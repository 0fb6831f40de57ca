"""Mesh / point-cloud post-processing.

Re-design of the reference MeshFactory (MeshFactory.cuh:32-225,
MeshFactory.cu): neighbour-distance outlier filtering, the normal-based
implicit surface function, surface reconstruction via isosurface extraction,
PLY save/load, and cloud comparison metrics.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ssrlcv_tpu.io import ply
from ssrlcv_tpu.mesh import octree as oc
from ssrlcv_tpu.mesh.marching_cubes import compact_mesh, marching_tetrahedra


class Mesh:
    """Host-side mesh container (MeshFactory points/colors/faces,
    MeshFactory.cuh:32-60)."""

    def __init__(self, points: np.ndarray, faces: Optional[np.ndarray] = None,
                 colors: Optional[np.ndarray] = None):
        self.points = np.asarray(points, np.float32)
        self.faces = None if faces is None else np.asarray(faces, np.int32)
        self.colors = None if colors is None else np.asarray(colors, np.uint8)

    def save_points(self, path: str) -> str:
        """savePoints (MeshFactory.cu:271)."""
        return ply.write_ply(path, self.points, colors=self.colors)

    def save_mesh(self, path: str) -> str:
        """saveMesh (MeshFactory.cuh:109-128)."""
        return ply.write_ply(path, self.points, colors=self.colors, faces=self.faces)

    @classmethod
    def load(cls, path: str) -> "Mesh":
        d = ply.read_ply(path)
        return cls(d["points"], faces=d["faces"], colors=d["colors"])


def filter_by_neighbor_distance(
    points: jax.Array, mask: jax.Array, sigma: float = 3.0, k: int = 8, window: int = 32
):
    """Drop points whose mean kNN distance exceeds sigma stddevs
    (filterByNeighborDistance, MeshFactory.cu:578; octree-backed variant
    MeshFactory.cuh:183).  Returns the updated mask in ORIGINAL point order."""
    tree = oc.build_octree(points, mask)
    filtered = oc.remove_low_density_points(tree, sigma=sigma, k=k, window=window)
    # scatter sorted-order mask back to original order
    out = jnp.zeros_like(mask)
    out = out.at[filtered.order].set(filtered.mask)
    return out


def implicit_from_normals(
    grid_points: jax.Array,   # (G, 3) sample locations
    surf_points: jax.Array,   # (N, 3) cloud (sorted octree order)
    normals: jax.Array,       # (N, 3)
    mask: jax.Array,          # (N,)
    chunk: int = 2048,
):
    """Signed distance of each grid sample to the plane of its nearest cloud
    point (computeVertexImplicit, MeshFactory.cu:639: per-vertex signed
    distance from neighbourhood normals)."""
    g = grid_points.shape[0]
    n_chunks = (g + chunk - 1) // chunk
    pad = n_chunks * chunk - g
    gp = jnp.pad(grid_points, ((0, pad), (0, 0)))

    def body(pc):
        d = jnp.linalg.norm(pc[:, None, :] - surf_points[None, :, :], axis=-1)
        d = jnp.where(mask[None, :], d, jnp.inf)
        nearest = jnp.argmin(d, axis=1)
        p0 = surf_points[nearest]
        n0 = normals[nearest]
        return jnp.sum((pc - p0) * n0, axis=1)

    vals = jax.lax.map(body, gp.reshape(n_chunks, chunk, 3))
    return vals.reshape(-1)[:g]


def reconstruct_surface(
    points: jax.Array,
    mask: jax.Array,
    camera_positions: jax.Array,
    resolution: int = 64,
    k: int = 8,
) -> Mesh:
    """Full surface reconstruction (the reference's octree-implicit +
    marching cubes chain, MeshFactory.cu:639-1014): normals -> implicit field
    on a regular grid -> isosurface triangles -> compacted mesh."""
    tree = oc.build_octree(points, mask)
    normals = oc.compute_normals(tree, camera_positions, k=k)

    extent = tree.bbox_max - tree.bbox_min
    # degenerate (near-planar) clouds still need volume around the surface
    pad = jnp.maximum(0.05 * extent, 0.05 * jnp.max(extent))
    lo = tree.bbox_min - pad
    hi = tree.bbox_max + pad
    axes = [jnp.linspace(lo[i], hi[i], resolution) for i in range(3)]
    gx, gy, gz = jnp.meshgrid(*axes, indexing="ij")
    grid = jnp.stack([gx, gy, gz], axis=-1).reshape(-1, 3)

    vals = implicit_from_normals(grid, tree.points, normals, tree.mask)
    field = vals.reshape(resolution, resolution, resolution)
    spacing = (hi - lo) / (resolution - 1)
    tris, tmask = marching_tetrahedra(field, lo, spacing, isolevel=0.0)
    verts, faces = compact_mesh(np.asarray(tris), np.asarray(tmask))
    return Mesh(verts, faces=faces)


def _hier_and_normals(points, mask, camera_positions, depth: int):
    """Shared prep for the octree-lattice meshers: hierarchy + per-sorted-
    point normals (computeNormals with camera disambiguation,
    Octree.cu:1373-1412)."""
    import jax.numpy as jnp

    from ssrlcv_tpu.mesh.hierarchy import build_hierarchy

    hier = build_hierarchy(np.asarray(points), np.asarray(mask), depth=depth)
    # normals in hier's sorted order, via the Morton octree estimator
    tree = oc.build_octree(jnp.asarray(hier.points),
                           jnp.ones(hier.points.shape[0], bool))
    nrm_sorted = oc.compute_normals(tree, jnp.asarray(camera_positions))
    # scatter back to hier.points order (tree.order indexes hier.points)
    nrm = np.empty_like(hier.points)
    nrm[np.asarray(tree.order)] = np.asarray(nrm_sorted)
    return hier, nrm


def marching_cubes_octree(points, mask, camera_positions, depth: int = 6) -> Mesh:
    """Finest-level octree-lattice marching cubes (marchingCubes,
    MeshFactory.cu:860-1014)."""
    from ssrlcv_tpu.mesh.mc_octree import marching_cubes_level, vertex_implicit_from_normals

    hier, nrm = _hier_and_normals(points, mask, camera_positions, depth)
    imp = vertex_implicit_from_normals(hier, nrm)
    verts, tris = marching_cubes_level(hier, imp, level=0)
    return Mesh(verts, faces=tris)


def adaptive_marching_cubes(points, mask, camera_positions, depth: int = 6) -> Mesh:
    """Top-down adaptive marching cubes (adaptiveMarchingCubes,
    MeshFactory.cu:716-858)."""
    from ssrlcv_tpu.mesh.mc_octree import adaptive_marching_cubes as _amc

    hier, nrm = _hier_and_normals(points, mask, camera_positions, depth)
    verts, tris = _amc(hier, nrm)
    return Mesh(verts, faces=tris)


def jax_meshing(points, mask, camera_positions, depth: int = 6) -> Mesh:
    """Surface-depth search + marching cubes (jaxMeshing,
    MeshFactory.cu:1015-1211)."""
    from ssrlcv_tpu.mesh.mc_octree import jax_meshing as _jm

    hier, nrm = _hier_and_normals(points, mask, camera_positions, depth)
    verts, tris, _level = _jm(hier, nrm)
    return Mesh(verts, faces=tris)


def generate_mesh(mesh: Mesh, out_dir: str, name: str, depth: int) -> str:
    """Write ``<out_dir>/<name>_mesh_march_<depth>.ply`` (generateMesh,
    MeshFactory.cu:1213-1285)."""
    import os

    return mesh.save_mesh(os.path.join(out_dir, f"{name}_mesh_march_{depth}"))


def average_cloud_difference(a: np.ndarray, b: np.ndarray) -> float:
    """Mean nearest-neighbour distance from cloud a to cloud b
    (calculateAverageDifference plane-difference metric,
    MeshFactory.cuh:145 — used to score reconstructions against a reference
    model)."""
    from scipy.spatial import cKDTree

    d, _ = cKDTree(np.asarray(b)).query(np.asarray(a))
    return float(np.mean(d))
