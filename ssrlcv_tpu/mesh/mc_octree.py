"""Octree-lattice marching cubes: plain, surface-depth (jaxMeshing), adaptive.

Re-design of the reference MeshFactory surface chain
(MeshFactory.cu:639-1236):

  - ``vertex_implicit_from_normals`` — per octree-lattice vertex, the signed
    cosine between the nearest cloud point's normal and the vector from that
    point to the vertex (vertexImplicitFromNormals kernel,
    MeshFactory.cu:2055-2091).  The reference approximates "nearest" by
    walking the vertex's 8 adjacent nodes up through parents until a point
    appears; here the nearest point is found *exactly* with a chunked
    matmul-shaped ``|v|^2+|p|^2-2 v.p`` distance matrix — same intent, no
    pointer walk, and strictly tighter than the node-walk approximation.
  - ``marching_cubes_level`` — classic MC over one octree level's node cubes
    (marchingCubes, MeshFactory.cu:860-1014): surface vertices at crossed
    edge midpoints (generateSurfaceVertices uses the midpoint, not an
    interpolant — MeshFactory.cu:2219-2231), triangles from the per-cube
    case table.
  - ``jax_meshing`` — searches for the coarsest "hole-free" level where
    every occupied node has an occupied 26-neighbor, then marches that level
    (jaxMeshing, MeshFactory.cu:1015-1211).
  - ``adaptive_marching_cubes`` — top-down refinement from the root's
    children: a parent's cube is replaced by its children's cubes whenever
    the children together emit at least as many triangles
    (categorizeCubesRecursively, MeshFactory.cu:2109-2167).

Category indexing deviates from the reference by design: categories are the
8-bit corner-sign mask with a generated table (see mc_tables), instead of
first-match lookup over an edge-mask table, which collapses complementary
configurations (MeshFactory.cu:2203-2214).
"""

from __future__ import annotations

import numpy as np

from ssrlcv_tpu.mesh.hierarchy import OctreeHierarchy
from ssrlcv_tpu.mesh.mc_tables import MAX_TRIS, NUM_TRIS, TRI_TABLE


def vertex_implicit_from_normals(
    hier: OctreeHierarchy,
    normals: np.ndarray,          # (P, 3) per sorted point (hier.points order)
    levels: slice | None = None,  # vertex range; default all
    chunk: int = 2048,
) -> np.ndarray:
    """Implicit value per octree vertex: dot(unit normal of nearest point,
    unit vector nearest-point -> vertex).  Negative is "inside"."""
    import jax
    import jax.numpy as jnp

    verts = hier.vertex_coord if levels is None else hier.vertex_coord[levels]
    v = jnp.asarray(verts)
    p = jnp.asarray(hier.points)
    nrm = jnp.asarray(np.asarray(normals, np.float32))

    g = v.shape[0]
    n_chunks = (g + chunk - 1) // chunk
    pad = n_chunks * chunk - g
    vp = jnp.pad(v, ((0, pad), (0, 0)))

    @jax.jit
    def _run(vp, p, nrm):
        p_sq = jnp.sum(p * p, axis=1)

        def body(vc):
            # |v-p|^2 via the matmul identity; full float32 precision, as a
            # reduced-precision (TF32) product can pick the wrong nearest
            # point for close candidates
            d2 = (jnp.sum(vc * vc, axis=1)[:, None] + p_sq[None, :]
                  - 2.0 * jnp.matmul(vc, p.T, precision="highest"))
            nearest = jnp.argmin(d2, axis=1)
            p0 = p[nearest]
            n0 = nrm[nearest]
            n0 = n0 / jnp.maximum(jnp.linalg.norm(n0, axis=1, keepdims=True), 1e-12)
            vec = vc - p0
            vec = vec / jnp.maximum(jnp.linalg.norm(vec, axis=1, keepdims=True), 1e-12)
            return jnp.sum(n0 * vec, axis=1)

        return jax.lax.map(body, vp.reshape(n_chunks, chunk, 3)).reshape(-1)

    return np.asarray(_run(vp, p, nrm))[:g]


def _emit(hier: OctreeHierarchy, node_ids: np.ndarray, categories: np.ndarray):
    """Emit (surface_vertices, triangles) for the given nodes/categories.

    Surface vertices are deduplicated crossed-edge midpoints (the union of
    edges referenced by any emitted triangle — minimizeVertices semantics,
    MeshFactory.cu:2168-2194)."""
    nt = NUM_TRIS[categories]                          # (M,)
    tri_edges_local = TRI_TABLE[categories]            # (M, 15) edge slots
    valid = np.arange(MAX_TRIS * 3)[None, :] < (nt * 3)[:, None]
    ge = hier.node_edges[node_ids]                     # (M, 12) global edge ids
    tri_edges = np.where(valid, np.take_along_axis(
        ge, np.maximum(tri_edges_local, 0).astype(np.int64), axis=1), -1)
    flat = tri_edges[valid]                            # (3*T,) global edge ids
    used_edges, inv = np.unique(flat, return_inverse=True)
    ev = hier.edge_v[used_edges]                       # (U, 2) lattice vertex ids
    surf_verts = 0.5 * (hier.vertex_coord[ev[:, 0]] + hier.vertex_coord[ev[:, 1]])
    tris = inv.reshape(-1, 3).astype(np.int32)
    return surf_verts.astype(np.float32), tris


def _categories_for(hier: OctreeHierarchy, node_ids: np.ndarray,
                    imp: np.ndarray) -> np.ndarray:
    """8-bit corner-sign category per node (inside = implicit < 0)."""
    nv = hier.node_vertices[node_ids]                  # (M, 8)
    signs = (imp[nv] < 0.0).astype(np.int64)
    return (signs << np.arange(8)[None, :]).sum(axis=1)


def marching_cubes_level(hier: OctreeHierarchy, imp: np.ndarray, level: int):
    """March one octree level's cubes (marchingCubes at the finest level,
    jaxMeshing at a coarser one).  imp is indexed by GLOBAL vertex id."""
    s, e = int(hier.node_level_start[level]), int(hier.node_level_start[level + 1])
    node_ids = np.arange(s, e)
    cats = _categories_for(hier, node_ids, imp)
    return _emit(hier, node_ids, cats)


def find_surface_level(hier: OctreeHierarchy) -> int:
    """Smallest level (0 = finest) at which every occupied node has at least
    one occupied 26-neighbor — "the depth at which the surface is surrounded
    by nodes without holes" (jaxMeshing scan, MeshFactory.cu:1036-1071)."""
    occ = hier.node_num_points > 0
    for level in range(hier.depth):
        s, e = int(hier.node_level_start[level]), int(hier.node_level_start[level + 1])
        ids = np.arange(s, e)[occ[s:e]]
        if ids.size == 0:
            continue
        nb = hier.node_neighbors[ids]                  # (n, 27)
        nb_occ = (nb >= 0) & occ[np.maximum(nb, 0)]
        nb_occ[:, 13] = False                          # skip self (neigh 13)
        if bool(nb_occ.any(axis=1).all()):
            return level
    return hier.depth - 1


def jax_meshing(hier: OctreeHierarchy, normals: np.ndarray):
    """Surface-depth search + marching cubes (jaxMeshing,
    MeshFactory.cu:1015-1211).  Returns (verts, tris, surface_level)."""
    level = find_surface_level(hier)
    imp = vertex_implicit_from_normals(hier, normals)
    verts, tris = marching_cubes_level(hier, imp, level)
    return verts, tris, level


def adaptive_marching_cubes(hier: OctreeHierarchy, normals: np.ndarray):
    """Top-down adaptive refinement (adaptiveMarchingCubes +
    categorizeCubesRecursively, MeshFactory.cu:716-858, 2109-2167): start at
    the root's children; descend into a node's children whenever they emit
    at least as many triangles together as the parent alone."""
    imp = vertex_implicit_from_normals(hier, normals)
    selected: list[int] = []
    root = int(hier.node_level_start[hier.depth])
    stack = [int(c) for c in hier.node_children[root] if c >= 0]
    while stack:
        nid = stack.pop()
        cat = int(_categories_for(hier, np.asarray([nid]), imp)[0])
        my_tris = int(NUM_TRIS[cat])
        children = hier.node_children[nid]
        children = children[children >= 0]
        if children.size:
            ccats = _categories_for(hier, children, imp)
            if int(NUM_TRIS[ccats].sum()) >= my_tris:
                stack.extend(int(c) for c in children)
                continue
        if my_tris:
            selected.append(nid)
    if not selected:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    node_ids = np.asarray(selected)
    cats = _categories_for(hier, node_ids, imp)
    return _emit(hier, node_ids, cats)
