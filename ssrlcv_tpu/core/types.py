"""Core pytree data model.

The reference's data model is array-of-structs (``Feature<SIFT_Descriptor>``,
``KeyPoint``, ``MultiMatch``, ``Bundle`` — Feature.cuh:31, MatchFactory.cuh:31-72,
PointCloudFactory.cuh:25-48) held in ``Unity<T>`` dual-residency buffers.

This design is struct-of-arrays: every collection is a pytree of
fixed-capacity ``jax.Array``s with a validity mask, so all stage functions jit
with static shapes.
There is no host/device state machine — arrays live on the device, and
``np.asarray`` at the I/O boundary is the only transfer point.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from ssrlcv_tpu.core import pytree as struct


@struct.dataclass
class Cameras:
    """Batched pinhole camera model (reference ``Image::Camera`` Image.cuh:41-57).

    All fields have leading axis = number of images.  Positions are in km
    (ECEF minus ``ecef_offset`` of image 0, as in Pipeline.cu:37-40).
    """

    cam_pos: jax.Array      # (N, 3) float32, km
    cam_rot: jax.Array      # (N, 3) float32, XYZ Euler radians
    fov: jax.Array          # (N, 2) float32, radians
    foc: jax.Array          # (N,)  float32, m? (reference units: same as dpix)
    dpix: jax.Array         # (N, 2) float32
    size: jax.Array         # (N, 2) int32  (width, height)
    ecef_offset: jax.Array  # (N, 3) float32, km
    timestamp: jax.Array    # (N,) int64 under jax_enable_x64, else int32
                            # (the reference's Camera::timeStamp, Image.cuh:47)

    @property
    def num_cameras(self) -> int:
        return self.cam_pos.shape[0]

    @classmethod
    def stack(cls, cams: list["Cameras"]) -> "Cameras":
        return jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs, axis=0), *cams)

    def __getitem__(self, idx) -> "Cameras":
        return jax.tree_util.tree_map(lambda x: x[idx], self)


@struct.dataclass
class PushbroomCameras:
    """Batched pushbroom (scan) camera (reference ``Image::PushbroomCamera``
    Image.cuh:62-77)."""

    start_pos: jax.Array          # (N, 3)
    end_pos: jax.Array            # (N, 3)
    projection_center: jax.Array  # (N, 2)
    axis_radius: jax.Array        # (N,)
    roll: jax.Array               # (N,) degrees (reference stores degrees)
    altitude: jax.Array           # (N,)
    foc: jax.Array                # (N,)
    fov: jax.Array                # (N,)
    gsd: jax.Array                # (N,)
    dpix: jax.Array               # (N, 2)
    size: jax.Array               # (N, 2) int32


@struct.dataclass
class FeatureSet:
    """Fixed-capacity SIFT features for one image.

    Replaces ragged ``Unity<Feature<SIFT_Descriptor>>`` (Feature.cuh:31,68)
    with capacity-padded tensors + mask.  Descriptors stay uint8 (as in the
    reference) and are widened on the fly inside the match kernel.
    """

    loc: jax.Array          # (K, 2) float32 — (x, y) pixel location
    sigma: jax.Array        # (K,) float32
    theta: jax.Array        # (K,) float32
    descriptors: jax.Array  # (K, 128) uint8
    mask: jax.Array         # (K,) bool — True where a real feature lives
    parent: jax.Array       # (K,) int32 — parent image id

    @property
    def capacity(self) -> int:
        return self.loc.shape[0]

    def count(self) -> jax.Array:
        return jnp.sum(self.mask.astype(jnp.int32))

    @classmethod
    def empty(cls, capacity: int, parent: int = -1) -> "FeatureSet":
        return cls(
            loc=jnp.full((capacity, 2), -1.0, jnp.float32),
            sigma=jnp.zeros((capacity,), jnp.float32),
            theta=jnp.zeros((capacity,), jnp.float32),
            descriptors=jnp.zeros((capacity, 128), jnp.uint8),
            mask=jnp.zeros((capacity,), bool),
            parent=jnp.full((capacity,), parent, jnp.int32),
        )


@struct.dataclass
class MatchSet:
    """N-view match tracks in padded-track layout.

    The reference represents tracks as a flat ``KeyPoint`` array plus
    ``MultiMatch{numKeyPoints, index}`` offsets (MatchFactory.cuh:31-47).
    Here the layout is a dense (T, V) tensor of keypoint slots with per-slot
    parent image ids and a views-count, which keeps triangulation fully
    vectorised with static shapes.
    """

    kp_loc: jax.Array     # (T, V, 2) float32 keypoint locations
    kp_parent: jax.Array  # (T, V) int32 parent image ids (-1 = empty slot)
    num_views: jax.Array  # (T,) int32 number of valid views per track
    mask: jax.Array       # (T,) bool — valid track

    @property
    def capacity(self) -> int:
        return self.kp_loc.shape[0]

    @property
    def max_views(self) -> int:
        return self.kp_loc.shape[1]

    def count(self) -> jax.Array:
        return jnp.sum(self.mask.astype(jnp.int32))

    @classmethod
    def empty(cls, capacity: int, max_views: int = 2) -> "MatchSet":
        return cls(
            kp_loc=jnp.zeros((capacity, max_views, 2), jnp.float32),
            kp_parent=jnp.full((capacity, max_views), -1, jnp.int32),
            num_views=jnp.zeros((capacity,), jnp.int32),
            mask=jnp.zeros((capacity,), bool),
        )

    @classmethod
    def from_flat(
        cls,
        kp_parent_flat: np.ndarray,
        kp_loc_flat: np.ndarray,
        mm_num: np.ndarray,
        mm_index: np.ndarray,
        capacity: Optional[int] = None,
        max_views: Optional[int] = None,
    ) -> "MatchSet":
        """Build from the reference's flat KeyPoint/MultiMatch layout
        (host-side; used for fixture ingest and track assembly)."""
        t = len(mm_num)
        v = int(max_views or (mm_num.max() if t else 2))
        cap = int(capacity or t)
        kp_loc = np.zeros((cap, v, 2), np.float32)
        kp_par = np.full((cap, v), -1, np.int32)
        nviews = np.zeros((cap,), np.int32)
        mask = np.zeros((cap,), bool)
        for i in range(t):
            n = int(mm_num[i])
            s = int(mm_index[i])
            kp_loc[i, :n] = kp_loc_flat[s : s + n]
            kp_par[i, :n] = kp_parent_flat[s : s + n]
            nviews[i] = n
            mask[i] = True
        return cls(
            kp_loc=jnp.asarray(kp_loc),
            kp_parent=jnp.asarray(kp_par),
            num_views=jnp.asarray(nviews),
            mask=jnp.asarray(mask),
        )


@struct.dataclass
class Bundles:
    """Rays lifted from match tracks (reference ``Bundle``/``Bundle::Line``
    PointCloudFactory.cuh:25-48) in padded (T, V) layout."""

    vec: jax.Array        # (T, V, 3) float32 — unit direction
    pnt: jax.Array        # (T, V, 3) float32 — camera origin
    num_views: jax.Array  # (T,) int32
    mask: jax.Array       # (T,) bool — valid & not flagged invalid

    @property
    def capacity(self) -> int:
        return self.vec.shape[0]


@struct.dataclass
class PointCloud:
    """Triangulated points + per-point errors."""

    points: jax.Array  # (T, 3) float32
    errors: jax.Array  # (T,) float32 — per-point linear/angular error
    mask: jax.Array    # (T,) bool

    def compact(self) -> np.ndarray:
        """Host-side: return only valid points as a dense (n,3) array."""
        m = np.asarray(self.mask)
        return np.asarray(self.points)[m]
