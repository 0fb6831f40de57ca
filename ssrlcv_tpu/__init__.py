"""ssrlcv_tpu — a JAX structure-from-motion framework.

A ground-up JAX/XLA re-design of the capabilities of uga-ssrl/SSRLCV
(C++11/CUDA SfM library for smallsat onboard reconstruction):

    SIFT feature detection/description  ->  (optional pose estimation)
    ->  epipolar-constrained feature matching  ->  2-view / N-view
    triangulation  ->  statistical point-cloud filtering  ->  bundle
    adjustment  ->  PLY output

Design principles (a re-design, not a port):
  * All device state is device-resident ``jax.Array``s; there is no host/device
    state machine (reference ``Unity<T>``, include/Unity.cuh:145).
  * Every pipeline stage is a pure, ``jit``-compiled function over
    fixed-capacity, validity-masked tensors (the reference's ragged thrust
    stream-compaction becomes masked compaction with static shapes).
  * Descriptor matching is an integer matrix product:
    ||q-t||^2 = ||q||^2+||t||^2-2 q.t^T in exact int8 x int8 -> int32
    arithmetic, swept in query chunks with the epipolar test fused in.
  * Bundle adjustment uses exact autodiff Jacobians/Hessians
    (``jax.grad``/``jax.hessian``) over the same triangulation objective the
    reference differentiates by finite differences.
  * Multi-chip scaling via ``jax.sharding.Mesh`` + ``shard_map`` collectives
    (match-pair data parallelism, feature-axis sharding, psum-reduced BA).
"""

__version__ = "0.1.0"

from ssrlcv_tpu.config import PipelineConfig, SIFTParams, MatchParams, FilterParams, BAParams

__all__ = [
    "PipelineConfig",
    "SIFTParams",
    "MatchParams",
    "FilterParams",
    "BAParams",
]
