"""Typed configuration for the SfM pipeline.

The reference scatters its constants across three tiers: compile-time Makefile
defines (LOG_LEVEL, GEO_ORBIT, SM — reference Makefile:9-32), CLI flags
(reference io_util.cpp:158-194), and hard-coded call-site literals (e.g. SIFT
sigma/thresholds at SIFT_FeatureFactory.cu:56-64, match thresholds at
Pipeline.cu:175).  Here they are lifted into one frozen dataclass tree; every
default reproduces the reference pipeline's defaults (see SURVEY.md Appendix A
for the file:line provenance of each value).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# Earth radii used by the "double constrained" epipolar-segment matcher
# (reference common_includes.hpp:52-53).
EARTH_MAX_KM_FROM_CENT = 6384.4
EARTH_MIN_KM_FROM_CENT = 6356.77


@dataclasses.dataclass(frozen=True)
class SIFTParams:
    """Scale-space + SIFT detection/description parameters.

    Defaults replicate the reference's sparse path
    (SIFT_FeatureFactory.cu:56-64 and FeatureFactory.cu:338-440).
    """

    num_octaves: int = 4
    blurs_per_octave: int = 6
    # Starting octave -1 => the image is first 2x-upsampled
    # (SIFT_FeatureFactory.cu:62; FeatureFactory.cu:348-381).
    starting_octave: int = -1
    initial_sigma: float = math.sqrt(2.0) / 2.0
    # sigma multipliers {across octaves, across blurs} (SIFT_FeatureFactory.cu:63).
    octave_sigma_multiplier: float = 2.0
    blur_sigma_multiplier: float = math.sqrt(2.0)
    # Separable Gaussian kernel half-extent parameters {8,8} => 9-tap-ish
    # windows grown with sigma (FeatureFactory.cu:11-44).
    kernel_size: Tuple[int, int] = (8, 8)
    # DoG extremum "noise" (contrast) threshold (SIFT_FeatureFactory.cu:58);
    # first pass uses 0.8x pre-refinement (FeatureFactory.cu:484,493).
    noise_threshold: float = 0.01
    # Edge rejection threshold on trace^2/det of the 2x2 Hessian
    # = (r+1)^2/r with r=10 (SIFT_FeatureFactory.cu:59).
    edge_threshold: float = 12.1
    # Iterative 3-D quadratic subpixel refinement: 5 Newton attempts, offsets
    # <= 0.5 accepted (FeatureFactory.cu:892-967).
    subpixel: bool = True
    max_refine_attempts: int = 5
    # Orientation histogram: 36 bins, contributer window multiplier, keep up to
    # maxOrientations peaks above orientationThreshold * max
    # (Pipeline.cu:25,44; FeatureFactory.cu:540-632).
    orientation_contrib_width: float = 1.5
    descriptor_contrib_width: float = 6.0
    max_orientations: int = 2
    orientation_threshold: float = 0.8
    # Dense-SIFT interior border in px (FeatureFactory.cuh:22 SIFTBORDER).
    border: int = 12
    # Descriptor normalisation clamp (SIFT_FeatureFactory.cu:433,439).
    descriptor_clamp: float = 0.2
    dense: bool = False
    # Static capacity for keypoints per image (fixed shapes; masked).
    max_keypoints: int = 65536
    # Host-loop SIFT path only: describe keypoints in per-blur buckets with
    # tight gather windows (~2.5x less gather traffic, one more dispatch per
    # bucket).  The fused path always buckets.
    bucket_describe: bool = False


@dataclasses.dataclass(frozen=True)
class MatchParams:
    """Feature-matching parameters (MatchFactory — reference Pipeline.cu:175)."""

    # Reject match unless dist < relative_threshold * seed_distance
    # (MatchFactory.cuh:136-137).
    relative_threshold: float = 0.6
    # Absolute squared-distance cutoff (200^2 at the matching stage).
    absolute_threshold: float = 200.0 ** 2
    # Epipolar tube half-width in px and Earth-radius slack in km for the
    # constrained / double-constrained kernels (SFM.cu:121,129 defaults).
    epsilon: float = 5.0
    delta: float = 0.0
    # GEO_ORBIT compile flag analogue: 'double' = Earth-segment epipolar
    # matching, 'fmatrix' = plain epipolar line, 'brute' = unconstrained
    # (Makefile:10; Pipeline.cu:191-195).
    mode: str = "double"
    # Capacity of the match set (static shapes).
    max_matches: int = 65536


@dataclasses.dataclass(frozen=True)
class FilterParams:
    """Point-cloud filtering (reference Pipeline.cu:297-348)."""

    # 2-view linear cutoff filter, km (Pipeline.cu:306).
    linear_cutoff_km: float = 100.0
    # Deterministic statistical filter: sigma multiplier and sample fraction
    # (Pipeline.cu:310,336 — 3.0 sigma, every 10th error).
    statistical_sigma: float = 3.0
    sample_fraction: float = 0.1


@dataclasses.dataclass(frozen=True)
class BAParams:
    """Two-view bundle adjustment (reference PointCloudFactory.cu:1832-2262)."""

    iterations: int = 10
    # Initial step scale alpha with adaptive decay (PointCloudFactory.cu:1891).
    initial_alpha: float = 0.1
    second_order: bool = True
    # Camera 0 pinned (PointCloudFactory.cu:1858-1862).
    fixed_camera: bool = True
    # SVD pseudo-inverse singular-value clamp used when inverting the Hessian.
    svd_rcond: float = 1e-6


@dataclasses.dataclass(frozen=True)
class PoseParams:
    """Pose estimation (reference PoseEstimator.cu)."""

    # LM initial lambda (PoseEstimator.cu:315).
    initial_lambda: float = 100.0
    max_outer_iterations: int = 50
    max_inner_iterations: int = 20
    # RANSAC symmetric-epipolar inlier distance (PoseEstimator.cu:597).
    ransac_inlier_threshold: float = 0.25
    ransac_iterations: int = 2048
    # Matching thresholds used by the pose stage (Pipeline.cu:82,93).
    relative_threshold: float = 0.6
    absolute_threshold: float = 10.0 ** 2
    epsilon: float = 100.0
    delta: float = 3.0


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level pipeline configuration (CLI analogue of reference SFM.cu)."""

    sift: SIFTParams = dataclasses.field(default_factory=SIFTParams)
    match: MatchParams = dataclasses.field(default_factory=MatchParams)
    filter: FilterParams = dataclasses.field(default_factory=FilterParams)
    ba: BAParams = dataclasses.field(default_factory=BAParams)
    pose: PoseParams = dataclasses.field(default_factory=PoseParams)

    # I/O roots (reference out/ + outputs/sfm-stage<N> checkpoints).
    output_dir: str = "out"
    checkpoint_dir: Optional[str] = None
    # Run the optional pose-estimation stage (reference --pose flag).
    do_pose: bool = False
    # Skip reading params.csv (reference -np/--noparams).
    no_params: bool = False

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)
