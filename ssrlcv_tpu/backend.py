"""Which path runs on this device, and where compiled programs are cached.

Every platform-dependent choice in the package asks ``device_path``; no other
module inspects ``jax.devices()[...].platform``.

  * ``"gpu"``: the device-resident fused programs (one SIFT program per image
    with on-device aggregation, the chunked XLA matcher, the dense stencil
    path with the XLA descriptor pass).
  * ``"cpu"``: the host-compacted SIFT loop, which keeps each gather as small
    as the live keypoint count (the same results; tests compare the two).

Any other platform is an error: nothing here was built or checked for it.

Measurements (bench.py, chip_smoke.py) additionally need ``require_gpu``:
a number taken on the CPU is never reported as a device number.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import jax

PATHS = ("cpu", "gpu")

# fixed, so that every run of this checkout finds the programs it compiled
# before (the path is part of the cache key)
_REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def device_path(device=None) -> str:
    """The code path for ``device`` (default: JAX's first device)."""
    platform = (device if device is not None else jax.devices()[0]).platform
    if platform not in PATHS:
        raise RuntimeError(
            f"no code path for JAX platform {platform!r}: ssrlcv_tpu runs on "
            f"{' and '.join(PATHS)} only")
    return platform


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the only directory used (JAX
    reads it itself, so nothing is overridden); otherwise the cache lives at
    the fixed ``.jax_cache/`` of this checkout."""
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or _REPO_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir


def require_gpu():
    """The visible devices, if JAX's first device is a GPU; raise otherwise
    (a measurement must not fall back to the CPU)."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {devices[0].platform!r} "
            f"({devices[0].device_kind}); this measures the GPU only")
    return devices


CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def parse_card_line(line: str) -> tuple[str, str]:
    """(name, power limit) from one line of ``CARD_QUERY``'s output, e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    name, sep, limit = line.strip().rpartition(",")
    if not sep or not name.strip() or not limit.strip():
        raise ValueError(f"unexpected nvidia-smi line: {line!r}")
    return name.strip(), limit.strip()


def card_lines() -> list[str]:
    """Each card's ``name, power.limit`` line as nvidia-smi reports it.
    Raises when nvidia-smi is missing or fails: a number without its card
    is not reported."""
    if shutil.which(CARD_QUERY[0]) is None:
        raise RuntimeError("nvidia-smi not found: cannot name the card")
    out = subprocess.run(CARD_QUERY, capture_output=True, text=True,
                         timeout=60, check=True).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi listed no card")
    for ln in lines:
        parse_card_line(ln)
    return lines
