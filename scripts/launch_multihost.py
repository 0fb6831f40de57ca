#!/usr/bin/env python
"""Multi-host launcher for the distributed pipeline.

The reference scales by launching independent single-GPU Slurm jobs
(scripts/sub-run-sfm-*.sh); this package scales one reconstruction across
hosts: one process per host joins a jax.distributed cluster, the global
(data, feat) mesh spans every device, and the sharded stages
(ssrlcv_tpu.parallel.sharded) run with cross-host collectives.

Usage (run on every host):
    python scripts/launch_multihost.py \
        --coordinator <host0>:8476 --num-processes N --process-id I \
        -- -d <image_dir> [sfm args...]

Single-host multi-chip needs no coordinator:
    python scripts/launch_multihost.py -- -d <image_dir>
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--feat-axis", type=int, default=1,
                   help="mesh size along the feature axis (rest is data)")
    p.add_argument("rest", nargs=argparse.REMAINDER, help="-- followed by sfm args")
    args = p.parse_args(argv)

    from ssrlcv_tpu.parallel.mesh import initialize_distributed

    initialize_distributed(
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )

    import jax

    print(f"[launch] process {args.process_id}/{args.num_processes}: "
          f"{jax.local_device_count()} local / {jax.device_count()} global devices")

    sfm_args = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    # shard the reconstruction over the global mesh (every host runs the
    # same program; jit + shard_map split the work) instead of duplicating
    # the single-device pipeline per host
    if "--mesh" not in sfm_args:
        n = jax.device_count()
        assert n % args.feat_axis == 0, (n, args.feat_axis)
        sfm_args = sfm_args + ["--mesh", f"{n // args.feat_axis}x{args.feat_axis}"]
    from ssrlcv_tpu.pipeline.sfm import main as sfm_main

    return sfm_main(sfm_args)


if __name__ == "__main__":
    sys.exit(main())
