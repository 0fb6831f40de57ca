"""Stage-door checkpoint / resume.

The reference checkpoints every pipeline stage into
``outputs/sfm-stage<N>/`` with binary ``.uty``/``.cpimg`` dumps plus an empty
``done`` marker, and on startup resumes at the first stage whose marker is
missing (SFM.cu:149-203, Unity.cuh:924-971).  This equivalent keeps the
same stage-door semantics over NPZ archives of pytrees: one
``<name>.npz`` per stage + ``done`` marker, written atomically
(tmp + rename) so a SIGINT mid-write never corrupts the resume chain.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional

import jax
import numpy as np


def stage_dir(root: str, stage_index: int) -> str:
    return os.path.join(root, f"sfm-stage{stage_index}")


def is_stage_done(root: str, stage_index: int) -> bool:
    return os.path.exists(os.path.join(stage_dir(root, stage_index), "done"))


def first_unfinished_stage(root: str, num_stages: int) -> int:
    """Index of the first stage without a done marker (SFM.cu:149-203)."""
    for i in range(num_stages):
        if not is_stage_done(root, i):
            return i
    return num_stages


def _flatten(tree: Any) -> tuple[dict[str, np.ndarray], dict]:
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    return arrays, treedef


def save_pytree(path: str, tree: Any) -> None:
    """Atomically write a pytree to NPZ (structure via tree_structure repr)."""
    arrays, treedef = _flatten(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __treedef__=np.frombuffer(str(treedef).encode(), np.uint8), **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_pytree(path: str, like: Any) -> Any:
    """Load an NPZ checkpoint into the structure of ``like`` (capacity and
    dtype must match — the same type-checking contract as the reference's
    typeid-validated Unity reader, Unity.cuh:467-531)."""
    with np.load(path) as z:
        leaves_like, treedef = jax.tree_util.tree_flatten(like)
        n = len(leaves_like)
        leaves = [z[f"leaf_{i}"] for i in range(n)]
        for got, want in zip(leaves, leaves_like):
            if hasattr(want, "shape") and tuple(got.shape) != tuple(np.shape(want)):
                raise ValueError(
                    f"checkpoint leaf shape {got.shape} != expected {np.shape(want)} in {path}"
                )
        import jax.numpy as jnp

        return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in leaves])


def save_stage(root: str, stage_index: int, name: str, tree: Any, meta: Optional[dict] = None) -> None:
    """Write a stage checkpoint + done marker (stage-door semantics)."""
    d = stage_dir(root, stage_index)
    os.makedirs(d, exist_ok=True)
    save_pytree(os.path.join(d, f"{name}.npz"), tree)
    if meta is not None:
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump(meta, f)
    with open(os.path.join(d, "done"), "w"):
        pass


def load_stage(root: str, stage_index: int, name: str, like: Any) -> Any:
    return load_pytree(os.path.join(stage_dir(root, stage_index), f"{name}.npz"), like)


def load_stage_meta(root: str, stage_index: int) -> Optional[dict]:
    p = os.path.join(stage_dir(root, stage_index), "meta.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return None
