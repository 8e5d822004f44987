"""Fault-tolerant checkpointing: atomic, keep-k, auto-resume (the port of
``repro.checkpoint.manager``, on the reference's on-disk layout).

Each checkpoint is a directory ``step_%010d`` holding ``leaves.npz`` (leaf
i, in ``core.tree.leaves`` order, as ``leaf_i``) and ``manifest.json``
(step, leaf count, each leaf's dtype, the tree's structure, ``extra``,
``complete``). A save writes a ``.tmp_`` directory and renames it into
place, so a crash mid-save never corrupts the latest checkpoint;
``restore_latest`` skips incomplete or corrupt directories. Leaves are
tensors; numpy has no bfloat16, so a bf16 leaf is stored as its uint16
bits and restored from the dtype in the manifest.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch.core.tree import leaves, tree_map, unflatten

_MANIFEST = "manifest.json"
_DATA = "leaves.npz"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_checkpoint(ckpt_dir: str, step: int, tree, *, keep: int = 3,
                    extra: dict = None) -> str:
    """Atomically write checkpoint ``step`` of ``tree``; keep the newest
    ``keep``. Returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        ls = leaves(tree)
        np.savez(os.path.join(tmp, _DATA),
                 **{f"leaf_{i}": _to_numpy(x) for i, x in enumerate(ls)})
        manifest = {
            "step": step,
            "n_leaves": len(ls),
            "dtypes": [str(x.dtype).removeprefix("torch.") for x in ls],
            "treedef": str(tree_map(lambda x: "*", tree)),
            "time": time.time(),
            "extra": extra or {},
            "complete": True,
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def list_checkpoints(ckpt_dir: str) -> list:
    """[(step, path, manifest)] of the complete checkpoints, oldest
    first."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in sorted(os.listdir(ckpt_dir)):
        if not d.startswith("step_"):
            continue
        path = os.path.join(ckpt_dir, d)
        try:
            with open(os.path.join(path, _MANIFEST)) as f:
                man = json.load(f)
            if man.get("complete"):
                out.append((man["step"], path, man))
        except (OSError, json.JSONDecodeError):
            continue  # incomplete/corrupt: skip
    return out


def restore_latest(ckpt_dir: str, tree_like):
    """Restore the newest intact checkpoint into ``tree_like``'s structure,
    each leaf on its counterpart's device and in its dtype. Returns
    (step, tree), or (None, None) when nothing restorable exists."""
    ref = leaves(tree_like)
    for step, path, man in reversed(list_checkpoints(ckpt_dir)):
        try:
            if man["n_leaves"] != len(ref):
                continue
            with np.load(os.path.join(path, _DATA)) as data:
                arrays = [data[f"leaf_{i}"] for i in range(len(ref))]
            dtypes = man.get("dtypes", [None] * len(ref))
            restored = []
            for a, name, r in zip(arrays, dtypes, ref):
                if tuple(a.shape) != tuple(r.shape):
                    raise ValueError(f"leaf shape {a.shape} != {r.shape}")
                restored.append(_from_numpy(a, name).to(r.device, r.dtype))
            return step, unflatten(tree_like, restored)
        except (OSError, ValueError, KeyError):
            continue  # corrupt: try the previous one
    return None, None
