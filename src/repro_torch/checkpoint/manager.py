"""Fault-tolerant checkpointing: atomic, keep-k, auto-resume (the port of
``repro.checkpoint.manager``, on the reference's on-disk layout).

Each checkpoint is a directory ``step_%010d`` holding ``leaves.npz`` (leaf
i, in ``core.tree.leaves`` order, as ``leaf_i``) and ``manifest.json``
(step, leaf count, the tree's structure, ``extra``, ``complete``, and
``dtypes``, each leaf's dtype, a key the reference does not read). A save
writes a ``.tmp_`` directory and renames it into place, so a crash
mid-save never corrupts the latest checkpoint; ``restore_latest`` skips
incomplete or corrupt directories. Leaves are tensors. numpy has no
bfloat16: a bf16 leaf is stored as the reference's ``np.asarray`` stores
one, its bits as a ``|V2`` array, and a ``|V2`` leaf (or a ``uint16`` leaf
that ``dtypes`` marks ``bfloat16``, as earlier versions of the port wrote
it) restores as bf16 bits. The reference itself cannot cast a ``|V2``
leaf, so it skips such a checkpoint, its own or the port's.

A sharded tree (``DTensor`` leaves) saves whole: each leaf is gathered
(``full_tensor``, a collective that every rank of its mesh joins, in leaf
order), so the files are those of an unsharded save of the same values.
Under ``torch.distributed`` every rank of the default group calls
``save_checkpoint``; rank 0 alone writes, and every rank returns only
once the checkpoint is in place. ``restore_latest`` gives every leaf back
whole, as the reference does; the caller re-places a sharded tree
(``distributed.sharding.place_params``).
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
    if hasattr(t, "full_tensor"):          # a DTensor: gathered whole
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if a.dtype == np.dtype("V2") or (a.dtype == np.uint16
                                     and dtype_name == "bfloat16"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_checkpoint(ckpt_dir: str, step: int, tree, *, keep: int = 3,
                    extra: dict = None) -> str:
    """Atomically write checkpoint ``step`` of ``tree``; keep the newest
    ``keep``. Returns the final path. Under ``torch.distributed`` every
    rank calls it (a sharded leaf is gathered by all of them); rank 0
    writes, and the others wait until it has."""
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    ls = leaves(tree)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(ls)}
    manifest = {
        "step": step,
        "n_leaves": len(ls),
        "dtypes": [str(x.dtype).removeprefix("torch.") for x in ls],
        "treedef": str(tree_map(lambda x: "*", tree)),
        "time": time.time(),
        "extra": extra or {},
        "complete": True,
    }
    dist = torch.distributed
    ranks = dist.is_available() and dist.is_initialized()
    try:
        if not ranks or dist.get_rank() == 0:
            _write(ckpt_dir, final, arrays, manifest, keep)
    finally:
        if ranks:       # no rank lists checkpoints before the rename
            dist.barrier()
    return final


def _write(ckpt_dir, final, arrays, manifest, keep):
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, _DATA), **arrays)
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)


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
    """Restore the newest intact checkpoint with ``tree_like``'s leaf count
    into its structure, each leaf whole and as stored (its shape is not
    checked, as the reference's is not), on its counterpart's device (a
    ``DTensor``'s local block's) and in its dtype. Returns (step, tree),
    or (None, None) when nothing restorable exists. A sharded caller
    re-places the tree (``distributed.sharding.place_params``)."""
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
                restored.append(_from_numpy(a, name).to(r.device, r.dtype))
            return step, unflatten(tree_like, restored)
        except (OSError, ValueError, KeyError, TypeError):
            continue  # corrupt or undecodable: try the previous one
    return None, None
