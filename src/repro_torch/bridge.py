"""Weights of the JAX reference, as numpy, turned into the port's params.

The reference (``repro.models.lm.init_lm``) stacks every layer's leaves
along a leading layer axis -- ``layers/attn/wq`` is (L, d, n_q, hd),
``layers/mlp/w_gate`` is (L, d, ff) -- for ``lax.scan``. The port keeps
one dict per layer. ``params_from_jax`` takes the reference's tree with
numpy leaves (``jax.tree.map(np.asarray, params)``) and slices it layer by
layer, so both packages compute with the same weights in the tests. The
ssm/hybrid tree (``repro.models.ssm_lm``) stacks ``layers/{norm, mamba/*}``
the same way; its hybrid ``shared_attn`` block is not stacked and maps as
it is. An MoE tree with ``moe_every`` 1 stacks its ``layers/moe/*`` leaves
the same way too; with ``moe_every`` me > 1 the reference stacks layer
groups instead: ``moe_layers`` (n_groups, ...) and ``dense_layers``
(n_groups, me - 1, ...), which flatten to layer g·me (the MoE layer) and
g·me + j (dense layer j - 1 of group g). A vlm tree is the dense one
with ``patch_proj`` beside it; the audio family's (``repro.models.encdec``)
stacks ``enc_layers`` and ``dec_layers``, which split into one dict per
layer the same way (LayerNorm ``scale``/``bias`` and the decoder's
``cross``/``cross_norm`` included), beside ``embed``, ``dec_pos``,
``enc_final_norm`` and ``dec_final_norm``.

A tree with the params' structure maps the same way: a gradient tree, and
the AdamW moments ``mu`` / ``nu`` of ``adamw_state_from_jax``.

The control plane's parameters carry across the same way: ``rl_from_jax``
maps the reference's DDPG state (actor, critic and their targets: the GCN's
``w[i]``/``b[i]`` lists and the MLP head's ``w1, b1, w2, b2``) and
``forecaster_from_jax`` the GRU forecaster's tree. Both trees keep their
structure; only the leaves become f32 tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ddpg import DDPGState
from repro_torch.device import resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":         # ml_dtypes' bfloat16: no numpy
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _unstack(tree, dev, *index) -> dict:
    """Slice ``index`` off the front of every leaf of a stacked tree."""
    return _map(tree, lambda a: _tensor(a[index], dev))


def params_from_jax(tree: dict, device="cuda") -> dict:
    """The reference's model params (numpy leaves; any family) as the
    port's: the stacked ``layers`` tree (or the moe layer groups
    ``moe_layers`` / ``dense_layers``, or the audio family's
    ``enc_layers`` and ``dec_layers``) split into one dict per layer, every
    other entry (``embed``, ``final_norm``, ``lm_head``, the hybrid's
    unstacked ``shared_attn`` block, the vlm's ``patch_proj``, the audio
    family's ``dec_pos`` and final norms) mapped leaf by leaf as it is."""
    dev = resolve_device(device)
    stacked = ("layers", "moe_layers", "dense_layers", "enc_layers",
               "dec_layers")
    out = {k: _map(v, lambda a: _tensor(a, dev)) for k, v in tree.items()
           if k not in stacked}
    if "enc_layers" in tree and "dec_layers" in tree:
        for name in ("enc_layers", "dec_layers"):
            n = np.asarray(next(_leaves(tree[name]))).shape[0]
            out[name] = [_unstack(tree[name], dev, i) for i in range(n)]
    elif "layers" in tree:
        n = np.asarray(next(_leaves(tree["layers"]))).shape[0]
        out["layers"] = [_unstack(tree["layers"], dev, i) for i in range(n)]
    elif "moe_layers" in tree and "dense_layers" in tree:
        n_groups, me1 = np.asarray(
            next(_leaves(tree["dense_layers"]))).shape[:2]
        out["layers"] = [
            _unstack(tree["moe_layers"], dev, g) if j == 0
            else _unstack(tree["dense_layers"], dev, g, j - 1)
            for g in range(n_groups) for j in range(me1 + 1)]
    else:
        raise ValueError("params_from_jax maps a stacked 'layers' tree, "
                         "the moe layer groups 'moe_layers' / "
                         "'dense_layers' or the encoder-decoder's "
                         "'enc_layers' / 'dec_layers'; got "
                         f"{sorted(tree)}")
    return out


def adamw_state_from_jax(state: dict, device="cuda") -> dict:
    """The reference's AdamW state ``{"mu", "nu", "step"}`` (numpy leaves)
    as ``models.optim.AdamW``'s: the moments split into layers as
    ``params_from_jax`` splits the params (in their own dtype, bf16
    included), ``step`` an int32 scalar tensor."""
    dev = resolve_device(device)
    return {"mu": params_from_jax(state["mu"], dev),
            "nu": params_from_jax(state["nu"], dev),
            "step": _tensor(np.asarray(state["step"], np.int32), dev)}


def rl_from_jax(state, device="cuda"):
    """The reference's ``DDPGState`` (or a dict with its four fields), with
    numpy leaves, as the port's ``core.ddpg.DDPGState``."""
    dev = resolve_device(device)
    fields = ("actor", "critic", "actor_target", "critic_target")
    get = state.get if isinstance(state, dict) else \
        (lambda k: getattr(state, k))
    return DDPGState(*(_map(get(k), lambda a: _tensor(a, dev)
                            .to(torch.float32)) for k in fields))


def forecaster_from_jax(tree: dict, device="cuda") -> dict:
    """The reference's GRU forecaster params (``init_forecaster`` /
    ``train_forecaster``), with numpy leaves, as the port's."""
    dev = resolve_device(device)
    return _map(tree, lambda a: _tensor(a, dev).to(torch.float32))
