"""Model facade: one API over the ported architecture families (the port of
``repro.models.model``).

    model = make_model(get_config("granite-3-8b"))
    params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
    loss, metrics = model.loss(params, batch)
    logits, state, pos = model.prefill(params, batch, cache_len=1024)
    logits, state = model.decode(params, state, tokens, pos)
    logits, state, pos = model.prefill_chunk(params, state, tokens,
                                             offsets, lengths)

Every family of the reference is ported: dense, moe and vlm through
``models.lm`` (a vlm batch carries ``patch_embeds``), ssm and hybrid
through ``models.ssm_lm``, audio through ``models.encdec`` (a batch
carries ``frame_embeds``); the port's own hybrid_moe family
(granitemoehybrid) serves through ``models.hybrid_moe``, with no training
forward and no chunked prefill. An unknown family raises ``ValueError``.
``cache_dtype="int8"`` (the quantized KV codec of ``serving.kv_quant``) is
taken by the attention-LM families (dense, moe, vlm) only, and chunked
prefill is refused for moe (expert capacity would scale with the chunk,
not the prompt), for hybrid_moe (not ported) and for vlm and audio
(their requests carry per-request extras and stay on exact-length single
admits), as in the reference.

Training: ``forward`` is the full-sequence forward (einsum attention,
``ssd_chunked``; the kernels have no backward), ``loss`` the next-token
CE through a chunked head, and ``make_train_step`` one optimizer step
over a batch, with gradient accumulation; ``Model.remat`` picks the
activation recomputation (``lm.remat_policy``).

Sharded runs: every entry point takes ``shard_fn`` (``distributed.
sharding.make_shard_fn``), which places the activations under the
reference's tags; ``None`` leaves every path as it is. With the params
(and the batch, the serve state) placed as DTensors over a
``DeviceMesh`` (``sharding.place_params``), ``make_train_step`` and the
serve steps run the same code on them under DTensor's
``implicit_replication`` (a plain constant, a RoPE table or a mask, is
whole on every rank). ``input_specs`` gives ``meta`` stand-ins of a
dry-run cell's inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.tree import tree_map, value_and_grad
from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid_moe, lm, ssm_lm
from repro_torch.models.dims import PaddedDims, padded_dims
from repro_torch.models.layers import token_nll


class _Serves(NamedTuple):
    """The module that serves a family and its five entry points."""
    module: object
    init: Callable
    init_state: Callable
    prefill: Callable
    decode: Callable
    forward: Callable


_LM = _Serves(lm, lm.init_lm, lm.lm_init_cache, lm.lm_prefill, lm.lm_decode,
              lm.lm_forward)
_SSM = _Serves(ssm_lm, ssm_lm.init_ssm_lm, ssm_lm.ssm_init_state,
               ssm_lm.ssm_prefill, ssm_lm.ssm_decode, ssm_lm.ssm_forward)
_ENCDEC = _Serves(encdec, encdec.init_encdec, encdec.encdec_init_state,
                  encdec.encdec_prefill, encdec.encdec_decode,
                  encdec.encdec_forward)
_HYBRID_MOE = _Serves(hybrid_moe, hybrid_moe.init_hybrid_moe,
                      hybrid_moe.hybrid_moe_init_state,
                      hybrid_moe.hybrid_moe_prefill,
                      hybrid_moe.hybrid_moe_decode,
                      hybrid_moe.hybrid_moe_forward)
SERVES = {"dense": _LM, "moe": _LM, "ssm": _SSM, "hybrid": _SSM,
          "vlm": _LM, "audio": _ENCDEC, "hybrid_moe": _HYBRID_MOE}
PORTED_FAMILIES = tuple(SERVES)
# serve-state leaves with a sequence axis (axis 2, after the layer and row
# axes: the attention caches, float or int8 with their scales, the
# decoder's self cache); the others (SSM and conv state, the encoder's
# cross K/V over its fixed Le positions) are written whole
SEQ_LEAVES = ("k", "v", "attn_k", "attn_v", "k_q", "v_q", "k_s", "v_s",
              "self_k", "self_v")


def _ce_sum(h, targets, head, vocab: int, shard_fn=None):
    """Sum of the next-token NLL of one chunk of features ``h`` (B, C, d)
    through ``head`` (d, V)."""
    logits = h @ head
    if shard_fn is not None:
        logits = shard_fn(logits, "logits")
    return token_nll(logits, targets, vocab).sum()


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    dims: PaddedDims
    remat: str = "none"

    def __post_init__(self):
        if self.cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"family {self.cfg.family!r} "
                             f"({self.cfg.name}) is not yet ported")
        lm.remat_policy(self.remat)         # raises on an unknown name

    @property
    def _serves(self) -> _Serves:
        """This family's entry points: ``lm`` (dense, moe, vlm), ``ssm_lm``
        (ssm, hybrid) or ``encdec`` (audio)."""
        return SERVES[self.cfg.family]

    def init(self, seed: int = 0, dtype=torch.float32, device="cuda"):
        """Random weights from a ``torch.Generator`` seeded with ``seed``
        on ``device``."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return self._serves.init(gen, self.cfg, self.dims, dtype)

    # ------------------------------------------------------------ training
    def forward(self, params, batch, shard_fn=None,
                return_features: bool = False):
        """The full-sequence forward: (logits, aux), or (features, aux)
        with ``return_features``. A vlm batch carries ``patch_embeds``, an
        audio batch ``frame_embeds``."""
        return self._serves.forward(params, batch, self.cfg, self.dims,
                                    remat=self.remat, shard_fn=shard_fn,
                                    return_features=return_features)

    def _head(self, params):
        head = params.get("lm_head")
        return head if head is not None else params["embed"].T

    def loss(self, params, batch, shard_fn=None, loss_chunk: int = 2048):
        """Next-token CE through a sequence-chunked head and softmax, plus
        0.01 x the MoE aux loss: (total, {"ce", "aux"}). A vlm model
        predicts its tokens from the positions P - 1 .. P + S - 2 (the
        last patch predicts the first token); every other family predicts
        tokens 1 .. S - 1."""
        feats, aux = self.forward(params, batch, shard_fn=shard_fn,
                                  return_features=True)
        toks = batch["tokens"]
        if self.cfg.family == "vlm":
            P = self.cfg.num_patches
            pred_h, targets = feats[:, P - 1:P + toks.shape[1] - 1], toks
        else:
            pred_h, targets = feats[:, :-1], toks[:, 1:]
        ce = self._chunked_ce(params, pred_h, targets, loss_chunk, shard_fn)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def _chunked_ce(self, params, pred_h, targets, loss_chunk: int,
                    shard_fn=None):
        """Mean NLL over the (B, S) positions, ``loss_chunk`` positions at
        a time, each chunk's head and softmax recomputed in the backward:
        the (B, S, V) logits are never held whole. The reference pads S to
        a multiple of the chunk and masks; summing the chunks without
        padding is the same value."""
        head = self._head(params)
        B, S = targets.shape
        total = torch.zeros((), dtype=torch.float32, device=pred_h.device)
        for c0 in range(0, S, loss_chunk):
            c = slice(c0, c0 + loss_chunk)
            total = total + ckpt.checkpoint(
                _ce_sum, pred_h[:, c], targets[:, c], head,
                self.cfg.vocab_size, shard_fn, use_reentrant=False)
        return total / max(B * S, 1)

    # ------------------------------------------------------------- serving
    def init_serve_state(self, batch: int, cache_len: int,
                         cache_dtype=torch.bfloat16, device="cuda"):
        """``cache_dtype`` may be the string "int8" for dense, moe and vlm:
        the KV pool is then int8 with per-(token, head) f32 absmax scales
        (``serving.kv_quant``). A vlm pool holds ``cache_len`` +
        ``num_patches`` positions a row."""
        if lm.is_int8(cache_dtype) and self._serves.module is not lm:
            raise ValueError(
                f"int8 cache needs an attention KV pool; family="
                f"{self.cfg.family!r} keeps its state in float")
        return self._serves.init_state(self.cfg, self.dims, batch,
                                       cache_len, cache_dtype,
                                       resolve_device(device))

    def prefill(self, params, batch, cache_len: int,
                cache_dtype=torch.bfloat16, shard_fn=None,
                attn_backend: str = "pallas"):
        """``attn_backend="pallas"`` runs the prompt through the kernels
        (flash-attention; the SSD scan for ssm/hybrid); ``"einsum"`` through
        the reference's dense paths. A vlm batch carries ``patch_embeds``
        (B, P, d), an audio batch ``frame_embeds`` (B, Le, d)."""
        return self._serves.prefill(params, batch, self.cfg, self.dims,
                                    cache_len=cache_len,
                                    cache_dtype=cache_dtype,
                                    attn_backend=attn_backend,
                                    shard_fn=shard_fn)

    def prefill_chunk(self, params, state, tokens, offsets, lengths,
                      shard_fn=None, rows=None, attn_backend: str = "pallas"):
        """Advance a chunked prefill: run ``tokens`` (B, C) at per-row cache
        ``offsets`` (B,) against the carried serve state (the KV cache for
        dense; SSM, conv and attention state for ssm/hybrid), batch row b
        in state row ``rows[b]`` (default b), updated in place. Returns
        (last-real-token logits, state, pos (B,) = offset + length).
        Chunk by chunk equals the single-shot ``prefill``. moe raises, as
        in the reference: per-chunk routing would drop other tokens than
        single-shot; vlm and audio raise, as in the reference: their
        requests carry per-request extras."""
        if self.cfg.family in ("moe", "vlm", "audio", "hybrid_moe"):
            raise ValueError(
                f"chunked prefill unsupported for {self.cfg.family!r}")
        chunk = lm.lm_prefill_chunk if self._serves.module is lm \
            else ssm_lm.ssm_prefill_chunk
        return chunk(params, state, tokens, offsets, lengths, self.cfg,
                     self.dims, rows=rows, attn_backend=attn_backend,
                     shard_fn=shard_fn)

    def decode(self, params, state, tokens, pos, shard_fn=None,
               attn_backend: str = "pallas", write_rows=None):
        """``attn_backend="pallas"`` decodes attention through the
        flash-decode kernel; ``"einsum"`` keeps the reference's dense path.
        ``write_rows`` limits the state write to those rows (see
        ``lm.lm_decode``, ``ssm_lm.ssm_decode``)."""
        return self._serves.decode(params, state, tokens, pos, self.cfg,
                                   self.dims, attn_backend=attn_backend,
                                   write_rows=write_rows, shard_fn=shard_fn)

    # ---------------------------------------------------------- dry-run IO
    def input_specs(self, shape: ShapeConfig, act_dtype=torch.bfloat16,
                    cache_dtype=torch.bfloat16) -> dict:
        """``meta`` stand-ins (no memory) of every input of a cell: the
        train or prefill batch (``tokens`` (B, S) int32, a vlm's
        ``patch_embeds``, an audio model's ``frame_embeds``); for decode
        one new token a row against a cache of S positions (``state`` from
        ``init_serve_state`` on ``meta``). The reference's decode ``pos``
        is one scalar; the port's decode takes one a row, so it is (B,)."""
        c = self.cfg
        B, S = shape.global_batch, shape.seq_len
        meta = dict(device="meta")
        if shape.kind in ("train", "prefill"):
            specs = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                           **meta)}
            if c.family == "vlm":
                specs["patch_embeds"] = torch.empty(
                    (B, c.num_patches, c.d_model), dtype=act_dtype, **meta)
            if c.family == "audio":
                specs["frame_embeds"] = torch.empty(
                    (B, c.encoder_seq_len, c.d_model), dtype=act_dtype,
                    **meta)
            return specs
        return {"tokens": torch.empty((B, 1), dtype=torch.int32, **meta),
                "pos": torch.empty((B,), dtype=torch.int32, **meta),
                "state": self.init_serve_state(B, S, cache_dtype,
                                               device="meta")}


def make_model(cfg: ArchConfig, tp: int = 1, remat: str = "none") -> Model:
    return Model(cfg, padded_dims(cfg, tp), remat)


def _laid_like(g, p):
    """``g`` redistributed to ``p``'s placements when both are DTensors."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _microbatches(v, grad_accum: int):
    """``v`` (B, ...) as (grad_accum, B / grad_accum, ...): microbatch i
    is rows i·B/ga .. (i+1)·B/ga - 1, as in the reference. A DTensor split
    on its batch dim is gathered whole there first (DTensor will not split
    a sharded dim in a view) and each microbatch split over the same axes
    again."""
    if not isinstance(v, DTensor):
        return v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])
    mesh, lay = v.device_mesh, list(v.placements)
    whole = v.redistribute(mesh, [Replicate() if p.is_shard(0) else p
                                  for p in lay])
    m = whole.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])
    return m.redistribute(mesh, [Shard(1) if p.is_shard(0) else p
                                 for p in lay])


def make_train_step(model: Model, optimizer, shard_fn=None, *,
                    grad_accum: int = 1, loss_chunk: int = 2048,
                    accum_dtype=torch.float32):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss's gradient by autograd over the parameter tree,
    then one ``optimizer.update``. Metrics: ``loss``, ``ce``, ``aux``,
    ``grad_norm``, ``lr`` (tensors; nothing is read back to the host).

    ``grad_accum > 1`` splits the batch on axis 0 into that many
    microbatches, adds their gradients in ``accum_dtype`` and divides:
    one update over the whole batch, with one microbatch's activations
    held at a time. ``loss`` is then the microbatches' mean; ``ce`` and
    ``aux`` are the last microbatch's, as in the reference.

    Sharded: ``params``, ``opt_state`` and ``batch`` are DTensors
    (``sharding.place_params``, ``place_batch``) and ``shard_fn`` places
    the activations; the step runs under ``implicit_replication``."""
    # torch.utils.checkpoint imports torch._dynamo at its first call, and
    # that import keeps a traceback whose frames reach back through the
    # caller's, holding a step's params and state for good: import it here
    import torch._dynamo  # noqa: F401

    def grads_of(params, batch):
        return value_and_grad(
            lambda p: model.loss(p, batch, shard_fn=shard_fn,
                                 loss_chunk=loss_chunk), params,
            has_aux=True)

    def train_step(params, opt_state, batch):
        with implicit_replication():
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        if grad_accum <= 1:
            (loss, metrics), grads = grads_of(params, batch)
        else:
            micro = {k: _microbatches(v, grad_accum)
                     for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=accum_dtype), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=micro["tokens"].device)
            for i in range(grad_accum):
                (l, metrics), g = grads_of(
                    params, {k: v[i] for k, v in micro.items()})
                grads = tree_map(lambda a, b: a + b.to(accum_dtype), grads,
                                 g)
                loss = loss + l
            grads = tree_map(lambda g: g / grad_accum, grads)
            loss = loss / grad_accum
        # each gradient in its param's layout (a DTensor's comes back
        # partial or split otherwise), so the update keeps the layouts
        grads = tree_map(_laid_like, grads, params)
        params, opt_state, stats = optimizer.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, loss=loss, **stats)
    return train_step


def make_decode_step(model: Model, shard_fn=None,
                     attn_backend: str = "pallas"):
    """``serve_step(params, state, tokens, pos) -> (logits, state)``, under
    ``implicit_replication`` for DTensor params and state."""
    def serve_step(params, state, tokens, pos):
        with implicit_replication():
            return model.decode(params, state, tokens, pos,
                                shard_fn=shard_fn, attn_backend=attn_backend)
    return serve_step


def make_prefill_step(model: Model, cache_len: int, shard_fn=None,
                      attn_backend: str = "pallas"):
    """``prefill_step(params, batch) -> (logits, state, pos)``, under
    ``implicit_replication`` for DTensor params and batch."""
    def prefill_step(params, batch):
        with implicit_replication():
            return model.prefill(params, batch, cache_len=cache_len,
                                 shard_fn=shard_fn,
                                 attn_backend=attn_backend)
    return prefill_step
