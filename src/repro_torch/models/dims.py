"""Physical (TP-padded) model dimensions (a copy of ``repro.models.dims``).

TPU tensor parallelism requires head counts / vocab divisible by the TP degree.
``PaddedDims`` derives the *physical* dimensions used to build parameters from
the *logical* ``ArchConfig`` plus the TP degree:

  - KV heads: if ``kv < tp`` the kv heads are replicated ``tp // kv`` times
    (vLLM-style). Replicating a GQA kv head is mathematically exact.
  - Q heads: each logical kv-group's queries are split across the replicas of
    its kv head; the per-physical-group query count is padded up so every
    physical group is equal-sized. Padded q-head slots are masked to zero
    after attention so they are exactly inert (forward and backward).
  - Vocab: padded to a multiple of ``vocab_multiple`` (2048 for TP=16) —
    padded logits are masked to -inf before softmax.

With ``tp == 1`` everything collapses to the logical dims (no padding), which
is what the CPU smoke tests exercise; a dedicated test checks padded==unpadded
equivalence.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.configs.base import ArchConfig


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class PaddedDims:
    tp: int
    n_q: int          # physical query heads
    n_kv: int         # physical kv heads (replication included)
    q_per_group: int  # physical q heads per physical kv head
    kv_rep: int       # replication factor of each logical kv head
    vocab: int        # physical (padded) vocab
    q_real: tuple     # bool per physical q head: is it a real (non-pad) head?

    @property
    def pad_flops_ratio(self) -> float:
        """useful q-heads / physical q-heads (roofline useful-ratio term)."""
        return sum(self.q_real) / max(self.n_q, 1)


def padded_dims(cfg: ArchConfig, tp: int = 1, vocab_multiple: int = 0) -> PaddedDims:
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if vocab_multiple == 0:
        vocab_multiple = max(tp * 128, 128) if tp > 1 else 1
    vocab = _round_up(cfg.vocab_size, vocab_multiple)
    if H == 0:  # attention-free
        return PaddedDims(tp, 0, 0, 0, 1, vocab, ())
    if H % KV != 0:
        raise ValueError(f"{cfg.name}: num_heads {H} not divisible by kv {KV}")
    qpg = H // KV
    if KV >= tp:
        if KV % tp != 0:
            raise ValueError(f"{cfg.name}: kv={KV} not divisible by tp={tp}")
        rep = 1
    else:
        if tp % KV != 0:
            raise ValueError(f"{cfg.name}: tp={tp} not a multiple of kv={KV}")
        rep = tp // KV
    n_kv = KV * rep
    qpg_phys = math.ceil(qpg / rep)
    n_q = n_kv * qpg_phys
    # real-head mask: physical group p = (logical group g, replica r);
    # slot j is real iff r*qpg_phys + j < qpg.
    q_real = []
    for p in range(n_kv):
        r = p % rep
        for j in range(qpg_phys):
            q_real.append(r * qpg_phys + j < qpg)
    assert sum(q_real) == H, (sum(q_real), H)
    return PaddedDims(tp, n_q, n_kv, qpg_phys, rep, vocab, tuple(q_real))


def q_head_mask(dims: PaddedDims) -> np.ndarray:
    """(n_q,) float mask — 1 for real heads, 0 for padding."""
    return np.asarray(dims.q_real, dtype=np.float32)
