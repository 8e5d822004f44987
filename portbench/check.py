"""How ``correct`` is decided: the served tokens against the plain
reference, and the frontend's ledger.

Served tokens. Once the window has closed and the program's state is
freed, a sample drawn from the seed of the counted requests that
finished, with the longest of them in it, until it holds ``SAMPLE_TOKENS``
served tokens or ``SAMPLE_MAX`` requests: the reference (``reference/
<family>.py``, float32, on the weights the benchmark made) runs once over
each prompt followed by its served tokens, and at each served token reads
how far its logit lies below the reference's best at that position. The
number compared is the widest such gap (``served_gap``). Greedy decoding
serves the token the program ranks first, so a sound run's gaps are its
rounding; a token altered where it is produced, or a state the decode
does not carry, reads the logits' own spread.

The control (``control_gaps``): the reference itself in float8 e4m3, the
step below the served bfloat16, at each position of the same prompts and
tokens, read at the token it puts first.

Ledger. Every request due in the window ends in exactly one state: a
``finished`` one is in the frontend's finished list once and a ``live``
one is held in exactly one queue or slot; nothing is served twice
(``ledger_faults``, limit 0).
"""
from __future__ import annotations

import collections

import numpy as np
import torch

SAMPLE_TOKENS = 600
SAMPLE_MAX = 16


def sample(counted: list, seed: int) -> list:
    """The finished counted requests to compare: the one with the most
    served tokens, then others in an order drawn from the seed."""
    done = [tr for tr in counted if tr.req.finish_time is not None
            and tr.req.output]
    if not done:
        return []
    longest = max(done, key=lambda tr: (len(tr.req.output), -tr.req.rid))
    rest = [tr for tr in done if tr is not longest]
    order = np.random.default_rng([seed % 2**64, 11]).permutation(len(rest))
    out, n = [longest], len(longest.req.output)
    for i in order:
        if n >= SAMPLE_TOKENS or len(out) >= SAMPLE_MAX:
            break
        out.append(rest[i])
        n += len(rest[i].req.output)
    return out


def enough_finished(counted: list) -> bool:
    """Whether the counted requests that finished hold a full sample's
    served tokens (or all of them finished): the run waits for that."""
    n, done = 0, True
    for tr in counted:
        if tr.req.finish_time is None:
            done = False
        else:
            n += len(tr.req.output)
    return done or n >= SAMPLE_TOKENS


def _inputs(picked: list) -> tuple:
    seqs = [list(tr.req.prompt) + list(tr.req.output[:-1]) for tr in picked]
    starts = [len(tr.req.prompt) - 1 for tr in picked]
    served = [torch.as_tensor(tr.req.output) for tr in picked]
    return seqs, starts, served


def served_gaps(ref, weights: dict, cfg: dict, picked: list) -> np.ndarray:
    """The gap of every sampled served token below the reference's best."""
    seqs, starts, served = _inputs(picked)
    out = []
    for lg, tok in zip(ref.logits(weights, cfg, seqs, starts), served):
        tok = tok.to(lg.device)
        gap = lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0]
        out.append(gap.cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def control_gaps(ref, weights: dict, cfg: dict, picked: list) -> np.ndarray:
    """The gap, in the float32 reference, of the token that the float8
    reference puts first at each of the same positions."""
    seqs, starts, _ = _inputs(picked)
    exact = ref.logits(weights, cfg, seqs, starts)
    low = ref.logits(weights, cfg, seqs, starts, quant="fp8")
    out = []
    for e, q in zip(exact, low):
        top = q.argmax(-1)
        out.append((e.max(-1).values - e.gather(1, top[:, None])[:, 0])
                   .cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def ledger_faults(system, counted: list) -> int:
    """Counted requests that do not end in exactly one state."""
    fe = system.fe
    led = fe.ledger
    fin = collections.Counter(r.rid for r in fe.finished)
    held = system.held()
    bad = 0
    for tr in counted:
        rid = tr.req.rid
        state = led.state.get(rid)
        if state == "live":
            ok = fin[rid] == 0 and held[rid] == 1
        else:                    # a terminal state: finished once
            ok = state is not None and fin[rid] == 1 and held[rid] == 0
        bad += not ok
    return bad + led.double_served + led.duplicates
