"""Synthetic serving requests (a copy of ``repro.data.pipeline``'s
``prompt_workload``)."""
from __future__ import annotations

import numpy as np


def prompt_workload(vocab: int, n: int, seed: int = 0, max_len: int = 12,
                    max_new: int = 16):
    """Synthetic serving requests for the engine examples/tests."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(2, max_len))
        out.append({
            "rid": i,
            "prompt": rng.integers(1, vocab, size=plen).tolist(),
            "max_new_tokens": int(rng.integers(4, max_new)),
        })
    return out
