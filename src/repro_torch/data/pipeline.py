"""Synthetic data (a copy of ``repro.data.pipeline``, numpy only): the
training corpus ``MarkovCorpus`` and its ``DataLoader``, and the serving
requests of ``prompt_workload``. Same seed, same tokens as the reference,
bit for bit.

``MarkovCorpus`` generates token streams from a seeded sparse Markov chain
with Zipfian marginals and planted induction patterns: enough learnable
structure that a small model's loss drops well below the unigram entropy
within a few hundred steps (``launch.train``'s check).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MarkovCorpus:
    vocab_size: int
    seed: int = 0
    branching: int = 8            # successors per state
    zipf_a: float = 1.2
    induction_p: float = 0.2      # chance to copy an earlier bigram

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V, B = self.vocab_size, self.branching
        # Zipfian unigram prior over successor choices
        ranks = np.arange(1, V + 1, dtype=np.float64)
        zipf = 1.0 / ranks ** self.zipf_a
        zipf /= zipf.sum()
        self.successors = rng.choice(V, size=(V, B), p=zipf)
        probs = rng.dirichlet(np.ones(B) * 0.5, size=V)
        self.probs = probs.astype(np.float64)

    def sample(self, rng: np.random.Generator, batch: int, seq: int
               ) -> np.ndarray:
        V, B = self.vocab_size, self.branching
        out = np.empty((batch, seq), np.int64)
        state = rng.integers(0, V, size=batch)
        for t in range(seq):
            u = rng.random(batch)
            # vectorized categorical over each row's successor distribution
            cdf = np.cumsum(self.probs[state], axis=1)
            choice = (u[:, None] > cdf).sum(axis=1).clip(0, B - 1)
            state = self.successors[state, choice]
            # induction: occasionally replay the token from 8 steps back
            if t >= 8:
                replay = rng.random(batch) < self.induction_p
                state = np.where(replay, out[:, t - 8], state)
            out[:, t] = state
        return out

    def unigram_entropy(self, n: int = 20000) -> float:
        rng = np.random.default_rng(123)
        toks = self.sample(rng, 8, n // 8).reshape(-1)
        _, counts = np.unique(toks, return_counts=True)
        p = counts / counts.sum()
        return float(-(p * np.log(p)).sum())


@dataclasses.dataclass
class DataLoader:
    """Sharded, prefetch-free loader: batch = global_batch // n_hosts rows
    of ``seq_len`` tokens (numpy int32) and their next-token targets."""
    corpus: MarkovCorpus
    global_batch: int
    seq_len: int
    host_id: int = 0
    n_hosts: int = 1
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(
            (self.seed * 1009 + self.host_id) % (2 ** 31))
        self.local_batch = self.global_batch // self.n_hosts

    def __iter__(self):
        return self

    def __next__(self):
        toks = self.corpus.sample(self._rng, self.local_batch,
                                  self.seq_len + 1)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}


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
