"""Token data pipeline, copied from ``repro.data.pipeline`` so that both
packages serve the same prompts, batches and contexts from the same seed:
the deterministic synthetic stream (``SyntheticLM``), the memmap-backed
corpus (``MemmapTokens``), host-sharded batch iteration
(``batch_iterator``) and the modality-frontend stub (``modality_stub``).
NumPy only."""

from __future__ import annotations

import dataclasses
import zlib
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    """Deterministic Zipf-ish token stream — every (host, step) batch is
    reproducible from the seed alone, so restarts resume bit-identically."""

    vocab: int
    seed: int = 0

    def batch(self, step: int, host: int, batch: int, seq: int
              ) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host]))
        # zipf-like skew over the vocab, clipped
        raw = rng.zipf(1.3, size=(batch, seq + 1))
        tokens = (raw % self.vocab).astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


class MemmapTokens:
    """Flat binary token corpus (np.memmap, int32), packed into fixed-length
    sequences with block-shuffled epochs; host-sharded by stride."""

    def __init__(self, path: str, seq: int, *, host: int = 0,
                 num_hosts: int = 1, seed: int = 0):
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.seq = seq
        self.host = host
        self.num_hosts = num_hosts
        self.seed = seed
        self.n_seqs = (len(self.data) - 1) // seq

    def epoch(self, epoch: int) -> Iterator[dict[str, np.ndarray]]:
        order = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch])
        ).permutation(self.n_seqs)
        for idx in order[self.host::self.num_hosts]:
            lo = idx * self.seq
            chunk = np.asarray(self.data[lo: lo + self.seq + 1])
            yield {"tokens": chunk[:-1].astype(np.int32)[None],
                   "labels": chunk[1:].astype(np.int32)[None]}


def batch_iterator(source: SyntheticLM, batch: int, seq: int, *,
                   host: int = 0, start_step: int = 0
                   ) -> Iterator[dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield source.batch(step, host, batch, seq)
        step += 1


def modality_stub(kind: str, batch: int, tokens: int, d_model: int,
                  seed: int = 0) -> np.ndarray:
    """Precomputed patch/frame embeddings standing in for the (stubbed)
    vision/speech frontend (assignment: backbone only)."""
    # crc32, not hash(): str hashes are salted per process (PYTHONHASHSEED)
    # and would give each run a different stream for the same kind
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed, zlib.crc32(kind.encode()) % (2 ** 31)]))
    return rng.standard_normal((batch, tokens, d_model)).astype(np.float32)
