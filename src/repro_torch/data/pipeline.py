"""Deterministic synthetic token stream and the modality-frontend stub,
copied from ``repro.data.pipeline`` (``SyntheticLM``, ``modality_stub``)
so that both packages serve the same prompts and contexts from the same
seed."""

from __future__ import annotations

import dataclasses
import zlib

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


def modality_stub(kind: str, batch: int, tokens: int, d_model: int,
                  seed: int = 0) -> np.ndarray:
    """Precomputed patch/frame embeddings standing in for the (stubbed)
    vision/speech frontend (assignment: backbone only)."""
    # crc32, not hash(): str hashes are salted per process (PYTHONHASHSEED)
    # and would give each run a different stream for the same kind
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed, zlib.crc32(kind.encode()) % (2 ** 31)]))
    return rng.standard_normal((batch, tokens, d_model)).astype(np.float32)
