"""Deterministic synthetic token stream, copied from
``repro.data.pipeline.SyntheticLM`` so that both packages serve the same
prompts from the same seed."""

from __future__ import annotations

import dataclasses

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
