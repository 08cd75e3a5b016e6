"""Serve step factories — port of ``make_serve_step`` and
``make_prefill_step`` (``repro/launch/steps.py:128-152``)."""

from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _lm_head, decode_step, prefill_hidden


def make_serve_step(cfg: ModelConfig, impl: str = "auto"):
    """Returns serve_step(params, token, cache) -> (next_ids, cache): one
    greedy decode step (B,1) int32 -> (B,1) int32."""

    def serve_step(params, token, cache):
        logits, cache = decode_step(params, cfg, token, cache, impl=impl)
        next_ids = logits[:, -1].argmax(dim=-1).int()
        return next_ids[:, None], cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, impl: str = "auto"):
    """Returns prefill_step(params, tokens) -> (last_logits, cache). Like the
    reference, it calls prefill without ``cache_len``, so every decode
    buffer is ``prompt_len`` wide. Only the final position's logits are
    computed: the LM head runs on that row alone instead of computing the
    full (B,S,V) logits and slicing them, a 2 GB tensor at gemma3-1b
    with a batch of 4 and 1024-token prompts."""

    def prefill_step(params, tokens):
        x, cache = prefill_hidden(params, cfg, tokens, impl=impl)
        return _lm_head(params, cfg, x[:, -1:], impl), cache

    return prefill_step
