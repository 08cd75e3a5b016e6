"""Serve step factories — port of ``make_serve_step`` and
``make_prefill_step`` (``repro/launch/steps.py:128-152``)."""

from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (_lm_head, decode_step, encode,
                                            prefill_hidden)


def model_context(params, cfg: ModelConfig, ctx, impl: str = "auto"):
    """What the cross-attention layers attend to: the encoded frames for
    encoder-decoder configs (``encode`` runs on every call, as the
    reference's prefill step and decode loop run it), else ``ctx`` as
    given (the image patches of a VLM, None for a decoder-only config)."""
    return encode(params, cfg, ctx, impl) if cfg.is_encdec else ctx


def make_serve_step(cfg: ModelConfig, impl: str = "auto"):
    """Returns serve_step(params, token, cache[, ctx]) -> (next_ids, cache):
    one greedy decode step (B,1) int32 -> (B,1) int32; ``ctx`` is the
    cross-attention context as ``model_context`` gives it."""

    def serve_step(params, token, cache, ctx=None):
        logits, cache = decode_step(params, cfg, token, cache, ctx, impl=impl)
        next_ids = logits[:, -1].argmax(dim=-1).int()
        return next_ids[:, None], cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, impl: str = "auto"):
    """Returns prefill_step(params, tokens[, ctx]) -> (last_logits, cache);
    an encoder-decoder config encodes ``ctx`` (its frames) first. Like the
    reference, it calls prefill without ``cache_len``, so every decode
    buffer is ``prompt_len`` wide. Only the final position's logits are
    computed: the LM head runs on that row alone instead of computing the
    full (B,S,V) logits and slicing them, a 2 GB tensor at gemma3-1b
    with a batch of 4 and 1024-token prompts."""

    def prefill_step(params, tokens, ctx=None):
        c = model_context(params, cfg, ctx, impl)
        x, cache = prefill_hidden(params, cfg, tokens, c, impl=impl)
        return _lm_head(params, cfg, x[:, -1:], impl), cache

    return prefill_step
