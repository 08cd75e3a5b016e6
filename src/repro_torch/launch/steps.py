"""Train and serve step factories — port of ``repro/launch/steps.py``:
the loss (``cross_entropy``, ``chunked_cross_entropy``, ``loss_fn``),
``make_train_step`` with microbatched gradient accumulation, and
``make_serve_step`` and ``make_prefill_step``."""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.bridge import leaves, tree_map, unflatten
from repro_torch.kernels import ops
from repro_torch.models.attention import NEG_INF
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (_lm_head, decode_step, encode,
                                            forward_hidden, prefill_hidden,
                                            local_params)
from repro_torch.optim import OptConfig, clip_by_global_norm, make_optimizer
from repro_torch.optim.adamw import scaled

F32 = torch.float32


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE by logsumexp in fp32, never forming log-probs."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    lab = lg.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - lab).mean()


CE_CHUNK = 512


def _chunk_ce(x_c, head, l_c, v_c, transpose_head: bool, vocab, impl: str):
    """Summed CE of one chunk: its (B, C, V) logits through ``ops.matmul``
    (a transposed head, the tied table, read in place), the padded vocab
    tail masked, reduced to logsumexp and the label logit."""
    logits = ops.matmul(x_c, head, b_transposed=transpose_head, impl=impl)
    lg = logits.float()
    V = lg.shape[-1]
    if vocab and vocab != V:   # the padded vocab tail never scores
        lg = lg.masked_fill(torch.arange(V, device=lg.device) >= vocab,
                            NEG_INF)
    lse = torch.logsumexp(lg, dim=-1)
    lab = lg.gather(-1, l_c.long()[..., None])[..., 0]
    return ((lse - lab) * v_c).sum()


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, transpose_head: bool,
                          vocab: int | None = None,
                          impl: str = "auto") -> torch.Tensor:
    """Fused LM head + CE over sequence chunks of CE_CHUNK, as the
    reference's (``steps.py:30-64``): the (B, S, V) logits never exist;
    each chunk's (B, C, V) logits reduce to two (B, C) rows, the chunk
    sums accumulate in fp32 in order, and (with grad enabled) each chunk
    runs again in the backward pass under ``torch.utils.checkpoint``.
    x: (B, S, d); head: (V, d) with ``transpose_head``, else (d, V)."""
    B, S, _ = x.shape
    C = min(CE_CHUNK, S)
    pad = (-S) % C
    xs = torch.nn.functional.pad(x, (0, 0, 0, pad))
    ls = torch.nn.functional.pad(labels, (0, pad))
    vs = torch.nn.functional.pad(torch.ones((B, S), dtype=F32,
                                            device=x.device), (0, pad))
    total = torch.zeros((), dtype=F32, device=x.device)
    for c in range(0, S + pad, C):
        args = (xs[:, c:c + C], head, ls[:, c:c + C], vs[:, c:c + C],
                transpose_head, vocab, impl)
        if torch.is_grad_enabled():
            part = torch.utils.checkpoint.checkpoint(_chunk_ce, *args,
                                                     use_reentrant=False)
        else:
            part = _chunk_ce(*args)
        total = total + part
    return total / (B * S)


def model_context(params, cfg: ModelConfig, ctx, impl: str = "auto"):
    """What the cross-attention layers attend to: the encoded frames for
    encoder-decoder configs (``encode`` runs on every call, as the
    reference's prefill step and decode loop run it), else ``ctx`` as
    given (the image patches of a VLM, None for a decoder-only config)."""
    return encode(params, cfg, ctx, impl) if cfg.is_encdec else ctx


def loss_fn(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, ctx: torch.Tensor | None,
            impl: str = "auto") -> torch.Tensor:
    """CE of the chunked LM head on the final hidden states + 0.01 x the
    MoE aux loss (``steps.py:67-74``)."""
    c = model_context(params, cfg, ctx, impl)
    x, aux = forward_hidden(params, cfg, tokens, c, impl)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    ce = chunked_cross_entropy(x, head, labels, cfg.tie_embeddings,
                               vocab=cfg.vocab, impl=impl)
    return ce + 0.01 * aux


def value_and_grad(params: dict, cfg: ModelConfig, tokens, labels, ctx,
                   impl: str = "auto", stack: bool = True
                   ) -> tuple[torch.Tensor, dict]:
    """(loss, grads of ``loss_fn`` for every leaf of ``params``), as
    ``jax.value_and_grad(loss_fn)`` gives them: each grad in its leaf's
    dtype. A stacked ``periods/`` leaf enters the loss as its period
    slices, each a leaf of its own, so that autograd hands back one grad a
    slice (a slice of one stacked tensor would get a full-size,
    zero-padded grad for each period); their grads are stacked, or with
    ``stack=False`` returned as the list of slices. Nothing in ``params``
    is modified."""
    flat = dict(leaves(params))
    free = {p: ([x[i].detach().requires_grad_() for i in range(x.shape[0])]
                if p.startswith("periods/") else x.detach().requires_grad_())
            for p, x in flat.items()}
    loss = loss_fn(unflatten(free), cfg, tokens, labels, ctx, impl)
    order = [(p, t) for p, x in free.items()
             for t in (x if isinstance(x, list) else [x])]
    got = torch.autograd.grad(loss, [t for _, t in order], allow_unused=True)
    grads: dict = {}
    for (p, t), g in zip(order, got):
        g = torch.zeros_like(t) if g is None else g
        if isinstance(free[p], list):
            grads.setdefault(p, []).append(g)
        else:
            grads[p] = g
    if stack:
        grads = {p: torch.stack(g) if isinstance(g, list) else g
                 for p, g in grads.items()}
    return loss.detach(), unflatten(grads)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    microbatches: int = 1, impl: str = "auto"):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}) (``steps.py:77-125``). batch = {"tokens",
    "labels"[, "ctx"]} with a global batch dim that microbatching splits
    in order. With microbatches > 1 the grads accumulate in each param's
    dtype from zeros (bf16 for bf16 leaves), are scaled by 1/microbatches
    in fp32 and rounded back, and the loss accumulates in fp32; then
    ``clip_by_global_norm`` and the optimizer. Inputs are not modified."""
    _, opt_update = make_optimizer(opt_cfg)

    def train_step(params, opt_state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        ctx = batch.get("ctx")
        if microbatches == 1:
            loss, grads = value_and_grad(params, cfg, tokens, labels, ctx,
                                         impl)
        else:
            # the reference reshapes the batch to (microbatches, mb, ...),
            # which raises unless microbatches divide it
            if tokens.shape[0] % microbatches:
                raise ValueError(f"a batch of {tokens.shape[0]} rows does "
                                 f"not split into {microbatches} "
                                 f"microbatches")
            mb = tokens.shape[0] // microbatches
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.bfloat16 if p.dtype == torch.bfloat16
                else F32, device=p.device), params)
            loss = torch.zeros((), dtype=F32, device=tokens.device)
            for i in range(microbatches):
                part = slice(i * mb, (i + 1) * mb)
                loss_i, g_i = value_and_grad(
                    params, cfg, tokens[part], labels[part],
                    None if ctx is None else ctx[part], impl, stack=False)
                flat = dict(leaves(g_i))
                for path, acc in leaves(grads):
                    g = flat[path]
                    for a, gj in (zip(acc, g) if isinstance(g, list)
                                  else ((acc, g),)):
                        a.add_(gj.to(a.dtype))
                loss = loss + loss_i
                del g_i, flat
            scale = 1.0 / microbatches
            grads = tree_map(lambda g: scaled(g, scale), grads)
            loss = loss * scale
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        params, opt_state = opt_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_serve_step(cfg: ModelConfig, impl: str = "auto", mesh=None):
    """Returns serve_step(params, token, cache[, ctx]) -> (next_ids, cache):
    one greedy decode step (B,1) int32 -> (B,1) int32; ``ctx`` is the
    cross-attention context as ``model_context`` gives it. On a ``mesh``
    (``models/transformer.py``) the params may be DTensors and the rest
    is this rank's rows."""

    def serve_step(params, token, cache, ctx=None):
        logits, cache = decode_step(params, cfg, token, cache, ctx, impl=impl,
                                    mesh=mesh)
        next_ids = logits[:, -1].argmax(dim=-1).int()
        return next_ids[:, None], cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, impl: str = "auto", mesh=None):
    """Returns prefill_step(params, tokens[, ctx]) -> (last_logits, cache);
    an encoder-decoder config encodes ``ctx`` (its frames) first. Like the
    reference, it calls prefill without ``cache_len``, so every decode
    buffer is ``prompt_len`` wide. Only the final position's logits are
    computed: the LM head runs on that row alone instead of computing the
    full (B,S,V) logits and slicing them, a 2 GB tensor at gemma3-1b
    with a batch of 4 and 1024-token prompts. On a ``mesh`` as
    ``make_serve_step``."""

    def prefill_step(params, tokens, ctx=None):
        if mesh is not None:
            params = local_params(params, mesh)
        c = model_context(params, cfg, ctx, impl)
        x, cache = prefill_hidden(params, cfg, tokens, c, impl=impl,
                                  mesh=mesh)
        return _lm_head(params, cfg, x[:, -1:], impl), cache

    return prefill_step
