"""Optimizers: AdamW (fp32 moments) and a factored-second-moment variant
("adafactor-m": bf16 first moment + row/col-factored second moment) —
the port of ``repro/optim/adamw.py:22-160``.

Functional, as the reference: params, grads and states are nested dicts
of tensors that mirror the param tree, and every update returns new
tensors, leaving its inputs as they were. The reference's rounding is the
contract: fp32 moments and bias correction, decay on every leaf with
``ndim >= 2`` (the stacked ``periods/...`` norm scales, (n_periods, d),
included), the global norm summed over leaves in ``bridge.leaves`` order
(JAX's sorted keys) in fp32. Elementwise updates of a stacked leaf run
one period slice at a time, which changes no bit and bounds the fp32
temporaries to a slice (a granite-3-2b FFN leaf is 2.7 GB whole in fp32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator

import torch

from repro_torch.bridge import leaves, tree_map, unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"            # "adamw" | "adafactor"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: OptConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _slices(*xs: torch.Tensor) -> Iterator[tuple[torch.Tensor, ...]]:
    """Aligned slices of same-shaped tensors along dim 0 when they have 3
    dims or more (a stacked leaf, one period each), else the tensors."""
    if xs[0].dim() >= 3:
        for i in range(xs[0].shape[0]):
            yield tuple(x[i] for x in xs)
    else:
        yield xs


def _zip(fn, *trees) -> list:
    """``fn(path, leaf, ...)`` over the leaves of same-structured trees."""
    flat = [dict(leaves(t)) for t in trees]
    return [fn(p, *(f[p] for f in flat)) for p in flat[0]]


def scaled(g: torch.Tensor, factor) -> torch.Tensor:
    """(g in fp32 x factor) rounded back to g's dtype, a new tensor."""
    out = torch.empty_like(g)
    for o, gi in _slices(out, g):
        o.copy_(gi.float() * factor)
    return out


def clip_by_global_norm(grads: dict, max_norm: float
                        ) -> tuple[dict, torch.Tensor]:
    """(grads x min(1, max_norm / max(norm, 1e-12)) in their dtypes, the
    global norm), the squares summed in fp32 leaf by leaf in tree order."""
    gsq = None
    for _, g in leaves(grads):
        sq = g.to(F32, copy=True).square_().sum()
        gsq = sq if gsq is None else gsq + sq
    norm = torch.sqrt(gsq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: scaled(g, scale), grads), norm


def _zeros(shape, dtype, device) -> torch.Tensor:
    """Zeros of ``shape`` as one broadcast scalar (stride 0). An update
    never writes into the state it is given, so a fresh state costs no
    memory: granite-3-2b's 20.2 GB of zero moments are not allocated
    beside the supervisor's copy of the initial state."""
    return torch.zeros((), dtype=dtype, device=device).expand(shape)


# ------------------------------------------------------------------- adamw

def adamw_init(params: dict) -> dict:
    step = next(iter(leaves(params)))[1]
    return {
        "m": tree_map(lambda p: _zeros(p.shape, F32, p.device), params),
        "v": tree_map(lambda p: _zeros(p.shape, F32, p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=step.device),
    }


def adamw_update(cfg: OptConfig, params: dict, grads: dict,
                 state: dict) -> tuple[dict, dict]:
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(F32)
    b2c = 1.0 - cfg.b2 ** step.to(F32)

    def upd(path, p, g, m, v):
        p_new, m_new, v_new = (torch.empty_like(x) for x in (p, m, v))
        for pn, mn, vn, pi, gi, mi, vi in _slices(p_new, m_new, v_new, p, g,
                                                  m, v):
            g32 = gi.float()
            mn.copy_(cfg.b1 * mi + (1 - cfg.b1) * g32)
            vn.copy_(cfg.b2 * vi + (1 - cfg.b2) * torch.square(g32))
            delta = (mn / b1c) / (torch.sqrt(vn / b2c) + cfg.eps)
            if p.dim() >= 2:  # no decay on norms/biases/scalars
                delta = delta + cfg.weight_decay * pi.float()
            pn.copy_(pi.float() - lr * delta)
        return (path, p_new), (path, m_new), (path, v_new)

    out = _zip(upd, params, grads, state["m"], state["v"])
    new_params, new_m, new_v = (unflatten(dict(o[i] for o in out))
                                for i in range(3))
    return new_params, {"m": new_m, "v": new_v, "step": step}


# --------------------------------------------------------------- adafactor

def _factored(p) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= 8 and p.shape[-2] >= 8


def adafactor_init(params: dict) -> dict:
    def vrow(p):
        if _factored(p):
            return _zeros(p.shape[:-1], F32, p.device)
        return _zeros(p.shape, F32, p.device)

    def vcol(p):
        if _factored(p):
            return _zeros(p.shape[:-2] + p.shape[-1:], F32, p.device)
        return _zeros((1,), F32, p.device)

    step = next(iter(leaves(params)))[1]
    return {
        "m": tree_map(lambda p: _zeros(p.shape, torch.bfloat16, p.device),
                      params),
        "vr": tree_map(vrow, params),
        "vc": tree_map(vcol, params),
        "step": torch.zeros((), dtype=torch.int32, device=step.device),
    }


def adafactor_update(cfg: OptConfig, params: dict, grads: dict,
                     state: dict) -> tuple[dict, dict]:
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    b2 = cfg.b2

    def upd(path, p, g, m, vr, vc):
        g32 = g.float()
        g2 = torch.square(g32) + 1e-30
        if _factored(p):
            vr_new = b2 * vr + (1 - b2) * g2.mean(dim=-1)
            vc_new = b2 * vc + (1 - b2) * g2.mean(dim=-2)
            denom = (vr_new[..., None] * vc_new[..., None, :]
                     / torch.clamp(vr_new.mean(dim=-1)[..., None, None],
                                   min=1e-30))
            rms = torch.sqrt(denom) + cfg.eps
        else:
            vr_new = b2 * vr + (1 - b2) * g2
            vc_new = vc
            rms = torch.sqrt(vr_new) + cfg.eps
        m_new = (cfg.b1 * m.float()
                 + (1 - cfg.b1) * (g32 / rms)).to(torch.bfloat16)
        delta = m_new.float()
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        return tuple((path, x) for x in (
            (p.float() - lr * delta).to(p.dtype), m_new, vr_new, vc_new))

    out = _zip(upd, params, grads, state["m"], state["vr"], state["vc"])
    pick = [unflatten(dict(o[i] for o in out)) for i in range(4)]
    return pick[0], {"m": pick[1], "vr": pick[2], "vc": pick[3],
                     "step": step}


def make_optimizer(cfg: OptConfig) -> tuple[Callable, Callable]:
    if cfg.kind == "adamw":
        return adamw_init, adamw_update
    if cfg.kind == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(f"unknown optimizer {cfg.kind!r}")
