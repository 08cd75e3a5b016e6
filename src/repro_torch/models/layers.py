"""Shared neural layers: norms, gated MLP, rotary embeddings, embedding.

Port of ``repro/models/layers.py:16-96`` with the reference's rounding:
fp32 norm math, tanh GELU, fp32 rotary angles, and the embed scale rounded
to the activation dtype before the multiply. The MLP's projections go
through ``ops.matmul`` (the CUDA kernel for CUDA tensors)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":  # jax.nn.gelu's default is the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {kind!r}")


def mlp_apply(p: dict, x: torch.Tensor, act: str = "silu",
              impl: str = "auto") -> torch.Tensor:
    if "wi_gate" in p:
        h = activation(ops.matmul(x, p["wi_gate"], impl=impl), act) \
            * ops.matmul(x, p["wi_up"], impl=impl)
    else:
        h = activation(ops.matmul(x, p["wi_up"], impl=impl), act)
    return ops.matmul(h, p["wo"], impl=impl)


def rope_frequencies(head_dim: int, theta: float, rotary_dim: int,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension."""
    half = rotary_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               partial: float = 1.0) -> torch.Tensor:
    """Rotary position embedding.

    x: (..., S, H, D); positions: broadcastable to (..., S) absolute indices.
    `partial` < 1 rotates only the leading fraction of D (ChatGLM-style
    2D/partial rotary).
    """
    d = x.shape[-1]
    rot = int(d * partial)
    rot -= rot % 2
    if rot == 0:
        return x
    inv = rope_frequencies(d, theta, rot, x.device)
    ang = positions[..., None].float() * inv                 # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, r/2)
    sin = torch.sin(ang)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype), xp], dim=-1)


def embed_apply(table: torch.Tensor, ids: torch.Tensor, scale: bool,
                d_model: int) -> torch.Tensor:
    x = table[ids]
    if scale:
        # the reference rounds sqrt(d_model) to the table's dtype first
        # (33.94 -> 34.0 in bf16 at d_model 1152), then multiplies
        x = x * torch.tensor(d_model ** 0.5, dtype=x.dtype).item()
    return x
