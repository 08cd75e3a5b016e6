"""Mamba-1 selective SSM block (falcon-mamba) — port of
``repro/models/mamba.py:46-168``.

Prefill runs the whole sequence through ``ops.mamba_scan`` (the CUDA
kernel for CUDA tensors, the sequential plain version otherwise), which
also returns the final state, so the reference's chunk padding, its
``valid`` mask and its associative scan have no counterpart here; the two
differ only in fp32 rounding. Decode is one recurrence step with a conv
ring buffer in plain PyTorch around the matmul kernel, as the reference
computes it outside any Pallas kernel. Every projection goes through
``ops.matmul``. The bf16 rounding points are the reference's."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time in x's dtype, in the reference's
    order: x * w[K-1], then each tap shifted by i, then + b.
    x: (B,S,di), w: (K,di)."""
    K, S = w.shape[0], x.shape[1]
    y = x * w[K - 1]
    for i in range(1, K):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        y = y + shifted * w[K - 1 - i]
    return y + b


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) without a threshold, as ``jax.nn.softplus``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssm_inputs(p: dict, cfg: ModelConfig, xc: torch.Tensor, impl: str):
    """Project the conv output to the selective parameters (dt, B, C), all
    fp32 and contiguous: B and C are slices of x_proj's bf16 output, dt is
    softplus of the bf16 dt_proj product plus dt_bias in fp32."""
    ns, dtr = cfg.ssm_state, cfg.resolved_dt_rank
    proj = ops.matmul(xc, p["x_proj"], impl=impl)               # (B,S,dtr+2N)
    dt_r = proj[..., :dtr]
    B_ssm = proj[..., dtr: dtr + ns].float().contiguous()       # (B,S,N)
    C_ssm = proj[..., dtr + ns:].float().contiguous()           # (B,S,N)
    dt = _softplus(ops.matmul(dt_r, p["dt_proj"], impl=impl).float()
                   + p["dt_bias"])                              # (B,S,di)
    return dt, B_ssm, C_ssm


def _gate(p: dict, y: torch.Tensor, xc: torch.Tensor, z: torch.Tensor,
          impl: str) -> torch.Tensor:
    """y + xc * D, gated by silu(z), then out_proj; bf16 throughout."""
    y = y + xc * p["D"].to(xc.dtype)
    return ops.matmul(y * F.silu(z), p["out_proj"], impl=impl)


def mamba_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  return_state: bool = False, impl: str = "auto"):
    """Full-sequence (prefill) pass. x: (B,S,d) -> (B,S,d). With
    ``return_state`` also returns the decode cache: the final SSM state
    ``h`` (B,di,N) fp32 and the last K-1 pre-conv inputs ``conv``
    (B,K-1,di) bf16, front-padded with zeros when S < K-1."""
    B, S, _ = x.shape
    di = cfg.d_inner
    xz = ops.matmul(x, p["in_proj"], impl=impl)
    x_in, z = xz[..., :di], xz[..., di:]                        # (B,S,di)
    xc = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"])).contiguous()
    dt, B_ssm, C_ssm = _ssm_inputs(p, cfg, xc, impl)
    A = -torch.exp(p["A_log"])                                  # (di,N)
    y, h_last = ops.mamba_scan(dt, A, B_ssm, C_ssm, xc, impl=impl)
    out = _gate(p, y, xc, z, impl)
    if not return_state:
        return out
    K = cfg.ssm_conv
    take = min(K - 1, S)
    conv = torch.zeros((B, K - 1, di), dtype=torch.bfloat16, device=x.device)
    conv[:, K - 1 - take:] = x_in[:, S - take:]
    return out, {"h": h_last, "conv": conv}


def mamba_init_cache(cfg: ModelConfig, B: int, device=None) -> dict:
    di, ns, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"h": torch.zeros((B, di, ns), dtype=torch.float32, device=device),
            "conv": torch.zeros((B, K - 1, di), dtype=torch.bfloat16,
                                device=device)}


def mamba_decode_step(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      cache: dict, impl: str = "auto"
                      ) -> tuple[torch.Tensor, dict]:
    """Single-token step. x: (B,1,d) -> ((B,1,d), the new {"h","conv"}).
    The window's taps are multiplied in bf16 and summed in fp32, as
    ``jnp.sum`` does; the oldest slot meets ``conv_w[0]``."""
    di = cfg.d_inner
    xz = ops.matmul(x[:, 0], p["in_proj"], impl=impl)
    x_in, z = xz[..., :di], xz[..., di:]                        # (B,di)
    win = torch.cat([cache["conv"], x_in[:, None].to(torch.bfloat16)], dim=1)
    taps = win * p["conv_w"][None]
    xc = F.silu(taps.sum(dim=1, dtype=torch.float32).to(taps.dtype)
                + p["conv_b"])
    dt, B_ssm, C_ssm = _ssm_inputs(p, cfg, xc[:, None], impl)
    dt, B_ssm, C_ssm = dt[:, 0], B_ssm[:, 0], C_ssm[:, 0]
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[..., None] * A)                            # (B,di,N)
    b = (dt * xc.float())[..., None] * B_ssm[:, None, :]
    h = a * cache["h"] + b
    y = torch.einsum("bdn,bn->bd", h, C_ssm).to(x.dtype)
    out = _gate(p, y, xc, z, impl)[:, None]
    return out, {"h": h, "conv": win[:, 1:]}
