"""Top-k Mixture-of-Experts with capacity-bounded scatter dispatch — port
of ``_moe_core`` (``repro/models/moe.py:52-101``) and, given a mesh, of
its shard-local ``shard_map`` path (``moe.py:104-135``).

``route`` picks each token's experts and gates; ``dispatch_combine``
scatters every (token, choice) into its expert's capacity buffer, runs
the experts and gathers back. Both keep the reference's rounding: the
router product bf16 in and out, then fp32 softmax, top-k with the lower
index first on ties (``jax.lax.top_k``'s order), gates renormalised in
fp32 and cast to the activation dtype, and the gate-weighted sum in the
activation dtype. Tokens past an expert's capacity go to a sink row and
come back as zeros.

Every product goes through ``ops.matmul`` (the CUDA kernel for CUDA
tensors): the router, then for each expert ``wi_gate``, ``wi_up`` and
``wo`` over its (capacity, d) slice of the buffer — 3·E + 1 launches a
layer. Every expert is computed, empty or not, as the reference's
einsums compute all of them."""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import activation


def capacity(cfg: ModelConfig, T: int) -> int:
    """Rows of each expert's buffer for ``T`` tokens (``moe.py:56``)."""
    return max(8, int(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts))


def route(p: dict, cfg: ModelConfig, x: torch.Tensor, impl: str = "auto"
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (..., d) -> (gate (T, k) in x's dtype, expert indices (T, k),
    router probabilities (T, E) fp32) over the T = prod(leading dims)
    tokens. A stable descending sort keeps equal probabilities in index
    order, as ``jax.lax.top_k`` does (``torch.topk`` promises no order)."""
    xt = x.reshape(-1, x.shape[-1])
    logits = ops.matmul(xt, p["router"], impl=impl).float()
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top[:, :cfg.top_k], order[:, :cfg.top_k]
    gate = (gate / gate.sum(dim=-1, keepdim=True)).to(x.dtype)
    return gate, idx, probs


def _expert(p: dict, j: int, xb: torch.Tensor, act: str,
            impl: str) -> torch.Tensor:
    h = activation(ops.matmul(xb, p["wi_gate"][j], impl=impl), act) \
        * ops.matmul(xb, p["wi_up"][j], impl=impl)
    return ops.matmul(h, p["wo"][j], impl=impl)


def dispatch_combine(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     gate: torch.Tensor, idx: torch.Tensor,
                     impl: str = "auto") -> torch.Tensor:
    """x: (B, S, d) with ``route``'s gate and idx -> y (B, S, d)."""
    B, S, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    T = B * S
    cap = capacity(cfg, T)
    flat = idx.reshape(T * k)
    # position of each (token, choice) within its expert's buffer, in
    # token-major order (the choices of earlier tokens come first): a
    # cumsum along the rows of the (E, T·k) one-hot, its contiguous dim
    # (a scan down the columns of a (T·k, E) one-hot runs each column
    # serially on the card: 6 ms a granite-moe prefill layer on an H100)
    onehot = (torch.arange(e, device=x.device)[:, None] == flat).int()
    pos = (onehot.cumsum(dim=1, dtype=torch.int32) - onehot).gather(
        0, flat[None])[0]
    slot = torch.where(pos < cap, flat * cap + pos.clamp(max=cap - 1),
                       e * cap)                              # overflow sink
    # only the sink row can be written twice, and nothing reads it back
    buf = x.new_zeros((e * cap + 1, d))
    buf.index_copy_(0, slot, x.reshape(T, d).repeat_interleave(k, dim=0))
    out = torch.cat([_expert(p, j, buf[j * cap:(j + 1) * cap], cfg.act, impl)
                     for j in range(e)] + [x.new_zeros((1, d))])
    yk = out[slot].reshape(T, k, d)
    return (yk * gate[..., None]).sum(dim=1).reshape(B, S, d)


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
              impl: str = "auto", mesh=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, Switch load-balancing aux loss, fp32 scalar).
    Given a ``mesh``, the shard-local path (``_moe_apply_mesh``)."""
    if mesh is not None:
        return _moe_apply_mesh(p, cfg, x, impl, mesh)
    return _moe_core(p, cfg, x, impl)


def _moe_core(p: dict, cfg: ModelConfig, x: torch.Tensor, impl: str
              ) -> tuple[torch.Tensor, torch.Tensor]:
    gate, idx, probs = route(p, cfg, x, impl)
    y = dispatch_combine(p, cfg, x, gate, idx, impl)
    e = cfg.n_experts
    me = probs.mean(dim=0)
    ce = (idx[:, 0, None] == torch.arange(e, device=x.device)).float().mean(0)
    return y, e * (me * ce).sum()


# each rank's slice of the experts: the reference's shard_map in_specs
# (moe.py:124-132), d_ff over "model"
EXPERT_SPECS = {"router": (None, None), "wi_gate": (None, None, "model"),
                "wi_up": (None, None, "model"), "wo": (None, "model", None)}


def expert_slices(p: dict, mesh) -> dict:
    """A MoE FFN's params as this rank's slices: each DTensor leaf
    redistributed to its ``EXPERT_SPECS`` entry (after any leading period
    axis) and made local; a plain tensor is taken as this rank's slice
    already."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import placements

    out = {}
    for k, spec in EXPERT_SPECS.items():
        t = p[k]
        if isinstance(t, DTensor):
            spec = (None,) * (t.ndim - len(spec)) + spec
            t = t.redistribute(mesh, placements(mesh, spec)).to_local()
        out[k] = t
    return out


def _moe_apply_mesh(p: dict, cfg: ModelConfig, x: torch.Tensor, impl: str,
                    mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel-style shard-local dispatch on ``mesh`` (port of
    ``_moe_apply_shardmap``, ``moe.py:104-135``). Each rank routes its
    data shard of x over its slice of every expert's d_ff at the capacity
    of its own token count; the only communication is one sum of its
    (T_loc, d) output over the "model" group and the aux loss's mean over
    every rank of the mesh.

    DTensors are redistributed to this rank's share; plain tensors are
    this rank's share already: for ``x`` its own rows (y comes back the
    same way, or as a DTensor sharded over the data axes for a DTensor
    ``x``), for ``p`` its expert slices (``expert_slices``). Only local
    tensors reach the kernels. The collectives carry no gradient: this
    path serves."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import data_axes
    from repro_torch.launch.sharding import placements

    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("the shard-local MoE carries no gradient")
    dp = data_axes(mesh)
    rows = placements(mesh, (dp if len(dp) > 1 else dp[0], None, None))
    xl = x.redistribute(mesh, rows).to_local() if isinstance(x, DTensor) \
        else x
    y, aux = _moe_core(expert_slices(p, mesh), cfg, xl, impl)
    dist.all_reduce(y, group=mesh.get_group("model"))
    for name in mesh.mesh_dim_names:
        dist.all_reduce(aux, group=mesh.get_group(name))
    aux = aux / mesh.size()
    if isinstance(x, DTensor):
        y = DTensor.from_local(y, mesh, rows, run_check=False)
    return y, aux
