"""Parameters of the port: their tree, the port's own seeded init, and the
crossing from and to the JAX package's params as numpy arrays.

The tree is the reference's (``repro/models/transformer.py:94-134``):
nested dicts whose leaves sit at ``/``-joined paths in sorted key order,
with the layers of whole periods stacked under ``periods/l<j>/...`` along a
leading ``n_periods`` axis and the rest under ``remainder/r<i>/...``. So
``leaf_sizes`` lists what ``repro.svm.tree_leaf_sizes`` lists.

bf16 numpy arrays (``ml_dtypes.bfloat16``, what JAX hands out) cross as
their 16-bit patterns; this module never imports ``ml_dtypes``.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import (ATTN, ATTN_LOCAL, CROSS, MAMBA, MLP,
                                      MOE, NONE, ModelConfig)

Shape = tuple[int, ...]
BF16, FP32 = torch.bfloat16, torch.float32


def _mamba_shapes(cfg: ModelConfig) -> dict:
    """``mamba_init``'s leaves (``repro/models/mamba.py:27-43``)."""
    d, di, ns = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr = cfg.resolved_dt_rank
    return {"in_proj": ((d, 2 * di), BF16),
            "conv_w": ((cfg.ssm_conv, di), BF16), "conv_b": ((di,), BF16),
            "x_proj": ((di, dtr + 2 * ns), BF16), "dt_proj": ((dtr, di), BF16),
            "dt_bias": ((di,), FP32), "A_log": ((di, ns), FP32),
            "D": ((di,), FP32), "out_proj": ((di, d), BF16)}


def _attn_shapes(cfg: ModelConfig) -> dict:
    """``attn_init``'s leaves (``repro/models/attention.py:19-28``)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    return {"wq": ((d, nq), BF16), "wk": ((d, nkv), BF16),
            "wv": ((d, nkv), BF16), "wo": ((nq, d), BF16)}


def _ffn_shapes(cfg: ModelConfig, ffn: str) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if ffn == MOE:   # moe_init (repro/models/moe.py:31-39)
        e = cfg.n_experts
        return {"router": ((d, e), BF16), "wi_gate": ((e, d, f), BF16),
                "wi_up": ((e, d, f), BF16), "wo": ((e, f, d), BF16)}
    if ffn != MLP:
        raise ValueError(f"unknown ffn {ffn!r}")
    ffn_p = {"wi_up": ((d, f), BF16), "wo": ((f, d), BF16)}
    if cfg.mlp_gated:
        ffn_p["wi_gate"] = ((d, f), BF16)
    return ffn_p


def _layer_shapes(cfg: ModelConfig, mixer: str, ffn: str) -> dict:
    """``_init_layer``'s leaves (``repro/models/transformer.py:61-82``):
    ``norm1`` and the mixer; a cross-attention layer's scalar ``gate``;
    ``norm2`` and the FFN (an MLP or a MoE, after any mixer) unless the
    FFN is ``none``."""
    d = cfg.d_model
    if mixer == MAMBA:
        tree = {"norm1": ((d,), BF16), "mixer": _mamba_shapes(cfg)}
    elif mixer in (ATTN, ATTN_LOCAL, CROSS):
        tree = {"norm1": ((d,), BF16), "mixer": _attn_shapes(cfg)}
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    if mixer == CROSS:
        tree["gate"] = ((), BF16)
    if ffn != NONE:
        tree["norm2"] = ((d,), BF16)
        tree["ffn"] = _ffn_shapes(cfg, ffn)
    return tree


def _stacked(tree: dict, n: int) -> dict:
    return {k: _stacked(v, n) if isinstance(v, dict) else ((n,) + v[0], v[1])
            for k, v in tree.items()}


def param_shapes(cfg: ModelConfig) -> dict:
    """The params tree of ``cfg`` with (shape, dtype) at each leaf: bf16,
    except the fp32 ``A_log``, ``D`` and ``dt_bias`` of Mamba layers.
    Encoder-decoder archs add ``encoder/e<i>`` (attention + MLP layers)
    and ``encoder/final_norm``."""
    v, d = cfg.padded_vocab, cfg.d_model
    tree: dict = {"embed": ((v, d), BF16), "final_norm": ((d,), BF16)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ((d, v), BF16)
    pat, fpat = cfg.layer_pattern, cfg.ffn_pattern
    if cfg.n_periods > 0:
        period = {f"l{j}": _layer_shapes(cfg, pat[j], fpat[j % len(fpat)])
                  for j in range(len(pat))}
        tree["periods"] = _stacked(period, cfg.n_periods)
    base = cfg.n_periods * len(pat)
    if cfg.n_remainder > 0:
        tree["remainder"] = {
            f"r{i}": _layer_shapes(cfg, pat[(base + i) % len(pat)],
                                   fpat[(base + i) % len(fpat)])
            for i in range(cfg.n_remainder)}
    if cfg.is_encdec:
        tree["encoder"] = {f"e{i}": _layer_shapes(cfg, ATTN, MLP)
                           for i in range(cfg.encoder_layers)}
        tree["encoder"]["final_norm"] = ((d,), BF16)
    return tree


def leaves(tree: dict, prefix: str = "") -> Iterator[tuple[str, object]]:
    """(path, leaf) in JAX's flattening order: dict keys sorted, depth
    first, paths joined with '/'."""
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], dict):
            yield from leaves(tree[key], path)
        else:
            yield path, tree[key]


def tree_map(fn, tree: dict) -> dict:
    """``fn`` applied to every leaf of a nested dict, keeping its keys."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def leaf_sizes(params: dict) -> list[tuple[str, int]]:
    """(path, nbytes) of every leaf in tree order — what
    ``repro.svm.tree_leaf_sizes`` gives for the same tree."""
    return [(p, x.numel() * x.element_size()) for p, x in leaves(params)]


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """The port's own random params, by the reference's init rules
    (``dense_init``, ``mamba_init``): weights are normal x 0.02 drawn in
    fp32 from a ``torch.Generator`` seeded with ``seed`` on ``device`` and
    cast to bf16 (normal x 0.1 for ``conv_w``, x dt_rank^-0.5 for
    ``dt_proj``); norms, ``conv_b`` and the cross-attention ``gate`` are
    zeros; ``A_log`` = log(1..N) over every channel, ``D`` = 1 and
    ``dt_bias`` = -4.6 in fp32. Paths,
    shapes, dtypes and those fixed leaves are the reference's; the random
    numbers are not. A leaf stacked over periods is drawn one period
    slice at a time, each fp32 draw scaled in place and rounded into the
    bf16 leaf, so a leaf costs its bf16 tensor and one slice's fp32 draw
    at most (granite-20b's (52, 6144, 24576) ``ffn/wo`` is 31.4 GB whole
    in fp32, 0.6 GB a slice)."""
    return unflatten(dict(_init_leaves(cfg, seed, device)))


def _init_leaves(cfg: ModelConfig, seed: int = 0, device=None
                 ) -> Iterator[tuple[str, torch.Tensor]]:
    """``init_params``' leaves as (path, tensor), drawn one at a time in
    tree order from the one generator: a caller that moves each leaf off
    ``device`` before it takes the next holds one leaf there at a time,
    and gets the bits of ``init_params``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    scales = {"conv_w": 0.1, "dt_proj": cfg.resolved_dt_rank ** -0.5}

    def draw(path: str, spec: tuple[Shape, torch.dtype]) -> torch.Tensor:
        shape, dtype = spec
        name = path.rsplit("/", 1)[-1]
        if "norm" in name or name in ("conv_b", "gate"):
            return torch.zeros(shape, dtype=dtype, device=dev)
        if name == "A_log":
            n = torch.arange(1, shape[-1] + 1, dtype=FP32, device=dev)
            return torch.log(n).expand(shape).contiguous()
        if name == "D":
            return torch.ones(shape, dtype=dtype, device=dev)
        if name == "dt_bias":   # softplus^-1(0.01)
            return torch.full(shape, -4.6, dtype=dtype, device=dev)
        w = torch.empty(shape, dtype=dtype, device=dev)
        for part in (w if path.startswith("periods/") else (w,)):
            part.copy_(torch.randn(part.shape, generator=gen, dtype=FP32,
                                   device=dev).mul_(scales.get(name, 0.02)))
        return w

    for path, spec in leaves(param_shapes(cfg)):
        yield path, draw(path, spec)


def unflatten(flat: dict[str, object]) -> dict:
    """The nested dict of ``{path: leaf}`` (paths joined with '/')."""
    tree: dict = {}
    for path, x in flat.items():
        node = tree
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = x
    return tree


def _to_torch(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: JAX's arrays are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tree_from_numpy(tree: dict, device=None) -> dict:
    """Any nested dict of numpy arrays (an optimizer state ``{"m", "v",
    "step"}``, a grads tree) as torch tensors on ``device``, bit for bit:
    bf16 arrays cross as their 16-bit patterns, the rest unchanged."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_torch(a, dev), tree)


def tree_to_numpy(tree: dict, bf16_dtype=np.uint16) -> dict:
    """Back to nested dicts of numpy arrays, bit for bit. bf16 leaves are
    returned as ``bf16_dtype`` views of their bits: their uint16 patterns
    by default, or pass a numpy bfloat16 type such as
    ``ml_dtypes.bfloat16`` to get arrays the JAX package takes."""
    def one(x: torch.Tensor) -> np.ndarray:
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(bf16_dtype)
        return x.numpy()
    return tree_map(one, tree)


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The JAX package's params (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as torch tensors on ``device``.
    Checks every path, shape and dtype against ``cfg``; fp32 leaves cross
    unchanged."""
    dev = resolve_device(device)
    want = dict(leaves(param_shapes(cfg)))
    got = dict(leaves(tree))
    if set(want) != set(got):
        raise ValueError(f"params tree does not match {cfg.name}: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}")
    for path, (shape, dtype) in want.items():
        a = got[path]
        name = str(dtype).replace("torch.", "")
        if tuple(a.shape) != shape or a.dtype.name != name:
            raise ValueError(f"{path}: {a.dtype.name} {tuple(a.shape)}, "
                             f"{cfg.name} needs {name} {shape}")
    return tree_from_numpy(tree, dev)


params_to_numpy = tree_to_numpy   # the name the params' callers use
