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
from repro_torch.models.config import ATTN, ATTN_LOCAL, MLP, ModelConfig

Shape = tuple[int, ...]


def _layer_shapes(cfg: ModelConfig, mixer: str, ffn: str) -> dict:
    if mixer not in (ATTN, ATTN_LOCAL) or ffn != MLP:
        raise NotImplementedError(
            f"layer kind ({mixer}, {ffn}) is not ported yet: only dense "
            f"attention + MLP layers (ROADMAP.md Queue 1 items 6-8)")
    d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    ffn_p = {"wi_up": (d, f), "wo": (f, d)}
    if cfg.mlp_gated:
        ffn_p["wi_gate"] = (d, f)
    return {"norm1": (d,), "norm2": (d,),
            "mixer": {"wq": (d, nq), "wk": (d, nkv), "wv": (d, nkv),
                      "wo": (nq, d)},
            "ffn": ffn_p}


def _stacked(tree: dict, n: int) -> dict:
    return {k: _stacked(v, n) if isinstance(v, dict) else (n,) + v
            for k, v in tree.items()}


def param_shapes(cfg: ModelConfig) -> dict:
    """The params tree of ``cfg`` with a shape at each leaf (all bf16)."""
    if cfg.is_encdec or cfg.is_vlm:
        raise NotImplementedError("encoder-decoder and VLM params are not "
                                  "ported yet (ROADMAP.md Queue 1 item 8)")
    tree: dict = {"embed": (cfg.padded_vocab, cfg.d_model),
                  "final_norm": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (cfg.d_model, cfg.padded_vocab)
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
    """The port's own random params: every weight is normal x 0.02 drawn in
    fp32 from a ``torch.Generator`` seeded with ``seed`` on ``device``, then
    cast to bf16; norms are zeros. Paths, shapes and dtypes are those of
    ``repro.models.init_params``; the numbers are not."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(path: str, shape: Shape) -> torch.Tensor:
        if "norm" in path.rsplit("/", 1)[-1]:
            return torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return (w * 0.02).to(torch.bfloat16)

    shapes = param_shapes(cfg)
    flat = {p: draw(p, s) for p, s in leaves(shapes)}
    return _unflatten(flat)


def _unflatten(flat: dict[str, torch.Tensor]) -> dict:
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


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The JAX package's params (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as torch tensors on ``device``.
    Checks every path and shape against ``cfg``."""
    dev = resolve_device(device)
    want = dict(leaves(param_shapes(cfg)))
    got = dict(leaves(tree))
    if set(want) != set(got):
        raise ValueError(f"params tree does not match {cfg.name}: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}")
    for path, shape in want.items():
        if tuple(got[path].shape) != shape:
            raise ValueError(f"{path}: shape {tuple(got[path].shape)}, "
                             f"{cfg.name} needs {shape}")
    return tree_map(lambda a: _to_torch(a, dev), tree)


def params_to_numpy(params: dict, bf16_dtype=np.uint16) -> dict:
    """Back to nested dicts of numpy arrays, bit for bit. bf16 leaves are
    returned as ``bf16_dtype`` views of their bits: their uint16 patterns
    by default, or pass a numpy bfloat16 type such as
    ``ml_dtypes.bfloat16`` to get arrays the JAX package takes."""
    def one(x: torch.Tensor) -> np.ndarray:
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(bf16_dtype)
        return x.numpy()
    return tree_map(one, params)
