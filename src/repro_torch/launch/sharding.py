"""Sharding rules: parameter specs, ZeRO optimizer-state specs, input and
cache specs for every (arch x shape) cell — port of
``repro.launch.sharding``, and their placement as DTensors.

Mesh axes: ("pod",) "data", "model". ``pod`` composes with ``data`` for
data parallelism / ZeRO / FSDP; ``model`` carries tensor parallelism
(attention heads, d_ff, vocab, mamba d_inner, per-expert d_ff).

A spec is a tuple with one entry per dim: None, an axis name, or a tuple
of axis names — the reference's ``tuple(PartitionSpec)``. The spec
functions read only shapes, so they take ``bridge.param_shapes(cfg)``'s
(shape, dtype) leaves or tensors on ``meta`` as well as real ones: the
specs of a 797 GB config allocate nothing. Trees are the port's nested
dicts, with the reference's ``/``-joined paths.

``placements`` turns a spec into a DTensor placement for each mesh dim
(the reference's ``named``); ``distribute`` places a tree as DTensors and
``gather`` is its inverse.
"""

from __future__ import annotations

import math
from typing import Any

Spec = tuple
PyTree = Any


# ------------------------------------------------------------- param rules

def _param_spec(path: str, ndim: int) -> Spec:
    """Base tensor-parallel spec by parameter name (path is '/'-joined)."""
    leaf = path.rsplit("/", 1)[-1]
    if leaf in ("wq", "wk", "wv"):
        return (None, "model")           # (d, heads*hd)
    if leaf == "wo" and "mixer" in path:
        return ("model", None)           # (heads*hd, d)
    if leaf in ("wi_gate", "wi_up"):
        if ndim == 3:                    # MoE (E, d, f)
            return (None, None, "model")
        return (None, "model")           # (d, f)
    if leaf == "wo":                     # ffn down-proj
        if ndim == 3:                    # MoE (E, f, d)
            return (None, "model", None)
        return ("model", None)           # (f, d)
    if leaf == "router":
        return (None, None)
    if leaf == "embed":
        return ("model", None)           # (V, d) vocab-sharded
    if leaf == "lm_head":
        return (None, "model")           # (d, V)
    if leaf == "in_proj":
        return (None, "model")           # (d, 2*di)
    if leaf == "out_proj":
        return ("model", None)           # (di, d)
    if leaf == "conv_w":
        return (None, "model")           # (K, di)
    if leaf in ("conv_b", "dt_bias", "D"):
        return ("model",)                # (di,)
    if leaf == "x_proj":
        return ("model", None)           # (di, dtr+2N)
    if leaf == "dt_proj":
        return (None, "model")           # (dtr, di)
    if leaf == "A_log":
        return ("model", None)           # (di, N)
    return ()                            # norms, gates, scalars


def _shape(leaf) -> tuple[int, ...]:
    """A leaf's shape: a tensor's, or the first half of
    ``bridge.param_shapes``' (shape, dtype)."""
    return tuple(leaf[0]) if isinstance(leaf, tuple) else tuple(leaf.shape)


def _map_with_path(fn, tree: dict, prefix: str = "") -> dict:
    return {k: _map_with_path(fn, v, f"{prefix}{k}/") if isinstance(v, dict)
            else fn(f"{prefix}{k}", v) for k, v in tree.items()}


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _axes_size(entry, sizes: dict[str, int]) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= sizes[a]
        return n
    return sizes[entry]


def _lead(dp_axes: tuple[str, ...]):
    return dp_axes if len(dp_axes) > 1 else dp_axes[0]


def legalize(spec: list, shape: tuple[int, ...], sizes: dict[str, int]
             ) -> list:
    """Sharded dims must divide exactly: relocate each sharded axis whose
    dim is not divisible to the largest dim that is, else replicate it
    (e.g. vocab=49155 moves the 'model' shard from the vocab dim to
    d_model)."""
    spec = list(spec)
    for i in range(len(spec)):
        if spec[i] is None:
            continue
        n = _axes_size(spec[i], sizes)
        if shape[i] % n == 0:
            continue
        ax = spec[i]
        spec[i] = None
        cands = [(shape[j], j) for j in range(len(spec))
                 if spec[j] is None and shape[j] % n == 0 and shape[j] >= n]
        if cands:
            _, j = max(cands)
            spec[j] = ax
    return spec


def param_specs(params: PyTree, *, fsdp: bool, dp_axes: tuple[str, ...],
                dp_total: int, axis_sizes: dict[str, int]) -> PyTree:
    """Spec tree for a parameter tree. With fsdp=True the largest
    unsharded dim of each weight additionally shards over the data axes
    (ZeRO-3 / FSDP)."""

    def spec_for(path, leaf):
        shape = _shape(leaf)
        scanned = "periods" in path
        base = _param_spec(path, len(shape) - (1 if scanned else 0))
        spec = ([None] if scanned else []) + list(base)
        while len(spec) < len(shape):
            spec.append(None)
        spec = legalize(spec, shape, axis_sizes)
        if fsdp and len(shape) >= 2:
            cands = [(shape[i], i) for i in range(len(shape))
                     if spec[i] is None and shape[i] >= dp_total
                     and shape[i] % dp_total == 0]
            if cands:
                _, i = max(cands)
                spec[i] = _lead(dp_axes)
        return tuple(spec)

    return _map_with_path(spec_for, params)


def zero_specs(opt_state: PyTree, pspecs: PyTree, *,
               dp_axes: tuple[str, ...], dp_total: int,
               axis_sizes: dict[str, int]) -> PyTree:
    """ZeRO: optimizer moments take the param spec plus data-axis sharding
    on the largest remaining unsharded dim."""
    flat_p = _flat(pspecs)   # param path -> spec (moments mirror the params)

    def spec_for(path, leaf):
        shape = _shape(leaf)
        if len(shape) == 0 or path.endswith("step"):
            return ()
        # match the param this moment mirrors: strip the leading m/v/vr/vc
        head, sub = (path.split("/", 1) + [path])[:2]
        base = flat_p.get(sub)
        if base is None or head in ("vr", "vc"):
            # factored moments have reduced rank — re-derive from scratch
            spec = [None] * len(shape)
        else:
            spec = list(base)[: len(shape)]
            while len(spec) < len(shape):
                spec.append(None)
        spec = legalize(spec, shape, axis_sizes)
        sharded = set()          # a membership test only
        for s in spec:
            sharded.update(s if isinstance(s, (tuple, list)) else [s])
        if any(ax in sharded for ax in dp_axes):
            return tuple(spec)
        cands = [(shape[i], i) for i in range(len(shape))
                 if spec[i] is None and shape[i] >= dp_total
                 and shape[i] % dp_total == 0]
        if cands:
            _, i = max(cands)
            spec[i] = _lead(dp_axes)
        return tuple(spec)

    return _map_with_path(spec_for, opt_state)


# ---------------------------------------------------------- input specs

def batch_spec(B: int, dp_axes: tuple[str, ...], dp_total: int,
               extra_dims: int = 1) -> Spec:
    """Shard the batch dim over data axes when divisible, else replicate."""
    if B >= dp_total and B % dp_total == 0:
        return (_lead(dp_axes),) + (None,) * extra_dims
    return (None,) * (extra_dims + 1)


def cache_specs(cache_shapes: PyTree, B: int, dp_axes: tuple[str, ...],
                dp_total: int, model_total: int = 1) -> PyTree:
    """Specs for decode caches. Batch shards over the data axes and the KV
    time dimension over 'model' when divisible (a 550 GB VLM cache at
    batch=128 x 32k x 40 layers needs both); for B=1 long-context the KV
    time dimension shards over 'data' instead."""
    shard_batch = B >= dp_total and B % dp_total == 0
    lead = _lead(dp_axes)

    def w_axis(W: int):
        return "model" if (model_total > 1 and W % model_total == 0
                           and W >= model_total) else None

    def spec_for(path, leaf):
        shape = _shape(leaf)
        name = path.rsplit("/", 1)[-1]
        pre = (None,) if "periods" in path else ()
        if name in ("k", "v"):            # (B, KV, W, hd)
            w_ax = w_axis(shape[2 + len(pre)])
            if shard_batch:
                return pre + (lead, None, w_ax, None)
            return pre + (None, None, "data", None)
        if name == "pos":                  # (B, W)
            w_ax = w_axis(shape[1 + len(pre)])
            if shard_batch:
                return pre + (lead, w_ax)
            return pre + (None, "data")
        if name == "h":                    # (B, di, N)
            return pre + (lead if shard_batch else None, "model", None)
        if name == "conv":                 # (B, K-1, di)
            return pre + (lead if shard_batch else None, None, "model")
        if name == "t":                    # (B,)
            return (lead if shard_batch else None,)
        return (None,) * len(shape)

    return _map_with_path(spec_for, cache_shapes)


# --------------------------------------------------------- activation hints

def moe_buffer_spec(dp_axes: tuple[str, ...], dp_total: int,
                    model_total: int) -> tuple:
    """Hint tuple for the MoE dispatch buffer: (capacity-dim axes, d-dim
    axis, divisors to verify against the static buffer shape)."""
    return (_lead(dp_axes), "model", dp_total, model_total)


# -------------------------------------------------------------- placement

def placements(mesh, spec: Spec) -> list:
    """The DTensor placement on each dim of ``mesh`` for ``spec``: Shard(d)
    on every mesh dim that the spec names at tensor dim d, Replicate on
    the others. An entry of several axes (("pod", "data")) shards its dim
    over each of them, the first the outermost, so it must list them in
    the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, (tuple, list)) else \
            (() if entry is None else (entry,))
        dims = [names.index(a) if a in names else -1 for a in axes]
        if -1 in dims or dims != sorted(dims):
            raise ValueError(f"spec {spec} does not fit a mesh over {names}")
        for a in axes:
            where[a] = d
    return [Shard(where[a]) if a in where else Replicate() for a in names]


def named(mesh, specs: PyTree) -> PyTree:
    """The placements of every spec of a tree (``placements``)."""
    return _map_with_path(lambda _, s: placements(mesh, s), specs)


def _shard_of(x, mesh, pl: list):
    """This rank's shard of the whole tensor ``x`` under placements ``pl``:
    each sharded mesh dim, in the mesh's order, takes its chunk."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if p.is_shard():
            x = x.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return x.contiguous()


def distribute(tree: PyTree, mesh, specs: PyTree) -> PyTree:
    """Each leaf of ``tree`` as a DTensor placed by its spec. Every rank
    holds the whole tree (the same seed's params, the same prompts) and
    keeps its own shard of each leaf: nothing is sent, and a leaf that no
    rank shards keeps its storage."""
    from torch.distributed.tensor import DTensor

    flat = _flat(specs)

    def one(path, x):
        pl = placements(mesh, flat[path])
        stride = tuple(math.prod(x.shape[d + 1:]) for d in range(x.ndim))
        return DTensor.from_local(_shard_of(x, mesh, pl), mesh, pl,
                                  run_check=False, shape=x.shape,
                                  stride=stride)
    return _map_with_path(one, tree)


def gather(tree: PyTree) -> PyTree:
    """The inverse of ``distribute``: every DTensor leaf whole
    (``full_tensor``), other leaves as they are."""
    from torch.distributed.tensor import DTensor

    return _map_with_path(
        lambda _, x: x.full_tensor() if isinstance(x, DTensor) else x, tree)
