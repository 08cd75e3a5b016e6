"""Dry run of every (arch x shape x mesh) cell, counted from the
placements — the port of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out rows.jsonl
    PYTHONPATH=src python -m repro_torch.launch.roofline rows.jsonl

The reference lowers each cell with XLA on 512 fake CPU devices and reads
the sharded HLO. The port has no HLO, and its own mesh path is not the
production program: it gathers every dense DTensor whole before use
(``models/transformer.local_params``) and its shard-local MoE carries no
gradient. So this dry run counts what the placements imply. A cell's row
is a pure function of the config, the shape, the mesh's axis sizes and
the spec functions of ``launch/sharding.py`` (``param_specs``,
``zero_specs``, ``cache_specs``, ``batch_spec``, ``moe_buffer_spec``),
applied to ``bridge.param_shapes`` leaves and tensors on ``meta``: it
allocates nothing (jamba-1.5-large-398b's 797 GB included), touches no
device, and starts no process group, mesh or DTensor.

A row carries:

  * the reference's keys where they mean the same: ``arch``, ``shape``,
    ``mesh`` ("16x16" / "2x16x16"), ``status``, ``reason`` (of a skipped
    cell), ``model_flops_global``, ``wall_s`` and ``collectives`` as
    ``{kind: {count, bytes}, effective_bytes_per_device}``;
  * ``argument_size_in_bytes``: each rank's params, optimizer moments,
    batch and cache, summed from the specs (not XLA's buffer figure; a
    prefill's cache is its output), and the same term by term in
    ``bytes_per_rank``;
  * ``flops_per_device``: ``analytic_flops_global`` over the ranks, with
    ``flops_source: "analytic"``, and ``analytic_bytes_per_device`` at the
    row's own mesh (the roofline's memory term);
  * ``collectives["by_axis"]``: the same counts split by the mesh axes a
    collective spans ("model", "data", "pod+data", ...);
  * ``hints``: the decisions the reference's ``build_cell`` leaves in its
    model modules (``moe.SHARD_MAP_SPEC``, ``moe.BUFFER_SPEC``,
    ``transformer.LOGITS_SPEC`` and ``ACT_SPEC``) as data of the row. The
    port's models take no such hints: the dry run reads them from the
    placements. ``moe_ep`` and ``seq_parallel`` take the place of the
    reference's ``REPRO_MOE_EP`` and ``REPRO_SEQ_PARALLEL``, with its
    defaults; no environment variable is read.

Collectives are those of the sharded program the placements imply, over
the axes of more than one rank (an axis of one rank moves nothing, and
XLA drops such a collective). Each rule is one function below
(``fsdp_gathers``, ``grad_syncs``, ``row_parallel``, ``embed_lookup``,
``logits``, ``moe_dispatch``, ``kv_cache``). ``bytes`` is the size of a
collective's result on one rank, as the reference reads it from the HLO,
and ``effective_bytes_per_device`` weighs each kind by
``COLLECTIVE_FACTOR``. A pass of the model is one call when serving; a
training step makes three a microbatch (forward, remat recompute,
backward) of every layer, as ``analytic.py`` counts weight reads.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback

import torch

from repro_torch.bridge import leaves, param_shapes, tree_map
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch.analytic import (resolve_config, resolve_shape,
                                         analytic_bytes_per_device,
                                         analytic_flops_global)
from repro_torch.launch.settings import SHAPES, cell_skipped, settings_for
from repro_torch.models.config import ATTN, CROSS, MOE

# effective data moved per device, relative to the (per-device) result shape
COLLECTIVE_FACTOR = {
    "all-gather": 1.0,       # receives (n-1)/n of the gathered result
    "all-reduce": 2.0,       # reduce-scatter + all-gather
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}

EP_MIN_TOKENS = 65536   # the shard-local MoE pays off from here (build_cell)
CE_CHUNK = 512          # the training loss' sequence chunk (launch/steps.py)
ACT_BYTES = 2           # bf16 activations
F32 = 4

# the 2-D products of a layer: x @ W with W (in, out)
PRODUCTS = ("wq", "wk", "wv", "wo", "wi_gate", "wi_up", "in_proj", "x_proj",
            "dt_proj", "out_proj")
RESIDUAL_OUT = ("wo", "out_proj")   # products whose output joins the residual


# ------------------------------------------------------------------ inputs

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch, shape_name) -> dict:
    """Meta-tensor stand-ins for every model input of a cell (the
    reference's ``ShapeDtypeStruct``s): tokens (and labels), or a decode
    token and its cache, and the VLM's image context or the
    encoder-decoder's frames (its encoded context when decoding)."""
    from repro_torch.models.transformer import init_cache

    cfg = resolve_config(arch)
    sh = resolve_shape(shape_name)
    B, S = sh["global_batch"], sh["seq_len"]
    kind = sh["kind"]
    specs = {}
    if kind == "train":
        specs["tokens"] = _meta((B, S), torch.int32)
        specs["labels"] = _meta((B, S), torch.int32)
    elif kind == "prefill":
        specs["tokens"] = _meta((B, S), torch.int32)
    else:  # decode
        specs["token"] = _meta((B, 1), torch.int32)
        specs["cache"] = init_cache(cfg, B, S, device="meta")
    if cfg.is_vlm:
        specs["ctx"] = _meta((B, cfg.image_tokens, cfg.d_model),
                             torch.bfloat16)
    elif cfg.is_encdec:
        if kind == "decode":  # decoder consumes the encoded frames
            specs["ctx"] = _meta((B, cfg.encoder_frames, cfg.d_model),
                                 torch.bfloat16)
        else:
            specs["frames"] = _meta((B, cfg.encoder_frames, cfg.d_model),
                                    torch.bfloat16)
    return specs


def model_flops(arch, shape_name) -> float:
    """Analytic useful FLOPs: 6·N_active·D (train) / 2·N_active·D (fwd)."""
    cfg = resolve_config(arch)
    sh = resolve_shape(shape_name)
    tokens = sh["global_batch"] * (sh["seq_len"]
                                   if sh["kind"] != "decode" else 1)
    n = cfg.active_param_count()
    return (6.0 if sh["kind"] == "train" else 2.0) * n * tokens


# ------------------------------------------------------------------- hints

def _data_axes(sizes: dict) -> tuple[str, ...]:
    return tuple(a for a in sizes if a in ("pod", "data"))


def cell_hints(cfg, sh: dict, sizes: dict, *, moe_ep: bool = True,
               seq_parallel: bool = True) -> dict:
    """The reference's per-cell decisions (``build_cell``), as data:

    * ``moe_path``: "shard_local" when the arch has experts, ``moe_ep``,
      the batch shards over the data axes and the step carries at least
      ``EP_MIN_TOKENS`` tokens; "global" for other MoE cells; None;
    * ``shard_map_spec`` (data axes, "model") on the shard-local path,
      ``buffer_spec`` (``moe_buffer_spec``) on the global one;
    * ``logits_spec``: batch over the data axes (when it shards), vocab
      over "model";
    * ``act_spec``: the residual stream's spec; sequence-parallel
      (batch, S over "model", d) for a training or prefill cell whose
      batch shards and whose S divides, unless every layer's FFN is a MoE
      on the shard-local path; else batch-sharded (or replicated)."""
    dp = _data_axes(sizes)
    dpn = math.prod(sizes[a] for a in dp)
    model = sizes["model"]
    lead = dp if len(dp) > 1 else dp[0]
    B, S, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    batch_ok = B % dpn == 0 and B >= dpn
    tokens_total = B * (S if kind != "decode" else 1)
    local = bool(cfg.n_experts and moe_ep and batch_ok
                 and tokens_total >= EP_MIN_TOKENS)
    all_moe = cfg.n_experts > 0 and all(f == MOE for _, f in cfg.layer_kinds())
    sp = (seq_parallel and batch_ok and kind in ("train", "prefill")
          and S % model == 0 and not (all_moe and local))
    return dict(
        batch_sharded=batch_ok,
        moe_path=None if not cfg.n_experts else
        ("shard_local" if local else "global"),
        shard_map_spec=(dp, "model") if local else None,
        buffer_spec=shd.moe_buffer_spec(dp, dpn, model)
        if cfg.n_experts and not local else None,
        logits_spec=(lead if batch_ok else None, None, "model"),
        act_spec=(lead, "model", None) if sp else
        (lead if batch_ok else None, None, None),
        seq_parallel=sp)


# ------------------------------------------------------------------- bytes

def _ranks(entry, sizes: dict) -> int:
    if entry is None:
        return 1
    axes = entry if isinstance(entry, (tuple, list)) else (entry,)
    return math.prod(sizes[a] for a in axes)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def shard_shape(shape, spec, sizes: dict) -> tuple[int, ...]:
    """One rank's shard of ``shape`` under ``spec``: each sharded dim
    divided by the ranks of its axes (it must divide)."""
    out = []
    for i, dim in enumerate(shape):
        n = _ranks(spec[i] if i < len(spec) else None, sizes)
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over {spec[i]} ({n} ranks)")
        out.append(dim // n)
    return tuple(out)


def _leaf(x) -> tuple[tuple[int, ...], torch.dtype]:
    return (tuple(x[0]), x[1]) if isinstance(x, tuple) else \
        (tuple(x.shape), x.dtype)


def tree_bytes(tree: dict, specs: dict, sizes: dict) -> int:
    """Bytes one rank holds of ``tree`` placed by ``specs``."""
    flat = dict(leaves(specs))
    total = 0
    for path, x in leaves(tree):
        shape, dtype = _leaf(x)
        total += math.prod(shard_shape(shape, flat[path], sizes)) * \
            dtype.itemsize
    return total


# ------------------------------------------------------------- collectives

class Tally:
    """Collectives by (kind, axes): ``add`` drops the axes of one rank
    and skips a collective that spans none."""

    def __init__(self, sizes: dict):
        self.sizes = sizes
        self.items: dict[tuple[str, tuple[str, ...]], list] = {}

    def add(self, kind: str, axes, nbytes: float, count: float = 1) -> None:
        axes = tuple(a for a in self.sizes if a in axes and self.sizes[a] > 1)
        if not axes or not count:
            return
        c = self.items.setdefault((kind, axes), [0, 0.0])
        c[0] += count
        c[1] += nbytes * count

    def row(self) -> dict:
        def block(items):
            out = {k: {"count": 0, "bytes": 0.0} for k in COLLECTIVE_FACTOR}
            eff = 0.0
            for (kind, _), (n, b) in items:
                out[kind]["count"] += n
                out[kind]["bytes"] += b
                eff += b * COLLECTIVE_FACTOR[kind]
            out["effective_bytes_per_device"] = eff
            return out

        out = block(self.items.items())
        names = sorted({ax for _, ax in self.items},
                       key=lambda ax: [list(self.sizes).index(a) for a in ax])
        out["by_axis"] = {"+".join(ax): block(
            [(k, v) for k, v in self.items.items() if k[1] == ax])
            for ax in names}
        return out


class Cell:
    """What the rules read of one cell: sizes, tokens a rank carries in a
    pass, passes, the param leaves with their specs."""

    def __init__(self, cfg, sh: dict, sizes: dict, hints: dict, pspecs: dict,
                 ospecs: dict | None, cache: dict | None,
                 cspecs: dict | None):
        self.cfg, self.sizes, self.hints = cfg, sizes, hints
        self.kind = sh["kind"]
        self.B, self.S = sh["global_batch"], sh["seq_len"]
        self.dp = _data_axes(sizes)
        self.dpn = math.prod(sizes[a] for a in self.dp)
        self.model = sizes["model"]
        self.train = self.kind == "train"
        st = settings_for(cfg.name)
        self.mb = st.microbatches if self.train else 1
        self.passes = 3 * self.mb if self.train else 1
        b_loc = self.B // self.dpn if hints["batch_sharded"] else self.B
        seq = self.S if self.kind != "decode" else 1
        # tokens a rank carries through one pass (a microbatch's share)
        self.rows = b_loc * seq // self.mb
        self.b_rows = b_loc / self.mb          # batch rows in a pass
        ctx_len = cfg.image_tokens or cfg.encoder_frames
        self.ctx_rows = b_loc * ctx_len // self.mb
        self.enc_rows = self.ctx_rows if cfg.is_encdec else 0
        self.sp = hints["seq_parallel"]
        self.pspecs = dict(leaves(pspecs))
        self.ospecs = dict(leaves(ospecs)) if ospecs is not None else {}
        self.cache = cache
        self.cspecs = cspecs
        self.mixer_of = _mixers(cfg)

    def params(self):
        """(path, per-layer shape, dtype, per-layer spec, layers) of each
        param leaf the cell runs: a leaf stacked over periods counts once
        a period, with its leading dim dropped; the encoder does not run
        in a decode step, which takes its context encoded."""
        for path, x in leaves(param_shapes(self.cfg)):
            if self.kind == "decode" and path.startswith("encoder/"):
                continue
            shape, dtype = _leaf(x)
            spec = self.pspecs[path]
            if path.startswith("periods/") and spec[0] is None:
                yield path, shape[1:], dtype, spec[1:], shape[0]
            elif path.startswith("periods/") and \
                    path.rsplit("/", 1)[-1] in PRODUCTS:
                raise ValueError(f"{path}: its period dim is sharded")
            else:
                # judgement: a stack sharded along its periods (FSDP puts
                # the data axes there when that dim is the largest, as on
                # falcon-mamba-7b's A_log) moves whole, once a pass
                yield path, shape, dtype, spec, 1


def _without(spec, axes) -> tuple:
    """``spec`` with ``axes`` taken out of every entry."""
    out = []
    for e in spec:
        keep = tuple(a for a in _axes(e) if a not in axes)
        out.append(None if not keep else keep[0] if len(keep) == 1 else keep)
    return tuple(out)


def _mixers(cfg) -> dict[str, str]:
    """Layer key (``l<j>``, ``r<i>``, ``e<i>``) -> its mixer kind."""
    pat = cfg.layer_pattern
    out = {f"l{j}": pat[j] for j in range(len(pat))}
    base = cfg.n_periods * len(pat)
    out.update({f"r{i}": pat[(base + i) % len(pat)]
                for i in range(cfg.n_remainder)})
    out.update({f"e{i}": ATTN for i in range(cfg.encoder_layers)})
    return out


def _numel(shape) -> int:
    return math.prod(shape)


def fsdp_gathers(t: Tally, c: Cell) -> None:
    """A param leaf sharded over the data axes (FSDP/ZeRO-3) is
    all-gathered over them before each use: once a serving call, and in
    training once a pass (forward, recompute and backward of each
    microbatch), a layer at a time. The result keeps the leaf's 'model'
    sharding."""
    for path, shape, dtype, spec, layers in c.params():
        axes = tuple(a for e in spec for a in _axes(e) if a in c.dp)
        if not axes:
            continue
        whole = shard_shape(shape, _without(spec, c.dp), c.sizes)
        t.add("all-gather", axes, _numel(whole) * dtype.itemsize,
              layers * c.passes)


def grad_syncs(t: Tally, c: Cell) -> None:
    """Training only: each gradient (in its param's dtype) is summed over
    the data axes.

    * A leaf sharded over the data axes: its backward's all-gather
      transposes to a reduce-scatter into the leaf's own spec, each
      microbatch, a layer at a time.
    * Otherwise the microbatches accumulate locally and the step syncs
      once: a reduce-scatter to the spec of its first moment where
      ``zero_specs`` shards that over the data axes, and then an
      all-gather of the updated param back to its own spec (judgement:
      XLA updates the ZeRO shard and gathers it for the next step);
      else one all-reduce.
    * The loss' mean over the batch is an fp32 all-reduce over the data
      axes each microbatch; the global grad norm one over every axis."""
    if not c.train:
        return
    for path, shape, dtype, spec, layers in c.params():
        mine = shard_shape(shape, spec, c.sizes)
        axes = tuple(a for e in spec for a in _axes(e) if a in c.dp)
        if axes:
            t.add("reduce-scatter", axes, _numel(mine) * dtype.itemsize,
                  layers * c.mb)
            continue
        full = (layers,) + tuple(shape) if layers > 1 else tuple(shape)
        mspec = c.ospecs.get(f"m/{path}")
        zaxes = tuple(a for e in (mspec or ()) for a in _axes(e)
                      if a in c.dp)
        nbytes = _numel(mine) * layers * dtype.itemsize
        if zaxes:
            t.add("reduce-scatter", zaxes,
                  _numel(shard_shape(full, mspec, c.sizes)) * dtype.itemsize)
            t.add("all-gather", zaxes, nbytes)
        else:
            t.add("all-reduce", c.dp, nbytes)
    t.add("all-reduce", c.dp, F32, c.mb)
    t.add("all-reduce", tuple(c.sizes), F32)


def _reduce_model(t: Tally, c: Cell, rows: float, width: int, count: float,
                  sp: bool) -> None:
    """One reduction over 'model' of a (rows, width) bf16 activation: an
    all-reduce, or under sequence parallelism a reduce-scatter to the
    S-sharded residual and the all-gather before the next product."""
    nbytes = rows * width * ACT_BYTES
    if sp:
        t.add("reduce-scatter", ("model",), nbytes / c.model, count)
        t.add("all-gather", ("model",), nbytes, count)
    else:
        t.add("all-reduce", ("model",), nbytes, count)


def row_parallel(t: Tally, c: Cell) -> None:
    """Each product x @ W of a layer whose W (data axes aside) shards its
    contracted dim over 'model' — the mixer's and the MLP's ``wo``, the
    Mamba ``out_proj`` and ``x_proj`` — sums partial products: one
    reduction of its (rows, out) activation over 'model' a pass (in
    training the backward's matching reduction sits at the column-parallel
    product's input; Megatron's f/g pair). Under a sequence-parallel
    ``act_spec`` a decoder product that ends in the residual takes a
    reduce-scatter and an all-gather instead. The rows are the pass'
    tokens, the encoder's frames for its layers, and the context's for a
    cross-attention layer's K and V. MoE experts are ``moe_dispatch``'s."""
    for path, shape, dtype, spec, layers in c.params():
        parts = path.split("/")
        name = parts[-1]
        if name not in PRODUCTS or len(shape) != 2:   # experts are 3-D
            continue
        spec = _without(spec, c.dp)
        if "model" not in _axes(spec[0]):
            continue
        encoder = parts[0] == "encoder"     # layers: <stack>/<key>/...
        if encoder:
            rows = c.enc_rows
        elif c.mixer_of[parts[1]] == CROSS and name in ("wk", "wv"):
            rows = c.ctx_rows
        else:
            rows = c.rows
        sp = c.sp and not encoder and name in RESIDUAL_OUT
        _reduce_model(t, c, rows, shape[1], layers * c.passes, sp)


def embed_lookup(t: Tally, c: Cell) -> None:
    """The embedding table sharded over 'model' by vocab rows: each rank
    looks up the tokens its rows hold, zeros elsewhere, and the (rows, d)
    result is summed over 'model' (a reduce-scatter and an all-gather
    under sequence parallelism). Once a serving call, once a microbatch
    in training: the lookup lies outside the remat, and its backward is
    a scatter into each rank's own rows."""
    spec = _without(c.pspecs["embed"], c.dp)
    if "model" in _axes(spec[0]):
        _reduce_model(t, c, c.rows, c.cfg.d_model, c.mb, c.sp)


def logits(t: Tally, c: Cell) -> None:
    """The LM head (``lm_head``, or the tied ``embed`` transposed) with
    its vocab over 'model' gives vocab-sharded logits (``logits_spec``).

    * Serving: the last position's (rows, V) logits leave the step whole
      over 'model' (the prefill's output spec, the decode's argmax): one
      all-gather.
    * Training: the loss runs over sequence chunks of ``CE_CHUNK``; each
      chunk's log-sum-exp and label logit reduce over the vocab: an fp32
      all-reduce each of the max, the sum and the label logit, in the
      forward and in the chunk's recompute; its backward contracts the
      head over its sharded vocab: one reduction of the chunk's (rows, d)
      over 'model'. Under sequence parallelism the head's input is first
      all-gathered, once a microbatch."""
    cfg = c.cfg
    head = "embed" if cfg.tie_embeddings else "lm_head"
    spec = _without(c.pspecs[head], c.dp)
    vdim = 0 if cfg.tie_embeddings else 1
    if "model" not in _axes(spec[vdim]):
        return
    V = cfg.padded_vocab
    if not c.train:
        t.add("all-gather", ("model",), c.b_rows * V * ACT_BYTES)
        return
    chunk = min(CE_CHUNK, c.S)
    n_chunks = -(-c.S // chunk)
    rows = c.b_rows * chunk
    t.add("all-reduce", ("model",), rows * F32, 3 * 2 * n_chunks * c.mb)
    if c.sp:
        t.add("all-gather", ("model",), c.rows * cfg.d_model * ACT_BYTES,
              c.mb)
        t.add("reduce-scatter", ("model",),
              rows * cfg.d_model * ACT_BYTES / c.model, n_chunks * c.mb)
    else:
        t.add("all-reduce", ("model",), rows * cfg.d_model * ACT_BYTES,
              n_chunks * c.mb)


def moe_dispatch(t: Tally, c: Cell) -> None:
    """The MoE FFN of each layer, by ``hints["moe_path"]``.

    * Shard-local: tokens stay on their data shard; each rank runs its
      experts' 'model' slice of f on its own tokens, and the (rows, d)
      result is all-reduced over 'model' (the shard_map's psum), with the
      aux loss' fp32 mean over every axis in training (a serving step
      drops the aux loss, and XLA the mean with it); a sequence-sharded
      residual is all-gathered over 'model' at the shard_map's boundary.
      A pass each.
    * Global (judgement, serving only in the reference's cells): the
      (E, cap, d) dispatch buffer is placed by ``buffer_spec`` (cap over
      the data axes where it divides, d over 'model'). Each rank
      scatters its tokens into it: an all-to-all over the data axes of its
      buffer shard (an all-reduce of the whole buffer where cap does not
      divide and the batch shards; nothing where every rank holds every
      token). The expert product contracts d, which the experts' weights
      hold whole: the buffer is all-gathered over 'model'; ``wo``
      contracts the sharded f: a reduce-scatter back to d over 'model'.
      The combine returns the buffer rows to their tokens (the
      dispatch's all-to-all again) and all-gathers the (rows, d/model)
      result over 'model'; in training the aux loss' mean is an
      all-reduce over the data axes where the batch shards."""
    cfg = c.cfg
    if not cfg.n_experts:
        return
    n_moe = sum(1 for _, f in cfg.layer_kinds() if f == MOE)
    d = cfg.d_model
    if c.hints["moe_path"] == "shard_local":
        count = n_moe * c.passes
        t.add("all-reduce", ("model",), c.rows * d * ACT_BYTES, count)
        if c.train:
            t.add("all-reduce", tuple(c.sizes), F32, count)
        if c.sp:
            t.add("all-gather", ("model",), c.rows * d * ACT_BYTES, count)
        return
    seq = c.S if c.kind != "decode" else 1
    T = c.B * seq // c.mb
    E, k = cfg.n_experts, cfg.top_k
    cap = max(8, int(cfg.capacity_factor * T * k / E))
    cap_ax, d_ax, dp_total, model_total = c.hints["buffer_spec"]
    cap_loc = cap // dp_total if cap % dp_total == 0 else cap
    d_loc = d // model_total if d % model_total == 0 else d
    shard = E * cap_loc * d_loc * ACT_BYTES
    count = n_moe * c.passes
    if cap % dp_total == 0:
        t.add("all-to-all", c.dp, shard, 2 * count)
    elif c.hints["batch_sharded"]:
        t.add("all-reduce", c.dp, shard, count)
    if d % model_total == 0:
        t.add("all-gather", ("model",), E * cap_loc * d * ACT_BYTES, count)
        t.add("reduce-scatter", ("model",), shard, count)
        t.add("all-gather", ("model",), c.rows * d * ACT_BYTES, count)
    if c.train and c.hints["batch_sharded"]:
        t.add("all-reduce", c.dp, F32, count)


def kv_cache(t: Tally, c: Cell) -> None:
    """The attention caches, as ``cache_specs`` places them: KV heads
    whole, the window over 'model' (or over 'data' for a batch that does
    not shard), against K/V projections whose columns shard over 'model'.

    * Prefill: each layer's K and V enter the cache in its spec: an
      all-to-all over 'model' each of the rank's (B, KV, W/model, hd)
      shard where the window shards over 'model', else an all-gather of
      the whole (B, KV, W, hd).
    * Decode (judgement: split-window attention): the new token's K and
      V are all-gathered over 'model' (KV heads whole); where the window
      shards over 'model' every rank needs every query head: an
      all-gather of q, and the partial outputs and their softmax max and
      sum (B, H, hd + 2) fp32 are all-reduced over the window's axes;
      where the window shards over 'data', the same all-reduce over
      'data' of the rank's own heads."""
    if c.kind == "train" or c.cache is None:
        return
    cfg = c.cfg
    hd, H = cfg.resolved_head_dim, cfg.n_heads
    flat = dict(leaves(c.cspecs))
    wk_cols = cfg.n_kv_heads * hd
    for path, x in leaves(c.cache):
        if not path.endswith("/k"):
            continue
        shape, _ = _leaf(x)
        spec, layers = flat[path], 1
        if path.startswith("periods/"):
            shape, spec, layers = shape[1:], spec[1:], shape[0]
        shape_local = shard_shape(shape, spec, c.sizes)
        B = shape_local[0]
        w_axes = _axes(spec[2])
        wk = _without(c.pspecs[path[:-1] + "mixer/wk"], c.dp)
        kv_sharded = "model" in _axes(wk[-1])
        if c.kind == "prefill":
            if not kv_sharded:
                continue
            if "model" in w_axes:
                t.add("all-to-all", ("model",),
                      _numel(shape_local) * ACT_BYTES, 2 * layers)
            else:
                t.add("all-gather", ("model",),
                      _numel(shape_local) * ACT_BYTES, 2 * layers)
            continue
        if kv_sharded:
            t.add("all-gather", ("model",), B * wk_cols * ACT_BYTES,
                  2 * layers)
        if "model" in w_axes:
            t.add("all-gather", ("model",), B * H * hd * ACT_BYTES, layers)
            t.add("all-reduce", w_axes, B * H * (hd + 2) * F32, layers)
        elif w_axes:
            t.add("all-reduce", w_axes,
                  B * H * (hd + 2) * F32 / c.model, layers)


RULES = (fsdp_gathers, grad_syncs, row_parallel, embed_lookup, logits,
         moe_dispatch, kv_cache)


# -------------------------------------------------------------------- cells

def count_cell(arch, shape, sizes: dict, *, moe_ep: bool = True,
               seq_parallel: bool = True) -> dict:
    """Per-rank bytes and collectives of one cell: ``arch`` a name of
    ``ARCH_IDS`` or a ``ModelConfig``, ``shape`` a name of ``SHAPES`` or a
    dict of its keys, ``sizes`` the mesh's {axis: ranks} in mesh order
    ("pod", "data", "model")."""
    from repro_torch.models.transformer import init_cache
    from repro_torch.optim import OptConfig, make_optimizer

    cfg = resolve_config(arch)
    st = settings_for(cfg.name)
    sh = resolve_shape(shape)
    B, S, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    dp = _data_axes(sizes)
    dpn = math.prod(sizes[a] for a in dp)
    hints = cell_hints(cfg, sh, sizes, moe_ep=moe_ep,
                       seq_parallel=seq_parallel)
    fsdp = st.fsdp_train if kind == "train" else st.fsdp_serve
    pshapes = param_shapes(cfg)
    kw = dict(dp_axes=dp, dp_total=dpn, axis_sizes=sizes)
    pspecs = shd.param_specs(pshapes, fsdp=fsdp, **kw)
    terms = dict(params=tree_bytes(pshapes, pspecs, sizes), moments=0,
                 batch=0, cache=0)

    ospecs = cache = cspecs = None
    if kind == "train":
        init, _ = make_optimizer(OptConfig(kind=st.optimizer))
        opt = init(tree_map(lambda sd: _meta(*sd), pshapes))
        ospecs = shd.zero_specs(opt, pspecs, **kw)
        terms["moments"] = tree_bytes(opt, ospecs, sizes)
    inputs = input_specs(cfg, sh)
    if kind == "prefill":
        cache = init_cache(cfg, B, S, device="meta")
    elif kind == "decode":
        cache = inputs.pop("cache")
    if cache is not None:
        cspecs = shd.cache_specs(cache, B, dp, dpn, sizes["model"])
        terms["cache"] = tree_bytes(cache, cspecs, sizes)
    bspecs = {k: shd.batch_spec(B, dp, dpn, extra_dims=v.dim() - 1)
              for k, v in inputs.items()}
    terms["batch"] = tree_bytes(inputs, bspecs, sizes)

    c = Cell(cfg, sh, sizes, hints, pspecs, ospecs, cache, cspecs)
    t = Tally(sizes)
    for rule in RULES:
        rule(t, c)
    ranks = math.prod(sizes.values())
    return dict(
        axis_sizes=dict(sizes), ranks=ranks,
        hints=dict(hints, fsdp=fsdp, microbatches=c.mb, moe_ep=moe_ep),
        argument_size_in_bytes=sum(terms.values()), bytes_per_rank=terms,
        model_flops_global=model_flops(cfg, sh),
        flops_per_device=analytic_flops_global(cfg, sh) / ranks,
        flops_source="analytic",
        analytic_bytes_per_device=analytic_bytes_per_device(
            cfg, sh, model_ax=sizes["model"], dp_ax=dpn),
        collectives=t.row(), collectives_source="placements")


def run_cell(arch: str, shape_name: str, multi_pod: bool, **options
             ) -> dict:
    """One row of the sweep at the (16, 16) mesh, or (2, 16, 16) with
    ``multi_pod``; ``options`` are ``count_cell``'s keywords."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    row = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    skip = cell_skipped(arch, shape_name)
    if skip:
        row["status"] = "skipped"
        row["reason"] = skip
        return row
    t0 = time.time()
    try:
        row.update(count_cell(arch, shape_name, MESHES[mesh_name],
                              **options))
        row["status"] = "ok"
    except Exception as e:  # record the failure, keep sweeping
        row["status"] = "error"
        row["error"] = f"{type(e).__name__}: {e}"[:2000]
        row["traceback"] = traceback.format_exc()[-4000:]
    row["wall_s"] = round(time.time() - t0, 3)
    return row


def run_roofline_cell(arch: str, shape_name: str, multi_pod: bool,
                      **options) -> dict:
    """``run_cell`` for the roofline tier. The reference lowers the cell
    at 1 and 2 layer periods and extrapolates, because XLA's cost
    analysis counts a loop body once; counted from the placements, every
    layer is counted already, so the row is ``run_cell``'s, tagged."""
    row = run_cell(arch, shape_name, multi_pod, **options)
    row["tier"] = "roofline"
    if row["status"] == "ok":
        row["periods"] = get_config(arch).n_periods
    return row


def sweep(archs=ARCH_IDS, shapes=tuple(SHAPES), meshes=(False, True),
          tier: str = "fit"):
    """The rows of every (arch x shape x mesh), in ``main``'s order."""
    run = run_roofline_cell if tier == "roofline" else run_cell
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                yield run(arch, shape, mp)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run, counted "
                                 "from the placements")
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x shape)")
    ap.add_argument("--tier", default="fit", choices=["fit", "roofline"])
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]
    for row in sweep(archs, shapes, meshes, args.tier):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
