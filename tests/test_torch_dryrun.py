"""The port's dry run (``repro_torch.launch.dryrun``), counted from the
placements, against the reference's ``repro.launch.dryrun`` and its
sharding rules.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` for its whole process when it is
imported, so it is imported only in one subprocess (``reference``, once a
module, with a time limit), which prints the reference's ``model_flops``,
``input_specs`` and the hints its ``build_cell`` leaves in the model
modules, for every cell at both production meshes. Each rank's bytes are
held against the reference's own specs (``repro.launch.sharding`` on
``jax.eval_shape`` trees) placed on an ``AbstractMesh``: no device, no
compile. The dry run itself runs in this process; it starts no process
group. No test here draws at random."""

import ast
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro_torch.bridge import leaves  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.settings import SHAPES, settings_for  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_TIMEOUT_S = 180
MESHES = dryrun.MESHES
N_CELLS = len(ARCH_IDS) * len(SHAPES) * len(MESHES)

# Runs in a subprocess: the reference's surface for every cell, as JSON.
REF_CODE = r'''
import json
import jax
import repro.launch.dryrun as dr
from repro.configs import ARCH_IDS
from repro.launch.mesh import make_production_mesh
from repro.launch.settings import SHAPES
from repro.models import moe, transformer

def norm(x):
    return json.loads(json.dumps(x))

meshes = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}
out = {"collective_factor": dr.COLLECTIVE_FACTOR, "cells": {}}
for arch in ARCH_IDS:
    for shape in SHAPES:
        ins = {}
        for k, v in dr.input_specs(arch, shape).items():
            if k == "cache":
                for kp, leaf in jax.tree_util.tree_leaves_with_path(v):
                    path = "/".join(str(p.key) for p in kp)
                    ins["cache/" + path] = [list(leaf.shape), str(leaf.dtype)]
            else:
                ins[k] = [list(v.shape), str(v.dtype)]
        hints = {}
        for name, mesh in meshes.items():
            dr.build_cell(arch, shape, mesh)
            smap = moe.SHARD_MAP_SPEC
            hints[name] = norm({
                "shard_map_spec": None if smap is None else smap[1:],
                "buffer_spec": moe.BUFFER_SPEC,
                "logits_spec": tuple(transformer.LOGITS_SPEC),
                "act_spec": tuple(transformer.ACT_SPEC)})
        out["cells"][arch + " " + shape] = {
            "model_flops": dr.model_flops(arch, shape), "inputs": ins,
            "hints": hints}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    done = subprocess.run([sys.executable, "-c", REF_CODE], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=REF_TIMEOUT_S)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def _norm(x):
    return json.loads(json.dumps(x))


def _dtype(t: torch.dtype) -> str:
    return str(t).replace("torch.", "")


# ---------------------------------------------------- (a) the public surface

def test_collective_factor_equals_the_reference(reference):
    assert dryrun.COLLECTIVE_FACTOR == reference["collective_factor"]
    assert len(reference["cells"]) == N_CELLS // len(MESHES)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_input_specs_equal_the_reference(arch, reference):
    """``model_flops`` ``==``, and every input's shape and dtype (the
    decode cache leaf by leaf), on every shape of the arch."""
    for shape in SHAPES:
        want = reference["cells"][f"{arch} {shape}"]
        assert dryrun.model_flops(arch, shape) == want["model_flops"]
        got = {}
        for k, v in dryrun.input_specs(arch, shape).items():
            if k == "cache":
                got.update({f"cache/{p}": [list(x.shape), _dtype(x.dtype)]
                            for p, x in leaves(v)})
            else:
                assert v.device.type == "meta"
                got[k] = [list(v.shape), _dtype(v.dtype)]
        assert got == want["inputs"], shape


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_hints_equal_what_build_cell_leaves(arch, reference):
    """``moe.SHARD_MAP_SPEC`` (its axes), ``moe.BUFFER_SPEC``,
    ``transformer.LOGITS_SPEC`` and ``ACT_SPEC`` after the reference's
    ``build_cell`` ``==`` the port's ``cell_hints`` on every shape at
    both meshes, skipped cells included."""
    cfg = get_config(arch)
    for shape in SHAPES:
        for mesh, sizes in MESHES.items():
            h = dryrun.cell_hints(cfg, SHAPES[shape], sizes)
            got = _norm({k: h[k] for k in ("shard_map_spec", "buffer_spec",
                                           "logits_spec", "act_spec")})
            assert got == reference["cells"][f"{arch} {shape}"]["hints"][
                mesh], (shape, mesh)
            assert (h["moe_path"] == "shard_local") == \
                (h["shard_map_spec"] is not None)


def test_the_switches_are_keywords_with_the_reference_defaults():
    """``moe_ep=False`` keeps the global MoE path everywhere (the
    reference's REPRO_MOE_EP=0); ``seq_parallel=False`` keeps the residual
    batch-sharded (REPRO_SEQ_PARALLEL=0)."""
    sizes = MESHES["16x16"]
    moe = get_config("mixtral-8x7b")
    on = dryrun.cell_hints(moe, SHAPES["train_4k"], sizes)
    off = dryrun.cell_hints(moe, SHAPES["train_4k"], sizes, moe_ep=False)
    assert on["moe_path"] == "shard_local" and off["moe_path"] == "global"
    assert not on["seq_parallel"] and off["seq_parallel"]   # all-MoE arch
    dense = get_config("granite-3-2b")
    assert dryrun.cell_hints(dense, SHAPES["prefill_32k"], sizes)[
        "act_spec"] == ("data", "model", None)
    assert dryrun.cell_hints(dense, SHAPES["prefill_32k"], sizes,
                             seq_parallel=False)["act_spec"] == \
        ("data", None, None)
    row = dryrun.run_cell("mixtral-8x7b", "train_4k", False, moe_ep=False)
    assert row["status"] == "ok" and row["hints"]["moe_path"] == "global"


# --------------------------------------------------- (b) bytes of each rank

def _ref_bytes(shapes: dict, specs: dict, mesh: AbstractMesh) -> int:
    """Sum over leaves of ``NamedSharding(mesh, P(*spec)).shard_shape``
    times the itemsize; ``shapes`` and ``specs`` flat by path."""
    return sum(math.prod(NamedSharding(mesh, P(*specs[p])).shard_shape(
        tuple(s))) * jax.numpy.dtype(dt).itemsize
        for p, (s, dt) in shapes.items())


def _jflat(tree, is_leaf=None) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in kp): v
            for kp, v in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=is_leaf)}


def _abstract_shapes(tree) -> dict:
    return {p: (x.shape, x.dtype) for p, x in _jflat(tree).items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bytes_per_rank_equal_the_reference_specs(arch, mesh, reference):
    """Params, optimizer moments (the arch's optimizer: adafactor for
    jamba), cache and batch of one rank, on every shape, ``==`` the
    reference's specs placed on ``AbstractMesh`` (skipped cells too)."""
    sizes = MESHES[mesh]
    amesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    dp = tuple(a for a in sizes if a != "model")
    dpn = math.prod(sizes[a] for a in dp)
    kw = dict(dp_axes=dp, dp_total=dpn, axis_sizes=sizes)
    st = settings_for(arch)
    jp = jax.eval_shape(lambda: jinit_params(jget_config(arch),
                                             jax.random.PRNGKey(0)))
    is_p = lambda x: isinstance(x, P)   # noqa: E731
    for shape, sh in SHAPES.items():
        B, S, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
        fsdp = st.fsdp_train if kind == "train" else st.fsdp_serve
        pspecs = jshd.param_specs(jp, fsdp=fsdp, **kw)
        want = dict(params=_ref_bytes(_abstract_shapes(jp),
                                      _jflat(pspecs, is_p), amesh),
                    moments=0, batch=0, cache=0)
        if kind == "train":
            jinit, _ = jmake_optimizer(JOptConfig(kind=st.optimizer))
            opt = jax.eval_shape(jinit, jp)
            want["moments"] = _ref_bytes(
                _abstract_shapes(opt),
                _jflat(jshd.zero_specs(opt, pspecs, **kw), is_p), amesh)
        else:
            cache = jax.eval_shape(lambda: jinit_cache(jget_config(arch),
                                                       B, S))
            want["cache"] = _ref_bytes(
                _abstract_shapes(cache),
                _jflat(jshd.cache_specs(cache, B, dp, dpn, sizes["model"]),
                       is_p), amesh)
        ins = {k: v for k, v in reference["cells"][f"{arch} {shape}"][
            "inputs"].items() if not k.startswith("cache/")}
        want["batch"] = _ref_bytes(
            ins, {k: jshd.batch_spec(B, dp, dpn, len(s) - 1)
                  for k, (s, _) in ins.items()}, amesh)
        got = dryrun.count_cell(arch, shape, sizes)
        assert got["bytes_per_rank"] == want, shape
        assert got["argument_size_in_bytes"] == sum(want.values())


# ------------------------------------------- (c) collectives, worked by hand

def _axis_counts(row) -> dict:
    return {ax: {k: v["count"] for k, v in block.items()
                 if isinstance(v, dict) and v["count"]}
            for ax, block in row["collectives"]["by_axis"].items()}


def test_tp_only_dense_decode_worked_by_hand():
    """granite-3-2b decode_32k at 16x16: no FSDP when serving, no sequence
    parallelism when decoding. B = 128 over 16 data ranks: 8 rows a rank.
    d 2048, 32 heads and 8 KV heads of 64, padded vocab 49 408 (tied), 40
    attention + MLP layers, caches (128, 8, 32768, 64) placed (data, -,
    model, -): 2048 window slots a rank.

    * row-parallel: attention ``wo`` and MLP ``wo`` a layer: 80
      all-reduces of (8, 2048) bf16 = 32 768 B;
    * embed (vocab over model): 1 all-reduce of 32 768 B;
    * logits: 1 all-gather of (8, 49 408) bf16 = 790 528 B;
    * the cache: the new token's K and V (8, 512) bf16 = 8 192 B
      all-gathered a layer (80), q (8, 2048) bf16 = 32 768 B
      all-gathered a layer (40) and the partial outputs (8, 32, 66) fp32
      = 67 584 B all-reduced a layer (40).

    All over 'model': 121 all-reduces of 81 x 32 768 + 40 x 67 584 =
    5 357 568 B, 121 all-gathers of 790 528 + 80 x 8 192 + 40 x 32 768 =
    2 756 608 B; effective 2 x 5 357 568 + 2 756 608 = 13 471 744 B."""
    row = dryrun.run_cell("granite-3-2b", "decode_32k", False)
    assert _axis_counts(row) == {"model": {"all-reduce": 121,
                                           "all-gather": 121}}
    c = row["collectives"]
    assert c["all-reduce"]["bytes"] == 5_357_568
    assert c["all-gather"]["bytes"] == 2_756_608
    assert c["effective_bytes_per_device"] == 13_471_744


def test_fsdp_train_with_microbatches_worked_by_hand():
    """chatglm3-6b train_4k at 16x16: FSDP, 4 microbatches, sequence
    parallel (B 256 shards over 16, S 4096 divides by 16), untied head.
    28 layers in periods; each carries 9 leaves (norm1, norm2, wq, wk,
    wv, wo, wi_gate, wi_up, wo) and FSDP shards every one over 'data'
    (the stacked norms (28, 4096) on their 4096), as it does ``embed``
    and ``lm_head``; ``final_norm`` (1-D) stays whole and its moments
    take ZeRO's data sharding.

    * 'data': 28 x 9 + 2 = 254 leaves gathered each pass, 3 passes x 4
      microbatches: 3 048 all-gathers, plus final_norm's gather after
      the update: 3 049; their gradients reduce-scattered each
      microbatch: 1 016, plus final_norm's one: 1 017; the loss'
      all-reduce each microbatch: 4.
    * 'model': 2 row-parallel products a layer, a reduce-scatter and an
      all-gather each, 12 passes: 672 + 672; the embed a microbatch: 4 +
      4; the head: 8 chunks of 512, 3 statistics x 2 passes: 192
      all-reduces, the backward's 32 reduce-scatters and one all-gather
      of its input a microbatch: 4. So 708 reduce-scatters, 680
      all-gathers, 192 all-reduces.
    * 'data+model': the grad norm's all-reduce: 1."""
    row = dryrun.run_cell("chatglm3-6b", "train_4k", False)
    assert _axis_counts(row) == {
        "data": {"all-gather": 3049, "reduce-scatter": 1017,
                 "all-reduce": 4},
        "model": {"all-gather": 680, "reduce-scatter": 708,
                  "all-reduce": 192},
        "data+model": {"all-reduce": 1}}


def test_shard_local_moe_prefill_worked_by_hand():
    """granite-moe-1b-a400m prefill_32k at 16x16: 2 prompts a rank of
    32 768 tokens (65 536 rows), one million tokens in all, so the MoE
    runs shard-local, and every layer's FFN is a MoE: no sequence
    parallelism. d 1024, 24 layers, 8 KV heads of 64, tied vocab 49 408.

    * attention ``wo`` a layer and the embed: 25 all-reduces over
      'model' of (65 536, 1024) bf16 = 134 217 728 B;
    * the MoE a layer: its psum, 24 more such all-reduces (a serving
      step drops the aux loss, so its mean moves nothing);
    * the cache: K and V a layer leave the projection with their columns
      over 'model' and enter (2, 8, 2048, 64) shards with the window
      over 'model': 48 all-to-alls of 4 194 304 B;
    * the last position's logits (2, 49 408) bf16: 1 all-gather of
      197 632 B."""
    row = dryrun.run_cell("granite-moe-1b-a400m", "prefill_32k", False)
    assert row["hints"]["moe_path"] == "shard_local"
    assert not row["hints"]["seq_parallel"]
    assert _axis_counts(row) == {
        "model": {"all-reduce": 49, "all-to-all": 48, "all-gather": 1}}
    by = row["collectives"]["by_axis"]
    assert by["model"]["all-reduce"]["bytes"] == 49 * 134_217_728
    assert by["model"]["all-to-all"]["bytes"] == 48 * 4_194_304
    assert by["model"]["all-gather"]["bytes"] == 197_632


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_rank_moves_nothing_and_pod_joins_only_data(arch, shape):
    """On a 1 x 1 mesh no collective is counted. At 2x16x16 every
    collective over the data axes spans ("pod", "data") and the 'model'
    ones stay: no axis set names "pod" without "data". The one set of
    'data' alone is a long-context decode's (B = 1): ``cache_specs``
    places its window over 'data' alone at both meshes."""
    one = dryrun.count_cell(arch, shape, {"data": 1, "model": 1})
    c = one["collectives"]
    assert c["by_axis"] == {} and c["effective_bytes_per_device"] == 0
    assert all(v["count"] == 0 for k, v in c.items()
               if k in dryrun.COLLECTIVE_FACTOR)
    single = dryrun.count_cell(arch, shape, MESHES["16x16"])
    multi = dryrun.count_cell(arch, shape, MESHES["2x16x16"])
    assert set(single["collectives"]["by_axis"]) <= {
        "model", "data", "data+model"}
    window = {"data"} if SHAPES[shape]["global_batch"] == 1 else set()
    assert set(multi["collectives"]["by_axis"]) <= {
        "model", "pod+data", "pod+data+model"} | window
    assert ("model" in single["collectives"]["by_axis"]) == \
        ("model" in multi["collectives"]["by_axis"])


def test_pod_doubles_the_data_axes_where_the_placements_agree():
    """chatglm3-6b train_4k places every leaf the same way at both
    meshes; at 2x16x16 its collectives over 'data' become the same
    counts over ("pod", "data")."""
    a = _axis_counts(dryrun.run_cell("chatglm3-6b", "train_4k", False))
    b = _axis_counts(dryrun.run_cell("chatglm3-6b", "train_4k", True))
    rename = {"data": "pod+data", "data+model": "pod+data+model",
              "model": "model"}
    assert {rename[k]: v for k, v in a.items()} == b


# --------------------------------------------- (d) (e) the sweep and main

def test_full_sweep_starts_no_process_group_and_touches_no_device():
    """``chip_smoke.sweep_check``, the card's run of the whole sweep, here:
    80 rows, none in error; afterwards no process group and no CUDA
    context exist in this process."""
    import importlib.util

    import torch.distributed as dist

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_dryrun", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    got = smoke.sweep_check()
    assert (got["rows"], got["ok"], got["skipped"]) == (N_CELLS, 68, 12)
    assert not dist.is_initialized()
    assert not torch.cuda.is_initialized()


def test_main_all_writes_80_rows_that_roofline_reads(tmp_path, capsys):
    out = tmp_path / "rows.jsonl"
    dryrun.main(["--all", "--out", str(out)])
    rows = roofline.load_rows(str(out))
    status = [r["status"] for r in rows]
    assert len(rows) == N_CELLS == 80
    assert status.count("ok") == 68 and status.count("skipped") == 12
    assert len(capsys.readouterr().out.strip().splitlines()) == 80
    for mesh, chips in (("16x16", 256), ("2x16x16", 512)):
        entries = roofline.analyze(str(out), mesh)
        assert len(entries) == 40
        for e in entries:
            if e["status"] == "ok":
                assert e["t_compute_s"] > 0 and e["t_memory_s"] > 0
                assert e["dominant"] in ("compute", "memory", "collective")
            else:
                assert e["reason"]
    roofline.main([str(out)])
    assert len(capsys.readouterr().out.strip().splitlines()) == 40


def test_the_loss_chunk_is_the_training_steps():
    """``logits`` counts the chunked loss' collectives a ``CE_CHUNK`` of
    sequence at a time: the port's training step's chunk, and the
    reference's."""
    from repro.launch import steps as jsteps
    from repro_torch.launch import steps

    assert dryrun.CE_CHUNK == steps.CE_CHUNK == jsteps.CE_CHUNK


def test_roofline_tier_rows_carry_the_fit_tier_counts():
    fit = dryrun.run_cell("jamba-1.5-large-398b", "decode_32k", True)
    roof = dryrun.run_roofline_cell("jamba-1.5-large-398b", "decode_32k",
                                    True)
    assert roof["tier"] == "roofline" and roof["periods"] == 9
    assert roof["collectives"] == fit["collectives"]
    skip = dryrun.run_cell("granite-3-2b", "long_500k", False)
    assert skip["status"] == "skipped" and "500k" in skip["reason"]


# ------------------------------------------------------- (f) imports

def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_port_imports_jax_or_repro():
    pkg = os.path.join(ROOT, "src", "repro_torch")
    seen = 0
    for base, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                bad = _imports(os.path.join(base, f)) & {"jax", "jaxlib",
                                                         "repro"}
                assert not bad, (f, bad)
                seen += 1
    assert seen > 50
    code = ("import sys; import repro_torch.launch.dryrun, "
            "repro_torch.launch.roofline, repro_torch.launch.analytic; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    done = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip() == "[]"
