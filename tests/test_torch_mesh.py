"""The port's multi-device layer against the JAX package: meshes
(``repro_torch.launch.mesh``), the sharding rules
(``repro_torch.launch.sharding``) with ``==`` on every arch's full config
at both production mesh sizes, the int8 gradient compression
(``repro_torch.optim.compression``) with ``==``, the shard-local MoE
(``moe_apply(..., mesh=)``) and the launchers' ``--production-mesh``.

What needs several ranks runs in four subprocesses on the CPU, joined by
gloo through a ``FileStore`` under the test's ``tmp_path`` (no port),
each with a time limit, on a (2, 2) mesh over ("data", "model"); a
1-rank host mesh runs in this process and is closed in ``finally``."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch import sharding as tshd  # noqa: E402
from repro_torch.launch.settings import settings_for  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import OptConfig, make_optimizer  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ({"data": 16, "model": 16}, ("data",)),
          "2x16x16": ({"pod": 2, "data": 16, "model": 16}, ("pod", "data"))}
MOE_ARCHS = ("granite-moe-1b-a400m", "mixtral-8x7b")
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)   # test_arch_smoke's bf16 tolerance
RANKS = 4
RANK_TIMEOUT_S = 240


def _jflat(tree) -> dict:
    """{'/'-joined path: tuple(spec)} of a reference spec tree."""
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in kp): tuple(s)
            for kp, s in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))}


def _tflat(tree) -> dict:
    return dict(bridge.leaves(tree))


def _meta(tree: dict) -> dict:
    """``bridge.param_shapes``' tree as meta tensors."""
    return bridge.tree_map(
        lambda sd: torch.empty(sd[0], dtype=sd[1], device="meta"), tree)


def _dp(sizes, dp_axes):
    n = 1
    for a in dp_axes:
        n *= sizes[a]
    return n


# ------------------------------------------------------------- param specs

@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference_on_full_configs(arch, mesh, fsdp):
    """``param_specs`` of the full config from ``bridge.param_shapes``
    (no weight allocated) ``==`` the reference's from ``jax.eval_shape``,
    leaf by leaf."""
    sizes, dp = MESHES[mesh]
    kw = dict(fsdp=fsdp, dp_axes=dp, dp_total=_dp(sizes, dp),
              axis_sizes=sizes)
    jp = jax.eval_shape(lambda: jinit_params(jget_config(arch),
                                             jax.random.PRNGKey(0)))
    want = _jflat(jshd.param_specs(jp, **kw))
    got = _tflat(tshd.param_specs(bridge.param_shapes(get_config(arch)),
                                  **kw))
    assert got == want
    assert any(s for s in got.values())   # tensor parallelism engages


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["gemma3-1b", "mixtral-8x7b",
                                  "falcon-mamba-7b", "jamba-1.5-large-398b"])
def test_zero_specs_equal_the_reference(arch, mesh, kind):
    """``zero_specs`` over each optimizer's state, made on ``meta`` by the
    port's own init, ``==`` the reference's over ``jax.eval_shape``."""
    sizes, dp = MESHES[mesh]
    kw = dict(dp_axes=dp, dp_total=_dp(sizes, dp), axis_sizes=sizes)
    jp = jax.eval_shape(lambda: jinit_params(jget_config(arch),
                                             jax.random.PRNGKey(0)))
    jinit, _ = jmake_optimizer(JOptConfig(kind=kind))
    want = _jflat(jshd.zero_specs(
        jax.eval_shape(jinit, jp),
        jshd.param_specs(jp, fsdp=False, **kw), **kw))
    tp = _meta(bridge.param_shapes(get_config(arch)))
    tinit, _ = make_optimizer(OptConfig(kind=kind))
    got = _tflat(tshd.zero_specs(
        tinit(tp), tshd.param_specs(tp, fsdp=False, **kw), **kw))
    assert got == want
    assert any("data" in str(s) for s in got.values())   # ZeRO engages


@pytest.mark.parametrize("B,S", [(128, 32768), (1, 4096)],
                         ids=["batch", "long"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, mesh, B, S):
    """``cache_specs`` of ``init_cache(..., device="meta")`` ``==`` the
    reference's over ``jax.eval_shape(init_cache)``: batch over the data
    axes and the window over 'model', or at B = 1 the window over
    'data'."""
    sizes, dp = MESHES[mesh]
    args = (B, dp, _dp(sizes, dp), sizes["model"])
    jc = jax.eval_shape(lambda: jinit_cache(jget_config(arch), B, S))
    want = _jflat(jshd.cache_specs(jc, *args))
    tc = transformer.init_cache(get_config(arch), B, S, device="meta")
    assert _tflat(tshd.cache_specs(tc, *args)) == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("B", [1, 8, 16, 32, 48, 128])
def test_batch_and_moe_buffer_specs_equal_the_reference(B, mesh):
    sizes, dp = MESHES[mesh]
    n = _dp(sizes, dp)
    for extra in (0, 1, 2):
        assert tshd.batch_spec(B, dp, n, extra) == \
            tuple(jshd.batch_spec(B, dp, n, extra))
    assert tshd.moe_buffer_spec(dp, n, sizes["model"]) == \
        jshd.moe_buffer_spec(dp, n, sizes["model"])


@settings(max_examples=60, deadline=None)
@given(dims=st.lists(st.integers(min_value=1, max_value=70000), min_size=1,
                     max_size=4),
       axis=st.sampled_from(["model", "data", ("data", "model"),
                             ("pod", "data")]),
       pos=st.integers(min_value=0, max_value=3))
def test_property_legalize_equals_the_reference(dims, axis, pos):
    """``legalize`` returns the reference's list, and every sharded dim
    divides."""
    sizes = MESHES["2x16x16"][0]
    spec = [None] * len(dims)
    spec[min(pos, len(dims) - 1)] = axis
    got = tshd.legalize(spec, tuple(dims), sizes)
    assert got == jshd.legalize(spec, tuple(dims), sizes)
    for dim, s in zip(dims, got):
        assert s is None or dim % tshd._axes_size(s, sizes) == 0


# -------------------------------------------------------------- placements

class _FakeMesh:
    def __init__(self, names):
        self.mesh_dim_names = names


def test_placements_follow_the_mesh_dims():
    """A spec entry naming several axes shards its dim over each of them
    (in the mesh's order); an axis the spec does not name replicates; a
    spec that names an axis the mesh lacks, or lists axes out of the
    mesh's order, raises."""
    from torch.distributed.tensor import Replicate, Shard
    m = _FakeMesh(("pod", "data", "model"))
    assert tshd.placements(m, (("pod", "data"), None, "model")) == \
        [Shard(0), Shard(0), Shard(2)]
    assert tshd.placements(m, (None,)) == [Replicate()] * 3
    assert tshd.placements(m, ()) == [Replicate()] * 3
    assert tshd.named(m, {"a": ("model",), "b": {"c": ()}}) == \
        {"a": [Replicate(), Replicate(), Shard(0)],
         "b": {"c": [Replicate()] * 3}}
    with pytest.raises(ValueError):
        tshd.placements(m, (("data", "pod"),))
    with pytest.raises(ValueError):
        tshd.placements(_FakeMesh(("data", "model")), ("pod",))


# ------------------------------------------------------------- compression

def _grads(n, seed, scale=1.0):
    g = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    g *= np.float32(scale)
    g[: min(n, 300)] *= np.float32(1e-3)   # blocks of very different scale
    return g


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4097])
@pytest.mark.parametrize("scale", [1e-6, 1.0, 3e4])
def test_compress_and_decompress_equal_the_reference(n, scale):
    g = _grads(n, n, scale)
    qj, sj = jcomp.compress(jnp.asarray(g))
    qt, stt = tcomp.compress(torch.from_numpy(g))
    assert qt.dtype == torch.int8 and stt.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(stt.numpy(), np.asarray(sj))
    back_j = jcomp.decompress(qj, sj, g.shape, jnp.float32)
    back_t = tcomp.decompress(qt, stt, g.shape, torch.float32)
    np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_j))


def test_compress_a_zero_block_and_bf16_equal_the_reference():
    """An all-zero block takes the 1e-20 floor; bf16 input is quantised
    from its fp32 value and decompressed back to bf16."""
    g = _grads(700, 3)
    g[256:512] = 0.0
    gj = jnp.asarray(g, jnp.bfloat16)
    gt = bridge._to_torch(np.asarray(gj), torch.device("cpu"))
    qj, sj = jcomp.compress(gj)
    qt, stt = tcomp.compress(gt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(stt.numpy(), np.asarray(sj))
    assert float(stt[1]) == np.float32(1e-20)
    back = tcomp.decompress(qt, stt, (700,), torch.bfloat16)
    want = np.asarray(jcomp.decompress(qj, sj, (700,), jnp.bfloat16))
    np.testing.assert_array_equal(back.view(torch.int16).numpy(),
                                  want.view(np.int16))


def test_error_feedback_equals_the_reference_over_steps():
    """``quantize_with_error_feedback`` from ``init_error_feedback``, ten
    steps over a nested tree of fp32 and bf16 leaves: grads and residuals
    ``==`` the reference's at every step."""
    rng = np.random.default_rng(7)
    shapes = {"a": (300,), "b": {"c": (16, 40), "d": (5,)}}
    jerr = jcomp.init_error_feedback(
        jax.tree.map(jnp.zeros, shapes,
                     is_leaf=lambda s: isinstance(s, tuple)))
    terr = tcomp.init_error_feedback(bridge.tree_map(torch.zeros, shapes))
    for step in range(10):
        g = {"a": rng.standard_normal(300).astype(np.float32),
             "b": {"c": rng.standard_normal((16, 40)).astype(np.float32)
                   * np.float32(1e-3),
                   "d": rng.standard_normal(5).astype(np.float32)}}
        gj = jax.tree.map(jnp.asarray, g)
        gj["b"]["c"] = gj["b"]["c"].astype(jnp.bfloat16)
        gt = bridge.tree_map(torch.from_numpy, g)
        gt["b"]["c"] = bridge._to_torch(np.asarray(gj["b"]["c"]),
                                        torch.device("cpu"))
        qj, jerr = jcomp.quantize_with_error_feedback(gj, jerr)
        qt, terr = tcomp.quantize_with_error_feedback(gt, terr)
        for (path, t), (_, e) in zip(bridge.leaves(qt), bridge.leaves(terr)):
            keys = path.split("/")
            want, want_e = qj, jerr
            for k in keys:
                want, want_e = want[k], want_e[k]
            assert t.dtype == bridge._to_torch(np.asarray(want),
                                               torch.device("cpu")).dtype
            np.testing.assert_array_equal(
                t.float().numpy(), np.asarray(want, np.float32), err_msg=path)
            np.testing.assert_array_equal(e.numpy(), np.asarray(want_e),
                                          err_msg=f"{path} step {step}")


def test_optim_exports_what_the_reference_exports():
    """The reference's ``repro.optim`` does not export compression; the
    port's does not either."""
    import repro.optim as jopt
    import repro_torch.optim as topt
    assert topt.__all__ == jopt.__all__


# ------------------------------------------------------------------ meshes

def test_production_mesh_raises_in_a_world_of_one_as_the_reference():
    from repro.launch.mesh import make_production_mesh as jmake
    import torch.distributed as dist
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError):
            jmake(multi_pod=multi_pod)
        with pytest.raises(ValueError, match=f"needs {need} ranks"):
            tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert not dist.is_initialized()


def test_host_mesh_closes_what_it_started_and_can_be_made_again():
    import torch.distributed as dist
    assert not dist.is_initialized()
    for _ in range(2):
        m = tmesh.make_host_mesh("cpu")
        try:
            assert dist.is_initialized() and dist.get_world_size() == 1
            assert m.mesh_dim_names == ("data", "model")
            assert tmesh.axis_sizes(m) == {"data": 1, "model": 1}
            assert tmesh.data_axes(m) == ("data",) and tmesh.dp_size(m) == 1
        finally:
            tmesh.close_mesh(m)
        assert not dist.is_initialized()
        tmesh.close_mesh(m)   # a second close is a no-op


def test_host_mesh_inside_a_group_leaves_the_group_to_its_owner():
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        m = tmesh.make_host_mesh("cpu")
        tmesh.close_mesh(m)
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


# --------------------------------------------- serving on a 1-rank mesh

def _serve(cfg, params, toks, steps, mesh=None):
    with torch.inference_mode():
        tok, logits, cache, _ = serve.run_prefill(cfg, params, toks,
                                                  mesh=mesh)
        outs, _, _ = serve.run_decode(cfg, params, tok, cache, steps,
                                      mesh=mesh)
    return logits, torch.cat([tok] + outs, dim=1)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_mesh", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", MOE_ARCHS + ("jamba-1.5-large-398b",))
def test_serving_on_the_host_mesh_equals_the_resident_path(arch):
    """``chip_smoke.mesh_compare``, the card's mesh phase, on the CPU:
    params placed by ``param_specs`` as DTensors (``fsdp_serve`` from the
    arch's settings: on for jamba, off for the others), the prompts by
    ``batch_spec``, the prefill's cache by ``cache_specs``, the MoE on
    the shard-local path; it raises unless logits and tokens are
    bit-equal to the resident path's and the launch counts equal. Then
    ``chip_smoke.dryrun_check``: the dry run's per-rank bytes of params,
    cache and prompts for that cell equal what the placed DTensors hold,
    and it counts no collective on one rank."""
    smoke = _smoke()
    cfg = get_reduced(arch)
    params = bridge.init_params(cfg, seed=0, device="cpu")
    toks = serve.prompts(cfg, 4, 16, "cpu")
    m = tmesh.make_host_mesh("cpu")
    try:
        out = smoke.mesh_compare(cfg, params, toks, m)
    finally:
        tmesh.close_mesh(m)
    assert out["fsdp"] == settings_for(arch).fsdp_serve
    assert len(out["continuation"]) == smoke.MESH_DECODE + 1
    dry = smoke.dryrun_check(cfg, out, 4, 16)
    assert dry["bytes"] == out["local_bytes"]
    assert out["local_bytes"]["params"] == sum(
        b for _, b in bridge.leaf_sizes(params))
    assert out["local_bytes"]["batch"] == toks.nbytes
    assert dry["collectives"] == {"prefill": 0, "decode": 0}
    assert dry["roofline"]["prefill"]["t_compute_s"] > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_on_the_host_mesh_equals_forward(arch):
    """The teacher-forced forward takes the mesh too: fsdp-placed DTensor
    params, the MoE on the shard-local path, logits and aux loss
    bit-equal to the resident forward's."""
    cfg = get_reduced(arch)
    params = bridge.init_params(cfg, seed=0, device="cpu")
    toks = serve.prompts(cfg, 4, 16, "cpu")
    want = transformer.forward_with_aux(params, cfg, toks)
    m = tmesh.make_host_mesh("cpu")
    try:
        dparams = tshd.distribute(params, m, tshd.param_specs(
            params, fsdp=True, dp_axes=("data",), dp_total=1,
            axis_sizes=tmesh.axis_sizes(m)))
        got = transformer.forward_with_aux(dparams, cfg, toks, mesh=m)
    finally:
        tmesh.close_mesh(m)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_mesh_compare_rejects_a_wrong_shard_local_moe(monkeypatch):
    """Its check has power: expert slices whose ``wo`` is zeroed on the
    mesh path move the logits, and ``mesh_compare`` raises."""
    from repro_torch.models import moe
    smoke = _smoke()
    cfg = get_reduced("granite-moe-1b-a400m")
    params = bridge.init_params(cfg, seed=0, device="cpu")
    slices = moe.expert_slices
    monkeypatch.setattr(moe, "expert_slices", lambda p, mesh: dict(
        slices(p, mesh), wo=torch.zeros_like(slices(p, mesh)["wo"])))
    m = tmesh.make_host_mesh("cpu")
    try:
        with pytest.raises(AssertionError, match="logits differ"):
            smoke.mesh_compare(cfg, params, serve.prompts(cfg, 4, 16, "cpu"),
                               m)
    finally:
        tmesh.close_mesh(m)


def test_a_dtensor_never_reaches_a_kernel():
    from repro_torch.kernels import ops
    from torch.distributed.tensor import Replicate, distribute_tensor
    m = tmesh.make_host_mesh("cpu")
    try:
        a = distribute_tensor(torch.ones(4, 8), m, [Replicate(), Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            ops.matmul(a, torch.ones(8, 2))
    finally:
        tmesh.close_mesh(m)


# ----------------------------------------------------- four ranks of gloo

RANK_CODE = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

store, rank, inp, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4)
try:
    import dataclasses
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch import bridge
    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh as M, serve, sharding as S
    from repro_torch.models import moe, transformer
    from repro_torch.optim.compression import compressed_psum

    res, arr = {}, {}
    m = M._make_mesh((2, 2), ("data", "model"), "cpu")
    sizes, dp = M.axis_sizes(m), M.data_axes(m)
    res["mesh"] = [sizes, list(dp), M.dp_size(m)]
    try:
        M.make_production_mesh(device="cpu")
        res["production"] = None
    except ValueError as e:
        res["production"] = str(e)
    data_i = m.get_coordinate()[0]

    # distribute and gather: a reduced config's params and a prefill cache
    cfg = get_reduced("granite-moe-1b-a400m")
    params = bridge.init_params(cfg, seed=0, device="cpu")
    toks = serve.prompts(cfg, 4, 16, "cpu")
    with torch.inference_mode():
        _, cache = transformer.prefill(params, cfg, toks)
    for name, tree, specs in (
            ("params", params, S.param_specs(params, fsdp=True, dp_axes=dp,
                                             dp_total=2, axis_sizes=sizes)),
            ("cache", cache, S.cache_specs(cache, 4, dp, 2, 2))):
        d = S.distribute(tree, m, specs)
        back = dict(bridge.leaves(S.gather(d)))
        res[name] = {p: [list(x.to_local().shape),
                         torch.equal(back[p], dict(bridge.leaves(tree))[p])]
                     for p, x in bridge.leaves(d)}

    # the shard-local MoE, fp32 and bf16, x as a DTensor and as local rows
    z = np.load(inp)
    for arch in ("granite-moe-1b-a400m", "mixtral-8x7b"):
        c = get_reduced(arch)
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            p = {k: torch.from_numpy(z[f"{arch}/{k}"]).to(dtype)
                 for k in moe.EXPERT_SPECS}
            x = torch.from_numpy(z[f"{arch}/x"]).to(dtype)
            dpp = S.distribute(p, m, S.param_specs(
                p, fsdp=True, dp_axes=dp, dp_total=2, axis_sizes=sizes))
            with torch.inference_mode():
                y, aux = moe.moe_apply(dpp, c, distribute_tensor(
                    x, m, [Replicate(), Replicate()], src_data_rank=None),
                    mesh=m)
                rows = x.shape[0] // 2
                yl, auxl = moe.moe_apply(
                    moe.expert_slices(dpp, m), c,
                    x[data_i * rows:(data_i + 1) * rows], mesh=m)
            arr[f"{arch}/{dt}/y"] = y.full_tensor().float().numpy()
            arr[f"{arch}/{dt}/y_rows"] = yl.float().numpy()
            res[f"{arch}/{dt}/aux"] = [float(aux), float(auxl)]
            res[f"{arch}/{dt}/dtypes"] = [str(y.dtype), str(yl.dtype)]

    # compressed_psum over the world and over each 'model' group
    g = torch.from_numpy(z[f"grad{rank}"])
    arr["psum_world"] = compressed_psum(g).numpy()
    arr["psum_model"] = compressed_psum(g, m.get_group("model")).numpy()

    # serving on the mesh: each rank its data shard's rows; capacity 8,
    # so no token drops at either token count
    c8 = dataclasses.replace(cfg, capacity_factor=8.0)
    dparams = S.distribute(params, m, S.param_specs(
        params, fsdp=True, dp_axes=dp, dp_total=2, axis_sizes=sizes))
    mine = S.distribute({"t": toks}, m,
                        {"t": S.batch_spec(4, dp, 2)})["t"].to_local()
    with torch.inference_mode():
        tok, logits, cache, _ = serve.run_prefill(c8, dparams, mine, mesh=m)
        outs, _, _ = serve.run_decode(c8, dparams, tok, cache, 2, mesh=m)
    arr["serve_logits"] = logits.float().numpy()
    arr["serve_tokens"] = torch.cat([tok] + outs, dim=1).numpy()
    res["data_index"] = data_i
    np.savez(f"{out}/rank{rank}.npz", **arr)
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(res, f)
    M.close_mesh(m)
finally:
    dist.destroy_process_group()
"""


def _moe_inputs(arch, seed):
    """A MoE layer's params (the reference's ``moe_init``) and a (4, 8, d)
    input of unit normals, in fp32."""
    jcfg = jget_reduced(arch)
    pj = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    p = {k: np.asarray(v, np.float32) for k, v in pj.items()}
    x = np.random.default_rng(seed + 1).standard_normal(
        (4, 8, jcfg.d_model)).astype(np.float32)
    return p, x


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run RANK_CODE on four ranks; -> ({rank: json}, {rank: arrays},
    inputs)."""
    tmp = tmp_path_factory.mktemp("mesh4")
    inputs = {}
    for i, arch in enumerate(MOE_ARCHS):
        p, x = _moe_inputs(arch, i)
        inputs.update({f"{arch}/{k}": v for k, v in p.items()})
        inputs[f"{arch}/x"] = x
    for r in range(RANKS):
        inputs[f"grad{r}"] = _grads(1000, 10 + r, scale=10.0 ** (r - 2))
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_CODE, str(tmp / "store"), str(r),
         str(tmp / "in.npz"), str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    res = {r: json.loads((tmp / f"rank{r}.json").read_text())
           for r in range(RANKS)}
    arr = {r: dict(np.load(tmp / f"rank{r}.npz")) for r in range(RANKS)}
    return res, arr, inputs


def test_four_ranks_make_the_2x2_mesh_and_refuse_the_production_one(ranks):
    res, _, _ = ranks
    for r in range(RANKS):
        assert res[r]["mesh"] == [{"data": 2, "model": 2}, ["data"], 2]
        assert "needs 256 ranks; the world has 4" in res[r]["production"]
    assert sorted(res[r]["data_index"] for r in range(RANKS)) == [0, 0, 1, 1]


@pytest.mark.parametrize("what", ["params", "cache"])
def test_distribute_then_gather_gives_the_tree_back(ranks, what):
    """Bit for bit on every rank, and each local shard has the shape the
    spec gives: each sharded dim divided by its axes' sizes."""
    res, _, _ = ranks
    sizes = {"data": 2, "model": 2}
    cfg = get_reduced("granite-moe-1b-a400m")
    params = bridge.init_params(cfg, seed=0, device="cpu")
    if what == "params":
        tree = params
        specs = tshd.param_specs(params, fsdp=True, dp_axes=("data",),
                                 dp_total=2, axis_sizes=sizes)
    else:
        with torch.inference_mode():
            _, tree = transformer.prefill(
                params, cfg, serve.prompts(cfg, 4, 16, "cpu"))
        specs = tshd.cache_specs(tree, 4, ("data",), 2, 2)
    specs = _tflat(specs)
    sharded = 0
    for path, x in bridge.leaves(tree):
        want = [d // tshd._axes_size(s, sizes)
                for d, s in zip(x.shape, specs[path] + (None,) * x.ndim)]
        sharded += want != list(x.shape)
        for r in range(RANKS):
            assert res[r][what][path] == [want, True], (r, path)
    assert sharded > 0


def _ref_moe(arch, p, x, dtype):
    """The reference's ``_moe_core`` on each data shard (2 of 2 rows) ->
    (y, the aux loss's mean over the shards)."""
    jcfg = jget_reduced(arch)
    pj = {k: jnp.asarray(v, dtype) for k, v in p.items()}
    ys, auxes = zip(*(jmoe._moe_core(pj, jcfg, jnp.asarray(x[i:i + 2], dtype))
                      for i in (0, 2)))
    return (np.concatenate([np.asarray(y, np.float32) for y in ys]),
            float(np.mean([float(a) for a in auxes])))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_shard_local_moe_equals_moe_core_on_each_data_shard(ranks, arch,
                                                           dtype):
    """y (as a DTensor's whole, and each rank's rows given its own rows)
    and the aux loss against the reference's ``_moe_core`` on each data
    shard. fp32: rtol 1e-5 (atol 1e-6 for entries that two partial sums
    cancel to near zero); bf16: test_arch_smoke's 2e-2, since the model
    group sums bf16 partial products."""
    res, arr, inputs = ranks
    p = {k: inputs[f"{arch}/{k}"] for k in ("router", "wi_gate", "wi_up",
                                            "wo")}
    x = inputs[f"{arch}/x"]
    want, want_aux = _ref_moe(arch, p, x, getattr(jnp, dtype))
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else TOL_BF16
    key = f"{arch}/{dtype}"
    for r in range(RANKS):
        i = res[r]["data_index"]
        assert res[r][f"{key}/dtypes"] == [f"torch.{dtype}"] * 2
        np.testing.assert_allclose(arr[r][f"{key}/y"], want, **tol)
        np.testing.assert_allclose(arr[r][f"{key}/y_rows"],
                                   want[2 * i:2 * i + 2], **tol)
        for aux in res[r][f"{key}/aux"]:
            np.testing.assert_allclose(aux, want_aux, rtol=1e-5)


def _psum_replay(xs):
    """The reference's ``compressed_psum`` steps (``compression.py:75-87``)
    in NumPy over the ranks' inputs ``xs``."""
    qs, ss = [], []
    for x in xs:
        q, s = jcomp.compress(jnp.asarray(x))
        qs.append(np.asarray(q))
        ss.append(np.asarray(s))
    smax = np.max(ss, axis=0)
    total = sum(np.clip(np.round(q.astype(np.float32)
                                 * (s / smax)[:, None]), -127, 127)
                .astype(np.int32) for q, s in zip(qs, ss))
    flat = (total.astype(np.float32) * smax[:, None]).reshape(-1)
    return flat[: xs[0].size].reshape(xs[0].shape)


def test_compressed_psum_equals_a_numpy_replay_of_the_reference(ranks):
    """Over the world of four, and over each 'model' group (ranks 2i and
    2i + 1): every rank gets the replay's result, ``==``."""
    _, arr, inputs = ranks
    xs = [inputs[f"grad{r}"] for r in range(RANKS)]
    world = _psum_replay(xs)
    for r in range(RANKS):
        np.testing.assert_array_equal(arr[r]["psum_world"], world)
        pair = _psum_replay(xs[r - r % 2: r - r % 2 + 2])
        np.testing.assert_array_equal(arr[r]["psum_model"], pair)
    assert np.abs(world - sum(xs)).max() < 0.05 * np.abs(sum(xs)).max()


def test_compressed_psum_on_one_rank_is_the_round_trip():
    """At world size 1 the shared scale is the rank's own, so the result
    is ``decompress(compress(x))`` bit for bit: ``chip_smoke.psum_check``,
    the card's check, on the CPU. What crosses the wire is two
    all-reduces: the MAX of the 20 fp32 scales and the SUM of the padded
    5 120 values in int32, more bytes than the fp32 tensor's 20 000; q's
    int8 bytes stay on the rank."""
    m = tmesh.make_host_mesh("cpu")
    try:
        x = torch.from_numpy(_grads(5000, 2, 3.0)).reshape(50, 100)
        out = _smoke().psum_check(x)
    finally:
        tmesh.close_mesh(m)
    assert out["wire"] == [
        {"op": "MAX", "dtype": "float32", "bytes": 20 * 4},
        {"op": "SUM", "dtype": "int32", "bytes": 5120 * 4}]
    assert out["wire_bytes"] == 20560 > out["fp32_bytes"] == 20000
    assert out["int8_bytes"] == 5120


def test_serving_on_four_ranks_gives_each_rank_its_rows(ranks):
    """Prefill and 2 decode tokens of the reduced granite-moe-1b-a400m
    (capacity factor 8: no drops at either token count) with fsdp-placed
    DTensor params: each rank's logits are the resident path's for its
    data shard's rows within the bf16 tolerance (2e-2; the model group
    sums the MoE's bf16 partial products), and its tokens agree where the
    resident logits' top-2 gap is beyond that tolerance."""
    import dataclasses
    res, arr, _ = ranks
    cfg = dataclasses.replace(get_reduced("granite-moe-1b-a400m"),
                              capacity_factor=8.0)
    params = bridge.init_params(cfg, seed=0, device="cpu")
    logits, seq = _serve(cfg, params, serve.prompts(cfg, 4, 16, "cpu"), 2)
    logits = logits.float().numpy()
    top2 = -np.sort(-logits[:, -1], axis=-1)[:, :2]
    clear = (top2[:, 0] - top2[:, 1]) > 0.1
    for r in range(RANKS):
        rows = slice(2 * res[r]["data_index"], 2 * res[r]["data_index"] + 2)
        np.testing.assert_allclose(arr[r]["serve_logits"], logits[rows],
                                   **TOL_BF16)
        first = arr[r]["serve_tokens"][:, 0]
        np.testing.assert_array_equal(first[clear[rows]],
                                      seq.numpy()[rows, 0][clear[rows]])


# --------------------------------------------------------------- launchers

@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_production_mesh_flag_raises_on_one_device_as_the_reference(
        launcher, monkeypatch, tmp_path):
    import torch.distributed as dist
    ref, port = {"serve": (jserve, serve), "train": (jtrain, train)}[launcher]
    flags = ["--reduced", "--production-mesh"]
    if launcher == "train":
        flags += ["--steps", "1", "--ckpt", str(tmp_path)]
    monkeypatch.setattr(sys, "argv", [launcher] + flags)
    with pytest.raises(ValueError):
        ref.main()
    with pytest.raises(ValueError, match="needs 256 ranks"):
        port.main(flags + ["--device", "cpu"])
    assert not dist.is_initialized()


def test_train_launcher_prints_the_host_mesh_and_runs_twice(tmp_path,
                                                           capsys):
    """The first line carries the reference's ``mesh=`` field; the host
    mesh is closed when ``main`` returns, so a second run starts clean."""
    import torch.distributed as dist
    args = ["--reduced", "--steps", "1", "--batch", "2", "--seq", "8",
            "--device", "cpu", "--ckpt", str(tmp_path)]
    for _ in range(2):
        train.main(args)
        first = capsys.readouterr().out.splitlines()[0]
        assert "mesh={'data': 1, 'model': 1}" in first
        assert not dist.is_initialized()
