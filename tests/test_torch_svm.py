"""The port's SVM weight stream (``repro_torch.svm`` and the launcher's
``--svm-*`` flags) against the JAX package's ``repro.svm`` on the CPU: the
planner and hot-set copies, the restored ``measured_pin`` axis of the core,
`StreamingExecutor` and `WeightStream`, all equal with ``==``.

Params cross with ``bridge.params_from_numpy``. Both sides get the same
rates: the reference's own defaults (its TPU host link and serving rate),
passed to the port explicitly, because the port's defaults are the H100's.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

import repro.svm as jsvm  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import svm as tsvm  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.svm.executor import host_leaf  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's rates (repro/core/costmodel.py: TPU_V5E_HOST and
# CostParams.serve_flops), given to both sides
REF_LINK = tcore.CostParams(link_bw=32e9)
REF_RATE = 197e12 * 0.4
REF = dict(cost_params=REF_LINK, compute_rate=REF_RATE)
ARCHS = ("gemma3-1b", "falcon-mamba-7b")
MODES = ("naive", "svm_aware", "measured", "zero_copy")
POLICIES = ("lrf", "lru", "clock", "random")
BATCH, STEPS, FRAC = 4, 6, 0.6
GB = 1 << 30


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(reference params, the same params in the port on the CPU)."""
    pj = jinit_params(jget_reduced(arch), jax.random.PRNGKey(0))
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, pj),
                                  get_reduced(arch), device="cpu")
    return pj, pt


def _np(x):
    """Bits of a tensor or JAX array as numpy (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


class _ScalarExecutor(jsvm.StreamingExecutor):
    """The reference's executor on the op-for-op scalar session."""

    def __init__(self, *args, **kw):
        super().__init__(*args, scalar=True, **kw)


def _streams(arch, mode, policy, frac=FRAC, scalar=False,
             monkeypatch=None):
    """The reference's and the port's `WeightStream` on one arch."""
    pj, pt = _params(arch)
    if scalar:
        monkeypatch.setattr(jsvm, "StreamingExecutor", _ScalarExecutor)
    ref = jserve.WeightStream(pj, BATCH, budget_frac=frac, policy=policy,
                              mode=mode)
    port = serve.WeightStream(pt, BATCH, budget_frac=frac, policy=policy,
                              mode=mode, device="cpu", scalar=scalar, **REF)
    assert ref.executor.session.scalar == port.executor.session.scalar \
        == scalar
    return ref, port


# ---------------------------------------------------------------- planner

@pytest.mark.parametrize("arch", ARCHS)
def test_tree_leaf_sizes_equal_reference(arch):
    pj, pt = _params(arch)
    assert tsvm.tree_leaf_sizes(pt) == jsvm.tree_leaf_sizes(pj)
    assert tsvm.tree_leaf_sizes is bridge.leaf_sizes


def _plan_state(plan):
    return dict(leaf_ranges=plan.leaf_ranges, leaf_bytes=plan.leaf_bytes,
                rid_to_leaf=plan.rid_to_leaf, rid_base=plan.rid_base,
                geometry=plan.geometry(), dos=plan.dos(),
                total=plan.total_bytes, budget=plan.hbm_budget,
                ranges=[(r.rid, r.alloc_id, r.start, r.end)
                        for r in plan.space.ranges],
                allocs=[(a.alloc_id, a.name, a.start, a.size)
                        for a in plan.space.allocations])


@pytest.mark.parametrize("frac", [0.3, 0.6, 1.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_param_ranges_equal_reference(arch, frac):
    pj, pt = _params(arch)
    budget = int(sum(n for _, n in bridge.leaf_sizes(pt)) * frac)
    assert _plan_state(tsvm.plan_param_ranges(pt, budget)) == \
        _plan_state(jsvm.plan_param_ranges(pj, budget))


@pytest.mark.parametrize("arch", ARCHS)
def test_shared_space_planning_and_clone_into_equal_reference(arch):
    """Two tenants planned into one space with ``align_start``, then a
    congruent clone of the first: the same ranges, allocations and
    geometry as the reference's, and the clone congruent to its source."""
    pj, pt = _params(arch)

    def run(svm, core, params):
        space = core.AddressSpace(64 << 20, base=core.ranges.DEFAULT_BASE)
        a = svm.plan_param_ranges(params, 1 << 20, space=space,
                                  align_start=True)
        b = svm.plan_leaf_ranges([("x", 5000), ("y", 3 << 20)], 1 << 20,
                                 space=space, align_start=True)
        c = a.clone_into(space)
        assert c.geometry() == a.geometry()
        return [_plan_state(p) for p in (a, b, c)]

    assert run(tsvm, tcore, pt) == run(jsvm, jcore, pj)


# ----------------------------------------------------------------- hotset

def _profile_state(prof):
    return {f: getattr(prof, f).tolist() for f in
            ("rids", "freq", "sizes", "reuse_min", "reuse_mean",
             "reuse_hist")} | dict(n=prof.n_touches,
                                   touched=prof.touched_bytes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hotset_profile_from_touches_equals_reference(seed):
    rng = np.random.default_rng(seed)
    size_arr = rng.integers(1, 1 << 20, size=32).astype(np.int64)
    rid_seq = rng.integers(0, 32, size=500).astype(np.int64)
    got = tsvm.HotSetProfile.from_touches(rid_seq, size_arr, rid_base=3)
    want = jsvm.HotSetProfile.from_touches(rid_seq, size_arr, rid_base=3)
    assert _profile_state(got) == _profile_state(want)
    for window in (0.0, 1e6, 1e7, float(size_arr.sum())):
        assert got.hot_mask(window).tolist() == want.hot_mask(window).tolist()
        assert got.hot_bytes(window) == want.hot_bytes(window)
        assert got.resident_bytes(window) == want.resident_bytes(window)
        assert got.select_hot_rids(window, 4e6).tolist() == \
            want.select_hot_rids(window, 4e6).tolist()
    empty = tsvm.HotSetProfile.from_touches(np.zeros(0, np.int64), size_arr)
    assert _profile_state(empty) == _profile_state(
        jsvm.HotSetProfile.from_touches(np.zeros(0, np.int64), size_arr))


@pytest.mark.parametrize("tokens", [1, 2, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_token_trace_and_profile_equal_reference(arch, tokens):
    pj, pt = _params(arch)
    plans = (tsvm.plan_param_ranges(pt, 1 << 18),
             jsvm.plan_param_ranges(pj, 1 << 18))
    out = []
    for svm, plan in zip((tsvm, jsvm), plans):
        layer_paths = [[p] for p in plan.leaf_ranges]
        ct = svm.token_trace(plan.leaf_ranges, layer_paths, concurrency=32,
                             tokens=tokens)
        size_arr = np.asarray([r.end - r.start for r in plan.space.ranges],
                              dtype=np.int64)
        cols = [c.tolist() for c in ct.touch_columns()]
        out.append((cols, _profile_state(
            svm.HotSetProfile.from_trace(ct, size_arr))))
    assert out[0] == out[1]


class _Spec:
    """A `ModelSpec`-shaped object: ``leaves``, ``layer_paths`` and
    ``total_bytes``, hashable for `ProfileCache`."""

    def __init__(self, leaves):
        self.leaves = tuple(leaves)
        self.layer_paths = tuple((p,) for p, _ in leaves)
        self.total_bytes = sum(n for _, n in leaves)

    def __hash__(self):
        return hash(self.leaves)

    def __eq__(self, other):
        return self.leaves == other.leaves


def test_spec_profile_and_profile_cache_equal_reference():
    spec = _Spec([("embed", 3 << 20), ("l0", 1 << 20), ("l1", 5000),
                  ("head", 3 << 20)])
    out = []
    for svm in (tsvm, jsvm):
        cache = svm.ProfileCache()
        profs = [svm.spec_profile(spec, cache=cache, tokens=t)
                 for t in (2, 2, 3)]
        out.append(([_profile_state(p) for p in profs], cache.stats(),
                    len(cache), _profile_state(svm.spec_profile(spec))))
    assert out[0] == out[1]


# ------------------------------------------ core: the measured_pin axis

@pytest.mark.parametrize("engine", ["batched", "scalar"])
@pytest.mark.parametrize("pin", [0.25, 0.5])
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_simulate_measured_pin_equals_reference(mode, pin, engine):
    def run(core):
        wl = core.make_workload("hotset", 2 * GB, mode=mode, ops=1024,
                                seed=0)
        return core.simulate(wl, GB, engine=engine, measured_pin=pin)

    got, want = run(tcore), run(jcore)
    assert got.row() == want.row()
    assert got.summary == want.summary
    assert sorted(got.manager.pinned) == sorted(want.manager.pinned)
    assert got.manager.pinned          # the measured hot set was pinned


def test_hotset_grid_measured_pins_equal_reference():
    kw = dict(policies=("lrf", "clock"), modes=("static", "oscillating"),
              ops=1024, measured_pins=(0.0, 0.5))
    got = tcore.sweep.hotset_grid(2 * GB, [GB], **kw)
    want = jcore.sweep.hotset_grid(2 * GB, [GB], **kw)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.measured_pin == w.measured_pin
        assert tcore.run_point(g, trace_cache=False) == \
            jcore.run_point(w, trace_cache=False)


# --------------------------------------------------------------- executor

def _pool_keys(ex):
    return sorted(ex._device)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_executor_decode_step_loop_equals_reference(arch, mode, policy):
    """`decode_step(materialize=True)` token by token: the pool's key set
    equal after every step, its tensors bit-equal, ``metrics()`` equal."""
    ref, port = _streams(arch, mode, policy)
    for _ in range(STEPS):
        ref.executor.decode_step(ref.layer_paths, ref.flops)
        port.executor.decode_step(port.layer_paths, port.flops)
        assert _pool_keys(port.executor) == _pool_keys(ref.executor)
    assert port.executor.metrics() == ref.executor.metrics()
    for path, t in port.executor.pool().items():
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(_np(t), _np(ref.executor._device[path]))
    assert port.executor.pool_bytes() <= port.budget


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_executor_fused_decode_steps_equal_reference(arch, mode, policy):
    ref, port = _streams(arch, mode, policy)
    ref.executor.decode_steps(ref.layer_paths, ref.flops, STEPS)
    port.executor.decode_steps(port.layer_paths, port.flops, STEPS)
    assert _pool_keys(port.executor) == _pool_keys(ref.executor)
    assert port.executor.metrics() == ref.executor.metrics()


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_executor_scalar_session_equals_reference(arch, mode, policy,
                                                  monkeypatch):
    """Both sides on the op-for-op scalar session; and the port's scalar
    session equal to its batched one (the engine's equivalence
    guarantee), with the fused pass equal to both but for its cache-hit
    count (it fetches the step segment once)."""
    ref, port = _streams(arch, mode, policy, scalar=True,
                         monkeypatch=monkeypatch)
    for _ in range(STEPS):
        ref.step()
        port.step()
        assert _pool_keys(port.executor) == _pool_keys(ref.executor) == []
    got = port.executor.metrics()
    assert got == ref.executor.metrics()
    _, pt = _params(arch)
    batched, fused = (serve.WeightStream(pt, BATCH, budget_frac=FRAC,
                                         policy=policy, mode=mode,
                                         device="cpu", **REF)
                      for _ in range(2))
    for _ in range(STEPS):
        batched.step()
    fused.steps(STEPS)
    assert batched.executor.metrics() == got
    m = fused.executor.metrics()
    if not fused.executor.prefetch:
        assert m.pop("segment_cache_hits") == 0
        got.pop("segment_cache_hits")
    assert m == got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_executor_fetch_and_tensor_equal_reference(arch, mode):
    """Demand fetches leaf by leaf (with a staged prefetch), then
    ``tensor``: the same tensors, pool keys, scan work and metrics."""
    ref, port = _streams(arch, mode, "lrf")
    paths = [p for p, in port.layer_paths]
    for ex in (ref.executor, port.executor):
        ex.decode_step(ref.layer_paths, ref.flops)
        ex.queue_prefetch(paths[1:3], 1e-4)
        ex.charge_compute(1e9)
    for path in paths + paths[::-1]:
        got = port.executor.fetch(path)
        want = ref.executor.fetch(path)
        np.testing.assert_array_equal(_np(got), _np(want))
        assert _pool_keys(port.executor) == _pool_keys(ref.executor)
        np.testing.assert_array_equal(_np(port.executor.tensor(path)),
                                      _np(ref.executor.tensor(path)))
    assert port.executor.fetch_scan_work == ref.executor.fetch_scan_work
    assert port.executor.metrics() == ref.executor.metrics()


@pytest.mark.parametrize("arch", ARCHS)
def test_run_layer_stream_equals_reference(arch):
    pj, pt = _params(arch)
    budget = int(sum(n for _, n in bridge.leaf_sizes(pt)) * 0.5)
    ref = jsvm.StreamingExecutor(pj, budget, prefetch=True)
    port = tsvm.StreamingExecutor(pt, budget, prefetch=True, device="cpu",
                                  **REF)
    layer_paths = [[p] for p, _ in bridge.leaves(pt)]
    sums = {}

    def apply(side):
        def f(i, tensors):
            (path, t), = tensors.items()
            sums.setdefault((side, i), []).append(
                float(np.asarray(_np(t), np.float64).sum()))
            return 2.0 * BATCH * t.size if side == "ref" else \
                2.0 * BATCH * t.numel()
        return f

    want = jsvm.run_layer_stream(ref, layer_paths, apply("ref"), steps=3)
    got = tsvm.run_layer_stream(port, layer_paths, apply("port"), steps=3)
    assert got == want
    for i in range(len(layer_paths)):
        assert sums[("port", i)] == sums[("ref", i)]


def test_executor_validates_prefetch_mode():
    _, pt = _params("gemma3-1b")
    with pytest.raises(ValueError, match="prefetch_mode"):
        tsvm.StreamingExecutor(pt, 1 << 18, prefetch_mode="bogus",
                               device="cpu")
    ex = tsvm.StreamingExecutor(pt, 1 << 18, prefetch=True, device="cpu")
    assert ex.prefetch_mode == "aggressive" and ex.prefetch


def test_host_leaves_on_the_cpu_are_the_params_unpinned():
    _, pt = _params("gemma3-1b")
    ex = tsvm.StreamingExecutor(pt, 1 << 18, device="cpu")
    for (path, host), (_, param) in zip(bridge.leaves(ex.host_params),
                                        bridge.leaves(pt)):
        assert host.data_ptr() == param.data_ptr()
        assert not host.is_pinned()
    x = torch.arange(12.0).reshape(3, 4).t()
    y = host_leaf(x, pin=False)
    assert y.is_contiguous() and torch.equal(y, x)


def test_executor_defaults_to_the_h100_preset():
    from repro_torch.core import costmodel
    _, pt = _params("gemma3-1b")
    ex = tsvm.StreamingExecutor(pt, 1 << 18, device="cpu")
    assert ex.compute_rate == costmodel.H100_SERVE_FLOPS
    assert ex.mgr.params == costmodel.H100_HOST
    assert costmodel.H100_HOST.link_bw > 0 and costmodel.H100_SERVE_FLOPS > 0


# ------------------------------------------------------------ WeightStream

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch,frac", [("gemma3-1b", 0.15),
                                       ("gemma3-1b", 0.6),
                                       ("falcon-mamba-7b", 0.4),
                                       ("falcon-mamba-7b", 0.6),
                                       ("granite-3-2b", 0.6),
                                       ("granite-moe-1b-a400m", 0.6),
                                       ("llama-3.2-vision-11b", 0.6),
                                       ("seamless-m4t-medium", 0.6)])
def test_weight_stream_report_equals_reference(arch, frac, mode):
    ref, port = _streams(arch, mode, "lrf", frac=frac)
    assert port.layer_paths == ref.layer_paths
    assert port.flops == ref.flops
    assert (port.total_bytes, port.budget) == (ref.total_bytes, ref.budget)
    ref.steps(STEPS)
    port.steps(STEPS)
    ref.step()
    port.step()
    assert port.report(STEPS + 1) == ref.report(STEPS + 1)
    assert port.executor.metrics() == ref.executor.metrics()
    assert port.executor._zc_leaves == ref.executor._zc_leaves
    assert sorted(port.executor.mgr.pinned) == sorted(ref.executor.mgr.pinned)


@pytest.mark.parametrize("mode", ["naive", "svm_aware"])
def test_a_leaf_larger_than_the_pool_raises_as_in_the_reference(mode):
    """falcon-mamba-7b's in_proj is 0.36 of the reduced weights, so a pool
    of 0.15 cannot hold it: both sides raise the same error."""
    ref, port = _streams("falcon-mamba-7b", mode, "lrf", frac=0.15)
    errors = []
    for ws in (ref, port):
        with pytest.raises(RuntimeError, match="device full") as info:
            ws.steps(2)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_weight_stream_covers_both_svm_aware_branches_and_the_zc_cap():
    """At F = 0.6 the reduced gemma3-1b's embed is pinned (under half the
    pool) and falcon-mamba-7b's largest leaf is not; zero-copy packs up
    to half the weights, skipping a leaf that would overflow."""
    pinned = {}
    for arch in ARCHS:
        _, port = _streams(arch, "svm_aware", "lrf")
        pinned[arch] = bool(port.executor.mgr.pinned)
        assert port.executor.prefetch
    assert pinned == {"gemma3-1b": True, "falcon-mamba-7b": False}
    _, port = _streams("gemma3-1b", "zero_copy", "lrf")
    sizes = dict(bridge.leaf_sizes(_params("gemma3-1b")[1]))
    zc = sum(sizes[p] for p in port.executor._zc_leaves)
    assert zc <= port.total_bytes // 2
    skipped = [n for p, n in sizes.items()
               if p not in port.executor._zc_leaves]
    assert zc + max(skipped) > port.total_bytes // 2


def _svm_line(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("svm stream:")]
    assert len(lines) == 1, out
    return lines[0]


@pytest.mark.parametrize("arch,mode,policy", [
    ("gemma3-1b", "svm_aware", "lrf"), ("gemma3-1b", "zero_copy", "clock"),
    ("falcon-mamba-7b", "naive", "lru"), ("falcon-mamba-7b", "measured",
                                         "random"),
    ("seamless-m4t-medium", "svm_aware", "lrf")])
def test_main_prints_the_reference_svm_stream_line(arch, mode, policy,
                                                   monkeypatch, capsys):
    flags = ["--arch", arch, "--reduced", "--svm-budget-frac", "0.6",
             "--svm-mode", mode, "--svm-policy", policy]
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jserve.main()
    want = _svm_line(capsys.readouterr().out)
    monkeypatch.setattr(serve, "WeightStream",
                        functools.partial(serve.WeightStream, **REF))
    serve.main(flags + ["--device", "cpu"])
    assert _svm_line(capsys.readouterr().out) == want


# ------------------------------------------------------------- no fallback

def test_executor_and_launcher_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pt = _params("gemma3-1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsvm.StreamingExecutor(pt, 1 << 18)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.WeightStream(pt, BATCH, budget_frac=FRAC, policy="lrf",
                           mode="naive")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced", "--svm-budget-frac", "0.6"])


# --------------------------------------------------------------- isolation

def test_svm_and_analysis_import_no_jax_and_nothing_of_repro():
    code = ("import sys, repro_torch.svm, repro_torch.svm.hotset, "
            "repro_torch.analysis, repro_torch.analysis.__main__\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
