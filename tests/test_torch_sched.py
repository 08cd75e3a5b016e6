"""The port's multi-tenant SVM scheduler, fault injection, bounded retry
and activation offload (``repro_torch.svm``, ``repro_torch.ft`` and the
launcher's ``--requests``/``--chaos`` flags) against the JAX package's
``repro.svm`` and ``repro.ft`` on the CPU, equal with ``==``.

The scheduler reads only each leaf's path, shape and dtype, so specs come
at full width without weights: the reference's from ``jax.eval_shape`` of
its init, the port's from meta tensors of ``bridge.param_shapes``. Both
sides get the reference's rates (its TPU host link and serving rate),
passed to the port explicitly, because the port's defaults are the
H100's.
"""

import dataclasses
import functools
import inspect
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

import repro.ft as jft  # noqa: E402
import repro.svm as jsvm  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import ft as tft  # noqa: E402
from repro_torch import svm as tsvm  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's rates (repro/core/costmodel.py: TPU_V5E_HOST and
# CostParams.serve_flops), given to both sides
REF_LINK = tcore.CostParams(link_bw=32e9)
REF_RATE = 197e12 * 0.4
REF = dict(cost_params=REF_LINK, compute_rate=REF_RATE)
ARCHS = ("gemma3-1b", "falcon-mamba-7b")
# the VLM and the encoder-decoder: their specs and single-spec schedules
CTX_ARCHS = ("llama-3.2-vision-11b", "seamless-m4t-medium")
WIDTHS = ("reduced", "full")
POLICIES = ("fifo", "admission", "svm_aware")
CHAOS = (None, 0, 1, 3)      # clean, then FaultPlan.default seeds
N_REQ, TOKENS, FRAC, BATCH = 8, 32, 0.6, 4
MB = tcore.MB
# the heterogeneous mix (as chip_smoke.py's sched phase): both full-width
# specs round-robin, a pool of 0.9 of the larger one
MIX = dict(seed=3, mean_interarrival_s=0.01, tokens=TOKENS,
           spec_choice="roundrobin", pin_frac=0.4)
MIX_FRAC = 0.9


# ------------------------------------------------------------------ specs

def _cfg(arch, width, jax_side):
    if jax_side:
        return (jget_reduced if width == "reduced" else jget_config)(arch)
    return (get_reduced if width == "reduced" else get_config)(arch)


def _meta(arch, width):
    """The port's params tree of ``arch`` as meta tensors: shapes and
    dtypes, no storage."""
    return bridge.tree_map(
        lambda sd: torch.empty(sd[0], dtype=sd[1], device="meta"),
        bridge.param_shapes(_cfg(arch, width, False)))


@functools.lru_cache(maxsize=None)
def _specs(arch, width):
    """(reference spec, port spec), both at batch BATCH, from shapes."""
    shapes = jax.eval_shape(
        lambda: jinit_params(_cfg(arch, width, True), jax.random.PRNGKey(0)))
    return (jsvm.ModelSpec.from_params(arch, shapes, batch=BATCH),
            tsvm.ModelSpec.from_params(arch, _meta(arch, width), batch=BATCH))


def _fields(spec):
    return dataclasses.astuple(spec) + (spec.total_bytes, spec.hot_leaf,
                                        hash(spec))


@pytest.mark.parametrize("width,source", [("reduced", "cpu"),
                                          ("reduced", "meta"),
                                          ("full", "meta")])
@pytest.mark.parametrize("arch", ARCHS + CTX_ARCHS)
def test_model_spec_from_params_equals_reference(arch, width, source):
    ref, port = _specs(arch, width)
    if source == "cpu":
        tree = bridge.init_params(_cfg(arch, width, False), seed=0,
                                  device="cpu")
        port = tsvm.ModelSpec.from_params(arch, tree, batch=BATCH)
    assert _fields(port) == _fields(ref)
    if width == "full":
        assert len(port.leaves) == {"gemma3-1b": 74,
                                    "falcon-mamba-7b": 13,
                                    "llama-3.2-vision-11b": 49,
                                    "seamless-m4t-medium": 126}[arch]


def test_model_spec_from_params_takes_the_batch():
    shapes = jax.eval_shape(
        lambda: jinit_params(jget_reduced("gemma3-1b"),
                             jax.random.PRNGKey(0)))
    for batch in (1, 7):
        assert _fields(tsvm.ModelSpec.from_params(
            "gemma3-1b", _meta("gemma3-1b", "reduced"), batch=batch)) == \
            _fields(jsvm.ModelSpec.from_params("gemma3-1b", shapes,
                                               batch=batch))


@pytest.mark.parametrize("kw", [
    dict(n_layers=6, layer_bytes=2 * MB, embed_bytes=4 * MB),
    dict(n_layers=24, layer_bytes=4 * MB, embed_bytes=24 * MB, batch=3),
    dict(n_layers=5, layer_bytes=3 * MB + 17)])
def test_synthetic_specs_equal_reference(kw):
    assert _fields(tsvm.ModelSpec.synthetic("arch", **kw)) == \
        _fields(jsvm.ModelSpec.synthetic("arch", **kw))


def _synth(mod):
    return [mod.ModelSpec.synthetic("archA", 6, 2 * MB, embed_bytes=4 * MB),
            mod.ModelSpec.synthetic("archB", 10, 2 * MB, embed_bytes=6 * MB)]


def _request_row(r):
    return (r.req_id, dataclasses.astuple(r.spec), r.arrival_s, r.n_tokens)


@pytest.mark.parametrize("jitter", [0, 3])
@pytest.mark.parametrize("choice", ["random", "roundrobin"])
@pytest.mark.parametrize("arrival,mean", [
    ("poisson", 0.004), ("uniform", 0.004), ("burst", 0.004),
    ("poisson", 0.0)])
def test_make_requests_equals_reference(arrival, mean, choice, jitter):
    kw = dict(seed=5, mean_interarrival_s=mean, arrival=arrival, tokens=9,
              token_jitter=jitter, spec_choice=choice)
    got = tsvm.make_requests(_synth(tsvm), 12, **kw)
    want = jsvm.make_requests(_synth(jsvm), 12, **kw)
    assert [_request_row(r) for r in got] == [_request_row(r) for r in want]


@pytest.mark.parametrize("kw,match", [(dict(arrival="storm"), "arrival"),
                                      (dict(spec_choice="best"),
                                       "spec_choice")])
def test_make_requests_rejects_what_the_reference_rejects(kw, match):
    for mod in (jsvm, tsvm):
        with pytest.raises(ValueError, match=match):
            mod.make_requests(_synth(mod), 2, **kw)


# ------------------------------------------------------------ faults

def _events(plan):
    return [dataclasses.astuple(e) for e in plan.events], plan.seed, \
        plan.name


@pytest.mark.parametrize("intensity", [0.4, 1.0, 2.5])
@pytest.mark.parametrize("n,tokens", [(8, 32), (64, 8), (1, 1)])
@pytest.mark.parametrize("seed", [0, 1, 3, 7])
def test_fault_plan_default_equals_reference(seed, n, tokens, intensity):
    kw = dict(n_requests=n, tokens=tokens, intensity=intensity)
    assert _events(tsvm.FaultPlan.default(seed, **kw)) == \
        _events(jsvm.FaultPlan.default(seed, **kw))


@pytest.mark.parametrize("args,match", [
    ((0, "meteor_strike"), "unknown hazard"), ((-1, "crash"), "at_tokens"),
    ((0, "slow_page", 0.0), "frac")])
def test_fault_event_validation_equals_reference(args, match):
    msgs = []
    for mod in (jsvm, tsvm):
        with pytest.raises(ValueError, match=match) as e:
            mod.FaultEvent(*args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _pump(mod, plan_of):
    """Drive an injector over a token counter, as the scheduler does."""
    inj = mod.FaultInjector(plan_of(mod))
    log = []
    for tok in range(0, 80, 3):
        log.append(("next", inj.next_at(), inj.remaining))
        log.append(("env", [dataclasses.astuple(e)
                            for e in inj.due_env(tok)]))
        ev = inj.pop_token_event(tok)
        log.append(("tok", None if ev is None else dataclasses.astuple(ev)))
    log.append(("applied", [dataclasses.astuple(e) for e in inj.applied]))
    return log, inj.stats()


@pytest.mark.parametrize("plan_of", [
    lambda m: m.FaultPlan.default(0, n_requests=8, tokens=8),
    lambda m: m.FaultPlan.default(3, n_requests=4, tokens=16,
                                  intensity=3.0),
    lambda m: m.FaultPlan((m.FaultEvent(5, "crash"),
                           m.FaultEvent(5, "migration_fault",
                                        fail_attempts=3),
                           m.FaultEvent(5, "capacity_loss", frac=0.5),
                           m.FaultEvent(2, "slow_page", frac=4.0)),
                          seed=9)],
    ids=["default0", "default3-dense", "custom-burst"])
def test_fault_injector_equals_reference(plan_of):
    assert _pump(tsvm, plan_of) == _pump(jsvm, plan_of)


# ------------------------------------------------------------- retry

@pytest.mark.parametrize("kw", [
    {}, dict(max_attempts=4, base_delay_s=0.5, factor=2.0, max_delay_s=1.5),
    dict(max_attempts=7, base_delay_s=1e-4, factor=3.0),
    dict(max_attempts=1)])
def test_retry_policy_schedule_equals_reference(kw):
    got, want = tft.RetryPolicy(**kw), jft.RetryPolicy(**kw)
    assert got.schedule() == want.schedule()
    assert [got.delay(k) for k in range(0, 9)] == \
        [want.delay(k) for k in range(0, 9)]
    assert dataclasses.astuple(tft.DEFAULT_RETRY) == \
        dataclasses.astuple(jft.DEFAULT_RETRY)


@pytest.mark.parametrize("kw", [dict(max_attempts=0),
                                dict(base_delay_s=-1.0), dict(factor=0.0)])
def test_retry_policy_validation_equals_reference(kw):
    for mod in (jft, tft):
        with pytest.raises(ValueError):
            mod.RetryPolicy(**kw)


def _retry_trace(mod, fails, max_attempts):
    """``retry_call`` over a callable that fails ``fails`` times: the
    attempts it saw, the backoffs charged, and the outcome."""
    seen, backoffs = [], []

    def flaky(attempt):
        seen.append(attempt)
        if attempt <= fails:
            raise OSError(f"transient {attempt}")
        return f"ok after {attempt}"

    try:
        out = mod.retry_call(
            flaky, policy=mod.RetryPolicy(max_attempts=max_attempts,
                                          base_delay_s=0.1),
            retry_on=(OSError,),
            on_backoff=lambda a, d: backoffs.append((a, d)))
    except mod.RetryError as e:
        out = ("RetryError", e.attempts, str(e), repr(e.last),
               repr(e.__cause__))
    return seen, backoffs, out


@pytest.mark.parametrize("fails,max_attempts", [(0, 4), (2, 4), (3, 4),
                                                (4, 4), (9, 1)])
def test_retry_call_equals_reference(fails, max_attempts):
    assert _retry_trace(tft.retry, fails, max_attempts) == \
        _retry_trace(jft.retry, fails, max_attempts)


def test_retry_call_lets_other_errors_through():
    for mod in (jft, tft):
        with pytest.raises(KeyError):
            mod.retry_call(lambda a: {}["x"], retry_on=(OSError,))


def _budget_trace(mod):
    b = mod.RetryBudget(mod.RetryPolicy(max_attempts=3, base_delay_s=0.25))
    log = []
    for _ in range(4):
        log.append((b.spend(), b.remaining, b.exhausted, b.backoff_s))
    b.reset()
    log.append((b.attempts, b.remaining, b.exhausted, b.backoff_s))
    return log


def test_retry_budget_equals_reference():
    assert _budget_trace(tft) == _budget_trace(jft)


# ----------------------------------------------------------- offload

@pytest.mark.parametrize("engine", ["session", "scalar"])
@pytest.mark.parametrize("svm_aware", [True, False])
@pytest.mark.parametrize("n_layers,act,res,compute", [
    (12, 16 * MB, 4, 0.0), (24, 8 * MB, 6, 2e-4), (6, 3 * MB + 5, 8, 1e-5)])
def test_simulate_offload_equals_reference(n_layers, act, res, compute,
                                           svm_aware, engine):
    args = (n_layers, act, res * act)
    got_plan = tsvm.plan_offload(*args, svm_aware=svm_aware)
    want_plan = jsvm.plan_offload(*args, svm_aware=svm_aware)
    assert dataclasses.asdict(got_plan) == dataclasses.asdict(want_plan)
    assert got_plan.resident_layers == want_plan.resident_layers
    got_stats, want_stats = {}, {}
    got = tsvm.simulate_offload(got_plan, params=REF_LINK,
                                compute_per_layer_s=compute, engine=engine,
                                session_stats=got_stats)
    want = jsvm.simulate_offload(want_plan, compute_per_layer_s=compute,
                                 engine=engine, session_stats=want_stats)
    assert got == want
    assert got_stats == want_stats


@pytest.mark.parametrize("svm_aware", [True, False])
def test_record_offload_equals_reference(svm_aware):
    """``record_offload`` into a caller's own session and manager."""
    def run(core, svm):
        plan = svm.plan_offload(10, 4 * MB, 3 * 4 * MB, svm_aware=svm_aware)
        space = core.AddressSpace(plan.budget_bytes, base=0,
                                  alignment=2 * MB)
        rids = [space.ranges_of(space.alloc(plan.act_bytes, f"a{i}"))[0].rid
                for i in range(plan.n_layers)]
        mgr = core.SVMManager(space, policy="lru",
                              params=core.CostParams(link_bw=32e9))
        sess = core.TraceSession(mgr)
        svm.record_offload(sess, plan, rids, compute_per_layer_s=1e-4)
        sess.flush()
        return mgr.summary(), sess.stats()

    assert run(tcore, tsvm) == run(jcore, jsvm)


def test_offload_rejects_an_unknown_engine():
    with pytest.raises(ValueError, match="unknown engine"):
        tsvm.simulate_offload(tsvm.plan_offload(4, MB, 4 * MB),
                              engine="batched")


# ---------------------------------------------------------- scheduler

def _pool(spec, frac=FRAC):
    return max(int(spec.total_bytes * frac), 1)


def _plans(chaos):
    """The default fault plans of seed ``chaos`` (None: a clean run)."""
    if chaos is None:
        return None, None
    kw = dict(n_requests=N_REQ, tokens=TOKENS)
    return (jsvm.FaultPlan.default(chaos, **kw),
            tsvm.FaultPlan.default(chaos, **kw))


def _pair(jspecs, tspecs, cap, chaos=None, **kw):
    """run_schedule on both sides with the same arguments."""
    jplan, tplan = _plans(chaos)
    want = jsvm.run_schedule(jspecs, N_REQ, cap, fault_plan=jplan, **kw)
    got = tsvm.run_schedule(tspecs, N_REQ, cap, fault_plan=tplan, **REF,
                            **kw)
    return got, want


def _conserved(r):
    c, m = r["conservation"], r["mgr"]
    assert c["svm_wall_s"] == pytest.approx(m["wall_s"], abs=1e-9)
    for k in ("migrations", "evictions", "bytes_migrated", "bytes_evicted"):
        assert c[k] == m[k], k


@pytest.mark.parametrize("chaos", CHAOS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("arch", ARCHS + CTX_ARCHS)
def test_run_schedule_equals_reference(arch, width, policy, chaos):
    jspec, tspec = _specs(arch, width)
    got, want = _pair([jspec], [tspec], _pool(jspec), chaos,
                      policy=policy, tokens=TOKENS)
    assert got == want
    assert got["n_failed"] == 0
    if chaos is not None:
        assert got["chaos"]["injector"]["events_remaining"] == 0
    _conserved(got)


@pytest.mark.parametrize("policy", ["admission", "svm_aware"])
@pytest.mark.parametrize("arch", ARCHS)
def test_run_schedule_admit_by_measured_equals_reference(arch, policy):
    jspec, tspec = _specs(arch, "full")
    got, want = _pair([jspec], [tspec], _pool(jspec), policy=policy,
                      admit_by="measured", tokens=TOKENS,
                      mean_interarrival_s=0.004)
    assert got == want


@pytest.mark.parametrize("chaos", [None, 0])
@pytest.mark.parametrize("arch", ARCHS)
def test_run_schedule_thrash_guard_equals_reference(arch, chaos):
    jspec, tspec = _specs(arch, "full")
    got, want = _pair([jspec], [tspec], _pool(jspec), chaos,
                      policy="svm_aware", tokens=TOKENS,
                      thrash_watermark=3.0, thrash_window=32)
    assert got == want


def _mix():
    pairs = [_specs(a, "full") for a in ARCHS]
    jspecs, tspecs = [p[0] for p in pairs], [p[1] for p in pairs]
    cap = int(max(s.total_bytes for s in jspecs) * MIX_FRAC)
    return jspecs, tspecs, cap


@functools.lru_cache(maxsize=None)
def _mix_pair(policy, chaos):
    jspecs, tspecs, cap = _mix()
    return _pair(jspecs, tspecs, cap, chaos, policy=policy, **MIX)


@pytest.mark.parametrize("chaos", [None, 0])
@pytest.mark.parametrize("policy", POLICIES)
def test_heterogeneous_mix_equals_reference(policy, chaos):
    got, want = _mix_pair(policy, chaos)
    assert got == want
    assert got["n_failed"] == 0
    _conserved(got)


def _tier_view(r):
    """A run without the execution-mode markers that differ between the
    tiers by design, as tests/test_fused_rounds.py strips them: the
    ``fused`` flag, the concat-build and memo counters (scalar mode has no
    batched interpreter), and the count of fused rounds degraded to
    per-token replay, which only the fused tier has."""
    r = dict(r, shared_cache=dict(r["shared_cache"]))
    r.pop("fused")
    for k in ("shared_concats", "concat_memo_entries",
              "concat_memo_evictions"):
        r["shared_cache"].pop(k)
    if "chaos" in r:
        r["chaos"] = dict(r["chaos"])
        r["chaos"].pop("degraded_rounds")
    return r


@pytest.mark.parametrize("chaos", [None, 0])
@pytest.mark.parametrize("policy", POLICIES)
def test_fused_per_token_and_scalar_tiers_agree(policy, chaos):
    """On the heterogeneous mix: fused == per-token == scalar in the port
    (the fused tier equals the reference's in the test above)."""
    _, tspecs, cap = _mix()
    plan = _plans(chaos)[1]
    runs = [tsvm.run_schedule(tspecs, N_REQ, cap, policy=policy,
                              fault_plan=plan, **MIX, **tier)
            for tier in (dict(fused=True), dict(fused=False),
                         dict(fused=False, scalar=True))]
    assert [r["fused"] for r in runs] == [True, False, False]
    rows = [r["requests"] + r["failed_requests"] for r in runs]
    assert rows[0] == rows[1] == rows[2]
    assert runs[0]["makespan_s"] == runs[1]["makespan_s"] \
        == runs[2]["makespan_s"]
    assert _tier_view(runs[0]) == _tier_view(runs[1]) \
        == _tier_view(runs[2])


def test_a_rerun_is_bit_identical():
    _, tspecs, cap = _mix()
    plan = tsvm.FaultPlan.default(0, n_requests=N_REQ, tokens=TOKENS)
    runs = [tsvm.run_schedule(tspecs, N_REQ, cap, policy="svm_aware",
                              fault_plan=plan, **MIX) for _ in range(2)]
    assert runs[0] == runs[1]


@pytest.mark.parametrize("scalar", [False, True])
def test_a_pinned_full_pool_raises_as_in_the_reference(scalar):
    """Two tenants each pinning half the pool leave no victim for the
    next migration; the reference raises there, and so does the port."""
    errors = []
    for mod in (jsvm, tsvm):
        spec = mod.ModelSpec.synthetic("a", 4, 2 * MB, embed_bytes=4 * MB)
        with pytest.raises(RuntimeError, match="pinned/unevictable") as e:
            mod.run_schedule([spec], 2, 8 * MB, policy="svm_aware",
                             pin_frac=1.0, admit_watermark=4.0, tokens=3,
                             scalar=scalar)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("kw,match", [(dict(policy="lifo"), "policy"),
                                      (dict(admit_by="vibes"), "admit_by")])
def test_pool_scheduler_rejects_what_the_reference_rejects(kw, match):
    for mod in (jsvm, tsvm):
        with pytest.raises(ValueError, match=match):
            mod.PoolScheduler(8 * MB, **kw)


def test_pool_scheduler_defaults_to_the_h100_preset():
    sched = tsvm.PoolScheduler(8 * MB)
    assert sched.mgr.params == tcore.H100_HOST
    assert sched.compute_rate == tcore.H100_SERVE_FLOPS
    assert inspect.signature(tsvm.simulate_offload).parameters[
        "params"].default == tcore.H100_HOST


# ---------------------------------------------------------- launcher

@pytest.mark.parametrize("chaos", [None, 0, 3])
@pytest.mark.parametrize("policy", POLICIES)
def test_schedule_report_equals_reference(policy, chaos):
    got, want = _mix_pair(policy, chaos)
    assert serve.schedule_report(got) == jserve.schedule_report(want)


def _sched_block(out):
    lines = out.splitlines()
    i = [k for k, ln in enumerate(lines) if ln.startswith("svm sched[")]
    assert len(i) == 1, out
    block = [lines[i[0]]]
    for ln in lines[i[0] + 1:]:
        if not ln.startswith("  "):
            break
        block.append(ln)
    return "\n".join(block)


@pytest.mark.parametrize("flags", [
    ["--chaos", "--chaos-seed", "3", "--chaos-intensity", "2"],
    ["--sched-policy", "admission", "--admit-by", "measured", "--arrival",
     "0.004", "--thrash-watermark", "3", "--svm-policy", "clock"]],
    ids=["chaos", "measured"])
def test_main_prints_the_reference_sched_block(flags, monkeypatch, capsys):
    """On the reduced gemma3-1b (falcon-mamba-7b's schedules are compared
    with run_schedule above: the block depends only on the spec)."""
    flags = ["--reduced", "--svm-budget-frac", "0.6",
             "--requests", "8", "--decode", "8"] + flags
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jserve.main()
    want = capsys.readouterr().out
    monkeypatch.setattr(serve, "WeightStream",
                        functools.partial(serve.WeightStream, **REF))
    monkeypatch.setattr(serve, "run_schedule",
                        functools.partial(tsvm.run_schedule, **REF))
    serve.main(flags + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _sched_block(got) == _sched_block(want)
    assert [ln for ln in got.splitlines() if ln.startswith("svm stream:")] \
        == [ln for ln in want.splitlines()
            if ln.startswith("svm stream:")]
    if "--chaos" in flags:
        assert "\n  chaos[default seed 3]" in _sched_block(got)


@pytest.mark.parametrize("flags", [
    ["--requests", "4"], ["--sched-policy", "lifo"],
    ["--admit-by", "vibes"], ["--thrash-watermark", "high"]],
    ids=["requests-without-pool", "policy", "admit-by", "watermark"])
def test_bad_flags_exit_as_in_the_reference(flags, monkeypatch, capsys):
    """The ``ap.error`` of ``--requests > 1`` without a pool, and the
    flags' choices and types, as the reference's parser has them."""
    flags = ["--reduced"] + flags
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    with pytest.raises(SystemExit) as want:
        jserve.main()
    want_err = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        serve.main(flags + ["--device", "cpu"])
    got_err = capsys.readouterr().err.splitlines()[-1]
    assert got.value.code == want.value.code == 2
    assert got_err == want_err


# ------------------------------------------------------ package surface

def test_svm_exports_what_the_reference_exports():
    assert set(tsvm.__all__) == set(jsvm.__all__)
    assert tft.__all__ == jft.__all__


@pytest.mark.parametrize("mod", [tsvm, tft], ids=["svm", "ft"])
def test_public_exports_have_nontrivial_docstrings(mod):
    thin = []
    for name in mod.__all__:
        obj = getattr(mod, name)
        if not (inspect.isclass(obj) or inspect.isfunction(obj)):
            continue
        doc = inspect.getdoc(obj)
        if not doc or len(doc.split()) < 3:
            thin.append(f"{mod.__name__}.{name}: {doc!r}")
    assert not thin, f"undocumented public symbols: {thin}"


def test_sched_ft_and_launcher_import_no_jax_and_nothing_of_repro():
    code = ("import sys, repro_torch.svm, repro_torch.svm.scheduler, "
            "repro_torch.svm.faults, repro_torch.svm.offload, "
            "repro_torch.ft, repro_torch.ft.retry, "
            "repro_torch.launch.serve\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
