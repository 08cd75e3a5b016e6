"""The port's copy of the SVM core (``repro_torch.core``) and of the paper's
workload table (``repro_torch.configs.paper_workloads``) against the JAX
package's ``repro.core``: the same workloads, managers, policies and
engines give results equal with ``==``.

Every input is fixed. The reference's UVM "all resident blocks pinned"
fault, which only random pin patterns reach, enters one test on purpose:
the port's copy must raise it exactly where the reference does."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import test_engine_fuzz as fuzz  # the reference's fuzz trace generator

from repro import core as jcore
from repro.core import engine as jengine
from repro_torch import core as tcore
from repro_torch.core import engine as tengine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 8 * jcore.GB
DOS = (75, 109, 150)

# the nine registered workloads and the two SVM-aware rewrites
CASES = [(n, {}) for n in jcore.WORKLOADS] + [("jacobi2d", {"svm_aware": True}),
                                               ("sgemm", {"svm_aware": True})]
CASE_IDS = [n + ("-aware" if kw else "") for n, kw in CASES]
# (manager, policy, engine)
MODES = [("svm", "lrf", "batched"), ("svm", "lru", "batched"),
         ("svm", "clock", "batched"), ("svm", "lrf", "scalar"),
         ("uvm", "lrf", "batched"), ("uvm", "lru", "batched"),
         ("uvm", "clock", "batched"), ("uvm", "lrf", "scalar")]
# UVM replays of far-oversubscribed points take up to a minute each (mvt
# at DOS 150), so the UVM manager runs DOS 75 and 109, and the wave
# workloads mvt and gesummv at 75 only; the SVM manager runs every point
UVM_DOS = {"mvt": (75,), "gesummv": (75,)}


def _run(core, name, kw, dos, manager, policy, engine):
    mgr = {"svm": core.SVMManager, "uvm": core.UVMManager}[manager]
    wl = core.make_workload(name, int(CAP * dos / 100), **kw)
    return core.simulate(wl, CAP, policy=policy, manager_cls=mgr,
                         engine=engine)


@pytest.mark.parametrize("mode", MODES, ids=["-".join(m) for m in MODES])
@pytest.mark.parametrize("name,kw", CASES, ids=CASE_IDS)
def test_simulate_equals_reference(name, kw, mode):
    """``row()``, ``wall_s`` and the whole ``summary`` (its
    ``cost_breakdown`` too), and the profiled events."""
    for dos in DOS if mode[0] == "svm" else UVM_DOS.get(name, (75, 109)):
        want = _run(jcore, name, kw, dos, *mode)
        got = _run(tcore, name, kw, dos, *mode)
        assert got.row() == want.row(), dos
        assert got.wall_s == want.wall_s, dos
        assert got.summary == want.summary, dos
        assert got.summary["cost_breakdown"] == want.summary["cost_breakdown"]
        assert [vars(e) for e in got.manager.events] == \
            [vars(e) for e in want.manager.events], dos


@pytest.mark.parametrize("spec", [("stream", {}), ("jacobi2d", {}),
                                  ("jacobi2d", {"svm_aware": True})],
                         ids=["stream", "jacobi2d", "jacobi2d-aware"])
def test_dos_sweep_equals_reference(spec):
    want = jcore.dos_sweep(spec, DOS, CAP, jobs=0)
    got = tcore.dos_sweep(spec, DOS, CAP, jobs=0)
    assert got == want
    assert len(got) == len(DOS) and all("norm_perf" in r for r in got)


def test_dos_sweep_with_a_callable_equals_reference():
    want = jcore.dos_sweep(lambda b: jcore.make_workload("stream", b), DOS,
                           CAP, normalize_at=90.0)
    got = tcore.dos_sweep(lambda b: tcore.make_workload("stream", b), DOS,
                          CAP, normalize_at=90.0)
    assert got == want


def _points(core):
    return [core.SweepPoint.make(n, CAP * d / 100.0, CAP, policy=pol,
                                 wl_kwargs=kw, manager=man)
            for n, kw in (("stream", {}), ("jacobi2d", {"svm_aware": True}))
            for d in DOS for pol in ("lrf", "clock")
            for man in ("svm", "uvm")]


def test_run_sweep_with_a_cache_equals_reference(tmp_path):
    """One cache directory per package: the copy's cache keys hash its own
    sources, so the rows of one package are never served to the other."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    want = jcore.run_sweep(_points(jcore), jobs=0, cache_dir=jdir)
    stats = {}
    got = tcore.run_sweep(_points(tcore), jobs=0, cache_dir=tdir, stats=stats)
    assert got == want
    assert stats["cached"] == 0 and stats["computed"] == len(got)
    again = {}
    assert tcore.run_sweep(_points(tcore), jobs=0, cache_dir=tdir,
                           stats=again) == want
    assert again["cached"] == len(got)
    assert sorted(os.listdir(jdir)) != sorted(os.listdir(tdir))
    point = _points(tcore)[0]
    assert point.key(tcore.MI250X) != _points(jcore)[0].key(jcore.MI250X)


@pytest.mark.parametrize("name,kw", CASES, ids=CASE_IDS)
def test_emit_columns_equal_generator_lowering(name, kw):
    """The copy's columnar tier against its own ``trace()`` generator, and
    both against the reference's columns."""
    cols = ("codes", "rids", "concs", "hints", "fargs", "boundaries")
    for dos in DOS:
        made = []
        for core, eng in ((tcore, tengine), (jcore, jengine)):
            space = core.AddressSpace(CAP)
            wl = core.make_workload(name, int(CAP * dos / 100), **kw)
            wl.build(space)
            made.append((eng.compile_trace(wl.trace(space)),
                         wl.emit_columns(space)))
        (t_gen, t_col), (_, j_col) = made
        for f in cols:
            assert (getattr(t_gen, f) == getattr(t_col, f)).all(), (dos, f)
            assert getattr(t_col, f).dtype == getattr(j_col, f).dtype
            assert (getattr(t_col, f) == getattr(j_col, f)).all(), (dos, f)


def test_copy_keeps_the_paper_constants_and_no_tpu_preset():
    from repro.core import traces as jtraces
    from repro_torch.core import costmodel, traces
    assert (traces.PEAK_FLOPS, traces.HBM_BW) == (jtraces.PEAK_FLOPS,
                                                  jtraces.HBM_BW)
    assert tcore.MI250X == tcore.CostParams()
    assert dataclasses.astuple(tcore.MI250X) == tuple(
        v for f, v in zip(dataclasses.fields(jcore.MI250X),
                          dataclasses.astuple(jcore.MI250X))
        if f.name != "serve_flops")
    assert not [n for n in dir(tcore) if "TPU" in n.upper()]
    assert not [n for n in dir(costmodel) if "TPU" in n.upper()]
    assert not hasattr(tcore.MI250X, "serve_flops")


def test_paper_workloads_lists_the_papers_eight():
    from repro_torch.configs import paper_workloads as pw
    assert sorted(pw.PAPER_WORKLOADS) == sorted(
        ["stream", "conv2d", "jacobi2d", "bfs", "syr2k", "sgemm", "mvt",
         "gesummv"])
    assert set(pw.PAPER_WORKLOADS) == set(tcore.WORKLOADS) - {"hotset"}
    assert {n for n, c in pw.PAPER_WORKLOADS.items()
            if c.svm_aware_variant} == {"jacobi2d", "sgemm"}
    assert pw.PAPER_WORKLOADS["stream"].category == "I"
    assert pw.PAPER_WORKLOADS["jacobi2d"].category == "II"
    wl = pw.build("jacobi2d", 109, svm_aware=True)
    assert wl.total_bytes == int(pw.DEFAULT_CAPACITY * 109 / 100.0)
    with pytest.raises(ValueError):
        pw.build("hotset", 75)


def test_paper_workloads_build_equals_reference_workload():
    from repro_torch.configs import paper_workloads as pw
    for name in pw.PAPER_WORKLOADS:
        got = tcore.simulate(pw.build(name, 109), pw.DEFAULT_CAPACITY)
        want = jcore.simulate(jcore.make_workload(
            name, int(pw.DEFAULT_CAPACITY * 109 / 100.0)), pw.DEFAULT_CAPACITY)
        assert got.row() == want.row(), name


def test_core_and_paper_workloads_import_no_jax_and_nothing_of_repro():
    code = ("import sys, repro_torch.core, repro_torch.core.engine_uvm, "
            "repro_torch.configs.paper_workloads\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes', 'torch'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# `UVMManager.pin` pops the range's blocks from `resident`
# (repro/core/uvm.py:150-155), so a later `touch` of the pinned range
# faults them in again and takes their bytes from `free` a second time
# (:107-127), until `_lru_victim` finds only pinned blocks and raises
# (:204-208). The uvm fuzz trace of this seed reaches it: it is the
# example test_engine_fuzz.py's property test saved.
UVM_PIN_FAULT_SEED = 190


def _uvm_fuzz_fault(core, engine, monkeypatch):
    """The uvm trace ``assert_differential`` builds for
    UVM_PIN_FAULT_SEED (test_engine_fuzz.py's generator over ``core``'s
    AddressSpace), replayed op by op (``apply_trace``) or lowered and
    batched (``execute_compiled``) until it raises: (the error, the ops
    fed when it raised, the manager's state then)."""
    monkeypatch.setattr(fuzz, "AddressSpace", core.AddressSpace)
    rng = np.random.default_rng(UVM_PIN_FAULT_SEED)
    space = fuzz.random_space(rng)
    ops = fuzz.random_ops(rng, space, int(rng.integers(50, 400)),
                          allow_spill=False)
    mgr = core.UVMManager(fuzz.random_space(
        np.random.default_rng(UVM_PIN_FAULT_SEED)))
    fed = []

    def feed():
        for op in ops:
            fed.append(op)
            yield op
    with pytest.raises(RuntimeError) as err:
        if engine == "scalar":
            core.apply_trace(mgr, feed())
        else:
            core.execute_compiled(core.compile_trace(feed()), mgr)
    state = dict(resident=list(mgr.resident.items()), free=mgr.free,
                 pinned=sorted(mgr.pinned), dirty=sorted(mgr.dirty),
                 wall=mgr.wall)
    return str(err.value), fed, state


@pytest.mark.parametrize("engine", ["scalar", "batched"])
def test_uvm_pin_fault_of_the_fuzz_trace_equals_reference(engine,
                                                          monkeypatch):
    """The reference's UVM pin-accounting fault, which the port's copy
    shares on purpose: seed 190's uvm fuzz trace raises the same
    RuntimeError at the same op through ``repro_torch.core`` as through
    ``repro.core``, op by op and batched, and leaves the same state. When
    the reference is repaired, the copy moves with it and this test
    holds both to the repair."""
    want = _uvm_fuzz_fault(jcore, engine, monkeypatch)
    got = _uvm_fuzz_fault(tcore, engine, monkeypatch)
    assert want[0] == "UVM: all resident blocks pinned"
    assert got == want
    if engine == "scalar":   # the 363rd of 393 ops raises
        assert len(want[1]) == 363
