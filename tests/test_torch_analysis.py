"""The port's svmlint (``repro_torch.analysis``) against the JAX package's
``repro.analysis``: the same rules give the same findings, with the scoped
rules keyed on ``repro_torch`` where the reference's are keyed on
``repro``; the port's tree lints clean; seeded violations in the port's
runtime layer are found."""

import os
import subprocess
import sys

import numpy as np
import pytest

from repro import analysis as janalysis
from repro_torch import analysis as tanalysis
from repro_torch.core import MB, AddressSpace, SVMManager, TraceSession

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")

DRIVE = "def f(mgr):\n    mgr.touch(3)\n"
ALIASED = """
def f(self):
    m = self.mgr
    m.advance(1e-3)
    return m._lru
"""
UNPAIRED = """
def attribute(sess, mgr, seg):
    before = mgr.n_migrations
    sess.replay(seg)
    return before
"""
CLOCK = "import time\n\ndef f():\n    return time.perf_counter()\n"
RNG = "import numpy as np\n\ndef f():\n    return np.random.rand(3)\n"
SET_ITER = "def f(xs):\n    for x in set(xs):\n        print(x)\n"
FROZEN = "def f(ct):\n    ct.codes[3] = 7\n    ct.rids.sort()\n"
RETRY = """
def f(job):
    while True:
        try:
            return job()
        except OSError:
            pass
"""
DISPATCH = """
def execute(op, mgr):
    if op == OP_TOUCH:
        return 1
    elif op == OP_COMPUTE:
        return 2
"""
HOT_LOOP = """
def execute_all(ct, mgr):
    for rid in ct.trid_np:
        mgr_touch(rid)
"""
BARE = "def f():\n    return 1  # svmlint: disable=determinism\n"
SNIPPETS = dict(drive=DRIVE, aliased=ALIASED, unpaired=UNPAIRED, clock=CLOCK,
                rng=RNG, set_iter=SET_ITER, frozen=FROZEN, retry=RETRY,
                dispatch=DISPATCH, hot_loop=HOT_LOOP, bare=BARE)
# (package path under src/<top>/, file name): every scope some rule keys on
PLACES = [("svm", "fixture.py"), ("launch", "fixture.py"),
          ("core", "fixture.py"), ("core", "engine.py"),
          ("analysis", "fixture.py"), ("data", "fixture.py")]


def _shape(findings):
    return [(f.rule, f.line, f.col) for f in findings]


def test_registry_equals_reference():
    assert sorted(tanalysis.RULES) == sorted(janalysis.RULES)
    for name, rule in tanalysis.RULES.items():
        ref = janalysis.RULES[name]
        assert rule.scope == tuple(s.replace("repro.", "repro_torch.", 1)
                                   for s in ref.scope)
    assert tanalysis.opcode_universe() == janalysis.opcode_universe()
    assert tanalysis.MANAGER_DRIVE == janalysis.MANAGER_DRIVE
    assert tanalysis.ATTRIBUTION_COUNTERS == janalysis.ATTRIBUTION_COUNTERS
    assert tanalysis.COLUMN_FIELDS == janalysis.COLUMN_FIELDS


@pytest.mark.parametrize("place", PLACES, ids=["/".join(p) for p in PLACES])
@pytest.mark.parametrize("snippet", sorted(SNIPPETS))
def test_findings_equal_reference_in_every_scope(snippet, place):
    """A snippet placed at src/repro_torch/<pkg>/<file> draws the findings
    the reference draws for it at src/repro/<pkg>/<file>."""
    pkg, name = place
    src = SNIPPETS[snippet]
    got = tanalysis.lint_source(src, f"src/repro_torch/{pkg}/{name}")
    want = janalysis.lint_source(src, f"src/repro/{pkg}/{name}")
    assert _shape(got) == _shape(want)


@pytest.mark.parametrize("pkg", ["svm", "launch"])
def test_seeded_manager_drive_in_the_port_is_found(pkg):
    """An op-by-op ``mgr.touch`` in the port's runtime layer is a
    finding of the port's lint; the reference's scopes never reach it."""
    path = f"src/repro_torch/{pkg}/fixture.py"
    found = tanalysis.lint_source(DRIVE, path)
    assert [f.rule for f in found] == ["manager-encapsulation"]
    assert janalysis.lint_source(DRIVE, path) == []


@pytest.mark.parametrize("pkg", ["core", "data", "kernels"])
def test_manager_drive_outside_the_runtime_layer_passes(pkg):
    assert tanalysis.lint_source(DRIVE,
                                 f"src/repro_torch/{pkg}/fixture.py") == []


def _executor_source():
    with open(os.path.join(PORT, "svm", "executor.py"),
              encoding="utf-8") as f:
        return f.read()


def test_seeded_violations_in_the_executor_are_found():
    """The executor's own source with its touches driven op by op, and
    with an unpaired counter read around a replay."""
    path = os.path.join(PORT, "svm", "executor.py")
    src = _executor_source()
    assert tanalysis.lint_source(src, path) == []
    drive = src.replace(
        "            self.session.touch(rid, concurrency=self.concurrency)",
        "            self.mgr.touch(rid, concurrency=self.concurrency)")
    assert drive != src
    assert [f.rule for f in tanalysis.lint_source(drive, path)] == \
        ["manager-encapsulation"]
    unpaired = src.replace(
        "        self.overlap_hidden_s += min(self.mgr.wall - w0, overlap_s)",
        "        self.overlap_hidden_s += overlap_s")
    assert unpaired != src
    assert [f.rule for f in tanalysis.lint_source(unpaired, path)] == \
        ["counter-pairing"]


def test_wall_clock_is_scoped_to_the_simulation_layers():
    for pkg, flagged in (("svm", True), ("core", True), ("analysis", True),
                         ("launch", False), ("kernels", False)):
        found = tanalysis.lint_source(CLOCK, f"src/repro_torch/{pkg}/x.py")
        assert bool(found) == flagged, pkg


def test_the_port_lints_clean():
    assert tanalysis.lint_paths([PORT]) == []


def test_cli_lints_the_port_clean_and_finds_a_seeded_violation(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.analysis"]
    res = subprocess.run(cmd + [PORT], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert f"svmlint: 0 findings ({len(tanalysis.RULES)} rules)" in res.stdout
    seeded = tmp_path / "repro_torch" / "svm" / "fixture.py"
    seeded.parent.mkdir(parents=True)
    seeded.write_text(DRIVE)
    res = subprocess.run(cmd + [str(seeded)], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 1
    assert "[manager-encapsulation]" in res.stdout
    res = subprocess.run(cmd + ["--rules", "no-such-rule"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 2


def test_runtime_frozen_audit_on_the_ports_traces():
    space = AddressSpace(64 * MB, alignment=2 * MB)
    for i in range(8):
        space.alloc(2 * MB, f"a{i}")
    sess = TraceSession(SVMManager(space, profile=False))
    for rid in range(6):
        sess.touch(rid, concurrency=8)
    sess.compute(1e-4)
    ct = sess.seal()
    tanalysis.assert_frozen(ct, "sealed segment")
    tanalysis.assert_frozen(ct.concat([ct, ct]), "concat")
    assert tanalysis.frozen_violations(ct) == \
        janalysis.frozen_violations(ct) == []

    class Thawed:
        pass

    bad = Thawed()
    for field in tanalysis.COLUMN_FIELDS:
        setattr(bad, field, np.zeros(2))
    assert tanalysis.frozen_violations(bad) == \
        janalysis.frozen_violations(bad)
    with pytest.raises(AssertionError, match="frozen-column audit"):
        tanalysis.assert_frozen(bad)
