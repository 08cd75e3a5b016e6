"""The port's checkpoint (repro_torch.checkpoint), its msgpack codec, the
training supervisor (repro_torch.ft.supervisor) and the launch settings
against the JAX package: checkpoints cross both ways bit for bit, the
manifest bytes equal ``msgpack.packb``'s, and the supervisor's restart
and resume logs equal the reference's."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import msgpack  # noqa: E402

import repro.checkpoint as jckpt  # noqa: E402
import repro.ft as jft  # noqa: E402
import repro.launch.settings as jsettings  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
import repro_torch.checkpoint as tckpt  # noqa: E402
import repro_torch.ft as tft  # noqa: E402
import repro_torch.launch.settings as tsettings  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import _msgpack  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402

ARCHS = ("granite-3-2b", "falcon-mamba-7b", "seamless-m4t-medium")


def _state(arch):
    """(reference train state, the same as numpy) of the reduced ``arch``:
    params (bf16, and fp32 for Mamba) and an AdamW state whose moments
    and step are nonzero."""
    cfg = jget_reduced(arch)
    params = jinit_params(cfg, jax.random.PRNGKey(0))
    init, _ = jmake_optimizer(JOptConfig())
    opt = init(params)
    rng = np.random.default_rng(3)
    opt = {"m": jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
                x.shape), jnp.float32), opt["m"]),
           "v": jax.tree.map(lambda x: jnp.asarray(rng.random(x.shape),
                                                   jnp.float32), opt["v"]),
           "step": jnp.asarray(7, jnp.int32)}
    state = {"params": params, "opt": opt}
    return state, jax.tree.map(np.asarray, state)


def _bits(x):
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.uint16)
    return a


def _assert_bit_equal(got: dict, want: dict):
    g, w = dict(bridge.leaves(got)), dict(bridge.leaves(want))
    assert list(g) == list(w)
    for path in w:
        gb, wb = _bits(g[path]), _bits(w[path])
        assert gb.dtype == wb.dtype and gb.shape == wb.shape, path
        assert np.array_equal(gb, wb), path


@pytest.mark.parametrize("arch", ARCHS)
def test_port_save_reference_restore_is_bitwise(arch, tmp_path):
    jstate, tree = _state(arch)
    tstate = bridge.tree_from_numpy(tree, device="cpu")
    tckpt.save(str(tmp_path), 7, tstate)
    got = jckpt.restore(str(tmp_path), 7, jstate)
    _assert_bit_equal(jax.tree.map(np.asarray, got), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_save_port_restore_is_bitwise(arch, tmp_path):
    jstate, tree = _state(arch)
    jckpt.save(str(tmp_path), 7, jstate)
    like = bridge.tree_from_numpy(tree, device="cpu")
    got = tckpt.restore(str(tmp_path), 7, like)
    _assert_bit_equal(bridge.tree_to_numpy(got, ml_dtypes.bfloat16), tree)
    for path, x in bridge.leaves(got):
        assert x.dtype == dict(bridge.leaves(like))[path].dtype


@pytest.mark.parametrize("arch", ARCHS)
def test_manifest_and_layout_equal_the_reference(arch, tmp_path):
    """Same directory names, npz entries and manifest bytes."""
    jstate, tree = _state(arch)
    jckpt.save(str(tmp_path / "j"), 3, jstate)
    tckpt.save(str(tmp_path / "t"), 3, bridge.tree_from_numpy(tree, "cpu"))
    for side in ("j", "t"):
        assert os.listdir(tmp_path / side) == ["step_00000003"]
    jd, td = tmp_path / "j" / "step_00000003", tmp_path / "t" / "step_00000003"
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    assert (jd / "manifest.msgpack").read_bytes() == \
        (td / "manifest.msgpack").read_bytes()
    with np.load(jd / "shard0.npz") as a, np.load(td / "shard0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_restore_checks_shapes(tmp_path):
    tckpt.save(str(tmp_path), 1, {"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="checkpoint mismatch at w"):
        tckpt.restore(str(tmp_path), 1, {"w": torch.zeros(4, 3)})


def test_restore_casts_to_like_dtype(tmp_path):
    tckpt.save(str(tmp_path), 1, {"w": torch.arange(6.0).reshape(2, 3)})
    got = tckpt.restore(str(tmp_path), 1,
                        {"w": torch.zeros(2, 3, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].float(), torch.arange(6.0).reshape(2, 3))


def test_manager_retention_and_latest_equal_reference(tmp_path):
    """keep=2, every=2 over steps 1..7 (async saves): the same step
    directories survive, and ``latest_step`` and ``restore_latest``
    agree."""
    tree = {"a": np.arange(5, dtype=np.float32), "b": {"c": np.int32(3)}}
    jm = jckpt.CheckpointManager(str(tmp_path / "j"), keep=2, every=2)
    tm = tckpt.CheckpointManager(str(tmp_path / "t"), keep=2, every=2)
    for step in range(1, 8):
        saved_j = jm.maybe_save(step, jax.tree.map(jnp.asarray, tree))
        saved_t = tm.maybe_save(step, bridge.tree_from_numpy(tree, "cpu"))
        assert saved_j == saved_t == (step % 2 == 0)
    jm.wait()
    tm.wait()
    assert sorted(os.listdir(tmp_path / "j")) == \
        sorted(os.listdir(tmp_path / "t")) == ["step_00000004", "step_00000006"]
    assert tckpt.latest_step(str(tmp_path / "t")) == \
        jckpt.latest_step(str(tmp_path / "j")) == 6
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    step, got = tm.restore_latest(bridge.tree_from_numpy(tree, "cpu"))
    assert step == 6
    _assert_bit_equal(bridge.tree_to_numpy(got), tree)


# ------------------------------------------------------------------ msgpack

_VALUES = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
    2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
    -2 ** 31 - 1, -2 ** 63, True, False, None, "", "a", "x" * 31,
    "x" * 32, "y" * 255, "y" * 256, "z" * 65536, "périodes/l0 ✓",
    [], list(range(15)), list(range(16)), list(range(70000)),
    {}, {f"k{i}": i for i in range(15)}, {f"k{i}": i for i in range(16)},
    {"nested": {"a": [1, [2, {"b": None}]], "c": True}},
]


@pytest.mark.parametrize("value", _VALUES,
                         ids=[f"v{i}" for i in range(len(_VALUES))])
def test_msgpack_subset_matches_msgpack(value):
    want = msgpack.packb(value)
    assert _msgpack.packb(value) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_msgpack_manifest_bytes_equal(arch):
    _, tree = _state(arch)
    manifest = {p: {"idx": i, "shape": list(x.shape),
                    "dtype": "bfloat16" if x.dtype == ml_dtypes.bfloat16
                    else x.dtype.name}
                for i, (p, x) in enumerate(bridge.leaves(tree))}
    doc = {"step": 123456, "leaves": manifest, "shard": 0}
    assert _msgpack.packb(doc) == msgpack.packb(doc)
    assert _msgpack.unpackb(msgpack.packb(doc)) == doc


def test_msgpack_rejects_what_it_does_not_cover():
    with pytest.raises(TypeError):
        _msgpack.packb(1.5)
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb(1.5))
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb([1, 2])[:-1])


# --------------------------------------------------------------- supervisor

def _run_supervisor(ft, ckpt, root, make_state, fail_at, steps=6):
    """Run ``steps`` steps of x <- x + step + 1 under the package's
    supervisor, checkpoints every 2 steps, a failure injected once at each
    step of ``fail_at``; returns (final step, state as numpy, log)."""
    failed = set()

    def inject(step):
        if step in fail_at and step not in failed:
            failed.add(step)
            raise RuntimeError(f"injected at {step}")

    def step_fn(step, st):
        return {"x": st["x"] + (step + 1), "n": st["n"] + 1}

    sup = ft.TrainSupervisor(ckpt.CheckpointManager(root, keep=2, every=2))
    final, state = sup.run(make_state(), step_fn, steps,
                           failure_injector=inject)
    return final, {k: np.asarray(v) for k, v in state.items()}, sup.log, sup


@pytest.mark.parametrize("fail_at", [(), (3,), (1, 4), (0,)])
def test_supervisor_restart_log_equals_reference(fail_at, tmp_path):
    x0 = np.arange(4, dtype=np.float32)
    jf, js, jlog, jsup = _run_supervisor(
        jft, jckpt, str(tmp_path / "j"),
        lambda: {"x": jnp.asarray(x0), "n": jnp.asarray(0, jnp.int32)}, fail_at)
    tf, ts, tlog, tsup = _run_supervisor(
        tft, tckpt, str(tmp_path / "t"),
        lambda: {"x": torch.from_numpy(x0.copy()),
                 "n": torch.tensor(0, dtype=torch.int32)}, fail_at)
    assert tlog == jlog and tf == jf == 6
    assert tsup.restarts == jsup.restarts == len(fail_at)
    assert tsup.budget.backoff_s == jsup.budget.backoff_s
    for k in js:
        assert np.array_equal(ts[k], js[k]) and ts[k].dtype == js[k].dtype


def test_supervisor_resumes_from_the_latest_checkpoint(tmp_path):
    """A second run over the same root resumes where the first saved."""
    x0 = np.zeros(3, dtype=np.float32)
    logs = {}
    for name, ft, ckpt, make in (
            ("j", jft, jckpt, lambda: {"x": jnp.asarray(x0),
                                       "n": jnp.asarray(0, jnp.int32)}),
            ("t", tft, tckpt, lambda: {"x": torch.zeros(3),
                                       "n": torch.tensor(0, dtype=torch.int32)})):
        root = str(tmp_path / name)
        _run_supervisor(ft, ckpt, root, make, (), steps=4)
        final, state, log, _ = _run_supervisor(ft, ckpt, root, make, (5,),
                                               steps=8)
        logs[name] = (final, state, log)
    assert logs["t"][2] == logs["j"][2]
    assert logs["t"][2][0] == "resumed from step 4"
    assert logs["t"][0] == logs["j"][0] == 8
    for k in ("x", "n"):
        assert np.array_equal(logs["t"][1][k], logs["j"][1][k])


def test_supervisor_gives_up_after_its_budget(tmp_path):
    for ft, ckpt, root in ((jft, jckpt, tmp_path / "j"),
                           (tft, tckpt, tmp_path / "t")):
        sup = ft.TrainSupervisor(ckpt.CheckpointManager(str(root), every=10),
                                 max_restarts=2)

        def always(step):
            raise RuntimeError("down")
        with pytest.raises(RuntimeError, match="down"):
            sup.run({"x": np.zeros(1)}, lambda s, st: st, 3,
                    failure_injector=always)
        assert sup.restarts == 2


def test_straggler_monitor_and_remesh_equal_reference():
    times = [1.0, 1.1, 0.9, 5.0, 5.2, 4.9, 1.0]
    jm, tm = jft.StragglerMonitor(), tft.StragglerMonitor()
    for i, t in enumerate(times):
        for m in (jm, tm):
            m.record(0, 1.0)
            m.record(1, t)
            m.record(2, 1.0 + 0.01 * i)
        assert tm.flagged() == jm.flagged()
        assert tm.strikes == jm.strikes
    for shape, axes, lost, zero in (((4, 8, 2), ("pod", "data", "model"),
                                     (1,), True),
                                    ((3, 16), ("pod", "data"), (0, 2), False)):
        assert dataclasses.asdict(tft.plan_elastic_remesh(shape, axes, lost, zero)) \
            == dataclasses.asdict(jft.plan_elastic_remesh(shape, axes, lost, zero))
    with pytest.raises(ValueError):
        tft.plan_elastic_remesh((4,), ("data",), (0,), True)


def test_ft_exports_equal_reference():
    assert tft.__all__ == jft.__all__
    assert tckpt.__all__ == jckpt.__all__


# ----------------------------------------------------------------- settings

def test_settings_equal_reference():
    assert tsettings.SHAPES == jsettings.SHAPES
    assert tsettings.LONG_CONTEXT_ARCHS == jsettings.LONG_CONTEXT_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in
            tsettings.TRAIN_SETTINGS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jsettings.TRAIN_SETTINGS.items()}
    archs = list(jsettings.TRAIN_SETTINGS) + ["no-such-arch"]
    assert tsettings.cells(archs) == jsettings.cells(archs)
    for arch in archs:
        assert dataclasses.asdict(tsettings.settings_for(arch)) == \
            dataclasses.asdict(jsettings.settings_for(arch))
        for shape in tsettings.SHAPES:
            assert tsettings.cell_skipped(arch, shape) == \
                jsettings.cell_skipped(arch, shape)


def test_reduced_configs_checkpoint_like_their_params(tmp_path):
    """The port's own init round-trips through its checkpoint bit for
    bit, a tree of every leaf kind (bf16, fp32, int32 step)."""
    from repro_torch.optim import adamw_init
    cfg = get_reduced("falcon-mamba-7b")
    params = bridge.init_params(cfg, seed=1, device="cpu")
    state = {"params": params, "opt": adamw_init(params)}
    tckpt.save(str(tmp_path), 2, state)
    got = tckpt.restore(str(tmp_path), 2, state)
    for (p, a), (q, b) in zip(bridge.leaves(got), bridge.leaves(state)):
        assert p == q and a.dtype == b.dtype and torch.equal(a, b)
