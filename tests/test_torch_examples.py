"""The port's package surface and examples against the JAX package's, on
the CPU: ``repro_torch.data`` (``MemmapTokens``, ``batch_iterator``) and
``repro_torch.models``' exports; each example of ``examples/torch/`` run
with ``--device cpu`` beside the reference's ``examples/``, their SVM
accounting equal with ``==``; and the streamed serving that
``chip_smoke.py`` runs with mixtral-8x7b at full depth on the card, here
at its reduced config: streamed prefill and decode bit-equal to the
resident ``prefill`` and ``decode_step``, in either placement, with
``metrics()`` equal to a replay of the same accounting.

The reference's examples run on the reference's own rates, so the port's
examples here get them too (the port's defaults are the H100 preset's).
The quickstart starts both from the reference's init, which crosses with
``bridge.params_from_numpy``."""

import contextlib
import dataclasses
import functools
import importlib.util
import io
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

import repro.data as jdata  # noqa: E402
import repro.models as jmodels  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
import repro_torch.models as tmodels  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import svm as tsvm  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's rates (repro/core/costmodel.py: TPU_V5E_HOST and
# CostParams.serve_flops), given to the port's examples
REF_LINK = tcore.CostParams(link_bw=32e9)
REF_RATE = 197e12 * 0.4
LOSS_TOL = 2e-2


# ---------------------------------------------------------------- data

def _corpus(tmp_path, n=1003, vocab=500):
    path = tmp_path / "toks.bin"
    np.random.default_rng(7).integers(0, vocab, n, dtype=np.int32).tofile(path)
    return str(path)


@pytest.mark.parametrize("host,num_hosts", [(0, 1), (0, 2), (1, 2)])
def test_memmap_tokens_epochs_equal_reference(tmp_path, host, num_hosts):
    path = _corpus(tmp_path)
    kw = dict(host=host, num_hosts=num_hosts, seed=3)
    got = tdata.MemmapTokens(path, 16, **kw)
    want = jdata.MemmapTokens(path, 16, **kw)
    assert got.n_seqs == want.n_seqs == (1003 - 1) // 16
    for epoch in (0, 1):
        g, w = list(got.epoch(epoch)), list(want.epoch(epoch))
        assert len(g) == len(w) > 0
        for a, b in zip(g, w):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert np.array_equal(a[k], b[k])
    # two epochs shuffle differently
    assert not all(np.array_equal(a["tokens"], b["tokens"]) for a, b in
                   zip(got.epoch(0), got.epoch(1)))


@pytest.mark.parametrize("host,start", [(0, 0), (1, 5)])
def test_batch_iterator_equals_reference(host, start):
    got = tdata.batch_iterator(tdata.SyntheticLM(vocab=300, seed=2), 3, 8,
                               host=host, start_step=start)
    want = jdata.batch_iterator(jdata.SyntheticLM(vocab=300, seed=2), 3, 8,
                                host=host, start_step=start)
    for _ in range(4):
        a, b = next(got), next(want)
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
                   for k in a)


@pytest.mark.parametrize("mods", [(tdata, jdata), (tmodels, jmodels)],
                         ids=["data", "models"])
def test_exports_equal_reference(mods):
    port, ref = mods
    assert port.__all__ == ref.__all__
    for name in port.__all__:
        obj = getattr(port, name)
        if callable(obj):
            assert obj.__module__.startswith("repro_torch."), (name, obj)
    if port is tmodels:
        assert all(getattr(port, k) == getattr(ref, k) for k in
                   ("ATTN", "ATTN_LOCAL", "CROSS", "MAMBA", "MLP", "MOE",
                    "NONE"))
        assert port.init_params is bridge.init_params


def test_models_import_makes_no_cycle():
    import subprocess

    for first in ("repro_torch.models", "repro_torch.bridge",
                  "repro_torch.launch.serve"):
        # the config modules load without torch (test_torch_core.py), and
        # they import models.config, so this package must too
        code = (f"import sys, {first}\n"
                f"assert ('torch' in sys.modules) == "
                f"({first!r} != 'repro_torch.models')\n"
                f"from repro_torch.models import *\n"
                f"import repro_torch.models as m\n"
                f"assert m.init_params.__module__ == 'repro_torch.bridge'\n"
                f"assert m.forward.__module__ == "
                f"'repro_torch.models.transformer'\n")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        res = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr


# ------------------------------------------------------------ examples

def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name: str):
    return _load(os.path.join(ROOT, "examples", "torch", f"{name}.py"),
                 f"torch_example_{name}")


def _ref(name: str):
    return _load(os.path.join(ROOT, "examples", f"{name}.py"),
                 f"ref_example_{name}")


def _stdout(fn, *args) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


@functools.lru_cache(maxsize=None)
def _ref_lines(name: str, scale: bool = False) -> tuple:
    mod = _ref(name)
    return tuple(_stdout(mod.scale if scale else mod.main))


def test_serve_streaming_accounting_equals_reference(monkeypatch):
    port = _port("serve_streaming")
    monkeypatch.setattr(port, "StreamingExecutor", functools.partial(
        tsvm.StreamingExecutor, cost_params=REF_LINK, compute_rate=REF_RATE))
    got = _stdout(port.main, ["--device", "cpu"])
    want = list(_ref_lines("serve_streaming"))
    # the weights, the four placements' wall, migrations, evictions and
    # session counts, and the best placement
    assert len(got) == 6 and got == want


@pytest.mark.parametrize("scale", [False, True], ids=["tour", "scale"])
def test_serve_multitenant_accounting_equals_reference(monkeypatch, scale):
    port = _port("serve_multitenant")
    monkeypatch.setattr(port, "PoolScheduler", functools.partial(
        tsvm.PoolScheduler, cost_params=REF_LINK, compute_rate=REF_RATE))
    got = _stdout(port.main, ["--device", "cpu"] + (["--scale"] if scale
                                                    else []))
    want = list(_ref_lines("serve_multitenant", scale))
    if scale:   # the host's seconds of the fused and per-token tiers
        timed = [i for i, ln in enumerate(want) if "fused " in ln
                 and "per-token" in ln]
        assert len(timed) == 1 and "byte-identical: True" in got[timed[0]]
        got, want = ([ln for i, ln in enumerate(x) if i not in timed]
                     for x in (got, want))
    assert len(got) > 3 and got == want


class _Stop(Exception):
    pass


def test_train_oversubscribed_offload_schedule_equals_reference(
        monkeypatch, tmp_path):
    """The port's example trains 2 steps on the CPU; the reference's is
    stopped at its init, after it has printed its offload schedule. (One
    row over the examples' 2 microbatches cannot split: the reference's
    reshape raises, so does the port's train step.)"""
    argv = ["--steps", "2", "--batch", "2", "--seq", "32"]
    ref = _ref("train_oversubscribed")

    def stop(*_a, **_k):
        raise _Stop

    monkeypatch.setattr(ref, "init_params", stop)
    monkeypatch.setattr(sys, "argv", ["train_oversubscribed.py"] + argv
                        + ["--ckpt", str(tmp_path / "ref")])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(_Stop):
        ref.main()
    want = buf.getvalue().splitlines()

    port = _port("train_oversubscribed")
    monkeypatch.setattr(port, "simulate_offload", functools.partial(
        tsvm.simulate_offload, params=REF_LINK))
    got = _stdout(port.main, argv + ["--device", "cpu", "--ckpt",
                                     str(tmp_path / "port")])
    assert len(want) == 2 and want[1].startswith("offload schedule")
    assert got[:2] == want
    assert got[-1].startswith("finished 2 steps") and "nan" not in got[-1]
    with pytest.raises(ValueError, match="microbatches"):
        port.main(["--steps", "1", "--batch", "1", "--seq", "32",
                   "--device", "cpu", "--ckpt", str(tmp_path / "one")])


def test_quickstart_losses_follow_reference(monkeypatch):
    want = list(_ref_lines("quickstart"))
    port = _port("quickstart")
    cfg = get_reduced("granite-3-2b")

    def ref_init(c, seed=0, device=None):   # the reference's PRNGKey(0)
        jc = dataclasses.replace(jget_reduced(c.name), n_layers=c.n_layers)
        pj = jmodels.init_params(jc, jax.random.PRNGKey(seed))
        return bridge.params_from_numpy(jax.tree.map(np.asarray, pj), c,
                                        device)

    monkeypatch.setattr(port, "init_params", ref_init)
    got = _stdout(port.main, ["--device", "cpu"])
    assert got[0] == want[0]           # the model line
    losses = {}
    for lines, side in ((got, "port"), (want, "ref")):
        losses[side] = {int(ln.split()[1]): float(ln.split("loss=")[1].split()[0])
                        for ln in lines if ln.startswith("step")}
    assert sorted(losses["port"]) == sorted(losses["ref"]) == [0, 10, 20, 29]
    for step in (0, 10):
        a, b = losses["port"][step], losses["ref"][step]
        assert abs(a - b) <= LOSS_TOL * abs(b), (step, a, b)
    ids = [ln for ln in got if ln.startswith("decoded continuation ids:")]
    assert len(ids) == 1
    toks = eval(ids[0].split(":", 1)[1])   # noqa: S307 - a printed int list
    assert len(toks) == 9 and all(0 <= t < cfg.vocab for t in toks)


# --------------------------------------- streamed serving (chip_smoke)

@functools.lru_cache(maxsize=None)
def _smoke():
    return _load(os.path.join(ROOT, "chip_smoke.py"), "chip_smoke_module")


STREAM_LAYERS, STREAM_DECODE, STREAM_B, STREAM_S = 4, 3, 2, 12


@functools.lru_cache(maxsize=None)
def _stream_setup():
    cs = _smoke()
    cfg = cs.unstacked(get_reduced("mixtral-8x7b"), STREAM_LAYERS)
    host, blocks, sums = cs.host_params(cfg, "cpu", pin=False)
    toks = serve.prompts(cfg, STREAM_B, STREAM_S, "cpu")
    total = sum(x.numel() * x.element_size()
                for _, x in bridge.leaves(host))
    return cs, cfg, host, blocks, sums, toks, int(total * 0.6)


def test_stream_host_params_are_init_params_unstacked():
    cs, cfg, host, blocks, sums, _, _ = _stream_setup()
    assert cfg.n_periods == 0 and cfg.n_remainder == STREAM_LAYERS
    want = bridge.init_params(cfg, seed=0, device="cpu")
    got, ref = dict(bridge.leaves(host)), dict(bridge.leaves(want))
    assert got.keys() == ref.keys()
    assert all(torch.equal(got[p], ref[p]) and got[p].dtype == ref[p].dtype
               for p in ref)
    assert sums == cs.param_sums(want) == cs.host_sums(host, "cpu")
    # every leaf a view of a block, in order, none past its block's end
    assert all(b.numel() & (b.numel() - 1) == 0 for b in blocks)
    paths = cs.stream_layer_paths(cfg)
    flat = [p for g in paths for p in g]
    assert len(flat) == len(set(flat)) and set(flat) == set(ref)
    assert len(paths) == STREAM_LAYERS + 2
    assert paths[0] == ["embed"] and paths[-1] == ["final_norm", "lm_head"]


@pytest.mark.parametrize("sizes,cap", [([100, 200, 300], 1024),
                                       ([700, 700, 5000, 3], 1024),
                                       ([1000] * 9 + [90] * 7, 4096)])
def test_host_blocks_pack_leaves_apart_within_powers_of_two(sizes, cap):
    bsizes, where = _smoke().host_blocks(sizes, cap)
    assert all(n & (n - 1) == 0 for n in bsizes)
    assert max(bsizes) <= max(cap, 1 << (max(sizes) - 1).bit_length())
    spans = sorted((b, off, off + n) for n, (b, off) in zip(sizes, where))
    for (b0, _, e0), (b1, o1, _) in zip(spans, spans[1:]):
        assert b0 != b1 or e0 <= o1
    assert all(off % 512 == 0 and off + n <= bsizes[b]
               for n, (b, off) in zip(sizes, where))


def test_host_blocks_hold_mixtral_in_11_blocks_of_8_gib():
    import math

    from repro_torch.configs import get_config

    cs = _smoke()
    cfg = cs.unstacked(get_config("mixtral-8x7b"), 32)
    sizes = [math.prod(s) * dt.itemsize
             for _, (s, dt) in bridge.leaves(bridge.param_shapes(cfg))]
    bsizes, _ = cs.host_blocks(sizes)
    assert sum(sizes) == 93_405_585_408
    assert bsizes == [8 << 30] * 11


@functools.lru_cache(maxsize=None)
def _streamed(policy: str):
    cs, cfg, host, _, _, toks, budget = _stream_setup()
    with torch.inference_mode():
        return cs.stream_run(cfg, host, toks, STREAM_DECODE, budget,
                             cs.STREAM_POLICIES[policy], "cpu")


@pytest.mark.parametrize("policy", ["naive", "svm_aware"])
def test_streamed_serving_equals_resident_bit_for_bit(policy):
    cs, cfg, host, _, sums, toks, budget = _stream_setup()
    r = _streamed(policy)
    with torch.inference_mode():
        logits, out = cs.resident_run(cfg, host, toks, STREAM_DECODE)
    assert len(r["logits"]) == len(logits) == STREAM_DECODE + 1
    assert logits[0].shape == (STREAM_B, 1, cfg.padded_vocab)
    assert cs.same_bits(r["logits"], logits) and cs.same_bits(r["tokens"], out)
    # the pool kept to its budget, the leaves moved, the params stayed
    assert 0 < r["max_pool_bytes"] <= budget == r["budget"]
    assert r["prefill"]["h2d_bytes"] > 0 and r["decode"]["h2d_bytes"] > 0
    assert r["prefill"]["migrations"] > 0 and r["decode"]["migrations"] > 0
    assert len(r["flops"]) == STREAM_DECODE + 1
    assert r["flops"][0] == cs.stream_flops(cfg, STREAM_B, STREAM_S)["prefill"]
    assert cs.host_sums(host, "cpu") == sums


def test_streamed_policies_agree_and_replay_equals_metrics():
    cs, cfg, host, _, _, toks, budget = _stream_setup()
    a, b = _streamed("naive"), _streamed("svm_aware")
    assert cs.same_bits(a["logits"], b["logits"])
    assert cs.same_bits(a["tokens"], b["tokens"])
    assert a["metrics"] != b["metrics"]   # the placements differ
    for r, policy in ((a, "naive"), (b, "svm_aware")):
        ex = tsvm.StreamingExecutor(host, budget, device="cpu",
                                    **cs.STREAM_POLICIES[policy])
        for f in r["flops"]:
            ex.decode_step(cs.stream_layer_paths(cfg), f, materialize=False)
        assert ex.metrics() == r["metrics"]


def test_first_layers_stream_like_their_resident_cut():
    cs, cfg, host, _, _, toks, _ = _stream_setup()
    full = get_reduced("mixtral-8x7b")
    cut = cs.unstacked(full, 2)
    host_cut = cs.first_layers(host, 2)
    nbytes = sum(x.numel() * x.element_size()
                 for _, x in bridge.leaves(host_cut))
    with torch.inference_mode():
        s = cs.stream_run(cut, host_cut, toks, 2, int(nbytes * 0.6), {}, "cpu")
        logits, out = cs.resident_run(cut, host_cut, toks, 2)
    assert cs.same_bits(s["logits"], logits) and cs.same_bits(s["tokens"], out)
    # and they are not the whole model's
    assert not cs.same_bits(s["logits"], _streamed("naive")["logits"][:3])


def test_stream_flops_count_the_kernels_products():
    cs = _smoke()
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity

    cfg = cs.unstacked(get_config("mixtral-8x7b"), 32)
    f = cs.stream_flops(cfg, 4, 1024)
    d, f_, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    attn = 2 * d * (cfg.n_heads * hd) * 2 + 2 * 2 * d * cfg.n_kv_heads * hd
    experts = 2 * capacity(cfg, 4096) * 3 * d * f_ * cfg.n_experts
    router = 2 * 4096 * d * cfg.n_experts
    core = 4 * hd * (1024 * 1025 // 2) * 4 * cfg.n_heads
    assert f["prefill"][1] == pytest.approx(4096 * attn + router + experts
                                            + core, rel=1e-12)
    assert f["decode"][1] == pytest.approx(
        4 * attn + 2 * 4 * d * cfg.n_experts
        + 2 * capacity(cfg, 4) * 3 * d * f_ * cfg.n_experts, rel=1e-12)
    assert f["prefill"][0] == f["decode"][0] == 0.0
    assert f["prefill"][-1] == f["decode"][-1] == 2 * 4 * d * cfg.padded_vocab
    assert len(f["decode"]) == cfg.n_layers + 2


def test_example_losses_read_every_printed_loss():
    """chip_smoke compares these, card against CPU, for the two examples
    that train: quickstart's step lines, train_oversubscribed's step lines
    and its last line's first and last loss."""
    cs = _smoke()
    quick = ["model: granite-3-2b reduced (0.18M params)",
             "step   0  loss=6.2013  gnorm=3.248",
             "step  29  loss=4.7401  gnorm=2.041",
             "decoded continuation ids: [1, 1]"]
    train = ["offload schedule (DOS=267%): naive replay 16 migs/3.25ms",
             "  step    0 loss=10.5848",
             "finished 3 steps in 1.1s (2792 tok/s); loss 10.585 -> 10.301"]
    assert cs.example_losses(quick) == [6.2013, 4.7401]
    assert cs.example_losses(train) == [10.5848, 10.585, 10.301]
    assert cs.example_losses(["weights 5.0MB, device budget 2.7MB"]) == []
