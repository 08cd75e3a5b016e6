"""The port's jamba-1.5-large-398b against the JAX package, on the CPU: its
Mamba layers followed by an MLP or a MoE FFN, its one attention layer a
period, the params crossing, the caches and the serve launcher.

Two layouts of the reduced config (d_model 64, d_inner 128, 4 experts):
``period``, its own 8 layers, one period stacked under ``periods/l<j>``;
``cut5``, the same config cut to its first 5 layers, every layer unrolled
under ``remainder/r0..r4`` — the layout the card serves at full width
(``chip_smoke.py``), where r0 is (mamba, mlp), r1 (mamba, moe) and r4
(attn, mlp). Both packages take the same numpy params: the port's own
seeded init (``bridge.init_params``) as numpy, through
``bridge.params_from_numpy`` on the port's side. The MoE capacity factor
is 8 on both sides, so that no token drops (``test_arch_smoke.py:86``):
capacity depends on the tokens of a call, so forward and decode would
drop different ones.

Tolerance 2e-2, the repo's bf16 model tolerance, relative to each tensor
as ``tests/test_torch_mamba.py`` takes it: rtol 2e-2 and atol 2e-2 x
max|want|. Every comparison also runs on ``LOUD_MODEL`` params (gains on
every Mamba mixer, dt_bias 0): at init a Mamba layer leaves the logits
unchanged within any tolerance. ``test_loud_params_move_the_logits``
shows that the loud copy's logits differ from the init's beyond the
tolerance, and that the forward check fails with the Mamba layers
skipped."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.optim as joptim  # noqa: E402
import repro_torch.optim as toptim  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.svm import tree_leaf_sizes  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.settings import settings_for  # noqa: E402
from repro_torch.models import transformer as tm  # noqa: E402

ARCH = "jamba-1.5-large-398b"
TOL = 2e-2
B, S = 2, 16
CUT = 5           # the card's depth cut: the first layer of each kind
LAYOUTS = {"period": 8, "cut5": CUT}
# tests/test_torch_mamba.py's gains for a model's Mamba mixers, dt_bias 0
LOUD_MODEL = {"in_proj": 3.0, "conv_w": 3.0, "x_proj": 3.0, "out_proj": 1.0}


def _cfgs(layout):
    """(port config, reference config) of the reduced jamba at the
    layout's depth, capacity factor 8."""
    kw = dict(n_layers=LAYOUTS[layout], capacity_factor=8.0)
    return (dataclasses.replace(get_reduced(ARCH), **kw),
            dataclasses.replace(jget_reduced(ARCH), **kw))


def _mamba_mixers(tree, cfg):
    """The mixer subtrees of every Mamba layer of a params tree."""
    pat = cfg.layer_pattern
    out = [tree["periods"][f"l{j}"]["mixer"] for j in range(len(pat))
           if cfg.n_periods and pat[j] == "mamba"]
    base = cfg.n_periods * len(pat)
    return out + [tree["remainder"][f"r{i}"]["mixer"]
                  for i in range(cfg.n_remainder)
                  if pat[(base + i) % len(pat)] == "mamba"]


def _loud(tree, cfg):
    """A copy of the numpy params with LOUD_MODEL on every Mamba mixer."""
    tree = bridge.tree_map(np.copy, tree)
    for mixer in _mamba_mixers(tree, cfg):
        for name, g in LOUD_MODEL.items():
            mixer[name] = (mixer[name].astype(np.float32) * g
                           ).astype(mixer[name].dtype)
        mixer["dt_bias"] = np.zeros_like(mixer["dt_bias"])
    return tree


def _replaying(fn):
    """``fn`` jit-compiled with a leading argument ``routes``: every
    ``jax.lax.top_k`` call of its trace answers, in order, with the next
    recorded expert indices and the router probabilities there."""
    def run(routes, *args):
        calls, top_k = iter(routes), jax.lax.top_k

        def replay(probs, k):
            idx = next(calls)
            assert idx.shape == (probs.shape[0], k)
            return jnp.take_along_axis(probs, idx, axis=-1), idx
        jax.lax.top_k = replay
        try:
            return fn(*args)
        finally:
            jax.lax.top_k = top_k
    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _reference(layout):
    """The reference's forward, prefill (S-wide cache) and decode step,
    each taking the port's routing first (``_replaying``), jit-compiled
    once a layout. Its one period is not rematerialised, so that each MoE
    layer traces one top_k."""
    _, jcfg = _cfgs(layout)
    jcfg = dataclasses.replace(jcfg, remat="none")
    return (_replaying(lambda p, t: jforward(p, jcfg, t)),
            _replaying(lambda p, t: jprefill(p, jcfg, t, cache_len=S)),
            _replaying(lambda p, t, c: jdecode_step(p, jcfg, t, c)))


def _routed(fn, *args):
    """(fn(*args), the expert indices of each of its MoE layers in layer
    order): the port's routing, which the reference then replays. At a
    near tie of the k-th and (k+1)-th router probability two correct runs
    that round differently pick other experts for a token (the port's
    init has such ties on these inputs), and the token's whole layer
    differs; the gates stay each side's own."""
    routes, route = [], tm.moe_lib.route

    def recording(p, cfg_, x, impl="auto"):
        gate, idx, probs = route(p, cfg_, x, impl)
        routes.append(jnp.asarray(idx.numpy().astype(np.int32)))
        return gate, idx, probs
    tm.moe_lib.route = recording
    try:
        return fn(*args), tuple(routes)
    finally:
        tm.moe_lib.route = route


@functools.lru_cache(maxsize=None)
def _model(layout, loud):
    """(cfg, numpy tree, reference params, port params, tokens)."""
    cfg, _ = _cfgs(layout)
    tree = bridge.params_to_numpy(bridge.init_params(cfg, seed=0,
                                                     device="cpu"),
                                  bf16_dtype=ml_dtypes.bfloat16)
    if loud:
        tree = _loud(tree, cfg)
    params_t = bridge.params_from_numpy(tree, cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)
    return cfg, tree, jax.tree.map(jnp.asarray, tree), params_t, tokens


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max(), err_msg=what)


def _check_caches(got, want, what):
    """Every leaf of a decode cache: the same paths, shapes and dtypes;
    ``t`` and the K/V slots' positions equal, the rest within TOL."""
    want = dict(bridge.leaves(jax.tree.map(np.asarray, want)))
    got = dict(bridge.leaves(got))
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        g = got[path]
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
        if path == "t" or path.endswith("/pos"):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
        else:
            _close(g, w, f"{what} {path}")


def test_configs_and_the_cut_layout():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(get_reduced(ARCH)) == \
        dataclasses.asdict(jget_reduced(ARCH))
    cfg, _ = _cfgs("cut5")
    assert (cfg.n_periods, cfg.n_remainder) == (0, CUT)
    assert cfg.layer_kinds() == [("mamba", "mlp"), ("mamba", "moe"),
                                 ("mamba", "mlp"), ("mamba", "moe"),
                                 ("attn", "mlp")]
    # the card's cut: 48.09 GB of bf16 weights at full width
    full = dataclasses.replace(get_config(ARCH), n_layers=CUT)
    nbytes = sum(int(np.prod(s)) * 2 for _, (s, _) in
                 bridge.leaves(bridge.param_shapes(full)))
    assert nbytes == 2 * full.param_count()
    assert round(nbytes / 1e9, 2) == 48.09


@pytest.mark.parametrize("layout", LAYOUTS)
def test_params_cross_bit_for_bit(layout):
    """The port's tree has the reference's paths, shapes and dtypes, at
    the reduced size and at full width (``jax.eval_shape``: no
    allocation); the numpy params cross both ways bit for bit, and
    ``leaf_sizes`` equals ``tree_leaf_sizes``."""
    cfg, jcfg = _cfgs(layout)
    for c, jc in ((cfg, jcfg), (dataclasses.replace(get_config(ARCH),
                                                    n_layers=cfg.n_layers),
                                dataclasses.replace(jget_config(ARCH),
                                                    n_layers=cfg.n_layers))):
        want = jax.eval_shape(lambda: jinit_params(jc, jax.random.PRNGKey(0)))
        assert [(p, tuple(s), str(dt).replace("torch.", "")) for p, (s, dt)
                in bridge.leaves(bridge.param_shapes(c))] == \
            [(p, tuple(x.shape), str(x.dtype)) for p, x in bridge.leaves(want)]
    _, tree, params_j, params_t, _ = _model(layout, False)
    back = bridge.params_to_numpy(params_t, bf16_dtype=ml_dtypes.bfloat16)
    want, got = dict(bridge.leaves(tree)), dict(bridge.leaves(back))
    assert list(got) == list(want)
    for path, a in want.items():
        assert got[path].dtype == a.dtype, path
        np.testing.assert_array_equal(got[path].view(np.uint8),
                                      a.view(np.uint8), err_msg=path)
    assert bridge.leaf_sizes(params_t) == tree_leaf_sizes(params_j)


@pytest.mark.parametrize("loud", [False, True], ids=["init", "loud"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_forward_matches_reference(layout, loud):
    """Logits and the MoE aux loss (the mean over MoE layers of the
    Switch loss)."""
    cfg, _, params_j, params_t, tokens = _model(layout, loud)
    (got, aux), routes = _routed(tm.forward_with_aux, params_t, cfg,
                                 torch.from_numpy(tokens))
    want, aux_j = _reference(layout)[0](routes, params_j, tokens)
    assert got.shape == (B, S, cfg.padded_vocab) and got.dtype == torch.bfloat16
    _close(got, want, "logits")
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=TOL)


@pytest.mark.parametrize("loud", [False, True], ids=["init", "loud"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefill_decode_and_caches_match_reference(layout, loud):
    """Prefill S-2 tokens into an S-wide cache, then decode the last two
    teacher-forced: each step's logits against the reference's and the
    port's forward, and the whole cache (Mamba ``h`` and ``conv``, the
    attention layer's K/V and positions, ``t``) against the reference's
    after the prefill and after each step. The reference's decode step
    starts from the port's cache: on the loud params bf16 rounding
    differences grow through the layers (the last Mamba layer's ``h`` is
    2.5 % apart in relative L2 after one step from the two prefills), and
    the steps would compound them."""
    cfg, _, params_j, params_t, tokens = _model(layout, loud)
    _, jpre, jdec = _reference(layout)
    toks = torch.from_numpy(tokens)
    full = _np(tm.forward(params_t, cfg, toks))
    (pre, cache), routes = _routed(tm.prefill, params_t, cfg,
                                   toks[:, : S - 2], None, S)
    lj, cj = jpre(routes, params_j, tokens[:, : S - 2])
    _close(pre, lj, "prefill logits")
    _close(pre[:, -1], full[:, S - 3], "prefill against forward")
    _check_caches(cache, cj, "prefill")
    for t in (S - 2, S - 1):
        # a copy: the port's step writes its cache in place
        start = jax.tree.map(lambda a: jnp.asarray(np.copy(a)),
                             bridge.tree_to_numpy(cache, ml_dtypes.bfloat16))
        (logits, cache), routes = _routed(tm.decode_step, params_t, cfg,
                                          toks[:, t: t + 1], cache)
        lj, cj = jdec(routes, params_j, tokens[:, t: t + 1], start)
        _close(logits, lj, f"decode {t}")
        _close(logits[:, 0], full[:, t], f"decode {t} against forward")
        _check_caches(cache, cj, f"decode {t}")
    assert cache["t"].tolist() == [S, S]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_init_cache_matches_reference_layout(layout):
    cfg, jcfg = _cfgs(layout)
    want = jinit_cache(jcfg, 3, 12)
    got = tm.init_cache(cfg, 3, 12)
    flat_w = {p: (tuple(x.shape), str(x.dtype))
              for p, x in bridge.leaves(jax.tree.map(np.asarray, want))}
    flat_g = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
              for p, x in bridge.leaves(got)}
    assert flat_g == flat_w
    assert {p.rsplit("/", 1)[-1] for p in flat_g} == {"t", "h", "conv", "k",
                                                      "v", "pos"}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_loud_params_move_the_logits(layout, monkeypatch):
    """The loud copy's logits differ from the init's beyond the
    tolerance, and with the Mamba layers skipped (their output zeroed)
    the forward check fails on the loud copy."""
    cfg, _, params_j, params_t, tokens = _model(layout, True)
    toks = torch.from_numpy(tokens)
    loud, routes = _routed(tm.forward, params_t, cfg, toks)
    plain = tm.forward(_model(layout, False)[3], cfg, toks)
    with pytest.raises(AssertionError):
        _close(loud, plain, "loud against init")
    want, _ = _reference(layout)[0](routes, params_j, tokens)
    _close(loud, want, "logits")
    monkeypatch.setattr(tm.mamba_lib, "mamba_forward",
                        lambda p, cfg, x, **kw: (torch.zeros_like(x), {}))
    with pytest.raises(AssertionError):
        _close(tm.forward(params_t, cfg, toks), want, "logits, Mamba skipped")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_adafactor_train_step_matches_reference(layout):
    """One ``make_train_step`` with jamba's TrainSettings (adafactor, 4
    microbatches) on 4 x 16 tokens, every leaf cast to fp32 on both sides
    so that the update is held tightly (as
    ``tests/test_torch_train.py::test_train_step_matches_reference``): loss
    and grad norm within 1e-4 relative, every updated param within 1e-5 of
    the reference's but where a grad near 0 takes the other sign. An
    unfactored leaf (a vector, or ``A_log`` with 4 columns) moves by lr x
    (1 - b1) / sqrt(1 - b2) x sign(grad) on the first step: at most 1 in
    10 000 params, each within twice that. The returned state's step is
    1, and the inputs are left as they were."""
    cfg, jcfg = _cfgs(layout)
    st = settings_for(ARCH)
    assert (st.optimizer, st.microbatches) == ("adafactor", 4)
    _, tree, _, _, _ = _model(layout, False)
    tree = bridge.tree_map(lambda a: a.astype(np.float32), tree)
    pj = jax.tree.map(jnp.asarray, tree)
    pt = bridge.tree_from_numpy(tree, "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (4, S)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab, (4, S)).astype(np.int32)
    ocfg = dict(kind=st.optimizer, lr=3e-3, warmup_steps=1, total_steps=4)
    jo, to = joptim.OptConfig(**ocfg), toptim.OptConfig(**ocfg)
    pj2, _, mj = jax.jit(jsteps.make_train_step(jcfg, jo, st.microbatches))(
        pj, joptim.make_optimizer(jo)[0](pj),
        {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)})
    before = bridge.tree_map(lambda x: x.clone(), pt)
    state = toptim.make_optimizer(to)[0](pt)
    pt2, st2, mt = tsteps.make_train_step(cfg, to, st.microbatches)(
        pt, state, {"tokens": torch.from_numpy(toks),
                    "labels": torch.from_numpy(labs)})
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]),
                               rtol=1e-4)
    assert int(st2["step"]) == 1 and int(state["step"]) == 0
    for (_, a), (_, b) in zip(bridge.leaves(pt), bridge.leaves(before)):
        assert torch.equal(a, b)
    want = dict(bridge.leaves(jax.tree.map(np.asarray, pj2)))
    flip = 2 * to.lr * (1 - to.b1) / (1 - to.b2) ** 0.5 * 1.001
    flips = total = 0
    for path, p in bridge.leaves(pt2):
        err = np.abs(_np(p) - want[path])
        far = err > 1e-5
        assert (err[far] <= flip).all(), path
        flips += int(far.sum())
        total += err.size
    assert flips <= total // 10_000, (flips, total)


def test_serve_launcher_runs_jamba_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "4", "--decode", "3"])
    out = capsys.readouterr().out
    assert "decoded 3 tokens" in out and "on cpu" in out


def test_train_launcher_trains_jamba_on_cpu(tmp_path, capsys):
    """The train launcher takes jamba (adafactor, its TrainSettings) and
    resumes it from its checkpoint with the same state."""
    args = ["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "8", "--device", "cpu", "--ckpt", str(tmp_path)]
    ttrain.main(args)
    first = capsys.readouterr().out
    assert f"arch={ARCH}" in first and "done: 2 steps" in first
    ttrain.main(args)
    second = capsys.readouterr().out
    assert "resumed from step 2" in second
    digest = [ln for ln in first.splitlines() if ln.startswith("state sha256")]
    assert digest and digest[0] in second
