"""The port's training path against the JAX package, on the CPU: the
optimizers (repro_torch.optim), the loss (cross_entropy,
chunked_cross_entropy, loss_fn), the grads of ``loss_fn`` on the reduced
configs of all ten archs, one ``make_train_step`` with 1 and 2
microbatches on gemma3-1b and on falcon-mamba-7b, the autograd Functions
of ``kernels/ops.py`` (the scan's against ``jax.vjp`` of the reference's
``mamba_scan_ref``) and the plain backward passes of flash attention and
the scan, the per-period recompute, and the train launcher. Inputs are
made with numpy from a seed and fed to both packages. falcon-mamba-7b runs
200 steps: past the reference's 128-step scan chunk and not a multiple of
it, so that its padded, masked tail runs.

Grads are held by ``tests/test_torch_mamba.py``'s rule: within 2e-2 of
``want`` relative to each element and to the largest |want| of the leaf
(rtol 2e-2, atol 2e-2 x max|want|); losses within 2e-2 relative. The
cross-attention gates of the VLM and the encoder-decoder are set to 0.5
on both sides: at init's 0 their layers, and the encoder, add nothing."""

import dataclasses
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.data import modality_stub as jmodality_stub  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
import repro.optim as joptim  # noqa: E402
import repro_torch.optim as toptim  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as tm  # noqa: E402

TOL = 2e-2
B, S = 2, 24
GATE = 0.5
# the ten archs, whose reduced configs train on the card too
ARCHS = ("gemma3-1b", "granite-3-2b", "chatglm3-6b", "granite-20b",
         "granite-moe-1b-a400m", "mixtral-8x7b", "llama-3.2-vision-11b",
         "seamless-m4t-medium", "falcon-mamba-7b", "jamba-1.5-large-398b")
# falcon-mamba-7b's sequence: past the reference's CHUNK (128) and not a
# multiple of it (repro/models/mamba.py pads and masks the tail)
SEQ = {"falcon-mamba-7b": 200}
# tests/test_torch_mamba.py's gains for a model's Mamba mixers, dt_bias 0
LOUD_MODEL = {"in_proj": 3.0, "conv_w": 3.0, "x_proj": 3.0, "out_proj": 1.0}
# archs whose grads are held in fp32 on both sides: the bf16 grads of the
# reduced jamba's Mamba mixers and norms (8 layers, FFNs after each) lie
# up to 3.9x the tolerance from the reference's own fp32 grads, in either
# package, while the two packages' fp32 grads agree within it everywhere
FP32_GRADS = ("jamba-1.5-large-398b",)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, what, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max(), err_msg=what)


def _with_gates(tree, cfg, value):
    """The numpy params tree with every cross-attention gate at ``value``."""
    if "cross" not in cfg.layer_pattern:
        return tree
    periods = dict(tree["periods"])
    for j, mixer in enumerate(cfg.layer_pattern):
        if mixer == "cross":
            lp = dict(periods[f"l{j}"])
            lp["gate"] = np.full(lp["gate"].shape, value, ml_dtypes.bfloat16)
            periods[f"l{j}"] = lp
    return dict(tree, periods=periods)


def _with_loud_mamba(tree, cfg):
    """The numpy params tree with ``LOUD_MODEL`` on every Mamba mixer of a
    model whose Mamba layers carry an FFN (jamba-1.5-large-398b's one
    period), dt_bias 0: at init such a layer adds almost nothing, and its
    mixer's grads (~1e-13) are fp32 rounding noise of the two packages'
    sums."""
    if not any(m == "mamba" and f != "none" for m, f in cfg.layer_kinds()):
        return tree
    periods = dict(tree["periods"])
    for j, mixer in enumerate(cfg.layer_pattern):
        if mixer == "mamba":
            lp = dict(periods[f"l{j}"])
            m = dict(lp["mixer"])
            for name, g in LOUD_MODEL.items():
                m[name] = (m[name].astype(np.float32) * g).astype(m[name].dtype)
            m["dt_bias"] = np.zeros_like(m["dt_bias"])
            periods[f"l{j}"] = dict(lp, mixer=m)
    return dict(tree, periods=periods)


def _setup(arch, batch=B, seq=S, fp32=False):
    """(cfg, jcfg, reference params, port params, tokens, labels, ctx as
    (reference, port) or None) for the reduced ``arch``, gates at GATE,
    Mamba mixers that precede an FFN at LOUD_MODEL; with ``fp32`` every
    leaf cast to fp32 on both sides."""
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    tree = _with_loud_mamba(_with_gates(jax.tree.map(np.asarray, jinit_params(
        jcfg, jax.random.PRNGKey(0))), cfg, GATE), cfg)
    params_t = bridge.params_from_numpy(tree, cfg, device="cpu")
    if fp32:
        tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
        params_t = bridge.tree_map(lambda x: x.float(), params_t)
    params_j = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, size=(batch, seq)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(batch, seq)).astype(np.int32)
    ctx = None
    if cfg.is_vlm or cfg.is_encdec:
        kind, T = (("image", cfg.image_tokens) if cfg.is_vlm
                   else ("frames", cfg.encoder_frames))
        cj = jnp.asarray(jmodality_stub(kind, batch, T, cfg.d_model, seed=2),
                         jnp.bfloat16)
        ct = torch.from_numpy(np.array(cj).view(np.int16)).view(torch.bfloat16)
        if fp32:
            cj, ct = cj.astype(jnp.float32), ct.float()
        ctx = (cj, ct)
    return cfg, jcfg, params_j, params_t, tokens, labels, ctx


# ---------------------------------------------------------------- optimizer

def _opt_tree(rng, dtype):
    """Leaves of every kind the optimizers treat apart: a scalar, a
    vector, a matrix (factored), a stacked (n, d) norm (decayed, not
    factored), and stacked matrices."""
    shapes = {"gate": (), "norm": (12,), "w": (16, 24),
              "periods": {"norm1": (3, 12), "w": (3, 8, 10)}}
    return bridge.tree_map(
        lambda s: (rng.standard_normal(s) * 0.5).astype(dtype), shapes)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_matches_reference(kind):
    """The same params, grads and state into both optimizers for 3 steps:
    params and every moment within 1e-6 relative (fp32 params; the
    reference's own leaf dtypes in the state)."""
    rng = np.random.default_rng(0)
    cfg = dict(kind=kind, lr=1e-2, warmup_steps=2, total_steps=5)
    jcfg, tcfg = joptim.OptConfig(**cfg), toptim.OptConfig(**cfg)
    jinit, jupd = joptim.make_optimizer(jcfg)
    tinit, tupd = toptim.make_optimizer(tcfg)
    params = _opt_tree(rng, np.float32)
    pj = jax.tree.map(jnp.asarray, params)
    pt = bridge.tree_from_numpy(params, "cpu")
    sj, st = jinit(pj), tinit(pt)
    for _ in range(3):
        grads = _opt_tree(rng, np.float32)
        pj, sj = jupd(jcfg, pj, jax.tree.map(jnp.asarray, grads), sj)
        pt, st = tupd(tcfg, pt, bridge.tree_from_numpy(grads, "cpu"), st)
        for name, got, want in [("params", pt, pj)] + [
                (k, st[k], sj[k]) for k in sj if k != "step"]:
            g = dict(bridge.leaves(bridge.tree_to_numpy(got, ml_dtypes.bfloat16)))
            w = dict(bridge.leaves(jax.tree.map(np.asarray, want)))
            assert list(g) == list(w)
            for path in w:
                assert g[path].dtype == w[path].dtype, (name, path)
                np.testing.assert_allclose(
                    g[path].astype(np.float64), w[path].astype(np.float64),
                    rtol=1e-6, atol=1e-6 * np.abs(w[path].astype(np.float64)
                                                  ).max(), err_msg=f"{name} {path}")
        assert int(st["step"]) == int(sj["step"])
        assert st["step"].dtype == torch.int32


def test_optimizer_leaves_its_inputs_alone():
    rng = np.random.default_rng(1)
    params = bridge.tree_from_numpy(_opt_tree(rng, np.float32), "cpu")
    grads = bridge.tree_from_numpy(_opt_tree(rng, np.float32), "cpu")
    before = bridge.tree_map(lambda x: x.clone(), params)
    for kind in ("adamw", "adafactor"):
        cfg = toptim.OptConfig(kind=kind)
        init, upd = toptim.make_optimizer(cfg)
        state = init(params)
        upd(cfg, params, grads, state)
        toptim.clip_by_global_norm(grads, 0.1)
        for (_, a), (_, b) in zip(bridge.leaves(params), bridge.leaves(before)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        toptim.make_optimizer(toptim.OptConfig(kind="sgd"))


@pytest.mark.parametrize("cfg", [dict(), dict(warmup_steps=3, total_steps=10),
                                 dict(warmup_steps=0, total_steps=1),
                                 dict(lr=1.0, min_lr_ratio=0.0)])
def test_cosine_schedule_matches_reference(cfg):
    jc, tc = joptim.OptConfig(**cfg), toptim.OptConfig(**cfg)
    for step in list(range(0, 14)) + [99, 100, 101, 5000, 10_000, 20_000]:
        np.testing.assert_allclose(
            float(toptim.cosine_schedule(tc, torch.tensor(step))),
            float(joptim.cosine_schedule(jc, step)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(2)
    grads = _opt_tree(rng, np.float32)
    grads["bf16"] = (rng.standard_normal((5, 7))).astype(ml_dtypes.bfloat16)
    gj, nj = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                        max_norm)
    gt, nt = toptim.clip_by_global_norm(bridge.tree_from_numpy(grads, "cpu"),
                                        max_norm)
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
    g = dict(bridge.leaves(bridge.tree_to_numpy(gt, ml_dtypes.bfloat16)))
    for path, w in bridge.leaves(jax.tree.map(np.asarray, gj)):
        assert g[path].dtype == w.dtype
        np.testing.assert_allclose(g[path].astype(np.float32),
                                   w.astype(np.float32), rtol=1e-6,
                                   atol=0 if w.dtype == np.float32 else 1e-2)


# --------------------------------------------------------------------- loss

def test_cross_entropy_and_grad_match_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    want, gwant = jax.value_and_grad(jsteps.cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels))
    x = torch.from_numpy(logits).requires_grad_()
    got = tsteps.cross_entropy(x, torch.from_numpy(labels))
    (g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(gwant), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("S_", [7, 512, 600, 1100])
@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_cross_entropy_matches_reference(S_, tied, dtype):
    """S below, at and past CE_CHUNK and not a multiple of it; tied
    ((V, d) head read transposed) and untied ((d, V)); a padded vocab (40
    wide, 37 real): the value and its grads for x and the head."""
    rng = np.random.default_rng(S_)
    d, V, vocab = 16, 40, 37
    x = rng.standard_normal((2, S_, d)).astype(np.float32)
    head = (rng.standard_normal((V, d) if tied else (d, V)) * 0.5
            ).astype(np.float32)
    labels = rng.integers(0, vocab, (2, S_)).astype(np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj, hj = jnp.asarray(x, jdt), jnp.asarray(head, jdt)
    want, (gx_w, gh_w) = jax.value_and_grad(
        lambda a, b: jsteps.chunked_cross_entropy(a, b, jnp.asarray(labels),
                                                  tied, vocab=vocab),
        argnums=(0, 1))(xj, hj)

    def torch_of(a):
        if dtype == "float32":
            return torch.from_numpy(np.asarray(a)).clone()
        return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
            torch.bfloat16)
    xt = torch_of(xj).requires_grad_()
    ht = torch_of(hj).requires_grad_()
    got = tsteps.chunked_cross_entropy(xt, ht, torch.from_numpy(labels), tied,
                                       vocab=vocab)
    gx, gh = torch.autograd.grad(got, (xt, ht))
    tol = 1e-5 if dtype == "float32" else TOL
    np.testing.assert_allclose(float(got), float(want), rtol=tol)
    assert gx.dtype == xt.dtype and gh.dtype == ht.dtype
    _close(gx, gx_w, "d x", tol)
    _close(gh, gh_w, "d head", tol)
    # the padded tail never scores: its head rows get no grad
    tail = gh[vocab:] if tied else gh[:, vocab:]
    assert float(tail.abs().max()) == 0.0
    with torch.no_grad():
        again = tsteps.chunked_cross_entropy(xt, ht, torch.from_numpy(labels),
                                             tied, vocab=vocab)
    assert torch.equal(again, got.detach())


def _port_routes(cfg, pt, toks, labs, monkeypatch):
    """The port's expert indices of each MoE layer in layer order, from a
    forward of its ``loss_fn`` without grad (no recompute)."""
    from repro_torch.models import moe as tmoe
    routes, route = [], tmoe.route

    def recording(p, cfg_, x, impl="auto"):
        gate, idx, probs = route(p, cfg_, x, impl)
        routes.append(idx.numpy().astype(np.int32))
        return gate, idx, probs
    monkeypatch.setattr(tmoe, "route", recording)
    with torch.no_grad():
        tsteps.loss_fn(pt, cfg, torch.from_numpy(toks), torch.from_numpy(labs),
                       None)
    monkeypatch.setattr(tmoe, "route", route)
    return routes


def _replay_in_reference(routes, monkeypatch):
    """The reference's MoE layers take ``routes``' experts in layer order,
    with gates from their own probabilities: ``jax.lax.top_k`` returns the
    recorded indices and the probabilities there. The periods are
    unrolled (``UNROLL_PERIODS``) and not rematerialised (the caller sets
    ``remat="none"``: ``jax.checkpoint`` would trace the period body once
    for every period), so that each layer calls its own top_k."""
    import repro.models.transformer as jtm
    calls = iter(routes)

    def replay(probs, k):
        idx = jnp.asarray(next(calls))
        assert idx.shape == (probs.shape[0], k)
        return jnp.take_along_axis(probs, idx, axis=-1), idx
    monkeypatch.setattr(jtm, "UNROLL_PERIODS", True)
    monkeypatch.setattr(jax.lax, "top_k", replay)


def _loss_and_grads(arch, monkeypatch, fp32=False):
    cfg, jcfg, pj, pt, toks, labs, ctx = _setup(arch, seq=SEQ.get(arch, S),
                                                 fp32=fp32)
    if cfg.n_experts:
        _replay_in_reference(_port_routes(cfg, pt, toks, labs, monkeypatch),
                             monkeypatch)
        jcfg = dataclasses.replace(jcfg, remat="none")
    lj, gj = jax.value_and_grad(jsteps.loss_fn)(
        pj, jcfg, jnp.asarray(toks), jnp.asarray(labs),
        None if ctx is None else ctx[0])
    lt, gt = tsteps.value_and_grad(pt, cfg, torch.from_numpy(toks),
                                   torch.from_numpy(labs),
                                   None if ctx is None else ctx[1])
    return (lj, gj), (lt, gt), pt


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, monkeypatch):
    """``value_and_grad`` of the port's ``loss_fn`` against
    ``jax.value_and_grad(loss_fn)``: the loss, and every leaf's grad in
    the leaf's dtype. MoE layers run the port's routing on both sides: at
    a near tie of the k-th and (k+1)-th router probability two correct
    runs that round differently pick other experts for a token (the
    reduced mixtral-8x7b and granite-moe-1b-a400m have such near ties on
    these inputs), and that token's grads then differ in every layer
    below. falcon-mamba-7b's A_log grad sums over every step and channel,
    where the two packages' scans round differently (within the
    tolerance). The archs of FP32_GRADS run in fp32 on both sides."""
    (lj, gj), (lt, gt), pt = _loss_and_grads(arch, monkeypatch,
                                             fp32=arch in FP32_GRADS)
    np.testing.assert_allclose(float(lt), float(lj), rtol=TOL)
    want = dict(bridge.leaves(jax.tree.map(np.asarray, gj)))
    got = dict(bridge.leaves(gt))
    assert list(got) == list(want)
    if any(p.endswith("/gate") for p in want):
        # a scalar gate's grad sums B x S x d products: the reference's
        # bf16 sum lands several % off its own fp32 value on the reduced
        # seamless-m4t-medium, beyond the tolerance, where the port's
        # stays within it; in fp32 the two packages agree. So the gates
        # are held against the reference's fp32 run.
        cfg, jcfg, pj, _, toks, labs, ctx = _setup(arch, fp32=True)
        g32 = jax.grad(jsteps.loss_fn)(pj, jcfg, jnp.asarray(toks),
                                       jnp.asarray(labs), ctx[0])
        want.update((p, w) for p, w in bridge.leaves(jax.tree.map(
            np.asarray, g32)) if p.endswith("/gate"))
    dtypes = dict(bridge.leaves(pt))
    for path, w in want.items():
        assert got[path].dtype == dtypes[path].dtype, path
        assert float(np.abs(_np(w)).max()) > 0, f"{path}: no grad to hold"
        _close(got[path], w, path)


def test_loss_fn_value_matches_reference_with_moe_aux():
    """loss_fn = CE + 0.01 aux: the MoE arch's aux is nonzero and part of
    the value on both sides."""
    cfg, jcfg, pj, pt, toks, labs, _ = _setup("granite-moe-1b-a400m")
    want = jsteps.loss_fn(pj, jcfg, jnp.asarray(toks), jnp.asarray(labs), None)
    got = tsteps.loss_fn(pt, cfg, torch.from_numpy(toks),
                         torch.from_numpy(labs), None)
    _, aux = tm.forward_hidden(pt, cfg, torch.from_numpy(toks))
    assert float(aux) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)


@pytest.mark.parametrize("arch", ["gemma3-1b", "llama-3.2-vision-11b"])
def test_forward_hidden_matches_reference(arch):
    cfg, jcfg, pj, pt, toks, _, ctx = _setup(arch)
    cj, ct = (None, None) if ctx is None else ctx
    want, aux_w = jforward(pj, jcfg, jnp.asarray(toks), ctx=cj,
                           return_hidden=True)
    got, aux = tm.forward_hidden(pt, cfg, torch.from_numpy(toks), ct)
    assert got.shape == (B, S, cfg.d_model) and got.dtype == torch.bfloat16
    _close(got, want, "hidden")
    np.testing.assert_allclose(float(aux), float(aux_w), atol=1e-6)


@pytest.mark.parametrize("arch", ["gemma3-1b", "mixtral-8x7b"])
def test_recompute_changes_no_bit(arch):
    """cfg.remat 'full' (each period under torch.utils.checkpoint) and
    'none' give the same loss and grads bit for bit on the CPU; gemma3-1b
    has remainder layers outside the periods, mixtral-8x7b MoE layers."""
    cfg, _, _, pt, toks, labs, _ = _setup(arch)
    assert cfg.remat == "full" and cfg.n_periods > 0
    out = {}
    for remat in ("full", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = tsteps.value_and_grad(pt, c, torch.from_numpy(toks),
                                           torch.from_numpy(labs), None)
    assert torch.equal(out["full"][0], out["none"][0])
    for (p, a), (_, b) in zip(bridge.leaves(out["full"][1]),
                              bridge.leaves(out["none"][1])):
        assert torch.equal(a, b), p


# --------------------------------------------------------------- train step

@pytest.mark.parametrize("arch, microbatches", [
    pytest.param("gemma3-1b", 1, id="1"), pytest.param("gemma3-1b", 2, id="2"),
    pytest.param("falcon-mamba-7b", 1, id="falcon-mamba-7b-1"),
    pytest.param("falcon-mamba-7b", 2, id="falcon-mamba-7b-2")])
def test_train_step_matches_reference(arch, microbatches):
    """One ``make_train_step`` (AdamW, warmup 1) on a reduced config in
    fp32 (every leaf cast on both sides, so that the update is held
    tightly): loss and grad norm within 1e-4 relative, every updated param
    within 1e-5 of the reference's but where a grad near 0 takes the other
    sign (Adam's first step moves a param by lr x sign(grad)): at most 1 in
    10 000 params, each within 2 lr; the returned state's step is 1, and
    the inputs are left as they were. gemma3-1b on 16 tokens a row,
    falcon-mamba-7b on 200 (``SEQ``)."""
    cfg, jcfg, pj, pt, _, _, _ = _setup(arch, fp32=True)
    rng = np.random.default_rng(5)
    seq = SEQ.get(arch, 16)
    toks = rng.integers(0, cfg.vocab, (4, seq)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab, (4, seq)).astype(np.int32)
    ocfg = dict(lr=3e-3, warmup_steps=1, total_steps=4)
    jstep = jsteps.make_train_step(jcfg, joptim.OptConfig(**ocfg),
                                   microbatches=microbatches)
    tstep = tsteps.make_train_step(cfg, toptim.OptConfig(**ocfg),
                                   microbatches=microbatches)
    pj2, sj2, mj = jstep(pj, joptim.adamw_init(pj),
                         {"tokens": jnp.asarray(toks),
                          "labels": jnp.asarray(labs)})
    before = bridge.tree_map(lambda x: x.clone(), pt)
    state = toptim.adamw_init(pt)
    pt2, st2, mt = tstep(pt, state, {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(labs)})
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]),
                               rtol=1e-4)
    assert int(st2["step"]) == 1 and int(state["step"]) == 0
    for (_, a), (_, b) in zip(bridge.leaves(pt), bridge.leaves(before)):
        assert torch.equal(a, b)
    want = dict(bridge.leaves(jax.tree.map(np.asarray, pj2)))
    flips = total = 0
    for path, p in bridge.leaves(pt2):
        err = np.abs(_np(p) - want[path])
        far = err > 1e-5
        assert (err[far] <= 2 * ocfg["lr"] * 1.001).all(), path
        flips += int(far.sum())
        total += err.size
    assert flips <= total // 10_000, (flips, total)


def test_train_step_microbatches_accumulate_in_bf16():
    """With microbatches > 1 the grads accumulate in the params' dtype:
    2 microbatches of a batch give the reference's loss and grad norm on
    the bf16 model within the bf16 tolerance."""
    cfg, jcfg, pj, pt, _, _, _ = _setup("granite-3-2b")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    ocfg = dict(warmup_steps=1, total_steps=4)
    _, _, mj = jsteps.make_train_step(jcfg, joptim.OptConfig(**ocfg), 2)(
        pj, joptim.adamw_init(pj), {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(labs)})
    _, _, mt = tsteps.make_train_step(cfg, toptim.OptConfig(**ocfg), 2)(
        pt, toptim.adamw_init(pt), {"tokens": torch.from_numpy(toks),
                                    "labels": torch.from_numpy(labs)})
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=TOL)
    np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]),
                               rtol=TOL)


# ------------------------------------------------------- autograd Functions

@pytest.mark.parametrize("b_transposed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["both", "a", "b"])
def test_matmul_function_grads_match_autograd_of_plain(b_transposed, dtype,
                                                       which):
    """``ops.matmul``'s Function (3-D A flattened into M) against torch
    autograd of ``matmul_ref``, with either operand or both needing a
    grad: the same bits (both take one fp32 product rounded once)."""
    g = torch.Generator().manual_seed(7)
    a0 = torch.randn(3, 5, 16, generator=g).to(dtype)
    b0 = torch.randn((24, 16) if b_transposed else (16, 24),
                     generator=g).to(dtype)
    dc = torch.randn(3, 5, 24, generator=g).to(dtype)
    a = a0.clone().requires_grad_(which in ("both", "a"))
    b = b0.clone().requires_grad_(which in ("both", "b"))
    out = ops.matmul(a, b, b_transposed=b_transposed)
    leaves_ = [x for x in (a, b) if x.requires_grad]
    got = torch.autograd.grad(out, leaves_, dc)
    a2 = a0.clone().requires_grad_(a.requires_grad)
    b2 = b0.clone().requires_grad_(b.requires_grad)
    want_out = ref.matmul_ref(a2.reshape(-1, 16), b2, b_transposed).reshape(
        3, 5, 24)
    want = torch.autograd.grad(want_out, [x for x in (a2, b2)
                                          if x.requires_grad], dc)
    assert torch.equal(out.detach(), want_out.detach())
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_matmul_function_only_when_a_grad_is_needed():
    a, b = torch.randn(4, 8), torch.randn(8, 3)
    assert ops.matmul(a, b).grad_fn is None
    with torch.no_grad():
        assert ops.matmul(a.requires_grad_(), b).grad_fn is None
    assert ops.matmul(a, b).grad_fn is not None


_FLASH = [  # (B, H, KV, S, T, D, causal, window)
    (2, 4, 2, 9, 9, 16, True, 0),
    (1, 4, 1, 12, 12, 8, True, 4),
    (2, 2, 2, 7, 11, 16, False, 0),
    (1, 6, 2, 13, 6, 8, True, 0),
    (1, 4, 2, 10, 15, 8, False, 5),
    (1, 2, 1, 8, 20, 16, True, 3),
]


def _flash_inputs(shape, dtype=torch.float32):
    B, H, KV, S, T, D, causal, window = shape
    g = torch.Generator().manual_seed(S * 31 + T)
    q = torch.randn(B, H, S, D, generator=g).to(dtype)
    k = torch.randn(B, KV, T, D, generator=g).to(dtype)
    v = torch.randn(B, KV, T, D, generator=g).to(dtype)
    do = torch.randn(B, H, S, D, generator=g).to(dtype)
    return q, k, v, do, causal, window


@pytest.mark.parametrize("shape", _FLASH, ids=[str(s) for s in _FLASH])
def test_flash_bwd_ref_and_lse_match_autograd(shape):
    """In fp32: ``flash_attention_ref``'s LSE against logsumexp of the
    masked scores, and ``flash_attention_bwd_ref`` against torch autograd
    of ``flash_attention_ref`` (GQA, windows, non-causal, S != T)."""
    q, k, v, do, causal, window = _flash_inputs(shape)
    scale = 0.37
    o, lse = ref.flash_attention_ref(q, k, v, causal, window, scale,
                                     return_lse=True)
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(H // KV, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q, kr) * scale
    mask = ref.attention_mask(S, T, causal, window)
    s = s.masked_fill(~mask, -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), rtol=1e-5,
                               atol=1e-5)
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(ref.flash_attention_ref(qa, ka, va, causal,
                                                       window, scale),
                               (qa, ka, va), do)
    got = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, window,
                                      scale)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", _FLASH[:3], ids=[str(s) for s in _FLASH[:3]])
def test_flash_function_on_cpu(shape):
    """``ops``' flash Function on CPU tensors (its forward with LSE, its
    backward through ``flash_attention_bwd``'s plain version) against
    torch autograd of the plain forward; bf16 in, grads in bf16."""
    q, k, v, do, causal, window = _flash_inputs(shape, torch.bfloat16)
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    out = ops._FlashAttention.apply(qa, ka, va, causal, window, None)
    got = torch.autograd.grad(out, (qa, ka, va), do)
    qb, kb, vb = (x.float().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(ref.flash_attention_ref(qb, kb, vb, causal,
                                                       window),
                               (qb, kb, vb), do.float())
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, v, causal,
                                                            window))
    for x, y in zip(got, want):
        assert x.dtype == torch.bfloat16
        _close(x, y, "flash grad")


_SCAN = [  # (Bt, S, D, N, x dtype)
    (2, 37, 24, 4, "f32"), (1, 200, 16, 16, "f32"), (3, 9, 8, 1, "f32"),
    (2, 150, 16, 4, "bf16"), (1, 33, 8, 16, "bf16"),
]


def _scan_case(case):
    """numpy inputs of a scan and a dy: dt = softplus(normal), A =
    -exp(0.3 normal), B, C, x, dy normal (x and dy rounded to bf16 for a
    bf16 case, in both packages)."""
    Bt, S, D, N, xd = case
    rng = np.random.default_rng(Bt * S + D + N)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, D)))).astype(np.float32)
    A = (-np.exp(0.3 * rng.standard_normal((D, N)))).astype(np.float32)
    B, C = (rng.standard_normal((Bt, S, N)).astype(np.float32)
            for _ in range(2))
    x, dy = (rng.standard_normal((Bt, S, D)).astype(np.float32)
             for _ in range(2))
    return (dt, A, B, C), x, dy, (jnp.bfloat16, torch.bfloat16) \
        if xd == "bf16" else (jnp.float32, torch.float32)


@pytest.mark.parametrize("case", _SCAN, ids=[str(c) for c in _SCAN])
def test_scan_function_on_cpu_matches_jax_vjp(case):
    """``ops``' scan Function on CPU tensors (the plain forward, its
    backward through ``mamba_scan_bwd_ref``) against ``jax.vjp`` of the
    reference's ``mamba_scan_ref``: y and every grad, in the operands'
    dtypes; ragged S, N of 1, 4 and 16, Bt > 1, x in fp32 and bf16. The
    fp32 grads within 1e-4 (one fp32 recurrence in another order); y and
    dx in bf16 within the bf16 tolerance."""
    f32s, x, dy, (jd, td) = _scan_case(case)
    y_j, vjp = jax.vjp(jref.mamba_scan_ref, *map(jnp.asarray, f32s),
                       jnp.asarray(x, jd))
    want = vjp(jnp.asarray(dy, jd))
    ins = [torch.from_numpy(a).requires_grad_() for a in f32s] \
        + [torch.from_numpy(x).to(td).requires_grad_()]
    y, h_last = ops._MambaScan.apply(*ins)
    got = torch.autograd.grad(y, ins, torch.from_numpy(dy).to(td))
    tol = TOL if td == torch.bfloat16 else 1e-4
    _close(y, y_j, "y", tol)
    assert h_last.shape == (case[0], case[2], case[3])
    for name, g, w, a in zip(("d_dt", "dA", "dB", "dC", "dx"), got, want,
                             ins):
        assert g.dtype == a.dtype, name
        _close(g, w, name, tol if g.dtype == torch.bfloat16 else 1e-4)


def test_scan_function_takes_the_grad_of_h_last():
    """A gradient on h_last reaches the Function's backward pass as
    dh_last: its grads equal torch autograd of the plain scan with both
    outputs used."""
    f32s, x, dy, _ = _scan_case((2, 40, 12, 4, "f32"))
    dh = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 12, 4)).astype(np.float32))
    grads = []
    for fn in (ops._MambaScan.apply, ref.mamba_scan_ref):
        ins = [torch.from_numpy(a).requires_grad_() for a in (*f32s, x)]
        y, h_last = fn(*ins)
        grads.append(torch.autograd.grad((y, h_last), ins,
                                         (torch.from_numpy(dy), dh)))
    for g, w in zip(*grads):
        _close(g, w, "grad", 1e-5)


def test_scan_takes_its_function_on_the_kernel_route(monkeypatch):
    """A kernel-route scan whose operands need a grad runs as
    ``ops._MambaScan``: the forward kernel once, the backward kernel once
    in the backward pass, grads as torch autograd of the plain scan gives
    them; without a grad, the forward kernel alone; on the plain path,
    plain autograd and no kernel. (No CUDA here: the dispatch is made to
    take the kernel route and both kernels are patched to their plain
    versions.)"""
    from repro_torch.kernels import mamba_scan as kscan
    calls = []
    monkeypatch.setattr(ops, "uses_kernel", lambda x, impl: impl != "torch")
    monkeypatch.setattr(kscan, "mamba_scan", lambda *a, **kw: calls.append(
        "fwd") or ref.mamba_scan_ref(*a))
    monkeypatch.setattr(kscan, "mamba_scan_bwd", lambda *a: calls.append(
        "bwd") or ref.mamba_scan_bwd_ref(*a[:7]))
    f32s, x, dy, _ = _scan_case((2, 21, 8, 4, "f32"))
    ins = [torch.from_numpy(a).requires_grad_() for a in (*f32s, x)]
    y, h_last = ops.mamba_scan(*ins)
    assert type(y.grad_fn).__name__ == "_MambaScanBackward"
    dh = torch.ones_like(h_last)
    got = torch.autograd.grad((y, h_last), ins, (torch.from_numpy(dy), dh))
    assert calls == ["fwd", "bwd"]
    ins2 = [t.detach().clone().requires_grad_() for t in ins]
    y2, h2 = ref.mamba_scan_ref(*ins2)
    want = torch.autograd.grad((y2, h2), ins2, (torch.from_numpy(dy), dh))
    for g, w in zip(got, want):
        _close(g, w, "grad", 1e-5)
    calls.clear()
    with torch.no_grad():
        ops.mamba_scan(*ins)
    assert calls == ["fwd"]
    calls.clear()
    y, _ = ops.mamba_scan(*ins, impl="torch")
    assert y.requires_grad and y.grad_fn is not None and not calls


def test_scan_function_in_the_loss_of_falcon_mamba(monkeypatch):
    """The reduced falcon-mamba-7b's loss and grads with every scan on the
    kernel route (no CUDA here: the dispatch takes the kernel route and the
    scan's two kernel wrappers, which take their plain versions on CPU
    tensors, are counted): a layer runs the scan's forward twice (the
    forward pass and the per-period recompute) and its backward once, as
    ``chip_smoke.train_counts`` expects on the card; the loss is the plain
    path's bit for bit and every grad within the file's rule."""
    from repro_torch.kernels import mamba_scan as kscan
    cfg, _, _, pt, toks, labs, _ = _setup("falcon-mamba-7b", seq=40)
    args = (torch.from_numpy(toks), torch.from_numpy(labs), None)
    want_loss, want = tsteps.value_and_grad(pt, cfg, *args, impl="torch")
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = kscan.mamba_scan, kscan.mamba_scan_bwd

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(ops, "uses_kernel", lambda x, impl: impl != "torch")
    monkeypatch.setattr(kscan, "mamba_scan", counted("fwd", fwd))
    monkeypatch.setattr(kscan, "mamba_scan_bwd", counted("bwd", bwd))
    loss, got = tsteps.value_and_grad(pt, cfg, *args, impl="auto")
    assert calls == {"fwd": 2 * cfg.n_layers, "bwd": cfg.n_layers}
    assert torch.equal(loss, want_loss)
    want = dict(bridge.leaves(want))
    for path, g in bridge.leaves(got):
        assert g.dtype == want[path].dtype, path
        _close(g, want[path], path)


# ----------------------------------------------------------------- launcher

def test_train_launcher_runs_and_resumes_on_cpu(tmp_path, capsys):
    args = ["--reduced", "--steps", "4", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt", str(tmp_path)]
    ttrain.main(args)
    first = capsys.readouterr().out
    assert "done: 4 steps" in first and "resumed" not in first
    ttrain.main(args)
    second = capsys.readouterr().out
    assert "resumed from step 4" in second
    digest = [ln for ln in first.splitlines() if ln.startswith("state sha256")]
    assert digest and digest[0] in second


def test_train_launcher_trains_a_vlm_with_its_context(tmp_path, capsys):
    ttrain.main(["--arch", "llama-3.2-vision-11b", "--reduced", "--steps",
                 "2", "--batch", "2", "--seq", "8", "--device", "cpu",
                 "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=llama-3.2-vision-11b" in out and "done: 2 steps" in out


def test_train_launcher_trains_falcon_mamba_on_cpu(tmp_path, capsys):
    """The launcher takes falcon-mamba-7b (its Mamba layers through the
    scan's Function on the card, the plain scan here)."""
    ttrain.main(["--arch", "falcon-mamba-7b", "--reduced", "--steps", "2",
                 "--batch", "2", "--seq", "20", "--device", "cpu",
                 "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=falcon-mamba-7b" in out and "done: 2 steps" in out
    assert latest_step(str(tmp_path)) == 2


def test_train_launcher_defaults_to_cuda(monkeypatch):
    """Without ``--device`` it asks for CUDA, and raises where there is
    none rather than moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--reduced", "--steps", "1"])


def test_train_launcher_checkpoints_under_tmpdir_by_default(tmp_path,
                                                            monkeypatch,
                                                            capsys):
    """Without ``--ckpt`` the checkpoints go under the temporary directory
    the environment names (``TMPDIR``), never a fixed path another checkout
    would share."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ttrain.main(["--reduced", "--steps", "2", "--batch", "2", "--seq", "8",
                 "--device", "cpu"])
    assert "done: 2 steps" in capsys.readouterr().out
    assert latest_step(str(tmp_path / "repro_torch_train_ckpt")) == 2
