"""The port's Mamba path (repro_torch.models.mamba and the Mamba layers of
repro_torch.models.transformer) against the JAX package on the reduced
falcon-mamba-7b (4 layers, d_model 64, d_inner 128, ssm_state 4), with the
reference's params crossed by the bridge: the block's prefill output, its
scan output before the gate and its state (including a prompt shorter than
the conv), its decode step, forward logits, prefill + decode against
forward, the serve steps, the cache layout, the config, and the port's own
init.

Tolerance 2e-2, the repo's bf16 model tolerance (test_arch_smoke), taken
relative to each tensor: rtol 2e-2 and atol 2e-2 x max|want|. At the
reference's init a block's output is ~3e-4 and its SSM state ~1e-6, so an
absolute 2e-2 would pass a block that returns zeros. For the same reason
every comparison also runs on louder params, whose Mamba layers dominate
what they feed (``LOUD_BLOCK`` gives a scan output and state of order 1,
``LOUD_MODEL`` a residual stream that a skipped layer changes by several
tolerances); ``test_checks_catch_a_broken_block`` shows that a zeroed or
10%-off scan, or skipped Mamba layers, fail them. The reference scans
associatively within 128-step chunks and the port sequentially, which
differ in fp32 rounding only."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.svm import tree_leaf_sizes  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import transformer as tm  # noqa: E402

ARCH = "falcon-mamba-7b"
TOL = 2e-2
MARGIN = 4e-2   # greedy tokens must agree where the reference's top-2 gap exceeds this
B, S = 2, 16
# gains on the reference's init, and dt_bias 0 (dt ~ softplus(N(0,1)) ~ 0.7
# instead of 0.01): LOUD_BLOCK puts the scan's y and h at O(1-10) and y
# above the D skip; LOUD_MODEL keeps 4 such layers within the bf16
# tolerance of each other while each still moves the logits
LOUD_BLOCK = {"in_proj": 10.0, "conv_w": 5.0, "x_proj": 5.0, "out_proj": 5.0}
LOUD_MODEL = {"in_proj": 3.0, "conv_w": 3.0, "x_proj": 3.0, "out_proj": 1.0}


def _crossed(gains=None):
    """The reference's params (seed 0), scaled by ``gains`` per mixer leaf
    (dt_bias then 0), in both packages."""
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    tree = jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(0)))
    if gains:
        mixer = tree["periods"]["l0"]["mixer"]
        for name, g in gains.items():
            mixer[name] = (mixer[name].astype(np.float32) * g
                           ).astype(mixer[name].dtype)
        mixer["dt_bias"] = np.zeros_like(mixer["dt_bias"])
    params_j = jax.tree.map(jnp.asarray, tree)
    params_t = bridge.params_from_numpy(tree, cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)
    return cfg, jcfg, params_j, tree, params_t, tokens


@pytest.fixture(scope="module")
def model():
    return _crossed()


@pytest.fixture(scope="module")
def loud_block():
    return _crossed(LOUD_BLOCK)


@pytest.fixture(scope="module")
def loud_model():
    return _crossed(LOUD_MODEL)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, what):
    """Within 2e-2 of ``want`` relative to each element and to the largest
    |want| of the tensor."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max(), err_msg=what)


def _layer0(model):
    """The mixer params of layer 0, in both packages."""
    _, _, params_j, _, params_t, _ = model
    pj = jax.tree.map(lambda a: a[0], params_j["periods"]["l0"]["mixer"])
    pt = tm._period_slice(params_t["periods"]["l0"]["mixer"], 0)
    return pj, pt


def _hidden(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _scan_before_gate_ref(pj, jcfg, xj):
    """The reference block's scan output y (before + xc D and the gate), in
    x's dtype, from its own pieces; one chunk, as its loop runs for
    S <= CHUNK."""
    assert xj.shape[1] <= jmamba.CHUNK
    x_in = jnp.split(xj @ pj["in_proj"], 2, axis=-1)[0]
    xc = jax.nn.silu(jmamba._causal_conv(x_in, pj["conv_w"], pj["conv_b"]))
    dt, B_ssm, C_ssm = jmamba._ssm_inputs(pj, jcfg, xc)
    a = jnp.exp(dt[..., None] * -jnp.exp(pj["A_log"]))
    b = (dt * xc.astype(jnp.float32))[..., None] * B_ssm[:, :, None, :]
    h_all, _ = jmamba._scan_chunk(a, b, jnp.zeros_like(b[:, 0]))
    return jnp.einsum("bldn,bln->bld", h_all, C_ssm).astype(xj.dtype)


def _check_block(model, seq, monkeypatch):
    """The block's scan output before the gate, its output and its prefill
    state (h, conv tail) against the reference's; at 2 tokens the conv
    tail is the pre-conv input front-padded with a zero row."""
    cfg, jcfg = model[0], model[1]
    pj, pt = _layer0(model)
    xj, xt = _hidden(2, (B, seq, cfg.d_model))
    seen, scan = [], ops.mamba_scan

    def spy(*args, **kw):
        seen.append(scan(*args, **kw))
        return seen[-1]
    monkeypatch.setattr(ops, "mamba_scan", spy)
    out_j, st_j = jmamba.mamba_forward(pj, jcfg, xj, return_state=True)
    out_t, st_t = tmamba.mamba_forward(pt, cfg, xt, return_state=True)
    assert len(seen) == 1
    _close(seen[0][0], _scan_before_gate_ref(pj, jcfg, xj), "y before gate")
    assert out_t.shape == (B, seq, cfg.d_model) and out_t.dtype == torch.bfloat16
    _close(out_t, out_j, "block output")
    assert st_t["h"].dtype == torch.float32 and st_t["conv"].dtype == torch.bfloat16
    _close(st_t["h"], st_j["h"], "h")
    _close(st_t["conv"], st_j["conv"], "conv tail")
    if seq < cfg.ssm_conv - 1:
        assert float(st_t["conv"][:, : cfg.ssm_conv - 1 - seq].abs().max()) == 0
    np.testing.assert_array_equal(
        _np(tmamba.mamba_forward(pt, cfg, xt)), _np(out_t))


def _check_forward(model):
    cfg, jcfg, params_j, _, params_t, tokens = model
    want, _ = jforward(params_j, jcfg, tokens)
    got = tm.forward(params_t, cfg, torch.from_numpy(tokens))
    assert got.shape == (B, S, cfg.padded_vocab) and got.dtype == torch.bfloat16
    _close(got, want, "logits")


def test_config_matches_reference():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(get_reduced(ARCH)) == \
        dataclasses.asdict(jget_reduced(ARCH))
    # jamba-1.5-large-398b, whose Mamba layers carry an MLP or a MoE FFN
    assert dataclasses.asdict(get_config("jamba-1.5-large-398b")) == \
        dataclasses.asdict(jget_config("jamba-1.5-large-398b"))
    assert dataclasses.asdict(get_reduced("jamba-1.5-large-398b")) == \
        dataclasses.asdict(jget_reduced("jamba-1.5-large-398b"))


@pytest.mark.parametrize("seq", [16, 2])
def test_mamba_forward_and_state_match_reference(model, loud_block, seq,
                                                 monkeypatch):
    for m in (model, loud_block):
        _check_block(m, seq, monkeypatch)
        monkeypatch.undo()


def test_mamba_decode_step_matches_reference(model, loud_block):
    """Three decode steps from a prefill state, each package on its own
    cache: output, h and the conv ring buffer."""
    for m in (model, loud_block):
        cfg, jcfg = m[0], m[1]
        pj, pt = _layer0(m)
        xj, xt = _hidden(3, (B, 5, cfg.d_model))
        _, cj = jmamba.mamba_forward(pj, jcfg, xj, return_state=True)
        _, ct = tmamba.mamba_forward(pt, cfg, xt, return_state=True)
        for step in range(3):
            yj, yt = _hidden(10 + step, (B, 1, cfg.d_model))
            out_j, cj = jmamba.mamba_decode_step(pj, jcfg, yj, cj)
            out_t, ct = tmamba.mamba_decode_step(pt, cfg, yt, ct)
            assert out_t.shape == (B, 1, cfg.d_model)
            _close(out_t, out_j, f"decode output, step {step}")
            _close(ct["h"], cj["h"], f"h, step {step}")
            _close(ct["conv"], cj["conv"], f"conv, step {step}")


@pytest.mark.parametrize("fault", ["zero y", "y 10% off", "zero h",
                                   "skip layers"])
def test_checks_catch_a_broken_block(loud_block, loud_model, fault,
                                     monkeypatch):
    """The comparisons above fail on a scan that returns zeros or is 10%
    off, and the forward check fails with the Mamba layers skipped."""
    if fault == "skip layers":
        monkeypatch.setattr(tm.mamba_lib, "mamba_forward",
                            lambda p, cfg, x, **kw: torch.zeros_like(x))
        with pytest.raises(AssertionError):
            _check_forward(loud_model)
        return
    scan = ops.mamba_scan

    def broken(*args, **kw):
        y, h = scan(*args, **kw)
        if fault == "zero h":
            return y, torch.zeros_like(h)
        return (torch.zeros_like(y) if fault == "zero y" else y * 1.1), h
    monkeypatch.setattr(ops, "mamba_scan", broken)
    with pytest.raises(AssertionError):
        _check_block(loud_block, S, monkeypatch)


def test_softplus_has_no_threshold():
    """jax.nn.softplus is log(1 + e^x) everywhere; F.softplus switches to x
    above 20. The port's agrees with the reference past that point too."""
    x = np.array([-30.0, -4.6, 0.0, 19.0, 25.0, 80.0], np.float32)
    np.testing.assert_allclose(
        _np(tmamba._softplus(torch.from_numpy(x))),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=0)


def test_forward_logits_match_reference(model, loud_model):
    for m in (model, loud_model):
        _check_forward(m)


def test_prefill_decode_matches_forward(model, loud_model):
    """Port of test_arch_smoke.py:79 for falcon-mamba: prefill S-2 tokens,
    decode the last two teacher-forced; each step's logits match the
    port's forward and the reference's (the SSM state hand-off)."""
    for m in (model, loud_model):
        cfg, jcfg, params_j, _, params_t, tokens = m
        toks = torch.from_numpy(tokens)
        full = _np(tm.forward(params_t, cfg, toks))
        full_j, _ = jforward(params_j, jcfg, tokens)
        _close(full, full_j, "forward")
        pre, cache = tm.prefill(params_t, cfg, toks[:, : S - 2], cache_len=S)
        _close(pre[:, -1], full[:, S - 3], "prefill")
        h_before = cache["periods"]["l0"]["h"]
        logits_a, cache = tm.decode_step(params_t, cfg, toks[:, S - 2: S - 1],
                                         cache)
        _close(logits_a[:, 0], full[:, S - 2], "decode 1")
        logits_b, cache = tm.decode_step(params_t, cfg, toks[:, S - 1: S],
                                         cache)
        _close(logits_b[:, 0], full[:, S - 1], "decode 2")
        assert cache["periods"]["l0"]["h"] is h_before   # written in place
        assert cache["t"].tolist() == [S, S]


def test_serve_steps_match_reference_past_prompt_len(model, loud_model):
    """make_prefill_step / make_serve_step against the reference's, then
    decode_step teacher-forced on the reference's tokens well past
    prompt_len (the SSM state has no width to wrap)."""
    prompt, decode = 3, 8
    for m in (model, loud_model):
        cfg, jcfg, params_j, _, params_t, _ = m
        prompts = serve.prompts(cfg, B, prompt, "cpu")
        lj, cj = jax.jit(jsteps.make_prefill_step(jcfg))(
            params_j, jnp.asarray(prompts.numpy()))
        lt, ct = steps.make_prefill_step(cfg)(params_t, prompts)
        assert lt.shape == lj.shape == (B, 1, cfg.padded_vocab)
        _close(lt, lj, "prefill step")
        ref_serve = jax.jit(jsteps.make_serve_step(jcfg))
        ref_decode = jax.jit(lambda p, t, c: jdecode_step(p, jcfg, t, c))
        port_serve = steps.make_serve_step(cfg)
        tok_j = jnp.argmax(lj[:, -1], axis=-1).astype(jnp.int32)[:, None]
        for step in range(decode):
            tok_t = torch.tensor(np.asarray(tok_j))
            ids_j, _ = ref_serve(params_j, tok_j, cj)
            # the port's step writes its cache in place: give it a copy
            ids_t, _ = port_serve(params_t, tok_t,
                                  bridge.tree_map(torch.clone, ct))
            logits_j, cj = ref_decode(params_j, tok_j, cj)
            logits_t, ct = tm.decode_step(params_t, cfg, tok_t, ct)
            _close(logits_t, logits_j, f"decode step {step}")
            top2 = np.sort(_np(logits_j[:, 0]), axis=-1)[:, -2:]
            decisive = (top2[:, 1] - top2[:, 0]) > MARGIN
            np.testing.assert_array_equal(ids_t[:, 0].numpy()[decisive],
                                          np.asarray(ids_j[:, 0])[decisive])
            tok_j = ids_j
        assert ct["t"].tolist() == [prompt + decode] * B


def test_main_runs_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "2", "--decode", "3"])
    out = capsys.readouterr().out
    assert "decoded 3 tokens" in out and "on cpu" in out


def test_init_cache_matches_reference_layout():
    cfg = get_reduced(ARCH)
    want = jinit_cache(jget_reduced(ARCH), 3, 12)
    got = tm.init_cache(cfg, 3, 12)
    flat_w = {p: (tuple(x.shape), str(x.dtype))
              for p, x in bridge.leaves(jax.tree.map(np.asarray, want))}
    flat_g = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
              for p, x in bridge.leaves(got)}
    assert flat_g == flat_w
    assert {p.rsplit("/", 1)[-1] for p in flat_g} == {"t", "h", "conv"}


# ------------------------------------------------------------------ bridge

def test_bridge_round_trip_is_bitwise_with_fp32_leaves(model):
    _, _, _, tree, params_t, _ = model
    assert params_t["periods"]["l0"]["mixer"]["A_log"].dtype == torch.float32
    back = bridge.params_to_numpy(params_t, bf16_dtype=ml_dtypes.bfloat16)
    want, got = dict(bridge.leaves(tree)), dict(bridge.leaves(back))
    assert list(got) == list(want)
    for path, a in want.items():
        assert got[path].dtype == a.dtype, path
        np.testing.assert_array_equal(got[path].view(np.uint8),
                                      a.view(np.uint8), err_msg=path)


def test_leaf_sizes_equal_tree_leaf_sizes(model):
    _, _, params_j, _, params_t, _ = model
    assert bridge.leaf_sizes(params_t) == tree_leaf_sizes(params_j)


def test_bridge_checks_dtypes(model):
    cfg, _, _, tree, _, _ = model
    bad = jax.tree.map(lambda a: a, tree)
    mixer = bad["periods"]["l0"]["mixer"]
    mixer["A_log"] = mixer["A_log"].astype(ml_dtypes.bfloat16)
    with pytest.raises(ValueError, match="A_log"):
        bridge.params_from_numpy(bad, cfg, device="cpu")


@pytest.mark.parametrize("ssm_state", [4, 16])
def test_own_init_fixed_leaves_equal_the_reference(ssm_state):
    """A_log, D, dt_bias and conv_b are not random: the port's init gives
    the reference's values. At ssm_state 4 every bit agrees. At 16 (the
    full config's), XLA's CPU log rounds log(7) one ulp above the correctly
    rounded value that torch.log gives, so there A_log is within one ulp."""
    cfg = dataclasses.replace(get_reduced(ARCH), ssm_state=ssm_state)
    jcfg = dataclasses.replace(jget_reduced(ARCH), ssm_state=ssm_state)
    mj = jinit_params(jcfg, jax.random.PRNGKey(0))["periods"]["l0"]["mixer"]
    mt = bridge.init_params(cfg, seed=0, device="cpu")["periods"]["l0"]["mixer"]
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        want = np.asarray(mj[name])
        got = bridge.params_to_numpy({name: mt[name]},
                                     bf16_dtype=ml_dtypes.bfloat16)[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if ssm_state == 16 and name == "A_log":
            ulps = np.abs(got.view(np.int32) - want.view(np.int32))
            assert ulps.max() <= 1
            np.testing.assert_array_equal(np.nonzero(ulps[0, 0])[0], [6])
        else:
            np.testing.assert_array_equal(got.view(np.uint8),
                                          want.view(np.uint8), err_msg=name)
    w = mt["dt_proj"].float()
    assert abs(w.std().item() * cfg.resolved_dt_rank ** 0.5 - 1) < 0.1
    assert abs(mt["conv_w"].float().std().item() / 0.1 - 1) < 0.1
