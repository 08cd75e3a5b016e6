"""The port's cross-attention, encoder and context threading against the
JAX package, on the reduced llama-3.2-vision-11b (one 5-layer period whose
l3 is a gated cross-attention layer) and seamless-m4t-medium (an encoder
of 2 layers, then 2 periods of (attn, none) and (cross, mlp) layers).

Every cross-attention ``gate`` is zero at init, which makes its layer a
no-op: a check on init params would pass with cross-attention, ``encode``
or the context threading wrong. So both sides take one numpy tree whose
gates are set to GATE, and ``test_the_gate_is_live`` shows that the gate
moves the logits beyond the tolerance."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.data import modality_stub as jmodality_stub  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import encode as jencode  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.svm import tree_leaf_sizes  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.data import modality_stub  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as tm  # noqa: E402

TOL = dict(rtol=2e-2, atol=2e-2)   # bf16 model tolerance (test_arch_smoke)
B, S = 2, 16
GATE = 0.5
LOUD = 8.0
VLM, ENCDEC = "llama-3.2-vision-11b", "seamless-m4t-medium"
ARCHS = (VLM, ENCDEC)
# the period key of each arch's cross-attention layer
CROSS_KEY = {VLM: "l3", ENCDEC: "l1"}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bf16(a):
    """A float32 numpy array as the reference's and the port's bf16."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j).view(np.int16)).view(
        torch.bfloat16)


def _with_gates(tree, cfg, value):
    """A copy of the numpy params tree with every cross-attention gate at
    ``value`` (the tree's other leaves shared)."""
    periods = dict(tree["periods"])
    for j, mixer in enumerate(cfg.layer_pattern):
        if mixer == "cross":
            lp = dict(periods[f"l{j}"])
            lp["gate"] = np.full(lp["gate"].shape, value, ml_dtypes.bfloat16)
            periods[f"l{j}"] = lp
    return dict(tree, periods=periods)


@functools.lru_cache(maxsize=None)
def _model(arch, gate=GATE):
    """(reference params, the port's params, tokens, the raw context as
    (reference, port) bf16 arrays) of the reduced ``arch``, gates at
    ``gate``."""
    cfg = get_reduced(arch)
    tree = jax.tree.map(np.asarray,
                        jinit_params(jget_reduced(arch), jax.random.PRNGKey(0)))
    tree = _with_gates(tree, cfg, gate)
    params_j = jax.tree.map(jnp.asarray, tree)
    params_t = bridge.params_from_numpy(tree, cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)
    kind, T = (("image", cfg.image_tokens) if cfg.is_vlm
               else ("frames", cfg.encoder_frames))
    ctx = _bf16(jmodality_stub(kind, B, T, cfg.d_model, seed=2))
    return params_j, params_t, tokens, ctx


def _contexts(arch, params_j, params_t, ctx):
    """What the cross layers attend to on each side: the encoder's output
    for the encoder-decoder, the image patches for the VLM."""
    cj, ct = ctx
    if arch == ENCDEC:
        return (jencode(params_j, jget_reduced(arch), cj),
                tm.encode(params_t, get_reduced(arch), ct))
    return cj, ct


def _mixer(arch, key):
    """Period 0's attention params of layer ``key`` on both sides, each
    projection times LOUD: at init (normal x 0.02, d_model 64) a module's
    output stays under the tolerance's atol of 2e-2, so the comparison
    would pass whatever the module computed."""
    params_j, params_t, _, _ = _model(arch)
    pj = jax.tree.map(lambda a: a[0] * LOUD, params_j["periods"][key]["mixer"])
    pt = {k: v[0] * LOUD for k, v in params_t["periods"][key]["mixer"].items()}
    return pj, pt


def _forward(arch, gate=GATE):
    params_j, params_t, tokens, ctx = _model(arch, gate)
    cj, ct = _contexts(arch, params_j, params_t, ctx)
    want, _ = jforward(params_j, jget_reduced(arch), tokens, ctx=cj)
    got = tm.forward(params_t, get_reduced(arch), torch.from_numpy(tokens), ct)
    return got, want


# ------------------------------------------------------------ configs, data

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(get_reduced(arch)) == \
        dataclasses.asdict(jget_reduced(arch))
    assert get_config(arch).is_vlm == (arch == VLM)
    assert get_config(arch).is_encdec == (arch == ENCDEC)


@pytest.mark.parametrize("kind,batch,tokens,d,seed", [
    ("image", 4, 6404, 16, 0), ("frames", 4, 1024, 32, 0),
    ("image", 2, 8, 64, 3), ("frames", 1, 16, 64, 7), ("audio", 3, 5, 2, 1)])
def test_modality_stub_equals_reference(kind, batch, tokens, d, seed):
    got = modality_stub(kind, batch, tokens, d, seed=seed)
    want = jmodality_stub(kind, batch, tokens, d, seed=seed)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_launcher_context_is_the_reference_stub_in_bf16():
    for arch, kind in ((VLM, "image"), (ENCDEC, "frames")):
        cfg = get_reduced(arch)
        T = cfg.image_tokens if cfg.is_vlm else cfg.encoder_frames
        got = serve.context(cfg, 3, "cpu")
        want = np.asarray(jnp.asarray(
            jmodality_stub(kind, 3, T, cfg.d_model), jnp.bfloat16))
        assert got.dtype == torch.bfloat16 and got.shape == (3, T, cfg.d_model)
        assert np.array_equal(got.view(torch.int16).numpy(),
                              want.view(np.int16))
    assert serve.context(get_reduced("gemma3-1b"), 3, "cpu") is None


# ----------------------------------------------------------------- params

@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_has_the_reference_paths_shapes_dtypes(arch, full):
    """``encoder/...`` and the scalar ``gate`` stacked over periods
    included; the port's own init keeps every gate at zero, as the
    reference's does."""
    jcfg = jget_config(arch) if full else jget_reduced(arch)
    cfg = get_config(arch) if full else get_reduced(arch)
    want = jax.eval_shape(lambda: jinit_params(jcfg, jax.random.PRNGKey(0)))
    want = [(p, tuple(x.shape), str(x.dtype)) for p, x in bridge.leaves(want)]
    if full:
        got = [(p, tuple(s), str(dt).replace("torch.", ""))
               for p, (s, dt) in bridge.leaves(bridge.param_shapes(cfg))]
    else:
        params = bridge.init_params(cfg, seed=0, device="cpu")
        got = [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
               for p, x in bridge.leaves(params)]
        gates = [x for p, x in bridge.leaves(params) if p.endswith("/gate")]
        assert len(gates) == 1 and float(gates[0].abs().max()) == 0.0
        wq = params["periods"][CROSS_KEY[arch]]["mixer"]["wq"]
        assert 0.018 < wq.float().std().item() < 0.022
    assert got == want
    paths = [p for p, _, _ in got]
    assert f"periods/{CROSS_KEY[arch]}/gate" in paths
    assert any(p.startswith("encoder/") for p in paths) == (arch == ENCDEC)
    if arch == ENCDEC:   # (attn, none) layers: no norm2, no ffn
        assert not any(p.startswith(("periods/l0/ffn", "periods/l0/norm2"))
                       for p in paths)
        assert paths[-1] == "periods/l1/norm2"


@pytest.mark.parametrize("arch", ARCHS)
def test_params_cross_bit_for_bit(arch):
    params_j, params_t, _, _ = _model(arch)
    tree = jax.tree.map(np.asarray, params_j)
    back = bridge.params_to_numpy(params_t, bf16_dtype=ml_dtypes.bfloat16)
    want, got = dict(bridge.leaves(tree)), dict(bridge.leaves(back))
    assert list(got) == list(want)
    for path, a in want.items():
        assert got[path].dtype == a.dtype, path
        np.testing.assert_array_equal(got[path].view(np.uint8),
                                      a.view(np.uint8), err_msg=path)
    assert bridge.leaf_sizes(params_t) == tree_leaf_sizes(params_j)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference_layout(arch):
    want = jinit_cache(jget_reduced(arch), 3, 12)
    got = tm.init_cache(get_reduced(arch), 3, 12)
    flat_w = {p: (tuple(x.shape), str(x.dtype))
              for p, x in bridge.leaves(jax.tree.map(np.asarray, want))}
    flat_g = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
              for p, x in bridge.leaves(got)}
    assert flat_g == flat_w
    assert got["periods"][CROSS_KEY[arch]] == {}


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("s_len", [S, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_matches_reference(arch, s_len):
    """At prefill and at decode (S = 1): one code path, the context's K/V
    projected on every call."""
    *_, (cj, ct) = _model(arch)
    cfg = get_reduced(arch)
    x = np.random.default_rng(5).standard_normal(
        (B, s_len, cfg.d_model)).astype(np.float32)
    xj, xt = _bf16(x)
    pj, pt = _mixer(arch, CROSS_KEY[arch])
    want = jattn.cross_attention(pj, jget_reduced(arch), xj, cj)
    got = tattn.cross_attention(pt, cfg, xt, ct)
    assert got.shape == (B, s_len, cfg.d_model) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert float(np.abs(_np(want)).max()) > 10 * TOL["atol"]


@pytest.mark.parametrize("arch", ARCHS)
def test_encoder_self_attention_matches_reference(arch):
    """Bidirectional, RoPE on arange(S): a later key changes an earlier
    query's output, which a causal mask would hide."""
    cfg = get_reduced(arch)
    pj, pt = _mixer(arch, "l0")
    x = np.random.default_rng(6).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    xj, xt = _bf16(x)
    want = jattn.encoder_self_attention(pj, jget_reduced(arch), xj)
    got = tattn.encoder_self_attention(pt, cfg, xt)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert float(np.abs(_np(want)).max()) > 10 * TOL["atol"]
    x2 = x.copy()
    x2[:, -1] += 3.0
    moved = tattn.encoder_self_attention(pt, cfg, _bf16(x2)[1])
    assert not np.allclose(_np(moved)[:, 0], _np(got)[:, 0], **TOL)


def test_encode_matches_reference():
    params_j, params_t, _, (cj, ct) = _model(ENCDEC)
    cfg = get_reduced(ENCDEC)
    want = jencode(params_j, jget_reduced(ENCDEC), cj)
    got = tm.encode(params_t, cfg, ct)
    assert got.shape == (B, cfg.encoder_frames, cfg.d_model)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_encode_runs_its_layers_in_numeric_order():
    """With 12 layers the tree's keys sort e0, e1, e10, e11, e2, ...; the
    stack runs e0 .. e11, as the reference's does: in the sorted order it
    would be farther than the tolerance from the reference."""
    cfg = dataclasses.replace(get_reduced(ENCDEC), encoder_layers=12)
    jcfg = dataclasses.replace(jget_reduced(ENCDEC), encoder_layers=12)
    params = bridge.init_params(cfg, seed=0, device="cpu")
    keys = [p.split("/")[1] for p, _ in bridge.leaves(params)
            if p.startswith("encoder/e")][::9]
    assert keys[:4] == ["e0", "e1", "e10", "e11"]
    # the layers' weights x 3, so that their order shows in the output
    params["encoder"] = {k: v if k == "final_norm" else
                         bridge.tree_map(lambda w: w * 3.0, v)
                         for k, v in params["encoder"].items()}
    frames = serve.context(cfg, B, "cpu")
    tree = bridge.params_to_numpy(params, bf16_dtype=ml_dtypes.bfloat16)
    want = _np(jencode(jax.tree.map(jnp.asarray, tree), jcfg,
                       _bf16(frames.float().numpy())[0]))
    np.testing.assert_allclose(_np(tm.encode(params, cfg, frames)), want,
                               **TOL)
    enc = params["encoder"]
    sorted_order = dict(enc, **{f"e{i}": enc[k] for i, k in enumerate(keys)})
    assert not np.allclose(_np(tm.encode(dict(params, encoder=sorted_order),
                                         cfg, frames)), want, **TOL)


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_ctx_matches_reference(arch):
    got, want = _forward(arch)
    cfg = get_reduced(arch)
    assert got.shape == (B, S, cfg.padded_vocab) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_gate_is_live(arch):
    """The logits with every gate at 0 and at 1 differ beyond the
    tolerance, on both sides: the checks of this module see the cross
    layers (and for the encoder-decoder the encoder)."""
    off, off_j = _forward(arch, 0.0)
    on, on_j = _forward(arch, 1.0)
    np.testing.assert_allclose(_np(on), _np(on_j), **TOL)
    np.testing.assert_allclose(_np(off), _np(off_j), **TOL)
    for a, b in ((on, off), (on_j, off_j)):
        assert not np.allclose(_np(a), _np(b), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """As test_arch_smoke.py:79: prefill S-2 tokens into an S-wide cache
    and decode the last two teacher-forced, the context threaded through
    every call; each step's logits match the port's forward and the
    reference's prefill and decode."""
    params_j, params_t, tokens, ctx = _model(arch)
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    cj, ct = _contexts(arch, params_j, params_t, ctx)
    toks = torch.from_numpy(tokens)
    full = _np(tm.forward(params_t, cfg, toks, ct))
    pre, cache = tm.prefill(params_t, cfg, toks[:, : S - 2], ct, cache_len=S)
    pre_j, cache_j = jprefill(params_j, jcfg, tokens[:, : S - 2], ctx=cj,
                              cache_len=S)
    np.testing.assert_allclose(_np(pre[:, -1]), full[:, S - 3], **TOL)
    np.testing.assert_allclose(_np(pre), _np(pre_j), **TOL)
    assert cache["periods"][CROSS_KEY[arch]] == {}
    for t in (S - 2, S - 1):
        logits, cache = tm.decode_step(params_t, cfg, toks[:, t: t + 1],
                                       cache, ct)
        logits_j, cache_j = jdecode_step(params_j, jcfg, tokens[:, t: t + 1],
                                         cache_j, ctx=cj)
        np.testing.assert_allclose(_np(logits[:, 0]), full[:, t], **TOL)
        np.testing.assert_allclose(_np(logits), _np(logits_j), **TOL)
    assert cache["t"].tolist() == [S, S]

