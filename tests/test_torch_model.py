"""The port's decoder (repro_torch.models.transformer) and param bridge
against the JAX package on the reduced gemma3-1b, whose 8 layers cover a
whole 6-layer period and a 2-layer remainder, and on the reduced
granite-3-2b, chatglm3-6b, granite-20b, granite-moe-1b-a400m and
mixtral-8x7b: forward logits (and the MoE aux loss), prefill + decode
against forward, and the params tree crossing."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.svm import tree_leaf_sizes  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import transformer as tm  # noqa: E402

TOL = dict(rtol=2e-2, atol=2e-2)   # bf16 model tolerance (test_arch_smoke)
B, S = 2, 16
# the archs ported after gemma3-1b and falcon-mamba-7b's own test modules
NEW_ARCHS = ("granite-3-2b", "chatglm3-6b", "granite-20b",
             "granite-moe-1b-a400m", "mixtral-8x7b")


@pytest.fixture(scope="module")
def model():
    cfg = get_reduced("gemma3-1b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_reduced("gemma3-1b"))
    params_j = jinit_params(jget_reduced("gemma3-1b"), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params_j)
    params_t = bridge.params_from_numpy(tree, cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)
    return cfg, params_j, tree, params_t, tokens


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_configs_match_reference():
    assert dataclasses.asdict(get_config("gemma3-1b")) == \
        dataclasses.asdict(jget_config("gemma3-1b"))
    for name in ("jamba-1.5-large-398b",):   # the last arch ported
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jget_config(name))
        assert dataclasses.asdict(get_reduced(name)) == \
            dataclasses.asdict(jget_reduced(name))
    with pytest.raises(ValueError):
        get_config("no-such-arch")


def test_forward_logits_match_reference(model):
    cfg, params_j, _, params_t, tokens = model
    want, _ = jforward(params_j, jget_reduced("gemma3-1b"), tokens)
    got = tm.forward(params_t, cfg, torch.from_numpy(tokens))
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_prefill_decode_matches_forward(model):
    """Port of test_arch_smoke.py:79 for gemma3-1b: prefill S-2 tokens into
    an S-wide cache, decode the last two teacher-forced; each step's
    logits match the port's forward and the reference's."""
    cfg, params_j, _, params_t, tokens = model
    toks = torch.from_numpy(tokens)
    full = _np(tm.forward(params_t, cfg, toks))
    full_j, _ = jforward(params_j, jget_reduced("gemma3-1b"), tokens)
    np.testing.assert_allclose(full, _np(full_j), **TOL)
    pre, cache = tm.prefill(params_t, cfg, toks[:, : S - 2], cache_len=S)
    np.testing.assert_allclose(_np(pre[:, -1]), full[:, S - 3], **TOL)
    logits_a, cache = tm.decode_step(params_t, cfg, toks[:, S - 2: S - 1], cache)
    np.testing.assert_allclose(_np(logits_a[:, 0]), full[:, S - 2], **TOL)
    logits_b, cache = tm.decode_step(params_t, cfg, toks[:, S - 1: S], cache)
    np.testing.assert_allclose(_np(logits_b[:, 0]), full[:, S - 1], **TOL)
    assert cache["t"].tolist() == [S, S]


def test_init_cache_matches_reference_layout():
    cfg = get_reduced("gemma3-1b")
    want = jinit_cache(jget_reduced("gemma3-1b"), 3, 12)
    got = tm.init_cache(cfg, 3, 12)
    flat_w = {p: (tuple(x.shape), str(x.dtype))
              for p, x in bridge.leaves(jax.tree.map(np.asarray, want))}
    flat_g = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
              for p, x in bridge.leaves(got)}
    assert flat_g == flat_w


def test_unported_layer_kinds_raise():
    """Mamba layers followed by an MLP or a MoE FFN (jamba-1.5-large-398b's
    layer kinds) on the reduced falcon-mamba-7b: ``bridge.param_shapes``
    and ``tm.init_cache`` give the reference's ``init_params`` and
    ``init_cache`` paths, shapes and dtypes. An unknown mixer or FFN raises
    ``ValueError`` in both packages."""
    def kinds(get, ffn):
        return dataclasses.replace(get("falcon-mamba-7b"), ffn_pattern=(ffn,),
                                   d_ff=128, n_experts=4, top_k=2)
    for ffn in ("mlp", "moe"):
        cfg, jcfg = kinds(get_reduced, ffn), kinds(jget_reduced, ffn)
        want = jax.eval_shape(lambda: jinit_params(jcfg, jax.random.PRNGKey(0)))
        assert [(p, tuple(s), str(dt).replace("torch.", "")) for p, (s, dt)
                in bridge.leaves(bridge.param_shapes(cfg))] == \
            [(p, tuple(x.shape), str(x.dtype)) for p, x in bridge.leaves(want)]
        assert {p.split("/")[2] for p, _ in bridge.leaves(want)
                if p.startswith("periods/")} == {"norm1", "mixer", "norm2",
                                                 "ffn"}
        want = jinit_cache(jcfg, 3, 12)
        assert {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
                for p, x in bridge.leaves(tm.init_cache(cfg, 3, 12))} == \
            {p: (tuple(x.shape), str(x.dtype))
             for p, x in bridge.leaves(jax.tree.map(np.asarray, want))}
    for field, bad in (("layer_pattern", ("conv",)), ("ffn_pattern", ("glu",))):
        c, jc = (dataclasses.replace(x, **{field: bad}) for x in (cfg, jcfg))
        with pytest.raises(ValueError):
            jinit_params(jc, jax.random.PRNGKey(0))
        with pytest.raises(ValueError):
            bridge.param_shapes(c)
    c, jc = (dataclasses.replace(x, layer_pattern=("conv",))
             for x in (cfg, jcfg))
    with pytest.raises(ValueError):
        jinit_cache(jc, 1, 4)
    with pytest.raises(ValueError):
        tm.init_cache(c, 1, 4)


# ------------------------------------------------------------------ bridge

def test_bridge_round_trip_is_bitwise(model):
    _, _, tree, params_t, _ = model
    back = bridge.params_to_numpy(params_t, bf16_dtype=ml_dtypes.bfloat16)
    want, got = dict(bridge.leaves(tree)), dict(bridge.leaves(back))
    assert list(got) == list(want)
    for path, a in want.items():
        assert got[path].dtype == a.dtype, path
        np.testing.assert_array_equal(got[path].view(np.uint8),
                                      a.view(np.uint8), err_msg=path)
    bits = bridge.params_to_numpy(params_t)["embed"]
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(bits, tree["embed"].view(np.uint16))


def test_leaf_sizes_equal_tree_leaf_sizes(model):
    _, params_j, _, params_t, _ = model
    assert bridge.leaf_sizes(params_t) == tree_leaf_sizes(params_j)


def test_bridge_rejects_a_tree_of_another_config(model):
    cfg, _, tree, _, _ = model
    with pytest.raises(ValueError):
        bridge.params_from_numpy(tree, get_config("gemma3-1b"), device="cpu")


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("name", ["gemma3-1b", "falcon-mamba-7b", *NEW_ARCHS])
def test_own_init_has_the_reference_paths_shapes_dtypes(name, full):
    """The port's seeded init at the reduced size, and its tree at full
    width (shapes and dtypes only, from jax.eval_shape: no allocation)."""
    jcfg = jget_config(name) if full else jget_reduced(name)
    cfg = get_config(name) if full else get_reduced(name)
    want = jax.eval_shape(lambda: jinit_params(jcfg, jax.random.PRNGKey(0)))
    want = [(p, tuple(x.shape), str(x.dtype))
            for p, x in bridge.leaves(want)]
    if full:
        got = [(p, tuple(s), str(dt).replace("torch.", ""))
               for p, (s, dt) in bridge.leaves(bridge.param_shapes(cfg))]
    else:
        params = bridge.init_params(cfg, seed=0, device="cpu")
        got = [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
               for p, x in bridge.leaves(params)]
        assert float(params["final_norm"].abs().max()) == 0.0
        std = params["embed"].float().std().item()
        assert 0.018 < std < 0.022
        again = bridge.init_params(cfg, seed=0, device="cpu")
        assert torch.equal(again["embed"], params["embed"])
    assert got == want


# ---------------------------------------------- the archs of ROADMAP 12, 6

@functools.lru_cache(maxsize=None)
def _new_model(arch):
    """(reference params, their numpy tree, the port's params, tokens) of
    the reduced ``arch``."""
    cfg = get_reduced(arch)
    params_j = jinit_params(jget_reduced(arch), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params_j)
    params_t = bridge.params_from_numpy(tree, cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)
    return params_j, tree, params_t, tokens


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_match_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(get_reduced(arch)) == \
        dataclasses.asdict(jget_reduced(arch))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_params_cross_bit_for_bit(arch):
    params_j, tree, params_t, _ = _new_model(arch)
    back = bridge.params_to_numpy(params_t, bf16_dtype=ml_dtypes.bfloat16)
    want, got = dict(bridge.leaves(tree)), dict(bridge.leaves(back))
    assert list(got) == list(want)
    for path, a in want.items():
        assert got[path].dtype == a.dtype, path
        np.testing.assert_array_equal(got[path].view(np.uint8),
                                      a.view(np.uint8), err_msg=path)
    assert bridge.leaf_sizes(params_t) == tree_leaf_sizes(params_j)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_forward_matches_reference(arch):
    """Logits, and the aux loss: the mean over MoE layers of the Switch
    loss, 0 for the dense archs."""
    params_j, _, params_t, tokens = _new_model(arch)
    cfg = get_reduced(arch)
    want, aux_j = jforward(params_j, jget_reduced(arch), tokens)
    got, aux = tm.forward_with_aux(params_t, cfg, torch.from_numpy(tokens))
    assert got.shape == (B, S, cfg.padded_vocab) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    # fp32 means of router probabilities over hidden states that carry
    # bf16 differences: 2e-4 apart relative at the reduced configs
    np.testing.assert_allclose(float(aux), float(aux_j), **TOL)
    assert (float(aux) > 0) == bool(cfg.n_experts)
    assert torch.equal(tm.forward(params_t, cfg, torch.from_numpy(tokens)), got)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_prefill_decode_matches_forward(arch):
    """As test_prefill_decode_matches_forward, with the MoE capacity raised
    to 8 so that no token drops (test_arch_smoke.py:86): capacity depends
    on the tokens of a call, so forward and decode drop different ones."""
    params_j, _, params_t, tokens = _new_model(arch)
    cfg = dataclasses.replace(get_reduced(arch), capacity_factor=8.0)
    jcfg = dataclasses.replace(jget_reduced(arch), capacity_factor=8.0)
    toks = torch.from_numpy(tokens)
    full = _np(tm.forward(params_t, cfg, toks))
    np.testing.assert_allclose(full, _np(jforward(params_j, jcfg, tokens)[0]),
                               **TOL)
    pre, cache = tm.prefill(params_t, cfg, toks[:, : S - 2], cache_len=S)
    np.testing.assert_allclose(_np(pre[:, -1]), full[:, S - 3], **TOL)
    for t in (S - 2, S - 1):
        logits, cache = tm.decode_step(params_t, cfg, toks[:, t: t + 1], cache)
        np.testing.assert_allclose(_np(logits[:, 0]), full[:, t], **TOL)
    assert cache["t"].tolist() == [S, S]
