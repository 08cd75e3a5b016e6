"""The port's MoE layer (repro_torch.models.moe) against the JAX package's
``_moe_core`` on the reduced granite-moe-1b-a400m (32 -> 8 experts, top-2
of the reduced config) and mixtral-8x7b (4 experts, top-2): the router's
gates and indices with ``jax.lax.top_k``'s tie rule, dispatch and combine
given the reference's own routing, the whole layer's output and aux loss
at the configs' capacity factor, at 0.5 (tokens drop) and at 8 (none
drop), and capacity with its overflow sink."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = dict(rtol=2e-2, atol=2e-2)   # bf16 model tolerance (test_arch_smoke)
ARCHS = ("granite-moe-1b-a400m", "mixtral-8x7b")
B, S = 4, 16


def _cfgs(arch, capacity_factor=None):
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return jcfg, cfg


def _layer(arch, seed=0, T=B * S, router=None):
    """(reference params, the port's, x as a JAX array and as a tensor):
    ``moe_init`` params and a (1, T, d) bf16 input of unit normals, as an
    rms-normed residual stream hands it over."""
    jcfg, cfg = _cfgs(arch)
    pj = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    if router is not None:
        pj = dict(pj, router=jnp.asarray(router, jnp.bfloat16))
    tree = jax.tree.map(np.asarray, pj)
    pt = {k: bridge._to_torch(v, torch.device("cpu")) for k, v in tree.items()}
    x = np.random.default_rng(seed + 1).standard_normal((1, T, cfg.d_model))
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = bridge._to_torch(np.asarray(xj), torch.device("cpu"))
    return pj, pt, xj, xt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _ref_route(pj, jcfg, xj):
    xt = xj.reshape(-1, xj.shape[-1])
    logits = (xt @ pj["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate, idx = jax.lax.top_k(probs, jcfg.top_k)
    gate = (gate / jnp.sum(gate, axis=-1, keepdims=True)).astype(xj.dtype)
    return np.asarray(logits), np.asarray(probs), gate, np.asarray(idx)


# ------------------------------------------------------------------ route

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference_where_the_top_k_is_decided(arch, seed):
    """Indices equal wherever the reference's k-th and (k+1)-th
    probabilities are further apart than one bf16 ulp of the token's
    largest logit (a product that rounds to another bf16 value cannot
    reorder them) or exactly equal (the tie rule); gates and probabilities
    within the bf16 tolerance."""
    jcfg, cfg = _cfgs(arch)
    pj, pt, xj, xt = _layer(arch, seed)
    logits, probs, gate_j, idx_j = _ref_route(pj, jcfg, xj)
    gate, idx, probs_t = moe.route(pt, cfg, xt)
    assert gate.dtype == torch.bfloat16 and tuple(idx.shape) == idx_j.shape
    np.testing.assert_allclose(probs_t.numpy(), probs, **TOL)
    k = cfg.top_k
    srt = -np.sort(-probs, axis=-1)
    gap = srt[:, k - 1] - srt[:, k]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(logits).max(axis=-1))) - 7)
    decided = (gap > ulp) | (gap == 0)
    assert decided.mean() > 0.75
    np.testing.assert_array_equal(idx.numpy()[decided], idx_j[decided])
    np.testing.assert_allclose(_np(gate)[decided], _np(gate_j)[decided], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_breaks_ties_as_jax_top_k(arch):
    """A router whose columns come in equal pairs gives every token exact
    ties: the lower expert index comes first, as in ``jax.lax.top_k``; a
    zero router ties every expert and picks experts 0..k-1."""
    jcfg, cfg = _cfgs(arch)
    d, e = cfg.d_model, cfg.n_experts
    half = np.random.default_rng(5).standard_normal((d, e // 2)) * 0.02
    for router in (np.repeat(half, 2, axis=1), np.zeros((d, e))):
        pj, pt, xj, xt = _layer(arch, router=router)
        _, _, gate_j, idx_j = _ref_route(pj, jcfg, xj)
        gate, idx, _ = moe.route(pt, cfg, xt)
        np.testing.assert_array_equal(idx.numpy(), idx_j)
        np.testing.assert_array_equal(_np(gate), _np(gate_j))
    np.testing.assert_array_equal(idx.numpy(),
                                  np.tile(np.arange(cfg.top_k), (B * S, 1)))


# ------------------------------------------------------- dispatch, combine

@pytest.mark.parametrize("capacity_factor", [None, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_combine_given_the_reference_routing(arch, capacity_factor):
    jcfg, cfg = _cfgs(arch, capacity_factor)
    pj, pt, xj, xt = _layer(arch)
    want, _ = jmoe._moe_core(pj, jcfg, xj)
    _, _, gate_j, idx_j = _ref_route(pj, jcfg, xj)
    gate = bridge._to_torch(np.asarray(gate_j), torch.device("cpu"))
    got = moe.dispatch_combine(pt, cfg, xt, gate,
                               torch.from_numpy(idx_j.astype(np.int64)))
    assert got.shape == xt.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("capacity_factor", [None, 0.5, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_moe_core(arch, capacity_factor):
    """y and the Switch aux loss. At the configs' 1.25 granite-moe's 8
    experts overflow on this input and mixtral's 4 do not; at 0.5 both drop
    tokens (the port must drop the same ones), at 8 neither does."""
    jcfg, cfg = _cfgs(arch, capacity_factor)
    pj, pt, xj, xt = _layer(arch)
    y_j, aux_j = jmoe._moe_core(pj, jcfg, xj)
    y, aux = moe.moe_apply(pt, cfg, xt)
    np.testing.assert_allclose(_np(y), _np(y_j), **TOL)
    load = np.bincount(moe.route(pt, cfg, xt)[1].numpy().ravel(),
                       minlength=cfg.n_experts)
    drops = {None: arch == "granite-moe-1b-a400m", 0.5: True, 8.0: False}
    assert (load.max() > moe.capacity(cfg, B * S)) == drops[capacity_factor]
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-5)


# ------------------------------------------------------- capacity, sink

@pytest.mark.parametrize("T", [1, 4, 64])
def test_capacity_and_the_overflow_sink(T):
    """Every token prefers experts 0 and 1 (top-2): the first ``cap``
    tokens fill both buffers and the rest drop on both choices, so their
    output rows are exactly zero in both packages."""
    arch = "granite-moe-1b-a400m"
    jcfg, cfg = _cfgs(arch)
    cap = moe.capacity(cfg, T)
    assert cap == max(8, int(jcfg.capacity_factor * T * jcfg.top_k
                             / jcfg.n_experts))
    router = np.zeros((cfg.d_model, cfg.n_experts))
    router[:, :2] = 0.5
    pj, pt, xj, xt = _layer(arch, T=T, router=router)
    xj, xt = jnp.abs(xj), xt.abs()      # positive rows: x @ router > 0
    y_j, _ = jmoe._moe_core(pj, jcfg, xj)
    y, _ = moe.moe_apply(pt, cfg, xt)
    np.testing.assert_allclose(_np(y), _np(y_j), **TOL)
    zero = (_np(y)[0] == 0).all(axis=-1)
    np.testing.assert_array_equal(zero, (_np(y_j)[0] == 0).all(axis=-1))
    np.testing.assert_array_equal(zero, np.arange(T) >= cap)
