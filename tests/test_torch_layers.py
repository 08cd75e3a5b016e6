"""The port's layers (repro_torch.models.layers) against the JAX package's,
on the same numpy inputs, including the reference's rounding traps: tanh
GELU, the embed scale rounded to bf16, fp32 norm and rotary math."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

# one bf16 ulp is 2^-8 relative; elementwise layers round once more or
# less than the reference in places, the MLP adds fp32 sums in two orders
ELEMENTWISE = dict(rtol=1e-2, atol=1e-2)
MLP_TOL = dict(rtol=2e-2, atol=2e-2)


def _both(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return (jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_rms_norm():
    rng = np.random.default_rng(0)
    xj, xt = _both(rng, (2, 5, 64), 3.0)
    sj, st = _both(rng, (64,), 0.1)
    np.testing.assert_allclose(_np(tl.rms_norm(xt, st, 1e-6)),
                               _np(jl.rms_norm(xj, sj, 1e-6)), **ELEMENTWISE)


@pytest.mark.parametrize("kind", ["silu", "gelu"])
def test_activation(kind):
    rng = np.random.default_rng(1)
    xj, xt = _both(rng, (4, 256), 2.0)
    np.testing.assert_allclose(_np(tl.activation(xt, kind)),
                               _np(jl.activation(xj, kind)), **ELEMENTWISE)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to tanh; torch's default (erf) differs from it
    by more than the comparison tolerance on fp32 inputs."""
    x = np.linspace(-4, 4, 2001, dtype=np.float32)
    ours = tl.activation(torch.from_numpy(x), "gelu").numpy()
    ref = np.asarray(jl.activation(jnp.asarray(x), "gelu"))
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    assert np.abs(erf - ref).max() > 1e-4


def test_activation_unknown_raises():
    with pytest.raises(ValueError):
        tl.activation(torch.zeros(2), "relu")


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_apply(gated):
    rng = np.random.default_rng(2)
    xj, xt = _both(rng, (2, 3, 64))
    names = ["wi_up", "wo"] + (["wi_gate"] if gated else [])
    shapes = {"wi_up": (64, 128), "wo": (128, 64), "wi_gate": (64, 128)}
    pj, pt = {}, {}
    for n in names:
        pj[n], pt[n] = _both(rng, shapes[n], 0.1)
    np.testing.assert_allclose(_np(tl.mlp_apply(pt, xt, "gelu")),
                               _np(jl.mlp_apply(pj, xj, "gelu")), **MLP_TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_frequencies(theta):
    np.testing.assert_allclose(
        tl.rope_frequencies(256, theta, 256).numpy(),
        np.asarray(jl.rope_frequencies(256, theta, 256)), rtol=1e-6)


@pytest.mark.parametrize("theta,partial", [(10_000.0, 1.0),
                                           (1_000_000.0, 1.0),
                                           (10_000.0, 0.5)])
def test_apply_rope(theta, partial):
    rng = np.random.default_rng(3)
    xj, xt = _both(rng, (2, 16, 4, 32))
    pos = np.arange(16, dtype=np.int32)[None, :] + 1000   # far positions
    out_t = tl.apply_rope(xt, torch.from_numpy(pos), theta, partial)
    out_j = jl.apply_rope(xj, jnp.asarray(pos), theta, partial)
    assert out_t.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out_t), _np(out_j), **ELEMENTWISE)


def test_embed_apply_rounds_the_scale_to_bf16():
    """At d_model 1152 the reference multiplies by bf16(33.94) = 34.0; the
    reduced config (d_model 64, scale 8.0) cannot show it."""
    d = 1152
    rng = np.random.default_rng(4)
    tj, tt = _both(rng, (40, d), 0.5)
    ids = rng.integers(0, 40, size=(2, 7)).astype(np.int32)
    out_t = tl.embed_apply(tt, torch.from_numpy(ids), True, d)
    out_j = jl.embed_apply(tj, jnp.asarray(ids), True, d)
    np.testing.assert_array_equal(_np(out_t), _np(out_j))
    unrounded = (tt[torch.from_numpy(ids)].float() * d ** 0.5).to(torch.bfloat16)
    assert not torch.equal(out_t, unrounded)
    assert float(jnp.asarray(d ** 0.5, jnp.bfloat16)) == 34.0


def test_embed_apply_unscaled():
    rng = np.random.default_rng(5)
    tj, tt = _both(rng, (10, 64))
    ids = np.array([[0, 3, 9]], np.int32)
    np.testing.assert_array_equal(
        _np(tl.embed_apply(tt, torch.from_numpy(ids), False, 64)),
        _np(jl.embed_apply(tj, jnp.asarray(ids), False, 64)))
