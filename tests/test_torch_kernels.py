"""The port's kernel layer on the CPU: the plain versions (what the CPU
runs and what each CUDA kernel is held against on the card) against the
JAX package's Pallas kernels in interpret mode and its model attention,
plus the dispatch and the no-fallback rules of the wrappers. The CUDA
kernels themselves run only on the card (``python3 chip_smoke.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan_pallas  # noqa: E402
from repro.kernels.matmul import matmul_pallas  # noqa: E402
from repro.models.attention import _attend  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import mamba_scan as tscan  # noqa: E402
from repro_torch.kernels import matmul as tmatmul  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _both(seed, shape, dtype="f32", scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    jd, td = DT[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------------ matmul

def _mm_tol(dtype):  # test_kernels.py:77-78
    return dict(rtol=3e-2, atol=3e-1) if dtype == "bf16" \
        else dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mnk", [(128, 128, 128), (256, 512, 384),
                                 (512, 256, 1024), (64, 128, 256)])
def test_matmul_plain_matches_pallas(mnk, dtype):
    m, n, k = mnk
    aj, at = _both(4, (m, k), dtype)
    bj, bt = _both(5, (k, n), dtype)
    want = matmul_pallas(aj, bj, interpret=True)
    got = ref.matmul_ref(at, bt)
    assert got.dtype == at.dtype
    np.testing.assert_allclose(_np(got), _np(want), **_mm_tol(dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mnk", [(4, 384, 256), (37, 50, 100)])
def test_matmul_b_transposed_matches_pallas(mnk, dtype):
    """B given as (N, K) row-major, as the tied LM head reads the table."""
    m, n, k = mnk
    aj, at = _both(6, (m, k), dtype)
    bj, bt = _both(7, (n, k), dtype)
    want = matmul_pallas(aj, bj.T, interpret=True)
    got = ref.matmul_ref(at, bt, b_transposed=True)
    np.testing.assert_allclose(_np(got), _np(want), **_mm_tol(dtype))
    np.testing.assert_array_equal(
        _np(ops.matmul(at, bt, b_transposed=True)), _np(got))


def test_ops_matmul_flattens_leading_dims():
    _, a = _both(8, (2, 3, 64))
    _, b = _both(9, (64, 32))
    out = ops.matmul(a, b)
    assert out.shape == (2, 3, 32)
    np.testing.assert_array_equal(_np(out.reshape(6, 32)),
                                  _np(ref.matmul_ref(a.reshape(6, 64), b)))


# --------------------------------------------------------- flash attention

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bhsd", [(1, 2, 256, 64), (2, 4, 512, 128),
                                  (1, 1, 384, 64)])
def test_flash_plain_matches_pallas(bhsd, causal):
    B, H, S, D = bhsd
    qj, qt = _both(6, (B, H, S, D))
    kj, kt = _both(7, (B, H, S, D))
    vj, vt = _both(8, (B, H, S, D))
    want = flash_attention_pallas(qj, kj, vj, causal=causal, interpret=True)
    got = ref.flash_attention_ref(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("st", [(128, 256), (256, 128), (192, 320)])
def test_flash_plain_matches_pallas_when_s_differs_from_t(st, causal):
    """S != T: the port follows the Pallas kernel's top-left causal rule
    (key j visible to query i iff j <= i), not ref.py's bottom-right
    tril(k=T-S) — the two differ exactly in these cases."""
    S, T = st
    qj, qt = _both(10, (1, 2, S, 64))
    kj, kt = _both(11, (1, 2, T, 64))
    vj, vt = _both(12, (1, 2, T, 64))
    want = flash_attention_pallas(qj, kj, vj, causal=causal, interpret=True)
    got = ref.flash_attention_ref(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)
    if causal:
        bottom_right = jref.flash_attention_ref(qj, kj, vj, causal=True)
        assert np.abs(_np(bottom_right) - _np(want)).max() > 1e-2


def test_attention_mask_is_top_left_with_window():
    m = ref.attention_mask(4, 6, causal=True, window=2).numpy()
    want = np.array([[1, 0, 0, 0, 0, 0],
                     [1, 1, 0, 0, 0, 0],
                     [0, 1, 1, 0, 0, 0],
                     [0, 0, 1, 1, 0, 0]], bool)
    np.testing.assert_array_equal(m, want)


@pytest.mark.parametrize("window", [0, 5, 16])
@pytest.mark.parametrize("hkv", [(4, 1), (4, 2), (2, 2)])
def test_flash_plain_gqa_window_matches_model_attend(hkv, window):
    """Native GQA and the sliding window against the reference model's
    _attend (absolute positions arange(S), q pre-scaled, scale=1.0): the
    model's prefill attention. bf16; the reference rounds scores to bf16
    before its softmax, the plain version keeps them fp32."""
    H, KV = hkv
    B, S, D = 2, 40, 32
    G = H // KV
    qj, qt = _both(13, (B, S, H, D), "bf16", D ** -0.5)
    kj, kt = _both(14, (B, S, KV, D), "bf16")
    vj, vt = _both(15, (B, S, KV, D), "bf16")
    pos = jnp.arange(S, dtype=jnp.int32)[None, :]
    want = _attend(qj.reshape(B, S, KV, G, D), kj, vj, pos, pos, window)
    got = ops.flash_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                              vt.transpose(1, 2), causal=True, window=window,
                              scale=1.0)
    got = got.transpose(1, 2).reshape(B, S, H * D)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


# --------------------------------------------------------------- mamba scan

def _scan_inputs(Bt, S, D, N, x_dtype="f32"):
    """The inputs of test_kernels.py:104-108, from numpy: dt = softplus(.),
    A = -exp(0.3 .), B, C, x standard normal."""
    rng = np.random.default_rng(9)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, D)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal((D, N)) * 0.3)).astype(np.float32)
    B = rng.standard_normal((Bt, S, N)).astype(np.float32)
    C = rng.standard_normal((Bt, S, N)).astype(np.float32)
    x = rng.standard_normal((Bt, S, D)).astype(np.float32)
    jd, td = DT[x_dtype]
    j = [jnp.asarray(a) for a in (dt, A, B, C)] + [jnp.asarray(x, jd)]
    t = [torch.from_numpy(a) for a in (dt, A, B, C)] + [torch.from_numpy(x).to(td)]
    return j, t


def _h_last_f64(dt, A, B, C, x):
    """The final state by a float64 recurrence in numpy."""
    dt, A, B, x = (np.asarray(a, np.float64) for a in (dt, A, B, _np(x)))
    h = np.zeros((x.shape[0], x.shape[2], A.shape[1]))
    for t in range(x.shape[1]):
        h = np.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
    return h


@pytest.mark.parametrize("dims", [(1, 128, 512, 16), (2, 128, 640, 8),
                                  (1, 200, 256, 16)])
def test_mamba_scan_plain_matches_pallas(dims):
    """fp32, at test_kernels.py:101-113's tolerance 2e-3. S=200 is no
    multiple of 128: the Pallas kernel shrinks its chunk to 100, the plain
    version has none. The final state, which the Pallas kernel does not
    return, against a float64 recurrence."""
    Bt, S, D, N = dims
    j, t = _scan_inputs(*dims)
    want = mamba_scan_pallas(*j, interpret=True)
    y, h_last = ref.mamba_scan_ref(*t)
    assert y.dtype == torch.float32 and h_last.shape == (Bt, D, N)
    np.testing.assert_allclose(_np(y), _np(want), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(h_last), _h_last_f64(*t), rtol=2e-3,
                               atol=2e-3)


def test_mamba_scan_plain_matches_pallas_bf16_x():
    """x in bf16 as the model gives it: y comes out in bf16 from the same
    fp32 recurrence, within one bf16 rounding of the output (1e-2)."""
    j, t = _scan_inputs(2, 64, 256, 4, "bf16")
    want = mamba_scan_pallas(*j, interpret=True)
    y, h_last = ops.mamba_scan(*t)
    assert y.dtype == torch.bfloat16 and h_last.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(want), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(h_last), _h_last_f64(*t), rtol=2e-3,
                               atol=2e-3)


# ------------------------------------------------- dispatch, no fallback

def test_ops_unknown_impl_raises():
    _, a = _both(20, (8, 8))
    with pytest.raises(ValueError):
        ops.matmul(a, a, impl="bogus")
    with pytest.raises(ValueError):
        ops.flash_attention(a[None, None], a[None, None], a[None, None],
                            impl="pallas")
    _, t = _scan_inputs(1, 4, 8, 2)
    with pytest.raises(ValueError):
        ops.mamba_scan(*t, impl="bogus")


def test_ops_cuda_impl_rejects_cpu_tensors():
    _, a = _both(21, (8, 8))
    with pytest.raises(ValueError):
        ops.matmul(a, a, impl="cuda")
    _, t = _scan_inputs(1, 4, 8, 2)
    with pytest.raises(ValueError):
        ops.mamba_scan(*t, impl="cuda")


def test_wrappers_take_the_plain_version_on_cpu_without_launching():
    _, a = _both(22, (16, 32))
    _, b = _both(23, (32, 8))
    _, q = _both(24, (1, 2, 16, 64))
    _, t = _scan_inputs(1, 5, 8, 2)
    before = (tmatmul.launches, tflash.launches, tscan.launches)
    np.testing.assert_array_equal(_np(tmatmul.matmul(a, b)),
                                  _np(ref.matmul_ref(a, b)))
    np.testing.assert_array_equal(_np(tflash.flash_attention(q, q, q)),
                                  _np(ref.flash_attention_ref(q, q, q)))
    for got, want in zip(tscan.mamba_scan(*t), ref.mamba_scan_ref(*t)):
        np.testing.assert_array_equal(_np(got), _np(want))
    assert (tmatmul.launches, tflash.launches, tscan.launches) == before


def test_wrappers_refuse_mixed_devices():
    """A tensor that is not on the CPU never drops to the plain version:
    the wrapper launches the kernel or raises (here: a meta tensor)."""
    _, a = _both(25, (4, 4))
    meta = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError):
        tmatmul.matmul(a, meta)
    with pytest.raises(ValueError):
        tflash.flash_attention(meta[None, None], meta[None, None],
                               meta[None, None])
    _, t = _scan_inputs(1, 4, 4, 4)
    with pytest.raises(ValueError):
        tscan.mamba_scan(*t[:4], meta[None])
