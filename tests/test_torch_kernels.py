"""The port's kernel layer on the CPU: the plain versions (what the CPU
runs and what each CUDA kernel is held against on the card) against the
JAX package's Pallas kernels in interpret mode and its model attention,
plus the dispatch and the no-fallback rules of the wrappers. The CUDA
kernels themselves run only on the card (``python3 chip_smoke.py``)."""

import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.jacobi2d import jacobi2d_pallas  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan_pallas  # noqa: E402
from repro.kernels.matmul import matmul_pallas  # noqa: E402
from repro.kernels.stream_triad import triad_pallas  # noqa: E402
from repro.models.attention import _attend  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import jacobi2d as tjacobi  # noqa: E402
from repro_torch.kernels import mamba_scan as tscan  # noqa: E402
from repro_torch.kernels import matmul as tmatmul  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import stream_triad as ttriad  # noqa: E402

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


@pytest.mark.parametrize("mnk", [(136, 288, 264), (64, 1024, 1152),
                                 (200, 264, 520)])
def test_matmul_plain_matches_pallas_at_wgmma_route_shapes(mnk):
    """Ragged but 16-byte aligned bf16 shapes, and M at the wgmma route's
    threshold: the plain version the card holds that route against."""
    m, n, k = mnk
    aj, at = _both(30, (m, k), "bf16")
    bj, bt = _both(31, (k, n), "bf16", scale=0.02)
    want = matmul_pallas(aj, bj, interpret=True)
    got = ref.matmul_ref(at, bt)
    np.testing.assert_allclose(_np(got), _np(want), **_mm_tol("bf16"))


# the serving shapes: every projection of a layer as (tag, K, N), from the
# configs as chip_smoke.py's ``projections`` reads them
def _projections(arch):
    cfg = get_config(arch)
    d = cfg.d_model
    if cfg.attention_free:
        di = cfg.d_inner
        return cfg, [("in_proj", d, 2 * di),
                     ("x_proj", di, cfg.resolved_dt_rank + 2 * cfg.ssm_state),
                     ("dt_proj", cfg.resolved_dt_rank, di), ("out_proj", di, d)]
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    return cfg, [("wq", d, nq), ("wk", d, nkv), ("wi", d, cfg.d_ff),
                 ("attn_wo", nq, d), ("mlp_wo", cfg.d_ff, d)]


def _serve_cases():
    """(id, M, K, N, b_transposed, route) of every matmul of both served
    configs: prefill (batch 4 x 1024 tokens) and its 128-token warm-up,
    decode (M = batch = 4), and the LM head on the last position."""
    cases = []
    for arch in ("gemma3-1b", "falcon-mamba-7b"):
        cfg, proj = _projections(arch)
        for tag, k, n in proj:
            cases += [(f"{arch}-{tag}-prefill", 4 * 1024, k, n, False, "wgmma"),
                      (f"{arch}-{tag}-warmup", 4 * 128, k, n, False, "wgmma"),
                      (f"{arch}-{tag}-decode", 4, k, n, False, "decode")]
        cases.append((f"{arch}-lm_head", 4, cfg.d_model, cfg.padded_vocab,
                       cfg.tie_embeddings, "decode"))
    return cases


_ALIGNED = (0x7F0000000000, 0x7F0000100000, 0x7F0000200000)
_SERVE_CASES = _serve_cases()


@pytest.mark.parametrize("case", _SERVE_CASES, ids=[c[0] for c in _SERVE_CASES])
def test_matmul_route_of_every_serving_shape(case):
    """Prefill projections take the wgmma route; decode and the LM head
    take the decode route."""
    _, M, K, N, bt, want = case
    assert tmatmul.route(M, N, K, bt, torch.bfloat16, _ALIGNED) == want


@pytest.mark.parametrize("case", [
    # (M, K, N), b_transposed, pointers, route; bf16 unless the route is f32
    ((4100, 1160, 1032), False, _ALIGNED, "wgmma"),      # ragged, aligned
    ((136, 264, 288), False, _ALIGNED, "wgmma"),
    ((1000, 520, 2056), False, _ALIGNED, "wgmma"),
    ((64, 1152, 1024), False, _ALIGNED, "wgmma"),        # the threshold
    ((63, 1152, 1024), False, _ALIGNED, "mma_sync"),     # just below it
    ((17, 1152, 1024), False, _ALIGNED, "mma_sync"),
    ((16, 1152, 1024), False, _ALIGNED, "decode"),
    ((37, 100, 50), False, _ALIGNED, "mma_sync"),        # chip_smoke's ragged
    ((37, 100, 50), True, _ALIGNED, "mma_sync"),
    ((4, 1000, 333), True, _ALIGNED, "decode"),
    ((4096, 1152, 1024), True, _ALIGNED, "mma_sync"),    # B as (N, K)
    ((4096, 1004, 1024), False, _ALIGNED, "mma_sync"),   # K*2 not 16-byte
    ((4096, 1152, 1028), False, _ALIGNED, "mma_sync"),   # N*2 not 16-byte
    ((4096, 0, 1024), False, _ALIGNED, "mma_sync"),      # no K: no tensor map
    ((4096, 1152, 1024), False,                          # A 2 bytes off
     (_ALIGNED[0] + 2,) + _ALIGNED[1:], "mma_sync"),
    ((4096, 1152, 1024), False,                          # B 8 bytes off
     (_ALIGNED[0], _ALIGNED[1] + 8, _ALIGNED[2]), "mma_sync"),
    ((4096, 1152, 1024), False,                          # C 4 bytes off
     _ALIGNED[:2] + (_ALIGNED[2] + 4,), "mma_sync"),
    ((4, 1152, 1024), False, _ALIGNED, "f32"),           # fp32: CUDA cores
    ((4096, 4096, 16384), False, _ALIGNED, "f32"),
    ((4096, 4096, 16384), True, _ALIGNED, "f32"),
    ((130, 77, 333), False, _ALIGNED, "f32"),
    ((130, 77, 333), True, _ALIGNED, "f32"),
], ids=lambda c: f"{c[0]}-bt{int(c[1])}-{c[3]}")
def test_matmul_route_of_edge_shapes(case):
    (M, K, N), bt, ptrs, want = case
    dtype = torch.float32 if want == "f32" else torch.bfloat16
    assert tmatmul.route(M, N, K, bt, dtype, ptrs) == want


@pytest.mark.parametrize("mn_tile", [
    ((4096, 16384), 256), ((4096, 4096), 256), ((4096, 8192), 256),
    ((4096, 6912), 256), ((4096, 1024), 256), ((4096, 1152), 128),
    ((4096, 288), 128), ((4096, 256), 128), ((4100, 1032), 128),
    ((136, 288), 128), ((64, 1024), 128), ((1000, 2056), 256)])
def test_wgmma_tile_width_takes_the_fewer_waves(mn_tile):
    """On 132 SMs: 256 columns a tile unless 128 takes fewer waves of
    blocks for the same columns."""
    (M, N), want = mn_tile
    assert tmatmul.wgmma_tile_n(M, N, 132) == want
    waves = {bn: -(-(-(-M // 128) * -(-N // bn)) // 132) for bn in (128, 256)}
    other = 384 - want
    assert waves[want] * want <= waves[other] * other


# the decode cases of both served configs, and edge shapes: ragged with B
# as (N, K), M = 1 at x_proj's shape, M = 16 at mlp wo's
_DECODE_CASES = [c for c in _SERVE_CASES if c[-1] == "decode"] + [
    ("edge-4x1000x333-bt", 4, 1000, 333, True, "decode"),
    ("edge-1x8192x288", 1, 8192, 288, False, "decode"),
    ("edge-16x6912x1152", 16, 6912, 1152, False, "decode")]


@pytest.mark.parametrize("case", _DECODE_CASES,
                         ids=[c[0] for c in _DECODE_CASES])
def test_decode_split_fills_the_card_and_covers_k(case):
    """On 132 SMs: at least one block an SM; K-slices, cut as the kernel
    cuts them, that cover K once each, every one but the last a whole
    number of K-steps; no split for the LM heads."""
    name, _, K, N, _, _ = case
    split = tmatmul.decode_split(N, K, 132)
    assert math.ceil(N / tmatmul.decode_tile_n(N, K)) * split >= 132
    step = tmatmul.DECODE_STEP_K
    per = math.ceil(math.ceil(K / step) / split) * step
    slices = [(i * per, min(K, (i + 1) * per)) for i in range(split)]
    assert all(lo < hi for lo, hi in slices)
    assert slices[0][0] == 0 and slices[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert all((hi - lo) % step == 0 for lo, hi in slices[:-1])
    if name.endswith("lm_head"):
        assert split == 1


@pytest.mark.parametrize("sms", [132, 114, 78])
def test_decode_split_fits_the_scratch(sms):
    """Any shape: a split grid has fewer tiles than SMs and needs no more
    workspace than the wrapper makes once per device (split x N <
    (DECODE_WAVES + 1) x sms x 64 fp32 rows of M <= 16), and every slice
    holds K-steps."""
    for N in range(1, 20000, 37):
        for K in (1, 63, 64, 65, 1000, 8190, 30000):
            split = tmatmul.decode_split(N, K, sms)
            steps = math.ceil(K / tmatmul.DECODE_STEP_K)
            assert 1 <= split <= steps
            assert (split - 1) * math.ceil(steps / split) < steps
            if split > 1:
                assert math.ceil(N / tmatmul.decode_tile_n(N, K)) < sms
                assert split * N < (tmatmul.DECODE_WAVES + 1) * sms * 64


@pytest.mark.parametrize("nk_tile", [
    ((16384, 4096), 64), ((4096, 8192), 64), ((65024, 4096), 64),
    ((262144, 1152), 64), ((288, 8192), 32), ((8192, 256), 32),
    ((1152, 6912), 32), ((6912, 1152), 32), ((1024, 1152), 32),
    ((333, 1000), 32)])
def test_decode_tile_width(nk_tile):
    """64 columns a tile for weights of 32 MiB and more (falcon-mamba-7b's
    in_proj and out_proj, both LM heads), else 32."""
    (N, K), want = nk_tile
    assert tmatmul.decode_tile_n(N, K) == want


@pytest.mark.parametrize("which, dtype, bt", [
    ("f32", torch.bfloat16, False), ("decode", torch.float32, False),
    ("decode", torch.bfloat16, False),
    ("mma_sync", torch.float32, False), ("wgmma", torch.bfloat16, True),
    ("wgmma", torch.float32, False)])
def test_matmul_launch_refuses_a_route_that_cannot_take_the_operands(
        which, dtype, bt):
    """Checked before anything is built or launched."""
    a = torch.zeros((128, 64), dtype=dtype)
    b = torch.zeros((64, 64), dtype=dtype)
    out = torch.empty((128, 64), dtype=dtype)
    before = tmatmul.launches, dict(tmatmul.route_launches), tmatmul._fn
    with pytest.raises(ValueError):
        tmatmul.launch(a, b, out, which, b_transposed=bt)
    assert (tmatmul.launches, tmatmul.route_launches, tmatmul._fn) == before


def test_matmul_module_imports_without_a_cuda_toolkit():
    """Importing the wrapper and choosing a route, a decode tile and a
    split build nothing: no nvcc on PATH and no CUDA_HOME."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)
    code = ("import torch\n"
            "from repro_torch.kernels import build, matmul\n"
            "r = matmul.route(4096, 1024, 1152, False, torch.bfloat16, (0, 16, 32))\n"
            "assert r == 'wgmma' and not build._loaded and matmul._fn is None\n"
            "assert matmul.decode_split(288, 8192, 132) > 1\n"
            "assert matmul.decode_tile_n(288, 8192) == 32\n"
            "assert not build._loaded and matmul._fn is None and not matmul._scratch\n"
            "assert matmul.launches == 0 and set(matmul.route_launches.values()) == {0}\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


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


def _meta_operands(B, H, KV, S, T, D, model_layout=False):
    """q, k, v as metadata only (no storage): (B,H,S,D) and (B,KV,T,D), or
    in the model's layout, (B,S,H,D) and (B,T,KV,D) tensors transposed."""
    def make(b, h, n):
        if model_layout:
            return torch.empty((b, n, h, D), dtype=torch.bfloat16,
                               device="meta").transpose(1, 2)
        return torch.empty((b, h, n, D), dtype=torch.bfloat16, device="meta")
    return make(B, H, S), make(B, KV, T), make(B, KV, T)


def _flash_route_cases():
    """(id, (B, H, KV, S, T, D), window, model layout, route): gemma3-1b's
    prefill calls at full width (4 x 1024 tokens, local and global), the
    shapes chip_smoke.py's flash phase gives each route, the reduced
    config's."""
    full, red = get_config("gemma3-1b"), get_reduced("gemma3-1b")
    hd = full.resolved_head_dim
    cases = [(f"gemma3-1b-{kind}", (4, full.n_heads, full.n_kv_heads, 1024,
                                    1024, hd), window, True, "wgmma")
             for kind, window in (("local", full.sliding_window),
                                  ("global", 0))]
    cases += [(f"pallas-{s}x{t}-d{d}", (b, h, h, s, t, d), 0, False, "wgmma")
              for b, h, s, t, d in ((1, 2, 256, 256, 64), (2, 4, 512, 512, 128),
                                    (1, 2, 384, 256, 64), (1, 2, 256, 384, 64))]
    cases += [("ragged-d256", (1, 2, 2, 1000, 1100, 256), 300, False, "wgmma"),
              ("gqa-4to1-d256", (2, 8, 2, 1000, 1000, 256), 512, True, "wgmma"),
              ("reduced", (2, red.n_heads, red.n_kv_heads, 37, 37,
                           red.resolved_head_dim), red.sliding_window, False,
               "mma_sync"),
              ("d32", (2, 4, 1, 200, 200, 32), 50, True, "mma_sync")]
    return cases


_FLASH_ROUTE_CASES = _flash_route_cases()


@pytest.mark.parametrize("case", _FLASH_ROUTE_CASES,
                         ids=[c[0] for c in _FLASH_ROUTE_CASES])
def test_flash_route_of_every_checked_shape(case):
    """The operands pass the wrapper's checks as given (model layout
    included), and the route follows D alone: wgmma from D = 64, where a
    row fills the 128-byte swizzle, mma_sync below. Choosing builds
    nothing."""
    _, shape, window, layout, want = case
    q, k, v = _meta_operands(*shape, model_layout=layout)
    assert tflash.check_operands(q, k, v, window) == shape
    assert tflash.route(shape[-1], q.dtype) == want
    assert tflash._fn is None


@pytest.mark.parametrize("D", tflash.WGMMA_HEAD_DIMS)
def test_flash_wgmma_smem_plan_fits_an_sm(D):
    """Q (128 rows), a ring of at least 2 stages of 64-key K and V tiles,
    the alignment slack and the mbarriers fit the 227 KB a block may use,
    and every tile is whole 1024-byte swizzle atoms."""
    stages = tflash.wgmma_stages(D)
    assert stages >= 2
    assert tflash.wgmma_smem_bytes(D) <= tflash.SMEM_LIMIT == 227 * 1024
    assert (tflash.WGMMA_BQ * D * 2) % 1024 == 0
    assert (tflash.WGMMA_BKV * D * 2) % 1024 == 0
    if D == 256:  # 64 KB of Q, 2 x (32 KB of K + 32 KB of V)
        assert tflash.wgmma_smem_bytes(D) == 65536 + 2 * 65536 + 1024 + 8 * 9


def _misaligned(shape):
    flat = torch.zeros(math.prod(shape) + 8, dtype=torch.bfloat16)
    return flat[1:1 + math.prod(shape)].view(shape)


@pytest.mark.parametrize("case", [
    ("fp32", lambda: [torch.zeros((1, 2, 8, 16))] * 3, 0, "takes bf16"),
    ("q-3d", lambda: [torch.zeros((2, 8, 16), dtype=torch.bfloat16)]
     + [torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16)] * 2, 0, "bad shapes"),
    ("k-ne-v", lambda: [torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16),
                        torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16),
                        torch.zeros((1, 2, 9, 16), dtype=torch.bfloat16)],
     0, "bad shapes"),
    ("batch", lambda: [torch.zeros((2, 2, 8, 16), dtype=torch.bfloat16)]
     + [torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16)] * 2, 0,
     "does not match"),
    ("head-dim", lambda: [torch.zeros((1, 2, 8, 32), dtype=torch.bfloat16)]
     + [torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16)] * 2, 0,
     "does not match"),
    ("h-mod-kv", lambda: [torch.zeros((1, 3, 8, 16), dtype=torch.bfloat16)]
     + [torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16)] * 2, 0,
     "does not match"),
    ("d48", lambda: [torch.zeros((1, 2, 8, 48), dtype=torch.bfloat16)] * 3, 0,
     "takes D in"),
    ("window", lambda: [torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16)] * 3,
     -1, "window < 0"),
    ("grid", lambda: [torch.empty((1, 65536, 8, 16), dtype=torch.bfloat16,
                                  device="meta")] * 3, 0, "65535"),
    ("d-stride", lambda: [torch.zeros((1, 2, 16, 8), dtype=torch.bfloat16
                                      ).transpose(2, 3)] * 3, 0,
     "contiguous along D"),
    ("misaligned", lambda: [_misaligned((1, 2, 8, 16))]
     + [torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16)] * 2, 0,
     "16-byte aligned rows"),
    ("row-stride", lambda: [torch.zeros((1, 2, 8, 20), dtype=torch.bfloat16
                                        )[..., :16]] * 3, 0,
     "16-byte aligned rows"),
], ids=lambda c: c[0])
def test_flash_checks_raise_as_before(case):
    """What the kernel does not take raises ValueError with the messages
    the wrapper has always given, whatever the route; nothing is built."""
    _, make, window, match = case
    q, k, v = make()
    with pytest.raises(ValueError, match=match):
        tflash.check_operands(q, k, v, window)
    assert tflash._fn is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("D", tflash.HEAD_DIMS)
def test_flash_bwd_route_of_every_head_dim(D, dtype):
    """The backward kernel's route follows D and the dtype alone, before
    any launch: wgmma for bf16 rows that fill the 128-byte swizzle (D =
    64, 128, 256), mma_sync below; every route is one of BWD_ROUTES, and
    choosing builds nothing."""
    want = "wgmma" if dtype == torch.bfloat16 and D >= 64 else "mma_sync"
    assert tflash.bwd_route(D, dtype) == want
    assert set(tflash.BWD_ROUTES) == {"wgmma", "mma_sync"}
    assert tflash._bwd_fn is None


def _bwd_csrc() -> str:
    path = os.path.join(os.path.dirname(tflash.__file__), "csrc",
                        "flash_attention_bwd.cu")
    with open(path) as f:
        return f.read()


def test_flash_bwd_entry_point_takes_the_routes_by_their_index():
    """The C entry point's cases are route index x 1000 + D for exactly
    the (route, D) pairs ``bwd_route`` picks for bf16."""
    cases = set(re.findall(r"REPRO_FA_BWD\((launch_\w+), (\d+), (\d+)\)",
                           _bwd_csrc()))
    want = set()
    for D in tflash.HEAD_DIMS:
        which = tflash.bwd_route(D, torch.bfloat16)
        fn = "launch_wgmma" if which == "wgmma" else "launch_mma"
        want.add((fn, str(D), str(tflash.BWD_ROUTES.index(which) * 1000 + D)))
    assert cases == want


@pytest.mark.parametrize("D", tflash.WGMMA_HEAD_DIMS)
def test_flash_bwd_wgmma_smem_plan_fits_an_sm(D):
    """A wgmma-route backward block in either role (dK/dV: K and V, a ring
    of at least 2 stages of Q and dO tiles with their lse and Delta rows;
    dQ: Q and dO of 128 rows, a ring of at least 2 stages of K and V
    tiles), with the alignment slack and both roles' mbarriers, fits the
    227 KB a block may use, and every tile is whole 1024-byte swizzle
    atoms; at D = 256 the dK/dV role's consumers share 64 keys and dQ's
    stages hold 32."""
    plan = tflash.bwd_wgmma_plan(D)
    smem = tflash.bwd_wgmma_smem_bytes(D)
    assert plan["dkv_stages"] >= 2 and plan["dq_stages"] >= 2
    assert smem["block"] <= tflash.SMEM_LIMIT == 227 * 1024
    assert smem["block"] >= max(smem["dkv"], smem["dq"])
    for rows in (plan["dkv_keys"], 64, tflash.WGMMA_BQ, plan["dq_keys"]):
        assert (rows * D * 2) % 1024 == 0
    assert plan["dkv_keys"] % 64 == 0 and plan["dq_keys"] % 16 == 0
    if D == 256:
        assert (plan["dkv_keys"], plan["dq_keys"]) == (64, 32)
        # K, V 64 KB; 2 x (Q, dO 64 KB + lse, Delta 512 B); 2 x (K, V 32 KB)
        assert smem == dict(dkv=65536 + 2 * (65536 + 512) + 1024,
                            dq=131072 + 2 * 32768 + 1024,
                            block=65536 + 2 * (65536 + 512) + 1024 + 8 * 10)


@pytest.mark.parametrize("S,want", [(1, 2 * 3 * 5 * 64), (64, 2 * 3 * 5 * 64),
                                    (65, 2 * 3 * 5 * 128),
                                    (6404, 2 * 3 * 5 * 6464)])
def test_flash_bwd_scratch_pads_rows_to_whole_tiles_on_wgmma(S, want):
    """The wgmma route's Delta and lse rows are padded to 64 a head, so
    that every 64-row tile's bulk copy reads inside the scratch; the
    mma_sync route keeps one Delta a row."""
    assert tflash.bwd_scratch_floats(3, 5, S, "wgmma") == want
    assert tflash.bwd_scratch_floats(3, 5, S, "mma_sync") == 3 * 5 * S


def _bwd_meta(B, H, KV, S, T, D, o=None, do=None, lse=None):
    q, k, v = _meta_operands(B, H, KV, S, T, D, model_layout=True)
    o = torch.empty((B, H, S, D), dtype=torch.bfloat16, device="meta") \
        if o is None else o
    do = q if do is None else do
    lse = torch.empty((B, H, S), dtype=torch.float32, device="meta") \
        if lse is None else lse
    return q, k, v, o, lse, do


@pytest.mark.parametrize("case", [
    # (id, shape (B, H, KV, S, T, D), route) as chip_smoke.py's BWD_CASES
    ("granite-3-2b", (2, 32, 8, 1024, 1024, 64), "wgmma"),
    ("gemma3-1b-local", (2, 4, 1, 1024, 1024, 256), "wgmma"),
    ("vlm-cross", (2, 32, 8, 1024, 6404, 128), "wgmma"),
    ("reduced", (2, 4, 2, 100, 100, 16), "mma_sync"),
    ("d32", (1, 4, 2, 100, 150, 32), "mma_sync"),
], ids=lambda c: c[0])
def test_flash_bwd_checks_take_the_model_operands(case):
    """The backward wrapper's checks take the model's operands (q, k, v
    transposed views, o and do of q's shape) on the route each shape
    takes; nothing is built."""
    _, shape, want = case
    ops_ = _bwd_meta(*shape)
    assert tflash.check_bwd_operands(*ops_, window=0) == shape
    assert tflash.bwd_route(shape[-1], ops_[0].dtype) == want
    assert tflash._bwd_fn is None


@pytest.mark.parametrize("D", [64, 16], ids=["wgmma", "mma_sync"])
@pytest.mark.parametrize("case", [
    ("o-shape", dict(o=(1, 2, 9, None)), "must match q"),
    ("o-dtype", dict(o_dtype=torch.float32), "must match q"),
    ("do-shape", dict(do=(1, 2, 8, None, 1)), "must match q"),
    ("lse-dtype", dict(lse_dtype=torch.bfloat16), "lse must be fp32"),
    ("lse-shape", dict(lse=(1, 2, 9)), "lse must be fp32"),
    ("q-fp32", dict(q_dtype=torch.float32), "takes bf16"),
    ("misaligned-q", dict(misaligned=True), "16-byte aligned rows"),
    ("window", dict(window=-1), "window < 0"),
], ids=lambda c: c[0])
def test_flash_bwd_checks_raise_on_what_the_route_cannot_take(case, D):
    """What neither route takes raises ValueError before any build: o or
    do unlike q, lse not fp32 (B, H, S), q not bf16, rows not 16-byte
    aligned (TMA's and the loads' rule), a negative window."""
    _, bad, match = case
    B, H, KV, S, T = 1, 2, 2, 8, 8
    q = torch.zeros((B, H, S, D), dtype=bad.get("q_dtype", torch.bfloat16))
    if bad.get("misaligned"):
        q = _misaligned((B, H, S, D))
    k = torch.zeros((B, KV, T, D), dtype=torch.bfloat16)
    o = torch.zeros(tuple(x if x else D for x in bad.get("o", (B, H, S, D))),
                    dtype=bad.get("o_dtype", torch.bfloat16))
    do = torch.zeros(tuple(x if x else D for x in bad.get("do", (B, H, S, D))),
                     dtype=torch.bfloat16)
    lse = torch.zeros(bad.get("lse", (B, H, S)),
                      dtype=bad.get("lse_dtype", torch.float32))
    with pytest.raises(ValueError, match=match):
        tflash.check_bwd_operands(q, k, k, o, lse, do, bad.get("window", 0))
    assert tflash._bwd_fn is None


def test_flash_bwd_wrapper_raises_off_the_cpu_without_a_card():
    """Operands that are not all on the CPU must all be on one CUDA
    device: meta tensors raise ValueError instead of taking the plain
    version, and nothing is built or counted."""
    tflash.bwd_launches = 0
    tflash.bwd_route_launches.update(dict.fromkeys(tflash.BWD_ROUTES, 0))
    for D in (64, 16):
        with pytest.raises(ValueError, match="one CUDA device"):
            tflash.flash_attention_bwd(*_bwd_meta(1, 4, 2, 64, 64, D))
    assert tflash.bwd_launches == 0
    assert tflash.bwd_route_launches == {"wgmma": 0, "mma_sync": 0}
    assert tflash._bwd_fn is None


def test_flash_bwd_source_has_no_atomics():
    """Every block of the backward kernel owns the rows it writes: the
    source and the headers it includes hold no atomic operation and no
    reducing store or copy (``red.``, ``cp.reduce``), on either route, so
    two calls give the same bits."""
    csrc = os.path.join(os.path.dirname(tflash.__file__), "csrc")
    src = _bwd_csrc()
    heads = re.findall(r'#include "(\w+\.cuh)"', src)
    assert set(heads) == {"mma_bf16.cuh", "sm90.cuh"}
    for text in [src] + [open(os.path.join(csrc, h)).read() for h in heads]:
        assert "atomic" not in text.lower()
        assert not re.search(r"\bred\.|cp\.reduce", text)


def test_flash_cpu_tensors_take_the_plain_version_on_every_route_shape():
    """CPU tensors at a wgmma-route D (model layout, GQA, a window) and at
    an mma_sync-route D give the plain version's bits and count no launch,
    on either route."""
    tflash.launches = 0
    tflash.route_launches.update(dict.fromkeys(tflash.ROUTES, 0))
    for D, window in ((64, 5), (16, 0)):
        _, q = _both(26, (2, 12, 4, D), "bf16", D ** -0.5)
        _, k = _both(27, (2, 12, 2, D), "bf16")
        _, v = _both(28, (2, 12, 2, D), "bf16")
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
        got = tflash.flash_attention(q, k, v, True, window, 1.0)
        np.testing.assert_array_equal(
            _np(got), _np(ref.flash_attention_ref(q, k, v, True, window, 1.0)))
    assert tflash.launches == 0
    assert tflash.route_launches == {"mma_sync": 0, "wgmma": 0}
    assert tflash._fn is None


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


# (tag, Bt, S, D, N): the falcon-mamba-7b serving shape and its reduced
# config's, the scan cases of chip_smoke.scan_phase, a D that is no
# multiple of the channels a block, S = 1 and S no multiple of the time
# tile, Bt = 1, and every N from 1 to 64
_SCAN_PLAN_CASES = [
    ("falcon-mamba-7b", 4, 1024, 8192, 16), ("reduced", 2, 24, 128, 4),
    ("pallas", 1, 128, 512, 16), ("pallas", 2, 256, 1024, 16),
    ("pallas", 2, 128, 640, 8), ("ragged", 1, 1000, 512, 16),
    ("ragged", 2, 37, 640, 4), ("ragged", 3, 200, 384, 8),
    ("N=1", 2, 300, 640, 1), ("N=32", 2, 200, 512, 32),
    ("N=64", 1, 100, 384, 64), ("Bt>65535", 65537, 2, 16, 4),
    ("ragged D", 2, 250, 8190, 16), ("long S", 1, 4096, 1024, 16),
    ("N=64 model", 2, 64, 8192, 64), ("D=100", 1, 64, 100, 16),
    ("S=1", 1, 1, 8192, 16), ("S=33", 3, 33, 64, 16),
] + [(f"N={n}", 2, 50, 300, n) for n in range(1, 65)]


def _scan_csrc() -> str:
    path = os.path.join(os.path.dirname(tscan.__file__), "csrc", "mamba_scan.cu")
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("x_bytes", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", _SCAN_PLAN_CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}x{c[4]}"
                              for c in _SCAN_PLAN_CASES])
def test_mamba_scan_plan(case, x_bytes):
    """The padded width holds N in whole lanes; the grid covers every
    (batch, channel) pair exactly once, batch-major as the kernel reads
    blockIdx.x; the time tile is whole groups of 8 steps and of the lanes;
    the ring's shared memory fits what a block may use, and the planned
    resident blocks fit an SM's shared memory and warps."""
    _, Bt, S, D, N = case
    p = tscan.plan(Bt, S, D, N, x_bytes)
    assert p.np in (4, 8, 16, 32, 64) and p.np >= N and p.np // 2 < max(N, 4)
    assert p.lanes * p.states_per_lane == p.np and 32 % p.lanes == 0
    assert p.channels * p.lanes == tscan.CONSUMERS
    assert p.threads == tscan.CONSUMERS + 32 and p.threads % 32 == 0
    nblk = -(-D // p.channels)
    assert p.grid == Bt * nblk <= tscan.MAX_GRID
    blocks = np.arange(p.grid)
    b, d0 = blocks // nblk, (blocks % nblk) * p.channels
    d = d0[:, None] + np.arange(p.channels)[None, :]
    pairs = (b[:, None] * D + d)[d < D]
    assert np.array_equal(np.bincount(pairs, minlength=Bt * D),
                          np.ones(Bt * D, dtype=np.int64))
    assert p.time_tile % 8 == 0 and p.time_tile % p.lanes == 0
    assert p.time_tile <= 32 and p.stages >= 2
    stage = p.time_tile * (p.channels * 4 + p.channels * x_bytes
                           + 2 * p.np * 4)   # dt, x, B and C of a tile
    assert p.smem_bytes == p.stages * (stage + 16)   # + two mbarriers
    assert p.smem_bytes <= 227 * 1024
    assert p.resident * (p.smem_bytes + 1024) <= 228 * 1024
    assert p.resident * p.threads // 32 <= 64


def test_mamba_scan_plan_takes_the_deepest_ring_that_fits():
    """At the model's shape: 4 lanes of 4 states, 64 channels and 3 stages
    of 32 steps a block, 512 blocks; fp32 x has room for 2 stages."""
    p = tscan.plan(4, 1024, 8192, 16, 2)
    assert (p.lanes, p.states_per_lane, p.channels, p.time_tile, p.stages,
            p.grid) == (4, 4, 64, 32, 3, 512)
    assert tscan.plan(4, 1024, 8192, 16, 4).stages == 2
    assert tscan.plan(2, 24, 128, 4, 2).time_tile == 16   # cut to S


def test_mamba_scan_plan_matches_the_instances_in_csrc():
    """Every plan names a (NP, SPL) instance the C side instantiates, and
    the C side's constants are the plan's."""
    src = _scan_csrc()
    instances = {(int(a), int(b)) for a, b in
                 re.findall(r"REPRO_SCAN\((\d+), (\d+)\)\n", src)}
    assert {(tscan.plan(1, 8, 64, n, 2).np, tscan.STATES_PER_LANE)
            for n in range(1, tscan.MAX_N + 1)} == instances
    for name, value in (("CONSUMERS", tscan.CONSUMERS),
                        ("RESIDENT", tscan.RESIDENT),
                        ("SMEM_BLOCK", tscan.SMEM_BLOCK)):
        assert re.search(rf"constexpr int {name} = {value};", src), name


def _scan_meta(Bt, S, D, N, x_dtype=torch.bfloat16):
    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    return (t(Bt, S, D), t(D, N), t(Bt, S, N), t(Bt, S, N),
            t(Bt, S, D, dtype=x_dtype))


def test_mamba_scan_checks_take_more_than_65535_batch_rows():
    """Batch is folded into the grid's x dimension: 70 000 rows pass the
    checks, with one block a batch row at D = 64; a grid past 2^31 - 1
    blocks raises. Nothing is built."""
    p = tscan.check_operands(*_scan_meta(70000, 8, 64, 16))
    assert p == tscan.plan(70000, 8, 64, 16, 2) and p.grid == 70000
    with pytest.raises(ValueError, match="exceed the grid"):
        tscan.check_operands(*_scan_meta(2 ** 31, 1, 1, 4))
    assert tscan._fn is None


@pytest.mark.parametrize("case", [
    ("fp16 x", lambda: _scan_meta(1, 4, 8, 4, torch.float16), "fp32 or bf16"),
    ("bf16 dt", lambda: (torch.empty((1, 4, 8), dtype=torch.bfloat16,
                                     device="meta"),) + _scan_meta(1, 4, 8, 4)[1:],
     "fp32 or bf16"),
    ("2-d x", lambda: _scan_meta(1, 4, 8, 4)[:4]
     + (torch.empty((4, 8), dtype=torch.bfloat16, device="meta"),), "bad shapes"),
    ("A rows", lambda: (lambda m: (m[0], torch.empty((9, 4), device="meta"))
                        + m[2:])(_scan_meta(1, 4, 8, 4)), "do not match"),
    ("N=0", lambda: _scan_meta(1, 4, 8, 0), "1 <= N"),
    ("N=65", lambda: _scan_meta(1, 4, 8, 65), "1 <= N"),
    ("strided", lambda: (lambda m: m[:4] + (
        torch.empty((1, 8, 4), dtype=torch.bfloat16,
                    device="meta").transpose(1, 2),))(_scan_meta(1, 4, 8, 4)),
     "contiguous"),
], ids=lambda c: c[0])
def test_mamba_scan_checks_raise(case):
    """What the kernel does not take raises ValueError before anything is
    built or launched."""
    _, make, match = case
    before = tscan.launches
    with pytest.raises(ValueError, match=match):
        tscan.check_operands(*make())
    assert tscan.launches == before and tscan._fn is None


def test_mamba_scan_module_plans_without_a_cuda_toolkit():
    """Importing the wrapper and planning a launch build nothing: no nvcc
    on PATH and no CUDA_HOME."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)
    code = ("from repro_torch.kernels import build, mamba_scan\n"
            "p = mamba_scan.plan(4, 1024, 8192, 16, 2)\n"
            "assert (p.lanes, p.channels, p.grid) == (4, 64, 512)\n"
            "assert not build._loaded and mamba_scan._fn is None\n"
            "assert mamba_scan.launches == 0\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ------------------------------------------------------- mamba scan backward

def _scan_bwd_csrc() -> str:
    path = os.path.join(os.path.dirname(tscan.__file__), "csrc",
                        "mamba_scan_bwd.cu")
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("dims", [(2, 37, 24, 4), (1, 200, 16, 16),
                                  (3, 9, 8, 1), (2, 17, 12, 3)])
@pytest.mark.parametrize("with_dh", [False, True], ids=["no-dh", "dh"])
def test_mamba_scan_bwd_ref_matches_autograd(dims, with_dh):
    """The written-out backward pass against torch autograd of
    ``mamba_scan_ref``, fp32, with and without a gradient on h_last: the
    same arithmetic in another order (1e-5)."""
    Bt, S, D, N = dims
    _, t = _scan_inputs(*dims)
    rng = np.random.default_rng(4)
    dy = torch.from_numpy(rng.standard_normal((Bt, S, D)).astype(np.float32))
    dh = torch.from_numpy(rng.standard_normal((Bt, D, N)).astype(np.float32))
    ins = [a.clone().requires_grad_() for a in t]
    y, h_last = ref.mamba_scan_ref(*ins)
    outs, cots = ((y, h_last), (dy, dh)) if with_dh else ((y,), (dy,))
    want = torch.autograd.grad(outs, ins, cots)
    got = ref.mamba_scan_bwd_ref(*t, dy, dh if with_dh else None)
    for name, g, w, a in zip(("d_dt", "dA", "dB", "dC", "dx"), got, want, t):
        assert g.dtype == a.dtype and g.shape == a.shape, name
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()),
                                   err_msg=name)


def test_mamba_scan_bwd_ref_takes_bf16_x():
    """x and dy in bf16 as the model hands them over: dx comes back in
    bf16, the rest in fp32, each within one bf16 rounding of the fp32
    run on the same values."""
    _, t = _scan_inputs(2, 40, 16, 4, "bf16")
    dy = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 40, 16)).astype(np.float32)).to(torch.bfloat16)
    got = ref.mamba_scan_bwd_ref(*t, dy)
    want = ref.mamba_scan_bwd_ref(*t[:4], t[4].float(), dy.float())
    assert [g.dtype for g in got] == [torch.float32] * 4 + [torch.bfloat16]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-2,
                                   atol=1e-2 * float(w.abs().max()))


def _segmented_scan_bwd(dt, A, B, C, x, dy, dh_last, seg_len, piece_len=None,
                        carries=True):
    """The backward kernel's split of time written out in plain PyTorch,
    fp32: S cut into segments of ``seg_len`` steps and into pieces of
    ``piece_len`` (dividing ``seg_len``; by default a segment each); the
    pre-pass's carry r0 that each piece after the first segment hands back
    from no carry in, sum_t exp(A cs_t) dy_t C_t with cs_t the sum of dt
    over the piece up to t, and its sum of dt; each segment's carry from
    the pieces after it folded in, the last first, R = r0 + exp(A sum dt)
    R, from dh_last (or 0); then each segment run back from its carry
    alone, its dA summed with the others'. ``carries=False`` drops every
    carry but dh_last."""
    Bt, S, D = x.shape
    N = A.shape[1]
    piece_len = piece_len or seg_len
    assert seg_len % piece_len == 0
    dyf, xf = dy.float(), x.float()
    hs = [torch.zeros((Bt, D, N))]   # hs[t + 1] = h_t
    for t in range(S):
        hs.append(torch.exp(dt[:, t, :, None] * A) * hs[-1]
                  + (dt[:, t] * xf[:, t])[..., None] * B[:, t, None, :])
    r0, sdt = {}, {}
    for p0 in range(seg_len, S, piece_len):
        cs = torch.cumsum(dt[:, p0:p0 + piece_len], 1)       # (Bt, L, D)
        dyc = dyf[:, p0:p0 + piece_len, :, None] * C[:, p0:p0 + piece_len,
                                                       None, :]
        r0[p0] = (torch.exp(cs[..., None] * A) * dyc).sum(1)
        sdt[p0] = cs[:, -1]
    d_dt, dx = torch.empty((Bt, S, D)), torch.empty((Bt, S, D))
    dB, dC = torch.empty((Bt, S, N)), torch.empty((Bt, S, N))
    dA = torch.zeros((D, N))
    for t0 in range(0, S, seg_len):
        r = torch.zeros((Bt, D, N)) if dh_last is None else dh_last.clone()
        if carries:
            for p0 in sorted((p for p in r0 if p >= t0 + seg_len),
                             reverse=True):
                r = r0[p0] + torch.exp(sdt[p0][..., None] * A) * r
        elif t0 + seg_len < S:
            r = torch.zeros((Bt, D, N))
        for t in reversed(range(t0, min(t0 + seg_len, S))):
            a = torch.exp(dt[:, t, :, None] * A)
            g = dyf[:, t, :, None] * C[:, t, None, :] + r
            r = a * g
            gah = r * hs[t]
            dC[:, t] = torch.einsum("bd,bdn->bn", dyf[:, t], hs[t + 1])
            dB[:, t] = torch.einsum("bdn,bd->bn", g, dt[:, t] * xf[:, t])
            du = torch.einsum("bdn,bn->bd", g, B[:, t])
            d_dt[:, t] = torch.einsum("bdn,dn->bd", gah, A) + xf[:, t] * du
            dx[:, t] = dt[:, t] * du
            dA += (gah * dt[:, t, :, None]).sum(0)
    return d_dt, dA, dB, dC, dx


@pytest.mark.parametrize("case", [
    ((2, 200, 8, 4), 64, 64),    # 64-step segments that do not divide S
    ((1, 192, 8, 16), 64, 16),   # ... and that do, in 16-step pieces
    ((2, 100, 6, 3), 100, 100),  # one segment
    ((2, 100, 6, 3), 256, 64),   # one segment longer than S
    ((1, 40, 8, 4), 1, 1),       # a segment a step: more than chunks allow
    ((3, 37, 5, 8), 8, 4),       # half-chunk segments, S ragged
    ((1, 160, 4, 16), 32, 8),    # pieces of a quarter segment
], ids=lambda c: f"{'x'.join(map(str, c[0]))}-seg{c[1]}-piece{c[2]}")
@pytest.mark.parametrize("with_dh", [False, True], ids=["no-dh", "dh"])
def test_mamba_scan_bwd_segmented_matches_the_plain_version(case, with_dh):
    """The kernel's split of time, written out in plain PyTorch (the
    pre-pass's carries and sums of dt a piece, the pieces after a segment
    folded in, each segment from its carry) against
    ``ref.mamba_scan_bwd_ref``, fp32, rtol 1e-5: a piece's decays as
    exp(A cs_t) and exp(A sum dt) in place of products of its steps'
    decays. dt near falcon-mamba-7b's (softplus(0.5 z - 4.6) ~
    0.01), so a carry reaches across about 100 steps; where there is more
    than one segment, dropping the carries must fail the same check."""
    (Bt, S, D, N), seg_len, piece_len = case
    rng = np.random.default_rng(S + seg_len)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    dt = torch.nn.functional.softplus(0.5 * normal(Bt, S, D) - 4.6)
    A = -torch.exp(0.3 * normal(D, N))
    B, C, x, dy = (normal(Bt, S, N), normal(Bt, S, N), normal(Bt, S, D),
                   normal(Bt, S, D))
    dh = normal(Bt, D, N) if with_dh else None
    want = ref.mamba_scan_bwd_ref(dt, A, B, C, x, dy, dh)
    got = _segmented_scan_bwd(dt, A, B, C, x, dy, dh, seg_len, piece_len)
    for name, g, w in zip(("d_dt", "dA", "dB", "dC", "dx"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()),
                                   err_msg=name)
    if seg_len < S:
        cut = _segmented_scan_bwd(dt, A, B, C, x, dy, dh, seg_len, piece_len,
                                  carries=False)
        assert not all(np.allclose(_np(g), _np(w), rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()))
                       for g, w in zip(cut, want))


@pytest.mark.parametrize("x_bytes", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", _SCAN_PLAN_CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}x{c[4]}"
                              for c in _SCAN_PLAN_CASES])
def test_mamba_scan_bwd_plan(case, x_bytes):
    """The backward kernels' plan: the forward's lanes, BWD_THREADS
    threads a block and its channels; segments of whole CHUNK-step chunks
    that cover S, none empty: as many as fill every SM's resident blocks
    about once (at most a segment a chunk), then evened out, so no more
    than that; sums every half chunk; registers bounded for 4 blocks an
    SM where 4 fit in shared memory, else 2; the grid a block a (batch
    row, channel block, segment); the pre-pass's pieces of at most PIECE
    chunks that divide a segment, a block each but those of the first
    segment; two stages of a chunk's inputs, each half-chunk's sums and
    STASH steps of decays in shared memory, for at least 2 blocks an SM;
    the workspace: a (Bt, S, 2, NP) slice of dB and dC partials a channel
    block, a (D, NP) slice of dA a (batch row, segment), the carries and
    sums of dt a piece; the summing kernel a block of SUM_OUT outputs;
    the chunk states (Bt, ceil(S / 16), D, NP)."""
    _, Bt, S, D, N = case
    p = tscan.plan_bwd(Bt, S, D, N, x_bytes)
    f = tscan.plan(Bt, S, D, N, x_bytes)
    assert (p.np, p.lanes, p.states_per_lane) == (f.np, f.lanes,
                                                  f.states_per_lane)
    assert p.threads == tscan.BWD_THREADS == 128
    assert p.channels * p.lanes == p.threads
    assert p.blocks_d == -(-D // p.channels)
    assert p.chunk == tscan.CHUNK == 16 and p.sum_steps == tscan.SUM_STEPS == 8
    assert p.blocks in tscan.BWD_BLOCKS == (2, 4)
    assert p.chunks * p.chunk >= S > (p.chunks - 1) * p.chunk
    assert p.seg_chunks * p.segments >= p.chunks \
        > p.seg_chunks * (p.segments - 1)
    rows = Bt * p.blocks_d
    want = min(max(p.chunks, 1),
               max(1, round(tscan.SMS * p.resident / rows + 1e-9)))
    assert p.seg_chunks == -(-max(p.chunks, 1) // want) and p.segments <= want
    assert p.grid == rows * p.segments
    assert 1 <= p.piece_chunks <= tscan.PIECE
    assert p.seg_chunks % p.piece_chunks == 0
    assert all(p.seg_chunks % c for c in range(p.piece_chunks + 1,
                                               tscan.PIECE + 1))
    assert p.pieces * p.piece_chunks >= max(p.chunks, 1) \
        > (p.pieces - 1) * p.piece_chunks
    assert p.pre_grid == rows * (p.pieces - p.seg_chunks // p.piece_chunks)
    assert (p.pre_grid == 0) == (p.segments == 1)
    stage = (p.chunk * (p.channels * (4 + 2 * x_bytes) + 2 * p.np * 4)
             + p.channels * p.np * 4)
    part = p.sum_steps * 2 * (p.threads // 32 * p.np + p.threads) * 4
    stash = tscan.STASH * p.threads * p.states_per_lane * 4
    assert p.smem_bytes == 2 * stage + 2 * part + stash <= 227 * 1024
    fit = 228 * 1024 // (p.smem_bytes + 1024)
    assert p.blocks == (4 if fit >= 4 else 2)
    assert p.resident == min(p.blocks, fit) >= 2
    assert p.ws_bc_floats == p.blocks_d * Bt * S * 2 * p.np
    assert p.ws_a_floats == Bt * p.segments * D * p.np
    assert p.ws_floats == p.ws_bc_floats + p.ws_a_floats \
        + Bt * p.pieces * D * (p.np + 1)
    assert p.sum_grid == -(-Bt * S * 2 * N // tscan.SUM_OUT) \
        + -(-D * N // (tscan.SUM_OUT * tscan.SUM_SLICES))
    assert tscan.chunk_states_shape(Bt, S, D, N) == (Bt, p.chunks, D, p.np)


def test_mamba_scan_bwd_plan_at_the_microbatch_shape():
    """falcon-mamba-7b's training microbatch (1, 1024, 8192, 16), x bf16:
    256 channel blocks of 32, 4 blocks an SM (56 KB each), so 2 segments
    of 32 chunks: 512 blocks; the pre-pass's 16 pieces of 4 chunks, 8 of
    them after the first segment: 2 048 blocks; its chunk states are 32
    MiB, the dB and dC partials 32 MiB, the dA partials 1 MiB. The
    ragged-S case (1, 1000, 512, 16), x fp32 (60 KB a block: 3 fit an SM,
    so the 2-block register bound): 16 segments of 4 chunks."""
    p = tscan.plan_bwd(1, 1024, 8192, 16, 2)
    assert (p.lanes, p.channels, p.blocks_d, p.blocks, p.resident,
            p.smem_bytes) == (4, 32, 256, 4, 4, 57344)
    assert (p.chunks, p.segments, p.seg_chunks, p.grid) == (64, 2, 32, 512)
    assert (p.piece_chunks, p.pieces, p.pre_grid) == (4, 16, 2048)
    assert 4 * int(np.prod(tscan.chunk_states_shape(1, 1024, 8192, 16))) \
        == 32 * 2 ** 20
    assert 4 * p.ws_bc_floats == 32 * 2 ** 20
    assert 4 * p.ws_a_floats == 2 ** 20
    q = tscan.plan_bwd(1, 1000, 512, 16, 4)
    assert (q.chunks, q.segments, q.seg_chunks, q.grid, q.piece_chunks,
            q.pre_grid) == (63, 16, 4, 256, 4, 240)


@pytest.mark.parametrize("case", [
    ((1, 1024, 8192, 16, 2), (2, 32, 512, 2048, 4, 16)),
    ((1, 4096, 8192, 16, 2), (2, 128, 512, 8192, 4, 64)),
    ((4, 1024, 8192, 16, 2), (1, 64, 1024, 0, 4, 16)),
    ((1, 1024, 2048, 16, 2), (8, 8, 512, 896, 4, 16)),
    ((1, 160, 4224, 16, 2), (4, 3, 528, 396, 3, 4)),
    ((1, 192, 2816, 16, 2), (6, 2, 528, 440, 2, 6)),
    ((1, 100, 640, 16, 4), (7, 1, 140, 120, 1, 7)),
    ((2, 40, 64, 4, 2), (3, 1, 6, 4, 1, 3)),
    ((1, 1, 8192, 16, 2), (1, 1, 256, 0, 1, 1)),
], ids=lambda c: "x".join(map(str, c[0])))
def test_mamba_scan_bwd_plan_takes_segments(case):
    """The plan's segments, worked out by hand (segments, chunks a
    segment, grid, pre-pass grid, chunks a piece, pieces): the nearest
    whole number of segments that fills every SM's resident blocks once
    (132 x 4 blocks an SM in bf16 at N = 16, 132 x 2 in fp32), cut to the
    chunks, then evened out (10 chunks in 4 segments of 3, 3-chunk
    pieces); one segment, and no pre-pass, where the channel blocks fill
    the card or S is one chunk."""
    (Bt, S, D, N, x_bytes), got = case
    p = tscan.plan_bwd(Bt, S, D, N, x_bytes)
    assert (p.segments, p.seg_chunks, p.grid, p.pre_grid, p.piece_chunks,
            p.pieces) == got


def test_mamba_scan_bwd_plan_matches_the_instances_in_csrc():
    """Every backward plan names an (NP, SPL) instance the C side
    instantiates, and the C side's constants are the plan's."""
    src = _scan_bwd_csrc()
    instances = {(int(a), int(b)) for a, b in
                 re.findall(r"REPRO_SCAN_BWD\((\d+), (\d+)\)\n", src)}
    assert {(tscan.plan_bwd(1, 8, 64, n, 2).np, tscan.STATES_PER_LANE)
            for n in range(1, tscan.MAX_N + 1)} == instances
    for name, value in (("THREADS", tscan.BWD_THREADS),
                        ("SPL", tscan.STATES_PER_LANE),
                        ("STASH", tscan.STASH),
                        ("SMEM_BLOCK", tscan.SMEM_BLOCK),
                        ("SUM_OUT", tscan.SUM_OUT),
                        ("SUM_SLICES", tscan.SUM_SLICES)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "constexpr int HALF = CHUNK / 2;" in src
    assert tscan.SUM_STEPS == tscan.CHUNK // 2
    assert "__launch_bounds__(THREADS, MIN_BLOCKS)" in src
    assert "BLOCKS = 4 * (BYTES + 1024) <= SMEM_SM ? 4 : 2;" in src
    assert tscan.BWD_BLOCKS == (2, 4)
    assert re.search(rf"constexpr int SMEM_SM = {tscan.SMEM_SM};", src)
    head = os.path.join(os.path.dirname(tscan.__file__), "csrc",
                        "mamba_scan.cuh")
    with open(head) as f:
        assert re.search(rf"constexpr int CHUNK = {tscan.CHUNK};", f.read())


def test_mamba_scan_bwd_source_has_no_atomics():
    """Every block writes its own partial sums and carries (the pre-pass
    too) and a last kernel adds them in a fixed order: the source, its
    three kernels, and the headers it includes hold no atomic operation
    and no reducing store or copy."""
    csrc = os.path.join(os.path.dirname(tscan.__file__), "csrc")
    src = _scan_bwd_csrc()
    for kernel in ("mamba_scan_bwd_carry(", "mamba_scan_bwd(",
                   "mamba_scan_bwd_sum("):
        assert f"__global__" in src.split(kernel)[0].rsplit("\n\n", 1)[-1], \
            kernel
    heads = re.findall(r'#include "(\w+\.cuh)"', src)
    assert set(heads) == {"mamba_scan.cuh", "mma_bf16.cuh", "sm90.cuh"}
    for text in [src] + [open(os.path.join(csrc, h)).read() for h in heads]:
        assert "atomic" not in text.lower()
        assert not re.search(r"\bred\.|cp\.reduce", text)


def _scan_bwd_meta(Bt, S, D, N, x_dtype=torch.bfloat16, dh=True):
    m = _scan_meta(Bt, S, D, N, x_dtype)
    dy = torch.empty((Bt, S, D), dtype=x_dtype, device="meta")
    dh_last = (torch.empty((Bt, D, N), device="meta") if dh else None)
    hc = torch.empty(tscan.chunk_states_shape(Bt, S, D, N), device="meta")
    return m + (dy, dh_last, hc)


def test_mamba_scan_bwd_checks_take_the_model_operands():
    """The microbatch's operands, with and without dh_last, pass and give
    ``plan_bwd``'s plan; nothing is built."""
    for dh in (True, False):
        p = tscan.check_bwd_operands(*_scan_bwd_meta(1, 1024, 8192, 16, dh=dh))
        assert p == tscan.plan_bwd(1, 1024, 8192, 16, 2)
    assert tscan._bwd_fn is None


def _swap(i, new):
    return lambda: tuple(new if j == i else t for j, t in
                         enumerate(_scan_bwd_meta(1, 40, 8, 4)))


@pytest.mark.parametrize("case", [
    ("fp16 x", lambda: _scan_bwd_meta(1, 40, 8, 4, torch.float16), "fp32 or bf16"),
    ("dy dtype", _swap(5, torch.empty((1, 40, 8), device="meta")), "dy must"),
    ("dy shape", _swap(5, torch.empty((1, 41, 8), dtype=torch.bfloat16,
                                      device="meta")), "dy must"),
    ("dy strided", _swap(5, torch.empty((1, 8, 40), dtype=torch.bfloat16,
                                        device="meta").transpose(1, 2)),
     "dy must"),
    ("dh shape", _swap(6, torch.empty((1, 8, 5), device="meta")), "dh_last"),
    ("dh bf16", _swap(6, torch.empty((1, 8, 4), dtype=torch.bfloat16,
                                     device="meta")), "dh_last"),
    ("no chunk states", _swap(7, None), "chunk states"),
    ("chunk states short", _swap(7, torch.empty((1, 2, 8, 4), device="meta")),
     "chunk states"),
    ("N=65", lambda: _scan_bwd_meta(1, 4, 8, 65), "1 <= N"),
], ids=lambda c: c[0])
def test_mamba_scan_bwd_checks_raise(case):
    """What the backward kernel does not take raises ValueError before
    anything is built or launched."""
    _, make, match = case
    before = tscan.bwd_launches
    with pytest.raises(ValueError, match=match):
        tscan.check_bwd_operands(*make())
    assert tscan.bwd_launches == before and tscan._bwd_fn is None


def test_mamba_scan_bwd_wrapper_raises_off_the_cpu_without_a_card():
    """Operands that are not all on the CPU must all be on one CUDA
    device: meta tensors raise ValueError instead of taking the plain
    version, and nothing is built or counted; so does a forward asked for
    chunk states on the CPU."""
    tscan.bwd_launches = 0
    with pytest.raises(ValueError, match="one CUDA device"):
        tscan.mamba_scan_bwd(*_scan_bwd_meta(1, 40, 8, 4))
    _, t = _scan_inputs(1, 8, 4, 2)
    with pytest.raises(ValueError, match="one CUDA device"):
        tscan.mamba_scan(*t, chunk_states=True)
    assert tscan.bwd_launches == 0 and tscan._bwd_fn is None


def test_mamba_scan_bwd_cpu_tensors_take_the_plain_version():
    """CPU tensors give ``mamba_scan_bwd_ref``'s bits, the chunk states
    unused, and count no launch."""
    tscan.bwd_launches = 0
    _, t = _scan_inputs(2, 20, 8, 4)
    dy = torch.ones(2, 20, 8)
    got = tscan.mamba_scan_bwd(*t, dy)
    for g, w in zip(got, ref.mamba_scan_bwd_ref(*t, dy)):
        assert torch.equal(g, w)
    assert tscan.bwd_launches == 0 and tscan._bwd_fn is None


# ------------------------------------------------------------ STREAM triad
# The plain triad is held to the Pallas kernel bit for bit: in fp32 XLA
# contracts the kernel body into one FMA (the JAX triad_ref rounds twice);
# in bf16 alpha is rounded to bf16 and the product and the sum each round.

def _bits_equal(got, want):
    np.testing.assert_array_equal(_np(got).view(np.int32),
                                  _np(want).view(np.int32))


@pytest.mark.parametrize("alpha", [2.5, 0.1])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 128), (256, 512), (300, 640),
                                   (1024, 1024), (97, 130), (1, 7)])
def test_triad_plain_matches_pallas(shape, dtype, alpha):
    bj, bt = _both(30, shape, dtype)
    cj, ct = _both(31, shape, dtype)
    want = triad_pallas(bj, cj, alpha, interpret=True)
    got = ref.triad_ref(bt, ct, alpha)
    assert got.dtype == bt.dtype and got.shape == bt.shape
    _bits_equal(got, want)
    _bits_equal(ops.triad(bt, ct, alpha), want)


def test_triad_fp32_rounds_once_where_the_jax_reference_rounds_twice():
    bj, bt = _both(32, (256, 512))
    cj, ct = _both(33, (256, 512))
    want = _np(triad_pallas(bj, cj, 2.5, interpret=True))
    assert (_np(jref.triad_ref(bj, cj, 2.5)) != want).sum() > 1000
    _bits_equal(ref.triad_ref(bt, ct, 2.5), want)


def test_triad_fp32_is_not_an_fp64_sum_rounded_to_fp32():
    """b + alpha c = 1 + 3 2^-24 - 2^-70: fp64 rounds it onto the fp32
    midpoint 1 + 3 2^-24, which ties to even upward; the exact value and
    the Pallas kernel's FMA round down."""
    b = np.array([[1 + 2 ** -23, 1.0, -(1 + 2 ** -23)]], np.float32)
    c = np.full((1, 3), (2 ** 23 - 1) * 2 ** -23, np.float32)
    alpha = (2 ** 23 + 1) * 2 ** -47     # an fp32 value
    want = _np(triad_pallas(jnp.asarray(b), jnp.asarray(c), alpha,
                            interpret=True))
    got = ref.triad_ref(torch.from_numpy(b), torch.from_numpy(c), alpha)
    _bits_equal(got, want)
    via_fp64 = (b.astype(np.float64) + alpha * c.astype(np.float64)
                ).astype(np.float32)
    assert (via_fp64 != want).sum() == 2


def test_triad_bf16_rounds_alpha_to_bf16_first():
    """At alpha = 0.1 (not a bf16 value), alpha in fp32 and one rounding
    (``torch.add``) each miss the Pallas kernel."""
    bj, bt = _both(34, (256, 512), "bf16")
    cj, ct = _both(35, (256, 512), "bf16")
    want = triad_pallas(bj, cj, 0.1, interpret=True)
    _bits_equal(ref.triad_ref(bt, ct, 0.1), want)
    assert ref.triad_alpha(0.1, torch.bfloat16) != ref.triad_alpha(
        0.1, torch.float32)
    assert (_np(bt + 0.1 * ct) != _np(want)).sum() > 1000
    assert (_np(torch.add(bt, ct, alpha=0.1)) != _np(want)).sum() > 1000


# ---------------------------------------------------------------- Jacobi-2d

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(16, 128), (256, 256), (384, 512),
                                   (100, 128), (97, 130)])
def test_jacobi2d_plain_matches_pallas(shape, dtype):
    """Bit for bit. R = 97 is prime, so the Pallas kernel falls to
    one-row blocks, each with its halo from the clamped neighbours."""
    aj, at = _both(36, shape, dtype)
    want = jacobi2d_pallas(aj, interpret=True)
    got = ref.jacobi2d_ref(at)
    assert got.dtype == at.dtype
    _bits_equal(got, want)
    _bits_equal(ops.jacobi2d(at), want)


def test_jacobi2d_bf16_sums_in_fp32_where_the_jax_reference_does_not():
    aj, at = _both(37, (256, 256), "bf16")
    want = _np(jacobi2d_pallas(aj, interpret=True))
    assert (_np(jref.jacobi2d_ref(aj)) != want).sum() > 1000
    _bits_equal(ref.jacobi2d_ref(at), want)


@pytest.mark.parametrize("shape", [(2, 5), (5, 2), (1, 1), (1, 7), (3, 3)])
def test_jacobi2d_small_grids(shape):
    """R or C < 3: all boundary, the output is the input; (3, 3) has one
    interior cell."""
    aj, at = _both(38, shape)
    want = jacobi2d_pallas(aj, interpret=True)
    got = ref.jacobi2d_ref(at)
    _bits_equal(got, want)
    if min(shape) < 3:
        _bits_equal(got, at)
    else:
        x = _np(at).astype(np.float64)
        assert got[1, 1].item() == pytest.approx(0.2 * (
            x[1, 1] + x[0, 1] + x[2, 1] + x[1, 0] + x[1, 2]), rel=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_jacobi2d_boundary_passes_through(dtype):
    """As test_kernels.py's boundary test, at 64 x 128; the interior
    changes."""
    _, at = _both(39, (64, 128), dtype)
    got = ref.jacobi2d_ref(at)
    for edge in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        _bits_equal(got[edge], at[edge])
    assert (_np(got[1:-1, 1:-1]) != _np(at[1:-1, 1:-1])).mean() > 0.9


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
    with pytest.raises(ValueError):
        ops.triad(a, a, 2.5, impl="pallas")
    with pytest.raises(ValueError):
        ops.jacobi2d(a, impl="jnp")


def test_ops_cuda_impl_rejects_cpu_tensors():
    _, a = _both(21, (8, 8))
    with pytest.raises(ValueError):
        ops.matmul(a, a, impl="cuda")
    _, t = _scan_inputs(1, 4, 8, 2)
    with pytest.raises(ValueError):
        ops.mamba_scan(*t, impl="cuda")
    with pytest.raises(ValueError):
        ops.triad(a, a, 2.5, impl="cuda")
    with pytest.raises(ValueError):
        ops.jacobi2d(a, impl="cuda")


def test_wrappers_take_the_plain_version_on_cpu_without_launching():
    _, a = _both(22, (16, 32))
    _, b = _both(23, (32, 8))
    _, q = _both(24, (1, 2, 16, 64))
    _, t = _scan_inputs(1, 5, 8, 2)
    counters = (tmatmul, tflash, tscan, ttriad, tjacobi)
    before = [m.launches for m in counters]
    np.testing.assert_array_equal(_np(tmatmul.matmul(a, b)),
                                  _np(ref.matmul_ref(a, b)))
    np.testing.assert_array_equal(_np(tflash.flash_attention(q, q, q)),
                                  _np(ref.flash_attention_ref(q, q, q)))
    for got, want in zip(tscan.mamba_scan(*t), ref.mamba_scan_ref(*t)):
        np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(ttriad.triad(a, a, 2.5)),
                                  _np(ref.triad_ref(a, a, 2.5)))
    np.testing.assert_array_equal(_np(tjacobi.jacobi2d(a)),
                                  _np(ref.jacobi2d_ref(a)))
    assert [m.launches for m in counters] == before


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
    with pytest.raises(ValueError):
        ttriad.triad(a, meta, 2.5)
    with pytest.raises(ValueError):
        tjacobi.jacobi2d(meta)
