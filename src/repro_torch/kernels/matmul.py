"""Matmul on the card: C = A @ B with fp32 accumulation, in A's dtype.

The kernel (``csrc/matmul.cu``) replaces ``_matmul_kernel`` /
``matmul_pallas`` (``repro/kernels/matmul.py:24,40``). A tensor on the CPU
takes the plain version (``ref.matmul_ref``); a CUDA tensor launches the
kernel or raises. ``route`` picks one of the kernel's four routes from the
shape, the dtype and the pointers before the launch; ``launches`` counts
kernel launches and ``route_launches`` counts them by route.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

# the C side's route numbers are the indices
ROUTES = ("f32", "decode", "mma_sync", "wgmma")
WGMMA_MIN_M = 64      # one warpgroup's rows; below it the 128-row tile is mostly empty
WGMMA_TILE_M = 128
DECODE_MAX_M = 16     # the decode route's tile height

launches = 0
route_launches = dict.fromkeys(ROUTES, 0)

_fn = None
_MAX_M = 65535 * 128  # grid.y limit times the tile height of the mma_sync route


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("matmul").repro_matmul
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def route(M: int, N: int, K: int, b_transposed: bool, dtype: torch.dtype,
          ptrs: tuple[int, ...]) -> str:
    """The kernel route for C (M, N) = A (M, K) @ B, with ``ptrs`` the
    addresses of A, B and C. wgmma reads A and B through TMA, which needs
    16-byte aligned bases and row strides (K and N multiples of 8 bf16)."""
    if dtype == torch.float32:
        return "f32"
    if M <= DECODE_MAX_M:
        return "decode"
    if (M >= WGMMA_MIN_M and not b_transposed and K > 0 and K % 8 == 0
            and N % 8 == 0 and all(p % 16 == 0 for p in ptrs)):
        return "wgmma"
    return "mma_sync"


def wgmma_tile_n(M: int, N: int, sms: int) -> int:
    """Columns of a wgmma-route tile: 256, unless 128-wide tiles take fewer
    waves of blocks (one per SM) for the same columns, as when N is small
    (x_proj's 288) or just past a multiple of 256 (gemma's 1152)."""
    tiles_m = math.ceil(M / WGMMA_TILE_M)

    def waves(bn):
        return math.ceil(tiles_m * math.ceil(N / bn) / sms)
    return 256 if 2 * waves(256) <= waves(128) else 128


_sms: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def launch(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, which: str,
           b_transposed: bool = False) -> None:
    """Launch route ``which`` on CUDA operands that ``matmul`` has checked;
    raise if the route cannot take them or the launch fails."""
    global launches
    M, K = a.shape
    N = out.shape[1]
    ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr())
    if (which == "f32") != (a.dtype == torch.float32) or (
            which == "wgmma"
            and route(M, N, K, b_transposed, a.dtype, ptrs) != "wgmma"):
        raise ValueError(f"matmul: route {which} does not take {a.dtype} "
                         f"({M}, {K}) x ({K}, {N}), b_transposed={b_transposed}")
    tile_n = wgmma_tile_n(M, N, sm_count(a.device)) if which == "wgmma" else 0
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _kernel()(*ptrs, M, N, K, int(b_transposed), ROUTES.index(which),
                    tile_n, stream)
    if err < 0:
        raise RuntimeError(f"matmul kernel ({which}): cuTensorMapEncodeTiled "
                           f"failed: CUresult {-err}")
    if err:
        raise RuntimeError(f"matmul kernel ({which}) launch failed: "
                           f"cudaError {err}")
    launches += 1
    route_launches[which] += 1


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           b_transposed: bool = False) -> torch.Tensor:
    """A: (M, K); B: (K, N), or (N, K) row-major when ``b_transposed``
    (read in place, e.g. a tied embedding table as the LM head)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ref.matmul_ref(a, b, b_transposed)
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"matmul: a and b must be on one CUDA device, got "
                         f"{a.device} and {b.device}")
    if a.dtype not in (torch.bfloat16, torch.float32) or b.dtype != a.dtype:
        raise ValueError(f"matmul kernel takes bf16 or fp32 of one dtype, got "
                         f"{a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul kernel takes 2-D operands, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul kernel takes contiguous row-major operands")
    M, K = a.shape
    N, Kb = b.shape if b_transposed else b.shape[::-1]
    if K != Kb:
        raise ValueError(f"matmul: inner dims differ: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, b_transposed={b_transposed}")
    if M > _MAX_M or N >= 2 ** 31 - 128:
        raise ValueError(f"matmul kernel: shape ({M}, {K}) x ({K}, {N}) "
                         f"exceeds its launch grid")
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    which = route(M, N, K, b_transposed, a.dtype,
                  (a.data_ptr(), b.data_ptr(), out.data_ptr()))
    launch(a, b, out, which, b_transposed)
    return out
