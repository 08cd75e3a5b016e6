"""Matmul on the card: C = A @ B with fp32 accumulation, in A's dtype.

The kernel (``csrc/matmul.cu``) replaces ``_matmul_kernel`` /
``matmul_pallas`` (``repro/kernels/matmul.py:24,40``). A tensor on the CPU
takes the plain version (``ref.matmul_ref``); a CUDA tensor launches the
kernel or raises. ``route`` picks one of the kernel's four routes from the
shape, the dtype and the pointers before the launch; ``launches`` counts
kernel launches and ``route_launches`` counts them by route. The decode
route (M <= 16) splits K into ``decode_split`` slices where C's column
tiles alone would leave SMs idle, and reduces the slices in the same
launch.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, ref

# the C side's route numbers are the indices
ROUTES = ("f32", "decode", "mma_sync", "wgmma")
WGMMA_MIN_M = 64      # one warpgroup's rows; below it the 128-row tile is mostly empty
WGMMA_TILE_M = 128
DECODE_MAX_M = 16     # the decode route's tile height
DECODE_STEP_K = 64    # the decode kernel's K-step: every K-slice but the last is a multiple
DECODE_WIDE = 2 ** 24  # weights of at least this many elements (32 MiB) take 64-wide tiles
DECODE_WAVES = 2      # blocks an SM that splitting K aims for

launches = 0
route_launches = dict.fromkeys(ROUTES, 0)

_fn = None
_MAX_M = 65535 * 128  # grid.y limit times the tile height of the mma_sync route


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("matmul").repro_matmul
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 3)
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


def decode_tile_n(N: int, K: int) -> int:
    """Columns of a decode-route tile: 64 for weights of DECODE_WIDE
    elements or more, which stream long enough that a tile's 128-byte rows
    (a whole L2 line) beat the latency that more, narrower tiles hide;
    else 32."""
    return 64 if K * N >= DECODE_WIDE else 32


@functools.lru_cache(maxsize=None)
def decode_split(N: int, K: int, sms: int) -> int:
    """The K-slices of the decode kernel. 1 where C's column tiles already
    give every SM a block (the LM heads), else about DECODE_WAVES blocks
    an SM, or one slice per K-step where K is too short for that; at least
    one block an SM whenever K allows. The kernel makes each slice
    ceil(steps / slices) K-steps long, the last shorter; the count
    returned leaves no slice empty. M does not enter: every tile is 16
    rows high."""
    tiles = math.ceil(N / decode_tile_n(N, K))
    steps = math.ceil(K / DECODE_STEP_K)
    if tiles >= sms or steps <= 1:
        return 1
    want = math.ceil(DECODE_WAVES * sms / tiles)
    return math.ceil(steps / math.ceil(steps / want))


_sms: dict[int, int] = {}
_scratch: dict[int, tuple] = {}  # device: (addresses, the tensors they belong to)


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def sm_count(device: torch.device) -> int:
    idx = _index(device)
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _split_scratch(device: torch.device) -> tuple[int, int]:
    """Addresses of the split decode's fp32 workspace and its per-tile
    arrival counters on ``device``, made once and zeroed once: each launch
    leaves its counters at zero again, so calls on one device must be
    serialised on one stream, as the port's are. A split grid has fewer
    tiles than SMs and at most DECODE_WAVES blocks an SM more than one
    tile's worth, so split x N < (DECODE_WAVES + 1) x sms x 64, and M <=
    DECODE_MAX_M: the sizes below hold every split call, and no captured
    CUDA graph outlives a buffer it points at."""
    idx = _index(device)
    if idx not in _scratch:
        sms = sm_count(device)
        ws = torch.empty(DECODE_MAX_M * (DECODE_WAVES + 1) * sms * 64,
                         dtype=torch.float32, device=device)
        counts = torch.zeros(sms, dtype=torch.int32, device=device)
        _scratch[idx] = ((ws.data_ptr(), counts.data_ptr()), (ws, counts))
    return _scratch[idx][0]


def launch(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, which: str,
           b_transposed: bool = False) -> None:
    """Launch route ``which`` on CUDA operands that ``matmul`` has checked;
    raise if the route cannot take them or the launch fails."""
    global launches
    M, K = a.shape
    N = out.shape[1]
    ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr())
    if (which == "f32") != (a.dtype == torch.float32) or (
            which == "decode" and M > DECODE_MAX_M) or (
            which == "wgmma"
            and route(M, N, K, b_transposed, a.dtype, ptrs) != "wgmma"):
        raise ValueError(f"matmul: route {which} does not take {a.dtype} "
                         f"({M}, {K}) x ({K}, {N}), b_transposed={b_transposed}")
    tile_n, split, scratch = 0, 1, (None, None)
    if which == "wgmma":
        tile_n = wgmma_tile_n(M, N, sm_count(a.device))
    elif which == "decode":
        tile_n = decode_tile_n(N, K)
        split = decode_split(N, K, sm_count(a.device))
        if split > 1:
            scratch = _split_scratch(a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _kernel()(*ptrs, M, N, K, int(b_transposed), ROUTES.index(which),
                    tile_n, split, *scratch, stream)
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
