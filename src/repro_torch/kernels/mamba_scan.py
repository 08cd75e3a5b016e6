"""Selective scan on the card: the Mamba-1 recurrence with an fp32 state,
returning y and the final state.

The kernel (``csrc/mamba_scan.cu``) replaces ``_scan_kernel`` /
``mamba_scan_pallas`` (``repro/kernels/mamba_scan.py:27,51``). It takes any
S and D and N <= 64, and it also returns ``h_last``, which the Pallas
kernel keeps in scratch: the model's prefill hands it to decode. A tensor
on the CPU takes the plain version (``ref.mamba_scan_ref``); a CUDA tensor
launches the kernel or raises. ``plan`` decides every launch parameter
before the launch, and the C side refuses a plan that does not match the
instance it picks. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import build, ref

launches = 0

MAX_N = 64   # the largest state width instantiated in csrc/mamba_scan.cu
# the plan's constants, as csrc/mamba_scan.cu has them
CONSUMERS = 256          # consumer threads a block, beside one producer warp
THREADS = CONSUMERS + 32
STATES_PER_LANE = 4      # the SPL of every instance
RESIDENT = 4             # blocks an SM the shared memory is planned for
TILES = ((32, 3), (32, 2), (16, 3), (16, 2), (8, 2))  # (time tile, stages), best first
# an H100 SM: shared memory for all its blocks, the part one block may
# use, and what the runtime keeps per block
SMEM_SM = 228 * 1024
SMEM_BLOCK = 227 * 1024
SMEM_RESERVED = 1024
MAX_GRID = 2 ** 31 - 1   # blocks along the grid's x dimension
_fn = None


@dataclass(frozen=True)
class Plan:
    """One launch of the scan kernel: NP states padded from N, ``lanes``
    lanes a channel with ``states_per_lane`` states each, ``channels`` a
    block, a ring of ``stages`` tiles of ``time_tile`` steps in
    ``smem_bytes`` of shared memory, and ``grid`` blocks, batch-major."""
    np: int
    lanes: int
    states_per_lane: int
    channels: int
    time_tile: int
    stages: int
    threads: int
    smem_bytes: int
    grid: int
    resident: int


def plan(Bt: int, S: int, D: int, N: int, x_bytes: int) -> Plan:
    """The launch parameters of a scan over dt, x (Bt, S, D), N states and
    x of ``x_bytes`` a value. The state is split so each lane holds 4;
    256 consumer threads a block share dt, x, B and C tiles that one
    producer warp stages; the deepest (time tile, stages) whose shared
    memory lets RESIDENT blocks share an SM is taken, and the tile is cut
    to the sequence, in whole groups of 8 steps and of the lanes."""
    np_ = 4   # the instance's state width: the next of 4, 8, 16, 32, 64
    while np_ < N:
        np_ *= 2
    lanes = np_ // STATES_PER_LANE
    channels = CONSUMERS // lanes
    step = channels * (4 + x_bytes) + 2 * np_ * 4   # bytes a time step
    for tt, stages in TILES:
        smem = stages * (tt * step + 16)   # + a full and an empty mbarrier a stage
        if smem <= SMEM_BLOCK and RESIDENT * (smem + SMEM_RESERVED) <= SMEM_SM:
            break
    unit = max(8, lanes)
    tt = min(tt, -(-max(S, 1) // unit) * unit)
    smem = stages * (tt * step + 16)
    return Plan(np=np_, lanes=lanes, states_per_lane=STATES_PER_LANE,
                channels=channels, time_tile=tt, stages=stages,
                threads=THREADS, smem_bytes=smem,
                grid=Bt * -(-D // channels), resident=RESIDENT)


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("mamba_scan").repro_mamba_scan
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_operands(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, x: torch.Tensor) -> Plan:
    """Raises ValueError unless the kernel takes the operands; returns the
    launch's plan."""
    ts = (dt, A, B, C, x)
    if any(t.dtype != torch.float32 for t in ts[:4]) \
            or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mamba_scan kernel takes fp32 dt, A, B, C and fp32 "
                         f"or bf16 x, got {[t.dtype for t in ts]}")
    if x.dim() != 3 or dt.shape != x.shape or A.dim() != 2:
        raise ValueError(f"mamba_scan: bad shapes dt {tuple(dt.shape)}, "
                         f"x {tuple(x.shape)}, A {tuple(A.shape)}")
    Bt, S, D = x.shape
    N = A.shape[1]
    if A.shape[0] != D or B.shape != (Bt, S, N) or C.shape != (Bt, S, N):
        raise ValueError(f"mamba_scan: A {tuple(A.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)} do not match x {tuple(x.shape)}")
    if not 1 <= N <= MAX_N:
        raise ValueError(f"mamba_scan kernel takes 1 <= N <= {MAX_N}, got N={N}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("mamba_scan kernel takes contiguous operands")
    p = plan(Bt, S, D, N, x.element_size())
    if p.grid > MAX_GRID:
        raise ValueError(f"mamba_scan: {p.grid} blocks exceed the grid's "
                         f"{MAX_GRID}")
    return p


def mamba_scan(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, x: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """dt, x: (Bt,S,D); A: (D,N); B, C: (Bt,S,N) -> (y (Bt,S,D) in x's
    dtype, h_last (Bt,D,N) fp32). dt, A, B and C are fp32; x is fp32 or
    bf16; all contiguous."""
    global launches
    ts = (dt, A, B, C, x)
    if all(t.device.type == "cpu" for t in ts):
        return ref.mamba_scan_ref(dt, A, B, C, x)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("mamba_scan: dt, A, B, C, x must be on one CUDA device")
    p = check_operands(dt, A, B, C, x)
    Bt, S, D = x.shape
    N = A.shape[1]
    y = torch.empty((Bt, S, D), dtype=x.dtype, device=x.device)
    h_last = torch.empty((Bt, D, N), dtype=torch.float32, device=x.device)
    if Bt == 0 or D == 0:
        return y, h_last
    err = _kernel()(dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                    x.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                    Bt, S, D, N, int(x.dtype == torch.bfloat16), p.np,
                    p.states_per_lane, p.channels, p.time_tile, p.stages,
                    p.smem_bytes, p.grid,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"mamba_scan kernel launch failed: cudaError {err}")
    launches += 1
    return y, h_last
