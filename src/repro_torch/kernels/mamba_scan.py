"""Selective scan on the card: the Mamba-1 recurrence with an fp32 state,
returning y and the final state, and its backward pass.

The kernel (``csrc/mamba_scan.cu``) replaces ``_scan_kernel`` /
``mamba_scan_pallas`` (``repro/kernels/mamba_scan.py:27,51``). It takes any
S and D and N <= 64, and it also returns ``h_last``, which the Pallas
kernel keeps in scratch: the model's prefill hands it to decode. For
training it also returns the state at the start of every CHUNK steps,
which the backward kernel (``csrc/mamba_scan_bwd.cu``, ``mamba_scan_bwd``;
no TPU counterpart: the reference differentiates its scan through XLA)
recomputes each chunk from. A tensor on the CPU takes the plain version
(``ref.mamba_scan_ref``, ``ref.mamba_scan_bwd_ref``); a CUDA tensor
launches the kernel or raises. ``plan`` and ``plan_bwd`` decide every
launch parameter before the launch, and the C side refuses a plan that
does not match the instance it picks. ``launches`` and ``bwd_launches``
count kernel launches (a backward call's three kernels count once).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import build, ref

launches = 0
bwd_launches = 0

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
# the backward kernels (csrc/mamba_scan_bwd.cu): states saved every CHUNK
# steps (csrc/mamba_scan.cuh); blocks of BWD_THREADS with the forward's
# lanes, their registers bounded for 4 blocks an SM where 4 fit in shared
# memory, else for 2 (BWD_BLOCKS); sums taken every SUM_STEPS steps;
# STASH steps of decays a thread in shared memory; as many segments of
# whole chunks as fill every SM's resident blocks about once; the
# pre-pass's pieces at most PIECE chunks; the summing kernel's blocks of
# SUM_OUT outputs of dB and dC, each summed in SUM_SLICES strided slices,
# and of SUM_OUT * SUM_SLICES outputs of dA
CHUNK = 16
BWD_THREADS = 128
BWD_WARPS = BWD_THREADS // 32
BWD_BLOCKS = (2, 4)
SUM_STEPS = CHUNK // 2
STASH = 8
SMS = 132
PIECE = 4
SUM_OUT = 32
SUM_SLICES = 8
_fn = None
_bwd_fn = None


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
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
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


def chunk_states_shape(Bt: int, S: int, D: int, N: int) -> tuple:
    """The shape of the forward's saved states: the state before every
    CHUNK-th step, (Bt, ceil(S / CHUNK), D, NP), fp32."""
    return (Bt, -(-S // CHUNK), D, plan(Bt, S, D, N, 2).np)


def mamba_scan(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, x: torch.Tensor, chunk_states: bool = False):
    """dt, x: (Bt,S,D); A: (D,N); B, C: (Bt,S,N) -> (y (Bt,S,D) in x's
    dtype, h_last (Bt,D,N) fp32), and with ``chunk_states`` (CUDA only)
    also the states ``mamba_scan_bwd`` reads (``chunk_states_shape``).
    dt, A, B and C are fp32; x is fp32 or bf16; all contiguous."""
    global launches
    ts = (dt, A, B, C, x)
    if all(t.device.type == "cpu" for t in ts) and not chunk_states:
        return ref.mamba_scan_ref(dt, A, B, C, x)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("mamba_scan: dt, A, B, C, x must be on one CUDA device")
    p = check_operands(dt, A, B, C, x)
    Bt, S, D = x.shape
    N = A.shape[1]
    y = torch.empty((Bt, S, D), dtype=x.dtype, device=x.device)
    h_last = torch.empty((Bt, D, N), dtype=torch.float32, device=x.device)
    hc = (torch.empty(chunk_states_shape(Bt, S, D, N), dtype=torch.float32,
                      device=x.device) if chunk_states else None)
    out = (y, h_last, hc) if chunk_states else (y, h_last)
    if Bt == 0 or D == 0:
        return out
    err = _kernel()(dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                    x.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                    0 if hc is None else hc.data_ptr(),
                    Bt, S, D, N, int(x.dtype == torch.bfloat16), p.np,
                    p.states_per_lane, p.channels, p.time_tile, p.stages,
                    p.smem_bytes, p.grid,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"mamba_scan kernel launch failed: cudaError {err}")
    launches += 1
    return out


# ---------------------------------------------------------------- backward

@dataclass(frozen=True)
class BwdPlan:
    """One call of the backward kernels: the forward's split of NP states
    over ``lanes`` lanes of ``states_per_lane`` and ``channels`` a block
    of ``threads``, registers bounded for ``blocks`` blocks an SM (4
    where 4 fit in shared memory, else 2); S cut into ``segments`` of
    ``seg_chunks`` chunks of ``chunk`` steps (``chunks`` in all), a block
    a (batch row, channel block, segment) in ``grid``, its sums taken
    every ``sum_steps`` steps; the pre-pass's ``pieces`` of
    ``piece_chunks`` chunks, a block each in ``pre_grid`` but those of the
    first segment; ``smem_bytes`` of
    shared memory a block (two stages of a chunk's inputs, a buffer of
    sums for each half of a chunk, the stashed decays) and ``resident``
    blocks an SM; the workspace (``ws_bc_floats`` of dB and dC partials,
    one (Bt, S, 2, NP) slice a channel block; ``ws_a_floats`` of dA
    partials, one (D, NP) slice a (batch row, segment); the pre-pass's
    carries and sums of dt a piece), ``ws_floats`` in all; the summing
    kernel's ``sum_grid``."""
    np: int
    lanes: int
    states_per_lane: int
    channels: int
    threads: int
    blocks: int
    chunk: int
    chunks: int
    sum_steps: int
    seg_chunks: int
    segments: int
    piece_chunks: int
    pieces: int
    smem_bytes: int
    resident: int
    blocks_d: int
    grid: int
    pre_grid: int
    ws_bc_floats: int
    ws_a_floats: int
    ws_floats: int
    sum_grid: int


def bwd_smem_bytes(np_: int, x_bytes: int) -> int:
    """The backward kernel's shared memory: two stages of a chunk's dt, x,
    dy, B, C and saved states; for each half of a chunk, the warps' dB and
    dC sums and the lanes' d dt and du partials; STASH steps of each
    thread's decays."""
    channels = BWD_THREADS * STATES_PER_LANE // np_
    stage = (CHUNK * (channels * (4 + 2 * x_bytes) + 2 * np_ * 4)
             + channels * np_ * 4)
    part = SUM_STEPS * 2 * BWD_WARPS * np_ + SUM_STEPS * 2 * BWD_THREADS
    return 2 * stage + 2 * part * 4 + STASH * BWD_THREADS * STATES_PER_LANE * 4


def plan_bwd(Bt: int, S: int, D: int, N: int, x_bytes: int) -> BwdPlan:
    """The backward kernels' launches for dt, x, dy (Bt, S, D), N states and
    x of ``x_bytes`` a value: the forward's lanes, BWD_THREADS threads a
    block; as many segments of whole chunks as fill every SM's resident
    blocks about once (the nearest whole number), cut to the chunks, then
    evened out; the pre-pass's pieces the longest of at most PIECE chunks
    that divide a segment's."""
    np_ = plan(Bt, S, D, N, x_bytes).np
    lanes = np_ // STATES_PER_LANE
    channels = BWD_THREADS // lanes
    smem = bwd_smem_bytes(np_, x_bytes)
    fit = SMEM_SM // (smem + SMEM_RESERVED)
    blocks = BWD_BLOCKS[-1] if fit >= BWD_BLOCKS[-1] else BWD_BLOCKS[0]
    resident = min(blocks, fit)
    blocks_d = -(-D // channels)
    chunks = -(-S // CHUNK)
    walk = max(chunks, 1)   # an empty sequence plans one chunk
    rows = Bt * blocks_d
    want = (SMS * resident + rows // 2) // rows
    seg_chunks = -(-walk // max(1, min(want, walk)))
    segments = -(-walk // seg_chunks)
    piece_chunks = max(c for c in range(1, PIECE + 1) if seg_chunks % c == 0)
    pieces = -(-walk // piece_chunks)
    tasks = (-(-Bt * S * 2 * N // SUM_OUT)
             + -(-D * N // (SUM_OUT * SUM_SLICES)))
    ws_bc = blocks_d * Bt * S * 2 * np_
    ws_a = Bt * segments * D * np_
    return BwdPlan(np=np_, lanes=lanes, states_per_lane=STATES_PER_LANE,
                   channels=channels, threads=BWD_THREADS, blocks=blocks,
                   chunk=CHUNK, chunks=chunks, sum_steps=SUM_STEPS,
                   seg_chunks=seg_chunks, segments=segments,
                   piece_chunks=piece_chunks, pieces=pieces,
                   smem_bytes=smem, resident=resident,
                   blocks_d=blocks_d, grid=rows * segments,
                   pre_grid=rows * (pieces - seg_chunks // piece_chunks),
                   ws_bc_floats=ws_bc, ws_a_floats=ws_a,
                   ws_floats=ws_bc + ws_a + Bt * pieces * D * (np_ + 1),
                   sum_grid=tasks)


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = build.load("mamba_scan_bwd").repro_mamba_scan_bwd
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 16
                       + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def check_bwd_operands(dt, A, B, C, x, dy, dh_last, h_chunks) -> BwdPlan:
    """Raises ValueError unless the backward kernel takes the operands: the
    forward's (``check_operands``), dy like x, dh_last None or (Bt, D, N)
    fp32, and the forward's saved states; returns the plan."""
    check_operands(dt, A, B, C, x)
    Bt, S, D = x.shape
    N = A.shape[1]
    if dy.dtype != x.dtype or dy.shape != x.shape or not dy.is_contiguous():
        raise ValueError(f"mamba_scan_bwd: dy must be a contiguous {x.dtype} "
                         f"{tuple(x.shape)}, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    if dh_last is not None and (dh_last.dtype != torch.float32
                                or dh_last.shape != (Bt, D, N)
                                or not dh_last.is_contiguous()):
        raise ValueError(f"mamba_scan_bwd: dh_last must be a contiguous fp32 "
                         f"{(Bt, D, N)}, got {dh_last.dtype} "
                         f"{tuple(dh_last.shape)}")
    want = chunk_states_shape(Bt, S, D, N)
    if h_chunks is None or h_chunks.dtype != torch.float32 \
            or tuple(h_chunks.shape) != want or not h_chunks.is_contiguous():
        raise ValueError(f"mamba_scan_bwd: the kernel reads the forward's "
                         f"chunk states, a contiguous fp32 {want}")
    p = plan_bwd(Bt, S, D, N, x.element_size())
    if max(p.grid, p.sum_grid) > MAX_GRID:
        raise ValueError(f"mamba_scan_bwd: {max(p.grid, p.sum_grid)} blocks "
                         f"exceed the grid's {MAX_GRID}")
    return p


def mamba_scan_bwd(dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, x: torch.Tensor, dy: torch.Tensor,
                   dh_last: torch.Tensor | None = None,
                   h_chunks: torch.Tensor | None = None):
    """The scan's backward pass: the forward's operands, dy like y, dh_last
    (Bt,D,N) fp32 or None, and on the card the forward's ``chunk_states``
    -> (d dt, dA, dB, dC, dx) in the operands' dtypes. CPU tensors take
    ``ref.mamba_scan_bwd_ref`` (``h_chunks`` unused)."""
    global bwd_launches
    ts = [t for t in (dt, A, B, C, x, dy, dh_last, h_chunks) if t is not None]
    if all(t.device.type == "cpu" for t in ts):
        return ref.mamba_scan_bwd_ref(dt, A, B, C, x, dy, dh_last)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("mamba_scan_bwd: every operand must be on one CUDA "
                         "device")
    p = check_bwd_operands(dt, A, B, C, x, dy, dh_last, h_chunks)
    Bt, S, D = x.shape
    N = A.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    d_dt = torch.empty((Bt, S, D), **f32)
    dx = torch.empty((Bt, S, D), dtype=x.dtype, device=x.device)
    dB, dC = torch.empty((Bt, S, N), **f32), torch.empty((Bt, S, N), **f32)
    if Bt == 0 or S == 0 or D == 0:
        return d_dt, torch.zeros((D, N), **f32), dB, dC, dx
    dA = torch.empty((D, N), **f32)
    ws = torch.empty(p.ws_floats, **f32)
    err = _bwd_kernel()(
        dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), x.data_ptr(),
        dy.data_ptr(), 0 if dh_last is None else dh_last.data_ptr(),
        h_chunks.data_ptr(), d_dt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), dx.data_ptr(), ws.data_ptr(),
        Bt, S, D, N, int(x.dtype == torch.bfloat16), p.np,
        p.states_per_lane, p.channels, p.chunk, p.sum_steps, p.threads,
        p.blocks, p.seg_chunks, p.segments, p.piece_chunks, p.smem_bytes,
        p.grid, p.pre_grid, p.sum_grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"mamba_scan_bwd kernel launch failed: cudaError "
                           f"{err}")
    bwd_launches += 1
    return d_dt, dA, dB, dC, dx
