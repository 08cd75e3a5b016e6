#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py        # from the repository root, one CUDA card
    python3 chip_smoke.py --only flash-bwd   # build, then phase 8(a) alone,
                                             # each launch profiled
    python3 chip_smoke.py --only scan-bwd    # build, then phase 8(a') alone
    python3 chip_smoke.py --only stream      # build, then phase 1'(a) alone
    python3 chip_smoke.py --only mesh        # build, then phase 7m alone

1. Prints the card's name and power limit, then builds the seven CUDA
   kernels from ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a), one
   nvcc process each, all at once.
1'. (a) mixtral-8x7b at full depth (93.4 GB of bf16 weights, more than
   the card's 80 GB), streamed layer by layer through the SVM executor,
   first of the phases, while the host's memory is the freest. Every
   layer is its own ``remainder/r<i>`` subtree (``unstacked``); the
   params are drawn on the card one leaf at a time from seed 0, with
   ``bridge.init_params``' bits, and copied into pinned host blocks
   (``host_blocks``: powers of two of at most STREAM_BLOCK bytes, so the
   pinned allocator pads none), which the executor takes as they are.
   The depth is cut to what fits the host's available memory beside
   STREAM_HOST_RESERVE, and a cut is printed. A ``StreamingExecutor``
   with a pool of SVM_FRAC of the weights (H100 preset) serves them
   through ``run_layer_stream`` in layer order (the embed, each layer's
   leaves, the final norm and the head): ``LayerStream`` runs the port's
   own layer (``models.transformer._apply_layer``) on the leaves it is
   handed, a prefill of BATCH x PROMPT tokens with ``prompt_len``-wide
   decode buffers as ``launch/steps.make_prefill_step`` keeps them, then
   STREAM_DECODE greedy decode tokens, for each of STREAM_POLICIES (lrf
   naive; svm_aware: embed and head pinned, prefetch). It fails unless
   the managed leaves in the pool keep to the budget at every layer, the
   launches by kernel and route are ``check_routes``' (every projection,
   the router and every expert product on wgmma in prefill and on decode
   in a token; one flash launch a layer in prefill, none in a token),
   the two policies give bit-equal logits and tokens, each run's
   ``metrics()`` equals a ``materialize=False`` replay of the same layer
   paths and flops with ``==``, the card's peak stays under
   STREAM_PEAK_GB, the first STREAM_CHECK_LAYERS layers of the same host
   tree streamed give the bits of the same layers resident
   (``make_prefill_step`` and ``decode_step``), and the host leaves' sums
   after it all are the ones drawn. It prints each policy's real prefill
   and token walls (CUDA events) beside the executor's simulated ones,
   the bytes copied host to device, migrations and evictions.
   (b) Each example of ``examples/torch`` once on the card, at its own
   size (``train_oversubscribed`` for EXAMPLE_TRAIN_STEPS steps), and on
   the CPU with the same arguments. The two that train draw their params
   on the host, so both runs start from the same bits: every loss they
   print is within EXAMPLE_LOSS_TOL of the CPU's, quickstart's decoded
   ids are the CPU's, and both launch the matmul and flash kernels. The
   SVM lines (``serve_streaming``'s and ``serve_multitenant``'s output,
   ``train_oversubscribed``'s offload schedule) come from the simulated
   clock, which no device changes, and equal the CPU run's with ``==``.
2. Holds the matmul kernel against its plain version at every shape the
   gemma3-1b serving path gives it (decode M=4, prefill M=4096), plus
   ragged and fp32 cases, the wgmma route's threshold (M = 64, 63) and
   ragged but 16-byte aligned shapes on it, and decode cases at M = 1
   and 16, K = 8190, odd N, misaligned A and both B layouts. Each case
   asserts the route it took (``matmul.route_launches``), that a second
   call gives the same bits, and that its tolerance rejects a zeroed and
   a 10 %-off output; it prints its share of the bound. Each wgmma case
   times the mma_sync route at the same shape (``prev_ms``); each decode
   case prints its tile width and K-slices (``decode_split``).
3. Holds the flash-attention kernel against its plain version: the Pallas
   kernel's cases (KV=H, causal and not, S != T, D = 64 and 128), the
   model's prefill shapes (GQA 4:1, D=256, window 512 and global), and at
   D = 256 ragged S and T (1000), S != T, window 1 and a window wider than
   S, non-causal with and without a window, GQA 4:1 in the model's
   layout; on the mma_sync route the reduced config's shape (D = 16) and
   D = 32 with GQA and a window. Each case asserts its route
   (``flash_attention.route_launches``: wgmma for D >= 64), that a second
   call gives the same bits, and that its tolerance rejects a zeroed and a
   10 %-off output.
4. Serves full-width gemma3-1b (random weights from seed 0): batch 4,
   1024-token prompts, 32 greedy decode tokens, through
   ``repro_torch.launch.serve``; checks that both of its kernels were
   launched, that every prefill projection took the wgmma route and
   every decode matmul the decode route, that all 26 prefill attention
   calls took the flash kernel's wgmma route, that the kernel path is no
   farther from the model in fp32 than the plain path (``impl="torch"``),
   and the reduced model on the card against the CPU; times the prefill
   PREFILL_REPEATS times more. Then frees all of it.
5. Holds the selective-scan kernel (y and the final state) against its
   plain version: the Pallas kernel's cases, ragged S, D = 640, N of 1,
   4, 8, 16, 32 and 64 (every padded instance), a ragged D (8190, rows
   not 16-byte aligned), a long S (4096), more than 65 535 batch rows,
   and the falcon-mamba prefill shape (4, 1024, 8192, 16) with x in bf16.
   Each case prints its launch plan (``mamba_scan.plan``: lanes a
   channel, states a lane, channels a block, time tile, stages), checks
   that a second call gives the same bits and that its tolerance rejects
   a zeroed and a 10 %-off output. Then the matmul kernel at every
   falcon-mamba shape.
   After it, the spec check and the SVM phase (below) on the served
   params, and the launcher with ``--svm-budget-frac 0.6 --svm-mode
   svm_aware --requests 8 --sched-policy svm_aware --chaos``.
6. Serves full-width falcon-mamba-7b the same way (64 Mamba layers, 14.6
   GB of bf16 weights), with the same checks for matmul, and exactly one
   scan launch a layer in prefill and none in decode; then the spec check,
   its SVM phase, and the launcher with ``--svm-mode zero_copy
   --requests 8 --sched-policy admission --admit-by measured``.

   The spec check: ``ModelSpec.from_params`` of the served CUDA params
   must equal the spec of meta tensors of ``bridge.param_shapes``.

   The SVM phase (``repro_torch.svm``): the served params are copied once
   into pinned host memory, then for each mode (naive, svm_aware,
   measured, zero_copy) at a pool of 0.6 of the weights, policy lrf, the
   launcher's ``WeightStream`` replays 32 decode tokens: fused
   (``decode_steps``, its host seconds printed), token by token, and on
   the scalar session. It fails unless the scalar session's ``metrics()``
   equals the batched one's with ``==`` and the fused pass equals the
   token loop (but for its segment-cache hits: it fetches the step
   segment once); unless a materialized run of 3 tokens, then a
   ``fetch`` and a ``tensor`` of every leaf, leaves every pool tensor on
   the card and equal (``torch.equal``) to the served param; and unless
   the managed leaves in the pool stay within the budget after every
   step and fetch. The launcher's ``svm stream:`` line must equal the
   phase's for its mode, and its ``svm sched[...]`` block must equal
   ``schedule_report`` of the phase's own ``run_schedule`` on the served
   spec with the launcher's arguments.

   The sched phase (``repro_torch.svm.scheduler``, on the host, after
   falcon-mamba-7b's launcher run): both served specs round-robin, 8
   requests (seed 3, mean interarrival 0.01 s), 32 tokens, a pool of 0.9
   of the larger spec, ``pin_frac`` 0.4, each policy (fifo, admission,
   svm_aware) clean and under ``FaultPlan.default(0)``. It fails unless
   the fused, per-token and scalar tiers agree, per-request accounting
   sums to the manager's, a rerun is bit-identical, and a chaos run
   applies every event with no request failed. It prints each run's
   simulated p50/p99 latency under the H100 preset, evictions a token,
   peak DOS and the host seconds of each tier, and which headline
   numbers svm_aware shares with admission.

   Every serve phase also checks that the served params are bit for bit
   what init made (``param_sums``) after serving and after
   ``compare_paths``.
7. The later decoders (``NEW_ARCHS``): flash attention at their prefill
   shapes (D = 64 at 32:8; D = 128 at 48:1 and at 32:8 with a 4096
   window), the matmul kernel at granite-moe-1b-a400m's shapes, its 3·E
   expert products a layer (``moe_case``, at capacity 1280 in prefill and
   8 in decode) against ``torch.bmm``, and at granite-20b's decode
   shapes; then lighter serve phases of granite-moe-1b-a400m,
   granite-3-2b, chatglm3-6b, granite-20b and mixtral-8x7b (full width;
   mixtral cut to DEPTH_CUT layers; its matmul shapes over all 32 layers
   are timed resident for the streamed run's kernel lines): the same
   launch, route and output checks (the router and every expert product
   on wgmma in prefill and on decode in decode), 2 prefill repeats, the
   device profile for granite-moe and granite-20b only, ``compare_paths``
   on the first PATHS_LAYERS layers (the others freed first but for
   granite-moe, whose SVM phase reads them), and the reduced config
   against the CPU (MoE
   layers replay the CPU's routing: ``RouteTape``). granite-moe also runs
   the SVM phase and the launcher with ``--svm-budget-frac 0.6
   --svm-mode svm_aware --requests 8``.
   Then the VLM and the encoder-decoder (``CTX_ARCHS``:
   llama-3.2-vision-11b, seamless-m4t-medium), whole at full width, each
   serving the launcher's context (``serve.context``: stub image patches,
   or frames that seamless encodes again in every decode token): flash
   attention at their shapes (non-causal, S != T, T = 6 404, S = 1 on the
   wgmma route, and the reduced VLM's cross-attention on mma_sync), the
   matmul kernel at every shape of their prefill and decode token
   (``context_matmuls``: the context's K/V at M = 25 616, seamless's tied
   head at N = 256 256), then their serve phases: the launches by kernel
   and route of a prefill and of every token exactly as ``CTX_COUNTS``,
   2 prefill repeats, the device profile for the VLM only,
   ``compare_paths`` on whole periods (``CTX_PATHS_LAYERS``; seamless's
   whole encoder in the path) on a copy of the params with every
   cross-attention gate at PATHS_GATE (init leaves them at 0, which makes
   cross-attention a no-op), after a check that the gates move the
   logits beyond MODEL_TOL, and the reduced config against the CPU with
   the gates at REDUCED_GATE; seamless also runs the SVM phase and the
   launcher with ``--svm-budget-frac 0.6 --svm-mode svm_aware
   --requests 8``.
7'. jamba-1.5-large-398b at full width cut to JAMBA_LAYERS = 5 of its 72
   layers, unstacked as ``remainder/r0..r4`` (the smallest cut that holds
   each layer kind: (mamba, mlp), (mamba, moe) and (attn, mlp); 48.09 GB
   of bf16 weights): flash attention at its shape (64:8, D 128, global
   causal), the scan at (4, 1024, 16384, 16), the matmul kernel at every
   shape of its prefill and token (the 16 experts' products by
   ``moe_case``), then its serve phase with the same launch, route and
   output checks (4 scan launches and 1 flash launch a prefill, none in
   a token), 2 prefill repeats and the device profile. ``compare_paths``
   runs on its first JAMBA_PATHS_LAYERS layers (r0, r1), r2 to r4 freed
   first, on a copy whose Mamba mixers take LOUD_FULL with dt_bias 0
   (``loud_copy``), after ``check_layers_live`` has shown that zeroing
   the scan's y, the MLP or the MoE moves that copy's prefill logits
   beyond MODEL_TOL; the reduced config runs against the CPU with
   LOUD_MODEL on every Mamba mixer, whose CPU logits must differ from
   init's beyond MODEL_TOL.
7m. (Run right after phase 7's decoders.) granite-moe-1b-a400m at full
   width and all 24 layers through a 1-rank ``DeviceMesh``: flash
   attention at its prefill shape (16:8, D 64) against its plain
   version; then a 1-rank NCCL group (``HashStore``, ``device_id``
   cuda:0, no port) and ``launch/mesh.make_host_mesh("cuda")``. The
   launcher's serving path (``run_prefill``, then MESH_DECODE greedy
   tokens by ``run_decode``; batch 4, prompts of 1024, seed 0) runs
   resident, then with the params placed as DTensors by
   ``launch/sharding.param_specs`` (``fsdp_serve`` from the arch's
   settings), the prompts by ``batch_spec`` and the prefill's cache by
   ``cache_specs``, the MoE on the shard-local path (``moe_apply(...,
   mesh=)``: each rank's expert slices, one all_reduce of y over
   'model'). It fails unless the mesh run's logits and tokens equal the
   resident run's bit for bit and its launches by kernel and route equal
   the resident run's (the counts set to 0 before each run's prefill);
   then one more run of each, mesh first, held to the same bits, so that
   the walls come in turns (resident, mesh, mesh, resident); and one
   token of each under cProfile (``host_hotspots``: its host time by
   function). Then the dry run (``launch/dryrun.py``, counted from the
   placements; ``dryrun_check``): its per-rank bytes of params, the
   prefill's cache and the prompts for that cell on the 1 x 1 mesh must
   equal what the placed DTensors hold (each ``to_local()``'s nbytes)
   with ``==``; its collective count there (none: every axis has one
   rank) beside the port's 72 all_reduces a call; the roofline's
   compute and memory terms (``launch/roofline.py``, one H100's
   figures) beside the resident walls; and the whole sweep (every arch x
   shape at 16x16 and 2x16x16, ``sweep_check``) on the host, timed, no
   row in error. Then ``compressed_psum`` of a (49 155, 1 024) fp32
   tensor over the group must equal ``decompress(compress(x))`` with
   ``==``, and the tensors it hands to ``all_reduce`` are recorded: the
   MAX of the fp32 scales and the SUM of int32 values (what crosses the
   wire, more bytes than fp32; q's int8 stays on the rank). And
   ``make_production_mesh()`` must raise ``ValueError`` at world size 1.
   The group is destroyed in a ``finally``; the phase's seconds, and the
   dry run's check's, go on the ``cut:`` line.
8. Training (after the serve phases, their memory freed):
   (a) the flash backward kernel (``flash_attention_bwd``) at BWD_CASES:
   granite-3-2b's microbatch (32:8, D 64, causal), gemma3-1b's local
   layers (4:1, D 256, window 512), the VLM's cross-attention (D 128, S
   1024 against T 6 404), the reduced D = 16, and edges (D 32 with S < T
   and a window, S > T, non-causal with a window, S = T = 6 404 causal
   with a window): the route each case takes (``bwd_route``: wgmma for
   D >= 64, mma_sync for D = 16 and 32) asserted and printed, the forward
   route's row log-sum-exp against the plain version's, dq, dk and dv
   against
   ``flash_attention_bwd_ref`` on the same inputs (BWD_TOL: an atol a
   row of dq, a key of dk and dv), a second call's bits against the
   first's, the tolerances' power to reject a zeroed and a 10 %-off
   output, whole or in the back half of its rows; the kernel's relative
   L2 distance to an fp64 truth within PATH_RATIO of the plain
   version's; timed beside the plain version and the backward pass of
   SDPA through autograd.
   (a') The serving scan's outputs at SERVE_SCAN_CASES against
   SERVE_SCAN_DIGEST, the bits the kernel gave before its training
   instance; then the scan's backward kernel (``mamba_scan_bwd``) at
   SCAN_BWD_CASES, after ptxas's registers and spills for each of its
   instances (none may spill at N = 16): falcon-mamba-7b's training
   microbatch (1, 1024, 8192, 16) with x in bf16, the reduced config's
   shape, ragged S, several segments of a length that does not divide S,
   D = 8190, every padded N (1 to 64), Bt > 1, dh_last given (each case
   prints its plan: segments, blocks an SM; and its us a step): the
   forward's training instance (chunk states) against its plain version,
   then d dt, dA, dB, dC and dx against ``mamba_scan_bwd_ref`` on the same
   inputs within SCAN_BWD_TOL (an atol a channel of d dt and dx, a step
   of dB and dC), the tolerances' power to reject a zeroed and a 10 %-off
   output, whole or in the first half of the steps (where the reverse
   pass ends), a second call's bits against the first's, each grad's
   relative L2 distance to an fp64 truth within PATH_RATIO of the plain
   version's; timed beside its bound and the plain version, and the
   forward with and without chunk states.
   (c) One train step (the arch's optimizer: AdamW, adafactor for jamba)
   of each reduced config on the card against the CPU: loss and grad
   norm within 2e-2 (MoE layers on the CPU's routing, gates at
   REDUCED_GATE).
   The matmul kernel at the training shapes of granite-3-2b's microbatch:
   each projection's forward, dA and dW products and the tied head's
   chunk, beside ``torch.matmul`` and the transposes.
   (b) On granite-3-2b's full-width params cut to TRAIN_PATHS_LAYERS
   layers, one microbatch's grads through the kernels and through the
   plain path, each against an fp32 plain run: every leaf's relative L2
   through the kernels within PATH_RATIO of the plain path's.
   (d) granite-3-2b at full width: its fresh params equal the ones its
   serve phase served, then 3 steps of ``make_train_step`` (4
   microbatches of 2 x 1024 tokens, AdamW) through ``TrainSupervisor``
   with a checkpoint period past the run; finite losses and grad norms,
   launches a step by kernel and route exactly ``train_counts``, every
   leaf moved; step walls, tokens/s, peak memory, and one more step under
   the profiler (device busy, idle share, the kernels and the ops that
   take the most device time).
   (b') and (d') The same for falcon-mamba-7b at full width cut to
   MAMBA_TRAIN_LAYERS of its 64 layers (16 microbatches of 1 x 1024
   tokens, AdamW): (b') on its first TRAIN_PATHS_LAYERS layers, then 3
   steps whose launches are exactly ``train_counts`` (the scan forward
   twice and its backward once a layer and microbatch) and whose peak
   memory stays under MAMBA_PEAK_GB.
   (e) ``python -m repro_torch.launch.train --reduced --steps 4`` into a
   temporary ``--ckpt``, twice: the second run resumes from step 4 with
   the first run's state bit for bit; then ``--arch
   jamba-1.5-large-398b`` once, on CUDA (adafactor).
9. The paper's Category-I and Category-II workloads: holds the STREAM
   triad and Jacobi-2d kernels against their plain versions bit for bit
   (fp32 triad: at most 1 ulp, the count printed) at (32768, 32768) in
   fp32 and bf16, above 2^31 elements and on ragged grids; runs Category
   I (one triad) and Category II (4 sweeps, as ``Jacobi2d``'s trace
   orders them) at (32768, 32768) fp32 through ``repro_torch.kernels.ops``
   with launch counts; prints one ``dos_sweep`` of the port's copy of the
   SVM core. Then frees all of it.
10. Prints the host link's copy rate (``link_bw``: a 1 GiB pinned tensor,
   ``.to("cuda", non_blocking=True)``, CUDA events, median of 5; the
   pageable rate beside it) and the serving rate of each model (its decode
   flops as the weight stream counts them, 2 x batch x params a token,
   over the decode step's device-busy time, and over its wall time): the
   two numbers of ``repro_torch.core.costmodel``'s H100 preset.
11. Prints one JSON line of kernel numbers, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Every time is the median over repeats, timed with CUDA events; a plain
version is timed once (``time_plain_ms``); matmul timings cycle through
copies of B that exceed the 50 MB L2, so weights are read cold, as in a
decode step, and are read after ``free_memory`` (with ``ms_cached``
before it, as for the data kernels). Per-case detail goes to
``chiprun_out/chip_smoke.json``. Any failure exits non-zero.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

HBM_BYTES_S = 3.35e12                              # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense; fp32 off the tensor cores
# exponentials per second: 132 SMs x 16 per clock on the special-function
# units x 1.98 GHz, the H100 SXM's top boost clock
EXP_RATE = 132 * 16 * 1.98e9
L2_BYTES = 50 * 2 ** 20
BATCH, PROMPT, DECODE = 4, 1024, 32
# a tolerance's atol_rel is an atol as a fraction of the largest |want| of
# the tensor; where it has atol too, the smaller of the two holds; its
# atol_row adds, for each element, that fraction of the largest |want| of
# its row (the last axis)
MM_TOL = {torch.bfloat16: dict(rtol=1e-2, atol=1e-2),   # one bf16 rounding of the output
          torch.float32: dict(rtol=1e-4, atol=1e-4)}
# P rounded to bf16 against another running max; atol_rel keeps the limit
# below 10 % of the output where attention averages many keys (|out| << 1)
FA_TOL = dict(rtol=2e-2, atol=2e-2, atol_rel=2e-2)
# the scan's y and state are small at the model's init (|y| ~ 1e-2), so
# their limits follow the tensor: rtol 8e-3 is one bf16 rounding of y
SCAN_TOL = {torch.float32: dict(rtol=2e-3, atol=2e-3, atol_rel=1e-3),  # test_kernels.py's
            torch.bfloat16: dict(rtol=8e-3, atol_rel=1e-3)}
H_TOL = dict(rtol=2e-3, atol=2e-3, atol_rel=1e-3)   # the fp32 state, fp32 in both versions
MODEL_TOL = dict(rtol=2e-2, atol=2e-2, atol_rel=2e-2)  # the repo's bf16 model tolerance (test_arch_smoke)
# gains on the init of a reduced config's Mamba mixers, with dt_bias 0, so
# that its Mamba layers move the logits it is checked by (as
# tests/test_torch_mamba.py's LOUD_MODEL)
LOUD_MODEL = {"in_proj": 3.0, "conv_w": 3.0, "x_proj": 3.0, "out_proj": 1.0}
# the same for jamba's full-width path check (``loud_copy``), with dt_bias
# 0: LOUD_MODEL's gains were sized at d_model 64, and at 8192 the init's
# 0.02-std weights already grow each projection's output with its width,
# so the in_proj, conv_w and x_proj gains would compound into a Mamba
# output far above the FFNs'; ``check_layers_live`` fails the run unless
# zeroing the scan's y, the MLP or the MoE each moves this copy's logits
LOUD_FULL = {"out_proj": 4.0}
# the paper workloads' grid: 4 GiB per fp32 array, 85x the L2 (STREAM asks
# for 4x the last-level cache); BIG has more than 2^31 elements
GRID = (32768, 32768)
BIG = (65537, 32768)
STREAM_SCALAR = 3.0  # STREAM's own triad scalar
CAP_GB = 8           # the simulated device of the dos_sweep line
PATH_RATIO = 1.5     # see compare_paths
MARGIN = 0.25        # a top-2 logit gap that bf16 noise at full width does not close
PREFILL_REPEATS = 5
SVM_FRAC = 0.6         # the SVM phase's pool, a fraction of the weights
SVM_MATERIALIZED = 3   # tokens of the materialized SVM run
LINK_BYTES = 1 << 30   # the host-link probe's tensor
LINK_REPS = 5
# the sched phase's mix: both full-width specs round-robin over one pool
# of 0.9 of the larger spec's bytes
SCHED_REQUESTS = 8
SCHED_FRAC = 0.9
SCHED_MIX = dict(seed=3, mean_interarrival_s=0.01, tokens=DECODE,
                 spec_choice="roundrobin", pin_frac=0.4)
# what the sched phase prints and compares between policies
SCHED_HEADLINE = ("latency_p50_s", "latency_p90_s", "latency_p99_s",
                  "agg_tok_s", "makespan_s", "migrations", "evictions",
                  "evictions_per_token", "dos_peak")
# each model's launcher run: the SVM mode of its svm stream line, then the
# multi-tenant flags of its svm sched block
LAUNCHER_RUNS = {
    "gemma3-1b": ("svm_aware", dict(policy="svm_aware", admit_by="bytes",
                                    chaos=True)),
    "falcon-mamba-7b": ("zero_copy", dict(policy="admission",
                                          admit_by="measured", chaos=False)),
    "granite-moe-1b-a400m": ("svm_aware", dict(policy="svm_aware",
                                               admit_by="bytes", chaos=False)),
    "seamless-m4t-medium": ("svm_aware", dict(policy="svm_aware",
                                              admit_by="bytes", chaos=False)),
}
# the decoders ported after the first two, served in this order by lighter
# phases: NEW_PREFILL_REPEATS repeats, the device profile only for
# NEW_PROFILED, the SVM phase and a launcher run only for the MoE arch
# (pinned host copies of the larger ones would take 12 to 41 GB),
# compare_paths on the first PATHS_LAYERS layers; mixtral-8x7b (93.4 GB in
# bf16) at full width cut to DEPTH_CUT layers
MOE_ARCH = "granite-moe-1b-a400m"
NEW_ARCHS = (MOE_ARCH, "granite-3-2b", "chatglm3-6b", "granite-20b",
             "mixtral-8x7b")
NEW_PROFILED = (MOE_ARCH, "granite-20b")
NEW_PREFILL_REPEATS = 2
PATHS_LAYERS = 4
DEPTH_CUT = {"mixtral-8x7b": 8}
# mixtral-8x7b streamed at full depth (stream_phase): the weights made
# leaf by leaf into pinned host blocks of at most STREAM_BLOCK bytes, with
# STREAM_HOST_RESERVE of host memory left beside them (the depth is cut to
# what fits); a pool of SVM_FRAC of them; each of STREAM_POLICIES through
# a prefill and STREAM_DECODE tokens (cut from DECODE: every token moves
# most of the 93 GB over the host link; 4, not 8, to pay for jamba's
# phase); its first STREAM_CHECK_LAYERS layers streamed against resident;
# the card's peak under STREAM_PEAK_GB
MESH_DECODE = 8        # tokens of the mesh phase's two runs
STREAM_ARCH = "mixtral-8x7b"
STREAM_DECODE = 4
STREAM_CHECK_LAYERS = 8
STREAM_BLOCK = 8 << 30
STREAM_HOST_RESERVE = 4 * 10 ** 9
STREAM_PEAK_GB = 80
STREAM_POLICIES = {"naive": {},
                   "svm_aware": dict(prefetch=True, pin=("embed", "lm_head"))}
# the port's examples (examples/torch), each run once on the card and once
# on the CPU; train_oversubscribed for EXAMPLE_TRAIN_STEPS steps
EXAMPLES = ("quickstart", "serve_streaming", "serve_multitenant",
            "train_oversubscribed")
EXAMPLE_TRAIN_STEPS = 3
# every loss the two training examples print, card against CPU from the
# same params, relative: 10x the largest reading (2.1e-5 quickstart,
# 9.5e-5 train_oversubscribed, at the printed 4 and 3 decimals)
EXAMPLE_LOSS_TOL = 1e-3
# the VLM and the encoder-decoder, served whole at full width by lighter
# phases (NEW_PREFILL_REPEATS repeats); the device profile for the VLM
# only, the SVM phase and a launcher run for the encoder-decoder only.
# compare_paths cuts whole periods: the VLM's first (5 layers, its first
# cross layer l3), the encoder-decoder's first two (4 layers) with its
# whole encoder
VLM_ARCH, ENCDEC_ARCH = "llama-3.2-vision-11b", "seamless-m4t-medium"
CTX_ARCHS = (VLM_ARCH, ENCDEC_ARCH)
CTX_PATHS_LAYERS = {VLM_ARCH: 5, ENCDEC_ARCH: 4}
# every cross-attention gate is 0 at init, which makes its layer a no-op:
# compare_paths runs a copy of the served params with the gates at
# PATHS_GATE, the reduced configs run with REDUCED_GATE
PATHS_GATE = 1.0
REDUCED_GATE = 0.5
# launches of a prefill and of one decode token by kernel and route, read
# off the model code: the VLM's 40 layers (32 self-attention, 8
# cross-attention) of 7 matmuls each and the LM head; in a token the 8
# cross layers project the context (4 x 6404 rows) on wgmma and attend at
# S = 1. seamless's 12 encoder layers of 7, 12 (attn, none) of 4 and 12
# (cross, mlp) of 7, and the head; a token encodes the frames again and
# projects them in the 12 cross layers (wgmma), and attends 12 + 12 times
CTX_COUNTS = {
    VLM_ARCH: dict(prefill=dict(matmul={"wgmma": 280, "decode": 1},
                                flash_attention={"wgmma": 40}),
                   token=dict(matmul={"wgmma": 16, "decode": 265},
                              flash_attention={"wgmma": 8})),
    ENCDEC_ARCH: dict(prefill=dict(matmul={"wgmma": 216, "decode": 1},
                                   flash_attention={"wgmma": 36}),
                      token=dict(matmul={"wgmma": 108, "decode": 109},
                                 flash_attention={"wgmma": 24})),
}

# the train phase: granite-3-2b at full width, its TrainSettings'
# microbatches, global batch 8 x 1024 tokens, 3 steps of AdamW through
# TrainSupervisor; phase (b) cuts it to TRAIN_PATHS_LAYERS layers, phase
# (e) runs the launcher on the reduced config for LAUNCHER_TRAIN_STEPS
TRAIN_ARCH = "granite-3-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 3
TRAIN_PATHS_LAYERS = 4
# falcon-mamba-7b trained at full width through the scan's kernels: its
# TrainSettings' 16 microbatches, global batch 16 x 1024 tokens, AdamW,
# TRAIN_STEPS steps; cut in depth to MAMBA_TRAIN_LAYERS of its 64 layers,
# the deepest multiple of 4 whose peak memory stays under 72 GB (params,
# AdamW's fp32 moments and the bf16 grads take about 24.5 bytes a param)
MAMBA_ARCH = "falcon-mamba-7b"
MAMBA_TRAIN_BATCH = 16
MAMBA_TRAIN_LAYERS = 20
MAMBA_PEAK_GB = 72
LAUNCHER_TRAIN_STEPS = 4
# jamba-1.5-large-398b (797 GB in bf16) at full width cut to JAMBA_LAYERS
# of its 72 layers, unstacked as remainder/r0..r4: the smallest cut that
# holds each layer kind, (mamba, mlp) r0, (mamba, moe) r1 and (attn, mlp)
# r4 (48.09 GB); compare_paths on its first JAMBA_PATHS_LAYERS layers (r0,
# r1 with the embedding and the head: 24.4 GB, 48.7 GB in fp32) with r2 to
# r4 freed first
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA_LAYERS = 5
JAMBA_PATHS_LAYERS = 2
# the row log-sum-exp, fp32 in both versions (the wgmma route's ex2.approx
# within 2^-22 a term)
LSE_TOL = dict(rtol=1e-3, atol=1e-3)
# dq, dk and dv: P and dS are rounded to bf16 as product operands (2^-9
# of each term), so an element's error follows its row's sum of |dS K|
# (dq) or its key's of |dS^T Q| (dk) and |P^T dO| (dv), which cancel to
# far less than that: the atol is 2e-2 of the largest |want| of the
# element's own row of dq or key of dk and dv, not of the tensor (under
# the causal mask the first rows and keys hold values 100x the last
# ones'), with a floor of 1e-4 of the tensor's largest for the rows
# whose true value is 0 (dq's first row: P = 1 makes dS vanish up to
# fp32 rounding, and the two versions round differently)
BWD_TOL = dict(rtol=2e-2, atol_row=2e-2, atol_rel=1e-4)
# loss and grad norm of one reduced train step, card against CPU, relative
REDUCED_TRAIN_TOL = 2e-2
# the reduced configs reduced_vs_cpu covers: one train step each
TRAIN_REDUCED = ("gemma3-1b", MOE_ARCH, "granite-3-2b", "chatglm3-6b",
                 "granite-20b", "mixtral-8x7b", VLM_ARCH, ENCDEC_ARCH,
                 MAMBA_ARCH, JAMBA_ARCH)
# the backward kernel's cases and the route each takes: granite-3-2b's
# microbatch (32:8, D 64, causal), gemma3-1b's local layers (4:1, D 256,
# window 512), the VLM's cross-attention (32:8, D 128, S 1024 against T
# 6 404), the reduced granite-3-2b (D 16), and edges: D 32 with S < T and
# a window, S > T, non-causal with a window, and a ragged S = T = 6 404,
# causal with a window, where the causal rule hides a prefix and the
# window a suffix of each block's tiles
BWD_CASES = ((2, 32, 8, 1024, 1024, 64, True, 0, "granite-3-2b", "wgmma"),
             (2, 4, 1, 1024, 1024, 256, True, 512, "gemma3-1b local", "wgmma"),
             (2, 32, 8, 1024, 6404, 128, False, 0, "vlm cross", "wgmma"),
             (2, 4, 2, 100, 100, 16, True, 0, "reduced", "mma_sync"),
             (1, 4, 2, 100, 150, 32, True, 40, "d32 S<T window", "mma_sync"),
             (1, 4, 1, 300, 200, 128, True, 0, "S>T", "wgmma"),
             (1, 2, 2, 200, 300, 256, False, 100, "nc window", "wgmma"),
             (1, 8, 2, 6404, 6404, 128, True, 1000, "T6404 window", "wgmma"))

# the scan's backward kernel against its plain version, both fp32 but for
# dx (x's dtype): the reverse recurrence carries g over many steps and the
# sums over D and Bt add in other orders, so an element's error follows
# its channel's largest |want| (d dt, dx: atol_row over the steps of a
# channel) or its step's (dB, dC: over the states of a step), dA its
# channel's; rtol 2e-3 is SCAN_TOL's fp32 rtol, 8e-3 one bf16 rounding
SCAN_BWD_TOL = {torch.float32: dict(rtol=2e-3, atol_row=1e-3, atol_rel=1e-5),
                torch.bfloat16: dict(rtol=8e-3, atol_row=1e-3, atol_rel=1e-5)}
# FP32 instructions a state-step of the backward pass: the recompute's
# dt * A, u * B and h FMA; g, the dB, dC and du partials, a h, g a h, the
# d dt and dA sums and the carry a g
SCAN_BWD_FP32 = 12
# the serving scan (a null chunk-state pointer) at SERVE_SCAN_CASES, (Bt,
# S, D, N, x dtype): the scan phase's cases and falcon-mamba-7b's prefill
# shape. The inputs are uniform draws of numpy's PCG64 seeded by S * 13 +
# D + N, the same bits on any numpy and torch; the sha256 of the outputs'
# bytes (y, then h_last, a case after another) must be SERVE_SCAN_DIGEST,
# the bits the kernel gave before its training instance was added. A
# change to the serving scan that alters its bits on purpose retakes it.
SERVE_SCAN_CASES = (
    (1, 128, 512, 16, torch.float32), (2, 256, 1024, 16, torch.float32),
    (2, 128, 640, 8, torch.float32), (1, 1000, 512, 16, torch.float32),
    (2, 37, 640, 4, torch.float32), (3, 200, 384, 8, torch.float32),
    (2, 300, 640, 1, torch.float32), (2, 200, 512, 32, torch.float32),
    (1, 100, 384, 64, torch.float32), (2, 24, 128, 4, torch.bfloat16),
    (2, 250, 8190, 16, torch.bfloat16), (1, 4096, 1024, 16, torch.bfloat16),
    (2, 64, 8192, 64, torch.bfloat16), (4, 1024, 8192, 16, torch.bfloat16))
SERVE_SCAN_DIGEST = (
    "5de8a1a7c43ecc7309d21e07a6685a1bc1534d0d1ee0cf2699b9663549d9ebb0")
# (Bt, S, D, N, x dtype, tag, options): falcon-mamba-7b's training
# microbatch (1 x 1024 tokens, d_inner 8192, N 16) and its reduced
# config's, ragged S with dh_last, several segments whose length does
# not divide S with the model's dt (a carry reaches across about 100
# steps) and dh_last, D = 8190 (rows not 16-byte aligned), every padded
# instance (N = 1, 4, 8, 16, 32, 64), Bt > 1
SCAN_BWD_CASES = (
    (1, 1024, 8192, 16, torch.bfloat16, "microbatch", dict(model_like=True)),
    (2, 64, 128, 4, torch.bfloat16, "reduced", dict(model_like=True)),
    (1, 1000, 512, 16, torch.float32, "ragged S", dict(dh=True)),
    (2, 1000, 1024, 16, torch.bfloat16, "segmented",
     dict(model_like=True, dh=True)),
    (2, 250, 8190, 16, torch.bfloat16, "ragged D", dict(model_like=True)),
    (2, 300, 640, 1, torch.float32, "N=1", dict(dh=True)),
    (3, 37, 640, 4, torch.float32, "N=4 Bt=3", {}),
    (4, 33, 256, 8, torch.float32, "N=8", dict(dh=True)),
    (2, 200, 512, 32, torch.float32, "N=32", {}),
    (1, 100, 384, 64, torch.float32, "N=64", dict(dh=True)),
    (2, 64, 8192, 64, torch.bfloat16, "N=64 model", dict(model_like=True)))


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def time_ms(fn, arg_sets, reps: int = 10, warmup: int = 3) -> float:
    """Median ms of one call of ``fn``, cycling through ``arg_sets``. The
    calls are captured once in a CUDA graph and the graph is replayed, so
    the time is the device's, not the host's launch overhead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up off the capture
        for args in arg_sets[:warmup]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in arg_sets:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / len(arg_sets))
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


# what timing each plain version once costs, and at least what it saves
# against three warm-up calls and ten replays (each call no shorter than
# its measured device time)
PLAIN_TIMING = dict(cases=0, seconds=0.0, saved_s=0.0)


def time_plain_ms(fn, arg_sets) -> float:
    """``time_ms`` of a plain version: one warm-up call and one timed
    replay (a plain version's time is no yardstick); counted in
    PLAIN_TIMING."""
    t0 = time.perf_counter()
    ms = time_ms(fn, arg_sets, reps=1, warmup=1)
    n = len(arg_sets)
    PLAIN_TIMING["cases"] += 1
    PLAIN_TIMING["seconds"] += time.perf_counter() - t0
    PLAIN_TIMING["saved_s"] += (min(3, n) - 1 + 9 * n) * ms / 1e3
    return ms


def bound_ms(nbytes: float, flops: float, dtype, exps: float = 0.0
             ) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate, or the
    operations (flops at the dtype's peak, exponentials at EXP_RATE)."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(flops / PEAK_FLOPS[dtype], exps / EXP_RATE)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def atol_of(want, tol):
    """The atol of ``tol`` for ``want``: a float, or with ``atol_row`` a
    tensor of one atol a row."""
    atol = tol.get("atol", math.inf)
    if "atol_rel" in tol:
        atol = min(atol, tol["atol_rel"] * want.float().abs().max().item())
    if "atol_row" in tol:
        atol = atol + tol["atol_row"] * want.float().abs().amax(-1, keepdim=True)
    return atol


def within(got, want, tol) -> bool:
    """Elementwise |got - want| <= atol + rtol |want|."""
    err = (got.float() - want.float()).abs()
    return bool((err <= atol_of(want, tol) + tol["rtol"] * want.float().abs()).all())


def check_close(name: str, got, want, tol) -> float:
    """Raises unless ``got`` is finite and within ``tol`` of ``want``;
    returns max |err|."""
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    if not within(got, want, tol):
        atol = atol_of(want, tol)
        if torch.is_tensor(atol):
            atol = atol.max().item()
        raise AssertionError(f"{name}: max |err| {err:.3e} over tolerance "
                             f"rtol={tol['rtol']} atol={atol:.3e}")
    return err


def check_discerns(name: str, want, tol, rows: bool = False) -> None:
    """The tolerance must reject an output of zeros and one 10% off; with
    ``rows``, also one whose back half of rows (the second-last axis, of
    the rows that hold a nonzero value anywhere) is zeroed or 10% off."""
    bads = [torch.zeros_like(want), want * 1.1]
    if rows:
        flat = want.reshape(-1, *want.shape[-2:])
        live = torch.nonzero(flat.abs().amax(-1).amax(0) > 0).flatten()
        back = live[len(live) // 2:]
        for f in (0.0, 1.1):
            bad = flat.clone()
            bad[:, back] *= f
            bads.append(bad.reshape(want.shape))
    for bad in bads:
        if within(bad, want, tol):
            raise AssertionError(f"{name}: tolerance {tol} passes a zeroed or "
                                 f"10%-off output, or one zeroed or 10% off "
                                 f"in its back half of rows")


# ------------------------------------------- paper workloads (Categories I, II)

def _ordered(x):
    """fp32 bits as integers in the order of the values (one step = 1 ulp)."""
    bits = x.view(torch.int32).long()
    return torch.where(bits >= 0, bits, -(bits & 0x7FFFFFFF))


def check_bits(name, got, want, max_ulp: int = 0) -> tuple[int, float]:
    """Raises unless ``got`` equals ``want`` bit for bit, or (fp32 with
    ``max_ulp``) within that many ulps; returns (elements that differ,
    max |diff|)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape} {got.dtype} against "
                             f"{want.shape} {want.dtype}")
    ints = torch.int32 if got.dtype == torch.float32 else torch.int16
    differ = int((got.view(ints) != want.view(ints)).sum())
    if not differ:
        return 0, 0.0
    err = (got.float() - want.float()).abs().max().item()
    ulps = ((_ordered(got) - _ordered(want)).abs().max().item()
            if got.dtype == torch.float32 else math.inf)
    print(f"{name}: {differ} elements differ, max |diff| {err:.3e}, "
          f"max {ulps} ulp", flush=True)
    if ulps > max_ulp:
        raise AssertionError(f"{name}: {differ} elements differ from the plain "
                             f"version (max |diff| {err:.3e}, {ulps} ulp; "
                             f"allowed {max_ulp})")
    return differ, err


def timed_calls(kernel, plain, library=None, arg_sets=((),)) -> dict:
    """Graph-replay ms of a kernel, its plain version and the library call,
    each cycling through ``arg_sets``. ``ms_cached`` is the kernel's time
    while the blocks the check freed still sit in the allocator's cache;
    ``ms`` and the others are read after ``free_memory`` hands them back to
    the driver. (On the H100 the triad and Jacobi-2d kernels read up to 12 %
    slower in the first state: PERF.md.)"""
    arg_sets = list(arg_sets)
    ms_cached = time_ms(kernel, arg_sets)
    free_memory()
    return dict(ms_cached=ms_cached, ms=time_ms(kernel, arg_sets),
                plain_ms=time_plain_ms(plain, arg_sets),
                library_ms=None if library is None else time_ms(library, arg_sets))


def _grid(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda", dtype=dtype)


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def triad_case(shape, dtype, alphas, timed=False):
    """The triad kernel against its plain version at each alpha: bf16 bit
    for bit, fp32 within 1 ulp (the kernel's FMA rounds once; the plain
    version reaches the same single rounding from fp64)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import stream_triad as ktriad

    b, c = _grid(shape, dtype, 1 + shape[0]), _grid(shape, dtype, 2 + shape[1])
    rows = []
    for alpha in alphas:
        got = ktriad.triad(b, c, alpha)
        want = ref.triad_ref(b, c, alpha)
        torch.cuda.synchronize()
        tag = f"triad {shape} {_dt(dtype)} alpha={alpha}"
        differ, err = check_bits(tag, got, want,
                                 1 if dtype == torch.float32 else 0)
        del got, want
        row = dict(shape=list(shape), dtype=_dt(dtype), alpha=alpha,
                   elements_differ=differ, max_abs_err=err)
        if timed:
            row.update(timed_calls(lambda: ktriad.triad(b, c, alpha),
                                   lambda: ref.triad_ref(b, c, alpha),
                                   lambda: torch.add(b, c, alpha=alpha)))
            row["bound_ms"], row["bound_by"] = bound_ms(
                3 * b.numel() * b.element_size(), 0.0, dtype)
        print(f"{tag}: {differ} elements differ"
              + (f"; kernel {row['ms']:.4f} ms ({row['ms_cached']:.4f} with "
                 f"the check's blocks cached)  plain {row['plain_ms']:.4f}  "
                 f"torch.add {row['library_ms']:.4f}  bound "
                 f"{row['bound_ms']:.4f} ({row['bound_by']})" if timed else ""),
              flush=True)
        rows.append(row)
    return rows


def jacobi_case(shape, dtype, timed=False):
    """The Jacobi-2d kernel against its plain version bit for bit, and its
    boundary rows and columns against the input."""
    from repro_torch.kernels import jacobi2d as kjac
    from repro_torch.kernels import ref

    a = _grid(shape, dtype, 3 + shape[0] + shape[1])
    got = kjac.jacobi2d(a)
    want = ref.jacobi2d_ref(a)
    torch.cuda.synchronize()
    tag = f"jacobi2d {shape} {_dt(dtype)}"
    differ, err = check_bits(tag, got, want)
    for edge in ((0,), (-1,), (slice(None), 0), (slice(None), -1)):
        check_bits(f"{tag} boundary {edge}", got[edge].contiguous(),
                   a[edge].contiguous())
    del got, want
    row = dict(shape=list(shape), dtype=_dt(dtype), elements_differ=differ,
               max_abs_err=err)
    if timed:
        row.update(timed_calls(lambda: kjac.jacobi2d(a),
                               lambda: ref.jacobi2d_ref(a)))
        row["bound_ms"], row["bound_by"] = bound_ms(
            2 * a.numel() * a.element_size(), 0.0, dtype)
    print(f"{tag}: {differ} elements differ, boundary equal to the input"
          + (f"; kernel {row['ms']:.4f} ms ({row['ms_cached']:.4f} with the "
             f"check's blocks cached)  plain {row['plain_ms']:.4f}  "
             f"bound {row['bound_ms']:.4f} ({row['bound_by']})" if timed else ""),
          flush=True)
    return row


def workloads_run() -> dict:
    """Category I, then Category II as ``Jacobi2d``'s trace orders its
    kernels (B <- J(A), A <- J(B), ITERS times), at GRID in fp32 through
    ``repro_torch.kernels.ops``, with the kernels' launches counted; then
    each output against the plain versions applied in the same order."""
    from repro_torch.core.traces import Jacobi2d
    from repro_torch.kernels import jacobi2d as kjac
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import stream_triad as ktriad

    b, c = _grid(GRID, torch.float32, 11), _grid(GRID, torch.float32, 12)
    A0 = _grid(GRID, torch.float32, 13)
    torch.cuda.synchronize()
    ktriad.launches = kjac.launches = 0
    t0 = time.perf_counter()
    a = ops.triad(b, c, STREAM_SCALAR)
    A = A0
    for _ in range(Jacobi2d.ITERS):
        B = ops.jacobi2d(A)
        A = ops.jacobi2d(B)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {"triad": ktriad.launches, "jacobi2d": kjac.launches}
    want_launches = {"triad": 1, "jacobi2d": 2 * Jacobi2d.ITERS}
    if launches != want_launches:
        raise AssertionError(f"paper workloads: launches {launches}, the "
                             f"traces order {want_launches}")
    tri = check_bits("category I output", a, ref.triad_ref(b, c, STREAM_SCALAR),
                     max_ulp=1)[0]
    del a, b, c, B
    x = A0
    for _ in range(2 * Jacobi2d.ITERS):
        x = ref.jacobi2d_ref(x)
    check_bits("category II output", A, x)
    del A, A0, x
    print(f"paper workloads at {GRID} fp32: category I (1 triad) and "
          f"category II ({2 * Jacobi2d.ITERS} sweeps) in {wall:.2f} ms; "
          f"launches {launches}; outputs equal the plain versions "
          f"({tri} triad elements 1 ulp apart)", flush=True)
    return dict(launches=launches, wall_ms=wall, triad_elements_differ=tri)


def sweep_line() -> dict:
    """One dos_sweep of the port's copy of the SVM core on this machine."""
    from repro_torch.core import GB, dos_sweep

    out = {}
    for label, spec in (("stream", ("stream", {})),
                        ("jacobi2d", ("jacobi2d", {})),
                        ("jacobi2d-svm-aware", ("jacobi2d", {"svm_aware": True}))):
        rows = dos_sweep(spec, (75, 109, 150), CAP_GB * GB, jobs=0)
        out[label] = [r["norm_perf"] for r in rows]
    print(f"dos_sweep (repro_torch.core, {CAP_GB} GB device, DOS 75/109/150, "
          "norm_perf): " + "; ".join(
              f"{k} " + "/".join(f"{v:.4f}" for v in vs) for k, vs in out.items()),
          flush=True)
    return out


def workloads_phase():
    print(f"paper workloads phase: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
          "allocated at its start", flush=True)
    tri = triad_case(GRID, torch.float32, (2.5, 0.1), timed=False)
    tri += triad_case(GRID, torch.float32, (STREAM_SCALAR,), timed=True)
    tri += triad_case(GRID, torch.bfloat16, (2.5, 0.1), timed=False)
    tri += triad_case(GRID, torch.bfloat16, (STREAM_SCALAR,), timed=True)
    free_memory()
    tri += triad_case((65536, 32768), torch.bfloat16, (2.5,))   # 2^31 elements
    free_memory()
    tri += triad_case(BIG, torch.bfloat16, (0.1,))
    free_memory()
    for shape in ((300, 640), (1, 7)):
        for dtype in (torch.float32, torch.bfloat16):
            tri += triad_case(shape, dtype, (2.5, 0.1, 3.0))
    jac = [jacobi_case(GRID, torch.float32, timed=True),
           jacobi_case(GRID, torch.bfloat16, timed=True)]
    free_memory()
    jac.append(jacobi_case(BIG, torch.bfloat16))
    free_memory()
    for shape in ((100, 128), (97, 130), (2, 5), (1, 1)):
        for dtype in (torch.float32, torch.bfloat16):
            jac.append(jacobi_case(shape, dtype))
    run = workloads_run()
    free_memory()
    sweep = sweep_line()
    main_tri = next(r for r in tri if r.get("ms") is not None
                    and r["dtype"] == "float32")
    main_jac = jac[0]
    weighted = {"triad": [(main_tri, run["launches"]["triad"])],
                "jacobi2d": [(main_jac, run["launches"]["jacobi2d"])]}
    return dict(triad=tri, jacobi2d=jac, run=run, dos_sweep=sweep), weighted


# ------------------------------------------------------------------ matmul

def matmul_case(M, K, N, bt, dtype, tag, want_route, misalign=False):
    """One matmul case: the route it takes (asserted), the kernel against
    its plain version, a second call's bits against the first's, the
    tolerance's power to reject a wrong output; for the wgmma route the
    mma_sync route's time at the same shape (``prev_ms``: that route took
    these shapes before the wgmma route), for the decode route its tile
    width and K-slices. With ``misalign`` A starts 2 bytes past a 16-byte
    boundary."""
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(M * 7 + N)
    a = torch.randn((M, K), generator=g, device="cuda").to(dtype)
    if misalign:
        a = torch.cat([a.new_zeros(1), a.flatten()])[1:].view(M, K)
    bshape = (N, K) if bt else (K, N)
    b = (torch.randn(bshape, generator=g, device="cuda") * 0.02).to(dtype)
    before = dict(kmm.route_launches)
    got = kmm.matmul(a, b, b_transposed=bt)
    again = kmm.matmul(a, b, b_transposed=bt)
    taken = [r for r in kmm.ROUTES if kmm.route_launches[r] != before[r]]
    want = ref.matmul_ref(a, b, bt)
    torch.cuda.synchronize()
    if taken != [want_route]:
        raise AssertionError(f"matmul {tag} ({M}, {K}, {N}) took routes "
                             f"{taken}, expected {want_route}")
    err = check_close(f"matmul {tag}", got, want, MM_TOL[dtype])
    check_discerns(f"matmul {tag}", want, MM_TOL[dtype])
    if not torch.equal(got, again):
        raise AssertionError(f"matmul {tag} ({M}, {K}, {N}): two calls on "
                             f"the same inputs differ")
    del got, again, want
    copies = max(1, math.ceil(2 * L2_BYTES / b.nbytes))
    bs = [b] + [b.clone() for _ in range(copies - 1)]
    sets = [(a, x) for x in bs]
    row = dict(tag=tag, M=M, K=K, N=N, b_transposed=bt,
               dtype=str(dtype).replace("torch.", ""), route=want_route,
               misaligned=misalign, max_abs_err=err)
    row.update(timed_calls(lambda x, y: kmm.matmul(x, y, b_transposed=bt),
                           lambda x, y: ref.matmul_ref(x, y, bt),
                           lambda x, y: torch.matmul(x, y.t() if bt else y),
                           arg_sets=sets))
    prev = shape = ""
    if want_route == "wgmma":
        row["tile_n"] = kmm.wgmma_tile_n(M, N, kmm.sm_count(a.device))
        shape = f"/{row['tile_n']}"
        out = torch.empty((M, N), dtype=dtype, device="cuda")
        row["prev_ms"] = time_ms(
            lambda x, y: kmm.launch(x, y, out, "mma_sync"), sets)
        prev = f"  mma_sync {row['prev_ms']:.4f}"
        del out
    elif want_route == "decode":
        row["tile_n"] = kmm.decode_tile_n(N, K)
        row["split"] = kmm.decode_split(N, K, kmm.sm_count(a.device))
        shape = f"/{row['tile_n']} split={row['split']}"
    del bs, sets
    nbytes = (M * K + K * N + M * N) * a.element_size()
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2.0 * M * N * K, dtype)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    print(f"matmul {tag:>14} M={M:<5d} K={K:<5d} N={N:<6d} bt={int(bt)} "
          f"route={want_route}{shape} err={err:.2e} kernel {row['ms']:.4f} ms "
          f"({row['ms_cached']:.4f} cached){prev}  plain {row['plain_ms']:.4f}  "
          f"torch.matmul {row['library_ms']:.4f}  bound {row['bound_ms']:.4f} "
          f"({row['bound_by']}; share {row['bound_share']:.2f})", flush=True)
    return row


def projections(cfg) -> list[tuple[str, int, int, int]]:
    """(tag, K, N, calls) of every matmul shape of one pass over ``cfg``'s
    layers, the calls summed over the layers of each kind: a Mamba layer's
    four projections, a self-attention layer's four, then each FFN's. A
    MoE layer's expert products (tags in EXPERT_TAGS) run over an
    expert's capacity rows, not over the tokens (``moe_case``)."""
    d = cfg.d_model
    mixers = collections.Counter(m for m, _ in cfg.layer_kinds())
    ffns = collections.Counter(f for _, f in cfg.layer_kinds())
    n_mamba, n_attn = mixers["mamba"], cfg.n_layers - mixers["mamba"]
    rows = []
    if n_mamba:
        di, dtr = cfg.d_inner, cfg.resolved_dt_rank
        rows += [("in_proj", d, 2 * di, n_mamba),
                 ("x_proj", di, dtr + 2 * cfg.ssm_state, n_mamba),
                 ("dt_proj", dtr, di, n_mamba), ("out_proj", di, d, n_mamba)]
    f, hd = cfg.d_ff, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    if n_attn:
        rows += [("wq", d, nq, n_attn), ("wk,wv", d, nkv, 2 * n_attn)]
    if ffns["moe"]:
        n, e = ffns["moe"], cfg.n_experts
        rows += [("router", d, e, n), ("experts wi_gate,wi_up", d, f, 2 * e * n)]
    if n_attn:
        rows.append(("attn wo", nq, d, n_attn))
    if ffns["moe"]:
        rows.append(("experts wo", f, d, cfg.n_experts * ffns["moe"]))
    if ffns["mlp"]:
        n = ffns["mlp"]
        rows += [("wi_gate,wi_up", d, f, 2 * n) if cfg.mlp_gated
                 else ("wi_up", d, f, n), ("mlp wo", f, d, n)]
    return rows


EXPERT_TAGS = ("experts wi_gate,wi_up", "experts wo")


def matmul_phase(cfg, phase_names=("decode", "prefill")):
    """Every matmul shape of ``cfg``'s serving path outside MoE experts,
    weighted by its calls per decode token and per prefill; the LM head
    runs on the last position only, in prefill as in decode. MoE layers
    add ``moe_case``'s row at the phase's capacity, weighted by the MoE
    layers."""
    phases = {name: [] for name in phase_names}
    rows = []
    for phase, M, route in (("decode", BATCH, "decode"),
                            ("prefill", BATCH * PROMPT, "wgmma")):
        if phase not in phases:
            continue
        for tag, K, N, calls in projections(cfg):
            if tag in EXPERT_TAGS:
                continue
            r = matmul_case(M, K, N, False, torch.bfloat16, tag, route)
            rows.append(r)
            phases[phase].append((r, calls))
        n_moe = sum(1 for _, f in cfg.layer_kinds() if f == "moe")
        if n_moe:
            r = moe_case(cfg, M)
            rows.append(r)
            phases[phase].append((r, n_moe))
        r = matmul_case(BATCH, cfg.d_model, cfg.padded_vocab,
                        cfg.tie_embeddings, torch.bfloat16, "lm head", "decode")
        rows.append(r)
        phases[phase].append((r, 1))
    return rows, phases


def moe_case(cfg, tokens: int):
    """The 3·E expert products of one MoE layer for ``tokens`` tokens, as
    ``repro_torch.models.moe`` launches them: ``wi_gate`` and ``wi_up`` over
    each expert's (capacity, d) rows of the dispatch buffer and ``wo`` over
    its (capacity, d_ff) rows, one matmul kernel launch each. Each product
    is held against its plain version, with the route asserted and a
    second call's bits against the first's; timed against the plain loop
    and against ``torch.bmm`` over the stacked experts (one call per
    weight matrix: the library's batched route, which the port does not
    use)."""
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ref
    from repro_torch.models.moe import capacity

    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    M = capacity(cfg, tokens)
    want_route = kmm.route(M, f, d, False, torch.bfloat16, (0, 0, 0))
    g = torch.Generator(device="cuda").manual_seed(M * 7 + e)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(torch.bfloat16)
    buf, h = randn(e, M, d), randn(e, M, f)
    wg, wu, wo = (randn(e, d, f, scale=0.02), randn(e, d, f, scale=0.02),
                  randn(e, f, d, scale=0.02))
    products = [(buf, wg), (buf, wu), (h, wo)]

    def kernel_path():
        return [kmm.matmul(a[j], w[j]) for a, w in products for j in range(e)]

    def plain_path():
        return [ref.matmul_ref(a[j], w[j]) for a, w in products for j in range(e)]

    before = dict(kmm.route_launches)
    got, again, want = kernel_path(), kernel_path(), plain_path()
    torch.cuda.synchronize()
    taken = {r: n - before[r] for r, n in kmm.route_launches.items()
             if n != before[r]}
    tag = f"moe {cfg.name} experts (E={e}, cap={M}, d={d}, f={f})"
    if taken != {want_route: 2 * 3 * e}:
        raise AssertionError(f"{tag} took routes {taken}, expected "
                             f"{want_route} x {2 * 3 * e}")
    err = 0.0
    for i, (x, y, w) in enumerate(zip(got, again, want)):
        err = max(err, check_close(f"{tag} product {i}", x, w,
                                   MM_TOL[torch.bfloat16]))
        if not torch.equal(x, y):
            raise AssertionError(f"{tag} product {i}: two calls differ")
    check_discerns(tag, want[0], MM_TOL[torch.bfloat16])
    del got, again, want
    row = dict(tag=f"experts {cfg.name}", E=e, M=M, K=d, N=f, launches=3 * e,
               route=want_route, max_abs_err=err)
    row.update(timed_calls(kernel_path, plain_path,
                           lambda: [torch.bmm(a, w) for a, w in products]))
    nbytes = 2 * (3 * e * d * f + e * M * (d + f) + e * M * (2 * f + d))
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2.0 * 3 * e * M * d * f,
                                                torch.bfloat16)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    print(f"{tag}: {3 * e} launches route={want_route} err={err:.2e} kernel "
          f"{row['ms']:.4f} ms ({row['ms_cached']:.4f} cached)  plain "
          f"{row['plain_ms']:.4f}  torch.bmm x3 {row['library_ms']:.4f}  "
          f"bound {row['bound_ms']:.4f} ({row['bound_by']}; share "
          f"{row['bound_share']:.2f})", flush=True)
    return row


def matmul_edge_cases():
    """Shapes no config gives the kernel: ragged M, N and K, fp32, the
    wgmma route's threshold and its ragged but 16-byte aligned shapes, a
    misaligned A, which takes the mma_sync route at M = 4096; and on the
    decode route M = 1 and 16, rows not 16-byte aligned (K = 8190 with B
    as (N, K), odd N with B as (K, N), a misaligned A), and ragged edges
    of 32- and 64-wide tiles."""
    bf = torch.bfloat16
    return [matmul_case(M, K, N, bt, dt, tag, route, misalign=mis)
            for M, K, N, bt, dt, tag, route, mis in (
                (37, 100, 50, False, bf, "ragged", "mma_sync", False),
                (37, 100, 50, True, bf, "ragged", "mma_sync", False),
                (4, 1000, 333, True, bf, "ragged", "decode", False),
                (1, 8190, 1024, False, bf, "M=1", "decode", False),
                (1, 8192, 288, False, bf, "M=1", "decode", False),
                (16, 8190, 1024, True, bf, "M=16", "decode", False),
                (16, 6912, 1152, False, bf, "M=16", "decode", False),
                (4, 4096, 333, False, bf, "odd N", "decode", False),
                (4, 1152, 1024, False, bf, "misaligned", "decode", True),
                (7, 4104, 4104, True, bf, "ragged wide", "decode", False),
                (16, 4096, 4100, False, bf, "ragged wide", "decode", False),
                (130, 77, 333, False, torch.float32, "ragged", "f32", False),
                (130, 77, 333, True, torch.float32, "ragged", "f32", False),
                (512, 1152, 1024, False, torch.float32, "fp32", "f32", False),
                (4100, 1160, 1032, False, bf, "ragged", "wgmma", False),
                (136, 264, 288, False, bf, "ragged", "wgmma", False),
                (1000, 520, 2056, False, bf, "ragged", "wgmma", False),
                (64, 1152, 1024, False, bf, "threshold", "wgmma", False),
                (63, 1152, 1024, False, bf, "threshold", "mma_sync", False),
                (4096, 1152, 1024, True, bf, "transposed", "mma_sync", False),
                (4096, 1152, 1024, False, bf, "misaligned", "mma_sync", True))]


# --------------------------------------------------------- flash attention

def flash_case(B, H, KV, S, T, D, causal, window, tag, want_route,
               model_layout=False):
    """One flash-attention case: the route it takes (asserted), the kernel
    against its plain version, a second call's bits against the first's,
    the tolerance's power to reject a wrong output; the kernel, the plain
    version and SDPA timed."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(S * 31 + T + window)
    if model_layout:   # as the model hands them over: (B,S,H,D) transposed
        q = (torch.randn((B, S, H, D), generator=g, device="cuda")
             * D ** -0.5).to(torch.bfloat16).transpose(1, 2)
        k = torch.randn((B, T, KV, D), generator=g, device="cuda").to(
            torch.bfloat16).transpose(1, 2)
        v = torch.randn((B, T, KV, D), generator=g, device="cuda").to(
            torch.bfloat16).transpose(1, 2)
        scale = 1.0
    else:
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                   for shape in ((B, H, S, D), (B, KV, T, D), (B, KV, T, D)))
        scale = D ** -0.5
    before = dict(kfa.route_launches)
    got = kfa.flash_attention(q, k, v, causal, window, scale)
    again = kfa.flash_attention(q, k, v, causal, window, scale)
    taken = {r: n - before[r] for r, n in kfa.route_launches.items()
             if n != before[r]}
    want = ref.flash_attention_ref(q, k, v, causal, window, scale)
    torch.cuda.synchronize()
    name = (f"flash {tag} (B={B} H={H} KV={KV} S={S} T={T} D={D} "
            f"causal={int(causal)} window={window})")
    if taken != {want_route: 2}:
        raise AssertionError(f"{name} took routes {taken}, expected {want_route}")
    err = check_close(name, got, want, FA_TOL)
    check_discerns(name, want, FA_TOL)
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    del got, again, want
    ms = time_ms(lambda: kfa.flash_attention(q, k, v, causal, window, scale), [()])
    plain = time_plain_ms(
        lambda: ref.flash_attention_ref(q, k, v, causal, window, scale), [()])
    mask = ref.attention_mask(S, T, causal, window, "cuda")
    kr = k.repeat_interleave(H // KV, dim=1).contiguous()
    vr = v.repeat_interleave(H // KV, dim=1).contiguous()
    qc = q.contiguous()
    if causal and not window and S == T:
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qc, kr, vr, is_causal=True, scale=scale), [()])
    elif not causal and not window:
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qc, kr, vr, scale=scale), [()])
    else:
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qc, kr, vr, attn_mask=mask, scale=scale), [()])
    pairs = int(mask.sum().item())     # the (q, k) pairs this mask leaves
    flops = 4.0 * B * H * pairs * D    # q.k and p.v, 2 flops per MAC
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KV * T * D)
    bnd, by = bound_ms(nbytes, flops, torch.bfloat16)
    row = dict(tag=tag, B=B, H=H, KV=KV, S=S, T=T, D=D, causal=causal,
               window=window, route=want_route, max_abs_err=err, ms=ms,
               plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
               tflops=flops / ms / 1e9)
    print(f"flash {tag:>10} B={B} H={H} KV={KV} S={S} T={T} D={D} "
          f"causal={int(causal)} window={window} route={want_route} "
          f"err={err:.2e} kernel {ms:.4f} ms ({row['tflops']:.0f} TFLOP/s)  "
          f"plain {plain:.4f}  sdpa {lib:.4f}  bound {bnd:.4f} ({by})",
          flush=True)
    return row


def flash_phase(cfg):
    rows = []
    for B, H, S, T, D, causal in ((1, 2, 256, 256, 64, True),
                                  (1, 2, 256, 256, 64, False),
                                  (2, 4, 512, 512, 128, True),
                                  (2, 4, 512, 512, 128, False),
                                  (1, 2, 384, 256, 64, True),
                                  (1, 2, 384, 256, 64, False),
                                  (1, 2, 256, 384, 64, True)):
        rows.append(flash_case(B, H, H, S, T, D, causal, 0, "pallas", "wgmma"))
    # the wgmma route's edges at the model's D: ragged S and T, S != T,
    # the narrowest and a too-wide window, no causal rule, GQA in layout
    for B, H, KV, S, T, causal, window, tag, layout in (
            (1, 2, 2, 1000, 1000, True, 0, "ragged", False),
            (1, 2, 2, 700, 1000, True, 0, "S<T", False),
            (1, 2, 2, 1000, 700, True, 300, "S>T", False),
            (1, 2, 1, 1000, 1000, True, 1, "window 1", False),
            (1, 2, 2, 1000, 1000, True, 4096, "window>S", False),
            (1, 2, 2, 1000, 1000, False, 0, "noncausal", False),
            (1, 2, 2, 1000, 1100, False, 300, "nc window", False),
            (2, 8, 2, 1000, 1000, True, 512, "gqa 4:1", True)):
        rows.append(flash_case(B, H, KV, S, T, 256, causal, window, tag,
                               "wgmma", model_layout=layout))
    # the mma_sync route: the reduced config's shape (D=16, GQA, a window,
    # ragged S) and D=32 with GQA and a window
    rows.append(flash_case(2, 4, 1, 37, 37, 16, True, 8, "reduced", "mma_sync"))
    rows.append(flash_case(2, 4, 1, 200, 200, 32, True, 50, "D=32", "mma_sync"))
    hd = cfg.resolved_head_dim
    local = flash_case(BATCH, cfg.n_heads, cfg.n_kv_heads, PROMPT, PROMPT, hd,
                       True, cfg.sliding_window, "local", "wgmma",
                       model_layout=True)
    glob = flash_case(BATCH, cfg.n_heads, cfg.n_kv_heads, PROMPT, PROMPT, hd,
                      True, 0, "global", "wgmma", model_layout=True)
    rows += [local, glob]
    n_global = sum(1 for m, _ in cfg.layer_kinds() if m == "attn")
    prefill = [(local, cfg.n_layers - n_global), (glob, n_global)]
    return rows, prefill


# -------------------------------------------------------------- mamba scan

def scan_case(Bt, S, D, N, x_dtype, tag, model_like=False):
    """One selective-scan case. The Pallas tests' inputs (dt = softplus of
    a normal, A = -exp(0.3 normal), B, C, x normal), or with
    ``model_like`` what the falcon-mamba block hands over: A = -(1..N),
    dt = softplus(0.5 normal - 4.6), B and C at 0.3, x a silu output."""
    from repro_torch.kernels import mamba_scan as kscan
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(S * 13 + D + N)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    if model_like:
        dt = F.softplus(0.5 * randn(Bt, S, D) - 4.6)
        A = -torch.arange(1, N + 1, dtype=torch.float32,
                          device="cuda").expand(D, N).contiguous()
        B, C = 0.3 * randn(Bt, S, N), 0.3 * randn(Bt, S, N)
        x = F.silu(randn(Bt, S, D)).to(x_dtype)
    else:
        dt = F.softplus(randn(Bt, S, D))
        A = -torch.exp(0.3 * randn(D, N))
        B, C = randn(Bt, S, N), randn(Bt, S, N)
        x = randn(Bt, S, D).to(x_dtype)
    args = (dt, A, B, C, x)
    p = kscan.plan(Bt, S, D, N, x.element_size())
    before = kscan.launches
    y, h = kscan.mamba_scan(*args)
    y2, h2 = kscan.mamba_scan(*args)
    y_want, h_want = ref.mamba_scan_ref(*args)
    torch.cuda.synchronize()
    name = f"mamba_scan {tag} ({Bt},{S},{D},{N})"
    if kscan.launches - before != 2:
        raise AssertionError(f"{name}: {kscan.launches - before} kernel "
                             f"launches for 2 calls")
    err = check_close(f"{name} y", y, y_want, SCAN_TOL[x_dtype])
    err_h = check_close(f"{name} h_last", h, h_want, H_TOL)
    check_discerns(f"{name} y", y_want, SCAN_TOL[x_dtype])
    check_discerns(f"{name} h_last", h_want, H_TOL)
    if not (torch.equal(y, y2) and torch.equal(h, h2)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    y_abs, h_abs = y_want.float().abs(), h_want.abs()
    del y2, h2
    ms = time_ms(lambda: kscan.mamba_scan(*args), [()])
    plain = time_plain_ms(lambda: ref.mamba_scan_ref(*args), [()])
    es = x.element_size()
    nbytes = (Bt * S * D * (4 + 2 * es) + 2 * Bt * S * N * 4 + D * N * 4
              + Bt * D * N * 4)
    # per state element and step: dt*A, exp, h FMA, y FMA; the exp bounds
    bnd, by = bound_ms(nbytes, 6.0 * Bt * S * D * N, torch.float32,
                       exps=Bt * S * D * N)
    row = dict(tag=tag, Bt=Bt, S=S, D=D, N=N,
               x_dtype=str(x_dtype).replace("torch.", ""), lanes=p.lanes,
               states_per_lane=p.states_per_lane, channels=p.channels,
               time_tile=p.time_tile, stages=p.stages, max_abs_err=err,
               h_last_max_abs_err=err_h, y_abs_mean=y_abs.mean().item(),
               y_abs_max=y_abs.max().item(), h_abs_mean=h_abs.mean().item(),
               h_abs_max=h_abs.max().item(), ms=ms, plain_ms=plain,
               library_ms=None, bound_ms=bnd, bound_by=by,
               bytes_bound_ms=nbytes / HBM_BYTES_S * 1e3,
               exp_bound_ms=Bt * S * D * N / EXP_RATE * 1e3)
    print(f"mamba_scan {tag:>9} ({Bt},{S},{D},{N}) x {row['x_dtype']} "
          f"plan G={p.lanes} states/lane={p.states_per_lane} "
          f"channels/block={p.channels} tile={p.time_tile} "
          f"stages={p.stages} err y {err:.2e} (|y| mean {row['y_abs_mean']:.2e} max "
          f"{row['y_abs_max']:.2e}) h {err_h:.2e} (|h| mean "
          f"{row['h_abs_mean']:.2e}) kernel {ms:.4f} ms  plain "
          f"{plain:.4f}  bound {bnd:.4f} ({by}; bytes "
          f"{row['bytes_bound_ms']:.4f}, exp {row['exp_bound_ms']:.4f})",
          flush=True)
    return row


def scan_phase(cfg):
    rows = []
    for Bt, S, D, N in ((1, 128, 512, 16), (2, 256, 1024, 16),
                        (2, 128, 640, 8)):           # test_kernels.py:101
        rows.append(scan_case(Bt, S, D, N, torch.float32, "pallas"))
    for Bt, S, D, N in ((1, 1000, 512, 16), (2, 37, 640, 4),
                        (3, 200, 384, 8)):
        rows.append(scan_case(Bt, S, D, N, torch.float32, "ragged"))
    # every padded instance (N = 1 pads to 4, 32 and 64), B and C rows not
    # 16-byte aligned (N = 1), more batch rows than a grid dimension held
    # before the batch was folded into x
    for Bt, S, D, N in ((2, 300, 640, 1), (2, 200, 512, 32),
                        (1, 100, 384, 64), (65537, 2, 16, 4)):
        rows.append(scan_case(Bt, S, D, N, torch.float32, f"N={N}"
                              if Bt < 65536 else "Bt>65535"))
    rows.append(scan_case(2, 24, 128, 4, torch.bfloat16, "reduced",
                          model_like=True))
    rows.append(scan_case(2, 250, 8190, 16, torch.bfloat16, "ragged D",
                          model_like=True))   # misaligned dt and x rows, ragged S
    rows.append(scan_case(1, 4096, 1024, 16, torch.bfloat16, "long S",
                          model_like=True))
    rows.append(scan_case(2, 64, 8192, 64, torch.bfloat16, "N=64",
                          model_like=True))
    model = scan_case(BATCH, PROMPT, cfg.d_inner, cfg.ssm_state,
                      torch.bfloat16, "model", model_like=True)
    rows.append(model)
    return rows, [(model, cfg.n_layers)]


def scan_grads_fp64(dt, A, B, C, x, dy, dh_last) -> list:
    """d dt, dA, dB, dC, dx of the scan in fp64 from the same inputs, by
    autograd of the recurrence: the truth the backward kernel and its
    plain version are both measured against."""
    ins = [t.double().requires_grad_() for t in (dt, A, B, C, x)]
    dt_, A_, B_, C_, x_ = ins
    h = torch.zeros((x.shape[0], x.shape[2], A.shape[1]), dtype=torch.float64,
                    device=x.device)
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(dt_[:, t, :, None] * A_) * h \
            + (dt_[:, t] * x_[:, t])[..., None] * B_[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C_[:, t]))
    outs, cots = [torch.stack(ys, 1)], [dy.double()]
    if dh_last is not None:
        outs.append(h)
        cots.append(dh_last.double())
    return list(torch.autograd.grad(outs, ins, cots))


def check_discerns_early(name, want, tol, view) -> None:
    """The tolerance (on ``view`` of the tensors) must reject an output of
    zeros, one 10 % off, and, where it has a time axis (axis 1 of (Bt, S,
    ...)), one zeroed or 10 % off in its first half of the steps: where
    the reverse pass ends."""
    bads = [torch.zeros_like(want), want * 1.1]
    if want.dim() == 3:
        for f in (0.0, 1.1):
            bad = want.clone()
            bad[:, :want.shape[1] // 2] *= f
            bads.append(bad)
    for bad in bads:
        if within(view(bad), view(want), tol):
            raise AssertionError(f"{name}: tolerance {tol} passes a zeroed or "
                                 f"10%-off output, whole or in its first half "
                                 f"of the steps")


def scan_bwd_case(Bt, S, D, N, x_dtype, tag, model_like=False, dh=False,
                  split=False) -> dict:
    """One case of the scan's backward kernel: the inputs of ``scan_case``
    and a normal dy (and dh_last with ``dh``). The forward's training
    instance (chunk states) within SCAN_TOL of the plain version;
    ``mamba_scan_bwd`` twice (the same bits) against
    ``mamba_scan_bwd_ref`` on the same inputs within SCAN_BWD_TOL, each
    tolerance's power to reject a wrong output (whole, or in the first
    half of the steps); each grad's relative L2 distance to an fp64 truth
    within PATH_RATIO of the plain version's; the kernel and the plain
    version timed. With ``split``: the launches' device times under the
    profiler (pre-pass, scan, sums), held to add up to the call's time."""
    from repro_torch.kernels import mamba_scan as kscan
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(S * 7 + D + N)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    if model_like:
        dt = F.softplus(0.5 * randn(Bt, S, D) - 4.6)
        A = -torch.arange(1, N + 1, dtype=torch.float32,
                          device="cuda").expand(D, N).contiguous()
        B, C = 0.3 * randn(Bt, S, N), 0.3 * randn(Bt, S, N)
        x = F.silu(randn(Bt, S, D)).to(x_dtype)
    else:
        dt = F.softplus(randn(Bt, S, D))
        A = -torch.exp(0.3 * randn(D, N))
        B, C = randn(Bt, S, N), randn(Bt, S, N)
        x = randn(Bt, S, D).to(x_dtype)
    dy = randn(Bt, S, D).to(x_dtype)
    dh_last = randn(Bt, D, N) if dh else None
    fwd = (dt, A, B, C, x)
    name = f"mamba_scan_bwd {tag} ({Bt},{S},{D},{N})"
    y, h, hc = kscan.mamba_scan(*fwd, chunk_states=True)
    y_want, h_want = ref.mamba_scan_ref(*fwd)
    fwd_err = check_close(f"{name} forward y", y, y_want, SCAN_TOL[x_dtype])
    check_close(f"{name} forward h_last", h, h_want, H_TOL)
    del y, h, y_want, h_want
    args = (*fwd, dy, dh_last, hc)
    p = kscan.plan_bwd(Bt, S, D, N, x.element_size())
    before = kscan.bwd_launches
    got = kscan.mamba_scan_bwd(*args)
    again = kscan.mamba_scan_bwd(*args)
    if kscan.bwd_launches - before != 2:
        raise AssertionError(f"{name}: {kscan.bwd_launches - before} backward "
                             f"launches for 2 calls")
    want = ref.mamba_scan_bwd_ref(*fwd, dy, dh_last)
    torch.cuda.synchronize()
    truth = scan_grads_fp64(*fwd, dy, dh_last)
    errs, l2 = {}, {}
    per_channel = lambda t: t.transpose(1, 2)   # noqa: E731  (Bt, D, S)
    same = lambda t: t                          # noqa: E731
    for nm, got_x, again_x, want_x, true_x in zip(
            ("d_dt", "dA", "dB", "dC", "dx"), got, again, want, truth):
        view = per_channel if nm in ("d_dt", "dx") else same
        tol = SCAN_BWD_TOL[got_x.dtype]
        if got_x.dtype != want_x.dtype or got_x.shape != want_x.shape:
            raise AssertionError(f"{name} {nm}: {got_x.dtype} "
                                 f"{tuple(got_x.shape)} against {want_x.dtype} "
                                 f"{tuple(want_x.shape)}")
        errs[nm] = check_close(f"{name} {nm}", view(got_x), view(want_x), tol)
        check_discerns_early(f"{name} {nm}", want_x, tol, view)
        if not torch.equal(got_x, again_x):
            raise AssertionError(f"{name} {nm}: two calls on the same inputs "
                                 f"differ")
        l2[nm] = {"kernel": rel_l2(got_x, true_x), "plain": rel_l2(want_x, true_x)}
        if not l2[nm]["kernel"] <= PATH_RATIO * l2[nm]["plain"]:
            raise AssertionError(f"{name} {nm}: relative L2 to fp64 "
                                 f"{l2[nm]['kernel']:.3e}, over {PATH_RATIO} "
                                 f"x the plain version's {l2[nm]['plain']:.3e}")
    del got, again, want, truth
    free_memory()
    ms = time_ms(lambda: kscan.mamba_scan_bwd(*args), [()])
    plain = time_plain_ms(lambda: ref.mamba_scan_bwd_ref(*fwd, dy, dh_last),
                          [()])
    # the forward as training runs it (chunk states), as serving runs it,
    # and its plain version
    fwd_ms = time_ms(lambda: kscan.mamba_scan(*fwd, chunk_states=True), [()])
    serve_ms = time_ms(lambda: kscan.mamba_scan(*fwd), [()])
    fwd_plain = time_plain_ms(lambda: ref.mamba_scan_ref(*fwd), [()])
    if split:   # the call's device time by launch
        split = scan_bwd_launch_ms(lambda: kscan.mamba_scan_bwd(*args), ms,
                                   p.pre_grid > 0, name)
    es = x.element_size()
    n_ss = Bt * S * D * N    # state-steps
    nbytes = (Bt * S * D * (4 + 2 * es) + Bt * S * D * (4 + es)   # dt, x, dy; d dt, dx
              + 4 * Bt * S * N * 4 + 2 * D * N * 4                # B, C, dB, dC; A, dA
              + (Bt * D * N * 4 if dh else 0))                    # dh_last
    # SCAN_BWD_FP32 FP32 instructions a state-step, each an issue slot of
    # the fp32 peak's FMA (2 flops), and one exponential
    bnd, by = bound_ms(nbytes, 2.0 * SCAN_BWD_FP32 * n_ss, torch.float32,
                       exps=n_ss)
    # the forward's: dt, x in, y out, B, C, A in, h_last and the chunk
    # states out; per state-step dt*A, exp, the h and y FMAs (scan_case's)
    fwd_bytes = (Bt * S * D * (4 + 2 * es) + 2 * Bt * S * N * 4 + D * N * 4
                 + Bt * D * N * 4 + hc.numel() * 4)
    fwd_bnd, fwd_by = bound_ms(fwd_bytes, 6.0 * n_ss, torch.float32,
                               exps=n_ss)
    row = dict(tag=tag, Bt=Bt, S=S, D=D, N=N, x_dtype=_dt(x_dtype),
               dh_last=dh, lanes=p.lanes, channels=p.channels, chunk=p.chunk,
               segments=p.segments, seg_chunks=p.seg_chunks,
               resident=p.resident,
               smem_bytes=p.smem_bytes, grid=p.grid, pre_grid=p.pre_grid,
               chunk_state_bytes=hc.numel() * 4,
               workspace_bytes=p.ws_floats * 4,
               max_abs_err=max(errs.values()), errs=errs, rel_l2_fp64=l2,
               us_per_step=ms * 1e3 / S,
               ms=ms, plain_ms=plain, library_ms=None, bound_ms=bnd,
               bound_by=by, bytes_bound_ms=nbytes / HBM_BYTES_S * 1e3,
               exp_bound_ms=n_ss / EXP_RATE * 1e3,
               fp32_bound_ms=2.0 * SCAN_BWD_FP32 * n_ss
               / PEAK_FLOPS[torch.float32] * 1e3, split_ms=split or None,
               forward=dict(max_abs_err=fwd_err, ms=fwd_ms, serve_ms=serve_ms,
                            plain_ms=fwd_plain, library_ms=None,
                            bound_ms=fwd_bnd, bound_by=fwd_by))
    print(f"mamba_scan_bwd {tag:>10} ({Bt},{S},{D},{N}) x {row['x_dtype']} "
          f"dh_last={int(dh)} plan G={p.lanes} channels/block={p.channels} "
          f"chunk={p.chunk} segments={p.segments}x{p.seg_chunks} "
          f"blocks/SM={p.resident} smem={p.smem_bytes} grid={p.grid}"
          f"+{p.pre_grid}; err "
          + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + "; rel L2 to fp64 kernel/plain "
          + " ".join(f"{k} {v['kernel']:.3e}/{v['plain']:.3e}"
                     for k, v in l2.items())
          + f"; kernel {ms:.4f} ms ({row['us_per_step']:.4f} us a step)  "
          f"plain {plain:.4f}  bound {bnd:.4f} ({by}; "
          f"bytes {row['bytes_bound_ms']:.4f}, exp {row['exp_bound_ms']:.4f}, "
          f"fp32 {row['fp32_bound_ms']:.4f}); forward with chunk states "
          f"{fwd_ms:.4f} ms, serving's {serve_ms:.4f}, plain {fwd_plain:.4f}, "
          f"bound {fwd_bnd:.4f}"
          + ("; profiled " + " ".join(f"{k} {v:.4f}" for k, v in split.items())
             if split else ""), flush=True)
    del args, fwd, dy, dh_last, hc
    free_memory()
    return row


def scan_bwd_launch_ms(fn, ms: float, pre_pass: bool, name: str,
                       calls: int = 4) -> dict:
    """The mean device ms of each of the backward call's launches (the
    pre-pass, the scan, the sums) over ``calls`` runs of ``fn`` under
    torch.profiler, from each kernel's own record, after a warm-up run
    that the profiler discards (a profile's first kernel can go
    unrecorded). Fails unless every launch the call makes (the pre-pass
    where ``pre_pass``) was recorded once a run with some device time,
    and unless the parts add up to ``ms``, the call's time by CUDA-graph
    replay, within a tenth of it and 5 us a launch (the gaps between
    launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        prof.step()
    total, count = dict(carry=0.0, scan=0.0, sum=0.0), dict(carry=0, scan=0,
                                                             sum=0)
    seen = set()
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        seen.add(e.name[:90])
        if "mamba_scan_bwd" not in e.name:
            continue
        part = ("carry" if "bwd_carry" in e.name else
                "sum" if "bwd_sum" in e.name else "scan")
        total[part] += e.time_range.elapsed_us() / 1e3
        count[part] += 1
    want = dict(carry=calls if pre_pass else 0, scan=calls, sum=calls)
    if count != want:
        raise AssertionError(f"{name}: the profiler recorded {count} launches "
                             f"in {calls} calls, want {want}; device events "
                             f"{sorted(seen)}")
    out = {k: total[k] / calls for k in total}
    if any(out[k] <= 0 for k in out if want[k]):
        raise AssertionError(f"{name}: a launched kernel reads no device time "
                             f"({out})")
    parts = sum(out.values())
    if not abs(parts - ms) <= 0.1 * ms + 0.005 * sum(want.values()) / calls:
        raise AssertionError(f"{name}: the profiled launches add up to "
                             f"{parts:.4f} ms, the call takes {ms:.4f} ms "
                             f"({out})")
    return out


def scan_bwd_registers() -> dict:
    """Registers and spill bytes (stores, loads) of each instance of the
    backward kernels, from ptxas's report in the build's log."""
    from repro_torch.kernels import build

    log = build.build_dir() / "mamba_scan_bwd.log"
    regs, fn = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"(?:entry function '|Function properties for )(\w+)",
                      line)
        if m:   # the kernel's name is the last mamba_scan_bwd* in it
            mangled = m.group(1)
            name, np_ = re.findall(r"(mamba_scan_bwd(?:_carry|_sum)?)"
                                   r"(?:ILi(\d+)E)?", mangled)[-1]
            blocks = re.search(r"(?:bfloat16|f)Li(\d)EE", mangled)
            fn = (f"{name}<{np_}, {'bf16' if 'bfloat16' in mangled else 'f32'}"
                  f"{f', {blocks.group(1)}' if blocks else ''}>" if np_
                  else name)
            regs.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            regs[fn]["spills"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            regs[fn]["registers"] = int(m.group(1))
    for k, v in sorted(regs.items()):
        print(f"ptxas {k}: {v.get('registers')} registers, spills "
              f"{v.get('spills')}", flush=True)
    return regs


def serve_scan_digest(kscan) -> str:
    """The sha256 of the serving scan's outputs (``kscan.mamba_scan`` with
    no chunk states) at SERVE_SCAN_CASES."""
    import hashlib

    import numpy as np

    total = hashlib.sha256()
    for Bt, S, D, N, xd in SERVE_SCAN_CASES:
        rng = np.random.default_rng(S * 13 + D + N)

        def uniform(lo, hi, *shape):
            u = lo + (hi - lo) * rng.random(shape)
            return torch.from_numpy(u.astype(np.float32)).cuda()
        dt = uniform(1e-3, 0.1, Bt, S, D)
        A = -uniform(0.25, 1.75, D, N)
        B, C = uniform(-1.0, 1.0, Bt, S, N), uniform(-1.0, 1.0, Bt, S, N)
        x = uniform(-1.0, 1.0, Bt, S, D).to(xd)
        for t in kscan.mamba_scan(dt, A, B, C, x):
            total.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        del dt, A, B, C, x
    free_memory()
    return total.hexdigest()


def serve_scan_bits() -> dict:
    """The serving scan's outputs at SERVE_SCAN_CASES against
    SERVE_SCAN_DIGEST, the bits it gave before the training instance."""
    from repro_torch.kernels import mamba_scan as kscan

    digest = serve_scan_digest(kscan)
    print(f"serving scan at {len(SERVE_SCAN_CASES)} shapes: digest "
          f"{digest[:16]}, before the training instance "
          f"{SERVE_SCAN_DIGEST[:16]}", flush=True)
    if digest != SERVE_SCAN_DIGEST:
        raise AssertionError(f"the serving scan's outputs changed: digest "
                             f"{digest}, before {SERVE_SCAN_DIGEST}")
    return dict(digest=digest)


def scan_bwd_phase(split: bool = False) -> dict:
    """Phase 8(a'): the serving scan's bits, then the scan's backward
    kernel at SCAN_BWD_CASES; fails if its N = 16 instances spill."""
    from repro_torch.kernels import mamba_scan as kscan

    out = dict(serve_bits=serve_scan_bits(), ptxas=scan_bwd_registers(),
               cases=[scan_bwd_case(*c[:6], **c[6], split=split)
                      for c in SCAN_BWD_CASES])
    for t, es in (("bf16", 2), ("f32", 4)):   # N = 16: none may spill
        v = out["ptxas"].get(f"mamba_scan_bwd<16, {t}, "
                             f"{kscan.plan_bwd(1, 64, 64, 16, es).blocks}>")
        if v is None or v.get("spills") != [0, 0]:
            raise AssertionError(f"mamba_scan_bwd<16, {t}>: ptxas reports "
                                 f"{v}; the plan wants no spills")
    return out


# ------------------------------------------------------------------- serve

def counters(cfg) -> dict:
    """The launch-counting kernel modules that ``cfg``'s main path runs:
    the matmul kernel, the scan for Mamba layers, flash for the others."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import mamba_scan as kscan
    from repro_torch.kernels import matmul as kmm

    mixers = {m for m, _ in cfg.layer_kinds()}
    return {"matmul": kmm,
            **({"flash_attention": kfa} if mixers - {"mamba"} else {}),
            **({"mamba_scan": kscan} if "mamba" in mixers else {})}


def serve_phase(cfg, repeats: int = PREFILL_REPEATS, profile: bool = True,
                svm: bool = True, paths_layers: int | None = None):
    """Serve ``cfg`` at full width (see the module docstring). The lighter
    phases of the later archs pass fewer prefill ``repeats``, skip the
    device profile or the SVM phase, and run ``compare_paths`` on the
    first ``paths_layers`` layers of the served params (the other layers
    freed first when no SVM phase reads them later). A VLM or an
    encoder-decoder takes the launcher's context (``serve.context``), and
    its launches are checked against CTX_COUNTS. A config whose Mamba
    layers carry an FFN runs the check on a copy whose Mamba mixers take
    LOUD_FULL (``loud_copy``), after ``check_layers_live``."""
    from repro_torch.bridge import init_params, leaf_sizes, leaves
    from repro_torch.launch import serve

    mods = counters(cfg)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device="cuda")
    toks = serve.prompts(cfg, BATCH, PROMPT, "cuda")
    ctx = serve.context(cfg, BATCH, "cuda")
    torch.cuda.synchronize()
    weight_bytes = sum(n for _, n in leaf_sizes(params))
    n_params = sum(x.numel() for x in dict(leaves(params)).values())
    init_peak = torch.cuda.max_memory_allocated()
    sums = param_sums(params)
    print(f"serve {cfg.name}: init {weight_bytes / 1e9:.3f} GB of params in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"serve {cfg.name}: {cfg.n_layers} layers, peak memory after init "
          f"{init_peak / 1e9:.3f} GB", flush=True)
    with torch.inference_mode():
        tok, _, cache, _ = serve.run_prefill(cfg, params, toks[:, :128],
                                             ctx)  # warm-up
        serve.run_decode(cfg, params, tok, cache, 2, ctx)
        del cache
        kmm = mods["matmul"]
        for m in mods.values():
            m.launches = 0
            if hasattr(m, "route_launches"):
                m.route_launches.update(dict.fromkeys(m.ROUTES, 0))
        tok, logits, cache, pre_ms = serve.run_prefill(cfg, params, toks, ctx)
        pre_counts = {k: m.launches for k, m in mods.items()}
        pre_routes = dict(kmm.route_launches)
        fa_routes = (dict(mods["flash_attention"].route_launches)
                     if "flash_attention" in mods else None)
        decoded, cache, dec_ms = serve.run_decode(cfg, params, tok, cache,
                                                  DECODE, ctx)
        counts = {k: m.launches for k, m in mods.items()}
        routes = {r: n - pre_routes[r] for r, n in kmm.route_launches.items()}
        fa_dec = (None if fa_routes is None else
                  {r: n - fa_routes[r] for r, n in
                   mods["flash_attention"].route_launches.items()})
        if ctx is None:
            check_routes(cfg, pre_routes, routes, fa_routes)
        else:
            check_context_counts(cfg, dict(matmul=pre_routes,
                                           flash_attention=fa_routes),
                                 dict(matmul=routes, flash_attention=fa_dec))
        if "mamba_scan" in mods:
            check_scan_launches(cfg, pre_counts["mamba_scan"],
                                counts["mamba_scan"])
        # the first full-size prefill grows the allocator's pool; repeats
        # show the steady state, and how far the host's dispatch spreads
        pre_ms_again = [serve.run_prefill(cfg, params, toks, ctx)[3]
                        for _ in range(repeats)]
        seq = torch.cat([tok] + decoded, dim=1)
        assert logits.shape == (BATCH, 1, cfg.padded_vocab), logits.shape
        assert torch.isfinite(logits.float()).all(), "non-finite prefill logits"
        assert seq.shape == (BATCH, DECODE + 1)
        assert int(seq.min()) >= 0 and int(seq.max()) < cfg.vocab
        if min(counts.values()) == 0:
            raise AssertionError(f"a kernel was not launched on the main "
                                 f"path: {counts}")
        tok_s = BATCH * DECODE / (dec_ms / 1e3)
        print(f"serve {cfg.name}: prefill {BATCH}x{PROMPT} in {pre_ms:.2f} ms "
              f"(repeated: median {statistics.median(pre_ms_again):.2f}, "
              f"{min(pre_ms_again):.2f} to {max(pre_ms_again):.2f}); "
              f"decoded {DECODE} tokens in {dec_ms:.2f} ms ({tok_s:.1f} tok/s, "
              f"{dec_ms / DECODE:.3f} ms/token; weight bound "
              f"{weight_bytes / HBM_BYTES_S * 1e3:.3f} ms/token); launches "
              + ", ".join(f"{k} {counts[k]} (prefill {pre_counts[k]})"
                          for k in counts), flush=True)
        print(f"serve {cfg.name}: matmul routes, prefill {pre_routes}; "
              f"decode {routes}"
              + ("" if fa_routes is None else
                 f"; flash_attention routes, prefill {fa_routes}")
              + ("" if ctx is None else f", decode {fa_dec}"), flush=True)
        print(f"serve {cfg.name}: first request continuation:",
              seq[0].tolist(), flush=True)

        # where the time goes: device-busy time under the profiler
        prof_pre = prof_dec = None
        if profile:
            prof_pre = profile_device(
                lambda: serve.run_prefill(cfg, params, toks, ctx))
            prof_dec = profile_device(
                lambda: serve.run_decode(cfg, params, seq[:, -1:], cache, 4,
                                         ctx))
            for phase, (busy, wall, top), eager in (
                    ("prefill", prof_pre, pre_ms), ("decode x4", prof_dec,
                                                    4 * dec_ms / DECODE)):
                print(f"profile {cfg.name} {phase}: device busy {busy:.2f} ms "
                      f"of {eager:.2f} ms unprofiled ({wall:.2f} ms "
                      f"profiled): idle share {1 - busy / eager:.3f}",
                      flush=True)
                for name, ms, n in top:
                    print(f"    {ms:9.3f} ms  {n:5d}x  {name}", flush=True)
        del cache

        spec = served_spec(cfg, params)
        check_params_unchanged(cfg.name, params, sums, "while serving")
        serve_peak = torch.cuda.max_memory_allocated()
        gate_live = layers_live = None
        if paths_layers is None:
            paths = compare_paths(cfg, params, toks)
        elif ctx is None:
            cut_cfg, cut = depth_cut(cfg, params, paths_layers)
            if not svm:      # nothing reads the other layers again
                params = cut
                free_memory()
            loud = mamba_ffn(cfg)
            print(f"paths {cfg.name}: compare_paths on the first "
                  f"{paths_layers} of {cfg.n_layers} layers (full width; the "
                  f"fp32 copy of all of them would not fit"
                  + (f"; the others freed first" if not svm else "")
                  + (f"; every Mamba mixer at LOUD_FULL {LOUD_FULL}, dt_bias "
                     f"0, on a copy" if loud else "") + ")", flush=True)
            if loud:
                cut = loud_copy(cut_cfg, cut, LOUD_FULL)
                layers_live = check_layers_live(cut_cfg, cut, toks)
            paths = compare_paths(cut_cfg, cut, toks)
            del cut
        else:
            cut_cfg, cut = depth_cut(cfg, params, paths_layers)
            gate_live = check_gate_live(cut_cfg, cut, toks, ctx)
            print(f"paths {cfg.name}: compare_paths on the first "
                  f"{paths_layers} of {cfg.n_layers} layers (whole periods, "
                  f"full width"
                  + (", the whole encoder" if cfg.is_encdec else "")
                  + f"), every cross-attention gate at {PATHS_GATE} on a "
                  f"copy", flush=True)
            paths = compare_paths(cut_cfg, with_gates(cut, PATHS_GATE), toks,
                                  ctx=ctx)
        check_params_unchanged(cfg.name, params, sums, "in compare_paths")
        pre_ms_p = paths.pop("plain_prefill_ms")
        peak = torch.cuda.max_memory_allocated()
        print(f"serve {cfg.name}: peak memory serving {serve_peak / 1e9:.3f} "
              f"GB, with compare_paths {peak / 1e9:.3f} GB", flush=True)
        free_memory()
        svm = svm_phase(cfg, params) if svm else None
        del params
        free_memory()
        reduced = reduced_vs_cpu(cfg.name)
    return dict(arch=cfg.name, n_layers=cfg.n_layers, paths_layers=paths_layers,
                weight_bytes=weight_bytes, n_params=n_params,
                init_peak_memory_bytes=init_peak,
                spec=spec, svm=svm, prefill_ms=pre_ms,
                prefill_ms_repeated=pre_ms_again,
                matmul_routes_prefill=pre_routes, matmul_routes_decode=routes,
                flash_routes_prefill=fa_routes, flash_routes_decode=fa_dec,
                gate_live=gate_live, layers_live=layers_live,
                decode_ms=dec_ms, tok_s=tok_s,
                decode_ms_per_token=dec_ms / DECODE,
                decode_weight_bound_ms_per_token=weight_bytes / HBM_BYTES_S * 1e3,
                profile_prefill=prof_pre, profile_decode_4_tokens=prof_dec,
                plain_prefill_ms=pre_ms_p, launches=counts,
                prefill_launches=pre_counts, peak_memory_bytes=peak,
                serve_peak_memory_bytes=serve_peak,
                paths_vs_fp32=paths, reduced_vs_cpu=reduced,
                continuation=seq[0].tolist(), param_sums=sums)


def param_sums(params) -> dict:
    """Each leaf's ``leaf_sums``: what a kernel that writes into the served
    weights would change."""
    from repro_torch.bridge import leaves

    return {path: leaf_sums(x) for path, x in leaves(params)}


def check_params_unchanged(name: str, params, sums: dict, where: str) -> None:
    now = param_sums(params)
    changed = [(p, i) for p in now for i, (a, b) in
               enumerate(zip(now[p], sums[p])) if a != b]
    if changed:
        raise AssertionError(f"serve {name}: the served params changed "
                             f"{where} (leaf, period slice): {changed[:16]}")


def depth_cut(cfg, params, n_layers: int):
    """``cfg`` cut to its first ``n_layers`` layers and the served params
    of those layers: whole periods (views of the stacked tensors) of a
    config with no remainder, or the first ``remainder/r<i>`` layers of an
    unstacked one (no periods)."""
    import dataclasses

    from repro_torch.bridge import tree_map

    per = len(cfg.layer_pattern)
    if n_layers > cfg.n_layers or (cfg.n_periods and (
            n_layers % per or cfg.n_remainder)):
        raise ValueError(f"{cfg.name}: cannot cut {cfg.n_layers} layers of "
                         f"period {per} to {n_layers}")
    cut = dataclasses.replace(cfg, n_layers=n_layers)
    if not cfg.n_periods:
        return cut, dict(params, remainder={
            f"r{i}": params["remainder"][f"r{i}"] for i in range(n_layers)})
    return cut, dict(params, periods=tree_map(lambda x: x[:n_layers // per],
                                              params["periods"]))


def mamba_ffn(cfg) -> bool:
    """Whether ``cfg`` has Mamba layers followed by an FFN (jamba's)."""
    return any(m == "mamba" and f != "none" for m, f in cfg.layer_kinds())


def loud_copy(cfg, params, gains: dict) -> dict:
    """``params`` with ``gains`` on the leaves of every Mamba mixer and
    its dt_bias at 0: new tensors for those leaves, the rest shared."""
    pat = cfg.layer_pattern

    def loud(layer):
        mixer = dict(layer["mixer"])
        for name, g in gains.items():
            mixer[name] = (mixer[name].float() * g).to(mixer[name].dtype)
        mixer["dt_bias"] = torch.zeros_like(mixer["dt_bias"])
        return dict(layer, mixer=mixer)

    out = dict(params)
    if cfg.n_periods:
        out["periods"] = {k: loud(v) if pat[int(k[1:])] == "mamba" else v
                          for k, v in params["periods"].items()}
    base = cfg.n_periods * len(pat)
    if cfg.n_remainder:
        out["remainder"] = {
            k: loud(v) if pat[(base + int(k[1:])) % len(pat)] == "mamba" else v
            for k, v in params["remainder"].items()}
    return out


def check_layers_live(cfg, params, toks) -> dict:
    """The kernel path's prefill logits of ``params`` against the same
    with the scan's y zeroed (the D skip kept), with every MLP's output
    zeroed, and with every MoE's: each must differ beyond MODEL_TOL, so
    that ``compare_paths`` on these params sees the scan and both FFNs
    (a part far below the residual's bf16 resolution would change no
    logit). Returns each one's relative L2 distance."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tm

    def logits():
        return serve.run_prefill(cfg, params, toks, None)[1][:, -1]

    def zero_y(scan):
        def broken(*args, **kw):
            y, h = scan(*args, **kw)
            return torch.zeros_like(y), h
        return broken

    want = logits()
    out = {}
    faults = {"scan y": (ops, "mamba_scan", zero_y),
              "mlp": (tm, "mlp_apply",
                      lambda f: lambda p, x, *a, **k: torch.zeros_like(x)),
              "moe": (tm.moe_lib, "moe_apply",
                      lambda f: lambda p, c, x, **k: (
                          torch.zeros_like(x),
                          x.new_zeros((), dtype=torch.float32)))}
    for name, (mod, attr, broken) in faults.items():
        real = getattr(mod, attr)
        setattr(mod, attr, broken(real))
        try:
            got = logits()
        finally:
            setattr(mod, attr, real)
        if within(got, want, MODEL_TOL):
            raise AssertionError(f"{cfg.name}: the prefill logits with the "
                                 f"{name} output zeroed are within "
                                 f"{MODEL_TOL} of the whole model's")
        out[name] = rel_l2(got, want)
    print(f"paths {cfg.name}: prefill logits relative L2 to the whole "
          f"model's with the output zeroed of: "
          + ", ".join(f"{k} {v:.3e}" for k, v in out.items())
          + f" (each beyond {MODEL_TOL})", flush=True)
    return out


def new_archs_phase(t_run: float) -> dict:
    """The decoders of NEW_ARCHS: flash attention at their prefill shapes
    (D = 64 at 32:8; D = 128 at 48:1 and at 32:8 with a 4096 window), the
    matmul shapes of the MoE arch (its expert products by ``moe_case``)
    and of granite-20b's decode, then each arch's lighter serve phase, and
    the MoE arch's SVM phase and launcher run."""
    import dataclasses

    from repro_torch.configs import get_config

    cfgs = {n: get_config(n) for n in NEW_ARCHS}
    for n, layers in DEPTH_CUT.items():
        cfgs[n] = dataclasses.replace(cfgs[n], n_layers=layers)
    g32, g20, mix = (cfgs[n] for n in ("granite-3-2b", "granite-20b",
                                       "mixtral-8x7b"))
    flash = {
        "d64": flash_case(BATCH, g32.n_heads, g32.n_kv_heads, PROMPT, PROMPT,
                          g32.resolved_head_dim, True, 0, "d64 32:8", "wgmma",
                          model_layout=True),
        "d128": flash_case(BATCH, g20.n_heads, g20.n_kv_heads, PROMPT, PROMPT,
                           g20.resolved_head_dim, True, 0, "d128 48:1",
                           "wgmma", model_layout=True),
        "d128-window": flash_case(BATCH, mix.n_heads, mix.n_kv_heads, PROMPT,
                                  PROMPT, mix.resolved_head_dim, True,
                                  mix.sliding_window, "d128 w4096", "wgmma",
                                  model_layout=True)}
    mm_moe, phases_moe = matmul_phase(cfgs[MOE_ARCH])
    mm_20b, phases_20b = matmul_phase(g20, ("decode",))
    # mixtral-8x7b's shapes over all 32 layers: what the streamed run
    # (phase 1'(a)) launches, timed resident
    t0 = time.perf_counter()
    mm_mix, phases_mix = matmul_phase(get_config("mixtral-8x7b"))
    mix_s = time.perf_counter() - t0
    print(f"matmul mixtral-8x7b: its 32 layers' shapes in {mix_s:.1f} s",
          flush=True)
    free_memory()
    served, launched = {}, None
    for name in NEW_ARCHS:
        cfg = cfgs[name]
        if name in DEPTH_CUT:
            print(f"serve {name}: full width, depth cut to {cfg.n_layers} of "
                  f"{get_config(name).n_layers} layers", flush=True)
        served[name] = serve_phase(
            cfg, repeats=NEW_PREFILL_REPEATS, profile=name in NEW_PROFILED,
            svm=name == MOE_ARCH, paths_layers=PATHS_LAYERS)
        served[name]["depth_cut"] = (dict(n_layers=cfg.n_layers, of=get_config(
            name).n_layers) if name in DEPTH_CUT else None)
        spec = served[name].pop("spec")
        free_memory()
        if name == MOE_ARCH:
            launched = launcher_phase(
                name, served[name]["svm"]["modes"]["svm_aware"]["report"], spec)
            free_memory()
        print(f"{name} phases done at {time.perf_counter() - t_run:.1f} s",
              flush=True)
    return dict(flash=flash, matmul_moe=mm_moe, matmul_moe_phases=phases_moe,
                matmul_granite_20b=mm_20b, matmul_granite_20b_phases=phases_20b,
                matmul_mixtral=mm_mix, matmul_mixtral_phases=phases_mix,
                matmul_mixtral_seconds=mix_s, served=served, launcher=launched)


def jamba_phase(t_run: float) -> dict:
    """jamba-1.5-large-398b at full width cut to JAMBA_LAYERS layers (see
    the module docstring): flash attention (64:8, D 128, global causal),
    the scan at (4, 1024, 16384, 16) and the matmul kernel at every shape
    of its prefill and token (the 16 experts' products by ``moe_case``),
    each against its plain version; then its serve phase."""
    import dataclasses

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    full = get_config(JAMBA_ARCH)
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    flash = flash_case(BATCH, cfg.n_heads, cfg.n_kv_heads, PROMPT, PROMPT,
                       cfg.resolved_head_dim, True, 0, "d128 64:8", "wgmma",
                       model_layout=True)
    scan = scan_case(BATCH, PROMPT, cfg.d_inner, cfg.ssm_state,
                     torch.bfloat16, "jamba", model_like=True)
    free_memory()
    mm_rows, mm_phases = matmul_phase(cfg)
    free_memory()
    kernels_s = time.perf_counter() - t0
    print(f"serve {JAMBA_ARCH}: full width, depth cut to {cfg.n_layers} of "
          f"{full.n_layers} layers, unstacked as remainder/r0..r"
          f"{cfg.n_layers - 1}: {cfg.layer_kinds()}", flush=True)
    served = serve_phase(cfg, repeats=NEW_PREFILL_REPEATS, svm=False,
                         paths_layers=JAMBA_PATHS_LAYERS)
    served["depth_cut"] = dict(n_layers=cfg.n_layers, of=full.n_layers)
    served.pop("spec")
    free_memory()
    seconds = time.perf_counter() - t0
    print(f"{JAMBA_ARCH} phase done in {seconds:.1f} s (its kernel cases "
          f"{kernels_s:.1f} s), at {time.perf_counter() - t_run:.1f} s",
          flush=True)
    return dict(flash=flash, scan=scan, matmul=mm_rows, matmul_phases=mm_phases,
                served=served, seconds=seconds, kernels_seconds=kernels_s)


# ------------------------------------------------------------------ mesh

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _served(cfg, params, toks, mesh=None, place=None):
    """One prefill and MESH_DECODE greedy tokens of the launcher's serving
    path (``launch/serve.py``), counted: -> (logits, tokens, prefill and
    whole-run launches by kernel and route, prefill ms, decode ms). On a
    ``mesh``, ``place`` turns the prefill's cache into what the decode
    loop takes."""
    from repro_torch.launch import serve

    _reset_counts()
    with torch.inference_mode():
        tok, logits, cache, pre_ms = serve.run_prefill(cfg, params, toks,
                                                       mesh=mesh)
    pre = _read_counts()
    if place is not None:
        cache = place(cache)
    with torch.inference_mode():
        outs, _, dec_ms = serve.run_decode(cfg, params, tok, cache,
                                           MESH_DECODE, mesh=mesh)
    counts = _read_counts()
    return (logits, torch.cat([tok] + outs, dim=1), pre, counts, pre_ms,
            dec_ms)


def host_hotspots(fn, top: int = 10) -> dict:
    """One run of ``fn`` under cProfile: its host wall (ms, synchronized)
    and the ``top`` functions by their own host time (tottime)."""
    import cProfile
    import pstats

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    _sync(dev)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    _sync(dev)
    prof.disable()
    wall = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return dict(wall_ms=wall, top=[
        (f"{os.path.basename(f)}:{line}({name})", nc, tt * 1e3)
        for (f, line, name), (_, nc, tt, _, _) in rows])


def mesh_compare(cfg, params, toks, mesh) -> dict:
    """The serving path resident, then through ``mesh`` (on any device):
    the params placed by ``param_specs`` (``fsdp_serve`` from the arch's
    settings), the prompts by ``batch_spec`` and the prefill's cache by
    ``cache_specs``, as DTensors. Raises unless the two runs' logits and
    tokens are bit-equal and their launches by kernel and route equal.
    Each run is warmed up first on the first 128 positions."""
    from repro_torch.bridge import leaves, unflatten
    from repro_torch.launch import serve
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import axis_sizes, data_axes, dp_size
    from repro_torch.launch.settings import settings_for

    dev = toks.device
    sizes, dp, n = axis_sizes(mesh), data_axes(mesh), dp_size(mesh)
    B = toks.shape[0]
    with torch.inference_mode():
        tok, _, cache, _ = serve.run_prefill(cfg, params, toks[:, :128])
        serve.run_decode(cfg, params, tok, cache, 2)
    del cache
    resident = _served(cfg, params, toks)

    _sync(dev)
    t0 = time.perf_counter()
    fsdp = settings_for(cfg.name).fsdp_serve
    dparams = shd.distribute(params, mesh, shd.param_specs(
        params, fsdp=fsdp, dp_axes=dp, dp_total=n, axis_sizes=sizes))
    mine = shd.distribute({"tokens": toks}, mesh,
                          {"tokens": shd.batch_spec(B, dp, n)})
    mine = mine["tokens"].to_local()
    _sync(dev)
    place_ms = (time.perf_counter() - t0) * 1e3
    placed = {}

    def place(cache):   # by cache_specs; the decode loop takes the local shards
        t = time.perf_counter()
        placed["cache"] = shd.distribute(cache, mesh, shd.cache_specs(
            cache, B, dp, n, sizes["model"]))
        local = unflatten({p: x.to_local() for p, x in leaves(placed["cache"])})
        _sync(dev)
        placed["ms"] = (time.perf_counter() - t) * 1e3
        return local

    with torch.inference_mode():
        tok, _, cache, _ = serve.run_prefill(cfg, dparams, mine[:, :128],
                                             mesh=mesh)
        serve.run_decode(cfg, dparams, tok, cache, 2, mesh=mesh)
    del cache
    meshed = _served(cfg, dparams, mine, mesh, place)
    kinds = {type(x).__name__ for _, x in leaves(dparams)}
    kinds |= {type(x).__name__ for _, x in leaves(placed["cache"])}
    if kinds != {"DTensor"}:
        raise AssertionError(f"mesh: placed leaves of types {kinds}")
    # the walls in turns (resident, mesh, mesh, resident): the host's
    # speed drifts within a call
    meshed2 = _served(cfg, dparams, mine, mesh, place)
    resident2 = _served(cfg, params, toks)
    for run in (meshed, meshed2, resident2):
        for name, a, b in zip(("logits", "tokens", "prefill launches",
                               "launches"), resident[:4], run[:4]):
            same = torch.equal(a, b) if name in ("logits", "tokens") \
                else a == b
            if not same:
                raise AssertionError(f"mesh: the mesh path's {name} differ "
                                     f"from the resident path's: {b} "
                                     f"against {a}")
    turns = [(tag, r[4], r[5]) for tag, r in (
        ("resident", resident), ("mesh", meshed), ("mesh", meshed2),
        ("resident", resident2))]
    # where a token's host time goes, each path once more
    tok = meshed[1][:, -1:]
    with torch.inference_mode():
        _, cache, _ = serve.run_prefill(cfg, params, toks)[1:]
        hot_res = host_hotspots(lambda: serve.run_decode(cfg, params, tok,
                                                         cache, 1))
        _, cache, _ = serve.run_prefill(cfg, dparams, mine, mesh=mesh)[1:]
        hot_mesh = host_hotspots(lambda: serve.run_decode(
            cfg, dparams, tok, cache, 1, mesh=mesh))
    del cache

    def held(tree):   # bytes this rank holds of a placed tree
        return sum(x.to_local().nbytes for _, x in leaves(tree))

    local_bytes = dict(params=held(dparams), cache=held(placed["cache"]),
                       batch=mine.nbytes)
    return dict(mesh=sizes, fsdp=fsdp, place_params_ms=place_ms,
                local_bytes=local_bytes,
                host_token_resident=hot_res, host_token_mesh=hot_mesh,
                place_cache_ms=placed["ms"],
                resident=dict(prefill_ms=resident[4], decode_ms=resident[5],
                              launches=resident[3],
                              prefill_launches=resident[2]),
                meshed=dict(prefill_ms=meshed[4], decode_ms=meshed[5],
                            launches=meshed[3], prefill_launches=meshed[2]),
                turns=turns, continuation=meshed[1][0].tolist())


def psum_check(x: torch.Tensor, group=None) -> dict:
    """``compressed_psum`` of ``x`` over a group of one rank: raises
    unless it equals ``decompress(compress(x))`` with ``==`` (the shared
    scale is the rank's own). Records what crosses the wire: each tensor
    the call hands to ``dist.all_reduce`` (its op, dtype and bytes), and
    q's int8 bytes, which stay on the rank."""
    import torch.distributed as dist

    from repro_torch.optim.compression import (compress, compressed_psum,
                                               decompress)

    q, scale = compress(x)
    wire = []
    all_reduce = dist.all_reduce

    def recorded(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        wire.append(dict(op=str(op).rsplit(".", 1)[-1],
                         dtype=str(t.dtype).replace("torch.", ""),
                         bytes=t.numel() * t.element_size()))
        return all_reduce(t, op=op, group=group, async_op=async_op)

    _sync(x.device)
    dist.all_reduce = recorded
    try:
        t0 = time.perf_counter()
        got = compressed_psum(x, group)
        _sync(x.device)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        dist.all_reduce = all_reduce
    if not torch.equal(got, decompress(q, scale, tuple(x.shape), x.dtype)):
        raise AssertionError("mesh: compressed_psum over one rank is not "
                             "decompress(compress(x))")
    want = [("MAX", "float32", scale.numel() * 4),
            ("SUM", "int32", q.numel() * 4)]
    if [(w["op"], w["dtype"], w["bytes"]) for w in wire] != want:
        raise AssertionError(f"mesh: compressed_psum's all-reduces {wire}, "
                             f"not {want}")
    return dict(shape=list(x.shape), ms=ms, fp32_bytes=x.numel() * 4,
                int8_bytes=q.numel() * q.element_size(), wire=wire,
                wire_bytes=sum(w["bytes"] for w in wire))


def dryrun_check(cfg, out: dict, batch: int, prompt: int) -> dict:
    """The dry run (``launch/dryrun.py``, counted from the placements) and
    the roofline (``launch/roofline.py``) against ``mesh_compare``'s
    ``out``: the dry run's per-rank bytes of params, the prefill's cache
    and the prompts for its cell (a prefill of ``batch`` x ``prompt`` on
    its mesh) must equal what the placed DTensors hold (each
    ``to_local()``'s nbytes) with ``==``; its collectives on that mesh
    are counted; the roofline's terms on one card's figures for that
    prefill and for a token over its cache."""
    from repro_torch.launch import dryrun, roofline

    t0 = time.perf_counter()
    sizes = out["mesh"]
    cells = {kind: dict(kind=kind, seq_len=prompt, global_batch=batch)
             for kind in ("prefill", "decode")}
    rows = {k: dryrun.count_cell(cfg, sh, sizes) for k, sh in cells.items()}
    want = {k: rows["prefill"]["bytes_per_rank"][k]
            for k in ("params", "cache", "batch")}
    if want != out["local_bytes"]:
        raise AssertionError(f"mesh: the dry run's per-rank bytes {want} "
                             f"differ from the placed DTensors' "
                             f"{out['local_bytes']}")
    colls = {k: sum(v["count"] for n, v in r["collectives"].items()
                    if n in dryrun.COLLECTIVE_FACTOR)
             for k, r in rows.items()}
    terms = {k: roofline.roofline_terms(dict(r, arch=cfg, shape=cells[k]),
                                        r["ranks"])
             for k, r in rows.items()}
    return dict(bytes=want, collectives=colls,
                roofline={k: {n: t[n] for n in ("t_compute_s", "t_memory_s",
                                                 "t_collective_s",
                                                 "dominant")}
                          for k, t in terms.items()},
                seconds=time.perf_counter() - t0)


def sweep_check() -> dict:
    """The dry run's whole sweep (every arch x shape at 16x16 and
    2x16x16) on the host, timed; raises if a row is an error."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    rows = list(dryrun.sweep())
    seconds = time.perf_counter() - t0
    status = [r["status"] for r in rows]
    if "error" in status:
        bad = [(r["arch"], r["shape"], r["mesh"], r["error"])
               for r in rows if r["status"] == "error"]
        raise AssertionError(f"dry-run rows in error: {bad}")
    return dict(rows=len(rows), ok=status.count("ok"),
                skipped=status.count("skipped"), seconds=seconds)


def mesh_phase() -> dict:
    """granite-moe-1b-a400m at full width and depth through a 1-rank
    DeviceMesh (see the module docstring): flash at its prefill shape,
    ``mesh_compare``, ``psum_check`` at (49 155, 1 024) fp32, and
    ``make_production_mesh`` refused."""
    import torch.distributed as dist

    from repro_torch.bridge import init_params, leaf_sizes
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline, serve
    from repro_torch.launch.mesh import (close_mesh, make_host_mesh,
                                         make_production_mesh)

    t0 = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    flash = flash_case(BATCH, cfg.n_heads, cfg.n_kv_heads, PROMPT, PROMPT,
                       cfg.resolved_head_dim, True, 0, "d64 16:8", "wgmma",
                       model_layout=True)
    free_memory()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    mesh = None
    try:
        mesh = make_host_mesh("cuda")
        params = init_params(cfg, seed=0, device="cuda")
        weight_bytes = sum(b for _, b in leaf_sizes(params))
        toks = serve.prompts(cfg, BATCH, PROMPT, "cuda")
        out = mesh_compare(cfg, params, toks, mesh)
        counts = out["meshed"]["launches"]
        if not counts["matmul"] or not counts["flash_attention"]:
            raise AssertionError(f"mesh: a kernel of the path was not "
                                 f"launched: {counts}")
        out["all_reduces_a_call"] = 3 * cfg.n_layers
        print(f"mesh {MOE_ARCH}: torch {torch.__version__}, 1-rank mesh "
              f"{out['mesh']} (NCCL); "
              f"{weight_bytes / 1e9:.3f} GB of params placed by param_specs "
              f"(fsdp_serve={out['fsdp']}) in {out['place_params_ms']:.1f} "
              f"ms, the prefill's cache by cache_specs in "
              f"{out['place_cache_ms']:.1f} ms; in turns, prefill "
              f"{BATCH}x{PROMPT} and {MESH_DECODE} tokens: "
              + ", ".join(f"{tag} {pre:.2f} and {dec:.2f} ms"
                          for tag, pre, dec in out["turns"])
              + f"; logits and tokens bit-equal, launches equal {counts}; "
              f"{out['all_reduces_a_call']} all_reduces a prefill and a token "
              f"(y over 'model', aux over each mesh dim)", flush=True)
        print(f"mesh {MOE_ARCH}: first request continuation "
              f"{out['continuation']}", flush=True)
        dry = dryrun_check(cfg, out, BATCH, PROMPT)
        res = [(pre, dec / MESH_DECODE) for tag, pre, dec in out["turns"]
               if tag == "resident"]
        rl = dry["roofline"]
        print(f"mesh dry run {MOE_ARCH}, prefill {BATCH}x{PROMPT} on the "
              f"{out['mesh']} mesh: per-rank bytes == the placed DTensors' "
              f"(params {dry['bytes']['params']}, cache "
              f"{dry['bytes']['cache']}, batch {dry['bytes']['batch']}); "
              f"collectives counted: {dry['collectives']['prefill']} a "
              f"prefill, {dry['collectives']['decode']} a token (every axis "
              f"one rank), against the {out['all_reduces_a_call']} "
              f"all_reduces a call the port's mesh path issues", flush=True)
        print(f"mesh roofline on one card's figures "
              f"({roofline.PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, "
              f"{roofline.HBM_BW / 1e12:.2f} TB/s): prefill "
              f"compute {rl['prefill']['t_compute_s'] * 1e3:.3f} ms, memory "
              f"{rl['prefill']['t_memory_s'] * 1e3:.3f} ms; a token compute "
              f"{rl['decode']['t_compute_s'] * 1e3:.3f} ms, memory "
              f"{rl['decode']['t_memory_s'] * 1e3:.3f} ms; measured resident "
              + ", ".join(f"prefill {p:.2f} ms and {t:.2f} ms a token"
                          for p, t in res), flush=True)
        sw = dry["sweep"] = sweep_check()
        dry["seconds"] += sw["seconds"]
        print(f"mesh dry run sweep at 16x16 and 2x16x16: {sw['rows']} rows "
              f"({sw['ok']} ok, {sw['skipped']} skipped, none in error) in "
              f"{sw['seconds']:.2f} s on the card's host; the check "
              f"{dry['seconds']:.2f} s", flush=True)
        for tag in ("resident", "mesh"):
            hot = out[f"host_token_{tag}"]
            print(f"mesh {MOE_ARCH}: one {tag} token under cProfile "
                  f"{hot['wall_ms']:.2f} ms; own host time by function:",
                  flush=True)
            for where, calls, ms in hot["top"]:
                print(f"    {ms:9.3f} ms  {calls:6d}x  {where}", flush=True)
        del params
        free_memory()
        g = torch.Generator(device="cuda").manual_seed(34)
        psum = psum_check(torch.randn((cfg.vocab, cfg.d_model), generator=g,
                                      device="cuda"))
        print(f"mesh compressed_psum {tuple(psum['shape'])} fp32: equals "
              f"decompress(compress(x)); on the wire "
              + " + ".join(f"{w['op']} all_reduce of {w['dtype']} "
                           f"{w['bytes']}" for w in psum["wire"])
              + f" = {psum['wire_bytes']} bytes against "
              f"{psum['fp32_bytes']} of fp32 (q's int8 {psum['int8_bytes']} "
              f"stays on the rank); {psum['ms']:.2f} ms host-timed",
              flush=True)
        try:
            make_production_mesh()
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("mesh: make_production_mesh() built a mesh "
                                 "at world size 1")
        print(f"mesh make_production_mesh(): refused: {refused}", flush=True)
    finally:
        if mesh is not None:
            close_mesh(mesh)
        dist.destroy_process_group()
    free_memory()
    seconds = time.perf_counter() - t0
    print(f"mesh phase done in {seconds:.1f} s on {smi()}", flush=True)
    return dict(out, arch=MOE_ARCH, weight_bytes=weight_bytes, flash=flash,
                decode_tokens=MESH_DECODE, psum=psum, dryrun=dry,
                production_refused=refused, seconds=seconds)


# ------------------------------------------- VLM and encoder-decoder

def with_gates(params, value: float) -> dict:
    """A copy of ``params`` with every cross-attention ``gate`` leaf at
    ``value``; the other leaves are the same tensors."""
    return {k: with_gates(v, value) if isinstance(v, dict)
            else torch.full_like(v, value) if k == "gate" else v
            for k, v in params.items()}


def check_gate_live(cfg, params, toks, ctx) -> float:
    """The kernel path's prefill logits with the served gates (0, as init
    leaves them) and with every gate at PATHS_GATE must differ beyond
    MODEL_TOL: with the gates at 0 neither the cross layers nor the
    encoder reach the output. Returns max |diff|."""
    from repro_torch.bridge import leaves
    from repro_torch.launch import serve

    gates = [x for p, x in leaves(params) if p.endswith("/gate")]
    if not gates or any(bool(g.any()) for g in gates):
        raise AssertionError(f"{cfg.name}: served gates {gates} are not the "
                             f"zeros of init")
    off, on = (serve.run_prefill(cfg, p, toks, ctx)[1][:, -1, :cfg.vocab]
               for p in (params, with_gates(params, PATHS_GATE)))
    diff = (on.float() - off.float()).abs().max().item()
    if within(on, off, MODEL_TOL):
        raise AssertionError(f"{cfg.name}: prefill logits with the gates at "
                             f"{PATHS_GATE} and at 0 are within {MODEL_TOL}")
    print(f"paths {cfg.name}: the gates are live: kernel-path prefill logits "
          f"with the gates at {PATHS_GATE} are {diff:.3e} from those at 0 "
          f"(beyond {MODEL_TOL})", flush=True)
    return diff


def check_context_counts(cfg, prefill: dict, decode: dict) -> None:
    """Launches of a prefill and of DECODE tokens by kernel and route
    ({kernel: {route: n}}) against CTX_COUNTS."""
    want = CTX_COUNTS[cfg.name]
    for phase, got, per, n in (("prefill", prefill, "prefill", 1),
                               ("decode", decode, "token", DECODE)):
        for kernel, routes in got.items():
            exp = dict.fromkeys(routes, 0) | {
                r: c * n for r, c in want[per][kernel].items()}
            if routes != exp:
                raise AssertionError(f"{cfg.name}: {kernel} routes {phase} "
                                     f"{routes}, expected {exp}")


def context_matmuls(cfg) -> dict:
    """{phase: {(M, K, N, b_transposed): [tags, calls]}} of every matmul of
    a prefill and of one decode token of a VLM or encoder-decoder ``cfg``,
    read off the model code: each layer's q and output projections, its K
    and V over the layer's own rows or, in a cross-attention layer, over
    the context's (at decode too), its MLP unless the FFN is none; an
    encoder-decoder's encoder over its frames (in every token too); the LM
    head on the last position."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    mlp = ([("wi_gate,wi_up", d, f, 2)] if cfg.mlp_gated
           else [("wi_up", d, f, 1)]) + [("mlp wo", f, d, 1)]
    ctx_rows = BATCH * (cfg.image_tokens or cfg.encoder_frames)
    layers = [(mixer, ffn, "") for mixer, ffn in cfg.layer_kinds()]
    layers += [("attn", "mlp", "enc ")] * cfg.encoder_layers
    out = {}
    for phase, M in (("prefill", BATCH * PROMPT), ("decode", BATCH)):
        calls: dict = {}

        def add(tag, m, k, n, c, bt=False):
            row = calls.setdefault((m, k, n, bt), [[], 0])
            if tag not in row[0]:
                row[0].append(tag)
            row[1] += c

        for mixer, ffn, enc in layers:
            m = BATCH * cfg.encoder_frames if enc else M
            add(enc + "wq", m, d, nq, 1)
            add(enc + "attn wo", m, nq, d, 1)
            if mixer == "cross":
                add("ctx wk,wv", ctx_rows, d, nkv, 2)
            else:
                add(enc + "wk,wv", m, d, nkv, 2)
            if ffn != "none":
                for tag, k, n, c in mlp:
                    add(enc + tag, m, k, n, c)
        add("lm head", BATCH, d, cfg.padded_vocab, 1, cfg.tie_embeddings)
        out[phase] = calls
    return out


def _mm_route(M: int) -> str:
    return "wgmma" if M >= 64 else "decode"


def context_matmul_phase(cfg):
    """``matmul_case`` once for every shape of ``context_matmuls(cfg)``,
    weighted by its calls in a prefill and in a decode token; the counts
    by route must be CTX_COUNTS'."""
    calls = context_matmuls(cfg)
    for phase, per in (("prefill", "prefill"), ("decode", "token")):
        by_route: dict = {}
        for (M, *_), (_, n) in calls[phase].items():
            by_route[_mm_route(M)] = by_route.get(_mm_route(M), 0) + n
        if by_route != CTX_COUNTS[cfg.name][per]["matmul"]:
            raise AssertionError(f"{cfg.name}: the {phase} walk gives "
                                 f"{by_route}, CTX_COUNTS says "
                                 f"{CTX_COUNTS[cfg.name][per]['matmul']}")
    cases, rows, phases = {}, [], {"prefill": [], "decode": []}
    for phase in phases:
        for (M, K, N, bt), (tags, n) in calls[phase].items():
            if (M, K, N, bt) not in cases:
                cases[(M, K, N, bt)] = matmul_case(
                    M, K, N, bt, torch.bfloat16, ",".join(tags), _mm_route(M))
                rows.append(cases[(M, K, N, bt)])
            phases[phase].append((cases[(M, K, N, bt)], n))
    return rows, phases


def context_flash_phase(vlm, s2t) -> dict:
    """Flash attention at the shapes the VLM and the encoder-decoder give
    it, in the model's layout: the VLM's self-attention (causal) and
    cross-attention over its 6 404 image tokens at prefill and at decode
    (S = 1), the encoder's bidirectional attention (the same shape as the
    encoder-decoder's cross-attention at prefill), its causal
    self-attention and its cross-attention at decode; and the reduced
    VLM's cross-attention on the mma_sync route."""
    from repro_torch.configs import get_reduced

    def case(cfg, S, T, causal, tag, route="wgmma", batch=BATCH):
        return flash_case(batch, cfg.n_heads, cfg.n_kv_heads, S, T,
                          cfg.resolved_head_dim, causal, 0, tag, route,
                          model_layout=True)
    small = get_reduced(VLM_ARCH)
    return {
        "vlm-self": case(vlm, PROMPT, PROMPT, True, "vlm self"),
        "vlm-cross": case(vlm, PROMPT, vlm.image_tokens, False, "vlm cross"),
        "vlm-cross-decode": case(vlm, 1, vlm.image_tokens, False,
                                 "vlm x dec"),
        "encoder": case(s2t, s2t.encoder_frames, s2t.encoder_frames, False,
                        "encoder"),
        "encdec-self": case(s2t, PROMPT, PROMPT, True, "s2t self"),
        "encdec-cross-decode": case(s2t, 1, s2t.encoder_frames, False,
                                    "s2t x dec"),
        "reduced-vlm": case(small, 16, small.image_tokens, False,
                            "reduced vlm", "mma_sync", batch=2)}


def context_archs_phase(t_run: float) -> dict:
    """The VLM and the encoder-decoder (CTX_ARCHS) at full width, whole:
    flash attention and the matmul kernel at their shapes, then each
    arch's lighter serve phase with its context, the launch and route
    counts of CTX_COUNTS, ``compare_paths`` on whole periods with the
    gates at PATHS_GATE, the reduced config against the CPU; and the
    encoder-decoder's SVM phase and launcher run."""
    from repro_torch.configs import get_config

    cfgs = {n: get_config(n) for n in CTX_ARCHS}
    flash = context_flash_phase(cfgs[VLM_ARCH], cfgs[ENCDEC_ARCH])
    matmul = {n: context_matmul_phase(cfg) for n, cfg in cfgs.items()}
    free_memory()
    served, launched = {}, None
    for name, cfg in cfgs.items():
        served[name] = serve_phase(
            cfg, repeats=NEW_PREFILL_REPEATS, profile=name == VLM_ARCH,
            svm=name == ENCDEC_ARCH, paths_layers=CTX_PATHS_LAYERS[name])
        spec = served[name].pop("spec")
        free_memory()
        if name in LAUNCHER_RUNS:
            launched = launcher_phase(
                name, served[name]["svm"]["modes"]["svm_aware"]["report"], spec)
            free_memory()
        print(f"{name} phases done at {time.perf_counter() - t_run:.1f} s",
              flush=True)
    return dict(flash=flash, matmul={n: rows for n, (rows, _) in matmul.items()},
                matmul_phases={n: ph for n, (_, ph) in matmul.items()},
                served=served, launcher=launched)


# ------------------------------------------------------- SVM weight stream

def svm_phase(cfg, params) -> dict:
    """The SVM weight stream on the served params, every mode at a pool of
    SVM_FRAC of the weights (see the module docstring): session
    equivalence, a real pool bit-equal to the params, within budget."""
    from repro_torch.bridge import leaves, tree_map
    from repro_torch.core.costmodel import H100_HOST, H100_SERVE_FLOPS
    from repro_torch.launch.serve import SVM_MODES, WeightStream
    from repro_torch.svm.executor import host_leaf

    t0 = time.perf_counter()
    host = tree_map(lambda x: host_leaf(x, pin=True), params)
    pin_s = time.perf_counter() - t0
    served = dict(leaves(params))
    nbytes = sum(x.numel() * x.element_size() for x in served.values())
    print(f"svm {cfg.name}: {nbytes / 1e9:.3f} GB of params copied to "
          f"pinned host memory in {pin_s:.2f} s; "
          f"pool {SVM_FRAC} of the weights, policy lrf, {DECODE} tokens; "
          f"H100 preset: link_bw {H100_HOST.link_bw / 1e9:.2f} GB/s, "
          f"compute {H100_SERVE_FLOPS / 1e12:.3f} TFLOP/s", flush=True)
    out = dict(pin_host_s=pin_s, modes={})
    for mode in SVM_MODES:
        def stream(**kw):
            return WeightStream(host, BATCH, budget_frac=SVM_FRAC,
                                policy="lrf", mode=mode, device="cuda", **kw)

        fused = stream()
        t0 = time.perf_counter()
        fused.steps(DECODE)
        acct_s = time.perf_counter() - t0
        report = fused.report(DECODE)
        loop, scalar = stream(), stream(scalar=True)
        t0 = time.perf_counter()
        for _ in range(DECODE):
            loop.step()
        loop_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(DECODE):
            scalar.step()
        scalar_s = time.perf_counter() - t0
        m_fused, m_loop = fused.executor.metrics(), loop.executor.metrics()
        if scalar.executor.metrics() != m_loop:
            raise AssertionError(f"svm {cfg.name} {mode}: the scalar "
                                 f"session's metrics differ from the batched")
        hits = (m_fused.pop("segment_cache_hits"),
                m_loop.pop("segment_cache_hits"))
        if m_fused != m_loop or (fused.executor.prefetch
                                 and hits[0] != hits[1]):
            raise AssertionError(f"svm {cfg.name} {mode}: decode_steps"
                                 f"({DECODE}) differs from {DECODE} "
                                 f"decode_step calls")
        pool = svm_pool_checks(cfg.name, mode, stream(), served)
        print(f"svm {cfg.name} {mode}: DOS {m_loop['dos']:.0f}%, simulated "
              f"decode wall {m_loop['wall_s'] * 1e3:.2f} ms, "
              f"{m_loop['migrations']} migrations / {m_loop['evictions']} "
              f"evictions (e2m {m_loop['evict_to_mig']:.2f}); fused: "
              f"{m_fused['segment_cache_misses']} compiled / {hits[0]} cached "
              f"segments, accounting {acct_s:.4f} s on the host (token loop "
              f"{loop_s:.4f} s, {hits[1]} cached; scalar {scalar_s:.4f} s): "
              f"scalar == batched, fused == loop; materialized pool at most "
              f"{pool['max_pool_bytes'] / 1e9:.3f} of {pool['budget'] / 1e9:.3f} "
              f"GB, {pool['checked']} tensors equal to the params on cuda",
              flush=True)
        print(f"    {report}", flush=True)
        out["modes"][mode] = dict(
            report=report, accounting_host_s=acct_s, loop_host_s=loop_s,
            scalar_host_s=scalar_s, segment_cache_hits_fused=hits[0],
            segment_cache_hits_loop=hits[1], **pool,
            **{k: m_loop[k] for k in ("dos", "wall_s", "migrations",
                                      "evictions", "evict_to_mig",
                                      "segment_cache_misses")})
    return out


def svm_pool_checks(name, mode, ws, served) -> dict:
    """A materialized run of SVM_MATERIALIZED tokens, then ``fetch`` and
    ``tensor`` of every leaf: each pool tensor and each returned tensor on
    the card and equal to the served param; the managed leaves in the pool
    within the budget after every step and fetch."""
    ex = ws.executor
    sizes = []

    def within_budget(where):
        sizes.append(ex.pool_bytes())
        if sizes[-1] > ws.budget:
            raise AssertionError(f"svm {name} {mode}: {sizes[-1]} bytes of "
                                 f"managed leaves in the pool after {where}, "
                                 f"over the budget of {ws.budget}")

    def same(path, t, where):
        if t.device.type != "cuda" or not torch.equal(t, served[path]):
            raise AssertionError(f"svm {name} {mode}: {where} {path} is not "
                                 f"the served param on cuda ({t.device})")

    checked = 0
    for step in range(SVM_MATERIALIZED):
        ex.decode_step(ws.layer_paths, ws.flops, materialize=True)
        within_budget(f"step {step}")
    for path, t in ex.pool().items():
        same(path, t, "pool tensor")
        checked += 1
    if not ex.pool():
        raise AssertionError(f"svm {name} {mode}: the pool is empty after "
                             f"a materialized run")
    for (path,) in ws.layer_paths:
        same(path, ex.fetch(path), "fetch of")
        within_budget(f"the fetch of {path}")
        checked += 1
    for (path,) in ws.layer_paths:
        same(path, ex.tensor(path), "tensor")
        checked += 1
    torch.cuda.synchronize()
    return dict(budget=ws.budget, max_pool_bytes=max(sizes), checked=checked)


def served_spec(cfg, params):
    """``ModelSpec.from_params`` of the served CUDA params, which must equal
    the spec of meta tensors of ``bridge.param_shapes(cfg)``."""
    from repro_torch.bridge import param_shapes, tree_map
    from repro_torch.svm import ModelSpec

    t0 = time.perf_counter()
    spec = ModelSpec.from_params(cfg.name, params, batch=BATCH)
    secs = time.perf_counter() - t0
    meta = tree_map(lambda sd: torch.empty(sd[0], dtype=sd[1], device="meta"),
                    param_shapes(cfg))
    if spec != ModelSpec.from_params(cfg.name, meta, batch=BATCH):
        raise AssertionError(f"spec {cfg.name}: the served params' spec "
                             f"differs from the meta tensors' spec")
    print(f"spec {cfg.name}: {len(spec.leaves)} leaves, "
          f"{spec.total_bytes / 1e9:.3f} GB, from the served params in "
          f"{secs * 1e3:.2f} ms; equal to the meta tensors' spec", flush=True)
    return spec


def sched_report(spec, policy: str, admit_by: str, chaos: bool) -> str:
    """``schedule_report`` of ``run_schedule`` on ``spec`` with the
    arguments the launcher gives it for ``--requests SCHED_REQUESTS
    --svm-budget-frac SVM_FRAC --decode DECODE`` and these flags."""
    from repro_torch.launch.serve import schedule_report
    from repro_torch.svm import FaultPlan, run_schedule

    plan = (FaultPlan.default(0, n_requests=SCHED_REQUESTS, tokens=DECODE)
            if chaos else None)
    pool = max(int(spec.total_bytes * SVM_FRAC), 1)
    return schedule_report(run_schedule(
        [spec], SCHED_REQUESTS, pool, policy=policy, admit_by=admit_by,
        seed=0, mean_interarrival_s=0.0, tokens=DECODE, evict_policy="lrf",
        fault_plan=plan, thrash_watermark=None))


def sched_block(out: str) -> str:
    """The ``svm sched[...]`` line of a launcher's output and its indented
    continuation lines."""
    lines = out.splitlines()
    starts = [i for i, ln in enumerate(lines) if ln.startswith("svm sched[")]
    if len(starts) != 1:
        return f"<{len(starts)} svm sched lines>"
    block = [lines[starts[0]]]
    for ln in lines[starts[0] + 1:]:
        if not ln.startswith("  "):
            break
        block.append(ln)
    return "\n".join(block)


def launcher_phase(name: str, want: str, spec) -> dict:
    """``repro_torch.launch.serve.main`` at full width with the SVM and
    multi-tenant flags of ``LAUNCHER_RUNS[name]``: it must serve, print
    the SVM phase's ``svm stream:`` line, and print the ``svm sched[...]``
    block of this phase's own ``run_schedule`` on the served spec."""
    import contextlib
    import io

    from repro_torch.launch import serve

    mode, sched = LAUNCHER_RUNS[name]
    want_sched = sched_report(spec, **sched)
    tenants = (["--requests", str(SCHED_REQUESTS), "--sched-policy",
                sched["policy"], "--admit-by", sched["admit_by"]]
               + (["--chaos"] if sched["chaos"] else []))
    flags = ["--arch", name, "--batch", str(BATCH), "--prompt-len",
             str(PROMPT), "--decode", str(DECODE),
             "--svm-budget-frac", str(SVM_FRAC), "--svm-mode", mode,
             "--svm-policy", "lrf"] + tenants
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve.main(flags)
    secs = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"launcher {name} {mode}: {line[:300]}", flush=True)
    got = [ln for ln in out.splitlines() if ln.startswith("svm stream:")]
    if got != [want]:
        raise AssertionError(f"launcher {name} {mode}: printed {got}, the "
                             f"SVM phase's line is {want!r}")
    if sched_block(out) != want_sched:
        raise AssertionError(f"launcher {name}: printed the block\n"
                             f"{sched_block(out)}\nthe phase's own "
                             f"run_schedule gives\n{want_sched}")
    print(f"launcher {name}: svm stream line and svm sched block equal the "
          f"phase's ({' '.join(tenants)})", flush=True)
    return dict(arch=name, mode=mode, flags=flags, seconds=secs, output=out)


# ---------------------------------------------------- multi-tenant schedule

def tier_view(r: dict) -> dict:
    """A run without the markers that differ between the scheduler's
    tiers by design (as tests/test_fused_rounds.py strips them): the
    ``fused`` flag, the concat-build and memo counters, and the fused
    tier's count of rounds degraded to per-token replay."""
    r = dict(r, shared_cache=dict(r["shared_cache"]))
    r.pop("fused")
    for k in ("shared_concats", "concat_memo_entries",
              "concat_memo_evictions"):
        r["shared_cache"].pop(k)
    if "chaos" in r:
        r["chaos"] = dict(r["chaos"])
        r["chaos"].pop("degraded_rounds")
    return r


def check_conserved(tag: str, r: dict) -> None:
    """Per-request accounting sums to the shared manager's aggregates (as
    tests/test_chaos.py's ``assert_conserved``)."""
    c, m = r["conservation"], r["mgr"]
    if abs(c["svm_wall_s"] - m["wall_s"]) > 1e-9:
        raise AssertionError(f"{tag}: per-request svm wall {c['svm_wall_s']} "
                             f"!= the manager's {m['wall_s']}")
    for k in ("migrations", "evictions", "bytes_migrated", "bytes_evicted"):
        if c[k] != m[k]:
            raise AssertionError(f"{tag}: per-request {k} {c[k]} != the "
                                 f"manager's {m[k]}")


def sched_phase(specs) -> dict:
    """The multi-tenant scheduler on the host over the two served specs
    (SCHED_MIX, SCHED_REQUESTS requests, a pool of SCHED_FRAC of the
    larger spec), every policy clean and under ``FaultPlan.default(0)``,
    at the H100 preset: fused == per-token == scalar, conservation, a
    bit-identical rerun, and every chaos event applied with no request
    failed."""
    from repro_torch.core.costmodel import H100_HOST, H100_SERVE_FLOPS
    from repro_torch.svm import FaultPlan, run_schedule
    from repro_torch.svm.scheduler import POLICIES

    cap = int(max(s.total_bytes for s in specs) * SCHED_FRAC)
    print(f"sched: {' + '.join(s.arch for s in specs)} round-robin, "
          f"{SCHED_REQUESTS} requests, {DECODE} tokens, pool "
          f"{cap / 1e9:.3f} GB ({SCHED_FRAC} of the larger); H100 preset: "
          f"link_bw {H100_HOST.link_bw / 1e9:.3f} GB/s, compute "
          f"{H100_SERVE_FLOPS / 1e12:.4f} TFLOP/s", flush=True)
    out = {}
    for policy in POLICIES:
        for chaos in (False, True):
            tag = f"sched {policy}{' chaos' if chaos else ''}"

            def run(**tier):
                plan = (FaultPlan.default(0, n_requests=SCHED_REQUESTS,
                                          tokens=DECODE) if chaos else None)
                t0 = time.perf_counter()
                r = run_schedule(specs, SCHED_REQUESTS, cap, policy=policy,
                                 fault_plan=plan, **SCHED_MIX, **tier)
                return r, time.perf_counter() - t0

            (fused, fused_s), (per_tok, per_tok_s), (scalar, scalar_s) = (
                run(fused=True), run(fused=False),
                run(fused=False, scalar=True))
            if not (fused["fused"] and not per_tok["fused"]
                    and tier_view(fused) == tier_view(per_tok)
                    == tier_view(scalar)):
                raise AssertionError(f"{tag}: the fused, per-token and "
                                     f"scalar tiers differ")
            for r in (fused, per_tok, scalar):
                check_conserved(tag, r)
            if run(fused=True)[0] != fused:
                raise AssertionError(f"{tag}: a rerun differs")
            if fused["n_failed"]:
                raise AssertionError(f"{tag}: {fused['n_failed']} requests "
                                     f"failed")
            if chaos and fused["chaos"]["injector"]["events_remaining"]:
                raise AssertionError(f"{tag}: chaos events left unapplied: "
                                     f"{fused['chaos']['injector']}")
            print(f"{tag}: p50/p99 latency {fused['latency_p50_s'] * 1e3:.2f}"
                  f"/{fused['latency_p99_s'] * 1e3:.2f} ms simulated, "
                  f"{fused['evictions_per_token']:.2f} evictions a token, "
                  f"peak DOS {fused['dos_peak']:.1f}% (offered "
                  f"{fused['dos_offered']:.1f}%), agg {fused['agg_tok_s']:.1f} "
                  f"tok/s; host {fused_s:.4f} s fused, {per_tok_s:.4f} "
                  f"per-token, {scalar_s:.4f} scalar: tiers equal, "
                  f"conserved, rerun equal"
                  + (f", {fused['chaos']['injector']['events_applied']} "
                     f"events applied" if chaos else ""), flush=True)
            out[tag] = dict(
                host_s=dict(fused=fused_s, per_token=per_tok_s,
                            scalar=scalar_s),
                dos_offered=fused["dos_offered"],
                **{k: fused[k] for k in SCHED_HEADLINE})
    for chaos in ("", " chaos"):
        a, b = (out[f"sched {p}{chaos}"] for p in ("admission", "svm_aware"))
        same = [k for k in SCHED_HEADLINE if a[k] == b[k]]
        out[f"svm_aware == admission{chaos}"] = same
        print(f"sched{chaos or ' clean'}: svm_aware equals admission in "
              f"{len(same)} of {len(SCHED_HEADLINE)} headline numbers "
              f"({', '.join(same) or 'none'})", flush=True)
    return out


def link_rates() -> dict:
    """GB/s of a host-to-device copy of LINK_BYTES with
    ``.to("cuda", non_blocking=True)``, from pinned and from pageable
    memory, timed with CUDA events: the median of LINK_REPS after a
    warm-up."""
    out = {}
    for kind in ("pinned", "pageable"):
        src = torch.empty(LINK_BYTES, dtype=torch.uint8,
                          pin_memory=kind == "pinned")
        src.fill_(1)
        times = []
        for _ in range(LINK_REPS + 1):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            dst = src.to("cuda", non_blocking=True)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
            del dst
        ms = statistics.median(times[1:])
        out[kind] = dict(ms=ms, times_ms=times[1:],
                         bytes_s=LINK_BYTES / (ms / 1e3))
        del src
    print(f"link_bw: host to device, {LINK_BYTES} bytes, median of "
          f"{LINK_REPS}: pinned {out['pinned']['bytes_s'] / 1e9:.2f} GB/s "
          f"({out['pinned']['ms']:.3f} ms), pageable "
          f"{out['pageable']['bytes_s'] / 1e9:.2f} GB/s "
          f"({out['pageable']['ms']:.3f} ms)", flush=True)
    free_memory()
    return out


def serving_rate(served: dict) -> dict:
    """The model's decode flops as the weight stream counts them (2 x
    batch x params a token) over the decode step's device-busy time (the
    profiled window of 4 tokens) and over its wall time (CUDA events)."""
    flops = 2.0 * BATCH * served["n_params"]
    busy_ms = served["profile_decode_4_tokens"][0] / 4
    wall_ms = served["decode_ms_per_token"]
    out = dict(flops_per_token=flops, busy_ms_per_token=busy_ms,
               wall_ms_per_token=wall_ms,
               flops_s_busy=flops / (busy_ms / 1e3),
               flops_s_wall=flops / (wall_ms / 1e3))
    print(f"serving rate {served['arch']}: {flops / 1e9:.3f} GFLOP a token "
          f"(2 x {BATCH} x {served['n_params']} params) over {busy_ms:.3f} ms "
          f"device busy = {out['flops_s_busy'] / 1e12:.3f} TFLOP/s; over "
          f"{wall_ms:.3f} ms wall = {out['flops_s_wall'] / 1e12:.3f} TFLOP/s",
          flush=True)
    return out


def check_scan_launches(cfg, prefill: int, total: int) -> None:
    """One scan launch a Mamba layer in prefill, none in decode (the
    decode recurrence is plain PyTorch)."""
    got = {"prefill": prefill, "decode": total - prefill}
    want = {"prefill": sum(1 for m, _ in cfg.layer_kinds() if m == "mamba"),
            "decode": 0}
    if got != want:
        raise AssertionError(f"{cfg.name}: mamba_scan launches {got}, "
                             f"expected {want}")


def check_routes(cfg, prefill: dict, decode: dict, flash: dict | None,
                 tokens: int = DECODE) -> None:
    """Every prefill projection took the wgmma route and the LM head (the
    last position only, M = BATCH) the decode route; every matmul of the
    ``tokens`` decode tokens took the decode route; every prefill
    attention call (one a self-attention layer) took the flash kernel's
    wgmma route."""
    proj = sum(calls for *_, calls in projections(cfg))
    want_pre = dict.fromkeys(prefill, 0) | {"wgmma": proj, "decode": 1}
    want_dec = dict.fromkeys(decode, 0) | {"decode": (proj + 1) * tokens}
    if prefill != want_pre or decode != want_dec:
        raise AssertionError(f"{cfg.name}: matmul routes prefill {prefill}, "
                             f"decode {decode}; expected {want_pre} and "
                             f"{want_dec}")
    if flash is not None:
        n_attn = sum(1 for m, _ in cfg.layer_kinds() if m != "mamba")
        want_fa = dict.fromkeys(flash, 0) | {"wgmma": n_attn}
        if flash != want_fa:
            raise AssertionError(f"{cfg.name}: flash_attention routes prefill "
                                 f"{flash}; expected {want_fa}")


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def compare_paths(cfg, params, toks, steps: int = 4, ctx=None) -> dict:
    """Full width: the kernel path (impl="auto") and the plain path
    (impl="torch"), both bf16, against the same model run in fp32 on the
    plain path. Prefill's last-position logits, then ``steps`` decode
    steps teacher-forced on the fp32 path's greedy tokens, each path on its
    own cache. Both bf16 paths round the residual stream after every
    sublayer, at different points (for gemma3-1b fp32 scores in the flash
    kernel and bf16 in the plain path's attention; other fp32 sum orders
    everywhere), so at full width neither is within an elementwise 2e-2 of
    the other. The check: the kernel path is no farther from fp32 than the
    plain path, relative L2 distance within PATH_RATIO of it at every step,
    and both bf16 paths pick fp32's greedy token wherever its top-2 gap
    exceeds MARGIN. MoE layers: both bf16 paths replay the fp32 path's
    routing (``RouteTape``), the kernel path's router logits must be no
    farther from fp32's than PATH_RATIO x the plain path's, and the tokens
    whose own choices differ from fp32's are counted. A modality context
    ``ctx`` goes to every path (to the fp32 path in fp32), encoded again in
    every step for an encoder-decoder, as the launcher does."""
    from repro_torch.bridge import tree_map

    params32 = tree_map(lambda x: x.float(), params)   # 4 bytes a weight
    setups = {"fp32": (params32, "torch"), "plain": (params, "torch"),
              "kernel": (params, "auto")}
    ctxs = {"fp32": None if ctx is None else ctx.float(), "plain": ctx,
            "kernel": ctx}
    tape = RouteTape() if cfg.n_experts else None

    def play(name):
        if tape:
            tape.play(None if name == "fp32" else name)

    with tape or contextlib.nullcontext():
        return _compare_paths(cfg, toks, steps, setups, ctxs, play, tape)


def _compare_paths(cfg, toks, steps, setups, ctxs, play, tape) -> dict:
    from repro_torch.launch import serve
    from repro_torch.launch.steps import model_context
    from repro_torch.models import transformer as tm

    logits, caches, out = {}, {}, {"steps": []}
    for name, (p, impl) in setups.items():
        play(name)
        _, lg, caches[name], ms = serve.run_prefill(cfg, p, toks, ctxs[name],
                                                    impl=impl)
        logits[name] = lg[:, -1, :cfg.vocab]   # without the masked padding
        if name == "plain":
            out["plain_prefill_ms"] = ms
    for step in range(steps + 1):
        if step:
            for name, (p, impl) in setups.items():
                play(name)
                lg, caches[name] = tm.decode_step(
                    p, cfg, tok, caches[name],
                    model_context(p, cfg, ctxs[name], impl), impl=impl)
                logits[name] = lg[:, -1, :cfg.vocab]
        ref = logits["fp32"].float()
        top2 = ref.topk(2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > MARGIN
        tok = ref.argmax(dim=-1).int()[:, None]
        for name in ("plain", "kernel"):
            if not torch.isfinite(logits[name].float()).all():
                raise AssertionError(f"{name} path: non-finite logits")
            ids = logits[name].float().argmax(dim=-1)[:, None]
            if not torch.equal(ids[decisive], tok[decisive]):
                raise AssertionError(f"{name} path: greedy token differs from "
                                     f"fp32 at step {step}")
        row = dict(step=step, plain=rel_l2(logits["plain"], ref),
                   kernel=rel_l2(logits["kernel"], ref),
                   kernel_vs_plain=rel_l2(logits["kernel"], logits["plain"]),
                   decisive=int(decisive.sum()))
        out["steps"].append(row)
        print(f"paths step {step}: relative L2 to fp32: plain {row['plain']:.3e}, "
              f"kernel {row['kernel']:.3e}; kernel vs plain "
              f"{row['kernel_vs_plain']:.3e}; {row['decisive']}/{len(tok)} "
              f"decisive greedy tokens agree", flush=True)
        if row["kernel"] > PATH_RATIO * row["plain"]:
            raise AssertionError(f"kernel path farther from fp32 than "
                                 f"{PATH_RATIO} x the plain path: {row}")
    if tape:
        st = {n: tape.stats[n] for n in ("plain", "kernel")}
        rel = {n: tape.router_rel_l2(n) for n in st}
        out["router"] = dict(calls=len(tape.calls), rel_l2=rel,
                             flips={n: st[n]["flips"] for n in st},
                             max_flip_gap={n: st[n]["max_flip_gap"] for n in st})
        print(f"paths router: {len(tape.calls)} route calls, both bf16 paths "
              f"on the fp32 path's experts; router logits relative L2 to "
              f"fp32: plain {rel['plain']:.3e}, kernel {rel['kernel']:.3e}; "
              f"tokens whose own choices differ from fp32's: plain "
              f"{st['plain']['flips']}, kernel {st['kernel']['flips']} "
              f"(largest fp32 gap between their k-th and (k+1)-th logit: "
              f"{max(s['max_flip_gap'] for s in st.values()):.3e})",
              flush=True)
        if rel["kernel"] > PATH_RATIO * rel["plain"]:
            raise AssertionError(f"kernel path's router logits farther from "
                                 f"fp32 than {PATH_RATIO} x the plain "
                                 f"path's: {rel}")
    return out


class RouteTape:
    """MoE routing of a reference run, replayed on the runs held against it
    (a context manager that wraps ``repro_torch.models.moe.route``). At a
    near tie the expert a token picks depends on the last bit of its
    router logits, so two correct runs that round differently (bf16 and
    fp32, the card and the CPU) pick other experts for a few tokens, and
    those tokens' whole layers differ. Within ``play(None)`` each route
    call is recorded; within ``play(name)`` the run computes its own route
    (its router kernel launched) and goes on with the recorded experts,
    the gates taken from its own probabilities, so that every other tensor
    can be held against the reference. Per replaying run it keeps the
    router logits' distance to the recorded ones (summed squares and max
    |err|) and the tokens whose own set of k experts differs, with the
    reference's gap between the k-th and (k+1)-th logit of each (how far
    from a tie the reference's choice was). ``elementwise`` also holds
    each call's router logits within that tolerance."""

    def __init__(self, elementwise: dict | None = None):
        from repro_torch.models import moe
        self.moe, self.route = moe, moe.route
        self.elementwise = elementwise
        self.calls, self.current, self.stats = [], None, {}

    def __enter__(self):
        self.moe.route = self._route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def play(self, name: str | None) -> None:
        """Record (None), or replay as the run ``name``."""
        self.current = name
        if name is not None:
            self.stats.setdefault(name, dict(cursor=0, diff2=0.0, ref2=0.0,
                                             max_err=0.0, flips=0,
                                             max_flip_gap=0.0))

    def router_rel_l2(self, name: str) -> float:
        st = self.stats[name]
        return math.sqrt(st["diff2"] / st["ref2"])

    def _route(self, p, cfg, x, impl="auto"):
        from repro_torch.kernels import ops

        gate, idx, probs = self.route(p, cfg, x, impl)
        logits = ops.matmul(x.reshape(-1, x.shape[-1]), p["router"],
                            impl=impl).float()
        if self.current is None:
            self.calls.append((logits, idx))
            return gate, idx, probs
        st = self.stats[self.current]
        want_logits, want_idx = (t.to(x.device)
                                 for t in self.calls[st["cursor"]])
        st["cursor"] += 1
        if self.elementwise is not None:
            check_close("router logits", logits.cpu(), want_logits.cpu(),
                        self.elementwise)
        d = logits - want_logits
        st["diff2"] += d.square().sum().item()
        st["ref2"] += want_logits.square().sum().item()
        st["max_err"] = max(st["max_err"], d.abs().max().item())
        flipped = (idx.sort(dim=-1).values
                   != want_idx.sort(dim=-1).values).any(dim=-1)
        if flipped.any():
            srt = want_logits.sort(dim=-1, descending=True).values
            gap = srt[:, cfg.top_k - 1] - srt[:, cfg.top_k]
            st["flips"] += int(flipped.sum())
            st["max_flip_gap"] = max(st["max_flip_gap"],
                                     gap[flipped].max().item())
        top = probs.gather(1, want_idx)
        return ((top / top.sum(dim=-1, keepdim=True)).to(x.dtype), want_idx,
                probs)


def reduced_vs_cpu(name: str) -> dict:
    """Small input, the repo's own tolerance: the reduced config of
    ``name`` served on the card through the kernels against the plain path
    on the CPU, same params and prompts; prefill logits and 8 decode steps
    past prompt_len, teacher-forced on the CPU's tokens, elementwise
    within MODEL_TOL. Every Mamba mixer gets the LOUD_MODEL gains: at its
    init it leaves the logits unchanged within any tolerance, so the CPU's
    prefill logits with the gains must differ from init's beyond
    MODEL_TOL. MoE layers
    replay the CPU's routing (``RouteTape``); the error of the card's own
    routing is printed beside it. A VLM or an encoder-decoder takes the
    launcher's context, its cross-attention gates at REDUCED_GATE, and its
    prefill logits on the card with the gates at 0 must differ from them
    beyond MODEL_TOL."""
    from repro_torch.bridge import init_params, tree_map
    from repro_torch.configs import get_reduced
    from repro_torch.launch import serve
    from repro_torch.launch.steps import model_context
    from repro_torch.models import transformer as tm

    cfg = get_reduced(name)
    p_cpu = init_params(cfg, seed=0, device="cpu")
    toks = serve.prompts(cfg, 2, 24, "cpu")
    loud_diff = None
    if any(m == "mamba" for m, _ in cfg.layer_kinds()):
        quiet = serve.run_prefill(cfg, p_cpu, toks)[1]
        p_cpu = loud_copy(cfg, p_cpu, LOUD_MODEL)
        loud = serve.run_prefill(cfg, p_cpu, toks)[1]
        if within(loud, quiet, MODEL_TOL):
            raise AssertionError(f"reduced {name}: the prefill logits with "
                                 f"LOUD_MODEL are within {MODEL_TOL} of "
                                 f"init's")
        loud_diff = (loud.float() - quiet.float()).abs().max().item()
    ctx = serve.context(cfg, 2, "cpu")
    if ctx is not None:
        p_cpu = with_gates(p_cpu, REDUCED_GATE)
    p_gpu = tree_map(lambda x: x.to("cuda"), p_cpu)

    def run(params, device, fed=None):
        """Prefill logits and 8 decode steps' logits; decode is fed
        ``fed`` (the CPU's greedy tokens), or its own greedy tokens."""
        c = None if ctx is None else ctx.to(device)
        tok, lg, cache, _ = serve.run_prefill(cfg, params, toks.to(device), c)
        logits, own = [lg.cpu()], [tok.cpu()]
        for i in range(8):
            tok = (fed[i] if fed else own[-1]).to(device)
            lg, cache = tm.decode_step(params, cfg, tok, cache,
                                       model_context(params, cfg, c))
            logits.append(lg.cpu())
            own.append(lg[:, -1].argmax(dim=-1).int()[:, None].cpu())
        return logits, own

    tape = RouteTape(elementwise=MODEL_TOL) if cfg.n_experts else None
    with tape or contextlib.nullcontext():
        if tape:
            tape.play(None)
        want, fed = run(p_cpu, "cpu")
        if tape:
            tape.play("card")
        got, _ = run(p_gpu, "cuda", fed)
    errs = [check_close("reduced prefill" if i == 0 else "reduced decode",
                        g, w, MODEL_TOL) for i, (g, w) in enumerate(zip(got, want))]
    out = dict(prefill_max_abs_err=errs[0], decode_max_abs_err=max(errs[1:]),
               loud_vs_init_max_abs_diff=loud_diff)
    line = (f"reduced {name}, card kernels vs CPU plain: max |err| prefill "
            f"{errs[0]:.3e}, 8 decode steps {max(errs[1:]):.3e} "
            f"(tolerance {MODEL_TOL})")
    if loud_diff is not None:
        line += (f"; Mamba mixers at LOUD_MODEL, their CPU prefill logits "
                 f"{loud_diff:.3e} from init's")
    if ctx is not None:
        off = run(with_gates(p_gpu, 0.0), "cuda", fed)[0][0]
        if within(got[0], off, MODEL_TOL):
            raise AssertionError(f"reduced {name}: the prefill logits with "
                                 f"the gates at {REDUCED_GATE} and at 0 are "
                                 f"within {MODEL_TOL}")
        out["gate_live_max_abs_diff"] = (got[0].float()
                                         - off.float()).abs().max().item()
        line += (f"; gates at {REDUCED_GATE}, their prefill logits "
                 f"{out['gate_live_max_abs_diff']:.3e} from the gates at 0")
    if tape:
        own, _ = run(p_gpu, "cuda", fed)          # the card's own routing
        st = tape.stats["card"]
        out.update(route_calls=len(tape.calls), route_flips=st["flips"],
                   route_flip_max_gap=st["max_flip_gap"],
                   router_logits_max_abs_err=st["max_err"],
                   own_routing_max_abs_err=max(
                       (g.float() - w.float()).abs().max().item()
                       for g, w in zip(own, want)))
        line += (f"; MoE routing replayed from the CPU over "
                 f"{len(tape.calls)} route calls, router logits within "
                 f"tolerance (max |err| {st['max_err']:.3e}), {st['flips']} "
                 f"tokens choose other experts on the card (largest CPU gap "
                 f"between their k-th and (k+1)-th logit: "
                 f"{st['max_flip_gap']:.3e}); with the card's own routing "
                 f"max |err| {out['own_routing_max_abs_err']:.3e}")
    print(line, flush=True)
    return out


# ---------------------------------------------------------------- training

def _bf16_view(g, B, S, H, D, scale=1.0):
    """(B, H, S, D) bf16 as the model hands it over: a (B, S, H, D) tensor
    transposed."""
    return (torch.randn((B, S, H, D), generator=g, device="cuda") * scale
            ).to(torch.bfloat16).transpose(1, 2)


def sdpa_bwd_ms(q, k, v, do, causal, window, scale, reps: int = 10) -> float:
    """Median ms of the backward pass of ``F.scaled_dot_product_attention``
    through autograd (CUDA events around ``torch.autograd.grad``, its
    forward recorded once), K and V repeated to the q heads as in
    ``flash_case``: the flash backward kernel's time yardstick."""
    from repro_torch.kernels import ref

    B, H, S, _ = q.shape
    KV, T = k.shape[1], k.shape[2]
    qc = q.detach().contiguous().requires_grad_()
    kr, vr = (x.detach().repeat_interleave(H // KV, dim=1).contiguous()
              .requires_grad_() for x in (k, v))
    if causal and not window and S == T:
        out = F.scaled_dot_product_attention(qc, kr, vr, is_causal=True,
                                             scale=scale)
    elif not causal and not window:
        out = F.scaled_dot_product_attention(qc, kr, vr, scale=scale)
    else:
        out = F.scaled_dot_product_attention(
            qc, kr, vr, attn_mask=ref.attention_mask(S, T, causal, window,
                                                     "cuda"), scale=scale)
    doc = do.contiguous()

    def run():
        torch.autograd.grad(out, (qc, kr, vr), doc, retain_graph=True)
    for _ in range(2):
        run()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        run()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def attention_grads_fp64(q, k, v, do, causal, window, scale) -> list:
    """dq, dk, dv of exact softmax attention in fp64 from the same inputs,
    by autograd, one batch element at a time: the truth the backward
    kernel and its plain version are both measured against."""
    from repro_torch.kernels import ref

    B, H, S, _ = q.shape
    KV, T = k.shape[1], k.shape[2]
    mask = ref.attention_mask(S, T, causal, window, "cuda")
    grads = []
    for b in range(B):
        qb, kb, vb = (x[b:b + 1].double().requires_grad_() for x in (q, k, v))
        kr, vr = (x.repeat_interleave(H // KV, dim=1) for x in (kb, vb))
        s = torch.einsum("bhsd,bhtd->bhst", qb * scale, kr)
        p = torch.softmax(s.masked_fill(~mask, -math.inf), -1).nan_to_num(0.0)
        o = torch.einsum("bhst,bhtd->bhsd", p, vr)
        grads.append(torch.autograd.grad(o, (qb, kb, vb), do[b:b + 1].double()))
        del qb, kb, vb, kr, vr, s, p, o
    return [torch.cat([g[i] for g in grads]) for i in range(3)]


def flash_bwd_case(B, H, KV, S, T, D, causal, window, tag, want_route,
                   split: bool = False) -> dict:
    """One case of the flash backward kernel, inputs in the model's layout
    (q pre-scaled, score scale 1): the forward's route (asserted) and its
    row log-sum-exp against the plain version's; the backward's route
    (``want_route``, asserted); dq, dk and dv of
    ``flash_attention_bwd`` against ``flash_attention_bwd_ref`` on the
    same q, k, v, o, lse and dO within BWD_TOL, the tolerance's power to
    reject a wrong output (whole, or in the back half of its rows), a
    second call's bits against the first's; the kernel's relative L2
    distance to the fp64 truth within PATH_RATIO of the plain version's
    (the kernel rounds dS to bf16 as a product operand, the plain version
    keeps it fp32); the kernel, the plain version and SDPA's backward
    timed; with ``split``, each launch's device time under the
    profiler."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(S * 17 + T + D + window)
    q = _bf16_view(g, B, S, H, D, D ** -0.5)
    k, v = _bf16_view(g, B, T, KV, D), _bf16_view(g, B, T, KV, D)
    do = _bf16_view(g, B, S, H, D)
    name = (f"flash bwd {tag} (B={B} H={H} KV={KV} S={S} T={T} D={D} "
            f"causal={int(causal)} window={window})")
    fwd_route = kfa.route(D, torch.bfloat16)
    before = dict(kfa.route_launches)
    o, lse = kfa.flash_attention(q, k, v, causal, window, 1.0, return_lse=True)
    taken = {r: n - before[r] for r, n in kfa.route_launches.items()
             if n != before[r]}
    if taken != {fwd_route: 1}:
        raise AssertionError(f"{name}: forward took routes {taken}, "
                             f"expected {fwd_route}")
    want_o, want_lse = ref.flash_attention_ref(q, k, v, causal, window, 1.0,
                                               return_lse=True)
    lse_err = check_close(f"{name} lse", lse, want_lse, LSE_TOL)
    check_discerns(f"{name} lse", want_lse, LSE_TOL)
    check_close(f"{name} out", o, want_o, FA_TOL)
    del want_o, want_lse
    args = (q, k, v, o, lse, do, causal, window, 1.0)
    if kfa.bwd_route(D, torch.bfloat16) != want_route:
        raise AssertionError(f"{name}: bwd_route picks "
                             f"{kfa.bwd_route(D, torch.bfloat16)}, the case "
                             f"expects {want_route}")
    n0 = kfa.bwd_launches
    before = dict(kfa.bwd_route_launches)
    got = kfa.flash_attention_bwd(*args)
    again = kfa.flash_attention_bwd(*args)
    taken = {r: n - before[r] for r, n in kfa.bwd_route_launches.items()
             if n != before[r]}
    if kfa.bwd_launches - n0 != 2 or taken != {want_route: 2}:
        raise AssertionError(f"{name}: {kfa.bwd_launches - n0} backward "
                             f"launches on routes {taken}, expected 2 on "
                             f"{want_route}")
    want = ref.flash_attention_bwd_ref(*args)
    torch.cuda.synchronize()
    truth = attention_grads_fp64(q, k, v, do, causal, window, 1.0)
    errs, l2 = {}, {}
    for nm, got_x, again_x, want_x, true_x in zip(("dq", "dk", "dv"), got,
                                                  again, want, truth):
        errs[nm] = check_close(f"{name} {nm}", got_x, want_x, BWD_TOL)
        check_discerns(f"{name} {nm}", want_x, BWD_TOL, rows=True)
        if not torch.equal(got_x, again_x):
            raise AssertionError(f"{name} {nm}: two calls on the same inputs "
                                 f"differ")
        l2[nm] = {"kernel": rel_l2(got_x, true_x),
                  "plain": rel_l2(want_x, true_x)}
        if not l2[nm]["kernel"] <= PATH_RATIO * l2[nm]["plain"]:
            raise AssertionError(f"{name} {nm}: relative L2 to fp64 "
                                 f"{l2[nm]['kernel']:.3e}, over {PATH_RATIO} "
                                 f"x the plain version's "
                                 f"{l2[nm]['plain']:.3e}")
    del got, again, want, truth
    free_memory()
    ms = time_ms(lambda: kfa.flash_attention_bwd(*args), [()])
    plain = time_plain_ms(lambda: ref.flash_attention_bwd_ref(*args), [()])
    free_memory()
    lib = sdpa_bwd_ms(q, k, v, do, causal, window, 1.0)
    if split:   # the call's device time by launch: Delta, then dK/dV and
        # dQ in one wgmma launch or in two mma_sync launches
        _, _, top = profile_device(lambda: kfa.flash_attention_bwd(*args))
        split = {part: sum(ms for nm, ms, _ in top if key in nm)
                 for part, key in (("delta", "flash_bwd_delta"),
                                   ("dkv+dq", "flash_bwd_wgmma"),
                                   ("dkv", "flash_bwd_dkv<"),
                                   ("dq", "flash_bwd_dq<"))}
        split = {part: ms for part, ms in split.items() if ms}
    pairs = int(ref.attention_mask(S, T, causal, window, "cuda").sum().item())
    flops = 10.0 * B * H * pairs * D   # S again, dP, dV, dK, dQ: 2 flops a MAC
    nbytes = 2 * (4 * B * H * S * D + 4 * B * KV * T * D) + 4 * B * H * S
    bnd, by = bound_ms(nbytes, flops, torch.bfloat16, exps=B * H * pairs)
    row = dict(tag=tag, B=B, H=H, KV=KV, S=S, T=T, D=D, causal=causal,
               window=window, fwd_route=fwd_route, route=want_route,
               lse_max_abs_err=lse_err,
               max_abs_err=max(errs.values()), errs=errs, rel_l2_fp64=l2,
               ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
               tflops=flops / ms / 1e9, split_ms=split or None)
    print(f"flash bwd {tag:>16} B={B} H={H} KV={KV} S={S} T={T} D={D} "
          f"causal={int(causal)} window={window} route={want_route} (fwd "
          f"{fwd_route}) lse err={lse_err:.2e}; dq {errs['dq']:.2e} dk {errs['dk']:.2e} dv "
          f"{errs['dv']:.2e}; rel L2 to fp64 kernel/plain "
          + " ".join(f"{nm} {r['kernel']:.3e}/{r['plain']:.3e}"
                     for nm, r in l2.items())
          + f"; kernel {ms:.4f} ms ({row['tflops']:.0f} TFLOP/s) "
          f"plain {plain:.4f}  sdpa bwd {lib:.4f}  bound {bnd:.4f} ({by})"
          + ("; profiled " + " ".join(f"{k} {v:.4f}" for k, v in split.items())
             if split else ""), flush=True)
    del q, k, v, o, lse, do, args
    free_memory()
    return row


def flash_bwd_phase(split: bool = False) -> list[dict]:
    """Phase (a): the backward kernel at BWD_CASES."""
    return [flash_bwd_case(*c, split=split) for c in BWD_CASES]


def train_matmul_phase(cfg, mb_tokens: int) -> list[dict]:
    """The matmul kernel at the training shapes of one microbatch of
    ``mb_tokens`` tokens: for each projection of a layer its forward
    product C = A W, dA = dC W^T (W^T made row-major: a weight's bytes)
    and dW = A^T dC (A^T made row-major: M x K), and for the tied head's
    chunk (CE_CHUNK rows a sequence) C = A E^T read in place (mma_sync),
    dA = dC E and dE = dC^T A; each beside its plain version and
    ``torch.matmul`` of the same product, with the transposes timed on
    their own."""
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ref
    from repro_torch.launch.steps import CE_CHUNK

    def mm(x, y, bt=False):
        return kmm.matmul(x, y, b_transposed=bt)

    def t(x):
        return x.t().contiguous()

    rows = []
    chunk = mb_tokens // TRAIN_SEQ * min(CE_CHUNK, TRAIN_SEQ)
    shapes = [(tag, mb_tokens, K, N, calls)
              for tag, K, N, calls in projections(cfg)]
    shapes.append(("lm head chunk", chunk, cfg.d_model, cfg.padded_vocab,
                   math.ceil(TRAIN_SEQ / CE_CHUNK)))
    for tag, M, K, N, calls in shapes:
        g = torch.Generator(device="cuda").manual_seed(M + K + N)
        a = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        dc = torch.randn((M, N), generator=g, device="cuda").to(torch.bfloat16)
        head = tag == "lm head chunk"
        w = (torch.randn((N, K) if head else (K, N), generator=g,
                         device="cuda") * 0.02).to(torch.bfloat16)
        if head:   # C = A E^T; dA = dC E; dE = dC^T A
            prods = {"fwd": ((a, w, True), lambda: torch.matmul(a, w.t())),
                     "dA": ((dc, w, False), lambda: torch.matmul(dc, w)),
                     "dW": ((t(dc), a, False), lambda: torch.matmul(dc.t(), a))}
            trans = [dc]
        else:      # C = A W; dA = dC W^T; dW = A^T dC
            prods = {"fwd": ((a, w, False), lambda: torch.matmul(a, w)),
                     "dA": ((dc, t(w), False), lambda: torch.matmul(dc, w.t())),
                     "dW": ((t(a), dc, False), lambda: torch.matmul(a.t(), dc))}
            trans = [w, a]
        row = dict(tag=tag, M=M, K=K, N=N, calls_per_microbatch=calls)
        for name, ((x, y, bt), lib) in prods.items():
            want = kmm.route(x.shape[0], y.shape[0] if bt else y.shape[1],
                             x.shape[1], bt, x.dtype,
                             (x.data_ptr(), y.data_ptr(), 0))
            row[name] = dict(route=want, ms=time_ms(lambda: mm(x, y, bt), [()]),
                             plain_ms=time_plain_ms(
                                 lambda: ref.matmul_ref(x, y, bt), [()]),
                             library_ms=time_ms(lib, [()]))
        row["transpose_ms"] = sum(time_ms(lambda x=x: t(x), [()]) for x in trans)
        nbytes = 2 * (M * K + K * N + M * N)
        row["bound_ms"] = bound_ms(nbytes, 2.0 * M * N * K, torch.bfloat16)[0]
        print(f"train matmul {tag:>14} M={M:<5d} K={K:<5d} N={N:<6d} "
              + "  ".join(f"{n} {r['route']} {r['ms']:.4f} ms (plain "
                          f"{r['plain_ms']:.4f}, torch.matmul "
                          f"{r['library_ms']:.4f})" for n, r in
                          ((n, row[n]) for n in prods))
              + f"  transposes {row['transpose_ms']:.4f} ms  bound "
              f"{row['bound_ms']:.4f} ms a product", flush=True)
        rows.append(row)
        del a, dc, w, prods, trans
        free_memory()
    return rows


def train_counts(cfg, microbatches: int) -> dict:
    """Launches of one train step by kernel and route, read off the code:
    a microbatch's forward runs every projection and the head's chunks,
    the recompute runs them again (every layer sits in a period), and the
    backward pass takes two products a forward product, on wgmma; a tied
    head's forward (C = A E^T) runs on mma_sync, an untied one's on
    wgmma. Flash runs forward twice and backward once an attention layer,
    both on wgmma (D = 64); the scan likewise a Mamba layer, on its one
    route ("cuda")."""
    from repro_torch.launch.steps import CE_CHUNK

    chunks = math.ceil(TRAIN_SEQ / CE_CHUNK)
    fwd = sum(n for _, _, _, n in projections(cfg)) + chunks
    tied = 2 * chunks if cfg.tie_embeddings else 0
    mixer = "mamba_scan" if cfg.attention_free else "flash_attention"
    route = "cuda" if cfg.attention_free else "wgmma"
    counts = dict(matmul={"wgmma": microbatches * (4 * fwd - tied)},
                  **{k: {} for k in COUNTED if k != "matmul"})
    if tied:
        counts["matmul"]["mma_sync"] = microbatches * tied
    counts[mixer] = {route: microbatches * 2 * cfg.n_layers}
    counts[mixer + "_bwd"] = {route: microbatches * cfg.n_layers}
    return counts


# the kernels whose launches a train step counts, by route
COUNTED = ("matmul", "flash_attention", "flash_attention_bwd", "mamba_scan",
           "mamba_scan_bwd")


def _reset_counts() -> None:
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import mamba_scan as kscan
    from repro_torch.kernels import matmul as kmm

    for m in (kmm, kfa):
        m.launches = 0
        m.route_launches.update(dict.fromkeys(m.ROUTES, 0))
    kfa.bwd_launches = 0
    kfa.bwd_route_launches.update(dict.fromkeys(kfa.BWD_ROUTES, 0))
    kscan.launches = kscan.bwd_launches = 0


def _read_counts() -> dict:
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import mamba_scan as kscan
    from repro_torch.kernels import matmul as kmm

    nonzero = lambda d: {r: n for r, n in d.items() if n}  # noqa: E731
    return dict(matmul=nonzero(kmm.route_launches),
                flash_attention=nonzero(kfa.route_launches),
                flash_attention_bwd=nonzero(kfa.bwd_route_launches),
                mamba_scan=nonzero({"cuda": kscan.launches}),
                mamba_scan_bwd=nonzero({"cuda": kscan.bwd_launches}))


def train_paths(cfg, params, toks, labs) -> dict:
    """Phase (b): one microbatch's loss and grads through the kernels
    (impl="auto") and through the plain path (impl="torch"), both bf16,
    each against the plain path in fp32, on ``cfg`` cut to its first
    TRAIN_PATHS_LAYERS layers (full width). Every leaf's grad from the
    kernel path must be within PATH_RATIO of the plain path's relative L2
    distance to fp32 (``compare_paths``' rule)."""
    from repro_torch.bridge import leaves, tree_map
    from repro_torch.launch.steps import value_and_grad

    cut_cfg, cut = depth_cut(cfg, params, TRAIN_PATHS_LAYERS)
    runs = {}
    for name, p, impl in (("fp32", tree_map(lambda x: x.float(), cut), "torch"),
                          ("plain", cut, "torch"), ("kernel", cut, "auto")):
        loss, grads = value_and_grad(p, cut_cfg, toks, labs, None, impl)
        runs[name] = (loss.item(), dict(leaves(grads)))
        del grads, p
        free_memory()
    ref32 = runs["fp32"][1]
    leaf_rows = {path: dict(kernel=rel_l2(runs["kernel"][1][path], g32),
                            plain=rel_l2(runs["plain"][1][path], g32))
                 for path, g32 in ref32.items()}
    losses = {n: r[0] for n, r in runs.items()}
    worst = max(leaf_rows, key=lambda p: leaf_rows[p]["kernel"]
                / max(leaf_rows[p]["plain"], 1e-30))
    print(f"train paths {cfg.name}, first {TRAIN_PATHS_LAYERS} of "
          f"{cfg.n_layers} layers, one microbatch {tuple(toks.shape)}: loss "
          f"fp32 {losses['fp32']:.6f}, plain {losses['plain']:.6f}, kernel "
          f"{losses['kernel']:.6f}; grads' relative L2 to fp32 over "
          f"{len(leaf_rows)} leaves: kernel at most "
          f"{max(r['kernel'] for r in leaf_rows.values()):.3e}, plain at most "
          f"{max(r['plain'] for r in leaf_rows.values()):.3e}; largest ratio "
          f"{worst}: kernel {leaf_rows[worst]['kernel']:.3e} against plain "
          f"{leaf_rows[worst]['plain']:.3e}", flush=True)
    for path, r in leaf_rows.items():
        if not math.isfinite(r["kernel"]) or r["kernel"] > PATH_RATIO * r["plain"]:
            raise AssertionError(f"train paths: the kernel path's grad of "
                                 f"{path} is farther from fp32 than "
                                 f"{PATH_RATIO} x the plain path's: {r}")
    del runs
    free_memory()
    return dict(losses=losses, leaves=leaf_rows)


def reduced_train_vs_cpu(name: str) -> dict:
    """Phase (c): one train step (the optimizer of the arch's
    TrainSettings: AdamW, adafactor for jamba; microbatches 1, batch 2 x
    64) of
    the reduced config of ``name`` on the card through the kernels against
    the plain path on the CPU, same params and batch; loss and grad norm
    within REDUCED_TRAIN_TOL relative. A VLM or an encoder-decoder takes
    the launcher's context with its gates at REDUCED_GATE; MoE layers
    replay the CPU's routing (``RouteTape``: the recompute replays it
    again in the same order)."""
    from repro_torch.bridge import init_params, tree_map
    from repro_torch.configs import get_reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.launch.settings import settings_for
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import OptConfig, make_optimizer

    t0 = time.perf_counter()
    cfg = get_reduced(name)
    p_cpu = init_params(cfg, seed=0, device="cpu")
    ctx = serve.context(cfg, 2, "cpu")
    if ctx is not None:
        p_cpu = with_gates(p_cpu, REDUCED_GATE)
    b = SyntheticLM(vocab=cfg.vocab, seed=0).batch(0, 0, 2, 64)
    opt_cfg = OptConfig(kind=settings_for(name).optimizer, warmup_steps=1,
                        total_steps=LAUNCHER_TRAIN_STEPS)
    opt_init = make_optimizer(opt_cfg)[0]
    step = make_train_step(cfg, opt_cfg, microbatches=1)
    out = {}
    tape = RouteTape() if cfg.n_experts else None
    with tape or contextlib.nullcontext():
        for dev in ("cpu", "cuda"):
            if tape:
                tape.play(None if dev == "cpu" else "card")
            p = tree_map(lambda x: x.to(dev), p_cpu)
            batch = {"tokens": torch.from_numpy(b["tokens"]).to(dev),
                     "labels": torch.from_numpy(b["labels"]).to(dev)}
            if ctx is not None:
                batch["ctx"] = ctx.to(dev)
            _, _, m = step(p, opt_init(p), batch)
            out[dev] = dict(loss=float(m["loss"]),
                            grad_norm=float(m["grad_norm"]))
    rel = {k: abs(out["cuda"][k] - out["cpu"][k]) / abs(out["cpu"][k])
           for k in ("loss", "grad_norm")}
    print(f"reduced train {name} ({opt_cfg.kind}), card kernels vs CPU "
          f"plain: loss "
          f"{out['cuda']['loss']:.6f} vs {out['cpu']['loss']:.6f}, grad norm "
          f"{out['cuda']['grad_norm']:.6f} vs {out['cpu']['grad_norm']:.6f} "
          f"(relative {rel['loss']:.2e}, {rel['grad_norm']:.2e}; tolerance "
          f"{REDUCED_TRAIN_TOL})", flush=True)
    if not all(math.isfinite(x) for d in out.values() for x in d.values()) \
            or max(rel.values()) > REDUCED_TRAIN_TOL:
        raise AssertionError(f"reduced train {name}: card {out['cuda']} and "
                             f"CPU {out['cpu']} differ beyond "
                             f"{REDUCED_TRAIN_TOL}")
    return dict(out, rel=rel, seconds=time.perf_counter() - t0)


def train_phase(arch: str, batch: int, served_sums: dict | None = None,
                n_layers: int | None = None) -> dict:
    """Phase (d), and (b) on its params: ``arch`` at full width (cut to
    ``n_layers`` layers if given) trained TRAIN_STEPS steps of ``batch`` x
    TRAIN_SEQ tokens through ``TrainSupervisor.run`` and
    ``make_train_step`` (its TrainSettings' microbatches, AdamW), with a
    ``CheckpointManager`` whose period exceeds the run, so that no
    many-GB state is written. With ``served_sums`` the fresh params must
    equal those its serve phase served (``param_sums``); every step's loss
    and grad norm must be finite, its launches by kernel and route exactly
    ``train_counts``; every leaf must move. One more step runs under the
    profiler: device busy, the kernels and the ops that take the most
    device time."""
    import dataclasses
    import tempfile

    from repro_torch.bridge import init_params, leaves
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.ft import TrainSupervisor
    from repro_torch.launch.settings import settings_for
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import OptConfig, make_optimizer

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    st = settings_for(arch)
    mb = st.microbatches
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device="cuda")
    sums = param_sums(params)
    if served_sums is not None and sums != served_sums:
        raise AssertionError(f"train {cfg.name}: the fresh params differ from "
                             f"the ones its serve phase served")
    data = SyntheticLM(vocab=cfg.vocab, seed=0)

    def batch_of(step):
        b = data.batch(step, 0, batch, TRAIN_SEQ)
        return {k: torch.from_numpy(b[k]).to("cuda")
                for k in ("tokens", "labels")}

    first = batch_of(0)
    paths = train_paths(cfg, params, first["tokens"][:batch // mb],
                        first["labels"][:batch // mb])
    opt_cfg = OptConfig(kind=st.optimizer, lr=3e-4,
                        warmup_steps=max(TRAIN_STEPS // 10, 1),
                        total_steps=TRAIN_STEPS)
    opt_init, _ = make_optimizer(opt_cfg)
    step = make_train_step(cfg, opt_cfg, microbatches=mb)
    state = {"params": params, "opt": opt_init(params)}
    n_params = sum(x.numel() for _, x in leaves(params))
    del params
    want = train_counts(cfg, mb)
    log = []

    def step_fn(i, st_):
        b = batch_of(i)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = step(st_["params"], st_["opt"], b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        row = dict(step=i, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   wall_s=wall, tok_s=batch * TRAIN_SEQ / wall,
                   launches=counts)
        log.append(row)
        print(f"train {cfg.name} step {i}: loss {row['loss']:.6f} grad norm "
              f"{row['grad_norm']:.6f} wall {wall:.3f} s ({row['tok_s']:.0f} "
              f"tok/s); launches {counts}", flush=True)
        if not (math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"])):
            raise AssertionError(f"train {cfg.name} step {i}: non-finite "
                                 f"loss or grad norm: {row}")
        if counts != want:
            raise AssertionError(f"train {cfg.name} step {i}: launches "
                                 f"{counts}, expected {want}")
        return {"params": p, "opt": o}

    with tempfile.TemporaryDirectory() as tmp:
        sup = TrainSupervisor(CheckpointManager(tmp, keep=2,
                                                every=TRAIN_STEPS + 1))
        final, state = sup.run(state, step_fn, steps=TRAIN_STEPS)
        if final != TRAIN_STEPS or sup.restarts or os.listdir(tmp):
            raise AssertionError(f"train {cfg.name}: supervisor ended at "
                                 f"{final} after {sup.restarts} restarts, "
                                 f"checkpoints {os.listdir(tmp)}")
    peak = torch.cuda.max_memory_allocated()
    now = param_sums(state["params"])
    still = [(p, i) for p in now for i, (a, b) in
             enumerate(zip(now[p], sums[p])) if a == b]
    if still:
        raise AssertionError(f"train {cfg.name}: params did not move (leaf, "
                             f"period slice): {still[:16]}")
    b = batch_of(TRAIN_STEPS)
    busy, wall_p, top, ops = profile_device(
        lambda: step(state["params"], state["opt"], b), ops=True)
    steady = statistics.median(r["wall_s"] for r in log[1:])
    flops = 6.0 * n_params * batch * TRAIN_SEQ
    print(f"train {cfg.name}: {TRAIN_STEPS} steps of {batch}x{TRAIN_SEQ} "
          f"tokens ({mb} microbatches, {cfg.n_layers} layers): step walls "
          + ", ".join(f"{r['wall_s']:.3f}" for r in log)
          + f" s; steady {steady:.3f} s, {batch * TRAIN_SEQ / steady:.0f} "
          f"tok/s, {flops / steady / 1e12:.1f} TFLOP/s of 6 N D; peak memory "
          f"{peak / 1e9:.3f} GB", flush=True)
    print(f"profile {cfg.name} train step: device busy {busy:.2f} ms of "
          f"{steady * 1e3:.2f} ms unprofiled ({wall_p:.2f} ms profiled): "
          f"idle share {1 - busy / (steady * 1e3):.3f}", flush=True)
    for name, ms, n in top:
        print(f"    {ms:9.3f} ms  {n:5d}x  {name}", flush=True)
    print("  by op (the op's own kernels' device time):", flush=True)
    for name, ms, n in ops:
        print(f"    {ms:9.3f} ms  {n:5d}x  {name}", flush=True)
    del state
    free_memory()
    return dict(arch=cfg.name, n_layers=cfg.n_layers, microbatches=mb,
                batch=batch, seq=TRAIN_SEQ, steps=log, steady_wall_s=steady,
                tok_s=batch * TRAIN_SEQ / steady, flops_6nd=flops,
                n_params=n_params, peak_memory_bytes=peak,
                profile=dict(busy_ms=busy, profiled_wall_ms=wall_p, top=top,
                             ops=ops, idle_share=1 - busy / (steady * 1e3)),
                launches_per_step=want, paths=paths)


def mamba_train_phase() -> dict:
    """Phase (d'): falcon-mamba-7b at full width cut to MAMBA_TRAIN_LAYERS
    layers, through ``train_phase`` (and (b') on its first
    TRAIN_PATHS_LAYERS layers); its peak memory must stay under
    MAMBA_PEAK_GB."""
    run = train_phase(MAMBA_ARCH, MAMBA_TRAIN_BATCH,
                      n_layers=MAMBA_TRAIN_LAYERS)
    if run["peak_memory_bytes"] > MAMBA_PEAK_GB * 1e9:
        raise AssertionError(f"train {MAMBA_ARCH} at {MAMBA_TRAIN_LAYERS} "
                             f"layers: peak "
                             f"{run['peak_memory_bytes'] / 1e9:.3f} GB over "
                             f"{MAMBA_PEAK_GB} GB")
    return run


def launcher_train_phase() -> dict:
    """Phase (e): ``python -m repro_torch.launch.train --arch granite-3-2b
    --reduced --steps 4`` into a temporary ``--ckpt``, then again: the
    second run must resume from step 4 and end with the first run's state
    (the launcher's ``state sha256`` line). Then ``--arch
    jamba-1.5-large-398b --reduced --steps 4`` once, on CUDA: Mamba layers
    through the scan's kernels, attention, MoE, and adafactor."""
    import tempfile

    outs = []
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(2):
            env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                 TRAIN_ARCH, "--reduced", "--steps", str(LAUNCHER_TRAIN_STEPS),
                 "--ckpt", os.path.join(tmp, "ckpt")],
                capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
            print(r.stdout, end="", flush=True)
            if r.returncode:
                raise AssertionError(f"train launcher exited {r.returncode}:\n"
                                     f"{r.stderr[-4000:]}")
            outs.append(r.stdout)
    digests = [next(ln.split()[-1] for ln in o.splitlines()
                    if ln.startswith("state sha256")) for o in outs]
    resumed = f"resumed from step {LAUNCHER_TRAIN_STEPS}"
    if resumed in outs[0] or resumed not in outs[1]:
        raise AssertionError(f"train launcher: the first run must start "
                             f"fresh and the second print {resumed!r}")
    if digests[0] != digests[1]:
        raise AssertionError(f"train launcher: the resumed run's state "
                             f"differs from the first run's: {digests}")
    print(f"train launcher: second run {resumed}, state bit-equal "
          f"(sha256 {digests[0][:16]})", flush=True)
    with tempfile.TemporaryDirectory() as tmp:   # the hybrid arch, on CUDA
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             JAMBA_ARCH, "--reduced", "--steps", str(LAUNCHER_TRAIN_STEPS),
             "--ckpt", os.path.join(tmp, "ckpt")],
            capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    print(r.stdout, end="", flush=True)
    done = f"done: {LAUNCHER_TRAIN_STEPS} steps"
    if r.returncode or f"arch={JAMBA_ARCH}" not in r.stdout \
            or "device=cuda" not in r.stdout or done not in r.stdout:
        raise AssertionError(f"train launcher --arch {JAMBA_ARCH} exited "
                             f"{r.returncode} without {done!r} on cuda:\n"
                             f"{r.stderr[-4000:]}")
    return dict(digest=digests[0], out=outs, jamba_out=r.stdout)


def train_phases(served_sums: dict) -> dict:
    """The train phases (a) to (e), in the order (a), (c), (d) with (b),
    (e); returns their rows."""
    from repro_torch.configs import get_config
    from repro_torch.launch.settings import settings_for

    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        free_memory()
        seconds[name] = time.perf_counter() - t
        return out

    mb = settings_for(TRAIN_ARCH).microbatches
    bwd = timed("a", flash_bwd_phase)
    scan_bwd = timed("a'", scan_bwd_phase)
    reduced = timed("c", lambda: {n: reduced_train_vs_cpu(n)
                                  for n in TRAIN_REDUCED})
    mm = timed("matmul", train_matmul_phase, get_config(TRAIN_ARCH),
               TRAIN_BATCH // mb * TRAIN_SEQ)
    run = timed("b+d", train_phase, TRAIN_ARCH, TRAIN_BATCH, served_sums)
    mamba = timed("b'+d'", mamba_train_phase)
    launcher = timed("e", launcher_train_phase)
    print(f"train phases done in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"({k}) {v:.1f} s" for k, v in seconds.items()),
          flush=True)
    return dict(flash_bwd=bwd, scan_bwd=scan_bwd, reduced=reduced, matmul=mm,
                run=run, mamba=mamba, launcher=launcher, seconds=seconds)


# ------------------------------- mixtral-8x7b streamed at full depth

def unstacked(cfg, n_layers: int):
    """``cfg`` at ``n_layers`` with every layer its own ``remainder/r<i>``
    subtree: layer and FFN patterns one longer than the depth, as
    ``examples/serve_streaming.py`` makes its streaming unit."""
    import dataclasses

    kinds = [(cfg.layer_pattern[j % len(cfg.layer_pattern)],
              cfg.ffn_pattern[j % len(cfg.ffn_pattern)])
             for j in range(n_layers + 1)]
    return dataclasses.replace(cfg, n_layers=n_layers,
                               layer_pattern=tuple(m for m, _ in kinds),
                               ffn_pattern=tuple(f for _, f in kinds))


def stream_layer_paths(cfg) -> list[list[str]]:
    """``run_layer_stream``'s groups for an unstacked decoder ``cfg``: the
    embed, each layer's leaves, then the final norm with the head (the
    embed again when it is tied)."""
    from repro_torch.bridge import leaves, param_shapes

    flat = [p for p, _ in leaves(param_shapes(cfg))]
    head = "embed" if cfg.tie_embeddings else "lm_head"
    return ([["embed"]]
            + [sorted(p for p in flat if p.startswith(f"remainder/r{i}/"))
               for i in range(cfg.n_layers)]
            + [["final_norm", head]])


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def host_blocks(sizes: list[int], cap: int = STREAM_BLOCK
                ) -> tuple[list[int], list[tuple[int, int]]]:
    """Leaves of ``sizes`` bytes packed into host blocks of at most ``cap``
    bytes, largest leaf first into the first block with room, 512-byte
    aligned: (block sizes, (block, offset) of each leaf). Every block is a
    power of two, the size torch's pinned allocator rounds a request up
    to, so none is padded (mixtral-8x7b's 0.94 GB expert leaves, 9 to an
    8 GiB block, leave its small leaves the rest)."""
    bins, where, left = [], [None] * len(sizes), sum(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: -sizes[i]):
        n = sizes[i]
        for b, (used, size) in enumerate(bins):
            off = -(-used // 512) * 512
            if off + n <= size:
                break
        else:
            bins.append([0, max(min(cap, _pow2(left)), _pow2(n))])
            b, off = len(bins) - 1, 0
        where[i] = (b, off)
        bins[b][0] = off + n
        left -= n
    return [min(size, _pow2(used)) for used, size in bins], where


def leaf_sums(x) -> list[int]:
    """A leaf's bits summed as integers, one slice of its first axis at a
    time when it has more than two (a whole stacked leaf widened to int64
    would not fit)."""
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return [int(t.view(ints[x.dtype]).sum(dtype=torch.int64))
            for t in (x if x.dim() > 2 else (x,))]


def host_params(cfg, device, pin: bool):
    """``bridge.init_params(cfg, seed=0, device=device)``, bit for bit,
    in host memory: each leaf drawn on ``device`` alone, its sums taken
    there, then copied into its place in ``host_blocks`` (page-locked
    when ``pin``) and freed, so that one leaf at a time is on the card.
    Returns (the tree of host views, the blocks, the sums as drawn)."""
    from repro_torch.bridge import _init_leaves, leaves, param_shapes, unflatten

    shapes = [(s, dt) for _, (s, dt) in leaves(param_shapes(cfg))]
    sizes = [math.prod(s) * dt.itemsize for s, dt in shapes]
    bsizes, where = host_blocks(sizes)
    blocks = [torch.empty(n, dtype=torch.uint8, pin_memory=pin)
              for n in bsizes]
    flat, sums = {}, {}
    for (path, x), (b, off), n in zip(_init_leaves(cfg, 0, device), where,
                                      sizes):
        sums[path] = leaf_sums(x)
        h = blocks[b][off:off + n].view(x.dtype).view(x.shape)
        h.copy_(x)
        flat[path] = h
        del x
    return unflatten(flat), blocks, sums


def host_sums(host, device) -> dict:
    """``leaf_sums`` of every host leaf, each copied to ``device`` alone."""
    from repro_torch.bridge import leaves

    return {p: leaf_sums(x.to(device, non_blocking=True))
            for p, x in leaves(host)}


def stream_flops(cfg, B: int, S: int) -> dict:
    """Each group's flops for ``run_layer_stream``, in prefill (B x S
    tokens) and in a decode token (B): 2·M·K·N of every product the
    matmul kernel runs (``projections``, over the layers, which are all
    alike; a MoE layer's experts over their capacity rows, the head on the
    last position only) and in prefill the flash kernel's 4·D of every
    visible (query, key) pair of a head; the embed, a gather, none."""
    from repro_torch.models.moe import capacity

    hd = cfg.resolved_head_dim
    out = {}
    for phase, T, Sq in (("prefill", B * S, S), ("decode", B, 0)):
        layer = 0.0
        for tag, K, N, calls in projections(cfg):
            M = capacity(cfg, T) if tag in EXPERT_TAGS else T
            layer += 2.0 * M * K * N * calls / cfg.n_layers
        w = cfg.sliding_window or Sq
        pairs = sum(min(q + 1, w) for q in range(Sq))
        layer += 4.0 * hd * pairs * B * cfg.n_heads
        head = 2.0 * B * cfg.d_model * cfg.padded_vocab
        out[phase] = [0.0] + [layer] * cfg.n_layers + [head]
    return out


class LayerStream:
    """``apply_layer`` of ``run_layer_stream`` serving an unstacked decoder
    ``cfg`` on the leaves it is handed: group 0 embeds, group i runs layer
    ``r<i-1>`` through ``models.transformer._apply_layer``, the last group
    the final norm and the head and picks the greedy token. The first
    pass prefills ``tokens`` as ``launch/steps.make_prefill_step`` does
    (decode buffers ``prompt_len`` wide, the head on the last position),
    each later pass decodes the last pick as ``decode_step`` does. Each
    pass appends its logits and tokens; a group returns ``stream_flops``'
    flops."""

    def __init__(self, cfg, tokens):
        if cfg.is_vlm or cfg.is_encdec or cfg.n_periods:
            raise ValueError(f"{cfg.name}: not an unstacked decoder")
        self.cfg, self.tokens = cfg, tokens
        self.kinds = cfg.layer_kinds()
        self.flops = stream_flops(cfg, *tokens.shape)
        self.caches = [None] * cfg.n_layers
        self.t = None
        self.logits, self.out = [], []

    def __call__(self, i: int, tensors: dict) -> float:
        from repro_torch.bridge import unflatten
        from repro_torch.models.config import MAMBA
        from repro_torch.models.layers import embed_apply, rms_norm
        from repro_torch.models.transformer import (_apply_layer,
                                                    _buffer_width,
                                                    _kv_to_buffer, _lm_head)
        cfg, prefill = self.cfg, self.t is None
        B, S = self.tokens.shape
        if i == 0:
            ids = self.tokens if prefill else self.out[-1]
            self.x = embed_apply(tensors["embed"], ids, cfg.embed_scale,
                                 cfg.d_model)
            self.positions = (torch.arange(S, dtype=torch.int32,
                                           device=self.x.device)[None, :]
                              if prefill else self.t[:, None])
        elif i <= cfg.n_layers:
            mixer, ffn = self.kinds[i - 1]
            lp = unflatten({p.split("/", 2)[2]: t for p, t in tensors.items()})
            self.x, state, _ = _apply_layer(
                lp, cfg, self.x, mixer, ffn, positions=self.positions,
                ctx=None, cache=self.caches[i - 1], impl="auto")
            if prefill:
                self.caches[i - 1] = state if mixer == MAMBA else \
                    _kv_to_buffer(state, _buffer_width(cfg, mixer, S))
        else:
            x = rms_norm(self.x, tensors["final_norm"], cfg.norm_eps)
            logits = _lm_head(tensors, cfg, x[:, -1:], "auto")
            self.logits.append(logits)
            self.out.append(logits[:, -1].argmax(dim=-1).int()[:, None])
            self.t = (torch.full((B,), S, dtype=torch.int32, device=x.device)
                      if prefill else self.t + 1)
            del self.x
        return self.flops["prefill" if prefill else "decode"][i]


def stream_run(cfg, host, tokens, decode: int, budget: int, kw: dict,
               device, counts=None) -> dict:
    """Serve ``cfg`` streamed from the ``host`` leaves through a
    ``StreamingExecutor`` with a pool of ``budget`` bytes and ``kw``: one
    ``run_layer_stream`` pass that prefills, then ``decode`` passes that
    decode. Checks after every group that the managed leaves in the pool
    keep to the budget, and that the executor took the host leaves as
    they are. Counts the bytes copied host to device: the leaves handed
    to a group from outside the pool, and the pool's copies after each
    pass. ``counts()``, when given, is read after the prefill and after
    the decode."""
    import weakref

    from repro_torch.bridge import leaves
    from repro_torch.launch.serve import _Timer
    from repro_torch.svm import StreamingExecutor, run_layer_stream

    paths = stream_layer_paths(cfg)
    sizes = {p: x.numel() * x.element_size() for p, x in leaves(host)}
    ex = StreamingExecutor(host, budget, device=device, **kw)
    moved = [p for (p, a), (_, b) in zip(leaves(ex.host_params), leaves(host))
             if a.data_ptr() != b.data_ptr()]
    if moved:
        raise AssertionError(f"stream {cfg.name}: the executor copied "
                             f"{len(moved)} host leaves, e.g. {moved[:3]}")
    served = LayerStream(cfg, tokens)
    flops, h2d, pool_max, seen = [], [0], [0], [{}]

    def pool_copies() -> int:   # the pool's tensors made since ``seen``
        old = seen[0]
        return sum(sizes[p] for p, t in ex.pool().items()
                   if p not in old or old[p]() is not t)

    def mark(pool) -> None:
        seen[0] = {p: weakref.ref(t) for p, t in pool.items()}

    def apply(i, tensors):
        if i == 0:
            h2d[0] += pool_copies()
            flops.append([])
        pool = ex.pool()
        h2d[0] += sum(sizes[p] for p, t in tensors.items()
                      if pool.get(p) is not t)
        pool_max[0] = max(pool_max[0], ex.pool_bytes())
        if pool_max[0] > budget:
            raise AssertionError(f"stream {cfg.name}: {pool_max[0]} bytes "
                                 f"of managed leaves in the pool at group "
                                 f"{i}, over the budget of {budget}")
        flops[-1].append(served(i, tensors))
        if i == len(paths) - 1:
            mark(pool)
        return flops[-1][-1]

    clock, out = _Timer(torch.device(device)), {}
    for phase, steps in (("prefill", 1), ("decode", decode)):
        h2d[0] = 0
        clock.start()
        m = run_layer_stream(ex, paths, apply, steps=steps)
        h2d[0] += pool_copies()
        mark(ex.pool())
        out[phase] = dict(ms=clock.stop(), h2d_bytes=h2d[0],
                          wall_s=m["wall_s"], migrations=m["migrations"],
                          evictions=m["evictions"],
                          counts=None if counts is None else counts())
    out["decode"]["ms_per_token"] = out["decode"]["ms"] / decode
    for k in ("wall_s", "migrations", "evictions"):
        out["decode"][k] -= out["prefill"][k]
    metrics = ex.metrics()
    replay = StreamingExecutor(host, budget, device=device, **kw)
    for f in flops:
        replay.decode_step(paths, f, materialize=False)
    if replay.metrics() != metrics:
        raise AssertionError(f"stream {cfg.name} {kw}: metrics() differs "
                             f"from a materialize=False replay of the same "
                             f"layer paths and flops")
    del ex, replay
    return dict(out, metrics=metrics, flops=flops, max_pool_bytes=pool_max[0],
                budget=budget, logits=served.logits, tokens=served.out)


def resident_run(cfg, params, tokens, decode: int):
    """The port's own serving path on resident params: ``make_prefill_step``,
    then ``decode`` greedy ``decode_step`` calls -> (logits, tokens) of
    each pass."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import decode_step

    logits, cache = make_prefill_step(cfg)(params, tokens)
    all_logits = [logits]
    out = [logits[:, -1].argmax(dim=-1).int()[:, None]]
    for _ in range(decode):
        logits, cache = decode_step(params, cfg, out[-1], cache)
        all_logits.append(logits)
        out.append(logits[:, -1].argmax(dim=-1).int()[:, None])
    return all_logits, out


def same_bits(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def first_layers(host, n: int) -> dict:
    """The embed, final norm and head of an unstacked ``host`` tree with
    its first ``n`` layers: the same tensors, no copy."""
    return dict(host, remainder={f"r{i}": host["remainder"][f"r{i}"]
                                 for i in range(n)})


def mem_available() -> int:
    with open("/proc/meminfo") as f:
        info = dict(line.split(":", 1) for line in f)
    return int(info["MemAvailable"].split()[0]) * 1024


def stream_depth(full, avail: int) -> int:
    """The most layers of ``full`` whose pinned host blocks fit beside
    STREAM_HOST_RESERVE in ``avail`` bytes of host memory."""
    from repro_torch.bridge import leaves, param_shapes

    for n in range(full.n_layers, 0, -1):
        sizes = [math.prod(s) * dt.itemsize for _, (s, dt) in
                 leaves(param_shapes(unstacked(full, n)))]
        if sum(host_blocks(sizes)[0]) + STREAM_HOST_RESERVE <= avail:
            return n
    return 0


def check_stream_routes(cfg, pre: dict, total: dict) -> None:
    """The streamed prefill and decode took the routes ``check_routes``
    asks of a resident one; no attention call of a decode token reaches
    the flash kernel (decode attention is plain PyTorch)."""
    mm = {r: n - pre["matmul"].get(r, 0) for r, n in total["matmul"].items()}
    fa = {r: n - pre["flash_attention"].get(r, 0)
          for r, n in total["flash_attention"].items()}
    check_routes(cfg, pre["matmul"], {r: n for r, n in mm.items() if n},
                 pre["flash_attention"], tokens=STREAM_DECODE)
    if any(fa.values()):
        raise AssertionError(f"stream {cfg.name}: flash launches in decode "
                             f"{fa}")


def stream_phase(card: str) -> dict:
    """mixtral-8x7b at full depth, streamed layer by layer through the SVM
    executor from pinned host memory (see the module docstring)."""
    from repro_torch.bridge import leaves, tree_map
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    full = get_config(STREAM_ARCH)
    free_memory()
    if hasattr(torch._C, "_host_emptyCache"):   # earlier phases' pinned blocks
        torch._C._host_emptyCache()
    print("stream host memory (free -g):\n" + subprocess.run(
        ["free", "-g"], capture_output=True, text=True).stdout.rstrip(),
        flush=True)
    avail = mem_available()
    n = stream_depth(full, avail)
    if n < STREAM_CHECK_LAYERS:
        raise AssertionError(f"stream {full.name}: {avail / 1e9:.1f} GB of "
                             f"host memory hold {n} layers pinned")
    cfg = unstacked(full, n)
    if n < full.n_layers:
        print(f"stream {full.name}: DEPTH CUT by the host: {n} of "
              f"{full.n_layers} layers fit pinned in {avail / 1e9:.2f} GB "
              f"available beside {STREAM_HOST_RESERVE / 1e9:.0f} GB",
              flush=True)
    toks = serve.prompts(cfg, BATCH, PROMPT, "cuda")
    t0 = time.perf_counter()
    with torch.inference_mode():
        host, blocks, sums = host_params(cfg, "cuda", pin=True)
    torch.cuda.synchronize()
    pin_s = time.perf_counter() - t0
    flat = dict(leaves(host))
    total = sum(x.numel() * x.element_size() for x in flat.values())
    if not all(x.is_pinned() for x in flat.values()):
        raise AssertionError(f"stream {cfg.name}: a host leaf is not pinned")
    budget = int(total * SVM_FRAC)
    print(f"stream {cfg.name}: {n} of {full.n_layers} layers unstacked, "
          f"{total / 1e9:.3f} GB of bf16 weights made on the card leaf by "
          f"leaf into {len(blocks)} pinned host blocks "
          f"({sum(b.numel() for b in blocks) / 1e9:.3f} GB) in {pin_s:.1f} "
          f"s; {mem_available() / 1e9:.2f} GB of host memory left; pool "
          f"{budget / 1e9:.3f} GB ({SVM_FRAC} of the weights), H100 preset; "
          f"batch {BATCH}, prompts {PROMPT}, {STREAM_DECODE} decode tokens",
          flush=True)
    runs = {}
    with torch.inference_mode():
        for name, kw in STREAM_POLICIES.items():
            free_memory()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            r = stream_run(cfg, host, toks, STREAM_DECODE, budget, kw,
                           "cuda", counts=_read_counts)
            peak = torch.cuda.max_memory_allocated()
            pre, dec = r["prefill"], r["decode"]
            check_stream_routes(cfg, pre["counts"], dec["counts"])
            if peak >= STREAM_PEAK_GB * 1e9:
                raise AssertionError(f"stream {cfg.name} {name}: peak "
                                     f"{peak / 1e9:.2f} GB")
            r["peak_memory_bytes"] = peak
            seq = torch.cat(r["tokens"], dim=1)
            if not torch.isfinite(torch.cat(r["logits"]).float()).all() or \
                    int(seq.min()) < 0 or int(seq.max()) >= cfg.vocab:
                raise AssertionError(f"stream {cfg.name} {name}: non-finite "
                                     f"logits or tokens out of the vocab")
            sim_pre, sim_dec = pre["wall_s"] * 1e3, \
                dec["wall_s"] * 1e3 / STREAM_DECODE
            print(f"stream {cfg.name} {name} ({card}): prefill "
                  f"{BATCH}x{PROMPT} {pre['ms']:.1f} ms real, "
                  f"{sim_pre:.1f} ms simulated ({pre['ms'] / sim_pre:.3f}x), "
                  f"{pre['h2d_bytes'] / 1e9:.3f} GB host to device, "
                  f"{pre['migrations']} migrations / {pre['evictions']} "
                  f"evictions; decode {dec['ms_per_token']:.1f} ms a token "
                  f"real, {sim_dec:.1f} ms simulated "
                  f"({dec['ms_per_token'] / sim_dec:.3f}x), "
                  f"{dec['h2d_bytes'] / STREAM_DECODE / 1e9:.3f} GB host to "
                  f"device a token, {dec['migrations']} migrations / "
                  f"{dec['evictions']} evictions over {STREAM_DECODE} "
                  f"tokens; pool at most {r['max_pool_bytes'] / 1e9:.3f} of "
                  f"{budget / 1e9:.3f} GB; card peak {peak / 1e9:.2f} GB; "
                  f"launches prefill {pre['counts']}, prefill + decode "
                  f"{dec['counts']}; metrics() == the materialize=False "
                  f"replay", flush=True)
            print(f"stream {cfg.name} {name}: continuation {seq[0].tolist()}",
                  flush=True)
            runs[name] = r
        a, b = runs.values()
        if not (same_bits(a["logits"], b["logits"])
                and same_bits(a["tokens"], b["tokens"])):
            raise AssertionError(f"stream {cfg.name}: the policies' logits "
                                 f"or tokens differ")
        print(f"stream {cfg.name}: {' and '.join(runs)} bit-equal in every "
              f"pass's logits and tokens", flush=True)

        # the first layers of the same host tree, streamed and resident
        free_memory()
        cut = unstacked(full, STREAM_CHECK_LAYERS)
        host_cut = first_layers(host, STREAM_CHECK_LAYERS)
        cut_bytes = sum(x.numel() * x.element_size()
                        for _, x in leaves(host_cut))
        s = stream_run(cut, host_cut, toks, STREAM_DECODE,
                       int(cut_bytes * SVM_FRAC), {}, "cuda")
        check_ms = s["decode"]["ms_per_token"]
        resident = tree_map(lambda x: x.to("cuda"), host_cut)
        clock = serve._Timer(torch.device("cuda"))
        clock.start()
        logits, out = resident_run(cut, resident, toks, STREAM_DECODE)
        res_ms = clock.stop()
        del resident
        if not (same_bits(s["logits"], logits) and
                same_bits(s["tokens"], out)):
            raise AssertionError(f"stream {cut.name}: {STREAM_CHECK_LAYERS} "
                                 f"layers streamed and resident differ")
        print(f"stream {cut.name}: its first {STREAM_CHECK_LAYERS} layers "
              f"({cut_bytes / 1e9:.3f} GB) streamed (prefill "
              f"{s['prefill']['ms']:.1f} ms, decode "
              f"{s['decode']['ms_per_token']:.1f} ms a token) and resident "
              f"(prefill + {STREAM_DECODE} tokens {res_ms:.1f} ms): logits "
              f"and tokens bit-equal", flush=True)
        del s, logits, out
        free_memory()
        after = host_sums(host, "cuda")
    if after != sums:
        raise AssertionError(f"stream {cfg.name}: the host params changed")
    del host, flat, blocks
    free_memory()
    t0 = time.perf_counter()
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()
    free_s = time.perf_counter() - t0
    # the host takes the freed pages back gradually, while the next
    # phases run
    print(f"stream {cfg.name}: host params unchanged; pinned blocks freed "
          f"in {free_s:.1f} s, {mem_available() / 1e9:.2f} GB of host memory "
          f"available; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    keep = ("prefill", "decode", "max_pool_bytes", "budget",
            "peak_memory_bytes")
    return dict(arch=full.name, n_layers=n, of=full.n_layers,
                weight_bytes=total, pin_host_s=pin_s, free_host_s=free_s,
                host_available_bytes=avail, decode_tokens=STREAM_DECODE,
                check_decode_ms_per_token=check_ms,
                policies={k: {f: r[f] for f in keep}
                          for k, r in runs.items()},
                seconds=time.perf_counter() - t_phase)


# --------------------------------------------------------- the examples

def run_example(name: str, argv: list[str]) -> tuple[list[str], float]:
    """``examples/torch/<name>.py``'s ``main(argv)`` in this process ->
    (its stdout lines, seconds)."""
    import importlib.util
    import io

    path = os.path.join(ROOT, "examples", "torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        mod.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return buf.getvalue().splitlines(), time.perf_counter() - t0


def example_losses(lines: list[str]) -> list[float]:
    """Every loss an example prints, in order: ``loss=x`` of a step line
    and ``loss x -> y`` of a run's last line."""
    return [float(v) for ln in lines for m in
            re.finditer(r"loss(?:=| )(\S+)(?: -> (\S+))?", ln)
            for v in m.groups() if v is not None]


def examples_phase() -> dict:
    """Each of the port's examples once on the card, at its own size
    (``train_oversubscribed`` for EXAMPLE_TRAIN_STEPS steps), then on the
    CPU with the same arguments. The two that train draw their params on
    the host, so both runs start from the same bits: every loss they print
    is within EXAMPLE_LOSS_TOL of the CPU's, quickstart's decoded ids are
    the CPU's, and they launch the matmul and flash kernels. The SVM
    lines (``serve_streaming``'s and ``serve_multitenant``'s whole output,
    ``train_oversubscribed``'s offload schedule) are the simulated
    clock's, which no device changes: their ``==`` holds the accounting,
    and the card's peak memory only shows that the serving examples put
    their params and pools there."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in EXAMPLES:
            argv = (["--steps", str(EXAMPLE_TRAIN_STEPS)]
                    if name == "train_oversubscribed" else [])
            runs = {}
            for dev in ("cuda", "cpu"):
                ckpt = (["--ckpt", os.path.join(tmp, dev)]
                        if name == "train_oversubscribed" else [])
                free_memory()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                _reset_counts()
                lines, secs = run_example(name, argv + ckpt
                                          + ["--device", dev])
                runs[dev] = dict(lines=lines, s=secs, counts=_read_counts(),
                                 peak=torch.cuda.max_memory_allocated()
                                 - before)
            card, cpu = runs["cuda"]["lines"], runs["cpu"]["lines"]
            counts, peak = runs["cuda"]["counts"], runs["cuda"]["peak"]
            if any(n for c in runs["cpu"]["counts"].values()
                   for n in c.values()):
                raise AssertionError(f"example {name}: the CPU run "
                                     f"launched {runs['cpu']['counts']}")
            if peak <= 0:
                raise AssertionError(f"example {name}: nothing on the card")
            if name in ("quickstart", "train_oversubscribed"):
                lc, lh = example_losses(card), example_losses(cpu)
                rel = [abs(a - b) / abs(b) for a, b in zip(lc, lh)]
                if not (lc and len(lc) == len(lh)
                        and all(map(math.isfinite, lc))
                        and max(rel) <= EXAMPLE_LOSS_TOL):
                    raise AssertionError(f"example {name}: losses {lc} on "
                                         f"the card, {lh} on the CPU")
                if not (counts["matmul"] and counts["flash_attention"]):
                    raise AssertionError(f"example {name}: launches {counts}")
                what = (f"losses {lc} (CPU {lh}: relative difference at "
                        f"most {max(rel):.2e}, within {EXAMPLE_LOSS_TOL})")
            if name == "quickstart":
                if card[-1] != cpu[-1]:
                    raise AssertionError(f"example quickstart: {card[-1]} "
                                         f"on the card, {cpu[-1]} on the CPU")
                svm = []
                what += f"; {card[-1]}, the CPU's"
            elif name == "train_oversubscribed":
                svm = [ln for ln in card if ln.startswith("offload schedule")]
                if len(svm) != 1 or svm != [ln for ln in cpu if
                                            ln.startswith("offload schedule")]:
                    raise AssertionError(f"example {name}: {svm} on the card")
                what += f"; {svm[0]}, equal to the CPU's"
            else:
                svm = card
                if card != cpu:
                    raise AssertionError(f"example {name}: the card's lines "
                                         f"{card} differ from the CPU's {cpu}")
                what = (f"its {len(card)} lines (simulated clock) equal the "
                        f"CPU's")
            print(f"example {name} ({' '.join(argv) or 'default'}): "
                  f"{runs['cuda']['s']:.1f} s on the card ({runs['cpu']['s']:.1f}"
                  f" s on the CPU); {what}; card peak {peak / 1e9:.3f} GB; "
                  f"launches {counts}", flush=True)
            out[name] = dict(card_s=runs["cuda"]["s"], cpu_s=runs["cpu"]["s"],
                             svm_lines=svm, launches=counts, peak_bytes=peak,
                             last=card[-1])
    return out


def profile_device(fn, ops: bool = False):
    """(device-busy ms, profiled wall ms, top kernels) of one run of ``fn``
    under torch.profiler: the sum of the device time of every kernel; with
    ``ops`` also the top 16 ops by the device time of the kernels each op
    launches itself (``self_device_time_total``: aten::mul, aten::add,
    aten::copy_, ... name the elementwise passes that kernel names hide)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kern:
        raise AssertionError("the profiler saw no device activity")
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    top = [(e.key[:70], e.self_device_time_total / 1e3, e.count) for e in top]
    if not ops:
        return busy, wall, top
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU
            and e.self_device_time_total > 0]
    by_op = sorted(host, key=lambda e: -e.self_device_time_total)[:16]
    return busy, wall, top, [(e.key[:70], e.self_device_time_total / 1e3,
                              e.count) for e in by_op]


def summarize(name, weighted, launches, source, replaces):
    """One kernel line: sums over the main path's calls of each shape."""
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches,
        max_abs_err=max(r["max_abs_err"] for r, _ in weighted),
        ms=sum(r["ms"] * n for r, n in weighted),
        plain_ms=sum(r["plain_ms"] * n for r, n in weighted),
        bound_ms=sum(r["bound_ms"] * n for r, n in weighted),
        bound_by=max(((r["bound_ms"] * n, r["bound_by"]) for r, n in weighted))[1],
        library_ms=None if any(r["library_ms"] is None for r, _ in weighted)
        else sum(r["library_ms"] * n for r, n in weighted))


def cut_seconds(jamba: dict, new: dict, trained: dict, streamed: dict,
                meshed: dict) -> dict:
    """What jamba-1.5-large-398b's serving and the mesh phase added to the
    run, and what the cuts that pay for them saved, from this run's own
    measurements: the
    streamed decode's tokens beyond STREAM_DECODE, up to the 8 it took
    before, at each policy's and the layer check's measured ms a token;
    the plain versions' warm-ups and replays beyond one each
    (PLAIN_TIMING, a lower bound); the launcher's steps beyond
    LAUNCHER_TRAIN_STEPS, up to 8, at its runs' measured mean step (an
    estimate: the first step carries the run's set-up)."""
    tokens = 8 - STREAM_DECODE
    stream_s = tokens * (sum(p["decode"]["ms_per_token"] for p in
                             streamed["policies"].values())
                         + streamed["check_decode_ms_per_token"]) / 1e3
    walls = [float(re.search(r"done: \d+ steps in ([\d.]+)s", o).group(1))
             for o in (trained["launcher"]["out"][0],
                       trained["launcher"]["jamba_out"])]
    launcher_s = (8 - LAUNCHER_TRAIN_STEPS) / LAUNCHER_TRAIN_STEPS * sum(walls)
    out = dict(added=dict(jamba_phase_s=jamba["seconds"],
                          mixtral_shapes_s=new["matmul_mixtral_seconds"],
                          jamba_reduced_step_s=trained["reduced"][JAMBA_ARCH][
                              "seconds"]),
               saved=dict(stream_decode_s=stream_s,
                          plain_once_at_least_s=PLAIN_TIMING["saved_s"],
                          launcher_steps_est_s=launcher_s),
               plain_timing=dict(PLAIN_TIMING),
               mesh_phase_s=meshed["seconds"],
               dryrun_check_s=meshed["dryrun"]["seconds"])
    added, saved = sum(out["added"].values()), sum(out["saved"].values())
    print(f"cut: jamba's serving added {added:.1f} s (its phase "
          f"{jamba['seconds']:.1f}, mixtral-8x7b's 32 layers' shapes "
          f"{new['matmul_mixtral_seconds']:.1f}, its reduced train step "
          f"{out['added']['jamba_reduced_step_s']:.1f}); the cuts saved "
          f"{saved:.1f} s: {tokens} streamed decode tokens {stream_s:.1f}, "
          f"{PLAIN_TIMING['cases']} plain versions timed once (in "
          f"{PLAIN_TIMING['seconds']:.1f} s) at least "
          f"{PLAIN_TIMING['saved_s']:.1f}, the launcher's steps about "
          f"{launcher_s:.1f}; the mesh phase added {meshed['seconds']:.1f} s "
          f"(the dry run's check {meshed['dryrun']['seconds']:.1f} s of it)",
          flush=True)
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("flash-bwd", "scan-bwd", "stream",
                                       "mesh"),
                    help="build the kernels and run only phase 8(a), the "
                    "flash backward kernel's cases, or 8(a'), the scan "
                    "backward kernel's, with each launch's profiled device "
                    "time; or phase 1'(a), mixtral-8x7b streamed; or phase "
                    "7m, granite-moe-1b-a400m through a 1-rank mesh")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 matmuls in full fp32
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    out = build.build_all()
    print(f"build: {out} in {time.perf_counter() - t0:.1f} s", flush=True)
    print(build.ptxas_report(), flush=True)
    if args.only == "flash-bwd":
        flash_bwd_phase(split=True)
        return 0
    if args.only == "scan-bwd":
        scan_bwd_phase(split=True)
        return 0
    if args.only == "stream":
        stream_phase(card)
        return 0
    if args.only == "mesh":
        mesh_phase()
        return 0

    t_run = time.perf_counter()
    link = link_rates()
    streamed = stream_phase(card)   # first: the host's memory is the freest
    examples = examples_phase()
    free_memory()
    print(f"stream and examples phases done at "
          f"{time.perf_counter() - t_run:.1f} s", flush=True)
    gemma = get_config("gemma3-1b")
    mm_rows, mm_phases = matmul_phase(gemma)
    mm_rows += matmul_edge_cases()
    fa_rows, fa_prefill = flash_phase(gemma)
    served = serve_phase(gemma)
    specs = [served.pop("spec")]
    free_memory()
    launched = [launcher_phase(
        "gemma3-1b", served["svm"]["modes"]["svm_aware"]["report"], specs[0])]
    free_memory()
    print(f"gemma3-1b phases done at {time.perf_counter() - t_run:.1f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB still allocated",
          flush=True)

    mamba = get_config("falcon-mamba-7b")
    scan_rows, scan_prefill = scan_phase(mamba)
    mm_rows_m, mm_phases_m = matmul_phase(mamba)
    served_m = serve_phase(mamba)
    specs.append(served_m.pop("spec"))
    free_memory()
    launched.append(launcher_phase(
        "falcon-mamba-7b", served_m["svm"]["modes"]["zero_copy"]["report"],
        specs[1]))
    print(f"falcon-mamba-7b phases done at {time.perf_counter() - t_run:.1f} s",
          flush=True)
    sched = sched_phase(specs)
    print(f"sched phase done at {time.perf_counter() - t_run:.1f} s",
          flush=True)
    free_memory()
    new = new_archs_phase(t_run)
    launched.append(new.pop("launcher"))
    free_memory()
    meshed = mesh_phase()
    print(f"mesh phase done at {time.perf_counter() - t_run:.1f} s",
          flush=True)
    ctxp = context_archs_phase(t_run)
    launched.append(ctxp.pop("launcher"))
    free_memory()
    jamba = jamba_phase(t_run)
    free_memory()
    served_sums = new["served"][TRAIN_ARCH]["param_sums"]
    for s in [served, served_m, *new["served"].values(),
              *ctxp["served"].values(), jamba["served"]]:   # the init bits
        del s["param_sums"]
    trained = train_phases(served_sums)
    free_memory()
    print(f"train phases done at {time.perf_counter() - t_run:.1f} s",
          flush=True)
    work, weighted = workloads_phase()   # last: the serving phases run as before it
    free_memory()
    print(f"paper workloads phase done at {time.perf_counter() - t_run:.1f} s",
          flush=True)

    rates = {s["arch"]: serving_rate(s) for s in (served, served_m)}
    mm_src = "src/repro_torch/kernels/csrc/matmul.cu"
    fa_src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    scan_src = "src/repro_torch/kernels/csrc/mamba_scan.cu"
    mm_rep = "src/repro/kernels/matmul.py:24"
    fa_rep = "src/repro/kernels/flash_attention.py:23"
    scan_rep = "src/repro/kernels/mamba_scan.py:27"

    def split(served, name):   # (decode launches, prefill launches)
        pre = served["prefill_launches"][name]
        return served["launches"][name] - pre, pre

    mm_dec, mm_pre = split(served, "matmul")
    mmm_dec, mmm_pre = split(served_m, "matmul")
    kernels = [
        summarize("matmul@decode", mm_phases["decode"], mm_dec, mm_src, mm_rep),
        summarize("matmul@prefill", mm_phases["prefill"], mm_pre, mm_src,
                  mm_rep),
        summarize("flash_attention@prefill", fa_prefill,
                  served["launches"]["flash_attention"], fa_src, fa_rep),
        summarize("mamba_scan@prefill", scan_prefill,
                  served_m["launches"]["mamba_scan"], scan_src, scan_rep),
        summarize("matmul@mamba-decode", mm_phases_m["decode"], mmm_dec,
                  mm_src, mm_rep),
        summarize("matmul@mamba-prefill", mm_phases_m["prefill"], mmm_pre,
                  mm_src, mm_rep),
        summarize("triad@category-I", weighted["triad"],
                  work["run"]["launches"]["triad"],
                  "src/repro_torch/kernels/csrc/triad.cu",
                  "src/repro/kernels/stream_triad.py:21"),
        summarize("jacobi2d@category-II", weighted["jacobi2d"],
                  work["run"]["launches"]["jacobi2d"],
                  "src/repro_torch/kernels/csrc/jacobi2d.cu",
                  "src/repro/kernels/jacobi2d.py:20"),
    ]
    s32, s20, smoe = (new["served"][n] for n in ("granite-3-2b", "granite-20b",
                                                  MOE_ARCH))
    moe_dec, moe_pre = split(smoe, "matmul")
    moe_phases = new.pop("matmul_moe_phases")   # (row, calls): not for the json
    g20_phases = new.pop("matmul_granite_20b_phases")
    kernels += [
        summarize("flash_attention@prefill-d64",
                  [(new["flash"]["d64"], s32["n_layers"])],
                  s32["launches"]["flash_attention"], fa_src, fa_rep),
        summarize("flash_attention@prefill-d128",
                  [(new["flash"]["d128"], s20["n_layers"])],
                  s20["launches"]["flash_attention"], fa_src, fa_rep),
        summarize("matmul@moe-prefill", moe_phases["prefill"], moe_pre,
                  mm_src, mm_rep),
        summarize("matmul@moe-decode", moe_phases["decode"], moe_dec,
                  mm_src, mm_rep),
        summarize("matmul@granite-20b-decode", g20_phases["decode"],
                  split(s20, "matmul")[0], mm_src, mm_rep),
    ]
    # granite-moe-1b-a400m through the 1-rank mesh (phase 7m): its
    # shapes are the resident run's, timed in phase 7 (matmul) and 7m
    # (flash at 16:8); launches of the mesh run
    mesh_run = meshed["meshed"]
    mesh_pre = sum(mesh_run["prefill_launches"]["matmul"].values())
    kernels += [
        summarize("matmul@mesh-prefill", moe_phases["prefill"], mesh_pre,
                  mm_src, mm_rep),
        summarize("matmul@mesh-decode", moe_phases["decode"],
                  sum(mesh_run["launches"]["matmul"].values()) - mesh_pre,
                  mm_src, mm_rep),
        summarize("flash_attention@mesh-prefill",
                  [(meshed["flash"], smoe["n_layers"])],
                  sum(mesh_run["prefill_launches"]["flash_attention"]
                      .values()), fa_src, fa_rep)]
    svlm, s2t = (ctxp["served"][n] for n in CTX_ARCHS)
    ctx_mm = ctxp.pop("matmul_phases")   # (row, calls): not for the json
    cf = ctxp["flash"]
    for tag, srv, mm, fa_pre, fa_dec in (
            ("vlm", svlm, ctx_mm[VLM_ARCH],
             [(cf["vlm-self"], 32), (cf["vlm-cross"], 8)],
             [(cf["vlm-cross-decode"], 8)]),
            ("encdec", s2t, ctx_mm[ENCDEC_ARCH],
             [(cf["encoder"], 24), (cf["encdec-self"], 12)],
             [(cf["encoder"], 12), (cf["encdec-cross-decode"], 12)])):
        mm_d, mm_p = split(srv, "matmul")
        fa_d, fa_p = split(srv, "flash_attention")
        kernels += [
            summarize(f"matmul@{tag}-prefill", mm["prefill"], mm_p, mm_src,
                      mm_rep),
            summarize(f"matmul@{tag}-decode", mm["decode"], mm_d, mm_src,
                      mm_rep),
            summarize(f"flash_attention@{tag}-prefill", fa_pre, fa_p, fa_src,
                      fa_rep),
            summarize(f"flash_attention@{tag}-decode", fa_dec, fa_d, fa_src,
                      fa_rep)]
    sj = jamba["served"]
    mm_j = jamba.pop("matmul_phases")   # (row, calls): not for the json
    mm_jd, mm_jp = split(sj, "matmul")
    kernels += [
        summarize("matmul@jamba-prefill", mm_j["prefill"], mm_jp, mm_src,
                  mm_rep),
        summarize("matmul@jamba-decode", mm_j["decode"], mm_jd, mm_src,
                  mm_rep),
        summarize("flash_attention@jamba-prefill",
                  [(jamba["flash"], sj["launches"]["flash_attention"])],
                  sj["launches"]["flash_attention"], fa_src, fa_rep),
        summarize("mamba_scan@jamba-prefill",
                  [(jamba["scan"], sj["launches"]["mamba_scan"])],
                  sj["launches"]["mamba_scan"], scan_src, scan_rep)]
    # mixtral-8x7b streamed (phase 1'(a), naive): the kernels at its
    # shapes over the 32 layers, timed resident; launches of the streamed
    # prefill and its STREAM_DECODE tokens
    mix = new.pop("matmul_mixtral_phases")
    st_pre = streamed["policies"]["naive"]["prefill"]["counts"]
    st_all = streamed["policies"]["naive"]["decode"]["counts"]
    st_mm = sum(st_pre["matmul"].values())
    kernels += [
        summarize("matmul@mixtral-stream-prefill", mix["prefill"], st_mm,
                  mm_src, mm_rep),
        summarize("matmul@mixtral-stream-decode", mix["decode"],
                  sum(st_all["matmul"].values()) - st_mm, mm_src, mm_rep),
        summarize("flash_attention@mixtral-stream-prefill",
                  [(new["flash"]["d128-window"], streamed["n_layers"])],
                  sum(st_pre["flash_attention"].values()), fa_src, fa_rep)]
    bwd_rows = {r["tag"]: r for r in trained["flash_bwd"]}
    step_counts = trained["run"]["steps"][-1]["launches"]
    bwd_routes = step_counts["flash_attention_bwd"]
    kernels.append(dict(summarize(
        "flash_attention_bwd@train", [(bwd_rows[TRAIN_ARCH],
                                       bwd_routes["wgmma"])],
        sum(bwd_routes.values()),
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "none: no TPU kernel; the reference differentiates _attend "
        "(src/repro/models/attention.py:116) through XLA"),
        routes=bwd_routes))
    scan_mb = next(r for r in trained["scan_bwd"]["cases"]
                   if r["tag"] == "microbatch")
    mamba_counts = trained["mamba"]["steps"][-1]["launches"]
    kernels += [
        summarize("mamba_scan@train", [(scan_mb["forward"],
                                        mamba_counts["mamba_scan"]["cuda"])],
                  mamba_counts["mamba_scan"]["cuda"], scan_src, scan_rep),
        summarize("mamba_scan_bwd@train", [(scan_mb,
                                            mamba_counts["mamba_scan_bwd"]["cuda"])],
                  mamba_counts["mamba_scan_bwd"]["cuda"],
                  "src/repro_torch/kernels/csrc/mamba_scan_bwd.cu",
                  "none: no TPU kernel; the reference differentiates its "
                  "chunked associative scan (src/repro/models/mamba.py:96) "
                  "through XLA")]
    cut = cut_seconds(jamba, new, trained, streamed, meshed)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__,
                       ptxas=build.ptxas_report(), matmul=mm_rows,
                       flash_attention=fa_rows, serve=served,
                       mamba_scan=scan_rows, matmul_mamba=mm_rows_m,
                       serve_mamba=served_m, paper_workloads=work,
                       kernels=kernels, link_bw=link, serving_rate=rates,
                       launcher=launched, sched=sched, new_archs=new,
                       context_archs=ctxp, jamba=jamba, mesh=meshed,
                       train=trained,
                       stream=streamed,
                       examples=examples, cut=cut,
                       seconds=time.perf_counter() - t_run), f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
