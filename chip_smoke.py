#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py        # from the repository root, one CUDA card

1. Prints the card's name and power limit, then builds the CUDA kernels
   from ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a).
2. Holds the matmul kernel against its plain version at every shape the
   gemma3-1b serving path gives it (decode M=4, prefill M=4096), plus
   ragged and fp32 cases.
3. Holds the flash-attention kernel against its plain version: the Pallas
   kernel's cases (KV=H, causal and not, S != T) and the model's prefill
   shapes (GQA 4:1, D=256, window 512 and global).
4. Serves full-width gemma3-1b (random weights from seed 0): batch 4,
   1024-token prompts, 32 greedy decode tokens, through
   ``repro_torch.launch.serve``; checks that both kernels were launched and
   that the plain path (``impl="torch"``) gives the same logits.
5. Prints one JSON line of kernel numbers, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Every time is the median over repeats, timed with CUDA events; matmul
timings cycle through copies of B that exceed the 50 MB L2, so weights are
read cold, as in a decode step. Per-case detail goes to
``chiprun_out/chip_smoke.json``. Any failure exits non-zero.
"""

from __future__ import annotations

import json
import math
import os
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
L2_BYTES = 50 * 2 ** 20
BATCH, PROMPT, DECODE = 4, 1024, 32
MM_TOL = {torch.bfloat16: dict(rtol=1e-2, atol=1e-2),   # one bf16 rounding of the output
          torch.float32: dict(rtol=1e-4, atol=1e-4)}
FA_TOL = dict(rtol=2e-2, atol=2e-2)    # P rounded to bf16 against another running max
MODEL_TOL = dict(rtol=2e-2, atol=2e-2)  # the repo's bf16 model tolerance (test_arch_smoke)
PATH_RATIO = 1.5     # see compare_paths
MARGIN = 0.25        # a top-2 logit gap that bf16 noise at full width does not close


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def time_ms(fn, arg_sets, reps: int = 10) -> float:
    """Median ms of one call of ``fn``, cycling through ``arg_sets``. The
    calls are captured once in a CUDA graph and the graph is replayed, so
    the time is the device's, not the host's launch overhead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up off the capture
        for args in arg_sets[:3]:
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


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_close(name: str, got, want, tol) -> float:
    """Elementwise |got - want| <= atol + rtol |want|; returns max |err|."""
    err = (got.float() - want.float()).abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    limit = tol["atol"] + tol["rtol"] * want.float().abs()
    if (err > limit).any():
        raise AssertionError(f"{name}: max |err| {err.max().item():.3e} over "
                             f"tolerance rtol={tol['rtol']} atol={tol['atol']}")
    return err.max().item()


# ------------------------------------------------------------------ matmul

def matmul_case(M, K, N, bt, dtype, tag):
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(M * 7 + N)
    a = torch.randn((M, K), generator=g, device="cuda").to(dtype)
    bshape = (N, K) if bt else (K, N)
    b = (torch.randn(bshape, generator=g, device="cuda") * 0.02).to(dtype)
    got = kmm.matmul(a, b, b_transposed=bt)
    want = ref.matmul_ref(a, b, bt)
    torch.cuda.synchronize()
    err = check_close(f"matmul {tag}", got, want, MM_TOL[dtype])
    copies = max(1, math.ceil(2 * L2_BYTES / b.nbytes))
    bs = [b] + [b.clone() for _ in range(copies - 1)]
    sets = [(a, x) for x in bs]
    ms = time_ms(lambda x, y: kmm.matmul(x, y, b_transposed=bt), sets)
    plain = time_ms(lambda x, y: ref.matmul_ref(x, y, bt), sets)
    lib = time_ms(lambda x, y: torch.matmul(x, y.t() if bt else y), sets)
    del bs, sets
    nbytes = (M * K + K * N + M * N) * a.element_size()
    bnd, by = bound_ms(nbytes, 2.0 * M * N * K, dtype)
    row = dict(tag=tag, M=M, K=K, N=N, b_transposed=bt,
               dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
               ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by)
    print(f"matmul {tag:>14} M={M:<5d} K={K:<5d} N={N:<6d} bt={int(bt)} "
          f"err={err:.2e} kernel {ms:.4f} ms  plain {plain:.4f}  "
          f"torch.matmul {lib:.4f}  bound {bnd:.4f} ({by})", flush=True)
    return row


def matmul_phase(cfg):
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    per_layer = [("wq", d, nq, 1), ("wk,wv", d, nkv, 2),
                 ("wi_gate,wi_up", d, f, 2), ("attn wo", nq, d, 1),
                 ("mlp wo", f, d, 1)]
    phases = {"decode": [], "prefill": []}
    rows = []
    for phase, M in (("decode", BATCH), ("prefill", BATCH * PROMPT)):
        for tag, K, N, per in per_layer:
            r = matmul_case(M, K, N, False, torch.bfloat16, tag)
            rows.append(r)
            phases[phase].append((r, per * cfg.n_layers))
        # the head runs on the last position only, in prefill as in decode
        r = matmul_case(BATCH, d, cfg.padded_vocab, True, torch.bfloat16,
                        "lm head")
        rows.append(r)
        phases[phase].append((r, 1))
    for M, K, N, bt, dt in ((37, 100, 50, False, torch.bfloat16),
                            (37, 100, 50, True, torch.bfloat16),
                            (4, 1000, 333, True, torch.bfloat16),
                            (130, 77, 333, False, torch.float32),
                            (130, 77, 333, True, torch.float32),
                            (512, 1152, 1024, False, torch.float32)):
        rows.append(matmul_case(M, K, N, bt, dt, "ragged" if M != 512 else "fp32"))
    return rows, phases


# --------------------------------------------------------- flash attention

def flash_case(B, H, KV, S, T, D, causal, window, tag, model_layout=False):
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
    got = kfa.flash_attention(q, k, v, causal, window, scale)
    want = ref.flash_attention_ref(q, k, v, causal, window, scale)
    torch.cuda.synchronize()
    err = check_close(f"flash {tag}", got, want, FA_TOL)
    ms = time_ms(lambda: kfa.flash_attention(q, k, v, causal, window, scale), [()])
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal, window, scale), [()])
    mask = ref.attention_mask(S, T, causal, window, "cuda")
    kr = k.repeat_interleave(H // KV, dim=1).contiguous()
    vr = v.repeat_interleave(H // KV, dim=1).contiguous()
    qc = q.contiguous()
    if causal and not window and S == T:
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qc, kr, vr, is_causal=True, scale=scale), [()])
    else:
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qc, kr, vr, attn_mask=mask, scale=scale), [()])
    pairs = int(mask.sum().item())     # the (q, k) pairs this mask leaves
    flops = 4.0 * B * H * pairs * D    # q.k and p.v, 2 flops per MAC
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KV * T * D)
    bnd, by = bound_ms(nbytes, flops, torch.bfloat16)
    row = dict(tag=tag, B=B, H=H, KV=KV, S=S, T=T, D=D, causal=causal,
               window=window, max_abs_err=err, ms=ms, plain_ms=plain,
               library_ms=lib, bound_ms=bnd, bound_by=by)
    print(f"flash {tag:>10} B={B} H={H} KV={KV} S={S} T={T} D={D} "
          f"causal={int(causal)} window={window} err={err:.2e} kernel "
          f"{ms:.4f} ms  plain {plain:.4f}  sdpa {lib:.4f}  bound {bnd:.4f} "
          f"({by})", flush=True)
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
        rows.append(flash_case(B, H, H, S, T, D, causal, 0, "pallas"))
    # the reduced config's shape: D=16, GQA, a window, ragged S
    rows.append(flash_case(2, 4, 1, 37, 37, 16, True, 8, "reduced"))
    hd = cfg.resolved_head_dim
    local = flash_case(BATCH, cfg.n_heads, cfg.n_kv_heads, PROMPT, PROMPT, hd,
                       True, cfg.sliding_window, "local", model_layout=True)
    glob = flash_case(BATCH, cfg.n_heads, cfg.n_kv_heads, PROMPT, PROMPT, hd,
                      True, 0, "global", model_layout=True)
    rows += [local, glob]
    n_global = sum(1 for m, _ in cfg.layer_kinds() if m == "attn")
    prefill = [(local, cfg.n_layers - n_global), (glob, n_global)]
    return rows, prefill


# ------------------------------------------------------------------- serve

def serve_phase(cfg):
    from repro_torch.bridge import init_params, leaf_sizes
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    toks = serve.prompts(cfg, BATCH, PROMPT, "cuda")
    torch.cuda.synchronize()
    print(f"serve: init {sum(n for _, n in leaf_sizes(params)) / 1e9:.3f} GB "
          f"of bf16 params in {time.perf_counter() - t0:.1f} s", flush=True)
    with torch.inference_mode():
        tok, _, cache, _ = serve.run_prefill(cfg, params, toks[:, :128])  # warm-up
        serve.run_decode(cfg, params, tok, cache, 2)
        del cache
        kmm.launches = kfa.launches = 0
        tok, logits, cache, pre_ms = serve.run_prefill(cfg, params, toks)
        pre_counts = (kmm.launches, kfa.launches)
        decoded, cache, dec_ms = serve.run_decode(cfg, params, tok, cache, DECODE)
        counts = (kmm.launches, kfa.launches)
        seq = torch.cat([tok] + decoded, dim=1)
        assert logits.shape == (BATCH, 1, cfg.padded_vocab), logits.shape
        assert torch.isfinite(logits.float()).all(), "non-finite prefill logits"
        assert seq.shape == (BATCH, DECODE + 1)
        assert int(seq.min()) >= 0 and int(seq.max()) < cfg.vocab
        if min(counts) == 0:
            raise AssertionError(f"a kernel was not launched on the main path: "
                                 f"matmul {counts[0]}, flash {counts[1]}")
        tok_s = BATCH * DECODE / (dec_ms / 1e3)
        print(f"serve: prefill {BATCH}x{PROMPT} in {pre_ms:.2f} ms; decoded "
              f"{DECODE} tokens in {dec_ms:.2f} ms ({tok_s:.1f} tok/s, "
              f"{dec_ms / DECODE:.3f} ms/token); launches: matmul {counts[0]} "
              f"(prefill {pre_counts[0]}), flash {counts[1]} "
              f"(prefill {pre_counts[1]})", flush=True)
        print("serve: first request continuation:", seq[0].tolist(), flush=True)

        # where the time goes: device-busy time under the profiler
        prof_pre = profile_device(lambda: serve.run_prefill(cfg, params, toks))
        prof_dec = profile_device(
            lambda: serve.run_decode(cfg, params, seq[:, -1:], cache, 4))
        del cache
        for phase, (busy, wall, top), eager in (
                ("prefill", prof_pre, pre_ms), ("decode x4", prof_dec,
                                                4 * dec_ms / DECODE)):
            print(f"profile {phase}: device busy {busy:.2f} ms of {eager:.2f} ms "
                  f"unprofiled ({wall:.2f} ms profiled): idle share "
                  f"{1 - busy / eager:.3f}", flush=True)
            for name, ms, n in top:
                print(f"    {ms:9.3f} ms  {n:5d}x  {name}", flush=True)

        paths = compare_paths(cfg, params, toks)
        pre_ms_p = paths.pop("plain_prefill_ms")
        reduced = reduced_vs_cpu()
    weight_bytes = sum(n for _, n in leaf_sizes(params))
    return dict(prefill_ms=pre_ms, decode_ms=dec_ms, tok_s=tok_s,
                decode_ms_per_token=dec_ms / DECODE,
                decode_weight_bound_ms_per_token=weight_bytes / HBM_BYTES_S * 1e3,
                profile_prefill=prof_pre, profile_decode_4_tokens=prof_dec,
                plain_prefill_ms=pre_ms_p, launches=counts,
                prefill_launches=pre_counts, paths_vs_fp32=paths,
                reduced_vs_cpu=reduced, continuation=seq[0].tolist())


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def compare_paths(cfg, params, toks, steps: int = 4) -> dict:
    """Full width: the kernel path (impl="auto") and the plain path
    (impl="torch"), both bf16, against the same model run in fp32 on the
    plain path. Prefill's last-position logits, then ``steps`` decode
    steps teacher-forced on the fp32 path's greedy tokens, each path on its
    own cache. Both bf16 paths round the residual stream after each of 52
    sublayers, at different points (fp32 scores in the flash kernel, bf16
    in the plain path's attention; other fp32 sum orders), so at full width
    neither is within an elementwise 2e-2 of the other. The check: the
    kernel path is no farther from fp32 than the plain path, relative L2
    distance within PATH_RATIO of it at every step, and both bf16 paths
    pick fp32's greedy token wherever its top-2 gap exceeds MARGIN."""
    from repro_torch.bridge import tree_map
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tm

    params32 = tree_map(lambda x: x.float(), params)
    setups = {"fp32": (params32, "torch"), "plain": (params, "torch"),
              "kernel": (params, "auto")}
    logits, caches, out = {}, {}, {"steps": []}
    for name, (p, impl) in setups.items():
        _, lg, caches[name], ms = serve.run_prefill(cfg, p, toks, impl=impl)
        logits[name] = lg[:, -1]
        if name == "plain":
            out["plain_prefill_ms"] = ms
    for step in range(steps + 1):
        if step:
            for name, (p, impl) in setups.items():
                lg, caches[name] = tm.decode_step(p, cfg, tok, caches[name],
                                                  impl=impl)
                logits[name] = lg[:, -1]
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
    return out


def reduced_vs_cpu() -> dict:
    """Small input, the repo's own tolerance: reduced gemma3-1b (head_dim
    16, window 8) served on the card through the kernels against the plain
    path on the CPU, same params and prompts; prefill logits and 8 decode
    steps past prompt_len, teacher-forced on the CPU's tokens, elementwise
    within MODEL_TOL."""
    from repro_torch.bridge import init_params, tree_map
    from repro_torch.configs import get_reduced
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tm

    cfg = get_reduced("gemma3-1b")
    p_cpu = init_params(cfg, seed=0, device="cpu")
    p_gpu = tree_map(lambda x: x.to("cuda"), p_cpu)
    toks = serve.prompts(cfg, 2, 24, "cpu")
    tok, lc, cache_c, _ = serve.run_prefill(cfg, p_cpu, toks)
    _, lg, cache_g, _ = serve.run_prefill(cfg, p_gpu, toks.to("cuda"))
    errs = [check_close("reduced prefill", lg.cpu(), lc, MODEL_TOL)]
    for _ in range(8):
        lc, cache_c = tm.decode_step(p_cpu, cfg, tok, cache_c)
        lg, cache_g = tm.decode_step(p_gpu, cfg, tok.to("cuda"), cache_g)
        errs.append(check_close("reduced decode", lg.cpu(), lc, MODEL_TOL))
        tok = lc[:, -1].argmax(dim=-1).int()[:, None]
    print(f"reduced gemma3-1b, card kernels vs CPU plain: max |err| prefill "
          f"{errs[0]:.3e}, 8 decode steps {max(errs[1:]):.3e} "
          f"(tolerance {MODEL_TOL})", flush=True)
    return dict(prefill_max_abs_err=errs[0], decode_max_abs_err=max(errs[1:]))


def profile_device(fn):
    """(device-busy ms, profiled wall ms, top kernels) of one run of ``fn``
    under torch.profiler: the sum of the device time of every kernel."""
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
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    return busy, wall, [(e.key[:70], e.self_device_time_total / 1e3, e.count)
                        for e in top]


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
        library_ms=sum(r["library_ms"] * n for r, n in weighted))


def main() -> int:
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

    cfg = get_config("gemma3-1b")
    mm_rows, mm_phases = matmul_phase(cfg)
    fa_rows, fa_prefill = flash_phase(cfg)
    served = serve_phase(cfg)

    mm_src = "src/repro_torch/kernels/csrc/matmul.cu"
    fa_src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    mm_rep = "src/repro/kernels/matmul.py:24"
    fa_rep = "src/repro/kernels/flash_attention.py:23"
    n_mm, n_fa = served["launches"]
    n_mm_pre, n_fa_pre = served["prefill_launches"]
    kernels = [
        summarize("matmul@decode", mm_phases["decode"], n_mm - n_mm_pre,
                  mm_src, mm_rep),
        summarize("matmul@prefill", mm_phases["prefill"], n_mm_pre, mm_src,
                  mm_rep),
        summarize("flash_attention@prefill", fa_prefill, n_fa, fa_src, fa_rep),
    ]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__, matmul=mm_rows,
                       flash_attention=fa_rows, serve=served, kernels=kernels),
                  f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
