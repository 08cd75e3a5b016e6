"""Serving launcher of the port: prefill a batch of prompts, then
greedy-decode — port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --batch 4 --prompt-len 16 --decode 16

``--arch`` takes every config of the reference: gemma3-1b,
falcon-mamba-7b, granite-3-2b, chatglm3-6b, granite-20b,
granite-moe-1b-a400m, mixtral-8x7b, llama-3.2-vision-11b,
seamless-m4t-medium and jamba-1.5-large-398b
(``repro_torch.configs.ARCH_IDS``). At full depth jamba-1.5-large-398b
holds 797 GB of bf16 weights, more than one card: the launcher builds
them all, as the reference's does; ``--reduced`` serves it anywhere.
The VLM and the encoder-decoder take the reference's stubbed frontend:
``modality_stub`` image patches or speech frames in bf16 (``context``),
which seamless-m4t-medium encodes again for every decode token, as the
reference does.

It runs on CUDA unless given ``--device cpu``. Prefill and decode are timed
with CUDA events on the card and with ``time.perf_counter`` on the CPU.

With ``--svm-budget-frac`` the decode loop additionally rides the SVM
weight-streaming runtime (`repro_torch.svm`): the model's parameter leaves
are planned into managed ranges against a device pool of the given
fraction of total param bytes, and the whole decode's layer-fetch trace
replays through the compiled-session engine in one fused pass
(`StreamingExecutor.decode_steps`; prefetch modes fall back to per-token
`decode_step` replays), after the timed loop, so tok/s stays the real
number. It reports the simulated streaming wall clock,
migration/eviction traffic and session cache stats next to the real
tok/s.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --svm-budget-frac 0.6 --svm-mode svm_aware --svm-policy lrf

With ``--requests N`` (N > 1, needs ``--svm-budget-frac``) the report adds
the **multi-tenant scheduler** (`repro_torch.svm.scheduler`): N decode
requests of this model, a seeded synthetic arrival process (``--arrival``
= mean interarrival seconds on the simulated clock; 0 = all at once),
contending for one shared SVM pool of the same fraction of the weights
under ``--sched-policy fifo|admission|svm_aware`` (``--admit-by bytes|
measured``; ``--thrash-watermark`` arms the thrash guard). ``--chaos``
injects the default seeded fault plan (``--chaos-seed``,
``--chaos-intensity``: capacity loss, slow pages, migration faults, a
crash) and adds the recovery line. The schedule runs on the simulated
clock after the timed loop, with the H100 preset's rates, and prints the
per-request latency percentiles, aggregate tok/s and eviction pressure
(`schedule_report`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --svm-budget-frac 0.6 --requests 8 --sched-policy svm_aware --chaos
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.bridge import init_params, leaves
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data import SyntheticLM, modality_stub
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (close_mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      model_context)
from repro_torch.models.transformer import local_params
from repro_torch.svm import (FaultPlan, ModelSpec, StreamingExecutor,
                             run_schedule)
from repro_torch.svm.scheduler import ADMIT_MODES, POLICIES

SVM_POLICIES = ("lrf", "lru", "clock", "random")
SVM_MODES = ("naive", "svm_aware", "measured", "zero_copy")


class WeightStream:
    """SVM weight-streaming accounting riding along a real decode loop.

    Each parameter leaf is one fetch group, visited in model order
    (`repro_torch.bridge.leaves`) once per token; per-leaf decode FLOPs are
    estimated as 2 · batch · params. All manager driving goes through the
    executor's `TraceSession` — the per-token trace compiles once and
    replays as cached segments. ``executor_kw`` goes to the
    `StreamingExecutor` (its ``device``, ``cost_params``,
    ``compute_rate``, ``scalar``)."""

    def __init__(self, params, batch: int, *, budget_frac: float,
                 policy: str, mode: str, **executor_kw):
        paths, nbytes, nparams = [], [], []
        for path, leaf in leaves(params):
            paths.append(path)
            n = leaf.numel()
            nparams.append(n)
            nbytes.append(n * leaf.element_size())
        total = sum(nbytes)
        budget = max(int(total * budget_frac), 1)

        kw: dict = {}
        if mode == "svm_aware":
            # pin the embedding-ish hottest leaf (only if it leaves room
            # for streaming the rest — a pinned-full pool deadlocks every
            # later migration) and prefetch the rest
            hot = int(np.argmax(nbytes))
            kw = {"prefetch": True}
            if nbytes[hot] <= budget // 2:
                kw["pin"] = (paths[hot],)
        elif mode == "measured":
            # docs/prefetching.md: profile the first token's touch
            # columns and pin only leaves above the touch-frequency
            # threshold
            kw = {"prefetch_mode": "measured"}
        elif mode == "zero_copy":
            # paper §4.2 hybrid placement: coldest (largest) leaves stay
            # host-resident at remote-access cost, up to half the weights
            order = sorted(range(len(paths)), key=lambda i: -nbytes[i])
            zc, acc = [], 0
            for i in order:
                if acc + nbytes[i] > total // 2:
                    continue     # too big for the budget; smaller may fit
                zc.append(paths[i])
                acc += nbytes[i]
            kw = {"zero_copy": tuple(zc)}

        self.executor = StreamingExecutor(
            params, budget, policy=policy, profile=False, **kw,
            **executor_kw)
        self.layer_paths = [[p] for p in paths]
        self.flops = [2.0 * batch * n for n in nparams]
        self.total_bytes = total
        self.budget = budget

    def step(self) -> None:
        self.executor.decode_step(self.layer_paths, self.flops,
                                  materialize=False)

    def steps(self, n: int) -> None:
        """Fused multi-token accounting: all ``n`` decode steps replay as
        one concatenated segment in a single batched engine pass
        (`decode_steps`; prefetch mode falls back to the per-token
        loop)."""
        self.executor.decode_steps(self.layer_paths, self.flops, n,
                                   materialize=False)

    def report(self, decoded: int) -> str:
        m = self.executor.metrics()
        return (
            f"svm stream: DOS {m['dos']:.0f}% "
            f"(pool {self.budget / 1e6:.1f}MB / "
            f"weights {self.total_bytes / 1e6:.1f}MB), "
            f"simulated decode wall {m['wall_s'] * 1e3:.2f}ms, "
            f"{m['migrations']} migs / {m['evictions']} evicts "
            f"(e2m {m['evict_to_mig']:.2f}), "
            f"session: {m['segment_cache_misses']} compiled / "
            f"{m['segment_cache_hits']} cached replays over "
            f"{decoded} tokens")


class _Timer:
    """Milliseconds of device work between ``start`` and ``stop``."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self) -> None:
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            t1.synchronize()
            return self.t0.elapsed_time(t1)
        return (time.perf_counter() - self.t0) * 1e3


def prompts(cfg, batch: int, prompt_len: int, device) -> torch.Tensor:
    """The reference launcher's prompts: ``SyntheticLM(seed=1)``, step 0."""
    data = SyntheticLM(vocab=cfg.vocab, seed=1)
    toks = data.batch(0, 0, batch, prompt_len)["tokens"]
    return torch.from_numpy(toks).to(device)


def context(cfg, batch: int, device) -> torch.Tensor | None:
    """The reference launcher's modality context in bf16: ``modality_stub``
    image patches (B, image_tokens, d) for a VLM, speech frames (B,
    encoder_frames, d) for an encoder-decoder, None otherwise."""
    if cfg.is_vlm:
        ctx = modality_stub("image", batch, cfg.image_tokens, cfg.d_model)
    elif cfg.is_encdec:
        ctx = modality_stub("frames", batch, cfg.encoder_frames, cfg.d_model)
    else:
        return None
    return torch.from_numpy(ctx).to(torch.bfloat16).to(device)


def run_prefill(cfg, params, tokens: torch.Tensor, ctx=None,
                impl: str = "auto", mesh=None):
    """Prefill ``tokens`` (B,S) with the modality context ``ctx`` ->
    (first greedy token (B,1), last-position logits (B,1,V), cache, ms).
    On a ``mesh`` the params may be DTensors, and ``tokens`` are this
    rank's rows (``models/transformer.py``)."""
    timer = _Timer(tokens.device)
    timer.start()
    logits, cache = make_prefill_step(cfg, impl, mesh)(params, tokens, ctx)
    tok = logits[:, -1].argmax(dim=-1).int()[:, None]
    return tok, logits, cache, timer.stop()


def decode_tokens(cfg, serve_step, params, tok, cache, ctx, steps: int,
                  impl: str = "auto"):
    """Greedy-decode ``steps`` tokens through a serve step.

    Encoder-decoder configs re-encode their modality context and thread
    it through every step; VLMs thread the precomputed image context.
    Decoder-only configs (``ctx`` is None) take the two-argument path.
    Returns (decoded token list, final cache)."""
    outs = []
    for _ in range(steps):
        if ctx is not None and (cfg.is_encdec or cfg.is_vlm):
            c = model_context(params, cfg, ctx, impl)
            tok, cache = serve_step(params, tok, cache, c)
        else:
            tok, cache = serve_step(params, tok, cache)
        outs.append(tok)
    return outs, cache


def run_decode(cfg, params, tok, cache, steps: int, ctx=None,
               impl: str = "auto", mesh=None):
    """Greedy-decode ``steps`` tokens after ``tok`` -> (tokens, cache, ms).
    On a ``mesh`` as ``run_prefill``; the params are made this rank's
    (``local_params``) once, before the first token."""
    timer = _Timer(tok.device)
    timer.start()
    if mesh is not None:
        params = local_params(params, mesh)
    outs, cache = decode_tokens(cfg, make_serve_step(cfg, impl, mesh), params,
                                tok, cache, ctx, steps, impl)
    return outs, cache, timer.stop()


def _chaos_line(r: dict) -> str:
    """One-line chaos/recovery summary (empty without an injector)."""
    ch = r.get("chaos")
    if not ch or "injector" not in ch:
        return ""
    return (
        f"\n  chaos[{ch['injector']['plan']} seed "
        f"{ch['injector']['seed']}]: "
        f"{ch['injector']['events_applied']}/"
        f"{ch['injector']['events_total']} events, "
        f"{ch['migration_faults']} migration faults / "
        f"{ch['retries']} retries ({ch['retry_exhausted']} exhausted), "
        f"{ch['crashes']} crashes, {ch['preemptions']} preemptions, "
        f"{ch['resumes']} resumes, {ch['degraded_rounds']} degraded "
        f"rounds, {r['n_failed']} failed, "
        f"backoff {ch['backoff_wall_s'] * 1e3:.2f}ms")


def schedule_report(r: dict) -> str:
    """Three-line human summary of a `run_schedule` result dict (plus a
    chaos/recovery line when a fault plan was injected)."""
    sc = r["shared_cache"]
    return (
        f"svm sched[{r['policy']}]: {r['n_requests']} reqs, "
        f"offered DOS {r['dos_offered']:.0f}% "
        f"(peak admitted {r['dos_peak']:.0f}%), "
        f"p50/p90/p99 latency "
        f"{r['latency_p50_s'] * 1e3:.1f}/{r['latency_p90_s'] * 1e3:.1f}/"
        f"{r['latency_p99_s'] * 1e3:.1f}ms, "
        f"agg {r['agg_tok_s']:.0f} tok/s\n"
        f"  {r['migrations']} migs / {r['evictions']} evicts "
        f"(e2m {r['evict_to_mig']:.2f}, "
        f"{r['evictions_per_token']:.2f} ev/tok), "
        f"segment hit rate {r['segment_hit_rate'] * 100:.1f}% "
        f"({r['segment_shared_hits']} cross-request replays)\n"
        f"  shared cache: {sc['shared_segments']} segments, "
        f"{sc['shared_lookup_hits']} hits / "
        f"{sc['shared_lookup_misses']} misses, "
        f"{sc['shared_relocations']} relocations, "
        f"{sc['shared_concats']} round concats "
        f"({'fused' if r.get('fused') else 'per-token'} replay)"
        + _chaos_line(r))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=list(ARCH_IDS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode", type=int, default=16)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) production mesh: 256 ranks (raises "
                         "in a world of another size)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--svm-budget-frac", type=float, default=0.0,
                    help="enable SVM weight-streaming accounting with a "
                         "device pool of this fraction of the param bytes")
    ap.add_argument("--svm-policy", default="lrf", choices=SVM_POLICIES)
    ap.add_argument("--svm-mode", default="naive", choices=SVM_MODES)
    ap.add_argument("--requests", type=int, default=1,
                    help="multi-tenant: N concurrent decode requests of "
                         "this model over one shared SVM pool (needs "
                         "--svm-budget-frac)")
    ap.add_argument("--arrival", type=float, default=0.0,
                    help="mean interarrival seconds (simulated Poisson "
                         "process; 0 = all requests arrive at once)")
    ap.add_argument("--sched-policy", default="svm_aware",
                    choices=POLICIES)
    ap.add_argument("--admit-by", default="bytes", choices=ADMIT_MODES,
                    help="what the admission watermark caps: total plan "
                         "bytes, or the measured resident working set "
                         "estimated from the spec's own touch columns "
                         "(docs/prefetching.md)")
    ap.add_argument("--chaos", action="store_true",
                    help="inject the default seeded fault plan into the "
                         "multi-tenant schedule (capacity loss, slow "
                         "pages, migration faults, a crash) and report "
                         "the recovery accounting")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for the default fault plan")
    ap.add_argument("--chaos-intensity", type=float, default=1.0,
                    help="scales the number of injected migration faults")
    ap.add_argument("--thrash-watermark", type=float, default=None,
                    help="evictions-per-token watermark for the runtime "
                         "thrash guard (preempt + tighten admission); "
                         "unset = guard off")
    args = ap.parse_args(argv)
    if args.requests > 1 and args.svm_budget_frac <= 0.0:
        ap.error("--requests > 1 needs --svm-budget-frac > 0 "
                 "(the shared pool is sized from it)")

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    mesh = (make_production_mesh(device=device) if args.production_mesh
            else make_host_mesh(device))
    try:
        _serve(args, cfg, device)
    finally:
        close_mesh(mesh)


def _serve(args, cfg, device: torch.device) -> None:
    """``main``'s run, inside its mesh (which, as the reference's, leaves
    the computation on this process's device)."""
    params = init_params(cfg, seed=0, device=device)

    stream = None
    if args.svm_budget_frac > 0.0:
        stream = WeightStream(params, args.batch,
                              budget_frac=args.svm_budget_frac,
                              policy=args.svm_policy, mode=args.svm_mode,
                              device=device)

    toks = prompts(cfg, args.batch, args.prompt_len, device)
    ctx = context(cfg, args.batch, device)
    with torch.inference_mode():
        tok, _, cache, t_pre = run_prefill(cfg, params, toks, ctx)
        decoded, cache, t_dec = run_decode(cfg, params, tok, cache,
                                           args.decode, ctx)
    # the streaming accounting is a pure function of the token count:
    # replay it outside the timed loop so tok/s stays the real number
    if stream is not None:
        stream.steps(args.decode)
    seq = torch.cat([tok] + decoded, dim=1)
    print(f"prefill {args.batch}x{args.prompt_len} in {t_pre:.1f}ms; "
          f"decoded {args.decode} tokens in {t_dec:.1f}ms "
          f"({args.batch * args.decode / max(t_dec / 1e3, 1e-9):.1f} tok/s) "
          f"on {device}")
    if stream is not None:
        print(stream.report(args.decode))
    if args.requests > 1:
        # multi-tenant accounting: N requests of this model contending
        # for one shared pool (pure simulation — rides the same clock
        # as the single-stream report above)
        spec = ModelSpec.from_params(args.arch, params, batch=args.batch)
        pool = max(int(spec.total_bytes * args.svm_budget_frac), 1)
        plan = None
        if args.chaos:
            plan = FaultPlan.default(args.chaos_seed,
                                     n_requests=args.requests,
                                     tokens=args.decode,
                                     intensity=args.chaos_intensity)
        sched = run_schedule(
            [spec], args.requests, pool, policy=args.sched_policy,
            admit_by=args.admit_by,
            seed=0, mean_interarrival_s=args.arrival,
            tokens=args.decode, evict_policy=args.svm_policy,
            fault_plan=plan, thrash_watermark=args.thrash_watermark)
        print(schedule_report(sched))
    print("first request continuation:", seq[0].tolist())


if __name__ == "__main__":
    main()
