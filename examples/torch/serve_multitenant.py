"""Multi-tenant serving over one shared SVM pool: 8 concurrent decode
requests of two (reduced) architectures contend for a device pool that
holds barely more than one model, under each scheduling policy.

  * fifo       — admit everything, round-robin: the paper's thrashing
                 pathology multiplied by N tenants.
  * admission  — cap admitted working-set bytes at the pool watermark;
                 later arrivals queue.
  * svm_aware  — admission + per-request hot-leaf pinning + same-arch
                 token batching (shared compiled-segment replays).

Same-architecture requests replay one shared compiled per-token segment
(relocated to each tenant's range offsets) — the `shared` column counts
those cross-request replays.

    PYTHONPATH=src python examples/torch/serve_multitenant.py [--device cpu]

The port's copy of ``examples/serve_multitenant.py``: the tenants' params
are made on the card (``--device cpu``: on the CPU), and the schedule runs
on the simulated clock with the H100 preset's rates.

``--scale`` swaps the 8-request tour for the fused-round tier at serving
scale: 256 requests through one pool (whole scheduler rounds concatenate
into a single batched engine pass), timed against the per-token reference
replay, plus the oscillating hot-set adversary from `repro.core.traces`
driven through the sweep tier at the same pool capacity.

    PYTHONPATH=src python examples/torch/serve_multitenant.py --scale
"""

import argparse
import dataclasses
import time

from repro_torch.configs import get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.svm import ModelSpec, PoolScheduler, make_requests


def tiny(arch: str, n_layers: int, d_model: int, d_ff: int, device):
    cfg = dataclasses.replace(get_reduced(arch), n_layers=n_layers,
                              d_model=d_model, d_ff=d_ff)
    return init_params(cfg, seed=0, device=device)


def scale(device) -> None:
    """256-request fused-round demo + oscillating hot-set sweep row."""
    from repro_torch.core.sweep import hotset_grid, run_point

    specs = [
        ModelSpec.from_params("gemma3-1b",
                              tiny("gemma3-1b", 6, 128, 512, device),
                              batch=4),
        ModelSpec.from_params("granite-3-2b",
                              tiny("granite-3-2b", 8, 192, 768, device),
                              batch=4),
    ]
    # a pool that admits a few dozen tenants at once: fused rounds win by
    # batching many per-token segments into one engine pass, so the demo
    # needs real concurrency (the bench's ≥512-request config shows ≥3x;
    # this stays CI-smoke-fast).  Burst arrival keeps rounds maximal —
    # pending arrivals would split svm_aware rounds into unit blocks
    # (correct, but nothing left to fuse)
    cap = int(max(s.total_bytes for s in specs) * 16)
    reqs = make_requests(specs, 256, seed=11, tokens=12, token_jitter=3,
                         arrival="burst", spec_choice="roundrobin")
    print(f"fused round tier: 256 requests, pool {cap / 1e6:.1f}MB")
    rows = {}
    for fused in (True, False):
        sched = PoolScheduler(cap, policy="svm_aware", pin_frac=0.4,
                              fused=fused)
        t0 = time.perf_counter()
        r = sched.run([dataclasses.replace(q) for q in reqs])
        rows[fused] = (r, time.perf_counter() - t0)
    r, dt = rows[True]
    _, dt_ref = rows[False]
    same = all(rows[True][0][k] == rows[False][0][k]
               for k in ("latency_p99_s", "migrations", "evictions",
                         "evict_to_mig", "agg_tok_s"))
    sc = r["shared_cache"]
    print(f"  fused {dt * 1e3:7.1f}ms vs per-token {dt_ref * 1e3:7.1f}ms "
          f"({dt_ref / dt:.2f}x), byte-identical: {same}")
    print(f"  p50/p99 {r['latency_p50_s'] * 1e3:.1f}/"
          f"{r['latency_p99_s'] * 1e3:.1f}ms, agg {r['agg_tok_s']:.0f} "
          f"tok/s, {sc['shared_concats']} round concats, "
          f"{sc['shared_relocations']} relocations\n")

    # the phase-change adversary at the same capacity: each phase flips
    # the hot set between the two halves of the allocation, so residency
    # built in one phase is dead weight in the next (``run_point``'s
    # default cost model, as in the reference)
    pt = hotset_grid(int(cap * 2), [cap], modes=("oscillating",),
                     ops=20_000, seed=11)[0]
    row = run_point(pt)
    print(f"oscillating hot-set ({row['workload']}, DOS "
          f"{row['dos']:.0f}%): {row['migrations']} migs / "
          f"{row['evictions']} evicts, e2m {row['evict_to_mig']:.2f}, "
          f"wall {row['wall_s'] * 1e3:.1f}ms")


def tour(device) -> None:
    """The 8-request tour: each policy over one pool."""
    specs = [
        ModelSpec.from_params("gemma3-1b",
                              tiny("gemma3-1b", 6, 128, 512, device),
                              batch=4),
        ModelSpec.from_params("granite-3-2b",
                              tiny("granite-3-2b", 8, 192, 768, device),
                              batch=4),
    ]
    # pool: slightly smaller than the larger model — the big arch is
    # individually oversubscribed (svm_aware's pinning regime), small-arch
    # pairs fit, and the full 8-request mix offers ~450 % DOS
    cap = int(max(s.total_bytes for s in specs) * 0.9)
    offered = sum(specs[i % 2].total_bytes for i in range(8))
    print(f"pool {cap / 1e6:.1f}MB; 8 requests "
          f"({specs[0].total_bytes / 1e6:.1f}MB gemma-ish / "
          f"{specs[1].total_bytes / 1e6:.1f}MB granite-ish), "
          f"offered DOS {offered / cap * 100:.0f}%\n")

    print(f"  {'policy':10s} {'p50':>8s} {'p99':>8s} {'tok/s':>7s} "
          f"{'ev/tok':>7s} {'e2m':>5s} {'hit%':>5s} {'shared':>6s}")
    rows = []
    for policy in ("fifo", "admission", "svm_aware"):
        sched = PoolScheduler(cap, policy=policy, pin_frac=0.4)
        reqs = make_requests(specs, 8, seed=3, mean_interarrival_s=0.01,
                             tokens=16, spec_choice="roundrobin")
        r = sched.run(reqs)
        rows.append(r)
        print(f"  {policy:10s} {r['latency_p50_s'] * 1e3:7.1f}ms "
              f"{r['latency_p99_s'] * 1e3:7.1f}ms {r['agg_tok_s']:7.0f} "
              f"{r['evictions_per_token']:7.2f} {r['evict_to_mig']:5.2f} "
              f"{r['segment_hit_rate'] * 100:5.1f} "
              f"{r['segment_shared_hits']:6d}")

    fifo, aware = rows[0], rows[-1]
    print(f"\nsvm_aware vs fifo: "
          f"{fifo['evictions_per_token'] / aware['evictions_per_token']:.2f}x "
          f"fewer evictions/token, "
          f"{fifo['latency_p99_s'] / aware['latency_p99_s']:.2f}x lower "
          f"p99 latency (admission keeps the pool below the thrashing "
          f"cliff; pinning + shared segment replays do the rest)")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", action="store_true",
                    help="256-request fused-round tier + oscillating "
                         "hot-set adversary (CI-smoke-fast)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.scale:
        scale(device)
    else:
        tour(device)


if __name__ == "__main__":
    main()
