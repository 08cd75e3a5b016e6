"""Roofline analysis over dry-run rows, on the H100's figures — the port
of ``repro.launch.roofline``.

    compute term    = FLOPs per device / peak_FLOP/s
    memory term     = analytic HBM bytes per device / HBM_bw
    collective term = sum over mesh axes of the axis' collective bytes
                      per device / the slowest link the axis spans

The dry run's rows count per device (``launch/dryrun.py``), so the terms
divide by one card's rates.

The figures, for an H100 SXM5 in 8-GPU nodes (DGX H100 / HGX H100):

  * ``PEAK_FLOPS`` 989e12: dense bf16 tensor-core FLOP/s (NVIDIA H100
    Tensor Core GPU data sheet, SXM column, without sparsity);
  * ``HBM_BW`` 3.35e12 B/s: HBM3 (same data sheet, SXM);
  * ``NVLINK_BW`` 450e9 B/s: NVLink 4 each way, of the 900e9 a GPU has
    in all (same data sheet), between the GPUs of one node;
  * ``IB_BW`` 50e9 B/s: one 400 Gb/s ConnectX-7 port a GPU (NVIDIA DGX
    H100 data sheet), between nodes.

A mesh axis takes the slowest link its ranks span. Ranks are laid out
with the last mesh axis innermost, ``GPUS_PER_NODE`` to a node: an axis
stays inside one node when its stride times its size is at most 8. On
the production meshes every axis has 16 ranks or a stride of 16, so
each spans at least two nodes and takes ``IB_BW``: "model" (16
consecutive ranks: two nodes), "data" (stride 16: sixteen nodes) and
"pod" (stride 256). Only a mesh whose axis fits in one node (a "model"
axis of 8 or fewer) reaches NVLink's rate. A row without the per-axis
split (the reference's rows) puts all its bytes on ``IB_BW``.

``roofline_terms``, ``load_rows``, ``analyze`` and ``main`` keep the
reference's names, outputs and clamping; the figures are keyword
parameters whose defaults are the H100's.
"""

from __future__ import annotations

import json
import math

PEAK_FLOPS = 989e12        # bf16 dense, H100 SXM
HBM_BW = 3.35e12           # bytes/s, H100 SXM HBM3
NVLINK_BW = 450e9          # bytes/s each way, NVLink 4, inside a node
IB_BW = 50e9               # bytes/s, one 400 Gb/s ConnectX-7 port a GPU
GPUS_PER_NODE = 8


def link_bw(axes, sizes: dict[str, int], *, nvlink_bw: float = NVLINK_BW,
            ib_bw: float = IB_BW, gpus_per_node: int = GPUS_PER_NODE
            ) -> float:
    """The rate of the slowest link that a collective over ``axes`` of a
    mesh of ``sizes`` (in mesh order, the last axis innermost) crosses:
    NVLink when every rank it joins sits in one node, else the node's
    network port."""
    names = list(sizes)
    span = 1
    for a in axes:
        stride = math.prod(sizes[b] for b in names[names.index(a) + 1:])
        span = max(span, stride * sizes[a])
    return nvlink_bw if span <= gpus_per_node else ib_bw


def _collective_seconds(row: dict, **links) -> float:
    """Each axis' bytes over its link; a row without the per-axis split
    (the reference's) puts every byte on the slowest link."""
    coll = row.get("collectives", {})
    if "by_axis" not in coll:
        return coll.get("effective_bytes_per_device", 0.0) / links["ib_bw"]
    return sum(v["effective_bytes_per_device"]
               / link_bw(tuple(ax.split("+")), row["axis_sizes"], **links)
               for ax, v in coll["by_axis"].items())


def roofline_terms(row: dict, chips: int, *, peak_flops: float = PEAK_FLOPS,
                   hbm_bw: float = HBM_BW, nvlink_bw: float = NVLINK_BW,
                   ib_bw: float = IB_BW,
                   gpus_per_node: int = GPUS_PER_NODE) -> dict:
    """Three roofline terms (seconds) for one dry-run row.

    compute   — FLOPs per device: the row's ``flops_per_device`` (the
                port's dry run: analytic) or ``hlo_flops_per_device``
                (the reference's rows);
    memory    — fused-traffic analytic model: the row's own
                ``analytic_bytes_per_device`` where it has one, else
                ``analytic.analytic_bytes_per_device`` of its cell (a
                row's ``hlo_bytes_per_device``, where present, is an
                unfused upper bound reported as t_memory_hlo_upper_s);
    collective— per-device collective bytes, each mesh axis over its
                link (``link_bw``).
    """
    flops_dev = row.get("flops_per_device",
                        row.get("hlo_flops_per_device", 0.0))
    bytes_hlo = row.get("hlo_bytes_per_device", 0.0)
    coll_dev = row.get("collectives", {}).get(
        "effective_bytes_per_device", 0.0)
    bytes_dev = row.get("analytic_bytes_per_device")
    try:
        from repro_torch.launch.analytic import (
            analytic_bytes_per_device,
            analytic_flops_global,
        )
        if bytes_dev is None:
            bytes_dev = analytic_bytes_per_device(row["arch"], row["shape"])
        flops_check = analytic_flops_global(row["arch"], row["shape"])
    except Exception:  # noqa: BLE001 — paper-workload rows have no arch
        bytes_dev = bytes_hlo if bytes_dev is None else bytes_dev
        flops_check = 0.0
    t_compute = flops_dev / peak_flops
    t_memory = bytes_dev / hbm_bw
    # a negative collective figure (the reference's depth differencing can
    # give one) is clamped and flagged instead of reported as a term
    nonlinear = coll_dev < 0
    links = dict(nvlink_bw=nvlink_bw, ib_bw=ib_bw,
                 gpus_per_node=gpus_per_node)
    t_collective = 0.0 if nonlinear else _collective_seconds(row, **links)
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_collective)),
        key=lambda kv: kv[1])[0]
    model = row.get("model_flops_global", 0.0)
    hlo_global = flops_dev * chips
    bound = max(t_compute, t_memory, t_collective)
    ideal = (model / chips) / peak_flops if chips else 0.0
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_memory_hlo_upper_s": bytes_hlo / hbm_bw,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "collective_nonlinear_flag": nonlinear,
        "model_flops_global": model,
        "hlo_flops_global": hlo_global,
        "analytic_flops_global": flops_check,
        "useful_flops_ratio": model / hlo_global if hlo_global else 0.0,
        # fraction of the compute roofline achievable if the dominant term
        # were the only cost (upper-bounds MFU for this program)
        "roofline_fraction": (ideal / bound) if bound else 0.0,
        # resource-aware fraction: the fundamental lower bound is the max of
        # ideal compute time and minimal memory time (weights+cache must
        # stream once) — the right score for memory-bound decode cells
        "fraction_resource": (max(ideal, t_memory) / bound) if bound else 0.0,
    }


def load_rows(path: str) -> list[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def analyze(path: str, mesh: str = "16x16", **figures) -> list[dict]:
    chips = 512 if mesh == "2x16x16" else 256
    out = []
    for row in load_rows(path):
        if row.get("mesh") != mesh:
            continue
        entry = {k: row.get(k) for k in ("arch", "shape", "mesh", "status")}
        if row.get("status") == "ok":
            entry.update(roofline_terms(row, chips, **figures))
        elif row.get("status") == "skipped":
            entry["reason"] = row.get("reason")
        else:
            entry["error"] = row.get("error")
        out.append(entry)
    return out


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    for e in analyze(args.path, args.mesh):
        print(json.dumps(e))


if __name__ == "__main__":
    main()
