"""SVM UM-management cost model (paper §2.4, Fig. 3 & 5).

Five host-visible cost terms per host→device range migration:

  cpu_unmap   — collect + unmap host pages (HMM page-table walk)
  SDMA_setup  — create SDMA mappings, issue copy/map/update commands;
                absorbs most of the async SDMA copy (overlapped issue)
  alloc       — allocate device VRAM; **absorbs eviction cost** when the
                device is full (the paper's dominant term under
                oversubscription)
  cpu_update  — update host page table with new mappings
  misc        — page metadata migration, non-overlapped SDMA copy tail,
                free copy mappings

Calibration targets (paper §2.4, DOS < 100, large ranges):
  * cpu_update is the largest single term,
  * cpu_update + SDMA_setup + alloc ≈ 76 % of total,
  * pure data movement (inside SDMA_setup/misc) < 50 % of total
    (≈ 36 % here for a 1 GB range on the 36 GB/s MI250X host link).

Eviction "comprises all other items in the opposite direction" — modelled as
a full migration-shaped cost for the victim range, charged to the triggering
migration's `alloc` term (paper §2.4: alloc "includes the cost of eviction").

Terms are (fixed + per-page) affine so small ranges are latency-bound and
large ranges bandwidth-bound, reproducing Fig. 5's linear segments.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.ranges import PAGE

TERMS = ("cpu_unmap", "sdma_setup", "alloc", "cpu_update", "misc")


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Affine per-term costs: seconds = fixed + per_page * npages (+copy)."""

    # fixed per-migration latencies (seconds)
    fix_cpu_unmap: float = 8e-6
    fix_sdma_setup: float = 12e-6
    fix_alloc: float = 6e-6
    fix_cpu_update: float = 10e-6
    fix_misc: float = 6e-6
    # per-4KB-page management costs (seconds/page)
    pp_cpu_unmap: float = 0.0408e-6
    pp_sdma_setup: float = 0.0015e-6
    pp_alloc: float = 0.0686e-6
    pp_cpu_update: float = 0.0877e-6
    pp_misc: float = 0.0004e-6
    # host<->device link bandwidth (bytes/s, one direction)
    link_bw: float = 36e9
    # split of raw copy time between SDMA_setup (issue-overlapped) and misc
    copy_in_sdma: float = 0.70
    # zero-copy remote access latency per cacheline-batch (s) and batch bytes
    zerocopy_lat: float = 1.5e-6
    zerocopy_batch: int = 4096

    def copy_time(self, nbytes: int) -> float:
        return nbytes / self.link_bw


# The paper's experimental node: MI250X GCD, 36 GB/s bidir Infinity Fabric.
MI250X = CostParams()

# NVIDIA H100 80GB HBM3, 700.00 W (nvidia-smi name and power limit), PCIe
# to its host. ``link_bw`` is the pinned host-to-device copy rate that
# ``chip_smoke.py`` measures (1 GiB pinned, ``.to("cuda",
# non_blocking=True)``, CUDA events, median of 5): 54.716 GB/s (pageable:
# 5.40 GB/s). Every other term is the paper's. The streaming executor's
# default cost model.
H100_HOST = CostParams(link_bw=54.716e9)

# The streaming executor's default serving compute rate (flops/s) on the
# same card (NVIDIA H100 80GB HBM3, 700.00 W): gemma3-1b's decode flops
# as the weight stream counts them (2 x batch x params a token, batch 4:
# 7.9985 GFLOP) over the decode step's device-busy time under
# torch.profiler (5.707 ms a token), measured by ``chip_smoke.py``.
H100_SERVE_FLOPS = 1.4015e12


@dataclasses.dataclass
class CostVector:
    """Accumulated per-term costs (seconds)."""

    cpu_unmap: float = 0.0
    sdma_setup: float = 0.0
    alloc: float = 0.0
    cpu_update: float = 0.0
    misc: float = 0.0

    def total(self) -> float:
        return (self.cpu_unmap + self.sdma_setup + self.alloc
                + self.cpu_update + self.misc)

    def add(self, other: "CostVector") -> None:
        self.cpu_unmap += other.cpu_unmap
        self.sdma_setup += other.sdma_setup
        self.alloc += other.alloc
        self.cpu_update += other.cpu_update
        self.misc += other.misc

    def as_dict(self) -> dict[str, float]:
        return {t: getattr(self, t) for t in TERMS}


def migration_cost(nbytes: int, p: CostParams) -> CostVector:
    """Host→device migration of one range (no eviction)."""
    npages = -(-nbytes // PAGE)
    copy = p.copy_time(nbytes)
    return CostVector(
        cpu_unmap=p.fix_cpu_unmap + p.pp_cpu_unmap * npages,
        sdma_setup=(p.fix_sdma_setup + p.pp_sdma_setup * npages
                    + copy * p.copy_in_sdma),
        alloc=p.fix_alloc + p.pp_alloc * npages,
        cpu_update=p.fix_cpu_update + p.pp_cpu_update * npages,
        misc=p.fix_misc + p.pp_misc * npages + copy * (1.0 - p.copy_in_sdma),
    )


def eviction_cost(nbytes: int, p: CostParams) -> float:
    """Device→host eviction of one range = migration-shaped, opposite
    direction (paper §2.2). Returned as a scalar: the caller charges it to
    the triggering migration's `alloc` term (paper §2.4)."""
    return migration_cost(nbytes, p).total()


def zerocopy_cost(nbytes: int, p: CostParams) -> float:
    """Remote (host-pinned) access cost for `nbytes` at cacheline-batch
    granularity (paper §4.2 zero-copy)."""
    batches = -(-nbytes // p.zerocopy_batch)
    return batches * p.zerocopy_lat + p.copy_time(nbytes) * 0.5
