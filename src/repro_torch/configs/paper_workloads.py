"""The paper's own workload suite (Table 2) as a selectable config set,
mirroring the architecture registry so benchmarks and examples can
enumerate them uniformly.

It holds the paper's eight workloads. ``WORKLOADS`` also registers
``hotset``, a synthetic hot-set adversary beyond the paper, which this
table leaves out."""

from __future__ import annotations

import dataclasses

from repro_torch.core import GB
from repro_torch.core.traces import WORKLOADS, make_workload


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    name: str
    description: str
    domain: str
    category: str          # paper §3.1 category at oversubscription
    svm_aware_variant: bool


PAPER_WORKLOADS = {
    "stream": WorkloadConfig(
        "stream", "Triad-only scaled dot product of two vectors",
        "Synthetic", "I", False),
    "conv2d": WorkloadConfig(
        "conv2d", "Full 2-D convolution with varying weights",
        "Machine Learning", "I", False),
    "jacobi2d": WorkloadConfig(
        "jacobi2d", "Forward/backward adjacent convolution, equal weights",
        "Machine Learning", "II", True),
    "bfs": WorkloadConfig(
        "bfs", "Breadth-first traversal from a random start node",
        "Graph Traversal", "I", False),
    "syr2k": WorkloadConfig(
        "syr2k", "Symmetric rank-2k update", "Linear Algebra", "III", False),
    "sgemm": WorkloadConfig(
        "sgemm", "General matrix-matrix product", "Linear Algebra", "III",
        True),
    "mvt": WorkloadConfig(
        "mvt", "Matrix-vector then matrix-transpose-vector product",
        "Linear Algebra", "III", False),
    "gesummv": WorkloadConfig(
        "gesummv", "Sum of two scaled matrix-vector products",
        "Linear Algebra", "III", False),
}

DEFAULT_CAPACITY = 8 * GB


def build(name: str, dos: float, capacity: int = DEFAULT_CAPACITY, **kw):
    """Instantiate a paper workload at a target degree of oversubscription."""
    if name not in PAPER_WORKLOADS:
        raise ValueError(
            f"unknown paper workload {name!r}; have {sorted(PAPER_WORKLOADS)}")
    return make_workload(name, int(capacity * dos / 100.0), **kw)


assert set(PAPER_WORKLOADS) == set(WORKLOADS) - {"hotset"}, \
    "registry drift"
