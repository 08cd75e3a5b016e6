"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``build/repro_torch_kernels/<digest>/lib<name>.so`` under the
repository root, where ``<digest>`` hashes every source and the flags, so
an edited kernel builds anew and an unchanged one is loaded as it is. All
missing libraries are built at once, one ``nvcc`` process each. Nothing is
built when this module is imported: the CPU tests import it on machines
that have no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("matmul", "flash_attention", "flash_attention_bwd", "mamba_scan",
           "mamba_scan_bwd", "triad", "jacobi2d")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the repro_torch CUDA kernels")


def build_all() -> Path:
    """Compile every kernel whose library is missing, in parallel; return
    the build directory. Raises with the compiler's output on failure."""
    out = build_dir()
    todo = [n for n in KERNELS if not (out / f"lib{n}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out / f"lib{name}.so")  # atomic: no half-written library
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
    return _loaded[name]


def ptxas_report() -> str:
    """The register, shared-memory and spill lines ``ptxas -v`` printed
    for each kernel of the current build, and any warning that it
    serialised a wgmma pipeline or set setmaxnreg aside ('' for a kernel
    built by another run)."""
    lines = []
    for name in KERNELS:
        log = build_dir() / f"{name}.log"
        if log.exists():
            lines += [f"{name}: {ln.strip()}" for ln in log.read_text().splitlines()
                      if any(w in ln for w in ("entry function", "registers",
                                                 "spill", "wgmma",
                                                 "setmaxnreg"))]
    return "\n".join(lines)
