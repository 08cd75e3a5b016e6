"""Device meshes — port of ``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dims carry
the reference's axis names: ("data", "model"), and ("pod", "data",
"model") across pods. ``pod`` composes with ``data`` for data
parallelism, ZeRO and FSDP; ``model`` carries tensor parallelism
(``launch/sharding.py``).

Importing this module starts no process group. A mesh of one rank starts
the default group itself when there is none (on a ``HashStore``, so no
port is opened), and then owns it: ``close_mesh`` destroys what the mesh
started, so that a second launcher run in one process starts clean. A
larger mesh needs the group its ranks were started with, and a world of
another size raises ``ValueError``, as ``jax.make_mesh`` does on a host
without the devices.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def _make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device):
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(device)
    need = math.prod(shape)
    owns = not dist.is_initialized()
    world = 1 if owns else dist.get_world_size()
    if world != need:
        raise ValueError(f"a {shape} mesh over {axes} needs {need} ranks; "
                         f"the world has {world}")
    if owns:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh(device.type, shape, mesh_dim_names=axes)
    except BaseException:
        if owns:
            dist.destroy_process_group()
        raise
    mesh.owns_world_group = owns
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The (16, 16) mesh over ("data", "model"), or (2, 16, 16) over
    ("pod", "data", "model") with ``multi_pod``: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_host_mesh(device):
    """A 1 x 1 mesh over ("data", "model") on ``device`` (same axis names):
    the mesh of one process, as the CPU tests, the examples and the card
    run it."""
    return _make_mesh((1, 1), ("data", "model"), device)


def close_mesh(mesh) -> None:
    """Destroy the default process group if making ``mesh`` started it."""
    if getattr(mesh, "owns_world_group", False) and dist.is_initialized():
        dist.destroy_process_group()
        mesh.owns_world_group = False


def data_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (pod composes with data)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: ranks along it}."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_size(mesh) -> int:
    """Ranks along the data-parallel axes together."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh))
