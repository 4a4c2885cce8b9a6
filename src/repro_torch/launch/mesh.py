"""Device meshes (port of ``repro.launch.mesh``).

Single pod: (16, 16) ("data", "model") = 256 ranks.
Multi-pod:  (2, 16, 16) ("pod", "data", "model") = 512 ranks.

Functions, not module constants, so importing this module starts no
process group.  ``make_production_mesh`` builds its mesh over the world
that is running: the dry run first starts a ``fake`` world of 256 or 512
ranks on one host (:func:`start_fake_world`; its collectives move
nothing), as the JAX dry run sets its device count before JAX starts.
``make_host_mesh`` builds a small mesh over the world there is, starting
a world of one when none is running.
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist


def production_shape(multi_pod: bool = False):
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def start_fake_world(world_size: int, rank: int = 0) -> None:
    """A process group of ``world_size`` ranks in this one process, on
    the ``fake`` backend: DTensors give rank ``rank``'s shapes and the
    collectives return at once (nothing is moved)."""
    # registers the "fake" backend
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        raise RuntimeError(f"a world of {dist.get_world_size()} ranks is "
                           f"running; the fake world needs {world_size}")
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cpu"):
    """The production mesh over the first 256 or 512 ranks of the running
    world (:func:`start_fake_world` for a dry run; the JAX dry run
    likewise forces 512 devices and meshes the first 256 for one pod)."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = production_shape(multi_pod)
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(device, torch.arange(n).view(shape),
                      mesh_dim_names=axes)


def _start_world_of_one(device_type: str) -> None:
    backend = "nccl" if device_type == "cuda" else "gloo"
    path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
    dist.init_process_group(backend, store=dist.FileStore(path, 1), rank=0,
                            world_size=1)


def make_host_mesh(n_data: int = None, n_model: int = 1,
                   axes=("data", "model"), device=None):
    """A small ``(n_data, n_model)`` mesh over the running world: NCCL on
    ``cuda`` (the default), gloo on ``cpu``.  With no process group
    running it starts a world of one from a ``FileStore`` in a temporary
    directory."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch._device import resolve_device
    dev = resolve_device(device)
    if not dist.is_initialized():
        _start_world_of_one(dev.type)
    n = dist.get_world_size()
    n_data = n_data or (n // n_model)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, (n_data, n_model),
                            mesh_dim_names=tuple(axes))


def close_world() -> None:
    """Destroy the running process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def check_mesh(mesh) -> None:
    """Entry points take ``None`` or a ``DeviceMesh``."""
    from torch.distributed.device_mesh import DeviceMesh
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh (launch.mesh."
                        f"make_host_mesh), not {type(mesh).__name__}")
