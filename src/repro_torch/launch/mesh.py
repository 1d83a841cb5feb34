"""Mesh construction (port of ``repro.launch.mesh``).

Single pod:  (data=16, model=16) = 256 ranks.
Multi-pod:   (pod=2, data=16, model=16) = 512 ranks; the 'pod' axis is pure
data parallelism with compressed gradient sync (optim/compression).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
over the process group the caller initialised
(``torch.distributed.init_process_group``, one rank per device): ``nccl``
for a CUDA mesh, ``gloo`` for a CPU mesh; the fake backend of
``launch/dryrun`` stands in for a world of any size.  A CUDA mesh on any
backend but ``nccl`` raises: nothing falls back to the CPU.  Functions,
not module constants: importing this module touches no process group.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.launch.device import resolve_device


def _device_type(device) -> str:
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group first (one rank per device)")
    backend = dist.get_backend()
    want = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in (want, "fake"):
        raise RuntimeError(f"a {dev.type} mesh needs the {want} backend; "
                           f"this world runs {backend}")
    return dev.type


def make_production_mesh(*, multi_pod: bool = False, device=None
                         ) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    dev_type = _device_type(device)
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {world} — run under "
            "launch/dryrun.py (a fake process group of any size)")
    if world == n:
        return init_device_mesh(dev_type, shape, mesh_dim_names=axes)
    return DeviceMesh(dev_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), device=None
                    ) -> DeviceMesh:
    """Small mesh over the whole initialised world (its size must be the
    product of ``shape``): 4 ``gloo`` ranks on the CPU in the tests, one
    ``nccl`` rank with ``(1, 1)`` on one card."""
    dev_type = _device_type(device)
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise RuntimeError(f"mesh {tuple(shape)} needs a world of {n} "
                           f"ranks, this one has {dist.get_world_size()}")
    return init_device_mesh(dev_type, tuple(shape), mesh_dim_names=axes)
