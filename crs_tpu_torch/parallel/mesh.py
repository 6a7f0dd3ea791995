"""Device meshes of the port (counterpart of ``crs_tpu.parallel.mesh``).

``crs_tpu`` threads one ``jax.sharding.Mesh`` through index build and query
and leaves the collectives to ``shard_map`` / GSPMD. The port runs SPMD
over ``torch.distributed``, one process per device: every rank runs the same
program on the same host inputs, keeps only its own shard on its own device,
and calls the collectives itself. A mesh is a
``torch.distributed.device_mesh.DeviceMesh``; a single device is the mesh
of size 1, with no separate code path (its collectives run over a one-rank
group).

A mesh constructor called before any process group exists, and without a
launcher's environment (``torchrun`` sets ``RANK`` / ``WORLD_SIZE``),
creates a one-rank group over a ``FileStore`` in a temporary directory: one
card needs no launcher. ``n`` cards run under ``torchrun --nproc-per-node n``
(NCCL); rank r uses ``cuda:{LOCAL_RANK}``. The CPU (gloo) is used only when
the caller asks for ``device="cpu"``. A failed NCCL set-up raises; nothing
falls back to gloo or to the CPU.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["corpus_mesh", "shard_rows", "replicate", "initialize_multihost", "mesh_device"]

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _rank_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The rank's device: ``cuda:{LOCAL_RANK}`` unless the CPU is asked for
    (a request for the card without one raises, through ``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: Optional[Union[str, torch.device]] = None) -> int:
    """``dist.init_process_group`` from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``, ``LOCAL_RANK``) or
    from the arguments (``coordinator_address`` an init method such as
    ``tcp://host:port`` or ``file:///path``). NCCL on the card, gloo when the
    caller asks for ``device="cpu"``. Returns the world size; a single
    process with no coordinator and no launcher is a no-op returning 1, as
    in ``crs_tpu``. An existing group is kept."""
    if dist.is_initialized():
        return dist.get_world_size()
    launched = all(k in os.environ for k in _LAUNCHER_ENV)
    if num_processes in (None, 1) and coordinator_address is None and not launched:
        return 1
    dev = _rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {}
    if not launched or coordinator_address is not None:
        kwargs = {"init_method": coordinator_address, "world_size": num_processes,
                  "rank": process_id}
    dist.init_process_group(_backend(dev), **kwargs)
    return dist.get_world_size()


def _ensure_group(dev: torch.device) -> None:
    """A process group for the mesh constructors: torchrun's when launched, else
    a one-rank group over a FileStore in a temporary directory."""
    if dist.is_initialized():
        return
    if initialize_multihost(device=dev) > 1 or dist.is_initialized():
        return
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tmp = tempfile.mkdtemp(prefix="crs_tpu_torch_group_")
    atexit.register(shutil.rmtree, tmp, True)
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    dist.init_process_group(_backend(dev), store=store, rank=0, world_size=1)


def corpus_mesh(num_devices: Optional[int] = None, axis_name: str = "corpus",
                device: Optional[Union[str, torch.device]] = None):
    """A 1-D ``DeviceMesh`` named ``axis_name`` over the first
    ``num_devices`` ranks (default: all of them). Every rank calls it; a
    rank outside the mesh gets a mesh it is not part of."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = _rank_device(device)
    _ensure_group(dev)
    world = dist.get_world_size()
    num = world if num_devices is None else int(num_devices)
    if not 1 <= num <= world:
        raise ValueError(f"a mesh of {num} devices in a world of {world}")
    return DeviceMesh(dev.type, list(range(num)), mesh_dim_names=(axis_name,))


def mesh_device(mesh) -> torch.device:
    """This rank's device in ``mesh``: ``cuda:{current}`` or the CPU."""
    if mesh.device_type == "cuda":
        return resolve_device(torch.device("cuda", torch.cuda.current_device()))
    return torch.device("cpu")


def _as_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.ascontiguousarray(arr))


def shard_rows(arr, mesh, axis_name: str = "corpus") -> torch.Tensor:
    """This rank's rows of ``arr`` (host or device; the leading axis a
    multiple of the axis size) on the rank's device."""
    t = _as_tensor(arr)
    num, r = dist.get_world_size(mesh.get_group(axis_name)), mesh.get_local_rank(axis_name)
    if t.shape[0] % num:
        raise ValueError(f"{t.shape[0]} rows do not split over {num} devices")
    per = t.shape[0] // num
    return t[r * per:(r + 1) * per].to(mesh_device(mesh)).contiguous()


def replicate(arr, mesh) -> torch.Tensor:
    """A full copy of ``arr`` on this rank's device."""
    return _as_tensor(arr).to(mesh_device(mesh))
