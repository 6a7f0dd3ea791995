"""Loading and launching the port's CUDA kernels outside the scans.

Each source in ``csrc/`` is one shared library with a plain C interface: a
``<kernel>_launch`` function per kernel that enqueues it on the given stream
and returns the CUDA error code. The library is built at first use
(``_build.build_cuda``) and bound with ``ctypes``. A wrapper counts a launch
only after its launcher returned 0. Scratch that a kernel keeps between its
blocks (partial sums, self-resetting counters) is allocated once per device
and stream and grown when a call needs more (:func:`scratch`).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Sequence

import torch

__all__ = ["KernelStats", "load_library", "stream_handle", "check_operands", "launch",
           "scratch", "sm_count", "ARG_INT", "ARG_PTR", "ARG_FLOAT"]

ARG_INT, ARG_PTR, ARG_FLOAT = ctypes.c_int, ctypes.c_void_p, ctypes.c_float


class KernelStats:
    """Per-process launch counts, in all and by kernel."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.launches = 0
        self.by_kernel: Dict[str, int] = {}

    def count_launch(self, kernel: str) -> None:
        self.launches += 1
        self.by_kernel[kernel] = self.by_kernel.get(kernel, 0) + 1


_libs: Dict[str, ctypes.CDLL] = {}


def load_library(source: str, launchers: Dict[str, Sequence],
                 restypes: Optional[Dict[str, type]] = None) -> ctypes.CDLL:
    """The built library of ``source`` (one of ``_build.CUDA_SOURCES``) with
    each function of ``launchers`` {name: argument types} typed; it returns
    an int unless ``restypes`` names its type."""
    lib = _libs.get(source)
    if lib is None:
        from .._build import build_cuda

        lib = ctypes.CDLL(build_cuda(source).path)
        for name, argtypes in launchers.items():
            fn = getattr(lib, name)
            fn.restype = (restypes or {}).get(name, ctypes.c_int)
            fn.argtypes = list(argtypes)
        _libs[source] = lib
    return lib


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_sm_counts: Dict[int, int] = {}


def sm_count(dev: torch.device) -> int:
    """The card's number of streaming multiprocessors."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


_scratch: Dict[tuple, torch.Tensor] = {}


def scratch(dev: torch.device, stream: int, name: str, numel: int, dtype: torch.dtype,
            zero: bool = False) -> torch.Tensor:
    """A flat buffer of at least ``numel`` elements kept for (device, stream,
    name) and reused by every later call: no allocation or memset on the hot
    path. ``zero`` buffers (the kernels' counters) are zeroed when they are
    allocated, and the kernels leave them zero. Work on one stream is
    ordered, so reuse there is safe; another stream gets its own buffer."""
    key = (dev, stream, name)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < numel or buf.dtype != dtype:
        make = torch.zeros if zero else torch.empty
        buf = _scratch[key] = make((max(numel, 1),), dtype=dtype, device=dev)
    return buf


def check_operands(dev: torch.device, *specs) -> None:
    """Each spec is (name, tensor, dtype): on ``dev``, of ``dtype``,
    contiguous and 16-byte aligned — what every kernel takes."""
    for name, t, dtype in specs:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def launch(stats: KernelStats, kernel: str, fn: Callable[..., int], *args) -> None:
    """Call a launcher; raise on a non-zero CUDA error, count it otherwise."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    stats.count_launch(kernel)
