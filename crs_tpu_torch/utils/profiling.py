"""Profiling helpers (port of ``crs_tpu.utils.profiling``).

``timed`` and ``device_timer`` read the host clock and fence with
``torch.cuda.synchronize`` on the CUDA devices of the work's outputs (or
the device given), so queued kernels count; ``capture_trace`` runs a
callable under ``torch.profiler`` (CPU and, with a card, CUDA activity)
and writes a Chrome trace, viewable in Perfetto, into ``trace_dir``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Union

import torch

logger = logging.getLogger(__name__)

__all__ = ["device_timer", "capture_trace", "timed", "fence_outputs"]


def _cuda_devices(out: Any, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


def fence_outputs(out: Any) -> Any:
    """Wait for the CUDA devices that hold a tensor of ``out`` (tensors,
    or lists, tuples and dicts of them); returns ``out``."""
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)
    return out


@contextlib.contextmanager
def device_timer(name: str = "block", results: Optional[Dict[str, float]] = None,
                 device: Optional[Union[str, torch.device]] = None):
    """The host clock around a block, fenced at its exit with
    ``torch.cuda.synchronize(device)`` when ``device`` is a CUDA device;
    the seconds go into ``results[name]``."""
    dev = torch.device(device) if device is not None else None
    t0 = time.perf_counter()
    yield
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = dt
    logger.debug("%s: %.3f ms", name, dt * 1000)


def timed(fn: Callable[..., Any], *args, fence: bool = True, **kw):
    """Run fn, fence on its outputs' devices, return (result, seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    if fence:
        fence_outputs(out)
    return out, time.perf_counter() - t0


def capture_trace(fn: Callable[[], Any], trace_dir: Optional[str] = None):
    """Run fn under ``torch.profiler``; writes ``trace.json`` (Chrome trace)
    into ``trace_dir`` (default: ``crs_tpu_torch_trace`` in the temporary
    directory) and returns (result, trace_dir)."""
    from torch.profiler import ProfilerActivity, profile

    trace_dir = trace_dir or os.path.join(tempfile.gettempdir(), "crs_tpu_torch_trace")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = fn()
        fence_outputs(out)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    logger.info("profiler trace written to %s", trace_dir)
    return out, trace_dir
