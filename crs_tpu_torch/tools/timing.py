"""How the tools time their work: on the card, a call captured once into a
CUDA graph (the JAX tools' one jitted program) and replayed between CUDA
events (:class:`GraphedCall`), or, where a call cannot be captured, one eager
call between CUDA events with the host clock beside them (:class:`EagerCall`);
on the CPU, the host clock around an eager call."""

from __future__ import annotations

import time
from collections import Counter
from typing import Callable, Dict, Tuple

import torch

__all__ = ["launch_counts", "GraphedCall", "EagerCall", "timed_call"]


def launch_counts() -> Dict[str, int]:
    """The launches every kernel's wrapper has counted in this process, by
    kernel: the scans (kernels 1–7), int4 / NF4 (8, 9), decode attention
    (10), the fused MLP (11) and the three probes (12–14)."""
    from ..ops import decode_attention, fused_mlp, gemv_probe, qgemm, scan

    return {**scan.STATS.by_kernel, **qgemm.STATS.by_kernel, **decode_attention.STATS.by_kernel,
            **fused_mlp.STATS.by_kernel, **gemv_probe.STATS.by_kernel}


def _since(before: Dict[str, int]) -> Counter:
    now = launch_counts()
    return Counter({k: now[k] - before.get(k, 0) for k in now if now[k] > before.get(k, 0)})


class GraphedCall:
    """``fn()`` → a tensor on the card, timed one call at a time: one
    warm-up call on a stream of its own (it loads the libraries and
    allocates the kernels' tables and scratch there), then ``fn`` captured
    once on that stream; each :meth:`run` replays the graph between CUDA
    events. A wrapper counts a launch when it is captured, so
    :attr:`launches` adds the captured launches once per replay, beside the
    warm-up's. :func:`timed_call` picks it or :class:`EagerCall`."""

    def __init__(self, fn: Callable[[], torch.Tensor], dev: torch.device):
        self.stream = torch.cuda.Stream(dev)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        before = launch_counts()
        with torch.cuda.stream(self.stream):
            fn()
        self.stream.synchronize()
        self.launches: Counter = Counter(_since(before))
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=self.stream):
            self.out = fn()
        self.last_run: Counter = _since(before)  # the launches a replay makes

    def run(self) -> Tuple[float, torch.Tensor]:
        """One replay: (seconds, its output). The output is overwritten by
        the next replay: read it first."""
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            start.record()
            self.graph.replay()
            stop.record()
        stop.synchronize()
        self.launches.update(self.last_run)
        return start.elapsed_time(stop) / 1e3, self.out


class EagerCall:
    """``fn()`` timed one eager call at a time, for work a CUDA graph cannot
    capture (a scan reads a device count on the host when it checks its
    ceilings). On the card each :meth:`run` records CUDA events on the
    current stream before and after the call, and also reads the host clock
    from before the call to the end of its device work (a synchronize):
    both include the host's time inside the call. :attr:`launches` adds
    each run's launches. On the CPU both times are the host clock."""

    def __init__(self, fn: Callable[[], object], dev: torch.device):
        self.fn, self.dev = fn, dev
        self.launches: Counter = Counter()
        self.last_run: Counter = Counter()  # the launches of the latest run
        self.host_seconds = 0.0  # the host clock of the latest run

    def run(self) -> Tuple[float, object]:
        """One call: (seconds between its CUDA events, its output)."""
        before = launch_counts()
        if self.dev.type != "cuda":
            t0 = time.perf_counter()
            out = self.fn()
            self.host_seconds = seconds = time.perf_counter() - t0
        else:
            start, stop = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            t0 = time.perf_counter()
            start.record()
            out = self.fn()
            stop.record()
            stop.synchronize()
            self.host_seconds = time.perf_counter() - t0
            seconds = start.elapsed_time(stop) / 1e3
        self.last_run = _since(before)
        self.launches.update(self.last_run)
        return seconds, out


def timed_call(fn: Callable[[], torch.Tensor], dev: torch.device, graph: bool = True):
    """A :class:`GraphedCall` of ``fn`` on the card with ``graph``, else an
    :class:`EagerCall` (the CPU, or a call that is not to be captured)."""
    return GraphedCall(fn, dev) if graph and dev.type == "cuda" else EagerCall(fn, dev)
