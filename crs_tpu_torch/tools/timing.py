"""How the tools time their work: on the card, a call captured once into a
CUDA graph (the JAX tools' one jitted program) and replayed between CUDA
events; on the CPU, the host clock around an eager call."""

from __future__ import annotations

import time
from collections import Counter
from typing import Callable, Dict, Tuple

import torch

__all__ = ["launch_counts", "GraphedCall"]


def launch_counts() -> Dict[str, int]:
    """The launches the wrappers on the tools' paths have counted, by kernel
    (kernel 8 and the three probes)."""
    from ..ops import gemv_probe, qgemm

    return {**qgemm.STATS.by_kernel, **gemv_probe.STATS.by_kernel}


def _since(before: Dict[str, int]) -> Counter:
    now = launch_counts()
    return Counter({k: now[k] - before.get(k, 0) for k in now if now[k] > before.get(k, 0)})


class GraphedCall:
    """``fn()`` → a tensor, timed one call at a time. On the card with
    ``graph``: one warm-up call on a stream of its own (it loads the
    libraries and allocates the kernels' tables and scratch there), then
    ``fn`` captured once on that stream; each :meth:`run` replays the graph.
    A wrapper counts a launch when it is captured, so :attr:`launches` adds
    the captured launches once per replay, beside the warm-up's. Without
    ``graph`` (or on the CPU) each run calls ``fn`` eagerly."""

    def __init__(self, fn: Callable[[], torch.Tensor], dev: torch.device, graph: bool = True):
        self.fn, self.dev, self.graph = fn, dev, None
        self.launches: Counter = Counter()
        self.last_run: Counter = Counter()  # the launches of the latest run
        if dev.type != "cuda":
            return
        self.stream = torch.cuda.Stream(dev) if graph else torch.cuda.current_stream(dev)
        if not graph:
            return
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        before = launch_counts()
        with torch.cuda.stream(self.stream):
            fn()
        self.stream.synchronize()
        self.launches.update(_since(before))
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=self.stream):
            self.out = fn()
        self.captured = _since(before)

    def run(self) -> Tuple[float, torch.Tensor]:
        """One call: (seconds, its output). The graph's output is overwritten
        by the next replay: read it first."""
        if self.dev.type != "cuda":
            t0 = time.perf_counter()
            out = self.fn()
            return time.perf_counter() - t0, out  # the plain versions: no launches
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            before = launch_counts()
            start.record()
            if self.graph is not None:
                self.graph.replay()
                out = self.out
            else:
                out = self.fn()
            stop.record()
        stop.synchronize()
        self.last_run = self.captured if self.graph is not None else _since(before)
        self.launches.update(self.last_run)
        return start.elapsed_time(stop) / 1e3, out
