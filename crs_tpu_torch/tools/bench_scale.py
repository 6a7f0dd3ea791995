"""Corpus-scale retrieval bench of the port: the int8 scan at 1M / 10M rows
(port of ``tools/bench_scale.py``).

The corpus codes, scales and queries are drawn on the host from
``np.random.default_rng(0)`` in the JAX tool's order and copied to the card
once. Each repetition folds its scores into the next queries (q ← q + 1e-6·s[:, :1]),
so no two scans are alike, and the fixed cost of a call cancels by
differencing n1 and n2 repetitions: scan ms = (median t2 − median t1) /
(n2 − n1) over ``--reps`` timed runs of each. The JAX tool runs the
repetitions inside one jitted ``fori_loop``; here they are an eager Python
loop timed by :class:`~crs_tpu_torch.tools.timing.EagerCall` (CUDA events,
and the host clock beside them as ``host_scan_ms``), because a scan reads
its flagged-pair count on the host and a CUDA graph cannot capture it.

Engines: ``pallas`` is ``ops.scan.scan_topk_int8`` with ``--block-size`` and
``--kb``; ``xla`` is ``ops.quant.int8_topk`` with ``--rescore-k`` (its
candidate scan, then an f32 rescore). Past ``SCAN_MIN_ROWS`` rows both scan
through kernel 1 (``int8_scan_topk_kernel``), as both go through
``crs_tpu``'s Pallas scan there: the name ``xla`` is historical. A corpus
that is not a whole number of blocks is copied into a padded tensor on
every call (10,000,000 rows are not a multiple of 4,096), as ``crs_tpu``
pads it.

Usage: python -m crs_tpu_torch.tools.bench_scale --rows 10000000 --batch 64 --k 64 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .timing import EagerCall

__all__ = ["ENGINES", "draw", "engine_scan", "repeated", "main"]

ENGINES = ("pallas", "xla")

Scan = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def draw(n: int, d: int, b: int, dev) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(codes [n, d] int8, scales [n] f32, queries [b, d] f32) drawn from
    ``np.random.default_rng(0)`` as the JAX tool draws them, on ``dev``."""
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(-127, 128, (n, d), dtype=np.int8)).to(dev)
    scales = torch.from_numpy((rng.random(n).astype(np.float32) * 0.5 + 0.5) / 127.0).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
    return codes, scales, q


def engine_scan(engine: str, codes: torch.Tensor, scales: torch.Tensor, k: int,
                block_size: int = 4096, kb: int = 0, rescore_k: int = 128) -> Scan:
    """queries → (scores [B, k], ids [B, k]) of ``engine`` over the corpus."""
    from ..ops.quant import int8_topk
    from ..ops.scan import scan_topk_int8

    n = codes.shape[0]
    if engine == "pallas":
        return lambda q: scan_topk_int8(codes, scales, q, k, n, block_size=block_size, kb=kb)
    if engine == "xla":
        return lambda q: int8_topk(codes, scales, q, k, n, rescore_k=rescore_k)
    raise ValueError(f"unknown engine {engine!r}; the engines are {ENGINES}")


def repeated(scan: Scan, q0: torch.Tensor, reps: int) -> torch.Tensor:
    """``reps`` scans, each folding its scores into the next queries; the
    sum of every score."""
    acc = torch.zeros((), dtype=torch.float32, device=q0.device)
    qc = q0
    for _ in range(reps):
        s, _ = scan(qc)
        qc = qc + 1e-6 * s[:, :1]
        acc = acc + s.sum()
    return acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--rescore-k", type=int, default=128)
    ap.add_argument("--n1", type=int, default=1)
    ap.add_argument("--n2", type=int, default=5)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--block-size", type=int, default=4096)
    ap.add_argument("--kb", type=int, default=0)
    ap.add_argument("--engine", default="pallas", choices=ENGINES,
                    help="pallas = scan_topk_int8 (the serving path at scale); "
                         "xla = int8_topk (the candidate scan, then an f32 rescore)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, d, b = args.rows, args.dim, args.batch
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={kind} rows={n} dim={d} int8={n * d / 1e9:.2f}GB batch={b} k={args.k}",
          file=sys.stderr)
    t0 = time.perf_counter()
    codes, scales, q = draw(n, d, b, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"built+transferred in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    scan = engine_scan(args.engine, codes, scales, args.k, args.block_size, args.kb,
                       args.rescore_k)
    calls = [EagerCall(lambda r=r: repeated(scan, q, r), dev) for r in (args.n1, args.n2)]
    for c in calls:  # warm: the first calls load the kernel and allocate
        c.run()
    t1s, t2s, h1s, h2s = [], [], [], []
    for _ in range(args.reps):
        t1s.append(calls[0].run()[0])
        h1s.append(calls[0].host_seconds)
        t2s.append(calls[1].run()[0])
        h2s.append(calls[1].host_seconds)
    per_scan = (float(np.median(t2s)) - float(np.median(t1s))) / (args.n2 - args.n1)
    host_scan = (float(np.median(h2s)) - float(np.median(h1s))) / (args.n2 - args.n1)
    print(json.dumps({
        "rows": n, "dim": d, "batch": b, "k": args.k, "engine": args.engine,
        "block_size": args.block_size, "kb": args.kb,
        "scan_ms": round(per_scan * 1e3, 3),
        "ms_per_query": round(per_scan * 1e3 / b, 4),
        "effective_gbps": round(n * d / per_scan / 1e9, 1),
        "host_scan_ms": round(host_scan * 1e3, 3), "device": kind,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
