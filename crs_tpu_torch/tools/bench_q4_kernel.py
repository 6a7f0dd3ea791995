"""Microbenchmark of the int4 GEMV kernel variants (port of
``tools/bench_q4_kernel.py``).

This tool loops over ONE weight matrix: at the defaults its 32.8 MB of int4
codes fit in the H100's 50 MB L2, so it reads them from there and reports
more than device memory gives. Use ``crs_tpu_torch.tools.bench_chain_gemv``
for absolute streaming rates; this one compares variants at identical shapes.

Variants: ``int8`` the port's int8 route (``models/quantized.py``
``_int8_act_matmul``, ``torch._int_mm`` on the card); ``i32`` / ``i16``
(the same function: the nibbles are unpacked in 32-bit registers on the
card) and ``none`` (the raw byte as both nibbles, wrong numerics) through
per-group int32 products; ``fold_i32`` / ``fold_i16`` with the scales folded
into bf16 weights — ``q4_probe_kernel`` of ``csrc/gemv_probe.cu`` on the
card, its plain version on the CPU. Each is timed as 50 calls inside one
CUDA graph, the input incremented each call (the JAX tool's ``fori_loop``
inside one jit), and one replay timed with CUDA events.

Usage: python -m crs_tpu_torch.tools.bench_q4_kernel --k 2048 --n 32000 --r 32 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.gemv_probe import probe_tiles, q4_probe_matmul
from .timing import timed_call

__all__ = ["VARIANTS", "build_variant", "int8_variant", "time_fn", "run_variants", "main"]

VARIANTS = ("int8", "i32", "i16", "none", "fold_i32", "fold_i16")
_LOOP_ITERS = 50


def build_variant(r: int, k: int, n: int, g: int, unpack: str = "i32", fold: bool = False,
                  device=None) -> Tuple[Callable, tuple]:
    """(run, args): ``run(*args)`` is the variant's [rt, N] product summed to
    a scalar, on operands drawn as the JAX tool draws them
    (``np.random.default_rng(0)``; rt = max(32, ⌈R/32⌉·32) rows)."""
    dev = resolve_device(device)
    k2 = k // 2
    probe_tiles(k2, g)  # refuses a K/2 that g does not divide
    rt = max(32, -(-r // 32) * 32)
    xdtype = torch.bfloat16 if fold else torch.int8

    def run(xe, xo, xs, codes, scales):
        return q4_probe_matmul(xe, xo, xs, codes, scales, unpack=unpack, fold=fold).sum()

    rng = np.random.default_rng(0)
    xe = torch.from_numpy(rng.integers(-20, 20, (rt, k2))).to(dev).to(xdtype)
    xo = torch.from_numpy(rng.integers(-20, 20, (rt, k2))).to(dev).to(xdtype)
    xs = torch.ones((rt, 1), dtype=torch.float32, device=dev)
    codes = torch.from_numpy(rng.integers(-128, 128, (k2, n)).astype(np.int8)).to(dev)
    scales = torch.full((g, n), 0.01, dtype=torch.float32, device=dev)
    return run, (xe, xo, xs, codes, scales)


def int8_variant(r: int, k: int, n: int, device=None) -> Tuple[Callable, tuple]:
    """(run, args) of the ``int8`` variant: the port's int8 route summed."""
    from ..models.quantized import _int8_act_matmul

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((r, k)).astype(np.float32)).to(dev)
    codes = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(dev)
    scales = torch.full((n,), 0.01, dtype=torch.float32, device=dev)
    return (lambda a, b, c: _int8_act_matmul(a, b, c).sum()), (x, codes, scales)


def time_fn(run_one: Callable, args: tuple, iters: int = _LOOP_ITERS):
    """(seconds a call, the summed value, launches by kernel) of ``iters``
    calls of ``run_one`` inside one CUDA graph, its first operand
    incremented by one (in its dtype) each call so no call repeats another;
    one replay for the value, then one timed (on the CPU: eager calls and
    the host clock)."""
    dev = args[0].device

    def looped():
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        cur = args[0]
        for _ in range(iters):
            acc = acc + run_one(cur, *args[1:])
            cur = cur + 1
        return acc

    call = timed_call(looped, dev)
    value = float(call.run()[1])
    seconds, _ = call.run()
    return seconds / iters, value, dict(call.launches)


def run_variants(variants: List[str], r: int, k: int, n: int, g: int, device=None,
                 report=print) -> Tuple[Dict[str, dict], List[str]]:
    """Each variant timed by :func:`time_fn`: ({variant: {"ms", "gbps",
    "value", "launches"}}, the variants that failed). A failure is
    reported and the next variant runs, as in the JAX tool."""
    dev = resolve_device(device)
    int4_bytes = k * n // 2
    results, failed = {}, []
    for var in variants:
        try:
            if var == "int8":
                fn, fargs = int8_variant(r, k, n, dev)
                nbytes = k * n
            else:
                fold = var.startswith("fold_")
                unpack = var.split("_")[-1] if fold else var
                fn, fargs = build_variant(r, k, n, g, unpack=unpack, fold=fold, device=dev)
                nbytes = int4_bytes
            dt, value, launches = time_fn(fn, fargs)
            results[var] = {"ms": dt * 1e3, "gbps": nbytes / dt / 1e9, "value": value,
                            "launches": launches}
            report(f"{var:10s}: {dt * 1e3:8.3f} ms  ({nbytes / dt / 1e9:6.1f} GB/s effective)"
                   + (f"  launches {launches}" if launches else ""))
        except Exception as e:  # the tool's contract: report the variant, run the next
            failed.append(var)
            report(f"{var:10s}: FAILED {type(e).__name__}: {str(e)[:200]}")
    return results, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--r", type=int, default=32)
    ap.add_argument("--k", type=int, default=2048)
    ap.add_argument("--n", type=int, default=32000)
    ap.add_argument("--g", type=int, default=16)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    r, k, n, g = args.r, args.k, args.n, args.g
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    l2 = (f"{torch.cuda.get_device_properties(dev).L2_cache_size / 1e6:.1f}MB"
          if dev.type == "cuda" else "n/a")
    print(f"device={kind} R={r} K={k} N={n} int4={k * n / 2 / 1e6:.1f}MB "
          f"int8={k * n / 1e6:.1f}MB L2={l2}", file=sys.stderr)
    results, failed = run_variants(args.variants.split(","), r, k, n, g, dev,
                                   report=lambda line: print(line, flush=True))
    print(json.dumps({"device": kind, **{v: round(res["ms"], 3) for v, res in results.items()}}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
