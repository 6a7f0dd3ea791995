"""Chained-GEMV bench of the port: decode-realistic weight streaming (port of
``tools/bench_chain_gemv.py``).

Its method, the JAX tool's:
- chain DISTINCT weights with a data dependency, like a decode step: L
  layers of x ← step(x, W_l), then an RMS renorm, repeated;
- size the weight set well past fast memory (96 layers of 2048 × 2048 int8
  are 403 MB, eight times the H100's 50 MB L2);
- cancel the fixed cost of a call by differencing two repetition counts n1
  and n2, each one CUDA graph (the JAX tool's one jitted program), replays
  timed with CUDA events: s/chain = (t2 − t1) / (n2 − n1), medians of
  ``--reps`` replays each.

Variants:
  int8      the port's int8 route (``_int8_act_matmul``: ``torch._int_mm``)
  q4        kernel 8 (``ops.qgemm.q4_matmul``, ``q4_mma_kernel``)
  dq4       ``QuantizedTensor.dequantize`` to bf16, then a bf16 ``torch.matmul``
  i4native  XLA's s4 dot in the JAX tool; here the same int32 product by
            PyTorch ops: x truncated to int8, ``ops.quant.int8_product``
            (``torch._int_mm`` on the card) on the int4 values held as int8
  q8pallas  ``ops.gemv_probe.q8_gemv`` (``q8_gemv_kernel``)
  pldb      ``ops.gemv_probe.db_gemv`` (``db_gemv_kernel``), checked first
            against its plain version on one drawn x

Every operand is drawn from ``np.random.default_rng(0)`` in the JAX tool's
order, so a seed gives both tools the same tensors.

Usage: python -m crs_tpu_torch.tools.bench_chain_gemv --d 2048 --layers 96 --r 8 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .timing import timed_call

__all__ = ["VARIANTS", "PEAK_BYTES_PER_S", "draw_variant", "chain",
           "timed_chain", "run_variants", "main"]

VARIANTS = ("int8", "q4", "dq4", "i4native", "q8pallas", "pldb")
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)

Step = Callable[[torch.Tensor, Dict[str, torch.Tensor]], torch.Tensor]


def _ints(rng, low: int, high: int, shape, dev) -> torch.Tensor:
    """``rng.integers(low, high, shape)`` (the JAX tool's int64 draw) as int8."""
    return torch.from_numpy(rng.integers(low, high, shape).astype(np.int8)).to(dev)


def draw_variant(var: str, rng, d: int, layers: int, r: int, g: int,
                 dev: torch.device) -> Tuple[Step, Dict[str, torch.Tensor], int]:
    """(step, stacked weights [L, ...], bytes the chain streams) of ``var``,
    its operands drawn from ``rng`` as the JAX tool draws them."""
    from ..models.quantized import QuantizedTensor, _int8_act_matmul
    from ..ops.gemv_probe import db_gemv, emulate_db_gemv, q8_gemv
    from ..ops.qgemm import q4_matmul
    from ..ops.quant import int8_product

    scale = 1e-2 / d ** 0.5
    if var == "int8":
        ws = {"codes": _ints(rng, -127, 128, (layers, d, d), dev),
              "scales": torch.full((layers, d), scale, dtype=torch.float32, device=dev)}
        return (lambda x, w: _int8_act_matmul(x, w["codes"], w["scales"])), ws, \
            layers * (d * d + 4 * d)
    if var in ("q4", "dq4"):
        ws = {"codes": _ints(rng, -128, 128, (layers, d // 2, d), dev),
              "scales": torch.full((layers, g, d), scale, dtype=torch.float32, device=dev)}
        nbytes = layers * (d * d // 2 + 4 * g * d)
        if var == "q4":
            return (lambda x, w: q4_matmul(x, w["codes"], w["scales"])), ws, nbytes

        def stepdq(x, w):
            qt = QuantizedTensor(w["codes"], w["scales"], 4, d // g, (d, d))
            return torch.matmul(x.to(torch.bfloat16), qt.dequantize().to(torch.bfloat16)).float()

        return stepdq, ws, nbytes
    if var == "i4native":
        ws = {"codes": _ints(rng, -8, 8, (layers, d, d), dev)}
        rng.integers(-100, 100, (r, d))  # the JAX tool's unused xq0: keeps the draw order

        def stepi4(x, w):
            return int8_product(x.to(torch.int8), w["codes"]).float() * scale

        return stepi4, ws, layers * d * d
    if var == "q8pallas":
        ws = {"codes": _ints(rng, -127, 128, (layers, d, d), dev),
              "scales": torch.full((layers, 1, d), scale, dtype=torch.float32, device=dev)}
        return (lambda x, w: q8_gemv(x, w["codes"], w["scales"])), ws, layers * (d * d + 4 * d)
    if var == "pldb":
        ws = {"codes": _ints(rng, -127, 128, (layers, d, d), dev)}
        xt = torch.from_numpy(rng.standard_normal((r, d)).astype(np.float32)).to(dev)
        want = emulate_db_gemv(xt, ws["codes"][0], scale)
        err = float((db_gemv(xt, ws["codes"][0], scale) - want).abs().max())
        if not err < 1e-2 * float(want.abs().max()):
            raise AssertionError(f"pldb: the kernel differs from its plain version by {err}")
        return (lambda x, w: db_gemv(x, w["codes"], scale)), ws, layers * d * d
    raise ValueError(f"unknown variant {var!r}; the variants are {VARIANTS}")


def chain(step: Step, layers: List[Dict[str, torch.Tensor]], x: torch.Tensor,
          reps: int) -> torch.Tensor:
    """``reps`` times: x through every layer, then x · rsqrt(mean(x²) + 1e-6)."""
    for _ in range(reps):
        for w in layers:
            x = step(x, w)
        x = x * torch.rsqrt(torch.mean(torch.square(x)) + 1e-6)
    return x


def timed_chain(step: Step, ws: Dict[str, torch.Tensor], x0: torch.Tensor, n1: int, n2: int,
                reps: int, graph: bool = True) -> dict:
    """Seconds a chain: two :func:`~.timing.timed_call` s of n1 and n2
    repetitions (CUDA graphs; eager calls without ``graph``), one warm run each, then
    ``reps`` timed runs of each in turns; (median t2 − median t1) / (n2 −
    n1). Also the launches by kernel (captured × replays, and the warm-ups)
    and the launches a chain."""
    num = next(iter(ws.values())).shape[0]
    layers = [{k: v[i] for k, v in ws.items()} for i in range(num)]
    calls = [timed_call(lambda n=n: chain(step, layers, x0, n).sum(), x0.device, graph)
             for n in (n1, n2)]
    for c in calls:
        c.run()
    t1s, t2s = [], []
    for _ in range(reps):
        t1s.append(calls[0].run()[0])
        t2s.append(calls[1].run()[0])
    t1, t2 = float(np.median(t1s)), float(np.median(t2s))
    return {"seconds": (t2 - t1) / (n2 - n1), "t1": t1, "t2": t2,
            "launches": dict(calls[0].launches + calls[1].launches),
            "launches_per_chain": sum(calls[0].last_run.values()) / n1}


def run_variants(variants: List[str], d: int, layers: int, r: int, g: int, reps: int, n1: int,
                 n2: int, device=None, report=print) -> Tuple[Dict[str, dict], List[str]]:
    """Each variant's chain timed by :func:`timed_chain`: ({variant:
    {"ms_per_chain", "gbps_effective" (the JAX tool's weight bytes),
    "bytes_per_chain", "bound_ms", "launches", "launches_per_chain"}}, the
    variants that failed). A failure is reported and the next variant runs,
    as in the JAX tool."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((r, d)).astype(np.float32)).to(dev)
    results, failed = {}, []
    for var in variants:
        try:
            step, ws, nbytes = draw_variant(var, rng, d, layers, r, g, dev)
            t = timed_chain(step, ws, x0, n1, n2, reps)
            del ws
            dt = t["seconds"]
            eff = layers * d * d / (1 if var in ("int8", "q8pallas", "pldb") else 2) / dt / 1e9
            results[var] = {"ms_per_chain": dt * 1e3, "gbps_effective": eff,
                            "bytes_per_chain": nbytes,
                            "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, **{
                                k: t[k] for k in ("launches", "launches_per_chain", "t1", "t2")}}
            per = t["launches_per_chain"]
            report(f"{var:6s}: {dt * 1e3:8.3f} ms/chain  ({eff:6.1f} GB/s effective)"
                   + (f"  {per:.0f} kernel launches a chain" if per else ""))
        except Exception as e:  # the tool's contract: report the variant, run the next
            failed.append(var)
            report(f"{var:6s}: FAILED {type(e).__name__}: {str(e)[:200]}")
    return results, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=96)
    ap.add_argument("--r", type=int, default=8)
    ap.add_argument("--g", type=int, default=16, help="int4 scale groups")
    ap.add_argument("--reps", type=int, default=5, help="timed repetitions")
    ap.add_argument("--n1", type=int, default=1, help="short in-graph rep count")
    ap.add_argument("--n2", type=int, default=5, help="long in-graph rep count")
    ap.add_argument("--variants", default="int8,q4,dq4")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    d, layers, r = args.d, args.layers, args.r
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    w_mb_int8 = layers * d * d / 1e6
    print(f"device={kind} d={d} L={layers} R={r} int8={w_mb_int8:.0f}MB "
          f"int4={w_mb_int8 / 2:.0f}MB", file=sys.stderr)
    results, failed = run_variants(args.variants.split(","), d, layers, r, args.g, args.reps,
                                   args.n1, args.n2, dev,
                                   report=lambda line: print(line, flush=True))
    print(json.dumps({"device": kind,
                      **{v: round(res["ms_per_chain"], 4) for v, res in results.items()}}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
