"""The fused-MLP decode kernel against the int8 route (port of
``tools/bench_fused_mlp.py``).

The chain method of ``crs_tpu_torch.tools.bench_chain_gemv``: L DISTINCT
layers with a data dependency, then an RMS renorm, repeated; the fixed cost
of a call cancelled by differencing two repetition counts n1 and n2, each
one CUDA graph replayed between CUDA events (``bench_chain_gemv.timed_chain``;
medians of ``--reps`` replays). At the defaults (H 4096, I 14336, L 8) the
weights are 1.41 GB of int8, 28 times the H100's 50 MB L2, so the chain
streams them from device memory.

Steps:
  xla_int8  the int8 route (``models/quantized.py`` ``_int8_act_matmul``:
            ``torch._int_mm`` on the card) for gate, up and down after an
            RMSNorm, ``silu`` as ``models/transformer.py`` computes it
  fused     kernel 11 (``ops.fused_mlp.fused_mlp_int8``, ``fused_mlp_int8_kernel``)
            on the same weights in its layout (gate and up transposed,
            scales [L, I / chunk, chunk])

Every operand is drawn from ``np.random.default_rng(0)`` in the JAX tool's
order. A failed step prints FAILED and the exit code is 1.

Usage: python -m crs_tpu_torch.tools.bench_fused_mlp --h 4096 --inter 14336 --layers 8 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .bench_chain_gemv import Step, timed_chain

__all__ = ["STEPS", "draw_weights", "step_xla", "fused_step", "main"]

STEPS = ("xla_int8", "fused")


def draw_weights(h: int, inter: int, layers: int, b: int, chunk: int, dev
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(x0 [b, H] f32, the int8 route's stacked weights, the fused kernel's),
    drawn from ``np.random.default_rng(0)`` as the JAX tool draws them: x0,
    then gate, up and down codes ([L, K, N] int8, scales 1e-2 / √K)."""
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((b, h)).astype(np.float32)).to(dev) * 0.3
    nchunks = inter // chunk

    def qw(k: int, n: int):
        codes = rng.integers(-127, 128, (layers, k, n), dtype=np.int8)
        return codes, np.full((layers, n), 1e-2 / k ** 0.5, np.float32)

    gate_c, gate_s = qw(h, inter)
    up_c, up_s = qw(h, inter)
    down_c, down_s = qw(inter, h)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    norm = torch.ones((layers, h), dtype=torch.float32, device=dev)
    down = {"down_c": put(down_c), "down_s": put(down_s), "norm": norm}
    ws_xla = {"gate_c": put(gate_c), "gate_s": put(gate_s), "up_c": put(up_c),
              "up_s": put(up_s), **down}
    ws_fused = {"gate_t": put(gate_c.transpose(0, 2, 1)),
                "gate_s2": put(gate_s.reshape(layers, nchunks, chunk)),
                "up_t": put(up_c.transpose(0, 2, 1)),
                "up_s2": put(up_s.reshape(layers, nchunks, chunk)), **down}
    return x0, ws_xla, ws_fused


def step_xla(x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One MLP block through the int8 route: x + down(silu(gate(xn)) · up(xn))."""
    from ..models.quantized import _int8_act_matmul
    from ..models.transformer import silu

    xn = x * torch.rsqrt(torch.mean(torch.square(x), dim=1, keepdim=True) + 1e-5)
    xn = xn * w["norm"][None, :]
    g = _int8_act_matmul(xn, w["gate_c"], w["gate_s"])
    u = _int8_act_matmul(xn, w["up_c"], w["up_s"])
    return x + _int8_act_matmul(silu(g) * u, w["down_c"], w["down_s"])


def fused_step(chunk: int) -> Step:
    """One MLP block through kernel 11."""
    from ..ops.fused_mlp import fused_mlp_int8

    def step(x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
        return fused_mlp_int8(x, w["norm"], w["gate_t"], w["gate_s2"], w["up_t"], w["up_s2"],
                              w["down_c"], w["down_s"], chunk=chunk)

    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--h", type=int, default=4096)
    ap.add_argument("--inter", type=int, default=14336)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--b", type=int, default=1)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--n1", type=int, default=1)
    ap.add_argument("--n2", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    h, inter, layers = args.h, args.inter, args.layers
    bytes_per_layer = 3 * inter * h
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={kind} H={h} I={inter} L={layers} b={args.b} "
          f"int8={layers * bytes_per_layer / 1e6:.0f}MB", file=sys.stderr)
    x0, ws_xla, ws_fused = draw_weights(h, inter, layers, args.b, args.chunk, dev)
    out, failed = {}, []
    for name, step, ws in (("xla_int8", step_xla, ws_xla),
                           ("fused", fused_step(args.chunk), ws_fused)):
        try:
            dt = timed_chain(step, ws, x0, args.n1, args.n2, args.reps)["seconds"]
            eff = layers * bytes_per_layer / dt / 1e9
            out[name] = {"ms_per_layer": round(dt * 1e3 / layers, 4),
                         "gbps_effective": round(eff, 1)}
            print(f"{name:9s}: {dt * 1e3 / layers:7.3f} ms/layer  ({eff:6.1f} GB/s eff)",
                  flush=True)
        except Exception as e:  # report the step, run the next; the exit code says it failed
            failed.append(name)
            print(f"{name:9s}: FAILED {type(e).__name__}: {str(e)[:200]}", flush=True)
    print(json.dumps({"device": kind, **out}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
