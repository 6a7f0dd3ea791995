"""Prefill MFU of the port on the card (port of ``tools/bench_prefill_mfu.py``).

Decode streams weights and is bound by the memory rate, so its MFU is
small on any hardware; prefill runs large batched matmuls on the tensor
cores, and there MFU means what it says. This tool builds a random-init
model at production widths through ``create_model_interface`` and times a
batched long-prompt prefill with
``evaluation.efficiency.latency.measure_prefill_mfu`` (the forward's logits
kept on the card, fenced with ``torch.cuda.synchronize``; the median of
``--runs``), against the peak of the card's row in
``evaluation/efficiency/device_specs.py`` (bf16, or int8 with ``--type
int8``). A failed measurement prints FAILED and exits 1.

Usage: python -m crs_tpu_torch.tools.bench_prefill_mfu --config 1b --type int8 --batch 8 --seq 512 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..device import resolve_device

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="1b")
    ap.add_argument("--type", default="bf16", choices=("bf16", "int8"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..evaluation.efficiency.latency import measure_prefill_mfu
    from ..models.model_interface import create_model_interface

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={kind}", file=sys.stderr)
    m = create_model_interface(args.type, {"config": args.config, "max_seq_len": 2048}, device=dev)
    m.load()
    out = measure_prefill_mfu(
        m, batch=args.batch, seq_len=args.seq, num_runs=args.runs,
        dtype="int8" if args.type == "int8" else "bf16", device_name=kind)
    if not out:  # measure_prefill_mfu logs the failure and returns nothing
        print(f"prefill {args.type}: FAILED (no measurement; see the log)", flush=True)
        return 1
    out.update({"config": args.config, "type": args.type, "device": kind})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
