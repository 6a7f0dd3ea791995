"""Pure-decode latency bench of the port: the int8 and int4 weight routes
(port of ``tools/bench_decode.py``).

Decode ms/token by differencing two greedy generates of n1 and n2 tokens
(the medians of ``--runs`` each), which cancels the prefill and the fixed
cost of a call: the method of ``evaluation/efficiency/latency.py``, without
the model interface, so that random quantized weights go straight into the
packed form (no f32 intermediate). Each generate is timed with the host
clock and ends in ``torch.cuda.synchronize``. Routes: ``--bits 4`` runs
every linear layer through kernel 8 (``q4_mma_kernel``), ``--bits 8``
through the int8 route (``torch._int_mm``), ``--kv-bits 8`` the attention
through kernel 10 (``decode_attention_int8``); ``--fuse`` fuses q|k|v and
gate|up. Greedy only: the port's sampling draws from a ``torch.Generator``.

Usage: python -m crs_tpu_torch.tools.bench_decode --config 1b --bits 4 --batch 1 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["build_random_quant_params", "main"]


def build_random_quant_params(cfg, bits: int, group_size: int = 128, seed: int = 0,
                              device="cpu"):
    """Random params with every weight already a ``QuantizedTensor`` in
    ``crs_tpu``'s layout (int8 codes [K, N] with [N] scales; int4 codes
    packed two a byte [K/2, N] with [g, N] scales), drawn from
    ``np.random.default_rng(seed)`` in the JAX tool's order: the embedding,
    the lm head, then each layer's q, k, v, o, gate, up, down. Codes are
    drawn as integers (timing does not depend on their values; the scales
    keep activations in a sane range)."""
    from ..models.quantized import QuantizedTensor

    rng = np.random.default_rng(seed)
    d, hd = cfg.hidden_size, cfg.head_dim

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    def qmat(kin: int, kout: int):
        scale_mag = (kin ** -0.5) / (127.0 if bits == 8 else 7.0)
        if bits == 8:
            codes = rng.integers(-127, 128, (kin, kout), dtype=np.int8)
            scales = np.full((kout,), scale_mag, np.float32)
            return QuantizedTensor(put(codes), put(scales), 8, 0, (kin, kout))
        g = kin // group_size if kin % group_size == 0 else 1
        packed = rng.integers(-128, 128, (kin // 2, kout), dtype=np.int16).astype(np.int8)
        scales = np.full((g, kout), scale_mag, np.float32)
        return QuantizedTensor(put(packed), put(scales), 4, kin // g, (kin, kout))

    def ones() -> torch.Tensor:
        return torch.ones((d,), dtype=cfg.dtype, device=device)

    params = {
        "embed": put(rng.standard_normal((cfg.vocab_size, d)).astype(np.float32) * 0.02).to(
            cfg.dtype),
        "layers": [],
        "final_norm": {"scale": ones()},
        "lm_head": qmat(d, cfg.vocab_size),
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "attn_norm": {"scale": ones()},
            "attn": {
                "q": qmat(d, cfg.num_heads * hd),
                "k": qmat(d, cfg.num_kv_heads * hd),
                "v": qmat(d, cfg.num_kv_heads * hd),
                "o": qmat(cfg.num_heads * hd, d),
            },
            "mlp_norm": {"scale": ones()},
            "mlp": {
                "gate": qmat(d, cfg.intermediate_size),
                "up": qmat(d, cfg.intermediate_size),
                "down": qmat(cfg.intermediate_size, d),
            },
        })
    return params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="1b")
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--kv-bits", type=int, default=16, choices=(8, 16))
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prefill", type=int, default=128)
    ap.add_argument("--n1", type=int, default=8)
    ap.add_argument("--n2", type=int, default=40)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--fuse", action="store_true", help="fuse q|k|v and gate|up projections")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..models.sampling import SamplingParams, generate_tokens
    from ..models.transformer import CONFIGS, fuse_qkv_params

    cfg = CONFIGS[args.config]
    if args.kv_bits != 16:
        cfg = dataclasses.replace(cfg, kv_bits=args.kv_bits)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={kind} config={args.config} bits={args.bits} "
          f"kv_bits={args.kv_bits} batch={args.batch}", file=sys.stderr)

    def fence() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    params = build_random_quant_params(cfg, args.bits, device=dev)
    if args.fuse:
        params = fuse_qkv_params(params)
    fence()
    print(f"params built+transferred in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (args.batch, args.prefill))).to(dev)
    mask = torch.ones((args.batch, args.prefill), dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev)

    def run(n_tokens: int) -> float:
        sp = SamplingParams(max_new_tokens=n_tokens, temperature=0.0, eos_id=-1)
        gen.manual_seed(0)
        t0 = time.perf_counter()
        generate_tokens(params, cfg, ids, mask, gen, sp)
        fence()
        return time.perf_counter() - t0

    for n in (args.n1, args.n2):  # the first calls load the kernels and allocate
        t = run(n)
        print(f"warmup n={n}: {t:.2f}s (includes the kernels' first calls)", file=sys.stderr)

    t1s = [run(args.n1) for _ in range(args.runs)]
    t2s = [run(args.n2) for _ in range(args.runs)]
    t1, t2 = float(np.median(t1s)), float(np.median(t2s))
    ms_per_tok = (t2 - t1) * 1000.0 / (args.n2 - args.n1)
    print(json.dumps({
        "config": args.config, "bits": args.bits, "kv_bits": args.kv_bits,
        "batch": args.batch, "prefill": args.prefill,
        "decode_ms_per_token": round(ms_per_tok, 4),
        "tokens_per_sec": round(args.batch * 1000.0 / ms_per_tok, 2),
        "t_n1_s": round(t1, 4), "t_n2_s": round(t2, 4), "device": kind,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
