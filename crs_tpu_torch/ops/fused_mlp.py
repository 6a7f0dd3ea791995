"""The fused SwiGLU MLP decode block over int8 weights (port of
``crs_tpu.ops.fused_mlp``).

For decode-sized rows x [B ≤ 8, H] it computes, in one call,

    y = x + W_down( silu(W_gate·xn) · W_up·xn ),   xn = rmsnorm(x) · g

with the arithmetic of the Pallas kernel (``_kernel``): xn quantized to
int8 per row; gate and up as exact int32 dots, scaled as
``f32(acc)·xs·s``; ``hmid = sigmoid(g)·g·u`` re-quantized per (row, chunk of
I); each chunk's int32 down dot added into ``y`` as ``f32(acc)·hs`` in chunk
order; finally ``x + y·s_down``.

Weight layout (:func:`fused_mlp_layout`): gate and up transposed to [I, H]
int8 with their per-I scales as [I / chunk, chunk]; down in its stored
[I, H] layout with per-H scales.

:func:`fused_mlp_int8` is the wrapper of the CUDA kernel in
``csrc/fused_mlp_int8.cu``: one launch a call, a thread-block cluster of 8
CTAs per chunk of I, at any chunk that divides I. On a CUDA tensor it launches the kernel or raises; on
a CPU tensor it runs :func:`emulate_fused_mlp_int8`, the plain torch version
beside it. Both can return the int8 codes and scales they
formed (``return_codes``), which is how the card's check holds one against
the other: XLA, torch and the kernel each sum the squares and evaluate
``exp`` their own way, so a last-ulp difference in ``xs`` or ``hs`` can move
one code by a step.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .launch import ARG_FLOAT, ARG_INT, ARG_PTR, KernelStats, check_operands, launch, \
    load_library, scratch, stream_handle
from .quant import int8_product

__all__ = [
    "STATS", "FusedMLPCodes", "fused_mlp_supported", "fused_mlp_layout", "fused_mlp_int8",
    "emulate_fused_mlp_int8", "MAX_ROWS", "CLUSTER",
]

STATS = KernelStats()
MAX_ROWS = 8  # decode-sized rows: the Pallas kernel's padded row tile

_SOURCE = "fused_mlp_int8.cu"
_LAUNCHER = "fused_mlp_int8_launch"
_INV_127 = float(np.float32(1.0) / np.float32(127.0))  # XLA's x / 127 under jit
CLUSTER = 8  # CTAs of one chunk's thread-block cluster (csrc/fused_mlp_int8.cu)
# the kernel library's own plan of what outgrows shared memory: whether a
# call keeps hq and hmid in device memory, and the bytes of its slab a chunk
_HQ_IN_SLAB = "fused_mlp_int8_hq_in_slab"
_HG_SLAB_BYTES = "fused_mlp_int8_hg_slab_bytes"


class FusedMLPCodes(NamedTuple):
    """What one call formed on its way: xq [B, H] int8, xs [B] f32, hq
    [B, I] int8, hs [B, I / chunk] f32."""

    xq: torch.Tensor
    xs: torch.Tensor
    hq: torch.Tensor
    hs: torch.Tensor


def fused_mlp_supported(batch: int, hidden: int, inter: int, chunk: int = 1024) -> bool:
    """Shape gate: decode-sized batch, lane-aligned dims, chunkable I."""
    return batch <= MAX_ROWS and hidden % 128 == 0 and inter % chunk == 0


def fused_mlp_layout(gate_codes, gate_scales, up_codes, up_scales, down_codes, down_scales,
                     chunk: int = 1024):
    """QuantizedTensor int8 layout → the kernel's layout: (gate_t, s_gate2,
    up_t, s_up2, down, s_down), gate / up transposed to [I, H] (a copy),
    their per-I scales as [I / chunk, chunk]; down and its scales as they
    are."""
    inter = gate_codes.shape[1]
    nchunks = inter // chunk
    return (
        gate_codes.T.contiguous(), gate_scales.reshape(nchunks, chunk),
        up_codes.T.contiguous(), up_scales.reshape(nchunks, chunk),
        down_codes, down_scales,
    )


def _recip32(c: int) -> float:
    """float32(1) / float32(c): what XLA multiplies by for ``x / c``."""
    return float(np.float32(1.0) / np.float32(c))


def _quantize_rows(v: torch.Tensor):
    """Per-row int8 over the last dim: (codes, scales), scale
    max(|v|)·f32(1/127), codes round-half-even of a true division."""
    amax = v.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) * _INV_127
    return torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8), scale


def emulate_fused_mlp_int8(x, norm_scale, gate_t, s_gate2, up_t, s_up2, down, s_down,
                           chunk: int = 1024, eps: float = 1e-5, return_codes: bool = False):
    """The Pallas body's arithmetic, op by op, in plain torch → [B, H] f32
    (and :class:`FusedMLPCodes` with ``return_codes``)."""
    x = x.float()
    h = x.shape[1]
    nchunks = gate_t.shape[0] // chunk
    var = torch.sum(torch.square(x), dim=1, keepdim=True) * _recip32(h)  # jnp.mean
    xn = x * torch.rsqrt(var + eps)
    xn = xn * norm_scale.float()[None, :]
    xq, xs = _quantize_rows(xn)
    y = torch.zeros_like(x)
    hqs, hss = [], []
    for ci in range(nchunks):
        rows = slice(ci * chunk, (ci + 1) * chunk)
        acc_g = int8_product(xq, gate_t[rows].T).float()
        acc_u = int8_product(xq, up_t[rows].T).float()
        g = acc_g * xs * s_gate2[ci][None, :]
        u = acc_u * xs * s_up2[ci][None, :]
        hmid = (1.0 / (1.0 + torch.exp(-g))) * g * u  # jax.nn.sigmoid: 1 / (1 + exp(−g))
        hq, hs = _quantize_rows(hmid)
        y = y + int8_product(hq, down[rows]).float() * hs
        hqs.append(hq)
        hss.append(hs)
    out = x + y * s_down.float()[None, :]
    if return_codes:
        return out, FusedMLPCodes(xq, xs[:, 0], torch.cat(hqs, 1), torch.cat(hss, 1))
    return out


def _part_floats(lib, b: int, h: int, inter: int, chunk: int) -> int:
    """``part``'s f32 elements: the chunks' [B, H] terms of y, then, where
    the kernel keeps hq and hmid in device memory (its HG instance), a slab
    a chunk of the size the kernel library gives."""
    nchunks = inter // chunk
    slab = getattr(lib, _HG_SLAB_BYTES)(b, chunk) // 4 if getattr(lib, _HQ_IN_SLAB)(h, chunk) else 0
    return nchunks * (b * h + slab)


def _load():
    return load_library(_SOURCE, {_LAUNCHER: [ARG_PTR] * 15 + [ARG_INT] * 4 + [ARG_FLOAT]
                                  + [ARG_PTR], _HQ_IN_SLAB: [ARG_INT] * 2,
                                  _HG_SLAB_BYTES: [ARG_INT] * 2},
                        {_HG_SLAB_BYTES: ctypes.c_longlong})


def fused_mlp_int8(x, norm_scale, gate_t, s_gate2, up_t, s_up2, down, s_down,
                   chunk: int = 1024, eps: float = 1e-5, return_codes: bool = False):
    """One fused decode MLP block: x [B ≤ 8, H] → x + SwiGLU-MLP(rmsnorm(x))
    [B, H] f32 (and :class:`FusedMLPCodes` with ``return_codes``). CPU
    tensors take :func:`emulate_fused_mlp_int8`; CUDA tensors launch
    ``fused_mlp_int8`` or raise."""
    if gate_t.device.type == "cpu":
        return emulate_fused_mlp_int8(x, norm_scale, gate_t, s_gate2, up_t, s_up2, down, s_down,
                                      chunk, eps, return_codes)
    dev = gate_t.device
    if x.dim() != 2 or gate_t.dim() != 2:
        raise ValueError("x must be [B, H] and gate_t [I, H]")
    b, h = x.shape
    inter = gate_t.shape[0]
    if not 1 <= b <= MAX_ROWS:
        raise ValueError(f"the kernel takes 1..{MAX_ROWS} rows, got {b}")
    if h % 128 or chunk < 1 or inter % chunk or inter == 0:
        raise ValueError(f"H ({h}) must be a multiple of 128 and I ({inter}) a positive "
                         f"multiple of the chunk ({chunk})")
    nchunks = inter // chunk
    for name, t, shape in (("gate_t", gate_t, (inter, h)), ("up_t", up_t, (inter, h)),
                           ("down", down, (inter, h)), ("s_gate2", s_gate2, (nchunks, chunk)),
                           ("s_up2", s_up2, (nchunks, chunk)), ("s_down", s_down, (h,)),
                           ("norm_scale", norm_scale, (h,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    xf = x.float().contiguous()
    gf = norm_scale.float().contiguous()
    check_operands(dev, ("x", xf, torch.float32), ("norm_scale", gf, torch.float32),
                   ("gate_t", gate_t, torch.int8), ("s_gate2", s_gate2, torch.float32),
                   ("up_t", up_t, torch.int8), ("s_up2", s_up2, torch.float32),
                   ("down", down, torch.int8), ("s_down", s_down, torch.float32))
    lib = _load()
    stream = stream_handle(dev)
    # each chunk's term of y (f32, [chunks, B, H]; past shared memory also
    # each chunk's hq and hmid) and the ranks' counters, which the last CTA
    # of each rank reads and resets
    part = scratch(dev, stream, "mlp_part", _part_floats(lib, b, h, inter, chunk), torch.float32)
    counters = scratch(dev, stream, "mlp_counters", CLUSTER, torch.int32, zero=True)
    out = torch.empty((b, h), dtype=torch.float32, device=dev)
    codes = None
    if return_codes:
        codes = FusedMLPCodes(torch.empty((b, h), dtype=torch.int8, device=dev),
                              torch.empty((b,), dtype=torch.float32, device=dev),
                              torch.empty((b, inter), dtype=torch.int8, device=dev),
                              torch.empty((b, nchunks), dtype=torch.float32, device=dev))
    code_ptrs = [t.data_ptr() for t in codes] if codes else [None] * 4
    launch(STATS, "fused_mlp_int8", getattr(lib, _LAUNCHER),
           xf.data_ptr(), gf.data_ptr(), gate_t.data_ptr(), s_gate2.data_ptr(), up_t.data_ptr(),
           s_up2.data_ptr(), down.data_ptr(), s_down.data_ptr(), part.data_ptr(),
           counters.data_ptr(), out.data_ptr(), *code_ptrs, b, h, inter, chunk, float(eps),
           stream)
    if return_codes:
        return out, codes
    return out
