"""Weight-only quantized tensors and the quantized matmul (port of
``crs_tpu.models.quantized``).

A weight matrix [in, out] becomes a :class:`QuantizedTensor`:

- int8: ``codes`` [in, out] int8, ``scales`` [out] per output channel;
- int4: ``codes`` [in/2, out] int8 (two sign-extended nibbles per byte along
  the input dim, low nibble = even row), ``scales`` [in/group, out];
- nf4: the same layout with unsigned nibble indices into
  ``ops.qgemm.NF4_LEVELS`` (uint8 codes) and group-wise absmax scales;
- int2 / int3: unpacked int8 codes with group scales.

:func:`quantize_tensor` does the numpy original's arithmetic in torch, on any
device, and gives its codes and scales bit for bit. :func:`qmatmul` routes as
``crs_tpu`` does: int8 through the exact int8 × int8 product with per-row
activation quantization; int4 / nf4 at decode-sized row counts through the
CUDA kernels of ``ops.qgemm`` (their plain versions on the CPU); everything
else through the dequantized product; a :class:`~crs_tpu_torch.finetuning.lora.LoRAWeight`
adds its adapters' delta to its base's product.

Gradients follow ``crs_tpu``'s custom VJPs: through the int8 route and the
int4 / NF4 kernels, dx = g·W_dequantᵀ in f32 (``_Int8ActMatmul`` here,
``ops.qgemm``'s functions for kernels 8 and 9); the codes and scales get
none. (``round`` in the activation quantizer would otherwise zero every
gradient through an int8 layer.)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.qgemm import NF4_LEVELS, nf4_matmul, q4_matmul, q4_pallas_supported
from ..ops.quant import int8_product as _int8_product

__all__ = [
    "QuantizedTensor", "qmatmul", "quantize_tensor", "tensor_from_int_codes",
    "quantize_params", "params_num_bytes",
]

_INV_127 = float(np.float32(1.0) / np.float32(127.0))  # XLA's x / 127 under jit


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """A quantized weight [in, out] (see the module docstring for layouts)."""

    codes: torch.Tensor
    scales: torch.Tensor
    bits: Union[int, str]
    group_size: int
    shape: Tuple[int, int]

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16

    def unpack_codes(self) -> torch.Tensor:
        """int4 only: [in/2, out] nibbles → [in, out] int8 in [-8, 7]."""
        p = self.codes.to(torch.int32)
        lo = torch.bitwise_right_shift(torch.bitwise_left_shift(p, 28), 28)
        hi = torch.bitwise_right_shift(p, 4)
        return torch.stack([lo, hi], dim=1).reshape(self.shape).to(torch.int8)

    def dequantize(self) -> torch.Tensor:
        """The f32 weight [in, out]: codes (or NF4 levels) × scales in f32."""
        kin, kout = self.shape
        if self.bits == 8:
            return self.codes.float() * self.scales[None, :]
        if self.bits == "nf4":
            p = self.codes.to(torch.int32)
            lut = torch.from_numpy(NF4_LEVELS).to(p.device)
            vals = torch.stack([lut[p & 0xF], lut[torch.bitwise_right_shift(p, 4) & 0xF]],
                               dim=1).reshape(kin, kout)
        else:
            vals = (self.unpack_codes() if self.bits == 4 else self.codes).float()
        g = self.scales.shape[0]
        return (vals.reshape(g, kin // g, kout) * self.scales[:, None, :]).reshape(kin, kout)


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` as a true f32 division (numpy's): the divisor is a tensor,
    so no kernel replaces it with a product by the reciprocal."""
    return a / torch.full_like(a, c)


def _pack_nibbles(vals: torch.Tensor) -> torch.Tensor:
    """[in, out] int8 in [-8, 7] → [in/2, out] int8, row 2i low, 2i+1 high."""
    pairs = vals.reshape(vals.shape[0] // 2, 2, vals.shape[1])
    lo = pairs[:, 0, :].to(torch.int16) & 0x0F
    hi = torch.bitwise_left_shift(pairs[:, 1, :].to(torch.int16), 4)
    return (lo | hi).to(torch.int8)


def quantize_tensor(w, bits: Union[int, str] = 8, group_size: int = 128) -> QuantizedTensor:
    """Quantize ``w`` [in, out] (a tensor, on its device, or an array) with
    the arithmetic of ``crs_tpu``'s numpy ``quantize_tensor``."""
    w = (w if isinstance(w, torch.Tensor) else torch.from_numpy(np.asarray(w))).float()
    kin, kout = w.shape
    if bits == 8:
        scales = _div(torch.clamp_min(w.abs().amax(dim=0), 1e-12), 127.0)
        codes = torch.clamp(torch.round(w / scales[None, :]), -127, 127).to(torch.int8)
        return QuantizedTensor(codes, scales, 8, 0, (kin, kout))
    if bits in (4, "nf4"):
        if kin % group_size != 0 or kin % 2 != 0:
            group_size = kin if kin % 2 == 0 else 0
        if group_size == 0:
            raise ValueError(f"{bits} requires an even input dim")
        g = kin // group_size
        grouped = w.reshape(g, group_size, kout)
        amax = grouped.abs().amax(dim=1)
        if bits == 4:
            scales = _div(torch.clamp_min(amax, 1e-12), 7.0)
            vals = torch.clamp(torch.round(grouped / scales[:, None, :]), -7, 7).to(torch.int8)
            return QuantizedTensor(_pack_nibbles(vals.reshape(kin, kout)), scales, 4, group_size,
                                   (kin, kout))
        # nf4: per-group absmax to [-1, 1], then the nearest of the 16 levels
        scales = torch.clamp_min(amax, 1e-12)
        norm = grouped / scales[:, None, :]
        levels = torch.from_numpy(NF4_LEVELS).to(w.device)
        mids = _div(levels[1:] + levels[:-1], 2.0)
        idx = torch.searchsorted(mids, norm.contiguous()).to(torch.uint8).reshape(kin // 2, 2, kout)
        packed = idx[:, 0, :] | torch.bitwise_left_shift(idx[:, 1, :], 4)
        return QuantizedTensor(packed, scales, "nf4", group_size, (kin, kout))
    if bits in (2, 3):
        if kin % group_size != 0:
            group_size = kin
        g = kin // group_size
        qmax = (1 << (bits - 1)) - 1  # 1 for 2-bit, 3 for 3-bit
        grouped = w.reshape(g, group_size, kout)
        scales = _div(torch.clamp_min(grouped.abs().amax(dim=1), 1e-12), float(qmax))
        vals = torch.clamp(torch.round(grouped / scales[:, None, :]), -qmax, qmax).to(torch.int8)
        return QuantizedTensor(vals.reshape(kin, kout), scales, bits, group_size, (kin, kout))
    raise ValueError(f"unsupported bits: {bits}")


def tensor_from_int_codes(vals, scales, bits: int, group_size: int) -> QuantizedTensor:
    """A QuantizedTensor from precomputed integer codes [in, out] and group
    scales; int4 nibbles packed as :func:`quantize_tensor` packs them."""
    vals = (vals if isinstance(vals, torch.Tensor) else torch.from_numpy(np.asarray(vals)))
    vals = vals.to(torch.int8)
    scales = (scales if isinstance(scales, torch.Tensor)
              else torch.from_numpy(np.asarray(scales))).float()
    kin, kout = vals.shape
    if bits == 4:
        return QuantizedTensor(_pack_nibbles(vals), scales, 4, group_size, (kin, kout))
    if bits in (2, 3):
        return QuantizedTensor(vals, scales, bits, group_size, (kin, kout))
    raise ValueError(f"unsupported bits for int-code tensors: {bits}")


def _int8_act_forward(x2: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Per-row dynamic int8 activations × int8 weight, int32 accumulation,
    then both scales: ``crs_tpu``'s forward."""
    xs = torch.clamp_min(x2.abs().amax(dim=-1, keepdim=True), 1e-12) * _INV_127
    xq = torch.clamp(torch.round(x2 / xs), -127, 127).to(torch.int8)
    return _int8_product(xq, codes).float() * xs * scales[None, :]


class _Int8ActMatmul(torch.autograd.Function):
    """The int8 route with ``crs_tpu``'s custom VJP: the forward as
    :func:`_int8_act_forward`; dx = g·(codes·scales)ᵀ in f32; no gradient
    for the codes and scales."""

    @staticmethod
    def forward(ctx, x2, codes, scales):
        ctx.save_for_backward(codes, scales)
        return _int8_act_forward(x2, codes, scales)

    @staticmethod
    def backward(ctx, g):
        codes, scales = ctx.saved_tensors
        w = codes.float() * scales[None, :]
        return torch.matmul(g.float(), w.T), None, None


def _int8_act_matmul(x2: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The int8 route; through :class:`_Int8ActMatmul` when x2 needs a
    gradient (decode does not pay for the autograd node)."""
    if torch.is_grad_enabled() and x2.requires_grad:
        return _Int8ActMatmul.apply(x2, codes, scales)
    return _int8_act_forward(x2, codes, scales)


def qmatmul(x: torch.Tensor, w: Any,
            unrounded: Optional[Callable[[], torch.Tensor]] = None) -> torch.Tensor:
    """``x @ w`` for a plain weight or a :class:`QuantizedTensor`, in
    ``x``'s dtype, routed as ``crs_tpu`` routes it. ``unrounded()`` gives x
    in f32 before its last rounding, where x is the output of an elementwise
    op: XLA fuses that op into the int8 route's f32 convert, so the int8
    route quantizes ``unrounded()``. A ``LoRAWeight`` adds its adapters'
    delta (``finetuning.lora.apply_lora_matmul``)."""
    if type(w).__name__ == "LoRAWeight":  # the finetuning package imports this one
        from ..finetuning.lora import apply_lora_matmul

        return apply_lora_matmul(x, w, unrounded)
    if isinstance(w, QuantizedTensor):
        if w.bits == 8:
            x2 = (x.float() if unrounded is None else unrounded()).reshape(-1, x.shape[-1])
            out = _int8_act_matmul(x2, w.codes, w.scales)
            return out.reshape(*x.shape[:-1], -1).to(x.dtype)
        if w.bits in (4, "nf4"):
            x2 = x.reshape(-1, x.shape[-1])
            k2, n = w.codes.shape
            if q4_pallas_supported(x2.shape[0], k2, n, w.scales.shape[0]):
                mm = nf4_matmul if w.bits == "nf4" else q4_matmul
                out = mm(x2, w.codes, w.scales)
                return out.reshape(*x.shape[:-1], -1).to(x.dtype)
        return _dot(x, w.dequantize().to(x.dtype))
    return _dot(x, w.to(x.dtype))


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``dot(x, w, preferred f32).astype(x.dtype)``: a bf16 product sums in
    f32 and rounds once (on the card with
    ``allow_bf16_reduced_precision_reduction`` off)."""
    if x.is_cuda and x.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("f32 products need torch.backends.cuda.matmul.allow_tf32 = False")
    return torch.matmul(x, w)


_QUANT_SKIP = ("embed", "scale", "norm")


def quantize_params(params: Dict[str, Any], bits: Union[int, str] = 8,
                    group_size: int = 128) -> Dict[str, Any]:
    """Quantize every 2-D weight of a params tree; embeddings and norms stay
    in full precision (``crs_tpu``'s rule, by path)."""

    def visit(path: str, node: Any) -> Any:
        if isinstance(node, dict):
            return {k: visit(f"{path}.{k}", v) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(f"{path}[{i}]", v) for i, v in enumerate(node)]
        if isinstance(node, torch.Tensor) and node.dim() == 2 and not any(
                s in path for s in _QUANT_SKIP):
            return quantize_tensor(node, bits=bits, group_size=group_size)
        return node

    return visit("", params)


def params_num_bytes(params: Any) -> int:
    """Total parameter bytes (packed int4 / nf4 at their stored width; a
    LoRA node's base and adapters)."""
    if isinstance(params, QuantizedTensor):
        return params_num_bytes(params.codes) + params_num_bytes(params.scales)
    if type(params).__name__ == "LoRAWeight":
        return sum(params_num_bytes(t) for t in (params.base, params.lora_a, params.lora_b))
    if isinstance(params, dict):
        return sum(params_num_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(params_num_bytes(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0
