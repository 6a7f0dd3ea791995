"""LoRA adapters over (optionally quantized) transformer weights (port of
``crs_tpu.finetuning.lora``).

QLoRA's shape: low-rank A / B factors on the seven projections (q, k, v, o,
gate, up, down) over a frozen base kept in its quantized form.
:class:`LoRAWeight` is a params-tree node that ``qmatmul`` dispatches on:
``x @ W_base + (x @ A) @ B · (α / r)``, with ``crs_tpu``'s rounding order
(:func:`apply_lora_matmul`). A and B are the tree's only tensors that
require a gradient (leaf tensors); the base stays frozen.

``crs_tpu`` draws A from ``jax.random``, which torch cannot reproduce:
:func:`add_lora` draws it from a ``torch.Generator`` the caller seeds, and
``convert.params_from_numpy`` carries ``crs_tpu``'s own A's across.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["LoRAWeight", "add_lora", "lora_trainable_mask", "merge_lora", "extract_lora",
           "apply_lora_matmul", "lora_nodes", "adapter_tensors", "DEFAULT_TARGETS"]

# the seven projection targets
DEFAULT_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")


@dataclasses.dataclass(frozen=True)
class LoRAWeight:
    """base (a tensor or QuantizedTensor) + trainable low-rank A / B."""

    base: Any
    lora_a: torch.Tensor  # [in, r]
    lora_b: torch.Tensor  # [r, out]
    alpha: float
    rank: int

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    @property
    def shape(self):
        return tuple(self.base.shape)

    @property
    def dtype(self):
        return getattr(self.base, "dtype", torch.bfloat16)


def _base_device(w: Any) -> torch.device:
    return (w.codes if hasattr(w, "codes") else w).device


def add_lora(params: Dict[str, Any], generator: torch.Generator, rank: int = 16,
             alpha: float = 32.0, targets: Tuple[str, ...] = DEFAULT_TARGETS,
             dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Wrap the target attention / MLP weights of a params tree in LoRA.

    A is normal · in^-0.5 (drawn in f32 on the host from ``generator``, a
    CPU generator, in layer order, so the card and the CPU get the same A's),
    B is zeros: the adapters start as the identity. Both are leaf tensors
    with ``requires_grad`` on the base's device."""

    def wrap(w: Any) -> LoRAWeight:
        kin, kout = w.shape
        dev = _base_device(w)
        a = torch.randn((kin, rank), generator=generator, dtype=torch.float32) * (kin ** -0.5)
        a = a.to(dtype).to(dev).requires_grad_(True)
        b = torch.zeros((rank, kout), dtype=dtype, device=dev).requires_grad_(True)
        return LoRAWeight(w, a, b, alpha, rank)

    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        new_layer = {k: dict(v) if isinstance(v, dict) else v for k, v in layer.items()}
        for grp in ("attn", "mlp"):
            for name in list(new_layer[grp]):
                if name in targets:
                    new_layer[grp][name] = wrap(new_layer[grp][name])
        out["layers"].append(new_layer)
    return out


def lora_trainable_mask(params: Dict[str, Any]) -> Dict[str, Any]:
    """The tree with True on each lora_a / lora_b and False on every other
    leaf (a QuantizedTensor base: False codes and scales), as ``crs_tpu``'s
    optimizer mask."""

    def visit(node: Any) -> Any:
        if isinstance(node, LoRAWeight):
            base = node.base
            frozen = (dataclasses.replace(base, codes=False, scales=False)
                      if hasattr(base, "codes") else False)
            return LoRAWeight(frozen, True, True, node.alpha, node.rank)
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v) for v in node]
        return False

    return visit(params)


def merge_lora(params: Dict[str, Any]) -> Dict[str, Any]:
    """Fold the adapters into dense base weights (inference export).

    A quantized base is dequantized first: the merged weight is
    ``(dense + A·B·scale)`` in f32, rounded to the base's dtype (bf16)."""

    def visit(node: Any) -> Any:
        if isinstance(node, LoRAWeight):
            base = node.base
            with torch.no_grad():
                dense = base.dequantize() if hasattr(base, "dequantize") else base.float()
                delta = (node.lora_a.float() @ node.lora_b.float()) * node.scaling
                return (dense + delta).to(getattr(base, "dtype", torch.bfloat16))
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v) for v in node]
        return node

    return visit(params)


def extract_lora(params: Dict[str, Any]) -> Dict[str, Any]:
    """Adapter-only state {path: {a, b, alpha, rank}} for saving; paths as
    ``crs_tpu`` names them (``layers[0].attn.q``)."""
    out: Dict[str, Any] = {}

    def visit(path: str, node: Any) -> None:
        if isinstance(node, LoRAWeight):
            out[path] = {"a": node.lora_a, "b": node.lora_b,
                         "alpha": node.alpha, "rank": node.rank}
        elif isinstance(node, dict):
            for k, v in node.items():
                visit(f"{path}.{k}" if path else k, v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                visit(f"{path}[{i}]", v)

    visit("", params)
    return out


def lora_nodes(params: Dict[str, Any]) -> List[LoRAWeight]:
    """The tree's LoRA nodes in the order of ``crs_tpu``'s flattened leaves
    (dict keys sorted)."""
    out: List[LoRAWeight] = []

    def visit(node: Any) -> None:
        if isinstance(node, LoRAWeight):
            out.append(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                visit(node[k])
        elif isinstance(node, list):
            for v in node:
                visit(v)

    visit(params)
    return out


def adapter_tensors(params: Dict[str, Any]) -> List[torch.Tensor]:
    """Every lora_a and lora_b of the tree, in :func:`lora_nodes`' order, a
    before b."""
    return [t for node in lora_nodes(params) for t in (node.lora_a, node.lora_b)]


def apply_lora_matmul(x: torch.Tensor, w: LoRAWeight,
                      unrounded: Optional[Callable[[], torch.Tensor]] = None) -> torch.Tensor:
    """x @ (base + A·B·scale), called from ``qmatmul``'s dispatch: the base
    product (``unrounded`` passed through, so an int8 base quantizes what it
    would alone), then dot(dot(x, A) → x's dtype, B) → the base product's
    dtype, then ``base_out + delta · scaling``."""
    from ..models.quantized import _dot, qmatmul

    base_out = qmatmul(x, w.base, unrounded)
    delta = _dot(_dot(x, w.lora_a.to(x.dtype)), w.lora_b.to(x.dtype)).to(base_out.dtype)
    return base_out + delta * w.scaling
