"""Params-tree checkpoints: ``crs_tpu``'s npz + json manifest format (port of
``crs_tpu.utils.checkpoint``).

Arrays are stored path-keyed in one compressed npz (bf16 as float32 with a
dtype tag); :class:`~crs_tpu_torch.models.quantized.QuantizedTensor` nodes
keep their bits, group size and shape in the manifest, and
:class:`~crs_tpu_torch.finetuning.lora.LoRAWeight` nodes their alpha and rank
(the base, A and B as children). Checkpoints written by either package load
in the other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

__all__ = ["save_pytree", "load_pytree"]


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` (dicts, lists, tensors, QuantizedTensor and LoRAWeight
    nodes) to ``path.npz`` + ``path.json``."""
    from ..finetuning.lora import LoRAWeight
    from ..models.quantized import QuantizedTensor

    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {"nodes": {}, "arrays": {}}

    def visit(prefix: str, node: Any) -> None:
        if isinstance(node, QuantizedTensor):
            manifest["nodes"][prefix] = {"kind": "QuantizedTensor", "bits": node.bits,
                                         "group_size": node.group_size, "shape": list(node.shape)}
            visit(f"{prefix}.codes", node.codes)
            visit(f"{prefix}.scales", node.scales)
        elif isinstance(node, LoRAWeight):
            manifest["nodes"][prefix] = {"kind": "LoRAWeight", "alpha": node.alpha,
                                         "rank": node.rank}
            visit(f"{prefix}.base", node.base)
            visit(f"{prefix}.lora_a", node.lora_a)
            visit(f"{prefix}.lora_b", node.lora_b)
        elif isinstance(node, dict):
            manifest["nodes"][prefix] = {"kind": "dict", "keys": list(node.keys())}
            for k, v in node.items():
                visit(f"{prefix}.{k}" if prefix else str(k), v)
        elif isinstance(node, list):
            manifest["nodes"][prefix] = {"kind": "list", "len": len(node)}
            for i, v in enumerate(node):
                visit(f"{prefix}[{i}]", v)
        else:
            t = node.detach().cpu()
            dtype = str(t.dtype).removeprefix("torch.")  # numpy's names, as crs_tpu writes them
            key = f"a{len(arrays)}"
            arrays[key] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
            manifest["arrays"][prefix] = {"key": key, "dtype": dtype}

    visit("", tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)


def load_pytree(path: str, device: Optional[Union[str, torch.device]] = "cpu") -> Any:
    """Read a tree written by :func:`save_pytree` or by ``crs_tpu``'s, with
    its tensors on ``device`` (a LoRA node's A and B requiring a gradient)."""
    from ..finetuning.lora import LoRAWeight
    from ..models.quantized import QuantizedTensor

    with open(path + ".json") as f:
        manifest = json.load(f)
    data = np.load(path + ".npz")
    nodes, arr_meta = manifest["nodes"], manifest["arrays"]

    def build(prefix: str) -> Any:
        if prefix in arr_meta:
            info = arr_meta[prefix]
            t = torch.from_numpy(np.array(data[info["key"]]))
            if info["dtype"] == "bfloat16":
                t = t.to(torch.bfloat16)
            return t.to(device)
        info = nodes[prefix]
        kind = info["kind"]
        if kind == "dict":
            return {k: build(f"{prefix}.{k}" if prefix else str(k)) for k in info["keys"]}
        if kind == "list":
            return [build(f"{prefix}[{i}]") for i in range(info["len"])]
        if kind == "QuantizedTensor":
            return QuantizedTensor(build(f"{prefix}.codes"), build(f"{prefix}.scales"),
                                   info["bits"], info["group_size"], tuple(info["shape"]))
        if kind == "LoRAWeight":
            return LoRAWeight(build(f"{prefix}.base"),
                              build(f"{prefix}.lora_a").requires_grad_(True),
                              build(f"{prefix}.lora_b").requires_grad_(True),
                              info["alpha"], info["rank"])
        raise ValueError(f"unknown node kind: {kind}")

    return build("")
