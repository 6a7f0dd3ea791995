"""Load a local Hugging Face Llama/Mistral checkpoint into the port's params
tree (port of ``crs_tpu.models.hf_loader``).

Local files only: the loader never touches the network. Weights come from
``*.safetensors`` shards (through ``safetensors``, imported only when a
directory holds such shards) or ``pytorch_model*.bin`` files (``torch.load``
with ``weights_only``). Neither ``safetensors`` nor ``transformers`` is
imported at module level.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional, Tuple, Union

import torch

from .transformer import TransformerConfig

logger = logging.getLogger(__name__)

__all__ = ["load_hf_causal_lm", "config_from_hf"]


def config_from_hf(config: Dict[str, Any], dtype: torch.dtype = torch.bfloat16) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=config["vocab_size"],
        hidden_size=config["hidden_size"],
        num_layers=config["num_hidden_layers"],
        num_heads=config["num_attention_heads"],
        num_kv_heads=config.get("num_key_value_heads", config["num_attention_heads"]),
        intermediate_size=config["intermediate_size"],
        max_seq_len=min(config.get("max_position_embeddings", 4096), 8192),
        rope_theta=float(config.get("rope_theta", 10000.0)),
        rms_eps=float(config.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(config.get("tie_word_embeddings", False)),
        dtype=dtype,
    )


def _load_state_dict(path: str) -> Optional[Dict[str, torch.Tensor]]:
    """Tensors from the safetensors shard(s) or the torch ``.bin`` file(s) of
    ``path``, as f32 on the CPU; None when there are none or they fail to
    load (``safetensors`` not installed included)."""
    try:
        files = sorted(os.listdir(path))
        shards = [f for f in files if f.endswith(".safetensors") and not f.startswith(".")]
        bins = [f for f in files if f.endswith(".bin")]
        state: Dict[str, torch.Tensor] = {}
        if shards:
            from safetensors.torch import load_file  # type: ignore

            for name in shards:
                sd = load_file(os.path.join(path, name))
                state.update({k: v.float() for k, v in sd.items()})
            return state
        if bins:
            for name in bins:
                sd = torch.load(os.path.join(path, name), map_location="cpu", weights_only=True)
                state.update({k: v.float() for k, v in sd.items()})
            return state
    except Exception as e:  # a corrupt or unreadable checkpoint: the caller raises
        logger.warning("failed to load checkpoint from %s: %s", path, e)
    return None


def load_hf_causal_lm(path: str, dtype: torch.dtype = torch.bfloat16,
                      device: Optional[Union[str, torch.device]] = "cpu",
                      ) -> Optional[Tuple[TransformerConfig, Dict[str, Any]]]:
    """(config, params on ``device``) from a local HF Llama/Mistral checkpoint
    directory; None when it holds no ``config.json`` or no weights."""
    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        return None
    with open(cfg_path) as f:
        hf_cfg = json.load(f)
    cfg = config_from_hf(hf_cfg, dtype)
    state = _load_state_dict(path)
    if state is None:
        return None

    def get(name: str) -> torch.Tensor:
        key = name if name in state else "model." + name
        return state[key].to(device).to(dtype)

    def lin(name: str) -> torch.Tensor:  # torch [out, in] → [in, out]
        return get(name + ".weight").T.contiguous()

    params: Dict[str, Any] = {
        "embed": get("embed_tokens.weight"),
        "layers": [],
        "final_norm": {"scale": get("norm.weight")},
    }
    for i in range(cfg.num_layers):
        base = f"layers.{i}."
        params["layers"].append({
            "attn_norm": {"scale": get(base + "input_layernorm.weight")},
            "attn": {
                "q": lin(base + "self_attn.q_proj"),
                "k": lin(base + "self_attn.k_proj"),
                "v": lin(base + "self_attn.v_proj"),
                "o": lin(base + "self_attn.o_proj"),
            },
            "mlp_norm": {"scale": get(base + "post_attention_layernorm.weight")},
            "mlp": {
                "gate": lin(base + "mlp.gate_proj"),
                "up": lin(base + "mlp.up_proj"),
                "down": lin(base + "mlp.down_proj"),
            },
        })
    if not cfg.tie_embeddings:
        params["lm_head"] = state["lm_head.weight"].to(device).to(dtype).T.contiguous()
    logger.info("Loaded HF checkpoint from %s (%d layers)", path, cfg.num_layers)
    return cfg, params
