"""JSON configuration loading with sectioned getters and dotted-path updates
(the port's own copy of ``crs_tpu.utils.config``).

A single JSON tree merged over ``DEFAULT_CONFIG``, per-section accessors
returning sub-dicts (missing sections yield ``{}`` so every component can
apply its own defaults), dotted-key lookups and updates, and save.
"""

from __future__ import annotations

import copy
import json
import logging
from pathlib import Path
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)

__all__ = ["ConfigLoader", "DEFAULT_CONFIG"]


# A minimal but complete default tree so the framework runs with no config
# file at all: ``crs_tpu``'s defaults (chunking semantic/512/128, MiniLM
# 384-d batch 32 normalized, retrieval top_k=3 threshold 0.3 rerank
# diversity 0.1, k_values [1,3,5,10]). The model type "jax" names
# ``crs_tpu``'s unquantized model, which the port's model table also takes.
DEFAULT_CONFIG: Dict[str, Any] = {
    "rag": {
        "document_processing": {"clean_text": True, "extract_sections": True},
        "chunking": {
            "strategy": "semantic",
            "chunk_size": 512,
            "chunk_overlap": 128,
            "min_chunk_size": 150,
        },
        "embedding": {
            "backend": "minilm",
            "model_name": "sentence-transformers/all-MiniLM-L6-v2",
            "embedding_dim": 384,
            "batch_size": 32,
            "normalize": True,
        },
        "retrieval": {
            "top_k": 3,
            "similarity_threshold": 0.3,
            "rerank": True,
            "diversity_penalty": 0.1,
        },
        "generation": {
            "max_new_tokens": 256,
            "temperature": 0.3,
            "top_p": 0.9,
            "repetition_penalty": 1.15,
        },
        "vector_store": {
            "format": "fp32",
            "block_size": 1024,
            "persist_directory": None,
            "metric": "cosine",
        },
    },
    "model": {"type": "jax", "config": "tiny", "dtype": "bfloat16"},
    "evaluation": {
        "efficiency": {"num_warmup": 3, "num_runs": 10, "max_new_tokens": 64},
        "performance": {"perplexity": {"max_samples": 100, "max_length": 512}},
        "retrieval": {"k_values": [1, 3, 5, 10]},
    },
}


class ConfigLoader:
    """Load/merge/save a JSON config tree with sectioned access."""

    def __init__(self, config_path: Optional[str] = None):
        self.config_path = config_path
        self.config: Dict[str, Any] = copy.deepcopy(DEFAULT_CONFIG)
        if config_path is not None:
            self._load(config_path)

    def _load(self, path: str) -> None:
        with open(path) as f:
            user = json.load(f)
        self.config = _deep_merge(self.config, user)
        logger.info("Loaded config from %s", path)

    # -- sectioned getters -------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        """Dotted-path lookup, e.g. ``get('rag.retrieval.top_k')``."""
        node: Any = self.config
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def get_model_config(self) -> Dict[str, Any]:
        return self.config.get("model", {})

    def get_rag_config(self) -> Dict[str, Any]:
        return self.config.get("rag", {})

    def get_evaluation_config(self) -> Dict[str, Any]:
        return self.config.get("evaluation", {})

    def get_efficiency_config(self) -> Dict[str, Any]:
        return self.get("evaluation.efficiency", {}) or {}

    def get_performance_config(self) -> Dict[str, Any]:
        return self.get("evaluation.performance", {}) or {}

    def get_retrieval_config(self) -> Dict[str, Any]:
        return self.get("evaluation.retrieval", {}) or {}

    def get_finetuning_config(self) -> Dict[str, Any]:
        return self.config.get("finetuning", {})

    # -- updates -----------------------------------------------------------
    def update_config(self, dotted_key: str, value: Any) -> None:
        """Set a value by dotted path, creating intermediate dicts."""
        parts = dotted_key.split(".")
        node = self.config
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise TypeError(f"{dotted_key}: {part} is not a dict")
        node[parts[-1]] = value

    def save_config(self, path: Optional[str] = None) -> None:
        target = path or self.config_path
        if target is None:
            raise ValueError("no path to save config to")
        Path(target).parent.mkdir(parents=True, exist_ok=True)
        with open(target, "w") as f:
            json.dump(self.config, f, indent=2)


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out
