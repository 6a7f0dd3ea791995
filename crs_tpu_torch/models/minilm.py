"""MiniLM (6-layer BERT) sentence encoder (port of ``crs_tpu.models.minilm``).

all-MiniLM-L6-v2's architecture: 6 post-LN transformer layers, hidden 384,
12 heads, FFN 1,536, exact-erf GELU, learned positions, a −1e9 mask bias,
masked mean pooling and L2 normalization, all in plain f32 torch (no TPU
kernel sits on this path). Params are ``crs_tpu``'s nested-dict tree
(kernels [in, out]); ``init_minilm_params`` draws them from
``np.random.default_rng(seed)`` exactly as ``crs_tpu`` does, so a random
init is ``crs_tpu``'s bit for bit, and ``load_hf_bert_params`` converts a
Hugging Face BERT state dict.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["MiniLMConfig", "MiniLMEncoder", "init_minilm_params", "minilm_encode",
           "minilm_hidden_states", "load_hf_bert_params", "params_to_torch"]

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MiniLMConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def init_minilm_params(seed: int, cfg: MiniLMConfig) -> Params:
    """Deterministic truncated-normal init (std 0.02, BERT convention) as a
    numpy float32 tree. ``crs_tpu`` takes its numpy seed from the last word
    of ``PRNGKey(seed)``'s key data, which is ``seed``'s low 32 bits."""
    rng = np.random.default_rng(int(seed) & 0xFFFFFFFF)

    def trunc(shape) -> np.ndarray:
        w = rng.standard_normal(shape).astype(np.float32)
        return np.clip(w, -2.0, 2.0) * 0.02

    def dense(kin: int, kout: int) -> Params:
        return {"kernel": trunc((kin, kout)), "bias": np.zeros((kout,), np.float32)}

    def ln() -> Params:
        return {"scale": np.ones((cfg.hidden_size,), np.float32),
                "bias": np.zeros((cfg.hidden_size,), np.float32)}

    h, ffn = cfg.hidden_size, cfg.intermediate_size
    params: Params = {
        "embeddings": {
            "word": trunc((cfg.vocab_size, h)),
            "position": trunc((cfg.max_position_embeddings, h)),
            "token_type": trunc((cfg.type_vocab_size, h)),
            "ln": ln(),
        },
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append(
            {
                "attn": {"q": dense(h, h), "k": dense(h, h), "v": dense(h, h),
                         "out": dense(h, h), "ln": ln()},
                "ffn": {"up": dense(h, ffn), "down": dense(ffn, h), "ln": ln()},
            }
        )
    return params


def params_to_torch(tree: Any, device: Union[str, torch.device] = "cpu") -> Any:
    """A params tree of arrays (numpy, or ``crs_tpu``'s as numpy) as float32
    tensors on ``device``, bit for bit."""
    if isinstance(tree, dict):
        return {k: params_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_torch(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def _layer_norm(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    return x @ p["kernel"] + p["bias"]


def _attention(x: torch.Tensor, p: Params, mask: torch.Tensor, cfg: MiniLMConfig) -> torch.Tensor:
    b, s, h = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim

    def split(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(b, s, nh, hd).transpose(1, 2)  # [B, H, S, hd]

    q, k, v = split(_dense(x, p["q"])), split(_dense(x, p["k"])), split(_dense(x, p["v"]))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    bias = torch.where(mask[:, None, None, :], 0.0, -1e9).to(scores.dtype)
    probs = torch.softmax(scores + bias, dim=-1)
    ctx = (probs @ v).transpose(1, 2).reshape(b, s, h)
    return _dense(ctx, p["out"])


def minilm_hidden_states(params: Params, cfg: MiniLMConfig, ids: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Token-level hidden states [B, S, H] (the post-LN BERT stack)."""
    emb = params["embeddings"]
    s = ids.shape[1]
    x = emb["word"][ids] + emb["position"][:s][None, :, :] + emb["token_type"][0][None, None, :]
    x = _layer_norm(x, emb["ln"], cfg.layer_norm_eps)
    for layer in params["layers"]:
        a = _attention(x, layer["attn"], mask, cfg)
        x = _layer_norm(x + a, layer["attn"]["ln"], cfg.layer_norm_eps)
        f = _dense(torch.nn.functional.gelu(_dense(x, layer["ffn"]["up"])), layer["ffn"]["down"])
        x = _layer_norm(x + f, layer["ffn"]["ln"], cfg.layer_norm_eps)
    return x


def minilm_encode(params: Params, cfg: MiniLMConfig, ids: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Sentence embeddings: masked mean pool + L2 normalize → [B, H] f32."""
    x = minilm_hidden_states(params, cfg, ids, mask)
    m = mask[:, :, None].to(x.dtype)
    pooled = (x * m).sum(dim=1) / torch.clamp_min(m.sum(dim=1), 1e-9)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp_min(norm, 1e-12)


# -- Hugging Face weight conversion (only for a local checkpoint) ---------------

_HF_LAYER_MAP = [
    ("attention.self.query", ("attn", "q")),
    ("attention.self.key", ("attn", "k")),
    ("attention.self.value", ("attn", "v")),
    ("attention.output.dense", ("attn", "out")),
    ("intermediate.dense", ("ffn", "up")),
    ("output.dense", ("ffn", "down")),
]


def load_hf_bert_params(state_dict: Dict[str, Any], cfg: MiniLMConfig) -> Params:
    """A Hugging Face BERT state dict (numpy arrays) → the params tree (numpy
    float32). Keys may carry a ``bert.`` or ``0.auto_model.`` prefix; dense
    kernels are transposed from torch's [out, in] to [in, out]."""

    def get(name: str) -> np.ndarray:
        for prefix in ("", "bert.", "0.auto_model."):
            if prefix + name in state_dict:
                return np.asarray(state_dict[prefix + name], np.float32)
        raise KeyError(name)

    def dense(name: str) -> Params:
        return {"kernel": np.ascontiguousarray(get(name + ".weight").T),
                "bias": get(name + ".bias")}

    def ln(name: str) -> Params:
        return {"scale": get(name + ".weight"), "bias": get(name + ".bias")}

    params: Params = {
        "embeddings": {
            "word": get("embeddings.word_embeddings.weight"),
            "position": get("embeddings.position_embeddings.weight"),
            "token_type": get("embeddings.token_type_embeddings.weight"),
            "ln": ln("embeddings.LayerNorm"),
        },
        "layers": [],
    }
    for i in range(cfg.num_layers):
        base = f"encoder.layer.{i}."
        layer: Params = {"attn": {}, "ffn": {}}
        for hf_name, (grp, ours) in _HF_LAYER_MAP:
            layer[grp][ours] = dense(base + hf_name)
        layer["attn"]["ln"] = ln(base + "attention.output.LayerNorm")
        layer["ffn"]["ln"] = ln(base + "output.LayerNorm")
        params["layers"].append(layer)
    return params


class MiniLMEncoder(nn.Module):
    """The encoder on a device: ``params`` (a numpy tree, ``crs_tpu``'s as
    numpy included) or the seeded random init, as f32 tensors."""

    def __init__(self, cfg: Optional[MiniLMConfig] = None, params: Optional[Params] = None,
                 seed: int = 0, device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.cfg = cfg or MiniLMConfig()
        self.device = resolve_device(device)
        if params is None:
            params = init_minilm_params(seed, self.cfg)
            logger.info("MiniLMEncoder: deterministic random init (seed=%d)", seed)
        self.params = params_to_torch(params, self.device)

    @torch.no_grad()
    def encode_ids(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """[B, S] token ids and bool mask → [B, H] f32 embeddings on the device."""
        ids_t = torch.as_tensor(np.asarray(ids, np.int64)).to(self.device)
        mask_t = torch.as_tensor(np.asarray(mask, np.bool_)).to(self.device)
        return minilm_encode(self.params, self.cfg, ids_t, mask_t)
