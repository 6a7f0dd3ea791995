"""Uniform model interface and factory (port of
``crs_tpu.models.model_interface``).

``create_model_interface(model_type, config, device)`` maps a type string to
a precision variant of one causal LM (:class:`TorchModel`): full precision
(``bf16``), int8, int4, int3, int2 or nf4 weight-only quantization, or the
calibrated ``gptq`` / ``awq`` 4-bit types (``quant_calib``), with a bf16 or
int8 (``kv_bits: 8``) KV cache. Weights come from a native checkpoint
directory (``model_path`` holding ``model_meta.json``, as
``save_pretrained`` writes it, in either package), a local Hugging Face
Llama/Mistral directory (``model_path`` holding ``config.json``), or
``crs_tpu``'s deterministic random init on a named config. The serving
flags ``fuse_projections`` (q|k|v and gate|up as one weight each) and
``fused_mlp`` (int8 layers through the fused MLP kernel) exclude each other.

The calibration batches come from the PDF named by ``calibration_pdf`` when
it exists, else from deterministic random tokens. (``crs_tpu`` reads a
fixed corpus path outside the repository, absent wherever the repository's
tests run, so both packages take the random tokens there.)

Not ported yet, and raising: log-likelihood scoring (the evaluation slice).

The model runs on the card unless ``device="cpu"`` is passed; without CUDA
it raises.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from .bytes_tokenizer import ByteTokenizer
from .quantized import params_num_bytes, quantize_params
from .sampling import SamplingParams, generate_tokens
from .transformer import (
    CONFIGS, TransformerConfig, forward, fuse_mlp_params, fuse_qkv_params, init_params,
)

logger = logging.getLogger(__name__)

__all__ = ["ModelInterface", "TorchModel", "create_model_interface"]

_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)
_NOT_PORTED = "(ROADMAP: modules to port)"


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


class ModelInterface(ABC):
    """What every model variant offers."""

    @abstractmethod
    def load(self) -> None: ...

    @abstractmethod
    def generate(self, prompt: str, max_new_tokens: int = 64, **kw) -> str: ...

    @abstractmethod
    def forward(self, input_ids: np.ndarray) -> np.ndarray: ...

    def get_loglikelihood(self, context: str, continuation: str) -> float:
        raise NotImplementedError(f"log-likelihood scoring comes with the evaluation slice "
                                  f"{_NOT_PORTED}")

    def get_model_info(self) -> Dict[str, Any]:
        return {}


class TorchModel(ModelInterface):
    """The causal LM behind ``ModelInterface``, any precision variant."""

    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        config = config or {}
        self.device = resolve_device(device)
        self.config_name = config.get("config", "tiny")
        self.model_path = config.get("model_path")
        self.quantization: Optional[str] = config.get("quantization")
        self.kv_bits = int(config.get("kv_bits", 16))
        self.fuse_projections = bool(config.get("fuse_projections", False))
        self.fused_mlp = bool(config.get("fused_mlp", False))
        if self.fused_mlp and self.fuse_projections:
            raise ValueError("fused_mlp and fuse_projections are mutually exclusive "
                             "(gate|up fusion replaces the layout)")
        # weight dtype of a Hugging Face checkpoint: bf16, or f32 for parity work
        self.dtype = (torch.float32 if str(config.get("dtype", "bf16")) in ("float32", "fp32")
                      else torch.bfloat16)
        self.calibration_pdf: Optional[str] = config.get("calibration_pdf")
        self.group_size = int(config.get("group_size", 128))
        self.seed = int(config.get("seed", 0))
        self.max_seq_len = int(config.get("max_seq_len", 2048))
        self.cfg: Optional[TransformerConfig] = None
        self.params = None
        self.tokenizer = None
        self._loaded = False
        self.load_time_s = 0.0
        self.weights_source = "unloaded"

    # -- loading -----------------------------------------------------------
    def load(self) -> None:
        if self._loaded:
            return
        t0 = time.perf_counter()
        already_quantized = False
        if self.model_path and os.path.exists(os.path.join(self.model_path, "model_meta.json")):
            requested = self.quantization
            self.load_pretrained(self.model_path)
            with open(os.path.join(self.model_path, "model_meta.json")) as f:
                already_quantized = bool(json.load(f).get("quantization"))
            if requested and not self.quantization:
                self.quantization = requested
            self.weights_source = "checkpoint"
        elif self.model_path:
            from .hf_loader import load_hf_causal_lm

            loaded = load_hf_causal_lm(self.model_path, dtype=self.dtype, device=self.device)
            if loaded is None:
                # random weights under the checkpoint's name would be a wrong answer
                raise RuntimeError(
                    f"model_path={self.model_path!r} was set but no weights could be loaded "
                    "(no model_meta.json or config.json, or missing / corrupt weights); unset "
                    "model_path to run a random-init architecture")
            self.cfg, self.params = loaded
            self.tokenizer = _load_hf_tokenizer(self.model_path) or ByteTokenizer()
            self.weights_source = "checkpoint"
        else:
            if self.config_name not in CONFIGS:
                raise ValueError(f"unknown model config: {self.config_name}")
            self.cfg = CONFIGS[self.config_name]
            self.params = init_params(self.seed, self.cfg, device=self.device)
            self.tokenizer = ByteTokenizer()
            self.weights_source = "random_init"
            logger.info("TorchModel: random init (%s, seed=%d)", self.config_name, self.seed)
        if self.kv_bits != 16:
            self.cfg = dataclasses.replace(self.cfg, kv_bits=self.kv_bits)
        q = self.quantization
        if already_quantized:
            pass
        elif q in ("int8", "int4", "int3", "int2", "nf4"):
            bits = "nf4" if q == "nf4" else int(q[3:])
            self.params = quantize_params(self.params, bits=bits, group_size=self.group_size)
        elif q and q.startswith(("awq", "gptq")):
            from .quant_calib import quantize_params_calibrated

            method = "awq" if q.startswith("awq") else "gptq"
            bits = int(q[len(method):] or 4)
            self.params = quantize_params_calibrated(self.params, self.cfg, method,
                                                     self._calibration_batches(), bits=bits,
                                                     group_size=self.group_size)
        elif q not in (None, "", "none", "bf16", "fp16"):
            raise ValueError(f"unknown quantization: {q}")
        if self.fuse_projections:
            self.params = fuse_qkv_params(self.params)
        if self.fused_mlp:
            self.params = fuse_mlp_params(self.params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.load_time_s = time.perf_counter() - t0
        self._loaded = True

    def _calibration_batches(self, num_batches: int = 4, batch: int = 2, seq: int = 128):
        """Fixed-shape calibration batches [(ids, mask)]: pages of more than
        50 words from ``calibration_pdf`` (read by
        ``DocumentProcessor.process_pdf``) when it exists, else deterministic
        random tokens from the seed — ``crs_tpu``'s rule, with the corpus
        path taken from the config."""
        texts: List[str] = []
        if self.calibration_pdf and os.path.exists(self.calibration_pdf):
            from ..rag.document_processing import DocumentProcessor

            pages = DocumentProcessor({}).process_pdf(self.calibration_pdf)
            texts = [t for t, _ in pages if len(t.split()) > 50]
        batches = []
        rng = np.random.default_rng(self.seed)
        for bi in range(num_batches):
            ids = np.zeros((batch, seq), np.int64)
            mask = np.zeros((batch, seq), np.bool_)
            for row in range(batch):
                if texts:
                    enc = self.tokenizer.encode(texts[(bi * batch + row) % len(texts)],
                                                max_length=seq)
                else:
                    enc = rng.integers(0, self.cfg.vocab_size, (seq,)).tolist()
                ids[row, :len(enc)] = enc
                mask[row, :len(enc)] = True
            batches.append((ids, mask))
        return batches

    def _ensure(self) -> None:
        if not self._loaded:
            self.load()

    # -- generation ----------------------------------------------------------
    def generate(self, prompt: str, max_new_tokens: int = 64, temperature: float = 0.0,
                 top_p: float = 1.0, top_k: int = 0, repetition_penalty: float = 1.0,
                 seed: int = 0) -> str:
        return self.generate_batch([prompt], max_new_tokens, temperature, top_p, top_k,
                                   repetition_penalty, seed)[0]

    def encode_batch(self, prompts: Sequence[str], max_new_tokens: int):
        """Left-padded ids [B, bucket] and mask [B, bucket] on the device."""
        enc = [self.tokenizer.encode(p, max_length=self.max_seq_len - max_new_tokens)
               for p in prompts]
        blen = _bucket(max(len(e) for e in enc))
        ids = np.full((len(enc), blen), _pad_id(self.tokenizer), np.int64)
        mask = np.zeros((len(enc), blen), np.bool_)
        for row, e in enumerate(enc):  # left pad (RoPE is relative; pads masked)
            ids[row, blen - len(e):] = e
            mask[row, blen - len(e):] = True
        return (torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device))

    def generate_batch(self, prompts: Sequence[str], max_new_tokens: int = 64,
                       temperature: float = 0.0, top_p: float = 1.0, top_k: int = 0,
                       repetition_penalty: float = 1.0, seed: int = 0) -> List[str]:
        self._ensure()
        ids, mask = self.encode_batch(prompts, max_new_tokens)
        sp = SamplingParams(max_new_tokens=max_new_tokens, temperature=temperature,
                            top_p=top_p, top_k=top_k, repetition_penalty=repetition_penalty,
                            eos_id=_eos_id(self.tokenizer), pad_id=_pad_id(self.tokenizer))
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        tokens, lengths = generate_tokens(self.params, self.cfg, ids, mask, generator, sp)
        tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        out = []
        for row in range(len(prompts)):
            toks = tokens[row, : lengths[row]]
            toks = toks[toks != sp.eos_id]
            out.append(self.tokenizer.decode(toks.tolist()))
        return out

    def forward(self, input_ids: np.ndarray) -> np.ndarray:
        self._ensure()
        ids = torch.from_numpy(np.atleast_2d(np.asarray(input_ids, np.int64))).to(self.device)
        with torch.no_grad():
            return forward(self.params, self.cfg, ids).cpu().numpy()

    # -- info ----------------------------------------------------------------
    def get_model_info(self) -> Dict[str, Any]:
        self._ensure()
        nbytes = params_num_bytes(self.params)
        nparams = _count_params(self.cfg)
        return {
            "model_name": self.model_path or self.config_name,
            "quantization": self.quantization or "bf16",
            "num_parameters": nparams,
            "model_size_gb": nbytes / 1e9,
            "bits_per_param": 8.0 * nbytes / max(nparams, 1),
            "device": str(torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                          else self.device),
            "load_time_s": self.load_time_s,
            "weights_source": self.weights_source,
            "kv_bits": self.kv_bits,
            "fused_projections": self.fuse_projections,
            "fused_mlp": self.fused_mlp,
        }

    # -- native checkpoints ---------------------------------------------------
    def save_pretrained(self, path: str) -> None:
        """Write the (possibly quantized) params and the model meta, in
        ``crs_tpu``'s format."""
        self._ensure()
        from ..utils.checkpoint import save_pytree

        save_pytree(os.path.join(path, "model"), self.params)
        keys = ("vocab_size", "hidden_size", "num_layers", "num_heads", "num_kv_heads",
                "intermediate_size", "max_seq_len", "rope_theta", "rms_eps", "tie_embeddings")
        meta = {"config_name": self.config_name, "quantization": self.quantization,
                "cfg": {k: getattr(self.cfg, k) for k in keys}}
        with open(os.path.join(path, "model_meta.json"), "w") as f:
            json.dump(meta, f, indent=2)

    def load_pretrained(self, path: str) -> None:
        from ..utils.checkpoint import load_pytree

        with open(os.path.join(path, "model_meta.json")) as f:
            meta = json.load(f)
        self.cfg = TransformerConfig(dtype=torch.bfloat16, **meta["cfg"])
        self.params = load_pytree(os.path.join(path, "model"), device=self.device)
        self.quantization = meta.get("quantization")
        self.config_name = meta.get("config_name", self.config_name)
        if self.tokenizer is None:
            self.tokenizer = ByteTokenizer()
        self._loaded = True


def _pad_id(tok) -> int:
    return getattr(tok, "pad_id", 0)


def _eos_id(tok) -> int:
    return getattr(tok, "eos_id", -1)


def _load_hf_tokenizer(path: str):
    """The checkpoint's tokenizer through ``transformers`` (local files
    only), or None when ``transformers`` or the tokenizer files are absent."""
    try:
        from transformers import AutoTokenizer  # type: ignore

        tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
    except Exception:  # no transformers, or no tokenizer in the directory
        return None

    class _Wrap:
        pad_id = tok.pad_token_id or 0
        eos_id = tok.eos_token_id if tok.eos_token_id is not None else -1

        def encode(self, text, max_length=None):
            ids = tok.encode(text)
            return ids[:max_length] if max_length else ids

        def decode(self, ids):
            return tok.decode(ids, skip_special_tokens=True)

    return _Wrap()


def _count_params(cfg: TransformerConfig) -> int:
    d, hd = cfg.hidden_size, cfg.head_dim
    per_layer = (d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
                 + cfg.num_heads * hd * d + 3 * d * cfg.intermediate_size + 2 * d)
    total = cfg.vocab_size * d + cfg.num_layers * per_layer + d
    if not cfg.tie_embeddings:
        total += d * cfg.vocab_size
    return total


_MODEL_TYPES = {
    "jax": None, "bf16": None, "huggingface": None, "hf": None,
    "int8": "int8", "int4": "int4", "int3": "int3", "int2": "int2",
    "gptq": "gptq4", "awq": "awq4", "hqq": "int4", "nf4": "nf4",
}


def create_model_interface(model_type: str, config: Optional[Dict[str, Any]] = None,
                           device: Optional[Union[str, torch.device]] = None) -> ModelInterface:
    """Type string → configured model variant (``crs_tpu``'s table)."""
    mt = (model_type or "jax").lower()
    if mt not in _MODEL_TYPES:
        raise ValueError(f"unknown model type: {model_type} (known: {sorted(_MODEL_TYPES)})")
    config = dict(config or {})
    quant = _MODEL_TYPES[mt]
    if quant and not config.get("quantization"):
        config["quantization"] = quant
    return TorchModel(config, device=device)
