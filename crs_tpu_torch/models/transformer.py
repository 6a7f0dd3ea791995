"""Decoder-only causal LM as plain torch functions over a params tree (port
of ``crs_tpu.models.transformer``).

A Mistral/Llama-family block — RMSNorm, rotary embeddings, grouped-query
attention, SwiGLU MLP — with prefill and KV-cache decode. Any weight may be
a :class:`~crs_tpu_torch.models.quantized.QuantizedTensor`; ``qmatmul``
routes it (at decode-sized row counts int4 / nf4 go through the CUDA
kernels of ``ops.qgemm``). With ``kv_bits == 8`` the cache is int8,
sequence-major per head, and each decode step's attention goes through the
CUDA kernel of ``ops.decode_attention``.

The params tree has ``crs_tpu``'s layout and paths, so one tree converts
to the other (``convert.params_from_numpy``) and checkpoints load in both.
Where ``crs_tpu`` returns a new cache, the port writes the new rows into the
cache it was given (in place, to keep one cache in device memory) and
returns it. ``fuse_qkv_params`` concatenates q|k|v and gate|up into one
weight each; ``fuse_mlp_params`` attaches the fused MLP's layout to int8
layers, and decode-sized rows then go through the CUDA kernel of
``ops.fused_mlp`` (TPU kernel 11). ``forward_captured`` returns each
layer's linear inputs for the calibrated quantizers (``quant_calib``).

Arithmetic follows the JAX version as XLA compiles it: bf16 elementwise ops
round one by one; a division by a constant is a product with the
constant's float32 reciprocal (``recip32``); and where an f32 convert reads
the output of a bf16 elementwise op, XLA fuses the two and skips that op's
rounding — an RMSNorm reads the f32 sum of the residual add before it
(``_residual``), an int8 product the f32 product before it (``qmatmul``'s
``unrounded``, computed only when an int8 product asks for it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..ops.decode_attention import (
    decode_attention_int8, decode_attention_supported, emulate_decode_attention_int8,
    quantize_kv_rows,
)
from ..ops.fused_mlp import fused_mlp_int8, fused_mlp_layout, fused_mlp_supported
from .quantized import QuantizedTensor, qmatmul

Params = Dict[str, Any]

__all__ = [
    "TransformerConfig", "CONFIGS", "init_params", "fuse_qkv_params", "fuse_mlp_params",
    "rms_norm", "apply_rope", "forward", "forward_captured", "init_cache", "prefill",
    "decode_step", "KVCache", "QuantKVCache", "recip32",
]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 14336
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    # KV-cache precision: 16 (the model dtype) or 8 (int8 codes + per-vector
    # scales, decoded through the int8 decode-attention kernel)
    kv_bits: int = 16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


CONFIGS: Dict[str, TransformerConfig] = {
    "tiny": TransformerConfig(
        vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=256, max_seq_len=512,
    ),
    "small": TransformerConfig(
        vocab_size=2048, hidden_size=512, num_layers=8, num_heads=8,
        num_kv_heads=4, intermediate_size=1536, max_seq_len=2048,
    ),
    "1b": TransformerConfig(
        vocab_size=32000, hidden_size=2048, num_layers=16, num_heads=16,
        num_kv_heads=8, intermediate_size=5632, max_seq_len=4096,
    ),
    "mistral-7b": TransformerConfig(
        vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=8, intermediate_size=14336, max_seq_len=4096,
    ),
}


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, S_max, Hkv, hd]
    v: torch.Tensor  # [L, B, S_max, Hkv, hd]
    mask: torch.Tensor  # [B, S_max] bool: slots holding real tokens
    length: int  # tokens in the cache


@dataclasses.dataclass
class QuantKVCache:
    """int8 cache (``kv_bits == 8``), sequence-major per head so the decode
    kernel reads each (batch row, kv-head) as one contiguous block."""

    k_codes: torch.Tensor  # [L, B, Hkv, S_max, hd] int8
    k_scales: torch.Tensor  # [L, B, Hkv, S_max] f32
    v_codes: torch.Tensor
    v_scales: torch.Tensor
    mask: torch.Tensor  # [B, S_max] bool
    length: int


def recip32(c: float) -> float:
    """float32(1) / float32(c): what XLA multiplies by for ``x / c``."""
    return float(np.float32(1.0) / np.float32(c))


def init_params(seed: int, cfg: TransformerConfig,
                device: Optional[Union[str, torch.device]] = "cpu") -> Params:
    """``crs_tpu``'s scaled-normal init, bit for bit: the same host numpy
    stream (``np.random.default_rng(seed)``, f32, in the same order), cast
    to ``cfg.dtype`` (round to nearest even) on ``device``."""
    rng = np.random.default_rng(seed)
    d, hd = cfg.hidden_size, cfg.head_dim

    def put(w: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(w).to(device).to(cfg.dtype)

    def mat(kin: int, kout: int) -> torch.Tensor:
        return put(rng.standard_normal((kin, kout), dtype=np.float32) * (kin ** -0.5))

    def ones() -> torch.Tensor:
        return torch.ones((d,), dtype=cfg.dtype, device=device)

    params: Params = {
        "embed": put(rng.standard_normal((cfg.vocab_size, d), dtype=np.float32) * 0.02),
        "layers": [],
        "final_norm": {"scale": ones()},
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "attn_norm": {"scale": ones()},
            "attn": {
                "q": mat(d, cfg.num_heads * hd),
                "k": mat(d, cfg.num_kv_heads * hd),
                "v": mat(d, cfg.num_kv_heads * hd),
                "o": mat(cfg.num_heads * hd, d),
            },
            "mlp_norm": {"scale": ones()},
            "mlp": {
                "gate": mat(d, cfg.intermediate_size),
                "up": mat(d, cfg.intermediate_size),
                "down": mat(cfg.intermediate_size, d),
            },
        })
    if not cfg.tie_embeddings:
        params["lm_head"] = mat(d, cfg.vocab_size)
    return params


def _concat_out(ws):
    """Weights concatenated along the output dim (shared input dim): plain
    tensors, or QuantizedTensors of one width and group size, whose codes
    and scales both concatenate on their output axis."""
    if isinstance(ws[0], QuantizedTensor):
        first = ws[0]
        if not all(isinstance(w, QuantizedTensor) and w.bits == first.bits
                   and w.group_size == first.group_size and w.shape[0] == first.shape[0]
                   for w in ws):
            raise ValueError("fusion requires the same input dim, bits and group size")
        return QuantizedTensor(torch.cat([w.codes for w in ws], dim=1),
                               torch.cat([w.scales for w in ws], dim=-1), first.bits,
                               first.group_size, (first.shape[0], sum(w.shape[1] for w in ws)))
    return torch.cat(ws, dim=1)


def fuse_qkv_params(params: Params) -> Params:
    """q|k|v → one ``qkv`` weight and gate|up → one ``gateup`` weight per
    layer (7 → 4 weight streams). The same arithmetic: every output column
    keeps its own dot and scale, and the int8 route's per-row activation
    scale sees the same x, so int8 is exact. Apply after quantization."""
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        attn, mlp = layer["attn"], layer["mlp"]
        new_attn = {"qkv": _concat_out([attn["q"], attn["k"], attn["v"]]), "o": attn["o"]}
        new_mlp = {"gateup": _concat_out([mlp["gate"], mlp["up"]]), "down": mlp["down"]}
        out["layers"].append({**layer, "attn": new_attn, "mlp": new_mlp})
    return out


def fuse_mlp_params(params: Params, chunk: int = 1024) -> Params:
    """Attach the fused MLP's layout (gate / up codes transposed to [I, H],
    per-chunk scales; down as it is) to every int8 layer whose intermediate
    width divides by ``chunk`` and whose hidden width by 128, so decode
    routes through :func:`~crs_tpu_torch.ops.fused_mlp.fused_mlp_int8`.
    Other layers are left as they are. gate / up carry a transposed copy;
    the unfused weights stay for prefill. Exclusive with
    :func:`fuse_qkv_params`. Apply after quantization."""
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        mlp = layer["mlp"]
        ok = all(isinstance(mlp.get(k), QuantizedTensor) and mlp[k].bits == 8
                 for k in ("gate", "up", "down"))
        if not ok or mlp["gate"].codes.shape[1] % chunk or mlp["gate"].codes.shape[0] % 128:
            out["layers"].append(layer)
            continue
        gate_t, sg2, up_t, su2, down_c, sd = fused_mlp_layout(
            mlp["gate"].codes, mlp["gate"].scales, mlp["up"].codes, mlp["up"].scales,
            mlp["down"].codes, mlp["down"].scales, chunk)
        fused = {"gate_t": gate_t, "s_gate2": sg2, "up_t": up_t, "s_up2": su2,
                 "down_c": down_c, "down_s": sd}
        out["layers"].append({**layer, "mlp": {**mlp, "fused": fused}})
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return _norm(x.float(), x.dtype, scale, eps)


def _norm(x32: torch.Tensor, dtype: torch.dtype, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm of the f32 residual stream, rounded to the model dtype."""
    return _norm2(x32, dtype, scale, eps)[0]


def _norm2(x32, dtype, scale, eps):
    """(RMSNorm in the model dtype, a function giving it before the scale
    product's rounding: what an int8 product reads, ``qmatmul``'s
    ``unrounded``)."""
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = (x32 * torch.rsqrt(var + eps)).to(dtype)
    return y * scale, lambda: y.float() * scale.float()


def _residual(x32: torch.Tensor, dtype: torch.dtype, delta: torch.Tensor) -> torch.Tensor:
    """The residual add ``x + delta`` in the model dtype, kept as the f32
    sum of the rounded stream and ``delta``. XLA fuses each add into the f32
    convert of the RMSNorm after it, so that norm reads the sum before its
    rounding, while the stream itself carries the rounded value; holding the
    residual stream in f32 (``x32``, rounded on use) gives both."""
    return x32.to(dtype).float() + delta.float()


def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [B, S] → (cos, sin) [B, S, hd/2] f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, hd], rotate-half convention (HF Llama/Mistral)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _project_qkv(x: torch.Tensor, p: Params, cfg: TransformerConfig, positions: torch.Tensor,
                 unrounded=None):
    """q [B, S, H, hd], k / v [B, S, Hkv, hd], rope on q and k; one product
    and a split with fused params (:func:`fuse_qkv_params`)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if "qkv" in p:
        qkv = qmatmul(x, p["qkv"], unrounded)
        q = qkv[..., :h * hd].reshape(b, s, h, hd)
        k = qkv[..., h * hd:(h + hkv) * hd].reshape(b, s, hkv, hd)
        v = qkv[..., (h + hkv) * hd:].reshape(b, s, hkv, hd)
    else:
        q = qmatmul(x, p["q"], unrounded).reshape(b, s, h, hd)
        k = qmatmul(x, p["k"], unrounded).reshape(b, s, hkv, hd)
        v = qmatmul(x, p["v"], unrounded).reshape(b, s, hkv, hd)
    cos, sin = _rope_angles(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _gate_up(hmlp: torch.Tensor, mlp: Params, unrounded=None):
    """SwiGLU gate and up: one product and a split with fused params."""
    if "gateup" in mlp:
        gu = qmatmul(hmlp, mlp["gateup"], unrounded)
        inter = gu.shape[-1] // 2
        return gu[..., :inter], gu[..., inter:]
    return qmatmul(hmlp, mlp["gate"], unrounded), qmatmul(hmlp, mlp["up"], unrounded)


def _attention(x, p, cfg: TransformerConfig, positions, cache_kv, cache_len: Optional[int],
               key_valid: Optional[torch.Tensor] = None, unrounded=None,
               capture: Optional[dict] = None):
    """Attention with an explicit product and softmax (no fused library
    attention). With ``cache_kv`` ([B, S_max, Hkv, hd] each) the new k / v
    rows are written into it at ``cache_len``. ``capture`` records the
    o-projection's input (``o_in``)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(x, p, cfg, positions, unrounded)
    if cache_kv is not None:
        ck, cv = cache_kv
        if cache_len + s > ck.shape[1]:
            raise ValueError(f"{cache_len + s} tokens do not fit a cache of {ck.shape[1]}")
        ck[:, cache_len:cache_len + s] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + s] = v.to(cv.dtype)
        keys, values = ck, cv
        key_pos = torch.arange(ck.shape[1], device=x.device)[None, :]
        mask = key_pos[:, None, :] <= positions[:, :, None]  # [B, S, S_max]
        mask = mask & (key_pos[:, None, :] < cache_len + s)
    else:
        keys, values = k, v
        key_pos = torch.arange(s, device=x.device)[None, :]
        mask = key_pos[:, None, :] <= positions[:, :, None]
    if key_valid is not None:
        mask = mask & key_valid[:, None, :]
    group = h // hkv
    qg = q.reshape(b, s, hkv, group, hd)
    # bf16 products are exact in f32: the scores are the f32 sums
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), keys.float())
    scores = scores * recip32(math.sqrt(hd))
    bias = torch.where(mask[:, None, None, :, :], 0.0, -1e30)
    probs = torch.softmax(scores + bias, dim=-1).to(x.dtype)
    ctx_dtype = torch.promote_types(probs.dtype, values.dtype)
    ctx = torch.einsum("bkgst,btkd->bskgd", probs.to(ctx_dtype), values.to(ctx_dtype))
    ctx = ctx.reshape(b, s, h * hd)
    if capture is not None:
        capture["o_in"] = ctx
    return qmatmul(ctx, p["o"])


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA computes it: x · (1 / (1 + exp(−x))), each op
    rounded to x's dtype (``torch.nn.functional.silu`` rounds once)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _mlp_block_res(x32: torch.Tensor, dtype: torch.dtype, layer: Params,
                   cfg: TransformerConfig, capture: Optional[dict] = None) -> torch.Tensor:
    """x + MLP(rmsnorm(x)) on the f32 residual stream. Decode-sized rows go
    through the fused MLP kernel when the layer carries its layout
    (:func:`fuse_mlp_params`); the kernel reads the stream rounded to the
    model dtype (XLA fuses no convert across the kernel's boundary) and its
    output is rounded to the model dtype, as in ``crs_tpu``. ``capture``
    records the MLP's linear inputs in f32 as the calibration statistics
    read them under XLA: ``mlp_in`` before the norm-scale product's rounding
    (fused into the statistics' convert), ``down_in`` rounded."""
    fused = layer["mlp"].get("fused")
    if fused is not None and capture is None:
        h = x32.shape[-1]
        rows = x32.numel() // h
        chunk = fused["s_gate2"].shape[1]
        if fused_mlp_supported(rows, h, fused["gate_t"].shape[0], chunk):
            out = fused_mlp_int8(x32.to(dtype).float().reshape(rows, h),
                                 layer["mlp_norm"]["scale"].float(),
                                 fused["gate_t"], fused["s_gate2"], fused["up_t"],
                                 fused["s_up2"], fused["down_c"], fused["down_s"],
                                 chunk=chunk, eps=cfg.rms_eps)
            return out.reshape(x32.shape).to(dtype).float()
    hmlp, hmlp_unrounded = _norm2(x32, dtype, layer["mlp_norm"]["scale"], cfg.rms_eps)
    gate_pre, up = _gate_up(hmlp, layer["mlp"], hmlp_unrounded)
    act = silu(gate_pre)
    down_in = act * up
    if capture is not None:
        capture["mlp_in"] = hmlp_unrounded()
        capture["down_in"] = down_in.float()
    down = qmatmul(down_in, layer["mlp"]["down"], lambda: act.float() * up.float())
    return _residual(x32, dtype, down)


def _block(x32, dtype, layer, cfg, positions, cache_kv, cache_len, key_valid=None,
           capture: Optional[dict] = None):
    """One block on the f32 residual stream ``x32`` (model dtype ``dtype``);
    ``capture`` records each linear input (``attn_in`` before its last
    rounding, as ``mlp_in``; ``o_in``; ``mlp_in``; ``down_in``)."""
    attn_in, attn_in_unrounded = _norm2(x32, dtype, layer["attn_norm"]["scale"], cfg.rms_eps)
    if capture is not None:
        capture["attn_in"] = attn_in_unrounded()
    a = _attention(attn_in, layer["attn"], cfg, positions, cache_kv, cache_len, key_valid,
                   attn_in_unrounded, capture)
    return _mlp_block_res(_residual(x32, dtype, a), dtype, layer, cfg, capture)


def _quant_store_rows(kc, ks, vc, vs, k_new, v_new, cache_len: int) -> None:
    """Quantize fresh [B, S, Hkv, hd] k / v rows and write them into the
    sequence-major int8 cache at ``cache_len``."""
    s = k_new.shape[1]
    kq, ksc = quantize_kv_rows(k_new.transpose(1, 2))
    vq, vsc = quantize_kv_rows(v_new.transpose(1, 2))
    kc[:, :, cache_len:cache_len + s] = kq
    ks[:, :, cache_len:cache_len + s] = ksc
    vc[:, :, cache_len:cache_len + s] = vq
    vs[:, :, cache_len:cache_len + s] = vsc


def _block_kvq_prefill(x32, dtype, layer, cfg, positions, kc, ks, vc, vs, cache_len,
                       key_valid):
    """Prefill through an int8 cache: the cached rows are dequantized into
    the model-dtype attention layout, the new rows are stored quantized."""
    s = x32.shape[1]
    kd = (kc.float() * ks[..., None]).to(dtype).transpose(1, 2).contiguous()
    vd = (vc.float() * vs[..., None]).to(dtype).transpose(1, 2).contiguous()
    x32 = _block(x32, dtype, layer, cfg, positions, (kd, vd), cache_len, key_valid)
    _quant_store_rows(kc, ks, vc, vs, kd[:, cache_len:cache_len + s],
                      vd[:, cache_len:cache_len + s], cache_len)
    return x32


def _block_kvq_decode(x32, dtype, layer, cfg, positions, kc, ks, vc, vs, cache_len, valid):
    """One decode token through the int8-KV attention kernel (its plain
    version where ``crs_tpu`` takes its XLA emulation: hd or S not
    128-aligned)."""
    b = x32.shape[0]
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn, xn_unrounded = _norm2(x32, dtype, layer["attn_norm"]["scale"], cfg.rms_eps)
    q, k_new, v_new = _project_qkv(xn, layer["attn"], cfg, positions, xn_unrounded)
    _quant_store_rows(kc, ks, vc, vs, k_new, v_new, cache_len)
    qh = q.reshape(b, hkv, h // hkv, hd)  # head h = kv·group + g
    if decode_attention_supported(hd, kc.shape[2]):
        ctx = decode_attention_int8(qh, kc, ks, vc, vs, valid)
    else:
        ctx = emulate_decode_attention_int8(qh, kc, ks, vc, vs, valid)
    a = qmatmul(ctx.reshape(b, 1, h * hd).to(dtype), layer["attn"]["o"])
    return _mlp_block_res(_residual(x32, dtype, a), dtype, layer, cfg)


def _logits(x32: torch.Tensor, dtype: torch.dtype, params: Params,
            cfg: TransformerConfig) -> torch.Tensor:
    x, x_unrounded = _norm2(x32, dtype, params["final_norm"]["scale"], cfg.rms_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return qmatmul(x, head, x_unrounded).float()


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def forward(params: Params, cfg: TransformerConfig, ids: torch.Tensor,
            attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward (no cache) → logits [B, S, V] f32.
    ``attn_mask`` [B, S] marks real tokens; pads are masked as keys."""
    b, s = ids.shape
    x = params["embed"][ids]
    dtype, x32 = x.dtype, x.float()
    positions = _positions(b, s, ids.device)
    for layer in params["layers"]:
        x32 = _block(x32, dtype, layer, cfg, positions, None, None, attn_mask)
    return _logits(x32, dtype, params, cfg)


def forward_captured(params: Params, cfg: TransformerConfig, ids: torch.Tensor,
                     attn_mask: Optional[torch.Tensor] = None):
    """:func:`forward` that also returns each layer's linear inputs, the
    calibration tap of the calibrated quantizers (``quant_calib``): (logits,
    [{"attn_in", "o_in", "mlp_in", "down_in"} per layer])."""
    b, s = ids.shape
    x = params["embed"][ids]
    dtype, x32 = x.dtype, x.float()
    positions = _positions(b, s, ids.device)
    sites = []
    for layer in params["layers"]:
        cap: Dict[str, torch.Tensor] = {}
        x32 = _block(x32, dtype, layer, cfg, positions, None, None, attn_mask, capture=cap)
        sites.append(cap)
    return _logits(x32, dtype, params, cfg), sites


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device: Optional[Union[str, torch.device]] = "cpu"):
    """An empty cache for ``max_len`` tokens (rounded up to 128 for the
    int8 cache, the decode kernel's alignment)."""
    if cfg.kv_bits == 8:
        s = -(-max_len // 128) * 128
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, s, cfg.head_dim)
        return QuantKVCache(
            k_codes=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scales=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_codes=torch.zeros(shape, dtype=torch.int8, device=device),
            v_scales=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            mask=torch.zeros((batch, s), dtype=torch.bool, device=device), length=0,
        )
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   mask=torch.zeros((batch, max_len), dtype=torch.bool, device=device), length=0)


def prefill(params: Params, cfg: TransformerConfig, ids: torch.Tensor, cache,
            attn_mask: Optional[torch.Tensor] = None):
    """Run the prompt through the model, filling ``cache`` → (logits
    [B, S, V], cache). Prompts are left-padded, ``attn_mask`` marking real
    tokens; positions count the pads, as in ``crs_tpu``."""
    b, s = ids.shape
    x = params["embed"][ids]
    dtype, x32 = x.dtype, x.float()
    positions = _positions(b, s, ids.device)
    if attn_mask is None:
        attn_mask = torch.ones((b, s), dtype=torch.bool, device=ids.device)
    start = cache.length
    cache.mask[:, start:start + s] = attn_mask
    for li, layer in enumerate(params["layers"]):
        if isinstance(cache, QuantKVCache):
            x32 = _block_kvq_prefill(x32, dtype, layer, cfg, positions, cache.k_codes[li],
                                     cache.k_scales[li], cache.v_codes[li], cache.v_scales[li],
                                     start, cache.mask)
        else:
            x32 = _block(x32, dtype, layer, cfg, positions, (cache.k[li], cache.v[li]), start,
                         cache.mask)
    cache.length = start + s
    return _logits(x32, dtype, params, cfg), cache


def decode_step(params: Params, cfg: TransformerConfig, token: torch.Tensor, cache):
    """One decode step: token [B] → (logits [B, V], cache)."""
    b = token.shape[0]
    pos = cache.length
    positions = torch.full((b, 1), pos, dtype=torch.long, device=token.device)
    x = params["embed"][token[:, None]]
    dtype, x32 = x.dtype, x.float()
    cache.mask[:, pos] = True
    for li, layer in enumerate(params["layers"]):
        if isinstance(cache, QuantKVCache):
            x32 = _block_kvq_decode(x32, dtype, layer, cfg, positions, cache.k_codes[li],
                                    cache.k_scales[li], cache.v_codes[li], cache.v_scales[li],
                                    pos, cache.mask)
        else:
            x32 = _block(x32, dtype, layer, cfg, positions, (cache.k[li], cache.v[li]), pos,
                         cache.mask)
    cache.length = pos + 1
    return _logits(x32, dtype, params, cfg)[:, 0, :], cache
