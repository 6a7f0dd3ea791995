"""Calibrated weight-only quantization: AWQ-style activation-aware scaling
and GPTQ-style error-compensated rounding (port of
``crs_tpu.models.quant_calib``).

- **AWQ**: per-input-channel scales ``s = (mean|x|)^α``, α chosen by a grid
  search that minimizes the calibration-weighted reconstruction error
  ``tr(ΔᵀHΔ), Δ = W − diag(1/s)·Q(diag(s)·W)``, ``H = E[xxᵀ]``. The scales
  fold into the preceding op, so inference is unchanged: q/k/v ←
  attn_norm.scale, gate/up ← mlp_norm.scale, down ← up's output channels,
  o ← v's output channels (shared across the GQA query groups).
- **GPTQ**: column-serial error-compensated rounding against the Cholesky
  factor of the inverse damped Hessian, group scales recomputed from the
  error-updated rows at each group boundary.

The calibration statistics (per-site mean|x| and Gram ``XᵀX``) are reduced
on the model's device from :func:`~crs_tpu_torch.models.transformer.
forward_captured`, the Gram through ``torch.matmul`` in f32 (TF32 off on the
card); only the reduced statistics come to the host. The rounding loops
are host numpy, as in ``crs_tpu``: they are serial by construction and run
once per model. Given the same statistics, the numpy parts give
``crs_tpu``'s codes and scales bit for bit.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .quantized import QuantizedTensor, quantize_tensor, tensor_from_int_codes
from .transformer import TransformerConfig, forward_captured

logger = logging.getLogger(__name__)

__all__ = [
    "SITES", "collect_calibration_stats", "awq_search_scale", "awq_quantize_params",
    "gptq_quantize_tensor", "gptq_quantize_params", "quantize_params_calibrated",
]

SITES = ("attn_in", "o_in", "mlp_in", "down_in")


def _site_stats(x: torch.Tensor, mask: torch.Tensor):
    """(Σ|x| [D], Gram [D, D], count) over the real (unmasked) tokens."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d).float()
    m = mask.reshape(-1).float()
    xm = x2 * m[:, None]
    return torch.sum(torch.abs(xm), dim=0), torch.matmul(xm.T, x2), torch.sum(m)


def _device_of(params) -> torch.device:
    return params["embed"].device


def collect_calibration_stats(
    params, cfg: TransformerConfig, batches: Sequence[Tuple[np.ndarray, np.ndarray]]
) -> List[Dict[str, Dict[str, np.ndarray]]]:
    """Run the calibration batches ((ids [B, S], mask [B, S]) arrays) through
    the model; per layer and site, {mean_abs [D], gram [D, D]} as numpy,
    accumulated over the batches and divided by the token count."""
    dev = _device_of(params)
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("calibration Grams need torch.backends.cuda.matmul.allow_tf32 = False")
    acc: Optional[List[Dict[str, list]]] = None
    with torch.no_grad():
        for ids, mask in batches:
            ids_t = torch.from_numpy(np.asarray(ids, np.int64)).to(dev)
            mask_t = torch.from_numpy(np.asarray(mask, np.bool_)).to(dev)
            _, sites = forward_captured(params, cfg, ids_t, mask_t)
            out = [{name: [t.cpu().numpy() for t in _site_stats(cap[name], mask_t)]
                    for name in SITES} for cap in sites]
            if acc is None:
                acc = out
            else:
                acc = [{name: [np.add(a, b) for a, b in zip(la[name], lo[name])]
                        for name in SITES} for la, lo in zip(acc, out)]
    stats: List[Dict[str, Dict[str, np.ndarray]]] = []
    for layer in acc:
        entry = {}
        for name, (sabs, gram, count) in layer.items():
            c = max(float(count), 1.0)
            entry[name] = {"mean_abs": sabs / c, "gram": gram / c}
        stats.append(entry)
    return stats


# -- AWQ: activation-aware scale search -----------------------------------------

def _rtn_dequant(w: np.ndarray, bits: int, group_size: int) -> np.ndarray:
    """Round-to-nearest group-wise quantize → dequantize (numpy mirror of
    the quantizer's arithmetic, used inside the scale search)."""
    kin, kout = w.shape
    qmax = 7 if bits == 4 else (1 << (bits - 1)) - 1
    g = group_size if kin % group_size == 0 else kin
    grouped = w.reshape(kin // g, g, kout)
    amax = np.max(np.abs(grouped), axis=1)
    scales = np.maximum(amax, 1e-12) / qmax
    vals = np.clip(np.round(grouped / scales[:, None, :]), -qmax, qmax)
    return (vals * scales[:, None, :]).reshape(kin, kout)


def _recon_error(w: np.ndarray, w_hat: np.ndarray, gram: np.ndarray) -> float:
    delta = (w - w_hat).astype(np.float64)
    return float(np.sum(delta * (gram.astype(np.float64) @ delta)))


def awq_search_scale(weights: Sequence[np.ndarray], mean_abs: np.ndarray, gram: np.ndarray,
                     bits: int, group_size: int,
                     alphas: Sequence[float] = (0.0, 0.25, 0.5, 0.75, 1.0)) -> np.ndarray:
    """Grid-search the AWQ scale exponent that minimizes the summed
    reconstruction error over the weights sharing this input."""
    x = np.maximum(mean_abs.astype(np.float64), 1e-8)
    best_s, best_err = None, np.inf
    for alpha in alphas:
        s = x ** alpha
        s = s / np.exp(np.mean(np.log(s)))  # geometric-mean normalize
        s = np.clip(s, 1e-4, 1e4).astype(np.float32)
        err = 0.0
        for w in weights:
            ws = w * s[:, None]
            w_hat = _rtn_dequant(ws, bits, group_size) / s[:, None]
            err += _recon_error(w, w_hat, gram)
        if err < best_err:
            best_err, best_s = err, s
    return best_s


def _host(t) -> np.ndarray:
    """A weight as f32 numpy on the host."""
    return t.float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _on(qt: QuantizedTensor, dev: torch.device) -> QuantizedTensor:
    return QuantizedTensor(qt.codes.to(dev), qt.scales.to(dev), qt.bits, qt.group_size, qt.shape)


def _lm_head(params, bits: int, group_size: int, dev: torch.device):
    return _on(quantize_tensor(_host(params["lm_head"]), bits=bits, group_size=group_size), dev)


def awq_quantize_params(params, cfg: TransformerConfig, stats, bits: int = 4,
                        group_size: int = 128) -> Dict[str, Any]:
    """Activation-aware quantization of every transformer linear, the
    inverse scales folded into the preceding op (see the module docstring)."""
    dev = _device_of(params)
    out: Dict[str, Any] = {"embed": params["embed"], "layers": [],
                           "final_norm": dict(params["final_norm"])}
    if "lm_head" in params:
        out["lm_head"] = _lm_head(params, bits, group_size, dev)
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for li, layer in enumerate(params["layers"]):
        st = stats[li]
        attn = {k: _host(v) for k, v in layer["attn"].items()}
        mlp = {k: _host(v) for k, v in layer["mlp"].items()}
        # q/k/v share the attn_norm input: one scale folded into the norm
        s_qkv = awq_search_scale([attn["q"], attn["k"], attn["v"]], st["attn_in"]["mean_abs"],
                                 st["attn_in"]["gram"], bits, group_size)
        # o's input is the attention context: one scale per kv head's channels,
        # shared across its query group, so it folds into v's output channels
        ma_o = st["o_in"]["mean_abs"].reshape(hkv, h // hkv, hd).mean(axis=1)
        ma_o = np.repeat(ma_o[:, None, :], h // hkv, axis=1).reshape(h * hd)
        s_o = awq_search_scale([attn["o"]], ma_o, st["o_in"]["gram"], bits, group_size)
        s_o_v = s_o.reshape(hkv, h // hkv, hd)[:, 0, :].reshape(hkv * hd)
        # gate/up share mlp_norm's input
        s_gu = awq_search_scale([mlp["gate"], mlp["up"]], st["mlp_in"]["mean_abs"],
                                st["mlp_in"]["gram"], bits, group_size)
        # down's input is silu(gate)·up: its scale folds into up's output
        s_down = awq_search_scale([mlp["down"]], st["down_in"]["mean_abs"],
                                  st["down_in"]["gram"], bits, group_size)

        def q(w):
            return _on(quantize_tensor(w, bits=bits, group_size=group_size), dev)

        def folded_norm(scale: torch.Tensor, s: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(_host(scale) / s).to(dev).to(scale.dtype)

        out["layers"].append({
            "attn_norm": {"scale": folded_norm(layer["attn_norm"]["scale"], s_qkv)},
            "attn": {
                "q": q(attn["q"] * s_qkv[:, None]),
                "k": q(attn["k"] * s_qkv[:, None]),
                # v: input scaled by s_qkv, output channels carry 1/s_o
                "v": q((attn["v"] * s_qkv[:, None]) / s_o_v[None, :]),
                "o": q(attn["o"] * s_o[:, None]),
            },
            "mlp_norm": {"scale": folded_norm(layer["mlp_norm"]["scale"], s_gu)},
            "mlp": {
                "gate": q(mlp["gate"] * s_gu[:, None]),
                # up: input scaled by s_gu, output channels carry 1/s_down
                "up": q((mlp["up"] * s_gu[:, None]) / s_down[None, :]),
                "down": q(mlp["down"] * s_down[:, None]),
            },
        })
    logger.info("AWQ-quantized %d layers (int%d, group %d)", len(out["layers"]), bits, group_size)
    return out


# -- GPTQ: error-compensated rounding -------------------------------------------

def gptq_quantize_tensor(w: np.ndarray, gram: np.ndarray, bits: int, group_size: int,
                         damp: float = 0.01) -> QuantizedTensor:
    """Column-serial GPTQ: quantize the input-dim rows in order, pushing each
    row's rounding error onto the rows not yet quantized through the
    Cholesky factor of the inverse (damped) Hessian. Returns a
    QuantizedTensor on the CPU."""
    w = np.asarray(w, np.float64).copy()
    kin, kout = w.shape
    qmax = 7 if bits == 4 else (1 << (bits - 1)) - 1
    g = group_size if (kin % group_size == 0 and not (bits == 4 and kin % 2)) else kin
    ngroups = kin // g

    hess = np.asarray(gram, np.float64).copy()
    dead = np.diag(hess) <= 0
    hess[dead, dead] = 1.0
    w[dead, :] = 0.0
    hess += np.eye(kin) * damp * float(np.mean(np.diag(hess)))
    hinv = np.linalg.inv(hess)
    # upper factor U with Hinv = Uᵀ U
    u = np.linalg.cholesky(hinv).T

    codes = np.zeros((kin, kout), np.int8)
    scales = np.zeros((ngroups, kout), np.float32)
    for i in range(kin):
        gi = i // g
        if i % g == 0:
            # group scales from the current (error-updated) rows
            amax = np.max(np.abs(w[i:i + g]), axis=0)
            scales[gi] = np.maximum(amax, 1e-12) / qmax
        qrow = np.clip(np.round(w[i] / scales[gi]), -qmax, qmax)
        codes[i] = qrow.astype(np.int8)
        err = (w[i] - qrow * scales[gi]) / u[i, i]
        if i + 1 < kin:
            w[i + 1:] -= np.outer(u[i, i + 1:], err)
    return tensor_from_int_codes(codes, scales, bits, g)


_SITE_OF = {"q": "attn_in", "k": "attn_in", "v": "attn_in", "o": "o_in",
            "gate": "mlp_in", "up": "mlp_in", "down": "down_in"}


def gptq_quantize_params(params, cfg: TransformerConfig, stats, bits: int = 4,
                         group_size: int = 128) -> Dict[str, Any]:
    """GPTQ over every transformer linear; the lm_head is rounded to nearest."""
    dev = _device_of(params)
    out: Dict[str, Any] = {"embed": params["embed"], "layers": [],
                           "final_norm": params["final_norm"]}
    if "lm_head" in params:
        out["lm_head"] = _lm_head(params, bits, group_size, dev)
    for li, layer in enumerate(params["layers"]):
        st = stats[li]
        new_layer = {"attn_norm": layer["attn_norm"], "mlp_norm": layer["mlp_norm"],
                     "attn": {}, "mlp": {}}
        for grp in ("attn", "mlp"):
            for name, w in layer[grp].items():
                gram = st[_SITE_OF[name]]["gram"]
                new_layer[grp][name] = _on(gptq_quantize_tensor(_host(w), gram, bits, group_size),
                                           dev)
        out["layers"].append(new_layer)
    logger.info("GPTQ-quantized %d layers (int%d, group %d)", len(out["layers"]), bits, group_size)
    return out


def quantize_params_calibrated(params, cfg: TransformerConfig, method: str,
                               calib_batches: Sequence[Tuple[np.ndarray, np.ndarray]],
                               bits: int = 4, group_size: int = 128) -> Dict[str, Any]:
    """Quantize a params tree with calibration (method ``awq`` or ``gptq``);
    the result lies on the params' device."""
    if method not in ("awq", "gptq"):
        raise ValueError(f"unknown calibrated method: {method}")
    stats = collect_calibration_stats(params, cfg, calib_batches)
    if method == "awq":
        return awq_quantize_params(params, cfg, stats, bits, group_size)
    return gptq_quantize_params(params, cfg, stats, bits, group_size)
