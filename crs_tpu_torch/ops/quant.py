"""Scalar (int8) vector quantization and the quantized top-k scan
(port of ``crs_tpu.ops.quant``), and the weight quantizers beside them.

Corpus vectors are stored as per-vector-scaled int8 codes; the candidate scan
ranks by the fully quantized dot (int8 query × int8 codes, per-row scales),
then the top ``rescore_k`` candidates are re-scored against the fp32 query.

At ≥ ``SCAN_MIN_ROWS`` rows the candidate scan goes through
:func:`crs_tpu_torch.ops.scan.scan_topk_int8` (the CUDA kernel on the card);
below it the product is plain torch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .topk import NEG_INF, topk_stable

__all__ = [
    "scalar_quantize", "scalar_dequantize", "int8_dot", "int8_rowdot", "int8_topk",
    "int8_product", "quantize_int8_rowwise", "quantize_int4_grouped", "dequantize_int4_grouped",
    "SCAN_MIN_ROWS",
]

# corpora at least this many rows route the candidate scan through the
# scan kernel (``crs_tpu.ops.quant._PALLAS_SCAN_MIN_ROWS``)
SCAN_MIN_ROWS = 4 * 4096

# past this many [B, N] score-matrix bytes the dense body goes blockwise
_INT8_DENSE_MAX_SCORE_BYTES = 1 << 30

# |Σ_d a_d·b_d| ≤ 127²·D stays below 2²⁴ for D ≤ 1040, so every partial sum
# of an int8 product is an integer that float32 holds exactly, in any order
_MAX_EXACT_DIM = (1 << 24) // (127 * 127)

_RECIP_7 = float(np.float32(1.0) / np.float32(7.0))  # XLA's x / 7 under jit


def scalar_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: (codes int8 [N, D], scales f32 [N]).
    ``torch.round`` rounds half to even, like ``jnp.round``. XLA compiles
    the JAX version's ``/ 127.0`` into a product with float32(1/127), so the
    scales are computed that way too, to the bit."""
    x = x.float()
    amax = x.abs().amax(dim=-1)
    scales = torch.clamp_min(amax, 1e-12) * (1.0 / 127.0)
    codes = torch.clamp(torch.round(x / scales[:, None]), -127, 127).to(torch.int8)
    return codes, scales


def scalar_dequantize(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return codes.float() * scales[:, None]


def int8_product(xq: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Exact int8 × int8 → int32 [M, N]. On the card ``torch._int_mm``
    (rows padded to its minimum, at least 17 and a multiple of 8); on the
    CPU, and for widths ``_int_mm`` does not take, float64, which holds
    every partial sum (127²·K < 2⁵³)."""
    m, k = xq.shape
    n = codes.shape[1]
    if xq.is_cuda and k % 8 == 0 and n % 8 == 0:
        mp = max(32, -(-m // 8) * 8)
        if mp != m:
            xq = torch.cat([xq, xq.new_zeros((mp - m, k))], 0)
        return torch._int_mm(xq, codes.contiguous())[:m]
    return (xq.double() @ codes.double()).to(torch.int32)


def _check_no_tf32(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("exact int8 products need torch.backends.cuda.matmul.allow_tf32 = False")


def int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 product ``a [M, D] · b [N, D]ᵀ`` as float32 [M, N]: the
    int32 sum ``crs_tpu`` accumulates, rounded once to f32. Float32 holds
    every partial sum for D ≤ 1040; past that the sums run in float64,
    which holds them for any D (127²·D < 2⁵³). TF32 would round the
    products, so it must be off on the card."""
    if a.shape[-1] > _MAX_EXACT_DIM:
        return (a.double() @ b.double().T).float()
    _check_no_tf32(a)
    return a.float() @ b.float().T


def int8_rowdot(blocks: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact ``blocks [R, S, D] · q [R, D]`` per r, as float32 [R, S] (as
    :func:`int8_dot`)."""
    if q.shape[-1] > _MAX_EXACT_DIM:
        return torch.bmm(blocks.double(), q.double()[:, :, None])[..., 0].float()
    _check_no_tf32(q)
    return torch.bmm(blocks.float(), q.float()[:, :, None])[..., 0]


def _rescore_candidates(codes, scales, queries, cand_ok, cand_ids, k):
    """fp32 rescore of gathered candidates. ``cand_ok`` [B, C] marks the
    candidates that passed the valid/row-mask filtering (an id-based mask,
    not a score sentinel)."""
    cand_vecs = codes[cand_ids].float() * scales[cand_ids][..., None]  # [B, C, D]
    exact = torch.bmm(cand_vecs, queries.float()[:, :, None])[..., 0]
    exact = torch.where(cand_ok, exact, NEG_INF)
    top_s, sel = topk_stable(exact, min(k, exact.shape[1]))
    return top_s, torch.gather(cand_ids, 1, sel)


def _valid_mask(n: int, valid_n, row_mask, device) -> torch.Tensor:
    mask = torch.arange(n, device=device) < (n if valid_n is None else valid_n)
    if row_mask is not None:
        mask = mask & row_mask[:n]
    return mask


def _int8_topk_blockwise(codes, scales, queries, k, valid_n=None, row_mask=None,
                         block_size: int = 65536):
    """Blockwise exact int8-score top-k — the dense body with rescore_k=0 at
    O(B·block_size) peak memory (the ``lax.scan`` of the JAX version as a loop)."""
    n = codes.shape[0]
    b = queries.shape[0]
    dev = queries.device
    q_codes, q_scales = scalar_quantize(queries)
    mask = _valid_mask(n, valid_n, row_mask, dev)
    kk = min(k, -(-n // block_size) * block_size)
    best_s = torch.full((b, kk), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.full((b, kk), -1, dtype=torch.int64, device=dev)
    for start in range(0, n, block_size):
        stop = min(start + block_size, n)
        s = int8_dot(q_codes, codes[start:stop]) * q_scales[:, None] * scales[None, start:stop]
        s = torch.where(mask[None, start:stop], s, NEG_INF)
        if stop - start < block_size:  # zero rows of the padded last block: masked
            s = torch.cat([s, torch.full((b, block_size - (stop - start)), NEG_INF, device=dev)], 1)
        ids = (start + torch.arange(block_size, device=dev))[None, :].expand(b, -1)
        cat_s = torch.cat([best_s, s], 1)
        cat_i = torch.cat([best_i, ids], 1)
        best_s, sel = topk_stable(cat_s, min(k, cat_s.shape[1]))
        best_i = torch.gather(cat_i, 1, sel)
    if best_s.shape[1] < k:
        pad = k - best_s.shape[1]
        best_s = torch.cat([best_s, torch.full((b, pad), NEG_INF, device=dev)], 1)
        best_i = torch.cat([best_i, torch.full((b, pad), -1, dtype=torch.int64, device=dev)], 1)
    return best_s, best_i


def _int8_topk_dense(codes, scales, queries, k, valid_n=None, rescore_k=0, row_mask=None):
    """The non-routing body of :func:`int8_topk` (``_int8_topk_xla``); also
    the scan's exactness fallback target, so it must never route back."""
    n = codes.shape[0]
    if rescore_k <= k and n * queries.shape[0] * 4 > _INT8_DENSE_MAX_SCORE_BYTES:
        return _int8_topk_blockwise(codes, scales, queries, k, valid_n=valid_n, row_mask=row_mask)
    q_codes, q_scales = scalar_quantize(queries)
    approx = int8_dot(q_codes, codes) * q_scales[:, None] * scales[None, :]
    if valid_n is not None:
        row_ids = torch.arange(n, device=approx.device)[None, :]
        approx = torch.where(row_ids < valid_n, approx, NEG_INF)
    if row_mask is not None:
        approx = torch.where(row_mask[None, :], approx, NEG_INF)
    if rescore_k <= k:
        return topk_stable(approx, min(k, n))
    cand_scores, cand_ids = topk_stable(approx, min(rescore_k, n))
    cand_ok = cand_scores > NEG_INF / 2  # unscaled sentinel: safe here
    return _rescore_candidates(codes, scales, queries, cand_ok, cand_ids, k)


def int8_topk(
    codes: torch.Tensor,  # [N, D] int8
    scales: torch.Tensor,  # [N] f32
    queries: torch.Tensor,  # [B, D] f32 (L2-normalized)
    k: int,
    valid_n: Optional[Union[int, torch.Tensor]] = None,
    rescore_k: int = 0,
    row_mask: Optional[torch.Tensor] = None,  # [N] bool — metadata `where` filter
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 scan + optional fp32 rescore of the top ``rescore_k`` candidates.
    Returns (scores [B, k] f32, ids [B, k] int64)."""
    n = codes.shape[0]
    if n < SCAN_MIN_ROWS:
        return _int8_topk_dense(codes, scales, queries, k, valid_n, rescore_k, row_mask)
    from .scan import scan_topk_int8

    valid = n if valid_n is None else valid_n
    if rescore_k <= k:
        return scan_topk_int8(codes, scales, queries, k, valid, row_mask=row_mask)
    cand_k = min(rescore_k, n)
    _, cand_ids = scan_topk_int8(codes, scales, queries, cand_k, valid, row_mask=row_mask)
    cand_ok = (cand_ids >= 0) & (cand_ids < valid)
    cand_ids = torch.clamp_min(cand_ids, 0)  # clamp -1 padding for the gather
    if row_mask is not None:
        cand_ok = cand_ok & row_mask[cand_ids]
    return _rescore_candidates(codes, scales, queries, cand_ok, cand_ids, k)


# -- weight-only quantization of model parameters ----------------------------------
# The JAX versions are jitted, so their divisions by a constant are products
# with its float32 reciprocal; their divisions by scales are true divisions.

def quantize_int8_rowwise(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 for a [in, out] weight: (codes, scales [out])."""
    w = w.float()
    scales = torch.clamp_min(w.abs().amax(dim=0), 1e-12) * (1.0 / 127.0)
    codes = torch.clamp(torch.round(w / scales[None, :]), -127, 127).to(torch.int8)
    return codes, scales


def quantize_int4_grouped(w: torch.Tensor, group_size: int = 128
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-wise symmetric int4 along the input dim of a [in, out] weight:
    unpacked int8 codes in [-7, 7] and scales [in / group_size, out]."""
    kin, kout = w.shape
    if kin % group_size:
        raise ValueError("input dim must be divisible by group_size")
    grouped = w.float().reshape(kin // group_size, group_size, kout)
    scales = torch.clamp_min(grouped.abs().amax(dim=1), 1e-12) * _RECIP_7
    codes = torch.clamp(torch.round(grouped / scales[:, None, :]), -7, 7).to(torch.int8)
    return codes.reshape(kin, kout), scales


def dequantize_int4_grouped(codes: torch.Tensor, scales: torch.Tensor,
                            group_size: int = 128) -> torch.Tensor:
    kin, kout = codes.shape
    grouped = codes.reshape(kin // group_size, group_size, kout).float()
    return (grouped * scales[:, None, :]).reshape(kin, kout)
