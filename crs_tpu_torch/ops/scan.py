"""Fused int8 scan with per-block top-k (port of
``crs_tpu.ops.pallas_scan.pallas_topk_int8``).

The corpus never leaves device memory in score form: per (query tile,
corpus block) the CUDA kernel ``csrc/int8_scan_topk.cu`` computes the int8
dot products and keeps only the block's top ``kb`` rows per query, writing
``[nq, nblocks, kb, QUERY_TILE]`` partials. Everything around it is plain
torch and mirrors the JAX host side step for step:

- :func:`_finalize` merges the partials into a sorted global top-k;
- each block's kb-th best score is a ceiling on what it did not emit
  (:func:`_block_ceilings`); a (query, block) pair whose ceiling reaches the
  global k-th score is rescanned exactly (:func:`_targeted_repair`);
- past the repair budget, the exact dense int8 top-k runs instead. That is
  the algorithm's own exactness step, not a device fallback; ``STATS``
  counts how often each of the two runs.

The per-query quantization scale is ranking-invariant: the kernel never sees
it, and it is applied at finalize, as in JAX.

``block_topk_int8`` is the kernel's wrapper. On a CUDA tensor it launches
the kernel or raises; on a CPU tensor it runs :func:`block_topk_int8_plain`,
the plain torch version of the same function.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional, Tuple, Union

import torch

from .quant import _int8_topk_dense, int8_dot, int8_rowdot, scalar_quantize
from .topk import NEG_INF, topk_stable

__all__ = [
    "BLOCK_ROWS", "QUERY_TILE", "STATS", "scan_topk_int8", "block_topk_int8",
    "block_topk_int8_plain", "build_kernel",
]

# The kernel's tile: BLOCK_ROWS corpus rows × QUERY_TILE queries per CUDA
# block (compile-time constants of csrc/int8_scan_topk.cu, checked at load).
BLOCK_ROWS = 256
QUERY_TILE = 64
_INT_BIG = 2**31 - 1

KERNEL_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "csrc", "int8_scan_topk.cu")
_LIB_NAME = "libint8_scan_topk.so"


class ScanStats:
    """Per-process counts: kernel launches, targeted repairs, exact fallbacks."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.launches = 0
        self.repairs = 0
        self.fallbacks = 0


STATS = ScanStats()

_lib: Optional[ctypes.CDLL] = None


def build_kernel():
    """Compile the kernel when stale (``nvcc``, ``sm_90a``); returns the build result."""
    from .._build import build_library

    return build_library(KERNEL_SOURCE, _LIB_NAME)


def _load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_kernel().path)
        lib.int8_scan_topk_launch.restype = ctypes.c_int
        lib.int8_scan_topk_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.int8_scan_topk_block_rows.restype = ctypes.c_int
        lib.int8_scan_topk_query_tile.restype = ctypes.c_int
        if (lib.int8_scan_topk_block_rows(), lib.int8_scan_topk_query_tile()) != (
                BLOCK_ROWS, QUERY_TILE):
            raise RuntimeError("int8_scan_topk.cu tile constants differ from scan.py's")
        _lib = lib
    return _lib


def _stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# -- the kernel and its plain version ----------------------------------------

def block_topk_int8_plain(
    q_codes: torch.Tensor,  # [nq·QUERY_TILE, D] int8
    codes: torch.Tensor,  # [nblocks·block_size, D] int8
    row_scale: torch.Tensor,  # [nblocks·block_size] f32
    bias: torch.Tensor,  # [nblocks·block_size] f32: 0 allowed, -1e30 padding/masked
    kb: int,
    block_size: int = BLOCK_ROWS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (query, block): s = float(q·c) · row_scale + bias, then kb passes
    of (max, lowest global id among equal maxima, mask that entry to -1e30)
    — ``_scan_kernel_int8`` with ``_extract_block_topk``, literally.
    Returns partials ([nq, nblocks, kb, QUERY_TILE] f32, same shape int32)."""
    bp = q_codes.shape[0]
    nq = bp // QUERY_TILE
    nblocks = codes.shape[0] // block_size
    dev = codes.device
    out_s = torch.empty((nq, nblocks, kb, QUERY_TILE), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, nblocks, kb, QUERY_TILE), dtype=torch.int32, device=dev)
    step = max(1, (1 << 24) // max(bp * block_size, 1))  # ≤ 16M scores per chunk
    for b0 in range(0, nblocks, step):
        b1 = min(b0 + step, nblocks)
        r0, r1 = b0 * block_size, b1 * block_size
        s = int8_dot(q_codes, codes[r0:r1]) * row_scale[None, r0:r1] + bias[None, r0:r1]
        s = s.view(bp, b1 - b0, block_size)
        col = torch.arange(r0, r1, device=dev).view(1, b1 - b0, block_size)
        for j in range(kb):
            m = s.amax(dim=-1)  # [Bp, nb]
            idx = torch.where(s >= m[..., None], col, _INT_BIG).amin(dim=-1)
            out_s[:, b0:b1, j, :] = m.view(nq, QUERY_TILE, b1 - b0).permute(0, 2, 1)
            out_i[:, b0:b1, j, :] = idx.view(nq, QUERY_TILE, b1 - b0).permute(0, 2, 1).int()
            s = torch.where(col == idx[..., None], NEG_INF, s)
    return out_s, out_i


def block_topk_int8(
    q_codes: torch.Tensor,
    codes: torch.Tensor,
    row_scale: torch.Tensor,
    bias: torch.Tensor,
    kb: int,
    block_size: int = BLOCK_ROWS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper: same signature and result as
    :func:`block_topk_int8_plain`. CPU tensors take the plain version; CUDA
    tensors launch ``int8_scan_topk`` or raise."""
    if codes.device.type == "cpu":
        return block_topk_int8_plain(q_codes, codes, row_scale, bias, kb, block_size)
    dev = codes.device
    d = codes.shape[1]
    for name, t, dtype in (("q_codes", q_codes, torch.int8), ("codes", codes, torch.int8),
                           ("row_scale", row_scale, torch.float32),
                           ("bias", bias, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, codes on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if block_size != BLOCK_ROWS:
        raise ValueError(f"the CUDA kernel scans blocks of {BLOCK_ROWS} rows, got {block_size}")
    if q_codes.dim() != 2 or q_codes.shape[1] != d or q_codes.shape[0] % QUERY_TILE:
        raise ValueError(f"q_codes must be [m·{QUERY_TILE}, {d}], got {tuple(q_codes.shape)}")
    n_rows = codes.shape[0]
    if n_rows % BLOCK_ROWS or n_rows >= _INT_BIG or row_scale.shape != (n_rows,) \
            or bias.shape != (n_rows,):
        raise ValueError("codes rows must be a multiple of BLOCK_ROWS, with scale/bias per row")
    if d % 16 or not 16 <= d <= 2048:
        raise ValueError(f"D must be a multiple of 16 in [16, 2048], got {d}")
    if not 1 <= kb <= BLOCK_ROWS:
        raise ValueError(f"kb must be in [1, {BLOCK_ROWS}], got {kb}")
    nq = q_codes.shape[0] // QUERY_TILE
    nblocks = n_rows // BLOCK_ROWS
    out_s = torch.empty((nq, nblocks, kb, QUERY_TILE), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, nblocks, kb, QUERY_TILE), dtype=torch.int32, device=dev)
    lib = _load_lib()
    err = lib.int8_scan_topk_launch(
        q_codes.data_ptr(), codes.data_ptr(), row_scale.data_ptr(), bias.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), nq, nblocks, d, kb, _stream_handle(dev),
    )
    if err != 0:
        raise RuntimeError(f"int8_scan_topk launch failed: CUDA error {err}")
    STATS.launches += 1
    return out_s, out_i


# -- host side (plain torch, mirrors crs_tpu.ops.pallas_scan) -----------------

def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    n = x.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return x
    pad = torch.zeros((target - n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], 0)


def _flat_pool(out: torch.Tensor, b_real: int) -> torch.Tensor:
    """[nq, nblocks, kb, qb] partials → [B, nblocks·kb] merge pool (entry e
    belongs to block e // kb)."""
    nq, nblocks, kb, qb = out.shape
    return out.permute(0, 3, 1, 2).reshape(nq * qb, nblocks * kb)[:b_real]


def _finalize(out_s, out_i, b_real, k):
    """Partials → sorted global top-k [B, k] (ids int64)."""
    flat_s = _flat_pool(out_s, b_real)
    flat_i = _flat_pool(out_i, b_real).long()
    k_eff = min(k, flat_s.shape[1])
    top_s, sel = topk_stable(flat_s, k_eff)
    top_i = torch.gather(flat_i, 1, sel)
    if k_eff < k:  # nblocks·kb < k: pad; the ceiling check then always trips
        b = top_s.shape[0]
        top_s = torch.cat([top_s, torch.full((b, k - k_eff), NEG_INF, device=top_s.device)], 1)
        top_i = torch.cat(
            [top_i, torch.full((b, k - k_eff), -1, dtype=torch.int64, device=top_i.device)], 1)
    return top_s, top_i


def _block_ceilings(out_s, b_real, kb):
    """[B, nblocks] kb-th best per block = ceiling on unemitted scores."""
    nq, nblocks, _, qb = out_s.shape
    return out_s[:, :, kb - 1, :].permute(0, 2, 1).reshape(nq * qb, nblocks)[:b_real]


def _exact_or_fallback(ceilings, top_s, top_i, fallback):
    """Exactness for k > kb without repair: recompute when any (query,
    block) ceiling reaches the global k-th score."""
    kth = top_s[:, -1]
    if bool((ceilings >= kth[:, None]).any()):
        STATS.fallbacks += 1
        return fallback()
    return top_s, top_i


def _default_kb(k: int, nblocks: int) -> int:
    """Winners per block without repair (``crs_tpu``'s ``_default_kb``)."""
    lam = k / max(nblocks, 1)
    return min(k, 16, max(8, math.ceil(6 * lam) + 6))


def _default_kb_repair(k: int, nblocks: int, b: int, max_repairs: int) -> int:
    """Smallest kb whose expected suspicious-pair count (winners per pair
    ~ Poisson(k/nblocks)) stays under a quarter of the repair budget."""
    lam = k / max(nblocks, 1)
    for kb in range(2, 16):
        if b * nblocks * lam**kb / math.factorial(kb) <= max_repairs / 4:
            return min(k, kb)
    return min(k, 16)


def _targeted_repair(pool_s, pool_i, top_s, top_i, ceilings, score_blocks_fn, k,
                     block_size, nblocks, kb, b_real, max_repairs, fallback):
    """Rescan only the flagged (query, block) pairs exactly, drop their
    superseded emissions from the merge pool and re-merge; past
    ``max_repairs`` flagged pairs, the exact fallback."""
    kth = top_s[:, -1]
    susp = ceilings >= kth[:, None]  # [B, nblocks]
    n_susp = int(susp.sum())
    if n_susp == 0:
        return top_s, top_i
    max_repairs = min(max_repairs, b_real * nblocks)
    if n_susp > max_repairs:
        STATS.fallbacks += 1
        return fallback()
    STATS.repairs += 1
    dev = pool_s.device
    margin = torch.where(susp, ceilings - kth[:, None], -math.inf)
    _, pos = topk_stable(margin.reshape(-1), max_repairs)
    qidx = pos // nblocks
    bid = pos % nblocks
    pair_ok = susp.reshape(-1)[pos]
    scores_r = score_blocks_fn(qidx, bid)  # [R, BS], kernel semantics
    scores_r = torch.where(pair_ok[:, None], scores_r, NEG_INF)
    kk = min(k, block_size)
    rep_s, rep_loc = topk_stable(scores_r, kk)
    rep_i = bid[:, None] * block_size + rep_loc
    entry_block = torch.arange(nblocks * kb, device=dev) // kb
    drop = susp[:, entry_block]
    flat_s = torch.where(drop, NEG_INF, pool_s)
    qmask = qidx[None, :] == torch.arange(b_real, device=dev)[:, None]  # [B, R]
    add_s = torch.where(qmask[:, :, None], rep_s[None], NEG_INF)
    add_i = rep_i[None].expand(b_real, max_repairs, kk)
    all_s = torch.cat([flat_s, add_s.reshape(b_real, -1)], 1)
    all_i = torch.cat([pool_i, add_i.reshape(b_real, -1)], 1)
    ts, sel = topk_stable(all_s, k)
    return ts, torch.gather(all_i, 1, sel)


def scan_topk_int8(
    codes: torch.Tensor,  # [N, D] int8
    scales: torch.Tensor,  # [N] f32 per-row scale
    queries: torch.Tensor,  # [B, D] f32 (quantized here)
    k: int,
    valid_n: Union[int, torch.Tensor],
    block_size: int = BLOCK_ROWS,
    kb: int = 0,
    row_mask: Optional[torch.Tensor] = None,  # [N] bool — metadata `where` filter
    repair: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Int8 scan top-k with ``int8_topk``'s quantized-score semantics,
    exact for any kb (ceilings + targeted repair + fallback). Returns
    (scores [B, k] f32, ids [B, k] int64)."""
    b_real = queries.shape[0]
    dev = codes.device
    q_codes, q_scales = scalar_quantize(queries)
    q_codes = _pad_rows(q_codes, QUERY_TILE)
    vecs = _pad_rows(codes, block_size)
    np_rows = vecs.shape[0]
    nblocks = np_rows // block_size
    if not kb:
        kb = _default_kb_repair(k, nblocks, b_real, repair) if repair else _default_kb(k, nblocks)
    vs = _pad_rows(scales, block_size)
    allowed = torch.arange(np_rows, device=dev) < valid_n
    if row_mask is not None:
        allowed = allowed & _pad_rows(row_mask, np_rows)
    bias = torch.where(allowed, 0.0, NEG_INF).float()

    def fallback():
        return _int8_topk_dense(codes, scales, queries, k, valid_n, rescore_k=0,
                                row_mask=row_mask)

    out_s, out_i = block_topk_int8(q_codes, vecs, vs, bias, kb, block_size)
    top_s, top_i = _finalize(out_s, out_i, b_real, k)
    top_s = top_s * q_scales[:, None]  # restore int8_topk score semantics
    if k <= kb:
        return top_s, top_i  # exact by construction
    ceilings = _block_ceilings(out_s, b_real, kb) * q_scales[:, None]
    if not repair:
        return _exact_or_fallback(ceilings, top_s, top_i, fallback)

    def score_blocks(qidx, bid):
        """Exact scores of block ``bid[r]`` for query ``qidx[r]`` in the
        kernel's semantics, times the per-query scale."""
        rows = bid[:, None] * block_size + torch.arange(block_size, device=dev)[None, :]
        codes_blk = vecs[rows]  # [R, BS, D] int8
        acc = int8_rowdot(codes_blk, q_codes[qidx])  # [R, BS]
        return (acc * vs[rows] + bias[rows]) * q_scales[qidx][:, None]

    return _targeted_repair(
        _flat_pool(out_s, b_real) * q_scales[:, None], _flat_pool(out_i, b_real).long(),
        top_s, top_i, ceilings, score_blocks, k, block_size, nblocks, kb, b_real,
        repair, fallback,
    )
