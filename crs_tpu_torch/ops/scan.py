"""Fused scans with per-block top-k (port of ``crs_tpu.ops.pallas_scan``).

The corpus never leaves device memory in score form: per (query tile,
corpus block) a CUDA kernel scores the block and keeps only its top ``kb``
rows per query, writing ``[nq, nblocks, kb, tile]`` partials. Four scans
share that contract and the host side around it:

- :func:`scan_topk_int8` — ``pallas_topk_int8`` → ``csrc/int8_scan_topk.cu``;
- :func:`scan_topk` (fp32/bf16) — ``pallas_topk`` → ``csrc/scan_topk_f32_bf16.cu``;
- :func:`scan_topk_residual_pq_adc` — ``pallas_topk_residual_pq_adc`` →
  ``csrc/pq_adc_scan_topk.cu`` with the coarse term;
- :func:`scan_topk_pq_adc` — ``pallas_topk_pq_adc`` → the same source without it.

Everything around the kernels is plain torch and mirrors the JAX host side
step for step (:func:`_scan_driver`):

- :func:`_finalize` merges the partials into a sorted global top-k;
- each block's kb-th best score is a ceiling on what it did not emit
  (:func:`_block_ceilings`); a (query, block) pair whose ceiling reaches the
  global k-th score is rescanned exactly (:func:`_targeted_repair`) by the
  scan's ``score_blocks``, which mirrors the JAX one literally;
- past the repair budget, the scan's exact route runs instead. That is the
  algorithm's own exactness step, not a device fallback; ``STATS`` counts
  how often each of the two runs.

Each ``block_topk_*`` function is a kernel's wrapper. On a CUDA tensor it
launches the kernel or raises; on a CPU tensor it runs the
``block_topk_*_plain`` function beside it, the plain torch version of the
same function. Rows are padded exactly as ``crs_tpu`` pads them (its
``group`` of blocks per grid step), so the block count, ``kb`` and every
repair decision are the JAX package's.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from .launch import KernelStats, check_operands, launch, stream_handle
from .quant import _int8_topk_dense, int8_dot, int8_rowdot, scalar_quantize
from .topk import NEG_INF, blockwise_topk, topk_stable

__all__ = [
    "BLOCK_ROWS", "QUERY_TILE", "FLOAT_QUERY_TILE", "ADC_QUERY_TILE", "CHUNK_ROWS", "STATS",
    "scan_topk_int8", "scan_topk", "scan_topk_residual_pq_adc", "scan_topk_pq_adc",
    "scan_topk_residual_pq_adc_luts", "scan_topk_pq_adc_luts",
    "block_topk_int8", "block_topk_int8_plain", "block_topk_float", "block_topk_float_plain",
    "block_topk_adc", "block_topk_adc_plain", "adc_tables", "build_kernels",
]

# Kernel 1's tile: BLOCK_ROWS corpus rows × QUERY_TILE queries per CUDA
# block (compile-time constants of csrc/int8_scan_topk.cu, checked at load).
BLOCK_ROWS = 256
QUERY_TILE = 64
# Kernels 2 and 3/5 take any block_size that is a multiple of CHUNK_ROWS:
# a CUDA block walks its corpus block CHUNK_ROWS rows at a time, keeping a
# running top-kb (kb ≤ MAX_KB) per query.
CHUNK_ROWS = 256
MAX_KB = 32
FLOAT_QUERY_TILE = 64
ADC_QUERY_TILE = 8
_SMEM_LIMIT = 232448  # bytes of shared memory one CUDA block may use (H100)
_INT_BIG = 2**31 - 1

KernelOut = Tuple[torch.Tensor, torch.Tensor]


class ScanStats(KernelStats):
    """Per-process counts: kernel launches (in all and by kernel), targeted
    repairs, exact fallbacks."""

    def reset(self) -> None:
        super().reset()
        self.repairs = 0
        self.fallbacks = 0


STATS = ScanStats()

# kernel → (its source in csrc/, the argument types of its ``<kernel>_launch``)
_I, _P = ctypes.c_int, ctypes.c_void_p
_KERNELS = {
    "int8_scan_topk": ("int8_scan_topk.cu", [_P] * 6 + [_I] * 4 + [_P]),
    "scan_topk_f32": ("scan_topk_f32_bf16.cu", [_P] * 5 + [_I] * 5 + [_P]),
    "scan_topk_bf16": ("scan_topk_f32_bf16.cu", [_P] * 5 + [_I] * 5 + [_P]),
    "adc_scan_topk_residual": ("pq_adc_scan_topk.cu", [_P] * 6 + [_I] * 8 + [_P]),
    "adc_scan_topk_plain": ("pq_adc_scan_topk.cu", [_P] * 6 + [_I] * 8 + [_P]),
}
# each source's tile constants, checked against this module's at load
_TILES = {
    "int8_scan_topk.cu": (("int8_scan_topk_block_rows", BLOCK_ROWS),
                          ("int8_scan_topk_query_tile", QUERY_TILE)),
    "scan_topk_f32_bf16.cu": (("scan_topk_float_chunk_rows", CHUNK_ROWS),
                              ("scan_topk_float_query_tile", FLOAT_QUERY_TILE),
                              ("scan_topk_float_max_kb", MAX_KB)),
    "pq_adc_scan_topk.cu": (("adc_scan_topk_chunk_rows", CHUNK_ROWS),
                            ("adc_scan_topk_query_tile", ADC_QUERY_TILE),
                            ("adc_scan_topk_max_kb", MAX_KB)),
}
_libs: Dict[str, ctypes.CDLL] = {}


def build_kernels():
    """Compile every kernel that is stale (``nvcc``, ``sm_90a``, all at
    once); returns {source: build result}."""
    from .._build import build_all_cuda

    return build_all_cuda()


def _load_kernel_lib(source: str) -> ctypes.CDLL:
    """The built library of ``source``, its launchers typed and its tile
    constants checked against this module's."""
    lib = _libs.get(source)
    if lib is None:
        from .._build import build_cuda

        lib = ctypes.CDLL(build_cuda(source).path)
        for name, (src, argtypes) in _KERNELS.items():
            if src == source:
                fn = getattr(lib, f"{name}_launch")
                fn.restype, fn.argtypes = ctypes.c_int, argtypes
        for sym, want in _TILES[source]:
            getattr(lib, sym).restype = ctypes.c_int
            if getattr(lib, sym)() != want:
                raise RuntimeError(f"{source}: {sym} differs from scan.py's {want}")
        _libs[source] = lib
    return lib


def _load_lib() -> ctypes.CDLL:
    return _load_kernel_lib("int8_scan_topk.cu")


_stream_handle = stream_handle
_check_operands = check_operands


def _launch(kernel: str, source: str, *args) -> None:
    """Call ``kernel``'s launcher; raise on a non-zero CUDA error, count it
    otherwise."""
    launch(STATS, kernel, getattr(_load_kernel_lib(source), f"{kernel}_launch"), *args)


def _partials(nq: int, nblocks: int, kb: int, tile: int, dev) -> KernelOut:
    return (torch.empty((nq, nblocks, kb, tile), dtype=torch.float32, device=dev),
            torch.empty((nq, nblocks, kb, tile), dtype=torch.int32, device=dev))


def _block_topk_plain(score_fn: Callable[[int, int], torch.Tensor], bp: int, n_rows: int,
                      kb: int, block_size: int, tile: int, dev) -> KernelOut:
    """The kernels' per-block extraction, literally (``_extract_block_topk``):
    per (query, block), kb passes of (max, lowest global id among equal
    maxima, set that entry to -1e30). ``score_fn(r0, r1)`` gives the
    [bp, r1 - r0] f32 scores of rows r0..r1, bias included."""
    nq = bp // tile
    nblocks = n_rows // block_size
    out_s, out_i = _partials(nq, nblocks, kb, tile, dev)
    step = max(1, (1 << 24) // max(bp * block_size, 1))  # ≤ 16M scores per chunk
    for b0 in range(0, nblocks, step):
        b1 = min(b0 + step, nblocks)
        r0, r1 = b0 * block_size, b1 * block_size
        s = score_fn(r0, r1).view(bp, b1 - b0, block_size)
        col = torch.arange(r0, r1, device=dev).view(1, b1 - b0, block_size)
        for j in range(kb):
            m = s.amax(dim=-1)  # [Bp, nb]
            idx = torch.where(s >= m[..., None], col, _INT_BIG).amin(dim=-1)
            out_s[:, b0:b1, j, :] = m.view(nq, tile, b1 - b0).permute(0, 2, 1)
            out_i[:, b0:b1, j, :] = idx.view(nq, tile, b1 - b0).permute(0, 2, 1).int()
            s = torch.where(col == idx[..., None], NEG_INF, s)
    return out_s, out_i


def _check_block_shape(n_rows: int, bias: torch.Tensor, block_size: int, kb: int) -> None:
    if block_size % CHUNK_ROWS or block_size <= 0:
        raise ValueError(f"block_size must be a positive multiple of {CHUNK_ROWS}, got {block_size}")
    if n_rows % block_size or n_rows >= _INT_BIG or bias.shape != (n_rows,):
        raise ValueError("corpus rows must be a multiple of block_size, with one bias per row")
    if not 1 <= kb <= MAX_KB:
        raise ValueError(f"kb must be in [1, {MAX_KB}], got {kb}")


# -- kernel 1: int8 (csrc/int8_scan_topk.cu) ---------------------------------

def block_topk_int8_plain(
    q_codes: torch.Tensor,  # [nq·QUERY_TILE, D] int8
    codes: torch.Tensor,  # [nblocks·block_size, D] int8
    row_scale: torch.Tensor,  # [nblocks·block_size] f32
    bias: torch.Tensor,  # [nblocks·block_size] f32: 0 allowed, -1e30 padding/masked
    kb: int,
    block_size: int = BLOCK_ROWS,
) -> KernelOut:
    """Per (query, block): s = float(q·c) · row_scale + bias, then the
    extraction — ``_scan_kernel_int8`` with ``_extract_block_topk``.
    Returns partials ([nq, nblocks, kb, QUERY_TILE] f32, same shape int32)."""

    def scores(r0, r1):
        return int8_dot(q_codes, codes[r0:r1]) * row_scale[None, r0:r1] + bias[None, r0:r1]

    return _block_topk_plain(scores, q_codes.shape[0], codes.shape[0], kb, block_size,
                             QUERY_TILE, codes.device)


def block_topk_int8(
    q_codes: torch.Tensor,
    codes: torch.Tensor,
    row_scale: torch.Tensor,
    bias: torch.Tensor,
    kb: int,
    block_size: int = BLOCK_ROWS,
) -> KernelOut:
    """The kernel's wrapper: same signature and result as
    :func:`block_topk_int8_plain`. CPU tensors take the plain version; CUDA
    tensors launch ``int8_scan_topk`` or raise."""
    if codes.device.type == "cpu":
        return block_topk_int8_plain(q_codes, codes, row_scale, bias, kb, block_size)
    dev = codes.device
    d = codes.shape[1]
    _check_operands(dev, ("q_codes", q_codes, torch.int8), ("codes", codes, torch.int8),
                    ("row_scale", row_scale, torch.float32), ("bias", bias, torch.float32))
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
    out_s, out_i = _partials(nq, nblocks, kb, QUERY_TILE, dev)
    launch(STATS, "int8_scan_topk", _load_lib().int8_scan_topk_launch,
           q_codes.data_ptr(), codes.data_ptr(), row_scale.data_ptr(), bias.data_ptr(),
           out_s.data_ptr(), out_i.data_ptr(), nq, nblocks, d, kb, _stream_handle(dev))
    return out_s, out_i


# -- kernel 2: fp32 / bf16 (csrc/scan_topk_f32_bf16.cu) ----------------------

def block_topk_float_plain(
    q: torch.Tensor,  # [nq·FLOAT_QUERY_TILE, D], the corpus dtype
    vecs: torch.Tensor,  # [nblocks·block_size, D] f32 or bf16
    bias: torch.Tensor,  # [nblocks·block_size] f32
    kb: int,
    block_size: int,
) -> KernelOut:
    """Per (query, block): s = q·v in f32 (bf16 products are exact in f32)
    + bias, then the extraction — ``_scan_kernel`` literally, up to the
    order of the f32 sums."""

    def scores(r0, r1):
        _check_no_tf32(vecs)
        return q.float() @ vecs[r0:r1].float().T + bias[None, r0:r1]

    return _block_topk_plain(scores, q.shape[0], vecs.shape[0], kb, block_size,
                             FLOAT_QUERY_TILE, vecs.device)


def _check_no_tf32(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the fp32 scan needs torch.backends.cuda.matmul.allow_tf32 = False")


def block_topk_float(
    q: torch.Tensor,
    vecs: torch.Tensor,
    bias: torch.Tensor,
    kb: int,
    block_size: int,
) -> KernelOut:
    """The kernel's wrapper: same signature and result as
    :func:`block_topk_float_plain`. CPU tensors take the plain version; CUDA
    tensors launch ``scan_topk_f32`` / ``scan_topk_bf16`` or raise."""
    if vecs.device.type == "cpu":
        return block_topk_float_plain(q, vecs, bias, kb, block_size)
    dev = vecs.device
    if vecs.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the float scan takes f32 or bf16 vectors, got {vecs.dtype}")
    _check_operands(dev, ("q", q, vecs.dtype), ("vectors", vecs, vecs.dtype),
                    ("bias", bias, torch.float32))
    n_rows, d = vecs.shape
    if q.dim() != 2 or q.shape[1] != d or q.shape[0] % FLOAT_QUERY_TILE:
        raise ValueError(f"q must be [m·{FLOAT_QUERY_TILE}, {d}], got {tuple(q.shape)}")
    if d % 32 or not 32 <= d <= 4096:
        raise ValueError(f"D must be a multiple of 32 in [32, 4096], got {d}")
    _check_block_shape(n_rows, bias, block_size, kb)
    nq = q.shape[0] // FLOAT_QUERY_TILE
    nblocks = n_rows // block_size
    out_s, out_i = _partials(nq, nblocks, kb, FLOAT_QUERY_TILE, dev)
    kernel = "scan_topk_f32" if vecs.dtype == torch.float32 else "scan_topk_bf16"
    _launch(kernel, "scan_topk_f32_bf16.cu", q.data_ptr(), vecs.data_ptr(), bias.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), nq, nblocks, block_size, kb, d,
            _stream_handle(dev))
    return out_s, out_i


# -- kernels 3 and 5: PQ ADC (csrc/pq_adc_scan_topk.cu) ----------------------

def adc_tables(lut: torch.Tensor, coarse_lut: Optional[torch.Tensor] = None):
    """The ADC kernels' tables, rounded as the TPU kernels round them: the
    residual LUT to bf16 (round to nearest even), the coarse LUT as a hi+lo
    bf16 pair (hi = bf16(c), lo = bf16(c − hi)). Returns (lut_bf16 [B, M, K],
    hi [B, C] bf16 or None, lo [B, C] bf16 or None)."""
    lut_bf = lut.to(torch.bfloat16).contiguous()  # an einsum's result may be strided
    if coarse_lut is None:
        return lut_bf, None, None
    hi = coarse_lut.to(torch.bfloat16).contiguous()
    lo = (coarse_lut - hi.float()).to(torch.bfloat16).contiguous()
    return lut_bf, hi, lo


def block_topk_adc_plain(
    lut_bf: torch.Tensor,  # [nq·ADC_QUERY_TILE, M, K] bf16
    codes: torch.Tensor,  # [nblocks·block_size, M (+2)] uint8
    bias: torch.Tensor,  # [nblocks·block_size] f32
    kb: int,
    block_size: int,
    coarse_hi: Optional[torch.Tensor] = None,  # [nq·ADC_QUERY_TILE, C] bf16
    coarse_lo: Optional[torch.Tensor] = None,
) -> KernelOut:
    """Per (query, row): s = (hi + lo)[cid] (residual layout only), then
    + lut[m, code_m] for m = 0..M−1 in order, then + bias — the order in
    which ``_scan_kernel_residual_pq_adc`` / ``_scan_kernel_pq_adc`` add
    their one-hot products (every other product is an exact zero), so the
    scores are the Pallas kernels' to the bit. Then the extraction."""
    residual = coarse_hi is not None
    bp = lut_bf.shape[0]
    m_sub = lut_bf.shape[1]
    off = 2 if residual else 0
    lut_f = lut_bf.float()
    hi_f = coarse_hi.float() if residual else None
    lo_f = coarse_lo.float() if residual else None

    def scores(r0, r1):
        cb = codes[r0:r1].long()
        s = torch.zeros((bp, r1 - r0), dtype=torch.float32, device=codes.device)
        if residual:
            cid = cb[:, 0] * 256 + cb[:, 1]
            s = s + hi_f[:, cid]
            s = s + lo_f[:, cid]
        for mi in range(m_sub):
            s = s + lut_f[:, mi, :][:, cb[:, off + mi]]
        return s + bias[None, r0:r1]

    return _block_topk_plain(scores, bp, codes.shape[0], kb, block_size, ADC_QUERY_TILE,
                             codes.device)


def _adc_grid_x(nblocks: int, nq: int, dev) -> int:
    """CUDA blocks along the corpus: enough for ~8 per SM over all query
    tiles, each walking ⌈nblocks / grid_x⌉ corpus blocks with its query
    tile's LUT loaded into shared memory once."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(nblocks, -(-8 * sms // max(nq, 1))))


def block_topk_adc(
    lut_bf: torch.Tensor,
    codes: torch.Tensor,
    bias: torch.Tensor,
    kb: int,
    block_size: int,
    coarse_hi: Optional[torch.Tensor] = None,
    coarse_lo: Optional[torch.Tensor] = None,
) -> KernelOut:
    """The kernels' wrapper: same signature and result as
    :func:`block_topk_adc_plain`. CPU tensors take the plain version; CUDA
    tensors launch ``adc_scan_topk_residual`` (with the coarse term) or
    ``adc_scan_topk_plain``, or raise."""
    if codes.device.type == "cpu":
        return block_topk_adc_plain(lut_bf, codes, bias, kb, block_size, coarse_hi, coarse_lo)
    dev = codes.device
    residual = coarse_hi is not None
    _check_operands(dev, ("lut", lut_bf, torch.bfloat16), ("codes", codes, torch.uint8),
                    ("bias", bias, torch.float32))
    bp, m_sub, k_clusters = lut_bf.shape
    cols = m_sub + (2 if residual else 0)
    n_rows = codes.shape[0]
    if bp % ADC_QUERY_TILE or codes.dim() != 2 or codes.shape[1] != cols:
        raise ValueError(f"lut must be [m·{ADC_QUERY_TILE}, M, K] and codes [N, {cols}]")
    if not 1 <= k_clusters <= 256:
        raise ValueError(f"the ADC kernels take K ≤ 256 clusters, got {k_clusters}")
    _check_block_shape(n_rows, bias, block_size, kb)
    smem = (ADC_QUERY_TILE * m_sub * k_clusters * 2 + ((CHUNK_ROWS * cols + 15) // 16) * 16
            + ADC_QUERY_TILE * CHUNK_ROWS * 4)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"M·K = {m_sub}·{k_clusters} needs {smem} bytes of shared memory "
                         f"per CUDA block, more than {_SMEM_LIMIT}")
    num_coarse = 0
    hilo = codes  # any valid pointer when there is no coarse term
    if residual:
        num_coarse = coarse_hi.shape[1]
        if coarse_hi.shape != (bp, num_coarse) or coarse_lo.shape != (bp, num_coarse) \
                or coarse_hi.dtype != torch.bfloat16 or coarse_lo.dtype != torch.bfloat16:
            raise ValueError("coarse hi/lo must be [B, C] bf16, one row per LUT row")
        if num_coarse > 65536:
            raise ValueError(f"coarse ids must fit two bytes, got C = {num_coarse}")
        # one 32-bit word per (query, coarse id), hi in the low half and lo in
        # the high half, laid out [tile, coarse id, query of the tile]
        hilo = torch.stack([coarse_hi, coarse_lo], -1).contiguous().view(torch.int32)
        hilo = hilo.reshape(-1, ADC_QUERY_TILE, num_coarse).transpose(1, 2).contiguous()
    nq = bp // ADC_QUERY_TILE
    # the kernel's LUT layout [tile, m, code, query of the tile]: the tile's 8
    # values of one (subspace, code) are one 16-byte entry
    lut_k = lut_bf.view(nq, ADC_QUERY_TILE, m_sub, k_clusters).permute(0, 2, 3, 1).contiguous()
    nblocks = n_rows // block_size
    out_s, out_i = _partials(nq, nblocks, kb, ADC_QUERY_TILE, dev)
    kernel = "adc_scan_topk_residual" if residual else "adc_scan_topk_plain"
    _launch(kernel, "pq_adc_scan_topk.cu", lut_k.data_ptr(), hilo.data_ptr(), codes.data_ptr(),
            bias.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), nq, nblocks, block_size,
            _adc_grid_x(nblocks, nq, dev), m_sub, k_clusters, num_coarse, kb,
            _stream_handle(dev))
    return out_s, out_i


# -- host side (plain torch, mirrors crs_tpu.ops.pallas_scan) -----------------

def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    n = x.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return x
    pad = torch.zeros((target - n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], 0)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _auto_group(nblocks: int, block_bytes: int) -> int:
    """``crs_tpu``'s blocks per grid step of the dense scans; the port pads
    rows to a multiple of ``group·block_size`` as it does."""
    for g in (8, 4, 2):
        if g * block_bytes <= 8 * 2**20 and nblocks >= 8 * g:
            return g
    return 1


def _auto_group_adc(nblocks: int, block_size: int, qb: int, code_cols: int) -> int:
    """``crs_tpu``'s blocks per grid step of the ADC scans (same padding rule)."""
    block_bytes = block_size * (4 * qb + 2 * 256 + code_cols)
    for g in (8, 4, 2):
        if g * block_bytes <= 16 * 2**20 and nblocks >= 8 * g:
            return g
    return 1


def _bias_row(np_rows: int, valid_n, row_mask, dev) -> torch.Tensor:
    """Padding and the `where` mask as an additive f32 row: 0 / -1e30."""
    allowed = torch.arange(np_rows, device=dev) < valid_n
    if row_mask is not None:
        allowed = allowed & _pad_rows(row_mask, np_rows)
    return torch.where(allowed, 0.0, NEG_INF).float()


def _block_rows(bid: torch.Tensor, block_size: int) -> torch.Tensor:
    return bid[:, None] * block_size + torch.arange(block_size, device=bid.device)[None, :]


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


def _scan_driver(partials_fn: Callable[[], KernelOut],
                 score_blocks_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                 fallback_fn: Callable[[], KernelOut], *, b_real: int, k: int, kb: int,
                 block_size: int, nblocks: int, repair: int,
                 q_scale: Optional[torch.Tensor] = None) -> KernelOut:
    """The host side every scan shares: partials → finalize → (k ≤ kb:
    done) → ceilings → targeted repair, or the exact fallback. ``q_scale``
    [B] multiplies every score after the kernel (the int8 scan's per-query
    scale, which is ranking-invariant and never reaches the kernel)."""

    def scaled(x):
        return x if q_scale is None else x * q_scale[:, None]

    out_s, out_i = partials_fn()
    top_s, top_i = _finalize(out_s, out_i, b_real, k)
    top_s = scaled(top_s)
    if k <= kb:
        return top_s, top_i  # exact by construction
    ceilings = scaled(_block_ceilings(out_s, b_real, kb))
    if not repair:
        return _exact_or_fallback(ceilings, top_s, top_i, fallback_fn)
    return _targeted_repair(
        scaled(_flat_pool(out_s, b_real)), _flat_pool(out_i, b_real).long(),
        top_s, top_i, ceilings, score_blocks_fn, k, block_size, nblocks, kb, b_real,
        repair, fallback_fn,
    )


def _pick_kb(k: int, nblocks: int, b: int, repair: int) -> int:
    return _default_kb_repair(k, nblocks, b, repair) if repair else _default_kb(k, nblocks)


# -- the four scans ----------------------------------------------------------

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
) -> KernelOut:
    """Int8 scan top-k with ``int8_topk``'s quantized-score semantics,
    exact for any kb (ceilings + targeted repair + fallback). Returns
    (scores [B, k] f32, ids [B, k] int64)."""
    b_real = queries.shape[0]
    dev = codes.device
    q_codes, q_scales = scalar_quantize(queries)
    q_codes = _pad_rows(q_codes, QUERY_TILE).contiguous()
    vecs = _pad_rows(codes, block_size).contiguous()
    np_rows = vecs.shape[0]
    nblocks = np_rows // block_size
    if not kb:
        kb = _pick_kb(k, nblocks, b_real, repair)
    vs = _pad_rows(scales, block_size)
    bias = _bias_row(np_rows, valid_n, row_mask, dev)

    def fallback():
        return _int8_topk_dense(codes, scales, queries, k, valid_n, rescore_k=0,
                                row_mask=row_mask)

    def score_blocks(qidx, bid):
        """Exact scores of block ``bid[r]`` for query ``qidx[r]`` in the
        kernel's semantics, times the per-query scale."""
        rows = _block_rows(bid, block_size)
        acc = int8_rowdot(vecs[rows], q_codes[qidx])  # [R, BS]
        return (acc * vs[rows] + bias[rows]) * q_scales[qidx][:, None]

    return _scan_driver(lambda: block_topk_int8(q_codes, vecs, vs, bias, kb, block_size),
                        score_blocks, fallback, b_real=b_real, k=k, kb=kb,
                        block_size=block_size, nblocks=nblocks, repair=repair,
                        q_scale=q_scales)


def scan_topk(
    vectors: torch.Tensor,  # [N, D] f32 or bf16 (rows beyond valid_n = padding)
    queries: torch.Tensor,  # [B, D] f32
    k: int,
    valid_n: Union[int, torch.Tensor],
    block_size: int = 4096,
    kb: int = 0,
    row_mask: Optional[torch.Tensor] = None,
    repair: int = 256,
) -> KernelOut:
    """Fused scan top-k over a float corpus (``pallas_topk``): queries are
    cast to the corpus dtype, scores accumulate in f32. Exact for any kb.
    Returns (scores [B, k] f32, ids [B, k] int64)."""
    n, d = vectors.shape
    b_real = queries.shape[0]
    dev = vectors.device
    q = _pad_rows(queries.to(vectors.dtype), FLOAT_QUERY_TILE).contiguous()
    group = _auto_group(-(-n // block_size), block_size * d * vectors.element_size())
    vecs = _pad_rows(vectors, group * block_size).contiguous()
    np_rows = vecs.shape[0]
    nblocks = np_rows // block_size
    if not kb:
        kb = _pick_kb(k, nblocks, b_real, repair)
    bias = _bias_row(np_rows, valid_n, row_mask, dev)

    def fallback():
        return blockwise_topk(vectors, queries, k, valid_n, row_mask=row_mask)

    def score_blocks(qidx, bid):
        """Exact scores of block ``bid[r]`` for query ``qidx[r]`` in the
        kernel's own semantics (same dtype dot, bias included)."""
        _check_no_tf32(vecs)
        rows = _block_rows(bid, block_size)
        dots = torch.bmm(vecs[rows].float(), q[qidx].float()[:, :, None])[..., 0]
        return dots + bias[rows]

    return _scan_driver(lambda: block_topk_float(q, vecs, bias, kb, block_size),
                        score_blocks, fallback, b_real=b_real, k=k, kb=kb,
                        block_size=block_size, nblocks=nblocks, repair=repair)


def scan_topk_residual_pq_adc_luts(
    coarse_lut: torch.Tensor,  # [B, C] f32: (qR)·coarse
    lut: torch.Tensor,  # [B, M, K] f32: per-subspace (qR)·centroids
    codes_ext: torch.Tensor,  # [N, M+2] uint8 — coarse id hi, lo, then M codes
    k: int,
    valid_n: Union[int, torch.Tensor],
    block_size: int = 2048,
    row_mask: Optional[torch.Tensor] = None,
    repair: int = 256,
) -> KernelOut:
    """:func:`scan_topk_residual_pq_adc` from its LUTs (the part after the
    query-side products)."""
    from .pq import _residual_adc_topk_luts

    n = codes_ext.shape[0]
    m_sub = codes_ext.shape[1] - 2
    b_real = lut.shape[0]
    dev = codes_ext.device
    qb = min(128, _round_up(b_real, 8))
    group = _auto_group_adc(-(-n // block_size), block_size, qb, m_sub + 2)
    codes_p = _pad_rows(codes_ext, group * block_size).contiguous()
    np_rows = codes_p.shape[0]
    nblocks = np_rows // block_size
    kb = _pick_kb(k, nblocks, b_real, repair)
    bias = _bias_row(np_rows, valid_n, row_mask, dev)
    lut_p = _pad_rows(lut, ADC_QUERY_TILE)
    coarse_p = _pad_rows(coarse_lut, ADC_QUERY_TILE)
    lut_bf, hi, lo = adc_tables(lut_p, coarse_p)

    def fallback():
        cid = codes_ext[:, 0].long() * 256 + codes_ext[:, 1].long()
        return _residual_adc_topk_luts(coarse_lut, lut, cid, codes_ext[:, 2:], k, valid_n,
                                       row_mask=row_mask)

    def score_blocks(qidx, bid):
        """ADC scores of flagged blocks: the coarse term in full f32 (as
        the JAX repair scores it, not hi+lo), residual terms in bf16."""
        rows = _block_rows(bid, block_size)
        cb = codes_p[rows].long()  # [R, BS, M+2]
        cid = cb[:, :, 0] * 256 + cb[:, :, 1]
        s = torch.gather(coarse_p[qidx], 1, cid)
        lut_sel = lut_bf[qidx]  # [R, M, K] bf16
        for mi in range(m_sub):
            s = s + torch.gather(lut_sel[:, mi, :], 1, cb[:, :, mi + 2]).float()
        return s + bias[rows]

    return _scan_driver(lambda: block_topk_adc(lut_bf, codes_p, bias, kb, block_size, hi, lo),
                        score_blocks, fallback, b_real=b_real, k=k, kb=kb,
                        block_size=block_size, nblocks=nblocks, repair=repair)


def scan_topk_residual_pq_adc(
    rotation: torch.Tensor,  # [D, D] f32 (OPQ)
    coarse: torch.Tensor,  # [C, D] f32 coarse centroids (rotated space)
    centroids: torch.Tensor,  # [M, K, Dsub] f32 residual codebooks
    codes_ext: torch.Tensor,  # [N, M+2] uint8
    queries: torch.Tensor,  # [B, D] f32
    k: int,
    valid_n: Union[int, torch.Tensor],
    block_size: int = 2048,
    row_mask: Optional[torch.Tensor] = None,
    repair: int = 256,
) -> KernelOut:
    """Fused residual-PQ ADC scan (``pallas_topk_residual_pq_adc``): coarse
    term + residual ADC in one pass over the M+2-byte rows, exact w.r.t. the
    kernel's ADC scores via ceilings, repair and fallback."""
    from .pq import residual_adc_luts

    coarse_lut, lut = residual_adc_luts(rotation, coarse, centroids, queries)
    return scan_topk_residual_pq_adc_luts(coarse_lut, lut, codes_ext, k, valid_n, block_size,
                                          row_mask, repair)


def scan_topk_pq_adc_luts(
    lut: torch.Tensor,  # [B, M, K] f32
    codes: torch.Tensor,  # [N, M] uint8
    k: int,
    valid_n: Union[int, torch.Tensor],
    block_size: int = 2048,
    row_mask: Optional[torch.Tensor] = None,
    repair: int = 256,
) -> KernelOut:
    """:func:`scan_topk_pq_adc` from its LUT."""
    from .pq import _adc_topk_luts

    n, m_sub = codes.shape
    b_real = lut.shape[0]
    dev = codes.device
    qb = min(128, _round_up(b_real, 8))
    group = _auto_group_adc(-(-n // block_size), block_size, qb, m_sub)
    codes_p = _pad_rows(codes, group * block_size).contiguous()
    np_rows = codes_p.shape[0]
    nblocks = np_rows // block_size
    kb = _pick_kb(k, nblocks, b_real, repair)
    bias = _bias_row(np_rows, valid_n, row_mask, dev)
    lut_bf, _, _ = adc_tables(_pad_rows(lut, ADC_QUERY_TILE))

    def fallback():
        return _adc_topk_luts(lut, codes, k, valid_n, row_mask=row_mask)

    def score_blocks(qidx, bid):
        """ADC scores of flagged blocks: bf16 LUT values added in f32 onto
        the bias, in the JAX repair's order."""
        rows = _block_rows(bid, block_size)
        cb = codes_p[rows].long()  # [R, BS, M]
        lut_sel = lut_bf[qidx]
        sc = bias[rows]
        for mi in range(m_sub):
            sc = sc + torch.gather(lut_sel[:, mi, :], 1, cb[:, :, mi]).float()
        return sc

    return _scan_driver(lambda: block_topk_adc(lut_bf, codes_p, bias, kb, block_size),
                        score_blocks, fallback, b_real=b_real, k=k, kb=kb,
                        block_size=block_size, nblocks=nblocks, repair=repair)


def scan_topk_pq_adc(
    centroids: torch.Tensor,  # [M, K, Dsub] f32
    codes: torch.Tensor,  # [N, M] uint8
    queries: torch.Tensor,  # [B, D] f32
    k: int,
    valid_n: Union[int, torch.Tensor],
    block_size: int = 2048,
    row_mask: Optional[torch.Tensor] = None,
    repair: int = 256,
) -> KernelOut:
    """Fused PQ ADC scan (``pallas_topk_pq_adc``): Σ_m lut[m, code_m] with
    bf16 LUT values accumulated in f32, exact w.r.t. those scores."""
    from .pq import adc_lut

    return scan_topk_pq_adc_luts(adc_lut(centroids, queries), codes, k, valid_n, block_size,
                                 row_mask, repair)
