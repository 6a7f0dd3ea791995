"""Fused scans with per-block top-k (port of ``crs_tpu.ops.pallas_scan``).

The corpus never leaves device memory in score form: per (query tile,
corpus block) a CUDA kernel scores the block and keeps only its top ``kb``
rows per query, writing ``[nq, nblocks, kb, tile]`` partials. Four scans
share that contract and the host side around it:

- :func:`scan_topk_int8` — ``pallas_topk_int8`` → ``csrc/int8_scan_topk.cu``;
- :func:`scan_topk` (fp32/bf16) — ``pallas_topk`` → ``csrc/scan_topk_f32_bf16.cu``;
- :func:`scan_topk_residual_pq_adc` — ``pallas_topk_residual_pq_adc`` →
  ``csrc/pq_adc_scan_topk.cu`` with the coarse term;
- :func:`scan_topk_residual_pq_adc_sorted` — ``pallas_topk_residual_pq_adc_sorted``
  → the same source, over rows sorted by coarse id, each tile of ``group``
  blocks reading a 512-id coarse window (:func:`plan_sorted_coarse_windows`);
- :func:`scan_topk_pq_adc` — ``pallas_topk_pq_adc`` → the same source without it.

Two approximate scans share the partials' layout and :func:`_finalize`, and
nothing else (no ceilings, repair or fallback): :func:`scan_topk_segmax` and
:func:`scan_topk_segmax_int8` (``pallas_topk_segmax`` / ``_int8`` →
``csrc/segmax_scan_topk.cu``) keep one (max, argmax) per 128-row segment and
emit each block's top-kseg segments.

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
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .launch import KernelStats, check_operands, launch, scratch, stream_handle
from .quant import _int8_topk_dense, int8_dot, int8_rowdot, scalar_quantize
from .topk import NEG_INF, blockwise_topk, topk_stable

__all__ = [
    "QUERY_TILE", "FLOAT_QUERY_TILE", "ADC_QUERY_TILE", "CHUNK_ROWS", "STATS",
    "scan_topk_int8", "scan_topk", "scan_topk_residual_pq_adc", "scan_topk_pq_adc",
    "scan_topk_residual_pq_adc_luts", "scan_topk_pq_adc_luts",
    "scan_topk_residual_pq_adc_sorted", "scan_topk_residual_pq_adc_sorted_luts",
    "scan_topk_segmax", "scan_topk_segmax_int8", "SEGMAX_QUERY_TILE", "SEGMENT_ROWS",
    "block_topk_int8", "block_topk_int8_plain", "block_topk_float", "block_topk_float_plain",
    "block_topk_adc", "block_topk_adc_plain", "block_topk_adc_sorted",
    "block_topk_adc_sorted_plain", "block_topk_segmax", "block_topk_segmax_plain",
    "block_topk_segmax_int8", "block_topk_segmax_int8_plain", "adc_tables",
    "adc_auto_group", "adc_layout", "AdcPlan", "adc_grid_x",
    "plan_sorted_coarse_windows", "build_kernels",
]

# A CUDA block walks its corpus rows CHUNK_ROWS at a time, keeping a running
# top-kb (kb ≤ MAX_KB) per query. Kernels 1 to 5 take any block_size: a
# block is ⌈block_size / CHUNK_ROWS⌉ chunks from its first row, and the
# columns of its last chunk past its end score -1e30. Kernel 1's partials
# are in tiles of QUERY_TILE queries (compile-time constants of the sources,
# checked at load).
QUERY_TILE = 64
CHUNK_ROWS = 256
MAX_KB = 32
FLOAT_QUERY_TILE = 64
ADC_QUERY_TILE = 8
# the corpus widths the kernels take: kernels 1 and 7 and kernel 2's fp32
# any D (they read the corpus as it is), kernel 2's bf16 a multiple of 8
# (TMA's 16-byte row stride), to which scan_topk zero-pads a bf16 corpus
# (exact: a zero product adds nothing to an f32 sum). The int8 kernels'
# queries arrive padded to a multiple of 16 (their wrappers pad them).
_INT8_Q_MULTIPLE = 16
_FLOAT_D_MULTIPLE = {torch.float32: 1, torch.bfloat16: 8}
# Kernels 6 and 7 (segment max): partials in tiles of 64 queries (a CUDA
# block scores two tiles), CHUNK_ROWS rows a step, any block of whole
# 128-row segments; up to MAX_SMEM_SEGMENTS segments a block the segment
# winners stay in shared memory, past that in a device scratch.
SEGMAX_QUERY_TILE = 64
SEGMENT_ROWS = 128
MAX_SMEM_SEGMENTS = 64
_INT_BIG = 2**31 - 1

KernelOut = Tuple[torch.Tensor, torch.Tensor]


class ScanStats(KernelStats):
    """Per-process counts: kernel launches (in all and by kernel), targeted
    repairs and the (query, block) pairs they rescanned, exact fallbacks."""

    def reset(self) -> None:
        super().reset()
        self.repairs = 0
        self.repaired_pairs = 0
        self.fallbacks = 0


STATS = ScanStats()

# kernel → (its source in csrc/, the argument types of its ``<kernel>_launch``)
_I, _P = ctypes.c_int, ctypes.c_void_p
_KERNELS = {
    "int8_scan_topk": ("int8_scan_topk.cu", [_P] * 6 + [_I] * 5 + [_P]),
    "scan_topk_f32": ("scan_topk_f32_bf16.cu", [_P] * 5 + [_I] * 5 + [_P]),
    "scan_topk_bf16": ("scan_topk_f32_bf16.cu", [_P] * 5 + [_I] * 5 + [_P]),
    "adc_scan_topk_residual": ("pq_adc_scan_topk.cu", [_P] * 6 + [_I] * 11 + [_P]),
    "adc_scan_topk_plain": ("pq_adc_scan_topk.cu", [_P] * 6 + [_I] * 11 + [_P]),
    "adc_scan_topk_sorted": ("pq_adc_scan_topk.cu", [_P] * 7 + [_I] * 12 + [_P]),
    "segmax_scan_topk_f32": ("segmax_scan_topk.cu", [_P] * 7 + [_I] * 6 + [_P]),
    "segmax_scan_topk_bf16": ("segmax_scan_topk.cu", [_P] * 7 + [_I] * 6 + [_P]),
    "segmax_scan_topk_int8": ("segmax_scan_topk.cu", [_P] * 7 + [_I] * 6 + [_P]),
}
# each source's tile constants, checked against this module's at load
_TILES = {
    "int8_scan_topk.cu": (("int8_scan_topk_chunk_rows", CHUNK_ROWS),
                          ("int8_scan_topk_query_tile", QUERY_TILE),
                          ("int8_scan_topk_max_kb", MAX_KB)),
    "scan_topk_f32_bf16.cu": (("scan_topk_float_chunk_rows", CHUNK_ROWS),
                              ("scan_topk_float_query_tile", FLOAT_QUERY_TILE),
                              ("scan_topk_float_max_kb", MAX_KB)),
    "pq_adc_scan_topk.cu": (("adc_scan_topk_chunk_rows", CHUNK_ROWS),
                            ("adc_scan_topk_query_tile", ADC_QUERY_TILE),
                            ("adc_scan_topk_max_kb", MAX_KB)),
    "segmax_scan_topk.cu": (("segmax_scan_topk_chunk_rows", CHUNK_ROWS),
                            ("segmax_scan_topk_query_tile", SEGMAX_QUERY_TILE),
                            ("segmax_scan_topk_segment_rows", SEGMENT_ROWS),
                            ("segmax_scan_topk_max_smem_segments", MAX_SMEM_SEGMENTS)),
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
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    if n_rows % block_size or n_rows >= _INT_BIG or bias.shape != (n_rows,):
        raise ValueError("corpus rows must be a multiple of block_size, with one bias per row")
    if not 1 <= kb <= MAX_KB:
        raise ValueError(f"kb must be in [1, {MAX_KB}], got {kb}")


# -- zero padding -----------------------------------------------------------

def _pad_cols(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """``x`` [N, D] with zero columns up to a multiple of ``multiple``."""
    extra = _round_up(x.shape[1], multiple) - x.shape[1]
    return x if extra == 0 else torch.nn.functional.pad(x, (0, extra))


# -- kernel 1: int8 (csrc/int8_scan_topk.cu) ---------------------------------

def block_topk_int8_plain(
    q_codes: torch.Tensor,  # [nq·QUERY_TILE, D] int8
    codes: torch.Tensor,  # [nblocks·block_size, D] int8
    row_scale: torch.Tensor,  # [nblocks·block_size] f32
    bias: torch.Tensor,  # [nblocks·block_size] f32: 0 allowed, -1e30 padding/masked
    kb: int,
    block_size: int = CHUNK_ROWS,
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
    block_size: int = CHUNK_ROWS,
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
    if q_codes.dim() != 2 or q_codes.shape[1] != d or q_codes.shape[0] % QUERY_TILE:
        raise ValueError(f"q_codes must be [m·{QUERY_TILE}, {d}], got {tuple(q_codes.shape)}")
    if d < 1:
        raise ValueError("the corpus must have at least one dimension")
    n_rows = codes.shape[0]
    _check_block_shape(n_rows, bias, block_size, kb)
    if row_scale.shape != (n_rows,):
        raise ValueError("one row scale per corpus row")
    nq = q_codes.shape[0] // QUERY_TILE
    nblocks = n_rows // block_size
    # the kernel reads the corpus as it is (any D) and the queries by TMA in
    # 16-byte words: only the [B, D] queries are padded here
    q_codes = _pad_cols(q_codes, _INT8_Q_MULTIPLE).contiguous()
    out_s, out_i = _partials(nq, nblocks, kb, QUERY_TILE, dev)
    launch(STATS, "int8_scan_topk", _load_lib().int8_scan_topk_launch,
           q_codes.data_ptr(), codes.data_ptr(), row_scale.data_ptr(), bias.data_ptr(),
           out_s.data_ptr(), out_i.data_ptr(), nq, nblocks, d, kb, block_size,
           _stream_handle(dev))
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
    if d < 1 or d % _FLOAT_D_MULTIPLE[vecs.dtype]:
        raise ValueError(f"D must be a positive multiple of {_FLOAT_D_MULTIPLE[vecs.dtype]} "
                         f"for {vecs.dtype}, got {d}")
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


def adc_grid_x(nblocks: int, nq: int, sms: int) -> int:
    """CUDA blocks along the corpus for the ADC kernels: about 8 per SM over
    all query tiles, each walking ⌈nblocks / grid_x⌉ corpus blocks with its
    query tile's LUT loaded into shared memory once; of the counts from half
    to twice that, the one whose waves of ``sms`` CUDA blocks are fullest,
    the nearest to it on a tie (41 query tiles × 1,024 blocks on 132 SMs:
    32, ten waves 99 % full, against 26's nine waves, the last 8 % full)."""
    base = max(1, min(nblocks, -(-8 * sms // max(nq, 1))))
    best, best_eff = base, 0.0
    for gx in range(max(1, base // 2), min(nblocks, 2 * base) + 1):
        per = -(-nblocks // gx)
        waves = -(-(-(-nblocks // per)) * nq // sms)
        eff = nblocks * nq / (waves * sms * per)
        if eff > best_eff + 1e-9 or (eff > best_eff - 1e-9 and abs(gx - base) < abs(best - base)):
            best, best_eff = gx, eff
    return best


def _adc_grid_x(nblocks: int, nq: int, dev) -> int:
    return adc_grid_x(nblocks, nq, torch.cuda.get_device_properties(dev).multi_processor_count)


class AdcPlan(NamedTuple):
    """How the ADC kernels' CUDA block takes M subspaces of K clusters."""

    queries: int  # queries a CUDA block scores: 8, or 4, 2, 1 when the tile's LUTs do not fit
    subspaces: int  # subspaces staged at a time: M, or fewer past one query's LUTs
    smem: int  # dynamic shared memory, bytes
    skewed: bool  # the main path: the skewed, conflict-free LUT layout (M ≤ 48 at K = 256)


ADC_SMEM_LIMIT = 232448  # shared memory one CUDA block may use


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def adc_layout(m_sub: int, k_clusters: int, residual: bool) -> AdcPlan:
    """The ADC kernels' plan for M subspaces of K clusters, which the
    wrappers pass to ``csrc/pq_adc_scan_topk.cu`` (the launcher only checks
    that it fits): the skewed main path when the 8 queries' LUTs padded to a
    multiple of 8 subspaces, two chunks' codes and the scores fit; else the
    most queries whose LUTs fit beside one chunk's codes and scores; else 8
    queries with the LUTs staged in slices. ``queries`` 0: none fits."""
    cols = m_sub + (2 if residual else 0)
    skew = (128 + -(-m_sub // 8) * 8 * k_clusters * 16 + 2 * _round16(CHUNK_ROWS * cols)
            + ADC_QUERY_TILE * CHUNK_ROWS * 4)
    if skew <= ADC_SMEM_LIMIT:
        return AdcPlan(ADC_QUERY_TILE, m_sub, skew, True)

    def smem(qt, ms):
        staged = CHUNK_ROWS * (cols if ms == m_sub else ms)
        return qt * ms * k_clusters * 2 + _round16(staged) + qt * CHUNK_ROWS * 4

    qt = ADC_QUERY_TILE
    while qt >= 1:
        if smem(qt, m_sub) <= ADC_SMEM_LIMIT:
            return AdcPlan(qt, m_sub, smem(qt, m_sub), False)
        qt //= 2
    for ms in range(m_sub - 1, 0, -1):
        if smem(ADC_QUERY_TILE, ms) <= ADC_SMEM_LIMIT:
            return AdcPlan(ADC_QUERY_TILE, ms, smem(ADC_QUERY_TILE, ms), False)
    return AdcPlan(0, 0, 0, False)


def _plan_args(m_sub: int, k_clusters: int, residual: bool) -> Tuple[int, int, int]:
    """:func:`adc_layout` as the launchers take it: (qt, ms, skew)."""
    plan = adc_layout(m_sub, k_clusters, residual)
    return plan.queries, plan.subspaces, int(plan.skewed)


def _adc_kernel_operands(lut_bf, codes, bias, kb: int, block_size: int, coarse_hi, coarse_lo,
                         max_coarse: int = 65536):
    """Check what the ADC kernels take and lay out their tables: returns
    (LUT [tile, m, code, query of the tile] — the tile's 8 values of one
    (subspace, code) one 16-byte entry —, the coarse hi/lo words [tile,
    coarse id, query of the tile] — hi in the low half — or ``codes`` as a
    pointer that is never read, query tiles, corpus blocks)."""
    residual = coarse_hi is not None
    _check_operands(codes.device, ("lut", lut_bf, torch.bfloat16), ("codes", codes, torch.uint8),
                    ("bias", bias, torch.float32))
    bp, m_sub, k_clusters = lut_bf.shape
    cols = m_sub + (2 if residual else 0)
    if bp % ADC_QUERY_TILE or codes.dim() != 2 or codes.shape[1] != cols:
        raise ValueError(f"lut must be [m·{ADC_QUERY_TILE}, M, K] and codes [N, {cols}]")
    if not 1 <= k_clusters <= 256:
        raise ValueError(f"the ADC kernels take K ≤ 256 clusters, got {k_clusters}")
    _check_block_shape(codes.shape[0], bias, block_size, kb)
    hilo = codes
    if residual:
        width = coarse_hi.shape[1]
        if coarse_hi.shape != (bp, width) or coarse_lo.shape != (bp, width) \
                or coarse_hi.dtype != torch.bfloat16 or coarse_lo.dtype != torch.bfloat16:
            raise ValueError("coarse hi/lo must be [B, C] bf16, one row per LUT row")
        if width > max_coarse:
            raise ValueError(f"coarse ids must fit two bytes, got a table of {width} ids")
        hilo = torch.stack([coarse_hi, coarse_lo], -1).contiguous().view(torch.int32)
        hilo = hilo.reshape(-1, ADC_QUERY_TILE, width).transpose(1, 2).contiguous()
    nq = bp // ADC_QUERY_TILE
    lut_k = lut_bf.view(nq, ADC_QUERY_TILE, m_sub, k_clusters).permute(0, 2, 3, 1).contiguous()
    return lut_k, hilo, nq, codes.shape[0] // block_size


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
    lut_k, hilo, nq, nblocks = _adc_kernel_operands(lut_bf, codes, bias, kb, block_size,
                                                    coarse_hi, coarse_lo)
    _, m_sub, k_clusters = lut_bf.shape
    num_coarse = 0 if coarse_hi is None else coarse_hi.shape[1]
    out_s, out_i = _partials(nq, nblocks, kb, ADC_QUERY_TILE, dev)
    kernel = "adc_scan_topk_plain" if coarse_hi is None else "adc_scan_topk_residual"
    _launch(kernel, "pq_adc_scan_topk.cu", lut_k.data_ptr(), hilo.data_ptr(), codes.data_ptr(),
            bias.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), nq, nblocks, block_size,
            _adc_grid_x(nblocks, nq, dev), m_sub, k_clusters, num_coarse, kb,
            *_plan_args(m_sub, k_clusters, coarse_hi is not None), _stream_handle(dev))
    return out_s, out_i


# -- kernel 4: PQ ADC over coarse-sorted rows (csrc/pq_adc_scan_topk.cu) -----

def block_topk_adc_sorted_plain(
    lut_bf: torch.Tensor,  # [nq·ADC_QUERY_TILE, M, K] bf16
    codes: torch.Tensor,  # [nblocks·block_size, M+2] uint8, rows sorted by coarse id
    bias: torch.Tensor,  # [nblocks·block_size] f32
    kb: int,
    block_size: int,
    coarse_hi: torch.Tensor,  # [nq·ADC_QUERY_TILE, C + 256] bf16, 256 zero columns last
    coarse_lo: torch.Tensor,
    wbase: torch.Tensor,  # [nblocks / group] int32: each tile's window base, 256-id units
    group: int,
) -> KernelOut:
    """:func:`block_topk_adc_plain` with ``_scan_kernel_residual_pq_adc_sorted``'s
    window rule: block b's tile reads ids ``[256·w, 256·w + 512)``, w =
    ``wbase[b // group]``; a row whose id lies outside (a padding row, a
    hand-built plan) gets a coarse term of exactly 0 (its one-hot row is
    zero), one inside ((0 + hi) + lo) as kernel 3. Then + lut[m, code_m] in
    order, + bias, and the extraction."""
    bp, m_sub = lut_bf.shape[0], lut_bf.shape[1]
    width = coarse_hi.shape[1]
    lut_f = lut_bf.float()
    hi_f, lo_f = coarse_hi.float(), coarse_lo.float()
    wb = wbase.long()

    def scores(r0, r1):
        cb = codes[r0:r1].long()
        cid = cb[:, 0] * 256 + cb[:, 1]
        rel = cid - 256 * wb[torch.arange(r0, r1, device=codes.device) // (group * block_size)]
        inside = (rel >= 0) & (rel < 512) & (cid < width)
        cid = torch.where(inside, cid, 0)
        s = torch.zeros((bp, r1 - r0), dtype=torch.float32, device=codes.device)
        s = s + torch.where(inside, hi_f[:, cid], 0.0)
        s = s + torch.where(inside, lo_f[:, cid], 0.0)
        for mi in range(m_sub):
            s = s + lut_f[:, mi, :][:, cb[:, 2 + mi]]
        return s + bias[None, r0:r1]

    return _block_topk_plain(scores, bp, codes.shape[0], kb, block_size, ADC_QUERY_TILE,
                             codes.device)


def block_topk_adc_sorted(
    lut_bf: torch.Tensor,
    codes: torch.Tensor,
    bias: torch.Tensor,
    kb: int,
    block_size: int,
    coarse_hi: torch.Tensor,
    coarse_lo: torch.Tensor,
    wbase: torch.Tensor,
    group: int,
) -> KernelOut:
    """The kernel's wrapper: same signature and result as
    :func:`block_topk_adc_sorted_plain`. CPU tensors take the plain version;
    CUDA tensors launch ``adc_scan_topk_sorted`` or raise."""
    if codes.device.type == "cpu":
        return block_topk_adc_sorted_plain(lut_bf, codes, bias, kb, block_size, coarse_hi,
                                           coarse_lo, wbase, group)
    dev = codes.device
    _check_operands(dev, ("wbase", wbase, torch.int32))
    width = coarse_hi.shape[1]
    if width % 256 or width < 512:
        raise ValueError(f"the coarse table must be C + 256 ids wide (C % 256 == 0), got {width}")
    lut_k, hilo, nq, nblocks = _adc_kernel_operands(lut_bf, codes, bias, kb, block_size,
                                                    coarse_hi, coarse_lo, 65536 + 256)
    if group < 1 or nblocks % group or wbase.shape != (nblocks // group,):
        raise ValueError(f"group must be ≥ 1 and divide the {nblocks} blocks, with one "
                         f"window base per tile of group blocks; got group {group}, "
                         f"wbase {tuple(wbase.shape)}")
    _, m_sub, k_clusters = lut_bf.shape
    out_s, out_i = _partials(nq, nblocks, kb, ADC_QUERY_TILE, dev)
    _launch("adc_scan_topk_sorted", "pq_adc_scan_topk.cu", lut_k.data_ptr(), hilo.data_ptr(),
            codes.data_ptr(), bias.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            wbase.data_ptr(), nq, nblocks, block_size, _adc_grid_x(nblocks, nq, dev), m_sub,
            k_clusters, width, kb, group, *_plan_args(m_sub, k_clusters, True),
            _stream_handle(dev))
    return out_s, out_i


# -- kernels 6 and 7: segment max (csrc/segmax_scan_topk.cu) -----------------

def _segmax_plain(score_fn: Callable[[int, int], torch.Tensor], bp: int, n_rows: int,
                  valid_n, kseg: int, block_size: int, dev) -> KernelOut:
    """``_scan_kernel_segmax``'s selection, literally: rows at or past
    ``valid_n`` score -1e30; per 128-row segment (max, lowest lane reaching
    it); kseg passes of (largest segment max, lowest segment among equal
    maxima, emit its max and argmax id, set its max to -1e30 and keep its
    id). Partials [nq, nblocks, kseg, SEGMAX_QUERY_TILE]."""
    tile = SEGMAX_QUERY_TILE
    nq = bp // tile
    nblocks = n_rows // block_size
    nseg = block_size // SEGMENT_ROWS
    out_s, out_i = _partials(nq, nblocks, kseg, tile, dev)
    step = max(1, (1 << 24) // max(bp * block_size, 1))
    seg_col = torch.arange(nseg, device=dev)
    lane = torch.arange(SEGMENT_ROWS, device=dev)
    for b0 in range(0, nblocks, step):
        b1 = min(b0 + step, nblocks)
        nb = b1 - b0
        r0, r1 = b0 * block_size, b1 * block_size
        col = torch.arange(r0, r1, device=dev)
        s = torch.where(col[None, :] < valid_n, score_fn(r0, r1), NEG_INF)
        s3 = s.view(bp, nb, nseg, SEGMENT_ROWS)
        segmax = s3.amax(dim=-1)  # [bp, nb, nseg]
        arg_lane = torch.where(s3 >= segmax[..., None], lane, _INT_BIG).amin(dim=-1)
        arg_id = (r0 + torch.arange(nb, device=dev)[:, None] * block_size
                  + seg_col[None, :] * SEGMENT_ROWS) + arg_lane
        for j in range(kseg):
            m = segmax.amax(dim=-1)  # [bp, nb]
            sel = torch.where(segmax >= m[..., None], seg_col, _INT_BIG).amin(dim=-1)
            chosen = torch.gather(arg_id, 2, sel[..., None])[..., 0]
            out_s[:, b0:b1, j, :] = m.view(nq, tile, nb).permute(0, 2, 1)
            out_i[:, b0:b1, j, :] = chosen.view(nq, tile, nb).permute(0, 2, 1).int()
            segmax = torch.where(seg_col == sel[..., None], NEG_INF, segmax)
    return out_s, out_i


def block_topk_segmax_plain(
    q: torch.Tensor,  # [nq·SEGMAX_QUERY_TILE, D], the corpus dtype
    vecs: torch.Tensor,  # [nblocks·block_size, D] f32 or bf16
    valid_n: Union[int, torch.Tensor],
    kseg: int,
    block_size: int,
) -> KernelOut:
    """Per (query, row): s = q·v in f32 (bf16 products are exact in f32),
    -1e30 at rows ≥ valid_n; then the segment-max selection."""

    def scores(r0, r1):
        _check_no_tf32(vecs)
        return q.float() @ vecs[r0:r1].float().T

    return _segmax_plain(scores, q.shape[0], vecs.shape[0], valid_n, kseg, block_size,
                         vecs.device)


def block_topk_segmax_int8_plain(
    q_codes: torch.Tensor,  # [nq·SEGMAX_QUERY_TILE, D] int8
    q_scale: torch.Tensor,  # [nq·SEGMAX_QUERY_TILE] f32
    codes: torch.Tensor,  # [nblocks·block_size, D] int8
    row_scale: torch.Tensor,  # [nblocks·block_size] f32
    valid_n: Union[int, torch.Tensor],
    kseg: int,
    block_size: int,
) -> KernelOut:
    """Per (query, row): s = (f32(q·c) · q_scale) · row_scale, the int32 dot
    exact; -1e30 at rows ≥ valid_n; then the segment-max selection."""

    def scores(r0, r1):
        return int8_dot(q_codes, codes[r0:r1]) * q_scale[:, None] * row_scale[None, r0:r1]

    return _segmax_plain(scores, q_codes.shape[0], codes.shape[0], valid_n, kseg, block_size,
                         codes.device)


def _check_segmax_shape(q, vecs, kseg: int, block_size: int, dim_multiple: int) -> None:
    n_rows, d = vecs.shape
    if q.dim() != 2 or q.shape[1] != d or q.shape[0] % SEGMAX_QUERY_TILE:
        raise ValueError(f"queries must be [m·{SEGMAX_QUERY_TILE}, {d}], got {tuple(q.shape)}")
    if d < 1 or d % dim_multiple:
        raise ValueError(f"D must be a positive multiple of {dim_multiple}, got {d}")
    if block_size % SEGMENT_ROWS or block_size <= 0:
        raise ValueError(f"the segment-max kernels take blocks of whole {SEGMENT_ROWS}-row "
                         f"segments, got {block_size}")
    if n_rows % block_size or n_rows >= _INT_BIG:
        raise ValueError("corpus rows must be a multiple of block_size")
    if not 1 <= kseg <= block_size // SEGMENT_ROWS:
        raise ValueError(f"kseg must be in [1, {block_size // SEGMENT_ROWS}], got {kseg}")


def _segment_scratch(dev, nq: int, nblocks: int, block_size: int) -> int:
    """The segment winners' device room when a block has more than
    MAX_SMEM_SEGMENTS segments ([CUDA blocks][nseg][128] f32 + int32), else
    0: the kernel keeps them in shared memory."""
    nseg = block_size // SEGMENT_ROWS
    if nseg <= MAX_SMEM_SEGMENTS:
        return 0
    ctas = (nq + 1) // 2 * nblocks
    buf = scratch(dev, _stream_handle(dev), "segmax_segments", ctas * nseg * 2 * 2 * QUERY_TILE,
                  torch.float32)
    return buf.data_ptr()


def block_topk_segmax(
    q: torch.Tensor,
    vecs: torch.Tensor,
    valid_n: Union[int, torch.Tensor],
    kseg: int,
    block_size: int,
) -> KernelOut:
    """Kernel 6's wrapper: same signature and result as
    :func:`block_topk_segmax_plain`. CPU tensors take the plain version;
    CUDA tensors launch ``segmax_scan_topk_f32`` / ``_bf16`` or raise."""
    if vecs.device.type == "cpu":
        return block_topk_segmax_plain(q, vecs, valid_n, kseg, block_size)
    dev = vecs.device
    if vecs.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the segment-max scan takes f32 or bf16 vectors, got {vecs.dtype}")
    _check_operands(dev, ("q", q, vecs.dtype), ("vectors", vecs, vecs.dtype))
    _check_segmax_shape(q, vecs, kseg, block_size, _FLOAT_D_MULTIPLE[vecs.dtype])
    nq = q.shape[0] // SEGMAX_QUERY_TILE
    nblocks = vecs.shape[0] // block_size
    out_s, out_i = _partials(nq, nblocks, kseg, SEGMAX_QUERY_TILE, dev)
    kernel = "segmax_scan_topk_f32" if vecs.dtype == torch.float32 else "segmax_scan_topk_bf16"
    _launch(kernel, "segmax_scan_topk.cu", q.data_ptr(), vecs.data_ptr(), q.data_ptr(),
            vecs.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            _segment_scratch(dev, nq, nblocks, block_size), nq, nblocks, block_size,
            vecs.shape[1], kseg, int(valid_n), _stream_handle(dev))
    return out_s, out_i


def block_topk_segmax_int8(
    q_codes: torch.Tensor,
    q_scale: torch.Tensor,
    codes: torch.Tensor,
    row_scale: torch.Tensor,
    valid_n: Union[int, torch.Tensor],
    kseg: int,
    block_size: int,
) -> KernelOut:
    """Kernel 7's wrapper: same signature and result as
    :func:`block_topk_segmax_int8_plain`. CPU tensors take the plain
    version; CUDA tensors launch ``segmax_scan_topk_int8`` or raise."""
    if codes.device.type == "cpu":
        return block_topk_segmax_int8_plain(q_codes, q_scale, codes, row_scale, valid_n, kseg,
                                            block_size)
    dev = codes.device
    _check_operands(dev, ("q_codes", q_codes, torch.int8), ("q_scale", q_scale, torch.float32),
                    ("codes", codes, torch.int8), ("row_scale", row_scale, torch.float32))
    _check_segmax_shape(q_codes, codes, kseg, block_size, 1)
    if q_scale.shape != (q_codes.shape[0],) or row_scale.shape != (codes.shape[0],):
        raise ValueError("one scale per query and per corpus row")
    nq = q_codes.shape[0] // SEGMAX_QUERY_TILE
    nblocks = codes.shape[0] // block_size
    # the corpus is read as it is (any D); the queries by TMA, padded here
    q_codes = _pad_cols(q_codes, _INT8_Q_MULTIPLE).contiguous()
    out_s, out_i = _partials(nq, nblocks, kseg, SEGMAX_QUERY_TILE, dev)
    _launch("segmax_scan_topk_int8", "segmax_scan_topk.cu", q_codes.data_ptr(),
            codes.data_ptr(), q_scale.data_ptr(), row_scale.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), _segment_scratch(dev, nq, nblocks, block_size), nq, nblocks,
            block_size, codes.shape[1], kseg, int(valid_n), _stream_handle(dev))
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


def adc_auto_group(n: int, batch: int, block_size: int, code_cols: int,
                   query_block: int = 128) -> int:
    """The group ``crs_tpu``'s ADC wrappers pick for this geometry (its
    query block ``min(query_block, round_up(batch, 8))``): the sorted scan's
    window plan is made for it."""
    qb = min(query_block, _round_up(batch, 8))
    return _auto_group_adc(-(-n // block_size), block_size, qb, code_cols)


def plan_sorted_coarse_windows(counts, n: int, block_size: int,
                               group: int) -> Optional[np.ndarray]:
    """Per-tile coarse-window base of the sorted residual-ADC scan (host
    numpy, ``crs_tpu``'s planner). ``counts`` = rows per coarse id of a
    corpus sorted by coarse id (:func:`crs_tpu_torch.ops.pq.sort_codes_by_coarse`).
    Each tile of ``group·block_size`` rows gets the 512-id window
    ``[256·base, 256·base + 512)`` around its ids. Returns the int32
    [ntiles] bases, or None when a tile spans more ids than the window
    covers: the caller then takes the unsorted scan."""
    counts = np.asarray(counts)
    rows = group * block_size
    n_pad = _round_up(max(n, 1), rows)
    ntiles = n_pad // rows
    cum = np.cumsum(counts)
    if cum.size == 0 or int(cum[-1]) != n:
        raise ValueError("plan_sorted_coarse_windows: counts must sum to n")
    starts = np.arange(ntiles, dtype=np.int64) * rows
    ends = np.minimum(starts + rows, n) - 1
    min_id = np.searchsorted(cum, starts, side="right")  # id of sorted row r: first cum > r
    max_id = np.searchsorted(cum, np.maximum(ends, starts), side="right")
    pad_tiles = starts >= n  # all-padding tail tiles: any base will do
    min_id = np.where(pad_tiles, 0, min_id)
    max_id = np.where(pad_tiles, 0, max_id)
    base = (min_id // 256).astype(np.int32)
    if np.any(max_id >= base.astype(np.int64) * 256 + 512):
        return None
    return base


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


_REPAIR_CHUNK = 1024  # flagged pairs scored per call (≈ 0.8 GB at block 1024, M = 48)


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
    ``max_repairs`` flagged pairs, the exact fallback.

    ``crs_tpu`` rescans a fixed ``max_repairs`` pairs (the flagged ones by
    margin, then masked padding) and offers every query every pair's slot.
    Here only the flagged pairs are scored, ``_REPAIR_CHUNK`` at a time, and
    each query's repaired entries follow its pool in the same margin order.
    The top-k is the same: an entry above -1e30 keeps its place relative to
    every other, and a -1e30 fill comes from the pool's own dropped entries
    while ``nblocks·kb ≥ k``. Below that every pair is flagged and the
    shared layout is kept, so even the fill ids are ``crs_tpu``'s."""
    kth = top_s[:, -1]
    susp = ceilings >= kth[:, None]  # [B, nblocks]
    n_susp = int(susp.sum())
    if n_susp == 0:
        return top_s, top_i
    if n_susp > min(max_repairs, b_real * nblocks):
        STATS.fallbacks += 1
        return fallback()
    STATS.repairs += 1
    STATS.repaired_pairs += n_susp
    dev = pool_s.device
    margin = torch.where(susp, ceilings - kth[:, None], -math.inf)
    _, pos = topk_stable(margin.reshape(-1), n_susp)  # the flagged pairs, largest margin first
    qidx = pos // nblocks
    bid = pos % nblocks
    kk = min(k, block_size)
    rep_s, rep_loc = [], []
    for c0 in range(0, n_susp, _REPAIR_CHUNK):
        s, loc = topk_stable(score_blocks_fn(qidx[c0:c0 + _REPAIR_CHUNK],
                                             bid[c0:c0 + _REPAIR_CHUNK]), kk)
        rep_s.append(s)
        rep_loc.append(loc)
    rep_s = torch.cat(rep_s)
    rep_i = bid[:, None] * block_size + torch.cat(rep_loc)
    entry_block = torch.arange(nblocks * kb, device=dev) // kb
    flat_s = torch.where(susp[:, entry_block], NEG_INF, pool_s)
    if nblocks * kb >= k:  # each query's pairs in its own rows, in margin order
        order = torch.argsort(qidx, stable=True)
        q_sorted = qidx[order]
        per_q = torch.bincount(qidx, minlength=b_real)
        slot = torch.arange(n_susp, device=dev) - (torch.cumsum(per_q, 0) - per_q)[q_sorted]
        width = int(per_q.max())
        add_s = torch.full((b_real, width, kk), NEG_INF, device=dev)
        add_i = torch.zeros((b_real, width, kk), dtype=torch.int64, device=dev)
        add_s[q_sorted, slot] = rep_s[order]
        add_i[q_sorted, slot] = rep_i[order]
    else:  # crs_tpu's layout: every query sees every pair's slot
        qmask = qidx[None, :] == torch.arange(b_real, device=dev)[:, None]  # [B, R]
        add_s = torch.where(qmask[:, :, None], rep_s[None], NEG_INF)
        add_i = rep_i[None].expand(b_real, n_susp, kk)
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
    block_size: int = 4096,
    kb: int = 0,
    row_mask: Optional[torch.Tensor] = None,  # [N] bool — metadata `where` filter
    repair: int = 256,
) -> KernelOut:
    """Int8 scan top-k (``pallas_topk_int8``) with ``int8_topk``'s
    quantized-score semantics, exact for any kb (ceilings + targeted repair
    + fallback). Rows are padded to whole blocks only (a store's already
    are: no copy); kernel 1 takes any block_size. Returns (scores [B, k]
    f32, ids [B, k] int64)."""
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
    d_multiple = _FLOAT_D_MULTIPLE.get(vectors.dtype, 1)
    q = _pad_cols(_pad_rows(queries.to(vectors.dtype), FLOAT_QUERY_TILE), d_multiple).contiguous()
    group = _auto_group(-(-n // block_size), block_size * d * vectors.element_size())
    vecs = _pad_cols(_pad_rows(vectors, group * block_size), d_multiple).contiguous()
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
    coarse_p = _pad_rows(coarse_lut, ADC_QUERY_TILE)
    lut_bf, hi, lo = adc_tables(_pad_rows(lut, ADC_QUERY_TILE), coarse_p)
    return _scan_driver(lambda: block_topk_adc(lut_bf, codes_p, bias, kb, block_size, hi, lo),
                        _residual_score_blocks(codes_p, coarse_p, lut_bf, bias, block_size),
                        _residual_fallback(coarse_lut, lut, codes_ext, k, valid_n, row_mask),
                        b_real=b_real, k=k, kb=kb, block_size=block_size, nblocks=nblocks,
                        repair=repair)


def _residual_fallback(coarse_lut, lut, codes_ext, k, valid_n, row_mask):
    """The residual ADC scans' exact route: the all-f32 ADC top-k."""
    from .pq import _residual_adc_topk_luts

    def fallback():
        cid = codes_ext[:, 0].long() * 256 + codes_ext[:, 1].long()
        return _residual_adc_topk_luts(coarse_lut, lut, cid, codes_ext[:, 2:], k, valid_n,
                                       row_mask=row_mask)

    return fallback


def _residual_score_blocks(codes_p, coarse_p, lut_bf, bias, block_size: int):
    """The residual ADC scans' repair scores of flagged blocks (the gather
    does not care about the layout): the coarse term in full f32 (as the
    JAX repair scores it, not hi+lo), residual terms in bf16."""

    m_sub, kc = lut_bf.shape[1], lut_bf.shape[2]
    offsets = torch.arange(m_sub, device=codes_p.device) * kc

    def score_blocks(qidx, bid):
        rows = _block_rows(bid, block_size)
        cb = codes_p[rows]  # [R, BS, M+2] uint8
        r, bs = rows.shape
        cid = cb[:, :, 0].long() * 256 + cb[:, :, 1].long()
        s = torch.gather(coarse_p[qidx], 1, cid)
        # every subspace's looked-up term in one gather, then summed in order
        idx = (cb[:, :, 2:].long() + offsets).reshape(r, bs * m_sub)
        terms = torch.gather(lut_bf[qidx].reshape(r, m_sub * kc), 1, idx)
        terms = terms.reshape(r, bs, m_sub).float()
        for mi in range(m_sub):
            s = s + terms[:, :, mi]
        return s + bias[rows]

    return score_blocks


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


def scan_topk_residual_pq_adc_sorted_luts(
    coarse_lut: torch.Tensor,  # [B, C] f32: (qR)·coarse
    lut: torch.Tensor,  # [B, M, K] f32
    codes_ext: torch.Tensor,  # [N, M+2] uint8, rows SORTED by coarse id
    wbase,  # [ntiles] int32 from plan_sorted_coarse_windows
    k: int,
    valid_n: Union[int, torch.Tensor],
    block_size: int = 2048,
    row_mask: Optional[torch.Tensor] = None,  # [N] bool, in sorted row order
    repair: int = 256,
    group: int = 1,
    layout_budget: bool = False,
) -> KernelOut:
    """:func:`scan_topk_residual_pq_adc_sorted` from its LUTs."""
    if group < 1:
        raise ValueError("the sorted scan needs the plan's explicit group (≥ 1)")
    b_real = lut.shape[0]
    dev = codes_ext.device
    codes_p = _pad_rows(codes_ext, group * block_size).contiguous()
    np_rows = codes_p.shape[0]
    nblocks = np_rows // block_size
    ntiles = nblocks // group
    wbase = (wbase if isinstance(wbase, torch.Tensor)
             else torch.from_numpy(np.asarray(wbase))).to(device=dev, dtype=torch.int32)
    if wbase.shape != (ntiles,):
        raise ValueError(f"wbase plan has {wbase.shape[0]} tiles, the geometry needs {ntiles}: "
                         "recompute plan_sorted_coarse_windows with this block_size and group")
    kb = _pick_kb(k, nblocks, b_real, repair)
    budget = b_real * max(1, k // kb) if layout_budget and repair else repair
    bias = _bias_row(np_rows, valid_n, row_mask, dev)
    lut_p = _pad_rows(lut, ADC_QUERY_TILE)
    coarse_p = _pad_rows(coarse_lut, ADC_QUERY_TILE)
    # 256 zero id columns: the window [256·w, 256·w + 512) never leaves the table
    coarse_w = torch.nn.functional.pad(coarse_p, (0, 256))
    lut_bf, hi, lo = adc_tables(lut_p, coarse_w)
    return _scan_driver(
        lambda: block_topk_adc_sorted(lut_bf, codes_p, bias, kb, block_size, hi, lo, wbase,
                                      group),
        _residual_score_blocks(codes_p, coarse_p, lut_bf, bias, block_size),
        _residual_fallback(coarse_lut, lut, codes_ext, k, valid_n, row_mask),
        b_real=b_real, k=k, kb=kb, block_size=block_size, nblocks=nblocks, repair=budget)


def scan_topk_residual_pq_adc_sorted(
    rotation: torch.Tensor,  # [D, D] f32 (OPQ)
    coarse: torch.Tensor,  # [C, D] f32 coarse centroids (rotated space)
    centroids: torch.Tensor,  # [M, K, Dsub] f32 residual codebooks
    codes_ext: torch.Tensor,  # [N, M+2] uint8, rows SORTED by coarse id
    wbase,  # [ntiles] int32 from plan_sorted_coarse_windows
    queries: torch.Tensor,  # [B, D] f32
    k: int,
    valid_n: Union[int, torch.Tensor],
    block_size: int = 2048,
    row_mask: Optional[torch.Tensor] = None,
    repair: int = 256,
    group: int = 1,
    layout_budget: bool = False,
) -> KernelOut:
    """Fused residual-PQ ADC scan over a coarse-id-sorted corpus
    (``pallas_topk_residual_pq_adc_sorted``): the scores of
    :func:`scan_topk_residual_pq_adc`, exact through the same ceilings,
    repair and fallback. Ids are positions in the SORTED rows: map them back
    through ``perm`` of :func:`crs_tpu_torch.ops.pq.sort_codes_by_coarse`.
    Callers take ``group = adc_auto_group(n, B, block_size, M+2)`` and
    ``wbase = plan_sorted_coarse_windows(counts, n, block_size, group)``; a
    None plan means: use the unsorted scan.

    ``repair`` sets ``kb`` and, by default, the repair budget, as in
    ``crs_tpu``. That budget assumes a query's top-k spread over the blocks
    as in insertion order. Sorting puts a query's neighbours, which share
    coarse ids, into a few consecutive blocks, so many of its pairs emit kb
    winners and flag; past 256 pairs the exact fallback rescores the whole
    corpus. ``layout_budget`` sizes the budget to the layout's worst case
    instead: a flagged block holds kb of the query's top k, so a query flags
    at most ``k // kb`` blocks and ``B·(k // kb)`` pairs cover the batch.
    The fallback then runs only on ties at the k-th score or fewer than k
    live rows. Both routes return the exact top-k of their scores (repaired
    blocks score the coarse term in f32, the fallback every term)."""
    from .pq import residual_adc_luts

    if coarse.shape[0] % 256:
        raise ValueError("the coarse cluster count must be a multiple of 256")
    coarse_lut, lut = residual_adc_luts(rotation, coarse, centroids, queries)
    return scan_topk_residual_pq_adc_sorted_luts(coarse_lut, lut, codes_ext, wbase, k, valid_n,
                                                 block_size, row_mask, repair, group,
                                                 layout_budget)


def scan_topk_segmax(
    vectors: torch.Tensor,  # [N, D] f32 or bf16
    queries: torch.Tensor,  # [B, D]
    k: int,
    valid_n: Union[int, torch.Tensor],
    block_size: int = 2048,
) -> KernelOut:
    """Approximate fused scan (``pallas_topk_segmax``): queries cast to the
    corpus dtype, one winner per 128-row segment and the top min(k,
    block_size/128) segments per block, merged by :func:`_finalize`. Scores
    are exact element scores; a row is missed when it shares its segment
    with a better one (shuffle the rows to make that rare). No ceilings,
    repair or fallback. Returns (scores [B, k] f32, ids [B, k] int64)."""
    b_real = queries.shape[0]
    kseg = min(k, block_size // SEGMENT_ROWS)
    # bf16: D zero-padded to TMA's multiple of 8, as scan_topk pads it
    d_multiple = _FLOAT_D_MULTIPLE.get(vectors.dtype, 1)
    q = _pad_cols(_pad_rows(queries.to(vectors.dtype), SEGMAX_QUERY_TILE), d_multiple).contiguous()
    vecs = _pad_cols(_pad_rows(vectors, block_size), d_multiple).contiguous()
    out_s, out_i = block_topk_segmax(q, vecs, valid_n, kseg, block_size)
    return _finalize(out_s, out_i, b_real, k)


def scan_topk_segmax_int8(
    codes: torch.Tensor,  # [N, D] int8
    scales: torch.Tensor,  # [N] f32
    queries: torch.Tensor,  # [B, D] f32 (quantized here)
    k: int,
    valid_n: Union[int, torch.Tensor],
    block_size: int = 2048,
) -> KernelOut:
    """Segment-max variant of the int8 scan (``pallas_topk_segmax_int8``):
    s = (f32(q·c) · q_scale) · row_scale with ``scalar_quantize``'s query
    codes, then the segment-max selection and :func:`_finalize`."""
    b_real = queries.shape[0]
    kseg = min(k, block_size // SEGMENT_ROWS)
    q_codes, q_scales = scalar_quantize(queries)
    q_codes = _pad_rows(q_codes, SEGMAX_QUERY_TILE).contiguous()
    qs = _pad_rows(q_scales.float(), SEGMAX_QUERY_TILE).contiguous()
    vecs = _pad_rows(codes, block_size).contiguous()
    vs = _pad_rows(scales.float(), block_size).contiguous()
    out_s, out_i = block_topk_segmax_int8(q_codes, qs, vecs, vs, valid_n, kseg, block_size)
    return _finalize(out_s, out_i, b_real, k)
