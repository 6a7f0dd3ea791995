"""int4 and NF4 weight-only matmuls for decode-sized row counts (port of
``crs_tpu.ops.qgemm``).

The weight is packed two nibbles per byte along K: packed row ``i`` holds
weight row ``2i`` in its low nibble and row ``2i+1`` in its high nibble —
sign-extended int4 for :func:`q4_matmul`, unsigned indices into
:data:`NF4_LEVELS` for :func:`nf4_matmul` — with f32 group scales
``[K/group, N]``. Both compute, in f32 accumulation,

    out = bf16(x) · bf16(bf16(level) · bf16(scale))

which is the Pallas kernels' arithmetic (``_q4_kernel`` / ``_nf4_kernel``):
every product of two bf16 values is exact in f32, so kernel and plain
version differ only in the order of the f32 sums.

:func:`q4_matmul` and :func:`nf4_matmul` are the wrappers of one CUDA
kernel, the tensor-core ``q4_mma_kernel`` of ``csrc/q4_matmul.cu``, with
its planner :func:`nf4_plan` and a dequant table per kind
(:func:`int4_byte_table`, :func:`nf4_byte_table`); it takes groups of any
even number of rows. On a CUDA tensor they launch the kernel or raise; on a
CPU tensor they run :func:`emulate_q4_matmul` / :func:`emulate_nf4_matmul`,
the plain torch versions beside them (literal mirrors of ``crs_tpu``'s
emulations). ``qmatmul`` takes them when :func:`q4_pallas_supported` says
so, exactly where ``crs_tpu`` takes its Pallas kernels.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from .launch import ARG_INT, ARG_PTR, KernelStats, check_operands, launch, load_library, \
    sm_count, stream_handle

__all__ = [
    "NF4_LEVELS", "STATS", "q4_pallas_supported", "q4_matmul", "nf4_matmul",
    "emulate_q4_matmul", "emulate_nf4_matmul", "Nf4Plan", "nf4_plan", "int4_byte_table",
    "nf4_byte_table", "NF4_MAX_SPLIT", "NF4_BLOCKS_PER_SM", "NF4_WIDE_N",
]

# bitsandbytes' NF4 codebook: the 16 quantile-optimal levels of a standard
# normal, normalized to [-1, 1] (the QLoRA paper's table)
NF4_LEVELS = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
], dtype=np.float32)

STATS = KernelStats()

_SOURCE = "q4_matmul.cu"
_LAUNCHER = "q4_mma_launch"
_N_MULTIPLE = 128  # the wrappers' gate on N (crs_tpu's tiling rule)
MAX_ROWS = 64  # decode-sized row counts: qmatmul's gate
# q4_mma_kernel: packed rows per k16 step, and the most K slices (one
# thread-block cluster of the portable size adds them)
NF4_STEP_ROWS = 8
NF4_MAX_SPLIT = 8
# the grid the planner aims at: a sweep of widths and K splits over the 1b
# decode step's shapes at R = 8 on the H100 (chip_smoke.py kernel_q4,
# "plan_sweep") ran fastest near 3/4 of a block per SM, one wave with room
NF4_BLOCKS_PER_SM = 0.75
# from this N up, R > 32 puts the block's warps side by side along N (at
# R = 64 on the H100: lm_head 2048 → 32000 and 4096 → 14336 ran faster so,
# 2048 → 5632 and 14336 → 4096 slower; chip_smoke.py kernel_q4)
NF4_WIDE_N = 8192
_tables: Dict[tuple, torch.Tensor] = {}


def _tile_config(k2: int, n: int, g: int):
    """``crs_tpu``'s tiling rule, kept as the routing gate: (groups per
    K-step, N tile), or None when the shapes do not map to its tiles."""
    if k2 <= 0 or n % 128 != 0 or k2 % g != 0:
        return None
    gs2 = k2 // g
    gpt = 0
    for cand in range(g, 0, -1):
        if g % cand == 0 and cand * gs2 <= 512 and (cand * gs2) % 128 == 0:
            gpt = cand
            break
    if gpt == 0:
        return None
    nt = 512 if n % 512 == 0 else (256 if n % 256 == 0 else 128)
    return gpt, nt


def q4_pallas_supported(rows: int, k2: int, n: int, g: int, max_rows: int = MAX_ROWS) -> bool:
    """True where ``crs_tpu`` takes its Pallas kernel, so where the port
    takes its CUDA kernel: decode-sized row counts and tileable shapes."""
    return rows <= max_rows and _tile_config(k2, n, g) is not None


# -- plain versions ---------------------------------------------------------------

def _unpack_int4(codes: torch.Tensor) -> torch.Tensor:
    """[K/2, N] packed int8 → [K, N] int32 in [-8, 7]: low nibble row 2i,
    high nibble row 2i+1, both sign-extended."""
    p = codes.to(torch.int32)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(p, 28), 28)
    hi = torch.bitwise_right_shift(p, 4)
    return torch.stack([lo, hi], dim=1).reshape(2 * codes.shape[0], codes.shape[1])


def _unpack_nf4(codes: torch.Tensor) -> torch.Tensor:
    """[K/2, N] packed uint8 → [K, N] f32 NF4 levels (unsigned nibbles)."""
    p = codes.to(torch.int32)
    lut = torch.from_numpy(NF4_LEVELS).to(codes.device)
    lo, hi = lut[p & 0xF], lut[torch.bitwise_right_shift(p, 4) & 0xF]
    return torch.stack([lo, hi], dim=1).reshape(2 * codes.shape[0], codes.shape[1])


def _emulate(vals: torch.Tensor, x2: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    if x2.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain q4/NF4 product needs torch.backends.cuda.matmul."
                           "allow_tf32 = False")
    gs = vals.shape[0] // scales.shape[0]
    scale_rows = torch.repeat_interleave(scales, gs, dim=0)  # [K, N]
    w = vals.to(torch.bfloat16) * scale_rows.to(torch.bfloat16)  # bf16 product, rounded
    return x2.to(torch.bfloat16).float() @ w.float()


def emulate_q4_matmul(x2: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The int4 kernel's arithmetic in plain torch: bf16 activations, group
    scales folded into bf16 weights, f32 accumulation → [R, N] f32."""
    return _emulate(_unpack_int4(codes), x2, scales)


def emulate_nf4_matmul(x2: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The NF4 kernel's arithmetic in plain torch (levels through the LUT,
    then as :func:`emulate_q4_matmul`) → [R, N] f32."""
    return _emulate(_unpack_nf4(codes), x2, scales)


# -- the kernels' wrappers ----------------------------------------------------------

class Nf4Plan(NamedTuple):
    """How ``q4_mma_kernel`` covers an [R, K] × [K/2, N] product (int4 or
    NF4): ``n_tiles`` tiles of 8 rows of x, ``width`` bytes of a packed row
    per thread (so 8·width columns per warp), ``warps_n`` of a block's 8
    warps side by side along N (the others along K), and K cut into
    ``ksplit`` slices of ``slice_rows`` packed rows (whole groups that are
    also whole 8-row k steps; the last may be shorter), the blocks of a
    column slab's slices forming one cluster."""
    n_tiles: int
    width: int
    ksplit: int
    slice_rows: int
    warps_n: int = 1

    @property
    def block_cols(self) -> int:
        return 8 * self.width * self.warps_n

    def blocks(self, n: int) -> int:
        return n // self.block_cols * self.ksplit


@functools.lru_cache(maxsize=None)
def nf4_plan(rows: int, k2: int, n: int, gs2: int, sm_count: int) -> Nf4Plan:
    """The grid of ``q4_mma_kernel`` (both kinds): 8·n_tiles ≥ R rows in one weight pass
    (the launcher derives n_tiles from R the same way), width 16 or 8 bytes
    for n_tiles ≤ 2 and 8 / 4 beyond, so the f32 sums stay in 64 registers;
    for 8 n-tiles at N ≥ :data:`NF4_WIDE_N` the block's 8 warps lie along N,
    so they share x's 64 rows and the table (each of the N/32 narrow blocks
    would read all of x from L2); then K slices (at most
    :data:`NF4_MAX_SPLIT`) of whole units of lcm(gs2, 8) packed rows — whole
    groups and whole k steps — so the grid comes as near as it can to
    :data:`NF4_BLOCKS_PER_SM` blocks per SM. The width that comes nearer
    wins, the wider on a tie."""
    n_tiles = 1 << max(0, (-(-rows // 8) - 1).bit_length())
    unit = math.lcm(gs2, NF4_STEP_ROWS)
    groups = k2 // unit
    target = NF4_BLOCKS_PER_SM * sm_count
    best = None
    for width in ((16, 8) if n_tiles <= 2 else (32 // n_tiles,)):
        warps_n = 8 if n_tiles == 8 and n >= NF4_WIDE_N and n % (64 * width) == 0 else 1
        slabs = n // (8 * width * warps_n)
        if slabs == 0:
            continue
        ksplit = max(1, min(round(target / slabs), NF4_MAX_SPLIT, groups))
        per = -(-groups // ksplit)  # units per slice
        plan = Nf4Plan(n_tiles, width, -(-groups // per), per * unit, warps_n)
        if best is None or abs(plan.blocks(n) - target) < abs(best.blocks(n) - target):
            best = plan
    return best


def _pair_table(levels: np.ndarray) -> np.ndarray:
    """For each byte value, the bf16 pair (level of the low nibble, level of
    the high nibble) as one uint32 word (low nibble in the low half: weight
    rows 2i, 2i+1); ``levels`` [16] by nibble value."""
    bits = torch.from_numpy(levels.astype(np.float32)).to(torch.bfloat16).view(torch.int16).numpy()
    half = bits.astype(np.uint16).astype(np.uint32)
    byte = np.arange(256)
    return (half[byte & 15] | (half[byte >> 4] << 16)).astype(np.uint32)


def nf4_byte_table() -> np.ndarray:
    """``q4_mma_kernel``'s dequant table for NF4: the unsigned nibbles'
    :data:`NF4_LEVELS`, a pair per byte."""
    return _pair_table(NF4_LEVELS)


def int4_byte_table() -> np.ndarray:
    """``q4_mma_kernel``'s dequant table for int4: each nibble sign-extended
    (0..7 → 0..7, 8..15 → -8..-1; exact in bf16), a pair per byte."""
    nib = np.arange(16)
    return _pair_table(np.where(nib < 8, nib, nib - 16))


def _lane_table(dev: torch.device, kind: str) -> torch.Tensor:
    """The ``kind`` ("int4" / "nf4") byte table with each entry repeated for
    the 32 lanes, as the kernel copies it into shared memory (entry e, lane
    l at 32·e + l)."""
    key = (dev, kind)
    if key not in _tables:
        table = int4_byte_table() if kind == "int4" else nf4_byte_table()
        _tables[key] = torch.from_numpy(np.repeat(table, 32).view(np.int32)).to(dev)
    return _tables[key]


def _load():
    return load_library(_SOURCE, {_LAUNCHER: [ARG_PTR] * 5 + [ARG_INT] * 8 + [ARG_PTR]})


def _check_shapes(x2: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor):
    """(R, K/2, N, packed rows per group) of a product the kernels take."""
    if x2.dim() != 2 or codes.dim() != 2 or scales.dim() != 2:
        raise ValueError("x2 [R, K], codes [K/2, N] and scales [G, N] must be 2-D")
    r, k = x2.shape
    k2, n = codes.shape
    g = scales.shape[0]
    if k != 2 * k2 or scales.shape[1] != n or g < 1 or k2 % g:
        raise ValueError(f"shapes do not match: x2 {tuple(x2.shape)}, codes {tuple(codes.shape)}, "
                         f"scales {tuple(scales.shape)}")
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"the kernel takes 1..{MAX_ROWS} rows, got {r}")
    if n % _N_MULTIPLE:
        raise ValueError(f"N must be a multiple of {_N_MULTIPLE}, got {n}")
    if k2 % NF4_STEP_ROWS:
        raise ValueError(f"K/2 must be a multiple of {NF4_STEP_ROWS}, got {k2}")
    return r, k2, n, k2 // g


_KINDS = {"int4": ("q4_matmul", torch.int8), "nf4": ("nf4_matmul", torch.uint8)}


def _forward(kind: str, x2: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
             plan: Nf4Plan = None) -> torch.Tensor:
    """Launch ``q4_mma_kernel`` with ``kind``'s table, counted under its
    wrapper's name; ``plan`` overrides :func:`nf4_plan` (the smoke's sweep)."""
    dev = codes.device
    name, code_dtype = _KINDS[kind]
    r, k2, n, gs2 = _check_shapes(x2, codes, scales)
    xb = x2.to(torch.bfloat16)
    check_operands(dev, ("x2", xb, torch.bfloat16), ("codes", codes, code_dtype),
                   ("scales", scales, torch.float32))
    if plan is None:
        plan = nf4_plan(r, k2, n, gs2, sm_count(dev))
    out = torch.empty((r, n), dtype=torch.float32, device=dev)
    launch(STATS, name, getattr(_load(), _LAUNCHER),
           xb.data_ptr(), codes.data_ptr(), scales.data_ptr(), _lane_table(dev, kind).data_ptr(),
           out.data_ptr(), r, k2, n, gs2, plan.ksplit, plan.slice_rows, plan.width,
           plan.warps_n, stream_handle(dev))
    return out


def q4_matmul(x2: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``x2`` [R, K] @ int4-packed weight (``codes`` [K/2, N] int8,
    ``scales`` [K/group, N] f32) → [R, N] f32. CPU tensors take
    :func:`emulate_q4_matmul`; CUDA tensors launch ``q4_mma_kernel`` with the
    int4 table or raise."""
    if codes.device.type == "cpu":
        return emulate_q4_matmul(x2, codes, scales)
    return _forward("int4", x2, codes, scales)


def nf4_matmul(x2: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``x2`` [R, K] @ NF4-packed weight (``codes`` [K/2, N] uint8,
    ``scales`` [K/group, N] f32 absmax) → [R, N] f32. CPU tensors take
    :func:`emulate_nf4_matmul`; CUDA tensors launch ``q4_mma_kernel`` with the
    NF4 table or raise."""
    if codes.device.type == "cpu":
        return emulate_nf4_matmul(x2, codes, scales)
    return _forward("nf4", x2, codes, scales)
