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

:func:`q4_matmul` and :func:`nf4_matmul` are the wrappers of the CUDA
kernels in ``csrc/q4_matmul.cu``. On a CUDA tensor they launch the kernel or
raise; on a CPU tensor they run :func:`emulate_q4_matmul` /
:func:`emulate_nf4_matmul`, the plain torch versions beside them (literal
mirrors of ``crs_tpu``'s emulations). ``qmatmul`` takes them when
:func:`q4_pallas_supported` says so, exactly where ``crs_tpu`` takes its
Pallas kernels.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .launch import ARG_INT, ARG_PTR, KernelStats, check_operands, launch, load_library, \
    stream_handle

__all__ = [
    "NF4_LEVELS", "STATS", "q4_pallas_supported", "q4_matmul", "nf4_matmul",
    "emulate_q4_matmul", "emulate_nf4_matmul", "q4_split_k",
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
_LAUNCHER = "q4_matmul_launch"
TILE_N = 128  # output columns per CUDA block (csrc/q4_matmul.cu)
MAX_ROWS = 64  # decode-sized row counts: qmatmul's gate
_TARGET_BLOCKS_PER_SM = 2
_sm_counts: Dict[int, int] = {}
_levels: Dict[torch.device, torch.Tensor] = {}


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

def q4_split_k(k2: int, n: int, rows: int, gs2: int, sm_count: int) -> int:
    """Split the K loop over this many CUDA blocks (each sums a K slice into
    its own partial, a second pass adds them in order) so a decode-sized
    product still fills the card: the smallest power of two that gives
    ``_TARGET_BLOCKS_PER_SM`` blocks per SM, while each slice keeps at least
    one group of packed rows and divides K/2 evenly."""
    rt = 8 if rows > 4 else max(1, 1 << (rows - 1).bit_length())
    blocks = (n // TILE_N) * -(-rows // rt)
    split = 1
    while (blocks * split < _TARGET_BLOCKS_PER_SM * sm_count
           and k2 % (2 * split) == 0 and k2 // (2 * split) >= max(gs2, 8)):
        split *= 2
    return split


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


def _nf4_levels(dev: torch.device) -> torch.Tensor:
    if dev not in _levels:
        _levels[dev] = torch.from_numpy(NF4_LEVELS).to(dev)
    return _levels[dev]


def _load():
    return load_library(_SOURCE, {_LAUNCHER: [ARG_PTR] * 6 + [ARG_INT] * 6 + [ARG_PTR]})


def _q4_forward(x2: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor, nf4: bool,
                kernel: str) -> torch.Tensor:
    dev = codes.device
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
    if n % TILE_N:
        raise ValueError(f"N must be a multiple of {TILE_N}, got {n}")
    gs2 = k2 // g
    if k2 % 8:
        raise ValueError(f"K/2 must be a multiple of 8, got {k2}")
    xb = x2.to(torch.bfloat16)
    check_operands(dev, ("x2", xb, torch.bfloat16),
                   ("codes", codes, torch.uint8 if nf4 else torch.int8),
                   ("scales", scales, torch.float32))
    split = q4_split_k(k2, n, r, gs2, _sm_count(dev))
    out = torch.empty((r, n), dtype=torch.float32, device=dev)
    partials = (torch.empty((split, r, n), dtype=torch.float32, device=dev)
                if split > 1 else out)
    levels = _nf4_levels(dev) if nf4 else out
    launch(STATS, kernel, getattr(_load(), _LAUNCHER),
           xb.data_ptr(), codes.data_ptr(), scales.data_ptr(), levels.data_ptr(),
           partials.data_ptr(), out.data_ptr(), r, k2, n, gs2, split, int(nf4),
           stream_handle(dev))
    return out


def q4_matmul(x2: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``x2`` [R, K] @ int4-packed weight (``codes`` [K/2, N] int8,
    ``scales`` [K/group, N] f32) → [R, N] f32. CPU tensors take
    :func:`emulate_q4_matmul`; CUDA tensors launch ``q4_matmul`` or raise."""
    if codes.device.type == "cpu":
        return emulate_q4_matmul(x2, codes, scales)
    return _q4_forward(x2, codes, scales, nf4=False, kernel="q4_matmul")


def nf4_matmul(x2: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``x2`` [R, K] @ NF4-packed weight (``codes`` [K/2, N] uint8,
    ``scales`` [K/group, N] f32 absmax) → [R, N] f32. CPU tensors take
    :func:`emulate_nf4_matmul`; CUDA tensors launch ``nf4_matmul`` or raise."""
    if codes.device.type == "cpu":
        return emulate_nf4_matmul(x2, codes, scales)
    return _q4_forward(x2, codes, scales, nf4=True, kernel="nf4_matmul")
