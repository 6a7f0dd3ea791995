"""The decode weight-streaming probes: the three kernels of the GEMV-streaming
tools (``crs_tpu_torch.tools.bench_q4_kernel`` and ``.bench_chain_gemv``,
ports of ``tools/bench_q4_kernel.py`` and ``tools/bench_chain_gemv.py``).

- :func:`q4_probe_matmul` (``q4_probe_kernel``): the int4 matmul variants of
  ``bench_q4_kernel.py``'s ``_q4_kernel_var``, per-group int32 products
  ("i32", "i16", "none") or scales folded into bf16 weights (``fold``);
- :func:`q8_gemv` (``q8_gemv_kernel``): ``bench_chain_gemv.py``'s ``q8mm``
  / ``k8``, a W8A16 GEMV over K tiles of 512 rows;
- :func:`db_gemv` (``db_gemv_kernel``): its ``dbmm`` / ``kdb``, a W8A16 GEMV
  against a row-major [N, K] weight; the weight and x arrive as TMA boxes
  and the products run on the tensor cores, weight as A and x as B.

Each wrapper runs its plain torch version (``emulate_*`` beside it) on a
CPU tensor; on a CUDA tensor it launches its kernel from
``csrc/gemv_probe.cu`` or raises. They never synchronize the host, so the
tools can capture them in CUDA graphs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .launch import ARG_FLOAT, ARG_INT, ARG_PTR, KernelStats, check_operands, launch, \
    load_library, stream_handle

__all__ = [
    "STATS", "KT2_CAP", "UNPACKS", "probe_tiles", "fold_weights", "q4_probe_matmul",
    "emulate_q4_probe_matmul", "q8_gemv", "emulate_q8_gemv", "db_gemv",
    "emulate_db_gemv", "Q8_TILE",
]

STATS = KernelStats()

_SOURCE = "gemv_probe.cu"
KT2_CAP = 512  # bench_q4_kernel.py build_variant's kt2_cap: packed rows a K-step at most
UNPACKS = ("i32", "i16", "none")  # "i32" and "i16" give the same nibbles
Q8_TILE = 512  # k8's K tile
_Q8_MAX_ROWS = 16
_DB_CHUNK, _DB_MAX_ROWS = 512, 8


def _load():
    return load_library(_SOURCE, {
        "q4_probe_launch": [ARG_PTR] * 6 + [ARG_INT] * 7 + [ARG_PTR],
        "q8_gemv_launch": [ARG_PTR] * 4 + [ARG_INT] * 3 + [ARG_PTR],
        "db_gemv_launch": [ARG_PTR] * 3 + [ARG_INT] * 3 + [ARG_FLOAT, ARG_PTR],
    })


def _fail_unless(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


# -- row 12: the int4 matmul variants ------------------------------------------------

def probe_tiles(k2: int, g: int) -> Tuple[int, int]:
    """(gs2, gpt): packed rows a group, and build_variant's groups per
    K-step — the largest divisor of g whose gpt·gs2 ≤ :data:`KT2_CAP` is a
    multiple of 128, else 1."""
    _fail_unless(g >= 1 and k2 % g == 0, f"K/2 = {k2} must split into g = {g} groups")
    gs2 = k2 // g
    for cand in range(g, 0, -1):
        if g % cand == 0 and cand * gs2 <= KT2_CAP and (cand * gs2) % 128 == 0:
            return gs2, cand
    return gs2, 1


def _nibbles(codes: torch.Tensor, unpack: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) int32 [K/2, N]: sign-extended nibbles, or the raw byte twice
    ("none", a speed probe with the wrong numerics)."""
    p = codes.to(torch.int32)
    if unpack == "none":
        return p, p
    return torch.bitwise_right_shift(torch.bitwise_left_shift(p, 28), 28), \
        torch.bitwise_right_shift(p, 4)


def fold_weights(codes: torch.Tensor, scales: torch.Tensor, unpack: str):
    """The fold variants' bf16 weights (lo, hi) [K/2, N]: bf16(nibble ·
    bf16(scale)), packed row j of K-step s scaled by scales[s·gpt + (j mod
    gpt)] — ``pltpu.repeat`` tiles the step's gpt scale rows."""
    k2 = codes.shape[0]
    gs2, gpt = probe_tiles(k2, scales.shape[0])
    j = torch.arange(k2, device=codes.device)
    kt2 = gpt * gs2
    rep = scales[(j // kt2) * gpt + (j % kt2) % gpt].to(torch.bfloat16)
    lo, hi = _nibbles(codes, unpack)
    return lo.to(torch.bfloat16) * rep, hi.to(torch.bfloat16) * rep


def _check_probe(xe, xo, xs, codes, scales, unpack: str, fold: bool):
    _fail_unless(unpack in UNPACKS, f"unpack must be one of {UNPACKS}, got {unpack!r}")
    _fail_unless(xe.dim() == 2 and xe.shape == xo.shape, "xe and xo must be [rt, K/2]")
    rt, k2 = xe.shape
    _fail_unless(codes.dim() == 2 and codes.shape[0] == k2, f"codes must be [{k2}, N]")
    n = codes.shape[1]
    _fail_unless(scales.dim() == 2 and scales.shape[1] == n, f"scales must be [g, {n}]")
    _fail_unless(xs.shape == (rt, 1), f"xs must be [{rt}, 1]")
    _fail_unless(xe.dtype == (torch.bfloat16 if fold else torch.int8),
                 f"xe and xo must be {'bf16' if fold else 'int8'} for fold={fold}")
    gs2, gpt = probe_tiles(k2, scales.shape[0])
    _fail_unless(rt % 32 == 0, f"rt must be a multiple of 32, got {rt}")
    _fail_unless(n % 4 == 0 and gs2 % 4 == 0,
                 f"N ({n}) and the group's packed rows ({gs2}) must be multiples of 4")
    return rt, k2, n, gs2, gpt


def emulate_q4_probe_matmul(xe, xo, xs, codes, scales, unpack: str = "i32",
                            fold: bool = False) -> torch.Tensor:
    """``_q4_kernel_var``'s arithmetic in plain torch → [rt, N] f32. Unfolded:
    per group the exact int32 sum Σ xe·lo + xo·hi, × its scale in f32, added
    in group order; fold: bf16 x against :func:`fold_weights`, f32 sums. Each
    K-step's sum × xs, added in step order."""
    rt, k2, n, gs2, gpt = _check_probe(xe, xo, xs, codes, scales, unpack, fold)
    if xe.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain probe needs torch.backends.cuda.matmul.allow_tf32 = False")
    kt2 = gpt * gs2
    out = torch.zeros((rt, n), dtype=torch.float32, device=codes.device)
    if fold:
        wlo, whi = fold_weights(codes, scales, unpack)
        for s in range(k2 // kt2):
            ks = slice(s * kt2, (s + 1) * kt2)
            acc = xe[:, ks].float() @ wlo[ks].float() + xo[:, ks].float() @ whi[ks].float()
            out = out + acc * xs
        return out
    lo, hi = _nibbles(codes, unpack)
    for s in range(k2 // kt2):
        acc = torch.zeros((rt, n), dtype=torch.float32, device=codes.device)
        for grp in range(gpt):
            gamma = s * gpt + grp
            rows = slice(gamma * gs2, (gamma + 1) * gs2)
            # every partial sum is an integer below 2^53: exact in float64
            ints = (xe[:, rows].double() @ lo[rows].double()
                    + xo[:, rows].double() @ hi[rows].double())
            acc = acc + ints.float() * scales[gamma][None, :]
        out = out + acc * xs
    return out


def q4_probe_matmul(xe: torch.Tensor, xo: torch.Tensor, xs: torch.Tensor, codes: torch.Tensor,
                    scales: torch.Tensor, unpack: str = "i32", fold: bool = False) -> torch.Tensor:
    """``bench_q4_kernel.py``'s matmul variant (``unpack`` one of
    :data:`UNPACKS`, ``fold``) → [rt, N] f32: xe, xo [rt, K/2] (int8, or
    bf16 with ``fold``), xs [rt, 1] f32, codes [K/2, N] int8, scales [g, N]
    f32. CPU tensors take :func:`emulate_q4_probe_matmul`; CUDA tensors
    launch ``q4_probe_kernel`` or raise."""
    if codes.device.type == "cpu":
        return emulate_q4_probe_matmul(xe, xo, xs, codes, scales, unpack, fold)
    rt, k2, n, gs2, gpt = _check_probe(xe, xo, xs, codes, scales, unpack, fold)
    dev = codes.device
    check_operands(dev, ("xe", xe, xe.dtype), ("xo", xo, xe.dtype), ("xs", xs, torch.float32),
                   ("codes", codes, torch.int8), ("scales", scales, torch.float32))
    out = torch.empty((rt, n), dtype=torch.float32, device=dev)
    launch(STATS, "q4_probe_matmul", _load().q4_probe_launch, xe.data_ptr(), xo.data_ptr(),
           xs.data_ptr(), codes.data_ptr(), scales.data_ptr(), out.data_ptr(), rt, k2, n, gs2, gpt,
           int(fold), int(unpack == "none"), stream_handle(dev))
    return out


# -- row 13: the W8A16 GEMV over K tiles ------------------------------------------------

def _check_q8(x, codes, scales):
    _fail_unless(x.dim() == 2 and codes.dim() == 2 and x.shape[1] == codes.shape[0],
                 f"x [R, K] and codes [K, N] do not match: {tuple(x.shape)}, {tuple(codes.shape)}")
    r, k = x.shape
    n = codes.shape[1]
    _fail_unless(scales.numel() == n, f"scales must hold {n} values")
    _fail_unless(1 <= r <= _Q8_MAX_ROWS, f"the GEMV takes 1..{_Q8_MAX_ROWS} rows, got {r}")
    _fail_unless(k % Q8_TILE == 0 and n % Q8_TILE == 0,
                 f"K ({k}) and N ({n}) must be multiples of {Q8_TILE}")
    return r, k, n


def emulate_q8_gemv(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``k8``'s arithmetic in plain torch → [R, N] f32: over K tiles of
    :data:`Q8_TILE` rows, bf16(x_tile) · bf16(codes_tile) with f32 sums, ×
    the scale, added tile by tile."""
    r, k, n = _check_q8(x, codes, scales)
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain GEMV needs torch.backends.cuda.matmul.allow_tf32 = False")
    xb = x.to(torch.bfloat16).float()
    s = scales.reshape(1, n).float()
    out = torch.zeros((r, n), dtype=torch.float32, device=codes.device)
    for t in range(0, k, Q8_TILE):
        out = out + (xb[:, t:t + Q8_TILE] @ codes[t:t + Q8_TILE].float()) * s
    return out


def q8_gemv(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``bench_chain_gemv.py``'s ``q8mm``: x [R, K] (any float dtype; bf16
    in the product, R ≤ 16) @ int8 codes [K, N] × f32 scales [1, N] → [R, N]
    f32. CPU tensors take :func:`emulate_q8_gemv`; CUDA tensors launch
    ``q8_gemv_kernel`` or raise."""
    if codes.device.type == "cpu":
        return emulate_q8_gemv(x, codes, scales)
    r, k, n = _check_q8(x, codes, scales)
    dev = codes.device
    xb = x.to(torch.bfloat16).contiguous()
    s = scales.reshape(n)
    check_operands(dev, ("x", xb, torch.bfloat16), ("codes", codes, torch.int8),
                   ("scales", s, torch.float32))
    out = torch.empty((r, n), dtype=torch.float32, device=dev)
    launch(STATS, "q8_gemv", _load().q8_gemv_launch, xb.data_ptr(), codes.data_ptr(), s.data_ptr(),
           out.data_ptr(), r, k, n, stream_handle(dev))
    return out


# -- row 14: the W8A16 GEMV against a row-major weight ----------------------------------

def _check_db(x, codes):
    _fail_unless(x.dim() == 2 and codes.dim() == 2 and x.shape[1] == codes.shape[1],
                 f"x [R, K] and codes [N, K] do not match: {tuple(x.shape)}, {tuple(codes.shape)}")
    r, k = x.shape
    n = codes.shape[0]
    _fail_unless(1 <= r <= _DB_MAX_ROWS, f"the GEMV takes 1..{_DB_MAX_ROWS} rows, got {r}")
    _fail_unless(k % _DB_CHUNK == 0 and n % _DB_CHUNK == 0,
                 f"K ({k}) and N ({n}) must be multiples of {_DB_CHUNK}")
    return r, k, n


def emulate_db_gemv(x: torch.Tensor, codes: torch.Tensor, scale: float) -> torch.Tensor:
    """``kdb``'s arithmetic in plain torch → [R, N] f32: bf16(x) ·
    bf16(codes)ᵀ with f32 sums, × ``scale`` (``dbmm``'s 1e-2/√d)."""
    _check_db(x, codes)
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain GEMV needs torch.backends.cuda.matmul.allow_tf32 = False")
    return (x.to(torch.bfloat16).float() @ codes.float().T) * scale


def db_gemv(x: torch.Tensor, codes: torch.Tensor, scale: float) -> torch.Tensor:
    """``bench_chain_gemv.py``'s ``dbmm``: x [R, K] (bf16 in the product, R
    ≤ 8) against int8 codes [N, K] (row-major weight, the product over its
    dim 1) × ``scale`` → [R, N] f32. CPU tensors take
    :func:`emulate_db_gemv`; CUDA tensors launch ``db_gemv_kernel`` or
    raise."""
    if codes.device.type == "cpu":
        return emulate_db_gemv(x, codes, scale)
    r, k, n = _check_db(x, codes)
    dev = codes.device
    xb = x.to(torch.bfloat16).contiguous()
    check_operands(dev, ("x", xb, torch.bfloat16), ("codes", codes, torch.int8))
    out = torch.empty((r, n), dtype=torch.float32, device=dev)
    launch(STATS, "db_gemv", _load().db_gemv_launch, xb.data_ptr(), codes.data_ptr(),
           out.data_ptr(), r, k, n, float(scale), stream_handle(dev))
    return out
