"""Decode attention over an int8 KV cache (port of
``crs_tpu.ops.decode_attention``).

One new token per (batch row, kv-head) attends over a sequence-major int8
cache ``[B, Hkv, S, hd]`` with one f32 scale per cached vector. The scales
factor out of both contractions:

    scores[g, s] = (bf16(q_g) · k_int_s) · k_scale_s / √hd + bias_s
    ctx[g, :]    = Σ_s bf16(softmax(scores)_g,s · v_scale_s) · v_int_s

with ``bias`` 0 for a valid slot and -1e30 for any other, a one-pass
softmax, f32 sums, and exact zeros for a batch row with no valid slot.

:func:`decode_attention_int8` is the wrapper of the CUDA kernel in
``csrc/decode_attention_int8.cu``: two launches over S cut into chunks by
:func:`split_plan` (``decode_attention_int8_scores_kernel``, then
``decode_attention_int8_pv_kernel``), for every shape ``crs_tpu``'s gate
sends to its kernel: any hd a multiple of 128 (past 512 the kernel reads
a row in 512-byte segments), any number of query heads per kv-head (padded
with zero heads to a built count), any S a multiple of 128. On a CUDA
tensor it launches them or raises; on a CPU tensor it runs
:func:`emulate_decode_attention_int8`, the plain torch version beside it (a
literal mirror of ``crs_tpu``'s emulation). There is no ``mesh`` argument: multi-device serving is not
ported yet.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from .launch import ARG_FLOAT, ARG_INT, ARG_PTR, KernelStats, check_operands, launch, \
    load_library, refuse_gradients, scratch, sm_count, stream_handle

__all__ = [
    "STATS", "quantize_kv_rows", "decode_attention_supported", "decode_attention_int8",
    "emulate_decode_attention_int8", "split_plan", "launch_groups", "KERNEL_GROUPS",
    "ROWS_PER_STEP", "MAX_CHUNK_ROWS", "MAX_CHUNKS",
]

NEG_INF = -1e30
STATS = KernelStats()

_SOURCE = "decode_attention_int8.cu"
_LAUNCHER = "decode_attention_int8_launch"
# query heads per kv-head the kernel is built for (ascending); a launch with
# more runs slices of the last along the grid
KERNEL_GROUPS = (1, 2, 4, 8)
# the chunks of S (csrc/decode_attention_int8.cu): a multiple of the 32 rows
# a block reads per step and at most 1,024 rows (the scores and p of a chunk
# sit in shared memory); the planner lengthens chunks before it passes
# MAX_CHUNKS of them (past MAX_CHUNKS · MAX_CHUNK_ROWS rows their count grows)
ROWS_PER_STEP = 32
MAX_CHUNK_ROWS = 1024
MAX_CHUNKS = 128
_BLOCKS_PER_SM = 2
_INV_127 = float(np.float32(1.0) / np.float32(127.0))  # XLA's x / 127 under jit


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8: x [..., hd] → (codes int8, scales f32
    [...]). The scale is max(|x|)·float32(1/127), as XLA compiles the JAX
    version's ``/ 127.0`` inside the jitted model."""
    xf = x.float()
    scales = torch.clamp_min(xf.abs().amax(dim=-1), 1e-12) * _INV_127
    codes = torch.clamp(torch.round(xf / scales[..., None]), -127, 127).to(torch.int8)
    return codes, scales


def decode_attention_supported(head_dim: int, seq: int) -> bool:
    """``crs_tpu``'s gate for the fused kernel: hd and S 128-aligned."""
    return head_dim % 128 == 0 and seq % 128 == 0


def launch_groups(group: int) -> int:
    """The query heads per kv-head a launch runs for ``group`` real ones: the
    next built count, or past the largest the next multiple of it (zero
    heads padded; each head's attention is its own, so the real heads are
    unchanged and the added ones are sliced off)."""
    top = KERNEL_GROUPS[-1]
    if group <= top:
        return next(kg for kg in KERNEL_GROUPS if kg >= group)
    return -(-group // top) * top


def emulate_decode_attention_int8(q, k_codes, k_scales, v_codes, v_scales, valid):
    """The kernel's arithmetic in plain torch (bf16 casts, f32 softmax) →
    ctx [B, Hkv, G, hd] f32."""
    if q.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain decode attention needs torch.backends.cuda.matmul."
                           "allow_tf32 = False")
    hd = q.shape[-1]
    qb = q.to(torch.bfloat16).float()
    scores = torch.einsum("bhgd,bhsd->bhgs", qb, k_codes.float())
    scores = scores * (k_scales[:, :, None, :] * (1.0 / (hd ** 0.5)))
    ok = (valid != 0)[:, None, None, :]
    scores = torch.where(ok, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.where(ok, torch.exp(scores - m), 0.0)
    probs = e / torch.clamp_min(e.sum(dim=-1, keepdim=True), 1e-30)
    pv = (probs * v_scales[:, :, None, :]).to(torch.bfloat16).float()
    return torch.einsum("bhgs,bhsd->bhgd", pv, v_codes.float())


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@functools.lru_cache(maxsize=None)
def split_plan(bh: int, s: int, sm_count: int) -> Tuple[int, int]:
    """(chunk_rows, nchunk): S cut into chunks so the grid of B·Hkv × nchunk
    blocks gives every SM ``_BLOCKS_PER_SM`` blocks where S allows it, the
    chunks as even as multiples of 32 rows make them."""
    want = -(-_BLOCKS_PER_SM * sm_count // bh)
    rows = max(ROWS_PER_STEP, s // want // ROWS_PER_STEP * ROWS_PER_STEP)
    rows = min(max(rows, _round_up(-(-s // MAX_CHUNKS), ROWS_PER_STEP)), MAX_CHUNK_ROWS)
    rows = _round_up(-(-s // -(-s // rows)), ROWS_PER_STEP)  # even out the last chunk
    return rows, -(-s // rows)


def _load():
    return load_library(_SOURCE, {_LAUNCHER: [ARG_PTR] * 11 + [ARG_INT] * 7 + [ARG_FLOAT]
                                  + [ARG_PTR]})


def decode_attention_int8(
    q: torch.Tensor,  # [B, Hkv, G, hd] (rope applied, not pre-scaled)
    k_codes: torch.Tensor,  # [B, Hkv, S, hd] int8
    k_scales: torch.Tensor,  # [B, Hkv, S] f32
    v_codes: torch.Tensor,  # [B, Hkv, S, hd] int8
    v_scales: torch.Tensor,  # [B, Hkv, S] f32
    valid: torch.Tensor,  # [B, S] bool / int8: slots holding real tokens
) -> torch.Tensor:
    """Single-token decode attention → ctx [B, Hkv, G, hd] f32, zero for a
    batch row with no valid slot. CPU tensors take
    :func:`emulate_decode_attention_int8`; CUDA tensors launch
    ``decode_attention_int8`` or raise. Forward-only: raises where an input
    requires a gradient."""
    refuse_gradients("decode_attention_int8", q, k_scales, v_scales)
    if k_codes.device.type == "cpu":
        return emulate_decode_attention_int8(q, k_codes, k_scales, v_codes, v_scales, valid)
    dev = k_codes.device
    if q.dim() != 4 or k_codes.dim() != 4:
        raise ValueError("q must be [B, Hkv, G, hd] and the codes [B, Hkv, S, hd]")
    b, hkv, g, hd = q.shape
    s = k_codes.shape[2]
    if not decode_attention_supported(hd, s) or hd < 128 or s < 128 or g < 1:
        raise ValueError(f"the kernel takes head_dim and S positive multiples of 128 and at "
                         f"least one query head per kv-head; got hd {hd}, G {g}, S {s}")
    for name, t, shape in (("k_codes", k_codes, (b, hkv, s, hd)), ("v_codes", v_codes, (b, hkv, s, hd)),
                           ("k_scales", k_scales, (b, hkv, s)), ("v_scales", v_scales, (b, hkv, s)),
                           ("valid", valid, (b, s))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    g_run = launch_groups(g)
    qf = q.float()
    if g_run != g:
        qf = torch.nn.functional.pad(qf, (0, 0, 0, g_run - g))
    qf = qf.contiguous()
    bias = torch.where(valid != 0, 0.0, NEG_INF).float()
    check_operands(dev, ("q", qf, torch.float32), ("k_codes", k_codes, torch.int8),
                   ("k_scales", k_scales, torch.float32), ("v_codes", v_codes, torch.int8),
                   ("v_scales", v_scales, torch.float32), ("bias", bias, torch.float32))
    bh = b * hkv
    rows, nchunk = split_plan(bh, s, sm_count(dev))
    stream = stream_handle(dev)
    scores = scratch(dev, stream, "attn_scores", bh * g_run * s, torch.float32)
    stats = scratch(dev, stream, "attn_stats", bh * nchunk * g_run * 2, torch.float32)
    partials = scratch(dev, stream, "attn_partials", bh * nchunk * g_run * hd, torch.float32)
    counters = scratch(dev, stream, "attn_counters", bh * max(1, g_run // KERNEL_GROUPS[-1]),
                       torch.int32, zero=True)
    out = torch.empty((b, hkv, g_run, hd), dtype=torch.float32, device=dev)
    launch(STATS, "decode_attention_int8", getattr(_load(), _LAUNCHER),
           qf.data_ptr(), k_codes.data_ptr(), k_scales.data_ptr(), v_codes.data_ptr(),
           v_scales.data_ptr(), bias.data_ptr(), scores.data_ptr(), stats.data_ptr(),
           partials.data_ptr(), counters.data_ptr(), out.data_ptr(), bh, hkv, g_run, s, rows,
           nchunk, hd, float(np.float32(1.0 / math.sqrt(hd))), stream)
    # a row with no valid slot softmaxes the bias into garbage: exact zeros
    any_valid = (valid != 0).any(dim=1).to(out.dtype)
    return out[:, :, :g] * any_valid[:, None, None, None]
