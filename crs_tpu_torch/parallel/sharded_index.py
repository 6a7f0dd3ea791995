"""The sharded corpus scan (counterpart of ``crs_tpu.parallel.sharded_index``).

Corpus rows are split over the mesh's ``corpus`` axis: with ``per =
ceil(n / S)`` rows a rank, rank r holds global rows ``[r·per, (r+1)·per)``
(zeros past the end), so a row's global id is its index in that layout.
Queries are replicated; each rank scans its own rows — through the same
kernels as the single-device store once a shard holds ≥ 4·block_size rows
(kernel 2 for fp32 / bf16, kernel 1 for int8, kernel 3 for residual PQ;
on a CPU tensor each wrapper takes its plain version), else the dense
per-shard body of ``crs_tpu`` — then the per-rank (scores, global ids) are
all-gathered over the corpus group, laid out shard-major, and reduced to the
global top-k with :func:`~crs_tpu_torch.ops.topk.topk_stable` (lowest
position first among ties, as ``lax.top_k``). Every rank returns the same
result. Padding and wholly padded shards score -1e30.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..ops.pq import ResidualPQ, residual_pq_adc_topk
from ..ops.quant import int8_dot, scalar_quantize
from ..ops.scan import scan_topk, scan_topk_int8, scan_topk_residual_pq_adc
from ..ops.topk import NEG_INF, merge_topk, topk_stable
from .mesh import mesh_device

__all__ = ["shard_corpus", "sharded_topk", "sharded_topk_int8", "sharded_topk_residual_pq",
           "all_gather_rows"]

ValidN = Union[int, torch.Tensor]


def shard_corpus(vectors, mesh, axis_name: str = "corpus") -> Tuple[torch.Tensor, int]:
    """This rank's ``per = ceil(n / S)`` rows of ``vectors`` (host or device
    array; zeros past row n) on the rank's device → (local tensor, n)."""
    t = vectors if isinstance(vectors, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(vectors))
    n = int(t.shape[0])
    per = -(-n // dist.get_world_size(mesh.get_group(axis_name)))
    r = mesh.get_local_rank(axis_name)
    part = t[min(r * per, n):min((r + 1) * per, n)]
    local = torch.zeros((per,) + tuple(t.shape[1:]), dtype=t.dtype, device=mesh_device(mesh))
    local[:part.shape[0]] = part.to(local.device)
    return local, n


def _use_kernel(per_shard: int, block_size: int) -> bool:
    """The kernel route once a shard holds a few blocks (the single-device
    store's ≥ 4·block_size threshold)."""
    return per_shard >= 4 * block_size


def all_gather_rows(local: torch.Tensor, group) -> torch.Tensor:
    """The shards of every rank of ``group``, concatenated in rank order."""
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts, 0)


def _merge_topk(s_top: torch.Tensor, i_top: torch.Tensor, k: int, group):
    """All-gather every rank's [B, k_local] winners (global ids) and reduce
    them shard-major to the global top-min(k, S·k_local)."""
    world = dist.get_world_size(group)
    all_s = [torch.empty_like(s_top) for _ in range(world)]
    all_i = [torch.empty_like(i_top) for _ in range(world)]
    dist.all_gather(all_s, s_top.contiguous(), group=group)
    dist.all_gather(all_i, i_top.contiguous(), group=group)
    return merge_topk(torch.stack(all_s, 1), torch.stack(all_i, 1), k)


def _local_view(n_local: int, valid_n: ValidN, row_mask, mesh, axis_name: str):
    """(offset, valid_local, mask_local [per] bool) of this rank."""
    offset = mesh.get_local_rank(axis_name) * n_local
    valid_local = min(max(int(valid_n) - offset, 0), n_local)
    dev = mesh_device(mesh)
    if row_mask is None:
        mask_local = torch.ones((n_local,), dtype=torch.bool, device=dev)
    else:
        mask_local = row_mask[offset:offset + n_local].to(dev)
    return offset, valid_local, mask_local


def _allowed(ids_local: torch.Tensor, valid_local: int, mask_local: torch.Tensor):
    """Local rows that are real and pass the mask."""
    return (ids_local < valid_local) & mask_local[ids_local]


def sharded_topk(
    vectors: torch.Tensor,  # [per, D] this rank's rows (shard_corpus)
    queries: torch.Tensor,  # [B, D] f32, replicated
    k: int,
    valid_n: ValidN,
    mesh,
    axis_name: str = "corpus",
    row_mask: Optional[torch.Tensor] = None,  # [per·S] bool, replicated
    block_size: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global exact top-k over the sharded fp32 / bf16 corpus → (scores
    [B, min(k, S·k_local)], global ids int64), the same on every rank."""
    per = vectors.shape[0]
    k_local = min(k, per)
    offset, valid_local, mask_local = _local_view(per, valid_n, row_mask, mesh, axis_name)
    q = queries.to(vectors.device).float()
    if _use_kernel(per, block_size):
        s, i_local = scan_topk(vectors, q, k_local, valid_local, block_size,
                               row_mask=mask_local)
    else:
        scores = q.to(vectors.dtype).float() @ vectors.float().T  # [B, per] f32
        ids = torch.arange(per, device=vectors.device)[None, :]
        scores = torch.where((ids < valid_local) & mask_local[None, :], scores, NEG_INF)
        s, i_local = topk_stable(scores, k_local)
    return _merge_topk(s, i_local + offset, k, mesh.get_group(axis_name))


def _rescore_local(codes, scales, q, cand, valid_local, mask_local, k_local, offset):
    """fp32 rescore of local candidates against the dequantized int8 rows,
    the local top-k_local as global ids."""
    cand_vecs = codes[cand].float() * scales[cand][..., None]
    exact = torch.bmm(cand_vecs, q[:, :, None])[..., 0]
    exact = torch.where(_allowed(cand, valid_local, mask_local), exact, NEG_INF)
    s_top, sel = topk_stable(exact, k_local)
    return s_top, torch.gather(cand, 1, sel) + offset


def sharded_topk_int8(
    codes: torch.Tensor,  # [per, D] int8, this rank's rows
    scales: torch.Tensor,  # [per] f32
    queries: torch.Tensor,
    k: int,
    valid_n: ValidN,
    mesh,
    rescore_k: int = 64,
    axis_name: str = "corpus",
    row_mask: Optional[torch.Tensor] = None,
    block_size: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard int8 candidates (kernel 1, or the dense approximate int8
    scan on small shards) → local fp32 rescore → all-gather merge."""
    per = codes.shape[0]
    offset, valid_local, mask_local = _local_view(per, valid_n, row_mask, mesh, axis_name)
    q = queries.to(codes.device).float()
    cand_k = min(rescore_k, per)
    if _use_kernel(per, block_size):
        _, cand = scan_topk_int8(codes, scales, q, cand_k, valid_local, block_size,
                                 row_mask=mask_local)
    else:
        # XLA's reciprocal product for max/127, a true division for q / qs
        q_codes, q_scales = scalar_quantize(q)
        approx = int8_dot(q_codes, codes) * q_scales[:, None] * scales[None, :]
        ids = torch.arange(per, device=codes.device)[None, :]
        approx = torch.where((ids < valid_local) & mask_local[None, :], approx, NEG_INF)
        _, cand = topk_stable(approx, cand_k)
    s_top, i_top = _rescore_local(codes, scales, q, cand, valid_local, mask_local,
                                  min(k, cand_k), offset)
    return _merge_topk(s_top, i_top, k, mesh.get_group(axis_name))


def sharded_topk_residual_pq(
    rpq: ResidualPQ,  # replicated rotation / coarse / codebook
    codes_ext: torch.Tensor,  # [per, M+2] uint8, this rank's rows
    i8_codes: Optional[torch.Tensor],  # [per, D] int8 rescore mirror, or None
    i8_scales: Optional[torch.Tensor],  # [per] f32, or None
    queries: torch.Tensor,
    k: int,
    valid_n: ValidN,
    mesh,
    rescore_k: int = 64,
    axis_name: str = "corpus",
    row_mask: Optional[torch.Tensor] = None,
    block_size: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard residual-PQ ADC candidates (kernel 3 when the shard holds
    ≥ 4·block_size rows and 256 | C ≤ 65,536; else the blockwise ADC) →
    rescore against the int8 mirror (or the ADC ranking without one) →
    all-gather merge."""
    per = codes_ext.shape[0]
    num_coarse = rpq.coarse.shape[0]
    offset, valid_local, mask_local = _local_view(per, valid_n, row_mask, mesh, axis_name)
    q = queries.to(codes_ext.device).float()
    cand_k = min(rescore_k, per)
    if _use_kernel(per, block_size) and num_coarse % 256 == 0 and num_coarse <= 65536:
        adc_s, cand = scan_topk_residual_pq_adc(
            rpq.rotation, rpq.coarse, rpq.codebook.centroids, codes_ext, q, cand_k,
            valid_local, block_size, row_mask=mask_local)
    else:
        cid = codes_ext[:, 0].int() * 256 + codes_ext[:, 1].int()
        adc_s, cand = residual_pq_adc_topk(rpq, cid, codes_ext[:, 2:], q, cand_k, valid_local,
                                           row_mask=mask_local)
    k_local = min(k, cand_k)
    if i8_codes is not None:
        s_top, i_top = _rescore_local(i8_codes, i8_scales, q, cand, valid_local, mask_local,
                                      k_local, offset)
    else:  # PQ-only serving: rank by the ADC scores
        exact = torch.where(_allowed(cand, valid_local, mask_local), adc_s, NEG_INF)
        s_top, sel = topk_stable(exact, k_local)
        i_top = torch.gather(cand, 1, sel) + offset
    return _merge_topk(s_top, i_top, k, mesh.get_group(axis_name))
