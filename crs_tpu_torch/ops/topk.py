"""Exact top-k similarity scan primitives (port of ``crs_tpu.ops.topk``).

``jax.lax.top_k`` and ``jnp.argsort`` put the lower index first among equal
values; ``torch.topk`` promises no order among ties. Every top-k of the port
therefore goes through :func:`topk_stable`, a stable descending sort, so ids
agree with the JAX package wherever scores tie exactly.

All functions assume L2-normalized vectors so cosine == dot product.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

__all__ = ["NEG_INF", "topk_stable", "exact_topk", "blockwise_topk", "merge_topk"]

NEG_INF = -1e30  # the score sentinel; ids pad with -1


def topk_stable(x: torch.Tensor, k: int, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along ``dim``, larger first, lower index first among equal
    values (``lax.top_k``'s order). Returns (values, int64 indices)."""
    values, indices = torch.sort(x, dim=dim, descending=True, stable=True)
    return values.narrow(dim, 0, k), indices.narrow(dim, 0, k)


def _pad_k(scores: torch.Tensor, ids: torch.Tensor, k: int):
    short = k - scores.shape[1]
    if short <= 0:
        return scores, ids
    b = scores.shape[0]
    pad_s = torch.full((b, short), NEG_INF, dtype=torch.float32, device=scores.device)
    pad_i = torch.full((b, short), -1, dtype=ids.dtype, device=ids.device)
    return torch.cat([scores, pad_s], 1), torch.cat([ids, pad_i], 1)


def _dot_f32(queries: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """[B, D] · [N, D]ᵀ in f32 with the corpus storage dtype's rounding of the
    query (bf16 products are exact in f32, so upcasting equals a bf16 dot
    with f32 accumulation)."""
    q = queries.to(vectors.dtype).float()
    return q @ vectors.float().T


def exact_topk(
    vectors: torch.Tensor,  # [N, D] f32/bf16, rows >= valid_n are padding
    queries: torch.Tensor,  # [B, D] f32
    k: int,
    valid_n: Optional[Union[int, torch.Tensor]] = None,
    row_mask: Optional[torch.Tensor] = None,  # [N] bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k: (scores [B, k] f32, ids [B, k] int64)."""
    n = vectors.shape[0]
    scores = _dot_f32(queries, vectors)
    if valid_n is not None:
        row_ids = torch.arange(n, device=scores.device)[None, :]
        scores = torch.where(row_ids < valid_n, scores, NEG_INF)
    if row_mask is not None:
        scores = torch.where(row_mask[None, :], scores, NEG_INF)
    top_s, top_i = topk_stable(scores, min(k, n))
    return _pad_k(top_s, top_i, k)


def blockwise_topk(
    vectors: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    valid_n: Union[int, torch.Tensor],
    block_size: int = 4096,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k scanning the corpus in blocks (the ``lax.scan`` of the
    JAX version as a loop): peak memory O(B·block_size), same result as
    :func:`exact_topk`."""
    n = vectors.shape[0]
    b = queries.shape[0]
    dev = queries.device
    best_s = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for start in range(0, n, block_size):
        block = vectors[start : start + block_size]
        s = _dot_f32(queries, block)
        if block.shape[0] < block_size:  # zero rows of the padded last block
            s = torch.cat([s, torch.zeros((b, block_size - block.shape[0]), device=dev)], 1)
        ids = start + torch.arange(block_size, device=dev)
        s = torch.where(ids[None, :] < valid_n, s, NEG_INF)
        if row_mask is not None:
            blk_mask = torch.zeros(block_size, dtype=torch.bool, device=dev)
            part = row_mask[start : start + block_size]
            blk_mask[: part.shape[0]] = part
            s = torch.where(blk_mask[None, :], s, NEG_INF)
        cat_s = torch.cat([best_s, s], 1)
        cat_i = torch.cat([best_i, ids[None, :].expand(b, -1)], 1)
        best_s, sel = topk_stable(cat_s, k)
        best_i = torch.gather(cat_i, 1, sel)
    return best_s, best_i


def merge_topk(
    scores: torch.Tensor,  # [B, S, k] per-shard scores
    ids: torch.Tensor,  # [B, S, k] per-shard GLOBAL ids
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top-k lists into a global top-k."""
    b = scores.shape[0]
    flat_s = scores.reshape(b, -1)
    flat_i = ids.reshape(b, -1)
    top_s, sel = topk_stable(flat_s, min(k, flat_s.shape[1]))
    return top_s, torch.gather(flat_i, 1, sel)
