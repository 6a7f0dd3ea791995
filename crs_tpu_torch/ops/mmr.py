"""Maximal Marginal Relevance (MMR) diversity selection (port of
``crs_tpu.ops.mmr``).

Greedy selection maximizing ``λ·relevance − (1−λ)·max_sim_to_selected``
over embeddings the index already holds. The JAX version vmaps a ``lax.scan``
of k steps; here the batch dimension is written out and the scan is a loop.
``torch.argmax`` returns the first maximal index, like ``jnp.argmax``.
"""

from __future__ import annotations

from typing import Union

import torch

from .topk import NEG_INF

__all__ = ["mmr_select", "mmr_select_batch"]


def mmr_select_batch(
    cand_embeddings: torch.Tensor,  # [B, C, D] per-query candidate embeddings
    relevance: torch.Tensor,  # [B, C] (invalid candidates = NEG_INF)
    k: int,
    lambda_: Union[float, torch.Tensor] = 0.9,
) -> torch.Tensor:
    """Batched greedy MMR → picks [B, min(k, C)] (int64 indices into the
    candidate lists). Chosen items are masked, so picks are distinct."""
    b, c, _ = cand_embeddings.shape
    dev = cand_embeddings.device
    sim = torch.bmm(cand_embeddings, cand_embeddings.transpose(1, 2))  # [B, C, C]
    # λ is a float32 scalar in the JAX program, so 1 − λ is rounded in f32
    lam = torch.as_tensor(lambda_, dtype=torch.float32, device=dev)
    selected = torch.zeros((b, c), dtype=torch.bool, device=dev)
    max_sim = torch.zeros((b, c), dtype=torch.float32, device=dev)
    rows = torch.arange(b, device=dev)
    picks = []
    for _ in range(min(k, c)):
        score = lam * relevance - (1.0 - lam) * max_sim
        score = torch.where(selected, NEG_INF, score)
        idx = torch.argmax(score, dim=1)
        selected[rows, idx] = True
        max_sim = torch.maximum(max_sim, sim[rows, idx])
        picks.append(idx)
    if not picks:
        return torch.zeros((b, 0), dtype=torch.int64, device=dev)
    return torch.stack(picks, dim=1)


def mmr_select(
    cand_embeddings: torch.Tensor,  # [C, D] L2-normalized candidate embeddings
    relevance: torch.Tensor,  # [C]
    k: int,
    lambda_: Union[float, torch.Tensor] = 0.9,
) -> torch.Tensor:
    """Greedy MMR over one candidate list → indices [min(k, C)] (int64)."""
    return mmr_select_batch(cand_embeddings[None], relevance[None], k, lambda_)[0]
