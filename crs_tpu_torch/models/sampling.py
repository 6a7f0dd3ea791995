"""Autoregressive generation: prefill, then a decode loop with sampling (port
of ``crs_tpu.models.sampling``).

Greedy, temperature, top-k, top-p and repetition penalty, with EOS masking.
``crs_tpu`` runs the decode as one ``lax.scan``; the port runs the same steps
as a Python loop over ``max_new_tokens`` with the same ``tokens`` /
``lengths`` contract. Sampled draws come from a ``torch.Generator`` and
cannot match ``jax.random``'s; greedy decoding and the filters are
deterministic and hold to ``crs_tpu``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .transformer import TransformerConfig, decode_step, init_cache, prefill, recip32

__all__ = ["SamplingParams", "generate_tokens"]

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 64
    temperature: float = 0.0  # 0 → greedy
    top_p: float = 1.0
    top_k: int = 0  # 0 → disabled
    repetition_penalty: float = 1.0
    eos_id: int = -1  # -1 → never stops early
    pad_id: int = 0


def _apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                              penalty: float) -> torch.Tensor:
    """HF convention: seen tokens' logits divided (if > 0) or multiplied (if
    < 0) by the penalty; the division is XLA's product by the reciprocal."""
    penalized = torch.where(logits > 0, logits * recip32(penalty), logits * penalty)
    return torch.where(seen, penalized, logits)


def _top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def _top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Keep the smallest set of top logits whose probability reaches top_p
    (the crossing one included): everything at or above its smallest logit."""
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_p
    cutoff = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < cutoff, NEG_INF, logits)


def _sample(logits: torch.Tensor, generator: torch.Generator, sp: SamplingParams) -> torch.Tensor:
    if sp.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits * recip32(sp.temperature)
    logits = _top_k_filter(logits, sp.top_k)
    logits = _top_p_filter(logits, sp.top_p)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)[:, 0]


@torch.no_grad()
def generate_tokens(params, cfg: TransformerConfig, prompt_ids: torch.Tensor,
                    prompt_mask: torch.Tensor, generator: torch.Generator,
                    sp: SamplingParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate from left-padded prompts [B, S] → (tokens [B, max_new_tokens],
    lengths [B]). Tokens after a row's EOS are ``pad_id``; ``lengths``
    counts the real tokens, the EOS included. No gradient: a LoRA model's
    adapters require one, the decode kernels are forward-only."""
    b, s = prompt_ids.shape
    dev = prompt_ids.device
    cache = init_cache(cfg, b, s + sp.max_new_tokens, device=dev)
    logits, cache = prefill(params, cfg, prompt_ids, cache, prompt_mask)
    logits = logits[:, -1, :]
    rows = torch.arange(b, device=dev)
    seen = torch.zeros((b, cfg.vocab_size), dtype=torch.bool, device=dev)
    seen[rows[:, None], prompt_ids] = True  # prompt tokens (pads too) count
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    tokens, was_done = [], []
    for step in range(sp.max_new_tokens):
        if sp.repetition_penalty != 1.0:
            logits = _apply_repetition_penalty(logits, seen, sp.repetition_penalty)
        token = _sample(logits, generator, sp)
        token = torch.where(done, sp.pad_id, token)
        tokens.append(token)
        was_done.append(done)
        done = done | (token == sp.eos_id)
        seen[rows, token] = True
        if step + 1 < sp.max_new_tokens:  # the last step's logits go unused
            logits, cache = decode_step(params, cfg, token, cache)
    if not tokens:
        return (torch.zeros((b, 0), dtype=torch.long, device=dev),
                torch.zeros((b,), dtype=torch.long, device=dev))
    tokens_t = torch.stack(tokens, dim=1)
    lengths = (~torch.stack(was_done, dim=1)).sum(dim=1)
    return tokens_t, lengths
