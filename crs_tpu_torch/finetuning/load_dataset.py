"""Dataset-category dispatch (port of ``crs_tpu.finetuning.load_dataset``).

Only ``code_generation`` is wired; the other category modules declare
their planned datasets and raise NotImplementedError, as ``crs_tpu``'s do.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .code_generation import create_code_dataset_loader

__all__ = ["load_dataset"]

# declared, not implemented (the five stub modules)
_STUB_CATEGORIES = {
    "math_reasoning": ("gsm8k", "math", "mathqa"),
    "world_knowledge": ("mmlu", "triviaqa", "natural_questions"),
    "domain_expertise": ("medqa", "legalbench", "arxiv"),
    "summarization": ("cnn_dailymail", "xsum", "samsum"),
    "instruction_following": ("alpaca", "dolly", "flan"),
}


def load_dataset(
    category: str, dataset: str = "synthetic", config: Optional[Dict[str, Any]] = None
):
    if category == "code_generation":
        return create_code_dataset_loader(dataset, config).load()
    if category in _STUB_CATEGORIES:
        raise NotImplementedError(
            f"category {category!r} is declared but not implemented "
            f"(planned datasets: {_STUB_CATEGORIES[category]})"
        )
    raise ValueError(f"unknown dataset category: {category}")
