"""Finetuning dataset abstractions (port of ``crs_tpu.finetuning.base``).

``DatasetSample`` (instruction, input, output, category, metadata),
``DatasetInfo``, the ``BaseDatasetLoader`` ABC with ``load() -> (train,
eval)``, the Alpaca-style ``format_prompt`` and word statistics. Host code
only: the samples and strings equal ``crs_tpu``'s.
"""

from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["DatasetSample", "DatasetInfo", "BaseDatasetLoader"]


@dataclasses.dataclass
class DatasetSample:
    instruction: str
    input: str = ""
    output: str = ""
    category: str = ""
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DatasetInfo:
    name: str
    category: str
    num_train: int
    num_eval: int
    description: str = ""
    source: str = ""


class BaseDatasetLoader(ABC):
    """Loads (train, eval) sample lists for a dataset."""

    name: str = "base"
    category: str = ""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = config or {}

    @abstractmethod
    def load(self) -> Tuple[List[DatasetSample], List[DatasetSample]]: ...

    @staticmethod
    def format_prompt(sample: DatasetSample, include_output: bool = True) -> str:
        """Alpaca-style instruction prompt."""
        if sample.input:
            prompt = (
                "Below is an instruction that describes a task, paired with an input "
                "that provides further context. Write a response that appropriately "
                "completes the request.\n\n"
                f"### Instruction:\n{sample.instruction}\n\n"
                f"### Input:\n{sample.input}\n\n### Response:\n"
            )
        else:
            prompt = (
                "Below is an instruction that describes a task. Write a response that "
                "appropriately completes the request.\n\n"
                f"### Instruction:\n{sample.instruction}\n\n### Response:\n"
            )
        if include_output:
            prompt += sample.output
        return prompt

    def get_info(self, train: List[DatasetSample], eval_: List[DatasetSample]) -> DatasetInfo:
        return DatasetInfo(
            name=self.name,
            category=self.category,
            num_train=len(train),
            num_eval=len(eval_),
        )

    @staticmethod
    def stats(samples: List[DatasetSample]) -> Dict[str, Any]:
        """Word statistics of the samples."""
        if not samples:
            return {"count": 0}
        lens = [len((s.instruction + s.input + s.output).split()) for s in samples]
        return {
            "count": len(samples),
            "avg_words": sum(lens) / len(lens),
            "max_words": max(lens),
            "min_words": min(lens),
        }
