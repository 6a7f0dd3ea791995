"""math_reasoning dataset loaders — declared, not yet implemented.

Port of ``crs_tpu.finetuning.math_reasoning``: the category and its planned
datasets are declared so the factory can report them, but loading raises
NotImplementedError until the datasets are wired.
"""

from typing import List, Tuple

from .base import BaseDatasetLoader, DatasetSample

__all__ = ["MathReasoningLoader", "PLANNED_DATASETS"]

PLANNED_DATASETS = ['gsm8k', 'math', 'mathqa']


class MathReasoningLoader(BaseDatasetLoader):
    name = "math_reasoning"
    category = "math_reasoning"

    def load(self) -> Tuple[List[DatasetSample], List[DatasetSample]]:
        raise NotImplementedError(
            f"math_reasoning loaders (e.g. GSM8K) are declared but not implemented; "
            f"planned datasets: {PLANNED_DATASETS}"
        )
