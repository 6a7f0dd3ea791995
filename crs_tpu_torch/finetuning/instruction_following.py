"""instruction_following dataset loaders — declared, not yet implemented.

Port of ``crs_tpu.finetuning.instruction_following``: the category and its planned
datasets are declared so the factory can report them, but loading raises
NotImplementedError until the datasets are wired.
"""

from typing import List, Tuple

from .base import BaseDatasetLoader, DatasetSample

__all__ = ["InstructionFollowingLoader", "PLANNED_DATASETS"]

PLANNED_DATASETS = ['alpaca', 'dolly', 'flan']


class InstructionFollowingLoader(BaseDatasetLoader):
    name = "instruction_following"
    category = "instruction_following"

    def load(self) -> Tuple[List[DatasetSample], List[DatasetSample]]:
        raise NotImplementedError(
            f"instruction_following loaders (e.g. Alpaca) are declared but not implemented; "
            f"planned datasets: {PLANNED_DATASETS}"
        )
