"""world_knowledge dataset loaders — declared, not yet implemented.

Port of ``crs_tpu.finetuning.world_knowledge``: the category and its planned
datasets are declared so the factory can report them, but loading raises
NotImplementedError until the datasets are wired.
"""

from typing import List, Tuple

from .base import BaseDatasetLoader, DatasetSample

__all__ = ["WorldKnowledgeLoader", "PLANNED_DATASETS"]

PLANNED_DATASETS = ['mmlu', 'triviaqa', 'natural_questions']


class WorldKnowledgeLoader(BaseDatasetLoader):
    name = "world_knowledge"
    category = "world_knowledge"

    def load(self) -> Tuple[List[DatasetSample], List[DatasetSample]]:
        raise NotImplementedError(
            f"world_knowledge loaders (e.g. MMLU) are declared but not implemented; "
            f"planned datasets: {PLANNED_DATASETS}"
        )
