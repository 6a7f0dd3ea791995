"""summarization dataset loaders — declared, not yet implemented.

Port of ``crs_tpu.finetuning.summarization``: the category and its planned
datasets are declared so the factory can report them, but loading raises
NotImplementedError until the datasets are wired.
"""

from typing import List, Tuple

from .base import BaseDatasetLoader, DatasetSample

__all__ = ["SummarizationLoader", "PLANNED_DATASETS"]

PLANNED_DATASETS = ['cnn_dailymail', 'xsum', 'samsum']


class SummarizationLoader(BaseDatasetLoader):
    name = "summarization"
    category = "summarization"

    def load(self) -> Tuple[List[DatasetSample], List[DatasetSample]]:
        raise NotImplementedError(
            f"summarization loaders (e.g. CNN-DailyMail) are declared but not implemented; "
            f"planned datasets: {PLANNED_DATASETS}"
        )
