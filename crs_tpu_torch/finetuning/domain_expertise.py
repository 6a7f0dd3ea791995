"""domain_expertise dataset loaders — declared, not yet implemented.

Port of ``crs_tpu.finetuning.domain_expertise``: the category and its planned
datasets are declared so the factory can report them, but loading raises
NotImplementedError until the datasets are wired.
"""

from typing import List, Tuple

from .base import BaseDatasetLoader, DatasetSample

__all__ = ["DomainExpertiseLoader", "PLANNED_DATASETS"]

PLANNED_DATASETS = ['medqa', 'legalbench', 'arxiv']


class DomainExpertiseLoader(BaseDatasetLoader):
    name = "domain_expertise"
    category = "domain_expertise"

    def load(self) -> Tuple[List[DatasetSample], List[DatasetSample]]:
        raise NotImplementedError(
            f"domain_expertise loaders (e.g. MedQA) are declared but not implemented; "
            f"planned datasets: {PLANNED_DATASETS}"
        )
