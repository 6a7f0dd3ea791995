from .base import BaseDatasetLoader, DatasetInfo, DatasetSample
from .lora import LoRAWeight, add_lora, lora_trainable_mask, merge_lora, extract_lora
from .trainer import QuantizedModelFinetuner, EvaluationCallback

__all__ = [
    "BaseDatasetLoader",
    "DatasetInfo",
    "DatasetSample",
    "LoRAWeight",
    "add_lora",
    "lora_trainable_mask",
    "merge_lora",
    "extract_lora",
    "QuantizedModelFinetuner",
    "EvaluationCallback",
]
