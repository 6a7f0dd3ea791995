"""Search primitives of the port; ``scan`` holds the CUDA int8 scan kernel."""

from .mmr import mmr_select, mmr_select_batch
from .quant import int8_topk, scalar_quantize
from .scan import block_topk_int8, scan_topk_int8
from .topk import blockwise_topk, exact_topk, merge_topk, topk_stable

__all__ = [
    "mmr_select", "mmr_select_batch", "int8_topk", "scalar_quantize",
    "block_topk_int8", "scan_topk_int8", "blockwise_topk", "exact_topk", "merge_topk",
    "topk_stable",
]
