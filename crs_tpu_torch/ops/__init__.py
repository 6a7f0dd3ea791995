"""Kernels and primitives of the port: ``scan`` holds the CUDA scan
kernels' wrappers (int8, fp32/bf16, PQ ADC over unsorted and coarse-sorted
rows, the segment-max pair), ``pq`` the product quantizer,
``qgemm`` the int4 / NF4 matmul wrappers, ``decode_attention`` the int8-KV
decode-attention wrapper, ``fused_mlp`` the fused int8 MLP wrapper,
``launch`` what they share."""

from .mmr import mmr_select, mmr_select_batch
from .pq import (
    PQCodebook, ResidualPQ, pq_adc_topk, pq_encode, residual_pq_adc_topk, residual_pq_encode,
    sort_codes_by_coarse, train_pq, train_residual_pq,
)
from .quant import int8_topk, scalar_quantize
from .scan import (
    adc_auto_group, block_topk_adc, block_topk_adc_sorted, block_topk_float, block_topk_int8,
    block_topk_segmax, block_topk_segmax_int8, plan_sorted_coarse_windows, scan_topk,
    scan_topk_int8, scan_topk_pq_adc, scan_topk_residual_pq_adc,
    scan_topk_residual_pq_adc_sorted, scan_topk_segmax, scan_topk_segmax_int8,
)
from .topk import blockwise_topk, exact_topk, merge_topk, topk_stable

__all__ = [
    "mmr_select", "mmr_select_batch", "PQCodebook", "ResidualPQ", "pq_adc_topk", "pq_encode",
    "residual_pq_adc_topk", "residual_pq_encode", "sort_codes_by_coarse", "train_pq",
    "train_residual_pq", "int8_topk", "scalar_quantize", "adc_auto_group", "block_topk_adc",
    "block_topk_adc_sorted", "block_topk_float", "block_topk_int8", "block_topk_segmax",
    "block_topk_segmax_int8", "plan_sorted_coarse_windows", "scan_topk", "scan_topk_int8",
    "scan_topk_pq_adc", "scan_topk_residual_pq_adc", "scan_topk_residual_pq_adc_sorted",
    "scan_topk_segmax", "scan_topk_segmax_int8",
    "blockwise_topk", "exact_topk", "merge_topk", "topk_stable",
]
