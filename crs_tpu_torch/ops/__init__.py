"""Kernels and primitives of the port: ``scan`` holds the CUDA scan
kernels' wrappers (int8, fp32/bf16, PQ ADC), ``pq`` the product quantizer,
``qgemm`` the int4 / NF4 matmul wrappers, ``decode_attention`` the int8-KV
decode-attention wrapper, ``fused_mlp`` the fused int8 MLP wrapper,
``launch`` what they share."""

from .mmr import mmr_select, mmr_select_batch
from .pq import (
    PQCodebook, ResidualPQ, pq_adc_topk, pq_encode, residual_pq_adc_topk, residual_pq_encode,
    train_pq, train_residual_pq,
)
from .quant import int8_topk, scalar_quantize
from .scan import (
    block_topk_adc, block_topk_float, block_topk_int8, scan_topk, scan_topk_int8,
    scan_topk_pq_adc, scan_topk_residual_pq_adc,
)
from .topk import blockwise_topk, exact_topk, merge_topk, topk_stable

__all__ = [
    "mmr_select", "mmr_select_batch", "PQCodebook", "ResidualPQ", "pq_adc_topk", "pq_encode",
    "residual_pq_adc_topk", "residual_pq_encode", "train_pq", "train_residual_pq",
    "int8_topk", "scalar_quantize", "block_topk_adc", "block_topk_float", "block_topk_int8",
    "scan_topk", "scan_topk_int8", "scan_topk_pq_adc", "scan_topk_residual_pq_adc",
    "blockwise_topk", "exact_topk", "merge_topk", "topk_stable",
]
