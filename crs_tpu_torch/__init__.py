"""crs_tpu_torch: the PyTorch/CUDA port of ``crs_tpu``.

Ported so far: the batched RAG retrieve (hashed, lexical LSA or MiniLM
embedding; fp32, bf16, int8 or PQ store; scan → rerank → MMR, with
pseudo-relevance feedback), the text layer with PDF input, config,
logging and the command line (``python -m crs_tpu_torch``), and the
generator (the quantized
causal LM with prefill and int8-KV decode, fused projections and the fused
int8 MLP, GPTQ / AWQ calibration, local Hugging Face checkpoints, sampling,
the model interface, answer generation and the RAG pipeline) on an NVIDIA
H100. Module names mirror ``crs_tpu``'s so each
counterpart is easy to find; the TPU kernels on these paths are
hand-written CUDA kernels in ``csrc/``: the scans of
``crs_tpu.ops.pallas_scan`` (``pallas_topk_int8``, ``pallas_topk``,
``pallas_topk_residual_pq_adc``, ``pallas_topk_pq_adc``), the int4 / NF4
matmuls of ``crs_tpu.ops.qgemm``, ``crs_tpu.ops.decode_attention`` and
``crs_tpu.ops.fused_mlp``.

Entry points run on the card unless the caller passes ``device="cpu"``;
without CUDA and without an explicit ``"cpu"`` they raise.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
