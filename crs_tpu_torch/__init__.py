"""crs_tpu_torch: the PyTorch/CUDA port of ``crs_tpu``.

The batched RAG retrieve (hashed query embedding; fp32, bf16, int8 or PQ
store; scan → rerank → MMR, with pseudo-relevance feedback) on an NVIDIA
H100. Module names mirror ``crs_tpu``'s so each counterpart is easy to
find; the TPU kernels on this path (``crs_tpu.ops.pallas_scan``'s
``pallas_topk_int8``, ``pallas_topk``, ``pallas_topk_residual_pq_adc`` and
``pallas_topk_pq_adc``) are hand-written CUDA kernels in ``csrc/``.

Entry points run on the card unless the caller passes ``device="cpu"``;
without CUDA and without an explicit ``"cpu"`` they raise.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
