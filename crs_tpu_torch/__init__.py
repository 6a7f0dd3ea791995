"""crs_tpu_torch: the PyTorch/CUDA port of ``crs_tpu``.

The batched int8 RAG retrieve (hashed query embedding, int8 store, fused
scan → rerank → MMR) on an NVIDIA H100. Module names mirror ``crs_tpu``'s so
each counterpart is easy to find; the one TPU kernel on this path
(``crs_tpu.ops.pallas_scan.pallas_topk_int8``) is the hand-written CUDA
kernel in ``csrc/int8_scan_topk.cu``.

Entry points run on the card unless the caller passes ``device="cpu"``;
without CUDA and without an explicit ``"cpu"`` they raise.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
