"""The port's causal LM: quantized weights, prefill and KV-cache decode,
sampling, and the model interface."""

from .bytes_tokenizer import ByteTokenizer
from .model_interface import ModelInterface, TorchModel, create_model_interface
from .quantized import QuantizedTensor, params_num_bytes, qmatmul, quantize_params, quantize_tensor
from .sampling import SamplingParams, generate_tokens
from .transformer import CONFIGS, TransformerConfig, decode_step, forward, init_cache, init_params, prefill

__all__ = [
    "ByteTokenizer", "ModelInterface", "TorchModel", "create_model_interface",
    "QuantizedTensor", "params_num_bytes", "qmatmul", "quantize_params", "quantize_tensor",
    "SamplingParams", "generate_tokens", "CONFIGS", "TransformerConfig", "decode_step",
    "forward", "init_cache", "init_params", "prefill",
]
