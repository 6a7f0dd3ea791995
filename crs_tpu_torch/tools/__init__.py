"""The port's decode weight-streaming tools (ports of ``tools/bench_q4_kernel.py``
and ``tools/bench_chain_gemv.py``): ``python -m crs_tpu_torch.tools.bench_q4_kernel``
and ``python -m crs_tpu_torch.tools.bench_chain_gemv``, on the card unless
``--device cpu``. Each times its work as replays of a CUDA graph (the JAX
tools' one jitted program), measured with CUDA events."""
