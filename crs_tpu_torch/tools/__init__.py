"""The port's tools (ports of ``tools/``), on the card unless ``--device cpu``:

- the decode weight-streaming tools ``bench_q4_kernel`` and
  ``bench_chain_gemv`` (and ``probe_breakdown``, card only), each timing its
  work as replays of a CUDA graph (the JAX tools' one jitted program);
- the serving tools ``bench_decode`` (decode ms/token by differencing two
  greedy generates), ``bench_prefill_mfu`` and ``bench_fused_mlp`` (kernel
  11 against the int8 route, as CUDA-graph chains);
- the scale tools ``bench_scale`` (the int8 scan at 10M rows) and
  ``bench_pq_serving`` (PQ-only serving at 40M rows), whose scans are timed
  eagerly: a scan reads a device count on the host, which a CUDA graph
  cannot capture.

Run each as ``python -m crs_tpu_torch.tools.<name>``; ``timing`` holds the
timers and the launch counts."""
