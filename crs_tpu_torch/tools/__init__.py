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
  cannot capture;
- the PQ recall curve ``pq_recall_curve`` (kernels 3 and 4) with its
  report ``curve_report`` and figure ``plot_pq_curve``;
- the retrieval-quality tools ``ir_eval``, ``quality_eval``,
  ``oracle_bounds``, ``quality_diag`` and the sweeps ``quality_sweep``,
  ``quality_docside_sweep`` and ``quality_geometry_sweep`` (their shared
  parts in ``quality_common``), on ``--corpus`` / ``--qa``: by default the
  repository's held-out corpus and questions.

Run each as ``python -m crs_tpu_torch.tools.<name>``; ``timing`` holds the
timers and the launch counts. The tools that write files write them under
:func:`output_dir` unless told otherwise."""

import os
import tempfile

__all__ = ["output_dir"]


def output_dir(tool: str) -> str:
    """The default output directory of ``tool``: ``crs_tpu_torch/<tool>``
    under the temporary directory (``TMPDIR``), never inside the repository."""
    return os.path.join(tempfile.gettempdir(), "crs_tpu_torch", tool)
