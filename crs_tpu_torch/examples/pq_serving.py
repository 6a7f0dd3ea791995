"""Compressed serving demo: a residual-PQ index at ~10 bytes a vector (port
of ``examples/pq_serving.py``).

Builds a ``VectorStore`` in the ``pq`` format (a coarse quantizer and
OPQ-rotated residual codebooks, trained under the anisotropic score-aware
loss), then serves the same queries through the three ``pq_rescore``
modes:

  int8  int8 rescore codes in device memory beside the PQ codes (default)
  host  the rescore mirror in host RAM; device memory holds only M+2 B/vec
  none  rank by the fused ADC scores alone (pure compressed serving)

At 20,000 rows in 512-row blocks the ADC scan runs through kernel 3
(``adc_scan_topk_skew_kernel``) on the card. It runs on the card unless
``--device cpu`` is given. A mode that fails prints FAILED and the exit
code is 1.

Usage: python -m crs_tpu_torch.examples.pq_serving [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict

import numpy as np

from ..device import resolve_device

__all__ = ["MODES", "N", "DIM", "TOPK", "QUERIES", "make_corpus", "store_config",
           "serve_modes", "main"]

MODES = ("int8", "host", "none")
N, DIM, TOPK, QUERIES = 20_000, 128, 10, 32  # rows, width, k, queries


def make_corpus(n=20_000, d=128, n_clusters=256, seed=0):
    """Clustered, anisotropic (correlated-dim) unit vectors — the regime
    real text embeddings live in and where plain PQ collapses."""
    rng = np.random.default_rng(seed)
    spec = np.exp(-np.arange(d) / 20.0)
    mix = rng.standard_normal((d, d)).astype(np.float32) * spec[None, :]
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) @ mix * 3.0
    x = centers[rng.integers(0, n_clusters, n)]
    x = x + rng.standard_normal((n, d)).astype(np.float32) @ mix
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def store_config(mode: str) -> dict:
    return {
        "format": "pq",
        "pq_subspaces": 8,           # 8 residual bytes
        "pq_coarse_clusters": 512,   # + 2 coarse-id bytes = 10 B/vec
        "pq_aniso_eta": "auto",      # ScaNN score-aware loss
        "pq_iters": 10, "pq_opq_iters": 2,
        "pq_rescore": mode,
        "rescore_k": 100,
        "block_size": 512,
    }


def serve_modes(x: np.ndarray, q: np.ndarray, exact: np.ndarray, topk: int, device,
                modes=MODES, report=print) -> Dict[str, dict]:
    """Each mode's store built over ``x`` and searched with ``q``: {mode:
    {"recall", "build_s", "search_ms", "device_bytes_per_vec",
    "host_mirror_bytes_per_vec"}}. A mode that fails is reported and left
    out; the next one runs."""
    from ..rag.index import VectorStore

    n = x.shape[0]
    out = {}
    for mode in modes:
        try:
            store = VectorStore(store_config(mode), device=device)
            t0 = time.perf_counter()
            store.create_index([f"doc-{i}" for i in range(n)], x)
            build_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            _, ids = store.search_batch(q, top_k=topk)
            ids = ids.cpu().numpy()  # the copy waits for the search
            search_ms = (time.perf_counter() - t0) * 1e3
            recall = float(np.mean([len(set(ids[i]) & set(exact[i])) / topk
                                    for i in range(len(q))]))
            stats = store.get_stats()
            mirror = stats.get("host_mirror_bytes", 0)
            out[mode] = {"recall": recall, "build_s": build_s, "search_ms": search_ms,
                         "device_bytes_per_vec": stats["memory_bytes"] / n,
                         "host_mirror_bytes_per_vec": mirror / n}
            report(f"pq_rescore={mode:5s}  recall@{topk}={recall:.3f}  "
                   f"build={build_s:.1f}s  search={search_ms:.0f}ms/{len(q)}q  "
                   f"device={stats['memory_bytes'] / n:.1f} B/vec"
                   + (f"  host_mirror={mirror / n:.1f} B/vec" if mirror else ""))
        except Exception as e:  # report the mode, run the next; main's exit code says so
            report(f"pq_rescore={mode:5s}  FAILED {type(e).__name__}: {str(e)[:200]}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, d, topk = N, DIM, TOPK
    x = make_corpus(n, d)
    rng = np.random.default_rng(42)
    qi = rng.choice(n, QUERIES, replace=False)
    q = x[qi] + 0.02 * rng.standard_normal((QUERIES, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    exact = np.argsort(-(q @ x.T), axis=1)[:, :topk]
    res = serve_modes(x, q, exact, topk, dev)
    return 0 if set(res) == set(MODES) else 1


if __name__ == "__main__":
    sys.exit(main())
