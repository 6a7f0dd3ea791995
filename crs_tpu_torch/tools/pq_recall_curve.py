"""PQ-only serving recall CURVE of the port (port of ``tools/pq_recall_curve.py``):
recall@10 against bytes/vec and ms/query across (M subspaces, coarse
clusters, cand_k) on the clustered anisotropic corpus of
:mod:`crs_tpu_torch.tools.bench_pq_serving`.

The corpus is drawn on the device in 1M-row chunks (never dense on the
host) by that tool's :class:`~crs_tpu_torch.tools.bench_pq_serving.ClusteredCorpus`:
torch cannot reproduce the JAX tool's ``jax.random`` keys, so the corpus is
the port's own, with the JAX tool's shapes and constants. The ground truth
(the exact fp32 top-k, each chunk's top-k merged on the host) is computed
ONCE per corpus and shared across the grid; the int8 host mirror of the
rescore too; ``cand`` variations reuse the same encoded codes (a re-scan
only).

Engines (``bench_pq_serving.engine_scan``):
- ``pallas``: the fused residual ADC scan (kernel 3,
  ``scan_topk_residual_pq_adc``);
- ``pallas_sorted``: the rows sorted by coarse id, scanned by kernel 4 in the
  windows planned for the batch; ids map back through the sort on the device;
- ``xla``: the plain all-f32 residual ADC (``residual_pq_adc_topk``), no kernel.

Caches in ``--cache-dir`` (per corpus the truth and the mirror, per (M,
coarse, η) the codebooks and codes) name the generator that drew their
corpus (``corpus_generator``). A cache without that name (the JAX tool's:
another corpus) or with another is refused; an unreadable one (a killed
run's) is removed and rebuilt. ``--out`` is written after every row, and a
rerun with the same ``--out`` skips every (rows, m, coarse, η, cand) it holds.

``scan_ms`` is the mean of 3 scans after a warm one, timed eagerly between
CUDA events (:class:`~crs_tpu_torch.tools.timing.EagerCall`) with the host
clock beside it as ``host_scan_ms``: a scan reads its flagged-pair count on
the host, which a CUDA graph cannot capture.

Usage:
  # the card (timing + recall), 4M rows:
  python -m crs_tpu_torch.tools.pq_recall_curve --rows 4000000
  # the CPU (recall shape only; the plain ADC, no kernel):
  python -m crs_tpu_torch.tools.pq_recall_curve --rows 1000000 --device cpu --engine xla
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
import zipfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from . import output_dir
from .timing import EagerCall

__all__ = ["ENGINES", "SCAN_REPS", "parse_eta", "load_npz", "savez_atomic", "main"]

ENGINES = ("pallas", "xla", "pallas_sorted")
SCAN_REPS = 3


def parse_eta(s: str, d: int) -> Optional[float]:
    """An ``--etas`` entry: ``auto`` is ScaNN's η(T=0.2, d); a value ≤ 1 is
    isotropic (None)."""
    from ..ops.pq import aniso_eta_from_threshold

    s = s.strip()
    if s == "auto":
        return aniso_eta_from_threshold(0.2, d)
    v = float(s)
    return v if v > 1.0 else None


def load_npz(path, dev: torch.device):
    """A cache's arrays, or None when the file is absent or unreadable (a
    killed run's: removed, to be rebuilt). Raises when it holds another
    corpus: written without ``corpus_generator`` or by another generator."""
    from .bench_pq_serving import GENERATOR_KEY, generator_name

    if not Path(path).exists():
        return None
    try:
        z = np.load(path)
        z.files  # force the zip directory read
    except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
        print(f"cache {path} unreadable ({e}); rebuilding", file=sys.stderr)
        Path(path).unlink()
        return None
    if GENERATOR_KEY not in z.files:
        raise ValueError(f"cache {path} has no {GENERATOR_KEY!r}: it was not written by this "
                         "tool, and its arrays belong to another corpus")
    if str(z[GENERATOR_KEY]) != generator_name(dev):
        raise ValueError(f"cache {path} holds the corpus of {str(z[GENERATOR_KEY])!r}, "
                         f"not of {generator_name(dev)!r}")
    return z


def savez_atomic(path, dev: torch.device, **arrays) -> None:
    """``arrays`` and the corpus generator's name into ``path``, atomically
    (a killed run leaves no truncated cache behind)."""
    from .bench_pq_serving import GENERATOR_KEY, generator_name

    np.savez(str(path) + ".tmp.npz", **arrays, **{GENERATOR_KEY: generator_name(dev)})
    os.replace(str(path) + ".tmp.npz", path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=4_000_000)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--centers", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--sigma", type=float, default=0.35)
    ap.add_argument("--ms", default="12,16,24", help="subspace counts")
    ap.add_argument("--coarses", default="2048,4096")
    ap.add_argument("--cands", default="100,200,400")
    ap.add_argument("--etas", default="0",
                    help="aniso η values (comma list); 0=isotropic, "
                         "'auto'=ScaNN η(T=0.2, dim) — see ops/pq.py")
    ap.add_argument("--engine", default="pallas", choices=ENGINES)
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--block-size", type=int, default=2048)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cache-dir", default=output_dir("pq_curve"),
                    help="per-corpus and per-(M,coarse) caches for resume")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else args.device)

    from ..ops.pq import PQCodebook, ResidualPQ
    from ..ops.quant import scalar_quantize
    from . import bench_pq_serving as bps

    def log(line: str) -> None:
        print(line, file=sys.stderr)

    n, d = args.rows, args.dim
    if not (n % bps.CHUNK == 0 or n < bps.CHUNK):
        raise ValueError(f"--rows must be a multiple of {bps.CHUNK} or fewer")
    chunk = min(bps.CHUNK, n)
    nchunks = max(n // chunk, 1)
    os.makedirs(args.cache_dir, exist_ok=True)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device={kind} rows={n} dim={d} engine={args.engine}")

    corpus = bps.ClusteredCorpus(d, args.centers, args.sigma, dev, chunk)
    c0 = corpus.chunk(0)
    queries = corpus.queries(c0, args.batch)
    chunk_fn = lambda ci: corpus.chunk(ci) if ci else c0  # noqa: E731

    # ---- ground truth, once per corpus ------------------------------------
    gt_cache = Path(args.cache_dir) / f"truth_{n}_{args.batch}_{args.k}.npz"
    gt_z = load_npz(gt_cache, dev)
    if gt_z is not None:
        truth = gt_z["truth"]
    else:
        t0 = time.perf_counter()
        truth = bps.ground_truth(chunk_fn, nchunks, chunk, queries, args.k)
        savez_atomic(gt_cache, dev, truth=truth)
        log(f"ground truth in {time.perf_counter() - t0:.1f}s")

    # the host int8 mirror for the rescore recall (once per corpus)
    mir_cache = Path(args.cache_dir) / f"mirror_{n}.npz"
    mdat = load_npz(mir_cache, dev)
    if mdat is not None:
        mirror, mirror_scales = mdat["mirror"], mdat["scales"]
    else:
        mirror = np.empty((n, d), np.int8)
        mirror_scales = np.empty((n,), np.float32)
        for ci in range(nchunks):
            qc, qs = scalar_quantize(chunk_fn(ci))
            mirror[ci * chunk:(ci + 1) * chunk] = qc.cpu().numpy()
            mirror_scales[ci * chunk:(ci + 1) * chunk] = qs.cpu().numpy()
        savez_atomic(mir_cache, dev, mirror=mirror, scales=mirror_scales)

    rows_out = []
    # Resume: a crashed sweep re-runs with the same --out; skip every
    # (m, coarse, eta, cand) combo already measured so re-runs neither
    # duplicate rows nor repeat finished scans.
    done_keys = set()
    if args.out and os.path.exists(args.out):
        with open(args.out) as fh:
            for r in json.load(fh):
                done_keys.add((r["rows"], r["m"], r["coarse"], r["aniso_eta"], r["cand"]))
        if done_keys:
            log(f"resume: {len(done_keys)} combos already in {args.out}")
    q_np = queries.cpu().numpy()
    for m, coarse, eta_s in itertools.product([int(x) for x in args.ms.split(",")],
                                              [int(x) for x in args.coarses.split(",")],
                                              args.etas.split(",")):
        eta = parse_eta(eta_s, d)
        eta_key = 0.0 if eta is None else round(float(eta), 3)
        cands = [int(x) for x in args.cands.split(",")]
        if all((n, m, coarse, eta_key, c) in done_keys for c in cands):
            log(f"resume: m={m} coarse={coarse} eta={eta_key} fully done, skipping")
            continue
        etag = "" if eta is None else f"_a{eta:.3g}"
        cpath = Path(args.cache_dir) / f"codes_{n}_m{m}_c{coarse}{etag}.npz"
        data = load_npz(cpath, dev)
        if data is not None:
            put = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
            rpq = ResidualPQ(rotation=put(data["rotation"]), coarse=put(data["coarse"]),
                             codebook=PQCodebook(put(data["centroids"])))
            ext_host = data["ext"]
        else:
            t0 = time.perf_counter()
            rpq = bps.train_codebooks(c0, m, coarse, eta)
            ext_host = np.empty((n, m + 2), np.uint8)
            bps.encode_chunks(rpq, chunk_fn, nchunks, chunk, eta, ext_host)
            savez_atomic(cpath, dev, ext=ext_host, rotation=rpq.rotation.cpu().numpy(),
                         coarse=rpq.coarse.cpu().numpy(),
                         centroids=rpq.codebook.centroids.cpu().numpy())
            log(f"m={m} coarse={coarse}: trained+encoded in {time.perf_counter() - t0:.0f}s")

        scan = bps.engine_scan(args.engine, rpq, ext_host, n, coarse, args.batch,
                               args.block_size, dev, log)
        for cand in cands:
            if (n, m, coarse, eta_key, cand) in done_keys:
                log(f"resume: m={m} coarse={coarse} eta={eta_key} cand={cand} done, skipping")
                continue
            scan(queries, cand)  # warm: the first call loads the kernel and allocates

            def scans(cand=cand):
                for _ in range(SCAN_REPS):
                    res = scan(queries, cand)
                return res

            call = EagerCall(scans, dev)
            seconds, (adc_s, adc_i) = call.run()
            scan_ms = seconds * 1e3 / SCAN_REPS
            log(f"m={m} coarse={coarse} cand={cand}: scan launches {dict(call.last_run)} "
                f"in {SCAN_REPS} scans")
            adc_i_np = adc_i.cpu().numpy()
            adc_s_np = adc_s.cpu().numpy()

            # host int8 rescore of the cand set (the pq_rescore="host" path)
            host_pred = bps.host_rescore(mirror, mirror_scales, q_np, adc_s_np, adc_i_np, args.k,
                                         n)

            row = {
                "rows": n, "m": m, "coarse": coarse, "cand": cand,
                "aniso_eta": eta_key,
                "bytes_per_vec": m + 2,
                "recall_none": round(bps.recall(adc_i_np, truth, args.k), 4),
                "recall_in_cand": round(bps.recall(adc_i_np, truth, args.k, width=cand), 4),
                "recall_host": round(bps.recall(host_pred, truth, args.k), 4),
                "scan_ms": round(scan_ms, 2),
                "ms_per_query": round(scan_ms / args.batch, 4),
                "host_scan_ms": round(call.host_seconds * 1e3 / SCAN_REPS, 2),
                "engine": args.engine,
                "device": kind,
            }
            rows_out.append(row)
            print(json.dumps(row), flush=True)
            if args.out:  # written after every row: a crash keeps the rows measured
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                existing = []
                if os.path.exists(args.out):
                    with open(args.out) as fh:
                        existing = json.load(fh)
                with open(args.out, "w") as fh:
                    json.dump(existing + [row], fh, indent=1)

    if args.out:
        log(f"wrote {len(rows_out)} rows -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
