"""PQ-only serving of the port at 40M–100M rows on one card (port of
``tools/bench_pq_serving.py``).

The corpus never exists densely anywhere: clustered anisotropic unit rows
are drawn on the card in 1M-row chunks, residual-PQ encoded chunk by chunk,
and only the [N, M+2] uint8 rows persist (M+2 B/vec: the serving footprint
in device memory). The exact fp32 ground truth draws the same chunks again
and scans them on the card, so a 100M-row corpus (38 GB dense) is checked
end to end with ~1.5 GB of device memory and no 60 GB host array.

The corpus: the JAX tool draws each chunk from ``jax.random`` keys, which
torch cannot reproduce. Here chunk ``ci`` comes from a ``torch.Generator``
on the tool's device seeded by (0, ci) (the mixing matrix, the centers and
the query noise from generators of their own), with the JAX tool's shapes
and constants: the exp(−i/20) spectrum, ``mix / √d``, normalized centers,
``--sigma``; the queries are chunk 0's first rows plus 0.05 noise; the
codebooks train on chunk 0's first 262,144 rows (coarse 8, residual 12 and
OPQ 2 iterations). A CUDA and a CPU generator draw different corpora, so a
``--codes-cache`` names the generator that drew its corpus
(``corpus_generator``), and a cache without that name, or with another, is
refused: its codes would belong to another corpus and the truth would be
wrong.

Modes measured:
- pq_rescore="none": rank by the fused ADC scores alone (kernel 3,
  ``adc_scan_topk_skew_kernel``; kernel 4 with ``--sorted-coarse``);
- pq_rescore="host": the top ``--cand`` ADC candidates rescored on the host
  against an int8 mirror in RAM (on by default at ≤ 50M rows), or in raw
  memmap files with ``--mirror-mmap``.

The scans are timed eagerly (:class:`~crs_tpu_torch.tools.timing.EagerCall`:
CUDA events, the host clock beside them as ``host_scan_ms``; the mean of 5
scans after a warm one), where the JAX tool times its jitted scans: a scan
reads its flagged-pair count on the host, which a CUDA graph cannot capture.

Usage:
  python -m crs_tpu_torch.tools.bench_pq_serving --rows 40000000
  python -m crs_tpu_torch.tools.bench_pq_serving --rows 100000000 --no-host-mirror
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .timing import EagerCall

__all__ = ["CHUNK", "GENERATOR_KEY", "ClusteredCorpus", "generator_name", "train_codebooks",
           "encode_chunks", "ground_truth", "make_scan", "host_rescore", "recall",
           "load_cache", "main"]

CHUNK = 1_000_000
SEED = 0  # the JAX tool's PRNGKey(0)
TRAIN_ROWS = 262_144
GENERATOR_KEY = "corpus_generator"  # the codes cache's name of the generator that drew the corpus
# the generators' streams: (SEED, role[, chunk]) → a seed, one stream a role
_MIX, _CENTERS, _QUERIES, _CHUNKS, _TRAIN = 0, 1, 2, 3, 7
_SCAN_REPS = 5

Scan = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def generator_name(dev: torch.device) -> str:
    """What drew the corpus on ``dev``: the cache key's value."""
    return f"torch.Generator({dev.type}) seeded by SeedSequence(({SEED}, role, chunk))"


def _generator(dev: torch.device, *key: int) -> torch.Generator:
    seed = int(np.random.SeedSequence((SEED, *key)).generate_state(1, np.uint32)[0])
    return torch.Generator(device=dev).manual_seed(seed)


class ClusteredCorpus:
    """The tool's corpus: ``centers`` normalized cluster centers, rows a
    center plus ``sigma``·(noise @ mix), normalized; each chunk of
    ``chunk_rows`` drawn again on demand from its own generator."""

    def __init__(self, dim: int, centers: int, sigma: float, dev: torch.device,
                 chunk_rows: int = CHUNK):
        self.dim, self.sigma, self.dev, self.chunk_rows = dim, sigma, dev, chunk_rows
        spec = torch.exp(-torch.arange(dim, dtype=torch.float32, device=dev) / 20.0)
        self.mix = torch.randn((dim, dim), generator=_generator(dev, _MIX), device=dev) * (
            spec[None, :] / dim ** 0.5)
        c = torch.randn((centers, dim), generator=_generator(dev, _CENTERS), device=dev)
        c = (c @ self.mix) * 3.0
        self.centers = c / torch.linalg.vector_norm(c, dim=1, keepdim=True)

    def chunk(self, ci: int) -> torch.Tensor:
        """Rows [ci·chunk_rows, (ci + 1)·chunk_rows) as [chunk_rows, dim] f32."""
        g = _generator(self.dev, _CHUNKS, ci)
        assign = torch.randint(0, self.centers.shape[0], (self.chunk_rows,), generator=g,
                               device=self.dev)
        noise = torch.randn((self.chunk_rows, self.dim), generator=g, device=self.dev) @ self.mix
        x = self.centers[assign] + self.sigma * noise
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)

    def queries(self, c0: torch.Tensor, batch: int) -> torch.Tensor:
        """Chunk 0's first ``batch`` rows plus 0.05 noise, normalized."""
        qn = torch.randn((batch, self.dim), generator=_generator(self.dev, _QUERIES),
                         device=self.dev)
        q = c0[:batch] + 0.05 * qn
        return q / torch.linalg.vector_norm(q, dim=1, keepdim=True)


def train_codebooks(c0: torch.Tensor, subspaces: int, coarse: int, eta: Optional[float]):
    """Residual PQ trained on ``c0``'s first 262,144 rows, as the JAX tool trains it."""
    from ..ops.pq import train_residual_pq

    return train_residual_pq(_generator(c0.device, _TRAIN), c0[:TRAIN_ROWS],
                             num_subspaces=subspaces, coarse_clusters=coarse, num_iters=12,
                             opq_iters=2, coarse_iters=8, aniso_eta=eta)


def encode_chunks(rpq, chunk_fn: Callable[[int], torch.Tensor], nchunks: int, chunk_rows: int,
                  eta: Optional[float], ext: np.ndarray, mirror=None, mirror_scales=None,
                  report=None) -> None:
    """Every chunk's [rows, M+2] codes into ``ext`` and, given arrays for
    them, its int8 mirror rows and scales (the JAX tool's ``quant``:
    ``scalar_quantize``)."""
    from ..ops.pq import residual_codes_ext, residual_pq_encode
    from ..ops.quant import scalar_quantize

    t0 = time.perf_counter()
    for ci in range(nchunks):
        x = chunk_fn(ci)
        rows = slice(ci * chunk_rows, (ci + 1) * chunk_rows)
        ext[rows] = residual_codes_ext(*residual_pq_encode(rpq, x, eta)).cpu().numpy()
        if mirror is not None:
            qc, qs = scalar_quantize(x)
            mirror[rows] = qc.cpu().numpy()
            mirror_scales[rows] = qs.cpu().numpy()
        if report and (ci + 1) % 10 == 0:
            report(f"encoded {ci + 1}/{nchunks} chunks ({time.perf_counter() - t0:.0f}s)")


def ground_truth(chunk_fn: Callable[[int], torch.Tensor], nchunks: int, chunk_rows: int,
                 queries: torch.Tensor, k: int) -> np.ndarray:
    """The exact fp32 top-k ids [B, k] over every chunk: each chunk's top-k
    on the device, merged on the host as the JAX tool merges them."""
    from ..ops.topk import topk_stable

    b = queries.shape[0]
    best_s = np.full((b, 0), -np.inf, np.float32)
    best_i = np.zeros((b, 0), np.int64)
    for ci in range(nchunks):
        s_c, i_c = topk_stable(queries @ chunk_fn(ci).T, k)
        best_s = np.concatenate([best_s, s_c.cpu().numpy()], axis=1)
        best_i = np.concatenate([best_i, i_c.cpu().numpy().astype(np.int64) + ci * chunk_rows],
                                axis=1)
        if best_s.shape[1] > 4 * k:  # keep the running top-k small
            sel = np.argsort(-best_s, axis=1)[:, :k]
            best_s = np.take_along_axis(best_s, sel, axis=1)
            best_i = np.take_along_axis(best_i, sel, axis=1)
    sel = np.argsort(-best_s, axis=1)[:, :k]
    return np.take_along_axis(best_i, sel, axis=1)


def make_scan(rpq, ext_host: np.ndarray, n: int, cand: int, block_size: int, dev,
              sorted_coarse: bool = False, coarse: int = 0, batch: int = 0,
              report=None) -> Tuple[Scan, int]:
    """(queries → (ADC scores, ids) [B, cand] of the fused residual-PQ scan
    over the rows, the rows' device bytes). With ``sorted_coarse`` the rows
    are sorted by coarse id and scanned by kernel 4 in the plan of ``batch``
    queries; ids map back through the sort."""
    from ..ops.scan import scan_topk_residual_pq_adc, scan_topk_residual_pq_adc_sorted

    m2 = ext_host.shape[1]
    if not sorted_coarse:
        ext_dev = torch.from_numpy(ext_host).to(dev)

        def scan(q):
            return scan_topk_residual_pq_adc(rpq.rotation, rpq.coarse, rpq.codebook.centroids,
                                             ext_dev, q, cand, n, block_size)

        return scan, ext_dev.numel()
    from ..ops.pq import sort_codes_by_coarse
    from ..ops.scan import adc_auto_group, plan_sorted_coarse_windows

    t0 = time.perf_counter()
    ext_sorted, perm, counts = sort_codes_by_coarse(ext_host, coarse)
    group = adc_auto_group(n, batch, block_size, m2)
    wbase = plan_sorted_coarse_windows(counts, n, block_size, group)
    if wbase is None:
        raise AssertionError("layout too fragmented for the 512-id sorted window")
    wbase_dev = torch.from_numpy(wbase).to(dev)
    perm_dev = torch.from_numpy(perm).long().to(dev)
    ext_dev = torch.from_numpy(ext_sorted).to(dev)
    if report:
        report(f"sorted layout in {time.perf_counter() - t0:.1f}s "
               f"(group={group}, tiles={wbase.shape[0]})")

    def scan(q):
        s, i = scan_topk_residual_pq_adc_sorted(
            rpq.rotation, rpq.coarse, rpq.codebook.centroids, ext_dev, wbase_dev, q, cand, n,
            block_size, group=group)
        return s, torch.where(i >= 0, perm_dev[i.clamp_min(0)], -1)

    return scan, ext_dev.numel()


def host_rescore(mirror, mirror_scales, queries: np.ndarray, adc_s: np.ndarray,
                 adc_i: np.ndarray, k: int, n: int) -> np.ndarray:
    """The ADC candidates rescored against the host int8 mirror: the top-k
    ids [B, k] (masked candidates keep -1e30)."""
    rows = np.clip(adc_i, 0, n - 1)
    vecs = mirror[rows].astype(np.float32) * mirror_scales[rows][..., None]
    exact = np.einsum("bd,bcd->bc", queries, vecs)
    exact = np.where(adc_s <= -1e29, -1e30, exact)
    sel = np.argsort(-exact, axis=1)[:, :k]
    return np.take_along_axis(adc_i, sel, axis=1)


def recall(pred: np.ndarray, truth: np.ndarray, k: int, width: Optional[int] = None) -> float:
    """Mean over the queries of |pred[:, :width] ∩ truth| / k."""
    width = width or k
    return float(np.mean([len(set(pred[b, :width]) & set(truth[b])) / k
                          for b in range(truth.shape[0])]))


def load_cache(path: str, n: int, m: int, eta: Optional[float], dev):
    """The npz codes cache: (its arrays, the ResidualPQ on ``dev``), or None
    when the file is unreadable (a killed run's: it is removed and rebuilt).
    Raises when it holds another corpus's codes: written without
    ``corpus_generator`` (the JAX tool's), by another generator, or for
    another row count, M or η."""
    from ..ops.pq import PQCodebook, ResidualPQ

    try:
        data = np.load(path)
        data["rows"]  # force the zip directory read now
    except (OSError, ValueError, KeyError) as e:  # truncated by a killed run: rebuild
        print(f"codes cache {path} unreadable ({e}); rebuilding", file=sys.stderr)
        Path(path).unlink()
        return None
    if GENERATOR_KEY not in data:
        raise ValueError(f"codes cache {path} has no {GENERATOR_KEY!r}: it was not written by "
                         "this tool, and its codes belong to another corpus")
    if str(data[GENERATOR_KEY]) != generator_name(dev):
        raise ValueError(f"codes cache {path} holds the corpus of {str(data[GENERATOR_KEY])!r}, "
                         f"not of {generator_name(dev)!r}")
    if int(data["rows"]) != n or int(data["m"]) != m:
        raise ValueError(f"codes cache {path} is for rows={int(data['rows'])} "
                         f"m={int(data['m'])}, asked rows={n} m={m}")
    cached_eta = float(data["aniso_eta"]) if "aniso_eta" in data else 0.0
    if cached_eta != (eta or 0.0):
        raise ValueError(f"codes cache trained with aniso_eta={cached_eta}, asked {eta or 0.0}")
    put = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    rpq = ResidualPQ(rotation=put(data["rotation"]), coarse=put(data["coarse"]),
                     codebook=PQCodebook(put(data["centroids"])))
    return data, rpq


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=40_000_000)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--centers", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--cand", type=int, default=100)
    ap.add_argument("--subspaces", type=int, default=12)
    ap.add_argument("--coarse", type=int, default=2048)
    ap.add_argument("--sigma", type=float, default=0.35)
    ap.add_argument("--host-mirror", dest="host_mirror", action="store_true", default=None)
    ap.add_argument("--no-host-mirror", dest="host_mirror", action="store_false")
    ap.add_argument("--block-size", type=int, default=2048)
    ap.add_argument("--codes-cache", default=None,
                    help="npz path: save/load the encoded ext codes + rpq + mirror so a rerun "
                         "skips the encode")
    ap.add_argument("--aniso-eta", default="0",
                    help="aniso η for codebook training/encode; 0=isotropic, "
                         "'auto'=ScaNN η(T=0.2, dim) — see ops/pq.py")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--sorted-coarse", action="store_true",
                    help="IVF layout: sort rows by coarse id and scan with the per-tile "
                         "512-id window kernel (kernel 4)")
    ap.add_argument("--mirror-mmap", default=None,
                    help="back the host rescore mirror with raw memmap files at this path "
                         "prefix (host-rescored serving past RAM: pages from disk)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else args.device)
    n, d, m = args.rows, args.dim, args.subspaces
    host_mirror = args.host_mirror
    if host_mirror is None:
        host_mirror = n <= 50_000_000
    if n % CHUNK:
        raise ValueError(f"--rows must be a multiple of {CHUNK}")
    nchunks = n // CHUNK
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={kind} rows={n} dim={d} M={m} coarse={args.coarse}", file=sys.stderr)

    def log(line: str) -> None:
        print(line, file=sys.stderr)

    from ..ops.pq import aniso_eta_from_threshold

    if args.aniso_eta == "auto":
        eta = aniso_eta_from_threshold(0.2, d)
    else:
        eta = float(args.aniso_eta)
        eta = eta if eta > 1.0 else None

    t0 = time.perf_counter()
    corpus = ClusteredCorpus(d, args.centers, args.sigma, dev, CHUNK)
    c0 = corpus.chunk(0)
    queries = corpus.queries(c0, args.batch)
    chunk_fn = lambda ci: corpus.chunk(ci) if ci else c0  # noqa: E731
    cache = args.codes_cache
    loaded = load_cache(cache, n, m, eta, dev) if cache and Path(cache).exists() else None
    mirror = mirror_scales = None
    if loaded is not None:
        data, rpq = loaded
        ext_host = data["ext"]
        if host_mirror and "mirror" in data:
            mirror, mirror_scales = data["mirror"], data["mirror_scales"]
        elif host_mirror and args.mirror_mmap:
            mm = args.mirror_mmap
            if Path(mm + ".codes.i8").exists():  # a memmapped mirror persists beside the cache
                mirror = np.memmap(mm + ".codes.i8", np.int8, mode="r", shape=(n, d))
                mirror_scales = np.memmap(mm + ".scales.f32", np.float32, mode="r", shape=(n,))
            else:  # the cache predates the mirror: draw and quantize the chunks again
                mirror = np.memmap(mm + ".codes.i8", np.int8, mode="w+", shape=(n, d))
                mirror_scales = np.memmap(mm + ".scales.f32", np.float32, mode="w+", shape=(n,))
                from ..ops.quant import scalar_quantize

                t1 = time.perf_counter()
                for ci in range(nchunks):
                    qc, qs = scalar_quantize(chunk_fn(ci))
                    mirror[ci * CHUNK:(ci + 1) * CHUNK] = qc.cpu().numpy()
                    mirror_scales[ci * CHUNK:(ci + 1) * CHUNK] = qs.cpu().numpy()
                mirror.flush()
                mirror_scales.flush()
                log(f"backfilled memmap mirror in {time.perf_counter() - t1:.0f}s")
        host_mirror = mirror is not None
        log(f"loaded codes cache {cache}")
    else:
        rpq = train_codebooks(c0, m, args.coarse, eta)
        log(f"trained rpq in {time.perf_counter() - t0:.1f}s (aniso_eta={eta})")
        ext_host = np.empty((n, m + 2), np.uint8)
        if host_mirror and args.mirror_mmap:
            mirror = np.memmap(args.mirror_mmap + ".codes.i8", np.int8, mode="w+", shape=(n, d))
            mirror_scales = np.memmap(args.mirror_mmap + ".scales.f32", np.float32, mode="w+",
                                      shape=(n,))
        elif host_mirror:
            mirror, mirror_scales = np.empty((n, d), np.int8), np.empty((n,), np.float32)
        t0 = time.perf_counter()
        encode_chunks(rpq, chunk_fn, nchunks, CHUNK, eta, ext_host, mirror, mirror_scales, log)
        log(f"encode total {time.perf_counter() - t0:.1f}s")
        if cache:
            # a memmapped mirror is its own cache (raw files persist)
            extra = ({"mirror": mirror, "mirror_scales": mirror_scales}
                     if host_mirror and not args.mirror_mmap else {})
            # atomic: a killed run must not leave a truncated npz behind
            np.savez(cache + ".tmp.npz", rows=n, m=m, ext=ext_host, aniso_eta=eta or 0.0,
                     rotation=rpq.rotation.cpu().numpy(), coarse=rpq.coarse.cpu().numpy(),
                     centroids=rpq.codebook.centroids.cpu().numpy(),
                     **{GENERATOR_KEY: generator_name(dev)}, **extra)
            os.replace(cache + ".tmp.npz", cache)
            log(f"saved codes cache {cache}")

    t0 = time.perf_counter()
    truth = ground_truth(chunk_fn, nchunks, CHUNK, queries, args.k)
    log(f"ground truth in {time.perf_counter() - t0:.1f}s")

    scan, hbm_bytes = make_scan(rpq, ext_host, n, args.cand, args.block_size, dev,
                                args.sorted_coarse, args.coarse, args.batch, log)
    log(f"serving footprint in device memory: {hbm_bytes / 1e9:.2f} GB "
        f"({m + 2} B/vec x {n / 1e6:.0f}M rows)")

    def scans():
        for _ in range(_SCAN_REPS):
            res = scan(queries)
        return res

    from ..ops.scan import STATS

    call = EagerCall(scans, dev)
    call.run()  # warm: the first call loads the kernel and allocates
    repairs, fallbacks = STATS.repairs, STATS.fallbacks
    seconds, (adc_s, adc_i) = call.run()
    scan_s, host_s = seconds / _SCAN_REPS, call.host_seconds / _SCAN_REPS
    log(f"scan launches {dict(call.last_run)}, repairs {STATS.repairs - repairs}, "
        f"exact fallbacks {STATS.fallbacks - fallbacks} in {_SCAN_REPS} scans")
    adc_i_np, adc_s_np = adc_i.cpu().numpy(), adc_s.cpu().numpy()
    out = {
        "rows": n, "dim": d, "bytes_per_vec_hbm": m + 2,
        "hbm_gb": round(hbm_bytes / 1e9, 2),
        "scan_ms": round(scan_s * 1e3, 2),
        "ms_per_query": round(scan_s * 1e3 / args.batch, 4),
        "recall_at_k_none": recall(adc_i_np, truth, args.k),
        "recall_k_in_cand": recall(adc_i_np, truth, args.k, width=args.cand),
        "cand": args.cand, "k": args.k,
        "sorted_coarse": bool(args.sorted_coarse),
    }
    if host_mirror:
        t0 = time.perf_counter()
        host_pred = host_rescore(mirror, mirror_scales, queries.cpu().numpy(), adc_s_np,
                                 adc_i_np, args.k, n)
        out["host_rescore_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
        out["recall_at_k_host"] = recall(host_pred, truth, args.k)
        out["host_mirror_gb"] = round((mirror.nbytes + mirror_scales.nbytes) / 1e9, 2)
    out.update(host_scan_ms=round(host_s * 1e3, 2), device=kind)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
