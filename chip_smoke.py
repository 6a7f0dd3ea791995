#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``crs_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Phases, each printed as one JSON line (name, seconds, what was compared and
the largest difference); any failure raises and exits non-zero:

1. build    — compile the CUDA int8 scan kernel (nvcc, sm_90a) and the
              native featurizer (g++), both at once, from the sources here;
2. kernel   — the kernel against its plain torch version on the card:
              (a) 1,048,576 × 384 random unit vectors, 328 queries, k = 64;
              (b) a clustered corpus with kb = 2 that forces targeted repairs
                  and the over-budget exact fallback;
              (c) padding (valid_n < N), a `where` row mask and exact ties;
3. bench    — the bench.py slice on the held-out corpus: chunk, hashed
              encoder, int8 store, retrieve_batch_fused over 328 queries,
              checked against the standard (host-rerank) retrieve;
4. full     — a 1,048,576-row int8 store built through the port's encoder
              from synthetic texts; retrieve_batch_fused at batch 328 through
              the kernel (launch count must rise), timed with CUDA events,
              plus the kernel's own time, its plain version's and its bound.

Then the kernel table line, the card's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no
result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(REPO, "results", "selftrained", "heldout_corpus.txt")
QA = os.path.join(REPO, "results", "selftrained", "heldout_qa.json")

FULL_ROWS = 1 << 20
DIM = 384
BATCH = 328
CAND_K = 64  # bench settings: rescore_k=64 ≥ fetch_k → the scan is asked for 64
BENCH_CHUNKER = {"strategy": "semantic", "chunk_size": 160, "chunk_overlap": 30,
                 "min_chunk_size": 10}
BENCH_RETRIEVER = {"top_k": 3, "similarity_threshold": 0.05, "rerank": True,
                   "diversity_penalty": 0.1}
BENCH_STORE = {"format": "int8", "block_size": 256, "rescore_k": 64}

# H100 SXM peaks (NVIDIA data sheet, dense): HBM rate and int8 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1.979e15


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Phase:
    """Times one phase and prints its JSON line on success."""

    def __init__(self, name: str):
        self.name, self.info = name, {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            emit({"phase": self.name, "seconds": round(time.perf_counter() - self.t0, 3),
                  **self.info})
        return False


def compare_partials(kernel_out, plain_out):
    """Ids identical, scores within 1e-6 relative; returns the max abs diff."""
    import torch

    (ks, ki), (ps, pi) = kernel_out, plain_out
    if not torch.equal(ki.cpu(), pi.cpu()):
        bad = int((ki.cpu() != pi.cpu()).sum())
        raise AssertionError(f"kernel ids differ from the plain version at {bad} entries")
    diff = (ks.double() - ps.double()).abs()
    if bool((diff > 1e-6 * ps.double().abs()).any()):
        raise AssertionError(f"kernel scores differ by up to {float(diff.max())}")
    return float(diff.max()) if diff.numel() else 0.0


def partial_inputs(codes, scales, queries, valid_n, row_mask=None):
    """The kernel's operands as ``scan_topk_int8`` builds them."""
    import torch

    from crs_tpu_torch.ops.quant import scalar_quantize
    from crs_tpu_torch.ops.scan import BLOCK_ROWS, QUERY_TILE, _pad_rows
    from crs_tpu_torch.ops.topk import NEG_INF

    q_codes, q_scales = scalar_quantize(queries)
    q_codes = _pad_rows(q_codes, QUERY_TILE)
    vecs = _pad_rows(codes, BLOCK_ROWS)
    vs = _pad_rows(scales, BLOCK_ROWS)
    allowed = torch.arange(vecs.shape[0], device=codes.device) < valid_n
    if row_mask is not None:
        allowed = allowed & _pad_rows(row_mask, vecs.shape[0])
    bias = torch.where(allowed, 0.0, NEG_INF).float()
    return q_codes, vecs, vs, bias


def device_ms(dev, fn, iters: int, warmup: int = 1) -> float:
    """Mean ms per call: CUDA events around ``iters`` calls on the card (the
    host clock on the CPU, for rehearsals)."""
    import torch

    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1000 / iters
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_profile(fn, batch_ms: float, top: int = 8) -> dict:
    """One call under torch.profiler: device time by kernel (the CUDA-side
    events only, so no op's time counts twice) and the device's busy share
    of ``batch_ms``. Returns {"not measured": reason} when the profiler
    records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            times[ev.key] = ev.self_device_time_total / 1e3
    if not times:
        return {"not measured": "the profiler recorded no device time"}
    busy = sum(times.values())
    ranked = sorted(times.items(), key=lambda kv: -kv[1])[:top]
    return {"device_busy_ms": busy, "device_busy_share": busy / batch_ms,
            "top_ms": {k[:80]: v for k, v in ranked}}


# -- phases --------------------------------------------------------------------

def phase_build(ph: Phase) -> None:
    from concurrent.futures import ThreadPoolExecutor

    from crs_tpu_torch.ops.scan import build_kernel
    from crs_tpu_torch.rag.hashed_features import build_native

    with ThreadPoolExecutor(max_workers=2) as pool:
        kernel_f, native_f = pool.submit(build_kernel), pool.submit(build_native)
        kernel, native = kernel_f.result(), native_f.result()
    ptxas = [ln.strip() for ln in kernel.log.splitlines()
             if "registers" in ln or "spill" in ln]
    ph.info.update({"cuda_kernel_build_s": round(kernel.seconds, 3),
                    "native_featurizer_build_s": round(native.seconds, 3),
                    "ptxas": ptxas})


def phase_kernel(ph: Phase, dev, seed: int, rows: int) -> float:
    import numpy as np
    import torch

    from crs_tpu_torch.ops.quant import _int8_topk_dense, scalar_quantize
    from crs_tpu_torch.ops.scan import (
        STATS, _default_kb_repair, block_topk_int8, block_topk_int8_plain, scan_topk_int8,
    )

    max_err = 0.0
    # (a) main-path shape, random unit vectors from the seed
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((rows, DIM), generator=g, device=dev)
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    codes, scales = scalar_quantize(x)
    del x
    q = torch.randn((BATCH, DIM), generator=g, device=dev)
    q /= torch.linalg.vector_norm(q, dim=1, keepdim=True)
    ops = partial_inputs(codes, scales, q, rows)
    kb = _default_kb_repair(CAND_K, ops[1].shape[0] // 256, BATCH, 256)
    max_err = max(max_err, compare_partials(block_topk_int8(*ops, kb),
                                            block_topk_int8_plain(*ops, kb)))
    s, i = scan_topk_int8(codes, scales, q, CAND_K, rows)
    ds, di = _int8_topk_dense(codes, scales, q, CAND_K, rows)
    if not torch.equal(i, di):
        raise AssertionError("(a) scan top-k ids differ from the exact dense int8 top-k")
    a_err = float((s - ds).abs().max())
    if a_err > 1e-6 * float(ds.abs().max()):
        raise AssertionError(f"(a) scan scores differ from the dense ones by {a_err}")
    ph.info["a"] = {"rows": rows, "dim": DIM, "batch": BATCH, "k": CAND_K, "kb": kb,
                    "partials": "kernel == plain", "topk_vs_dense_max_abs": a_err}
    del codes, scales, ops

    # (b) clustered: every query owns a hot block → targeted repair, then the
    # over-budget fallback (tests/test_pallas_scan.py's construction)
    rng = np.random.default_rng(seed)
    n, d, b, k = 4096, 64, 16, 40
    base = rng.standard_normal((n, d)).astype(np.float32)
    qb = rng.standard_normal((b, d)).astype(np.float32)
    for qi in range(b):
        st = (256 * qi) % (n - 60)
        base[st:st + 50] = qb[qi][None] * 10 + 0.01 * rng.standard_normal((50, d))
    mask = rng.random(n) < 0.5
    codes_c, scales_c = scalar_quantize(torch.from_numpy(base))
    cases = {"repair": (256, None), "fallback": (4, None), "repair_masked": (256, mask)}
    counts = {}
    for name, (repair, m) in cases.items():
        m_cpu = None if m is None else torch.from_numpy(m)
        STATS.reset()
        s_dev, i_dev = scan_topk_int8(codes_c.to(dev), scales_c.to(dev), torch.from_numpy(qb).to(dev),
                                      k, n, kb=2, repair=repair,
                                      row_mask=None if m_cpu is None else m_cpu.to(dev))
        counts[name] = {"launches": STATS.launches, "repairs": STATS.repairs,
                        "fallbacks": STATS.fallbacks}
        s_ref, i_ref = scan_topk_int8(codes_c, scales_c, torch.from_numpy(qb), k, n, kb=2,
                                      repair=repair, row_mask=m_cpu)
        if not torch.equal(i_dev.cpu(), i_ref):
            raise AssertionError(f"(b) {name}: ids differ from the plain version")
        err = float((s_dev.cpu() - s_ref).abs().max())
        if err > 1e-6 * float(s_ref.abs().max()):
            raise AssertionError(f"(b) {name}: scores differ by {err}")
        max_err = max(max_err, err)
    if counts["repair"]["repairs"] < 1 or counts["fallback"]["fallbacks"] < 1:
        raise AssertionError(f"(b) repair/fallback paths did not run: {counts}")
    ph.info["b"] = {"rows": n, "dim": d, "batch": b, "k": k, "kb": 2, "counts": counts}

    # (c) padding (valid_n < N), a row mask and exact ties (duplicated rows)
    n, d, b, k = 20000, 128, 40, 16
    xs = rng.standard_normal((n, d)).astype(np.float32)
    xs[10000:10100] = xs[0:100]  # exact duplicates → exactly tied scores
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    qs = xs[:b].copy()
    valid_n = n - 300
    m = rng.random(n) < 0.7
    m[:b] = True
    codes_t, scales_t = scalar_quantize(torch.from_numpy(xs))
    m_t = torch.from_numpy(m)
    ops_dev = partial_inputs(codes_t.to(dev), scales_t.to(dev), torch.from_numpy(qs).to(dev),
                             valid_n, m_t.to(dev))
    max_err = max(max_err, compare_partials(block_topk_int8(*ops_dev, 4),
                                            block_topk_int8_plain(*ops_dev, 4)))
    s_dev, i_dev = scan_topk_int8(codes_t.to(dev), scales_t.to(dev), torch.from_numpy(qs).to(dev),
                                  k, valid_n, row_mask=m_t.to(dev))
    s_ref, i_ref = scan_topk_int8(codes_t, scales_t, torch.from_numpy(qs), k, valid_n,
                                  row_mask=m_t)
    if not torch.equal(i_dev.cpu(), i_ref):
        raise AssertionError("(c) ids differ from the plain version")
    if int(i_ref.max()) >= valid_n or not bool(m_t[i_ref].all()):
        raise AssertionError("(c) padding or masked rows were returned")
    err = float((s_dev.cpu() - s_ref).abs().max())
    max_err = max(max_err, err)
    ties = int(sum(len(set(r) & set(range(10000, 10100))) for r in i_ref.tolist()))
    ph.info["c"] = {"rows": n, "valid_n": valid_n, "masked_out": int((~m).sum()), "k": k,
                    "tied_duplicates_in_topk": ties, "max_abs": err}
    ph.info["max_abs_err"] = max_err
    return max_err


def _questions():
    with open(QA) as f:
        qs = [x["question"] for x in json.load(f)]
    return (qs * math.ceil(BATCH / len(qs)))[:BATCH]


def phase_bench(ph: Phase, dev) -> None:
    import torch

    from crs_tpu_torch.rag import (
        ContextRetriever, DocumentProcessor, EmbeddingModel, TextChunker, VectorStore,
    )

    pages = DocumentProcessor({}).process_file(CORPUS)
    ck = TextChunker(BENCH_CHUNKER)
    chunks = [c for t, p in pages for c in ck.chunk(t, page_number=p)]
    em = EmbeddingModel({"backend": "hashed", "embedding_dim": DIM}, device=dev)
    store = VectorStore(BENCH_STORE, device=dev)
    store.create_index(chunks, em.embed_chunks(chunks))
    retr = ContextRetriever(store, em, BENCH_RETRIEVER)
    batch = _questions()
    for _ in range(2):
        fused = retr.retrieve_batch_fused(batch)
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        fused = retr.retrieve_batch_fused(batch)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    answered = sum(1 for r in fused if r)
    if answered < 0.8 * len(fused):  # 9 of the 10 held-out questions clear the threshold
        raise AssertionError(f"bench: only {answered} of {len(fused)} queries got context")
    std = retr.retrieve_batch(batch)
    score_diff = 0.0
    for s, f in zip(std, fused):
        if [c["id"] for c in s] != [c["id"] for c in f]:
            raise AssertionError(f"bench: fused ids {[c['id'] for c in f]} != standard "
                                 f"{[c['id'] for c in s]}")
        for cs, cf in zip(s, f):
            score_diff = max(score_diff, abs(cs["score"] - cf["score"]))
    if score_diff > 1e-4:
        raise AssertionError(f"bench: fused scores differ from standard by {score_diff}")
    ph.info.update({"chunks": len(chunks), "batch": len(batch), "answered": answered,
                    "ms_per_query": dt * 1000 / (iters * len(batch)),
                    "compared": "fused vs standard retrieve: ids equal",
                    "max_score_diff": score_diff})


def synthetic_corpus(rng, rows: int, n_topics: int = 1024, topic_words: int = 48,
                     doc_words: int = 24, common: int = 512):
    """Texts over a fixed vocabulary: each doc draws most words from its
    topic's list and a few from a shared list; queries draw from one topic,
    so each query shares words with ~rows/n_topics docs."""
    import numpy as np

    vocab = np.array([f"t{t}w{j}" for t in range(n_topics) for j in range(topic_words)]
                     + [f"c{j}" for j in range(common)])
    topic = rng.integers(0, n_topics, rows)
    words = topic[:, None] * topic_words + rng.integers(0, topic_words, (rows, doc_words))
    shared = n_topics * topic_words + rng.integers(0, common, (rows, 4))
    grid = vocab[np.concatenate([words, shared], 1)]
    texts = [" ".join(r) for r in grid.tolist()]
    q_topic = rng.integers(0, n_topics, BATCH)
    q_words = q_topic[:, None] * topic_words + rng.integers(0, topic_words, (BATCH, 8))
    queries = [" ".join(r) for r in vocab[q_words].tolist()]
    return texts, queries


def phase_full(ph: Phase, dev, seed: int, rows: int, max_err: float) -> dict:
    import numpy as np
    import torch

    from crs_tpu_torch.ops.quant import _int8_topk_dense, int8_topk
    from crs_tpu_torch.ops.scan import (
        STATS, _default_kb_repair, block_topk_int8, block_topk_int8_plain,
    )
    from crs_tpu_torch.rag import ContextRetriever, EmbeddingModel, VectorStore

    rng = np.random.default_rng(seed + 1)
    t0 = time.perf_counter()
    texts, queries = synthetic_corpus(rng, rows)
    t_texts = time.perf_counter() - t0
    em = EmbeddingModel({"backend": "hashed", "embedding_dim": DIM}, device=dev)
    store = VectorStore(BENCH_STORE, device=dev)
    t0 = time.perf_counter()
    emb = em.embed_chunks(texts)
    store.create_index(texts, emb)
    del emb
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_index = time.perf_counter() - t0
    retr = ContextRetriever(store, em, BENCH_RETRIEVER)
    t0 = time.perf_counter()
    retr._ensure_presence()
    t_presence = time.perf_counter() - t0

    # the main path: counts to 0 just before, read just after
    STATS.reset()
    warmup, iters = 2, 10
    out = {}

    def serve():
        out["results"] = retr.retrieve_batch_fused(queries)

    batch_ms = device_ms(dev, serve, iters=iters, warmup=warmup)
    results = out["results"]
    launches = STATS.launches
    main_counts = {"launches": launches, "repairs": STATS.repairs, "fallbacks": STATS.fallbacks}
    if launches < warmup + iters:
        raise AssertionError(f"the scan kernel launched {launches} times in "
                             f"{warmup + iters} main-path batches")
    empty = sum(1 for r in results if not r)
    if empty:
        raise AssertionError(f"full: {empty} of {len(results)} queries returned no context")

    # the scan through the kernel against the exact dense int8 top-k
    q_emb = em.embed(queries)
    s, i = int8_topk(store._codes, store._scales, q_emb, 6, store.n, rescore_k=64)
    ds, di = _int8_topk_dense(store._codes, store._scales, q_emb, 6, store.n, rescore_k=64)
    if not torch.equal(i, di):
        raise AssertionError("full: scan + rescore ids differ from the dense path")
    rescore_err = float((s - ds).abs().max())

    # where one batch's time goes: host pieces by the host clock, the device
    # by the profiler (outside the counted main-path run)
    t0 = time.perf_counter()
    em.embed(queries)
    torch.cuda.synchronize()
    t_embed = (time.perf_counter() - t0) * 1000
    t0 = time.perf_counter()
    retr._query_token_ids(queries)
    t_tokens = (time.perf_counter() - t0) * 1000
    profile = device_profile(serve, batch_ms)

    # the kernel alone at this shape, its plain version, and its bound
    ops = partial_inputs(store._codes, store._scales, q_emb, store.n)
    nblocks = ops[1].shape[0] // 256
    kb = _default_kb_repair(CAND_K, nblocks, BATCH, 256)
    max_err = max(max_err, compare_partials(block_topk_int8(*ops, kb),
                                            block_topk_int8_plain(*ops, kb)))
    kernel_ms = device_ms(dev, lambda: block_topk_int8(*ops, kb), iters=10, warmup=2)
    plain_ms = device_ms(dev, lambda: block_topk_int8_plain(*ops, kb), iters=2, warmup=1)
    q_codes, vecs = ops[0], ops[1]
    nq = q_codes.shape[0] // 64
    bytes_moved = (vecs.numel() + 4 * vecs.shape[0] * 2 + q_codes.numel()
                   + nq * nblocks * kb * 64 * 8)
    int8_ops = 2 * BATCH * store.n * DIM
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = int8_ops / PEAK_INT8_OPS_PER_S * 1e3
    ph.info.update({
        "rows": store.n, "dim": DIM, "batch": BATCH,
        "host_setup_s": {"texts": round(t_texts, 3), "featurize_embed_index": round(t_index, 3),
                         "presence_ids": round(t_presence, 3)},
        "ms_per_batch": batch_ms, "ms_per_query": batch_ms / BATCH,
        "main_path_counts": main_counts,
        "breakdown": {"query_embed_ms": t_embed, "query_token_ids_ms": t_tokens,
                      "profile": profile},
        "rescore_vs_dense_max_abs": rescore_err,
        "kernel": {"kb": kb, "nblocks": nblocks, "ms": kernel_ms, "plain_ms": plain_ms,
                   "bytes": bytes_moved, "int8_ops": int8_ops,
                   "bound_ms": max(bytes_ms, ops_ms)},
    })
    return {
        "name": "int8_scan_topk", "route": "cuda",
        "source": "crs_tpu_torch/csrc/int8_scan_topk.cu",
        "replaces": "crs_tpu/ops/pallas_scan.py:172",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from crs_tpu_torch import resolve_device

    dev = resolve_device("cuda")
    t_start = time.perf_counter()
    with Phase("build") as ph:
        phase_build(ph)
    with Phase("kernel") as ph:
        max_err = phase_kernel(ph, dev, args.seed, FULL_ROWS)
    with Phase("bench") as ph:
        phase_bench(ph, dev)
    with Phase("full") as ph:
        row = phase_full(ph, dev, args.seed, FULL_ROWS, max_err)
    emit({"phase": "total", "seconds": round(time.perf_counter() - t_start, 3)})
    emit({"kernels": [row]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
