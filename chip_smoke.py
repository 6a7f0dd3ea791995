#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``crs_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--phases a,b,...]

Phases, each printed as one JSON line (name, seconds, what was compared and
the largest difference); any failure raises and exits non-zero:

1. build              — compile the eight CUDA sources (nvcc, sm_90a) and the
                        native featurizer (g++), all at once, from the sources here;
2. kernel             — the int8 scan kernel against its plain torch version:
                        (a) 1,048,576 × 384 random unit vectors, 328 queries, k = 64,
                            the main path's 256-row blocks; the kernel, its
                            dequantize + matmul + topk composition and its
                            torch._int_mm (cuBLAS int8) + topk composition timed
                            in turns, plain ms, bound; first a line with each
                            instantiation's registers, spills and shared memory;
                        (b) a clustered corpus with kb = 2 that forces targeted
                            repairs and the over-budget exact fallback;
                        (c) padding (valid_n < N), a `where` row mask and exact ties;
                        (d) INT8_EDGE_CASES (ragged D by 4-byte and byte offsets,
                            D past one query slice, kb = 32) and a corpus of one
                            repeated vector;
3. kernel_f32_bf16    — the float scan kernel (fp32 and bf16) against its plain
                        version at 1,048,576 × 384, B = 328 (scores within
                        rtol·(1+|s|), rtol 1e-5 fp32 / 1e-2 bf16; ids equal where
                        neighbouring scores are 1e-5·(1+|s|) apart), on the
                        edge cases of FLOAT_EDGE_CASES (ragged D, D = 4096,
                        odd query tiles, kb = 32, blocks of 256 and 4096,
                        masked blocks, ties) and through scan_topk on the
                        repair, fallback, padding, mask, tie and D = 100 cases;
                        the kernel and its composition in turns, bound, plain
                        ms; first a line with each instantiation's registers,
                        spills and shared memory;
4. kernel_adc         — both PQ ADC kernels (residual and plain) against their
                        plain version at 1,048,576 rows, M = 48, C = 2048,
                        B = 328, bit for bit, and on the same cases;
5. kernel_sorted_adc  — the sorted residual ADC kernel (kernel 4) against its
                        plain version, bit for bit, at 1,048,576 rows sorted by
                        coarse id (M = 48, C = 2048, B = 328, the plan's group),
                        against kernel 3 on the same rows (scores bit for bit),
                        both kernels' device ms in turns, and the scan's repair,
                        fallback, layout-budget, padding-tile, mask, hand-built-plan
                        and tie (1,200 equal rows across blocks and tiles) cases;
6. kernel_segmax      — the segment-max kernels (6: fp32 and bf16; 7: int8) at
                        1,048,576 × 384, B = 328, k = 10, block 2048 on a shuffled
                        clustered corpus: against their plain versions (int8 bit
                        for bit), the tiling's edge cases at small sizes (valid_n
                        inside a segment, blocks past it, odd query tiles, D = 32,
                        160, 512, 4096, blocks of 256 and 4096, exact ties), each
                        kernel and its library composition timed in turns
                        (int8: also torch._int_mm + segment max + topk),
                        through scan_topk_segmax / _int8 (counted), and recall@10
                        against the exact f32 top-10; first a line with each
                        instantiation's registers, spills and shared memory;
7. kernel_q4          — int4 and NF4 (kernels 8, 9: one tensor-core kernel, a
                        table each) against their plain versions at the 1b
                        widths, mistral-7b's MLP and N ∈ {128, 1024}, R ∈ {1, 3,
                        8, 17, 64}, and at groups of 2, 8 and 24 rows
                        (|kernel − plain| ≤ 1e-5·Σ|x·w|); device ms per launch
                        (torch.profiler), the two kinds timed in turns (int4,
                        NF4, NF4, int4) on the same codes and plan; plain and
                        library ms, bound, the plan and a sweep of plans;
8. kernel_decode_attn — the int8 decode-attention kernel (two launches over
                        chunks of S) against its plain version at B ∈ {1, 8},
                        Hkv 8, G 2, hd 128, S ∈ {2176, 4096}, partial masks and
                        an all-masked row (exact zeros), ms at each; and at G ∈
                        {1, 4, 8} × S ∈ {128, 2176, 4096}: a row masked but for
                        a window (whole chunks masked), an all-masked row, a
                        full row;
9. kernel_fused_mlp   — the fused MLP kernel against its plain version at
                        mistral-7b's MLP (H 4096, I 14336, chunk 1024), R ∈ {1,
                        3, 8}, and a small multi-chunk case: xq / hq codes equal
                        in ≥ 99.9 % of entries, the output within the flipped
                        codes' effect; device ms, each launch's µs (one
                        launch a call), plain ms, the unfused int8 route's
                        ms, bound;
10. gemv              — the decode weight-streaming tools (crs_tpu_torch/tools/):
                        their three kernels (gemv_probe.cu) against their plain
                        versions — the int4 probe at bench_q4_kernel's defaults
                        (R 32, K 2048, N 32000) with g 16, 8, 4, 64 and 256,
                        and at N 32004 (no TMA: 4-byte copies), every unpack
                        and fold (unfolded bit for bit, fold within
                        1e-5·Σ|x·w|, random scales so the tiled fold mapping
                        shows), the q8 GEMV at (R, d) 8/2048, 1/2048, 16/2048,
                        3/2048, 12/2048 and 8/4096, the row-major GEMV at
                        8/2048, 1/2048, 3/2048, 5/2048, 7/2048, 8/512 (one
                        chunk), 8/4096 and 8/8192 (its ring) — each kernel's
                        device ms with the weights past the L2, plain and
                        composition ms, bound; the one-call library times of
                        rows 14 (torch._weight_int8pack_mm at 8/2048), 8
                        (torch._weight_int4pack_mm at the chain's q4 layer,
                        beside kernel 8 there), 13 (torch._weight_int8pack_mm
                        on the transposed 2048 × 2048 weight at R 8) and 12
                        (torch._weight_int4pack_mm at R 32, N 32,000), or why
                        the card's torch has none or refuses the shape, each
                        held against the plain version; then both
                        tools with every variant at their defaults (CUDA
                        graphs; ms/chain, GB/s, bound, launches a chain; the
                        bench_chain_gemv chain is 96 layers of 2048 × 2048)
                        and kernel 8's q4 chain eagerly beside its graph;
11. tools             — the port's serving and scale tools and examples
                        (crs_tpu_torch/tools/, crs_tpu_torch/examples/), each through
                        its own main on the card: the quickstart on the repository's
                        PDF (16-token generations); bench_decode (1b, int4, int8 KV;
                        16 tokens, 2 runs) at batches 1 and 8; bench_prefill_mfu
                        (1b, bf16 and int8); bench_fused_mlp over 4 mistral-7b MLP
                        layers; bench_scale (both engines) at 2M rows;
                        bench_pq_serving at 2M rows unsorted, then
                        --sorted-coarse from the
                        first run's codes cache; the pq_serving example — each exits
                        0 with its JSON keys, kernels 1, 3, 4, 8, 10 and 11 counted on
                        their tools; the first scan of each shape held against its
                        plain version (int8 within 1e-6, ADC bit for bit); the device
                        ms of bench_scale's padding copy beside its scan at 10M rows;
12. quality           — the PQ recall-curve and retrieval-quality tools
                        (crs_tpu_torch/tools/), each through its own main on
                        the card: pq_recall_curve at 1M rows × 384 (M 12,
                        coarse 2048, cands 100, 200, 400) with the pallas
                        engine (kernel 3), then pallas_sorted (kernel 4) from
                        the same caches, and one scan of each under
                        torch.profiler; curve_report on both; plot_pq_curve
                        where matplotlib is installed (else its refusal);
                        ir_eval, quality_eval, oracle_bounds, quality_diag and
                        the three sweeps on the held-out corpus and questions;
                        the first scan of each shape held against its plain
                        version (bit for bit); ir_eval, quality_eval and
                        quality_diag held against their CPU runs;
13. faults            — ROADMAP §3's repairs at 8,192 rows: hashed stores at D =
                        100 and 3072 in fp32, bf16 and int8, residual pq and
                        pq_sorted stores at M = 64, each on its kernel (launch
                        counts) against the same store on the CPU; the ADC
                        kernels at M 64–320 bit for bit; the 1b model as int4
                        and nf4 at group_size 8 (113 kernel launches a decode
                        step, logits against the plain versions); int8-KV
                        decode steps at G 3, G 12, hd 256 and hd 640 against
                        the CPU, kernel 10 at hd 384 / 512 / 640 / 1024, G 16,
                        S 139,264; kernel 11 at chunks 64, 96, 40, 16,512 and
                        24,576; kernels 6 and 7 at D 40 / 100 / 4,104 and blocks
                        of 384, 8,192 and 16,384 rows; kernel 1 at blocks of 512
                        to 8,192 rows; kernels 2 (fp32, bf16) and 3 to 5 at
                        blocks of 128, 384 and 640 rows (ADC bit for bit) and
                        fp32 and pq stores of 128- and 640-row blocks, each on
                        its kernel; the cost of a ragged D at 1M rows;
14. bench             — the bench.py slice on the held-out corpus: chunk, hashed
                        encoder, int8 store, retrieve_batch_fused over 328 queries,
                        checked against the standard (host-rerank) retrieve;
15. full              — a 1,048,576-row int8 store built through the port's
                        encoder from synthetic texts; retrieve_batch_fused at batch
                        328 through the int8 kernel (launch count must rise), timed
                        with CUDA events, plus the kernel's own time and bound;
16. formats           — the first 524,288 of those texts and embeddings (cut
                        from 1M in PR 18) in an fp32, a bf16, a residual pq
                        and a plain pq store (config.json's store values):
                        retrieve_batch at batch 328 without and with PRF
                        (each format's kernel must launch), a `where`-filtered
                        search, the whole scan route held against its plain
                        version, each pq store built twice from one seed (same
                        bits), set-up seconds, device bytes per vector and
                        recall@3 against the fp32 exact top-3; a pq_sorted store
                        over the residual store's state must launch kernel 4
                        (not 3), never take the exact fallback, and return the
                        unsorted store's results;
17. add               — 65,536 rows added in 4,096-row calls to the 1M int8 and
                        524,288-row residual pq stores: ms per add, capacity,
                        the int8 store identical to create_index over the same
                        rows, the pq
                        codes against a CPU encode, a `where` search;
18. multi             — multi-device serving and training at world size 1 (a
                        one-rank NCCL group, every collective called): int8
                        and bf16 mesh stores over the full phase's 1M
                        embeddings, search_batch at batch 328, k 3, through
                        kernels 1 and 2 (counted), ids against the plain
                        shard body, recall@3 against the fp32 exact top-3
                        within 0.005 of the unsharded store's, ms per query
                        beside it; a residual pq mesh store (int8 mirror) at
                        131,072 rows through kernel 3, bit for bit against
                        the plain versions; the 1b config in dense bf16 with
                        kv_bits 8 at (dp, tp) = (1, 1): 32 greedy tokens at
                        batch 8 equal to the unsharded generate_tokens, kernel
                        10 16 times a decode step, the first decode step
                        against the plain version; one AdamW train step at 4 ×
                        256 tokens, its loss within 1e-3 of the unsharded loss;
19. generate          — the 1b model as int4 and as nf4 with an int8 KV cache,
                        random weights from the seed, through
                        create_model_interface: greedy generate_batch of 8
                        tokens at batch 1 and 8 on RAG-sized prompts, with 113
                        q4/NF4 and 16 attention launches per decode step;
                        prefill and decode times, the step's device ms by
                        kernel, weight and cache bytes, the
                        first decode step's logits against the plain versions,
                        greedy-token agreement with them;
20. evaluate          — the evaluation slice: (a) EvaluationRunner.run_all() (the
                        efficiency, performance and retrieval benchmarks) over the
                        generate phase's 1b int4 model and a RAGPipeline with
                        config.json's rag section on the held-out corpus and
                        questions (efficiency warm-up 1, 2 runs, 16 tokens, batches
                        1 and 8; perplexity at 1,024 tokens; the corpus_qa_mc task;
                        16 generated tokens): no errors, the five files, the
                        headline metrics, the H100's spec row and power limit,
                        kernels 8 and 10 counted; (b) config.json's small int8
                        model on the card and on the CPU: log-likelihoods per
                        scored token and is_greedy outside ties, perplexity, and
                        the retrieval benchmark's metrics over one saved index;
                        (c) python -m crs_tpu_torch --eval-performance
                        --eval-retrieval as a child on a copy of config.json;
21. finetune          — QLoRA on the card: (a) the 1b model with an int4 base and
                        kv_bits 8 (its own random init), LoRA at config.json's
                        finetuning values for 2 epochs (3 in config.json) of
                        SyntheticCodeLoader's 64 samples, the performance
                        benchmark after each epoch into epoch_N/ (the evaluate
                        phase's perplexity and QA inputs): median step ms,
                        tokens/s, a step's peak memory, losses, eval_loss, the
                        callback's seconds, every checkpoint and result file;
                        (b) a LoRA'd two-layer 1b slice in int4 and nf4 at 32
                        rows, forward and backward through kernels 8 / 9
                        (counted) against their plain versions: logits, adapter
                        gradients and dx; (c) 16 greedy tokens of the adapted
                        model (kernels 8 and 10 counted) and merge_lora's logits
                        against the adapted model's; (d) config.json's small
                        int8 model, 3 trainer steps on the card and on the CPU
                        from the same A's and batches: losses and adapters;
                        (e) the five analysis tools over epoch_0/ and epoch_1/;
22. rag               — RAGPipeline (config.json's lexical embedding, fitted on
                        the card; int8 store) over the held-out corpus with the
                        nf4 model: query() with config.json's generation values
                        (sampled), ms per query split into retrieve and
                        generate, chunks checked against a CPU pipeline on the
                        card's saved index and state, doc·query scores against
                        a CPU pipeline's own fit (within 1e-4);
23. lexical           — config.json's lexical encoder at full width (131,072
                        features, 384 dims) fitted on 16,384 synthetic chunks
                        of config.json's 240 words,
                        config.json's int8 store, a retrieve batch of 328
                        queries through kernel 1: fit seconds by stage, index
                        and query embed times; embeddings against a CPU encoder
                        on the card's saved state, ids against the plain scan;
24. minilm            — MiniLM-L6 at full width (random init) embeds 4,096
                        chunks at batch 32 into config.json's int8 store, a
                        search through kernel 1; embeddings and the search
                        against the CPU;
25. cli               — ``python -m crs_tpu_torch`` on the card on copies of
                        config.json: --no-model --query on a copy of vector_db/,
                        --index of the held-out corpus into its own directory
                        and a query on it, then the command line's main in this
                        process on the lexical phase's index through kernel 1;
                        vector_db/ unchanged;
26. generate_7b       — mistral-7b at full width, its depth cut to 4 layers, as
                        int8 with a bf16 KV cache, random weights
                        from the seed, loaded once: unfused, fuse_projections
                        and fused_mlp, greedy generate_batch of 32 tokens at
                        batch 1 and 8 (kernel 11: 16 launches per decode step in
                        the fused_mlp variant, none in the others); first-step
                        logits identical with fuse_projections, within 5e-2 of
                        unfused with fused_mlp; one kv_bits 8 batch-8 decode
                        through kernels 10 and 11 against the plain versions;
27. calibrated        — the gptq and awq types of the small config loaded on the
                        card: load seconds, codes equal to the CPU load,
                        reconstruction error against plain rounding, 16 tokens.

Then the kernel table line (all fourteen kernels), the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. Without CUDA
it exits 1 and prints no result; ``--phases`` with a subset exits 2 after
the phases, with no table and no result. It imports nothing of JAX or of
the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
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
INT8_BLOCK = BENCH_STORE["block_size"]  # kernel 1's block on the main path (`full`)

# config.json's vector_store values (rag.vector_store) for the formats phase
CONFIG_STORE = {"block_size": 1024, "rescore_k": 64, "pq_subspaces": 48, "pq_clusters": 256,
                "pq_aniso_eta": 0.0}
FORMAT_STORES = {
    "fp32": {"format": "fp32"},
    "bf16": {"format": "bf16"},
    "pq": {"format": "pq"},
    "pq_sorted": {"format": "pq", "pq_sorted": True},  # the residual store's state, sorted route
    "pq_plain": {"format": "pq", "pq_residual": False},
}
FORMAT_KERNEL = {"fp32": "scan_topk_f32", "bf16": "scan_topk_bf16",
                 "pq": "adc_scan_topk_residual", "pq_sorted": "adc_scan_topk_sorted",
                 "pq_plain": "adc_scan_topk_plain"}
SCAN_BLOCK = 1024  # config.json's block_size: the kernels' main-path block
SCAN_KB = 3  # kb of the pq stores' 64-candidate scan at 1M rows, B = 328
# the formats phase's stores: the first half of the full phase's rows (cut from
# FULL_ROWS in PR 18 to keep the whole run inside its time limit: PQ training
# runs over every row, twice a pq store)
FORMAT_ROWS = 1 << 19
PQ_M, PQ_C, PQ_K = 48, 2048, 256
FLOAT_RTOL = {"fp32": 1e-5, "bf16": 1e-2}
ID_RTOL = 1e-5  # the f32 sum-order bound: ranks farther apart must agree

# H100 SXM peaks (NVIDIA data sheet, dense): HBM rate, int8 tensor-core rate,
# f32 on the CUDA cores, bf16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1.979e15
PEAK_F32_OPS_PER_S = 67e12  # FMAs counted as two operations
PEAK_BF16_OPS_PER_S = 989e12
H100_SMS, H100_CLOCK_HZ = 132, 1.98e9
# a lone f32 add (the ADC kernels' work) takes a lane for a clock: half the FMA-counting peak
PEAK_F32_ADDS_PER_S = H100_SMS * 128 * H100_CLOCK_HZ
SMEM_LIMIT = 232448  # shared memory one CTA may use (227 KB)


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


def check_float_ranked(got, ref, rtol: float, dim: int) -> float:
    """Kernel 2's tolerance rule on ranked lists along ``dim`` (a block's kb
    partials, or a final top-k): scores within rtol·(1 + |s|); ids equal at
    every rank whose score is more than ID_RTOL·(1 + |s|) from both
    neighbours' (the f32 sum-order bound) and at every -1e30 rank. ``ref``
    may hold one rank more than ``got`` (the plain version asked for kb + 1
    or k + 1): its score is the last rank's next neighbour, which a list cut
    at kb does not show. Returns the largest score difference over the
    non-sentinel entries."""
    import torch

    (gs, gi), (rs_all, ri) = got, ref
    n = gs.shape[dim]
    gs, rs_all = gs.double().cpu(), rs_all.double().cpu()
    rs = rs_all.narrow(dim, 0, n)
    gi, ri = gi.cpu().long(), ri.cpu().long().narrow(dim, 0, n)
    diff = (gs - rs).abs()
    if bool((diff > rtol * (1 + rs.abs())).any()):
        raise AssertionError(f"float scan scores differ by up to {float(diff.max())}")
    tol = ID_RTOL * (1 + rs.abs())
    m = rs_all.shape[dim]
    step = rs_all.narrow(dim, 0, m - 1) - rs_all.narrow(dim, 1, m - 1)
    inf = torch.full_like(rs.narrow(dim, 0, 1), float("inf"))
    gap_prev = torch.cat([inf, step], dim).narrow(dim, 0, n)
    gap_next = torch.cat([step, inf], dim).narrow(dim, 0, n)
    need = ((gap_prev > tol) & (gap_next > tol)) | (rs <= -1e29)
    bad = int(((gi != ri) & need).sum())
    if bad:
        raise AssertionError(f"float scan ids differ at {bad} separated ranks")
    real = rs > -1e29
    return float(diff[real].max()) if bool(real.any()) else 0.0


def check_bits(got, ref, what: str) -> float:
    """ADC kernels: ids and scores identical."""
    import torch

    if not (torch.equal(got[1].cpu().long(), ref[1].cpu().long())
            and torch.equal(got[0].cpu(), ref[0].cpu())):
        bad = int((got[1].cpu().long() != ref[1].cpu().long()).sum())
        raise AssertionError(f"{what}: not bit-identical to the plain version ({bad} ids differ)")
    return 0.0


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper replaced by its plain torch version (the same
    code around it), to hold a whole route against its plain form."""
    from crs_tpu_torch.models import quantized, transformer
    from crs_tpu_torch.ops import decode_attention, fused_mlp, qgemm, scan

    swaps = [(scan, n, getattr(scan, n + "_plain"))
             for n in ("block_topk_int8", "block_topk_float", "block_topk_adc",
                       "block_topk_adc_sorted", "block_topk_segmax", "block_topk_segmax_int8")]
    swaps += [(quantized, "q4_matmul", qgemm.emulate_q4_matmul),
              (quantized, "nf4_matmul", qgemm.emulate_nf4_matmul),
              (transformer, "decode_attention_int8",
               decode_attention.emulate_decode_attention_int8),
              (transformer, "fused_mlp_int8", fused_mlp.emulate_fused_mlp_int8)]
    saved = [(mod, n, getattr(mod, n)) for mod, n, _ in swaps]
    for mod, n, fn in swaps:
        setattr(mod, n, fn)
    try:
        yield
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def bound(bytes_moved: float, ops: float, ops_rate: float) -> dict:
    """The least time for the work: max(bytes / HBM rate, ops / peak rate)."""
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / ops_rate * 1e3
    return {"bytes": bytes_moved, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def clustered_case(rng, n: int, d: int, b: int, hot: int = 50):
    """Every query owns a hot run of rows near it, so its top-k crowds into
    one block: small kb trips ceilings (repair) or the budget (fallback)."""
    import numpy as np

    base = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    for qi in range(b):
        st = (256 * qi) % (n - hot - 10)
        base[st:st + hot] = q[qi][None] * 10 + 0.01 * rng.standard_normal((hot, d))
    return base, q


def partial_inputs(codes, scales, queries, valid_n, row_mask=None, block_size: int = INT8_BLOCK):
    """The kernel's operands as ``scan_topk_int8`` builds them (rows padded
    to whole blocks of ``block_size``)."""
    import torch

    from crs_tpu_torch.ops.quant import scalar_quantize
    from crs_tpu_torch.ops.scan import QUERY_TILE, _pad_rows
    from crs_tpu_torch.ops.topk import NEG_INF

    q_codes, q_scales = scalar_quantize(queries)
    q_codes = _pad_rows(q_codes, QUERY_TILE)
    vecs = _pad_rows(codes, block_size)
    vs = _pad_rows(scales, block_size)
    allowed = torch.arange(vecs.shape[0], device=codes.device) < valid_n
    if row_mask is not None:
        allowed = allowed & _pad_rows(row_mask, vecs.shape[0])
    bias = torch.where(allowed, 0.0, NEG_INF).float()
    return q_codes, vecs, vs, bias


def empty_cache(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.empty_cache()


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


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


def device_profile(fn, batch_ms: float, top: int = 8, kernels=None) -> dict:
    """One call under torch.profiler: device time by kernel (the CUDA-side
    events only, so no op's time counts twice), the device's busy share of
    ``batch_ms`` and, for each {label: name filters} of ``kernels``, the ms
    covered by the kernels whose names hold one of them. Returns {"not
    measured": reason} when the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernel_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    times = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            times[ev.key] = ev.self_device_time_total / 1e3
    if not times:
        return {"not measured": "the profiler recorded no device time"}
    busy = sum(times.values())
    ranked = sorted(times.items(), key=lambda kv: -kv[1])[:top]
    by_label = {label: device_union_ms([e for e in kernel_events
                                        if any(n in e.name for n in names)])
                for label, names in (kernels or {}).items()}
    return {"device_busy_ms": busy, "device_busy_share": busy / batch_ms,
            "top_ms": {k[:80]: v for k, v in ranked}, "kernels_ms": by_label}


# -- phases --------------------------------------------------------------------

def phase_build(ph: Phase) -> dict:
    from concurrent.futures import ThreadPoolExecutor

    from crs_tpu_torch.ops.scan import build_kernels
    from crs_tpu_torch.rag.hashed_features import build_native

    with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc per source, started together
        kernels_f, native_f = pool.submit(build_kernels), pool.submit(build_native)
        kernels, native = kernels_f.result(), native_f.result()
    ph.info.update({
        "cuda_build_s": {src: round(r.seconds, 3) for src, r in kernels.items()},
        "native_featurizer_build_s": round(native.seconds, 3),
        "ptxas": {src: [ln.strip() for ln in r.log.splitlines()
                        if "registers" in ln or "spill" in ln] for src, r in kernels.items()},
    })
    return {src: r.log for src, r in kernels.items()}


def kernel_build_report(log: str, stem: str) -> dict:
    """Registers, spills and static shared memory of each instantiation of
    the kernel ``stem`` from ``nvcc -Xptxas -v`` output, keyed by its
    template arguments as mangled (``ILb1ELb0E``: RESIDENT, not RAGGED)."""
    import re

    args = sorted({m.group(1) for m in re.finditer(stem + r"(I\w*?E)E?v", log)})
    return ptxas_report(log, {stem + a: a or stem for a in args} or {stem: stem})


def int8_yardsticks(q, ops, kb: int, block: int):
    """Kernel 1's two PyTorch compositions at its operands (queries q,
    ``partial_inputs`` ops): dequantize + torch.matmul (TF32 off) +
    torch.topk per block; torch._int_mm (cuBLAS int8) of the query codes and
    the corpus + row scale and bias + torch.topk per block."""
    import torch

    q_codes, vecs, vs, bias = ops
    nblocks = vecs.shape[0] // block

    def dequantize():
        s = torch.matmul(q, (vecs.float() * vs[:, None]).T)
        return torch.topk(s.view(q.shape[0], nblocks, block), kb, dim=-1)

    def int_mm():
        s = torch._int_mm(q_codes, vecs.T).float() * vs[None, :] + bias[None, :]
        return torch.topk(s.view(q_codes.shape[0], nblocks, block), kb, dim=-1)

    return dequantize, int_mm


def phase_kernel(ph: Phase, dev, seed: int, rows: int, build_logs: dict) -> float:
    import numpy as np
    import torch

    from crs_tpu_torch.ops.quant import _int8_topk_dense, scalar_quantize
    from crs_tpu_torch.ops.scan import (
        STATS, _default_kb_repair, _load_lib, block_topk_int8, block_topk_int8_plain,
        scan_topk_int8,
    )

    build = kernel_build_report(build_logs.get("int8_scan_topk.cu", ""), "int8_scan_topk_kernel")
    lib = _load_lib()
    if hasattr(lib, "int8_scan_topk_smem_bytes"):  # the dynamic shared memory at (D, kb 3)
        build["dynamic_smem_at_main_shape"] = lib.int8_scan_topk_smem_bytes(DIM, 3)
        build["queries_resident_at_main_shape"] = bool(lib.int8_scan_topk_queries_resident(DIM, 3))
    emit({"int8_scan_build": build})
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
    nblocks = ops[1].shape[0] // INT8_BLOCK
    kb = _default_kb_repair(CAND_K, nblocks, BATCH, 256)
    max_err = max(max_err, compare_partials(block_topk_int8(*ops, kb),
                                            block_topk_int8_plain(*ops, kb)))
    s, i = scan_topk_int8(codes, scales, q, CAND_K, rows)
    ds, di = _int8_topk_dense(codes, scales, q, CAND_K, rows)
    if not torch.equal(i, di):
        raise AssertionError("(a) scan top-k ids differ from the exact dense int8 top-k")
    a_err = float((s - ds).abs().max())
    if a_err > 1e-6 * float(ds.abs().max()):
        raise AssertionError(f"(a) scan scores differ from the dense ones by {a_err}")
    # the kernel at the main path's blocks, its two compositions in turns
    # (kernel, dequantize, _int_mm, _int_mm, dequantize, kernel), plain, bound
    dequantize, int_mm = int8_yardsticks(q, ops, kb, INT8_BLOCK)
    kernel = lambda: block_topk_int8(*ops, kb)  # noqa: E731
    turns = [device_ms(dev, kernel, iters=10, warmup=2), device_ms(dev, dequantize, iters=3),
             device_ms(dev, int_mm, iters=3), device_ms(dev, int_mm, iters=3),
             device_ms(dev, dequantize, iters=3), device_ms(dev, kernel, iters=10, warmup=1)]
    plain_ms = device_ms(dev, lambda: block_topk_int8_plain(*ops, kb), iters=2)
    q_codes, vecs = ops[0], ops[1]
    nbytes = (vecs.numel() + 4 * vecs.shape[0] * 2 + q_codes.numel()
              + q_codes.shape[0] // 64 * nblocks * kb * 64 * 8)
    ph.info["a"] = {"rows": rows, "dim": DIM, "batch": BATCH, "k": CAND_K, "kb": kb,
                    "block_size": INT8_BLOCK, "partials": "kernel == plain",
                    "topk_vs_dense_max_abs": a_err, "ms": (turns[0] + turns[5]) / 2,
                    "plain_ms": plain_ms, "library_composition_ms": (turns[1] + turns[4]) / 2,
                    "int_mm_composition_ms": (turns[2] + turns[3]) / 2,
                    "turns_kernel_dequantize_int_mm_int_mm_dequantize_kernel_ms": turns,
                    **bound(nbytes, 2.0 * BATCH * rows * DIM, PEAK_INT8_OPS_PER_S)}
    del codes, scales, ops, q_codes, vecs

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

    # (d) widths: a D off the kernel's 16-byte words (zero-filled inside the
    # kernel) and D past one 512-byte query slice, aligned and not
    edge = {}
    for name, (n, d, b, kb) in INT8_EDGE_CASES.items():
        x = torch.randn((n, d), generator=g, device=dev)
        x[40:60] = x[0:20]  # exact ties inside a block
        qd = torch.randn((b, d), generator=g, device=dev)
        codes_e, scales_e = scalar_quantize(x)
        ops_e = partial_inputs(codes_e, scales_e, qd, n - 100)
        err = compare_partials(block_topk_int8(*ops_e, kb), block_topk_int8_plain(*ops_e, kb))
        edge[name] = {"rows": n, "dim": d, "batch": b, "kb": kb, "max_abs": err}
        max_err = max(max_err, err)
    # one vector repeated: every score of a block equal (the first-chunk
    # candidates overflow and the full merge takes over), the tail masked
    x = torch.randn((1, 64), generator=g, device=dev).repeat(2048, 1)
    codes_e, scales_e = scalar_quantize(x)
    ops_e = partial_inputs(codes_e, scales_e, torch.randn((64, 64), generator=g, device=dev), 1900)
    err = compare_partials(block_topk_int8(*ops_e, 4), block_topk_int8_plain(*ops_e, 4))
    edge["all_equal"] = {"rows": 2048, "dim": 64, "batch": 64, "kb": 4, "max_abs": err}
    ph.info["d"] = edge
    ph.info["max_abs_err"] = max_err
    return {"max_abs_err": max_err, **ph.info["a"]}


# kernel 1's widths on its main-path blocks, (rows, D, queries, kb): ragged
# D in one 128-byte slice (4-byte and byte offsets, an odd query tile
# count), ragged D over 17 slices, an aligned D over 24 (the queries
# streamed), a D under one slice, the lists' room (kb 32)
INT8_EDGE_CASES = {
    "d_ragged_100": (4096, 100, 130, 4),
    "d_ragged_99": (4096, 99, 64, 3),
    "d_ragged_2049": (2048, 2049, 64, 3),
    "d3072_sliced": (2048, 3072, 130, 3),
    "d16": (2048, 16, 64, 4),
    "kb32": (2048, 384, 64, 32),
}


# kernel 2's edge cases at small sizes, (rows, D, queries, block_size, kb,
# masked blocks): ragged D (fp32 any D; bf16 a multiple of 8), D = 4096 (the
# bf16 queries streamed) and wider, to 20,000, an odd query tile count, kb = 32 (the lists' room),
# blocks of 256 and 4096, whole blocks and a block's tail masked (-1e30
# re-emissions)
FLOAT_EDGE_CASES = {
    "d_ragged_104": (4096, 104, 64, 1024, 3, ()),
    "d_ragged_200": (2048, 200, 130, 512, 4, ()),
    "d4096_streamed": (4096, 4096, 128, 1024, 3, ()),
    "d8200_ragged": (2048, 8200, 64, 1024, 3, ()),
    "d16384_streamed": (2048, 16384, 130, 1024, 3, ()),
    "d20000_ragged": (2048, 20000, 64, 1024, 4, ()),
    "odd_query_tiles": (2048, 64, 130, 1024, 8, ()),
    "kb32": (2048, 64, 64, 1024, 32, ()),
    "kb32_d384": (2048, 384, 64, 1024, 32, ()),
    "block_256": (2048, 64, 64, 256, 2, ()),
    "block_4096": (8192, 64, 64, 4096, 8, ()),
    "masked_blocks": (4096, 64, 64, 512, 6, (1, 3)),
}


def float_edge_operands(g, dev, dtype, rows, d, queries, block_size, masked):
    """Unit rows and queries (the query rows padded to the tile), a bias that
    masks the blocks in ``masked`` whole and block 2 but for 3 rows, and
    duplicated rows (exact ties) in block 0."""
    import torch

    from crs_tpu_torch.ops.scan import FLOAT_QUERY_TILE, _pad_rows

    x = torch.randn((rows, d), generator=g, device=dev)
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    x[40:60] = x[0:20]  # exact ties inside a block
    q = torch.randn((queries, d), generator=g, device=dev)
    q /= torch.linalg.vector_norm(q, dim=1, keepdim=True)
    bias = torch.zeros(rows, device=dev)
    for b in masked:
        bias[b * block_size:(b + 1) * block_size] = -1e30
        bias[2 * block_size + 3:3 * block_size] = -1e30
    return _pad_rows(q.to(dtype), FLOAT_QUERY_TILE).contiguous(), x.to(dtype).contiguous(), bias


def ptxas_report(log: str, names: dict) -> dict:
    """Registers, spills and static shared memory per kernel instantiation
    from ``nvcc -Xptxas -v`` output; ``names`` maps a fragment of the
    mangled name to the report's name."""
    import re

    funcs, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = m.group(1)
            funcs[cur] = {}
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur in funcs:
            funcs[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur in funcs:
            sm = re.search(r"(\d+) bytes smem", ln)
            funcs[cur].update(registers=int(m.group(1)), static_smem=int(sm.group(1)) if sm else 0)
    return {name: info for mangled, info in funcs.items()
            for key, name in names.items() if key in mangled}


def phase_kernel_f32_bf16(ph: Phase, dev, seed: int, rows: int, build_logs: dict) -> dict:
    """Kernel 2 against its plain version at the main shape (1M × 384, B =
    328, block 1024, kb 3), on FLOAT_EDGE_CASES and, through scan_topk, on
    the repair / fallback / padding / mask / tie / ragged-D cases; each
    dtype's kernel and its composition timed in turns (kernel, composition,
    composition, kernel); bound, plain ms; a line with each instantiation's
    registers, spills and shared memory."""
    import numpy as np
    import torch

    from crs_tpu_torch.ops.scan import (
        FLOAT_QUERY_TILE, STATS, _load_kernel_lib, _pad_rows, block_topk_float,
        block_topk_float_plain, scan_topk,
    )

    lib = _load_kernel_lib("scan_topk_f32_bf16.cu")  # ctypes calls return int by default
    build = ptxas_report(build_logs.get("scan_topk_f32_bf16.cu", ""),
                         {"scan_topk_f32_kernelILb0ELb0E": "f32",
                          "scan_topk_f32_kernelILb1ELb0E": "f32_ragged",
                          "scan_topk_f32_kernelILb1ELb1E": "f32_masked",
                          "scan_topk_bf16_kernelILb1ELb0E": "bf16_resident",
                          "scan_topk_bf16_kernelILb0ELb0E": "bf16_streamed",
                          "scan_topk_bf16_kernelILb1ELb1E": "bf16_resident_masked",
                          "scan_topk_bf16_kernelILb0ELb1E": "bf16_streamed_masked"})
    build["dynamic_smem_at_main_shape"] = {"f32": lib.scan_topk_float_smem_bytes(0, DIM, SCAN_KB),
                                           "bf16": lib.scan_topk_float_smem_bytes(1, DIM, SCAN_KB)}
    build["bf16_queries_resident_at_main_shape"] = bool(
        lib.scan_topk_float_bf16_queries_resident(DIM, SCAN_KB))
    build["wgmma_remarks"] = [ln.strip() for ln in build_logs.get("scan_topk_f32_bf16.cu", "")
                              .splitlines() if "wgmma" in ln.lower()]
    emit({"float_scan_build": build})

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)
    edge = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for case, (n_rows, d, queries, bs, kb, masked) in FLOAT_EDGE_CASES.items():
            qq, v, bias_e = float_edge_operands(g, dev, dtype, n_rows, d, queries, bs, masked)
            got = block_topk_float(qq, v, bias_e, kb, bs)
            edge[f"{name}.{case}"] = check_float_ranked(
                got, block_topk_float_plain(qq, v, bias_e, kb + 1, bs), FLOAT_RTOL[name], dim=2)
            if masked:  # a whole masked block re-emits its first row at -1e30
                b0 = masked[0]
                if not (bool((got[0][:, b0] == -1e30).all())
                        and bool((got[1][:, b0] == b0 * bs).all())):
                    raise AssertionError(f"{name}.{case}: a masked block's emissions are not "
                                         f"(-1e30, its first row)")
    sync(dev)

    x = torch.randn((rows, DIM), generator=g, device=dev)
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    q = torch.randn((BATCH, DIM), generator=g, device=dev)
    q /= torch.linalg.vector_norm(q, dim=1, keepdim=True)
    bias = torch.zeros(rows, device=dev)
    bias[rows - 1000:] = -1e30  # padding rows at the tail
    nblocks = rows // SCAN_BLOCK
    out = {"edge_cases": edge}
    for name, dtype, ops_rate in (("fp32", torch.float32, PEAK_F32_OPS_PER_S),
                                  ("bf16", torch.bfloat16, PEAK_BF16_OPS_PER_S)):
        v = x.to(dtype)
        qq = _pad_rows(q.to(dtype), FLOAT_QUERY_TILE)
        err = check_float_ranked(block_topk_float(qq, v, bias, SCAN_KB, SCAN_BLOCK),
                                 block_topk_float_plain(qq, v, bias, SCAN_KB + 1, SCAN_BLOCK),
                                 FLOAT_RTOL[name], dim=2)
        plain_ms = device_ms(dev, lambda: block_topk_float_plain(qq, v, bias, SCAN_KB,
                                                                 SCAN_BLOCK), iters=2)
        q_real = q.to(dtype)

        def kernel():
            return block_topk_float(qq, v, bias, SCAN_KB, SCAN_BLOCK)

        def library():  # two calls: torch.matmul (no TF32) and torch.topk per block
            s = torch.matmul(q_real, v.T)
            return torch.topk(s.view(BATCH, nblocks, SCAN_BLOCK), SCAN_KB, dim=-1)

        turns = {"kernel": [], "library": []}
        for who, fn in (("kernel", kernel), ("library", library), ("library", library),
                        ("kernel", kernel)):
            turns[who].append(device_ms(dev, fn, iters=10 if who == "kernel" else 5, warmup=2))
        nq = qq.shape[0] // FLOAT_QUERY_TILE
        b = bound(v.numel() * v.element_size() + qq.numel() * qq.element_size() + rows * 4
                  + nq * nblocks * SCAN_KB * FLOAT_QUERY_TILE * 8,
                  2.0 * BATCH * rows * DIM, ops_rate)
        out[name] = {"max_abs_err": max([err] + [e for k_, e in edge.items()
                                                 if k_.startswith(name + ".")]),
                     "ms": sum(turns["kernel"]) / 2, "plain_ms": plain_ms,
                     "library_composition_ms": sum(turns["library"]) / 2, "turns_ms": turns, **b}
        del v, qq
    del x
    out["shape"] = {"rows": rows, "dim": DIM, "batch": BATCH, "block_size": SCAN_BLOCK,
                    "kb": SCAN_KB}
    out["library_composition"] = "torch.matmul (TF32 off) + torch.topk per block: two calls"

    # the scan's host side around the kernel, GPU against the CPU plain path
    rng = np.random.default_rng(seed + 3)
    n, d, b, k = 4096, 64, 16, 40
    base, qc = clustered_case(rng, n, d, b)
    mask = rng.random(n) < 0.5
    tie = rng.standard_normal((n, d)).astype(np.float32)
    tie /= np.linalg.norm(tie, axis=1, keepdims=True)
    tie[3000:3100] = tie[0:100]  # duplicated rows: exact ties
    sparse = np.zeros(n, bool)
    sparse[rng.choice(n, 4, replace=False)] = True
    sparse[:b] = sparse[3000:3000 + b] = True  # fewer allowed rows than k: -1e30 ranks
    ragged = rng.standard_normal((n, 100)).astype(np.float32)
    ragged /= np.linalg.norm(ragged, axis=1, keepdims=True)
    cases = {  # name: (vectors, queries, kb, repair, mask, valid_n)
        "ragged_d100": (ragged, ragged[:b] + 0.1, 2, 256, None, n - 5),
        "repair": (base, qc, 2, 256, None, n),
        "fallback": (base, qc, 2, 4, None, n),
        "repair_masked": (base, qc, 2, 256, mask, n - 37),
        "ties_padding_mask": (tie, tie[:b].copy(), 0, 256, sparse, n - 300),
    }
    counts = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for case, (v, qv, kb, repair, m, valid) in cases.items():
            args = dict(k=k, valid_n=valid, block_size=256, kb=kb, repair=repair)
            m_t = None if m is None else torch.from_numpy(m)
            STATS.reset()
            got = scan_topk(torch.from_numpy(v).to(dtype).to(dev), torch.from_numpy(qv).to(dev),
                            row_mask=None if m_t is None else m_t.to(dev), **args)
            counts[f"{name}/{case}"] = {"launches": STATS.launches, "repairs": STATS.repairs,
                                        "fallbacks": STATS.fallbacks}
            ref = scan_topk(torch.from_numpy(v).to(dtype), torch.from_numpy(qv), row_mask=m_t,
                            **{**args, "k": k + 1})  # the k-th rank's next neighbour too
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                           check_float_ranked(got, ref, FLOAT_RTOL[name], dim=1))
            ref = (ref[0][:, :k], ref[1][:, :k])
            if m is not None and bool((ref[0] > -1e29).any()):
                ok = ref[1][ref[0] > -1e29]
                if not bool(m_t[ok].all()) or int(ok.max()) >= valid:
                    raise AssertionError(f"{name}/{case}: masked or padding rows returned")
        for case, key in (("repair", "repairs"), ("fallback", "fallbacks")):
            if counts[f"{name}/{case}"][key] < 1:
                raise AssertionError(f"{name}/{case}: the {key[:-1]} path did not run: {counts}")
    out["cases"] = counts
    ph.info.update(out)
    return out


def adc_case(rng, n: int, d: int, b: int, m: int, c: int):
    """Random residual-PQ state with hot rows (each query's best code in most
    subspaces, so its top-k crowds into one block), duplicated rows (ties),
    and the LUTs built by the port on the CPU."""
    import numpy as np
    import torch

    from crs_tpu_torch.ops.pq import adc_lut, residual_adc_luts

    rot = torch.from_numpy(np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32))
    coarse = torch.from_numpy((rng.standard_normal((c, d)) * 0.3).astype(np.float32))
    cents = torch.from_numpy((rng.standard_normal((m, 256, d // m)) * 0.1).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    cid = rng.integers(0, c, n)
    ext = np.concatenate([(cid // 256)[:, None], (cid % 256)[:, None],
                          rng.integers(0, 256, (n, m))], 1).astype(np.uint8)
    ext[3000:3100] = ext[0:100]
    cl, lut = residual_adc_luts(rot, coarse, cents, q)
    plut = adc_lut(cents, q)
    codes = ext[:, 2:].copy()
    for qi in range(b):
        st = (256 * qi) % (n - 60)
        best = lut[qi].argmax(dim=1).numpy()
        ext[st:st + 50, 2:] = np.where(rng.random((50, m)) < 0.7, best[None], ext[st:st + 50, 2:])
        best = plut[qi].argmax(dim=1).numpy()
        codes[st + 128:st + 178] = np.where(rng.random((50, m)) < 0.7, best[None],
                                            codes[st + 128:st + 178])
    return cl, lut, torch.from_numpy(ext), plut, torch.from_numpy(codes)


ADC_INSTANCES = {"adc_scan_topk_skew_kernelILi1ELb0E": "residual_skew",
                 "adc_scan_topk_skew_kernelILi0ELb0E": "plain_skew",
                 "adc_scan_topk_skew_kernelILi2ELb0E": "sorted_skew",
                 "adc_scan_topk_skew_kernelILi1ELb1E": "residual_skew_masked",
                 "adc_scan_topk_kernelILi1ELi8ELb0ELb0E": "residual_qt8",
                 "adc_scan_topk_kernelILi1ELi8ELb0ELb1E": "residual_qt8_masked",
                 "adc_scan_topk_kernelILi0ELi8ELb0ELb0E": "plain_qt8"}


def occupancy(registers: int, threads: int, smem: int) -> dict:
    """CTAs and warps an SM holds for a kernel, from its ptxas registers and
    its shared memory (65,536 registers allocated per warp in units of 256;
    228 KB of shared memory, 1 KB of it reserved per CTA; 64 warps)."""
    warps = threads // 32
    regs_per_warp = -(-registers * 32 // 256) * 256
    by_regs = 65536 // (regs_per_warp * warps)
    by_smem = (228 * 1024) // (smem + 1024)
    ctas = min(by_regs, by_smem, 64 // warps)
    limit = ("registers" if by_regs < by_smem else "shared memory" if by_smem < by_regs
             else "registers and shared memory")
    return {"ctas_per_sm": ctas, "warps_per_sm": ctas * warps, "limited_by": limit}


def gather_wavefronts(codes, m: int, off: int, skewed: bool, rows: int = 1 << 16) -> float:
    """Mean shared-memory wavefronts of one warp's 16-byte LUT gather, from
    this run's codes (computed, not a hardware counter): a warp's 32 lanes
    score 32 consecutive rows; a 16-byte load is served 8 lanes a phase,
    and a phase takes as many wavefronts as the most distinct entries that
    fall on one of the 8 four-bank groups (entry e sits on group e mod 8;
    equal entries are one broadcast). Unskewed, the lanes of a step read
    subspace j of their rows, entry m·K + code; skewed (the main path), lane
    l reads subspace j − (l mod 8), entry code·Mp + j − (l mod 8), Mp = M
    rounded up to 8 (an idle lane of the first and last 7 steps reads the
    zero entry before the LUT on its step's bank group)."""
    import torch

    c = codes[:rows, off:off + m].long().reshape(-1, 8, m)  # [phase, lane, m]
    lag = torch.arange(8, device=codes.device)
    waves = []
    steps = range(m + 7) if skewed else range(m)
    mp = -(-m // 8) * 8
    for j in steps:
        if skewed:
            sub = j - lag  # [lane]
            on = (sub >= 0) & (sub < m)
            code = c.gather(2, sub.clamp(0, m - 1)[None, :, None].expand(c.shape[0], 8, 1))[..., 0]
            entry = torch.where(on[None, :], code * mp + sub[None, :], (sub[None, :] & 7) - 8)
        else:
            entry = c[..., j] + j * 256
        same = entry[:, :, None] == entry[:, None, :]
        first = ~torch.tril(same, diagonal=-1).any(-1)
        per_group = torch.zeros((entry.shape[0], 8), dtype=torch.long, device=codes.device)
        per_group.scatter_add_(1, entry % 8, first.long())
        waves.append(per_group.amax(-1).float().mean())
    return float(torch.stack(waves).mean()) * 4  # 4 phases a warp


def adc_kernel_threads() -> int:
    from crs_tpu_torch.ops.scan import _load_kernel_lib

    return _load_kernel_lib("pq_adc_scan_topk.cu").adc_scan_topk_threads()


def adc_counters(build_log: str, codes, nq: int, rows: int) -> dict:
    """What the card lets this script read of the ADC kernel at the main
    shape: registers, spills and shared memory of each instantiation
    (ptxas, read from the build) and the CTAs and warps an SM holds; beside
    them a model, not a hardware counter: the 16-byte gather's wavefronts
    computed from this run's codes, and the gather's floor at one wavefront
    per SM per clock. Stall reasons and measured bank conflicts need Nsight
    Compute, which this machine cannot run: not measured."""
    from crs_tpu_torch.ops.scan import adc_layout

    build = ptxas_report(build_log, ADC_INSTANCES)
    threads = adc_kernel_threads()
    for name, resid in (("residual_skew", True), ("plain_skew", False)):
        plan = adc_layout(PQ_M, PQ_K, resid)
        if not plan.skewed:
            raise AssertionError(f"ADC plan at the main shape: {plan}, not the skewed main path")
        if name in build:
            build[name].update(plan=plan._asdict(), threads=threads,
                               **occupancy(build[name]["registers"], threads,
                                           plan.smem + build[name]["static_smem"]))
    unskewed = gather_wavefronts(codes, PQ_M, 2, skewed=False)
    skewed = gather_wavefronts(codes, PQ_M, 2, skewed=True)
    loads = float(nq) * rows / 32  # warp loads a subspace step: one per (query tile, 32 rows)
    per_ms = H100_SMS * H100_CLOCK_HZ / 1e3  # wavefronts the card serves a ms
    return {"ptxas": build,
            "gather_model": {
                "wavefronts_per_warp_load": {"unskewed": unskewed, "skewed": skewed},
                "floor_ms": {"conflict_free": loads * PQ_M * 4 / per_ms,
                             "unskewed": loads * PQ_M * unskewed / per_ms,
                             "skewed": loads * (PQ_M + 7) * skewed / per_ms},
                "note": "modelled from this run's codes, not read from the hardware: query "
                        "tiles × rows / 32 warp loads for each of M subspace steps (M + 7 "
                        "skewed), each as many wavefronts as above (4 without conflicts), one "
                        "wavefront per SM per clock at 1.98 GHz"},
            "stall_reasons": "not measured (no Nsight Compute on this machine)"}


def phase_kernel_adc(ph: Phase, dev, seed: int, rows: int, build_logs: dict) -> dict:
    """Kernels 3 and 5 against their plain version, bit for bit, at the main
    shape and on the repair / fallback / padding / mask / tie cases."""
    import numpy as np
    import torch

    from crs_tpu_torch.ops.scan import (
        ADC_QUERY_TILE, STATS, _pad_rows, adc_tables, block_topk_adc, block_topk_adc_plain,
        scan_topk_pq_adc_luts, scan_topk_residual_pq_adc_luts,
    )

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 4)
    codes = torch.randint(0, PQ_K, (rows, PQ_M + 2), generator=g, device=dev).to(torch.uint8)
    cid = torch.randint(0, PQ_C, (rows,), generator=g, device=dev)
    codes[:, 0], codes[:, 1] = (cid // 256).to(torch.uint8), (cid % 256).to(torch.uint8)
    lut = torch.randn((BATCH, PQ_M, PQ_K), generator=g, device=dev) * 0.05
    cl = torch.randn((BATCH, PQ_C), generator=g, device=dev) * 0.3
    lut_bf, hi, lo = adc_tables(_pad_rows(lut, ADC_QUERY_TILE), _pad_rows(cl, ADC_QUERY_TILE))
    bias = torch.zeros(rows, device=dev)
    bias[rows - 1000:] = -1e30
    bias[:rows - 1000:7] = -1e30  # a `where` mask: every 7th row dropped
    nblocks = rows // SCAN_BLOCK
    nq = lut_bf.shape[0] // ADC_QUERY_TILE
    out = {}
    for name, resid in (("residual", True), ("plain", False)):
        cd = codes if resid else codes[:, 2:].contiguous()
        extra = (hi, lo) if resid else ()
        err = check_bits(block_topk_adc(lut_bf, cd, bias, SCAN_KB, SCAN_BLOCK, *extra),
                         block_topk_adc_plain(lut_bf, cd, bias, SCAN_KB, SCAN_BLOCK, *extra),
                         f"{name} ADC partials")
        ms = device_ms(dev, lambda: block_topk_adc(lut_bf, cd, bias, SCAN_KB, SCAN_BLOCK, *extra),
                       iters=10, warmup=2)
        plain_ms = device_ms(dev, lambda: block_topk_adc_plain(lut_bf, cd, bias, SCAN_KB,
                                                               SCAN_BLOCK, *extra), iters=2)
        library_ms = device_ms(dev, adc_library(lut_bf, hi, lo, cd, cid, resid, rows), iters=3)
        b = bound(cd.numel() + rows * 4 + lut_bf.numel() * 2 + (hi.numel() * 4 if resid else 0)
                  + nq * nblocks * SCAN_KB * ADC_QUERY_TILE * 8,
                  float(BATCH) * rows * (PQ_M + (2 if resid else 1)), PEAK_F32_ADDS_PER_S)
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_composition_ms": library_ms, **b}
    out["counters"] = adc_counters(build_logs.get("pq_adc_scan_topk.cu", ""), codes, nq, rows)
    del codes, lut_bf, hi, lo
    out["shape"] = {"rows": rows, "m": PQ_M, "coarse": PQ_C, "clusters": PQ_K, "batch": BATCH,
                    "block_size": SCAN_BLOCK, "kb": SCAN_KB}
    out["library_composition"] = ("torch.index_select of the LUT entries + sum + torch.topk "
                                  "per block, 16,384 rows a step: not one call")
    out["bound_note"] = ("operations = B·N·(M+2) (residual) or B·N·(M+1) f32 adds at "
                         f"{PEAK_F32_ADDS_PER_S:.4g}/s (132 SMs × 128 lanes × 1.98 GHz: one add "
                         "a lane a clock)")

    rng = np.random.default_rng(seed + 5)
    n, d, b, k = 4096, 64, 16, 40
    cl_c, lut_c, ext_c, plut_c, codes_c = adc_case(rng, n, d, b, 8, 512)
    mask = rng.random(n) < 0.6
    sparse = np.zeros(n, bool)
    sparse[rng.choice(n, 12, replace=False)] = True
    cases = {"repair": (256, None, n), "fallback": (2, None, n), "no_repair": (0, None, n),
             "repair_masked_padded": (256, mask, n - 37), "exhausted_mask": (256, sparse, n)}
    counts = {}
    for case, (repair, m, valid) in cases.items():
        m_t = None if m is None else torch.from_numpy(m)
        for name, fn, ops in (
                ("residual", scan_topk_residual_pq_adc_luts, (cl_c, lut_c, ext_c)),
                ("plain", scan_topk_pq_adc_luts, (plut_c, codes_c))):
            args = dict(k=k, valid_n=valid, block_size=256, repair=repair)
            STATS.reset()
            got = fn(*(t.to(dev) for t in ops), row_mask=None if m_t is None else m_t.to(dev),
                     **args)
            counts[f"{name}/{case}"] = {"launches": STATS.launches, "repairs": STATS.repairs,
                                        "fallbacks": STATS.fallbacks}
            check_bits(got, fn(*ops, row_mask=m_t, **args), f"{name}/{case}")
    for name in ("residual", "plain"):
        if counts[f"{name}/repair"]["repairs"] < 1 or counts[f"{name}/fallback"]["fallbacks"] < 1:
            raise AssertionError(f"{name}: the repair/fallback paths did not run: {counts}")
    out["cases"] = counts
    ph.info.update(out)
    return out


def ties_agree(scores, ids_a, ids_b) -> None:
    """Per row: the ids of each group of exactly tied scores agree as sets."""
    import numpy as np

    for r, (row_s, row_a, row_b) in enumerate(zip(scores.tolist(), ids_a.tolist(),
                                                  ids_b.tolist())):
        row_s = np.asarray(row_s)
        for v in np.unique(row_s):
            tied = row_s == v
            if set(np.asarray(row_a)[tied]) != set(np.asarray(row_b)[tied]):
                raise AssertionError(f"row {r}: ids differ beyond exact ties at score {v}")


def plan_spread(sorted_cid, tile_rows: int, wbase) -> dict:
    """Coarse ids each tile of the sorted layout spans (rows ascend by id,
    so a tile's first and last rows bound them) and, for an accepted plan,
    how far into its 512-id window the tile's last id reaches."""
    import numpy as np

    sorted_cid = np.asarray(sorted_cid)
    starts = np.arange(0, sorted_cid.size, tile_rows)
    ends = np.minimum(starts + tile_rows, sorted_cid.size) - 1
    span = sorted_cid[ends] - sorted_cid[starts] + 1
    out = {"tiles": int(starts.size), "tile_rows": tile_rows,
           "ids_per_tile": {"min": int(span.min()), "median": float(np.median(span)),
                            "max": int(span.max())}, "window": 512, "refused": wbase is None}
    if wbase is not None:
        wb = np.asarray(wbase.cpu() if hasattr(wbase, "cpu") else wbase)[: starts.size]
        out["window_reach_max"] = int((sorted_cid[ends] - 256 * wb.astype(np.int64) + 1).max())
    return out


def adc_library(lut_bf, hi, lo, codes, cid, resid: bool, rows: int):
    """The nearest library composition of an ADC scan: a gather of every
    (row, subspace) LUT entry, a sum, and torch.topk per block, 16,384
    rows at a time."""
    import torch

    dev = codes.device
    lut_flat = lut_bf[:BATCH].float().reshape(BATCH, PQ_M * PQ_K)
    off = 2 if resid else 0
    flat_idx = (torch.arange(PQ_M, device=dev) * PQ_K + codes[:, off:].long()).reshape(-1)
    cid_l = cid.long()
    coarse_f = (hi[:BATCH].float() + lo[:BATCH].float()) if resid else None
    step = 16384

    def library():
        for r0 in range(0, rows, step):
            s = lut_flat.index_select(1, flat_idx[r0 * PQ_M:(r0 + step) * PQ_M])
            s = s.view(BATCH, step, PQ_M).sum(-1)
            if resid:
                s = s + coarse_f.index_select(1, cid_l[r0:r0 + step])
            torch.topk(s.view(BATCH, step // SCAN_BLOCK, SCAN_BLOCK), SCAN_KB, dim=-1)

    return library


def phase_kernel_sorted_adc(ph: Phase, dev, seed: int, rows: int) -> dict:
    """Kernel 4 against its plain version, bit for bit, at the main shape
    (adc_case's data sorted by coarse id, the plan's group) and on the
    repair / fallback / padding tile / mask / tie / hand-built plan cases;
    kernel 4 against kernel 3 on the same rows; both kernels' device ms."""
    import numpy as np
    import torch

    from crs_tpu_torch.ops.pq import sort_codes_by_coarse
    from crs_tpu_torch.ops.scan import (
        ADC_QUERY_TILE, STATS, _finalize, _pad_rows, adc_auto_group, adc_tables, block_topk_adc,
        block_topk_adc_sorted, block_topk_adc_sorted_plain, plan_sorted_coarse_windows,
        scan_topk_residual_pq_adc_sorted_luts,
    )

    rng = np.random.default_rng(seed + 6)
    cl, lut, ext, _, _ = adc_case(rng, rows, DIM, BATCH, PQ_M, PQ_C)
    ext = ext.numpy()
    sorted_ext, perm, counts = sort_codes_by_coarse(ext, PQ_C)
    group = adc_auto_group(rows, BATCH, SCAN_BLOCK, PQ_M + 2)
    plan = plan_sorted_coarse_windows(counts, rows, SCAN_BLOCK, group)
    spread = plan_spread(sorted_ext[:, 0].astype(np.int64) * 256 + sorted_ext[:, 1],
                         group * SCAN_BLOCK, plan)
    if plan is None:
        raise AssertionError(f"the window planner refused the main shape: {spread}")
    ext_u = _pad_rows(torch.from_numpy(ext).to(dev), group * SCAN_BLOCK).contiguous()
    ext_s = _pad_rows(torch.from_numpy(sorted_ext).to(dev), group * SCAN_BLOCK).contiguous()
    n_pad = ext_u.shape[0]
    perm_t = torch.from_numpy(perm).long().to(dev)
    bias_u = torch.zeros(n_pad, device=dev)
    bias_u[rows - 1000:] = -1e30  # padding rows at the tail
    bias_u[:rows - 1000:7] = -1e30  # a `where` mask: every 7th row dropped
    bias_s = bias_u.clone()
    bias_s[:rows] = bias_u[:rows][perm_t]  # the same rows, in sorted order
    table = torch.nn.functional.pad(_pad_rows(cl.to(dev), ADC_QUERY_TILE), (0, 256))
    lut_bf, hi, lo = adc_tables(_pad_rows(lut.to(dev), ADC_QUERY_TILE), table)
    wbase = torch.from_numpy(plan).to(dev)
    args_s = (lut_bf, ext_s, bias_s, SCAN_KB, SCAN_BLOCK, hi, lo, wbase, group)
    args_u = (lut_bf, ext_u, bias_u, SCAN_KB, SCAN_BLOCK, hi[:, :PQ_C].contiguous(),
              lo[:, :PQ_C].contiguous())
    err = check_bits(block_topk_adc_sorted(*args_s), block_topk_adc_sorted_plain(*args_s),
                     "sorted ADC partials")
    # kernel 4 against kernel 3: with kb = k every block emits its own top-k,
    # so the merged top-k is exact under the kernels' scores in both layouts
    su, iu = _finalize(*block_topk_adc(*args_u), BATCH, SCAN_KB)
    ss, is_ = _finalize(*block_topk_adc_sorted(*args_s), BATCH, SCAN_KB)
    if not torch.equal(ss, su):
        raise AssertionError("kernel 4's top-k scores differ from kernel 3's on the same rows")
    ties_agree(su.cpu(), iu.cpu(), perm_t[is_.clamp_min(0)].cpu())
    ms = {"sorted": [], "unsorted": []}
    for which in ("sorted", "unsorted", "unsorted", "sorted"):  # in turns, one card
        fn = block_topk_adc_sorted if which == "sorted" else block_topk_adc
        a = args_s if which == "sorted" else args_u
        ms[which].append(device_ms(dev, lambda: fn(*a), iters=10, warmup=2))
    plain_ms = device_ms(dev, lambda: block_topk_adc_sorted_plain(*args_s), iters=2)
    cid_s = ext_s[:, 0].long() * 256 + ext_s[:, 1].long()
    library_ms = device_ms(dev, adc_library(lut_bf, hi, lo, ext_s, cid_s, True, n_pad),
                           iters=3)
    nq = lut_bf.shape[0] // ADC_QUERY_TILE
    nblocks = n_pad // SCAN_BLOCK
    b = bound(ext_s.numel() + n_pad * 4 + lut_bf.numel() * 2 + hi.numel() * 4
              + wbase.numel() * 4 + nq * nblocks * SCAN_KB * ADC_QUERY_TILE * 8,
              float(BATCH) * rows * (PQ_M + 2), PEAK_F32_ADDS_PER_S)
    out = {"max_abs_err": err, "ms": sum(ms["sorted"]) / 2, "unsorted_ms": sum(ms["unsorted"]) / 2,
           "ab_ms": ms, "plain_ms": plain_ms, "library_composition_ms": library_ms, **b,
           "plan": spread,
           "shape": {"rows": rows, "m": PQ_M, "coarse": PQ_C, "clusters": PQ_K,
                     "batch": BATCH, "block_size": SCAN_BLOCK, "kb": SCAN_KB, "group": group},
           "compared": "partials == plain (bits); merged top-3 == kernel 3's (scores bit for "
                       "bit, ids through perm up to exact ties)"}
    del ext_u, ext_s, bias_u, bias_s, lut_bf, hi, lo

    # the host side around the kernel on small cases, card against CPU
    n, d, bq, k = 4000, 64, 16, 40  # 4,000 rows: the last tile is part padding
    cl_c, lut_c, ext_c, _, _ = adc_case(np.random.default_rng(seed + 7), 4096, d, bq, 8, 512)
    ext_c = ext_c[:n].numpy()
    # ties: 1,200 rows with query 0's best coarse id and best residual codes
    # score alike, top for it, and span blocks and tiles of the sorted layout
    ext_t = ext_c.copy()
    best_c = int(cl_c[0].argmax())
    ext_t[:1200, 0], ext_t[:1200, 1] = best_c // 256, best_c % 256
    ext_t[:1200, 2:] = lut_c[0].argmax(dim=1).numpy()
    g_c = adc_auto_group(n, bq, 256, 10)
    layouts = {}
    for name, e in (("random", ext_c), ("ties", ext_t)):
        srt, perm_c, counts_c = sort_codes_by_coarse(e, 512)
        plan_c = plan_sorted_coarse_windows(counts_c, n, 256, g_c)
        if plan_c is None:
            raise AssertionError(f"the window planner refused the small {name} case")
        layouts[name] = (torch.from_numpy(srt), plan_c)
    plan_c = layouts["random"][1]
    mask = np.random.default_rng(seed + 8).random(n) < 0.6
    cases = {  # name: (layout, plan, repair, mask in sorted order, valid_n, layout budget)
        "repair": ("random", plan_c, 256, None, n, False),
        "fallback": ("random", plan_c, 2, None, n, False),
        "layout_budget": ("random", plan_c, 2, None, n, True),
        "masked_padded": ("random", plan_c, 256, mask, n - 37, False),
        "hand_plan_outside_window": ("random", np.ones_like(plan_c), 256, None, n, False),
        "ties_across_blocks": ("ties", layouts["ties"][1], 256, None, n, True)}
    counts = {}
    for case, (layout, wb, repair, m, valid, lb) in cases.items():
        srt = layouts[layout][0]
        m_t = None if m is None else torch.from_numpy(m)
        args = dict(k=k, valid_n=valid, block_size=256, repair=repair, group=g_c,
                    layout_budget=lb)
        STATS.reset()
        got = scan_topk_residual_pq_adc_sorted_luts(
            cl_c.to(dev), lut_c.to(dev), srt.to(dev), torch.from_numpy(wb).to(dev),
            row_mask=None if m_t is None else m_t.to(dev), **args)
        counts[case] = {"launches": STATS.by_kernel.get("adc_scan_topk_sorted", 0),
                        "repairs": STATS.repairs, "fallbacks": STATS.fallbacks}
        check_bits(got, scan_topk_residual_pq_adc_sorted_luts(cl_c, lut_c, srt, wb, row_mask=m_t,
                                                               **args), case)
        if case == "ties_across_blocks":
            tied = int((got[0][0] == got[0][0, 0]).sum())
            if tied < k:
                raise AssertionError(f"ties: only {tied} of query 0's top {k} scores are tied")
    want = {"repair": ("repairs", 1), "fallback": ("fallbacks", 1),
            "layout_budget": ("repairs", 1), "ties_across_blocks": ("repairs", 1)}
    if any(counts[c][key] < least for c, (key, least) in want.items()) \
            or counts["layout_budget"]["fallbacks"] \
            or (dev.type == "cuda" and min(c["launches"] for c in counts.values()) < 1):
        raise AssertionError(f"the sorted scan's repair / fallback / kernel did not run: {counts}")
    out["cases"] = counts
    ph.info.update(out)
    return out


SEGMAX_K = 10  # k of the segment-max phase; kseg = min(k, block / 128) = 10
SEGMAX_BLOCK = 2048  # the Python functions' default block
SEGMAX_CLUSTERS = 4096


def check_ranked_by_exact(got, ref, rtol: float, exact) -> float:
    """A segment-max ranking against its plain version: scores within
    rtol·(1 + |s|); ids equal, or, where they differ, both rows' exact f64
    scores for that query within ID_RTOL·(1 + |s|) of each other (a near
    tie inside a segment or between segments, broken by another f32 sum
    order); ids equal at every -1e30 rank. ``exact(flat index, ids)``
    gives the f64 scores. Returns the largest score difference."""
    import torch

    (gs, gi), (rs, ri) = got, ref
    gs, rs = gs.double(), rs.double()
    diff = (gs - rs).abs()
    if bool((diff > rtol * (1 + rs.abs())).any()):
        raise AssertionError(f"segment-max scores differ by up to {float(diff.max())}")
    bad = (gi != ri).reshape(-1).nonzero()[:, 0]
    if bad.numel():
        if bool((rs.reshape(-1)[bad] <= -1e29).any()):
            raise AssertionError("segment-max ids differ at a -1e30 rank")
        eg = exact(bad, gi.reshape(-1)[bad].long())
        er = exact(bad, ri.reshape(-1)[bad].long())
        if bool(((eg - er).abs() > ID_RTOL * (1 + er.abs())).any()):
            raise AssertionError(f"segment-max ids differ at {bad.numel()} ranks, beyond near ties")
    real = rs > -1e29
    return float(diff[real].max()) if bool(real.any()) else 0.0


# (value, tie rule) cases the kernels' tiling touches: name → (rows, dim,
# queries, block_size, kseg, valid_n); run on the card for every dtype
SEGMAX_EDGE_CASES = {
    "valid_n_inside_a_segment_and_chunk": (3072, 64, 5, 512, 4, 1337),
    "blocks_past_valid_n": (3072, 64, 70, 512, 4, 1100),
    "odd_query_tiles": (2048, 64, 130, 1024, 8, 2048),
    "d32": (2048, 32, 64, 512, 4, 2000),
    "d_ragged_160": (2048, 160, 64, 512, 4, 2048),
    "block_256": (2048, 64, 64, 256, 2, 1999),
    "block_4096": (8192, 64, 64, 4096, 32, 8000),
    "d4096_streamed": (4096, 4096, 64, 2048, 16, 4096),
    "d512_streamed": (4096, 512, 130, 2048, 10, 4000),
}
# rows holding one vector per case of the tie test: block 0's segments 0
# and 3 (equal maxima across segments; lanes / quads apart inside each) and
# block 1's segment 1; query 0 must pick rows 9, then 424, and 1153
SEGMAX_TIE_ROWS = (9, 70, 384 + 40, 384 + 100, 1024 + 128 + 127, 1024 + 128 + 1)


def segmax_build_report(log: str, lib, d: int, block_size: int) -> dict:
    """Per instantiation of csrc/segmax_scan_topk.cu (keyed by its mangled
    template arguments): registers, spills and static shared memory from
    ptxas -v; the dynamic shared memory of one CTA of each dtype at (d,
    block_size); ptxas's wgmma remarks verbatim."""
    out = {dt: kernel_build_report(log, f"segmax_{dt}_kernel") for dt in ("f32", "bf16", "i8")}
    out["dynamic_smem_at_main_shape"] = {dt: lib.segmax_scan_topk_smem_bytes(mode, d, block_size)
                                         for dt, mode in (("f32", 0), ("bf16", 1), ("i8", 2))}
    if hasattr(lib, "segmax_scan_topk_queries_resident"):
        out["queries_resident_at_main_shape"] = {
            dt: bool(lib.segmax_scan_topk_queries_resident(mode, d, block_size))
            for dt, mode in (("bf16", 1), ("i8", 2))}
    out["wgmma_remarks"] = [ln.strip() for ln in log.splitlines() if "wgmma" in ln.lower()]
    return out


def segmax_operands(dtype, g, dev, rows, d, queries, tie: bool = False):
    """Unit rows and queries, padded to the query tile, in the kernel's
    operand form; ``tie`` copies query 0's direction into SEGMAX_TIE_ROWS."""
    import torch

    from crs_tpu_torch.ops import scalar_quantize
    from crs_tpu_torch.ops.scan import SEGMAX_QUERY_TILE, _pad_rows

    x = torch.randn((rows, d), generator=g, device=dev)
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    q = torch.randn((queries, d), generator=g, device=dev)
    if tie:
        x[list(SEGMAX_TIE_ROWS)] = q[0] / torch.linalg.vector_norm(q[0])
    if dtype == torch.int8:
        codes, scales = scalar_quantize(x)
        qc, qs = scalar_quantize(q)
        return (_pad_rows(qc, SEGMAX_QUERY_TILE).contiguous(),
                _pad_rows(qs, SEGMAX_QUERY_TILE).contiguous(), codes, scales)
    return _pad_rows(q.to(dtype), SEGMAX_QUERY_TILE).contiguous(), x.to(dtype).contiguous()


def segmax_exact(qq, v, nblocks: int, kseg: int):
    """f64 score of (the partials' flat index → its query, a row id)."""
    from crs_tpu_torch.ops.scan import SEGMAX_QUERY_TILE

    def exact(flat, ids):
        qrow = (flat // SEGMAX_QUERY_TILE // kseg // nblocks) * SEGMAX_QUERY_TILE \
            + flat % SEGMAX_QUERY_TILE
        return (qq[qrow].double() * v[ids].double()).sum(-1)

    return exact


def segmax_check(name: str, dtype, ops, block_size: int, kseg: int, valid_n: int):
    """One kernel call against its plain version on the same operands."""
    import torch

    from crs_tpu_torch.ops.scan import (
        block_topk_segmax, block_topk_segmax_int8, block_topk_segmax_int8_plain,
        block_topk_segmax_plain,
    )

    if dtype == torch.int8:
        args = (*ops, valid_n, kseg, block_size)
        got = block_topk_segmax_int8(*args)
        return got, check_bits(got, block_topk_segmax_int8_plain(*args), f"int8 {name}")
    args = (*ops, valid_n, kseg, block_size)
    got = block_topk_segmax(*args)
    nblocks = ops[1].shape[0] // block_size
    return got, check_ranked_by_exact(got, block_topk_segmax_plain(*args),
                                      FLOAT_RTOL["fp32" if dtype == torch.float32 else "bf16"],
                                      segmax_exact(ops[0], ops[1], nblocks, kseg))


def segmax_edge_cases(dev, seed: int, lib) -> dict:
    """SEGMAX_EDGE_CASES and the tie test on the card, each dtype's kernel
    against its plain version (int8 bit for bit); a case whose CTA the
    library's own plan does not fit in shared memory is listed as skipped."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 19)
    out = {}
    for mode, (dname, dtype) in enumerate((("fp32", torch.float32), ("bf16", torch.bfloat16),
                                           ("int8", torch.int8))):
        for case, (rows, d, queries, bs, kseg, valid) in SEGMAX_EDGE_CASES.items():
            if lib.segmax_scan_topk_smem_bytes(mode, d, bs) > SMEM_LIMIT:
                out[f"{dname}.{case}"] = "skipped: past one CTA's shared memory"
                continue
            _, err = segmax_check(case, dtype, segmax_operands(dtype, g, dev, rows, d, queries),
                                  bs, kseg, valid)
            out[f"{dname}.{case}"] = err
        (s, i), err = segmax_check("ties", dtype,
                                   segmax_operands(dtype, g, dev, 2048, 64, 64, tie=True),
                                   1024, 4, 2048)
        picks = [int(i[0, 0, 0, 0]), int(i[0, 0, 1, 0]), int(i[0, 1, 0, 0])]
        if picks != [9, 424, 1153] or float(s[0, 0, 0, 0]) != float(s[0, 0, 1, 0]):
            raise AssertionError(f"{dname} segment-max ties: picks {picks}, want [9, 424, 1153] "
                                 f"at equal maxima")
        out[f"{dname}.ties"] = err
    sync(dev)
    return out


def phase_kernel_segmax(ph: Phase, dev, seed: int, rows: int, build_logs: dict) -> dict:
    """Kernels 6 (fp32, bf16) and 7 at 1,048,576 × 384, B = 328, k = 10,
    block 2048 (kseg = 10) on a clustered corpus shuffled row-wise: each
    kernel against its plain version (kernel 7 bit for bit), the edge cases
    of SEGMAX_EDGE_CASES and the tie rule at small sizes, the scans through
    their ops entry points (the main path, counted), recall@10 against the
    exact f32 top-10; device ms of each kernel and its library composition
    in turns (kernel, composition, composition, kernel), bound, plain ms;
    each instantiation's registers, spills and shared memory."""
    import torch

    from crs_tpu_torch.ops import scalar_quantize, scan_topk_segmax, scan_topk_segmax_int8
    from crs_tpu_torch.ops.scan import (
        SEGMAX_QUERY_TILE, STATS, _finalize, _load_kernel_lib, _pad_rows, block_topk_segmax,
        block_topk_segmax_int8, block_topk_segmax_int8_plain, block_topk_segmax_plain,
    )
    from crs_tpu_torch.ops.topk import exact_topk

    lib = _load_kernel_lib("segmax_scan_topk.cu")
    build = segmax_build_report(build_logs.get("segmax_scan_topk.cu", ""), lib, DIM, SEGMAX_BLOCK)
    emit({"segmax_build": build})
    edge = segmax_edge_cases(dev, seed, lib)

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 9)
    centers = torch.randn((SEGMAX_CLUSTERS, DIM), generator=g, device=dev)
    assign = torch.sort(torch.randint(0, SEGMAX_CLUSTERS, (rows,), generator=g,
                                      device=dev)).values  # rows grouped by cluster…
    x = centers[assign] + 0.5 * torch.randn((rows, DIM), generator=g, device=dev)
    x = x[torch.randperm(rows, generator=g, device=dev)]  # …then shuffled, as segment max asks
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    del centers, assign
    q = x[torch.randint(0, rows, (BATCH,), generator=g, device=dev)]
    q = q + 0.1 * torch.randn(q.shape, generator=g, device=dev)
    q /= torch.linalg.vector_norm(q, dim=1, keepdim=True)
    kseg = min(SEGMAX_K, SEGMAX_BLOCK // 128)
    nblocks = rows // SEGMAX_BLOCK
    nq = -(-BATCH // SEGMAX_QUERY_TILE)
    out_bytes = nq * nblocks * kseg * SEGMAX_QUERY_TILE * 8
    exact_ids = exact_topk(x, q, SEGMAX_K, rows)[1].cpu().tolist()

    def recall(ids) -> float:
        return sum(len(set(a) & set(e)) for a, e in zip(ids.cpu().tolist(), exact_ids)) / (
            SEGMAX_K * BATCH)

    codes, scales = scalar_quantize(x)
    qc, qs = scalar_quantize(q)
    qc, qs = _pad_rows(qc, SEGMAX_QUERY_TILE).contiguous(), _pad_rows(qs, SEGMAX_QUERY_TILE)
    out = {"build": build, "edge_cases_max_abs_err": edge}
    for name, dtype, rate in (("fp32", torch.float32, PEAK_F32_OPS_PER_S),
                              ("bf16", torch.bfloat16, PEAK_BF16_OPS_PER_S),
                              ("int8", torch.int8, PEAK_INT8_OPS_PER_S)):
        if dtype == torch.int8:
            args = (qc, qs, codes, scales, rows, kseg, SEGMAX_BLOCK)
            kernel, plain = block_topk_segmax_int8, block_topk_segmax_int8_plain
            err = check_bits(kernel(*args), plain(*args), "int8 segment-max partials")
            got_final = _finalize(*kernel(*args), BATCH, SEGMAX_K)
            check_bits(got_final, _finalize(*plain(*args), BATCH, SEGMAX_K), "int8 segmax top-k")

            def library():  # dequantize, torch.matmul, segment max, torch.topk: four calls
                s = torch.matmul(q, (codes.float() * scales[:, None]).T)
                m = s.view(BATCH, rows // 128, 128).max(dim=-1)
                return torch.topk(m.values.view(BATCH, nblocks, -1), kseg, dim=-1)

            def int_mm():  # torch._int_mm (cuBLAS int8), the two scales, segment max, topk
                s = torch._int_mm(qc, codes.T).float() * qs[:, None] * scales[None, :]
                m = s.view(qc.shape[0], rows // 128, 128).max(dim=-1)
                return torch.topk(m.values.view(qc.shape[0], nblocks, -1), kseg, dim=-1)

            nbytes = codes.numel() + rows * 4 + qc.numel() + qs.numel() * 4 + out_bytes
            corpus_bytes = codes.numel() + rows * 4
        else:
            v = x.to(dtype)
            qq = _pad_rows(q.to(dtype), SEGMAX_QUERY_TILE).contiguous()
            args = (qq, v, rows, kseg, SEGMAX_BLOCK)
            kernel, plain = block_topk_segmax, block_topk_segmax_plain
            err = check_ranked_by_exact(kernel(*args), plain(*args), FLOAT_RTOL[name],
                                        segmax_exact(qq, v, nblocks, kseg))
            got_final = _finalize(*kernel(*args), BATCH, SEGMAX_K)
            ref_final = _finalize(*plain(*args), BATCH, SEGMAX_K)
            check_ranked_by_exact(
                got_final, ref_final, FLOAT_RTOL[name],
                lambda flat, ids, qq=qq, v=v: (qq[flat // SEGMAX_K].double()
                                               * v[ids].double()).sum(-1))
            q_real = q.to(dtype)

            def library(v=v, q_real=q_real):  # torch.matmul (TF32 off), segment max, topk
                s = torch.matmul(q_real, v.T)
                m = s.view(BATCH, rows // 128, 128).max(dim=-1)
                return torch.topk(m.values.view(BATCH, nblocks, -1), kseg, dim=-1)

            nbytes = v.numel() * v.element_size() + qq.numel() * qq.element_size() + out_bytes
            corpus_bytes = v.numel() * v.element_size()
        turns = [device_ms(dev, lambda: kernel(*args), iters=10, warmup=2),
                 device_ms(dev, library, iters=3), device_ms(dev, library, iters=3),
                 device_ms(dev, lambda: kernel(*args), iters=10, warmup=1)]
        ms = (turns[0] + turns[3]) / 2
        plain_ms = device_ms(dev, lambda: plain(*args), iters=2)
        extra = {}
        if dtype == torch.int8:
            int_mm_ms = [device_ms(dev, int_mm, iters=3) for _ in range(2)]
            extra = {"int_mm_composition_ms": sum(int_mm_ms) / 2,
                     "int_mm_composition": "torch._int_mm (cuBLAS int8) + the query and row "
                                           "scales + max over 128-row segments + torch.topk"}
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_composition_ms": (turns[1] + turns[2]) / 2, **extra,
                     "turns_kernel_library_library_kernel_ms": turns,
                     # device bytes the run can have moved, in corpus reads: ms · 3.35 TB/s
                     "corpus_reads_at_most": ms * 1e-3 * PEAK_BYTES_PER_S / corpus_bytes,
                     **bound(nbytes, 2.0 * BATCH * rows * DIM, rate)}

    # the main path: the ops entry points, counts to 0 just before, read just after
    xb = x.to(torch.bfloat16)
    STATS.reset()
    scans = {"fp32": lambda: scan_topk_segmax(x, q, SEGMAX_K, rows, SEGMAX_BLOCK),
             "bf16": lambda: scan_topk_segmax(xb, q, SEGMAX_K, rows, SEGMAX_BLOCK),
             "int8": lambda: scan_topk_segmax_int8(codes, scales, q, SEGMAX_K, rows,
                                                   SEGMAX_BLOCK)}
    for name, fn in scans.items():
        res = fn()
        out[name]["scan_ms"] = device_ms(dev, fn, iters=3)
        out[name]["recall_at_10_vs_f32_exact"] = recall(res[1])
        if not bool(torch.isfinite(res[0]).all()) or res[1].shape != (BATCH, SEGMAX_K):
            raise AssertionError(f"segmax {name}: bad result {res[0].shape}")
    launches = dict(STATS.by_kernel)
    for kname in ("segmax_scan_topk_f32", "segmax_scan_topk_bf16", "segmax_scan_topk_int8"):
        if dev.type == "cuda" and not launches.get(kname):
            raise AssertionError(f"{kname} never launched on its main path: {launches}")
    out["main_path_launches"] = launches
    out["shape"] = {"rows": rows, "dim": DIM, "batch": BATCH, "k": SEGMAX_K, "kseg": kseg,
                    "block_size": SEGMAX_BLOCK, "clusters": SEGMAX_CLUSTERS}
    out["library_composition"] = ("[dequantize +] torch.matmul (TF32 off) + max over 128-row "
                                  "segments + torch.topk per block: three or four calls")
    out["compared"] = ("int8 partials and top-10 == plain (bits); fp32 / bf16 scores within "
                       "rtol 1e-5 / 1e-2, ids equal or f64 near ties within 1e-5; the same on "
                       "SEGMAX_EDGE_CASES, and query 0's tie picks [9, 424, 1153]")
    ph.info.update(out)
    return out


ADD_ROWS = 65536
ADD_CALL = 4096


def phase_add(ph: Phase, dev, seed: int, shared: dict) -> dict:
    """VectorStore.add on the card: 65,536 new rows in 4,096-row calls into
    the full phase's 1M int8 store and the formats phase's residual pq store
    (FORMAT_ROWS)
    (short of the retrain); the int8 store against create_index over the same
    rows; the pq store's new codes against a CPU-side encode with the same
    codebooks; a `where`-filtered search on each grown store."""
    import numpy as np
    import torch

    from crs_tpu_torch.ops.pq import PQCodebook, ResidualPQ, residual_pq_encode
    from crs_tpu_torch.rag import VectorStore

    em, texts, emb, queries = (shared[k] for k in ("em", "texts", "emb", "queries"))
    stores = {"int8": shared.pop("int8_store"), "pq": shared.pop("pq_store")}
    new_texts, _ = synthetic_corpus(np.random.default_rng(seed + 10), ADD_ROWS)
    new_emb = em.embed_chunks(new_texts)
    n0s = {name: store.n for name, store in stores.items()}
    out = {"rows_added": ADD_ROWS, "rows_per_call": ADD_CALL, "rows_before": n0s}
    for name, store in stores.items():
        n0 = n0s[name]
        trained = store._pq_trained_n
        cap0 = store._padded_rows()
        times = []
        for r0 in range(0, ADD_ROWS, ADD_CALL):
            sync(dev)
            t0 = time.perf_counter()
            store.add(new_texts[r0:r0 + ADD_CALL], new_emb[r0:r0 + ADD_CALL])
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        if store.n != n0 + ADD_ROWS:
            raise AssertionError(f"add {name}: n = {store.n}, expected {n0 + ADD_ROWS}")
        if store._pq_trained_n != trained:
            raise AssertionError(f"add {name}: the PQ retrain fired")
        out[name] = {"ms_per_add": sum(times) / len(times), "ms_first_add": times[0],
                     "ms_max_add": max(times), "capacity_before": cap0,
                     "capacity_after": store._padded_rows()}
    q_emb = torch.cat([em.embed(queries), new_emb[:64]])

    # int8: the grown store against a build over the same rows
    scratch = VectorStore(BENCH_STORE, device=dev)
    scratch.create_index(texts + new_texts, torch.cat([emb, new_emb]))
    got, ref = stores["int8"].search_batch(q_emb, top_k=10), scratch.search_batch(q_emb, top_k=10)
    n, n0 = stores["int8"].n, n0s["int8"]
    if not (torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])
            and torch.equal(stores["int8"]._codes[:n], scratch._codes[:n])):
        raise AssertionError("add int8: search or codes differ from create_index over the rows")
    self_hits = float((got[1][BATCH:, 0].cpu() == torch.arange(n0, n0 + 64)).float().mean())
    out["int8"].update({"vs_create_index": "codes, ids and scores identical",
                        "new_rows_self_hit_at_1": self_hits})
    del scratch

    # pq: the new codes against the same codebooks' encode on the CPU
    pq, n0 = stores["pq"], n0s["pq"]
    rpq = ResidualPQ(rotation=pq._rpq.rotation.cpu(), coarse=pq._rpq.coarse.cpu(),
                     codebook=PQCodebook(pq._rpq.codebook.centroids.cpu()))
    cid_cpu, codes_cpu = residual_pq_encode(rpq, new_emb.cpu(), pq._aniso_eta())
    cid_dev = pq._pq_coarse_ids[n0:n0 + ADD_ROWS].cpu()
    codes_dev = pq._pq_codes[n0:n0 + ADD_ROWS].cpu()
    same_cid = cid_dev == cid_cpu.to(cid_dev.dtype)
    cid_agree = float(same_cid.float().mean())
    code_agree = float((codes_dev[same_cid] == codes_cpu[same_cid].to(codes_dev.dtype))
                       .float().mean())
    # near-equidistant centroids flip when the card sums the distances in
    # another order: at least 99.9 % of the assignments must agree
    if cid_agree < 0.999 or code_agree < 0.999:
        raise AssertionError(f"add pq: coarse ids agree {cid_agree}, codes {code_agree}")
    out["pq"].update({"coarse_ids_equal_to_cpu_encode": cid_agree,
                      "codes_equal_to_cpu_encode": code_agree,
                      "coarse_id_flips": int((~same_cid).sum())})

    # a `where`-filtered search on each grown store: a new row with shard 1
    for name, store in stores.items():
        n0 = n0s[name]
        j = (1 - n0) % 4
        store.metadatas = [{"shard": i % 4} for i in range(store.n)]
        res = store.search(new_emb[j], top_k=5, where={"shard": 1})
        if len(res["ids"][0]) != 5 or any(md["shard"] != 1 for md in res["metadatas"][0]) \
                or store.ids[n0 + j] not in res["ids"][0]:
            raise AssertionError(f"add {name}: the where-filtered search returned {res['ids']}")
        out[name]["where_search_top1_is_the_new_row"] = res["ids"][0][0] == store.ids[n0 + j]
    del stores
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ph.info.update(out)
    return out


# kernel_q4: the 1b linear layers (in → out) and mistral-7b's MLP, at R rows;
# "edge" adds N = 128 (one column slab) and a deep K into N = 1024
Q4_SHAPES = {"1b": ((2048, 2048), (2048, 1024), (2048, 5632), (5632, 2048), (2048, 32000)),
             "mistral-7b": ((4096, 14336), (14336, 4096))}
Q4_EDGE_SHAPES = {"edge": ((2048, 128), (5632, 1024))}
Q4_ROWS = (1, 8, 64)
Q4_EXTRA_ROWS = (3, 17)  # a partial n-tile, and the 4-tile design
Q4_GROUP = 128
# one 1b decode step's linear layers: q, k, v, o, gate, up, down per layer; lm_head
Q4_STEP_1B = ((2048, 2048), (2048, 1024), (2048, 1024), (2048, 2048), (2048, 5632),
              (2048, 5632), (5632, 2048))
Q4_RTOL = 1e-5  # |kernel − plain| ≤ Q4_RTOL · Σ_k |x_k·w_k,n|: only the f32 sum order differs
# each kind's launches in the profiler: one tensor-core kernel for both
Q4_KERNELS = {"int4": ("q4_mma_kernel",), "nf4": ("q4_mma_kernel",)}
# groups off the kernel's 16-row k step, (K, N, group_size): a step's two
# packed rows in two groups (8: gs2 4; 2: gs2 1), a group across steps (24)
Q4_GROUP_CASES = ((2048, 2048, 8), (3072, 2048, 24), (2048, 1024, 2))
ATTN_SHAPES = ((1, 2176), (1, 4096), (8, 2176), (8, 4096))  # (B, S); Hkv 8, G 2, hd 128
ATTN_EXTRA = tuple((grp, s) for grp in (1, 4, 8) for s in (128, 2176, 4096))  # (G, S), B 3
ATTN_TOL = 2.0 ** -7  # |kernel − plain| ≤ ATTN_TOL · Σ_s |p_s·v_s,d|: one bf16 step of p
ATTN_KERNELS = ("decode_attention_int8_",)  # the scores and the p·v launches
L2_BYTES = 50e6


def cold_copies(nbytes: float) -> int:
    """Copies of an operand to cycle through so a timed run reads ~150 MB,
    past the 50 MB L2: a decode step finds its weights and cache cold."""
    return max(1, math.ceil(3 * L2_BYTES / max(nbytes, 1)))


def device_union_ms(events) -> float:
    """ms covered by the union of the events' device intervals: a launch
    that overlaps another (a programmatic dependent launch) counts once."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def kernel_device_ms(fn, iters: int, names, tries: int = 3) -> float:
    """Mean device time per call of the kernels whose names contain one of
    ``names`` (the union of their intervals, so overlapping launches count
    once), from torch.profiler over ``iters`` calls; None when the profiler
    records no device time for them. A decode-sized launch is shorter than
    the host's work around it, so CUDA events around a loop would time the
    host. A session that recorded fewer launches of a kernel than there were
    calls (the profiler drops events now and then) is repeated, up to
    ``tries`` sessions."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and any(n in e.name for n in names)]
        counts = Counter(e.name for e in evs)
        if evs and min(counts.values()) >= iters:
            return device_union_ms(evs) / iters
    return None


def launch_trace(fn, iters: int, names, tries: int = 3) -> dict:
    """Device µs per call of each kernel whose name holds one of ``names``
    (torch.profiler over ``iters`` calls), its launches per call, and the
    µs from the first launch's start to the last one's end per call (gaps
    included); {"not measured": reason} when, in ``tries`` traces, the
    profiler never recorded a launch for every call (it may drop events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA and any(n in e.name for n in names)),
                     key=lambda e: e.time_range.start)
        if len(evs) >= iters:
            break
    else:
        return {"not measured": f"the profiler recorded {len(evs)} launches of {iters} calls "
                                f"in each of {tries} traces"}
    import re

    per = {}
    for e in evs:
        found = re.search(r"(\w*(?:%s)\w*)" % "|".join(map(re.escape, names)), e.name)
        key = found.group(1) if found else e.name[:90]
        t = per.setdefault(key, {"us": 0.0, "launches": 0})
        t["us"] += (e.time_range.end - e.time_range.start) / iters
        t["launches"] += 1
    for t in per.values():
        t["launches"] /= iters
    launches = len(evs) // iters
    spans = [evs[i + launches - 1].time_range.end - evs[i].time_range.start
             for i in range(0, launches * iters, launches)]
    return {"kernels": per, "launches_per_call": len(evs) / iters,
            "first_start_to_last_end_us": sum(spans) / len(spans)}


def nf4_plan_sweep(dev, g) -> dict:
    """Kernel 9's device ms over the plans it could take (width × K slices)
    at each 1b decode-step shape, R = 8, weights cold: the measurement that
    sets the planner's target grid (ops/qgemm.py NF4_BLOCKS_PER_SM)."""
    import torch

    from crs_tpu_torch.ops import qgemm
    from crs_tpu_torch.ops.launch import sm_count

    out = {}
    for k, n in sorted(set(Q4_STEP_1B)) + [(2048, 32000)]:
        k2, gs2 = k // 2, Q4_GROUP // 2
        codes = torch.randint(0, 256, (k2, n), generator=g, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        scales = torch.rand((k // Q4_GROUP, n), generator=g, device=dev) * 0.02 + 1e-3
        x = torch.randn((8, k), generator=g, device=dev).to(torch.bfloat16)
        copies = [(codes.clone(), scales.clone()) for _ in range(cold_copies(codes.numel()) - 1)]
        copies.append((codes, scales))
        chosen = qgemm.nf4_plan(8, k2, n, gs2, sm_count(dev))
        row = {"chosen": f"w{chosen.width} k{chosen.ksplit}"}
        groups = k2 // gs2
        for width in (16, 8):
            for want in (1, 2, 3, 4, 6, 8):
                per = -(-groups // want)
                plan = qgemm.Nf4Plan(1, width, -(-groups // per), per * gs2)
                key = f"w{width} k{plan.ksplit}"
                if key in row:
                    continue
                it = iter(range(1 << 30))

                def run(plan=plan, it=it):
                    c, sc = copies[next(it) % len(copies)]
                    qgemm._forward("nf4", x, c, sc, plan=plan)

                row[key] = {"blocks": plan.blocks(n),
                            "ms": kernel_device_ms(run, 30, Q4_KERNELS["nf4"])}
        out[f"{k}->{n}"] = row
        del copies
    return out


# faults: shapes crs_tpu serves that the port's kernels once refused on the
# card (8,192 rows = 8 blocks of config.json's 1,024, past the 4-block kernel
# threshold); each must launch its kernel
FAULT_ROWS = 8192
FAULT_BLOCK = 1024
FAULT_DIMS = (100, 3072)  # off kernel 1's 16-byte words; past one query slice and old limits
FAULT_QUERIES = 64
FAULT_K = 10
FAULT_PQ = {"format": "pq", "block_size": FAULT_BLOCK, "pq_subspaces": 64, "pq_iters": 8,
            "pq_coarse_clusters": 256, "pq_opq_iters": 1, "rescore_k": 64}  # a tile's LUTs past smem
FAULT_GROUP = 8  # q4 / NF4 groups of 8 rows: a k step's packed rows in two groups
# int8-KV models whose decode step the kernel once refused: G = 3 (padded to
# 4), G = 12 (padded to 16, two slices of 8), head_dim 256 and head_dim 640
# (past 512: the row in 512-byte segments)
FAULT_ATTN_MODELS = {
    "g3": {"vocab_size": 2048, "hidden_size": 768, "num_layers": 2, "num_heads": 6,
           "num_kv_heads": 2, "intermediate_size": 2048, "max_seq_len": 1024},
    "g12": {"vocab_size": 2048, "hidden_size": 1536, "num_layers": 2, "num_heads": 12,
            "num_kv_heads": 1, "intermediate_size": 2048, "max_seq_len": 1024},
    "hd256": {"vocab_size": 2048, "hidden_size": 1024, "num_layers": 2, "num_heads": 4,
              "num_kv_heads": 2, "intermediate_size": 2048, "max_seq_len": 1024},
    "hd640": {"vocab_size": 2048, "hidden_size": 2560, "num_layers": 2, "num_heads": 4,
              "num_kv_heads": 2, "intermediate_size": 2048, "max_seq_len": 1024},
}
# the ADC kernels over their plans, (M, residual, K): the skewed main path
# (M 5 at K 256, M 96 at K 16), 8 queries unskewed (M 50), 4, 2 and 1
# queries a CUDA block (M 64, 128, 256 at K = 256), the LUTs in slices (M 320)
# (H, I, chunk, R): kernel 11 past mistral-7b's width; xq in shared memory to H 27,136
FAULT_MLP_WIDE = ((16384, 2048, 1024, 1), (16384, 2048, 1024, 8), (27136, 1024, 1024, 8),
                  (28672, 1024, 1024, 8), (32768, 2048, 1024, 3))
FAULT_ADC_WIDE = tuple((m, r, k) for m, k in ((5, 256), (96, 16), (50, 256), (64, 256),
                                             (128, 256), (256, 256), (320, 256))
                       for r in (True, False))
# (H, I, chunk, R): kernel 11 at chunks off 128, below it, and past 16,384
# rows (hq and hmid in the chunk's slab of device memory)
FAULT_MLP_CHUNKS = ((4096, 1024, 64, 8), (4096, 960, 96, 3), (1024, 200, 40, 1),
                    (128, 24576, 24576, 8), (4096, 16512, 16512, 2))
# kernels 6 and 7 at the widths and blocks they once refused, name → (rows,
# D, queries, block_size, kseg, valid_n): D off 32 and 16 and past the old
# cap of 4,096, blocks of 3 segments (each ends in half a chunk), 64 (the
# most kept in shared memory) and 128 (the winners in a device scratch)
FAULT_SEGMAX = {
    "d40_block384": (3072, 40, 130, 384, 3, 3000),
    "d100_block8192": (16384, 100, 64, 8192, 16, 16000),
    "d4104_block384": (1536, 4104, 64, 384, 3, 1500),
    "d40_block8192": (16384, 40, 130, 8192, 64, 16384),
    "d64_block16384": (32768, 64, 64, 16384, 10, 32000),
}
# kernel 1 on blocks other than the main path's 256, name → (rows, D,
# queries, block_size, kb): several blocks a CTA (SPAN_CHUNKS 16, the last
# CTA's span short), one, a block of 32 chunks with the queries streamed,
# and blocks off the 256-row chunk whose last chunk is part masked (128 and
# 640 as int8 stores take them, an odd 1,000 at a ragged D, 24 below kb)
FAULT_INT8_BLOCKS = {
    "block512_d384": (8192, 384, 130, 512, 4),
    "block768_d384": (6144, 384, 64, 768, 3),
    "block1024_d100": (8192, 100, 64, 1024, 3),
    "block4096_d99": (16384, 99, 130, 4096, 5),
    "block8192_d3072": (16384, 3072, 64, 8192, 3),
    "block128_d384": (8192, 384, 130, 128, 4),
    "block640_d384": (6400, 384, 64, 640, 3),
    "block1000_d99": (9000, 99, 130, 1000, 5),
    "block24_d112": (4800, 112, 64, 24, 32),
}
FAULT_INT8_STORE_BLOCKS = (128, 640)  # int8 stores whose blocks are off kernel 1's chunk
# kernels 2 to 5 on blocks off their 256-row chunk (a block's last chunk part
# masked), over rows that are whole blocks of each, name → block_size; the
# ADC kernels at config.json's table (M 48, K 256: the skewed main path),
# M 64 (4 queries a CUDA block) and M 320 (the LUTs staged in slices)
FAULT_OFF_CHUNK_BLOCKS = (128, 384, 640)
FAULT_OFF_CHUNK_ROWS = 7680
FAULT_OFF_CHUNK_ADC = ((48, True), (64, True), (320, True), (48, False))
FAULT_OFF_CHUNK_STORES = (128, 640)  # fp32 and pq stores of these blocks
FAULT_OFF_CHUNK_PQ = {"format": "pq", "pq_subspaces": 48, "pq_iters": 8,
                      "pq_coarse_clusters": 256, "pq_opq_iters": 1, "rescore_k": 64}
RAGGED_COST_ROWS = 1 << 20  # the main path's corpus rows, for the cost of a D off the multiple


def fault_search(name: str, card, cpu, q, rtol: float, kernel: str) -> dict:
    """One search on the card store (its launches counted: ``kernel`` must
    run) against the CPU store holding the same state."""
    from crs_tpu_torch.ops import scan

    reset_counts()
    got = card.search_batch(q, top_k=FAULT_K)
    sync(q.device)
    launches = dict(scan.STATS.by_kernel)
    if launches.get(kernel, 0) < 1:
        raise AssertionError(f"faults {name}: {kernel} did not launch ({launches})")
    ref = cpu.search_batch(q.cpu(), top_k=FAULT_K + 1)
    err = check_float_ranked(got, ref, rtol, dim=1)
    return {"kernel": kernel, "launches": launches, "max_abs_err": err}


def fault_adc_wide(dev, seed: int) -> dict:
    """The ADC kernels at FAULT_ADC_WIDE against their plain version, bit for
    bit, 16 queries (two tiles) over 8,192 rows with a masked tail, and the
    kernel's plan for each (queries per CUDA block, subspaces staged)."""
    import torch

    from crs_tpu_torch.ops.scan import adc_layout, block_topk_adc, block_topk_adc_plain

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 22)
    out = {}
    for m, residual, k in FAULT_ADC_WIDE:
        nq, c = 16, 512
        lut = (torch.randn((nq, m, k), generator=g, device=dev) * 0.1).to(torch.bfloat16)
        codes = torch.randint(0, k, (FAULT_ROWS, m + (2 if residual else 0)), generator=g,
                              device=dev, dtype=torch.int32).to(torch.uint8)
        extra = ()
        if residual:
            codes[:, 0] = torch.randint(0, c // 256, (FAULT_ROWS,), generator=g, device=dev,
                                        dtype=torch.int32).to(torch.uint8)
            hi = torch.randn((nq, c), generator=g, device=dev).to(torch.bfloat16)
            extra = (hi, (torch.randn((nq, c), generator=g, device=dev) * 1e-3).to(torch.bfloat16))
        codes[100:140] = codes[0:40]  # exact ties
        bias = torch.zeros(FAULT_ROWS, device=dev)
        bias[-300:] = -1e30
        got = block_topk_adc(lut, codes, bias, 4, FAULT_BLOCK, *extra)
        ref = block_topk_adc_plain(lut, codes, bias, 4, FAULT_BLOCK, *extra)
        what = f"faults ADC M={m} K={k} {'residual' if residual else 'plain'}"
        err = check_bits(got, ref, what)
        plan = adc_layout(m, k, residual)
        out[f"m{m}_k{k}_{'residual' if residual else 'plain'}"] = {**plan._asdict(),
                                                                  "max_abs_err": err}
    return out


def fault_attention_wide(dev, seed: int) -> dict:
    """Kernel 10 at the shapes it once refused, against its plain version:
    head_dim 256, 384, 512, 640 and 1024 (past 512 in 512-byte segments), G
    12 and 16 (slices of 8 along the grid), and a cache longer than 128
    chunks (S = 139,264); B 3, Hkv 2, one row with no valid slot and one
    valid only in a window."""
    import torch

    from crs_tpu_torch.ops import decode_attention as da
    from crs_tpu_torch.ops.launch import sm_count

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 23)
    out = {}
    for hd, grp, s in ((256, 2, 2176), (384, 8, 2176), (512, 4, 2176), (640, 2, 2176),
                       (640, 8, 4096), (1024, 4, 2176), (1024, 16, 2176), (128, 12, 4096),
                       (128, 16, 2176), (256, 16, 2176), (128, 1, 139264)):
        b, hkv = 3, 2
        q, kc, ks, vc, vs = attn_case(g, dev, b, hkv, grp, s, hd)
        rows, nchunk = da.split_plan(b * hkv, s, sm_count(dev))
        valid = torch.ones((b, s), dtype=torch.bool, device=dev)
        valid[1] = False
        valid[0] = False
        lo = (nchunk // 2) * rows
        valid[0, lo + 3:min(s, lo + rows) - 5] = True
        err = attn_check((q, kc, ks, vc, vs, valid), f"hd={hd} G={grp} S={s}", zero_rows=(1,))
        out[f"hd={hd} G={grp} S={s}"] = {"max_abs_err": err, "launch_groups": da.launch_groups(grp),
                                         "chunk_rows": rows, "nchunk": nchunk}
    return out


def fault_mlp_wide(dev, seed: int, shapes=FAULT_MLP_WIDE) -> dict:
    """Kernel 11 at ``shapes`` against its plain version, as
    ``kernel_fused_mlp`` holds it: codes, output within ``mlp_check``'s
    tolerance, two launches bitwise equal. FAULT_MLP_WIDE: H 27,136 is the
    widest whose xq rows fit in shared memory; past it they go to device
    memory (the kernel's XG instance). FAULT_MLP_CHUNKS: chunks off 128
    (masked tiles) and past what shared memory holds (the HG instance)."""
    import torch

    from crs_tpu_torch.ops import fused_mlp as fm

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 24)
    out = {}
    for h, inter, chunk, r in shapes:
        x, norm, lay = mlp_case(g, dev, h, inter, chunk, r)
        before = fm.STATS.by_kernel.get("fused_mlp_int8", 0)
        got, kc = fm.fused_mlp_int8(x, norm, *lay, chunk=chunk, return_codes=True)
        again = fm.fused_mlp_int8(x, norm, *lay, chunk=chunk)
        launches = fm.STATS.by_kernel.get("fused_mlp_int8", 0) - before
        ref, pc = fm.emulate_fused_mlp_int8(x, norm, *lay, chunk=chunk, return_codes=True)
        if not torch.equal(got, again) or launches != 2:
            raise AssertionError(f"fused MLP H={h} R={r}: {launches} launches for 2 calls, or "
                                 f"two launches differ")
        out[f"H={h} I={inter} chunk={chunk} R={r}"] = {
            **mlp_check(got, ref, kc, pc, lay[4], lay[5], x, chunk), "launches": launches}
        del x, lay, got, ref, kc, pc
    return out


def fault_segmax_wide(dev, seed: int) -> dict:
    """Kernels 6 (fp32, bf16) and 7 at FAULT_SEGMAX against their plain
    versions (int8 bit for bit, the float kernels as ``kernel_segmax``
    holds them), each launch counted; bf16 at a D off 8 zero-padded as
    ``scan_topk_segmax`` pads it."""
    import torch

    from crs_tpu_torch.ops import scan

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 25)
    out = {}
    for dname, dtype, kernel in (("fp32", torch.float32, "segmax_scan_topk_f32"),
                                 ("bf16", torch.bfloat16, "segmax_scan_topk_bf16"),
                                 ("int8", torch.int8, "segmax_scan_topk_int8")):
        for case, (rows, d, queries, bs, kseg, valid) in FAULT_SEGMAX.items():
            ops = segmax_operands(dtype, g, dev, rows, d, queries)
            if dtype == torch.bfloat16:
                ops = tuple(scan._pad_cols(t, 8).contiguous() for t in ops)
            before = scan.STATS.by_kernel.get(kernel, 0)
            _, err = segmax_check(case, dtype, ops, bs, kseg, valid)
            launches = scan.STATS.by_kernel.get(kernel, 0) - before
            if launches != (dev.type == "cuda"):
                raise AssertionError(f"faults segmax {dname} {case}: {launches} launches")
            out[f"{dname}.{case}"] = {"max_abs_err": err, "launches": launches}
            del ops
    return out


def fault_int8_blocks(dev, seed: int) -> dict:
    """Kernel 1 at FAULT_INT8_BLOCKS against its plain version (ids
    identical, scores within 1e-6 relative), a masked tail and exact ties in
    block 0, each launch counted."""
    import torch

    from crs_tpu_torch.ops import scan
    from crs_tpu_torch.ops.quant import scalar_quantize

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 26)
    out = {}
    for case, (rows, d, queries, bs, kb) in FAULT_INT8_BLOCKS.items():
        x = torch.randn((rows, d), generator=g, device=dev)
        x[40:60] = x[0:20]
        codes, scales = scalar_quantize(x)
        ops = partial_inputs(codes, scales, torch.randn((queries, d), generator=g, device=dev),
                             rows - 300, block_size=bs)
        before = scan.STATS.by_kernel.get("int8_scan_topk", 0)
        err = compare_partials(scan.block_topk_int8(*ops, kb, bs),
                               scan.block_topk_int8_plain(*ops, kb, bs))
        launches = scan.STATS.by_kernel.get("int8_scan_topk", 0) - before
        if launches != (dev.type == "cuda"):
            raise AssertionError(f"faults int8 {case}: {launches} launches")
        out[case] = {"max_abs_err": err, "launches": launches}
        del x, codes, scales, ops
    return out


def fault_off_chunk_blocks(dev, seed: int) -> dict:
    """Kernels 2 to 5 at FAULT_OFF_CHUNK_BLOCKS against their plain versions
    (ADC bit for bit, float within FLOAT_RTOL), a whole masked block (its
    emissions: -1e30 at its first row), a masked tail, exact ties, each
    launch counted."""
    import torch

    from crs_tpu_torch.ops import scan

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 27)
    rows, out = FAULT_OFF_CHUNK_ROWS, {}

    def counted(kernel, fn):
        before = scan.STATS.by_kernel.get(kernel, 0)
        got = fn()
        if scan.STATS.by_kernel.get(kernel, 0) - before != 1:
            raise AssertionError(f"faults off-chunk {kernel}: not one launch")
        return got

    for bs in FAULT_OFF_CHUNK_BLOCKS:
        for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            qq, v, bias = float_edge_operands(g, dev, dtype, rows, DIM, 130, bs, (1,))
            kernel = "scan_topk_f32" if name == "fp32" else "scan_topk_bf16"
            got = counted(kernel, lambda: scan.block_topk_float(qq, v, bias, 4, bs))
            err = check_float_ranked(got, scan.block_topk_float_plain(qq, v, bias, 5, bs),
                                     FLOAT_RTOL[name], dim=2)
            if not (bool((got[0][:, 1] == -1e30).all()) and bool((got[1][:, 1] == bs).all())):
                raise AssertionError(f"faults off-chunk {name} block {bs}: a masked block's "
                                     f"emissions are not (-1e30, its first row)")
            out[f"{name}_block{bs}"] = {"kernel": kernel, "max_abs_err": err}
        for m, residual in FAULT_OFF_CHUNK_ADC:
            nq, c = 16, 512
            lut = (torch.randn((nq, m, 256), generator=g, device=dev) * 0.1).to(torch.bfloat16)
            codes = torch.randint(0, 256, (rows, m + (2 if residual else 0)), generator=g,
                                  device=dev, dtype=torch.int32).to(torch.uint8)
            codes[100:140] = codes[0:40]  # exact ties
            bias = torch.zeros(rows, device=dev)
            bias[bs:2 * bs] = -1e30
            bias[-300:] = -1e30
            extra = ()
            if residual:
                codes[:, 0] = torch.randint(0, c // 256, (rows,), generator=g, device=dev,
                                            dtype=torch.int32).to(torch.uint8)
                extra = (torch.randn((nq, c), generator=g, device=dev).to(torch.bfloat16),
                         (torch.randn((nq, c), generator=g, device=dev) * 1e-3).to(torch.bfloat16))
            kind = "residual" if residual else "plain"
            got = counted(f"adc_scan_topk_{kind}",
                          lambda: scan.block_topk_adc(lut, codes, bias, 4, bs, *extra))
            check_bits(got, scan.block_topk_adc_plain(lut, codes, bias, 4, bs, *extra),
                       f"faults off-chunk ADC M={m} {kind} block {bs}")
            out[f"adc_{kind}_m{m}_block{bs}"] = {"kernel": f"adc_scan_topk_{kind}",
                                                 "plan": scan.adc_layout(m, 256, residual)._asdict(),
                                                 "max_abs_err": 0.0}
            if residual and m == 48:  # kernel 4: the same rows under a two-window plan
                group = 2
                wide = [torch.nn.functional.pad(t, (0, 256)) for t in extra]
                wbase = torch.randint(0, 2, (rows // bs // group,), generator=g, device=dev,
                                      dtype=torch.int32)
                got = counted("adc_scan_topk_sorted", lambda: scan.block_topk_adc_sorted(
                    lut, codes, bias, 4, bs, *wide, wbase, group))
                check_bits(got, scan.block_topk_adc_sorted_plain(lut, codes, bias, 4, bs, *wide,
                                                                 wbase, group),
                           f"faults off-chunk sorted ADC block {bs}")
                out[f"adc_sorted_m{m}_block{bs}"] = {"kernel": "adc_scan_topk_sorted",
                                                     "max_abs_err": 0.0}
    return out


def fault_ragged_cost(dev, seed: int) -> dict:
    """What a D off the kernels' multiple costs a search at the main path's
    1,048,576 rows, B = 328, k = 64: a ragged D against the aligned D above
    it, ms per ``scan_topk`` (bf16 D 100: the corpus zero-padded to 104 per
    call) and ``scan_topk_int8`` (kernel 1's RAGGED staging: D 100 and 99
    staged by cp.async and shifted into place; 112 by TMA), timed in turns
    on the card; and kernel 1 alone (``block_topk_int8`` on the main path's
    blocks and kb) at those D, in turns, without the search's host work."""
    import torch

    from crs_tpu_torch.ops.quant import scalar_quantize
    from crs_tpu_torch.ops.scan import _default_kb_repair, block_topk_int8, scan_topk, \
        scan_topk_int8

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 24)
    out = {}
    for fmt, dims in (("bf16", (100, 104)), ("int8", (99, 100, 112)),
                      ("int8_kernel", (99, 100, 112))):
        fns = {}
        for d in dims:
            x = torch.randn((RAGGED_COST_ROWS, d), generator=g, device=dev)
            x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
            q = torch.randn((BATCH, d), generator=g, device=dev)
            if fmt == "bf16":
                v = x.to(torch.bfloat16)
                fns[d] = lambda v=v, q=q: scan_topk(v, q, CAND_K, RAGGED_COST_ROWS, SCAN_BLOCK)
            elif fmt == "int8_kernel":
                ops = partial_inputs(*scalar_quantize(x), q, RAGGED_COST_ROWS)
                kb = _default_kb_repair(CAND_K, ops[1].shape[0] // INT8_BLOCK, BATCH, 256)
                fns[d] = lambda ops=ops, kb=kb: block_topk_int8(*ops, kb, INT8_BLOCK)
            else:
                codes, scales = scalar_quantize(x)
                fns[d] = lambda c=codes, sc=scales, q=q: scan_topk_int8(c, sc, q, CAND_K,
                                                                        RAGGED_COST_ROWS)
            del x
        ms = {d: [] for d in dims}
        for d in (*dims, *reversed(dims)):
            ms[d].append(device_ms(dev, fns[d], iters=10, warmup=2))
        out[fmt] = {f"d{d}_ms": sum(v) / len(v) for d, v in ms.items()}
        for d in dims[:-1]:
            out[fmt][f"d{d}_over_d{dims[-1]}"] = out[fmt][f"d{d}_ms"] / out[fmt][f"d{dims[-1]}_ms"]
        del fns
    return out


def phase_faults(ph: Phase, dev, seed: int) -> dict:
    """ROADMAP §3's card-only refusals, repaired in the kernels, at small
    sizes, each through its entry point with its kernel's launches counted,
    against the port on the CPU: hashed stores at D ∈ FAULT_DIMS in fp32,
    bf16 and int8 (ids equal where the scores separate, scores within the
    kernels' tolerances); residual-pq stores at M = 64, unsorted and sorted
    (state copied to the CPU through save / load); the ADC kernels past one
    tile's LUTs, bit for bit; the 1b model as int4 and nf4 at group_size 8
    (first decode step's logits against the plain versions, 113 kernel
    launches a step); one int8-KV decode step of each FAULT_ATTN_MODELS
    model (logits against the CPU, one decode-attention launch a layer) and
    kernel 10 at head dims to 1024, G to 16 and S past 128 chunks; kernel
    11 at H to 32,768 and at FAULT_MLP_CHUNKS; kernels 6 and 7 at
    FAULT_SEGMAX; kernel 1 at FAULT_INT8_BLOCKS and under int8 stores of
    FAULT_INT8_STORE_BLOCKS rows a block; kernels 2 to 5 at
    FAULT_OFF_CHUNK_BLOCKS and under fp32 and pq stores of
    FAULT_OFF_CHUNK_STORES rows a block; what a ragged D costs a search and
    kernel 1 at 1M rows."""
    import tempfile

    import numpy as np
    import torch

    from crs_tpu_torch.models import create_model_interface
    from crs_tpu_torch.models.transformer import (
        TransformerConfig, decode_step, init_cache, init_params, prefill,
    )
    from crs_tpu_torch.ops.decode_attention import launch_groups
    from crs_tpu_torch.rag.embedding import EmbeddingModel
    from crs_tpu_torch.rag.index import VectorStore

    rng = np.random.default_rng(seed + 21)
    texts, queries = synthetic_corpus(rng, FAULT_ROWS)
    queries = queries[:FAULT_QUERIES]
    out = {}
    kernel_of = {"fp32": "scan_topk_f32", "bf16": "scan_topk_bf16", "int8": "int8_scan_topk"}
    for d in FAULT_DIMS:
        enc = EmbeddingModel({"backend": "hashed", "embedding_dim": d}, device="cpu")
        emb, q = enc.embed(texts), enc.embed(queries)
        for fmt in ("fp32", "bf16", "int8"):
            cfg = {"format": fmt, "block_size": FAULT_BLOCK, "rescore_k": 64}
            card, cpu = VectorStore(cfg, device=dev), VectorStore(cfg, device="cpu")
            card.create_index(texts, emb)
            cpu.create_index(texts, emb)
            out[f"{fmt}_d{d}"] = fault_search(f"{fmt} D={d}", card, cpu, q.to(dev),
                                              FLOAT_RTOL.get(fmt, FLOAT_RTOL["fp32"]),
                                              kernel_of[fmt])
            del card, cpu
    enc = EmbeddingModel({"backend": "hashed", "embedding_dim": DIM}, device="cpu")
    emb, q = enc.embed(texts), enc.embed(queries)
    for bs in FAULT_INT8_STORE_BLOCKS:  # kernel 1 on the store's own blocks
        cfg = {"format": "int8", "block_size": bs, "rescore_k": 64}
        card, cpu = VectorStore(cfg, device=dev), VectorStore(cfg, device="cpu")
        card.create_index(texts, emb)
        cpu.create_index(texts, emb)
        out[f"int8_store_block{bs}"] = fault_search(f"int8 block {bs}", card, cpu, q.to(dev),
                                                    FLOAT_RTOL["fp32"], "int8_scan_topk")
        del card, cpu
    card = VectorStore(FAULT_PQ, device=dev)
    card.create_index(texts, emb)
    with tempfile.TemporaryDirectory() as tmp:
        card.save(tmp)
        cpu = VectorStore(FAULT_PQ, device="cpu")
        cpu.load(tmp)
        out["pq_residual_m64"] = fault_search("pq M=64", card, cpu, q.to(dev),
                                              FLOAT_RTOL["fp32"], "adc_scan_topk_residual")
        sorted_cfg = {**FAULT_PQ, "pq_sorted": True}
        card_s, cpu_s = VectorStore(sorted_cfg, device=dev), VectorStore(sorted_cfg, device="cpu")
        card_s.load(tmp)
        cpu_s.load(tmp)
    out["pq_sorted_m64"] = fault_search("pq_sorted M=64", card_s, cpu_s, q.to(dev),
                                        FLOAT_RTOL["fp32"], "adc_scan_topk_sorted")
    del card, cpu, card_s, cpu_s
    for bs in FAULT_OFF_CHUNK_STORES:  # kernels 2 and 3 on the stores' own blocks
        cfg = {"format": "fp32", "block_size": bs, "rescore_k": 64}
        card, cpu = VectorStore(cfg, device=dev), VectorStore(cfg, device="cpu")
        card.create_index(texts, emb)
        cpu.create_index(texts, emb)
        out[f"fp32_store_block{bs}"] = fault_search(f"fp32 block {bs}", card, cpu, q.to(dev),
                                                    FLOAT_RTOL["fp32"], "scan_topk_f32")
        cfg = {**FAULT_OFF_CHUNK_PQ, "block_size": bs}
        card = VectorStore(cfg, device=dev)
        card.create_index(texts, emb)
        with tempfile.TemporaryDirectory() as tmp:
            card.save(tmp)
            cpu = VectorStore(cfg, device="cpu")
            cpu.load(tmp)
        out[f"pq_store_block{bs}"] = fault_search(f"pq block {bs}", card, cpu, q.to(dev),
                                                  FLOAT_RTOL["fp32"], "adc_scan_topk_residual")
        del card, cpu
    out["adc_wide_kernels"] = fault_adc_wide(dev, seed)

    prompts = rag_prompts(1)
    for kind in ("int4", "nf4"):
        kernel = "nf4_matmul" if kind == "nf4" else "q4_matmul"
        model = create_model_interface(kind, {"config": GEN_CONFIG, "kv_bits": 8, "seed": seed,
                                              "group_size": FAULT_GROUP}, device=dev)
        model.load()
        ids, mask = model.encode_batch(prompts, 4)
        cache = init_cache(model.cfg, 1, ids.shape[1] + 4, device=dev)
        logits, cache = prefill(model.params, model.cfg, ids, cache, mask)
        token = torch.argmax(logits[:, -1], dim=-1)
        reset_counts()
        got = first_step_logits(model, cache, token)
        sync(dev)
        counts = kernel_counts()
        if counts.get(kernel, 0) != Q4_LAUNCHES_PER_STEP_1B:
            raise AssertionError(f"faults {kind} group {FAULT_GROUP}: launches {counts} in one "
                                 f"decode step")
        with plain_kernels():
            ref = first_step_logits(model, cache, token)
        err = rel_l2(got.float(), ref.float())
        if not err <= GEN_LOGITS_RTOL or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"faults {kind} group {FAULT_GROUP}: first-step logits "
                                 f"{err} from the plain versions (limit {GEN_LOGITS_RTOL})")
        out[f"{kind}_group{FAULT_GROUP}"] = {"kernel": kernel, "launches": counts,
                                             "logits_rel_l2": err,
                                             "greedy_equal": bool(torch.equal(
                                                 got.argmax(-1), ref.argmax(-1)))}
        del model, cache
    for name, spec in FAULT_ATTN_MODELS.items():
        cfg = TransformerConfig(kv_bits=8, **spec)
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 200)))

        def step(where):  # prefill, then one decode step's logits
            params = init_params(seed, cfg, device=where)
            cache = init_cache(cfg, 1, 256, device=where)
            _, cache = prefill(params, cfg, ids.to(where), cache)
            reset_counts()
            logits = decode_step(params, cfg, torch.tensor([7], device=where), cache)[0]
            sync(torch.device(where) if isinstance(where, str) else where)
            return logits.float().cpu()

        ref = step("cpu")
        got = step(dev)
        counts = kernel_counts()
        err = rel_l2(got, ref)
        if counts.get("decode_attention_int8", 0) != cfg.num_layers or not err <= GEN_LOGITS_RTOL:
            raise AssertionError(f"faults {name}: launches {counts}, logits {err} from the CPU's")
        grp = cfg.num_heads // cfg.num_kv_heads
        out[f"decode_attention_{name}"] = {
            "kernel": "decode_attention_int8", "head_dim": cfg.head_dim, "group": grp,
            "launch_groups": launch_groups(grp),
            "launches": counts, "logits_rel_l2_vs_cpu": err}
    out["decode_attention_wide_kernels"] = fault_attention_wide(dev, seed)
    out["fused_mlp_wide_kernels"] = fault_mlp_wide(dev, seed)
    out["fused_mlp_chunks"] = fault_mlp_wide(dev, seed, FAULT_MLP_CHUNKS)
    out["segmax_widths_and_blocks"] = fault_segmax_wide(dev, seed)
    out["int8_scan_blocks"] = fault_int8_blocks(dev, seed)
    out["float_adc_blocks_off_chunk"] = fault_off_chunk_blocks(dev, seed)
    out["ragged_d_cost"] = fault_ragged_cost(dev, seed)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ph.info.update(out)
    return out


def q4_check(kind, kernel, plain, unpack, x, codes, scales, group: int, what: str):
    """One q4 / NF4 product against its plain version: |kernel − plain| ≤
    Q4_RTOL·Σ|x·w|; returns (that ratio, the largest |kernel − plain|)."""
    import torch

    k, n = x.shape[1], codes.shape[1]
    w = (unpack(codes).to(torch.bfloat16)
         * torch.repeat_interleave(scales, group, 0).to(torch.bfloat16)).float()
    got, ref = kernel(x, codes, scales), plain(x, codes, scales)
    absref = x.float().abs() @ w.abs()
    ratio = float(((got - ref).abs() / (absref + 1e-30)).max())
    if not ratio <= Q4_RTOL or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{kind} {what} {k}→{n} R={x.shape[0]}: kernel differs from the "
                             f"plain version by {ratio}·Σ|x·w| (limit {Q4_RTOL})")
    return ratio, float((got - ref).abs().max())


def q4_group_cases(dev, g, kinds, worst) -> dict:
    """Both kinds at Q4_GROUP_CASES (groups off the 16-row step), R ∈
    Q4_ROWS, against their plain versions on the same codes."""
    import torch

    out = {}
    for k, n, group in Q4_GROUP_CASES:
        raw = torch.randint(-128, 128, (k // 2, n), generator=g, device=dev,
                            dtype=torch.int32).to(torch.int8)
        scales = torch.rand((k // group, n), generator=g, device=dev) * 0.02 + 1e-3
        for r in Q4_ROWS:
            x = torch.randn((r, k), generator=g, device=dev).to(torch.bfloat16)
            for kind, (kernel, plain, unpack) in kinds.items():
                codes = raw.view(torch.uint8) if kind == "nf4" else raw
                ratio, err = q4_check(kind, kernel, plain, unpack, x, codes, scales, group,
                                      f"group {group}")
                worst[kind] = max(worst[kind], err)
                out[f"{kind} {k}->{n} group {group} R={r}"] = ratio
    sync(dev)
    return out


def phase_kernel_q4(ph: Phase, dev, seed: int) -> dict:
    """Kernels 8 and 9 against their plain versions at the 1b and mistral-7b
    widths and the edge shapes, R ∈ Q4_ROWS + Q4_EXTRA_ROWS, random codes
    (the same bytes for both) and scales; ms per launch (weights cold) of
    the two timed in turns 8, 9, 9, 8; plain and library-composition ms,
    bound. Returns each kernel's kernel-table numbers, the mean over one 1b
    decode step's 113 launches at R = 8."""
    import torch

    from crs_tpu_torch.ops import qgemm
    from crs_tpu_torch.ops.launch import sm_count

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 6)
    kinds = {"int4": (qgemm.q4_matmul, qgemm.emulate_q4_matmul, qgemm._unpack_int4),
             "nf4": (qgemm.nf4_matmul, qgemm.emulate_nf4_matmul, qgemm._unpack_nf4)}
    per_shape = {kind: {} for kind in kinds}
    worst = {kind: 0.0 for kind in kinds}
    int4_over_nf4 = {}
    for model, shapes in {**Q4_SHAPES, **Q4_EDGE_SHAPES}.items():
        for k, n in shapes:
            raw = torch.randint(-128, 128, (k // 2, n), generator=g, device=dev,
                                dtype=torch.int32).to(torch.int8)
            scales = torch.rand((k // Q4_GROUP, n), generator=g, device=dev) * 0.02 + 1e-3
            nbytes = raw.numel() + scales.numel() * 4
            copies = [(raw.clone(), scales.clone()) for _ in range(cold_copies(nbytes) - 1)]
            copies.append((raw, scales))
            for r in Q4_ROWS + Q4_EXTRA_ROWS:
                x = torch.randn((r, k), generator=g, device=dev).to(torch.bfloat16)
                timed = {}
                for kind, (kernel, plain, unpack) in kinds.items():
                    codes = raw.view(torch.uint8) if kind == "nf4" else raw
                    ratio, err = q4_check(kind, kernel, plain, unpack, x, codes, scales,
                                          Q4_GROUP, model)
                    worst[kind] = max(worst[kind], err)
                    it = iter(range(1 << 30))

                    def run(kernel=kernel, kind=kind, it=it):
                        c, sc = copies[next(it) % len(copies)]
                        kernel(x, c.view(torch.uint8) if kind == "nf4" else c, sc)

                    timed[kind] = run
                    row = {"max_abs_err": err, "err_over_abs_sum": ratio}
                    if r in Q4_ROWS:
                        row["wall_ms_per_call"] = device_ms(dev, run, iters=max(20, len(copies)),
                                                            warmup=3)
                        row["plain_ms"] = device_ms(dev, lambda: plain(x, codes, scales), iters=3)

                        def library(codes=codes, unpack=unpack):  # dequantize, then matmul in bf16
                            wd = (unpack(codes).float().view(k // Q4_GROUP, Q4_GROUP, n)
                                  * scales[:, None, :]).view(k, n).to(torch.bfloat16)
                            return torch.matmul(x, wd)

                        row["library_composition_ms"] = device_ms(dev, library, iters=5)
                    per_shape[kind][f"{model} {k}->{n} R={r}"] = row
                # in turns on the same codes: kernel 8, 9, 9, 8
                iters = max(20, len(copies))
                turns = {kind: [] for kind in kinds}
                for kind in ("int4", "nf4", "nf4", "int4"):
                    turns[kind].append(kernel_device_ms(timed[kind], iters, Q4_KERNELS[kind]))
                b = bound(nbytes + x.numel() * 2 + r * n * 4, 2.0 * r * k * n, PEAK_BF16_OPS_PER_S)
                key = f"{model} {k}->{n} R={r}"
                for kind in kinds:
                    got_turns = [t for t in turns[kind] if t is not None]
                    ms = sum(got_turns) / len(got_turns) if got_turns else None
                    row = per_shape[kind][key]
                    if ms is None and "wall_ms_per_call" not in row:
                        row["wall_ms_per_call"] = device_ms(dev, timed[kind], iters=iters, warmup=3)
                    row.update({"ms": ms if ms is not None else row["wall_ms_per_call"],
                                "device_ms": ms, "turns_ms": turns[kind],
                                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]})
                plan = qgemm.nf4_plan(r, k // 2, n, Q4_GROUP // 2, sm_count(dev))
                for kind in kinds:  # one plan for both kinds
                    per_shape[kind][key]["plan"] = {**plan._asdict(), "blocks": plan.blocks(n)}
                int4_over_nf4[key] = per_shape["int4"][key]["ms"] / per_shape["nf4"][key]["ms"]
            del copies
    step = list(Q4_STEP_1B) * 16 + [(2048, 32000)]  # 113 launches per 1b decode step
    out = {"plan_sweep": nf4_plan_sweep(dev, g)}
    for kind in kinds:
        def step_sum(key, kind=kind):
            return sum(per_shape[kind][f"1b {k}->{n} R=8"][key] for k, n in step)

        out[kind] = {"max_abs_err": worst[kind], "ms": step_sum("ms") / len(step),
                     "plain_ms": step_sum("plain_ms") / len(step),
                     "library_composition_ms": step_sum("library_composition_ms") / len(step),
                     "bound_ms": step_sum("bound_ms") / len(step), "bound_by": "bytes",
                     "step_ms_at_r8": step_sum("ms"), "step_bound_ms_at_r8": step_sum("bound_ms"),
                     "shapes": per_shape[kind]}
    out["int4_ms_over_nf4_ms"] = int4_over_nf4
    out["groups_off_the_step"] = q4_group_cases(dev, g, kinds, worst)
    for kind in kinds:
        out[kind]["max_abs_err"] = worst[kind]
    out["note"] = ("ms / plain_ms / bound_ms: mean per launch over one 1b decode step's 113 "
                   "launches at R = 8; ms is the kernels' device time (torch.profiler, every "
                   "launch of the design; the mean of two turns, 8, 9, 9, 8, on the same code "
                   "bytes; wall_ms_per_call is the host-bound call time by CUDA events); "
                   "weights cycled through copies past the L2; tolerance "
                   f"|kernel − plain| ≤ {Q4_RTOL}·Σ|x·w|")
    out["library_composition"] = "dequantize to bf16 + torch.matmul: two steps, not one call"
    ph.info.update(out)
    return out


def attn_case(g, dev, b: int, hkv: int, grp: int, s: int, hd: int = 128):
    """Random q, int8 cache and scales for decode attention."""
    import torch

    q = torch.randn((b, hkv, grp, hd), generator=g, device=dev)
    kc = torch.randint(-127, 128, (b, hkv, s, hd), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    vc = torch.randint(-127, 128, (b, hkv, s, hd), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    ks = torch.rand((b, hkv, s), generator=g, device=dev) * 0.05 + 1e-3
    vs = torch.rand((b, hkv, s), generator=g, device=dev) * 0.05 + 1e-3
    return q, kc, ks, vc, vs


def attn_check(ops, what: str, zero_rows=()) -> float:
    """Kernel 10 against its plain version within ATTN_TOL·Σ|p·v|, exact
    zeros on ``zero_rows``; returns the largest difference."""
    import torch

    from crs_tpu_torch.ops import decode_attention as da

    q, kc, ks, vc, vs, valid = ops
    hd = q.shape[-1]
    got, ref = da.decode_attention_int8(*ops), da.emulate_decode_attention_int8(*ops)
    scores = torch.einsum("bhgd,bhsd->bhgs", q.to(torch.bfloat16).float(), kc.float())
    scores = torch.where(valid[:, None, None, :], scores * (ks[:, :, None, :] / hd ** 0.5), -1e30)
    p = torch.softmax(scores, -1) * vs[:, :, None, :]
    abs_sum = torch.einsum("bhgs,bhsd->bhgd", p.abs(), vc.float().abs())
    excess = float(((got - ref).abs() - ATTN_TOL * abs_sum).max())
    if excess > 0 or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"decode attention {what}: kernel differs from the plain "
                             f"version past {ATTN_TOL}·Σ|p·v| (by {excess})")
    for r in zero_rows:
        if bool(got[r].any()):
            raise AssertionError(f"decode attention {what}: the all-masked row is not exact zeros")
    return float((got - ref).abs().max())


def phase_kernel_decode_attn(ph: Phase, dev, seed: int) -> dict:
    """Kernel 10 against its plain version at B ∈ {1, 8}, Hkv 8, G 2,
    hd 128, S ∈ {2176, 4096}: left-padded partial masks, and one all-masked
    row at B = 8 (exact zeros); ms (cache cold; both launches), plain and
    library ms, bound. Then G ∈ {1, 4, 8} × S ∈ {128, 2176, 4096} at B = 3:
    a row valid only in a window that leaves whole chunks masked, an
    all-masked row and a full row."""
    import torch

    from crs_tpu_torch.ops import decode_attention as da
    from crs_tpu_torch.ops.launch import sm_count

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 7)
    hkv, grp, hd = 8, 2, 128
    per_shape = {}
    worst = 0.0
    for b, s in ATTN_SHAPES:
        q, kc, ks, vc, vs = attn_case(g, dev, b, hkv, grp, s, hd)
        start = torch.randint(0, s // 2, (b,), generator=g, device=dev)
        length = torch.randint(s // 4, s // 2, (b,), generator=g, device=dev)
        pos = torch.arange(s, device=dev)[None, :]
        valid = (pos >= start[:, None]) & (pos < (start + length)[:, None])
        if b > 1:
            valid[b // 2] = False  # a batch row with no valid slot
        ops = (q, kc, ks, vc, vs, valid)
        err = attn_check(ops, f"B={b} S={s}", zero_rows=(b // 2,) if b > 1 else ())
        worst = max(worst, err)
        nbytes = 2 * (kc.numel() + ks.numel() * 4) + b * s * 4 + q.numel() * 4
        copies = [tuple(t.clone() for t in (kc, ks, vc, vs)) for _ in range(cold_copies(nbytes) - 1)]
        copies.append((kc, ks, vc, vs))
        it = iter(range(1 << 30))

        def run():
            c = copies[next(it) % len(copies)]
            da.decode_attention_int8(q, c[0], c[1], c[2], c[3], valid)

        wall_ms = device_ms(dev, run, iters=max(20, len(copies)), warmup=3)
        ms = kernel_device_ms(run, max(20, len(copies)), ATTN_KERNELS)
        launch_ms = {name: kernel_device_ms(run, max(20, len(copies)), (name,))
                     for name in ("int8_scores_kernel", "int8_pv_kernel")}
        plain_ms = device_ms(dev, lambda: da.emulate_decode_attention_int8(*ops), iters=3)
        bias = torch.where(valid, 0.0, -1e30)[:, None, None, :]

        def library():  # dequantize, einsum, softmax, einsum
            kd = (kc.float() * ks[..., None]).to(torch.bfloat16)
            vd = (vc.float() * vs[..., None]).to(torch.bfloat16)
            sc = torch.einsum("bhgd,bhsd->bhgs", q.to(torch.bfloat16), kd).float() / hd ** 0.5
            pr = torch.softmax(sc + bias, -1).to(torch.bfloat16)
            return torch.einsum("bhgs,bhsd->bhgd", pr, vd)

        library_ms = device_ms(dev, library, iters=5)
        bd = bound(nbytes + q.numel() * 4, 4.0 * b * hkv * grp * s * hd, PEAK_BF16_OPS_PER_S)
        rows, nchunk = da.split_plan(b * hkv, s, sm_count(dev))
        per_shape[f"B={b} S={s}"] = {"ms": wall_ms if ms is None else ms, "device_ms": ms,
                                     "wall_ms_per_call": wall_ms, "plain_ms": plain_ms,
                                     "library_composition_ms": library_ms,
                                     "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
                                     "max_abs_err": err, "chunk_rows": rows, "nchunk": nchunk,
                                     "blocks": b * hkv * nchunk, "launch_ms": launch_ms}
        del copies
    extra = {}
    for grp_x, s in ATTN_EXTRA:
        b = 3
        q, kc, ks, vc, vs = attn_case(g, dev, b, hkv, grp_x, s, hd)
        rows, nchunk = da.split_plan(b * hkv, s, sm_count(dev))
        valid = torch.ones((b, s), dtype=torch.bool, device=dev)
        valid[1] = False  # no valid slot: exact zeros
        valid[0] = False  # a window inside one chunk: every other chunk fully masked
        lo = (nchunk // 2) * rows
        valid[0, lo + 3:min(s, lo + rows) - 5] = True
        err = attn_check((q, kc, ks, vc, vs, valid), f"G={grp_x} S={s}", zero_rows=(1,))
        worst = max(worst, err)
        extra[f"G={grp_x} S={s}"] = {"max_abs_err": err, "chunk_rows": rows, "nchunk": nchunk}
    main = per_shape["B=8 S=2176"]  # the generate phase's batch-8 shape
    out = {"max_abs_err": worst, **{k: main[k] for k in ("ms", "plain_ms", "library_composition_ms",
                                                           "bound_ms", "bound_by")},
           "shapes": per_shape, "other_groups_b3": extra, "hkv": hkv, "group": grp,
           "head_dim": hd,
           "note": f"kernel-table numbers at B=8, S=2176 (ms: the device time of both "
                   f"launches by torch.profiler); tolerance |kernel − plain| ≤ "
                   f"{ATTN_TOL}·Σ_s|p·v|; cache cycled through copies past the L2",
           "library_composition": "dequantize + einsum + softmax + einsum: not one call"}
    ph.info.update(out)
    return out


MLP_SHAPES = ((4096, 14336, 1024, 1), (4096, 14336, 1024, 3), (4096, 14336, 1024, 8),
              (512, 1024, 256, 5))  # (H, I, chunk, R): mistral-7b's MLP, and a small multi-chunk one
MLP_MIN_AGREE = 0.999  # least share of equal xq / hq codes, kernel against plain
MLP_RTOL = 1e-6  # f32 rounding of the sums, relative to Σ|terms|, beside the flipped codes' effect
MLP_KERNELS = ("fused_mlp_",)  # the kernel's name in the profiler (one launch a call)


def mlp_case(g, dev, h: int, inter: int, chunk: int, r: int):
    """Random int8 weights in the kernel's layout with scales that keep g, u
    and y near 1, and rows x ~ N(0, 1)."""
    import torch

    from crs_tpu_torch.ops.fused_mlp import fused_mlp_layout

    def codes(k, n):
        return torch.randint(-127, 128, (k, n), generator=g, device=dev,
                             dtype=torch.int32).to(torch.int8)

    def scales(n, scale):
        return (torch.rand((n,), generator=g, device=dev) + 0.5) * scale

    layout = fused_mlp_layout(codes(h, inter), scales(inter, 1.0 / (73 * h ** 0.5)),
                              codes(h, inter), scales(inter, 1.0 / (73 * h ** 0.5)),
                              codes(inter, h), scales(h, 2.0 / (73 * inter ** 0.5)), chunk)
    x = torch.randn((r, h), generator=g, device=dev)
    norm = 1.0 + 0.1 * torch.randn((h,), generator=g, device=dev)
    return x, norm, layout


def mlp_check(got, ref, kc, pc, down, s_down, x, chunk: int) -> dict:
    """Kernel 11 against its plain version: xq and hq codes equal in at least
    MLP_MIN_AGREE of entries and never more than one step apart; the output
    within the flipped codes' effect, sd·Σ_c |hq_k·hs_k − hq_p·hs_p|·|down_c|,
    plus MLP_RTOL of the terms' magnitude."""
    import torch

    out = {}
    for name, k, p in (("xq", kc.xq, pc.xq), ("hq", kc.hq, pc.hq)):
        d = (k.int() - p.int()).abs()
        out[f"{name}_agreement"] = float((d == 0).float().mean())
        if out[f"{name}_agreement"] < MLP_MIN_AGREE or int(d.max()) > 1:
            raise AssertionError(f"fused MLP: {name} codes agree in {out[f'{name}_agreement']} "
                                 f"(limit {MLP_MIN_AGREE}), differ by up to {int(d.max())}")
    hs_k = kc.hs.double().repeat_interleave(chunk, 1)
    hs_p = pc.hs.double().repeat_interleave(chunk, 1)
    dabs = down.double().abs()
    flip = ((kc.hq.double() * hs_k - pc.hq.double() * hs_p).abs() @ dabs) * s_down.double()
    mag = ((pc.hq.double() * hs_p).abs() @ dabs) * s_down.double() + x.double().abs()
    tol = flip + MLP_RTOL * mag
    diff = (got.double() - ref.double()).abs()
    out["max_abs_err"] = float(diff.max())
    out["max_err_over_tol"] = float((diff / tol).max())
    if not bool((diff <= tol).all()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"fused MLP: kernel differs from the plain version past the "
                             f"tolerance ({out['max_err_over_tol']}× it)")
    return out


def phase_kernel_fused_mlp(ph: Phase, dev, seed: int) -> dict:
    """Kernel 11 against its plain version at mistral-7b's MLP (H 4096,
    I 14336, chunk 1024) for R ∈ {1, 3, 8} and one small multi-chunk case;
    device ms per call (torch.profiler), each launch's device µs and the
    launches a call (the launch trace), plain ms, the unfused int8 route's
    ms (the library composition), bound."""
    import torch

    from crs_tpu_torch.models.quantized import _int8_act_matmul
    from crs_tpu_torch.ops import fused_mlp as fm

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 11)
    per_shape = {}
    for h, inter, chunk, r in MLP_SHAPES:
        x, norm, lay = mlp_case(g, dev, h, inter, chunk, r)
        gate_t, sg2, up_t, su2, down, sd = lay
        got, kc = fm.fused_mlp_int8(x, norm, *lay, chunk=chunk, return_codes=True)
        ref, pc = fm.emulate_fused_mlp_int8(x, norm, *lay, chunk=chunk, return_codes=True)
        again = fm.fused_mlp_int8(x, norm, *lay, chunk=chunk)
        if not torch.equal(got, again):
            raise AssertionError("fused MLP: two launches on the same inputs differ")
        info = mlp_check(got, ref, kc, pc, down, sd, x, chunk)
        wall_ms = device_ms(dev, lambda: fm.fused_mlp_int8(x, norm, *lay, chunk=chunk), iters=20,
                            warmup=3)
        trace = launch_trace(lambda: fm.fused_mlp_int8(x, norm, *lay, chunk=chunk), 20,
                             MLP_KERNELS)
        ms = (sum(t["us"] for t in trace["kernels"].values()) / 1e3
              if "kernels" in trace and trace["launches_per_call"] >= 1 else None)
        plain_ms = device_ms(dev, lambda: fm.emulate_fused_mlp_int8(x, norm, *lay, chunk=chunk),
                             iters=3)
        gate_c, up_c = gate_t.T.contiguous(), up_t.T.contiguous()
        sg, su = sg2.reshape(-1), su2.reshape(-1)

        def library():  # the unfused int8 route: RMSNorm, 3 × torch._int_mm, silu·up
            xn = x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-5) * norm
            gg = _int8_act_matmul(xn, gate_c, sg)
            uu = _int8_act_matmul(xn, up_c, su)
            return x + _int8_act_matmul(torch.nn.functional.silu(gg) * uu, down, sd)

        library_ms = device_ms(dev, library, iters=10, warmup=2)
        del gate_c, up_c
        nbytes = 3 * inter * h + 2 * inter * 4 + 2 * h * 4 + 2 * r * h * 4
        b = bound(nbytes, 2.0 * r * 3 * inter * h, PEAK_INT8_OPS_PER_S)
        per_shape[f"H={h} I={inter} chunk={chunk} R={r}"] = {
            **info, "ms": wall_ms if ms is None else ms, "device_ms": ms,
            "clusters": inter // chunk,
            "wall_ms_per_call": wall_ms, "plain_ms": plain_ms,
            "library_composition_ms": library_ms, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "launch_trace": trace}
        del lay, gate_t, up_t, down
    main = per_shape["H=4096 I=14336 chunk=1024 R=8"]  # a batch-8 decode step's shape
    out = {"max_abs_err": max(v["max_abs_err"] for v in per_shape.values()),
           **{k: main[k] for k in ("ms", "plain_ms", "library_composition_ms", "bound_ms",
                                   "bound_by")},
           "shapes": per_shape,
           "note": "kernel-table numbers at mistral-7b, R = 8 (ms: the kernel's device time per "
                   "call by torch.profiler); tolerance: xq / hq codes equal in at least "
                   f"{MLP_MIN_AGREE} of entries, output within the flipped codes' effect plus "
                   f"{MLP_RTOL}·Σ|terms|",
           "library_composition": "RMSNorm + three torch._int_mm products + silu·up (the port's "
                                  "unfused int8 route): not one call"}
    ph.info.update(out)
    return out


# the decode weight-streaming tools (crs_tpu_torch/tools/) and their three kernels
GEMV_TOL = 1e-5  # |kernel − plain| ≤ GEMV_TOL·Σ|x·w|: f32 sums in another order
# (R, K, N, g): the tool's defaults (timed), other groups (16 and 4 packed rows at g 64 and
# 256: masked products), and an N that is no multiple of 16 (the kernel's cp.async route)
GEMV_Q4_SHAPES = ((32, 2048, 32000, 16), (32, 2048, 32000, 8), (32, 2048, 32000, 4),
                  (32, 2048, 32000, 64), (32, 2048, 32000, 256), (32, 2048, 32004, 16))
GEMV_Q8_SHAPES = ((8, 2048), (1, 2048), (16, 2048), (3, 2048), (12, 2048),
                  (8, 4096))  # (R, d): the chain's, and off it
# (R, d): the chain's (timed), other rows of x, one chunk of 512, and d 4096 / 8192 (the ring)
GEMV_DB_SHAPES = ((8, 2048), (1, 2048), (3, 2048), (5, 2048), (7, 2048), (8, 512), (8, 4096),
                  (8, 8192))
GEMV_CHAIN = {"d": 2048, "layers": 96, "r": 8, "g": 16, "reps": 5, "n1": 1, "n2": 5}  # the defaults
GEMV_Q4_TOOL = {"r": 32, "k": 2048, "n": 32000, "g": 16}  # bench_q4_kernel's defaults
GEMV_KERNELS = {"q4_probe_matmul": ("q4_probe_kernel",), "q8_gemv": ("q8_gemv_kernel",),
                "db_gemv": ("db_gemv_kernel",), "q4_matmul": ("q4_mma_kernel",)}
# a library call's bf16 output against the f32 plain version: |lib − plain| ≤
# GEMV_LIB_TOL·Σ|x·w·s| (the output rounded to bf16, 2⁻⁹ of |out| ≤ Σ; the
# weights' scale in bf16, 2⁻⁹ of each term)
GEMV_LIB_TOL = 2.0 ** -8


def gemv_check(got, ref, abs_sum, what: str, exact: bool = False) -> dict:
    """A probe kernel against its plain version: bit for bit (``exact``: the
    unfolded int4 path, whose f32 operations run in the plain version's
    order) or within GEMV_TOL·Σ|x·w|."""
    import torch

    diff = (got.double() - ref.double()).abs()
    ratio = float((diff / abs_sum.double().clamp_min(1e-30)).max())
    ok = torch.equal(got, ref) if exact else ratio <= GEMV_TOL
    if not (ok and bool(torch.isfinite(got).all())):
        raise AssertionError(f"gemv {what}: kernel differs from the plain version by "
                             f"{float(diff.max())} ({ratio} of Σ|x·w|)")
    return {"max_abs_err": float(diff.max()), "err_over_abs_sum": ratio}


def gemv_time(dev, fn, copies, kernel: str) -> dict:
    """Device ms a launch (torch.profiler) with the operands cycled through
    ``copies`` past the L2 (the chain streams distinct weights), beside the
    CUDA events' wall ms a call."""
    it = iter(range(1 << 30))

    def run():
        fn(*copies[next(it) % len(copies)])

    iters = max(20, len(copies))
    ms = kernel_device_ms(run, iters, GEMV_KERNELS[kernel])
    wall = device_ms(dev, run, iters=iters, warmup=3)
    return {"ms": wall if ms is None else ms, "device_ms": ms, "wall_ms_per_call": wall,
            "copies": len(copies)}


def cuda_op_missing(*ops) -> str:
    """Why the card's torch cannot run ``aten::<op>`` for every op on a CUDA
    tensor, or "" when it registers a CUDA kernel for each."""
    import torch

    for op in ops:
        if not torch._C._dispatch_has_kernel_for_dispatch_key(f"aten::{op}", "CUDA"):
            return f"torch {torch.__version__} registers no CUDA kernel for aten::{op}"
    return ""


def library_time(call, args, ref, abs_sum, what: str) -> dict:
    """One PyTorch call that computes a kernel's function: its bf16 output
    on ``args[0]`` held against the plain version within
    GEMV_LIB_TOL·Σ|x·w·s|, then its device ms a call (every kernel it
    launches, torch.profiler) with the operands cycled through ``args``
    (copies past the L2, as the kernel is timed). Timed here, used nowhere in
    the port."""
    got = call(*args[0])
    diff = (got.double() - ref.double()).abs()
    ratio = float((diff / abs_sum.double().clamp_min(1e-30)).max())
    if not (ratio <= GEMV_LIB_TOL and bool(got.float().isfinite().all())):
        raise AssertionError(f"gemv: {what} differs from the plain version by {float(diff.max())} "
                             f"({ratio} of Σ|x·w·s|)")
    it = iter(range(1 << 30))
    ms = kernel_device_ms(lambda: call(*args[next(it) % len(args)]), max(20, len(args)),
                          ("",))  # every device event of the call
    return {"library_ms": ms, "library_call": what, "library_max_abs_err": float(diff.max()),
            "library_err_over_abs_sum": ratio}


def db_library(dev, x, codes, scale) -> dict:
    """Row 14's one call: torch._weight_int8pack_mm(bf16 x [R, K], int8 w
    [N, K], N bf16 scales) → bf16 [R, N]."""
    import torch

    from crs_tpu_torch.ops import gemv_probe as gp

    what = "torch._weight_int8pack_mm(x bf16 [8, 2048], w int8 [2048, 2048], scales bf16 [2048])"
    missing = cuda_op_missing("_weight_int8pack_mm")
    if missing:
        return {"library_ms": None, "library_note": missing}
    xb = x.to(torch.bfloat16)
    sc = torch.full((codes.shape[0],), scale, dtype=torch.bfloat16, device=dev)
    abs_sum = (xb.float().abs() @ codes.float().abs().T) * scale
    return library_time(lambda c: torch._weight_int8pack_mm(xb, c, sc),
                        [(codes.clone(),) for _ in range(cold_copies(codes.numel()))],
                        gp.emulate_db_gemv(x, codes, scale), abs_sum, what)


def int4pack(codes, scales):
    """The int4 weight of [K/2, N] int8 codes (k = 2i in the low nibble of
    byte i, k = 2i + 1 in the high one, signed) for torch._weight_int4pack_mm:
    the codes as unsigned q = s + 8 (zero point 0) packed by
    torch._convert_weight_to_int4pack (even k in the high nibble of a byte of
    the [N, K/2] weight), and the [groups, N] scales with zeros as
    [groups, N, 2] bf16."""
    import torch

    p = codes.to(torch.int32) & 0xFF
    lo, hi = (p & 0xF) ^ 8, ((p >> 4) & 0xF) ^ 8  # k = 2i, 2i + 1 as q = s + 8
    wp = torch._convert_weight_to_int4pack(((lo << 4) | hi).T.contiguous().to(torch.uint8), 8)
    return wp, torch.stack([scales, torch.zeros_like(scales)], dim=2).to(
        torch.bfloat16).contiguous()


def q4_library(dev, gen) -> dict:
    """Row 8 at the chain tool's q4 layer (d 2048, R 8, groups of 128):
    kernel 8's device ms there (weights past the L2), and the one call
    torch._weight_int4pack_mm on the same weight, packed once by
    :func:`int4pack`."""
    import torch

    from crs_tpu_torch.ops import qgemm

    d, r, grp = GEMV_CHAIN["d"], GEMV_CHAIN["r"], GEMV_CHAIN["g"]
    gs = d // grp
    codes = torch.randint(-128, 128, (d // 2, d), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
    scales = torch.full((grp, d), 1e-2 / d ** 0.5, device=dev) * (
        torch.rand((grp, d), generator=gen, device=dev) + 0.5)  # random: a wrong group shows
    x = torch.randn((r, d), generator=gen, device=dev)
    copies = [(codes.clone(), scales.clone()) for _ in range(cold_copies(codes.numel()))]
    ref = qgemm.emulate_q4_matmul(x, codes, scales)
    w = qgemm._unpack_int4(codes).float() * scales.repeat_interleave(gs, 0)
    xb = x.to(torch.bfloat16)
    abs_sum = xb.float().abs() @ w.abs()
    row = gemv_check(qgemm.q4_matmul(x, codes, scales), ref, abs_sum, f"q4 R={r} d={d} g={grp}")
    row.update(gemv_time(dev, lambda c, s: qgemm.q4_matmul(x, c, s), copies, "q4_matmul"))
    row["shape"] = {"R": r, "K": d, "N": d, "group": gs}
    what = (f"torch._weight_int4pack_mm(x bf16 [{r}, {d}], int4pack of [{d}, {d}], {gs}, "
            f"scales and zeros bf16 [{grp}, {d}, 2])")
    missing = cuda_op_missing("_convert_weight_to_int4pack", "_weight_int4pack_mm")
    if missing:
        return {**row, "library_ms": None, "library_note": missing}
    packed = [int4pack(c, s) for c, s in copies]
    lib = library_time(lambda wp, sz: torch._weight_int4pack_mm(xb, wp, gs, sz), packed,
                       ref, abs_sum, what)
    return {**row, **lib}


def refused(call, *args) -> dict:
    """``call(*args)``, or the refusal of a library call in its own words
    (a RuntimeError: the op takes no such shape on this card)."""
    try:
        return call(*args)
    except RuntimeError as e:
        return {"library_ms": None, "library_note": f"refused: {str(e).splitlines()[0]}"}


def q8_library(dev, x, codes, scales) -> dict:
    """Row 13's one call at the chain tool's layer: torch._weight_int8pack_mm(bf16 x
    [R, K], int8 w [N, K], N bf16 scales) → bf16 [R, N], the [K, N] weight of
    kernel 13 transposed once, outside the timed calls."""
    import torch

    from crs_tpu_torch.ops import gemv_probe as gp

    r, (k, n) = x.shape[0], codes.shape
    what = (f"torch._weight_int8pack_mm(x bf16 [{r}, {k}], w int8 [{n}, {k}] (the [{k}, {n}] "
            f"weight transposed once), scales bf16 [{n}])")
    missing = cuda_op_missing("_weight_int8pack_mm")
    if missing:
        return {"library_ms": None, "library_note": missing}
    xb = x.to(torch.bfloat16)
    sc = scales.reshape(-1).to(torch.bfloat16)
    abs_sum = (xb.float().abs() @ codes.float().abs()) * scales
    copies = [(codes.T.contiguous(),) for _ in range(cold_copies(codes.numel()))]
    return refused(library_time, lambda w: torch._weight_int8pack_mm(xb, w, sc), copies,
                   gp.emulate_q8_gemv(x, codes, scales), abs_sum, what)


def q4_probe_library(dev, xe, xo, xs, codes, scales) -> dict:
    """Row 12's one call at bench_q4_kernel's defaults: torch._weight_int4pack_mm
    on x = xe and xo interleaved (x[:, 2i] = xe[:, i], x[:, 2i+1] = xo[:, i];
    small integers, exact in bf16) and the probe's int4 weight (even k in the
    low nibble of a byte of the [K/2, N] codes) packed once by
    torch._convert_weight_to_int4pack, per-group scales (K/g rows a group) and
    zeros. The probe's per-row x scale ``xs`` is left out of the call: it is
    held against the plain version over ``xs``."""
    import torch

    from crs_tpu_torch.ops import gemv_probe as gp
    from crs_tpu_torch.ops import qgemm

    (rt, k2), (grp, n) = xe.shape, scales.shape
    k = 2 * k2
    gs = k // grp
    what = (f"torch._weight_int4pack_mm(x bf16 [{rt}, {k}], int4pack of [{k}, {n}], {gs}, "
            f"scales and zeros bf16 [{grp}, {n}, 2])")
    missing = cuda_op_missing("_convert_weight_to_int4pack", "_weight_int4pack_mm")
    if missing:
        return {"library_ms": None, "library_note": missing}
    xb = torch.stack([xe, xo], dim=2).reshape(rt, k).to(torch.bfloat16)
    ref = gp.emulate_q4_probe_matmul(xe, xo, xs, codes, scales) / xs
    w = qgemm._unpack_int4(codes).float() * scales.repeat_interleave(gs, 0)
    abs_sum = xb.float().abs() @ w.abs()

    def timed():
        packed = [int4pack(codes.clone(), scales) for _ in range(cold_copies(codes.numel()))]
        return library_time(lambda wp, sz: torch._weight_int4pack_mm(xb, wp, gs, sz), packed,
                            ref, abs_sum, what)

    return refused(timed)


def phase_gemv(ph: Phase, dev, seed: int) -> dict:
    """The decode weight-streaming tools on the card: (a) the three probe
    kernels against their plain versions at the tools' default shapes and
    off them (A at g 16, 8, 4, 64, 256 and N 32004, every unpack and fold;
    B at R 8, 1, 16, 3, 12 and d 4096; C at R 8, 1 and d 4096), each
    kernel's device ms (weights past the L2), plain and composition ms,
    bound; (b) both tools with every variant at their defaults through
    their own functions (CUDA graphs),
    counts reset before and read after: ms/chain, GB/s, bound and launches
    a chain; (c) the q4 chain (kernel 8) also eagerly, a launch at a time;
    (d) one layer of the int8, dq4 and i4native variants under
    torch.profiler: its device time by kernel. Rows 14, 8, 13 and 12 also get
    the one PyTorch call that computes their function (:func:`db_library`,
    :func:`q4_library`, :func:`q8_library`, :func:`q4_probe_library`), or its
    refusal."""
    import numpy as np
    import torch

    from crs_tpu_torch.ops import gemv_probe as gp
    from crs_tpu_torch.tools import bench_chain_gemv as bcg
    from crs_tpu_torch.tools import bench_q4_kernel as bqk
    from crs_tpu_torch.tools.timing import launch_counts

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 18)
    out = {"q4_probe_matmul": {}, "q8_gemv": {}, "db_gemv": {}}
    part_s, t_part = {}, [time.perf_counter()]  # host seconds of each part of the phase

    def part(name):
        now = time.perf_counter()
        part_s[name] = part_s.get(name, 0.0) + now - t_part[0]
        t_part[0] = now

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int32).to(
            torch.int8)

    # (a) A: every unpack, unfolded and fold; random scales, so the tiled fold mapping shows
    for r, k, n, grp in GEMV_Q4_SHAPES:
        rt, k2 = max(32, -(-r // 32) * 32), k // 2
        codes = ints(-128, 128, (k2, n))
        scales = torch.rand((grp, n), generator=g, device=dev) * 0.015 + 0.005
        xs = torch.rand((rt, 1), generator=g, device=dev) + 0.5
        xi = (ints(-20, 20, (rt, k2)), ints(-20, 20, (rt, k2)))
        for var in bqk.VARIANTS[1:]:
            fold = var.startswith("fold_")
            unpack = var.split("_")[-1] if fold else var
            xe, xo = (t.to(torch.bfloat16) for t in xi) if fold else xi
            got = gp.q4_probe_matmul(xe, xo, xs, codes, scales, unpack=unpack, fold=fold)
            ref = gp.emulate_q4_probe_matmul(xe, xo, xs, codes, scales, unpack=unpack, fold=fold)
            if fold:
                wlo, whi = gp.fold_weights(codes, scales, unpack)
                abs_sum = (xe.float().abs() @ wlo.float().abs()
                           + xo.float().abs() @ whi.float().abs()) * xs
            else:
                abs_sum = ref.abs()
            row = gemv_check(got, ref, abs_sum, f"{var} K={k} N={n} g={grp}", exact=not fold)
            if (r, k, n, grp) == GEMV_Q4_SHAPES[0]:
                fn = lambda c, s, xe=xe, xo=xo, unpack=unpack, fold=fold: gp.q4_probe_matmul(
                    xe, xo, xs, c, s, unpack=unpack, fold=fold)
                row.update(gemv_time(dev, fn, [(codes.clone(), scales.clone()) for _ in
                                               range(cold_copies(codes.numel()))],
                                     "q4_probe_matmul"))
                row["ms_one_matrix"] = kernel_device_ms(lambda: fn(codes, scales), 20,
                                                        GEMV_KERNELS["q4_probe_matmul"])
                row["plain_ms"] = device_ms(dev, lambda: gp.emulate_q4_probe_matmul(
                    xe, xo, xs, codes, scales, unpack=unpack, fold=fold), iters=3)
                b = bound(codes.numel() + scales.numel() * 4 + 2 * xe.numel() * xe.element_size()
                          + rt * 4 + rt * n * 4, 2.0 * rt * k * n,
                          PEAK_BF16_OPS_PER_S if fold else PEAK_INT8_OPS_PER_S)
                row.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
                if var == "i32":  # row 12's one call, on the same codes
                    part("q4_probe")
                    row.update(q4_probe_library(dev, xe, xo, xs, codes, scales))
                    part("q4_probe_library")
            out["q4_probe_matmul"][f"{var} R={r} K={k} N={n} g={grp}"] = row
        if (r, k, n, grp) == GEMV_Q4_SHAPES[0]:  # an unpack + per-group int8 products (_int_mm)
            xe, xo = xi
            gs2 = k2 // grp

            def composition():
                p = codes.to(torch.int32)
                lo = torch.bitwise_right_shift(torch.bitwise_left_shift(p, 28), 28).to(torch.int8)
                hi = torch.bitwise_right_shift(p, 4).to(torch.int8)
                acc = torch.zeros((rt, n), dtype=torch.float32, device=dev)
                for gi in range(grp):
                    rows = slice(gi * gs2, (gi + 1) * gs2)
                    ints_ = (torch._int_mm(xe[:, rows].contiguous(), lo[rows])
                             + torch._int_mm(xo[:, rows].contiguous(), hi[rows]))
                    acc = acc + ints_.float() * scales[gi]
                return acc * xs

            ref = gp.emulate_q4_probe_matmul(xe, xo, xs, codes, scales)
            # a yardstick: sums in another order (xs once, not per K-step)
            gemv_check(composition(), ref, torch.full_like(ref, float(ref.abs().max())),
                       "the composition")
            out["q4_probe_library_composition_ms"] = device_ms(dev, composition, iters=5)
        del codes, xi
    part("q4_probe")
    # B and C at the chain's shapes and off them
    for r, d in GEMV_Q8_SHAPES:
        codes = ints(-127, 128, (d, d))
        scales = torch.full((1, d), 1e-2 / d ** 0.5, device=dev) * (
            torch.rand((1, d), generator=g, device=dev) + 0.5)
        x = torch.randn((r, d), generator=g, device=dev)
        got, ref = gp.q8_gemv(x, codes, scales), gp.emulate_q8_gemv(x, codes, scales)
        abs_sum = (x.to(torch.bfloat16).float().abs() @ codes.float().abs()) * scales
        row = gemv_check(got, ref, abs_sum, f"q8 R={r} d={d}")
        if (r, d) == GEMV_Q8_SHAPES[0]:
            row.update(gemv_time(dev, lambda c, s: gp.q8_gemv(x, c, s), [
                (codes.clone(), scales.clone()) for _ in range(cold_copies(codes.numel()))],
                "q8_gemv"))
            row["plain_ms"] = device_ms(dev, lambda: gp.emulate_q8_gemv(x, codes, scales), iters=5)
            row["library_composition_ms"] = device_ms(dev, lambda: torch.matmul(
                x.to(torch.bfloat16), codes.to(torch.bfloat16)).float() * scales, iters=10)
            b = bound(d * d + d * 4 + r * d * 2 + r * d * 4, 2.0 * r * d * d, PEAK_BF16_OPS_PER_S)
            row.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
            part("q8_gemv")
            row.update(q8_library(dev, x, codes, scales))  # row 13's one call
            part("q8_library")
        out["q8_gemv"][f"R={r} d={d}"] = row
    part("q8_gemv")
    for r, d in GEMV_DB_SHAPES:
        codes = ints(-127, 128, (d, d))
        x = torch.randn((r, d), generator=g, device=dev)
        scale = 1e-2 / d ** 0.5
        got, ref = gp.db_gemv(x, codes, scale), gp.emulate_db_gemv(x, codes, scale)
        abs_sum = (x.to(torch.bfloat16).float().abs() @ codes.float().abs().T) * scale
        row = gemv_check(got, ref, abs_sum, f"db R={r} d={d}")
        if (r, d) == GEMV_DB_SHAPES[0]:
            row.update(gemv_time(dev, lambda c: gp.db_gemv(x, c, scale), [
                (codes.clone(),) for _ in range(cold_copies(codes.numel()))], "db_gemv"))
            row["plain_ms"] = device_ms(dev, lambda: gp.emulate_db_gemv(x, codes, scale), iters=5)
            row["library_composition_ms"] = device_ms(dev, lambda: torch.matmul(
                x.to(torch.bfloat16), codes.to(torch.bfloat16).T).float() * scale, iters=10)
            b = bound(d * d + r * d * 2 + r * d * 4, 2.0 * r * d * d, PEAK_BF16_OPS_PER_S)
            row.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
            part("db_gemv")
            row.update(db_library(dev, x, codes, scale))
            part("db_library")
        out["db_gemv"][f"R={r} d={d}"] = row
    del codes
    part("db_gemv")
    out["q4_library"] = q4_library(dev, g)  # row 8's one-call library time
    empty_cache(dev)
    part("q4_library")

    # (b) the tools, every variant, at their defaults: the main path
    reset_counts()
    lines = []
    t0 = time.perf_counter()
    chain_res, chain_failed = bcg.run_variants(list(bcg.VARIANTS), device=dev, report=lines.append,
                                               **GEMV_CHAIN)
    chain_s = time.perf_counter() - t0
    empty_cache(dev)
    t0 = time.perf_counter()
    q4_res, q4_failed = bqk.run_variants(list(bqk.VARIANTS), device=dev, report=lines.append,
                                         **GEMV_Q4_TOOL)
    q4tool_s = time.perf_counter() - t0
    counted = launch_counts()
    if chain_failed or q4_failed:
        raise AssertionError(f"gemv: variants failed: {chain_failed + q4_failed}: {lines}")
    for name in ("q4_probe_matmul", "q8_gemv", "db_gemv", "q4_matmul"):
        if counted.get(name, 0) < 1:
            raise AssertionError(f"gemv: {name} was never launched on the tools' path: {counted}")
    values = {v: res["value"] for v, res in q4_res.items()}
    if not all(math.isfinite(v) for v in values.values()) or values["i32"] != values["i16"]:
        raise AssertionError(f"gemv: bench_q4_kernel's sums {values} (i32 and i16 must agree)")
    for var, res in chain_res.items():
        if not math.isfinite(res["ms_per_chain"]) or res["ms_per_chain"] <= 0:
            raise AssertionError(f"gemv: {var}'s chain took {res['ms_per_chain']} ms")
    launches = {"q4_probe_matmul": sum(res["launches"].get("q4_probe_matmul", 0)
                                       for res in q4_res.values()),
                "q8_gemv": chain_res["q8pallas"]["launches"].get("q8_gemv", 0),
                "db_gemv": chain_res["pldb"]["launches"].get("db_gemv", 0),
                "q4_matmul": chain_res["q4"]["launches"].get("q4_matmul", 0)}
    out["chain"] = {"args": GEMV_CHAIN, "seconds": chain_s, "variants": chain_res}
    out["q4_tool"] = {"args": GEMV_Q4_TOOL, "seconds": q4tool_s, "variants": q4_res}
    out["tool_lines"] = lines
    out["main_path_launches"] = launches
    out["wrapper_counts"] = counted
    part("tools")

    # (c) the q4 chain, a launch at a time (no graph), beside its graph time
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((GEMV_CHAIN["r"], GEMV_CHAIN["d"])).astype(
        np.float32)).to(dev)
    step, ws, _ = bcg.draw_variant("q4", rng, GEMV_CHAIN["d"], GEMV_CHAIN["layers"],
                                   GEMV_CHAIN["r"], GEMV_CHAIN["g"], dev)
    eager = bcg.timed_chain(step, ws, x0, GEMV_CHAIN["n1"], GEMV_CHAIN["n2"], GEMV_CHAIN["reps"],
                            graph=False)
    del ws
    graph_ms = chain_res["q4"]["ms_per_chain"]
    out["q4_chain_eager_vs_graph"] = {
        "eager_ms_per_chain": eager["seconds"] * 1e3, "graph_ms_per_chain": graph_ms,
        "eager_us_per_layer": eager["seconds"] * 1e6 / GEMV_CHAIN["layers"],
        "graph_us_per_layer": graph_ms * 1e3 / GEMV_CHAIN["layers"],
        "kernel_8_bound_us_per_layer": chain_res["q4"]["bound_ms"] * 1e3 / GEMV_CHAIN["layers"]}
    part("q4_chain_eager")
    # (d) what a layer of the composed variants spends on the card, by kernel (one layer)
    out["step_profiles"] = {}
    for var in ("int8", "dq4", "i4native"):
        step, ws, _ = bcg.draw_variant(var, np.random.default_rng(seed), GEMV_CHAIN["d"], 1,
                                       GEMV_CHAIN["r"], GEMV_CHAIN["g"], dev)
        w = {k: v[0] for k, v in ws.items()}
        step(x0, w)
        sync(dev)
        out["step_profiles"][var] = device_profile(lambda: step(x0, w),
                                                   device_ms(dev, lambda: step(x0, w), iters=20))
    empty_cache(dev)
    part("step_profiles")
    out["part_seconds"] = part_s
    out["note"] = ("kernel ms: device time a launch (torch.profiler), operands cycled through "
                   "copies past the L2; q4_probe ms_one_matrix: the tool's one-matrix loop (L2 "
                   "warm); chain ms: CUDA graphs of n1 and n2 repetitions, "
                   "(t2 − t1)/(n2 − n1); "
                   "unfolded probe bit for bit, the rest within "
                   f"{GEMV_TOL}·Σ|x·w|")
    ph.info.update(out)
    return out


TOOLS_DOCUMENT = os.path.join(REPO, "report", "paper", "figures", "pq_curve_4m.pdf")
# at batches 1 and 8; 16 tokens and 2 runs where the tool takes 40 and 3 (for time)
TOOLS_DECODE = ["--config", "1b", "--bits", "4", "--kv-bits", "8", "--n2", "16", "--runs", "2"]
TOOLS_DECODE_BATCHES = (1, 8)
TOOLS_PREFILL_TYPES = ("bf16", "int8")
TOOLS_PQ_ROWS = 2_000_000  # bench_pq_serving's rows here (40M by default: a 15.4 GB mirror)
TOOLS_SCALE_ROWS = 2_000_000  # bench_scale's rows here (10M by default: a 15 s host draw a run),
# still not a whole number of its 4,096-row blocks
TOOLS_FUSED_MLP = ["--layers", "4"]  # 705 MB of int8 weights, 14× the L2 (8 layers by default)
TOOLS_QUICKSTART_TOKENS = 16  # the quickstart's generations (the default config's 256: ~37 s)
# each tool's printed JSON keys: the JAX tool's, plus the device and the eager host clock
TOOLS_KEYS = {
    "bench_decode": {"config", "bits", "kv_bits", "batch", "prefill", "decode_ms_per_token",
                     "tokens_per_sec", "t_n1_s", "t_n2_s", "device"},
    "bench_prefill_mfu": {"prefill_mfu_percent", "prefill_tflops_achieved", "prefill_batch",
                          "prefill_seq_len", "prefill_tokens_per_sec", "config", "type",
                          "device"},
    "bench_fused_mlp": {"xla_int8", "fused", "device"},
    "bench_scale": {"rows", "dim", "batch", "k", "engine", "block_size", "kb", "scan_ms",
                    "ms_per_query", "effective_gbps", "host_scan_ms", "device"},
    "bench_pq_serving": {"rows", "dim", "bytes_per_vec_hbm", "hbm_gb", "scan_ms", "ms_per_query",
                         "recall_at_k_none", "recall_k_in_cand", "cand", "k", "sorted_coarse",
                         "host_rescore_ms", "recall_at_k_host", "host_mirror_gb", "host_scan_ms",
                         "device"},
}
# the kernels each run must launch (its counts are read around it)
TOOLS_KERNELS = {"bench_decode": ("q4_matmul", "decode_attention_int8"),
                 "bench_fused_mlp": ("fused_mlp_int8",), "bench_scale": ("int8_scan_topk",),
                 "bench_pq_serving": ("adc_scan_topk_residual",),
                 "bench_pq_serving_sorted": ("adc_scan_topk_sorted",),
                 "pq_serving": ("adc_scan_topk_residual",)}
# kernel table row → its count on the tools' path
TOOLS_LAUNCH_KEY = {"int8_scan_topk": "int8_scan_topk",
                    "adc_scan_topk_residual": "adc_scan_topk_residual",
                    "adc_scan_topk_sorted": "adc_scan_topk_sorted", "q4_matmul": "q4_matmul",
                    "decode_attention_int8": "decode_attention_int8",
                    "fused_mlp_int8": "fused_mlp_int8"}
# the scan shapes the tools' path must hold against the plain versions: bench_scale's (kernel
# 1; its engines' k 64 and 128 may launch one shape), bench_pq_serving's and the example's
# (kernel 3), the sorted layout's (4)
TOOLS_HELD = {"block_topk_int8": 1, "block_topk_adc": 2, "block_topk_adc_sorted": 1}
TOOLS_PAD_BLOCK = 4096  # bench_scale's block: 10,000,000 rows are not a whole number of them


@contextlib.contextmanager
def scans_held_against_plain(checks: dict):
    """While open, the first call of each scan kernel's wrapper at each shape
    is held against its plain version on the same operands (the tool's own
    data, at its shape): int8 ids identical and scores within 1e-6 relative,
    ADC bit for bit. The plain versions launch nothing."""
    from crs_tpu_torch.ops import scan

    pairs = {"block_topk_int8": (scan.block_topk_int8_plain, compare_partials),
             "block_topk_adc": (scan.block_topk_adc_plain, None),
             "block_topk_adc_sorted": (scan.block_topk_adc_sorted_plain, None)}
    originals = {name: getattr(scan, name) for name in pairs}

    def held(name):
        plain, compare = pairs[name]

        def call(*args, **kwargs):
            out = originals[name](*args, **kwargs)
            key = (f"{name} {[tuple(a.shape) for a in args[:2]]} "
                   f"{[a for a in (*args, *kwargs.values()) if isinstance(a, int)]}")
            if key not in checks:
                ref = plain(*args, **kwargs)
                err = compare(out, ref) if compare else check_bits(out, ref, key)
                checks[key] = {"max_abs_err": err, "partials": list(out[0].shape)}
            return out

        return call

    for name in pairs:
        setattr(scan, name, held(name))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(scan, name, fn)


def run_tool(main, argv, what: str, kernels=(), keys=None, **kwargs) -> dict:
    """``main(argv, **kwargs)`` in this process, its standard output kept: its
    exit code (must be 0), seconds, the launches by kernel around it (each
    of ``kernels`` at least once), its printed lines and, given ``keys``, its
    last line's JSON (exactly those keys)."""
    import io

    from crs_tpu_torch.tools.timing import launch_counts

    before = launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv, **kwargs)
    seconds = time.perf_counter() - t0
    print(f"tools: {what} exited {rc} after {seconds:.1f} s", file=sys.stderr, flush=True)
    after = launch_counts()
    launches = {k: v - before.get(k, 0) for k, v in after.items() if v > before.get(k, 0)}
    lines = buf.getvalue().strip().splitlines()
    if rc != 0:
        raise AssertionError(f"tools: {what} exited {rc}: {lines[-5:]}")
    missing = [k for k in kernels if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"tools: {what} never launched {missing}: {launches}")
    out = {"argv": argv, "seconds": seconds, "launches": launches}
    if keys is None:
        out["lines"] = lines
        return out
    last = json.loads(lines[-1])
    if set(last) != keys:
        raise AssertionError(f"tools: {what} printed the keys {sorted(last)}, not {sorted(keys)}")
    out["json"] = last
    if len(lines) > 1:
        out["lines"] = lines[:-1]
    return out


def finite_positive(value, what: str) -> None:
    if not (isinstance(value, (int, float)) and math.isfinite(value) and value > 0):
        raise AssertionError(f"tools: {what} is {value}")


def pad_copy_cost(dev, seed: int) -> dict:
    """bench_scale's default corpus (10,000,000 × 384 int8 rows, not a whole
    number of 4,096-row blocks): the device ms of the copy into whole
    blocks that ``scan_topk_int8`` makes on every call, beside the whole
    scan's (B 64, k 64) and the scan of the 9,998,336 rows that need no
    copy (2,441 blocks), each timed by CUDA events; the data drawn on the
    card."""
    import torch

    from crs_tpu_torch.ops.scan import _pad_rows, scan_topk_int8

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 21)
    n, d = 10_000_000, 384
    codes = torch.randint(-127, 128, (n, d), generator=g, device=dev, dtype=torch.int8)
    scales = torch.rand((n,), generator=g, device=dev) * (0.5 / 127) + 0.5 / 127
    q = torch.randn((64, d), generator=g, device=dev)
    whole = n // TOOLS_PAD_BLOCK * TOOLS_PAD_BLOCK
    out = {"rows": n, "whole_block_rows": whole, "block": TOOLS_PAD_BLOCK}
    out["pad_copy_ms"] = device_ms(dev, lambda: _pad_rows(codes, TOOLS_PAD_BLOCK), iters=5)
    out["scan_ms"] = device_ms(dev, lambda: scan_topk_int8(codes, scales, q, 64, n), iters=5)
    cw, sw = codes[:whole], scales[:whole]
    out["scan_ms_whole_blocks"] = device_ms(dev, lambda: scan_topk_int8(cw, sw, q, 64, whole),
                                            iters=5)
    out["pad_copy_share"] = out["pad_copy_ms"] / out["scan_ms"]
    del codes, scales, cw, sw
    empty_cache(dev)
    return out


def phase_tools(ph: Phase, dev, seed: int) -> dict:
    """The seven serving and scale scripts of the port on the card, each
    through its own ``main`` as a user runs it (standard output captured):
    the quickstart on the repository's PDF (its generations cut to
    TOOLS_QUICKSTART_TOKENS tokens); bench_decode (1b, int4 weights:
    kernel 8; int8 KV: kernel 10) at batches 1 and 8 (TOOLS_DECODE's
    tokens and runs); bench_prefill_mfu (1b, bf16 and int8);
    bench_fused_mlp at mistral-7b's widths over TOOLS_FUSED_MLP's layers
    (kernel 11 against the int8 route); bench_scale with both engines
    (kernel 1) at TOOLS_SCALE_ROWS rows;
    bench_pq_serving unsorted (kernel 3) and then ``--sorted-coarse``
    (kernel 4) from the first run's ``--codes-cache`` in a temporary
    directory, at TOOLS_PQ_ROWS rows; the pq_serving example (kernel 3).
    Each exits 0 and prints its JSON keys; the launch counts are read
    around each. The first scan of each shape each tool makes is held
    against its plain version (``scans_held_against_plain``); and
    bench_scale's padding copy is timed beside its scan."""
    import re
    import tempfile

    from crs_tpu_torch.examples import pq_serving, quickstart
    from crs_tpu_torch.tools import (bench_decode, bench_fused_mlp, bench_pq_serving,
                                     bench_prefill_mfu, bench_scale)
    from crs_tpu_torch.utils.config import DEFAULT_CONFIG

    out, checks = {}, {}
    reset_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp, \
            scans_held_against_plain(checks):
        generation = DEFAULT_CONFIG["rag"]["generation"]
        default_tokens = generation["max_new_tokens"]
        generation["max_new_tokens"] = TOOLS_QUICKSTART_TOKENS
        try:
            qs = run_tool(quickstart.main, [TOOLS_DOCUMENT], "quickstart",
                          results_dir=os.path.join(tmp, "quickstart_results"),
                          ft_dir=os.path.join(tmp, "quickstart_ft"))
        finally:
            generation["max_new_tokens"] = default_tokens
        text = "\n".join(qs["lines"])
        indexed = re.search(r"^indexed (\d+) chunks in", text, re.M)
        loss = re.search(r"^finetune: loss (\S+) after epoch 0", text, re.M)
        if not (indexed and int(indexed.group(1)) >= 1 and loss
                and math.isfinite(float(loss.group(1))) and "answer:" in text):
            raise AssertionError(f"tools: the quickstart printed {qs['lines']}")
        out["quickstart"] = qs
        empty_cache(dev)
        for b in TOOLS_DECODE_BATCHES:
            run = run_tool(bench_decode.main, TOOLS_DECODE + ["--batch", str(b)],
                           f"bench_decode batch {b}", TOOLS_KERNELS["bench_decode"],
                           TOOLS_KEYS["bench_decode"])
            finite_positive(run["json"]["decode_ms_per_token"], f"bench_decode batch {b}")
            out[f"bench_decode_b{b}"] = run
            empty_cache(dev)
        for kind in TOOLS_PREFILL_TYPES:
            run = run_tool(bench_prefill_mfu.main, ["--config", "1b", "--type", kind],
                           f"bench_prefill_mfu {kind}", keys=TOOLS_KEYS["bench_prefill_mfu"])
            finite_positive(run["json"]["prefill_mfu_percent"], f"prefill MFU {kind}")
            out[f"bench_prefill_mfu_{kind}"] = run
            empty_cache(dev)
        run = run_tool(bench_fused_mlp.main, TOOLS_FUSED_MLP, "bench_fused_mlp",
                       TOOLS_KERNELS["bench_fused_mlp"], TOOLS_KEYS["bench_fused_mlp"])
        for step in ("xla_int8", "fused"):
            finite_positive(run["json"][step]["ms_per_layer"], f"bench_fused_mlp {step}")
        out["bench_fused_mlp"] = run
        empty_cache(dev)
        for engine in ("pallas", "xla"):
            run = run_tool(bench_scale.main, ["--rows", str(TOOLS_SCALE_ROWS), "--engine", engine],
                           f"bench_scale {engine}",
                           TOOLS_KERNELS["bench_scale"], TOOLS_KEYS["bench_scale"])
            finite_positive(run["json"]["scan_ms"], f"bench_scale {engine}")
            out[f"bench_scale_{engine}"] = run
            empty_cache(dev)
        cache = os.path.join(tmp, "pq_codes.npz")
        for name, extra in (("bench_pq_serving", []), ("bench_pq_serving_sorted",
                                                       ["--sorted-coarse"])):
            run = run_tool(bench_pq_serving.main, ["--rows", str(TOOLS_PQ_ROWS), "--codes-cache",
                                                   cache, *extra], name, TOOLS_KERNELS[name],
                           TOOLS_KEYS["bench_pq_serving"])
            res = run["json"]
            finite_positive(res["scan_ms"], name)
            if not 0.0 < res["recall_at_k_host"] <= 1.0 or res["sorted_coarse"] != bool(extra):
                raise AssertionError(f"tools: {name} printed {res}")
            out[name] = run
            empty_cache(dev)
        a, b = out["bench_pq_serving"]["json"], out["bench_pq_serving_sorted"]["json"]
        if a["hbm_gb"] != b["hbm_gb"]:
            raise AssertionError(f"tools: the sorted run's footprint {b} against {a}")
        run = run_tool(pq_serving.main, [], "pq_serving", TOOLS_KERNELS["pq_serving"])
        recalls = [float(line.split("recall@10=")[1].split()[0]) for line in run["lines"]]
        if len(recalls) != 3 or not all(0.0 < r <= 1.0 for r in recalls):
            raise AssertionError(f"tools: the pq_serving example printed {run['lines']}")
        out["pq_serving"] = run
        empty_cache(dev)
    for name, count in TOOLS_HELD.items():
        if sum(key.split()[0] == name for key in checks) < count:
            raise AssertionError(f"tools: fewer than {count} {name} shapes held: {sorted(checks)}")
    out["scans_held_against_plain"] = checks
    out["pad_copy"] = pad_copy_cost(dev, seed)
    counted = {}
    for run in out.values():
        for k, v in run.get("launches", {}).items():
            counted[k] = counted.get(k, 0) + v
    out["main_path_launches"] = counted
    out["seconds_by_tool"] = {k: v["seconds"] for k, v in out.items() if "seconds" in v}
    ph.info.update(out)
    return out


QUALITY_ROWS = 1_000_000  # pq_recall_curve's rows here (4,000,000 by default)
QUALITY_CANDS = (100, 200, 400)
QUALITY_CURVE = ["--rows", str(QUALITY_ROWS), "--ms", "12", "--coarses", "2048",
                 "--cands", ",".join(map(str, QUALITY_CANDS))]
# the curve's engines and the kernel each must launch: 3 unsorted, 4 sorted (its second run
# reads the first run's caches)
QUALITY_ENGINES = {"pallas": "adc_scan_topk_residual", "pallas_sorted": "adc_scan_topk_sorted"}
QUALITY_HELD = {"block_topk_adc": 1, "block_topk_adc_sorted": 1}
QUALITY_ROW_KEYS = {"rows", "m", "coarse", "cand", "aniso_eta", "bytes_per_vec", "recall_none",
                    "recall_in_cand", "recall_host", "scan_ms", "ms_per_query", "host_scan_ms",
                    "engine", "device"}
# rows each sweep writes with its default grid
QUALITY_SWEEP_ROWS = {"quality_sweep": ("sweep.json", 8),
                      "quality_docside_sweep": ("docside_sweep.json", 10),
                      "quality_geometry_sweep": ("geometry_sweep.json", 8)}
QUALITY_IR_TOL = 1e-9  # fp32 / int8 IR metrics, card against CPU (the same ranking)
QUALITY_PQ_TOL = 0.05  # pq's: its codebooks train from the card's and the CPU's generators
QUALITY_CONTEXT_TOL = 1e-6  # sufficiency, precision, coverage, context chars: the same chunks
QUALITY_SCORE_TOL = 1e-5  # the mean and spread of the int8 store's scores (f32 sum orders)
QUALITY_CONTEXT_KEYS = ("context_sufficiency", "context_precision", "context_coverage",
                        "avg_context_length_chars", "avg_chunks_retrieved")
QUALITY_SCORE_KEYS = ("avg_retrieval_score", "retrieval_consistency")


@contextlib.contextmanager
def temp_root(path: str):
    """While open, the temporary directory (``tempfile.gettempdir()``: the
    tools' default outputs lie under it) is ``path``."""
    import tempfile

    old = tempfile.tempdir
    tempfile.tempdir = path
    try:
        yield
    finally:
        tempfile.tempdir = old


def quality_close(card: dict, cpu: dict, keys, tol: float, what: str) -> float:
    """The largest |card − CPU| over ``keys``; raises past ``tol``."""
    worst = 0.0
    for key in keys:
        diff = abs(card[key] - cpu[key])
        if not diff <= tol:
            raise AssertionError(f"quality: {what} {key} on the card {card[key]}, on the CPU "
                                 f"{cpu[key]}")
        worst = max(worst, diff)
    return worst


def curve_scan_profile(dev, cache_dir: str) -> dict:
    """Where one of the curve's 64-query scans (cand QUALITY_CANDS[0]) spends
    its time, each engine's scan rebuilt by the tools' own ``engine_scan``
    from its codes cache: its ms between CUDA events, and under
    torch.profiler the device's busy share and the ADC kernel's ms."""
    import torch

    from crs_tpu_torch.ops.pq import PQCodebook, ResidualPQ
    from crs_tpu_torch.tools import bench_pq_serving as bps
    from crs_tpu_torch.tools import pq_recall_curve

    (name,) = [f for f in os.listdir(cache_dir) if f.startswith("codes_")]
    codes = pq_recall_curve.load_npz(os.path.join(cache_dir, name), dev)
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    rpq = ResidualPQ(rotation=put(codes["rotation"]), coarse=put(codes["coarse"]),
                     codebook=PQCodebook(put(codes["centroids"])))
    ext = codes["ext"]
    # the tool's corpus at its defaults (4,096 centers, sigma 0.35) and its 64 queries
    corpus = bps.ClusteredCorpus(rpq.rotation.shape[0], 4096, 0.35, dev,
                                 min(bps.CHUNK, QUALITY_ROWS))
    queries = corpus.queries(corpus.chunk(0), 64)
    out = {}
    for engine in QUALITY_ENGINES:
        scan = bps.engine_scan(engine, rpq, ext, QUALITY_ROWS, rpq.coarse.shape[0],
                                           64, 2048, dev)
        call = lambda: scan(queries, QUALITY_CANDS[0])  # noqa: E731
        ms = device_ms(dev, call, iters=3)
        out[engine] = {"scan_ms": ms, **device_profile(call, ms, kernels={"adc": ("adc_scan",)})}
    empty_cache(dev)
    return out


def phase_quality(ph: Phase, dev, seed: int) -> dict:
    """The PQ recall-curve tools and the retrieval-quality tools of the port on
    the card, each through its own ``main`` as a user runs it (standard
    output captured, default outputs in a temporary directory):
    pq_recall_curve at QUALITY_ROWS rows × 384 (M 12, coarse 2048, cands
    100, 200, 400) with ``pallas`` (kernel 3), then ``pallas_sorted``
    (kernel 4) from the same caches; curve_report on both files;
    plot_pq_curve where matplotlib is installed (else its refusal);
    ir_eval (section judgments, fp32 / int8 / pq), quality_eval,
    oracle_bounds, quality_diag and the three sweeps (default grids) on the
    held-out corpus and questions. The first scan of each shape the curve
    makes is held against its plain version (ADC bit for bit); ir_eval,
    quality_eval and quality_diag also run on the CPU and the card's numbers
    are held against the CPU's (these stores are too small for a kernel:
    their numbers are about quality); each sweep's matched-context row
    equals quality_eval's on the card. Launch counts are read around each
    tool."""
    import tempfile

    import torch

    from crs_tpu_torch.evaluation.visualizer import _mpl
    from crs_tpu_torch.tools import (curve_report, ir_eval, oracle_bounds, output_dir,
                                     plot_pq_curve, pq_recall_curve, quality_diag,
                                     quality_docside_sweep, quality_eval, quality_geometry_sweep,
                                     quality_sweep)

    def load(path):
        with open(path) as f:
            return json.load(f)

    out, checks = {}, {}
    kind = torch.cuda.get_device_name(dev)
    reset_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_quality_") as tmp, temp_root(tmp), \
            scans_held_against_plain(checks):
        curves = []
        for engine, kernel in QUALITY_ENGINES.items():
            path = os.path.join(tmp, f"curve_{engine}.json")
            run = run_tool(pq_recall_curve.main, QUALITY_CURVE + ["--engine", engine, "--out",
                                                                  path],
                           f"pq_recall_curve {engine}", (kernel,))
            rows = [json.loads(line) for line in run.pop("lines")]
            if load(path) != rows or [r["cand"] for r in rows] != list(QUALITY_CANDS) or any(
                    set(r) != QUALITY_ROW_KEYS or r["engine"] != engine or r["device"] != kind
                    or r["rows"] != QUALITY_ROWS or not 0 < r["recall_host"] <= 1
                    or not 0 <= r["recall_none"] <= r["recall_in_cand"] <= 1 for r in rows):
                raise AssertionError(f"quality: pq_recall_curve {engine} printed {rows}")
            for r in rows:
                finite_positive(r["scan_ms"], f"pq_recall_curve {engine} cand {r['cand']}")
            out[f"pq_recall_curve_{engine}"] = dict(run, rows=rows)
            curves.append(path)
            empty_cache(dev)
        cache = sorted(os.listdir(output_dir("pq_curve")))
        if len(cache) != 3:  # truth, mirror, codes: the sorted run trained nothing anew
            raise AssertionError(f"quality: the curve's caches are {cache}")
        out["curve_scan_profile"] = curve_scan_profile(dev, output_dir("pq_curve"))
        run = run_tool(curve_report.main, curves, "curve_report")
        table = [line for line in run["lines"] if line.startswith(f"| {QUALITY_ROWS} |")]
        if len(table) != 2 * len(QUALITY_CANDS) or not any(
                line.startswith("VERDICT criterion") for line in run["lines"]):
            raise AssertionError(f"quality: curve_report printed {run['lines']}")
        out["curve_report"] = run
        figure = os.path.join(tmp, "pq_curve")
        if _mpl() is not None:
            run = run_tool(plot_pq_curve.main, curves + ["--out", figure], "plot_pq_curve")
            if not all(os.path.getsize(f"{figure}.{ext}") for ext in ("png", "pdf")):
                raise AssertionError(f"quality: plot_pq_curve wrote {os.listdir(tmp)}")
            out["plot_pq_curve"] = dict(run, ran=True)
        else:  # the card's machine may lack matplotlib: the tool refuses, writing nothing
            try:
                plot_pq_curve.main(curves + ["--out", figure])
                raise AssertionError("quality: plot_pq_curve ran without matplotlib")
            except RuntimeError as e:
                if os.path.exists(f"{figure}.png") or "needs matplotlib" not in str(e):
                    raise
                out["plot_pq_curve"] = {"ran": False, "refused": str(e)}
        out["matplotlib"] = _mpl() is not None

        # the retrieval-quality tools, on the held-out corpus and questions
        run = run_tool(ir_eval.main, ["--judgments", "section"], "ir_eval")
        card_ir = load(os.path.join(output_dir("ir_eval"), "ir_summary.json"))
        out["ir_eval"] = dict(run, summary=card_ir)
        run = run_tool(quality_eval.main, [], "quality_eval")
        out["quality_eval"] = run
        run = run_tool(oracle_bounds.main, [], "oracle_bounds")
        oracle = load(os.path.join(output_dir("oracle_bounds"), "oracle_bounds.json"))
        card_qe = {name: load(os.path.join(output_dir("quality_eval"), name))
                   for name in sorted(os.listdir(output_dir("quality_eval")))}
        matched = card_qe["retrieval_quality_matched-ctx90_10q.json"]
        if oracle["ours_10q"]["coverage"] != round(matched["context_coverage"], 4) or not (
                matched["context_coverage"] <= oracle["10q"]["oracle_coverage"] + 1e-9):
            raise AssertionError(f"quality: oracle_bounds wrote {oracle}")
        out["oracle_bounds"] = dict(run, oracle=oracle)
        run = run_tool(quality_diag.main, [], "quality_diag")
        out["quality_diag"] = run
        for name, (fname, count) in QUALITY_SWEEP_ROWS.items():
            mod = {"quality_sweep": quality_sweep, "quality_docside_sweep": quality_docside_sweep,
                   "quality_geometry_sweep": quality_geometry_sweep}[name]
            run = run_tool(mod.main, [], name)
            rows = load(os.path.join(output_dir(name), fname))
            if len(rows) != count:
                raise AssertionError(f"quality: {name} wrote {len(rows)} rows: {rows}")
            out[name] = dict(run, first_row=rows[0])
        # each sweep's first row is the matched-context pipeline of quality_eval (docside
        # writes its metrics rounded to 4 digits)
        want = [matched[k] for k in ("context_sufficiency", "context_precision",
                                     "context_coverage")]
        docside = out["quality_docside_sweep"]["first_row"]["10q"]
        for name, got in (("quality_sweep", out["quality_sweep"]["first_row"]["q10"]),
                          ("quality_geometry_sweep",
                           out["quality_geometry_sweep"]["first_row"]["q10"])):
            if any(abs(g - w) > QUALITY_CONTEXT_TOL for g, w in zip(got, want, strict=True)):
                raise AssertionError(f"quality: {name}'s first row {got}, quality_eval {want}")
        if [docside[k] for k in ("suf", "prec", "cov")] != [round(w, 4) for w in want]:
            raise AssertionError(f"quality: quality_docside_sweep's first row {docside}, "
                                 f"quality_eval {want}")

        # the card against the CPU: the same numbers
        cpu = {}
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ir_eval.main(["--judgments", "section", "--out", os.path.join(tmp, "cpu_ir"),
                          "--device", "cpu"])
            quality_eval.main(["--output-dir", os.path.join(tmp, "cpu_qe"), "--device", "cpu"])
        cpu_ir = load(os.path.join(tmp, "cpu_ir", "ir_summary.json"))
        with contextlib.redirect_stdout(io.StringIO()) as diag_cpu:
            quality_diag.main(["--device", "cpu"])
        worst = {"ir": 0.0, "ir_pq": 0.0, "context": 0.0, "score": 0.0}
        for fmt, metrics in cpu_ir["section"].items():
            if not isinstance(metrics, dict):
                if card_ir["section"][fmt] != metrics:
                    raise AssertionError(f"quality: ir_eval {fmt} {card_ir['section'][fmt]} "
                                         f"on the card, {metrics} on the CPU")
                continue
            keys = [k for k in metrics if k.startswith(("precision_at", "recall_at", "f1_at",
                                                        "mrr", "map"))]
            tol, slot = (QUALITY_PQ_TOL, "ir_pq") if fmt == "pq" else (QUALITY_IR_TOL, "ir")
            worst[slot] = max(worst[slot], quality_close(card_ir["section"][fmt], metrics, keys,
                                                         tol, f"ir_eval {fmt}"))
        for name, card in card_qe.items():
            cpu_m = load(os.path.join(tmp, "cpu_qe", name))
            worst["context"] = max(worst["context"], quality_close(
                card, cpu_m, QUALITY_CONTEXT_KEYS, QUALITY_CONTEXT_TOL, name))
            worst["score"] = max(worst["score"], quality_close(
                card, cpu_m, QUALITY_SCORE_KEYS, QUALITY_SCORE_TOL, name))
        if diag_cpu.getvalue().strip().splitlines() != out["quality_diag"]["lines"]:
            raise AssertionError("quality: quality_diag's lines differ between the card and the "
                                 "CPU")
        cpu["seconds"] = time.perf_counter() - t0
        cpu["max_abs_diff"] = worst
        out["card_against_cpu"] = cpu
    for name, count in QUALITY_HELD.items():
        if sum(key.split()[0] == name for key in checks) < count:
            raise AssertionError(f"quality: fewer than {count} {name} shapes held: "
                                 f"{sorted(checks)}")
    out["scans_held_against_plain"] = checks
    counted = {}
    for run in out.values():
        for k, v in (run.get("launches", {}) if isinstance(run, dict) else {}).items():
            counted[k] = counted.get(k, 0) + v
    out["main_path_launches"] = counted
    out["seconds_by_tool"] = {k: v["seconds"] for k, v in out.items()
                              if isinstance(v, dict) and "seconds" in v}
    ph.info.update(out)
    return out


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


def prose_chunks(rng, rows: int, words: int):
    """Chunks of ``words`` words (config.json's chunk_size: 240) with the
    statistics of prose, over synthetic_corpus's 1,024 topics: each chunk
    has one topic, and about a quarter of its words are that topic's terms
    (one stem per topic with one of 48 endings, as a paper's terms share
    roots); the rest are drawn from a background vocabulary of 16,384
    pseudo-words, Zipf-like (rank r with weight
    1 / (r + 2.7)^1.1; the frequent ones short, ~6 letters a word in all).
    A chunk then holds ~160 distinct words, and with bigrams and char
    3/4-grams ~1,900 lexical features (seed 30: a few percent past the
    encoder's 2,048, whose extra features it drops in CSR order), as a
    chunk of prose does. Queries: 8 terms of one topic, as
    synthetic_corpus's."""
    import numpy as np

    n_topics, topic_words, background, topic_share = 1024, 48, 16384, 0.25
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))

    def pseudo_words(n: int, lo: int, hi: int) -> list:
        lens = rng.integers(lo, hi + 1, n).tolist()
        chars = letters[rng.integers(0, 26, (n, hi))].tolist()
        return ["".join(c[:k]) for c, k in zip(chars, lens)]

    stems = pseudo_words(n_topics, 4, 6)
    endings = pseudo_words(topic_words, 1, 5)
    # frequent words are short (2 letters at the head, ~9 in the tail)
    lens = np.clip(np.log2(np.arange(background) + 2) * 0.6 + 1.5
                   + rng.normal(0, 1, background), 2, 12).astype(int).tolist()
    chars = letters[rng.integers(0, 26, (background, 12))].tolist()
    vocab = ["".join(c[:k]) for c, k in zip(chars, lens)] + [s + e for s in stems
                                                             for e in endings]
    cdf = np.cumsum(1.0 / (np.arange(background) + 2.7) ** 1.1)
    cdf /= cdf[-1]
    topic = rng.integers(0, n_topics, rows)
    texts = []
    for r0 in range(0, rows, 8192):  # bounded host memory
        n = min(8192, rows - r0)
        ids = np.minimum(np.searchsorted(cdf, rng.random((n, words))), background - 1)
        term = background + topic[r0:r0 + n, None] * topic_words + rng.integers(
            0, topic_words, (n, words))
        ids = np.where(rng.random((n, words)) < topic_share, term, ids)
        texts += [" ".join([vocab[i] for i in row]) for row in ids.tolist()]
    q_topic = rng.integers(0, n_topics, BATCH)
    q_words = background + q_topic[:, None] * topic_words + rng.integers(
        0, topic_words, (BATCH, 8))
    queries = [" ".join([vocab[i] for i in row]) for row in q_words.tolist()]
    return texts, queries


def phase_full(ph: Phase, dev, seed: int, rows: int, max_err: float, shared: dict) -> dict:
    """The main path: a 1,048,576-row int8 store, retrieve_batch_fused at
    batch 328 through kernel 1 (counted), the host's and the device's share
    of a batch, and kernel 1 alone at the store's operands: ms, plain ms,
    both compositions, bound. ``max_err``: the kernel phase's."""
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
    nblocks = ops[1].shape[0] // INT8_BLOCK
    kb = _default_kb_repair(CAND_K, nblocks, BATCH, 256)
    max_err = max(max_err, compare_partials(block_topk_int8(*ops, kb),
                                            block_topk_int8_plain(*ops, kb)))
    kernel_ms = device_ms(dev, lambda: block_topk_int8(*ops, kb), iters=10, warmup=2)
    plain_ms = device_ms(dev, lambda: block_topk_int8_plain(*ops, kb), iters=2, warmup=1)
    q_codes, vecs = ops[0], ops[1]
    dequantize, int_mm = int8_yardsticks(q_emb, ops, kb, INT8_BLOCK)
    library_ms = device_ms(dev, dequantize, iters=3)
    int_mm_ms = device_ms(dev, int_mm, iters=3)
    nq = q_codes.shape[0] // 64
    bytes_moved = (vecs.numel() + 4 * vecs.shape[0] * 2 + q_codes.numel()
                   + nq * nblocks * kb * 64 * 8)
    int8_ops = 2 * BATCH * store.n * DIM
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = int8_ops / PEAK_INT8_OPS_PER_S * 1e3
    shared.update(texts=texts, queries=queries, emb=emb, em=em, int8_store=store)
    ph.info.update({
        "rows": store.n, "dim": DIM, "batch": BATCH,
        "host_setup_s": {"texts": round(t_texts, 3), "featurize_embed_index": round(t_index, 3),
                         "presence_ids": round(t_presence, 3)},
        "ms_per_batch": batch_ms, "ms_per_query": batch_ms / BATCH,
        "main_path_counts": main_counts,
        "breakdown": {"query_embed_ms": t_embed, "query_token_ids_ms": t_tokens,
                      "profile": profile},
        "rescore_vs_dense_max_abs": rescore_err,
        "kernel": {"kb": kb, "nblocks": nblocks, "block_size": INT8_BLOCK, "ms": kernel_ms,
                   "plain_ms": plain_ms, "library_composition_ms": library_ms,
                   "library_composition": "dequantize + torch.matmul + torch.topk per block",
                   "int_mm_composition_ms": int_mm_ms,
                   "int_mm_composition": "torch._int_mm (cuBLAS int8) + row scale and bias + "
                                         "torch.topk per block",
                   "bytes": bytes_moved, "int8_ops": int8_ops,
                   "bound_ms": max(bytes_ms, ops_ms)},
    })
    return {
        "name": "int8_scan_topk", "route": "cuda",
        "source": "crs_tpu_torch/csrc/int8_scan_topk.cu",
        "replaces": "crs_tpu/ops/pallas_scan.py:172",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None, "library_composition_ms": library_ms,
        "int_mm_composition_ms": int_mm_ms,
    }


def sorted_store_from(store, cfg: dict, dev):
    """A ``pq_sorted`` store over a residual store's trained state, carried
    across as numpy (``convert.pq_store_from_numpy``): no second training."""
    from crs_tpu_torch.convert import pq_store_from_numpy

    def host(t):
        return t.cpu().numpy()

    return pq_store_from_numpy(
        store.n, store.dim, store.ids, store.documents, store.metadatas,
        centroids=host(store._pq_codebook.centroids), pq_codes=host(store._pq_codes),
        rotation=host(store._rpq.rotation), coarse=host(store._rpq.coarse),
        coarse_ids=host(store._pq_coarse_ids), codes=host(store._codes),
        scales=host(store._scales), config=cfg, device=dev)


def pq_rebuild_identical(store, cfg: dict, texts, emb, dev) -> str:
    """Build the pq store a second time from the same seed and require the
    same codes, coarse ids, codebooks, rotation and coarse centroids."""
    import torch

    from crs_tpu_torch.rag import VectorStore

    again = VectorStore(cfg, device=dev)
    again.create_index(texts, emb)
    pairs = {"codes": (store._pq_codes, again._pq_codes),
             "codebook": (store._pq_codebook.centroids, again._pq_codebook.centroids)}
    if store._rpq is not None:
        pairs.update({"coarse_ids": (store._pq_coarse_ids, again._pq_coarse_ids),
                      "rotation": (store._rpq.rotation, again._rpq.rotation),
                      "coarse": (store._rpq.coarse, again._rpq.coarse)})
    differ = [k for k, (a, b) in pairs.items() if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"two pq builds from one seed differ in {differ}")
    return "identical: " + ", ".join(pairs)


def phase_formats(ph: Phase, dev, shared: dict) -> dict:
    """The first FORMAT_ROWS of the full phase's texts and embeddings in every
    other store format:
    each format's main path (retrieve_batch at batch 328, without and with
    PRF) must launch that format's kernel; returns each kernel's launches."""
    import torch

    from crs_tpu_torch.ops.scan import STATS
    from crs_tpu_torch.ops.topk import exact_topk
    from crs_tpu_torch.rag import ContextRetriever, VectorStore

    texts, queries, emb, em = (shared[k] for k in ("texts", "queries", "emb", "em"))
    texts, emb = texts[:FORMAT_ROWS], emb[:FORMAT_ROWS]
    n = emb.shape[0]
    q_emb = em.embed(queries)
    exact = exact_topk(emb, q_emb, 3, n)  # the fp32 exact top-3 on the same embeddings
    exact_ids = exact[1].cpu().tolist()
    mds = [{"shard": i % 4} for i in range(n)]
    launches = {}
    doc_tokens = []
    residual = None
    for name, cfg in FORMAT_STORES.items():
        sync(dev)
        t0 = time.perf_counter()
        if name == "pq_sorted":  # no second PQ training: the residual store's state
            store = sorted_store_from(residual, dict(CONFIG_STORE, **cfg), dev)
        else:
            store = VectorStore(dict(CONFIG_STORE, **cfg), device=dev)
            store.create_index(texts, emb)
        sync(dev)
        setup_s = time.perf_counter() - t0
        store.metadatas = mds
        if store.format == "pq" and name != "pq_sorted":  # the same bits from one seed
            info_det = pq_rebuild_identical(store, dict(CONFIG_STORE, **cfg), texts, emb, dev)
        train_s = store.build_seconds.get("pq_train", 0.0)
        info = {"setup_s": setup_s, "pq_train_s": train_s, "setup_without_pq_train_s":
                setup_s - train_s, "device_bytes_per_vector": store.memory_bytes() / n}
        if name == "pq_sorted":
            info["built_from"] = "the residual store's state (convert.pq_store_from_numpy)"
        elif store.format == "pq":
            info["rebuild_from_same_seed"] = info_det
        kernel = FORMAT_KERNEL[name]
        retr = ContextRetriever(store, em, BENCH_RETRIEVER)
        if doc_tokens:  # the host rerank's per-document tokens: same texts, built once
            retr._doc_tokens, retr._doc_tokens_n = doc_tokens[0], n
        for prf in (0.0, 0.3):
            retr.prf_beta = prf
            out = {}

            def serve():
                out["results"] = retr.retrieve_batch(queries)

            # this format's main path: counts to 0 just before, read just after
            STATS.reset()
            warmup, iters = 2, 10
            batch_ms = device_ms(dev, serve, iters=iters, warmup=warmup)
            count = STATS.by_kernel.get(kernel, 0)
            if count == 0:
                raise AssertionError(f"{name}: {kernel} never launched on its main path")
            if name == "pq_sorted" and STATS.by_kernel.get(FORMAT_KERNEL["pq"], 0):
                raise AssertionError(f"pq_sorted: the unsorted kernel ran: {STATS.by_kernel}")
            if name == "pq_sorted" and STATS.fallbacks:  # the answer must be kernel 4's
                raise AssertionError(f"pq_sorted prf={prf}: {STATS.fallbacks} exact fallbacks "
                                     f"in {warmup + iters} batches ({STATS.repairs} repairs)")
            empty = sum(1 for r in out["results"] if not r)
            if empty:
                raise AssertionError(f"{name} prf={prf}: {empty} queries returned no context")
            info[f"prf_beta_{prf}"] = {
                "ms_per_batch": batch_ms, "ms_per_query": batch_ms / BATCH,
                "launches_per_batch": count / (warmup + iters),
                "repairs": STATS.repairs, "repaired_pairs": STATS.repaired_pairs,
                "fallbacks": STATS.fallbacks}
            if prf == 0.0:
                launches[name] = count
        if not doc_tokens:
            doc_tokens.append(retr._doc_tokens)
        res = store.search(q_emb[0], top_k=5, where={"shard": 1})
        if len(res["ids"][0]) != 5 or any(md["shard"] != 1 for md in res["metadatas"][0]):
            raise AssertionError(f"{name}: the where-filtered search returned {res['metadatas']}")
        got = store.search_batch_dev(q_emb, 3)
        info["recall_at_3_vs_fp32_exact"] = sum(
            len(set(g) & set(e)) for g, e in zip(got[1].cpu().tolist(), exact_ids)) / (3 * BATCH)
        with plain_kernels():  # the same route with every kernel's plain version
            ref = store.search_batch_dev(q_emb, 3)
        if store.format == "pq":
            check_bits(got, ref, f"{name} search_batch_dev")
            info["route_vs_plain"] = "bit-identical"
        else:
            info["route_vs_plain_max_abs"] = check_float_ranked(got, ref, FLOAT_RTOL[name], 1)
        if name == "fp32":  # the exact format: its top-3 is the exact top-3
            info["vs_exact_max_abs"] = check_float_ranked(got, exact, FLOAT_RTOL[name], 1)
        if name == "pq_sorted":
            from crs_tpu_torch.ops.scan import adc_auto_group

            ext_s = store._pq_sorted_cache[0]
            group = adc_auto_group(n, BATCH, store.block_size, PQ_M + 2)
            wbase = store._pq_wbase[group]
            info["plan"] = plan_spread((ext_s[:, 0].long() * 256 + ext_s[:, 1].long()).cpu(),
                                       group * store.block_size, wbase)
            info["plan"]["group"] = group
            if wbase is None:
                raise AssertionError(f"pq_sorted: the window planner refused: {info['plan']}")
            unsorted = residual.search_batch_dev(q_emb, 3)
            if not torch.equal(got[0], unsorted[0]):
                raise AssertionError("pq_sorted: scores differ from the unsorted store's")
            ties_agree(got[0].cpu(), got[1].cpu(), unsorted[1].cpu())
            info["vs_unsorted_store"] = "scores identical, ids up to exact ties"
        ph.info[name] = info
        if name == "pq":
            residual = store
        elif name == "pq_sorted":
            shared["pq_store"] = residual  # the add phase grows it
            residual = None
        del store, retr
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    ph.info.update({"rows": n, "batch": BATCH, "store_config": CONFIG_STORE,
                    "retriever": BENCH_RETRIEVER, "main_path_launches": launches})
    return launches


GEN_CONFIG = "1b"
GEN_NEW_TOKENS = 8  # cut from 64 (32 in PRs 14–20) to keep the whole run inside its time limit
GEN_BATCHES = (1, 8)
GEN_LOGITS_RTOL = 5e-2  # ‖kernels − plain‖₂ / ‖plain‖₂ of the first decode step's logits
Q4_LAUNCHES_PER_STEP_1B = 16 * 7 + 1  # every linear layer and the lm_head
ATTN_LAUNCHES_PER_STEP_1B = 16
CONFIG_JSON = os.path.join(REPO, "config.json")
RAG_QUESTIONS = 2  # rag queries: each samples up to 256 tokens, a retry included
# two lexical fits of one corpus (the card's, the CPU's) share each step but
# the f32 Gram's and projection's sum orders and each eigenvector's sign
RAG_FIT_SCORE_TOL = 1e-4


def rag_prompts(n: int):
    """RAG-sized prompts: the generator's instruct prompt over ~1,400
    characters of held-out text and a held-out question (≈1,500 bytes)."""
    from crs_tpu_torch.rag.generation import RAGGenerator

    with open(CORPUS, encoding="utf-8") as f:
        text = f.read()
    with open(QA) as f:
        questions = [x["question"] for x in json.load(f)]
    fmt = RAGGenerator(None, {"max_context_chars": 1400})
    out = []
    for i in range(n):
        start = (i * 997) % max(1, len(text) - 1400)
        ctx = fmt._truncate_context(text[start:start + 2000])
        out.append(fmt._format_instruct_prompt(questions[i % len(questions)], ctx))
    return out


def kernel_counts():
    from crs_tpu_torch.ops import decode_attention, fused_mlp, qgemm

    return {**qgemm.STATS.by_kernel, **decode_attention.STATS.by_kernel,
            **fused_mlp.STATS.by_kernel}


def reset_counts() -> None:
    from crs_tpu_torch.ops import decode_attention, fused_mlp, gemv_probe, qgemm, scan

    for stats in (scan.STATS, qgemm.STATS, decode_attention.STATS, fused_mlp.STATS,
                  gemv_probe.STATS):
        stats.reset()


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in
               (cache.k_codes, cache.k_scales, cache.v_codes, cache.v_scales, cache.mask))


def clone_cache(cache):
    import dataclasses

    return dataclasses.replace(cache, **{f.name: getattr(cache, f.name).clone()
                                         for f in dataclasses.fields(cache) if f.name != "length"})


def phase_generate(ph: Phase, dev, seed: int, shared: dict) -> dict:
    """The 1b model as int4 and as nf4 with an int8 KV cache, random init
    from the seed, through create_model_interface: greedy generate_batch at
    batch 1 and 8 on RAG-sized prompts, GEN_NEW_TOKENS new tokens (the main
    path: every decode step's linear layers through kernel 8 or 9, its
    attention through kernel 10); prefill and decode times; the first decode
    step's logits through the kernels against the plain versions;
    greedy-token agreement with the plain versions over those steps
    (reported, not gated)."""
    import torch

    from crs_tpu_torch.models import create_model_interface, params_num_bytes
    from crs_tpu_torch.models.sampling import SamplingParams, generate_tokens
    from crs_tpu_torch.models.transformer import decode_step, init_cache, prefill

    from crs_tpu_torch.models.quantized import _int8_product

    prompts = rag_prompts(max(GEN_BATCHES))
    out = {"config": GEN_CONFIG, "kv_bits": 8, "new_tokens": GEN_NEW_TOKENS,
           "prompt_bytes": [len(p.encode("utf-8")) for p in prompts]}
    # the int8 weight route's exact product (torch._int_mm on the card)
    # against the CPU's float64 one, at decode and prefill row counts
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 8)
    w8 = torch.randint(-127, 128, (2048, 5632), generator=g, device=dev, dtype=torch.int32)
    for rows in (1, 8, 300):
        x8 = torch.randint(-127, 128, (rows, 2048), generator=g, device=dev, dtype=torch.int32)
        x8, w = x8.to(torch.int8), w8.to(torch.int8)
        if not torch.equal(_int8_product(x8, w).cpu(), _int8_product(x8.cpu(), w.cpu())):
            raise AssertionError(f"the int8 product on the card differs at {rows} rows")
    out["int8_route"] = "torch._int_mm equals the exact CPU product at 1, 8 and 300 rows"
    launches = {}
    for kind in ("int4", "nf4"):
        kernel = "nf4_matmul" if kind == "nf4" else "q4_matmul"
        model = create_model_interface(kind, {"config": GEN_CONFIG, "kv_bits": 8, "seed": seed},
                                       device=dev)
        t0 = time.perf_counter()
        model.load()
        info = {"load_s": time.perf_counter() - t0,
                "weight_bytes": params_num_bytes(model.params),
                "bits_per_param": model.get_model_info()["bits_per_param"]}
        params, cfg = model.params, model.cfg
        for b in GEN_BATCHES:
            batch = prompts[:b]
            model.generate_batch(batch, 2)  # warm-up
            # the main path: counts to 0 just before, read just after
            reset_counts()
            sync(dev)
            t0 = time.perf_counter()
            texts = model.generate_batch(batch, GEN_NEW_TOKENS)
            sync(dev)
            total_ms = (time.perf_counter() - t0) * 1e3
            counts = kernel_counts()
            steps = GEN_NEW_TOKENS - 1  # decode steps: the last token needs none
            if counts.get(kernel, 0) != Q4_LAUNCHES_PER_STEP_1B * steps \
                    or counts.get("decode_attention_int8", 0) != ATTN_LAUNCHES_PER_STEP_1B * steps:
                raise AssertionError(f"{kind} B={b}: launches {counts} for {steps} decode steps")
            launches[kind] = launches.get(kind, 0) + counts.get(kernel, 0)
            launches["attn"] = launches.get("attn", 0) + counts.get("decode_attention_int8", 0)
            if len(texts) != b or not all(isinstance(t, str) for t in texts):
                raise AssertionError(f"{kind} B={b}: generate_batch returned {texts!r}")

            # prefill and decode alone (outside the counted run)
            ids, mask = model.encode_batch(batch, GEN_NEW_TOKENS)
            cache = init_cache(cfg, b, ids.shape[1] + GEN_NEW_TOKENS, device=dev)
            sync(dev)
            t0 = time.perf_counter()
            logits, cache = prefill(params, cfg, ids, cache, mask)
            sync(dev)
            prefill_ms = (time.perf_counter() - t0) * 1e3
            token = torch.argmax(logits[:, -1], dim=-1)
            start = clone_cache(cache)
            state = {"cache": clone_cache(cache)}

            def step():
                state["logits"], state["cache"] = decode_step(params, cfg, token, state["cache"])

            decode_ms = device_ms(dev, step, iters=16, warmup=2)
            step_profile = device_profile(step, decode_ms, top=6, kernels={
                kernel: Q4_KERNELS[kind], "decode_attention_int8": ATTN_KERNELS})
            # the first decode step: kernels against plain versions, same cache
            got, _ = decode_step(params, cfg, token, clone_cache(start))
            with plain_kernels():
                ref, _ = decode_step(params, cfg, token, clone_cache(start))
            rel = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
            if not rel <= GEN_LOGITS_RTOL or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{kind} B={b}: first-step logits differ from the plain "
                                     f"versions by {rel} (relative L2, limit {GEN_LOGITS_RTOL})")
            # greedy tokens over the GEN_NEW_TOKENS steps, kernels and plain versions
            sp = SamplingParams(max_new_tokens=GEN_NEW_TOKENS, eos_id=-1, pad_id=0)
            g = torch.Generator(device=dev)
            tk, _ = generate_tokens(params, cfg, ids, mask, g, sp)
            with plain_kernels():
                tp, _ = generate_tokens(params, cfg, ids, mask, g, sp)
            same = (tk == tp).float()
            first_diff = [int(torch.nonzero(r == 0)[0]) if bool((r == 0).any()) else None
                          for r in same]
            info[f"batch_{b}"] = {
                "prompt_tokens": int(ids.shape[1]), "generate_ms": total_ms,
                "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
                "tokens_per_s": b * 1000.0 / decode_ms, "decode_step_profile": step_profile,
                "kv_cache_bytes": cache_bytes(start), "main_path_launches": counts,
                "launches_per_decode_step": {k: v / steps for k, v in counts.items()},
                "first_step_logits_rel_l2_vs_plain": rel,
                "first_step_logits_max_abs_diff": float((got - ref).abs().max()),
                "first_step_top1_equal": float((got.argmax(-1) == ref.argmax(-1)).float().mean()),
                "greedy_token_agreement_vs_plain": float(same.mean()),
                "first_divergent_step": first_diff,
                "sample": texts[0][:80],
            }
            del cache, start, state
        out[kind] = info
        shared[f"{kind}_model"] = model  # nf4: the rag phase's; int4: the evaluate phase's
        del params
        torch.cuda.empty_cache()
    out["main_path_launches"] = launches
    out["note"] = ("decode_ms_per_token: CUDA events over 16 decode steps (host work included); "
                   "decode_step_profile: one decode step under torch.profiler, kernels_ms its "
                   "device ms by kernel; "
                   "prefill_ms: host clock around one prefill; generate_ms: one greedy "
                   "generate_batch of 64 tokens, prefill included")
    ph.info.update(out)
    return out


EVAL_EFFICIENCY = {"num_warmup": 1, "num_runs": 2, "max_new_tokens": 16, "batch_sizes": [1, 8]}
EVAL_PPL_MAX_LENGTH = 1024
EVAL_NEW_TOKENS = 16  # generation's max_new_tokens (config.json: 96)
EVAL_CPU_CONFIG = "small"  # config.json's model config, scored on the card and on the CPU
# |card − CPU| of a log-likelihood, per scored token: bf16 sums in other orders flip int8
# activation codes (logits up to 0.13 apart); measured 5.0e-3 over the task's pairs and
# 9.8e-3 / 1.52e-2 over the CPU's / the card's greedy chains (NVIDIA H100 80GB HBM3)
EVAL_NLL_TOL = 3e-2
EVAL_PPL_RTOL = 1e-2  # |card / CPU − 1| of the perplexity
EVAL_SCORE_ATOL = 1e-5  # retrieval scores' mean and spread, card against CPU (f32 sum orders)
EVAL_CLI_NEW_TOKENS = 16
EVAL_CHAIN_STEPS = 8  # tokens of each greedy chain of the is_greedy check
EVAL_FILES = ["comprehensive_results.json", "efficiency_results.json",
              "performance_results.json", "retrieval_results.json", "summary.json"]
EVAL_HEADLINE = ("latency_ms_per_token", "ttft_ms", "throughput_tokens_per_sec",
                 "device_memory_peak_mb", "prefill_mfu_percent", "perplexity",
                 "average_accuracy", "f1_score", "avg_retrieval_time_ms")
EVAL_TIMING_WORDS = ("time", "qps", "tokens_per_sec", "speedup")
EVAL_SCORE_KEYS = ("avg_retrieval_score", "retrieval_consistency")


def smi_power_limit_w() -> float:
    """The card's power limit in watts, as nvidia-smi reads it."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(smi.stdout.strip().splitlines()[0])


def eval_config_copy(tmp: str) -> str:
    """A copy of config.json for the command line's evaluation: its model
    (small, int8, random init), its rag section persisting into ``tmp``, at
    most EVAL_CLI_NEW_TOKENS new tokens, the held-out QA file and corpus as
    the evaluation's questions, corpus, perplexity text and MC task."""
    with open(CONFIG_JSON) as f:
        cfg = json.load(f)
    cfg["rag"]["vector_store"]["persist_directory"] = os.path.join(tmp, "cli_index")
    cfg["rag"]["generation"]["max_new_tokens"] = EVAL_CLI_NEW_TOKENS
    ev = cfg["evaluation"]
    ev["performance"]["perplexity"].update(dataset_path=CORPUS, max_length=EVAL_PPL_MAX_LENGTH)
    ev["performance"]["tasks"]["corpus_qa_mc"]["qa_path"] = QA
    ev["retrieval"].update(test_questions_file=QA, corpus_file=CORPUS)
    path = os.path.join(tmp, "eval_config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def scored_positions(tokenizer, context: str, continuation: str):
    """(full ids, the logit rows that score the continuation)."""
    ctx, full = tokenizer.encode(context), tokenizer.encode(context + continuation)
    return full, list(range(max(len(ctx), 1) - 1, len(full) - 1))


def outside_tie(ref_logits, got_logits) -> bool:
    """Whether no argmax of these logit rows can differ between two
    computations: every row's top-2 margin in ``ref_logits`` exceeds twice
    the largest |got − ref| over the rows."""
    import numpy as np

    d = float(np.abs(got_logits - ref_logits).max())
    top2 = np.sort(ref_logits, axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min()) > 2 * d


def greedy_chain_check(card_m, cpu_m, contexts) -> dict:
    """is_greedy where it is True: each context continued by EVAL_CHAIN_STEPS
    tokens of one model's own argmax chain (built on the CPU, then on the
    card), scored by ``_sequence_logprob`` on both (token ids, so no text
    round trip). The chain model's flag must be True in every chain without an
    exact tie in its own logits, and False with the chain's last token
    changed; the other model's the same wherever ``outside_tie`` holds for
    the chain's steps. The sums agree within EVAL_NLL_TOL a token."""
    import numpy as np
    import torch

    from crs_tpu_torch.models.model_interface import _sequence_logprob

    def score(model, arr, mask, starts):
        lp, greedy = _sequence_logprob(
            model.params, model.cfg, torch.from_numpy(arr).to(model.device),
            torch.from_numpy(mask).to(model.device), torch.from_numpy(starts).to(model.device))
        return lp.cpu().numpy(), greedy.cpu().numpy()

    out = {"chains": len(contexts), "steps": EVAL_CHAIN_STEPS}
    for name, source, other in (("cpu_built", cpu_m, card_m), ("card_built", card_m, cpu_m)):
        chains = []
        for ctx in contexts:
            ids = source.tokenizer.encode(ctx)
            start = len(ids)
            for _ in range(EVAL_CHAIN_STEPS):
                ids.append(int(source.forward_device(np.asarray([ids]))[0, -1].argmax()))
            chains.append((ids, start))
        blen = max(len(ids) for ids, _ in chains)
        arr = np.zeros((len(chains), blen), np.int64)
        mask = np.zeros((len(chains), blen), bool)
        for row, (ids, _) in enumerate(chains):
            arr[row, :len(ids)], mask[row, :len(ids)] = ids, True
        starts = np.asarray([st for _, st in chains])
        steps = [list(range(st - 1, len(ids) - 1)) for ids, st in chains]
        own_logits = source.forward_device(arr).cpu().numpy()
        other_logits = other.forward_device(arr).cpu().numpy()
        own = np.asarray([outside_tie(own_logits[r, ps], own_logits[r, ps])
                          for r, ps in enumerate(steps)])
        cross = np.asarray([outside_tie(own_logits[r, ps], other_logits[r, ps])
                            for r, ps in enumerate(steps)])
        bad = arr.copy()
        for row, (ids, _) in enumerate(chains):
            bad[row, len(ids) - 1] = (ids[-1] + 1) % source.cfg.vocab_size
        (own_lp, own_g), (other_lp, other_g) = (score(m, arr, mask, starts)
                                                for m in (source, other))
        (_, own_bad), (_, other_bad) = (score(m, bad, mask, starts) for m in (source, other))
        per_token = float(np.abs(own_lp - other_lp).max()) / EVAL_CHAIN_STEPS
        if not (own_g[own].all() and other_g[cross].all()) or own_bad[own].any() \
                or other_bad[cross].any() or not per_token <= EVAL_NLL_TOL:
            raise AssertionError(
                f"evaluate: {name} greedy chains: flags {own_g.tolist()} / {other_g.tolist()}, "
                f"untied {own.tolist()}, outside ties {cross.tolist()}, changed "
                f"{own_bad.tolist()} / {other_bad.tolist()}, {per_token} a token")
        out[name] = {"untied": int(own.sum()), "source_true": int(own_g.sum()),
                     "outside_ties": int(cross.sum()), "other_true": int(other_g.sum()),
                     "logit_max_diff": float(max(np.abs(other_logits[r, ps] - own_logits[r, ps])
                                                 .max() for r, ps in enumerate(steps))),
                     "max_nll_diff_per_token": per_token}
    return out


def phase_evaluate(ph: Phase, dev, seed: int, shared: dict) -> dict:
    """The evaluation slice on the card, three parts.

    (a) EvaluationRunner.run_all() — the efficiency, performance and
    retrieval benchmarks — over the generate phase's 1b int4 model (int8 KV
    cache, random init from the seed) and a RAGPipeline with config.json's
    rag section (lexical embedding, int8 store; EVAL_NEW_TOKENS new tokens)
    indexed from the held-out corpus, the held-out questions, at
    EVAL_EFFICIENCY, perplexity over the held-out corpus at
    EVAL_PPL_MAX_LENGTH and the corpus_qa_mc task built from the held-out
    QA file. errors must be {}, the five files written, the headline
    metrics not null, device_memory_peak_mb the run's own (the peak reset
    just before it) and above what was held before it, the metadata's
    device the H100, its spec row "h100",
    device_tdp_w the card's power limit, and kernels 8 and 10 launched
    (counts to 0 just before the run, read just after).
    (b) config.json's small int8 model, the same seeded weights on the card
    and on the CPU: get_loglikelihood_batch_scored over the task's pairs
    (within EVAL_NLL_TOL a scored token; is_greedy equal wherever
    outside_tie holds for the scored positions), the greedy-chain check of
    is_greedy (greedy_chain_check) and the
    perplexity (the same tokens, within EVAL_PPL_RTOL); the retrieval
    benchmark on the card and on the CPU over (a)'s saved index: every
    metric but timings equal, the scores' mean and spread within
    EVAL_SCORE_ATOL.
    (c) python -m crs_tpu_torch --eval-performance --eval-retrieval in a
    child process on a copy of config.json (its small model, the held-out
    files): exit 0, four files, a summary with no errors."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from crs_tpu_torch.evaluation import EvaluationRunner
    from crs_tpu_torch.evaluation.efficiency.device_specs import DEVICE_SPECS, get_device_specs
    from crs_tpu_torch.evaluation.performance.perplexity import PerplexityEvaluator
    from crs_tpu_torch.evaluation.performance.tasks import build_corpus_qa_task
    from crs_tpu_torch.evaluation.retrieval.benchmark import RetrievalBenchmark
    from crs_tpu_torch.models import create_model_interface
    from crs_tpu_torch.rag import RAGPipeline

    out = {"model": {"config": GEN_CONFIG, "kind": "int4", "kv_bits": 8}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        # -- (a) the runner over the 1b int4 model and config.json's pipeline
        model = shared.pop("int4_model", None)
        if model is None:
            model = create_model_interface("int4", {"config": GEN_CONFIG, "kv_bits": 8,
                                                    "seed": seed}, device=dev)
            model.load()
        rag = config_json_rag()
        rag = {**rag, "vector_store": {**rag["vector_store"],
                                       "persist_directory": os.path.join(tmp, "index")},
               "generation": {**rag["generation"], "max_new_tokens": EVAL_NEW_TOKENS}}
        pipe = RAGPipeline(rag, device=dev).setup(model)
        t0 = time.perf_counter()
        pipe.index_documents(CORPUS)
        out["index_s"] = time.perf_counter() - t0
        task = build_corpus_qa_task(QA)
        mc_path = os.path.join(tmp, "corpus_qa_mc.json")
        with open(mc_path, "w") as f:
            json.dump(task.items, f)
        with open(QA) as f:
            questions = json.load(f)
        cfg = {"efficiency": EVAL_EFFICIENCY,
               "performance": {"perplexity": {"dataset_path": CORPUS,
                                              "max_length": EVAL_PPL_MAX_LENGTH},
                               "tasks": {"corpus_qa_mc": {"enabled": True,
                                                          "dataset_path": mc_path}}},
               "retrieval": {"test_questions": questions}}
        results = os.path.join(tmp, "results")
        # the port reads the peak since the process started; reset here, so
        # that device_memory_peak_mb is the evaluation's own
        memory = {}
        if dev.type == "cuda":
            memory = {"process_peak_before_mb": torch.cuda.max_memory_allocated(dev) / 1e6,
                      "allocated_before_mb": torch.cuda.memory_allocated(dev) / 1e6}
            torch.cuda.reset_peak_memory_stats(dev)
        # the main path: counts to 0 just before, read just after
        reset_counts()
        sync(dev)
        t0 = time.perf_counter()
        res = EvaluationRunner(model, pipe, cfg, results).run_all()
        sync(dev)
        run_s = time.perf_counter() - t0
        counts = kernel_counts()
        summary = res.get_summary()
        if res.errors:
            raise AssertionError(f"evaluate: the runner's errors: {res.errors}")
        if sorted(os.listdir(results)) != EVAL_FILES:
            raise AssertionError(f"evaluate: the runner wrote {sorted(os.listdir(results))}")
        missing = [k for k in EVAL_HEADLINE if summary.get(k) is None]
        if missing:
            raise AssertionError(f"evaluate: headline metrics missing: {missing} ({summary})")
        if counts.get("q4_matmul", 0) < 1 or counts.get("decode_attention_int8", 0) < 1:
            raise AssertionError(f"evaluate: kernels 8 and 10 did not both launch: {counts}")
        if dev.type == "cuda":
            memory["evaluation_peak_mb"] = summary["device_memory_peak_mb"]
            if not summary["device_memory_peak_mb"] > memory["allocated_before_mb"]:
                raise AssertionError(f"evaluate: device_memory_peak_mb "
                                     f"{summary['device_memory_peak_mb']} is not above the "
                                     f"memory held before the run ({memory})")
        eff = res.efficiency
        spec = get_device_specs(eff["device"])
        card = {"metadata_device": res.metadata.get("device"),
                "backend": res.metadata.get("backend"), "efficiency_device": eff["device"],
                "spec_matched": spec["matched"], "device_tdp_w": eff.get("device_tdp_w")}
        if dev.type == "cuda":
            limit = smi_power_limit_w()
            card["power_limit_w"] = limit
            row = {k: spec[k] for k in DEVICE_SPECS["h100"]}
            if "h100" not in str(card["metadata_device"]).lower() or card["backend"] != "cuda":
                raise AssertionError(f"evaluate: the metadata names {card}")
            if not spec["matched"] or row != DEVICE_SPECS["h100"]:
                raise AssertionError(f"evaluate: {eff['device']!r} matched {spec}, not h100's row")
            if eff.get("device_tdp_w") != limit:
                raise AssertionError(f"evaluate: device_tdp_w {eff.get('device_tdp_w')} is not "
                                     f"the card's power limit {limit} W")
        out["runner"] = {
            "seconds": run_s, "timing_s": res.timing, "summary": summary,
            "main_path_launches": counts, "card": card, "memory": memory,
            "efficiency": {k: eff.get(k) for k in (
                "prefill_ms", "decode_ms_per_token", "batch_throughput",
                "batch_throughput_best_tokens_per_sec", "mfu_percent", "mfu_batched_percent",
                "prefill_tflops_achieved", "prefill_tokens_per_sec", "hbm_gbps_achieved",
                "device_memory_in_use_mb", "model_size_gb", "bits_per_param",
                "energy_per_token_mj")},
            "performance": {k: res.performance.get(k) for k in (
                "avg_nll", "num_samples", "num_tokens", "tasks")},
            "retrieval": {k: res.retrieval.get(k) for k in (
                "num_questions", "avg_rag_generation_time_ms", "avg_no_rag_generation_time_ms",
                "rag_tokens_per_sec", "exact_match", "rouge1", "context_sufficiency",
                "context_precision", "avg_chunks_retrieved")}}
        del pipe, model
        torch.cuda.empty_cache()

        # -- (b) scoring and retrieval metrics, card against CPU
        small = {"config": EVAL_CPU_CONFIG, "seed": seed}
        card_m = create_model_interface("int8", small, device=dev)
        cpu_m = create_model_interface("int8", small, device="cpu")
        card_m.load()
        cpu_m.load()
        pairs = [(it["query"], " " + c.lstrip()) for it in task.items for c in it["choices"]]
        t0 = time.perf_counter()
        got = card_m.get_loglikelihood_batch_scored(pairs)
        card_score_s = time.perf_counter() - t0
        ref = cpu_m.get_loglikelihood_batch_scored(pairs)
        worst, compared = 0.0, 0
        for (c, x), (gl, gg), (rl, rg) in zip(pairs, got, ref):
            full, rows = scored_positions(cpu_m.tokenizer, c, x)
            per_token = abs(gl - rl) / max(len(rows), 1)
            worst = max(worst, per_token)
            if not per_token <= EVAL_NLL_TOL:
                raise AssertionError(f"evaluate: {c!r}+{x!r} scored {gl} on the card, {rl} on "
                                     f"the CPU ({per_token} a token, limit {EVAL_NLL_TOL})")
            if rows and outside_tie(cpu_m.forward(np.asarray([full]))[0][rows],
                                    card_m.forward(np.asarray([full]))[0][rows]):
                compared += 1
                if gg != rg:
                    raise AssertionError(f"evaluate: is_greedy {gg} on the card, {rg} on the "
                                         f"CPU for {c!r}+{x!r}, outside a tie")
        chains = greedy_chain_check(card_m, cpu_m, [it["query"] for it in task.items])
        ppl_cfg = {"dataset_path": CORPUS, "max_length": EVAL_PPL_MAX_LENGTH}
        ppl_card = PerplexityEvaluator(card_m, ppl_cfg).calculate()
        ppl_cpu = PerplexityEvaluator(cpu_m, ppl_cfg).calculate()
        ppl_rel = abs(ppl_card["perplexity"] / ppl_cpu["perplexity"] - 1)
        if ppl_card["num_tokens"] != ppl_cpu["num_tokens"] or not ppl_rel <= EVAL_PPL_RTOL:
            raise AssertionError(f"evaluate: perplexity {ppl_card} on the card, {ppl_cpu} on "
                                 f"the CPU (limit {EVAL_PPL_RTOL})")
        del card_m, cpu_m
        torch.cuda.empty_cache()
        rb_cfg = {"test_questions": questions, "compare_no_rag": False}
        card_rb = RetrievalBenchmark(RAGPipeline(rag, device=dev).setup(), rb_cfg).run_all()
        cpu_rb = RetrievalBenchmark(RAGPipeline(rag, device="cpu").setup(), rb_cfg).run_all()

        def untimed(m):
            return {k: v for k, v in m.items() if not any(w in k for w in EVAL_TIMING_WORDS)}

        gm, cm = untimed(card_rb.metrics), untimed(cpu_rb.metrics)
        score_diff = max(abs(gm[k] - cm[k]) for k in EVAL_SCORE_KEYS)
        if set(gm) != set(cm) or any(gm[k] != cm[k] for k in cm if k not in EVAL_SCORE_KEYS) \
                or not score_diff <= EVAL_SCORE_ATOL:
            raise AssertionError(f"evaluate: retrieval metrics on the card {gm}, on the CPU {cm}")
        out["vs_cpu"] = {
            "model": EVAL_CPU_CONFIG, "pairs": len(pairs), "card_scoring_s": card_score_s,
            "max_nll_diff_per_token": worst, "limit": EVAL_NLL_TOL,
            "is_greedy_equal_outside_ties": compared, "greedy_chains": chains,
            "perplexity_card": ppl_card["perplexity"], "perplexity_cpu": ppl_cpu["perplexity"],
            "perplexity_rel_diff": ppl_rel, "perplexity_tokens": ppl_card["num_tokens"],
            "perplexity_limit": EVAL_PPL_RTOL, "retrieval_score_diff": score_diff,
            "retrieval_score_limit": EVAL_SCORE_ATOL,
            "retrieval_metrics_equal": sorted(k for k in cm if k not in EVAL_SCORE_KEYS)}

        # -- (c) the command line's evaluation, in a child process
        cli_results = os.path.join(tmp, "cli_results")
        cpu_rehearsal = ["--device", "cpu"] if dev.type == "cpu" else []  # the card: the default
        secs, stdout = run_cli(["--config", eval_config_copy(tmp), "--eval-performance",
                                "--eval-retrieval", "--output-dir", cli_results,
                                *cpu_rehearsal], "evaluate")
        cli_summary = json.loads(stdout[stdout.index("{"):])
        written = sorted(os.listdir(cli_results))
        want = [f for f in EVAL_FILES if f != "efficiency_results.json"]
        if cli_summary.get("errors") != {} or written != want \
                or cli_summary.get("perplexity") is None or cli_summary.get("f1_score") is None:
            raise AssertionError(f"evaluate: the command line wrote {written} and printed "
                                 f"{cli_summary}")
        out["cli"] = {"seconds": secs, "files": written, "summary": cli_summary}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["note"] = ("runner: one EvaluationRunner.run_all() on the host clock; its efficiency "
                   "numbers are the benchmark's own (host clock around fenced work); "
                   "device_memory_peak_mb is the evaluation's own peak (the smoke resets the "
                   "peak just before run_all; the port never resets it)")
    ph.info.update(out)
    return out


FT_CONFIG = "1b"  # QLoRA's shape: the 1b model with an int4 base and an int8 KV cache
FT_SAMPLES = 64  # SyntheticCodeLoader samples: 58 to train (15 batches of 4), 6 to evaluate
FT_EPOCHS = 2  # config.json's finetuning.num_epochs is 3: cut for time
FT_SLICE_LAYERS = 2  # the 1b slice of the gradient check: full width, two layers
FT_GRAD_SHAPE = (1, 32)  # B × S of the gradient check: 32 rows, kernels 8 / 9's route
FT_KERNEL_GATE = 1e-5  # |kernel − plain| ≤ 1e-5·Σ|x·w| per product (kernel_q4's gate)
# adapter gradients and dx, kernel route against plain route: the forwards differ
# within FT_KERNEL_GATE per product, which moves a bf16 rounding of an
# activation by one step (2⁻⁸ relative) now and then; the gradients are bf16
# sums of such terms, so each tensor is held to 2⁻⁴ of its largest entry
FT_GRAD_RTOL = 2.0 ** -4
FT_DECODE_TOKENS = 16
# merge_lora re-rounds each base weight (code × scale) and its delta to bf16, where
# the kernel reads bf16(level)·bf16(scale): the merged model's next-token logits
# are held to the generate phase's relative L2 for such re-rounding (crs_tpu's own
# test allows 6e-2 + 3e-2·|x| elementwise at tiny; the 1b model's went 0.074 past
# that on an NVIDIA H100 80GB HBM3 at 700 W)
FT_MERGE_RTOL = GEN_LOGITS_RTOL
FT_CPU_CONFIG = "small"  # config.json's model (int8), card against the CPU
FT_CPU_STEPS = 3
FT_LOSS_TOL = EVAL_NLL_TOL  # nats a token, each step's loss, card against the CPU
# the adapters after FT_CPU_STEPS, card against the CPU: an Adam step moves an
# element by at most |m̂ / √v̂| ≤ 1.004 times the rate at these counts
# (Cauchy-Schwarz over the bf16 moments), and a gradient near 0 may take either
# sign on the two devices: twice the sum of the rates, and 5 % for the bf16
# roundings of the rate and of the update
FT_ADAPTER_RATE_FACTOR = 2.1


def finetune_eval_config(tmp: str) -> dict:
    """The evaluate phase's performance inputs: perplexity over the held-out
    corpus at EVAL_PPL_MAX_LENGTH tokens and the corpus_qa_mc task built
    from the held-out QA file."""
    from crs_tpu_torch.evaluation.performance.tasks import build_corpus_qa_task

    mc_path = os.path.join(tmp, "corpus_qa_mc.json")
    with open(mc_path, "w") as f:
        json.dump(build_corpus_qa_task(QA).items, f)
    return {"performance": {"perplexity": {"dataset_path": CORPUS,
                                           "max_length": EVAL_PPL_MAX_LENGTH},
                            "tasks": {"corpus_qa_mc": {"enabled": True,
                                                       "dataset_path": mc_path}}}}


def finetune_config(out_dir: str) -> dict:
    with open(CONFIG_JSON) as f:
        cfg = dict(json.load(f)["finetuning"])
    cfg.update(num_epochs=FT_EPOCHS, output_dir=out_dir)
    return cfg


def adapters_of(params) -> dict:
    from crs_tpu_torch.finetuning.lora import extract_lora

    return {k: (v["a"].detach().float().cpu(), v["b"].detach().float().cpu())
            for k, v in extract_lora(params).items()}


@contextlib.contextmanager
def plain_q4_products():
    """Kernels 8 and 9 replaced by their plain versions inside the same
    autograd Function (its backward unchanged), on any device."""
    from crs_tpu_torch.ops import qgemm

    saved = qgemm._product
    qgemm._product = lambda kind, x2, codes, scales: (
        qgemm.emulate_q4_matmul if kind == "int4" else qgemm.emulate_nf4_matmul)(x2, codes, scales)
    try:
        yield
    finally:
        qgemm._product = saved


def finetune_grad_check(dev, seed: int) -> dict:
    """A LoRA'd 1b slice (full width, FT_SLICE_LAYERS layers) in int4 and in
    nf4 at FT_GRAD_SHAPE: one forward and backward through kernel 8 / 9
    (launches counted, none in the backward), again through their plain
    versions on the card; the first product within the kernel's gate, the
    logits within GEN_LOGITS_RTOL relative L2, each adapter gradient and dx
    (the gradient at the embedded input) within FT_GRAD_RTOL of its largest
    entry."""
    import dataclasses

    import torch

    from crs_tpu_torch.finetuning.lora import add_lora, lora_nodes
    from crs_tpu_torch.finetuning.trainer import masked_loss
    from crs_tpu_torch.models.quantized import quantize_params
    from crs_tpu_torch.models.transformer import CONFIGS, forward, init_params
    from crs_tpu_torch.ops import qgemm

    cfg = dataclasses.replace(CONFIGS[FT_CONFIG], num_layers=FT_SLICE_LAYERS)
    dense = init_params(seed, cfg, device=dev)
    b, s = FT_GRAD_SHAPE
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=g).to(dev)
    mask = torch.ones((b, s), dtype=torch.bool, device=dev)
    out = {}
    for kind, bits, name in (("int4", 4, "q4_matmul"), ("nf4", "nf4", "nf4_matmul")):
        params = add_lora(quantize_params(dense, bits=bits), torch.Generator().manual_seed(seed))
        with torch.no_grad():  # B = 0 would give A no gradient
            for node in lora_nodes(params):
                node.lora_b.copy_(torch.randn(node.lora_b.shape, generator=g).to(dev) * 0.01)

        def run():
            """One forward and backward → (logits, adapter gradients, dx: the
            gradient at the embedding rows of the ids)."""
            params["embed"] = params["embed"].detach().requires_grad_(True)
            for node in lora_nodes(params):
                node.lora_a.grad = node.lora_b.grad = None
            logits = forward(params, cfg, ids, mask)
            masked_loss(logits, ids, mask).backward()
            grads = [t.grad.float() for n in lora_nodes(params) for t in (n.lora_a, n.lora_b)]
            return logits.detach(), grads, params["embed"].grad[ids.unique()].float()

        reset_counts()
        sync(dev)
        logits, grads, dx = run()
        sync(dev)
        launches = kernel_counts().get(name, 0)
        want = FT_SLICE_LAYERS * 7 + 1
        if launches != want:
            raise AssertionError(f"finetune: {name} launched {launches} times in a forward and "
                                 f"backward of the slice, expected {want}")
        with plain_q4_products():
            reset_counts()
            p_logits, p_grads, p_dx = run()
            if kernel_counts().get(name, 0):
                raise AssertionError(f"finetune: {name} launched through the plain route")
        # the first product (layer 0's q) against its plain version, the kernel's gate
        q = params["layers"][0]["attn"]["q"].base
        x2 = torch.randn((b * s, cfg.hidden_size), generator=g).to(dev, torch.bfloat16)
        got = getattr(qgemm, name)(x2, q.codes, q.scales)
        ref = (qgemm.emulate_q4_matmul if kind == "int4" else qgemm.emulate_nf4_matmul)(
            x2, q.codes, q.scales)
        w = qgemm.dequantize_f32(kind, q.codes, q.scales).to(torch.bfloat16).float()
        gate = FT_KERNEL_GATE * (x2.float().abs() @ w.abs())
        if not bool(((got - ref).abs() <= gate).all()):
            raise AssertionError(f"finetune: {name} outside its gate on the slice's q product")
        logit_rel = rel_l2(logits, p_logits)
        grad_rel = max(float((a - r).abs().max() / r.abs().max().clamp_min(1e-30))
                       for a, r in zip(grads + [dx], p_grads + [p_dx]))
        if not logit_rel <= GEN_LOGITS_RTOL or not grad_rel <= FT_GRAD_RTOL:
            raise AssertionError(f"finetune: {kind} kernel route against plain: logits "
                                 f"{logit_rel} (limit {GEN_LOGITS_RTOL}), gradients {grad_rel} "
                                 f"(limit {FT_GRAD_RTOL})")
        out[kind] = {"launches": launches, "logits_rel_l2": logit_rel,
                     "max_grad_diff_of_largest": grad_rel, "grad_tensors": len(grads) + 1,
                     "q_product_max_abs_err": float((got - ref).abs().max())}
    return out


def finetune_vs_cpu(dev, seed: int, train, tmp: str) -> dict:
    """config.json's model (small, int8) on the card and on the CPU with the
    same A's (a host generator from the seed) and the same batches:
    FT_CPU_STEPS trainer steps each; each step's loss within FT_LOSS_TOL,
    the first step moving nothing (its rate is 0), the adapters after the
    last step within FT_ADAPTER_RATE_FACTOR times the sum of the rates."""
    import torch

    from crs_tpu_torch.finetuning import QuantizedModelFinetuner
    from crs_tpu_torch.models import create_model_interface

    runs = {}
    for where in (dev, torch.device("cpu")):
        model = create_model_interface("int8", {"config": FT_CPU_CONFIG, "seed": seed},
                                       device=where)
        ft = QuantizedModelFinetuner(model, finetune_config(os.path.join(tmp, where.type)))
        ft.prepare_model()
        batches = ft.prepare_batches(train)[:FT_CPU_STEPS]
        ft._opt = ft._build_optimizer(len(batches))
        start = adapters_of(model.params)
        t0 = time.perf_counter()
        losses, rates, after_first = [], [], None
        for i, batch in enumerate(batches):
            rates.append(ft._opt.schedule(i))
            losses.append(ft.train_step(batch))
            if i == 0:
                after_first = adapters_of(model.params)
        runs[where.type] = {"losses": losses, "rates": rates, "start": start,
                            "after_first": after_first, "end": adapters_of(model.params),
                            "seconds": time.perf_counter() - t0}
        del ft, model
    card, cpu = runs["cuda" if dev.type == "cuda" else "cpu"], runs["cpu"]
    for run in (card, cpu):
        moved = max(float((x - y).abs().max()) for k in run["start"]
                    for x, y in zip(run["start"][k], run["after_first"][k]))
        if run["rates"][0] != 0.0 or moved != 0.0:
            raise AssertionError(f"finetune: the first update moved the adapters by {moved} "
                                 f"(rate {run['rates'][0]})")
    loss_diff = max(abs(a - b) for a, b in zip(card["losses"], cpu["losses"]))
    limit = FT_ADAPTER_RATE_FACTOR * sum(cpu["rates"])
    diffs = [float((x - y).abs().max()) for k in cpu["end"]
             for x, y in zip(card["end"][k], cpu["end"][k])]
    equal = sum(int((x == y).sum()) for k in cpu["end"] for x, y in zip(card["end"][k],
                                                                        cpu["end"][k]))
    total = sum(x.numel() for k in cpu["end"] for x in cpu["end"][k])
    if not loss_diff <= FT_LOSS_TOL or not max(diffs) <= limit:
        raise AssertionError(f"finetune: card against CPU: losses {card['losses']} / "
                             f"{cpu['losses']} (limit {FT_LOSS_TOL}), adapters {max(diffs)} "
                             f"(limit {limit})")
    return {"model": FT_CPU_CONFIG, "steps": FT_CPU_STEPS, "rates": cpu["rates"],
            "losses_card": card["losses"], "losses_cpu": cpu["losses"],
            "max_loss_diff": loss_diff, "loss_limit": FT_LOSS_TOL,
            "max_adapter_diff": max(diffs), "adapter_limit": limit,
            "adapter_entries_equal": equal / total, "card_s": card["seconds"],
            "cpu_s": cpu["seconds"]}


def phase_finetune(ph: Phase, dev, seed: int) -> dict:
    """QLoRA finetuning on the card, five parts.

    (a) Train: the 1b model with an int4 base and kv_bits 8 (random init
    from the seed, a load of this phase's own), LoRA at config.json's
    finetuning values (r 16, α 32, lr 2e-4, wd 0.01, B 4, S 256, warmup 10,
    clip 1.0, save_total_limit 3) but FT_EPOCHS epochs, over
    SyntheticCodeLoader's FT_SAMPLES samples, the performance benchmark after
    each epoch (the evaluate phase's perplexity and QA inputs) into
    epoch_N/: the median step ms, tokens/s, the loss per epoch, eval_loss,
    a step's peak memory and the callback's seconds; it fails on a
    non-finite loss, B all zero after training, a missing checkpoint,
    manifest, evaluation_history.json or train_result.json.
    (b) finetune_grad_check: gradients through kernels 8 and 9.
    (c) Decode with the adapter: greedy generate_batch of FT_DECODE_TOKENS
    tokens at B 1 (kernels 8 and 10 counted, both > 0); merge_lora into a
    dense model, its next-token logits within FT_MERGE_RTOL relative L2 of
    the adapted model's.
    (d) finetune_vs_cpu: the card against the CPU.
    (e) The analysis tools over epoch_0/ and epoch_1/: ResultsSummary,
    ResultsComparator (pairs, best model, leaderboard), ResultsExporter's
    four formats, ReportGenerator's report.html; host seconds and whether
    matplotlib drew the plots."""
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch

    from crs_tpu_torch.evaluation.comparator import ResultsComparator
    from crs_tpu_torch.evaluation.export import ResultsExporter
    from crs_tpu_torch.evaluation.reporter import ReportGenerator
    from crs_tpu_torch.evaluation.summary import ResultsSummary
    from crs_tpu_torch.evaluation.visualizer import _mpl
    from crs_tpu_torch.finetuning import QuantizedModelFinetuner, merge_lora
    from crs_tpu_torch.finetuning.code_generation import SyntheticCodeLoader
    from crs_tpu_torch.models import create_model_interface
    from crs_tpu_torch.models.transformer import forward

    out = {"model": {"config": FT_CONFIG, "kind": "int4", "kv_bits": 8}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_finetune_")
    try:
        # -- (a) two epochs of QLoRA training with the evaluation after each
        model = create_model_interface("int4", {"config": FT_CONFIG, "kv_bits": 8, "seed": seed},
                                       device=dev)
        t0 = time.perf_counter()
        model.load()
        out["load_s"] = time.perf_counter() - t0
        train, held = SyntheticCodeLoader({"num_samples": FT_SAMPLES, "seed": seed}).load()
        ft_dir, eval_dir = os.path.join(tmp, "finetune_out"), os.path.join(tmp, "finetune_eval")
        ft = QuantizedModelFinetuner(model, finetune_config(ft_dir))
        ft.prepare_model()
        callback = ft.setup_evaluation(eval_config=finetune_eval_config(tmp),
                                       output_dir=eval_dir, benchmarks=("performance",))
        steps, callback_s = [], []
        step, on_epoch_end = ft.train_step, callback.on_epoch_end

        def timed_step(batch):
            held = None
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
                held = torch.cuda.memory_allocated(dev) / 1e6
            sync(dev)
            t = time.perf_counter()
            loss = step(batch)  # float(loss) waits for the update
            ms = (time.perf_counter() - t) * 1e3
            peak = torch.cuda.max_memory_allocated(dev) / 1e6 if dev.type == "cuda" else None
            steps.append((ms, int(batch["mask"].sum()), batch["mask"].size, peak, held))
            return loss

        def timed_epoch_end(epoch):
            t = time.perf_counter()
            entry = on_epoch_end(epoch)
            callback_s.append(time.perf_counter() - t)
            return entry

        ft.train_step, callback.on_epoch_end = timed_step, timed_epoch_end
        reset_counts()
        t0 = time.perf_counter()
        result = ft.train(train, held, resume=False)
        sync(dev)
        train_s = time.perf_counter() - t0
        train_launches = kernel_counts()
        final_dir = ft.save_model()
        losses = [h["loss"] for h in result["history"]]
        if not all(math.isfinite(v) for v in losses + [h["eval_loss"] for h in result["history"]]):
            raise AssertionError(f"finetune: a loss is not finite: {result['history']}")
        b_max = max(float(b.abs().max()) for _, b in adapters_of(model.params).values())
        if not b_max > 0:
            raise AssertionError("finetune: every B is still zero after training")
        ckpts = sorted(d for d in os.listdir(ft_dir) if d.startswith("checkpoint-"))
        missing = [p for p in [os.path.join(ft_dir, "train_result.json"),
                               os.path.join(eval_dir, "evaluation_history.json"),
                               os.path.join(final_dir, "training_config.json"),
                               os.path.join(final_dir, "adapters.npz")]
                   + [os.path.join(ft_dir, c, f) for c in ckpts
                      for f in ("adapters.npz", "manifest.json")]
                   + [os.path.join(eval_dir, f"epoch_{e}", "performance_results.json")
                      for e in range(FT_EPOCHS)] if not os.path.exists(p)]
        if not ckpts or len(ckpts) > ft.save_total_limit or missing:
            raise AssertionError(f"finetune: checkpoints {ckpts}, missing files {missing}")
        step_ms = [s[0] for s in steps]
        out["train"] = {
            "samples": {"train": len(train), "eval": len(held)},
            "batches_per_epoch": len(ft.prepare_batches(train)), "epochs": FT_EPOCHS,
            "steps": len(steps), "seconds": train_s,
            "step_ms_median": statistics.median(step_ms), "step_ms_first": step_ms[0],
            "tokens_per_s": sum(s[1] for s in steps) / (sum(step_ms) / 1e3),
            "padded_tokens_per_s": sum(s[2] for s in steps) / (sum(step_ms) / 1e3),
            "step_peak_mb": max(s[3] for s in steps) if dev.type == "cuda" else None,
            # what the process held when each step began (other phases' state included),
            # and the most a step added to it
            "held_before_step_mb": max(s[4] for s in steps) if dev.type == "cuda" else None,
            "step_own_peak_mb": max(s[3] - s[4] for s in steps) if dev.type == "cuda" else None,
            "loss_per_epoch": losses, "eval_loss": [h["eval_loss"] for h in result["history"]],
            "callback_s": callback_s,
            "perplexity_per_epoch": [e["value"] for e in callback.history],
            "best_epoch": callback.best_epoch, "max_abs_b": b_max, "checkpoints": ckpts,
            "main_path_launches": train_launches}

        # -- (b) gradients through kernels 8 and 9
        out["grad_check"] = finetune_grad_check(dev, seed)

        # -- (c) decode with the adapter, then the merged model
        prompt = rag_prompts(1)
        reset_counts()
        sync(dev)
        t0 = time.perf_counter()
        text = model.generate_batch(prompt, FT_DECODE_TOKENS)[0]
        sync(dev)
        decode_s = time.perf_counter() - t0
        decode_launches = kernel_counts()
        if decode_launches.get("q4_matmul", 0) < 1 or \
                decode_launches.get("decode_attention_int8", 0) < 1:
            raise AssertionError(f"finetune: the adapted decode launched {decode_launches}")
        ids = torch.as_tensor([model.tokenizer.encode("def add_7(x):\n    return")],
                              device=dev)
        with torch.no_grad():
            adapted = forward(model.params, model.cfg, ids)[0, -1]
            merged = forward(merge_lora(model.params), model.cfg, ids)[0, -1]
        merge_err = rel_l2(merged, adapted)
        if not merge_err <= FT_MERGE_RTOL:
            raise AssertionError(f"finetune: merged logits {merge_err} relative L2 from the "
                                 f"adapted model's (limit {FT_MERGE_RTOL})")
        out["decode"] = {"tokens": FT_DECODE_TOKENS, "seconds": decode_s, "text_chars": len(text),
                         "main_path_launches": decode_launches,
                         "merged_logits_rel_l2": merge_err, "merged_limit": FT_MERGE_RTOL,
                         "merged_max_abs_diff": float((merged - adapted).abs().max()),
                         "merged_same_argmax": bool(merged.argmax() == adapted.argmax())}
        del model, ft, callback
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # -- (d) card against CPU
        out["vs_cpu"] = finetune_vs_cpu(dev, seed, train, tmp)

        # -- (e) the analysis tools over the epoch directories
        t0 = time.perf_counter()
        epochs = [os.path.join(eval_dir, f"epoch_{e}") for e in range(FT_EPOCHS)]
        summary = ResultsSummary(epochs)
        table = summary.comparison_table(["perplexity", "average_accuracy"])
        comp = ResultsComparator.from_directories(epochs)
        pair = comp.compare_two("epoch_0", "epoch_1", ["perplexity", "average_accuracy"])
        best = comp.best_model("perplexity")
        board = comp.create_leaderboard({"perplexity": 1.0, "average_accuracy": 1.0})
        paths = ResultsExporter.from_directories(epochs).export_all(os.path.join(tmp, "export"))
        report = ReportGenerator.from_directories(epochs).generate(os.path.join(tmp,
                                                                                "report.html"))
        tools_s = time.perf_counter() - t0
        if set(summary.results) != {"epoch_0", "epoch_1"} or not all(
                os.path.getsize(p) for p in list(paths.values()) + [report]) or best is None:
            raise AssertionError(f"finetune: the tools read {sorted(summary.results)} and "
                                 f"wrote {paths}, {report}")
        with open(report) as f:
            report_text = f.read()
        out["tools"] = {"seconds": tools_s, "matplotlib": _mpl() is not None,
                        "report_plots": report_text.count("data:image/png;base64"),
                        "table_lines": len(table.splitlines()), "pair": pair,
                        "best_perplexity": list(best), "leaderboard": board,
                        "files": sorted(os.path.basename(p) for p in paths.values())}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ph.info.update(out)
    return out


GEN7_BASE = "mistral-7b"
# its 32 layers cut (full width) to keep the whole run inside its time limit: to 16
# for the finetune and multi phases, to 8 for gemv; kernel 11 launches per decode
# step in the fused_mlp variant
GEN7_LAYERS = 4
GEN7_CONFIG = f"{GEN7_BASE}-{GEN7_LAYERS}-layers"
GEN7_NEW_TOKENS = 32
GEN7_FUSED_LOGITS_RTOL = 5e-2  # fused MLP against unfused: per-chunk hidden scales differ


def register_gen7_config() -> None:
    """GEN7_CONFIG in the model presets: GEN7_BASE at GEN7_LAYERS layers."""
    import dataclasses

    from crs_tpu_torch.models.transformer import CONFIGS

    CONFIGS.setdefault(GEN7_CONFIG, dataclasses.replace(CONFIGS[GEN7_BASE],
                                                        num_layers=GEN7_LAYERS))


def variant_model(base, flag: str, seed: int, dev, kv_bits: int = 16):
    """A create_model_interface model with ``flag`` set that serves the base
    model's int8 weights, transformed by the function its load() applies:
    the mistral-7b random init costs over a minute on the host, so the
    variants share one set of quantized weights."""
    import dataclasses

    from crs_tpu_torch.models import create_model_interface
    from crs_tpu_torch.models.transformer import fuse_mlp_params, fuse_qkv_params

    conf = {"config": GEN7_CONFIG, "kv_bits": kv_bits, "seed": seed}
    if flag:
        conf[flag] = True
    model = create_model_interface("int8", conf, device=dev)
    model.cfg = dataclasses.replace(base.cfg, kv_bits=kv_bits)
    model.tokenizer = base.tokenizer
    model.params = {"": lambda p: p, "fuse_projections": fuse_qkv_params,
                    "fused_mlp": fuse_mlp_params}[flag](base.params)
    model.load_time_s, model.weights_source, model._loaded = 0.0, base.weights_source, True
    return model


def first_step_logits(model, cache, token):
    """One decode step of ``token`` on a copy of the prefilled ``cache``: the
    step's logits [B, V]."""
    from crs_tpu_torch.models.transformer import decode_step

    return decode_step(model.params, model.cfg, token, clone_cache(cache))[0]


def rel_l2(got, ref) -> float:
    import torch

    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))


def phase_generate_7b(ph: Phase, dev, seed: int) -> dict:
    """mistral-7b at full width, GEN7_LAYERS of its 32 layers, as int8 with a
    bf16 KV cache (config.json's model values at the one preset whose I
    divides the fused MLP's chunk), random weights from the seed, loaded once
    through create_model_interface; three
    variants — unfused, fuse_projections, fused_mlp — each through greedy
    generate_batch of 32 tokens at batch 1 and 8 on RAG-sized prompts.
    Kernel 11 must launch GEN7_LAYERS times per decode step in the fused_mlp variant
    and never in the others; the first decode step's logits must equal the
    unfused ones with fuse_projections and lie within 5e-2 relative L2 of them
    with fused_mlp. Then one kv_bits 8 batch-8 decode through kernels 10 and
    11 together, held against the plain versions."""
    import torch

    from crs_tpu_torch.models import create_model_interface, params_num_bytes
    from crs_tpu_torch.models.transformer import decode_step, init_cache, prefill

    prompts = rag_prompts(max(GEN_BATCHES))
    register_gen7_config()
    base = create_model_interface("int8", {"config": GEN7_CONFIG, "kv_bits": 16, "seed": seed},
                                  device=dev)
    t0 = time.perf_counter()
    base.load()
    out = {"config": GEN7_CONFIG, "kv_bits": 16, "new_tokens": GEN7_NEW_TOKENS,
           "load_s": time.perf_counter() - t0, "variants": {}}
    steps = GEN7_NEW_TOKENS - 1  # decode steps: the last token needs none
    launches = 0
    ref_logits = {}
    for flag in ("", "fuse_projections", "fused_mlp"):
        model = base if not flag else variant_model(base, flag, seed, dev)
        name = flag or "unfused"
        info = {"weight_bytes": params_num_bytes(model.params),
                "model_info": {k: model.get_model_info()[k]
                               for k in ("fused_projections", "fused_mlp", "bits_per_param")}}
        for b in GEN_BATCHES:
            batch = prompts[:b]
            model.generate_batch(batch, 2)  # warm-up
            # the main path: counts to 0 just before, read just after
            reset_counts()
            sync(dev)
            t0 = time.perf_counter()
            texts = model.generate_batch(batch, GEN7_NEW_TOKENS)
            sync(dev)
            total_ms = (time.perf_counter() - t0) * 1e3
            counts = kernel_counts()
            want = GEN7_LAYERS * steps if flag == "fused_mlp" else 0
            if counts.get("fused_mlp_int8", 0) != want:
                raise AssertionError(f"{name} B={b}: fused_mlp_int8 launched "
                                     f"{counts.get('fused_mlp_int8', 0)} times in {steps} decode "
                                     f"steps, expected {want}")
            launches += counts.get("fused_mlp_int8", 0)
            if len(texts) != b or not all(isinstance(t, str) for t in texts):
                raise AssertionError(f"{name} B={b}: generate_batch returned {texts!r}")
            ids, mask = model.encode_batch(batch, GEN7_NEW_TOKENS)
            cache = init_cache(model.cfg, b, ids.shape[1] + GEN7_NEW_TOKENS, device=dev)
            sync(dev)
            t0 = time.perf_counter()
            logits, cache = prefill(model.params, model.cfg, ids, cache, mask)
            sync(dev)
            prefill_ms = (time.perf_counter() - t0) * 1e3
            token = torch.argmax(logits[:, -1], dim=-1)
            kv_bytes = sum(t.numel() * t.element_size() for t in (cache.k, cache.v, cache.mask))
            start = cache  # the prefilled cache, for the first-step checks
            state = {"cache": clone_cache(cache)}

            def step():
                state["logits"], state["cache"] = decode_step(model.params, model.cfg, token,
                                                              state["cache"])

            decode_ms = device_ms(dev, step, iters=16, warmup=2)
            step_profile = device_profile(step, decode_ms, top=6)
            del state
            row = {"prompt_tokens": int(ids.shape[1]), "generate_ms": total_ms,
                   "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
                   "tokens_per_s": b * 1000.0 / decode_ms, "decode_step_profile": step_profile,
                   "kv_cache_bytes": kv_bytes, "main_path_launches": counts,
                   "launches_per_decode_step": {k: v / steps for k, v in counts.items()},
                   "sample": texts[0][:80]}
            if not flag:  # the reference of the first decode step
                ref_logits[b] = (token, first_step_logits(model, start, token))
            else:
                token, ref = ref_logits[b]
                got = first_step_logits(model, start, token)
                rel = rel_l2(got, ref)
                row.update({"first_step_logits_rel_l2_vs_unfused": rel,
                            "first_step_top1_agreement_vs_unfused":
                                float((got.argmax(-1) == ref.argmax(-1)).float().mean())})
                if flag == "fuse_projections" and not torch.equal(got, ref):
                    raise AssertionError(f"fuse_projections B={b}: first-step logits differ from "
                                         f"the unfused ones (relative L2 {rel})")
                if flag == "fused_mlp" and (not rel <= GEN7_FUSED_LOGITS_RTOL
                                            or not bool(torch.isfinite(got).all())):
                    raise AssertionError(f"fused_mlp B={b}: first-step logits {rel} from the "
                                         f"unfused ones (relative L2, limit "
                                         f"{GEN7_FUSED_LOGITS_RTOL})")
            if flag == "fused_mlp":
                with plain_kernels():
                    plain = first_step_logits(model, start, token)
                row["first_step_logits_rel_l2_vs_plain"] = rel_l2(got, plain)
                if not row["first_step_logits_rel_l2_vs_plain"] <= GEN_LOGITS_RTOL:
                    raise AssertionError(f"fused_mlp B={b}: first-step logits through kernel 11 "
                                         f"differ from its plain version by "
                                         f"{row['first_step_logits_rel_l2_vs_plain']}")
            info[f"batch_{b}"] = row
            del cache, start
            torch.cuda.empty_cache()
        out["variants"][name] = info
        if flag == "fuse_projections":
            del model
            torch.cuda.empty_cache()
    # kernels 10 and 11 together: kv_bits 8, batch 8
    model = variant_model(base, "fused_mlp", seed, dev, kv_bits=8)
    batch = prompts[:8]
    model.generate_batch(batch, 2)
    reset_counts()
    sync(dev)
    t0 = time.perf_counter()
    model.generate_batch(batch, GEN7_NEW_TOKENS)
    sync(dev)
    total_ms = (time.perf_counter() - t0) * 1e3
    counts = kernel_counts()
    for kernel in ("fused_mlp_int8", "decode_attention_int8"):
        if counts.get(kernel, 0) != GEN7_LAYERS * steps:
            raise AssertionError(f"kv_bits 8: {kernel} launched {counts.get(kernel, 0)} times in "
                                 f"{steps} decode steps")
    launches += counts["fused_mlp_int8"]
    ids, mask = model.encode_batch(batch, GEN7_NEW_TOKENS)
    cache = init_cache(model.cfg, 8, ids.shape[1] + 2, device=dev)
    _, cache = prefill(model.params, model.cfg, ids, cache, mask)
    token = ref_logits[8][0]
    got = first_step_logits(model, cache, token)
    with plain_kernels():
        plain = first_step_logits(model, cache, token)
    rel = rel_l2(got, plain)
    if not rel <= GEN_LOGITS_RTOL or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"kv_bits 8 fused_mlp: first-step logits {rel} from the plain "
                             f"versions (limit {GEN_LOGITS_RTOL})")
    out["kv8_fused_mlp_batch_8"] = {
        "generate_ms": total_ms, "main_path_launches": counts,
        "launches_per_decode_step": {k: v / steps for k, v in counts.items()},
        "first_step_logits_rel_l2_vs_plain": rel,
        "first_step_top1_agreement_vs_unfused_bf16_cache":
            float((got.argmax(-1) == ref_logits[8][1].argmax(-1)).float().mean())}
    out["main_path_launches"] = launches
    out["note"] = ("decode_ms_per_token: CUDA events over 16 decode steps (host work included); "
                   "prefill_ms: host clock around one prefill; generate_ms: one greedy "
                   "generate_batch of 32 tokens, prefill included; kv_cache_bytes: the bf16 "
                   "cache for prompt + 32 tokens")
    del model, base
    torch.cuda.empty_cache()
    ph.info.update(out)
    return out


CALIB_CONFIG = "small"  # config.json's model config
CALIB_NEW_TOKENS = 16


def phase_calibrated(ph: Phase, dev, seed: int) -> dict:
    """The calibrated gptq / awq types of the small config loaded on the card
    through create_model_interface (statistics on the card, rounding loops
    on the host): load seconds, the share of codes equal to the same load on
    the CPU, each layer's reconstruction error against plain rounding on the
    card's statistics, and 16 greedy tokens."""
    import numpy as np

    from crs_tpu_torch.models import create_model_interface
    from crs_tpu_torch.models.quant_calib import (
        _recon_error, _rtn_dequant, awq_search_scale, collect_calibration_stats,
    )
    from crs_tpu_torch.models.transformer import init_params

    out = {"config": CALIB_CONFIG}
    question = "What does product quantization trade for its smaller index?"
    for kind in ("gptq", "awq"):
        conf = {"config": CALIB_CONFIG, "seed": seed}
        model = create_model_interface(kind, conf, device=dev)
        t0 = time.perf_counter()
        model.load()
        load_s = time.perf_counter() - t0
        cpu = create_model_interface(kind, conf, device="cpu")
        t0 = time.perf_counter()
        cpu.load()
        cpu_load_s = time.perf_counter() - t0
        same = total = 0
        for lg, lc in zip(model.params["layers"], cpu.params["layers"]):
            for grp in ("attn", "mlp"):
                for name, qt in lg[grp].items():
                    same += int((qt.codes.cpu() == lc[grp][name].codes).sum())
                    total += qt.codes.numel()
        # reconstruction error on the card's statistics, against plain rounding
        full = init_params(seed, model.cfg, device=dev)
        stats = collect_calibration_stats(full, model.cfg, model._calibration_batches())
        ratios = []
        sites = {"q": "attn_in", "k": "attn_in", "v": "attn_in", "o": "o_in",
                 "gate": "mlp_in", "up": "mlp_in", "down": "down_in"}
        err_total = rtn_total = 0.0
        for li, layer in enumerate(full["layers"]):
            for grp in ("attn", "mlp"):
                for name, w in layer[grp].items():
                    w = w.float().cpu().numpy()
                    st = stats[li][sites[name]]
                    rtn = _recon_error(w, _rtn_dequant(w, 4, model.group_size), st["gram"])
                    if kind == "gptq":
                        w_hat = model.params["layers"][li][grp][name].dequantize().cpu().numpy()
                    else:
                        s = awq_search_scale([w], st["mean_abs"], st["gram"], 4, model.group_size)
                        w_hat = _rtn_dequant(w * s[:, None], 4, model.group_size) / s[:, None]
                    err = _recon_error(w, w_hat, st["gram"])
                    if kind == "awq" and err > rtn:
                        raise AssertionError(f"awq layer {li} {name}: error {err} above plain "
                                             f"rounding's {rtn}")
                    ratios.append(err / rtn)
                    err_total += err
                    rtn_total += rtn
        if not err_total < rtn_total:
            raise AssertionError(f"{kind}: reconstruction error {err_total} not below plain "
                                 f"rounding's {rtn_total}")
        text = model.generate(question, max_new_tokens=CALIB_NEW_TOKENS)
        if not isinstance(text, str):
            raise AssertionError(f"{kind}: generate returned {text!r}")
        out[kind] = {"load_s": load_s, "cpu_load_s": cpu_load_s,
                     "codes_equal_to_cpu_load": same / total,
                     "recon_error_over_rtn": {"total": err_total / rtn_total,
                                              "max_layer": max(ratios),
                                              "mean_layer": float(np.mean(ratios))},
                     "sample": text[:80]}
        del model, cpu, full
    out["note"] = ("recon_error_over_rtn: tr(ΔᵀHΔ) against plain 4-bit rounding's on the card's "
                   "calibration statistics (awq: each layer's searched scale, at most 1 by "
                   "construction; gptq: the loaded weights)")
    ph.info.update(out)
    return out


def phase_rag(ph: Phase, dev, seed: int, shared: dict) -> dict:
    """RAGPipeline (config.json's lexical embedding, int8 store, bench.py's
    retrieval and config.json's chunking and generation values) over the
    held-out corpus with the nf4 1b model of the generate phase: the
    embedder fits on the card (its Gram and projection products on CUDA
    tensors); query() on held-out questions, sampling through a
    torch.Generator; ms per query split into retrieve and generate. The
    retrieved chunks are checked against a CPU pipeline that loads the
    card's saved index and fitted state (only the projection's sum order
    differs: ids equal), and the card's doc·query scores against a CPU
    pipeline that fits on its own (within RAG_FIT_SCORE_TOL)."""
    import tempfile

    import numpy as np

    from crs_tpu_torch.rag import RAGPipeline

    with open(CONFIG_JSON) as f:
        rag_cfg = json.load(f)["rag"]
    cfg = {"chunking": rag_cfg["chunking"], "embedding": rag_cfg["embedding"],
           "vector_store": {**rag_cfg["vector_store"], "format": "int8", "persist_directory": None},
           "retrieval": BENCH_RETRIEVER, "generation": rag_cfg["generation"]}
    model = shared["nf4_model"]
    with tempfile.TemporaryDirectory() as tmp:
        card_cfg = {**cfg, "vector_store": {**cfg["vector_store"], "persist_directory": tmp}}
        pipe = RAGPipeline(card_cfg, device=dev).setup(model)
        pipe.index_documents(CORPUS)
        fit = pipe.embedder.encoder.fit_report
        if not fit_on(fit, dev):
            raise AssertionError(f"rag: the lexical fit's products ran on {fit}, not {dev}")
        loaded = RAGPipeline(card_cfg, device="cpu").setup()  # the card's index and state
    own = RAGPipeline(cfg, device="cpu").setup()  # the CPU's own fit
    own.index_documents(CORPUS)
    with open(QA) as f:
        questions = [x["question"] for x in json.load(f)][:RAG_QUESTIONS]
    pipe.retrieve(questions[0])  # warm-up
    model.generate_batch([questions[0]], 2)
    rows = []
    # the main path: counts to 0 just before, read just after
    reset_counts()
    for q in questions:
        sync(dev)
        t0 = time.perf_counter()
        res = pipe.query(q, return_chunks=True)
        sync(dev)
        total_ms = (time.perf_counter() - t0) * 1e3
        rows.append((q, res, total_ms))
    counts = kernel_counts()
    if counts.get("nf4_matmul", 0) == 0 or counts.get("decode_attention_int8", 0) == 0:
        raise AssertionError(f"rag: the generator's kernels did not launch: {counts}")
    per_query = []
    for q, res, total_ms in rows:
        t0 = time.perf_counter()
        chunks = pipe.retrieve(q)
        sync(dev)
        retrieve_ms = (time.perf_counter() - t0) * 1e3
        want = [c["id"] for c in loaded.retrieve(q)]
        if [c["id"] for c in res["chunks"]] != want or [c["id"] for c in chunks] != want:
            raise AssertionError(f"rag: {q!r} retrieved {[c['id'] for c in res['chunks']]}, "
                                 f"the CPU pipeline on the card's state {want}")
        if not want or not isinstance(res["answer"], str):
            raise AssertionError(f"rag: {q!r} got no context ({want}) or no answer")
        per_query.append({"question": q, "ms": total_ms, "retrieve_ms": retrieve_ms,
                          "generate_ms": total_ms - retrieve_ms, "chunks": want,
                          "answer_chars": len(res["answer"])})
    # the card's fit against the CPU's own: doc·query scores of every chunk
    with open(QA) as f:
        all_q = [x["question"] for x in json.load(f)]
    docs = pipe.store.documents
    if own.store.documents != docs:
        raise AssertionError("rag: the CPU pipeline chunked the corpus differently")

    def scores(p):
        d = p.embedder.embed(docs).cpu().double().numpy()
        return d @ p.embedder.embed(all_q, is_query=True).cpu().double().numpy().T

    fit_diff = float(np.abs(scores(pipe) - scores(own)).max())
    if not fit_diff <= RAG_FIT_SCORE_TOL:
        raise AssertionError(f"rag: doc·query scores of the card's fit differ from the CPU's "
                             f"own fit by {fit_diff} (limit {RAG_FIT_SCORE_TOL})")
    out = {"chunks_indexed": pipe.store.n, "queries": per_query,
           "ms_per_query": sum(r["ms"] for r in per_query) / len(per_query),
           "retrieve_ms_per_query": sum(r["retrieve_ms"] for r in per_query) / len(per_query),
           "generate_ms_per_query": sum(r["generate_ms"] for r in per_query) / len(per_query),
           "main_path_launches": counts, "generation": cfg["generation"],
           "embedding": cfg["embedding"]["backend"], "fit": fit,
           "vs_cpu_on_card_state": "retrieved chunk ids equal (the card's index and fitted "
                                   "state loaded on the CPU)",
           "vs_cpu_own_fit": {"questions": len(all_q), "chunks": len(docs),
                              "max_score_diff": fit_diff, "limit": RAG_FIT_SCORE_TOL}}
    ph.info.update(out)
    return out


LEXICAL_ROWS = 1 << 14  # chunks of the lexical phase (2^18 cut to a sixteenth for the time limit)
LEXICAL_SAMPLE = 2048  # chunks held against the CPU encoder
EMBED_ATOL = 1e-5  # one projection (or one encoder) on the card and the CPU: f32 sum orders


def fit_on(fit: dict, dev) -> bool:
    """The lexical fit's Gram and projection products ran on ``dev``'s kind."""
    import torch

    return all(torch.device(fit[k]).type == dev.type for k in ("device", "projection_device"))


def config_json_rag() -> dict:
    with open(CONFIG_JSON) as f:
        return json.load(f)["rag"]


def phase_lexical(ph: Phase, dev, seed: int, shared: dict) -> dict:
    """config.json's lexical encoder at full width (131,072 features, 384
    dims, char n-grams, BM25 k1 0.6, 4 expansion terms, 2,048 fit docs) over
    LEXICAL_ROWS synthetic chunks of config.json's length (prose_chunks:
    240 words, ~1,900 features each) into config.json's int8 store (block
    1,024), then a retrieve batch of 328 queries with config.json's
    retrieval values through kernel 1 (counted): fit seconds by stage, index
    embed seconds, query embed ms; the card's chunk (a sample) and query
    embeddings against a CPU encoder that loads the card's saved state, and
    the retrieved ids against the same store's plain scan. The index and
    state stay in a temporary directory for the cli phase."""
    import tempfile

    import numpy as np
    import torch

    from crs_tpu_torch.ops import scan
    from crs_tpu_torch.rag import ContextRetriever, EmbeddingModel, VectorStore
    from crs_tpu_torch.rag.hashed_features import featurize_batch_counts

    rag = config_json_rag()
    rng = np.random.default_rng(seed + 30)
    t0 = time.perf_counter()
    texts, queries = prose_chunks(rng, LEXICAL_ROWS, rag["chunking"]["chunk_size"])
    texts_s = time.perf_counter() - t0
    em = EmbeddingModel(rag["embedding"], device=dev)
    t0 = time.perf_counter()
    em.fit(texts)
    sync(dev)
    fit_s = time.perf_counter() - t0
    fit = em.encoder.fit_report
    if not fit_on(fit, dev):
        raise AssertionError(f"lexical: the fit's products ran on {fit}, not {dev}")
    t0 = time.perf_counter()
    emb = em.embed_chunks(texts)
    sync(dev)
    embed_s = time.perf_counter() - t0
    store = VectorStore({**rag["vector_store"], "persist_directory": None}, device=dev)
    t0 = time.perf_counter()
    store.create_index(texts, emb)
    sync(dev)
    index_s = time.perf_counter() - t0
    retr = ContextRetriever(store, em, rag["retrieval"])
    retr.retrieve_batch(queries)  # warm-up
    sync(dev)
    t0 = time.perf_counter()
    em.embed(queries, is_query=True)
    sync(dev)
    query_embed_ms = (time.perf_counter() - t0) * 1e3
    # the main path: counts to 0 just before, read just after
    reset_counts()
    t0 = time.perf_counter()
    results = retr.retrieve_batch(queries)
    sync(dev)
    batch_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(scan.STATS.by_kernel)
    if launches.get("int8_scan_topk", 0) < 1:
        raise AssertionError(f"lexical: kernel 1 did not launch ({launches})")
    with plain_kernels():
        plain = retr.retrieve_batch(queries)
    ids = [[c["id"] for c in r] for r in results]
    if ids != [[c["id"] for c in r] for r in plain]:
        raise AssertionError("lexical: the retrieved ids differ from the store's plain scan")
    answered = sum(1 for r in ids if r)
    if answered < len(queries) // 2:
        raise AssertionError(f"lexical: only {answered} of {len(queries)} queries got context")
    shared["lexical_question"] = next(q for q, r in zip(queries, ids) if r) + "?"

    # the card's embeddings against the CPU encoder on the card's saved state
    tmp = tempfile.mkdtemp(prefix="lexical_index_")
    shared["lexical_dir"] = tmp
    t0 = time.perf_counter()
    store.save(tmp)
    em.save_state(tmp)
    save_s = time.perf_counter() - t0
    cpu = EmbeddingModel(rag["embedding"], device="cpu")
    if not cpu.load_state(tmp):
        raise AssertionError("lexical: the CPU encoder found no saved state")
    sample = np.linspace(0, LEXICAL_ROWS - 1, LEXICAL_SAMPLE).astype(int)
    _, _, offsets = featurize_batch_counts([texts[i] for i in sample], em.encoder.num_features,
                                           em.encoder.char_ngrams)
    nnz = np.diff(offsets)
    kmax = em.encoder._NNZ_BUCKETS[-1]
    chunk_err = float((cpu.embed_chunks([texts[i] for i in sample])
                       - emb[torch.from_numpy(sample).to(dev)].cpu()).abs().max())
    query_err = float((cpu.embed(queries, is_query=True)
                       - em.embed(queries, is_query=True).cpu()).abs().max())
    if not max(chunk_err, query_err) <= EMBED_ATOL:
        raise AssertionError(f"lexical: card embeddings differ from the CPU's on the card's "
                             f"state by {chunk_err} (chunks) / {query_err} (queries)")
    out = {"rows": store.n, "features": em.encoder.num_features, "dim": em.encoder.dim,
           "chunk_words": rag["chunking"]["chunk_size"], "texts_s": texts_s,
           "features_per_chunk": {"sample": LEXICAL_SAMPLE, "mean": float(nnz.mean()),
                                  "max": int(nnz.max()), "bucket_max": kmax,
                                  "share_past_bucket": float((nnz > kmax).mean())},
           "fit_s": fit_s, "fit_stages_s": fit["seconds"], "fit_basis_docs": fit["basis_docs"],
           "expansion_words": len(em.encoder._exp_map),
           "index_embed_s": embed_s, "index_store_s": index_s, "save_s": save_s,
           "query_embed_ms": query_embed_ms,
           "query_embed_ms_per_query": query_embed_ms / len(queries), "batch": len(queries),
           "retrieve_batch_ms": batch_ms, "ms_per_query": batch_ms / len(queries),
           "answered": answered, "main_path_launches": launches,
           "vs_plain_scan": "retrieved ids equal",
           "vs_cpu_on_card_state": {"chunks": LEXICAL_SAMPLE, "chunk_max_abs": chunk_err,
                                    "query_max_abs": query_err, "limit": EMBED_ATOL}}
    ph.info.update(out)
    return out


MINILM_ROWS = 4096  # chunks the full-width MiniLM embeds (4 blocks: kernel 1's route)
MINILM_SAMPLE = 256  # chunks held against the CPU (~62,000 tokens)


def phase_minilm(ph: Phase, dev, seed: int) -> dict:
    """The MiniLM-L6 encoder at full width (384, 12 heads, 1,536, vocab
    30,522, random init from the seed, the hash tokenizer) embeds
    MINILM_ROWS chunks of config.json's length (prose_chunks: 240 words,
    ~242 tokens of config.json's max_length 256) at batch 32 into config.json's int8 store; a search
    of 64 queries through kernel 1 (counted). Held against the CPU: the
    embeddings of a sample of chunks and of the queries (the same weights,
    within EMBED_ATOL), and the search's ids and scores against the same
    embeddings in a CPU store."""
    import numpy as np
    import torch

    from crs_tpu_torch.ops import scan
    from crs_tpu_torch.rag import EmbeddingModel, VectorStore

    rag = config_json_rag()
    cfg = {**rag["embedding"], "backend": "minilm", "seed": seed}
    rng = np.random.default_rng(seed + 31)
    texts, queries = prose_chunks(rng, MINILM_ROWS, rag["chunking"]["chunk_size"])
    queries = queries[:64]
    t0 = time.perf_counter()
    em = EmbeddingModel(cfg, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    em.embed(texts[:64])  # warm-up
    sync(dev)
    t0 = time.perf_counter()
    emb = em.embed_chunks(texts)
    sync(dev)
    embed_s = time.perf_counter() - t0
    store = VectorStore({**rag["vector_store"], "persist_directory": None}, device=dev)
    store.create_index(texts, emb)
    q = em.embed(queries)
    reset_counts()
    got = store.search_batch(q, top_k=FAULT_K)
    sync(dev)
    launches = dict(scan.STATS.by_kernel)
    if launches.get("int8_scan_topk", 0) < 1:
        raise AssertionError(f"minilm: kernel 1 did not launch ({launches})")
    cpu = EmbeddingModel(cfg, device="cpu")
    chunk_err = float((cpu.embed_chunks(texts[:MINILM_SAMPLE]) - emb[:MINILM_SAMPLE].cpu())
                      .abs().max())
    query_err = float((cpu.embed(queries) - q.cpu()).abs().max())
    if not max(chunk_err, query_err) <= EMBED_ATOL:
        raise AssertionError(f"minilm: card embeddings differ from the CPU's by {chunk_err} "
                             f"(chunks) / {query_err} (queries)")
    cpu_store = VectorStore({**rag["vector_store"], "persist_directory": None}, device="cpu")
    cpu_store.create_index(texts, emb.cpu())
    search_err = check_float_ranked(got, cpu_store.search_batch(q.cpu(), top_k=FAULT_K + 1),
                                    FLOAT_RTOL["fp32"], dim=1)
    tokens = sum(min(len(em.tokenizer.encode(t)), em.max_length) for t in texts)
    out = {"rows": store.n, "hidden": em.encoder.cfg.hidden_size,
           "layers": em.encoder.cfg.num_layers, "vocab": em.encoder.cfg.vocab_size,
           "batch_size": em.batch_size, "init_s": init_s, "embed_s": embed_s,
           "chunks_per_s": MINILM_ROWS / embed_s, "tokens": tokens,
           "tokens_per_chunk": tokens / MINILM_ROWS, "tokens_per_s": tokens / embed_s,
           "main_path_launches": launches,
           "vs_cpu": {"chunks": MINILM_SAMPLE, "chunk_max_abs": chunk_err,
                      "query_max_abs": query_err, "limit": EMBED_ATOL,
                      "search_max_abs": search_err}}
    ph.info.update(out)
    return out


CLI_QUERY = "What is GPTQ?"
CLI_TIMEOUT_S = 300
CLI_NEW_TOKENS = 8  # the model child's max_new_tokens (config.json: 256)


def tree_digest(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    for root, dirs, files in sorted(os.walk(path)):
        dirs.sort()
        for name in sorted(files):
            full = os.path.join(root, name)
            h.update(os.path.relpath(full, path).encode())
            with open(full, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def cli_config(tmp: str, name: str, persist: str, max_new_tokens: int = 0) -> str:
    """A copy of config.json in ``tmp`` that persists to ``persist`` (and
    generates at most ``max_new_tokens`` tokens, when given)."""
    with open(CONFIG_JSON) as f:
        cfg = json.load(f)
    cfg["rag"]["vector_store"]["persist_directory"] = persist
    if max_new_tokens:
        cfg["rag"]["generation"]["max_new_tokens"] = max_new_tokens
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def run_cli(args, what: str) -> tuple:
    """``python -m crs_tpu_torch`` in a child process on the card; returns
    (seconds, standard output). The child ends within CLI_TIMEOUT_S or is
    killed."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "crs_tpu_torch", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"cli {what}: exit {proc.returncode}: {proc.stderr[-2000:]}")
    return time.perf_counter() - t0, proc.stdout


def chunk_lines(out: str) -> list:
    return [line for line in out.splitlines() if line.startswith("  [")]


def phase_cli(ph: Phase, dev, shared: dict) -> dict:
    """``python -m crs_tpu_torch``, the port's command line, on the card
    with copies of config.json pointed at temporary directories (vector_db/
    itself is never written: its digest is checked): ``--no-model --query``
    on a copy of vector_db/ must print chunks; ``--query`` with config.json's
    model (int8 small, random init, through create_model_interface; at most
    CLI_NEW_TOKENS new tokens) must print chunks and an answer; ``--index`` of the held-out
    corpus writes its index into its own directory only, and ``--query`` on
    it prints chunks; then ``main`` in this process answers a query on the
    lexical phase's LEXICAL_ROWS-chunk index through kernel 1 (counted)."""
    import io
    import shutil
    import tempfile

    from crs_tpu_torch.__main__ import main as cli_main
    from crs_tpu_torch.ops import scan

    if "lexical_dir" not in shared:
        raise AssertionError("cli: needs the lexical phase's index (run it first)")
    vdb = os.path.join(REPO, "vector_db")
    before = tree_digest(vdb)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(vdb, os.path.join(tmp, "vdb"))
        cfg = cli_config(tmp, "vdb", os.path.join(tmp, "vdb"))
        secs, stdout = run_cli(["--config", cfg, "--no-model", "--query", CLI_QUERY], "query")
        lines = chunk_lines(stdout)
        if not lines:
            raise AssertionError(f"cli: --query printed no chunks: {stdout[-1000:]}")
        out["vector_db_query"] = {"seconds": secs, "chunks": lines}
        cfg = cli_config(tmp, "vdb_model", os.path.join(tmp, "vdb"), CLI_NEW_TOKENS)
        secs, stdout = run_cli(["--config", cfg, "--query", CLI_QUERY], "model query")
        answer = [line for line in stdout.splitlines() if line.startswith("answer: ")]
        if not chunk_lines(stdout) or len(answer) != 1:
            raise AssertionError(f"cli: --query with the model printed no chunks or no "
                                 f"answer: {stdout[-1000:]}")
        out["vector_db_model_query"] = {"seconds": secs, "max_new_tokens": CLI_NEW_TOKENS,
                                        "chunks": chunk_lines(stdout), "answer": answer[0]}
        index_dir = os.path.join(tmp, "heldout")
        cfg = cli_config(tmp, "heldout", index_dir)
        secs, stdout = run_cli(["--config", cfg, "--no-model", "--index", CORPUS], "index")
        written = sorted(os.listdir(tmp))
        if written != ["heldout", "heldout.json", "vdb", "vdb.json", "vdb_model.json"] or \
                sorted(os.listdir(index_dir)) != ["index_arrays.npz", "index_meta.json",
                                                  "lexical_state.npz"]:
            raise AssertionError(f"cli: --index wrote {written} / {os.listdir(index_dir)}")
        q_secs, q_out = run_cli(["--config", cfg, "--no-model", "--query", CLI_QUERY], "query")
        if not chunk_lines(q_out):
            raise AssertionError(f"cli: --query on the new index printed no chunks")
        out["heldout_index"] = {"seconds": secs, "printed": stdout.strip().splitlines()[-1],
                                "query_seconds": q_secs, "chunks": chunk_lines(q_out)}
        big = cli_config(tmp, "lexical", shared["lexical_dir"])
        question = shared["lexical_question"]
        buf = io.StringIO()
        root = logging.getLogger()
        saved = (list(root.handlers), root.level)
        reset_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli_main(["--config", big, "--no-model", "--query", question,
                               "--device", dev.type])
            sync(dev)
        finally:  # main configures the root logger: put this script's back
            root.handlers[:] = saved[0]
            root.setLevel(saved[1])
        secs = time.perf_counter() - t0
        launches = dict(scan.STATS.by_kernel)
        if rc != 0 or launches.get("int8_scan_topk", 0) < 1 or not chunk_lines(buf.getvalue()):
            raise AssertionError(f"cli: main on the lexical index: rc {rc}, launches "
                                 f"{launches}, output {buf.getvalue()[-1000:]}")
        out["lexical_index_query"] = {"seconds_with_load": secs, "question": question,
                                      "main_path_launches": launches,
                                      "chunks": chunk_lines(buf.getvalue())}
    shutil.rmtree(shared.pop("lexical_dir"), ignore_errors=True)
    if tree_digest(vdb) != before:
        raise AssertionError("cli: vector_db/ changed")
    out["vector_db_unchanged"] = True
    ph.info.update(out)
    return out


MULTI_K = 3
MULTI_STORES = {"int8": BENCH_STORE, "bf16": dict(CONFIG_STORE, format="bf16")}
MULTI_KERNEL = {"int8": "int8_scan_topk", "bf16": "scan_topk_bf16"}
MULTI_RECALL_SLACK = 0.005  # recall@3 of the mesh store within this of the unsharded store's
MULTI_PQ_ROWS = 1 << 17
MULTI_PQ_STORE = dict(CONFIG_STORE, format="pq", pq_iters=8, pq_opq_iters=2)
MULTI_BATCH, MULTI_PROMPT, MULTI_NEW_TOKENS = 8, 64, 32
MULTI_TRAIN_BATCH, MULTI_TRAIN_SEQ = 4, 256
MULTI_LOSS_RTOL = 1e-3
# kernel table row → its count on the mesh path
MULTI_LAUNCH_KEY = {"int8_scan_topk": "int8_scan_topk", "scan_topk_f32_bf16": "scan_topk_bf16",
                    "adc_scan_topk_residual": "adc_scan_topk_residual",
                    "decode_attention_int8": "decode_attention_int8"}


def phase_multi(ph: Phase, dev, seed: int, shared: dict) -> dict:
    """Multi-device serving and training at world size 1 (a one-rank NCCL
    group; every collective runs): (a) int8 and bf16 mesh stores over the
    full phase's 1M embeddings, search_batch at batch 328, k 3, through
    kernels 1 and 2 (counted), ids against the plain shard body on the same
    tensors, recall@3 against the fp32 exact top-3 beside the unsharded
    store's, ms per query beside it; (b) a residual pq mesh store with the
    int8 mirror at 131,072 rows through kernel 3 (counted), bit for bit
    against the plain versions; (c) the 1b config, dense bf16, kv_bits 8, at
    (dp, tp) = (1, 1): sharded_generate_tokens, 32 greedy tokens at batch 8
    equal to the unsharded generate_tokens, kernel 10 16 times a decode step,
    the first decode step against the plain version; one AdamW
    make_sharded_train_step at 4 × 256 tokens, its loss within 1e-3 of the
    unsharded loss. Returns the main path's launches by kernel."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from crs_tpu_torch.finetuning.trainer import masked_loss
    from crs_tpu_torch.models.sampling import SamplingParams, generate_tokens
    from crs_tpu_torch.models.sharding import (
        make_model_mesh, make_sharded_train_step, param_leaves, shard_batch, shard_params,
        sharded_generate_tokens,
    )
    from crs_tpu_torch.models.transformer import (
        CONFIGS, decode_step, forward, init_cache, init_params, prefill,
    )
    from crs_tpu_torch.ops import decode_attention
    from crs_tpu_torch.ops.scan import STATS
    from crs_tpu_torch.ops.topk import exact_topk
    from crs_tpu_torch.parallel import corpus_mesh
    from crs_tpu_torch.parallel.sharded_index import sharded_topk, sharded_topk_int8
    from crs_tpu_torch.rag import VectorStore

    texts, queries, emb, em = (shared[k] for k in ("texts", "queries", "emb", "em"))
    n = emb.shape[0]
    q_emb = em.embed(queries)
    exact_ids = exact_topk(emb, q_emb, MULTI_K, n)[1].cpu().tolist()

    def recall(ids) -> float:
        return sum(len(set(g) & set(e)) for g, e in zip(ids.cpu().tolist(), exact_ids)) / (
            MULTI_K * len(exact_ids))

    mesh = corpus_mesh(device=dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    out = {"card": smi.stdout.strip().splitlines()[0], "world_size": dist.get_world_size(),
           "backend": dist.get_backend(), "corpus_mesh": list(mesh.mesh.shape)}
    launches = {}
    for fmt, cfg in MULTI_STORES.items():
        plain_store = VectorStore(cfg, device=dev)
        plain_store.create_index(texts, emb)
        unsharded_ms = device_ms(dev, lambda: plain_store.search_batch(q_emb, MULTI_K), iters=5)
        unsharded_recall = recall(plain_store.search_batch(q_emb, MULTI_K)[1])
        del plain_store
        sync(dev)
        t0 = time.perf_counter()
        store = VectorStore(cfg, device=dev, mesh=mesh)
        store.create_index(texts, emb)
        sync(dev)
        setup_s = time.perf_counter() - t0
        res = {}

        def serve():
            res["got"] = store.search_batch(q_emb, MULTI_K)

        # the main path: counts to 0 just before, read just after
        reset_counts()
        mesh_ms = device_ms(dev, serve, iters=5, warmup=1)
        count = STATS.by_kernel.get(MULTI_KERNEL[fmt], 0)
        if count == 0:
            raise AssertionError(f"multi {fmt}: {MULTI_KERNEL[fmt]} never launched: "
                                 f"{STATS.by_kernel}")
        launches[MULTI_KERNEL[fmt]] = count
        got = res["got"]
        if fmt == "int8":  # the dense per-shard body: kernel 1's route not taken
            ref = sharded_topk_int8(store._codes, store._scales, q_emb, MULTI_K, n, mesh,
                                    rescore_k=store.rescore_k, block_size=1 << 30)
        else:
            ref = sharded_topk(store._vectors, q_emb, MULTI_K, n, mesh, block_size=1 << 30)
        err = check_float_ranked(got, ref, FLOAT_RTOL.get(fmt, ID_RTOL), 1)
        mesh_recall = recall(got[1])
        if abs(mesh_recall - unsharded_recall) > MULTI_RECALL_SLACK:
            raise AssertionError(f"multi {fmt}: recall@3 {mesh_recall} against the unsharded "
                                 f"store's {unsharded_recall}")
        out[fmt] = {"rows": n, "batch": BATCH, "k": MULTI_K, "setup_s": setup_s,
                    "ms_per_query": mesh_ms / BATCH, "unsharded_ms_per_query":
                    unsharded_ms / BATCH, "launches_per_batch": count / 6,
                    "vs_plain_shard_body_max_abs": err, "recall_at_3_vs_fp32_exact": mesh_recall,
                    "unsharded_recall_at_3": unsharded_recall,
                    "memory_bytes": store.memory_bytes()}
        del store, res, got, ref
        empty_cache(dev)

    # (b) residual pq with the int8 mirror: kernel 3 on the shard
    t0 = time.perf_counter()
    store = VectorStore(MULTI_PQ_STORE, device=dev, mesh=mesh)
    store.create_index(texts[:MULTI_PQ_ROWS], emb[:MULTI_PQ_ROWS])
    sync(dev)
    setup_s = time.perf_counter() - t0
    reset_counts()
    res = {}
    pq_ms = device_ms(dev, lambda: res.update(got=store.search_batch(q_emb, MULTI_K)), iters=5)
    count = STATS.by_kernel.get("adc_scan_topk_residual", 0)
    if count == 0:
        raise AssertionError(f"multi pq: kernel 3 never launched: {STATS.by_kernel}")
    launches["adc_scan_topk_residual"] = count
    with plain_kernels():
        ref = store.search_batch(q_emb, MULTI_K)
    check_bits(res["got"], ref, "multi pq search_batch")
    out["pq"] = {"rows": MULTI_PQ_ROWS, "setup_s": setup_s, "pq_train_s":
                 store.build_seconds.get("pq_train"), "ms_per_query": pq_ms / BATCH,
                 "num_coarse": int(store._rpq.coarse.shape[0]), "vs_plain": "bit-identical",
                 "memory_bytes": store.memory_bytes()}
    del store, res, ref
    empty_cache(dev)

    # (c) the 1b model at (dp, tp) = (1, 1)
    cfg = dataclasses.replace(CONFIGS[GEN_CONFIG], kv_bits=8)
    t0 = time.perf_counter()
    params = init_params(seed, cfg, device=dev)
    init_s = time.perf_counter() - t0
    model_mesh = make_model_mesh(device=dev)
    shard = shard_params(params, model_mesh, cfg)
    g = torch.Generator().manual_seed(seed + 17)
    ids = torch.randint(0, cfg.vocab_size, (MULTI_BATCH, MULTI_PROMPT), generator=g).to(dev)
    mask = torch.ones_like(ids, dtype=torch.bool)
    mask[1, :MULTI_PROMPT // 4] = False  # a left-padded row
    sp = SamplingParams(max_new_tokens=MULTI_NEW_TOKENS, eos_id=-1, pad_id=0)
    gen = torch.Generator(device=dev)
    ref_tokens, ref_lengths = generate_tokens(params, cfg, ids, mask, gen, sp)
    sharded_generate_tokens(shard, cfg, ids, mask, gen, SamplingParams(max_new_tokens=2),
                            model_mesh)  # warm-up
    reset_counts()  # the main path: counts to 0 just before, read just after
    sync(dev)
    t0 = time.perf_counter()
    tokens, lengths = sharded_generate_tokens(shard, cfg, ids, mask, gen, sp, model_mesh)
    sync(dev)
    gen_ms = (time.perf_counter() - t0) * 1e3
    steps = MULTI_NEW_TOKENS - 1
    attn = decode_attention.STATS.by_kernel.get("decode_attention_int8", 0)
    if attn != ATTN_LAUNCHES_PER_STEP_1B * steps:
        raise AssertionError(f"multi: kernel 10 launched {attn} times in {steps} decode steps")
    launches["decode_attention_int8"] = attn
    if not (torch.equal(tokens, ref_tokens) and torch.equal(lengths, ref_lengths)):
        bad = int((tokens != ref_tokens).sum())
        raise AssertionError(f"multi: sharded greedy tokens differ from the unsharded at {bad}")
    # kernel 10 on the local cache against its plain version: the first decode step
    cache = init_cache(cfg, MULTI_BATCH, MULTI_PROMPT + 2, device=dev, mesh=model_mesh)
    logits, cache = prefill(shard, cfg, ids, cache, mask, mesh=model_mesh)
    token = torch.argmax(logits[:, -1], dim=-1)
    got, _ = decode_step(shard, cfg, token, clone_cache(cache), mesh=model_mesh)
    with plain_kernels():
        ref, _ = decode_step(shard, cfg, token, clone_cache(cache), mesh=model_mesh)
    rel = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
    if not rel <= GEN_LOGITS_RTOL:
        raise AssertionError(f"multi: first-step logits differ from the plain version by {rel}")
    del cache, logits, got, ref

    # one AdamW step on (1, 1) against the unsharded loss
    g = torch.Generator().manual_seed(seed + 18)
    t_ids = torch.randint(0, cfg.vocab_size, (MULTI_TRAIN_BATCH, MULTI_TRAIN_SEQ), generator=g)
    t_mask = torch.ones_like(t_ids, dtype=torch.bool)
    with torch.no_grad():
        ref_loss = float(masked_loss(forward(params, cfg, t_ids.to(dev), t_mask.to(dev)),
                                     t_ids.to(dev), t_mask.to(dev)))
    del params
    empty_cache(dev)
    opt = torch.optim.AdamW(param_leaves(shard), lr=1e-4)
    step = make_sharded_train_step(cfg, model_mesh, opt)
    b_ids, b_mask = shard_batch(t_ids, t_mask, model_mesh)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = float(step(shard, b_ids, b_mask))
    sync(dev)
    step_ms = (time.perf_counter() - t0) * 1e3
    if not abs(loss - ref_loss) <= MULTI_LOSS_RTOL * abs(ref_loss):
        raise AssertionError(f"multi: sharded loss {loss} against the unsharded {ref_loss}")
    out["model"] = {"config": GEN_CONFIG, "dtype": "bf16", "kv_bits": 8, "mesh": [1, 1],
                    "init_s": init_s, "batch": MULTI_BATCH, "prompt_tokens": MULTI_PROMPT,
                    "new_tokens": MULTI_NEW_TOKENS, "generate_ms": gen_ms,
                    "tokens_equal_unsharded": True,
                    "attn_launches_per_decode_step": attn / steps,
                    "first_step_logits_rel_l2_vs_plain": rel,
                    "train_tokens": MULTI_TRAIN_BATCH * MULTI_TRAIN_SEQ, "train_step_ms": step_ms,
                    "train_loss": loss, "unsharded_loss": ref_loss,
                    "train_peak_bytes": torch.cuda.max_memory_allocated()
                    if dev.type == "cuda" else None}
    del shard, opt, step
    empty_cache(dev)
    dist.destroy_process_group()
    out["main_path_launches"] = launches
    out["note"] = ("ms_per_query: CUDA events over 5 batches of search_batch; generate_ms and "
                   "train_step_ms: host clock around one call")
    ph.info.update(out)
    return launches


RANKS_ROWS, RANKS_ADD, RANKS_PQ_ROWS = 1 << 18, 4096, 1 << 17
RANKS_MODEL = {"vocab_size": 4096, "hidden_size": 1024, "num_layers": 4, "num_heads": 8,
               "num_kv_heads": 4, "intermediate_size": 2816, "max_seq_len": 1024, "kv_bits": 8}
RANKS_SGD_ATOL, RANKS_SGD_RTOL = 5e-5, 1e-4  # tests/test_sharding.py's single-device step


def phase_ranks(ph: Phase, dev, seed: int) -> dict:
    """The mesh path across every rank of the launch (``torchrun
    --nproc-per-node n chip_smoke.py --phases ranks``, after a ``build``
    call; not among the default phases): each rank builds the same inputs
    from the seed and holds its result against what it computes unsharded.
    (a) int8, bf16 and residual pq mesh stores at 262,144 × 384 (pq 131,072
    rows), batch 328, k 3: kernels 1, 2, 3 launched on every rank, ids
    against the plain shard body (pq: bit for bit against the plain
    versions), recall@3 against the fp32 exact top-3 beside the unsharded
    store's; a bf16 add across a regrow (rows move between ranks) against a
    fresh mesh store over the same rows, get_vectors against the host rows,
    save on rank 0 loaded unsharded. (b) an f32 model with hd 128 and
    kv_bits 8 on make_model_mesh(): greedy tokens equal to the unsharded
    model's, kernel 10 on each rank's cache, and one SGD step against the
    unsharded step (the loss, and this rank's lm_head columns)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from crs_tpu_torch.finetuning.trainer import masked_loss
    from crs_tpu_torch.models.sampling import SamplingParams, generate_tokens
    from crs_tpu_torch.models.sharding import (
        make_model_mesh, make_sharded_train_step, param_leaves, shard_batch, shard_params,
        sharded_generate_tokens,
    )
    from crs_tpu_torch.models.transformer import TransformerConfig, forward, init_params
    from crs_tpu_torch.ops import decode_attention
    from crs_tpu_torch.ops.scan import STATS
    from crs_tpu_torch.ops.topk import exact_topk
    from crs_tpu_torch.parallel import corpus_mesh
    from crs_tpu_torch.parallel.mesh import mesh_device
    from crs_tpu_torch.parallel.sharded_index import sharded_topk, sharded_topk_int8
    from crs_tpu_torch.rag import VectorStore

    mesh = corpus_mesh(device=dev)
    dev = mesh_device(mesh)
    world, rank = dist.get_world_size(), dist.get_rank()
    rng = np.random.default_rng(seed + 31)
    centers = rng.standard_normal((1024, DIM)).astype(np.float32)
    x = centers[rng.integers(0, 1024, RANKS_ROWS + RANKS_ADD)]
    x += 0.3 * rng.standard_normal(x.shape).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.choice(RANKS_ROWS, BATCH, replace=False)] + 0.05 * rng.standard_normal(
        (BATCH, DIM)).astype(np.float32)
    q = torch.nn.functional.normalize(torch.from_numpy(q), dim=1).to(dev)
    emb = torch.from_numpy(x).to(dev)
    texts = [f"d{i}" for i in range(x.shape[0])]
    out = {"world_size": world, "backend": dist.get_backend(), "device": str(dev)}

    def recall(ids, n) -> float:
        exact = exact_topk(emb[:n], q, 3, n)[1].cpu().tolist()
        return sum(len(set(g) & set(e)) for g, e in zip(ids.cpu().tolist(), exact)) / (3 * BATCH)

    launches = {}
    for fmt, cfg, kernel, rows in (("int8", BENCH_STORE, "int8_scan_topk", RANKS_ROWS),
                                   ("bf16", MULTI_STORES["bf16"], "scan_topk_bf16", RANKS_ROWS),
                                   ("pq", MULTI_PQ_STORE, "adc_scan_topk_residual",
                                    RANKS_PQ_ROWS)):
        store = VectorStore(cfg, device=dev, mesh=mesh)
        store.create_index(texts[:rows], emb[:rows])
        reset_counts()
        got = store.search_batch(q, 3)
        launches[kernel] = STATS.by_kernel.get(kernel, 0)
        if launches[kernel] != 1:
            raise AssertionError(f"ranks {fmt}: rank {rank} launched {STATS.by_kernel}")
        if fmt == "pq":
            with plain_kernels():
                check_bits(got, store.search_batch(q, 3), "ranks pq")
        elif fmt == "int8":
            check_float_ranked(got, sharded_topk_int8(store._codes, store._scales, q, 3, rows,
                                                      mesh, rescore_k=store.rescore_k,
                                                      block_size=1 << 30), ID_RTOL, 1)
        else:
            check_float_ranked(got, sharded_topk(store._vectors, q, 3, rows, mesh,
                                                 block_size=1 << 30), FLOAT_RTOL[fmt], 1)
        single = VectorStore(cfg, device=dev)
        single.create_index(texts[:rows], emb[:rows])
        out[fmt] = {"local_rows": store._padded_rows() // world,
                    "recall_at_3": recall(got[1], rows),
                    "unsharded_recall_at_3": recall(single.search_batch(q, 3)[1], rows)}
        # each shard rescores its own rescore_k candidates (S times as many in all), so
        # the mesh store's recall may rise above the unsharded store's, never fall
        if out[fmt]["recall_at_3"] < out[fmt]["unsharded_recall_at_3"] - 0.01:
            raise AssertionError(f"ranks {fmt}: recall {out[fmt]}")
        if fmt == "bf16":  # add across a regrow, gathers, save on rank 0
            before = store._padded_rows()
            store.add(texts[rows:], emb[rows:])
            fresh = VectorStore(cfg, device=dev, mesh=mesh)
            fresh.create_index(texts, emb)
            check_float_ranked(store.search_batch(q, 3), fresh.search_batch(q, 3),
                               FLOAT_RTOL[fmt], 1)
            picks = np.array([0, rows // 2, rows - 1, rows, x.shape[0] - 1])
            want = torch.from_numpy(x[picks]).to(torch.bfloat16).float().numpy()
            if not np.array_equal(store.get_vectors(picks), want):
                raise AssertionError("ranks: get_vectors differs from the host rows")
            tmp = [tempfile.mkdtemp(prefix="ranks_") if rank == 0 else None]
            dist.broadcast_object_list(tmp, src=0)
            store.save(tmp[0])
            loaded = VectorStore(cfg, device=dev)
            loaded.load(tmp[0])
            check_float_ranked(loaded.search_batch(q, 3), fresh.search_batch(q, 3),
                               FLOAT_RTOL[fmt], 1)
            dist.barrier()
            if rank == 0:
                shutil.rmtree(tmp[0], ignore_errors=True)
            out[fmt].update(padded_before=before, padded_after=store._padded_rows())
        del store, single
        empty_cache(dev)

    # (b) the dp × tp model
    mm = make_model_mesh(device=dev)
    cfg = TransformerConfig(**RANKS_MODEL, dtype=torch.float32)
    params = init_params(seed, cfg, device=dev)
    shard = shard_params(params, mm, cfg)
    g = torch.Generator().manual_seed(seed + 32)
    ids = torch.randint(0, cfg.vocab_size, (8, 48), generator=g).to(dev)
    mask = torch.ones_like(ids, dtype=torch.bool)
    mask[3, :10] = False
    sp = SamplingParams(max_new_tokens=16, eos_id=-1, pad_id=0)
    gen = torch.Generator(device=dev)
    ref = generate_tokens(params, cfg, ids, mask, gen, sp)
    reset_counts()
    got = sharded_generate_tokens(shard, cfg, ids, mask, gen, sp, mm)
    attn = decode_attention.STATS.by_kernel.get("decode_attention_int8", 0)
    launches["decode_attention_int8"] = attn
    if attn != cfg.num_layers * (sp.max_new_tokens - 1):
        raise AssertionError(f"ranks: kernel 10 launched {attn} times on rank {rank}")
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError(f"ranks: sharded tokens differ on rank {rank}")
    t_ids = torch.randint(0, cfg.vocab_size, (8, 64), generator=g).to(dev)
    t_mask = torch.ones_like(t_ids, dtype=torch.bool)
    lm = params["lm_head"].clone().requires_grad_(True)
    full = dict(params, lm_head=lm)
    for p in param_leaves(full):
        p.requires_grad_(True)
    loss_t = masked_loss(forward(full, cfg, t_ids, t_mask), t_ids, t_mask)
    loss_t.backward()
    ref_loss = loss_t.item()
    step = make_sharded_train_step(cfg, mm, torch.optim.SGD(param_leaves(shard), lr=1e-2))
    loss = float(step(shard, *shard_batch(t_ids, t_mask, mm)))
    cols = shard["lm_head"].shape[1]
    tp_rank = mm.get_local_rank("tp")
    want = (lm - 1e-2 * lm.grad).detach()[:, tp_rank * cols:(tp_rank + 1) * cols]
    diff = (shard["lm_head"].detach() - want).abs()
    if not (abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
            and bool((diff <= RANKS_SGD_ATOL + RANKS_SGD_RTOL * want.abs()).all())):
        raise AssertionError(f"ranks: SGD step loss {loss} / {ref_loss}, "
                             f"lm_head diff {float(diff.max())}")
    out["model"] = {"mesh": [mm.size(0), mm.size(1)], "tokens_equal_unsharded": True,
                    "attn_launches": attn, "sgd_loss": loss, "unsharded_loss": ref_loss,
                    "lm_head_max_abs_diff": float(diff.max())}
    out["launches"] = launches
    dist.barrier()
    dist.destroy_process_group()
    ph.info.update(out, rank=rank)
    return out


def kernel_table(res: dict) -> list:
    """The kernel line: every ported kernel with its launches on its main
    path and its numbers from this run."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_composition_ms")
    flt, adc, launches = res["kernel_f32_bf16"], res["kernel_adc"], res["formats"]
    rows = [res["full"], {
        "name": "scan_topk_f32_bf16", "route": "cuda",
        "source": "crs_tpu_torch/csrc/scan_topk_f32_bf16.cu",
        "replaces": "crs_tpu/ops/pallas_scan.py:144",
        "launches": launches["fp32"] + launches["bf16"],
        "max_abs_err": max(flt["fp32"]["max_abs_err"], flt["bf16"]["max_abs_err"]),
        **{k: flt["fp32"][k] for k in keys}, "library_ms": None,
        "by_dtype": {dt: {"launches": launches[dt], **{k: flt[dt][k] for k in keys}}
                     for dt in ("fp32", "bf16")},
    }]
    srt, seg = res["kernel_sorted_adc"], res["kernel_segmax"]
    for name, fmt, line in (("residual", "pq", 674), ("sorted", "pq_sorted", 608),
                            ("plain", "pq_plain", 521)):
        row = adc if name != "sorted" else {"sorted": srt}
        rows.append({
            "name": f"adc_scan_topk_{name}", "route": "cuda",
            "source": "crs_tpu_torch/csrc/pq_adc_scan_topk.cu",
            "replaces": f"crs_tpu/ops/pallas_scan.py:{line}", "launches": launches[fmt],
            "max_abs_err": row[name]["max_abs_err"], **{k: row[name][k] for k in keys},
            "library_ms": None})
    rows[-2]["unsorted_kernel_ms_same_rows"] = srt["unsorted_ms"]
    seg_launches = seg["main_path_launches"]
    rows.append({
        "name": "segmax_scan_topk_f32_bf16", "route": "cuda",
        "source": "crs_tpu_torch/csrc/segmax_scan_topk.cu",
        "replaces": "crs_tpu/ops/pallas_scan.py:453",
        "launches": seg_launches["segmax_scan_topk_f32"] + seg_launches["segmax_scan_topk_bf16"],
        "max_abs_err": max(seg["fp32"]["max_abs_err"], seg["bf16"]["max_abs_err"]),
        **{k: seg["fp32"][k] for k in keys}, "library_ms": None,
        "by_dtype": {dt: {"launches": seg_launches[kname], **{k: seg[dt][k] for k in keys}}
                     for dt, kname in (("fp32", "segmax_scan_topk_f32"),
                                       ("bf16", "segmax_scan_topk_bf16"))},
    })
    rows.append({
        "name": "segmax_scan_topk_int8", "route": "cuda",
        "source": "crs_tpu_torch/csrc/segmax_scan_topk.cu",
        "replaces": "crs_tpu/ops/pallas_scan.py:489",
        "launches": seg_launches["segmax_scan_topk_int8"], "max_abs_err": seg["int8"]["max_abs_err"],
        **{k: seg["int8"][k] for k in keys}, "library_ms": None,
        "int_mm_composition_ms": seg["int8"]["int_mm_composition_ms"]})
    gen, q4, attn = res["generate"], res["kernel_q4"], res["kernel_decode_attn"]
    evaluated = res["evaluate"]["runner"]["main_path_launches"]  # the evaluation's path
    ft = res["finetune"]  # the finetune path: training, the gradient check, the adapted decode
    tuned = {k: ft["train"]["main_path_launches"].get(k, 0)
             + ft["decode"]["main_path_launches"].get(k, 0)
             for k in ("q4_matmul", "nf4_matmul", "decode_attention_int8")}
    for name, kind, line in (("q4_matmul", "int4", 105), ("nf4_matmul", "nf4", 161)):
        tuned[name] += ft["grad_check"][kind]["launches"]
        rows.append({
            "name": name, "route": "cuda", "source": "crs_tpu_torch/csrc/q4_matmul.cu",
            "replaces": f"crs_tpu/ops/qgemm.py:{line}",
            "launches": gen["main_path_launches"][kind],
            "launches_evaluate": evaluated.get(name, 0), "launches_finetune": tuned[name],
            "max_abs_err": q4[kind]["max_abs_err"], **{k: q4[kind][k] for k in keys},
            "library_ms": None})
    lib8 = res["gemv"]["q4_library"]  # row 8's one call, at the chain tool's q4 layer
    rows[-2].update(library_ms=lib8["library_ms"], library_shape=lib8["shape"],
                    ms_at_library_shape=lib8["ms"],
                    library_note=lib8.get("library_note", lib8.get("library_call")))
    rows.append({
        "name": "decode_attention_int8", "route": "cuda",
        "source": "crs_tpu_torch/csrc/decode_attention_int8.cu",
        "replaces": "crs_tpu/ops/decode_attention.py:69",
        "launches": gen["main_path_launches"]["attn"],
        "launches_evaluate": evaluated.get("decode_attention_int8", 0),
        "launches_finetune": tuned["decode_attention_int8"],
        "max_abs_err": attn["max_abs_err"], **{k: attn[k] for k in keys}, "library_ms": None})
    mlp = res["kernel_fused_mlp"]
    rows.append({
        "name": "fused_mlp_int8", "route": "cuda",
        "source": "crs_tpu_torch/csrc/fused_mlp_int8.cu",
        "replaces": "crs_tpu/ops/fused_mlp.py:74",
        "launches": res["generate_7b"]["main_path_launches"], "max_abs_err": mlp["max_abs_err"],
        **{k: mlp[k] for k in keys}, "library_ms": None})
    gemv = res["gemv"]  # the weight-streaming tools' path (CUDA graphs: captured × replays)
    q4p = gemv["q4_probe_matmul"][f"i32 R={GEMV_Q4_TOOL['r']} K={GEMV_Q4_TOOL['k']} "
                                  f"N={GEMV_Q4_TOOL['n']} g={GEMV_Q4_TOOL['g']}"]
    q8, db = gemv["q8_gemv"]["R=8 d=2048"], gemv["db_gemv"]["R=8 d=2048"]
    for name, line, row, comp in (
            ("q4_probe_matmul", "tools/bench_q4_kernel.py:36", q4p,
             gemv["q4_probe_library_composition_ms"]),
            ("q8_gemv", "tools/bench_chain_gemv.py:152", q8, q8["library_composition_ms"]),
            ("db_gemv", "tools/bench_chain_gemv.py:209", db, db["library_composition_ms"])):
        rows.append({
            "name": name, "route": "cuda", "source": "crs_tpu_torch/csrc/gemv_probe.cu",
            "replaces": line, "launches": gemv["main_path_launches"][name],
            "max_abs_err": max(v["max_abs_err"] for v in gemv[name].values()),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_composition_ms": comp, "library_ms": row.get("library_ms"),
            "library_note": row.get("library_note", row.get("library_call"))})
    rows[-3]["by_variant_ms"] = {k.split()[0]: v["ms"] for k, v in gemv["q4_probe_matmul"].items()
                                 if "ms" in v}
    for row in rows:  # kernel 8 on the chain tool's q4 variant
        if row["name"] == "q4_matmul":
            row["launches_gemv_tools"] = gemv["main_path_launches"]["q4_matmul"]
    multi = res["multi"]  # the mesh path's launches (kernels 1, 2, 3 and 10; 0 elsewhere)
    tools = res["tools"]["main_path_launches"]  # the serving and scale tools' path
    quality = res["quality"]["main_path_launches"]  # the recall curve's and quality tools' path
    for row in rows:
        row["launches_multi"] = multi.get(MULTI_LAUNCH_KEY.get(row["name"], ""), 0)
        row["launches_tools"] = tools.get(TOOLS_LAUNCH_KEY.get(row["name"], ""), 0)
        row["launches_quality"] = quality.get(TOOLS_LAUNCH_KEY.get(row["name"], ""), 0)
    return rows


ALL_PHASES = ("build", "kernel", "kernel_f32_bf16", "kernel_adc", "kernel_sorted_adc",
              "kernel_segmax", "kernel_q4", "kernel_decode_attn", "kernel_fused_mlp", "gemv",
              "tools", "quality", "faults", "bench", "full", "formats", "add", "multi", "generate",
              "evaluate", "finetune", "rag", "lexical", "minilm", "cli", "generate_7b",
              "calibrated")
# selectable with --phases, not run by default: the mesh path across every rank of a
# torchrun launch (after a separate build call)
EXTRA_PHASES = ("ranks",)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of the phases, for development runs; the "
                         "kernel table and the last line need all of them")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(ALL_PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from crs_tpu_torch import resolve_device

    dev = resolve_device("cuda")
    # plain versions and yardsticks in full f32, bf16 products summed in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_start = time.perf_counter()
    res = {}
    shared = {}
    steps = {
        "build": lambda ph: phase_build(ph),
        "kernel": lambda ph: phase_kernel(ph, dev, args.seed, FULL_ROWS, res.get("build") or {}),
        "kernel_f32_bf16": lambda ph: phase_kernel_f32_bf16(ph, dev, args.seed, FULL_ROWS,
                                                            res.get("build") or {}),
        "kernel_adc": lambda ph: phase_kernel_adc(ph, dev, args.seed, FULL_ROWS,
                                                  res.get("build") or {}),
        "kernel_sorted_adc": lambda ph: phase_kernel_sorted_adc(ph, dev, args.seed, FULL_ROWS),
        "kernel_segmax": lambda ph: phase_kernel_segmax(ph, dev, args.seed, FULL_ROWS,
                                                        res.get("build") or {}),
        "kernel_q4": lambda ph: phase_kernel_q4(ph, dev, args.seed),
        "kernel_decode_attn": lambda ph: phase_kernel_decode_attn(ph, dev, args.seed),
        "kernel_fused_mlp": lambda ph: phase_kernel_fused_mlp(ph, dev, args.seed),
        "gemv": lambda ph: phase_gemv(ph, dev, args.seed),
        "tools": lambda ph: phase_tools(ph, dev, args.seed),
        "quality": lambda ph: phase_quality(ph, dev, args.seed),
        "faults": lambda ph: phase_faults(ph, dev, args.seed),
        "bench": lambda ph: phase_bench(ph, dev),
        "full": lambda ph: phase_full(ph, dev, args.seed, FULL_ROWS,
                                      (res.get("kernel") or {}).get("max_abs_err", 0.0),
                                      shared),
        "formats": lambda ph: phase_formats(ph, dev, shared),
        "add": lambda ph: phase_add(ph, dev, args.seed, shared),
        "multi": lambda ph: phase_multi(ph, dev, args.seed, shared),
        "generate": lambda ph: phase_generate(ph, dev, args.seed, shared),
        "evaluate": lambda ph: phase_evaluate(ph, dev, args.seed, shared),
        "finetune": lambda ph: phase_finetune(ph, dev, args.seed),
        "rag": lambda ph: phase_rag(ph, dev, args.seed, shared),
        "lexical": lambda ph: phase_lexical(ph, dev, args.seed, shared),
        "minilm": lambda ph: phase_minilm(ph, dev, args.seed),
        "cli": lambda ph: phase_cli(ph, dev, shared),
        "generate_7b": lambda ph: phase_generate_7b(ph, dev, args.seed),
        "calibrated": lambda ph: phase_calibrated(ph, dev, args.seed),
        "ranks": lambda ph: phase_ranks(ph, dev, args.seed),
    }
    try:
        for name in ALL_PHASES + EXTRA_PHASES:
            if name in phases:
                with Phase(name) as ph:
                    res[name] = steps[name](ph)
    finally:  # the lexical phase's index, when the cli phase did not remove it
        if "lexical_dir" in shared:
            import shutil

            shutil.rmtree(shared.pop("lexical_dir"), ignore_errors=True)
    emit({"phase": "total", "seconds": round(time.perf_counter() - t_start, 3)})
    if set(phases) != set(ALL_PHASES):
        print("chip_smoke: a subset of the phases ran; no kernel table, no result",
              file=sys.stderr)
        return 2
    emit({"kernels": kernel_table(res)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
