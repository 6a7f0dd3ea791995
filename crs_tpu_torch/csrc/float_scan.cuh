// The scoring passes the float scans share (scan_topk_f32_bf16.cu, kernel 2;
// segmax_scan_topk.cu, kernel 6): one CTA scores one corpus block against
// two query tiles (128 queries) chunk by chunk, CHUNK = 256 rows at a time,
// and hands each finished chunk's f32 scores to the kernel's epilogue (a
// running top-kb, or segment maxima). The grid is one dimension with the
// query pair varying fastest: the CTAs that share a corpus block are
// adjacent in launch order, start together and walk its rows in the same
// order, so the first to touch a slice pulls it into L2 and the others find
// it there (one corpus pass per launch).
//
// F32: FFMA with an 8 × 8 register tile per thread. A CTA of 512 threads
// (16 warps, 8 queries each) stages rows and queries in KC = 32-dimension
// slices, transposed on the way in by 4-byte cp.async into [dim][row] and
// [dim][query] with strides ≡ 4 (mod 32) floats (conflict-free); lane l
// holds rows 4l..4l+3 and 128+4l..128+4l+3 of the chunk, and per dimension
// reads them with two LDS.128 and its warp's 8 queries with two broadcasts,
// for 64 FFMA. Two stages: slice t+1's copies go out in two pieces between
// slice t's FMAs. A ragged last slice (D not a multiple of 32) is
// zero-filled by the copies (src-size 0; the RAGGED instantiation), and a
// zero adds nothing to an f32 sum, so any D is taken.
//
// BF16: wgmma m64n256k16 on a TMA-fed ring. A CTA of 384 threads has two
// consumer warpgroups of 64 queries each and a producer warpgroup, one
// thread of which starts every copy; setmaxnreg moves the producer's
// registers to the consumers (232 each instead of the 168 that 12 warps
// get). The queries are the A operand (M = 64 per warpgroup), the corpus
// rows the B operand (N = 256, one chunk), both K-major in shared memory
// with 128-byte swizzle, fed by TMA in 64-dimension slices. When the 128
// queries fit whole beside a 3-stage ring they are loaded once per CTA and
// only the corpus streams; otherwise both stream through a ring of 4
// stages (fewer when the epilogue's room needs it). Full / empty mbarriers
// guard each stage. TMA zero-fills past D (a ragged last slice; D must be a
// multiple of 8, the 16-byte row stride TMA needs) and past the last query
// tile. A consumer thread's accumulators hold, for query rows qa and qa + 8
// of the CTA, columns 8j + 2t + {0, 1} of the chunk (t = lane % 4) in
// acc[4j + 2r + e]: a quad of threads holds a query row's 256 columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_async.cuh"

namespace fscan {

using namespace sm90;

constexpr int CHUNK = 256;       // corpus rows per step
constexpr int HALF = CHUNK / 2;  // the fp32 row layout's two halves
constexpr int QUERY_TILE = 64;   // queries per tile of the partials
constexpr int TILE_Q = 128;      // queries per CTA (two tiles)
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory one CTA may use

// ---- F32: FFMA, 8 queries × 8 rows per thread ----------------------------------

constexpr int F_THREADS = 512;                        // 16 warps, 8 queries each
constexpr int F_KC = 32;                              // dimensions per slice
constexpr int F_ROW_STRIDE = CHUNK + 4;               // floats per staged dimension (rows)
constexpr int F_Q_STRIDE = TILE_Q + 4;                // floats per staged dimension (queries)
constexpr int F_STAGE_FLOATS = F_KC * (F_ROW_STRIDE + F_Q_STRIDE);
constexpr int F_STAGES = 2;
constexpr int F_PIPE_FLOATS = F_STAGES * F_STAGE_FLOATS;  // the staging's shared memory
constexpr int F_PARTS = 2;                            // pieces of the next slice's copies
constexpr int F_RPR = F_THREADS / 32;                 // rows per copy round
constexpr int F_ROW_ROUNDS = CHUNK / F_RPR;           // 16
constexpr int F_Q_ROUNDS = TILE_Q / F_RPR;            // 8

// The chunk row of acc[.][j] for lane `lane`.
__device__ __forceinline__ int f32_row(int lane, int j) {
    return (j < 4 ? 0 : HALF - 4) + 4 * lane + j;
}

// Scores corpus block `blk` against the CTA's query pair, staging through
// fsmem[0, F_PIPE_FLOATS). After chunk c, epi(c, acc) gets this thread's
// scores: acc[i][j] = q(8·warp + i of the pair) · row(c·CHUNK + f32_row(lane, j));
// they are zeroed after it. RAGGED: d need not be a multiple of F_KC, nor
// block_size of CHUNK (the copies then carry a zero-fill predicate, which
// costs a few % at D 384: dimensions past d and rows past the corpus's n
// read as 0; a last half chunk's rows past the block are the next block's,
// which the epilogue drops). Called by all F_THREADS threads.
template <bool RAGGED, class Epi>
__device__ __forceinline__ void f32_scores(const float* __restrict__ q,     // [nq·QUERY_TILE, d]
                                           const float* __restrict__ vecs,  // [n, d]
                                           float* fsmem, int nq, int pair, int blk,
                                           int block_size, int d, long long n, Epi&& epi) {
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nk = (d + F_KC - 1) / F_KC;
    const int nslices = ((block_size + CHUNK - 1) / CHUNK) * nk;
    const float* vb = vecs + (long long)blk * block_size * d;

    // Copy i of this thread moves element (row crow + 16i, dimension cdim) of
    // the slice: a warp reads 4 rows × 32 bytes (whole sectors) and writes
    // them dimension-major, [dim][row]; with a stride ≡ 4 (mod 32) floats its
    // 32 stores land in 32 distinct banks. Dimensions past d are zero-filled.
    const int cdim = 8 * (warp & 3) + (lane & 7);
    const int crow = 4 * (warp >> 2) + (lane >> 3);
    const float* qsrc = q + ((long long)pair * TILE_Q + crow) * d;
    // with an odd tile count the last pair has one tile: its second half
    // re-reads the first (never emitted)
    const int qvalid = (int)min((long long)TILE_Q,
                                (long long)nq * QUERY_TILE - (long long)pair * TILE_Q);
    auto copy_part = [&](int t, int part) {  // slice t → stage t % 2, piece `part`
        if (t < nslices) {
            float* st = fsmem + (t % F_STAGES) * F_STAGE_FLOATS;
            const int dim = (t % nk) * F_KC + cdim;
            const bool ok = !RAGGED || dim < d;
            const int off = ok ? dim : 0;
            const float* rows = vb + ((long long)(t / nk) * CHUNK + crow) * d + off;
            auto copy = [&](float* dst, const float* src, bool valid) {
                if (RAGGED)
                    cp_async4_or_zero(dst, valid ? src : vecs, valid);
                else
                    cp_async4(dst, src);
            };
            // rows of this chunk inside the corpus (RAGGED)
            const long long live =
                n - (long long)blk * block_size - (long long)(t / nk) * CHUNK - crow;
#pragma unroll
            for (int i = part * (F_ROW_ROUNDS / F_PARTS);
                 i < (part + 1) * (F_ROW_ROUNDS / F_PARTS); ++i)
                copy(st + cdim * F_ROW_STRIDE + crow + F_RPR * i, rows + (long long)(F_RPR * i) * d,
                     ok && F_RPR * i < live);
            float* sq = st + F_KC * F_ROW_STRIDE;
#pragma unroll
            for (int i = part * (F_Q_ROUNDS / F_PARTS); i < (part + 1) * (F_Q_ROUNDS / F_PARTS);
                 ++i) {
                const int r = crow + F_RPR * i;
                copy(sq + cdim * F_Q_STRIDE + r,
                     qsrc + (long long)(r < qvalid ? F_RPR * i : F_RPR * i - QUERY_TILE) * d + off,
                     ok);
            }
        }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
    for (int part = 0; part < F_PARTS; ++part) copy_part(0, part);
    cp_async_commit();
    for (int t = 0; t < nslices; ++t) {
        cp_async_wait<0>();
        __syncthreads();  // slice t has landed, and every warp is done with slice t - 1
        // per dimension: this lane's rows 4l..4l+3 and 128+4l..128+4l+3 (two
        // conflict-free LDS.128) and the warp's queries 8w..8w+7 (two
        // broadcasts); slice t + 1's copies go out in F_PARTS pieces between
        const float* rs = fsmem + (t % F_STAGES) * F_STAGE_FLOATS + 4 * lane;
        const float* qs = fsmem + (t % F_STAGES) * F_STAGE_FLOATS + F_KC * F_ROW_STRIDE + 8 * warp;
#pragma unroll
        for (int part = 0; part < F_PARTS; ++part) {
            copy_part(t + 1, part);
#pragma unroll
            for (int k = part * (F_KC / F_PARTS); k < (part + 1) * (F_KC / F_PARTS); ++k) {
                const float4 b0 = *reinterpret_cast<const float4*>(rs + k * F_ROW_STRIDE);
                const float4 b1 = *reinterpret_cast<const float4*>(rs + k * F_ROW_STRIDE + HALF);
                const float4 a0 = *reinterpret_cast<const float4*>(qs + k * F_Q_STRIDE);
                const float4 a1 = *reinterpret_cast<const float4*>(qs + k * F_Q_STRIDE + 4);
                const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
                const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            }
        }
        cp_async_commit();
        if (t % nk != nk - 1) continue;
        epi(t / nk, acc);  // the chunk is scored
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
}

// ---- BF16: wgmma m64n256k16 on a TMA-fed ring ----------------------------------

constexpr int B_CONSUMERS = 2;                         // warpgroups, 64 queries each
constexpr int B_THREADS = (B_CONSUMERS + 1) * 128;     // + one producer warpgroup
// registers per thread after setmaxnreg: the producer gives up what the
// consumers' accumulators and epilogues take (128·40 + 256·232 ≤ 65,536)
constexpr int B_PRODUCER_REGS = 40;
constexpr int B_CONSUMER_REGS = 232;
constexpr int B_BK = 64;                               // dimensions per slice (128 bytes)
constexpr int B_A_BYTES = TILE_Q * B_BK * 2;           // 16 KB: the queries' slice
constexpr int B_B_BYTES = CHUNK * B_BK * 2;            // 32 KB: the chunk's slice
constexpr int B_STAGES_RESIDENT = 3;                   // corpus-only stages
constexpr int B_STAGES_STREAM = 4;                     // queries + corpus stages, at most

// Offsets from the 1024-byte-aligned base of the dynamic shared memory: the
// resident queries, the ring, the epilogue's `extra` bytes, the barriers.
struct RingLayout {
    int stages, a_bytes, stage_bytes, ring, extra, bars, total;
};

// nk: the slices of one row (the int8 pass, csrc/int8_scan.cuh, takes the
// same layout: its 128-dimension slices are 128 bytes too)
__host__ __device__ inline RingLayout ring_layout_as(int nk, int extra_bytes, bool resident,
                                                     int stages) {
    RingLayout L;
    L.stages = stages;
    L.a_bytes = resident ? nk * B_A_BYTES : 0;
    L.stage_bytes = resident ? B_B_BYTES : B_A_BYTES + B_B_BYTES;
    L.ring = L.a_bytes;
    L.extra = L.ring + L.stages * L.stage_bytes;
    L.bars = L.extra + (extra_bytes + 7) / 8 * 8;
    L.total = L.bars + (2 * L.stages + 1) * 8;
    return L;
}

__host__ __device__ inline int ring_bytes(const RingLayout& L) { return 1024 + L.total; }

// The queries resident beside a 3-stage ring when they fit; else both
// streamed, through as many stages (4, 3, 2) as fit beside the extra bytes.
__host__ __device__ inline RingLayout ring_layout_k(int nk, int extra_bytes) {
    RingLayout L = ring_layout_as(nk, extra_bytes, true, B_STAGES_RESIDENT);
    if (ring_bytes(L) <= SMEM_LIMIT) return L;
    for (int s = B_STAGES_STREAM; s > 2; --s) {
        L = ring_layout_as(nk, extra_bytes, false, s);
        if (ring_bytes(L) <= SMEM_LIMIT) return L;
    }
    return ring_layout_as(nk, extra_bytes, false, 2);
}

__host__ __device__ inline RingLayout ring_layout(int d, int extra_bytes) {
    return ring_layout_k((d + B_BK - 1) / B_BK, extra_bytes);
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
    return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                            ~(uintptr_t)1023);
}

// Scores corpus block `blk` against the CTA's query pair through the ring at
// `smem` (aligned_smem, layout L, RESIDENT = L.a_bytes > 0). The producer
// warpgroup returns false once it has started every copy; each consumer
// thread calls epi(c, acc, wg, t, qa) after chunk c (query rows qa and qa + 8
// of the CTA, columns 8j + 2t + e in acc[4j + 2r + e]) and returns true.
// Called by all B_THREADS threads.
template <bool RESIDENT, class Epi>
__device__ __forceinline__ bool bf16_scores(const CUtensorMap* tm_q,  // [nq·64, d], box 64 × 128
                                            const CUtensorMap* tm_v,  // [N, d], box 64 × 256
                                            unsigned char* smem, const RingLayout& L, int pair,
                                            int blk, int block_size, int d, Epi&& epi) {
    const uint32_t base = smem_u32(smem);
    const uint32_t full0 = base + L.bars;            // full[s] = full0 + 8s
    const uint32_t empty0 = full0 + 8 * L.stages;    // empty[s]
    const uint32_t qbar = empty0 + 8 * L.stages;     // the resident queries
    const int nk = (d + B_BK - 1) / B_BK;
    const int nchunks = (block_size + CHUNK - 1) / CHUNK;  // TMA zero-fills rows past n
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;

    if (tid == 0) {
        for (int s = 0; s < L.stages; ++s) {
            mbar_init(full0 + 8 * s, 1);                // the producer's arrive + the bytes
            mbar_init(empty0 + 8 * s, B_CONSUMERS);     // one arrive per consumer warpgroup
        }
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp >= B_CONSUMERS * 4) {  // the producer warpgroup: one thread starts every copy
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(B_PRODUCER_REGS));
        if (warp == B_CONSUMERS * 4 && lane == 0) {
            const int qrow = pair * TILE_Q;
            if (RESIDENT) {
                mbar_expect_tx(qbar, (uint32_t)(nk * B_A_BYTES));
                for (int ks = 0; ks < nk; ++ks)
                    tma_load_2d(base + ks * B_A_BYTES, tm_q, ks * B_BK, qrow, qbar);
            }
            int stage = 0;
            uint32_t phase = 0;
            for (int c = 0; c < nchunks; ++c) {
                const int row0 = blk * block_size + c * CHUNK;
                for (int ks = 0; ks < nk; ++ks) {
                    mbar_wait(empty0 + 8 * stage, phase ^ 1);
                    const uint32_t st = base + L.ring + stage * L.stage_bytes;
                    const uint32_t fb = full0 + 8 * stage;
                    mbar_expect_tx(fb, (uint32_t)L.stage_bytes);
                    if (!RESIDENT) tma_load_2d(st, tm_q, ks * B_BK, qrow, fb);
                    tma_load_2d(st + (RESIDENT ? 0 : B_A_BYTES), tm_v, ks * B_BK, row0, fb);
                    if (++stage == L.stages) {
                        stage = 0;
                        phase ^= 1;
                    }
                }
            }
        }
        return false;
    }

    // consumer warpgroup wg: queries 64·wg .. 64·wg + 63 of the CTA's 128
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(B_CONSUMER_REGS));
    const int wg = warp >> 2;
    const int t = lane & 3;
    const int qa = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // rows qa and qa + 8
    const bool lead = (tid & 127) == 0;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    if (RESIDENT) {
        mbar_wait(qbar, 0);
        __syncwarp();
    }
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int c = 0; c < nchunks; ++c) {
        fence_acc(acc);
        for (int ks = 0; ks < nk; ++ks) {
            mbar_wait(full0 + 8 * stage, phase);
            __syncwarp();
            const uint32_t st = base + L.ring + stage * L.stage_bytes;
            const uint32_t a = (RESIDENT ? base + ks * B_A_BYTES : st) + wg * (B_A_BYTES / 2);
            const uint32_t b = st + (RESIDENT ? 0 : B_A_BYTES);
            const uint64_t da = sw128_desc(a), db = sw128_desc(b);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < B_BK / 16; ++kk)
                wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk, (ks | kk) != 0);
            wgmma_commit();
            if (ks > 0) {  // the previous slice's products are done: free its stage
                wgmma_wait<1>();
                if (lead) mbar_arrive(empty0 + 8 * prev);
            }
            prev = stage;
            if (++stage == L.stages) {
                stage = 0;
                phase ^= 1;
            }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (lead) mbar_arrive(empty0 + 8 * prev);
        epi(c, acc, wg, t, qa);
    }
    return true;
}

}  // namespace fscan
