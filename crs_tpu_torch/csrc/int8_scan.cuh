// The scoring pass the int8 scans share (int8_scan_topk.cu, kernel 1;
// segmax_scan_topk.cu, kernel 7), as csrc/float_scan.cuh is for the float
// scans: one CTA scores a run of corpus rows against two query tiles (128
// queries) one CHUNK = 256-row chunk at a time, on the int8 tensor cores,
// and hands each finished chunk's int32 dots to the kernel's epilogue (a
// running top-kb, or segment maxima). The grid is one dimension with the
// query pair varying fastest: the CTAs that share corpus rows are adjacent
// in launch order, start together and walk the rows in the same order, so
// the first to touch a slice pulls it into L2 and the others find it there
// (one corpus pass from device memory per launch).
//
// wgmma m64n256k32 s8 · s8 → s32 on a ring of stages. A CTA of 384 threads
// has two consumer warpgroups of 64 queries each and a producer warpgroup;
// setmaxnreg moves the producer's registers to the consumers (232 each). The
// queries are the A operand (M = 64 per warpgroup), the corpus rows the B
// operand (N = 256, one chunk), both K-major in shared memory with 128-byte
// swizzle: one 128-dimension slice of a row is one 128-byte line. When the
// 128 queries fit whole beside a 3-stage ring they are loaded once per CTA
// and only the corpus streams; otherwise both stream through a ring of up
// to 4 stages (fscan::ring_layout_k: the slices have bf16's byte sizes).
// Full / empty mbarriers guard each stage. The queries arrive zero-padded to
// a multiple of 16 dimensions (their wrapper pads [B, D], never the corpus)
// and TMA zero-fills past that and past the last query tile, so a dimension
// past D multiplies a zero query byte whatever the corpus holds there: the
// int32 dots are exact for any D.
//
// The corpus, two routes:
//   TMA (D % 16 == 0, the 16-byte row stride TMA needs): one thread of the
//     producer starts every copy, a [256 rows × 128 bytes] box per stage.
//   RAGGED (any other D): rows start at any byte, so the producer warpgroup
//     stages each row slice's 33 aligned 4-byte words by cp.async (words past
//     the corpus's last byte read as 0, a word across it reads only its
//     bytes inside), then every producer thread shifts its words into place
//     (funnel shift by the slice's byte offset mod 4), stores them to the
//     swizzled line, fences the generic proxy for wgmma and the stage is
//     released by one arrive. One staging buffer: a stage's copies wait for
//     the previous stage's shifts. The corpus is read as it is: no padded
//     copy, whatever D.
//
// A consumer thread's accumulators hold, for query rows qa and qa + 8 of the
// CTA, columns 8j + 2t + {0, 1} of the chunk (t = lane % 4) in
// acc[4j + 2r + e]: a quad of threads holds a query row's 256 columns. The
// int32 sums are exact up to D = 133,143 (127² per product).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "float_scan.cuh"
#include "sm90_async.cuh"

namespace i8scan {

using namespace sm90;
using fscan::CHUNK;
using fscan::QUERY_TILE;
using fscan::RingLayout;
using fscan::SMEM_LIMIT;
using fscan::TILE_Q;

constexpr int CONSUMERS = 2;                      // warpgroups, 64 queries each
constexpr int THREADS = (CONSUMERS + 1) * 128;    // + one producer warpgroup
constexpr int PRODUCER_REGS = 40;                 // 128·40 + 256·232 ≤ 65,536
constexpr int CONSUMER_REGS = 232;
constexpr int BK = 128;                           // dimensions (bytes) per slice
constexpr int A_BYTES = TILE_Q * BK;              // 16 KB: the queries' slice
// the ring (fscan::ring_layout_k) is laid out in bf16's slice sizes
static_assert(A_BYTES == fscan::B_A_BYTES && CHUNK * BK == fscan::B_B_BYTES,
              "an int8 slice is a bf16 slice's bytes");
constexpr int Q_MULTIPLE = 16;                    // the queries' padded width
constexpr int STAGING_WORDS = BK / 4 + 1;         // a row slice's aligned words (RAGGED)
constexpr int STAGING_BYTES = CHUNK * STAGING_WORDS * 4;

__host__ __device__ inline int slices(int d) { return (d + BK - 1) / BK; }

__host__ __device__ inline bool ragged(int d) { return d % Q_MULTIPLE != 0; }

// The ring for width d; the RAGGED staging sits at L.extra, the epilogue's
// `extra_bytes` after it (epilogue_offset).
__host__ __device__ inline RingLayout layout(int d, int extra_bytes) {
    return fscan::ring_layout_k(slices(d), extra_bytes + (ragged(d) ? STAGING_BYTES : 0));
}

__host__ __device__ inline int epilogue_offset(const RingLayout& L, int d) {
    return L.extra + (ragged(d) ? STAGING_BYTES : 0);
}

// Scores nchunks chunks of the corpus against the CTA's query pair through
// the ring at `smem` (fscan::aligned_smem, layout L, RESIDENT = L.a_bytes >
// 0); chunk c is rows chunk_row(c) .. chunk_row(c) + CHUNK − 1, any row to
// start at. The producer warpgroup returns false once its copies are done;
// each consumer thread calls epi(c, acc, wg, t, qa) after chunk c (query
// rows qa and qa + 8 of the CTA, columns 8j + 2t + e in acc[4j + 2r + e];
// acc may be overwritten: the next chunk's first product replaces it) and
// returns true. Rows past the corpus (a part chunk at its end) score 0.
// Called by all THREADS threads.
template <bool RESIDENT, bool RAGGED, class ChunkRow, class Epi>
__device__ __forceinline__ bool i8_scores(const CUtensorMap* tm_q,  // [nq·64, dq], box 128 × 128
                                          const CUtensorMap* tm_v,  // [n, d], box 128 × 256 (TMA)
                                          const int8_t* __restrict__ codes,  // [n, d] (RAGGED)
                                          long long n, unsigned char* smem, const RingLayout& L,
                                          int pair, ChunkRow&& chunk_row, int nchunks,
                                          int d, Epi&& epi) {
    const uint32_t base = smem_u32(smem);
    const uint32_t full0 = base + L.bars;            // full[s] = full0 + 8s
    const uint32_t empty0 = full0 + 8 * L.stages;    // empty[s]
    const uint32_t qbar = empty0 + 8 * L.stages;     // the resident queries
    const int nk = slices(d);
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;

    if (tid == 0) {
        for (int s = 0; s < L.stages; ++s) {
            // the producer's arrive (+ the TMA bytes); RAGGED and streaming:
            // the queries' expect_tx and the corpus lines' arrive
            mbar_init(full0 + 8 * s, RAGGED && !RESIDENT ? 2 : 1);
            mbar_init(empty0 + 8 * s, CONSUMERS);  // one arrive per consumer warpgroup
        }
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp >= CONSUMERS * 4) {  // the producer warpgroup
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
        const int ptid = tid - CONSUMERS * 128;
        const int qrow = pair * TILE_Q;
        if (RESIDENT && ptid == 0) {
            mbar_expect_tx(qbar, (uint32_t)(nk * A_BYTES));
            for (int ks = 0; ks < nk; ++ks)
                tma_load_2d(base + ks * A_BYTES, tm_q, ks * BK, qrow, qbar);
        }
        int stage = 0;
        uint32_t phase = 0;
        if (!RAGGED) {  // one thread starts every copy
            if (ptid == 0) {
                for (int c = 0; c < nchunks; ++c) {
                    const int row = (int)chunk_row(c);
                    for (int ks = 0; ks < nk; ++ks) {
                        mbar_wait(empty0 + 8 * stage, phase ^ 1);
                        const uint32_t st = base + L.ring + stage * L.stage_bytes;
                        const uint32_t fb = full0 + 8 * stage;
                        mbar_expect_tx(fb, (uint32_t)L.stage_bytes);
                        if (!RESIDENT) tma_load_2d(st, tm_q, ks * BK, qrow, fb);
                        tma_load_2d(st + (RESIDENT ? 0 : A_BYTES), tm_v, ks * BK, row, fb);
                        if (++stage == L.stages) {
                            stage = 0;
                            phase ^= 1;
                        }
                    }
                }
            }
            return false;
        }
        // RAGGED: warp pw of the producer stages rows pw, pw + 4, ...; lane l
        // moves word l of each (lane 0 also the 33rd)
        const int pw = ptid >> 5;
        uint32_t* stg = reinterpret_cast<uint32_t*>(smem + L.extra);
        const long long total = n * d;  // the corpus's bytes
        for (int c = 0; c < nchunks; ++c) {
            for (int ks = 0; ks < nk; ++ks) {
                const long long slice0 = (long long)chunk_row(c) * d + ks * BK;
                for (int r = pw; r < CHUNK; r += 4) {
                    const long long w0 = (slice0 + (long long)r * d) & ~3LL;
                    for (int w = lane; w < STAGING_WORDS; w += 32) {
                        const long long at = w0 + 4 * w;
                        const long long left = total - at;
                        const int nb = left <= 0 ? 0 : left >= 4 ? 4 : (int)left;
                        cp_async4_part(stg + r * STAGING_WORDS + w, nb ? codes + at : codes, nb);
                    }
                }
                cp_async_commit();
                cp_async_wait<0>();
                asm volatile("bar.sync 2, 128;\n" ::: "memory");  // the staging is whole
                mbar_wait(empty0 + 8 * stage, phase ^ 1);
                const uint32_t fb = full0 + 8 * stage;
                unsigned char* st = smem + L.ring + stage * L.stage_bytes;
                if (!RESIDENT && ptid == 0) {
                    mbar_expect_tx(fb, (uint32_t)A_BYTES);
                    tma_load_2d(smem_u32(st), tm_q, ks * BK, qrow, fb);
                }
                unsigned char* line = st + (RESIDENT ? 0 : A_BYTES);
                for (int r = pw; r < CHUNK; r += 4) {
                    const int sh = (int)((slice0 + (long long)r * d) & 3) * 8;
                    const uint32_t v = __funnelshift_r(stg[r * STAGING_WORDS + lane],
                                                       stg[r * STAGING_WORDS + lane + 1], sh);
                    // 16-byte unit lane / 4 of line r, 128-byte swizzle
                    const int at = r * BK + ((((lane >> 2) ^ (r & 7)) << 4) | ((lane & 3) << 2));
                    *reinterpret_cast<uint32_t*>(line + at) = v;
                }
                fence_proxy_async();
                asm volatile("bar.sync 2, 128;\n" ::: "memory");  // the lines are written
                if (ptid == 0) mbar_arrive(fb);
                if (++stage == L.stages) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        }
        return false;
    }

    // consumer warpgroup wg: queries 64·wg .. 64·wg + 63 of the CTA's 128
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = warp >> 2;
    const int t = lane & 3;
    const int qa = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // rows qa and qa + 8
    const bool lead = (tid & 127) == 0;
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
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
            const uint32_t a = (RESIDENT ? base + ks * A_BYTES : st) + wg * (A_BYTES / 2);
            const uint32_t b = st + (RESIDENT ? 0 : A_BYTES);
            const uint64_t da = sw128_desc(a), db = sw128_desc(b);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 32; ++kk)
                wgmma_s8_m64n256k32(acc, da + 2 * kk, db + 2 * kk, (ks | kk) != 0);
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

}  // namespace i8scan
