// Float scan with per-block top-kb, for Hopper (sm_90a), fp32 and bf16 corpora.
//
// Replaces the TPU kernel crs_tpu/ops/pallas_scan.py:pallas_topk / _scan_kernel
// (with _extract_block_topk). For each query tile of QUERY_TILE queries and
// each corpus block of block_size rows:
//   s = q · v  in f32 (the queries come cast to the corpus dtype; a bf16
//              product is exact in f32), then __fadd_rn(s, bias) (bias 0, or
//              -1e30 for padding and rows the `where` mask drops)
//   kb times: the max, the lowest global id among equal maxima, that entry
//   set to -1e30 (it stays a candidate under its id, so a block with no
//   allowed rows left re-emits its lowest id at -1e30).
// Partials go to out_s / out_i laid out [nq, nblocks, kb, QUERY_TILE].
// Scores must be -1e30 or above it (|q·v| far below 1e22, as for any
// embedding): then the emissions' scores never rise, which the running lists
// below rely on.
//
// What bounds it on an H100 at the main path's shape (N = 1,048,576, D =
// 384, B = 328 queries): the work, 2·B·N·D = 2.64e11 operations, is 3.94 ms
// of f32 FMA on the CUDA cores at 67 TFLOP/s (TF32 would change the scores
// the plain version computes, so it is not used) and 0.267 ms of bf16 on the
// tensor cores at 989 TFLOP/s; the corpus, 1.5 GiB / 768 MiB, is 0.48 /
// 0.24 ms at 3.35 TB/s. So fp32 is bound by the FMA rate and bf16 by the
// tensor cores, with the corpus bytes close behind. (B is padded to 384,
// six tiles of 64: the kernels do 17 % more work.)
//
// The scoring passes are csrc/float_scan.cuh's, which kernel 6
// (csrc/segmax_scan_topk.cu) shares: one corpus pass per launch, a CTA
// scoring one corpus block against two query tiles; fp32 on FFMA with an
// 8 × 8 register tile per thread (any D: a ragged last slice is
// zero-filled), bf16 on wgmma m64n256k16 fed by TMA (D a multiple of 8).
// This file adds the epilogue, a running top-kb per (query, block). (The
// first port ran the corpus block fastest: each of the six query tiles read
// the whole corpus from device memory.)
//
// The running list. A CTA walks its block CHUNK = 256 rows at a time and
// keeps, per query, the kb emissions of the rows seen so far, in shared
// memory. A chunk is folded in by kb arg-max passes over (chunk ∪ list), an
// extracted entry set to -1e30 under its id; every list id is lower than
// every id of a later chunk, so the list after the last chunk is exactly the
// kb emissions of the whole block, ties and re-emissions included. Skip: a
// chunk whose scores all lie at or below the list's kb-th entry cannot
// change the list (the list's entries win every pass: their scores are at
// least as high and their ids lower), so a warp whose queries all see such
// a chunk leaves their lists as they are.
//
// Any block_size >= 1 is taken (as kernel 1's, csrc/int8_scan_topk.cu): a
// block is ⌈block_size / 256⌉ chunks from its first row, and the columns of
// its last chunk past the block's end (rows of the next block, or past the
// corpus, which the passes zero-fill) score -1e30 and never enter the
// block's top-kb (every id of the block is lower than theirs).
//
// F32: a scored chunk gets its bias and is merged per query by the warp
// that owns it (block_topk.cuh, each lane's 8 row ids passed through);
// lanes < kb hold the list during the merge.
//
// BF16: the top-kb comes straight from the accumulators: a quad of threads
// holds a query row's 256 columns, 64 per thread (columns 8j + 2t + {0, 1}),
// so a pass is a thread-local arg-max over 64 values (columns ascend: a
// strict > keeps the lowest) and two shfl_xor steps; the list is
// double-buffered in shared memory (the old one read, the new one written)
// and is read as one more candidate per pass. No score tile passes through
// shared memory. What holds it: the merge runs between a chunk's products
// and the next, and the tensor cores idle while both warpgroups merge.
// (Tried on the H100 and slower: a tree in place of the thread-local scan,
// both rows merged side by side, and the scores above the list's kb-th
// copied to shared memory before the passes.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_topk.cuh"
#include "float_scan.cuh"

namespace {

using namespace fscan;

constexpr int MAX_KB = 32;
constexpr float NEG_INF = block_topk::NEG_INF;
constexpr unsigned FULL = 0xffffffffu;

// The CTA's finished lists [TILE_Q][kb] → the partials of its one or two tiles.
__device__ __forceinline__ void write_lists(const float* ls, const int* li, int tid, int threads,
                                            int pair, int nq, int nblocks, int blk, int kb,
                                            float* __restrict__ out_s, int* __restrict__ out_i) {
    for (int e = tid; e < TILE_Q * kb; e += threads) {
        const int q = e % TILE_Q, p = e / TILE_Q;
        const int tile = pair * 2 + q / QUERY_TILE;
        if (tile < nq) {
            const long long o =
                (((long long)tile * nblocks + blk) * kb + p) * QUERY_TILE + q % QUERY_TILE;
            out_s[o] = ls[q * kb + p];
            out_i[o] = li[q * kb + p];
        }
    }
}

// ---- F32: the running lists from the FFMA tiles -----------------------------------

size_t f32_smem_bytes(int kb) { return (size_t)F_PIPE_FLOATS * 4 + (size_t)TILE_Q * kb * 8; }

// MASKED: block_size is not a multiple of CHUNK (a block's last chunk is
// masked past its end; implies RAGGED). The main path's blocks take the
// unmasked instance, whose epilogue has no mask to evaluate.
template <bool RAGGED, bool MASKED>
__global__ void __launch_bounds__(F_THREADS, 1)
scan_topk_f32_kernel(const float* __restrict__ q,      // [nq·QUERY_TILE, d]
                     const float* __restrict__ vecs,   // [nblocks·block_size, d]
                     const float* __restrict__ bias,   // [nblocks·block_size]
                     float* __restrict__ out_s,        // [nq, nblocks, kb, QUERY_TILE]
                     int* __restrict__ out_i, int nq, int nblocks, int block_size, int d,
                     int kb) {
    extern __shared__ __align__(16) float fsmem[];  // the staging, then the lists
    float* lst_s = fsmem + F_PIPE_FLOATS;           // [TILE_Q][kb]
    int* lst_i = reinterpret_cast<int*>(lst_s + TILE_Q * kb);
    const int npairs = (nq + 1) / 2;
    const int pair = blockIdx.x % npairs;
    const int blk = blockIdx.x / npairs;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;

    // each scored chunk: bias, then each query's merge by its warp
    f32_scores<RAGGED>(q, vecs, fsmem, nq, pair, blk, block_size, d,
                       (long long)nblocks * block_size, [&](int c, float (&acc)[8][8]) {
        const int grow0 = blk * block_size + c * CHUNK;
        const int live = min(CHUNK, block_size - c * CHUNK);  // the block's columns
        // bias, or -1e30 at the columns past the block's end (which then never win)
        float bv[8];
        if (!MASKED || (live == CHUNK && !(grow0 & 3))) {  // a whole chunk, 16-byte aligned
            const float4 bb0 = *reinterpret_cast<const float4*>(bias + grow0 + 4 * lane);
            const float4 bb1 = *reinterpret_cast<const float4*>(bias + grow0 + HALF + 4 * lane);
            bv[0] = bb0.x; bv[1] = bb0.y; bv[2] = bb0.z; bv[3] = bb0.w;
            bv[4] = bb1.x; bv[5] = bb1.y; bv[6] = bb1.z; bv[7] = bb1.w;
        } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
                bv[j] = f32_row(lane, j) < live ? bias[grow0 + f32_row(lane, j)] : NEG_INF;
        }
        const auto row_of = [=](int j) { return grow0 + f32_row(lane, j); };
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            float s[8];
            float m = NEG_INF;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                s[j] = __fadd_rn(acc[i][j], bv[j]);  // -1e30 past the block: |q·v| ≪ 1e22
                m = fmaxf(m, s[j]);
            }
            const int ql = warp * 8 + i;
            float ls = NEG_INF;
            int li = 0;
            if (c > 0) {
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
                if (m <= lst_s[ql * kb + kb - 1]) continue;  // the list stays as it is
                if (lane < kb) {
                    ls = lst_s[ql * kb + lane];
                    li = lst_i[ql * kb + lane];
                }
            }
            block_topk::merge_chunk_rows<8>(s, row_of, c > 0, ls, li, kb, lane);
            if (lane < kb) {
                lst_s[ql * kb + lane] = ls;
                lst_i[ql * kb + lane] = li;
            }
        }
    });
    __syncthreads();
    write_lists(lst_s, lst_i, threadIdx.x, F_THREADS, pair, nq, nblocks, blk, kb, out_s, out_i);
}

// ---- BF16: the running lists from the accumulators --------------------------------

// the lists' room: two buffers of [TILE_Q][kb] scores, then ids
__host__ __device__ inline int lists_bytes(int kb) { return 2 * TILE_Q * kb * 8; }

__host__ __device__ inline RingLayout bf16_layout(int d, int kb) {
    return ring_layout(d, lists_bytes(kb));
}

template <bool RESIDENT, bool MASKED>  // MASKED: as the f32 kernel's
__global__ void __launch_bounds__(B_THREADS, 1)
scan_topk_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,  // [nq·64, d] bf16, box 64 × 128
                      const __grid_constant__ CUtensorMap tm_v,  // [N, d] bf16, box 64 × 256
                      const float* __restrict__ bias,            // [N]
                      float* __restrict__ out_s, int* __restrict__ out_i, int nq, int nblocks,
                      int block_size, int d, int kb) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = aligned_smem(smem_raw);
    const RingLayout L = bf16_layout(d, kb);
    // list buffer b (chunk parity): scores [TILE_Q][kb], then ids
    float* lists = reinterpret_cast<float*>(smem + L.extra);
    const int npairs = (nq + 1) / 2;
    const int pair = blockIdx.x % npairs;
    const int blk = blockIdx.x / npairs;
    const int block_row0 = blk * block_size;
    const bool consumer = bf16_scores<RESIDENT>(
        &tm_q, &tm_v, smem, L, pair, blk, block_size, d,
        [&](int c, float (&acc)[128], int wg, int t, int qa) {
            // the chunk's scores + bias, straight from the accumulators
            const int grow0 = block_row0 + c * CHUNK;
            const int live = min(CHUNK, block_size - c * CHUNK);  // the block's columns
            float m0 = NEG_INF, m1 = NEG_INF;
            if (!MASKED || (live == CHUNK && !(grow0 & 1))) {  // whole, pairs 8-byte aligned
#pragma unroll
                for (int j = 0; j < 32; ++j) {
                    const float2 bb = *reinterpret_cast<const float2*>(bias + grow0 + 8 * j + 2 * t);
                    acc[4 * j + 0] = __fadd_rn(acc[4 * j + 0], bb.x);
                    acc[4 * j + 1] = __fadd_rn(acc[4 * j + 1], bb.y);
                    acc[4 * j + 2] = __fadd_rn(acc[4 * j + 2], bb.x);
                    acc[4 * j + 3] = __fadd_rn(acc[4 * j + 3], bb.y);
                    m0 = fmaxf(m0, fmaxf(acc[4 * j + 0], acc[4 * j + 1]));
                    m1 = fmaxf(m1, fmaxf(acc[4 * j + 2], acc[4 * j + 3]));
                }
            } else {  // -1e30 at the columns past the block's end: they never win
#pragma unroll
                for (int j = 0; j < 32; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = 8 * j + 2 * t + e;
                        float s0 = NEG_INF, s1 = NEG_INF;
                        if (col < live) {
                            const float bb = bias[grow0 + col];
                            s0 = __fadd_rn(acc[4 * j + e], bb);
                            s1 = __fadd_rn(acc[4 * j + 2 + e], bb);
                        }
                        acc[4 * j + e] = s0;
                        acc[4 * j + 2 + e] = s1;
                        m0 = fmaxf(m0, s0);
                        m1 = fmaxf(m1, s1);
                    }
            }
            const bool have = c > 0;
            float* os = lists + ((c & 1) ^ 1) * 2 * TILE_Q * kb;  // the list so far
            float* ns = lists + (c & 1) * 2 * TILE_Q * kb;        // the list with this chunk
            const int* oi = reinterpret_cast<const int*>(os + TILE_Q * kb);
            int* ni = reinterpret_cast<int*>(ns + TILE_Q * kb);
            bool need0 = true, need1 = true;
            if (have) {
#pragma unroll
                for (int off = 1; off < 4; off <<= 1) {
                    m0 = fmaxf(m0, __shfl_xor_sync(FULL, m0, off));
                    m1 = fmaxf(m1, __shfl_xor_sync(FULL, m1, off));
                }
                need0 = m0 > os[qa * kb + kb - 1];
                need1 = m1 > os[(qa + 8) * kb + kb - 1];
            }
            const int o0 = qa * kb, o1 = (qa + 8) * kb;
            if (__any_sync(FULL, need0))
                block_topk::merge_row<0>(acc, t, grow0, have, os + o0, oi + o0, ns + o0,
                                         ni + o0, kb, block_row0);
            else
                block_topk::copy_list(os + o0, oi + o0, ns + o0, ni + o0, kb, t);
            if (__any_sync(FULL, need1))
                block_topk::merge_row<1>(acc, t, grow0, have, os + o1, oi + o1, ns + o1,
                                         ni + o1, kb, block_row0);
            else
                block_topk::copy_list(os + o1, oi + o1, ns + o1, ni + o1, kb, t);
            __syncwarp();
        });
    if (!consumer) return;
    asm volatile("bar.sync 1, %0;\n" ::"n"(B_CONSUMERS * 128) : "memory");
    const int nchunks = (block_size + CHUNK - 1) / CHUNK;
    const float* fs = lists + ((nchunks - 1) & 1) * 2 * TILE_Q * kb;
    write_lists(fs, reinterpret_cast<const int*>(fs + TILE_Q * kb), threadIdx.x,
                B_CONSUMERS * 128, pair, nq, nblocks, blk, kb, out_s, out_i);
}

// ---- launchers ------------------------------------------------------------------

bool shape_ok(int nq, int nblocks, int block_size, int kb, int d) {
    return nq >= 1 && nblocks >= 1 && block_size >= 1 && kb >= 1 && kb <= MAX_KB && d >= 1 &&
           (long long)nblocks * block_size < (1LL << 31);
}

int launch_f32(const void* q, const void* vecs, const void* bias, void* out_s, void* out_i,
               int nq, int nblocks, int block_size, int kb, int d, cudaStream_t stream) {
    if (!shape_ok(nq, nblocks, block_size, kb, d)) return (int)cudaErrorInvalidValue;
    const size_t smem = f32_smem_bytes(kb);
    // RAGGED: a slice past D, or a block's last chunk past the corpus, is zero-filled
    auto kernel = block_size % CHUNK ? scan_topk_f32_kernel<true, true>
                  : d % F_KC         ? scan_topk_f32_kernel<true, false>
                                     : scan_topk_f32_kernel<false, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return refused(err);
    kernel<<<(unsigned)((nq + 1) / 2) * (unsigned)nblocks, F_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(vecs),
        static_cast<const float*>(bias), static_cast<float*>(out_s), static_cast<int*>(out_i), nq,
        nblocks, block_size, d, kb);
    return (int)cudaGetLastError();
}

template <bool RESIDENT, bool MASKED>
int launch_bf16_as(const CUtensorMap& tq, const CUtensorMap& tv, const void* bias, void* out_s,
                   void* out_i, int nq, int nblocks, int block_size, int kb, int d,
                   cudaStream_t stream) {
    const size_t smem = ring_bytes(bf16_layout(d, kb));
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(scan_topk_bf16_kernel<RESIDENT, MASKED>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return refused(err);
    const unsigned grid = (unsigned)((nq + 1) / 2) * (unsigned)nblocks;
    scan_topk_bf16_kernel<RESIDENT, MASKED><<<grid, B_THREADS, smem, stream>>>(
        tq, tv, static_cast<const float*>(bias), static_cast<float*>(out_s),
        static_cast<int*>(out_i), nq, nblocks, block_size, d, kb);
    return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* vecs, const void* bias, void* out_s, void* out_i,
                int nq, int nblocks, int block_size, int kb, int d, cudaStream_t stream) {
    if (!shape_ok(nq, nblocks, block_size, kb, d) || d % 8) return (int)cudaErrorInvalidValue;
    CUtensorMap tq, tv;
    int err = encode_bf16_map(&tq, q, (long long)nq * QUERY_TILE, d, TILE_Q);
    if (err) return err;
    err = encode_bf16_map(&tv, vecs, (long long)nblocks * block_size, d, CHUNK);
    if (err) return err;
    const bool resident = bf16_layout(d, kb).a_bytes > 0;
#define BF16_LAUNCH(RES, MASK)                                                                   \
    launch_bf16_as<RES, MASK>(tq, tv, bias, out_s, out_i, nq, nblocks, block_size, kb, d, stream)
    if (block_size % CHUNK) return resident ? BF16_LAUNCH(true, true) : BF16_LAUNCH(false, true);
    return resident ? BF16_LAUNCH(true, false) : BF16_LAUNCH(false, false);
#undef BF16_LAUNCH
}

}  // namespace

extern "C" {

int scan_topk_float_chunk_rows() { return CHUNK; }
int scan_topk_float_query_tile() { return QUERY_TILE; }
int scan_topk_float_max_kb() { return MAX_KB; }

// Dynamic shared memory of one CTA (mode 0 f32, 1 bf16) at (d, kb), and
// whether the bf16 kernel keeps its queries resident.
int scan_topk_float_smem_bytes(int mode, int d, int kb) {
    return mode == 0 ? (int)f32_smem_bytes(kb) : ring_bytes(bf16_layout(d, kb));
}
int scan_topk_float_bf16_queries_resident(int d, int kb) {
    return bf16_layout(d, kb).a_bytes > 0 ? 1 : 0;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success),
// or for bf16 the CUresult of a failed tensor-map encode. q rows =
// nq·QUERY_TILE, vector rows = nblocks·block_size, block_size >= 1,
// 1 <= kb <= MAX_KB, d >= 1 (bf16: d % 8 == 0), 16-byte aligned
// pointers; scores must be ≥ -1e30.
int scan_topk_f32_launch(const void* q, const void* vecs, const void* bias, void* out_s,
                         void* out_i, int nq, int nblocks, int block_size, int kb, int d,
                         void* stream) {
    return launch_f32(q, vecs, bias, out_s, out_i, nq, nblocks, block_size, kb, d,
                      (cudaStream_t)stream);
}

int scan_topk_bf16_launch(const void* q, const void* vecs, const void* bias, void* out_s,
                          void* out_i, int nq, int nblocks, int block_size, int kb, int d,
                          void* stream) {
    return launch_bf16(q, vecs, bias, out_s, out_i, nq, nblocks, block_size, kb, d,
                       (cudaStream_t)stream);
}

}  // extern "C"
