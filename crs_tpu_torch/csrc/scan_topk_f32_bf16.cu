// Float scan with per-block top-kb, for Hopper (sm_90a), fp32 and bf16 corpora.
//
// Replaces the TPU kernel crs_tpu/ops/pallas_scan.py:pallas_topk / _scan_kernel
// (with _extract_block_topk). For each query tile and each corpus block of
// block_size rows:
//   s = q · v  in f32 (the queries come cast to the corpus dtype; a bf16
//              product is exact in f32), + bias (0, or -1e30 for padding and
//              rows the `where` mask drops)
//   kb times: the max, the lowest global id among equal maxima, that entry
//   set to -1e30 (block_topk.cuh).
// Partials go to out_s / out_i laid out [nq, nblocks, kb, QUERY_TILE].
//
// What bounds it on an H100: at N = 1,048,576, D = 384, B = 328 the fp32
// work is 2·B·N·D ≈ 2.6e11 FLOP, ≈ 3.9 ms at the 67 TFLOP/s of the CUDA
// cores (TF32 would change the scores the plain version computes, so it is
// not used), against 1.6 GB of corpus ≈ 0.48 ms: operations bound fp32. In
// bf16 the corpus is 0.8 GB ≈ 0.24 ms and the same FLOP take ≈ 0.27 ms on
// the bf16 tensor cores (989 TFLOP/s): operations, barely.
//
// fp32 design (scan_topk_float_kernel): plain f32 FMA on the CUDA cores. One
// CUDA block per (corpus block, 64-query tile), 256 threads = 8 warps. The
// block walks its rows CHUNK = 256 at a time; per chunk, query and corpus
// slices of KC = 32 dimensions are staged in shared memory as [dim][query]
// and [dim][row] floats (rows padded by one word, so both the transposing
// stores and the reads are free of bank conflicts). Warp w owns queries
// 8w..8w+7 and lane l rows l, l+32, ..., so each thread keeps an 8 × 8 tile
// of sums in registers; after the bias, block_topk::merge_chunk folds the
// chunk into each query's running top-kb (one entry per lane).
//
// bf16 design (scan_topk_bf16_mma_kernel): the products run on the tensor
// cores, mma.sync m16n8k16 (bf16 × bf16, exact products, f32 accumulation).
// Same grid and chunking; per chunk the 64 × 256 score tile is computed by
// 8 warps of 16 queries × 128 rows (16 mma tiles each, 64 f32 accumulators
// per thread) from bf16 slices of 32 dimensions staged row-major in shared
// memory (rows padded to 40 bf16, so the fragment loads of a quad's 8 rows
// fall in distinct banks). The tile then goes to shared memory as f32, and
// warp w reads its 8 queries back in the merge layout (lane l: rows l,
// l+32, ...), adds the bias and runs the same merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_topk.cuh"

namespace {

constexpr int CHUNK = 256;       // corpus rows per step
constexpr int QUERY_TILE = 64;   // queries per CUDA block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int Q_PER_WARP = QUERY_TILE / WARPS;  // 8
constexpr int ROWS_PER_LANE = CHUNK / 32;       // 8
constexpr int KC = 32;                          // dimensions per shared-memory stage
constexpr int MAX_KB = 32;
// bf16 tensor-core kernel
constexpr int SROW = KC + 8;                    // bf16 per staged row (bank padding)
constexpr int SC_STRIDE = CHUNK + 8;            // floats per score-tile row
constexpr int MMA_Q = 16;                       // queries per warp tile (mma M)
constexpr int MMA_ROWS = 128;                   // corpus rows per warp tile
constexpr int N_TILES = MMA_ROWS / 8;           // mma N = 8 rows each
constexpr size_t BF16_SMEM = (size_t)(QUERY_TILE + CHUNK) * SROW * 2 +
                             (size_t)QUERY_TILE * SC_STRIDE * sizeof(float);

// rows [0, R) × dims [k0, k0 + KC) of a row-major [*, d] matrix → dst[dim][row]
template <int R>
__device__ __forceinline__ void stage(float (*dst)[R + 1], const float* src, int d, int k0,
                                      int tid) {
    constexpr int V = KC / 4;  // float4 per row slice
    for (int idx = tid; idx < R * V; idx += THREADS) {
        const int r = idx / V, g = idx % V;
        const float4 v = *reinterpret_cast<const float4*>(src + (long long)r * d + k0 + g * 4);
        dst[g * 4 + 0][r] = v.x;
        dst[g * 4 + 1][r] = v.y;
        dst[g * 4 + 2][r] = v.z;
        dst[g * 4 + 3][r] = v.w;
    }
}

__global__ void __launch_bounds__(THREADS)
scan_topk_float_kernel(const float* __restrict__ q,     // [nq·QUERY_TILE, d]
                       const float* __restrict__ vecs,  // [nblocks·block_size, d]
                       const float* __restrict__ bias, // [nblocks·block_size]
                       float* __restrict__ out_s,      // [nq, nblocks, kb, QUERY_TILE]
                       int* __restrict__ out_i,
                       int nblocks, int block_size, int d, int kb) {
    __shared__ float qs[KC][QUERY_TILE + 1];
    __shared__ float cs[KC][CHUNK + 1];

    const int blk = blockIdx.x;
    const int iq = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const float* qbase = q + (long long)iq * QUERY_TILE * d;

    float ls[Q_PER_WARP];
    int li[Q_PER_WARP];
#pragma unroll
    for (int i = 0; i < Q_PER_WARP; ++i) {
        ls[i] = block_topk::NEG_INF;
        li[i] = 0;
    }

    for (int c0 = 0; c0 < block_size; c0 += CHUNK) {
        const long long row0 = (long long)blk * block_size + c0;
        const float* cbase = vecs + row0 * d;
        float acc[Q_PER_WARP][ROWS_PER_LANE];
#pragma unroll
        for (int i = 0; i < Q_PER_WARP; ++i)
#pragma unroll
            for (int j = 0; j < ROWS_PER_LANE; ++j) acc[i][j] = 0.0f;

        for (int k0 = 0; k0 < d; k0 += KC) {
            __syncthreads();  // the previous stage is consumed
            stage<QUERY_TILE>(qs, qbase, d, k0, tid);
            stage<CHUNK>(cs, cbase, d, k0, tid);
            __syncthreads();
#pragma unroll 4
            for (int kk = 0; kk < KC; ++kk) {
                float qv[Q_PER_WARP], cv[ROWS_PER_LANE];
#pragma unroll
                for (int i = 0; i < Q_PER_WARP; ++i) qv[i] = qs[kk][warp * Q_PER_WARP + i];
#pragma unroll
                for (int j = 0; j < ROWS_PER_LANE; ++j) cv[j] = cs[kk][lane + 32 * j];
#pragma unroll
                for (int i = 0; i < Q_PER_WARP; ++i)
#pragma unroll
                    for (int j = 0; j < ROWS_PER_LANE; ++j)
                        acc[i][j] = fmaf(qv[i], cv[j], acc[i][j]);
            }
        }

#pragma unroll
        for (int j = 0; j < ROWS_PER_LANE; ++j) {
            const float b = bias[row0 + lane + 32 * j];
#pragma unroll
            for (int i = 0; i < Q_PER_WARP; ++i) acc[i][j] = __fadd_rn(acc[i][j], b);
        }
#pragma unroll
        for (int i = 0; i < Q_PER_WARP; ++i)
            block_topk::merge_chunk<ROWS_PER_LANE>(acc[i], (int)row0, c0 > 0, ls[i], li[i], kb,
                                                   lane);
    }

    if (lane < kb) {
#pragma unroll
        for (int i = 0; i < Q_PER_WARP; ++i) {
            const long long o =
                (((long long)iq * nblocks + blk) * kb + lane) * QUERY_TILE + warp * Q_PER_WARP + i;
            out_s[o] = ls[i];
            out_i[o] = li[i];
        }
    }
}

// rows [0, R) × dims [k0, k0 + KC) of a row-major bf16 [*, d] matrix →
// dst[row][SROW], 16 bytes per load and store
template <int R>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int d,
                                           int k0, int tid) {
    constexpr int V = KC / 8;
    for (int idx = tid; idx < R * V; idx += THREADS) {
        const int r = idx / V, g = idx % V;
        *reinterpret_cast<uint4*>(dst + r * SROW + g * 8) =
            *reinterpret_cast<const uint4*>(src + (long long)r * d + k0 + g * 8);
    }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// D = A·B + D, A 16 × 16 (row), B 16 × 8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS, 2)
scan_topk_bf16_mma_kernel(const __nv_bfloat16* __restrict__ q,     // [nq·QUERY_TILE, d]
                          const __nv_bfloat16* __restrict__ vecs,  // [nblocks·block_size, d]
                          const float* __restrict__ bias,          // [nblocks·block_size]
                          float* __restrict__ out_s,               // [nq, nblocks, kb, QUERY_TILE]
                          int* __restrict__ out_i,
                          int nblocks, int block_size, int d, int kb) {
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);        // [QUERY_TILE][SROW]
    __nv_bfloat16* cs = qs + QUERY_TILE * SROW;                         // [CHUNK][SROW]
    float* sc = reinterpret_cast<float*>(cs + CHUNK * SROW);            // [QUERY_TILE][SC_STRIDE]

    const int blk = blockIdx.x;
    const int iq = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int group = lane >> 2, tig = lane & 3;  // the mma fragments' row and column pair
    const int q0 = MMA_Q * (warp % 4);            // this warp's 16 queries
    const int n0 = MMA_ROWS * (warp / 4);         // and its 128 rows of the chunk
    const __nv_bfloat16* qbase = q + (long long)iq * QUERY_TILE * d;

    float ls[Q_PER_WARP];
    int li[Q_PER_WARP];
#pragma unroll
    for (int i = 0; i < Q_PER_WARP; ++i) {
        ls[i] = block_topk::NEG_INF;
        li[i] = 0;
    }

    for (int c0 = 0; c0 < block_size; c0 += CHUNK) {
        const long long row0 = (long long)blk * block_size + c0;
        float acc[N_TILES][4];
#pragma unroll
        for (int t = 0; t < N_TILES; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;

        for (int k0 = 0; k0 < d; k0 += KC) {
            __syncthreads();  // the previous stage (and the previous chunk's merge) is done
            stage_rows<QUERY_TILE>(qs, qbase, d, k0, tid);
            stage_rows<CHUNK>(cs, vecs + row0 * d, d, k0, tid);
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < KC; kk += 16) {
                const __nv_bfloat16* pa = qs + (q0 + group) * SROW + kk + 2 * tig;
                const uint32_t a0 = ld32(pa), a1 = ld32(pa + 8 * SROW);
                const uint32_t a2 = ld32(pa + 8), a3 = ld32(pa + 8 * SROW + 8);
#pragma unroll
                for (int t = 0; t < N_TILES; ++t) {
                    const __nv_bfloat16* pb = cs + (n0 + 8 * t + group) * SROW + kk + 2 * tig;
                    mma_bf16(acc[t], a0, a1, a2, a3, ld32(pb), ld32(pb + 8));
                }
            }
        }
        // the score tile → shared memory: acc[t] holds (query q0 + group (+8),
        // rows n0 + 8t + 2·tig, +1)
#pragma unroll
        for (int t = 0; t < N_TILES; ++t) {
            const int n = n0 + 8 * t + 2 * tig;
            *reinterpret_cast<float2*>(sc + (q0 + group) * SC_STRIDE + n) =
                make_float2(acc[t][0], acc[t][1]);
            *reinterpret_cast<float2*>(sc + (q0 + group + 8) * SC_STRIDE + n) =
                make_float2(acc[t][2], acc[t][3]);
        }
        __syncthreads();
        float b[ROWS_PER_LANE];
#pragma unroll
        for (int j = 0; j < ROWS_PER_LANE; ++j) b[j] = bias[row0 + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < Q_PER_WARP; ++i) {
            float s[ROWS_PER_LANE];
            const float* row = sc + (warp * Q_PER_WARP + i) * SC_STRIDE;
#pragma unroll
            for (int j = 0; j < ROWS_PER_LANE; ++j) s[j] = __fadd_rn(row[lane + 32 * j], b[j]);
            block_topk::merge_chunk<ROWS_PER_LANE>(s, (int)row0, c0 > 0, ls[i], li[i], kb, lane);
        }
    }

    if (lane < kb) {
#pragma unroll
        for (int i = 0; i < Q_PER_WARP; ++i) {
            const long long o =
                (((long long)iq * nblocks + blk) * kb + lane) * QUERY_TILE + warp * Q_PER_WARP + i;
            out_s[o] = ls[i];
            out_i[o] = li[i];
        }
    }
}

int launch_f32(const void* q, const void* vecs, const void* bias, void* out_s, void* out_i,
               int nq, int nblocks, int block_size, int kb, int d, void* stream) {
    const dim3 grid((unsigned)nblocks, (unsigned)nq);
    scan_topk_float_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(vecs),
        static_cast<const float*>(bias), static_cast<float*>(out_s), static_cast<int*>(out_i),
        nblocks, block_size, d, kb);
    return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* vecs, const void* bias, void* out_s, void* out_i,
                int nq, int nblocks, int block_size, int kb, int d, void* stream) {
    cudaError_t err = cudaFuncSetAttribute(
        scan_topk_bf16_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BF16_SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)nblocks, (unsigned)nq);
    scan_topk_bf16_mma_kernel<<<grid, THREADS, BF16_SMEM, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(vecs),
        static_cast<const float*>(bias), static_cast<float*>(out_s), static_cast<int*>(out_i),
        nblocks, block_size, d, kb);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int scan_topk_float_chunk_rows() { return CHUNK; }
int scan_topk_float_query_tile() { return QUERY_TILE; }
int scan_topk_float_max_kb() { return MAX_KB; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The caller checks shapes: q rows = nq·QUERY_TILE, vector rows =
// nblocks·block_size, block_size % CHUNK == 0, d % 32 == 0,
// 1 <= kb <= MAX_KB, 16-byte aligned pointers.
int scan_topk_f32_launch(const void* q, const void* vecs, const void* bias, void* out_s,
                         void* out_i, int nq, int nblocks, int block_size, int kb, int d,
                         void* stream) {
    return launch_f32(q, vecs, bias, out_s, out_i, nq, nblocks, block_size, kb, d, stream);
}

int scan_topk_bf16_launch(const void* q, const void* vecs, const void* bias, void* out_s,
                          void* out_i, int nq, int nblocks, int block_size, int kb, int d,
                          void* stream) {
    return launch_bf16(q, vecs, bias, out_s, out_i, nq, nblocks, block_size, kb, d, stream);
}

}  // extern "C"
