// Segment-max scans (approximate, one winner per 128-row segment), for
// Hopper (sm_90a): f32, bf16 and int8 corpora.
//
// Replaces two TPU kernels of crs_tpu/ops/pallas_scan.py:
//   MODE = F32 / BF16: pallas_topk_segmax / _scan_kernel_segmax
//   MODE = I8:         pallas_topk_segmax_int8 / _scan_kernel_segmax_int8
// For each query tile and each corpus block of block_size rows:
//   F32 / BF16: s = q · v in f32 (the queries come cast to the corpus dtype;
//               a bf16 product is exact in f32)
//   I8:         s = (f32(acc) · q_scale) · row_scale, acc = q_codes · codes
//               in int32 (exact), each product rounded alone
//   s = -1e30 at every row ≥ valid_n (the value replaced, not a bias added)
//   per 128-row segment: its max and the lowest row reaching it
//   kseg times: the segment with the largest max (the lowest segment among
//   equal maxima); emit (its max, its argmax row); set its max to -1e30 and
//   keep its argmax row.
// Partials go to out_s / out_i laid out [nq, nblocks, kseg, QUERY_TILE]. As
// in the Pallas kernel, once fewer than kseg segments score above -1e30 the
// later picks land on the lowest segment at -1e30 and emit its row again.
//
// What bounds it on an H100 (N = 1,048,576, D = 384, B = 328): the work,
// 2·B·N·D ≈ 2.6e11 operations: ≈ 3.9 ms in f32 on the CUDA cores (TF32
// would change the scores), ≈ 0.27 ms in bf16 on the tensor cores, ≈ 0.13
// ms in int8 on the tensor cores, against 1.6 GB / 0.8 GB / 0.4 GB of
// corpus (0.48 / 0.24 / 0.12 ms at 3.35 TB/s).
//
// Design: the scoring is the float scan's (scan_topk_f32_bf16.cu: f32 FMA
// on the CUDA cores, bf16 on mma.sync m16n8k16) and the int8 scan's
// (int8_scan_topk.cu: __dp4a); the TPU kernel's gain, two vector passes
// over the scores instead of kb, carries over as one warp reduction per
// segment instead of kb extraction passes. One CUDA block per (corpus
// block, query tile of 64), 256 threads = 8 warps; the block walks its rows
// CHUNK = 256 at a time, so a chunk holds two whole segments. Warp w owns
// queries 8w..8w+7 and lane l holds rows l, l+32, ..., l+224 of the chunk:
// rows l+32j for j < 4 are the first segment, j ≥ 4 the second. A segment's
// (max, lowest row) is a lane-local pass over 4 values and a warp reduction;
// lane s of the warp keeps segment s's (max, row) for each of its 8 queries
// in registers (so at most 32 segments, block_size ≤ 4096). The kseg picks
// are warp arg-max reductions over those lanes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 256;       // corpus rows per step (two segments)
constexpr int SEGMENT = 128;     // rows per segment
constexpr int QUERY_TILE = 64;   // queries per CUDA block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int Q_PER_WARP = QUERY_TILE / WARPS;  // 8
constexpr int ROWS_PER_LANE = CHUNK / 32;       // 8
constexpr int SEG_LANES = SEGMENT / 32;         // 4 values per lane per segment
constexpr int MAX_SEGMENTS = 32;                // one per lane
constexpr int KC = 32;                          // dimensions per shared-memory stage
constexpr int KCHUNK_WORDS = 16;                // int8: 64 bytes of each row per stage
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
// bf16 tensor-core scoring
constexpr int SROW = KC + 8;                    // bf16 per staged row (bank padding)
constexpr int SC_STRIDE = CHUNK + 8;            // floats per score-tile row
constexpr int MMA_Q = 16;
constexpr int MMA_ROWS = 128;
constexpr int N_TILES = MMA_ROWS / 8;

enum Mode { F32 = 0, BF16 = 1, I8 = 2 };

size_t smem_bytes(int mode, int d) {
    if (mode == F32) return (size_t)KC * (QUERY_TILE + 1 + CHUNK + 1) * sizeof(float);
    if (mode == BF16)
        return (size_t)(QUERY_TILE + CHUNK) * SROW * 2 + (size_t)QUERY_TILE * SC_STRIDE * 4;
    return (size_t)d * QUERY_TILE + (size_t)KCHUNK_WORDS * CHUNK * 4;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// F32: the chunk's scores s[i][j] (query 8·warp + i, row lane + 32j) by FMA
// over KC-dimension slices staged [dim][query] and [dim][row].
__device__ __forceinline__ void score_f32(float (&s)[Q_PER_WARP][ROWS_PER_LANE], const float* q,
                                          const float* rows, int d, unsigned char* smem, int tid,
                                          int lane, int warp) {
    float(*qs)[QUERY_TILE + 1] = reinterpret_cast<float(*)[QUERY_TILE + 1]>(smem);
    float(*cs)[CHUNK + 1] =
        reinterpret_cast<float(*)[CHUNK + 1]>(smem + KC * (QUERY_TILE + 1) * sizeof(float));
#pragma unroll
    for (int i = 0; i < Q_PER_WARP; ++i)
#pragma unroll
        for (int j = 0; j < ROWS_PER_LANE; ++j) s[i][j] = 0.0f;
    constexpr int V = KC / 4;
    for (int k0 = 0; k0 < d; k0 += KC) {
        __syncthreads();  // the previous stage is consumed
        for (int idx = tid; idx < QUERY_TILE * V; idx += THREADS) {
            const int r = idx / V, g = idx % V;
            const float4 v = *reinterpret_cast<const float4*>(q + (long long)r * d + k0 + g * 4);
            qs[g * 4 + 0][r] = v.x; qs[g * 4 + 1][r] = v.y;
            qs[g * 4 + 2][r] = v.z; qs[g * 4 + 3][r] = v.w;
        }
        for (int idx = tid; idx < CHUNK * V; idx += THREADS) {
            const int r = idx / V, g = idx % V;
            const float4 v = *reinterpret_cast<const float4*>(rows + (long long)r * d + k0 + g * 4);
            cs[g * 4 + 0][r] = v.x; cs[g * 4 + 1][r] = v.y;
            cs[g * 4 + 2][r] = v.z; cs[g * 4 + 3][r] = v.w;
        }
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
                for (int j = 0; j < ROWS_PER_LANE; ++j) s[i][j] = fmaf(qv[i], cv[j], s[i][j]);
        }
    }
}

// BF16: the 64 × 256 score tile on mma.sync (8 warps of 16 queries × 128
// rows), through shared memory into the same s[i][j] layout.
__device__ __forceinline__ void score_bf16(float (&s)[Q_PER_WARP][ROWS_PER_LANE],
                                           const __nv_bfloat16* q, const __nv_bfloat16* rows,
                                           int d, unsigned char* smem, int tid, int lane,
                                           int warp) {
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [QUERY_TILE][SROW]
    __nv_bfloat16* cs = qs + QUERY_TILE * SROW;                   // [CHUNK][SROW]
    float* sc = reinterpret_cast<float*>(cs + CHUNK * SROW);      // [QUERY_TILE][SC_STRIDE]
    const int group = lane >> 2, tig = lane & 3;
    const int q0 = MMA_Q * (warp % 4);
    const int n0 = MMA_ROWS * (warp / 4);
    float acc[N_TILES][4];
#pragma unroll
    for (int t = 0; t < N_TILES; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
    constexpr int V = KC / 8;
    for (int k0 = 0; k0 < d; k0 += KC) {
        __syncthreads();  // the previous stage (and the previous chunk's reads of sc) is done
        for (int idx = tid; idx < QUERY_TILE * V; idx += THREADS) {
            const int r = idx / V, g = idx % V;
            *reinterpret_cast<uint4*>(qs + r * SROW + g * 8) =
                *reinterpret_cast<const uint4*>(q + (long long)r * d + k0 + g * 8);
        }
        for (int idx = tid; idx < CHUNK * V; idx += THREADS) {
            const int r = idx / V, g = idx % V;
            *reinterpret_cast<uint4*>(cs + r * SROW + g * 8) =
                *reinterpret_cast<const uint4*>(rows + (long long)r * d + k0 + g * 8);
        }
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
#pragma unroll
    for (int t = 0; t < N_TILES; ++t) {
        const int n = n0 + 8 * t + 2 * tig;
        *reinterpret_cast<float2*>(sc + (q0 + group) * SC_STRIDE + n) =
            make_float2(acc[t][0], acc[t][1]);
        *reinterpret_cast<float2*>(sc + (q0 + group + 8) * SC_STRIDE + n) =
            make_float2(acc[t][2], acc[t][3]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < Q_PER_WARP; ++i)
#pragma unroll
        for (int j = 0; j < ROWS_PER_LANE; ++j)
            s[i][j] = sc[(warp * Q_PER_WARP + i) * SC_STRIDE + lane + 32 * j];
}

// I8: int32 dots by __dp4a over the query tile's words [word][query] (in
// shared memory for the whole block) and the chunk's words staged
// [word][row] KCHUNK_WORDS at a time; then the two rounded products.
__device__ __forceinline__ void score_i8(float (&s)[Q_PER_WARP][ROWS_PER_LANE],
                                         const int* qw, const int8_t* rows,
                                         const float* q_scale, const float* row_scale, int d,
                                         int* cs, int tid, int lane, int warp) {
    const int dw = d / 4;
    int acc[Q_PER_WARP][ROWS_PER_LANE];
#pragma unroll
    for (int i = 0; i < Q_PER_WARP; ++i)
#pragma unroll
        for (int j = 0; j < ROWS_PER_LANE; ++j) acc[i][j] = 0;
    for (int kc = 0; kc < dw; kc += KCHUNK_WORDS) {
        const int nw = min(KCHUNK_WORDS, dw - kc);  // a multiple of 4 (d % 16 == 0)
        const int nseg = nw / 4;
        __syncthreads();
        for (int idx = tid; idx < CHUNK * nseg; idx += THREADS) {
            const int r = idx / nseg, sg = idx % nseg;
            const int4 v =
                *reinterpret_cast<const int4*>(rows + (long long)r * d + kc * 4 + sg * 16);
            cs[(sg * 4 + 0) * CHUNK + r] = v.x;
            cs[(sg * 4 + 1) * CHUNK + r] = v.y;
            cs[(sg * 4 + 2) * CHUNK + r] = v.z;
            cs[(sg * 4 + 3) * CHUNK + r] = v.w;
        }
        __syncthreads();
        for (int w = 0; w < nw; ++w) {
            int qv[Q_PER_WARP], cv[ROWS_PER_LANE];
#pragma unroll
            for (int i = 0; i < Q_PER_WARP; ++i)
                qv[i] = qw[(kc + w) * QUERY_TILE + warp * Q_PER_WARP + i];
#pragma unroll
            for (int j = 0; j < ROWS_PER_LANE; ++j) cv[j] = cs[w * CHUNK + lane + 32 * j];
#pragma unroll
            for (int i = 0; i < Q_PER_WARP; ++i)
#pragma unroll
                for (int j = 0; j < ROWS_PER_LANE; ++j) acc[i][j] = __dp4a(qv[i], cv[j], acc[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < ROWS_PER_LANE; ++j) {
        const float vs = row_scale[lane + 32 * j];
#pragma unroll
        for (int i = 0; i < Q_PER_WARP; ++i)
            s[i][j] = __fmul_rn(__fmul_rn((float)acc[i][j], q_scale[warp * Q_PER_WARP + i]), vs);
    }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
segmax_scan_kernel(const void* __restrict__ q_,            // [nq·QUERY_TILE, d]
                   const void* __restrict__ vecs_,         // [nblocks·block_size, d]
                   const float* __restrict__ q_scale,      // [nq·QUERY_TILE] (I8)
                   const float* __restrict__ row_scale,    // [nblocks·block_size] (I8)
                   float* __restrict__ out_s,              // [nq, nblocks, kseg, QUERY_TILE]
                   int* __restrict__ out_i,
                   int nblocks, int block_size, int d, int kseg, int valid_n) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int blk = blockIdx.x;
    const int iq = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long q_off = (long long)iq * QUERY_TILE * d;

    int* qw = reinterpret_cast<int*>(smem);          // I8: [d/4][QUERY_TILE] words
    int* cs_i8 = qw + (d / 4) * QUERY_TILE;          // I8: [KCHUNK_WORDS][CHUNK] words
    if constexpr (MODE == I8) {  // the query tile's codes → shared memory, 16 bytes per load
        const int segs = d / 16;
        const int4* src = reinterpret_cast<const int4*>(static_cast<const int8_t*>(q_) + q_off);
        for (int idx = tid; idx < QUERY_TILE * segs; idx += THREADS) {
            const int qq = idx / segs, sg = idx % segs;
            const int4 v = src[(long long)qq * segs + sg];
            qw[(sg * 4 + 0) * QUERY_TILE + qq] = v.x;
            qw[(sg * 4 + 1) * QUERY_TILE + qq] = v.y;
            qw[(sg * 4 + 2) * QUERY_TILE + qq] = v.z;
            qw[(sg * 4 + 3) * QUERY_TILE + qq] = v.w;
        }
    }

    // lane s: segment s's (max, argmax row) for each of the warp's queries;
    // lanes past the block's segments stay at -inf and are never picked
    float seg_max[Q_PER_WARP];
    int seg_arg[Q_PER_WARP];
#pragma unroll
    for (int i = 0; i < Q_PER_WARP; ++i) {
        seg_max[i] = -INFINITY;
        seg_arg[i] = 0;
    }

    for (int c0 = 0; c0 < block_size; c0 += CHUNK) {
        const long long row0 = (long long)blk * block_size + c0;
        float s[Q_PER_WARP][ROWS_PER_LANE];
        if constexpr (MODE == F32) {
            score_f32(s, static_cast<const float*>(q_) + q_off,
                      static_cast<const float*>(vecs_) + row0 * d, d, smem, tid, lane, warp);
        } else if constexpr (MODE == BF16) {
            score_bf16(s, static_cast<const __nv_bfloat16*>(q_) + q_off,
                       static_cast<const __nv_bfloat16*>(vecs_) + row0 * d, d, smem, tid, lane,
                       warp);
        } else {
            score_i8(s, qw, static_cast<const int8_t*>(vecs_) + row0 * d,
                     q_scale + (long long)iq * QUERY_TILE, row_scale + row0, d, cs_i8, tid,
                     lane, warp);
        }
#pragma unroll
        for (int j = 0; j < ROWS_PER_LANE; ++j) {
            if (row0 + lane + 32 * j >= valid_n) {
#pragma unroll
                for (int i = 0; i < Q_PER_WARP; ++i) s[i][j] = NEG_INF;
            }
        }
#pragma unroll
        for (int h = 0; h < CHUNK / SEGMENT; ++h) {
            const int seg = c0 / SEGMENT + h;
#pragma unroll
            for (int i = 0; i < Q_PER_WARP; ++i) {
                // lane-local (max, lowest row): rows ascend with j, strict > keeps the lowest
                float best = s[i][SEG_LANES * h];
                int brow = (int)row0 + lane + 32 * SEG_LANES * h;
#pragma unroll
                for (int jj = 1; jj < SEG_LANES; ++jj) {
                    const int j = SEG_LANES * h + jj;
                    if (s[i][j] > best) {
                        best = s[i][j];
                        brow = (int)row0 + lane + 32 * j;
                    }
                }
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) {
                    const float ob = __shfl_xor_sync(FULL, best, off);
                    const int orow = __shfl_xor_sync(FULL, brow, off);
                    if (ob > best || (ob == best && orow < brow)) {
                        best = ob;
                        brow = orow;
                    }
                }
                if (lane == seg) {
                    seg_max[i] = best;
                    seg_arg[i] = brow;
                }
            }
        }
    }

    // kseg picks per query: (largest max, lowest segment), emit, mask to -1e30
#pragma unroll
    for (int i = 0; i < Q_PER_WARP; ++i) {
        const int qq = warp * Q_PER_WARP + i;
        for (int p = 0; p < kseg; ++p) {
            float best = seg_max[i];
            int bl = lane;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                const float ob = __shfl_xor_sync(FULL, best, off);
                const int ol = __shfl_xor_sync(FULL, bl, off);
                if (ob > best || (ob == best && ol < bl)) {
                    best = ob;
                    bl = ol;
                }
            }
            const int arg = __shfl_sync(FULL, seg_arg[i], bl);
            if (lane == 0) {
                const long long o = (((long long)iq * nblocks + blk) * kseg + p) * QUERY_TILE + qq;
                out_s[o] = best;
                out_i[o] = arg;
            }
            if (lane == bl) seg_max[i] = NEG_INF;
        }
    }
}

template <int MODE>
int launch(const void* q, const void* vecs, const void* q_scale, const void* row_scale,
           void* out_s, void* out_i, int nq, int nblocks, int block_size, int d, int kseg,
           int valid_n, void* stream) {
    const size_t smem = smem_bytes(MODE, d);
    cudaError_t err = cudaFuncSetAttribute(segmax_scan_kernel<MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)nblocks, (unsigned)nq);
    segmax_scan_kernel<MODE><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        q, vecs, static_cast<const float*>(q_scale), static_cast<const float*>(row_scale),
        static_cast<float*>(out_s), static_cast<int*>(out_i), nblocks, block_size, d, kseg,
        valid_n);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int segmax_scan_topk_chunk_rows() { return CHUNK; }
int segmax_scan_topk_query_tile() { return QUERY_TILE; }
int segmax_scan_topk_segment_rows() { return SEGMENT; }
int segmax_scan_topk_max_segments() { return MAX_SEGMENTS; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The caller checks shapes: query rows = nq·QUERY_TILE, corpus rows =
// nblocks·block_size, block_size a multiple of CHUNK and at most
// MAX_SEGMENTS·SEGMENT, 1 <= kseg <= block_size / SEGMENT, d % 32 == 0
// (f32 / bf16) or d % 16 == 0 (int8), 16-byte aligned pointers. The scale
// pointers are read by the int8 kernel only.
int segmax_scan_topk_f32_launch(const void* q, const void* vecs, const void* q_scale,
                                const void* row_scale, void* out_s, void* out_i, int nq,
                                int nblocks, int block_size, int d, int kseg, int valid_n,
                                void* stream) {
    return launch<F32>(q, vecs, q_scale, row_scale, out_s, out_i, nq, nblocks, block_size, d,
                       kseg, valid_n, stream);
}

int segmax_scan_topk_bf16_launch(const void* q, const void* vecs, const void* q_scale,
                                 const void* row_scale, void* out_s, void* out_i, int nq,
                                 int nblocks, int block_size, int d, int kseg, int valid_n,
                                 void* stream) {
    return launch<BF16>(q, vecs, q_scale, row_scale, out_s, out_i, nq, nblocks, block_size, d,
                        kseg, valid_n, stream);
}

int segmax_scan_topk_int8_launch(const void* q, const void* vecs, const void* q_scale,
                                 const void* row_scale, void* out_s, void* out_i, int nq,
                                 int nblocks, int block_size, int d, int kseg, int valid_n,
                                 void* stream) {
    return launch<I8>(q, vecs, q_scale, row_scale, out_s, out_i, nq, nblocks, block_size, d,
                      kseg, valid_n, stream);
}

}  // extern "C"
