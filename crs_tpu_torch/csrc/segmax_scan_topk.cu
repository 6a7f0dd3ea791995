// Segment-max scans (approximate, one winner per 128-row segment), for
// Hopper (sm_90a): f32, bf16 and int8 corpora.
//
// Replaces two TPU kernels of crs_tpu/ops/pallas_scan.py:
//   F32 / BF16 (kernel 6): pallas_topk_segmax → _scan_kernel_segmax
//   I8 (kernel 7):         pallas_topk_segmax_int8 → _scan_kernel_segmax_int8
// For each query tile of QUERY_TILE queries and each corpus block of
// block_size rows:
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
// What bounds it on an H100 at the main path's shape (N = 1,048,576, D =
// 384, B = 328 queries): the work, 2·B·N·D = 2.64e11 operations, is 3.94 ms
// of f32 FMA on the CUDA cores at 67 TFLOP/s (TF32 would change the scores)
// and 0.267 ms of bf16 on the tensor cores at 989 TFLOP/s; the corpus, 1.5
// GiB / 768 MiB, is 0.48 / 0.24 ms at 3.35 TB/s. So f32 is bound by the
// FMA rate and bf16 by the tensor cores, with the corpus bytes close behind.
// (B is padded to 384, six tiles of 64: the kernels do 17 % more work.)
//
// F32 and BF16 (kernel 6) score through csrc/float_scan.cuh's passes, which
// kernel 2 shares: one corpus pass per launch, a CTA scoring one corpus
// block against two query tiles; fp32 on FFMA with an 8 × 8 register tile
// per thread, bf16 on wgmma m64n256k16 fed by TMA. This file adds the
// epilogue. F32: lane l holds rows 4l..4l+3 of each of the chunk's two
// 128-row segments, so its part of a segment max is over 4 contiguous rows,
// then a warp reduction. BF16: a thread holds, for each of its 2 query
// rows, columns 8j + 2t + {0,1} (t = lane % 4), so a 128-row segment is a
// thread-local (max, lowest row) over 32 values and two shfl_xor steps
// across the quad. No score tile passes through shared memory; each
// segment's (max, row) goes to a small [segment][query] array for the
// picks. (Measured alternatives for the fp32 pass, all slower at the main
// shape: TMA into a swizzled [row][dim] layout, whose operands need 32 more
// registers and spill; 8 × 256 or 32 × 64 warp tiles at 256 threads; 3–4
// stages.)
//
// I8 (kernel 7): unchanged from its first port. One CUDA block per (corpus
// block, query tile of 64), 256 threads; lane l holds rows l, l+32, ...,
// l+224 of a 256-row chunk; the query tile's codes stay in shared memory
// and __dp4a scores 16 words of each row per stage; lane s of a warp keeps
// segment s's winner, the picks are warp arg-max reductions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "float_scan.cuh"

namespace {

using namespace fscan;

constexpr int SEGMENT = 128;     // rows per segment (a chunk holds two)
constexpr int MAX_SEGMENTS = 32;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// ---- shared pieces ----------------------------------------------------------

// (value, row) ← the better of itself and (ov, orow): the larger value, the
// lower row among equal values.
__device__ __forceinline__ void take_better(float& v, int& row, float ov, int orow) {
    if (ov > v || (ov == v && orow < row)) {
        v = ov;
        row = orow;
    }
}

// One query's kseg picks over its nseg segment winners, kept in shared
// memory [segment][stride] (column q): the largest max, the lowest segment
// among equal maxima; the picked max is set to -1e30 and its row kept.
__device__ __forceinline__ void emit_picks(float* smax, const int* srow, int stride, int q,
                                           int nseg, int kseg, float* __restrict__ out_s,
                                           int* __restrict__ out_i, long long o) {
    for (int p = 0; p < kseg; ++p) {
        float best = smax[q];
        int bs = 0;
        for (int s = 1; s < nseg; ++s) {
            const float m = smax[s * stride + q];
            if (m > best) {
                best = m;
                bs = s;
            }
        }
        out_s[o + (long long)p * QUERY_TILE] = best;
        out_i[o + (long long)p * QUERY_TILE] = srow[bs * stride + q];
        smax[bs * stride + q] = NEG_INF;
    }
}

// ---- F32: segment maxima from the FFMA tiles ----------------------------------------

size_t f32_smem_bytes(int block_size) {
    return (size_t)F_PIPE_FLOATS * 4 + (size_t)(block_size / SEGMENT) * TILE_Q * 8;
}

__global__ void __launch_bounds__(F_THREADS, 1)
segmax_f32_kernel(const float* __restrict__ q,      // [nq·QUERY_TILE, d]
                  const float* __restrict__ vecs,   // [nblocks·block_size, d]
                  float* __restrict__ out_s,        // [nq, nblocks, kseg, QUERY_TILE]
                  int* __restrict__ out_i, int nq, int nblocks, int block_size, int d,
                  int kseg, int valid_n) {
    extern __shared__ __align__(16) float fsmem[];  // the staging, then the segment maxima
    const int nseg = block_size / SEGMENT;
    float* smax = fsmem + F_PIPE_FLOATS;  // [nseg][128]
    int* srow = reinterpret_cast<int*>(smax + nseg * TILE_Q);
    const int npairs = (nq + 1) / 2;
    const int pair = blockIdx.x % npairs;
    const int blk = blockIdx.x / npairs;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    // each scored chunk: its two segments' (max, lowest row) per query
    f32_scores<false>(q, vecs, fsmem, nq, pair, blk, block_size, d,
                      [&](int c, float (&acc)[8][8]) {
        const long long grow0 = (long long)blk * block_size + (long long)c * CHUNK;
        const long long lim = (long long)valid_n - grow0;  // rows of the chunk below valid_n
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                float best = NEG_INF;
                int brow = 0;
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                    const int row = SEGMENT * h + 4 * lane + jj;
                    const float v = row < lim ? acc[i][4 * h + jj] : NEG_INF;
                    if (jj == 0 || v > best) {  // rows ascend: strict > keeps the lowest
                        best = v;
                        brow = row;
                    }
                }
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    take_better(best, brow, __shfl_xor_sync(FULL, best, off),
                                __shfl_xor_sync(FULL, brow, off));
                if (lane == i) {
                    const int s = (c * 2 + h) * TILE_Q + warp * 8 + i;
                    smax[s] = best;
                    srow[s] = (int)grow0 + brow;
                }
            }
        }
    });
    __syncthreads();
    if (tid < TILE_Q) {
        const int tile = pair * 2 + tid / QUERY_TILE;
        if (tile < nq)
            emit_picks(smax, srow, TILE_Q, tid, nseg, kseg, out_s, out_i,
                       ((long long)tile * nblocks + blk) * kseg * QUERY_TILE + tid % QUERY_TILE);
    }
}

// ---- BF16: segment maxima from the accumulators ---------------------------------------

// the segment maxima's room: [nseg][TILE_Q] maxima, then rows
__host__ __device__ inline RingLayout bf16_layout(int d, int block_size) {
    return ring_layout(d, (block_size / SEGMENT) * TILE_Q * 8);
}

// A thread's (max, lowest column) over the 32 columns of one query row (r)
// and one segment (h) of the accumulator: d[4j + 2r + e] is column
// 8j + 2t + e of query row r; columns at or past `lim` score -1e30.
template <int H, int R, bool MASK>
__device__ __forceinline__ void acc_segment_best(const float (&d)[128], int t, int lim,
                                                 float& best, int& bcol) {
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int j = 16 * H + jj;
            const int col = 8 * j + 2 * t + e;
            float v = d[4 * j + 2 * R + e];
            if (MASK && col >= lim) v = NEG_INF;
            if ((jj == 0 && e == 0) || v > best) {  // columns ascend: strict > keeps the lowest
                best = v;
                bcol = col;
            }
        }
    }
    take_better(best, bcol, __shfl_xor_sync(FULL, best, 1), __shfl_xor_sync(FULL, bcol, 1));
    take_better(best, bcol, __shfl_xor_sync(FULL, best, 2), __shfl_xor_sync(FULL, bcol, 2));
}

template <bool MASK>
__device__ __forceinline__ void acc_segments(const float (&d)[128], int t, int lim,
                                             float (&bm)[2][2], int (&bc)[2][2]) {
    acc_segment_best<0, 0, MASK>(d, t, lim, bm[0][0], bc[0][0]);
    acc_segment_best<0, 1, MASK>(d, t, lim, bm[0][1], bc[0][1]);
    acc_segment_best<1, 0, MASK>(d, t, lim, bm[1][0], bc[1][0]);
    acc_segment_best<1, 1, MASK>(d, t, lim, bm[1][1], bc[1][1]);
}

template <bool RESIDENT>
__global__ void __launch_bounds__(B_THREADS, 1)
segmax_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,  // [nq·64, d] bf16, box 64 × 128
                   const __grid_constant__ CUtensorMap tm_v,  // [N, d] bf16, box 64 × 256
                   float* __restrict__ out_s, int* __restrict__ out_i, int nq, int nblocks,
                   int block_size, int d, int kseg, int valid_n) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = aligned_smem(smem_raw);
    const RingLayout L = bf16_layout(d, block_size);
    const int nseg = block_size / SEGMENT;
    float* smax = reinterpret_cast<float*>(smem + L.extra);  // [nseg][128]
    int* srow = reinterpret_cast<int*>(smax + nseg * TILE_Q);
    const int npairs = (nq + 1) / 2;
    const int pair = blockIdx.x % npairs;
    const int blk = blockIdx.x / npairs;
    const bool consumer = bf16_scores<RESIDENT>(
        &tm_q, &tm_v, smem, L, pair, blk, block_size, d,
        [&](int c, float (&acc)[128], int wg, int t, int qa) {
            // the chunk's two segments, straight from the accumulators
            const long long grow0 = (long long)blk * block_size + (long long)c * CHUNK;
            const long long lim_ll = (long long)valid_n - grow0;
            float bm[2][2];
            int bc[2][2];
            if (lim_ll >= CHUNK) {
                acc_segments<false>(acc, t, CHUNK, bm, bc);
            } else {
                acc_segments<true>(acc, t, lim_ll < 0 ? 0 : (int)lim_ll, bm, bc);
            }
            // thread t of the quad stores (segment h = t & 1, query row r = t >> 1)
            const int h = t & 1, r = t >> 1;
            const float v = r ? (h ? bm[1][1] : bm[0][1]) : (h ? bm[1][0] : bm[0][0]);
            const int col = r ? (h ? bc[1][1] : bc[0][1]) : (h ? bc[1][0] : bc[0][0]);
            const int s = (c * 2 + h) * TILE_Q + qa + 8 * r;
            smax[s] = v;
            srow[s] = (int)grow0 + col;
        });
    if (!consumer) return;
    asm volatile("bar.sync 1, %0;\n" ::"n"(B_CONSUMERS * 128) : "memory");
    const int tid = threadIdx.x;
    if (tid < TILE_Q) {
        const int tile = pair * 2 + tid / QUERY_TILE;
        if (tile < nq)
            emit_picks(smax, srow, TILE_Q, tid, nseg, kseg, out_s, out_i,
                       ((long long)tile * nblocks + blk) * kseg * QUERY_TILE + tid % QUERY_TILE);
    }
}

// ---- I8: __dp4a, the first port's design (kernel 7) ----------------------------

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int Q_PER_WARP = QUERY_TILE / WARPS;  // 8
constexpr int ROWS_PER_LANE = CHUNK / 32;       // 8
constexpr int SEG_LANES = SEGMENT / 32;         // 4 values per lane per segment
constexpr int KCHUNK_WORDS = 16;                // int8: 64 bytes of each row per stage

size_t i8_smem_bytes(int d) {
    return (size_t)d * QUERY_TILE + (size_t)KCHUNK_WORDS * CHUNK * 4;
}

// int32 dots by __dp4a over the query tile's words [word][query] (in shared
// memory for the whole block) and the chunk's words staged [word][row]
// KCHUNK_WORDS at a time; then the two rounded products.
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

__global__ void __launch_bounds__(THREADS)
segmax_i8_kernel(const int8_t* __restrict__ q_,         // [nq·QUERY_TILE, d]
                 const int8_t* __restrict__ vecs_,      // [nblocks·block_size, d]
                 const float* __restrict__ q_scale,     // [nq·QUERY_TILE]
                 const float* __restrict__ row_scale,   // [nblocks·block_size]
                 float* __restrict__ out_s,             // [nq, nblocks, kseg, QUERY_TILE]
                 int* __restrict__ out_i,
                 int nblocks, int block_size, int d, int kseg, int valid_n) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int blk = blockIdx.x;
    const int iq = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long q_off = (long long)iq * QUERY_TILE * d;

    int* qw = reinterpret_cast<int*>(smem);          // [d/4][QUERY_TILE] words
    int* cs_i8 = qw + (d / 4) * QUERY_TILE;          // [KCHUNK_WORDS][CHUNK] words
    {  // the query tile's codes → shared memory, 16 bytes per load
        const int segs = d / 16;
        const int4* src = reinterpret_cast<const int4*>(q_ + q_off);
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
        score_i8(s, qw, vecs_ + row0 * d, q_scale + (long long)iq * QUERY_TILE, row_scale + row0,
                 d, cs_i8, tid, lane, warp);
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
                for (int off = 16; off > 0; off >>= 1)
                    take_better(best, brow, __shfl_xor_sync(FULL, best, off),
                                __shfl_xor_sync(FULL, brow, off));
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
            for (int off = 16; off > 0; off >>= 1)
                take_better(best, bl, __shfl_xor_sync(FULL, best, off),
                            __shfl_xor_sync(FULL, bl, off));
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

// ---- launchers ------------------------------------------------------------------

int launch_f32(const void* q, const void* vecs, void* out_s, void* out_i, int nq, int nblocks,
               int block_size, int d, int kseg, int valid_n, cudaStream_t stream) {
    const size_t smem = f32_smem_bytes(block_size);
    cudaError_t err = cudaFuncSetAttribute(segmax_f32_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return refused(err);
    segmax_f32_kernel<<<(unsigned)((nq + 1) / 2) * (unsigned)nblocks, F_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(vecs), static_cast<float*>(out_s),
        static_cast<int*>(out_i), nq, nblocks, block_size, d, kseg, valid_n);
    return (int)cudaGetLastError();
}

template <bool RESIDENT>
int launch_bf16_as(const CUtensorMap& tq, const CUtensorMap& tv, void* out_s, void* out_i,
                   int nq, int nblocks, int block_size, int d, int kseg, int valid_n,
                   cudaStream_t stream) {
    const size_t smem = ring_bytes(bf16_layout(d, block_size));
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(segmax_bf16_kernel<RESIDENT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return refused(err);
    const unsigned grid = (unsigned)((nq + 1) / 2) * (unsigned)nblocks;
    segmax_bf16_kernel<RESIDENT><<<grid, B_THREADS, smem, stream>>>(
        tq, tv, static_cast<float*>(out_s), static_cast<int*>(out_i), nq, nblocks, block_size, d,
        kseg, valid_n);
    return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* vecs, void* out_s, void* out_i, int nq, int nblocks,
                int block_size, int d, int kseg, int valid_n, cudaStream_t stream) {
    CUtensorMap tq, tv;
    int err = encode_bf16_map(&tq, q, (long long)nq * QUERY_TILE, d, TILE_Q);
    if (err) return err;
    err = encode_bf16_map(&tv, vecs, (long long)nblocks * block_size, d, CHUNK);
    if (err) return err;
    if (bf16_layout(d, block_size).a_bytes > 0)
        return launch_bf16_as<true>(tq, tv, out_s, out_i, nq, nblocks, block_size, d, kseg,
                                    valid_n, stream);
    return launch_bf16_as<false>(tq, tv, out_s, out_i, nq, nblocks, block_size, d, kseg, valid_n,
                                 stream);
}

int launch_i8(const void* q, const void* vecs, const void* q_scale, const void* row_scale,
              void* out_s, void* out_i, int nq, int nblocks, int block_size, int d, int kseg,
              int valid_n, cudaStream_t stream) {
    const size_t smem = i8_smem_bytes(d);
    cudaError_t err = cudaFuncSetAttribute(segmax_i8_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return refused(err);
    const dim3 grid((unsigned)nblocks, (unsigned)nq);
    segmax_i8_kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(vecs),
        static_cast<const float*>(q_scale), static_cast<const float*>(row_scale),
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

// Dynamic shared memory of one CTA (mode 0 f32, 1 bf16, 2 int8) at (d,
// block_size), and whether the bf16 kernel keeps its queries resident.
int segmax_scan_topk_smem_bytes(int mode, int d, int block_size) {
    if (mode == 0) return (int)f32_smem_bytes(block_size);
    if (mode == 1) return ring_bytes(bf16_layout(d, block_size));
    return (int)i8_smem_bytes(d);
}
int segmax_scan_topk_bf16_queries_resident(int d, int block_size) {
    return bf16_layout(d, block_size).a_bytes > 0 ? 1 : 0;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success),
// or for bf16 the CUresult of a failed tensor-map encode. The caller checks
// shapes: query rows = nq·QUERY_TILE, corpus rows = nblocks·block_size,
// block_size a multiple of CHUNK and at most MAX_SEGMENTS·SEGMENT, 1 <=
// kseg <= block_size / SEGMENT, d % 32 == 0 (f32 / bf16) or d % 16 == 0
// (int8), d <= 4096, 16-byte aligned pointers. The scale pointers are read
// by the int8 kernel only.
int segmax_scan_topk_f32_launch(const void* q, const void* vecs, const void* q_scale,
                                const void* row_scale, void* out_s, void* out_i, int nq,
                                int nblocks, int block_size, int d, int kseg, int valid_n,
                                void* stream) {
    return launch_f32(q, vecs, out_s, out_i, nq, nblocks, block_size, d, kseg, valid_n,
                      (cudaStream_t)stream);
}

int segmax_scan_topk_bf16_launch(const void* q, const void* vecs, const void* q_scale,
                                 const void* row_scale, void* out_s, void* out_i, int nq,
                                 int nblocks, int block_size, int d, int kseg, int valid_n,
                                 void* stream) {
    return launch_bf16(q, vecs, out_s, out_i, nq, nblocks, block_size, d, kseg, valid_n,
                       (cudaStream_t)stream);
}

int segmax_scan_topk_int8_launch(const void* q, const void* vecs, const void* q_scale,
                                 const void* row_scale, void* out_s, void* out_i, int nq,
                                 int nblocks, int block_size, int d, int kseg, int valid_n,
                                 void* stream) {
    return launch_i8(q, vecs, q_scale, row_scale, out_s, out_i, nq, nblocks, block_size, d, kseg,
                     valid_n, (cudaStream_t)stream);
}

}  // extern "C"
