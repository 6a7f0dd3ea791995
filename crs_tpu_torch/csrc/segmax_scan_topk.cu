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
// of f32 FMA on the CUDA cores at 67 TFLOP/s (TF32 would change the scores),
// 0.267 ms of bf16 on the tensor cores at 989 TFLOP/s and 0.133 ms of int8
// on them at 1,979 TOPS; the corpus, 1.5 GiB / 768 MiB / 384 MiB, is 0.48 /
// 0.24 / 0.12 ms at 3.35 TB/s. So f32 is bound by the FMA rate, bf16 and
// int8 by the tensor cores, with the corpus bytes close behind. (B is
// padded to 384, six tiles of 64: the kernels do 17 % more work.)
//
// F32 and BF16 (kernel 6) score through csrc/float_scan.cuh's passes, which
// kernel 2 shares, and I8 (kernel 7) through csrc/int8_scan.cuh's, which
// kernel 1 shares: one corpus pass per launch, a CTA scoring one corpus
// block against two query tiles; fp32 on FFMA with an 8 × 8 register tile
// per thread, bf16 on wgmma m64n256k16 fed by TMA, int8 on wgmma
// m64n256k32 s8 fed by TMA (any other D through the RAGGED staging). This
// file adds the epilogue. F32: lane l holds rows 4l..4l+3 of each of the
// chunk's two 128-row segments, so its part of a segment max is over 4
// contiguous rows, then a warp reduction. BF16 and I8: a thread holds, for
// each of its 2 query rows, columns 8j + 2t + {0,1} (t = lane % 4), so a
// 128-row segment is a thread-local (max, lowest row) over 32 values and
// two shfl_xor steps across the quad (I8 first turns its int32 dots into
// the scores in place, their f32 bits in the accumulator registers). No
// score tile passes through shared memory; each segment's (max, row) goes
// to a [segment][query] array for the picks: in shared memory up to
// MAX_SMEM_SEGMENTS segments, past that in a device-memory scratch of the
// caller's. (Measured alternatives for the fp32 pass, all slower at the
// main shape: TMA into a swizzled [row][dim] layout, whose operands need 32
// more registers and spill; 8 × 256 or 32 × 64 warp tiles at 256 threads;
// 3–4 stages.)
//
// Any D and any block_size that is a multiple of SEGMENT are taken: f32
// takes the RAGGED pass (dimensions past d and rows past the corpus
// zero-filled) when D is not a multiple of 32, the block ends in half a
// chunk or the segment winners go to the scratch; bf16 needs D a multiple of 8 (TMA's row stride; the caller
// zero-pads the corpus as kernel 2's does); int8 reads any D in place. A
// chunk that runs past its block's end (block_size an odd multiple of 128)
// scores the next block's rows, or zeros past the corpus, and its second
// segment is dropped: those rows never win a segment of this block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_topk.cuh"
#include "float_scan.cuh"
#include "int8_scan.cuh"

namespace {

using namespace fscan;

constexpr int SEGMENT = 128;     // rows per segment (a chunk holds two)
constexpr int MAX_SMEM_SEGMENTS = 64;  // past this, the segment winners go to device memory
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

// The segment winners' [nseg][TILE_Q] maxima, then rows: at `local` in
// shared memory, or this CTA's part of the caller's device scratch.
__device__ __forceinline__ float* segment_room(float* scratch, void* local, int nseg) {
    return scratch ? scratch + (size_t)blockIdx.x * nseg * TILE_Q * 2
                   : reinterpret_cast<float*>(local);
}

__host__ __device__ inline int segment_bytes(int block_size, bool in_smem) {
    return in_smem ? (block_size / SEGMENT) * TILE_Q * 8 : 0;
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

size_t f32_smem_bytes(int block_size, bool seg_smem) {
    return (size_t)F_PIPE_FLOATS * 4 + (size_t)segment_bytes(block_size, seg_smem);
}

template <bool RAGGED>
__global__ void __launch_bounds__(F_THREADS, 1)
segmax_f32_kernel(const float* __restrict__ q,      // [nq·QUERY_TILE, d]
                  const float* __restrict__ vecs,   // [nblocks·block_size, d]
                  float* __restrict__ out_s,        // [nq, nblocks, kseg, QUERY_TILE]
                  int* __restrict__ out_i, float* __restrict__ seg_scratch, int nq, int nblocks,
                  int block_size, int d, int kseg, int valid_n) {
    extern __shared__ __align__(16) float fsmem[];  // the staging, then the segment maxima
    const int nseg = block_size / SEGMENT;
    // [nseg][128]: the aligned instance keeps them in shared memory,
    // addressed as such; RAGGED wherever the launcher put them
    float* smax = RAGGED ? segment_room(seg_scratch, fsmem + F_PIPE_FLOATS, nseg)
                         : fsmem + F_PIPE_FLOATS;
    int* srow = reinterpret_cast<int*>(smax + nseg * TILE_Q);
    const int npairs = (nq + 1) / 2;
    const int pair = blockIdx.x % npairs;
    const int blk = blockIdx.x / npairs;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    // each scored chunk: its two segments' (max, lowest row) per query
    f32_scores<RAGGED>(q, vecs, fsmem, nq, pair, blk, block_size, d,
                       (long long)nblocks * block_size, [&](int c, float (&acc)[8][8]) {
        const long long grow0 = (long long)blk * block_size + (long long)c * CHUNK;
        const long long lim = (long long)valid_n - grow0;  // rows of the chunk below valid_n
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if (RAGGED && c * 2 + h >= nseg) break;  // past the block: the next block's rows
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
__host__ __device__ inline RingLayout bf16_layout(int d, int block_size, bool seg_smem) {
    return ring_layout(d, segment_bytes(block_size, seg_smem));
}

// A thread's (max, lowest column) over the 32 columns of one query row (r)
// and one segment (h) of the accumulator: d[4j + 2r + e] is column
// 8j + 2t + e of query row r; columns at or past `lim` score -1e30.
template <int H, int R, bool MASK, typename A>
__device__ __forceinline__ void acc_segment_best(const A (&d)[128], int t, int lim, float& best,
                                                 int& bcol) {
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int j = 16 * H + jj;
            const int col = 8 * j + 2 * t + e;
            float v = block_topk::acc_score(d[4 * j + 2 * R + e]);
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

template <bool MASK, typename A>
__device__ __forceinline__ void acc_segments(const A (&d)[128], int t, int lim,
                                             float (&bm)[2][2], int (&bc)[2][2]) {
    acc_segment_best<0, 0, MASK>(d, t, lim, bm[0][0], bc[0][0]);
    acc_segment_best<0, 1, MASK>(d, t, lim, bm[0][1], bc[0][1]);
    acc_segment_best<1, 0, MASK>(d, t, lim, bm[1][0], bc[1][0]);
    acc_segment_best<1, 1, MASK>(d, t, lim, bm[1][1], bc[1][1]);
}

// Thread t of the quad stores (segment h = t & 1, query row r = t >> 1) of
// the chunk's two segments; a segment past the block (a half chunk) is not
// stored.
__device__ __forceinline__ void store_segments(const float (&bm)[2][2], const int (&bc)[2][2],
                                               int t, int c, int nseg, long long grow0, int qa,
                                               float* smax, int* srow) {
    const int h = t & 1, r = t >> 1;
    if (c * 2 + h >= nseg) return;
    const float v = r ? (h ? bm[1][1] : bm[0][1]) : (h ? bm[1][0] : bm[0][0]);
    const int col = r ? (h ? bc[1][1] : bc[0][1]) : (h ? bc[1][0] : bc[0][0]);
    const int s = (c * 2 + h) * TILE_Q + qa + 8 * r;
    smax[s] = v;
    srow[s] = (int)grow0 + col;
}

// After the consumers' segments: each of the CTA's (one or two) tiles' picks.
__device__ __forceinline__ void emit_pair(float* smax, const int* srow, int pair, int nq,
                                          int nblocks, int blk, int nseg, int kseg,
                                          float* __restrict__ out_s, int* __restrict__ out_i) {
    asm volatile("bar.sync 1, %0;\n" ::"n"(B_CONSUMERS * 128) : "memory");
    const int tid = threadIdx.x;
    if (tid < TILE_Q) {
        const int tile = pair * 2 + tid / QUERY_TILE;
        if (tile < nq)
            emit_picks(smax, srow, TILE_Q, tid, nseg, kseg, out_s, out_i,
                       ((long long)tile * nblocks + blk) * kseg * QUERY_TILE + tid % QUERY_TILE);
    }
}

template <bool RESIDENT>
__global__ void __launch_bounds__(B_THREADS, 1)
segmax_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,  // [nq·64, d] bf16, box 64 × 128
                   const __grid_constant__ CUtensorMap tm_v,  // [N, d] bf16, box 64 × 256
                   float* __restrict__ out_s, int* __restrict__ out_i,
                   float* __restrict__ seg_scratch, int nq, int nblocks, int block_size, int d,
                   int kseg, int valid_n) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = aligned_smem(smem_raw);
    const RingLayout L = bf16_layout(d, block_size, seg_scratch == nullptr);
    const int nseg = block_size / SEGMENT;
    float* smax = segment_room(seg_scratch, smem + L.extra, nseg);  // [nseg][128]
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
            store_segments(bm, bc, t, c, nseg, grow0, qa, smax, srow);
        });
    if (consumer) emit_pair(smax, srow, pair, nq, nblocks, blk, nseg, kseg, out_s, out_i);
}

// ---- I8: segment maxima from the int8 accumulators (kernel 7) -------------------

__host__ __device__ inline RingLayout i8_layout(int d, int block_size, bool seg_smem) {
    return i8scan::layout(d, segment_bytes(block_size, seg_smem));
}

// The chunk's scores in place, (f32(acc)·q_scale)·row_scale with each
// product rounded alone, -1e30 at columns ≥ lim; segment h only (a half
// chunk's second segment is past the block, and past the corpus for the
// last block: its row scales are not read).
template <int H, bool MASK>
__device__ __forceinline__ void i8_segment_scores(int (&acc)[128], const float* row_scale,
                                                  float qs0, float qs1, int t, int lim) {
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
        const int j = 16 * H + jj;
        const float2 rs = *reinterpret_cast<const float2*>(row_scale + 8 * j + 2 * t);
        const float sc[2] = {rs.x, rs.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const bool live = !MASK || 8 * j + 2 * t + e < lim;
            const float s0 = __fmul_rn(__fmul_rn((float)acc[4 * j + e], qs0), sc[e]);
            const float s1 = __fmul_rn(__fmul_rn((float)acc[4 * j + 2 + e], qs1), sc[e]);
            acc[4 * j + e] = __float_as_int(live ? s0 : NEG_INF);
            acc[4 * j + 2 + e] = __float_as_int(live ? s1 : NEG_INF);
        }
    }
}

template <bool RESIDENT, bool RAGGED>
__global__ void __launch_bounds__(i8scan::THREADS, 1)
segmax_i8_kernel(const __grid_constant__ CUtensorMap tm_q,  // [nq·64, dq] int8, box 128 × 128
                 const __grid_constant__ CUtensorMap tm_v,  // [N, d] int8, box 128 × 256 (TMA)
                 const int8_t* __restrict__ codes,          // [N, d] (RAGGED)
                 const float* __restrict__ q_scale,         // [nq·QUERY_TILE]
                 const float* __restrict__ row_scale,       // [N]
                 float* __restrict__ out_s, int* __restrict__ out_i,
                 float* __restrict__ seg_scratch, int nq, int nblocks, int block_size, int d,
                 int kseg, int valid_n) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = aligned_smem(smem_raw);
    const RingLayout L = i8_layout(d, block_size, seg_scratch == nullptr);
    const int nseg = block_size / SEGMENT;
    float* smax = segment_room(seg_scratch, smem + i8scan::epilogue_offset(L, d), nseg);
    int* srow = reinterpret_cast<int*>(smax + nseg * TILE_Q);
    const int npairs = (nq + 1) / 2;
    const int pair = blockIdx.x % npairs;
    const int blk = blockIdx.x / npairs;
    const long long row0 = (long long)blk * block_size;
    const bool consumer = i8scan::i8_scores<RESIDENT, RAGGED>(
        &tm_q, &tm_v, codes, (long long)nblocks * block_size, smem, L, pair,
        [=](int c) { return row0 + (long long)c * CHUNK; }, (block_size + CHUNK - 1) / CHUNK, d,
        [&](int c, int (&acc)[128], int wg, int t, int qa) {
            const long long grow0 = row0 + (long long)c * CHUNK;
            const long long lim_ll = (long long)valid_n - grow0;
            const int lim = lim_ll < 0 ? 0 : lim_ll > CHUNK ? CHUNK : (int)lim_ll;
            // query rows past the last tile (an odd tile count) have no scale
            const int qrow = pair * TILE_Q + qa;
            const float qs0 = qrow < nq * QUERY_TILE ? q_scale[qrow] : 0.0f;
            const float qs1 = qrow + 8 < nq * QUERY_TILE ? q_scale[qrow + 8] : 0.0f;
            const float* rs = row_scale + grow0;
            if (lim == CHUNK) {
                i8_segment_scores<0, false>(acc, rs, qs0, qs1, t, lim);
            } else {
                i8_segment_scores<0, true>(acc, rs, qs0, qs1, t, lim);
            }
            const bool second = c * 2 + 1 < nseg;
            if (second) {
                if (lim == CHUNK)
                    i8_segment_scores<1, false>(acc, rs, qs0, qs1, t, lim);
                else
                    i8_segment_scores<1, true>(acc, rs, qs0, qs1, t, lim);
            }
            float bm[2][2];
            int bc[2][2];
            acc_segment_best<0, 0, false>(acc, t, lim, bm[0][0], bc[0][0]);
            acc_segment_best<0, 1, false>(acc, t, lim, bm[0][1], bc[0][1]);
            if (second) {
                acc_segment_best<1, 0, false>(acc, t, lim, bm[1][0], bc[1][0]);
                acc_segment_best<1, 1, false>(acc, t, lim, bm[1][1], bc[1][1]);
            }
            store_segments(bm, bc, t, c, nseg, grow0, qa, smax, srow);
        });
    if (consumer) emit_pair(smax, srow, pair, nq, nblocks, blk, nseg, kseg, out_s, out_i);
}

// ---- launchers ------------------------------------------------------------------

int launch_f32(const void* q, const void* vecs, void* out_s, void* out_i, float* scratch, int nq,
               int nblocks, int block_size, int d, int kseg, int valid_n, cudaStream_t stream) {
    const size_t smem = f32_smem_bytes(block_size, scratch == nullptr);
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    auto kernel = d % F_KC || block_size % CHUNK || scratch ? segmax_f32_kernel<true>
                                                             : segmax_f32_kernel<false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return refused(err);
    kernel<<<(unsigned)((nq + 1) / 2) * (unsigned)nblocks, F_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(vecs), static_cast<float*>(out_s),
        static_cast<int*>(out_i), scratch, nq, nblocks, block_size, d, kseg, valid_n);
    return (int)cudaGetLastError();
}

template <bool RESIDENT>
int launch_bf16_as(const CUtensorMap& tq, const CUtensorMap& tv, void* out_s, void* out_i,
                   float* scratch, int nq, int nblocks, int block_size, int d, int kseg,
                   int valid_n, cudaStream_t stream) {
    const size_t smem = ring_bytes(bf16_layout(d, block_size, scratch == nullptr));
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(segmax_bf16_kernel<RESIDENT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return refused(err);
    const unsigned grid = (unsigned)((nq + 1) / 2) * (unsigned)nblocks;
    segmax_bf16_kernel<RESIDENT><<<grid, B_THREADS, smem, stream>>>(
        tq, tv, static_cast<float*>(out_s), static_cast<int*>(out_i), scratch, nq, nblocks,
        block_size, d, kseg, valid_n);
    return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* vecs, void* out_s, void* out_i, float* scratch, int nq,
                int nblocks, int block_size, int d, int kseg, int valid_n, cudaStream_t stream) {
    if (d % 8) return (int)cudaErrorInvalidValue;
    CUtensorMap tq, tv;
    int err = encode_bf16_map(&tq, q, (long long)nq * QUERY_TILE, d, TILE_Q);
    if (err) return err;
    err = encode_bf16_map(&tv, vecs, (long long)nblocks * block_size, d, CHUNK);
    if (err) return err;
    if (bf16_layout(d, block_size, scratch == nullptr).a_bytes > 0)
        return launch_bf16_as<true>(tq, tv, out_s, out_i, scratch, nq, nblocks, block_size, d,
                                    kseg, valid_n, stream);
    return launch_bf16_as<false>(tq, tv, out_s, out_i, scratch, nq, nblocks, block_size, d, kseg,
                                 valid_n, stream);
}

template <bool RESIDENT, bool RAGGED>
int launch_i8_as(const CUtensorMap& tq, const CUtensorMap& tv, const void* vecs,
                 const void* q_scale, const void* row_scale, void* out_s, void* out_i,
                 float* scratch, int nq, int nblocks, int block_size, int d, int kseg,
                 int valid_n, cudaStream_t stream) {
    const size_t smem = ring_bytes(i8_layout(d, block_size, scratch == nullptr));
    auto kernel = segmax_i8_kernel<RESIDENT, RAGGED>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return refused(err);
    const unsigned grid = (unsigned)((nq + 1) / 2) * (unsigned)nblocks;
    kernel<<<grid, i8scan::THREADS, smem, stream>>>(
        tq, tv, static_cast<const int8_t*>(vecs), static_cast<const float*>(q_scale),
        static_cast<const float*>(row_scale), static_cast<float*>(out_s),
        static_cast<int*>(out_i), scratch, nq, nblocks, block_size, d, kseg, valid_n);
    return (int)cudaGetLastError();
}

int launch_i8(const void* q, const void* vecs, const void* q_scale, const void* row_scale,
              void* out_s, void* out_i, float* scratch, int nq, int nblocks, int block_size, int d,
              int kseg, int valid_n, cudaStream_t stream) {
    const RingLayout L = i8_layout(d, block_size, scratch == nullptr);
    if (ring_bytes(L) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    CUtensorMap tq, tv;
    const int dq = (d + i8scan::Q_MULTIPLE - 1) / i8scan::Q_MULTIPLE * i8scan::Q_MULTIPLE;
    int err = encode_i8_map(&tq, q, (long long)nq * QUERY_TILE, dq, TILE_Q);
    if (err) return err;
    const bool rag = i8scan::ragged(d);
    if (!rag) {
        err = encode_i8_map(&tv, vecs, (long long)nblocks * block_size, d, CHUNK);
        if (err) return err;
    } else {
        tv = tq;  // not read: the RAGGED route stages the corpus by cp.async
    }
#define SEGMAX_I8(R, G)                                                                        \
    launch_i8_as<R, G>(tq, tv, vecs, q_scale, row_scale, out_s, out_i, scratch, nq, nblocks,   \
                       block_size, d, kseg, valid_n, stream)
    if (L.a_bytes > 0) return rag ? SEGMAX_I8(true, true) : SEGMAX_I8(true, false);
    return rag ? SEGMAX_I8(false, true) : SEGMAX_I8(false, false);
#undef SEGMAX_I8
}

bool shape_ok(int nq, int nblocks, int block_size, int d, int kseg) {
    return nq >= 1 && nblocks >= 1 && block_size >= SEGMENT && block_size % SEGMENT == 0 &&
           kseg >= 1 && kseg <= block_size / SEGMENT && d >= 1 &&
           (long long)nblocks * block_size < (1LL << 31);
}

}  // namespace

extern "C" {

int segmax_scan_topk_chunk_rows() { return CHUNK; }
int segmax_scan_topk_query_tile() { return QUERY_TILE; }
int segmax_scan_topk_segment_rows() { return SEGMENT; }
int segmax_scan_topk_max_smem_segments() { return MAX_SMEM_SEGMENTS; }

// Dynamic shared memory of one CTA (mode 0 f32, 1 bf16, 2 int8) at (d,
// block_size) with the segment winners in shared memory, and whether the
// bf16 / int8 kernel keeps its queries resident.
int segmax_scan_topk_smem_bytes(int mode, int d, int block_size) {
    if (mode == 0) return (int)f32_smem_bytes(block_size, true);
    if (mode == 1) return ring_bytes(bf16_layout(d, block_size, true));
    return ring_bytes(i8_layout(d, block_size, true));
}
int segmax_scan_topk_queries_resident(int mode, int d, int block_size) {
    return (mode == 1 ? bf16_layout(d, block_size, true) : i8_layout(d, block_size, true))
                       .a_bytes > 0 ? 1 : 0;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success),
// or for bf16 / int8 the CUresult of a failed tensor-map encode. The caller
// checks shapes: query rows = nq·QUERY_TILE (int8: ⌈d/16⌉·16 bytes wide,
// zero past d), corpus rows = nblocks·block_size, block_size a multiple of
// SEGMENT, 1 <= kseg <= block_size / SEGMENT, d >= 1 (bf16: d % 8 == 0),
// 16-byte aligned pointers. seg_scratch: null keeps the segment winners in
// shared memory (up to MAX_SMEM_SEGMENTS segments); else [grid][nseg][128]
// f32 + int32 of device memory, the grid being ⌈nq/2⌉·nblocks CTAs. The
// scale pointers are read by the int8 kernel only.
int segmax_scan_topk_f32_launch(const void* q, const void* vecs, const void* q_scale,
                                const void* row_scale, void* out_s, void* out_i,
                                void* seg_scratch, int nq, int nblocks, int block_size, int d,
                                int kseg, int valid_n, void* stream) {
    if (!shape_ok(nq, nblocks, block_size, d, kseg)) return (int)cudaErrorInvalidValue;
    return launch_f32(q, vecs, out_s, out_i, static_cast<float*>(seg_scratch), nq, nblocks,
                      block_size, d, kseg, valid_n, (cudaStream_t)stream);
}

int segmax_scan_topk_bf16_launch(const void* q, const void* vecs, const void* q_scale,
                                 const void* row_scale, void* out_s, void* out_i,
                                 void* seg_scratch, int nq, int nblocks, int block_size, int d,
                                 int kseg, int valid_n, void* stream) {
    if (!shape_ok(nq, nblocks, block_size, d, kseg)) return (int)cudaErrorInvalidValue;
    return launch_bf16(q, vecs, out_s, out_i, static_cast<float*>(seg_scratch), nq, nblocks,
                       block_size, d, kseg, valid_n, (cudaStream_t)stream);
}

int segmax_scan_topk_int8_launch(const void* q, const void* vecs, const void* q_scale,
                                 const void* row_scale, void* out_s, void* out_i,
                                 void* seg_scratch, int nq, int nblocks, int block_size, int d,
                                 int kseg, int valid_n, void* stream) {
    if (!shape_ok(nq, nblocks, block_size, d, kseg)) return (int)cudaErrorInvalidValue;
    return launch_i8(q, vecs, q_scale, row_scale, out_s, out_i, static_cast<float*>(seg_scratch),
                     nq, nblocks, block_size, d, kseg, valid_n, (cudaStream_t)stream);
}

}  // extern "C"
