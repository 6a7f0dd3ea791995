// int8 scan with per-block top-kb, for Hopper (sm_90a).
//
// Replaces the TPU kernel crs_tpu/ops/pallas_scan.py:pallas_topk_int8 /
// _scan_kernel_int8 (with _extract_block_topk). For each query tile of
// QUERY_TILE queries and each corpus block of block_size rows:
//   acc = q_codes · codes_blockᵀ                (int8 × int8 → int32, exact)
//   s   = __fadd_rn(__fmul_rn(f32(acc), row_scale), bias)   (bias 0, or
//         -1e30 for padding and rows the `where` mask drops)
//   kb times: the max, the lowest global id among equal maxima, that entry
//   set to -1e30 (it stays a candidate under its id, so a block with no
//   allowed rows left re-emits its lowest id at -1e30).
// Partials go to out_s / out_i laid out [nq, nblocks, kb, QUERY_TILE], the
// JAX kernel's layout. The per-query scale is applied by the caller.
//
// What bounds it on an H100: at N = 1,048,576, D = 384, B = 328 the corpus is
// ~403 MB (~0.12 ms at 3.35 TB/s) and the work 2·B·N·D ≈ 2.6e11 int8
// operations (~0.13 ms at 1,979 TOPS on the tensor cores), so the bound is
// about 0.13 ms a batch. (B is padded to 384, six tiles of 64: the kernel
// does 17 % more work.)
//
// Design: the scoring pass is csrc/int8_scan.cuh's, which kernel 7 shares:
// wgmma m64n256k32 s8 on a TMA-fed ring (any other D through the RAGGED
// staging), one corpus pass per launch, a CTA scoring its rows against two
// query tiles. This file adds the epilogue, a running top-kb per (query,
// block): the int32 dots become scores in place in the accumulator registers
// (their f32 bits), and block_topk::merge_row folds each 256-row chunk into
// the query row's list by kb arg-max passes over (chunk ∪ list), a quad of
// threads holding the row's 256 columns (kernel 2's bf16 epilogue). The list
// is double-buffered in shared memory; a chunk whose scores all lie at or
// below the list's kb-th entry leaves it as it is. Any block_size >= 1 is
// taken: a block is ⌈block_size / 256⌉ chunks from its first row, and the
// columns of its last chunk past the block's end (rows of the next block,
// or past the corpus) score -1e30 and never win. A CTA walks SPAN_CHUNKS
// chunks (whole blocks, at least one) so that its queries' load and its
// ring's fill are shared by several chunks, and writes each block's list to
// the partials when the block ends.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_topk.cuh"
#include "int8_scan.cuh"

namespace {

using namespace i8scan;

constexpr int MAX_KB = 32;
constexpr int SPAN_CHUNKS = 16;  // chunks a CTA walks: whole blocks, at least one
constexpr float NEG_INF = block_topk::NEG_INF;
constexpr unsigned FULL = 0xffffffffu;

// the lists' room: two buffers of [TILE_Q][kb] scores, then ids
__host__ __device__ inline int lists_bytes(int kb) { return 2 * TILE_Q * kb * 8; }

__host__ __device__ inline RingLayout k1_layout(int d, int kb) {
    return layout(d, lists_bytes(kb));
}

__host__ __device__ inline int chunks_per_block(int block_size) {
    return (block_size + CHUNK - 1) / CHUNK;
}

__host__ __device__ inline int blocks_per_cta(int block_size) {
    const int cpb = chunks_per_block(block_size);
    return cpb >= SPAN_CHUNKS ? 1 : SPAN_CHUNKS / cpb;
}

template <bool RESIDENT, bool RAGGED>
__global__ void __launch_bounds__(THREADS, 1)
int8_scan_topk_kernel(const __grid_constant__ CUtensorMap tm_q,  // [nq·64, dq] int8
                      const __grid_constant__ CUtensorMap tm_v,  // [N, d] int8 (TMA route)
                      const int8_t* __restrict__ codes,          // [N, d] (RAGGED route)
                      const float* __restrict__ row_scale,       // [N]
                      const float* __restrict__ bias,            // [N]
                      float* __restrict__ out_s,                 // [nq, nblocks, kb, QUERY_TILE]
                      int* __restrict__ out_i, int nq, int nblocks, int block_size, int d,
                      int kb) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = fscan::aligned_smem(smem_raw);
    const RingLayout L = k1_layout(d, kb);
    // list buffer b (chunk parity): scores [TILE_Q][kb], then ids
    float* lists = reinterpret_cast<float*>(smem + epilogue_offset(L, d));
    const int npairs = (nq + 1) / 2;
    const int pair = blockIdx.x % npairs;
    const int bpc = blocks_per_cta(block_size);
    const int blk0 = blockIdx.x / npairs * bpc;
    const int nblk = min(bpc, nblocks - blk0);
    const int cpb = chunks_per_block(block_size);
    // chunk c of the CTA: chunk c % cpb of block blk0 + c / cpb
    const auto chunk_row = [=](int c) {
        return (long long)(blk0 + c / cpb) * block_size + (long long)(c % cpb) * CHUNK;
    };
    i8_scores<RESIDENT, RAGGED>(
        &tm_q, &tm_v, codes, (long long)nblocks * block_size, smem, L, pair, chunk_row,
        nblk * cpb, d, [&](int c, int (&acc)[128], int wg, int t, int qa) {
            // the chunk's scores, in place: f32(acc)·row_scale + bias, -1e30
            // at the columns past the block's end
            const int cb = c % cpb;
            const int blk = blk0 + c / cpb;
            const int grow0 = (int)chunk_row(c);
            const int live = min(CHUNK, block_size - cb * CHUNK);  // the block's columns
            float m0 = NEG_INF, m1 = NEG_INF;
            if (live == CHUNK && !(grow0 & 1)) {  // a whole chunk, pairs of rows 8-byte aligned
#pragma unroll
                for (int j = 0; j < 32; ++j) {
                    const int col = grow0 + 8 * j + 2 * t;
                    const float2 rs = *reinterpret_cast<const float2*>(row_scale + col);
                    const float2 bb = *reinterpret_cast<const float2*>(bias + col);
                    const float s0 = __fadd_rn(__fmul_rn((float)acc[4 * j + 0], rs.x), bb.x);
                    const float s1 = __fadd_rn(__fmul_rn((float)acc[4 * j + 1], rs.y), bb.y);
                    const float s2 = __fadd_rn(__fmul_rn((float)acc[4 * j + 2], rs.x), bb.x);
                    const float s3 = __fadd_rn(__fmul_rn((float)acc[4 * j + 3], rs.y), bb.y);
                    acc[4 * j + 0] = __float_as_int(s0);
                    acc[4 * j + 1] = __float_as_int(s1);
                    acc[4 * j + 2] = __float_as_int(s2);
                    acc[4 * j + 3] = __float_as_int(s3);
                    m0 = fmaxf(m0, fmaxf(s0, s1));
                    m1 = fmaxf(m1, fmaxf(s2, s3));
                }
            } else {
#pragma unroll
                for (int j = 0; j < 32; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = 8 * j + 2 * t + e;
                        float s0 = NEG_INF, s1 = NEG_INF;
                        if (col < live) {
                            const float rs = row_scale[grow0 + col];
                            const float bb = bias[grow0 + col];
                            s0 = __fadd_rn(__fmul_rn((float)acc[4 * j + e], rs), bb);
                            s1 = __fadd_rn(__fmul_rn((float)acc[4 * j + 2 + e], rs), bb);
                        }
                        acc[4 * j + e] = __float_as_int(s0);
                        acc[4 * j + 2 + e] = __float_as_int(s1);
                        m0 = fmaxf(m0, s0);
                        m1 = fmaxf(m1, s1);
                    }
            }
            const bool have = cb > 0;
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
            const int block_row0 = blk * block_size;
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
            if (cb != cpb - 1) return;
            // the block is done: the quad writes its two rows' lists
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int q = qa + 8 * r;
                const int tile = pair * 2 + q / QUERY_TILE;
                if (tile >= nq) continue;
                for (int p = t; p < kb; p += 4) {
                    const long long o =
                        (((long long)tile * nblocks + blk) * kb + p) * QUERY_TILE + q % QUERY_TILE;
                    out_s[o] = ns[q * kb + p];
                    out_i[o] = ni[q * kb + p];
                }
            }
        });
}

// ---- launcher -------------------------------------------------------------------

template <bool RESIDENT, bool RAGGED>
int launch_as(const CUtensorMap& tq, const CUtensorMap& tv, const void* codes,
              const void* row_scale, const void* bias, void* out_s, void* out_i, int nq,
              int nblocks, int block_size, int d, int kb, cudaStream_t stream) {
    const size_t smem = fscan::ring_bytes(k1_layout(d, kb));
    auto kernel = int8_scan_topk_kernel<RESIDENT, RAGGED>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return refused(err);
    const int bpc = blocks_per_cta(block_size);
    const unsigned grid = (unsigned)((nq + 1) / 2) * (unsigned)((nblocks + bpc - 1) / bpc);
    kernel<<<grid, THREADS, smem, stream>>>(
        tq, tv, static_cast<const int8_t*>(codes), static_cast<const float*>(row_scale),
        static_cast<const float*>(bias), static_cast<float*>(out_s), static_cast<int*>(out_i), nq,
        nblocks, block_size, d, kb);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int int8_scan_topk_chunk_rows() { return CHUNK; }
int int8_scan_topk_query_tile() { return QUERY_TILE; }
int int8_scan_topk_max_kb() { return MAX_KB; }

// Dynamic shared memory of one CTA at (d, kb), and whether the queries stay
// resident (1) or stream with the corpus (0).
int int8_scan_topk_smem_bytes(int d, int kb) { return fscan::ring_bytes(k1_layout(d, kb)); }
int int8_scan_topk_queries_resident(int d, int kb) { return k1_layout(d, kb).a_bytes > 0; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success),
// or the CUresult of a failed tensor-map encode. The caller checks shapes:
// q rows = nq·QUERY_TILE of ⌈d/16⌉·16 bytes (zero past d), codes rows =
// nblocks·block_size of d bytes, block_size >= 1, d >= 1, 1 <= kb <=
// MAX_KB, 16-byte aligned pointers.
int int8_scan_topk_launch(const void* q_codes, const void* codes, const void* row_scale,
                          const void* bias, void* out_s, void* out_i, int nq, int nblocks,
                          int d, int kb, int block_size, void* stream) {
    if (nq < 1 || nblocks < 1 || block_size < 1 || d < 1 || kb < 1 ||
        kb > MAX_KB || (long long)nblocks * block_size >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const RingLayout L = k1_layout(d, kb);
    if (fscan::ring_bytes(L) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const long long n = (long long)nblocks * block_size;
    CUtensorMap tq, tv;
    int err = encode_i8_map(&tq, q_codes, (long long)nq * QUERY_TILE,
                            (d + Q_MULTIPLE - 1) / Q_MULTIPLE * Q_MULTIPLE, TILE_Q);
    if (err) return err;
    const bool rag = ragged(d);
    if (!rag) {
        err = encode_i8_map(&tv, codes, n, d, CHUNK);
        if (err) return err;
    } else {
        tv = tq;  // not read: the RAGGED route stages the corpus by cp.async
    }
    const bool resident = L.a_bytes > 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (resident)
        return rag ? launch_as<true, true>(tq, tv, codes, row_scale, bias, out_s, out_i, nq,
                                           nblocks, block_size, d, kb, s)
                   : launch_as<true, false>(tq, tv, codes, row_scale, bias, out_s, out_i, nq,
                                            nblocks, block_size, d, kb, s);
    return rag ? launch_as<false, true>(tq, tv, codes, row_scale, bias, out_s, out_i, nq, nblocks,
                                        block_size, d, kb, s)
               : launch_as<false, false>(tq, tv, codes, row_scale, bias, out_s, out_i, nq,
                                         nblocks, block_size, d, kb, s);
}

}  // extern "C"
