// int8 scan with per-block top-kb, for Hopper (sm_90a).
//
// Replaces the TPU kernel crs_tpu/ops/pallas_scan.py:pallas_topk_int8 /
// _scan_kernel_int8 (with _extract_block_topk). For each query tile and each
// corpus block of BLOCK_ROWS rows:
//   acc = q_codes · codes_blockᵀ              (int8 × int8 → int32, __dp4a)
//   s   = float(acc) · row_scale + bias         (bias 0, or -1e30 for padding
//                                                and rows the `where` mask drops)
//   kb times: take the max, then the lowest global id among equal maxima,
//   emit (score, id), set that entry to -1e30.
// Partials go to out_s / out_i laid out [nq, nblocks, kb, QUERY_TILE], the
// JAX kernel's layout. The per-query scale is applied by the caller.
//
// What bounds it on an H100: at N = 1,048,576, D = 384, B = 328 the corpus is
// ~403 MB (~0.12 ms at 3.35 TB/s) and the work 2·B·N·D ≈ 2.6e11 int8
// operations (~0.13 ms at 1,979 TOPS on the tensor cores), so the bound is
// about 0.13 ms a batch. This first kernel is simple and right rather than
// fast: it uses __dp4a on the CUDA cores (no tensor cores) and rereads the
// corpus once per query tile of QUERY_TILE queries, so it sits far from that
// bound; the tensor-core (mma/wgmma s8) version is later work.
//
// Design: one CUDA block per (corpus block, query tile), 256 threads = 8
// warps. The query tile's codes pass through shared memory as 32-bit words
// laid out [word][query], Q_SLICE_WORDS words of each query at a time (so
// any D fits: a wide corpus is scored slice by slice into the same int32
// sums); the corpus block streams through shared memory in chunks of
// KCHUNK_WORDS words per row, laid out [word][row] so that lane l reads
// rows l, l+32, ... without bank conflicts. Warp w owns queries 8w..8w+7
// and every lane holds the scores of its 8 rows for those queries in
// registers, so the whole 8 × 256 score tile of a warp is in registers and
// the top-kb extraction is kb warp-shuffle arg-max passes per query — no
// score tile in shared memory. A D that is not a multiple of 16 is read 4
// bytes (D a multiple of 4) or a byte at a time and zero-filled past D
// inside the kernel (a zero product
// adds nothing to an int32 sum), so the corpus is never copied to pad it;
// the queries arrive padded to the multiple (the wrapper pads them, B × D
// bytes). The int32 sums are exact up to D = 133,143 (127² per product).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_ROWS = 256;   // corpus rows per CUDA block
constexpr int QUERY_TILE = 64;    // queries per CUDA block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int Q_PER_WARP = QUERY_TILE / WARPS;   // 8
constexpr int ROWS_PER_LANE = BLOCK_ROWS / 32;   // 8
constexpr int KCHUNK_WORDS = 16;                 // 64 bytes of each row per chunk
constexpr int Q_SLICE_WORDS = 128;               // 512 bytes of each query per slice
constexpr float NEG_INF = -1e30f;

// the dynamic shared memory at width d: a query slice, then a corpus chunk
__host__ __device__ inline int q_slice_words(int d) {
    const int dw = (d + 15) / 16 * 4;
    return dw < Q_SLICE_WORDS ? dw : Q_SLICE_WORDS;
}
size_t smem_bytes(int d) {
    return (size_t)(q_slice_words(d) * QUERY_TILE + KCHUNK_WORDS * BLOCK_ROWS) * sizeof(int);
}

// 16 bytes of a corpus row from byte `o` on, zero at or past D: one
// 16-byte load when D is a multiple of 16 (ALIGN 16), four 4-byte loads
// when it is a multiple of 4 (ALIGN 4), else byte by byte (ALIGN 1)
template <int ALIGN>
__device__ __forceinline__ int4 load16(const int8_t* row, int o, int d) {
    if (ALIGN == 16) return *reinterpret_cast<const int4*>(row + o);
    int w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int c0 = o + 4 * i;
        if (ALIGN == 4) {
            w[i] = c0 < d ? *reinterpret_cast<const int*>(row + c0) : 0;
            continue;
        }
        uint32_t v = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
            if (c0 + b < d) v |= (uint32_t)(uint8_t)row[c0 + b] << (8 * b);
        w[i] = (int)v;
    }
    return make_int4(w[0], w[1], w[2], w[3]);
}

template <int ALIGN>
__global__ void __launch_bounds__(THREADS, 2)
int8_scan_topk_kernel(const int8_t* __restrict__ q_codes,     // [nq·QUERY_TILE, ⌈D/16⌉·16]
                      const int8_t* __restrict__ codes,       // [nblocks·BLOCK_ROWS, D]
                      const float* __restrict__ row_scale,    // [nblocks·BLOCK_ROWS]
                      const float* __restrict__ bias,         // [nblocks·BLOCK_ROWS]
                      float* __restrict__ out_s,              // [nq, nblocks, kb, QUERY_TILE]
                      int* __restrict__ out_i,
                      int nblocks, int d, int kb) {
    extern __shared__ int smem[];
    const int dq = (d + 15) & ~15;               // the queries' padded width
    const int dw = dq / 4;                       // 32-bit words per (padded) row
    int* qs = smem;                                  // [q_slice_words][QUERY_TILE]
    int* cs = smem + q_slice_words(d) * QUERY_TILE;  // [KCHUNK_WORDS][BLOCK_ROWS]

    const int blk = blockIdx.x;
    const int iq = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long row0 = (long long)blk * BLOCK_ROWS;

    int acc[Q_PER_WARP][ROWS_PER_LANE];
#pragma unroll
    for (int i = 0; i < Q_PER_WARP; ++i)
#pragma unroll
        for (int j = 0; j < ROWS_PER_LANE; ++j) acc[i][j] = 0;

    const int8_t* qbase = q_codes + (long long)iq * QUERY_TILE * dq;
    const int8_t* cbase = codes + row0 * d;
    for (int q0 = 0; q0 < dw; q0 += q_slice_words(d)) {
        const int qn = min(q_slice_words(d), dw - q0);   // a multiple of 4
        const int qsegs = qn / 4;
        __syncthreads();                               // the previous slice consumed
        // the query tile's slice → shared memory, 16 bytes per load
        for (int idx = tid; idx < QUERY_TILE * qsegs; idx += THREADS) {
            const int q = idx / qsegs, sg = idx % qsegs;
            const int4 v = *reinterpret_cast<const int4*>(qbase + (long long)q * dq + q0 * 4 + sg * 16);
            qs[(sg * 4 + 0) * QUERY_TILE + q] = v.x;
            qs[(sg * 4 + 1) * QUERY_TILE + q] = v.y;
            qs[(sg * 4 + 2) * QUERY_TILE + q] = v.z;
            qs[(sg * 4 + 3) * QUERY_TILE + q] = v.w;
        }
        for (int kc = 0; kc < qn; kc += KCHUNK_WORDS) {
            const int nw = min(KCHUNK_WORDS, qn - kc);   // a multiple of 4
            const int nseg = nw / 4;
            __syncthreads();                              // previous chunk consumed
            for (int idx = tid; idx < BLOCK_ROWS * nseg; idx += THREADS) {
                const int r = idx / nseg, sg = idx % nseg;
                const int4 v = load16<ALIGN>(cbase + (long long)r * d, (q0 + kc) * 4 + sg * 16, d);
                cs[(sg * 4 + 0) * BLOCK_ROWS + r] = v.x;
                cs[(sg * 4 + 1) * BLOCK_ROWS + r] = v.y;
                cs[(sg * 4 + 2) * BLOCK_ROWS + r] = v.z;
                cs[(sg * 4 + 3) * BLOCK_ROWS + r] = v.w;
            }
            __syncthreads();
            for (int w = 0; w < nw; ++w) {
                int qv[Q_PER_WARP], cv[ROWS_PER_LANE];
#pragma unroll
                for (int i = 0; i < Q_PER_WARP; ++i) qv[i] = qs[(kc + w) * QUERY_TILE + warp * Q_PER_WARP + i];
#pragma unroll
                for (int j = 0; j < ROWS_PER_LANE; ++j) cv[j] = cs[w * BLOCK_ROWS + lane + 32 * j];
#pragma unroll
                for (int i = 0; i < Q_PER_WARP; ++i)
#pragma unroll
                    for (int j = 0; j < ROWS_PER_LANE; ++j) acc[i][j] = __dp4a(qv[i], cv[j], acc[i][j]);
            }
        }
    }

    // scores: round the product, then add the bias (no FMA contraction, so
    // the value is the one the plain version computes)
    float s[Q_PER_WARP][ROWS_PER_LANE];
#pragma unroll
    for (int j = 0; j < ROWS_PER_LANE; ++j) {
        const long long row = row0 + lane + 32 * j;
        const float rs = row_scale[row];
        const float bi = bias[row];
#pragma unroll
        for (int i = 0; i < Q_PER_WARP; ++i)
            s[i][j] = __fadd_rn(__fmul_rn((float)acc[i][j], rs), bi);
    }

    // top-kb per query: lane-local (max, lowest row), then a warp arg-max
#pragma unroll
    for (int i = 0; i < Q_PER_WARP; ++i) {
        const int q = warp * Q_PER_WARP + i;
        for (int p = 0; p < kb; ++p) {
            float best = s[i][0];
            int bcol = lane;
#pragma unroll
            for (int j = 1; j < ROWS_PER_LANE; ++j) {
                if (s[i][j] > best) {   // strict: the lower row wins a tie
                    best = s[i][j];
                    bcol = lane + 32 * j;
                }
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                const float ob = __shfl_xor_sync(0xffffffffu, best, off);
                const int oc = __shfl_xor_sync(0xffffffffu, bcol, off);
                if (ob > best || (ob == best && oc < bcol)) {
                    best = ob;
                    bcol = oc;
                }
            }
            if (lane == (bcol & 31)) {
#pragma unroll
                for (int j = 0; j < ROWS_PER_LANE; ++j)
                    if (j == (bcol >> 5)) s[i][j] = NEG_INF;
            }
            if (lane == 0) {
                const long long o = (((long long)iq * nblocks + blk) * kb + p) * QUERY_TILE + q;
                out_s[o] = best;
                out_i[o] = (int)(row0 + bcol);
            }
        }
    }
}

}  // namespace

extern "C" {

int int8_scan_topk_block_rows() { return BLOCK_ROWS; }
int int8_scan_topk_query_tile() { return QUERY_TILE; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The caller checks shapes: q rows = nq·QUERY_TILE of ⌈d/16⌉·16 bytes (zero
// past d), codes rows = nblocks·BLOCK_ROWS of d bytes, d >= 1,
// 1 <= kb <= BLOCK_ROWS, 16-byte aligned pointers.
int int8_scan_topk_launch(const void* q_codes, const void* codes, const void* row_scale,
                          const void* bias, void* out_s, void* out_i, int nq, int nblocks,
                          int d, int kb, void* stream) {
    if (d < 1 || kb < 1 || kb > BLOCK_ROWS) return (int)cudaErrorInvalidValue;
    auto kernel = d % 16 == 0 ? int8_scan_topk_kernel<16>
                : d % 4 == 0  ? int8_scan_topk_kernel<4>
                              : int8_scan_topk_kernel<1>;
    const size_t smem = smem_bytes(d);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)nblocks, (unsigned)nq);
    kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const int8_t*>(q_codes), static_cast<const int8_t*>(codes),
        static_cast<const float*>(row_scale), static_cast<const float*>(bias),
        static_cast<float*>(out_s), static_cast<int*>(out_i), nblocks, d, kb);
    return (int)cudaGetLastError();
}

}  // extern "C"
