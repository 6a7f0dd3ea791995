// PQ ADC scans with per-block top-kb, for Hopper (sm_90a).
//
// Replaces three TPU kernels of crs_tpu/ops/pallas_scan.py:
//   MODE = RESIDUAL: pallas_topk_residual_pq_adc / _scan_kernel_residual_pq_adc
//   MODE = SORTED:   pallas_topk_residual_pq_adc_sorted /
//                    _scan_kernel_residual_pq_adc_sorted
//   MODE = PLAIN:    pallas_topk_pq_adc / _scan_kernel_pq_adc
// For each query tile and each corpus block of block_size rows:
//   s = ((0 + hi[cid]) + lo[cid])      (RESIDUAL and SORTED; s = 0 in PLAIN)
//   s = s + lut[m][code_m]  for m = 0 .. M-1, in order
//   s = s + bias            (0, or -1e30 for padding and `where`-masked rows)
// then the per-block top-kb of block_topk.cuh. Any block_size >= 1 is taken
// (as kernel 1's): a block is ⌈block_size / 256⌉ chunks from its first row,
// and the rows of its last chunk past the block's end (the next block's, or
// past the corpus: staged as zeros) score -1e30 and never enter the block's
// top-kb (every id of the block is lower than theirs). The tables arrive rounded as
// the TPU kernels round them: the residual LUT in bf16, the coarse LUT as a
// hi+lo bf16 pair (one 32-bit word per (query, coarse id), hi in the low
// half). The Pallas kernels add the same values as one-hot matrix products,
// in which every other product is an exact zero, in this order; every add
// here is an explicit __fadd_rn, so the scores are theirs to the bit.
//
// SORTED: the rows are sorted by coarse id, and block b belongs to the tile
// b / group whose ids the host planner put in the 512-id window
// [256·w, 256·w + 512), w = wbase[b / group]. The Pallas kernel's one-hot
// covers only that window, so a row whose id lies outside it (a padding row
// of the last tile, a hand-built plan) gets a coarse term of exactly 0; the
// kernel keeps that rule. The table has 256 zero columns after the C real
// ones (c = C + 256 here), so the window never leaves it. Inside the window
// the term is kernel 3's, and so are the scores. What the layout buys on
// this card is locality: a tile's coarse reads fall in one 16 KB window of
// the table (512 ids × 8 queries × 4 bytes), which stays in L2. The window
// is read through L2 like the whole table in RESIDUAL: kept in shared
// memory it would add 8·512·4 = 16 KB to the 217,600 bytes the LUTs, row
// staging and scores take at M = 48, K = 256, past the 232,448 a CUDA block
// may have. On the TPU the layout cut the coarse one-hot products from C/256
// windows to 2; here the lookup's cost never depended on C.
//
// What bounds it on an H100: the corpus is M+2 bytes a row (52 MB at
// N = 1,048,576, M = 48) ≈ 0.016 ms at 3.35 TB/s, so bytes do not bound
// it: the work does. Each (query, row) costs M + 2 f32 adds on looked-up
// values (coarse pair, M residual terms, bias), B·N·(M+2) ≈ 1.7e10 at
// B = 328: ≈ 0.51 ms at one add per lane per clock (132 SMs × 128 lanes ×
// 1.98 GHz = 3.3e13 adds a second). The lookups are shared-memory loads,
// which the card's published peaks do not list: one 16-byte entry (8
// queries) per (query tile, row, subspace), 41 × 1M × 48 × 16 B ≈ 33 GB,
// at 128 bytes per SM per clock ≈ 1 ms without bank conflicts.
//
// Design: the LUT lookup is a gather from shared memory (the one-hot matrix
// product is a TPU idiom). One CUDA block per (query tile of 8, run of corpus
// blocks), 256 threads = 8 warps. The tile's residual LUTs live in shared
// memory for the whole run: the 8 queries' bf16 values of one (subspace,
// code) are one 16-byte entry, so a row's lookup in subspace m is a single
// 16-byte load for all 8 queries. 8·M·K·2 bytes = 192 KB at M = 48, K = 256,
// which is why the tile is 8 queries and why the grid walks several corpus
// blocks per CUDA block (the LUT is loaded once per run, not once per
// block). The coarse hi/lo table (B·C·4 bytes, 2.7 MB at B = 328, C = 2048)
// stays in device memory, read through L2 as [coarse id][query] (one
// 32-byte sector per row for the tile). Thread t scores row t of each
// chunk of 256 rows for all 8 queries, the scores go to shared memory, and
// warp w folds them into query w's running top-kb.
//
// The main path (8 queries a CUDA block, all M subspaces resident: M ≤ 48
// at K = 256; adc_scan_topk_skew_kernel). A 16-byte load is served 8 lanes
// at a time, and two lanes whose entries fall on the same 4 of the 32
// banks (entry e on bank group e mod 8) are served one after the other:
// with random codes a warp's gather took ~10 wavefronts instead of 4. So
// the LUT is laid out [code][m] with the subspace stride padded to a
// multiple of 8 entries (entry (m, code) at code·Mp + m, bank group m mod 8
// for any code), and lane l of each 8 runs l mod 8 steps behind: at step j
// it adds subspace m = j − (l mod 8). The 8 lanes of a phase then read 8
// different bank groups whatever the codes, and every lane still adds its
// row's terms in the order m = 0 .. M−1 (the first and last 7 steps of a
// row have idle lanes, which add a zero entry before the LUT: M + 7
// steps for M, and s + 0 = s since a sum here is never -0). A group of 8
// steps takes its 8 codes from 3 words of the row in shared memory,
// funnel-shifted by the lane's lag, so a step is one byte extract, one
// address and one 16-byte load; a group's loads are issued before the
// previous group's adds. The chunk's codes
// arrive by cp.async into one of two buffers while the previous chunk is
// scored, and a chunk whose scores all fall below the running list's last
// entry leaves the list as it is (its kb passes would re-emit the list).
// What is left bounds it by instructions: ~19 a step (the byte, the
// address, the load, 8 bf16 → f32 widenings and 8 adds) over M + 7 steps.
//
// Wider tables (adc_scan_topk_kernel: M ≥ 49 at K = 256, where the padded
// layout and the second code buffer do not fit). When the tile's LUTs do
// not fit beside a chunk (M ≥ 52 at K = 256), a CUDA block scores QT = 4,
// 2 or 1 of the tile's 8 queries (the largest that fits; QT·M·K·2 bytes of
// LUT, entries of QT values), and the grid has 8 / QT blocks per tile and
// run. Past one query's LUTs (M ≥ 296 at K = 256) the block takes its 8
// queries' LUTs SLICE subspaces at a time: for every chunk, each slice of
// the LUTs and of the chunk's codes is staged in turn and its terms added,
// in subspace order, so the sums are the same; the LUTs are then read once
// per chunk instead of once per run. Every M and K ≤ 256 is taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_topk.cuh"

namespace {

constexpr int CHUNK = 256;      // corpus rows per step; thread t scores row t
constexpr int QUERY_TILE = 8;   // queries per tile of the partials and the LUT layout
constexpr int THREADS = 256;
constexpr int ROWS_PER_LANE = CHUNK / 32;
constexpr int MAX_KB = 32;
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory one CUDA block may use
enum Mode { PLAIN = 0, RESIDUAL = 1, SORTED = 2 };

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) / 16 * 16; }

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// A LUT entry of QT queries' bf16 values for one (subspace, code), and its
// values widened exactly, in query order.
template <int QT> struct Entry;
template <> struct Entry<8> {
    using T = uint4;
    __device__ static void unpack(const T v, float (&f)[8]) {
        f[0] = bf16_lo(v.x); f[1] = bf16_hi(v.x); f[2] = bf16_lo(v.y); f[3] = bf16_hi(v.y);
        f[4] = bf16_lo(v.z); f[5] = bf16_hi(v.z); f[6] = bf16_lo(v.w); f[7] = bf16_hi(v.w);
    }
};
template <> struct Entry<4> {
    using T = uint2;
    __device__ static void unpack(const T v, float (&f)[4]) {
        f[0] = bf16_lo(v.x); f[1] = bf16_hi(v.x); f[2] = bf16_lo(v.y); f[3] = bf16_hi(v.y);
    }
};
template <> struct Entry<2> {
    using T = uint32_t;
    __device__ static void unpack(const T v, float (&f)[2]) { f[0] = bf16_lo(v); f[1] = bf16_hi(v); }
};
template <> struct Entry<1> {
    using T = uint16_t;
    __device__ static void unpack(const T v, float (&f)[1]) { f[0] = bf16_lo(v); }
};

// Shared memory of one CUDA block: QT queries' LUTs for `ms` subspaces, the
// chunk's staged codes (whole rows of `cols` bytes when ms = m, else `ms`
// bytes a row) and its scores.
__host__ __device__ inline size_t adc_smem(int qt, int m, int ms, int kc, int cols) {
    const size_t code_bytes = (size_t)CHUNK * (ms == m ? cols : ms);
    return (size_t)qt * ms * kc * 2 + round16(code_bytes) + (size_t)qt * CHUNK * 4;
}

// `bytes` bytes of rows from `src` → shared memory at `dst`, zeros up to
// `room` bytes (a chunk's rows past the block's end, or past the corpus):
// 16-byte words when the source is aligned and the chunk whole, else bytes.
__device__ __forceinline__ void stage_rows(unsigned char* dst, const uint8_t* src, int bytes,
                                           int room, int tid) {
    if (bytes == room && !(reinterpret_cast<uintptr_t>(src) & 15)) {
        const uint4* s4 = reinterpret_cast<const uint4*>(src);
        uint4* d4 = reinterpret_cast<uint4*>(dst);
        for (int idx = tid; idx < room / 16; idx += THREADS) d4[idx] = s4[idx];
    } else {
        for (int idx = tid; idx < room; idx += THREADS) dst[idx] = idx < bytes ? src[idx] : 0;
    }
}

// entries [e0, e1) of the query tile's [m·kc] LUT entries (16 bytes, 8
// queries) → shared memory from 0, the QT values of queries q0.. of each
template <int QT>
__device__ __forceinline__ void load_lut(typename Entry<QT>::T* dst, const unsigned char* tile_lut,
                                         int e0, int e1, int q0, int tid) {
    using T = typename Entry<QT>::T;
    for (int e = e0 + tid; e < e1; e += THREADS)
        dst[e - e0] = *reinterpret_cast<const T*>(tile_lut + (size_t)e * 16 + q0 * 2);
}

// MODE, QT queries per CUDA block, SLICED: the LUTs and codes staged `ms`
// subspaces at a time per chunk (else all M, the LUTs once per run).
// MASKED: block_size is not a multiple of CHUNK (a block's last chunk is
// masked past its end); blocks of whole chunks take the unmasked instance.
template <int MODE, int QT, bool SLICED, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
adc_scan_topk_kernel(const __nv_bfloat16* __restrict__ lut,  // [nq, m, kc, QUERY_TILE]
                     const uint32_t* __restrict__ hilo,      // [nq, c, QUERY_TILE] (not PLAIN)
                     const uint8_t* __restrict__ codes,      // [nblocks·block_size, cols]
                     const float* __restrict__ bias,         // [nblocks·block_size]
                     float* __restrict__ out_s,              // [nq, nblocks, kb, QUERY_TILE]
                     int* __restrict__ out_i,
                     const int* __restrict__ wbase,          // [nblocks / group] (SORTED)
                     int nblocks, int block_size, int blocks_per_cta, int m, int kc, int c,
                     int kb, int group, int ms) {
    using T = typename Entry<QT>::T;
    constexpr int SUBS = QUERY_TILE / QT;  // CUDA blocks per query tile
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr bool COARSE = MODE != PLAIN;
    const int cols = m + (COARSE ? 2 : 0);
    const int off = COARSE ? 2 : 0;
    const int stride = SLICED ? ms : cols;                     // staged bytes a row
    const size_t lut_bytes = (size_t)QT * ms * kc * 2;         // a multiple of 16 (SLICED: QT = 8)
    T* lut_s = reinterpret_cast<T*>(smem);                     // [ms·kc] entries of QT queries
    unsigned char* codes_s = smem + round16(lut_bytes);
    float* sc = reinterpret_cast<float*>(codes_s + round16((size_t)CHUNK * stride));  // [QT][CHUNK]

    const int iq = blockIdx.y / SUBS;
    const int q0 = (blockIdx.y % SUBS) * QT;  // the first of the tile's queries scored here
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const unsigned char* tile_lut =
        reinterpret_cast<const unsigned char*>(lut) + (size_t)iq * m * kc * QUERY_TILE * 2;
    if (!SLICED) load_lut<QT>(lut_s, tile_lut, 0, m * kc, q0, tid);
    const uint32_t* hilo_q = COARSE ? hilo + (size_t)iq * c * QUERY_TILE : nullptr;

    const int blk_begin = blockIdx.x * blocks_per_cta;
    const int blk_end = min(nblocks, blk_begin + blocks_per_cta);
    for (int blk = blk_begin; blk < blk_end; ++blk) {
        const int win = MODE == SORTED ? 256 * wbase[blk / group] : 0;  // first id of the window
        float ls = block_topk::NEG_INF;
        int li = 0;
        for (int c0 = 0; c0 < block_size; c0 += CHUNK) {
            const long long row0 = (long long)blk * block_size + c0;
            // the block's rows in this chunk; this thread's row is the block's
            const int live = MASKED ? min(CHUNK, block_size - c0) : CHUNK;
            const bool mine = !MASKED || tid < live;
            const uint8_t* rowp = codes + (row0 + tid) * cols;  // this thread's row
            if (!SLICED) {
                __syncthreads();  // LUT loaded / previous chunk's codes and scores consumed
                if (MASKED) {
                    stage_rows(codes_s, codes + row0 * cols, live * cols, CHUNK * cols, tid);
                } else {
                    const uint4* src = reinterpret_cast<const uint4*>(codes + row0 * cols);
                    uint4* dst = reinterpret_cast<uint4*>(codes_s);
                    for (int idx = tid; idx < CHUNK * cols / 16; idx += THREADS) dst[idx] = src[idx];
                }
                __syncthreads();
            }
            float s[QT];
            int cid = 0;
            if (COARSE) {  // a row past the block reads id 0: its score is dropped below
                const unsigned char* cb = SLICED ? rowp : codes_s + tid * cols;
                cid = MASKED && SLICED && !mine ? 0 : ((int)cb[0] << 8) | (int)cb[1];
            }
            // SORTED: an id outside the tile's window has no coarse term
            const bool in_window = MODE != SORTED || ((unsigned)(cid - win) < 512u && cid < c);
            if (COARSE && in_window) {
                // word q of the row's 32-byte entry: hi in the low half, lo in the high half
                uint32_t w[QT];
                if (QT == 8) {
                    const uint4* e = reinterpret_cast<const uint4*>(hilo_q + (size_t)cid * QUERY_TILE);
                    const uint4 a = __ldg(e), b = __ldg(e + 1);
                    const uint32_t all[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
                    for (int qq = 0; qq < QT; ++qq) w[qq] = all[qq];
                } else {
#pragma unroll
                    for (int qq = 0; qq < QT; ++qq)
                        w[qq] = __ldg(hilo_q + (size_t)cid * QUERY_TILE + q0 + qq);
                }
#pragma unroll
                for (int qq = 0; qq < QT; ++qq)
                    s[qq] = __fadd_rn(__fadd_rn(0.0f, bf16_lo(w[qq])), bf16_hi(w[qq]));
            } else {
#pragma unroll
                for (int qq = 0; qq < QT; ++qq) s[qq] = 0.0f;
            }
            for (int m0 = 0; m0 < m; m0 += (SLICED ? ms : m)) {
                const int m1 = SLICED ? min(m, m0 + ms) : m;
                if (SLICED) {  // this slice's LUTs and codes → shared memory
                    const int w = m1 - m0;
                    __syncthreads();  // the previous slice (or chunk's scores) consumed
                    load_lut<QT>(lut_s, tile_lut, m0 * kc, m1 * kc, q0, tid);
                    for (int idx = tid; idx < CHUNK * w; idx += THREADS) {
                        const int r = idx / w, j = idx - r * w;
                        codes_s[r * ms + j] =
                            !MASKED || r < live ? codes[(row0 + r) * cols + off + m0 + j] : 0;
                    }
                    __syncthreads();
                }
                const unsigned char* my = SLICED ? codes_s + tid * ms : codes_s + tid * cols + off;
                for (int mm = m0; mm < m1; ++mm) {
                    float r[QT];
                    Entry<QT>::unpack(lut_s[(mm - m0) * kc + my[mm - m0]], r);
#pragma unroll
                    for (int qq = 0; qq < QT; ++qq) s[qq] = __fadd_rn(s[qq], r[qq]);
                }
            }
            // -1e30 past the block's end: those rows never enter its top-kb
            const float b = mine ? bias[row0 + tid] : block_topk::NEG_INF;
#pragma unroll
            for (int qq = 0; qq < QT; ++qq)
                sc[qq * CHUNK + tid] = mine ? __fadd_rn(s[qq], b) : block_topk::NEG_INF;
            __syncthreads();

            if (warp < QT) {
                float v[ROWS_PER_LANE];
#pragma unroll
                for (int j = 0; j < ROWS_PER_LANE; ++j) v[j] = sc[warp * CHUNK + lane + 32 * j];
                block_topk::merge_chunk<ROWS_PER_LANE>(v, (int)row0, c0 > 0, ls, li, kb, lane);
            }
        }
        if (warp < QT && lane < kb) {
            const long long o =
                (((long long)iq * nblocks + blk) * kb + lane) * QUERY_TILE + q0 + warp;
            out_s[o] = ls;
            out_i[o] = li;
        }
    }
}

template <int MODE, int QT, bool SLICED, bool MASKED>
int launch_as(const void* lut, const void* hilo, const void* codes, const void* bias,
              void* out_s, void* out_i, const void* wbase, int nq, int nblocks, int block_size,
              int grid_x, int m, int kc, int c, int kb, int group, int ms, size_t smem,
              void* stream) {
    cudaError_t err = cudaFuncSetAttribute(adc_scan_topk_kernel<MODE, QT, SLICED, MASKED>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int per_cta = (nblocks + grid_x - 1) / grid_x;
    const dim3 grid((unsigned)((nblocks + per_cta - 1) / per_cta),
                    (unsigned)nq * (QUERY_TILE / QT));
    adc_scan_topk_kernel<MODE, QT, SLICED, MASKED><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(lut), static_cast<const uint32_t*>(hilo),
        static_cast<const uint8_t*>(codes), static_cast<const float*>(bias),
        static_cast<float*>(out_s), static_cast<int*>(out_i), static_cast<const int*>(wbase),
        nblocks, block_size, per_cta, m, kc, c, kb, group, ms);
    return (int)cudaGetLastError();
}

// The main path's shared memory: the skewed LUT (8 queries, Mp = M rounded
// up to 8 subspaces), two chunks' codes and the scores.
__host__ __device__ inline int skew_stride(int m) { return (m + 7) / 8 * 8; }
constexpr int SKEW_LUT_PAD = 128;  // 8 zero entries before the LUT, one per bank group: idle steps
__host__ __device__ inline size_t skew_smem(int m, int kc, int cols) {
    return SKEW_LUT_PAD + (size_t)skew_stride(m) * kc * 16 + 2 * round16((size_t)CHUNK * cols)
           + (size_t)QUERY_TILE * CHUNK * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// the adds of steps j0 .. j0 + 7, in order
__device__ __forceinline__ void skew_add(const uint4 (&e)[8], float (&s)[QUERY_TILE]) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
        float r[QUERY_TILE];
        Entry<QUERY_TILE>::unpack(e[u], r);
#pragma unroll
        for (int q = 0; q < QUERY_TILE; ++q) s[q] = __fadd_rn(s[q], r[q]);
    }
}

// the entries of group g's steps j = 8g .. 8g + 7: subspace j − lag's entry
// (m, code) at lut_s[code·mp + m] = lane_lut[code·mp + j], the 8 codes from
// the row's bytes in shared memory (3 words funnel-shifted by the lane's
// lag: byte j of the shifted row is subspace j − lag's code). RAMP: a step
// off the row (j − lag outside [0, m)) reads one of the 8 zero entries
// before the LUT instead, the one on the bank group the step would have
// used, so its add leaves the sum's bits as they are (a sum is never -0)
// and the phase stays free of conflicts.
template <bool RAMP>
__device__ __forceinline__ void skew_gather(uint4 (&e)[8], const uint32_t* row_words, int sh,
                                             const uint4* lut_s, const uint4* lane_lut, int mp,
                                             int m, int lag, int g) {
    const uint32_t w0 = row_words[2 * g], w1 = row_words[2 * g + 1], w2 = row_words[2 * g + 2];
    const uint32_t c0 = __funnelshift_r(w0, w1, sh), c1 = __funnelshift_r(w1, w2, sh);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
        const int j = 8 * g + u;
        const int code = (int)__byte_perm(u < 4 ? c0 : c1, 0u, 0x4440u | (u & 3));
        if (RAMP) {
            const int idx = (unsigned)(j - lag) < (unsigned)m ? code * mp + j - lag
                                                              : ((j - lag) & 7) - 8;
            e[u] = lut_s[idx];
        } else {
            e[u] = lane_lut[code * mp + j];
        }
    }
}

// group g's gathers: every lane on its row (8 ≤ 8g and 8g + 8 ≤ m) or not
__device__ __forceinline__ void skew_gather_group(uint4 (&e)[8], const uint32_t* row_words, int sh,
                                                   const uint4* lut_s, const uint4* lane_lut,
                                                   int mp, int m, int lag, int g) {
    if (g >= 1 && 8 * g + 8 <= m)
        skew_gather<false>(e, row_words, sh, lut_s, lane_lut, mp, m, lag, g);
    else
        skew_gather<true>(e, row_words, sh, lut_s, lane_lut, mp, m, lag, g);
}

// MASKED: block_size is not a multiple of CHUNK (a block's last chunk is
// masked past its end). The main path's blocks take the unmasked instance.
template <int MODE, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
adc_scan_topk_skew_kernel(const __nv_bfloat16* __restrict__ lut,  // [nq, m, kc, QUERY_TILE]
                          const uint32_t* __restrict__ hilo,      // [nq, c, QUERY_TILE] (not PLAIN)
                          const uint8_t* __restrict__ codes,      // [nblocks·block_size, cols]
                          const float* __restrict__ bias,         // [nblocks·block_size]
                          float* __restrict__ out_s,              // [nq, nblocks, kb, QUERY_TILE]
                          int* __restrict__ out_i,
                          const int* __restrict__ wbase,          // [nblocks / group] (SORTED)
                          int nblocks, int block_size, int blocks_per_cta, int m, int kc, int c,
                          int kb, int group) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr bool COARSE = MODE != PLAIN;
    const int cols = m + (COARSE ? 2 : 0);
    const int off = COARSE ? 2 : 0;
    const int mp = skew_stride(m);
    const size_t stage = round16((size_t)CHUNK * cols);
    uint4* lut_s = reinterpret_cast<uint4*>(smem + SKEW_LUT_PAD);            // [kc][mp] entries
    unsigned char* codes_s = smem + SKEW_LUT_PAD + (size_t)mp * kc * 16;     // 2 × [CHUNK][cols]
    float* sc = reinterpret_cast<float*>(codes_s + 2 * stage);               // [8][CHUNK]

    const int iq = blockIdx.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int lag = lane & 7;  // steps this lane runs behind lane 8·⌊lane/8⌋
    const uint4* tile_lut = reinterpret_cast<const uint4*>(lut) + (size_t)iq * m * kc;  // [m][kc]
    for (int e = tid; e < m * kc; e += THREADS) {
        const int mm = e / kc, code = e - mm * kc;
        lut_s[code * mp + mm] = tile_lut[e];
    }
    if (tid < SKEW_LUT_PAD / 16) reinterpret_cast<uint4*>(smem)[tid] = make_uint4(0u, 0u, 0u, 0u);
    const uint32_t* hilo_q = COARSE ? hilo + (size_t)iq * c * QUERY_TILE : nullptr;

    const int blk_begin = blockIdx.x * blocks_per_cta;
    const int blk_end = min(nblocks, blk_begin + blocks_per_cta);
    // a block is ⌈block_size / CHUNK⌉ chunks from its first row; chunk ci of
    // the run is chunk ci % per_block of block blk_begin + ci / per_block
    const int per_block = MASKED ? (block_size + CHUNK - 1) / CHUNK : block_size / CHUNK;
    const int nch = (blk_end - blk_begin) * per_block;
    auto chunk_row = [&](int ci) {
        return MASKED ? (long long)(blk_begin + ci / per_block) * block_size
                            + (long long)(ci % per_block) * CHUNK
                      : (long long)blk_begin * block_size + (long long)ci * CHUNK;
    };
    auto chunk_live = [&](int ci) {
        return MASKED ? min(CHUNK, block_size - (ci % per_block) * CHUNK) : CHUNK;
    };
    auto stage_codes = [&](int ci) {  // chunk ci's rows → buffer ci & 1
        const uint8_t* src = codes + chunk_row(ci) * cols;
        unsigned char* dst = codes_s + (ci & 1) * stage;
        const int live = chunk_live(ci);
        if (!MASKED || (live == CHUNK && !(reinterpret_cast<uintptr_t>(src) & 15))) {
            const uint4* s4 = reinterpret_cast<const uint4*>(src);
            for (int w = tid; w < CHUNK * cols / 16; w += THREADS) cp_async16(dst + 16 * w, s4 + w);
        } else {  // a block's last chunk (zeros past its end) or rows off 16 bytes: plain copies
            stage_rows(dst, src, live * cols, CHUNK * cols, tid);
        }
        cp_async_commit();
    };
    stage_codes(0);
    float ls = block_topk::NEG_INF;
    int li = 0;
    for (int ci = 0; ci < nch; ++ci) {
        const long long row0 = chunk_row(ci);
        const int blk = blk_begin + ci / per_block;
        const int c0 = (ci % per_block) * CHUNK;
        const bool mine = !MASKED || tid < chunk_live(ci);  // this thread's row is the block's
        if (ci + 1 < nch) {
            stage_codes(ci + 1);  // its buffer's chunk (ci − 1) was scored before the last barrier
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // chunk ci's codes are in; the previous merge is done with the scores

        const unsigned char* buf = codes_s + (ci & 1) * stage;
        const unsigned char* cb = buf + tid * cols;
        float s[QUERY_TILE];
        uint4 ca = make_uint4(0u, 0u, 0u, 0u), cw2 = ca;  // the row's coarse words (0 + 0 = 0: none)
        if (COARSE) {
            const int cid = ((int)cb[0] << 8) | (int)cb[1];
            const int win = MODE == SORTED ? 256 * wbase[blk / group] : 0;  // first id of the window
            // SORTED: an id outside the tile's window has no coarse term
            const bool in_window = MODE != SORTED || ((unsigned)(cid - win) < 512u && cid < c);
            if (in_window) {
                const uint4* e = reinterpret_cast<const uint4*>(hilo_q + (size_t)cid * QUERY_TILE);
                ca = __ldg(e);
                cw2 = __ldg(e + 1);
            }
        }
        // -1e30 past the block's end: those rows never enter its top-kb
        const float bv = mine ? bias[row0 + tid] : block_topk::NEG_INF;
        const int a = tid * cols + off - lag;  // this lane's row from byte off − lag
        const uint32_t* row_words = reinterpret_cast<const uint32_t*>(buf) + (a >> 2);
        const int sh = (a & 3) * 8;
        const uint4* lane_lut = lut_s - lag;
        {
            const uint32_t w[8] = {ca.x, ca.y, ca.z, ca.w, cw2.x, cw2.y, cw2.z, cw2.w};
#pragma unroll
            for (int q = 0; q < QUERY_TILE; ++q)  // ((0 + hi) + lo); PLAIN: 0
                s[q] = COARSE ? __fadd_rn(__fadd_rn(0.0f, bf16_lo(w[q])), bf16_hi(w[q])) : 0.0f;
        }
        // step j adds subspace j − lag when it is in [0, m), and zero when not.
        // Steps go in groups of 8: a group's 8 loads are issued before the
        // previous group's adds, so the gathers of one group overlap the
        // arithmetic of the other.
        uint4 ea[8], eb[8];
        const int ngroups = (m + 14) / 8;  // steps j < m + 7
        skew_gather_group(ea, row_words, sh, lut_s, lane_lut, mp, m, lag, 0);
#pragma unroll 1
        for (int g = 0; g < ngroups; g += 2) {
            if (g + 1 < ngroups) skew_gather_group(eb, row_words, sh, lut_s, lane_lut, mp, m, lag, g + 1);
            skew_add(ea, s);
            if (g + 2 < ngroups) skew_gather_group(ea, row_words, sh, lut_s, lane_lut, mp, m, lag, g + 2);
            if (g + 1 < ngroups) skew_add(eb, s);
        }
#pragma unroll
        for (int q = 0; q < QUERY_TILE; ++q)
            sc[q * CHUNK + tid] = mine ? __fadd_rn(s[q], bv) : block_topk::NEG_INF;
        __syncthreads();

        float v[ROWS_PER_LANE];
        float top = block_topk::NEG_INF;
#pragma unroll
        for (int j = 0; j < ROWS_PER_LANE; ++j) {
            v[j] = sc[warp * CHUNK + lane + 32 * j];
            top = fmaxf(top, v[j]);
        }
        // below the list's last entry, every row of the chunk loses every pass
        if (c0 == 0 || __any_sync(block_topk::FULL, top >= __shfl_sync(block_topk::FULL, ls, kb - 1)))
            block_topk::merge_chunk<ROWS_PER_LANE>(v, (int)row0, c0 > 0, ls, li, kb, lane);
        if ((MASKED ? ci % per_block == per_block - 1 : c0 + CHUNK == block_size) && lane < kb) {
            const long long o = (((long long)iq * nblocks + blk) * kb + lane) * QUERY_TILE + warp;
            out_s[o] = ls;
            out_i[o] = li;
        }
    }
}

template <int MODE, bool MASKED>
int launch_skew(const void* lut, const void* hilo, const void* codes, const void* bias,
                void* out_s, void* out_i, const void* wbase, int nq, int nblocks,
                int block_size, int grid_x, int m, int kc, int c, int kb, int group,
                size_t smem, void* stream) {
    cudaError_t err = cudaFuncSetAttribute(adc_scan_topk_skew_kernel<MODE, MASKED>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int per_cta = (nblocks + grid_x - 1) / grid_x;
    const dim3 grid((unsigned)((nblocks + per_cta - 1) / per_cta), (unsigned)nq);
    adc_scan_topk_skew_kernel<MODE, MASKED><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(lut), static_cast<const uint32_t*>(hilo),
        static_cast<const uint8_t*>(codes), static_cast<const float*>(bias),
        static_cast<float*>(out_s), static_cast<int*>(out_i), static_cast<const int*>(wbase),
        nblocks, block_size, per_cta, m, kc, c, kb, group);
    return (int)cudaGetLastError();
}

// The plan (ops/scan.py adc_layout makes it): qt queries a CUDA block (8, 4,
// 2, 1), ms subspaces staged at a time (m: all, the LUTs once per run; fewer
// only with qt = 8), skew: the main path's skewed kernel (qt = 8, ms = m).
// A plan that is not one of these, or does not fit, is refused.
template <int MODE>
int launch(const void* lut, const void* hilo, const void* codes, const void* bias, void* out_s,
           void* out_i, const void* wbase, int nq, int nblocks, int block_size, int grid_x,
           int m, int kc, int c, int kb, int group, int qt, int ms, int skew, void* stream) {
    if (m < 1 || kc < 1 || kc > 256 || kb < 1 || kb > MAX_KB || block_size < 1)
        return (int)cudaErrorInvalidValue;
    if ((qt != 8 && qt != 4 && qt != 2 && qt != 1) || ms < 1 || ms > m
        || (ms < m && qt != QUERY_TILE) || (skew && (qt != QUERY_TILE || ms != m)))
        return (int)cudaErrorInvalidValue;
    const int cols = m + (MODE != PLAIN ? 2 : 0);
    const size_t smem = skew ? skew_smem(m, kc, cols) : adc_smem(qt, m, ms, kc, cols);
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
#define ADC_LAUNCH(QT, SLICED)                                                                   \
    (block_size % CHUNK                                                                          \
         ? launch_as<MODE, QT, SLICED, true>(lut, hilo, codes, bias, out_s, out_i, wbase, nq,    \
                                             nblocks, block_size, grid_x, m, kc, c, kb, group,   \
                                             ms, smem, stream)                                   \
         : launch_as<MODE, QT, SLICED, false>(lut, hilo, codes, bias, out_s, out_i, wbase, nq,   \
                                              nblocks, block_size, grid_x, m, kc, c, kb, group,  \
                                              ms, smem, stream))
    if (skew)
        return block_size % CHUNK
                   ? launch_skew<MODE, true>(lut, hilo, codes, bias, out_s, out_i, wbase, nq,
                                             nblocks, block_size, grid_x, m, kc, c, kb, group,
                                             smem, stream)
                   : launch_skew<MODE, false>(lut, hilo, codes, bias, out_s, out_i, wbase, nq,
                                              nblocks, block_size, grid_x, m, kc, c, kb, group,
                                              smem, stream);
    if (ms < m) return ADC_LAUNCH(8, true);
    switch (qt) {
        case 8: return ADC_LAUNCH(8, false);
        case 4: return ADC_LAUNCH(4, false);
        case 2: return ADC_LAUNCH(2, false);
        default: return ADC_LAUNCH(1, false);
    }
#undef ADC_LAUNCH
}

}  // namespace

extern "C" {

int adc_scan_topk_chunk_rows() { return CHUNK; }
int adc_scan_topk_query_tile() { return QUERY_TILE; }
int adc_scan_topk_max_kb() { return MAX_KB; }
int adc_scan_topk_threads() { return THREADS; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The caller checks shapes: LUT rows = nq·QUERY_TILE, code rows =
// nblocks·block_size, block_size >= 1, kc <= 256, c <= 65536,
// 1 <= kb <= MAX_KB, 16-byte aligned pointers. grid_x = CUDA blocks wanted
// along the corpus (per query tile, or per part of one when QT < 8); qt,
// ms, skew: the plan (launch above).
int adc_scan_topk_residual_launch(const void* lut, const void* hilo, const void* codes,
                                  const void* bias, void* out_s, void* out_i, int nq, int nblocks,
                                  int block_size, int grid_x, int m, int kc, int c, int kb,
                                  int qt, int ms, int skew, void* stream) {
    return launch<RESIDUAL>(lut, hilo, codes, bias, out_s, out_i, nullptr, nq, nblocks,
                            block_size, grid_x, m, kc, c, kb, 1, qt, ms, skew, stream);
}

int adc_scan_topk_plain_launch(const void* lut, const void* hilo, const void* codes,
                               const void* bias, void* out_s, void* out_i, int nq, int nblocks,
                               int block_size, int grid_x, int m, int kc, int c, int kb,
                               int qt, int ms, int skew, void* stream) {
    return launch<PLAIN>(lut, hilo, codes, bias, out_s, out_i, nullptr, nq, nblocks, block_size,
                         grid_x, m, kc, c, kb, 1, qt, ms, skew, stream);
}

// The sorted layout: c = C + 256 columns of hi/lo (the last 256 zero),
// wbase = one window base (in units of 256 ids) per tile of `group` blocks,
// nblocks % group == 0.
int adc_scan_topk_sorted_launch(const void* lut, const void* hilo, const void* codes,
                                const void* bias, void* out_s, void* out_i, const void* wbase,
                                int nq, int nblocks, int block_size, int grid_x, int m, int kc,
                                int c, int kb, int group, int qt, int ms, int skew,
                                void* stream) {
    return launch<SORTED>(lut, hilo, codes, bias, out_s, out_i, wbase, nq, nblocks, block_size,
                          grid_x, m, kc, c, kb, group, qt, ms, skew, stream);
}

}  // extern "C"
