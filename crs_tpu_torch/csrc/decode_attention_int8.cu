// Single-token decode attention over an int8 KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel crs_tpu/ops/decode_attention.py:
// decode_attention_int8 / _decode_attn_kernel. Per (batch row b, kv-head h),
// with G query heads on that kv-head and head dim HD (any multiple of 128,
// every head dim crs_tpu's gate admits):
//   scores[g, s] = (Σ_d bf16(q[g, d]) · k[s, d]) · (k_scale[s] · scale) + bias[s]
//   m = max_s scores, e = exp(scores − m), l = Σ_s e      (one global m and l)
//   p[g, s] = bf16((e / max(l, 1e-30)) · v_scale[s])
//   ctx[g, d] = Σ_s p[g, s] · v[s, d]                       (f32 sums)
// k, v are the int8 codes [S, HD] (exact in bf16), bias is 0 for a valid slot
// and -1e30 otherwise (additive, as the TPU kernel has it). The wrapper zeroes
// the rows of a batch with no valid slot. Every product is exact in f32, so
// the kernel differs from the plain version (ops/decode_attention.py
// emulate_decode_attention_int8) in the order of the f32 sums (l included),
// in exp's last bit, and where either flips a bf16 rounding of p.
//
// What bounds it on an H100: every step reads the whole cache once, so it is
// bound by bytes: 2·B·Hkv·S·(HD + 4) cache bytes at 3.35 TB/s (B = 8, Hkv = 8,
// S = 2176: 36.8 MB ≈ 11 µs).
//
// Design (flash-decode, split over S): the wrapper cuts S into `nchunk`
// chunks of `chunk_rows` rows (ops/decode_attention.py split_plan: at least
// two blocks per SM at B = 1 as at B = 8), and two launches of one block of
// 256 threads per (chunk, b·h) walk them:
//   1. decode_attention_int8_scores_kernel — the chunk's scores [G, rows]
//      (into shared memory and the `scores` scratch) and its statistics
//      m_c = max, l_c = Σ exp(s − m_c) per query head. Lanes 8r..8r+7 of a
//      warp read one cached row as 8 × 16 bytes, so a warp reads 4 rows per
//      load and the 8 warps 32; each thread keeps 4 such loads in flight
//      (2 for G = 8). More in flight held more registers and cost blocks
//      per SM: 8 loads, or the whole chunk staged in shared memory with
//      cp.async so load and compute no longer overlapped, both ran slower.
//   2. decode_attention_int8_pv_kernel — first the chunk's V loads go out;
//      then warp g forms m = max_c m_c and l = Σ_c l_c·exp(m_c − m) in chunk
//      order (the same in every block), p exactly as above (normalised by
//      the global l before its bf16 rounding: an online-softmax rescale
//      would round un-normalised p, another function), and the chunk's
//      partial ctx = Σ p·v, reduced over a warp's 4 rows by shuffles and
//      over the 8 warps in warp order. The last block of a (b, h) — a
//      self-resetting counter — adds the partials in chunk order. No float
//      atomics: the result has the same bits on every run.
// A chunk whose slots are all masked has m_c = -1e30 and l_c = its row
// count; exp(m_c − m) is 0 against any valid chunk, so it drops out. The
// whole cache is read, masked slots included.
//
// Shapes. A lane reads 16 bytes of a row, so a row takes HD / 16 lanes (8 at
// HD = 128; 16, 24 and 32 at 256, 384 and 512, a warp then reading 2, 1
// and 1 rows per load; at 384 a quarter of the lanes idle). A wider row
// (HD = 640, 768, ...: the WIDE instantiation, HD a runtime value) is read
// in segments of 512 bytes, one warp a row: the scores kernel adds each
// segment's q·k partial into the row's score in shared memory, in segment
// order, and applies the scale and bias after the last segment; the p·v
// kernel walks the chunk's rows once per segment and writes that segment's
// columns (V accumulated per segment, p formed once). The lanes past the
// row's end in its last segment idle. The kernels are
// built for G ∈ {1, 2, 4, 8} heads; a launch with more heads than 8 (the
// wrapper pads them to a multiple of 8, and a G between the built ones to
// the next, with zero heads) runs G / 8 slices of 8 along the grid's third
// dimension, each reading the cache (the slices of one chunk are adjacent
// in launch order, so the second finds it in L2). Any number of chunks is
// taken (the statistics are read in rounds of 32 chunks), so any S.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SEG = 16;                      // int8 values per lane per row (16 bytes)
constexpr int MAX_CHUNK_ROWS = 1024;
constexpr int MAX_G = 8;                     // query heads per launch slice, at most

constexpr int WIDE_SEGMENT = 512;            // bytes of a row a warp reads per segment (HD > 512)

// the layout of a row (or of one 512-byte segment of a wider row) over a warp
template <int HD>
struct RowLayout {
    static constexpr int ACTIVE = HD / SEG;  // lanes holding a row's bytes
    static constexpr int LANES = ACTIVE <= 8 ? 8 : ACTIVE <= 16 ? 16 : 32;  // lanes per row
    static constexpr int ROWS_PER_WARP = 32 / LANES;
    static constexpr int ROWS_PER_STEP = WARPS * ROWS_PER_WARP;
    static_assert(HD % 128 == 0 && ACTIVE <= 32, "head dim: a multiple of 128 up to 512");
};

// HD = 0: the WIDE instantiation (a runtime head dim past 512, in segments)
template <int HD>
using Layout = RowLayout<HD == 0 ? WIDE_SEGMENT : HD>;

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void unpack16(const int4 v, float (&out)[SEG]) {
    const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t) out[4 * i + t] = (float)(int8_t)((uint32_t)w[i] >> (8 * t));
}

// 16-byte loads in flight per thread: fewer for G = 8, whose sums take 128
// registers
template <int G>
constexpr int LOADS_IN_FLIGHT = G >= 8 ? 2 : 4;

// Grid (chunk, b·Hkv, slice of G heads); gt = the launch's heads per kv-head.
template <int HD, int G>
__global__ void __launch_bounds__(THREADS)
decode_attention_int8_scores_kernel(const float* __restrict__ q,        // [B·Hkv, gt, hd]
                                    const int8_t* __restrict__ k_codes, // [B·Hkv, S, hd]
                                    const float* __restrict__ k_scales, // [B·Hkv, S]
                                    const float* __restrict__ bias,     // [B, S]
                                    float* __restrict__ scores,         // [B·Hkv, gt, S]
                                    float* __restrict__ stats,          // [B·Hkv, nchunk, gt, 2]
                                    int hkv, int gt, int S, int chunk_rows, int hd, float scale) {
    constexpr bool WIDE = HD == 0;
    using L = Layout<HD>;
    constexpr int U = LOADS_IN_FLIGHT<G>;
    extern __shared__ __align__(16) float sc[];  // [G][chunk_rows]
    const int c = blockIdx.x, nchunk = gridDim.x, bh = blockIdx.y, g0 = blockIdx.z * G;
    const int b = bh / hkv;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int rr = lane / L::LANES, seg = lane % L::LANES;
    const int rowb = WIDE ? hd : HD;  // bytes of a cached row
    const int nseg = WIDE ? (hd + WIDE_SEGMENT - 1) / WIDE_SEGMENT : 1;
    const int s0 = c * chunk_rows;
    const int n = min(chunk_rows, S - s0);  // a multiple of 32
    const float* ksb = k_scales + (size_t)bh * S + s0;
    const float* bb = bias + (size_t)b * S + s0;

    for (int sg = 0; sg < nseg; ++sg) {
        const int col = sg * WIDE_SEGMENT + seg * SEG;  // this lane's 16 bytes of the row
        const bool active = seg < L::ACTIVE && col < rowb;
        const int8_t* kb = k_codes + ((size_t)bh * S + s0) * rowb + (active ? col : 0);
        float qr[G][SEG];
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int j = 0; j < SEG; j += 4) {
                float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                if (active)
                    v = __ldg(reinterpret_cast<const float4*>(
                        q + ((size_t)bh * gt + g0 + g) * rowb + col + j));
                qr[g][j] = bf16_round(v.x), qr[g][j + 1] = bf16_round(v.y);
                qr[g][j + 2] = bf16_round(v.z), qr[g][j + 3] = bf16_round(v.w);
            }

        for (int t0 = 0; t0 < n; t0 += U * L::ROWS_PER_STEP) {
            int4 kv[U];
            float ks[U], bs[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int row = t0 + u * L::ROWS_PER_STEP + warp * L::ROWS_PER_WARP + rr;
                kv[u] = make_int4(0, 0, 0, 0);
                if (t0 + u * L::ROWS_PER_STEP < n) {
                    if (active) kv[u] = __ldg(reinterpret_cast<const int4*>(kb + (size_t)row * rowb));
                    if (!WIDE && seg == 0) {
                        ks[u] = __ldg(ksb + row);
                        bs[u] = __ldg(bb + row);
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (t0 + u * L::ROWS_PER_STEP < n) {  // the same for every thread of the block
                    const int row = t0 + u * L::ROWS_PER_STEP + warp * L::ROWS_PER_WARP + rr;
                    float kf[SEG];
                    unpack16(kv[u], kf);
                    float dot[G];
#pragma unroll
                    for (int g = 0; g < G; ++g) {
                        dot[g] = 0.f;
#pragma unroll
                        for (int j = 0; j < SEG; ++j) dot[g] = fmaf(qr[g][j], kf[j], dot[g]);
#pragma unroll
                        for (int off = L::LANES / 2; off > 0; off >>= 1)
                            dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
                    }
                    if (seg == 0) {
                        if (WIDE) {  // the segment's partial, in segment order (same lane each time)
#pragma unroll
                            for (int g = 0; g < G; ++g) {
                                float* d = sc + g * chunk_rows + row;
                                *d = sg == 0 ? dot[g] : __fadd_rn(*d, dot[g]);
                            }
                        } else {
                            const float kss = __fmul_rn(ks[u], scale);
#pragma unroll
                            for (int g = 0; g < G; ++g)
                                sc[g * chunk_rows + row] = __fadd_rn(__fmul_rn(dot[g], kss), bs[u]);
                        }
                    }
                }
            }
        }
    }
    __syncthreads();
    if (WIDE) {  // the whole row's q·k is in: scale and bias
        for (int i = tid; i < G * n; i += THREADS) {
            const int g = i / n, j = i - g * n;
            float* d = sc + g * chunk_rows + j;
            *d = __fadd_rn(__fmul_rn(*d, __fmul_rn(__ldg(ksb + j), scale)), __ldg(bb + j));
        }
        __syncthreads();
    }

    for (int i = tid; i < G * n; i += THREADS) {
        const int g = i / n, j = i - g * n;
        scores[((size_t)bh * gt + g0 + g) * S + s0 + j] = sc[g * chunk_rows + j];
    }
    if (warp < G) {  // warp g: the chunk's max and sum of query head g
        const float* row = sc + warp * chunk_rows;
        float m = __int_as_float(0xff800000);  // -inf
        for (int i = lane; i < n; i += 32) m = fmaxf(m, row[i]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        float l = 0.f;
        for (int i = lane; i < n; i += 32) l += expf(__fsub_rn(row[i], m));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
        if (lane == 0) {
            float* st = stats + (((size_t)bh * nchunk + c) * gt + g0 + warp) * 2;
            st[0] = m;
            st[1] = l;
        }
    }
}

template <int HD, int G>
__global__ void __launch_bounds__(THREADS)
decode_attention_int8_pv_kernel(const float* __restrict__ scores,   // [B·Hkv, gt, S]
                                const float* __restrict__ stats,    // [B·Hkv, nchunk, gt, 2]
                                const int8_t* __restrict__ v_codes, // [B·Hkv, S, hd]
                                const float* __restrict__ v_scales, // [B·Hkv, S]
                                float* __restrict__ partials,       // [B·Hkv, nchunk, gt, hd]
                                int* __restrict__ counters,         // [B·Hkv, gt / G], zero between launches
                                float* __restrict__ out,            // [B·Hkv, gt, hd]
                                int gt, int S, int chunk_rows, int hd) {
    constexpr bool WIDE = HD == 0;
    using L = Layout<HD>;
    constexpr int SW = WIDE ? WIDE_SEGMENT : HD;  // columns of one pass
    constexpr int U = LOADS_IN_FLIGHT<G>;
    extern __shared__ __align__(16) float smem[];
    float* p = smem;                     // [G][chunk_rows]
    float* red = p + G * chunk_rows;     // [WARPS][G][SW]
    __shared__ float m_s[G], den_s[G];
    __shared__ int last_block;
    const int c = blockIdx.x, nchunk = gridDim.x, bh = blockIdx.y, g0 = blockIdx.z * G;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int rr = lane / L::LANES, seg = lane % L::LANES;
    const int rowb = WIDE ? hd : HD;
    const int nseg = WIDE ? (hd + WIDE_SEGMENT - 1) / WIDE_SEGMENT : 1;
    const int s0 = c * chunk_rows;
    const int n = min(chunk_rows, S - s0);
    const int lrow = warp * L::ROWS_PER_WARP + rr;
    bool active = seg < L::ACTIVE && seg * SEG < rowb;
    const int8_t* vb = v_codes + ((size_t)bh * S + s0) * rowb + (active ? seg * SEG : 0);

    // the first V loads go out before the softmax work
    int4 vv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        vv[u] = make_int4(0, 0, 0, 0);
        if (active && u * L::ROWS_PER_STEP < n)
            vv[u] = __ldg(reinterpret_cast<const int4*>(vb + (size_t)(u * L::ROWS_PER_STEP + lrow) * rowb));
    }

    if (warp < G) {  // warp g: the global m and l of query head g
        const float* st = stats + ((size_t)bh * nchunk * gt + g0 + warp) * 2;  // chunk cc: + cc·gt·2
        float m = __int_as_float(0xff800000);
        for (int cc = lane; cc < nchunk; cc += 32) m = fmaxf(m, st[(size_t)cc * gt * 2]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        float l = 0.f;  // Σ_c l_c·exp(m_c − m), in chunk order, 32 chunks a round
        for (int c0 = 0; c0 < nchunk; c0 += 32) {
            const int cc = c0 + lane;
            float t = 0.f;
            if (cc < nchunk)
                t = __fmul_rn(st[(size_t)cc * gt * 2 + 1], expf(__fsub_rn(st[(size_t)cc * gt * 2], m)));
            const int nr = min(32, nchunk - c0);
            for (int i = 0; i < nr; ++i) l = __fadd_rn(l, __shfl_sync(0xffffffffu, t, i));
        }
        if (lane == 0) {
            m_s[warp] = m;
            den_s[warp] = fmaxf(l, 1e-30f);
        }
    }
    __syncthreads();
#pragma unroll 4
    for (int i = tid; i < G * n; i += THREADS) {
        const int g = i / n, j = i - g * n;
        const float e = expf(__fsub_rn(scores[((size_t)bh * gt + g0 + g) * S + s0 + j], m_s[g]));
        p[g * chunk_rows + j] =
            bf16_round(__fmul_rn(__fdiv_rn(e, den_s[g]), __ldg(v_scales + (size_t)bh * S + s0 + j)));
    }
    __syncthreads();

    float* dst = nchunk == 1 ? out + ((size_t)bh * gt + g0) * rowb
                             : partials + (((size_t)bh * nchunk + c) * gt + g0) * rowb;
    for (int sg = 0; sg < nseg; ++sg) {  // WIDE: one pass per 512-byte segment of the row
        const int col0 = sg * WIDE_SEGMENT;
        if (sg > 0) {
            active = seg < L::ACTIVE && col0 + seg * SEG < rowb;
            vb = v_codes + ((size_t)bh * S + s0) * rowb + (active ? col0 + seg * SEG : 0);
        }
        float acc[G][SEG];
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int j = 0; j < SEG; ++j) acc[g][j] = 0.f;
        for (int t0 = 0; t0 < n; t0 += U * L::ROWS_PER_STEP) {
            if (t0 > 0 || sg > 0) {
#pragma unroll
                for (int u = 0; u < U; ++u)
                    if (active && t0 + u * L::ROWS_PER_STEP < n)
                        vv[u] = __ldg(reinterpret_cast<const int4*>(
                            vb + (size_t)(t0 + u * L::ROWS_PER_STEP + lrow) * rowb));
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (t0 + u * L::ROWS_PER_STEP < n) {
                    const int row = t0 + u * L::ROWS_PER_STEP + lrow;
                    float vf[SEG];
                    unpack16(vv[u], vf);  // an idle lane's sums are never written
#pragma unroll
                    for (int g = 0; g < G; ++g) {
                        const float pg = p[g * chunk_rows + row];
#pragma unroll
                        for (int j = 0; j < SEG; ++j) acc[g][j] = fmaf(pg, vf[j], acc[g][j]);
                    }
                }
            }
        }
        // the warp's rows → one sum per (head, column): add the ROWS_PER_WARP rows
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int j = 0; j < SEG; ++j)
#pragma unroll
                for (int off = L::LANES; off < 32; off <<= 1)
                    acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], off);
        if (sg > 0) __syncthreads();  // the previous segment's sums are read
        if (rr == 0 && active) {
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
                for (int j = 0; j < SEG; ++j) red[(warp * G + g) * SW + seg * SEG + j] = acc[g][j];
        }
        __syncthreads();
        const int cols = min(SW, rowb - col0);
        for (int i = tid; i < G * SW; i += THREADS) {
            const int g = i / SW, j = i - g * SW;
            if (j >= cols) continue;
            float s = 0.f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) s += red[w * G * SW + i];
            dst[g * rowb + col0 + j] = s;
        }
    }
    if (nchunk == 1) return;

    // the last block of this (b, h, slice) adds the chunks' partials in chunk order
    int* counter = counters + (size_t)bh * gridDim.z + blockIdx.z;
    __threadfence();
    __syncthreads();
    if (tid == 0) last_block = atomicAdd(counter, 1) == nchunk - 1;
    __syncthreads();
    if (!last_block) return;
    __threadfence();
    const float* part = partials + ((size_t)bh * nchunk * gt + g0) * rowb;  // chunk cc: + cc·gt·hd
    for (int i = tid; i < G * rowb; i += THREADS) {
        float s = 0.f;
#pragma unroll 8
        for (int cc = 0; cc < nchunk; ++cc) s += __ldcg(part + (size_t)cc * gt * rowb + i);
        out[((size_t)bh * gt + g0) * rowb + i] = s;
    }
    if (tid == 0) *counter = 0;
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
    int bh, nchunk, hkv, gt, S, chunk_rows, hd;
    float scale;
    cudaStream_t stream;
    const float* q;
    const int8_t* kc;
    const float* ks;
    const int8_t* vc;
    const float* vs;
    const float* bias;
    float *scores, *stats, *partials;
    int* counters;
    float* out;
};

template <int HD, int G>
int launch_g(const Args& a) {
    const dim3 grid(a.nchunk, a.bh, a.gt / G);
    const size_t smem_scores = sizeof(float) * G * a.chunk_rows;
    const size_t smem_pv =
        sizeof(float) * ((size_t)G * a.chunk_rows + (size_t)WARPS * G * (HD == 0 ? WIDE_SEGMENT : HD));
    int e = allow_smem(decode_attention_int8_scores_kernel<HD, G>, smem_scores);
    if (e) return e;
    e = allow_smem(decode_attention_int8_pv_kernel<HD, G>, smem_pv);
    if (e) return e;
    decode_attention_int8_scores_kernel<HD, G><<<grid, THREADS, smem_scores, a.stream>>>(
        a.q, a.kc, a.ks, a.bias, a.scores, a.stats, a.hkv, a.gt, a.S, a.chunk_rows, a.hd, a.scale);
    e = (int)cudaGetLastError();
    if (e) return e;
    decode_attention_int8_pv_kernel<HD, G><<<grid, THREADS, smem_pv, a.stream>>>(
        a.scores, a.stats, a.vc, a.vs, a.partials, a.counters, a.out, a.gt, a.S, a.chunk_rows, a.hd);
    return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(const Args& a) {
    switch (a.gt) {
        case 1: return launch_g<HD, 1>(a);
        case 2: return launch_g<HD, 2>(a);
        case 4: return launch_g<HD, 4>(a);
        default: return a.gt % MAX_G ? (int)cudaErrorInvalidValue : launch_g<HD, MAX_G>(a);
    }
}

}  // namespace

extern "C" int decode_attention_int8_max_group() { return MAX_G; }
extern "C" int decode_attention_int8_max_chunk_rows() { return MAX_CHUNK_ROWS; }

// q [B·Hkv, G, hd] f32; k/v codes [B·Hkv, S, hd] int8; k/v scales
// [B·Hkv, S] f32; bias [B, S] f32; scratch: scores [B·Hkv, G, S] f32, stats
// [B·Hkv, nchunk, G, 2] f32, partials [B·Hkv, nchunk, G, hd] f32, counters
// [B·Hkv, G / 8 or 1] int32 (zero; left zero); out [B·Hkv, G, hd] f32.
// G ∈ {1, 2, 4} or a multiple of 8; hd a positive multiple of 128; S and
// chunk_rows multiples of 32, chunk_rows ≤ 1024, nchunk = ⌈S / chunk_rows⌉.
// Returns the CUDA error of the launches.
extern "C" int decode_attention_int8_launch(const void* q, const void* k_codes,
                                            const void* k_scales, const void* v_codes,
                                            const void* v_scales, const void* bias,
                                            void* scores, void* stats, void* partials,
                                            void* counters, void* out, int bh, int hkv, int G,
                                            int S, int chunk_rows, int nchunk, int hd,
                                            float scale, void* stream) {
    if (bh < 1 || hkv < 1 || bh % hkv || G < 1 || S < 32 || S % 32 || chunk_rows < 32 ||
        chunk_rows % 32 || chunk_rows > MAX_CHUNK_ROWS || nchunk < 1 ||
        nchunk != (S + chunk_rows - 1) / chunk_rows)
        return (int)cudaErrorInvalidValue;
    const Args a{bh, nchunk, hkv, G, S, chunk_rows, hd, scale, static_cast<cudaStream_t>(stream),
                 static_cast<const float*>(q), static_cast<const int8_t*>(k_codes),
                 static_cast<const float*>(k_scales), static_cast<const int8_t*>(v_codes),
                 static_cast<const float*>(v_scales), static_cast<const float*>(bias),
                 static_cast<float*>(scores), static_cast<float*>(stats),
                 static_cast<float*>(partials), static_cast<int*>(counters),
                 static_cast<float*>(out)};
    switch (hd) {
        case 128: return launch_hd<128>(a);
        case 256: return launch_hd<256>(a);
        case 384: return launch_hd<384>(a);
        case 512: return launch_hd<512>(a);
        default: return hd > 512 && hd % 128 == 0 ? launch_hd<0>(a) : (int)cudaErrorInvalidValue;
    }
}
