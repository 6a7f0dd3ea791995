// Single-token decode attention over an int8 KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel crs_tpu/ops/decode_attention.py:
// decode_attention_int8 / _decode_attn_kernel. Per (batch row b, kv-head h),
// with G query heads on that kv-head and head dim HD = 128:
//   scores[g, s] = (Σ_d bf16(q[g, d]) · k[s, d]) · (k_scale[s] · scale) + bias[s]
//   m = max_s scores, e = exp(scores − m), l = Σ_s e      (one pass, no rescaling)
//   p[g, s] = bf16((e / max(l, 1e-30)) · v_scale[s])
//   ctx[g, d] = Σ_s p[g, s] · v[s, d]                       (f32 sums)
// k, v are the int8 codes [S, HD] (exact in bf16), bias is 0 for a valid slot
// and -1e30 otherwise (additive, as the TPU kernel has it). The wrapper zeroes
// the rows of a batch with no valid slot. Every product is exact in f32, so
// the kernel differs from the plain version (ops/decode_attention.py
// emulate_decode_attention_int8) in the order of the f32 sums, in exp's last
// bit, and where either flips a bf16 rounding of p.
//
// What bounds it on an H100: every step reads the whole cache once, so it is
// bound by bytes: 2·B·Hkv·S·(HD + 4) cache bytes at 3.35 TB/s (B = 8, Hkv = 8,
// S = 4096: 68 MB ≈ 20 µs).
//
// Design (simple and right first): one CUDA block of 256 threads per
// (b, h), three passes over S with the [G, S] score rows in shared memory
// (G = 2, S = 4096: 32 KB). Lanes 8r..8r+7 of a warp read one cached row as
// 8 × 16 bytes, so a warp reads 4 whole rows per load and the 8 warps 32 rows.
// Pass 1 forms the scores (dot over the 8 lanes by shuffles); pass 2 takes
// max and sum per g by block reductions in a fixed order and overwrites the
// scores with p; pass 3 accumulates p · v per lane, reduces over the 4 rows
// of a warp by shuffles and over the 8 warps in warp order. One block per
// (b, h) fills at most B·Hkv SMs: splitting S over blocks is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SEG = 16;                      // int8 values per lane per row (16 bytes)
constexpr int LANES_PER_ROW = HD / SEG;      // 8
constexpr int ROWS_PER_WARP = 32 / LANES_PER_ROW;  // 4
constexpr int ROWS_PER_STEP = WARPS * ROWS_PER_WARP;  // 32

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

// reduce `v` over the block (max or sum) in a fixed order; every thread gets it
template <bool MAX>
__device__ float block_reduce(float v, float* scratch) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, v, off);
        v = MAX ? fmaxf(v, o) : v + o;
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();  // scratch may still be read from the previous reduction
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    float r = scratch[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) r = MAX ? fmaxf(r, scratch[w]) : r + scratch[w];
    return r;
}

template <int G>
__global__ void __launch_bounds__(THREADS)
decode_attention_int8_kernel(const float* __restrict__ q,        // [B·Hkv, G, HD]
                             const int8_t* __restrict__ k_codes, // [B·Hkv, S, HD]
                             const float* __restrict__ k_scales, // [B·Hkv, S]
                             const int8_t* __restrict__ v_codes,
                             const float* __restrict__ v_scales,
                             const float* __restrict__ bias,     // [B, S]
                             float* __restrict__ out,            // [B·Hkv, G, HD]
                             int hkv, int S, float scale) {
    extern __shared__ __align__(16) float smem[];
    float* sc = smem;                        // [G][S]: scores, then p
    float* red = sc + G * S;                 // [WARPS][G][HD]
    float* scratch = red + WARPS * G * HD;   // [WARPS]
    const int bh = blockIdx.x;
    const int b = bh / hkv;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int rr = lane / LANES_PER_ROW, seg = lane % LANES_PER_ROW;
    const size_t kv_base = (size_t)bh * S * HD;
    const size_t s_base = (size_t)bh * S;

    float qr[G][SEG];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < SEG; ++j) qr[g][j] = bf16_round(q[((size_t)bh * G + g) * HD + seg * SEG + j]);

    // pass 1: scores
#pragma unroll 2
    for (int s0 = 0; s0 < S; s0 += ROWS_PER_STEP) {
        const int s = s0 + warp * ROWS_PER_WARP + rr;
        float kv[SEG];
        unpack16(__ldg(reinterpret_cast<const int4*>(k_codes + kv_base + (size_t)s * HD + seg * SEG)), kv);
        float dot[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
            dot[g] = 0.f;
#pragma unroll
            for (int j = 0; j < SEG; ++j) dot[g] = fmaf(qr[g][j], kv[j], dot[g]);
#pragma unroll
            for (int off = LANES_PER_ROW / 2; off > 0; off >>= 1)
                dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
        }
        if (seg == 0) {
            const float ks = __fmul_rn(k_scales[s_base + s], scale);
            const float bs = bias[(size_t)b * S + s];
#pragma unroll
            for (int g = 0; g < G; ++g) sc[g * S + s] = __fadd_rn(__fmul_rn(dot[g], ks), bs);
        }
    }
    __syncthreads();

    // pass 2: softmax per query head; p overwrites the scores
#pragma unroll 1
    for (int g = 0; g < G; ++g) {
        float m = __int_as_float(0xff800000);  // -inf
        for (int s = tid; s < S; s += THREADS) m = fmaxf(m, sc[g * S + s]);
        m = block_reduce<true>(m, scratch);
        float l = 0.f;
        for (int s = tid; s < S; s += THREADS) l += expf(__fsub_rn(sc[g * S + s], m));
        l = block_reduce<false>(l, scratch);
        const float den = fmaxf(l, 1e-30f);
        for (int s = tid; s < S; s += THREADS) {
            const float e = expf(__fsub_rn(sc[g * S + s], m));
            sc[g * S + s] = bf16_round(__fmul_rn(__fdiv_rn(e, den), v_scales[s_base + s]));
        }
    }
    __syncthreads();

    // pass 3: ctx = p · v
    float acc[G][SEG];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < SEG; ++j) acc[g][j] = 0.f;
#pragma unroll 2
    for (int s0 = 0; s0 < S; s0 += ROWS_PER_STEP) {
        const int s = s0 + warp * ROWS_PER_WARP + rr;
        float vv[SEG];
        unpack16(__ldg(reinterpret_cast<const int4*>(v_codes + kv_base + (size_t)s * HD + seg * SEG)), vv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
            const float p = sc[g * S + s];
#pragma unroll
            for (int j = 0; j < SEG; ++j) acc[g][j] = fmaf(p, vv[j], acc[g][j]);
        }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < SEG; ++j) {
            acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], LANES_PER_ROW);
            acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], 2 * LANES_PER_ROW);
        }
    if (rr == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int j = 0; j < SEG; ++j) red[(warp * G + g) * HD + seg * SEG + j] = acc[g][j];
    }
    __syncthreads();
    for (int idx = tid; idx < G * HD; idx += THREADS) {
        const int g = idx / HD, d = idx - g * HD;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += red[(w * G + g) * HD + d];
        out[((size_t)bh * G + g) * HD + d] = s;
    }
}

template <int G>
int launch_g(int blocks, int hkv, int S, float scale, cudaStream_t stream, const float* q,
             const int8_t* kc, const float* ks, const int8_t* vc, const float* vs,
             const float* bias, float* out) {
    const size_t smem = sizeof(float) * ((size_t)G * S + (size_t)WARPS * G * HD + WARPS);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(decode_attention_int8_kernel<G>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    decode_attention_int8_kernel<G><<<blocks, THREADS, smem, stream>>>(
        q, kc, ks, vc, vs, bias, out, hkv, S, scale);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_int8_head_dim() { return HD; }

// q [B·Hkv, G, 128] f32; k/v codes [B·Hkv, S, 128] int8; k/v scales
// [B·Hkv, S] f32; bias [B, S] f32; out [B·Hkv, G, 128] f32. S a multiple of
// 32 (the wrapper asks 128). Returns the CUDA error of the launch.
extern "C" int decode_attention_int8_launch(const void* q, const void* k_codes,
                                            const void* k_scales, const void* v_codes,
                                            const void* v_scales, const void* bias, void* out,
                                            int blocks, int hkv, int G, int S, float scale,
                                            void* stream) {
    if (blocks < 1 || hkv < 1 || blocks % hkv || S < ROWS_PER_STEP || S % ROWS_PER_STEP)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* qf = static_cast<const float*>(q);
    const auto* kc = static_cast<const int8_t*>(k_codes);
    const auto* ks = static_cast<const float*>(k_scales);
    const auto* vc = static_cast<const int8_t*>(v_codes);
    const auto* vs = static_cast<const float*>(v_scales);
    const auto* bs = static_cast<const float*>(bias);
    auto* o = static_cast<float*>(out);
    switch (G) {
        case 1: return launch_g<1>(blocks, hkv, S, scale, st, qf, kc, ks, vc, vs, bs, o);
        case 2: return launch_g<2>(blocks, hkv, S, scale, st, qf, kc, ks, vc, vs, bs, o);
        case 4: return launch_g<4>(blocks, hkv, S, scale, st, qf, kc, ks, vc, vs, bs, o);
        case 8: return launch_g<8>(blocks, hkv, S, scale, st, qf, kc, ks, vc, vs, bs, o);
        default: return (int)cudaErrorInvalidValue;
    }
}
