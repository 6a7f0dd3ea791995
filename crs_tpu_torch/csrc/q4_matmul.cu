// int4 and NF4 weight-only matmul for decode-sized row counts, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels crs_tpu/ops/qgemm.py:q4_matmul / _q4_kernel and
// nf4_matmul / _nf4_kernel. For x [R, K] (bf16), packed codes [K/2, N] and
// f32 group scales [K/group, N]:
//   w[2i, n]   = bf16(bf16(level(lo nibble of codes[i, n])) · bf16(scale))
//   w[2i+1, n] = the same with the hi nibble
//   out[r, n]  = Σ_k x[r, k] · w[k, n]                          (f32 sums)
// level() is the sign-extended nibble for int4 (lo = (p << 28) >> 28,
// hi = p >> 4, arithmetic) and NF4_LEVELS[unsigned nibble] for NF4. Every
// product of two bf16 values is exact in f32, so the result differs from the
// plain version (ops/qgemm.py emulate_*) only in the order of the f32 sums.
//
// What bounds it on an H100: at R ≤ 64 the packed weight is read once and
// each byte feeds 2·R multiply-adds, so it is bound by bytes: K/2·N code bytes
// plus K/group·N·4 scale bytes at 3.35 TB/s (1b's lm_head, 2048 → 32000:
// 32.8 MB codes + 2 MB scales ≈ 10 µs).
//
// Design (simple and right first): one CUDA block of 256 threads per
// (128-column tile, K slice, row tile of RT ≤ 8 rows). Lane l of every warp
// owns columns 4l..4l+3 of the tile and reads them as one 32-bit word per
// packed row, so a warp reads one contiguous 128-byte line; the 8 warps
// take interleaved packed rows. The row tile's x slice sits in shared memory
// as f32 and is read as broadcasts. The nibbles are unpacked and scaled in
// registers; each thread keeps RT × 4 f32 sums. At the end the 8 warps' sums
// are added in warp order through shared memory. When the columns alone give
// too few blocks for the card, the wrapper splits K over `ksplit` slices:
// each writes its own partial [ksplit, R, N] and a second kernel adds them
// in slice order, so the result has the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 4;                  // columns per thread (one 32-bit word)
constexpr int TILE_N = 32 * COLS;        // 128 columns per CUDA block
constexpr int CHUNK = 256;               // packed rows of x staged per pass
constexpr int MAX_RT = 8;
constexpr int SMEM_FLOATS = WARPS * MAX_RT * TILE_N;  // 8192 (32 KB), ≥ MAX_RT·2·CHUNK

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

template <int RT, bool NF4>
__global__ void __launch_bounds__(THREADS)
q4_matmul_kernel(const __nv_bfloat16* __restrict__ x,   // [R, 2·K2]
                 const uint8_t* __restrict__ codes,     // [K2, N]
                 const float* __restrict__ scales,      // [K2/gs2, N]
                 const float* __restrict__ levels,      // [16] (NF4 only)
                 float* __restrict__ out,               // [ksplit, R, N]
                 int R, int K2, int N, int gs2, int rows_per_split) {
    __shared__ __align__(16) float smem[SMEM_FLOATS];
    __shared__ float lut[16];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int n0 = blockIdx.x * TILE_N + lane * COLS;
    const int split = blockIdx.y;
    const int row0 = blockIdx.z * RT;
    const int k_begin = split * rows_per_split;
    const int k_end = k_begin + rows_per_split;
    const int K = 2 * K2;
    if (NF4 && tid < 16) lut[tid] = bf16_round(levels[tid]);

    float acc[RT][COLS];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int j = 0; j < COLS; ++j) acc[r][j] = 0.f;

    int g_cur = -1;
    float s_bf[COLS] = {0.f, 0.f, 0.f, 0.f};
    float* xs = smem;  // [RT][2·CHUNK]
    for (int c0 = k_begin; c0 < k_end; c0 += CHUNK) {
        const int c1 = min(c0 + CHUNK, k_end);
        const int width = 2 * (c1 - c0);
        __syncthreads();
        for (int idx = tid; idx < RT * width; idx += THREADS) {
            const int r = idx / width, c = idx - r * width;
            const int row = row0 + r;
            xs[r * 2 * CHUNK + c] =
                row < R ? __bfloat162float(x[(size_t)row * K + 2 * c0 + c]) : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int i = c0 + warp; i < c1; i += WARPS) {
            const int g = i / gs2;
            if (g != g_cur) {
                const float4 s = __ldg(reinterpret_cast<const float4*>(scales + (size_t)g * N + n0));
                s_bf[0] = bf16_round(s.x);
                s_bf[1] = bf16_round(s.y);
                s_bf[2] = bf16_round(s.z);
                s_bf[3] = bf16_round(s.w);
                g_cur = g;
            }
            const uint32_t word = __ldg(reinterpret_cast<const unsigned int*>(codes + (size_t)i * N + n0));
            float wlo[COLS], whi[COLS];
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
                const uint32_t b = (word >> (8 * j)) & 0xFFu;
                float lo, hi;
                if (NF4) {
                    lo = lut[b & 15u];
                    hi = lut[b >> 4];
                } else {
                    lo = (float)(((int)(b << 28)) >> 28);
                    hi = (float)(((int)(b << 24)) >> 28);
                }
                wlo[j] = bf16_round(lo * s_bf[j]);
                whi[j] = bf16_round(hi * s_bf[j]);
            }
            const int xi = 2 * (i - c0);
#pragma unroll
            for (int r = 0; r < RT; ++r) {
                const float2 xv = *reinterpret_cast<const float2*>(xs + r * 2 * CHUNK + xi);
#pragma unroll
                for (int j = 0; j < COLS; ++j) {
                    acc[r][j] = fmaf(xv.x, wlo[j], acc[r][j]);
                    acc[r][j] = fmaf(xv.y, whi[j], acc[r][j]);
                }
            }
        }
    }

    // the 8 warps' sums, added in warp order
    __syncthreads();
    float* red = smem;  // [WARPS][RT][TILE_N]
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int j = 0; j < COLS; ++j) red[(warp * RT + r) * TILE_N + lane * COLS + j] = acc[r][j];
    __syncthreads();
    for (int idx = tid; idx < RT * TILE_N; idx += THREADS) {
        const int r = idx / TILE_N, col = idx - r * TILE_N;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += red[(w * RT + r) * TILE_N + col];
        const int row = row0 + r;
        if (row < R) out[((size_t)split * R + row) * N + blockIdx.x * TILE_N + col] = s;
    }
}

// out[i] = Σ_s partials[s, i], in slice order
__global__ void q4_split_sum_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                    int ksplit, long long total) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total) return;
    float s = 0.f;
    for (int sp = 0; sp < ksplit; ++sp) s += partials[(long long)sp * total + i];
    out[i] = s;
}

template <int RT>
void launch_rt(dim3 grid, bool nf4, cudaStream_t stream, const __nv_bfloat16* x,
               const uint8_t* codes, const float* scales, const float* levels, float* dst,
               int R, int K2, int N, int gs2, int rows_per_split) {
    if (nf4)
        q4_matmul_kernel<RT, true><<<grid, THREADS, 0, stream>>>(
            x, codes, scales, levels, dst, R, K2, N, gs2, rows_per_split);
    else
        q4_matmul_kernel<RT, false><<<grid, THREADS, 0, stream>>>(
            x, codes, scales, levels, dst, R, K2, N, gs2, rows_per_split);
}

}  // namespace

extern "C" int q4_matmul_tile_n() { return TILE_N; }

// x [R, 2·K2] bf16; codes [K2, N] (int8 for int4, uint8 for NF4); scales
// [K2/gs2, N] f32; levels [16] f32 (NF4); partials [ksplit, R, N] f32 (used
// when ksplit > 1); out [R, N] f32. Returns the CUDA error of the launches.
extern "C" int q4_matmul_launch(const void* x, const void* codes, const void* scales,
                                const void* levels, void* partials, void* out, int R, int K2,
                                int N, int gs2, int ksplit, int nf4, void* stream) {
    if (R < 1 || K2 < 1 || N % TILE_N || gs2 < 1 || K2 % gs2 || ksplit < 1 || K2 % ksplit)
        return (int)cudaErrorInvalidValue;
    const int rt = R <= 1 ? 1 : R <= 2 ? 2 : R <= 4 ? 4 : 8;
    const dim3 grid(N / TILE_N, ksplit, (R + rt - 1) / rt);
    float* dst = static_cast<float*>(ksplit > 1 ? partials : out);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* cb = static_cast<const uint8_t*>(codes);
    const auto* sb = static_cast<const float*>(scales);
    const auto* lv = static_cast<const float*>(levels);
    const int rps = K2 / ksplit;
    switch (rt) {
        case 1: launch_rt<1>(grid, nf4, st, xb, cb, sb, lv, dst, R, K2, N, gs2, rps); break;
        case 2: launch_rt<2>(grid, nf4, st, xb, cb, sb, lv, dst, R, K2, N, gs2, rps); break;
        case 4: launch_rt<4>(grid, nf4, st, xb, cb, sb, lv, dst, R, K2, N, gs2, rps); break;
        default: launch_rt<8>(grid, nf4, st, xb, cb, sb, lv, dst, R, K2, N, gs2, rps); break;
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || ksplit == 1) return (int)err;
    const long long total = (long long)R * N;
    q4_split_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(partials), static_cast<float*>(out), ksplit, total);
    return (int)cudaGetLastError();
}
