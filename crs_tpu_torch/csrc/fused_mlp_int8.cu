// The fused SwiGLU MLP decode block over int8 weights, for Hopper (sm_90a).
//
// Replaces the TPU kernel crs_tpu/ops/fused_mlp.py:fused_mlp_int8 / _kernel.
// For decode-sized rows x [R ≤ 8, H] (f32), the norm scale g [H], gate_t and
// up_t [I, H] int8 with per-I scales, down [I, H] int8 with per-H scales:
//
//   xn    = x · rsqrt(Σ x² · f32(1/H) + eps) · g               (per row)
//   xs    = max(max|xn|, 1e-12) · f32(1/127),  xq = rint(xn / xs) ∈ [-127, 127]
//   g_i   = f32(Σ_h xq·gate_t[i]) · xs · s_gate[i],  u_i likewise
//   hmid  = (1 / (1 + exp(-g))) · g · u
//   per (row, chunk c of I): hs = max(max|hmid|, 1e-12) · f32(1/127),
//                            hq = rint(hmid / hs)
//   y     = Σ_c f32(Σ_{i∈c} hq_i · down[i]) · hs_c            (in chunk order)
//   out   = x + y · s_down
//
// every product and sum rounded on its own (no contraction into FMA), as
// the Pallas body and the plain version (ops/fused_mlp.py
// emulate_fused_mlp_int8) compute them. The int32 dots are exact in any
// order, and 127²·1024 < 2²⁴ makes each chunk's down sum exact in f32.
//
// What bounds it on an H100: bytes. The three weight stacks are read once,
// 3·I·H int8 (mistral-7b: 3·14336·4096 = 176 MB, 52.6 µs at 3.35 TB/s),
// against 2·R·3·I·H int8 operations (≈ 1.4 µs at 1,979 TOPS for R = 8).
//
// Design (simple and right first). The TPU kernel is one sequential loop
// over I chunks with double-buffered DMAs; on 132 SMs that shape would run
// a handful of blocks, so the same arithmetic is cut into five launches on
// the caller's stream:
//   1. prologue  — one block per row: RMSNorm, × g, amax → xs, xq.
//   2. gate/up   — 8 warps per block, 4 outputs i per warp: the warp reads
//                  the contiguous rows gate_t[i] and up_t[i] with 16-byte
//                  loads (the reason the layout transposes them) and dots
//                  them with __dp4a against xq staged in shared memory; the
//                  warp's int32 sums meet by shuffles; the lane of row r
//                  writes hmid[r, i].
//   3. requant   — one block per (chunk, row): hs and hq.
//   4. down      — one block per (512-column tile, row slice of a chunk,
//                  chunk): each thread owns 4 columns, reads 4 rows of
//                  down as 32-bit words, transposes the 4×4 bytes with
//                  __byte_perm and dots them with __dp4a against hq; each
//                  block writes its int32 partial [slice, chunk, R, H].
//   5. epilogue  — per (row, column): add the slices' partials (exact), then
//                  y += f32(acc)·hs in chunk order, out = x + y·s_down.
// The result has the same bits on every run. Making it fast (cp.async/TMA
// rings, s8 tensor cores, one launch) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_R = 8;
constexpr int PRO_THREADS = 256;
constexpr int GU_WARPS = 8;
constexpr int GU_THREADS = 32 * GU_WARPS;
constexpr int GU_OUT_PER_WARP = 4;
constexpr int GU_OUT_PER_BLOCK = GU_WARPS * GU_OUT_PER_WARP;  // 32 outputs of I
constexpr int RQ_THREADS = 256;
constexpr int DN_THREADS = 128;
constexpr int DN_COLS = 4;                         // columns per thread
constexpr int DN_TILE = DN_THREADS * DN_COLS;      // 512 columns per block
constexpr int EP_THREADS = 256;
constexpr int DEFAULT_SMEM = 48 * 1024;
constexpr float INV_127 = 1.0f / 127.0f;           // f32(1)/f32(127), as XLA folds x / 127

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, v, off);
        v = is_max ? fmaxf(v, o) : __fadd_rn(v, o);
    }
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;  // 0: neutral for Σ and max|·|
        #pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float o = __shfl_xor_sync(0xffffffffu, v, off);
            v = is_max ? fmaxf(v, o) : __fadd_rn(v, o);
        }
        if (lane == 0) red[0] = v;
    }
    __syncthreads();
    v = red[0];
    __syncthreads();
    return v;
}

__device__ __forceinline__ int8_t quantize(float v, float scale) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.0f), 127.0f);
    return static_cast<int8_t>(q);
}

// 1. One block per row: xs[r] and xq[r, :].
__global__ void __launch_bounds__(PRO_THREADS)
fused_mlp_prologue_kernel(const float* __restrict__ x, const float* __restrict__ g,
                int8_t* __restrict__ xq, float* __restrict__ xs, int H, float inv_h, float eps) {
    __shared__ float red[32];
    const int r = blockIdx.x;
    const float* xr = x + (size_t)r * H;
    float s = 0.0f;
    for (int j = threadIdx.x; j < H; j += blockDim.x) s = __fadd_rn(s, __fmul_rn(xr[j], xr[j]));
    s = block_reduce(s, red, false);
    const float rs = rsqrtf(__fadd_rn(__fmul_rn(s, inv_h), eps));
    float m = 0.0f;
    for (int j = threadIdx.x; j < H; j += blockDim.x)
        m = fmaxf(m, fabsf(__fmul_rn(__fmul_rn(xr[j], rs), g[j])));
    m = block_reduce(m, red, true);
    const float scale = __fmul_rn(fmaxf(m, 1e-12f), INV_127);
    for (int j = threadIdx.x; j < H; j += blockDim.x)
        xq[(size_t)r * H + j] = quantize(__fmul_rn(__fmul_rn(xr[j], rs), g[j]), scale);
    if (threadIdx.x == 0) xs[r] = scale;
}

// 2. hmid[r, i] for GU_OUT_PER_BLOCK outputs i per block.
template <int R>
__global__ void __launch_bounds__(GU_THREADS)
fused_mlp_gateup_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
              const int8_t* __restrict__ gate_t, const float* __restrict__ s_gate,
              const int8_t* __restrict__ up_t, const float* __restrict__ s_up,
              float* __restrict__ hmid, int H, int I) {
    extern __shared__ __align__(16) int8_t sx[];  // [R, H]
    const int4* src = reinterpret_cast<const int4*>(xq);
    int4* dst = reinterpret_cast<int4*>(sx);
    const int words = R * H / 16;
    for (int k = threadIdx.x; k < words; k += blockDim.x) dst[k] = src[k];
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int hw = H / 16;  // 16-byte words per row
    float xsr[R];
    #pragma unroll
    for (int r = 0; r < R; ++r) xsr[r] = xs[r];
    for (int o = 0; o < GU_OUT_PER_WARP; ++o) {
        const int i = blockIdx.x * GU_OUT_PER_BLOCK + warp * GU_OUT_PER_WARP + o;
        if (i >= I) break;
        const int4* grow = reinterpret_cast<const int4*>(gate_t + (size_t)i * H);
        const int4* urow = reinterpret_cast<const int4*>(up_t + (size_t)i * H);
        int accg[R], accu[R];
        #pragma unroll
        for (int r = 0; r < R; ++r) accg[r] = accu[r] = 0;
        #pragma unroll 4
        for (int k = lane; k < hw; k += 32) {
            const int4 gw = __ldg(grow + k);
            const int4 uw = __ldg(urow + k);
            #pragma unroll
            for (int r = 0; r < R; ++r) {
                const int4 xv = reinterpret_cast<const int4*>(sx + (size_t)r * H)[k];
                accg[r] = __dp4a(gw.x, xv.x, accg[r]);
                accg[r] = __dp4a(gw.y, xv.y, accg[r]);
                accg[r] = __dp4a(gw.z, xv.z, accg[r]);
                accg[r] = __dp4a(gw.w, xv.w, accg[r]);
                accu[r] = __dp4a(uw.x, xv.x, accu[r]);
                accu[r] = __dp4a(uw.y, xv.y, accu[r]);
                accu[r] = __dp4a(uw.z, xv.z, accu[r]);
                accu[r] = __dp4a(uw.w, xv.w, accu[r]);
            }
        }
        #pragma unroll
        for (int r = 0; r < R; ++r) {
            #pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                accg[r] += __shfl_xor_sync(0xffffffffu, accg[r], off);
                accu[r] += __shfl_xor_sync(0xffffffffu, accu[r], off);
            }
        }
        const float sg = s_gate[i], su = s_up[i];
        #pragma unroll
        for (int r = 0; r < R; ++r) {
            if (lane == r) {
                const float gg = __fmul_rn(__fmul_rn(static_cast<float>(accg[r]), xsr[r]), sg);
                const float uu = __fmul_rn(__fmul_rn(static_cast<float>(accu[r]), xsr[r]), su);
                const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-gg)));
                hmid[(size_t)r * I + i] = __fmul_rn(__fmul_rn(sig, gg), uu);
            }
        }
    }
}

// 3. One block per (chunk, row): hs[r, c] and hq[r, chunk c].
__global__ void __launch_bounds__(RQ_THREADS)
fused_mlp_requant_kernel(const float* __restrict__ hmid, int8_t* __restrict__ hq, float* __restrict__ hs,
               int I, int chunk) {
    __shared__ float red[32];
    const int c = blockIdx.x, r = blockIdx.y, nchunks = gridDim.x;
    const float* hr = hmid + (size_t)r * I + (size_t)c * chunk;
    float m = 0.0f;
    for (int k = threadIdx.x; k < chunk; k += blockDim.x) m = fmaxf(m, fabsf(hr[k]));
    m = block_reduce(m, red, true);
    const float scale = __fmul_rn(fmaxf(m, 1e-12f), INV_127);
    int8_t* qr = hq + (size_t)r * I + (size_t)c * chunk;
    for (int k = threadIdx.x; k < chunk; k += blockDim.x) qr[k] = quantize(hr[k], scale);
    if (threadIdx.x == 0) hs[r * nchunks + c] = scale;
}

// 4. acc[s, c, r, j] = Σ_{i in slice s of chunk c} hq[r, i] · down[i, j].
template <int R>
__global__ void __launch_bounds__(DN_THREADS)
fused_mlp_down_kernel(const int8_t* __restrict__ hq, const int8_t* __restrict__ down,
            int32_t* __restrict__ acc, int H, int I, int chunk, int slice) {
    extern __shared__ __align__(16) int sh[];  // [R, slice / 4] packed hq words
    const int c = blockIdx.z, s = blockIdx.y, nchunks = gridDim.z;
    const int i0 = c * chunk + s * slice;
    const int wps = slice / 4;
    for (int k = threadIdx.x; k < R * wps; k += blockDim.x) {
        const int r = k / wps, w = k % wps;
        sh[k] = *reinterpret_cast<const int*>(hq + (size_t)r * I + i0 + 4 * w);
    }
    __syncthreads();
    const int j0 = blockIdx.x * DN_TILE + threadIdx.x * DN_COLS;
    if (j0 >= H) return;
    int a[R][DN_COLS];
    #pragma unroll
    for (int r = 0; r < R; ++r)
        #pragma unroll
        for (int k = 0; k < DN_COLS; ++k) a[r][k] = 0;
    const int8_t* base = down + (size_t)i0 * H + j0;
    #pragma unroll 4
    for (int w = 0; w < wps; ++w) {
        const int8_t* p = base + (size_t)(4 * w) * H;
        const unsigned w0 = __ldg(reinterpret_cast<const unsigned*>(p));
        const unsigned w1 = __ldg(reinterpret_cast<const unsigned*>(p + H));
        const unsigned w2 = __ldg(reinterpret_cast<const unsigned*>(p + 2 * (size_t)H));
        const unsigned w3 = __ldg(reinterpret_cast<const unsigned*>(p + 3 * (size_t)H));
        // 4 rows × 4 columns of bytes → one word of 4 rows per column
        const unsigned lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
        const unsigned lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
        const int t0 = static_cast<int>(__byte_perm(lo01, lo23, 0x5410));
        const int t1 = static_cast<int>(__byte_perm(lo01, lo23, 0x7632));
        const int t2 = static_cast<int>(__byte_perm(hi01, hi23, 0x5410));
        const int t3 = static_cast<int>(__byte_perm(hi01, hi23, 0x7632));
        #pragma unroll
        for (int r = 0; r < R; ++r) {
            const int hw = sh[r * wps + w];
            a[r][0] = __dp4a(t0, hw, a[r][0]);
            a[r][1] = __dp4a(t1, hw, a[r][1]);
            a[r][2] = __dp4a(t2, hw, a[r][2]);
            a[r][3] = __dp4a(t3, hw, a[r][3]);
        }
    }
    #pragma unroll
    for (int r = 0; r < R; ++r) {
        int32_t* o = acc + (((size_t)s * nchunks + c) * R + r) * H + j0;
        *reinterpret_cast<int4*>(o) = make_int4(a[r][0], a[r][1], a[r][2], a[r][3]);
    }
}

// 5. out[r, j] = x[r, j] + (Σ_c f32(Σ_s acc[s, c, r, j]) · hs[r, c]) · s_down[j].
__global__ void __launch_bounds__(EP_THREADS)
fused_mlp_epilogue_kernel(const float* __restrict__ x, const int32_t* __restrict__ acc,
                const float* __restrict__ hs, const float* __restrict__ s_down,
                float* __restrict__ out, int R, int H, int nchunks, int ksplit) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= R * H) return;
    const int r = idx / H, j = idx % H;
    float y = 0.0f;
    for (int c = 0; c < nchunks; ++c) {
        int a = 0;
        for (int s = 0; s < ksplit; ++s) a += acc[(((size_t)s * nchunks + c) * R + r) * H + j];
        y = __fadd_rn(y, __fmul_rn(static_cast<float>(a), hs[r * nchunks + c]));
    }
    out[idx] = __fadd_rn(x[idx], __fmul_rn(y, s_down[j]));
}

template <int R>
cudaError_t launch_rows(const int8_t* xq, const float* xs, const int8_t* gate_t,
                        const float* s_gate, const int8_t* up_t, const float* s_up,
                        const int8_t* down, const float* s_down, const float* x, float* hmid,
                        int8_t* hq, float* hs, int32_t* acc, float* out, int H, int I,
                        int chunk, int ksplit, cudaStream_t stream) {
    const int gu_smem = R * H;
    if (gu_smem > DEFAULT_SMEM) {
        const cudaError_t e = cudaFuncSetAttribute(
            fused_mlp_gateup_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, gu_smem);
        if (e != cudaSuccess) return e;
    }
    fused_mlp_gateup_kernel<R><<<(I + GU_OUT_PER_BLOCK - 1) / GU_OUT_PER_BLOCK, GU_THREADS, gu_smem,
                       stream>>>(xq, xs, gate_t, s_gate, up_t, s_up, hmid, H, I);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int nchunks = I / chunk;
    fused_mlp_requant_kernel<<<dim3(nchunks, R), RQ_THREADS, 0, stream>>>(hmid, hq, hs, I, chunk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int slice = chunk / ksplit;
    const dim3 grid((H + DN_TILE - 1) / DN_TILE, ksplit, nchunks);
    fused_mlp_down_kernel<R><<<grid, DN_THREADS, R * slice, stream>>>(hq, down, acc, H, I, chunk, slice);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    fused_mlp_epilogue_kernel<<<(R * H + EP_THREADS - 1) / EP_THREADS, EP_THREADS, 0, stream>>>(
        x, acc, hs, s_down, out, R, H, nchunks, ksplit);
    return cudaGetLastError();
}

}  // namespace

// The wrapper (ops/fused_mlp.py) allocates every buffer: xq [R, H] int8,
// xs [R], hmid [R, I] f32, hq [R, I] int8, hs [R, I/chunk], acc [ksplit,
// I/chunk, R, H] int32, out [R, H] f32. Enqueues the five kernels on
// `stream` and returns the CUDA error of the first launch that failed, or 0.
extern "C" int fused_mlp_int8_launch(
        const float* x, const float* g, const int8_t* gate_t, const float* s_gate,
        const int8_t* up_t, const float* s_up, const int8_t* down, const float* s_down,
        int8_t* xq, float* xs, float* hmid, int8_t* hq, float* hs, int32_t* acc, float* out,
        int R, int H, int I, int chunk, int ksplit, float eps, cudaStream_t stream) {
    if (R < 1 || R > MAX_R || H % 128 || chunk % 128 || I <= 0 || I % chunk || ksplit < 1
            || chunk % ksplit || (chunk / ksplit) % 16 || R * (chunk / ksplit) > DEFAULT_SMEM
            || R * H > 227 * 1024)
        return static_cast<int>(cudaErrorInvalidValue);
    const float inv_h = 1.0f / static_cast<float>(H);
    fused_mlp_prologue_kernel<<<R, PRO_THREADS, 0, stream>>>(x, g, xq, xs, H, inv_h, eps);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    switch (R) {
#define ROWS_CASE(N)                                                                     \
        case N:                                                                          \
            e = launch_rows<N>(xq, xs, gate_t, s_gate, up_t, s_up, down, s_down, x, hmid, \
                               hq, hs, acc, out, H, I, chunk, ksplit, stream);           \
            break;
        ROWS_CASE(1) ROWS_CASE(2) ROWS_CASE(3) ROWS_CASE(4)
        ROWS_CASE(5) ROWS_CASE(6) ROWS_CASE(7) ROWS_CASE(8)
#undef ROWS_CASE
    }
    return static_cast<int>(e);
}
