// The decode weight-streaming probes, for Hopper (sm_90a): the three kernels
// of the repository's GEMV-streaming tools (crs_tpu_torch/tools/), each with
// its plain version in crs_tpu_torch/ops/gemv_probe.py. One plain C launcher
// per kernel enqueues it on the given stream and returns the CUDA error.
//
// q4_probe_kernel replaces tools/bench_q4_kernel.py build_variant's run /
// _q4_kernel_var: x [rt, K/2] twice (xe pairs with the low nibble of each
// packed row, xo with the high nibble), a row scale xs [rt], packed codes
// [K/2, N] and f32 group scales [g, N] → out [rt, N] f32. K is cut into
// K-steps of kt2 = gpt·gs2 packed rows (gs2 = K/2 / g rows a group, gpt the
// tool's groups per step), and out = Σ_steps step_sum · xs in step order.
//   unfolded (FOLD false): step_sum = Σ_groups f32(Σ_k xe·lo + xo·hi) ·
//     scales[group] in group order, the inner sums exact in int32; lo, hi
//     the sign-extended nibbles, or both the raw byte (RAW: the tool's
//     "none" probe);
//   fold (FOLD true): bf16 xe, xo against bf16(nibble · bf16(scale)), f32
//     sums, where packed row j of step s takes scales[s·gpt + (j mod gpt)]:
//     pltpu.repeat tiles the step's gpt scale rows, it does not repeat each
//     one (kernel 8's mapping, the own group's scale, differs).
// Bound at the tool's defaults (R 32 → rt 32, K 2048, N 32000, g 16): the
// 32.8 MB of codes and 2 MB of scales at 3.35 TB/s, ≈ 10.4 µs; the codes fit
// in the 50 MB L2, so the tool's loop over one matrix reads them from there.
// Design: a block of 4 warps owns 128 columns (a 4-byte word of a packed row
// per lane, 128 contiguous bytes a warp) and 32 rows (8 a warp); its rows of
// x are staged in shared memory 128 packed rows at a time and read by the
// whole warp at once (broadcast). The four warps read the same codes, the
// three after the first from L1. Unfolded, the lane turns its 4 × 4 bytes
// (4 packed rows × 4 columns) into one word of 4 k per column (byte
// permutes) and takes both nibbles at once as 16 × the signed nibble:
// (w << 4) & 0xF0F0F0F0 and w & 0xF0F0F0F0, each byte an int8, so one
// __dp4a gives 16 × four products; the group's int32 sum is shifted back by
// 4 (exact), converted once and scaled with f32 operations that are not
// contracted, in the Pallas kernel's order. Fold: the lane dequantises its
// 16 weights per 4 rows (exact f32 product, one bf16 rounding) and sums
// bf16 x · bf16 w in f32 (each product exact) with FMAs.
//
// q8_gemv_kernel replaces tools/bench_chain_gemv.py q8mm / k8 (a W8A16
// GEMV): x [R, K] bf16 (R ≤ 16), codes [K, N] int8, scales [N] f32 → out
// [R, N] = Σ_tiles (x_tile · bf16(codes_tile), f32 sums) · scale over K
// tiles of 512 rows. Bound at d 2048: the 4.19 MB of codes at 3.35 TB/s, ≈
// 1.25 µs. Design: a block of 8 warps owns 128 columns; a lane loads 16
// bytes (16 columns) of a row, 8 lanes a row's 128 contiguous bytes, and the
// block's 32 lanes-groups take every 32nd row of its K slice. Each slice of
// K lies in one tile or is cut at tile edges into segments; a segment's sums
// are added over the lanes-groups (shuffles, then the warps in order through
// shared memory), multiplied by the scale and added to the block's total.
// K is split into ≤ 8 slices, the blocks of a column slab forming one
// thread-block cluster: each block stores its totals into the shared memory
// of the block that owns them, and after one cluster barrier each owner
// adds them in slice order. Rows run in passes of 8 (R > 8 reads the codes
// twice, the second time from L1 / L2).
//
// db_gemv_kernel replaces tools/bench_chain_gemv.py dbmm / kdb (a W8A16 GEMV
// against a row-major weight, streamed through a manual two-slot DMA double
// buffer): x [R, K] bf16 (R ≤ 8), w [N, K] int8 → out [R, N] = (x ·
// bf16(w)ᵀ, f32 sums) · scale. Bound at d 2048: the 4.19 MB of the weight,
// ≈ 1.25 µs. Design: a block of 8 warps owns 16 output rows, streamed in
// two stages of 8 rows (8·K bytes) through a two-slot cp.async ring in
// shared memory, the counterpart of kdb's two DMA slots and semaphores:
// the second stage is in flight while the first is summed. A warp sums one
// weight row: a lane reads 16 contiguous bytes of it at a time (512 a
// warp), x from L1, and the warp's sums meet by shuffles.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// Sets the dynamic shared memory limit of `kernel` to `bytes` once a
// process: the first call comes before any graph capture.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, int& done) {
    if (bytes <= 48 * 1024 || done >= (int)bytes) return cudaSuccess;
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return e;
    }
    done = (int)bytes;
    return cudaSuccess;
}

// -- q4_probe_kernel ---------------------------------------------------------------

constexpr int QP_ROWS = 32;   // rows of x a block owns (8 a warp)
constexpr int QP_WARPS = 4;
constexpr int QP_COLS = 128;  // columns a block owns (4 a lane)
constexpr int QP_CHUNK = 128; // packed rows of x staged at a time

// bytes (w0.b, w1.b, w2.b, w3.b) for each byte position b: 4 packed rows of
// one column, k ascending in the word
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&c)[4]) {
    const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), lo23 = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362), hi23 = __byte_perm(w[2], w[3], 0x7362);
    c[0] = __byte_perm(lo01, lo23, 0x5410);
    c[1] = __byte_perm(lo01, lo23, 0x7632);
    c[2] = __byte_perm(hi01, hi23, 0x5410);
    c[3] = __byte_perm(hi01, hi23, 0x7632);
}

template <bool FOLD, bool RAW>
__global__ void __launch_bounds__(32 * QP_WARPS)
q4_probe_kernel(const void* __restrict__ xe_, const void* __restrict__ xo_,
                const float* __restrict__ xs, const uint8_t* __restrict__ codes,
                const float* __restrict__ scales, float* __restrict__ out, int K2, int N, int gs2,
                int gpt) {
    using XT = typename std::conditional<FOLD, __nv_bfloat16, int8_t>::type;
    __shared__ __align__(16) XT sx[2][QP_ROWS][QP_CHUNK];
    const XT* xe = static_cast<const XT*>(xe_);
    const XT* xo = static_cast<const XT*>(xo_);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row0 = blockIdx.y * QP_ROWS;
    const int col = blockIdx.x * QP_COLS + 4 * lane;
    const bool live = col < N;
    const int kt2 = gpt * gs2;

    float total[8][4], kacc[8][4];
    int iacc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) total[r][c] = 0.f, kacc[r][c] = 0.f, iacc[r][c] = 0;

    for (int c0 = 0; c0 < K2; c0 += QP_CHUNK) {
        const int cn = min(QP_CHUNK, K2 - c0);
        __syncthreads();  // the previous chunk's readers are done
        for (int i = threadIdx.x; i < QP_ROWS * cn; i += 32 * QP_WARPS) {
            const int r = i / cn, j = i - r * cn;
            const size_t src = (size_t)(row0 + r) * K2 + c0 + j;
            sx[0][r][j] = xe[src];
            sx[1][r][j] = xo[src];
        }
        __syncthreads();
        for (int jj = 0; jj < cn; jj += 4) {
            const int j = c0 + jj;  // the first of 4 packed rows
            uint32_t w[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
                w[q] = live ? __ldg(reinterpret_cast<const unsigned int*>(
                                  codes + (size_t)(j + q) * N + col))
                            : 0u;
            if constexpr (!FOLD) {
                uint32_t cw[4], lo[4], hi[4];
                transpose4(w, cw);
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    lo[c] = RAW ? cw[c] : (cw[c] << 4) & 0xF0F0F0F0u;
                    hi[c] = RAW ? cw[c] : cw[c] & 0xF0F0F0F0u;
                }
#pragma unroll
                for (int r = 0; r < 8; ++r) {
                    const int e4 = *reinterpret_cast<const int*>(&sx[0][8 * warp + r][jj]);
                    const int o4 = *reinterpret_cast<const int*>(&sx[1][8 * warp + r][jj]);
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        iacc[r][c] = __dp4a(e4, (int)lo[c], iacc[r][c]);
                        iacc[r][c] = __dp4a(o4, (int)hi[c], iacc[r][c]);
                    }
                }
                if ((j + 4) % gs2 == 0) {  // the group ends: its f32 term, in group order
                    float s[4] = {0.f, 0.f, 0.f, 0.f};
                    if (live) {
                        const float4 v = __ldg(reinterpret_cast<const float4*>(
                            scales + (size_t)(j / gs2) * N + col));
                        s[0] = v.x, s[1] = v.y, s[2] = v.z, s[3] = v.w;
                    }
#pragma unroll
                    for (int r = 0; r < 8; ++r)
#pragma unroll
                        for (int c = 0; c < 4; ++c) {
                            const float v = (float)(RAW ? iacc[r][c] : iacc[r][c] >> 4);
                            kacc[r][c] = __fadd_rn(kacc[r][c], __fmul_rn(v, s[c]));
                            iacc[r][c] = 0;
                        }
                }
            } else {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int step = (j + q) / kt2;
                    // the step's gpt scale rows tiled, not each repeated
                    const int srow = step * gpt + (j + q - step * kt2) % gpt;
                    float s[4] = {0.f, 0.f, 0.f, 0.f};
                    if (live) {
                        const float4 v =
                            __ldg(reinterpret_cast<const float4*>(scales + (size_t)srow * N + col));
                        s[0] = bf16_round(v.x), s[1] = bf16_round(v.y);
                        s[2] = bf16_round(v.z), s[3] = bf16_round(v.w);
                    }
                    float wl[4], wh[4];
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const int b = (int)(int8_t)((w[q] >> (8 * c)) & 0xFFu);
                        const int l = RAW ? b : (int)((uint32_t)b << 28) >> 28;
                        const int h = RAW ? b : b >> 4;
                        wl[c] = bf16_round((float)l * s[c]);
                        wh[c] = bf16_round((float)h * s[c]);
                    }
#pragma unroll
                    for (int r = 0; r < 8; ++r) {
                        const float e = __bfloat162float(sx[0][8 * warp + r][jj + q]);
                        const float o = __bfloat162float(sx[1][8 * warp + r][jj + q]);
#pragma unroll
                        for (int c = 0; c < 4; ++c)
                            kacc[r][c] = fmaf(o, wh[c], fmaf(e, wl[c], kacc[r][c]));
                    }
                }
            }
            if ((j + 4) % kt2 == 0) {  // the K-step ends: × xs, added in step order
#pragma unroll
                for (int r = 0; r < 8; ++r) {
                    const float x_s = xs[row0 + 8 * warp + r];
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        total[r][c] = __fadd_rn(total[r][c], __fmul_rn(kacc[r][c], x_s));
                        kacc[r][c] = 0.f;
                    }
                }
            }
        }
    }
    if (!live) return;
#pragma unroll
    for (int r = 0; r < 8; ++r)
        *reinterpret_cast<float4*>(out + (size_t)(row0 + 8 * warp + r) * N + col) =
            make_float4(total[r][0], total[r][1], total[r][2], total[r][3]);
}

// -- q8_gemv_kernel ----------------------------------------------------------------

constexpr int Q8_THREADS = 256;
constexpr int Q8_COLS = 128;      // columns a block owns (16 a lane, 8 lanes a row)
constexpr int Q8_KLANES = 32;     // lanes-groups along K
constexpr int Q8_TILE = 512;      // k8's K tile
constexpr int Q8_MAX_ROWS = 16;
constexpr int Q8_MAX_CLUSTER = 8;

// shared memory: [x slice, k-major: slice_rows × 16 bf16][warp sums: 8 × 8 ×
// 128 f32][the block's totals: 16 × 128 f32][recv: ksplit × per_owner f32]
__global__ void __launch_bounds__(Q8_THREADS)
q8_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
               const float* __restrict__ scales, float* __restrict__ out, int R, int K, int N,
               int slice_rows, int ksplit) {
    extern __shared__ __align__(16) uint8_t smem[];
    __nv_bfloat16* sxt = reinterpret_cast<__nv_bfloat16*>(smem);
    float* red = reinterpret_cast<float*>(smem + (size_t)slice_rows * Q8_MAX_ROWS * 2);
    float* tot = red + 8 * 8 * Q8_COLS;
    float* recv = tot + Q8_MAX_ROWS * Q8_COLS;
    const int per_owner = (R * Q8_COLS + ksplit - 1) / ksplit;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int cl = lane & 7;                  // 16-column lane
    const int kl = warp * 4 + (lane >> 3);    // lanes-group along K
    const int slab = blockIdx.x, split = blockIdx.y;
    const int k_begin = split * slice_rows, k_end = min(K, k_begin + slice_rows);
    const int rows_here = k_end - k_begin;
    const int col0 = slab * Q8_COLS + 16 * cl;

    for (int i = tid; i < rows_here * Q8_MAX_ROWS; i += Q8_THREADS) {
        const int k = i / Q8_MAX_ROWS, r = i - k * Q8_MAX_ROWS;
        sxt[i] = r < R ? x[(size_t)r * K + k_begin + k] : __float2bfloat16_rn(0.f);
    }
    for (int i = tid; i < R * Q8_COLS; i += Q8_THREADS) tot[i] = 0.f;
    if (ksplit > 1)  // every block of the cluster has started before any writes into it
        asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    __syncthreads();

    for (int r0 = 0; r0 < R; r0 += 8) {
        for (int seg = k_begin; seg < k_end;) {
            const int seg_end = min(k_end, (seg / Q8_TILE + 1) * Q8_TILE);
            float acc[8][16];
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
                for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;
            for (int k = seg + kl; k < seg_end; k += Q8_KLANES) {
                const uint4 wv =
                    __ldg(reinterpret_cast<const uint4*>(codes + (size_t)k * N + col0));
                const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
                float wf[16];
#pragma unroll
                for (int c = 0; c < 16; ++c)
                    wf[c] = (float)(int8_t)((ww[c >> 2] >> (8 * (c & 3))) & 0xFFu);
                const uint4 xv = *reinterpret_cast<const uint4*>(
                    sxt + (size_t)(k - k_begin) * Q8_MAX_ROWS + r0);
                const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(&xv);
#pragma unroll
                for (int r = 0; r < 8; ++r) {
                    const float xr = __bfloat162float(xb[r]);
#pragma unroll
                    for (int c = 0; c < 16; ++c) acc[r][c] = fmaf(xr, wf[c], acc[r][c]);
                }
            }
            // the segment's sums: over the warp's 4 lanes-groups, then the warps in order
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
                for (int c = 0; c < 16; ++c) {
                    float v = acc[r][c];
                    v += __shfl_xor_sync(0xFFFFFFFFu, v, 8);
                    v += __shfl_xor_sync(0xFFFFFFFFu, v, 16);
                    acc[r][c] = v;
                }
            if (lane < 8) {
#pragma unroll
                for (int r = 0; r < 8; ++r)
#pragma unroll
                    for (int c = 0; c < 16; ++c)
                        red[(warp * 8 + r) * Q8_COLS + 16 * cl + c] = acc[r][c];
            }
            __syncthreads();
            for (int i = tid; i < 8 * Q8_COLS; i += Q8_THREADS) {
                const int r = i / Q8_COLS, c = i - r * Q8_COLS;
                if (r0 + r >= R) continue;
                float v = 0.f;
#pragma unroll
                for (int w = 0; w < 8; ++w) v += red[(w * 8 + r) * Q8_COLS + c];
                const float sc = scales[slab * Q8_COLS + c];
                tot[(r0 + r) * Q8_COLS + c] += v * sc;  // × the scale, added tile by tile
            }
            __syncthreads();
            seg = seg_end;
        }
    }

    if (ksplit == 1) {
        for (int i = tid; i < R * Q8_COLS; i += Q8_THREADS)
            out[(size_t)(i / Q8_COLS) * N + slab * Q8_COLS + i % Q8_COLS] = tot[i];
        return;
    }
    // the slab's K slices are one cluster: each block stores its totals into
    // the block that owns them (i ≡ owner mod ksplit); after one barrier each
    // owner adds its totals over the slices, in slice order
    cg::cluster_group cluster = cg::this_cluster();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    for (int i = tid; i < R * Q8_COLS; i += Q8_THREADS)
        *cluster.map_shared_rank(recv + split * per_owner + i / ksplit, i % ksplit) = tot[i];
    cluster.sync();
    for (int j = tid; j < per_owner; j += Q8_THREADS) {
        const int i = j * ksplit + split;
        if (i >= R * Q8_COLS) break;
        float v = 0.f;
        for (int q = 0; q < ksplit; ++q) v += recv[q * per_owner + j];
        out[(size_t)(i / Q8_COLS) * N + slab * Q8_COLS + i % Q8_COLS] = v;
    }
}

// -- db_gemv_kernel ----------------------------------------------------------------

constexpr int DB_THREADS = 256;
constexpr int DB_STAGE_ROWS = 8;   // weight rows a stage (one a warp)
constexpr int DB_STAGES = 2;       // stages a block: its 16 output rows
constexpr int DB_MAX_ROWS = 8;

__device__ __forceinline__ void db_issue(uint8_t* slot, const int8_t* w, int row0, int K, int tid) {
    const int chunks = DB_STAGE_ROWS * K / 16;
    for (int i = tid; i < chunks; i += DB_THREADS) {
        const int r = i / (K / 16), c = i - r * (K / 16);
        cp_async16(smem_addr(slot + (size_t)r * K + 16 * c), w + (size_t)(row0 + r) * K + 16 * c);
    }
}

// shared memory: the ring, 2 slots × 8 rows × K bytes
__global__ void __launch_bounds__(DB_THREADS)
db_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
               float* __restrict__ out, int R, int K, int N, float scale) {
    extern __shared__ __align__(16) uint8_t ring[];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int n0 = blockIdx.x * DB_STAGE_ROWS * DB_STAGES;
    const size_t slot_bytes = (size_t)DB_STAGE_ROWS * K;

    db_issue(ring, w, n0, K, tid);
    cp_async_commit();
    for (int st = 0; st < DB_STAGES; ++st) {
        if (st + 1 < DB_STAGES) {
            db_issue(ring + ((st + 1) & 1) * slot_bytes, w, n0 + (st + 1) * DB_STAGE_ROWS, K, tid);
            cp_async_commit();
            cp_async_wait<1>();  // stage st has landed (this thread's copies)
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // ... and every thread's
        const uint8_t* row = ring + (st & 1) * slot_bytes + (size_t)warp * K;
        float acc[DB_MAX_ROWS];
#pragma unroll
        for (int r = 0; r < DB_MAX_ROWS; ++r) acc[r] = 0.f;
        for (int k = 16 * lane; k < K; k += 512) {
            const uint4 wv = *reinterpret_cast<const uint4*>(row + k);
            const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
            float wf[16];
#pragma unroll
            for (int c = 0; c < 16; ++c)
                wf[c] = (float)(int8_t)((ww[c >> 2] >> (8 * (c & 3))) & 0xFFu);
#pragma unroll
            for (int r = 0; r < DB_MAX_ROWS; ++r) {
                if (r >= R) break;
                const uint4* xp = reinterpret_cast<const uint4*>(x + (size_t)r * K + k);
                const uint4 xa = __ldg(xp), xb = __ldg(xp + 1);
                const __nv_bfloat16* xh0 = reinterpret_cast<const __nv_bfloat16*>(&xa);
                const __nv_bfloat16* xh1 = reinterpret_cast<const __nv_bfloat16*>(&xb);
                float a = acc[r];
#pragma unroll
                for (int c = 0; c < 8; ++c) a = fmaf(__bfloat162float(xh0[c]), wf[c], a);
#pragma unroll
                for (int c = 0; c < 8; ++c) a = fmaf(__bfloat162float(xh1[c]), wf[8 + c], a);
                acc[r] = a;
            }
        }
#pragma unroll
        for (int r = 0; r < DB_MAX_ROWS; ++r) {
            float v = acc[r];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
            acc[r] = v;
        }
        if (lane == 0) {
            const int n = n0 + st * DB_STAGE_ROWS + warp;
#pragma unroll
            for (int r = 0; r < DB_MAX_ROWS; ++r)
                if (r < R) out[(size_t)r * N + n] = acc[r] * scale;
        }
        __syncthreads();  // the slot is read before it is refilled
    }
}

int q8_smem_done = 0, db_smem_done = 0;

}  // namespace

// xe, xo [rt, K2] int8 (fold 0) or bf16 (fold 1); xs [rt] f32; codes [K2, N]
// bytes; scales [K2 / gs2, N] f32; out [rt, N] f32. rt % 32 == 0, N % 4 ==
// 0, gs2 % 4 == 0, gs2 · gpt divides K2; raw 1 takes each byte whole (the
// "none" probe). Returns the CUDA error of the launch.
extern "C" int q4_probe_launch(const void* xe, const void* xo, const void* xs, const void* codes,
                               const void* scales, void* out, int rt, int K2, int N, int gs2,
                               int gpt, int fold, int raw, void* stream) {
    if (rt < QP_ROWS || rt % QP_ROWS || N < 4 || N % 4 || K2 < 4 || gs2 < 4 || gs2 % 4 ||
        gpt < 1 || K2 % (gs2 * gpt))
        return (int)cudaErrorInvalidValue;
    const dim3 grid((N + QP_COLS - 1) / QP_COLS, rt / QP_ROWS);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* c = static_cast<const uint8_t*>(codes);
    const auto* s = static_cast<const float*>(scales);
    const auto* x_s = static_cast<const float*>(xs);
    auto* o = static_cast<float*>(out);
#define QP_LAUNCH(FOLD_, RAW_)                                                                 \
    if (!!fold == FOLD_ && !!raw == RAW_)                                                      \
        q4_probe_kernel<FOLD_, RAW_><<<grid, 32 * QP_WARPS, 0, st>>>(xe, xo, x_s, c, s, o, K2, N, \
                                                                    gs2, gpt);
    QP_LAUNCH(false, false)
    QP_LAUNCH(false, true)
    QP_LAUNCH(true, false)
    QP_LAUNCH(true, true)
#undef QP_LAUNCH
    return (int)cudaGetLastError();
}

// x [R, K] bf16 (R ≤ 16); codes [K, N] int8; scales [N] f32; out [R, N]
// f32. N % 128 == 0; K is cut into ksplit ≤ 8 slices of slice_rows rows
// (the last may be shorter, none empty). Returns the CUDA error.
extern "C" int q8_gemv_launch(const void* x, const void* codes, const void* scales, void* out,
                              int R, int K, int N, int slice_rows, int ksplit, void* stream) {
    if (R < 1 || R > Q8_MAX_ROWS || K < 1 || N < Q8_COLS || N % Q8_COLS || ksplit < 1 ||
        ksplit > Q8_MAX_CLUSTER || slice_rows < 1 || (long long)ksplit * slice_rows < K ||
        (long long)(ksplit - 1) * slice_rows >= K)
        return (int)cudaErrorInvalidValue;
    const int per_owner = (R * Q8_COLS + ksplit - 1) / ksplit;
    const size_t smem = (size_t)slice_rows * Q8_MAX_ROWS * 2 +
                        sizeof(float) * (8 * 8 * Q8_COLS + Q8_MAX_ROWS * Q8_COLS +
                                         (size_t)ksplit * per_owner);
    const cudaError_t e = allow_smem(q8_gemv_kernel, smem, q8_smem_done);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(N / Q8_COLS, ksplit, 1);
    cfg.blockDim = dim3(Q8_THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = ksplit;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t l = cudaLaunchKernelEx(
        &cfg, q8_gemv_kernel, static_cast<const __nv_bfloat16*>(x),
        static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
        static_cast<float*>(out), R, K, N, slice_rows, ksplit);
    const cudaError_t last = cudaGetLastError();
    return (int)(l != cudaSuccess ? l : last);
}

// x [R, K] bf16 (R ≤ 8); w [N, K] int8; out [R, N] f32 = (x · wᵀ) · scale.
// K % 512 == 0, N % 16 == 0. Returns the CUDA error.
extern "C" int db_gemv_launch(const void* x, const void* w, void* out, int R, int K, int N,
                              float scale, void* stream) {
    if (R < 1 || R > DB_MAX_ROWS || K < 512 || K % 512 || N < 16 ||
        N % (DB_STAGE_ROWS * DB_STAGES))
        return (int)cudaErrorInvalidValue;
    const size_t smem = 2 * (size_t)DB_STAGE_ROWS * K;
    const cudaError_t e = allow_smem(db_gemv_kernel, smem, db_smem_done);
    if (e != cudaSuccess) return (int)e;
    db_gemv_kernel<<<N / (DB_STAGE_ROWS * DB_STAGES), DB_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
        static_cast<float*>(out), R, K, N, scale);
    return (int)cudaGetLastError();
}
