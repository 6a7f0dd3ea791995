// int4 and NF4 weight-only matmuls for decode-sized row counts, for Hopper
// (sm_90a): one tensor-core kernel, q4_mma_kernel, with a table per kind.
//
// Replaces the TPU kernels crs_tpu/ops/qgemm.py:q4_matmul / _q4_kernel
// (kernel 8) and nf4_matmul / _nf4_kernel (kernel 9). For x [R, K] (bf16),
// packed codes [K/2, N] and f32 group scales [K/group, N]:
//   w[2i, n]   = bf16(bf16(level(lo nibble of codes[i, n])) · bf16(scale))
//   w[2i+1, n] = the same with the hi nibble
//   out[r, n]  = Σ_k x[r, k] · w[k, n]                          (f32 sums)
// level() is the sign-extended nibble for int4 (lo = (p << 28) >> 28,
// hi = p >> 4, arithmetic) and NF4_LEVELS[unsigned nibble] for NF4. Every
// product of two bf16 values is exact in f32, so the result differs from the
// plain version (ops/qgemm.py emulate_*) only in the order of the f32 sums.
//
// What bounds it on an H100: at R ≤ 64 the packed weight is read once and
// each byte feeds 2·R multiply-adds, so it is bound by bytes: K/2·N code
// bytes plus K/group·N·4 scale bytes at 3.35 TB/s (1b's lm_head, 2048 →
// 32000: 32.8 MB codes + 2 MB scales ≈ 10 µs).
//
// Design: the R×K×N multiply-adds run on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 sums) with the weight as the A operand (16 columns
// × 16 k) and x as B (8 rows × 16 k), so R ≤ 8 pads to 8 rows, not 16. The
// packed layout is A's register layout: byte (i, n) holds k rows (2i, 2i+1)
// of column n, one bf16x2 register of an A fragment. A thread (gid = lane /
// 4, tig = lane % 4) loads W consecutive bytes of packed rows tig and
// tig + 4 of each 8-row step (W = 16, 8 or 4: a warp reads 8·W contiguous
// bytes per packed row); byte 2j and 2j + 1 become A's rows gid and gid + 8
// of m-tile j, so the warp's W/2 m-tiles cover its 8·W columns in a fixed
// permutation. Each byte is dequantised whole: one read of a 256-entry
// bf16x2 table (level_lo, level_hi) in shared memory — NF4's levels or
// int4's sign-extended nibbles, ops/qgemm.py byte_table — kept once per
// lane so the 32 lanes never share a bank, then one bf16x2 multiply by
// (bf16(scale), bf16(scale)), which rounds the exact product once as the
// plain version does. The CUDA cores do only that dequant, so the cost no
// longer grows with R; the weight is read once for every R ≤ 64 (R > 8
// takes ⌈R/8⌉ n-tiles, with W shrinking so the f32 sums stay in 64
// registers). A block of 8 warps owns 8·W columns; its K slice is split
// over the warps in contiguous runs of steps, their sums added in warp
// order through shared memory. A decode-sized product is a chain of
// latencies more than a stream of bytes, so nothing waits that need not:
// each warp streams its codes and x's fragments through its own ring of
// cp.async stages in shared memory, 2–3 steps ahead of the tensor cores,
// and the block's table (kept replicated per lane in device memory) and its
// slice's f32 scales arrive by cp.async too, so the prologue holds no load
// in a register; a group's scales become bf16 pairs in registers when a
// warp enters it. Groups of any number of packed rows gs2: when gs2 is a
// multiple of the 8-row step (group_size 16, 32, … — every preset), a step
// lies in one group and the scales are staged as above; otherwise (RAGGED:
// group_size 2, 8, 24, …) the step's rows tig and tig + 4 may lie in two
// groups, and each thread reads the scales of both of its rows, for each
// step, from device memory (L1 / L2) instead. K is split over ksplit ≤ 8
// slices of whole groups that are also whole steps (ops/qgemm.py
// q4_plan), launched as one thread-block cluster per column slab: each
// block stores its sums into the shared memory of the block that owns them
// (distributed shared memory), and after one cluster barrier each owner
// adds its sums over the slices in slice order. No partial reaches device
// memory, and every sum has a fixed order, so the result has the same bits
// on every run.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// -- q4_mma_kernel --------------------------------------------------------------

constexpr int MMA_WARPS = 8;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int TABLE_WORDS = 256 * 32;    // a bf16x2 entry per byte value, one copy per lane
constexpr int STEP_ROWS = 8;             // packed rows per k16 step
constexpr int MAX_ROWS = 64;
constexpr int MAX_CLUSTER = 8;           // K slices meet in one cluster (portable size)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// global → shared copies that bypass the registers; `bytes` 4, 8 or 16
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(BYTES)
                     : "memory");
}

// 16 bytes, or 16 zero bytes when !valid; through L1 when L1_SHARED (other
// warps of the block copy the same bytes)
template <bool L1_SHARED>
__device__ __forceinline__ void cp_async16_or_zero(uint32_t dst, const void* src, bool valid) {
    if constexpr (L1_SHARED)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                     "r"(valid ? 16 : 0)
                     : "memory");
    else
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                     "r"(valid ? 16 : 0)
                     : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// W bytes of shared memory as W/4 words
template <int W>
__device__ __forceinline__ void read_row(const uint8_t* p, uint32_t (&w)[W / 4]) {
    if constexpr (W == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else if constexpr (W == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        w[0] = v.x, w[1] = v.y;
    } else {
        w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
}

// byte b of the W bytes, dequantised: the lane's copy of its table entry
// (byte offset 128·byte + 4·lane: one shift and one LOP3), then × (s, s)
template <int W>
__device__ __forceinline__ uint32_t dequant(const uint8_t* tbl, uint32_t lane4,
                                            const uint32_t (&w)[W / 4], int b, uint32_t s2) {
    const uint32_t word = w[b >> 2];
    const int k = b & 3;
    const uint32_t off = ((k == 0 ? word << 7 : word >> (8 * k - 7)) & 0x7F80u) | lane4;
    const uint32_t t = *reinterpret_cast<const uint32_t*>(tbl + off);
    const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&t),
                                     *reinterpret_cast<const __nv_bfloat162*>(&s2));
    return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The per-warp ring of q4_mma_kernel: STAGES steps in flight, each holding
// the warp's codes (packed rows tig and tig + 4, W bytes a lane) and the
// step's 16 k of x's 8·NT rows (32 bytes a row, copied 16 at a time; a row
// stride of 48 bytes puts the 32 lanes' fragment reads on 32 banks).
template <int NT, int W>
struct Ring {
    static constexpr int CODE_BYTES = 2 * 32 * W;
    static constexpr int X_ROW = 48;
    static constexpr int X_BYTES = 8 * NT * X_ROW;
    static constexpr int STAGE_BYTES = CODE_BYTES + X_BYTES;
    static constexpr int STAGES = NT <= 2 ? 3 : 4;  // 3 beat 2, 4 and 6 at R = 8
    static constexpr int WARP_BYTES = STAGES * STAGE_BYTES;
    // bytes of shared memory before the scales: the table and the rings,
    // or the warps' sums that reuse them, whichever is larger
    static constexpr int FRONT_BYTES = 4 * TABLE_WORDS + MMA_WARPS * WARP_BYTES;
    static constexpr int RED_BYTES = 4 * MMA_WARPS * 8 * NT * 8 * W;
    static constexpr int BASE_BYTES = FRONT_BYTES > RED_BYTES ? FRONT_BYTES : RED_BYTES;
};

// NT n-tiles of 8 rows of x; W bytes per packed row per thread, so 8·W
// columns per warp. The block's 8 warps lie WN along N and 8 / WN along K.
// WN = 8 serves R > 32 at wide N: every warp needs the step's 64 rows of
// x, warps on the same k share them through L1, and the block's table
// serves 8 times the columns. Launched in clusters of the ksplit blocks of
// a slab.
//
// Shared memory: [table: 256 × 32 words][rings: 8 × WARP_BYTES] — after the
// main loop the warps' sums [8 / WN][RP][BC] reuse that front — then,
// past the larger of the two, [scales: n_groups × BC f32, none when RAGGED]
// [recv: ksplit × ⌈R·BC/ksplit⌉ f32]. `recv` is written by the cluster's
// other blocks, so nothing else uses it.
template <int NT, int W, int WN, bool RAGGED>
__global__ void __launch_bounds__(MMA_THREADS, 2)
q4_mma_kernel(const __nv_bfloat16* __restrict__ x,  // [R, 2·K2]
              const uint8_t* __restrict__ codes,    // [K2, N]
              const float* __restrict__ scales,     // [K2/gs2, N]
              const uint32_t* __restrict__ table,   // [256 × 32] bf16x2, an entry per lane
              float* __restrict__ out,              // [R, N]
              int R, int K2, int N, int gs2, int slice_rows) {
    constexpr int CW = 8 * W;      // columns per warp
    constexpr int BC = WN * CW;    // columns per block
    constexpr int WK = MMA_WARPS / WN;  // warps along K
    constexpr int MT = W / 2;      // m16 tiles per warp
    constexpr int WORDS = W / 4;
    constexpr int RP = 8 * NT;     // rows of x the n-tiles cover
    using RG = Ring<NT, W>;
    constexpr int S = RG::STAGES;
    extern __shared__ __align__(16) uint32_t smem[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int slab = blockIdx.x, split = blockIdx.y, ksplit = gridDim.y;
    const int wk = warp / WN;
    const int col0 = (warp % WN) * CW + gid * W;  // this thread's first column in the slab
    const int K = 2 * K2;
    const int p_begin = split * slice_rows;
    const int p_end = min(K2, p_begin + slice_rows);
    const int steps = (p_end - p_begin) / STEP_ROWS;
    const int per_warp = (steps + WK - 1) / WK;
    const int st_begin = min(steps, wk * per_warp);
    const int st_end = min(steps, st_begin + per_warp);
    const int n_groups = (p_end - p_begin + gs2 - 1) / gs2;
    const int slice_groups = (slice_rows + gs2 - 1) / gs2;
    const int per_owner = (R * BC + ksplit - 1) / ksplit;
    uint8_t* ring = reinterpret_cast<uint8_t*>(smem + TABLE_WORDS) + warp * RG::WARP_BYTES;
    float* sraw = reinterpret_cast<float*>(smem + RG::BASE_BYTES / 4);
    float* recv = sraw + (RAGGED ? 0 : slice_groups * BC);  // [ksplit][per_owner]
    const uint8_t* cbase = codes + (size_t)slab * BC + col0;

    // step st of this warp → ring stage `stage`
    auto issue = [&](int st, int stage) {
        uint8_t* d = ring + stage * RG::STAGE_BYTES;
        const int p0 = p_begin + STEP_ROWS * st;
        const uint8_t* src = cbase + (size_t)(p0 + tig) * N;
        cp_async<W>(smem_addr(d + lane * W), src);
        cp_async<W>(smem_addr(d + (32 + lane) * W), src + (size_t)4 * N);
        uint8_t* dx = d + RG::CODE_BYTES;
        for (int i = lane; i < 16 * NT; i += 32) {  // row i / 2, k half i % 2
            const int r = i >> 1, h = i & 1;
            const __nv_bfloat16* xr = x + (size_t)(r < R ? r : 0) * K + 2 * p0 + 8 * h;
            cp_async16_or_zero<(WN > 1)>(smem_addr(dx + r * RG::X_ROW + 16 * h), xr, r < R);
        }
    };
    // one group of copies: the table and the slice's scales (the whole
    // block's), then one group per step of this warp's first S - 1
    for (int i = tid; i < TABLE_WORDS / 4; i += MMA_THREADS)
        cp_async<16>(smem_addr(smem + 4 * i), table + 4 * i);
    for (int i = tid; i < (RAGGED ? 0 : n_groups * BC / 4); i += MMA_THREADS) {
        const int g = 4 * i / BC, c = 4 * i - g * BC;
        cp_async<16>(smem_addr(sraw + 4 * i), scales + (size_t)(p_begin / gs2 + g) * N + slab * BC + c);
    }
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
        if (st_begin + i < st_end) issue(st_begin + i, i);
        cp_async_commit();
    }
    cp_async_wait<S - 1>();
    __syncthreads();  // every thread's copies of the table and scales
    const uint8_t* tbl = reinterpret_cast<const uint8_t*>(smem);
    const uint32_t lane4 = 4u * lane;

    float acc[MT][NT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][t][e] = 0.f;
    // (bf16(scale), bf16(scale)) of the thread's columns: for packed row
    // tig of the step (s2) and, when RAGGED, for row tig + 4 (s2b)
    uint32_t s2[W], s2b[W];
    int group_end = 0;   // packed rows into the slice where s2's group ends
    int stage = 0;
    for (int st = st_begin; st < st_end; ++st) {
        if (st + S - 1 < st_end) issue(st + S - 1, stage == 0 ? S - 1 : stage - 1);
        cp_async_commit();
        cp_async_wait<S - 1>();  // this thread's copies of step st have landed
        const uint8_t* d = ring + stage * RG::STAGE_BYTES;
        stage = stage == S - 1 ? 0 : stage + 1;
        const int off = STEP_ROWS * st;
        if constexpr (RAGGED) {  // rows tig and tig + 4 of the step: each its own group
            const float* scol = scales + (size_t)slab * BC + col0;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float* sg = scol + (size_t)((p_begin + off + tig + 4 * h) / gs2) * N;
#pragma unroll
                for (int q = 0; q < W / 4; ++q) {
                    const float4 v = __ldg(reinterpret_cast<const float4*>(sg + 4 * q));
                    const float sv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const __nv_bfloat162 hv = __floats2bfloat162_rn(sv[e], sv[e]);
                        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(&hv);
                        if (h) s2b[4 * q + e] = w2;
                        else s2[4 * q + e] = w2;
                    }
                }
            }
        } else if (off >= group_end) {  // the step lies in one group (gs2 % 8 == 0)
            const int g = off / gs2;
            group_end = (g + 1) * gs2;
            const float* sg = sraw + g * BC + col0;
#pragma unroll
            for (int q = 0; q < W / 4; ++q) {
                const float4 v = *reinterpret_cast<const float4*>(sg + 4 * q);
                const float sv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const __nv_bfloat162 h = __floats2bfloat162_rn(sv[e], sv[e]);
                    s2[4 * q + e] = *reinterpret_cast<const uint32_t*>(&h);
                }
            }
        }
        uint32_t c0[WORDS], c1[WORDS], b[NT][2];
        read_row<W>(d + lane * W, c0);
        read_row<W>(d + (32 + lane) * W, c1);
        const uint8_t* dx = d + RG::CODE_BYTES + gid * RG::X_ROW + 4 * tig;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            b[t][0] = *reinterpret_cast<const uint32_t*>(dx + 8 * t * RG::X_ROW);       // k 2·tig
            b[t][1] = *reinterpret_cast<const uint32_t*>(dx + 8 * t * RG::X_ROW + 16);  // k + 8
        }
#pragma unroll
        for (int j = 0; j < MT; ++j) {
            const uint32_t a0 = dequant<W>(tbl, lane4, c0, 2 * j, s2[2 * j]);
            const uint32_t a1 = dequant<W>(tbl, lane4, c0, 2 * j + 1, s2[2 * j + 1]);
            const uint32_t a2 = dequant<W>(tbl, lane4, c1, 2 * j, RAGGED ? s2b[2 * j] : s2[2 * j]);
            const uint32_t a3 =
                dequant<W>(tbl, lane4, c1, 2 * j + 1, RAGGED ? s2b[2 * j + 1] : s2[2 * j + 1]);
#pragma unroll
            for (int t = 0; t < NT; ++t) mma_bf16(acc[j][t], a0, a1, a2, a3, b[t][0], b[t][1]);
        }
    }
    cp_async_wait<0>();

    // the K warps' sums, added in warp order (the front of shared memory is free now)
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);  // [WK][RP][BC]
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            const int c = col0 + 2 * j, r = 8 * t + 2 * tig;
            float* w0 = red + (size_t)(wk * RP + r) * BC + c;
            w0[0] = acc[j][t][0];   // (column gid → c, row r)
            w0[BC] = acc[j][t][1];  // (c, r + 1)
            w0[1] = acc[j][t][2];   // (column gid + 8 → c + 1, r)
            w0[BC + 1] = acc[j][t][3];
        }
    __syncthreads();
    cg::cluster_group cluster = cg::this_cluster();
    for (int i = tid; i < R * BC; i += MMA_THREADS) {
        const int r = i / BC, c = i - r * BC;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WK; ++w) s += red[(w * RP + r) * BC + c];
        if (ksplit == 1) out[(size_t)r * N + slab * BC + c] = s;
        else  // to the block that owns sum i, into this slice's row of its recv
            *cluster.map_shared_rank(recv + split * per_owner + i / ksplit, i % ksplit) = s;
    }
    if (ksplit == 1) return;

    // the slab's K slices are one cluster: after one barrier each block adds
    // the sums it owns (i ≡ split mod ksplit) over the slices, in slice order
    cluster.sync();
    for (int j = tid; j < per_owner; j += MMA_THREADS) {
        const int i = j * ksplit + split;
        if (i >= R * BC) break;
        float s = 0.f;
        for (int q = 0; q < ksplit; ++q) s += recv[q * per_owner + j];
        const int r = i / BC, c = i - r * BC;
        out[(size_t)r * N + slab * BC + c] = s;
    }
}

template <int NT, int W, int WN, bool RAGGED>
int launch_q4(int ksplit, cudaStream_t stream, const __nv_bfloat16* x, const uint8_t* codes,
              const float* scales, const uint32_t* table, float* out, int R, int K2, int N,
              int gs2, int slice_rows) {
    constexpr int BC = 8 * W * WN;
    if (N % BC) return (int)cudaErrorInvalidValue;
    const size_t groups = RAGGED ? 0 : (slice_rows + gs2 - 1) / gs2;
    const size_t per_owner = ((size_t)R * BC + ksplit - 1) / ksplit;
    const size_t smem = Ring<NT, W>::BASE_BYTES
                        + sizeof(float) * (groups * BC + (ksplit > 1 ? ksplit * per_owner : 0));
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(q4_mma_kernel<NT, W, WN, RAGGED>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   (int)smem);
        if (e != cudaSuccess) {
            cudaGetLastError();
            return (int)e;
        }
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(N / BC, ksplit, 1);
    cfg.blockDim = dim3(MMA_THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = ksplit;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t l = cudaLaunchKernelEx(&cfg, q4_mma_kernel<NT, W, WN, RAGGED>, x, codes,
                                             scales, table, out, R, K2, N, gs2, slice_rows);
    const cudaError_t last = cudaGetLastError();  // clears the runtime's error
    return (int)(l != cudaSuccess ? l : last);
}

}  // namespace

// x [R, 2·K2] bf16 (R ≤ 64); codes [K2, N] bytes (int4 or NF4 nibble
// pairs); scales [K2/gs2, N] f32 (any gs2 ≥ 1 dividing K2); table [256 × 32]
// bf16x2 words, each entry of ops/qgemm.py byte_table once per lane; out
// [R, N] f32. K2 % 8 == 0. K is cut into ksplit ≤ 8 slices of slice_rows
// packed rows (a multiple of gs2 and of 8; the last may be shorter, none
// empty), width (16, 8 or 4) is the bytes of a packed row each thread reads
// and warps_n (1, or 8 for R > 32) the warps of a block along N:
// ops/qgemm.py q4_plan. Returns the CUDA error of the launch.
extern "C" int q4_mma_launch(const void* x, const void* codes, const void* scales,
                             const void* table, void* out, int R, int K2, int N, int gs2,
                             int ksplit, int slice_rows, int width, int warps_n, void* stream) {
    if (R < 1 || R > MAX_ROWS || K2 < STEP_ROWS || K2 % STEP_ROWS || gs2 < 1 || K2 % gs2 ||
        N < 1 || ksplit < 1 || ksplit > MAX_CLUSTER || slice_rows < gs2 || slice_rows % gs2 ||
        slice_rows % STEP_ROWS || (long long)ksplit * slice_rows < K2 ||
        (long long)(ksplit - 1) * slice_rows >= K2)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* cb = static_cast<const uint8_t*>(codes);
    const auto* sb = static_cast<const float*>(scales);
    const auto* tb = static_cast<const uint32_t*>(table);
    auto* o = static_cast<float*>(out);
    const int nt = R <= 8 ? 1 : R <= 16 ? 2 : R <= 32 ? 4 : 8;
    const bool ragged = gs2 % STEP_ROWS != 0;
#define Q4_LAUNCH(NT_, W_, WN_)                                                              \
    if (nt == NT_ && width == W_ && warps_n == WN_)                                          \
        return ragged ? launch_q4<NT_, W_, WN_, true>(ksplit, st, xb, cb, sb, tb, o, R, K2, N,  \
                                                      gs2, slice_rows)                        \
                      : launch_q4<NT_, W_, WN_, false>(ksplit, st, xb, cb, sb, tb, o, R, K2, N, \
                                                       gs2, slice_rows);
    Q4_LAUNCH(1, 16, 1)
    Q4_LAUNCH(1, 8, 1)
    Q4_LAUNCH(2, 16, 1)
    Q4_LAUNCH(2, 8, 1)
    Q4_LAUNCH(4, 8, 1)
    Q4_LAUNCH(8, 4, 1)
    Q4_LAUNCH(8, 4, 8)
#undef Q4_LAUNCH
    return (int)cudaErrorInvalidValue;
}
