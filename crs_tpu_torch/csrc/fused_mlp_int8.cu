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
// Design: one launch, as the TPU kernel is one invocation. The TPU kernel
// walks the chunks of I in order with the chunk's [8, ck] intermediates in
// VMEM; here each chunk is one thread-block cluster of 8 CTAs (one CTA an
// SM), and the chunks' clusters run side by side:
//   1. prologue — CTA r of the cluster reads x's row r and g through the
//      read-only cache, normalises and quantizes the row and writes xq[r]
//      and xs[r] into the shared memory of all 8 CTAs (distributed shared
//      memory); the weights' first loads go out before it.
//   2. gate/up — CTA k owns chunk/8 rows i of the chunk, warp w 16 of them:
//      the rows of gate_t and up_t are the M operand of int8 tensor-core
//      products (mma.sync m16n8k32 s8, the ≤ 8 rows of xq the N = 8 operand),
//      streamed from device memory straight into the A fragments with 16-byte
//      loads, two groups of 4 × 64-byte k-blocks in flight per thread (the
//      k order inside a 64-byte block is permuted alike in A and in B, which
//      leaves the dot unchanged). silu·up stays in the CTA's shared memory.
//   3. requant — each CTA's max|hmid| per row goes to every CTA of the
//      cluster; after a cluster barrier each CTA forms the chunk's hs and
//      writes its rows' hq codes into the shared memory of all 8 CTAs, so
//      hmid and hq never leave the cluster. A cluster per chunk, not a grid
//      barrier: the requant needs only its own chunk, so the chunks never
//      wait for one another and nothing needs the whole grid resident.
//   4. down — the cluster's 64 warps split the chunk's [chunk, H] slab of
//      down into 128-column groups (and, when there are fewer groups than
//      warps, into row parts summed in int32 inside the CTA). down is
//      j-contiguous, so a thread loads 16 columns of 4 rows at a time and
//      transposes 4 × 4 bytes with __byte_perm into A fragments with K = i
//      (no second [H, I] copy of the weights); the B operand is hq from
//      shared memory. The first loads of down go out before the requant's
//      barriers. Each column group's f32(acc)·hs (the chunk's term of y) goes
//      to a [chunks, R, H] buffer.
//   5. the ordered sum — the last CTA of each rank to finish (a self-resetting
//      counter) adds the chunks' terms of its columns in chunk order and
//      writes out = x + y·s_down. So y is the same on every run and the
//      chunks never wait: no grid barrier, no float atomics.
// The result has the same bits on every run. Past the streaming of the
// weights, the time goes to the prologue (two block reductions and a
// cluster barrier while only the first weight loads are in flight), the
// requant's wait for the cluster's slowest CTA and the ordered sum (PERF.md).
//
// Shared memory grows with H only through xq, 8·(H + 64) bytes. Where it
// does not fit (H past 27,136 at chunk 1024), the kernel's XG instance keeps
// the cluster's xq rows in device memory instead, in the first R·H bytes of
// the chunk's slab of `part`, and gate/up reads its B operand from L2; the
// slab's down terms are written only after the requant's cluster barrier,
// when no CTA of the cluster reads xq any more. So every H % 128 launches.
//
// Any chunk of I: CTA k owns rows_cta = ⌈chunk/8⌉ rounded up to 16 rows i
// of the chunk (fewer, or none, at the chunk's end), so a chunk that is
// not a multiple of 128 has CTAs whose last 16-row tile runs past it: those
// rows load as zeros, form no hmid, add nothing to the chunk's max and are
// never stored. hq is kept to a multiple of 32 codes a row (down's k-step),
// its columns past the chunk zero; down's rows past the chunk load as zeros.
// Where hq and hmid outgrow shared memory (a chunk past 16,384 rows at H ≤
// 4,096, past 19,072 wider), the HG instance keeps them in device memory,
// in the chunk's slab of a region of `part` after the terms ([chunks] of
// 5·R·⌈chunk/128⌉·128 bytes: hq [R][⌈chunk/128⌉·128] int8, then hmid
// [R][8·rows_cta] f32), and down reads hq from L2. The down sums keep their
// order: each chunk's term f32(acc)·hs_c, added in chunk order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_R = 8;
constexpr int CLUSTER = 8;                         // CTAs a chunk, one cluster
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NPAD = 8;                            // the N = 8 rows of the products (R padded)
constexpr int KU = 4;                              // gate/up: 64-byte k-blocks a load group
constexpr int KS = 2;                              // down: 32-row k-steps a load group
constexpr int XQ_PAD = 64;                         // xq rows' padding: conflict-free B loads
constexpr int HQ_PAD = 16;                         // hq rows' padding: conflict-free B loads
constexpr int COLS = 128;                          // columns of down a warp owns
constexpr int SUMS = 4;                            // ordered sums a thread runs side by side
constexpr int SMEM_LIMIT = 232448;
// more than half an SM's shared memory: one CTA an SM, so the cluster's
// CTAs (and their loads in flight) spread over 8 SMs
constexpr int SMEM_ONE_CTA = 116 * 1024;
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
        v = lane < WARPS ? red[lane] : 0.0f;  // 0: neutral for Σ and max|·|
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

__device__ __forceinline__ int quantize(float v, float scale) {
    return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.0f), 127.0f));
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// d += A·B: A 16×32 s8 (a0: row g, k 4t..; a1: row g+8; a2: row g, k 16+4t..;
// a3: row g+8), B 32×8 s8 (b0: k 4t.., column g; b1: k 16+4t..), d 16×8 s32
// (d0, d1: row g, columns 2t, 2t+1; d2, d3: row g+8)
__device__ __forceinline__ void mma_s8(int (&d)[4], int a0, int a1, int a2, int a3, int b0,
                                       int b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int word(const int4& v, int q) {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// 4 rows × 4 bytes (word q of each row's int4) → one word of the 4 rows per column
__device__ __forceinline__ void transpose4(const int4* rows, int q, int (&out)[4]) {
    const unsigned w0 = word(rows[0], q), w1 = word(rows[1], q);
    const unsigned w2 = word(rows[2], q), w3 = word(rows[3], q);
    const unsigned lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
    const unsigned lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
    out[0] = static_cast<int>(__byte_perm(lo01, lo23, 0x5410));
    out[1] = static_cast<int>(__byte_perm(lo01, lo23, 0x7632));
    out[2] = static_cast<int>(__byte_perm(hi01, hi23, 0x5410));
    out[3] = static_cast<int>(__byte_perm(hi01, hi23, 0x7632));
}

// gate/up: the 16-byte pieces of k-blocks kb0 .. kb0+KU-1 a thread feeds its
// A fragments from: gate rows g and g+8, up rows g and g+8 of the warp's tile
// (rows of the tile at or past `live` — past the chunk — load as zeros)
__device__ __forceinline__ void gu_load(int4 (&v)[KU][4], const int8_t* gate_tile,
                                        const int8_t* up_tile, int H, int kb0, int nkb, int g,
                                        int t, int live) {
    const int4 zero = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < KU; ++u) {
        const int kb = kb0 + u;
        if (kb < nkb) {
            const size_t o = (size_t)g * H + kb * 64 + 16 * t, o8 = o + (size_t)8 * H;
            v[u][0] = g < live ? __ldcs(reinterpret_cast<const int4*>(gate_tile + o)) : zero;
            v[u][1] = g + 8 < live ? __ldcs(reinterpret_cast<const int4*>(gate_tile + o8)) : zero;
            v[u][2] = g < live ? __ldcs(reinterpret_cast<const int4*>(up_tile + o)) : zero;
            v[u][3] = g + 8 < live ? __ldcs(reinterpret_cast<const int4*>(up_tile + o8)) : zero;
        }
    }
}

// the k-blocks' products: within a 64-byte block, thread t's bytes 16t..16t+7
// are the (k 4t.., k 16+4t..) of the first product and 16t+8..16t+15 of the
// second, in A (the weights) and in B (xq row g) alike
// (XG: xq's R rows in device memory, the padding rows' zeros formed here)
template <bool XG>
__device__ __forceinline__ void gu_mma(const int4 (&v)[KU][4], const int8_t* xq, int xstride,
                                       int R, int kb0, int nkb, int g, int t, int (&ag)[2][4],
                                       int (&au)[2][4]) {
#pragma unroll
    for (int u = 0; u < KU; ++u) {
        const int kb = kb0 + u;
        if (kb < nkb) {
            const int4* src = reinterpret_cast<const int4*>(xq + (size_t)g * xstride + kb * 64 + 16 * t);
            const int4 x = !XG ? *src : g < R ? __ldcg(src) : make_int4(0, 0, 0, 0);
            mma_s8(ag[0], v[u][0].x, v[u][1].x, v[u][0].y, v[u][1].y, x.x, x.y);
            mma_s8(ag[1], v[u][0].z, v[u][1].z, v[u][0].w, v[u][1].w, x.z, x.w);
            mma_s8(au[0], v[u][2].x, v[u][3].x, v[u][2].y, v[u][3].y, x.x, x.y);
            mma_s8(au[1], v[u][2].z, v[u][3].z, v[u][2].w, v[u][3].w, x.z, x.w);
        }
    }
}

// down: piece e of a thread's k-step holds columns 16g..16g+15 of row
// 4t + e (e < 4) or 16 + 4t + e − 4 of the step's 32 rows
__device__ __forceinline__ int dn_row(int ks, int e, int t) {
    return 32 * ks + (e < 4 ? 4 * t + e : 16 + 4 * t + e - 4);
}

// k-steps ks0 .. ks0+KS-1 from device memory into registers (rows at or
// past `live` — past the chunk — as zeros)
__device__ __forceinline__ void dn_load(int4 (&v)[KS][8], const int8_t* slab, int H, int ks0,
                                        int nks, int t, int live) {
#pragma unroll
    for (int s = 0; s < KS; ++s) {
        const int ks = ks0 + s;
        if (ks < nks) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const int row = dn_row(ks, e, t);
                v[s][e] = row < live
                              ? __ldcs(reinterpret_cast<const int4*>(slab + (size_t)row * H))
                              : make_int4(0, 0, 0, 0);
            }
        }
    }
}

// product u = (q, h) covers columns 16g + 4q + 2h (as row g of A) and
// 16g + 4q + 2h + 1 (row g + 8); K = the step's 32 rows, B = hq (HG: from
// device memory, null for a padding row)
template <bool HG>
__device__ __forceinline__ void dn_mma(const int4 (&v)[KS][8], const int8_t* hq_row, int ks0,
                                       int nks, int t, int (&acc)[8][4]) {
#pragma unroll
    for (int s = 0; s < KS; ++s) {
        const int ks = ks0 + s;
        if (ks < nks) {
            const int* b = reinterpret_cast<const int*>(hq_row + 32 * ks + 4 * t);
            const int b0 = !HG ? b[0] : hq_row ? __ldcg(b) : 0;
            const int b1 = !HG ? b[4] : hq_row ? __ldcg(b + 4) : 0;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                int ta[4], tb[4];
                transpose4(&v[s][0], q, ta);
                transpose4(&v[s][4], q, tb);
                mma_s8(acc[2 * q], ta[0], ta[1], tb[0], tb[1], b0, b1);
                mma_s8(acc[2 * q + 1], ta[2], ta[3], tb[2], tb[3], b0, b1);
            }
        }
    }
}

// rows i of the chunk a CTA owns (whole 16-row tiles; the last CTAs' run
// past the chunk, or hold none of it)
__host__ __device__ inline int cta_rows(int chunk) {
    return ((chunk + CLUSTER - 1) / CLUSTER + 15) / 16 * 16;
}

// hq's codes a row: the chunk rounded up to down's 32-row k-steps
__host__ __device__ inline int hq_cols(int chunk) { return (chunk + 31) / 32 * 32; }

// the HG slab of a chunk, bytes: hq [R][CLUSTER·rows_cta] int8, hmid [R][CLUSTER·rows_cta] f32
__host__ __device__ inline size_t hg_slab(int R, int chunk) {
    return (size_t)5 * R * CLUSTER * cta_rows(chunk);
}

__host__ __device__ inline int down_parts(int H, int chunk) {
    // row parts of a chunk per 128-column group: enough units for the
    // cluster's 64 warps, each part whole 32-row k-steps
    const int kc = hq_cols(chunk);
    int p = 1;
    while (p < CLUSTER && (H / COLS) * p * 2 <= CLUSTER * WARPS && (kc / (2 * p)) % 32 == 0)
        p *= 2;
    return p;
}

// xq (not XG), hq and hmid (not HG) and, where a column group has row
// parts, their int32 sums (ops/fused_mlp.py:_hq_in_slab mirrors the choice)
__host__ __device__ inline size_t smem_bytes(int H, int chunk, bool xg, bool hg) {
    return (xg ? 0 : (size_t)NPAD * (H + XQ_PAD))
           + (hg ? 0 : (size_t)NPAD * (hq_cols(chunk) + HQ_PAD)
                           + sizeof(float) * NPAD * cta_rows(chunk))
           + (down_parts(H, chunk) > 1 ? sizeof(int) * WARPS * 32 * 32 : 0);
}

template <bool XG, bool HG>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
fused_mlp_int8_kernel(const float* __restrict__ x, const float* __restrict__ gn,
                      const int8_t* __restrict__ gate_t, const float* __restrict__ s_gate,
                      const int8_t* __restrict__ up_t, const float* __restrict__ s_up,
                      const int8_t* __restrict__ down, const float* __restrict__ s_down,
                      float* __restrict__ part, int* __restrict__ counters,
                      float* __restrict__ out, int8_t* __restrict__ xq_out,
                      float* __restrict__ xs_out, int8_t* __restrict__ hq_out,
                      float* __restrict__ hs_out, int R, int H, int I, int chunk, float inv_h,
                      float eps) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float red[32], xs_s[NPAD], cmax_s[CLUSTER][NPAD], hs_s[NPAD], wmax_s[WARPS][NPAD];
    __shared__ int last_cta;
    cg::cluster_group cluster = cg::this_cluster();
    const int c = blockIdx.y, nchunks = gridDim.y;
    const int kc = hq_cols(chunk);                                   // hq's codes a row
    const int rows_cta = cta_rows(chunk);                            // rows i of a CTA
    const int xstride = XG ? H : H + XQ_PAD;
    const int hstride = HG ? CLUSTER * rows_cta : kc + HQ_PAD;
    // [NPAD][H + XQ_PAD] in shared memory, or (XG) [R][H] in the chunk's slab of part
    int8_t* xq_s = XG ? reinterpret_cast<int8_t*>(part + (size_t)c * R * H)
                      : reinterpret_cast<int8_t*>(smem);
    // hq [NPAD][kc + HQ_PAD] and hmid [NPAD][rows_cta] in shared memory, or
    // (HG) hq [R][hstride] and hmid [R][hstride] (this CTA's rows at
    // k·rows_cta) in the chunk's slab past the terms
    int8_t* hg_slab_p = reinterpret_cast<int8_t*>(part + (size_t)nchunks * R * H)
                        + (size_t)c * hg_slab(R, chunk);
    int8_t* hq_s = HG ? hg_slab_p
                      : reinterpret_cast<int8_t*>(smem) + (XG ? 0 : (size_t)NPAD * xstride);
    float* hmid_s = HG ? reinterpret_cast<float*>(hg_slab_p + (size_t)R * hstride)
                       : reinterpret_cast<float*>(hq_s + (size_t)NPAD * hstride);
    const int hm_stride = HG ? hstride : rows_cta;
    if (HG) hmid_s += (size_t)blockIdx.x * rows_cta;
    int* dn_red = reinterpret_cast<int*>(
        reinterpret_cast<unsigned char*>(smem) + (XG ? 0 : (size_t)NPAD * xstride)
        + (HG ? 0 : (size_t)NPAD * hstride + sizeof(float) * NPAD * rows_cta));  // [WARPS][32][32]

    const int k = (int)cluster.block_rank();  // == blockIdx.x
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int nkb = H / 64;
    const int live_cta = max(0, min(rows_cta, chunk - k * rows_cta));  // its rows of the chunk
    const int ntile = (live_cta + 15) / 16;
    const size_t i_cta = (size_t)c * chunk + (size_t)k * rows_cta;
    const int P = down_parts(H, chunk);
    const int units = (H / COLS) * P, rows_part = kc / P, nks = rows_part / 32;
    auto unit_slab = [&](int u) {  // columns 16g.. of unit u's rows in down
        return down + ((size_t)c * chunk + (u % P) * rows_part) * H + (u / P) * COLS + 16 * g;
    };
    auto unit_live = [&](int u) { return chunk - (u % P) * rows_part; };  // its rows in the chunk

    // the padding rows of the products' B operands are zero
    if (!XG)
        for (int i = tid; i < (NPAD - R) * xstride / 16; i += THREADS)
            reinterpret_cast<int4*>(xq_s + (size_t)R * xstride)[i] = make_int4(0, 0, 0, 0);
    if (!HG)
        for (int i = tid; i < (NPAD - R) * hstride / 16; i += THREADS)
            reinterpret_cast<int4*>(hq_s + (size_t)R * hstride)[i] = make_int4(0, 0, 0, 0);
    cluster_arrive();  // this CTA runs: the others may write its shared memory

    const int u_first = k * WARPS + warp;  // this warp's first unit of the down product

    // the weights do not depend on x: the first gate/up group goes out now
    int4 ga[KU][4], gb[KU][4];
    if (warp < ntile)
        gu_load(ga, gate_t + (i_cta + 16 * warp) * H, up_t + (i_cta + 16 * warp) * H, H, 0, nkb,
                g, t, live_cta - 16 * warp);

    // 1. prologue: CTA r forms row r's xq and xs for the whole cluster
    if (k < R) {
        const float4* xr = reinterpret_cast<const float4*>(x + (size_t)k * H);
        const float4* gr = reinterpret_cast<const float4*>(gn);
        float s = 0.0f;
        for (int j = 16 * tid; j < H; j += 16 * THREADS)
#pragma unroll
            for (int e = 0; e < 16; e += 4) {
                const float4 v = __ldg(xr + (j + e) / 4);
                s = __fadd_rn(s, __fmul_rn(v.x, v.x));
                s = __fadd_rn(s, __fmul_rn(v.y, v.y));
                s = __fadd_rn(s, __fmul_rn(v.z, v.z));
                s = __fadd_rn(s, __fmul_rn(v.w, v.w));
            }
        s = block_reduce(s, red, false);
        const float rs = rsqrtf(__fadd_rn(__fmul_rn(s, inv_h), eps));
        auto xn = [&](const float4& v, const float4& w) {  // x·rs·g, element by element
            return make_float4(__fmul_rn(__fmul_rn(v.x, rs), w.x), __fmul_rn(__fmul_rn(v.y, rs), w.y),
                               __fmul_rn(__fmul_rn(v.z, rs), w.z), __fmul_rn(__fmul_rn(v.w, rs), w.w));
        };
        float m = 0.0f;
        for (int j = 16 * tid; j < H; j += 16 * THREADS)
#pragma unroll
            for (int e = 0; e < 16; e += 4) {
                const float4 v = xn(__ldg(xr + (j + e) / 4), __ldg(gr + (j + e) / 4));
                m = fmaxf(fmaxf(fmaxf(fmaxf(m, fabsf(v.x)), fabsf(v.y)), fabsf(v.z)), fabsf(v.w));
            }
        m = block_reduce(m, red, true);
        const float scale = __fmul_rn(fmaxf(m, 1e-12f), INV_127);
        cluster_wait();
        for (int j = 16 * tid; j < H; j += 16 * THREADS) {
            unsigned w[4];
#pragma unroll
            for (int e4 = 0; e4 < 4; ++e4) {
                const float4 v = xn(__ldg(xr + j / 4 + e4), __ldg(gr + j / 4 + e4));
                w[e4] = (unsigned)(quantize(v.x, scale) & 0xff)
                        | (unsigned)(quantize(v.y, scale) & 0xff) << 8
                        | (unsigned)(quantize(v.z, scale) & 0xff) << 16
                        | (unsigned)(quantize(v.w, scale) & 0xff) << 24;
            }
            const int4 v = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
            if (XG)
                *reinterpret_cast<int4*>(xq_s + (size_t)k * xstride + j) = v;
            else
                for (int r2 = 0; r2 < CLUSTER; ++r2)
                    *reinterpret_cast<int4*>(cluster.map_shared_rank(xq_s + (size_t)k * xstride + j, r2)) = v;
            if (c == 0 && xq_out) *reinterpret_cast<int4*>(xq_out + (size_t)k * H + j) = v;
        }
        if (tid < CLUSTER) *cluster.map_shared_rank(xs_s + k, tid) = scale;
        if (c == 0 && tid == 0 && xs_out) xs_out[k] = scale;
    } else {
        cluster_wait();
    }
    cluster.sync();  // xq, xs of every row in every CTA (XG: xq in the slab)

    // 2. gate/up: warp w's tiles of 16 rows i, hmid into shared memory
    float mx[2] = {0.0f, 0.0f};  // max|hmid| of rows n = 2t, 2t + 1
    for (int tile = warp; tile < ntile; tile += WARPS) {
        const int8_t* gt = gate_t + (i_cta + 16 * tile) * H;
        const int8_t* ut = up_t + (i_cta + 16 * tile) * H;
        const int live = live_cta - 16 * tile;  // the tile's rows inside the chunk
        if (tile != warp) gu_load(ga, gt, ut, H, 0, nkb, g, t, live);
        int ag[2][4] = {}, au[2][4] = {};
        for (int kb0 = 0; kb0 < nkb; kb0 += 2 * KU) {
            gu_load(gb, gt, ut, H, kb0 + KU, nkb, g, t, live);
            gu_mma<XG>(ga, xq_s, xstride, R, kb0, nkb, g, t, ag, au);
            gu_load(ga, gt, ut, H, kb0 + 2 * KU, nkb, g, t, live);
            gu_mma<XG>(gb, xq_s, xstride, R, kb0 + KU, nkb, g, t, ag, au);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // d q: row i = g (+8 for q ≥ 2), n = 2t + (q & 1)
            const int n = 2 * t + (q & 1);
            const int il = 16 * tile + g + (q >> 1) * 8;  // the row within the CTA's rows
            if (n < R && il < live_cta) {  // a row past the chunk forms no hmid
                const size_t i = i_cta + il;
                const float gg = __fmul_rn(__fmul_rn(static_cast<float>(ag[0][q] + ag[1][q]),
                                                     xs_s[n]), s_gate[i]);
                const float uu = __fmul_rn(__fmul_rn(static_cast<float>(au[0][q] + au[1][q]),
                                                     xs_s[n]), s_up[i]);
                const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-gg)));
                const float hm = __fmul_rn(__fmul_rn(sig, gg), uu);
                hmid_s[n * hm_stride + il] = hm;
                mx[q & 1] = fmaxf(mx[q & 1], fabsf(hm));
            }
        }
    }

    // down's first k-steps past the prefetched ones go out before the requant's barriers
    int4 da[KS][8], db[KS][8];
    if (u_first < units) dn_load(da, unit_slab(u_first), H, 0, nks, t, unit_live(u_first));

    // 3. requant: the chunk's max|hmid| per row over the cluster, then hq
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
            mx[q] = fmaxf(mx[q], __shfl_xor_sync(0xffffffffu, mx[q], off));
    if (g == 0) {
        wmax_s[warp][2 * t] = mx[0];
        wmax_s[warp][2 * t + 1] = mx[1];
    }
    __syncthreads();
    if (tid < R * CLUSTER) {  // thread (n, r2): this CTA's max of row n → CTA r2
        const int n = tid / CLUSTER, r2 = tid % CLUSTER;
        float m = 0.0f;
        for (int w = 0; w < WARPS; ++w) m = fmaxf(m, wmax_s[w][n]);
        *cluster.map_shared_rank(&cmax_s[k][n], r2) = m;
    }
    cluster.sync();
    if (tid < R) {
        float m = 0.0f;
        for (int r2 = 0; r2 < CLUSTER; ++r2) m = fmaxf(m, cmax_s[r2][tid]);
        hs_s[tid] = __fmul_rn(fmaxf(m, 1e-12f), INV_127);
        if (k == 0 && hs_out) hs_out[(size_t)tid * nchunks + c] = hs_s[tid];
    }
    __syncthreads();
    // every CTA writes its words of hq up to kc, zeros past the chunk (a
    // CTA with no rows of the chunk too), so down's padding k reads zeros
    const int wpr = rows_cta / 4;  // 4-code words of a row in this CTA
    for (int idx = tid; idx < R * wpr; idx += THREADS) {
        const int n = idx / wpr, w4 = idx - n * wpr;
        const int col = k * rows_cta + 4 * w4;  // the word's first code in the chunk
        if (col >= kc) continue;
        const float* hr = hmid_s + n * hm_stride + 4 * w4;
        unsigned packed = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (col + e < chunk) packed |= (unsigned)(quantize(hr[e], hs_s[n]) & 0xff) << (8 * e);
        int8_t* dst = hq_s + (size_t)n * hstride + col;
        if (HG)
            *reinterpret_cast<unsigned*>(dst) = packed;
        else
            for (int r2 = 0; r2 < CLUSTER; ++r2)
                *reinterpret_cast<unsigned*>(cluster.map_shared_rank(dst, r2)) = packed;
        if (hq_out && col < chunk) {
            int8_t* o = hq_out + (size_t)n * I + (size_t)c * chunk + col;
            if (col + 4 <= chunk && reinterpret_cast<uintptr_t>(o) % 4 == 0)
                *reinterpret_cast<unsigned*>(o) = packed;
            else
                for (int e = 0; e < 4 && col + e < chunk; ++e) o[e] = (int8_t)(packed >> (8 * e));
        }
    }
    cluster.sync();  // the chunk's hq in every CTA (HG: in the slab); no shared memory is read
                     // remotely after this

    // 4. down: unit u = (128-column group u / P, row part u % P) of the chunk
    for (int base = 0; base < units; base += CLUSTER * WARPS) {
        const int u = base + k * WARPS + warp;
        const bool have = u < units;
        const int cgp = u / P, pp = u % P;
        int acc[8][4] = {};
        if (have) {
            const int8_t* slab = unit_slab(u);
            const int live = unit_live(u);
            const int8_t* hq_row = HG && g >= R ? nullptr
                                                : hq_s + (size_t)g * hstride + pp * rows_part;
            if (base > 0) dn_load(da, slab, H, 0, nks, t, live);
            for (int ks0 = 0; ks0 < nks; ks0 += 2 * KS) {
                dn_load(db, slab, H, ks0 + KS, nks, t, live);
                dn_mma<HG>(da, hq_row, ks0, nks, t, acc);
                dn_load(da, slab, H, ks0 + 2 * KS, nks, t, live);
                dn_mma<HG>(db, hq_row, ks0 + KS, nks, t, acc);
            }
        }
        if (P > 1) {  // the row parts of a column group are warps of this CTA: add them (exact)
            if (have && pp != 0)
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) dn_red[(warp * 32 + j * 4 + e) * 32 + lane] = acc[j][e];
            __syncthreads();
            if (have && pp == 0)
                for (int p2 = 1; p2 < P; ++p2)
#pragma unroll
                    for (int j = 0; j < 8; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            acc[j][e] += dn_red[((warp + p2) * 32 + j * 4 + e) * 32 + lane];
            __syncthreads();
        }
        if (have && pp == 0) {  // this chunk's term of y: f32(acc)·hs
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int j = cgp * COLS + 16 * g + 4 * q + 2 * h;
                    const int* a = acc[2 * q + h];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int n = 2 * t + e;
                        if (n < R)
                            *reinterpret_cast<float2*>(part + ((size_t)c * R + n) * H + j) =
                                make_float2(__fmul_rn(static_cast<float>(a[e]), hs_s[n]),
                                            __fmul_rn(static_cast<float>(a[2 + e]), hs_s[n]));
                    }
                }
        }
    }

    // 5. the last CTA of rank k adds the chunks' terms of its columns in order
    __threadfence();
    __syncthreads();
    if (tid == 0) last_cta = atomicAdd(counters + k, 1) == nchunks - 1;
    __syncthreads();
    if (!last_cta) return;
    __threadfence();
    for (int base = 0; base < units; base += CLUSTER * WARPS) {
        const int u0 = base + k * WARPS;
        if (u0 >= units) break;
        const int j0 = u0 / P * COLS, ncols = (min(units, u0 + WARPS) - u0) / P * COLS;
        const int q4 = ncols / 4, total = R * q4;
        // SUMS groups of 4 columns a thread, their loads of one chunk side by
        // side: the chunk order of each sum is kept, the L2 round trips overlap
        for (int idx0 = tid; idx0 < total; idx0 += THREADS * SUMS) {
            float4 y[SUMS];
            size_t at[SUMS];
#pragma unroll
            for (int f = 0; f < SUMS; ++f) {
                const int idx = min(idx0 + f * THREADS, total - 1);
                const int n = idx / q4;
                at[f] = (size_t)n * H + j0 + 4 * (idx - n * q4);
                y[f] = make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll 4
            for (int c2 = 0; c2 < nchunks; ++c2) {
#pragma unroll
                for (int f = 0; f < SUMS; ++f) {
                    const float4 p = __ldcg(reinterpret_cast<const float4*>(part + (size_t)c2 * R * H + at[f]));
                    y[f].x = __fadd_rn(y[f].x, p.x);
                    y[f].y = __fadd_rn(y[f].y, p.y);
                    y[f].z = __fadd_rn(y[f].z, p.z);
                    y[f].w = __fadd_rn(y[f].w, p.w);
                }
            }
#pragma unroll
            for (int f = 0; f < SUMS; ++f) {
                if (idx0 + f * THREADS >= total) break;
                const int j = (int)(at[f] % H);
                const float4 xv = *reinterpret_cast<const float4*>(x + at[f]);
                const float4 sd = *reinterpret_cast<const float4*>(s_down + j);
                *reinterpret_cast<float4*>(out + at[f]) = make_float4(
                    __fadd_rn(xv.x, __fmul_rn(y[f].x, sd.x)), __fadd_rn(xv.y, __fmul_rn(y[f].y, sd.y)),
                    __fadd_rn(xv.z, __fmul_rn(y[f].z, sd.z)), __fadd_rn(xv.w, __fmul_rn(y[f].w, sd.w)));
            }
        }
    }
    if (tid == 0) counters[k] = 0;
}

}  // namespace

extern "C" {

// Whether a call at (R, H, chunk) keeps hq and hmid in device memory (the HG
// instance), and the bytes of its slab a chunk; part then holds I/chunk of
// them, 16-byte aligned, after its [I/chunk, R, H] f32 terms.
int fused_mlp_int8_hq_in_slab(int H, int chunk) {
    return smem_bytes(H, chunk, false, false) + 2048 > (size_t)SMEM_LIMIT &&
           smem_bytes(H, chunk, true, false) + 2048 > (size_t)SMEM_LIMIT;
}
long long fused_mlp_int8_hg_slab_bytes(int R, int chunk) { return (long long)hg_slab(R, chunk); }

// x [R, H] f32, g [H], gate_t / up_t / down [I, H] int8, s_gate / s_up [I],
// s_down [H]; scratch: part [I/chunk, R, H] f32 (also xq's rows where they
// do not fit in shared memory), counters [8] int32 (zero; left zero); out
// [R, H] f32. xq_out [R, H] int8, xs_out [R], hq_out [R, I] int8 and hs_out
// [R, I/chunk] f32 receive the codes and scales when not null. One launch
// on `stream`; returns its CUDA error, or 0. Any chunk ≥ 1 that divides I.
// Where hq and hmid outgrow shared memory (fused_mlp_int8_hq_in_slab), part
// holds [I/chunk] slabs of hg_slab(R, chunk) bytes after its terms.
int fused_mlp_int8_launch(const float* x, const float* g, const int8_t* gate_t,
                          const float* s_gate, const int8_t* up_t, const float* s_up,
                          const int8_t* down, const float* s_down, float* part, int* counters,
                          float* out, int8_t* xq_out, float* xs_out, int8_t* hq_out,
                          float* hs_out, int R, int H, int I, int chunk, float eps,
                          cudaStream_t stream) {
    if (R < 1 || R > MAX_R || H < 128 || H % 128 || chunk < 1 || I <= 0 || I % chunk)
        return static_cast<int>(cudaErrorInvalidValue);
    // xq, then hq and hmid, in shared memory where they fit beside the rest
    // (+ the static arrays); else XG, then HG, then both
    bool xg = false, hg = false;
    for (int m = 0; m < 4; ++m) {
        xg = m & 1;
        hg = m >> 1;
        if (smem_bytes(H, chunk, xg, hg) + 2048 <= (size_t)SMEM_LIMIT) break;
    }
    const size_t need = smem_bytes(H, chunk, xg, hg);
    if (need + 2048 > (size_t)SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = need > (size_t)SMEM_ONE_CTA ? need : (size_t)SMEM_ONE_CTA;
    const auto kernel = xg ? (hg ? fused_mlp_int8_kernel<true, true>
                                 : fused_mlp_int8_kernel<true, false>)
                           : (hg ? fused_mlp_int8_kernel<false, true>
                                 : fused_mlp_int8_kernel<false, false>);
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const float inv_h = 1.0f / static_cast<float>(H);
    kernel<<<dim3(CLUSTER, I / chunk), THREADS, smem, stream>>>(
        x, g, gate_t, s_gate, up_t, s_up, down, s_down, part, counters, out, xq_out, xs_out,
        hq_out, hs_out, R, H, I, chunk, inv_h, eps);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
