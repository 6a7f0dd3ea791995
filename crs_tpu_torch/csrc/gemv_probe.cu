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
// 32.8 MB of codes, 2 MB of scales and 4 MB of output at 3.35 TB/s, ≈ 11.6
// µs; the 4.2 G int8 products take 2.1 µs on the tensor cores, so bytes
// bound it. The codes fit in the 50 MB L2, so the tool's loop over one
// matrix reads them from there.
// Design: a block of 8 warps owns 256 columns and 32 rows of x; a warp owns
// 32 of the columns and all 32 rows (two m16 tiles), so each code byte is
// loaded and unpacked once a block. The codes (two TMA boxes of 64 packed
// rows × 128 bytes, 128-byte swizzled) and both halves of x (one box each)
// stream through a ring of 4 stages, one thread issuing a stage's boxes
// against an mbarrier, three stages (48 KB of codes) in flight; TMA fills
// zeros past K/2 and N. Where N % 16, the rows of x or the alignment rule
// out TMA, 4-byte cp.async copies lay the stage out the same way. x is read
// with ldmatrix as the A operand. At N 32,000 that is 125 blocks, one wave
// on 132 SMs. A chunk of 64 rows whose groups (steps) end only at piece
// edges runs in a straight line, every load first; others piece by piece.
//   unfolded: mma.sync m16n8k32 s8 with s32 sums. A lane reads a word (4
//     columns) of 4 packed rows and turns them into a word of 4 k for each
//     column (byte permutes): the B fragments of 4 n8 tiles whose columns
//     are interleaved by 4, so a lane's sums are 8 adjacent columns. The
//     masks (w << 4) & 0xF0F0F0F0 and w & 0xF0F0F0F0 make each byte 16 ×
//     the signed nibble, an exact int8 (RAW takes the byte whole). A group
//     shorter than 32 rows, or one that does not start on a 32-row edge,
//     masks the B words of the other rows to zero. At a group's end the
//     int32 sum is shifted back by 4 (exact), converted once and scaled
//     with f32 operations that are not contracted, in the Pallas kernel's
//     order, then × xs at a step's end: bit for bit the plain version. The
//     next group's scales are loaded a group ahead. K is not split across
//     blocks, so that order holds.
//   fold: mma.sync m16n8k16 bf16 with f32 sums. Each weight is made once a
//     block in registers: the nibble as a bf16 (128 + (nibble ^ 8), less
//     136, exact), × the bf16 scale of its row (one rounding, fma.rn.bf16x2
//     with −0), the scale rows tiled as above; a step that ends inside 16
//     rows masks the other rows' B words.
//
// q8_gemv_kernel replaces tools/bench_chain_gemv.py q8mm / k8 (a W8A16
// GEMV): x [R, K] bf16 (R ≤ 16), codes [K, N] int8, scales [N] f32 → out
// [R, N] = Σ_tiles (x_tile · bf16(codes_tile), f32 sums) · scale over K
// tiles of 512 rows. Bound at d 2048: the 4.19 MB of codes at 3.35 TB/s, ≈
// 1.25 µs; the 67 MFLOP take 0.07 µs on the tensor cores, so the kernel is
// bound by how many bytes are in flight. Design: a block of 8 warps owns 16
// columns and all of K (128 blocks at d 2048), so no sum crosses blocks: a
// K split over a cluster of blocks spent more on its barriers and exchange
// than it saved.
// One thread issues every tile at once where the ring of 4 holds them all:
// a tile's codes as two TMA boxes of 256 rows × 16 bytes and its x as eight
// boxes of 16 rows × 64 bf16 (128-byte swizzled; TMA fills the rows past R
// with zeros). Products on the tensor cores (mma.sync m16n8k16 bf16, f32
// sums): x is the A operand (16 rows), read with ldmatrix; a lane turns 2
// columns of 4 rows (16-bit reads, conflict-free at 16-byte rows) into the
// bf16 pairs of 2 n8 tiles in registers (exact: 128 + the low 7 bits, less
// 128 or 256 by the sign). A warp owns 64 rows of each tile and keeps its
// sums in its fragments, × the scale at the tile's end; the block's 8 warps
// meet in shared memory (R × 16 f32 each), added in warp order.
//
// db_gemv_kernel replaces tools/bench_chain_gemv.py dbmm / kdb (a W8A16 GEMV
// against a row-major weight, streamed through a manual two-slot DMA double
// buffer): x [R, K] bf16 (R ≤ 8), w [N, K] int8 → out [R, N] = (x ·
// bf16(w)ᵀ, f32 sums) · scale. Bound at d 2048: the 4.19 MB of the weight,
// ≈ 1.25 µs; the 67 MFLOP take 0.07 µs on the tensor cores, so bytes in
// flight bound it. Design: a block of 8 warps owns 16 weight rows (one m16
// tile; 128 blocks at d 2048) or, where N ≥ 4,096 still leaves 128 blocks,
// 32 (two tiles, halving the x a block reads for each weight byte), and all
// of K, so no sum crosses blocks. K comes in chunks of 512: the chunk's
// weight as four TMA boxes of 16 or 32 rows × 128 bytes and its x as eight
// boxes of 8 rows × 64 bf16 (both 128-byte swizzled; TMA fills x's rows
// past R with zeros), so x comes into shared memory once a block and no
// warp reads it from device memory. One thread issues every chunk at once
// where the ring holds them all (64 KB at d 2048), else a ring runs with
// all its stages but one in flight: up to 200 KB where the grid is one
// wave, else 96 KB so that two blocks share an SM. Products on the tensor
// cores (mma.sync m16n8k16 bf16, f32 sums): the weight is A (16 rows the
// m16, row-major as stored), x is B (its ≤ 8 rows the n8, whose col layout
// is x's [R, K] rows). A warp sums 128-wide pieces of K, piece p on warp p
// mod 8, in two product chains; K is permuted alike in both operands, so a
// lane reads 16 contiguous bytes of rows g and g + 8 (a word of 4 k a
// product: bytes 0, 1 its a0 / a1, bytes 2, 3 its a2 / a3, made bf16 by
// s8_pair_bf16) and x's row g at the same k as 16-byte words (an 8-byte
// half is b0 / b1); no ldmatrix, and the lanes' chunks are chosen so that
// every 16-byte read is free of bank conflicts. The 8 warps' sums meet in
// shared memory, added in warp order, × the scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_async.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 4 bytes, or 4 zeros when !ok (src is then not read)
__device__ __forceinline__ void cp_async4_or_zero(uint32_t dst, const void* src, bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8×8 b16 matrices: lanes 0–7 give the rows of the first, 8–15 of the
// second, ...; register i holds the lane's word of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

// d += A·B: A 16×32 s8 (a0: row g, k 4t..; a1: row g+8; a2: row g, k 16+4t..;
// a3: row g+8), B 32×8 s8 (b0: k 4t.., column g; b1: k 16+4t..), d 16×8 s32
// (d0, d1: row g, columns 2t, 2t+1; d2, d3: row g+8); g = lane / 4, t = lane % 4
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same for bf16, K 16: a0: row g, k 2t, 2t+1; a1: row g+8; a2: row g,
// k 8+2t..; a3: row g+8; b0: k 2t, 2t+1 of column g; b1: k 8+2t..; f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a · b + c on bf16 pairs, rounded once
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}

constexpr uint32_t BF2_NEG_ONE = 0xBF80BF80u;  // (−1, −1)
constexpr uint32_t BF2_NEG_ZERO = 0x80008000u;
constexpr uint32_t BF2_ONE = 0x3F803F80u;
constexpr uint32_t BF2_M136 = 0xC308C308u;     // (−136, −136)

// bytes 0 and 2 of w (lower first) as exact bf16 int8 values: 128 + the low
// 7 bits, less 128 + the sign bit (128 or 256)
__device__ __forceinline__ uint32_t s8_pair_bf16(uint32_t w) {
    const uint32_t mag = (w & 0x007F007Fu) | 0x43004300u;
    const uint32_t sgn = (w & 0x00800080u) | 0x43004300u;
    return fma_bf16x2(sgn, BF2_NEG_ONE, mag);
}

// the low nibbles of bytes 0 and 2 of w as exact bf16 values in [−8, 7]:
// 128 + (nibble ^ 8), less 136
__device__ __forceinline__ uint32_t s4_pair_bf16(uint32_t w) {
    return fma_bf16x2((w & 0x000F000Fu) ^ 0x43084308u, BF2_ONE, BF2_M136);
}

// byte c of a (low half) and of b (high half), in bytes 0 and 2
__device__ __forceinline__ uint32_t pair_bytes(uint32_t a, uint32_t b, int c) {
    return __byte_perm(a, b, (uint32_t)(c | (c << 4) | ((c + 4) << 8) | ((c + 4) << 12)));
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
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

constexpr int QP_ROWS = 32;                   // rows of x a block owns: two m16 tiles
constexpr int QP_WARPS = 8;
constexpr int QP_THREADS = 32 * QP_WARPS;
constexpr int QP_WCOLS = 32;                  // columns a warp owns: four n8 tiles
constexpr int QP_COLS = QP_WARPS * QP_WCOLS;  // columns a block owns
constexpr int QP_KC = 64;                     // packed rows a ring stage holds
constexpr int QP_STAGES = 4;
constexpr int QP_BOX = 128;                   // columns of codes a TMA box holds (128 bytes)

// A ring stage, laid out as the TMA boxes land (1024-byte aligned): [codes:
// two boxes of QP_KC rows × 128 columns, 128-byte swizzled][xe: QP_ROWS rows
// × QP_KC elements][xo: the same], x 64-byte swizzled (int8, 64-byte rows) or
// 128-byte swizzled (bf16, 128-byte rows). The cp.async route writes the
// same layout.
template <bool FOLD>
struct QpStage {
    static constexpr int XB = FOLD ? 2 : 1;          // bytes an element of x
    static constexpr int X_ROW = QP_KC * XB;         // 64 or 128
    static constexpr int BOX_BYTES = QP_KC * QP_BOX;
    static constexpr int CODE_BYTES = 2 * BOX_BYTES;
    static constexpr int X_BYTES = QP_ROWS * X_ROW;
    static constexpr int BYTES = CODE_BYTES + 2 * X_BYTES;  // a multiple of 1024
};

// byte offset of (packed row r, column c) in a stage's codes: 16-byte chunk
// (c / 16) % 8 of a 128-byte row stored at chunk ((c / 16) % 8) ^ (r % 8)
__device__ __forceinline__ int qp_code_off(int r, int c) {
    return (c >> 7) * (QP_KC * QP_BOX) + r * QP_BOX + ((((c >> 4) & 7) ^ (r & 7)) << 4) + (c & 15);
}

// byte offset of (row r, byte b) in a stage's xe or xo: the TMA swizzle of
// 64-byte rows (chunk ^ (r / 2) % 4) or 128-byte rows (chunk ^ r % 8)
template <bool FOLD>
__device__ __forceinline__ int qp_x_off(int r, int b) {
    return FOLD ? r * 128 + ((((b >> 4) & 7) ^ (r & 7)) << 4) + (b & 15)
                : r * 64 + ((((b >> 4) & 3) ^ ((r >> 1) & 3)) << 4) + (b & 15);
}

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

// scales of the fold's packed row j: the step's gpt scale rows tiled
__device__ __forceinline__ int fold_scale_row(int j, int kt2, int gpt) {
    const int step = j / kt2;
    return step * gpt + (j - step * kt2) % gpt;
}

// Lane (g, t) of warp w: rows g, g+8 of each m16 tile; of n8 tile c, the
// block column w·32 + 4·g' + c holds tile column g', so the lane's sums are
// columns w·32 + 8t .. 8t+7 (element e: + 4·(e & 1) + c, row + 8·(e >> 1)).
// TMA: the codes and x arrive as TMA boxes (one thread issues a stage's
// four), else by cp.async (4-byte copies where N % 16, the rows of x or the
// alignment forbid 16-byte ones).
template <bool FOLD, bool RAW, bool TMA>
__global__ void __launch_bounds__(QP_THREADS, 1)
q4_probe_kernel(const __grid_constant__ CUtensorMap tm_codes,  // [K2, N] u8, box 128 × 64
                const __grid_constant__ CUtensorMap tm_xe,     // [rt, K2], box 64 × 32
                const __grid_constant__ CUtensorMap tm_xo,
                const void* __restrict__ xe_, const void* __restrict__ xo_,
                const float* __restrict__ xs, const uint8_t* __restrict__ codes,
                const float* __restrict__ scales, float* __restrict__ out, int K2, int N, int gs2,
                int gpt) {
    using S = QpStage<FOLD>;
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t full[QP_STAGES];  // TMA: a stage's bytes have landed
    uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                               ~(uintptr_t)1023);
    const uint8_t* xe = static_cast<const uint8_t*>(xe_);
    const uint8_t* xo = static_cast<const uint8_t*>(xo_);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = blockIdx.y * QP_ROWS;
    const int bcol = blockIdx.x * QP_COLS;     // the block's first column
    const int wcol = bcol + warp * QP_WCOLS;   // the warp's
    const int kt2 = gpt * gs2;
    const int nch = (K2 + QP_KC - 1) / QP_KC;
    const int slots = min(QP_STAGES, nch);
    const size_t xrow = (size_t)K2 * S::XB;   // bytes a row of x

    // chunk ch (packed rows 64·ch ..) → its ring slot; zeros past K2 and N
    auto issue = [&](int ch) {
        uint8_t* st = smem + (ch % slots) * S::BYTES;
        const int j0 = ch * QP_KC;
        if constexpr (TMA) {
            if (tid == 0) {  // the second box only where it holds a column below N
                const bool box1 = bcol + QP_BOX < N;
                const uint32_t bar = sm90::smem_u32(&full[ch % slots]);
                sm90::mbar_expect_tx(bar, box1 ? S::BYTES : S::BYTES - S::BOX_BYTES);
                sm90::tma_load_2d(smem_addr(st), &tm_codes, bcol, j0, bar);
                if (box1)
                    sm90::tma_load_2d(smem_addr(st + S::BOX_BYTES), &tm_codes, bcol + QP_BOX, j0,
                                      bar);
                sm90::tma_load_2d(smem_addr(st + S::CODE_BYTES), &tm_xe, j0, row0, bar);
                sm90::tma_load_2d(smem_addr(st + S::CODE_BYTES + S::X_BYTES), &tm_xo, j0, row0,
                                  bar);
            }
        } else {
            const size_t xoff = (size_t)row0 * xrow + (size_t)j0 * S::XB;
            constexpr int CPR = QP_COLS / 4;        // 4-byte copies a row of codes
            constexpr int XPR = QP_KC * S::XB / 4;  // ... a row of x
            for (int i = tid; i < QP_KC * CPR; i += QP_THREADS) {
                const int r = i / CPR, c = 4 * (i % CPR);
                const bool ok = j0 + r < K2 && bcol + c < N;
                cp_async4_or_zero(smem_addr(st + qp_code_off(r, c)),
                                  ok ? codes + (size_t)(j0 + r) * N + bcol + c : codes, ok);
            }
            for (int i = tid; i < 2 * QP_ROWS * XPR; i += QP_THREADS) {
                const int h = i / (QP_ROWS * XPR), r = (i / XPR) % QP_ROWS, c = 4 * (i % XPR);
                const bool ok = (size_t)j0 * S::XB + c < xrow;
                const uint8_t* src = ok ? (h ? xo : xe) + xoff + (size_t)r * xrow + c : xe;
                const int dst = S::CODE_BYTES + h * S::X_BYTES + qp_x_off<FOLD>(r, c);
                cp_async4_or_zero(smem_addr(st + dst), src, ok);
            }
        }
    };
    if constexpr (TMA) {
        if (tid == 0) {
            for (int s = 0; s < QP_STAGES; ++s) sm90::mbar_init(sm90::smem_u32(&full[s]), 1);
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        __syncthreads();
    }
#pragma unroll
    for (int s = 0; s < QP_STAGES - 1; ++s) {
        if (s < nch) issue(s);
        if constexpr (!TMA) cp_async_commit();
    }

    float xsv[2][2];  // xs of the lane's rows (m16 tile, + 8)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) xsv[mt][h] = xs[row0 + 16 * mt + g + 8 * h];
    // unfolded: acc the group's int32 sums, kacc the step's f32 sum; fold:
    // acc the step's f32 sums
    using Acc = typename std::conditional<FOLD, float, int>::type;
    Acc acc[2][4][4];
    float kacc[2][4][4], total[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                acc[mt][c][e] = 0, kacc[mt][c][e] = 0.f, total[mt][c][e] = 0.f;

    // the step's end: × xs, added in step order
    auto end_step = [&](float (&sum)[2][4][4]) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    total[mt][c][e] =
                        __fadd_rn(total[mt][c][e], __fmul_rn(sum[mt][c][e], xsv[mt][e >> 1]));
                    sum[mt][c][e] = 0.f;
                }
    };

    const int arow = (lane & 7) + 8 * ((lane >> 3) & 1), acol = 16 * (lane >> 4);
    const int ccol = warp * QP_WCOLS + 4 * g;  // the lane's 4 code columns in the stage
    // the stage offsets of the lane's 4 code words of a 16-row group: rows
    // 4t + q (unfolded) or 2t, 2t + 1, 8 + 2t, 9 + 2t (fold); whole groups of
    // 8 rows further on keep the swizzle
    int coff[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
        coff[q] = qp_code_off(FOLD ? 2 * t + (q & 1) + 8 * (q >> 1) : 4 * t + q, ccol);
    const bool scol_ok = wcol + 4 * g < N;
    int group_end = gs2, step_end = kt2, grp = 0;
    // unfolded: the scales of the lane's 8 columns for the current group,
    // loaded a group ahead of its end
    float gsc[8];
    auto load_group_scales = [&](int gi) {
        const float* sp = scales + (size_t)gi * N + wcol + 8 * t;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 va = wcol + 8 * t < N ? __ldg(reinterpret_cast<const float4*>(sp)) : zero;
        const float4 vb =
            wcol + 8 * t + 4 < N ? __ldg(reinterpret_cast<const float4*>(sp + 4)) : zero;
        gsc[0] = va.x, gsc[1] = va.y, gsc[2] = va.z, gsc[3] = va.w;
        gsc[4] = vb.x, gsc[5] = vb.y, gsc[6] = vb.z, gsc[7] = vb.w;
    };
    if constexpr (!FOLD) load_group_scales(0);
    // fold: the lane's bf16 scale pairs (rows 2t, 2t+1 | 8+2t, 9+2t of the 16),
    // the same in every 16-row piece of a step when gpt divides 16
    uint32_t sb0[4] = {0u, 0u, 0u, 0u}, sb1[4] = {0u, 0u, 0u, 0u};
    const bool per_step = kt2 % 16 == 0 && 16 % gpt == 0;

    // unfolded: the group's end: its f32 term, in group order; at a step's end × xs
    auto end_group = [&]() {
        if constexpr (!FOLD) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int c = 0; c < 4; ++c)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float v = (float)(RAW ? acc[mt][c][e] : acc[mt][c][e] >> 4);
                        kacc[mt][c][e] =
                            __fadd_rn(kacc[mt][c][e], __fmul_rn(v, gsc[4 * (e & 1) + c]));
                        acc[mt][c][e] = 0;
                    }
            if (group_end < K2) load_group_scales(grp + 1);
            ++grp;
            if (group_end == step_end) {
                end_step(kacc);
                step_end += kt2;
            }
            group_end += gs2;
        }
    };
    // fold: the bf16 scale pairs of the lane's rows of the 16 at j0
    auto load_fold_scales = [&](int j0) {
        float4 sv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int srow = fold_scale_row(min(j0 + 2 * t + (q & 1) + 8 * (q >> 1), K2 - 1),
                                            kt2, gpt);
            sv[q] = scol_ok ? __ldg(reinterpret_cast<const float4*>(scales + (size_t)srow * N +
                                                                    wcol + 4 * g))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        sb0[0] = bf16_pair(sv[0].x, sv[1].x), sb1[0] = bf16_pair(sv[2].x, sv[3].x);
        sb0[1] = bf16_pair(sv[0].y, sv[1].y), sb1[1] = bf16_pair(sv[2].y, sv[3].y);
        sb0[2] = bf16_pair(sv[0].z, sv[1].z), sb1[2] = bf16_pair(sv[2].z, sv[3].z);
        sb0[3] = bf16_pair(sv[0].w, sv[1].w), sb1[3] = bf16_pair(sv[2].w, sv[3].w);
    };
    // unfolded: B of the 32 rows whose words are w (rows 4t + q, 16 + 4t + q)
    auto int4_b = [&](const uint32_t* w, uint32_t (&lo0)[4], uint32_t (&hi0)[4],
                      uint32_t (&lo1)[4], uint32_t (&hi1)[4]) {
        uint32_t c0[4], c1[4];
        transpose4(*reinterpret_cast<const uint32_t(*)[4]>(w), c0);
        transpose4(*reinterpret_cast<const uint32_t(*)[4]>(w + 4), c1);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            lo0[c] = RAW ? c0[c] : (c0[c] << 4) & 0xF0F0F0F0u;
            hi0[c] = RAW ? c0[c] : c0[c] & 0xF0F0F0F0u;
            lo1[c] = RAW ? c1[c] : (c1[c] << 4) & 0xF0F0F0F0u;
            hi1[c] = RAW ? c1[c] : c1[c] & 0xF0F0F0F0u;
        }
    };
    // fold: B of the 16 rows whose words are w (rows 2t, 2t+1, 8+2t, 9+2t):
    // bf16(nibble · bf16(scale)) of column c
    auto fold_b = [&](const uint32_t* w, uint32_t (&lo0)[4], uint32_t (&hi0)[4],
                      uint32_t (&lo1)[4], uint32_t (&hi1)[4]) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const uint32_t p0 = pair_bytes(w[0], w[1], c), p1 = pair_bytes(w[2], w[3], c);
            if constexpr (RAW) {
                lo0[c] = hi0[c] = fma_bf16x2(s8_pair_bf16(p0), sb0[c], BF2_NEG_ZERO);
                lo1[c] = hi1[c] = fma_bf16x2(s8_pair_bf16(p1), sb1[c], BF2_NEG_ZERO);
            } else {
                lo0[c] = fma_bf16x2(s4_pair_bf16(p0), sb0[c], BF2_NEG_ZERO);
                hi0[c] = fma_bf16x2(s4_pair_bf16(p0 >> 4), sb0[c], BF2_NEG_ZERO);
                lo1[c] = fma_bf16x2(s4_pair_bf16(p1), sb1[c], BF2_NEG_ZERO);
                hi1[c] = fma_bf16x2(s4_pair_bf16(p1 >> 4), sb1[c], BF2_NEG_ZERO);
            }
        }
    };
    // the products of one piece (32 rows unfolded, 16 fold), B's words masked by m0, m1
    auto products = [&](const uint32_t (&ae)[2][4], const uint32_t (&ao)[2][4],
                        const uint32_t (&lo0)[4], const uint32_t (&hi0)[4],
                        const uint32_t (&lo1)[4], const uint32_t (&hi1)[4], uint32_t m0,
                        uint32_t m1) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                if constexpr (FOLD) {
                    mma_bf16(acc[mt][c], ae[mt], lo0[c] & m0, lo1[c] & m1);
                    mma_bf16(acc[mt][c], ao[mt], hi0[c] & m0, hi1[c] & m1);
                } else {
                    mma_s8(acc[mt][c], ae[mt], lo0[c] & m0, lo1[c] & m1);
                    mma_s8(acc[mt][c], ao[mt], hi0[c] & m0, hi1[c] & m1);
                }
            }
    };
    constexpr int PIECE = FOLD ? 16 : 32;     // packed rows of one product's K
    constexpr int PIECES = QP_KC / PIECE;
    // the stage's A fragments and code words of piece p
    auto load_piece = [&](const uint8_t* st, int p, uint32_t (&ae)[2][4], uint32_t (&ao)[2][4],
                          uint32_t* w) {
        const uint32_t sxe = smem_addr(st + S::CODE_BYTES), sxo = sxe + S::X_BYTES;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
            const uint32_t off = qp_x_off<FOLD>(16 * mt + arow, 32 * p + acol);
            ldsm_x4(ae[mt], sxe + off);
            ldsm_x4(ao[mt], sxo + off);
        }
#pragma unroll
        for (int q = 0; q < (FOLD ? 4 : 8); ++q)  // unfolded: rows 4t + q, then 16 + 4t + q
            w[q] = *reinterpret_cast<const uint32_t*>(
                st + coff[q & 3] + (PIECE * p + (FOLD ? 0 : 16 * (q >> 2))) * QP_BOX);
    };

    for (int ch = 0; ch < nch; ++ch) {
        if constexpr (TMA) sm90::mbar_wait(sm90::smem_u32(&full[ch % slots]), (ch / slots) & 1);
        else cp_async_wait<QP_STAGES - 2>();  // this thread's copies of chunk ch have landed
        __syncthreads();  // ... every thread's; chunk ch − 1 is read
        if (ch + QP_STAGES - 1 < nch) issue(ch + QP_STAGES - 1);
        if constexpr (!TMA) cp_async_commit();
        const uint8_t* st = smem + (ch % slots) * S::BYTES;
        const int c0 = ch * QP_KC;
        // a whole chunk whose groups (unfolded) or steps (fold) end only at
        // piece edges: every load first, then the pieces in a straight line
        if (c0 + QP_KC <= K2 && (FOLD ? kt2 : gs2) % PIECE == 0) {
            uint32_t ae[PIECES][2][4], ao[PIECES][2][4], w[PIECES][FOLD ? 4 : 8];
#pragma unroll
            for (int p = 0; p < PIECES; ++p) load_piece(st, p, ae[p], ao[p], w[p]);
#pragma unroll
            for (int p = 0; p < PIECES; ++p) {
                const int j0 = c0 + PIECE * p;
                uint32_t lo0[4], hi0[4], lo1[4], hi1[4];
                if constexpr (FOLD) {
                    if (!per_step || j0 == step_end - kt2) load_fold_scales(j0);
                    fold_b(w[p], lo0, hi0, lo1, hi1);
                } else {
                    int4_b(w[p], lo0, hi0, lo1, hi1);
                }
                products(ae[p], ao[p], lo0, hi0, lo1, hi1, ~0u, ~0u);
                if constexpr (FOLD) {
                    if (j0 + PIECE == step_end) {
                        end_step(acc);
                        step_end += kt2;
                    }
                } else if (j0 + PIECE == group_end) {
                    end_group();
                }
            }
            continue;
        }
        // else piece by piece, each cut where a group (unfolded) or a step
        // (fold) ends, B's words of the other rows masked out
        for (int p = 0; p < PIECES; ++p) {
            const int j0 = c0 + PIECE * p;
            if (j0 >= K2) break;
            uint32_t ae[2][4], ao[2][4], w[FOLD ? 4 : 8];
            load_piece(st, p, ae, ao, w);
            uint32_t lo0[4], hi0[4], lo1[4], hi1[4];
            if constexpr (FOLD) {
                if (!per_step || j0 == step_end - kt2) load_fold_scales(j0);
                fold_b(w, lo0, hi0, lo1, hi1);
            } else {
                int4_b(w, lo0, hi0, lo1, hi1);
            }
            // the lane's rows: b0 from j0 + 4t (unfolded) or 2t (fold), b1 PIECE / 2 on
            const int r0 = j0 + (FOLD ? 2 : 4) * t, r1 = r0 + PIECE / 2;
            const int end = min(j0 + PIECE, K2);
            for (int seg = j0; seg < end;) {
                const int edge = FOLD ? step_end : group_end;
                const int send = min(end, edge);
                products(ae, ao, lo0, hi0, lo1, hi1, r0 >= seg && r0 < send ? ~0u : 0u,
                         r1 >= seg && r1 < send ? ~0u : 0u);
                if (send == edge) {
                    if constexpr (FOLD) {
                        end_step(acc);
                        step_end += kt2;
                    } else {
                        end_group();
                    }
                }
                seg = send;
            }
        }
    }

#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float* o = out + (size_t)(row0 + 16 * mt + g + 8 * h) * N + wcol + 8 * t;
            if (wcol + 8 * t < N)
                *reinterpret_cast<float4*>(o) =
                    make_float4(total[mt][0][2 * h], total[mt][1][2 * h], total[mt][2][2 * h],
                                total[mt][3][2 * h]);
            if (wcol + 8 * t + 4 < N)
                *reinterpret_cast<float4*>(o + 4) =
                    make_float4(total[mt][0][2 * h + 1], total[mt][1][2 * h + 1],
                                total[mt][2][2 * h + 1], total[mt][3][2 * h + 1]);
        }
}

// -- q8_gemv_kernel ----------------------------------------------------------------

constexpr int Q8_WARPS = 8;
constexpr int Q8_THREADS = 32 * Q8_WARPS;
constexpr int Q8_COLS = 16;        // columns a block owns: two n8 tiles
constexpr int Q8_TILE = 512;       // k8's K tile, and the rows a ring stage holds (64 a warp)
constexpr int Q8_BOX_ROWS = 256;   // rows of codes a TMA box holds (the most a box takes)
constexpr int Q8_STAGES = 4;
constexpr int Q8_MAX_ROWS = 16;
constexpr int Q8_CODE_BYTES = Q8_TILE * Q8_COLS;       // two boxes of 256 rows × 16 bytes
constexpr int Q8_XBOX = Q8_MAX_ROWS * 128;             // 16 rows × 64 bf16 of x, 128-byte swizzled
constexpr int Q8_STAGE = Q8_CODE_BYTES + (Q8_TILE / 64) * Q8_XBOX;  // a multiple of 1024

// shared memory (from a 1024-byte aligned base): [ring: slots × (codes: 512
// rows × 16 bytes, x: eight boxes of 16 rows × 64 bf16)][red: 8 warps × R ×
// 16 f32], slots = min(4, K / 512). The TMA boxes zero x's rows past R.
// Warp w: rows 64·w .. of each tile, both n8 tiles. Lane (g, t): its sums are
// x rows g, g+8 and columns 4t .. 4t+3 (n8 tile c holds column 2·g' + c at
// tile column g').
__global__ void __launch_bounds__(Q8_THREADS, 2)
q8_gemv_kernel(const __grid_constant__ CUtensorMap tm_codes,  // [K, N] int8, box 16 × 256
               const __grid_constant__ CUtensorMap tm_x,      // [R, K] bf16, box 64 × 16
               const float* __restrict__ scales, float* __restrict__ out, int R, int K, int N) {
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t full[Q8_STAGES];
    uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                               ~(uintptr_t)1023);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int col0 = blockIdx.x * Q8_COLS;
    const int nch = K / Q8_TILE;
    const int slots = min(Q8_STAGES, nch);
    float* red = reinterpret_cast<float*>(smem + (size_t)slots * Q8_STAGE);

    auto issue = [&](int ch) {  // one thread: the tile's codes and x as TMA boxes
        const uint32_t st = smem_addr(smem + (size_t)(ch % slots) * Q8_STAGE);
        const uint32_t bar = sm90::smem_u32(&full[ch % slots]);
        const int k0 = ch * Q8_TILE;
        sm90::mbar_expect_tx(bar, Q8_STAGE);
        for (int b = 0; b < Q8_TILE / Q8_BOX_ROWS; ++b)
            sm90::tma_load_2d(st + b * Q8_BOX_ROWS * Q8_COLS, &tm_codes, col0, k0 + b * Q8_BOX_ROWS,
                              bar);
        for (int b = 0; b < Q8_TILE / 64; ++b)
            sm90::tma_load_2d(st + Q8_CODE_BYTES + b * Q8_XBOX, &tm_x, k0 + 64 * b, 0, bar);
    };
    // every tile at once when the ring holds them all, else the ring's first three
    const int pre = nch <= Q8_STAGES ? nch : Q8_STAGES - 1;
    if (tid == 0) {
        for (int s = 0; s < Q8_STAGES; ++s) sm90::mbar_init(sm90::smem_u32(&full[s]), 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int s = 0; s < pre; ++s) issue(s);
    }
    __syncthreads();

    float sc[4];  // the scales of the lane's 4 columns
    {
        const float4 v = __ldg(reinterpret_cast<const float4*>(scales + col0 + 4 * t));
        sc[0] = v.x, sc[1] = v.y, sc[2] = v.z, sc[3] = v.w;
    }
    float wsum[2][4] = {};  // the warp's sums, × the scale tile by tile
    const int arow = (lane & 7) + 8 * ((lane >> 3) & 1);
    for (int ch = 0; ch < nch; ++ch) {
        sm90::mbar_wait(sm90::smem_u32(&full[ch % slots]), (ch / slots) & 1);
        __syncthreads();  // every thread has read tile ch − 1
        if (tid == 0 && ch + Q8_STAGES - 1 >= pre && ch + Q8_STAGES - 1 < nch)
            issue(ch + Q8_STAGES - 1);
        const uint8_t* st = smem + (size_t)(ch % slots) * Q8_STAGE;
        float acc[2][4] = {};  // the tile's sums
#pragma unroll
        for (int step = 0; step < 4; ++step) {
            const int r0 = 64 * warp + 16 * step;  // the step's 16 rows in the tile
            const int e = r0 + 8 * (lane >> 4);   // the lane's 8 elements of x for ldmatrix
            const int xb = 2 * (e & 63);
            uint32_t a[4];
            ldsm_x4(a, smem_addr(st + Q8_CODE_BYTES + (e >> 6) * Q8_XBOX + arow * 128 +
                                 ((((xb >> 4) ^ (arow & 7))) << 4)));
            // columns 2g, 2g + 1 of rows 2t, 2t + 1, 8 + 2t, 9 + 2t
            const uint8_t* cr = st + (r0 + 2 * t) * Q8_COLS + 2 * g;
            const uint32_t w0 = *reinterpret_cast<const uint16_t*>(cr);
            const uint32_t w1 = *reinterpret_cast<const uint16_t*>(cr + Q8_COLS);
            const uint32_t w2 = *reinterpret_cast<const uint16_t*>(cr + 8 * Q8_COLS);
            const uint32_t w3 = *reinterpret_cast<const uint16_t*>(cr + 9 * Q8_COLS);
#pragma unroll
            for (int c = 0; c < 2; ++c)
                mma_bf16(acc[c], a, s8_pair_bf16(pair_bytes(w0, w1, c)),
                         s8_pair_bf16(pair_bytes(w2, w3, c)));
        }
#pragma unroll
        for (int c = 0; c < 2; ++c)  // × the scale, added tile by tile
#pragma unroll
            for (int e = 0; e < 4; ++e) wsum[c][e] += acc[c][e] * sc[2 * (e & 1) + c];
    }

    // the block's sum over its 8 warps, in warp order
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = g + 8 * (e >> 1);
            if (r < R) red[(warp * R + r) * Q8_COLS + 4 * t + 2 * (e & 1) + c] = wsum[c][e];
        }
    __syncthreads();
    for (int i = tid; i < R * Q8_COLS; i += Q8_THREADS) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < Q8_WARPS; ++w) v += red[w * R * Q8_COLS + i];
        out[(size_t)(i / Q8_COLS) * N + col0 + i % Q8_COLS] = v;
    }
}

// -- db_gemv_kernel ----------------------------------------------------------------

constexpr int DB_WARPS = 8;
constexpr int DB_THREADS = 32 * DB_WARPS;
constexpr int DB_MAX_ROWS = 8;     // rows of x: the n8 of one product
constexpr int DB_CHUNK = 512;      // kdb's chunk, and the k a ring stage holds
constexpr int DB_PIECE = 128;      // k a warp sums at a time: one weight box's width
constexpr int DB_RING2 = 96 * 1024;    // bytes of ring a block at two blocks an SM
constexpr int DB_RING1 = 200 * 1024;   // ... at one (a grid of at most 132 blocks)
constexpr int DB_XBOX = DB_MAX_ROWS * 128;  // 8 rows × 64 bf16 of x
constexpr int DB_XBYTES = (DB_CHUNK / 64) * DB_XBOX;  // a stage's x: 8 KB

// a block of MT m16 tiles: 16·MT weight rows
template <int MT>
struct DbStage {
    static constexpr int ROWS = 16 * MT;
    static constexpr int WBOX = ROWS * DB_PIECE;                // ROWS weight rows × 128 bytes
    static constexpr int WBYTES = (DB_CHUNK / DB_PIECE) * WBOX;  // a stage's weight
    static constexpr int BYTES = WBYTES + DB_XBYTES;              // a multiple of 1024
    static constexpr int MAX_SLOTS = DB_RING1 / BYTES;            // 12 (MT 1) or 8 (MT 2)
};

// the 4-byte word j of a 16-byte read
__device__ __forceinline__ uint32_t word_of(const uint4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// shared memory (from a 1024-byte aligned base): the ring, slots × (weight:
// four boxes of 16·MT rows × 128 bytes; x: eight boxes of 8 rows × 64 bf16),
// slots ≤ K / 512 stages (the launcher's choice), both 128-byte swizzled
// (16-byte chunk c of row r at chunk c ^ r % 8). Lane (g, t): its sums are
// weight rows 16·mt + g and 16·mt + g + 8 of each tile mt, x rows 2t, 2t + 1.
template <int MT>
__global__ void __launch_bounds__(DB_THREADS, 2)
db_gemv_kernel(const __grid_constant__ CUtensorMap tm_w,  // [N, K] int8, box 128 × 16·MT
               const __grid_constant__ CUtensorMap tm_x,  // [R, K] bf16, box 64 × 8
               float* __restrict__ out, int R, int K, int N, float scale, int slots) {
    using S = DbStage<MT>;
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t full[S::MAX_SLOTS];
    __shared__ float red[DB_WARPS][DB_MAX_ROWS][S::ROWS];  // the warps' sums
    uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                               ~(uintptr_t)1023);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int n0 = blockIdx.x * S::ROWS;
    const int nch = K / DB_CHUNK;
    const bool ring = nch > slots;

    auto issue = [&](int ch) {  // one thread: the chunk's weight and x as TMA boxes
        const uint32_t st = smem_addr(smem + (size_t)(ch % slots) * S::BYTES);
        const uint32_t bar = sm90::smem_u32(&full[ch % slots]);
        const int k0 = ch * DB_CHUNK;
        sm90::mbar_expect_tx(bar, S::BYTES);
        for (int b = 0; b < DB_CHUNK / DB_PIECE; ++b)
            sm90::tma_load_2d(st + b * S::WBOX, &tm_w, k0 + b * DB_PIECE, n0, bar);
        for (int b = 0; b < DB_CHUNK / 64; ++b)
            sm90::tma_load_2d(st + S::WBYTES + b * DB_XBOX, &tm_x, k0 + 64 * b, 0, bar);
    };
    // every chunk at once when the ring holds them all, else all but one slot's
    const int pre = ring ? slots - 1 : nch;
    if (tid == 0) {
        for (int s = 0; s < slots; ++s) sm90::mbar_init(sm90::smem_u32(&full[s]), 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int c = 0; c < pre; ++c) issue(c);
    }
    __syncthreads();

    // the lane's reads in a piece: weight chunks 2t + (h ^ (t >> 1)) (h = 0, 1)
    // of rows g + 8i (1024·i bytes on), and x chunks 4(t & 1) + (q ^ 2(t >> 1))
    // (q = 0..3) of row g in x box t >> 1: k 32t .. 32t + 31 of the piece in
    // both, each 8-lane phase of a read on 8 distinct bank groups
    int woff[2], xoff[4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
        woff[h] = g * 128 + (((2 * t + (h ^ (t >> 1))) ^ g) << 4);
#pragma unroll
    for (int q = 0; q < 4; ++q)
        xoff[q] = S::WBYTES + (t >> 1) * DB_XBOX + g * 128 +
                  (((4 * (t & 1) + (q ^ (2 * (t >> 1)))) ^ g) << 4);
    float acc[MT][2][4] = {};  // by tile and by weight read h: independent product chains
    for (int ch = 0; ch < nch; ++ch) {
        if (ring) {
            __syncthreads();  // every warp has read chunk ch − 1: its slot is free
            if (tid == 0 && ch + slots - 1 < nch) issue(ch + slots - 1);
        }
        if ((ch & 1) != (warp >> 2)) continue;  // piece 4·ch + (warp & 3) is warp p mod 8's
        sm90::mbar_wait(sm90::smem_u32(&full[ch % slots]), (ch / slots) & 1);  // chunk ch landed
        const uint8_t* sb = smem + (size_t)(ch % slots) * S::BYTES;
        // the piece: weight box warp & 3, x boxes 2(warp & 3) and 2(warp & 3) + 1
        const uint8_t* st = sb + (warp & 3) * S::WBOX;
        const uint8_t* sx = sb + 2 * (warp & 3) * DB_XBOX;
        uint4 wv[2][2 * MT], xv[4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 2 * MT; ++i)
                wv[h][i] = *reinterpret_cast<const uint4*>(st + woff[h] + 1024 * i);
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = *reinterpret_cast<const uint4*>(sx + xoff[q]);
        // product (mt, h, j): word j of weight read h (k 4j .. 4j + 3 of its
        // chunk) of rows 16·mt + g, + 8 against the same 4 k of x: read 2h + j / 2,
        // half j % 2
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const uint4& x4 = xv[2 * h + (j >> 1)];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    const uint32_t a0 = word_of(wv[h][2 * mt], j);
                    const uint32_t a1 = word_of(wv[h][2 * mt + 1], j);
                    const uint32_t a[4] = {s8_pair_bf16(__byte_perm(a0, 0, 0x4140)),
                                           s8_pair_bf16(__byte_perm(a1, 0, 0x4140)),
                                           s8_pair_bf16(__byte_perm(a0, 0, 0x4342)),
                                           s8_pair_bf16(__byte_perm(a1, 0, 0x4342))};
                    mma_bf16(acc[mt][h], a, (j & 1) ? x4.z : x4.x, (j & 1) ? x4.w : x4.y);
                }
            }
    }

    // the block's sum over its 8 warps, in warp order (x rows past R hold zeros)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            red[warp][2 * t + (e & 1)][16 * mt + g + 8 * (e >> 1)] = acc[mt][0][e] + acc[mt][1][e];
    __syncthreads();
    for (int i = tid; i < R * S::ROWS; i += DB_THREADS) {
        const int r = i / S::ROWS, m = i % S::ROWS;
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < DB_WARPS; ++w) v += red[w][r][m];
        out[(size_t)r * N + n0 + m] = v * scale;
    }
}

int q8_smem_done = 0;

// a byte [rows, cols] row-major tensor (cols % 16 == 0) as boxes of
// box_cols × box_rows, swizzled as asked, zeros past its edges. Returns a
// CUresult.
int encode_u8_map(CUtensorMap* map, const void* ptr, long long rows, int cols, int box_cols,
                  int box_rows, CUtensorMapSwizzle swizzle) {
    const sm90::EncodeTiledFn fn = sm90::encode_tiled();
    if (!fn) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides,
                   box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <bool FOLD, bool RAW, bool TMA>
int q4_probe_enqueue(const CUtensorMap& tc, const CUtensorMap& txe, const CUtensorMap& txo,
                     const void* xe, const void* xo, const float* xs, const uint8_t* codes,
                     const float* scales, float* out, int rt, int K2, int N, int gs2, int gpt,
                     cudaStream_t st) {
    static int smem_done = 0;
    const int nch = (K2 + QP_KC - 1) / QP_KC;
    const size_t smem = 1024 + (size_t)(nch < QP_STAGES ? nch : QP_STAGES) * QpStage<FOLD>::BYTES;
    const cudaError_t e = allow_smem(q4_probe_kernel<FOLD, RAW, TMA>, smem, smem_done);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((N + QP_COLS - 1) / QP_COLS, rt / QP_ROWS);
    q4_probe_kernel<FOLD, RAW, TMA><<<grid, QP_THREADS, smem, st>>>(
        tc, txe, txo, xe, xo, xs, codes, scales, out, K2, N, gs2, gpt);
    return (int)cudaGetLastError();
}

template <int MT>
int db_gemv_enqueue(const void* x, const void* w, float* out, int R, int K, int N, float scale,
                    cudaStream_t st) {
    using S = DbStage<MT>;
    static int smem_done = 0;
    CUtensorMap tw, tx;
    int err = sm90::encode_i8_map(&tw, w, N, K, S::ROWS);
    if (!err) err = sm90::encode_bf16_map(&tx, x, R, K, DB_MAX_ROWS);
    if (err) return err;
    // one block an SM where the grid is one wave, else two: the ring's stages
    const int most = (N / S::ROWS <= 132 ? DB_RING1 : DB_RING2) / S::BYTES;
    const int slots = K / DB_CHUNK < most ? K / DB_CHUNK : most;
    const size_t smem = 1024 + (size_t)slots * S::BYTES;
    const cudaError_t e = allow_smem(db_gemv_kernel<MT>, smem, smem_done);
    if (e != cudaSuccess) return (int)e;
    db_gemv_kernel<MT><<<N / S::ROWS, DB_THREADS, smem, st>>>(tw, tx, out, R, K, N, scale,
                                                                slots);
    return (int)cudaGetLastError();
}

}  // namespace

// xe, xo [rt, K2] int8 (fold 0) or bf16 (fold 1); xs [rt] f32; codes [K2, N]
// bytes; scales [K2 / gs2, N] f32; out [rt, N] f32. rt % 32 == 0, N % 4 ==
// 0, gs2 % 4 == 0, gs2 · gpt divides K2; raw 1 takes each byte whole (the
// "none" probe). Codes and x arrive by TMA where N and the rows of x are
// whole 16-byte units and the pointers 16-byte aligned, else by 4-byte
// cp.async copies. Returns the CUDA error of the launch (or of a tensor
// map's encoding).
extern "C" int q4_probe_launch(const void* xe, const void* xo, const void* xs, const void* codes,
                               const void* scales, void* out, int rt, int K2, int N, int gs2,
                               int gpt, int fold, int raw, void* stream) {
    if (rt < QP_ROWS || rt % QP_ROWS || N < 4 || N % 4 || K2 < 4 || gs2 < 4 || gs2 % 4 ||
        gpt < 1 || K2 % (gs2 * gpt))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* c = static_cast<const uint8_t*>(codes);
    const auto* s = static_cast<const float*>(scales);
    const auto* x_s = static_cast<const float*>(xs);
    auto* o = static_cast<float*>(out);
    const uintptr_t align = (uintptr_t)xe | (uintptr_t)xo | (uintptr_t)codes;
    const bool tma = N % 16 == 0 && (size_t)K2 * (fold ? 2 : 1) % 16 == 0 && align % 16 == 0;
    CUtensorMap tc = {}, txe = {}, txo = {};
    if (tma) {
        int err = sm90::encode_i8_map(&tc, codes, K2, N, QP_KC);
        if (!err) err = fold ? sm90::encode_bf16_map(&txe, xe, rt, K2, QP_ROWS)
                             : encode_u8_map(&txe, xe, rt, K2, 64, QP_ROWS,
                                             CU_TENSOR_MAP_SWIZZLE_64B);
        if (!err) err = fold ? sm90::encode_bf16_map(&txo, xo, rt, K2, QP_ROWS)
                             : encode_u8_map(&txo, xo, rt, K2, 64, QP_ROWS,
                                             CU_TENSOR_MAP_SWIZZLE_64B);
        if (err) return err;
    }
#define QP_LAUNCH(FOLD_, RAW_, TMA_)                                                          \
    if (!!fold == FOLD_ && !!raw == RAW_ && tma == TMA_)                                      \
        return q4_probe_enqueue<FOLD_, RAW_, TMA_>(tc, txe, txo, xe, xo, x_s, c, s, o, rt, K2, N, \
                                                   gs2, gpt, st);
    QP_LAUNCH(false, false, true)
    QP_LAUNCH(false, true, true)
    QP_LAUNCH(true, false, true)
    QP_LAUNCH(true, true, true)
    QP_LAUNCH(false, false, false)
    QP_LAUNCH(false, true, false)
    QP_LAUNCH(true, false, false)
    QP_LAUNCH(true, true, false)
#undef QP_LAUNCH
    return (int)cudaErrorInvalidValue;
}

// x [R, K] bf16 (R ≤ 16); codes [K, N] int8; scales [N] f32; out [R, N]
// f32. K % 512 == 0, N % 16 == 0, 16-byte aligned. Returns the CUDA error
// (or a tensor map's encoding error).
extern "C" int q8_gemv_launch(const void* x, const void* codes, const void* scales, void* out,
                              int R, int K, int N, void* stream) {
    if (R < 1 || R > Q8_MAX_ROWS || K < Q8_TILE || K % Q8_TILE || N < Q8_COLS || N % Q8_COLS)
        return (int)cudaErrorInvalidValue;
    CUtensorMap tc, tx;
    int err = encode_u8_map(&tc, codes, K, N, Q8_COLS, Q8_BOX_ROWS, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (!err) err = sm90::encode_bf16_map(&tx, x, R, K, Q8_MAX_ROWS);
    if (err) return err;
    const int slots = K / Q8_TILE < Q8_STAGES ? K / Q8_TILE : Q8_STAGES;
    const size_t smem =
        1024 + (size_t)slots * Q8_STAGE + sizeof(float) * Q8_WARPS * R * Q8_COLS;
    const cudaError_t e = allow_smem(q8_gemv_kernel, smem, q8_smem_done);
    if (e != cudaSuccess) return (int)e;
    q8_gemv_kernel<<<N / Q8_COLS, Q8_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        tc, tx, static_cast<const float*>(scales), static_cast<float*>(out), R, K, N);
    return (int)cudaGetLastError();
}

// x [R, K] bf16 (R ≤ 8); w [N, K] int8; out [R, N] f32 = (x · wᵀ) · scale.
// K % 512 == 0, N % 16 == 0, 16-byte aligned. A block owns 32 weight rows
// where that still leaves 128 blocks or more (N ≥ 4,096, N % 32 == 0),
// halving the x it reads for each weight byte; else 16. Returns the CUDA
// error (or a tensor map's encoding error).
extern "C" int db_gemv_launch(const void* x, const void* w, void* out, int R, int K, int N,
                              float scale, void* stream) {
    if (R < 1 || R > DB_MAX_ROWS || K < DB_CHUNK || K % DB_CHUNK || N < 16 || N % 16)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* o = static_cast<float*>(out);
    if (N % 32 == 0 && N / 32 >= 128) return db_gemv_enqueue<2>(x, w, o, R, K, N, scale, st);
    return db_gemv_enqueue<1>(x, w, o, R, K, N, scale, st);
}
