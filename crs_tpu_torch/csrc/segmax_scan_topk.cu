// Segment-max scans (approximate, one winner per 128-row segment), for
// Hopper (sm_90a): f32, bf16 and int8 corpora.
//
// Replaces two TPU kernels of crs_tpu/ops/pallas_scan.py:
//   F32 / BF16 (kernel 6): pallas_topk_segmax → _scan_kernel_segmax
//   I8 (kernel 7):         pallas_topk_segmax_int8 → _scan_kernel_segmax_int8
// For each query tile of QUERY_TILE queries and each corpus block of
// block_size rows:
//   F32 / BF16: s = q · v in f32 (the queries come cast to the corpus dtype;
//               a bf16 product is exact in f32)
//   I8:         s = (f32(acc) · q_scale) · row_scale, acc = q_codes · codes
//               in int32 (exact), each product rounded alone
//   s = -1e30 at every row ≥ valid_n (the value replaced, not a bias added)
//   per 128-row segment: its max and the lowest row reaching it
//   kseg times: the segment with the largest max (the lowest segment among
//   equal maxima); emit (its max, its argmax row); set its max to -1e30 and
//   keep its argmax row.
// Partials go to out_s / out_i laid out [nq, nblocks, kseg, QUERY_TILE]. As
// in the Pallas kernel, once fewer than kseg segments score above -1e30 the
// later picks land on the lowest segment at -1e30 and emit its row again.
//
// What bounds it on an H100 at the main path's shape (N = 1,048,576, D =
// 384, B = 328 queries): the work, 2·B·N·D = 2.64e11 operations, is 3.94 ms
// of f32 FMA on the CUDA cores at 67 TFLOP/s (TF32 would change the scores)
// and 0.267 ms of bf16 on the tensor cores at 989 TFLOP/s; the corpus, 1.5
// GiB / 768 MiB, is 0.48 / 0.24 ms at 3.35 TB/s. So f32 is bound by the
// FMA rate and bf16 by the tensor cores, with the corpus bytes close behind.
// (B is padded to 384, six tiles of 64: the kernels do 17 % more work.)
//
// One corpus pass per launch (both float modes). A CTA scores one corpus
// block against two query tiles (128 queries), and the grid is one
// dimension with the query pair varying fastest: the 3 CTAs that share a
// block are adjacent in launch order, start together and walk its rows in
// the same order, so the first to touch a slice pulls it into L2 and the
// others find it there microseconds later. That holds at any D up to 4096:
// what L2 must hold is the slices in flight between sibling CTAs (a few MB
// over the whole card), never a whole block or query tile. (The first port
// ran the corpus block fastest, so the 6 CTAs sharing a block ran ~512 CTAs
// apart and each read it from device memory.)
//
// F32 (kernel 6, f32): FFMA with an 8 × 8 register tile per thread. A CTA of
// 512 threads (16 warps, 8 queries each) walks its block CHUNK = 256 rows at
// a time; lane l holds rows 4l..4l+3 of each of the chunk's two 128-row
// segments, so its part of a segment max is over 4 contiguous rows. Rows
// and queries come in KC = 32-dimension slices, transposed on the way in
// by 4-byte cp.async into [dim][row] and [dim][query] (a warp's 32 copies
// read 4 rows × 32 bytes and hit 32 distinct banks: the strides are ≡ 4
// mod 32 floats). Per dimension a lane then reads its 8 rows with two
// conflict-free LDS.128 and its warp's 8 queries with two broadcasts, for 64
// FFMA; the operands cost 16 registers, so the thread fits in 128 (the
// count two CTAs of 256 threads would need; one CTA of 512 threads keeps
// the same 16 warps per SM and feeds each staged row to 128 queries, not
// 64). Two stages: slice t+1's copies go out in two pieces between slice
// t's FMAs. Measured alternatives, all slower at this shape: TMA into a
// swizzled [row][dim] layout (its operands need 32 more registers and
// spill), 8 × 256 or 32 × 64 warp tiles at 256 threads, 3–4 stages.
//
// BF16 (kernel 6, bf16): wgmma on a TMA-fed ring. A CTA of 288 threads has
// two consumer warpgroups of 64 queries each and one producer warp. The
// queries are the A operand (M = 64 per warpgroup), the corpus rows the B
// operand (N = 256, one chunk), both K-major in shared memory with 128-byte
// swizzle, fed by TMA (cp.async.bulk.tensor.2d) in 64-dimension slices:
// wgmma.mma_async m64n256k16 four times a slice. When the 128 queries fit
// whole beside a 3-stage ring of corpus slices (D ≤ 416 at block 2048, e.g.
// D = 384) they are loaded once per CTA and only the corpus streams;
// otherwise both operands stream through a 4-stage ring. Full / empty
// mbarriers guard each stage; the producer waits for a stage to drain
// before refilling it. TMA zero-fills past D (a ragged last slice, D =
// 32·odd) and past the last query tile (an odd number of tiles). The
// segment maxima come straight from the accumulators: a thread holds, for
// each of its 2 query rows, columns 8j + 2t + {0,1} (t = lane % 4), so a
// 128-row segment is a thread-local (max, lowest row) over 32 values and
// two shfl_xor steps across the quad. No score tile passes through shared
// memory; each segment's (max, row) goes to a small [segment][query] array
// for the picks. The tensor maps are encoded on the host per launch
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPointByVersion
// so the library needs no -lcuda) and passed as __grid_constant__
// parameters.
//
// I8 (kernel 7): unchanged from its first port. One CUDA block per (corpus
// block, query tile of 64), 256 threads; lane l holds rows l, l+32, ...,
// l+224 of a 256-row chunk; the query tile's codes stay in shared memory
// and __dp4a scores 16 words of each row per stage; lane s of a warp keeps
// segment s's winner, the picks are warp arg-max reductions.

#include <cuda.h>  // CUtensorMap and the encode function's types; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 256;       // corpus rows per step (two segments)
constexpr int SEGMENT = 128;     // rows per segment
constexpr int QUERY_TILE = 64;   // queries per tile of the partials
constexpr int MAX_SEGMENTS = 32;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory one CTA may use

// ---- shared pieces ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// (value, row) ← the better of itself and (ov, orow): the larger value, the
// lower row among equal values.
__device__ __forceinline__ void take_better(float& v, int& row, float ov, int orow) {
    if (ov > v || (ov == v && orow < row)) {
        v = ov;
        row = orow;
    }
}

// One query's kseg picks over its nseg segment winners, kept in shared
// memory [segment][stride] (column q): the largest max, the lowest segment
// among equal maxima; the picked max is set to -1e30 and its row kept.
__device__ __forceinline__ void emit_picks(float* smax, const int* srow, int stride, int q,
                                           int nseg, int kseg, float* __restrict__ out_s,
                                           int* __restrict__ out_i, long long o) {
    for (int p = 0; p < kseg; ++p) {
        float best = smax[q];
        int bs = 0;
        for (int s = 1; s < nseg; ++s) {
            const float m = smax[s * stride + q];
            if (m > best) {
                best = m;
                bs = s;
            }
        }
        out_s[o + (long long)p * QUERY_TILE] = best;
        out_i[o + (long long)p * QUERY_TILE] = srow[bs * stride + q];
        smax[bs * stride + q] = NEG_INF;
    }
}

// ---- F32: FFMA, 8 queries × 8 rows per thread ----------------------------------

constexpr int F_THREADS = 512;                        // 16 warps, 8 queries each
constexpr int F_TILE_Q = 128;                         // queries per CTA (two tiles)
constexpr int F_KC = 32;                              // dimensions per slice
constexpr int F_ROW_STRIDE = CHUNK + 4;               // floats per staged dimension (rows)
constexpr int F_Q_STRIDE = F_TILE_Q + 4;              // floats per staged dimension (queries)
constexpr int F_STAGE_FLOATS = F_KC * (F_ROW_STRIDE + F_Q_STRIDE);
constexpr int F_STAGES = 2;
constexpr int F_PARTS = 2;                            // pieces of the next slice's copies
constexpr int F_RPR = F_THREADS / 32;                 // rows per copy round
constexpr int F_ROW_ROUNDS = CHUNK / F_RPR;           // 16
constexpr int F_Q_ROUNDS = F_TILE_Q / F_RPR;          // 8

size_t f32_smem_bytes(int block_size) {
    return (size_t)F_STAGES * F_STAGE_FLOATS * 4 +
           (size_t)(block_size / SEGMENT) * F_TILE_Q * 8;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(F_THREADS, 1)
segmax_f32_kernel(const float* __restrict__ q,      // [nq·QUERY_TILE, d]
                  const float* __restrict__ vecs,   // [nblocks·block_size, d]
                  float* __restrict__ out_s,        // [nq, nblocks, kseg, QUERY_TILE]
                  int* __restrict__ out_i, int nq, int nblocks, int block_size, int d,
                  int kseg, int valid_n) {
    extern __shared__ __align__(16) float fsmem[];  // [F_STAGES][dim][rows, then queries]
    const int nseg = block_size / SEGMENT;
    float* smax = fsmem + F_STAGES * F_STAGE_FLOATS;  // [nseg][128]
    int* srow = reinterpret_cast<int*>(smax + nseg * F_TILE_Q);
    const int npairs = (nq + 1) / 2;
    const int pair = blockIdx.x % npairs;
    const int blk = blockIdx.x / npairs;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nk = d / F_KC;
    const int nslices = (block_size / CHUNK) * nk;
    const float* vb = vecs + (long long)blk * block_size * d;

    // Copy i of this thread moves element (row crow + 16i, dimension cdim) of
    // the slice: a warp reads 4 rows × 32 bytes (whole sectors) and writes
    // them dimension-major, [dim][row]; with a stride ≡ 4 (mod 32) floats its
    // 32 stores land in 32 distinct banks.
    const int cdim = 8 * (warp & 3) + (lane & 7);
    const int crow = 4 * (warp >> 2) + (lane >> 3);
    const float* qsrc = q + ((long long)pair * F_TILE_Q + crow) * d + cdim;
    // with an odd tile count the last pair has one tile: its second half
    // re-reads the first (never emitted)
    const int qvalid = (int)min((long long)F_TILE_Q,
                                (long long)nq * QUERY_TILE - (long long)pair * F_TILE_Q);
    auto copy_part = [&](int t, int part) {  // slice t → stage t % 2, piece `part`
        if (t < nslices) {
            float* st = fsmem + (t % F_STAGES) * F_STAGE_FLOATS;
            const int k0 = (t % nk) * F_KC;
            const float* rows = vb + ((long long)(t / nk) * CHUNK + crow) * d + k0 + cdim;
#pragma unroll
            for (int i = part * (F_ROW_ROUNDS / F_PARTS);
                 i < (part + 1) * (F_ROW_ROUNDS / F_PARTS); ++i)
                cp_async4(st + cdim * F_ROW_STRIDE + crow + F_RPR * i,
                          rows + (long long)(F_RPR * i) * d);
            float* sq = st + F_KC * F_ROW_STRIDE;
#pragma unroll
            for (int i = part * (F_Q_ROUNDS / F_PARTS); i < (part + 1) * (F_Q_ROUNDS / F_PARTS);
                 ++i) {
                const int r = crow + F_RPR * i;
                cp_async4(sq + cdim * F_Q_STRIDE + r,
                          qsrc + (long long)(r < qvalid ? F_RPR * i : F_RPR * i - QUERY_TILE) * d +
                              k0);
            }
        }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
    for (int part = 0; part < F_PARTS; ++part) copy_part(0, part);
    cp_async_commit();
    for (int t = 0; t < nslices; ++t) {
        cp_async_wait<0>();
        __syncthreads();  // slice t has landed, and every warp is done with slice t - 1
        // per dimension: this lane's rows 4l..4l+3 and 128+4l..128+4l+3 (two
        // conflict-free LDS.128) and the warp's queries 8w..8w+7 (two
        // broadcasts); slice t + 1's copies go out in F_PARTS pieces between
        const float* rs = fsmem + (t % F_STAGES) * F_STAGE_FLOATS + 4 * lane;
        const float* qs = fsmem + (t % F_STAGES) * F_STAGE_FLOATS + F_KC * F_ROW_STRIDE + 8 * warp;
#pragma unroll
        for (int part = 0; part < F_PARTS; ++part) {
            copy_part(t + 1, part);
#pragma unroll
            for (int k = part * (F_KC / F_PARTS); k < (part + 1) * (F_KC / F_PARTS); ++k) {
                const float4 b0 = *reinterpret_cast<const float4*>(rs + k * F_ROW_STRIDE);
                const float4 b1 =
                    *reinterpret_cast<const float4*>(rs + k * F_ROW_STRIDE + SEGMENT);
                const float4 a0 = *reinterpret_cast<const float4*>(qs + k * F_Q_STRIDE);
                const float4 a1 = *reinterpret_cast<const float4*>(qs + k * F_Q_STRIDE + 4);
                const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
                const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            }
        }
        cp_async_commit();
        if (t % nk != nk - 1) continue;

        // the chunk is scored: its two segments' (max, lowest row) per query
        const int c = t / nk;
        const long long grow0 = (long long)blk * block_size + (long long)c * CHUNK;
        const long long lim = (long long)valid_n - grow0;  // rows of the chunk below valid_n
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                float best = NEG_INF;
                int brow = 0;
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                    const int row = SEGMENT * h + 4 * lane + jj;
                    const float v = row < lim ? acc[i][4 * h + jj] : NEG_INF;
                    if (jj == 0 || v > best) {  // rows ascend: strict > keeps the lowest
                        best = v;
                        brow = row;
                    }
                }
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    take_better(best, brow, __shfl_xor_sync(FULL, best, off),
                                __shfl_xor_sync(FULL, brow, off));
                if (lane == i) {
                    const int s = (c * 2 + h) * F_TILE_Q + warp * 8 + i;
                    smax[s] = best;
                    srow[s] = (int)grow0 + brow;
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
    __syncthreads();
    if (tid < F_TILE_Q) {
        const int tile = pair * 2 + tid / QUERY_TILE;
        if (tile < nq)
            emit_picks(smax, srow, F_TILE_Q, tid, nseg, kseg, out_s, out_i,
                       ((long long)tile * nblocks + blk) * kseg * QUERY_TILE + tid % QUERY_TILE);
    }
}

// ---- BF16: wgmma m64n256k16 on a TMA-fed ring ----------------------------------

constexpr int B_CONSUMERS = 2;                         // warpgroups, 64 queries each
constexpr int B_THREADS = B_CONSUMERS * 128 + 32;      // + one producer warp
constexpr int B_TILE_Q = B_CONSUMERS * 64;             // queries per CTA (two tiles)
constexpr int B_BK = 64;                               // dimensions per slice (128 bytes)
constexpr int B_A_BYTES = B_TILE_Q * B_BK * 2;         // 16 KB: the queries' slice
constexpr int B_B_BYTES = CHUNK * B_BK * 2;            // 32 KB: the chunk's slice
constexpr int B_STAGES_RESIDENT = 3;                   // corpus-only stages
constexpr int B_STAGES_STREAM = 4;                     // queries + corpus stages

// Offsets from the 1024-byte-aligned base of the dynamic shared memory.
struct Bf16Layout {
    int stages, a_bytes, stage_bytes, ring, seg_max, seg_row, bars, total;
};

__host__ __device__ inline Bf16Layout bf16_layout(int d, int block_size, bool resident) {
    Bf16Layout L;
    const int nk = (d + B_BK - 1) / B_BK;
    L.stages = resident ? B_STAGES_RESIDENT : B_STAGES_STREAM;
    L.a_bytes = resident ? nk * B_A_BYTES : 0;
    L.stage_bytes = resident ? B_B_BYTES : B_A_BYTES + B_B_BYTES;
    L.ring = L.a_bytes;
    L.seg_max = L.ring + L.stages * L.stage_bytes;
    L.seg_row = L.seg_max + (block_size / SEGMENT) * B_TILE_Q * 4;
    L.bars = L.seg_row + (block_size / SEGMENT) * B_TILE_Q * 4;
    L.total = L.bars + (2 * L.stages + 1) * 8;
    return L;
}

size_t bf16_smem_bytes(int d, int block_size, bool resident) {
    return 1024 + (size_t)bf16_layout(d, block_size, resident).total;  // + the alignment slack
}

bool bf16_resident(int d, int block_size) {
    return bf16_smem_bytes(d, block_size, true) <= (size_t)SMEM_LIMIT;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait that lasts 2^32
// clocks (about 2 s) means the pipeline is broken: trap, so the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    long long t0 = 0;
    for (;;) {
        uint32_t done;
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
        if (done) return;
        if (t0 == 0) {
            t0 = clock64();
        } else if (clock64() - t0 > (1LL << 32)) {
            __trap();
        }
    }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
        : "memory");
}

// K-major operand, 128-byte swizzle: rows of 128 bytes, 8-row groups 1024
// bytes apart (SBO), LBO unused; +2 in the address field steps 32 bytes (16
// bf16) along K inside the swizzle atom.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
           ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator accesses across the async region
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 × 256] (+)= A[64 × 16] · B[256 × 16]ᵀ, both K-major in shared memory;
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127},"
        " %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
}

// A thread's (max, lowest column) over the 32 columns of one query row (r)
// and one segment (h) of the accumulator: d[4j + 2r + e] is column
// 8j + 2t + e of query row r; columns at or past `lim` score -1e30.
template <int H, int R, bool MASK>
__device__ __forceinline__ void acc_segment_best(const float (&d)[128], int t, int lim,
                                                 float& best, int& bcol) {
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int j = 16 * H + jj;
            const int col = 8 * j + 2 * t + e;
            float v = d[4 * j + 2 * R + e];
            if (MASK && col >= lim) v = NEG_INF;
            if ((jj == 0 && e == 0) || v > best) {  // columns ascend: strict > keeps the lowest
                best = v;
                bcol = col;
            }
        }
    }
    take_better(best, bcol, __shfl_xor_sync(FULL, best, 1), __shfl_xor_sync(FULL, bcol, 1));
    take_better(best, bcol, __shfl_xor_sync(FULL, best, 2), __shfl_xor_sync(FULL, bcol, 2));
}

template <bool MASK>
__device__ __forceinline__ void acc_segments(const float (&d)[128], int t, int lim,
                                             float (&bm)[2][2], int (&bc)[2][2]) {
    acc_segment_best<0, 0, MASK>(d, t, lim, bm[0][0], bc[0][0]);
    acc_segment_best<0, 1, MASK>(d, t, lim, bm[0][1], bc[0][1]);
    acc_segment_best<1, 0, MASK>(d, t, lim, bm[1][0], bc[1][0]);
    acc_segment_best<1, 1, MASK>(d, t, lim, bm[1][1], bc[1][1]);
}

template <bool RESIDENT>
__global__ void __launch_bounds__(B_THREADS, 1)
segmax_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,  // [nq·64, d] bf16, box 64 × 128
                   const __grid_constant__ CUtensorMap tm_v,  // [N, d] bf16, box 64 × 256
                   float* __restrict__ out_s, int* __restrict__ out_i, int nq, int nblocks,
                   int block_size, int d, int kseg, int valid_n) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
    const Bf16Layout L = bf16_layout(d, block_size, RESIDENT);
    const uint32_t base = smem_u32(smem);
    float* smax = reinterpret_cast<float*>(smem + L.seg_max);  // [nseg][128]
    int* srow = reinterpret_cast<int*>(smem + L.seg_row);
    const uint32_t full0 = base + L.bars;            // full[s] = full0 + 8s
    const uint32_t empty0 = full0 + 8 * L.stages;    // empty[s]
    const uint32_t qbar = empty0 + 8 * L.stages;     // the resident queries
    const int npairs = (nq + 1) / 2;
    const int pair = blockIdx.x % npairs;
    const int blk = blockIdx.x / npairs;
    const int nk = (d + B_BK - 1) / B_BK;
    const int nchunks = block_size / CHUNK;
    const int nseg = block_size / SEGMENT;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;

    if (tid == 0) {
        for (int s = 0; s < L.stages; ++s) {
            mbar_init(full0 + 8 * s, 1);                // the producer's arrive + the bytes
            mbar_init(empty0 + 8 * s, B_CONSUMERS);     // one arrive per consumer warpgroup
        }
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == B_CONSUMERS * 4) {  // the producer warp: one thread starts every copy
        if (lane == 0) {
            const int qrow = pair * B_TILE_Q;
            if (RESIDENT) {
                mbar_expect_tx(qbar, (uint32_t)(nk * B_A_BYTES));
                for (int ks = 0; ks < nk; ++ks)
                    tma_load_2d(base + ks * B_A_BYTES, &tm_q, ks * B_BK, qrow, qbar);
            }
            int stage = 0;
            uint32_t phase = 0;
            for (int c = 0; c < nchunks; ++c) {
                const int row0 = blk * block_size + c * CHUNK;
                for (int ks = 0; ks < nk; ++ks) {
                    mbar_wait(empty0 + 8 * stage, phase ^ 1);
                    const uint32_t st = base + L.ring + stage * L.stage_bytes;
                    const uint32_t fb = full0 + 8 * stage;
                    mbar_expect_tx(fb, (uint32_t)L.stage_bytes);
                    if (!RESIDENT) tma_load_2d(st, &tm_q, ks * B_BK, qrow, fb);
                    tma_load_2d(st + (RESIDENT ? 0 : B_A_BYTES), &tm_v, ks * B_BK, row0, fb);
                    if (++stage == L.stages) {
                        stage = 0;
                        phase ^= 1;
                    }
                }
            }
        }
        return;
    }

    // consumer warpgroup wg: queries 64·wg .. 64·wg + 63 of the CTA's 128
    const int wg = warp >> 2;
    const int t = lane & 3;
    const int qa = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // rows qa and qa + 8
    const bool lead = (tid & 127) == 0;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    if (RESIDENT) {
        mbar_wait(qbar, 0);
        __syncwarp();
    }
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int c = 0; c < nchunks; ++c) {
        fence_acc(acc);
        for (int ks = 0; ks < nk; ++ks) {
            mbar_wait(full0 + 8 * stage, phase);
            __syncwarp();
            const uint32_t st = base + L.ring + stage * L.stage_bytes;
            const uint32_t a = (RESIDENT ? base + ks * B_A_BYTES : st) + wg * (B_A_BYTES / 2);
            const uint32_t b = st + (RESIDENT ? 0 : B_A_BYTES);
            const uint64_t da = sw128_desc(a), db = sw128_desc(b);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < B_BK / 16; ++kk)
                wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk, (ks | kk) != 0);
            wgmma_commit();
            if (ks > 0) {  // the previous slice's products are done: free its stage
                wgmma_wait<1>();
                if (lead) mbar_arrive(empty0 + 8 * prev);
            }
            prev = stage;
            if (++stage == L.stages) {
                stage = 0;
                phase ^= 1;
            }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (lead) mbar_arrive(empty0 + 8 * prev);

        // the chunk's two segments, straight from the accumulators
        const long long grow0 = (long long)blk * block_size + (long long)c * CHUNK;
        const long long lim_ll = (long long)valid_n - grow0;
        float bm[2][2];
        int bc[2][2];
        if (lim_ll >= CHUNK) {
            acc_segments<false>(acc, t, CHUNK, bm, bc);
        } else {
            acc_segments<true>(acc, t, lim_ll < 0 ? 0 : (int)lim_ll, bm, bc);
        }
        // thread t of the quad stores (segment h = t & 1, query row r = t >> 1)
        const int h = t & 1, r = t >> 1;
        const float v = r ? (h ? bm[1][1] : bm[0][1]) : (h ? bm[1][0] : bm[0][0]);
        const int col = r ? (h ? bc[1][1] : bc[0][1]) : (h ? bc[1][0] : bc[0][0]);
        const int s = (c * 2 + h) * B_TILE_Q + qa + 8 * r;
        smax[s] = v;
        srow[s] = (int)grow0 + col;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(B_CONSUMERS * 128) : "memory");
    if (tid < B_TILE_Q) {
        const int tile = pair * 2 + tid / QUERY_TILE;
        if (tile < nq)
            emit_picks(smax, srow, B_TILE_Q, tid, nseg, kseg, out_s, out_i,
                       ((long long)tile * nblocks + blk) * kseg * QUERY_TILE + tid % QUERY_TILE);
    }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// A bf16 [rows, d] row-major tensor seen as boxes of 64 dimensions × box_rows
// rows, 128-byte swizzled, zero-filled past its edges. Returns a CUresult.
int encode_bf16_map(CUtensorMap* map, const void* ptr, long long rows, int d, int box_rows) {
    const EncodeTiledFn fn = encode_tiled();
    if (!fn) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
    const cuuint32_t box[2] = {(cuuint32_t)B_BK, (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                   box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// ---- I8: __dp4a, the first port's design (kernel 7) ----------------------------

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int Q_PER_WARP = QUERY_TILE / WARPS;  // 8
constexpr int ROWS_PER_LANE = CHUNK / 32;       // 8
constexpr int SEG_LANES = SEGMENT / 32;         // 4 values per lane per segment
constexpr int KCHUNK_WORDS = 16;                // int8: 64 bytes of each row per stage

size_t i8_smem_bytes(int d) {
    return (size_t)d * QUERY_TILE + (size_t)KCHUNK_WORDS * CHUNK * 4;
}

// int32 dots by __dp4a over the query tile's words [word][query] (in shared
// memory for the whole block) and the chunk's words staged [word][row]
// KCHUNK_WORDS at a time; then the two rounded products.
__device__ __forceinline__ void score_i8(float (&s)[Q_PER_WARP][ROWS_PER_LANE],
                                         const int* qw, const int8_t* rows,
                                         const float* q_scale, const float* row_scale, int d,
                                         int* cs, int tid, int lane, int warp) {
    const int dw = d / 4;
    int acc[Q_PER_WARP][ROWS_PER_LANE];
#pragma unroll
    for (int i = 0; i < Q_PER_WARP; ++i)
#pragma unroll
        for (int j = 0; j < ROWS_PER_LANE; ++j) acc[i][j] = 0;
    for (int kc = 0; kc < dw; kc += KCHUNK_WORDS) {
        const int nw = min(KCHUNK_WORDS, dw - kc);  // a multiple of 4 (d % 16 == 0)
        const int nseg = nw / 4;
        __syncthreads();
        for (int idx = tid; idx < CHUNK * nseg; idx += THREADS) {
            const int r = idx / nseg, sg = idx % nseg;
            const int4 v =
                *reinterpret_cast<const int4*>(rows + (long long)r * d + kc * 4 + sg * 16);
            cs[(sg * 4 + 0) * CHUNK + r] = v.x;
            cs[(sg * 4 + 1) * CHUNK + r] = v.y;
            cs[(sg * 4 + 2) * CHUNK + r] = v.z;
            cs[(sg * 4 + 3) * CHUNK + r] = v.w;
        }
        __syncthreads();
        for (int w = 0; w < nw; ++w) {
            int qv[Q_PER_WARP], cv[ROWS_PER_LANE];
#pragma unroll
            for (int i = 0; i < Q_PER_WARP; ++i)
                qv[i] = qw[(kc + w) * QUERY_TILE + warp * Q_PER_WARP + i];
#pragma unroll
            for (int j = 0; j < ROWS_PER_LANE; ++j) cv[j] = cs[w * CHUNK + lane + 32 * j];
#pragma unroll
            for (int i = 0; i < Q_PER_WARP; ++i)
#pragma unroll
                for (int j = 0; j < ROWS_PER_LANE; ++j) acc[i][j] = __dp4a(qv[i], cv[j], acc[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < ROWS_PER_LANE; ++j) {
        const float vs = row_scale[lane + 32 * j];
#pragma unroll
        for (int i = 0; i < Q_PER_WARP; ++i)
            s[i][j] = __fmul_rn(__fmul_rn((float)acc[i][j], q_scale[warp * Q_PER_WARP + i]), vs);
    }
}

__global__ void __launch_bounds__(THREADS)
segmax_i8_kernel(const int8_t* __restrict__ q_,         // [nq·QUERY_TILE, d]
                 const int8_t* __restrict__ vecs_,      // [nblocks·block_size, d]
                 const float* __restrict__ q_scale,     // [nq·QUERY_TILE]
                 const float* __restrict__ row_scale,   // [nblocks·block_size]
                 float* __restrict__ out_s,             // [nq, nblocks, kseg, QUERY_TILE]
                 int* __restrict__ out_i,
                 int nblocks, int block_size, int d, int kseg, int valid_n) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int blk = blockIdx.x;
    const int iq = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long q_off = (long long)iq * QUERY_TILE * d;

    int* qw = reinterpret_cast<int*>(smem);          // [d/4][QUERY_TILE] words
    int* cs_i8 = qw + (d / 4) * QUERY_TILE;          // [KCHUNK_WORDS][CHUNK] words
    {  // the query tile's codes → shared memory, 16 bytes per load
        const int segs = d / 16;
        const int4* src = reinterpret_cast<const int4*>(q_ + q_off);
        for (int idx = tid; idx < QUERY_TILE * segs; idx += THREADS) {
            const int qq = idx / segs, sg = idx % segs;
            const int4 v = src[(long long)qq * segs + sg];
            qw[(sg * 4 + 0) * QUERY_TILE + qq] = v.x;
            qw[(sg * 4 + 1) * QUERY_TILE + qq] = v.y;
            qw[(sg * 4 + 2) * QUERY_TILE + qq] = v.z;
            qw[(sg * 4 + 3) * QUERY_TILE + qq] = v.w;
        }
    }

    // lane s: segment s's (max, argmax row) for each of the warp's queries;
    // lanes past the block's segments stay at -inf and are never picked
    float seg_max[Q_PER_WARP];
    int seg_arg[Q_PER_WARP];
#pragma unroll
    for (int i = 0; i < Q_PER_WARP; ++i) {
        seg_max[i] = -INFINITY;
        seg_arg[i] = 0;
    }

    for (int c0 = 0; c0 < block_size; c0 += CHUNK) {
        const long long row0 = (long long)blk * block_size + c0;
        float s[Q_PER_WARP][ROWS_PER_LANE];
        score_i8(s, qw, vecs_ + row0 * d, q_scale + (long long)iq * QUERY_TILE, row_scale + row0,
                 d, cs_i8, tid, lane, warp);
#pragma unroll
        for (int j = 0; j < ROWS_PER_LANE; ++j) {
            if (row0 + lane + 32 * j >= valid_n) {
#pragma unroll
                for (int i = 0; i < Q_PER_WARP; ++i) s[i][j] = NEG_INF;
            }
        }
#pragma unroll
        for (int h = 0; h < CHUNK / SEGMENT; ++h) {
            const int seg = c0 / SEGMENT + h;
#pragma unroll
            for (int i = 0; i < Q_PER_WARP; ++i) {
                // lane-local (max, lowest row): rows ascend with j, strict > keeps the lowest
                float best = s[i][SEG_LANES * h];
                int brow = (int)row0 + lane + 32 * SEG_LANES * h;
#pragma unroll
                for (int jj = 1; jj < SEG_LANES; ++jj) {
                    const int j = SEG_LANES * h + jj;
                    if (s[i][j] > best) {
                        best = s[i][j];
                        brow = (int)row0 + lane + 32 * j;
                    }
                }
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    take_better(best, brow, __shfl_xor_sync(FULL, best, off),
                                __shfl_xor_sync(FULL, brow, off));
                if (lane == seg) {
                    seg_max[i] = best;
                    seg_arg[i] = brow;
                }
            }
        }
    }

    // kseg picks per query: (largest max, lowest segment), emit, mask to -1e30
#pragma unroll
    for (int i = 0; i < Q_PER_WARP; ++i) {
        const int qq = warp * Q_PER_WARP + i;
        for (int p = 0; p < kseg; ++p) {
            float best = seg_max[i];
            int bl = lane;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                take_better(best, bl, __shfl_xor_sync(FULL, best, off),
                            __shfl_xor_sync(FULL, bl, off));
            const int arg = __shfl_sync(FULL, seg_arg[i], bl);
            if (lane == 0) {
                const long long o = (((long long)iq * nblocks + blk) * kseg + p) * QUERY_TILE + qq;
                out_s[o] = best;
                out_i[o] = arg;
            }
            if (lane == bl) seg_max[i] = NEG_INF;
        }
    }
}

// ---- launchers ------------------------------------------------------------------

// A refused launch's error, cleared from the runtime's last error so that
// the next launch on this thread (ours or PyTorch's) does not report it.
int refused(cudaError_t err) {
    cudaGetLastError();
    return (int)err;
}

int launch_f32(const void* q, const void* vecs, void* out_s, void* out_i, int nq, int nblocks,
               int block_size, int d, int kseg, int valid_n, cudaStream_t stream) {
    const size_t smem = f32_smem_bytes(block_size);
    cudaError_t err = cudaFuncSetAttribute(segmax_f32_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return refused(err);
    segmax_f32_kernel<<<(unsigned)((nq + 1) / 2) * (unsigned)nblocks, F_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(vecs), static_cast<float*>(out_s),
        static_cast<int*>(out_i), nq, nblocks, block_size, d, kseg, valid_n);
    return (int)cudaGetLastError();
}

template <bool RESIDENT>
int launch_bf16_as(const CUtensorMap& tq, const CUtensorMap& tv, void* out_s, void* out_i,
                   int nq, int nblocks, int block_size, int d, int kseg, int valid_n,
                   cudaStream_t stream) {
    const size_t smem = bf16_smem_bytes(d, block_size, RESIDENT);
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(segmax_bf16_kernel<RESIDENT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return refused(err);
    const unsigned grid = (unsigned)((nq + 1) / 2) * (unsigned)nblocks;
    segmax_bf16_kernel<RESIDENT><<<grid, B_THREADS, smem, stream>>>(
        tq, tv, static_cast<float*>(out_s), static_cast<int*>(out_i), nq, nblocks, block_size, d,
        kseg, valid_n);
    return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* vecs, void* out_s, void* out_i, int nq, int nblocks,
                int block_size, int d, int kseg, int valid_n, cudaStream_t stream) {
    CUtensorMap tq, tv;
    int err = encode_bf16_map(&tq, q, (long long)nq * QUERY_TILE, d, B_TILE_Q);
    if (err) return err;
    err = encode_bf16_map(&tv, vecs, (long long)nblocks * block_size, d, CHUNK);
    if (err) return err;
    if (bf16_resident(d, block_size))
        return launch_bf16_as<true>(tq, tv, out_s, out_i, nq, nblocks, block_size, d, kseg,
                                    valid_n, stream);
    return launch_bf16_as<false>(tq, tv, out_s, out_i, nq, nblocks, block_size, d, kseg, valid_n,
                                 stream);
}

int launch_i8(const void* q, const void* vecs, const void* q_scale, const void* row_scale,
              void* out_s, void* out_i, int nq, int nblocks, int block_size, int d, int kseg,
              int valid_n, cudaStream_t stream) {
    const size_t smem = i8_smem_bytes(d);
    cudaError_t err = cudaFuncSetAttribute(segmax_i8_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return refused(err);
    const dim3 grid((unsigned)nblocks, (unsigned)nq);
    segmax_i8_kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(vecs),
        static_cast<const float*>(q_scale), static_cast<const float*>(row_scale),
        static_cast<float*>(out_s), static_cast<int*>(out_i), nblocks, block_size, d, kseg,
        valid_n);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int segmax_scan_topk_chunk_rows() { return CHUNK; }
int segmax_scan_topk_query_tile() { return QUERY_TILE; }
int segmax_scan_topk_segment_rows() { return SEGMENT; }
int segmax_scan_topk_max_segments() { return MAX_SEGMENTS; }

// Dynamic shared memory of one CTA (mode 0 f32, 1 bf16, 2 int8) at (d,
// block_size), and whether the bf16 kernel keeps its queries resident.
int segmax_scan_topk_smem_bytes(int mode, int d, int block_size) {
    if (mode == 0) return (int)f32_smem_bytes(block_size);
    if (mode == 1) return (int)bf16_smem_bytes(d, block_size, bf16_resident(d, block_size));
    return (int)i8_smem_bytes(d);
}
int segmax_scan_topk_bf16_queries_resident(int d, int block_size) {
    return bf16_resident(d, block_size) ? 1 : 0;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success),
// or for bf16 the CUresult of a failed tensor-map encode. The caller checks
// shapes: query rows = nq·QUERY_TILE, corpus rows = nblocks·block_size,
// block_size a multiple of CHUNK and at most MAX_SEGMENTS·SEGMENT, 1 <=
// kseg <= block_size / SEGMENT, d % 32 == 0 (f32 / bf16) or d % 16 == 0
// (int8), d <= 4096, 16-byte aligned pointers. The scale pointers are read
// by the int8 kernel only.
int segmax_scan_topk_f32_launch(const void* q, const void* vecs, const void* q_scale,
                                const void* row_scale, void* out_s, void* out_i, int nq,
                                int nblocks, int block_size, int d, int kseg, int valid_n,
                                void* stream) {
    return launch_f32(q, vecs, out_s, out_i, nq, nblocks, block_size, d, kseg, valid_n,
                      (cudaStream_t)stream);
}

int segmax_scan_topk_bf16_launch(const void* q, const void* vecs, const void* q_scale,
                                 const void* row_scale, void* out_s, void* out_i, int nq,
                                 int nblocks, int block_size, int d, int kseg, int valid_n,
                                 void* stream) {
    return launch_bf16(q, vecs, out_s, out_i, nq, nblocks, block_size, d, kseg, valid_n,
                       (cudaStream_t)stream);
}

int segmax_scan_topk_int8_launch(const void* q, const void* vecs, const void* q_scale,
                                 const void* row_scale, void* out_s, void* out_i, int nq,
                                 int nblocks, int block_size, int d, int kseg, int valid_n,
                                 void* stream) {
    return launch_i8(q, vecs, q_scale, row_scale, out_s, out_i, nq, nblocks, block_size, d, kseg,
                     valid_n, (cudaStream_t)stream);
}

}  // extern "C"
