// The per-block top-kb of the scan kernels, kept in a warp's registers.
//
// crs_tpu's Pallas kernels (_extract_block_topk, crs_tpu/ops/pallas_scan.py)
// take, for each query and each corpus block, kb passes of: the maximum, the
// lowest global row id among the entries equal to it, and that entry set to
// -1e30 (it stays a candidate, so a block that runs out of allowed rows
// re-emits its lowest id at -1e30). A CUDA block here walks its corpus block
// CHUNK rows at a time, so it keeps a running list instead: lane p < kb of
// the warp that owns a query holds the list's entry p. merge_chunk folds the
// next CHUNK rows into the list with kb arg-max passes over (chunk ∪ list);
// merge_chunk_rows does the same for any layout of the rows over the lanes.
// Because every list id is lower than every id of a later chunk, and an
// extracted list entry stays in the pass at -1e30 under its id, the list
// after the last chunk is exactly the Pallas kernel's kb emissions for the
// whole block, in order, ties and re-emissions included.
//
// merge_row is the same fold for the tensor-core scans (kernels 1 and 2),
// straight from a wgmma accumulator: a quad of threads holds a query row's
// 256 chunk scores and the list lives in shared memory.

#pragma once

#include <cuda_runtime.h>

namespace block_topk {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// s[j] holds the score of row row_of(j) of this chunk (RPL·32 rows over the
// warp); a lane's rows ascend with j. have_list: the lanes < kb hold a
// running list (false for the first chunk). On return lanes < kb hold the
// new list in (ls, li).
template <int RPL, typename RowOf>
__device__ __forceinline__ void merge_chunk_rows(float (&s)[RPL], RowOf row_of, bool have_list,
                                                 float& ls, int& li, int kb, int lane) {
    float new_s = NEG_INF;
    int new_i = 0;
    const bool list_here = have_list && lane < kb;
    for (int p = 0; p < kb; ++p) {
        // lane-local best: chunk rows ascend with j, so strict > keeps the lowest id
        float best = s[0];
        int bid = row_of(0);
        int slot = 0;
#pragma unroll
        for (int j = 1; j < RPL; ++j) {
            if (s[j] > best) {
                best = s[j];
                bid = row_of(j);
                slot = j;
            }
        }
        if (list_here && (ls > best || (ls == best && li < bid))) {
            best = ls;
            bid = li;
            slot = RPL;
        }
        // warp arg-max under (score desc, id asc, lane asc): a total order, so
        // every lane ends with the same winner; the lane order only separates
        // repeated re-emissions of one id
        int blane = lane;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ob = __shfl_xor_sync(FULL, best, off);
            const int oi = __shfl_xor_sync(FULL, bid, off);
            const int ol = __shfl_xor_sync(FULL, blane, off);
            if (ob > best || (ob == best && (oi < bid || (oi == bid && ol < blane)))) {
                best = ob;
                bid = oi;
                blane = ol;
            }
        }
        if (lane == blane) {  // the winner's own lane sets its entry to -1e30
            if (slot == RPL) {
                ls = NEG_INF;
            } else {
#pragma unroll
                for (int j = 0; j < RPL; ++j)
                    if (j == slot) s[j] = NEG_INF;
            }
        }
        if (lane == p) {
            new_s = best;
            new_i = bid;
        }
    }
    ls = new_s;
    li = new_i;
}

// merge_chunk_rows with lane l holding rows base + l + 32·j
template <int RPL>
__device__ __forceinline__ void merge_chunk(float (&s)[RPL], int base, bool have_list,
                                            float& ls, int& li, int kb, int lane) {
    merge_chunk_rows<RPL>(s, [=](int j) { return base + lane + 32 * j; }, have_list, ls, li, kb,
                          lane);
}

// A wgmma accumulator element as an f32 score: kernel 2's hold f32, kernel
// 1's int32 registers hold the f32 bits of the score computed in place.
__device__ __forceinline__ float acc_score(float v) { return v; }
__device__ __forceinline__ float acc_score(int v) { return __int_as_float(v); }
__device__ __forceinline__ void set_score(float& v, float s) { v = s; }
__device__ __forceinline__ void set_score(int& v, float s) { v = __float_as_int(s); }

// One query row's merge (quad-cooperative): the quad's 4 threads hold its
// 256 chunk scores, thread t columns 8j + 2t + e in d[4j + 2R + e]; the old
// list [kb] is read, the new one written (by thread 0 of the quad).
template <int R, typename A>
__device__ __forceinline__ void merge_row(A (&d)[128], int t, int grow0, bool have_list,
                                          const float* os, const int* oi, float* ns, int* ni,
                                          int kb, int block_row0) {
    // this thread's best remaining (value, column): columns ascend with
    // (j, e), so a strict > keeps the lowest
    auto local_best = [&](float& bv, int& bc) {
        bv = acc_score(d[2 * R]);
        bc = 2 * t;
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float v = acc_score(d[4 * j + 2 * R + e]);
                if (v > bv) {
                    bv = v;
                    bc = 8 * j + 2 * t + e;
                }
            }
    };
    auto quad_best = [&](float& bv, int& bc) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            const float ov = __shfl_xor_sync(FULL, bv, off);
            const int oc = __shfl_xor_sync(FULL, bc, off);
            if (ov > bv || (ov == bv && oc < bc)) {
                bv = ov;
                bc = oc;
            }
        }
    };
    float cv;
    int cc;
    local_best(cv, cc);
    quad_best(cv, cc);
    int ptr = 0;
    for (int p = 0; p < kb; ++p) {
        // the list's next entry wins a tie (its id is lower); past every
        // score above -1e30, each row of the block is at -1e30 and the
        // lowest, the block's first, is emitted
        const float lv = have_list ? os[ptr] : NEG_INF;
        const bool from_list = lv > NEG_INF && (lv >= cv || cv <= NEG_INF);
        const bool from_chunk = !from_list && cv > NEG_INF;
        if (t == 0) {
            ns[p] = from_list ? lv : from_chunk ? cv : NEG_INF;
            ni[p] = from_list ? oi[ptr] : from_chunk ? grow0 + cc : block_row0;
        }
        if (from_list) ++ptr;
        if (p + 1 == kb) break;  // the last pass: no entry is read after it
        if (from_chunk && ((cc >> 1) & 3) == t) {  // the owner sets the entry to -1e30
            const int slot = 4 * (cc >> 3) + 2 * R + (cc & 1);
#pragma unroll
            for (int k = 0; k < 32; ++k)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    if (4 * k + 2 * R + e == slot) set_score(d[4 * k + 2 * R + e], NEG_INF);
        }
        if (__any_sync(FULL, from_chunk)) {  // the next chunk candidate (shuffles need the warp)
            float nv;
            int nc;
            local_best(nv, nc);
            quad_best(nv, nc);
            if (from_chunk) {
                cv = nv;
                cc = nc;
            }
        }
    }
}

// A quad's list copied unchanged into the new buffer (a chunk that cannot change it).
__device__ __forceinline__ void copy_list(const float* os, const int* oi, float* ns, int* ni,
                                          int kb, int t) {
    for (int p = t; p < kb; p += 4) {
        ns[p] = os[p];
        ni[p] = oi[p];
    }
}

}  // namespace block_topk
