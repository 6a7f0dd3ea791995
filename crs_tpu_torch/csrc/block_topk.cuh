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

}  // namespace block_topk
