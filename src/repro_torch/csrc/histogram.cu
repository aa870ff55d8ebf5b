// Step ① — gradient-statistics histogram, grouped by field.
//
// Replaces the TPU kernels src/repro/kernels/histogram.py::_hist_kernel_grouped
// (with its helper _stats_node, including its class axis, and its
// nibble_packed branch) and ::_hist_kernel_packed (below).  The TPU version
// turned the scatter hist[slot, f, bin] += (g, h) into a one-hot matrix
// product on the MXU; on Hopper that product would run on the tensor cores in
// TF32 and truncate g and h, so this kernel does what the paper's hardware
// does instead: every field owns its own NB-bin array of (g, h) sums in
// shared memory (NB = 256 bins x 2 stats x 4 B = the paper's 2 KB SRAM per
// field).
//
// Slots.  Multi-class boosting grows K trees per round, each with its own
// node partition of the same records.  A slot is a (class, node) pair,
// class-major: slot = k * NN + node[k, r], K * NN slots in all; the output
// (K*NN, F, NB, 2) is (K, NN, F, NB, 2).  K = 1 is the single-class
// histogram.
//
// Bound on the H100: bytes.  The codes (n*F bytes) and K*12 bytes of g, h
// and node id per record must be read; the arithmetic is 2*K adds per
// (record, field).  Design of the grouped kernel (hist_grouped_kernel):
//   * Records grouped by slot.  A counting sort of the (class, record)
//     pairs by slot (slot_sort_kernel, slot_scan_kernel) lists the record
//     indices slot after slot in a scratch array: per block, counts in
//     shared memory (__match_any_sync groups a warp's lanes of one slot,
//     whose first lane adds the group), one global atomic per (block,
//     slot), an exclusive scan of the K*NN counts, then a scatter in which
//     each block reserves its run of every slot and each warp group its
//     place in it.  With one slot (K*NN = 1) the list is the identity and
//     the sort is skipped.
//   * Exact subtraction (paper §II-A).  At a level > 0 the two children of
//     a parent (slots 2p and 2p + 1 of a class) hold exactly its records,
//     so given the parent level's int64 sums the scan lists only each
//     parent's smaller child (by record count, the left one on a tie): the
//     larger child's run is empty and its cursor SKIP, so the scatter
//     writes none of its records and the kernel reads none.  The finish
//     pass then writes that child's sums as parent - sibling, in place, and
//     its float32 histogram from them.  Integer subtraction is exact, so
//     the level equals the direct pass bit for bit; the list holds at most
//     K*n/2 positions, and a parent that stopped splitting (every record
//     on one side) costs nothing.  The scan also adds the pairs it listed
//     and the pairs a direct pass would have listed into a two-word
//     counter (kernels/histogram.py, record_pair_counts).
//   * One block, one slot's histogram.  A block holds every field's bins
//     of one slot (of a field tile, where the bins pass the budget) and
//     takes an equal share of the sorted list, whatever the slots' sizes
//     (the list's length read on the device, offsets[S]);
//     where its share crosses into the next slot it flushes and starts
//     again.  So each record (each (class, record) pair) is read once per
//     level, with no per-slot test.
//   * A warp per record, a lane per field (the paper's field -> SRAM
//     mapping).  Lane l of a warp loads one record's index, g and h for 32
//     sorted positions and stages them in shared memory; each lane then
//     reads them back as broadcast 16-byte loads (a shuffle costs the SM
//     twice as much), loads the codes of its field l, l + 32, ... of
//     STEP_RECORDS records at once, and adds each.  A record's row arrives
//     in one or two sectors; no index is divided per pair.
//   * Fixed-point bins.  Each g (h) is rounded once, as its lane loads it,
//     to an integer q on a power-of-two grid: q = rint(g * scale), where
//     scale (kernels/histogram.py, fixed_point_scale, one a class and
//     statistic, read from the device) puts the largest |g| of the tree's
//     records in [2^30, 2^31).  The grid is at most 2^-30 of that largest
//     |g|, 128x finer than float32's own spacing there, and every sum of
//     the q is exact, so the histogram does not depend on the order of
//     the adds.  A statistic's bin is two 32-bit words, the high half of
//     q (q >> 16, signed) and the low half (q & 0xFFFF, unsigned), each
//     added with a native shared-memory integer atomic whose result is
//     unused (ATOMS.ADD, one a cycle an SM on sm_90a, whatever the
//     addresses: no compare-and-swap loop, no retry); four adds a (record,
//     field), without a branch.  The halves lie in [-2^15, 2^15) and
//     [0, 2^16), so neither word can overflow within 2^16 positions: a
//     block flushes its bins at each slot's edge and at least every
//     flush_every <= 2^16 positions (kernels/histogram.py,
//     grouped_geometry).  The adds are not what bounds the kernel (timed
//     without them it takes as long): the instructions that address and
//     load the codes are.
//   * Conflict-free bins.  The bins are four [bin][field] arrays (g's high
//     and low words, then h's), a tile's fields padded to a multiple of 32
//     words (row): the lane of field f adds into bank f mod 32 whatever
//     the code, so the 32 lanes of a warp never share a bank, let alone an
//     address.  Each array has a bin NB more, into which a code outside
//     the binning invariant adds and which no flush reads.  16 bytes a
//     (field, bin): 128 KB for 32 fields of 256 bins, one block of
//     GROUPED_THREADS an SM, whose 32 warps keep the gathered code loads
//     in flight.
//   * Blocks run in no order (the TPU grid carried its sum from step to
//     step), so each block flushes its non-zero bins, hi * 2^16 + lo, into
//     a zeroed int64 scratch with native 64-bit global atomics: the
//     cross-block reduction is explicit and exact.  Then one pass
//     (hist_grouped_kernel_finish) turns the level's int64 sums into the
//     float32 histogram, each sum rounded once and divided by its scale.
//     A non-finite g or h gives scale 0, and its statistic's histogram is
//     NaN throughout.
//
// 4-bit codes (the nibble_packed=True branch of _hist_kernel_grouped).  With
// n_bins <= 16 the row-major copy holds two codes a byte, Fb = ceil(F/2)
// bytes a record, the low nibble the even field; an odd F leaves one pad
// nibble a record, which no field index reaches.  The same kernel body reads
// the code of (record r, field f) from byte codes[r * Fb + (f >> 1)],
// shifted by (f & 1) * 4 (the NIBBLE instance); two lanes read one byte.  Field tiles are addressed by global field index, so a tile may
// start on an odd field (the TPU version had to widen its field block to
// whole bytes).
//
// Naive packing (hist_naive_kernel, the Fig. 9 ablation twin of
// _hist_kernel_packed).  What the ablation compares stays naive: a block's
// bins are one slot's flat [field][bin][2] array, the output's own layout
// (the TPU kernel's single FBLK*NB-wide tile), and each thread takes a
// whole record and adds its fields one after another, as a record's fields
// behind one SRAM port serialise in the paper's naive packing.  With 2*NB
// words a field (NB a multiple of 16), field f's bin c lies on bank 2c mod
// 32 whatever f, so lanes collide by code: that is the layout's cost here.
// Its bins stay float32: shared-memory atomicAdd on float compiles to a
// compare-and-swap loop on sm_90a (LDS, FADD, ATOMS.CAST.SPIN), and the
// blocks flush their non-zero bins into the zeroed output with global
// float atomics, so its sums are reordered from run to run: bit-equal to
// the plain version only when every partial sum is exact (dyadic g, h).
// Everything else is the grouped kernel's: the same counting sort and the
// same schedule (an equal share of the sorted list a block, one slot's bins
// at a time, non-zero bins flushed), so each (class, record) pair's g, h,
// node id and code row is read once a level per field tile; a warp loads
// 32 positions' index, g and h at once, then each lane reads its record's
// row as 32-bit words where the rows allow it.  Where a warp's codes of a
// field span at most COMBINE_RANGE bins (two-category fields), its lanes'
// adds to one bin are summed first and one lane adds the sum, so a field
// of two codes costs two adds a warp and not a compare-and-swap loop of 32.
#include "launch.cuh"

// -- the counting sort of (class, record) pairs by slot ---------------------

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int SORT_THREADS = 512;
constexpr int SCAN_THREADS = 1024;
constexpr int GROUPED_THREADS = 1024;     // one block an SM: 32 warps
constexpr int NAIVE_THREADS = 512;
constexpr int NAIVE_BLOCKS_PER_SM = 3;     // registers for three blocks an SM
constexpr int FINISH_THREADS = 256;
// Records whose codes a lane of the grouped kernel loads at once, and a
// warp's stage of 32 positions' record index and g, h words (high and low
// halves)
constexpr int STEP_RECORDS = 16;
constexpr int STAGE_INTS = 5 * 32;
constexpr int GROUPED_STAGE_BYTES = GROUPED_THREADS / 32 * STAGE_INTS * 4;
constexpr int SORT_NODE_BYTES = 12;        // a node's base (8 B) and counter
// The scatter cursor of a slot that exact subtraction does not bin
constexpr unsigned long long SKIP = ~0ull;

// One pass of a block over its records [r0, r1) of one class: lanes whose
// records share a node form one group (__match_any_sync), whose first lane
// adds the group's size to the node's shared counter.  With ``order`` the
// pass also writes each record at base[node] + its rank in the block,
// skipping the records of a node whose base is SKIP.
__device__ __forceinline__ void rank_pass(const int32_t* __restrict__ nk,
                                          long long r0, long long r1, int NN,
                                          unsigned* cnt,
                                          const unsigned long long* base,
                                          int32_t* __restrict__ order) {
    const int lane = threadIdx.x & 31;
    for (long long w = r0 + (threadIdx.x & ~31u); w < r1; w += blockDim.x) {
        const long long r = w + lane;
        const int nd = r < r1 ? nk[r] : -1;
        // others add nothing
        const int s = nd >= 0 && nd < NN
                      && (order == nullptr || base[nd] != SKIP) ? nd : -1;
        const unsigned peers = __match_any_sync(FULL_MASK, s);
        if (s < 0) continue;
        const int rank = __popc(peers & ((1u << lane) - 1u));
        unsigned off = 0;
        if (rank == 0) off = atomicAdd(cnt + s, static_cast<unsigned>(__popc(peers)));
        if (order != nullptr) {
            off = __shfl_sync(peers, off, __ffs(peers) - 1);
            order[base[s] + off + rank] = static_cast<int32_t>(r);
        }
    }
}

// blockIdx.y = class k, blockIdx.x = a chunk of its records.  Without
// SCATTER: add the chunk's count of every slot of class k into totals.
// With SCATTER: totals holds each slot's next free position (SKIP where
// the slot is not binned); reserve the chunk's run of every binned slot
// there, then write the record indices.
template <bool SCATTER>
__global__ void __launch_bounds__(SORT_THREADS)
slot_sort_kernel(const int32_t* __restrict__ node, long long n, int NN,
                 long long chunk, unsigned long long* __restrict__ totals,
                 int32_t* __restrict__ order) {
    extern __shared__ unsigned long long sort_shared[];
    unsigned long long* base = sort_shared;                      // [NN]
    unsigned* cnt = reinterpret_cast<unsigned*>(sort_shared + NN);  // [NN]
    const int k = blockIdx.y;
    const int32_t* nk = node + static_cast<long long>(k) * n;
    unsigned long long* tk = totals + static_cast<long long>(k) * NN;
    const long long r0 = static_cast<long long>(blockIdx.x) * chunk;
    const long long r1 = min(n, r0 + chunk);
    for (int i = threadIdx.x; i < NN; i += blockDim.x) cnt[i] = 0;
    __syncthreads();
    rank_pass(nk, r0, r1, NN, cnt, nullptr, nullptr);
    __syncthreads();
    for (int i = threadIdx.x; i < NN; i += blockDim.x) {
        const unsigned long long c = cnt[i];
        if (!SCATTER) {
            if (c) atomicAdd(tk + i, c);
        } else {
            base[i] = tk[i] == SKIP ? SKIP : c ? atomicAdd(tk + i, c) : 0ull;
            cnt[i] = 0;
        }
    }
    if (!SCATTER) return;
    __syncthreads();
    rank_pass(nk, r0, r1, NN, cnt, base, order);
}

// Whether slot s of a level of sibling pairs (slots 2p, 2p + 1) is binned
// under exact subtraction: the child with fewer records, the left one on a
// tie (core/tree.ResidentRecords.smaller_is_left's rule).
__device__ __forceinline__ bool smaller_child(
        const unsigned long long* __restrict__ counts, int s) {
    const unsigned long long c = counts[s], sibling = counts[s ^ 1];
    return (s & 1) ? c < sibling : c <= sibling;
}

// One block: offsets = the exclusive scan of the listed counts (S + 1
// entries, the last the total), and cursor = offsets[:S], the scatter's
// first free positions.  Every slot is listed, or with ``subtract`` only
// each pair's smaller child: the other's run is empty and its cursor
// SKIP.  ``pairs`` (or null): two int64 words that gain the pairs listed
// and the pairs of every slot.
__global__ void __launch_bounds__(SCAN_THREADS)
slot_scan_kernel(const unsigned long long* __restrict__ counts,
                 unsigned long long* __restrict__ offsets,
                 unsigned long long* __restrict__ cursor, int S,
                 bool subtract, unsigned long long* __restrict__ pairs) {
    __shared__ unsigned long long warp_total[SCAN_THREADS / 32];
    __shared__ unsigned long long every;
    if (threadIdx.x == 0) every = 0;
    const int per = (S + blockDim.x - 1) / blockDim.x;
    const int lo = min(S, static_cast<int>(threadIdx.x) * per);
    const int hi = min(S, lo + per);
    unsigned long long sum = 0, all = 0;
    for (int i = lo; i < hi; ++i) {
        all += counts[i];
        if (!subtract || smaller_child(counts, i)) sum += counts[i];
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned long long incl = sum;
    for (int d = 1; d < 32; d <<= 1) {
        const unsigned long long v = __shfl_up_sync(FULL_MASK, incl, d);
        if (lane >= d) incl += v;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    if (all) atomicAdd(&every, all);
    if (warp == 0) {
        unsigned long long t = lane < static_cast<int>(blockDim.x >> 5)
                                   ? warp_total[lane] : 0ull;
        for (int d = 1; d < 32; d <<= 1) {
            const unsigned long long v = __shfl_up_sync(FULL_MASK, t, d);
            if (lane >= d) t += v;
        }
        warp_total[lane] = t;
    }
    __syncthreads();
    unsigned long long run = incl - sum + (warp ? warp_total[warp - 1] : 0ull);
    for (int i = lo; i < hi; ++i) {
        const bool listed = !subtract || smaller_child(counts, i);
        offsets[i] = run;
        cursor[i] = listed ? run : SKIP;
        if (listed) run += counts[i];
    }
    if (threadIdx.x == blockDim.x - 1) {
        offsets[S] = run;
        if (pairs != nullptr) {
            atomicAdd(pairs, run);
            atomicAdd(pairs + 1, every);
        }
    }
}

// -- the grouped histogram over the sorted list ------------------------------

// Add the sorted positions [a, e) of one slot into the block's fixed-point
// bins: g's high word of (field fi, code c) at bins[c * row + fi], g's low
// word `words` on, then h's two.  row is a multiple of 32, so lane l, on
// fields l, l + 32, ..., always hits bank l, whatever the codes are.  Lane
// l puts the g and h of the record at position q + l on the grid of sg and
// sh and stages the record's index and the four words it adds in the
// warp's ``stage`` (STAGE_INTS ints); a position that adds nothing (past
// e, of another node, or g and h both 0 on the grid) stages record 0 with
// four zero words.  Each lane then reads the stage as broadcast 16-byte
// loads (a shuffle costs the SM twice a shared load), issues the loads of
// its field's codes of STEP_RECORDS records at once, and adds each
// record's words with four atomics, without a branch: a code outside the
// binning invariant adds into bin NB, which no flush reads.  The warp
// issues every add whatever the codes, so summing a lane's records of
// equal code first would save none.  Without ``order`` (one slot)
// position p is record p, of node 0.
template <bool NIBBLE>
__device__ __forceinline__ void add_records(
        unsigned* bins, int* stage, const uint8_t* __restrict__ codes,
        const float* __restrict__ gk, const float* __restrict__ hk,
        float sg, float sh, const int32_t* __restrict__ node,
        const int32_t* __restrict__ order, long long a, long long e, int f0,
        int ft, int row_bytes, int NB, int row, int words) {
    const int lane = threadIdx.x & 31;
    const long long step = static_cast<long long>(blockDim.x);
    int4* adds = reinterpret_cast<int4*>(stage + 32);
    int* g_hi = reinterpret_cast<int*>(bins);
    unsigned* g_lo = bins + words;
    int* h_hi = reinterpret_cast<int*>(bins + 2 * words);
    unsigned* h_lo = bins + 3 * words;
    for (long long q = a + (threadIdx.x & ~31u); q < e; q += step) {
        const long long p = q + lane;
        int r = -1, qg = 0, qh = 0;
        if (p < e) {
            r = order != nullptr ? order[p] : static_cast<int>(p);
            if (order == nullptr && node[r] != 0) r = -1;
            if (r >= 0) {
                qg = __float2int_rn(gk[r] * sg);
                qh = __float2int_rn(hk[r] * sh);
            }
        }
        __syncwarp();
        stage[lane] = max(r, 0);
        adds[lane] = r >= 0 ? make_int4(qg >> 16, qg & 0xFFFF, qh >> 16,
                                        qh & 0xFFFF)
                            : make_int4(0, 0, 0, 0);
        __syncwarp();
        for (int fi = lane; fi < ft; fi += 32) {
            const int f = f0 + fi;
            const uint8_t* field = codes + (NIBBLE ? f >> 1 : f);
            const int shift = NIBBLE ? (f & 1) << 2 : 0;
            for (int j = 0; j < 32; j += STEP_RECORDS) {
                int c[STEP_RECORDS];
#pragma unroll
                for (int u = 0; u < STEP_RECORDS; u += 4) {
                    const int4 rr =
                        *reinterpret_cast<const int4*>(stage + j + u);
                    const int ri[4] = {rr.x, rr.y, rr.z, rr.w};
#pragma unroll
                    for (int t = 0; t < 4; ++t) {
                        int code = field[static_cast<unsigned long long>(
                                             static_cast<unsigned>(ri[t]))
                                         * static_cast<unsigned>(row_bytes)];
                        if (NIBBLE) code = (code >> shift) & 0xF;
                        c[u + t] = min(code, NB);
                    }
                }
#pragma unroll
                for (int u = 0; u < STEP_RECORDS; ++u) {
                    const int4 v = adds[j + u];
                    const int w = c[u] * row + fi;
                    atomicAdd(g_hi + w, v.x);
                    atomicAdd(g_lo + w, static_cast<unsigned>(v.y));
                    atomicAdd(h_hi + w, v.z);
                    atomicAdd(h_lo + w, static_cast<unsigned>(v.w));
                }
            }
        }
    }
}

// Add the block's bins of one slot, hi * 2^16 + lo a statistic, into the
// slot's int64 sums, laid out as the bins are ([bin][field][2], all F
// fields), with global 64-bit atomics (non-zero sums only), and zero them
// for the next run.  Consecutive threads take consecutive fields of a bin:
// a warp's reads of the bins never share a bank, and its atomics fall on
// consecutive words.
__device__ __forceinline__ void flush_slot(unsigned* bins,
                                           unsigned long long* sums_slot,
                                           int F, int f0, int ft, int NB,
                                           int row, int words) {
    for (int i = threadIdx.x; i < NB * row; i += blockDim.x) {
        const int c = i / row, fi = i - c * row;
        if (fi >= ft) continue;
        unsigned* w = bins + i;
        const long long vg = static_cast<long long>(static_cast<int>(w[0]))
                                 * 65536 + w[words];
        const long long vh =
            static_cast<long long>(static_cast<int>(w[2 * words])) * 65536
            + w[3 * words];
        unsigned long long* out =
            sums_slot + 2 * (static_cast<long long>(c) * F + f0 + fi);
        if (vg != 0) atomicAdd(out, static_cast<unsigned long long>(vg));
        if (vh != 0) atomicAdd(out + 1, static_cast<unsigned long long>(vh));
        w[0] = w[words] = w[2 * words] = w[3 * words] = 0u;
    }
}

// The schedule of both histogram kernels.  blockIdx.y is a field tile and
// blockIdx.x an equal share of the sorted list, whatever the slots' sizes:
// the list's length is read here (offsets[S]; exact subtraction lists at
// most half the pairs), so every block takes a share of what was listed.
// The block zeroes its ``words`` bins, then calls run(s, a, e) for each
// slot s whose positions [a, e) meet its share, in order; run adds them
// into the bins and flushes them, which zeroes them again.  Without
// ``order`` (one slot) the list is the n records.
template <typename Word, typename Run>
__device__ __forceinline__ void for_each_slot(
        const int32_t* __restrict__ order,
        const unsigned long long* __restrict__ offsets, long long n, int S,
        Word* bins, int words, Run run) {
    const long long total =
        order != nullptr ? static_cast<long long>(offsets[S]) : n;
    const long long per_block = (total + gridDim.x - 1) / gridDim.x;
    long long p = static_cast<long long>(blockIdx.x) * per_block;
    const long long p_end = min(total, p + per_block);
    if (p >= p_end) return;
    for (int i = threadIdx.x; i < words; i += blockDim.x) bins[i] = Word(0);
    // the slot of position p: the last s with offsets[s] <= p
    int s = 0;
    if (order != nullptr) {
        int hi = S;
        while (hi - s > 1) {
            const int mid = (s + hi) >> 1;
            if (static_cast<long long>(offsets[mid]) <= p) s = mid;
            else hi = mid;
        }
    }
    __syncthreads();
    while (p < p_end) {
        long long e = p_end;
        if (order != nullptr) {
            while (static_cast<long long>(offsets[s + 1]) <= p) ++s;
            e = min(e, static_cast<long long>(offsets[s + 1]));
        }
        run(s, p, e);
        p = e;
    }
}

// scale: (K, 2) float32, the grid of each class's g and h; sums: the
// zeroed int64 (K*NN, NB, F, 2) scratch.  A block flushes at each slot's
// edge and every flush_every positions (<= 2^16: see the header), and at
// the end of its share.
template <bool NIBBLE>
__global__ void __launch_bounds__(GROUPED_THREADS, 1)
hist_grouped_kernel(const uint8_t* __restrict__ codes,
                    const float* __restrict__ g, const float* __restrict__ h,
                    const int32_t* __restrict__ node,
                    const int32_t* __restrict__ order,
                    const unsigned long long* __restrict__ offsets,
                    const float* __restrict__ scale,
                    unsigned long long* __restrict__ sums, long long n,
                    int F, int row_bytes, int NN, int S, int NB, int FT,
                    int row, long long flush_every) {
    // [4][NB + 1][row]: g hi, lo, h hi, lo, each with bin NB for what is
    // not added (the naive kernel's bins are float); then each warp's
    // stage
    extern __shared__ unsigned fixed_bins[];
    unsigned* bins = fixed_bins;
    const int words = (NB + 1) * row;
    int* stage = reinterpret_cast<int*>(bins + 4 * words)
                 + (threadIdx.x >> 5) * STAGE_INTS;
    const int f0 = blockIdx.y * FT;
    const int ft = min(FT, F - f0);
    for_each_slot(order, offsets, n, S, bins, 4 * words,
                  [&](int s, long long a, long long e) {
        const int k = s / NN;
        const long long kn = static_cast<long long>(k) * n;
        const float sg = scale[2 * k], sh = scale[2 * k + 1];
        unsigned long long* sums_slot =
            sums + static_cast<long long>(s) * NB * F * 2;
        for (; a < e; a += flush_every) {
            add_records<NIBBLE>(bins, stage, codes, g + kn, h + kn, sg, sh,
                                node, order, a, min(e, a + flush_every), f0,
                                ft, row_bytes, NB, row, words);
            __syncthreads();
            flush_slot(bins, sums_slot, F, f0, ft, NB, row, words);
            __syncthreads();
        }
    });
}

// The float32 (K*NN, F, NB, 2) histogram from the level's int64 (K*NN, NB,
// F, 2) sums: out = sum / scale, one (g, h) pair of the output a thread.
// scale 0 marks a non-finite statistic, whose histogram is NaN.  With
// ``parent`` (the last level's (K*NN/2, NB, F, 2) sums) a slot whose
// cursor is SKIP was not binned: its sums are parent - sibling, written
// back into ``sums`` for the next level (the sibling's are final).
__global__ void __launch_bounds__(FINISH_THREADS)
hist_grouped_kernel_finish(longlong2* __restrict__ sums,
                           const longlong2* __restrict__ parent,
                           const unsigned long long* __restrict__ cursor,
                           const float* __restrict__ scale,
                           float2* __restrict__ out, long long pairs, int NN,
                           int F, int NB) {
    const int per_slot = F * NB;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x; i < pairs; i += stride) {
        const long long s = i / per_slot;
        const int rem = static_cast<int>(i - s * per_slot);
        const int f = rem / NB, c = rem - f * NB;
        const int k = static_cast<int>(s / NN);
        const float sg = scale[2 * k], sh = scale[2 * k + 1];
        const long long at = (s * NB + c) * F + f;
        longlong2 v;
        if (parent != nullptr && cursor[s] == SKIP) {
            const longlong2 whole = parent[((s >> 1) * NB + c) * F + f];
            const longlong2 sibling = sums[((s ^ 1) * NB + c) * F + f];
            v = make_longlong2(whole.x - sibling.x, whole.y - sibling.y);
            sums[at] = v;
        } else {
            v = sums[at];
        }
        out[i] = make_float2(
            sg > 0.f ? __ll2float_rn(v.x) / sg : __int_as_float(0x7fc00000),
            sh > 0.f ? __ll2float_rn(v.y) / sh : __int_as_float(0x7fc00000));
    }
}

// -- the naive-packing histogram over the sorted list ------------------------

// A warp's codes of one field that span at most this many bins are summed
// bin by bin across the warp before one lane adds each sum.
constexpr int COMBINE_RANGE = 4;

// Add this lane's (g, h) into bin c of field fi of the flat [field][bin][2]
// bins; c >= NB (no record, or a code outside the binning invariant) adds
// nothing.  Every lane of the warp calls it for the same field.  Lanes of
// equal code add into one word, a compare-and-swap loop that retries once
// a lane: where the warp's codes span few bins, each bin's lanes are summed
// by shuffles and the bin's first lane adds the sum.
__device__ __forceinline__ void add_field(float* bins, int fi, int c, int NB,
                                          float gv, float hv) {
    const bool ok = c < NB;
    const int lo = __reduce_min_sync(FULL_MASK, ok ? c : NB);
    const int hi = __reduce_max_sync(FULL_MASK, ok ? c : -1);
    float* field = bins + 2 * fi * NB;
    if (hi - lo >= COMBINE_RANGE) {
        if (ok) {
            atomicAdd(field + 2 * c, gv);
            atomicAdd(field + 2 * c + 1, hv);
        }
        return;
    }
    const int lane = threadIdx.x & 31;
    for (int v = lo; v <= hi; ++v) {
        const unsigned lanes = __ballot_sync(FULL_MASK, c == v);
        if (lanes == 0u) continue;
        float sg = c == v ? gv : 0.f, sh = c == v ? hv : 0.f;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
            sg += __shfl_xor_sync(FULL_MASK, sg, d);
            sh += __shfl_xor_sync(FULL_MASK, sh, d);
        }
        if (lane == __ffs(lanes) - 1) {
            atomicAdd(field + 2 * v, sg);
            atomicAdd(field + 2 * v + 1, sh);
        }
    }
}

// Add the sorted positions [a, e) of one slot into the block's flat bins of
// the field tile [f0, f0 + ft): lane l of a warp loads the record at
// position q + l and its g and h, then adds the record's fields one after
// another, reading its row as 32-bit words with WORDS (row and tile start
// on a multiple of 4 bytes), else byte by byte.  Without ``order`` (one
// slot) position p is record p, of node 0.
template <bool WORDS>
__device__ __forceinline__ void add_rows(
        float* bins, const uint8_t* __restrict__ codes,
        const float* __restrict__ gk, const float* __restrict__ hk,
        const int32_t* __restrict__ node, const int32_t* __restrict__ order,
        long long a, long long e, int F, int f0, int ft, int NB) {
    const int lane = threadIdx.x & 31;
    const long long step = static_cast<long long>(blockDim.x);
    for (long long q = a + (threadIdx.x & ~31u); q < e; q += step) {
        const long long p = q + lane;
        int r = -1;
        float gv = 0.f, hv = 0.f;
        if (p < e) {
            r = order != nullptr ? order[p] : static_cast<int>(p);
            if (order == nullptr && node[r] != 0) r = -1;
            if (r >= 0) {
                gv = gk[r];
                hv = hk[r];
            }
        }
        const uint8_t* row =
            codes + static_cast<long long>(max(r, 0)) * F + f0;
        if (WORDS) {
            const unsigned* words = reinterpret_cast<const unsigned*>(row);
            for (int fw = 0; fw < ft; fw += 4) {
                const unsigned w = r >= 0 ? words[fw >> 2] : 0u;
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    const int c = static_cast<int>((w >> (8 * b)) & 0xFFu);
                    if (fw + b < ft)
                        add_field(bins, fw + b, r >= 0 ? c : NB, NB, gv, hv);
                }
            }
        } else {
            for (int fi = 0; fi < ft; ++fi)
                add_field(bins, fi, r >= 0 ? row[fi] : NB, NB, gv, hv);
        }
    }
}

// Add the block's flat bins of one slot (the output's own [field][bin][2]
// layout) into the output with global float atomics: non-zero words only,
// consecutive threads on consecutive words; and zero them for the next slot.
__device__ __forceinline__ void flush_flat(float* bins,
                                           float* __restrict__ out_slot,
                                           int words) {
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
        const float v = bins[i];
        if (v != 0.f) atomicAdd(out_slot + i, v);
        bins[i] = 0.f;
    }
}

template <bool WORDS>
__global__ void __launch_bounds__(NAIVE_THREADS, NAIVE_BLOCKS_PER_SM)
hist_naive_kernel(const uint8_t* __restrict__ codes,
                  const float* __restrict__ g, const float* __restrict__ h,
                  const int32_t* __restrict__ node,
                  const int32_t* __restrict__ order,
                  const unsigned long long* __restrict__ offsets,
                  float* __restrict__ out, long long n, int F, int NN, int S,
                  int NB, int FT) {
    extern __shared__ float bins[];      // [ft][NB][2], the output's layout
    const int f0 = blockIdx.y * FT;
    const int ft = min(FT, F - f0);
    const int words = 2 * ft * NB;
    for_each_slot(order, offsets, n, S, bins, words,
                  [&](int s, long long a, long long e) {
        const long long kn = static_cast<long long>(s / NN) * n;
        add_rows<WORDS>(bins, codes, g + kn, h + kn, node, order, a, e, F,
                        f0, ft, NB);
        __syncthreads();
        flush_flat(bins, out + (static_cast<long long>(s) * F + f0) * NB * 2,
                   words);
        __syncthreads();
    });
}

// -- launches ----------------------------------------------------------------

// The counting sort of the (class, record) pairs by slot into ord.  counts:
// 3 * K * NN + 1 zeroed uint64 — counts, offsets (the exclusive scan, its
// last entry the total), cursor.  With ``subtract`` only each sibling
// pair's smaller child is listed; ``pairs`` (or null) gains the pairs
// listed and the pairs of every slot.
static cudaError_t sort_by_slot(const int32_t* nodes, int32_t* ord,
                                unsigned long long* counts, long long n,
                                int K, int NN, int sort_blocks,
                                long long sort_chunk, bool subtract,
                                unsigned long long* pairs, cudaStream_t st) {
    const int S = K * NN;
    const int sort_smem = NN * SORT_NODE_BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        slot_sort_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        sort_smem);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            slot_sort_kernel<true>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, sort_smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(sort_blocks, K);
    slot_sort_kernel<false><<<grid, SORT_THREADS, sort_smem, st>>>(
        nodes, n, NN, sort_chunk, counts, nullptr);
    slot_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(
        counts, counts + S, counts + 2 * S + 1, S, subtract, pairs);
    slot_sort_kernel<true><<<grid, SORT_THREADS, sort_smem, st>>>(
        nodes, n, NN, sort_chunk, counts + 2 * S + 1, ord);
    return cudaGetLastError();
}

// The counting sort (skipped when order is null: one slot), then a
// histogram kernel over blocks x n_ftiles blocks of ``threads``, each with
// smem bytes of bins.  Returns the first CUDA error.
template <typename Kernel, typename... Args>
static int launch_sorted(Kernel kernel, int threads, int smem,
                         const void* node, void* order, void* slots,
                         long long n, int K, int NN, int n_ftiles,
                         int blocks, int sort_blocks, long long sort_chunk,
                         bool subtract, void* pairs, cudaStream_t st,
                         Args... args) {
    if (order != nullptr) {
        const cudaError_t err = sort_by_slot(
            static_cast<const int32_t*>(node), static_cast<int32_t*>(order),
            static_cast<unsigned long long*>(slots), n, K, NN, sort_blocks,
            sort_chunk, subtract, static_cast<unsigned long long*>(pairs),
            st);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(blocks, n_ftiles), threads, smem, st>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

// What sizes a launch of either histogram kernel on ``device``
// (kernels/histogram.py, GroupedLimits): out[0..6] = the blocks of the
// grouped kernel an SM can hold by its registers and threads (the fewer of
// its two instances), the blocks an SM the naive kernel's launch bounds
// allow, the sort's shared bytes a node, then the card's SMs, shared
// memory an SM, what the runtime keeps of it for every block, and the
// most dynamic shared memory a block may opt into.
extern "C" int hist_grouped_limits(int device, int* out) {
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(device);
    int byte_blocks = 0, nibble_blocks = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &byte_blocks, hist_grouped_kernel<false>, GROUPED_THREADS, 0);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &nibble_blocks, hist_grouped_kernel<true>, GROUPED_THREADS, 0);
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = min(byte_blocks, nibble_blocks);
    out[1] = NAIVE_BLOCKS_PER_SM;
    out[2] = SORT_NODE_BYTES;
    const cudaDeviceAttr attrs[] = {
        cudaDevAttrMultiProcessorCount,
        cudaDevAttrMaxSharedMemoryPerMultiprocessor,
        cudaDevAttrReservedSharedMemoryPerBlock,
        cudaDevAttrMaxSharedMemoryPerBlockOptin};
    for (int i = 0; i < 4; ++i) {
        err = cudaDeviceGetAttribute(out + 3 + i, attrs[i], device);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

// The three entries take the same arguments first: codes, g, h and node
// ids, order (K * n int32, null with one slot), slots (3 * K * NN + 1
// zeroed uint64, null with one slot), then the shapes and the geometry of
// kernels/histogram.py's grouped_geometry.
#define HIST_ENTRY_ARGS                                                     \
    const void *codes, const void *g, const void *h, const void *node,      \
        void *order, void *slots, long long n, int F, int K, int NN,        \
        int NB, int FT, int row, int n_ftiles, int blocks,                  \
        int sort_blocks, long long sort_chunk
#define GROUPED_ENTRY_ARGS                                                  \
    HIST_ENTRY_ARGS, const void *scale, void *sums, long long flush_every,  \
        bool subtract, void *pairs, void *stream

// The grouped entries then take scale ((K, 2) float32), sums (the (K * NN,
// NB, F, 2) int64 scratch, zeroed here) and flush_every, and leave the
// level's exact sums there (hist_grouped_finish turns them into floats);
// with ``subtract`` (NN even, the last level's sums at hand) they bin only
// each parent's smaller child, for the finish to derive its sibling, and
// add the pairs listed and the pairs in all into ``pairs`` (or null).
template <bool NIBBLE>
static int launch_grouped(GROUPED_ENTRY_ARGS) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long pairs_out = static_cast<long long>(K) * NN * F * NB;
    cudaError_t err = cudaMemsetAsync(sums, 0, pairs_out * 16, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_sorted(
        hist_grouped_kernel<NIBBLE>, GROUPED_THREADS,
        16 * (NB + 1) * row + GROUPED_STAGE_BYTES, node, order, slots, n, K,
        NN, n_ftiles, blocks, sort_blocks, sort_chunk, subtract, pairs, st,
        static_cast<const uint8_t*>(codes), static_cast<const float*>(g),
        static_cast<const float*>(h), static_cast<const int32_t*>(node),
        static_cast<const int32_t*>(order),
        static_cast<const unsigned long long*>(slots) + K * NN,
        static_cast<const float*>(scale),
        static_cast<unsigned long long*>(sums), n, F,
        NIBBLE ? (F + 1) / 2 : F, NN, K * NN, NB, FT, row, flush_every);
}

extern "C" int hist_grouped_launch(GROUPED_ENTRY_ARGS) {
    return launch_grouped<false>(codes, g, h, node, order, slots, n, F, K,
                                 NN, NB, FT, row, n_ftiles, blocks,
                                 sort_blocks, sort_chunk, scale, sums,
                                 flush_every, subtract, pairs, stream);
}

// codes: the (n, ceil(F/2)) packed bytes of PackedCodes.data
extern "C" int hist_nibble_launch(GROUPED_ENTRY_ARGS) {
    return launch_grouped<true>(codes, g, h, node, order, slots, n, F, K,
                                NN, NB, FT, row, n_ftiles, blocks,
                                sort_blocks, sort_chunk, scale, sums,
                                flush_every, subtract, pairs, stream);
}

// The float32 (S, F, NB, 2) histogram ``out`` of S = K * NN slots from
// their (S, NB, F, 2) int64 sums on the grid ``scale`` ((K, 2) float32).
// With ``parent`` (the last level's (S / 2, NB, F, 2) sums; null for a
// direct pass) the slots whose ``cursor`` (the entry's slots + 2 * S + 1)
// is SKIP take parent - sibling, in ``sums`` too.
extern "C" int hist_grouped_finish(void* sums, const void* parent,
                                   const void* cursor, const void* scale,
                                   void* out, long long S, int NN, int F,
                                   int NB, void* stream) {
    const long long pairs = S * F * NB;
    const long long blocks =
        min((pairs + FINISH_THREADS - 1) / FINISH_THREADS, 1ll << 16);
    hist_grouped_kernel_finish<<<static_cast<unsigned>(blocks),
                                 FINISH_THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<longlong2*>(sums),
        static_cast<const longlong2*>(parent),
        static_cast<const unsigned long long*>(cursor),
        static_cast<const float*>(scale), static_cast<float2*>(out), pairs,
        NN, F, NB);
    return static_cast<int>(cudaGetLastError());
}

// out: the zeroed (K * NN, F, NB, 2) float32 histogram.  row == FT: the
// naive kernel's bins are the tile's fields, unpadded.  Rows are read as
// words where every tile starts on a multiple of 4 bytes.
extern "C" int hist_naive_launch(HIST_ENTRY_ARGS, void *out, void *stream) {
    const bool words = F % 4 == 0 && FT % 4 == 0
                       && reinterpret_cast<uintptr_t>(codes) % 4 == 0;
    auto* kernel =
        words ? &hist_naive_kernel<true> : &hist_naive_kernel<false>;
    return launch_sorted(
        kernel, NAIVE_THREADS, 2 * NB * row * static_cast<int>(sizeof(float)),
        node, order, slots, n, K, NN, n_ftiles, blocks, sort_blocks,
        sort_chunk, false, nullptr, static_cast<cudaStream_t>(stream),
        static_cast<const uint8_t*>(codes), static_cast<const float*>(g),
        static_cast<const float*>(h), static_cast<const int32_t*>(node),
        static_cast<const int32_t*>(order),
        static_cast<const unsigned long long*>(slots) + K * NN,
        static_cast<float*>(out), n, F, NN, K * NN, NB, FT);
}
