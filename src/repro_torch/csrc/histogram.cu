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
// and node id per record must be read; the arithmetic is 2*K float adds per
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
//   * One block, one slot's histogram.  A block holds every field's bins
//     of one slot (of a field tile, where the bins pass the budget) and
//     takes an equal share of the sorted list, whatever the slots' sizes;
//     where its share crosses into the next slot it flushes and starts
//     again.  So each record (each (class, record) pair) is read once per
//     level, with no per-slot test, and two or three blocks fit on an SM.
//   * A warp per record, a lane per field (the paper's field -> SRAM
//     mapping).  Lane l of a warp loads one record's index, g and h for 32
//     sorted positions; the warp then takes those records four at a time
//     (shuffled to every lane), each lane adding field l, l + 32, ... of
//     each, with one add for those of the four whose codes are equal (two
//     in three for two-category fields).  A record's row arrives in one or
//     two sectors; no index is divided per pair.
//   * Conflict-free bins.  The bins are [bin][field], a tile's fields
//     padded to a multiple of 32 words (row), g sums then h sums: the lane
//     of field f adds into bank f mod 32 whatever the code, so the 32 lanes
//     of a warp never share a bank, let alone an address.  Shared-memory
//     atomicAdd on float compiles to a compare-and-swap loop on sm_90a
//     (LDS, FADD, ATOMS.CAST.SPIN), two shared accesses an add.
//   * Blocks run in no order (the TPU grid carried its sum from step to
//     step), so each block flushes its non-zero bins into the zeroed output
//     with global float atomics: the cross-block reduction is explicit.
// Float atomics reorder the sums from run to run: results are bit-equal to
// the plain version only when every partial sum is exact (dyadic g, h).
//
// 4-bit codes (the nibble_packed=True branch of _hist_kernel_grouped).  With
// n_bins <= 16 the row-major copy holds two codes a byte, Fb = ceil(F/2)
// bytes a record, the low nibble the even field; an odd F leaves one pad
// nibble a record, which no field index reaches.  The same kernel body reads
// the code of (record r, field f) through code_at<NIBBLE>: byte
// codes[r * Fb + (f >> 1)], shifted by (f & 1) * 4; two lanes read one
// byte.  Field tiles are addressed by global field index, so a tile may
// start on an odd field (the TPU version had to widen its field block to
// whole bytes).
//
// Naive packing (hist_naive_kernel, the Fig. 9 ablation twin of
// _hist_kernel_packed).  Tiles of (slot, field) pairs in one flat
// [slot][field][bin] array in shared memory, each block streaming every
// record of its chunk and skipping those of other slots; each thread takes
// whole records and adds the record's tile fields one after another, as a
// record's fields behind one SRAM port serialise in the paper's naive
// packing.
#include "launch.cuh"

template <bool NIBBLE>
__device__ __forceinline__ int code_at(const uint8_t* __restrict__ codes,
                                       long long r, int f, int row_bytes) {
    if (NIBBLE) {
        const int b = codes[r * row_bytes + (f >> 1)];
        return (b >> ((f & 1) << 2)) & 0xF;
    }
    return codes[r * row_bytes + f];
}

// The (slot tile, field tile) a block owns, its class range, and its bins
// zeroed in shared memory.
struct Tile {
    int s0, f0, st, ft, k0, k1, size;
};

__device__ __forceinline__ Tile start_tile(float* bins, int F, int K, int NN,
                                           int NB, int FT, int ST,
                                           int n_ftiles) {
    Tile t;
    t.s0 = (blockIdx.x / n_ftiles) * ST;
    t.f0 = (blockIdx.x % n_ftiles) * FT;
    t.st = min(ST, K * NN - t.s0);
    t.ft = min(FT, F - t.f0);
    t.k0 = t.s0 / NN;                    // classes whose slots meet the tile
    t.k1 = (t.s0 + t.st - 1) / NN;
    t.size = t.st * t.ft * NB * 2;
    for (int i = threadIdx.x; i < t.size; i += blockDim.x) bins[i] = 0.f;
    __syncthreads();
    return t;
}

// Blocks run in no order: each flushes its non-zero bins into the zeroed
// output with global float atomics.
__device__ __forceinline__ void flush_tile(const float* bins, const Tile& t,
                                           float* __restrict__ out, int F,
                                           int NB) {
    __syncthreads();
    for (int i = threadIdx.x; i < t.size; i += blockDim.x) {
        const float v = bins[i];
        if (v == 0.f) continue;
        const int s = i & 1;
        int q = i >> 1;
        const int bin = q % NB;
        q /= NB;
        const int fi = q % t.ft;
        const int sl = q / t.ft;
        const long long o =
            ((static_cast<long long>(t.s0 + sl) * F + t.f0 + fi) * NB + bin)
            * 2;
        atomicAdd(out + o + s, v);
    }
}

__global__ void hist_naive_kernel(const uint8_t* __restrict__ codes,
                                  const float* __restrict__ g,
                                  const float* __restrict__ h,
                                  const int32_t* __restrict__ node,
                                  float* __restrict__ out, long long n, int F,
                                  int K, int NN, int NB, int FT, int ST,
                                  int n_ftiles, long long chunk) {
    extern __shared__ float bins[];      // [st][ft * NB][2], flat per slot
    const Tile t = start_tile(bins, F, K, NN, NB, FT, ST, n_ftiles);
    const long long r0 = static_cast<long long>(blockIdx.y) * chunk;
    const long long r1 = min(n, r0 + chunk);
    for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
        const uint8_t* row = codes + r * F + t.f0;
        for (int k = t.k0; k <= t.k1; ++k) {
            const long long kr = static_cast<long long>(k) * n + r;
            const int nd = node[kr];
            if (nd < 0 || nd >= NN) continue;
            const int sl = k * NN + nd - t.s0;
            if (sl < 0 || sl >= t.st) continue;
            const float gv = g[kr], hv = h[kr];
            float* slot = bins + sl * t.ft * NB * 2;
            for (int fi = 0; fi < t.ft; ++fi) {   // the record's fields, in turn
                const int c = row[fi];
                if (c >= NB) continue;   // outside the binning invariant
                float* b = slot + ((fi * NB + c) << 1);
                atomicAdd(b, gv);
                atomicAdd(b + 1, hv);
            }
        }
    }
    flush_tile(bins, t, out, F, NB);
}

// -- the counting sort of (class, record) pairs by slot ---------------------

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int SORT_THREADS = 512;
constexpr int SCAN_THREADS = 1024;
constexpr int GROUPED_THREADS = 512;
constexpr int GROUPED_BLOCKS_PER_SM = 3;   // registers for three blocks an SM
constexpr int SORT_NODE_BYTES = 12;        // a node's base (8 B) and counter

// One pass of a block over its records [r0, r1) of one class: lanes whose
// records share a node form one group (__match_any_sync), whose first lane
// adds the group's size to the node's shared counter.  With ``order`` the
// pass also writes each record at base[node] + its rank in the block.
__device__ __forceinline__ void rank_pass(const int32_t* __restrict__ nk,
                                          long long r0, long long r1, int NN,
                                          unsigned* cnt,
                                          const unsigned long long* base,
                                          int32_t* __restrict__ order) {
    const int lane = threadIdx.x & 31;
    for (long long w = r0 + (threadIdx.x & ~31u); w < r1; w += blockDim.x) {
        const long long r = w + lane;
        const int nd = r < r1 ? nk[r] : -1;
        const int s = nd >= 0 && nd < NN ? nd : -1;   // others add nothing
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
// With SCATTER: totals holds each slot's next free position; reserve the
// chunk's run of every slot there, then write the record indices.
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
            base[i] = c ? atomicAdd(tk + i, c) : 0ull;
            cnt[i] = 0;
        }
    }
    if (!SCATTER) return;
    __syncthreads();
    rank_pass(nk, r0, r1, NN, cnt, base, order);
}

// One block: offsets = the exclusive scan of counts (S + 1 entries, the
// last the total), and cursor = offsets[:S], the scatter's first free
// positions.
__global__ void __launch_bounds__(SCAN_THREADS)
slot_scan_kernel(const unsigned long long* __restrict__ counts,
                 unsigned long long* __restrict__ offsets,
                 unsigned long long* __restrict__ cursor, int S) {
    __shared__ unsigned long long warp_total[SCAN_THREADS / 32];
    const int per = (S + blockDim.x - 1) / blockDim.x;
    const int lo = min(S, static_cast<int>(threadIdx.x) * per);
    const int hi = min(S, lo + per);
    unsigned long long sum = 0;
    for (int i = lo; i < hi; ++i) sum += counts[i];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned long long incl = sum;
    for (int d = 1; d < 32; d <<= 1) {
        const unsigned long long v = __shfl_up_sync(FULL_MASK, incl, d);
        if (lane >= d) incl += v;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
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
        offsets[i] = run;
        cursor[i] = run;
        run += counts[i];
    }
    if (threadIdx.x == blockDim.x - 1) offsets[S] = run;
}

// -- the grouped histogram over the sorted list ------------------------------

// Add the sorted positions [a, e) of one slot into the block's bins: the g
// sum of (field fi, code c) at bins[c * row + fi], the h sums `half` words
// on.  row is a multiple of 32, so lane l, on fields l, l + 32, ..., always
// hits bank l, whatever the codes are.  Without ``order`` (one slot)
// position p is record p, of node 0.
template <bool NIBBLE>
__device__ __forceinline__ void add_records(
        float* bins, const uint8_t* __restrict__ codes,
        const float* __restrict__ gk, const float* __restrict__ hk,
        const int32_t* __restrict__ node, const int32_t* __restrict__ order,
        long long a, long long e, int f0, int ft, int row_bytes, int NB,
        int row, int half) {
    const int lane = threadIdx.x & 31;
    const long long step = static_cast<long long>(blockDim.x);
    for (long long q = a + (threadIdx.x & ~31u); q < e; q += step) {
        // lane l fetches the record at position q + l and its g, h
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
        const int cnt = static_cast<int>(min(32ll, e - q));
        for (int j = 0; j < cnt; j += 4) {
            // the warp takes four records at a time, a lane per field
            int rr[4];
            float gg[4], hh[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                rr[u] = __shfl_sync(FULL_MASK, r, j + u);
                gg[u] = __shfl_sync(FULL_MASK, gv, j + u);
                hh[u] = __shfl_sync(FULL_MASK, hv, j + u);
            }
            for (int fi = lane; fi < ft; fi += 32) {
                int c[4];
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    c[u] = rr[u] >= 0
                               ? code_at<NIBBLE>(codes, rr[u], f0 + fi,
                                                 row_bytes)
                               : NB;
                float* b = bins + fi;
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    if (c[u] >= NB) continue;   // outside the binning invariant
                    // one add for this lane's records of equal code
                    float sg = gg[u], sh = hh[u];
#pragma unroll
                    for (int v = u + 1; v < 4; ++v) {
                        if (c[v] != c[u]) continue;
                        sg += gg[v];
                        sh += hh[v];
                        c[v] = NB;
                    }
                    atomicAdd(b + c[u] * row, sg);
                    atomicAdd(b + half + c[u] * row, sh);
                }
            }
        }
    }
}

// Add the block's bins of one slot into the output with global float
// atomics (non-zero bins only, consecutive threads on consecutive output
// words) and zero them for the next slot.
__device__ __forceinline__ void flush_slot(float* bins,
                                           float* __restrict__ out_slot,
                                           int ft, int NB, int row,
                                           int half) {
    for (int i = threadIdx.x; i < ft * NB; i += blockDim.x) {
        const int fi = i / NB;
        float* b = bins + (i - fi * NB) * row + fi;
        const float vg = b[0], vh = b[half];
        if (vg != 0.f) atomicAdd(out_slot + 2 * i, vg);
        if (vh != 0.f) atomicAdd(out_slot + 2 * i + 1, vh);
        b[0] = 0.f;
        b[half] = 0.f;
    }
}

// blockIdx.y = field tile, blockIdx.x = a share of per_block positions of
// the sorted list (every share the same size, whatever the slots' sizes).
template <bool NIBBLE>
__global__ void __launch_bounds__(GROUPED_THREADS, GROUPED_BLOCKS_PER_SM)
hist_grouped_kernel(const uint8_t* __restrict__ codes,
                    const float* __restrict__ g, const float* __restrict__ h,
                    const int32_t* __restrict__ node,
                    const int32_t* __restrict__ order,
                    const unsigned long long* __restrict__ offsets,
                    float* __restrict__ out, long long n, int F,
                    int row_bytes, int NN, int S, int NB, int FT, int row,
                    long long per_block) {
    extern __shared__ float bins[];      // [2][NB][row]: g, then h sums
    const int half = NB * row;
    const int f0 = blockIdx.y * FT;
    const int ft = min(FT, F - f0);
    const long long total =
        order != nullptr ? static_cast<long long>(offsets[S]) : n;
    long long p = static_cast<long long>(blockIdx.x) * per_block;
    const long long p_end = min(total, p + per_block);
    if (p >= p_end) return;
    for (int i = threadIdx.x; i < 2 * half; i += blockDim.x) bins[i] = 0.f;
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
        const long long kn = static_cast<long long>(s / NN) * n;
        add_records<NIBBLE>(bins, codes, g + kn, h + kn, node, order, p, e,
                            f0, ft, row_bytes, NB, row, half);
        __syncthreads();
        flush_slot(bins, out + (static_cast<long long>(s) * F + f0) * NB * 2,
                   ft, NB, row, half);
        __syncthreads();
        p = e;
    }
}

// The grid and shared memory of one launch: blockIdx.x = (slot tile, field
// tile), blockIdx.y = record chunk.
template <typename Kernel>
static cudaError_t configure(Kernel kernel, int F, int K, int NN, int NB,
                             int FT, int ST, int n_chunks, dim3* grid,
                             int* smem, int* n_ftiles) {
    *n_ftiles = (F + FT - 1) / FT;
    const int n_stiles = (K * NN + ST - 1) / ST;
    *smem = FT * ST * NB * 2 * static_cast<int>(sizeof(float));
    *grid = dim3(*n_ftiles * n_stiles, n_chunks);
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

// The counting sort (skipped when order is null: one slot), then the
// histogram.  slots: 3 * S + 1 zeroed uint64 — counts, offsets, cursor.
template <bool NIBBLE>
static int launch_grouped(const void* codes, const void* g, const void* h,
                          const void* node, void* order, void* slots,
                          void* out, long long n, int F, int row_bytes, int K,
                          int NN, int NB, int FT, int row, int n_ftiles,
                          int blocks, long long per_block, int sort_blocks,
                          long long sort_chunk, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int S = K * NN;
    auto* counts = static_cast<unsigned long long*>(slots);
    const int32_t* nodes = static_cast<const int32_t*>(node);
    int32_t* ord = static_cast<int32_t*>(order);
    cudaError_t err;
    if (ord != nullptr) {
        const int sort_smem = NN * SORT_NODE_BYTES;
        err = cudaFuncSetAttribute(slot_sort_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   sort_smem);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                slot_sort_kernel<true>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, sort_smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        const dim3 grid(sort_blocks, K);
        slot_sort_kernel<false><<<grid, SORT_THREADS, sort_smem, st>>>(
            nodes, n, NN, sort_chunk, counts, nullptr);
        slot_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(
            counts, counts + S, counts + 2 * S + 1, S);
        slot_sort_kernel<true><<<grid, SORT_THREADS, sort_smem, st>>>(
            nodes, n, NN, sort_chunk, counts + 2 * S + 1, ord);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int smem = 2 * NB * row * static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(hist_grouped_kernel<NIBBLE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    hist_grouped_kernel<NIBBLE><<<dim3(blocks, n_ftiles), GROUPED_THREADS,
                                  smem, st>>>(
        static_cast<const uint8_t*>(codes), static_cast<const float*>(g),
        static_cast<const float*>(h), nodes, ord, counts + S,
        static_cast<float*>(out), n, F, row_bytes, NN, S, NB, FT, row,
        per_block);
    return static_cast<int>(cudaGetLastError());
}

// What sizes a grouped launch on ``device`` (kernels/histogram.py,
// GroupedLimits): out[0..5] = the blocks an SM the grouped kernel's launch
// bounds allow, the sort's shared bytes a node, then the card's SMs, shared
// memory an SM, what the runtime keeps of it for every block, and the most
// dynamic shared memory a block may opt into.
extern "C" int hist_grouped_limits(int device, int* out) {
    out[0] = GROUPED_BLOCKS_PER_SM;
    out[1] = SORT_NODE_BYTES;
    const cudaDeviceAttr attrs[] = {
        cudaDevAttrMultiProcessorCount,
        cudaDevAttrMaxSharedMemoryPerMultiprocessor,
        cudaDevAttrReservedSharedMemoryPerBlock,
        cudaDevAttrMaxSharedMemoryPerBlockOptin};
    for (int i = 0; i < 4; ++i) {
        const cudaError_t err = cudaDeviceGetAttribute(out + 2 + i, attrs[i],
                                                       device);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

extern "C" int hist_grouped_launch(const void* codes, const void* g,
                                   const void* h, const void* node,
                                   void* order, void* slots, void* out,
                                   long long n, int F, int K, int NN, int NB,
                                   int FT, int row, int n_ftiles,
                                   int blocks, long long per_block,
                                   int sort_blocks, long long sort_chunk,
                                   void* stream) {
    return launch_grouped<false>(codes, g, h, node, order, slots, out, n, F,
                                 F, K, NN, NB, FT, row, n_ftiles, blocks,
                                 per_block, sort_blocks, sort_chunk, stream);
}

// codes: the (n, ceil(F/2)) packed bytes of PackedCodes.data
extern "C" int hist_nibble_launch(const void* codes, const void* g,
                                  const void* h, const void* node,
                                  void* order, void* slots, void* out,
                                  long long n, int F, int K, int NN, int NB,
                                  int FT, int row, int n_ftiles,
                                  int blocks, long long per_block,
                                  int sort_blocks, long long sort_chunk,
                                  void* stream) {
    return launch_grouped<true>(codes, g, h, node, order, slots, out, n, F,
                                (F + 1) / 2, K, NN, NB, FT, row, n_ftiles,
                                blocks, per_block, sort_blocks, sort_chunk,
                                stream);
}

extern "C" int hist_naive_launch(const void* codes, const void* g,
                                 const void* h, const void* node, void* out,
                                 long long n, int F, int K, int NN, int NB,
                                 int FT, int ST, int n_chunks,
                                 long long chunk, int threads, void* stream) {
    dim3 grid;
    int smem, n_ftiles;
    cudaError_t err = configure(hist_naive_kernel, F, K, NN, NB, FT, ST,
                                n_chunks, &grid, &smem, &n_ftiles);
    if (err != cudaSuccess) return static_cast<int>(err);
    hist_naive_kernel<<<grid, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes), static_cast<const float*>(g),
        static_cast<const float*>(h), static_cast<const int32_t*>(node),
        static_cast<float*>(out), n, F, K, NN, NB, FT, ST, n_ftiles, chunk);
    return static_cast<int>(cudaGetLastError());
}
