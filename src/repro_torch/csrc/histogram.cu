// Step ① — gradient-statistics histogram, grouped by field.
//
// Replaces the TPU kernels src/repro/kernels/histogram.py::_hist_kernel_grouped
// (with its helper _stats_node, including its class axis, and its
// nibble_packed branch) and ::_hist_kernel_packed (below).  The TPU version
// turned the scatter hist[slot, f, bin] += (g, h) into a one-hot matrix
// product on the MXU; on Hopper that product would run on the tensor cores in
// TF32 and truncate g and h, so this kernel does what the paper's hardware
// does instead: every (slot, field) pair owns its own NB-bin array of (g, h)
// sums in shared memory (NB = 256 bins x 2 stats x 4 B = the paper's 2 KB
// SRAM per field).
//
// Slots.  Multi-class boosting grows K trees per round, each with its own
// node partition of the same records.  A slot is a (class, node) pair,
// class-major: slot = k * NN + node[k, r], K * NN slots in all; the output
// (K*NN, F, NB, 2) is (K, NN, F, NB, 2).  As on the TPU (_stats_node), one
// read of a record's code byte serves every class: the thread adds
// (g[k, r], h[k, r]) into each class's slot that lies in its block's tile.
// K = 1 is the single-class histogram.
//
// Bound on the H100: bytes.  The codes (n*F bytes) and K*12 bytes of g, h
// and node id per record must be read; the arithmetic is 2*K float adds per
// (record, field).  Design:
//   * blockIdx.x picks a tile of (slot, field) pairs whose bins fit in
//     dynamic shared memory (the wrapper sizes it, <= ~192 KB); the slot
//     axis is tiled, so every depth up to 10 and every K works (K = 7 at
//     NN = 32 is 224 slots, 448 KB per field).  A block visits only the
//     classes whose slots meet its tile and skips records whose slot lies
//     outside it.  A tile of one class's slots (every tile at K = 1) takes
//     a loop of its own that reads the node id before the code byte.
//   * blockIdx.y picks a chunk of records; the block's threads stride over
//     (record, field) pairs of the chunk and accumulate with shared-memory
//     float atomics.
//   * Blocks run in no order (the TPU grid carried its sum from step to
//     step), so each block flushes its non-zero bins into the zeroed output
//     with global float atomics: the cross-block reduction is explicit.
//   * The ragged record edge is masked here; nothing is padded.
// Float atomics reorder the sums from run to run: results are bit-equal to
// the plain version only when every partial sum is exact (dyadic g, h).
//
// 4-bit codes (the nibble_packed=True branch of _hist_kernel_grouped).  With
// n_bins <= 16 the row-major copy holds two codes a byte, Fb = ceil(F/2)
// bytes a record, the low nibble the even field; an odd F leaves one pad
// nibble a record, which no field index reaches.  The same kernel body reads
// the code of (record r, field f) through code_at<NIBBLE>: byte
// codes[r * Fb + (f >> 1)], shifted by (f & 1) * 4.  Field tiles are
// addressed by global field index, so a tile may start on an odd field (the
// TPU version had to widen its field block to whole bytes).  Halving the
// code bytes halves the byte bound; the shared-memory atomics stay.
//
// Naive packing (hist_naive_kernel, the Fig. 9 ablation twin of
// _hist_kernel_packed).  The same tiles and the same flat [slot][field][bin]
// array in shared memory, but each thread takes whole records and adds the
// record's tile fields one after another, as a record's fields behind one
// SRAM port serialise in the paper's naive packing; the grouped kernel's
// consecutive threads take consecutive (record, field) pairs instead.
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

template <bool NIBBLE>
__global__ void hist_grouped_kernel(const uint8_t* __restrict__ codes,
                                    const float* __restrict__ g,
                                    const float* __restrict__ h,
                                    const int32_t* __restrict__ node,
                                    float* __restrict__ out,
                                    long long n, int F, int row_bytes, int K,
                                    int NN, int NB, int FT, int ST,
                                    int n_ftiles, long long chunk) {
    extern __shared__ float bins[];      // [st][ft][NB][2]
    const Tile t = start_tile(bins, F, K, NN, NB, FT, ST, n_ftiles);
    const int s0 = t.s0, f0 = t.f0, st = t.st, ft = t.ft;
    const int k0 = t.k0, k1 = t.k1;

    const long long r0 = static_cast<long long>(blockIdx.y) * chunk;
    const long long r1 = min(n, r0 + chunk);
    const long long total = (r1 - r0) * ft;
    if (k0 == k1) {
        // The tile holds one class's slots (always so at K = 1): read the
        // record's node id first and skip its code byte when the slot lies
        // outside the tile.
        const long long kn = static_cast<long long>(k0) * n;
        const int32_t* nk = node + kn;
        const float* gk = g + kn;
        const float* hk = h + kn;
        const int lo = s0 - k0 * NN;     // the tile's first node of class k0
        for (long long i = threadIdx.x; i < total; i += blockDim.x) {
            const long long r = r0 + i / ft;
            const int fi = static_cast<int>(i % ft);
            const int sl = nk[r] - lo;
            if (sl < 0 || sl >= st) continue;
            const int c = code_at<NIBBLE>(codes, r, f0 + fi, row_bytes);
            if (c >= NB) continue;       // outside the binning invariant
            float* b = bins + (((sl * ft + fi) * NB + c) << 1);
            atomicAdd(b, gk[r]);
            atomicAdd(b + 1, hk[r]);
        }
    } else {
        for (long long i = threadIdx.x; i < total; i += blockDim.x) {
            const long long r = r0 + i / ft;
            const int fi = static_cast<int>(i % ft);
            const int c = code_at<NIBBLE>(codes, r, f0 + fi, row_bytes);
            if (c >= NB) continue;       // outside the binning invariant
            for (int k = k0; k <= k1; ++k) {
                const long long kr = static_cast<long long>(k) * n + r;
                const int nd = node[kr];
                if (nd < 0 || nd >= NN) continue;
                const int sl = k * NN + nd - s0;
                if (sl < 0 || sl >= st) continue;
                float* b = bins + (((sl * ft + fi) * NB + c) << 1);
                atomicAdd(b, g[kr]);
                atomicAdd(b + 1, h[kr]);
            }
        }
    }
    flush_tile(bins, t, out, F, NB);
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

template <bool NIBBLE>
static int launch_grouped(const void* codes, const void* g, const void* h,
                          const void* node, void* out, long long n, int F,
                          int row_bytes, int K, int NN, int NB, int FT, int ST,
                          int n_chunks, long long chunk, int threads,
                          void* stream) {
    dim3 grid;
    int smem, n_ftiles;
    cudaError_t err = configure(hist_grouped_kernel<NIBBLE>, F, K, NN, NB, FT,
                                ST, n_chunks, &grid, &smem, &n_ftiles);
    if (err != cudaSuccess) return static_cast<int>(err);
    hist_grouped_kernel<NIBBLE><<<grid, threads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes), static_cast<const float*>(g),
        static_cast<const float*>(h), static_cast<const int32_t*>(node),
        static_cast<float*>(out), n, F, row_bytes, K, NN, NB, FT, ST,
        n_ftiles, chunk);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int hist_grouped_launch(const void* codes, const void* g,
                                   const void* h, const void* node, void* out,
                                   long long n, int F, int K, int NN, int NB,
                                   int FT, int ST, int n_chunks,
                                   long long chunk, int threads,
                                   void* stream) {
    return launch_grouped<false>(codes, g, h, node, out, n, F, F, K, NN, NB,
                                 FT, ST, n_chunks, chunk, threads, stream);
}

// codes: the (n, ceil(F/2)) packed bytes of PackedCodes.data
extern "C" int hist_nibble_launch(const void* codes, const void* g,
                                  const void* h, const void* node, void* out,
                                  long long n, int F, int K, int NN, int NB,
                                  int FT, int ST, int n_chunks,
                                  long long chunk, int threads,
                                  void* stream) {
    return launch_grouped<true>(codes, g, h, node, out, n, F, (F + 1) / 2, K,
                                NN, NB, FT, ST, n_chunks, chunk, threads,
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
