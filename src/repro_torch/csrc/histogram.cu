// Step ① — gradient-statistics histogram, grouped by field.
//
// Replaces the TPU kernel src/repro/kernels/histogram.py::_hist_kernel_grouped
// (with its helper _stats_node, including its class axis).  The TPU version
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
#include "launch.cuh"

__global__ void hist_grouped_kernel(const uint8_t* __restrict__ codes,
                                    const float* __restrict__ g,
                                    const float* __restrict__ h,
                                    const int32_t* __restrict__ node,
                                    float* __restrict__ out,
                                    long long n, int F, int K, int NN, int NB,
                                    int FT, int ST, int n_ftiles,
                                    long long chunk) {
    extern __shared__ float bins[];      // [st][ft][NB][2]
    const int s0 = (blockIdx.x / n_ftiles) * ST;
    const int f0 = (blockIdx.x % n_ftiles) * FT;
    const int st = min(ST, K * NN - s0);
    const int ft = min(FT, F - f0);
    const int k0 = s0 / NN;              // classes whose slots meet the tile
    const int k1 = (s0 + st - 1) / NN;
    const int size = st * ft * NB * 2;
    for (int i = threadIdx.x; i < size; i += blockDim.x) bins[i] = 0.f;
    __syncthreads();

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
            const int c = codes[r * F + f0 + fi];
            if (c >= NB) continue;       // outside the binning invariant
            float* b = bins + (((sl * ft + fi) * NB + c) << 1);
            atomicAdd(b, gk[r]);
            atomicAdd(b + 1, hk[r]);
        }
    } else {
        for (long long i = threadIdx.x; i < total; i += blockDim.x) {
            const long long r = r0 + i / ft;
            const int fi = static_cast<int>(i % ft);
            const int c = codes[r * F + f0 + fi];
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
    __syncthreads();

    for (int i = threadIdx.x; i < size; i += blockDim.x) {
        const float v = bins[i];
        if (v == 0.f) continue;
        const int s = i & 1;
        int t = i >> 1;
        const int bin = t % NB;
        t /= NB;
        const int fi = t % ft;
        const int sl = t / ft;
        const long long o =
            ((static_cast<long long>(s0 + sl) * F + f0 + fi) * NB + bin) * 2;
        atomicAdd(out + o + s, v);
    }
}

extern "C" int hist_grouped_launch(const void* codes, const void* g,
                                   const void* h, const void* node, void* out,
                                   long long n, int F, int K, int NN, int NB,
                                   int FT, int ST, int n_chunks,
                                   long long chunk, int threads,
                                   void* stream) {
    const int n_ftiles = (F + FT - 1) / FT;
    const int n_stiles = (K * NN + ST - 1) / ST;
    const int smem = FT * ST * NB * 2 * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        hist_grouped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(n_ftiles * n_stiles, n_chunks);
    hist_grouped_kernel<<<grid, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes), static_cast<const float*>(g),
        static_cast<const float*>(h), static_cast<const int32_t*>(node),
        static_cast<float*>(out), n, F, K, NN, NB, FT, ST, n_ftiles, chunk);
    return static_cast<int>(cudaGetLastError());
}
