// Step ① — gradient-statistics histogram, grouped by field.
//
// Replaces the TPU kernel src/repro/kernels/histogram.py::_hist_kernel_grouped
// (with its helper _stats_node).  The TPU version turned the scatter
// hist[node, f, bin] += (g, h) into a one-hot matrix product on the MXU; on
// Hopper that product would run on the tensor cores in TF32 and truncate
// g and h, so this kernel does what the paper's hardware does instead: every
// (node, field) pair owns its own NB-bin array of (g, h) sums in shared
// memory (NB = 256 bins x 2 stats x 4 B = the paper's 2 KB SRAM per field).
//
// Bound on the H100: bytes.  Each record is read once per field tile
// (n*F code bytes plus 12 bytes of g, h and node id), and the arithmetic is
// two float adds per (record, field).  Design:
//   * blockIdx.x picks a tile of (node, field) pairs whose bins fit in
//     dynamic shared memory (the wrapper sizes it, <= ~192 KB); the node
//     axis is tiled too, so every depth up to 10 (512 nodes, 1 MB per
//     field) works.  A record whose node lies outside the tile is skipped.
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
                                    long long n, int F, int NN, int NB,
                                    int FT, int NT, int n_ftiles,
                                    long long chunk) {
    extern __shared__ float bins[];      // [nt][ft][NB][2]
    const int n0 = (blockIdx.x / n_ftiles) * NT;
    const int f0 = (blockIdx.x % n_ftiles) * FT;
    const int nt = min(NT, NN - n0);
    const int ft = min(FT, F - f0);
    const int size = nt * ft * NB * 2;
    for (int i = threadIdx.x; i < size; i += blockDim.x) bins[i] = 0.f;
    __syncthreads();

    const long long r0 = static_cast<long long>(blockIdx.y) * chunk;
    const long long r1 = min(n, r0 + chunk);
    const long long total = (r1 - r0) * ft;
    for (long long i = threadIdx.x; i < total; i += blockDim.x) {
        const long long r = r0 + i / ft;
        const int fi = static_cast<int>(i % ft);
        const int nd = node[r] - n0;
        if (nd < 0 || nd >= nt) continue;
        const int c = codes[r * F + f0 + fi];
        if (c >= NB) continue;           // outside the binning invariant
        float* b = bins + (((nd * ft + fi) * NB + c) << 1);
        atomicAdd(b, g[r]);
        atomicAdd(b + 1, h[r]);
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
        const int nd = t / ft;
        const long long o =
            ((static_cast<long long>(n0 + nd) * F + f0 + fi) * NB + bin) * 2;
        atomicAdd(out + o + s, v);
    }
}

extern "C" int hist_grouped_launch(const void* codes, const void* g,
                                   const void* h, const void* node, void* out,
                                   long long n, int F, int NN, int NB, int FT,
                                   int NT, int n_chunks, long long chunk,
                                   int threads, void* stream) {
    const int n_ftiles = (F + FT - 1) / FT;
    const int n_ntiles = (NN + NT - 1) / NT;
    const int smem = FT * NT * NB * 2 * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        hist_grouped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(n_ftiles * n_ntiles, n_chunks);
    hist_grouped_kernel<<<grid, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes), static_cast<const float*>(g),
        static_cast<const float*>(h), static_cast<const int32_t*>(node),
        static_cast<float*>(out), n, F, NN, NB, FT, NT, n_ftiles, chunk);
    return static_cast<int>(cudaGetLastError());
}
