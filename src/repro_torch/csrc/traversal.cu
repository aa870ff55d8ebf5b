// Step ⑤ (one-tree traversal) and batch inference (ensemble walk).
//
// Replace the TPU kernels src/repro/kernels/traversal.py::_traverse_kernel
// and ::_ensemble_kernel (both via _walk_levels).  A node is one packed
// int32 word ((feature+1) << 16) | (thr << 8) | (is_cat << 1) | default_left
// (pack_node_table), children are implicit (2*node + 2 - go_left), and a
// depth-D walk is D dependent hops.  In shared memory each tree is laid out
// as [node words | leaf values], so the node index a walk ends on is also
// the index of its leaf value.
//
// traverse_launch — one tree, one thread per record.  Bound on the H100:
// bytes (each record's code row is read, one float written); the table and
// leaves (63 + 64 words at depth 6) sit in shared memory.
//
// ensemble_launch — the sum over T trees, one thread per record.  Blocks of
// TB trees are staged in shared memory in turn (each block of records reads
// every tree once per tree block); leaves sum in a register in tree order.
// Bound on the H100: operations, not bytes — n*T*D dependent hops (3e10 at
// n = 10M, T = 500, D = 6) against one pass over the codes.  Trees whose
// node words all carry feature -1 and whose leaves are zero (padding) add
// exactly 0.
#include "launch.cuh"

__device__ __forceinline__ int walk(const uint8_t* __restrict__ row,
                                    const int* __restrict__ tree, int depth,
                                    int missing_bin) {
    int node = 0;
    for (int d = 0; d < depth; ++d) {
        const int p = tree[node];
        const int f = (p >> 16) - 1;
        const int code = f >= 0 ? row[f] : 0;
        const int left = go_left_of(code, f, (p >> 8) & 255, (p >> 1) & 1,
                                    p & 1, missing_bin);
        node = 2 * node + 2 - left;
    }
    return node;
}

__global__ void traverse_kernel(const uint8_t* __restrict__ codes,
                                const int32_t* __restrict__ table,
                                const float* __restrict__ leaves,
                                float* __restrict__ out, long long n, int C,
                                int depth, int missing_bin) {
    extern __shared__ int tree[];        // [n_int node words | n_leaf leaves]
    const int n_int = (1 << depth) - 1;
    for (int i = threadIdx.x; i < n_int; i += blockDim.x) tree[i] = table[i];
    for (int i = threadIdx.x; i <= n_int; i += blockDim.x)
        tree[n_int + i] = __float_as_int(leaves[i]);
    __syncthreads();
    const long long r = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    if (r >= n) return;
    out[r] = __int_as_float(tree[walk(codes + r * C, tree, depth,
                                      missing_bin)]);
}

__global__ void ensemble_kernel(const uint8_t* __restrict__ codes,
                                const int32_t* __restrict__ tables,
                                const float* __restrict__ leaves,
                                float* __restrict__ out, long long n, int F,
                                int T, int depth, int missing_bin, int TB) {
    extern __shared__ int trees[];       // TB x [node words | leaves]
    const int n_int = (1 << depth) - 1;
    const int n_leaf = n_int + 1;
    const int words = n_int + n_leaf;
    const long long r = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    const bool live = r < n;
    const uint8_t* row = codes + (live ? r : 0) * F;
    float acc = 0.f;
    for (int t0 = 0; t0 < T; t0 += TB) {
        const int tb = min(TB, T - t0);
        __syncthreads();                 // previous tree block fully walked
        for (int i = threadIdx.x; i < tb * words; i += blockDim.x) {
            const long long t = t0 + i / words;
            const int w = i % words;
            trees[i] = w < n_int ? tables[t * n_int + w]
                                 : __float_as_int(leaves[t * n_leaf + w - n_int]);
        }
        __syncthreads();
        if (live) {
            for (int t = 0; t < tb; ++t) {
                const int* tree = trees + t * words;
                acc += __int_as_float(tree[walk(row, tree, depth,
                                                missing_bin)]);
            }
        }
    }
    if (live) out[r] = acc;
}

static int blocks_for(long long n, int threads) {
    return static_cast<int>((n + threads - 1) / threads);
}

extern "C" int traverse_launch(const void* codes, const void* table,
                               const void* leaves, void* out, long long n,
                               int C, int depth, int missing_bin, int threads,
                               void* stream) {
    const int smem = ((2 << depth) - 1) * static_cast<int>(sizeof(int));
    traverse_kernel<<<blocks_for(n, threads), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes),
        static_cast<const int32_t*>(table), static_cast<const float*>(leaves),
        static_cast<float*>(out), n, C, depth, missing_bin);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int ensemble_launch(const void* codes, const void* tables,
                               const void* leaves, void* out, long long n,
                               int F, int T, int depth, int missing_bin,
                               int TB, int threads, void* stream) {
    const int smem = TB * ((2 << depth) - 1) * static_cast<int>(sizeof(int));
    ensemble_kernel<<<blocks_for(n, threads), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes),
        static_cast<const int32_t*>(tables), static_cast<const float*>(leaves),
        static_cast<float*>(out), n, F, T, depth, missing_bin, TB);
    return static_cast<int>(cudaGetLastError());
}
