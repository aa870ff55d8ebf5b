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
// traverse_launch — one round's K class trees (K = 1: one tree), one
// thread per (record, class), the class as blockIdx.y; each block stages its
// class's tree.  The TPU build vmaps _traverse_kernel over the classes
// (src/repro/core/gbdt.py:803-807).  Codes are shared by every class
// (class stride 0) or one (n, C) block per class (the renumbered-column
// fetch).  Output (n, K).  Bound on the H100: bytes (each record's code row
// is read, K floats written); the table and leaves (63 + 64 words at depth
// 6) sit in shared memory.
//
// ensemble_launch — the sum over T trees, one thread per record.  Blocks of
// TB trees are staged in shared memory in turn (each block of records reads
// every tree once per tree block).  Trees are stacked round-major: tree t
// adds into margin column t % K, with t the global tree index (a staged
// block need not start at a class boundary).  The thread owns its output
// row, so no atomics are needed: per staged block it makes one pass per
// class over that class's trees, summing in one register in tree order and
// carrying the sum across blocks in its own output element (a per-thread
// float acc[K] indexed by a runtime class would sit in local memory).
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
                                const int32_t* __restrict__ tables,
                                const float* __restrict__ leaves,
                                float* __restrict__ out, long long n, int C,
                                int K, long long class_stride, int depth,
                                int missing_bin) {
    extern __shared__ int tree[];        // [n_int node words | n_leaf leaves]
    const int k = blockIdx.y;            // class
    const int n_int = (1 << depth) - 1;
    const int32_t* table = tables + static_cast<long long>(k) * n_int;
    const float* leaf = leaves + static_cast<long long>(k) * (n_int + 1);
    for (int i = threadIdx.x; i < n_int; i += blockDim.x) tree[i] = table[i];
    for (int i = threadIdx.x; i <= n_int; i += blockDim.x)
        tree[n_int + i] = __float_as_int(leaf[i]);
    __syncthreads();
    const long long r = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    if (r >= n) return;
    const uint8_t* row = codes + k * class_stride + r * C;
    out[r * K + k] = __int_as_float(tree[walk(row, tree, depth, missing_bin)]);
}

__global__ void ensemble_kernel(const uint8_t* __restrict__ codes,
                                const int32_t* __restrict__ tables,
                                const float* __restrict__ leaves,
                                float* __restrict__ out, long long n, int F,
                                int T, int K, int depth, int missing_bin,
                                int TB) {
    extern __shared__ int trees[];       // TB x [node words | leaves]
    const int n_int = (1 << depth) - 1;
    const int n_leaf = n_int + 1;
    const int words = n_int + n_leaf;
    const long long r = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    const bool live = r < n;
    const uint8_t* row = codes + (live ? r : 0) * F;
    float* o = out + (live ? r : 0) * K;  // zeroed by the wrapper
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
        if (!live) continue;
        for (int c = 0; c < K; ++c) {
            // first staged tree of class c: (t0 + t) % K == c
            const int first = ((c - t0 % K) + K) % K;
            if (first >= tb) continue;
            float acc = o[c];
            for (int t = first; t < tb; t += K) {
                const int* tree = trees + t * words;
                acc += __int_as_float(tree[walk(row, tree, depth,
                                                missing_bin)]);
            }
            o[c] = acc;
        }
    }
}

static int blocks_for(long long n, int threads) {
    return static_cast<int>((n + threads - 1) / threads);
}

extern "C" int traverse_launch(const void* codes, const void* tables,
                               const void* leaves, void* out, long long n,
                               int C, int K, long long class_stride,
                               int depth, int missing_bin, int threads,
                               void* stream) {
    const int smem = ((2 << depth) - 1) * static_cast<int>(sizeof(int));
    const dim3 grid(blocks_for(n, threads), K);
    traverse_kernel<<<grid, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes),
        static_cast<const int32_t*>(tables),
        static_cast<const float*>(leaves), static_cast<float*>(out), n, C, K,
        class_stride, depth, missing_bin);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int ensemble_launch(const void* codes, const void* tables,
                               const void* leaves, void* out, long long n,
                               int F, int T, int K, int depth,
                               int missing_bin, int TB, int threads,
                               void* stream) {
    const int smem = TB * ((2 << depth) - 1) * static_cast<int>(sizeof(int));
    ensemble_kernel<<<blocks_for(n, threads), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes),
        static_cast<const int32_t*>(tables), static_cast<const float*>(leaves),
        static_cast<float*>(out), n, F, T, K, depth, missing_bin, TB);
    return static_cast<int>(cudaGetLastError());
}
