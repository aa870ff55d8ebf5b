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
// ensemble_launch — the sum over T trees.  Bound on the H100: operations,
// not bytes — n*T*D dependent hops (3e10 at n = 10M, T = 500, D = 6)
// against one pass over the codes.  So the design makes a hop cheap:
//   * A block owns R = U * blockDim records and first stages their code
//     rows in shared memory, read once from global memory, as 32-bit words
//     of 4 consecutive fields of one record: word (f >> 2) * R + r, byte
//     f & 3 (F padded to a multiple of 4; the pad bytes are never read, as
//     field ids are checked < F).  R is a multiple of 32, so the lanes of a
//     warp, which walk consecutive records, hit bank r mod 32 whatever
//     fields they want: a hop is two conflict-free shared loads (node word,
//     code word) and the integer decision of go_left_of, not a gather over
//     ~7 L1 lines as a global read of row[f] is.  The decision is written
//     without branches (goes_left): go_left_of's early returns compile to
//     divergent branches that cost more than the loads.
//   * A thread walks U records, interleaved hop by hop over the same tree:
//     U independent chains of dependent loads hide each other's latency,
//     and a block covers U times the records for every tree it stages.
//   * The walk is unrolled over the depth (a template, 1..10).
//   * Blocks of TB trees are staged behind the codes in turn (each block of
//     records reads every tree once per tree block).  Trees are stacked
//     round-major: tree t adds into margin column t % K, with t the global
//     tree index (a staged block need not start at a class boundary).
// Each thread owns its records' output rows, so no atomics are needed: per
// staged block it makes one pass per class over that class's trees, summing
// each record in one register in tree order and carrying the sum across
// blocks in its own output element (a per-thread float acc[K] indexed by a
// runtime class would sit in local memory).  The sum order is that of one
// record a thread, so the output does not depend on U, R or TB.  Trees
// whose node words all carry feature -1 and whose leaves are zero (padding)
// add exactly 0.
//
// Code rows that do not fit — 32 records of ceil(F/4)*4 bytes plus one tree
// past a block's shared memory (F in the thousands) — take the wide entry,
// the same body reading row[f] from global memory, one record a thread
// (ensemble_kernel<D, 1, false>).  kernels/traversal.py:ensemble_geometry
// chooses the entry, R and TB from ensemble_limits before the launch.
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

constexpr int ENSEMBLE_THREADS = 256;           // threads a block at most
constexpr int ENSEMBLE_RECORDS_PER_THREAD = 2;  // U of the staged entry
constexpr int ENSEMBLE_BLOCKS_PER_SM = 4;       // registers for four blocks

// Stage the block's ``live`` code rows as words [(f >> 2) * R + r].  Each
// 32 consecutive threads copy a tile of 4 records x 8 bytes at a time: the
// global reads touch 4 row segments, the byte stores 4 banks (2 words
// each), so neither side is a 32-way gather or conflict.
__device__ __forceinline__ void stage_rows(const uint8_t* __restrict__ codes,
                                           uint8_t* staged, long long r0,
                                           int live, int F, int R) {
    for (int i = threadIdx.x; i < ((live + 3) >> 2) * 32; i += blockDim.x) {
        const int r = (i >> 5) * 4 + ((i >> 3) & 3);
        if (r >= live) continue;
        const uint8_t* src = codes + (r0 + r) * F;
        for (int f = i & 7; f < F; f += 8)
            staged[((f >> 2) * R + r) * 4 + (f & 3)] = src[f];
    }
}

// go_left_of's decision written without branches, so that a warp never
// splits at a node and the U records' hops interleave: 1 (left) or 0 for
// the packed node word p (feature (p >> 16) - 1, -1: pass-through, left).
__device__ __forceinline__ int goes_left(int p, int code, int missing_bin) {
    const int thr = (p >> 8) & 255;
    const int cmp = (p & 2) ? code == thr : code <= thr;
    const int decided = code == missing_bin ? (p & 1) : cmp;
    return (p < 0x10000) | decided;
}

template <int DEPTH, int U, bool STAGED>
__global__ void __launch_bounds__(ENSEMBLE_THREADS, ENSEMBLE_BLOCKS_PER_SM)
ensemble_kernel(const uint8_t* __restrict__ codes,
                const int32_t* __restrict__ tables,
                const float* __restrict__ leaves, float* __restrict__ out,
                long long n, int F, int T, int K, int missing_bin, int TB) {
    // STAGED: [ceil(F/4) x R code words | TB x [node words | leaves]]
    extern __shared__ int smem[];
    constexpr int n_int = (1 << DEPTH) - 1;
    constexpr int words = 2 * n_int + 1;
    const int R = U * blockDim.x;
    const long long r0 = static_cast<long long>(blockIdx.x) * R;
    const int live = static_cast<int>(min(static_cast<long long>(R), n - r0));
    const uint32_t* rows = reinterpret_cast<const uint32_t*>(smem);
    int* trees = smem + (STAGED ? ((F + 3) >> 2) * R : 0);
    if (STAGED)
        stage_rows(codes, reinterpret_cast<uint8_t*>(smem), r0, live, F, R);
    int slot[U];
    const uint8_t* row[U];
    float* o[U];                          // zeroed by the wrapper
#pragma unroll
    for (int u = 0; u < U; ++u) {
        slot[u] = u * blockDim.x + threadIdx.x;
        const long long r = slot[u] < live ? r0 + slot[u] : 0;
        row[u] = codes + r * F;
        o[u] = out + r * K;
    }
    for (int t0 = 0; t0 < T; t0 += TB) {
        const int tb = min(TB, T - t0);
        __syncthreads();                 // codes staged, or the previous
                                         // tree block fully walked
        for (int i = threadIdx.x; i < tb * words; i += blockDim.x) {
            const long long t = t0 + i / words;
            const int w = i % words;
            trees[i] = w < n_int ? tables[t * n_int + w]
                                 : __float_as_int(leaves[t * (n_int + 1)
                                                         + w - n_int]);
        }
        __syncthreads();
        for (int c = 0; c < K; ++c) {
            // first staged tree of class c: (t0 + t) % K == c
            const int first = ((c - t0 % K) + K) % K;
            if (first >= tb) continue;
            float acc[U];
#pragma unroll
            for (int u = 0; u < U; ++u) acc[u] = o[u][c];
            for (int t = first; t < tb; t += K) {
                const int* tree = trees + t * words;
                int node[U];
#pragma unroll
                for (int u = 0; u < U; ++u) node[u] = 0;
#pragma unroll
                for (int d = 0; d < DEPTH; ++d) {
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        const int p = tree[node[u]];
                        const int f = (p >> 16) - 1;
                        int code;
                        if (STAGED)      // f = -1 reads column 0, unused
                            code = __byte_perm(
                                rows[(max(f, 0) >> 2) * R + slot[u]], 0,
                                0x4440 | (f & 3));
                        else
                            code = f >= 0 ? row[u][f] : 0;
                        node[u] = 2 * node[u] + 2
                                  - goes_left(p, code, missing_bin);
                    }
                }
#pragma unroll
                for (int u = 0; u < U; ++u)
                    acc[u] += __int_as_float(tree[node[u]]);
            }
#pragma unroll
            for (int u = 0; u < U; ++u)
                if (slot[u] < live) o[u][c] = acc[u];
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

template <int DEPTH, int U, bool STAGED>
static int launch_ensemble(const void* codes, const void* tables,
                           const void* leaves, void* out, long long n, int F,
                           int T, int K, int missing_bin, int R, int TB,
                           int smem, cudaStream_t stream) {
    const auto kernel = ensemble_kernel<DEPTH, U, STAGED>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks_for(n, R), R / U, smem, stream>>>(
        static_cast<const uint8_t*>(codes),
        static_cast<const int32_t*>(tables), static_cast<const float*>(leaves),
        static_cast<float*>(out), n, F, T, K, missing_bin, TB);
    return static_cast<int>(cudaGetLastError());
}

template <int DEPTH>
static int launch_ensemble_depth(bool wide, const void* codes,
                                 const void* tables, const void* leaves,
                                 void* out, long long n, int F, int T, int K,
                                 int missing_bin, int R, int TB, int smem,
                                 cudaStream_t stream) {
    if (wide)
        return launch_ensemble<DEPTH, 1, false>(codes, tables, leaves, out, n,
                                                F, T, K, missing_bin, R, TB,
                                                smem, stream);
    return launch_ensemble<DEPTH, ENSEMBLE_RECORDS_PER_THREAD, true>(
        codes, tables, leaves, out, n, F, T, K, missing_bin, R, TB, smem,
        stream);
}

// What sizes an ensemble launch on ``device`` (kernels/traversal.py,
// EnsembleLimits): out[0..5] = the threads a block at most, the records a
// thread of the staged entry (U), the blocks an SM the launch bounds allow,
// then the card's shared memory an SM, what the runtime keeps of it for
// every block, and the most dynamic shared memory a block may opt into.
extern "C" int ensemble_limits(int device, int* out) {
    out[0] = ENSEMBLE_THREADS;
    out[1] = ENSEMBLE_RECORDS_PER_THREAD;
    out[2] = ENSEMBLE_BLOCKS_PER_SM;
    const cudaDeviceAttr attrs[] = {
        cudaDevAttrMaxSharedMemoryPerMultiprocessor,
        cudaDevAttrReservedSharedMemoryPerBlock,
        cudaDevAttrMaxSharedMemoryPerBlockOptin};
    for (int i = 0; i < 3; ++i) {
        const cudaError_t err = cudaDeviceGetAttribute(out + 3 + i, attrs[i],
                                                       device);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

// R records a block (R / U threads; wide: U = 1), TB trees a staged block,
// smem bytes of dynamic shared memory: ensemble_geometry's choice.
extern "C" int ensemble_launch(const void* codes, const void* tables,
                               const void* leaves, void* out, long long n,
                               int F, int T, int K, int depth,
                               int missing_bin, int R, int TB, int smem,
                               int wide, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ENSEMBLE_DEPTH(D)                                                    \
    case D:                                                                  \
        return launch_ensemble_depth<D>(wide != 0, codes, tables, leaves, out,\
                                        n, F, T, K, missing_bin, R, TB, smem, \
                                        st);
    switch (depth) {
        ENSEMBLE_DEPTH(1) ENSEMBLE_DEPTH(2) ENSEMBLE_DEPTH(3)
        ENSEMBLE_DEPTH(4) ENSEMBLE_DEPTH(5) ENSEMBLE_DEPTH(6)
        ENSEMBLE_DEPTH(7) ENSEMBLE_DEPTH(8) ENSEMBLE_DEPTH(9)
        ENSEMBLE_DEPTH(10)
    }
#undef ENSEMBLE_DEPTH
    return static_cast<int>(cudaErrorInvalidValue);
}
