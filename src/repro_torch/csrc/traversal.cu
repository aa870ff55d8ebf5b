// Step ⑤ (one round's trees) and batch inference (ensemble walk): one
// kernel body, ensemble_kernel.
//
// Replaces the TPU kernels src/repro/kernels/traversal.py::_traverse_kernel
// and ::_ensemble_kernel (both via _walk_levels).  A node is one packed
// int32 word ((feature+1) << 16) | (thr << 8) | (is_cat << 1) | default_left
// (pack_node_table), children are implicit (2*node + 2 - go_left), and a
// depth-D walk is D dependent hops.  In shared memory each tree is laid out
// as [node words | leaf values], so the node index a walk ends on is also
// the index of its leaf value.
//
// ensemble_launch — the sum over T trees, tree t into margin column t % K.
// Step ⑤ is its T = K case: one round's K class trees (the TPU build vmaps
// _traverse_kernel over the classes, src/repro/core/gbdt.py:803-807), where
// the sum of one tree a class into the output is that tree's leaf added to
// what the output held: -0.0 (the leaf exactly, its sign included) or the
// margins (the round's margin update, one float add, as margins + leaf).  Bound on the
// H100: bytes at T = K (each record's code row read, K floats read and
// written), operations at large T — n*T*D dependent hops (3e10 at n = 10M,
// T = 500, D = 6) against one pass over the codes.  So the design makes a
// hop cheap:
//   * A block owns R = U * blockDim records and first stages their code
//     rows in shared memory, read once from global memory, as 32-bit words
//     of 4 consecutive bytes of one record's row: word (b >> 2) * R + r,
//     byte b & 3 (the row padded to a multiple of 4 bytes; the pad bytes are
//     never read, as field ids are checked < F).  R is a multiple of 32, so
//     the lanes of a warp, which walk consecutive records, hit bank r mod 32
//     whatever fields they want: a hop is two conflict-free shared loads
//     (node word, code word) and the integer decision, not a gather over
//     ~7 L1 lines as a global read of row[f] is.  The decision is written
//     without branches (goes_left), so a warp never splits at a node.
//   * Rows of uint8 codes hold field f at byte f.  Rows of 4-bit packed
//     codes (PackedCodes over the field axis, two fields a byte, F odd: a
//     pad nibble) are staged as they lie, ceil(F/2) bytes a record, and a
//     hop decodes field f's nibble from its word (f >> 3), bits 4 * (f & 7):
//     the card never unpacks them.
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
// each record in one register in tree order, starting from the output
// element it holds, and carrying the sum across blocks in that element (a
// per-thread float acc[K] indexed by a runtime class would sit in local
// memory).  The sum order is that of one record a thread, so the output
// does not depend on U, R or TB.  Trees whose node words all carry feature
// -1 and whose leaves are zero (padding) add exactly 0.
//
// Code rows that do not fit — 32 records' padded rows plus one tree past a
// block's shared memory (F in the thousands) — take the wide entry, the same
// body reading row[f] from global memory, one record a thread
// (ensemble_kernel<D, 1, false, NIBBLE>).  kernels/traversal.py:
// ensemble_geometry chooses the entry, R and TB from ensemble_limits before
// the launch.
#include "launch.cuh"

constexpr int ENSEMBLE_THREADS = 256;           // threads a block at most
constexpr int ENSEMBLE_RECORDS_PER_THREAD = 2;  // U of the staged entry
constexpr int ENSEMBLE_BLOCKS_PER_SM = 4;       // registers for four blocks
constexpr int STAGE_CHUNKS = 4;                 // 16-byte loads in flight

// Stage the block's ``live`` code rows of RB bytes as words
// [(b >> 2) * R + r].  The rows are one contiguous span of live * RB bytes
// (r0 * RB is a multiple of 32, as R is), read in 16-byte loads where the
// codes start on 16 bytes (a tensor's own storage does): each thread takes
// up to four chunks at a time, all loads issued before any is written out.  A
// chunk at span offset o starts in record o / RB; where RB is a multiple of
// 4, each of its 4-byte words is one staged word, else its bytes go one by
// one.  The span's last (live * RB) % 16 bytes, and every byte of a span
// that does not start on 16 bytes, are copied byte by byte.
__device__ __forceinline__ void stage_chunk(uint4 v, int o, uint32_t* staged,
                                            int RB, int R) {
    int r = o / RB;
    int b = o - r * RB;
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    if ((RB & 3) == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            staged[(b >> 2) * R + r] = w[j];
            b += 4;
            if (b == RB) { b = 0; ++r; }
        }
        return;
    }
    uint8_t* bytes = reinterpret_cast<uint8_t*>(staged);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        bytes[((b >> 2) * R + r) * 4 + (b & 3)] =
            static_cast<uint8_t>(w[j >> 2] >> ((j & 3) << 3));
        if (++b == RB) { b = 0; ++r; }
    }
}

__device__ __forceinline__ void stage_rows(const uint8_t* __restrict__ codes,
                                           uint32_t* staged, long long r0,
                                           int live, int RB, int R) {
    const uint8_t* span = codes + r0 * RB;
    const int n_bytes = live * RB;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(span) & 15) == 0) {
        const uint4* chunks = reinterpret_cast<const uint4*>(span);
        const int n_chunks = n_bytes >> 4;
        for (int c0 = threadIdx.x; c0 < n_chunks;
             c0 += STAGE_CHUNKS * blockDim.x) {
            uint4 v[STAGE_CHUNKS];
#pragma unroll
            for (int j = 0; j < STAGE_CHUNKS; ++j) {
                const int c = c0 + j * blockDim.x;
                v[j] = c < n_chunks ? __ldg(chunks + c)
                                    : make_uint4(0, 0, 0, 0);
            }
#pragma unroll
            for (int j = 0; j < STAGE_CHUNKS; ++j) {
                const int c = c0 + j * blockDim.x;
                if (c < n_chunks) stage_chunk(v[j], c << 4, staged, RB, R);
            }
        }
        done = n_chunks << 4;
    }
    uint8_t* bytes = reinterpret_cast<uint8_t*>(staged);
    for (int o = done + threadIdx.x; o < n_bytes; o += blockDim.x) {
        const int r = o / RB;
        const int b = o - r * RB;
        bytes[((b >> 2) * R + r) * 4 + (b & 3)] = span[o];
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

// Field f's code in a staged row: byte f of the uint8 row, nibble f of the
// packed one (f = -1 reads an unused byte or nibble of the first word).
template <bool NIBBLE>
__device__ __forceinline__ int staged_code(const uint32_t* __restrict__ rows,
                                           int f, int R, int slot) {
    if (NIBBLE)
        return (rows[(max(f, 0) >> 3) * R + slot] >> ((f & 7) << 2)) & 0xF;
    return __byte_perm(rows[(max(f, 0) >> 2) * R + slot], 0,
                       0x4440 | (f & 3));
}

template <int DEPTH, int U, bool STAGED, bool NIBBLE>
__global__ void __launch_bounds__(ENSEMBLE_THREADS, ENSEMBLE_BLOCKS_PER_SM)
ensemble_kernel(const uint8_t* __restrict__ codes,
                const int32_t* __restrict__ tables,
                const float* __restrict__ leaves, float* __restrict__ out,
                long long n, int F, int T, int K, int missing_bin, int TB) {
    // STAGED: [ceil(RB/4) x R code words | TB x [node words | leaves]]
    extern __shared__ int smem[];
    constexpr int n_int = (1 << DEPTH) - 1;
    constexpr int words = 2 * n_int + 1;
    const int RB = NIBBLE ? (F + 1) >> 1 : F;       // bytes a code row
    const int R = U * blockDim.x;
    const long long r0 = static_cast<long long>(blockIdx.x) * R;
    const int live = static_cast<int>(min(static_cast<long long>(R), n - r0));
    const uint32_t* rows = reinterpret_cast<const uint32_t*>(smem);
    int* trees = smem + (STAGED ? ((RB + 3) >> 2) * R : 0);
    if (STAGED)
        stage_rows(codes, reinterpret_cast<uint32_t*>(smem), r0, live, RB,
                   R);
    int slot[U];
    const uint8_t* row[U];
    float* o[U];                          // zeros or margins (the wrapper's)
#pragma unroll
    for (int u = 0; u < U; ++u) {
        slot[u] = u * blockDim.x + threadIdx.x;
        const long long r = slot[u] < live ? r0 + slot[u] : 0;
        row[u] = codes + r * RB;
        o[u] = out + r * K;
    }
    for (int t0 = 0; t0 < T; t0 += TB) {
        const int tb = min(TB, T - t0);
        if (t0 > 0)
            __syncthreads();             // the previous tree block walked
        // the first tree block loads while the rows' loads are in flight
        for (int i = threadIdx.x; i < tb * words; i += blockDim.x) {
            const long long t = t0 + i / words;
            const int w = i % words;
            trees[i] = w < n_int ? tables[t * n_int + w]
                                 : __float_as_int(leaves[t * (n_int + 1)
                                                         + w - n_int]);
        }
        __syncthreads();                 // rows staged, trees loaded
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
                        if (STAGED)
                            code = staged_code<NIBBLE>(rows, f, R, slot[u]);
                        else if (NIBBLE)
                            code = f >= 0 ? (row[u][f >> 1] >> ((f & 1) << 2))
                                                & 0xF
                                          : 0;
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

template <int DEPTH, int U, bool STAGED, bool NIBBLE>
static int launch_ensemble(const void* codes, const void* tables,
                           const void* leaves, void* out, long long n, int F,
                           int T, int K, int missing_bin, int R, int TB,
                           int smem, cudaStream_t stream) {
    const auto kernel = ensemble_kernel<DEPTH, U, STAGED, NIBBLE>;
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

template <int DEPTH, bool NIBBLE>
static int launch_ensemble_entry(bool wide, const void* codes,
                                 const void* tables, const void* leaves,
                                 void* out, long long n, int F, int T, int K,
                                 int missing_bin, int R, int TB, int smem,
                                 cudaStream_t stream) {
    if (wide)
        return launch_ensemble<DEPTH, 1, false, NIBBLE>(
            codes, tables, leaves, out, n, F, T, K, missing_bin, R, TB, smem,
            stream);
    return launch_ensemble<DEPTH, ENSEMBLE_RECORDS_PER_THREAD, true, NIBBLE>(
        codes, tables, leaves, out, n, F, T, K, missing_bin, R, TB, smem,
        stream);
}

template <int DEPTH>
static int launch_ensemble_depth(bool wide, bool nibble, const void* codes,
                                 const void* tables, const void* leaves,
                                 void* out, long long n, int F, int T, int K,
                                 int missing_bin, int R, int TB, int smem,
                                 cudaStream_t stream) {
    if (nibble)
        return launch_ensemble_entry<DEPTH, true>(
            wide, codes, tables, leaves, out, n, F, T, K, missing_bin, R, TB,
            smem, stream);
    return launch_ensemble_entry<DEPTH, false>(
        wide, codes, tables, leaves, out, n, F, T, K, missing_bin, R, TB,
        smem, stream);
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
// smem bytes of dynamic shared memory: ensemble_geometry's choice.  codes:
// (n, F) uint8, or with nibble != 0 the (n, ceil(F/2)) bytes of 4-bit
// packed codes.  out (n, K) float32 holds what the sums start from.
extern "C" int ensemble_launch(const void* codes, const void* tables,
                               const void* leaves, void* out, long long n,
                               int F, int T, int K, int depth,
                               int missing_bin, int R, int TB, int smem,
                               int wide, int nibble, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ENSEMBLE_DEPTH(D)                                                    \
    case D:                                                                  \
        return launch_ensemble_depth<D>(wide != 0, nibble != 0, codes,       \
                                        tables, leaves, out, n, F, T, K,     \
                                        missing_bin, R, TB, smem, st);
    switch (depth) {
        ENSEMBLE_DEPTH(1) ENSEMBLE_DEPTH(2) ENSEMBLE_DEPTH(3)
        ENSEMBLE_DEPTH(4) ENSEMBLE_DEPTH(5) ENSEMBLE_DEPTH(6)
        ENSEMBLE_DEPTH(7) ENSEMBLE_DEPTH(8) ENSEMBLE_DEPTH(9)
        ENSEMBLE_DEPTH(10)
    }
#undef ENSEMBLE_DEPTH
    return static_cast<int>(cudaErrorInvalidValue);
}
