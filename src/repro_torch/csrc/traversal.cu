// Step ⑤ (one round's trees) and batch inference (ensemble walk): one
// kernel body, ensemble_kernel.
//
// Replaces the TPU kernels src/repro/kernels/traversal.py::_traverse_kernel
// and ::_ensemble_kernel (both via _walk_levels).  A node comes as one
// packed int32 word ((feature+1) << 16) | (thr << 8) | (is_cat << 1) |
// default_left (pack_node_table), children are implicit (heap order), and a
// depth-D walk is D dependent hops.  In shared memory each tree is laid out
// as [decoded nodes | leaf values] (decode_node), so the heap index a walk
// ends on also gives its leaf value.
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
//     (the decoded node, the code), not a gather over ~7 L1 lines as a
//     global read of row[f] is.
//   * Each node is decoded once, as its tree block is staged, into the 8
//     bytes a hop reads (decode_node): where its field's code lies, R folded
//     in, and its decision as a float bound and a missing code (uint8) or a
//     16-code mask (4-bit).  A hop then spends no instruction unpacking a
//     word: a uint8 hop is the node's 8-byte load, one shift-add, the
//     code's byte load, two shifts, three float compares and the child's
//     select and multiply-add: 12.1 SASS instructions on an H100, 5 of them
//     on the integer pipe (which issues the float compares too).  The
//     decision is written without branches, so a warp never splits at a
//     node.
//   * Rows of uint8 codes hold field f at byte f.  Rows of 4-bit packed
//     codes (PackedCodes over the field axis, two fields a byte, F odd: a
//     pad nibble) are staged as they lie, ceil(F/2) bytes a record, and a
//     hop shifts field f's nibble out of its word (f >> 3), bits 4 * (f & 7):
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
// (ensemble_kernel<D, 1, false, NIBBLE>), with the same decoded decision.
// kernels/traversal.py: ensemble_geometry chooses the entry, R and TB from
// ensemble_limits before the launch.
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

// A node as a hop reads it: decoded once from its packed word p
// ((feature+1) << 16 | thr << 8 | is_cat << 1 | default_left) while its
// tree block is staged, into NODE_BYTES = 8 that one 8-byte shared load
// brings, so that a hop spends no instruction unpacking a word.  Word 0 is
// (offset << 14) | low: a hop's code lies offset (word 0 >> 14) bytes past
// the record's own place, and low tells how to read or check it.
//   uint8 codes: offset, staged, the byte (f >> 2) * R * 4 + (f & 3) of the
//        rows, to which a record adds 4 * its slot (R folded in); wide,
//        byte f of the record's row; a pass-through node (f = -1) reads
//        byte 0, whatever it holds.  low = miss, the missing bin where its
//        code would otherwise go against default_left, else 0x3FFF (no
//        code).  Word 1 = w, a float whose bits are thr, its sign set on a
//        numeric node: the code c, an int in [0, 255] from one byte load,
//        read as a float is a denormal (+0.0 for 0), and such floats order
//        as their integers do, since the build does not flush denormals
//        (no -ftz).  The node goes left iff (w <= c <= |w|) != (c == miss):
//        numeric [-thr, thr], categorical [thr, thr], pass-through
//        [-256, 256]; c == miss compares c << 18 with word 0 << 18, which
//        keeps low alone, as floats.
//   4-bit codes: offset, staged, the byte (f >> 3) * R * 4 of the rows'
//        word that holds field f; wide, byte f >> 1 of the row.  low = the
//        nibble's shift, 4 * (f & 7) staged, 4 * (f & 1) wide, which a
//        funnel shift by word 0 takes as its low 5 bits.  Word 1 = the
//        node's 16 decisions, bit (c + 3) mod 16 set where code c goes
//        right, in both halves.  Rotated right by the code word shifted
//        (whose low 5 bits are c plus 16 times the next nibble's low bit),
//        its bit 3 is 8 x (c goes right).
// A walk tracks X = NODE_BYTES * q + base, q the node's heap index from 1
// (root 1, children 2q and 2q + 1), base the shared offset of its tree
// less NODE_BYTES (even): X is where node q lies, and its child is 2X -
// base + NODE_BYTES * (goes right).
constexpr int NODE_BYTES = 8;
constexpr unsigned NO_CODE = 0x3FFF;

template <bool STAGED, bool NIBBLE>
__device__ __forceinline__ uint2 decode_node(int p, int R, int missing_bin) {
    const int f = (p >> 16) - 1;
    const int thr = (p >> 8) & 255;
    const bool cat = (p & 2) != 0, default_left = (p & 1) != 0;
    const unsigned g = max(f, 0);
    if (NIBBLE) {
        unsigned left = 0xFFFF;                          // pass-through
        if (f >= 0) {
            left = cat ? (thr < 16 ? 1u << thr : 0u)
                       : (thr >= 15 ? 0xFFFFu : (2u << thr) - 1u);
            if (0 <= missing_bin && missing_bin < 16)
                left = default_left ? left | (1u << missing_bin)
                                    : left & ~(1u << missing_bin);
        }
        const unsigned right = ~left & 0xFFFF;
        const unsigned mask = ((right << 3) | (right >> 13)) & 0xFFFF;
        const unsigned at = STAGED ? (((g >> 3) * R * 4) << 14) | ((g & 7) << 2)
                                   : ((g >> 1) << 14) | ((g & 1) << 2);
        return make_uint2(at, mask | (mask << 16));
    }
    if (f < 0)
        return make_uint2(NO_CODE, 0x80000100u);         // [-256, 256]
    const bool in = cat ? missing_bin == thr
                        : 0 <= missing_bin && missing_bin <= thr;
    const unsigned miss =
        0 <= missing_bin && missing_bin < 256 && in != default_left
            ? static_cast<unsigned>(missing_bin) : NO_CODE;
    const unsigned off = STAGED ? (g >> 2) * R * 4 + (g & 3) : g;
    return make_uint2((off << 14) | miss,
                      (cat ? 0u : 0x80000000u) | static_cast<unsigned>(thr));
}

template <int DEPTH, int U, bool STAGED, bool NIBBLE>
__global__ void __launch_bounds__(ENSEMBLE_THREADS, ENSEMBLE_BLOCKS_PER_SM)
ensemble_kernel(const uint8_t* __restrict__ codes,
                const int32_t* __restrict__ tables,
                const float* __restrict__ leaves, float* __restrict__ out,
                long long n, int F, int T, int K, int missing_bin, int TB) {
    // STAGED: [ceil(RB/4) x R code words | TB x [decoded nodes | leaves]]
    extern __shared__ int4 smem_words[];
    char* smem = reinterpret_cast<char*>(smem_words);
    constexpr int n_int = (1 << DEPTH) - 1;
    constexpr int items = 2 * n_int + 1;           // nodes and leaves a tree
    constexpr int NB = NODE_BYTES;
    constexpr int TREE_BYTES = NB * n_int + 4 * (n_int + 1);
    const int RB = NIBBLE ? (F + 1) >> 1 : F;       // bytes a code row
    const int R = U * blockDim.x;
    const long long r0 = static_cast<long long>(blockIdx.x) * R;
    const int live = static_cast<int>(min(static_cast<long long>(R), n - r0));
    const int trees = STAGED ? ((RB + 3) >> 2) * R * 4 : 0;
    if (STAGED)
        stage_rows(codes, reinterpret_cast<uint32_t*>(smem), r0, live, RB,
                   R);
    int slot4[U];                         // 4 x the record's slot
    const uint8_t* row[U];
    float* o[U];                          // zeros or margins (the wrapper's)
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int slot = u * blockDim.x + threadIdx.x;
        slot4[u] = 4 * slot;
        const long long r = slot < live ? r0 + slot : 0;
        row[u] = codes + r * RB;
        o[u] = out + r * K;
    }
    for (int t0 = 0; t0 < T; t0 += TB) {
        const int tb = min(TB, T - t0);
        if (t0 > 0)
            __syncthreads();             // the previous tree block walked
        // the first tree block decodes while the rows' loads are in flight
        for (int i = threadIdx.x; i < tb * items; i += blockDim.x) {
            const int t = i / items, w = i - t * items;
            const long long g = t0 + t;
            char* tree = smem + trees + t * TREE_BYTES;
            if (w < n_int)
                *reinterpret_cast<uint2*>(tree + w * NB) =
                    decode_node<STAGED, NIBBLE>(tables[g * n_int + w], R,
                                                missing_bin);
            else
                *reinterpret_cast<float*>(tree + NB * n_int
                                          + 4 * (w - n_int)) =
                    leaves[g * (n_int + 1) + w - n_int];
        }
        __syncthreads();                 // rows staged, trees decoded
        for (int c = 0; c < K; ++c) {
            // first staged tree of class c: (t0 + t) % K == c
            const int first = ((c - t0 % K) + K) % K;
            if (first >= tb) continue;
            float acc[U];
#pragma unroll
            for (int u = 0; u < U; ++u) acc[u] = o[u][c];
            for (int t = first; t < tb; t += K) {
                // node q at X = base + NB * q, its child at 2X + step
                const int base = trees + t * TREE_BYTES - NB;
                const int left = -base, right = NB - base;
                int X[U];
#pragma unroll
                for (int u = 0; u < U; ++u) X[u] = base + NB;   // the root
#pragma unroll
                for (int d = 0; d < DEPTH; ++d) {
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        const uint2 node =
                            *reinterpret_cast<const uint2*>(smem + X[u]);
                        if (NIBBLE) {
                            const unsigned word =
                                STAGED ? *reinterpret_cast<const uint32_t*>(
                                             smem + slot4[u] + (node.x >> 14))
                                       : row[u][node.x >> 14];
                            const unsigned code =
                                __funnelshift_r(word, 0u, node.x);
                            X[u] = 2 * X[u] + left
                                   + (__funnelshift_r(node.y, node.y, code)
                                      & NB);
                        } else {
                            const unsigned code =
                                STAGED ? reinterpret_cast<const uint8_t*>(
                                             smem)[slot4[u] + (node.x >> 14)]
                                       : row[u][node.x >> 14];
                            const float c = __uint_as_float(code);
                            const float w = __uint_as_float(node.y);
                            const bool in = (c >= w) & (c <= fabsf(w));
                            const bool miss =
                                __uint_as_float(code << 18)
                                == __uint_as_float(node.x << 18);
                            X[u] = 2 * X[u] + (in != miss ? left : right);
                        }
                    }
                }
                // the leaf of heap index q = (X - base) / NB lies q -
                // 2^DEPTH floats past the nodes: at X / 2 + leaf (NB = 8)
                const int leaf = base / 2 + NB * (n_int + 1) - 4 * (n_int + 1);
#pragma unroll
                for (int u = 0; u < U; ++u)
                    acc[u] += *reinterpret_cast<const float*>(
                        smem + leaf + (X[u] >> 1));
            }
#pragma unroll
            for (int u = 0; u < U; ++u)
                if (slot4[u] < 4 * live) o[u][c] = acc[u];
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
