// Step ③ — single-predicate evaluation: route every record to its child.
//
// Replaces the TPU kernel src/repro/kernels/partition.py::_partition_kernel.
// The TPU version fetched each record's split parameters with a one-hot
// float matrix product over the level's split table; here the table
// (NN x {feature, threshold, is_cat, default_left}, at most 3072 x 16 B) sits
// in shared memory and each thread indexes it directly with its node id.
// Each block stages it from the four split arrays as the grower holds them
// (int32, row k of class k at k * split_stride), so the wrapper never stacks
// or casts them.
//
// Bound on the H100: bytes.  Per record the function needs its node id
// (4 B), one code byte and the new id (4 B); the work is a handful of
// integer operations.  What the bytes alone do not show: a node id load
// followed by a dependent 1-byte gather, which at one record a thread keeps
// too few bytes in flight per SM for the memory's latency, and a gather
// that reads a 32-byte sector of a split column for each byte it needs.
// So each thread takes RECORDS (4) consecutive records: one 16-byte load of
// their node ids, then their four code gathers, all issued before any is
// used, then one 16-byte store.  A partial group (the tail of a class, or a
// class row that does not start on 16 bytes, as at K > 1 with n % 4 != 0)
// loads and stores its records one by one.  The decision has no branches.
//
// One kernel, three layouts of the codes (the template argument):
//   * ROWS: codes_lvl (n, C), the level's gathered columns in the JAX
//     signature (split_feature indexes [0, C)); one class;
//   * CM: codes_cm[f, r] straight from the (F, n) column-major copy
//     (split_feature holds global field ids), so the grower never
//     materialises the (NN, n) gather of the level's columns;
//   * CM_NIBBLE: the same over the 4-bit packed column-major copy
//     (PackedCodes over the record axis, n_bins <= 16): row f holds
//     nb = ceil(n/2) bytes, and record r's code is the nibble (r & 1) of byte
//     codes[f * nb + (r >> 1)].  The row stride is ceil(n/2), not n/2: an odd
//     n leaves a pad nibble at each row's end, which no record reads.
// The column-major layouts carry a class axis: node ids (K, n), split arrays
// (K, NN) and output (K, n) over the shared codes, one launch with the class
// as blockIdx.y (the TPU build vmaps its kernel over the classes,
// src/repro/core/tree.py:159).
// A node id outside [0, NN) or a feature outside the code matrix yields -1
// (the plain version raises on such input; the kernel cannot).
#include "launch.cuh"

constexpr int PARTITION_THREADS = 256;
constexpr int RECORDS = 4;               // consecutive records a thread

enum Layout { ROWS = 0, CM = 1, CM_NIBBLE = 2 };

template <int LAYOUT>
__device__ __forceinline__ int code_at(const uint8_t* __restrict__ codes,
                                       long long r, int f, long long n,
                                       int C) {
    if (LAYOUT == ROWS) return __ldg(codes + r * C + f);
    if (LAYOUT == CM) return __ldg(codes + f * n + r);
    const long long nb = (n + 1) >> 1;
    return (__ldg(codes + f * nb + (r >> 1)) >> ((r & 1) << 2)) & 0xF;
}

template <int LAYOUT>
__global__ void __launch_bounds__(PARTITION_THREADS)
partition_kernel(const int32_t* __restrict__ node,
                 const uint8_t* __restrict__ codes,
                 const int32_t* __restrict__ feature,
                 const int32_t* __restrict__ threshold,
                 const int32_t* __restrict__ is_cat,
                 const int32_t* __restrict__ default_left,
                 long long split_stride, int32_t* __restrict__ out,
                 long long n, int F, int NN, int missing_bin) {
    extern __shared__ int4 splits[];     // x feature, y thr, z is_cat, w dl
    const int k = blockIdx.y;            // class
    const long long s0 = static_cast<long long>(k) * split_stride;
    for (int i = threadIdx.x; i < NN; i += blockDim.x)
        splits[i] = make_int4(feature[s0 + i], threshold[s0 + i],
                              is_cat[s0 + i], default_left[s0 + i]);
    __syncthreads();
    const long long r0 = (static_cast<long long>(blockIdx.x) * blockDim.x
                          + threadIdx.x) * RECORDS;
    if (r0 >= n) return;
    const int32_t* nd_k = node + static_cast<long long>(k) * n + r0;
    int32_t* out_k = out + static_cast<long long>(k) * n + r0;
    const int live = static_cast<int>(min(static_cast<long long>(RECORDS),
                                          n - r0));
    const bool vec = live == RECORDS
        && ((reinterpret_cast<uintptr_t>(nd_k)
             | reinterpret_cast<uintptr_t>(out_k)) & 15) == 0;
    int nd[RECORDS];
    if (vec) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(nd_k));
        nd[0] = v.x; nd[1] = v.y; nd[2] = v.z; nd[3] = v.w;
    } else {
#pragma unroll
        for (int j = 0; j < RECORDS; ++j)
            nd[j] = j < live ? __ldg(nd_k + j) : -1;
    }
    int4 p[RECORDS];
    bool ok[RECORDS];
    int code[RECORDS];
#pragma unroll
    for (int j = 0; j < RECORDS; ++j) {
        ok[j] = nd[j] >= 0 && nd[j] < NN;
        p[j] = ok[j] ? splits[nd[j]] : make_int4(-1, 0, 0, 0);
        ok[j] = ok[j] && p[j].x < F;
    }
#pragma unroll
    for (int j = 0; j < RECORDS; ++j)    // every gather before any use
        code[j] = ok[j] && p[j].x >= 0
                      ? code_at<LAYOUT>(codes, r0 + j, p[j].x, n, F) : 0;
    int res[RECORDS];
#pragma unroll
    for (int j = 0; j < RECORDS; ++j)
        res[j] = ok[j] ? 2 * nd[j] + 1 - go_left_of(code[j], p[j].x, p[j].y,
                                                    p[j].z, p[j].w,
                                                    missing_bin)
                       : -1;
    if (vec) {
        *reinterpret_cast<int4*>(out_k) = make_int4(res[0], res[1], res[2],
                                                    res[3]);
    } else {
#pragma unroll
        for (int j = 0; j < RECORDS; ++j)
            if (j < live) out_k[j] = res[j];
    }
}

template <int LAYOUT>
static int launch(const void* node, const void* codes, const void* feature,
                  const void* threshold, const void* is_cat,
                  const void* default_left, long long split_stride, void* out,
                  long long n, int F, int K, int NN, int missing_bin,
                  cudaStream_t stream) {
    const long long per_block =
        static_cast<long long>(PARTITION_THREADS) * RECORDS;
    const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block),
                    K);
    partition_kernel<LAYOUT><<<grid, PARTITION_THREADS, NN * sizeof(int4),
                               stream>>>(
        static_cast<const int32_t*>(node), static_cast<const uint8_t*>(codes),
        static_cast<const int32_t*>(feature),
        static_cast<const int32_t*>(threshold),
        static_cast<const int32_t*>(is_cat),
        static_cast<const int32_t*>(default_left), split_stride,
        static_cast<int32_t*>(out), n, F, NN, missing_bin);
    return static_cast<int>(cudaGetLastError());
}

// layout: 0 ROWS (codes (n, F), K = 1), 1 CM (codes (F, n)), 2 CM_NIBBLE
// (codes (F, ceil(n/2)) packed bytes).  node and out are (K, n) int32; the
// four split arrays hold class k's NN entries at k * split_stride.
extern "C" int partition_launch(int layout, const void* node,
                                const void* codes, const void* feature,
                                const void* threshold, const void* is_cat,
                                const void* default_left,
                                long long split_stride, void* out,
                                long long n, int F, int K, int NN,
                                int missing_bin, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (layout) {
        case ROWS:
            return launch<ROWS>(node, codes, feature, threshold, is_cat,
                                default_left, split_stride, out, n, F, K, NN,
                                missing_bin, st);
        case CM:
            return launch<CM>(node, codes, feature, threshold, is_cat,
                              default_left, split_stride, out, n, F, K, NN,
                              missing_bin, st);
        case CM_NIBBLE:
            return launch<CM_NIBBLE>(node, codes, feature, threshold, is_cat,
                                     default_left, split_stride, out, n, F,
                                     K, NN, missing_bin, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
