// Step ③ — single-predicate evaluation: route every record to its child.
//
// Replaces the TPU kernel src/repro/kernels/partition.py::_partition_kernel.
// The TPU version fetched each record's split parameters with a one-hot
// float matrix product over the level's split table; here the table
// (NN x {feature, threshold, is_cat, default_left}, at most 512 x 16 B) sits
// in shared memory and each thread indexes it directly with its node id.
//
// Bound on the H100: bytes.  Per record the function needs its node id
// (4 B), one code byte and the new id (4 B); the work is a handful of
// integer operations.  One thread per record, so consecutive threads read
// consecutive node ids and write consecutive outputs.
//
// Two entries:
//   * partition_rows_launch reads codes_lvl (n, C), the level's gathered
//     columns in the JAX signature (split_feature indexes [0, C));
//   * partition_cm_launch reads codes_cm[f, r] straight from the
//     column-major copy (split_feature holds global field ids), so the
//     grower never materialises the (NN, n) gather of the level's columns.
//     It carries a class axis: node ids (K, n), split tables (K, NN) and
//     output (K, n) over the shared codes, one launch with the class as
//     blockIdx.y (the TPU build vmaps its kernel over the classes,
//     src/repro/core/tree.py:159).  Each block stages its class's table.
//   * partition_cm_nibble_launch is the same entry over the 4-bit packed
//     column-major copy (PackedCodes over the record axis, n_bins <= 16):
//     row f holds nb = ceil(n/2) bytes, and record r's code is the nibble
//     (r & 1) of byte codes_cm[f * nb + (r >> 1)].  The row stride is
//     ceil(n/2), not n/2: an odd n leaves a pad nibble at each row's end.
//     It keeps the fused column gather: the grower never unpacks the
//     level's K*NN rows of n codes.
// A node id outside [0, NN) or a feature outside the code matrix yields -1
// (the plain version raises on such input; the kernel cannot).
#include "launch.cuh"

__global__ void partition_rows_kernel(const int32_t* __restrict__ node,
                                      const uint8_t* __restrict__ codes,
                                      const int4* __restrict__ table,
                                      int32_t* __restrict__ out, long long n,
                                      int C, int NN, int missing_bin) {
    extern __shared__ int4 splits[];
    for (int i = threadIdx.x; i < NN; i += blockDim.x) splits[i] = table[i];
    __syncthreads();
    const long long r = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    if (r >= n) return;
    const int nd = node[r];
    if (nd < 0 || nd >= NN) { out[r] = -1; return; }
    const int4 p = splits[nd];           // x feature, y thr, z is_cat, w dl
    if (p.x >= C) { out[r] = -1; return; }
    const int code = p.x >= 0 ? codes[r * C + p.x] : 0;
    out[r] = 2 * nd + 1 - go_left_of(code, p.x, p.y, p.z, p.w, missing_bin);
}

template <bool NIBBLE>
__global__ void partition_cm_kernel(const int32_t* __restrict__ node,
                                    const uint8_t* __restrict__ codes_cm,
                                    const int4* __restrict__ table,
                                    int32_t* __restrict__ out, long long n,
                                    int F, int NN, int missing_bin) {
    extern __shared__ int4 splits[];
    const int k = blockIdx.y;            // class
    for (int i = threadIdx.x; i < NN; i += blockDim.x)
        splits[i] = table[static_cast<long long>(k) * NN + i];
    __syncthreads();
    const long long r = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    if (r >= n) return;
    const long long kr = static_cast<long long>(k) * n + r;
    const int nd = node[kr];
    if (nd < 0 || nd >= NN) { out[kr] = -1; return; }
    const int4 p = splits[nd];
    if (p.x >= F) { out[kr] = -1; return; }
    int code = 0;
    if (p.x >= 0) {
        if (NIBBLE) {
            const long long nb = (n + 1) >> 1;
            const int b = codes_cm[static_cast<long long>(p.x) * nb + (r >> 1)];
            code = (b >> ((r & 1) << 2)) & 0xF;
        } else {
            code = codes_cm[static_cast<long long>(p.x) * n + r];
        }
    }
    out[kr] = 2 * nd + 1 - go_left_of(code, p.x, p.y, p.z, p.w, missing_bin);
}

static int blocks_for(long long n, int threads) {
    return static_cast<int>((n + threads - 1) / threads);
}

extern "C" int partition_rows_launch(const void* node, const void* codes,
                                     const void* table, void* out,
                                     long long n, int C, int NN,
                                     int missing_bin, int threads,
                                     void* stream) {
    partition_rows_kernel<<<blocks_for(n, threads), threads,
                            NN * sizeof(int4),
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(node), static_cast<const uint8_t*>(codes),
        static_cast<const int4*>(table), static_cast<int32_t*>(out), n, C, NN,
        missing_bin);
    return static_cast<int>(cudaGetLastError());
}

template <bool NIBBLE>
static int launch_cm(const void* node, const void* codes_cm,
                     const void* table, void* out, long long n, int F, int K,
                     int NN, int missing_bin, int threads, void* stream) {
    const dim3 grid(blocks_for(n, threads), K);
    partition_cm_kernel<NIBBLE><<<grid, threads, NN * sizeof(int4),
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(node),
        static_cast<const uint8_t*>(codes_cm),
        static_cast<const int4*>(table), static_cast<int32_t*>(out), n, F, NN,
        missing_bin);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int partition_cm_launch(const void* node, const void* codes_cm,
                                   const void* table, void* out, long long n,
                                   int F, int K, int NN, int missing_bin,
                                   int threads, void* stream) {
    return launch_cm<false>(node, codes_cm, table, out, n, F, K, NN,
                            missing_bin, threads, stream);
}

// codes_cm: the (F, ceil(n/2)) packed bytes of PackedCodes.data
extern "C" int partition_cm_nibble_launch(const void* node,
                                          const void* codes_cm,
                                          const void* table, void* out,
                                          long long n, int F, int K, int NN,
                                          int missing_bin, int threads,
                                          void* stream) {
    return launch_cm<true>(node, codes_cm, table, out, n, F, K, NN,
                           missing_bin, threads, stream);
}
