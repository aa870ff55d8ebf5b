// Shared by every kernel source: each source is built into its own shared
// library with a plain C interface, loaded from Python with ctypes.  Every
// launch entry returns cudaGetLastError() so the wrapper can raise on a
// refused launch (too many threads, too much shared memory), and this
// export turns that code into CUDA's own message.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* repro_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Split predicate of the partition kernel (the semantics of
// repro_torch.kernels.ref._decide_go_left): a negative feature is a
// pass-through (always left), the missing bin follows default_left,
// categorical fields test equality and numeric fields test <=.  Written
// without branches (each ternary is a select), so that the records of a
// warp, or of a thread, never split at a decision.
__device__ __forceinline__ int go_left_of(int code, int feature, int thr,
                                          int is_cat, int default_left,
                                          int missing_bin) {
    const int cmp = is_cat == 1 ? code == thr : code <= thr;
    const int decided = code == missing_bin ? default_left == 1 : cmp;
    return (feature < 0) | decided;
}
