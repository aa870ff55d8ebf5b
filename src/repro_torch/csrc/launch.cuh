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

// Split predicate shared by the partition and traversal kernels (the
// semantics of repro_torch.kernels.ref._decide_go_left): a negative feature
// is a pass-through (always left), the missing bin follows default_left,
// categorical fields test equality and numeric fields test <=.
__device__ __forceinline__ int go_left_of(int code, int feature, int thr,
                                          int is_cat, int default_left,
                                          int missing_bin) {
    if (feature < 0) return 1;
    if (code == missing_bin) return default_left == 1;
    return is_cat == 1 ? code == thr : code <= thr;
}
