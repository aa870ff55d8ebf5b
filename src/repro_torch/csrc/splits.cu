// Step ② — the split search of one level, its decisions folded into the
// tree tables, in one launch.
//
// Replaces no TPU kernel.  The JAX build's src/repro/core/splits.py::
// find_best_splits is plain jnp under jit, which XLA fuses into a few
// programs on the TPU; the port runs PyTorch eagerly, where the same
// function is ~100 small operations (cumsums, four gain chains, selects,
// argmaxes, gathers, casts) and the level's fold into the tree tables
// (core/tree.py::_decide_level) ~30 more.  Each costs the host a launch of a
// few microseconds while the device work behind it is tiny, so the host set
// the pace of every boosting round.  This kernel is the port's answer to
// losing jit: the whole of step ② is one launch a level.
//
// Bound on the H100: neither bytes nor operations.  A level reads its
// (K*NN, F, NB, 2) float32 histogram once (1.8 MB at Higgs level 5, 24.8 MB
// at Covertype level 5: under 8 us at 3.35 TB/s) and does ~20 operations a
// bin; what bounds a launch this small is its latency and the length of
// each block's dependent chain (load, scan, gains, two argmaxes).  The
// design keeps that chain short and every load in flight at once:
//   * One block a node (K*NN blocks, 1 to 224 in the benchmark's cells), one
//     warp a field, each warp looping over fields w, w + W, ... when F
//     exceeds the W <= 16 warps of a block (Covertype: F = 54).
//   * A lane takes a run of ceil((NB-1)/32) consecutive value bins (8 at
//     NB = 256; at most one at NB = 16, the packed path) and loads them as
//     16-byte vectors (two bins each) where the run's length is even, 8-byte
//     ones otherwise; it adds its run sequentially, a warp shuffle scan of
//     the lanes' sums gives each run its offset, and the lane then has the
//     G and H prefixes of its bins.
//   * Each lane scores its bins' four candidates (numeric "<= t" or
//     categorical "== t", the missing bin left or right), keeps its best,
//     and a shuffle butterfly gives the warp's; a shared-memory argmax over
//     the warps ends the search.
//   * Thread 0 writes the eight decision arrays and, on the grower's path,
//     the node's entries of the four split tables; the block then writes the
//     new leaf's weight into the node's 2^(depth-level) bottom slots.
//
// Semantics: those of the plain version (repro_torch.core.splits.
// find_best_splits_plain), which the tests hold this kernel against.  The
// parent's G and H are field 0's sums.  A missing direction is "left" only
// if its gain is strictly greater.  A masked or refused candidate scores
// -inf.  Ties go to the first bin, then to the first field (NaN counts as
// the largest, as torch.argmax has it).  A node whose best gain is not
// finite gets gain -1 (feature 0, threshold 0 where every candidate is
// -inf).  Float32 throughout; each operation of the gain is rounded on its
// own (__f*_rn: no fused multiply-add), as PyTorch's one-operation kernels
// round them, so only the order of the prefix sums' additions differs from
// torch.cumsum: dyadic statistics, whose every partial sum is exact, give
// decisions bit-equal to the plain version.
#include "launch.cuh"
#include <climits>
#include <math.h>

constexpr int SPLIT_MAX_WARPS = 16;
constexpr int SPLIT_MAX_RUN = 8;         // value bins a lane: NB <= 257
constexpr unsigned FULL_MASK = 0xffffffffu;

// (a, ia) beats (b, ib) under torch.argmax's order: NaN above every number,
// then the larger value, then the smaller index.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
    const bool an = isnan(a), bn = isnan(b);
    if (an != bn) return an;
    if (!an && a != b) return a > b;
    return ia < ib;
}

// XGBoost's eq. 7, operation by operation as the plain version rounds it.
__device__ __forceinline__ float gain_of(float GL, float HL, float Gp,
                                         float Hp, float parent, float lam,
                                         float gam, float mcw) {
    const float GR = __fsub_rn(Gp, GL);
    const float HR = __fsub_rn(Hp, HL);
    const float l = __fdiv_rn(__fmul_rn(GL, GL), __fadd_rn(HL, lam));
    const float r = __fdiv_rn(__fmul_rn(GR, GR), __fadd_rn(HR, lam));
    const float g = __fsub_rn(
        __fmul_rn(0.5f, __fsub_rn(__fadd_rn(l, r), parent)), gam);
    return (HL >= mcw && HR >= mcw) ? g : -INFINITY;
}

__device__ __forceinline__ int flag_at(const void* flags, int bytes, int f) {
    return bytes == 1 ? static_cast<const uint8_t*>(flags)[f]
                      : static_cast<const int32_t*>(flags)[f];
}

// The grower's tables, written when `feature` is not null: the level's
// nodes sit at off + i of each class's (n_int,) split tables and own the
// bottom slots [i * reps, (i + 1) * reps) of its (n_leaf,) leaf tables.
struct Fold {
    int nn, off, reps, n_int, n_leaf;
    uint8_t* do_split;
    int32_t* feature;
    int32_t* threshold;
    int32_t* is_cat;
    int32_t* default_left;
    float* value_bottom;
    uint8_t* value_set;
};

__global__ void __launch_bounds__(SPLIT_MAX_WARPS * 32)
split_level_kernel(const float* __restrict__ hist, int NN, int F, int NB,
                   int run, int vec, const void* is_cat_field, int cat_bytes,
                   const void* field_mask, int mask_bytes, float lam,
                   float gam, float mcw, float* __restrict__ f32_out,
                   int32_t* __restrict__ i32_out, Fold fold) {
    __shared__ float s_parent[2];
    __shared__ float s_v[SPLIT_MAX_WARPS], s_hl[SPLIT_MAX_WARPS];
    __shared__ int s_f[SPLIT_MAX_WARPS], s_t[SPLIT_MAX_WARPS];
    __shared__ int s_dl[SPLIT_MAX_WARPS];
    __shared__ int s_leaf;
    __shared__ float s_w;

    const int node = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_warps = blockDim.x >> 5;
    const int V = NB - 1;                          // value bins
    const int first = lane * run;
    const int cnt = max(0, min(run, V - first));   // this lane's value bins
    const float* node_hist = hist + static_cast<long long>(node) * F * NB * 2;

    float Gp = 0.f, Hp = 0.f, parent = 0.f;
    // the warp's best over its fields: gain, field, bin, missing left, HL
    float wv = -INFINITY, whl = 0.f;
    int wf = INT_MAX, wt = 0, wdl = 0;

    for (int f = warp; f < F; f += n_warps) {
        const float* fh = node_hist + static_cast<long long>(f) * NB * 2;
        float g[SPLIT_MAX_RUN], h[SPLIT_MAX_RUN];
#pragma unroll
        for (int j = 0; j < SPLIT_MAX_RUN; ++j) g[j] = h[j] = 0.f;
        if (vec) {
#pragma unroll
            for (int j = 0; j < SPLIT_MAX_RUN; j += 2) {
                if (j < cnt) {           // bins first+j, first+j+1 <= NB-1
                    const float4 q = __ldg(reinterpret_cast<const float4*>(
                        fh + 2 * (first + j)));
                    g[j] = q.x;
                    h[j] = q.y;
                    if (j + 1 < cnt) {
                        g[j + 1] = q.z;
                        h[j + 1] = q.w;
                    }
                }
            }
        } else {
#pragma unroll
            for (int j = 0; j < SPLIT_MAX_RUN; ++j) {
                if (j < cnt) {
                    const float2 q = __ldg(reinterpret_cast<const float2*>(
                        fh + 2 * (first + j)));
                    g[j] = q.x;
                    h[j] = q.y;
                }
            }
        }
        const float Gm = __ldg(fh + 2 * V), Hm = __ldg(fh + 2 * V + 1);

        // prefixes: the run's own, then the run's offset from a warp scan
        float cg[SPLIT_MAX_RUN], ch[SPLIT_MAX_RUN];
        cg[0] = g[0];
        ch[0] = h[0];
#pragma unroll
        for (int j = 1; j < SPLIT_MAX_RUN; ++j) {
            cg[j] = j < cnt ? __fadd_rn(cg[j - 1], g[j]) : cg[j - 1];
            ch[j] = j < cnt ? __fadd_rn(ch[j - 1], h[j]) : ch[j - 1];
        }
        float sg = cnt > 0 ? cg[SPLIT_MAX_RUN - 1] : 0.f;
        float sh = cnt > 0 ? ch[SPLIT_MAX_RUN - 1] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const float yg = __shfl_up_sync(FULL_MASK, sg, o);
            const float yh = __shfl_up_sync(FULL_MASK, sh, o);
            if (lane >= o) {
                sg = __fadd_rn(sg, yg);
                sh = __fadd_rn(sh, yh);
            }
        }
        float eg = __shfl_up_sync(FULL_MASK, sg, 1);   // exclusive offsets
        float eh = __shfl_up_sync(FULL_MASK, sh, 1);
        if (f == warp) {
            // every warp's first field; warp 0's is field 0, the parent
            if (warp == 0 && lane == 31) {
                s_parent[0] = __fadd_rn(sg, Gm);
                s_parent[1] = __fadd_rn(sh, Hm);
            }
            __syncthreads();
            Gp = s_parent[0];
            Hp = s_parent[1];
            parent = __fdiv_rn(__fmul_rn(Gp, Gp), __fadd_rn(Hp, lam));
        }
        if (lane > 0) {
#pragma unroll
            for (int j = 0; j < SPLIT_MAX_RUN; ++j) {
                cg[j] = __fadd_rn(eg, cg[j]);
                ch[j] = __fadd_rn(eh, ch[j]);
            }
        }

        const bool cat = flag_at(is_cat_field, cat_bytes, f) != 0;
        const bool on = flag_at(field_mask, mask_bytes, f) != 0;
        float bv = -INFINITY, bhl = 0.f;
        int bt = INT_MAX, bdl = 0;
#pragma unroll
        for (int j = 0; j < SPLIT_MAX_RUN; ++j) {
            if (j < cnt) {
                const float GL = cat ? g[j] : cg[j];
                const float HL = cat ? h[j] : ch[j];
                const float dr = gain_of(GL, HL, Gp, Hp, parent, lam, gam,
                                         mcw);
                const float dl = gain_of(__fadd_rn(GL, Gm), __fadd_rn(HL, Hm),
                                         Gp, Hp, parent, lam, gam, mcw);
                const bool go_left = dl > dr;
                float v = (isnan(dl) || isnan(dr)) ? NAN : fmaxf(dl, dr);
                v = on ? v : -INFINITY;
                if (beats(v, first + j, bv, bt)) {
                    bv = v;
                    bt = first + j;
                    bdl = go_left;
                    bhl = __fadd_rn(HL, go_left ? Hm : 0.f);
                }
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(FULL_MASK, bv, o);
            const int ot = __shfl_xor_sync(FULL_MASK, bt, o);
            const int odl = __shfl_xor_sync(FULL_MASK, bdl, o);
            const float ohl = __shfl_xor_sync(FULL_MASK, bhl, o);
            if (beats(ov, ot, bv, bt)) {
                bv = ov;
                bt = ot;
                bdl = odl;
                bhl = ohl;
            }
        }
        if (beats(bv, f, wv, wf)) {
            wv = bv;
            wf = f;
            wt = bt;
            wdl = bdl;
            whl = bhl;
        }
    }
    if (lane == 0) {
        s_v[warp] = wv;
        s_f[warp] = wf;
        s_t[warp] = wt;
        s_dl[warp] = wdl;
        s_hl[warp] = whl;
    }
    __syncthreads();

    if (threadIdx.x == 0) {
        int best = 0;
        for (int w = 1; w < n_warps; ++w)
            if (beats(s_v[w], s_f[w], s_v[best], s_f[best])) best = w;
        const float v = s_v[best];
        const float gain = isfinite(v) ? v : -1.f;
        const int f = s_f[best];
        const int cat = flag_at(is_cat_field, cat_bytes, f);
        f32_out[node] = gain;
        f32_out[NN + node] = Gp;
        f32_out[2 * NN + node] = Hp;
        f32_out[3 * NN + node] = s_hl[best];
        i32_out[node] = f;
        i32_out[NN + node] = s_t[best];
        i32_out[2 * NN + node] = cat;
        i32_out[3 * NN + node] = s_dl[best];
        if (fold.feature != nullptr) {
            const int k = node / fold.nn, i = node - k * fold.nn;
            const long long t = static_cast<long long>(k) * fold.n_int
                                + fold.off + i;
            const bool resolved =
                fold.value_set[static_cast<long long>(k) * fold.n_leaf
                               + static_cast<long long>(i) * fold.reps] != 0;
            const bool split = gain > 0.f && !resolved;
            fold.do_split[node] = split;
            fold.feature[t] = split ? f : -1;
            fold.threshold[t] = s_t[best];
            fold.is_cat[t] = cat;
            fold.default_left[t] = s_dl[best];
            s_leaf = !split && !resolved;
            s_w = __fdiv_rn(-Gp, __fadd_rn(Hp, lam));
        }
    }
    if (fold.feature == nullptr) return;
    __syncthreads();
    if (!s_leaf) return;
    const int k = node / fold.nn, i = node - k * fold.nn;
    const long long base = static_cast<long long>(k) * fold.n_leaf
                           + static_cast<long long>(i) * fold.reps;
    for (int j = threadIdx.x; j < fold.reps; j += blockDim.x) {
        if (!fold.value_set[base + j]) fold.value_bottom[base + j] = s_w;
        fold.value_set[base + j] = 1;
    }
}

// f32_out (4, NN): gain, node_g, node_h, left_h; i32_out (4, NN): feature,
// threshold, is_cat, default_left.  The fold's pointers are null on the
// search-only entry.
extern "C" int split_level_launch(
        const void* hist, int NN, int F, int NB, int vec,
        const void* is_cat_field, int cat_bytes, const void* field_mask,
        int mask_bytes, float lam, float gam, float mcw, void* f32_out,
        void* i32_out, int nn, int off, int reps, int n_int, int n_leaf,
        void* do_split, void* feature, void* threshold, void* is_cat,
        void* default_left, void* value_bottom, void* value_set,
        void* stream) {
    if (NN < 1 || F < 1 || NB < 2 || NB > 32 * SPLIT_MAX_RUN + 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int run = (NB - 1 + 31) / 32;
    const int warps = F < SPLIT_MAX_WARPS ? F : SPLIT_MAX_WARPS;
    const Fold fold{nn, off, reps, n_int, n_leaf,
                    static_cast<uint8_t*>(do_split),
                    static_cast<int32_t*>(feature),
                    static_cast<int32_t*>(threshold),
                    static_cast<int32_t*>(is_cat),
                    static_cast<int32_t*>(default_left),
                    static_cast<float*>(value_bottom),
                    static_cast<uint8_t*>(value_set)};
    split_level_kernel<<<NN, warps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(hist), NN, F, NB, run,
        vec && run % 2 == 0, is_cat_field, cat_bytes, field_mask, mask_bytes,
        lam, gam, mcw, static_cast<float*>(f32_out),
        static_cast<int32_t*>(i32_out), fold);
    return static_cast<int>(cudaGetLastError());
}
