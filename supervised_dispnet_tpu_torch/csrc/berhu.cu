// Masked BerHu (reverse Huber) loss with an adaptive threshold, forward and
// backward, for a group of predictions that share one target, for Hopper
// (sm_90a). Bound to Python with ctypes by ops/cuda/losses.py; built by
// ops/cuda/_build.py.
//
// Replaces supervised_dispnet_tpu/ops/pallas/losses.py::_berhu_kernel (the
// forward) and ::_berhu_bwd_kernel (the backward). A group is up to
// kMaxProblems predictions pred_s of gt's shape that share gt, the mask m
// and c_frac, each with a weight w_s. Per problem it computes
//   d = (pred_s - gt) * m,  c_s = max(c_frac * max|d|, 1e-6)  (stop-gradient),
//   loss_s = sum(m * (|d| <= c_s ? |d| : (d^2 + c_s^2) / 2c_s)) / max(sum(m), 1),
//   dpred_s = m^2 * (|d| <= c_s ? sign(d) : d / c_s) * w_s * g / max(sum(m), 1)
// (m^2: the mask scales d and weighs the sum; for a 0/1 mask it is m), and
// the weighted total ((0 + w_0 loss_0) + w_1 loss_1) + ..., in the order of
// the plain per-scale loop. An all-zero mask gives loss 0 with c = 1e-6. The
// multi-scale supervised loss is one group: its 4 scales, each upsampled to
// gt's size, weights (1, .5, .25, .125).
//
// What bounds it. At the main path's shape, (4, 128, 416) = 212,992 px with
// a one-byte mask and 4 problems, the forward must read 4 preds, gt and the
// mask once (21 B a pixel, 4.47 MB, 1.335 us at 3.35 TB/s) and the backward
// read as much and write 4 gradients (37 B a pixel, 7.88 MB, 2.352 us). Both
// are far below what a launch costs: what held BerHu back was the number of
// calls and launches. The Pallas kernel ran a sequential two-phase grid that
// carried max|d| and the sums from step to step; one scale at a time, that
// became a memset and three dependent kernels of ~2 us each per scale, so
// 16 launches, 4 memsets and 4 backward kernels a step, each call with its
// own host work.
//
// Design. One launch each way covers the group, and gt and the mask are read
// once for all its problems.
//   - berhu_forward_group_kernel is one cooperative launch (grid.sync(); the
//     grid is what the occupancy API says fits on the card at once, capped
//     by the work). Pass A keeps a max|d| per problem in each thread; a block
//     reduce writes the block's maxima to scratch. After the barrier every
//     block reduces all blocks' maxima itself, so every block holds the same
//     c_s and no word has to be zeroed first (no memset, no atomicMax). Pass
//     B sums the loss of each problem and the mask into per-block partials;
//     after the second barrier block 0 reduces them in a fixed order and
//     writes [loss_s, count, c_s] per problem and the total. No float
//     atomics: two runs give the same bits. Where the group's elements fit
//     kCacheItems a thread, pass A keeps them in registers for pass B;
//     otherwise pass B reads them again (from L2, at these sizes).
//   - berhu_backward_group_kernel is one elementwise launch: each thread
//     reads gt and the mask once and writes every problem's dpred, with
//     16-byte loads and stores where every pointer allows (a scalar tail).
//     c_s, the count and g are read from device memory: nothing goes back
//     to the host.
//   - berhu_forward_given_c_group_kernel is the forward with given
//     thresholds: c_s is read from device memory, so there is no pass A.
//     One cooperative launch: pass B into per-block partials, one barrier,
//     block 0 reduces them in a fixed order and writes each problem's sum
//     of terms and the mask's sum, not divided. A data-parallel step needs
//     it: c and the sums must be the global batch's, so the wrapper takes
//     the max of the first launch's c over the ranks, launches this, and
//     sums its sums over the ranks before it divides (ops/cuda/losses.py
//     berhu_stats). The backward reads the global count and c as it reads
//     the local ones.
// The problem table (pointers, weights) is a kernel parameter passed by
// value (__grid_constant__): no host-to-device copy. The single-problem
// entries of ops/cuda/losses.py are the same launches with one problem of
// weight 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxProblems = 8;  // ops/cuda/losses.py MAX_PROBLEMS

// A group's problems; ops/cuda/losses.py::_TABLE packs it. At file scope, not
// in the unnamed namespace: the C entries take it, and a type of internal
// linkage in their signature would give them internal linkage too.
struct BerhuTable {
    const float* pred[kMaxProblems];
    float* dpred[kMaxProblems];  // the backward's outputs
    float weight[kMaxProblems];
};

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCacheItems = 4;  // forward: elements a thread may keep across the barrier
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float mask_at(const uint8_t* m, long i) {
    return static_cast<float>(m[i]);
}

__device__ __forceinline__ float mask_at(const float* m, long i) { return m[i]; }

__device__ __forceinline__ float4 mask4(const uint8_t* m, long q) {
    const uchar4 v = reinterpret_cast<const uchar4*>(m)[q];
    return make_float4(v.x, v.y, v.z, v.w);
}

__device__ __forceinline__ float4 mask4(const float* m, long q) {
    return reinterpret_cast<const float4*>(m)[q];
}

struct MaxOp {
    __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

struct SumOp {
    __device__ float operator()(float a, float b) const { return a + b; }
};

// v[0, K) reduced over the block in a fixed order; every thread returns with
// the block's results (the same bits in each). Starts with a barrier, so
// that two calls in a row may share `part`.
template <int K, typename Op>
__device__ __forceinline__ void block_allreduce(float (&v)[K], Op op) {
    __shared__ float part[kWarps][K];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
        for (int o = 16; o > 0; o >>= 1) v[k] = op(v[k], __shfl_xor_sync(0xffffffffu, v[k], o));
    }
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) part[threadIdx.x >> 5][k] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
        float r = part[0][k];
        for (int w = 1; w < kWarps; ++w) r = op(r, part[w][k]);
        v[k] = r;
    }
}

// One element's BerHu term, already weighed by the mask.
__device__ __forceinline__ float berhu_term(float p, float g, float m, float c) {
    const float d = (p - g) * m;
    const float a = fabsf(d);
    return (a <= c ? a : (d * d + c * c) / (2.0f * c)) * m;
}

// One element's dL/dpred; scale = w * g / max(count, 1).
__device__ __forceinline__ float berhu_grad(float p, float g, float m, float c, float scale) {
    const float d = (p - g) * m;
    const float sign = static_cast<float>((d > 0.0f) - (d < 0.0f));
    return (fabsf(d) <= c ? sign : d / c) * (m * m) * scale;
}

// P: the problem slots compiled in (np <= P are used), so that each
// problem's max and sum live in registers. scratch: [np][gridDim.x] block
// maxima, then [np + 1][gridDim.x] block sums (loss of each problem, then the
// mask). out: [loss, count, c] of each problem, then the weighted total.
template <typename M, int P>
__global__ void __launch_bounds__(kThreads) berhu_forward_group_kernel(
        const __grid_constant__ BerhuTable t, const float* __restrict__ gt,
        const M* __restrict__ mask, long n, int np, float c_frac, float* out,
        float* scratch) {
    cg::grid_group grid = cg::this_grid();
    const int nblocks = gridDim.x;
    const long stride = static_cast<long>(nblocks) * kThreads;
    const long first = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
    const bool cached = n <= stride * kCacheItems;  // the same in every thread
    float g_c[kCacheItems], m_c[kCacheItems], p_c[kCacheItems][P];

    // pass A: max|d| of each problem
    float c[P];
#pragma unroll
    for (int s = 0; s < P; ++s) c[s] = 0.0f;
    if (cached) {
#pragma unroll
        for (int k = 0; k < kCacheItems; ++k) {
            const long i = first + k * stride;
            const bool in = i < n;  // out of range: p = g = m = 0, which adds nothing
            g_c[k] = in ? gt[i] : 0.0f;
            m_c[k] = in ? mask_at(mask, i) : 0.0f;
#pragma unroll
            for (int s = 0; s < P; ++s) {
                p_c[k][s] = in && s < np ? t.pred[s][i] : 0.0f;
                c[s] = fmaxf(c[s], fabsf((p_c[k][s] - g_c[k]) * m_c[k]));
            }
        }
    } else {
        for (long i = first; i < n; i += stride) {
            const float g = gt[i];
            const float m = mask_at(mask, i);
#pragma unroll
            for (int s = 0; s < P; ++s) {
                if (s < np) c[s] = fmaxf(c[s], fabsf((t.pred[s][i] - g) * m));
            }
        }
    }
    block_allreduce(c, MaxOp());
    float* block_max = scratch;
    float* block_sum = scratch + static_cast<long>(np) * nblocks;
    if (threadIdx.x == 0) {
#pragma unroll
        for (int s = 0; s < P; ++s) {
            if (s < np) block_max[s * nblocks + blockIdx.x] = c[s];
        }
    }
    grid.sync();

    // every block: c of each problem from all blocks' maxima (max is exact
    // in any order, so every block holds the same c)
#pragma unroll
    for (int s = 0; s < P; ++s) c[s] = 0.0f;
    for (int b = threadIdx.x; b < nblocks; b += kThreads) {
#pragma unroll
        for (int s = 0; s < P; ++s) {
            if (s < np) c[s] = fmaxf(c[s], __ldcg(block_max + s * nblocks + b));
        }
    }
    block_allreduce(c, MaxOp());
#pragma unroll
    for (int s = 0; s < P; ++s) c[s] = fmaxf(c_frac * c[s], 1e-6f);

    // pass B: the loss of each problem and the mask's sum
    float acc[P + 1];
#pragma unroll
    for (int s = 0; s <= P; ++s) acc[s] = 0.0f;
    if (cached) {
#pragma unroll
        for (int k = 0; k < kCacheItems; ++k) {
#pragma unroll
            for (int s = 0; s < P; ++s) {
                if (s < np) acc[s] += berhu_term(p_c[k][s], g_c[k], m_c[k], c[s]);
            }
            acc[P] += m_c[k];
        }
    } else {
        for (long i = first; i < n; i += stride) {
            const float g = gt[i];
            const float m = mask_at(mask, i);
#pragma unroll
            for (int s = 0; s < P; ++s) {
                if (s < np) acc[s] += berhu_term(t.pred[s][i], g, m, c[s]);
            }
            acc[P] += m;
        }
    }
    block_allreduce(acc, SumOp());
    if (threadIdx.x == 0) {
#pragma unroll
        for (int s = 0; s < P; ++s) {
            if (s < np) block_sum[s * nblocks + blockIdx.x] = acc[s];
        }
        block_sum[np * nblocks + blockIdx.x] = acc[P];
    }
    grid.sync();

    // block 0: the partials in a fixed order, then the stats and the total
    if (blockIdx.x != 0) return;
#pragma unroll
    for (int s = 0; s <= P; ++s) acc[s] = 0.0f;
    for (int b = threadIdx.x; b < nblocks; b += kThreads) {
#pragma unroll
        for (int s = 0; s < P; ++s) {
            if (s < np) acc[s] += __ldcg(block_sum + s * nblocks + b);
        }
        acc[P] += __ldcg(block_sum + np * nblocks + b);
    }
    block_allreduce(acc, SumOp());
    if (threadIdx.x == 0) {
        const float count = acc[P];
        float total = 0.0f;
#pragma unroll
        for (int s = 0; s < P; ++s) {
            if (s < np) {
                const float loss = acc[s] / fmaxf(count, 1.0f);
                out[3 * s] = loss;
                out[3 * s + 1] = count;
                out[3 * s + 2] = c[s];
                total = __fadd_rn(total, __fmul_rn(t.weight[s], loss));  // no FMA: the plain order
            }
        }
        out[3 * np] = total;
    }
}

// The forward with given thresholds: c[s] for problem s (device memory).
// scratch: [np + 1][gridDim.x] block sums; out: the sum of problem s's terms
// at out[s], the mask's sum at out[np] (np + 1 floats, unnormalised).
template <typename M, int P>
__global__ void __launch_bounds__(kThreads) berhu_forward_given_c_group_kernel(
        const __grid_constant__ BerhuTable t, const float* __restrict__ gt,
        const M* __restrict__ mask, long n, int np, const float* __restrict__ given_c,
        float* out, float* scratch) {
    cg::grid_group grid = cg::this_grid();
    const int nblocks = gridDim.x;
    const long stride = static_cast<long>(nblocks) * kThreads;
    float c[P], acc[P + 1];
#pragma unroll
    for (int s = 0; s < P; ++s) c[s] = s < np ? given_c[s] : 1.0f;
#pragma unroll
    for (int s = 0; s <= P; ++s) acc[s] = 0.0f;
    for (long i = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
        const float g = gt[i];
        const float m = mask_at(mask, i);
#pragma unroll
        for (int s = 0; s < P; ++s) {
            if (s < np) acc[s] += berhu_term(t.pred[s][i], g, m, c[s]);
        }
        acc[P] += m;
    }
    block_allreduce(acc, SumOp());
    if (threadIdx.x == 0) {
#pragma unroll
        for (int s = 0; s < P; ++s) {
            if (s < np) scratch[s * nblocks + blockIdx.x] = acc[s];
        }
        scratch[np * nblocks + blockIdx.x] = acc[P];
    }
    grid.sync();

    // block 0: the partials in a fixed order
    if (blockIdx.x != 0) return;
#pragma unroll
    for (int s = 0; s <= P; ++s) acc[s] = 0.0f;
    for (int b = threadIdx.x; b < nblocks; b += kThreads) {
#pragma unroll
        for (int s = 0; s < P; ++s) {
            if (s < np) acc[s] += __ldcg(scratch + s * nblocks + b);
        }
        acc[P] += __ldcg(scratch + np * nblocks + b);
    }
    block_allreduce(acc, SumOp());
    if (threadIdx.x == 0) {
#pragma unroll
        for (int s = 0; s < P; ++s) {
            if (s < np) out[s] = acc[s];
        }
        out[np] = acc[P];
    }
}

// stats: the forward's [loss, count, c] of each problem; grad: the upstream
// gradient of the total (one float). vec: every pointer allows 16-byte
// access, so the first n / 4 quads go as float4 and the rest as scalars.
template <typename M>
__global__ void __launch_bounds__(kThreads) berhu_backward_group_kernel(
        const __grid_constant__ BerhuTable t, const float* __restrict__ gt,
        const M* __restrict__ mask, long n, int np, int vec,
        const float* __restrict__ stats, const float* __restrict__ grad) {
    const float g = grad[0];
    const float count = fmaxf(stats[1], 1.0f);
    float c[kMaxProblems], scale[kMaxProblems];
#pragma unroll
    for (int s = 0; s < kMaxProblems; ++s) {
        c[s] = s < np ? stats[3 * s + 2] : 1.0f;
        scale[s] = s < np ? t.weight[s] * g / count : 0.0f;
    }
    const long stride = static_cast<long>(gridDim.x) * kThreads;
    const long first = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
    const long n4 = vec ? n / 4 : 0;
    for (long q = first; q < n4; q += stride) {
        const float4 gv = reinterpret_cast<const float4*>(gt)[q];
        const float4 mv = mask4(mask, q);
#pragma unroll
        for (int s = 0; s < kMaxProblems; ++s) {
            if (s < np) {
                const float4 pv = reinterpret_cast<const float4*>(t.pred[s])[q];
                reinterpret_cast<float4*>(t.dpred[s])[q] = make_float4(
                    berhu_grad(pv.x, gv.x, mv.x, c[s], scale[s]),
                    berhu_grad(pv.y, gv.y, mv.y, c[s], scale[s]),
                    berhu_grad(pv.z, gv.z, mv.z, c[s], scale[s]),
                    berhu_grad(pv.w, gv.w, mv.w, c[s], scale[s]));
            }
        }
    }
    for (long i = 4 * n4 + first; i < n; i += stride) {
        const float gi = gt[i];
        const float m = mask_at(mask, i);
#pragma unroll
        for (int s = 0; s < kMaxProblems; ++s) {
            if (s < np) t.dpred[s][i] = berhu_grad(t.pred[s][i], gi, m, c[s], scale[s]);
        }
    }
}

bool aligned(const void* p, uintptr_t bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

bool bad_group(const BerhuTable* t, int np, long n, const float* gt, const void* mask,
               bool backward) {
    if (t == nullptr || np < 1 || np > kMaxProblems || n < 0 || gt == nullptr
        || mask == nullptr) {
        return true;
    }
    for (int s = 0; s < np; ++s) {
        if (t->pred[s] == nullptr || (backward && t->dpred[s] == nullptr)) return true;
    }
    return false;
}

// The blocks of `fn` that fit on the card at once (occupancy x SMs), for a
// cooperative launch; computed once per device and kernel. Concurrent first
// calls compute the same value, so the unguarded cache is benign.
cudaError_t coresident_blocks(const void* fn, int device, int* cache, int* blocks) {
    if (device >= 0 && device < kMaxDevices && cache[device] > 0) {
        *blocks = cache[device];
        return cudaSuccess;
    }
    int cooperative = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return err;
    if (!cooperative) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    *blocks = per_sm * sms;
    if (device >= 0 && device < kMaxDevices) cache[device] = *blocks;
    return cudaSuccess;
}

template <typename M, int P>
cudaError_t launch_forward(const BerhuTable& t, int np, const float* gt, const M* mask,
                           long n, float c_frac, float* out, float* scratch,
                           int scratch_blocks, int device, cudaStream_t stream) {
    static int cache[kMaxDevices] = {};
    const void* fn = reinterpret_cast<const void*>(&berhu_forward_group_kernel<M, P>);
    int blocks = 0;
    cudaError_t err = coresident_blocks(fn, device, cache, &blocks);
    if (err != cudaSuccess) return err;
    // as few blocks as hold every element in registers, kCacheItems a
    // thread; where that is more than fit at once, all that fit (pass B
    // then reads the elements again)
    const long work = (n + kThreads * kCacheItems - 1) / (kThreads * kCacheItems);
    long grid = blocks < work ? blocks : work;
    grid = grid < scratch_blocks ? grid : scratch_blocks;
    grid = grid < 1 ? 1 : grid;
    void* args[] = {const_cast<BerhuTable*>(&t), &gt, &mask, &n, &np, &c_frac, &out, &scratch};
    const cudaError_t launch = cudaLaunchCooperativeKernel(
        fn, dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, 0, stream);
    const cudaError_t last = cudaGetLastError();
    return launch != cudaSuccess ? launch : last;
}

template <typename M>
cudaError_t dispatch_forward(const BerhuTable& t, int np, const float* gt, const void* mask,
                           long n, float c_frac, float* out, float* scratch,
                           int scratch_blocks, int device, cudaStream_t stream) {
    const M* m = static_cast<const M*>(mask);
    if (np <= 1) {
        return launch_forward<M, 1>(t, np, gt, m, n, c_frac, out, scratch, scratch_blocks,
                                    device, stream);
    }
    if (np <= 2) {
        return launch_forward<M, 2>(t, np, gt, m, n, c_frac, out, scratch, scratch_blocks,
                                    device, stream);
    }
    if (np <= 4) {
        return launch_forward<M, 4>(t, np, gt, m, n, c_frac, out, scratch, scratch_blocks,
                                    device, stream);
    }
    return launch_forward<M, kMaxProblems>(t, np, gt, m, n, c_frac, out, scratch,
                                           scratch_blocks, device, stream);
}

template <typename M, int P>
cudaError_t launch_given_c(const BerhuTable& t, int np, const float* gt, const M* mask, long n,
                           const float* c, float* out, float* scratch, int scratch_blocks,
                           int device, cudaStream_t stream) {
    static int cache[kMaxDevices] = {};
    const void* fn = reinterpret_cast<const void*>(&berhu_forward_given_c_group_kernel<M, P>);
    int blocks = 0;
    cudaError_t err = coresident_blocks(fn, device, cache, &blocks);
    if (err != cudaSuccess) return err;
    // the forward's grid: kCacheItems elements a thread where that fits
    const long work = (n + kThreads * kCacheItems - 1) / (kThreads * kCacheItems);
    long grid = blocks < work ? blocks : work;
    grid = grid < scratch_blocks ? grid : scratch_blocks;
    grid = grid < 1 ? 1 : grid;
    void* args[] = {const_cast<BerhuTable*>(&t), &gt, &mask, &n, &np, &c, &out, &scratch};
    const cudaError_t launch = cudaLaunchCooperativeKernel(
        fn, dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, 0, stream);
    const cudaError_t last = cudaGetLastError();
    return launch != cudaSuccess ? launch : last;
}

template <typename M>
cudaError_t dispatch_given_c(const BerhuTable& t, int np, const float* gt, const void* mask,
                             long n, const float* c, float* out, float* scratch,
                             int scratch_blocks, int device, cudaStream_t stream) {
    const M* m = static_cast<const M*>(mask);
    if (np <= 1) {
        return launch_given_c<M, 1>(t, np, gt, m, n, c, out, scratch, scratch_blocks, device,
                                    stream);
    }
    if (np <= 2) {
        return launch_given_c<M, 2>(t, np, gt, m, n, c, out, scratch, scratch_blocks, device,
                                    stream);
    }
    if (np <= 4) {
        return launch_given_c<M, 4>(t, np, gt, m, n, c, out, scratch, scratch_blocks, device,
                                    stream);
    }
    return launch_given_c<M, kMaxProblems>(t, np, gt, m, n, c, out, scratch, scratch_blocks,
                                           device, stream);
}

}  // namespace

extern "C" {

// Forward of a group of np problems (the table's first np rows) sharing gt,
// mask and c_frac, in one cooperative launch. `out` receives np x [loss,
// count, c] and the weighted total (3 np + 1 floats); `scratch` holds
// (2 np + 1) x scratch_blocks floats, and the grid takes at most
// scratch_blocks blocks. `mask_is_float` selects a float32 mask, else one
// byte per element (bool or uint8). Returns the launch's CUDA error as an
// int.
int berhu_forward_many(const BerhuTable* table, int np, const float* gt, const void* mask,
                       int mask_is_float, long n, float c_frac, float* out, float* scratch,
                       int scratch_blocks, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (bad_group(table, np, n, gt, mask, false) || out == nullptr || scratch == nullptr
        || scratch_blocks < 1) {
        return cudaErrorInvalidValue;
    }
    cudaStream_t strm = static_cast<cudaStream_t>(stream);
    if (mask_is_float) {
        return dispatch_forward<float>(*table, np, gt, mask, n, c_frac, out, scratch,
                                       scratch_blocks, device, strm);
    }
    return dispatch_forward<uint8_t>(*table, np, gt, mask, n, c_frac, out, scratch,
                                     scratch_blocks, device, strm);
}

// Forward of a group with given thresholds c[0, np) (device memory), in one
// cooperative launch. `out` receives each problem's sum of terms and the
// mask's sum (np + 1 floats, unnormalised); `scratch` holds (np + 1) x
// scratch_blocks floats. Returns the launch's CUDA error as an int.
int berhu_forward_given_c_many(const BerhuTable* table, int np, const float* gt,
                               const void* mask, int mask_is_float, long n, const float* c,
                               float* out, float* scratch, int scratch_blocks, int device,
                               void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (bad_group(table, np, n, gt, mask, false) || c == nullptr || out == nullptr
        || scratch == nullptr || scratch_blocks < 1) {
        return cudaErrorInvalidValue;
    }
    cudaStream_t strm = static_cast<cudaStream_t>(stream);
    if (mask_is_float) {
        return dispatch_given_c<float>(*table, np, gt, mask, n, c, out, scratch, scratch_blocks,
                                       device, strm);
    }
    return dispatch_given_c<uint8_t>(*table, np, gt, mask, n, c, out, scratch, scratch_blocks,
                                     device, strm);
}

// Backward of a group: each problem's dpred (the table's dpred rows) from the
// forward's `stats` and the upstream gradient `grad` of the total (one float
// on the device), in one launch.
int berhu_backward_many(const BerhuTable* table, int np, const float* gt, const void* mask,
                        int mask_is_float, long n, const float* stats, const float* grad,
                        int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (bad_group(table, np, n, gt, mask, true) || stats == nullptr || grad == nullptr) {
        return cudaErrorInvalidValue;
    }
    const BerhuTable& t = *table;
    bool vec = aligned(gt, 16) && aligned(mask, mask_is_float ? 16 : 4);
    for (int s = 0; s < np; ++s) vec = vec && aligned(t.pred[s], 16) && aligned(t.dpred[s], 16);
    const long items = vec ? n / 4 + n % 4 : n;  // threads' work: quads, then the tail
    long blocks = (items + kThreads - 1) / kThreads;
    blocks = blocks < 1 ? 1 : (blocks > 8192 ? 8192 : blocks);
    cudaStream_t strm = static_cast<cudaStream_t>(stream);
    if (mask_is_float) {
        berhu_backward_group_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, strm>>>(
            t, gt, static_cast<const float*>(mask), n, np, vec, stats, grad);
    } else {
        berhu_backward_group_kernel<uint8_t><<<static_cast<unsigned>(blocks), kThreads, 0,
                                               strm>>>(
            t, gt, static_cast<const uint8_t*>(mask), n, np, vec, stats, grad);
    }
    return cudaGetLastError();
}

const char* berhu_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
