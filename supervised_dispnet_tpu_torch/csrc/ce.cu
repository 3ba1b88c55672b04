// Masked per-pixel cross-entropy over depth bins, forward and backward, for
// Hopper (sm_90a). Bound to Python with ctypes by ops/cuda/classification.py;
// built by ops/cuda/_build.py.
//
// Replaces supervised_dispnet_tpu/ops/pallas/losses.py::_ce_kernel (the
// forward) and ::_ce_bwd_kernel (the backward). For logits x (B, P, K) over
// K bins, int labels y and a mask m (B, P):
//   nll = logsumexp(x) - x[y],  loss = sum(m * nll) / max(sum(m), 1),
//   dx = (softmax(x) - onehot(y)) * m * g / max(sum(m), 1).
// A label outside [0, K) gives NaN (it never reads outside the pixel's row).
//
// Design. The Pallas kernel padded K to 128 lanes with -1e30 and rows to
// 512, picked the label's logit with an iota == label compare, and carried
// the two sums from grid step to grid step in scalar memory. Here one thread
// owns one pixel: it takes the max over K, then sum exp(x - max) with expf /
// logf, then loads x[y] directly; no padding, the ragged tail is masked by
// index. The logits are read in place through (batch, pixel, bin) strides:
// in the (B, H, W, K) view of the conv head's NCHW output, bin k of a pixel
// lies at k * H * W, so a warp's 32 pixels read 32 consecutive floats for
// every k (coalesced) and no transposed copy is made either way; contiguous
// (..., K) logits are taken too. Blocks run in no order, so the forward is
// two launches on one stream, BerHu's scheme: per-block partial sums of
// (m * nll, m) in a fixed reduction order into scratch, then one block sums
// the partials in a fixed order into [loss, count] in device memory. No
// float atomics: the loss is the same on every run, and nothing is read back
// to the host. The backward is one launch, one thread a pixel: it computes
// the max and the sum of exps again and writes K gradients in the logits'
// layout; g / count comes from device memory (no host sync).
//
// Bound: memory. At the main path's shape (4, 128, 416, 64) the forward
// reads 54.5 MB of logits, 0.85 MB of labels and 0.21 MB of a byte mask
// (~16.6 us at 3.35 TB/s); the backward reads as much and writes 54.5 MB
// (~33 us). The second pass over a pixel's K logits is served from L1/L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float mask_at(const uint8_t* m, long i) {
    return static_cast<float>(m[i]);
}

__device__ __forceinline__ float mask_at(const float* m, long i) { return m[i]; }

// Block-wide sum over kThreads threads; the result is valid in thread 0.
// It starts with a barrier so that two calls in a row may share `partial`.
__device__ float block_sum(float v) {
    __shared__ float partial[kWarps];
    __syncthreads();
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
    __syncthreads();
    v = threadIdx.x < kWarps ? partial[threadIdx.x] : 0.0f;
    if (threadIdx.x < 32) {
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    }
    return v;
}

struct Layout {
    long P;   // pixels of one batch entry
    int K;    // bins
    long sb;  // batch stride
    long sp;  // pixel stride
    long sk;  // bin stride
    __device__ long row(long i) const { return (i / P) * sb + (i % P) * sp; }
};

// The max of a pixel's K logits and the sum of exp(x - max).
__device__ __forceinline__ void row_stats(const float* __restrict__ row, const Layout& L,
                                          float* mx, float* sum) {
    float m = -INFINITY;
    for (int k = 0; k < L.K; ++k) m = fmaxf(m, row[k * L.sk]);
    float s = 0.0f;
    for (int k = 0; k < L.K; ++k) s += expf(row[k * L.sk] - m);
    *mx = m;
    *sum = s;
}

template <typename M>
__global__ void __launch_bounds__(kThreads) ce_sum_kernel(
        const float* __restrict__ logits, const int* __restrict__ labels,
        const M* __restrict__ mask, long n, Layout L, float* __restrict__ partials) {
    float loss = 0.0f;
    float count = 0.0f;
    for (long i = blockIdx.x * (long)kThreads + threadIdx.x; i < n;
         i += (long)gridDim.x * kThreads) {
        const float* row = logits + L.row(i);
        const int y = labels[i];
        const float w = mask_at(mask, i);
        float mx, s;
        row_stats(row, L, &mx, &s);
        const float nll = (y >= 0 && y < L.K) ? mx + logf(s) - row[y * L.sk] : NAN;
        loss += nll * w;
        count += w;
    }
    loss = block_sum(loss);
    count = block_sum(count);
    if (threadIdx.x == 0) {
        partials[blockIdx.x] = loss;
        partials[gridDim.x + blockIdx.x] = count;
    }
}

__global__ void __launch_bounds__(kThreads) ce_final_kernel(
        const float* __restrict__ partials, int nblocks, float* __restrict__ out) {
    float loss = 0.0f;
    float count = 0.0f;
    for (int i = threadIdx.x; i < nblocks; i += kThreads) {
        loss += partials[i];
        count += partials[nblocks + i];
    }
    loss = block_sum(loss);
    count = block_sum(count);
    if (threadIdx.x == 0) {
        out[0] = loss / fmaxf(count, 1.0f);
        out[1] = count;
    }
}

template <typename M>
__global__ void __launch_bounds__(kThreads) ce_bwd_kernel(
        const float* __restrict__ logits, const int* __restrict__ labels,
        const M* __restrict__ mask, long n, Layout L, const float* __restrict__ stats,
        const float* __restrict__ grad, float* __restrict__ dlogits) {
    const float scale = grad[0] / fmaxf(stats[1], 1.0f);
    for (long i = blockIdx.x * (long)kThreads + threadIdx.x; i < n;
         i += (long)gridDim.x * kThreads) {
        const long off = L.row(i);
        const float* row = logits + off;
        float* drow = dlogits + off;
        const int y = labels[i];
        const float w = (y >= 0 && y < L.K) ? mask_at(mask, i) * scale : NAN;
        float mx, s;
        row_stats(row, L, &mx, &s);
        for (int k = 0; k < L.K; ++k) {
            const float p = expf(row[k * L.sk] - mx) / s;
            drow[k * L.sk] = (k == y ? p - 1.0f : p) * w;
        }
    }
}

int grid_blocks(long n) {
    const long blocks = (n + kThreads - 1) / kThreads;
    return static_cast<int>(blocks < 1 ? 1 : (blocks > 8192 ? 8192 : blocks));
}

}  // namespace

extern "C" {

// Forward. `scratch` holds 2 * nblocks floats; `out` receives [loss, count].
// `mask_is_float` selects a float32 mask, else one byte per pixel (bool or
// uint8). Logit (b, p, k) lies at b * sb + p * sp + k * sk; labels and mask
// are contiguous (B, P). Returns cudaGetLastError() as an int.
int ce_forward(const float* logits, const int* labels, const void* mask, int mask_is_float,
               long B, long P, int K, long sb, long sp, long sk, int nblocks,
               float* scratch, float* out, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (nblocks < 1 || K < 1 || B * P < 1) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Layout L{P, K, sb, sp, sk};
    const long n = B * P;
    if (mask_is_float) {
        ce_sum_kernel<float><<<nblocks, kThreads, 0, s>>>(
            logits, labels, static_cast<const float*>(mask), n, L, scratch);
    } else {
        ce_sum_kernel<uint8_t><<<nblocks, kThreads, 0, s>>>(
            logits, labels, static_cast<const uint8_t*>(mask), n, L, scratch);
    }
    ce_final_kernel<<<1, kThreads, 0, s>>>(scratch, nblocks, out);
    return cudaGetLastError();
}

// Backward: dlogits, in the logits' layout, from the forward's [loss, count]
// and the upstream gradient `grad` (one float on the device).
int ce_backward(const float* logits, const int* labels, const void* mask, int mask_is_float,
                long B, long P, int K, long sb, long sp, long sk, const float* stats,
                const float* grad, float* dlogits, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (K < 1 || B * P < 1) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Layout L{P, K, sb, sp, sk};
    const long n = B * P;
    const int blocks = grid_blocks(n);
    if (mask_is_float) {
        ce_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
            logits, labels, static_cast<const float*>(mask), n, L, stats, grad, dlogits);
    } else {
        ce_bwd_kernel<uint8_t><<<blocks, kThreads, 0, s>>>(
            logits, labels, static_cast<const uint8_t*>(mask), n, L, stats, grad, dlogits);
    }
    return cudaGetLastError();
}

const char* ce_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
