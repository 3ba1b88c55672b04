// Masked BerHu (reverse Huber) loss with an adaptive threshold, forward and
// backward, for Hopper (sm_90a). Bound to Python with ctypes by
// ops/cuda/losses.py; built by ops/cuda/_build.py.
//
// Replaces supervised_dispnet_tpu/ops/pallas/losses.py::_berhu_kernel (the
// forward) and ::_berhu_bwd_kernel (the backward). It computes
//   d = (pred - gt) * m,  c = max(c_frac * max|d|, 1e-6),
//   loss = sum(m * (|d| <= c ? |d| : (d^2 + c^2) / 2c)) / max(sum(m), 1),
//   dpred = m^2 * (|d| <= c ? sign(d) : d / c) * g / max(sum(m), 1)
// (m^2: the mask scales d and weighs the sum; for a 0/1 mask it is m).
//
// Design. The Pallas kernel ran one sequential two-phase grid that carried
// max|d| and the sums from step to step in scalar memory. Blocks on Hopper
// run in no order, so the forward is three launches on one stream instead:
//   1. berhu_max_kernel: grid-stride masked max|d|, a block reduce, then one
//      atomicMax on the float's bit pattern per block. That is exact because
//      |d| >= 0, where IEEE-754 order and unsigned-integer order agree.
//   2. berhu_sum_kernel: per-block partial sums of the loss and of the mask
//      into a scratch buffer. No float atomics, so the result is the same on
//      every run.
//   3. berhu_final_kernel: one block sums the partials in a fixed order and
//      writes [loss, count, c] to device memory. Nothing is read back to the
//      host. An all-zero mask gives loss 0 with c = 1e-6.
// pred - gt is fused into every pass, so no diff map is written, and the
// ragged edge is masked by index (no padding to the TPU's 512 x 128 tiles).
// The backward is one elementwise kernel that reads c and count from the
// forward's output tensor and g from the device.
//
// Bound: memory. At the main-path shape (4, 128, 416) = 212,992 px with a
// one-byte mask, the forward reads pred, gt and the mask twice (~3.8 MB,
// ~1.1 us at 3.35 TB/s); the backward reads ~1.9 MB and writes 0.85 MB
// (~0.8 us). At that size both are bounded by launch latency in practice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float mask_at(const uint8_t* m, long i) {
    return static_cast<float>(m[i]);
}

__device__ __forceinline__ float mask_at(const float* m, long i) { return m[i]; }

__device__ __forceinline__ float threshold(float c_frac, const unsigned* max_bits) {
    return fmaxf(c_frac * __uint_as_float(*max_bits), 1e-6f);
}

// Block-wide reductions over kThreads threads; the result is valid in thread 0.
// Each starts with a barrier so that two calls in a row may share `partial`.
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

__device__ float block_max(float v) {
    __shared__ float partial[kWarps];
    __syncthreads();
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
    __syncthreads();
    v = threadIdx.x < kWarps ? partial[threadIdx.x] : 0.0f;
    if (threadIdx.x < 32) {
        for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    }
    return v;
}

template <typename M>
__global__ void __launch_bounds__(kThreads) berhu_max_kernel(
        const float* __restrict__ pred, const float* __restrict__ gt,
        const M* __restrict__ mask, long n, unsigned* max_bits) {
    float mx = 0.0f;
    for (long i = blockIdx.x * (long)kThreads + threadIdx.x; i < n;
         i += (long)gridDim.x * kThreads) {
        mx = fmaxf(mx, fabsf((pred[i] - gt[i]) * mask_at(mask, i)));
    }
    mx = block_max(mx);
    if (threadIdx.x == 0) atomicMax(max_bits, __float_as_uint(mx));
}

template <typename M>
__global__ void __launch_bounds__(kThreads) berhu_sum_kernel(
        const float* __restrict__ pred, const float* __restrict__ gt,
        const M* __restrict__ mask, long n, float c_frac,
        const unsigned* max_bits, float* partials) {
    const float c = threshold(c_frac, max_bits);
    float loss = 0.0f;
    float count = 0.0f;
    for (long i = blockIdx.x * (long)kThreads + threadIdx.x; i < n;
         i += (long)gridDim.x * kThreads) {
        const float m = mask_at(mask, i);
        const float d = (pred[i] - gt[i]) * m;
        const float a = fabsf(d);
        const float per = a <= c ? a : (d * d + c * c) / (2.0f * c);
        loss += per * m;
        count += m;
    }
    loss = block_sum(loss);
    count = block_sum(count);
    if (threadIdx.x == 0) {
        partials[blockIdx.x] = loss;
        partials[gridDim.x + blockIdx.x] = count;
    }
}

__global__ void __launch_bounds__(kThreads) berhu_final_kernel(
        const float* __restrict__ partials, int nblocks, float c_frac,
        const unsigned* max_bits, float* out) {
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
        out[2] = threshold(c_frac, max_bits);
    }
}

template <typename M>
__global__ void __launch_bounds__(kThreads) berhu_bwd_kernel(
        const float* __restrict__ pred, const float* __restrict__ gt,
        const M* __restrict__ mask, long n, const float* __restrict__ stats,
        const float* __restrict__ grad, float* __restrict__ dpred) {
    const float c = stats[2];
    const float scale = grad[0] / fmaxf(stats[1], 1.0f);
    for (long i = blockIdx.x * (long)kThreads + threadIdx.x; i < n;
         i += (long)gridDim.x * kThreads) {
        const float m = mask_at(mask, i);
        const float d = (pred[i] - gt[i]) * m;
        const float sign = static_cast<float>((d > 0.0f) - (d < 0.0f));
        dpred[i] = (fabsf(d) <= c ? sign : d / c) * (m * m) * scale;
    }
}

template <typename M>
cudaError_t launch_forward(const float* pred, const float* gt, const M* mask,
                           long n, float c_frac, int nblocks, float* scratch,
                           float* out, cudaStream_t stream) {
    unsigned* max_bits = reinterpret_cast<unsigned*>(scratch + 2 * (long)nblocks);
    cudaError_t err = cudaMemsetAsync(max_bits, 0, sizeof(unsigned), stream);
    if (err != cudaSuccess) return err;
    berhu_max_kernel<M><<<nblocks, kThreads, 0, stream>>>(pred, gt, mask, n, max_bits);
    berhu_sum_kernel<M><<<nblocks, kThreads, 0, stream>>>(
        pred, gt, mask, n, c_frac, max_bits, scratch);
    berhu_final_kernel<<<1, kThreads, 0, stream>>>(scratch, nblocks, c_frac, max_bits, out);
    return cudaGetLastError();
}

int elementwise_blocks(long n) {
    const long blocks = (n + kThreads - 1) / kThreads;
    return static_cast<int>(blocks < 1 ? 1 : (blocks > 8192 ? 8192 : blocks));
}

}  // namespace

extern "C" {

// Forward. `scratch` holds 2 * nblocks + 1 floats; `out` receives
// [loss, count, c]. `mask_is_float` selects a float32 mask, else one byte per
// element (bool or uint8). Returns cudaGetLastError() as an int.
int berhu_forward(const float* pred, const float* gt, const void* mask,
                  int mask_is_float, long n, float c_frac, int nblocks,
                  float* scratch, float* out, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (nblocks < 1) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mask_is_float) {
        err = launch_forward(pred, gt, static_cast<const float*>(mask), n, c_frac,
                             nblocks, scratch, out, s);
    } else {
        err = launch_forward(pred, gt, static_cast<const uint8_t*>(mask), n, c_frac,
                             nblocks, scratch, out, s);
    }
    return err;
}

// Backward: dpred from the forward's [loss, count, c] and the upstream
// gradient `grad` (one float on the device).
int berhu_backward(const float* pred, const float* gt, const void* mask,
                   int mask_is_float, long n, const float* stats,
                   const float* grad, float* dpred, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int blocks = elementwise_blocks(n);
    if (mask_is_float) {
        berhu_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
            pred, gt, static_cast<const float*>(mask), n, stats, grad, dpred);
    } else {
        berhu_bwd_kernel<uint8_t><<<blocks, kThreads, 0, s>>>(
            pred, gt, static_cast<const uint8_t*>(mask), n, stats, grad, dpred);
    }
    return cudaGetLastError();
}

const char* berhu_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
