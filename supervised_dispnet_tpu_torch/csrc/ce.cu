// Masked per-pixel cross-entropy over depth bins, forward and backward, for
// Hopper (sm_90a). Bound to Python with ctypes by ops/cuda/classification.py;
// built by ops/cuda/_build.py.
//
// Replaces supervised_dispnet_tpu/ops/pallas/losses.py::_ce_kernel (the
// forward) and ::_ce_bwd_kernel (the backward). For logits x (B, P, K) over
// K bins, int labels y and a mask m (B, P):
//   lse = logsumexp(x),  loss = sum(m * (lse - x[y])) / max(sum(m), 1),
//   dx = (exp(x - lse) - onehot(y)) * m * g / max(sum(m), 1).
// A label outside [0, K) gives NaN (it never reads outside the pixel's row).
//
// What bounds it: bytes. At the main path's shape (4, 128, 416, 64) the
// forward must read 54.5 MB of logits, 0.85 MB of labels and 0.21 MB of a
// byte mask and write each pixel's lse (8 B, below), 57.3 MB or 17.1 us at
// 3.35 TB/s; the backward reads as much and writes 54.5 MB of gradient
// (33.4 us).
//
// Design.
//   - One pass over each logit. The forward keeps a running max m and a
//     running sum s = sum exp(x - m) per pixel, folding kChunk bins at a
//     time (their max first, then s rescaled once to the new max), and takes
//     x[y] in the same pass by comparing the bin index. m starts at -inf and
//     s at 0. A fold whose new max is still -inf subtracts 0 in place of it,
//     so the start and leading -inf bins add exp(-inf) = 0 rather than
//     exp(-inf - (-inf)) = NaN; a row of only -inf gives lse = -inf, as
//     logsumexp does, and a NaN loss, as the reference does.
//   - The lse is kept for the backward as two floats a pixel: hi = m + log s
//     rounded, and lo = (m - hi) + log s, the rounding error of hi (exact
//     where |m| >= log s). The backward's p = exp((x - hi) - lo) is then as
//     accurate as exp(x - m) / s: x - hi is exact for the bins that matter.
//     One float would leave x - lse off by up to half an ulp of lse, which
//     at |x| ~ 3e4 is ~1e-3 of p, far above the 1e-5 the kernels are held to.
//   - Several pixels a thread. In the (B, H, W, K) view of the conv head's
//     NCHW output (pixel stride 1, bin stride H * W) a thread takes 4
//     consecutive pixels: a float4 load per bin, labels as int4, a byte mask
//     as uchar4 (a float mask as float4); a warp reads 512 consecutive bytes
//     a bin. Where P, the batch or bin stride or a pointer does not allow
//     16-byte access, and for contiguous (..., K) logits, the wrapper picks
//     the scalar path: one pixel a thread, the same arithmetic.
//   - K is known only at run time: each fold unrolls its kChunk loads, so
//     they are in flight together for any K, and a tail of single bins
//     takes the rest. 256 threads a block, 8-bin folds and streaming cache
//     hints on the 16-byte accesses (__ldcs / __stcs: each is touched once):
//     no other build of scripts/ce_variants.py (block size, fold width,
//     K = 64 compiled, an unrolled fold loop, no hints) is faster on the card
//     by more than the ~1 us that a build's time moves with its place in
//     the run.
//   - The forward is one launch. Each block reduces (m * nll, m) in a fixed
//     order into per-block partials; the last block to finish (a
//     __threadfence, then an integer ticket) sums all the partials in a
//     fixed order into [loss, count] and sets the ticket back to 0 for the
//     next launch. The ticket is one word per device and stream, zeroed once
//     when the wrapper allocates it. No memset and no float atomics: the
//     same bits on every run, and nothing is read back to the host.
//   - The backward reads each logit once and writes its gradient once, from
//     the forward's lse; g / count comes from device memory (no host sync).
//     Masked-out pixels still read their logits and write p * 0, so a
//     non-finite logit or a bad label there gives NaN, as in the reference.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;  // bins a fold takes: loads in flight a thread

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

// L consecutive floats (L = 4: one 16-byte access, marked as read once:
// evict-first, as the stores are), labels and mask values.
template <int L>
__device__ __forceinline__ void load(const float* __restrict__ p, float (&v)[L]) {
    if constexpr (L == 4) {
        const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
        v[0] = *p;
    }
}

template <int L>
__device__ __forceinline__ void store(float* __restrict__ p, const float (&v)[L]) {
    if constexpr (L == 4) {
        __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    } else {
        *p = v[0];
    }
}

template <int L>
__device__ __forceinline__ void load(const int* __restrict__ p, int (&v)[L]) {
    if constexpr (L == 4) {
        const int4 q = *reinterpret_cast<const int4*>(p);
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
        v[0] = *p;
    }
}

template <int L>
__device__ __forceinline__ void load_mask(const uint8_t* __restrict__ p, float (&w)[L]) {
    if constexpr (L == 4) {
        const uchar4 q = *reinterpret_cast<const uchar4*>(p);
        w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
    } else {
        w[0] = static_cast<float>(*p);
    }
}

template <int L>
__device__ __forceinline__ void load_mask(const float* __restrict__ p, float (&w)[L]) {
    load<L>(p, w);
}

// Running statistics of L pixels: max m, s = sum exp(x - m), and x[y].
template <int L>
struct Running {
    float m[L], s[L], xy[L];
};

// Folds bins k0 .. k0 + C - 1 (v[c][l]: bin k0 + c of pixel l) into r.
template <int L, int C>
__device__ __forceinline__ void fold(Running<L>& r, const float (&v)[C][L], int k0,
                                     const int (&y)[L]) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
        float cm = v[0][l];
#pragma unroll
        for (int c = 1; c < C; ++c) cm = fmaxf(cm, v[c][l]);
        const float m = fmaxf(r.m[l], cm);
        const float base = m == -INFINITY ? 0.0f : m;
        float s = r.s[l] * expf(r.m[l] - base);
#pragma unroll
        for (int c = 0; c < C; ++c) {
            s += expf(v[c][l] - base);
            r.xy[l] = k0 + c == y[l] ? v[c][l] : r.xy[l];
        }
        r.m[l] = m;
        r.s[l] = s;
    }
}

template <int L, int C>
__device__ __forceinline__ void fold_bins(Running<L>& r, const float* __restrict__ row, long sk,
                                          int k0, const int (&y)[L]) {
    float v[C][L];
#pragma unroll
    for (int c = 0; c < C; ++c) load<L>(row + (k0 + c) * sk, v[c]);
    fold<L, C>(r, v, k0, y);
}

// The running statistics of L pixels' K bins, bin k at row[k * sk].
template <int L>
__device__ __forceinline__ Running<L> row_stats(const float* __restrict__ row, long sk, int K,
                                                const int (&y)[L]) {
    Running<L> r;
#pragma unroll
    for (int l = 0; l < L; ++l) r.m[l] = -INFINITY, r.s[l] = 0.0f, r.xy[l] = 0.0f;
    int k0 = 0;
#pragma unroll 1
    for (; k0 + kChunk <= K; k0 += kChunk) fold_bins<L, kChunk>(r, row, sk, k0, y);
#pragma unroll 1
    for (; k0 < K; ++k0) fold_bins<L, 1>(r, row, sk, k0, y);
    return r;
}

// dx of bins k0 .. k0 + C - 1 of L pixels: one read and one write each.
template <int L, int C>
__device__ __forceinline__ void grad_bins(const float* __restrict__ row, float* __restrict__ drow,
                                          long sk, int k0, const int (&y)[L],
                                          const float (&hi)[L], const float (&lo)[L],
                                          const float (&w)[L]) {
    float v[C][L];
#pragma unroll
    for (int c = 0; c < C; ++c) load<L>(row + (k0 + c) * sk, v[c]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int l = 0; l < L; ++l) {
            const float p = expf((v[c][l] - hi[l]) - lo[l]);
            v[c][l] = (k0 + c == y[l] ? p - 1.0f : p) * w[l];
        }
        store<L>(drow + (k0 + c) * sk, v[c]);
    }
}

// One launch: the lse planes (hi at lse[i], lo at lse[n + i]) and, through
// per-block partials and the last block, [loss, count] in out.
template <int L, typename M>
__global__ void __launch_bounds__(kThreads) ce_forward_kernel(
        const float* __restrict__ logits, const int* __restrict__ labels,
        const M* __restrict__ mask, long n, Layout lay, float* __restrict__ lse,
        float* __restrict__ partials, unsigned* __restrict__ ticket, float* __restrict__ out) {
    float loss = 0.0f;
    float count = 0.0f;
    for (long i = (blockIdx.x * (long)kThreads + threadIdx.x) * L; i < n;
         i += (long)gridDim.x * kThreads * L) {
        int y[L];
        float w[L];
        load<L>(labels + i, y);
        load_mask<L>(mask + i, w);
        const Running<L> r = row_stats<L>(logits + lay.row(i), lay.sk, lay.K, y);
        float hi[L], lo[L];
#pragma unroll
        for (int l = 0; l < L; ++l) {
            const float ls = logf(r.s[l]);
            hi[l] = r.m[l] + ls;
            lo[l] = (r.m[l] - hi[l]) + ls;
            const float nll = (y[l] >= 0 && y[l] < lay.K) ? (r.m[l] - r.xy[l]) + ls : NAN;
            loss += nll * w[l];
            count += w[l];
        }
        store<L>(lse + i, hi);
        store<L>(lse + n + i, lo);
    }
    loss = block_sum(loss);
    count = block_sum(count);
    __shared__ bool last;
    if (threadIdx.x == 0) {
        partials[blockIdx.x] = loss;
        partials[gridDim.x + blockIdx.x] = count;
        __threadfence();  // the partials are seen before the ticket is
        last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    loss = count = 0.0f;
    for (int j = threadIdx.x; j < (int)gridDim.x; j += kThreads) {
        loss += __ldcg(partials + j);
        count += __ldcg(partials + gridDim.x + j);
    }
    loss = block_sum(loss);
    count = block_sum(count);
    if (threadIdx.x == 0) {
        out[0] = loss / fmaxf(count, 1.0f);
        out[1] = count;
        *ticket = 0u;
    }
}

template <int L, typename M>
__global__ void __launch_bounds__(kThreads) ce_backward_kernel(
        const float* __restrict__ logits, const int* __restrict__ labels,
        const M* __restrict__ mask, long n, Layout lay, const float* __restrict__ lse,
        const float* __restrict__ stats, const float* __restrict__ grad,
        float* __restrict__ dlogits) {
    const float scale = grad[0] / fmaxf(stats[1], 1.0f);
    const int K = lay.K;
    for (long i = (blockIdx.x * (long)kThreads + threadIdx.x) * L; i < n;
         i += (long)gridDim.x * kThreads * L) {
        int y[L];
        float w[L], hi[L], lo[L];
        load<L>(labels + i, y);
        load_mask<L>(mask + i, w);
        load<L>(lse + i, hi);
        load<L>(lse + n + i, lo);
#pragma unroll
        for (int l = 0; l < L; ++l) w[l] = (y[l] >= 0 && y[l] < K) ? w[l] * scale : NAN;
        const long off = lay.row(i);
        int k0 = 0;
#pragma unroll 1
        for (; k0 + kChunk <= K; k0 += kChunk) {
            grad_bins<L, kChunk>(logits + off, dlogits + off, lay.sk, k0, y, hi, lo, w);
        }
#pragma unroll 1
        for (; k0 < K; ++k0) grad_bins<L, 1>(logits + off, dlogits + off, lay.sk, k0, y, hi, lo, w);
    }
}

int grid_for(long n, int L, long cap) {
    const long per_block = (long)kThreads * L;
    const long blocks = (n + per_block - 1) / per_block;
    return static_cast<int>(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

template <int L, typename M>
void launch_forward(int blocks, cudaStream_t s, const float* logits, const int* labels,
                    const void* mask, long n, const Layout& lay, float* lse, float* partials,
                    unsigned* ticket, float* out) {
    ce_forward_kernel<L, M><<<blocks, kThreads, 0, s>>>(
        logits, labels, static_cast<const M*>(mask), n, lay, lse, partials, ticket, out);
}

template <int L, typename M>
void launch_backward(int blocks, cudaStream_t s, const float* logits, const int* labels,
                     const void* mask, long n, const Layout& lay, const float* lse,
                     const float* stats, const float* grad, float* dlogits) {
    ce_backward_kernel<L, M><<<blocks, kThreads, 0, s>>>(
        logits, labels, static_cast<const M*>(mask), n, lay, lse, stats, grad, dlogits);
}

}  // namespace

extern "C" {

// Forward, one launch. Logit (b, p, k) lies at b * sb + p * sp + k * sk;
// labels and mask are contiguous (B, P); `mask_is_float` selects a float32
// mask, else one byte per pixel (bool or uint8). `vec` takes 4 pixels a
// thread with 16-byte accesses: the caller has checked that P, sb and sk
// are multiples of 4, sp is 1 and every pointer allows it. `lse` receives
// 2 x B * P floats (hi, then lo), `out` [loss, count]; `partials` holds
// 2 x `capacity` floats, which caps the grid; `ticket` is 0 before the
// launch and after it. Returns cudaGetLastError() as an int.
int ce_forward(const float* logits, const int* labels, const void* mask, int mask_is_float,
               long B, long P, int K, long sb, long sp, long sk, int vec, float* lse,
               float* partials, int capacity, unsigned* ticket, float* out, int device,
               void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (capacity < 1 || K < 1 || B * P < 1) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Layout lay{P, K, sb, sp, sk};
    const long n = B * P;
    const int blocks = grid_for(n, vec ? 4 : 1, capacity);
    if (vec && mask_is_float) {
        launch_forward<4, float>(blocks, s, logits, labels, mask, n, lay, lse, partials, ticket, out);
    } else if (vec) {
        launch_forward<4, uint8_t>(blocks, s, logits, labels, mask, n, lay, lse, partials, ticket,
                                   out);
    } else if (mask_is_float) {
        launch_forward<1, float>(blocks, s, logits, labels, mask, n, lay, lse, partials, ticket, out);
    } else {
        launch_forward<1, uint8_t>(blocks, s, logits, labels, mask, n, lay, lse, partials, ticket,
                                   out);
    }
    return cudaGetLastError();
}

// Backward: dlogits, in the logits' layout, from the forward's lse and
// [loss, count] and the upstream gradient `grad` (one float on the device).
int ce_backward(const float* logits, const int* labels, const void* mask, int mask_is_float,
                long B, long P, int K, long sb, long sp, long sk, int vec, const float* lse,
                const float* stats, const float* grad, float* dlogits, int device,
                void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (K < 1 || B * P < 1) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Layout lay{P, K, sb, sp, sk};
    const long n = B * P;
    const int blocks = grid_for(n, vec ? 4 : 1, 1L << 20);
    if (vec && mask_is_float) {
        launch_backward<4, float>(blocks, s, logits, labels, mask, n, lay, lse, stats, grad,
                                  dlogits);
    } else if (vec) {
        launch_backward<4, uint8_t>(blocks, s, logits, labels, mask, n, lay, lse, stats, grad,
                                    dlogits);
    } else if (mask_is_float) {
        launch_backward<1, float>(blocks, s, logits, labels, mask, n, lay, lse, stats, grad,
                                  dlogits);
    } else {
        launch_backward<1, uint8_t>(blocks, s, logits, labels, mask, n, lay, lse, stats, grad,
                                    dlogits);
    }
    return cudaGetLastError();
}

const char* ce_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
