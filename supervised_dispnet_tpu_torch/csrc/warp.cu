// Bilinear image sampling at float pixel coordinates, forward and the two
// backwards, for Hopper (sm_90a). Bound to Python with ctypes by
// ops/cuda/warp.py; built by ops/cuda/_build.py.
//
// Replaces supervised_dispnet_tpu/ops/pallas/warp.py:
//   _fwd_kernel         -> warp_forward_kernel          (the sample)
//   _bwd_kernel         -> warp_backward_kernel         (dimg, dx, dy)
//   _bwd_coords_kernel  -> warp_backward_kernel<false>  (dx, dy only)
// It computes, for img (B, H, W, C) NHWC and coordinates x, y (B, P):
//   out[b, p, c] = (c00 wx0 + c01 wx1) wy0 + (c10 wx0 + c11 wx1) wy1
// with the corners and weights of _corner_setup: 'border' clamps x to
// [0, W-1] and y to [0, H-1] first; 'zeros' zeroes the weight (and the
// value) of each out-of-bounds corner. The backward gives
//   dx = sum_c g (wy0 (c01 - c00) + wy1 (c11 - c10)),
//   dy = sum_c g (wx0 (c10 - c00) + wx1 (c11 - c01)),
// zeroed in 'border' mode where x is outside [0, W-1] (y outside [0, H-1]),
// the inclusive boundary of the clamp's derivative; and dimg, the scatter of
// g * w to each in-bounds corner.
//
// Design. The Pallas kernel gathers rows with one-hot matrix products on the
// TPU's matrix unit and scatters dimg with their transposes, in 1024-pixel
// blocks padded to that size. Hopper gathers directly: one thread per output
// pixel reads its four corners (C floats each, NHWC so a corner's channels
// are adjacent), and the ragged tail is masked by index. The image
// gradient is a scatter: dimg is zeroed on the stream, then each thread adds
// g * w into its in-bounds corners with atomicAdd, so the order of the sum
// at a pixel changes from run to run (float sums differ in the last bits).
// The coordinate gradients need no atomics: each thread owns its dx, dy.
// Coordinates far out of view (cam2pixel keeps Z >= 1e-3, not x in range)
// are clamped to [-2, W+1] before the integer cast, where they stay out of
// bounds. Offsets are 64-bit.
//
// Bound: memory. At the main path's finest scale, img (4, 128, 416, 3) f32
// is 2.6 MB and fits the 50 MB L2, so the corner gathers hit L2 after the
// first touch; the forward must read img once plus x, y (1.7 MB) and write
// out (2.6 MB): ~6.9 MB, ~2 us at 3.35 TB/s. Launch latency dominates at the
// coarser scales.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Corners {
    long o00, o01, o10, o11;  // element offsets of channel 0 of each corner
    float wx0, wx1, wy0, wy1;  // weights, zero for an out-of-bounds corner
    bool v00, v01, v10, v11;  // corner in bounds (always true for 'border')
};

__device__ __forceinline__ Corners corner_setup(float x, float y, int H, int W,
                                                int border, long img_base, int C) {
    Corners k;
    if (border) {
        x = fminf(fmaxf(x, 0.0f), static_cast<float>(W - 1));
        y = fminf(fmaxf(y, 0.0f), static_cast<float>(H - 1));
    }
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    k.wx1 = x - x0f;
    k.wy1 = y - y0f;
    k.wx0 = 1.0f - k.wx1;
    k.wy0 = 1.0f - k.wy1;
    int x0 = static_cast<int>(fminf(fmaxf(x0f, -2.0f), static_cast<float>(W) + 1.0f));
    int y0 = static_cast<int>(fminf(fmaxf(y0f, -2.0f), static_cast<float>(H) + 1.0f));
    int x1 = x0 + 1;
    int y1 = y0 + 1;
    if (border) {
        x0 = min(max(x0, 0), W - 1);
        x1 = min(max(x1, 0), W - 1);
        y0 = min(max(y0, 0), H - 1);
        y1 = min(max(y1, 0), H - 1);
        k.v00 = k.v01 = k.v10 = k.v11 = true;
    } else {
        const bool vx0 = x0 >= 0 && x0 <= W - 1;
        const bool vx1 = x1 >= 0 && x1 <= W - 1;
        const bool vy0 = y0 >= 0 && y0 <= H - 1;
        const bool vy1 = y1 >= 0 && y1 <= H - 1;
        k.wx0 = vx0 ? k.wx0 : 0.0f;
        k.wx1 = vx1 ? k.wx1 : 0.0f;
        k.wy0 = vy0 ? k.wy0 : 0.0f;
        k.wy1 = vy1 ? k.wy1 : 0.0f;
        k.v00 = vx0 && vy0;
        k.v01 = vx1 && vy0;
        k.v10 = vx0 && vy1;
        k.v11 = vx1 && vy1;
        // any in-range offset for a corner that is never read
        x0 = min(max(x0, 0), W - 1);
        x1 = min(max(x1, 0), W - 1);
        y0 = min(max(y0, 0), H - 1);
        y1 = min(max(y1, 0), H - 1);
    }
    k.o00 = img_base + (static_cast<long>(y0) * W + x0) * C;
    k.o01 = img_base + (static_cast<long>(y0) * W + x1) * C;
    k.o10 = img_base + (static_cast<long>(y1) * W + x0) * C;
    k.o11 = img_base + (static_cast<long>(y1) * W + x1) * C;
    return k;
}

__device__ __forceinline__ float tap(const float* __restrict__ img, long off, bool valid) {
    return valid ? __ldg(img + off) : 0.0f;
}

__global__ void __launch_bounds__(kThreads) warp_forward_kernel(
        const float* __restrict__ img, const float* __restrict__ xs,
        const float* __restrict__ ys, float* __restrict__ out, int B, int H, int W,
        int C, long P, int border) {
    const long n = static_cast<long>(B) * P;
    for (long i = blockIdx.x * static_cast<long>(kThreads) + threadIdx.x; i < n;
         i += static_cast<long>(gridDim.x) * kThreads) {
        const long b = i / P;
        const Corners k = corner_setup(xs[i], ys[i], H, W, border,
                                       b * H * static_cast<long>(W) * C, C);
        for (int c = 0; c < C; ++c) {
            const float c00 = tap(img, k.o00 + c, k.v00);
            const float c01 = tap(img, k.o01 + c, k.v01);
            const float c10 = tap(img, k.o10 + c, k.v10);
            const float c11 = tap(img, k.o11 + c, k.v11);
            out[i * C + c] = (c00 * k.wx0 + c01 * k.wx1) * k.wy0
                             + (c10 * k.wx0 + c11 * k.wx1) * k.wy1;
        }
    }
}

// WITH_IMG: also scatter dimg (row 6); otherwise coordinates only (row 7).
template <bool WITH_IMG>
__global__ void __launch_bounds__(kThreads) warp_backward_kernel(
        const float* __restrict__ img, const float* __restrict__ xs,
        const float* __restrict__ ys, const float* __restrict__ g,
        float* __restrict__ dimg, float* __restrict__ dx, float* __restrict__ dy,
        int B, int H, int W, int C, long P, int border) {
    const long n = static_cast<long>(B) * P;
    for (long i = blockIdx.x * static_cast<long>(kThreads) + threadIdx.x; i < n;
         i += static_cast<long>(gridDim.x) * kThreads) {
        const long b = i / P;
        const float x = xs[i];
        const float y = ys[i];
        const Corners k = corner_setup(x, y, H, W, border,
                                       b * H * static_cast<long>(W) * C, C);
        float gx = 0.0f;
        float gy = 0.0f;
        for (int c = 0; c < C; ++c) {
            const float gc = g[i * C + c];
            const float c00 = tap(img, k.o00 + c, k.v00);
            const float c01 = tap(img, k.o01 + c, k.v01);
            const float c10 = tap(img, k.o10 + c, k.v10);
            const float c11 = tap(img, k.o11 + c, k.v11);
            gx += gc * (k.wy0 * (c01 - c00) + k.wy1 * (c11 - c10));
            gy += gc * (k.wx0 * (c10 - c00) + k.wx1 * (c11 - c01));
            if (WITH_IMG) {
                if (k.v00) atomicAdd(dimg + k.o00 + c, gc * k.wy0 * k.wx0);
                if (k.v01) atomicAdd(dimg + k.o01 + c, gc * k.wy0 * k.wx1);
                if (k.v10) atomicAdd(dimg + k.o10 + c, gc * k.wy1 * k.wx0);
                if (k.v11) atomicAdd(dimg + k.o11 + c, gc * k.wy1 * k.wx1);
            }
        }
        if (border) {
            gx = (x >= 0.0f && x <= static_cast<float>(W - 1)) ? gx : 0.0f;
            gy = (y >= 0.0f && y <= static_cast<float>(H - 1)) ? gy : 0.0f;
        }
        dx[i] = gx;
        dy[i] = gy;
    }
}

int grid_blocks(long n) {
    const long blocks = (n + kThreads - 1) / kThreads;
    return static_cast<int>(blocks < 1 ? 1 : (blocks > 65535 ? 65535 : blocks));
}

bool bad_shape(int B, int H, int W, int C, long P) {
    return B < 1 || H < 1 || W < 1 || C < 1 || P < 1;
}

}  // namespace

extern "C" {

// out (B, P, C) = the sample of img (B, H, W, C) at x, y (B, P). `border`
// selects 'border' padding, else 'zeros'. Returns cudaGetLastError() as an int.
int warp_forward(const float* img, const float* x, const float* y, float* out,
                 int B, int H, int W, int C, long P, int border, int device,
                 void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (bad_shape(B, H, W, C, P)) return cudaErrorInvalidValue;
    const long n = static_cast<long>(B) * P;
    warp_forward_kernel<<<grid_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        img, x, y, out, B, H, W, C, P, border);
    return cudaGetLastError();
}

// dimg (B, H, W, C), dx, dy (B, P) from the upstream gradient g (B, P, C).
// dimg is zeroed here, on the stream, before the scatter.
int warp_backward(const float* img, const float* x, const float* y, const float* g,
                  float* dimg, float* dx, float* dy, int B, int H, int W, int C,
                  long P, int border, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (bad_shape(B, H, W, C, P)) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = cudaMemsetAsync(dimg, 0, sizeof(float) * B * static_cast<size_t>(H) * W * C, s);
    if (err != cudaSuccess) return err;
    const long n = static_cast<long>(B) * P;
    warp_backward_kernel<true><<<grid_blocks(n), kThreads, 0, s>>>(
        img, x, y, g, dimg, dx, dy, B, H, W, C, P, border);
    return cudaGetLastError();
}

// dx, dy (B, P) only: img is data, its gradient is not formed.
int warp_backward_coords(const float* img, const float* x, const float* y,
                         const float* g, float* dx, float* dy, int B, int H, int W,
                         int C, long P, int border, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (bad_shape(B, H, W, C, P)) return cudaErrorInvalidValue;
    const long n = static_cast<long>(B) * P;
    warp_backward_kernel<false><<<grid_blocks(n), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        img, x, y, g, nullptr, dx, dy, B, H, W, C, P, border);
    return cudaGetLastError();
}

const char* warp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
