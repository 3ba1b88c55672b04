// Bilinear image sampling at float pixel coordinates, forward and the two
// backwards, for Hopper (sm_90a). Bound to Python with ctypes by
// ops/cuda/warp.py; built by ops/cuda/_build.py.
//
// Replaces supervised_dispnet_tpu/ops/pallas/warp.py:
//   _fwd_kernel         -> warp_forward_group_kernel          (the sample)
//   _bwd_kernel         -> warp_backward_kernel               (dimg, dx, dy)
//   _bwd_coords_kernel  -> warp_backward_coords_group_kernel  (dx, dy only)
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
// are adjacent) through __ldg, and the ragged tail is masked by index. The
// image gradient is a scatter: dimg is zeroed on the stream, then each
// thread adds g * w into its in-bounds corners with atomicAdd, so the order
// of the sum at a pixel changes from run to run (float sums differ in the
// last bits). The coordinate gradients need no atomics: each thread owns its
// dx, dy. Coordinates far out of view (cam2pixel keeps Z >= 1e-3, not x in
// range) are clamped to [-2, W+1] before the integer cast, where they stay
// out of bounds. Offsets are 64-bit.
//
// What holds the sampler back on this card is less the device's work than
// the calls around it. The photometric loss samples 4 scales x R refs:
//   - each call costs the host tens of us (checks, stream lookup,
//     allocation, a ctypes call, the autograd node) around a kernel of a
//     few us;
//   - the coarse scales cannot fill 132 SMs: scale 3 at B=4 is 4 x 16 x 52
//     = 3,328 pixels, 13 blocks, so its launch is all launch latency;
//   - one thread a pixel writes out[i*C + c] as C scalar stores at a
//     12-byte stride for C = 3.
// The grouped design answers each. The forward and the coordinate-only
// backward take a table of up to kMaxProblems problems (a WarpProblems
// struct, passed by value as a __grid_constant__ kernel parameter: no
// host-to-device copy, no allocation) and cover all of them with one launch,
// so a loss pays the host's per-call cost once a step and the small
// problems ride in the tail of the large ones' grid. Each block finds its
// problem with a short scan of block_start (the exclusive prefix of the
// problems' block counts) in the parameter bank; the host puts the largest
// problems first, so the grid's last blocks are the small ones. Blocks never
// straddle problems. For C <= kStageC the forward stages a block's 256 x C
// outputs in shared memory and stores them as float4 where the block's base
// is 16-byte aligned, as consecutive scalars otherwise. The backward reads
// g[i*C + c] directly: in a comparison on one card, staging g as well made
// the grouped backward slower, where staging the forward's outputs made
// the grouped forward a little faster (and took registers off it). The
// batch index i / P is a 32-bit division where B * P fits. The
// single-problem entries are the same kernels with a one-entry table.
//
// What limits a launch at the finest scale is its gathers: with the
// coordinates of a random per-pixel depth, neighbouring threads read
// corners in different cache lines, one scalar load a channel, and the
// 832 blocks of a (4, 128, 416) problem take two rounds of the SMs at 60
// registers a thread (4 blocks an SM). A lane a channel (C lanes a pixel,
// coalesced stores without shared memory) was slower still: three times
// the threads, each with the corner setup.
//
// Bound: memory. At the main path's finest scale, img (4, 128, 416, 3) f32
// is 2.6 MB and fits the 50 MB L2, so the corner gathers hit L2 after the
// first touch; the forward must read img once plus x, y (1.7 MB) and write
// out (2.6 MB): ~6.9 MB, ~2 us at 3.35 TB/s. A group's bound is the sum over
// its problems of img + x + y read once and out written once (in the
// backward, g read and dx + dy written instead of out): for the
// self-supervised step's 8 problems (4 scales x 2 refs, 128x416, B=4)
// ~18 MB forward, ~5.4 us, and ~22.6 MB backward, ~6.8 us.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxProblems = 16;  // ops/cuda/warp.py MAX_PROBLEMS

// One sampling problem; ops/cuda/warp.py::PROBLEM_ROW packs it. At file
// scope, not in the unnamed namespace: the C entries take it, and a type of
// internal linkage in their signature would give them internal linkage too.
struct WarpProblem {
    const float* img;  // (B, H, W, C)
    const float* x;    // (B, P)
    const float* y;    // (B, P)
    const float* g;    // backward: upstream gradient (B, P, C)
    float* out;        // forward: the sample (B, P, C)
    float* dx;         // backward: (B, P)
    float* dy;         // backward: (B, P)
    long P;
    int B, H, W, C;
    int block_start;   // the blocks of the problems before it in the table
};

struct WarpProblems {
    WarpProblem p[kMaxProblems];
    int n;
};

namespace {

constexpr int kThreads = 256;
constexpr int kStageC = 4;  // forward outputs of up to this many channels are staged

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

// The coordinate gradients' terms of one channel; shared by the
// image+coordinate and the coordinate-only backward, so both give the same
// bits.
__device__ __forceinline__ void add_coord_grads(const float* __restrict__ img,
                                                const Corners& k, int c, float gc,
                                                float& gx, float& gy) {
    const float c00 = tap(img, k.o00 + c, k.v00);
    const float c01 = tap(img, k.o01 + c, k.v01);
    const float c10 = tap(img, k.o10 + c, k.v10);
    const float c11 = tap(img, k.o11 + c, k.v11);
    gx += gc * (k.wy0 * (c01 - c00) + k.wy1 * (c11 - c10));
    gy += gc * (k.wx0 * (c10 - c00) + k.wx1 * (c11 - c01));
}

__device__ __forceinline__ void border_mask(float x, float y, int H, int W, int border,
                                            float& gx, float& gy) {
    if (border) {
        gx = (x >= 0.0f && x <= static_cast<float>(W - 1)) ? gx : 0.0f;
        gy = (y >= 0.0f && y <= static_cast<float>(H - 1)) ? gy : 0.0f;
    }
}

// The block's problem: the last one whose block_start <= blockIdx.x.
__device__ __forceinline__ const WarpProblem& block_problem(const WarpProblems& t) {
    int j = 0;
    for (int i = 1; i < t.n; ++i) {
        j = static_cast<int>(blockIdx.x) >= t.p[i].block_start ? i : j;
    }
    return t.p[j];
}

// dst[0, count) = src[0, count) by the whole block, as float4 where dst is
// 16-byte aligned (shared memory src is), else as consecutive scalars.
__device__ __forceinline__ void block_store(float* __restrict__ dst,
                                            const float* __restrict__ src, int count) {
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        const int n4 = count >> 2;
        for (int v = threadIdx.x; v < n4; v += kThreads) {
            reinterpret_cast<float4*>(dst)[v] = reinterpret_cast<const float4*>(src)[v];
        }
        done = n4 << 2;
    }
    for (int e = done + threadIdx.x; e < count; e += kThreads) {
        dst[e] = src[e];
    }
}

// b * H * W * C, the offset of pixel i's image; i / P in 32 bits where it
// fits (the same quotient, far fewer instructions than a 64-bit division).
__device__ __forceinline__ long image_base(const WarpProblem& q, long i, long n) {
    const long b = n <= UINT_MAX ? static_cast<long>(static_cast<unsigned>(i)
                                                     / static_cast<unsigned>(q.P))
                                 : i / q.P;
    return b * q.H * static_cast<long>(q.W) * q.C;
}

// The block's output pixels: all kThreads but in a problem's last block.
__device__ __forceinline__ int block_rows(long left) {
    return left < kThreads ? static_cast<int>(left) : kThreads;
}

__global__ void __launch_bounds__(kThreads) warp_forward_group_kernel(
        const __grid_constant__ WarpProblems t, int border) {
    __shared__ __align__(16) float stage[kThreads * kStageC];
    const WarpProblem& q = block_problem(t);
    const int C = q.C;
    const long n = static_cast<long>(q.B) * q.P;
    const long first = static_cast<long>(blockIdx.x - q.block_start) * kThreads;
    const long i = first + threadIdx.x;
    const bool staged = C <= kStageC;
    if (i < n) {
        const Corners k = corner_setup(__ldg(q.x + i), __ldg(q.y + i), q.H, q.W, border,
                                       image_base(q, i, n), C);
        for (int c = 0; c < C; ++c) {
            const float c00 = tap(q.img, k.o00 + c, k.v00);
            const float c01 = tap(q.img, k.o01 + c, k.v01);
            const float c10 = tap(q.img, k.o10 + c, k.v10);
            const float c11 = tap(q.img, k.o11 + c, k.v11);
            const float v = (c00 * k.wx0 + c01 * k.wx1) * k.wy0
                            + (c10 * k.wx0 + c11 * k.wx1) * k.wy1;
            if (staged) {
                stage[threadIdx.x * C + c] = v;
            } else {
                q.out[i * C + c] = v;
            }
        }
    }
    if (staged) {  // the same for the whole block: one problem a block
        __syncthreads();
        block_store(q.out + first * C, stage, block_rows(n - first) * C);
    }
}

__global__ void __launch_bounds__(kThreads) warp_backward_coords_group_kernel(
        const __grid_constant__ WarpProblems t, int border) {
    const WarpProblem& q = block_problem(t);
    const int C = q.C;
    const long n = static_cast<long>(q.B) * q.P;
    const long first = static_cast<long>(blockIdx.x - q.block_start) * kThreads;
    const long i = first + threadIdx.x;
    if (i >= n) return;
    const float x = __ldg(q.x + i);
    const float y = __ldg(q.y + i);
    const Corners k = corner_setup(x, y, q.H, q.W, border, image_base(q, i, n), C);
    float gx = 0.0f;
    float gy = 0.0f;
    for (int c = 0; c < C; ++c) {
        const float gc = __ldg(q.g + i * C + c);
        add_coord_grads(q.img, k, c, gc, gx, gy);
    }
    border_mask(x, y, q.H, q.W, border, gx, gy);
    q.dx[i] = gx;
    q.dy[i] = gy;
}

// The image+coordinate backward (one problem a launch; not on a training
// path: inverse_warp with an image gradient).
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
            add_coord_grads(img, k, c, gc, gx, gy);
            if (k.v00) atomicAdd(dimg + k.o00 + c, gc * k.wy0 * k.wx0);
            if (k.v01) atomicAdd(dimg + k.o01 + c, gc * k.wy0 * k.wx1);
            if (k.v10) atomicAdd(dimg + k.o10 + c, gc * k.wy1 * k.wx0);
            if (k.v11) atomicAdd(dimg + k.o11 + c, gc * k.wy1 * k.wx1);
        }
        border_mask(x, y, H, W, border, gx, gy);
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

// Copy the host's table into t, the kernel's parameter, and count the
// grid's blocks (one per 256 output pixels of every problem). The table must
// be laid out as the host planned it: block_start the exclusive prefix of
// the problems' blocks.
cudaError_t copy_table(const WarpProblem* problems, int n, int device, WarpProblems& t,
                       unsigned& blocks) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (problems == nullptr || n < 1 || n > kMaxProblems) return cudaErrorInvalidValue;
    long total = 0;
    for (int i = 0; i < n; ++i) {
        const WarpProblem& q = problems[i];
        if (bad_shape(q.B, q.H, q.W, q.C, q.P) || q.block_start != total) {
            return cudaErrorInvalidValue;
        }
        t.p[i] = q;
        total += (static_cast<long>(q.B) * q.P + kThreads - 1) / kThreads;
        if (total > INT_MAX) return cudaErrorInvalidValue;
    }
    t.n = n;
    blocks = static_cast<unsigned>(total);
    return cudaSuccess;
}

}  // namespace

extern "C" {

// Every problem of the table: out (B, P, C) = the sample of img (B, H, W, C)
// at x, y (B, P), in one launch. n <= kMaxProblems. `border` selects
// 'border' padding, else 'zeros', for the whole group. Returns
// cudaGetLastError() as an int.
int warp_forward_many(const WarpProblem* problems, int n, int border, int device,
                      void* stream) {
    WarpProblems t{};
    unsigned blocks = 0;
    const cudaError_t err = copy_table(problems, n, device, t, blocks);
    if (err != cudaSuccess) return err;
    warp_forward_group_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        t, border);
    return cudaGetLastError();
}

// Every problem of the table: dx, dy (B, P) from the upstream gradient
// g (B, P, C), in one launch; the images are data.
int warp_backward_coords_many(const WarpProblem* problems, int n, int border, int device,
                              void* stream) {
    WarpProblems t{};
    unsigned blocks = 0;
    const cudaError_t err = copy_table(problems, n, device, t, blocks);
    if (err != cudaSuccess) return err;
    warp_backward_coords_group_kernel<<<blocks, kThreads, 0,
                                        static_cast<cudaStream_t>(stream)>>>(t, border);
    return cudaGetLastError();
}

// One problem: out (B, P, C) = the sample of img (B, H, W, C) at x, y (B, P).
int warp_forward(const float* img, const float* x, const float* y, float* out,
                 int B, int H, int W, int C, long P, int border, int device,
                 void* stream) {
    const WarpProblem q{img, x, y, nullptr, out, nullptr, nullptr, P, B, H, W, C, 0};
    return warp_forward_many(&q, 1, border, device, stream);
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
    warp_backward_kernel<<<grid_blocks(n), kThreads, 0, s>>>(
        img, x, y, g, dimg, dx, dy, B, H, W, C, P, border);
    return cudaGetLastError();
}

// One problem: dx, dy (B, P) only; img is data, its gradient is not formed.
int warp_backward_coords(const float* img, const float* x, const float* y,
                         const float* g, float* dx, float* dy, int B, int H, int W,
                         int C, long P, int border, int device, void* stream) {
    const WarpProblem q{img, x, y, g, nullptr, dx, dy, P, B, H, W, C, 0};
    return warp_backward_coords_many(&q, 1, border, device, stream);
}

const char* warp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
