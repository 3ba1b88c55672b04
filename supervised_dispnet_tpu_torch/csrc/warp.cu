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
// blocks padded to that size. Hopper gathers directly: a thread reads an
// output pixel's four corners (C floats each, NHWC so a corner's channels
// are adjacent) through __ldg, and ragged edges are masked by index. The
// coordinate gradients need no atomics: each thread owns its dx, dy.
// Coordinates far out of view (cam2pixel keeps Z >= 1e-3, not x in range)
// are clamped to [-2, W+1] before the integer cast, where they stay out of
// bounds. Offsets are 64-bit.
//
// The forward and the coordinate-only backward serve the photometric loss,
// 4 scales x R refs a step, where the host's cost a call (checks, stream
// lookup, allocation, a ctypes call, the autograd node: tens of us around a
// kernel of a few us) and the coarse scales' launch latency (scale 3 at B=4
// is 3,328 pixels, 13 blocks) set the time. So both take a table of up to
// kMaxProblems problems (a WarpProblems struct, passed by value as a
// __grid_constant__ kernel parameter: no host-to-device copy, no
// allocation) and cover all of them with one launch of one thread an output
// pixel. Each block finds its problem with a short scan of block_start (the
// exclusive prefix of the problems' block counts) in the parameter bank;
// the host puts the largest problems first, so the grid's last blocks are
// the small ones. Blocks never straddle problems. For C <= kStageC the
// forward stages a block's 256 x C outputs in shared memory and stores them
// as float4 where the block's base is 16-byte aligned, as consecutive
// scalars otherwise. The backward reads g[i*C + c] directly: in a
// comparison on one card, staging g as well made the grouped backward
// slower. The batch index i / P is a 32-bit division where B * P fits. The
// single-problem entries are the same kernels with a one-entry table. With
// the coordinates of a random per-pixel depth, neighbouring threads read
// corners in different cache lines, one scalar load a channel. A lane a
// channel (C lanes a pixel, coalesced stores without shared memory) was
// slower still: three times the threads, each with the corner setup.
//
// The image+coordinate backward (inverse_warp with an image gradient; one
// problem a launch) is a scatter of g * w into dimg at each pixel's four
// corners. One thread a pixel with a global atomicAdd a corner and channel
// (the design this one replaced) made 12 L2 atomics a pixel, 2.56 M at
// (4, 128, 416, 3); on a per-pixel random depth's projection their
// addresses scatter and it took ~35 us against a 3.3 us bound. Here a block
// owns a 2-D tile of kTilePixels output pixels of one image (tile_w x
// kTilePixels / tile_w, tile_w from the host: ops/cuda/warp.py::tile_plan),
// a warp 32 neighbouring pixels of a row, and privatises the scatter where
// that pays:
//   1. x, y and g's first channels are loaded together;
//   2. 32 sample pixels of the tile, the same for every warp, decide with
//      no barrier whether the block takes the window path at all: if fewer
//      than kDenseSamples are window candidates (an in-bounds corner, not
//      piled on an edge by 'border' mode's clamp), as for random
//      coordinates mostly out of bounds, each pixel's gradients are formed
//      in one pass, each channel's atomics beside its coordinate terms,
//      and the block is done;
//   3. else each pixel's dx, dy as the coordinate-only kernel forms them; a
//      warp with at least kDenseLanes candidates whose corners spread over
//      more than kSpread image pixels a pixel (their box's area) is a
//      window warp; every other pixel adds its corners to dimg now;
//   4. the window: the window pixels' box of corners (block reductions,
//      one REDUX instruction a warp each) if it fits kWinFloats floats of
//      static shared memory (48 KB), else (a point thrown far) the box of
//      the corners in a region around their mean, at most win_w pixels
//      wide (from the host) and as tall as the budget allows, kept where at
//      least kMinHits corners a window pixel land in it;
//   5. each window pixel's corner in the window is added with a shared
//      atomicAdd (a compare-and-swap loop on sm_90, which has no native
//      shared float add); its other corners go to dimg;
//   6. after a barrier the window is flushed to dimg, zeroed on the stream
//      first (windows of neighbouring tiles overlap), one float4 atomicAdd
//      where the address is 16-byte aligned, scalars at a row's ragged
//      ends, skipping entries that are exactly zero. Each window row is
//      padded so that its floats have the alignment of their place in dimg.
// Straight to dimg, a pixel piled on an edge first sums the corners that
// the clamp made one (one atomic a channel where there were four). Any
// coordinates give the right sums: the window is only a fast path. The
// order of the sums at a pixel still changes from run to run. Each choice
// was timed against the others on one card (scripts/warp_bwd_variants.py,
// PERF.md): more pixels a thread, wider tiles, a smaller window, narrower
// flushes, other thresholds, a zeroing kernel in place of the memset.

// Bound: memory. At the main path's finest scale, img (4, 128, 416, 3) f32
// is 2.6 MB and fits the 50 MB L2, so the corner gathers hit L2 after the
// first touch; the forward must read img once plus x, y (1.7 MB) and write
// out (2.6 MB): ~6.9 MB, ~2 us at 3.35 TB/s; the image+coordinate backward
// reads img, x, y, g and writes dimg, dx, dy: ~11 MB, ~3.3 us. A group's
// bound is the sum over its problems of img + x + y read once and out
// written once (in the backward, g read and dx + dy written instead of
// out): for the self-supervised step's 8 problems (4 scales x 2 refs,
// 128x416, B=4) ~18 MB forward, ~5.4 us, and ~22.6 MB backward, ~6.8 us.

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
constexpr int kWarps = kThreads / 32;
constexpr int kStageC = 4;  // forward outputs of up to this many channels are staged
// The image+coordinate backward (ops/cuda/warp.py TILE_PIXELS, WIN_FLOATS)
constexpr int kTilePixelsPerThread = 1;
constexpr int kTilePixels = kThreads * kTilePixelsPerThread;  // output pixels a block
constexpr int kWinFloats = 12 * 1024 - 96;  // the window: 48 KB of static shared memory
                                            // less the reductions' 384 bytes
constexpr float kMinHits = 0.125f;  // a clipped window's corner hits a pixel, at least
constexpr int kFlushWidth = 4;     // floats an atomicAdd of the flush: 4, 2 or 1
constexpr int kKeepC = 4;          // g's first channels kept in registers between phases
constexpr int kDenseSamples = 24;  // window candidates of a window block's 32 samples, at least
constexpr int kDenseLanes = 16;    // window candidates a window warp has, at least
constexpr float kSpread = 2.0f;    // image pixels a window warp's corner box has a pixel, over

struct Corners {
    long o00, o01, o10, o11;  // element offsets of channel 0 of each corner
    float wx0, wx1, wy0, wy1;  // weights, zero for an out-of-bounds corner
    bool v00, v01, v10, v11;  // corner in bounds (always true for 'border')
    int x0, x1, y0, y1;       // columns and rows of the corners (clamped into the image)
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
    k.x0 = x0;
    k.x1 = x1;
    k.y0 = y0;
    k.y1 = y1;
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

// Floats of shared memory a window row of w pixels takes: w * C rounded up
// to a float4, and up to 3 floats in front that give its floats the
// alignment of their place in dimg.
__device__ __host__ __forceinline__ int window_stride(int w, int C) {
    return ((w * C + 3) & ~3) + 4;
}

// The min (max, sum) of v over the block: every warp's lane 0 writes its
// warp's value (one REDUX instruction, __reduce_*_sync) to part[warp], and
// after the caller's __syncthreads() every thread folds part[] in the same
// order (block_fold).
struct Min {
    __device__ int warp(int v) const { return __reduce_min_sync(0xffffffffu, v); }
    __device__ int operator()(int a, int b) const { return min(a, b); }
};
struct Max {
    __device__ int warp(int v) const { return __reduce_max_sync(0xffffffffu, v); }
    __device__ int operator()(int a, int b) const { return max(a, b); }
};
struct Add {  // unsigned: a sum that wraps is defined (it only places a window)
    __device__ unsigned warp(unsigned v) const { return __reduce_add_sync(0xffffffffu, v); }
    __device__ unsigned operator()(unsigned a, unsigned b) const { return a + b; }
};

template <typename T, typename Op>
__device__ __forceinline__ void warp_part(T v, Op op, T* part) {
    v = op.warp(v);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
}

template <typename T, typename Op>
__device__ __forceinline__ T block_fold(const T* part, Op op) {
    T v = part[0];
    for (int w = 1; w < kWarps; ++w) v = op(v, part[w]);
    return v;
}

// The block's shared window over dimg: columns [x0, x0 + w), rows
// [y0, y0 + h) of its image; row r starts at r * stride + pad(row).
struct Window {
    int x0, y0, w, h, stride;
};

// Where in the window channel 0 of corner (cx, cy) lies, or -1.
__device__ __forceinline__ int window_slot(const Window& win, int cx, int cy, int row0,
                                           int W, int C) {
    const int c = cx - win.x0;
    const int r = cy - win.y0;
    if (static_cast<unsigned>(c) >= static_cast<unsigned>(win.w)
        || static_cast<unsigned>(r) >= static_cast<unsigned>(win.h)) {
        return -1;
    }
    // dimg's float index of the row's first window float, mod 4 (unsigned
    // arithmetic wraps mod 2^32, which 4 divides)
    const unsigned pad = ((static_cast<unsigned>(row0 + cy) * W + win.x0) * C) & 3u;
    return r * win.stride + static_cast<int>(pad) + c * C;
}

// Channel c of a corner += v: in the shared window at `slot` (channel 0's
// place) where it lies there, else in dimg at `off` (channel 0's offset).
__device__ __forceinline__ void scatter(float* win_buf, int slot, float* dimg, long off,
                                        int c, float v) {
    if (slot >= 0) {
        atomicAdd(win_buf + slot + c, v);
    } else {
        atomicAdd(dimg + off + c, v);
    }
}

// Channel c of a window pixel's four corners: g * w into each in-bounds one,
// in the window at its slot where it has one (>= 0), else in dimg.
__device__ __forceinline__ void scatter_corners(float* win_buf, float* dimg, const Corners& q,
                                                const int s[4], int c, float gc) {
    if (q.v00) scatter(win_buf, s[0], dimg, q.o00, c, gc * q.wy0 * q.wx0);
    if (q.v01) scatter(win_buf, s[1], dimg, q.o01, c, gc * q.wy0 * q.wx1);
    if (q.v10) scatter(win_buf, s[2], dimg, q.o10, c, gc * q.wy1 * q.wx0);
    if (q.v11) scatter(win_buf, s[3], dimg, q.o11, c, gc * q.wy1 * q.wx1);
}

// Corner weights of a pixel that adds straight to dimg, and which corners it
// adds to.
struct DirectCorners {
    float w00, w01, w10, w11;
    bool k00, k01, k10, k11;
};

// In 'border' mode a corner clamped onto its neighbour (x0 == x1 or
// y0 == y1: a pixel piled on the image's edge) has its weight summed into
// the neighbour's first, so a pile takes one corner's atomics where it took
// four.
__device__ __forceinline__ DirectCorners direct_corners(const Corners& q, int border) {
    DirectCorners d{q.wy0 * q.wx0, q.wy0 * q.wx1, q.wy1 * q.wx0, q.wy1 * q.wx1,
                    q.v00, q.v01, q.v10, q.v11};
    if (border && q.x1 == q.x0) {  // the right corners are the left ones
        d.w00 += d.w01;
        d.w10 += d.w11;
        d.k01 = d.k11 = false;
    }
    if (border && q.y1 == q.y0) {  // the bottom corners are the top ones
        d.w00 += d.w10;
        d.w01 += d.w11;
        d.k10 = d.k11 = false;
    }
    return d;
}

// Channel c of such a pixel: g * w into dimg at each of its corners.
__device__ __forceinline__ void scatter_direct(float* dimg, const Corners& q,
                                               const DirectCorners& d, int c, float gc) {
    if (d.k00) atomicAdd(dimg + q.o00 + c, gc * d.w00);
    if (d.k01) atomicAdd(dimg + q.o01 + c, gc * d.w01);
    if (d.k10) atomicAdd(dimg + q.o10 + c, gc * d.w10);
    if (d.k11) atomicAdd(dimg + q.o11 + c, gc * d.w11);
}

// dst[j] += q[j] for the j in [lo, hi) of one float4 slot (dst 16-byte
// aligned when `vec`), skipping entries that are exactly zero.
__device__ __forceinline__ void flush_slot(float* dst, float4 q, int lo, int hi, bool vec) {
    const float v[4] = {q.x, q.y, q.z, q.w};
    if (kFlushWidth == 4 && vec && lo <= 0 && hi >= 4) {
        if (q.x != 0.0f || q.y != 0.0f || q.z != 0.0f || q.w != 0.0f) {
            atomicAdd(reinterpret_cast<float4*>(dst), q);
        }
        return;
    }
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
        if (kFlushWidth == 2 && vec && lo <= j && hi >= j + 2) {
            if (v[j] != 0.0f || v[j + 1] != 0.0f) {
                atomicAdd(reinterpret_cast<float2*>(dst + j), make_float2(v[j], v[j + 1]));
            }
            continue;
        }
#pragma unroll
        for (int e = j; e < j + 2; ++e) {
            if (e >= lo && e < hi && v[e] != 0.0f) atomicAdd(dst + e, v[e]);
        }
    }
}

// Whether pixel (x, y) may take the window: in 'zeros' mode an in-bounds
// corner (corner_setup's validity: x in [-1, W), y in [-1, H)); in 'border'
// mode x in [0, W-1], y in [0, H-1], where the clamp does not move it (its
// corners would pile on the image's edge).
__device__ __forceinline__ bool window_candidate(float x, float y, int H, int W, int border) {
    if (border) {
        return x >= 0.0f && x <= static_cast<float>(W - 1) && y >= 0.0f
               && y <= static_cast<float>(H - 1);
    }
    return x >= -1.0f && x < static_cast<float>(W) && y >= -1.0f && y < static_cast<float>(H);
}

// The image+coordinate backward: dimg (zeroed by the caller), dx, dy. Grid
// (tiles across, tiles down, B); tile_w a power of two in [32, kTilePixels].
__global__ void __launch_bounds__(kThreads) warp_backward_kernel(
        const float* __restrict__ img, const float* __restrict__ xs,
        const float* __restrict__ ys, const float* __restrict__ g,
        float* __restrict__ dimg, float* __restrict__ dx, float* __restrict__ dy,
        int H, int W, int C, int Ho, int Wo, int tile_w, int win_w, int border) {
    __shared__ __align__(16) float win_buf[kWinFloats];
    __shared__ int part_i[4][kWarps];        // the window pixels' box
    __shared__ unsigned part_u[3][kWarps];   // their count, the sums for their mean
    __shared__ int part_c[4][kWarps];        // a clipped window: its corners' box
    __shared__ unsigned part_h[kWarps];      // and their count

    const unsigned all = 0xffffffffu;
    const int tile_h = kTilePixels / tile_w;
    const int shift = __ffs(tile_w) - 1;
    const int b = blockIdx.z;
    const int ox0 = blockIdx.x * tile_w;
    const int oy0 = blockIdx.y * tile_h;
    const long P = static_cast<long>(Ho) * Wo;
    const long img_base = static_cast<long>(b) * H * W * C;
    const int row0 = b * H;  // the image's first row in dimg's (B * H) rows

    // 1. x, y and g's first channels of the thread's pixels, loaded
    //    together (g kept for the scatter)
    float px[kTilePixelsPerThread], py[kTilePixelsPerThread];
    float gk[kTilePixelsPerThread][kKeepC];
    long pi[kTilePixelsPerThread];  // the pixel's index in (B, P), or -1
    bool on[kTilePixelsPerThread];  // a window pixel
#pragma unroll
    for (int k = 0; k < kTilePixelsPerThread; ++k) {
        const int t = threadIdx.x + k * kThreads;
        const int oy = oy0 + (t >> shift);
        const int ox = ox0 + (t & (tile_w - 1));
        pi[k] = (oy < Ho && ox < Wo) ? b * P + static_cast<long>(oy) * Wo + ox : -1;
        px[k] = pi[k] >= 0 ? __ldg(xs + pi[k]) : 0.0f;
        py[k] = pi[k] >= 0 ? __ldg(ys + pi[k]) : 0.0f;
#pragma unroll
        for (int c = 0; c < kKeepC; ++c) {
            gk[k][c] = pi[k] >= 0 && c < C ? __ldg(g + pi[k] * C + c) : 0.0f;
        }
    }

    // 2. the window path, or not, for the whole block, from 32 of its pixels
    //    that every warp reads alike, so that every warp comes to the same
    //    answer with no barrier: at least kDenseSamples of them window
    //    candidates. Else (random coordinates, mostly out of bounds: few
    //    atomics) each pixel's gradients in one pass, each channel's atomics
    //    issued beside its coordinate terms, and the block is done.
    {
        const int lane = threadIdx.x & 31;
        const int t = lane * (kTilePixels / 32) + lane % (kTilePixels / 32);
        const int oy = oy0 + (t >> shift);
        const int ox = ox0 + (t & (tile_w - 1));
        bool cand = false;
        if (oy < Ho && ox < Wo) {
            const long j = b * P + static_cast<long>(oy) * Wo + ox;
            cand = window_candidate(__ldg(xs + j), __ldg(ys + j), H, W, border);
        }
        if (__popc(__ballot_sync(all, cand)) < kDenseSamples) {  // the same for the block
#pragma unroll
            for (int k = 0; k < kTilePixelsPerThread; ++k) {
                const long i = pi[k];
                if (i < 0) continue;
                const Corners q = corner_setup(px[k], py[k], H, W, border, img_base, C);
                const DirectCorners d = direct_corners(q, border);
                float gx = 0.0f;
                float gy = 0.0f;
#pragma unroll
                for (int c = 0; c < kKeepC; ++c) {
                    if (c < C) {
                        add_coord_grads(img, q, c, gk[k][c], gx, gy);
                        scatter_direct(dimg, q, d, c, gk[k][c]);
                    }
                }
                for (int c = kKeepC; c < C; ++c) {
                    const float gc = __ldg(g + i * C + c);
                    add_coord_grads(img, q, c, gc, gx, gy);
                    scatter_direct(dimg, q, d, c, gc);
                }
                border_mask(px[k], py[k], H, W, border, gx, gy);
                dx[i] = gx;
                dy[i] = gy;
            }
            return;
        }
    }

    // 3. each pixel's coordinate gradients, as the coordinate-only kernel
    //    forms them. A warp (a row of 32 output pixels) takes the window if
    //    at least kDenseLanes of its pixels are window candidates and their
    //    corners spread over more than kSpread pixels of the image each (a
    //    box of that area: scattered, as under a per-pixel random depth).
    //    Every other pixel adds its corners straight to dimg now: a smooth
    //    row's atomics are coalesced and few collide. The box and mean of
    //    the window pixels' corners.
    int xlo = INT_MAX, xhi = INT_MIN, ylo = INT_MAX, yhi = INT_MIN;  // warp-uniform
    unsigned n = 0, sx = 0, sy = 0;
#pragma unroll
    for (int k = 0; k < kTilePixelsPerThread; ++k) {
        const long i = pi[k];
        const Corners q = corner_setup(px[k], py[k], H, W, border, img_base, C);
        if (i >= 0) {
            float gx = 0.0f;
            float gy = 0.0f;
#pragma unroll
            for (int c = 0; c < kKeepC; ++c) {
                if (c < C) add_coord_grads(img, q, c, gk[k][c], gx, gy);
            }
            for (int c = kKeepC; c < C; ++c) {
                add_coord_grads(img, q, c, __ldg(g + i * C + c), gx, gy);
            }
            border_mask(px[k], py[k], H, W, border, gx, gy);
            dx[i] = gx;
            dy[i] = gy;
        }
        // every lane takes part: the ballots and reductions are warp-wide
        const bool cand = i >= 0 && window_candidate(px[k], py[k], H, W, border);
        const int ax = cand ? ((q.v00 || q.v10) ? q.x0 : q.x1) : INT_MAX;
        const int bx = cand ? ((q.v01 || q.v11) ? q.x1 : q.x0) : INT_MIN;
        const int ay = cand ? ((q.v00 || q.v01) ? q.y0 : q.y1) : INT_MAX;
        const int by = cand ? ((q.v10 || q.v11) ? q.y1 : q.y0) : INT_MIN;
        const int dense = __popc(__ballot_sync(all, cand));
        const int wxlo = __reduce_min_sync(all, ax);
        const int wxhi = __reduce_max_sync(all, bx);
        const int wylo = __reduce_min_sync(all, ay);
        const int wyhi = __reduce_max_sync(all, by);
        const bool window_warp = dense >= kDenseLanes
            && static_cast<float>(wxhi - wxlo + 1) * static_cast<float>(wyhi - wylo + 1)
               > kSpread * static_cast<float>(dense);
        on[k] = cand && window_warp;
        if (i >= 0 && !on[k]) {
            const DirectCorners d = direct_corners(q, border);
#pragma unroll
            for (int c = 0; c < kKeepC; ++c) {
                if (c < C) scatter_direct(dimg, q, d, c, gk[k][c]);
            }
            for (int c = kKeepC; c < C; ++c) scatter_direct(dimg, q, d, c, __ldg(g + i * C + c));
        }
        if (window_warp) {  // the same for the warp
            xlo = min(xlo, wxlo);
            xhi = max(xhi, wxhi);
            ylo = min(ylo, wylo);
            yhi = max(yhi, wyhi);
            n += dense;
            sx += __reduce_add_sync(all, cand ? static_cast<unsigned>(ax + bx) : 0u);
            sy += __reduce_add_sync(all, cand ? static_cast<unsigned>(ay + by) : 0u);
        }
    }
    if ((threadIdx.x & 31) == 0) {
        const int w = threadIdx.x >> 5;
        part_i[0][w] = xlo;
        part_i[1][w] = xhi;
        part_i[2][w] = ylo;
        part_i[3][w] = yhi;
        part_u[0][w] = n;
        part_u[1][w] = sx;
        part_u[2][w] = sy;
    }
    __syncthreads();
    n = block_fold(part_u[0], Add());

    // 4. the window: the box, or a part of it around the mean (block-uniform)
    Window win{0, 0, 0, 0, 0};
    if (n > 0) {
        xlo = block_fold(part_i[0], Min());
        xhi = block_fold(part_i[1], Max());
        ylo = block_fold(part_i[2], Min());
        yhi = block_fold(part_i[3], Max());
        const int bw = xhi - xlo + 1;
        const int bh = yhi - ylo + 1;
        if (static_cast<long>(bh) * window_stride(bw, C) <= kWinFloats) {
            win = Window{xlo, ylo, bw, bh, window_stride(bw, C)};
        } else {
            // the corners in a region of the budget's size around the mean, and
            // their own box: the window, if enough of them land there
            const int w = min(bw, win_w);
            const int stride = window_stride(w, C);
            const int h = w > 0 && stride <= kWinFloats ? min(bh, kWinFloats / stride) : 0;
            if (h > 0) {
                // the mean of the corners' box centres (sums of doubled centres)
                const float mx = 0.5f * static_cast<float>(block_fold(part_u[1], Add())) / n;
                const float my = 0.5f * static_cast<float>(block_fold(part_u[2], Add())) / n;
                const int rx = min(max(__float2int_rn(mx - 0.5f * (w - 1)), xlo), xhi - w + 1);
                const int ry = min(max(__float2int_rn(my - 0.5f * (h - 1)), ylo), yhi - h + 1);
                int cxlo = INT_MAX, cxhi = INT_MIN, cylo = INT_MAX, cyhi = INT_MIN;
                unsigned hits = 0;
#pragma unroll
                for (int k = 0; k < kTilePixelsPerThread; ++k) {
                    if (!on[k]) continue;
                    const Corners q = corner_setup(px[k], py[k], H, W, border, 0, C);
                    const bool v[4] = {q.v00, q.v01, q.v10, q.v11};
                    const int cx[4] = {q.x0, q.x1, q.x0, q.x1};
                    const int cy[4] = {q.y0, q.y0, q.y1, q.y1};
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        if (v[j] && static_cast<unsigned>(cx[j] - rx) < static_cast<unsigned>(w)
                            && static_cast<unsigned>(cy[j] - ry) < static_cast<unsigned>(h)) {
                            cxlo = min(cxlo, cx[j]);
                            cxhi = max(cxhi, cx[j]);
                            cylo = min(cylo, cy[j]);
                            cyhi = max(cyhi, cy[j]);
                            ++hits;
                        }
                    }
                }
                warp_part(cxlo, Min(), part_c[0]);
                warp_part(cxhi, Max(), part_c[1]);
                warp_part(cylo, Min(), part_c[2]);
                warp_part(cyhi, Max(), part_c[3]);
                warp_part(hits, Add(), part_h);
                __syncthreads();
                hits = block_fold(part_h, Add());
                if (hits > 0) {
                    cxlo = block_fold(part_c[0], Min());
                    cylo = block_fold(part_c[2], Min());
                    const int cw = block_fold(part_c[1], Max()) - cxlo + 1;
                    const int ch = block_fold(part_c[3], Max()) - cylo + 1;
                    if (hits >= kMinHits * cw * ch) {
                        win = Window{cxlo, cylo, cw, ch, window_stride(cw, C)};
                    }
                }
            }
        }
    }
    const bool shared_path = win.w > 0;
    if (shared_path) {
        for (int v = threadIdx.x; v < (win.h * win.stride) >> 2; v += kThreads) {
            reinterpret_cast<float4*>(win_buf)[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        __syncthreads();
    }

    // 5. each window pixel's corners into the window where they lie there,
    //    else into dimg
#pragma unroll
    for (int k = 0; k < kTilePixelsPerThread; ++k) {
        if (!on[k]) continue;
        const long i = pi[k];
        const Corners q = corner_setup(px[k], py[k], H, W, border, img_base, C);
        int s[4] = {-1, -1, -1, -1};
        if (shared_path) {
            s[0] = window_slot(win, q.x0, q.y0, row0, W, C);
            s[1] = window_slot(win, q.x1, q.y0, row0, W, C);
            s[2] = window_slot(win, q.x0, q.y1, row0, W, C);
            s[3] = window_slot(win, q.x1, q.y1, row0, W, C);
        }
#pragma unroll
        for (int c = 0; c < kKeepC; ++c) {
            if (c < C) scatter_corners(win_buf, dimg, q, s, c, gk[k][c]);
        }
        for (int c = kKeepC; c < C; ++c) {
            scatter_corners(win_buf, dimg, q, s, c, __ldg(g + i * C + c));
        }
    }

    // 6. the window into dimg, a float4 slot at a time
    if (!shared_path) return;
    __syncthreads();
    const int slots = win.stride >> 2;  // a row's float4 slots
    const bool vec = (reinterpret_cast<uintptr_t>(dimg) & 15) == 0;
    for (int v = threadIdx.x; v < win.h * slots; v += kThreads) {
        const int r = v / slots;
        const int s = v - r * slots;
        const long start = (static_cast<long>(row0 + win.y0 + r) * W + win.x0) * C;
        const int pad = static_cast<int>(start & 3);
        const float4 q = reinterpret_cast<const float4*>(win_buf + r * win.stride)[s];
        // the slot's floats of this row: [pad, pad + w * C) of the row's slots
        flush_slot(dimg + (start - pad) + 4 * s, q, pad - 4 * s, pad + win.w * C - 4 * s, vec);
    }
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

// dimg (B, H, W, C), dx, dy (B, Ho, Wo) from the upstream gradient
// g (B, Ho, Wo, C): one block a tile of tile_w x kTilePixels / tile_w output
// pixels (tile_w a power of two in [32, kTilePixels]); a window at most
// win_w pixels wide where a tile's corners do not fit kWinFloats (0: only
// where they fit). dimg is zeroed here, on the stream, before the scatter.
int warp_backward(const float* img, const float* x, const float* y, const float* g,
                  float* dimg, float* dx, float* dy, int B, int H, int W, int C, int Ho,
                  int Wo, int tile_w, int win_w, int border, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (bad_shape(B, H, W, C, static_cast<long>(Ho) * Wo) || Ho < 1 || Wo < 1 || B > 65535
        || tile_w < 32 || tile_w > kTilePixels || (tile_w & (tile_w - 1)) != 0 || win_w < 0) {
        return cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = cudaMemsetAsync(dimg, 0, sizeof(float) * B * static_cast<size_t>(H) * W * C, s);
    if (err != cudaSuccess) return err;
    const int tile_h = kTilePixels / tile_w;
    const dim3 grid((Wo + tile_w - 1) / tile_w, (Ho + tile_h - 1) / tile_h, B);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    warp_backward_kernel<<<grid, kThreads, 0, s>>>(img, x, y, g, dimg, dx, dy, H, W, C, Ho,
                                                   Wo, tile_w, win_w, border);
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
