// int8 convolution on the s8 tensor cores with a fused epilogue, for Hopper
// (sm_90a). Bound to Python with ctypes by ops/cuda/int8_conv.py; built by
// ops/cuda/_build.py.
//
// Replaces no pallas_call. The JAX package runs its int8 convolutions in
// XLA: supervised_dispnet_tpu/ops/quant.py::_conv_q and ::_int8_conv
// (lax.conv_general_dilated on int8 with preferred_element_type=int32),
// with the dequantise / BN / bias / residual / activation / requantise of
// ::_requant and the chains fused into the conv's epilogue. PyTorch has no
// CUDA int8 convolution, so the port's int8 serving path needs this kernel
// to keep activations in device memory as int8 between convs.
//
// The function. x is NHWC int8 (B, H, W, C); w is (Cout, Kp) int8, each row
// the (ky, kx, ci) taps of one output channel, K = kh * kw * C of them,
// zero-padded to Kp, a multiple of 32. The input is read through a
// predicate: its coordinate in the lhs-dilated (dilation dh, dw), padded
// (pt, pl low; the high padding is implied by Ho, Wo) input is
//   vy = oy * sh - pt + ky * rh   (rh: kernel, i.e. rhs, dilation),
// and it reads x[vy / dh] where vy >= 0, vy % dh == 0 and vy / dh < H, else
// 0; the same for columns. The sum over K is int32 and exact (|sum| <=
// 127 * 127 * K, K <= 6 * 6 * 512 on the model's convs). Then per output
// channel c, with float32 operations rounded one at a time (__fmul_rn,
// __fadd_rn, __fdiv_rn: nvcc contracts none of them into an FMA, so the
// card rounds where the CPU's plain version does):
//   y = float(acc) * mult[c]
//   res_mode 3:  y = y + r                  (float32 r, added before bias)
//   y = y + bias[c]
//   res_mode 1:  y = y + float(r) * res_scale  (int8 r, the identity of a block)
//   res_mode 2:  y = float(bf16(bf16(y) + r))  (bf16 r: both sides rounded to
//                bf16 before the add, as the JAX chain does at a block with
//                a downsample conv)
//   act 1: max(y, 0); act 2: y > 0 ? y : expm1(y)
//   out 0: float32 y; 1: bf16 y; 2: int8 clip(rint(y / out_scale), -127, 127)
//   (round half to even, a true division); 3: the raw int32 accumulator.
//
// What bounds it: operations at the main path's shapes, in principle.
// DispResNet-50's 3x3 convs at (8, 3, 128, 416) do 2 * M * N * K ~ 8 GOP
// each, ~4 us at 1,979 int8 TOPS, against ~1-2 MB of bytes (~0.5 us at
// 3.35 TB/s); its 1x1 convs and the decoder's narrow ones (Cout 16-64) are
// closer to the bytes line.
//
// Design (a simple kernel that is right; wgmma, TMA and a pipelined ring are
// later work):
//   - Implicit GEMM: M = B * Ho * Wo output pixels by N = Cout channels by
//     K taps. A block of 4 warps takes a 64 x 64 tile; each warp a 32 x 32
//     quarter, 2 x 4 mma.sync.m16n8k32 s8 tiles with int32 accumulators.
//   - The K loop steps 32 taps at a time: the block gathers the A tile
//     (64 pixels x 32 taps) through the predicate into shared memory, 16
//     bytes a load where C % 16 == 0 (a 16-tap run then lies in one tap
//     position), 4 where C % 4 == 0, else one byte (the stem, C = 3, and
//     the concat widths 17, 65, 129 of DispNetS); the B tile (64 channels x
//     32 taps) is one 16-byte load a thread. Rows are 48 bytes apart in
//     shared memory, so the fragment loads hit 32 different banks.
//   - No double buffering: a __syncthreads between gather and mma.
//   - The epilogue works on the accumulators in registers and writes the
//     output once, in its final type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;       // output pixels a block
constexpr int kBN = 64;       // output channels a block
constexpr int kBK = 32;       // taps a K step
constexpr int kLds = 48;      // bytes between shared-memory rows
constexpr int kThreads = 128;

struct ConvParams {
    const int8_t* x;
    const int8_t* w;
    const float* mult;
    const float* bias;
    const void* res;
    void* out;
    int B, H, W, C;
    int Ho, Wo, Cout;
    int kh, kw, sh, sw, pt, pl, dh, dw, rh, rw;
    int K, Kp;
    int act, out_mode, res_mode;
    float res_scale, out_scale;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Offset of tap k of output pixel (b, oy, ox) in x, or -1 where the
// predicate reads 0 (padding, a dilation hole, or k >= K).
__device__ __forceinline__ long tap_offset(const ConvParams& p, int b, int oy, int ox, int k) {
    if (k >= p.K) return -1;
    const int tap = k / p.C;
    const int ci = k - tap * p.C;
    const int ky = tap / p.kw;
    const int kx = tap - ky * p.kw;
    const int vy = oy * p.sh - p.pt + ky * p.rh;
    const int vx = ox * p.sw - p.pl + kx * p.rw;
    if (vy < 0 || vx < 0) return -1;
    if (vy % p.dh != 0 || vx % p.dw != 0) return -1;
    const int iy = vy / p.dh;
    const int ix = vx / p.dw;
    if (iy >= p.H || ix >= p.W) return -1;
    return ((static_cast<long>(b) * p.H + iy) * p.W + ix) * p.C + ci;
}

// Gather the A tile (kBM pixels x kBK taps starting at k0) into shared
// memory, VEC bytes a load.
template <int VEC>
__device__ __forceinline__ void load_a(const ConvParams& p, int8_t (*As)[kLds], int m0, int k0,
                                       int M) {
    constexpr int kPerRow = kBK / VEC;
    constexpr int kLoads = kBM * kPerRow / kThreads;
    const int hw = p.Ho * p.Wo;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int row = idx / kPerRow;
        const int col = (idx % kPerRow) * VEC;
        const int m = m0 + row;
        long off = -1;
        if (m < M) {
            const int b = m / hw;
            const int rem = m - b * hw;
            const int oy = rem / p.Wo;
            off = tap_offset(p, b, oy, rem - oy * p.Wo, k0 + col);
        }
        if (VEC == 16) {
            int4 v = make_int4(0, 0, 0, 0);
            if (off >= 0) v = *reinterpret_cast<const int4*>(p.x + off);
            *reinterpret_cast<int4*>(&As[row][col]) = v;
        } else if (VEC == 4) {
            int v = 0;
            if (off >= 0) v = *reinterpret_cast<const int*>(p.x + off);
            *reinterpret_cast<int*>(&As[row][col]) = v;
        } else {
            As[row][col] = off >= 0 ? p.x[off] : static_cast<int8_t>(0);
        }
    }
}

__device__ __forceinline__ void emit(const ConvParams& p, long idx, int c, int acc) {
    if (p.out_mode == 3) {
        static_cast<int*>(p.out)[idx] = acc;
        return;
    }
    float y = __fmul_rn(__int2float_rn(acc), p.mult[c]);
    if (p.res_mode == 3) y = __fadd_rn(y, static_cast<const float*>(p.res)[idx]);
    y = __fadd_rn(y, p.bias[c]);
    if (p.res_mode == 1) {
        const float r = static_cast<float>(static_cast<const int8_t*>(p.res)[idx]);
        y = __fadd_rn(y, __fmul_rn(r, p.res_scale));
    } else if (p.res_mode == 2) {
        const __nv_bfloat16 r = static_cast<const __nv_bfloat16*>(p.res)[idx];
        const float main = __bfloat162float(__float2bfloat16_rn(y));
        y = __bfloat162float(__float2bfloat16_rn(__fadd_rn(main, __bfloat162float(r))));
    }
    if (p.act == 1) {
        y = fmaxf(y, 0.0f);
    } else if (p.act == 2) {
        y = y > 0.0f ? y : expm1f(y);
    }
    if (p.out_mode == 0) {
        static_cast<float*>(p.out)[idx] = y;
    } else if (p.out_mode == 1) {
        static_cast<__nv_bfloat16*>(p.out)[idx] = __float2bfloat16_rn(y);
    } else {
        const float q = fminf(fmaxf(rintf(__fdiv_rn(y, p.out_scale)), -127.0f), 127.0f);
        static_cast<int8_t*>(p.out)[idx] = static_cast<int8_t>(q);
    }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(const ConvParams p) {
    __shared__ __align__(16) int8_t As[kBM][kLds];
    __shared__ __align__(16) int8_t Bs[kBN][kLds];
    const int M = p.B * p.Ho * p.Wo;
    const int m0 = blockIdx.x * kBM;
    const int n0 = blockIdx.y * kBN;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int wm = (warp >> 1) * 32;
    const int wn = (warp & 1) * 32;
    const int g = lane >> 2;
    const int t = lane & 3;

    int acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

    for (int k0 = 0; k0 < p.Kp; k0 += kBK) {
        load_a<VEC>(p, As, m0, k0, M);
        {
            const int row = threadIdx.x >> 1;
            const int col = (threadIdx.x & 1) * 16;
            const int n = n0 + row;
            int4 v = make_int4(0, 0, 0, 0);
            if (n < p.Cout) {
                v = *reinterpret_cast<const int4*>(p.w + static_cast<long>(n) * p.Kp + k0 + col);
            }
            *reinterpret_cast<int4*>(&Bs[row][col]) = v;
        }
        __syncthreads();
        uint32_t a[2][4];
        uint32_t b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
            const int row = wm + mi * 16 + g;
            a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[row][t * 4]);
            a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[row + 8][t * 4]);
            a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[row][16 + t * 4]);
            a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[row + 8][16 + t * 4]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int col = wn + ni * 8 + g;
            b[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[col][t * 4]);
            b[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[col][16 + t * 4]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
        __syncthreads();
    }

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int m = m0 + wm + mi * 16 + g + (r >= 2 ? 8 : 0);
                const int c = n0 + wn + ni * 8 + t * 2 + (r & 1);
                if (m < M && c < p.Cout) emit(p, static_cast<long>(m) * p.Cout + c, c, acc[mi][ni][r]);
            }
}

}  // namespace

extern "C" {

// dims: B, H, W, C, Ho, Wo, Cout, kh, kw, sh, sw, pt, pl, dh, dw, rh, rw,
// Kp, act, out_mode, res_mode (21 ints). x and, where res_mode > 0, res are
// contiguous on `device`; w is (Cout, Kp); the caller has checked the
// shapes and that x, w allow 16-byte loads. Returns cudaGetLastError() as
// an int.
int int8_conv(const void* x, const void* w, const float* mult, const float* bias,
              const void* res, void* out, const int* dims, float res_scale, float out_scale,
              int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    ConvParams p;
    p.x = static_cast<const int8_t*>(x);
    p.w = static_cast<const int8_t*>(w);
    p.mult = mult;
    p.bias = bias;
    p.res = res;
    p.out = out;
    p.B = dims[0]; p.H = dims[1]; p.W = dims[2]; p.C = dims[3];
    p.Ho = dims[4]; p.Wo = dims[5]; p.Cout = dims[6];
    p.kh = dims[7]; p.kw = dims[8]; p.sh = dims[9]; p.sw = dims[10];
    p.pt = dims[11]; p.pl = dims[12]; p.dh = dims[13]; p.dw = dims[14];
    p.rh = dims[15]; p.rw = dims[16]; p.Kp = dims[17];
    p.act = dims[18]; p.out_mode = dims[19]; p.res_mode = dims[20];
    p.K = p.kh * p.kw * p.C;
    p.res_scale = res_scale;
    p.out_scale = out_scale;
    const long M = static_cast<long>(p.B) * p.Ho * p.Wo;
    if (M < 1 || p.Cout < 1 || p.K < 1 || p.Kp < p.K || p.Kp % kBK != 0 || p.dh < 1 ||
        p.dw < 1 || M > (1L << 31) - kBM) {
        return cudaErrorInvalidValue;
    }
    const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), (p.Cout + kBN - 1) / kBN);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (p.C % 16 == 0) {
        int8_conv_kernel<16><<<grid, kThreads, 0, s>>>(p);
    } else if (p.C % 4 == 0) {
        int8_conv_kernel<4><<<grid, kThreads, 0, s>>>(p);
    } else {
        int8_conv_kernel<1><<<grid, kThreads, 0, s>>>(p);
    }
    return cudaGetLastError();
}

const char* int8_conv_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
