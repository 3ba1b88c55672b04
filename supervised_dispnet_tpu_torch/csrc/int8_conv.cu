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
// The function. x is NHWC int8 (B, H, W, C), C a multiple of 16 (the caller
// pads channels with zeros). The conv runs as 1 to 4 phases
// (ops/cuda/int8_conv.py::plan): an lhs-dilated conv (dilation 2, stride 1)
// is split by output parity into 4 convs over the undilated input, each
// with only the taps that land on input pixels; any other conv is one
// phase. Phase f computes outputs (oy, ox) = (j * osy + py, i * osx + px),
// j < ho, i < wo, summing over taps t < nty, u < ntx and channels ci the
// products of x[b, j * sy + off_y + t * ty, i * sx + off_x + u * tx, ci]
// (0 outside the input) with its weight block: w is (Cout, wrow) int8, the
// phase's (t, u, ci) taps at byte column w_off of each row, zero-padded to
// whole K tiles of kBK bytes. The sum is int32 and exact (|sum| <= 127 *
// 127 * K, K <= 25,600 on the model's convs), so every order of it, and
// every split of it, is the same number. Then per output channel c, with
// float32 operations rounded one at a time (__fmul_rn, __fadd_rn, __fmaf_rn:
// nvcc contracts none of them, so the card rounds where the CPU's plain
// version does):
//   y = float(acc) * mult[c]
//   res_mode 3:  y = y + r                  (float32 r, added before bias)
//   y = y + bias[c]
//   res_mode 1:  y = y + float(r) * res_scale  (int8 r, the identity of a block)
//   res_mode 2:  y = float(bf16(bf16(y) + r))  (bf16 r: both sides rounded to
//                bf16 before the add, as the JAX chain does at a block with
//                a downsample conv)
//   act 1: max(y, 0); act 2: y > 0 ? y : expm1(y)
//   out 0: float32 y; 1: bf16 y; 2: int8 clip(rint(y / out_scale), -127, 127)
//   (round half to even, a correctly rounded division); 3: the raw int32
//   accumulator.
//
// What bounds it, by class of conv (at (8, 3, 128, 416)):
//   - the deep-K convs of the small maps (ResNet-50's layers 3-4, the
//     decoder's upconv4_0 at K = 18,432, the fused stages' skips, FCRN's
//     unpool convs at K up to 25,600): operations, 1-6 us at 1,979 int8
//     TOPS, but only 14-56 output tiles for 132 SMs, and every tile
//     streams its weights from L2;
//   - the wide maps (the stems, layer1, the decoder at 64x208 and 128x416,
//     DispNetS's concat inputs, C = 17 / 65 / 129): bytes, the taps'
//     gathers from L2 and the output's writes, and the epilogue's
//     instructions, 8-30 a value;
//   - the stems (C = 3, 7x7/2): bytes; 16 / 3 of the gathered bytes are
//     padding, bought for 16-byte loads;
//   - the lhs-dilated convs: operations, 1/4 of the dilated conv's taps.
//
// Design:
//   - Implicit GEMM: M = B * ho * wo output pixels of a phase by N = Cout by
//     K taps. A block of WG warpgroups (128 threads each) takes a 64 * WG by
//     BN tile (BN 16, 32, 64 or 128, the least that holds Cout; two
//     warpgroups only with BN <= 64, where 128 x BN still fills a wave);
//     each warpgroup issues wgmma.mma_async m64nBNk32 s32.s8.s8, both
//     operands in shared memory, K-major, in the 128-byte swizzle: a stage
//     holds a kBK = 128-byte slice of K for each row, 4 wgmma k-steps, the
//     descriptor advanced 32 bytes a step.
//   - An asynchronous ring of 3 to kMaxStages stages, as deep as the K
//     tiles a block walks and kRingBytes (two blocks an SM) or, where the
//     grid is one wave, kWaveRingBytes allow: every thread gathers its A
//     rows' 16-byte chunks with cp.async (zero-filled, src-size 0, where the
//     tap falls outside the input or past K) and the weight tile's chunks
//     the same way; stages - 2 tiles load while one multiplies
//     (cp.async.wait_group, then fence.proxy.async and a barrier before
//     wgmma reads them; one wgmma group stays in flight, wgmma.wait_group 1,
//     so the stage two behind is the one refilled).
//   - Address arithmetic out of the K loop: each thread owns one 16-byte
//     column of the A tile and 64 * WG / (16 * WG) = 4 of its rows; the rows'
//     pixel offsets and input corners are computed once a block, the
//     column's (t, u, ci) tap is stepped by kBK bytes a stage with adds.
//   - Split-K: where the plan's tiles fill at most half a wave, blockIdx.z
//     also holds the K slice; each block stores its int32 tile (in the
//     accumulators' register order, so the stores and the reads are
//     coalesced) in the workspace, fences, and counts itself in at the
//     tile's counter; the last to arrive adds the other slices, runs the
//     epilogue and sets the counter back to 0. One launch a conv.
//   - Phases: blockIdx.z = phase * splits + split; the outputs of a phase
//     are written at stride osy, osx.
//   - The epilogue stages the accumulators (wgmma's fragment: row
//     16 * warp + lane / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) +
//     2 * (lane % 4) + i % 2) in the freed ring, the residual tile beside
//     them with cp.async, and writes each output once, in its final type, a
//     warp a whole run of a row's channels. Its loop is compiled for each
//     variant the networks run (write_tile), and the int8 output's division
//     is Markstein's correction of a product by the reciprocal (code()):
//     bit for bit __fdiv_rn's quotient, without its slow path on zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 128;      // bytes of K a stage: one 128-byte swizzle row
// a block's ring: two blocks fit an SM; one, where the grid is one wave
constexpr int kRingBytes = 110 * 1024;
constexpr int kWaveRingBytes = 200 * 1024;
constexpr int kMaxStages = 8;
constexpr int kMaxPhases = 4;

// n / d for 0 <= n < 2^31 without a division (the card divides integers
// through its conversion unit, 16 a clock an SM, which a block's setup
// saturated): umulhi(n, mul) >> shift, mul = ceil(2^(31 + ceil(log2 d)) / d),
// shift = ceil(log2 d) - 1; mul 0 for d = 1 (ops/cuda/int8_conv.py::
// fast_divisor)
struct FastDiv {
    unsigned mul;
    int shift;
};

__device__ __forceinline__ int fast_div(int n, FastDiv d) {
    return d.mul == 0 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), d.mul) >> d.shift);
}

struct Phase {
    int py, px;        // the phase's first output row and column
    int nty, ntx;      // taps
    int off_y, off_x;  // input row and column of tap 0 at output index 0
    int ho, wo;        // outputs along each axis
    int nk;            // K tiles (kBK bytes each)
    int w_off;         // byte column of the phase's block in a weight row
    int mtiles;        // M tiles
    int tile_base;     // M tiles of the phases before it
    FastDiv div_hw, div_wo, div_ntx;  // by ho * wo, wo and ntx
};

struct ConvParams {
    const int8_t* x;
    const int8_t* w;
    const float* mult;
    const float* bias;
    const void* res;
    void* out;
    int* ws;        // split-K partial tiles
    int* counters;  // split-K arrivals a tile, 0 between launches
    int B, H, W, C;
    int Ho, Wo, Cout, wrow;
    int sy, sx, ty, tx, osy, osx;
    int act, out_mode, res_mode, splits, nphases;
    int stages;  // the ring's depth: 3 to kMaxStages
    FastDiv div_c;  // by C
    float res_scale, out_scale;
    Phase ph[kMaxPhases];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros where !ok
// (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the generic proxy's writes (cp.async) made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving an accumulator's use across a wgmma wait
__device__ __forceinline__ void fence_operand(int& r) {
    asm volatile("" : "+r"(r) :: "memory");
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the leading offset is unused in this layout)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
           (1ull << 62);
}

// d += A (64 x 32 bytes, descriptor a) * B^T (N x 32 bytes, descriptor b),
// d a thread's N / 2 int32 accumulators of the warpgroup's 64 x N tile
__device__ __forceinline__ void wgmma_n16(int (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t a, uint64_t b) {
    if constexpr (BN == 16) {
        wgmma_n16(d, a, b);
    } else if constexpr (BN == 32) {
        wgmma_n32(d, a, b);
    } else if constexpr (BN == 64) {
        wgmma_n64(d, a, b);
    } else {
        wgmma_n128(d, a, b);
    }
}

// The epilogue's helpers take the output mode, activation and residual mode
// as arguments: write_tile calls them with constants for the variants the
// networks run, so that each of its loops holds only its own arithmetic.

// the residual of output element idx as a float (exact)
__device__ __forceinline__ float load_res(const ConvParams& p, int res_mode, long idx) {
    if (res_mode == 1) return static_cast<float>(static_cast<const int8_t*>(p.res)[idx]);
    if (res_mode == 2) return __bfloat162float(static_cast<const __nv_bfloat16*>(p.res)[idx]);
    return static_cast<const float*>(p.res)[idx];
}

// y of one accumulator before its conversion to the output type
__device__ __forceinline__ float epilogue(const ConvParams& p, int act, int res_mode, int acc,
                                          float mult, float bias, float r) {
    float y = __fmul_rn(__int2float_rn(acc), mult);
    if (res_mode == 3) y = __fadd_rn(y, r);
    y = __fadd_rn(y, bias);
    if (res_mode == 1) {
        y = __fadd_rn(y, __fmul_rn(r, p.res_scale));
    } else if (res_mode == 2) {
        const float main = __bfloat162float(__float2bfloat16_rn(y));
        y = __bfloat162float(__float2bfloat16_rn(__fadd_rn(main, r)));
    }
    if (act == 1) {
        y = fmaxf(y, 0.0f);
    } else if (act == 2) {
        y = y > 0.0f ? y : expm1f(y);
    }
    return y;
}

// clip(rint(y / out_scale), -127, 127), rcp = __frcp_rn(out_scale). The
// quotient: __fdiv_rn's own fast path fails its check on a zero dividend
// (half of a ReLU's outputs) and calls a slow subroutine, so it is
// Markstein's correction of y * rcp instead, the same number: with rcp the
// correctly rounded reciprocal, q0 = RN(y * rcp) lies within an ulp of
// y / s, the remainder y - q0 * s is exact in one FMA, and RN(q0 + r * rcp)
// is the correctly rounded y / s (Markstein 1990) wherever nothing
// overflows or underflows; there the code is 0 or +-127 either way, and a
// NaN (from an infinite y) takes __fdiv_rn.
__device__ __forceinline__ int8_t code(const ConvParams& p, float rcp, float y) {
    const float q0 = __fmul_rn(y, rcp);
    float q = __fmaf_rn(__fmaf_rn(-q0, p.out_scale, y), rcp, q0);
    if (q != q) q = __fdiv_rn(y, p.out_scale);
    return static_cast<int8_t>(fminf(fmaxf(rintf(q), -127.0f), 127.0f));
}

// output elements idx .. idx + 3 (channels of one pixel, n of them left in
// the row) from their accumulators a, the channels' scales and biases and
// the residuals r, in the output type; one store where vec (Cout a
// multiple of 4, so idx is)
__device__ __forceinline__ void store4(const ConvParams& p, int out_mode, int act, int res_mode,
                                       float rcp, long idx, bool vec, int n, int4 a,
                                       const float* mult, const float* bias, const float (&r)[4]) {
    const int acc[4] = {a.x, a.y, a.z, a.w};
    const bool one = vec && n >= 4;
    if (out_mode == 3) {
        int* out = static_cast<int*>(p.out) + idx;
        if (one) {
            *reinterpret_cast<int4*>(out) = a;
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (j < n) out[j] = acc[j];
            }
        }
        return;
    }
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = epilogue(p, act, res_mode, acc[j], mult[j], bias[j], r[j]);
    if (out_mode == 0) {
        float* out = static_cast<float*>(p.out) + idx;
        if (one) {
            *reinterpret_cast<float4*>(out) = make_float4(y[0], y[1], y[2], y[3]);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (j < n) out[j] = y[j];
            }
        }
    } else if (out_mode == 1) {
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + idx;
        __nv_bfloat16 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = __float2bfloat16_rn(y[j]);
        if (one) {
            *reinterpret_cast<uint2*>(out) = make_uint2(
                __bfloat16_as_ushort(b[0]) | (static_cast<unsigned>(__bfloat16_as_ushort(b[1])) << 16),
                __bfloat16_as_ushort(b[2]) | (static_cast<unsigned>(__bfloat16_as_ushort(b[3])) << 16));
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (j < n) out[j] = b[j];
            }
        }
    } else {
        int8_t* out = static_cast<int8_t*>(p.out) + idx;
        int8_t q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) q[j] = code(p, rcp, y[j]);
        if (one) {
            *reinterpret_cast<char4*>(out) = make_char4(q[0], q[1], q[2], q[3]);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (j < n) out[j] = q[j];
            }
        }
    }
}

// The epilogue's loop over a tile staged in shared memory: a thread takes 4
// channels of a row at a time (a warp a whole run of a row), their
// accumulators from `staged` (kLd ints a row), scales and biases from
// s_mult / s_bias, residuals from `res_tile` (BN elements a row) where it
// holds them, else from global memory. OUT, ACT, RES: the output mode,
// activation and residual mode, constants, or -1 to read them from p.
template <int OUT, int ACT, int RES, int BN, int kBM, int kT>
__device__ __forceinline__ void write_tile(const ConvParams& p, int n0, const int* staged, int kLd,
                                           const float* s_mult, const float* s_bias,
                                           const long* s_obase, const uint8_t* res_tile) {
    const int out_mode = OUT >= 0 ? OUT : p.out_mode;
    const int act = ACT >= 0 ? ACT : p.act;
    const int res_mode = RES >= 0 ? RES : p.res_mode;
    constexpr int kGroups = BN / 4;  // 4-channel groups of a row
    const bool vec = (p.Cout & 3) == 0;
    const float rcp = out_mode == 2 ? __frcp_rn(p.out_scale) : 0.0f;
#pragma unroll 1
    for (int idx = threadIdx.x; idx < kBM * kGroups; idx += kT) {
        const int row = idx / kGroups;
        const int g = idx - row * kGroups;
        const int c = n0 + 4 * g;
        const long ob = s_obase[row];
        if (ob < 0 || c >= p.Cout) continue;
        const int n = p.Cout - c;
        float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (res_mode != 0 && res_tile != nullptr) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int e = row * BN + 4 * g + j;
                r[j] = res_mode == 1 ? static_cast<float>(reinterpret_cast<const int8_t*>(res_tile)[e])
                     : res_mode == 2 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(res_tile)[e])
                                     : reinterpret_cast<const float*>(res_tile)[e];
            }
        } else if (res_mode != 0) {
#pragma unroll
            for (int j = 0; j < 4; ++j) r[j] = j < n ? load_res(p, res_mode, ob + c + j) : 0.0f;
        }
        const int4 a = *reinterpret_cast<const int4*>(staged + row * kLd + 4 * g);
        store4(p, out_mode, act, res_mode, rcp, ob + c, vec, n, a, s_mult + 4 * g, s_bias + 4 * g,
               r);
    }
}

// ints between rows of the accumulator tile staged in shared memory for
// the epilogue (8 more than BN: a warp's 8-byte stores in 2 wavefronts)
template <int BN>
__host__ __device__ constexpr int staged_ld() {
    return BN + 8;
}

// shared memory the epilogue takes from the freed ring: the staged int32
// tile and a float32 residual tile
template <int BN, int WG>
__host__ __device__ constexpr int epilogue_bytes() {
    return 64 * WG * (staged_ld<BN>() + BN) * 4;
}

// blocks an SM should hold: the narrow tiles run few K tiles a block and
// hide their latency with more blocks
template <int BN, int WG>
__host__ __device__ constexpr int min_blocks() {
    return BN <= 32 ? 3 : (BN == 64 && WG == 1 ? 3 : (BN == 64 ? 2 : 1));
}

__device__ __forceinline__ void cp_async_wait_ring(int stages) {
    // stages - 3 groups may stay in flight (a constant in the instruction)
    switch (stages) {
        case 3: cp_async_wait<0>(); break;
        case 4: cp_async_wait<1>(); break;
        case 5: cp_async_wait<2>(); break;
        case 6: cp_async_wait<3>(); break;
        case 7: cp_async_wait<4>(); break;
        default: cp_async_wait<5>(); break;
    }
}

template <int BN, int WG>
__global__ void __launch_bounds__(128 * WG, (min_blocks<BN, WG>())) int8_conv_kernel(const ConvParams p) {
    constexpr int kT = 128 * WG;         // threads
    constexpr int kBM = 64 * WG;         // output pixels a tile
    constexpr int kA = kBM * kBK;        // bytes of a stage's A tile
    constexpr int kStage = (kBM + BN) * kBK;
    constexpr int kNR = BN / 2;          // accumulators a thread
    constexpr int kRowStep = kT / 8;     // A rows between a thread's rows
    constexpr int kRows = kBM / kRowStep;
    constexpr int kLd = staged_ld<BN>();
    static_assert(kMaxStages * kStage >= epilogue_bytes<BN, WG>(),
                  "the staged tile and a float32 residual tile fit the deepest ring");
    const int stages = p.stages;
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    __shared__ int s_last;
    __shared__ float s_mult[BN], s_bias[BN];
    __shared__ long s_obase[kBM];  // a tile row's output offset, -1 past M
    // stage tiles on 1024-byte boundaries: the swizzle XORs address bits 4-6
    // with bits 7-9, i.e. a row's 16-byte chunk with the row mod 8
    const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;

    const int tid = threadIdx.x;
    const int phase = blockIdx.z / p.splits;
    const int split = blockIdx.z - phase * p.splits;
    Phase ph = p.ph[0];
#pragma unroll
    for (int f = 1; f < kMaxPhases; ++f) {
        if (phase == f) ph = p.ph[f];
    }
    if (static_cast<int>(blockIdx.x) >= ph.mtiles) return;  // a phase with fewer M tiles
    const int M = p.B * ph.ho * ph.wo;
    const int hw = ph.ho * ph.wo;
    const int m0 = blockIdx.x * kBM;
    const int n0 = blockIdx.y * BN;
    const int lo = split * ph.nk / p.splits;
    const int nkl = (split + 1) * ph.nk / p.splits - lo;

    // this thread's A rows: pixel offsets and input corners, once a block
    const int col = tid & 7;
    int pix[kRows], iy0[kRows], ix0[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int m = m0 + (tid >> 3) + r * kRowStep;
        if (m < M) {
            const int b = fast_div(m, ph.div_hw);
            const int rem = m - b * hw;
            const int jy = fast_div(rem, ph.div_wo);
            const int jx = rem - jy * ph.wo;
            iy0[r] = jy * p.sy + ph.off_y;
            ix0[r] = jx * p.sx + ph.off_x;
            pix[r] = ((b * p.H + iy0[r]) * p.W + ix0[r]) * p.C;
        } else {
            iy0[r] = -(1 << 28);  // fails every bounds check
            ix0[r] = 0;
            pix[r] = 0;
        }
    }
    // this thread's column of K: its tap (ky, kx) and channel, stepped a stage
    const int ntx = ph.ntx > 0 ? ph.ntx : 1;
    int ci, ky, kx;
    {
        const int k = lo * kBK + col * 16;
        const int tap = fast_div(k, p.div_c);
        ci = k - tap * p.C;
        ky = fast_div(tap, ph.div_ntx);
        kx = tap - ky * ntx;
    }
    int kt_next = lo;

    auto load = [&](int stage) {
        const uint32_t sa = base + stage * kStage;
        const uint32_t sb = sa + kA;
        const bool in_k = ky < ph.nty;
        const int dy = ky * p.ty;
        const int dx = kx * p.tx;
        const long delta = (static_cast<long>(dy) * p.W + dx) * p.C + ci;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            const int row = (tid >> 3) + r * kRowStep;
            const bool ok = in_k && static_cast<unsigned>(iy0[r] + dy) < static_cast<unsigned>(p.H) &&
                            static_cast<unsigned>(ix0[r] + dx) < static_cast<unsigned>(p.W);
            const int8_t* src = ok ? p.x + (pix[r] + delta) : p.x;
            cp_async16(sa + row * kBK + ((col ^ (row & 7)) << 4), src, ok);
        }
        ci += kBK;
        while (ci >= p.C) {
            ci -= p.C;
            if (++kx == ntx) {
                kx = 0;
                ++ky;
            }
        }
        const long kcol = ph.w_off + static_cast<long>(kt_next) * kBK;
#pragma unroll
        for (int idx = tid; idx < BN * 8; idx += kT) {
            const int n = idx >> 3;
            const int c = idx & 7;
            const bool ok = n0 + n < p.Cout;
            const int8_t* src = ok ? p.w + static_cast<long>(n0 + n) * p.wrow + kcol + c * 16 : p.w;
            cp_async16(sb + n * kBK + ((c ^ (n & 7)) << 4), src, ok);
        }
        ++kt_next;
    };

    int acc[kNR];
#pragma unroll
    for (int i = 0; i < kNR; ++i) acc[i] = 0;

    // the ring: stages - 2 tiles ahead of the one multiplied, and the one
    // before it still read by the wgmma group in flight
#pragma unroll 1
    for (int t = 0; t < stages - 2; ++t) {
        if (t < nkl) load(t);
        cp_async_commit();
    }
    const int wg = tid >> 7;
#pragma unroll 1
    for (int t = 0; t < nkl; ++t) {
        cp_async_wait_ring(stages);  // this thread's part of tile t is in
        fence_proxy_async();
        __syncthreads();  // everyone's part of tile t; the wgmma of t - 2 done
        if (t + stages - 2 < nkl) load((t + stages - 2) % stages);
        cp_async_commit();
        const uint32_t sa = base + (t % stages) * kStage + wg * 64 * kBK;
        const uint32_t sb = base + (t % stages) * kStage + kA;
#pragma unroll
        for (int i = 0; i < kNR; ++i) fence_operand(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 32; ++k) {
            wgmma_tile<BN>(acc, sw128_desc(sa + 32 * k), sw128_desc(sb + 32 * k));
        }
        wgmma_commit();
        wgmma_wait<1>();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kNR; ++i) fence_operand(acc[i]);

    if (p.splits > 1) {
        // the tile's K slices meet at the last block to finish one
        const long tile = static_cast<long>(ph.tile_base + blockIdx.x) * gridDim.y + blockIdx.y;
        int* slot = p.ws + (tile * p.splits + split) * (kBM * BN);
#pragma unroll
        for (int i = 0; i < kNR; ++i) __stcg(slot + i * kT + tid, acc[i]);
        __threadfence();
        __syncthreads();
        if (tid == 0) s_last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
        __syncthreads();
        if (!s_last) return;
        __threadfence();
        for (int q = 0; q < p.splits; ++q) {
            if (q == split) continue;
            const int* other = p.ws + (tile * p.splits + q) * (kBM * BN);
#pragma unroll
            for (int i = 0; i < kNR; ++i) acc[i] += __ldcg(other + i * kT + tid);
        }
        if (tid == 0) p.counters[tile] = 0;
    }

    // the epilogue, from the tile staged in shared memory (the ring is free:
    // every warpgroup has waited for its wgmma), so that one short loop
    // writes whole runs of a row's channels, a thread 4 channels of a row at
    // a time; the residual tile comes in beside it with cp.async
    __syncthreads();
    int* staged = reinterpret_cast<int*>(smem_raw + (base - smem_addr(smem_raw)));
    {
        const int lane = tid & 31;
        const int r0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
        for (int i = 0; i < kNR; i += 2) {
            const int row = r0 + 8 * ((i >> 1) & 1);
            const int col = 8 * (i >> 2) + 2 * (lane & 3);
            *reinterpret_cast<int2*>(staged + row * kLd + col) = make_int2(acc[i], acc[i + 1]);
        }
    }
    if (tid < BN) {
        const int c = n0 + tid;
        s_mult[tid] = c < p.Cout ? p.mult[c] : 0.0f;
        s_bias[tid] = c < p.Cout ? p.bias[c] : 0.0f;
    }
    for (int r = tid; r < kBM; r += kT) {
        const int m = m0 + r;
        long ob = -1;
        if (m < M) {
            const int b = fast_div(m, ph.div_hw);
            const int rem = m - b * hw;
            const int jy = fast_div(rem, ph.div_wo);
            const int jx = rem - jy * ph.wo;
            ob = (static_cast<long>(b * p.Ho + jy * p.osy + ph.py) * p.Wo + jx * p.osx + ph.px) *
                 p.Cout;
        }
        s_obase[r] = ob;
    }
    __syncthreads();
    const int esize = p.res_mode == 1 ? 1 : (p.res_mode == 2 ? 2 : 4);
    // the residual tile in shared memory where its rows are whole 16-byte
    // chunks: kBM rows of BN elements after the staged accumulators
    const bool res_tile = p.res_mode != 0 && (p.Cout * esize) % 16 == 0 &&
                          (reinterpret_cast<uintptr_t>(p.res) & 15) == 0;
    const uint32_t res_smem = base + kBM * kLd * 4;
    const uint8_t* res_tile_ptr = smem_raw + (res_smem - smem_addr(smem_raw));
    if (res_tile) {
        const int chunks_log2 = __ffs(BN * esize / 16) - 1;  // a row's: a power of 2
        const int valid = ((p.Cout - n0 < BN ? p.Cout - n0 : BN) * esize) / 16;
        for (int idx = tid; idx < kBM << chunks_log2; idx += kT) {
            const int row = idx >> chunks_log2;
            const int ch = idx & ((1 << chunks_log2) - 1);
            const long ob = s_obase[row];
            const bool ok = ob >= 0 && ch < valid;
            const uint8_t* src = static_cast<const uint8_t*>(p.res) +
                                 (ok ? (ob + n0) * esize + ch * 16 : 0);
            cp_async16(res_smem + row * BN * esize + ch * 16, src, ok);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
    }
    const uint8_t* rt = res_tile ? res_tile_ptr : nullptr;
    // the variants the networks run, each with its own loop; any other
    // reads its modes at run time
    switch (p.out_mode * 16 + p.act * 4 + p.res_mode) {
        case 2 * 16 + 1 * 4 + 0:  // int8, ReLU: the chains' inner convs
            write_tile<2, 1, 0, BN, kBM, kT>(p, n0, staged, kLd, s_mult, s_bias, s_obase, rt);
            break;
        case 2 * 16 + 1 * 4 + 1:  // int8, ReLU, int8 identity: a block's end
            write_tile<2, 1, 1, BN, kBM, kT>(p, n0, staged, kLd, s_mult, s_bias, s_obase, rt);
            break;
        case 2 * 16 + 1 * 4 + 2:  // int8, ReLU, bf16 downsample: a first block's end
            write_tile<2, 1, 2, BN, kBM, kT>(p, n0, staged, kLd, s_mult, s_bias, s_obase, rt);
            break;
        case 1 * 16 + 0 * 4 + 0:  // bf16: a downsample conv
            write_tile<1, 0, 0, BN, kBM, kT>(p, n0, staged, kLd, s_mult, s_bias, s_obase, rt);
            break;
        case 2 * 16 + 2 * 4 + 0:  // int8, ELU: the decoder's upconvs
            write_tile<2, 2, 0, BN, kBM, kT>(p, n0, staged, kLd, s_mult, s_bias, s_obase, rt);
            break;
        case 2 * 16 + 2 * 4 + 3:  // int8, ELU, float32 before the bias: a fused stage's skip
            write_tile<2, 2, 3, BN, kBM, kT>(p, n0, staged, kLd, s_mult, s_bias, s_obase, rt);
            break;
        case 0:  // float32: the per-conv path
            write_tile<0, 0, 0, BN, kBM, kT>(p, n0, staged, kLd, s_mult, s_bias, s_obase, rt);
            break;
        case 3 * 16:  // the raw int32 accumulators
            write_tile<3, 0, 0, BN, kBM, kT>(p, n0, staged, kLd, s_mult, s_bias, s_obase, rt);
            break;
        default:
            write_tile<-1, -1, -1, BN, kBM, kT>(p, n0, staged, kLd, s_mult, s_bias, s_obase, rt);
            break;
    }
}

template <int BN, int WG>
cudaError_t launch_tile(ConvParams& p, int mtiles, int nk_block, int sms, cudaStream_t s) {
    // a ring no deeper than the K tiles a block walks (stages - 2 of them
    // load ahead), in kRingBytes, or kWaveRingBytes where the grid fits one
    // block an SM; at least 3 stages and room for the epilogue; its bytes
    // + 1024 for the alignment
    constexpr int kStage = (64 * WG + BN) * kBK;
    constexpr int kLeast = (epilogue_bytes<BN, WG>() + kStage - 1) / kStage > 3
                               ? (epilogue_bytes<BN, WG>() + kStage - 1) / kStage
                               : 3;
    const long blocks = static_cast<long>(mtiles) * ((p.Cout + BN - 1) / BN) * p.nphases * p.splits;
    int deepest = (blocks <= sms ? kWaveRingBytes : kRingBytes) / kStage;
    deepest = deepest < kLeast ? kLeast : (deepest > kMaxStages ? kMaxStages : deepest);
    p.stages = nk_block + 2 < kLeast ? kLeast : (nk_block + 2 > deepest ? deepest : nk_block + 2);
    const size_t smem = static_cast<size_t>(p.stages) * kStage + 1024;
    cudaError_t err = cudaFuncSetAttribute(int8_conv_kernel<BN, WG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(mtiles), static_cast<unsigned>((p.Cout + BN - 1) / BN),
                    static_cast<unsigned>(p.nphases * p.splits));
    int8_conv_kernel<BN, WG><<<grid, 128 * WG, smem, s>>>(p);
    return cudaGetLastError();
}

template <int WG>
cudaError_t launch_wg(ConvParams& p, int bn, int mtiles, int nk_block, int sms, cudaStream_t s) {
    switch (bn) {
        case 16: return launch_tile<16, WG>(p, mtiles, nk_block, sms, s);
        case 32: return launch_tile<32, WG>(p, mtiles, nk_block, sms, s);
        case 64: return launch_tile<64, WG>(p, mtiles, nk_block, sms, s);
        case 128: return launch_tile<128, WG>(p, mtiles, nk_block, sms, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// dims: B, H, W, C, Ho, Wo, Cout, wrow, sy, sx, ty, tx, osy, osx, act,
// out_mode, res_mode, splits, nphases, bn, wg, C's FastDiv mul and shift
// (23 ints), then for each of kMaxPhases phases py, px, nty, ntx, off_y,
// off_x, ho, wo, nk, w_off, mtiles, tile_base and the FastDivs (mul, shift)
// of ho * wo, wo and ntx (18 ints; the unused ones 0). x (C a multiple of 16)
// and, where res_mode > 0, res are contiguous on `device`; w is (Cout,
// wrow); ws holds tiles * splits * 64 * wg * bn ints and counters one zeroed
// int a tile where splits > 1. The caller has checked the shapes and that x,
// w allow 16-byte loads. Returns cudaGetLastError() as an int.
int int8_conv(const void* x, const void* w, const float* mult, const float* bias,
              const void* res, void* out, void* ws, void* counters, const int* dims,
              float res_scale, float out_scale, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    ConvParams p;
    p.x = static_cast<const int8_t*>(x);
    p.w = static_cast<const int8_t*>(w);
    p.mult = mult;
    p.bias = bias;
    p.res = res;
    p.out = out;
    p.ws = static_cast<int*>(ws);
    p.counters = static_cast<int*>(counters);
    p.B = dims[0]; p.H = dims[1]; p.W = dims[2]; p.C = dims[3];
    p.Ho = dims[4]; p.Wo = dims[5]; p.Cout = dims[6]; p.wrow = dims[7];
    p.sy = dims[8]; p.sx = dims[9]; p.ty = dims[10]; p.tx = dims[11];
    p.osy = dims[12]; p.osx = dims[13];
    p.act = dims[14]; p.out_mode = dims[15]; p.res_mode = dims[16];
    p.splits = dims[17]; p.nphases = dims[18];
    const int bn = dims[19];
    const int wg = dims[20];
    p.div_c = {static_cast<unsigned>(dims[21]), dims[22]};
    p.res_scale = res_scale;
    p.out_scale = out_scale;
    int mtiles = 0;
    int nk_block = 0;  // K tiles of the deepest slice
    for (int f = 0; f < kMaxPhases; ++f) {
        const int* d = dims + 23 + 18 * f;
        Phase& ph = p.ph[f];
        ph.py = d[0]; ph.px = d[1]; ph.nty = d[2]; ph.ntx = d[3];
        ph.off_y = d[4]; ph.off_x = d[5]; ph.ho = d[6]; ph.wo = d[7];
        ph.nk = d[8]; ph.w_off = d[9]; ph.mtiles = d[10]; ph.tile_base = d[11];
        ph.div_hw = {static_cast<unsigned>(d[12]), d[13]};
        ph.div_wo = {static_cast<unsigned>(d[14]), d[15]};
        ph.div_ntx = {static_cast<unsigned>(d[16]), d[17]};
        if (f < p.nphases && ph.mtiles > mtiles) mtiles = ph.mtiles;
        if (f < p.nphases && p.splits > 0) {
            const int deepest = (ph.nk + p.splits - 1) / p.splits;
            if (deepest > nk_block) nk_block = deepest;
        }
    }
    const long xbytes = static_cast<long>(p.B) * p.H * p.W * p.C;
    if (p.C < 16 || p.C % 16 != 0 || p.wrow % kBK != 0 || p.Cout < 1 || p.nphases < 1 ||
        p.nphases > kMaxPhases || p.splits < 1 || p.splits > 65535 / p.nphases ||
        xbytes >= (1L << 31) || mtiles < 1 || (p.splits > 1 && (!ws || !counters))) {
        return cudaErrorInvalidValue;
    }
    static int sms[64] = {0};  // SMs of each device, asked once
    if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
    if (sms[device] == 0) {
        err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
        if (err != cudaSuccess) return err;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (wg == 1) return launch_wg<1>(p, bn, mtiles, nk_block, sms[device], s);
    if (wg == 2) return launch_wg<2>(p, bn, mtiles, nk_block, sms[device], s);
    return cudaErrorInvalidValue;
}

const char* int8_conv_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
