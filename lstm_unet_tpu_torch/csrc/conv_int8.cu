// int8 conv: SAME, stride-1 conv of an int8 NHWC activation with packed int8
// weights, exact s32 sums, dequantized in the epilogue.
//
// Replaces the int8 conv of lstm_unet_tpu/ops/quant.py::conv2d_q (the XLA
// conv `lax.conv_general_dilated(..., preferred_element_type=int32)` of
// _conv_int8, quant.py:91; no pallas_call) and its dequant:
//   y = (float)acc * (s_x * w_scale[n]) + bias[n]
// each op rounded once in f32 (the explicit _rn intrinsics stop nvcc from
// contracting the multiply and the add into an FMA), then rounded once to the
// output type (bf16 RN, or f32). s_x is a 0-d device tensor read here, so a
// frame's 25 convs need no host read of a scale.
//
// Bound: operations at every flagship site but the 1x1 head (e.g. decoder
// level 0's first conv: 2 * 262144 * 128 * 3456 = 0.23 TOP against ~0.2 GB,
// 0.12 ms at the H100's 1979 int8 TOP/s). So it is an implicit GEMM on the
// tensor cores: M = B*H*W output pixels, N = cout, K = KH*KW*cin ordered
// (tap, channel), no im2col buffer.
//
// Design (simple first; a wgmma / TMA version is later work):
//  - a block computes a 128-pixel x 128-column tile with 8 warps (2 along M
//    x 4 along N, 64 x 32 each) on mma.sync.m16n8k32 s8 x s8 -> s32, fed by
//    ldmatrix from shared memory;
//  - K runs in steps of 64 bytes through a 4-stage cp.async ring. Rows of a
//    stage are 80 bytes apart, so the eight 16-byte rows one ldmatrix reads
//    fall in eight different bank groups;
//  - A (activation) rows are gathered per tap: with cin % 16 == 0 each
//    16-byte chunk of K lies in one tap and is one cp.async, zero-filled
//    where the tap falls outside the frame (the zero point is 0, so SAME
//    padding stays exact), its tap walked on from stage to stage with no
//    division; other cin (1 at flagship level 0's x-conv, 8 and 24 on the
//    tiny model) take a byte gather;
//  - B (weights) is packed once by ops/kernels/conv_int8.py::pack_weight as
//    [N_pad][K_pad], N padded to 128 and K to 64 with zeros, so its loads
//    need no bounds;
//  - the epilogue dequantizes in registers and writes only n < N.
// The largest sum on the flagship is 127^2 * 3*3*1024 = 1.49e8 < 2^31.
// Measured (PERF.md section 6): 16-27% of the int8 bound at the flagship's
// shapes, slower than cuDNN's bf16 conv at most of them.

#include "common.cuh"

namespace lut {

namespace i8 {

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 4, kThreads = 256;
constexpr int kRow = kBK + 16;           // bytes between rows of a stage
constexpr int kTile = kBM * kRow;        // bytes of one A (or B) stage
constexpr int kSmem = kStages * 2 * kTile;

struct Args {
  const int8_t* x;        // [B, H, W, C]
  const int8_t* w;        // [Npad, Kpad]
  const float* s_x;       // 0-d
  const float* w_scale;   // [N]
  const float* bias;      // [N] or null
  void* y;                // [B, H, W, N]
  int H, W, C, KH, KW, N, Kdim, Kpad;
  int M;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where one output pixel of the tile sits: its batch image's base offset in x
// and its (y, x); valid is false past M.
struct Pixel {
  long long base;
  int y, x;
  bool valid;
};

__device__ __forceinline__ Pixel pixel_of(const Args& a, int p) {
  Pixel px;
  px.valid = p < a.M;
  const int q = px.valid ? p : 0;
  const int hw = a.H * a.W;
  const int b = q / hw;
  const int r = q - b * hw;
  px.y = r / a.W;
  px.x = r - px.y * a.W;
  px.base = (long long)b * hw * a.C;
  return px;
}

// x[pixel shifted by tap (ky, kx)][ci] as an offset, or -1 outside the
// frame or past K (ky == KH)
__device__ __forceinline__ long long shifted(const Args& a, const Pixel& px, int ky, int kx,
                                             int ci) {
  const int iy = px.y + ky - a.KH / 2;
  const int ix = px.x + kx - a.KW / 2;
  if (!px.valid || ky >= a.KH || iy < 0 || iy >= a.H || ix < 0 || ix >= a.W) return -1;
  return px.base + ((long long)iy * a.W + ix) * a.C + ci;
}

// the same for K index k = (ky * KW + kx) * C + ci
__device__ __forceinline__ long long tap_offset(const Args& a, const Pixel& px, int k) {
  const int tap = k / a.C;
  const int ky = tap / a.KW;
  return shifted(a, px, ky, tap - ky * a.KW, k - tap * a.C);
}

// A K position (ky, kx, ci) moved on by `step` in K order; no division
__device__ __forceinline__ void advance(const Args& a, int step, int& ky, int& kx, int& ci) {
  ci += step;
  while (ci >= a.C) {
    ci -= a.C;
    if (++kx == a.KW) {
      kx = 0;
      ++ky;
    }
  }
}

template <typename TOut>
__device__ __forceinline__ void store2(TOut* y, long long idx, float v0, float v1, bool pair);

template <>
__device__ __forceinline__ void store2<float>(float* y, long long idx, float v0, float v1,
                                              bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(y + idx) = make_float2(v0, v1);
  } else {
    y[idx] = v0;
  }
}

template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* y, long long idx,
                                                      float v0, float v1, bool pair) {
  if (pair) {
    __nv_bfloat162 v;
    v.x = __float2bfloat16_rn(v0);
    v.y = __float2bfloat16_rn(v1);
    *reinterpret_cast<__nv_bfloat162*>(y + idx) = v;
  } else {
    y[idx] = __float2bfloat16_rn(v0);
  }
}

// VEC: cin % 16 == 0 (16-byte cp.async chunks); else a byte gather.
template <bool VEC, typename TOut>
__global__ void __launch_bounds__(kThreads)
conv_int8_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sA = smem;                        // [stage][128 rows][kRow]
  uint8_t* sB = smem + kStages * kTile;      // [stage][128 cols][kRow]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int num_k = a.Kpad / kBK;

  // A rows this thread stages: VEC, rows tid/4 and tid/4 + 64 at chunk tid%4;
  // byte gather, row tid/2 at bytes (tid%2)*32 .. +31
  const int a_row0 = VEC ? (tid >> 2) : (tid >> 1);
  const Pixel px0 = pixel_of(a, m0 + a_row0);
  const Pixel px1 = pixel_of(a, m0 + a_row0 + 64);
  // B rows (output columns) tid/4 and tid/4 + 64, chunk tid%4
  const int8_t* wrow0 = a.w + (long long)(n0 + (tid >> 2)) * a.Kpad + (tid & 3) * 16;
  const int8_t* wrow1 = wrow0 + 64LL * a.Kpad;
  // VEC: this thread's 16-byte chunk of K as (ky, kx, ci), moved on by kBK a
  // stage (stages are loaded in order), so the K loop runs no division (the
  // byte gather divides per byte: a walk like this one measured slower there)
  int ky = 0, kx = 0, ci = 0;
  if (VEC) advance(a, (tid & 3) * 16, ky, kx, ci);

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    uint8_t* dA = sA + stage * kTile;
    uint8_t* dB = sB + stage * kTile;
    const int c16 = (tid & 3) * 16;
    cp_async16(smem_u32(dB + (tid >> 2) * kRow + c16), wrow0 + k0, 16);
    cp_async16(smem_u32(dB + ((tid >> 2) + 64) * kRow + c16), wrow1 + k0, 16);
    if constexpr (VEC) {
      const long long o0 = shifted(a, px0, ky, kx, ci);
      const long long o1 = shifted(a, px1, ky, kx, ci);
      advance(a, kBK, ky, kx, ci);
      cp_async16(smem_u32(dA + a_row0 * kRow + c16), a.x + (o0 < 0 ? 0 : o0), o0 < 0 ? 0 : 16);
      cp_async16(smem_u32(dA + (a_row0 + 64) * kRow + c16), a.x + (o1 < 0 ? 0 : o1),
                 o1 < 0 ? 0 : 16);
    } else {
      const int kb = k0 + (tid & 1) * 32;
      uint32_t* dst = reinterpret_cast<uint32_t*>(dA + a_row0 * kRow + (tid & 1) * 32);
#pragma unroll
      for (int w4 = 0; w4 < 8; ++w4) {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long o = tap_offset(a, px0, kb + w4 * 4 + j);
          const uint32_t v = o < 0 ? 0u : (uint32_t)(uint8_t)a.x[o];
          word |= v << (8 * j);
        }
        dst[w4] = word;
      }
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < num_k) load_stage(s, s);
    cp_async_commit();
  }

  // ldmatrix row addresses: A, matrix (lane / 8) of a 16 x 32 tile is rows
  // + 8 * (lane/8 % 2), bytes + 16 * (lane / 16); B, two 8-column tiles,
  // columns + 8 * (lane / 16), bytes + 16 * (lane/8 % 2)
  const int a_ld_row = warp_m * 64 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_ld_col = (lane >> 4) * 16;
  const int b_ld_row = warp_n * 32 + (lane & 7) + (lane >> 4) * 8;
  const int b_ld_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < num_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < num_k) load_stage(nk % kStages, nk);
    cp_async_commit();

    const int stage = kt % kStages;
    const uint32_t baseA = smem_u32(sA + stage * kTile);
    const uint32_t baseB = smem_u32(sB + stage * kTile);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(baseA + (a_ld_row + mt * 16) * kRow + kk + a_ld_col, af[mt]);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(baseB + (b_ld_row + np * 16) * kRow + kk + b_ld_col, bf[np]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], af[mt], bf[nt >> 1][(nt & 1) * 2], bf[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: thread holds rows g and g + 8 of each 16-row tile, columns
  // 2 * (lane % 4) and + 1 of each 8-column tile
  const float sx = *a.s_x;
  TOut* y = static_cast<TOut*>(a.y);
  const int g = lane >> 2, t4 = lane & 3;
  const bool even = (a.N & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + warp_n * 32 + nt * 8 + t4 * 2;
    if (n >= a.N) continue;
    const bool has1 = n + 1 < a.N;
    const float sc0 = __fmul_rn(sx, a.w_scale[n]);
    const float sc1 = has1 ? __fmul_rn(sx, a.w_scale[n + 1]) : 0.0f;
    const float b0 = a.bias ? a.bias[n] : 0.0f;
    const float b1 = (a.bias && has1) ? a.bias[n + 1] : 0.0f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = m0 + warp_m * 64 + mt * 16 + g + half * 8;
        if (p >= a.M) continue;
        float v0 = __fmul_rn(__int2float_rn(acc[mt][nt][half * 2]), sc0);
        float v1 = __fmul_rn(__int2float_rn(acc[mt][nt][half * 2 + 1]), sc1);
        if (a.bias) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
        }
        const long long idx = (long long)p * a.N + n;
        if (has1 && even) {
          store2<TOut>(y, idx, v0, v1, true);
        } else {
          store2<TOut>(y, idx, v0, v1, false);
          if (has1) store2<TOut>(y, idx + 1, v1, v1, false);
        }
      }
    }
  }
}

template <bool VEC, typename TOut>
static int launch(const Args& a, cudaStream_t stream) {
  auto kernel = conv_int8_kernel<VEC, TOut>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.M + kBM - 1) / kBM), (unsigned)((a.N + kBN - 1) / kBN));
  kernel<<<grid, kThreads, kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace i8
}  // namespace lut

// x [B,H,W,C] int8, w [Npad,Kpad] int8 (pack_weight), s_x 0-d f32, w_scale
// [N] f32, bias [N] f32 or null; y [B,H,W,N] in out_dtype (kF32 or kBF16).
extern "C" int lut_conv2d_int8(const void* x, const void* w, const void* s_x,
                               const void* w_scale, const void* bias, void* y, int B,
                               int H, int W, int C, int KH, int KW, int N, int Kpad,
                               int out_dtype, void* stream) {
  using namespace lut;
  using namespace lut::i8;
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.s_x = static_cast<const float*>(s_x);
  a.w_scale = static_cast<const float*>(w_scale);
  a.bias = static_cast<const float*>(bias);
  a.y = y;
  a.H = H;
  a.W = W;
  a.C = C;
  a.KH = KH;
  a.KW = KW;
  a.N = N;
  a.Kdim = KH * KW * C;
  a.Kpad = Kpad;
  a.M = B * H * W;
  if (Kpad % kBK != 0 || Kpad < a.Kdim || a.M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = C % 16 == 0;
  if (out_dtype == kF32) return vec ? launch<true, float>(a, s) : launch<false, float>(a, s);
  if (out_dtype == kBF16)
    return vec ? launch<true, __nv_bfloat16>(a, s) : launch<false, __nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}
