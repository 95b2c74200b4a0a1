// int8 conv, small-K route: a SAME, stride-1 s8 x s8 -> s32 conv whose whole
// reduction K = KH*KW*cin fits one weight tile that a block keeps in shared
// memory for its lifetime, with the activation quantize folded into its
// staging and the output written in full 16-byte pieces of its rows.
//
// Replaces, as conv_int8.cu and conv_int8_wgmma.cu do, the int8 conv of
// lstm_unet_tpu/ops/quant.py::conv2d_q (the XLA conv of _conv_int8,
// quant.py:91; no pallas_call) with its dequant and the activation quantize
// before it (quantize_act, quant.py:41-56). From x [B,H,W,C] in bf16 or f32:
//   s_x = the static 0-d f32 scale, or (dynamic) fmaxf(amax, 1e-8) / 127
//         from the 0-d amax = max|x| (in x's dtype), the reference's order;
//   q   = clamp(rint(x / s_x), -127, 127): the true division (__fdiv_rn),
//         rounded half to even; SAME padding is q = 0;
//   acc = exact s32 sums over (tap, channel);
//   y   = (float)acc * (s_x * w_scale[n]) + bias[n], each op rounded once in
//         f32 (the add skipped with no bias), then once to the output type.
//
// Bound: bytes written. The flagship's site (level 0's x-conv: 5x5, cin = 1,
// cout = 512 at 512^2) writes 268 MB of bf16 gates from 0.5 MB of input:
// 0.080 ms at 3.35 TB/s; its 6.7 GOP are 0.003 ms of int8 tensor work. The
// tiny model's cin 8 and 24 sites (K = 72, 216) are the same kind of site.
// So the design is a streaming writer that spends as few instructions and
// shared-memory cycles as it can on each output value:
//  - persistent: a grid of as many blocks as fit on the SMs walks the
//    output tiles, each a segment of 64 consecutive pixels of one row;
//  - weights: ops/kernels/conv_int8.py::pack_weight_smallk lays the int8
//    weights out once, for all N columns and the whole K padded to the
//    instruction's k of 32, in the mma.sync B-fragment order ([k step]
//    [8-column tile][lane][8 bytes]); a block copies them into shared memory
//    once (16 KB at the flagship's site), with s_x * w_scale and the bias;
//  - input: per tile the halo'd KH x (64 + KW - 1) x C window of x is read
//    once and quantized as above into bytes, then laid out as the tile's A
//    rows (64 pixels x K, through an offset table from k to its byte of the
//    window), so the fragments are 32-bit shared loads; no int8 tensor and
//    no im2col reaches device memory;
//  - products: mma.sync.m16n8k32 s8 (K padded to 32, not 64); a warp takes
//    16 pixels x 64 columns at a time, and where it keeps one column group
//    (the flagship's 512 columns over 8 warps) its scales, bias and, with
//    one k step, its B fragments stay in registers across tiles;
//  - epilogue: the dequant in registers, with the int-to-float conversion
//    as an integer add and one f32 subtraction (exact: |acc| < 2^22 for
//    K <= 256), not the quarter-rate I2F; the warp's 16 x 64 piece goes
//    through its own slice of shared memory (rows padded, so the fragment
//    stores do not collide in banks) and out as 16-byte stores, each row's
//    128 (bf16) or 256 (f32) bytes whole. Full rows, not the instruction's
//    scattered 4-byte fragments, are what buys the time: the generic mma_sync
//    kernel (conv_int8.cu) wrote this site at ~0.77 TB/s. (Rows that are not
//    a multiple of 16 bytes, such as the tiny model's 3-column head, are
//    stored element by element.)
// Result: bit-equal to the plain version (int32 sums are exact, the
// dequant is the same sequence of roundings). Shared memory:
// lut_conv2d_int8_smallk_smem, mirrored by conv_int8.py::smallk_smem_bytes.

#include "common.cuh"

namespace lut {
namespace q8s {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 64;             // output pixels of a tile (one row segment)
constexpr int kMaxKSteps = 8;       // K padded to 32 per step: K <= 256
constexpr int kGroup = 8;           // 8-column tiles a warp takes at a time (64 columns)
constexpr int kSmemLimit = 232448;  // bytes of shared memory a Hopper block may use

__host__ __device__ __forceinline__ int up(int v, int m) { return (v + m - 1) / m * m; }

struct Layout {
  int KP, N8, HWin, AStride, Stage, WOff, ScOff, BiasOff, TabOff, QOff, AOff, SOff, Smem;
};

// [weights KP*N8][s_x*w_scale N8 f32][bias N8 f32][offset table KP int32]
// [quantized window KH*(64+KW-1)*C][A rows 64 x AStride][8 warp slices of
// 16 x Stage]. A row is KP bytes padded by 16 (so the 8 rows of a fragment
// load fall in distinct banks); a slice row is 64 columns of out_bytes,
// padded by 8 columns (16 or 32 bytes: the 8 rows of a fragment store fall
// in distinct banks).
__host__ __device__ __forceinline__ Layout layout(int KH, int KW, int C, int N, int out_bytes) {
  Layout l;
  l.KP = up(KH * KW * C, 32);
  l.N8 = up(N, 8);
  l.HWin = kTM + KW - 1;
  l.AStride = l.KP + 16;
  l.Stage = (8 * kGroup + 8) * out_bytes;
  l.WOff = 0;
  l.ScOff = l.WOff + l.KP * l.N8;
  l.BiasOff = l.ScOff + 4 * l.N8;
  l.TabOff = l.BiasOff + 4 * l.N8;
  l.QOff = l.TabOff + 4 * l.KP;
  l.AOff = l.QOff + up(KH * l.HWin * C, 16);
  l.SOff = l.AOff + kTM * l.AStride;
  l.Smem = l.SOff + kWarps * 16 * l.Stage;
  return l;
}

struct Args {
  const void* x;         // [B, H, W, C], bf16 or f32
  const int8_t* w;       // pack_weight_smallk
  const void* scale;     // static: 0-d f32 s_x; dynamic: 0-d amax in x's type
  const float* w_scale;  // [N]
  const float* bias;     // [N] or null
  void* y;               // [B, H, W, N]
  int B, H, W, C, KH, KW, N;
  int dynamic;
};

template <typename T>
__device__ __forceinline__ float scale_of(const Args& a) {
  if (!a.dynamic) return *static_cast<const float*>(a.scale);
  const float amax = to_f32(*static_cast<const T*>(a.scale));
  return __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (float)acc for |acc| < 2^22: 1.5 * 2^23 + acc is a float whose bits are
// those of 1.5 * 2^23 plus acc, so one integer add and one exact f32
// subtraction give the conversion I2F would (on the quarter-rate pipe)
__device__ __forceinline__ float exact_float(int acc) {
  return __fsub_rn(__int_as_float(0x4B400000 + acc), 12582912.0f);
}

template <typename TOut>
__device__ __forceinline__ void store_pair(unsigned char* p, float v0, float v1);

template <>
__device__ __forceinline__ void store_pair<float>(unsigned char* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(unsigned char* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// KS1: the reduction is one k step (the flagship's K = 25), so a warp's B
// fragments of a column group fit its registers
template <typename T, typename TOut, bool KS1>
__global__ void __launch_bounds__(kThreads, 2) conv_int8_smallk_kernel(const Args a) {
  constexpr int ob = sizeof(TOut);
  const Layout L = layout(a.KH, a.KW, a.C, a.N, ob);
  extern __shared__ __align__(16) unsigned char smem[];
  const int8_t* w_s = reinterpret_cast<const int8_t*>(smem + L.WOff);
  float* sc_s = reinterpret_cast<float*>(smem + L.ScOff);
  float* bias_s = reinterpret_cast<float*>(smem + L.BiasOff);
  int* tab = reinterpret_cast<int*>(smem + L.TabOff);
  int8_t* q_s = reinterpret_cast<int8_t*>(smem + L.QOff);
  unsigned char* a_s = smem + L.AOff;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int RH = a.KH / 2, RW = a.KW / 2;
  const int kdim = a.KH * a.KW * a.C;
  const int ksteps = KS1 ? 1 : L.KP / 32;
  const int ntiles8 = L.N8 / 8;
  const float s = scale_of<T>(a);
  unsigned char* stage = smem + L.SOff + warp * 16 * L.Stage;

  // once per block: the weights, the per-column scale and bias, the table
  {
    const uint4* src = reinterpret_cast<const uint4*>(a.w);
    uint4* dst = reinterpret_cast<uint4*>(smem + L.WOff);
    for (int i = tid; i < L.KP * L.N8 / 16; i += kThreads) dst[i] = src[i];
    for (int n = tid; n < L.N8; n += kThreads) {
      sc_s[n] = n < a.N ? __fmul_rn(s, a.w_scale[n]) : 0.0f;
      bias_s[n] = (n < a.N && a.bias) ? a.bias[n] : 0.0f;
    }
    for (int k = tid; k < L.KP; k += kThreads) {
      int o = -1;
      if (k < kdim) {
        const int tap = k / a.C, ci = k - tap * a.C;
        const int ky = tap / a.KW, kx = tap - ky * a.KW;
        o = (ky * L.HWin + kx) * a.C + ci;
      }
      tab[k] = o;
    }
  }
  __syncthreads();

  const T* x = static_cast<const T*>(a.x);
  unsigned char* y = static_cast<unsigned char*>(a.y);
  const int nx = (a.W + kTM - 1) / kTM;
  const long long tiles = (long long)nx * a.H * a.B;
  const int wcount = a.KH * L.HWin * a.C;  // bytes of the window
  const int ngroups = (ntiles8 + kGroup - 1) / kGroup;
  const int nitems = (kTM / 16) * ngroups;
  const long long rowb = (long long)a.N * ob;  // bytes of one output row in device memory
  const bool vec = rowb % 16 == 0;

  // the column group whose scales, bias (and B fragments) are in registers
  int cur = -1;
  float2 sc[kGroup], bi[kGroup];
  uint2 bw1[kGroup];

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int x0 = (int)(t % nx) * kTM;
    const int yy = (int)((t / nx) % a.H);
    const int b = (int)(t / ((long long)nx * a.H));
    const int npx = min(kTM, a.W - x0);

    // the quantized window (rows yy - RH .. yy + RH, columns x0 - RW ..), zero
    // outside the frame; consecutive threads read consecutive elements
    const T* xb = x + (long long)b * a.H * a.W * a.C;
    for (int e = tid; e < wcount; e += kThreads) {
      const int ky = e / (L.HWin * a.C);
      const int r = e - ky * L.HWin * a.C;
      const int gy = yy + ky - RH;
      const int gx = x0 - RW + r / a.C;
      int q = 0;
      if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) {
        const float v = to_f32(xb[((long long)gy * a.W + gx) * a.C + r % a.C]);
        q = min(max(__float2int_rn(__fdiv_rn(v, s)), -127), 127);
      }
      q_s[e] = (int8_t)q;
    }
    __syncthreads();  // the window is complete (and the last tile's A rows read)
    // the A rows: byte k of pixel p is the window's byte tab[k] + p * C
    for (int i = tid; i < kTM * L.KP / 4; i += kThreads) {
      const int p = i / (L.KP / 4), k = 4 * (i - p * (L.KP / 4));
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = tab[k + j];
        word |= (o < 0 ? 0u : (uint32_t)(uint8_t)q_s[o + p * a.C]) << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(a_s + p * L.AStride + k) = word;
    }
    __syncthreads();  // the A rows are complete

    for (int item = warp; item < nitems; item += kWarps) {
      const int grp = item % ngroups, mb = item / ngroups;
      if (grp != cur) {  // this group's scales and bias (and B) into registers
        cur = grp;
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const int n = 8 * min(grp * kGroup + j, ntiles8 - 1) + 2 * t4;
          sc[j] = *reinterpret_cast<const float2*>(sc_s + n);
          bi[j] = *reinterpret_cast<const float2*>(bias_s + n);
          if (KS1)
            bw1[j] = *reinterpret_cast<const uint2*>(
                w_s + ((long long)min(grp * kGroup + j, ntiles8 - 1) * 32 + lane) * 8);
        }
      }
      int acc[kGroup][4];
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = 0;
      const unsigned char* arow = a_s + (16 * mb + g) * L.AStride + 4 * t4;
#pragma unroll
      for (int ks = 0; ks < (KS1 ? 1 : kMaxKSteps); ++ks) {
        if (ks < ksteps) {
          uint32_t af[4];
          af[0] = *reinterpret_cast<const uint32_t*>(arow + 32 * ks);
          af[1] = *reinterpret_cast<const uint32_t*>(arow + 8 * L.AStride + 32 * ks);
          af[2] = *reinterpret_cast<const uint32_t*>(arow + 32 * ks + 16);
          af[3] = *reinterpret_cast<const uint32_t*>(arow + 8 * L.AStride + 32 * ks + 16);
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            const int nt = grp * kGroup + j;
            if (nt < ntiles8) {
              const uint2 bw = KS1 ? bw1[j]
                                   : *reinterpret_cast<const uint2*>(
                                         w_s + (((long long)ks * ntiles8 + nt) * 32 + lane) * 8);
              mma_s8(acc[j], af, bw.x, bw.y);
            }
          }
        }
      }
      // the dequant into the warp's slice: rows g (+ 8), columns 8 j + 2 t4, + 1
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v0 = __fmul_rn(exact_float(acc[j][2 * half]), sc[j].x);
          float v1 = __fmul_rn(exact_float(acc[j][2 * half + 1]), sc[j].y);
          if (a.bias) {
            v0 = __fadd_rn(v0, bi[j].x);
            v1 = __fadd_rn(v1, bi[j].y);
          }
          store_pair<TOut>(stage + (g + 8 * half) * L.Stage + (8 * j + 2 * t4) * ob, v0, v1);
        }
      }
      __syncwarp();
      // the slice out: 16 pixels x the group's columns that exist
      const int col0 = grp * kGroup * 8;
      const int cols = min(8 * kGroup, a.N - col0);
      const int p0 = 16 * mb;
      unsigned char* dst = y + ((((long long)b * a.H + yy) * a.W + x0 + p0) * a.N + col0) * ob;
      if (vec) {
        constexpr int kPer = 16 / ob;  // values of a 16-byte piece
        const int pieces = cols / kPer;
        for (int i = lane; i < 16 * pieces; i += 32) {
          const int r = i / pieces, c = i - r * pieces;
          if (p0 + r < npx)
            *reinterpret_cast<uint4*>(dst + r * rowb + 16 * c) =
                *reinterpret_cast<const uint4*>(stage + r * L.Stage + 16 * c);
        }
      } else {
        for (int i = lane; i < 16 * cols; i += 32) {
          const int r = i / cols, c = i - r * cols;
          if (p0 + r < npx)
            *reinterpret_cast<TOut*>(dst + r * rowb + c * ob) =
                *reinterpret_cast<const TOut*>(stage + r * L.Stage + c * ob);
        }
      }
      __syncwarp();  // the slice is free for the next item
    }
  }
}

constexpr int kDevices = 64;        // devices whose launch state is kept
constexpr int kSmPerSm = 233472;    // shared memory of an SM
constexpr int kSmPerBlock = 1024;   // of it reserved for each block

// The SM count of the current device into *sms, read once a device: the
// launch is on the path of every int8 frame, whose host loop is what the
// stream waits for.
static cudaError_t sm_count(int* sms, int* dev) {
  static int cached[kDevices];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < kDevices && cached[*dev] > 0) {
    *sms = cached[*dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err == cudaSuccess && *dev < kDevices) cached[*dev] = *sms;
  return err;
}

template <typename T, typename TOut, bool KS1>
static int launch(const Args& a, cudaStream_t stream) {
  auto kernel = conv_int8_smallk_kernel<T, TOut, KS1>;
  const Layout L = layout(a.KH, a.KW, a.C, a.N, sizeof(TOut));
  if (L.KP > 32 * kMaxKSteps || L.Smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = sm_count(&sms, &dev);
  if (err != cudaSuccess) return (int)err;
  // the largest dynamic shared memory asked for so far, a device
  static int smem_set[kDevices];
  if (dev >= kDevices || L.Smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.Smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kDevices) smem_set[dev] = L.Smem;
  }
  // blocks an SM holds: __launch_bounds__ keeps two in registers, shared
  // memory may allow fewer
  const int fit = kSmPerSm / (L.Smem + kSmPerBlock);
  const int per_sm = fit < 2 ? fit : 2;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (long long)((a.W + kTM - 1) / kTM) * a.H * a.B;
  const long long slots = (long long)sms * per_sm;
  const int grid = (int)(tiles < slots ? tiles : slots);
  kernel<<<grid, kThreads, L.Smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename TOut>
static int dispatch_ks(const Args& a, cudaStream_t s) {
  return up(a.KH * a.KW * a.C, 32) == 32 ? launch<T, TOut, true>(a, s)
                                         : launch<T, TOut, false>(a, s);
}

template <typename T>
static int dispatch_out(const Args& a, int out_dtype, cudaStream_t s) {
  if (out_dtype == kF32) return dispatch_ks<T, float>(a, s);
  if (out_dtype == kBF16) return dispatch_ks<T, __nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace q8s
}  // namespace lut

// Shared-memory bytes of one block for a KH x KW kernel, cin C, N columns and
// output elements of out_bytes (2: bf16, 4: f32); 0 for what it does not take
// (K padded to 32 above 256).
extern "C" long long lut_conv2d_int8_smallk_smem(int KH, int KW, int C, int N, int out_bytes) {
  using namespace lut::q8s;
  if (KH <= 0 || KW <= 0 || C <= 0 || N <= 0 || (out_bytes != 2 && out_bytes != 4)) return 0;
  const Layout L = layout(KH, KW, C, N, out_bytes);
  return L.KP > 32 * kMaxKSteps ? 0 : L.Smem;
}

// x [B,H,W,C] in in_dtype (kF32 or kBF16); w the pack of
// ops/kernels/conv_int8.py::pack_weight_smallk; scale the static 0-d f32 s_x,
// or with dynamic != 0 the 0-d amax = max|x| in in_dtype; w_scale [N] f32,
// bias [N] f32 or null; y [B,H,W,N] in out_dtype. KH, KW odd.
extern "C" int lut_conv2d_int8_smallk(const void* x, const void* w, const void* scale,
                                      int dynamic, const void* w_scale, const void* bias,
                                      void* y, int B, int H, int W, int C, int KH, int KW,
                                      int N, int in_dtype, int out_dtype, void* stream) {
  using namespace lut;
  using namespace lut::q8s;
  Args a;
  a.x = x;
  a.w = static_cast<const int8_t*>(w);
  a.scale = scale;
  a.w_scale = static_cast<const float*>(w_scale);
  a.bias = static_cast<const float*>(bias);
  a.y = y;
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.KH = KH;
  a.KW = KW;
  a.N = N;
  a.dynamic = dynamic;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0 || KH % 2 == 0 || KW % 2 == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kBF16) return dispatch_out<__nv_bfloat16>(a, out_dtype, s);
  if (in_dtype == kF32) return dispatch_out<float>(a, out_dtype, s);
  return (int)cudaErrorInvalidValue;
}
