// K4, narrow-level route: fused ConvLSTM level on wgmma for the levels the
// 64-feature tiles of convlstm_wgmma.cu do not take: F not a multiple of 64
// (the tiny model's F = 8 and 16, F = 24, 32, 96, ...) and 7x7 kernels, in
// bf16 or in f32 as 3xTF32.
//
// Replaces lstm_unet_tpu/ops/pallas/convlstm_cell.py::fused_convlstm_level
// (_kernel) at those levels. Same function: the KxK SAME recurrent conv of h [B,H,W,F] (rounded to the
// compute dtype) with Wh, exact products and f32 sums, plus gx [B,H,W,4F],
// then the gate math; only h' and c' are written, in the state dtype.
//
// Bound: operations at every 512^2 level it was built for (e.g. F = 32, 5x5:
// 54 GFLOP against 134 MB of bf16 traffic; 0.054 ms at 989 TFLOP/s bf16,
// 0.33 ms as 3xTF32 at 495); the tiny model's 32^2 levels are bound by the
// cost of a launch. One feature a lane of a 32-feature slice on the f32
// CUDA cores would leave 24 of 32 lanes idle at F = 8 and need 20 shared
// loads per 64 FMAs. Here:
//  - a tile is R output rows x 64 pixels x FT features, FT = 32, 16 or 8
//    (the largest that divides F): N = 4 FT gate columns, one
//    wgmma.m64nNk16 (bf16) or m64nNk8 (tf32) per row, tap and k step; each
//    of the two consumer warpgroups owns R / 2 rows (bf16: R = 4, two M
//    tiles, so each Wh stage brought in feeds twice the products: at these
//    narrow N a one-row tile would spend as many bytes of Wh from L2 per
//    product as the flagship's 64-feature tile; 3xTF32: R = 2, its f32 sum
//    takes the registers); every lane holds FT / 4 features;
//  - input channels in chunks of the instruction's k: 16 (bf16, 2 planes of
//    8 channels) or 8 (3xTF32, 2 planes of 4 as hi and 2 as lo); a chunk
//    past F (F = 8, 24 in bf16) is zero-filled while it is staged, never in
//    device memory;
//  - A, no im2col: three producer warps stage the halo'd h tile of a chunk
//    ([plane][HP][WP][16 bytes], tap (ky, kx) the same descriptor moved by
//    (ky*WP + kx)*16 bytes) by cp.async, double-buffered across chunks and
//    tiles; mbarriers hand it to the consumers;
//  - B: ops/kernels/convlstm_cell.py::pack_wh_narrow (bf16) and
//    pack_wh_narrow_tf32x3 (hi and lo) lay Wh out as [column tile, chunk,
//    tap] blocks in the layout wgmma reads, so a stage -- the K taps of one
//    kernel row of one chunk -- is one contiguous cp.async.bulk into a ring
//    of up to 4 stages with full / empty mbarriers (the ring's depth is what
//    fits beside the two h tiles: 2 at 7x7 in 3xTF32 with 32-feature tiles);
//  - 3xTF32 as in convlstm_wgmma.cu: hi*lo + lo*hi + hi*hi, each chunk's
//    products from zero in the wgmma registers, then added, rounded, into an
//    f32 sum (the tensor cores truncate as they accumulate; a chunk is at
//    most 49 taps x 3 products, as many as the flagship's 25 x 2 x 3);
//  - the packs order the N columns in groups of 16 as [i f i f i f i f |
//    g o g o g o g o] (pack_wh's trick), so one thread holds i, f, g and o
//    of its FT / 4 features for its two pixels: the epilogue adds gx, runs
//    the gate math (on the fast exponential, as convlstm_wgmma.cu's) and
//    writes h' and c' only;
//  - persistent: one block per SM walks the tiles (spatial fastest), the
//    producers run ahead into the next tile while the consumers run the
//    epilogue, whose gx and c lines each consumer thread asks into L2 when
//    its tile starts; at FT = 32 (64 accumulators, and 64 more for the 3xTF32 sum)
//    setmaxnreg moves registers to the consumers (56 / 224, as
//    convlstm_wgmma.cu); narrower tiles fit the even split.
// Limits (ops/kernels/convlstm_cell.py::route): F % 8 == 0, K in {1, 3, 5,
// 7}, any B, H, W; shared memory by lut_convlstm_level_narrow_smem, mirrored
// by convlstm_cell.py::narrow_smem_bytes.

#include "common.cuh"
#include "hopper.cuh"

namespace lut {
namespace nw {

constexpr int kCols = 64;            // output pixels per row: one wgmma M tile
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kLoaders = 96;                // producer threads that stage h
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a Hopper block may use

// The operand types: T is gx's and Wh's element type, kVec the channels of
// one 16-byte plane entry, kChunk the input channels of one h tile and one
// Wh block (the instruction's k), kPlanes the planes of one (hi and lo for
// 3xTF32), kMT the M tiles (output rows) of each consumer warpgroup.
struct Bf16 {
  using T = __nv_bfloat16;
  static constexpr int kVec = 8, kChunk = 16, kPlanes = 2, kMT = 2;
  static constexpr bool kSplit = false;
};
struct Tf32x3 {
  using T = float;
  static constexpr int kVec = 4, kChunk = 8, kPlanes = 4, kMT = 1;
  static constexpr bool kSplit = true;
};

// Shared memory: [S stages of K taps x planes x N x 16 bytes][2 h tiles of
// planes x APlane][mbarriers: 2 kMaxStages + 4]. APlane (HP*WP 16-byte
// units) is odd, so the planes of one pixel land in distinct banks. S is the
// largest of 4 .. 1 that fits.
struct Layout {
  int HP, WP, APlane, ABytes, BPlane, BStage, S, AOff, BarOff, Smem;
};

// rows: output rows of a tile (2 kMT)
__host__ __device__ __forceinline__ Layout layout(int K, int N, int planes, int rows) {
  Layout l;
  l.HP = rows + K - 1;
  l.WP = kCols + K - 1;
  l.APlane = ((l.HP * l.WP) | 1) * 16;
  l.ABytes = planes * l.APlane;
  l.BPlane = N * 16;
  l.BStage = K * planes * l.BPlane;
  const int bars = (2 * kMaxStages + 4) * 8;
  l.S = kMaxStages;
  while (l.S > 1 && l.S * l.BStage + 2 * l.ABytes + bars > kSmemLimit) --l.S;
  l.AOff = l.S * l.BStage;
  l.BarOff = l.AOff + 2 * l.ABytes;
  l.Smem = l.BarOff + bars;
  return l;
}

struct Tile {
  int b, nt, y0, x0;
};

__device__ __forceinline__ Tile tile_at(int t, int nx, int ny, int ntiles, int rows) {
  Tile r;
  r.x0 = (t % nx) * kCols;
  t /= nx;
  r.y0 = (t % ny) * rows;
  t /= ny;
  r.nt = t % ntiles;
  r.b = t / ntiles;
  return r;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define NW_ACC8(d, i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define NW_ACC16(d) NW_ACC8(d, 0), NW_ACC8(d, 8)
#define NW_ACC32(d) NW_ACC16(d), NW_ACC8(d, 16), NW_ACC8(d, 24)
#define NW_ACC64(d) NW_ACC32(d), NW_ACC8(d, 32), NW_ACC8(d, 40), NW_ACC8(d, 48), NW_ACC8(d, 56)
#define NW_ACC_0_15 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define NW_ACC_16_31 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"

// d[64 x N] (+)= A * B from shared memory, K-major; bf16 k16 or tf32 k8.
// scale_d = 0 overwrites d (3xTF32's first product of a chunk).
__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t a, uint64_t b, int scale_d,
                                      Bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" NW_ACC_0_15
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : NW_ACC16(d)
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b, int scale_d,
                                      Bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" NW_ACC_0_15 ", " NW_ACC_16_31
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : NW_ACC32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b, int scale_d,
                                      Bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" LUT_ACC_0_63
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : NW_ACC64(d)
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t a, uint64_t b, int scale_d,
                                      Tf32x3) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" NW_ACC_0_15
      "}, %16, %17, p, 1, 1;\n}\n"
      : NW_ACC16(d)
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b, int scale_d,
                                      Tf32x3) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" NW_ACC_0_15 ", " NW_ACC_16_31
      "}, %32, %33, p, 1, 1;\n}\n"
      : NW_ACC32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b, int scale_d,
                                      Tf32x3) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" LUT_ACC_0_63
      "}, %64, %65, p, 1, 1;\n}\n"
      : NW_ACC64(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// The products of one tap: A at arow (the tap's shifted h tile), B at btap
// (the tap's block of the stage). bf16: one k16 step over the chunk's two
// planes; 3xTF32: the k8 step as hi*lo + lo*hi + hi*hi (small terms first),
// the first overwriting the accumulators unless accumulate.
template <typename Op, int NA>
__device__ __forceinline__ void mma_tap(float (&acc)[NA], uint32_t arow, uint32_t btap,
                                        int aplane, int bplane, int accumulate) {
  if constexpr (!Op::kSplit) {
    wgmma(acc, make_desc(arow, aplane, 128), make_desc(btap, bplane, 128), 1, Op());
  } else {
    const uint64_t a_hi = make_desc(arow, aplane, 128);
    const uint64_t a_lo = make_desc(arow + 2 * aplane, aplane, 128);
    const uint64_t b_hi = make_desc(btap, bplane, 128);
    const uint64_t b_lo = make_desc(btap + 2 * bplane, bplane, 128);
    wgmma(acc, a_hi, b_lo, accumulate, Op());
    wgmma(acc, a_lo, b_hi, 1, Op());
    wgmma(acc, a_hi, b_hi, 1, Op());
  }
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// n consecutive values as f32 (n * sizeof(T) bytes: 4, 8, 16 or 32)
template <int n>
__device__ __forceinline__ void loadv(const float* p, float (&v)[n]) {
  if constexpr (n == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x;
    v[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < n; i += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + i);
      v[i] = u.x;
      v[i + 1] = u.y;
      v[i + 2] = u.z;
      v[i + 3] = u.w;
    }
  }
}
template <int n>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float (&v)[n]) {
  uint32_t w[n / 2];
  if constexpr (n == 2) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (n == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else {
    const uint4 u = load16(p);
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  }
#pragma unroll
  for (int i = 0; i < n / 2; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <int n>
__device__ __forceinline__ void storev(float* p, const float (&v)[n]) {
  if constexpr (n == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < n; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}
template <int n>
__device__ __forceinline__ void storev(__nv_bfloat16* p, const float (&v)[n]) {
  uint32_t w[n / 2];
#pragma unroll
  for (int i = 0; i < n / 2; ++i) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&t);
  }
  if constexpr (n == 2) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else if constexpr (n == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Stage the halo'd h tile of channels [ch*kChunk, ch*kChunk + kChunk) into
// [plane][HP][WP][16 bytes]; zero outside the frame and past F. Run by the
// kLoaders producer threads; li is the thread's index among them.
template <typename Op, int kChunk, typename S>
__device__ __forceinline__ void load_h_tile(const S* __restrict__ hb, uint32_t dst,
                                            const Layout& L, int H, int W, int F, int K,
                                            int y0, int x0, int ch, int li) {
  const int R = K / 2;
  constexpr int kGroups = kChunk / Op::kVec;  // channel groups of one chunk
  const int items = L.HP * L.WP * kGroups;
  if constexpr (!Op::kSplit && sizeof(S) == 2) {
    for (int i = li; i < items; i += kLoaders) {
      const int g = i % kGroups;
      const int p = i / kGroups;
      const int y = y0 + p / L.WP - R;
      const int x = x0 + p % L.WP - R;
      const int c = ch * kChunk + g * 8;
      const bool in = y >= 0 && y < H && x >= 0 && x < W && c < F;
      const S* src = in ? hb + ((long long)y * W + x) * F + c : hb;
      cp_async16(dst + g * L.APlane + p * 16, src, in ? 16 : 0);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else if constexpr (!Op::kSplit) {
    // f32 state, bf16 compute: 8 channels loaded and rounded per item
    for (int i = li; i < items; i += kLoaders) {
      const int g = i % kGroups;
      const int p = i / kGroups;
      const int y = y0 + p / L.WP - R;
      const int x = x0 + p % L.WP - R;
      const int c = ch * kChunk + g * 8;
      float v[8];
      if (y >= 0 && y < H && x >= 0 && x < W && c < F) {
        loadv<8>(reinterpret_cast<const float*>(hb) + ((long long)y * W + x) * F + c, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.0f;
      }
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 t = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        w[e] = *reinterpret_cast<const uint32_t*>(&t);
      }
      st_shared16(dst + g * L.APlane + p * 16, w);
    }
  } else {
    // 3xTF32: 4 channels per item, stored as hi = tf32(x) in plane g and
    // lo = tf32(x - hi) in plane g + 2 (F % 8 == 0: a chunk is all in F)
    for (int i = li; i < items; i += kLoaders) {
      const int g = i % kGroups;
      const int p = i / kGroups;
      const int y = y0 + p / L.WP - R;
      const int x = x0 + p % L.WP - R;
      float v[4];
      if (y >= 0 && y < H && x >= 0 && x < W) {
        loadv<4>(hb + ((long long)y * W + x) * F + ch * kChunk + g * 4, v);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = 0.0f;
      }
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = to_tf32(v[e]);
        lo[e] = to_tf32(__fsub_rn(v[e], __uint_as_float(hi[e])));
      }
      const uint32_t a = dst + g * L.APlane + p * 16;
      st_shared16(a, hi);
      st_shared16(a + kGroups * L.APlane, lo);
    }
  }
  // the tile is read by wgmma (the async proxy) after the barrier
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Bring the gx and c lines of the thread's epilogue (its two pixels of row
// y, features f .. f + TF - 1) into L2 while the tile's products run, so the
// epilogue's loads wait for L2, not device memory.
template <int TF, typename T, typename S>
__device__ __forceinline__ void prefetch_epilogue(const T* __restrict__ gx,
                                                  const S* __restrict__ c, int b, int y,
                                                  int x0, int f, int H, int W, int F) {
  if (y >= H) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int x = x0 + 8 * half;
    if (x < W) {
      const long long pix = ((long long)b * H + y) * W + x;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) prefetch_l2(gx + pix * 4 * F + gate * F + f);
      prefetch_l2(c + pix * F + f);
    }
  }
}

// The gate math of common.cuh's gate_update on the fast exponential, as
// convlstm_wgmma.cu's epilogue runs it (h' and c' move by ~1e-6).
__device__ __forceinline__ float fast_act(float x, int act) {
  if (act == kSigmoid) return __fdividef(1.0f, 1.0f + __expf(-x));
  return recurrent_act(x, act);
}

__device__ __forceinline__ float fast_tanh(float x) {
  return __fdividef(2.0f, 1.0f + __expf(-2.0f * x)) - 1.0f;
}

// Gate update of the consumer thread's two pixels (16wl + lane/4 and 8 more)
// of row y, features f .. f + TF - 1: the fragment gives the thread columns
// 8j + 2(lane%4) + {0,1} of both pixels, i and f of feature f + u at
// j = 2u, g and o at j = 2u + 1.
template <int TF, typename T, typename S>
__device__ __forceinline__ void epilogue(const float (&z)[8 * TF], const T* __restrict__ gx,
                                         const S* __restrict__ c, S* __restrict__ h_out,
                                         S* __restrict__ c_out, int b, int y, int x0, int f,
                                         int H, int W, int F, int act) {
  if (y >= H) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int x = x0 + 8 * half;
    if (x < W) {
      const long long pix = ((long long)b * H + y) * W + x;
      float gi[TF], gf[TF], gg[TF], go[TF], cv[TF], hn[TF], cn[TF];
      loadv<TF>(gx + pix * 4 * F + f, gi);
      loadv<TF>(gx + pix * 4 * F + F + f, gf);
      loadv<TF>(gx + pix * 4 * F + 2 * F + f, gg);
      loadv<TF>(gx + pix * 4 * F + 3 * F + f, go);
      loadv<TF>(c + pix * F + f, cv);
#pragma unroll
      for (int u = 0; u < TF; ++u) {
        const int a = 8 * u + 2 * half;
        const float i = fast_act(z[a] + gi[u], act);
        const float fg = fast_act(z[a + 1] + gf[u], act);
        const float o = fast_act(z[a + 5] + go[u], act);
        cn[u] = __fadd_rn(__fmul_rn(fg, cv[u]), __fmul_rn(i, fast_tanh(z[a + 4] + gg[u])));
        hn[u] = __fmul_rn(o, fast_tanh(cn[u]));
      }
      storev<TF>(c_out + pix * F + f, cn);
      storev<TF>(h_out + pix * F + f, hn);
    }
  }
}

// K is a template parameter, so the loop over a kernel row's taps unrolls.
template <typename Op, typename S, int FT, int K>
__global__ void __launch_bounds__(kThreads, 1)
convlstm_narrow_kernel(const typename Op::T* __restrict__ gx, const S* __restrict__ h,
                       const S* __restrict__ c, const typename Op::T* __restrict__ wpack,
                       S* __restrict__ h_out, S* __restrict__ c_out, int B, int H, int W,
                       int F, int act) {
  constexpr int N = 4 * FT;     // gate columns of a tile
  constexpr int NA = N / 2;     // accumulators per consumer thread
  constexpr int TF = FT / 4;    // features per consumer thread
  constexpr bool kRebalance = FT == 32;  // setmaxnreg (see the header)
  constexpr int MT = Op::kMT;
  constexpr int kRows = 2 * MT;  // output rows of a tile
  const Layout L = layout(K, N, Op::kPlanes, kRows);
  const int S_ = L.S;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t b_full = sbase + L.BarOff;       // [S]
  const uint32_t b_empty = b_full + 8 * kMaxStages;  // [S]
  const uint32_t a_full = b_empty + 8 * kMaxStages;  // [2]
  const uint32_t a_empty = a_full + 16;              // [2]

  const int nx = (W + kCols - 1) / kCols;
  const int ny = (H + kRows - 1) / kRows;
  const int ntiles = F / FT;
  const int tiles = nx * ny * ntiles * B;
  const int nchunks = (F + Op::kChunk - 1) / Op::kChunk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S_; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, kConsumerWarps);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(a_full + 8 * s, kLoaders);
      mbar_init(a_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // one if-else that never reconverges, so each side keeps its registers
  if (warp >= kConsumerWarps) {
    if constexpr (kRebalance)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps + 1) {
      // one thread: the Wh stages [chunk, kernel row] of each tile's columns
      if (lane == 0) {
        int i = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          const Tile tl = tile_at(t, nx, ny, ntiles, kRows);
          const unsigned char* src = reinterpret_cast<const unsigned char*>(wpack) +
                                     (long long)tl.nt * nchunks * K * L.BStage;
          for (int j = 0; j < nchunks * K; ++j, ++i) {
            const int s = i % S_;
            mbar_wait(b_empty + 8 * s, ((i / S_) & 1) ^ 1);
            mbar_expect_tx(b_full + 8 * s, L.BStage);
            bulk_load(sbase + s * L.BStage, src + (long long)j * L.BStage, L.BStage,
                      b_full + 8 * s);
          }
        }
      }
    } else {
      // three warps: the h tiles, one per chunk, double-buffered
      const int li = threadIdx.x - kConsumers - (warp > kConsumerWarps + 1 ? 32 : 0);
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = tile_at(t, nx, ny, ntiles, kRows);
        const S* hb = h + (long long)tl.b * H * W * F;
        for (int ch = 0; ch < nchunks; ++ch, ++it) {
          const int buf = it & 1;
          mbar_wait(a_empty + 8 * buf, ((it >> 1) & 1) ^ 1);
          load_h_tile<Op, Op::kChunk, S>(hb, sbase + L.AOff + buf * L.ABytes, L, H, W, F, K,
                                         tl.y0, tl.x0, ch, li);
          mbar_arrive(a_full + 8 * buf);
        }
      }
    }
  } else {
    if constexpr (kRebalance)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    // consumers: warpgroup wg owns output rows MT wg .. MT wg + MT - 1 of a
    // tile, one M tile (and accumulator set) each
    const int wg = warp / 4;
    const int tap_bytes = Op::kPlanes * L.BPlane;  // one tap's block of a stage
    float acc[MT][NA];
    float sum[Op::kSplit ? NA : 1];  // 3xTF32 (MT = 1): the f32 sum of the chunks
    int it = 0, i = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tl = tile_at(t, nx, ny, ntiles, kRows);
      const int x = tl.x0 + 16 * (warp % 4) + lane / 4;
      const int f = tl.nt * FT + TF * (lane % 4);
#pragma unroll
      for (int m = 0; m < MT; ++m)
        prefetch_epilogue<TF>(gx, c, tl.b, tl.y0 + MT * wg + m, x, f, H, W, F);
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        if constexpr (Op::kSplit) {
          sum[j] = 0.0f;
        } else {
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[m][j] = 0.0f;
        }
      }
      for (int ch = 0; ch < nchunks; ++ch, ++it) {
        const int buf = it & 1;
        mbar_wait(a_full + 8 * buf, (it >> 1) & 1);
        const uint32_t abase = sbase + L.AOff + buf * L.ABytes;
        for (int ky = 0; ky < K; ++ky, ++i) {
          const int s = i % S_;
          mbar_wait(b_full + 8 * s, (i / S_) & 1);
          const uint32_t bbase = sbase + s * L.BStage;
          const uint32_t arow = abase + (MT * wg + ky) * L.WP * 16;
#pragma unroll
          for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
#pragma unroll
            for (int m = 0; m < MT; ++m)
              mma_tap<Op>(acc[m], arow + (m * L.WP + kx) * 16, bbase + kx * tap_bytes, L.APlane,
                          L.BPlane, !Op::kSplit || ky > 0 || kx > 0);
          }
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
#pragma unroll
          for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
          // the previous stage's products are done: hand it back, and at a
          // chunk's first stage the previous chunk's h tile (one arrival
          // per warp, after its own wait)
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
          if (lane == 0) {
            if (ch > 0 || ky > 0) mbar_arrive(b_empty + 8 * ((i + S_ - 1) % S_));
            if (ch > 0 && ky == 0) mbar_arrive(a_empty + 8 * (buf ^ 1));
          }
        }
        if constexpr (Op::kSplit) {  // the chunk's sums, rounded, into the f32 sum
          asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
          fence_acc(acc[0]);
#pragma unroll
          for (int j = 0; j < NA; ++j) sum[j] = __fadd_rn(sum[j], acc[0][j]);
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
      if (lane == 0) {  // the producers may fill the next tile's stages now
        mbar_arrive(b_empty + 8 * ((i + S_ - 1) % S_));
        mbar_arrive(a_empty + 8 * ((it - 1) & 1));
      }
      if constexpr (Op::kSplit) {
        epilogue<TF>(sum, gx, c, h_out, c_out, tl.b, tl.y0 + wg, x, f, H, W, F, act);
      } else {
#pragma unroll
        for (int m = 0; m < MT; ++m)
          epilogue<TF>(acc[m], gx, c, h_out, c_out, tl.b, tl.y0 + MT * wg + m, x, f, H, W, F,
                       act);
      }
    }
  }
}

constexpr int kDevices = 64;  // devices whose launch state is kept

// The SM count of the current device into *sms, read once a device (the
// tiny model's levels are bound by the cost of a launch).
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

template <typename Op, typename S, int FT, int K>
static int launch(const void* gx, const void* h, const void* c, const void* wpack,
                  void* h_out, void* c_out, int B, int H, int W, int F, int act,
                  cudaStream_t stream) {
  using T = typename Op::T;
  auto kernel = convlstm_narrow_kernel<Op, S, FT, K>;
  const Layout L = layout(K, 4 * FT, Op::kPlanes, 2 * Op::kMT);
  if (L.Smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = sm_count(&sms, &dev);
  if (err != cudaSuccess) return (int)err;
  static bool ready[kDevices];  // the attribute set and the registers checked, a device
  if (dev >= kDevices || !ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.Smem);
    if (err != cudaSuccess) return (int)err;
    // setmaxnreg moves registers within the block's allocation: refuse a
    // build whose allocation cannot cover the consumers' raise (it would
    // stall)
    cudaFuncAttributes fa;
    if ((err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) return (int)err;
    if (FT == 32 && fa.numRegs * kThreads < kProducerRegs * 128 + kConsumerRegs * kConsumers)
      return (int)cudaErrorInvalidConfiguration;
    if (dev < kDevices) ready[dev] = true;
  }
  const int rows = 2 * Op::kMT;
  const long long tiles = (long long)((W + kCols - 1) / kCols) * ((H + rows - 1) / rows) *
                          (F / FT) * B;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, L.Smem, stream>>>(
      static_cast<const T*>(gx), static_cast<const S*>(h), static_cast<const S*>(c),
      static_cast<const T*>(wpack), static_cast<S*>(h_out), static_cast<S*>(c_out), B, H, W,
      F, act);
  return (int)cudaGetLastError();
}

template <typename Op, typename S, int FT>
static int dispatch_k(const void* gx, const void* h, const void* c, const void* wpack,
                      void* h_out, void* c_out, int B, int H, int W, int F, int K, int act,
                      cudaStream_t s) {
  switch (K) {
    case 1: return launch<Op, S, FT, 1>(gx, h, c, wpack, h_out, c_out, B, H, W, F, act, s);
    case 3: return launch<Op, S, FT, 3>(gx, h, c, wpack, h_out, c_out, B, H, W, F, act, s);
    case 5: return launch<Op, S, FT, 5>(gx, h, c, wpack, h_out, c_out, B, H, W, F, act, s);
    case 7: return launch<Op, S, FT, 7>(gx, h, c, wpack, h_out, c_out, B, H, W, F, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Op, typename S>
static int dispatch_ft(const void* gx, const void* h, const void* c, const void* wpack,
                       void* h_out, void* c_out, int B, int H, int W, int F, int K, int FT,
                       int act, cudaStream_t s) {
  switch (FT) {
    case 8: return dispatch_k<Op, S, 8>(gx, h, c, wpack, h_out, c_out, B, H, W, F, K, act, s);
    case 16: return dispatch_k<Op, S, 16>(gx, h, c, wpack, h_out, c_out, B, H, W, F, K, act, s);
    case 32: return dispatch_k<Op, S, 32>(gx, h, c, wpack, h_out, c_out, B, H, W, F, K, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Op>
static int dispatch(const void* gx, const void* h, const void* c, const void* wpack,
                    void* h_out, void* c_out, int B, int H, int W, int F, int K, int FT,
                    int act, int state_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F % 8 != 0 || FT <= 0 || F % FT != 0 || (K != 1 && K != 3 && K != 5 && K != 7) ||
      B <= 0 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  if (state_dtype == kBF16)
    return dispatch_ft<Op, __nv_bfloat16>(gx, h, c, wpack, h_out, c_out, B, H, W, F, K, FT,
                                          act, s);
  if (state_dtype == kF32)
    return dispatch_ft<Op, float>(gx, h, c, wpack, h_out, c_out, B, H, W, F, K, FT, act, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace nw
}  // namespace lut

// Shared-memory bytes of one block at kernel size K, feature tile FT and
// compute dtype (kBF16, or kF32 for 3xTF32); 0 for what it does not take.
extern "C" long long lut_convlstm_level_narrow_smem(int K, int FT, int compute_dtype) {
  using namespace lut;
  using namespace lut::nw;
  if ((K != 1 && K != 3 && K != 5 && K != 7) || (FT != 8 && FT != 16 && FT != 32)) return 0;
  if (compute_dtype != kBF16 && compute_dtype != kF32) return 0;
  const Layout L = compute_dtype == kBF16
                       ? layout(K, 4 * FT, Bf16::kPlanes, 2 * Bf16::kMT)
                       : layout(K, 4 * FT, Tf32x3::kPlanes, 2 * Tf32x3::kMT);
  return L.Smem > kSmemLimit ? 0 : L.Smem;
}

// gx [B,H,W,4F] in the compute dtype (kBF16: bf16 operands; kF32: 3xTF32),
// h/c [B,H,W,F] and the outputs in the state dtype; wpack the packed Wh
// (ops/kernels/convlstm_cell.py::pack_wh_narrow or pack_wh_narrow_tf32x3)
// with feature tiles of FT; F % 8 == 0, FT in {8, 16, 32} dividing F.
extern "C" int lut_convlstm_level_narrow(const void* gx, const void* h, const void* c,
                                         const void* wpack, void* h_out, void* c_out, int B,
                                         int H, int W, int F, int K, int FT, int act,
                                         int compute_dtype, int state_dtype, void* stream) {
  using namespace lut;
  using namespace lut::nw;
  if (compute_dtype == kBF16)
    return dispatch<Bf16>(gx, h, c, wpack, h_out, c_out, B, H, W, F, K, FT, act, state_dtype,
                          stream);
  if (compute_dtype == kF32)
    return dispatch<Tf32x3>(gx, h, c, wpack, h_out, c_out, B, H, W, F, K, FT, act,
                            state_dtype, stream);
  return (int)cudaErrorInvalidValue;
}
