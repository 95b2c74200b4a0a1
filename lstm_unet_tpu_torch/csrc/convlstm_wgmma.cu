// K4, tensor-core routes: fused ConvLSTM level on wgmma, in bf16 or in f32
// as 3xTF32.
//
// Replaces lstm_unet_tpu/ops/pallas/convlstm_cell.py::fused_convlstm_level
// (_kernel): the KxK SAME recurrent conv of h [B,H,W,F] (rounded to the
// compute dtype) with Wh, exact products and f32 sums, plus gx [B,H,W,4F],
// then the gate math; only h' and c' are written, in the state dtype (bf16
// or f32).
//
// Bound: operations. Flagship level 0 (512^2, F = 128, 5x5) is 0.86 TFLOP
// per frame against ~0.5 GB (bf16) or ~1 GB (f32) of traffic (0.15-0.3 ms).
// bf16: 0.87 ms at the H100's 989 TFLOP/s. f32: the tensor cores have no f32
// mode, and one TF32 product (10-bit mantissas) misses K4's 2e-5 tolerance,
// so each operand is split as x = hi + lo, hi = tf32(x), lo = tf32(x - hi),
// and each product taken as hi*lo + lo*hi + hi*hi (3xTF32; the dropped lo*lo
// and the rounding of lo are ~2^-21 relative): three TF32 products at 495
// TFLOP/s, 5.21 ms at level 0, against 12.8 ms for f32 on the CUDA cores.
// So the conv runs as an implicit GEMM on the tensor cores -- M = output
// pixels, N = 4F gate columns, K = K*K*F (tap x input channel) -- and the
// gate update is its epilogue, in registers.
//
// Design (one kernel, templated on the operand type, Bf16 or Tf32x3):
//  - a tile is 2 output rows x 64 pixels and 64 features (bf16: N = 256
//    gate columns, wgmma.m64n256k16) or 32 features (3xTF32: N = 128,
//    m64n128k8, see Tf32x3 below); each of the two consumer warpgroups owns
//    one row: one row of 64 pixels is one M = 64 tile;
//  - shared memory holds A and B as planes of 16 bytes per pixel or column:
//    8 bf16 or 4 tf32 channels, in wgmma's no-swizzle K-major layout, so one
//    8-pixel core matrix is 128 contiguous bytes. An h tile and a Wh stage
//    are 8 planes each: bf16 takes 64-channel chunks, 3xTF32 16-channel
//    chunks as 4 planes of hi then 4 of lo, so both have the same bytes;
//  - A, no im2col: three producer warps stage the halo'd h tile of one
//    chunk once, [plane][HP][WP][16 bytes]. Tap (ky, kx) is then the same
//    descriptor with its start moved by (ky*WP + kx)*16 bytes. The tile is
//    double-buffered across chunks (bf16: cp.async with zero fill for the
//    frame's SAME padding when h is bf16, loads + rounding when h is f32;
//    3xTF32: loads, then cvt.rna.tf32 to hi and lo);
//  - B: ops/kernels/convlstm_cell.py::pack_wh (bf16) and pack_wh_tf32x3
//    (hi and lo) lay Wh out in global memory as contiguous 32 KB
//    [tap, chunk] tiles already in the layout wgmma reads, so one producer
//    thread brings each in with one cp.async.bulk into a ring of stages
//    (bf16 3 of 32 KB, 3xTF32 6 of 16 KB) with full/empty mbarriers,
//    overlapping the loads with wgmma;
//  - 3xTF32 issues the two cross products before hi*hi, the small terms
//    first; each chunk's products start from zero in the wgmma registers
//    and are then added, rounded, into an f32 sum (Tf32x3 says why);
//  - the packs order the N columns in groups of 16 as
//    [i f i f i f i f | g o g o g o g o] over features 16k + n, k = 0..3,
//    so the accumulator fragment (columns 8j + 2(lane%4) + {0,1}) gives each
//    thread i, f, g, o of N/16 consecutive features of its two pixels: the
//    epilogue adds gx, runs the gate math (gate_update_fast) and writes h'
//    and c' only; the 4F gates never reach device memory;
//  - persistent: one block per SM walks the tiles, and the producers run
//    ahead into the next tile's h chunk and Wh stages while the consumers
//    run the epilogue. setmaxnreg moves registers from the producer
//    warpgroup (56) to the consumers (224: 128 accumulators, or 64 and the
//    64 of the f32 sum, + the epilogue's loads), so nothing spills.
// Limits (ops/kernels/convlstm_cell.py::route): F % 64 == 0, K in {1, 3, 5};
// shared memory at K = 5 is 203,088 bytes (bf16) and 203,136 (3xTF32):
// lut_convlstm_level_wgmma_smem, lut_convlstm_level_tf32x3_smem.

#include "common.cuh"
#include "hopper.cuh"

namespace lut {
namespace tc {

constexpr int kRows = 2;             // output rows per tile, one per consumer warpgroup
constexpr int kCols = 64;            // output pixels per row: one wgmma M tile
constexpr int kPlanes = 8;           // 16-byte planes per h tile and per Wh stage
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kLoaders = 96;                // producer threads that stage h
constexpr int kProducerRegs = 56, kConsumerRegs = 224;

// The operand types: T is gx's and Wh's element type, kVec the channels of
// one 16-byte plane entry, kChunk the input channels of one h tile and one
// Wh stage, kFeat the features of a tile (N = 4 kFeat gate columns), kStages
// the Wh ring's depth, kSplit whether each operand comes as hi and lo planes.
//
// The tensor cores add each k step's products into the accumulator with
// truncation, a bias of up to an ulp of the running sum per step. 3xTF32
// takes six times bf16's k steps (1200 at flagship level 0), enough to miss
// K4's tolerance, so its tile is N = 128: each chunk's k steps (150 at 5x5)
// start from zero in the wgmma registers and are then added, rounded, into
// an f32 sum in 64 more registers per thread.
struct Bf16 {
  using T = __nv_bfloat16;
  static constexpr int kVec = 8, kChunk = 64, kFeat = 64, kStages = 3;
  static constexpr bool kSplit = false;
};
struct Tf32x3 {
  using T = float;
  static constexpr int kVec = 4, kChunk = 16, kFeat = 32, kStages = 6;
  static constexpr bool kSplit = true;
};
static_assert(Bf16::kChunk / Bf16::kVec == kPlanes, "bf16 chunk fills the planes");
static_assert(2 * Tf32x3::kChunk / Tf32x3::kVec == kPlanes, "hi + lo fill the planes");

template <typename Op, int K>
struct Geom {
  static constexpr int N = 4 * Op::kFeat;        // gate columns per tile (wgmma N)
  static constexpr int TF = Op::kFeat / 4;       // features per consumer thread
  static constexpr int BPlane = N * 16;          // one plane of a Wh tile
  static constexpr int BStage = kPlanes * BPlane;  // one Wh [tap, chunk] tile
  static constexpr int HP = kRows + K - 1;
  static constexpr int WP = kCols + K - 1;
  // one plane of the h tile; an odd number of 16-byte units, so the 8
  // planes of one pixel land in distinct banks when the tile is stored
  static constexpr int APlane = ((HP * WP) | 1) * 16;
  static constexpr int ABytes = kPlanes * APlane;
  static constexpr int BOff = 0;
  static constexpr int AOff = Op::kStages * BStage;
  static constexpr int BarOff = AOff + 2 * ABytes;
  static constexpr int Smem = BarOff + (2 * Op::kStages + 4) * 8;
};

// the tile at index t; spatial tiles fastest, so the blocks in flight share
// one column tile's Wh in L2
struct Tile {
  int b, nt, y0, x0;
};

__device__ __forceinline__ Tile tile_at(int t, int nx, int ny, int ntiles) {
  Tile r;
  r.x0 = (t % nx) * kCols;
  t /= nx;
  r.y0 = (t % ny) * kRows;
  t /= ny;
  r.nt = t % ntiles;
  r.b = t / ntiles;
  return r;
}

// x rounded to TF32 (10-bit mantissa), to nearest with ties away from zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the accumulator constraints of an m64n128 (64) or m64n256 (128) wgmma
#define LUT_ACC8(d, i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define LUT_ACC_REGS64(d)                                                               \
  LUT_ACC8(d, 0), LUT_ACC8(d, 8), LUT_ACC8(d, 16), LUT_ACC8(d, 24), LUT_ACC8(d, 32),    \
      LUT_ACC8(d, 40), LUT_ACC8(d, 48), LUT_ACC8(d, 56)
#define LUT_ACC_REGS128(d)                                                              \
  LUT_ACC_REGS64(d), LUT_ACC8(d, 64), LUT_ACC8(d, 72), LUT_ACC8(d, 80), LUT_ACC8(d, 88), \
      LUT_ACC8(d, 96), LUT_ACC8(d, 104), LUT_ACC8(d, 112), LUT_ACC8(d, 120)

// d[64x256] += A[64x16] * B[16x256], both bf16 from shared memory, K-major
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" LUT_ACC_0_63 ", " LUT_ACC_64_127
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : LUT_ACC_REGS128(d)
      : "l"(a), "l"(b), "r"(1));
}

// d[64x128] = A[64x8] * B[8x128] (+ d if accumulate), both tf32 from shared
// memory, K-major
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" LUT_ACC_0_63
      "}, %64, %65, p, 1, 1;\n}\n"
      : LUT_ACC_REGS64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// One tap of one chunk: A at arow (the tap's shifted h tile), B at bbase
// (its Wh stage). Each k step reads two planes of A and of B. 3xTF32 issues
// the two cross products before hi*hi, the small terms first; its first
// product overwrites the accumulators unless accumulate.
template <typename Op, int K>
__device__ __forceinline__ void mma_tap(float (&acc)[2 * Op::kFeat], uint32_t arow,
                                        uint32_t bbase, int accumulate) {
  using G = Geom<Op, K>;
  constexpr int AP = G::APlane, BP = G::BPlane;
  if constexpr (!Op::kSplit) {
#pragma unroll
    for (int kk = 0; kk < kPlanes / 2; ++kk)
      wgmma_bf16(acc, make_desc(arow + 2 * kk * AP, AP, 128),
                 make_desc(bbase + 2 * kk * BP, BP, 128));
  } else {
    constexpr int kLo = kPlanes / 2;  // the lo planes follow the hi planes
#pragma unroll
    for (int kk = 0; kk < kLo / 2; ++kk) {
      const uint32_t ah = arow + 2 * kk * AP, bh = bbase + 2 * kk * BP;
      const uint64_t a_hi = make_desc(ah, AP, 128), a_lo = make_desc(ah + kLo * AP, AP, 128);
      const uint64_t b_hi = make_desc(bh, BP, 128), b_lo = make_desc(bh + kLo * BP, BP, 128);
      wgmma_tf32(acc, a_hi, b_lo, kk > 0 || accumulate);
      wgmma_tf32(acc, a_lo, b_hi, 1);
      wgmma_tf32(acc, a_hi, b_hi, 1);
    }
  }
}

__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// element n of 16 bytes holding 8 bf16 or 4 f32 (the pointer only picks the type)
__device__ __forceinline__ float elem(const uint4& u, int n, const __nv_bfloat16*) {
  const uint32_t w = word(u, n / 2);
  return __uint_as_float(n % 2 ? (w & 0xffff0000u) : (w << 16));
}
__device__ __forceinline__ float elem(const uint4& u, int n, const float*) {
  return __uint_as_float(word(u, n));
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// four consecutive values as f32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const uint4 u = load16(p);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = elem(u, e, p);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Stage the halo'd h tile of channels [ch*kChunk, ch*kChunk + kChunk) into
// the [plane][HP][WP][16 bytes] layout; zero outside the frame. Run by the
// kLoaders producer threads; li is the thread's index among them.
template <typename Op, typename S, int K>
__device__ __forceinline__ void load_h_tile(const S* __restrict__ hb, uint32_t dst, int H,
                                            int W, int F, int y0, int x0, int ch, int li) {
  using G = Geom<Op, K>;
  constexpr int R = K / 2;
  constexpr int kGroups = Op::kChunk / Op::kVec;  // channel groups of one chunk
  constexpr int kItems = G::HP * G::WP * kGroups;
  if constexpr (!Op::kSplit && sizeof(S) == 2) {
    for (int i = li; i < kItems; i += kLoaders) {
      const int g = i % kGroups;  // channel group fastest: 128 B runs of one pixel
      const int p = i / kGroups;
      const int y = y0 + p / G::WP - R;
      const int x = x0 + p % G::WP - R;
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
      const S* src = in ? hb + ((long long)y * W + x) * F + ch * Op::kChunk + g * 8 : hb;
      cp_async16(dst + g * G::APlane + p * 16, src, in ? 16 : 0);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else if constexpr (!Op::kSplit) {
    constexpr int kBatch = 2;  // 32-byte items in flight per thread (producer registers)
    for (int i0 = li; i0 < kItems; i0 += kLoaders * kBatch) {
      uint4 v[kBatch][2];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + kLoaders * u;
        const int p = i / kGroups;
        const int y = y0 + p / G::WP - R;
        const int x = x0 + p % G::WP - R;
        if (i < kItems && y >= 0 && y < H && x >= 0 && x < W) {
          const float* src =
              hb + ((long long)y * W + x) * F + ch * Op::kChunk + (i % kGroups) * 8;
          v[u][0] = load16(src);
          v[u][1] = load16(src + 4);
        } else {
          v[u][0] = v[u][1] = make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + kLoaders * u;
        if (i < kItems) {
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const __nv_bfloat162 t = __floats2bfloat162_rn(
                elem(v[u][e / 2], 2 * (e % 2), (const float*)nullptr),
                elem(v[u][e / 2], 2 * (e % 2) + 1, (const float*)nullptr));
            w[e] = *reinterpret_cast<const uint32_t*>(&t);
          }
          st_shared16(dst + (i % kGroups) * G::APlane + (i / kGroups) * 16, w);
        }
      }
    }
  } else {
    // 3xTF32: 4 channels per item, stored as hi = tf32(x) in plane g and
    // lo = tf32(x - hi) in plane g + kGroups
    constexpr int kBatch = 4;  // 16-byte items in flight per thread (producer registers)
    for (int i0 = li; i0 < kItems; i0 += kLoaders * kBatch) {
      float v[kBatch][4];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + kLoaders * u;
        const int p = i / kGroups;
        const int y = y0 + p / G::WP - R;
        const int x = x0 + p % G::WP - R;
        if (i < kItems && y >= 0 && y < H && x >= 0 && x < W) {
          load4(hb + ((long long)y * W + x) * F + ch * Op::kChunk + (i % kGroups) * 4, v[u]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[u][e] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + kLoaders * u;
        if (i < kItems) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hi[e] = to_tf32(v[u][e]);
            lo[e] = to_tf32(__fsub_rn(v[u][e], __uint_as_float(hi[e])));
          }
          const uint32_t a = dst + (i % kGroups) * G::APlane + (i / kGroups) * 16;
          st_shared16(a, hi);
          st_shared16(a + kGroups * G::APlane, lo);
        }
      }
    }
  }
  // the tile is read by wgmma (the async proxy) after the barrier
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The gate math of common.cuh's gate_update with the sigmoid and tanh on
// the fast exponential (ex2.approx, a few ulp) and an approximate division.
// The epilogue is the part of a tile the tensor cores wait for, and the
// exact expf, tanhf and division are most of its instructions. Against the
// exact formulas this moves h' and c' by ~1e-6, inside K4's tolerance.
__device__ __forceinline__ float fast_act(float x, int act) {
  if (act == kSigmoid) return __fdividef(1.0f, 1.0f + __expf(-x));
  return recurrent_act(x, act);
}

__device__ __forceinline__ float fast_tanh(float x) {
  return __fdividef(2.0f, 1.0f + __expf(-2.0f * x)) - 1.0f;
}

__device__ __forceinline__ void gate_update_fast(float zi, float zf, float zg, float zo,
                                                 float c, int act, float* c_new,
                                                 float* h_new) {
  const float i = fast_act(zi, act);
  const float f = fast_act(zf, act);
  const float o = fast_act(zo, act);
  const float cn = __fadd_rn(__fmul_rn(f, c), __fmul_rn(i, fast_tanh(zg)));
  *c_new = cn;
  *h_new = __fmul_rn(o, fast_tanh(cn));
}

// Gate update of the consumer thread's two pixels (16wl + lane/4 and 8 more)
// of row y, features f .. f + TF - 1, from the gate sums z: the fragment of
// an m64nN accumulator gives the thread columns 8j + 2(lane%4) + {0,1} of
// both pixels, i and f of feature f + n at j = 2n, g and o at j = 2n + 1. In
// batches of 32 bytes of gx per gate (16 bf16 or 8 f32 features): the
// batch's gx (and bf16 c) loads are all issued before its gate math, f32 c
// 4 features at a time (registers); h' and c' are stored 4 features at a
// time.
template <int TF, typename T, typename S>
__device__ __forceinline__ void epilogue(const float (&z)[8 * TF], const T* __restrict__ gx,
                                         const S* __restrict__ c, S* __restrict__ h_out,
                                         S* __restrict__ c_out, int b, int y, int x0, int f,
                                         int H, int W, int F, int act) {
  constexpr int kGV = 16 / sizeof(T);   // gx values per 16 bytes
  constexpr int kBatchF = 2 * kGV;      // features per batch
  constexpr int kPer = 16 / sizeof(S);  // state values per 16 bytes
  static_assert(TF % kBatchF == 0, "whole batches");
  if (y >= H) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int x = x0 + 8 * half;
    if (x < W) {
      const long long pix = ((long long)b * H + y) * W + x;
#pragma unroll
      for (int f0 = 0; f0 < TF; f0 += kBatchF) {
        uint4 g4[4][2], c4[2];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
#pragma unroll
          for (int v = 0; v < 2; ++v)
            g4[gate][v] = load16(gx + pix * 4 * F + gate * F + f + f0 + kGV * v);
        if constexpr (kPer == 8) {
#pragma unroll
          for (int v = 0; v < kBatchF / 8; ++v) c4[v] = load16(c + pix * F + f + f0 + 8 * v);
        }
#pragma unroll
        for (int n0 = 0; n0 < kBatchF; n0 += 4) {
          if constexpr (kPer == 4) c4[0] = load16(c + pix * F + f + f0 + n0);
          float hn[4], cn[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int n = n0 + u;  // feature within the batch
            const int a = 8 * (f0 + n) + 2 * half;
            gate_update_fast(z[a] + elem(g4[0][n / kGV], n % kGV, gx),
                             z[a + 1] + elem(g4[1][n / kGV], n % kGV, gx),
                             z[a + 4] + elem(g4[2][n / kGV], n % kGV, gx),
                             z[a + 5] + elem(g4[3][n / kGV], n % kGV, gx),
                             elem(c4[kPer == 8 ? n / 8 : 0], n % kPer, c), act, &cn[u],
                             &hn[u]);
          }
          store4(c_out + pix * F + f + f0 + n0, cn);
          store4(h_out + pix * F + f + f0 + n0, hn);
        }
      }
    }
  }
}

template <typename Op, typename S, int K>
__global__ void __launch_bounds__(kThreads, 1)
convlstm_wgmma_kernel(const typename Op::T* __restrict__ gx, const S* __restrict__ h,
                      const S* __restrict__ c, const typename Op::T* __restrict__ wpack,
                      S* __restrict__ h_out, S* __restrict__ c_out, int B, int H, int W,
                      int F, int act) {
  using G = Geom<Op, K>;
  constexpr int KK = K * K;
  constexpr int kStages = Op::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t b_full = sbase + G::BarOff;      // [kStages]
  const uint32_t b_empty = b_full + 8 * kStages;  // [kStages]
  const uint32_t a_full = b_empty + 8 * kStages;  // [2]
  const uint32_t a_empty = a_full + 16;           // [2]

  const int nx = (W + kCols - 1) / kCols;
  const int ny = (H + kRows - 1) / kRows;
  const int ntiles = F / Op::kFeat;
  const int tiles = nx * ny * ntiles * B;
  const int nchunks = F / Op::kChunk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps + 1) {
      // one thread: the Wh tiles [tap, chunk] of each tile's columns
      if (lane == 0) {
        int i = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          const Tile tl = tile_at(t, nx, ny, ntiles);
          const unsigned char* src = reinterpret_cast<const unsigned char*>(wpack) +
                                     (long long)tl.nt * nchunks * KK * G::BStage;
          for (int j = 0; j < nchunks * KK; ++j, ++i) {
            const int s = i % kStages;
            mbar_wait(b_empty + 8 * s, ((i / kStages) & 1) ^ 1);
            mbar_expect_tx(b_full + 8 * s, G::BStage);
            bulk_load(sbase + G::BOff + s * G::BStage, src + (long long)j * G::BStage,
                      G::BStage, b_full + 8 * s);
          }
        }
      }
    } else {
      // three warps: the h tiles, one per chunk, double-buffered across
      // chunks and tiles
      const int li = threadIdx.x - kConsumers - (warp > kConsumerWarps + 1 ? 32 : 0);
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = tile_at(t, nx, ny, ntiles);
        const S* hb = h + (long long)tl.b * H * W * F;
        for (int ch = 0; ch < nchunks; ++ch, ++it) {
          const int buf = it & 1;
          mbar_wait(a_empty + 8 * buf, ((it >> 1) & 1) ^ 1);
          load_h_tile<Op, S, K>(hb, sbase + G::AOff + buf * G::ABytes, H, W, F, tl.y0, tl.x0,
                                ch, li);
          mbar_arrive(a_full + 8 * buf);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    // consumers: warpgroup wg owns output row wg of a tile
    const int wg = warp / 4;
    float acc[G::N / 2];
    float sum[Op::kSplit ? G::N / 2 : 1];  // 3xTF32: the f32 sum of the chunks
    int it = 0, i = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tl = tile_at(t, nx, ny, ntiles);
#pragma unroll
      for (int j = 0; j < G::N / 2; ++j) {
        if constexpr (Op::kSplit) sum[j] = 0.0f;
        else acc[j] = 0.0f;
      }

      for (int ch = 0; ch < nchunks; ++ch, ++it) {
        const int buf = it & 1;
        mbar_wait(a_full + 8 * buf, (it >> 1) & 1);
        const uint32_t abase = sbase + G::AOff + buf * G::ABytes;
        for (int tap = 0; tap < KK; ++tap, ++i) {
          const int s = i % kStages;
          mbar_wait(b_full + 8 * s, (i / kStages) & 1);
          const uint32_t bbase = sbase + G::BOff + s * G::BStage;
          const uint32_t arow = abase + ((wg + tap / K) * G::WP + tap % K) * 16;
          fence_acc(acc);
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
          mma_tap<Op, K>(acc, arow, bbase, !Op::kSplit || tap > 0);
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          fence_acc(acc);
          // the previous tap's products are done: hand its Wh stage back,
          // and at a chunk's first tap the previous chunk's h tile (one
          // arrival per warp, after its own wait)
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
          if (lane == 0) {
            if (ch > 0 || tap > 0) mbar_arrive(b_empty + 8 * ((i + kStages - 1) % kStages));
            if (ch > 0 && tap == 0) mbar_arrive(a_empty + 8 * (buf ^ 1));
          }
        }
        if constexpr (Op::kSplit) {  // the chunk's sums, rounded, into the f32 sum
          asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
          fence_acc(acc);
#pragma unroll
          for (int j = 0; j < G::N / 2; ++j) sum[j] = __fadd_rn(sum[j], acc[j]);
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(acc);
      if (lane == 0) {  // the producers may fill the next tile's stages now
        mbar_arrive(b_empty + 8 * ((i + kStages - 1) % kStages));
        mbar_arrive(a_empty + 8 * ((it - 1) & 1));
      }
      const int y = tl.y0 + wg, x = tl.x0 + 16 * (warp % 4) + lane / 4;
      const int f = tl.nt * Op::kFeat + G::TF * (lane % 4);
      if constexpr (Op::kSplit)
        epilogue<G::TF>(sum, gx, c, h_out, c_out, tl.b, y, x, f, H, W, F, act);
      else
        epilogue<G::TF>(acc, gx, c, h_out, c_out, tl.b, y, x, f, H, W, F, act);
    }
  }
}

template <typename Op, typename S, int K>
static int launch(const void* gx, const void* h, const void* c, const void* wpack,
                  void* h_out, void* c_out, int B, int H, int W, int F, int act,
                  cudaStream_t stream) {
  using T = typename Op::T;
  auto kernel = convlstm_wgmma_kernel<Op, S, K>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Geom<Op, K>::Smem);
  if (err != cudaSuccess) return (int)err;
  // setmaxnreg moves registers within the block's allocation: refuse a build
  // whose allocation cannot cover the consumers' raise (it would stall)
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) return (int)err;
  if (fa.numRegs * kThreads < kProducerRegs * 128 + kConsumerRegs * kConsumers)
    return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long tiles = (long long)((W + kCols - 1) / kCols) * ((H + kRows - 1) / kRows) *
                          (F / Op::kFeat) * B;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, Geom<Op, K>::Smem, stream>>>(
      static_cast<const T*>(gx), static_cast<const S*>(h), static_cast<const S*>(c),
      static_cast<const T*>(wpack), static_cast<S*>(h_out), static_cast<S*>(c_out), B, H, W,
      F, act);
  return (int)cudaGetLastError();
}

template <typename Op, typename S>
static int dispatch_k(int K, const void* gx, const void* h, const void* c, const void* wpack,
                      void* h_out, void* c_out, int B, int H, int W, int F, int act,
                      cudaStream_t s) {
  switch (K) {
    case 1: return launch<Op, S, 1>(gx, h, c, wpack, h_out, c_out, B, H, W, F, act, s);
    case 3: return launch<Op, S, 3>(gx, h, c, wpack, h_out, c_out, B, H, W, F, act, s);
    case 5: return launch<Op, S, 5>(gx, h, c, wpack, h_out, c_out, B, H, W, F, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Op>
static int dispatch(const void* gx, const void* h, const void* c, const void* wpack,
                    void* h_out, void* c_out, int B, int H, int W, int F, int K, int act,
                    int state_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F % Op::kFeat != 0 || F % Op::kChunk != 0) return (int)cudaErrorInvalidValue;
  if (state_dtype == kBF16)
    return dispatch_k<Op, __nv_bfloat16>(K, gx, h, c, wpack, h_out, c_out, B, H, W, F, act, s);
  if (state_dtype == kF32)
    return dispatch_k<Op, float>(K, gx, h, c, wpack, h_out, c_out, B, H, W, F, act, s);
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes of one block at kernel size K (0 for a K it does not
// take).
template <typename Op>
static long long smem_bytes(int K) {
  switch (K) {
    case 1: return Geom<Op, 1>::Smem;
    case 3: return Geom<Op, 3>::Smem;
    case 5: return Geom<Op, 5>::Smem;
    default: return 0;
  }
}

}  // namespace tc
}  // namespace lut

extern "C" long long lut_convlstm_level_wgmma_smem(int K) {
  return lut::tc::smem_bytes<lut::tc::Bf16>(K);
}
extern "C" long long lut_convlstm_level_tf32x3_smem(int K) {
  return lut::tc::smem_bytes<lut::tc::Tf32x3>(K);
}

// bf16: gx [B,H,W,4F] bf16, h/c [B,H,W,F] and the outputs in the state
// dtype, wpack the packed Wh (ops/kernels/convlstm_cell.py::pack_wh);
// F % 64 == 0.
extern "C" int lut_convlstm_level_wgmma(const void* gx, const void* h, const void* c,
                                        const void* wpack, void* h_out, void* c_out, int B,
                                        int H, int W, int F, int K, int act, int state_dtype,
                                        void* stream) {
  return lut::tc::dispatch<lut::tc::Bf16>(gx, h, c, wpack, h_out, c_out, B, H, W, F, K, act,
                                          state_dtype, stream);
}

// 3xTF32: gx f32, wpack the hi/lo packed Wh (pack_wh_tf32x3); otherwise as
// lut_convlstm_level_wgmma.
extern "C" int lut_convlstm_level_tf32x3(const void* gx, const void* h, const void* c,
                                         const void* wpack, void* h_out, void* c_out, int B,
                                         int H, int W, int F, int K, int act, int state_dtype,
                                         void* stream) {
  return lut::tc::dispatch<lut::tc::Tf32x3>(gx, h, c, wpack, h_out, c_out, B, H, W, F, K, act,
                                            state_dtype, stream);
}
