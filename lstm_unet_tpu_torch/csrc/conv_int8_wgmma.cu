// int8 conv, tensor-core route: a SAME, stride-1 s8 x s8 -> s32 implicit
// GEMM on wgmma that quantizes its float input as it stages it.
//
// Replaces, as conv_int8.cu does, the int8 conv of
// lstm_unet_tpu/ops/quant.py::conv2d_q (the XLA conv of _conv_int8,
// quant.py:91; no pallas_call) with its dequant, and here also the
// activation quantize before it (quantize_act, quant.py:41-56). From x
// [B,H,W,C] in bf16 or f32:
//   s_x = the static 0-d f32 scale, or (dynamic) fmaxf(amax, 1e-8) / 127
//         from the 0-d amax = max|x| (in x's dtype), the reference's order;
//   q   = clamp(rint(x / s_x), -127, 127) as s8: a true division, rounding
//         half to even as jnp.round; SAME padding is q = 0;
//   acc = exact s32 sums over (tap, channel);
//   y   = (float)acc * (s_x * w_scale[n]) + bias[n], each op rounded once in
//         f32 (the add skipped with no bias), then once to the output type.
// conv_int8.cu's epilogue, unchanged. Input and output types are
// independent (the unfused int8 cell's h-conv reads f32 and writes bf16).
//
// Bound: operations at every flagship site but the 1x1 head (e.g. 512^2
// 128 -> 512 5x5: 0.86 TOP at 1979 TOP/s, 0.43 ms, against ~0.34 GB); the
// head (128 -> 3) reads 64 MB of bf16 x: bytes.
//
// Design (K4's bf16 route, csrc/convlstm_wgmma.cu, carried over: a 128-channel
// s8 chunk is 128 bytes a pixel like a 64-channel bf16 chunk, and a k32 s8
// step is 32 bytes of K like a k16 bf16 step):
//  - a tile is 2 * MR output rows x 64 pixels x TN columns (wgmma.m64nTNk32
//    .s32.s8.s8, TN = 256, 128, 64, 32 or 8); each of the two consumer
//    warpgroups owns MR rows, MR M = 64 tiles that share each weight stage;
//  - the tile fits the site (the wrapper chooses it from cout and cin,
//    ops/kernels/conv_int8.py::kernel_tile_n / kernel_chunk, among the
//    configurations of with_tile): TN is the smallest of 8, 32, 64, 128, 256
//    that holds cout (256 split in two where a frame has too few tiles); at
//    TN = 64, 32 and 8 a chunk of the input holds 128, 64 or 32 channels
//    (P = 8, 4 or 2 planes; those with_tile lists), the widest that divides
//    cin rounded up to 32 and fits. So a 32- or 64-column site (the
//    published decoder's last two levels) computes no padded column, and a
//    chunk of cin 32, 64 or 192 (the head's 32 too) no padded k32 product and
//    no padded quantize. At TN = 64 and 32 the accumulators of one
//    128-column tile hold MR = 2 or 4 rows: each weight stage serves more
//    outputs, and the 5x5 halo is quantized 2x or 1.5x, not 3x. TN = 256 and
//    128 keep one row and full 128-channel chunks, as the wide sites (cin %
//    128 == 0) need;
//  - A, no im2col, no int8 tensor in device memory: the loader warps (three
//    at TN = 256, seven at TN <= 128) bring the halo'd x tile of one chunk
//    in by cp.async, in slabs of consecutive pixels through a ring of three
//    (so the loads are in flight without holding the producers' registers),
//    quantize each slab from shared memory and store it once as one plane
//    of 16 bytes a pixel per 16 channels (wgmma's no-swizzle K-major
//    layout), double-buffered across chunks.
//    Tap (ky, kx) is the same descriptor moved by (ky*WP + kx)*16 bytes, so
//    an element is quantized (tile + halo) / tile times: (2 MR + K - 1) /
//    (2 MR) at K x K;
//  - the quantize multiplies by r = 1/s_x (correctly rounded) where that is
//    provably the division's integer: the exact product x*r is within
//    2^-23 |x/s_x| of fl(x / s_x), so rint(x*r) is rint(fl(x / s_x)) unless
//    x*r lies within 2^-14 of a half-integer (|x/s_x| <= 128; beyond, both
//    clamp to +-127). Such values (a few in ten thousand of a bf16
//    activation, more where x and s_x share few significant bits), and all
//    values when r is subnormal, are quantized again with __fdiv_rn: the
//    integers are the division's exactly. The rounding is one FMA with
//    1.5 * 2^23, so a value costs ~7 FP32-pipe instructions and no
//    conversion: the division and F2I/FRND run on the quarter-rate pipes,
//    and the loaders, not the tensor cores, would be the bound;
//  - B: ops/kernels/conv_int8.py::pack_weight_wgmma lays the weights out
//    once, when the model is quantized, as contiguous [column tile, chunk of
//    128, tap] stages of 8 planes x pack_tn columns x 16 bytes, already in
//    the layout wgmma reads; one producer thread brings the planes of a
//    kernel chunk of each stage in with cp.async.bulk (one copy, or one per
//    plane when the kernel's TN is part of the pack's) into a ring with
//    full/empty mbarriers. It walks the stages' addresses with no division:
//    a narrow tile consumes a stage in a few hundred cycles, and the
//    thread's divisions had set the pace of every tile (a ~0.4 us floor a
//    tap with no quantize, product or epilogue at all);
//  - persistent: one block per SM walks the tiles (spatial fastest), and the
//    producers run ahead into the next tile while the consumers run the
//    epilogue, in registers, writing only n < N. setmaxnreg moves registers
//    from the producers to the consumers (Cfg: 96 / 200 at TN = 256, where
//    they hold 128 s32 accumulators; 104 / 152 with two producer
//    warpgroups at TN <= 128, 64 accumulators);
//  - where the input is one chunk a work item is a spatial tile and all its
//    column tiles: the x tile is staged and quantized once and stays in its
//    buffer while the consumers walk the columns (the 512^2 h-conv's 512,
//    the 256^2 x-conv's 1024).
// Shared memory at K = 5, TN = 256, bf16 x: 229,200 bytes (K4's bf16 budget
// of 203,088 + three raw slabs of 32 padded pixels); lut_conv2d_int8_wgmma_smem.
// The largest flagship sum, 127^2 * 9 * 1024, is below 2^31.

#include "common.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace lut {
namespace q8 {

constexpr int kWarpgroups = 2;   // consumer warpgroups; each owns MR rows of a tile
constexpr int kCols = 64;        // output pixels per row: one wgmma M tile
constexpr int kPlanes = 8;       // 16-byte planes of a chunk of the pack (the most a chunk has)
constexpr int kChunk = 128;      // input channels of one chunk of the pack (one byte each)
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kConsumerWarps = kConsumers / 32;

// The block for a tile of TN columns. TN = 256: one producer warpgroup (three
// loader warps and the weight thread's warp) beside consumers that hold 128
// s32 accumulators; TN <= 128: the consumers' 64 accumulators (kRows = MR
// rows of TN / 2, 2 at 64 columns and 4 at 32: measured against 1 and 2 at
// the published decoder's shapes) leave the registers for a second producer
// warpgroup (seven loader
// warps), which the 3x3 and 1x1 sites need: their tiles carry less tensor
// work per quantized value. kStages is the weight ring's depth (96 KB at 256
// and 128 columns).
template <int TN>
struct Cfg {
  static constexpr int kRows = TN == 64 ? 2 : TN == 32 ? 4 : 1;  // MR: M tiles a warpgroup
  static constexpr int kProducerWarps = TN == 256 ? 4 : 8;
  static constexpr int kThreads = kConsumers + 32 * kProducerWarps;
  static constexpr int kLoaders = 32 * (kProducerWarps - 1);  // threads that stage x
  static constexpr int kProducerRegs = TN == 256 ? 96 : 104;
  static constexpr int kConsumerRegs = TN == 256 ? 200 : 152;
  static constexpr int kStages = TN == 256 ? 3 : TN >= 64 ? 6 : 8;
};

constexpr int kRaw = 3;               // slabs of the raw x ring
constexpr int kSmemLimit = 232448;    // bytes of shared memory a Hopper block may use

struct Layout {
  int Rows, HP, WP, APlane, ABytes, BStage, AOff, RawOff, SlabPix, Slab, BarOff, Smem;
};

// shared memory: [stages][P planes][TN][16] weights, then two quantized x
// tiles of [P planes][HP][WP][16] (a plane is an odd number of 16-byte
// units, so the planes of one pixel land in distinct banks), then the raw x
// ring of kRaw slabs of SlabPix pixels (16 KB of x each, 8 KB where that
// does not fit; each pixel padded by 16 bytes, so the pixels one warp reads
// start in distinct banks), then the mbarriers. A tile has 2 * MR output
// rows, a chunk 16 * P channels; xbytes is the size of an element of x.
__host__ __device__ __forceinline__ Layout layout(int K, int TN, int MR, int P, int nstages,
                                                  int xbytes) {
  Layout l;
  l.Rows = kWarpgroups * MR;
  l.HP = l.Rows + K - 1;
  l.WP = kCols + K - 1;
  l.APlane = ((l.HP * l.WP) | 1) * 16;
  l.ABytes = P * l.APlane;
  l.BStage = P * TN * 16;
  l.AOff = nstages * l.BStage;
  l.RawOff = l.AOff + 2 * l.ABytes;
  const int bars = (2 * nstages + 4) * 8;
  const int pix = 16 * P * xbytes;  // raw bytes of one pixel of a chunk
  l.SlabPix = 16384 / pix;
  if (l.RawOff + kRaw * l.SlabPix * (pix + 16) + bars > kSmemLimit) l.SlabPix = 8192 / pix;
  l.Slab = l.SlabPix * (pix + 16);
  l.BarOff = l.RawOff + kRaw * l.Slab;
  l.Smem = l.BarOff + bars;
  return l;
}

struct Args {
  const void* x;         // [B, H, W, C], bf16 or f32
  const int8_t* w;       // pack_weight_wgmma
  const void* scale;     // static: 0-d f32 s_x; dynamic: 0-d amax in x's type
  const float* w_scale;  // [N]
  const float* bias;     // [N] or null
  void* y;               // [B, H, W, N]
  int B, H, W, C, K, N;
  int pack_tn;           // columns of one tile of the pack (a multiple of TN)
  int dynamic;
};

// the work item at index t (nt: its group of column tiles); spatial tiles
// fastest, so the blocks in flight share one column tile's weights in L2
struct Tile {
  int b, nt, y0, x0;
};

__device__ __forceinline__ Tile tile_at(int t, int nx, int ny, int ngroups, int rows) {
  Tile r;
  r.x0 = (t % nx) * kCols;
  t /= nx;
  r.y0 = (t % ny) * rows;
  t /= ny;
  r.nt = t % ngroups;
  r.b = t / ngroups;
  return r;
}

// Column tiles that share one staged x tile (a work item): all of them where
// the input is one chunk (cin <= chunk: the tile stays in its buffer while the
// consumers walk the columns), else one (each chunk's buffer is handed back
// as the next is staged).
__host__ __device__ __forceinline__ int group_of(int N, int pack_tn, int TN, int nchunks) {
  return nchunks == 1 ? (N + pack_tn - 1) / pack_tn * pack_tn / TN : 1;
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define Q8_ACC8(d, i)                                                                   \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),           \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define Q8_ACC_REGS64(d)                                                                \
  Q8_ACC8(d, 0), Q8_ACC8(d, 8), Q8_ACC8(d, 16), Q8_ACC8(d, 24), Q8_ACC8(d, 32),         \
      Q8_ACC8(d, 40), Q8_ACC8(d, 48), Q8_ACC8(d, 56)

// d[64 x TN] += A[64 x 32] * B[32 x TN], s8 from shared memory, K-major
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" LUT_ACC_0_63 ", " LUT_ACC_64_127
      "}, %128, %129, p;\n}\n"
      : Q8_ACC_REGS64(d), Q8_ACC8(d, 64), Q8_ACC8(d, 72), Q8_ACC8(d, 80), Q8_ACC8(d, 88),
        Q8_ACC8(d, 96), Q8_ACC8(d, 104), Q8_ACC8(d, 112), Q8_ACC8(d, 120)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" LUT_ACC_0_63 "}, %64, %65, p;\n}\n"
      : Q8_ACC_REGS64(d)
      : "l"(a), "l"(b), "r"(1));
}

#define Q8_ACC_0_15 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define Q8_ACC_16_31 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" Q8_ACC_0_15 ", " Q8_ACC_16_31
      "}, %32, %33, p;\n}\n"
      : Q8_ACC8(d, 0), Q8_ACC8(d, 8), Q8_ACC8(d, 16), Q8_ACC8(d, 24)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {" Q8_ACC_0_15 "}, %16, %17, p;\n}\n"
      : Q8_ACC8(d, 0), Q8_ACC8(d, 8)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {%0, %1, %2, %3}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

// 16 channels of x as f32 (32 bytes of bf16, 64 of f32)
template <typename T>
struct Vec16 {
  static constexpr int kWords = 16 * sizeof(T) / 16;  // uint4 per 16 channels
  uint4 u[kWords];
};

__device__ __forceinline__ float value(const Vec16<__nv_bfloat16>& v, int e) {
  const uint4& u = v.u[e / 8];
  const int k = (e % 8) / 2;
  const uint32_t w = k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
  return __uint_as_float(e % 2 ? (w & 0xffff0000u) : (w << 16));
}

__device__ __forceinline__ float value(const Vec16<float>& v, int e) {
  const uint4& u = v.u[e / 4];
  const int k = e % 4;
  return __uint_as_float(k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w);
}

// 16 values quantized into 16 bytes (w[0] holds channels 0-3, byte 0 the
// first): t = x * r + 1.5 * 2^23 in one FMA is 1.5 * 2^23 + rint(x * r),
// rounded half to even, for |x * r| < 2^22, and its float bits end in that
// integer's byte once t is clamped to +-127 around 1.5 * 2^23; a second FMA
// gives x * r - rint(x * r) for the check. All on the FP32 pipe. Where any
// value of the item lies near a rounding boundary, or `exact` is set, the
// values concerned are quantized again by the division (see the header); a
// few values in ten thousand of a bf16 activation need it, so the item is
// checked first and each value only then.
template <typename T>
__device__ __forceinline__ void quantize16(const Vec16<T>& v, float s, float r, bool exact,
                                           uint32_t (&w)[4]) {
  constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
  constexpr float kNear = 0.5f - 0x1p-14f;
  bool near = exact;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = value(v, 4 * k + j);
      const float t = __fmaf_rn(x, r, kMagic);
      near |= fabsf(__fmaf_rn(x, r, -__fsub_rn(t, kMagic))) >= kNear;
      b[j] = __float_as_uint(fminf(fmaxf(t, kMagic - 127.0f), kMagic + 127.0f));
    }
    w[k] = __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040),
                       0x5410);
  }
  if (near) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float x = value(v, e);
      const float d = __fmaf_rn(x, r, -__fsub_rn(__fmaf_rn(x, r, kMagic), kMagic));
      if (exact || fabsf(d) >= kNear) {
        const int c = min(max(__float2int_rn(__fdiv_rn(x, s)), -127), 127);
        // byte e % 4 of word e / 4 := c
        w[e / 4] = __byte_perm(w[e / 4], c, e % 4 == 0 ? 0x3214 : e % 4 == 1 ? 0x3240
                                                : e % 4 == 2 ? 0x3410 : 0x4210);
      }
    }
  }
}

template <int kLoaders>
__device__ __forceinline__ void loaders_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kLoaders) : "memory");
}

// Stage the halo'd x tile of the chunk's channels [ch * 16P, ch * 16P + 16P),
// quantized, into [plane][HP][WP][16 bytes] at dst; zero outside the frame
// and past C. The raw x goes through the ring of kRaw slabs (consecutive
// pixels of the tile) by cp.async, so the loads are in flight without
// holding registers; each slab is quantized from shared memory once it has
// landed. Run by the kLoaders producer threads; li is the thread's index
// among them.
template <typename T, int kLoaders, int P>
__device__ __forceinline__ void stage_x(const T* __restrict__ xb, uint32_t dst, uint32_t raw,
                                        const unsigned char* raw_ptr, const Args& a,
                                        const Layout& L, int y0, int x0, int ch, float s,
                                        float r, bool exact, int li) {
  constexpr int kPixBytes = P * 16 * sizeof(T);  // raw bytes of one pixel of a chunk
  constexpr int kPixStride = kPixBytes + 16;     // and their stride in a slab
  constexpr int kPieces = kPixBytes / 16;        // 16-byte pieces of one pixel
  constexpr int kPieceCh = 16 / sizeof(T);       // channels of one piece
  constexpr int kPixStep = kLoaders / kPieces;   // pixels a loader moves on per piece
  const int R = a.K / 2;
  const int npix = L.HP * L.WP;
  const int spx = L.SlabPix;
  const int nslab = (npix + spx - 1) / spx;
  const int c = ch * 16 * P + (li % kPieces) * kPieceCh;  // this loader's channels
  const bool in_c = c < a.C;                               // C % 16 == 0: all or none

  auto issue = [&](int j) {
    const uint32_t buf = raw + (j % kRaw) * L.Slab + (li % kPieces) * 16;
    int p = j * spx + li / kPieces;
    int py = p / L.WP, px = p - py * L.WP;
    // element offset of tile pixel (py, px) in the image, and the pixel's
    // byte offset in the slab, both walked on kPixStep pixels a piece
    long long off = ((long long)(y0 + py - R) * a.W + (x0 + px - R)) * a.C + c;
    uint32_t dst = buf + (li / kPieces) * kPixStride;
    for (int q = li; q < spx * kPieces; q += kLoaders, p += kPixStep) {
      const int y = y0 + py - R, x = x0 + px - R;
      const bool in = in_c && p < npix && y >= 0 && y < a.H && x >= 0 && x < a.W;
      cp_async16(dst, in ? xb + off : xb, in ? 16 : 0);
      dst += kPixStep * kPixStride;
      off += (long long)kPixStep * a.C;
      px += kPixStep;  // WP > kPixStep: at most one wrap
      if (px >= L.WP) {
        px -= L.WP;
        ++py;
        off += (long long)(a.W - L.WP) * a.C;
      }
    }
  };

#pragma unroll
  for (int j = 0; j < kRaw; ++j) {
    if (j < nslab) issue(j);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int j = 0; j < nslab; ++j) {
    asm volatile("cp.async.wait_group %0;" ::"n"(kRaw - 1) : "memory");
    loaders_sync<kLoaders>();  // every loader's pieces of slab j have landed
    const unsigned char* buf = raw_ptr + (j % kRaw) * L.Slab;
    for (int it = li; it < spx * P; it += kLoaders) {
      const int pl = it / P, g = it % P;
      const int p = j * spx + pl;
      if (p < npix) {
        Vec16<T> v;
        const uint4* src = reinterpret_cast<const uint4*>(buf + pl * kPixStride) +
                           g * Vec16<T>::kWords;
#pragma unroll
        for (int k = 0; k < Vec16<T>::kWords; ++k) v.u[k] = src[k];
        uint32_t w[4];
        quantize16(v, s, r, exact, w);
        st_shared16(dst + g * L.APlane + p * 16, w);
      }
    }
    loaders_sync<kLoaders>();  // slab j's buffer is free again
    if (j + kRaw < nslab) issue(j + kRaw);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  // the tile is read by wgmma (the async proxy) after the barrier
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// s_x as the reference forms it
template <typename T>
__device__ __forceinline__ float scale_of(const Args& a) {
  if (!a.dynamic) return *static_cast<const float*>(a.scale);
  const float amax = to_f32(*static_cast<const T*>(a.scale));
  return __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
}

template <typename TOut>
__device__ __forceinline__ void store2(TOut* y, long long idx, float v0, float v1, bool pair);

template <>
__device__ __forceinline__ void store2<float>(float* y, long long idx, float v0, float v1,
                                              bool pair) {
  if (pair) *reinterpret_cast<float2*>(y + idx) = make_float2(v0, v1);
  else y[idx] = v0;
}

template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* y, long long idx,
                                                      float v0, float v1, bool pair) {
  if (pair) *reinterpret_cast<__nv_bfloat162*>(y + idx) = __floats2bfloat162_rn(v0, v1);
  else y[idx] = __float2bfloat16_rn(v0);
}

// The dequant of a consumer thread's fragment: pixels x and x + 8 of row y,
// columns n0 + 8j + 2(lane%4) + {0, 1} at acc[4j + 2 half + {0, 1}].
template <int TN, typename TOut>
__device__ __forceinline__ void epilogue(const int (&acc)[TN / 2], const Args& a, float sx,
                                         int b, int y, int x, int n0) {
  if (y >= a.H) return;
  TOut* out = static_cast<TOut*>(a.y);
  const long long pix = ((long long)b * a.H + y) * a.W + x;
  const bool even = (a.N & 1) == 0;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int n = n0 + 8 * j;
    if (n >= a.N) continue;
    const bool has1 = n + 1 < a.N;
    const float sc0 = __fmul_rn(sx, a.w_scale[n]);
    const float sc1 = has1 ? __fmul_rn(sx, a.w_scale[n + 1]) : 0.0f;
    const float b0 = a.bias ? a.bias[n] : 0.0f;
    const float b1 = (a.bias && has1) ? a.bias[n + 1] : 0.0f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (x + 8 * half >= a.W) continue;
      float v0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * half]), sc0);
      float v1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * half + 1]), sc1);
      if (a.bias) {
        v0 = __fadd_rn(v0, b0);
        v1 = __fadd_rn(v1, b1);
      }
      const long long idx = (pix + 8 * half) * a.N + n;
      if (has1 && even) {
        store2<TOut>(out, idx, v0, v1, true);
      } else {
        store2<TOut>(out, idx, v0, v1, false);
        if (has1) store2<TOut>(out, idx + 1, v1, v1, false);
      }
    }
  }
}

// TN columns (Cfg<TN>::kRows = MR output rows a consumer warpgroup), chunks
// of 16 * P input channels: the tile configuration, fitted to the site by
// the wrapper
template <typename T, typename TOut, int TN, int P>
__global__ void __launch_bounds__(Cfg<TN>::kThreads, 1) conv_int8_wgmma_kernel(const Args a) {
  using C = Cfg<TN>;
  constexpr int MR = C::kRows;
  constexpr int S = C::kStages;
  constexpr int kChunkC = 16 * P;  // input channels of a chunk of the kernel
  const Layout L = layout(a.K, TN, MR, P, S, sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t b_full = sbase + L.BarOff;  // [S]
  const uint32_t b_empty = b_full + 8 * S;   // [S]
  const uint32_t a_full = b_empty + 8 * S;   // [2]
  const uint32_t a_empty = a_full + 16;      // [2]

  const int KK = a.K * a.K;
  const int nx = (a.W + kCols - 1) / kCols;
  const int ny = (a.H + L.Rows - 1) / L.Rows;
  const int nchunks = (a.C + kChunkC - 1) / kChunkC;  // chunks of the kernel
  const int G = group_of(a.N, a.pack_tn, TN, nchunks);
  const int ngroups = (a.N + a.pack_tn - 1) / a.pack_tn * a.pack_tn / TN / G;
  const int tiles = nx * ny * ngroups * a.B;  // work items: a spatial tile and G column tiles
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, kConsumerWarps);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(a_full + 8 * s, C::kLoaders);
      mbar_init(a_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // one if-else that never reconverges, so each side keeps its registers
  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(C::kProducerRegs));
    if (warp == kConsumerWarps + 1) {
      // one thread: the weight stages [chunk, tap] of each of a work item's
      // column tiles, each the P planes of its chunk (contiguous in the
      // pack's stage of 8), addresses walked without a division
      if (lane == 0) {
        const long long plane = (long long)a.pack_tn * 16;  // bytes of a plane of the pack
        const long long stage = kPlanes * plane;            // bytes of a stage of the pack
        const long long column_tile = (long long)(a.C + kChunk - 1) / kChunk * KK * stage;
        int s = 0, phase = 0;  // the ring's slot and the parity of its pass
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          const Tile tl = tile_at(t, nx, ny, ngroups, L.Rows);
          for (int g = 0; g < G; ++g) {
            const int col = (tl.nt * G + g) * TN;
            const int8_t* wt = a.w + col / a.pack_tn * column_tile + (col % a.pack_tn) * 16;
            for (int ch = 0; ch < nchunks; ++ch) {
              const int cc = ch * kChunkC;  // the chunk's first channel
              const int8_t* st = wt + cc / kChunk * KK * stage + (cc % kChunk) / 16 * plane;
              for (int tap = 0; tap < KK; ++tap, st += stage) {
                mbar_wait(b_empty + 8 * s, phase ^ 1);
                mbar_expect_tx(b_full + 8 * s, L.BStage);
                const uint32_t dst = sbase + s * L.BStage;
                if (TN == a.pack_tn) {
                  bulk_load(dst, st, L.BStage, b_full + 8 * s);
                } else {
#pragma unroll
                  for (int p = 0; p < P; ++p)
                    bulk_load(dst + p * TN * 16, st + p * plane, TN * 16, b_full + 8 * s);
                }
                if (++s == S) {
                  s = 0;
                  phase ^= 1;
                }
              }
            }
          }
        }
      }
    } else {
      // the loader warps (three or seven): the quantized x tiles, one per
      // chunk of a work item, double-buffered across chunks and work items
      const int li = threadIdx.x - kConsumers - (warp > kConsumerWarps + 1 ? 32 : 0);
      const float s = scale_of<T>(a);
      const float r = __frcp_rn(s);
      const bool exact = !(r >= 0x1p-126f);  // a subnormal 1/s: divide every value
      const T* x = static_cast<const T*>(a.x);
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = tile_at(t, nx, ny, ngroups, L.Rows);
        const T* xb = x + (long long)tl.b * a.H * a.W * a.C;
        for (int ch = 0; ch < nchunks; ++ch, ++it) {
          const int buf = it & 1;
          mbar_wait(a_empty + 8 * buf, ((it >> 1) & 1) ^ 1);
          stage_x<T, C::kLoaders, P>(xb, sbase + L.AOff + buf * L.ABytes, sbase + L.RawOff,
                                     smem + L.RawOff, a, L, tl.y0, tl.x0, ch, s, r, exact, li);
          mbar_arrive(a_full + 8 * buf);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::kConsumerRegs));
    // consumers: warpgroup wg owns output rows wg * MR .. wg * MR + MR - 1 of
    // a tile, one M tile each, all against the same weight stage
    const int wg = warp / 4;
    const float sx = scale_of<T>(a);
    const uint32_t bplane = TN * 16;
    int acc[MR][TN / 2];
    int it = 0, i = 0;  // x chunks before this work item; weight stages
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tl = tile_at(t, nx, ny, ngroups, L.Rows);
      for (int n = 0; n < G; ++n) {  // the work item's column tiles, one x tile
#pragma unroll
        for (int m = 0; m < MR; ++m)
#pragma unroll
          for (int j = 0; j < TN / 2; ++j) acc[m][j] = 0;
        for (int ch = 0; ch < nchunks; ++ch) {
          const int buf = (it + ch) & 1;
          if (n == 0) mbar_wait(a_full + 8 * buf, ((it + ch) >> 1) & 1);
          const uint32_t abase = sbase + L.AOff + buf * L.ABytes;
          int ky = 0, kx = 0;
          for (int tap = 0; tap < KK; ++tap, ++i) {
            const int s = i % S;
            mbar_wait(b_full + 8 * s, (i / S) & 1);
            const uint32_t bbase = sbase + s * L.BStage;
            const uint32_t arow = abase + ((wg * MR + ky) * L.WP + kx) * 16;
#pragma unroll
            for (int m = 0; m < MR; ++m) fence_acc(acc[m]);
            asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
            for (int kk = 0; kk < P / 2; ++kk) {
              const uint64_t bd = make_desc(bbase + 2 * kk * bplane, bplane, 128);
#pragma unroll
              for (int m = 0; m < MR; ++m)
                wgmma_s8(acc[m],
                         make_desc(arow + m * L.WP * 16 + 2 * kk * L.APlane, L.APlane, 128), bd);
            }
            asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
#pragma unroll
            for (int m = 0; m < MR; ++m) fence_acc(acc[m]);
            // the previous tap's products are done: hand its weight stage
            // back, and at a chunk's first tap the previous chunk's x tile
            // (one arrival per warp, after its own wait)
            asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
            if (lane == 0) {
              if (ch > 0 || tap > 0) mbar_arrive(b_empty + 8 * ((i + S - 1) % S));
              if (ch > 0 && tap == 0) mbar_arrive(a_empty + 8 * (buf ^ 1));
            }
            if (++kx == a.K) {
              kx = 0;
              ++ky;
            }
          }
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
        for (int m = 0; m < MR; ++m) fence_acc(acc[m]);
        if (lane == 0) {  // the producers may fill the next stages now
          mbar_arrive(b_empty + 8 * ((i + S - 1) % S));
          if (n == G - 1) mbar_arrive(a_empty + 8 * ((it + nchunks - 1) & 1));
        }
#pragma unroll
        for (int m = 0; m < MR; ++m)
          epilogue<TN, TOut>(acc[m], a, sx, tl.b, tl.y0 + wg * MR + m,
                             tl.x0 + 16 * (warp % 4) + lane / 4,
                             (tl.nt * G + n) * TN + 2 * (lane % 4));
      }
      it += nchunks;
    }
  }
}

// f(TN, P) for the tile configurations the kernel is compiled for (TN
// columns, P planes a chunk), `other` for another: full chunks at 256 and
// 128 columns; chunks of 128, 64 or 32 channels at 64 columns, 64 or 32 at
// 32 columns (a full chunk of 8 rows does not fit), 128 or 32 at the
// 8-column head
template <typename F>
static int with_tile(int tile_n, int planes, int other, F&& f) {
  using std::integral_constant;
#define Q8_TILE(tn, p) \
  case tn * 16 + p: return f(integral_constant<int, tn>(), integral_constant<int, p>())
  switch (tile_n * 16 + planes) {
    Q8_TILE(256, 8);
    Q8_TILE(128, 8);
    Q8_TILE(64, 8);
    Q8_TILE(64, 4);
    Q8_TILE(64, 2);
    Q8_TILE(32, 4);
    Q8_TILE(32, 2);
    Q8_TILE(8, 8);
    Q8_TILE(8, 2);
    default: return other;
  }
#undef Q8_TILE
}

template <typename T, typename TOut, int TN, int P>
static int launch(const Args& a, cudaStream_t stream) {
  auto kernel = conv_int8_wgmma_kernel<T, TOut, TN, P>;
  using C = Cfg<TN>;
  const int smem = layout(a.K, TN, C::kRows, P, C::kStages, sizeof(T)).Smem;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // setmaxnreg moves registers within the block's allocation: refuse a build
  // whose allocation cannot cover the consumers' raise (it would stall)
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) return (int)err;
  if (fa.numRegs * C::kThreads <
      C::kProducerRegs * 32 * C::kProducerWarps + C::kConsumerRegs * kConsumers)
    return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int rows = kWarpgroups * C::kRows;
  const int nchunks = (a.C + 16 * P - 1) / (16 * P);
  const long long npad = (a.N + a.pack_tn - 1) / a.pack_tn * a.pack_tn;
  const long long tiles = (long long)((a.W + kCols - 1) / kCols) * ((a.H + rows - 1) / rows) *
                          (npad / TN / group_of(a.N, a.pack_tn, TN, nchunks)) * a.B;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, C::kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename TOut>
static int dispatch_tile(const Args& a, int tile_n, int planes, cudaStream_t s) {
  return with_tile(tile_n, planes, (int)cudaErrorInvalidValue, [&](auto tn, auto p) {
    return launch<T, TOut, decltype(tn)::value, decltype(p)::value>(a, s);
  });
}

template <typename T>
static int dispatch_out(const Args& a, int tile_n, int planes, int out_dtype, cudaStream_t s) {
  if (out_dtype == kF32) return dispatch_tile<T, float>(a, tile_n, planes, s);
  if (out_dtype == kBF16) return dispatch_tile<T, __nv_bfloat16>(a, tile_n, planes, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace q8
}  // namespace lut

// Shared-memory bytes of one block at kernel size K, a tile of tile_n columns
// (and its rows), chunks of `chunk` input channels and x elements of xbytes
// (2: bf16, 4: f32); 0 for what the kernel does not take (it refuses a
// launch above 232,448 bytes).
extern "C" long long lut_conv2d_int8_wgmma_smem(int K, int tile_n, int chunk, int xbytes) {
  using namespace lut::q8;
  if ((K != 1 && K != 3 && K != 5) || (xbytes != 2 && xbytes != 4) || chunk % 16 != 0)
    return 0;
  return with_tile(tile_n, chunk / 16, 0, [&](auto tn, auto p) {
    using C = Cfg<decltype(tn)::value>;
    return layout(K, decltype(tn)::value, C::kRows, decltype(p)::value, C::kStages, xbytes).Smem;
  });
}

// x [B,H,W,C] in in_dtype (kF32 or kBF16), C % 16 == 0; w the pack of
// ops/kernels/conv_int8.py::pack_weight_wgmma with pack_tn columns a tile;
// scale the static 0-d f32 s_x, or with dynamic != 0 the 0-d amax = max|x|
// in in_dtype; w_scale [N] f32, bias [N] f32 or null; y [B,H,W,N] in
// out_dtype. K in {1, 3, 5}; tile_n divides pack_tn; (tile_n, chunk) one of
// the configurations of with_tile: tile_n columns, chunks of `chunk` input
// channels.
extern "C" int lut_conv2d_int8_wgmma(const void* x, const void* w, const void* scale,
                                     int dynamic, const void* w_scale, const void* bias,
                                     void* y, int B, int H, int W, int C, int K, int N,
                                     int pack_tn, int tile_n, int chunk, int in_dtype,
                                     int out_dtype, void* stream) {
  using namespace lut;
  using namespace lut::q8;
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
  a.K = K;
  a.N = N;
  a.pack_tn = pack_tn;
  a.dynamic = dynamic;
  const bool pack_ok = pack_tn == 8 || pack_tn == 32 || pack_tn == 64 || pack_tn == 128 ||
                       pack_tn == 256;
  if (!pack_ok || tile_n <= 0 || tile_n > pack_tn || pack_tn % tile_n != 0 || C % 16 != 0 ||
      chunk % 16 != 0 || (K != 1 && K != 3 && K != 5) || B <= 0 || H <= 0 || W <= 0 ||
      C <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kBF16) return dispatch_out<__nv_bfloat16>(a, tile_n, chunk / 16, out_dtype, s);
  if (in_dtype == kF32) return dispatch_out<float>(a, tile_n, chunk / 16, out_dtype, s);
  return (int)cudaErrorInvalidValue;
}
