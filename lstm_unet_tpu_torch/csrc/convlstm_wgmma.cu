// K4, tensor-core route: fused ConvLSTM level in bf16 on wgmma.
//
// Replaces lstm_unet_tpu/ops/pallas/convlstm_cell.py::fused_convlstm_level
// (_kernel) for the bf16 compute dtype. Same function as convlstm_cell.cu:
// the KxK SAME recurrent conv of h [B,H,W,F] (rounded to bf16) with Wh,
// exact products and f32 sums, plus gx [B,H,W,4F], then the gate math; only
// h' and c' are written, in the state dtype (bf16 or f32).
//
// Bound: operations. Flagship level 0 (512^2, F = 128, 5x5) is 0.86 TFLOP
// per frame: 0.87 ms at the H100's 989 TFLOP/s bf16 against ~0.5 GB of
// traffic (0.15 ms). So the conv runs as an implicit GEMM on the tensor
// cores -- M = output pixels, N = 4F gate columns, K = K*K*F (tap x input
// channel) -- and the gate update is its epilogue, in registers.
//
// Design:
//  - a tile is 2 output rows x 64 pixels and 64 features (N = 256 gate
//    columns); each of the two consumer warpgroups owns one row and issues
//    wgmma.m64n256k16 (one row of 64 pixels is one M = 64 tile);
//  - A, no im2col: three producer warps stage the halo'd h tile of one
//    64-channel chunk once, as bf16 in wgmma's no-swizzle K-major layout
//    [C/8][HP][WP][8], so one 8-pixel core matrix is 128 contiguous bytes.
//    Tap (ky, kx) is then the same descriptor with its start moved by
//    (ky*WP + kx)*16 bytes. The tile is double-buffered across chunks
//    (cp.async with zero fill for the frame's SAME padding when h is bf16;
//    loads + rounding when h is f32);
//  - B: ops/kernels/convlstm_cell.py::pack_wh lays Wh out in global memory
//    as contiguous 32 KB [tap, chunk] tiles already in the layout wgmma
//    reads, so one producer thread brings each in with one cp.async.bulk into
//    a ring of 3 stages with full/empty mbarriers, overlapping the loads with
//    wgmma;
//  - the pack orders the N columns in groups of 16 as
//    [i f i f i f i f | g o g o g o g o] over features 16k + n, k = 0..3,
//    so the accumulator fragment (columns 8j + 2(lane%4) + {0,1}) gives each
//    thread i, f, g, o of 16 consecutive features of its two pixels: the
//    epilogue adds gx, runs the gate math (gate_update_fast) and writes h'
//    and c' only; the 4F gates never reach device memory;
//  - persistent: one block per SM walks the tiles, and the producers run
//    ahead into the next tile's h chunk and Wh stages while the consumers
//    run the epilogue. setmaxnreg moves registers from the producer
//    warpgroup (56) to the consumers (224: 128 accumulators + the epilogue's
//    loads), so nothing spills.
// Limits (ops/kernels/convlstm_cell.py::route): F % 64 == 0, K in {1, 3, 5};
// shared memory is 203,088 bytes at K = 5 (lut_convlstm_level_wgmma_smem).

#include "common.cuh"

namespace lut {
namespace tc {

constexpr int kRows = 2;             // output rows per tile, one per consumer warpgroup
constexpr int kCols = 64;            // output pixels per row: one wgmma M tile
constexpr int kFeat = 64;            // features per tile
constexpr int kN = 4 * kFeat;        // gate columns per tile (wgmma N)
constexpr int kTF = kFeat / 4;       // features per consumer thread
constexpr int kChunk = 64;           // input channels per h tile and per Wh stage
constexpr int kGroups = kChunk / 8;  // 16-byte channel groups per chunk
constexpr int kStages = 3;           // Wh ring depth
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kLoaders = 96;                // producer threads that stage h
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kBStage = kChunk * kN * 2;    // bytes of one Wh [tap, chunk] tile
constexpr int kBPlane = kN * 16;            // one channel group of a Wh tile
// a broken pipeline traps (a launch error) instead of hanging the card
constexpr long long kSpinLimit = 1LL << 26;

template <int K>
struct Geom {
  static constexpr int HP = kRows + K - 1;
  static constexpr int WP = kCols + K - 1;
  // one channel group of the h tile; an odd number of 16-byte units, so the
  // 8 groups of one pixel land in distinct banks when the tile is stored
  static constexpr int APlane = ((HP * WP) | 1) * 16;
  static constexpr int ABytes = kGroups * APlane;
  static constexpr int BOff = 0;
  static constexpr int AOff = kStages * kBStage;
  static constexpr int BarOff = AOff + 2 * ABytes;
  static constexpr int Smem = BarOff + (2 * kStages + 4) * 8;
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

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > kSpinLimit) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// one contiguous global -> shared copy on the async proxy, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16-byte cp.async; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// no-swizzle K-major wgmma descriptor: LBO = bytes between the two 8-channel
// core matrices of a k16 step, SBO = bytes between 8-row core matrices
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window
__device__ __forceinline__ void fence_acc(float (&d)[kN / 2]) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64x256] += A[64x16] * B[16x256], both bf16 from shared memory, K-major
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76,"
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91,"
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105,"
      "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118,"
      "%119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
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

// Stage the halo'd h tile of channels [ch*64, ch*64 + 64) as bf16 into the
// [group][HP][WP][8] layout; zero outside the frame. Run by the kLoaders
// producer threads; li is the thread's index among them.
template <typename S, int K>
__device__ __forceinline__ void load_h_tile(const S* __restrict__ hb, uint32_t dst, int H,
                                            int W, int F, int y0, int x0, int ch, int li) {
  using G = Geom<K>;
  constexpr int R = K / 2;
  constexpr int kItems = G::HP * G::WP * kGroups;
  if constexpr (sizeof(S) == 2) {
    for (int i = li; i < kItems; i += kLoaders) {
      const int g = i % kGroups;  // channel group fastest: 128 B runs of one pixel
      const int p = i / kGroups;
      const int y = y0 + p / G::WP - R;
      const int x = x0 + p % G::WP - R;
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
      const S* src = in ? hb + ((long long)y * W + x) * F + ch * kChunk + g * 8 : hb;
      cp_async16(dst + g * G::APlane + p * 16, src, in ? 16 : 0);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
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
          const float* src = hb + ((long long)y * W + x) * F + ch * kChunk + (i % kGroups) * 8;
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
          const uint32_t a = dst + (i % kGroups) * G::APlane + (i / kGroups) * 16;
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(a), "r"(w[0]),
                       "r"(w[1]), "r"(w[2]), "r"(w[3])
                       : "memory");
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
// of row y, features f .. f + 15: the pixel's gx (and bf16 c) loads are all
// issued before its gate math, f32 c 4 features at a time (registers); h'
// and c' are stored 4 features at a time.
template <typename S>
__device__ __forceinline__ void epilogue(float (&acc)[kN / 2],
                                         const __nv_bfloat16* __restrict__ gx,
                                         const S* __restrict__ c, S* __restrict__ h_out,
                                         S* __restrict__ c_out, int b, int y, int x0, int f,
                                         int H, int W, int F, int act) {
  constexpr int kPer = 16 / sizeof(S);  // state values per 16 bytes
  if (y >= H) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int x = x0 + 8 * half;
    if (x < W) {
      const long long pix = ((long long)b * H + y) * W + x;
      uint4 g4[4][kTF / 8], c4[kTF / 8];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
#pragma unroll
        for (int v = 0; v < kTF / 8; ++v)
          g4[gate][v] = load16(gx + pix * 4 * F + gate * F + f + 8 * v);
      if constexpr (kPer == 8) {
#pragma unroll
        for (int v = 0; v < kTF / 8; ++v) c4[v] = load16(c + pix * F + f + 8 * v);
      }
#pragma unroll
      for (int n0 = 0; n0 < kTF; n0 += 4) {
        if constexpr (kPer == 4) c4[0] = load16(c + pix * F + f + n0);
        float hn[4], cn[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int n = n0 + u;
          const __nv_bfloat16* tb = nullptr;
          gate_update_fast(acc[8 * n + 2 * half] + elem(g4[0][n / 8], n % 8, tb),
                           acc[8 * n + 2 * half + 1] + elem(g4[1][n / 8], n % 8, tb),
                           acc[8 * n + 4 + 2 * half] + elem(g4[2][n / 8], n % 8, tb),
                           acc[8 * n + 5 + 2 * half] + elem(g4[3][n / 8], n % 8, tb),
                           elem(c4[kPer == 8 ? n / 8 : 0], n % kPer, c), act, &cn[u], &hn[u]);
        }
        store4(c_out + pix * F + f + n0, cn);
        store4(h_out + pix * F + f + n0, hn);
      }
    }
  }
}

template <typename S, int K>
__global__ void __launch_bounds__(kThreads, 1)
convlstm_wgmma_kernel(const __nv_bfloat16* __restrict__ gx, const S* __restrict__ h,
                      const S* __restrict__ c, const __nv_bfloat16* __restrict__ wpack,
                      S* __restrict__ h_out, S* __restrict__ c_out, int B, int H, int W,
                      int F, int act) {
  using G = Geom<K>;
  constexpr int KK = K * K;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t b_full = sbase + G::BarOff;      // [kStages]
  const uint32_t b_empty = b_full + 8 * kStages;  // [kStages]
  const uint32_t a_full = b_empty + 8 * kStages;  // [2]
  const uint32_t a_empty = a_full + 16;           // [2]

  const int nx = (W + kCols - 1) / kCols;
  const int ny = (H + kRows - 1) / kRows;
  const int ntiles = F / kFeat;
  const int tiles = nx * ny * ntiles * B;
  const int nchunks = F / kChunk;
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
                                     (long long)tl.nt * nchunks * KK * kBStage;
          for (int j = 0; j < nchunks * KK; ++j, ++i) {
            const int s = i % kStages;
            mbar_wait(b_empty + 8 * s, ((i / kStages) & 1) ^ 1);
            mbar_expect_tx(b_full + 8 * s, kBStage);
            bulk_load(sbase + G::BOff + s * kBStage, src + (long long)j * kBStage, kBStage,
                      b_full + 8 * s);
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
          load_h_tile<S, K>(hb, sbase + G::AOff + buf * G::ABytes, H, W, F, tl.y0, tl.x0, ch,
                            li);
          mbar_arrive(a_full + 8 * buf);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    // consumers: warpgroup wg owns output row wg of a tile
    const int wg = warp / 4;
    float acc[kN / 2];
    int it = 0, i = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tl = tile_at(t, nx, ny, ntiles);
#pragma unroll
      for (int j = 0; j < kN / 2; ++j) acc[j] = 0.0f;

      for (int ch = 0; ch < nchunks; ++ch, ++it) {
        const int buf = it & 1;
        mbar_wait(a_full + 8 * buf, (it >> 1) & 1);
        const uint32_t abase = sbase + G::AOff + buf * G::ABytes;
        for (int tap = 0; tap < KK; ++tap, ++i) {
          const int s = i % kStages;
          mbar_wait(b_full + 8 * s, (i / kStages) & 1);
          const uint32_t bbase = sbase + G::BOff + s * kBStage;
          const uint32_t arow = abase + ((wg + tap / K) * G::WP + tap % K) * 16;
          fence_acc(acc);
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < kChunk / 16; ++kk)
            wgmma_m64n256k16(acc, make_desc(arow + 2 * kk * G::APlane, G::APlane, 128),
                             make_desc(bbase + 2 * kk * kBPlane, kBPlane, 128));
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
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(acc);
      if (lane == 0) {  // the producers may fill the next tile's stages now
        mbar_arrive(b_empty + 8 * ((i + kStages - 1) % kStages));
        mbar_arrive(a_empty + 8 * ((it - 1) & 1));
      }
      epilogue<S>(acc, gx, c, h_out, c_out, tl.b, tl.y0 + wg, tl.x0 + 16 * (warp % 4) + lane / 4,
                  tl.nt * kFeat + kTF * (lane % 4), H, W, F, act);
    }
  }
}

template <typename S, int K>
static int launch(const void* gx, const void* h, const void* c, const void* wpack,
                  void* h_out, void* c_out, int B, int H, int W, int F, int act,
                  cudaStream_t stream) {
  auto kernel = convlstm_wgmma_kernel<S, K>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Geom<K>::Smem);
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
                          (F / kFeat) * B;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, Geom<K>::Smem, stream>>>(
      static_cast<const __nv_bfloat16*>(gx), static_cast<const S*>(h),
      static_cast<const S*>(c), static_cast<const __nv_bfloat16*>(wpack),
      static_cast<S*>(h_out), static_cast<S*>(c_out), B, H, W, F, act);
  return (int)cudaGetLastError();
}

template <typename S>
static int dispatch_k(int K, const void* gx, const void* h, const void* c, const void* wpack,
                      void* h_out, void* c_out, int B, int H, int W, int F, int act,
                      cudaStream_t s) {
  switch (K) {
    case 1: return launch<S, 1>(gx, h, c, wpack, h_out, c_out, B, H, W, F, act, s);
    case 3: return launch<S, 3>(gx, h, c, wpack, h_out, c_out, B, H, W, F, act, s);
    case 5: return launch<S, 5>(gx, h, c, wpack, h_out, c_out, B, H, W, F, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace lut

// Shared-memory bytes one block of the tensor-core kernel needs at kernel
// size K (0 for a K it does not take).
extern "C" long long lut_convlstm_level_wgmma_smem(int K) {
  using namespace lut::tc;
  switch (K) {
    case 1: return Geom<1>::Smem;
    case 3: return Geom<3>::Smem;
    case 5: return Geom<5>::Smem;
    default: return 0;
  }
}

// gx [B,H,W,4F] bf16, h/c [B,H,W,F] and the outputs in the state dtype,
// wpack the packed Wh (ops/kernels/convlstm_cell.py::pack_wh); F % 64 == 0.
extern "C" int lut_convlstm_level_wgmma(const void* gx, const void* h, const void* c,
                                        const void* wpack, void* h_out, void* c_out, int B,
                                        int H, int W, int F, int K, int act, int state_dtype,
                                        void* stream) {
  using namespace lut;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F % tc::kChunk != 0) return (int)cudaErrorInvalidValue;
  if (state_dtype == kBF16)
    return tc::dispatch_k<__nv_bfloat16>(K, gx, h, c, wpack, h_out, c_out, B, H, W, F, act, s);
  if (state_dtype == kF32)
    return tc::dispatch_k<float>(K, gx, h, c, wpack, h_out, c_out, B, H, W, F, act, s);
  return (int)cudaErrorInvalidValue;
}
