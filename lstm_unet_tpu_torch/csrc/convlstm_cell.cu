// K4: fused ConvLSTM level, inference.
//
// Replaces lstm_unet_tpu/ops/pallas/convlstm_cell.py::fused_convlstm_level
// (_kernel). Computes the KxK SAME recurrent conv of h [B,H,W,F] with
// Wh [K,K,F,4F] in f32, adds gx [B,H,W,4F] (x-conv + bias, computed outside),
// applies the gate math and writes only h' and c'. The 4F gates never reach
// device memory.
//
// Bound: arithmetic. Flagship level 0 is 2*512^2*(25*128)*512 = 0.86 TFLOP
// per frame against ~0.5 GB of traffic, far above the card's balance point;
// this first kernel runs it on the f32 SIMT units (no tensor cores yet).
// Design:
//  - a block owns an 8 x 16 tile of output pixels and a slice of 32 features;
//    warp w owns tile row w, lane l owns feature f0 + l and keeps the i, f,
//    g, o accumulators of its feature for the warp's 16 pixels in registers
//    (64 f32), so the gate epilogue needs no exchange between threads;
//  - the halo'd h tile for ALL F input channels is staged once in shared
//    memory (as f32, after rounding h to the compute dtype), so h is read
//    from device memory once per block;
//  - Wh is staged in chunks of 4 input channels (all K*K taps, 4 gates x 32
//    features); inside a chunk each h value is a warp-wide broadcast and each
//    weight a conflict-free 32-lane read, feeding 64 FMAs per 20 loads.
// The shared-memory budget (h tile + one Wh chunk <= 227 KB) is what
// ops/kernels/convlstm_cell.py::supported checks: F = 128 at K = 5 fits,
// F = 256 does not, and those levels take the plain conv + K1 path.
// wgmma/TMA implicit GEMM is the planned next step.

#include "common.cuh"

namespace lut {

constexpr int kTileH = 8;    // output rows per block, one warp each
constexpr int kTileW = 16;   // output columns per block, all in each thread
constexpr int kFeat = 32;    // features per block, one per lane
constexpr int kChunk = 4;    // input channels per staged Wh chunk
constexpr int kThreads = kTileH * 32;

template <typename T, typename S, int K>
__global__ void __launch_bounds__(kThreads)
convlstm_level_kernel(const T* __restrict__ gx, const S* __restrict__ h,
                      const S* __restrict__ c, const T* __restrict__ wh,
                      S* __restrict__ h_out, S* __restrict__ c_out, int H,
                      int W, int F, int act) {
  constexpr int HP = kTileH + K - 1;
  constexpr int WP = kTileW + K - 1;
  constexpr int R = K / 2;
  extern __shared__ float smem[];
  float* hs = smem;                   // [F][HP][WP]
  float* ws = smem + (size_t)F * HP * WP;  // [K*K][kChunk][4][kFeat]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int nslices = (F + kFeat - 1) / kFeat;
  const int b = blockIdx.z / nslices;
  const int f0 = (blockIdx.z % nslices) * kFeat;

  // halo'd h tile, zero outside the frame (SAME padding); channel fastest in
  // device memory, so consecutive threads read consecutive addresses
  const S* hb = h + (long long)b * H * W * F;
  for (int i = tid; i < HP * WP * F; i += kThreads) {
    const int ci = i % F;
    const int p = i / F;
    const int px = p % WP;
    const int py = p / WP;
    const int y = y0 + py - R;
    const int x = x0 + px - R;
    float v = 0.0f;
    if (y >= 0 && y < H && x >= 0 && x < W)
      v = to_f32(from_f32<T>(to_f32(hb[((long long)y * W + x) * F + ci])));
    hs[(ci * HP + py) * WP + px] = v;
  }

  float acc[kTileW][4];
#pragma unroll
  for (int p = 0; p < kTileW; ++p)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[p][g] = 0.0f;

  for (int c0 = 0; c0 < F; c0 += kChunk) {
    __syncthreads();  // h tile staged / previous chunk consumed
    for (int i = tid; i < K * K * kChunk * 4 * kFeat; i += kThreads) {
      const int fl = i % kFeat;
      int r = i / kFeat;
      const int g = r % 4;
      r /= 4;
      const int cl = r % kChunk;
      const int tap = r / kChunk;
      const int ci = c0 + cl;
      const int f = f0 + fl;
      float v = 0.0f;
      if (ci < F && f < F) v = to_f32(wh[((long long)tap * F + ci) * 4 * F + g * F + f]);
      ws[i] = v;
    }
    __syncthreads();
    const int nc = min(kChunk, F - c0);
    for (int cl = 0; cl < nc; ++cl) {
      const float* hrow = hs + ((c0 + cl) * HP + warp) * WP;
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const float* wp = ws + (((ky * K + kx) * kChunk + cl) * 4) * kFeat + lane;
          const float w0 = wp[0];
          const float w1 = wp[kFeat];
          const float w2 = wp[2 * kFeat];
          const float w3 = wp[3 * kFeat];
          const float* hp = hrow + ky * WP + kx;
#pragma unroll
          for (int p = 0; p < kTileW; ++p) {
            const float v = hp[p];
            acc[p][0] = fmaf(v, w0, acc[p][0]);
            acc[p][1] = fmaf(v, w1, acc[p][1]);
            acc[p][2] = fmaf(v, w2, acc[p][2]);
            acc[p][3] = fmaf(v, w3, acc[p][3]);
          }
        }
      }
    }
  }

  const int f = f0 + lane;
  const int y = y0 + warp;
  if (f >= F || y >= H) return;
#pragma unroll
  for (int p = 0; p < kTileW; ++p) {
    const int x = x0 + p;
    if (x < W) {
      const long long pix = ((long long)b * H + y) * W + x;
      const T* g = gx + pix * 4 * F + f;
      float cn, hn;
      gate_update(acc[p][0] + to_f32(g[0]), acc[p][1] + to_f32(g[F]),
                  acc[p][2] + to_f32(g[2 * F]), acc[p][3] + to_f32(g[3 * F]),
                  to_f32(c[pix * F + f]), act, &cn, &hn);
      c_out[pix * F + f] = from_f32<S>(cn);
      h_out[pix * F + f] = from_f32<S>(hn);
    }
  }
}

template <typename T, typename S, int K>
static int launch(const void* gx, const void* h, const void* c, const void* wh,
                  void* h_out, void* c_out, int B, int H, int W, int F, int act,
                  cudaStream_t stream) {
  constexpr int HP = kTileH + K - 1;
  constexpr int WP = kTileW + K - 1;
  const size_t smem =
      sizeof(float) * ((size_t)F * HP * WP + (size_t)K * K * kChunk * 4 * kFeat);
  auto kernel = convlstm_level_kernel<T, S, K>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nslices = (F + kFeat - 1) / kFeat;
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B * nslices);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(gx), static_cast<const S*>(h), static_cast<const S*>(c),
      static_cast<const T*>(wh), static_cast<S*>(h_out), static_cast<S*>(c_out),
      H, W, F, act);
  return (int)cudaGetLastError();
}

template <typename T, typename S>
static int dispatch_k(int K, const void* gx, const void* h, const void* c,
                      const void* wh, void* h_out, void* c_out, int B, int H,
                      int W, int F, int act, cudaStream_t s) {
  switch (K) {
    case 1: return launch<T, S, 1>(gx, h, c, wh, h_out, c_out, B, H, W, F, act, s);
    case 3: return launch<T, S, 3>(gx, h, c, wh, h_out, c_out, B, H, W, F, act, s);
    case 5: return launch<T, S, 5>(gx, h, c, wh, h_out, c_out, B, H, W, F, act, s);
    case 7: return launch<T, S, 7>(gx, h, c, wh, h_out, c_out, B, H, W, F, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace lut

// Shared-memory bytes one block of the kernel needs (the budget supported()
// holds against the card's 227 KB per block).
extern "C" long long lut_convlstm_level_smem(int K, int F) {
  using namespace lut;
  return (long long)sizeof(float) *
         ((long long)F * (kTileH + K - 1) * (kTileW + K - 1) +
          (long long)K * K * kChunk * 4 * kFeat);
}

extern "C" int lut_convlstm_level(const void* gx, const void* h, const void* c,
                                  const void* wh, void* h_out, void* c_out, int B,
                                  int H, int W, int F, int K, int act,
                                  int compute_dtype, int state_dtype, void* stream) {
  using namespace lut;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (compute_dtype == kF32 && state_dtype == kF32)
    return dispatch_k<float, float>(K, gx, h, c, wh, h_out, c_out, B, H, W, F, act, s);
  if (compute_dtype == kBF16 && state_dtype == kBF16)
    return dispatch_k<bf16, bf16>(K, gx, h, c, wh, h_out, c_out, B, H, W, F, act, s);
  if (compute_dtype == kBF16 && state_dtype == kF32)
    return dispatch_k<bf16, float>(K, gx, h, c, wh, h_out, c_out, B, H, W, F, act, s);
  if (compute_dtype == kF32 && state_dtype == kBF16)
    return dispatch_k<float, bf16>(K, gx, h, c, wh, h_out, c_out, B, H, W, F, act, s);
  return (int)cudaErrorInvalidValue;
}
