// int8 conv, tensor-core route: the C entries. The kernel, its design and
// its launch are in conv_int8_wgmma.cuh; this file compiles it for the tile
// configurations of with_tile, x and y each bf16 or f32.

#include "conv_int8_wgmma.cuh"

namespace lut {
namespace q8 {

template <typename T, typename TOut>
static int dispatch_tile(const Args& a, int tile_n, int planes, cudaStream_t s) {
  return with_tile(tile_n, planes, (int)cudaErrorInvalidValue, [&](auto tn, auto p) {
    return launch<T, TOut, decltype(tn)::value, decltype(p)::value, false>(a, s);
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
    return layout(K, decltype(tn)::value, C::kRows, decltype(p)::value, C::kStages, xbytes,
                  C::kLoaders).Smem;
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
  const int err = make_args(a, x, w, scale, dynamic, w_scale, bias, y, B, H, W, C, K, N,
                            pack_tn, tile_n, chunk);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kBF16) return dispatch_out<__nv_bfloat16>(a, tile_n, chunk / 16, out_dtype, s);
  if (in_dtype == kF32) return dispatch_out<float>(a, tile_n, chunk / 16, out_dtype, s);
  return (int)cudaErrorInvalidValue;
}
