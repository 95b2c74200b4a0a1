// A measurement, never the program's path: the int8 wgmma conv
// (../conv_int8_wgmma.cuh) built with kTime, its cycle counters by role.
// Built into a library of its own at its first call
// (ops/kernels/_build.py::probe_library), not into the program's.

#include "../conv_int8_wgmma.cuh"

// The launch of lut_conv2d_int8_wgmma at a wide tile (tile_n 256 or 128,
// chunks of 128 channels), bf16 x and y and a static scale, adding the
// kernel's 10 cycle counters (unsigned 64-bit, zeroed by the caller) to prof.
extern "C" int lut_conv2d_int8_wgmma_probe(const void* x, const void* w, const void* scale,
                                           const void* w_scale, const void* bias, void* y, int B,
                                           int H, int W, int C, int K, int N, int pack_tn,
                                           int tile_n, void* prof, void* stream) {
  using namespace lut::q8;
  using B16 = __nv_bfloat16;
  Args a;
  const int err = make_args(a, x, w, scale, 0, w_scale, bias, y, B, H, W, C, K, N, pack_tn,
                            tile_n, kChunk);
  if (err != 0) return err;
  if (prof == nullptr) return (int)cudaErrorInvalidValue;
  a.prof = static_cast<unsigned long long*>(prof);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_n == 256) return launch<B16, B16, 256, kPlanes, true>(a, s);
  if (tile_n == 128) return launch<B16, B16, 128, kPlanes, true>(a, s);
  return (int)cudaErrorInvalidValue;
}
