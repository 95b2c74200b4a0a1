// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel here is bound through a plain C entry point (ctypes, see
// ops/kernels/_build.py). Each entry returns cudaGetLastError() after its
// launch so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lut {

// dtype codes shared with the Python wrappers (ops/kernels/_build.py)
enum DType : int { kF32 = 0, kBF16 = 1 };
// recurrent activation codes
enum Act : int { kSigmoid = 0, kHardSigmoid = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// sigmoid, or hard_sigmoid clip(0.2x + 0.5, 0, 1). The explicit _rn
// intrinsics stop nvcc from contracting into an FMA, so the rounding is the
// one the plain PyTorch version does (a multiply, then an add).
__device__ __forceinline__ float recurrent_act(float x, int act) {
  if (act == kSigmoid) return 1.0f / (1.0f + expf(-x));
  return fminf(fmaxf(__fadd_rn(__fmul_rn(0.2f, x), 0.5f), 0.0f), 1.0f);
}

// ConvLSTM gate math on f32 pre-activations in the order i, f, g, o:
//   c' = act(f) * c + act(i) * tanh(g),   h' = act(o) * tanh(c')
__device__ __forceinline__ void gate_update(float zi, float zf, float zg, float zo,
                                            float c, int act, float* c_new,
                                            float* h_new) {
  const float i = recurrent_act(zi, act);
  const float f = recurrent_act(zf, act);
  const float g = tanhf(zg);
  const float o = recurrent_act(zo, act);
  const float cn = __fadd_rn(__fmul_rn(f, c), __fmul_rn(i, g));
  *c_new = cn;
  *h_new = __fmul_rn(o, tanhf(cn));
}

// d act(z) / dz given a = act(z): a(1 - a) for sigmoid; for hard_sigmoid 0.2
// strictly inside (-2.5, 2.5) and 0 elsewhere, the reference kernel's rule
// (lstm_unet_tpu/ops/pallas/lstm_gates.py::_bwd_kernel), so z = +-2.5 gives 0.
// `scale` is the upstream factor; the product keeps the reference's order
// (scale * a * (1 - a), or scale * 0.2).
__device__ __forceinline__ float recurrent_act_vjp(float scale, float z, float a,
                                                   int act) {
  if (act == kSigmoid) return __fmul_rn(__fmul_rn(scale, a), __fsub_rn(1.0f, a));
  return __fmul_rn(scale, (z > -2.5f && z < 2.5f) ? 0.2f : 0.0f);
}

// Backward of gate_update from the pre-activations, the previous cell state
// and the cotangents (dc', dh') of (c', h'); recomputes the forward in
// registers. In the reference's order of operations:
//   dc_new = dc' + dh' * o * (1 - tanh(c')^2)
//   dzi = dc_new * g * act'(zi)      dzf = dc_new * c * act'(zf)
//   dzg = dc_new * i * (1 - g^2)     dzo = dh' * tanh(c') * act'(zo)
//   dc  = dc_new * f
__device__ __forceinline__ void gate_update_bwd(float zi, float zf, float zg, float zo,
                                                float c, float dc_out, float dh, int act,
                                                float* dzi, float* dzf, float* dzg,
                                                float* dzo, float* dc) {
  const float i = recurrent_act(zi, act);
  const float f = recurrent_act(zf, act);
  const float g = tanhf(zg);
  const float o = recurrent_act(zo, act);
  const float tc = tanhf(__fadd_rn(__fmul_rn(f, c), __fmul_rn(i, g)));
  const float dc_new = __fadd_rn(
      dc_out, __fmul_rn(__fmul_rn(dh, o), __fsub_rn(1.0f, __fmul_rn(tc, tc))));
  *dzi = recurrent_act_vjp(__fmul_rn(dc_new, g), zi, i, act);
  *dzf = recurrent_act_vjp(__fmul_rn(dc_new, c), zf, f, act);
  *dzg = __fmul_rn(__fmul_rn(dc_new, i), __fsub_rn(1.0f, __fmul_rn(g, g)));
  *dzo = recurrent_act_vjp(__fmul_rn(dh, tc), zo, o, act);
  *dc = __fmul_rn(dc_new, f);
}

}  // namespace lut
