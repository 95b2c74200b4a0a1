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

}  // namespace lut
