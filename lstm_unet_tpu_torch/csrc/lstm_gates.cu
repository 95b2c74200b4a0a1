// K1: fused ConvLSTM gate update, forward.
//
// Replaces lstm_unet_tpu/ops/pallas/lstm_gates.py::_fwd_pallas (_fwd_kernel).
// Reads the pre-activation gates [rows, 4F] (order i, f, g, o) and the cell
// state c [rows, F]; writes c' and h' [rows, F] in c's dtype. Math in f32.
//
// Bound: device-memory bandwidth. Per row it moves 4F + F elements in and 2F
// out and does a handful of flops per element, far below the H100's
// operations-per-byte balance. Design: one thread per (row, feature), so a
// warp reads 32 consecutive features of each gate slice and of c (coalesced),
// and the four activations, the state update and both stores happen in
// registers: no intermediate (i, f, g, o, tanh c') touches device memory.
// A grid-stride loop covers any rows x F with a bounded grid.

#include "common.cuh"

namespace lut {

template <typename TG, typename TS>
__global__ void __launch_bounds__(256)
gate_update_kernel(const TG* __restrict__ gates, const TS* __restrict__ c,
                   TS* __restrict__ c_out, TS* __restrict__ h_out,
                   long long rows, int feat, int act) {
  const long long n = rows * feat;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += stride) {
    const long long r = idx / feat;
    const int f = (int)(idx - r * feat);
    const TG* g = gates + r * 4 * feat + f;
    float cn, hn;
    gate_update(to_f32(g[0]), to_f32(g[feat]), to_f32(g[2 * feat]),
                to_f32(g[3 * feat]), to_f32(c[idx]), act, &cn, &hn);
    c_out[idx] = from_f32<TS>(cn);
    h_out[idx] = from_f32<TS>(hn);
  }
}

template <typename TG, typename TS>
static void launch(const void* gates, const void* c, void* c_out, void* h_out,
                   long long rows, int feat, int act, cudaStream_t stream) {
  const long long n = rows * feat;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 blocks/SM
  gate_update_kernel<TG, TS><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const TG*>(gates), static_cast<const TS*>(c),
      static_cast<TS*>(c_out), static_cast<TS*>(h_out), rows, feat, act);
}

}  // namespace lut

extern "C" int lut_gate_update(const void* gates, const void* c, void* c_out,
                               void* h_out, long long rows, int feat, int act,
                               int gate_dtype, int state_dtype, void* stream) {
  using namespace lut;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gate_dtype == kF32 && state_dtype == kF32)
    launch<float, float>(gates, c, c_out, h_out, rows, feat, act, s);
  else if (gate_dtype == kBF16 && state_dtype == kBF16)
    launch<__nv_bfloat16, __nv_bfloat16>(gates, c, c_out, h_out, rows, feat, act, s);
  else if (gate_dtype == kBF16 && state_dtype == kF32)
    launch<__nv_bfloat16, float>(gates, c, c_out, h_out, rows, feat, act, s);
  else if (gate_dtype == kF32 && state_dtype == kBF16)
    launch<float, __nv_bfloat16>(gates, c, c_out, h_out, rows, feat, act, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
