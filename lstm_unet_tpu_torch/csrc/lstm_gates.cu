// K1: fused ConvLSTM gate update, forward; K2: its backward.
//
// K1 replaces lstm_unet_tpu/ops/pallas/lstm_gates.py::_fwd_pallas (_fwd_kernel).
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
//
// K2 replaces lstm_unet_tpu/ops/pallas/lstm_gates.py::_bwd_pallas (_bwd_kernel).
// From the saved forward inputs (gates [rows, 4F], c [rows, F]) and the
// cotangents (dc', dh') [rows, F] it writes dgates [rows, 4F] in the gates'
// dtype and dc [rows, F] in c's dtype. Like the reference it saves nothing
// from the forward but its inputs: i, f, g, o and tanh(c') are recomputed in
// registers. Bound: bandwidth again, reading 7F and writing 5F elements per
// row for ~40 flops per (row, feature); same thread layout as K1, so every
// load and store of a warp is 32 consecutive elements.

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

template <typename TG, typename TS>
__global__ void __launch_bounds__(256)
gate_update_bwd_kernel(const TG* __restrict__ gates, const TS* __restrict__ c,
                       const TS* __restrict__ dc_out, const TS* __restrict__ dh,
                       TG* __restrict__ dgates, TS* __restrict__ dc, long long rows,
                       int feat, int act) {
  const long long n = rows * feat;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += stride) {
    const long long r = idx / feat;
    const int f = (int)(idx - r * feat);
    const long long off = r * 4 * feat + f;
    const TG* g = gates + off;
    float dzi, dzf, dzg, dzo, dcv;
    gate_update_bwd(to_f32(g[0]), to_f32(g[feat]), to_f32(g[2 * feat]),
                    to_f32(g[3 * feat]), to_f32(c[idx]), to_f32(dc_out[idx]),
                    to_f32(dh[idx]), act, &dzi, &dzf, &dzg, &dzo, &dcv);
    TG* dg = dgates + off;
    dg[0] = from_f32<TG>(dzi);
    dg[feat] = from_f32<TG>(dzf);
    dg[2 * feat] = from_f32<TG>(dzg);
    dg[3 * feat] = from_f32<TG>(dzo);
    dc[idx] = from_f32<TS>(dcv);
  }
}

template <typename TG, typename TS>
static void launch_bwd(const void* gates, const void* c, const void* dc_out,
                       const void* dh, void* dgates, void* dc, long long rows,
                       int feat, int act, cudaStream_t stream) {
  const long long n = rows * feat;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  gate_update_bwd_kernel<TG, TS><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const TG*>(gates), static_cast<const TS*>(c),
      static_cast<const TS*>(dc_out), static_cast<const TS*>(dh),
      static_cast<TG*>(dgates), static_cast<TS*>(dc), rows, feat, act);
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

extern "C" int lut_gate_update_bwd(const void* gates, const void* c, const void* dc_out,
                                   const void* dh, void* dgates, void* dc,
                                   long long rows, int feat, int act, int gate_dtype,
                                   int state_dtype, void* stream) {
  using namespace lut;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gate_dtype == kF32 && state_dtype == kF32)
    launch_bwd<float, float>(gates, c, dc_out, dh, dgates, dc, rows, feat, act, s);
  else if (gate_dtype == kBF16 && state_dtype == kBF16)
    launch_bwd<__nv_bfloat16, __nv_bfloat16>(gates, c, dc_out, dh, dgates, dc, rows,
                                             feat, act, s);
  else if (gate_dtype == kBF16 && state_dtype == kF32)
    launch_bwd<__nv_bfloat16, float>(gates, c, dc_out, dh, dgates, dc, rows, feat,
                                     act, s);
  else if (gate_dtype == kF32 && state_dtype == kBF16)
    launch_bwd<float, __nv_bfloat16>(gates, c, dc_out, dh, dgates, dc, rows, feat,
                                     act, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
