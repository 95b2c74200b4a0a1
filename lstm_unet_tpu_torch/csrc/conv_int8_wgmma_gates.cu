// int8 conv, tensor-core route, with the gate epilogue: the unfused int8
// ConvLSTM cell's h-conv, its add of gx and K1's gate update in one kernel
// (conv_int8_wgmma.cuh, kGates). The C entry; compiled apart from
// conv_int8_wgmma.cu so the two build at once.
//
// Replaces, on the card, what the unfused int8 cell of
// lstm_unet_tpu/ops/convlstm.py::QConvLSTMCell ran after its x-conv:
// gates = gx + conv2d_q(h) (the XLA conv of quant.py::_conv_int8), then
// K1 (lstm_unet_tpu/ops/pallas/lstm_gates.py::_fwd_pallas). Bit for bit the
// same arithmetic, and only h' and c' are written: the h-conv's 4F output,
// the add's 4F sum and K1's 4F read never reach device memory.

#include "conv_int8_wgmma.cuh"

namespace lut {
namespace q8 {

template <typename TS, typename TG>
static int dispatch_gates(const Args& a, int tile_n, cudaStream_t s) {
  if (tile_n == 256) return launch<TS, TG, 256, kPlanes, false, true>(a, s);
  if (tile_n == 128) return launch<TS, TG, 128, kPlanes, false, true>(a, s);
  return (int)cudaErrorInvalidValue;
}

template <typename TS>
static int dispatch_gate_dtype(const Args& a, int tile_n, int gate_dtype, cudaStream_t s) {
  if (gate_dtype == kBF16) return dispatch_gates<TS, __nv_bfloat16>(a, tile_n, s);
  if (gate_dtype == kF32) return dispatch_gates<TS, float>(a, tile_n, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace q8
}  // namespace lut

// h [B,H,W,F] and c [B,H,W,F] in state_dtype (kF32 or kBF16), F % 64 == 0;
// w the gate-ordered pack of Wh (ops/kernels/conv_int8.py::gate_order, then
// pack_weight_wgmma: 256-column tiles of 64 features, 128-channel chunks);
// scale the static 0-d f32 s_h, or with dynamic != 0 the 0-d amax = max|h|
// in state_dtype; w_scale [4F] f32 in the pack's column order; gx [B,H,W,4F]
// in gate_dtype, natural order (i | f | g | o); act a recurrent activation
// code. Writes h' into h_out and c' into c_out [B,H,W,F] in state_dtype; none
// of them may alias an input (other tiles still read h's halo). K in {1, 3,
// 5}; tile_n 256 or 128 (it divides the pack's 256).
extern "C" int lut_conv2d_int8_wgmma_gates(const void* h, const void* w, const void* scale,
                                           int dynamic, const void* w_scale, const void* gx,
                                           const void* c, void* h_out, void* c_out, int B, int H,
                                           int W, int F, int K, int tile_n, int act,
                                           int gate_dtype, int state_dtype, void* stream) {
  using namespace lut;
  using namespace lut::q8;
  Args a;
  const int err = make_args(a, h, w, scale, dynamic, w_scale, nullptr, h_out, B, H, W, F, K,
                            4 * F, 256, tile_n, kChunk);
  if (err != 0) return err;
  if (F % 64 != 0 || (act != kSigmoid && act != kHardSigmoid) || gx == nullptr ||
      c == nullptr || c_out == nullptr)
    return (int)cudaErrorInvalidValue;
  a.gx = gx;
  a.c = c;
  a.c_out = c_out;
  a.act = act;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (state_dtype == kBF16) return dispatch_gate_dtype<__nv_bfloat16>(a, tile_n, gate_dtype, s);
  if (state_dtype == kF32) return dispatch_gate_dtype<float>(a, tile_n, gate_dtype, s);
  return (int)cudaErrorInvalidValue;
}
