// The postprocess's two data-dependent loops, each in one launch.
//
// Replaces the XLA lax.while_loops of lstm_unet_tpu/ops/postprocess.py (no
// pallas_call): grow_into_band (:53-79), the simultaneous-BFS growth of
// labels into a band, and _erosion_distance (:115-137), the Chebyshev or
// octagonal distance by iterated erosion. The plain versions
// (ops/kernels/postprocess_loops.py) run one round a step and read a flag on
// the host to decide whether to go on; here the decision stays on the card,
// so the streaming step never waits for it.
//
// Bound: latency, not bytes or arithmetic. A round reads 5 bytes a pixel and
// writes 4 (growth) or 1 (erosion): 2.4 MB at 512^2, in L2, a few
// microseconds. What costs is the barrier between rounds. The design, simple
// first (a cluster / DSMEM route like K3's is later work):
//
//  * One cooperative launch (cudaLaunchCooperativeKernel), no more blocks
//    than the device holds at once (occupancy query; a grid that cannot be
//    co-resident is refused, never shrunk below what fits); each thread
//    walks the pixels grid-stride.
//  * Jacobi rounds: every round reads one buffer and writes the other
//    (ping-pong in global memory), so a label moves one pixel a round and
//    the nearest marker wins with ties to the smaller label, as in the
//    plain version. An update in place would let a label run further in one
//    round and break that.
//  * One grid.sync() a round. Each block ORs its threads' "changed" (growth)
//    or "non-empty" (erosion) bit into the round's flag before the barrier,
//    and every thread reads the flag after it, so all leave together. The
//    flags rotate over three slots: slot r is set in round r and read after
//    its barrier, and cleared in round r + 2, when every thread has passed
//    the barrier after the one it was read behind.
//  * The buffers and the flags are read with ld.global.cg (L2, not L1): a
//    line another SM wrote after this SM cached it would be stale in L1.
//  * The rounds run are added to a device counter that nothing on the
//    step's path reads.

#include <cooperative_groups.h>
#include <limits.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace lut {

constexpr int kLoopThreads = 256;
constexpr int kFlags = 3;  // rotating round flags, after the scratch buffers
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void raise_flag(int* flags, int round, bool mine) {
  if (__syncthreads_or(mine) && threadIdx.x == 0) atomicExch(flags + round % kFlags, 1);
}

// Growth: each round, a pixel with label 0 inside the band takes the least
// nonzero label of its 8 neighbours (the border counts as none). Stops after
// a round that changed nothing or after `bound` rounds; `out` holds the
// result, `tmp` is the other buffer.
__global__ void __launch_bounds__(kLoopThreads)
grow_into_band_kernel(const int* __restrict__ in, const uint8_t* __restrict__ band,
                      int* out, int* tmp, int* flags, int H, int W, int bound,
                      unsigned long long* rounds) {
  cg::grid_group grid = cg::this_grid();
  const int n = H * W;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0;
  const int* src = in;
  int* dst = out;
  int it = 0;
  for (;;) {
    bool changed = false;
    for (int p = first; p < n; p += stride) {
      int v = __ldcg(src + p);
      if (v == 0 && band[p]) {
        const int y = p / W, x = p - y * W;
        int nb = INT_MAX;
        for (int dy = -1; dy <= 1; ++dy) {
          const int yy = y + dy;
          if (yy < 0 || yy >= H) continue;
          for (int dx = -1; dx <= 1; ++dx) {
            const int xx = x + dx;
            if ((dy == 0 && dx == 0) || xx < 0 || xx >= W) continue;
            const int q = __ldcg(src + yy * W + xx);
            if (q > 0 && q < nb) nb = q;
          }
        }
        if (nb != INT_MAX) {
          v = nb;
          changed = true;
        }
      }
      dst[p] = v;
    }
    if (leader) flags[(it + 1) % kFlags] = 0;
    raise_flag(flags, it, changed);
    grid.sync();
    const bool again = __ldcg(flags + it % kFlags) != 0;
    ++it;
    if (!again || it >= bound) break;
    src = dst;
    dst = dst == out ? tmp : out;
  }
  if (dst != out) {  // the last round wrote the other buffer
    for (int p = first; p < n; p += stride) out[p] = __ldcg(dst + p);
  }
  if (leader) atomicAdd(rounds, static_cast<unsigned long long>(it));
}

// Erosion distance: dist = mask, then while the mask is not empty and fewer
// than `bound` rounds ran, erode it (8-neighbourhood, or under `octagon` the
// 8- and the 4-neighbourhood in turn, 8 first; the border counts as
// background) and add it to dist. A pixel's dist is kept by the thread that
// owns it, so it needs no barrier of its own.
__global__ void __launch_bounds__(kLoopThreads)
erosion_distance_kernel(const uint8_t* __restrict__ mask, int* dist, uint8_t* buf0,
                        uint8_t* buf1, int* flags, int H, int W, int bound, int octagon,
                        unsigned long long* rounds) {
  cg::grid_group grid = cg::this_grid();
  const int n = H * W;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0;
  // pass 0: dist = mask, and whether the mask holds a pixel
  bool any = false;
  for (int p = first; p < n; p += stride) {
    const int m = mask[p] != 0;
    dist[p] = m;
    any |= m;
  }
  if (leader) flags[1] = 0;
  raise_flag(flags, 0, any);
  grid.sync();
  bool nonempty = __ldcg(flags) != 0;
  const uint8_t* src = mask;
  uint8_t* dst = buf0;
  int it = 0;
  while (nonempty && it < bound) {
    const bool diagonals = !(octagon && (it & 1));
    any = false;
    for (int p = first; p < n; p += stride) {
      bool v = __ldcg(src + p) != 0;
      if (v) {
        const int y = p / W, x = p - y * W;
        const bool up = y > 0, down = y < H - 1, left = x > 0, right = x < W - 1;
        v = left && right && up && down && __ldcg(src + p - 1) && __ldcg(src + p + 1) &&
            __ldcg(src + p - W) && __ldcg(src + p + W);
        if (v && diagonals) {
          v = __ldcg(src + p - W - 1) && __ldcg(src + p - W + 1) &&
              __ldcg(src + p + W - 1) && __ldcg(src + p + W + 1);
        }
        if (v) {
          dist[p] += 1;
          any = true;
        }
      }
      dst[p] = v;
    }
    const int pass = it + 1;
    if (leader) flags[(pass + 1) % kFlags] = 0;
    raise_flag(flags, pass, any);
    grid.sync();
    nonempty = __ldcg(flags + pass % kFlags) != 0;
    it = pass;
    src = dst;
    dst = dst == buf0 ? buf1 : buf0;
  }
  if (leader) atomicAdd(rounds, static_cast<unsigned long long>(it));
}

// Blocks of `kernel` the device holds at once (cached per device), capped at
// what `n` pixels need; 0 with `err` set when the query fails or nothing fits.
template <typename K>
int cooperative_blocks(K kernel, int* cache, int n, cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  int blocks = dev < kMaxDevices ? cache[dev] : 0;
  if (blocks == 0) {
    int per_sm = 0, sms = 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kLoopThreads, 0);
    if (*err != cudaSuccess) return 0;
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err != cudaSuccess) return 0;
    blocks = per_sm * sms;
    if (blocks <= 0) {
      *err = cudaErrorCooperativeLaunchTooLarge;
      return 0;
    }
    if (dev < kMaxDevices) cache[dev] = blocks;
  }
  const int wanted = (n + kLoopThreads - 1) / kLoopThreads;
  return wanted < blocks ? wanted : blocks;
}

}  // namespace lut

// `labels` int32 [H, W] (not written), `band` bool [H, W], `out` int32 [H, W];
// `scratch` int32 [H * W + 3]: the second buffer, then the round flags.
// `rounds` (one uint64 on the device) gains the rounds run.
extern "C" int lut_grow_into_band(const void* labels, const void* band, void* out,
                                  void* scratch, int H, int W, int bound, void* rounds,
                                  void* stream) {
  using namespace lut;
  static int resident[kMaxDevices] = {};
  cudaError_t err = cudaSuccess;
  const int blocks = cooperative_blocks(grow_into_band_kernel, resident, H * W, &err);
  if (blocks == 0) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* in = static_cast<const int*>(labels);
  const uint8_t* b = static_cast<const uint8_t*>(band);
  int* o = static_cast<int*>(out);
  int* tmp = static_cast<int*>(scratch);
  int* flags = tmp + static_cast<long long>(H) * W;
  unsigned long long* r = static_cast<unsigned long long*>(rounds);
  err = cudaMemsetAsync(flags, 0, kFlags * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&in, &b, &o, &tmp, &flags, &H, &W, &bound, &r};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(grow_into_band_kernel),
                                    dim3(blocks), dim3(kLoopThreads), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// `mask` bool [H, W], `dist` int32 [H, W]; `scratch` holds two uint8 [H, W]
// buffers, then (at int32 index `flag_at`) the round flags. `rounds` (one
// uint64 on the device) gains the rounds run.
extern "C" int lut_erosion_distance(const void* mask, void* dist, void* scratch, int flag_at,
                                    int H, int W, int bound, int octagon, void* rounds,
                                    void* stream) {
  using namespace lut;
  static int resident[kMaxDevices] = {};
  cudaError_t err = cudaSuccess;
  const int blocks = cooperative_blocks(erosion_distance_kernel, resident, H * W, &err);
  if (blocks == 0) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* d = static_cast<int*>(dist);
  uint8_t* buf0 = static_cast<uint8_t*>(scratch);
  uint8_t* buf1 = buf0 + static_cast<long long>(H) * W;
  int* flags = static_cast<int*>(scratch) + flag_at;
  unsigned long long* r = static_cast<unsigned long long*>(rounds);
  err = cudaMemsetAsync(flags, 0, kFlags * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&m, &d, &buf0, &buf1, &flags, &H, &W, &bound, &octagon, &r};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(erosion_distance_kernel),
                                    dim3(blocks), dim3(kLoopThreads), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
