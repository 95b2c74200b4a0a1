// The postprocess's two data-dependent loops, each in one launch, and the
// markers of the 'dist' split in two (at the end of this file).
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

// The markers of the 'dist' split (split_markers). They replace no TPU
// kernel: the reference computes them in plain XLA
// (lstm_unet_tpu/ops/postprocess.py:189-197), as rounds of a 3x3 maximum
// with the border padded 0, `max(window, rel_window)` rounds, and the port
// took them as one launch a shifted view a round, ~430 a frame at the
// default radii. What they compute is two window maxima of `dist`, over the
// (2 window + 1)^2 and the (2 R + 1)^2 square around each pixel clipped to
// the frame (equal to the rounds because dist >= 0), and a predicate.
//
// Bound: latency. A call reads 5 bytes a pixel and writes 1: 1.5 MB at 512^2,
// which sits in L2, under a microsecond of bytes. The design:
//
//  * Separable, two launches: the row pass writes each pixel's maxima over
//    its row for both radii (int32 scratch in L2), the column pass finishes
//    them over the column and evaluates the predicate, writing bool markers.
//    A square maximum is the column maximum of row maxima.
//  * One thread a pixel, on a flat index over H * W, so any H and W take
//    the same code. A thread walks its row from the centre out, d = 1 .. R,
//    and keeps the maximum when d reaches `window`, so one walk gives both
//    radii; in the column pass it walks each radius's row maxima.
//  * The clipped window without branches: the neighbour at x - d is read at
//    max(x - d, 0), which lies inside the clipped window whenever x - d does
//    not, so the maximum is unchanged. Radii past the frame are cut to it by
//    the wrapper.
//  * Neighbouring threads read neighbouring addresses (a row in the row pass,
//    a row of the row maxima in the column pass), served by L1 and L2; no
//    shared memory, so no radius or width is too large for a block.
//  * The predicate is the plain version's: int32 compares, `wmax - slack`
//    wrapping as torch's int32 does, and float(dist) >= rel * float(wide)
//    with one f32 multiply rounded once (__fmul_rn: nothing to contract).
constexpr int kSplitThreads = 256;

__device__ __forceinline__ int window_max(const int* __restrict__ line, int at, int stride,
                                          int last, int from, int to, int m) {
  for (int d = from; d <= to; ++d) {
    const int lo = at - d < 0 ? 0 : at - d;
    const int hi = at + d > last ? last : at + d;
    m = max(m, max(__ldg(line + lo * stride), __ldg(line + hi * stride)));
  }
  return m;
}

// Row pass: row_win[p] and (when row_wide is given) row_wide[p], the
// maxima of dist over x +- window and x +- radius in the pixel's row.
__global__ void __launch_bounds__(kSplitThreads)
split_rows_kernel(const int* __restrict__ dist, int* __restrict__ row_win,
                  int* __restrict__ row_wide, int H, int W, int window, int radius) {
  const long long p = static_cast<long long>(blockIdx.x) * kSplitThreads + threadIdx.x;
  if (p >= static_cast<long long>(H) * W) return;
  const int y = static_cast<int>(p / W), x = static_cast<int>(p - static_cast<long long>(y) * W);
  const int* row = dist + static_cast<long long>(y) * W;
  const int m = window_max(row, x, 1, W - 1, 1, window, __ldg(row + x));
  row_win[p] = m;
  if (row_wide != nullptr) row_wide[p] = window_max(row, x, 1, W - 1, window + 1, radius, m);
}

// Column pass: wmax and wide over the pixel's column of the row maxima (wide
// is wmax when row_wide is null), then the markers.
__global__ void __launch_bounds__(kSplitThreads)
split_cols_kernel(const int* __restrict__ dist, const uint8_t* __restrict__ interior,
                  const int* __restrict__ row_win, const int* __restrict__ row_wide,
                  bool* __restrict__ markers, int H, int W, int window, int radius,
                  int slack, int min_dist, int rel_on, float rel) {
  const long long p = static_cast<long long>(blockIdx.x) * kSplitThreads + threadIdx.x;
  if (p >= static_cast<long long>(H) * W) return;
  const int y = static_cast<int>(p / W), x = static_cast<int>(p - static_cast<long long>(y) * W);
  const int wmax = window_max(row_win + x, y, W, H - 1, 1, window, __ldg(row_win + p));
  int wide = wmax;
  if (row_wide != nullptr) {
    wide = window_max(row_wide + x, y, W, H - 1, 1, radius, __ldg(row_wide + p));
  }
  const int v = __ldg(dist + p);
  const int low = static_cast<int>(static_cast<unsigned>(wmax) - static_cast<unsigned>(slack));
  bool m = __ldg(interior + p) != 0 && v >= low && v >= min_dist;
  if (rel_on) m = m && __int2float_rn(v) >= __fmul_rn(rel, __int2float_rn(wide));
  markers[p] = m;
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

// `dist` int32 [H, W] (>= 0), `interior` bool [H, W], `markers` bool [H, W];
// `scratch` int32: the row maxima at `window`, then (when radius > window)
// those at `radius`, H * W each. 0 <= window <= radius; radii past the
// frame change nothing (the wrapper cuts them to max(H, W)).
extern "C" int lut_split_markers(const void* dist, const void* interior, void* markers,
                                 void* scratch, int H, int W, int window, int radius,
                                 int slack, int min_dist, int rel_on, float rel,
                                 void* stream) {
  using namespace lut;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(H) * W;
  const int blocks = static_cast<int>((n + kSplitThreads - 1) / kSplitThreads);
  const int* d = static_cast<const int*>(dist);
  int* row_win = static_cast<int*>(scratch);
  int* row_wide = radius > window ? row_win + n : nullptr;
  const int last_x = W - 1, last_y = H - 1;
  split_rows_kernel<<<blocks, kSplitThreads, 0, s>>>(
      d, row_win, row_wide, H, W, window < last_x ? window : last_x,
      radius < last_x ? radius : last_x);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  split_cols_kernel<<<blocks, kSplitThreads, 0, s>>>(
      d, static_cast<const uint8_t*>(interior), row_win, row_wide, static_cast<bool*>(markers),
      H, W, window < last_y ? window : last_y, radius < last_y ? radius : last_y, slack,
      min_dist, rel_on, rel);
  return static_cast<int>(cudaGetLastError());
}
