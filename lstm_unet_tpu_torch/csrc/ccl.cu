// K3: 8-connected connected-component labelling of a binary mask.
//
// Replaces lstm_unet_tpu/ops/pallas/ccl.py::connected_components_pallas
// (_ccl_kernel, _neighborhood_min). Output: int32 [H, W], 0 for background and
// for each component its minimum linear index row*W + col, plus one, the fixed
// point of the reference's min-label propagation (ops/ccl.py).
//
// Bound: latency and memory, not arithmetic. The TPU kernel keeps the whole
// label grid in VMEM and sweeps it to a fixed point; a 512^2 int32 grid is
// 1 MB, more than one SM's 227 KB of shared memory, and a sweep to the fixed
// point costs O(component diameter) rounds (O(H*W) for a spiral). Design:
// union-find after Playne & Hawick, "A New Algorithm for Parallel
// Connected-Component Labelling on GPUs" (IEEE TPDS 2018), in three launches
// with no iteration count at all:
//  1. ccl_local: each 32x32 tile unions its pixels in shared memory;
//  2. ccl_merge: pixels on tile borders union across tiles in device memory;
//  3. ccl_flatten: each pixel writes its root + 1.
// Every union links the larger root under the smaller one (atomicMin) and a
// parent is never larger than its child, so each root ends as its
// component's minimum index whatever order the atomics run in: the labels
// are bit-identical to the plain version.

#include "common.cuh"

namespace lut {

constexpr int kTile = 32;

// Root of x; parents only ever decrease, so a stale read is still an
// ancestor and the walk ends at a root.
__device__ __forceinline__ int find_root(volatile const int* p, int x) {
  int y = p[x];
  while (y != x) {
    x = y;
    y = p[x];
  }
  return x;
}

// Union the trees of a and b: link the larger root under the smaller one,
// retrying if a concurrent union moved the root first.
__device__ __forceinline__ void unite(int* p, int a, int b) {
  while (true) {
    a = find_root(p, a);
    b = find_root(p, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(&p[b], a);
    if (old == b) return;
    b = old;
  }
}

__global__ void __launch_bounds__(kTile * kTile)
ccl_local(const uint8_t* __restrict__ mask, int* __restrict__ parent, int H, int W) {
  __shared__ int sp[kTile * kTile];
  const int lx = threadIdx.x, ly = threadIdx.y;
  const int x = blockIdx.x * kTile + lx, y = blockIdx.y * kTile + ly;
  const int l = ly * kTile + lx;
  const bool fg = x < W && y < H && mask[(long long)y * W + x];
  sp[l] = fg ? l : -1;  // background stays -1: unions only touch roots
  __syncthreads();
  if (fg) {
    // backward neighbours W, NW, N, NE inside the tile (unions are symmetric)
    if (lx > 0 && sp[l - 1] >= 0) unite(sp, l, l - 1);
    if (ly > 0) {
      if (lx > 0 && sp[l - kTile - 1] >= 0) unite(sp, l, l - kTile - 1);
      if (sp[l - kTile] >= 0) unite(sp, l, l - kTile);
      if (lx < kTile - 1 && sp[l - kTile + 1] >= 0) unite(sp, l, l - kTile + 1);
    }
  }
  __syncthreads();
  if (fg) {
    // tile-local raster order agrees with global raster order, so the local
    // minimum root maps to the global minimum index of the local component
    const int r = find_root(sp, l);
    parent[(long long)y * W + x] =
        (blockIdx.y * kTile + r / kTile) * W + blockIdx.x * kTile + r % kTile;
  }
}

__global__ void ccl_merge(const uint8_t* __restrict__ mask, int* __restrict__ parent,
                          int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int g = y * W + x;
  if (!mask[g]) return;
  const bool left = x % kTile == 0;
  const bool right = x % kTile == kTile - 1;
  const bool top = y % kTile == 0;
  // backward neighbours that lie in another tile
  if (x > 0 && left && mask[g - 1]) unite(parent, g, g - 1);
  if (y > 0) {
    if (x > 0 && (left || top) && mask[g - W - 1]) unite(parent, g, g - W - 1);
    if (top && mask[g - W]) unite(parent, g, g - W);
    if (x < W - 1 && (right || top) && mask[g - W + 1]) unite(parent, g, g - W + 1);
  }
}

__global__ void ccl_flatten(const uint8_t* __restrict__ mask,
                            const int* __restrict__ parent, int* __restrict__ labels,
                            int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int g = y * W + x;
  labels[g] = mask[g] ? find_root(parent, g) + 1 : 0;
}

}  // namespace lut

extern "C" int lut_ccl(const void* mask, void* parent, void* labels, int H, int W,
                       void* stream) {
  using namespace lut;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* p = static_cast<int*>(parent);
  dim3 tile(kTile, kTile);
  dim3 tiles((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  ccl_local<<<tiles, tile, 0, s>>>(m, p, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 block(32, 8);
  dim3 grid((W + 31) / 32, (H + 7) / 8);
  ccl_merge<<<grid, block, 0, s>>>(m, p, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ccl_flatten<<<grid, block, 0, s>>>(m, p, static_cast<int*>(labels), H, W);
  return (int)cudaGetLastError();
}

extern "C" const char* lut_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
