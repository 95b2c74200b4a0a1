// K3: 8-connected connected-component labelling of a binary mask.
//
// Replaces lstm_unet_tpu/ops/pallas/ccl.py::connected_components_pallas
// (_ccl_kernel, _neighborhood_min). Output: int32 [H, W], 0 for background and
// for each component its minimum linear index row*W + col, plus one, the fixed
// point of the reference's min-label propagation (ops/ccl.py).
//
// Bound: latency, not bytes or arithmetic: the mask and the labels are 5
// bytes a pixel, less than a launch costs to start. The TPU kernel keeps the
// whole label grid in VMEM and sweeps it to a fixed point, O(component
// diameter) rounds. Here the grid stays on chip too, but as a union-find
// forest with no iteration count at all, in ONE launch:
//
//  * Runs, not pixels. A row is cut into 32-pixel words and a word into runs
//    of set bits (__ffs / __clz on the word). Only a run's first pixel
//    carries a parent. A run that continues the word to its left is seeded
//    with the start of the whole run, so a row needs no union; run starts
//    union with every run of the row above that touches them (the runs of
//    the window one pixel wider on each side).
//  * Every union links the larger root under the smaller one (atomicMin), and
//    a parent is never larger than its child, so each root ends as its
//    component's minimum linear index whatever order the atomics run in: the
//    labels are bit-identical to the plain version.
//  * The cluster route (frames whose int32 grid fits the shared memory of a
//    thread-block cluster of 8: 512^2 is 8 strips of 64 rows, 128 KB each).
//    Block k owns a strip of rows and keeps its part of the forest in its own
//    shared memory from first touch to last write; parents are global linear
//    indices, so a parent in another strip is told from a local one by its
//    row and reached through distributed shared memory. Phases, separated by
//    barriers: (0) read the mask once (16 pixels a thread), build the bit
//    words, seed the run starts; (1) unions inside the strip, then pointer
//    jumping until every run start points at its strip root, the roots
//    flagged; (2) unions across the seven seams, on the neighbours' forests
//    (cluster.map_shared_rank; only flagged roots are ever rewritten); (3)
//    the strip roots walk to their final roots, the other run starts read
//    theirs through their strip root, and every pixel takes its label from
//    its run start: the labels are written once, 4 a thread. The last cluster
//    barrier is waited on at the kernel's end, after the last remote access
//    of every block. No scratch in device memory: the traffic is the mask in
//    and the labels out.
//  * The grid route (every other shape): the same phases in one cooperative
//    launch with grid.sync() between them and the forest in device memory,
//    stored in the label grid itself as parent + 1 (so a resolved run start
//    already holds its final label), plus the bit words as scratch.
//
// With one block on each of 8 SMs the cluster route is bound by the
// instructions those SMs issue and by the walks of the unions, not by memory.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace lut {

constexpr int kClusterBlocks = 8;      // the portable cluster size
constexpr int kClusterThreads = 1024;
constexpr int kGridThreads = 256;
constexpr int kMaxSmem = 232448;       // bytes one Hopper block may use
constexpr int kMaxDevices = 64;
constexpr uint32_t kFull = 0xffffffffu;

// First bit of the run of set bits of w that holds bit b.
__device__ __forceinline__ int run_start(uint32_t w, int b) {
  const uint32_t zeros_below = ~w & ((1u << b) - 1u);
  return zeros_below ? 32 - __clz(zeros_below) : 0;
}

// Whether bit b of w starts a run.
__device__ __forceinline__ bool starts_run(uint32_t w, int b) {
  return ((w >> b) & 1u) && (b == 0 || !((w >> (b - 1)) & 1u));
}

// Where the parent of strip pixel idx sits in shared memory. A warp works on
// 32 neighbouring words, a word a lane, mostly at the same bit of each: left
// as they are, those parents sit 32 ints apart, all in one bank. So each
// group of 32 is rotated by its number.
__device__ __forceinline__ int slot(int idx) {
  return (idx & ~31) | ((idx + (idx >> 5)) & 31);
}

// The forest of one strip in this block's shared memory, while no other block
// touches it. Parents are global linear indices; `lo` is the strip's first.
struct StripForest {
  int* par;
  int lo;
  __device__ __forceinline__ int load(int x) const {
    return reinterpret_cast<volatile int*>(par)[slot(x - lo)];
  }
  __device__ __forceinline__ int link(int child, int parent) const {
    return atomicMin(&par[slot(child - lo)], parent);
  }
  // A plain store: shared-memory atomics are scarce, and a walk issues one
  // shortening a hop. It can undo a smaller value another thread just wrote,
  // but never a link: only nodes seen with a parent are rewritten, a node
  // with a parent never becomes a root again, and what is written is one of
  // its ancestors. The strip's trees are flattened afterwards in any case.
  __device__ __forceinline__ void shorten(int x, int ancestor) const {
    par[slot(x - lo)] = ancestor;
  }
};

// The forest of the whole frame, spread over the cluster's shared memory:
// strip r of `strip` pixels lives in block r, at the same offset everywhere.
struct ClusterForest {
  int* par;
  int lo, hi, strip;
  __device__ __forceinline__ int* at(int x) const {
    if (x >= lo && x < hi) return par + slot(x - lo);
    const int rank = x / strip;
    return cg::this_cluster().map_shared_rank(par, rank) + slot(x - rank * strip);
  }
  __device__ __forceinline__ int load(int x) const {
    return *reinterpret_cast<volatile int*>(at(x));
  }
  __device__ __forceinline__ int link(int child, int parent) const {
    return atomicMin(at(child), parent);
  }
  __device__ __forceinline__ void shorten(int x, int ancestor) const {
    atomicMin(at(x), ancestor);
  }
};

// The forest in device memory, kept in the label grid as parent + 1.
struct GridForest {
  int* lab;
  __device__ __forceinline__ int load(int x) const {
    return reinterpret_cast<volatile int*>(lab)[x] - 1;
  }
  __device__ __forceinline__ int link(int child, int parent) const {
    return atomicMin(&lab[child], parent + 1) - 1;
  }
  __device__ __forceinline__ void shorten(int x, int ancestor) const {
    atomicMin(&lab[x], ancestor + 1);
  }
};

// Root of x; parents only ever decrease, so a stale read is still an
// ancestor and the walk ends at a root. Every node passed is pointed at its
// grandparent (path splitting; how is the forest's business): linking by
// index alone builds deep trees, and the walks dominate without it.
template <class Forest>
__device__ __forceinline__ int find_root(const Forest& f, int x) {
  int y = f.load(x);
  while (y != x) {
    const int z = f.load(y);
    if (z != y) f.shorten(x, z);
    x = y;
    y = z;
  }
  return x;
}

// Union the trees of a and b: link the larger root under the smaller one,
// retrying if a concurrent union moved the root first.
template <class Forest>
__device__ __forceinline__ void unite(const Forest& f, int a, int b) {
  while (true) {
    a = find_root(f, a);
    b = find_root(f, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = f.link(b, a);
    if (old == b) return;
    b = old;
  }
}

// The starts of the runs of a word.
__device__ __forceinline__ uint32_t run_starts(uint32_t w) { return w & ~(w << 1); }

// What lies above a word: bit j of `window` is the pixel above bit j - 1 of
// the word, so bits 0 and 33 belong to the neighbouring words of that row.
// (Bit words are read as volatile throughout: on the grid route other blocks
// wrote them earlier in the same launch.)
struct Above {
  uint32_t left, mid;
  uint64_t window;
};

__device__ __forceinline__ Above load_above(const volatile uint32_t* up, int wx, int ww) {
  Above a;
  a.mid = up[wx];
  a.left = wx > 0 ? up[wx - 1] : 0u;
  const uint32_t right = wx + 1 < ww ? up[wx + 1] : 0u;
  a.window = static_cast<uint64_t>(a.left >> 31) | (static_cast<uint64_t>(a.mid) << 1) |
             (static_cast<uint64_t>(right & 1u) << 33);
  return a;
}

// A run that starts at bit 0 of word wx may continue a run of the words to
// its left: the column where that run really starts (wx * 32 if it does not).
// Seeding such a piece with that start as its parent joins a row's pieces
// with no union at all (a fresh root may hang under any smaller index of its
// component).
__device__ __forceinline__ int row_run_start(const volatile uint32_t* row, int wx) {
  int k = wx;
  while (k > 0 && (row[k - 1] >> 31)) {
    --k;
    if (row[k] != kFull) return k * 32 + run_start(row[k], 31);
  }
  return k * 32;
}

// The runs of the row above that touch the run starting at bit s of `cur`:
// those of the window one pixel wider than the run on each side, as the bits
// of `above.window` where each begins (or enters the window).
__device__ __forceinline__ uint64_t touched_above(uint32_t cur, int s, const Above& above) {
  const uint32_t rest = ~cur >> s;  // first clear bit at or after s ends the run
  const int len = rest ? __ffs(rest) - 1 : 32 - s;
  const uint64_t touched = above.window & (((1ull << (len + 2)) - 1ull) << s);
  return touched & ~(touched << 1);
}

// The run start (of its word) of the pixel at bit j of `above.window`; `base`
// is the linear index of bit 0 of the word above.
__device__ __forceinline__ int above_run_start(const Above& above, int j, int base) {
  if (j == 0) return base - 32 + run_start(above.left, 31);
  if (j == 33) return base + 32;
  return base + run_start(above.mid, j - 1);
}

// Union the run that starts at bit s of `cur` (linear index p) with the runs
// of the row above that touch it. That row's pixels sit `w` before this one's.
// A union starts from the parents of the two run starts, so its walks never
// rewrite a run start that is not a root: the cluster route's last phase
// relies on those still pointing at their strip root.
template <class Forest>
__device__ __forceinline__ void link_up(const Forest& f, int p, uint32_t cur, int s,
                                        const Above& above, int w) {
  uint64_t starts = touched_above(cur, s, above);
  while (starts) {
    const int j = __ffsll(static_cast<long long>(starts)) - 1;
    starts &= starts - 1;
    unite(f, f.load(p), f.load(above_run_start(above, j, p - s - w)));
  }
}

// All unions of one word (its first pixel at linear index p0) with the row
// above.
template <class Forest>
__device__ __forceinline__ void link_word(const Forest& f, int p0, uint32_t cur, int wx,
                                          const volatile uint32_t* up, int ww, int w) {
  if (!cur) return;
  const Above above = load_above(up, wx, ww);
  if (!above.window) return;
  uint32_t starts = run_starts(cur);
  while (starts) {
    const int s = __ffs(starts) - 1;
    starts &= starts - 1;
    link_up(f, p0 + s, cur, s, above, w);
  }
}

// Bytes of dynamic shared memory of a cluster block: the strip's parents (in
// whole groups of 32, see slot()), the bit words of the strip and of the row
// above it, the root flags.
__host__ __device__ inline long long cluster_smem_bytes(int H, int W) {
  const long long R = (H + kClusterBlocks - 1) / kClusterBlocks;
  const long long ww = (W + 31) / 32;
  return 4 * ((R * W + 31) / 32 * 32 + (R + 1) * ww + R * ww);
}

// Point every run start of the strip at the root of its tree: pointer
// jumping, two hops a round, each round over all run starts, until a round
// moves nothing; that last round leaves the roots flagged in `roots`.
__device__ __forceinline__ void flatten_strip(int* par, const uint32_t* strip_bits,
                                              uint32_t* roots, int words, int ww, int W,
                                              int lo) {
  for (bool again = true; again;) {
    bool moved = false;
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      const int ly = i / ww, wx = i - ly * ww;
      const int base = ly * W + wx * 32;
      uint32_t starts = run_starts(strip_bits[i]);
      uint32_t flags = 0u;
      while (starts) {
        const int s = __ffs(starts) - 1;
        starts &= starts - 1;
        const int at = slot(base + s);
        const int y = par[at];
        const int z = par[slot(y - lo)];
        if (z != y) {
          par[at] = par[slot(z - lo)];
          moved = true;
        } else if (y == lo + base + s) {
          flags |= 1u << s;
        }
      }
      roots[i] = flags;
    }
    again = __syncthreads_or(moved);
  }
}

// With -DLUT_CCL_PROFILE the cluster kernel records the clock of each block
// at the end of each phase (after a barrier of its own, so the build is a
// little slower); scripts/profile_torch_ccl.py builds and reads it.
#ifdef LUT_CCL_PROFILE
__device__ long long ccl_clocks[kClusterBlocks * 8];
__device__ __forceinline__ long long clock_after(int dep) {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "r"(dep) : "memory");
  return t;
}
#define PROF(k)                                                           \
  {                                                                       \
    const int dep_ = __syncthreads_or(0);                                 \
    if (threadIdx.x == 0) ccl_clocks[rank * 8 + (k)] = clock_after(dep_); \
  }
#else
#define PROF(k)
#endif

// 16 mask bytes as 16 bits (nonzero byte -> 1).
__device__ __forceinline__ uint32_t pack16(uint4 px) {
  // per 4 bytes: 0/1 in each byte, then the four gathered into bits 24..27
  const uint32_t a = ((__vcmpne4(px.x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
  const uint32_t b = ((__vcmpne4(px.y, 0u) & 0x01010101u) * 0x01020408u) >> 24;
  const uint32_t c = ((__vcmpne4(px.z, 0u) & 0x01010101u) * 0x01020408u) >> 24;
  const uint32_t d = ((__vcmpne4(px.w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
  return a | (b << 4) | (c << 8) | (d << 12);
}

// Work is handed out a word a thread wherever it is per run (a thread walks
// the runs of its word with __ffs), and 16 or 4 pixels a thread where it is
// per pixel (the read and the write): with one block on each of 8 SMs, the
// instructions issued bound the kernel before the memory does.
__global__ void __launch_bounds__(kClusterThreads)
ccl_cluster(const uint8_t* __restrict__ mask, int* __restrict__ labels, int H, int W,
            int R, int vec) {
  extern __shared__ int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ww = (W + 31) >> 5;
  const int r0 = rank * R;
  const int rows = max(0, min(R, H - r0));
  const int lo = r0 * W;
  int* par = smem;  // [R * W], rounded up to 32; entry idx at slot(idx)
  // [(R + 1) * ww]
  uint32_t* bits = reinterpret_cast<uint32_t*>(par + (R * W + 31) / 32 * 32);
  uint32_t* roots = bits + (R + 1) * ww;                       // [R * ww]
  const uint32_t* strip_bits = bits + ww;  // row 0 of `bits` is the row above
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int words = rows * ww;
  const StripForest strip{par, lo};
  const ClusterForest frame{par, lo, lo + rows * W, R * W};

  PROF(0);
  // (0) the bit words of the row above the strip and of the strip
  if (vec) {
    // 16 pixels a thread, all of a thread's loads in flight at once (the read
    // is latency-bound); two neighbouring lanes make a word
    const int total = rows ? (rows + 1) * ww * 2 : 0;
    const uint4* src = reinterpret_cast<const uint4*>(mask + static_cast<long long>(r0 - 1) * W);
    for (int i0 = tid; i0 - lane < total; i0 += 4 * nthreads) {  // whole warps: shuffles
      uint4 px[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * nthreads;
        px[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < total && (r0 > 0 || i >= ww * 2)) px[u] = src[i];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * nthreads;
        const uint32_t half = pack16(px[u]);
        const uint32_t other = __shfl_xor_sync(kFull, half, 1);
        if (i < total && !(lane & 1)) bits[i >> 1] = half | (other << 16);
      }
    }
  } else {
    for (int i = warp; i < (rows ? (rows + 1) * ww : 0); i += nwarps) {
      const int ry = i / ww, wx = i - ry * ww;
      const int y = r0 - 1 + ry, x = wx * 32 + lane;
      const bool fg = y >= 0 && x < W && mask[static_cast<long long>(y) * W + x];
      const uint32_t word = __ballot_sync(kFull, fg);
      if (lane == 0) bits[i] = word;
    }
  }
  __syncthreads();
  // each run start is its own parent; one that continues the word to its
  // left points at where its run really starts
  for (int i = tid; i < words; i += nthreads) {
    const int ly = i / ww, wx = i - ly * ww;
    const uint32_t* row = strip_bits + ly * ww;
    const int base = ly * W + wx * 32;
    uint32_t starts = run_starts(row[wx]);
    if ((starts & 1u) && wx > 0 && (row[wx - 1] >> 31)) {
      starts &= starts - 1;
      par[slot(base)] = lo + ly * W + row_run_start(row, wx);
    }
    while (starts) {
      const int s = __ffs(starts) - 1;
      starts &= starts - 1;
      par[slot(base + s)] = lo + base + s;
    }
  }
  __syncthreads();
  PROF(1);

  // (1) unions inside the strip
  for (int i = tid; i < words; i += nthreads) {
    const int ly = i / ww, wx = i - ly * ww;
    if (ly == 0) continue;
    link_word(strip, lo + ly * W + wx * 32, strip_bits[i], wx, strip_bits + (ly - 1) * ww, ww,
              W);
  }
  __syncthreads();
  PROF(2);
  // every run start points at its strip root; the roots are flagged
  flatten_strip(par, strip_bits, roots, words, ww, W, lo);
  cluster.sync();
  PROF(3);

  // (2) unions across the seam above this strip, a pixel a lane (one row);
  // only roots are ever linked, in whichever block they live
  if (rank > 0) {
    for (int wx = warp; wx < (rows ? ww : 0); wx += nwarps) {
      const uint32_t cur = strip_bits[wx];
      if (!starts_run(cur, lane)) continue;
      const Above above = load_above(bits, wx, ww);
      link_up(frame, lo + wx * 32 + lane, cur, lane, above, W);
    }
  }
  cluster.sync();
  PROF(4);

  // (3) the strip roots of (1) walk to their final roots (the only remote
  // reads left) ...
  for (int i = tid; i < words; i += nthreads) {
    const int ly = i / ww, wx = i - ly * ww;
    const int p0 = lo + ly * W + wx * 32;
    uint32_t flags = roots[i];
    while (flags) {
      const int s = __ffs(flags) - 1;
      flags &= flags - 1;
      par[slot(p0 + s - lo)] = find_root(frame, p0 + s);
    }
  }
  // No block reads another's shared memory after this barrier. Until then the
  // others may still walk this strip's roots, which the rest of this block's
  // work only reads: so it arrives here and waits at its end.
  cluster.barrier_arrive();
  __syncthreads();
  PROF(5);
  // ... the other run starts read theirs through their strip root ...
  for (int i = tid; i < words; i += nthreads) {
    const int ly = i / ww, wx = i - ly * ww;
    const int base = ly * W + wx * 32;
    uint32_t starts = run_starts(strip_bits[i]) & ~roots[i];
    while (starts) {
      const int s = __ffs(starts) - 1;
      starts &= starts - 1;
      par[slot(base + s)] = par[slot(par[slot(base + s)] - lo)];
    }
  }
  __syncthreads();
  // ... and every pixel takes its label from its run start
  if (vec) {
    const int quads = W >> 2;
    for (int i = tid; i < rows * quads; i += nthreads) {
      const int ly = i / quads, x = (i - ly * quads) * 4;
      const uint32_t cur = strip_bits[ly * ww + (x >> 5)];
      const int base = ly * W + (x & ~31);
      int out[4];
      int prev = 0;  // the pixel before, when it is of the same run
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int b = (x & 31) + k;
        if (!((cur >> b) & 1u)) {
          prev = 0;
        } else if (!prev) {
          prev = par[slot(base + run_start(cur, b))] + 1;
        }
        out[k] = prev;
      }
      *reinterpret_cast<int4*>(labels + lo + ly * W + x) =
          make_int4(out[0], out[1], out[2], out[3]);
    }
  } else {
    for (int i = warp; i < words; i += nwarps) {
      const int ly = i / ww, wx = i - ly * ww;
      const int x = wx * 32 + lane;
      if (x >= W) continue;
      const uint32_t cur = strip_bits[i];
      const int base = ly * W + wx * 32;
      labels[lo + base + lane] =
          ((cur >> lane) & 1u) ? par[slot(base + run_start(cur, lane))] + 1 : 0;
    }
  }
  cluster.barrier_wait();
  PROF(6);
}

// The grid route hands out a pixel a lane throughout: the whole device runs
// it, and the walks through device memory want as many in flight as fit.
__global__ void __launch_bounds__(kGridThreads)
ccl_grid(const uint8_t* __restrict__ mask, int* labels, uint32_t* bits, int H, int W) {
  cg::grid_group grid = cg::this_grid();
  const int ww = (W + 31) >> 5;
  const int words = H * ww;
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  const GridForest frame{labels};

  // (0) bit words
  for (int i = warp; i < words; i += nwarps) {
    const int y = i / ww, wx = i - y * ww;
    const int x = wx * 32 + lane;
    const bool fg = x < W && mask[static_cast<long long>(y) * W + x];
    const uint32_t word = __ballot_sync(kFull, fg);
    if (lane == 0) bits[i] = word;
  }
  grid.sync();
  // each run start is its own parent (+ 1), or where its run really starts
  for (int i = warp; i < words; i += nwarps) {
    const int y = i / ww, wx = i - y * ww;
    const volatile uint32_t* row = bits + y * ww;
    if (!starts_run(row[wx], lane)) continue;
    const int p = y * W + wx * 32 + lane;
    const bool continues = lane == 0 && wx > 0 && (row[wx - 1] >> 31);
    labels[p] = (continues ? y * W + row_run_start(row, wx) : p) + 1;
  }
  grid.sync();

  // (1) + (2) unions with the row above
  for (int i = warp; i < words; i += nwarps) {
    const int y = i / ww, wx = i - y * ww;
    const uint32_t cur = __ldcg(bits + i);
    if (y == 0 || !starts_run(cur, lane)) continue;
    const Above above = load_above(bits + (y - 1) * ww, wx, ww);
    link_up(frame, y * W + wx * 32 + lane, cur, lane, above, W);
  }
  grid.sync();

  // (3) every run start takes its root's label; then the other pixels of the
  // run copy it, and the background is cleared
  for (int i = warp; i < words; i += nwarps) {
    const int y = i / ww, wx = i - y * ww;
    if (!starts_run(__ldcg(bits + i), lane)) continue;
    const int p = y * W + wx * 32 + lane;
    labels[p] = find_root(frame, p) + 1;
  }
  grid.sync();
  for (int i = warp; i < words; i += nwarps) {
    const int y = i / ww, wx = i - y * ww;
    const int x = wx * 32 + lane;
    if (x >= W) continue;
    const uint32_t cur = __ldcg(bits + i);
    const int g = y * W + x;
    if (!((cur >> lane) & 1u)) {
      labels[g] = 0;
    } else {
      const int s = run_start(cur, lane);
      if (s != lane) labels[g] = __ldcg(labels + (g - lane + s));
    }
  }
}

}  // namespace lut

// The cluster route: one launch of one cluster of 8 blocks. `labels` is
// int32 [H, W]; the frame must fit (lut_ccl_cluster_smem(H, W) <= 232448).
extern "C" int lut_ccl_cluster(const void* mask, void* labels, int H, int W,
                               void* stream) {
  using namespace lut;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(ccl_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) configured[dev] = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kClusterBlocks);
  config.blockDim = dim3(kClusterThreads);
  config.dynamicSmemBytes = static_cast<size_t>(cluster_smem_bytes(H, W));
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterBlocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const int R = (H + kClusterBlocks - 1) / kClusterBlocks;
  // rows of whole words at aligned addresses are read 16 pixels and written
  // 4 labels a thread
  const int vec = W % 32 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(labels) % 16 == 0;
  err = cudaLaunchKernelEx(&config, ccl_cluster, static_cast<const uint8_t*>(mask),
                           static_cast<int*>(labels), H, W, R, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#ifdef LUT_CCL_PROFILE
extern "C" int lut_ccl_clocks(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, lut::ccl_clocks, sizeof(lut::ccl_clocks)));
}
#endif

extern "C" long long lut_ccl_cluster_smem(int H, int W) {
  return lut::cluster_smem_bytes(H, W);
}

// The grid route: one cooperative launch. `labels` is int32 [H * W] followed
// by H * ceil(W / 32) words of scratch for the bit words.
extern "C" int lut_ccl_grid(const void* mask, void* labels, int H, int W, void* stream) {
  using namespace lut;
  static int resident[kMaxDevices] = {};  // blocks the device holds at once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = dev < kMaxDevices ? resident[dev] : 0;
  if (blocks == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ccl_grid, kGridThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    blocks = per_sm * sms;
    if (blocks <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
    if (dev < kMaxDevices) resident[dev] = blocks;
  }
  const int ww = (W + 31) / 32;
  const long long wanted = (static_cast<long long>(H) * ww * 32 + kGridThreads - 1) / kGridThreads;
  if (wanted < blocks) blocks = static_cast<int>(wanted);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* l = static_cast<int*>(labels);
  uint32_t* b = reinterpret_cast<uint32_t*>(l + static_cast<long long>(H) * W);
  void* args[] = {&m, &l, &b, &H, &W};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(ccl_grid), dim3(blocks),
                                    dim3(kGridThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lut_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
