// Windowed neighbour select over the cylindrical range image, for sm_90a.
//
// Replaces the two Pallas TPU kernels of efficientlo_net_tpu/ops/pallas_select.py:
//   * window_select_kernel    <- _kernel (pallas_select.py:48-95), driven by
//     _run_select / pallas_window_select;
//   * select_and_group_kernel <- _kernel + _emit_kernel (pallas_select.py:98-122),
//     driven by pallas_select_and_group: one pass selects and copies.
//
// What it computes.  For every centre (i, j) of the centre-strided grid
// (centre pixel (i*csh, j*csw + c1_off) of grid 1), scan the kh x kw window
// of grid 2 based at ((i*csh)/sh, (j*csw)/sw + c2_off): W wraps round the
// cylinder, rows outside [0, H2) are skipped.  The column offsets and the
// centre count n_w are 0, 0 and ceil(W1/csw) for a whole range image; the
// W-axis ring (efficientlo_net_torch/parallel/ring.py) runs a rank's sector
// on its block widened by kw/2 columns each side, where every window stays
// inside the block, the wrap never fires and the indices are flat into the
// widened block.  A candidate counts if the centre and the candidate
// both have |p|^2 > 1e-10 and max(d^2, 1e-10) <= r^2.  FIRST_K keeps the
// first K counted candidates in scan order (raster, or the perm order) and
// stops; KNN keeps the K nearest, ties to the lowest window slot.
//
// Output order.  The K slots are written in the order of the plain PyTorch
// version (efficientlo_net_torch/ops/neighbors.py): scan order for FIRST_K,
// ascending d^2 with ties to the lowest slot for KNN.  Every consumer pools
// over K, so only the set matters to the network, but equal order makes the
// kernel and the plain version give bit-identical network outputs.  d^2 and
// |p|^2 are summed as (x*x + y*y) + z*z without FMA contraction, as the
// plain version's separate tensor ops do, so the radius and KNN decisions
// agree bit for bit.
//
// What bounds it.  Not bytes: a launch has at most 3600 centres, each reads
// at most 451 window slots of 12 bytes (mostly from L1/L2, since neighbouring
// centres share windows) and writes K indices and K mask values, or K*(3+C)
// grouped values; that is well under a microsecond at 3.35 TB/s.  At these
// sizes the launch and the memory latency of a centre's scan set the time,
// and a scan that gives each centre one thread makes T dependent loads (175
// at 5x35, 451 at 11x41) on as few as one or two SMs (116-228 centres).
//
// The design.  One warp per (batch, centre), four warps a block, so 228
// centres spread over 57 SMs.  The lanes take 32 consecutive scan positions
// at once: a scan is ceil(T/32) rounds of independent loads.  FIRST_K ranks
// a round's hits with a ballot and a popcount and stops, warp-uniformly, once
// K are found.  KNN keeps the 32 best keys (d^2 bits << 32 | slot; d^2 > 0,
// so the bits order like the float, and the slot breaks ties) one per lane,
// ascending, in registers: a round's keys are sorted by a warp bitonic sort,
// merged by min(best[i], round[31-i]) and put in order by a bitonic clean.
// A round none of whose keys beats the K-th best cannot change the K nearest
// and is skipped.  The selected flat indices pass through K ints of shared
// memory per warp; the lanes then write the output side by side, so stores
// coalesce, and in the fused kernel neighbouring lanes copy neighbouring
// channels of one pixel.  Tensor cores and TMA have no use here: there is no
// matrix product, and a centre's window is at most 451 x 12 bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 32;
constexpr float kValidEps = 1e-10f;
constexpr int kWarps = 4;  // warps a block, one centre each
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;  // a slot that does not count

struct Geometry {
  int B, H1, W1, H2, W2;  // grid 1 (centres) and grid 2 (source) sizes
  int n_h, n_w;           // centre grid
  int c1_off, c2_off;     // centre column offset on grid 1, window column offset on grid 2
  int kh, kw;             // window
  int csh, csw;           // centre stride on grid 1
  int sh, sw;             // source stride from grid 1 to grid 2
  int k;                  // neighbours kept per centre
  float r2;               // squared radius
};

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// Flat grid-2 index of window slot t of the window based at (row0, col0), or
// -1 where the slot's row lies outside the grid.
__device__ __forceinline__ int slot_flat(const Geometry& g, int row0, int col0, int t) {
  const int row = row0 + t / g.kw;
  if (row < 0 || row >= g.H2) return -1;
  const int col = ((col0 + t % g.kw) % g.W2 + g.W2) % g.W2;
  return row * g.W2 + col;
}

// Whether the candidate at flat index f (-1: none) counts for the centre c;
// sets *d to max(d^2, 1e-10) when it does.
__device__ __forceinline__ bool counts(const float* __restrict__ src, int f, float cx,
                                       float cy, float cz, float r2, float* d) {
  if (f < 0) return false;
  const float* q = src + static_cast<size_t>(f) * 3;
  const float qx = __ldg(q), qy = __ldg(q + 1), qz = __ldg(q + 2);
  if (!(sq3(qx, qy, qz) > kValidEps)) return false;
  *d = fmaxf(sq3(__fsub_rn(qx, cx), __fsub_rn(qy, cy), __fsub_rn(qz, cz)), kValidEps);
  return *d <= r2;
}

// One compare-exchange of a bitonic network over the warp's lanes: of the
// pair (lane, lane ^ j), the lane whose bit j is clear keeps the smaller key
// when `ascending`, the larger otherwise.
__device__ __forceinline__ unsigned long long exchange(unsigned long long key, int lane,
                                                       int j, bool ascending) {
  const unsigned long long other = __shfl_xor_sync(kAllLanes, key, j);
  const bool keep_min = ((lane & j) == 0) == ascending;
  return (key < other) == keep_min ? key : other;
}

// The warp's 32 keys in ascending order over the lanes.
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long key, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) key = exchange(key, lane, j, (lane & k) == 0);
  }
  return key;
}

// A bitonic sequence over the lanes in ascending order.
__device__ __forceinline__ unsigned long long bitonic_clean(unsigned long long key, int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) key = exchange(key, lane, j, true);
  return key;
}

// Selects the neighbours of centre c of batch b, over the whole warp.  Writes
// their flat grid-2 indices to flat[0..hits) in output order and returns hits,
// the same on every lane; every lane may read flat afterwards.
template <bool kKnn>
__device__ int select_centre(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
                             const int* __restrict__ perm, const Geometry& g, int b, int c,
                             int lane, int* flat) {
  const int ci = (c / g.n_w) * g.csh;
  const int cj = (c % g.n_w) * g.csw;
  const float* p = xyz1 + ((static_cast<size_t>(b) * g.H1 + ci) * g.W1 + cj + g.c1_off) * 3;
  const float cx = __ldg(p), cy = __ldg(p + 1), cz = __ldg(p + 2);
  if (!(sq3(cx, cy, cz) > kValidEps)) return 0;

  const int row0 = ci / g.sh - g.kh / 2;
  const int col0 = cj / g.sw + g.c2_off - g.kw / 2;
  const float* src = xyz2 + static_cast<size_t>(b) * g.H2 * g.W2 * 3;
  const int t_total = g.kh * g.kw;
  float d;

  if (!kKnn) {
    const unsigned lanes_below = (1u << lane) - 1u;
    int hits = 0;
    for (int base = 0; base < t_total && hits < g.k; base += 32) {
      const int pos = base + lane;
      const int f = pos < t_total
          ? slot_flat(g, row0, col0, perm ? __ldg(perm + pos) : pos) : -1;
      const bool ok = counts(src, f, cx, cy, cz, g.r2, &d);
      const unsigned ballot = __ballot_sync(kAllLanes, ok);
      const int rank = hits + __popc(ballot & lanes_below);
      if (ok && rank < g.k) flat[rank] = f;
      hits += __popc(ballot);
    }
    __syncwarp();
    return min(hits, g.k);
  }

  unsigned long long best = kNoKey;  // lane i: the i-th nearest so far
  for (int base = 0; base < t_total; base += 32) {
    const int t = base + lane;
    unsigned long long key = kNoKey;
    if (t < t_total && counts(src, slot_flat(g, row0, col0, t), cx, cy, cz, g.r2, &d))
      key = (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
            static_cast<unsigned>(t);
    // lanes K..31 keep real candidates too, but only the K nearest can win
    const unsigned long long kth = __shfl_sync(kAllLanes, best, g.k - 1);
    if (__ballot_sync(kAllLanes, key < kth) == 0) continue;
    key = warp_sort(key, lane);
    const unsigned long long mirrored = __shfl_sync(kAllLanes, key, 31 - lane);
    best = bitonic_clean(mirrored < best ? mirrored : best, lane);
  }
  const int hits = min(__popc(__ballot_sync(kAllLanes, best != kNoKey)), g.k);
  if (lane < hits) flat[lane] = slot_flat(g, row0, col0, static_cast<int>(best & 0xffffffffu));
  __syncwarp();
  return hits;
}

template <bool kKnn>
__global__ void __launch_bounds__(kWarps * 32)
    window_select_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
                         const int* __restrict__ perm, Geometry g, int* __restrict__ idx,
                         float* __restrict__ mask) {
  __shared__ int selected[kWarps][kMaxK];
  const int lane = threadIdx.x & 31;
  const int n = g.n_h * g.n_w;
  const int gid = blockIdx.x * kWarps + (threadIdx.x >> 5);  // (batch, centre)
  if (gid >= g.B * n) return;
  int* flat = selected[threadIdx.x >> 5];
  const int hits = select_centre<kKnn>(xyz1, xyz2, perm, g, gid / n, gid % n, lane, flat);
  if (lane < g.k) {
    const size_t o = static_cast<size_t>(gid) * g.k + lane;
    idx[o] = lane < hits ? flat[lane] : 0;
    mask[o] = lane < hits ? 1.0f : 0.0f;
  }
}

template <bool kKnn>
__global__ void __launch_bounds__(kWarps * 32)
    select_and_group_kernel(const float* __restrict__ xyz, const float* __restrict__ feats,
                            const int* __restrict__ perm, Geometry g, int C,
                            float* __restrict__ gxyz, float* __restrict__ gfeat,
                            float* __restrict__ mask) {
  __shared__ int selected[kWarps][kMaxK];
  const int lane = threadIdx.x & 31;
  const int n = g.n_h * g.n_w;
  const int gid = blockIdx.x * kWarps + (threadIdx.x >> 5);  // (batch, centre)
  if (gid >= g.B * n) return;
  const int b = gid / n;
  int* flat = selected[threadIdx.x >> 5];
  const int hits = select_centre<kKnn>(xyz, xyz, perm, g, b, gid % n, lane, flat);
  // the centre's K x 3 and K x C outputs are contiguous: element e = s*C + ch
  // reads channel ch of the s-th selected pixel, and neighbouring lanes take
  // neighbouring elements
  const size_t pix0 = static_cast<size_t>(b) * g.H2 * g.W2;
  float* out_x = gxyz + static_cast<size_t>(gid) * g.k * 3;
  for (int e = lane; e < g.k * 3; e += 32) {
    const int s = e / 3;
    out_x[e] = s < hits ? __ldg(xyz + (pix0 + flat[s]) * 3 + (e - s * 3)) : 0.0f;
  }
  float* out_f = gfeat + static_cast<size_t>(gid) * g.k * C;
  for (int e = lane; e < g.k * C; e += 32) {
    const int s = e / C;
    out_f[e] = s < hits ? __ldg(feats + (pix0 + flat[s]) * C + (e - s * C)) : 0.0f;
  }
  if (lane < g.k) mask[static_cast<size_t>(gid) * g.k + lane] = lane < hits ? 1.0f : 0.0f;
}

Geometry make_geometry(int B, int H1, int W1, int H2, int W2, int kh, int kw, int csh,
                       int csw, int sh, int sw, int k, float r2, int n_w, int c1_off,
                       int c2_off) {
  Geometry g;
  g.B = B; g.H1 = H1; g.W1 = W1; g.H2 = H2; g.W2 = W2;
  g.n_h = (H1 + csh - 1) / csh;
  g.n_w = n_w;
  g.c1_off = c1_off; g.c2_off = c2_off;
  g.kh = kh; g.kw = kw; g.csh = csh; g.csw = csw; g.sh = sh; g.sw = sw;
  g.k = k; g.r2 = r2;
  return g;
}

int blocks_for(const Geometry& g) { return (g.B * g.n_h * g.n_w + kWarps - 1) / kWarps; }

}  // namespace

extern "C" int elo_max_k() { return kMaxK; }

// idx (B, N, K) int32 flat into H2*W2 (0 where masked), mask (B, N, K) float;
// N = ceil(H1/csh) * n_w.  Returns cudaGetLastError() after the launch.
extern "C" int elo_window_select(const float* xyz1, const float* xyz2, const int* perm,
                                 int B, int H1, int W1, int H2, int W2, int kh, int kw,
                                 int csh, int csw, int sh, int sw, int k, float r2,
                                 int knn, int n_w, int c1_off, int c2_off, int* idx,
                                 float* mask, cudaStream_t stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = make_geometry(B, H1, W1, H2, W2, kh, kw, csh, csw, sh, sw, k, r2, n_w,
                                   c1_off, c2_off);
  auto kernel = knn ? window_select_kernel<true> : window_select_kernel<false>;
  kernel<<<blocks_for(g), kWarps * 32, 0, stream>>>(xyz1, xyz2, perm, g, idx, mask);
  return static_cast<int>(cudaGetLastError());
}

// gxyz (B, N, K, 3), gfeat (B, N, K, C), mask (B, N, K) float; masked slots
// are zero; N = ceil(H/csh) * n_w.  Returns cudaGetLastError() after the launch.
extern "C" int elo_select_and_group(const float* xyz, const float* feats, const int* perm,
                                    int B, int H, int W, int C, int kh, int kw, int csh,
                                    int csw, int k, float r2, int knn, int n_w, int c1_off,
                                    int c2_off, float* gxyz, float* gfeat, float* mask,
                                    cudaStream_t stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = make_geometry(B, H, W, H, W, kh, kw, csh, csw, 1, 1, k, r2, n_w, c1_off,
                                   c2_off);
  auto kernel = knn ? select_and_group_kernel<true> : select_and_group_kernel<false>;
  kernel<<<blocks_for(g), kWarps * 32, 0, stream>>>(xyz, feats, perm, g, C, gxyz, gfeat,
                                                    mask);
  return static_cast<int>(cudaGetLastError());
}
