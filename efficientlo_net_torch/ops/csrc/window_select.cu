// Windowed neighbour select over the cylindrical range image, for sm_90a.
//
// Replaces the two Pallas TPU kernels of efficientlo_net_tpu/ops/pallas_select.py:
//   * window_select_kernel    <- _kernel (pallas_select.py:48-95), driven by
//     _run_select / pallas_window_select;
//   * select_and_group_kernel <- _kernel + _emit_kernel (pallas_select.py:98-122),
//     driven by pallas_select_and_group: one pass selects and copies.
//
// What it computes.  For every centre (i, j) of the centre-strided grid
// (centre pixel (i*csh, j*csw) of grid 1), scan the kh x kw window of grid 2
// based at ((i*csh)/sh, (j*csw)/sw): W wraps round the cylinder, rows outside
// [0, H2) are skipped.  A candidate counts if the centre and the candidate
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
// What bounds it.  Bytes: each centre reads at most kh*kw*3 floats, mostly
// from L1/L2 (neighbouring centres share windows), and writes K indices and K
// mask values (or K*(3+C) grouped values).  At the network's shapes (at most
// 3600 centres a launch) the work is a few microseconds of memory traffic,
// so the launch itself dominates.  The design is one thread per centre, no
// shared memory and no re-layout of the source (the TPU kernel's _prebuild
// exists only to suit the TPU's vector tiling): it indexes the wrapped window
// directly and keeps the K-best list in thread-local arrays, which keeps the
// launch cheap and the code small.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 32;
constexpr float kValidEps = 1e-10f;
constexpr int kThreads = 128;

struct Geometry {
  int B, H1, W1, H2, W2;  // grid 1 (centres) and grid 2 (source) sizes
  int n_h, n_w;           // centre grid
  int kh, kw;             // window
  int csh, csw;           // centre stride on grid 1
  int sh, sw;             // source stride from grid 1 to grid 2
  int k;                  // neighbours kept per centre
  float r2;               // squared radius
  int knn;                // 1: K nearest, 0: first K in scan order
};

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// Selects the neighbours of centre c of batch b.  Writes their flat grid-2
// indices to flat[0..hits) in output order and returns hits.
__device__ int select_centre(const float* __restrict__ xyz1,
                             const float* __restrict__ xyz2,
                             const int* __restrict__ perm, const Geometry& g,
                             int b, int c, int* flat) {
  const int ci = (c / g.n_w) * g.csh;
  const int cj = (c % g.n_w) * g.csw;
  const float* p = xyz1 + ((static_cast<size_t>(b) * g.H1 + ci) * g.W1 + cj) * 3;
  const float cx = p[0], cy = p[1], cz = p[2];
  if (!(sq3(cx, cy, cz) > kValidEps)) return 0;

  const int row0 = ci / g.sh - g.kh / 2;
  const int col0 = cj / g.sw - g.kw / 2;
  const float* src = xyz2 + static_cast<size_t>(b) * g.H2 * g.W2 * 3;
  const int t_total = g.kh * g.kw;

  float best[kMaxK];
  int hits = 0;
  for (int pos = 0; pos < t_total; ++pos) {
    const int t = perm ? __ldg(perm + pos) : pos;
    const int row = row0 + t / g.kw;
    if (row < 0 || row >= g.H2) continue;
    const int col = ((col0 + t % g.kw) % g.W2 + g.W2) % g.W2;
    const int f = row * g.W2 + col;
    const float* q = src + static_cast<size_t>(f) * 3;
    const float qx = q[0], qy = q[1], qz = q[2];
    if (!(sq3(qx, qy, qz) > kValidEps)) continue;
    const float d = fmaxf(sq3(__fsub_rn(qx, cx), __fsub_rn(qy, cy), __fsub_rn(qz, cz)),
                          kValidEps);
    if (!(d <= g.r2)) continue;
    if (!g.knn) {
      flat[hits++] = f;
      if (hits == g.k) break;
      continue;
    }
    // insertion into the ascending K-best list; the strict comparisons keep
    // an earlier slot ahead of a later one at equal distance
    if (hits == g.k && !(d < best[g.k - 1])) continue;
    int s = hits < g.k ? hits++ : g.k - 1;
    while (s > 0 && d < best[s - 1]) {
      best[s] = best[s - 1];
      flat[s] = flat[s - 1];
      --s;
    }
    best[s] = d;
    flat[s] = f;
  }
  return hits;
}

__global__ void window_select_kernel(const float* __restrict__ xyz1,
                                     const float* __restrict__ xyz2,
                                     const int* __restrict__ perm, Geometry g,
                                     int* __restrict__ idx, float* __restrict__ mask) {
  const int n = g.n_h * g.n_w;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= g.B * n) return;
  int flat[kMaxK];
  const int hits = select_centre(xyz1, xyz2, perm, g, gid / n, gid % n, flat);
  int* out_i = idx + static_cast<size_t>(gid) * g.k;
  float* out_m = mask + static_cast<size_t>(gid) * g.k;
  for (int s = 0; s < g.k; ++s) {
    out_i[s] = s < hits ? flat[s] : 0;
    out_m[s] = s < hits ? 1.0f : 0.0f;
  }
}

__global__ void select_and_group_kernel(const float* __restrict__ xyz,
                                        const float* __restrict__ feats,
                                        const int* __restrict__ perm, Geometry g,
                                        int C, float* __restrict__ gxyz,
                                        float* __restrict__ gfeat,
                                        float* __restrict__ mask) {
  const int n = g.n_h * g.n_w;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= g.B * n) return;
  const int b = gid / n;
  int flat[kMaxK];
  const int hits = select_centre(xyz, xyz, perm, g, b, gid % n, flat);
  const size_t pix0 = static_cast<size_t>(b) * g.H2 * g.W2;
  float* out_x = gxyz + static_cast<size_t>(gid) * g.k * 3;
  float* out_f = gfeat + static_cast<size_t>(gid) * g.k * C;
  float* out_m = mask + static_cast<size_t>(gid) * g.k;
  for (int s = 0; s < g.k; ++s) {
    const bool hit = s < hits;
    const size_t pix = pix0 + (hit ? flat[s] : 0);
    for (int ch = 0; ch < 3; ++ch) out_x[s * 3 + ch] = hit ? xyz[pix * 3 + ch] : 0.0f;
    for (int ch = 0; ch < C; ++ch)
      out_f[s * C + ch] = hit ? feats[pix * C + ch] : 0.0f;
    out_m[s] = hit ? 1.0f : 0.0f;
  }
}

Geometry make_geometry(int B, int H1, int W1, int H2, int W2, int kh, int kw,
                       int csh, int csw, int sh, int sw, int k, float r2, int knn) {
  Geometry g;
  g.B = B; g.H1 = H1; g.W1 = W1; g.H2 = H2; g.W2 = W2;
  g.n_h = (H1 + csh - 1) / csh;
  g.n_w = (W1 + csw - 1) / csw;
  g.kh = kh; g.kw = kw; g.csh = csh; g.csw = csw; g.sh = sh; g.sw = sw;
  g.k = k; g.r2 = r2; g.knn = knn;
  return g;
}

int blocks_for(const Geometry& g) {
  return (g.B * g.n_h * g.n_w + kThreads - 1) / kThreads;
}

}  // namespace

extern "C" int elo_max_k() { return kMaxK; }

// idx (B, N, K) int32 flat into H2*W2 (0 where masked), mask (B, N, K) float.
// Returns cudaGetLastError() after the launch.
extern "C" int elo_window_select(const float* xyz1, const float* xyz2, const int* perm,
                                 int B, int H1, int W1, int H2, int W2, int kh, int kw,
                                 int csh, int csw, int sh, int sw, int k, float r2,
                                 int knn, int* idx, float* mask, cudaStream_t stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = make_geometry(B, H1, W1, H2, W2, kh, kw, csh, csw, sh, sw, k, r2, knn);
  window_select_kernel<<<blocks_for(g), kThreads, 0, stream>>>(xyz1, xyz2, perm, g, idx,
                                                                 mask);
  return static_cast<int>(cudaGetLastError());
}

// gxyz (B, N, K, 3), gfeat (B, N, K, C), mask (B, N, K) float; masked slots
// are zero.  Returns cudaGetLastError() after the launch.
extern "C" int elo_select_and_group(const float* xyz, const float* feats, const int* perm,
                                    int B, int H, int W, int C, int kh, int kw, int csh,
                                    int csw, int k, float r2, int knn, float* gxyz,
                                    float* gfeat, float* mask, cudaStream_t stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = make_geometry(B, H, W, H, W, kh, kw, csh, csw, 1, 1, k, r2, knn);
  select_and_group_kernel<<<blocks_for(g), kThreads, 0, stream>>>(xyz, feats, perm, g, C,
                                                                    gxyz, gfeat, mask);
  return static_cast<int>(cudaGetLastError());
}
