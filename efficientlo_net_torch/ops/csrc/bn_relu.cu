// Eval-mode batch norm and ReLU in one pass over a dense layer's output, for sm_90a.
//
// Replaces no TPU kernel.  In the JAX package XLA fuses the eval-mode batch
// norm of every ConvMLP layer (efficientlo_net_tpu/models/layers.py) and its
// ReLU into one pass.  Eager PyTorch runs the chain of
// efficientlo_net_torch/models/layers.py (ScheduledBatchNorm in eval, then
// torch.relu) as seven kernels: var + eps and rsqrt on C values, then
// x - mean, * inv, * scale and + bias, each of which reads and writes the
// whole activation with a broadcast (C,) operand, then the ReLU.  This kernel
// is that chain in one read and one write of x.
//
// What it computes.  x is (rows, C) float32, contiguous; mean, var, scale and
// bias are (C,).  y = relu(((x - mean) * inv) * scale + bias) with
// inv = rsqrtf(var + eps).  Every step is one IEEE operation rounded to
// nearest, in the chain's order (__fsub_rn, __fmul_rn, __fmul_rn, __fadd_rn:
// no FMA contraction), rsqrtf is what torch.rsqrt computes on the card, and
// the ReLU is torch.relu's (clamp_min: NaN kept, else fmaxf(v, 0)).  So y
// equals the eager chain bit for bit.
//
// What bounds it.  Bytes: 8 bytes an element (one read, one write) against
// five operations.  An HDL-64 eval frame normalises 48.5 M elements over the
// network's 89 layers: 0.39 GB, ~0.12 ms at 3.35 TB/s.
//
// The design.  A thread keeps one group of V channels for all its work, so
// the per-channel values (and inv) sit in its registers, loaded once: the
// threads of a block cover floor(256 / (C/V)) rows side by side (channel
// group = thread % (C/V)), and each block takes whole rows.  With
// C % 4 == 0 (every width of the network: 8 to 128) V = 4, and each load and
// store moves 16 bytes, neighbouring threads on neighbouring addresses;
// otherwise V = 1.  Each thread has kUnroll loads in flight before it
// computes.  The grid gives every block its own kUnroll steps of rows (it
// strides over rows only beyond kMaxBlocks blocks): on the H100 that moved
// 2.87-2.99 TB/s, torch.relu's rate, where a grid-stride loop over 8 or 16
// blocks an SM moved 2.71-2.87.  Wider than 256 groups, a thread walks over
// several groups in turn.  No shared memory and no tensor cores: there is
// nothing to share between threads and no matrix product.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                 // loads a thread has in flight
constexpr long long kMaxBlocks = 1LL << 20;  // beyond it the blocks stride over rows

template <int V> struct Vec;
template <> struct Vec<1> { using type = float; };
template <> struct Vec<4> { using type = float4; };

__device__ __forceinline__ float& lane(float& v, int) { return v; }
__device__ __forceinline__ float& lane(float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float bn_relu1(float x, float mean, float inv, float scale,
                                          float bias) {
  const float v = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), inv), scale), bias);
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

// x and y as (rows, groups) arrays of V-float vectors.
template <int V>
__global__ void __launch_bounds__(kThreads)
bn_relu_kernel(const typename Vec<V>::type* __restrict__ x, long long rows, int groups,
               const float* __restrict__ mean, const float* __restrict__ var,
               const float* __restrict__ scale, const float* __restrict__ bias, float eps,
               typename Vec<V>::type* __restrict__ y) {
  using T = typename Vec<V>::type;
  const int per_row = groups < kThreads ? groups : kThreads;  // groups a pass covers
  const int rows_per_step = kThreads / per_row;
  const int r0 = threadIdx.x / per_row;
  if (r0 >= rows_per_step) return;  // the threads left over when per_row does not divide 256
  const long long rows_per_block = static_cast<long long>(rows_per_step) * kUnroll;
  const long long row_stride = rows_per_block * gridDim.x;
  for (int g = threadIdx.x % per_row; g < groups; g += per_row) {
    float m[V], inv[V], s[V], b[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = g * V + v;
      m[v] = __ldg(mean + c);
      inv[v] = rsqrtf(__fadd_rn(__ldg(var + c), eps));
      s[v] = __ldg(scale + c);
      b[v] = __ldg(bias + c);
    }
    for (long long r = blockIdx.x * rows_per_block + r0; r < rows; r += row_stride) {
      T in[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = r + static_cast<long long>(u) * rows_per_step;
        if (row < rows) in[u] = x[row * groups + g];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = r + static_cast<long long>(u) * rows_per_step;
        if (row < rows) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            lane(in[u], v) = bn_relu1(lane(in[u], v), m[v], inv[v], s[v], b[v]);
          y[row * groups + g] = in[u];
        }
      }
    }
  }
}

template <int V>
int launch(const float* x, long long rows, int C, const float* mean, const float* var,
           const float* scale, const float* bias, float eps, float* y, cudaStream_t stream) {
  using T = typename Vec<V>::type;
  const int groups = C / V;
  const int per_row = groups < kThreads ? groups : kThreads;
  const long long rows_per_block = static_cast<long long>(kThreads / per_row) * kUnroll;
  const long long wanted = (rows + rows_per_block - 1) / rows_per_block;
  const int blocks = static_cast<int>(wanted < kMaxBlocks ? wanted : kMaxBlocks);
  bn_relu_kernel<V><<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const T*>(x), rows, groups, mean, var, scale, bias, eps,
      reinterpret_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

// y (rows, C) = relu(((x - mean) * rsqrtf(var + eps)) * scale + bias), all
// float32 and contiguous, on `stream`.  Returns cudaGetLastError() after the
// launch (nothing is launched for rows == 0).
extern "C" int elo_bn_relu(const float* x, long long rows, int C, const float* mean,
                           const float* var, const float* scale, const float* bias, float eps,
                           float* y, cudaStream_t stream) {
  if (rows == 0) return static_cast<int>(cudaSuccess);
  if (rows < 0 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (C % 4 == 0 && aligned16(x) && aligned16(y))
    return launch<4>(x, rows, C, mean, var, scale, bias, eps, y, stream);
  return launch<1>(x, rows, C, mean, var, scale, bias, eps, y, stream);
}
