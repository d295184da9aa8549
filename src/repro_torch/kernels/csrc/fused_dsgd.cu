// Fused DSGD-momentum update for Hopper (sm_90a), on an (R, C) view of one
// parameter leaf:
//
//     u' = beta * u + g
//     x' = pre[row] * (x - eta * u')
//
// in f32, written back in the leaf's type (f32 or bf16).  `pre` is one
// float per row (the simulation engine folds the per-node gossip
// self-weight diag(W) through it, with nodes on rows) or a scalar.
//
// Replaces the TPU kernel fused_dsgd_pallas
// (src/repro/kernels/fused_dsgd.py:50, body _fused_dsgd_kernel at :36).
// The plain version is repro_torch.kernels.ref.fused_dsgd_ref.
//
// Bound on this card (H100 SXM, 3.35 TB/s): 3 reads and 2 writes of the
// leaf and 6 FLOPs per element, so it is bound by bytes, ~5 x the leaf's
// size over 3.35 TB/s.
//
// Design (simple and correct first):
//   * a grid-stride elementwise loop with 64-bit indices: a node-stacked
//     embedding leaf of gemma3-1b is 906 M elements at n = 3 and passes
//     2^31 at n >= 8.  Rows walk blockIdx.y, columns blockIdx.x, so the
//     row of an element (and its pre) comes without a division.
//   * every f32 step is an explicit round-to-nearest intrinsic
//     (__fmul_rn / __fadd_rn / __fsub_rn) in the plain version's order,
//     so nvcc contracts nothing into an FMA and the result equals the
//     plain version bit for bit, in f32 and in bf16 (__float2bfloat16_rn,
//     as PyTorch rounds).
//   * no tiles, masks or staging: the Pallas (256, 512) VMEM tiling and
//     its ragged-edge mask do not carry over.
// What it leaves for later: 16-byte vector loads, and one launch for all
// leaves of a model instead of one per leaf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kTargetBlocks = 132 * 16;  // 16 blocks per SM
constexpr int64_t kMaxGridY = 65535;

__device__ __forceinline__ float load_f32(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, int64_t i,
                                          float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_dsgd_kernel(const T* __restrict__ x, const T* __restrict__ u,
                      const T* __restrict__ g, T* __restrict__ x_out,
                      T* __restrict__ u_out, const float* __restrict__ pre,
                      float pre0, float beta, float eta, int64_t rows,
                      int64_t cols) {
  const int64_t col0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const float p = pre != nullptr ? pre[r] : pre0;
    const int64_t base = r * cols;
    for (int64_t c = col0; c < cols; c += stride) {
      const int64_t i = base + c;
      const float un =
          __fadd_rn(__fmul_rn(beta, load_f32(u, i)), load_f32(g, i));
      const float xn =
          __fmul_rn(p, __fsub_rn(load_f32(x, i), __fmul_rn(eta, un)));
      store_f32(u_out, i, un);
      store_f32(x_out, i, xn);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* u, const void* g, void* x_out,
                   void* u_out, const float* pre, float pre0, float beta,
                   float eta, int64_t rows, int64_t cols,
                   cudaStream_t stream) {
  const int64_t gy = rows < kMaxGridY ? rows : kMaxGridY;
  int64_t gx = (cols + kThreads - 1) / kThreads;
  const int64_t gx_cap = (kTargetBlocks + gy - 1) / gy;
  if (gx > gx_cap) gx = gx_cap;
  if (gx < 1) gx = 1;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  fused_dsgd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(u),
      static_cast<const T*>(g), static_cast<T*>(x_out),
      static_cast<T*>(u_out), pre, pre0, beta, eta, rows, cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  All five tensors are contiguous
// (rows, cols) of that type; `pre` is null (use pre0) or `rows` floats.
// Returns the cudaError_t of the launch (0 on success); nothing is
// synchronised.
int repro_fused_dsgd(int dtype, const void* x, const void* u, const void* g,
                     void* x_out, void* u_out, const float* pre, float pre0,
                     float beta, float eta, int64_t rows, int64_t cols,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(x, u, g, x_out, u_out, pre, pre0, beta, eta,
                              rows, cols, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, u, g, x_out, u_out, pre, pre0,
                                      beta, eta, rows, cols, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_fused_dsgd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
