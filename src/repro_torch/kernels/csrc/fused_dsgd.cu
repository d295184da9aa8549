// Fused DSGD-momentum update for Hopper (sm_90a), over a list of
// parameter leaves in one launch:
//
//     u' = beta * u + g
//     x' = pre[row] * (x - eta * u')
//
// in f32, written back in the leaves' type (f32 or bf16).  `pre` is one
// float per row, shared by every leaf (the simulation engine folds the
// per-node gossip self-weight diag(W) through it; every leaf has the node
// axis first, so a leaf of n elements over R nodes has rows of n / R), or
// a scalar.
//
// Replaces the TPU kernel fused_dsgd_pallas
// (src/repro/kernels/fused_dsgd.py:50, body _fused_dsgd_kernel at :36).
// The plain version is repro_torch.kernels.ref.fused_dsgd_ref.
//
// Bound on this card (H100 SXM, 3.35 TB/s): 3 reads and 2 writes of each
// leaf and 6 FLOPs per element, so it is bound by bytes, ~5 x the
// leaves' size over 3.35 TB/s (30 GB, 8.95 ms, for gemma3-1b's 1.0 B
// bf16 parameters on 3 nodes).
//
// Design:
//   * one launch over all leaves of one dtype, fed from a segment table
//     passed as a kernel parameter (csrc/multi_tensor.cuh): the training
//     step updates gemma3-1b's 340 leaves, 157 of them 1,152-element
//     norm scales, whose time one launch each was launch and host time.
//     The single-tensor entry is a one-segment table of the same kernel.
//   * a persistent grid walks fixed chunks; each thread keeps kUnroll
//     16-byte vectors of each of x, u and g in flight (8 bf16 or 4 f32
//     each), loaded before any is used, where the leaf's pointers are
//     16-byte aligned and its row length a multiple of the vector; a
//     scalar loop takes the other leaves and a segment's last partial
//     vector.  Indices are 64-bit: a node-stacked embedding leaf is
//     906 M elements at n = 3 and passes 2^31 at n >= 8.
//   * every f32 step is an explicit round-to-nearest intrinsic
//     (__fmul_rn / __fadd_rn / __fsub_rn) in the plain version's order,
//     so nvcc contracts nothing into an FMA and the result equals the
//     plain version bit for bit, in f32 and in bf16 (__float2bfloat16_rn,
//     as PyTorch rounds).
// What it leaves for later: the update still reads and writes every byte
// once per step; fusing it with the gossip mix that follows (one pass
// over the leaves instead of two) is the next saving in bytes.
#include "multi_tensor.cuh"

namespace {

using mt::kThreads;
using mt::kUnroll;

__device__ __forceinline__ void step(float x, float u, float g, float p,
                                     float beta, float eta, float& xn,
                                     float& un) {
  un = __fadd_rn(__fmul_rn(beta, u), g);
  xn = __fmul_rn(p, __fsub_rn(x, __fmul_rn(eta, un)));
}

// Records: x, u, g, x_out, u_out.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_dsgd_kernel(const __grid_constant__ mt::Table t,
                      const float* __restrict__ pre, float pre0, float beta,
                      float eta) {
  constexpr int V = mt::vec_elems<T>();
  mt::for_each_chunk<T>(t, [&](const mt::Chunk& ch) {
    const T* x = reinterpret_cast<const T*>(ch.rec[0]) + ch.begin;
    const T* u = reinterpret_cast<const T*>(ch.rec[1]) + ch.begin;
    const T* g = reinterpret_cast<const T*>(ch.rec[2]) + ch.begin;
    T* xo = reinterpret_cast<T*>(ch.rec[3]) + ch.begin;
    T* uo = reinterpret_cast<T*>(ch.rec[4]) + ch.begin;
    // element i of the chunk lies in row (begin + i) / cols
    auto scale = [&](int64_t i) {
      return pre != nullptr ? __ldg(pre + (ch.begin + i) / ch.cols) : pre0;
    };
    int64_t done = 0;
    if (ch.vec) {
      const int64_t nv = ch.n / V;
      uint4 xr[kUnroll], ur[kUnroll], gr[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int64_t vi = (int64_t)j * kThreads + threadIdx.x;
        if (vi < nv) {
          xr[j] = mt::load16(x + vi * V);
          ur[j] = mt::load16(u + vi * V);
          gr[j] = mt::load16(g + vi * V);
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int64_t vi = (int64_t)j * kThreads + threadIdx.x;
        if (vi < nv) {
          const float p = scale(vi * V);  // cols % V == 0: one row
          float xn[V], un[V];
#pragma unroll
          for (int e = 0; e < V; ++e)
            step(mt::lane<T>(xr[j], e), mt::lane<T>(ur[j], e),
                 mt::lane<T>(gr[j], e), p, beta, eta, xn[e], un[e]);
          mt::store_vec<T, V>(uo + vi * V, un);
          mt::store_vec<T, V>(xo + vi * V, xn);
        }
      }
      done = nv * V;
    }
    for (int64_t i = done + threadIdx.x; i < ch.n; i += kThreads) {
      float xn, un;
      step(mt::to_f32(x[i]), mt::to_f32(u[i]), mt::to_f32(g[i]), scale(i),
           beta, eta, xn, un);
      uo[i] = mt::from_f32<T>(un);
      xo[i] = mt::from_f32<T>(xn);
    }
  });
}

template <typename T>
cudaError_t launch(const uint64_t* words, int nseg, const float* pre,
                   float pre0, float beta, float eta, cudaStream_t stream) {
  mt::Table t;
  const cudaError_t err = mt::fill_table(
      t, words, nseg, 5, mt::chunk_elems<T>(), mt::vec_elems<T>(),
      pre != nullptr);
  if (err != cudaSuccess) return err;
  const int blocks = mt::persistent_blocks<fused_dsgd_kernel<T>>(t.chunks);
  fused_dsgd_kernel<T><<<blocks, kThreads, 0, stream>>>(t, pre, pre0, beta,
                                                         eta);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, the type of every leaf.  words: nseg
// records of 5 pointers (x, u, g, x_out, u_out) and the 4 words of
// csrc/multi_tensor.cuh, a host array; cols of a record is its row length
// where `pre` is given (null: every element scaled by pre0), and is 0
// otherwise.  `pre` holds one float per row, on the card.  Returns the
// cudaError_t of the launch (0 on success); nothing is synchronised.
int repro_fused_dsgd_many(int dtype, const uint64_t* words, int nseg,
                          const float* pre, float pre0, float beta, float eta,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(words, nseg, pre, pre0, beta, eta, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(words, nseg, pre, pre0, beta, eta, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_fused_dsgd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
