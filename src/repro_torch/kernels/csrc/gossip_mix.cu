// Gossip combine for Hopper (sm_90a): the weighted sum of S equal-shape
// buffers, the node's own values and what it received in each slot of a
// gossip round,
//
//     out = sum_s w[s] * bufs[s]        (s = 0 .. S-1, 1 <= S <= 32)
//
// accumulated in f32 in slot order, written back in the buffers' type
// (f32 or bf16).
//
// Replaces two TPU entry points over one kernel body
// (src/repro/kernels/gossip_mix.py, body _combine at :42):
//   * gossip_mix_slots_pallas (:92): S separate buffers, the distributed
//     runtime's combine (own buffer + each received buffer);
//   * gossip_mix_pallas (:69): one stacked (S, ...) buffer.
// Both C entry points below fill the same slot table and launch the same
// kernel.  The plain version is repro_torch.kernels.ref.gossip_mix_ref,
// and the result equals it bit for bit: every f32 step is an explicit
// round-to-nearest intrinsic in its order (acc = w0*b0, then
// acc = acc + ws*bs), so nvcc's default -fmad=true contracts nothing into
// an FMA; bf16 is widened exactly and the sum rounded once
// (__float2bfloat16_rn, as PyTorch rounds).
//
// Bound on this card (H100 SXM, 3.35 TB/s): bytes.  S reads and one write
// of the buffer, 2S - 1 FLOPs per element.
//
// Design (simple and correct first): a grid-stride loop over the flat
// elements with 64-bit indices (one f32 work buffer of gemma3-1b's
// embedding is 302 M elements), 16-byte vector loads and stores where
// every pointer is 16-byte aligned (4 f32 or 8 bf16 per thread), and a
// scalar tail.  S is a runtime argument: the pointers and weights travel
// in a parameter struct, and the slot loop is unrolled over the table's
// 32 entries with a guard, so every access is a constant offset into the
// kernel's parameters.  What it leaves for later: mixing all tensors of a
// model in one launch, and overlapping the combine with the next
// tensor's receive.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 32;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

struct Slots {
  const void* buf[kMaxSlots];
  float w[kMaxSlots];
  int n;
  int vec;  // every pointer 16-byte aligned: take the vector loop
};

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

// 16 bytes at vector index vi: 4 f32 or 8 bf16, widened to f32.
__device__ __forceinline__ void load_vec(const float* p, int64_t vi,
                                         float (&x)[4]) {
  const float4 v = reinterpret_cast<const float4*>(p)[vi];
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, int64_t vi,
                                         float (&x)[8]) {
  const uint4 v = reinterpret_cast<const uint4*>(p)[vi];
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = __bfloat162float(h[j]);
}
__device__ __forceinline__ void store_vec(float* p, int64_t vi,
                                          const float (&x)[4]) {
  reinterpret_cast<float4*>(p)[vi] = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, int64_t vi,
                                          const float (&x)[8]) {
  uint4 v;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16_rn(x[j]);
  reinterpret_cast<uint4*>(p)[vi] = v;
}

template <typename T>
__device__ __forceinline__ float combine_one(const Slots& s, int64_t i) {
  float acc = __fmul_rn(s.w[0], load_f32(static_cast<const T*>(s.buf[0]), i));
#pragma unroll
  for (int k = 1; k < kMaxSlots; ++k) {
    if (k >= s.n) break;
    acc = __fadd_rn(
        acc, __fmul_rn(s.w[k], load_f32(static_cast<const T*>(s.buf[k]), i)));
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gossip_mix_kernel(const Slots s, T* __restrict__ out, int64_t n) {
  constexpr int V = 16 / sizeof(T);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t done = 0;
  if (s.vec) {
    const int64_t nv = n / V;
    for (int64_t vi = tid; vi < nv; vi += stride) {
      float acc[V], x[V];
      load_vec(static_cast<const T*>(s.buf[0]), vi, x);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = __fmul_rn(s.w[0], x[j]);
#pragma unroll
      for (int k = 1; k < kMaxSlots; ++k) {
        if (k >= s.n) break;
        load_vec(static_cast<const T*>(s.buf[k]), vi, x);
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(s.w[k], x[j]));
      }
      store_vec(out, vi, acc);
    }
    done = nv * V;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    store_f32(out, i, combine_one<T>(s, i));
}

template <typename T>
cudaError_t launch(const Slots& s, void* out, int64_t n, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int64_t per_thread = s.vec ? V : 1;
  int64_t blocks = (n / per_thread + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  gossip_mix_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      s, static_cast<T*>(out), n);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int run(int dtype, Slots& s, void* out, int64_t n, void* stream) {
  if (n < 1 || s.n < 1 || s.n > kMaxSlots || out == nullptr)
    return (int)cudaErrorInvalidValue;
  s.vec = aligned16(out);
  for (int k = 0; k < s.n; ++k) {
    if (s.buf[k] == nullptr) return (int)cudaErrorInvalidValue;
    s.vec = s.vec && aligned16(s.buf[k]);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(s, out, n, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(s, out, n, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  bufs: n_slots pointers (a host
// array) to contiguous buffers of n elements of that type; w: n_slots
// floats (a host array); out: n elements, aliasing no buffer.  Returns
// the cudaError_t of the launch (0 on success); nothing is synchronised.
int repro_gossip_mix_slots(int dtype, const void* const* bufs,
                           const float* w, int n_slots, void* out, int64_t n,
                           void* stream) {
  if (n_slots < 1 || n_slots > kMaxSlots) return (int)cudaErrorInvalidValue;
  Slots s{};
  s.n = n_slots;
  for (int k = 0; k < n_slots; ++k) {
    s.buf[k] = bufs[k];
    s.w[k] = w[k];
  }
  return run(dtype, s, out, n, stream);
}

// The stacked entry: slot k is the k-th of n_slots contiguous blocks of
// n elements starting at `stack`.
int repro_gossip_mix_stacked(int dtype, const void* stack, const float* w,
                             int n_slots, void* out, int64_t n,
                             void* stream) {
  if (n_slots < 1 || n_slots > kMaxSlots) return (int)cudaErrorInvalidValue;
  const size_t elt = dtype == 1 ? sizeof(__nv_bfloat16) : sizeof(float);
  Slots s{};
  s.n = n_slots;
  for (int k = 0; k < n_slots; ++k) {
    s.buf[k] = static_cast<const char*>(stack) + (size_t)k * (size_t)n * elt;
    s.w[k] = w[k];
  }
  return run(dtype, s, out, n, stream);
}

const char* repro_gossip_mix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
