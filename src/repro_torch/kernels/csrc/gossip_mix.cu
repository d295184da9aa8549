// Gossip combine for Hopper (sm_90a), over a list of tensors in one
// launch: for each tensor, the weighted sum of its S equal-shape buffers,
// the node's own values and what it received in each slot of a gossip
// round,
//
//     out = sum_s w[s] * bufs[s]        (s = 0 .. S-1, 1 <= S <= 32)
//
// accumulated in f32 in slot order, with one weight vector for the round,
// written in the output type (f32 or bf16; the buffers are f32 or bf16).
//
// Replaces two TPU entry points over one kernel body
// (src/repro/kernels/gossip_mix.py, body _combine at :42):
//   * gossip_mix_slots_pallas (:92): S separate buffers, the distributed
//     runtime's combine (own buffer + each received buffer);
//   * gossip_mix_pallas (:69): one stacked (S, ...) buffer.
// The Python side makes both, and the grouped call over many tensors,
// into segment tables (csrc/multi_tensor.cuh) of this one kernel.  The
// plain version is repro_torch.kernels.ref.gossip_mix_ref, and the result
// equals it bit for bit: every f32 step is an explicit round-to-nearest
// intrinsic in its order (acc = w0*b0, then acc = acc + ws*bs), so nvcc's
// default -fmad=true contracts nothing into an FMA; bf16 is widened
// exactly and the f32 sum rounded once (__float2bfloat16_rn, as PyTorch
// rounds), so a bf16 output equals gossip_mix_ref(...) cast to bf16.
//
// Bound on this card (H100 SXM, 3.35 TB/s): bytes.  S reads of the
// buffers and one write of the output, 2S - 1 FLOPs per element.
//
// Design: one launch per bucket of the distributed mixer (or per call),
// a persistent grid over the table's chunks; each thread keeps kUnroll
// 16-byte vectors of one slot in flight (4 f32 or 8 bf16 each) and
// accumulates them in registers slot by slot, where every pointer of the
// tensor is 16-byte aligned; a scalar loop takes the other tensors and
// each tensor's last partial vector.  The slot pointers sit in the
// segment's record and the weights in the table, both read in place from
// the kernel's parameters.  What it leaves for later: overlapping the
// combine of one bucket with the exchange of the next.
#include "multi_tensor.cuh"

namespace {

using mt::kThreads;
using mt::kUnroll;

// Records: S slot buffers of Tin, then the output of Tout.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
    gossip_mix_kernel(const __grid_constant__ mt::Table t) {
  constexpr int V = mt::vec_elems<Tin>();
  const int S = t.nptr - 1;
  mt::for_each_chunk<Tin>(t, [&](const mt::Chunk& ch) {
    auto buf = [&](int s) {
      return reinterpret_cast<const Tin*>(ch.rec[s]) + ch.begin;
    };
    Tout* out = reinterpret_cast<Tout*>(ch.rec[S]) + ch.begin;
    int64_t done = 0;
    if (ch.vec) {
      const int64_t nv = ch.n / V;
      float acc[kUnroll][V];
      uint4 r[kUnroll];
      for (int s = 0; s < S; ++s) {
        const Tin* b = buf(s);
        const float w = t.weight[s];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          const int64_t vi = (int64_t)j * kThreads + threadIdx.x;
          r[j] = vi < nv ? mt::load16(b + vi * V) : make_uint4(0, 0, 0, 0);
        }
        if (s == 0) {
#pragma unroll
          for (int j = 0; j < kUnroll; ++j)
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[j][e] = __fmul_rn(w, mt::lane<Tin>(r[j], e));
        } else {
#pragma unroll
          for (int j = 0; j < kUnroll; ++j)
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[j][e] =
                  __fadd_rn(acc[j][e], __fmul_rn(w, mt::lane<Tin>(r[j], e)));
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int64_t vi = (int64_t)j * kThreads + threadIdx.x;
        if (vi < nv) mt::store_vec<Tout, V>(out + vi * V, acc[j]);
      }
      done = nv * V;
    }
    for (int64_t i = done + threadIdx.x; i < ch.n; i += kThreads) {
      float acc = __fmul_rn(t.weight[0], mt::to_f32(buf(0)[i]));
      for (int s = 1; s < S; ++s)
        acc = __fadd_rn(acc, __fmul_rn(t.weight[s], mt::to_f32(buf(s)[i])));
      out[i] = mt::from_f32<Tout>(acc);
    }
  });
}

template <typename Tin, typename Tout>
cudaError_t launch(const uint64_t* words, int nseg, int nslots,
                   const float* w, cudaStream_t stream) {
  mt::Table t;
  const cudaError_t err =
      mt::fill_table(t, words, nseg, nslots + 1, mt::chunk_elems<Tin>(),
                     mt::vec_elems<Tin>(), false);
  if (err != cudaSuccess) return err;
  for (int s = 0; s < mt::kMaxWeights; ++s)
    t.weight[s] = s < nslots ? w[s] : 0.f;
  const int blocks =
      mt::persistent_blocks<gossip_mix_kernel<Tin, Tout>>(t.chunks);
  gossip_mix_kernel<Tin, Tout><<<blocks, kThreads, 0, stream>>>(t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16, the type of every
// slot buffer / of every output.  words: nseg records of nslots + 1
// pointers (the slot buffers in slot order, then the output, which
// aliases no buffer) and the 4 words of csrc/multi_tensor.cuh (cols 0), a
// host array; w: nslots floats, a host array, 1 <= nslots <= 32.  Returns
// the cudaError_t of the launch (0 on success); nothing is synchronised.
int repro_gossip_mix_many(int in_dtype, int out_dtype, const uint64_t* words,
                          int nseg, int nslots, const float* w,
                          void* stream) {
  if (nslots < 1 || nslots > mt::kMaxWeights || w == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (in_dtype == 0 && out_dtype == 0)
    return (int)launch<float, float>(words, nseg, nslots, w, s);
  if (in_dtype == 0 && out_dtype == 1)
    return (int)launch<float, bf16>(words, nseg, nslots, w, s);
  if (in_dtype == 1 && out_dtype == 0)
    return (int)launch<bf16, float>(words, nseg, nslots, w, s);
  if (in_dtype == 1 && out_dtype == 1)
    return (int)launch<bf16, bf16>(words, nseg, nslots, w, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_gossip_mix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
