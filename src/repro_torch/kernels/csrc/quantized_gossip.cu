// Quantize + EF21 residual for compressed gossip, for Hopper (sm_90a),
// over a list of (R, C) chunk-row buffers in one launch (C = the codec's
// chunk, one scale per row; one buffer per reference leaf of a bucket):
//
//     s      = x + err                       (err optional)
//     scale  = amax_row(|s|) > 0 ? amax * float32(1/QMAX) : 1
//     q      = SR(s / scale)                 int8, or fp8 e4m3fn
//     resid  = s - q * scale
//
// SR is stochastic rounding whose noise is a hash of (key, global element
// index) with index = ((row + row_offset) * C + col) mod 2^32, each buffer
// with its own row_offset, so a node's rows quantized alone give the bits
// of the node-stacked array.  int8: floor(v + u), u = float32(h) * 2^-32,
// clipped to +-127.  fp8: the 20 low hash bits are added below e4m3's
// 3-bit mantissa and the f32 bits truncated there, clipped to +-448, then
// cast, rounding to nearest even (e4m3's subnormal tail is the only place
// that cast rounds).
//
// Replaces the TPU kernel quantize_ef_pallas
// (src/repro/kernels/quantized_gossip.py:71, body _quantize_ef_kernel at
// :47).  The plain version is repro_torch.kernels.ref.quantize_ef_ref, and
// the payload is a bitwise contract: q, scale and resid equal it bit for
// bit.  For that, every f32 step is an explicit round-to-nearest
// intrinsic in the plain version's order (nvcc's default -fmad=true would
// contract q * scale and s - hat into an FMA), the division is IEEE
// (__fdiv_rn; never build with --use_fast_math), the hash runs in
// uint32_t, and the fp8 cast is the hardware's satfinite round-to-nearest.
//
// Bound on this card (H100 SXM, 3.35 TB/s): bytes.  13 B per element with
// err (read x and err, 4 B each; write q, 1 B, and resid, 4 B), 9 B
// without, plus 4 B per row for the scale; ~30 integer and float
// operations per element are far below the card's rates.
//
// Design: one launch per table of segments (csrc/multi_tensor.cuh's row
// tables, a __grid_constant__ parameter: up to 396 buffers with err),
// over a persistent grid of chunks of whole rows, one warp per row.  At
// C = 256 with 16-byte aligned buffers (the compressed paths' chunk) a
// lane holds 8 contiguous elements of the row: x and err are read once
// into registers with two 16-byte streaming loads each, the amax is a
// warp-shuffle max over them, and q (one 8-byte store per lane), resid
// (two 16-byte streaming stores) and the scale (lane 0) are written from
// the registers.  Any other C, or a buffer the 16-byte loads cannot read,
// takes a scalar loop that reads the row twice (amax, then quantize),
// flagged per segment in the table and re-checked by the host code.
// Indices are 64-bit (a node-stacked embedding of gemma3-1b is 906 M
// elements at n = 3).  What it leaves for later: reading the bf16 leaf
// directly instead of the f32 chunk rows the layout makes, and fusing the
// decode and the mix into the same pass.
//
// The second kernel here is the compressed gossip round's combine, on
// each buffer's own exact chunk rows and the S payloads it received:
//
//     out = w[0] * own + sum_s w[s+1] * (q_s * scale_s)     (f32, s in order)
//
// own (R, C) f32, q_s (R, C) int8 or fp8 e4m3fn, scale_s (R, 1) f32,
// 0 <= S <= 31, one weight vector for the round.  It replaces the TPU
// kernel quantized_gossip_mix_slots_pallas
// (src/repro/kernels/quantized_gossip.py:115, body _qmix_slots_kernel at
// :101); the plain version is
// repro_torch.kernels.ref.quantized_gossip_mix_ref, bit for bit: explicit
// _rn products and sums in its order, and the payload decoded as the
// quantize kernel decodes it (int8 exactly; fp8 through the hardware's
// e4m3 -> half conversion, exact for every finite code).  Bound: bytes,
// 8 + S B per element (own and out 4 B each, one payload byte per slot)
// plus 4 B per row and slot.  Design: one launch per table over a bucket
// of reference leaves, one warp per row; lane s loads slot s's scale of
// the row once and the slot loop takes it by a shuffle; where C is a
// multiple of 128 and the buffers are 16-byte aligned, a lane reads 4
// contiguous elements of own per 16-byte load and their 4 codes of each
// payload per 4-byte load, two 128-column spans at a time, every load
// of a span issued before its arithmetic, and writes out in 16 bytes;
// else a scalar loop.
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "multi_tensor.cuh"

namespace {

using mt::kThreads;
using mt::kWarps;

constexpr int kQuantVecCols = 256;   // the quantize kernel's vector rows
constexpr int kMixVecCols = 128;     // one 16-byte vector of own per lane
constexpr int kMaxMixSlots = mt::kMaxWeights - 1;
constexpr int kSlotBatch = 4;        // payload loads in flight per span

__device__ __forceinline__ uint32_t sr_bits(uint32_t key, uint32_t idx) {
  uint32_t h = idx * 0x9E3779B1u;
  h ^= key;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// kFmt: 0 = int8, 1 = fp8 e4m3fn.  Sets q's byte and returns q as f32.
template <int kFmt>
__device__ __forceinline__ float quantize(float v, uint32_t h, uint8_t& q) {
  if (kFmt == 0) {
    const float u = __fmul_rn(__uint2float_rn(h), 0x1p-32f);
    const float r = fminf(fmaxf(floorf(__fadd_rn(v, u)), -127.0f), 127.0f);
    q = (uint8_t)(int8_t)r;
    return r;
  } else {
    uint32_t b = __float_as_uint(v);
    b = (b + (h & 0xFFFFFu)) & 0xFFF00000u;
    const float w = fminf(fmaxf(__uint_as_float(b), -448.0f), 448.0f);
    const __nv_fp8_storage_t f8 =
        __nv_cvt_float_to_fp8(w, __NV_SATFINITE, __NV_E4M3);
    q = (uint8_t)f8;
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(f8, __NV_E4M3)));
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  return v;
}

__device__ __forceinline__ float row_scale(float amax, float inv_qmax) {
  return amax > 0.0f ? __fmul_rn(amax, inv_qmax) : 1.0f;
}

// One row of C = 256 held in registers: lane l owns columns 8l .. 8l+7.
template <int kFmt, bool kWithErr>
__device__ __forceinline__ void quantize_row_vec(
    const float* __restrict__ x, const float* __restrict__ err,
    uint8_t* __restrict__ q, float* __restrict__ resid, float& sc_out,
    uint32_t key, uint32_t idx0, float inv_qmax, int lane) {
  const int64_t off = (int64_t)lane * 8;
  uint4 raw[2], eraw[2] = {};
  raw[0] = mt::load16(x + off);
  raw[1] = mt::load16(x + off + 4);
  if (kWithErr) {
    eraw[0] = mt::load16(err + off);
    eraw[1] = mt::load16(err + off + 4);
  }
  float s[8];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = mt::lane<float>(raw[j], e);
      s[4 * j + e] = kWithErr ? __fadd_rn(v, mt::lane<float>(eraw[j], e))
                              : v;
      amax = fmaxf(amax, fabsf(s[4 * j + e]));
    }
  const float sc = row_scale(warp_max(amax), inv_qmax);
  sc_out = sc;
  uint2 qv = make_uint2(0u, 0u);   // the 8 codes, packed in registers
  float res[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t h = sr_bits(key, idx0 + (uint32_t)(off + e));
    uint8_t b;
    const float qf = quantize<kFmt>(__fdiv_rn(s[e], sc), h, b);
    res[e] = __fsub_rn(s[e], __fmul_rn(qf, sc));
    if (e < 4)
      qv.x |= (uint32_t)b << (8 * e);
    else
      qv.y |= (uint32_t)b << (8 * (e - 4));
  }
  __stcs(reinterpret_cast<uint2*>(q + off), qv);
  mt::store_vec<float, 8>(resid + off, res);
}

// One row of any C >= 1, read twice: once for the amax, once to quantize.
template <int kFmt, bool kWithErr>
__device__ __forceinline__ void quantize_row_scalar(
    const float* __restrict__ x, const float* __restrict__ err,
    uint8_t* __restrict__ q, float* __restrict__ resid, float& sc_out,
    uint32_t key, uint32_t idx0, float inv_qmax, int64_t cols, int lane) {
  float amax = 0.0f;
  for (int64_t c = lane; c < cols; c += 32)
    amax = fmaxf(amax, fabsf(kWithErr ? __fadd_rn(x[c], err[c]) : x[c]));
  const float sc = row_scale(warp_max(amax), inv_qmax);
  sc_out = sc;
  for (int64_t c = lane; c < cols; c += 32) {
    const float s = kWithErr ? __fadd_rn(x[c], err[c]) : x[c];
    const uint32_t h = sr_bits(key, idx0 + (uint32_t)c);
    const float qf = quantize<kFmt>(__fdiv_rn(s, sc), h, q[c]);
    resid[c] = __fsub_rn(s, __fmul_rn(qf, sc));
  }
}

// Records: x, [err], q, scale, resid.
template <int kFmt, bool kWithErr>
__global__ void __launch_bounds__(kThreads)
    quantize_ef_kernel(const __grid_constant__ mt::Table t, uint32_t key,
                       float inv_qmax) {
  constexpr int kE = kWithErr ? 1 : 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  mt::for_each_row_chunk(t, [&](const mt::RowChunk& ch) {
    const float* x = reinterpret_cast<const float*>(ch.rec[0]);
    const float* err =
        kWithErr ? reinterpret_cast<const float*>(ch.rec[1]) : nullptr;
    uint8_t* q = reinterpret_cast<uint8_t*>(ch.rec[1 + kE]);
    float* scale = reinterpret_cast<float*>(ch.rec[2 + kE]);
    float* resid = reinterpret_cast<float*>(ch.rec[3 + kE]);
    const int64_t C = ch.cols;
    for (int64_t r = ch.row0 + warp; r < ch.row0 + ch.rows; r += kWarps) {
      const int64_t base = r * C;
      // the reference's int32 index arithmetic, cast to uint32: mod 2^32
      const uint32_t idx0 =
          (uint32_t)(((uint64_t)r + ch.row_offset) * (uint64_t)C);
      float sc;
      if (ch.vec)
        quantize_row_vec<kFmt, kWithErr>(
            x + base, kWithErr ? err + base : nullptr, q + base,
            resid + base, sc, key, idx0, inv_qmax, lane);
      else
        quantize_row_scalar<kFmt, kWithErr>(
            x + base, kWithErr ? err + base : nullptr, q + base,
            resid + base, sc, key, idx0, inv_qmax, C, lane);
      if (lane == 0) scale[r] = sc;
    }
  });
}

template <int kFmt, bool kWithErr>
cudaError_t launch_quantize(const uint64_t* words, int nseg, uint32_t key,
                            float inv_qmax, cudaStream_t stream) {
  mt::Table t;
  const cudaError_t err = mt::fill_row_table(
      t, words, nseg, kWithErr ? 5 : 4, kQuantVecCols, kQuantVecCols);
  if (err != cudaSuccess) return err;
  const int blocks =
      mt::persistent_blocks<quantize_ef_kernel<kFmt, kWithErr>>(t.chunks);
  quantize_ef_kernel<kFmt, kWithErr><<<blocks, kThreads, 0, stream>>>(
      t, key, inv_qmax);
  return cudaGetLastError();
}

template <int kFmt>
__device__ __forceinline__ float decode(uint32_t b) {
  if (kFmt == 0) return __int2float_rn((int)(int8_t)(uint8_t)b);
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(
      (__nv_fp8_storage_t)(uint8_t)b, __NV_E4M3)));
}

__device__ __forceinline__ float slot_scale(float mine, int k) {
  return __shfl_sync(0xFFFFFFFFu, mine, k);
}

// One row, C a multiple of 128, 16-byte aligned: lane l owns columns
// 128 j + 4 l .. + 3 of each span j, two spans per pass.
template <int kFmt>
__device__ __forceinline__ void mix_row_vec(
    const mt::Table& t, const uint64_t* rec, int S, int64_t base,
    int64_t cols, float my_sc, int lane) {
  const float* own = reinterpret_cast<const float*>(rec[0]) + base;
  float* out = reinterpret_cast<float*>(rec[2 * S + 1]) + base;
  const int64_t spans = cols / kMixVecCols;
  for (int64_t j0 = 0; j0 < spans; j0 += 2) {
    const bool two = j0 + 1 < spans;
    const int64_t off0 = j0 * kMixVecCols + 4 * lane;
    const int64_t off1 = off0 + kMixVecCols;
    uint4 o[2];
    o[0] = mt::load16(own + off0);
    o[1] = two ? mt::load16(own + off1) : make_uint4(0, 0, 0, 0);
    float acc[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[h][e] = __fmul_rn(t.weight[0], mt::lane<float>(o[h], e));
    for (int k0 = 0; k0 < S; k0 += kSlotBatch) {
      uint32_t w[kSlotBatch][2];
#pragma unroll
      for (int b = 0; b < kSlotBatch; ++b) {
        const int k = k0 + b;
        const uint8_t* qk =
            k < S ? reinterpret_cast<const uint8_t*>(rec[1 + k]) + base
                  : nullptr;
        w[b][0] = k < S ? __ldcs(reinterpret_cast<const unsigned int*>(
                              qk + off0))
                        : 0u;
        w[b][1] = k < S && two ? __ldcs(reinterpret_cast<const unsigned int*>(
                                     qk + off1))
                               : 0u;
      }
#pragma unroll
      for (int b = 0; b < kSlotBatch; ++b) {
        const int k = k0 + b;
        if (k >= S) break;
        const float sc = slot_scale(my_sc, k);
        const float wk = t.weight[k + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float hat =
                __fmul_rn(decode<kFmt>(w[b][h] >> (8 * e)), sc);
            acc[h][e] = __fadd_rn(acc[h][e], __fmul_rn(wk, hat));
          }
      }
    }
    mt::store_vec<float, 4>(out + off0, acc[0]);
    if (two) mt::store_vec<float, 4>(out + off1, acc[1]);
  }
}

// One row of any C: lane l takes columns l, l + 32, ...
template <int kFmt>
__device__ __forceinline__ void mix_row_scalar(
    const mt::Table& t, const uint64_t* rec, int S, int64_t base,
    int64_t cols, float my_sc, int lane) {
  const float* own = reinterpret_cast<const float*>(rec[0]) + base;
  float* out = reinterpret_cast<float*>(rec[2 * S + 1]) + base;
  for (int64_t c0 = 0; c0 < cols; c0 += 32) {
    const int64_t c = c0 + lane;
    const bool in = c < cols;
    float acc = in ? __fmul_rn(t.weight[0], own[c]) : 0.0f;
    for (int k = 0; k < S; ++k) {
      const float sc = slot_scale(my_sc, k);   // every lane takes part
      if (in) {
        const uint8_t* qk = reinterpret_cast<const uint8_t*>(rec[1 + k]);
        const float hat = __fmul_rn(decode<kFmt>(qk[base + c]), sc);
        acc = __fadd_rn(acc, __fmul_rn(t.weight[k + 1], hat));
      }
    }
    if (in) out[c] = acc;
  }
}

// Records: own, q_1 .. q_S, scale_1 .. scale_S, out.
template <int kFmt>
__global__ void __launch_bounds__(kThreads)
    quantized_gossip_mix_kernel(const __grid_constant__ mt::Table t) {
  const int S = (t.nptr - 2) / 2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  mt::for_each_row_chunk(t, [&](const mt::RowChunk& ch) {
    for (int64_t r = ch.row0 + warp; r < ch.row0 + ch.rows; r += kWarps) {
      // lane s holds slot s's scale of the row: one load per slot and row
      const float my_sc =
          lane < S ? reinterpret_cast<const float*>(ch.rec[1 + S + lane])[r]
                   : 0.0f;
      if (ch.vec)
        mix_row_vec<kFmt>(t, ch.rec, S, r * ch.cols, ch.cols, my_sc, lane);
      else
        mix_row_scalar<kFmt>(t, ch.rec, S, r * ch.cols, ch.cols, my_sc,
                             lane);
    }
  });
}

template <int kFmt>
cudaError_t launch_mix(const uint64_t* words, int nseg, int nslots,
                       const float* w, cudaStream_t stream) {
  mt::Table t;
  const cudaError_t err =
      mt::fill_row_table(t, words, nseg, 2 * nslots + 2, kMixVecCols,
                         INT64_MAX);
  if (err != cudaSuccess) return err;
  for (int s = 0; s < mt::kMaxWeights; ++s)
    t.weight[s] = s <= nslots ? w[s] : 0.f;
  const int blocks =
      mt::persistent_blocks<quantized_gossip_mix_kernel<kFmt>>(t.chunks);
  quantized_gossip_mix_kernel<kFmt><<<blocks, kThreads, 0, stream>>>(t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fmt: 0 = int8, 1 = fp8 e4m3fn; with_err: 1 where every record carries
// err.  words: nseg records of csrc/multi_tensor.cuh's row tables (a host
// array): the pointers x, err (with_err only), q, scale, resid, then
// numel, cols (>= 2), chunk_end, vec and row_offset.  x, err and resid are
// contiguous (rows, cols) float32, q (rows, cols) bytes, scale rows
// floats; no output aliases an input.  inv_qmax is float32(1 / 127) or
// float32(1 / 448).  Returns the cudaError_t of the launch (0 on success);
// nothing is synchronised.
int repro_quantize_ef_many(int fmt, int with_err, const uint64_t* words,
                           int nseg, uint32_t key, float inv_qmax,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nptr = with_err ? 5 : 4;
  if (words == nullptr || nseg < 1 ||
      (int64_t)nseg * (nptr + mt::kRowMeta) > mt::kTableWords)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nseg; ++i)
    if (words[(int64_t)i * (nptr + mt::kRowMeta) + nptr + mt::kCols] < 2)
      return (int)cudaErrorInvalidValue;
  if (fmt == 0 && !with_err)
    return (int)launch_quantize<0, false>(words, nseg, key, inv_qmax, s);
  if (fmt == 0)
    return (int)launch_quantize<0, true>(words, nseg, key, inv_qmax, s);
  if (fmt == 1 && !with_err)
    return (int)launch_quantize<1, false>(words, nseg, key, inv_qmax, s);
  if (fmt == 1)
    return (int)launch_quantize<1, true>(words, nseg, key, inv_qmax, s);
  return (int)cudaErrorInvalidValue;
}

// fmt: 0 = int8, 1 = fp8 e4m3fn, the type of every payload.  words: nseg
// row-table records of 2 * nslots + 2 pointers (own, the nslots payloads
// in slot order, their nslots scales, out) and the 5 words; own and out
// contiguous (rows, cols) float32, out aliasing nothing; a payload
// (rows, cols) bytes, a scale rows floats.  w: nslots + 1 floats (a host
// array), the own value's weight first, 0 <= nslots <= 31.  Returns the
// cudaError_t of the launch (0 on success); nothing is synchronised.
int repro_quantized_gossip_mix_many(int fmt, const uint64_t* words, int nseg,
                                    int nslots, const float* w,
                                    void* stream) {
  if (nslots < 0 || nslots > kMaxMixSlots || w == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fmt == 0) return (int)launch_mix<0>(words, nseg, nslots, w, st);
  if (fmt == 1) return (int)launch_mix<1>(words, nseg, nslots, w, st);
  return (int)cudaErrorInvalidValue;
}

const char* repro_quantize_ef_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
