// Quantize + EF21 residual for compressed gossip, for Hopper (sm_90a), on
// one (R, C) chunk-row buffer (C = the codec's chunk, one scale per row):
//
//     s      = x + err                       (err optional)
//     scale  = amax_row(|s|) > 0 ? amax * float32(1/QMAX) : 1
//     q      = SR(s / scale)                 int8, or fp8 e4m3fn
//     resid  = s - q * scale
//
// SR is stochastic rounding whose noise is a hash of (key, global element
// index) with index = ((row + row_offset) * C + col) mod 2^32, so a node's
// rows quantized alone give the bits of the node-stacked array.  int8:
// floor(v + u), u = float32(h) * 2^-32, clipped to +-127.  fp8: the 20 low
// hash bits are added below e4m3's 3-bit mantissa and the f32 bits
// truncated there, clipped to +-448, then cast, rounding to nearest even
// (e4m3's subnormal tail is the only place that cast rounds).
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
// operations per element are far below the card's rates.  The simplified
// design reads each row twice, once for the amax and once to quantize
// (the second read mostly hits L1/L2 for C = 256).
//
// Design (simple and correct first): one warp per row, 8 rows per block,
// rows spread over the grid by a grid-stride loop, any C >= 2, 64-bit
// offsets (a node-stacked embedding of gemma3-1b is 906 M elements at
// n = 3).  The row's amax is a warp-shuffle max.  What later PRs may do:
// keep the row in registers instead of reading it twice, read the bf16
// leaf directly instead of the f32 copy the chunk-row layout makes, and
// fuse the decode and the mix into the same pass.
//
// The second kernel here is the compressed gossip round's combine, on the
// node's own exact chunk rows and the S payloads it received:
//
//     out = w[0] * own + sum_s w[s+1] * (q_s * scale_s)     (f32, s in order)
//
// own (R, C) f32, q_s (R, C) int8 or fp8 e4m3fn, scale_s (R, 1) f32,
// 0 <= S <= 32.  It replaces the TPU kernel
// quantized_gossip_mix_slots_pallas (src/repro/kernels/quantized_gossip.py
// :115, body _qmix_slots_kernel at :101); the plain version is
// repro_torch.kernels.ref.quantized_gossip_mix_ref, bit for bit: explicit
// _rn products and sums in its order, and the payload decoded as the
// quantize kernel decodes it (int8 exactly; fp8 through the hardware's
// e4m3 -> half conversion, exact for every finite code).  Bound: bytes,
// 8 + S B per element (own and out 4 B each, one payload byte per slot)
// plus 4 B per row and slot.  Design: one warp per row, as above; the
// slot pointers and weights travel in a parameter struct and the slot
// loop is unrolled over its 32 entries with a guard.
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int64_t kMaxBlocks = 132 * 32;

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

template <bool kWithErr>
__device__ __forceinline__ float load_s(const float* __restrict__ x,
                                        const float* __restrict__ err,
                                        int64_t i) {
  return kWithErr ? __fadd_rn(x[i], err[i]) : x[i];
}

// kFmt: 0 = int8, 1 = fp8 e4m3fn.  Writes q's byte and returns q as f32.
template <int kFmt>
__device__ __forceinline__ float quantize(float v, uint32_t h,
                                          uint8_t* __restrict__ q,
                                          int64_t i) {
  if (kFmt == 0) {
    const float u = __fmul_rn(__uint2float_rn(h), 0x1p-32f);
    const float r = fminf(fmaxf(floorf(__fadd_rn(v, u)), -127.0f), 127.0f);
    q[i] = (uint8_t)(int8_t)r;
    return r;
  } else {
    uint32_t b = __float_as_uint(v);
    b = (b + (h & 0xFFFFFu)) & 0xFFF00000u;
    const float w = fminf(fmaxf(__uint_as_float(b), -448.0f), 448.0f);
    const __nv_fp8_storage_t f8 =
        __nv_cvt_float_to_fp8(w, __NV_SATFINITE, __NV_E4M3);
    q[i] = (uint8_t)f8;
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(f8, __NV_E4M3)));
  }
}

template <int kFmt, bool kWithErr>
__global__ void __launch_bounds__(kThreads)
    quantize_ef_kernel(const float* __restrict__ x,
                       const float* __restrict__ err,
                       uint8_t* __restrict__ q, float* __restrict__ scale,
                       float* __restrict__ resid, uint32_t key,
                       int64_t row_offset, float inv_qmax, int64_t rows,
                       int64_t cols) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t n_warps = (int64_t)gridDim.x * kWarps;
  for (int64_t r = warp; r < rows; r += n_warps) {
    const int64_t base = r * cols;
    float amax = 0.0f;
    for (int64_t c = lane; c < cols; c += 32)
      amax = fmaxf(amax, fabsf(load_s<kWithErr>(x, err, base + c)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, off));
    const float sc = amax > 0.0f ? __fmul_rn(amax, inv_qmax) : 1.0f;
    if (lane == 0) scale[r] = sc;
    // the reference's int32 index arithmetic, cast to uint32: mod 2^32
    const uint64_t row_idx =
        (uint64_t)(r + row_offset) * (uint64_t)cols;
    for (int64_t c = lane; c < cols; c += 32) {
      const int64_t i = base + c;
      const float s = load_s<kWithErr>(x, err, i);
      const uint32_t h = sr_bits(key, (uint32_t)(row_idx + (uint64_t)c));
      const float qf = quantize<kFmt>(__fdiv_rn(s, sc), h, q, i);
      resid[i] = __fsub_rn(s, __fmul_rn(qf, sc));
    }
  }
}

template <int kFmt, bool kWithErr>
cudaError_t launch(const float* x, const float* err, uint8_t* q,
                   float* scale, float* resid, uint32_t key,
                   int64_t row_offset, float inv_qmax, int64_t rows,
                   int64_t cols, cudaStream_t stream) {
  int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  quantize_ef_kernel<kFmt, kWithErr><<<(unsigned)blocks, kThreads, 0,
                                       stream>>>(
      x, err, q, scale, resid, key, row_offset, inv_qmax, rows, cols);
  return cudaGetLastError();
}

constexpr int kMaxMixSlots = 32;

struct QSlots {
  const uint8_t* q[kMaxMixSlots];
  const float* scale[kMaxMixSlots];
  float w[kMaxMixSlots + 1];  // w[0] is the own value's weight
  int n;
};

template <int kFmt>
__device__ __forceinline__ float decode(uint8_t b) {
  if (kFmt == 0) return __int2float_rn((int)(int8_t)b);
  return __half2float(
      __half(__nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)b, __NV_E4M3)));
}

template <int kFmt>
__global__ void __launch_bounds__(kThreads)
    quantized_gossip_mix_kernel(const float* __restrict__ own, const QSlots s,
                                float* __restrict__ out, int64_t rows,
                                int64_t cols) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t n_warps = (int64_t)gridDim.x * kWarps;
  for (int64_t r = warp; r < rows; r += n_warps) {
    const int64_t base = r * cols;
    for (int64_t c = lane; c < cols; c += 32) {
      const int64_t i = base + c;
      float acc = __fmul_rn(s.w[0], own[i]);
#pragma unroll
      for (int k = 0; k < kMaxMixSlots; ++k) {
        if (k >= s.n) break;
        const float hat = __fmul_rn(decode<kFmt>(s.q[k][i]), s.scale[k][r]);
        acc = __fadd_rn(acc, __fmul_rn(s.w[k + 1], hat));
      }
      out[i] = acc;
    }
  }
}

template <int kFmt>
cudaError_t launch_mix(const float* own, const QSlots& s, float* out,
                       int64_t rows, int64_t cols, cudaStream_t stream) {
  int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  quantized_gossip_mix_kernel<kFmt><<<(unsigned)blocks, kThreads, 0,
                                      stream>>>(own, s, out, rows, cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fmt: 0 = int8, 1 = fp8 e4m3fn.  x, err (may be null), resid: contiguous
// (rows, cols) float32; q: (rows, cols) bytes; scale: rows floats.  No
// output may alias an input.  inv_qmax is float32(1 / 127) or
// float32(1 / 448).  Returns the cudaError_t of the launch (0 on success);
// nothing is synchronised.
int repro_quantize_ef(int fmt, const float* x, const float* err, void* q,
                      float* scale, float* resid, uint32_t key,
                      int64_t row_offset, float inv_qmax, int64_t rows,
                      int64_t cols, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* qb = static_cast<uint8_t*>(q);
  if (rows < 1 || cols < 2) return (int)cudaErrorInvalidValue;
  if (fmt == 0 && err == nullptr)
    return (int)launch<0, false>(x, err, qb, scale, resid, key, row_offset,
                                 inv_qmax, rows, cols, s);
  if (fmt == 0)
    return (int)launch<0, true>(x, err, qb, scale, resid, key, row_offset,
                                inv_qmax, rows, cols, s);
  if (fmt == 1 && err == nullptr)
    return (int)launch<1, false>(x, err, qb, scale, resid, key, row_offset,
                                 inv_qmax, rows, cols, s);
  if (fmt == 1)
    return (int)launch<1, true>(x, err, qb, scale, resid, key, row_offset,
                                inv_qmax, rows, cols, s);
  return (int)cudaErrorInvalidValue;
}

// fmt: 0 = int8, 1 = fp8 e4m3fn.  own, out: contiguous (rows, cols)
// float32, out aliasing nothing; q: n_slots pointers (a host array) to
// (rows, cols) payload bytes; scale: n_slots pointers to rows floats; w:
// n_slots + 1 floats (a host array), the own value's weight first.
// Returns the cudaError_t of the launch (0 on success); nothing is
// synchronised.
int repro_quantized_gossip_mix(int fmt, const float* own,
                               const void* const* q,
                               const float* const* scale, const float* w,
                               int n_slots, float* out, int64_t rows,
                               int64_t cols, void* stream) {
  if (rows < 1 || cols < 1 || n_slots < 0 || n_slots > kMaxMixSlots)
    return (int)cudaErrorInvalidValue;
  QSlots s{};
  s.n = n_slots;
  s.w[0] = w[0];
  for (int k = 0; k < n_slots; ++k) {
    s.q[k] = static_cast<const uint8_t*>(q[k]);
    s.scale[k] = scale[k];
    s.w[k + 1] = w[k + 1];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fmt == 0) return (int)launch_mix<0>(own, s, out, rows, cols, st);
  if (fmt == 1) return (int)launch_mix<1>(own, s, out, rows, cols, st);
  return (int)cudaErrorInvalidValue;
}

const char* repro_quantize_ef_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
