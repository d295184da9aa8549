// Flash-attention forward for Hopper (sm_90a): GQA streaming softmax with
// causal mask, sliding window, optional tanh softcap and per-batch
// q_start / k_valid_len.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:310, body _flash_kernel at :54).
// Semantics are the reference's: query row i of batch b sits at absolute
// position q_start[b] + i; key s is visible iff s < k_valid[b], and (when
// causal) s <= qpos, and (with a window) s > qpos - window.  Masked logits
// are -1e30 (never -inf), value rows at or past k_valid are zeroed before
// the accumulate, the denominator is clamped at 1e-30, sums are f32 and the
// output is written in the input type.
//
// Layout: the kernel reads the model layout directly through strides —
// q (B, Tq, H, D), k (B, S, KV, D), v (B, S, KV, DV), out (B, Tq, H, DV),
// each with a contiguous last dimension.  Query head h reads kv head
// h / G with G = H / KV.
//
// Design (simple and correct first):
//   * one thread block per (row tile, kv head, batch).  A "row" is one
//     (query position, head of the group) pair, so the G query heads that
//     share a kv head are in the same block and each K/V tile is loaded
//     from device memory once per group.  Rows are flattened as t * G + g
//     and a block takes BR consecutive rows.
//   * the kv loop runs inside the block, over [kv_lo, kv_hi) — the union of
//     the causal / window bands of the block's rows, clipped to k_valid —
//     in tiles of 32 keys staged in shared memory as f32.
//   * the Q tile (BR x D) and the K tile (32 x D) sit in shared memory with
//     a row stride of D + 1 floats, so the S = Q K^T phase reads them
//     without bank conflicts; the accumulator (BR x DV) lives in registers,
//     spread over 256 threads as a 16 x 16 grid of (rows, value columns).
//   * online softmax in f32, one warp per row, one key per lane.
//   * products are plain f32 FMAs on the CUDA cores.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): decode
// (Tq = 1) reads the whole valid K/V prefix once and does ~4 FLOP per byte,
// so it is bound by bytes; a long prefill does O(Tq * band * D) FLOPs on
// O((Tq + S) * D) bytes and is bound by operations.  What this design
// leaves on the table: at decode, B = 4 and KV = 1 give only 4 blocks on
// 132 SMs (a split over the kv axis with a combine pass would fill the
// card), and the products run on the CUDA cores instead of the tensor
// cores (mma.sync / wgmma with TMA-fed tiles).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;  // keys per tile: one per lane in the softmax phase
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t B, Tq, H, KV, S;
  int64_t sq_b, sq_t, sq_h;
  int64_t sk_b, sk_s, sk_h;
  int64_t sv_b, sv_s, sv_h;
  int64_t so_b, so_t, so_h;
  const int32_t* q_start;  // (B,) or null -> q_start0
  const int32_t* k_valid;  // (B,) or null -> k_valid0
  int64_t q_start0, k_valid0;
  int causal;
  int64_t window;  // <= 0: no window
  int has_softcap;
  float softcap;
  float scale;
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D, int DV, int BR>
constexpr size_t smem_floats() {
  return (size_t)BR * (D + 1)       // q tile
         + (size_t)kBK * (D + 1)    // k tile
         + (size_t)kBK * DV         // v tile
         + (size_t)BR * (kBK + 1)   // logits / probabilities
         + 3 * (size_t)BR;          // running max, denominator, rescale
}

template <typename T, int D, int DV, int BR>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  static_assert(BR % 16 == 0 && D % 16 == 0 && DV % 16 == 0, "tile shape");
  constexpr int RPT = BR / 16;   // rows per thread
  constexpr int CPT = DV / 16;   // value columns per thread
  constexpr int KPT = kBK / 16;  // keys per thread in the S phase
  constexpr int QS = D + 1;      // padded shared-memory row strides
  constexpr int KS = D + 1;
  constexpr int PS = kBK + 1;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BR * QS;
  float* v_s = k_s + kBK * KS;
  float* p_s = v_s + kBK * DV;
  float* m_s = p_s + BR * PS;
  float* l_s = m_s + BR;
  float* a_s = l_s + BR;

  const T* Q = static_cast<const T*>(p.q);
  const T* K = static_cast<const T*>(p.k);
  const T* V = static_cast<const T*>(p.v);
  T* O = static_cast<T*>(p.o);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ri = tid >> 4;  // row thread 0..15
  const int ci = tid & 15;  // column thread 0..15
  const int64_t b = blockIdx.z;
  const int64_t kvh = blockIdx.y;
  const int64_t G = p.H / p.KV;
  const int64_t rows = p.Tq * G;
  const int64_t f0 = (int64_t)blockIdx.x * BR;

  const int64_t q0 = p.q_start ? (int64_t)p.q_start[b] : p.q_start0;
  int64_t kvalid = p.k_valid ? (int64_t)p.k_valid[b] : p.k_valid0;
  kvalid = kvalid < p.S ? kvalid : p.S;
  kvalid = kvalid > 0 ? kvalid : 0;

  // kv range of the block: union of its rows' bands
  const int64_t f_last = (f0 + BR < rows ? f0 + BR : rows) - 1;
  const int64_t t_lo = f0 / G;
  const int64_t t_hi = f_last / G;
  int64_t kv_lo = 0;
  int64_t kv_hi = kvalid;
  if (p.causal && q0 + t_hi + 1 < kv_hi) kv_hi = q0 + t_hi + 1;
  if (p.window > 0 && q0 + t_lo - p.window + 1 > kv_lo)
    kv_lo = q0 + t_lo - p.window + 1;

  for (int idx = tid; idx < BR * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    const int64_t f = f0 + r;
    float val = 0.f;
    if (f < rows) {
      const int64_t t = f / G;
      const int64_t h = kvh * G + f % G;
      val = to_f32(Q[b * p.sq_b + t * p.sq_t + h * p.sq_h + d]);
    }
    q_s[r * QS + d] = val;
  }
  for (int r = tid; r < BR; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  const T* Kb = K + b * p.sk_b + kvh * p.sk_h;
  const T* Vb = V + b * p.sv_b + kvh * p.sv_h;

  for (int64_t k0 = kv_lo; k0 < kv_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx % D;
      const int64_t s = k0 + j;
      k_s[j * KS + d] = s < kvalid ? to_f32(Kb[s * p.sk_s + d]) : 0.f;
    }
    for (int idx = tid; idx < kBK * DV; idx += kThreads) {
      const int j = idx / DV;
      const int d = idx % DV;
      const int64_t s = k0 + j;
      v_s[j * DV + d] = s < kvalid ? to_f32(Vb[s * p.sv_s + d]) : 0.f;
    }
    __syncthreads();

    // S = (Q K^T) * scale
    float sc[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT];
      float kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = q_s[(ri + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = k_s[(ci + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        p_s[(ri + 16 * i) * PS + ci + 16 * j] = sc[i][j] * p.scale;
    __syncthreads();

    // online softmax: one warp per row, one key per lane
    for (int r = warp; r < BR; r += kWarps) {
      const int64_t f = f0 + r < rows ? f0 + r : rows - 1;
      const int64_t qpos = q0 + f / G;
      const int64_t s = k0 + lane;
      float x = p_s[r * PS + lane];
      if (p.has_softcap) x = p.softcap * tanhf(x / p.softcap);
      bool ok = s < kvalid;
      if (p.causal) ok = ok && s <= qpos;
      if (p.window > 0) ok = ok && s > qpos - p.window;
      x = ok ? x : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float pr = expf(x - m_new);
      const float sum = warp_sum(pr);
      p_s[r * PS + lane] = pr;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float a = a_s[ri + 16 * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = p_s[(ri + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vv = v_s[kk * DV + ci + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();  // l_s is final (and visible when no tile ran)

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ri + 16 * i;
    const int64_t f = f0 + r;
    if (f >= rows) continue;
    const int64_t t = f / G;
    const int64_t h = kvh * G + f % G;
    const float den = fmaxf(l_s[r], 1e-30f);
    T* out = O + b * p.so_b + t * p.so_t + h * p.so_h;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      out[ci + 16 * j] = from_f32<T>(acc[i][j] / den);
  }
}

template <typename T, int D, int DV, int BR>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D, DV, BR>() * sizeof(float);
  // Above 48 KB a kernel must opt in to dynamic shared memory.  The
  // attribute belongs to the kernel on the current device; the port runs
  // one device per process, so it is set once per instantiation.
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, DV, BR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int64_t rows = p.Tq * (p.H / p.KV);
  const dim3 grid((unsigned)((rows + BR - 1) / BR), (unsigned)p.KV,
                  (unsigned)p.B);
  flash_fwd_kernel<T, D, DV, BR><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int BR>
cudaError_t dispatch_dims(int d, int dv, const Params& p, cudaStream_t s) {
  if (d == 64 && dv == 64) return launch<T, 64, 64, BR>(p, s);
  if (d == 128 && dv == 128) return launch<T, 128, 128, BR>(p, s);
  if (d == 256 && dv == 256) return launch<T, 256, 256, BR>(p, s);
  if (d == 192 && dv == 128) return launch<T, 192, 128, BR>(p, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_rows(int block_rows, int d, int dv, const Params& p,
                          cudaStream_t s) {
  if (block_rows == 16) return dispatch_dims<T, 16>(d, dv, p, s);
  if (block_rows == 64) return dispatch_dims<T, 64>(d, dv, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  block_rows: 16 or 64.  Returns the
// cudaError_t of the launch (0 on success); nothing is synchronised.
int repro_flash_attention_fwd(
    int dtype, int d, int dv, int block_rows, const void* q, const void* k,
    const void* v, void* o, int64_t B, int64_t Tq, int64_t H, int64_t KV,
    int64_t S, int64_t sq_b, int64_t sq_t, int64_t sq_h, int64_t sk_b,
    int64_t sk_s, int64_t sk_h, int64_t sv_b, int64_t sv_s, int64_t sv_h,
    int64_t so_b, int64_t so_t, int64_t so_h, const int32_t* q_start,
    const int32_t* k_valid, int64_t q_start0, int64_t k_valid0, int causal,
    int64_t window, int has_softcap, float softcap, float scale,
    void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.B = B;
  p.Tq = Tq;
  p.H = H;
  p.KV = KV;
  p.S = S;
  p.sq_b = sq_b;
  p.sq_t = sq_t;
  p.sq_h = sq_h;
  p.sk_b = sk_b;
  p.sk_s = sk_s;
  p.sk_h = sk_h;
  p.sv_b = sv_b;
  p.sv_s = sv_s;
  p.sv_h = sv_h;
  p.so_b = so_b;
  p.so_t = so_t;
  p.so_h = so_h;
  p.q_start = q_start;
  p.k_valid = k_valid;
  p.q_start0 = q_start0;
  p.k_valid0 = k_valid0;
  p.causal = causal;
  p.window = window;
  p.has_softcap = has_softcap;
  p.softcap = softcap;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_rows<float>(block_rows, d, dv, p, s);
  if (dtype == 1)
    return (int)dispatch_rows<__nv_bfloat16>(block_rows, d, dv, p, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
