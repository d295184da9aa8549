// Paged flash-attention forward for Hopper (sm_90a): GQA streaming softmax
// over a KV cache kept as a pool of pages and a per-slot block table, with
// causal mask, sliding window, optional tanh softcap and per-slot q_start /
// k_valid_len.
//
// Replaces the TPU kernel paged_flash_attention_pallas
// (src/repro/kernels/flash_attention.py:216, body _paged_flash_kernel at
// :136).  Semantics are the reference's: query row i of slot b sits at
// absolute position q_start[b] + i; key position s of slot b lives at
// pool[table[b, s / ps], s % ps]; key s is visible iff s < k_valid[b], and
// (when causal) s <= qpos, and (with a window) s > qpos - window.  Masked
// logits are -1e30, value rows at or past k_valid are zero, the denominator
// is clamped at 1e-30, sums are f32 and the output is in the input type.
//
// Layout: q (B, Tq, H, D), pools (P, ps, KV, D) and (P, ps, KV, DV), out
// (B, Tq, H, DV), each read through strides with a contiguous last
// dimension; the block table is (B, maxp) int32 with rows table_stride
// apart.  Query head h reads kv head h / G with G = H / KV.  Only the table
// entries j < ceil(k_valid / ps) are read, and those must be page ids in
// [0, P): the kernel does not check them.
//
// The row contract (what makes speculative decoding lossless, DESIGN.md
// Sec. 15): each row's result depends only on its own query, position and
// k_valid, never on Tq or on the other rows of its block.  So a verify call
// (Tq = k + 1, k_valid = q_start + k + 1) equals, bit for bit, k + 1 calls
// with Tq = 1 and k_valid = q_start + i + 1.  The design holds it by:
//   * key tiles aligned to absolute positions: lane i of tile t holds key
//     32 t + i, whatever rows the block holds, so every row meets its keys
//     in the same tiles in the same order;
//   * masking by select before any use: a masked logit is -1e30 before the
//     max and a masked key's probability is 0 by select (never
//     exp(-1e30 - m)), so a tile that is fully masked for a row is an exact
//     no-op (alpha 1, or 0 on a zero sum, and 0 added);
//   * keys at or past k_valid are never loaded: their K and V rows are
//     zero by select, so garbage or NaN in scratch page 0 or in a page's
//     unwritten tail never reaches a sum;
//   * one fixed 16-row tile shape and one instruction sequence per row:
//     its dot products run over d in order, its softmax sums over the
//     warp's lanes in butterfly order, its P V products over the tile's
//     keys in order.
//
// Design (simple and correct first): one thread block per (16-row tile,
// kv head, slot).  A row is one (query position, head of the group) pair,
// so the G query heads of a kv head share each K/V tile.  The block walks
// the union of its rows' bands in 32-key tiles: 32 threads first look up
// each key's page in the block table, then the tile is staged in shared
// memory as f32 (rows D + 1 floats apart, so the Q K^T phase reads without
// bank conflicts).  The accumulator (16 x DV) lives in registers over 256
// threads; online softmax runs one warp per row, one key per lane;
// products are f32 FMAs on the CUDA cores.
//
// Bound on this card (H100 SXM, 3.35 TB/s): decode and verify read each
// visible K/V row once (1,024 B per key per layer at gemma3-1b's one kv
// head of 256 in bf16) and do ~4 FLOP per byte, so they are bound by bytes.
// Known limits: one block per (kv head, slot) at decode, so 8 slots give 8
// blocks on 132 SMs (a split over the kv axis would need a combine fixed by
// absolute tile position to keep the row contract), and the products run on
// the CUDA cores rather than the tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;  // keys per tile: one per lane in the softmax phase
constexpr int kBR = 16;  // rows per block
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int32_t* table;    // (B, maxp), rows st_b apart
  const int32_t* q_start;  // (B,)
  const int32_t* k_valid;  // (B,)
  int64_t B, Tq, H, KV, ps, maxp;
  int64_t sq_b, sq_t, sq_h;
  int64_t sk_p, sk_s, sk_h;
  int64_t sv_p, sv_s, sv_h;
  int64_t so_b, so_t, so_h;
  int64_t st_b;
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
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int D, int DV>
constexpr size_t smem_floats() {
  return (size_t)kBR * (D + 1)      // q tile
         + (size_t)kBK * (D + 1)    // k tile
         + (size_t)kBK * DV         // v tile
         + (size_t)kBR * (kBK + 1)  // logits / probabilities
         + 3 * (size_t)kBR;         // running max, denominator, rescale
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
    paged_flash_fwd_kernel(const Params p) {
  static_assert(D % 16 == 0 && DV % 16 == 0, "tile shape");
  constexpr int CPT = DV / 16;   // value columns per thread
  constexpr int KPT = kBK / 16;  // keys per thread in the S phase
  constexpr int QS = D + 1;      // padded shared-memory row strides
  constexpr int KS = D + 1;
  constexpr int PS = kBK + 1;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBR * QS;
  float* v_s = k_s + kBK * KS;
  float* p_s = v_s + kBK * DV;
  float* m_s = p_s + kBR * PS;
  float* l_s = m_s + kBR;
  float* a_s = l_s + kBR;
  __shared__ int64_t koff_s[kBK];  // element offset of each key's K row,
  __shared__ int64_t voff_s[kBK];  // and V row; -1: not loaded (>= k_valid)

  const T* Q = static_cast<const T*>(p.q);
  const T* K = static_cast<const T*>(p.k);
  const T* V = static_cast<const T*>(p.v);
  T* O = static_cast<T*>(p.o);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ri = tid >> 4;  // row thread 0..15 (one row each)
  const int ci = tid & 15;  // column thread 0..15
  const int64_t b = blockIdx.z;
  const int64_t kvh = blockIdx.y;
  const int64_t G = p.H / p.KV;
  const int64_t rows = p.Tq * G;
  const int64_t f0 = (int64_t)blockIdx.x * kBR;

  const int64_t q0 = p.q_start[b];
  int64_t kvalid = p.k_valid[b];
  kvalid = kvalid < p.maxp * p.ps ? kvalid : p.maxp * p.ps;
  kvalid = kvalid > 0 ? kvalid : 0;
  const int32_t* tbl = p.table + b * p.st_b;

  // the tiles the block walks: the union of its rows' bands, widened to
  // whole 32-key tiles at absolute positions (extra tiles are no-ops)
  const int64_t f_last = (f0 + kBR < rows ? f0 + kBR : rows) - 1;
  const int64_t t_lo = f0 / G;
  const int64_t t_hi = f_last / G;
  int64_t kv_lo = 0;
  int64_t kv_hi = kvalid;
  if (p.causal && q0 + t_hi + 1 < kv_hi) kv_hi = q0 + t_hi + 1;
  if (p.window > 0 && q0 + t_lo - p.window + 1 > kv_lo)
    kv_lo = q0 + t_lo - p.window + 1;
  kv_lo -= kv_lo % kBK;

  for (int idx = tid; idx < kBR * D; idx += kThreads) {
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
  if (tid < kBR) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.f;

  for (int64_t k0 = kv_lo; k0 < kv_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    if (tid < kBK) {
      const int64_t s = k0 + tid;
      int64_t ko = -1;
      int64_t vo = -1;
      if (s < kvalid) {
        const int64_t page = tbl[s / p.ps];
        const int64_t slot = s % p.ps;
        ko = page * p.sk_p + slot * p.sk_s + kvh * p.sk_h;
        vo = page * p.sv_p + slot * p.sv_s + kvh * p.sv_h;
      }
      koff_s[tid] = ko;
      voff_s[tid] = vo;
    }
    __syncthreads();
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx % D;
      const int64_t o = koff_s[j];
      k_s[j * KS + d] = o >= 0 ? to_f32(K[o + d]) : 0.f;
    }
    for (int idx = tid; idx < kBK * DV; idx += kThreads) {
      const int j = idx / DV;
      const int d = idx % DV;
      const int64_t o = voff_s[j];
      v_s[j * DV + d] = o >= 0 ? to_f32(V[o + d]) : 0.f;
    }
    __syncthreads();

    // S = (Q K^T) * scale, each element a dot product over d in order
    float sc[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) sc[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qv = q_s[ri * QS + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        sc[j] = fmaf(qv, k_s[(ci + 16 * j) * KS + d], sc[j]);
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j)
      p_s[ri * PS + ci + 16 * j] = __fmul_rn(sc[j], p.scale);
    __syncthreads();

    // online softmax: one warp per row, one key per lane, masks by select
    for (int r = warp; r < kBR; r += kWarps) {
      const int64_t f = f0 + r < rows ? f0 + r : rows - 1;
      const int64_t qpos = q0 + f / G;
      const int64_t s = k0 + lane;
      float x = p_s[r * PS + lane];
      if (p.has_softcap)
        x = __fmul_rn(p.softcap, tanhf(__fdiv_rn(x, p.softcap)));
      bool ok = s < kvalid;
      if (p.causal) ok = ok && s <= qpos;
      if (p.window > 0) ok = ok && s > qpos - p.window;
      x = ok ? x : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float pr = ok ? expf(__fsub_rn(x, m_new)) : 0.f;
      const float sum = warp_sum(pr);
      p_s[r * PS + lane] = pr;
      if (lane == 0) {
        const float alpha = expf(__fsub_rn(m_prev, m_new));
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = __fmaf_rn(alpha, l_s[r], sum);
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V, over the tile's keys in order
    const float a = a_s[ri];
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] = __fmul_rn(acc[j], a);
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float pv = p_s[ri * PS + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        acc[j] = __fmaf_rn(pv, v_s[kk * DV + ci + 16 * j], acc[j]);
    }
  }
  __syncthreads();  // l_s is final (and visible when no tile ran)

  const int64_t f = f0 + ri;
  if (f >= rows) return;
  const int64_t t = f / G;
  const int64_t h = kvh * G + f % G;
  const float den = fmaxf(l_s[ri], 1e-30f);
  T* out = O + b * p.so_b + t * p.so_t + h * p.so_h;
#pragma unroll
  for (int j = 0; j < CPT; ++j)
    out[ci + 16 * j] = from_f32<T>(__fdiv_rn(acc[j], den));
}

template <typename T, int D, int DV>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D, DV>() * sizeof(float);
  // Above 48 KB a kernel must opt in to dynamic shared memory.  The
  // attribute belongs to the kernel on the current device; the port runs
  // one device per process, so it is set once per instantiation.
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_flash_fwd_kernel<T, D, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int64_t rows = p.Tq * (p.H / p.KV);
  const dim3 grid((unsigned)((rows + kBR - 1) / kBR), (unsigned)p.KV,
                  (unsigned)p.B);
  paged_flash_fwd_kernel<T, D, DV><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dims(int d, int dv, const Params& p, cudaStream_t s) {
  if (d == 64 && dv == 64) return launch<T, 64, 64>(p, s);
  if (d == 128 && dv == 128) return launch<T, 128, 128>(p, s);
  if (d == 256 && dv == 256) return launch<T, 256, 256>(p, s);
  if (d == 192 && dv == 128) return launch<T, 192, 128>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 on success); nothing is synchronised.
int repro_paged_flash_attention_fwd(
    int dtype, int d, int dv, const void* q, const void* k, const void* v,
    void* o, const int32_t* table, const int32_t* q_start,
    const int32_t* k_valid, int64_t B, int64_t Tq, int64_t H, int64_t KV,
    int64_t ps, int64_t maxp, int64_t sq_b, int64_t sq_t, int64_t sq_h,
    int64_t sk_p, int64_t sk_s, int64_t sk_h, int64_t sv_p, int64_t sv_s,
    int64_t sv_h, int64_t so_b, int64_t so_t, int64_t so_h, int64_t st_b,
    int causal, int64_t window, int has_softcap, float softcap, float scale,
    void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.table = table;
  p.q_start = q_start;
  p.k_valid = k_valid;
  p.B = B;
  p.Tq = Tq;
  p.H = H;
  p.KV = KV;
  p.ps = ps;
  p.maxp = maxp;
  p.sq_b = sq_b;
  p.sq_t = sq_t;
  p.sq_h = sq_h;
  p.sk_p = sk_p;
  p.sk_s = sk_s;
  p.sk_h = sk_h;
  p.sv_p = sv_p;
  p.sv_s = sv_s;
  p.sv_h = sv_h;
  p.so_b = so_b;
  p.so_t = so_t;
  p.so_h = so_h;
  p.st_b = st_b;
  p.causal = causal;
  p.window = window;
  p.has_softcap = has_softcap;
  p.softcap = softcap;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_dims<float>(d, dv, p, s);
  if (dtype == 1) return (int)dispatch_dims<__nv_bfloat16>(d, dv, p, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_paged_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
