// The device-side core of the port's two flash-attention kernels for Hopper
// (sm_90a): csrc/flash_attention.cu (dense K/V) and
// csrc/paged_flash_attention.cu (K/V in a page pool behind a block table).
// Both files are thin launchers around the templated body below, so a dense
// row and a paged row run one instruction sequence.
//
// What it computes (the reference's flash_attention_pallas and
// paged_flash_attention_pallas, src/repro/kernels/flash_attention.py:310 and
// :216): GQA attention with a causal mask, a sliding window, an optional
// tanh softcap and per-batch q_start / k_valid.  Query row i of batch b sits
// at absolute position q_start[b] + i; key s is visible iff s < k_valid[b],
// and (when causal) s <= qpos, and (with a window) s > qpos - window.  A row
// is one (query position, head of the group) pair, flattened t * G + g, so
// the G query heads of a kv head share every K/V tile.  A row that sees no
// key gives zeros.
//
// The row contract (DESIGN.md Sec. 14-15): a row's bits depend only on its
// own query, position and k_valid, never on Tq, on the other rows of its
// block, on the block's row count or on the split of the key axis.  So a
// verify window equals one-row calls, a dense row equals a paged row over
// pages holding the same bits, and a split call equals an unsplit one, all
// bit for bit.  The design holds it by:
//   * chunks at absolute positions: the key axis is cut into chunks of BK
//     keys (Tile<T>), chunk j = keys [j BK, (j+1) BK), one key tile each.
//     A chunk yields a partial (m_j, l_j, o_j) from a fresh softmax state,
//     and the partials are folded in ascending j with explicit __fmul_rn /
//     __fadd_rn / expf (fold_row, fold_elem); a chunk with l_j = 0 is
//     skipped by select, so chunks a row cannot see are exact no-ops;
//   * masking by select before any use: a masked logit is -1e30 before the
//     max, a masked probability is 0, and K/V rows at or past k_valid are
//     never read (cp.async zero-fills them), so NaN in a cache tail or in
//     scratch page 0 never reaches a sum;
//   * one instruction sequence per 16-row team: a block holds 1 or 4 teams
//     of 4 warps, and every team runs the same steps on its 16 rows (warp w
//     computes keys [w kBK/4, (w+1) kBK/4) of the logits and the value
//     columns [w DV/4, (w+1) DV/4) of P V; maxima and sums go over the
//     quad by __shfl_xor_sync in butterfly order, then over the 4 warps in
//     order through shared memory);
//   * split == unsplit: an unsplit block folds its chunks in registers; a
//     split block writes each chunk's f32 partial to scratch and
//     combine_kernel folds them in the same order with the same fold_row.
//     Storing and reloading f32 is exact.
//
// Products, by the element type T:
//   * bf16: K/V tiles stay bf16 in shared memory (16-byte chunks swizzled
//     by row, so ldmatrix reads them without bank conflicts), fed by a
//     two-stage cp.async ring (tile i + 1 loads while tile i computes).
//     Q K^T and P V run as mma.sync.m16n8k16 bf16 -> f32, over D in k16
//     steps in order.  P is split into a bf16 high part and a bf16 low part
//     (p - hi) and P V runs both, so P keeps ~16 bits: one bf16 P alone
//     would miss the 1e-4 tolerance on rows of few keys.
//   * f32: the same staging, tiles and fragment layout, with the products
//     as f32 FMAs over d in order on the CUDA cores (no TF32).
//
// Bound on this card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16): decode and
// verify read each visible K/V row once at ~4 FLOP per byte, so they are
// bound by bytes, and their few rows give few blocks: the wrapper splits
// the key axis over blocks (kv_splits) to fill the SMs.  Prefill and
// training do O(Tq * band * D) FLOPs and are bound by operations; 64-row
// blocks share each K/V tile among 4 teams.  Left for later: wgmma with
// TMA and warp specialisation for the 64-row tiles.
//
// Registers and spills per instantiation (-Xptxas -v, sm_90a) are printed
// by chip_smoke.py's [build] phase and recorded in PERF.md.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Each library that includes this header is one translation unit, and the
// body has internal linkage in it: two libraries loaded in one process
// never resolve each other's kernels or launch state.
namespace flash {
namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTeamWarps = 4;
constexpr int kTeamThreads = 32 * kTeamWarps;
constexpr int kStages = 2;

// keys per tile (= per chunk): 64 in bf16, 32 in f32 (f32 tiles take twice
// the shared memory)
template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int BK = 64;
};
template <>
struct Tile<float> {
  static constexpr int BK = 32;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // split scratch (null when unsplit): per (b, kv head, padded row, chunk)
  float* part_o;   // DV floats each
  float2* part_ml; // (m, l)
  const int32_t* table;    // paged: (B, maxp), rows st_b apart
  const int32_t* q_start;  // (B,) or null -> q_start0
  const int32_t* k_valid;  // (B,) or null -> k_valid0
  int64_t q_start0, k_valid0;
  int64_t B, Tq, H, KV;
  int64_t S;  // keys addressable: dense S, paged maxp * ps
  int64_t ps, st_b;
  int64_t sq_b, sq_t, sq_h;
  int64_t sk_b, sk_s, sk_h;  // paged: sk_b is the page stride
  int64_t sv_b, sv_s, sv_h;
  int64_t so_b, so_t, so_h;
  int causal;
  int64_t window;  // <= 0: no window
  int has_softcap;
  float softcap;
  float scale;
  int splits;       // blocks over the key axis per row tile (>= 1)
  int64_t nchunks;  // ceil(S / BK)
  int64_t row_tiles;
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 fills the destination with zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a barrier over one team's 128 threads (ids 1..4; 0 is __syncthreads)
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(team + 1), "r"(kTeamThreads)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a b, one m16n8k16 bf16 product with an f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk c of row r in a tile whose rows are ROWB
// bytes: the chunk index is XORed with r mod 8, so the 8 rows an ldmatrix
// (or a column read) touches land in 8 distinct bank groups.
template <int ROWB>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  static_assert(ROWB % 128 == 0, "rows of at least 8 chunks");
  return (uint32_t)(r * ROWB + ((c ^ (r & 7)) << 4));
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

// ---------------------------------------------------------------------------
// The fold of one chunk's partial into a row's running state.  The unsplit
// kernel and combine_kernel both call it, so the two routes give the same
// bits; a chunk with l_j = 0 (no visible key) is skipped by select.
// ---------------------------------------------------------------------------

struct Fold {
  float a, b;  // O' = O a + o_j b
  bool take;
};

__device__ __forceinline__ Fold fold_row(float& M, float& L, float mj,
                                         float lj) {
  Fold f;
  f.take = lj > 0.f;
  const float mx = fmaxf(M, mj);
  const float ea = expf(__fsub_rn(M, mx));
  const float eb = expf(__fsub_rn(mj, mx));
  const float ln = __fadd_rn(__fmul_rn(L, ea), __fmul_rn(lj, eb));
  f.a = ea;
  f.b = eb;
  M = f.take ? mx : M;
  L = f.take ? ln : L;
  return f;
}

__device__ __forceinline__ float fold_elem(const Fold& f, float O, float o) {
  const float n = __fadd_rn(__fmul_rn(O, f.a), __fmul_rn(o, f.b));
  return f.take ? n : O;
}

__device__ __forceinline__ float finish(float O, float L) {
  return __fdiv_rn(O, fmaxf(L, 1e-30f));
}

// ---------------------------------------------------------------------------
// Block geometry
// ---------------------------------------------------------------------------

// positions and row counts fit 32 bits; element offsets stay 64-bit
struct Slot {
  int G, rows, q0, kvalid;
};

__device__ __forceinline__ Slot slot_of(const Params& p, int64_t b) {
  Slot s;
  s.G = (int)(p.H / p.KV);
  s.rows = (int)(p.Tq * s.G);
  s.q0 = p.q_start ? p.q_start[b] : (int)p.q_start0;
  int64_t kv = p.k_valid ? (int64_t)p.k_valid[b] : p.k_valid0;
  kv = kv < p.S ? kv : p.S;
  s.kvalid = (int)(kv > 0 ? kv : 0);
  return s;
}

// [lo, hi): the union of the bands of rows [f_begin, f_end), clipped to
// k_valid; empty (hi <= lo) when none of those rows exists
__device__ __forceinline__ void band(const Params& p, const Slot& s,
                                     int f_begin, int f_end, int& lo,
                                     int& hi) {
  const int f_last = (f_end < s.rows ? f_end : s.rows) - 1;
  lo = 0;
  hi = 0;
  if (f_last < f_begin) return;
  const int t_lo = f_begin / s.G;
  const int t_hi = f_last / s.G;
  hi = s.kvalid;
  if (p.causal && s.q0 + t_hi + 1 < hi) hi = s.q0 + t_hi + 1;
  if (p.window > 0 && s.q0 + t_lo - p.window + 1 > lo)
    lo = (int)(s.q0 + t_lo - p.window + 1);
}

// the chunks a row tile walks: [c_lo, c_hi), whole chunks at absolute
// positions covering the band of its rows
template <int BK>
__device__ __forceinline__ void tile_chunks(const Params& p, const Slot& s,
                                            int f0, int f1, int& c_lo,
                                            int& c_hi) {
  int lo, hi;
  band(p, s, f0, f1, lo, hi);
  c_lo = lo / BK;
  c_hi = hi > lo ? (hi + BK - 1) / BK : c_lo;
}

// element offsets of key s's K and V rows, or -1 where s is not loaded
template <bool PAGED>
__device__ __forceinline__ void key_rows(const Params& p, int64_t b,
                                         int64_t kvh, int64_t s,
                                         int64_t kvalid, int64_t& ko,
                                         int64_t& vo) {
  ko = -1;
  vo = -1;
  if (s >= kvalid) return;
  if (PAGED) {
    const int64_t page = p.table[b * p.st_b + s / p.ps];
    const int64_t slot = s % p.ps;
    ko = page * p.sk_b + slot * p.sk_s + kvh * p.sk_h;
    vo = page * p.sv_b + slot * p.sv_s + kvh * p.sv_h;
  } else {
    ko = b * p.sk_b + s * p.sk_s + kvh * p.sk_h;
    vo = b * p.sv_b + s * p.sv_s + kvh * p.sv_h;
  }
}

template <typename T, int D, int DV, int NT>
struct Layout {
  static constexpr int BK = Tile<T>::BK;
  static constexpr int BR = 16 * NT;
  static constexpr int E = (int)sizeof(T);
  static constexpr bool MMA = E == 2;
  static constexpr int QROWB = D * E;   // bytes per Q / K row
  static constexpr int VROWB = DV * E;  // bytes per V row
  static constexpr int PROWB = BK * E;  // bytes per P row (128 both ways)
  static constexpr int PBYTES = 16 * PROWB;
  static constexpr int PPARTS = MMA ? 2 : 1;  // bf16: high and low parts
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t K_OFF = Q_OFF + (size_t)BR * QROWB;
  static constexpr size_t V_OFF = K_OFF + (size_t)kStages * BK * QROWB;
  static constexpr size_t P_OFF = V_OFF + (size_t)kStages * BK * VROWB;
  static constexpr size_t RED_OFF = P_OFF + (size_t)NT * PPARTS * PBYTES;
  static constexpr size_t OFFS_OFF = RED_OFF + (size_t)NT * 128 * 4;
  static constexpr size_t BYTES = OFFS_OFF + (size_t)2 * 2 * BK * 8;
  static_assert(PROWB == 128, "P rows are 8 chunks");
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// ---------------------------------------------------------------------------
// The attention kernel: one block per (row tile x batch, kv head x split)
// ---------------------------------------------------------------------------

template <typename T, int D, int DV, int NT, bool PAGED>
__global__ void __launch_bounds__(kTeamThreads* NT)
    attn_kernel(const Params p) {
  using L_ = Layout<T, D, DV, NT>;
  constexpr int BK = L_::BK;
  constexpr int BR = L_::BR;
  constexpr bool MMA = L_::MMA;
  constexpr int NTH = kTeamThreads * NT;
  constexpr int EPC = 16 / L_::E;      // elements per 16-byte chunk
  constexpr int CPRK = D / EPC;        // chunks per Q / K row
  constexpr int CPRV = DV / EPC;       // chunks per V row
  constexpr int KW = BK / kTeamWarps;  // keys per warp in the logits
  constexpr int NS = KW / 8;           // n8 tiles per warp in the logits
  constexpr int VW = DV / kTeamWarps;  // value columns per warp in P V
  constexpr int NV = VW / 8;           // n8 tiles per warp in P V
  static_assert(D % 16 == 0 && DV % 64 == 0 && NV % 2 == 0, "tile shape");
  static_assert(!MMA || NS % 2 == 0, "logit tiles in pairs");
  static_assert(MMA || NS == 1, "f32: one n8 tile of logits per warp");

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_sa = smem_u32(smem + L_::Q_OFF);
  const uint32_t k_sa = smem_u32(smem + L_::K_OFF);
  const uint32_t v_sa = smem_u32(smem + L_::V_OFF);
  const uint32_t p_sa = smem_u32(smem + L_::P_OFF);
  unsigned char* q_s = smem + L_::Q_OFF;
  unsigned char* k_s = smem + L_::K_OFF;
  unsigned char* v_s = smem + L_::V_OFF;
  unsigned char* p_s = smem + L_::P_OFF;
  float* red = reinterpret_cast<float*>(smem + L_::RED_OFF);
  int64_t* offs = reinterpret_cast<int64_t*>(smem + L_::OFFS_OFF);

  const T* Q = static_cast<const T*>(p.q);
  const T* K = static_cast<const T*>(p.k);
  const T* V = static_cast<const T*>(p.v);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int team = warp / kTeamWarps;
  const int w = warp % kTeamWarps;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // blockIdx.x runs over (row tile, batch) with the last row tiles first:
  // under a causal mask they walk the most chunks, and starting them
  // first keeps the card's last wave short
  const int64_t b = blockIdx.x % p.B;
  const int rt = (int)(p.row_tiles - 1 - blockIdx.x / p.B);
  const int64_t kvh = blockIdx.y / p.splits;
  const int split = (int)(blockIdx.y % p.splits);
  const bool unsplit = p.part_o == nullptr;
  const Slot sl = slot_of(p, b);
  const int f0 = rt * BR;

  int c_lo, c_hi;
  tile_chunks<BK>(p, sl, f0, f0 + BR, c_lo, c_hi);
  const int n = c_hi - c_lo;
  const int c_begin = c_lo + n * split / p.splits;
  const int c_end = c_lo + n * (split + 1) / p.splits;
  if (!unsplit && c_begin == c_end) return;  // the whole block: nothing to do

  // the team's rows and their band (a tile outside it is a no-op for them)
  const int ft = f0 + 16 * team;
  int team_lo, team_hi;
  band(p, sl, ft, ft + 16, team_lo, team_hi);
  const int fA = ft + g;  // this lane's two rows: g and g + 8
  const int fB = fA + 8;
  const int posA = sl.q0 + fA / sl.G;
  const int posB = sl.q0 + fB / sl.G;

  auto fill_offs = [&](int c, int buf) {
    if (tid < BK) {
      int64_t ko = -1, vo = -1;
      if (c < c_end)
        key_rows<PAGED>(p, b, kvh, c * BK + tid, sl.kvalid, ko, vo);
      offs[(2 * buf) * BK + tid] = ko;
      offs[(2 * buf + 1) * BK + tid] = vo;
    }
  };
  auto load_tile = [&](int buf) {
    const uint32_t kb = k_sa + buf * BK * L_::QROWB;
    const uint32_t vb = v_sa + buf * BK * L_::VROWB;
    for (int idx = tid; idx < BK * CPRK; idx += NTH) {
      const int j = idx / CPRK, c = idx % CPRK;
      const int64_t o = offs[(2 * buf) * BK + j];
      cp_async16(kb + swz<L_::QROWB>(j, c), o >= 0 ? K + o + c * EPC : K,
                 o >= 0 ? 16 : 0);
    }
    for (int idx = tid; idx < BK * CPRV; idx += NTH) {
      const int j = idx / CPRV, c = idx % CPRV;
      const int64_t o = offs[(2 * buf + 1) * BK + j];
      cp_async16(vb + swz<L_::VROWB>(j, c), o >= 0 ? V + o + c * EPC : V,
                 o >= 0 ? 16 : 0);
    }
  };

  fill_offs(c_begin, 0);
  fill_offs(c_begin + 1, 1);
  __syncthreads();
  for (int idx = tid; idx < BR * CPRK; idx += NTH) {
    const int r = idx / CPRK, c = idx % CPRK;
    const int f = f0 + r;
    const T* src = Q;
    int bytes = 0;
    if (f < sl.rows) {
      const int64_t h = kvh * sl.G + f % sl.G;
      src = Q + b * p.sq_b + (f / sl.G) * p.sq_t + h * p.sq_h + c * EPC;
      bytes = 16;
    }
    cp_async16(q_sa + swz<L_::QROWB>(r, c), src, bytes);
  }
  if (c_begin < c_end) load_tile(0);
  cp_async_commit();

  // the running state of rows g and g + 8 (replicated over the quad and
  // the team's warps) and this warp's value columns of them
  float M[2] = {kNegInf, kNegInf};
  float Lsum[2] = {0.f, 0.f};
  float O[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[j][e] = 0.f;

  float* red_max = red + team * 128;  // [warp][16 rows]
  float* red_sum = red_max + 64;

  for (int c = c_begin; c < c_end; ++c) {
    const int buf = (c - c_begin) & 1;
    // One barrier per tile: after it tile c is visible to every thread,
    // and every thread is done with tile c - 1, so its stage takes tile
    // c + 1 (whose offsets were written before the barrier) while tile c
    // computes, and tile c's offsets make room for tile c + 2's.
    cp_async_wait<0>();
    __syncthreads();
    if (c + 1 < c_end) load_tile(buf ^ 1);
    cp_async_commit();
    fill_offs(c + 2, buf);
    const int k0 = c * BK;
    const bool active = k0 < team_hi && k0 + BK > team_lo;
    // every key of the tile visible to every row of the team: the masks
    // would all pass, so they are not computed
    const bool full = ft + 16 <= sl.rows && k0 + BK <= sl.kvalid &&
                      (!p.causal || k0 + BK - 1 <= sl.q0 + ft / sl.G) &&
                      (p.window <= 0 ||
                       k0 > sl.q0 + (ft + 15) / sl.G - p.window);
    const uint32_t kb = k_sa + buf * BK * L_::QROWB;
    const uint32_t vb = v_sa + buf * BK * L_::VROWB;
    const unsigned char* vrow = v_s + buf * BK * L_::VROWB;
    const unsigned char* krow = k_s + buf * BK * L_::QROWB;
    float mrow[2] = {kNegInf, kNegInf};
    float lrow[2] = {0.f, 0.f};
    float acc[NV][4];
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    if (active) {
      // ---- logits: rows g, g+8 x keys w*KW + j*8 + 2*t4 + {0, 1}
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if constexpr (MMA) {
#pragma unroll 4
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, q_sa + swz<L_::QROWB>(
                             16 * team + (lane & 7) + ((lane >> 3) & 1) * 8,
                             kk * 2 + (lane >> 4)));
#pragma unroll
          for (int j2 = 0; j2 < NS / 2; ++j2) {
            uint32_t bb[4];
            ldmatrix_x4(bb, kb + swz<L_::QROWB>(
                                w * KW + j2 * 16 + (lane & 7) + (lane >> 4) * 8,
                                kk * 2 + ((lane >> 3) & 1)));
            mma_bf16(s[2 * j2], a, bb[0], bb[1]);
            mma_bf16(s[2 * j2 + 1], a, bb[2], bb[3]);
          }
        }
      } else {
        const int key0 = w * KW + 2 * t4;
#pragma unroll 1
        for (int cc = 0; cc < CPRK; ++cc) {
          const float4 qa = *reinterpret_cast<const float4*>(
              q_s + swz<L_::QROWB>(16 * team + g, cc));
          const float4 qb = *reinterpret_cast<const float4*>(
              q_s + swz<L_::QROWB>(16 * team + g + 8, cc));
          const float4 ka = *reinterpret_cast<const float4*>(
              krow + swz<L_::QROWB>(key0, cc));
          const float4 kb4 = *reinterpret_cast<const float4*>(
              krow + swz<L_::QROWB>(key0 + 1, cc));
          const float qv[2][4] = {{qa.x, qa.y, qa.z, qa.w},
                                  {qb.x, qb.y, qb.z, qb.w}};
          const float kv[2][4] = {{ka.x, ka.y, ka.z, ka.w},
                                  {kb4.x, kb4.y, kb4.z, kb4.w}};
#pragma unroll
          for (int d = 0; d < 4; ++d)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[0][e] = fmaf(qv[e >> 1][d], kv[e & 1][d], s[0][e]);
        }
      }

      // ---- scale, softcap and mask by select; the tile's row maxima
      const int win = (int)p.window;
      uint32_t okbits = 0;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rb = e >> 1;
          const int f = rb ? fB : fA;
          const int qpos = rb ? posB : posA;
          const int key = k0 + w * KW + j * 8 + 2 * t4 + (e & 1);
          float x = __fmul_rn(s[j][e], p.scale);
          if (p.has_softcap)
            x = __fmul_rn(p.softcap, tanhf(__fdiv_rn(x, p.softcap)));
          bool ok = true;
          if (!full) {
            ok = f < sl.rows && key < sl.kvalid;
            if (p.causal) ok = ok && key <= qpos;
            if (win > 0) ok = ok && key > qpos - win;
          }
          s[j][e] = ok ? x : kNegInf;
          okbits |= (uint32_t)ok << (j * 4 + e);
          mx[rb] = fmaxf(mx[rb], s[j][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      if (t4 == 0) {
        red_max[w * 16 + g] = mx[0];
        red_max[w * 16 + g + 8] = mx[1];
      }
      team_sync(team);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = red_max[g + 8 * r];
#pragma unroll
        for (int ww = 1; ww < kTeamWarps; ++ww)
          m = fmaxf(m, red_max[ww * 16 + g + 8 * r]);
        mrow[r] = m;
      }

      // ---- probabilities (0 by select where masked), sums, P to smem
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rb = e >> 1;
          const bool ok = (okbits >> (j * 4 + e)) & 1u;
          const float pr = ok ? expf(__fsub_rn(s[j][e], mrow[rb])) : 0.f;
          s[j][e] = pr;
          sum[rb] = __fadd_rn(sum[rb], pr);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 1));
        sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 2));
      }
      if (t4 == 0) {
        red_sum[w * 16 + g] = sum[0];
        red_sum[w * 16 + g + 8] = sum[1];
      }
      unsigned char* pt = p_s + team * L_::PPARTS * L_::PBYTES;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int key = w * KW + j * 8 + 2 * t4;  // within the tile
#pragma unroll
        for (int rb = 0; rb < 2; ++rb) {
          const int row = g + 8 * rb;
          const float p0 = s[j][2 * rb], p1 = s[j][2 * rb + 1];
          if constexpr (MMA) {
            const uint32_t off = swz<L_::PROWB>(row, key / 8) + (key % 8) * 2;
            const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
            const __nv_bfloat162 lo = __floats2bfloat162_rn(
                __fsub_rn(p0, __low2float(hi)),
                __fsub_rn(p1, __high2float(hi)));
            *reinterpret_cast<__nv_bfloat162*>(pt + off) = hi;
            *reinterpret_cast<__nv_bfloat162*>(pt + L_::PBYTES + off) = lo;
          } else {
            const uint32_t off = swz<L_::PROWB>(row, key / 4) + (key % 4) * 4;
            *reinterpret_cast<float2*>(pt + off) = make_float2(p0, p1);
          }
        }
      }
      team_sync(team);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = red_sum[g + 8 * r];
#pragma unroll
        for (int ww = 1; ww < kTeamWarps; ++ww)
          l = __fadd_rn(l, red_sum[ww * 16 + g + 8 * r]);
        lrow[r] = l;
      }

      // ---- o = P V over the tile's keys in order, this warp's columns
      if constexpr (MMA) {
        const uint32_t ph = p_sa + team * L_::PPARTS * L_::PBYTES;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t ah[4], al[4];
          const uint32_t po = swz<L_::PROWB>(
              (lane & 7) + ((lane >> 3) & 1) * 8, kk * 2 + (lane >> 4));
          ldmatrix_x4(ah, ph + po);
          ldmatrix_x4(al, ph + L_::PBYTES + po);
#pragma unroll
          for (int j2 = 0; j2 < NV / 2; ++j2) {
            uint32_t bb[4];
            ldmatrix_x4_trans(
                bb, vb + swz<L_::VROWB>(
                         kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                         (w * VW + j2 * 16) / 8 + (lane >> 4)));
            mma_bf16(acc[2 * j2], ah, bb[0], bb[1]);
            mma_bf16(acc[2 * j2], al, bb[0], bb[1]);
            mma_bf16(acc[2 * j2 + 1], ah, bb[2], bb[3]);
            mma_bf16(acc[2 * j2 + 1], al, bb[2], bb[3]);
          }
        }
      } else {
        const unsigned char* pt2 = p_s + team * L_::PBYTES;
#pragma unroll 1
        for (int key = 0; key < BK; ++key) {
          const uint32_t po = (key % 4) * 4;
          const float pa = *reinterpret_cast<const float*>(
              pt2 + swz<L_::PROWB>(g, key / 4) + po);
          const float pb = *reinterpret_cast<const float*>(
              pt2 + swz<L_::PROWB>(g + 8, key / 4) + po);
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            const int col = w * VW + j * 8 + 2 * t4;
            const float2 vv = *reinterpret_cast<const float2*>(
                vrow + swz<L_::VROWB>(key, col / 4) + (col % 4) * 4);
            acc[j][0] = fmaf(pa, vv.x, acc[j][0]);
            acc[j][1] = fmaf(pa, vv.y, acc[j][1]);
            acc[j][2] = fmaf(pb, vv.x, acc[j][2]);
            acc[j][3] = fmaf(pb, vv.y, acc[j][3]);
          }
        }
      }
    }

    // ---- fold the chunk's partial, or write it for combine_kernel
    if (unsplit) {
      if (active) {
        Fold fo[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          fo[r] = fold_row(M[r], Lsum[r], mrow[r], lrow[r]);
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            O[j][e] = fold_elem(fo[e >> 1], O[j][e], acc[j][e]);
      }
    } else {
      const int64_t RP = p.row_tiles * BR;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int f = r ? fB : fA;
        if (f >= sl.rows) continue;
        const int64_t idx = ((b * p.KV + kvh) * RP + f) * p.nchunks + c;
        if (w == 0 && t4 == 0) p.part_ml[idx] = make_float2(mrow[r], lrow[r]);
        if (active) {
          float* po = p.part_o + idx * DV + w * VW + 2 * t4;
#pragma unroll
          for (int j = 0; j < NV; ++j)
            *reinterpret_cast<float2*>(po + j * 8) =
                make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (!unsplit) return;
  T* Out = static_cast<T*>(p.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int f = r ? fB : fA;
    if (f >= sl.rows) continue;
    const int64_t h = kvh * sl.G + f % sl.G;
    T* out = Out + b * p.so_b + (f / sl.G) * p.so_t + h * p.so_h;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = w * VW + j * 8 + 2 * t4;
      out[col] = from_f32<T>(finish(O[j][2 * r], Lsum[r]));
      out[col + 1] = from_f32<T>(finish(O[j][2 * r + 1], Lsum[r]));
    }
  }
}

// ---------------------------------------------------------------------------
// The fold of a split call's partials: one block per (row, kv head, batch),
// each of its DV / 2 threads two value columns, chunks in ascending order.
// The loads of kGroup chunks are issued before their folds, so their
// latencies overlap; the folds themselves run one after another.
// ---------------------------------------------------------------------------

constexpr int kGroup = 8;

template <typename T, int DV, int NT>
__global__ void __launch_bounds__(DV / 2) combine_kernel(const Params p) {
  constexpr int BK = Tile<T>::BK;
  constexpr int BR = 16 * NT;
  const int64_t b = blockIdx.z;
  const int64_t kvh = blockIdx.y;
  const int f = (int)blockIdx.x;
  const int col = 2 * threadIdx.x;
  const Slot sl = slot_of(p, b);
  const int f0 = f / BR * BR;
  int c_lo, c_hi;
  tile_chunks<BK>(p, sl, f0, f0 + BR, c_lo, c_hi);
  const int64_t base = ((b * p.KV + kvh) * p.row_tiles * BR + f) * p.nchunks;
  const float2* __restrict__ ml_p = p.part_ml + base;
  const float* __restrict__ o_p = p.part_o + base * DV + col;
  float M = kNegInf, L = 0.f, O0 = 0.f, O1 = 0.f;
  for (int c0 = c_lo; c0 < c_hi; c0 += kGroup) {
    float2 ml[kGroup], o[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int c = c0 + i < c_hi ? c0 + i : c_hi - 1;
      ml[i] = __ldg(ml_p + c);
      o[i] = __ldg(reinterpret_cast<const float2*>(o_p + (int64_t)c * DV));
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      // a chunk past c_hi, or one with no visible key, is skipped: what
      // fold_row would do by select
      if (c0 + i >= c_hi || !(ml[i].y > 0.f)) continue;
      const Fold fo = fold_row(M, L, ml[i].x, ml[i].y);
      O0 = fold_elem(fo, O0, o[i].x);
      O1 = fold_elem(fo, O1, o[i].y);
    }
  }
  const int64_t h = kvh * sl.G + f % sl.G;
  T* out = static_cast<T*>(p.o) + b * p.so_b + (f / sl.G) * p.so_t +
           h * p.so_h;
  out[col] = from_f32<T>(finish(O0, L));
  out[col + 1] = from_f32<T>(finish(O1, L));
}

// ---------------------------------------------------------------------------
// Host side: launch one instantiation (and, split, its combine)
// ---------------------------------------------------------------------------

template <typename T, int D, int DV, int NT, bool PAGED>
cudaError_t launch(Params p, cudaStream_t stream) {
  using L_ = Layout<T, D, DV, NT>;
  // Above 48 KB a kernel must opt in to dynamic shared memory.  The
  // attribute belongs to the kernel on the current device; the port runs
  // one device per process, so it is set once per instantiation.
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<T, D, DV, NT, PAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L_::BYTES);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  p.row_tiles = (p.Tq * (p.H / p.KV) + L_::BR - 1) / L_::BR;
  p.nchunks = (p.S + L_::BK - 1) / L_::BK;
  if (p.splits < 1 || (p.splits > 1) != (p.part_o != nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(p.row_tiles * p.B),
                  (unsigned)(p.KV * p.splits), 1u);
  attn_kernel<T, D, DV, NT, PAGED>
      <<<grid, kTeamThreads * NT, L_::BYTES, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.part_o == nullptr) return e;
  const dim3 cgrid((unsigned)(p.Tq * (p.H / p.KV)), (unsigned)p.KV,
                   (unsigned)p.B);
  combine_kernel<T, DV, NT><<<cgrid, DV / 2, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int NT, bool PAGED>
cudaError_t dispatch_dims(int d, int dv, const Params& p, cudaStream_t s) {
  if (d == 64 && dv == 64) return launch<T, 64, 64, NT, PAGED>(p, s);
  if (d == 128 && dv == 128) return launch<T, 128, 128, NT, PAGED>(p, s);
  if (d == 256 && dv == 256) return launch<T, 256, 256, NT, PAGED>(p, s);
  if (d == 192 && dv == 128) return launch<T, 192, 128, NT, PAGED>(p, s);
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16
inline int key_tile(int dtype) {
  return dtype == 0 ? Tile<float>::BK : Tile<__nv_bfloat16>::BK;
}

}  // namespace
}  // namespace flash
