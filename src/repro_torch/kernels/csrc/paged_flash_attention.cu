// Paged flash-attention forward for Hopper (sm_90a): the launcher of
// flash_core.cuh's body with page-table key addressing.
//
// Replaces the TPU kernel paged_flash_attention_pallas
// (src/repro/kernels/flash_attention.py:216, body _paged_flash_kernel at
// :136).  Key position s of slot b lives at pool[table[b, s / ps], s % ps];
// each key tile's page offsets are looked up once per tile by the block.
// What it computes, the row contract that makes speculative decoding
// lossless (a verify window equals one-row calls, and a paged row equals a
// dense row over the same bits), its design and what bounds it on the H100
// are in flash_core.cuh's header.
//
// Layout: q (B, Tq, H, D), pools (P, ps, KV, D) and (P, ps, KV, DV), out
// (B, Tq, H, DV), each read through strides with a contiguous last
// dimension and 16-byte aligned rows; the block table is (B, maxp) int32
// with rows table_stride apart.  Only the table entries j < ceil(k_valid /
// ps) are read, and those must be page ids in [0, P): the kernel does not
// check them.  Blocks hold one 16-row team.  splits > 1 cuts each row
// tile's chunks over that many blocks, as in flash_attention.cu, with
// scratch of B * KV * row_tiles * 16 * ceil(maxp * ps / key tile) rows.
#include "flash_core.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launches (0 on success); nothing is synchronised.
int repro_paged_flash_attention_fwd(
    int dtype, int d, int dv, const void* q, const void* k, const void* v,
    void* o, const int32_t* table, const int32_t* q_start,
    const int32_t* k_valid, int64_t B, int64_t Tq, int64_t H, int64_t KV,
    int64_t ps, int64_t maxp, int64_t sq_b, int64_t sq_t, int64_t sq_h,
    int64_t sk_p, int64_t sk_s, int64_t sk_h, int64_t sv_p, int64_t sv_s,
    int64_t sv_h, int64_t so_b, int64_t so_t, int64_t so_h, int64_t st_b,
    int causal, int64_t window, int has_softcap, float softcap, float scale,
    int splits, float* part_o, float* part_ml, void* stream) {
  flash::Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.part_o = part_o;
  p.part_ml = reinterpret_cast<float2*>(part_ml);
  p.table = table;
  p.q_start = q_start;
  p.k_valid = k_valid;
  p.B = B;
  p.Tq = Tq;
  p.H = H;
  p.KV = KV;
  p.S = maxp * ps;
  p.ps = ps;
  p.st_b = st_b;
  p.sq_b = sq_b;
  p.sq_t = sq_t;
  p.sq_h = sq_h;
  p.sk_b = sk_p;
  p.sk_s = sk_s;
  p.sk_h = sk_h;
  p.sv_b = sv_p;
  p.sv_s = sv_s;
  p.sv_h = sv_h;
  p.so_b = so_b;
  p.so_t = so_t;
  p.so_h = so_h;
  p.causal = causal;
  p.window = window;
  p.has_softcap = has_softcap;
  p.softcap = softcap;
  p.scale = scale;
  p.splits = splits;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using flash::dispatch_dims;
  if (dtype == 0) return (int)dispatch_dims<float, 1, true>(d, dv, p, s);
  if (dtype == 1)
    return (int)dispatch_dims<__nv_bfloat16, 1, true>(d, dv, p, s);
  return (int)cudaErrorInvalidValue;
}

// keys per tile and per chunk for dtype (the split scratch's chunk count)
int repro_paged_key_tile(int dtype) { return flash::key_tile(dtype); }

const char* repro_paged_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
