// Flash-attention forward for Hopper (sm_90a) over dense K/V: the launcher
// of flash_core.cuh's body with dense key addressing.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:310, body _flash_kernel at :54).
// What it computes, the row contract it holds, its design and what bounds
// it on the H100 are in flash_core.cuh's header.
//
// Layout: the kernel reads the model layout through strides — q (B, Tq, H,
// D), k (B, S, KV, D), v (B, S, KV, DV), out (B, Tq, H, DV), each with a
// contiguous last dimension and 16-byte aligned rows.  block_rows is 16
// (one team of 4 warps) or 64 (four teams sharing each K/V tile); a row's
// bits do not depend on it.  splits > 1 cuts each row tile's chunks over
// that many blocks, which write f32 partials to part_o / part_ml (sized by
// the caller: B * KV * row_tiles * block_rows * ceil(S / key tile) rows of
// DV and of 2 floats), and a combine kernel folds them; the result equals
// splits = 1 bit for bit.
#include "flash_core.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launches (0 on success); nothing is synchronised.
int repro_flash_attention_fwd(
    int dtype, int d, int dv, int block_rows, const void* q, const void* k,
    const void* v, void* o, int64_t B, int64_t Tq, int64_t H, int64_t KV,
    int64_t S, int64_t sq_b, int64_t sq_t, int64_t sq_h, int64_t sk_b,
    int64_t sk_s, int64_t sk_h, int64_t sv_b, int64_t sv_s, int64_t sv_h,
    int64_t so_b, int64_t so_t, int64_t so_h, const int32_t* q_start,
    const int32_t* k_valid, int64_t q_start0, int64_t k_valid0, int causal,
    int64_t window, int has_softcap, float softcap, float scale, int splits,
    float* part_o, float* part_ml, void* stream) {
  flash::Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.part_o = part_o;
  p.part_ml = reinterpret_cast<float2*>(part_ml);
  p.q_start = q_start;
  p.k_valid = k_valid;
  p.q_start0 = q_start0;
  p.k_valid0 = k_valid0;
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
  p.causal = causal;
  p.window = window;
  p.has_softcap = has_softcap;
  p.softcap = softcap;
  p.scale = scale;
  p.splits = splits;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using flash::dispatch_dims;
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0 && block_rows == 16)
    e = dispatch_dims<float, 1, false>(d, dv, p, s);
  if (dtype == 0 && block_rows == 64)
    e = dispatch_dims<float, 4, false>(d, dv, p, s);
  if (dtype == 1 && block_rows == 16)
    e = dispatch_dims<__nv_bfloat16, 1, false>(d, dv, p, s);
  if (dtype == 1 && block_rows == 64)
    e = dispatch_dims<__nv_bfloat16, 4, false>(d, dv, p, s);
  return (int)e;
}

// keys per tile and per chunk for dtype (the split scratch's chunk count)
int repro_flash_key_tile(int dtype) { return flash::key_tile(dtype); }

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
