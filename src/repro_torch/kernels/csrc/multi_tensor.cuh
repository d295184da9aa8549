// Segment tables for grouped launches: one kernel launch over a list of
// tensors (the fused DSGD update over every leaf of a model, the gossip
// combine over every tensor of a bucket, the quantize+EF pass and the
// quantized combine over every reference leaf of a bucket).  Included by
// fused_dsgd.cu, gossip_mix.cu and quantized_gossip.cu; the Python side
// that builds the tables is repro_torch/kernels/multi_tensor.py, and the
// two must agree on every constant below.
//
// The table.  A segment is one tensor: a record of `nptr` pointers (the
// kernel's streams: inputs, then outputs) followed by kMeta words:
//   numel      elements of the segment (>= 1: empty tensors are dropped)
//   cols       row length for a per-row scale (0: no rows)
//   chunk_end  the prefix sum of the segments' chunk counts, this one's
//              included; a segment's chunks are [previous end, chunk_end)
//   vec        1 where every pointer is 16-byte aligned and cols is a
//              multiple of the vector width: the 16-byte vector loop;
//              0: the scalar loop
// A chunk is kThreads * kUnroll vectors of 16 bytes of the input type
// (8,192 bf16 or 4,096 f32 elements) and never crosses a segment, so a
// segment's last chunk is short.  Indices are 64-bit: one segment may
// pass 2^31 elements.
//
// How the table reaches the card: as a kernel parameter, marked
// __grid_constant__ so that the kernel reads it in place (indexed by
// runtime values) and no thread copies it.  CUDA 12.1 and later on
// Volta and later take 32,764 bytes of parameters; the table uses
// 31,888, so one launch takes up to 3,968 / (nptr + 4) segments (440
// fused DSGD leaves, 566 combines of two slots), and the Python side
// splits a longer list into several launches.  A parameter needs no
// host staging, no copy on the stream and no pinned buffer kept alive
// until the copy has run, and a CUDA graph captures it by value.
//
// Row tables, for the kernels with one scale per row of `cols` elements
// (quantized_gossip.cu, one warp per row): a record is `nptr` pointers
// and kRowMeta words, the four above and
//   row_offset the global index of the segment's row 0 (an int64 as its
//              64-bit two's complement), for the hash of the quantizer
// and a chunk is whole rows of the segment: rows_per_chunk(cols) of
// them, as many as fit kRowChunkElems elements but at least one per warp
// of the block, so a chunk never splits a row or crosses a segment, and
// a segment's last chunk may hold fewer rows.  Such a table holds up to
// 3,968 / (nptr + 5) segments (396 quantize records with err, 440
// combines of one payload).  The vector flag's rule is the kernel's own
// (`vec_cols`, `max_cols` in fill_row_table).
//
// The grid is persistent: as many blocks as the SMs hold at the kernel's
// occupancy (capped by the chunk count), each walking chunk ids with a
// grid stride.  A block's chunk ids rise, so its segment is found by
// advancing a cursor through the table, which every thread of the block
// reads at the same address.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mt {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // 16-byte vectors in flight per stream
constexpr int kTableWords = 3968;
constexpr int kMaxWeights = 32;
constexpr int kMeta = 4;          // numel, cols, chunk_end, vec
constexpr int kNumel = 0, kCols = 1, kChunkEnd = 2, kVec = 3;
constexpr int kRowMeta = 5;       // the four, then row_offset
constexpr int kRowOffset = 4;
constexpr int64_t kRowChunkElems = 4096;
constexpr int kWarps = kThreads / 32;

struct Table {
  uint64_t w[kTableWords];        // the records, back to back
  float weight[kMaxWeights];      // the gossip combine's slot weights
  int nseg;
  int nptr;                       // pointers per record
  int64_t chunks;                 // chunk_end of the last record
};
// the rest of a kernel's parameters fits in what is left of 32,764 bytes
static_assert(sizeof(Table) + 256 <= 32764, "table outgrows the parameters");

template <typename T>
__host__ __device__ constexpr int vec_elems() {
  return 16 / (int)sizeof(T);
}
template <typename T>
__host__ __device__ constexpr int64_t chunk_elems() {
  return (int64_t)kThreads * kUnroll * vec_elems<T>();
}

// One chunk of one segment: its record and where it starts.
struct Chunk {
  const uint64_t* rec;  // the segment's pointers, then its kMeta words
  int64_t begin;        // first element of the chunk in the segment
  int64_t n;            // elements of the chunk
  bool vec;
  int64_t cols;
};

// Calls body(chunk) for each chunk of this block, in rising order.
template <typename T, typename F>
__device__ __forceinline__ void for_each_chunk(const Table& t, F&& body) {
  const int stride = t.nptr + kMeta;
  const uint64_t* rec = t.w;
  int64_t seg_first = 0;
  for (int64_t c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    int64_t end = (int64_t)rec[t.nptr + kChunkEnd];
    while (c >= end) {
      seg_first = end;
      rec += stride;
      end = (int64_t)rec[t.nptr + kChunkEnd];
    }
    const int64_t numel = (int64_t)rec[t.nptr + kNumel];
    const int64_t begin = (c - seg_first) * chunk_elems<T>();
    const int64_t left = numel - begin;
    Chunk ch{rec, begin, left < chunk_elems<T>() ? left : chunk_elems<T>(),
             rec[t.nptr + kVec] != 0, (int64_t)rec[t.nptr + kCols]};
    body(ch);
  }
}

// Whole rows per chunk of a row table.
__host__ __device__ constexpr int64_t rows_per_chunk(int64_t cols) {
  return kRowChunkElems / cols > kWarps ? kRowChunkElems / cols : kWarps;
}

// One chunk of one segment of a row table: its record and its rows.
struct RowChunk {
  const uint64_t* rec;  // the segment's pointers, then its kRowMeta words
  int64_t row0;         // first row of the chunk in the segment
  int64_t rows;         // rows of the chunk
  int64_t cols;
  uint64_t row_offset;  // the global index of the segment's row 0
  bool vec;
};

// Calls body(chunk) for each chunk of a row table of this block, in
// rising order.
template <typename F>
__device__ __forceinline__ void for_each_row_chunk(const Table& t,
                                                   F&& body) {
  const int stride = t.nptr + kRowMeta;
  // The cursor is a 32-bit segment index, and the segment's first chunk
  // is read again from the table: carried across the chunk's body as a
  // 64-bit value, ptxas kept it on the stack in the quantize kernel
  // without err (8 bytes, 24 B of spill stores and loads).
  int seg = 0;
  for (int64_t c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    while (c >= (int64_t)t.w[seg * stride + t.nptr + kChunkEnd]) ++seg;
    const uint64_t* rec = t.w + seg * stride;
    const int64_t seg_first =
        seg ? (int64_t)rec[t.nptr + kChunkEnd - stride] : 0;
    const int64_t cols = (int64_t)rec[t.nptr + kCols];
    const int64_t rows = (int64_t)rec[t.nptr + kNumel] / cols;
    const int64_t per = rows_per_chunk(cols);
    const int64_t row0 = (c - seg_first) * per;
    const int64_t left = rows - row0;
    RowChunk ch{rec, row0, left < per ? left : per, cols,
                rec[t.nptr + kRowOffset], rec[t.nptr + kVec] != 0};
    body(ch);
  }
}

// 16 bytes of T, widened to f32 (lane j), and back.
template <typename T>
__device__ __forceinline__ float lane(const uint4& v, int j);
template <>
__device__ __forceinline__ float lane<float>(const uint4& v, int j) {
  return reinterpret_cast<const float*>(&v)[j];
}
template <>
__device__ __forceinline__ float lane<__nv_bfloat16>(const uint4& v, int j) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&v)[j]);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as PyTorch does
}

// Loads 16 bytes at p (16-byte aligned), streaming: each byte is read once.
__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

// Stores V f32 values as V elements of T at p, streaming: 8, 16 or 32
// bytes, p 16-byte aligned.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&a)[V]) {
  constexpr int kBytes = V * (int)sizeof(T);
  static_assert(kBytes == 8 || kBytes == 16 || kBytes == 32, "width");
  if constexpr (kBytes == 8) {
    uint2 v;
    T* h = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < V; ++j) h[j] = from_f32<T>(a[j]);
    __stcs(reinterpret_cast<uint2*>(p), v);
  } else {
    constexpr int kWords = kBytes / 16;
    constexpr int kPer = V / kWords;
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      uint4 v;
      T* h = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int j = 0; j < kPer; ++j) h[j] = from_f32<T>(a[q * kPer + j]);
      __stcs(reinterpret_cast<uint4*>(p) + q, v);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Copies the Python side's records into t after checking them: record
// sizes, chunk prefix sums against the kernel's chunk size (`chunk`
// elements), pointers, row lengths (where `rows`: cols >= 1 and a divisor
// of numel), and the vector flag (pointers 16-byte aligned, cols a
// multiple of the `vec` elements of a vector).  Returns cudaSuccess or
// cudaErrorInvalidValue.
inline cudaError_t fill_table(Table& t, const uint64_t* words, int nseg,
                              int nptr, int64_t chunk, int vec, bool rows) {
  const int stride = nptr + kMeta;
  if (words == nullptr || nseg < 1 || nptr < 1 ||
      (int64_t)nseg * stride > kTableWords)
    return cudaErrorInvalidValue;
  int64_t end = 0;
  for (int s = 0; s < nseg; ++s) {
    const uint64_t* rec = words + (int64_t)s * stride;
    const int64_t numel = (int64_t)rec[nptr + kNumel];
    const int64_t cols = (int64_t)rec[nptr + kCols];
    if (numel < 1 || cols < 0) return cudaErrorInvalidValue;
    if (rows && (cols < 1 || numel % cols != 0)) return cudaErrorInvalidValue;
    end += (numel + chunk - 1) / chunk;
    if ((int64_t)rec[nptr + kChunkEnd] != end) return cudaErrorInvalidValue;
    bool aligned = cols % vec == 0;
    for (int k = 0; k < nptr; ++k) {
      if (rec[k] == 0) return cudaErrorInvalidValue;
      aligned = aligned && (rec[k] & 15u) == 0;
    }
    const uint64_t flag = rec[nptr + kVec];
    if (flag > 1 || (flag == 1 && !aligned)) return cudaErrorInvalidValue;
  }
  for (int64_t i = 0; i < (int64_t)nseg * stride; ++i) t.w[i] = words[i];
  t.nseg = nseg;
  t.nptr = nptr;
  t.chunks = end;
  return cudaSuccess;
}

// Copies a row table's records into t after checking them: record
// sizes, pointers, cols >= 1 and a divisor of numel, the chunk prefix
// sums against rows_per_chunk, and the vector flag (every pointer 16-byte
// aligned, cols a multiple of `vec_cols` and at most `max_cols`).
// Returns cudaSuccess or cudaErrorInvalidValue.
inline cudaError_t fill_row_table(Table& t, const uint64_t* words, int nseg,
                                  int nptr, int64_t vec_cols,
                                  int64_t max_cols) {
  const int stride = nptr + kRowMeta;
  if (words == nullptr || nseg < 1 || nptr < 1 ||
      (int64_t)nseg * stride > kTableWords)
    return cudaErrorInvalidValue;
  int64_t end = 0;
  for (int s = 0; s < nseg; ++s) {
    const uint64_t* rec = words + (int64_t)s * stride;
    const int64_t numel = (int64_t)rec[nptr + kNumel];
    const int64_t cols = (int64_t)rec[nptr + kCols];
    if (numel < 1 || cols < 1 || numel % cols != 0)
      return cudaErrorInvalidValue;
    const int64_t per = rows_per_chunk(cols);
    end += (numel / cols + per - 1) / per;
    if ((int64_t)rec[nptr + kChunkEnd] != end) return cudaErrorInvalidValue;
    bool aligned = cols % vec_cols == 0 && cols <= max_cols;
    for (int k = 0; k < nptr; ++k) {
      if (rec[k] == 0) return cudaErrorInvalidValue;
      aligned = aligned && (rec[k] & 15u) == 0;
    }
    const uint64_t flag = rec[nptr + kVec];
    if (flag > 1 || (flag == 1 && !aligned)) return cudaErrorInvalidValue;
  }
  for (int64_t i = 0; i < (int64_t)nseg * stride; ++i) t.w[i] = words[i];
  t.nseg = nseg;
  t.nptr = nptr;
  t.chunks = end;
  return cudaSuccess;
}

// Blocks for a persistent launch of Kernel over `chunks` chunks: the
// SMs times the blocks of kThreads that fit on one at the kernel's
// registers, at most one per chunk.  Read once per kernel and kept.
template <auto Kernel>
inline int persistent_blocks(int64_t chunks) {
  static const int per_card = [] {
    int dev = 0, sms = 0, occ = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, Kernel, kThreads, 0);
    const int blocks = sms * (occ > 0 ? occ : 1);
    return blocks > 0 ? blocks : 132;
  }();
  return chunks < per_card ? (int)chunks : per_card;
}

}  // namespace mt
