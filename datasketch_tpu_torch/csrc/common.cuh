// Shared pieces of the equality-count kernels (score, top-k scan, b-bit).
//
// Signatures are int32 slots holding uint32 bit patterns; a score is the
// number of equal slots between a query row and a db row, turned into f32
// only when it is written out, as f32(count) * f32(1/P) -- the JAX
// package's rounding (its f32 mean multiplies by the reciprocal; equal to
// count / P for power-of-two P). Distinct counts give distinct scores, so
// an integer count orders exactly like the score.
//
// Tiling: a block of kThreads threads holds kQB query rows and kRB db rows
// in shared memory, each padded to a row stride of round4(P) + 4 ints (the
// +4 pad puts neighbouring rows on different banks, so 16-byte loads do
// not conflict). The score and scan kernels stage the query tile once
// (stage_rows), copy db tiles with cp.async (issue_tile) and count with
// block_counts: 2 db rows x 4 queries a thread, each slot one ISETP and
// one predicated f32 FADD. The b-bit kernel stages both tiles with
// stage_rows and maps one db row x kQPT queries to a thread.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dst {

constexpr int kThreads = 256;
constexpr int kQB = 32;                      // query rows per block
constexpr int kRB = 64;                      // db rows per tile
constexpr int kQPT = kQB * kRB / kThreads;   // queries per thread (8)

__host__ __device__ inline int row_stride(int p) { return ((p + 3) / 4) * 4 + 4; }

// Stage rows [row0, row0 + rows) of a row-major [n, p] int32 matrix into
// dst[rows][stride]. Rows >= n and slots >= p are written as `fill`: the
// query tile is filled with 0 and the db tile with 1, so padding slots
// never compare equal. Rows are copied as 16-byte words when p % 4 == 0
// and `src` is 16-byte aligned (every full-table and tile slice of the
// callers is), else word by word.
__device__ inline void stage_rows(int* dst, const int* __restrict__ src,
                                  long long row0, int rows, long long n,
                                  int p, int stride, int fill) {
  if ((p & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int vs = stride / 4;
    const int vp = p / 4;
    const int4 pad = make_int4(fill, fill, fill, fill);
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < rows * vs; i += blockDim.x) {
      const int r = i / vs;
      const int c = i - r * vs;
      const long long row = row0 + r;
      d4[i] = (row < n && c < vp) ? s4[row * vp + c] : pad;
    }
    return;
  }
  const int total = rows * stride;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / stride;
    const int c = i - r * stride;
    const long long row = row0 + r;
    dst[i] = (row < n && c < p) ? src[row * p + c] : fill;
  }
}

// Thread map of a tile (kQB queries x kRB rows, kThreads threads): lane
// (lr, lq) = (lane % 4, lane / 4) of warp w counts rows w * 8 + lr and
// w * 8 + lr + 4 against queries lq + 8 j, j < 4. A warp's 16-byte shared
// loads then touch 4 distinct db rows or 8 distinct query rows, each on its
// own banks (the row stride is 4 mod 32 ints at P 128), and every loaded
// word feeds 8 compares.
constexpr int kRowsPT = 2;                       // db rows per thread
constexpr int kQueriesPT = 4;                    // queries per thread
static_assert(kThreads / 32 * 4 * kRowsPT == kRB, "rows of a tile");
static_assert(8 * kQueriesPT == kQB, "queries of a tile");

// This thread's place in the map: rows r0 and r0 + 4, queries lq + 8 j.
__device__ __forceinline__ void tile_coords(int& r0, int& lq) {
  const int lane = threadIdx.x % 32;
  r0 = threadIdx.x / 32 * 8 + (lane & 3);
  lq = lane >> 2;
}

// acc += 1 where a == b: one integer compare and one predicated f32 add.
// Summing the compares as integers costs an add and a select on top of
// the compare (the compiler's ISETP, VIADD, IMAD.MOV per slot); the f32
// add runs on the FMA pipe beside the compare's integer ALU, and a count
// of at most 2**24 is exact in f32.
__device__ __forceinline__ void count_equal(float& acc, int a, int b) {
  asm("{\n\t.reg .pred same;\n\tsetp.eq.b32 same, %1, %2;\n\t"
      "@same add.f32 %0, %0, 0f3F800000;\n\t}"
      : "+f"(acc)
      : "r"(a), "r"(b));
}

__device__ __forceinline__ void count_equal4(float& acc, const int4& a, const int4& b) {
  count_equal(acc, a.x, b.x);
  count_equal(acc, a.y, b.y);
  count_equal(acc, a.z, b.z);
  count_equal(acc, a.w, b.w);
}

// counts[h][j] = equal slots between staged db row r0 + 4 h and staged
// query lq + 8 j.
__device__ __forceinline__ void block_counts(const int* q_s, const int* db_s,
                                             int stride, int r0, int lq,
                                             int (&counts)[kRowsPT][kQueriesPT]) {
  float acc[kRowsPT][kQueriesPT];
#pragma unroll
  for (int h = 0; h < kRowsPT; ++h) {
#pragma unroll
    for (int j = 0; j < kQueriesPT; ++j) acc[h][j] = 0.0f;
  }
  const int vs = stride / 4;
  const int nvec = vs - 1;  // the last int4 is the bank pad
  const int4* d0 = reinterpret_cast<const int4*>(db_s) + r0 * vs;
  const int4* d1 = d0 + 4 * vs;
  const int4* qb = reinterpret_cast<const int4*>(q_s) + lq * vs;
#pragma unroll 4
  for (int c = 0; c < nvec; ++c) {
    const int4 a = d0[c];
    const int4 b = d1[c];
#pragma unroll
    for (int j = 0; j < kQueriesPT; ++j) {
      const int4 w = qb[8 * j * vs + c];
      count_equal4(acc[0][j], a, w);
      count_equal4(acc[1][j], b, w);
    }
  }
#pragma unroll
  for (int h = 0; h < kRowsPT; ++h) {
#pragma unroll
    for (int j = 0; j < kQueriesPT; ++j) counts[h][j] = static_cast<int>(acc[h][j]);
  }
}

// cp.async: `bytes` (16 or 4) from global to shared memory without a pass
// through registers; a source size of 0 reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0) : "memory");
}

// Wait for every cp.async this thread issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Close this thread's group of cp.async copies issued since the last one.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are still
// in flight (the older ones have landed and are visible to this thread).
template <int kPending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Issue the copy of db rows [row0, row0 + kRB) into `dst` (kRB rows of
// `stride` ints), columns [0, p) only, and their sizes into `x_dst` (sizes
// mode). Rows >= r_end are zero-filled: they fail the validity test, so
// their counts are never used. The pad columns [p, stride) are never
// written here: zero-fill there would equal the query tile's 0 pad.
__device__ inline void issue_tile(int* dst, int* x_dst, const int* __restrict__ db,
                                  const int* __restrict__ sizes, long long row0,
                                  long long r_end, int p, int stride, bool vec) {
  if (vec) {
    const int vp = p / 4;
    const int vs = stride / 4;
    const int4* src = reinterpret_cast<const int4*>(db);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < kRB * vp; i += blockDim.x) {
      const int r = i / vp;
      const int c = i - r * vp;
      const long long row = row0 + r;
      const bool in = row < r_end;
      cp_async16(d4 + r * vs + c, src + (in ? row * vp + c : 0), in);
    }
  } else {
    for (int i = threadIdx.x; i < kRB * p; i += blockDim.x) {
      const int r = i / p;
      const int c = i - r * p;
      const long long row = row0 + r;
      const bool in = row < r_end;
      cp_async4(dst + r * stride + c, db + (in ? row * p + c : 0), in);
    }
  }
  if (sizes != nullptr) {
    for (int i = threadIdx.x; i < kRB; i += blockDim.x) {
      const long long row = row0 + i;
      const bool in = row < r_end;
      cp_async4(x_dst + i, sizes + (in ? row : 0), in);
    }
  }
}

}  // namespace dst
