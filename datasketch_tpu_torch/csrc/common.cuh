// Shared pieces of the equality-count kernels (score, top-k scan).
//
// Signatures are int32 slots holding uint32 bit patterns; a score is the
// number of equal slots between a query row and a db row, turned into f32
// only when it is written out, as f32(count) * f32(1/P) -- the JAX
// package's rounding (its f32 mean multiplies by the reciprocal; equal to
// count / P for power-of-two P). Distinct counts give distinct scores, so
// an integer count orders exactly like the score.
//
// Tiling: a block of kThreads threads holds kQB query rows and kRB db rows
// in shared memory, each padded to a row stride of round4(P) + 4 ints.
// Thread t owns db row (t % kRB) against kQPT queries (t / kRB) * kQPT ...:
// the 32 lanes of a warp read 32 different db rows (the +4 pad puts
// neighbouring rows on different banks, so the 16-byte loads do not
// conflict) and the same query words (a broadcast).
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

// counts[i] = equal slots between staged query (g * kQPT + i) and staged
// db row r.
__device__ inline void tile_counts(const int* q_s, const int* db_s,
                                   int stride, int r, int g,
                                   int (&counts)[kQPT]) {
#pragma unroll
  for (int i = 0; i < kQPT; ++i) counts[i] = 0;
  const int4* drow = reinterpret_cast<const int4*>(db_s + r * stride);
  const int4* qbase = reinterpret_cast<const int4*>(q_s + g * kQPT * stride);
  const int qstep = stride / 4;
  const int nvec = stride / 4 - 1;  // the last int4 is the bank pad
  for (int c = 0; c < nvec; ++c) {
    const int4 d = drow[c];
#pragma unroll
    for (int i = 0; i < kQPT; ++i) {
      const int4 qv = qbase[i * qstep + c];
      counts[i] += (d.x == qv.x) + (d.y == qv.y) + (d.z == qv.z) + (d.w == qv.w);
    }
  }
}

}  // namespace dst
