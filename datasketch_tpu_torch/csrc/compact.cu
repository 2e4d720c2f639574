// Kernel 8: ragged compaction of a padded threshold result.
//
// Replaces no TPU kernel: the JAX package copies its padded [Q, W] result
// (datasketch_tpu/ops/lsh_ops.py::threshold_select's sel_ids / sel_sc) to
// the host whole and walks every slot there. On the H100 that copy and walk
// were most of a bands threshold call (1,024 x 3,200 slots for a few
// hundred answers), so the port compacts on the card and the host copies
// only counts and answers.
//
// counts[q] = filled slots (id >= 0) of row q; flat_ids[0, total) and
// flat_sc[0, total) hold every filled slot, row after row, each row in its
// own order (a -1 may sit anywhere in a row). Places past the answers are
// not written.
//
// Bound on the H100: device-memory bytes, the [Q, W] ids read twice (to
// count, then to place) plus the answers' scores read and the answers
// written: ~26 MB at Q 1,024 x W 3,200, ~8 us at 3.35 TB/s. Design: two
// launches, one warp a row in each, so no slot needs a global scan and no
// write contends. count: kUnroll coalesced 32-id loads in flight a warp, a
// ballot and popc each. place: the block's threads first sum the counts of
// every earlier row (the flat offset of its first row; at most Q ints, read
// from L2), then each warp walks its row as count did and writes its filled
// slots at the offset plus the popc of the ballot below its lane, so the
// row's order is kept; a score is read only for a filled slot.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // rows a block
constexpr int kUnroll = 8;             // 32-id loads a warp has in flight
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
compact_count(const int* __restrict__ ids, int nq, int w, int* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= nq) return;  // whole warps leave together
  const int* r = ids + static_cast<long long>(row) * w;
  int n = 0;
  for (int j0 = 0; j0 < w; j0 += 32 * kUnroll) {
    int v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * 32 + lane;
      v[u] = j < w ? __ldg(r + j) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) n += __popc(__ballot_sync(kFull, v[u] >= 0));
  }
  if (lane == 0) counts[row] = n;
}

__global__ void __launch_bounds__(kThreads)
compact_place(const int* __restrict__ ids, const float* __restrict__ sc,
              const int* __restrict__ counts, int nq, int w, int* __restrict__ flat_ids,
              float* __restrict__ flat_sc) {
  __shared__ long long s_before[kWarps];  // per warp: part of the earlier blocks' rows
  __shared__ int s_rows[kWarps];          // this block's row counts
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kWarps;
  const int row = row0 + warp;
  long long before = 0;
  for (int i = threadIdx.x; i < row0; i += kThreads) before += counts[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) before += __shfl_down_sync(kFull, before, off);
  if (lane == 0) {
    s_before[warp] = before;
    s_rows[warp] = row < nq ? counts[row] : 0;
  }
  __syncthreads();
  long long at = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) at += s_before[i] + (i < warp ? s_rows[i] : 0);
  if (row >= nq) return;
  const int* r = ids + static_cast<long long>(row) * w;
  const float* rs = sc == nullptr ? nullptr : sc + static_cast<long long>(row) * w;
  const unsigned below = (1u << lane) - 1u;
  for (int j0 = 0; j0 < w; j0 += 32 * kUnroll) {
    int v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * 32 + lane;
      v[u] = j < w ? __ldg(r + j) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned filled = __ballot_sync(kFull, v[u] >= 0);
      if (v[u] >= 0) {
        const long long k = at + __popc(filled & below);
        flat_ids[k] = v[u];
        if (rs != nullptr) flat_sc[k] = __ldg(rs + j0 + u * 32 + lane);
      }
      at += __popc(filled);
    }
  }
}

}  // namespace

extern "C" int ds_compact_rows(const void* ids, const void* sc, int nq, int w, void* counts,
                               void* flat_ids, void* flat_sc, void* stream) {
  if (nq > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    const int blocks = (nq + kWarps - 1) / kWarps;
    const int* id = static_cast<const int*>(ids);
    int* cnt = static_cast<int*>(counts);
    compact_count<<<blocks, kThreads, 0, st>>>(id, nq, w, cnt);
    if (w > 0) {
      compact_place<<<blocks, kThreads, 0, st>>>(id, static_cast<const float*>(sc), cnt, nq, w,
                                                 static_cast<int*>(flat_ids),
                                                 static_cast<float*>(flat_sc));
    }
  }
  return static_cast<int>(cudaGetLastError());
}
