// Kernel 3: band-candidate rerank with the candidate gather fused in.
//
// Replaces datasketch_tpu/ops/pallas_kernels.py::_rerank_kernel /
// rerank_scores_pallas together with the db_sigs[cand_ids] gather of
// datasketch_tpu/ops/lsh_ops.py::rerank_jaccard, which on the TPU built a
// [Q, C, P] gathered intermediate in device memory (1.6 MB per query at
// C = 25 bands x 128 cap, P = 128) before scoring it.
//
// out[q, c] = f32(equal slots of query q and db row cand[q, c]) * f32(1/P),
// and 0 where cand[q, c] is -1 (or out of range).
//
// Bound on the H100: device-memory bytes, as random 4*P-byte row reads
// (one per live candidate) plus the [Q, C] ids and scores. Design: one warp
// per (query, kChunks chunks of 32 consecutive candidate slots), a flat
// grid. The warp reads each chunk's 32 ids in one coalesced load (one id a
// lane; the kChunks loads in flight together) and a ballot lists the live
// ones, so a -1 slot costs nothing past that load -- on the bands path ~99 %
// of the slots are -1, and the kernel's time is these id loads' latency.
// Live rows are taken kRows at a time: every lane issues its loads of all
// kRows rows (one 16-byte word a lane at P 128) before the first compare,
// so a warp has kRows rows in flight, not one. Each row's count is a warp sum that lands in the lane whose slot it
// is, and the 32 scores leave in one coalesced store. At P <= 128 with
// P % 4 == 0 and 16-byte aligned tables (the serving path's P 128), a lane
// moves 4 slots as one int4 word and keeps the query's word in a register;
// other P take one int32 slot a lane per step.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;    // live candidate rows a warp has in flight
constexpr int kChunks = 4;  // 32-slot chunks a warp takes, their ids read together
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int equal_slots(int a, int b) { return a == b; }

__device__ __forceinline__ int equal_slots(const int4& a, const int4& b) {
  return (a.x == b.x) + (a.y == b.y) + (a.z == b.z) + (a.w == b.w);
}

// W: int4 (the query row is at most 32 such words, one a lane, loaded once
// per warp) or int (the row walked 32 words a step). Three blocks an SM (at
// most 85 registers): four spilled the row words, two left too few rows in
// flight.
template <typename W>
__global__ void __launch_bounds__(kThreads, 3)
rerank_kernel(const int* __restrict__ db, const int* __restrict__ q,
              const int* __restrict__ cand, long long n_db, int nq, int c, int p,
              float* __restrict__ out) {
  const int groups = (c + 32 * kChunks - 1) / (32 * kChunks);
  const long long task = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (task >= static_cast<long long>(nq) * groups) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const int qi = static_cast<int>(task / groups);
  const int c0 = static_cast<int>(task - static_cast<long long>(qi) * groups) * 32 * kChunks;
  const int* __restrict__ cand_q = cand + static_cast<long long>(qi) * c;
  float* __restrict__ out_q = out + static_cast<long long>(qi) * c;
  int ids[kChunks];  // every chunk's ids in flight together
#pragma unroll
  for (int g = 0; g < kChunks; ++g) {
    const int ci = c0 + 32 * g + lane;
    ids[g] = ci < c ? cand_q[ci] : -1;
  }

  constexpr int kPer = sizeof(W) / sizeof(int);
  const int words = p / kPer;
  const W* __restrict__ dbw = reinterpret_cast<const W*>(db);
  const W* __restrict__ qw = reinterpret_cast<const W*>(q) + static_cast<long long>(qi) * words;
  constexpr bool kHeld = kPer == 4;
  W q_held{};
  if (kHeld && lane < words) q_held = qw[lane];
  const float inv_p = 1.0f / static_cast<float>(p);

#pragma unroll 1
  for (int g = 0; g < kChunks; ++g) {
    const int id = ids[g];
    const bool live = id >= 0 && id < n_db;
    unsigned mask = __ballot_sync(kFull, live);
    int cnt = 0;  // the count of this lane's own slot
    while (mask) {
      int src[kRows];
      const W* row[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        src[r] = mask ? __ffs(mask) - 1 : -1;
        mask &= mask - 1;
        const int rid = __shfl_sync(kFull, id, src[r] & 31);
        row[r] = dbw + static_cast<long long>(src[r] >= 0 ? rid : 0) * words;
      }
      int sums[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) sums[r] = 0;
      for (int w = lane; w < words; w += 32) {
        W v[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (src[r] >= 0) v[r] = row[r][w];
        }
        const W qv = kHeld ? q_held : qw[w];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (src[r] >= 0) sums[r] += equal_slots(v[r], qv);
        }
        if (kHeld) break;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (src[r] < 0) break;  // warp-uniform: the group's live rows come first
        const int total = __reduce_add_sync(kFull, sums[r]);
        if (lane == src[r]) cnt = total;
      }
    }
    const int ci = c0 + 32 * g + lane;
    if (ci < c) out_q[ci] = live ? static_cast<float>(cnt) * inv_p : 0.0f;
  }
}

template <typename W>
void launch(const void* db, const void* q, const void* cand, long long n_db, int nq,
            int c, int p, void* out, cudaStream_t stream) {
  const long long warps =
      static_cast<long long>(nq) * ((c + 32 * kChunks - 1) / (32 * kChunks));
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  rerank_kernel<W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(db), static_cast<const int*>(q),
      static_cast<const int*>(cand), n_db, nq, c, p, static_cast<float*>(out));
}

}  // namespace

extern "C" int ds_rerank(const void* db, const void* q, const void* cand,
                         long long n_db, int nq, int c, int p, void* out,
                         void* stream) {
  if (nq > 0 && c > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    const bool vec = p % 4 == 0 && (reinterpret_cast<uintptr_t>(db) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(q) & 15) == 0;
    if (vec && p <= 4 * 32) {
      launch<int4>(db, q, cand, n_db, nq, c, p, out, st);
    } else {
      launch<int>(db, q, cand, n_db, nq, c, p, out, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
