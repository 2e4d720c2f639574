// Kernel 2: fused exact-scan top-k with hit counting (k <= 128).
//
// Replaces datasketch_tpu/ops/pallas_kernels.py::_topk_scan_kernel /
// topk_scan_pallas in all three of its modes: plain, alive-mask and sizes
// (containment). Per query: the top-k (id, score) among valid db rows that
// are hits, in the total order (score desc, id asc) -- the order lax.top_k
// gives over the TPU kernel's carry-then-tile concat -- empty slots
// (-1, -1.0), plus the number of hits.
// A row is valid when row < n_valid and alive[row] != 0 (when a mask is
// given).
//
// Plain and mask modes: the score is the Jaccard estimate of common.cuh
// and the carry ranks the integer count, which orders exactly like it. A
// hit has count >= `min_count`, the least count whose f32 score f32(count)
// * f32(1/P) reaches the caller's f32 cutoff, computed on the host, so the
// test is exact.
// Sizes mode (`sizes` given): the score is the containment estimate
// c = j*(x+q) / ((1+j)*q) of the query (size q, at least 1) in the row
// (exact size x) with j the Jaccard estimate; a row with x <= 0 is
// padding. c depends on the row's size, so no integer stands in for it:
// the hit test is the f32 compare c >= cutoff, and the carry ranks the
// bits of c as an int (c >= 0, and non-negative floats order like their
// bit patterns), so the same machinery serves both modes.
//
// Bound on the H100: one integer compare per (query, row, slot), 1.37e11
// at Q 1,024, N 2**20, P 128: 8.2 ms at 64 integer lanes x 132 SMs x
// 1,980 MHz. The db stream comes second: each block of 32 queries reads
// its share of the N*4P-byte table once, so the table crosses the L2 Q/32
// times. The containment score adds ~5 f32 ops per (query, row) pair,
// small beside the P-slot compare.
//
// Design (the TPU grid ran its db axis in order and carried the top-k in
// VMEM):
// - Grid: (query blocks of kQB = 32, splits of the db axis). The wrapper
//   sizes the splits so that the blocks fill the card's resident slots in
//   one whole wave (ds_topk_scan_blocks_per_sm reports them per SM); a
//   block of a second wave would run while most of the card idles. Each
//   split is a whole number of kRB = 64-row tiles.
// - Staging: the query tile is staged once; db tiles are copied with
//   cp.async (16-byte where P % 4 == 0 and the table is 16-byte aligned,
//   else 4-byte), with no pass through registers, into one buffer. A
//   block (70,528 bytes at P 128, k 10; 100,736 at k 128; under 80
//   registers a thread, where 3 blocks allow 85) fits 3 times on an SM at
//   k 10 and 16 and twice at k 128, and the other resident blocks count
//   while one waits for its tile. A
//   second buffer, to copy tile t + 1 while tile t is counted, costs a
//   resident block at P 100 and 128 and was slower there, and no faster
//   at P 64 where it costs none (PERF.md).
// - Counts: each thread counts 2 db rows x 4 queries (kRowsPT x
//   kQueriesPT, the thread map below), so one staged 16-byte word feeds 8
//   compares: 6 LDS.128 per 32 compares, where 1 row x 8 queries took 9.
//   Each slot costs one ISETP and one predicated f32 FADD (count_equal).
// - Top-k: each (query block, split) keeps a sorted per-query top-k in
//   shared memory; a tile's rows go to a per-query candidate buffer only
//   when they beat the current k-th best (most tiles add nothing, like the
//   TPU kernel's can_improve skip), and one warp per query merges the
//   buffer by rank, in the tiles where any row was added. A second small
//   kernel merges the splits' lists per query by rank; both merges are
//   exact in the total order, so the result does not depend on the split
//   count or on the order in which threads append.
#include <climits>

#include "common.cuh"

namespace {

using namespace dst;

constexpr int kMaxK = 128;

// Ranking keys: the count (plain and mask modes) or the bits of c (sizes
// mode), both >= 0; -1 marks an empty slot.
__device__ __forceinline__ bool better(int c1, int id1, int c2, int id2) {
  return c1 > c2 || (c1 == c2 && id1 < id2);
}

// Containment estimate in the JAX package's f32 op order: j = f32(count) *
// f32(1/P), then (j * (x + q)) / ((1 + j) * q). The _rn intrinsics are
// never contracted into an FMA (nvcc's default --fmad=true would fuse
// `count * inv_p + 1`, which rounds once where JAX rounds twice).
__device__ __forceinline__ float containment(int count, float inv_p, float xf,
                                             float qf) {
  const float j = __fmul_rn(static_cast<float>(count), inv_p);
  return __fdiv_rn(__fmul_rn(j, __fadd_rn(xf, qf)),
                   __fmul_rn(__fadd_rn(1.0f, j), qf));
}

// Shared memory of a block, in ints.
__host__ __device__ inline size_t scan_smem_ints(int p, int k) {
  return static_cast<size_t>(kQB + kRB) * row_stride(p)  // q and db tiles
         + 2 * kQB * k                                   // carry (key, id)
         + 2 * kQB * kRB                                 // candidates
         + 4 * kQB                                       // n_buf, n_carry, thr, hits
         + kRB + kQB;                                    // row sizes, query sizes
}

// Merge query qi's candidate buffer into its sorted carry (one warp).
__device__ void merge_candidates(int* cc, int* ci, const int* bc,
                                 const int* bi, int* n_buf, int* n_carry,
                                 int* thr, int qi, int k, int lane) {
  const int nc = n_carry[qi];
  const int nb = n_buf[qi];
  constexpr int kCarryPerLane = kMaxK / 32;
  constexpr int kBufPerLane = kRB / 32;
  int rank[kCarryPerLane + kBufPerLane];
  int val[kCarryPerLane + kBufPerLane];
  int ids[kCarryPerLane + kBufPerLane];
#pragma unroll
  for (int j = 0; j < kCarryPerLane; ++j) {
    const int e = lane + 32 * j;
    rank[j] = INT_MAX;
    if (e < nc) {
      const int c = cc[e], id = ci[e];
      int rk = e;  // the carry is sorted: e entries precede it
      for (int t = 0; t < nb; ++t) rk += better(bc[t], bi[t], c, id);
      rank[j] = rk;
      val[j] = c;
      ids[j] = id;
    }
  }
#pragma unroll
  for (int j = 0; j < kBufPerLane; ++j) {
    const int e = lane + 32 * j;
    const int s = kCarryPerLane + j;
    rank[s] = INT_MAX;
    if (e < nb) {
      const int c = bc[e], id = bi[e];
      int rk = 0;
      for (int t = 0; t < nc; ++t) rk += better(cc[t], ci[t], c, id);
      for (int t = 0; t < nb; ++t) rk += better(bc[t], bi[t], c, id);
      rank[s] = rk;
      val[s] = c;
      ids[s] = id;
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kCarryPerLane + kBufPerLane; ++s) {
    if (rank[s] < k) {
      cc[rank[s]] = val[s];
      ci[rank[s]] = ids[s];
    }
  }
  __syncwarp();
  if (lane == 0) {
    const int total = min(k, nc + nb);
    n_carry[qi] = total;
    thr[qi] = total == k ? cc[k - 1] : -1;
    n_buf[qi] = 0;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
topk_scan_kernel(const int* __restrict__ db, const int* __restrict__ q,
                 const unsigned char* __restrict__ alive,
                 const int* __restrict__ sizes, const int* __restrict__ q_sizes,
                 int nq, long long n, int p, long long n_valid, int min_count,
                 float cutoff, int k, long long rows_per_split,
                 int* __restrict__ part_cnt, int* __restrict__ part_id,
                 int* __restrict__ hit_count) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const int stride = row_stride(p);
  int* q_s = smem;
  int* db_s = q_s + kQB * stride;
  int* carry_c = db_s + kRB * stride;
  int* carry_i = carry_c + kQB * k;
  int* buf_c = carry_i + kQB * k;
  int* buf_i = buf_c + kQB * kRB;
  int* n_buf = buf_i + kQB * kRB;
  int* n_carry = n_buf + kQB;
  int* thr = n_carry + kQB;
  int* hits_s = thr + kQB;
  int* x_s = hits_s + kQB;                             // the tile's row sizes
  float* qf_s = reinterpret_cast<float*>(x_s + kRB);   // f32 query sizes, >= 1
  const bool use_sizes = sizes != nullptr;
  const bool vec = (p & 3) == 0 && (reinterpret_cast<uintptr_t>(db) & 15) == 0;
  const float inv_p = 1.0f / static_cast<float>(p);

  const int q0 = blockIdx.x * kQB;
  const long long r_begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long r_end = min(n, r_begin + rows_per_split);
  const int n_tiles = r_end > r_begin
                          ? static_cast<int>((r_end - r_begin + kRB - 1) / kRB) : 0;
  stage_rows(q_s, q, q0, kQB, nq, p, stride, 0);
  // the db pad columns: 1, never equal to the query tile's 0 pad
  for (int i = threadIdx.x; i < kRB * (stride - p); i += blockDim.x) {
    const int r = i / (stride - p);
    db_s[r * stride + p + (i - r * (stride - p))] = 1;
  }
  for (int i = threadIdx.x; i < kQB; i += blockDim.x) {
    n_buf[i] = 0;
    n_carry[i] = 0;
    thr[i] = q0 + i < nq ? -1 : INT_MAX;  // padding queries take nothing
    hits_s[i] = 0;
    qf_s[i] = use_sizes && q0 + i < nq
                  ? static_cast<float>(max(q_sizes[q0 + i], 1)) : 1.0f;
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int r0, lq;  // rows r0 and r0 + 4, queries lq + 8 j
  tile_coords(r0, lq);
  int hits[kQueriesPT];
#pragma unroll
  for (int j = 0; j < kQueriesPT; ++j) hits[j] = 0;

  for (int t = 0; t < n_tiles; ++t) {
    const long long row0 = r_begin + static_cast<long long>(t) * kRB;
    // every thread is past its reads of tile t - 1 (the __syncthreads_or)
    issue_tile(db_s, x_s, db, sizes, row0, r_end, p, stride, vec);
    cp_async_wait_all();
    __syncthreads();  // tile t is in; the previous tile's merge is done
    int counts[kRowsPT][kQueriesPT];
    block_counts(q_s, db_s, stride, r0, lq, counts);
    int appended = 0;
#pragma unroll
    for (int h = 0; h < kRowsPT; ++h) {
      const int rr = r0 + 4 * h;
      const long long row = row0 + rr;
      const int x = use_sizes ? x_s[rr] : 1;
      const bool valid = row < r_end && row < n_valid && x > 0 &&
                         (alive == nullptr || alive[row] != 0);
      if (!valid) continue;
      const float xf = static_cast<float>(x);
#pragma unroll
      for (int j = 0; j < kQueriesPT; ++j) {
        const int qi = lq + 8 * j;
        int key;
        bool hit;
        if (use_sizes) {
          const float c = containment(counts[h][j], inv_p, xf, qf_s[qi]);
          key = __float_as_int(c);
          hit = c >= cutoff;
        } else {
          key = counts[h][j];
          hit = key >= min_count;
        }
        if (q0 + qi < nq && hit) {
          ++hits[j];
          if (key > thr[qi]) {
            const int pos = atomicAdd(&n_buf[qi], 1);
            buf_c[qi * kRB + pos] = key;
            buf_i[qi * kRB + pos] = static_cast<int>(row);
            appended = 1;
          }
        }
      }
    }
    // the tile's reads and candidates are done; merge only if any came
    if (__syncthreads_or(appended)) {
      for (int qi = warp; qi < kQB; qi += kThreads / 32) {
        if (n_buf[qi] > 0) {
          merge_candidates(carry_c + qi * k, carry_i + qi * k, buf_c + qi * kRB,
                           buf_i + qi * kRB, n_buf, n_carry, thr, qi, k, lane);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kQueriesPT; ++j) {
    if (hits[j]) atomicAdd(&hits_s[lq + 8 * j], hits[j]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kQB * k; e += blockDim.x) {
    const int qi = e / k;
    const int j = e - qi * k;
    if (q0 + qi >= nq) continue;
    const long long out = (static_cast<long long>(blockIdx.y) * nq + q0 + qi) * k + j;
    const bool has = j < n_carry[qi];
    part_cnt[out] = has ? carry_c[qi * k + j] : -1;
    part_id[out] = has ? carry_i[qi * k + j] : -1;
  }
  for (int i = threadIdx.x; i < kQB; i += blockDim.x) {
    if (q0 + i < nq && hits_s[i]) atomicAdd(&hit_count[q0 + i], hits_s[i]);
  }
}

// Merge the n_split sorted partial lists of each query: an entry's rank is
// its index in its own list plus, per other list, how many entries there
// beat it (binary search: better entries form a prefix). The score written
// is the count's f32(count) * f32(1/P), or in sizes mode (`key_is_score`)
// the key's own float bits.
__global__ void topk_merge_kernel(const int* __restrict__ part_cnt,
                                  const int* __restrict__ part_id, int nq,
                                  int n_split, int k, int p, int key_is_score,
                                  int* __restrict__ out_id,
                                  float* __restrict__ out_sc) {
  const int qi = blockIdx.x;
  const float inv_p = 1.0f / static_cast<float>(p);
  for (int e = threadIdx.x; e < n_split * k; e += blockDim.x) {
    const int s = e / k;
    const int j = e - s * k;
    const long long base = (static_cast<long long>(s) * nq + qi) * k;
    const int c = part_cnt[base + j];
    if (c < 0) continue;
    const int id = part_id[base + j];
    int rank = j;
    for (int s2 = 0; s2 < n_split && rank < k; ++s2) {
      if (s2 == s) continue;
      const long long b2 = (static_cast<long long>(s2) * nq + qi) * k;
      int lo = 0, hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        const int cm = part_cnt[b2 + mid];
        if (cm >= 0 && better(cm, part_id[b2 + mid], c, id)) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      rank += lo;
    }
    if (rank < k) {
      out_id[static_cast<long long>(qi) * k + rank] = id;
      out_sc[static_cast<long long>(qi) * k + rank] =
          key_is_score ? __int_as_float(c) : static_cast<float>(c) * inv_p;
    }
  }
}

}  // namespace

// Make the scan kernel ready for its dynamic shared memory at (p, k);
// `*fits` is false where that is more than a block may have.
static cudaError_t prepare_scan(int p, int k, size_t* smem, bool* fits) {
  *smem = sizeof(int) * scan_smem_ints(p, k);
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  *fits = err == cudaSuccess && *smem <= static_cast<size_t>(most);
  if (err != cudaSuccess || !*fits) return err;
  return cudaFuncSetAttribute(topk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

// Resident blocks of the scan kernel per SM at (p, k), 0 where a block
// does not fit, written to `*out`: the wrapper sizes its grid in whole
// waves of them.
extern "C" int ds_topk_scan_blocks_per_sm(int p, int k, void* out) {
  size_t smem = 0;
  bool fits = false;
  cudaError_t err = prepare_scan(p, k, &smem, &fits);
  int blocks = 0;
  if (err == cudaSuccess && fits) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, topk_scan_kernel,
                                                        kThreads, smem);
  }
  *static_cast<int*>(out) = blocks;
  return static_cast<int>(err);
}

// `alive`, `sizes` and `q_sizes` may be null; `sizes` and `q_sizes` are
// given together and select the sizes mode (then `cutoff` is the f32 hit
// test and `min_count` is unused). Split s scans rows [s * rows_per_split,
// (s + 1) * rows_per_split): a whole number of tiles, n_split of them
// covering the n rows.
extern "C" int ds_topk_scan(const void* db, const void* q, const void* alive,
                            const void* sizes, const void* q_sizes, int nq,
                            long long n, int p, long long n_valid,
                            int min_count, float cutoff, int k, int n_split,
                            long long rows_per_split, void* part_cnt,
                            void* part_id, void* hit_count, void* stream) {
  if ((sizes == nullptr) != (q_sizes == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k < 1 || k > kMaxK || rows_per_split < kRB || rows_per_split % kRB != 0 ||
      static_cast<long long>(n_split) * rows_per_split < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nq > 0 && n_split > 0) {
    size_t smem = 0;
    bool fits = false;
    const cudaError_t err = prepare_scan(p, k, &smem, &fits);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!fits) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>((nq + kQB - 1) / kQB),
                    static_cast<unsigned>(n_split));
    topk_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(db), static_cast<const int*>(q),
        static_cast<const unsigned char*>(alive),
        static_cast<const int*>(sizes), static_cast<const int*>(q_sizes), nq,
        n, p, n_valid, min_count, cutoff, k, rows_per_split,
        static_cast<int*>(part_cnt), static_cast<int*>(part_id),
        static_cast<int*>(hit_count));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ds_topk_merge(const void* part_cnt, const void* part_id, int nq,
                             int n_split, int k, int p, int key_is_score,
                             void* out_id, void* out_sc, void* stream) {
  if (nq > 0) {
    topk_merge_kernel<<<nq, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(part_cnt), static_cast<const int*>(part_id),
        nq, n_split, k, p, key_is_score, static_cast<int*>(out_id),
        static_cast<float*>(out_sc));
  }
  return static_cast<int>(cudaGetLastError());
}
