// Kernel 2: fused exact-scan top-k with hit counting (k <= 128).
//
// Replaces datasketch_tpu/ops/pallas_kernels.py::_topk_scan_kernel /
// topk_scan_pallas in its plain and alive-mask modes (the sizes mode is
// still to be ported). Per query: the top-k (id, score) among valid db
// rows whose count reaches `min_count`, in the total order (count desc,
// id asc) -- the order lax.top_k gives over the TPU kernel's carry-then-
// tile concat -- empty slots (-1, -1.0), plus the number of such rows.
// Scores as in common.cuh.
// A row is valid when row < n_valid and alive[row] != 0 (when a mask is
// given). `min_count` is the least count whose f32 score f32(count) *
// f32(1/P) reaches the caller's f32 cutoff, computed on the host, so the
// test is exact.
//
// Bound on the H100: integer issue in the compare (~2*Q*N*P ops: 2.7e11
// at Q = 1024, N = 2**20, P = 128) and, second, the db stream: each block
// of 32 queries reads its share of the N*4P-byte table once, so the table
// crosses the memory bus Q/32 times. The TPU grid ran its db axis in
// order and carried the top-k in VMEM; here the db axis is also split
// over gridDim.y so that Q = 50..1024 still fills 132 SMs. Each
// (query block, split) keeps a sorted per-query top-k in shared memory;
// a tile's rows go to a per-query candidate buffer only when they beat
// the current k-th best (most tiles add nothing, like the TPU kernel's
// can_improve skip), and one warp per query merges the buffer by rank.
// A second small kernel merges the splits' lists per query by rank; both
// merges are exact in the total order, so the result does not depend on
// the split count or on the order in which threads append.
#include <climits>

#include "common.cuh"

namespace {

using namespace dst;

constexpr int kMaxK = 128;

__device__ __forceinline__ bool better(int c1, int id1, int c2, int id2) {
  return c1 > c2 || (c1 == c2 && id1 < id2);
}

__host__ __device__ inline size_t scan_smem_ints(int p, int k) {
  return static_cast<size_t>(kQB + kRB) * row_stride(p)  // q and db tiles
         + 2 * kQB * k                                   // carry (count, id)
         + 2 * kQB * kRB                                 // candidates
         + 4 * kQB;                                      // n_buf, n_carry, thr, hits
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
                 const unsigned char* __restrict__ alive, int nq,
                 long long n, int p, long long n_valid, int min_count, int k,
                 long long rows_per_split, int* __restrict__ part_cnt,
                 int* __restrict__ part_id, int* __restrict__ hit_count) {
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

  const int q0 = blockIdx.x * kQB;
  const long long r_begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long r_end = min(n, r_begin + rows_per_split);
  stage_rows(q_s, q, q0, kQB, nq, p, stride, 0);
  for (int i = threadIdx.x; i < kQB; i += blockDim.x) {
    n_buf[i] = 0;
    n_carry[i] = 0;
    thr[i] = q0 + i < nq ? -1 : INT_MAX;  // padding queries take nothing
    hits_s[i] = 0;
  }
  const int r = threadIdx.x % kRB;
  const int g = threadIdx.x / kRB;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int hits[kQPT];
#pragma unroll
  for (int i = 0; i < kQPT; ++i) hits[i] = 0;

  for (long long row0 = r_begin; row0 < r_end; row0 += kRB) {
    __syncthreads();  // the previous tile's merge is done
    stage_rows(db_s, db, row0, kRB, r_end, p, stride, 1);
    __syncthreads();
    int counts[kQPT];
    tile_counts(q_s, db_s, stride, r, g, counts);
    const long long row = row0 + r;
    const bool valid = row < r_end && row < n_valid &&
                       (alive == nullptr || alive[row] != 0);
    if (valid) {
#pragma unroll
      for (int i = 0; i < kQPT; ++i) {
        const int qi = g * kQPT + i;
        const int c = counts[i];
        if (q0 + qi < nq && c >= min_count) {
          ++hits[i];
          if (c > thr[qi]) {
            const int pos = atomicAdd(&n_buf[qi], 1);
            buf_c[qi * kRB + pos] = c;
            buf_i[qi * kRB + pos] = static_cast<int>(row);
          }
        }
      }
    }
    __syncthreads();
    for (int qi = warp; qi < kQB; qi += kThreads / 32) {
      if (n_buf[qi] > 0) {
        merge_candidates(carry_c + qi * k, carry_i + qi * k, buf_c + qi * kRB,
                         buf_i + qi * kRB, n_buf, n_carry, thr, qi, k, lane);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    if (hits[i]) atomicAdd(&hits_s[g * kQPT + i], hits[i]);
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
// beat it (binary search: better entries form a prefix).
__global__ void topk_merge_kernel(const int* __restrict__ part_cnt,
                                  const int* __restrict__ part_id, int nq,
                                  int n_split, int k, int p,
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
      out_sc[static_cast<long long>(qi) * k + rank] = static_cast<float>(c) * inv_p;
    }
  }
}

}  // namespace

extern "C" int ds_topk_scan(const void* db, const void* q, const void* alive,
                            int nq, long long n, int p, long long n_valid,
                            int min_count, int k, int n_split, void* part_cnt,
                            void* part_id, void* hit_count, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (nq > 0 && n_split > 0) {
    const size_t smem = sizeof(int) * scan_smem_ints(p, k);
    cudaError_t err = cudaFuncSetAttribute(
        topk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    long long rows = (n + n_split - 1) / n_split;
    rows = ((rows + kRB - 1) / kRB) * kRB;
    const dim3 grid(static_cast<unsigned>((nq + kQB - 1) / kQB),
                    static_cast<unsigned>(n_split));
    topk_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(db), static_cast<const int*>(q),
        static_cast<const unsigned char*>(alive), nq, n, p, n_valid,
        min_count, k, rows, static_cast<int*>(part_cnt),
        static_cast<int*>(part_id), static_cast<int*>(hit_count));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ds_topk_merge(const void* part_cnt, const void* part_id, int nq,
                             int n_split, int k, int p, void* out_id,
                             void* out_sc, void* stream) {
  if (nq > 0) {
    topk_merge_kernel<<<nq, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(part_cnt), static_cast<const int*>(part_id),
        nq, n_split, k, p, static_cast<int*>(out_id),
        static_cast<float*>(out_sc));
  }
  return static_cast<int>(cudaGetLastError());
}
