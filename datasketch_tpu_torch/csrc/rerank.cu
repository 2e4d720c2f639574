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
// (one per candidate). One warp scores one candidate at a time: its 32
// lanes read the row's P slots as consecutive words (coalesced), compare
// with the query row staged once per block in shared memory, and sum with
// one warp reduction. Nothing but the [Q, C] scores is written.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCandPerBlock = 64;

__global__ void __launch_bounds__(kThreads)
rerank_kernel(const int* __restrict__ db, const int* __restrict__ q,
              const int* __restrict__ cand, long long n_db, int c, int p,
              float* __restrict__ out) {
  extern __shared__ int q_s[];
  const int qi = blockIdx.x;
  for (int i = threadIdx.x; i < p; i += blockDim.x) q_s[i] = q[static_cast<long long>(qi) * p + i];
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const int c0 = blockIdx.y * kCandPerBlock;
  const int c1 = min(c, c0 + kCandPerBlock);
  const float inv_p = 1.0f / static_cast<float>(p);
  for (int ci = c0 + warp; ci < c1; ci += nwarps) {
    const long long slot = static_cast<long long>(qi) * c + ci;
    const int id = cand[slot];
    int cnt = 0;
    if (id >= 0 && id < n_db) {
      const int* row = db + static_cast<long long>(id) * p;
      for (int j = lane; j < p; j += 32) cnt += row[j] == q_s[j];
      cnt = __reduce_add_sync(0xFFFFFFFFu, cnt);
    }
    if (lane == 0) out[slot] = (id >= 0 && id < n_db) ? static_cast<float>(cnt) * inv_p : 0.0f;
  }
}

}  // namespace

extern "C" int ds_rerank(const void* db, const void* q, const void* cand,
                         long long n_db, int nq, int c, int p, void* out,
                         void* stream) {
  if (nq > 0 && c > 0) {
    const dim3 grid(static_cast<unsigned>(nq),
                    static_cast<unsigned>((c + kCandPerBlock - 1) / kCandPerBlock));
    const size_t smem = sizeof(int) * p;
    cudaError_t err = cudaFuncSetAttribute(
        rerank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    rerank_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(db), static_cast<const int*>(q),
        static_cast<const int*>(cand), n_db, c, p, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
