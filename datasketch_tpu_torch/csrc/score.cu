// Kernel 4: all-pairs signature-equality scores, [Q, P] x [T, P] -> f32[Q, T].
//
// Replaces datasketch_tpu/ops/pallas_kernels.py::_score_kernel /
// score_matrix_pallas: out[q, t] = f32(equal slots of q and db row t) *
// f32(1/P), the reference's rounding (common.cuh).
//
// Bound on the H100: integer issue (one compare and one add per slot pair,
// ~2*Q*T*P ops), plus writing the 4*Q*T-byte output. Each block stages 32
// queries and 64 db rows in shared memory (common.cuh) and every thread
// scores one db row against 8 queries from registers-fed 16-byte loads,
// so each staged word is reused 8 (query) to 64 (db row) times. Used by
// topk_scan for k > 128 and by jaccard_matrix.
#include "common.cuh"

namespace {

using namespace dst;

__global__ void __launch_bounds__(kThreads)
score_kernel(const int* __restrict__ q, const int* __restrict__ db, int nq,
             long long nt, int p, float* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const int stride = row_stride(p);
  int* q_s = smem;
  int* db_s = smem + kQB * stride;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRB;
  const int q0 = blockIdx.y * kQB;
  stage_rows(q_s, q, q0, kQB, nq, p, stride, 0);
  stage_rows(db_s, db, row0, kRB, nt, p, stride, 1);
  __syncthreads();
  const int r = threadIdx.x % kRB;
  const int g = threadIdx.x / kRB;
  int counts[kQPT];
  tile_counts(q_s, db_s, stride, r, g, counts);
  const long long row = row0 + r;
  if (row >= nt) return;
  const float inv_p = 1.0f / static_cast<float>(p);
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    const int qi = q0 + g * kQPT + i;
    if (qi < nq) out[static_cast<long long>(qi) * nt + row] = static_cast<float>(counts[i]) * inv_p;
  }
}

}  // namespace

extern "C" int ds_score_matrix(const void* q, const void* db, int nq,
                               long long nt, int p, void* out, void* stream) {
  if (nq > 0 && nt > 0) {
    const size_t smem = sizeof(int) * (kQB + kRB) * row_stride(p);
    cudaError_t err = cudaFuncSetAttribute(
        score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>((nt + kRB - 1) / kRB),
                    static_cast<unsigned>((nq + kQB - 1) / kQB));
    score_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(q), static_cast<const int*>(db), nq, nt, p,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
