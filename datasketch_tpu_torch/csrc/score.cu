// Kernel 4: all-pairs signature-equality scores, [Q, P] x [T, P] -> f32[Q, T].
//
// Replaces datasketch_tpu/ops/pallas_kernels.py::_score_kernel /
// score_matrix_pallas: out[q, t] = f32(equal slots of q and db row t) *
// f32(1/P), the reference's rounding (common.cuh). Callers: the running
// top-k past k = 128 (topk_scan, containment_scan) over 8,192-row db
// tiles, and jaccard_matrix.
//
// Bound on the H100: one integer compare per (query, row, slot), 1.07e9 at
// Q 1,024 x T 8,192 x P 128: 0.064 ms at 64 integer lanes x 132 SMs x
// 1,980 MHz. The 4*Q*T-byte output (33.5 MB there, 0.010 ms at 3.35 TB/s)
// comes second, so the count's instruction issue is what to cut.
//
// Design (kernel 2's, lsh_scan.cu, without its top-k):
// - Grid: (query blocks of kQB = 32, splits of the db axis). The wrapper
//   sizes the splits so that the blocks fill the card's resident slots in
//   one whole wave (ds_score_blocks_per_sm reports them per SM; the rule
//   is kernels/tiling.grid, shared with kernel 2). Each split is a whole
//   number of kRB = 64-row tiles.
// - Staging: a block stages its query tile once and walks its split's db
//   tiles, each copied with cp.async (16-byte where P % 4 == 0 and the
//   table is 16-byte aligned, else 4-byte) straight into one shared buffer,
//   kernel 2's pipeline: the other resident blocks (3 an SM at P 128, 50.7
//   KB and 65 registers each) count while one waits for its tile. A second
//   buffer was ~1.5 % faster at P 128 (PERF.md) but needs 2 * kRB + kQB
//   rows of shared memory, which caps P near 356 where one buffer reaches
//   600 on the H100 (232,448 bytes a block). The db pad columns are written
//   as 1 once per block: cp.async's zero-fill would equal the query tile's
//   0 pad.
// - Counts: common.cuh's block_counts, 2 db rows x 4 queries a thread,
//   each slot one ISETP and one predicated f32 FADD (an integer count
//   compiles to ~3.4 instructions a slot, an add-and-select chain).
// - Output: each thread writes its 8 scores as they are; a warp's store
//   covers 8 runs of 16 bytes, and a thread's two rows fill each 32-byte
//   sector between them.
#include "common.cuh"

namespace {

using namespace dst;

// Shared memory of a block, in ints: the query tile and one db tile.
__host__ __device__ inline size_t score_smem_ints(int p) {
  return static_cast<size_t>(kQB + kRB) * row_stride(p);
}

__global__ void __launch_bounds__(kThreads)
score_kernel(const int* __restrict__ q, const int* __restrict__ db, int nq,
             long long nt, int p, long long rows_per_split,
             float* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const int stride = row_stride(p);
  int* q_s = smem;
  int* db_s = q_s + kQB * stride;
  const bool vec = (p & 3) == 0 && (reinterpret_cast<uintptr_t>(db) & 15) == 0;
  const float inv_p = 1.0f / static_cast<float>(p);

  const int q0 = blockIdx.x * kQB;
  const long long r_begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long r_end = min(nt, r_begin + rows_per_split);
  const int n_tiles = r_end > r_begin
                          ? static_cast<int>((r_end - r_begin + kRB - 1) / kRB) : 0;
  stage_rows(q_s, q, q0, kQB, nq, p, stride, 0);
  // the db pad columns: 1, never equal to the query tile's 0 pad
  for (int i = threadIdx.x; i < kRB * (stride - p); i += blockDim.x) {
    const int r = i / (stride - p);
    db_s[r * stride + p + (i - r * (stride - p))] = 1;
  }
  int r0, lq;  // rows r0 and r0 + 4, queries lq + 8 j
  tile_coords(r0, lq);

  for (int t = 0; t < n_tiles; ++t) {
    const long long row0 = r_begin + static_cast<long long>(t) * kRB;
    // every thread is past its reads of tile t - 1 (the loop's last barrier)
    issue_tile(db_s, nullptr, db, nullptr, row0, r_end, p, stride, vec);
    cp_async_wait_all();
    __syncthreads();  // tile t is in
    int counts[kRowsPT][kQueriesPT];
    block_counts(q_s, db_s, stride, r0, lq, counts);
#pragma unroll
    for (int h = 0; h < kRowsPT; ++h) {
      const long long row = row0 + r0 + 4 * h;
      if (row >= r_end) continue;
#pragma unroll
      for (int j = 0; j < kQueriesPT; ++j) {
        const int qi = q0 + lq + 8 * j;
        if (qi < nq) {
          out[static_cast<long long>(qi) * nt + row] =
              static_cast<float>(counts[h][j]) * inv_p;
        }
      }
    }
    __syncthreads();  // the tile's reads are done before it is copied over
  }
}

// Make the kernel ready for its dynamic shared memory at p; `*fits` is
// false where that is more than a block may have.
cudaError_t prepare_score(int p, size_t* smem, bool* fits) {
  *smem = sizeof(int) * score_smem_ints(p);
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  *fits = err == cudaSuccess && *smem <= static_cast<size_t>(most);
  if (err != cudaSuccess || !*fits) return err;
  return cudaFuncSetAttribute(score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

// Resident blocks of the score kernel per SM at p, 0 where a block does
// not fit, written to `*out`: the wrapper sizes its grid in whole waves.
extern "C" int ds_score_blocks_per_sm(int p, void* out) {
  size_t smem = 0;
  bool fits = false;
  cudaError_t err = prepare_score(p, &smem, &fits);
  int blocks = 0;
  if (err == cudaSuccess && fits) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, score_kernel, kThreads,
                                                        smem);
  }
  *static_cast<int*>(out) = blocks;
  return static_cast<int>(err);
}

// Split s scores db rows [s * rows_per_split, (s + 1) * rows_per_split): a
// whole number of tiles, n_split of them covering the nt rows.
extern "C" int ds_score_matrix(const void* q, const void* db, int nq,
                               long long nt, int p, int n_split,
                               long long rows_per_split, void* out, void* stream) {
  if (rows_per_split < kRB || rows_per_split % kRB != 0 ||
      static_cast<long long>(n_split) * rows_per_split < nt) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nq > 0 && nt > 0) {
    size_t smem = 0;
    bool fits = false;
    const cudaError_t err = prepare_score(p, &smem, &fits);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!fits) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>((nq + kQB - 1) / kQB),
                    static_cast<unsigned>(n_split));
    score_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(q), static_cast<const int*>(db), nq, nt, p,
        rows_per_split, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
