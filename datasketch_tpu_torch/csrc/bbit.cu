// Kernel 5: packed b-bit equal-slot counts, [Q, W] x [T, W] -> int32[Q, T].
//
// Replaces datasketch_tpu/ops/pallas_kernels.py::_bbit_kernel /
// bbit_scores_pallas. Signatures are packed s bits per slot, LSB-first, into
// uint32 words (int32 bit patterns here); out[q, t] counts the s-bit slots
// that are equal in query row q and db row t over all W words, the zero
// padding slots past num_perm included (the caller subtracts them). Per
// word: x = q ^ d, OR-fold each slot's bits onto its lowest bit
// (x |= x >> 1, 2, ..., s/2: a bit moves down by at most s - 1, so no
// neighbouring slot's bit reaches this slot's lowest bit), then
// popc(~x & lsb_mask(s)). At s = 32 the five folds and the one-bit mask
// give exactly x == 0. Integers only.
//
// Bound on the H100: at b = 1 (W = 4 at num_perm 128) writing the 4*Q*T
// bytes of counts (~1.28 ms at Q 1,024 x T 1,048,576) outweighs the
// ~4 integer operations per word pair; from b = 4 (W = 16, two folds) the
// operations come close to it. The TPU kernel materialised [BQ, BT, W]
// XORs in VMEM and demanded Q and T to be multiples of its blocks; here
// each block stages 32 query rows and 64 db rows in shared memory
// (common.cuh's stage_rows) and every thread scores one db row against 8
// queries from registers, so the XORs live only in registers, each staged
// word is reused 8 to 64 times, and any Q, T and W are taken (ragged edges
// are guarded, nothing need be padded). Rows are staged at an odd number
// of 16-byte words, so the 32 lanes of a warp, reading 32 different db
// rows, hit distinct banks; words past W are staged as 0 in the query tile
// and as all ones in the db tile, so they never count as equal.
#include "common.cuh"

namespace {

using namespace dst;

// Row stride in ints: the 16-byte words of a row, rounded up to an odd count.
__host__ __device__ inline int bbit_stride(int w) { return 4 * (((w + 3) / 4) | 1); }

__host__ __device__ constexpr unsigned lsb_mask(int s) {
  unsigned m = 0;
  for (int j = 0; j < 32; j += s) m |= 1u << j;
  return m;
}

template <int S>
__device__ __forceinline__ int equal_slots(int word_xor) {
  unsigned x = static_cast<unsigned>(word_xor);
#pragma unroll
  for (int sh = 1; sh < S; sh *= 2) x |= x >> sh;
  return __popc(~x & lsb_mask(S));
}

template <int S>
__global__ void __launch_bounds__(kThreads)
bbit_kernel(const int* __restrict__ q, const int* __restrict__ db, int nq,
            long long nt, int w, int* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const int stride = bbit_stride(w);
  int* q_s = smem;
  int* db_s = smem + kQB * stride;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRB;
  const int q0 = blockIdx.y * kQB;
  stage_rows(q_s, q, q0, kQB, nq, w, stride, 0);
  stage_rows(db_s, db, row0, kRB, nt, w, stride, -1);
  __syncthreads();
  const int r = threadIdx.x % kRB;
  const int g = threadIdx.x / kRB;
  int counts[kQPT];
#pragma unroll
  for (int i = 0; i < kQPT; ++i) counts[i] = 0;
  const int4* drow = reinterpret_cast<const int4*>(db_s + r * stride);
  const int4* qbase = reinterpret_cast<const int4*>(q_s + g * kQPT * stride);
  const int qstep = stride / 4;
  const int nvec = (w + 3) / 4;
  for (int c = 0; c < nvec; ++c) {
    const int4 d = drow[c];
#pragma unroll
    for (int i = 0; i < kQPT; ++i) {
      const int4 v = qbase[i * qstep + c];
      counts[i] += equal_slots<S>(d.x ^ v.x) + equal_slots<S>(d.y ^ v.y) +
                   equal_slots<S>(d.z ^ v.z) + equal_slots<S>(d.w ^ v.w);
    }
  }
  const long long row = row0 + r;
  if (row >= nt) return;
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    const int qi = q0 + g * kQPT + i;
    if (qi < nq) out[static_cast<long long>(qi) * nt + row] = counts[i];
  }
}

template <int S>
cudaError_t launch(const int* q, const int* db, int nq, long long nt, int w,
                   int* out, cudaStream_t stream) {
  const size_t smem = sizeof(int) * (kQB + kRB) * bbit_stride(w);
  cudaError_t err = cudaFuncSetAttribute(
      bbit_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((nt + kRB - 1) / kRB),
                  static_cast<unsigned>((nq + kQB - 1) / kQB));
  bbit_kernel<S><<<grid, kThreads, smem, stream>>>(q, db, nq, nt, w, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ds_bbit_counts(const void* q, const void* db, int nq,
                              long long nt, int w, int s, void* out,
                              void* stream) {
  if (nq <= 0 || nt <= 0) return static_cast<int>(cudaGetLastError());
  const int* qp = static_cast<const int*>(q);
  const int* dp = static_cast<const int*>(db);
  int* op = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (s) {
    case 1: err = launch<1>(qp, dp, nq, nt, w, op, st); break;
    case 2: err = launch<2>(qp, dp, nq, nt, w, op, st); break;
    case 4: err = launch<4>(qp, dp, nq, nt, w, op, st); break;
    case 8: err = launch<8>(qp, dp, nq, nt, w, op, st); break;
    case 16: err = launch<16>(qp, dp, nq, nt, w, op, st); break;
    case 32: err = launch<32>(qp, dp, nq, nt, w, op, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
