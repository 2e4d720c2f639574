// Kernel 1: MinHash signatures from a flat ragged token buffer.
//
// Replaces datasketch_tpu/ops/pallas_kernels.py::_sign_kernel /
// sign_batch_pallas, and fuses minhash_ops._gather_rows: the TPU path
// gathered the flat buffer into a padded [B, T] matrix on the device first;
// here each block reads its document straight from the flat buffer.
//
// out[d, j] = min over the doc's tokens h of
//     ((a_j * h + b_j) mod 2**64) mod (2**61 - 1) & 0xFFFFFFFF
// (MAX_HASH for an empty doc), with the murmur3 fmix32 applied to h first
// when `mix` is set (raw token ids, hashed on the card).
//
// Bound on the H100: integer issue. Per (token, permutation) the thread
// does one 64x64-bit multiply-add (emulated in several IMADs: Hopper has
// no 64-bit integer multiplier), the Mersenne fold and a min; the doc's
// tokens are read once into shared memory and broadcast to the P threads,
// so device-memory traffic is ~4 bytes per token plus 4*P per doc. Native
// unsigned long long arithmetic replaces the TPU's uint32 limb chain; the
// mod-2**64 wrap of a*h is exactly the reference's. One block per doc,
// one thread per permutation; no tuning yet.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTokTile = 1024;
constexpr unsigned long long kP61 = (1ULL << 61) - 1;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t permute(unsigned long long a,
                                            unsigned long long b, uint32_t h) {
  const unsigned long long s = a * static_cast<unsigned long long>(h) + b;
  unsigned long long y = (s & kP61) + (s >> 61);
  if (y >= kP61) y -= kP61;
  return static_cast<uint32_t>(y);
}

__global__ void minhash_sign_kernel(const uint32_t* __restrict__ flat,
                                    const long long* __restrict__ starts,
                                    const int* __restrict__ lengths,
                                    const unsigned long long* __restrict__ pa,
                                    const unsigned long long* __restrict__ pb,
                                    int p, int mix, uint32_t* __restrict__ out) {
  __shared__ uint32_t tok[kTokTile];
  const int d = blockIdx.x;
  const long long start = starts[d];
  const int len = lengths[d];
  for (int j0 = 0; j0 < p; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const unsigned long long a = j < p ? pa[j] : 0ULL;
    const unsigned long long b = j < p ? pb[j] : 0ULL;
    uint32_t m = 0xFFFFFFFFu;
    for (int t0 = 0; t0 < len; t0 += kTokTile) {
      const int n = min(kTokTile, len - t0);
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const uint32_t h = flat[start + t0 + i];
        tok[i] = mix ? fmix32(h) : h;
      }
      __syncthreads();
      for (int i = 0; i < n; ++i) m = min(m, permute(a, b, tok[i]));
    }
    if (j < p) out[static_cast<long long>(d) * p + j] = m;
  }
}

}  // namespace

extern "C" int ds_minhash_sign(const void* flat, const void* starts,
                               const void* lengths, const void* a,
                               const void* b, int n_docs, int p, int mix,
                               void* out, void* stream) {
  if (n_docs > 0) {
    const int threads = min(256, ((p + 31) / 32) * 32);
    minhash_sign_kernel<<<n_docs, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(flat),
        static_cast<const long long*>(starts),
        static_cast<const int*>(lengths),
        static_cast<const unsigned long long*>(a),
        static_cast<const unsigned long long*>(b), p, mix,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
