// Kernel 9: sha1_hash32 of bytes tokens packed back to back.
//
// Replaces no TPU kernel: the JAX package hashes SHA1 on the host (its
// native module, datasketch_tpu/native/src/dshash_module.cpp), and so did
// the port, where the host's hashing of a sign-16k call (3.28 M tokens)
// took ~145 ms while the card idled. Here the host only packs the tokens
// (csrc/token_pack.cpp) into pinned memory, and this kernel hashes them.
//
// out[t] = the first 4 bytes of SHA1(token t), read little-endian (the
// reference's sha1_hash32), where token t is bytes[offsets[t] ..
// offsets[t + 1]). One thread a token, 256 tokens a block; tokens of at
// most 55 bytes take one compression, longer ones one per 64-byte block.
//
// Bound on the H100: the PCIe link. The kernel reads the bytes and the
// offsets in place from pinned host memory, through their mapped device
// pointer: copying a chunk's bytes (16.4 MB in the sign-16k cell) and
// offsets (6.5 MB) to device memory first would raise the cell's peak
// device memory by ~39 %, and only the hashes (4 bytes a token) land in
// device memory, where kernel 1 reads them. A 10-byte token costs 14
// bytes over PCIe and one 80-round compression (~640 integer operations):
// at ~64 GB/s one way and ~15 T integer operations/s the link binds
// (~0.36 ms against ~0.07 ms a chunk). So every byte crosses the link once,
// in full transactions: each block stages its tokens' offsets and its
// contiguous byte range in shared memory with coalesced loads (16 bytes a
// thread, neighbouring threads on neighbouring addresses), and its threads
// build their message words from shared memory. A block whose range
// exceeds the staging window (tokens longer than ~64 bytes on average)
// walks it in windows: each pass stages the window that starts at the
// least byte some unfinished thread still needs, and every thread runs the
// compressions whose bytes lie inside it, so each pass finishes at least
// the 64-byte block it started from.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // tokens a block
constexpr int kStage = 16384;  // bytes of the staging window

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

// One SHA1 compression of the 16 big-endian words w into h.
__device__ __forceinline__ void compress(uint32_t h[5], uint32_t w[16]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      wt = rotl(w[(t + 13) & 15] ^ w[(t + 8) & 15] ^ w[(t + 2) & 15] ^ w[t & 15], 1);
      w[t & 15] = wt;
    }
    uint32_t f, k;
    if (t < 20) {
      f = (b & c) | (~b & d);
      k = 0x5A827999u;
    } else if (t < 40) {
      f = b ^ c ^ d;
      k = 0x6ED9EBA1u;
    } else if (t < 60) {
      f = (b & c) | (b & d) | (c & d);
      k = 0x8F1BBCDCu;
    } else {
      f = b ^ c ^ d;
      k = 0xCA62C1D6u;
    }
    const uint32_t tmp = rotl(a, 5) + f + e + k + wt;
    e = d;
    d = c;
    c = rotl(b, 30);
    b = a;
    a = tmp;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
}

__global__ void __launch_bounds__(kThreads)
sha1_hash32_kernel(const uint8_t* __restrict__ bytes, long long cap,
                   const int* __restrict__ offsets, int n,
                   uint32_t* __restrict__ out) {
  __shared__ uint4 stage4[kStage / 16];
  __shared__ int s_off[kThreads + 1];
  __shared__ int s_next;
  const uint8_t* stage = reinterpret_cast<const uint8_t*>(stage4);
  const int t0 = blockIdx.x * kThreads;
  const int count = min(kThreads, n - t0);
  const int tid = threadIdx.x;
  if (tid < count) s_off[tid] = offsets[t0 + tid];
  if (tid == 0) s_off[count] = offsets[t0 + count];
  __syncthreads();
  const int hi = s_off[count];
  const long long hi16 = min(((static_cast<long long>(hi) + 15) / 16) * 16, cap);

  const bool mine = tid < count;
  const int s = mine ? s_off[tid] : 0;
  const int len = mine ? s_off[tid + 1] - s : 0;
  const int nblk = mine ? (len + 8) / 64 + 1 : 0;
  int k = 0;  // this token's next 64-byte block
  uint32_t h[5] = {0x67452301u, 0xEFCDAB89u, 0x98BADCFEu, 0x10325476u, 0xC3D2E1F0u};

  int win = s_off[0] & ~15;
  while (true) {
    // stage [win, win + kStage) of the block's range, 16 bytes a thread
    // (the last 16 may pass `cap`: those bytes are read one by one)
    const int n16 =
        static_cast<int>((min(static_cast<long long>(kStage), hi16 - win) + 15) / 16);
    for (int i = tid; i < n16; i += kThreads) {
      const long long g = win + 16LL * i;
      if (g + 16 <= cap) {
        stage4[i] = reinterpret_cast<const uint4*>(bytes)[g / 16];
      } else {
        uint8_t* dst = reinterpret_cast<uint8_t*>(stage4 + i);
        for (int j = 0; j < 16; ++j) dst[j] = g + j < cap ? bytes[g + j] : 0;
      }
    }
    __syncthreads();
    // every compression whose message bytes lie in the window (or that
    // holds only padding)
    for (; k < nblk; ++k) {
      const int m0 = 64 * k;  // the block's first message byte
      const int data_end = min(len, m0 + 64);
      if (m0 < len && (s + m0 < win || s + data_end > win + kStage)) break;
      uint32_t w[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        uint32_t v = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = m0 + 4 * j + b;
          const uint32_t byte = i < len ? stage[s + i - win] : (i == len ? 0x80u : 0u);
          v = (v << 8) | byte;
        }
        w[j] = v;
      }
      if (k == nblk - 1) {  // the message length in bits, big-endian
        w[14] = static_cast<uint32_t>(len) >> 29;
        w[15] = static_cast<uint32_t>(len) << 3;
      }
      compress(h, w);
    }
    if (tid == 0) s_next = INT_MAX;
    __syncthreads();
    if (k < nblk) atomicMin(&s_next, s + 64 * k);
    __syncthreads();
    const int next = s_next;
    if (next == INT_MAX) break;
    win = next & ~15;
    __syncthreads();  // s_next read by all before thread 0 resets it
  }
  if (mine) out[t0 + tid] = __byte_perm(h[0], 0, 0x0123);
}

}  // namespace

// Kernel 9: out[t] = sha1_hash32(bytes[offsets[t] .. offsets[t + 1])) for
// t < n. `bytes` (16-byte aligned, `cap` bytes readable) and `offsets`
// (n + 1 ints) are device-accessible pointers: the mapped device pointers
// of pinned host buffers (ds_host_device_ptr).
extern "C" cudaError_t ds_sha1_hash32(const void* bytes, long long cap,
                                      const void* offsets, int n, void* out,
                                      void* stream) {
  if (n > 0) {
    const int grid = (n + kThreads - 1) / kThreads;
    sha1_hash32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bytes), cap, static_cast<const int*>(offsets), n,
        static_cast<uint32_t*>(out));
  }
  return cudaGetLastError();
}

// The device pointer through which a kernel reads the pinned host memory
// at `host`. A failure is returned and cleared, so it cannot surface at a
// later launch's check.
extern "C" cudaError_t ds_host_device_ptr(void* host, void** dev) {
  const cudaError_t err = cudaHostGetDevicePointer(dev, host, 0);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}
