// Shared pieces of the port's scan kernels (Hopper, sm_90a).
//
// Every kernel emits per-512-byte-block counts in byte order: bs[b] covers
// bytes 512b..512b+511 of the kernel region.  Bytes and words at or past the
// end of the region read as 0.  Each C entry launches on the given stream,
// does not synchronise and returns cudaGetLastError(), which the Python
// wrapper (utils/cuda_build.launch) turns into an error.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tpm {

constexpr int kBlockBytes = 512;  // bytes per output block sum
constexpr int kBlockWords = 128;  // 32-bit words per output block sum

// 16 bytes at byte offset p (a multiple of 16).  The region holds whole
// 512-byte blocks, so a 16-byte group lies either wholly inside it or wholly
// past its end.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ text,
                                        long long p, long long n_bytes) {
  return p < n_bytes ? __ldg(reinterpret_cast<const uint4*>(text + p))
                     : make_uint4(0u, 0u, 0u, 0u);
}

constexpr int kMaxDevices = 64;

// CTAs of a persistent scan: every SM filled to the kernel's occupancy at
// `threads` threads and `smem` bytes of dynamic shared memory, at most one
// per item of work.  The SM count times CTAs per SM is computed once per
// device into cache[device] (and again if smem changes).
struct GridCache {
  int ctas[kMaxDevices];
  size_t smem[kMaxDevices];
};

inline int persistent_grid(const void* kernel, int threads, size_t smem,
                           long long n_items, GridCache* cache,
                           unsigned* grid) {
  int dev = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (cache->ctas[dev] == 0 || cache->smem[dev] != smem) {
    int sms = 0, per_sm = 0;
    if (cudaError_t err =
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      return (int)err;
    if (cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, threads, smem))
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cache->ctas[dev] = sms * per_sm;
    cache->smem[dev] = smem;
  }
  *grid = (unsigned)(n_items < cache->ctas[dev] ? n_items : cache->ctas[dev]);
  return 0;
}

// Word i (0..3, a compile-time constant after unrolling) of a 16-byte group.
__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// byte_of in one byte permute.
__device__ __forceinline__ uint32_t byte_at(const uint4& v, int b) {
  return __byte_perm(word_of(v, b >> 2), 0u, 0x4440u | (b & 3));
}

}  // namespace tpm

// Each csrc/<name>.cu is one translation unit and one shared library, so
// every library that includes this header exports its own copy.
extern "C" const char* tpm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
