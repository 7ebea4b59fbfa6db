// Shift-AND prefix automaton (KMP's scan) for Hopper (sm_90a).
//
// Replaces kernels/shift_and.py::_kernel (Pallas, TPU), per-byte step
// group_perbyte, with emit='bsums'.
//
// The automaton runs D = ((D << 1) | 1) & B[c] over K = ceil(m/32) state
// words: bit j of D is "pattern[0..j] ends at this byte", B[k][c] has bit j
// set when pattern[32k + j] == c (kernels/shift_and.py b_table), and the
// shift carries bit 31 of word k-1 into bit 0 of word k.  A match of the m
// pattern bytes ends at a byte exactly when bit (m-1) % 32 of word K-1 is
// set after that byte.
//
// One thread owns the starts of one 512-byte block.  It starts the
// automaton cold (D = 0) at the block's first byte and scans 512 + m - 1
// bytes, so it finds every match that starts in the block and none that
// starts before it (a match's automaton state depends only on its own m
// bytes).  A match starting at s is counted when s <= n_lim, the caller's
// largest valid start; the count goes straight to bs[block], with no
// reduction across threads.  At 256 MiB that is 524,288 threads.
//
// Bound on the H100: latency and issue, not HBM.  Each thread runs a serial
// chain of 512 + m - 1 steps, each K shared-memory lookups of B (K * 1 KiB
// per CUDA block) and 3K integer operations; the text is read once, 16
// bytes per load.  Neighbouring threads read 16-byte groups 512 bytes
// apart, so loads are not coalesced: every load touches its own 32-byte
// sector.  Making it fast (a warp per block, a transposed feed through
// shared memory) is later work.

#include "scan.cuh"

namespace {

using tpm::byte_of;
using tpm::kBlockBytes;
using tpm::load16;

constexpr int kThreads = 128;
constexpr int kMaxStateWords = 8;

template <int K>
__global__ void __launch_bounds__(kThreads)
kmp_bsums_kernel(const uint8_t* __restrict__ text, long long n_bytes,
                 long long n_lim, const uint32_t* __restrict__ B, int m,
                 int* __restrict__ bs) {
  __shared__ uint32_t sB[K * 256];
  for (int t = threadIdx.x; t < K * 256; t += kThreads) sB[t] = B[t];
  __syncthreads();

  const long long blk = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (blk >= n_bytes / kBlockBytes) return;
  const long long base = blk * kBlockBytes;
  // Block-local starts j in [0, lim) are valid: base + j <= n_lim.
  const long long room = n_lim - base + 1;
  const int lim = room < 0 ? 0 : (room > kBlockBytes ? kBlockBytes : (int)room);
  const int steps = kBlockBytes + m - 1;
  const int hit_bit = (m - 1) & 31;

  uint32_t D[K];
#pragma unroll
  for (int k = 0; k < K; ++k) D[k] = 0u;
  int count = 0;
  for (int q = 0; q < steps; q += 16) {
    const uint4 v = load16(text, base + q, n_bytes);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t c = byte_of(v, i);
      uint32_t carry = 1u;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint32_t old = D[k];
        D[k] = ((old << 1) | carry) & sB[k * 256 + c];
        carry = old >> 31;
      }
      // The match ending at this byte starts at block-local j.
      const int j = q + i - (m - 1);
      const bool own = j >= 0 && j < lim;
      count += (int)(((D[K - 1] >> hit_bit) & 1u) != 0u && own);
    }
  }
  bs[blk] = count;
}

template <int K>
void launch(const void* text, long long n_bytes, long long n_lim,
            const void* B, int m, void* bs, unsigned grid,
            cudaStream_t stream) {
  kmp_bsums_kernel<K><<<grid, kThreads, 0, stream>>>(
      (const uint8_t*)text, n_bytes, n_lim, (const uint32_t*)B, m, (int*)bs);
}

}  // namespace

extern "C" {

// text: the kernel region, n_bytes a multiple of 512, 16-byte aligned.
// B: uint32[K][256] with K = ceil(m / 32) in 1..8.  bs must hold
// n_bytes / 512 ints.
int tpm_kmp_bsums(const void* text, long long n_bytes, long long n_lim,
                  const void* B, int K, int m, void* bs, void* stream) {
  if (n_bytes % kBlockBytes != 0 || K < 1 || K > kMaxStateWords ||
      m < 32 * (K - 1) + 1 || m > 32 * K ||
      reinterpret_cast<uintptr_t>(text) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = n_bytes / kBlockBytes;
  if (n_blocks == 0) return 0;
  const unsigned grid = (unsigned)((n_blocks + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1: launch<1>(text, n_bytes, n_lim, B, m, bs, grid, s); break;
    case 2: launch<2>(text, n_bytes, n_lim, B, m, bs, grid, s); break;
    case 3: launch<3>(text, n_bytes, n_lim, B, m, bs, grid, s); break;
    case 4: launch<4>(text, n_bytes, n_lim, B, m, bs, grid, s); break;
    case 5: launch<5>(text, n_bytes, n_lim, B, m, bs, grid, s); break;
    case 6: launch<6>(text, n_bytes, n_lim, B, m, bs, grid, s); break;
    case 7: launch<7>(text, n_bytes, n_lim, B, m, bs, grid, s); break;
    default: launch<8>(text, n_bytes, n_lim, B, m, bs, grid, s); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
