// Shift-AND prefix automaton (KMP's scan) for Hopper (sm_90a).
//
// Replaces kernels/shift_and.py::_kernel (Pallas, TPU), per-byte step
// group_perbyte, with emit='bsums' (K4, kmp_bsums) and with emit='nib'
// plus its host wrapper's end-to-start shift end_nibble3_to_start_nib (K10a,
// kmp_nib).
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
// K10a (kEmitNib) also writes the nibble plane of the block's starts: bit
// j & 3 of word j >> 2 for each counted start j.  The reference's kernel
// emits END positions and its host wrapper shifts them to starts outside the
// kernel; the thread here knows j, so it emits starts directly, with the
// validity s <= n_lim applied.  Starts arrive in order, 16 to a 16-bit
// accumulator, stored as one 16-byte write of four nibble words when the
// 16th is known.
//
// Bound on the H100: latency and issue, not HBM.  Each thread runs a serial
// chain of 512 + m - 1 steps, each K shared-memory lookups of B (K * 1 KiB
// per CUDA block) and 3K integer operations; the text is read once, 16
// bytes per load.  Neighbouring threads read 16-byte groups 512 bytes
// apart, so loads are not coalesced: every load touches its own 32-byte
// sector.  Making it fast (a warp per block, a transposed feed through
// shared memory) is later work.  K10a adds one write of the nibble plane
// (the region's size again, 80 us more at 256 MiB); the 16-byte stores of
// neighbouring threads are 512 bytes apart as well.

#include "scan.cuh"

namespace {

using tpm::byte_of;
using tpm::kBlockBytes;
using tpm::load16;

constexpr int kThreads = 128;
constexpr int kMaxStateWords = 8;

template <int K, bool kEmitNib>
__global__ void __launch_bounds__(kThreads)
kmp_scan_kernel(const uint8_t* __restrict__ text, long long n_bytes,
                long long n_lim, const uint32_t* __restrict__ B, int m,
                int* __restrict__ nib, int* __restrict__ bs) {
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
  uint32_t group = 0u;  // kEmitNib: starts 16g..16g+15, bit j & 15
  uint4* out = kEmitNib ? reinterpret_cast<uint4*>(nib + base / 4) : nullptr;
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
      const bool hit = ((D[K - 1] >> hit_bit) & 1u) != 0u && own;
      count += (int)hit;
      if (kEmitNib && j >= 0 && j < kBlockBytes) {
        group |= (uint32_t)hit << (j & 15);
        if ((j & 15) == 15) {
          out[j >> 4] = make_uint4(group & 0xFu, (group >> 4) & 0xFu,
                                   (group >> 8) & 0xFu, group >> 12);
          group = 0u;
        }
      }
    }
  }
  bs[blk] = count;
}

template <int K, bool kEmitNib>
void launch_k(const void* text, long long n_bytes, long long n_lim,
              const void* B, int m, void* nib, void* bs, unsigned grid,
              cudaStream_t stream) {
  kmp_scan_kernel<K, kEmitNib><<<grid, kThreads, 0, stream>>>(
      (const uint8_t*)text, n_bytes, n_lim, (const uint32_t*)B, m, (int*)nib,
      (int*)bs);
}

template <bool kEmitNib>
int launch(const void* text, long long n_bytes, long long n_lim,
           const void* B, int K, int m, void* nib, void* bs, void* stream) {
  if (n_bytes % kBlockBytes != 0 || K < 1 || K > kMaxStateWords ||
      m < 32 * (K - 1) + 1 || m > 32 * K ||
      reinterpret_cast<uintptr_t>(text) % 16 != 0 ||
      (kEmitNib && reinterpret_cast<uintptr_t>(nib) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = n_bytes / kBlockBytes;
  if (n_blocks == 0) return 0;
  const unsigned grid = (unsigned)((n_blocks + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1: launch_k<1, kEmitNib>(text, n_bytes, n_lim, B, m, nib, bs, grid, s); break;
    case 2: launch_k<2, kEmitNib>(text, n_bytes, n_lim, B, m, nib, bs, grid, s); break;
    case 3: launch_k<3, kEmitNib>(text, n_bytes, n_lim, B, m, nib, bs, grid, s); break;
    case 4: launch_k<4, kEmitNib>(text, n_bytes, n_lim, B, m, nib, bs, grid, s); break;
    case 5: launch_k<5, kEmitNib>(text, n_bytes, n_lim, B, m, nib, bs, grid, s); break;
    case 6: launch_k<6, kEmitNib>(text, n_bytes, n_lim, B, m, nib, bs, grid, s); break;
    case 7: launch_k<7, kEmitNib>(text, n_bytes, n_lim, B, m, nib, bs, grid, s); break;
    default: launch_k<8, kEmitNib>(text, n_bytes, n_lim, B, m, nib, bs, grid, s); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// text: the kernel region, n_bytes a multiple of 512, 16-byte aligned.
// B: uint32[K][256] with K = ceil(m / 32) in 1..8.  bs must hold
// n_bytes / 512 ints.
int tpm_kmp_bsums(const void* text, long long n_bytes, long long n_lim,
                  const void* B, int K, int m, void* bs, void* stream) {
  return launch<false>(text, n_bytes, n_lim, B, K, m, nullptr, bs, stream);
}

// The same arguments, plus nib: n_bytes / 4 ints, 16-byte aligned.
int tpm_kmp_nib(const void* text, long long n_bytes, long long n_lim,
                const void* B, int K, int m, void* nib, void* bs,
                void* stream) {
  return launch<true>(text, n_bytes, n_lim, B, K, m, nib, bs, stream);
}

}  // extern "C"
