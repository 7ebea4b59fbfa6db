// Shift-AND prefix automaton (KMP's scan) for Hopper (sm_90a).
//
// Replaces kernels/shift_and.py::_kernel (Pallas, TPU): with its per-byte
// step group_perbyte and emit='bsums' (K4, kmp_bsums); with emit='nib' plus
// its host wrapper's end-to-start shift end_nibble3_to_start_nib (K10a,
// kmp_nib); and with its opt-in variants (K9), the composed-4 step
// group_composed and the compare-B lookup lookup_compare, under either
// emission.
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
// K9, composed-4 (kComposed, m >= 5): four steps folded into one per text
// word.  Since (X & B) << 1 | 1 == ((X << 1) | 1) & ((B << 1) | 1),
//
//     D4 = (D << 4 | 15) & (B[c0] << 3 | 7) & (B[c1] << 2 | 3)
//                        & (B[c2] << 1 | 1) & B[c3]
//
// with the multiword shifts carrying the high bits of word k-1 (of the old
// D, and of each B word) into word k.  The hit after byte t-1 of the word
// (t = 1..4 steps) is bit m-1 of the t-step state: bit m-1-t of the old D
// AND, for each earlier byte b < t, bit m-t+b of B[c_b].  As in the
// reference, these come as aligned nibbles: bits m-5..m-2 of D and bits
// m-4+b..m-1+b of B[c_b] (neutral ones where t <= b), ANDed, so that bit
// 3-b of the result is byte b's hit.  The serial chain shortens from three
// operations a byte to about three a word; the lookups and hit bits sit off
// it.  Block bases are 512-aligned, so the steps align with words.
//
// K9, compare-B (kCompareB, K = 1): B[c] is computed instead of looked up,
// as the OR over the pattern's distinct bytes d of (c == d ? mask_d : 0),
// where bit j of mask_d is set when pattern[j] == d.  The at most 32 bytes
// and masks arrive as two small arrays and sit in shared memory; bit 31
// (m = 32) is an ordinary uint32 bit here, the reference's int32 wrap.
// Compare-B combines with either step.  All four step and lookup variants
// compute the same function as K4 and K10a, bit for bit.
//
// Bound on the H100: latency and issue, not HBM.  Each thread runs a serial
// chain of 512 + m - 1 steps (a quarter as many words under composed-4),
// each K shared-memory lookups of B (K * 1 KiB per CUDA block) or up to 32
// compares, and 3K integer operations; the text is read once, 16 bytes per
// load.  Neighbouring threads read 16-byte groups 512 bytes apart, so loads
// are not coalesced: every load touches its own 32-byte sector.  Making it
// fast (a warp per block, a transposed feed through shared memory) is later
// work.  K10a adds one write of the nibble plane (the region's size again,
// 80 us more at 256 MiB); the 16-byte stores of neighbouring threads are 512
// bytes apart as well.

#include "scan.cuh"

namespace {

using tpm::byte_of;
using tpm::kBlockBytes;
using tpm::load16;

constexpr int kThreads = 128;
constexpr int kMaxStateWords = 8;
constexpr int kMaxCompare = 32;  // distinct bytes of a pattern of m <= 32

// B[k][c]: from the table in shared memory, or under compare-B (K = 1) the
// OR over the pattern's distinct bytes of (c == byte ? mask : 0).
template <bool kCompareB>
__device__ __forceinline__ uint32_t lookup(const uint32_t* sB,
                                           const uint32_t* sCmp, int n_cmp,
                                           int k, uint32_t c) {
  if constexpr (!kCompareB) return sB[k * 256 + c];
  uint32_t acc = 0u;
  for (int d = 0; d < n_cmp; ++d)
    acc |= c == sCmp[d] ? sCmp[kMaxCompare + d] : 0u;
  return acc;
}

// Bits p..p+3 of the K-word state ws as a low nibble, for the positions the
// composed step reads: m-5 <= p <= m-1, so the bits lie in words K-2 and
// K-1 (bits past the top word read as 0).
template <int K>
__device__ __forceinline__ uint32_t ext4(const uint32_t (&ws)[K], int p) {
  const uint64_t top = ((uint64_t)ws[K - 1] << 32) |
                       (K >= 2 ? ws[K >= 2 ? K - 2 : 0] : 0u);
  return (uint32_t)(top >> (p - 32 * (K - 2))) & 0xFu;
}

template <int K, bool kEmitNib, bool kComposed, bool kCompareB>
__global__ void __launch_bounds__(kThreads)
kmp_scan_kernel(const uint8_t* __restrict__ text, long long n_bytes,
                long long n_lim, const uint32_t* __restrict__ B,
                const uint32_t* __restrict__ cmp_bytes,
                const uint32_t* __restrict__ cmp_masks, int n_cmp, int m,
                int* __restrict__ nib, int* __restrict__ bs) {
  __shared__ uint32_t sB[kCompareB ? 1 : K * 256];
  __shared__ uint32_t sCmp[kCompareB ? 2 * kMaxCompare : 1];
  if constexpr (kCompareB) {
    for (int t = threadIdx.x; t < n_cmp; t += kThreads) {
      sCmp[t] = cmp_bytes[t];
      sCmp[kMaxCompare + t] = cmp_masks[t];
    }
  } else {
    for (int t = threadIdx.x; t < K * 256; t += kThreads) sB[t] = B[t];
  }
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
  // The match ending at block-local byte e starts at j = e - (m - 1).
  auto emit = [&](int e, uint32_t hit_bit_set) {
    const int j = e - (m - 1);
    const bool hit = hit_bit_set != 0u && j >= 0 && j < lim;
    count += (int)hit;
    if (kEmitNib && j >= 0 && j < kBlockBytes) {
      group |= (uint32_t)hit << (j & 15);
      if ((j & 15) == 15) {
        out[j >> 4] = make_uint4(group & 0xFu, (group >> 4) & 0xFu,
                                 (group >> 8) & 0xFu, group >> 12);
        group = 0u;
      }
    }
  };
  for (int q = 0; q < steps; q += 16) {
    const uint4 v = load16(text, base + q, n_bytes);
    if constexpr (kComposed) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t g[4][K];  // g[b][k] = B[k][byte b of the word]
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int k = 0; k < K; ++k)
            g[b][k] = lookup<kCompareB>(sB, sCmp, n_cmp, k, byte_of(v, 4 * w + b));
        uint32_t nr = ext4<K>(D, m - 5);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          uint32_t F = ext4<K>(g[b], m - 4 + b);
          if (b > 0) F |= (0xFu << (4 - b)) & 0xFu;  // neutral where t <= b
          nr &= F;
        }
        uint32_t nd[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          uint32_t H = 0xFFFFFFFFu;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int s = 3 - b;
            const uint32_t lo = k > 0 ? g[b][k > 0 ? k - 1 : 0] >> (32 - s)
                                      : (1u << s) - 1u;
            H &= s == 0 ? g[b][k] : (g[b][k] << s) | lo;
          }
          // The carry into word k is the OLD word k-1's top four bits.
          const uint32_t in = k > 0 ? D[k > 0 ? k - 1 : 0] >> 28 : 15u;
          nd[k] = ((D[k] << 4) | in) & H;
        }
#pragma unroll
        for (int k = 0; k < K; ++k) D[k] = nd[k];
#pragma unroll
        for (int b = 0; b < 4; ++b) emit(q + 4 * w + b, (nr >> (3 - b)) & 1u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const uint32_t c = byte_of(v, i);
        uint32_t carry = 1u;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const uint32_t old = D[k];
          D[k] = ((old << 1) | carry) & lookup<kCompareB>(sB, sCmp, n_cmp, k, c);
          carry = old >> 31;
        }
        emit(q + i, (D[K - 1] >> hit_bit) & 1u);
      }
    }
  }
  bs[blk] = count;
}

struct Args {
  const void* text;
  long long n_bytes, n_lim;
  const void* B;
  const void* cmp_bytes;
  const void* cmp_masks;
  int n_cmp, m;
  void* nib;
  void* bs;
};

template <int K, bool kEmitNib, bool kComposed, bool kCompareB>
void launch_k(const Args& a, unsigned grid, cudaStream_t stream) {
  kmp_scan_kernel<K, kEmitNib, kComposed, kCompareB><<<grid, kThreads, 0, stream>>>(
      (const uint8_t*)a.text, a.n_bytes, a.n_lim, (const uint32_t*)a.B,
      (const uint32_t*)a.cmp_bytes, (const uint32_t*)a.cmp_masks, a.n_cmp,
      a.m, (int*)a.nib, (int*)a.bs);
}

template <bool kEmitNib, bool kComposed>
void launch_step(const Args& a, int K, unsigned grid, cudaStream_t s) {
  switch (K) {
    case 1:
      if (a.n_cmp) launch_k<1, kEmitNib, kComposed, true>(a, grid, s);
      else launch_k<1, kEmitNib, kComposed, false>(a, grid, s);
      break;
    case 2: launch_k<2, kEmitNib, kComposed, false>(a, grid, s); break;
    case 3: launch_k<3, kEmitNib, kComposed, false>(a, grid, s); break;
    case 4: launch_k<4, kEmitNib, kComposed, false>(a, grid, s); break;
    case 5: launch_k<5, kEmitNib, kComposed, false>(a, grid, s); break;
    case 6: launch_k<6, kEmitNib, kComposed, false>(a, grid, s); break;
    case 7: launch_k<7, kEmitNib, kComposed, false>(a, grid, s); break;
    default: launch_k<8, kEmitNib, kComposed, false>(a, grid, s); break;
  }
}

template <bool kEmitNib>
int launch(const Args& a, int K, int composed, void* stream) {
  if (a.n_bytes % kBlockBytes != 0 || K < 1 || K > kMaxStateWords ||
      a.m < 32 * (K - 1) + 1 || a.m > 32 * K || (composed && a.m < 5) ||
      a.n_cmp < 0 || a.n_cmp > kMaxCompare || (a.n_cmp && K != 1) ||
      reinterpret_cast<uintptr_t>(a.text) % 16 != 0 ||
      (kEmitNib && reinterpret_cast<uintptr_t>(a.nib) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = a.n_bytes / kBlockBytes;
  if (n_blocks == 0) return 0;
  const unsigned grid = (unsigned)((n_blocks + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (composed) launch_step<kEmitNib, true>(a, K, grid, s);
  else launch_step<kEmitNib, false>(a, K, grid, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// text: the kernel region, n_bytes a multiple of 512, 16-byte aligned.
// B: uint32[K][256] with K = ceil(m / 32) in 1..8.  cmp_bytes, cmp_masks:
// uint32[n_cmp], the pattern's distinct bytes and their B masks; n_cmp = 0
// looks B up in the table, 1..32 (K = 1 only) runs compare-B.  composed:
// 0 for the per-byte step, 1 for composed-4 (m >= 5).  bs must hold
// n_bytes / 512 ints.
int tpm_kmp_bsums(const void* text, long long n_bytes, long long n_lim,
                  const void* B, int K, int m, const void* cmp_bytes,
                  const void* cmp_masks, int n_cmp, int composed, void* bs,
                  void* stream) {
  const Args a{text, n_bytes, n_lim, B, cmp_bytes, cmp_masks, n_cmp, m,
               nullptr, bs};
  return launch<false>(a, K, composed, stream);
}

// The same arguments, plus nib: n_bytes / 4 ints, 16-byte aligned.
int tpm_kmp_nib(const void* text, long long n_bytes, long long n_lim,
                const void* B, int K, int m, const void* cmp_bytes,
                const void* cmp_masks, int n_cmp, int composed, void* nib,
                void* bs, void* stream) {
  const Args a{text, n_bytes, n_lim, B, cmp_bytes, cmp_masks, n_cmp, m, nib,
               bs};
  return launch<true>(a, K, composed, stream);
}

}  // extern "C"
