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
// set after that byte.  A start s is counted when s <= n_lim, the caller's
// largest valid start; bytes past the region read as 0, as in the plain
// versions.
//
// K4 and K10a: kmp_warp_kernel<K, kEmitNib>, a warp per 512-byte block.
// A persistent grid (tpm::persistent_grid) of 256-thread CTAs gives each
// warp one contiguous span of blocks, walked in order; lane l loads bytes
// [16l, 16l + 16) of a block (one coalesced 512-byte load per warp, the next
// block in flight to registers).  The automaton is carried warm across the
// span: it starts cold (D = 0) once, at the span's first byte, which loses
// only matches that start before it, and those belong to the previous warp.
//
// - Alignment.  The table is loaded into shared memory shifted up by
//   o = 32K - m bits, with ones in bits 0..o-1: the pattern behind o bytes
//   that match anything, started with those ones set.  The step is
//   unchanged, bits 0..o-1 stay ones and the hit bit is bit 31 of word K-1
//   for every m.
// - Lane map.  Over its 16 bytes the lane runs the step from D = all ones.
//   Since (X & Y) << 1 | 1 == ((X << 1) | 1) & ((Y << 1) | 1), the state
//   after t steps from any D_in is (D_in << t | (2^t - 1)) & M_t, M_t the
//   state from all ones.  So M = M_16 is the lane's map, and the hit after
//   step t is bit 31 of M_t (shifted into h, one funnel shift a byte, step
//   t at bit 16 - t) AND bit 31 - t of D_in's top word: h & (D_in[K-1] >>
//   15), bit-reversed into byte order.  One pass over the bytes.
// - Lane scan.  Maps compose as (X, then Y over 16d bytes) -> (X << 16d |
//   ones) & Y, and lane 0 folds in the state carried from the previous
//   block, so an inclusive __shfl_up_sync scan gives each lane its state.
//   A state's bits below the hit bit depend only on the last m - 1 bytes,
//   so the scan stops once it reaches that far: no step at m <= 17, at most
//   four at m <= 256.  D_in is the previous lane's state (lane 0's the
//   carry); lane 31's is the next block's carry.
// - Ends to starts.  The match ending at block byte e starts at e - (m-1):
//   lane l's starts are ends 16(l + a) + r .. + 15, a = (m-1) >> 4, r =
//   (m-1) & 15, in lanes l + a and l + a + 1 of this block and the next.
//   So the warp finds block b + 1's ends before it emits block b's starts
//   (the span's last block reads one block past the span), each lane
//   fetching two 32-bit words (both blocks' 16-bit masks) by __shfl_sync.
// - Emission.  The start bits are clamped at n_lim; K4 writes the warp's
//   sum of their popcounts to bs[b], K10a also lane l's bits as nibble words
//   4l..4l+3 (bit s & 3 of word s >> 2), one 16-byte store per lane, 512
//   contiguous bytes per warp.
//
// Bound on the H100: the largest of the bytes (the region read once, 80 us
// for 256 MiB at 3.35 TB/s; K10a also writes a nibble plane of the same
// size), the 2K + 1 integer operations a byte (two per state word, one for
// the hit) and the K shared-memory lookups a byte (32 a clock per SM): the
// bytes up to K = 2, the operations at K = 8 (0.27 ms for 256 MiB).  The
// lane runs a byte permute, the lookup's address, K lookups of B (K * 1 KiB
// per CTA; lanes reading different bytes that share a bank conflict) and
// the step; each block's scan, shuffles and epilogue add more.  Per byte
// the block loop issues 9.5 operations besides its lookups and shuffles at
// K = 1, 12.4 at K = 2 and 25.75 at K = 8, where 17 are needed.  It is
// issue-bound: on 256 MiB of English K4 runs at 0.58 of its bound at m = 16,
// 0.44 at m = 64 and 0.66 at m = 256, K10a at 0.78, 0.77 and 0.63; at K = 8
// the time is that of the loop's 25.75 operations a byte on the INT32 pipe
// (kernel_ab.py).
//
// K9: kmp_scan_kernel<K, kEmitNib, kComposed, kCompareB>, the first form,
// now only for the composed-4 step and the compare-B lookup.  One thread
// owns the starts of one 512-byte block.  It starts the automaton cold at
// the block's first byte and scans 512 + m - 1 bytes, so it finds every
// match that starts in the block and none that starts before it.  The
// count goes straight to bs[block], with no reduction across threads; under
// kEmitNib the thread emits its starts, 16 to a 16-bit accumulator, stored
// as one 16-byte write of four nibble words when the 16th is known.
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
// 3-b of the result is byte b's hit.  Block bases are 512-aligned, so the
// steps align with words.
//
// K9, compare-B (kCompareB, K = 1): B[c] is computed instead of looked up,
// as the OR over the pattern's distinct bytes d of (c == d ? mask_d : 0),
// where bit j of mask_d is set when pattern[j] == d.  The at most 32 bytes
// and masks arrive as two small arrays and sit in shared memory; bit 31
// (m = 32) is an ordinary uint32 bit here, the reference's int32 wrap.
// Compare-B combines with either step.  Every variant computes the same
// function as K4 and K10a, bit for bit.  Neighbouring threads read 16-byte
// groups and store nibble words 512 bytes apart, so neither coalesces.

#include "scan.cuh"

namespace {

using tpm::byte_at;
using tpm::byte_of;
using tpm::kBlockBytes;
using tpm::load16;

constexpr int kThreads = 128;  // kmp_scan_kernel
constexpr int kWarpThreads = 256;  // kmp_warp_kernel
constexpr int kWarps = kWarpThreads / 32;
constexpr int kMaxStateWords = 8;
constexpr int kMaxCompare = 32;  // distinct bytes of a pattern of m <= 32
constexpr unsigned kFull = 0xffffffffu;

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

// out = x << n over K words, ones shifted in (n a multiple of 16, known at
// compile time after unrolling).
template <int K>
__device__ __forceinline__ void shl_fill(const uint32_t (&x)[K], int n,
                                         uint32_t (&out)[K]) {
  const int q = n >> 5, s = n & 31;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = k >= q ? k - q : 0;
    if (k < q) out[k] = kFull;
    else if (s == 0) out[k] = x[j];
    else if (k == q) out[k] = (x[0] << s) | ((1u << s) - 1u);
    else out[k] = __funnelshift_l(x[j > 0 ? j - 1 : 0], x[j], s);
  }
}

// Lane scan steps that reach 16 * 2^r >= m - 1 bytes back at m <= 32K.
template <int K>
constexpr int kMaxScanSteps = K == 1 ? 1 : K == 2 ? 2 : K <= 4 ? 3 : 4;

template <int K, bool kEmitNib>
__global__ void __launch_bounds__(kWarpThreads)
kmp_warp_kernel(const uint8_t* __restrict__ text, long long n_bytes,
                long long n_lim, const uint32_t* __restrict__ B, int m,
                int* __restrict__ nib, int* __restrict__ bs) {
  // The table shifted up by o = 32K - m bits, ones below o.
  __shared__ uint32_t sB[K * 256];
  const int o = 32 * K - m;
  const uint32_t low = (1u << o) - 1u;
  for (int t = threadIdx.x; t < K * 256; t += kWarpThreads)
    sB[t] = o == 0 ? B[t] : (B[t] << o) | (t >= 256 ? B[t - 256] >> (32 - o) : low);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n_blocks = n_bytes / kBlockBytes;
  const long long n_warps = (long long)gridDim.x * kWarps;
  const long long span = (n_blocks + n_warps - 1) / n_warps;
  const long long b0 = ((long long)blockIdx.x * kWarps + warp) * span;
  const long long b_end = b0 + span < n_blocks ? b0 + span : n_blocks;
  if (b0 >= b_end) return;  // the whole warp: no lane reaches a shuffle

  // The state entering the next block; cold (no pattern prefix) at the
  // span's first byte.
  uint32_t carry[K];
#pragma unroll
  for (int k = 0; k < K; ++k) carry[k] = k == 0 ? low : 0u;

  // Lane l's end bits of the block whose bytes are v (bit i: a match ends
  // at byte 16l + i); carry moves on to the block after.
  auto ends = [&](const uint4& v) -> uint32_t {
    uint32_t M[K];
#pragma unroll
    for (int k = 0; k < K; ++k) M[k] = kFull;
    uint32_t h = 0u;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t* row = sB + byte_at(v, i);
      uint32_t cin = 1u;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint32_t old = M[k];
        M[k] = ((old << 1) | cin) & row[256 * k];
        cin = old >> 31;
      }
      h = __funnelshift_l(M[K - 1], h, 1);  // (h << 1) | hit bit
    }
    uint32_t S[K], t[K];
    shl_fill<K>(carry, 16, t);
#pragma unroll
    for (int k = 0; k < K; ++k) S[k] = lane == 0 ? t[k] & M[k] : M[k];
#pragma unroll
    for (int r = 0; r < kMaxScanSteps<K>; ++r) {
      if ((16 << r) >= m - 1) break;
      const int d = 1 << r;
      const int used = K - ((16 * d) >> 5);  // words of y that reach S
      uint32_t y[K];
#pragma unroll
      for (int k = 0; k < K; ++k) y[k] = k < used ? __shfl_up_sync(kFull, S[k], d) : 0u;
      shl_fill<K>(y, 16 * d, t);
      if (lane >= d) {
#pragma unroll
        for (int k = 0; k < K; ++k) S[k] &= t[k];
      }
    }
    uint32_t top = __shfl_up_sync(kFull, S[K - 1], 1);
    if (lane == 0) top = carry[K - 1];
#pragma unroll
    for (int k = 0; k < K; ++k) carry[k] = __shfl_sync(kFull, S[k], 31);
    return __brev(h & (top >> 15)) >> 16;
  };

  // Blocks b0 + i, i < nblk, are the span's; the warp reads blocks up to
  // b0 + nblk, those past the region's end as zeros.  The offsets stay
  // 32-bit (in_region capped at nblk + 1 to fit an int): tpm::load16's
  // 64-bit ones cost nine instructions a block and made K4 5% slower at
  // K = 8 (kernel_ab.py).
  const int nblk = (int)(b_end - b0);
  const int in_region = (int)(n_blocks - b0 < nblk + 1 ? n_blocks - b0 : nblk + 1);
  const uint4* src = reinterpret_cast<const uint4*>(text) + b0 * 32 + lane;
  auto fetch = [&](int i) {
    return i < in_region ? __ldg(src + 32 * i) : make_uint4(0u, 0u, 0u, 0u);
  };
  // Lane l's starts of block b are the ends of lanes j and j + 1 (j = l + a,
  // past 31 in block b + 1), shifted down by r: one byte permute picks the
  // two 16-bit masks out of the lanes' (block b, block b + 1) pairs.
  const int a = (m - 1) >> 4, r = (m - 1) & 15, j = lane + a;
  const uint32_t pick = (j < 32 ? 0x10u : 0x32u) | (j + 1 < 32 ? 0x5400u : 0x7600u);
  // Start 512i + 16l + t of the span is counted when it is <= lim0; blocks
  // i < clamp_from hold none past it.
  const long long lim0 = n_lim - b0 * kBlockBytes;
  const int clamp_from =
      lim0 < 0 ? 0 : (int)((lim0 + 1) / kBlockBytes < nblk ? (lim0 + 1) / kBlockBytes : nblk);
  int* out_bs = bs + b0;
  uint4* out_nib = kEmitNib ? reinterpret_cast<uint4*>(nib) + b0 * 32 + lane : nullptr;

  uint4 ahead = fetch(1);
  uint32_t prev = ends(fetch(0));
  for (int i = 0; i < nblk; ++i) {
    const uint4 v = ahead;
    if (i + 2 <= nblk) ahead = fetch(i + 2);
    const uint32_t cur = ends(v);
    const uint32_t pair = prev | cur << 16;
    prev = cur;
    const uint32_t two = __byte_perm(__shfl_sync(kFull, pair, j & 31),
                                     __shfl_sync(kFull, pair, (j + 1) & 31), pick);
    uint32_t st = (two >> r) & 0xFFFFu;  // bit t: start 16l + t
    if (i >= clamp_from) {  // starts past n_lim
      const long long room = lim0 - (long long)kBlockBytes * i - 16 * lane + 1;
      st &= room <= 0 ? 0u : room >= 16 ? 0xFFFFu : (1u << room) - 1u;
    }
    if (kEmitNib)
      out_nib[32 * i] = make_uint4(st & 0xFu, (st >> 4) & 0xFu, (st >> 8) & 0xFu, st >> 12);
    const unsigned total = __reduce_add_sync(kFull, (unsigned)__popc(st));
    if (lane == 0) out_bs[i] = (int)total;
  }
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

template <int K, bool kEmitNib>
int launch_warp(const Args& a, cudaStream_t stream) {
  const long long n_blocks = a.n_bytes / kBlockBytes;
  static tpm::GridCache ctas;
  unsigned grid = 0;
  if (int err = tpm::persistent_grid((const void*)kmp_warp_kernel<K, kEmitNib>,
                                     kWarpThreads, 0, (n_blocks + kWarps - 1) / kWarps,
                                     &ctas, &grid))
    return err;
  kmp_warp_kernel<K, kEmitNib><<<grid, kWarpThreads, 0, stream>>>(
      (const uint8_t*)a.text, a.n_bytes, a.n_lim, (const uint32_t*)a.B, a.m,
      (int*)a.nib, (int*)a.bs);
  return (int)cudaGetLastError();
}

// K4 / K10a: the warp kernel, K = 1..8.
template <bool kEmitNib>
int launch_perbyte(const Args& a, int K, cudaStream_t s) {
  switch (K) {
    case 1: return launch_warp<1, kEmitNib>(a, s);
    case 2: return launch_warp<2, kEmitNib>(a, s);
    case 3: return launch_warp<3, kEmitNib>(a, s);
    case 4: return launch_warp<4, kEmitNib>(a, s);
    case 5: return launch_warp<5, kEmitNib>(a, s);
    case 6: return launch_warp<6, kEmitNib>(a, s);
    case 7: return launch_warp<7, kEmitNib>(a, s);
    default: return launch_warp<8, kEmitNib>(a, s);
  }
}

// K9: the composed step (K = 1..8, compare-B at K = 1 too), or compare-B on
// the per-byte step.
template <bool kEmitNib>
int launch_k9(const Args& a, int K, int composed, cudaStream_t s) {
  const long long n_blocks = a.n_bytes / kBlockBytes;
  const unsigned grid = (unsigned)((n_blocks + kThreads - 1) / kThreads);
  if (!composed) {
    launch_k<1, kEmitNib, false, true>(a, grid, s);
    return (int)cudaGetLastError();
  }
  switch (K) {
    case 1:
      if (a.n_cmp) launch_k<1, kEmitNib, true, true>(a, grid, s);
      else launch_k<1, kEmitNib, true, false>(a, grid, s);
      break;
    case 2: launch_k<2, kEmitNib, true, false>(a, grid, s); break;
    case 3: launch_k<3, kEmitNib, true, false>(a, grid, s); break;
    case 4: launch_k<4, kEmitNib, true, false>(a, grid, s); break;
    case 5: launch_k<5, kEmitNib, true, false>(a, grid, s); break;
    case 6: launch_k<6, kEmitNib, true, false>(a, grid, s); break;
    case 7: launch_k<7, kEmitNib, true, false>(a, grid, s); break;
    default: launch_k<8, kEmitNib, true, false>(a, grid, s); break;
  }
  return (int)cudaGetLastError();
}

template <bool kEmitNib>
int launch(const Args& a, int K, int composed, void* stream) {
  if (a.n_bytes % kBlockBytes != 0 || K < 1 || K > kMaxStateWords ||
      a.m < 32 * (K - 1) + 1 || a.m > 32 * K || (composed && a.m < 5) ||
      a.n_cmp < 0 || a.n_cmp > kMaxCompare || (a.n_cmp && K != 1) ||
      reinterpret_cast<uintptr_t>(a.text) % 16 != 0 ||
      (kEmitNib && reinterpret_cast<uintptr_t>(a.nib) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (a.n_bytes == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (composed || a.n_cmp) return launch_k9<kEmitNib>(a, K, composed, s);
  return launch_perbyte<kEmitNib>(a, K, s);
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
