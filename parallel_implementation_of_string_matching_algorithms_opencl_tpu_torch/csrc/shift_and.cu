// Shift-AND prefix automaton (KMP's scan) for Hopper (sm_90a).
//
// Replaces kernels/shift_and.py::_kernel (Pallas, TPU): with its per-byte
// step group_perbyte and emit='bsums' (K4, kmp_bsums); with emit='nib' plus
// its host wrapper's end-to-start shift end_nibble3_to_start_nib (K10a,
// kmp_nib); and with its opt-in variants (K9), the composed-4 step
// group_composed and the compare-B lookup lookup_compare, under either
// emission.  One kernel template, kmp_warp_kernel<K, kEmitNib, kStep,
// kLookup>, runs them all: every variant computes the same function, bit
// for bit.
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
// A warp per 512-byte block.  A persistent grid (tpm::persistent_grid) of
// 256-thread CTAs gives each warp one contiguous span of blocks, walked in
// order; lane l loads bytes [16l, 16l + 16) of a block (one coalesced
// 512-byte load per warp, the next block in flight to registers).  The
// automaton is carried warm across the span: it starts cold (D = 0) once,
// at the span's first byte, which loses only matches that start before it,
// and those belong to the previous warp.
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
//   step t is bit 31 of M_t (in h, step t at bit 16 - t) AND bit 31 - t of
//   D_in's top word: h & (D_in[K-1] >> 15), bit-reversed into byte order.
//   One pass over the bytes.
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
// Only the lane map's step and the source of the table differ between the
// variants (template policies):
//
// - Step::kPerByte (K4, K10a; group_perbyte): M = ((M << 1) | 1) & B'[c]
//   a byte, one funnel shift moving bit 31 of the top word into h.
// - Step::kComposed (K9, STEP_PATH = "composed", m >= 5; group_composed):
//   four bytes c0..c3 a step, by the same identity,
//
//       M = (M << 4 | 15) & (B'[c0] << 3 | 7) & (B'[c1] << 2 | 3)
//                         & (B'[c2] << 1 | 1) & B'[c3],
//
//   each multiword shift one __funnelshift_l of words k-1 and k (all ones
//   below word 0), the words walked upward so that each B' word is looked
//   up once and kept for word k + 1.  The hit after byte b of the four is
//   bit 31 of the top word after b + 1 steps: bit 30 - b of M's top word
//   before the step AND, for each earlier byte b' <= b, bit 31 - b + b' of
//   B'[K-1][c_b'].  With the table aligned to the top these are fixed bits
//   for every m: (M[K-1] << 1) & B'[c0] & (B'[c1] >> 1 | 1 << 31) & ...
//   holds the four hits in bits 31..28 (byte 0 at bit 31, ones shifted in
//   where a byte is not yet reached), and one funnel shift moves them into
//   h in the per-byte step's places.  The reference's run-time bit
//   extracts (_ext4 at p = m - 5) have no counterpart.
// - Lookup::kTable: the CTA loads b_table's K x 256 words.
// - Lookup::kCompare (K9, pat_key, K = 1; lookup_compare): the wrapper
//   passes the pattern's at most 32 distinct bytes and their masks, and
//   the CTA's prologue builds the 256-word row from them once (B[c] = the
//   mask of the distinct byte equal to c, else 0); the block loop is then
//   the table's.  Compare-B was the TPU's answer to a slow dynamic_gather,
//   kept by the reference as a measured negative (shift_and.py:286-293);
//   Hopper's shared-memory lookup is the fast gather the TPU lacked, so
//   the compares run 256 times per CTA, not once per byte.  The form this
//   replaced (a thread per 512-byte block comparing each byte against the
//   distinct bytes) took 1.10-1.61 ms on 256 MiB of English (PERF.md §6).
//
// Bound on the H100: the largest of the bytes (the region read once, 80 us
// for 256 MiB at 3.35 TB/s; K10a also writes a nibble plane of the same
// size), the 2K + 1 integer operations a byte (two per state word, one for
// the hit) and the K shared-memory lookups a byte (32 a clock per SM): the
// bytes up to K = 2, the operations at K = 8 (0.27 ms for 256 MiB).  The
// lane runs a byte permute, the lookup's address, K lookups of B (K * 1 KiB
// per CTA; lanes reading different bytes that share a bank conflict) and
// the step; each block's scan, shuffles and epilogue add more.  Per byte
// the per-byte block loop issues 9.5 operations besides its lookups and
// shuffles at K = 1, 12.4 at K = 2 and 25.75 at K = 8, where 17 are needed.
// It is issue-bound: on 256 MiB of English K4 runs at 0.58 of its bound at
// m = 16, 0.44 at m = 64 and 0.66 at m = 256, K10a at 0.78, 0.77 and 0.63;
// at K = 8 the time is that of the loop's 25.75 operations a byte on the
// INT32 pipe (kernel_ab.py).  The composed step takes six operations a
// state word for four bytes where the per-byte step takes eight, and seven
// for the four hits where it takes four: its block loop is 537 SASS
// instructions at K = 8 against 576 (0.97x K4's time) and 175 against 173
// at K = 1 (1.05x), so it gains only at large K (kernel_ab.py, one H100).

#include "scan.cuh"

namespace {

using tpm::byte_at;
using tpm::kBlockBytes;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStateWords = 8;
constexpr int kMaxCompare = 32;  // distinct bytes of a pattern of m <= 32
constexpr unsigned kFull = 0xffffffffu;

enum class Step { kPerByte, kComposed };
enum class Lookup { kTable, kCompare };

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

// The lane map M over the 16 bytes v from all ones, and h: the hit bit
// (bit 31 of M's top word) after step t at bit 16 - t.  sB: the aligned
// table, word k of byte c at sB[256k + c].
template <int K, Step kStep>
__device__ __forceinline__ uint32_t lane_map(const uint32_t* sB, const uint4& v,
                                             uint32_t (&M)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) M[k] = kFull;
  uint32_t h = 0u;
  if constexpr (kStep == Step::kPerByte) {
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
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t* r0 = sB + byte_at(v, 4 * w);
      const uint32_t* r1 = sB + byte_at(v, 4 * w + 1);
      const uint32_t* r2 = sB + byte_at(v, 4 * w + 2);
      const uint32_t* r3 = sB + byte_at(v, 4 * w + 3);
      const uint32_t top = M[K - 1];
      // Word k-1 of M and of each byte's B' (all ones below word 0); after
      // the loop g0..g3 hold the top words.
      uint32_t pm = kFull, p0 = kFull, p1 = kFull, p2 = kFull;
      uint32_t g0 = 0u, g1 = 0u, g2 = 0u, g3 = 0u;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        g0 = r0[256 * k];
        g1 = r1[256 * k];
        g2 = r2[256 * k];
        g3 = r3[256 * k];
        const uint32_t H = __funnelshift_l(p0, g0, 3) & __funnelshift_l(p1, g1, 2) &
                           __funnelshift_l(p2, g2, 1) & g3;
        const uint32_t old = M[k];
        M[k] = __funnelshift_l(pm, old, 4) & H;
        pm = old;
        p0 = g0;
        p1 = g1;
        p2 = g2;
      }
      // Bit 31 - b: the hit after byte b of the four.
      const uint32_t hits = (top << 1) & g0 & __funnelshift_r(g1, kFull, 1) &
                            __funnelshift_r(g2, kFull, 2) & __funnelshift_r(g3, kFull, 3);
      h = __funnelshift_l(hits, h, 4);  // (h << 4) | hits >> 28
    }
  }
  return h;
}

template <int K, bool kEmitNib, Step kStep, Lookup kLookup>
__global__ void __launch_bounds__(kThreads)
kmp_warp_kernel(const uint8_t* __restrict__ text, long long n_bytes,
                long long n_lim, const uint32_t* __restrict__ B,
                const uint32_t* __restrict__ cmp_bytes,
                const uint32_t* __restrict__ cmp_masks, int n_cmp, int m,
                int* __restrict__ nib, int* __restrict__ bs) {
  // The table shifted up by o = 32K - m bits, ones below o.
  __shared__ uint32_t sB[K * 256];
  const int o = 32 * K - m;
  const uint32_t low = (1u << o) - 1u;
  // Word t of the unshifted table: b_table's, or under compare-B (K = 1)
  // the mask of the distinct byte equal to t, 0 if none is.
  auto b_of = [&](int t) -> uint32_t {
    if constexpr (kLookup == Lookup::kTable) {
      return B[t];
    } else {
      uint32_t acc = 0u;
      for (int d = 0; d < n_cmp; ++d) acc |= cmp_bytes[d] == (uint32_t)t ? cmp_masks[d] : 0u;
      return acc;
    }
  };
  for (int t = threadIdx.x; t < K * 256; t += kThreads)
    sB[t] = o == 0 ? b_of(t) : (b_of(t) << o) | (t >= 256 ? b_of(t - 256) >> (32 - o) : low);
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
    const uint32_t h = lane_map<K, kStep>(sB, v, M);
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

template <int K, bool kEmitNib, Step kStep, Lookup kLookup>
int launch_warp(const Args& a, cudaStream_t stream) {
  const long long n_blocks = a.n_bytes / kBlockBytes;
  static tpm::GridCache ctas;
  unsigned grid = 0;
  if (int err = tpm::persistent_grid(
          (const void*)kmp_warp_kernel<K, kEmitNib, kStep, kLookup>, kThreads, 0,
          (n_blocks + kWarps - 1) / kWarps, &ctas, &grid))
    return err;
  kmp_warp_kernel<K, kEmitNib, kStep, kLookup><<<grid, kThreads, 0, stream>>>(
      (const uint8_t*)a.text, a.n_bytes, a.n_lim, (const uint32_t*)a.B,
      (const uint32_t*)a.cmp_bytes, (const uint32_t*)a.cmp_masks, a.n_cmp, a.m,
      (int*)a.nib, (int*)a.bs);
  return (int)cudaGetLastError();
}

// The table's lookup at K = 1..8.
template <bool kEmitNib, Step kStep>
int launch_table(const Args& a, int K, cudaStream_t s) {
  switch (K) {
    case 1: return launch_warp<1, kEmitNib, kStep, Lookup::kTable>(a, s);
    case 2: return launch_warp<2, kEmitNib, kStep, Lookup::kTable>(a, s);
    case 3: return launch_warp<3, kEmitNib, kStep, Lookup::kTable>(a, s);
    case 4: return launch_warp<4, kEmitNib, kStep, Lookup::kTable>(a, s);
    case 5: return launch_warp<5, kEmitNib, kStep, Lookup::kTable>(a, s);
    case 6: return launch_warp<6, kEmitNib, kStep, Lookup::kTable>(a, s);
    case 7: return launch_warp<7, kEmitNib, kStep, Lookup::kTable>(a, s);
    default: return launch_warp<8, kEmitNib, kStep, Lookup::kTable>(a, s);
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
  if (a.n_bytes == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.n_cmp)  // K9 compare-B, K = 1
    return composed ? launch_warp<1, kEmitNib, Step::kComposed, Lookup::kCompare>(a, s)
                    : launch_warp<1, kEmitNib, Step::kPerByte, Lookup::kCompare>(a, s);
  return composed ? launch_table<kEmitNib, Step::kComposed>(a, K, s)  // K9
                  : launch_table<kEmitNib, Step::kPerByte>(a, K, s);  // K4 / K10a
}

}  // namespace

extern "C" {

// text: the kernel region, n_bytes a multiple of 512, 16-byte aligned.
// B: uint32[K][256] with K = ceil(m / 32) in 1..8.  cmp_bytes, cmp_masks:
// uint32[n_cmp], the pattern's distinct bytes and their B masks; n_cmp = 0
// looks B up in the table, 1..32 (K = 1 only) builds it from them
// (compare-B) and reads no B.  composed: 0 for the per-byte step, 1 for
// composed-4 (m >= 5).  bs must hold n_bytes / 512 ints.
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
