// Rolling-hash Rabin-Karp screens for Hopper (sm_90a).
//
// Replaces kernels/rk_roll.py::_kernel (Pallas, TPU) with emit='bsums' (K5),
// with emit='nib' plus its host wrapper's end-to-start shift
// (rk_candidate_nib, shift_and.end_nibble3_to_start_nib) (K10b), with
// emit='pmask' plus kernels/shift_and.py::_end_to_start_pmask (K6), and with
// emit='bmask' plus kernels/shift_and.py::_end_to_start_bmask (K10c).
//
// The window hash of m bytes x[s..s+m-1] is H(s) = sum_j x[s+j] * B^(m-1-j)
// mod 2^32 (ops/tables.rk_hash).  B is odd and uint32 wraparound is the
// mod, so native arithmetic gives the reference's values bit for bit.  A
// start s is a candidate when H(s) equals any of the k targets and
// s <= n_lim.  Hash hits are candidates, not matches:
// ops/reconstruct.extract_region verifies and recounts them.  Bytes past the
// end of the region read as 0, as in the plain versions.
//
// One design serves all four: a warp per 512-byte block on prefix hashes
// (rk_warp_kernel).  With the Horner prefix P(i) = sum_{j<i} x[j] *
// B^(i-1-j), started from 0 anywhere at or before s,
//
//     H(s) = P(s + m) - B^m * P(s)                              (uint32)
//
// since P(s + m) = B^m * P(s) + H(s): the bytes before s cancel.  A
// persistent grid (tpm::persistent_grid) of 256-thread CTAs gives each warp
// one contiguous span of blocks, walked in order with P carried from block
// to block.  Lane l loads bytes [16l, 16l + 16) of a block, so one warp
// load reads 512 contiguous bytes; the next block's bytes are in flight to
// registers while one is scanned.  The lane runs Horner over its 16 bytes
// (a byte permute and a multiply-add each), and a five-step
// __shfl_up_sync scan combines the lanes affinely (P_hi <- P_lo * B^(16d)
// + P_hi), the carry entering as lane 0's term.  The block's 512 prefixes
// go to a two-block ring in shared memory: 64 rows of 16 (row 32 * (b & 1)
// + l holds lane l's), each padded to 20 words, written and read as 16-byte
// chunks, so that eight lanes' chunks fill the 32 banks.  A start of block
// b needs P up to 512b + 511 + 509 < 512(b + 2), so the warp computes block
// b + 1's prefixes before it hashes block b's starts (the span's last block
// reads one block past the span).  Lane l takes the starts 16l..16l+15 of
// its own bytes: P(s) is its own row, P(s + m) columns (m + t) mod 16 of
// the row m / 16 further on and of the one after.  Where they split is
// m & 15, a template argument (the launch picks one of 16 instances), so
// every read is a chunk at a fixed offset.  Each H is compared with the
// targets four at a time from registers, setting its hit bit, and with the
// k mod 4 others into one predicate per lane; only in the rare warp where
// that holds do the lanes build those targets' bits.  Bit t of lane l's
// `hits` is then start 16l + t, clamped at n_lim, and the emission (a
// template argument too) is the block's epilogue:
//
// - K5 (Emit::kCount): bs[b] is the warp's sum of the lanes' popcounts.
// - K10b (Emit::kNib): lane l's bits are the nibble words 4l..4l+3 (bit
//   s & 3 of word s >> 2), one 16-byte store per lane, 512 contiguous
//   bytes per warp; bs[b] as K5's.
// - K6 (Emit::kPmask, k <= 31, so the sign bit is never used): bit p of
//   bs[b] is set exactly when some start s <= n_lim in the block hashes to
//   target p, the tightest per-pattern superset of the block's true
//   starts.  A lane with hits walks its set bits, recomputes each one's H
//   from the ring (block b's slot stays until the warp's next __syncwarp)
//   and ORs bit p for every target p it equals; __reduce_or_sync joins the
//   lanes.  Only lanes with a hit do any of this, so K6 costs what K5 does
//   on the blocks without one.  The reference's mask is wider (its
//   end-word fold reaches a few bytes into the neighbouring blocks, and
//   each TPU sub-chunk rolls cold over zero front padding); every bit set
//   here is set there too.
// - K10c (Emit::kBmask, any k): bit g (0..15) of bs[b] is set exactly when
//   some start s <= n_lim in the block's bytes [32g, 32g + 32) hashes to
//   any target, the 32-byte-group occupancy that multi_gather='groups'
//   verifies.  Lanes 2g and 2g + 1 hold group g's starts: one ballot of
//   hits != 0, an OR of each pair of bits and four shift-and-mask steps
//   that compact the even bits into 16.  The reference folds its END
//   nibbles to starts byte-exactly before the any-per-group, so its mask
//   is the same function; it is nonzero exactly where K5's count is.
//
// Bound on the H100: K5, K6 and K10c read the region once (80 us for
// 256 MiB at 3.35 TB/s); K10b also writes a nibble plane of the same size
// (160 us).  The bound's operation count (chip_smoke.py) is 2 + k per
// byte, 0.16 ms at k = 8, for all four.  The warp runs about six INT32
// instructions per byte besides the compares (the Horner pair, the lane
// offset, H, and a quarter each of the chunk writes and reads) and one to
// one and a half per target: K5 at k = 1 runs at about half its bytes
// bound, held by the instruction rate and by the latency of each block's
// Horner chain and shuffle scan.  More bytes in flight (two or four blocks
// ahead in registers, or a cp.async ring of 4-8 blocks) did not make it
// faster.  At k = 8 K6 and K10c take within 4% of K5's time: their
// epilogues add a few instructions per block, and K6's walk of set bits
// runs only in the lanes with a hit.

#include <utility>

#include "scan.cuh"

namespace {

using tpm::byte_at;
using tpm::kBlockBytes;
using tpm::load16;
using tpm::word_of;

constexpr int kMaxPattern = 509;
constexpr int kMaxPmaskTargets = 31;
constexpr unsigned kFull = 0xffffffffu;

// What a block's epilogue emits: K5's count, K10b's count and nibble plane,
// K6's pattern mask or K10c's group occupancy mask.
enum class Emit { kCount, kNib, kPmask, kBmask };

constexpr int kWarpThreads = 256;
constexpr int kWarps = kWarpThreads / 32;
// A warp's ring: two blocks of prefixes in 64 rows of 16, one row per lane
// and block, each row padded to 20 words.
constexpr int kRowWords = 20;
constexpr int kRingWords = 64 * kRowWords;
constexpr size_t kRingSmem = (size_t)kWarps * kRingWords * sizeof(uint32_t);

// kO = m & 15 (the launch picks the instance): the ring row at which a
// lane's reads of P(s + m) cross is then known at compile time.
template <Emit kEmit, int kO>
__global__ void __launch_bounds__(kWarpThreads)
rk_warp_kernel(const uint8_t* __restrict__ text, long long n_bytes,
               long long n_lim, int m, uint32_t B, uint32_t Bm,
               const uint32_t* __restrict__ targets, int k,
               int* __restrict__ nib, int* __restrict__ bs) {
  extern __shared__ uint32_t smem[];  // the warps' rings, then the targets
  uint32_t* tgt = smem + kWarps * kRingWords;
  for (int t = threadIdx.x; t < k; t += kWarpThreads) tgt[t] = targets[t];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* ring = smem + warp * kRingWords;
  const long long n_blocks = n_bytes / kBlockBytes;
  const long long n_warps = (long long)gridDim.x * kWarps;
  const long long span = (n_blocks + n_warps - 1) / n_warps;
  const long long b0 = ((long long)blockIdx.x * kWarps + warp) * span;
  const long long b_end = b0 + span < n_blocks ? b0 + span : n_blocks;
  if (b0 >= b_end) return;  // the whole warp: no lane reaches a shuffle

  // Bt[t] = B^t; Bd[r] = B^(16 * 2^r), the scan's steps.
  uint32_t Bt[16];
  Bt[0] = 1u;
#pragma unroll
  for (int t = 1; t < 16; ++t) Bt[t] = Bt[t - 1] * B;
  uint32_t Bd[5];
  Bd[0] = Bt[15] * B;
#pragma unroll
  for (int r = 1; r < 5; ++r) Bd[r] = Bd[r - 1] * Bd[r - 1];
  const uint32_t nBm = 0u - Bm;

  // P(512b + 16l + t) of the block whose bytes are v into ring row
  // 32 * slot + l; carry is P at the block's first byte on entry and at the
  // next block's on return.
  uint32_t carry = 0u;
  auto prefixes = [&](const uint4& v, int slot) {
    uint32_t P[16];
    uint32_t L = 0u;  // Horner over the lane's bytes, from 0
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      P[t] = L;
      L = L * B + byte_at(v, t);
    }
    // S: sum over lanes l' <= l of L(l') * B^(16(l - l')), the carry
    // entering as lane 0's term carry * B^16: P at the lane's last byte + 1.
    uint32_t S = lane == 0 ? L + carry * Bd[0] : L;
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const uint32_t y = __shfl_up_sync(kFull, S, 1 << r);
      if (lane >= 1 << r) S += y * Bd[r];
    }
    uint32_t E = __shfl_up_sync(kFull, S, 1);
    if (lane == 0) E = carry;
    carry = __shfl_sync(kFull, S, 31);
#pragma unroll
    for (int t = 0; t < 16; ++t) P[t] += E * Bt[t];
    uint4* w = reinterpret_cast<uint4*>(ring + (32 * slot + lane) * kRowWords);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      w[c] = make_uint4(P[4 * c], P[4 * c + 1], P[4 * c + 2], P[4 * c + 3]);
  };

  // Lane l's candidate bits of block b (bit t: start s = 16l + t), from
  // the ring: P(s) is column t of the lane's own row, 32 * slot(b) + l;
  // P(s + m), prefix slot(b) * 512 + 16l + m + t, is column (kO + t) mod 16
  // of row q0 = 32 * slot(b) + l + m / 16 (mod 64) for t < 16 - kO and of
  // row q0 + 1 after, read as the 16-byte chunks that hold those columns.
  // The targets are compared four at a time from registers, then one at a
  // time.
  auto hash_hits = [&](int own, int q0, long long b) -> uint32_t {
    const uint4* row = reinterpret_cast<const uint4*>(ring + own * kRowWords);
    const uint4* row0 = reinterpret_cast<const uint4*>(ring + q0 * kRowWords);
    const uint4* row1 = reinterpret_cast<const uint4*>(ring + ((q0 + 1) & 63) * kRowWords);
    uint4 c0[4], c1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      c0[c] = 4 * c + 3 >= kO ? row0[c] : make_uint4(0u, 0u, 0u, 0u);
      c1[c] = 4 * c < kO ? row1[c] : make_uint4(0u, 0u, 0u, 0u);
    }
    uint32_t H[16];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint4 near = row[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = kO + 4 * c + i;
        const uint32_t far = col < 16 ? word_of(c0[col >> 2], col & 3)
                                      : word_of(c1[(col - 16) >> 2], col & 3);
        H[4 * c + i] = far + nBm * word_of(near, i);
      }
    }
    // Four targets at a time from registers, each start's bit set where
    // one equals its hash; then the rest one at a time into one predicate
    // per lane, the bits built only in the rare warp where one holds.
    uint32_t hits = 0u;
    int p = 0;
    for (; p + 4 <= k; p += 4) {
      const uint4 tp = *reinterpret_cast<const uint4*>(tgt + p);
#pragma unroll
      for (int t = 0; t < 16; ++t)
        if (H[t] == tp.x || H[t] == tp.y || H[t] == tp.z || H[t] == tp.w) hits |= 1u << t;
    }
    const int rest = p;
    bool any = false;
    for (; p < k; ++p) {
      const uint32_t tp = tgt[p];
#pragma unroll
      for (int t = 0; t < 16; ++t) any |= H[t] == tp;
    }
    if (__any_sync(kFull, any))
      for (p = rest; p < k; ++p) {
        const uint32_t tp = tgt[p];
#pragma unroll
        for (int t = 0; t < 16; ++t)
          if (H[t] == tp) hits |= 1u << t;
      }
    if ((b + 1) * kBlockBytes > n_lim) {  // starts past n_lim
      const long long room = n_lim - b * kBlockBytes - 16 * lane + 1;
      if (room < 16) hits &= room <= 0 ? 0u : (1u << room) - 1u;
    }
    return hits;
  };

  // Block b's output from the lanes' hit bits; K6 recomputes the H of
  // each set bit from the ring (column (kO + t) mod 16 of row q0 or q0 + 1,
  // as hash_hits reads it).
  auto emit = [&](int own, int q0, long long b, uint32_t hits) {
    uint32_t out;
    if (kEmit == Emit::kPmask) {
      out = 0u;
      for (uint32_t h = hits; h != 0u; h &= h - 1u) {
        const int t = __ffs(h) - 1;
        const int col = kO + t;
        const int far = (col < 16 ? q0 : (q0 + 1) & 63) * kRowWords + (col & 15);
        const uint32_t H = ring[far] + nBm * ring[own * kRowWords + t];
        for (int p = 0; p < k; ++p) out |= (uint32_t)(H == tgt[p]) << p;
      }
      out = __reduce_or_sync(kFull, out);
    } else if (kEmit == Emit::kBmask) {
      // Lanes 2g and 2g + 1 hold group g: OR the pairs, keep the even bits.
      out = __ballot_sync(kFull, hits != 0u);
      out = (out | out >> 1) & 0x55555555u;
      out = (out | out >> 1) & 0x33333333u;
      out = (out | out >> 2) & 0x0F0F0F0Fu;
      out = (out | out >> 4) & 0x00FF00FFu;
      out = (out | out >> 8) & 0x0000FFFFu;
    } else {
      if (kEmit == Emit::kNib)
        reinterpret_cast<uint4*>(nib)[b * 32 + lane] =
            make_uint4(hits & 0xFu, (hits >> 4) & 0xFu, (hits >> 8) & 0xFu, hits >> 12);
      out = __reduce_add_sync(kFull, (unsigned)__popc(hits));
    }
    if (lane == 0) bs[b] = (int)out;
  };

  // Block b's starts: block b + 1's prefixes go to the ring's other slot,
  // from the prefetched bytes, and the bytes of block b + 2 are fetched if
  // the span needs them.
  uint4 ahead = load16(text, (b0 + 1) * kBlockBytes + 16 * lane, n_bytes);
  prefixes(load16(text, b0 * kBlockBytes + 16 * lane, n_bytes), (int)(b0 & 1));
  for (long long b = b0; b < b_end; ++b) {
    const uint4 v = ahead;
    if (b + 2 <= b_end) ahead = load16(text, (b + 2) * kBlockBytes + 16 * lane, n_bytes);
    prefixes(v, (int)((b + 1) & 1));
    __syncwarp();
    const int own = (int)(b & 1) * 32 + lane;
    const int q0 = (own + (m >> 4)) & 63;
    emit(own, q0, b, hash_hits(own, q0, b));
    __syncwarp();  // block b's slot is block b + 2's next
  }
}

// The 16 instances of rk_warp_kernel<kEmit, kO>, by kO.
template <Emit kEmit, int... kO>
const void* const* warp_kernels(std::integer_sequence<int, kO...>) {
  static const void* const table[] = {(const void*)rk_warp_kernel<kEmit, kO>...};
  return table;
}

template <Emit kEmit>
int launch_warp(const void* text, long long n_bytes, long long n_lim, int m,
                unsigned int B, unsigned int Bm, const void* targets, int k,
                void* nib, void* bs, void* stream) {
  if (n_bytes % kBlockBytes != 0 || m < 1 || m > kMaxPattern || k < 1 ||
      (kEmit == Emit::kPmask && k > kMaxPmaskTargets) || (B & 1u) == 0u ||
      reinterpret_cast<uintptr_t>(text) % 16 != 0 ||
      (kEmit == Emit::kNib && reinterpret_cast<uintptr_t>(nib) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = n_bytes / kBlockBytes;
  if (n_blocks == 0) return 0;
  const void* kernel = warp_kernels<kEmit>(std::make_integer_sequence<int, 16>())[m & 15];
  const size_t smem = kRingSmem + (size_t)k * sizeof(uint32_t);
  if (smem > 48 * 1024)
    if (cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
      return (int)err;
  static tpm::GridCache ctas[16];
  unsigned grid = 0;
  if (int err = tpm::persistent_grid(kernel, kWarpThreads, smem,
                                     (n_blocks + kWarps - 1) / kWarps, &ctas[m & 15],
                                     &grid))
    return err;
  const uint8_t* text_arg = (const uint8_t*)text;
  const uint32_t* targets_arg = (const uint32_t*)targets;
  int* nib_arg = (int*)nib;
  int* bs_arg = (int*)bs;
  void* args[] = {&text_arg, &n_bytes, &n_lim, &m, &B, &Bm, &targets_arg, &k,
                  &nib_arg, &bs_arg};
  if (cudaError_t err = cudaLaunchKernel(kernel, grid, kWarpThreads, args, smem,
                                         (cudaStream_t)stream))
    return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// text: the kernel region, n_bytes a multiple of 512, 16-byte aligned.
// B: the odd base; Bm = B^m mod 2^32; targets: uint32[k].  bs must hold
// n_bytes / 512 ints.
int tpm_rk_candidate_bsums(const void* text, long long n_bytes,
                           long long n_lim, int m, unsigned int B,
                           unsigned int Bm, const void* targets, int k,
                           void* bs, void* stream) {
  return launch_warp<Emit::kCount>(text, n_bytes, n_lim, m, B, Bm, targets, k,
                                   nullptr, bs, stream);
}

// The same arguments; k must be in 1..31.  bs[b] gets the k-bit mask.
int tpm_rk_candidate_pmask(const void* text, long long n_bytes,
                           long long n_lim, int m, unsigned int B,
                           unsigned int Bm, const void* targets, int k,
                           void* bs, void* stream) {
  return launch_warp<Emit::kPmask>(text, n_bytes, n_lim, m, B, Bm, targets, k,
                                   nullptr, bs, stream);
}

// The same arguments as tpm_rk_candidate_bsums; any k >= 1.  bs[b] gets the
// 16-bit occupancy mask of the block's 32-byte groups.
int tpm_rk_candidate_bmask(const void* text, long long n_bytes,
                           long long n_lim, int m, unsigned int B,
                           unsigned int Bm, const void* targets, int k,
                           void* bs, void* stream) {
  return launch_warp<Emit::kBmask>(text, n_bytes, n_lim, m, B, Bm, targets, k,
                                   nullptr, bs, stream);
}

// The same arguments as tpm_rk_candidate_bsums, plus nib: n_bytes / 4 ints,
// 16-byte aligned.  bs gets K5's counts.
int tpm_rk_candidate_nib(const void* text, long long n_bytes, long long n_lim,
                         int m, unsigned int B, unsigned int Bm,
                         const void* targets, int k, void* nib, void* bs,
                         void* stream) {
  return launch_warp<Emit::kNib>(text, n_bytes, n_lim, m, B, Bm, targets, k, nib,
                                 bs, stream);
}

}  // extern "C"
