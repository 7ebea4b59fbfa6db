// Rolling-hash Rabin-Karp screen for Hopper (sm_90a).
//
// Replaces kernels/rk_roll.py::_kernel (Pallas, TPU) with emit='bsums' (K5),
// with emit='pmask' plus kernels/shift_and.py::_end_to_start_pmask (K6),
// with emit='nib' plus its host wrapper's end-to-start shift
// (rk_candidate_nib, shift_and.end_nibble3_to_start_nib) (K10b), and with
// emit='bmask' plus kernels/shift_and.py::_end_to_start_bmask (K10c).
//
// The window hash of m bytes x[s..s+m-1] is H = sum_j x[s+j] * B^(m-1-j)
// mod 2^32 (ops/tables.rk_hash).  It rolls one byte at a time,
//
//     H <- H * B + in - out * B^m          (uint32 wraparound is the mod)
//
// where `in` is the byte entering the window and `out` the byte m places
// before it, leaving.  B is odd, so native uint32 arithmetic gives the
// reference's values bit for bit.
//
// One thread owns the starts of one 512-byte block.  It starts from H = 0
// at the block's first byte with no departing byte for its first m steps
// (bytes before the block read as 0), so after step i >= m-1 H is the hash
// of the window starting at block-local j = i - (m-1).  It runs
// 512 + m - 1 steps and counts the starts j in the block whose hash equals
// any of the k targets and whose position is <= n_lim.  Hash hits are
// candidates, not matches: ops/reconstruct.extract_region verifies and
// recounts them.  The count goes straight to bs[block].
//
// K6 is the same kernel with Emit::kPmask: instead of counting, it ORs bit p
// into the block's mask when a start's hash equals target p (k <= 31, so the
// sign bit is never used).  Bit p of bs[block] is then exactly "some start
// s <= n_lim in this block hashes to pattern p", the tightest per-pattern
// superset of the block's true starts.  The reference's mask is wider (its
// end-word fold reaches a few bytes into the neighbouring blocks, and each
// TPU sub-chunk rolls cold over zero front padding); every bit set here is
// set there too.
//
// K10b is the same kernel with Emit::kNib: it counts as K5 does (bs equals
// K5's for the same targets) and also writes the candidate nibble plane,
// bit j & 3 of word j >> 2 for each counted start j of the block.  The
// reference emits END positions and shifts them to starts outside the
// kernel; the thread here knows j and emits starts directly.  The starts
// arrive in order, 16 to a 16-bit accumulator, stored as one 16-byte write
// of four nibble words when the 16th is known.
//
// K10c is the same kernel with Emit::kBmask: it ORs bit j >> 5 into the
// block's word for each start j that K5 counts, so bit g (0..15) of bs[block]
// is set exactly when some start s <= n_lim in the block's bytes
// [32g, 32g + 32) hashes to any target: the 32-byte-group occupancy that
// multi_gather='groups' verifies.  Any k >= 1.  The reference folds its END
// nibbles to starts byte-exactly before the any-per-group, so its mask is
// the same function; it is nonzero exactly where K5's count is.
//
// Bound on the H100: latency and issue, not HBM.  Each step is a serial
// multiply-add chain on H plus k compares; the entering bytes come 16 per
// load, the departing bytes (the same stream m bytes behind, L1/L2 hits)
// as five 4-byte loads per 16 steps aligned with funnel shifts.  Loads of
// neighbouring threads are 512 bytes apart, so none is coalesced.  Making
// it fast (the reference's word-level Horner split, a warp per block) is
// later work.  K10b adds one write of the nibble plane, the region's size
// (80 us more at 256 MiB), in 16-byte stores 512 bytes apart.

#include "scan.cuh"

namespace {

using tpm::byte_of;
using tpm::kBlockBytes;
using tpm::load16;

constexpr int kThreads = 128;
constexpr int kMaxPattern = 509;

// What a block's scan emits: K5's count, K6's pattern mask, K10b's count
// plus the candidate nibble plane, or K10c's group occupancy mask.
enum class Emit { kCount, kPmask, kNib, kBmask };

template <Emit kEmit>
__global__ void __launch_bounds__(kThreads)
rk_scan_kernel(const uint8_t* __restrict__ text, long long n_bytes,
               long long n_lim, int m, uint32_t B, uint32_t Bm,
               const uint32_t* __restrict__ targets, int k,
               int* __restrict__ nib, int* __restrict__ bs) {
  extern __shared__ uint32_t tgt[];  // the k target hashes
  for (int t = threadIdx.x; t < k; t += kThreads) tgt[t] = targets[t];
  __syncthreads();

  const long long blk = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (blk >= n_bytes / kBlockBytes) return;
  const long long base = blk * kBlockBytes;
  const long long room = n_lim - base + 1;
  const int lim = room < 0 ? 0 : (room > kBlockBytes ? kBlockBytes : (int)room);
  const int steps = kBlockBytes + m - 1;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(text);
  const long long n_words = n_bytes / 4;
  // Departing bytes of the group at q start at block-local byte q - m:
  // word offset wrel = floor((q - m) / 4), then a shift of sh bytes, the
  // same for every group since q is a multiple of 16 (m <= 509 < 512).
  const int sh = (-m) & 3;

  uint32_t H = 0u;
  uint32_t out = 0u;  // K5, K10b: candidate count; K6: pattern-hit mask;
                      // K10c: group occupancy mask
  uint32_t group = 0u;  // K10b: starts 16g..16g+15, bit j & 15
  uint4* nib4 =
      kEmit == Emit::kNib ? reinterpret_cast<uint4*>(nib + base / 4) : nullptr;
  for (int q = 0; q < steps; q += 16) {
    const uint4 v = load16(text, base + q, n_bytes);
    const int wrel = (q - m + kBlockBytes) / 4 - kBlockBytes / 4;
    uint32_t w[5];
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const long long wi = base / 4 + wrel + t;
      // Words before the block are "no departing byte yet": 0.
      w[t] = (wrel + t >= 0 && wi < n_words) ? __ldg(words + wi) : 0u;
    }
    const uint4 o = make_uint4(__funnelshift_r(w[0], w[1], 8 * sh),
                               __funnelshift_r(w[1], w[2], 8 * sh),
                               __funnelshift_r(w[2], w[3], 8 * sh),
                               __funnelshift_r(w[3], w[4], 8 * sh));
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      H = H * B + byte_of(v, i) - byte_of(o, i) * Bm;
      const int j = q + i - (m - 1);
      if (kEmit == Emit::kPmask) {
        if (j >= 0 && j < lim)
          for (int p = 0; p < k; ++p) out |= (uint32_t)(H == tgt[p]) << p;
      } else {
        bool hit = false;
        if (j >= 0 && j < lim)
          for (int p = 0; p < k; ++p) hit |= H == tgt[p];
        if (kEmit == Emit::kBmask) {
          if (hit) out |= 1u << (j >> 5);  // a hit has 0 <= j < lim <= 512
        } else {
          out += (uint32_t)hit;
        }
        if (kEmit == Emit::kNib && j >= 0 && j < kBlockBytes) {
          group |= (uint32_t)hit << (j & 15);
          if ((j & 15) == 15) {
            nib4[j >> 4] = make_uint4(group & 0xFu, (group >> 4) & 0xFu,
                                      (group >> 8) & 0xFu, group >> 12);
            group = 0u;
          }
        }
      }
    }
  }
  bs[blk] = (int)out;
}

template <Emit kEmit>
int launch_scan(const void* text, long long n_bytes, long long n_lim, int m,
                unsigned int B, unsigned int Bm, const void* targets, int k,
                void* nib, void* bs, void* stream) {
  if (n_bytes % kBlockBytes != 0 || m < 1 || m > kMaxPattern || k < 1 ||
      (kEmit == Emit::kPmask && k > 31) || (B & 1u) == 0u ||
      reinterpret_cast<uintptr_t>(text) % 16 != 0 ||
      (kEmit == Emit::kNib && reinterpret_cast<uintptr_t>(nib) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = n_bytes / kBlockBytes;
  if (n_blocks == 0) return 0;
  const unsigned grid = (unsigned)((n_blocks + kThreads - 1) / kThreads);
  rk_scan_kernel<kEmit><<<grid, kThreads, (size_t)k * sizeof(uint32_t),
                          (cudaStream_t)stream>>>(
      (const uint8_t*)text, n_bytes, n_lim, m, B, Bm,
      (const uint32_t*)targets, k, (int*)nib, (int*)bs);
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
  return launch_scan<Emit::kCount>(text, n_bytes, n_lim, m, B, Bm, targets, k,
                                   nullptr, bs, stream);
}

// The same arguments; k must be in 1..31.  bs[b] gets the k-bit mask.
int tpm_rk_candidate_pmask(const void* text, long long n_bytes,
                           long long n_lim, int m, unsigned int B,
                           unsigned int Bm, const void* targets, int k,
                           void* bs, void* stream) {
  return launch_scan<Emit::kPmask>(text, n_bytes, n_lim, m, B, Bm, targets, k,
                                   nullptr, bs, stream);
}

// The same arguments as tpm_rk_candidate_bsums; any k >= 1.  bs[b] gets the
// 16-bit occupancy mask of the block's 32-byte groups.
int tpm_rk_candidate_bmask(const void* text, long long n_bytes,
                           long long n_lim, int m, unsigned int B,
                           unsigned int Bm, const void* targets, int k,
                           void* bs, void* stream) {
  return launch_scan<Emit::kBmask>(text, n_bytes, n_lim, m, B, Bm, targets, k,
                                   nullptr, bs, stream);
}

// The same arguments as tpm_rk_candidate_bsums, plus nib: n_bytes / 4 ints,
// 16-byte aligned.  bs gets K5's counts.
int tpm_rk_candidate_nib(const void* text, long long n_bytes, long long n_lim,
                         int m, unsigned int B, unsigned int Bm,
                         const void* targets, int k, void* nib, void* bs,
                         void* stream) {
  return launch_scan<Emit::kNib>(text, n_bytes, n_lim, m, B, Bm, targets, k,
                                 nib, bs, stream);
}

}  // extern "C"
