// Word-packed (SWAR) matching kernels for Hopper (sm_90a).
//
// The text is read as little-endian 32-bit words: word w holds bytes
// 4w..4w+3.  A match of an m-byte pattern starting at byte 4w + a
// (alignment a in 0..3) satisfies, for every pattern word k in [0, nw),
//
//     (word[w + k] & M[a][k]) == P[a][k]
//
// where P[a] is the pattern placed at byte offset a of a zeroed buffer and
// M[a] its byte-occupancy mask (kernels/swar.py pattern_words).  Words at
// or past n_words (the end of the kernel region) read as 0.
//
// Every kernel here is a persistent tiled scan: a grid of as many CTAs as
// the card holds at once walks tiles of the region, each tile and its halo
// prefetched to registers while the one before it is scanned, then stored
// to one of two shared-memory buffers, and one warp scans each 512-byte
// output block out of shared memory (scan_tiles).  The scans, K1 and K11a
// (the probe screen, one template), the naive verify K2/K3 and the screened
// verify K7/K8 (one template: the screen's probe pair is an argument), walk
// contiguous 16 KiB tiles.  K11d, the gather-verify of listed 4 KiB groups,
// runs K2's verify (verify_block) on gathered tiles: tile i is the group
// g8[i] and the halo after it.
//
// Block sums come out in byte order: bs[b] covers bytes 512b..512b+511.
// The JAX reference's tile-major reorder (swar.py _run) has no counterpart.

#include "scan.cuh"

namespace {

using tpm::kBlockBytes;
using tpm::kBlockWords;
using tpm::persistent_grid;

constexpr int kGroupWords = 8 * kBlockWords;  // one 4 KiB group of K11d

struct Probes {
  // Probe word index per alignment (a pair may repeat one word); negative
  // in kOwnScreen, where K2/K3 pick their own screen words.
  int k[4][2];
};

// ---------------------------------------------------------------------------
// Persistent tiled scans
// ---------------------------------------------------------------------------

constexpr int kTileBlocks = 32;                        // output blocks per tile
constexpr int kTileWords = kTileBlocks * kBlockWords;  // 16 KiB of text
constexpr int kScanWarps = 8;
constexpr int kScanThreads = 32 * kScanWarps;
constexpr int kMaxPatternWords = kBlockWords;  // nw <= 128, i.e. m <= 509
// One buffer of a tile of kWords words: up to 3 lead words (the region may
// start anywhere in its 16-byte line), the tile, and a halo of up to
// kMaxPatternWords - 1 words, in whole 16-byte chunks.
template <int kWords>
constexpr int kBufWordsOf = kWords + kMaxPatternWords + 4;
constexpr int kBufWords = kBufWordsOf<kTileWords>;       // contiguous tiles
constexpr int kGroupBufWords = kBufWordsOf<kGroupWords>;  // K11d's groups
constexpr size_t kTileSmem = 2 * kBufWords * sizeof(uint32_t);  // two buffers
constexpr size_t kGroupSmem = 2 * kGroupBufWords * sizeof(uint32_t);
constexpr size_t kPatternSmem = 8 * kMaxPatternWords * sizeof(uint32_t);
// Within the 48 KB a launch gets without cudaFuncSetAttribute, the
// pattern's staged words included (naive_kernel).
static_assert(kTileSmem + kPatternSmem <= 48 * 1024,
              "tile buffers past 48 KB need cudaFuncAttributeMaxDynamicSharedMemorySize");

// Tiles of a region of n_words (a multiple of 128); the last may be ragged.
__host__ __device__ __forceinline__ long long tiles_of(long long n_words) {
  return (n_words / kBlockWords + kTileBlocks - 1) / kTileBlocks;
}

// Walks the CTA's tiles t = blockIdx.x, blockIdx.x + gridDim.x, ... <
// n_tiles through two buffers in shared memory s.  Tile t is the kWords
// region words from first_of(t) (a multiple of 4) and the halo after them,
// or, where first_of(t) is negative, kWords + halo zeros read from nowhere.
// fn(base, t, first_of(t)) scans tile t, in which s[base + j] is region
// word first_of(t) + j for j in [0, kWords + halo), while the next tile's
// words are in flight to registers (r: each thread's 16-byte chunks of the
// buffer, read with ld.global.nc): they go to the other buffer after fn,
// and one barrier per tile orders both buffers.  Copies start at the
// region's 16-byte line (the lead words before its first word share that
// line, so they lie in its allocation); words at or past n_words read as 0
// and are never read from memory.  Every thread of the CTA calls fn once
// per tile; fn's warps never synchronise with each other.
template <int kWords, class First, class Fn>
__device__ __forceinline__ void scan_tiles(uint32_t* s, const uint32_t* words,
                                           long long n_words, long long n_tiles,
                                           int halo, First&& first_of, Fn&& fn) {
  constexpr int kBuf = kBufWordsOf<kWords>;
  constexpr int kChunks = (kBuf / 4 + kScanThreads - 1) / kScanThreads;
  const int lead = (int)((reinterpret_cast<uintptr_t>(words) >> 2) & 3);
  const int n_load = (lead + kWords + halo + 3) & ~3;
  uint4 r[kChunks];
  auto fetch = [&](long long f) {
    const long long first = f - lead;  // a 16-byte line
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = 4 * (threadIdx.x + j * kScanThreads);
      const long long left = f < 0 ? 0 : n_words - (first + c);
      const uint32_t* src = words + (first + c);
      if (c >= n_load) continue;
      if (left >= 4)
        r[j] = __ldg(reinterpret_cast<const uint4*>(src));
      else  // the region's end (a whole chunk past it unless the region
            // starts off its 16-byte line), or a tile that reads nothing
        r[j] = make_uint4(left > 0 ? __ldg(src) : 0u, left > 1 ? __ldg(src + 1) : 0u,
                          left > 2 ? __ldg(src + 2) : 0u, 0u);
    }
  };
  auto stash = [&](uint32_t* buf) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = 4 * (threadIdx.x + j * kScanThreads);
      if (c < n_load) *reinterpret_cast<uint4*>(buf + c) = r[j];
    }
  };
  long long t = blockIdx.x;  // the grid never exceeds n_tiles
  long long f = first_of(t);
  fetch(f);
  stash(s);
  __syncthreads();
  for (int i = 0; t < n_tiles; t += gridDim.x, ++i) {
    const bool more = t + gridDim.x < n_tiles;
    const long long f_next = more ? first_of(t + gridDim.x) : 0;
    if (more) fetch(f_next);
    fn((i & 1) * kBuf + lead, t, f);
    if (more) stash(s + ((i + 1) & 1) * kBuf);
    __syncthreads();
    f = f_next;
  }
}

// The contiguous tiles: tile t is region words t * kTileWords on.
template <class Fn>
__device__ __forceinline__ void scan_region(uint32_t* s, const uint32_t* words,
                                            long long n_words, int halo, Fn&& fn) {
  scan_tiles<kTileWords>(s, words, n_words, tiles_of(n_words), halo,
                         [](long long t) { return t * kTileWords; }, fn);
}

// Probe screen.  kNibSums = false replaces kernels/swar.py::_screen_cand_kernel
// (Pallas, TPU), K1; kNibSums = true replaces exp/screen_kernel_opt.py::
// _v1_kernel (K11a) and exp/proto_kernels.py::_proto_screen_kernel (K11c).
//
// K1, the Boyer-Moore candidate screen: word w is a candidate when, for
// some alignment a, both probe words of a compare equal under their masks.
// The count of candidate words with 4w <= n_lim (the clamp is per WORD, as
// in the reference) goes to bs[block].  Candidates are a superset of the
// matches; ops/reconstruct.extract_region verifies them exactly.
//
// K11a, the same compares with the reference's full epilogue
// (swar._epilogue): bit a of a word's nibble is set when both probe words
// of alignment a compare equal, bits with 4w + a > n_lim are cleared (the
// clamp is per ALIGNMENT), bs[block] is the block's count of (word,
// alignment) candidates and *total, which the C entry zeroes, their sum:
// lane 0 of each warp keeps the sum of its blocks over the CTA's tiles and
// adds it to *total once, after the last tile.  The reference's narrow halo
// roll (K11a) and its (L, 1024) word and (nb, 128) block feeds (K11c) are
// TPU layout: here both feeds are one flat word array, and the words after
// a block are simply the next words.
//
// Bound on the H100: one read of the region from device memory (about
// 80 us for 256 MiB at 3.35 TB/s), with the eight masked compares per word
// close behind on the 16 INT32 lanes per scheduler, so once it streams the
// kernel is bound by its instruction rate.  scan_tiles streams: each CTA
// has the next 16 KiB tile in flight while it scans one, several CTAs per
// SM.
// Lane L of the warp that owns a block takes its words L, L + 32, L + 64
// and L + 96: the read of word w + k from shared memory is conflict-free
// for any probe offset k, at a register-plus-immediate address.  The
// eight (P, M) probe values sit in registers for the CTA's life; the block
// sum is one __reduce_add_sync, and lane 0 writes it.  A probe offset
// shared by two alignments is read once per alignment (the offsets are
// runtime values): those reads go to the shared-memory pipe, beside the
// compares.  K11a's per-alignment clamp runs only in the block that holds
// n_lim (a warp-uniform branch), so elsewhere it adds four bit inserts and
// a popcount per word to K1's work.
template <bool kNibSums>
__global__ void __launch_bounds__(kScanThreads)
screen_cand_kernel(const uint32_t* __restrict__ words, long long n_words,
                   long long n_lim, const uint32_t* __restrict__ P,
                   const uint32_t* __restrict__ M, int nw, Probes pr, int halo,
                   int* __restrict__ bs, int* __restrict__ total) {
  extern __shared__ uint32_t smem[];
  uint32_t pv[4][2], mv[4][2];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      pv[a][s] = __ldg(P + a * nw + pr.k[a][s]);
      mv[a][s] = __ldg(M + a * nw + pr.k[a][s]);
    }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n_blocks = n_words / kBlockWords;
  const long long wlim = n_lim >> 2;  // 4w <= n_lim  <=>  w <= floor(n_lim / 4)
  int sum = 0;  // K11a: lane 0's blocks, over the CTA's tiles
  scan_region(smem, words, n_words, halo, [=, &sum](int base, long long t, long long) {
#pragma unroll
    for (int i = 0; i < kTileBlocks / kScanWarps; ++i) {
      const int lb = warp + i * kScanWarps;
      const long long b = t * kTileBlocks + lb;
      if (b >= n_blocks) break;  // the ragged last tile
      // K1: the block's words j <= last pass the clamp.  K11a: its starts
      // at bytes 0..relc do.
      const long long rel = wlim - b * kBlockWords;
      const int last = rel < 0 ? -1 : (rel > kBlockWords ? kBlockWords : (int)rel);
      const long long relb = n_lim - (long long)kBlockBytes * b;
      const int relc = relb < 0 ? -1 : (int)(relb > kBlockBytes ? kBlockBytes : relb);
      const int x = base + lb * kBlockWords + lane;
      int count = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int xq = x + 32 * q;
        int hits = 0;  // bit a: alignment a's probe words compare equal
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const uint32_t d = ((smem[xq + pr.k[a][0]] & mv[a][0]) ^ pv[a][0]) |
                             ((smem[xq + pr.k[a][1]] & mv[a][1]) ^ pv[a][1]);
          // K1 needs only whether any alignment hit.
          hits |= kNibSums ? (int)(d == 0u) << a : (int)(d == 0u);
        }
        if (kNibSums) {
          if (relc < kBlockBytes - 1) {  // the block that holds n_lim
            int keep = relc - 4 * (lane + 32 * q) + 1;
            keep = keep < 0 ? 0 : (keep > 4 ? 4 : keep);
            hits &= (1 << keep) - 1;
          }
          count += __popc(hits);
        } else {
          count += hits != 0 && lane + 32 * q <= last;
        }
      }
      count = __reduce_add_sync(0xffffffffu, count);
      if (lane == 0) {
        bs[b] = count;
        sum += count;
      }
    }
  });
  if (kNibSums && lane == 0 && sum != 0) atomicAdd(total, sum);
}

// Exact verify of every start.  kEmitNib = true replaces
// kernels/swar.py::_naive_kernel (naive_nib with emit_nib=True), the full
// rescan that extract_region escalates to when candidate chunks outnumber
// its gather width, and the naive matcher's emission='nib' scan.
// kEmitNib = false replaces kernels/swar.py::_naive_sparse_kernel
// (emit_nib=False), the naive matcher's sparse scan: the same verify
// without the nibble store.  With Boyer-Moore probes in pr (K7, K8) it also
// replaces kernels/swar.py::_screened_kernel (bm_screen='fused',
// emission='nib'; probe indices fixed per pattern) and
// kernels/swar.py::_screened_dyn_kernel (bm_probes='table_dyn'; probe
// indices as runtime scalars): a runtime index costs nothing on Hopper, so
// the TPU's split between static lane slices and dynamic rotates has no
// counterpart, and the TPU's skip of a whole 512 KiB tile (Mosaic
// predicates no finer, swar.py:397-405) becomes a skip per warp.
//
// Bit a of a word's nibble is set when the pattern matches at byte 4w + a,
// kept only if 4w + a <= n_lim (validity per ALIGNMENT, as the reference's
// _validity_nibble).  bs[block] is the block's exact match count.  The
// screen only decides which words' chains run: a true match at alignment a
// passes a's screen words (they are among its pattern words), so nib and bs
// are K2's (K3's) bit for bit whatever the probes.
//
// Bound on the H100: one read of the region, plus one write of the int32
// nibble plane of the same size when kEmitNib (about 80 us or 160 us for
// 256 MiB at 3.35 TB/s).  The tiles stream through scan_tiles as K1's do.
// The pattern's 8 nw words are staged in shared memory once per CTA.  A
// word's chains run only past a screen that costs K1's eight compares
// whatever m is: alignment a's two words in pr, or for K2/K3 (negative
// indices in pr) its first and last whole words.  On text that repeats the
// pattern's own words (the word soup chip_smoke.py times is full of
// "quick") a screen on one word per alignment sends most warps down the
// chains, divergent, and costs more than it saves.  All four chains of a
// word with a hit run, and only in warps with a hit: running alignment a's
// chain only where a's own screen words hit (the first K7's rule) made the
// block-sum verify 27% slower on English and gained nothing on the dense
// text (kernel_ab.py, one H100).  Lane L owns words L + 32q of its warp's
// block, so each nibble store is one contiguous 128-byte line per warp.
//
// The verify of one block (verify_block) is also K11d's, on its gathered
// tiles (naive_groups_kernel below).

// The screen of the exact verify: per alignment two word indices and their
// pattern and mask words.
struct Screen {
  int k[4][2];
  uint32_t p[4][2], m[4][2];
};

// Stages P[4][nw], then M[4][nw], at pm (all of the CTA's threads) and
// returns the screen: pr's probe words, or where pr's are negative (K2/K3)
// alignment a's first and last whole words (word 0 twice if none is
// whole), as K1's 'static' probes: a start that fails either fails its
// chain, and two words far apart rarely both match where the pattern does
// not.
__device__ __forceinline__ Screen stage_screen(const uint32_t* __restrict__ P,
                                               const uint32_t* __restrict__ M,
                                               int nw, const Probes& pr, uint32_t* pm) {
  for (int t = threadIdx.x; t < 4 * nw; t += kScanThreads) {
    pm[t] = P[t];
    pm[4 * nw + t] = M[t];
  }
  __syncthreads();
  Screen sc;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (pr.k[a][0] >= 0) {
      sc.k[a][0] = pr.k[a][0];
      sc.k[a][1] = pr.k[a][1];
    } else {
      int first = -1, last = 0;
      for (int k = 0; k < nw; ++k)
        if (pm[4 * nw + a * nw + k] == 0xFFFFFFFFu) {
          first = first < 0 ? k : first;
          last = k;
        }
      sc.k[a][0] = first < 0 ? 0 : first;
      sc.k[a][1] = last;
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      sc.p[a][s] = pm[a * nw + sc.k[a][s]];
      sc.m[a][s] = pm[4 * nw + a * nw + sc.k[a][s]];
    }
  }
  return sc;
}

// One warp's exact verify of a 512-byte block whose word i is smem[x -
// lane + i] (the pattern's nw - 1 words after it too): lane L takes words
// L + 32q.  Starts at bytes 0..rel of the block pass the clamp (rel =
// n_lim - the block's first byte).  Under kEmitNib stores word i's nibble
// at nib_row[i]; returns the block's count in every lane.
template <bool kEmitNib>
__device__ __forceinline__ int verify_block(const uint32_t* smem, int x, const Screen& sc,
                                            const uint32_t* pm, int nw, long long rel,
                                            int lane, int* __restrict__ nib_row) {
  // The screen, branch-free: does any alignment of the word pass it?
  bool hit[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    hit[q] = false;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const uint32_t d = ((smem[x + 32 * q + sc.k[a][0]] & sc.m[a][0]) ^ sc.p[a][0]) |
                         ((smem[x + 32 * q + sc.k[a][1]] & sc.m[a][1]) ^ sc.p[a][1]);
      hit[q] |= d == 0u;
    }
  }
  int bits[4] = {0, 0, 0, 0};
  int sum = 0;
  // The chains, each to its first mismatch, of the words with a hit; the
  // warp takes this path only when one of its lanes has one.
  if (__any_sync(0xffffffffu, hit[0] | hit[1] | hit[2] | hit[3])) {
    const int relc = rel < 0 ? -1 : (int)(rel > kBlockBytes ? kBlockBytes : rel);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!hit[q]) continue;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        bool ok = true;
        for (int k = 0; ok && k < nw; ++k)
          ok = (smem[x + 32 * q + k] & pm[4 * nw + a * nw + k]) == pm[a * nw + k];
        bits[q] |= (int)ok << a;
      }
      int keep = relc - 4 * (lane + 32 * q) + 1;
      keep = keep < 0 ? 0 : (keep > 4 ? 4 : keep);
      bits[q] &= (1 << keep) - 1;
      sum += __popc(bits[q]);
    }
  }
  if (kEmitNib)
#pragma unroll
    for (int q = 0; q < 4; ++q) nib_row[lane + 32 * q] = bits[q];
  return __reduce_add_sync(0xffffffffu, sum);
}

template <bool kEmitNib>
__global__ void __launch_bounds__(kScanThreads)
naive_kernel(const uint32_t* __restrict__ words, long long n_words,
             long long n_lim, const uint32_t* __restrict__ P,
             const uint32_t* __restrict__ M, int nw, Probes pr,
             int* __restrict__ nib, int* __restrict__ bs) {
  extern __shared__ uint32_t smem[];
  uint32_t* pm = smem + 2 * kBufWords;  // P[4][nw], then M[4][nw]
  const Screen sc = stage_screen(P, M, nw, pr, pm);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n_blocks = n_words / kBlockWords;
  scan_region(smem, words, n_words, nw - 1, [=](int base, long long t, long long) {
#pragma unroll
    for (int i = 0; i < kTileBlocks / kScanWarps; ++i) {
      const int lb = warp + i * kScanWarps;
      const long long b = t * kTileBlocks + lb;
      if (b >= n_blocks) break;  // the ragged last tile
      const int sum = verify_block<kEmitNib>(smem, base + lb * kBlockWords + lane, sc, pm, nw,
                                             n_lim - (long long)kBlockBytes * b, lane,
                                             nib + b * kBlockWords);
      if (lane == 0) bs[b] = sum;
    }
  });
}

// Replaces exp/proto_kernels.py::_gv_kernel (K11d).
//
// Gather-verify over listed 4 KiB groups: K2's verify (verify_block, its
// own screen words) on gathered tiles.  The persistent grid walks the id
// list; tile i is group g8[i], its 8 blocks and the nw - 1 halo words that
// follow (read as zeros past n_words), staged through scan_tiles' two
// buffers with the next listed group in flight to registers.  Warp r
// verifies row r of every group: row r of the group is nib[i][r][*], its
// popcount bsr[8i + r], and lane 0 of each warp keeps its rows' sum over
// the CTA's groups and adds it to *total (zeroed by the C entry) once.
// The reference gathers each group and its successor's first row through
// scalar-prefetched block specs; here the halo is simply the words that
// follow.  Validity is per alignment from the UNCLAMPED id, as K2's of
// block 8 g8[i] + r: a start at byte 4096 g8[i] + 512 r + 4c + a is kept
// when <= n_lim.  An id outside [0, n_words / 1024) (the fill id n_words /
// 1024 among them) reads no word and yields zero rows.  The ids need not be
// ascending or distinct.
//
// Bound on the H100: the listed groups read once (4 KiB each, plus the
// halo) and their nibble planes written once (4 KiB each): about 11 us for
// 4096 groups at 3.35 TB/s.  A call lists a few thousand groups, a few per
// CTA, so the latency of the id, the group's load and the verify weighs as
// much as the bytes: 0.58 of the bound at 4096 ids (2781 listed) on 256 MiB
// of English, 0.37 at 1024 (kernel_ab.py, one H100).
__global__ void __launch_bounds__(kScanThreads)
naive_groups_kernel(const uint32_t* __restrict__ words, long long n_words,
                    long long n_lim, const int* __restrict__ g8, long long n_ids,
                    const uint32_t* __restrict__ P, const uint32_t* __restrict__ M,
                    int nw, Probes pr, int* __restrict__ nib, int* __restrict__ bsr,
                    int* __restrict__ total) {
  extern __shared__ uint32_t smem[];
  uint32_t* pm = smem + 2 * kGroupBufWords;  // P[4][nw], then M[4][nw]
  const Screen sc = stage_screen(P, M, nw, pr, pm);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n_groups = n_words / kGroupWords;
  int sum = 0;  // lane 0: its warp's rows, over the CTA's groups
  auto first_of = [=](long long i) -> long long {
    const long long g = __ldg(g8 + i);
    return g >= 0 && g < n_groups ? g * kGroupWords : -1;
  };
  scan_tiles<kGroupWords>(
      smem, words, n_words, n_ids, nw - 1, first_of,
      [=, &sum](int base, long long i, long long first) {
        const long long row = 8 * i + warp;
        int* nib_row = nib + row * kBlockWords;
        int count = 0;
        if (first >= 0) {  // the warp's block of a listed group
          const long long b = first / kBlockWords + warp;
          count = verify_block<true>(smem, base + warp * kBlockWords + lane, sc, pm, nw,
                                     n_lim - (long long)kBlockBytes * b, lane, nib_row);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) nib_row[lane + 32 * q] = 0;
        }
        if (lane == 0) {
          bsr[row] = count;
          sum += count;
        }
      });
  if (lane == 0 && sum != 0) atomicAdd(total, sum);
}

int check_args(long long n_words, int nw) {
  return (n_words % kBlockWords != 0 || nw < 1) ? (int)cudaErrorInvalidValue
                                                : 0;
}

int check_probes(const Probes& pr, int nw) {
  for (int a = 0; a < 4; ++a)
    for (int s = 0; s < 2; ++s)
      if (pr.k[a][s] < 0 || pr.k[a][s] >= nw) return (int)cudaErrorInvalidValue;
  return 0;
}

// K2/K3: the verify chooses its own screen words (naive_kernel).
constexpr Probes kOwnScreen = {{{-1, -1}, {-1, -1}, {-1, -1}, {-1, -1}}};

// K1 (kNibSums = false) or K11a: bs n_words / 128 ints, total one int (K11a
// zeroes it first).
template <bool kNibSums>
int launch_screen(const void* words, long long n_words, long long n_lim,
                  const void* P, const void* M, int nw, const Probes& pr,
                  void* bs, void* total, void* stream) {
  if (int err = check_args(n_words, nw)) return err;
  if (int err = check_probes(pr, nw)) return err;
  if (nw > kMaxPatternWords) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (kNibSums) {
    if (cudaError_t err = cudaMemsetAsync(total, 0, sizeof(int), s)) return (int)err;
  }
  if (n_words == 0) return 0;
  int halo = 0;  // the largest probe offset
  for (int a = 0; a < 4; ++a)
    for (int k = 0; k < 2; ++k) halo = pr.k[a][k] > halo ? pr.k[a][k] : halo;
  static tpm::GridCache ctas;
  unsigned grid = 0;
  if (int err = persistent_grid((const void*)screen_cand_kernel<kNibSums>,
                                kScanThreads, kTileSmem, tiles_of(n_words), &ctas,
                                &grid))
    return err;
  screen_cand_kernel<kNibSums><<<grid, kScanThreads, kTileSmem, s>>>(
      (const uint32_t*)words, n_words, n_lim, (const uint32_t*)P,
      (const uint32_t*)M, nw, pr, halo, (int*)bs, (int*)total);
  return (int)cudaGetLastError();
}

// K2/K3 (pr = kOwnScreen) or K7/K8 (the Boyer-Moore probes).
template <bool kEmitNib>
int launch_naive(const void* words, long long n_words, long long n_lim,
                 const void* P, const void* M, int nw, const Probes& pr,
                 void* nib, void* bs, void* stream) {
  if (int err = check_args(n_words, nw)) return err;
  if (nw > kMaxPatternWords) return (int)cudaErrorInvalidValue;
  if (n_words == 0) return 0;
  // The tile buffers, then the pattern's 8 nw words (room for the largest).
  const size_t smem = kTileSmem + kPatternSmem;
  static tpm::GridCache ctas;
  unsigned grid = 0;
  if (int err = persistent_grid((const void*)naive_kernel<kEmitNib>, kScanThreads,
                                smem, tiles_of(n_words), &ctas, &grid))
    return err;
  naive_kernel<kEmitNib><<<grid, kScanThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_words, n_lim, (const uint32_t*)P,
      (const uint32_t*)M, nw, pr, (int*)nib, (int*)bs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bs must hold n_words / 128 ints; n_words must be a multiple of 128, nw at
// most 128 (K1-K3, K7, K8, K11a) and each probe word index in [0, nw).
int tpm_screen_cand_bsums(const void* words, long long n_words, long long n_lim,
                          const void* P, const void* M, int nw, int k00,
                          int k01, int k10, int k11, int k20, int k21, int k30,
                          int k31, void* bs, void* stream) {
  const Probes pr = {{{k00, k01}, {k10, k11}, {k20, k21}, {k30, k31}}};
  return launch_screen<false>(words, n_words, n_lim, P, M, nw, pr, bs, nullptr,
                              stream);
}

// nib must hold n_words ints and bs n_words / 128.
int tpm_naive_nib(const void* words, long long n_words, long long n_lim,
                  const void* P, const void* M, int nw, void* nib, void* bs,
                  void* stream) {
  return launch_naive<true>(words, n_words, n_lim, P, M, nw, kOwnScreen, nib,
                            bs, stream);
}

// bs must hold n_words / 128 ints.
int tpm_naive_bsums(const void* words, long long n_words, long long n_lim,
                    const void* P, const void* M, int nw, void* bs,
                    void* stream) {
  return launch_naive<false>(words, n_words, n_lim, P, M, nw, kOwnScreen,
                             nullptr, bs, stream);
}

// K7/K8 with the nibble plane: the probe word indices per alignment as in
// tpm_screen_cand_bsums, each in [0, nw).  nib must hold n_words ints and
// bs n_words / 128.
int tpm_screened_nib(const void* words, long long n_words, long long n_lim,
                     const void* P, const void* M, int nw, int k00, int k01,
                     int k10, int k11, int k20, int k21, int k30, int k31,
                     void* nib, void* bs, void* stream) {
  const Probes pr = {{{k00, k01}, {k10, k11}, {k20, k21}, {k30, k31}}};
  if (int err = check_probes(pr, nw)) return err;
  return launch_naive<true>(words, n_words, n_lim, P, M, nw, pr, nib, bs,
                            stream);
}

// K7/K8 without the nibble plane: bs only (exact match counts).
int tpm_screened_bsums(const void* words, long long n_words, long long n_lim,
                       const void* P, const void* M, int nw, int k00, int k01,
                       int k10, int k11, int k20, int k21, int k30, int k31,
                       void* bs, void* stream) {
  const Probes pr = {{{k00, k01}, {k10, k11}, {k20, k21}, {k30, k31}}};
  if (int err = check_probes(pr, nw)) return err;
  return launch_naive<false>(words, n_words, n_lim, P, M, nw, pr, nullptr, bs,
                             stream);
}

// K11a/K11c: probe indices as in tpm_screen_cand_bsums, each in [0, nw).
// bs must hold n_words / 128 ints and total one int, which is zeroed here.
int tpm_screen_cand_nibsums(const void* words, long long n_words,
                            long long n_lim, const void* P, const void* M,
                            int nw, int k00, int k01, int k10, int k11,
                            int k20, int k21, int k30, int k31, void* bs,
                            void* total, void* stream) {
  const Probes pr = {{{k00, k01}, {k10, k11}, {k20, k21}, {k30, k31}}};
  return launch_screen<true>(words, n_words, n_lim, P, M, nw, pr, bs, total,
                             stream);
}

// K11d: words holds whole 4 KiB groups (n_words a multiple of 1024), g8 the
// n_ids int32 group ids, nw at most 128.  nib must hold n_ids * 1024 ints,
// bsr n_ids * 8 and total one int, which is zeroed here.
int tpm_gather_verify(const void* words, long long n_words, long long n_lim,
                      const void* g8, long long n_ids, const void* P,
                      const void* M, int nw, void* nib, void* bsr, void* total,
                      void* stream) {
  if (n_words % kGroupWords != 0 || nw < 1 || nw > kMaxPatternWords || n_ids < 0 ||
      n_ids > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cudaError_t err = cudaMemsetAsync(total, 0, sizeof(int), s)) return (int)err;
  if (n_ids == 0) return 0;
  const size_t smem = kGroupSmem + kPatternSmem;
  static tpm::GridCache ctas;
  unsigned grid = 0;
  if (int err = persistent_grid((const void*)naive_groups_kernel, kScanThreads, smem,
                                n_ids, &ctas, &grid))
    return err;
  naive_groups_kernel<<<grid, kScanThreads, smem, s>>>(
      (const uint32_t*)words, n_words, n_lim, (const int*)g8, n_ids,
      (const uint32_t*)P, (const uint32_t*)M, nw, kOwnScreen, (int*)nib, (int*)bsr,
      (int*)total);
  return (int)cudaGetLastError();
}

}  // extern "C"
