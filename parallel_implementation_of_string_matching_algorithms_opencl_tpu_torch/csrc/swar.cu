// Word-packed (SWAR) matching kernels for Hopper (sm_90a).
//
// The text is read as little-endian 32-bit words: word w holds bytes
// 4w..4w+3.  A match of an m-byte pattern starting at byte 4w + a
// (alignment a in 0..3) satisfies, for every pattern word k in [0, nw),
//
//     (word[w + k] & M[a][k]) == P[a][k]
//
// where P[a] is the pattern placed at byte offset a of a zeroed buffer and
// M[a] its byte-occupancy mask (kernels/swar.py pattern_words).  Both
// kernels run one thread per text word and 128 threads per block, so one
// CUDA block owns one 512-byte output block.  Words at or past n_words (the
// end of the kernel region) read as 0; a thread reads word w + k straight
// from global memory, and the neighbouring threads of a warp read
// neighbouring words, so every load instruction is one coalesced 128-byte
// line that later probes of the same block hit in L1.
//
// Block sums come out in byte order: bs[b] covers bytes 512b..512b+511.
// The JAX reference's tile-major reorder (swar.py _run) has no counterpart.
//
// Each C entry launches on the given stream, does not synchronise and
// returns cudaGetLastError(), which the Python wrapper turns into an error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;  // words per 512-byte output block

__device__ __forceinline__ uint32_t load_word(const uint32_t* __restrict__ words,
                                              long long j, long long n_words) {
  return j < n_words ? __ldg(words + j) : 0u;
}

struct Probes {
  int k[4][2];  // probe word index per alignment (a pair may repeat one word)
};

// Replaces kernels/swar.py::_screen_cand_kernel (Pallas, TPU).
//
// Boyer-Moore candidate screen: word w is a candidate when, for some
// alignment a, both probe words of a compare equal under their masks.  The
// count of candidate words with 4w <= n_lim (the clamp is per WORD, as in
// the reference) goes to bs[block].  Candidates are a superset of the
// matches; ops/reconstruct.extract_region verifies them exactly.
//
// Bound on the H100: one read of the region from device memory (about
// 80 us for 256 MiB at 3.35 TB/s).  Compute is at most 8 masked compares
// per word.  The design keeps it a pure stream: probe words come from L1
// after the first touch, the per-block count is one __syncthreads_count,
// and the only write is one int per 512 bytes.  The probe indices are
// kernel arguments: unlike the TPU's dynamic rotate, a runtime offset
// costs nothing here.
__global__ void __launch_bounds__(kBlock)
screen_cand_kernel(const uint32_t* __restrict__ words, long long n_words,
                   long long n_lim, const uint32_t* __restrict__ P,
                   const uint32_t* __restrict__ M, int nw, Probes pr,
                   int* __restrict__ bs) {
  const long long w = (long long)blockIdx.x * kBlock + threadIdx.x;
  int cand = 0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int k0 = pr.k[a][0];
    const int k1 = pr.k[a][1];
    const uint32_t x0 = load_word(words, w + k0, n_words);
    const uint32_t x1 = load_word(words, w + k1, n_words);
    const bool h0 = (x0 & __ldg(M + a * nw + k0)) == __ldg(P + a * nw + k0);
    const bool h1 = (x1 & __ldg(M + a * nw + k1)) == __ldg(P + a * nw + k1);
    cand |= (int)(h0 & h1);
  }
  if (4 * w > n_lim) cand = 0;
  const int count = __syncthreads_count(cand);
  if (threadIdx.x == 0) bs[blockIdx.x] = count;
}

// Replaces kernels/swar.py::_naive_kernel (Pallas, TPU; naive_nib with
// emit_nib=True), the full rescan that extract_region escalates to when
// candidate chunks outnumber its gather width.
//
// Exact verify of every start: bit a of nib[w] is set when the pattern
// matches at byte 4w + a.  Validity is per ALIGNMENT (as the reference's
// _validity_nibble): bit a is kept only if 4w + a <= n_lim.  bs[block] is
// the popcount of the block's 128 nibbles.
//
// Bound on the H100: one read of the region plus one write of the int32
// nibble plane (the same size), about 160 us for 256 MiB.  The pattern
// words sit in shared memory; each alignment's AND chain stops at its
// first mismatch, so on ordinary text a thread reads one or two words per
// alignment whatever m is.
__global__ void __launch_bounds__(kBlock)
naive_nib_kernel(const uint32_t* __restrict__ words, long long n_words,
                 long long n_lim, const uint32_t* __restrict__ P,
                 const uint32_t* __restrict__ M, int nw, int* __restrict__ nib,
                 int* __restrict__ bs) {
  extern __shared__ uint32_t pm[];  // P[4][nw] then M[4][nw]
  for (int t = threadIdx.x; t < 4 * nw; t += kBlock) {
    pm[t] = P[t];
    pm[4 * nw + t] = M[t];
  }
  __syncthreads();

  const long long w = (long long)blockIdx.x * kBlock + threadIdx.x;
  int bits = 0;
  for (int a = 0; a < 4; ++a) {
    const uint32_t* pa = pm + a * nw;
    const uint32_t* ma = pm + 4 * nw + a * nw;
    bool ok = true;
    for (int k = 0; k < nw && ok; ++k) {
      const uint32_t mk = ma[k];
      if (mk != 0u) ok = (load_word(words, w + k, n_words) & mk) == pa[k];
    }
    bits |= (int)ok << a;
  }
  long long keep = n_lim - 4 * w + 1;
  keep = keep < 0 ? 0 : (keep > 4 ? 4 : keep);
  bits &= (1 << (int)keep) - 1;
  nib[w] = bits;

  int c = __popc(bits);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  __shared__ int warp_sums[kBlock / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int i = 0; i < kBlock / 32; ++i) s += warp_sums[i];
    bs[blockIdx.x] = s;
  }
}

}  // namespace

extern "C" {

// bs must hold n_words / 128 ints; n_words must be a multiple of 128.
int tpm_screen_cand_bsums(const void* words, long long n_words, long long n_lim,
                          const void* P, const void* M, int nw, int k00,
                          int k01, int k10, int k11, int k20, int k21, int k30,
                          int k31, void* bs, void* stream) {
  if (n_words % kBlock != 0 || nw < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = n_words / kBlock;
  if (blocks == 0) return 0;
  Probes pr = {{{k00, k01}, {k10, k11}, {k20, k21}, {k30, k31}}};
  screen_cand_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_words, n_lim, (const uint32_t*)P,
      (const uint32_t*)M, nw, pr, (int*)bs);
  return (int)cudaGetLastError();
}

// nib must hold n_words ints and bs n_words / 128.
int tpm_naive_nib(const void* words, long long n_words, long long n_lim,
                  const void* P, const void* M, int nw, void* nib, void* bs,
                  void* stream) {
  if (n_words % kBlock != 0 || nw < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = n_words / kBlock;
  if (blocks == 0) return 0;
  const size_t smem = 2 * 4 * (size_t)nw * sizeof(uint32_t);
  naive_nib_kernel<<<(unsigned)blocks, kBlock, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_words, n_lim, (const uint32_t*)P,
      (const uint32_t*)M, nw, (int*)nib, (int*)bs);
  return (int)cudaGetLastError();
}

const char* tpm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
