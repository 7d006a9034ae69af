// Rolling canonical k-mer extraction fused with the sort engine's append.
//
// Replaces the TPU kernel metacherchant_tpu/ops/pallas_kmers.py::_extract_kernel
// together with the append of metacherchant_tpu/ops/sortcount.py::_append_kernel.
//
// For a (rows, len) int8 code matrix (codes 0..3, -1 for padding and N) and
// 1 <= k <= 31, one thread walks one read and keeps the 2-bit forward and
// reverse-complement registers (itmo:dna/kmers/ShortKmer.java:68-71):
//   fw = ((fw << 2) | c) & mask(2k)        rc = (rc >> 2) | ((3 - c) << (2k - 2))
// and writes, for every column j >= k - 1, the canonical key min(fw, rc) of the
// window [j-k+1, j], or SENTINEL (int64 max) when one of its k codes is invalid,
// to out[b * (len - k + 1) + (j - k + 1)]: the first k-1 columns, which never
// hold a window, are not written. Both registers stay below 2^62, so the
// unsigned minimum equals the signed one the reference takes; the TPU kernel's
// int32 (hi, lo) halves and sign-flip compare only worked around its compiler.
// A register counter of consecutive valid codes replaces the cummax validity
// mask of ops/kmers.py: after k valid codes every earlier bit has been shifted
// out of both registers, so the keys are bit-identical.
//
// What bounds it: memory traffic, about len bytes read and (len-k+1)*8 bytes
// written per read, with a handful of integer operations per byte. The simple
// design leaves for later:
//   - one thread per read: the default batch of 4096 reads fills only 32 blocks
//     of 128 threads on the H100's 132 SMs;
//   - row-major codes make a warp's loads strided (32 rows, one byte each);
//   - splitting reads into segments with a k-1 halo, or staging (32 x len) code
//     tiles in shared memory, would fix both.
// The kernel allocates nothing, launches on the caller's stream and does not
// synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kSentinel = 0x7fffffffffffffffLL;

__global__ void extract_append_kernel(const int8_t* __restrict__ codes,
                                      long long* __restrict__ out,
                                      int rows, int len, int k) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= rows) return;
  const int8_t* row = codes + static_cast<long long>(b) * len;
  long long* dst = out + static_cast<long long>(b) * (len - k + 1);
  const unsigned long long mask = (1ULL << (2 * k)) - 1ULL;
  const int shift_hi = 2 * k - 2;
  unsigned long long fw = 0ULL, rc = 0ULL;
  int run = 0;
  for (int j = 0; j < len; ++j) {
    const int c = row[j];
    const unsigned long long cc = c < 0 ? 0ULL : static_cast<unsigned long long>(c);
    run = c < 0 ? 0 : (run < k ? run + 1 : k);
    fw = ((fw << 2) | cc) & mask;
    rc = (rc >> 2) | ((3ULL - cc) << shift_hi);
    if (j >= k - 1) {
      const unsigned long long key = fw < rc ? fw : rc;
      dst[j - (k - 1)] = run >= k ? static_cast<long long>(key) : kSentinel;
    }
  }
}

}  // namespace

// codes: (rows, len) int8, row-major; out: rows * (len - k + 1) int64.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mc_extract_append(const void* codes, void* out, int rows,
                                 int len, int k, void* stream) {
  const int threads = 128;
  const int blocks = (rows + threads - 1) / threads;
  extract_append_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<long long*>(out), rows, len, k);
  return static_cast<int>(cudaGetLastError());
}
