// Rolling canonical k-mer extraction fused with the sort engine's append.
//
// Replaces the TPU kernel metacherchant_tpu/ops/pallas_kmers.py::_extract_kernel
// (called from exact_canonical_kmers_pallas) together with the append of
// metacherchant_tpu/ops/sortcount.py::_append_kernel.
//
// What it computes. Rows of an int8 code array (codes 0..3, any negative
// code is N or padding) and 1 <= k <= 31. Row r holds len_r >= k codes from
// codes[start_r]; its len_r - k + 1 windows write, in order, from
// out[off_r], where off is the running sum of the rows' window counts:
//   key = min(fw, rc)     fw = sum c_i << 2(k-1-i),  rc = sum (3-c_i) << 2i
// over the window's codes c_0..c_{k-1} (itmo:dna/kmers/ShortKmer.java:68-71),
// or SENTINEL (int64 max) when one of them is negative. Both registers stay
// below 2^62, so the unsigned minimum equals the signed one the reference
// takes. The dense (rows, len) batch of the classifier is the case
// start_r = r*len, len_r = len, off_r = r*(len-k+1); that entry computes the
// three from r instead of reading tables.
//
// What bounds it: bytes. Each code is read once and each window writes one
// int64 key, about 8 bytes written per byte read, with a handful of integer
// operations per byte; at 3.35 TB/s a launch of 4096 reads of 150 codes
// needs 1.4 us. The first design (one thread per read walking its codes
// serially, a TPU-shaped (4096, 256) tile packed on the host) reached about
// 5% of that: 32 blocks on 132 SMs, every warp load and store touching 32
// rows, and 47% of the lanes written as padding.
//
// The design here:
//   - a block takes a tile of kTileRows consecutive rows. In counting's
//     layout (chunks of consecutive fragments, k-1 overlap between the
//     chunks of a long fragment) their codes span one short contiguous
//     range, and their outputs are one contiguous range of out;
//   - the block stages that code range into shared memory with 16-byte
//     loads, each aligned to 16 bytes in device memory; the unaligned edges
//     and anything past the array are read byte by byte or not at all. While
//     staging it packs every 32 codes into a 64-bit forward word (first code
//     in the top bits), a 64-bit complement word (first code in the low bits)
//     and a 32-bit invalid mask, a few multiply-shift steps per 4 codes;
//   - threads then walk the tile's output lanes in order: consecutive
//     threads write consecutive int64 keys, so a warp stores 256 contiguous
//     bytes. A lane finds its row by advancing through the tile's offsets in
//     shared memory, and reads its window as two funnel shifts of two
//     neighbouring words plus one of the invalid mask: no loop over k;
//   - 16 rows per tile give 256 blocks for a launch of 4096 reads and
//     8,192 for 131,072: several blocks per SM;
//   - the ragged entry's tables are checked where they are read: each row's
//     thread tests its length, its bounds and its offset against the row
//     before; a tile with a fault writes nothing and ORs the fault into a
//     word the wrapper reads back, so no torch pass over the tables is needed;
//   - a tile whose code range does not fit the staging buffer (rows far
//     apart in the array, or rows of more than 2,048 codes) computes each
//     window from device memory instead, k byte loads per lane: the same
//     keys, slower. Counting's and the classifier's layouts never take it.
// Tensor cores have no part in this. The kernel allocates nothing, launches
// on the caller's stream and does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kSentinel = 0x7fffffffffffffffLL;
constexpr int kThreads = 256;
constexpr int kTileRows = 16;
constexpr int kMaxWords = 1024;  // 32,768 codes staged per tile
static_assert(kTileRows <= 32, "warp 0 reduces the tile's rows");

// Row geometry: tables for the ragged entry, arithmetic for the dense one.
struct Rows {
  const long long* starts;
  const int* lens;
  const long long* offs;
  int len;  // dense row length
};

template <bool kDense>
__device__ __forceinline__ void row_geometry(const Rows& g, int r, int k,
                                             long long& start, int& len,
                                             long long& off) {
  if (kDense) {
    start = static_cast<long long>(r) * g.len;
    len = g.len;
    off = static_cast<long long>(r) * (g.len - k + 1);
  } else {
    start = g.starts[r];
    len = g.lens[r];
    off = g.offs[r];
  }
}

// 16 codes from codes[s], s a multiple of 16 bytes from a 16-byte boundary;
// bytes outside [0, n) read as 0xFF (invalid) and are never loaded.
__device__ __forceinline__ uint4 load16(const int8_t* codes, long long n,
                                        long long s) {
  if (s >= 0 && s + 16 <= n)
    return __ldg(reinterpret_cast<const uint4*>(codes + s));
  unsigned v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const long long p = s + j;
    const unsigned byte =
        (p >= 0 && p < n) ? static_cast<unsigned>(static_cast<uint8_t>(codes[p]))
                          : 0xFFu;
    v[j >> 2] |= byte << (8 * (j & 3));
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Pack 16 codes (byte j = code j): forward 2-bit codes with code 0 in the
// top bits, complements 3-c with code 0 in the low bits, and bit j set when
// code j is negative. Each multiply gathers the 2-bit fields (or sign bits)
// of four bytes into one byte; the partial products never overlap or carry
// into it.
__device__ __forceinline__ void pack16(uint4 q, unsigned& fw, unsigned& rc,
                                       unsigned& inv) {
  const unsigned x[4] = {q.x, q.y, q.z, q.w};
  fw = rc = inv = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned c = x[i] & 0x03030303u;
    const unsigned cc = ~x[i] & 0x03030303u;
    const unsigned sign = (x[i] >> 7) & 0x01010101u;
    fw |= ((c * 0x40100401u) >> 24) << (24 - 8 * i);
    rc |= ((cc * 0x01041040u) >> 24) << (8 * i);
    inv |= (((sign * 0x00204081u) >> 21) & 0xFu) << (4 * i);
  }
}

template <bool kDense>
__global__ void __launch_bounds__(kThreads)
extract_kernel(const int8_t* __restrict__ codes, long long n_codes, Rows g,
               int rows, int k, long long* __restrict__ out, long long n_out,
               int* __restrict__ err) {
  __shared__ unsigned long long s_fw[kMaxWords + 1];
  __shared__ unsigned long long s_rc[kMaxWords + 1];
  __shared__ unsigned s_inv[kMaxWords + 1];
  __shared__ long long s_start[kTileRows];
  __shared__ long long s_off[kTileRows + 1];
  __shared__ long long s_lo, s_hi;
  __shared__ unsigned s_bad;

  const int r0 = blockIdx.x * kTileRows;
  const int nrows = min(kTileRows, rows - r0);
  const int tid = threadIdx.x;
  if (tid < 32) {
    long long lo = 0x7fffffffffffffffLL, hi = -lo - 1;
    unsigned bad = 0u;
    if (tid < nrows) {
      const int r = r0 + tid;
      long long start, off;
      int len;
      row_geometry<kDense>(g, r, k, start, len, off);
      s_start[tid] = start;
      s_off[tid] = off;
      if (tid == nrows - 1) s_off[nrows] = off + len - k + 1;
      lo = start;
      hi = start + len;
      if (!kDense) {  // the tables' checks, one row per thread
        long long want = 0, ps, po;
        int pl;
        if (r > 0) {
          row_geometry<kDense>(g, r - 1, k, ps, pl, po);
          want = po + pl - k + 1;
        }
        bad = (len < k ? 1u : 0u) |
              (start < 0 || start + len > n_codes ? 2u : 0u) |
              (off != want ? 4u : 0u) |
              (r == rows - 1 && off + len - k + 1 != n_out ? 8u : 0u);
      }
    }
#pragma unroll
    for (int m = 16; m; m >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, m));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, m));
      bad |= __shfl_xor_sync(0xffffffffu, bad, m);
    }
    if (tid == 0) {
      s_lo = lo;
      s_hi = hi;
      s_bad = bad;
    }
  }
  __syncthreads();
  const long long first = s_off[0], end = s_off[nrows];
  if (!kDense) {  // a tile with a bad row, or lanes outside out, writes nothing
    const unsigned bad = s_bad | (first < 0 || end > n_out ? 8u : 0u);
    if (bad) {
      if (tid == 0) atomicOr(err, static_cast<int>(bad));
      return;
    }
  }

  // first staged code: lo, moved down to a 16-byte boundary in memory
  const long long base =
      s_lo - static_cast<long long>((reinterpret_cast<uintptr_t>(codes) + s_lo) & 15);
  const long long words = (s_hi - base + 31) >> 5;
  const unsigned long long mask = (1ULL << (2 * k)) - 1ULL;
  const unsigned kmask = (1u << k) - 1u;
  int t = 0;

  if (words <= kMaxWords) {
    for (int w = tid; w < words; w += kThreads) {
      const long long s = base + 32LL * w;
      unsigned f0, c0, i0, f1, c1, i1;
      pack16(load16(codes, n_codes, s), f0, c0, i0);
      pack16(load16(codes, n_codes, s + 16), f1, c1, i1);
      s_fw[w] = (static_cast<unsigned long long>(f0) << 32) | f1;
      s_rc[w] = (static_cast<unsigned long long>(c1) << 32) | c0;
      s_inv[w] = (i1 << 16) | i0;
    }
    if (tid == 0) {  // the neighbour word of a window in the last word
      s_fw[words] = 0ULL;
      s_rc[words] = 0ULL;
      s_inv[words] = 0u;
    }
    __syncthreads();
    for (long long lane = first + tid; lane < end; lane += kThreads) {
      while (lane >= s_off[t + 1]) ++t;
      const int q = static_cast<int>(s_start[t] - base + (lane - s_off[t]));
      const int w = q >> 5, o = q & 31;
      unsigned long long f = s_fw[w], r = s_rc[w];
      if (o) {
        f = (f << (2 * o)) | (s_fw[w + 1] >> (64 - 2 * o));
        r = (r >> (2 * o)) | (s_rc[w + 1] << (64 - 2 * o));
      }
      f >>= 64 - 2 * k;
      r &= mask;
      const unsigned bad = __funnelshift_r(s_inv[w], s_inv[w + 1], o) & kmask;
      out[lane] = bad ? kSentinel : static_cast<long long>(f < r ? f : r);
    }
  } else {
    for (long long lane = first + tid; lane < end; lane += kThreads) {
      while (lane >= s_off[t + 1]) ++t;
      const int8_t* p = codes + s_start[t] + (lane - s_off[t]);
      unsigned long long f = 0ULL, r = 0ULL;
      bool bad = false;
      for (int j = 0; j < k; ++j) {
        const int c = __ldg(p + j);
        const unsigned long long cc = static_cast<unsigned long long>(c & 3);
        bad |= c < 0;
        f = (f << 2) | cc;
        r |= (3ULL - cc) << (2 * j);
      }
      out[lane] = bad ? kSentinel : static_cast<long long>(f < r ? f : r);
    }
  }
}

int launch_blocks(int rows) { return (rows + kTileRows - 1) / kTileRows; }

}  // namespace

// Dense batch. codes: (rows, len) int8, row-major; out: rows * (len - k + 1)
// int64. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mc_extract_append(const void* codes, void* out, int rows,
                                 int len, int k, void* stream) {
  const Rows g{nullptr, nullptr, nullptr, len};
  const long long n_codes = static_cast<long long>(rows) * len;
  extract_kernel<true><<<launch_blocks(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), n_codes, g, rows, k,
      static_cast<long long*>(out), static_cast<long long>(rows) * (len - k + 1),
      nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Ragged rows. codes: n_codes int8; starts, offs: rows int64; lens: rows
// int32; out: n_out int64. The kernel checks the tables as it reads them and
// ORs into *err (an int32 the caller zeroed): 1 a row shorter than k, 2 a row
// outside the codes, 4 offs not the running sum of lens - k + 1 from 0, 8 the
// rows' windows not exactly n_out. A tile with a fault writes nothing.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mc_extract_append_ragged(const void* codes, long long n_codes,
                                        const void* starts, const void* lens,
                                        const void* offs, int rows, int k,
                                        void* out, long long n_out, void* err,
                                        void* stream) {
  const Rows g{static_cast<const long long*>(starts),
               static_cast<const int*>(lens),
               static_cast<const long long*>(offs), 0};
  extract_kernel<false><<<launch_blocks(rows), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), n_codes, g, rows, k,
      static_cast<long long*>(out), n_out, static_cast<int*>(err));
  return static_cast<int>(cudaGetLastError());
}
