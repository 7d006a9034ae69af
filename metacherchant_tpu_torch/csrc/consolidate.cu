// Merge of the sort engine's sorted buffer into its compact store, with the
// reduce by key: one merge-path pass that counts, one that writes.
//
// Replaces no Pallas kernel. On the card it replaces the JAX package's
// consolidation routes, among them the merge-split
// (metacherchant_tpu/ops/sortcount.py: a
// bitonic merge of store and sorted buffer padded to a power of two, an
// int64 cumsum, run-last marking and log2(n) shift stages), which the JAX
// package builds from static-stride slices because its TPU compiler handles
// only those. On the card that route is some 52 eager passes over every
// lane of the padded total.
//
// What it computes. A store of na distinct keys, ascending (int64, compared
// signed as torch compares them), with int32 counts, and a sorted run of nb
// raw keys, each of weight 1 (a SENTINEL key, int64 max, weighs 0 and is
// never written). Out: the distinct non-SENTINEL keys of both, ascending,
// each with its total weight, store counts clamped at 1e9 before the sum
// and totals clamped at 1e9 -- the plain version's store
// (ops/consolidate_cuda.consolidate) bit for bit.
//
// What bounds it: bytes. The store's 12 bytes a key and the run's 8 bytes a
// lane read once, the new store's 12 bytes a key written once
// (benchmark/peaks.py consolidate_bytes); at 3.35 TB/s a merge of a 2^27-key
// store with a 2^28-lane run needs about 1.5 ms.
//
// The design:
//   - the merged sequence is cut into tiles of kTile lanes. One thread per
//     tile edge finds, by a merge-path binary search on its diagonal, how
//     many store keys precede it (ties put the store first); a block then
//     owns the store and run slices between its two edges and stages them
//     in shared memory with coalesced 8-byte loads (a warp reads 256
//     contiguous bytes), together with the one key that follows the tile;
//   - each thread finds its kItems lanes' split inside the tile by the same
//     search in shared memory and merges them serially, one lane ahead, so
//     it knows which of its lanes end a run of equal keys (a run-last), at
//     tile edges too;
//   - pass 1 reduces each tile's run-lasts and weight; torch.cumsum scans
//     the small per-tile arrays, and the wrapper reads the distinct count
//     back (the one readback the route always made) to allocate the new
//     store at its exact size;
//   - pass 2 merges again, scans the threads' run-lasts and weights in the
//     block, gathers each run-last's key and its inclusive int64 weight
//     prefix in shared memory at its scanned place, and stores the tile's
//     run-lasts to their place in the new store with coalesced stores (a
//     thread writing its own few run-lasts straight out touched a 32-byte
//     sector per 8-byte key, and took three times pass 1's time); a last
//     pass takes each count as the
//     difference of neighbouring prefixes, so a key whose lanes span many
//     tiles (a frequent k-mer fills thousands of buffer lanes) gets its
//     whole total without any carry between blocks.
// The kernels allocate nothing, launch on the caller's stream and do not
// synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kSentinel = 0x7fffffffffffffffLL;
constexpr int kClamp = 1000000000;
constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // merged lanes a block
constexpr int kWarps = kThreads / 32;

// How many of a's keys are among the first d lanes of the merge of a and
// b (both ascending; on equal keys a's come first).
template <typename Index>
__device__ __forceinline__ Index merge_split(const long long* a, Index na,
                                             const long long* b, Index nb,
                                             Index d) {
  Index lo = d > nb ? d - nb : 0;
  Index hi = d < na ? d : na;
  while (lo < hi) {
    const Index mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid])
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void partition_kernel(const long long* a, long long na,
                                 const long long* b, long long nb,
                                 long long n_tiles, long long* splits) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t > n_tiles) return;
  const long long d = min(t * kTile, na + nb);
  splits[t] = merge_split<long long>(a, na, b, nb, d);
}

// Exclusive block scan of two sums; `total` gets the block's totals.
__device__ __forceinline__ void block_scan(long long& r, long long& w,
                                           long long (*s)[kWarps],
                                           long long& total_r,
                                           long long& total_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long ir = r, iw = w;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long ur = __shfl_up_sync(0xffffffffu, ir, o);
    const long long uw = __shfl_up_sync(0xffffffffu, iw, o);
    if (lane >= o) {
      ir += ur;
      iw += uw;
    }
  }
  if (lane == 31) {
    s[0][warp] = ir;
    s[1][warp] = iw;
  }
  __syncthreads();
  long long br = 0, bw = 0;
  total_r = total_w = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    if (i < warp) {
      br += s[0][i];
      bw += s[1][i];
    }
    total_r += s[0][i];
    total_w += s[1][i];
  }
  r = br + ir - r;
  w = bw + iw - w;
}

// kWrite false: tile_runs[t], tile_weight[t] = the tile's run-lasts and
// weight. kWrite true: those arrays hold their exclusive scans; writes the
// run-lasts' keys and inclusive weight prefixes.
template <bool kWrite>
__global__ void __launch_bounds__(kThreads)
    tile_kernel(const long long* a, const int* a_cnt, long long na,
                const long long* b, long long nb, const long long* splits,
                long long* tile_runs, long long* tile_weight,
                long long* out_keys, long long* out_pref) {
  __shared__ long long s_key[kTile];
  __shared__ int s_w[kTile];
  __shared__ long long s_scan[2][kWarps];
  const long long n = na + nb;
  const long long t = blockIdx.x;
  const long long d0 = t * kTile, d1 = min(d0 + kTile, n);
  const long long a0 = splits[t], a1 = splits[t + 1];
  const long long b0 = d0 - a0, b1 = d1 - a1;
  const int ta = static_cast<int>(a1 - a0), tb = static_cast<int>(b1 - b0);
  const int tn = ta + tb;
  for (int i = threadIdx.x; i < tn; i += kThreads) {
    long long key;
    int w;
    if (i < ta) {
      key = a[a0 + i];
      const int c = a_cnt[a0 + i];
      w = key == kSentinel ? 0 : min(c, kClamp);
    } else {
      key = b[b0 + i - ta];
      w = key != kSentinel;
    }
    s_key[i] = key;
    s_w[i] = w;
  }
  // the key of merged lane d1, which decides whether the tile's last lane
  // ends its run
  const bool has_after = d1 < n;
  long long after = 0;
  if (has_after)
    after = (a1 < na && (b1 >= nb || a[a1] <= b[b1])) ? a[a1] : b[b1];
  __syncthreads();

  const long long* sa = s_key;
  const long long* sb = s_key + ta;
  const int d = min(static_cast<int>(threadIdx.x) * kItems, tn);
  int i = merge_split<int>(sa, ta, sb, tb, d);
  int j = d - i;
  const int count = min(kItems, tn - d);
  long long keys[kItems];
  int ws[kItems];
  unsigned runs_at = 0;
  long long runs = 0, weight = 0;
  long long key = 0;
  int w = 0;
  auto take = [&](long long& k_out, int& w_out) {
    if (i < ta && (j >= tb || sa[i] <= sb[j])) {
      k_out = sa[i];
      w_out = s_w[i];
      ++i;
    } else {
      k_out = sb[j];
      w_out = s_w[ta + j];
      ++j;
    }
  };
  if (count > 0) take(key, w);
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    if (s < count) {
      long long next = after;
      int next_w = 0;
      bool has_next = has_after;
      if (d + s + 1 < tn) {
        take(next, next_w);
        has_next = true;
      }
      const bool run_last = (!has_next || next != key) && key != kSentinel;
      keys[s] = key;
      ws[s] = w;
      runs_at |= static_cast<unsigned>(run_last) << s;
      runs += run_last;
      weight += w;
      key = next;
      w = next_w;
    }
  }
  long long total_r, total_w;
  block_scan(runs, weight, s_scan, total_r, total_w);
  if constexpr (kWrite) {
    // the tile's run-lasts go to shared memory in order (s_key is free once
    // every thread has passed block_scan's barrier), then out in coalesced
    // stores
    __shared__ long long s_pref[kTile];
    int at = static_cast<int>(runs);
    long long pref = tile_weight[t] + weight;
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
      if (s < count) {
        pref += ws[s];
        if (runs_at >> s & 1u) {
          s_key[at] = keys[s];
          s_pref[at] = pref;
          ++at;
        }
      }
    }
    __syncthreads();
    const long long base = tile_runs[t];
    for (int i = threadIdx.x; i < total_r; i += kThreads) {
      out_keys[base + i] = s_key[i];
      out_pref[base + i] = s_pref[i];
    }
  } else if (threadIdx.x == 0) {
    tile_runs[t] = total_r;
    tile_weight[t] = total_w;
  }
}

__global__ void diff_kernel(const long long* pref, long long nd, int* cnt) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < nd; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long c = pref[i] - (i > 0 ? pref[i - 1] : 0);
    cnt[i] = static_cast<int>(c < kClamp ? c : kClamp);
  }
}

unsigned blocks_for(long long items, long long per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

}  // namespace

extern "C" int mc_consolidate_tile_lanes() { return kTile; }

// Pass 1: the tile edges' splits (n_tiles + 1 of them) and each tile's
// run-lasts and weight.
extern "C" int mc_consolidate_count(const void* keys, const void* cnts,
                                    long long na, const void* run,
                                    long long nb, long long n_tiles,
                                    void* splits, void* tile_runs,
                                    void* tile_weight, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* a = static_cast<const long long*>(keys);
  const long long* b = static_cast<const long long*>(run);
  long long* sp = static_cast<long long*>(splits);
  partition_kernel<<<blocks_for(n_tiles + 1, kThreads), kThreads, 0, s>>>(
      a, na, b, nb, n_tiles, sp);
  tile_kernel<false><<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      a, static_cast<const int*>(cnts), na, b, nb, sp,
      static_cast<long long*>(tile_runs),
      static_cast<long long*>(tile_weight), nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: tile_runs and tile_weight hold their exclusive scans; writes the
// nd distinct keys, their inclusive weight prefixes (scratch) and counts.
extern "C" int mc_consolidate_write(const void* keys, const void* cnts,
                                    long long na, const void* run,
                                    long long nb, long long n_tiles,
                                    const void* splits, void* tile_runs,
                                    void* tile_weight, void* out_keys,
                                    void* out_pref, void* out_cnts,
                                    long long nd, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* pref = static_cast<long long*>(out_pref);
  tile_kernel<true><<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      static_cast<const long long*>(keys), static_cast<const int*>(cnts), na,
      static_cast<const long long*>(run), nb,
      static_cast<const long long*>(splits),
      static_cast<long long*>(tile_runs),
      static_cast<long long*>(tile_weight),
      static_cast<long long*>(out_keys), pref);
  const unsigned diff_blocks = blocks_for(nd, kThreads);
  diff_kernel<<<diff_blocks < 132u * 16u ? diff_blocks : 132u * 16u,
                kThreads, 0, s>>>(pref, nd, static_cast<int*>(out_cnts));
  return static_cast<int>(cudaGetLastError());
}
