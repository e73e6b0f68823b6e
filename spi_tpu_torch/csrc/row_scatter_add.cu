// Row scatter-add for Hopper: updates binned by table slice, rows summed
// in registers; and, for short rows into a table that fits the L2, one
// float4 reduction an update.
//
// Replaces the Pallas TPU kernel `kernel` of `pallas_rmw_probe` in
// tools/probe_scatter_r5.py: zeros(R, C).at[rows].add(upd), a serial
// read-modify-write of one VMEM-resident table, row by row, along a
// sequential grid. As JAX's scatter does, a row in [-R, 0) wraps to
// row + R and every other row outside [0, R) is dropped.
//
// What bounds it on an H100: bytes (the row ids, the live rows' updates
// and the table written once: 112 MB for 786,432 rows of 32 f32 into
// 65,536, 34 us at 3.35 TB/s; 439 MB at 128 channels, 77 MB with 90% of
// the rows dead). Blocks run in no order, so nothing can carry a table
// from one to the next.
//
// The binned route (spi_row_scatter_add). The first port gave each (row,
// 4-channel group) one 16-byte atomicAdd in the L2 (25.2 M at 128
// channels), after a memset of the table that the atomics read back, and
// spent 32 threads on a dead row at 128 channels. Here a block owns one
// slice of kSliceRows table rows, the updates are binned by slice first,
// and each slice's rows are summed in registers and written once with
// plain stores. An f32 atomicAdd to shared memory is a compare-and-swap
// loop on sm_90 (ATOMS.CAST.SPIN), so no float is added in shared memory:
// the bins are counting sorts with integer ATOMS.ADD. Four passes:
//   1. count: a block takes kChunk updates, a thread an update row (not a
//      channel group); it wraps or drops the row, counts it into its
//      bucket (row / kSliceRows) in a block histogram and keeps its rank
//      there;
//   2. colscan: each bucket's column of the (blocks, buckets) histograms
//      scanned over the blocks, 32 buckets a block;
//   3. place: each block scans the bucket totals into offsets (block 0
//      also lists the parts: a bucket of more than kBucketSplit entries
//      is split into parts of kBucketSplit), sorts its live updates by
//      bucket in shared memory and writes each one's index and row within
//      the slice to the list, a bucket's run contiguous; it zeroes the
//      slices of the split buckets;
//   4. sum: a few blocks an SM walk the parts. A block ranks its part's
//      entries by row within the slice (a counting sort in shared memory),
//      and lanes of neighbouring 4-channel groups sum each row's run with
//      float4 loads of the update rows, four in flight. A bucket of one
//      part stores every row of its slice once, zeros for a row with no
//      update, so nothing is zeroed first. A run longer than kRunSplit (a
//      hot row) is split into pieces that other lanes, and so other warps,
//      sum side by side; each piece adds into its row with one float4
//      reduction (REDG), after the block stored the row's zeros, fenced
//      them and met at a barrier. A split bucket's parts add every run they
//      hold in pieces into the slice that pass 3 zeroed.
// The scratch (histograms, prefixes, totals, parts, the placed list) comes
// from the caller; no pass allocates or waits on the host.
//
// The atomic route (spi_row_scatter_add_atomic): the first port's kernel
// with the wrap. The binned route gathers each live update row at random:
// 512-byte rows at 128 channels at about 2.8 TB/s, 128-byte rows at 32
// channels at 2.2 TB/s, and the three binning passes add about 20 us to a
// call. At 32 channels into an 8 MB table the atomic route streams the
// updates and its reductions stay in the L2: 0.062 ms, where the binned
// route takes 0.076 (PERF.md §6 row 6), so the wrapper
// sends rows of at most 32 channels into a table of at most half the L2
// there. Its one weakness is a row that takes most updates: the
// reductions into one line serialize (1.86 ms for 786,432 updates into
// one row of 32 channels; the binned route 0.10 ms).
//
// The order of the adds within a row follows the atomics' ranks (and the
// L2's order of the reductions), so the f32 sums may differ in their last
// bits from run to run.

#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kSliceRows = 64;       // table rows a bucket covers (SLICE_ROWS)
constexpr int kSliceShift = 6;       // log2(kSliceRows)
constexpr int kBucketSplit = 4096;   // most entries one block of the sum pass takes (BUCKET_SPLIT)
constexpr int kRunSplit = 64;        // longest run one lane group sums alone (RUN_SPLIT)
constexpr int kChunk = 8192;         // updates a block of the count and place passes takes (CHUNK)
constexpr int kMaxBuckets = 16384;   // buckets a block histogram holds (MAX_BUCKETS)
constexpr int kBinThreads = 1024;
constexpr int kSumThreads = 512;
constexpr int kPerBin = kChunk / kBinThreads;          // updates a thread of passes 1 and 3
constexpr int kPerSum = kBucketSplit / kSumThreads;    // entries a thread of pass 4
constexpr int kMaxPieces = kSliceRows + kBucketSplit / kRunSplit;
static_assert(1 << kSliceShift == kSliceRows, "kSliceShift");
static_assert(kSliceRows % 32 == 0 && kSliceRows <= 256, "slice rows: whole lanes, 8-bit ids");
static_assert(kBucketSplit < (1 << 16) && kChunk <= (1 << 16), "ranks are 16-bit");
static_assert(kMaxBuckets <= (1 << 16), "bucket ids are 16-bit in pass 3");

using BinScan = cub::BlockScan<int, kBinThreads>;

// This lane's rank among the adds of 1 to counter[key] (an integer
// shared-memory atomic).
__device__ __forceinline__ int take_rank(int* counter, int key) {
  return atomicAdd(counter + key, 1);
}

__device__ __forceinline__ int parts_of(int entries) {
  return entries <= kBucketSplit ? 1 : (entries + kBucketSplit - 1) / kBucketSplit;
}

// The wrapped rows of updates [base, base + kChunk) a thread owns, -1 for a
// dead or missing one: [-n_rows, 0) wraps to [0, n_rows), and the row is
// live if it then lies in [0, n_rows). A missing update (past n) reads as
// row n_rows, which no wrap brings into range.
__device__ __forceinline__ void bin_rows(const int* __restrict__ rows, int n, int n_rows,
                                         int base, int (&row)[kPerBin]) {
#pragma unroll
  for (int k = 0; k < kPerBin; ++k) {
    const int i = base + k * kBinThreads + (int)threadIdx.x;
    row[k] = i < n ? __ldg(rows + i) : n_rows;
  }
#pragma unroll
  for (int k = 0; k < kPerBin; ++k) {
    const int w = row[k] < 0 ? row[k] + n_rows : row[k];
    row[k] = (unsigned)w < (unsigned)n_rows ? w : -1;
  }
}

// Pass 1: the block's bucket histogram, stored as row blockIdx.x of
// counts (blocks, buckets), and each live update's rank among the block's
// updates of its bucket.
__global__ void __launch_bounds__(kBinThreads)
row_scatter_count(const int* __restrict__ rows, int n, int n_rows, int buckets,
                  int* __restrict__ counts, unsigned short* __restrict__ ranks) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < buckets; b += kBinThreads) hist[b] = 0;
  int row[kPerBin];
  bin_rows(rows, n, n_rows, blockIdx.x * kChunk, row);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPerBin; ++k) {
    if (row[k] >= 0) {
      const int i = blockIdx.x * kChunk + k * kBinThreads + (int)threadIdx.x;
      ranks[i] = (unsigned short)take_rank(hist, row[k] >> kSliceShift);
    }
  }
  __syncthreads();
  int* dst = counts + (size_t)blockIdx.x * buckets;
  for (int b = threadIdx.x; b < buckets; b += kBinThreads) dst[b] = hist[b];
}

// Pass 2: each column of counts scanned over the blocks. A block takes 32
// buckets, a warp a run of the count blocks' rows; prefix (blocks,
// buckets) holds each count block's start within its bucket, totals
// (buckets) each bucket's entries.
__global__ void __launch_bounds__(1024)
row_scatter_colscan(const int* __restrict__ counts, int blocks, int buckets,
                    int* __restrict__ prefix, int* __restrict__ totals) {
  __shared__ int run_sum[32][33];  // (row run, bucket)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane;
  const int per = (blocks + 31) / 32;
  const int k0 = min(warp * per, blocks);
  const int k1 = min(k0 + per, blocks);
  int sum = 0;
  if (b < buckets) {
    for (int k = k0; k < k1; ++k) sum += __ldg(counts + (size_t)k * buckets + b);
  }
  run_sum[warp][lane] = sum;
  __syncthreads();
  int run = 0;
  for (int w = 0; w < warp; ++w) run += run_sum[w][lane];
  if (b >= buckets) return;
  if (warp == 31) totals[b] = run + sum;
  for (int k = k0; k < k1; ++k) {
    const size_t at = (size_t)k * buckets + b;
    const int v = __ldg(counts + at);
    prefix[at] = run;
    run += v;
  }
}

// Pass 3: each bucket's offset in the list (a block scan of the totals);
// block 0 also lists the parts (first entry, end, bucket, split?) for
// pass 4. Then the block's live updates are sorted by bucket in shared
// memory (at the scan of the block's own row of counts plus pass 1's
// rank), and each update's index and its row within the slice written to
// the list, a bucket's run of them contiguous; then the slices of the
// split buckets zeroed.
__global__ void __launch_bounds__(kBinThreads)
row_scatter_place(const int* __restrict__ rows, int n, int n_rows, int buckets, int c,
                  const int* __restrict__ counts, const int* __restrict__ prefix,
                  const int* __restrict__ totals, const unsigned short* __restrict__ ranks,
                  int* __restrict__ entries, unsigned char* __restrict__ slots,
                  int4* __restrict__ parts, int* __restrict__ n_parts, float* __restrict__ out) {
  __shared__ typename BinScan::TempStorage tmp;
  extern __shared__ int4 place_smem[];
  int* first = reinterpret_cast<int*>(place_smem);  // (buckets): a bucket's first place in s_idx
  int* shift = first + buckets;  // (buckets): place in the list - place in s_idx
  int* s_idx = shift + buckets;  // (kChunk)
  unsigned short* s_bucket = reinterpret_cast<unsigned short*>(s_idx + kChunk);
  unsigned char* s_slot = reinterpret_cast<unsigned char*>(s_bucket + kChunk);
  int row[kPerBin];
  const int base = blockIdx.x * kChunk;
  bin_rows(rows, n, n_rows, base, row);
  const bool counted = blockIdx.x * kChunk < n;  // else a block with no row of counts
  const int* mine = counts + (size_t)blockIdx.x * buckets;
  const int* before = prefix + (size_t)blockIdx.x * buckets;
  const int per = (buckets + kBinThreads - 1) / kBinThreads;
  const int b0 = min((int)threadIdx.x * per, buckets);
  const int b1 = min(b0 + per, buckets);
  int live = 0, total = 0, n_part = 0;
  for (int b = b0; b < b1; ++b) {
    live += counted ? mine[b] : 0;
    total += totals[b];
    n_part += parts_of(totals[b]);
  }
  int live_at, n_live, entry_at;
  BinScan(tmp).ExclusiveSum(live, live_at, n_live);
  __syncthreads();
  BinScan(tmp).ExclusiveSum(total, entry_at);
  if (blockIdx.x == 0) {
    int part_at, all_parts;
    __syncthreads();
    BinScan(tmp).ExclusiveSum(n_part, part_at, all_parts);
    int e = entry_at;
    for (int b = b0; b < b1; ++b) {
      const int t = totals[b];
      for (int q = 0; q < parts_of(t); ++q) {
        const int e0 = e + q * kBucketSplit;
        parts[part_at + q] = make_int4(e0, min(e0 + kBucketSplit, e + t), b, t > kBucketSplit);
      }
      e += t;
      part_at += parts_of(t);
    }
    if (threadIdx.x == 0) *n_parts = all_parts;
  }
  for (int b = b0; b < b1; ++b) {
    first[b] = live_at;
    shift[b] = entry_at + (counted ? before[b] : 0) - live_at;
    live_at += counted ? mine[b] : 0;
    entry_at += totals[b];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPerBin; ++k) {
    if (row[k] >= 0) {
      const int bk = row[k] >> kSliceShift;
      const int i = base + k * kBinThreads + (int)threadIdx.x;
      const int j = first[bk] + ranks[i];
      s_idx[j] = i;
      s_bucket[j] = (unsigned short)bk;
      s_slot[j] = (unsigned char)(row[k] & (kSliceRows - 1));
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_live; j += kBinThreads) {
    const int at = shift[s_bucket[j]] + j;
    entries[at] = s_idx[j];
    slots[at] = s_slot[j];
  }
  const int groups = c / 4;
  for (int b = blockIdx.x; b < buckets; b += gridDim.x) {
    if (totals[b] <= kBucketSplit) continue;
    const int row0 = b * kSliceRows;
    const int n_here = min(kSliceRows, n_rows - row0);
    float4* dst = reinterpret_cast<float4*>(out + (size_t)row0 * c);
    for (int q = threadIdx.x; q < n_here * groups; q += kBinThreads) {
      dst[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

// One float4 reduction into global memory (REDG). The atomicAdd
// intrinsic compiles to an ATOMG that waits for the old value in a kernel
// with a __threadfence, as row_scatter_sum has.
__device__ __forceinline__ void red_add(float4* dst, const float4& v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(__cvta_generic_to_global(dst)),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// The sum of channels [4g, 4g + 4) of the update rows ids[0, len), in
// order, four loads in flight.
__device__ __forceinline__ float4 run_sum(const int* ids, int len, const float* __restrict__ upd,
                                          int c, int g) {
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int j = 0;
  for (; j + 4 <= len; j += 4) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = __ldg(reinterpret_cast<const float4*>(upd + (size_t)ids[j + u] * c) + g);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) add4(acc, v[u]);
  }
  for (; j < len; ++j) {
    add4(acc, __ldg(reinterpret_cast<const float4*>(upd + (size_t)ids[j] * c) + g));
  }
  return acc;
}

// Pass 4: a few blocks an SM walk the parts, one part at a time.
__global__ void __launch_bounds__(kSumThreads)
row_scatter_sum(const float* __restrict__ upd, float* __restrict__ out,
                const int* __restrict__ entries, const unsigned char* __restrict__ slots,
                const int4* __restrict__ parts, const int* __restrict__ n_parts, int n_rows,
                int c) {
  __shared__ int sorted[kBucketSplit];    // the part's update indices by row
  __shared__ int count[kSliceRows];       // entries a row
  __shared__ int start[kSliceRows];       // where a row's run starts in sorted
  __shared__ int piece_first[kSliceRows + 1];
  __shared__ unsigned char piece_row[kMaxPieces];
  const int lane = threadIdx.x & 31;
  const int groups = c / 4;
  const int all_parts = *n_parts;
  for (int pi = blockIdx.x; pi < all_parts; pi += gridDim.x) {
    const int4 part = parts[pi];  // (first entry, end, bucket, split)
    const bool split = part.w != 0;
    const int row0 = part.z * kSliceRows;
    const int n_here = min(kSliceRows, n_rows - row0);
    if (threadIdx.x < kSliceRows) count[threadIdx.x] = 0;

    // Rank each entry among its row's: (row in slice << 16 | rank).
    int idx[kPerSum];
    int rr[kPerSum];
#pragma unroll
    for (int k = 0; k < kPerSum; ++k) {
      const int e = part.x + k * kSumThreads + (int)threadIdx.x;
      idx[k] = e < part.y ? entries[e] : -1;
      rr[k] = e < part.y ? slots[e] : -1;
    }
    __syncthreads();
    unsigned key[kPerSum];
#pragma unroll
    for (int k = 0; k < kPerSum; ++k) {
      key[k] = rr[k] >= 0 ? (unsigned)rr[k] << 16 | (unsigned)take_rank(count, rr[k]) : ~0u;
    }
    __syncthreads();

    // Each row's start, and its pieces: every run of a split bucket, the
    // runs longer than kRunSplit of one that is not (one warp).
    if (threadIdx.x < 32) {
      constexpr int kPer = kSliceRows / 32;
      int n[kPer], pc[kPer], sum_n = 0, sum_pc = 0;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        n[q] = count[lane * kPer + q];
        pc[q] = (split || n[q] > kRunSplit) ? (n[q] + kRunSplit - 1) / kRunSplit : 0;
        sum_n += n[q];
        sum_pc += pc[q];
      }
      int incl_n = sum_n, incl_pc = sum_pc;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int vn = __shfl_up_sync(0xffffffffu, incl_n, d);
        const int vp = __shfl_up_sync(0xffffffffu, incl_pc, d);
        if (lane >= d) {
          incl_n += vn;
          incl_pc += vp;
        }
      }
      int at_n = incl_n - sum_n, at_pc = incl_pc - sum_pc;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        start[lane * kPer + q] = at_n;
        piece_first[lane * kPer + q] = at_pc;
        at_n += n[q];
        at_pc += pc[q];
      }
      if (lane == 31) piece_first[kSliceRows] = at_pc;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPerSum; ++k) {
      if (key[k] != ~0u) sorted[start[key[k] >> 16] + (key[k] & 0xffffu)] = idx[k];
    }
    if (threadIdx.x < kSliceRows) {
      for (int q = piece_first[threadIdx.x]; q < piece_first[threadIdx.x + 1]; ++q) {
        piece_row[q] = (unsigned char)threadIdx.x;
      }
    }
    __syncthreads();

    if (!split) {
      // Every row of the slice once: a run's sum, zeros for no update or a
      // run that its pieces add below.
      for (int t = threadIdx.x; t < n_here * groups; t += kSumThreads) {
        const int row = t / groups;
        const int g = t - row * groups;
        const int len = count[row];
        const float4 acc = len <= kRunSplit ? run_sum(sorted + start[row], len, upd, c, g)
                                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        reinterpret_cast<float4*>(out + (size_t)(row0 + row) * c)[g] = acc;
      }
    }
    const int pieces = piece_first[kSliceRows];
    if (pieces > 0) {
      if (!split) {
        __threadfence();  // the zeros are in memory before any piece adds into their rows
        __syncthreads();
      }
      for (int t = threadIdx.x; t < pieces * groups; t += kSumThreads) {
        const int p = t / groups;
        const int g = t - p * groups;
        const int row = piece_row[p];
        const int done = (p - piece_first[row]) * kRunSplit;
        const int len = min(kRunSplit, count[row] - done);
        const float4 acc = run_sum(sorted + start[row] + done, len, upd, c, g);
        red_add(reinterpret_cast<float4*>(out + (size_t)(row0 + row) * c) + g, acc);
      }
    }
    __syncthreads();  // the shared arrays are free for the next part
  }
}

// Blocks of pass 4 an SM holds, and the SMs of the current device.
int sum_grid(int max_parts) {
  static int sms[64] = {}, per_sm[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) dev = 63;
  if (sms[dev] == 0) {
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], row_scatter_sum, kSumThreads, 0);
  }
  const long long cap = (long long)sms[dev] * (per_sm[dev] > 0 ? per_sm[dev] : 1);
  return (int)(max_parts < cap ? max_parts : cap);
}

// The atomic route, for rows of at most 32 channels into a table that
// fits the L2 (the wrapper's rule): one thread a (row, 4-channel group)
// adds its update with one float4 reduction into the table, zeroed first.
// The updates stream from memory and the reductions stay in the L2, where
// the binned route would gather the updates as random 128-byte rows.
__global__ void row_scatter_atomic(const int* __restrict__ rows, const float* __restrict__ upd,
                                   float* __restrict__ out, long long n, int c, int n_rows) {
  const int groups = c / 4;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * groups) return;
  const long long i = t / groups;
  const int g = (int)(t % groups);
  int r = __ldg(rows + i);
  if (r < 0) r += n_rows;
  if ((unsigned)r >= (unsigned)n_rows) return;
  red_add(reinterpret_cast<float4*>(out + (size_t)r * c) + g,
          __ldg(reinterpret_cast<const float4*>(upd + i * c) + g));
}

}  // namespace

// rows (n,) i32; upd (n, C) f32; out (n_rows, C) f32, written whole;
// scratch holds scratch_ints i32 (ops/gather_scatter.scatter_scratch_ints),
// 16-byte aligned. C a multiple of 4, upd and out 16-byte aligned, n_rows
// at most kSliceRows * kMaxBuckets (checked by the Python wrapper).
// Returns the first cudaGetLastError() that is not cudaSuccess, checked
// after each launch, or cudaErrorInvalidValue for a scratch too small.
extern "C" int spi_row_scatter_add(const int* rows, const float* upd, float* out, int* scratch,
                                   long long scratch_ints, int n, int c, int n_rows,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int buckets = (n_rows + kSliceRows - 1) / kSliceRows;
  const int blocks = (n + kChunk - 1) / kChunk;
  const int max_parts = buckets + (n + kBucketSplit - 1) / kBucketSplit;
  if (n_rows <= 0 || buckets > kMaxBuckets) return (int)cudaErrorInvalidValue;
  int4* parts = reinterpret_cast<int4*>(scratch);
  int* counts = scratch + 4 * (size_t)max_parts;
  int* prefix = counts + (size_t)blocks * buckets;
  int* totals = prefix + (size_t)blocks * buckets;
  int* n_parts = totals + buckets;
  int* entries = n_parts + 1;
  unsigned char* slots = reinterpret_cast<unsigned char*>(entries + n);
  unsigned short* ranks = reinterpret_cast<unsigned short*>(entries + n + (n + 3) / 4);
  if ((long long)(entries + n + (n + 3) / 4 + (n + 1) / 2 - scratch) > scratch_ints) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t hist_bytes = sizeof(int) * (size_t)buckets;
  const size_t place_bytes = 2 * hist_bytes + (sizeof(int) + 3) * kChunk;
  cudaError_t err = cudaSuccess;
  if (hist_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(row_scatter_count, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)hist_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(row_scatter_place, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)place_bytes);
  if (err != cudaSuccess) return (int)err;
  if (blocks > 0) {
    row_scatter_count<<<blocks, kBinThreads, hist_bytes, s>>>(rows, n, n_rows, buckets, counts,
                                                              ranks);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  row_scatter_colscan<<<(buckets + 31) / 32, 1024, 0, s>>>(counts, blocks, buckets, prefix,
                                                           totals);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  row_scatter_place<<<blocks > 0 ? blocks : 1, kBinThreads, place_bytes, s>>>(
      rows, n, n_rows, buckets, c, counts, prefix, totals, ranks, entries, slots, parts, n_parts,
      out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  row_scatter_sum<<<sum_grid(max_parts), kSumThreads, 0, s>>>(upd, out, entries, slots, parts,
                                                              n_parts, n_rows, c);
  return (int)cudaGetLastError();
}

// The atomic route: zeroes out (n_rows, C) and adds upd (n, C) into it at
// the wrapped rows with one float4 reduction a (row, 4-channel group).
// Same inputs and checks as spi_row_scatter_add. Returns
// cudaGetLastError() after the launch.
extern "C" int spi_row_scatter_add_atomic(const int* rows, const float* upd, float* out, int n,
                                          int c, int n_rows, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n_rows * c, s);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)n * (c / 4);
  const unsigned blocks = (unsigned)((total + 255) / 256);
  if (blocks > 0) row_scatter_atomic<<<blocks, 256, 0, s>>>(rows, upd, out, n, c, n_rows);
  return (int)cudaGetLastError();
}
