// The two probe kernels of the port for Hopper (sm_90a): a random-row gather
// reduced to one number (T1) and the bilinear one-hot G build (T2).
//
//   gather_rows_sum  -- out = sum_g sum_r sum_c v[idx[g, r], c] in f32, for an
//       f32 or bf16 table v (R, C) and int32 indices idx (n, k), each in [0, R).
//       Replaces the TPU row-gather rate probe tools/bench_pallas_gather.py
//       (kernel :49, f32 table, pallas_call :57; kernel_b :82, bf16 table,
//       pallas_call :90). Its metric is the gather rate: gathered rows (and
//       bytes) per second, at the row widths the deformable-attention samplers
//       fetch per corner (C = 32 f32 is one head's D = 32 value row).
//   onehot_g  -- G[h, w, q] = sum_p a[p, q] * wy_p(h, q) * wx_p(w, q), where
//       wx_p(w, q) = (w == floor(x) ? 1 - dx : 0) + (w == floor(x) + 1 ? dx : 0)
//       for x = x[p, q], dx = x - floor(x), and wy the same in y. Replaces the
//       TPU probe tools/probe_bf16_g.py:_g_kernel (:35, pallas_call :68), the
//       standalone form of the one-hot operand that the TPU's v2 encoder
//       multiplies with a value footprint (gomatching_tpu/ops/deform_attn_vmem.py:
//       _accum_onehot_g).
//
// gather_rows_sum. The TPU probe keeps the whole table in VMEM; the counterpart
// here is shared memory (128 bytes a clock on each SM). The table (4 MB at the
// probe's largest case) does not fit one SM's 227 KB, so it is cut into slices of
// rows_per_slice rows (the wrapper's slice plan: the most rows whose bytes fit
// T1_SLICE_BYTES, a multiple of T1_SLICE_ALIGN_ROWS so that every slice starts on
// a 16-byte boundary), and the indices are sorted by slice first.
//   Pass A, a stable counting sort of the indices by slice (at most T1_MAX_SLICES),
//   deterministic: no atomic decides an order. Each block takes T1_SORT_WARPS *
//   T1_WARP_ELEMS consecutive indices, T1_WARP_ELEMS a warp. The count kernel counts
//   each warp's indices per slice with shared-memory atomics (sums: the order of the
//   additions does not matter) and writes each warp's first position within the
//   block's share of each slice, and the block's count per slice. One block scans the
//   (slice, block) counts, slice-major, into each block's first position in each
//   slice's bucket and the buckets' starts. The scatter kernel sorts its block's
//   indices in shared memory: lane x of a warp keeps the warp's next position in
//   slice x; each round of 32 indices takes one ballot per bit of the slice number,
//   from which each lane finds its peers (its place: their slice's position plus its
//   rank among them) and lane x the count of slice x. It then writes each slice's run
//   to its bucket, as rows within the slice, with coalesced stores. The slice number
//   comes from an f32 reciprocal, corrected to the exact quotient.
//   Pass B, the gather: one block of 1024 threads an SM takes a contiguous range
//   of the sorted positions (n_blocks equal ranges). For each slice its range
//   touches, thread 0 copies the slice into shared memory with one cp.async.bulk
//   completed on an mbarrier (a tail of less than 16 bytes, at the table's end,
//   by the threads), and the warps walk the range's positions 32 at a time (one
//   coalesced index load, the next group's prefetched). Each lane reads its own
//   row from shared memory in 16-byte chunks, starting at a chunk of its own
//   (lane % chunks, or for rows under 128 bytes its rank among the lanes whose rows
//   start in the same 128-byte bank line), so that the 32 lanes' loads spread over
//   the banks: a 128-byte row costs one wavefront, the shared-memory rate. Every
//   one of the n * k rows is read; nothing is counted instead of gathered.
//   Summation: each lane keeps 4 f32 accumulators; after T1_CHAIN additions to
//   each (flush_groups groups of 32 rows) the warp sums them (2 levels, then 5
//   shuffle levels) into a running warp total, in the warp's fixed order. The
//   block sums its 32 warp totals (5 levels) into one partial a block, and one
//   block sums the partials in a fixed order (gather_rows_sum_final_kernel). The
//   sort and the ranges depend only on the indices, so the result is the same
//   bits from run to run. The deepest chain of additions at the probe's shapes is
//   T1_CHAIN + 2 + 5 + (flushes a warp, <= 3) + 5 + 9 (the final pass) <= 152.
//   What bounds it on an H100: the function must read the table once and the
//   indices once (DRAM: (R*C*size + 4*n*k) bytes over 3.35 TB/s), but every
//   gathered row is read from on-chip memory, so the binding rate is shared
//   memory's: n*k*C*size bytes over 128 bytes a clock on each of 132 SMs. Beside
//   that, pass A reads the indices twice and writes them once, and each block copies
//   one or two slices (up to ~227 KB each) from L2: all blocks at once, ~30 MB, at
//   L2's aggregate rate (a cluster's blocks could share one copy by TMA multicast).
//   Built with -DT1_NO_SLICE_COPY (a measurement build, which the wrappers never load),
//   pass B gathers from shared memory that nothing copied: its time without the slice
//   copies (the sum is then meaningless). Built with -DT1_L2_GATHER (another), the same
//   entry runs the earlier form instead: warps walk the unsorted indices,
//   broadcast each row index with a shuffle and load the row from L1/L2 (per-block
//   partials in the scratch, then the final pass); that build also exports an empty
//   kernel (probe_empty), the launch floor.
//
// onehot_g. Each (p, q) has at most 4 nonzero terms, at (floor(y) + {0, 1},
// floor(x) + {0, 1}); the TPU's dense form evaluates all FH * FW cells. A block
// owns a tile of G: TH rows of h, G_TW of w and G_TQ of q (TH, the host's choice,
// the largest power of two up to G_MAX_TH that still gives the grid
// G_BLOCKS_WANTED blocks, or 1). It computes each (p, q)'s taps once (the tap
// values of x, and those of y times a) into shared memory, zeroes the tile there,
// and then thread (q, part) walks p in order and adds into its own column the taps
// whose w lies in the tile with (w - w0) % G_PARTS == part and whose h lies in the
// tile. Each term is computed by the ops _g_kernel uses, in its order: x0 = floor(x),
// dx = x - x0, the tap values 1 - dx and dx (and the same in y), yw *= a, term =
// yw * xw, acc += term. Every f32 op is an explicit _rn intrinsic, so no
// multiply-add is contracted; in the bf16 instantiation each op's f32 result is
// rounded to bf16 (__float2bfloat16_rn), which is what the plain version does op by
// op. The plain version adds the zero terms too; adding +0 to a sum of nonnegative
// terms changes nothing (the one difference is the sign of a zero where a < 0).
// After a barrier the tile goes out with 16-byte stores, q fastest: rows of G_TQ q,
// 256 bytes in f32 and 128 in bf16 (64-q rows: fewer, longer row writes than 32).
// What bounds it: the output bytes (FH*FW*Q * 4 or 2), x, y and a once; at the
// probe's shape (P=8, 32x32x256) that is 0.3 us, below a launch.
//
// Plain C interface, loaded with ctypes; every launch goes on the caller's stream
// and each function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define T1_SMEM_BYTES 232448       // a block's opt-in shared memory on sm_90 (227 KB)
#define T1_SLICE_BYTES 231424      // a slice's bytes at most: T1_SMEM_BYTES less 1 KB
#define T1_SLICE_ALIGN_ROWS 8      // rows a slice is a multiple of this
#define T1_MAX_SLICES 32           // slices at most: lane s of a pass-A warp keeps slice s
#define T1_SORT_WARPS 16           // warps a block of pass A
#define T1_WARP_ELEMS 512          // indices a warp of pass A (16 a lane)
#define T1_GATHER_THREADS 1024     // a block of pass B
#define T1_CHAIN 128               // additions to an accumulator before a flush
#define T1_ROW_BITS 17             // a row within its slice, in the scatter's packed entries
#define FINAL_THREADS 256          // the last pass: one block
#define G_TQ 64                    // onehot_g: q per tile (two warps' lanes)
#define G_TW 32                    // onehot_g: w per tile
#define G_MAX_TH 4                 // onehot_g: h per tile at most
#define G_THREADS 256              // onehot_g: G_TQ q by G_PARTS parts of the tile's w
#define G_PARTS (G_THREADS / G_TQ)
#define G_MAX_P 64                 // onehot_g: taps at most
#define G_BLOCKS_WANTED 264        // onehot_g: two blocks an SM on 132 SMs

#define FULL 0xffffffffu

static_assert(T1_SLICE_BYTES / 2 <= (1 << T1_ROW_BITS), "a 2-byte row's index fits T1_ROW_BITS");
static_assert(T1_MAX_SLICES <= (1 << (31 - T1_ROW_BITS)), "a slice number fits the rest");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Sum over the block (blockDim.x a multiple of 32, at most 1024); the result is
// valid in thread 0.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float part[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = warp_sum(x);
  if (lane == 0) part[warp] = x;
  __syncthreads();
  x = 0.f;
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    x = warp_sum(lane < n_warps ? part[lane] : 0.f);
  }
  return x;
}

// The last pass, one block: out[0] = the partials' sum, in a fixed order.
__global__ void gather_rows_sum_final_kernel(const float* __restrict__ partials, int n,
                                             float* __restrict__ out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

// Blocks of pass A for n_rows indices (gather_probe.scratch_sizes mirrors it).
static int sort_blocks(int64_t n_rows) {
  const int64_t per = (int64_t)T1_SORT_WARPS * T1_WARP_ELEMS;
  return n_rows > 0 ? (int)((n_rows + per - 1) / per) : 1;
}

#ifndef T1_L2_GATHER

// ---------------------------------------------------------------------------
// T1, pass A: the stable counting sort of the indices by slice
// ---------------------------------------------------------------------------

// The lanes of `valid` whose `key` (< 2^bits) equals this lane's: one ballot per bit.
// Every lane of the warp calls it.
__device__ __forceinline__ unsigned peers_of(int key, int bits, unsigned valid) {
  unsigned peers = valid;
  for (int k = 0; k < bits; ++k) {
    const bool set = (key >> k) & 1;
    const unsigned m = __ballot_sync(FULL, set);
    peers &= set ? m : ~m;
  }
  return peers;
}

// r / rps for 0 <= r < 1024 * rps, from the f32 reciprocal inv = 1 / rps: its quotient
// is within 1 of the true one (r and the product each round by 2^-24 of a quotient
// below 1024), and one step each way makes it exact.
__device__ __forceinline__ int slice_of(int r, int rps, float inv) {
  int s = __float2int_rz(__int2float_rn(r) * inv);
  s -= s * rps > r;
  s += (s + 1) * rps <= r;
  return s;
}

// This lane's T1_WARP_ELEMS / 32 indices of the warp's run, e0 the run's first.
__device__ __forceinline__ void load_run(const int* __restrict__ idx, int64_t n, int64_t e0,
                                         int lane, int (&r)[T1_WARP_ELEMS / 32]) {
#pragma unroll
  for (int j = 0; j < T1_WARP_ELEMS / 32; ++j) {
    const int64_t e = e0 + 32 * j + lane;
    r[j] = e < n ? __ldg(idx + e) : 0;
  }
}

// wpre (blocks, T1_SORT_WARPS, n_slices): each warp's first position within its block's
// share of each slice (the counts of the block's earlier warps); counts (n_slices,
// blocks): each block's count per slice. The counts are sums, so shared-memory atomics
// order nothing that matters.
__global__ void __launch_bounds__(32 * T1_SORT_WARPS, 2)
    gather_rows_sum_count_kernel(const int* __restrict__ idx, int64_t n, int rps, int n_slices,
                                 int* __restrict__ wpre, int* __restrict__ counts) {
  __shared__ int cnt[T1_SORT_WARPS * T1_MAX_SLICES];  // (T1_SORT_WARPS, n_slices)
  const float inv = 1.f / (float)rps;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < T1_SORT_WARPS * n_slices; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const int64_t e0 = ((int64_t)blockIdx.x * T1_SORT_WARPS + w) * T1_WARP_ELEMS;
  int r[T1_WARP_ELEMS / 32];
  load_run(idx, n, e0, lane, r);
#pragma unroll
  for (int j = 0; j < T1_WARP_ELEMS / 32; ++j)
    if (e0 + 32 * j + lane < n) atomicAdd(&cnt[w * n_slices + slice_of(r[j], rps, inv)], 1);
  __syncthreads();
  const int b = blockIdx.x;
  for (int s = threadIdx.x; s < n_slices; s += blockDim.x) {
    int total = 0;
    for (int ww = 0; ww < T1_SORT_WARPS; ++ww) {
      wpre[((int64_t)b * T1_SORT_WARPS + ww) * n_slices + s] = total;
      total += cnt[ww * n_slices + s];
    }
    counts[(int64_t)s * gridDim.x + b] = total;
  }
}

// One block: counts (m = n_slices * blocks entries, slice-major) -> their exclusive
// scan in place, counts[m] = the total; bstart[s] = the first position of slice s's
// bucket, bstart[n_slices] = the total.
__global__ void __launch_bounds__(1024)
    gather_rows_sum_scan_kernel(int* __restrict__ counts, int m, int blocks, int n_slices,
                                int* __restrict__ bstart) {
  __shared__ int wsum[32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int per = (m + blockDim.x - 1) / blockDim.x;
  const int i0 = min(m, t * per);
  const int i1 = min(m, i0 + per);
  int sum = 0;
#pragma unroll 4
  for (int i = i0; i < i1; ++i) sum += counts[i];
  int x = sum;  // inclusive scan over the block
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[w] = x;
  __syncthreads();
  if (w == 0) {
    int y = lane < (int)(blockDim.x >> 5) ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(FULL, y, o);
      if (lane >= o) y += z;
    }
    wsum[lane] = y;
  }
  __syncthreads();
  int run = x - sum + (w > 0 ? wsum[w - 1] : 0);
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const int c = counts[i];
    counts[i] = run;
    run += c;
  }
  if (t == (int)blockDim.x - 1) counts[m] = run;
  __syncthreads();
  for (int s = t; s <= n_slices; s += blockDim.x)
    bstart[s] = counts[s < n_slices ? (int64_t)s * blocks : m];
}

// bucket[pos] = the row within its slice of each index, sorted by slice, stably. The
// block first sorts its T1_SORT_WARPS * T1_WARP_ELEMS indices in shared memory, then
// writes each slice's run to the slice's bucket with coalesced stores. In a warp, lane x
// keeps the warp's next local position in slice x. Each round of 32 indices takes one
// ballot per bit of the slice number (`bits` of them); from those ballots every lane
// finds its peers (the lanes of its slice: its place is lane x = s's position plus its
// rank among them) and lane x the count of slice x (its position's step).
__global__ void __launch_bounds__(32 * T1_SORT_WARPS, 2)
    gather_rows_sum_scatter_kernel(const int* __restrict__ idx, int64_t n, int rps, int n_slices,
                                   int bits, const int* __restrict__ wpre,
                                   const int* __restrict__ scan, int* __restrict__ bucket) {
  __shared__ int lstart[T1_MAX_SLICES];  // the slice's local start
  __shared__ int shift[T1_MAX_SLICES];   // global position - local
  __shared__ int loc[T1_SORT_WARPS * T1_WARP_ELEMS];  // the block's indices, sorted: (s, row)
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int NB = gridDim.x;
  const float inv = 1.f / (float)rps;
  const int64_t e0 = ((int64_t)b * T1_SORT_WARPS + w) * T1_WARP_ELEMS;
  int r[T1_WARP_ELEMS / 32];
  load_run(idx, n, e0, lane, r);
  if (w == 0) {  // the block's share of each slice from the scan, scanned over the slices
    const int64_t at = (int64_t)lane * NB + b;
    const int c = lane < n_slices ? scan[at + 1] - scan[at] : 0;
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane < n_slices) {
      lstart[lane] = x - c;
      shift[lane] = scan[at] - (x - c);
    }
  }
  __syncthreads();
  int next = lane < n_slices ? lstart[lane] + wpre[((int64_t)b * T1_SORT_WARPS + w) * n_slices + lane] : 0;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < T1_WARP_ELEMS / 32; ++j) {
    const bool ok = e0 + 32 * j + lane < n;
    const unsigned valid = __ballot_sync(FULL, ok);
    if (valid == 0) break;
    const int s = slice_of(r[j], rps, inv);
    unsigned peers = valid;  // the lanes of slice s
    unsigned mine = valid;   // the lanes of slice `lane`
    for (int k = 0; k < bits; ++k) {
      const unsigned m = __ballot_sync(FULL, (s >> k) & 1);
      peers &= (s >> k) & 1 ? m : ~m;
      mine &= (lane >> k) & 1 ? m : ~m;
    }
    const int at = __shfl_sync(FULL, next, s);
    if (ok) loc[at + __popc(peers & below)] = (s << T1_ROW_BITS) | (r[j] - s * rps);
    next += __popc(mine);
  }
  __syncthreads();
  const int64_t first = (int64_t)b * T1_SORT_WARPS * T1_WARP_ELEMS;
  const int count = (int)min((int64_t)T1_SORT_WARPS * T1_WARP_ELEMS, n - first);
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int e = loc[i];
    bucket[shift[e >> T1_ROW_BITS] + i] = e & ((1 << T1_ROW_BITS) - 1);
  }
}

// ---------------------------------------------------------------------------
// T1, pass B: slices in shared memory, every sorted row gathered from there
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// acc += the 4 f32 (or 8 bf16, two to each) of one 16-byte chunk.
template <typename T>
__device__ __forceinline__ void add_chunk(const uint4 t, float (&acc)[4]) {
  if constexpr (sizeof(T) == 4) {
    acc[0] += __uint_as_float(t.x);
    acc[1] += __uint_as_float(t.y);
    acc[2] += __uint_as_float(t.z);
    acc[3] += __uint_as_float(t.w);
  } else {
    const uint32_t u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[k]));
      acc[(2 * k) & 3] += f.x;
      acc[(2 * k + 1) & 3] += f.y;
    }
  }
}

// Add row r of the slice to this lane's accumulators. V > 0: rows of V 16-byte
// chunks; V == 0: rows of `chunks` 16-byte chunks; V == -1: any row, element by
// element. `first` is this lane's first chunk (element for V == -1).
template <typename T, int V>
__device__ __forceinline__ void add_row(const unsigned char* slice, int r, int C, int row_bytes,
                                        int chunks, int first, float (&acc)[4]) {
  const unsigned char* row = slice + (int64_t)r * row_bytes;
  if constexpr (V == -1) {
    const T* e = reinterpret_cast<const T*>(row);
    int c = first;
    for (int k = 0; k < C; ++k) {
      acc[k & 3] += to_f32(e[c]);
      c = c + 1 == C ? 0 : c + 1;
    }
  } else {
    const uint4* q = reinterpret_cast<const uint4*>(row);
    const int n = V > 0 ? V : chunks;
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      int c = first + k;
      if (c >= n) c -= n;
      add_chunk<T>(q[c], acc);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(T1_GATHER_THREADS, 1)
    gather_rows_sum_slices_kernel(const T* __restrict__ v, int R, int C, int rps, int n_slices,
                                  const int* __restrict__ bucket, const int* __restrict__ bstart,
                                  int64_t n, float* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char slice[];
  __shared__ uint64_t bar;
  __shared__ float wtotal[T1_GATHER_THREADS / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int64_t p0 = (int64_t)blockIdx.x * n / gridDim.x;
  const int64_t p1 = (int64_t)(blockIdx.x + 1) * n / gridDim.x;
  const int row_bytes = C * (int)sizeof(T);
  const int chunks = row_bytes / 16;
  const int per_row = (C + 3) / 4;  // additions to each accumulator a row
  const int flush_groups = per_row >= T1_CHAIN ? 1 : T1_CHAIN / per_row;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the slice holding p0: the last s with bstart[s] <= p0 (that bucket is not empty)
  int s = 0;
  for (int hi = n_slices - 1; s < hi;) {
    const int mid = (s + hi + 1) >> 1;
    if (__ldg(bstart + mid) <= p0) s = mid; else hi = mid - 1;
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float total = 0.f;  // the warp's flushed sums, in its order
  int groups = 0;     // groups of 32 rows since the last flush (uniform in the warp)
  uint32_t phase = 0;
  for (int64_t p = p0; p < p1; ++s) {
    const int64_t end = min(p1, (int64_t)__ldg(bstart + s + 1));
    if (end <= p) continue;  // an empty bucket
    const int row0 = s * rps;
    const uint32_t bytes = (uint32_t)min(rps, R - row0) * (uint32_t)row_bytes;
    const uint32_t bulk = bytes & ~15u;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(v) + (int64_t)row0 * row_bytes;
    __syncthreads();  // every warp is done with the previous slice (and bar is set up)
#ifndef T1_NO_SLICE_COPY
    if (tid == 0 && bulk > 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(&bar)),
                   "r"(bulk)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          ::"r"(smem_addr(slice)), "l"(src), "r"(bulk), "r"(smem_addr(&bar))
          : "memory");
    }
    for (uint32_t i = bulk + 2 * tid; i < bytes; i += 2 * T1_GATHER_THREADS)
      *reinterpret_cast<uint16_t*>(slice + i) = *reinterpret_cast<const uint16_t*>(src + i);
    if (bulk > 0) {
      // a copy that never completes traps after 2^37 SM cycles (~70 s at 1.98 GHz)
      // instead of holding the card
      const long long t0 = clock64();
      while (!mbar_try_wait(&bar, phase))
        if (clock64() - t0 > (1ll << 37)) __trap();
      phase ^= 1u;
    }
    if (bulk != bytes) __syncthreads();  // the tail's bytes
#endif
    int64_t g = p + 32 * w + lane;
    int r = g < end ? __ldg(bucket + g) : -1;
    for (; g - lane < end; g += T1_GATHER_THREADS) {
      const int64_t gn = g + T1_GATHER_THREADS;
      const int rn = gn < end ? __ldg(bucket + gn) : -1;
      const unsigned live = __ballot_sync(FULL, r >= 0);
      int first;
      if constexpr (V == -1) {
        first = lane % C;
      } else if (row_bytes % 128 == 0) {
        first = lane % chunks;
      } else {
        // rows under (or not a multiple of) 128 bytes: spread the lanes whose rows start
        // at the same 16-byte bank group over the chunks
        const unsigned same = peers_of((int)(((int64_t)r * chunks) & 7), 3, live);
        first = __popc(same & ((1u << lane) - 1u)) % chunks;
      }
      if (r >= 0) add_row<T, V>(slice, r, C, row_bytes, chunks, first, acc);
      if (++groups == flush_groups) {
        total += warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
        acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
        groups = 0;
      }
      r = rn;
    }
    p = end;
  }
  if (groups > 0) total += warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
  if (lane == 0) wtotal[w] = total;
  __syncthreads();
  if (w == 0) {
    const float x = warp_sum(wtotal[lane]);
    if (lane == 0) partials[blockIdx.x] = x;
  }
}

template <typename T, int V>
static int launch_slices(const T* v, int R, int C, int rps, int n_slices, const int* bucket,
                         const int* bstart, int64_t n, float* partials, int n_blocks,
                         cudaStream_t s) {
  const int smem = (min(rps, R) * C * (int)sizeof(T) + 15) & ~15;
  cudaError_t e = cudaFuncSetAttribute(gather_rows_sum_slices_kernel<T, V>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  gather_rows_sum_slices_kernel<T, V><<<n_blocks, T1_GATHER_THREADS, smem, s>>>(
      v, R, C, rps, n_slices, bucket, bstart, n, partials);
  return (int)cudaGetLastError();
}

// Pass B's instantiation for the table's rows: element by element unless a row is a
// whole number of 16-byte chunks; a fixed count of chunks (V0) for the probe's 32-wide
// rows, a count read at run time for any other.
template <typename T, int V0>
static int launch_gather(const T* v, int R, int C, int rps, int n_slices, const int* bucket,
                         const int* bstart, int64_t n, float* partials, int n_blocks,
                         cudaStream_t s) {
  const int row_bytes = C * (int)sizeof(T);
  if (row_bytes % 16 != 0)
    return launch_slices<T, -1>(v, R, C, rps, n_slices, bucket, bstart, n, partials, n_blocks, s);
  if (row_bytes / 16 == V0)
    return launch_slices<T, V0>(v, R, C, rps, n_slices, bucket, bstart, n, partials, n_blocks, s);
  return launch_slices<T, 0>(v, R, C, rps, n_slices, bucket, bstart, n, partials, n_blocks, s);
}

#else  // T1_L2_GATHER: the earlier form, a measurement build

#define GATHER_WARPS 8          // warps per block of the first pass
#define GATHER_MAX_BLOCKS 1024  // the first pass's grid is at most this wide

// Add this lane's share of one table row to acc. VEC > 0: each lane loads VEC
// consecutive elements at lane * VEC (C == 32 * VEC, the row start aligned to
// VEC elements); VEC == 0: any C, lanes stride the row by 32.
template <typename T, int VEC>
__device__ __forceinline__ void add_row_l2(const T* __restrict__ row, int C, int lane, float& acc) {
  if constexpr (VEC == 0) {
    for (int c = lane; c < C; c += 32) acc += to_f32(row[c]);
  } else if constexpr (VEC == 1) {
    acc += to_f32(__ldg(row + lane));
  } else if constexpr (sizeof(T) == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(row) + lane);
    acc += t.x;
    acc += t.y;
    acc += t.z;
    acc += t.w;
  } else {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(row) + lane);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    acc += lo.x;
    acc += lo.y;
    acc += hi.x;
    acc += hi.y;
  }
}

// partials[blockIdx.x] = this block's share of the sum: a warp takes runs of 32
// gathered rows, lane l loads index l, and the warp walks the run's rows with the
// index broadcast by a shuffle, one coalesced row load a lane each.
template <typename T, int VEC>
__global__ void gather_rows_sum_kernel(const T* __restrict__ v, const int* __restrict__ idx,
                                       int64_t n_rows, int C, float* __restrict__ partials) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t n_chunks = (n_rows + 31) >> 5;
  float acc = 0.f;
  for (int64_t chunk = warp; chunk < n_chunks; chunk += n_warps) {
    const int64_t r0 = chunk << 5;
    const int64_t left = n_rows - r0;
    const int cnt = left < 32 ? (int)left : 32;
    const int mine = lane < cnt ? __ldg(idx + r0 + lane) : 0;
    if (cnt == 32) {
#pragma unroll 8  // row loads a warp keeps in flight
      for (int j = 0; j < 32; ++j) {
        const int r = __shfl_sync(FULL, mine, j);
        add_row_l2<T, VEC>(v + (int64_t)r * C, C, lane, acc);
      }
    } else {
      for (int j = 0; j < cnt; ++j) {
        const int r = __shfl_sync(FULL, mine, j);
        add_row_l2<T, VEC>(v + (int64_t)r * C, C, lane, acc);
      }
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

static int l2_blocks(int64_t n_rows) {
  const int64_t chunks = (n_rows + 31) / 32;
  const int64_t blocks = (chunks + GATHER_WARPS - 1) / GATHER_WARPS;
  return (int)(blocks < GATHER_MAX_BLOCKS ? (blocks > 0 ? blocks : 1) : GATHER_MAX_BLOCKS);
}

template <typename T>
static int launch_l2(const T* v, const int* idx, int64_t n_rows, int C, float* partials,
                     int blocks, cudaStream_t s) {
  const int threads = 32 * GATHER_WARPS;
  const int vec_bytes = 4 * (int)sizeof(T);
  if (C == 32)
    gather_rows_sum_kernel<T, 1><<<blocks, threads, 0, s>>>(v, idx, n_rows, C, partials);
  else if (C == 128 && (uintptr_t)v % vec_bytes == 0)
    gather_rows_sum_kernel<T, 4><<<blocks, threads, 0, s>>>(v, idx, n_rows, C, partials);
  else
    gather_rows_sum_kernel<T, 0><<<blocks, threads, 0, s>>>(v, idx, n_rows, C, partials);
  return (int)cudaGetLastError();
}

__global__ void probe_empty_kernel() {}

// The launch floor: one empty block.
extern "C" int probe_empty(void* stream) {
  probe_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

#endif  // T1_L2_GATHER

// Int32 words of each piece of gather_rows_sum's scratch, in its order: the sorted
// rows (n_rows), the per-warp counts, the per-block counts and their scan, the
// buckets' starts, and the f32 partials of pass B (n_blocks).
extern "C" int gather_rows_sum_scratch(int64_t n_rows, int n_slices, int n_blocks,
                                       int64_t* sizes) {
  if (n_rows < 0 || n_slices < 1 || n_slices > T1_MAX_SLICES || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = sort_blocks(n_rows);
  sizes[0] = n_rows;
  sizes[1] = blocks * T1_SORT_WARPS * n_slices;
  sizes[2] = (int64_t)n_slices * blocks + 1;
  sizes[3] = n_slices + 1;
  sizes[4] = n_blocks;
  return (int)cudaSuccess;
}

// v (R, C) f32 (bf16 = 0) or bf16 (bf16 = 1), 16-byte aligned; idx (n_rows,) int32 in
// [0, R); scratch as gather_rows_sum_scratch sizes it for (n_rows, n_slices, n_blocks);
// out (1,) f32. The slice plan: rows_per_slice a multiple of T1_SLICE_ALIGN_ROWS whose
// bytes fit T1_SLICE_BYTES, n_slices = ceil(R / rows_per_slice); n_blocks blocks in
// pass B (one an SM).
extern "C" int gather_rows_sum(const void* v, const int* idx, int* scratch, float* out,
                               int64_t n_rows, int R, int C, int bf16, int rows_per_slice,
                               int n_slices, int n_blocks, void* stream) {
  const int64_t row_bytes = (int64_t)C * (bf16 ? 2 : 4);
  if (C < 1 || R < 1 || n_rows < 0 || n_rows > INT32_MAX || n_blocks < 1 ||
      rows_per_slice < T1_SLICE_ALIGN_ROWS || rows_per_slice % T1_SLICE_ALIGN_ROWS != 0 ||
      rows_per_slice * row_bytes > T1_SLICE_BYTES || n_slices > T1_MAX_SLICES ||
      n_slices != (int)(((int64_t)R + rows_per_slice - 1) / rows_per_slice) ||
      (uintptr_t)v % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = sort_blocks(n_rows);
  int* bucket = scratch;
  int* wpre = bucket + n_rows;
  int* counts = wpre + (int64_t)blocks * T1_SORT_WARPS * n_slices;
  int* bstart = counts + (int64_t)n_slices * blocks + 1;
  float* partials = reinterpret_cast<float*>(bstart + n_slices + 1);
  int rc = (int)cudaSuccess;
#ifndef T1_L2_GATHER
  if (n_rows > 0) {
    int bits = 0;  // of a slice number
    while ((1 << bits) < n_slices) ++bits;
    gather_rows_sum_count_kernel<<<blocks, 32 * T1_SORT_WARPS, 0, s>>>(
        idx, n_rows, rows_per_slice, n_slices, wpre, counts);
    gather_rows_sum_scan_kernel<<<1, 1024, 0, s>>>(counts, n_slices * blocks, blocks, n_slices,
                                                   bstart);
    gather_rows_sum_scatter_kernel<<<blocks, 32 * T1_SORT_WARPS, 0, s>>>(
        idx, n_rows, rows_per_slice, n_slices, bits, wpre, counts, bucket);
    rc = (int)cudaGetLastError();
    if (rc != (int)cudaSuccess) return rc;
    if (bf16)
      rc = launch_gather<__nv_bfloat16, 4>(static_cast<const __nv_bfloat16*>(v), R, C,
                                               rows_per_slice, n_slices, bucket, bstart, n_rows,
                                               partials, n_blocks, s);
    else
      rc = launch_gather<float, 8>(static_cast<const float*>(v), R, C, rows_per_slice,
                                       n_slices, bucket, bstart, n_rows, partials, n_blocks, s);
  } else {
    n_blocks = 0;  // the sum of nothing
  }
#else
  // the earlier form's partials (at most one a 256 rows, at least one) fit the scratch,
  // whose sorted-rows piece alone holds n_rows words and its partials n_blocks >= 1
  partials = reinterpret_cast<float*>(scratch);
  n_blocks = l2_blocks(n_rows);
  if (bf16)
    rc = launch_l2(static_cast<const __nv_bfloat16*>(v), idx, n_rows, C, partials, n_blocks, s);
  else
    rc = launch_l2(static_cast<const float*>(v), idx, n_rows, C, partials, n_blocks, s);
#endif
  if (rc != (int)cudaSuccess) return rc;
  gather_rows_sum_final_kernel<<<1, FINAL_THREADS, 0, s>>>(partials, n_blocks, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// T2
// ---------------------------------------------------------------------------

// f32 op results, rounded to bf16 in the bf16 instantiation.
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// 16 bytes of the tile row at t (4 f32 or 8 bf16) to out.
__device__ __forceinline__ void store16(float* out, const float* t) {
  *reinterpret_cast<float4*>(out) = *reinterpret_cast<const float4*>(t);
}
__device__ __forceinline__ void store16(__nv_bfloat16* out, const float* t) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(t[2 * k], t[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(out) = u;
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// One (p, q)'s taps relative to the tile: the first column and row (x0 - w0, y0 - h0),
// the x tap values (1 - dx, dx) and the y tap values times a.
struct GTaps {
  int wl, hl;
  float xw0, xw1, ya0, ya1;
};

// x, y, a (P, Q) f32; out (FH, FW, Q). Block = the tile q in [blockIdx.x * G_TQ, +G_TQ),
// w in [blockIdx.y * G_TW, +G_TW), h in [blockIdx.z * TH, +TH); `vec`: Q and out allow
// 16-byte stores.
template <bool BF16, typename Out>
__global__ void __launch_bounds__(G_THREADS)
    onehot_g_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ a, Out* __restrict__ out, int P, int FH, int FW,
                    int Q, int TH, int vec) {
  extern __shared__ __align__(16) float sm[];
  float* tile = sm;                                                 // (TH, G_TW, G_TQ)
  GTaps* taps = reinterpret_cast<GTaps*>(tile + TH * G_TW * G_TQ);  // (P, G_TQ)
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * G_TQ;
  const int w0 = blockIdx.y * G_TW;
  const int h0 = blockIdx.z * TH;
  // each (p, q)'s taps once, by _g_kernel's ops in its order
  for (int i = tid; i < P * G_TQ; i += G_THREADS) {
    const int q = q0 + i % G_TQ;
    const int64_t at = (int64_t)(i / G_TQ) * Q + q;
    const bool ok = q < Q;
    const float xv = rnd<BF16>(ok ? __ldg(x + at) : 0.f);
    const float yv = rnd<BF16>(ok ? __ldg(y + at) : 0.f);
    const float av = rnd<BF16>(ok ? __ldg(a + at) : 0.f);
    const float x0 = floorf(xv);
    const float y0 = floorf(yv);
    const float dx = rnd<BF16>(__fsub_rn(xv, x0));
    const float dy = rnd<BF16>(__fsub_rn(yv, y0));
    GTaps t;
    t.wl = (int)x0 - w0;
    t.hl = (int)y0 - h0;
    t.xw0 = rnd<BF16>(__fsub_rn(1.f, dx));
    t.xw1 = dx;
    t.ya0 = rnd<BF16>(__fmul_rn(rnd<BF16>(__fsub_rn(1.f, dy)), av));
    t.ya1 = rnd<BF16>(__fmul_rn(dy, av));
    taps[i] = t;
  }
  for (int i = tid; i < TH * G_TW * G_TQ / 4; i += G_THREADS)
    reinterpret_cast<float4*>(tile)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // thread (q, part) adds, for p in order, the terms of the cells of its column q whose
  // w - w0 is part modulo G_PARTS: at most one x tap of each p, times its two y taps
  const int qq = tid % G_TQ;
  const int part = tid / G_TQ;
  for (int p = 0; p < P; ++p) {
    const GTaps& t = taps[p * G_TQ + qq];
    const int wl = t.wl;
    int wt;
    float xw;
    if ((wl & (G_PARTS - 1)) == part) {
      wt = wl;
      xw = t.xw0;
    } else if (((wl + 1) & (G_PARTS - 1)) == part) {
      wt = wl + 1;
      xw = t.xw1;
    } else {
      continue;
    }
    if (wt < 0 || wt >= G_TW || w0 + wt >= FW) continue;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int ht = t.hl + k;
      if (ht < 0 || ht >= TH || h0 + ht >= FH) continue;
      const float term = rnd<BF16>(__fmul_rn(k == 0 ? t.ya0 : t.ya1, xw));
      float* cell = tile + (ht * G_TW + wt) * G_TQ + qq;
      *cell = rnd<BF16>(__fadd_rn(*cell, term));
    }
  }
  __syncthreads();

  constexpr int PER = 16 / sizeof(Out);  // q a 16-byte store
  const int qn = min(G_TQ, Q - q0);
  const bool full = vec && qn == G_TQ;
  for (int i = tid; i < TH * G_TW * (G_TQ / PER); i += G_THREADS) {
    const int row = i / (G_TQ / PER);
    const int qs = (i % (G_TQ / PER)) * PER;
    const int h = h0 + row / G_TW;
    const int w = w0 + row % G_TW;
    if (h >= FH || w >= FW) continue;
    Out* o = out + ((int64_t)h * FW + w) * Q + q0 + qs;
    const float* t = tile + row * G_TQ + qs;
    if (full) {
      store16(o, t);
    } else {
      for (int k = 0; k < PER && qs + k < qn; ++k) store1(o + k, t[k]);
    }
  }
}

// h rows a tile: the largest power of two up to G_MAX_TH that still gives the grid
// G_BLOCKS_WANTED blocks, else 1 (and no more than FH).
static int g_tile_h(int FH, int FW, int Q) {
  const int64_t base = (int64_t)((Q + G_TQ - 1) / G_TQ) * ((FW + G_TW - 1) / G_TW);
  int th = G_MAX_TH;
  while (th > 1 && base * ((FH + th - 1) / th) < G_BLOCKS_WANTED) th >>= 1;
  return th < FH ? th : FH;
}

template <bool BF16, typename Out>
static int launch_onehot(const float* x, const float* y, const float* a, Out* out, int P, int FH,
                         int FW, int Q, cudaStream_t s) {
  const int th = g_tile_h(FH, FW, Q);
  const dim3 grid((Q + G_TQ - 1) / G_TQ, (FW + G_TW - 1) / G_TW, (FH + th - 1) / th);
  const int smem = th * G_TW * G_TQ * (int)sizeof(float) + P * G_TQ * (int)sizeof(GTaps);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(onehot_g_kernel<BF16, Out>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = Q % (16 / (int)sizeof(Out)) == 0 && (uintptr_t)out % 16 == 0;
  onehot_g_kernel<BF16, Out><<<grid, G_THREADS, smem, s>>>(x, y, a, out, P, FH, FW, Q, th, vec);
  return (int)cudaGetLastError();
}

// compute_bf16 / out_bf16: (0, 0) f32 arithmetic, f32 out; (1, 1) bf16 arithmetic,
// bf16 out; (0, 1) f32 arithmetic, bf16 out.
extern "C" int onehot_g(const float* x, const float* y, const float* a, void* out, int P, int FH,
                        int FW, int Q, int compute_bf16, int out_bf16, void* stream) {
  if (P < 1 || P > G_MAX_P || FH < 0 || FW < 0 || Q < 0 || (compute_bf16 && !out_bf16))
    return (int)cudaErrorInvalidValue;
  if (FH == 0 || FW == 0 || Q == 0) return (int)cudaSuccess;
  if ((FW + G_TW - 1) / G_TW > 65535 || FH > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!out_bf16)
    return launch_onehot<false>(x, y, a, static_cast<float*>(out), P, FH, FW, Q, s);
  if (compute_bf16)
    return launch_onehot<true>(x, y, a, static_cast<__nv_bfloat16*>(out), P, FH, FW, Q, s);
  return launch_onehot<false>(x, y, a, static_cast<__nv_bfloat16*>(out), P, FH, FW, Q, s);
}

// What the runtime made of a kernel: info[0] registers a thread, info[1] local memory a
// thread in bytes (stack and spills), info[2] static shared memory a block in bytes. which:
// 0-2 T1's count, scan and scatter kernels, 3-5 its gather for (f32, C = 32), (f32, any
// other C of whole 16-byte chunks, such as 128), (bf16, C = 32), 6 its last pass, 7-9 onehot_g (f32 / f32, bf16 / bf16, f32 /
// bf16); in the T1_L2_GATHER build 3-5 are the earlier form's (C = 32 f32, C = 128 f32,
// C = 32 bf16) and 0-2 do not exist.
extern "C" int probes_kernel_info(int which, int* info) {
  const void* fns[] = {
#ifndef T1_L2_GATHER
      (const void*)gather_rows_sum_count_kernel,
      (const void*)gather_rows_sum_scan_kernel,
      (const void*)gather_rows_sum_scatter_kernel,
      (const void*)gather_rows_sum_slices_kernel<float, 8>,
      (const void*)gather_rows_sum_slices_kernel<float, 0>,
      (const void*)gather_rows_sum_slices_kernel<__nv_bfloat16, 4>,
#else
      nullptr, nullptr, nullptr,
      (const void*)gather_rows_sum_kernel<float, 1>,
      (const void*)gather_rows_sum_kernel<float, 4>,
      (const void*)gather_rows_sum_kernel<__nv_bfloat16, 1>,
#endif
      (const void*)gather_rows_sum_final_kernel,
      (const void*)onehot_g_kernel<false, float>,
      (const void*)onehot_g_kernel<true, __nv_bfloat16>,
      (const void*)onehot_g_kernel<false, __nv_bfloat16>};
  if (which < 0 || which > 9 || fns[which] == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, fns[which]);
  if (e != cudaSuccess) return (int)e;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes;
  return (int)cudaSuccess;
}
