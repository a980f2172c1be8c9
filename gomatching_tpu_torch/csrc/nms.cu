// Greedy non-maximum suppression over the query-slot axis, for Hopper (sm_90a).
//
//   nms_mask  -- keep[b, s] for boxes (B, N, 4) xyxy f32, scores (B, N) f32, valid
//       (B, N) bool: torchvision's greedy NMS over the valid slots of each frame,
//       visited in descending score order (ties in slot order, NaN first, as
//       torch.sort(descending=True, stable=True) puts them); a slot is dropped if it
//       overlaps an already kept slot with IoU > thr. keep is valid & kept.
//
// It replaces no TPU kernel: the JAX package's nms_mask (gomatching_tpu/utils/boxes.py:40)
// is a lax.fori_loop that XLA compiles. What it replaces is the port's eager form of
// that loop (utils/boxes.py:nms_mask), N steps of about five tensor ops each, so ~5N
// launches a call (N = 300 queries: ~1500) during which the card waits for the host.
//
// What bounds it on an H100: not bytes (B * N * 22 bytes read and written, nanoseconds)
// but the greedy recurrence, N dependent steps. The design makes each step a few
// shared-memory cycles of one warp, and does everything else in parallel first.
// One block of NMS_THREADS threads a frame, grid (B,); dynamic shared memory sized
// from N; no atomics and a fixed order, so the result is the same bits every run.
//   1. Order by counting: the rank of a valid slot is the number of valid slots that
//      sort before it (a higher score, or an equal one at a lower slot). Invalid slots
//      get no rank: they are never kept and so never suppress.
//   2. Each valid slot's box and area go to shared memory at its rank.
//   3. Suppression bitmask, N rows of W = ceil(N / 32) words: bit j of row i is set when
//      j < i and IoU(i, j) > thr. A warp builds one word with one ballot, a lane an IoU.
//      The IoU is pairwise_iou's arithmetic op for op (area, max/min, clamp, product,
//      (area_i + area_j) - inter, division where union > 0), each op rounded as torch
//      rounds it: the _rn intrinsics keep nvcc from contracting any pair into an FMA,
//      and max/min/clamp pass NaN on as torch.maximum/minimum/clamp do. thr is the f32
//      that torch compares an f32 tensor with.
//   4. The greedy scan in one warp: lane w holds keep word w (W <= 32). Step i:
//      suppressed = any lane's (row_i[w] & keep[w]) != 0; if not, the owning lane sets
//      bit i. Row i + 1 is loaded while step i decides, so a step's dependent chain is
//      the AND, the vote and the OR. A measurement build (-DNMS_SCAN_PASSES=k, which
//      chip_smoke.py times against this one) runs the scan k times; every pass after
//      the first decides as the first did (row i holds only bits j < i), so the time
//      it adds is k - 1 scans.
//   5. keep[b, s] = bit rank(s) of the keep words, in slot order.
// Shared memory: 6 N floats (boxes, areas, scores), N ints (ranks), N * W words (the
// mask), 32 keep words, N bytes (valid): 20.3 KB at N = 300 (the mask 11.7 KB),
// 157.1 KB at NMS_MAX_N, above the 48 KB a launch takes without opting in.

#include <cuda_runtime.h>
#include <stdint.h>

#define NMS_MAX_N 1024
#define NMS_THREADS 512
#define NMS_STATIC_SMEM_LIMIT (48 * 1024)
#ifndef NMS_SCAN_PASSES
#define NMS_SCAN_PASSES 1
#endif

static __host__ __device__ int nms_words(int N) { return (N + 31) / 32; }

static size_t nms_smem_bytes(int N) {
  return (size_t)N * (6 * sizeof(float) + sizeof(int) + 1) +
         (size_t)N * nms_words(N) * sizeof(unsigned) + 32 * sizeof(unsigned);
}

// does slot j (score sj) sort before slot s (score ss) in a descending stable sort?
__device__ __forceinline__ bool sorts_before(float sj, int j, float ss, int s) {
  const bool nj = sj != sj, ns = ss != ss;
  if (nj != ns) return nj;
  if (!nj && sj != ss) return sj > ss;
  return j < s;
}

// torch.maximum / torch.minimum: NaN if either is NaN
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
// clamp(min=0), NaN passed on
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

__global__ void __launch_bounds__(NMS_THREADS)
nms_mask_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep, int N,
                float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = nms_words(N);
  float* x1 = reinterpret_cast<float*>(smem);
  float* y1 = x1 + N;
  float* x2 = y1 + N;
  float* y2 = x2 + N;
  float* area = y2 + N;
  float* score = area + N;
  int* rank = reinterpret_cast<int*>(score + N);
  unsigned* mask = reinterpret_cast<unsigned*>(rank + N);
  unsigned* keep_words = mask + (size_t)N * W;
  uint8_t* ok = reinterpret_cast<uint8_t*>(keep_words + 32);

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = NMS_THREADS / 32;
  const float* bx = boxes + (size_t)b * N * 4;
  scores += (size_t)b * N;
  valid += (size_t)b * N;
  keep += (size_t)b * N;

  // scores and valid flags into shared memory; the number of valid slots
  int n_valid = 0;
  for (int base = 0; base < N; base += NMS_THREADS) {
    const int s = base + tid;
    bool v = false;
    if (s < N) {
      v = valid[s] != 0;
      ok[s] = v;
      score[s] = scores[s];
    }
    n_valid += __syncthreads_count(v);
  }

  // 1-2. each valid slot's rank; its box and area at that rank
  for (int s = tid; s < N; s += NMS_THREADS) {
    int r = -1;
    if (ok[s]) {
      const float ss = score[s];
      r = 0;
      for (int j = 0; j < N; ++j) r += (ok[j] && sorts_before(score[j], j, ss, s)) ? 1 : 0;
      const float a0 = bx[4 * s], a1 = bx[4 * s + 1], a2 = bx[4 * s + 2], a3 = bx[4 * s + 3];
      x1[r] = a0;
      y1[r] = a1;
      x2[r] = a2;
      y2[r] = a3;
      area[r] = __fmul_rn(clamp0(__fsub_rn(a2, a0)), clamp0(__fsub_rn(a3, a1)));
    }
    rank[s] = r;
  }
  __syncthreads();

  // 3. the suppression bitmask: word w of row i, one warp, lane l tests j = 32 w + l
  for (int t = warp; t < n_valid * W; t += n_warps) {
    const int i = t / W, j = (t - i * W) * 32 + lane;
    bool over = false;
    if (j < i) {
      const float w = clamp0(__fsub_rn(nan_min(x2[i], x2[j]), nan_max(x1[i], x1[j])));
      const float h = clamp0(__fsub_rn(nan_min(y2[i], y2[j]), nan_max(y1[i], y1[j])));
      const float inter = __fmul_rn(w, h);
      const float uni = __fsub_rn(__fadd_rn(area[i], area[j]), inter);
      const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
      over = iou > thr;
    }
    const unsigned bits = __ballot_sync(0xffffffffu, over);
    if (lane == 0) mask[t] = bits;
  }
  __syncthreads();

  // 4. the greedy scan, in rank order
  if (warp == 0) {
    unsigned kept = 0;
    for (int pass = 0; pass < NMS_SCAN_PASSES; ++pass) {
      unsigned row = (lane < W && n_valid > 0) ? mask[lane] : 0u;
      for (int i = 0; i < n_valid; ++i) {
        const unsigned next =
            (lane < W && i + 1 < n_valid) ? mask[(size_t)(i + 1) * W + lane] : 0u;
        const bool suppressed = __any_sync(0xffffffffu, (row & kept) != 0u);
        if (!suppressed && lane == (i >> 5)) kept |= 1u << (i & 31);
        row = next;
      }
    }
    keep_words[lane] = kept;
  }
  __syncthreads();

  // 5. back to slot order
  for (int s = tid; s < N; s += NMS_THREADS) {
    const int r = rank[s];
    keep[s] = (r >= 0 && ((keep_words[r >> 5] >> (r & 31)) & 1u)) ? 1 : 0;
  }
}

// boxes (B, N, 4) f32, scores (B, N) f32, valid (B, N) bool (one byte each), all
// contiguous; keep (B, N) bool written. 1 <= N <= NMS_MAX_N. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments out of range).
extern "C" int nms_mask(const float* boxes, const float* scores, const uint8_t* valid,
                        uint8_t* keep, int B, int N, float thr, void* stream) {
  if (B < 0 || N < 1 || N > NMS_MAX_N) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const size_t smem = nms_smem_bytes(N);
  if (smem > NMS_STATIC_SMEM_LIMIT) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_mask_kernel<<<B, NMS_THREADS, smem, (cudaStream_t)stream>>>(boxes, scores, valid, keep,
                                                                   N, thr);
  return (int)cudaGetLastError();
}
