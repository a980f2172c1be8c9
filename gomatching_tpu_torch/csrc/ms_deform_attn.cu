// Multi-scale deformable attention forwards for Hopper (sm_90a).
//
// Two kernels share one exact bilinear tap routine (grid_sample semantics:
// align_corners=False, zero padding):
//
//   ms_deform_attn_queries_fwd  -- arbitrary normalized sampling locations and
//       softmaxed attention (decoder cross-attention). Replaces the TPU kernel
//       gomatching_tpu/ops/deform_attn_dec_vmem.py:_kernel (entry
//       ms_deform_attn_queries_vmem).
//   ms_deform_attn_encoder_fwd  -- encoder self-attention: the queries are the
//       grid tokens themselves, so each token's level, (row, col) and reference
//       point ((col+0.5)/W, (row+0.5)/H) come from its index; inputs are the raw
//       sampling offsets (target-level cells, reference (m, l, p, xy) order) and
//       the attention LOGITS, softmaxed over L*P in registers. Exact over the
//       whole level (the TPU kernel gomatching_tpu/ops/deform_attn_vmem.py:
//       _kernel_v2 is exact only within its halo).
//
// Design: the gather form of the reference CUDA im2col forward
// (ms_deform_im2col_cuda.cuh:238), not the TPU's one-hot matrix contraction.
// One warp owns one (batch, query, head) triple and its 32 lanes own the
// channels of that head, so each bilinear corner is one coalesced 128-byte load
// when D == 32 (D > 32 loops over channel groups). Accumulation is f32.
//
// What bounds it on an H100: memory. Per sample it does 4 FMAs per channel
// against 4 scattered corner rows, so arithmetic intensity is ~0.5 flop/byte of
// corner traffic; the least time is the bytes of value + locations + attention
// + output over 3.35 TB/s. The corners of neighbouring queries overlap, so most
// corner loads hit L2 (the value tensor of one frame is 38 MB, inside the 50 MB
// L2). Keeping value tiles in shared memory, and loading the per-sample
// locations once per warp with shuffles, is later work.
//
// Plain C interface, loaded with ctypes; every launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 8
#define MSDA_WARPS_PER_BLOCK 8

struct LevelInfo {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

// Bilinear sample of one channel. ``v`` points at (level start token, head,
// this lane's channel); consecutive tokens are ``tok_stride`` floats apart.
// (x, y) are pixel coordinates with align_corners=False already applied
// (x = loc_x * W - 0.5). Corners outside the map contribute zero.
__device__ __forceinline__ float bilinear_tap(const float* __restrict__ v, int h, int w,
                                              int64_t tok_stride, float x, float y) {
  if (!(x > -1.f && y > -1.f && x < (float)w && y < (float)h)) return 0.f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const float dx = x - x0f;
  const float dy = y - y0f;
  const float hx = 1.f - dx;
  const float hy = 1.f - dy;
  float acc = 0.f;
  if (y0 >= 0) {
    const float* row = v + (int64_t)y0 * w * tok_stride;
    if (x0 >= 0) acc += hy * hx * __ldg(row + (int64_t)x0 * tok_stride);
    if (x0 + 1 < w) acc += hy * dx * __ldg(row + (int64_t)(x0 + 1) * tok_stride);
  }
  if (y0 + 1 < h) {
    const float* row = v + (int64_t)(y0 + 1) * w * tok_stride;
    if (x0 >= 0) acc += dy * hx * __ldg(row + (int64_t)x0 * tok_stride);
    if (x0 + 1 < w) acc += dy * dx * __ldg(row + (int64_t)(x0 + 1) * tok_stride);
  }
  return acc;
}

// value (B, S, M, D); loc (B, Lq, M, L, P, 2); attn (B, Lq, M, L, P);
// out (B, Lq, M*D). Warp index == flattened (b, q, m).
__global__ void ms_deform_attn_queries_kernel(const float* __restrict__ value,
                                              const float* __restrict__ loc,
                                              const float* __restrict__ attn,
                                              float* __restrict__ out, LevelInfo lv, int S,
                                              int Lq, int M, int D, int L, int P,
                                              int64_t n_warps) {
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;
  const int m = (int)(warp % M);
  const int64_t b = warp / ((int64_t)M * Lq);
  const int LP = L * P;
  const float* loc_w = loc + warp * LP * 2;
  const float* attn_w = attn + warp * LP;
  const int64_t tok_stride = (int64_t)M * D;
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int h = lv.h[l];
      const int w = lv.w[l];
      const float* vb = value + ((b * S + lv.start[l]) * M + m) * D + d;
      for (int p = 0; p < P; ++p) {
        const int i = l * P + p;
        const float x = __ldg(loc_w + 2 * i) * w - 0.5f;
        const float y = __ldg(loc_w + 2 * i + 1) * h - 0.5f;
        acc += __ldg(attn_w + i) * bilinear_tap(vb, h, w, tok_stride, x, y);
      }
    }
    out[warp * D + d] = acc;
  }
}

// value (B, S, M, D); off (B, S, M, L, P, 2) raw target-level cells;
// logits (B, S, M, L*P); out (B, S, M*D). Warp index == flattened (b, s, m).
__global__ void ms_deform_attn_encoder_kernel(const float* __restrict__ value,
                                              const float* __restrict__ off,
                                              const float* __restrict__ logits,
                                              float* __restrict__ out, LevelInfo lv, int S,
                                              int M, int D, int L, int P, int64_t n_warps) {
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;
  const int m = (int)(warp % M);
  const int64_t bs = warp / M;
  const int s = (int)(bs % S);
  const int64_t b = bs / S;
  // the query token's own level and grid cell
  int l1 = 0;
  while (l1 + 1 < L && s >= lv.start[l1 + 1]) ++l1;
  const int t = s - lv.start[l1];
  const int row = t / lv.w[l1];
  const int col = t - row * lv.w[l1];
  const float rx = ((float)col + 0.5f) / (float)lv.w[l1];
  const float ry = ((float)row + 0.5f) / (float)lv.h[l1];

  const int LP = L * P;
  const float* lg = logits + warp * LP;
  const float* of = off + warp * LP * 2;
  float mx = __int_as_float(0xff800000);  // -inf
  for (int i = 0; i < LP; ++i) mx = fmaxf(mx, __ldg(lg + i));
  float sum = 0.f;
  for (int i = 0; i < LP; ++i) sum += expf(__ldg(lg + i) - mx);

  const int64_t tok_stride = (int64_t)M * D;
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int h = lv.h[l];
      const int w = lv.w[l];
      const float* vb = value + ((b * S + lv.start[l]) * M + m) * D + d;
      for (int p = 0; p < P; ++p) {
        const int i = l * P + p;
        const float a = expf(__ldg(lg + i) - mx) / sum;
        // the reference's order: loc = ref + off / (W, H), then x = loc * W - 0.5
        const float lx = rx + __ldg(of + 2 * i) / (float)w;
        const float ly = ry + __ldg(of + 2 * i + 1) / (float)h;
        acc += a * bilinear_tap(vb, h, w, tok_stride, lx * w - 0.5f, ly * h - 0.5f);
      }
    }
    out[warp * D + d] = acc;
  }
}

static LevelInfo make_levels(const int* shapes, int L) {
  LevelInfo lv;
  int start = 0;
  for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
    if (l < L) {
      lv.h[l] = shapes[2 * l];
      lv.w[l] = shapes[2 * l + 1];
      lv.start[l] = start;
      start += lv.h[l] * lv.w[l];
    } else {
      lv.h[l] = lv.w[l] = 0;
      lv.start[l] = start;
    }
  }
  return lv;
}

static unsigned int n_blocks(int64_t n_warps) {
  return (unsigned int)((n_warps + MSDA_WARPS_PER_BLOCK - 1) / MSDA_WARPS_PER_BLOCK);
}

extern "C" int ms_deform_attn_queries_fwd(const float* value, const float* loc,
                                          const float* attn, float* out, const int* shapes,
                                          int B, int S, int Lq, int M, int D, int L, int P,
                                          void* stream) {
  if (L < 1 || L > MSDA_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  const int64_t n_warps = (int64_t)B * Lq * M;
  if (n_warps == 0) return (int)cudaSuccess;
  ms_deform_attn_queries_kernel<<<n_blocks(n_warps), 32 * MSDA_WARPS_PER_BLOCK, 0,
                                  (cudaStream_t)stream>>>(
      value, loc, attn, out, make_levels(shapes, L), S, Lq, M, D, L, P, n_warps);
  return (int)cudaGetLastError();
}

extern "C" int ms_deform_attn_encoder_fwd(const float* value, const float* off,
                                          const float* logits, float* out, const int* shapes,
                                          int B, int S, int M, int D, int L, int P,
                                          void* stream) {
  if (L < 1 || L > MSDA_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  const int64_t n_warps = (int64_t)B * S * M;
  if (n_warps == 0) return (int)cudaSuccess;
  ms_deform_attn_encoder_kernel<<<n_blocks(n_warps), 32 * MSDA_WARPS_PER_BLOCK, 0,
                                  (cudaStream_t)stream>>>(
      value, off, logits, out, make_levels(shapes, L), S, M, D, L, P, n_warps);
  return (int)cudaGetLastError();
}
