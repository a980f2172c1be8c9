// Multi-scale deformable attention forwards and backwards for Hopper (sm_90a).
//
// Two forward kernels share one exact bilinear tap routine (grid_sample
// semantics: align_corners=False, zero padding):
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
// Their backwards (the VJPs the training path needs) recompute the taps:
//
//   ms_deform_attn_queries_bwd  -- B1's VJP: dValue, dLoc, dAttn from dOut.
//       Replaces gomatching_tpu/ops/deform_attn_dec_vmem.py:_bwd_kernel (via
//       _op_bwd).
//   ms_deform_attn_encoder_bwd  -- B2's VJP: dValue, dOffsets (cells) and
//       dLogits through the in-register softmax. Replaces
//       gomatching_tpu/ops/deform_attn_vmem.py:_bwd_kernel_v2 (via
//       _v2_bwd_impl); exact over the whole level, no halo and no slab
//       overlap-add.
//
// Design: the gather/scatter form of the reference CUDA col2im backward
// (ms_deform_im2col_cuda.cuh:302, :407, :514), not the TPU's transposed one-hot
// contraction. Same warp layout as the forwards: one warp per (batch, query,
// head), lanes on the channels. Per (level, point) the warp recomputes x, y and
// the four corner weights, then
//   dValue[corner] += attn * w_corner * dOut       (f32 atomicAdd: one coalesced
//                                                   128-byte reduction per corner
//                                                   at D == 32)
//   dAttn  = sum_d dOut[d] * sample[d]             (warp shuffles)
//   dLoc   = attn * sum_d dOut[d] * dsample/dx * W (and y, H; the encoder's
//                                                   offsets are in cells, so
//                                                   dx/doff = 1)
// Corners outside the map contribute nothing to any of the three, behind the
// same in-range gate as bilinear_tap, so the gradient is grid_sample's. The
// atomics reorder f32 sums, so dValue differs in its last bits from run to run.
// Bound: bytes again (the touched value rows read, dValue zeroed and written,
// the per-sample inputs read and gradients written). The function needs ~4 flops
// per channel per in-range corner (one dot dOut . v_corner, one dValue
// scale-and-add; dAttn, dx and dy follow from the four corner dots as scalars),
// which stays under the byte time. This kernel does ~8 (it accumulates the
// sample, gx and gy per channel), and the scattered corner atomics, mostly L2
// hits, are what the simple form pays above the bound.
//
// Plain C interface, loaded with ctypes; every launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 8
#define MSDA_MAX_SAMPLES 64  // L * P per head, kept in registers by the encoder backward
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

// Backward of one bilinear tap for this lane's channel. ``v``/``dv`` point at
// (level start token, head, channel) of value and dValue. Scatters ``ag`` (attn *
// dOut) times each corner weight into dv, adds g * dsample/dx and g * dsample/dy
// to gx and gy, and returns the sample.
__device__ __forceinline__ float bilinear_tap_bwd(const float* __restrict__ v,
                                                  float* __restrict__ dv, int h, int w,
                                                  int64_t tok_stride, float x, float y,
                                                  float g, float ag, float& gx, float& gy) {
  if (!(x > -1.f && y > -1.f && x < (float)w && y < (float)h)) return 0.f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const float dx = x - x0f;
  const float dy = y - y0f;
  const float hx = 1.f - dx;
  const float hy = 1.f - dy;
  const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < w, in_y0 = y0 >= 0, in_y1 = y0 + 1 < h;
  const int64_t o00 = ((int64_t)y0 * w + x0) * tok_stride;
  const int64_t o10 = o00 + (int64_t)w * tok_stride;
  float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
  if (in_y0 && in_x0) { v00 = __ldg(v + o00); atomicAdd(dv + o00, ag * hy * hx); }
  if (in_y0 && in_x1) { v01 = __ldg(v + o00 + tok_stride); atomicAdd(dv + o00 + tok_stride, ag * hy * dx); }
  if (in_y1 && in_x0) { v10 = __ldg(v + o10); atomicAdd(dv + o10, ag * dy * hx); }
  if (in_y1 && in_x1) { v11 = __ldg(v + o10 + tok_stride); atomicAdd(dv + o10 + tok_stride, ag * dy * dx); }
  gx += g * (hy * (v01 - v00) + dy * (v11 - v10));
  gy += g * (hx * (v10 - v00) + dx * (v11 - v01));
  return hy * hx * v00 + hy * dx * v01 + dy * hx * v10 + dy * dx * v11;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int k = 16; k > 0; k >>= 1) x += __shfl_xor_sync(0xffffffffu, x, k);
  return x;
}

// The backward of one (batch, query, head) warp over its L*P samples, shared by
// both kernels: writes dLoc (in units of ``loc_scale`` per pixel: W, H for
// normalized locations, 1 for cell offsets) and the attention gradient dA into
// ``dattn_w`` (lane 0), and scatters into dValue. ``xy_of`` maps sample i to its
// pixel coordinates (x, y).
template <typename XY>
__device__ __forceinline__ void warp_bwd(const float* __restrict__ value, float* __restrict__ dvalue,
                                         const float* __restrict__ dout_w,
                                         float* __restrict__ dloc_w, float* __restrict__ dattn_w,
                                         const LevelInfo& lv, int64_t b, int S, int m, int M,
                                         int D, int L, int P, int lane, bool normalized,
                                         const float* attn, XY xy_of) {
  const int64_t tok_stride = (int64_t)M * D;
  for (int l = 0; l < L; ++l) {
    const int h = lv.h[l];
    const int w = lv.w[l];
    const int64_t base = ((b * S + lv.start[l]) * M + m) * D;
    for (int p = 0; p < P; ++p) {
      const int i = l * P + p;
      float x, y;
      xy_of(i, l, x, y);
      const float a = attn[i];
      float s_acc = 0.f, gx = 0.f, gy = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float g = __ldg(dout_w + d);
        s_acc += g * bilinear_tap_bwd(value + base + d, dvalue + base + d, h, w, tok_stride,
                                      x, y, g, a * g, gx, gy);
      }
      s_acc = warp_sum(s_acc);
      gx = warp_sum(gx);
      gy = warp_sum(gy);
      if (lane == 0) {
        dattn_w[i] = s_acc;
        dloc_w[2 * i] = a * gx * (normalized ? (float)w : 1.f);
        dloc_w[2 * i + 1] = a * gy * (normalized ? (float)h : 1.f);
      }
    }
  }
}

// value/loc/attn as the forward; dout (B, Lq, M*D); dvalue (B, S, M, D) zeroed by
// the caller; dloc (B, Lq, M, L, P, 2); dattn (B, Lq, M, L, P).
__global__ void ms_deform_attn_queries_bwd_kernel(
    const float* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attn, const float* __restrict__ dout, float* __restrict__ dvalue,
    float* __restrict__ dloc, float* __restrict__ dattn, LevelInfo lv, int S, int Lq, int M,
    int D, int L, int P, int64_t n_warps) {
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;
  const int m = (int)(warp % M);
  const int64_t b = warp / ((int64_t)M * Lq);
  const int LP = L * P;
  const float* loc_w = loc + warp * LP * 2;
  const float* attn_w = attn + warp * LP;
  auto xy_of = [&](int i, int l, float& x, float& y) {
    x = __ldg(loc_w + 2 * i) * lv.w[l] - 0.5f;
    y = __ldg(loc_w + 2 * i + 1) * lv.h[l] - 0.5f;
  };
  warp_bwd(value, dvalue, dout + warp * D, dloc + warp * LP * 2, dattn + warp * LP, lv, b, S, m,
           M, D, L, P, lane, true, attn_w, xy_of);
}

// value/off/logits as the forward; dout (B, S, M*D); dvalue zeroed by the caller;
// doff (B, S, M, L, P, 2) in cells; dlogits (B, S, M, L*P).
__global__ void ms_deform_attn_encoder_bwd_kernel(
    const float* __restrict__ value, const float* __restrict__ off,
    const float* __restrict__ logits, const float* __restrict__ dout, float* __restrict__ dvalue,
    float* __restrict__ doff, float* __restrict__ dlogits, LevelInfo lv, int S, int M, int D,
    int L, int P, int64_t n_warps) {
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;
  const int m = (int)(warp % M);
  const int64_t bs = warp / M;
  const int s = (int)(bs % S);
  const int64_t b = bs / S;
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
  float* dlg = dlogits + warp * LP;
  float mx = __int_as_float(0xff800000);  // -inf
  for (int i = 0; i < LP; ++i) mx = fmaxf(mx, __ldg(lg + i));
  float sum = 0.f;
  for (int i = 0; i < LP; ++i) sum += expf(__ldg(lg + i) - mx);
  // the softmax, as the forward computes it, in a per-thread array
  float a[MSDA_MAX_SAMPLES];
  for (int i = 0; i < LP; ++i) a[i] = expf(__ldg(lg + i) - mx) / sum;
  auto xy_of = [&](int i, int l, float& x, float& y) {
    const float w = (float)lv.w[l];
    const float h = (float)lv.h[l];
    x = (rx + __ldg(of + 2 * i) / w) * w - 0.5f;
    y = (ry + __ldg(of + 2 * i + 1) / h) * h - 0.5f;
  };
  // dA goes into dlogits first, then through the softmax in place
  warp_bwd(value, dvalue, dout + warp * D, doff + warp * LP * 2, dlg, lv, b, S, m, M, D, L, P,
           lane, false, a, xy_of);
  __syncwarp();
  float dot = 0.f;
  for (int i = 0; i < LP; ++i) dot += a[i] * dlg[i];
  __syncwarp();
  for (int i = lane; i < LP; i += 32) dlg[i] = a[i] * (dlg[i] - dot);
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

extern "C" int ms_deform_attn_queries_bwd(const float* value, const float* loc,
                                          const float* attn, const float* dout, float* dvalue,
                                          float* dloc, float* dattn, const int* shapes, int B,
                                          int S, int Lq, int M, int D, int L, int P,
                                          void* stream) {
  if (L < 1 || L > MSDA_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  const int64_t n_warps = (int64_t)B * Lq * M;
  if (n_warps == 0) return (int)cudaSuccess;
  ms_deform_attn_queries_bwd_kernel<<<n_blocks(n_warps), 32 * MSDA_WARPS_PER_BLOCK, 0,
                                      (cudaStream_t)stream>>>(
      value, loc, attn, dout, dvalue, dloc, dattn, make_levels(shapes, L), S, Lq, M, D, L, P,
      n_warps);
  return (int)cudaGetLastError();
}

extern "C" int ms_deform_attn_encoder_bwd(const float* value, const float* off,
                                          const float* logits, const float* dout,
                                          float* dvalue, float* doff, float* dlogits,
                                          const int* shapes, int B, int S, int M, int D, int L,
                                          int P, void* stream) {
  if (L < 1 || L > MSDA_MAX_LEVELS || L * P > MSDA_MAX_SAMPLES) return (int)cudaErrorInvalidValue;
  const int64_t n_warps = (int64_t)B * S * M;
  if (n_warps == 0) return (int)cudaSuccess;
  ms_deform_attn_encoder_bwd_kernel<<<n_blocks(n_warps), 32 * MSDA_WARPS_PER_BLOCK, 0,
                                      (cudaStream_t)stream>>>(
      value, off, logits, dout, dvalue, doff, dlogits, make_levels(shapes, L), S, M, D, L, P,
      n_warps);
  return (int)cudaGetLastError();
}
