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
// gather_rows_sum. Design: each warp takes runs of 32 gathered rows (a chunk):
// lane l loads index l of the chunk (one coalesced 128-byte index load), then
// the warp walks the chunk's rows, broadcasting each row index with a shuffle.
// At C == 32 lane l loads element l of the row (one coalesced row: 128 bytes in
// f32, 64 in bf16); at C == 128 it loads a float4 (or 4 bf16) when the table is
// so aligned; any other C loops over the row in steps of 32. The row loop is
// unrolled so that several row loads of a warp are in flight at once. Values are
// upcast to f32 and summed in registers; warp shuffles and shared memory reduce
// each block to one partial, and a second one-block pass sums the partials in a
// fixed order. The grid depends only on the number of rows, so the result is the
// same bits from run to run (an f32 atomicAdd across blocks would not be).
// What bounds it on an H100: the function must read the table once, the indices
// once and write one float: (R*C*size + 4*n*k + 4) bytes over 3.35 TB/s. The
// gathered bytes (n*k*C*size) are many times that, but the table (1-4 MB at the
// probe's shapes) stays in the 50 MB L2, so they are L2 traffic: the kernel is
// bound by how fast the SMs can have random rows served from L2, which is the
// rate the probe measures.
//
// onehot_g. Design: one thread per output element (h, w, q), q fastest, so a
// warp stores 32 consecutive q of one (h, w) row. A block covers 32 q by 8 w of
// one h and first stages x, y and a of its q-range for every p in shared
// memory. Each thread then computes, per p in order, the same ops as _g_kernel
// in its order: x0 = floor(x), dx = x - x0, xw, yw, yw *= a, acc += yw * xw (acc
// starts as the p = 0 term). Every f32 op is an explicit _rn intrinsic, so no
// multiply-add is contracted; in the bf16 instantiation each op's f32 result is
// rounded to bf16 (__float2bfloat16_rn), which is what the plain version does
// op by op. A tap outside [0, FH) x [0, FW) matches no h or w and drops out:
// there is no clamping. The output is dense (the TPU's form), so nothing is
// scattered and no atomics are needed. What bounds it: the output bytes
// (FH*FW*Q * 4 or 2), 2 P flops per element being far fewer; at the probe's
// shape (P=8, 32x32x256) that is 0.3 us, so a launch costs more than the work.
//
// Plain C interface, loaded with ctypes; every launch goes on the caller's stream
// and each function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define GATHER_WARPS 8         // warps per block of the first pass
#define GATHER_MAX_BLOCKS 1024 // the first pass's grid is at most this wide
#define FINAL_THREADS 256      // the second pass: one block
#define G_TQ 32                // onehot_g: q per block (one warp's row)
#define G_TW 8                 // onehot_g: w per block
#define G_MAX_P 64             // 3 * P * G_TQ floats of shared memory (24 KB at 64)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Add this lane's share of one table row to acc. VEC > 0: each lane loads VEC
// consecutive elements at lane * VEC (C == 32 * VEC, the row start aligned to
// VEC elements); VEC == 0: any C, lanes stride the row by 32.
template <typename T, int VEC>
__device__ __forceinline__ void add_row(const T* __restrict__ row, int C, int lane, float& acc) {
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
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

// First pass: partials[blockIdx.x] = this block's share of the sum.
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
        const int r = __shfl_sync(0xffffffffu, mine, j);
        add_row<T, VEC>(v + (int64_t)r * C, C, lane, acc);
      }
    } else {
      for (int j = 0; j < cnt; ++j) {
        const int r = __shfl_sync(0xffffffffu, mine, j);
        add_row<T, VEC>(v + (int64_t)r * C, C, lane, acc);
      }
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

// Second pass, one block: out[0] = the partials' sum, in a fixed order.
__global__ void gather_rows_sum_final_kernel(const float* __restrict__ partials, int n,
                                             float* __restrict__ out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

// Blocks of the first pass for n_rows gathered rows (gather_probe.py computes the
// same number to size the partials).
static int gather_blocks(int64_t n_rows) {
  const int64_t chunks = (n_rows + 31) / 32;
  const int64_t blocks = (chunks + GATHER_WARPS - 1) / GATHER_WARPS;
  return (int)(blocks < GATHER_MAX_BLOCKS ? (blocks > 0 ? blocks : 1) : GATHER_MAX_BLOCKS);
}

template <typename T>
static void launch_gather(const T* v, const int* idx, int64_t n_rows, int C, float* partials,
                          int blocks, cudaStream_t s) {
  const int threads = 32 * GATHER_WARPS;
  const int vec_bytes = 4 * (int)sizeof(T);
  if (C == 32) {
    gather_rows_sum_kernel<T, 1><<<blocks, threads, 0, s>>>(v, idx, n_rows, C, partials);
  } else if (C == 128 && (uintptr_t)v % vec_bytes == 0) {
    gather_rows_sum_kernel<T, 4><<<blocks, threads, 0, s>>>(v, idx, n_rows, C, partials);
  } else {
    gather_rows_sum_kernel<T, 0><<<blocks, threads, 0, s>>>(v, idx, n_rows, C, partials);
  }
}

// v (R, C) f32 (bf16 = 0) or bf16 (bf16 = 1); idx (n_rows,) int32 in [0, R);
// partials (blocks,) f32 scratch with blocks == gather_blocks(n_rows); out (1,) f32.
extern "C" int gather_rows_sum(const void* v, const int* idx, float* partials, float* out,
                               int64_t n_rows, int C, int bf16, int blocks, void* stream) {
  if (C < 1 || n_rows < 0 || blocks != gather_blocks(n_rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    launch_gather(static_cast<const __nv_bfloat16*>(v), idx, n_rows, C, partials, blocks, s);
  else
    launch_gather(static_cast<const float*>(v), idx, n_rows, C, partials, blocks, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gather_rows_sum_final_kernel<<<1, FINAL_THREADS, 0, s>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}

extern "C" int gather_rows_sum_blocks(int64_t n_rows) { return gather_blocks(n_rows); }

// f32 op results, rounded to bf16 in the bf16 instantiation.
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// x, y, a (P, Q) f32; out (FH, FW, Q). Block (G_TQ * G_TW threads) = q-range
// [blockIdx.x * G_TQ, +G_TQ) x w-range [blockIdx.y * G_TW, +G_TW) at h = blockIdx.z.
template <bool BF16, typename Out>
__global__ void onehot_g_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                const float* __restrict__ a, Out* __restrict__ out, int P,
                                int FH, int FW, int Q) {
  __shared__ float sx[G_MAX_P * G_TQ];
  __shared__ float sy[G_MAX_P * G_TQ];
  __shared__ float sa[G_MAX_P * G_TQ];
  const int q0 = blockIdx.x * G_TQ;
  for (int i = threadIdx.x; i < P * G_TQ; i += blockDim.x) {
    const int p = i / G_TQ;
    const int q = q0 + i % G_TQ;
    const bool ok = q < Q;
    sx[i] = ok ? __ldg(x + (int64_t)p * Q + q) : 0.f;
    sy[i] = ok ? __ldg(y + (int64_t)p * Q + q) : 0.f;
    sa[i] = ok ? __ldg(a + (int64_t)p * Q + q) : 0.f;
  }
  __syncthreads();
  const int qq = threadIdx.x % G_TQ;
  const int q = q0 + qq;
  const int w = blockIdx.y * G_TW + threadIdx.x / G_TQ;
  const int h = blockIdx.z;
  if (q >= Q || w >= FW) return;
  float acc = 0.f;
  for (int p = 0; p < P; ++p) {
    const float xv = rnd<BF16>(sx[p * G_TQ + qq]);
    const float yv = rnd<BF16>(sy[p * G_TQ + qq]);
    const float av = rnd<BF16>(sa[p * G_TQ + qq]);
    const float x0 = floorf(xv);
    const float y0 = floorf(yv);
    const float dx = rnd<BF16>(__fsub_rn(xv, x0));
    const float dy = rnd<BF16>(__fsub_rn(yv, y0));
    const int xi = (int)x0;
    const int yi = (int)y0;
    const float xw = rnd<BF16>(__fadd_rn(w == xi ? rnd<BF16>(__fsub_rn(1.f, dx)) : 0.f,
                                         w == xi + 1 ? dx : 0.f));
    float yw = rnd<BF16>(__fadd_rn(h == yi ? rnd<BF16>(__fsub_rn(1.f, dy)) : 0.f,
                                   h == yi + 1 ? dy : 0.f));
    yw = rnd<BF16>(__fmul_rn(yw, av));
    const float term = rnd<BF16>(__fmul_rn(yw, xw));
    acc = p == 0 ? term : rnd<BF16>(__fadd_rn(acc, term));
  }
  store(out + ((int64_t)h * FW + w) * Q + q, acc);
}

// compute_bf16 / out_bf16: (0, 0) f32 arithmetic, f32 out; (1, 1) bf16 arithmetic,
// bf16 out; (0, 1) f32 arithmetic, bf16 out.
extern "C" int onehot_g(const float* x, const float* y, const float* a, void* out, int P, int FH,
                        int FW, int Q, int compute_bf16, int out_bf16, void* stream) {
  if (P < 1 || P > G_MAX_P || FH < 0 || FH > 65535 || FW < 0 || Q < 0 ||
      (compute_bf16 && !out_bf16))
    return (int)cudaErrorInvalidValue;
  if (FH == 0 || FW == 0 || Q == 0) return (int)cudaSuccess;
  const dim3 grid((Q + G_TQ - 1) / G_TQ, (FW + G_TW - 1) / G_TW, FH);
  cudaStream_t s = (cudaStream_t)stream;
  if (!out_bf16)
    onehot_g_kernel<false, float><<<grid, G_TQ * G_TW, 0, s>>>(x, y, a, static_cast<float*>(out),
                                                                P, FH, FW, Q);
  else if (compute_bf16)
    onehot_g_kernel<true, __nv_bfloat16><<<grid, G_TQ * G_TW, 0, s>>>(
        x, y, a, static_cast<__nv_bfloat16*>(out), P, FH, FW, Q);
  else
    onehot_g_kernel<false, __nv_bfloat16><<<grid, G_TQ * G_TW, 0, s>>>(
        x, y, a, static_cast<__nv_bfloat16*>(out), P, FH, FW, Q);
  return (int)cudaGetLastError();
}
