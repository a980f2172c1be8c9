// Multi-scale deformable attention forwards and backwards for Hopper (sm_90a).
//
// Two forwards take arbitrary locations or the encoder's own grid (grid_sample
// semantics: align_corners=False, zero padding):
//
//   ms_deform_attn_queries_fwd  -- B1: arbitrary normalized sampling locations and
//       softmaxed attention (decoder cross-attention). Replaces the TPU kernel
//       gomatching_tpu/ops/deform_attn_dec_vmem.py:_kernel (entry
//       ms_deform_attn_queries_vmem). The gather form of the reference CUDA im2col
//       forward (ms_deform_im2col_cuda.cuh:238), not the TPU's one-hot matrix
//       contraction. D == 32, L*P <= 64.
//   ms_deform_attn_encoder_fwd  -- B2: encoder self-attention: the queries are the
//       grid tokens themselves, so each token's level, (row, col) and reference
//       point ((col+0.5)/W, (row+0.5)/H) come from its index; inputs are the raw
//       sampling offsets (target-level cells, reference (m, l, p, xy) order) and
//       the attention LOGITS, softmaxed over L*P on the lanes. Replaces
//       gomatching_tpu/ops/deform_attn_vmem.py:_kernel_v2 (entry
//       ms_deform_attn_encoder_vmem_v2); exact over the whole level, where the TPU
//       kernel is exact only within its halo. D == 32, L*P <= 64.
//
// What bounds both on an H100: memory. Per sample a head does 4 FMAs per channel
// against 4 scattered corner rows, ~0.5 flop per byte of corner traffic; the least
// time is the bytes of the touched value rows + locations + attention + output over
// 3.35 TB/s (0.119 ms for B2 at 3 frames of 1000x1778, 0.030 ms for B1 at 3 x 2500
// decoder queries). But every sample reads four 128-byte rows (57M rows, 7.3 GB for
// B2's call), almost all from L2 and L1, so what the kernels reach is a rate of
// gathered rows, not the byte bound.
//
// The lane layout (B1, B2, B4, and B5 on its table). The first forms of B1 and B2 took
// one warp per (batch, query, head), lanes on the channels, 16 samples in series through
// a per-sample bilinear tap: B2 3.70 ms, B1 0.212 ms a call on an NVIDIA H100 80GB HBM3 at
// 700 W. Every lane reloaded the samples' inputs (B2: its 16 logits three times, expf per
// lane and sample); the runtime-indexed LevelInfo parameter was copied to each thread's
// stack; each sample's four branch-guarded corner loads depended on that sample's input
// load, so a warp had about one load in flight. The design now, straight from value
// (B, S, M, 32):
//   - a 2D grid: blockIdx.y is the (batch, head) pair and the 8 warps of a block take 8
//     neighbouring queries, so warps run in (batch, head, query) order and share that
//     head's L1 and L2 lines (B1's 25 points of a text instance are neighbouring
//     queries), and no lane divides a 64-bit index (a form of B2 with a 1D grid, 64-bit
//     divisions and level_dims per sample took 0.93 ms);
//   - lane j loads sample j's coordinate pair and weight (one coalesced load each for the
//     warp, load_samples); B2 softmaxes the logits there (lane_softmax: max and sum by
//     shuffles, one expf per sample);
//   - the level dims come from a table on the lanes (lane_level / level_of), filled
//     from LevelInfo with constant indices: no runtime index into the parameter;
//   - lane l owns corner l/8 and channels 4(l%8)..+3. For a batch of 8 samples, lane
//     8c + k computes sample k's clamped token row of corner c and that corner's
//     weight with the attention folded in (sample_corner; 0, with a valid row, for a
//     corner off the map: loads need no branch). gather8 hands each lane its own
//     corner's row and weight with one shuffle each and issues the batch's 8 float4
//     loads (8 x 4 128-byte lines) before the first is used, while the next batch's
//     geometry is computed; shuffles by 8 and 16 then sum the corners and lanes 0-7
//     store the head's 128 bytes. The sums run in a fixed order, without atomics, so
//     a call gives the same bits every time.
// ptxas: B1 64 registers, B2 62, no stack, no spills (the kernels ask for 4 blocks of 256
// threads a SM); the runtime holds 32 warps per SM. On an NVIDIA H100 80GB HBM3 at 700 W:
// B2 0.79 ms against a bound of 0.119 ms (4.7x faster than its first form); B1 0.059 ms
// at the decoder shape against a bound of 0.030 ms (a wrapper call, host included, ~0.1
// ms) and 0.62 ms at the encoder's shape, on the same samples as B2: the same function
// from the same inputs, less the reference point and the softmax. What bounds them now is
// their own work, not memory: with every gathered row an L1 hit (the -DMSDA_GATHER_ROW0
// build) B2 still takes 0.739 ms of its 0.789, B1 0.575 of 0.625 at the encoder's shape
// and 0.043 of 0.059 at the decoder's.
// Not used, and why: tensor cores (the function does ~0.5 flop per byte; the one-hot
// operand of a matmul form alone costs 4-10 us a block to build, the probe T2);
// shared-memory value tiles (measured in B6: 3.8-4.4 ms); TMA (it copies tiles, not
// 16-byte gathers).
//
// Their backwards (the VJPs the training path needs) recompute the taps:
//
//   ms_deform_attn_queries_bwd  -- B3: B1's VJP: dValue, dLoc, dAttn from dOut.
//       Replaces gomatching_tpu/ops/deform_attn_dec_vmem.py:_bwd_kernel (via
//       _op_bwd).
//   ms_deform_attn_encoder_bwd  -- B4: B2's VJP: dValue, dOffsets (cells) and
//       dLogits through the in-register softmax. Replaces
//       gomatching_tpu/ops/deform_attn_vmem.py:_bwd_kernel_v2 (via
//       _v2_bwd_impl); exact over the whole level, no halo and no slab
//       overlap-add.
//
// Both compute, per sample and in-map corner c with bilinear weight w_c,
//   dValue[corner] += attn * w_c * dOut
//   dAttn  = sum_c w_c * dot(dOut, v_c)
//   dLoc   = attn * sum_c dot(dOut, v_c) * dw_c/dx * W (and y, H; the encoder's
//            offsets are in cells, so dx/doff = 1)
// the gather/scatter form of the reference CUDA col2im backward
// (ms_deform_im2col_cuda.cuh:302, :407, :514), not the TPU's transposed one-hot
// contraction. Corners outside the map contribute nothing to any of the three, so the
// gradient is grid_sample's. dValue's f32 atomics reorder its sums, so it differs in
// its last bits from run to run. Bound: bytes (the touched value rows read, dValue
// zeroed and written, the per-sample inputs read and gradients written; 0.062 ms for B4
// at 1280x1280, 0.021 ms for B3 at 2500 queries). The function needs ~4 flops per
// channel per in-range corner (one dot, one dValue scale-and-add), which stays under
// the byte time.
//
// B3 keeps its first form: one warp per (batch, query, head), lanes on the channels;
// per (level, point) the warp recomputes x, y and the four corner weights, scatters
// with one scalar f32 atomicAdd per channel and corner (a 128-byte reduction per
// corner at D == 32) and reduces the sample, dx and dy with three 5-step warp sums;
// lane 0 writes dAttn and dLoc; LevelInfo indexed at run time (on the stack). 0.14 ms
// against its 0.021 ms bound on an NVIDIA H100 80GB HBM3 at 700 W.
//
// B4 is the transpose of B2 on its lane layout (B4's first form had B3's and took
// 1.81 ms): B2's grid, level table, softmax and geometry, so each sample lands in the
// same cell as in the forward. Lane l keeps dOut's channels 4(l%8)..+3 as one float4.
// Per batch of 8 samples, lane 8c + k holds corner c of sample k: the warp first adds
// a_k w_ck dOut to each in-map corner row with one float4 atomicAdd per lane and sample
// (4x fewer atomic instructions than a scalar one per channel; a corner off the map
// issues none), merging the corners of the batch that share a row (merge_shared_rows)
// so a row gets one atomic; then it gathers the batch's rows (load8, 8 loads in flight)
// and each lane forms its 4-channel share of dot(dOut, v_ck); a 7-shuffle
// reduce-scatter (xor 4, 2, 1) leaves the whole dot of (c, k) on lane 8c + k, where the
// corner's weight and its x and y derivatives (all 0 off the map: the corner's row is
// the valid one it was clamped to) turn it into the three terms that shuffles by 8 and
// 16 sum over the corners: dA_k, gx_k, gy_k. The lane of sample k stores dOffsets_k =
// a_k (gx_k, gy_k), and dLogits_j = a_j (dA_j - sum_i a_i dA_i) runs on the lanes
// without a round trip through device memory. dOffsets and dLogits are summed in a
// fixed order: the same bits every call. ptxas: 64 registers, no stack, no spills; 32
// warps per SM. On an NVIDIA H100 80GB HBM3 at 700 W: 0.65 ms at (1, 34000, 8, 32)
// against a bound of 0.062 ms (2.8x faster than its first form); without the dValue
// atomics (the -DMSDA_NO_SCATTER build) 0.29 ms, so the scatter (17.4M 128-byte L2
// reductions a call) sets its pace. Tried and not kept: the atomics issued after the
// loads (32 bytes of spills, 0.72 ms). Merging shared rows took B4 from 0.67 to 0.65 ms
// at random offsets and from 0.77 to 0.58 ms a launch in a training step, whose offsets
// cluster, so it stays.
//
// A third forward samples the corner-merged table (SAMPLING_IMPL='pallas'):
//
//   ms_deform_attn_merged_fwd  -- B5; replaces gomatching_tpu/ops/deform_attn_pallas.py:
//       _sampling_kernel (entry ms_deform_attn_pallas). The table (B, M, S, 4D)
//       holds in row s the four bilinear corners of token s side by side
//       ((0,0), (0,+x), (+y,0), (+y,+x); an edge duplicate past the last row or
//       column). Each sample is one clamped base row of the table and four
//       slot weights, so at D == 32 one sample is ONE coalesced 512-byte row
//       load: lane l takes the float4 of corner l/8, channels 4(l%8)..4(l%8)+3, and
//       scales it by that corner's slot weight; shuffles by 8 and 16 sum the corners
//       and lanes 0-7 store the head's 32 channels as one 128-byte row.
//
// Design: one warp per (batch, head, query), queries fastest, so the warps of
// one (batch, head) run together and share that head's table slice (S * 512 B,
// 19 MB at 1000x1778 input) in L2. The TPU kernel reads a base index and four
// slot weights per sample that an XLA prologue precomputed; here the lanes compute
// them in registers from the locations and attention (the same floor, clamp to
// [0, max(W-2, 0)], equality rule and +1-slot mask as
// _merged_indices_and_slot_weights), which saves the index and weight round trip
// through device memory (20 bytes per sample against the 12 of locations and
// attention). Redesigned with B2: its first form shuffled all four slot weights and
// selected one for each sample, and its sample loop ran to a runtime bound, one
// 512-byte load consumed right after it was issued. Now lane 8c + k computes sample k
// of a batch of 8 and keeps corner c's slot weight, gather8 issues the batch's 8 row
// loads before using any, and the grid and level table are B2's. ptxas: 64 registers,
// no stack, no spills; 32 warps per SM. On an NVIDIA H100 80GB HBM3 at 700 W it takes
// 0.817 ms, as its first form did (0.812): with 8 loads in flight per warp instead of
// 1, nothing moved. It is bound by the rate of gathered table rows: with every row an L1 hit it
// takes 0.633 ms of its 0.812. A 512-byte table row serves one cell, so two samples in
// neighbouring cells share no line, where B2's 128-byte value rows are shared; B2
// reaches the same function from value faster than B5 from its table (0.79 against
// 0.81 ms, plus 0.22 ms for the table). The table is 4x the value tensor, and its build
// writes it once
// per call, which is a cost of this design and not of the function.
//
//   ms_deform_attn_merged_table  -- builds that table from value (B, S, M, D),
//       the counterpart of the dense XLA prologue the TPU kernel's caller runs
//       (gomatching_tpu/ops/deform_attn.py:_merged_corner_table). A copy bound
//       by bytes: value read once (four reads per row, three of them L2 hits)
//       and the table written once, in 512-byte rows. A torch index_select
//       computes the same table at 2.3x this byte bound on an H100 (the time
//       chip_smoke.py phase 9 prints as its library_ms).
//
// A fourth forward serves the encoder variants that stage tile footprints
// (B6a-c: ms_deform_attn_encoder_vmem, _vmem_tm, _vmem_v3 and _fused):
//
//   ms_deform_attn_footprint_fwd  -- one kernel, three input layouts; see its
//       source note below.
//
// Plain C interface, loaded with ctypes; every launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 8
#define MSDA_MAX_SAMPLES 64  // L * P per head: two samples a lane in the lane-layout kernels
#define MSDA_WARPS_PER_BLOCK 8
// resident blocks per SM the lane-layout kernels (B1, B2, B4, B5) ask of the compiler: at
// most 64 registers a thread, so that 32 warps fit on an SM
#define MSDA_FWD_MIN_BLOCKS 4
#define MSDA_FULL 0xffffffffu

struct LevelInfo {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

// (h, w, start) of level l. The loop over constant indices keeps the parameter
// struct out of local memory: indexing it with a runtime l makes every thread
// copy all 96 bytes of it to its stack first, which costs more than the whole
// work of a thread of the table build.
__device__ __forceinline__ void level_dims(const LevelInfo& lv, int l, int& h, int& w,
                                           int& start) {
  h = lv.h[0];
  w = lv.w[0];
  start = lv.start[0];
#pragma unroll
  for (int i = 1; i < MSDA_MAX_LEVELS; ++i) {
    if (i == l) {
      h = lv.h[i];
      w = lv.w[i];
      start = lv.start[i];
    }
  }
}

// The gather of the lane-layout kernels (B1, B2, B4, B5), D == 32. Lane l owns corner
// l >> 3 and channels 4(l & 7)..+3; for the 8 samples of a batch, the lanes of corner c
// (8c .. 8c + 7) hold, sample k of the batch in lane 8c + k, that corner's float4 offset
// ``row`` from ``base`` (a valid row for a corner off the map). load8 takes each lane's
// own corner's row of every sample with one shuffle and issues all 8 loads before the
// first is consumed: 8 independent 512-byte warp loads in flight.
#ifdef MSDA_GATHER_ROW0
// A measurement build (chip_smoke.py builds it with -DMSDA_GATHER_ROW0): every gathered
// row becomes row 0 of its base, an L1 hit, through a mask the compiler cannot know is
// 0, so the time left is the kernel's own work without the memory system's.
__device__ int msda_row_mask = 0;
#endif

__device__ __forceinline__ void load8(const float4* __restrict__ base, int row, int lane,
                                      float4 (&v)[8]) {
  const int grp = lane & 24;
#ifdef MSDA_GATHER_ROW0
  row &= *(volatile int*)&msda_row_mask;
#endif
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __ldg(base + __shfl_sync(MSDA_FULL, row, grp | k));
}

// The forwards' gather: load8, then each lane scales its corner's rows by that corner's
// weight ``wgt`` (attention folded in, 0 for a corner off the map), one shuffle each.
__device__ __forceinline__ void gather8(const float4* __restrict__ base, int row, float wgt,
                                        int lane, float4& acc) {
  const int grp = lane & 24;
  float4 v[8];
  load8(base, row, lane, v);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = __shfl_sync(MSDA_FULL, wgt, grp | k);
    acc.x = fmaf(w, v[k].x, acc.x);
    acc.y = fmaf(w, v[k].y, acc.y);
    acc.z = fmaf(w, v[k].z, acc.z);
    acc.w = fmaf(w, v[k].w, acc.w);
  }
}

// Sum the four corners (lanes l, l^8, l^16, l^24 hold the same channels) and store the
// head's 32 channels from lanes 0-7 as one 128-byte row.
__device__ __forceinline__ void store_corners(float4 acc, int lane, float* __restrict__ out) {
#pragma unroll
  for (int k = 8; k <= 16; k <<= 1) {
    acc.x += __shfl_xor_sync(MSDA_FULL, acc.x, k);
    acc.y += __shfl_xor_sync(MSDA_FULL, acc.y, k);
    acc.z += __shfl_xor_sync(MSDA_FULL, acc.z, k);
    acc.w += __shfl_xor_sync(MSDA_FULL, acc.w, k);
  }
  if (lane < 8) reinterpret_cast<float4*>(out)[lane] = acc;
}

// The level table on the lanes: lane k holds level (k & 7)'s (h, w, start), read from
// the parameter once with level_dims, so that any lane finds any level's dims with three
// shuffles instead of a select over every level.
struct LaneLevel {
  int h, w, start;
};

__device__ __forceinline__ LaneLevel lane_level(const LevelInfo& lv, int lane) {
  LaneLevel t;
  level_dims(lv, lane & (MSDA_MAX_LEVELS - 1), t.h, t.w, t.start);
  return t;
}

__device__ __forceinline__ LaneLevel level_of(const LaneLevel& t, int l) {
  return {__shfl_sync(MSDA_FULL, t.h, l), __shfl_sync(MSDA_FULL, t.w, l),
          __shfl_sync(MSDA_FULL, t.start, l)};
}

// i / P for 0 <= i < 64 and 1 <= P <= 64 without a division per use:
// (i * level_magic(P)) >> 16, exact because i * (ceil(2^16 / P) - 2^16 / P) < 2^16 / P.
__device__ __forceinline__ int level_magic(int P) { return (65536 + P - 1) / P; }

// The encoder's query token s: its reference point ((col + 0.5) / W, (row + 0.5) / H) on
// its own level.
__device__ __forceinline__ float2 token_ref(const LevelInfo& lv, const LaneLevel& levels, int s,
                                            int L) {
  int l1 = 0;
#pragma unroll
  for (int i = 1; i < MSDA_MAX_LEVELS; ++i) l1 += (i < L && s >= lv.start[i]);
  const LaneLevel q = level_of(levels, l1);
  const int t = s - q.start;
  const int qrow = t / q.w;
  const int qcol = t - qrow * q.w;
  return make_float2(((float)qcol + 0.5f) / (float)q.w, ((float)qrow + 0.5f) / (float)q.h);
}

// A warp's L*P <= 64 samples, lane j holding sample j's (and j + 32's) coordinate pair and
// weight: the pair and the weight are each one coalesced load for the warp.
struct Samples {
  float2 xy0, xy1;
  float a0, a1;
};

__device__ __forceinline__ Samples load_samples(const float* __restrict__ xy,
                                                const float* __restrict__ a, int LP, int lane,
                                                float fill) {
  const float2* xy2 = reinterpret_cast<const float2*>(xy);
  const float2 zero = make_float2(0.f, 0.f);
  return {lane < LP ? __ldg(xy2 + lane) : zero, lane + 32 < LP ? __ldg(xy2 + lane + 32) : zero,
          lane < LP ? __ldg(a + lane) : fill, lane + 32 < LP ? __ldg(a + lane + 32) : fill};
}

// The softmax of the logits in a0, a1 (-inf past L*P) over the warp, in place: max and sum
// by shuffles, one expf per sample. Every lane ends with the same sum, bit for bit.
__device__ __forceinline__ void lane_softmax(Samples& sm, int LP, int lane) {
  float mx = fmaxf(sm.a0, sm.a1);
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) mx = fmaxf(mx, __shfl_xor_sync(MSDA_FULL, mx, k));
  const float e0 = lane < LP ? expf(sm.a0 - mx) : 0.f;
  const float e1 = lane + 32 < LP ? expf(sm.a1 - mx) : 0.f;
  float sum = e0 + e1;
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) sum += __shfl_xor_sync(MSDA_FULL, sum, k);
  const float inv_sum = 1.f / sum;
  sm.a0 = e0 * inv_sum;
  sm.a1 = e1 * inv_sum;
}

// One bilinear corner of one sample: its float4 row offset from the head's base (0, a
// valid row, for a corner off the map), whether it lies in the map, and the fractional
// position (fx, fy) in the sample's cell.
struct Corner {
  int row;
  bool in;
  float fx, fy;
};

// Sample i = i0 + (lane & 7) of a batch of 8 for corner ((lane >> 3) & 1, lane >> 4): its
// coordinates and weight come from lane i & 31 by shuffle (register 0 or 1 by i0, which is
// warp-uniform), its level's dims from the lane-held table (level i / P). CELLS: the
// coordinates are offsets in target-level cells from the reference point (rx, ry), in the
// reference's order (loc = ref + off / (W, H), then x = loc * W - 0.5); else normalized
// locations (x = loc * W - 0.5). x and y are clamped where every corner is off the map
// anyway, so the int casts are safe. ``a`` gets the sample's weight.
template <bool CELLS>
__device__ __forceinline__ Corner sample_corner(int i0, int lane, int LP, int magic,
                                                const LaneLevel& levels, const Samples& sm,
                                                float2 ref, int tok4, float& a) {
  const int i = i0 + (lane & 7);
  const int src = i & 31;
  const float ox = __shfl_sync(MSDA_FULL, i0 < 32 ? sm.xy0.x : sm.xy1.x, src);
  const float oy = __shfl_sync(MSDA_FULL, i0 < 32 ? sm.xy0.y : sm.xy1.y, src);
  a = __shfl_sync(MSDA_FULL, i0 < 32 ? sm.a0 : sm.a1, src);
  const LaneLevel lvl = level_of(levels, min((i * magic) >> 16, MSDA_MAX_LEVELS - 1));
  Corner c = {0, false, 0.f, 0.f};
  if (i < LP) {
    const int h = lvl.h, w = lvl.w;
    const float wf = (float)w;
    const float hf = (float)h;
    float x, y;
    if (CELLS) {
      const float lx = ref.x + ox / wf;
      const float ly = ref.y + oy / hf;
      x = lx * wf - 0.5f;
      y = ly * hf - 0.5f;
    } else {
      x = ox * wf - 0.5f;
      y = oy * hf - 0.5f;
    }
    x = fminf(fmaxf(x, -2.f), wf + 1.f);
    y = fminf(fmaxf(y, -2.f), hf + 1.f);
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    c.fx = x - x0;
    c.fy = y - y0;
    const int xc = (int)x0 + ((lane >> 3) & 1);
    const int yc = (int)y0 + (lane >> 4);
    if (xc >= 0 && xc < w && yc >= 0 && yc < h) {
      c.in = true;
      c.row = (lvl.start + yc * w + xc) * tok4;
    }
  }
  return c;
}

// The bilinear weight of this lane's corner of the sample.
__device__ __forceinline__ float corner_weight(const Corner& c, int lane) {
  return ((lane >> 4) ? c.fy : 1.f - c.fy) * (((lane >> 3) & 1) ? c.fx : 1.f - c.fx);
}

// The sampling loop of the forwards: batches of 8 samples, the next batch's geometry
// computed while this batch's loads are in flight; ``geometry(i0, row, wgt)`` gives this
// lane's corner of sample i0 + (lane & 7).
template <typename Geometry>
__device__ __forceinline__ float4 sample_loop(const float4* __restrict__ base, int LP, int lane,
                                              Geometry geometry) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int row;
  float wgt;
  geometry(0, row, wgt);
  for (int i0 = 0; i0 < LP; i0 += 8) {
    int row_n = 0;
    float wgt_n = 0.f;
    if (i0 + 8 < LP) geometry(i0 + 8, row_n, wgt_n);
    gather8(base, row, wgt, lane, acc);
    row = row_n;
    wgt = wgt_n;
  }
  return acc;
}

// value (B, S, M, 32); loc (B, Lq, M, L, P, 2) normalized; attn (B, Lq, M, L*P) softmaxed;
// out (B, Lq, M*32). B2's design on normalized locations: blockIdx.y is the (batch, head)
// pair and warp w of block x takes query 8x + w, so the warps of a block sample one head
// around neighbouring queries (the 25 points of one text instance are neighbours). L*P <= 64.
__global__ void __launch_bounds__(32 * MSDA_WARPS_PER_BLOCK, MSDA_FWD_MIN_BLOCKS)
ms_deform_attn_queries_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                              const float* __restrict__ attn, float* __restrict__ out,
                              LevelInfo lv, int S, int Lq, int M, int L, int P) {
  const int q = blockIdx.x * MSDA_WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= Lq) return;
  const int m = blockIdx.y % M;
  const int b = blockIdx.y / M;
  const LaneLevel levels = lane_level(lv, lane);
  const int LP = L * P;
  const int64_t bqm = ((int64_t)b * Lq + q) * M + m;
  const Samples sm = load_samples(loc + bqm * LP * 2, attn + bqm * LP, LP, lane, 0.f);
  const int tok4 = M * 8;  // float4s per token
  const int magic = level_magic(P);
  const float4* base = reinterpret_cast<const float4*>(value + ((int64_t)b * S * M + m) * 32) +
                       (lane & 7);
  const float4 acc = sample_loop(base, LP, lane, [&](int i0, int& row, float& wgt) {
    float a;
    const Corner c =
        sample_corner<false>(i0, lane, LP, magic, levels, sm, make_float2(0.f, 0.f), tok4, a);
    row = c.row;
    wgt = c.in ? a * corner_weight(c, lane) : 0.f;
  });
  store_corners(acc, lane, out + bqm * 32);
}

// value (B, S, M, 32); off (B, S, M, L, P, 2) raw target-level cells;
// logits (B, S, M, L*P); out (B, S, M*32). blockIdx.y is the (batch, head) pair and
// warp w of block x takes token 8x + w: warps in (b, m, s) order, tokens fastest, so
// the warps of one block sample one head around neighbouring tokens, and no lane
// divides 64-bit indices. L*P <= 64.
__global__ void __launch_bounds__(32 * MSDA_WARPS_PER_BLOCK, MSDA_FWD_MIN_BLOCKS)
ms_deform_attn_encoder_kernel(const float* __restrict__ value, const float* __restrict__ off,
                              const float* __restrict__ logits, float* __restrict__ out,
                              LevelInfo lv, int S, int M, int L, int P) {
  const int s = blockIdx.x * MSDA_WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= S) return;
  const int m = blockIdx.y % M;
  const int b = blockIdx.y / M;
  const LaneLevel levels = lane_level(lv, lane);
  const float2 ref = token_ref(lv, levels, s, L);
  const int LP = L * P;
  const int64_t bsm = ((int64_t)b * S + s) * M + m;
  Samples sm = load_samples(off + bsm * LP * 2, logits + bsm * LP, LP, lane,
                            __int_as_float(0xff800000));  // -inf
  lane_softmax(sm, LP, lane);
  const int tok4 = M * 8;
  const int magic = level_magic(P);
  const float4* base = reinterpret_cast<const float4*>(value + ((int64_t)b * S * M + m) * 32) +
                       (lane & 7);
  const float4 acc = sample_loop(base, LP, lane, [&](int i0, int& row, float& wgt) {
    float a;
    const Corner c = sample_corner<true>(i0, lane, LP, magic, levels, sm, ref, tok4, a);
    row = c.row;
    wgt = c.in ? a * corner_weight(c, lane) : 0.f;
  });
  store_corners(acc, lane, out + bsm * 32);
}

// Lane 8c + j holds p[k] = its channels' share of corner c's dot for sample k of the batch
// (k < 8); returns, on lane 8c + k, the sum of p[k] over the 8 lanes of corner c: a
// reduce-scatter by xor 4, 2, 1 in 7 shuffles, in a fixed order.
__device__ __forceinline__ float reduce_scatter8(float (&p)[8], int lane) {
#pragma unroll
  for (int half = 4; half >= 1; half >>= 1) {
    const bool upper = lane & half;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float send = upper ? p[j] : p[j + half];
      const float keep = upper ? p[j + half] : p[j];
      p[j] = keep + __shfl_xor_sync(MSDA_FULL, send, half);
    }
  }
  return p[0];
}

// The scatter weights of a batch's corners with the corners that share a row merged:
// lane 8c + k holds corner c of sample k, its row and its weight (0 off the map). Lanes
// are grouped by row (__match_any_sync); the lowest lane of a group gets the group's sum
// and the others 0, so that a row gets one atomic per batch. A batch with no shared row
// skips the sum.
__device__ __forceinline__ float merge_shared_rows(int row, bool in, float wgt, int lane) {
  const unsigned peers = __match_any_sync(MSDA_FULL, in ? row : -1);
  if (!__any_sync(MSDA_FULL, in && peers != (1u << lane))) return wgt;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float wj = __shfl_sync(MSDA_FULL, wgt, j);
    if ((peers >> j) & 1u) sum += wj;
  }
  return in && __ffs(peers) - 1 == lane ? sum : 0.f;
}

// B2's VJP. value/off/logits as the forward; dout (B, S, M*32); dvalue (B, S, M, 32) zeroed
// by the caller; doff (B, S, M, L, P, 2) in cells; dlogits (B, S, M, L*P). B2's grid, level
// table, softmax and geometry (the same samples land in the same cells as in the
// forward). Lane l keeps dOut's channels 4(l & 7)..+3 for the whole warp. Per batch of 8
// samples, lane 8c + k holds corner c of sample k; each lane adds a_k w_ck dOut to its
// corner's in-map row of every sample with one float4 atomic, gathers those rows (load8)
// and forms its 4-channel share of dot(dOut, v_ck); a reduce-scatter leaves the whole dot
// of (c, k) on lane 8c + k, where it meets the corner's weight and derivative weights, and
// shuffles by 8 and 16 sum the corners: dA_k, and gx_k, gy_k (d/dx, d/dy of the sample;
// x is in cells, so d x / d off = 1). The lane of sample i0 + k stores dOffsets_k = a_k
// (gx_k, gy_k) and keeps dA_k, and the softmax backward runs on the lanes:
// dLogits_j = a_j (dA_j - sum_i a_i dA_i).
__global__ void __launch_bounds__(32 * MSDA_WARPS_PER_BLOCK, MSDA_FWD_MIN_BLOCKS)
ms_deform_attn_encoder_bwd_kernel(const float* __restrict__ value, const float* __restrict__ off,
                                  const float* __restrict__ logits,
                                  const float* __restrict__ dout, float* __restrict__ dvalue,
                                  float* __restrict__ doff, float* __restrict__ dlogits,
                                  LevelInfo lv, int S, int M, int L, int P) {
  const int s = blockIdx.x * MSDA_WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= S) return;
  const int m = blockIdx.y % M;
  const int b = blockIdx.y / M;
  const LaneLevel levels = lane_level(lv, lane);
  const float2 ref = token_ref(lv, levels, s, L);
  const int LP = L * P;
  const int64_t bsm = ((int64_t)b * S + s) * M + m;
  Samples sm = load_samples(off + bsm * LP * 2, logits + bsm * LP, LP, lane,
                            __int_as_float(0xff800000));  // -inf
  lane_softmax(sm, LP, lane);
  const float4 g = __ldg(reinterpret_cast<const float4*>(dout + bsm * 32) + (lane & 7));
  const int tok4 = M * 8;
  const int magic = level_magic(P);
  const int64_t head = ((int64_t)b * S * M + m) * 32;
  const float4* base = reinterpret_cast<const float4*>(value + head) + (lane & 7);
  float4* dbase = reinterpret_cast<float4*>(dvalue + head) + (lane & 7);
  const int grp = lane & 24;
  const bool cx = (lane >> 3) & 1;
  const bool cy = lane >> 4;
  float2* doff2 = reinterpret_cast<float2*>(doff + bsm * LP * 2);
  float dA0 = 0.f, dA1 = 0.f;
  for (int i0 = 0; i0 < LP; i0 += 8) {
    float a;
    const Corner c = sample_corner<true>(i0, lane, LP, magic, levels, sm, ref, tok4, a);
#ifndef MSDA_NO_SCATTER
    // dValue first: the atomics are issued before the loads, so that neither waits on the
    // other and their operands are dead before the 8 rows arrive (issued after the loads,
    // they spill). A measurement build (chip_smoke.py builds it with -DMSDA_NO_SCATTER)
    // skips these atomics and nothing else.
    const float wgt =
        merge_shared_rows(c.row, c.in, c.in ? a * corner_weight(c, lane) : 0.f, lane);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float wk = __shfl_sync(MSDA_FULL, wgt, grp | k);
      const int rk = __shfl_sync(MSDA_FULL, c.row, grp | k);
      if (wk != 0.f) atomicAdd(dbase + rk, make_float4(wk * g.x, wk * g.y, wk * g.z, wk * g.w));
    }
#endif
    float4 v[8];
    load8(base, c.row, lane, v);
    float p[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      p[k] = fmaf(g.w, v[k].w, fmaf(g.z, v[k].z, fmaf(g.y, v[k].y, g.x * v[k].x)));
    const float dot = reduce_scatter8(p, lane);
    // the corner's weight and its derivatives in x and y, all 0 for a corner off the map:
    // its row is the valid one it was clamped to, whose dot must add nothing
    const float wx = cx ? c.fx : 1.f - c.fx;
    const float wy = cy ? c.fy : 1.f - c.fy;
    float tA = c.in ? wy * wx * dot : 0.f;
    float tx = c.in ? (cx ? wy : -wy) * dot : 0.f;
    float ty = c.in ? (cy ? wx : -wx) * dot : 0.f;
#pragma unroll
    for (int k = 8; k <= 16; k <<= 1) {
      tA += __shfl_xor_sync(MSDA_FULL, tA, k);
      tx += __shfl_xor_sync(MSDA_FULL, tx, k);
      ty += __shfl_xor_sync(MSDA_FULL, ty, k);
    }
    // the lane of sample i = i0 + (lane & 7) keeps dA_i and stores dOffsets_i
    const int i = i0 + (lane & 7);
    if ((lane >> 3) == ((i0 >> 3) & 3) && i < LP) {
      const float ai = i0 < 32 ? sm.a0 : sm.a1;
      doff2[i] = make_float2(ai * tx, ai * ty);
      if (i0 < 32)
        dA0 = tA;
      else
        dA1 = tA;
    }
  }
  float sdot = sm.a0 * dA0 + sm.a1 * dA1;
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) sdot += __shfl_xor_sync(MSDA_FULL, sdot, k);
  float* dlg = dlogits + bsm * LP;
  if (lane < LP) dlg[lane] = sm.a0 * (dA0 - sdot);
  if (lane + 32 < LP) dlg[lane + 32] = sm.a1 * (dA1 - sdot);
}

// ---------------------------------------------------------------------------
// B3, in its first form (one warp per (batch, query, head), lanes on the channels).

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

// The backward of one (batch, query, head) warp over its L*P samples (B3; B4 had the
// same layout before its redesign): writes dLoc (in units of ``loc_scale`` per pixel: W, H for
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

// Slot weights of one axis (_merged_indices_and_slot_weights :103-111): the true
// corners c0 (weight 1 - f) and c0 + 1 (weight f) land on slot 0 or 1 of the
// window anchored at ``base``; a corner off the map matches no slot, and slot 1
// is dropped when it lies past the level's edge (size 1: it holds a duplicate).
__device__ __forceinline__ void axis_slots(float c0, float f, float base, float size,
                                           float& w_lo, float& w_hi) {
  w_lo = (base == c0 ? 1.f - f : 0.f) + (base == c0 + 1.f ? f : 0.f);
  w_hi = (base + 1.f == c0 ? 1.f - f : 0.f) + (base + 1.f == c0 + 1.f ? f : 0.f);
  if (!(base + 1.f <= size - 1.f)) w_hi = 0.f;
}

// table (B, M, S, 4*32); loc (B, Lq, M, L, P, 2); attn (B, Lq, M, L, P);
// out (B, Lq, M*32). blockIdx.y is the (batch, head) pair and warp w of block x takes
// query 8x + w, as in B2. L*P <= 64.
__global__ void __launch_bounds__(32 * MSDA_WARPS_PER_BLOCK, MSDA_FWD_MIN_BLOCKS)
ms_deform_attn_merged_kernel(const float* __restrict__ table, const float* __restrict__ loc,
                             const float* __restrict__ attn, float* __restrict__ out,
                             LevelInfo lv, int S, int Lq, int M, int L, int P) {
  const int q = blockIdx.x * MSDA_WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= Lq) return;
  const int bm = blockIdx.y;
  const int m = bm % M;
  const int b = bm / M;
  const LaneLevel levels = lane_level(lv, lane);
  const int magic = level_magic(P);
  const int LP = L * P;
  const int64_t bqm = ((int64_t)b * Lq + q) * M + m;
  const float2* loc_w = reinterpret_cast<const float2*>(loc + bqm * LP * 2);
  const float* attn_w = attn + bqm * LP;
  const int cx = (lane >> 3) & 1;
  const int cy = lane >> 4;
  // per sample, on the lane of each corner: the base row (the same for the four
  // corners: float4 offset row * 32) and this corner's slot weight
  auto geometry = [&](int i0, int& row, float& wgt) {
    const int i = i0 + (lane & 7);
    const LaneLevel lvl = level_of(levels, min((i * magic) >> 16, MSDA_MAX_LEVELS - 1));
    row = 0;
    wgt = 0.f;
    if (i < LP) {
      const int w = lvl.w, start = lvl.start;
      const float wf = (float)w;
      const float hf = (float)lvl.h;
      const float2 xy = __ldg(loc_w + i);
      const float x = xy.x * wf - 0.5f;
      const float y = xy.y * hf - 0.5f;
      const float x0 = floorf(x);
      const float y0 = floorf(y);
      const float bx = fminf(fmaxf(x0, 0.f), fmaxf(wf - 2.f, 0.f));
      const float by = fminf(fmaxf(y0, 0.f), fmaxf(hf - 2.f, 0.f));
      float wx0, wx1, wy0, wy1;
      axis_slots(x0, x - x0, bx, wf, wx0, wx1);
      axis_slots(y0, y - y0, by, hf, wy0, wy1);
      wgt = (cy ? wy1 : wy0) * (cx ? wx1 : wx0) * __ldg(attn_w + i);
      row = (start + (int)by * w + (int)bx) * 32;
    }
  };

  const float4* base = reinterpret_cast<const float4*>(table + bm * (int64_t)S * 128) + lane;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int row;
  float wgt;
  geometry(0, row, wgt);
  for (int i0 = 0; i0 < LP; i0 += 8) {
    int row_n = 0;
    float wgt_n = 0.f;
    if (i0 + 8 < LP) geometry(i0 + 8, row_n, wgt_n);
    gather8(base, row, wgt, lane, acc);
    row = row_n;
    wgt = wgt_n;
  }
  store_corners(acc, lane, out + bqm * 32);
}

// value (B, S, M, 32) -> table (B, M, S, 4*32): one warp per table row, lane j
// on the float4 j of the row (corner j/8, channels 4(j%8)..+3), so the warp
// writes one 512-byte row and reads four 128-byte value rows. blockIdx.y is the
// (batch, head) pair and each block covers MSDA_WARPS_PER_BLOCK consecutive
// tokens, so no lane divides 64-bit indices.
__global__ void ms_deform_attn_merged_table_kernel(const float* __restrict__ value,
                                                   float* __restrict__ table, LevelInfo lv,
                                                   int S, int M, int L) {
  const int s = blockIdx.x * MSDA_WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (s >= S) return;
  const int j = threadIdx.x & 31;
  const int bm = blockIdx.y;
  const int m = bm % M;
  const int b = bm / M;
  int l = 0;
#pragma unroll
  for (int i = 1; i < MSDA_MAX_LEVELS; ++i) l += (i < L && s >= lv.start[i]);
  int h, w, start;
  level_dims(lv, l, h, w, start);
  const int k = s - start;
  const int y = k / w;
  const int x = k - y * w;
  const int corner = j >> 3;  // (0,0), (0,+x), (+y,0), (+y,+x); edge duplicates
  const int yy = min(y + (corner >> 1), h - 1);
  const int xx = min(x + (corner & 1), w - 1);
  const int64_t tok = (int64_t)b * S + start + yy * w + xx;
  const float4* src = reinterpret_cast<const float4*>(value + (tok * M + m) * 32);
  reinterpret_cast<float4*>(table + ((int64_t)bm * S + s) * 128)[j] = __ldg(src + (j & 7));
}

// ---------------------------------------------------------------------------
// Encoder sampling through tile footprints in shared memory (B6a, B6b, B6c).
//
//   ms_deform_attn_footprint_fwd -- replaces gomatching_tpu/ops/deform_attn_vmem.py:
//       _kernel (:896, entries ms_deform_attn_encoder_vmem and
//       ms_deform_attn_encoder_vmem_tm), _kernel_v3 (:724, entry
//       ms_deform_attn_encoder_vmem_v3) and gomatching_tpu/ops/deform_attn_fused.py:
//       _kernel (:54, entry ms_deform_attn_encoder_fused).
//
// Encoder self-attention (every token is a query). Each TPU kernel stages, for a tile
// of queries, a footprint of every target level (the tile's reference region plus a
// halo) in VMEM, contracts a one-hot G against it on the MXU and drops the samples
// beyond it. Here the footprint is a cache: a corner inside the staged footprint is
// read from shared memory, any other corner from device memory, so the result is
// exact (grid_sample semantics: corners off the map contribute zero) whatever the halo.
//
// Design. One block (8 warps) per (query chunk, batch, head): blockIdx.x runs over
// the chunks of up to FP_QCHUNK queries of the query tiles of all source levels,
// fastest, so that the blocks of one (batch, head) run together and share that
// head's value rows in L2. A host-built table (the counterpart of the TPU's
// scalar-prefetched origin table) gives each block its source level, tile origin and
// width, chunk, first slot, and per target level the footprint origin and extent,
// or zeros when the footprint is over the shared-memory budget (the direct route:
// every corner from device memory, as in B1). The block first writes its queries'
// geometry into shared memory -- x and y in target-level pixels and the attention
// per (level, point) -- from coalesced rows of the tile-major layouts or, in the
// natural layout, with lane l on word l of a query's locations. Then per target
// level it copies the staged footprint (Fh * Fw rows of 32 floats, one float4 per
// thread, zeros off the map) into shared memory, and each warp takes its queries
// one at a time with lanes on the channels, accumulating in registers in B1's order
// (level, point, corner). The table is read with runtime indices from device memory
// and the level dims from it, so no parameter struct is copied to the stack.
//
// What bounds it: the function is bound by bytes, as B2's (the value rows the corners
// touch, locations, attention and output once: 0.119 ms for a 1000x1778 frame batch of
// 3 on an H100). This kernel is bound by the latency of each warp's chain of samples:
// shared memory and registers hold 16 warps per SM, each taking 16 queries in series.
// Staging shortens that chain (on an H100 at halo 5 it is 1.2-1.5x faster than the
// same kernel with every pair direct), but a warp per query at full occupancy (B1)
// is faster still. Simple first: no cp.async, no TMA, one footprint staged at a time.

#define FP_QCHUNK 128                      // queries of one block
#define FP_GEO_STRIDE (FP_QCHUNK + 1)      // +1: one query's rows fall in distinct banks
#define FP_QPW (FP_QCHUNK / MSDA_WARPS_PER_BLOCK)
#define FP_REC_HEAD 8

// Input layouts: loc (B,S,M,L,P,2) + attn (B,S,M,L,P); locT (B,M,L,P,2,Sq) + attnT
// (B,M,L,P,Sq); offT (B,2LMP,Sq) rows (l,xy,m,p) in target cells + attnT (B,LMP,Sq)
// rows (l,m,p), reference point from the slot's tile row and column.
enum FootprintGeometry { NATURAL_LOC = 0, TM_LOC = 1, TM_OFF_CELLS = 2 };

// The value of one corner for this lane's channel: from the staged footprint ``fp``
// (cells of 32 floats, row-major over (Fh, Fw)) when (fy, fx) lies inside it, else
// from device memory. ``fh == 0`` (the direct route) always reads device memory.
__device__ __forceinline__ float fp_corner(const float* __restrict__ fp,
                                           const float* __restrict__ v, int w,
                                           int64_t tok_stride, int fh, int fw, int y, int x,
                                           int fy, int fx) {
  if ((unsigned)fy < (unsigned)fh && (unsigned)fx < (unsigned)fw) return fp[(fy * fw + fx) * 32];
  return __ldg(v + ((int64_t)y * w + x) * tok_stride);
}

// The bilinear sample of this lane's channel at pixel coordinates (x, y) (x = loc * W -
// 0.5; corners off the map contribute zero), with the footprint cache: (oy, ox) is the
// footprint's origin.
__device__ __forceinline__ float fp_tap(const float* __restrict__ fp, const float* __restrict__ v,
                                        int h, int w, int64_t tok_stride, int oy, int ox,
                                        int fh, int fw, float x, float y) {
  if (!(x > -1.f && y > -1.f && x < (float)w && y < (float)h)) return 0.f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const float dx = x - x0f;
  const float dy = y - y0f;
  const float hx = 1.f - dx;
  const float hy = 1.f - dy;
  const int fx = x0 - ox;
  const int fy = y0 - oy;
  float acc = 0.f;
  if (y0 >= 0) {
    if (x0 >= 0) acc += hy * hx * fp_corner(fp, v, w, tok_stride, fh, fw, y0, x0, fy, fx);
    if (x0 + 1 < w) acc += hy * dx * fp_corner(fp, v, w, tok_stride, fh, fw, y0, x0 + 1, fy, fx + 1);
  }
  if (y0 + 1 < h) {
    if (x0 >= 0) acc += dy * hx * fp_corner(fp, v, w, tok_stride, fh, fw, y0 + 1, x0, fy + 1, fx);
    if (x0 + 1 < w)
      acc += dy * dx * fp_corner(fp, v, w, tok_stride, fh, fw, y0 + 1, x0 + 1, fy + 1, fx + 1);
  }
  return acc;
}

// The grid cell (r, c) of in-tile query qt of a tile at (ty0, tx0) of width tx;
// false for the padding slots past the level's edge.
__device__ __forceinline__ bool tile_cell(int qt, int ty0, int tx0, int tx, int H1, int W1,
                                          int& r, int& c) {
  const int row = qt / tx;
  r = ty0 + row;
  c = tx0 + qt - row * tx;
  return r < H1 && c < W1;
}

// value (B,S,M,32); a/b the layout's locations (or offsets) and attention; table as
// Footprints (ops/deform_attn_vmem.py); out (B,S,M*32) natural or, for TM_OFF_CELLS,
// (B,Sq,M*32) tile-major. Dynamic shared memory: the geometry (3*L*P rows of
// FP_GEO_STRIDE floats, rounded up to float4s), then the largest staged footprint.
template <int GEOM>
__global__ void __launch_bounds__(32 * MSDA_WARPS_PER_BLOCK)
ms_deform_attn_footprint_kernel(const float* __restrict__ value, const float* __restrict__ a,
                                const float* __restrict__ bt, const int* __restrict__ table,
                                float* __restrict__ out, int S, int M, int L, int P, int Sq) {
  extern __shared__ float4 smem4[];
  float* geo = reinterpret_cast<float*>(smem4);
  const int LP = L * P;
  float* fp = geo + ((3 * LP * FP_GEO_STRIDE + 3) & ~3);
  const int b = blockIdx.y;
  const int m = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int* rec = table + 4 * L + (int64_t)blockIdx.x * (FP_REC_HEAD + 4 * L);
  const int l1 = __ldg(rec);
  const int ty0 = __ldg(rec + 1);
  const int tx0 = __ldg(rec + 2);
  const int tx = __ldg(rec + 3);
  const int q0 = __ldg(rec + 4);
  const int nq = __ldg(rec + 5);
  const int slot0 = __ldg(rec + 6) + q0;  // slot of the chunk's first query
  const int H1 = __ldg(table + 4 * l1);
  const int W1 = __ldg(table + 4 * l1 + 1);
  const int start1 = __ldg(table + 4 * l1 + 2);
  const int64_t tok_stride = (int64_t)M * 32;

  // 1. the chunk's geometry: row (l2*P + p)*3 + {x, y, attention}, queries minor
  if (GEOM == NATURAL_LOC) {
    for (int q = warp; q < nq; q += MSDA_WARPS_PER_BLOCK) {
      int r, c;
      if (!tile_cell(q0 + q, ty0, tx0, tx, H1, W1, r, c)) continue;
      const int64_t bsm = ((int64_t)b * S + start1 + r * W1 + c) * M + m;
      for (int w = lane; w < 2 * LP; w += 32) {
        const int i = w >> 1;
        const int xy = w & 1;
        const float size = (float)__ldg(table + 4 * (i / P) + 1 - xy);  // W for x, H for y
        geo[(i * 3 + xy) * FP_GEO_STRIDE + q] = __ldg(a + bsm * 2 * LP + w) * size - 0.5f;
      }
      for (int i = lane; i < LP; i += 32)
        geo[(i * 3 + 2) * FP_GEO_STRIDE + q] = __ldg(bt + bsm * LP + i);
    }
  } else {
    const int64_t bm = (int64_t)b * M + m;
    for (int k = tid; k < 2 * LP * nq; k += blockDim.x) {
      const int w = k / nq;  // (l2, p, xy)
      const int q = k - w * nq;
      const int i = w >> 1;
      const int xy = w & 1;
      const int l2 = i / P;
      const float size = (float)__ldg(table + 4 * l2 + 1 - xy);
      float g;
      if (GEOM == TM_LOC) {
        g = __ldg(a + (bm * 2 * LP + w) * Sq + slot0 + q) * size - 0.5f;
      } else {
        // the reference point in target pixels, as _kernel_v3 :763-764, plus the offset
        const int p = i - l2 * P;
        const int qt = q0 + q;
        const int row = qt / tx;
        const float s = size / (float)(xy ? H1 : W1);
        const float ref = ((float)(xy ? ty0 : tx0) + 0.5f) * s - 0.5f + (float)(xy ? row : qt - row * tx) * s;
        const int64_t orow = (int64_t)b * 2 * LP * M + ((l2 * 2 + xy) * M + m) * P + p;
        g = ref + __ldg(a + orow * Sq + slot0 + q);
      }
      geo[(i * 3 + xy) * FP_GEO_STRIDE + q] = g;
    }
    for (int k = tid; k < LP * nq; k += blockDim.x) {
      const int i = k / nq;  // (l2, p)
      const int q = k - i * nq;
      int64_t arow;
      if (GEOM == TM_LOC) {
        arow = bm * LP + i;
      } else {
        const int l2 = i / P;
        arow = (int64_t)b * LP * M + (l2 * M + m) * P + (i - l2 * P);
      }
      geo[(i * 3 + 2) * FP_GEO_STRIDE + q] = __ldg(bt + arow * Sq + slot0 + q);
    }
  }
  __syncthreads();

  // 2. per target level: stage the footprint if it has one, then sample
  float acc[FP_QPW];
#pragma unroll
  for (int j = 0; j < FP_QPW; ++j) acc[j] = 0.f;
  for (int l2 = 0; l2 < L; ++l2) {
    const int h = __ldg(table + 4 * l2);
    const int w = __ldg(table + 4 * l2 + 1);
    const int start = __ldg(table + 4 * l2 + 2);
    const int* f = rec + FP_REC_HEAD + 4 * l2;
    const int oy = __ldg(f);
    const int ox = __ldg(f + 1);
    const int fh = __ldg(f + 2);
    const int fw = __ldg(f + 3);
    const float* vb = value + (((int64_t)b * S + start) * M + m) * 32;
    if (fh > 0) {
      __syncthreads();  // every warp is done with the previous footprint
      for (int k = tid; k < fh * fw * 8; k += blockDim.x) {
        const int cell = k >> 3;
        const int fy = cell / fw;
        const int y = oy + fy;
        const int x = ox + cell - fy * fw;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (y < h && x < w)
          v = __ldg(reinterpret_cast<const float4*>(vb + ((int64_t)y * w + x) * tok_stride) + (k & 7));
        reinterpret_cast<float4*>(fp)[k] = v;
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < FP_QPW; ++j) {
      const int q = j * MSDA_WARPS_PER_BLOCK + warp;
      int r, c;
      if (q < nq && (GEOM == TM_OFF_CELLS || tile_cell(q0 + q, ty0, tx0, tx, H1, W1, r, c))) {
        for (int p = 0; p < P; ++p) {
          const float* g = geo + (l2 * P + p) * 3 * FP_GEO_STRIDE + q;
          acc[j] += g[2 * FP_GEO_STRIDE] * fp_tap(fp + lane, vb + lane, h, w, tok_stride, oy, ox,
                                                  fh, fw, g[0], g[FP_GEO_STRIDE]);
        }
      }
    }
  }

  // 3. one 128-byte row per query: natural token, or the slot (TM_OFF_CELLS)
#pragma unroll
  for (int j = 0; j < FP_QPW; ++j) {
    const int q = j * MSDA_WARPS_PER_BLOCK + warp;
    if (q >= nq) continue;
    int64_t row;
    if (GEOM == TM_OFF_CELLS) {
      row = (int64_t)b * Sq + slot0 + q;
    } else {
      int r, c;
      if (!tile_cell(q0 + q, ty0, tx0, tx, H1, W1, r, c)) continue;
      row = (int64_t)b * S + start1 + r * W1 + c;
    }
    out[row * tok_stride + m * 32 + lane] = acc[j];
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

// The limits of the lane-layout kernels B1, B2 and B4 (ops/deform_attn.py check_lane_layout
// raises on the same): D == 32, one float4 per lane and corner; at most two samples a lane;
// the (batch, head) pairs within gridDim.y; the float4 index of every token row of one batch
// item in int.
static bool lane_layout_ok(int B, int S, int M, int D, int L, int P) {
  return L >= 1 && L <= MSDA_MAX_LEVELS && D == 32 && P >= 1 && L * P <= MSDA_MAX_SAMPLES &&
         (int64_t)B * M <= 65535 && (int64_t)S * M * 8 <= INT32_MAX;
}

extern "C" int ms_deform_attn_queries_fwd(const float* value, const float* loc,
                                          const float* attn, float* out, const int* shapes,
                                          int B, int S, int Lq, int M, int D, int L, int P,
                                          void* stream) {
  if (!lane_layout_ok(B, S, M, D, L, P)) return (int)cudaErrorInvalidValue;
  if (B * M == 0 || Lq == 0) return (int)cudaSuccess;
  const dim3 grid((Lq + MSDA_WARPS_PER_BLOCK - 1) / MSDA_WARPS_PER_BLOCK, B * M);
  ms_deform_attn_queries_kernel<<<grid, 32 * MSDA_WARPS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      value, loc, attn, out, make_levels(shapes, L), S, Lq, M, L, P);
  return (int)cudaGetLastError();
}

extern "C" int ms_deform_attn_encoder_fwd(const float* value, const float* off,
                                          const float* logits, float* out, const int* shapes,
                                          int B, int S, int M, int D, int L, int P,
                                          void* stream) {
  if (!lane_layout_ok(B, S, M, D, L, P)) return (int)cudaErrorInvalidValue;
  if (B * M == 0 || S == 0) return (int)cudaSuccess;
  const dim3 grid((S + MSDA_WARPS_PER_BLOCK - 1) / MSDA_WARPS_PER_BLOCK, B * M);
  ms_deform_attn_encoder_kernel<<<grid, 32 * MSDA_WARPS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      value, off, logits, out, make_levels(shapes, L), S, M, L, P);
  return (int)cudaGetLastError();
}

// What the runtime made of a lane-layout kernel (which: 0 B1, 1 B2, 2 B4, 3 B5): info[0]
// registers a thread, info[1] local memory a thread in bytes (stack and spills), info[2]
// resident blocks of 32 * MSDA_WARPS_PER_BLOCK threads per SM.
extern "C" int ms_deform_attn_kernel_info(int which, int* info) {
  const void* fns[] = {(const void*)ms_deform_attn_queries_kernel,
                       (const void*)ms_deform_attn_encoder_kernel,
                       (const void*)ms_deform_attn_encoder_bwd_kernel,
                       (const void*)ms_deform_attn_merged_kernel};
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fns[which]);
  if (e != cudaSuccess) return (int)e;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], fns[which],
                                                    32 * MSDA_WARPS_PER_BLOCK, 0);
  return (int)e;
}

extern "C" int ms_deform_attn_merged_fwd(const float* table, const float* loc,
                                         const float* attn, float* out, const int* shapes,
                                         int B, int S, int Lq, int M, int D, int L, int P,
                                         void* stream) {
  if (L < 1 || L > MSDA_MAX_LEVELS || D != 32 || L * P > MSDA_MAX_SAMPLES ||
      (int64_t)S * 32 > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * M > 65535) return (int)cudaErrorInvalidValue;
  if (B * M == 0 || Lq == 0) return (int)cudaSuccess;
  const dim3 grid((Lq + MSDA_WARPS_PER_BLOCK - 1) / MSDA_WARPS_PER_BLOCK, B * M);
  ms_deform_attn_merged_kernel<<<grid, 32 * MSDA_WARPS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      table, loc, attn, out, make_levels(shapes, L), S, Lq, M, L, P);
  return (int)cudaGetLastError();
}

extern "C" int ms_deform_attn_merged_table(const float* value, float* table, const int* shapes,
                                           int B, int S, int M, int D, int L, void* stream) {
  if (L < 1 || L > MSDA_MAX_LEVELS || D != 32 || B * M > 65535) return (int)cudaErrorInvalidValue;
  if (B * M == 0 || S == 0) return (int)cudaSuccess;
  const dim3 grid((S + MSDA_WARPS_PER_BLOCK - 1) / MSDA_WARPS_PER_BLOCK, B * M);
  ms_deform_attn_merged_table_kernel<<<grid, 32 * MSDA_WARPS_PER_BLOCK, 0,
                                       (cudaStream_t)stream>>>(value, table,
                                                               make_levels(shapes, L), S, M, L);
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
  if (!lane_layout_ok(B, S, M, D, L, P)) return (int)cudaErrorInvalidValue;
  if (B * M == 0 || S == 0) return (int)cudaSuccess;
  const dim3 grid((S + MSDA_WARPS_PER_BLOCK - 1) / MSDA_WARPS_PER_BLOCK, B * M);
  ms_deform_attn_encoder_bwd_kernel<<<grid, 32 * MSDA_WARPS_PER_BLOCK, 0,
                                      (cudaStream_t)stream>>>(
      value, off, logits, dout, dvalue, doff, dlogits, make_levels(shapes, L), S, M, L, P);
  return (int)cudaGetLastError();
}

template <int GEOM>
static int launch_footprint(const float* value, const float* a, const float* b, const int* table,
                            float* out, dim3 grid, int S, int M, int L, int P, int Sq,
                            int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(ms_deform_attn_footprint_kernel<GEOM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  ms_deform_attn_footprint_kernel<GEOM><<<grid, 32 * MSDA_WARPS_PER_BLOCK, smem_bytes, stream>>>(
      value, a, b, table, out, S, M, L, P, Sq);
  return (int)cudaGetLastError();
}

// geometry: a FootprintGeometry; table (device int32) and smem_bytes from the wrapper's
// Footprints; n_items blocks per (batch, head); Sq the token axis of a and b.
extern "C" int ms_deform_attn_footprint_fwd(int geometry, const float* value, const float* a,
                                            const float* b, const int* table, float* out, int B,
                                            int S, int M, int D, int L, int P, int n_items,
                                            int Sq, int smem_bytes, void* stream) {
  if (L < 1 || L > MSDA_MAX_LEVELS || D != 32 || L * P > MSDA_MAX_SAMPLES || B > 65535 ||
      M > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_items == 0 || B == 0 || M == 0) return (int)cudaSuccess;
  const dim3 grid(n_items, B, M);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (geometry) {
    case NATURAL_LOC:
      return launch_footprint<NATURAL_LOC>(value, a, b, table, out, grid, S, M, L, P, Sq,
                                           smem_bytes, st);
    case TM_LOC:
      return launch_footprint<TM_LOC>(value, a, b, table, out, grid, S, M, L, P, Sq, smem_bytes,
                                      st);
    case TM_OFF_CELLS:
      return launch_footprint<TM_OFF_CELLS>(value, a, b, table, out, grid, S, M, L, P, Sq,
                                            smem_bytes, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
