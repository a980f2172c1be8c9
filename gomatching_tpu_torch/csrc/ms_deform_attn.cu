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
// The lane layout (B1-B4, and B5 on its table). The first forms of B1 and B2 took
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
// operand of a matmul form alone costs 4-10 us a block to build, the probe T2); value
// tiles staged in shared memory, even by TMA and on this lane layout (the footprint kernel
// B6 below does exactly that): the kernels are bound by their own instructions, not by
// where a row comes from (shared memory and L1 are one array behind one data path, so a
// row costs the same wavefronts from either; staging saves only L1 misses), and the shared
// memory a tile takes costs resident warps; B6 staging 90% of its corner taps is 3%
// faster than gathering them all at the same occupancy and 26% slower than gathering them
// at twice its resident warps (the -DFP_WARPS=8 build; chip_smoke.py phase 12).
//
// The production precision path (MODEL.PRECISION bfloat16) runs B1 and B2 on bf16 value:
//
//   ms_deform_attn_queries_fwd_bf16, ms_deform_attn_encoder_fwd_bf16  -- one body of their
//       own (paired_fwd_bf16, below the f32 kernels); locations, offsets, attention and
//       logits stay f32. Replace the bf16 runs of
//       gomatching_tpu/ops/deform_attn_dec_vmem.py:_fwd_impl and
//       gomatching_tpu/ops/deform_attn_vmem.py:_v2_impl (value and output in the value
//       dtype there too). The weights, the softmax and the sums are f32, and the output is
//       rounded once to nearest even. The TPU kernels round each one-hot weight G (bilinear
//       weight x attention) to bf16 before their MXU product; these keep it f32, which is
//       more exact.
// Their first form instantiated the f32 bodies for bf16 value, each lane
// reading 8 bytes where f32 reads 16: the f32 kernels' instructions, shuffles and chain,
// 0.7813 ms for B2 at the encoder shape against f32's 0.7908, B1 0.0473 ms of device time at
// the decoder's. The paired-head layout (its note is at paired_fwd_bf16) gives a warp two
// heads, one a half-warp, so two chains a warp and the per-query work once for both; a lane
// moves 16 bytes (8 channels) a corner row, so one warp load gathers 8 corner rows, and the
// samples' corner (row, weight) pairs reach the gatherers through a 1 KB slice of shared
// memory a warp instead of two shuffles a sample. ptxas: 64 registers each, no stack, no
// spills, 9344 bytes of static shared memory a block; 32 warps per SM. On an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py phases 15 and 17): B2 0.420 ms at the encoder shape
// (B = 3, value (3, 37171, 8, 32)) against a byte bound of 0.085 ms and f32's 0.79 in turns;
// B1 36.7 us of device time at the decoder shape (bound 16.9 us) and 0.376 ms at the
// encoder's. What bounds them now is still their own instructions and the L1's data path,
// not memory: with every gathered row an L1 hit B2 takes 0.395 ms of its 0.420 (B1 0.320 of
// 0.376 at the encoder shape; 0.025 of 0.038 ms at the decoder's, whose few waves wait on
// device memory), against a floor of 0.22 ms for the 57.1M corner line requests at one line
// an SM cycle. Eight samples' loads in flight a gatherer were 0.4-6% faster than four in a
// measurement build on the same card, which is not kept.
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
// B3 is B4's kernel on B1's geometry (its first form took one warp per (batch, query,
// head) with lanes on the channels, walked the samples one at a time, kept LevelInfo on the
// stack and issued a scalar atomic per channel and corner: 0.138 ms a call, 0.121 ms of
// device time on an NVIDIA H100 80GB HBM3 at 700 W). Now B1's grid and load_samples on the
// normalized locations and softmaxed weights (no softmax backward), sample_corner<false>
// so every sample lands in B1's cell, the merged float4 atomics before the loads, the
// reduce-scatter of the corner dots; the lane of sample i stores dAttn_i and dLoc_i = a_i
// (gx_i W, gy_i H). It takes D == 32 within check_lane_layout's limits. What bounds it is
// what bounds B4: its scatter and its own instructions, not bytes (PERF.md and phases 6 and
// 15 of chip_smoke.py give its times beside the bound).
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
// GoMatching++ in the production precision path ('pallas' with MODEL.PRECISION bfloat16)
// runs both on bf16 value, each a body of its own:
//
//   ms_deform_attn_merged_table_bf16  -- the table in value's dtype, as JAX builds it
//       (_merged_corner_table on bf16 value): a copy of bits in 256-byte rows. A lane moves
//       one 16-byte word (a warp two rows, 512 contiguous bytes), each warp walks 16
//       consecutive tokens of one (batch, head) with its level, row and column found once
//       and stepped, and each lane has its 8 loads in flight before its first store (its
//       note is at ms_deform_attn_merged_table_bf16_kernel).
//   ms_deform_attn_merged_fwd_bf16  -- B5 on that table through the paired-head body of B1
//       and B2 bf16 (paired_fwd_bf16, PAIRED_MERGED): two heads a warp, lane h of a half
//       reading word h of a 256-byte row, so one 16-byte load a lane gathers one sample's
//       whole row for both heads (4 128-byte lines a warp load); each lane owns one sample
//       of a chunk of 16 and computes its base row and four slot weights once. It widens
//       each row exactly, scales it by f32 slot weights, sums in f32 and rounds the output
//       once, as _sampling_kernel does with its f32 slot weights and accumulator; unlike
//       B1/B2's TPU kernels, JAX's B5 does not round its weights to bf16, so the two differ
//       only in the order of the f32 sums.
// Their first forms instantiated the f32 bodies for bf16, a lane reading 8 bytes where f32
// reads 16: B5 bf16 0.683 ms at the encoder shape, the table 0.189 ms (45% of the memory
// rate, each 8-byte word paying a level search, a division and 64-bit address arithmetic).
// ptxas now: B5 bf16 64 registers, the table 59, no stack, no spills; 32 warps per SM each.
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phases 15 and 20): the table 0.111 ms
// at the ICDAR15 shape (B = 3, value (3, 37171, 8, 32)) against a byte bound of 0.085 ms
// (57.1 MB read, 228.4 MB written: 76.5% of the memory rate) and f32's 0.220 in turns; B5
// bf16 0.437 ms at the encoder shape against a byte bound of 0.085 ms and f32's 0.811 in
// turns, 0.046 ms at the decoder's (bound 0.017). What bounds B5 bf16 now is its own work
// and where its rows come from: with every row an L1 hit it takes 0.327 ms of its 0.435, so
// the memory system adds 25% (B2 bf16 6%): a 256-byte table row serves one cell, so samples
// in neighbouring cells share no line and most rows come from L2 (3.65 GB of rows
// requested a call, 8.4 TB/s at the kernel's time), where value's rows are shared by
// neighbouring cells' corners; the 28.5M row lines take 0.109 ms at one line an SM cycle.
// A fourth forward serves the encoder variants that stage tile footprints
// (B6a-c: ms_deform_attn_encoder_vmem, _vmem_tm, _vmem_v3 and _fused):
//
//   ms_deform_attn_footprint_fwd  -- one kernel, three input layouts; see its
//       source note below.
//
// Plain C interface, loaded with ctypes; every launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define MSDA_MAX_LEVELS 8
#define MSDA_MAX_SAMPLES 64  // L * P per head: two samples a lane in the lane-layout kernels
#define MSDA_WARPS_PER_BLOCK 8
// resident blocks per SM the lane-layout kernels (B1-B5) ask of the compiler: at
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

// The gather of the lane-layout kernels (B1-B5), D == 32. Lane l owns corner
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

// A lane's 4 channels of a head row are one word: a float4 of f32 value, or 8 bytes of 4
// bf16 (a bf16 head row is 64 bytes, 8 lanes x 8 B, so the lane layout and the row
// offsets in words are the same for both types where a kernel reads bf16 through it: the
// footprint kernels only; B1's, B2's and B5's bf16 kernels, paired_fwd_bf16, and B5's bf16
// table build read 16-byte words of 8 channels). ``as_float4`` widens a word exactly;
// ``store_row`` rounds a lane's 4 f32 sums to the output type, to nearest even for bf16.
template <typename T>
struct RowWord {
  using type = float4;
};
template <>
struct RowWord<__nv_bfloat16> {
  using type = uint2;
};

__device__ __forceinline__ float4 as_float4(float4 w) { return w; }

__device__ __forceinline__ float4 as_float4(uint2 w) {
  // little-endian: channel 2k is the low half of word k
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

__device__ __forceinline__ void store_row(float* __restrict__ out, int lane, float4 v) {
  reinterpret_cast<float4*>(out)[lane] = v;
}

__device__ __forceinline__ void store_row(__nv_bfloat16* __restrict__ out, int lane, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 w;
  memcpy(&w.x, &lo, 4);
  memcpy(&w.y, &hi, 4);
  reinterpret_cast<uint2*>(out)[lane] = w;
}

template <typename Word>
__device__ __forceinline__ void load8(const Word* __restrict__ base, int row, int lane,
                                      float4 (&v)[8]) {
  const int grp = lane & 24;
#ifdef MSDA_GATHER_ROW0
  row &= *(volatile int*)&msda_row_mask;
#endif
  Word w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = __ldg(base + __shfl_sync(MSDA_FULL, row, grp | k));
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = as_float4(w[k]);
}

// The forwards' gather: load8, then each lane scales its corner's rows by that corner's
// weight ``wgt`` (attention folded in, 0 for a corner off the map), one shuffle each.
template <typename Word>
__device__ __forceinline__ void gather8(const Word* __restrict__ base, int row, float wgt,
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
// head's 32 channels from lanes 0-7 as one row (128 bytes of f32, 64 of bf16).
template <typename T>
__device__ __forceinline__ void store_corners(float4 acc, int lane, T* __restrict__ out) {
#pragma unroll
  for (int k = 8; k <= 16; k <<= 1) {
    acc.x += __shfl_xor_sync(MSDA_FULL, acc.x, k);
    acc.y += __shfl_xor_sync(MSDA_FULL, acc.y, k);
    acc.z += __shfl_xor_sync(MSDA_FULL, acc.z, k);
    acc.w += __shfl_xor_sync(MSDA_FULL, acc.w, k);
  }
  if (lane < 8) store_row(out, lane, acc);
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
template <typename Word, typename Geometry>
__device__ __forceinline__ float4 sample_loop(const Word* __restrict__ base, int LP, int lane,
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
// out (B, Lq, M*32); all f32. B2's design on normalized locations: blockIdx.y is the (batch,
// head) pair and warp w of block x takes query 8x + w, so the warps of a block sample one
// head around neighbouring queries (the 25 points of one text instance are neighbours).
// L*P <= 64.
__device__ __forceinline__ void queries_fwd(const float* __restrict__ value,
                                            const float* __restrict__ loc,
                                            const float* __restrict__ attn,
                                            float* __restrict__ out, const LevelInfo& lv, int S,
                                            int Lq, int M, int L, int P) {
  using Word = float4;
  const int q = blockIdx.x * MSDA_WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= Lq) return;
  const int m = blockIdx.y % M;
  const int b = blockIdx.y / M;
  const LaneLevel levels = lane_level(lv, lane);
  const int LP = L * P;
  const int64_t bqm = ((int64_t)b * Lq + q) * M + m;
  const Samples sm = load_samples(loc + bqm * LP * 2, attn + bqm * LP, LP, lane, 0.f);
  const int tok4 = M * 8;  // row words per token
  const int magic = level_magic(P);
  const Word* base = reinterpret_cast<const Word*>(value + ((int64_t)b * S * M + m) * 32) +
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

// value (B, S, M, 32); off (B, S, M, L, P, 2) raw target-level cells; logits (B, S, M,
// L*P); out (B, S, M*32); all f32. blockIdx.y is the (batch, head) pair and warp w of block
// x takes token 8x + w: warps in (b, m, s) order, tokens fastest, so the warps of one block
// sample one head around neighbouring tokens, and no lane divides 64-bit indices.
// L*P <= 64.
__device__ __forceinline__ void encoder_fwd(const float* __restrict__ value,
                                            const float* __restrict__ off,
                                            const float* __restrict__ logits,
                                            float* __restrict__ out, const LevelInfo& lv, int S,
                                            int M, int L, int P) {
  using Word = float4;
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
  const Word* base = reinterpret_cast<const Word*>(value + ((int64_t)b * S * M + m) * 32) +
                     (lane & 7);
  const float4 acc = sample_loop(base, LP, lane, [&](int i0, int& row, float& wgt) {
    float a;
    const Corner c = sample_corner<true>(i0, lane, LP, magic, levels, sm, ref, tok4, a);
    row = c.row;
    wgt = c.in ? a * corner_weight(c, lane) : 0.f;
  });
  store_corners(acc, lane, out + bsm * 32);
}

// B1 and B2 on f32 value.
__global__ void __launch_bounds__(32 * MSDA_WARPS_PER_BLOCK, MSDA_FWD_MIN_BLOCKS)
ms_deform_attn_queries_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                              const float* __restrict__ attn, float* __restrict__ out,
                              LevelInfo lv, int S, int Lq, int M, int L, int P) {
  queries_fwd(value, loc, attn, out, lv, S, Lq, M, L, P);
}

__global__ void __launch_bounds__(32 * MSDA_WARPS_PER_BLOCK, MSDA_FWD_MIN_BLOCKS)
ms_deform_attn_encoder_kernel(const float* __restrict__ value, const float* __restrict__ off,
                              const float* __restrict__ logits, float* __restrict__ out,
                              LevelInfo lv, int S, int M, int L, int P) {
  encoder_fwd(value, off, logits, out, lv, S, M, L, P);
}

// ---------------------------------------------------------------------------
// B1, B2 and B5 on bf16 value (the production precision path): the paired-head lane layout.
//
// A warp takes one query (B1, B5) or token (B2) and TWO heads, m = 2 blockIdx.y + (lane >> 4):
// each half-warp is one head's chain, so a warp runs two independent chains and the
// per-query work (indices, the token's reference point, the level table) is paid once for
// both. Within a half, lane h = 4c + w plays two roles:
//   - owner of sample k = c0 + h of a chunk of MSDA_BF16_CHUNK = 16 samples (one a lane
//     at the configs' L*P = 16; larger L*P loops over chunks): it loads the sample's
//     coordinate pair and weight or logit (coalesced), computes its cell once, and writes
//     its four corners' (16-byte word row, weight) pairs to the warp's slice of shared
//     memory (4 stores; a corner off the map gets row 0, a valid address, and weight 0);
//   - gatherer of corner c = h >> 2, word w = h & 3 (channels 8w..8w+7) of every sample:
//     it reads two samples' (row, weight) pairs of its corner with one 16-byte shared load
//     and the rows with one 16-byte global load each, widens the 8 bf16 exactly (a shift
//     or a mask) and adds them into 8 f32 sums with f32 FMAs. A head row (64 bytes) is 4
//     lanes' words, so one warp load gathers 8 corner rows: the 4 corners of one sample of
//     each head. MSDA_BF16_GROUP samples' loads are in flight before the first is used.
// The shared slice replaces the per-sample row and weight shuffles of the f32 layout (a
// transpose of the owners' corner pairs to the gatherers; value itself is not staged). The
// softmax of B2 runs over a half in 4 shuffle steps; its normalization is deferred to the
// output (sum_k e_k w_kc v_kc, times 1 / sum_k e_k), so the sum's shuffles leave the chain.
// A 6-shuffle reduce-scatter over the corners (xor 8, then 4) leaves lane 4c + w with
// channels 8w + 2c, +1 of the head, which it rounds to bf16 once, to nearest even, and
// stores as one 4-byte word: the warp writes both heads' 128 bytes in one store. Sums run in
// a fixed order, no atomics: a call gives the same bits every time.
// B2 places a sample at ref * (W, H) - 0.5 + off, one FMA and an add: the same point as the
// reference's and the f32 kernel's (ref + off / (W, H)) * (W, H) - 0.5 without its
// division, so x and y can differ from theirs by a few f32 roundings (well under one bf16
// ulp of the output; chip_smoke.py phase 17 holds it to the plain version).
// B5 (PAIRED_MERGED) reads the corner-merged table (B, M, S, 4*32) instead of value: a bf16
// table row is 256 bytes, 16 words, and lane h of a half reads word h (corner c, channels
// 8w..8w+7), so one warp load gathers one sample's whole row for each head (4 128-byte
// lines, where B1 and B2 touch 8). The owner computes the sample's clamped base row and its
// four slot weights (axis_slots, the f32 B5's arithmetic in the reference's order) and
// writes (the base row, slot weight c) for each corner c: the same row for the four, which
// is always a valid row of the head's slice.
#define MSDA_BF16_CHUNK 16
// samples whose loads a gatherer has in flight at once (a divisor of MSDA_BF16_CHUNK)
#define MSDA_BF16_GROUP 8
// int2 entries a (half, corner) row of the shared slice: 16 samples plus 16 bytes of pad,
// so that the 8 (half, corner) rows one gather load reads start in distinct bank groups
#define MSDA_GEO_STRIDE 18

// acc[i] += w * channel i of a 16-byte word of 8 bf16 (little-endian: channel 2j is the low
// half of 32-bit word j), each widened exactly.
__device__ __forceinline__ void fma_bf16x8(float (&acc)[8], float w, uint4 v) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc[2 * j] = fmaf(w, __uint_as_float(u[j] << 16), acc[2 * j]);
    acc[2 * j + 1] = fmaf(w, __uint_as_float(u[j] & 0xffff0000u), acc[2 * j + 1]);
  }
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

// What the paired-head body samples: B1 (xy normalized locations, wq softmaxed weights;
// value rows), B2 (xy raw offsets in target-level cells from the token's reference point,
// wq the attention logits; value rows) or B5 (B1's inputs; rows of the corner-merged table).
enum PairedGeometry { PAIRED_QUERIES, PAIRED_ENCODER, PAIRED_MERGED };

// src: value (B, S, M, 32) bf16, or for B5 the table (B, M, S, 4*32) bf16; xy (B, Nq, M, L,
// P, 2), wq (B, Nq, M, L*P) f32; out (B, Nq, M*32) bf16; Nq = S for B2. Grid (ceil(Nq / 8),
// ceil(M / 2), B).
template <PairedGeometry GEOM>
__device__ __forceinline__ void paired_fwd_bf16(const __nv_bfloat16* __restrict__ src,
                                                const float* __restrict__ xy,
                                                const float* __restrict__ wq,
                                                __nv_bfloat16* __restrict__ out,
                                                const LevelInfo& lv, int S, int Nq, int M,
                                                int L, int P) {
  constexpr bool ENCODER = GEOM == PAIRED_ENCODER;
  constexpr bool MERGED = GEOM == PAIRED_MERGED;
  __shared__ int4 s_lv[MSDA_MAX_LEVELS];  // (h, w, start) of each level
  __shared__ __align__(16) int2 s_geo[MSDA_WARPS_PER_BLOCK][2][4][MSDA_GEO_STRIDE];
  if (threadIdx.x < MSDA_MAX_LEVELS) {
    int h, w, start;
    level_dims(lv, threadIdx.x, h, w, start);
    s_lv[threadIdx.x] = make_int4(h, w, start, 0);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * MSDA_WARPS_PER_BLOCK + warp;
  if (q >= Nq) return;
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int h = lane & 15;
  const int m = 2 * blockIdx.y + half;
  const bool mval = m < M;  // an odd M leaves the last pair's second half idle
  const int mc = mval ? m : M - 1;
  const int b = blockIdx.z;
  const int LP = L * P;
  const int64_t bqm = ((int64_t)b * Nq + q) * M + mc;
  const float2* xy2 = reinterpret_cast<const float2*>(xy + bqm * LP * 2);
  const float* wk = wq + bqm * LP;
  const float neg_inf = __int_as_float(0xff800000);

  // the token's reference point on its own level: ((col + 0.5) / W, (row + 0.5) / H)
  float2 ref = make_float2(0.f, 0.f);
  if (ENCODER) {
    int l1 = 0;
#pragma unroll
    for (int i = 1; i < MSDA_MAX_LEVELS; ++i) l1 += (i < L && q >= lv.start[i]);
    const int4 ql = s_lv[l1];
    const int t = q - ql.z;
    const int qrow = t / ql.y;
    const int qcol = t - qrow * ql.y;
    ref = make_float2(((float)qcol + 0.5f) / (float)ql.y, ((float)qrow + 0.5f) / (float)ql.x);
  }

  // chunk 0's inputs, and B2's softmax max over the half (later chunks reread theirs)
  bool kv = mval && h < LP;
  float2 o = kv ? __ldg(xy2 + h) : make_float2(0.f, 0.f);
  float a = kv ? __ldg(wk + h) : (ENCODER ? neg_inf : 0.f);
  float mx = 0.f;
  if (ENCODER) {
    mx = a;
    for (int c0 = MSDA_BF16_CHUNK; c0 < LP; c0 += MSDA_BF16_CHUNK)
      mx = fmaxf(mx, mval && c0 + h < LP ? __ldg(wk + c0 + h) : neg_inf);
#pragma unroll
    for (int k = 8; k > 0; k >>= 1) mx = fmaxf(mx, __shfl_xor_sync(MSDA_FULL, mx, k));
  }

  const int tw = M * 4;  // 16-byte words a token of value
  const int magic = level_magic(P);
  // the gatherer's word of row 0 of the head: word h & 3 of value's head row, or word h of
  // a merged table row (16 words a row)
  const uint4* base =
      MERGED ? reinterpret_cast<const uint4*>(src + ((int64_t)b * M + mc) * S * 128) + h
             : reinterpret_cast<const uint4*>(src + ((int64_t)b * S * M + mc) * 32) + (h & 3);
  int2(*geo)[MSDA_GEO_STRIDE] = s_geo[warp][half];
  const int2* mine = geo[h >> 2];  // the gatherer's corner row
#ifdef MSDA_GATHER_ROW0
  const int row_mask = *(volatile int*)&msda_row_mask;
#endif
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  float esum = 0.f;
  for (int c0 = 0; c0 < LP; c0 += MSDA_BF16_CHUNK) {
    const int k = c0 + h;
    if (c0 > 0) {
      kv = mval && k < LP;
      o = kv ? __ldg(xy2 + k) : make_float2(0.f, 0.f);
      a = kv ? __ldg(wk + k) : 0.f;
    }
    float e = a;  // the sample's weight before the bilinear factors
    if (ENCODER) {
      e = kv ? expf(a - mx) : 0.f;
      esum += e;
    }
    // owner: sample k's cell on its level (level k / P; k < 64 here) and its four corners
    const int4 lvl = s_lv[min((k * magic) >> 16, MSDA_MAX_LEVELS - 1)];
    const float wf = (float)lvl.y;
    const float hf = (float)lvl.x;
    if (MERGED) {
      // the table's clamped base row and four slot weights, as the f32 B5 (merged_fwd)
      // computes them: x = loc * W - 0.5 with the product rounded, as the reference does
      const float x = __fmul_rn(o.x, wf) - 0.5f;
      const float y = __fmul_rn(o.y, hf) - 0.5f;
      const float x0 = floorf(x);
      const float y0 = floorf(y);
      const float bx = fminf(fmaxf(x0, 0.f), fmaxf(wf - 2.f, 0.f));
      const float by = fminf(fmaxf(y0, 0.f), fmaxf(hf - 2.f, 0.f));
      float wx0, wx1, wy0, wy1;
      axis_slots(x0, x - x0, bx, wf, wx0, wx1);
      axis_slots(y0, y - y0, by, hf, wy0, wy1);
      // past L*P the level may be past the last (start == S): row 0, weight 0
      const int r = kv ? (lvl.z + (int)by * lvl.y + (int)bx) * 16 : 0;
      geo[0][h] = make_int2(r, __float_as_int(wy0 * wx0 * e));
      geo[1][h] = make_int2(r, __float_as_int(wy0 * wx1 * e));
      geo[2][h] = make_int2(r, __float_as_int(wy1 * wx0 * e));
      geo[3][h] = make_int2(r, __float_as_int(wy1 * wx1 * e));
    } else {
      float x, y;
      if (ENCODER) {  // ref * (W, H) - 0.5 + off
        x = fmaf(ref.x, wf, -0.5f) + o.x;
        y = fmaf(ref.y, hf, -0.5f) + o.y;
      } else {
        x = fmaf(o.x, wf, -0.5f);
        y = fmaf(o.y, hf, -0.5f);
      }
      // clamped where every corner is off the map anyway, so the int casts are safe
      x = fminf(fmaxf(x, -2.f), wf + 1.f);
      y = fminf(fmaxf(y, -2.f), hf + 1.f);
      const float x0 = floorf(x);
      const float y0 = floorf(y);
      const float fx = x - x0;
      const float fy = y - y0;
      const int ix = (int)x0;
      const int iy = (int)y0;
      const bool vx0 = (unsigned)ix < (unsigned)lvl.y;
      const bool vx1 = (unsigned)(ix + 1) < (unsigned)lvl.y;
      const bool vy0 = (unsigned)iy < (unsigned)lvl.x;
      const bool vy1 = (unsigned)(iy + 1) < (unsigned)lvl.x;
      const float ax0 = vx0 ? e * (1.f - fx) : 0.f;
      const float ax1 = vx1 ? e * fx : 0.f;
      const float wy0 = vy0 ? 1.f - fy : 0.f;
      const float wy1 = vy1 ? fy : 0.f;
      const int r00 = (lvl.z + iy * lvl.y + ix) * tw;
      const int r10 = r00 + lvl.y * tw;
      geo[0][h] = make_int2(vx0 && vy0 ? r00 : 0, __float_as_int(wy0 * ax0));
      geo[1][h] = make_int2(vx1 && vy0 ? r00 + tw : 0, __float_as_int(wy0 * ax1));
      geo[2][h] = make_int2(vx0 && vy1 ? r10 : 0, __float_as_int(wy1 * ax0));
      geo[3][h] = make_int2(vx1 && vy1 ? r10 + tw : 0, __float_as_int(wy1 * ax1));
    }
    __syncwarp();
    // gatherer: this chunk's samples, MSDA_BF16_GROUP at a time, every load of a group
    // issued before the first is used (entries past L*P have weight 0)
    const int n = min(LP - c0, MSDA_BF16_CHUNK);
    for (int j = 0; j < n; j += MSDA_BF16_GROUP) {
      int4 p[MSDA_BF16_GROUP / 2];  // two samples' (row, weight) pairs each
#pragma unroll
      for (int i = 0; i < MSDA_BF16_GROUP / 2; ++i) {
        p[i] = *reinterpret_cast<const int4*>(mine + j + 2 * i);
#ifdef MSDA_GATHER_ROW0
        p[i].x &= row_mask;
        p[i].z &= row_mask;
#endif
      }
      uint4 v[MSDA_BF16_GROUP];
#pragma unroll
      for (int i = 0; i < MSDA_BF16_GROUP / 2; ++i) {
        v[2 * i] = __ldg(base + p[i].x);
        v[2 * i + 1] = __ldg(base + p[i].z);
      }
#pragma unroll
      for (int i = 0; i < MSDA_BF16_GROUP / 2; ++i) {
        fma_bf16x8(acc, __int_as_float(p[i].y), v[2 * i]);
        fma_bf16x8(acc, __int_as_float(p[i].w), v[2 * i + 1]);
      }
    }
    __syncwarp();
  }

  // reduce-scatter over the corners: lanes h, h ^ 4, h ^ 8, h ^ 12 hold the same channels
  float r[4];
  const bool up8 = lane & 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = up8 ? acc[i] : acc[i + 4];
    r[i] = (up8 ? acc[i + 4] : acc[i]) + __shfl_xor_sync(MSDA_FULL, send, 8);
  }
  const bool up4 = lane & 4;
  float s0 = (up4 ? r[2] : r[0]) + __shfl_xor_sync(MSDA_FULL, up4 ? r[0] : r[2], 4);
  float s1 = (up4 ? r[3] : r[1]) + __shfl_xor_sync(MSDA_FULL, up4 ? r[1] : r[3], 4);
  if (ENCODER) {
#pragma unroll
    for (int k = 8; k > 0; k >>= 1) esum += __shfl_xor_sync(MSDA_FULL, esum, k);
    const float inv_sum = 1.f / esum;
    s0 *= inv_sum;
    s1 *= inv_sum;
  }
  if (mval) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(s0, s1);
    unsigned word;
    memcpy(&word, &pair, 4);
    reinterpret_cast<unsigned*>(out + bqm * 32)[4 * (h & 3) + (h >> 2)] = word;
  }
}

__global__ void __launch_bounds__(32 * MSDA_WARPS_PER_BLOCK, MSDA_FWD_MIN_BLOCKS)
ms_deform_attn_queries_bf16_kernel(const __nv_bfloat16* __restrict__ value,
                                   const float* __restrict__ loc, const float* __restrict__ attn,
                                   __nv_bfloat16* __restrict__ out, LevelInfo lv, int S, int Lq,
                                   int M, int L, int P) {
  paired_fwd_bf16<PAIRED_QUERIES>(value, loc, attn, out, lv, S, Lq, M, L, P);
}

__global__ void __launch_bounds__(32 * MSDA_WARPS_PER_BLOCK, MSDA_FWD_MIN_BLOCKS)
ms_deform_attn_encoder_bf16_kernel(const __nv_bfloat16* __restrict__ value,
                                   const float* __restrict__ off,
                                   const float* __restrict__ logits,
                                   __nv_bfloat16* __restrict__ out, LevelInfo lv, int S, int M,
                                   int L, int P) {
  paired_fwd_bf16<PAIRED_ENCODER>(value, off, logits, out, lv, S, S, M, L, P);
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

// One batch of 8 samples of the backward kernels B3 and B4: lane 8c + k holds corner c of
// sample k (``c``; ``a`` the sample's weight), ``g`` the lane's 4 channels of dOut, ``base``
// and ``dbase`` the head's value and dValue rows at the lane's float4. Each lane adds
// a_k w_ck dOut to its corner's in-map row of every sample with one float4 atomic, the
// batch's corners that share a row merged first; the atomics are issued before the
// batch's loads, so that neither waits on the other and their operands are dead before
// the 8 rows arrive (issued after the loads, they spill). A measurement build
// (chip_smoke.py builds it with -DMSDA_NO_SCATTER) skips these atomics and nothing else.
// Then load8 gathers the rows, each lane forms its 4-channel share of dot(dOut, v_ck), a
// reduce-scatter leaves the whole dot of (c, k) on lane 8c + k, where it meets the corner's
// weight and derivative weights (all 0 for a corner off the map: its row is the valid one
// it was clamped to, whose dot must add nothing), and shuffles by 8 and 16 sum the corners.
// Every lane of sample k gets dA_k (tA) and the sample's d/dx and d/dy (tx, ty).
__device__ __forceinline__ void bwd_batch(const Corner& c, float a, float4 g,
                                          const float4* __restrict__ base,
                                          float4* __restrict__ dbase, int lane, float& tA,
                                          float& tx, float& ty) {
#ifndef MSDA_NO_SCATTER
  const float wgt =
      merge_shared_rows(c.row, c.in, c.in ? a * corner_weight(c, lane) : 0.f, lane);
  const int grp = lane & 24;
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
  const bool cx = (lane >> 3) & 1;
  const bool cy = lane >> 4;
  const float wx = cx ? c.fx : 1.f - c.fx;
  const float wy = cy ? c.fy : 1.f - c.fy;
  tA = c.in ? wy * wx * dot : 0.f;
  tx = c.in ? (cx ? wy : -wy) * dot : 0.f;
  ty = c.in ? (cy ? wx : -wx) * dot : 0.f;
#pragma unroll
  for (int k = 8; k <= 16; k <<= 1) {
    tA += __shfl_xor_sync(MSDA_FULL, tA, k);
    tx += __shfl_xor_sync(MSDA_FULL, tx, k);
    ty += __shfl_xor_sync(MSDA_FULL, ty, k);
  }
}

// B2's VJP. value/off/logits as the forward; dout (B, S, M*32); dvalue (B, S, M, 32) zeroed
// by the caller; doff (B, S, M, L, P, 2) in cells; dlogits (B, S, M, L*P). B2's grid, level
// table, softmax and geometry (the same samples land in the same cells as in the
// forward). Lane l keeps dOut's channels 4(l & 7)..+3 for the whole warp. Each batch of 8
// samples goes through bwd_batch: dValue, and per sample dA_k, gx_k, gy_k (d/dx, d/dy; x
// is in cells, so d x / d off = 1). The lane of sample i0 + k stores dOffsets_k = a_k
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
  float2* doff2 = reinterpret_cast<float2*>(doff + bsm * LP * 2);
  float dA0 = 0.f, dA1 = 0.f;
  for (int i0 = 0; i0 < LP; i0 += 8) {
    float a, tA, tx, ty;
    const Corner c = sample_corner<true>(i0, lane, LP, magic, levels, sm, ref, tok4, a);
    bwd_batch(c, a, g, base, dbase, lane, tA, tx, ty);
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

// B1's VJP. value/loc/attn as B1's forward; dout (B, Lq, M*32); dvalue (B, S, M, 32) zeroed
// by the caller; dloc (B, Lq, M, L, P, 2); dattn (B, Lq, M, L, P). B4's kernel with B1's
// geometry: blockIdx.y is the (batch, head) pair and warp w of block x takes query 8x + w
// (neighbouring points of one text instance), lane j loads sample j's normalized location
// and softmaxed weight (load_samples; no softmax, so no softmax backward), and each batch of
// 8 samples goes through sample_corner<false>, so every sample lands in B1's cell, then
// through B4's bwd_batch. The lane of sample i stores dAttn_i = dA_i and dLoc_i = a_i
// (gx_i W_l, gy_i H_l): x = loc W - 0.5, so dx / dloc = W. dLoc and dAttn are summed in a
// fixed order: the same bits every call.
__global__ void __launch_bounds__(32 * MSDA_WARPS_PER_BLOCK, MSDA_FWD_MIN_BLOCKS)
ms_deform_attn_queries_bwd_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                                  const float* __restrict__ attn, const float* __restrict__ dout,
                                  float* __restrict__ dvalue, float* __restrict__ dloc,
                                  float* __restrict__ dattn, LevelInfo lv, int S, int Lq, int M,
                                  int L, int P) {
  const int q = blockIdx.x * MSDA_WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= Lq) return;
  const int m = blockIdx.y % M;
  const int b = blockIdx.y / M;
  const LaneLevel levels = lane_level(lv, lane);
  const int LP = L * P;
  const int64_t bqm = ((int64_t)b * Lq + q) * M + m;
  const Samples sm = load_samples(loc + bqm * LP * 2, attn + bqm * LP, LP, lane, 0.f);
  const float4 g = __ldg(reinterpret_cast<const float4*>(dout + bqm * 32) + (lane & 7));
  const int tok4 = M * 8;
  const int magic = level_magic(P);
  const int64_t head = ((int64_t)b * S * M + m) * 32;
  const float4* base = reinterpret_cast<const float4*>(value + head) + (lane & 7);
  float4* dbase = reinterpret_cast<float4*>(dvalue + head) + (lane & 7);
  float2* dloc2 = reinterpret_cast<float2*>(dloc + bqm * LP * 2);
  float* dattn_q = dattn + bqm * LP;
  for (int i0 = 0; i0 < LP; i0 += 8) {
    float a, tA, tx, ty;
    const Corner c =
        sample_corner<false>(i0, lane, LP, magic, levels, sm, make_float2(0.f, 0.f), tok4, a);
    bwd_batch(c, a, g, base, dbase, lane, tA, tx, ty);
    // the lane of sample i = i0 + (lane & 7) stores dAttn_i and dLoc_i (its level's W, H
    // from the lane-held table, fetched by every lane: a shuffle needs the whole warp)
    const int i = i0 + (lane & 7);
    const LaneLevel lvl = level_of(levels, min((i * magic) >> 16, MSDA_MAX_LEVELS - 1));
    if ((lane >> 3) == ((i0 >> 3) & 3) && i < LP) {
      const float ai = i0 < 32 ? sm.a0 : sm.a1;
      dloc2[i] = make_float2(ai * tx * (float)lvl.w, ai * ty * (float)lvl.h);
      dattn_q[i] = tA;
    }
  }
}

// table (B, M, S, 4*32), loc (B, Lq, M, L, P, 2), attn (B, Lq, M, L, P), out (B, Lq, M*32),
// all f32. blockIdx.y is the (batch, head) pair and warp w of block x takes query 8x + w, as
// in B2. L*P <= 64. Lane l reads word l of a table row (a float4: corner l/8, channels
// 4(l%8)..+3), so a row is 32 words.
__device__ __forceinline__ void merged_fwd(const float* __restrict__ table,
                                           const float* __restrict__ loc,
                                           const float* __restrict__ attn, float* __restrict__ out,
                                           const LevelInfo& lv, int S, int Lq, int M, int L,
                                           int P) {
  using Word = float4;
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
  // corners: word offset row * 32) and this corner's slot weight
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

  const Word* base = reinterpret_cast<const Word*>(table + bm * (int64_t)S * 128) + lane;
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

__global__ void __launch_bounds__(32 * MSDA_WARPS_PER_BLOCK, MSDA_FWD_MIN_BLOCKS)
ms_deform_attn_merged_kernel(const float* __restrict__ table, const float* __restrict__ loc,
                             const float* __restrict__ attn, float* __restrict__ out,
                             LevelInfo lv, int S, int Lq, int M, int L, int P) {
  merged_fwd(table, loc, attn, out, lv, S, Lq, M, L, P);
}

// B5 on a bf16 table: the paired-head body (PAIRED_MERGED). Grid (ceil(Lq / 8), ceil(M / 2),
// B).
__global__ void __launch_bounds__(32 * MSDA_WARPS_PER_BLOCK, MSDA_FWD_MIN_BLOCKS)
ms_deform_attn_merged_bf16_kernel(const __nv_bfloat16* __restrict__ table,
                                  const float* __restrict__ loc, const float* __restrict__ attn,
                                  __nv_bfloat16* __restrict__ out, LevelInfo lv, int S, int Lq,
                                  int M, int L, int P) {
  paired_fwd_bf16<PAIRED_MERGED>(table, loc, attn, out, lv, S, Lq, M, L, P);
}

// value (B, S, M, 32) -> table (B, M, S, 4*32), f32: one warp per table row, lane j on word
// j of the row (a float4: corner j/8, channels 4(j%8)..+3), so the warp writes one 512-byte
// row and reads four value head rows. A copy of bits, no arithmetic. blockIdx.y is the
// (batch, head) pair and each block covers MSDA_WARPS_PER_BLOCK consecutive tokens, so no
// lane divides 64-bit indices.
__global__ void ms_deform_attn_merged_table_kernel(const float* __restrict__ value,
                                                   float* __restrict__ table, LevelInfo lv,
                                                   int S, int M, int L) {
  using Word = float4;
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
  const Word* src = reinterpret_cast<const Word*>(value + (tok * M + m) * 32);
  reinterpret_cast<Word*>(table + ((int64_t)bm * S + s) * 128)[j] = __ldg(src + (j & 7));
}

// The bf16 table build. A bf16 row is 256 bytes, 16 words of 16 bytes: lane j of a half-warp
// moves word j (corner j >> 2, channels 8(j & 3)..+7), so the warp moves two rows at a time,
// tokens s and s + 1, 512 contiguous bytes of the table. Each warp walks
// MSDA_TABLE_TOKENS consecutive tokens of one (batch, head) (blockIdx.y): a half finds its
// first token's level, row and column once (one division) and steps them two tokens at a
// time, and again only where it crosses into the next level; all MSDA_TABLE_ROWS rows' loads
// of a half are issued before its first store, so each lane keeps MSDA_TABLE_ROWS 16-byte
// loads in flight. A copy of bits, no arithmetic. It replaces, on bf16 value, the XLA
// prologue gomatching_tpu/ops/deform_attn.py:_merged_corner_table that
// ms_deform_attn_pallas runs (deform_attn_pallas.py:89). Bound: bytes (value read once, the
// table written once); chip_smoke.py phase 20 prints its share of the memory rate.
#define MSDA_TABLE_ROWS 8                        // rows a half-warp moves
#define MSDA_TABLE_TOKENS (2 * MSDA_TABLE_ROWS)  // consecutive tokens a warp walks

// Token s's level dims (h, w, start) and its row and column on that level.
struct TokenPos {
  int h, w, start, y, x;
};

__device__ __forceinline__ TokenPos token_pos(const LevelInfo& lv, int L, int s) {
  TokenPos p;
  int l = 0;
#pragma unroll
  for (int i = 1; i < MSDA_MAX_LEVELS; ++i) l += (i < L && s >= lv.start[i]);
  level_dims(lv, l, p.h, p.w, p.start);
  const int k = s - p.start;
  p.y = k / p.w;
  p.x = k - p.y * p.w;
  return p;
}

__global__ void __launch_bounds__(32 * MSDA_WARPS_PER_BLOCK, MSDA_FWD_MIN_BLOCKS)
ms_deform_attn_merged_table_bf16_kernel(const __nv_bfloat16* __restrict__ value,
                                        __nv_bfloat16* __restrict__ table, LevelInfo lv, int S,
                                        int M, int L) {
  const int lane = threadIdx.x & 31;
  int s = (blockIdx.x * MSDA_WARPS_PER_BLOCK + (threadIdx.x >> 5)) * MSDA_TABLE_TOKENS +
          (lane >> 4);
  if (s >= S) return;
  const int j = lane & 15;
  const int dy = j >> 3;        // corner (0,0), (0,+x), (+y,0), (+y,+x); edge duplicates
  const int dx = (j >> 2) & 1;
  const int bm = blockIdx.y;
  const int m = bm % M;
  const int b = bm / M;
  const int tw = M * 4;  // 16-byte words a token of value
  const uint4* src =
      reinterpret_cast<const uint4*>(value + ((int64_t)b * S * M + m) * 32) + (j & 3);
  uint4* dst = reinterpret_cast<uint4*>(table + (int64_t)bm * S * 128) + j;
  TokenPos p = token_pos(lv, L, s);
  int tok[MSDA_TABLE_ROWS];  // the source token of each row, -1 past the last token
#pragma unroll
  for (int u = 0; u < MSDA_TABLE_ROWS; ++u) {
    tok[u] = s + 2 * u < S
                 ? p.start + min(p.y + dy, p.h - 1) * p.w + min(p.x + dx, p.w - 1)
                 : -1;
    p.x += 2;
    while (p.x >= p.w) {  // at most twice (a 1-wide level)
      p.x -= p.w;
      ++p.y;
    }
    if (p.y >= p.h && s + 2 * u + 2 < S) p = token_pos(lv, L, s + 2 * u + 2);
  }
  uint4 v[MSDA_TABLE_ROWS];
#pragma unroll
  for (int u = 0; u < MSDA_TABLE_ROWS; ++u)
    if (tok[u] >= 0) v[u] = __ldg(src + (int64_t)tok[u] * tw);
#pragma unroll
  for (int u = 0; u < MSDA_TABLE_ROWS; ++u)
    if (tok[u] >= 0) dst[(int64_t)(s + 2 * u) * 16] = v[u];
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
// Design. One block (FP_WARPS warps) per (query chunk, batch, head): blockIdx.x runs over the
// chunks of up to FP_QCHUNK queries of the query tiles of all source levels, fastest, so
// that the blocks of one (batch, head) run together and share that head's value rows in
// L2. A host-built table (the counterpart of the TPU's scalar-prefetched origin table)
// gives each block its source level, tile origin and width, chunk, first slot, and per
// target level the footprint origin and extent, or zeros when the footprint is over the
// per-buffer budget (the direct route: every corner from device memory, as in B1).
//   - Copy: each staged footprint is one TMA copy (cp.async.bulk.tensor.5d) of a box
//     (32, 1, Fw, Fh, 1) of value's target-level slice viewed as (32, M, W, H, B), one
//     tensor map per (source, target) level pair, encoded on the host per call
//     (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the library needs no
//     -lcuda) and passed as a __grid_constant__ parameter. Its shared-memory image is the
//     footprint (Fh, Fw, 32); cells past the map arrive as zeros. Thread 0 issues the copy
//     and the warps wait on the buffer's mbarrier. FP_NBUF = 2 buffers: the copy of the
//     next staged level is in flight while this one is sampled (the first two are issued
//     before any sampling).
//   - Sampling on B2's lane layout, per target level: warp w takes queries w, w + FP_WARPS,
//     ... of the chunk, their samples of this level in batches of 8 (a batch spans 8 / P
//     queries); lane 8c + k computes corner c of sample k (the level is fixed, so no level
//     table), its cell in the footprint when the pair is staged and the corner lies
//     inside it, else its row in device memory; the batch's 8 float4 loads (from shared
//     or device memory, per lane) are in flight before the first is used, while
//     the next batch's geometry is computed; 8 lanes read one 128-byte footprint row, 4
//     wavefronts a sample, without conflicts.
//   - The chunk's geometry (x and y in target-level pixels and the attention, per
//     (level, point) and query) is read into shared memory once, by the whole block with
//     FP_GEO_BATCH loads in flight a thread, while the first copies are in flight.
//   - A query's output accumulates over the L level passes in shared memory (FP_QCHUNK
//     rows of 128 bytes, each written only by the warp that owns the query): at the
//     last sample of a query in a level, shuffles by 8 and 16 sum the corners and lanes
//     0-7 add the 128 bytes to its row. Sums run in a fixed order: the same bits every
//     call.
//   - Blocks of FP_WARPS = 16 warps, one block an SM (at most 128 registers a thread;
//     buffers of up to 86 KB at L*P = 16: every pair from a source level onto the same or
//     a coarser level is staged at the ICDAR15 shapes, halo 5, tiles 8x16). Each half of a
//     batch has its 4 loads in flight at once (8 at once cost the 8-warp blocks of the
//     -DFP_WARPS=8 measurement build their 64 registers).
// What bounds it: the function is bound by bytes, as B2's (0.119 ms for a 1000x1778 frame
// batch of 3 on an H100). This kernel is bound by its own instructions and the latency of
// each warp's chain of batches (32 a block at L*P = 16), so by its resident warps. On an
// NVIDIA H100 80GB HBM3 at 700 W, at B = 3 and halo 5 (chip_smoke.py phase 12, in turns):
// ~1.9-2.0 ms a call with one block of 16 warps an SM and 90% of the corner taps read from
// the staged footprints (3.8-4.4 ms in its first form, which staged synchronously with one
// warp a query and one load in flight a warp); ~3% slower with the same blocks and nothing
// staged; ~1.45 ms with four blocks of 8 warps an SM (32 warps; the -DFP_WARPS=8 build,
// whose buffers of up to 7 KB fit no footprint at those shapes) and nothing staged. So
// staging saves little beside the gather at the same occupancy, and the shared memory it
// needs costs half the resident warps, which cost more. B1 takes ~0.63 ms on the same
// samples with 32 warps an SM and a chain of 2 batches a query: against it this kernel
// pays a level pass per query (4 corner reductions and partial-output updates instead of
// one store), the per-sample choice of shared or device memory, and the block's geometry
// pass and barriers. The shipped build stages (16 warps, SMEM_BLOCK_BYTES the whole 227 KB):
// it is what the entries' footprints mean. Tried and not kept: each lane loading its samples' geometry from device
// memory (the locations miss L2, and every batch waited on them), blocks of 8 warps with
// the large buffers (8 warps an SM), 8 loads in flight under a 64-register cap (spills).
// PERF.md has the numbers, from chip_smoke.py phases 12 and 13.
//
//   ms_deform_attn_footprint_fwd_bf16 -- the same kernel on bf16 value (the dtype of JAX's
//       sampler benchmark, tools/bench_deform_attn.py): value, footprints and output
//       __nv_bfloat16, TMA maps of CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 and 64-byte footprint
//       cells (the buffers stay 128-byte multiples), so the same budget stages about twice
//       the cells: 96.8% of the corner taps (B6a/b) and 98.1% (B6c) at the ICDAR15 shapes,
//       halo 5, against f32's 90.2% and 71.0%. The bilinear weight x attention products
//       and the partial outputs stay f32; JAX's kernels round the one-hot G to bf16 before
//       their product (deform_attn_vmem.py:918-919), which this does not. Held by its
//       instructions as in f32: 1.86-1.99 ms a call against f32's 1.86-2.04 on the same
//       values (phase 20).

// Warps of a block: 16, one block an SM. A measurement build (chip_smoke.py builds it with
// -DFP_WARPS=8) takes blocks of 8 warps at 64 registers, four an SM, for the other side of
// the buffers-against-occupancy trade-off; the wrappers never load it.
#ifndef FP_WARPS
#define FP_WARPS 16
#endif
#define FP_QCHUNK 128                     // queries of one block
#define FP_NBUF 2                         // footprint buffers of a block
#define FP_REC_HEAD 8
#define FP_MAX_PAIRS (MSDA_MAX_LEVELS * MSDA_MAX_LEVELS)
#define FP_PART_BYTES (FP_QCHUNK * 128)   // the chunk's partial outputs
#define FP_GEO_STRIDE (FP_QCHUNK + 1)     // +1: a batch's 8 (point, query) reads in 8 banks
#define FP_GEO_BATCH 8                    // geometry words a thread loads before it stores
// the chunk's geometry: x, y and attention per (level, point) and query, in 128-byte units
#define FP_GEO_BYTES(LP) (((3 * (LP) * FP_GEO_STRIDE * 4) + 127) / 128 * 128)
// dynamic shared memory of a block: alignment slack, partial outputs, geometry, the
// buffers, the buffers' mbarriers (ops/deform_attn_vmem.py footprints() sizes it so too)
#define FP_SMEM_BYTES(fp_bytes, LP) \
  (128 + FP_PART_BYTES + FP_GEO_BYTES(LP) + FP_NBUF * (fp_bytes) + 8 * FP_NBUF)

// Input layouts: loc (B,S,M,L,P,2) + attn (B,S,M,L,P); locT (B,M,L,P,2,Sq) + attnT
// (B,M,L,P,Sq); offT (B,2LMP,Sq) rows (l,xy,m,p) in target cells + attnT (B,LMP,Sq)
// rows (l,m,p), reference point from the slot's tile row and column.
enum FootprintGeometry { NATURAL_LOC = 0, TM_LOC = 1, TM_OFF_CELLS = 2 };

// One tensor map per (source, target) level pair, row-major; zeros for a direct pair.
struct FootprintMaps {
  CUtensorMap pair[FP_MAX_PAIRS];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
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

// Copy footprint (oy, ox) of extent ``map``'s box into ``dst`` (128-byte aligned);
// completion (``bytes``) is reported to ``bar``. One thread.
__device__ __forceinline__ void fp_copy(void* dst, const CUtensorMap* map, uint64_t* bar,
                                        uint32_t bytes, int m, int ox, int oy, int b) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(0), "r"(m), "r"(ox),
      "r"(oy), "r"(b)
      : "memory");
}

// The first staged target level at or after l2 of block record ``rec`` (L if none).
__device__ __forceinline__ int fp_next_staged(const int* __restrict__ rec, int l2, int L) {
  while (l2 < L && __ldg(rec + FP_REC_HEAD + 4 * l2 + 2) == 0) ++l2;
  return l2;
}

// Copy number n, the footprint of target level l2 of block record ``rec``, into buffer
// n % FP_NBUF through l2's tensor map of the block's source level; a footprint cell is one
// head row of ``row_bytes`` (32 values: 128 bytes of f32, 64 of bf16). One thread.
__device__ __forceinline__ void fp_issue(const int* __restrict__ rec, int l2, int n,
                                         const CUtensorMap* pair_maps, unsigned char* bufs,
                                         int fp_bytes, int row_bytes, uint64_t* bars, int m,
                                         int b) {
  const int* f = rec + FP_REC_HEAD + 4 * l2;
  const int fh = __ldg(f + 2), fw = __ldg(f + 3);
  fp_copy(bufs + (n % FP_NBUF) * fp_bytes, pair_maps + l2, &bars[n % FP_NBUF],
          (uint32_t)(fh * fw * row_bytes), m, __ldg(f + 1), __ldg(f), b);
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

// The chunk's block record and the level it samples.
struct FpBlock {
  const int* rec;
  int l1, ty0, tx0, tx, q0, nq, slot0, H1, W1, start1;
};

// One target level's geometry for the block: dims, footprint origin and extent (fh == 0:
// direct).
struct FpLevel {
  int l2, h, w, start, oy, ox, fh, fw;
};

// Corner ((lane >> 3) & 1, lane >> 4) of sample i = i0 + (lane & 7) of this warp's samples
// of level ``t`` (sample i: query j = i / P of the warp, point p = i - jP), from the
// chunk's geometry ``geo``: ``code`` is its float4 row from the head's base (>= 0), or
// -1 - its footprint cell when it is staged; ``wgt`` its weight with the attention folded
// in (0, with row 0, off the map).
__device__ __forceinline__ void fp_corner(const FpLevel& t, const float* geo, int P, int magic,
                                          int warp, int n_s, int i0, int lane, int tok4,
                                          int& code, float& wgt) {
  const int i = i0 + (lane & 7);
  code = 0;
  wgt = 0.f;
  if (i >= n_s) return;
  const int j = (i * magic) >> 16;
  const int p = i - j * P;
  const float* g = geo + (t.l2 * P + p) * 3 * FP_GEO_STRIDE + j * FP_WARPS + warp;
  float x = g[0];
  float y = g[FP_GEO_STRIDE];
  const float att = g[2 * FP_GEO_STRIDE];
  const float wf = (float)t.w;
  const float hf = (float)t.h;
  // the corners of a sample outside (-1, W) x (-1, H) are all off the map; clamping keeps
  // the int casts safe
  const bool gate = x > -1.f && y > -1.f && x < wf && y < hf;
  x = fminf(fmaxf(x, -2.f), wf + 1.f);
  y = fminf(fmaxf(y, -2.f), hf + 1.f);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  const int cx = (lane >> 3) & 1;
  const int cy = lane >> 4;
  const int xc = (int)x0 + cx;
  const int yc = (int)y0 + cy;
  if (!(gate && xc >= 0 && xc < t.w && yc >= 0 && yc < t.h)) return;
  wgt = att * (cy ? fy : 1.f - fy) * (cx ? fx : 1.f - fx);
  const int fyc = yc - t.oy;
  const int fxc = xc - t.ox;
  if (t.fh > 0 && (unsigned)fyc < (unsigned)t.fh && (unsigned)fxc < (unsigned)t.fw)
    code = -1 - (fyc * t.fw + fxc);
  else
    code = (t.start + yc * t.w + xc) * tok4;
}

// Word e of the chunk's geometry (3 L P words a query): its value and its index ``dst`` in
// ``geo``. NATURAL_LOC walks a query's 2 L P location words and L P attention words (one
// contiguous run each), the tile-major layouts row (l2, p, xy), then row (l2, p) of
// attention, queries fastest (contiguous slots).
template <int GEOM>
__device__ __forceinline__ void fp_geo_word(const FpBlock& k, const int* __restrict__ table,
                                            const float* __restrict__ a,
                                            const float* __restrict__ bt, int b, int m, int M,
                                            int S, int P, int LP, int Sq, int e, float& val,
                                            int& dst) {
  int q, w;
  if (GEOM == NATURAL_LOC) {
    q = e / (3 * LP);
    w = e - q * 3 * LP;
  } else {
    w = e / k.nq;
    q = e - w * k.nq;
  }
  int r = 0, c = 0;
  const bool valid =
      GEOM == TM_OFF_CELLS || tile_cell(k.q0 + q, k.ty0, k.tx0, k.tx, k.H1, k.W1, r, c);
  if (w >= 2 * LP) {  // attention of (level, point) i
    const int i = w - 2 * LP;
    dst = (i * 3 + 2) * FP_GEO_STRIDE + q;
    int64_t at;
    if (GEOM == NATURAL_LOC) {
      at = (((int64_t)b * S + k.start1 + r * k.W1 + c) * M + m) * LP + i;
    } else if (GEOM == TM_LOC) {
      at = (((int64_t)b * M + m) * LP + i) * Sq + k.slot0 + q;
    } else {
      const int l2 = i / P;
      at = ((int64_t)b * LP * M + (l2 * M + m) * P + (i - l2 * P)) * Sq + k.slot0 + q;
    }
    val = valid ? __ldg(bt + at) : 0.f;
    return;
  }
  const int i = w >> 1;  // coordinate xy of (level, point) i
  const int xy = w & 1;
  const int l2 = i / P;
  dst = (i * 3 + xy) * FP_GEO_STRIDE + q;
  const float size = (float)__ldg(table + 4 * l2 + 1 - xy);  // W for x, H for y
  if (GEOM == NATURAL_LOC) {
    const int64_t bsm = ((int64_t)b * S + k.start1 + r * k.W1 + c) * M + m;
    val = valid ? __ldg(a + bsm * 2 * LP + w) * size - 0.5f : -4.f;
  } else if (GEOM == TM_LOC) {
    val = valid ? __ldg(a + (((int64_t)b * M + m) * 2 * LP + w) * Sq + k.slot0 + q) * size - 0.5f
                : -4.f;
  } else {
    // the reference point in target pixels, as _kernel_v3 :763-764, plus the offset
    const int p = i - l2 * P;
    const int qt = k.q0 + q;
    const int row = qt / k.tx;
    const float sc = size / (float)(xy ? k.H1 : k.W1);
    const float ref = ((float)(xy ? k.ty0 : k.tx0) + 0.5f) * sc - 0.5f +
                      (float)(xy ? row : qt - row * k.tx) * sc;
    const int64_t orow = (int64_t)b * 2 * LP * M + ((l2 * 2 + xy) * M + m) * P + p;
    val = ref + __ldg(a + orow * Sq + k.slot0 + q);
  }
}

__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_value(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// value (B,S,M,32) of type T (float or __nv_bfloat16); a/bt the layout's locations (or
// offsets) and attention, f32; table as Footprints (ops/deform_attn_vmem.py); out
// (B,S,M*32) natural or, for TM_OFF_CELLS, (B,Sq,M*32) tile-major, of type T. fp_bytes: one
// footprint buffer (a multiple of 128). A bf16 head row is 64 bytes, in device memory and in
// a footprint alike: lane l reads channels 4(l%8)..+3 as one 8-byte word and widens it
// exactly, so the row offsets in words, the geometry, the weights (bilinear weight x
// attention, f32) and the f32 partial outputs are the f32 kernel's; the output is rounded
// once, at the store.
template <int GEOM, typename T>
__global__ void __launch_bounds__(32 * FP_WARPS, FP_WARPS == 8 ? 4 : 1)
ms_deform_attn_footprint_kernel(const __grid_constant__ FootprintMaps maps,
                                const T* __restrict__ value, const float* __restrict__ a,
                                const float* __restrict__ bt, const int* __restrict__ table,
                                T* __restrict__ out, int S, int M, int L, int P, int Sq,
                                int fp_bytes) {
  using Word = typename RowWord<T>::type;
  constexpr int row_bytes = 32 * (int)sizeof(T);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  float4* part = reinterpret_cast<float4*>(sm);  // (FP_QCHUNK, 8)
  float* geo = reinterpret_cast<float*>(sm + FP_PART_BYTES);
  const int LP = L * P;
  unsigned char* bufs = sm + FP_PART_BYTES + FP_GEO_BYTES(LP);
  uint64_t* bars = reinterpret_cast<uint64_t*>(bufs + FP_NBUF * fp_bytes);
  const int b = blockIdx.y;
  const int m = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  FpBlock k;
  k.rec = table + 4 * L + (int64_t)blockIdx.x * (FP_REC_HEAD + 4 * L);
  k.l1 = __ldg(k.rec);
  k.ty0 = __ldg(k.rec + 1);
  k.tx0 = __ldg(k.rec + 2);
  k.tx = __ldg(k.rec + 3);
  k.q0 = __ldg(k.rec + 4);
  k.nq = __ldg(k.rec + 5);
  k.slot0 = __ldg(k.rec + 6) + k.q0;  // slot of the chunk's first query
  k.H1 = __ldg(table + 4 * k.l1);
  k.W1 = __ldg(table + 4 * k.l1 + 1);
  k.start1 = __ldg(table + 4 * k.l1 + 2);
  const int tok4 = M * 8;
  const int magic = level_magic(P);
  const Word* gbase =
      reinterpret_cast<const Word*>(value + ((int64_t)b * S * M + m) * 32) + (lane & 7);
  const int grp = lane & 24;

  // thread 0 copies the staged levels in order, copy n into buffer n % FP_NBUF: the first
  // FP_NBUF now, each next one when a buffer is free
  const CUtensorMap* pair_maps = &maps.pair[k.l1 * L];
  int issued = 0, scan = 0;  // thread 0: copies issued, next level to look at
  if (tid == 0) {
#pragma unroll
    for (int n = 0; n < FP_NBUF; ++n) mbar_init(&bars[n]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (; issued < FP_NBUF; ++issued) {
      scan = fp_next_staged(k.rec, scan, L);
      if (scan == L) break;
      fp_issue(k.rec, scan++, issued, pair_maps, bufs, fp_bytes, row_bytes, bars, m, b);
    }
  }

  // the chunk's geometry, while the first copies are in flight: row (l2*P + p)*3 +
  // {x, y, attention}, queries minor; x and y in target-level pixels; a padding slot past
  // its level's edge (NATURAL_LOC, TM_LOC) gets x = y = -4 and attention 0 (off the map).
  // Each thread loads FP_GEO_BATCH words before it stores any, so that many loads are in
  // flight (one at a time, the pass waited on a device-memory round trip per query)
  const int n_el = 3 * LP * k.nq;
  for (int e0 = tid; e0 < n_el; e0 += FP_GEO_BATCH * 32 * FP_WARPS) {
    float val[FP_GEO_BATCH];
    int dst[FP_GEO_BATCH];
#pragma unroll
    for (int u = 0; u < FP_GEO_BATCH; ++u) {
      const int e = e0 + u * 32 * FP_WARPS;
      val[u] = 0.f;
      dst[u] = -1;
      if (e < n_el) fp_geo_word<GEOM>(k, table, a, bt, b, m, M, S, P, LP, Sq, e, val[u], dst[u]);
    }
#pragma unroll
    for (int u = 0; u < FP_GEO_BATCH; ++u)
      if (dst[u] >= 0) geo[dst[u]] = val[u];
  }
  __syncthreads();

  // this warp's queries: w, w + 8, ... of the chunk
  const int nqw = k.nq > warp ? (k.nq - warp + FP_WARPS - 1) / FP_WARPS : 0;
  const int n_s = nqw * P;
  int n_staged = 0;  // staged levels sampled so far
  for (int l2 = 0; l2 < L; ++l2) {
    const int* f = k.rec + FP_REC_HEAD + 4 * l2;
    FpLevel t;
    t.l2 = l2;
    t.h = __ldg(table + 4 * l2);
    t.w = __ldg(table + 4 * l2 + 1);
    t.start = __ldg(table + 4 * l2 + 2);
    t.oy = __ldg(f);
    t.ox = __ldg(f + 1);
    t.fh = __ldg(f + 2);
    t.fw = __ldg(f + 3);
    const int buf = n_staged % FP_NBUF;
    if (t.fh > 0) {
      // a copy that never completes (a tensor map the hardware refuses) traps after 2^37 SM
      // cycles (~70 s at 1.98 GHz) instead of holding the card; far above any wait of a
      // copy that completes, preemption and time-slicing with other contexts included
      const long long t0 = clock64();
      while (!mbar_try_wait(&bars[buf], (uint32_t)((n_staged / FP_NBUF) & 1)))
        if (clock64() - t0 > (1ll << 37)) __trap();
    }
    const Word* fbase = reinterpret_cast<const Word*>(bufs + buf * fp_bytes) + (lane & 7);
    // the warp's samples of this level in batches of 8; at the last sample of query j
    // (index qend), its corners are summed into the query's row
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int j = 0, qend = P - 1;
    int code;
    float wgt;
    fp_corner(t, geo, P, magic, warp, n_s, 0, lane, tok4, code, wgt);
    for (int i0 = 0; i0 < n_s; i0 += 8) {
      int code_n = 0;
      float wgt_n = 0.f;
      if (i0 + 8 < n_s)
        fp_corner(t, geo, P, magic, warp, n_s, i0 + 8, lane, tok4, code_n, wgt_n);
      // two halves of 4 loads in flight (8 at once cost the 8-warp blocks their 64 registers)
#pragma unroll
      for (int h = 0; h < 8; h += 4) {
        float4 v[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int ck = __shfl_sync(MSDA_FULL, code, grp | (h + s));
          v[s] = as_float4(ck >= 0 ? __ldg(gbase + ck) : fbase[(-1 - ck) * 8]);
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float w = __shfl_sync(MSDA_FULL, wgt, grp | (h + s));
          acc.x = fmaf(w, v[s].x, acc.x);
          acc.y = fmaf(w, v[s].y, acc.y);
          acc.z = fmaf(w, v[s].z, acc.z);
          acc.w = fmaf(w, v[s].w, acc.w);
          if (i0 + h + s == qend && j < nqw) {  // warp-uniform
#pragma unroll
            for (int x = 8; x <= 16; x <<= 1) {
              acc.x += __shfl_xor_sync(MSDA_FULL, acc.x, x);
              acc.y += __shfl_xor_sync(MSDA_FULL, acc.y, x);
              acc.z += __shfl_xor_sync(MSDA_FULL, acc.z, x);
              acc.w += __shfl_xor_sync(MSDA_FULL, acc.w, x);
            }
            if (lane < 8) {
              float4* row = part + (j * FP_WARPS + warp) * 8 + lane;
              if (l2 > 0) {
                const float4 o = *row;
                acc.x += o.x;
                acc.y += o.y;
                acc.z += o.z;
                acc.w += o.w;
              }
              *row = acc;
            }
            acc = make_float4(0.f, 0.f, 0.f, 0.f);
            ++j;
            qend += P;
          }
        }
      }
      code = code_n;
      wgt = wgt_n;
    }
    if (t.fh > 0) {
      ++n_staged;
      __syncthreads();  // every warp is done with this buffer
      if (tid == 0) {
        scan = fp_next_staged(k.rec, scan, L);
        if (scan < L) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          fp_issue(k.rec, scan++, issued++, pair_maps, bufs, fp_bytes, row_bytes, bars, m, b);
        }
      }
    }
  }

  // one 128-byte row per query: natural token, or the slot (TM_OFF_CELLS)
  __syncwarp();
  const float* part_f = reinterpret_cast<const float*>(part);
  const int64_t tok_stride = (int64_t)M * 32;
  for (int jj = 0; jj < nqw; ++jj) {
    const int q = jj * FP_WARPS + warp;
    int64_t row;
    if (GEOM == TM_OFF_CELLS) {
      row = (int64_t)b * Sq + k.slot0 + q;
    } else {
      int r, c;
      if (!tile_cell(k.q0 + q, k.ty0, k.tx0, k.tx, k.H1, k.W1, r, c)) continue;
      row = (int64_t)b * S + k.start1 + r * k.W1 + c;
    }
    store_value(out + row * tok_stride + m * 32 + lane, part_f[q * 32 + lane]);
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

// The limits of the lane-layout kernels B1-B4 (ops/deform_attn.py check_lane_layout
// raises on the same): D == 32, one row word per lane and corner; at most two samples a
// lane; the (batch, head) pairs within gridDim.y; the word index of every token row of one
// batch item in int (8 float4 words a head row of f32; a bf16 head row is 4 16-byte words,
// paired_fwd_bf16).
static bool lane_layout_ok(int B, int S, int M, int D, int L, int P) {
  return L >= 1 && L <= MSDA_MAX_LEVELS && D == 32 && P >= 1 && L * P <= MSDA_MAX_SAMPLES &&
         (int64_t)B * M <= 65535 && (int64_t)S * M * 8 <= INT32_MAX;
}

// The forwards' grids: 8 queries (tokens) a block on x. The f32 kernels take a (batch,
// head) pair a y index; the paired-head bf16 kernels a head pair a y index and the batch
// item on z (B * M <= 65535 by lane_layout_ok). Returns 0 where there is nothing to launch.
static dim3 fwd_grid(bool paired, int B, int Nq, int M) {
  if (B * M == 0 || Nq == 0) return dim3(0);
  const int x = (Nq + MSDA_WARPS_PER_BLOCK - 1) / MSDA_WARPS_PER_BLOCK;
  return paired ? dim3(x, (M + 1) / 2, B) : dim3(x, B * M);
}

template <typename V>
static int launch_queries(void (*kernel)(const V*, const float*, const float*, V*, LevelInfo,
                                         int, int, int, int, int),
                          bool paired, const V* value, const float* loc, const float* attn,
                          V* out, const int* shapes, int B, int S, int Lq, int M, int D, int L,
                          int P, void* stream) {
  if (!lane_layout_ok(B, S, M, D, L, P)) return (int)cudaErrorInvalidValue;
  const dim3 grid = fwd_grid(paired, B, Lq, M);
  if (grid.x == 0) return (int)cudaSuccess;
  kernel<<<grid, 32 * MSDA_WARPS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      value, loc, attn, out, make_levels(shapes, L), S, Lq, M, L, P);
  return (int)cudaGetLastError();
}

template <typename V>
static int launch_encoder(void (*kernel)(const V*, const float*, const float*, V*, LevelInfo,
                                         int, int, int, int),
                          bool paired, const V* value, const float* off, const float* logits,
                          V* out, const int* shapes, int B, int S, int M, int D, int L, int P,
                          void* stream) {
  if (!lane_layout_ok(B, S, M, D, L, P)) return (int)cudaErrorInvalidValue;
  const dim3 grid = fwd_grid(paired, B, S, M);
  if (grid.x == 0) return (int)cudaSuccess;
  kernel<<<grid, 32 * MSDA_WARPS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      value, off, logits, out, make_levels(shapes, L), S, M, L, P);
  return (int)cudaGetLastError();
}

extern "C" int ms_deform_attn_queries_fwd(const float* value, const float* loc,
                                          const float* attn, float* out, const int* shapes,
                                          int B, int S, int Lq, int M, int D, int L, int P,
                                          void* stream) {
  return launch_queries(ms_deform_attn_queries_kernel, false, value, loc, attn, out, shapes, B,
                        S, Lq, M, D, L, P, stream);
}

// B1 on bf16 value: value and out __nv_bfloat16, loc and attn f32.
extern "C" int ms_deform_attn_queries_fwd_bf16(const __nv_bfloat16* value, const float* loc,
                                               const float* attn, __nv_bfloat16* out,
                                               const int* shapes, int B, int S, int Lq, int M,
                                               int D, int L, int P, void* stream) {
  return launch_queries(ms_deform_attn_queries_bf16_kernel, true, value, loc, attn, out, shapes,
                        B, S, Lq, M, D, L, P, stream);
}

extern "C" int ms_deform_attn_encoder_fwd(const float* value, const float* off,
                                          const float* logits, float* out, const int* shapes,
                                          int B, int S, int M, int D, int L, int P,
                                          void* stream) {
  return launch_encoder(ms_deform_attn_encoder_kernel, false, value, off, logits, out, shapes,
                        B, S, M, D, L, P, stream);
}

// B2 on bf16 value: value and out __nv_bfloat16, offsets and logits f32.
extern "C" int ms_deform_attn_encoder_fwd_bf16(const __nv_bfloat16* value, const float* off,
                                               const float* logits, __nv_bfloat16* out,
                                               const int* shapes, int B, int S, int M, int D,
                                               int L, int P, void* stream) {
  return launch_encoder(ms_deform_attn_encoder_bf16_kernel, true, value, off, logits, out,
                        shapes, B, S, M, D, L, P, stream);
}

// What the runtime made of a kernel (which: 0 B1, 1 B2, 2 B4, 3 B5, 4 B3; 5, 6, 7 the
// footprint kernel's NATURAL_LOC, TM_LOC and TM_OFF_CELLS instantiations, at ``smem_bytes``
// of dynamic shared memory a block; 0 for the others; 8 B1 and 9 B2 on bf16 value; 10 B5 and
// 11 its table build on bf16; 12, 13, 14 the footprint kernel's three on bf16 value; 15 B5's
// table build on f32):
// info[0] registers a thread, info[1] local memory a thread in bytes (stack and spills),
// info[2] resident warps per SM, info[3] static shared memory a block in bytes.
extern "C" int ms_deform_attn_kernel_info(int which, int smem_bytes, int* info) {
  const void* fns[] = {(const void*)ms_deform_attn_queries_kernel,
                       (const void*)ms_deform_attn_encoder_kernel,
                       (const void*)ms_deform_attn_encoder_bwd_kernel,
                       (const void*)ms_deform_attn_merged_kernel,
                       (const void*)ms_deform_attn_queries_bwd_kernel,
                       (const void*)ms_deform_attn_footprint_kernel<NATURAL_LOC, float>,
                       (const void*)ms_deform_attn_footprint_kernel<TM_LOC, float>,
                       (const void*)ms_deform_attn_footprint_kernel<TM_OFF_CELLS, float>,
                       (const void*)ms_deform_attn_queries_bf16_kernel,
                       (const void*)ms_deform_attn_encoder_bf16_kernel,
                       (const void*)ms_deform_attn_merged_bf16_kernel,
                       (const void*)ms_deform_attn_merged_table_bf16_kernel,
                       (const void*)ms_deform_attn_footprint_kernel<NATURAL_LOC, __nv_bfloat16>,
                       (const void*)ms_deform_attn_footprint_kernel<TM_LOC, __nv_bfloat16>,
                       (const void*)ms_deform_attn_footprint_kernel<TM_OFF_CELLS, __nv_bfloat16>,
                       (const void*)ms_deform_attn_merged_table_kernel};
  const int n_fns = (int)(sizeof(fns) / sizeof(fns[0]));
  if (which < 0 || which >= n_fns || smem_bytes < 0 || smem_bytes > 232448)
    return (int)cudaErrorInvalidValue;
  const bool footprint = (which >= 5 && which <= 7) || (which >= 12 && which <= 14);
  cudaError_t e;
  if (footprint) {
    e = cudaFuncSetAttribute(fns[which], cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return (int)e;
  }
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fns[which]);
  if (e != cudaSuccess) return (int)e;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  const int warps = footprint ? FP_WARPS : MSDA_WARPS_PER_BLOCK;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[which], 32 * warps, smem_bytes);
  info[2] = blocks * warps;
  info[3] = (int)attr.sharedSizeBytes;
  return (int)e;
}

// The limits of B5 and its table build (ops/deform_attn_merged.py checks the same): D ==
// 32; L*P <= 64 samples; the (batch, head) pairs within gridDim.y (B5 bf16: the head pairs on
// y and the batch items on z); the word index of every table row of one (batch, head) pair
// (32 words a row of f32, 16 of bf16) in int.
static bool merged_ok(int B, int S, int M, int D, int L, int P) {
  return L >= 1 && L <= MSDA_MAX_LEVELS && D == 32 && P >= 1 && L * P <= MSDA_MAX_SAMPLES &&
         (int64_t)B * M <= 65535 && (int64_t)S * 32 <= INT32_MAX;
}

// ``paired``: B5 bf16's grid (fwd_grid's paired-head one), else one (batch, head) a y index.
template <typename T>
static int launch_merged(void (*kernel)(const T*, const float*, const float*, T*, LevelInfo, int,
                                        int, int, int, int),
                         bool paired, const T* table, const float* loc, const float* attn,
                         T* out, const int* shapes, int B, int S, int Lq, int M, int D, int L,
                         int P, void* stream) {
  if (!merged_ok(B, S, M, D, L, P)) return (int)cudaErrorInvalidValue;
  const dim3 grid = fwd_grid(paired, B, Lq, M);
  if (grid.x == 0) return (int)cudaSuccess;
  kernel<<<grid, 32 * MSDA_WARPS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      table, loc, attn, out, make_levels(shapes, L), S, Lq, M, L, P);
  return (int)cudaGetLastError();
}

// ``tokens``: the consecutive tokens of one (batch, head) a block covers (one a warp for f32,
// MSDA_TABLE_TOKENS a warp for bf16).
template <typename T>
static int launch_table(void (*kernel)(const T*, T*, LevelInfo, int, int, int), int tokens,
                        const T* value, T* table, const int* shapes, int B, int S, int M, int D,
                        int L, void* stream) {
  if (!merged_ok(B, S, M, D, L, 1)) return (int)cudaErrorInvalidValue;
  if (B * M == 0 || S == 0) return (int)cudaSuccess;
  const dim3 grid((S + tokens - 1) / tokens, B * M);
  kernel<<<grid, 32 * MSDA_WARPS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      value, table, make_levels(shapes, L), S, M, L);
  return (int)cudaGetLastError();
}

extern "C" int ms_deform_attn_merged_fwd(const float* table, const float* loc,
                                         const float* attn, float* out, const int* shapes,
                                         int B, int S, int Lq, int M, int D, int L, int P,
                                         void* stream) {
  return launch_merged(ms_deform_attn_merged_kernel, false, table, loc, attn, out, shapes, B, S,
                       Lq, M, D, L, P, stream);
}

// B5 on a bf16 table: table and out __nv_bfloat16, loc and attn f32.
extern "C" int ms_deform_attn_merged_fwd_bf16(const __nv_bfloat16* table, const float* loc,
                                              const float* attn, __nv_bfloat16* out,
                                              const int* shapes, int B, int S, int Lq, int M,
                                              int D, int L, int P, void* stream) {
  return launch_merged(ms_deform_attn_merged_bf16_kernel, true, table, loc, attn, out, shapes, B,
                       S, Lq, M, D, L, P, stream);
}

extern "C" int ms_deform_attn_merged_table(const float* value, float* table, const int* shapes,
                                           int B, int S, int M, int D, int L, void* stream) {
  return launch_table(ms_deform_attn_merged_table_kernel, MSDA_WARPS_PER_BLOCK, value, table,
                      shapes, B, S, M, D, L, stream);
}

// B5's table build on bf16 value: value and table __nv_bfloat16.
extern "C" int ms_deform_attn_merged_table_bf16(const __nv_bfloat16* value, __nv_bfloat16* table,
                                                const int* shapes, int B, int S, int M, int D,
                                                int L, void* stream) {
  return launch_table(ms_deform_attn_merged_table_bf16_kernel,
                      MSDA_WARPS_PER_BLOCK * MSDA_TABLE_TOKENS, value, table, shapes, B, S, M, D,
                      L, stream);
}

extern "C" int ms_deform_attn_queries_bwd(const float* value, const float* loc,
                                          const float* attn, const float* dout, float* dvalue,
                                          float* dloc, float* dattn, const int* shapes, int B,
                                          int S, int Lq, int M, int D, int L, int P,
                                          void* stream) {
  if (!lane_layout_ok(B, S, M, D, L, P)) return (int)cudaErrorInvalidValue;
  if (B * M == 0 || Lq == 0) return (int)cudaSuccess;
  const dim3 grid((Lq + MSDA_WARPS_PER_BLOCK - 1) / MSDA_WARPS_PER_BLOCK, B * M);
  ms_deform_attn_queries_bwd_kernel<<<grid, 32 * MSDA_WARPS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      value, loc, attn, dout, dvalue, dloc, dattn, make_levels(shapes, L), S, Lq, M, L, P);
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

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda at link time).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor maps of a call: for each staged (source, target) pair (boxes[2 * pair] = (Fh,
// Fw), 0 for a direct pair), value's target-level slice viewed innermost first as (32, M,
// W, H, B) with a box of (32, 1, Fw, Fh, 1); cells past the map read as zeros. Elements of
// ``dtype``, ``esize`` bytes each (a head row of 128 or 64 bytes, a multiple of 16 as TMA
// needs of strides and of the box's inner extent).
static int encode_maps(FootprintMaps& maps, const void* value, CUtensorMapDataType dtype,
                       int esize, const int* shapes, const int* boxes, int B, int S, int M,
                       int L) {
  memset(&maps, 0, sizeof(maps));
  const EncodeTiledFn encode = encode_tiled();
  int start = 0;
  for (int l2 = 0; l2 < L; ++l2) {
    const int h = shapes[2 * l2], w = shapes[2 * l2 + 1];
    for (int l1 = 0; l1 < L; ++l1) {
      const int fh = boxes[2 * (l1 * L + l2)], fw = boxes[2 * (l1 * L + l2) + 1];
      if (fh == 0) continue;
      if (encode == nullptr) return (int)cudaErrorNotSupported;
      const cuuint64_t dims[5] = {32, (cuuint64_t)M, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)B};
      const cuuint64_t row = 32 * (cuuint64_t)esize;
      const cuuint64_t strides[4] = {row, (cuuint64_t)M * row, (cuuint64_t)M * w * row,
                                     (cuuint64_t)M * S * row};
      const cuuint32_t box[5] = {32, 1, (cuuint32_t)fw, (cuuint32_t)fh, 1};
      const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
      const CUresult r = encode(
          &maps.pair[l1 * L + l2], dtype, 5,
          (void*)((const char*)value + (int64_t)start * M * 32 * esize), dims, strides, box, elem,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
    }
    start += h * w;
  }
  return (int)cudaSuccess;
}

template <int GEOM, typename T>
static int launch_footprint(const FootprintMaps& maps, const T* value, const float* a,
                            const float* b, const int* table, T* out, dim3 grid, int S, int M,
                            int L, int P, int Sq, int fp_bytes, cudaStream_t stream) {
  const int smem = FP_SMEM_BYTES(fp_bytes, L * P);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(ms_deform_attn_footprint_kernel<GEOM, T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  ms_deform_attn_footprint_kernel<GEOM, T><<<grid, 32 * FP_WARPS, smem, stream>>>(
      maps, value, a, b, table, out, S, M, L, P, Sq, fp_bytes);
  return (int)cudaGetLastError();
}

// The footprint kernel on value of type T, for either entry below.
template <typename T>
static int footprint_fwd(int geometry, const T* value, CUtensorMapDataType dtype, const float* a,
                         const float* b, const int* table, T* out, const int* shapes,
                         const int* boxes, int B, int S, int M, int D, int L, int P, int n_items,
                         int Sq, int fp_bytes, void* stream) {
  if (L < 1 || L > MSDA_MAX_LEVELS || D != 32 || P < 1 || L * P > MSDA_MAX_SAMPLES ||
      B > 65535 || M > 65535 || (int64_t)S * M * 8 > INT32_MAX || fp_bytes < 0 ||
      fp_bytes % 128 || FP_SMEM_BYTES(fp_bytes, L * P) > 232448)
    return (int)cudaErrorInvalidValue;
  if (n_items == 0 || B == 0 || M == 0) return (int)cudaSuccess;
  FootprintMaps maps;
  const int rc = encode_maps(maps, value, dtype, (int)sizeof(T), shapes, boxes, B, S, M, L);
  if (rc != (int)cudaSuccess) return rc;
  const dim3 grid(n_items, B, M);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (geometry) {
    case NATURAL_LOC:
      return launch_footprint<NATURAL_LOC>(maps, value, a, b, table, out, grid, S, M, L, P, Sq,
                                           fp_bytes, st);
    case TM_LOC:
      return launch_footprint<TM_LOC>(maps, value, a, b, table, out, grid, S, M, L, P, Sq,
                                      fp_bytes, st);
    case TM_OFF_CELLS:
      return launch_footprint<TM_OFF_CELLS>(maps, value, a, b, table, out, grid, S, M, L, P, Sq,
                                            fp_bytes, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// geometry: a FootprintGeometry; table (device int32), boxes (host, (Fh, Fw) per (source,
// target) pair, 0 for a direct pair) and fp_bytes (one footprint buffer, a multiple of 128)
// from the wrapper's Footprints; shapes (host) the level (H, W); n_items blocks per (batch,
// head); Sq the token axis of a and b.
extern "C" int ms_deform_attn_footprint_fwd(int geometry, const float* value, const float* a,
                                            const float* b, const int* table, float* out,
                                            const int* shapes, const int* boxes, int B, int S,
                                            int M, int D, int L, int P, int n_items, int Sq,
                                            int fp_bytes, void* stream) {
  return footprint_fwd(geometry, value, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a, b, table, out,
                       shapes, boxes, B, S, M, D, L, P, n_items, Sq, fp_bytes, stream);
}

// The footprint kernel on bf16 value: value, the staged footprints and out __nv_bfloat16
// (TMA maps of CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 64-byte footprint cells), a and b f32.
extern "C" int ms_deform_attn_footprint_fwd_bf16(int geometry, const __nv_bfloat16* value,
                                                 const float* a, const float* b, const int* table,
                                                 __nv_bfloat16* out, const int* shapes,
                                                 const int* boxes, int B, int S, int M, int D,
                                                 int L, int P, int n_items, int Sq, int fp_bytes,
                                                 void* stream) {
  return footprint_fwd(geometry, value, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, b, table, out,
                       shapes, boxes, B, S, M, D, L, P, n_items, Sq, fp_bytes, stream);
}
