// Fused predict-then-train dense SGD for Hopper (sm_90a).
//
// Replaces twtml_tpu/ops/pallas_sgd.py::_sgd_kernel, the TPU kernel that
// runs MLlib's GradientDescent loop on a [B, F] design matrix held in VMEM:
//   preds = X·w0; then for it = 1..N:
//     r = X·w − y (least squares) or σ(X·w) − y (logistic);
//     g = Xᵀr / max(count, 1);  η = stepSize/√it;
//     w ← w·(1 − η·λ) − η·g   (skipped when count == 0);
//     frozen from the next iteration once ‖Δw‖ < tol·max(‖w‖, 1).
//
// What bounds it on an H100: operations, once X is on chip. Each iteration
// does 4 flops per element of X (X·w, then Xᵀr) and, if X stays in shared
// memory, moves no bytes of X off chip; f32 X is read from device memory
// once. X is stored in bf16 (the bigram counts are small integers, exact in
// bf16); every product, sum, w, r and g stays in f32.
//
// Design: one persistent cooperative launch a call (the TPU kernel's own
// idea: load X once and keep it on chip for the whole loop).
//   - Grid: at most one CTA an SM (cudaLaunchCooperativeKernel, so all CTAs
//     are co-resident); the launch plan (ops/fused_sgd.py::launch_plan)
//     sizes it. CTA c owns rows [c·B/grid, (c+1)·B/grid).
//   - Prologue: each CTA reads its rows of the caller's f32 X, labels and
//     mask once, applies where(mask > 0, ·, 0) (NaN/Inf in masked rows stays
//     out), converts X to bf16 and keeps it in dynamic shared memory. Rows
//     that do not fit go to a bf16 spill buffer written once here and read
//     from L2 (ld.global.cg) each iteration. At the operating point
//     (B = 16384, F = 1004, fpad 1008, 132 SMs) a CTA owns 124-125 rows,
//     stored 1024 columns wide; 103 stay resident (210,944 B of X + 21,456 B
//     of w, reduction slots, y, r and scratch = 232,400 B of the 232,448 B a
//     block may use) and 21-22 spill: 13,596 rows resident, 2,788 spilled
//     (5.7 MB, in L2). Registers cannot hold the rest: w, the Xᵀr
//     accumulator and two row buffers take ~166 of the 168 a thread may
//     have at 384 threads a CTA (at 512 threads the cap is 128 and ptxas
//     spills in the row loop). A warp's spill rows are its last; loading
//     the next row into the other register buffer hides their L2 latency.
//   - One pass over X an iteration: a warp takes a row, lanes own 16-byte
//     groups of 8 columns; r = x·w − y by warp shuffle, then acc += r·x
//     from the same registers (w and acc in registers). The CTA reduces
//     its warps' accumulators in a fixed order into one [fpad] partial.
//     Wider than 1024 columns, w stays in shared memory and the columns go
//     in tiles of 1024: r for every row first, then Xᵀr tile by tile (two
//     shared-memory passes a row).
//   - Grid barrier. CTA j reduces its slice of columns across the CTA
//     partials in a fixed order, applies the update with the same
//     non-contracting intrinsics as the JAX loop's f32 arithmetic, writes
//     its slice of w and its partials of ‖Δw‖² and ‖w‖².
//   - Grid barrier. Every CTA reads the new w and reduces the norm partials
//     in the same fixed order, so every CTA takes the same converged
//     decision and the grid leaves the loop together: after the freeze no
//     work is done. A batch with count == 0 runs no iteration at all.
// No float atomics anywhere: reruns are bitwise equal (on one card; the
// order of the sums depends on the grid). One launch a call.
//
// Residual modes: the loss is a template parameter (two instantiations of
// one kernel, chosen by the C entry's `residual_mode`): least squares
// r = x·w − y, or logistic r = 1/(1 + expf(−x·w)) − y (MLlib's
// LogisticGradient multiplier; expf, not the approximate __expf). preds
// stays the raw margin X·w0 in both; the step thresholds it. A masked row
// was zeroed in the prologue, so its logistic residual is σ(0) − 0 = 0.5,
// not 0: it still adds nothing to Xᵀr, because every element of its row
// of X is 0 (NaN/Inf that the caller left in a masked row never reached
// shared memory).
//
// What Hopper offers and this design leaves out: tensor cores. Both
// products are matrix × vector (N = 1, while wgmma takes N >= 8), and bf16
// operands would round w and r at each product, which the f32 twin does
// not; so the kernel stays on the f32 FMA units, and so does its bound.
// TMA and clusters buy nothing for a one-time, row-contiguous prologue.
//
// ---- fused_predict_kernel: the predict-only mode (N = 0, every served
// dense batch): preds = bf16(where(mask > 0, X, 0))·w0 in f32, w_out = w0,
// 0 iterations. What bounds it: bytes, one read of f32 X (66 MB at B =
// 16384, F = 1004: 0.0197 ms at 3.35 TB/s); at the serve batch (B = 256,
// 1 MB) the launch and one trip to device memory. Design: a plain launch
// (no cooperative launch, no grid barrier, no count, X never stored): a warp
// takes a row at a time, grid-stride over the rows, and reads its f32
// columns straight from device memory with 16-byte read-only loads, the
// next row's loads in flight while this row computes (two register
// buffers); w0 stays in registers (narrow) or shared memory (wide) across
// the warp's rows. The arithmetic is the training kernel's first row pass
// instruction for instruction: the same lane owns the same 8-column groups,
// stage_row's where-and-round (pack_bf16x2), dot8 in the same order, then
// warp_sum; wider than 1024 columns, row_pass_wide's order (the dot carried
// across tiles). So its preds equal bitwise the preds of a launch of the
// training kernel on the same batch. A lane's two 16-byte loads of one
// group share a 32-byte sector; they go through L1 (ld.global.nc), so the
// second finds the sector the first brought in and X crosses from L2 once.
//
// ---- tenant_sgd_kernel: B1 with a tenant grid dimension, M tenants' loops
// in one cooperative launch (the tenant plane's vmap form); its section
// below gives its design.
//
// ---- tenant_iteration_kernel: the data-parallel split with that tenant
// grid (the vmap form over a data axis), one launch an iteration around ONE
// all-reduce of every tenant's Xᵀr and count; its section below gives its
// design.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 384;  // 12 warps: up to 168 registers a thread
constexpr int kWarps = kThreads / 32;
constexpr int kVpl = 4;                     // 8-column groups a lane holds
constexpr int kTileGroups = 32 * kVpl;      // 128 groups = 1024 columns
constexpr int kTileCols = kTileGroups * 8;
constexpr int kReduceSlots = 4;             // warps summed per slot in rounds
constexpr int kScratchFloats = 4;  // CTA-wide broadcast slots
constexpr int kConvergedSlot = 0;
constexpr int kCountSlot = 1;
constexpr int kMaxTenants = 32;  // tenants a tenant-grid launch: one bit each in a mask
constexpr int kPredictThreads = 256;  // 8 warps, two CTAs an SM
constexpr int kPredictWarps = kPredictThreads / 32;

// The launch plan (ops/fused_sgd.py) sizes the shared memory from its own
// copy of these constants; ops/_build.py passes that copy as -D flags, so
// the two cannot drift apart without the build failing here.
#if !defined(TWTML_SGD_THREADS) || !defined(TWTML_SGD_TILE_COLUMNS) || \
    !defined(TWTML_SGD_REDUCE_SLOTS) || !defined(TWTML_SGD_SCRATCH_FLOATS) || \
    !defined(TWTML_SGD_PREDICT_THREADS) || !defined(TWTML_SGD_TENANTS_PER_LAUNCH) || \
    !defined(TWTML_SGD_PROBE_PROLOGUE_EDGES) || !defined(TWTML_SGD_PROBE_ITERATION_EDGES) || \
    !defined(TWTML_SGD_PROBE_SPLIT_EDGES)
#error "build through twtml_tpu_torch/ops/_build.py, which passes the launch plan's constants"
#endif
static_assert(kThreads == TWTML_SGD_THREADS, "THREADS differs from ops/fused_sgd.py");
static_assert(kPredictThreads == TWTML_SGD_PREDICT_THREADS,
              "PREDICT_THREADS differs from ops/fused_sgd.py");
static_assert(kMaxTenants == TWTML_SGD_TENANTS_PER_LAUNCH,
              "TENANTS_PER_LAUNCH differs from ops/fused_sgd.py");
static_assert(kTileCols == TWTML_SGD_TILE_COLUMNS, "TILE_COLUMNS differs from ops/fused_sgd.py");
static_assert(kReduceSlots == TWTML_SGD_REDUCE_SLOTS, "REDUCE_SLOTS differs from ops/fused_sgd.py");
static_assert(kScratchFloats == TWTML_SGD_SCRATCH_FLOATS,
              "SCRATCH_FLOATS differs from ops/fused_sgd.py");

struct Params {
  const float* x;       // [rows, features] f32, row stride features
  const float* labels;  // [rows] f32
  const float* mask;    // [rows] f32
  const float* w0;      // [features] f32
  float* w_out;         // [features] f32
  float* preds;         // [rows] f32
  __nv_bfloat16* spill; // [grid, spill_per_cta, 8·stride] bf16
  float* partials;      // [grid, fpad] f32: each CTA's Xᵀr
  float* wbuf;          // [fpad] f32: w after each update
  float* count_part;    // [grid] f32
  float* norm_part;     // [grid, 2] f32: ‖Δw‖², ‖w‖² of a CTA's columns
  float* iterations;    // [1] f32: iterations run (for the caller's log)
  int rows, features, fpad, nvec, rows_cap, resident, spill_per_cta;
  int stride;  // 16-byte groups a stored row takes: kTileGroups when narrow
  int num_iterations;
  float step_size, l2_reg, tol;
};

// Byte offsets of the dynamic shared memory, each 16-byte aligned: w
// [fpad] f32 at 0, the reduction slots, y and r [rows_cap] f32, the
// broadcast scratch, then the resident bf16 rows of X. The launch plan
// (ops/fused_sgd.py) computes the same and passes it to the C entry, which
// refuses a plan that differs. (Offsets passed in as kernel parameters
// instead cost 5 registers and ~1.5 % of the kernel's time on an H100:
// the compiler no longer sees how the regions relate.)
struct Layout {
  size_t red, y, r, scratch, x;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// 16-byte groups a stored bf16 row takes: rows up to kTileCols wide are
// padded to kTileCols so that the narrow pass needs no bounds checks.
__host__ __device__ inline int row_groups(int fpad) {
  return (fpad <= kTileCols ? kTileCols : fpad) / 8;
}

__host__ __device__ inline Layout layout(int fpad, int rows_cap) {
  Layout l;
  l.red = align16((size_t)fpad * 4);
  l.y = l.red + (size_t)kReduceSlots * kTileCols * 4;
  l.r = l.y + align16((size_t)rows_cap * 4);
  l.scratch = l.r + align16((size_t)rows_cap * 4);
  l.x = l.scratch + kScratchFloats * 4;
  return l;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;  // the same bits in every lane
}

// bf16 → f32 is exact: the bf16 bits are the f32's high half
__device__ __forceinline__ float lo_bf16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ float dot8(const uint4 x, const float* w, float acc) {
  acc = fmaf(lo_bf16(x.x), w[0], acc);
  acc = fmaf(hi_bf16(x.x), w[1], acc);
  acc = fmaf(lo_bf16(x.y), w[2], acc);
  acc = fmaf(hi_bf16(x.y), w[3], acc);
  acc = fmaf(lo_bf16(x.z), w[4], acc);
  acc = fmaf(hi_bf16(x.z), w[5], acc);
  acc = fmaf(lo_bf16(x.w), w[6], acc);
  acc = fmaf(hi_bf16(x.w), w[7], acc);
  return acc;
}

__device__ __forceinline__ void axpy8(float r, const uint4 x, float* acc) {
  acc[0] = fmaf(r, lo_bf16(x.x), acc[0]);
  acc[1] = fmaf(r, hi_bf16(x.x), acc[1]);
  acc[2] = fmaf(r, lo_bf16(x.y), acc[2]);
  acc[3] = fmaf(r, hi_bf16(x.y), acc[3]);
  acc[4] = fmaf(r, lo_bf16(x.z), acc[4]);
  acc[5] = fmaf(r, hi_bf16(x.z), acc[5]);
  acc[6] = fmaf(r, lo_bf16(x.w), acc[6]);
  acc[7] = fmaf(r, hi_bf16(x.w), acc[7]);
}

// w[8v .. 8v+7] from shared memory as two 16-byte loads (scalar loads at a
// lane stride of 32 bytes would conflict 8 ways on the banks).
__device__ __forceinline__ void load_w8(const float* w_s, int v, float (&out)[8]) {
  const float4* w4 = reinterpret_cast<const float4*>(w_s) + 2 * v;
  const float4 a = w4[0], b = w4[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// The residual of one row from its margin x·w and label y.
template <bool kLogistic>
__device__ __forceinline__ float residual(float dot, float y) {
  if constexpr (kLogistic) {
    return 1.f / (1.f + expf(-dot)) - y;
  } else {
    return dot - y;
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 8 f32 columns as one 16-byte group of bf16, in column order
__device__ __forceinline__ uint4 pack8(const float4 a, const float4 b) {
  return make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                    pack_bf16x2(b.z, b.w));
}

// Where local row l is stored: shared memory for a resident row, the spill
// buffer (read through L2) otherwise.
__device__ __forceinline__ const uint4* spill_row(const Params& p, int cta, int l) {
  return reinterpret_cast<const uint4*>(p.spill) +
         ((size_t)cta * p.spill_per_cta + (l - p.resident)) * p.stride;
}

// Narrow path: rows are stored kTileGroups groups wide, zero past fpad, so
// lane + 32k is always in the row and no lane needs a bounds check.
__device__ __forceinline__ void load_row_narrow(const Params& p, const uint4* x_s, int cta,
                                                int l, int lane, uint4 (&out)[kVpl]) {
  if (l < p.resident) {
    const uint4* src = x_s + (size_t)l * kTileGroups + lane;
#pragma unroll
    for (int k = 0; k < kVpl; ++k) out[k] = src[32 * k];
  } else {
    const uint4* src = spill_row(p, cta, l) + lane;
#pragma unroll
    for (int k = 0; k < kVpl; ++k) out[k] = __ldcg(src + 32 * k);
  }
}

// Wide path: the groups g0 + lane + 32k (k < kVpl) of local row l, zero
// past the row's end.
__device__ __forceinline__ void load_row(const Params& p, const uint4* x_s, int cta,
                                         int l, int g0, int lane, uint4 (&out)[kVpl]) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int nvec = p.nvec;
  if (l < p.resident) {
    const uint4* src = x_s + (size_t)l * p.stride;
#pragma unroll
    for (int k = 0; k < kVpl; ++k) {
      const int v = g0 + lane + 32 * k;
      out[k] = v < nvec ? src[v] : zero;
    }
  } else {
    const uint4* src = spill_row(p, cta, l);
#pragma unroll
    for (int k = 0; k < kVpl; ++k) {
      const int v = g0 + lane + 32 * k;
      out[k] = v < nvec ? __ldcg(src + v) : zero;
    }
  }
}

// The CTA's Xᵀr over columns [col0, col0 + kTileCols) into dst: warp w adds
// its accumulator into slot w % kReduceSlots in round w / kReduceSlots, then
// the slots are summed in slot order. A fixed order: no atomics. In a slot,
// float4 number (2k + h)·32 + lane holds columns 8(lane + 32k) + 4h + 0..3,
// so a warp's float4 accesses are contiguous (no bank conflicts).
__device__ void cta_reduce_tile(const float (&acc)[kVpl][8], float* red, float* dst,
                                int col0, int fpad) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* slot = red + (warp % kReduceSlots) * kTileCols;
#pragma unroll 1
  for (int round = 0; round < kWarps / kReduceSlots; ++round) {
    if (warp / kReduceSlots == round) {
#pragma unroll
      for (int k = 0; k < kVpl; ++k) {
        float4* d0 = reinterpret_cast<float4*>(slot) + (2 * k) * 32 + lane;
        float4* d1 = d0 + 32;
        if (round == 0) {
          *d0 = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
          *d1 = make_float4(acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
        } else {
          float4 a = *d0, b = *d1;
          a.x += acc[k][0]; a.y += acc[k][1]; a.z += acc[k][2]; a.w += acc[k][3];
          b.x += acc[k][4]; b.y += acc[k][5]; b.z += acc[k][6]; b.w += acc[k][7];
          *d0 = a;
          *d1 = b;
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < kTileCols && col0 + c < fpad; c += kThreads) {
    const int g = c >> 3;  // column c sits in group g of lane g % 32, k = g / 32
    const int at = ((2 * (g >> 5) + ((c >> 2) & 1)) * 32 + (g & 31)) * 4 + (c & 3);
    float v = red[at];
#pragma unroll
    for (int s = 1; s < kReduceSlots; ++s) v += red[s * kTileCols + at];
    dst[col0 + c] = v;
  }
  __syncthreads();
}

// One row of the narrow pass: dot = x·w by warp shuffle (preds on the first
// pass), then acc += residual(dot, y)·x from the same registers.
template <bool kLogistic>
__device__ __forceinline__ void narrow_row(const Params& p, const float (&wr)[kVpl][8],
                                           float (&acc)[kVpl][8], const uint4 (&x)[kVpl],
                                           const float* y_s, int row0, int l, int lane,
                                           bool first, bool train) {
  float dot = dot8(x[0], wr[0], 0.f);
#pragma unroll
  for (int k = 1; k < kVpl; ++k) dot += dot8(x[k], wr[k], 0.f);
  dot = warp_sum(dot);
  if (first && lane == 0) p.preds[row0 + l] = dot;
  if (train) {
    const float r = residual<kLogistic>(dot, y_s[l]);
#pragma unroll
    for (int k = 0; k < kVpl; ++k) axpy8(r, x[k], acc[k]);
  }
}

// One pass over the CTA's rows, fpad <= kTileCols: w and the Xᵀr
// accumulator in registers, each row read once; the next row of the warp
// is loaded into the other register buffer while this one computes. The
// CTA's Xᵀr is left in `acc` (row_pass_narrow reduces it).
template <bool kLogistic>
__device__ __forceinline__ void narrow_rows(const Params& p, const float* w_s, const float* y_s,
                                            const uint4* x_s, int cta, int row0, int my_rows,
                                            bool first, bool train, float (&acc)[kVpl][8]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float wr[kVpl][8];
#pragma unroll
  for (int k = 0; k < kVpl; ++k) {
    const int v = lane + 32 * k;
    if (v < p.nvec) {
      load_w8(w_s, v, wr[k]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) wr[k][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[k][e] = 0.f;
  }
  uint4 xa[kVpl], xb[kVpl];
  int l = warp;
  if (l < my_rows) load_row_narrow(p, x_s, cta, l, lane, xa);
  while (l < my_rows) {
    if (l + kWarps < my_rows) load_row_narrow(p, x_s, cta, l + kWarps, lane, xb);
    narrow_row<kLogistic>(p, wr, acc, xa, y_s, row0, l, lane, first, train);
    l += kWarps;
    if (l >= my_rows) break;
    if (l + kWarps < my_rows) load_row_narrow(p, x_s, cta, l + kWarps, lane, xa);
    narrow_row<kLogistic>(p, wr, acc, xb, y_s, row0, l, lane, first, train);
    l += kWarps;
  }
}

template <bool kLogistic>
__device__ void row_pass_narrow(const Params& p, const float* w_s, const float* y_s,
                                const uint4* x_s, float* red, int cta, int row0,
                                int my_rows, bool first, bool train) {
  float acc[kVpl][8];
  narrow_rows<kLogistic>(p, w_s, y_s, x_s, cta, row0, my_rows, first, train, acc);
  if (train) cta_reduce_tile(acc, red, p.partials + (size_t)cta * p.fpad, 0, p.fpad);
}

// fpad > kTileCols: w stays in shared memory; r for every row first, then
// Xᵀr one tile of columns at a time (two passes over each row).
template <bool kLogistic>
__device__ void row_pass_wide(const Params& p, const float* w_s, const float* y_s,
                              float* r_s, const uint4* x_s, float* red, int cta,
                              int row0, int my_rows, bool first, bool train) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int l = warp; l < my_rows; l += kWarps) {
    float dot = 0.f;
    for (int g0 = 0; g0 < p.nvec; g0 += kTileGroups) {
      uint4 xc[kVpl];
      load_row(p, x_s, cta, l, g0, lane, xc);
#pragma unroll
      for (int k = 0; k < kVpl; ++k) {
        const int v = g0 + lane + 32 * k;
        if (v < p.nvec) {
          float w8[8];
          load_w8(w_s, v, w8);
          dot = dot8(xc[k], w8, dot);
        }
      }
    }
    dot = warp_sum(dot);
    if (lane == 0) {
      if (first) p.preds[row0 + l] = dot;
      r_s[l] = residual<kLogistic>(dot, y_s[l]);
    }
  }
  if (!train) return;
  __syncthreads();
  for (int g0 = 0; g0 < p.nvec; g0 += kTileGroups) {
    float acc[kVpl][8];
#pragma unroll
    for (int k = 0; k < kVpl; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[k][e] = 0.f;
    for (int l = warp; l < my_rows; l += kWarps) {
      uint4 xc[kVpl];
      load_row(p, x_s, cta, l, g0, lane, xc);
      const float r = r_s[l];
#pragma unroll
      for (int k = 0; k < kVpl; ++k) axpy8(r, xc[k], acc[k]);
    }
    cta_reduce_tile(acc, red, p.partials + (size_t)cta * p.fpad, g0 * 8, p.fpad);
  }
}

// Prologue for local row l: the caller's f32 row, where(mask > 0, ·, 0),
// rounded to bf16 and stored p.stride groups wide (zero past the features)
// in shared memory or the spill buffer; y likewise. All of a lane's loads
// are issued before its stores.
__device__ __forceinline__ void stage_row(const Params& p, uint4* x_s, float* y_s, int cta,
                                          int row0, int l, int lane, bool vec4) {
  const int row = row0 + l, features = p.features;
  const bool keep = __ldg(p.mask + row) > 0.f;
  const float* xr = p.x + (size_t)row * features;
  uint4* dst = l < p.resident ? x_s + (size_t)l * p.stride
                              : const_cast<uint4*>(spill_row(p, cta, l));
  for (int v0 = 0; v0 < p.stride; v0 += kTileGroups) {
    float4 a[kVpl], b[kVpl];
#pragma unroll
    for (int k = 0; k < kVpl; ++k) {
      const int c0 = (v0 + lane + 32 * k) * 8;
      if (keep && vec4 && c0 + 8 <= features) {
        a[k] = __ldg(reinterpret_cast<const float4*>(xr + c0));
        b[k] = __ldg(reinterpret_cast<const float4*>(xr + c0 + 4));
      } else {  // masked row, ragged edge or zero padding
        float f8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          f8[e] = keep && c0 + e < features ? __ldg(xr + c0 + e) : 0.f;
        a[k] = make_float4(f8[0], f8[1], f8[2], f8[3]);
        b[k] = make_float4(f8[4], f8[5], f8[6], f8[7]);
      }
    }
#pragma unroll
    for (int k = 0; k < kVpl; ++k) {
      const int v = v0 + lane + 32 * k;
      if (v < p.stride) dst[v] = pack8(a[k], b[k]);
    }
  }
  if (lane == 0) y_s[l] = keep ? __ldg(p.labels + row) : 0.f;
}

// ---- the update, shared by B1 and the split: the one home of its arithmetic

// η = step/√it and 1 − η·λ of iteration it, as the JAX loop rounds them
struct StepScalars {
  float eta, scale;
};

__device__ __forceinline__ StepScalars step_scalars(const Params& p, int it) {
  const float eta = __fdiv_rn(p.step_size, __fsqrt_rn((float)it));
  return {eta, __fsub_rn(1.f, __fmul_rn(eta, p.l2_reg))};
}

// Column f's update, the JAX loop's f32 arithmetic operation for operation
// (no FMA contraction): w·(1 − η·λ) − (η·g)/max(count, 1), written to wbuf
// and w_out; adds its ‖Δw‖² and ‖w‖² terms to d and n.
__device__ __forceinline__ void update_column(const Params& p, int f, float wo, float g,
                                              StepScalars k, float denom, float& d, float& n) {
  const float wn = __fsub_rn(__fmul_rn(wo, k.scale), __fdiv_rn(__fmul_rn(k.eta, g), denom));
  const float dw = __fsub_rn(wn, wo);
  d = fmaf(dw, dw, d);
  n = fmaf(wn, wn, n);
  p.wbuf[f] = wn;
  if (f < p.features) p.w_out[f] = wn;
}

// The CTA's columns [col0, col1), 8 at a time, summed across the `ncta`
// CTA partials at p.partials in a fixed order: lane & 7 takes column f0 +
// (lane & 7), and the warps read partial rows 4·warp + (lane >> 3) + 48j, so
// a load instruction covers 4 partial rows × 8 adjacent columns (whole
// 32-byte sectors); then use(f, Σ) in lanes 0-7 of warp 0, in column order.
template <class Use>
__device__ __forceinline__ void column_sums(const Params& p, float* red, int col0, int col1,
                                            int ncta, Use use) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fpad = p.fpad;
  for (int f0 = col0; f0 < col1; f0 += 8) {
    const int f = f0 + (lane & 7);
    float g = 0.f;
    if (f < col1) {
#pragma unroll 4
      for (int c = 4 * warp + (lane >> 3); c < ncta; c += 4 * kWarps)
        g += __ldcg(p.partials + (size_t)c * fpad + f);
    }
    g += __shfl_xor_sync(0xffffffffu, g, 8);
    g += __shfl_xor_sync(0xffffffffu, g, 16);
    if (lane < 8) red[warp * 8 + lane] = g;
    __syncthreads();
    if (warp == 0 && lane < 8 && f < col1) {
      float gs = red[lane];
      for (int w = 1; w < kWarps; ++w) gs += red[w * 8 + lane];
      use(f, gs);
    }
    __syncthreads();
  }
}

// MLlib's converged test on the summed ‖Δw‖² and ‖w‖²
__device__ __forceinline__ bool converged_norms(float ds, float ns, float tol) {
  return tol > 0.f && sqrtf(ds) < tol * fmaxf(sqrtf(ns), 1.f);
}

// In warp 0 after the norm partials are in: the converged decision from
// the ‖Δw‖² and ‖w‖² of the `ncta` CTAs at norm_part, summed lane-strided
// over the CTAs and then across the warp, so every lane of every CTA takes
// the same one.
__device__ __forceinline__ bool converged(const float* norm_part, int ncta, float tol,
                                          int lane) {
  float ds = 0.f, ns = 0.f;
  for (int c = lane; c < ncta; c += 32) {
    ds += __ldcg(norm_part + 2 * c);
    ns += __ldcg(norm_part + 2 * c + 1);
  }
  return converged_norms(warp_sum(ds), warp_sum(ns), tol);
}

// In warp 0: the CTA's ‖Δw‖² and ‖w‖² partials from lanes' d and n.
__device__ __forceinline__ void store_norms(const Params& p, int cta, float d, float n) {
  d = warp_sum(d);
  n = warp_sum(n);
  if ((threadIdx.x & 31) == 0) {
    p.norm_part[2 * cta] = d;
    p.norm_part[2 * cta + 1] = n;
  }
}

template <bool kLogistic>
__global__ void __launch_bounds__(kThreads, 1) fused_sgd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(p.fpad, p.rows_cap);
  float* w_s = reinterpret_cast<float*>(smem);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* y_s = reinterpret_cast<float*>(smem + lay.y);
  float* r_s = reinterpret_cast<float*>(smem + lay.r);
  float* scratch = reinterpret_cast<float*>(smem + lay.scratch);
  uint4* x_s = reinterpret_cast<uint4*>(smem + lay.x);

  cg::grid_group grid = cg::this_grid();
  const int cta = blockIdx.x, ncta = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (int)((long long)cta * p.rows / ncta);
  const int my_rows = (int)((long long)(cta + 1) * p.rows / ncta) - row0;
  const int fpad = p.fpad, nvec = p.nvec, features = p.features;
  const int cols_per_cta = (fpad + ncta - 1) / ncta;
  const int col0 = min(cta * cols_per_cta, fpad);
  const int col1 = min(col0 + cols_per_cta, fpad);

  // ---- prologue: w0, then the CTA's rows of X from device memory, once
  for (int f = threadIdx.x; f < fpad; f += kThreads)
    w_s[f] = f < features ? __ldg(p.w0 + f) : 0.f;
  for (int f = col0 + threadIdx.x; f < min(col1, features); f += kThreads)
    p.w_out[f] = __ldg(p.w0 + f);  // the result when no update runs
  const bool vec4 = features % 4 == 0 && (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
  for (int l = warp; l < my_rows; l += kWarps) stage_row(p, x_s, y_s, cta, row0, l, lane, vec4);
  if (warp == 0) {  // count = Σ mask, this CTA's share, in a fixed order
    float s = 0.f;
    for (int i = lane; i < my_rows; i += 32) s += __ldg(p.mask + row0 + i);
    s = warp_sum(s);
    if (lane == 0) p.count_part[cta] = s;
  }
  grid.sync();
  if (warp == 0) {
    float s = 0.f;
    for (int c = lane; c < ncta; c += 32) s += __ldcg(p.count_part + c);
    s = warp_sum(s);
    if (lane == 0) scratch[kCountSlot] = s;
  }
  __syncthreads();
  const float count = scratch[kCountSlot];
  const float denom = fmaxf(count, 1.f);
  const bool train = p.num_iterations > 0 && count > 0.f;  // else w0 stands
  const bool narrow = nvec <= kTileGroups;

  int it = 1;
  for (;; ++it) {
    // ---- one pass over X: r = residual(X·w, y) (preds on the first), CTA's Xᵀr
    if (narrow)
      row_pass_narrow<kLogistic>(p, w_s, y_s, x_s, red, cta, row0, my_rows, it == 1, train);
    else
      row_pass_wide<kLogistic>(p, w_s, y_s, r_s, x_s, red, cta, row0, my_rows, it == 1, train);
    if (!train) break;
    const StepScalars k = step_scalars(p, it);
    grid.sync();

    // ---- update of this CTA's columns with Xᵀr summed across the CTAs
    float d = 0.f, n = 0.f;  // in lanes 0-7 of warp 0
    column_sums(p, red, col0, col1, ncta, [&](int f, float g) {
      update_column(p, f, w_s[f], g, k, denom, d, n);
    });
    if (warp == 0) store_norms(p, cta, d, n);
    grid.sync();

    // ---- every CTA: the new w, and the same converged decision
    for (int f = threadIdx.x - 32; warp > 0 && f < fpad; f += kThreads - 32)
      w_s[f] = __ldcg(p.wbuf + f);
    if (warp == 0) {
      const bool done = converged(p.norm_part, ncta, p.tol, lane);
      if (lane == 0) scratch[kConvergedSlot] = done ? 1.f : 0.f;
    }
    __syncthreads();
    if (scratch[kConvergedSlot] != 0.f || it >= p.num_iterations) break;
  }
  if (cta == 0 && threadIdx.x == 0) *p.iterations = train ? (float)it : 0.f;
}

// ------------------------------------------------------------ data-parallel split
//
// The same loop cut at its one cross-rank point, for N processes that train
// one model (parallel/distributed.py). No collective can run inside a
// launch, so the loop leaves the kernel once an iteration, at the all-reduce
// (SUM, on the host's side) of this rank's Xᵀr and count, fpad + 1 floats in
// gbuf. Each iteration is ONE cooperative launch of dense_iteration_kernel
// over B1's grid, which at iteration `it` does, in order:
//   (a) it >= 2: B1's update of iteration it − 1 with the all-reduced Xᵀr
//       and count in gbuf, each CTA its column slice (update_column; wbuf,
//       w_out and its ‖Δw‖², ‖w‖² partials); a grid barrier; then every CTA
//       loads the new w into shared memory and takes B1's converged
//       decision. A step that converged, or whose global count is 0 (no
//       update: w0 stands, 0 iterations), returns here in every CTA, and
//       CTA 0 sets the step's flag in `state`: later launches of the step
//       return at entry, so the host never reads convergence back;
//   (b) the row pass: r = residual(X·w, y), each CTA's Xᵀr into the [grid,
//       fpad] partials (B1's row split, warp order and cta_reduce_tile). The
//       first launch of a step also stages X (stage_row's where-and-round to
//       bf16) into a device buffer laid out as B1's spill buffer with no
//       resident rows, writes preds = X·w0 and each CTA's masked count;
//   (c) a grid barrier, then each CTA sums its column slice of the partials
//       into gbuf in B1's order (column_sums), CTA 0 the count into
//       gbuf[fpad].
// After the step's last all-reduce, one launch in update-only mode does (a)
// alone. A step of N iterations is N + 1 launches and N all-reduces. The
// grid, the row split, the order of every sum and the update's f32
// arithmetic are B1's, so at world size 1 (the all-reduce an identity) the
// split gives B1's w and preds bit for bit.
// What bounds it: bytes. Each iteration streams the staged bf16 X once from
// device memory (B_local = 8192 rows x 1024 stored columns: 16.8 MB); X no
// longer stays on chip across iterations, because the loop leaves the
// kernel at every iteration. The update and the reduce move a few KB and
// cost a grid barrier each (~1.1 µs on an H100) inside the launch.

struct SplitState {
  int* state;   // [1]: the step's flag: converged, or no row anywhere
  float* gbuf;  // [fpad + 1]: this rank's Xᵀr and count, then the global ones
};

template <bool kLogistic>
__global__ void __launch_bounds__(kThreads, 1)
    dense_iteration_kernel(const Params p, const SplitState s, const int it, const int row_pass) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool first = row_pass && it == 1;
  if (!first && s.state[0] != 0) return;
  const Layout lay = layout(p.fpad, p.rows_cap);
  float* w_s = reinterpret_cast<float*>(smem);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* y_s = reinterpret_cast<float*>(smem + lay.y);
  float* r_s = reinterpret_cast<float*>(smem + lay.r);
  float* scratch = reinterpret_cast<float*>(smem + lay.scratch);
  cg::grid_group grid = cg::this_grid();
  const int cta = blockIdx.x, ncta = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (int)((long long)cta * p.rows / ncta);
  const int my_rows = (int)((long long)(cta + 1) * p.rows / ncta) - row0;
  const int fpad = p.fpad, features = p.features;
  const int cols_per_cta = (fpad + ncta - 1) / ncta;
  const int col0 = min(cta * cols_per_cta, fpad);
  const int col1 = min(col0 + cols_per_cta, fpad);
  if (first) {
    for (int f = threadIdx.x; f < fpad; f += kThreads)
      w_s[f] = f < features ? __ldg(p.w0 + f) : 0.f;
    for (int f = col0 + threadIdx.x; f < col1; f += kThreads) {
      p.wbuf[f] = f < features ? __ldg(p.w0 + f) : 0.f;
      if (f < features) p.w_out[f] = __ldg(p.w0 + f);  // the result when no update runs
    }
    if (cta == 0 && threadIdx.x == 0) {
      s.state[0] = 0;
      *p.iterations = 0.f;
    }
    const bool vec4 = features % 4 == 0 && (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
    for (int l = warp; l < my_rows; l += kWarps)
      stage_row(p, nullptr, y_s, cta, row0, l, lane, vec4);
    if (warp == 0) {  // this CTA's count, as B1 sums it
      float c = 0.f;
      for (int i = lane; i < my_rows; i += 32) c += __ldg(p.mask + row0 + i);
      c = warp_sum(c);
      if (lane == 0) p.count_part[cta] = c;
    }
    __threadfence();  // the staged rows are read back through L2 below
  } else {
    // ---- (a) the update of iteration u with the all-reduced Xᵀr and count
    const int u = row_pass ? it - 1 : it;
    const float count = __ldcg(s.gbuf + fpad);
    if (!(count > 0.f)) {  // no row on any rank: every CTA returns
      if (cta == 0 && threadIdx.x == 0) s.state[0] = 1;
      return;
    }
    if (row_pass)
      for (int l = threadIdx.x; l < my_rows; l += kThreads)
        y_s[l] = __ldg(p.mask + row0 + l) > 0.f ? __ldg(p.labels + row0 + l) : 0.f;
    if (warp == 0) {  // lanes 0-7 take 8 adjacent columns, as B1's update does
      const StepScalars k = step_scalars(p, u);
      const float denom = fmaxf(count, 1.f);
      float d = 0.f, n = 0.f;
      for (int f0 = col0; f0 < col1; f0 += 8) {
        const int f = f0 + (lane & 7);
        if (lane < 8 && f < col1)
          update_column(p, f, __ldcg(p.wbuf + f), __ldcg(s.gbuf + f), k, denom, d, n);
      }
      store_norms(p, cta, d, n);
    }
    grid.sync();
    if (row_pass)
      for (int f = threadIdx.x - 32; warp > 0 && f < fpad; f += kThreads - 32)
        w_s[f] = __ldcg(p.wbuf + f);
    if (warp == 0) {
      const bool done = converged(p.norm_part, ncta, p.tol, lane);
      if (lane == 0) scratch[kConvergedSlot] = done ? 1.f : 0.f;
    }
    __syncthreads();
    const bool stop = scratch[kConvergedSlot] != 0.f;
    if (cta == 0 && threadIdx.x == 0) {
      *p.iterations = (float)u;
      if (stop) s.state[0] = 1;
    }
    if (stop || !row_pass) return;
  }
  __syncthreads();

  // ---- (b) one pass over this rank's rows: each CTA's Xᵀr into the partials
  if (p.nvec <= kTileGroups)
    row_pass_narrow<kLogistic>(p, w_s, y_s, nullptr, red, cta, row0, my_rows, first, true);
  else
    row_pass_wide<kLogistic>(p, w_s, y_s, r_s, nullptr, red, cta, row0, my_rows, first, true);
  grid.sync();

  // ---- (c) this CTA's columns of Xᵀr in B1's order, CTA 0 the count
  column_sums(p, red, col0, col1, ncta, [&](int f, float g) { s.gbuf[f] = g; });
  if (cta == 0 && warp == 0) {
    float c = 0.f;
    for (int i = lane; i < ncta; i += 32) c += __ldcg(p.count_part + i);
    c = warp_sum(c);
    if (lane == 0) s.gbuf[fpad] = c;
  }
}

// ------------------------------------------------------------ tenant grid (B10)
//
// M tenants' loops in one cooperative launch: the JAX package's
// jax.vmap of the train step over a tenant stack (twtml_tpu/parallel/
// tenants.py, mapping="vmap"), where the scan form launches B1 once a
// tenant over its whole padded part. The grid is laid over the tenants by
// the host (ops/fused_sgd.py tenant_launch_plan): tenant t owns CTAs
// [first_cta[t], first_cta[t+1]), in proportion to its valid rows, none for
// a dry tenant, at most one CTA an SM in all. Tenant t's rows [0, valid[t])
// (its rows up to its last with mask > 0, which the host knows before the
// copy) are split over its CTAs as B1 splits a batch; rows past valid[t]
// are never read as X, and their preds are written 0, B1's value for a
// masked row. CTA j of tenant m's k runs B1's code on rows m·B + ... of
// the M·B rows, with its own index in the grid for its partials, count,
// norms and spilled rows, and tenant m's w, step size and L2 in the update.
//
// What bounds it: as B1, operations once the valid rows are on chip (the M
// tenants' work is one B1 call's on their valid rows together; padding
// rows cost nothing): 0.0491 ms at 4 x 4096 valid rows of 1004 columns, 50
// iterations (3.29 GFLOP f32). Each CTA stages, stores (B1's layout: its
// first `resident` bf16 rows in shared memory, the rest spilled to L2) and
// passes over its rows with B1's own code (stage_row, narrow_rows or
// row_pass_wide, cta_reduce_tile). What the timing probe found on top of
// B1's iteration at M = 4 on an H100, and what this design does about it:
//   - The reduce in rounds. A tenant's k CTAs each sum a slice of
//     ceil(fpad / k) columns over the tenant's k partials; column_sums
//     takes 8 columns a round (4 rounds at k = 33, each two __syncthreads
//     and a serial sum of 12 warps). Here one round: thread t takes column
//     t % cols of the slice and stripe t / cols of the k partial rows
//     (each stripe summed in ascending row order, its loads issued
//     together), the stripes meet in shared memory and are added in stripe
//     order, then the update. A slice of at most 8 columns (k >= 126:
//     one tenant on the whole card) keeps column_sums' one round.
//   - The decisions in turn. Every CTA took the M tenants' converged
//     decisions one after another, an L2 round trip each. Here, up to
//     kDirectTenants tenants, warp u takes tenant u's decision from L2
//     (converged()) while the other warps reload the tenant's new w: one
//     round of loads. More tenants: the CTA loads the whole norm table (2
//     floats a CTA of the grid) into shared memory with w, and warp u sums
//     tenants u, u + 12, ... from it in converged()'s order. Each deciding
//     warp sets its tenant's bit of the finished mask. The tenants' counts
//     after the prologue come from a table likewise.
// Every CTA crosses the same two grid barriers an iteration: a tenant that
// has converged (or never trains: count 0, or N = 0) skips its row pass
// and update but keeps crossing them, and all CTAs take the same decisions
// from the same partials in the same order, so they hold the same mask and
// leave the loop together, once all have finished or at N. No float
// atomics (the finished mask is an integer OR); every sum has a fixed
// order, so reruns are bitwise equal.
// Left out: the text columns' counts in 8 bits, so that every row stays
// resident (a count c in [0, 255] is exact in a byte; a row's 1000 text
// columns take 1,000 B, not 2,000). Unpacking a byte (prmt into the low
// byte of 2^23, then a subtraction) costs two instructions a column where
// bf16 costs one, and on an H100 the row pass took longer with 8-bit rows
// than with the 22 of 125 rows a CTA that B1's layout spills to L2: every
// row in 8 bits, or 80 rows in bf16 and 45 in 8 bits, both timed slower
// than this design. Tensor cores (each tenant's two products are matrix x
// vector, N = 1 where wgmma takes N >= 8, and bf16 operands would round w
// and r, which the f32 twin does not); a barrier of each tenant's own (a
// flag barrier measured 2.3x slower than grid.sync() in B7); clusters and
// distributed shared memory (a tenant spans 33 CTAs at M = 4, more than a
// cluster holds).
// The timing instantiation (kProbe) stamps %globaltimer and clock64 at
// each phase edge in CTA 0 and each tenant's last CTA (probe_stamp); no
// launch the port makes for training uses it.

struct TenantTable {
  int tenants;     // M of this launch, at most kMaxTenants
  int batch_rows;  // B: rows a tenant's part has (its padded rows included)
  int first_cta[kMaxTenants + 1];
  int valid[kMaxTenants];
  float step_size[kMaxTenants], l2_reg[kMaxTenants];
  // the timing probe (kProbe instantiations): [1 + tenants, probe_edges]
  // pairs of (%globaltimer, clock64), or null
  unsigned long long* probe;
  int probe_edges;
};

// Phase edges the probe stamps: the prologue's, then kIterEdges an iteration
constexpr int kPrologueEdges = 4;  // entry, rows staged, barrier 0, counts taken
constexpr int kIterEdges = 6;      // row pass, CTA reduce, barrier 1, update, barrier 2, decisions
static_assert(kPrologueEdges == TWTML_SGD_PROBE_PROLOGUE_EDGES,
              "PROBE_PROLOGUE_EDGES differs from ops/fused_sgd.py");
static_assert(kIterEdges == TWTML_SGD_PROBE_ITERATION_EDGES,
              "PROBE_ITERATION_EDGES differs from ops/fused_sgd.py");
// the split with a tenant grid's, a launch: entry, update, barrier 1,
// decisions and reloads, row pass, barrier 2, reduce
constexpr int kSplitEdges = 7;
static_assert(kSplitEdges == TWTML_SGD_PROBE_SPLIT_EDGES,
              "PROBE_SPLIT_EDGES differs from ops/fused_sgd.py");

// kProbe only: after every thread of the CTA has reached it, thread 0 of a
// stamping CTA (slot >= 0: CTA 0 is slot 0, tenant m's last CTA slot 1 + m)
// writes the time at phase edge `edge`.
template <bool kProbe>
__device__ __forceinline__ void probe_stamp(const TenantTable& t, int slot, int edge) {
  if constexpr (kProbe) {
    __syncthreads();
    if (threadIdx.x == 0 && slot >= 0 && edge < t.probe_edges) {
      unsigned long long g;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
      unsigned long long* at = t.probe + ((size_t)slot * t.probe_edges + edge) * 2;
      at[0] = g;
      at[1] = (unsigned long long)clock64();
    }
  }
}

constexpr int kStripeLoads = 4;  // a stripe's partial rows loaded at once
constexpr int kDirectTenants = kWarps / 2;  // decisions straight from L2, a warp each

// Σ src[r·stride] over rows r = first, first + step, ... < end, added in
// ascending order, kStripeLoads loads issued before their adds. (A loop of
// a runtime step and few trips leaves each load waiting for the add before
// it: one L2 round trip a row.)
__device__ __forceinline__ float strided_sum(const float* src, size_t stride, int first,
                                             int step, int end) {
  float g = 0.f;
  for (int r0 = first; r0 < end; r0 += kStripeLoads * step) {
    float v[kStripeLoads];
#pragma unroll
    for (int i = 0; i < kStripeLoads; ++i) {
      const int r = r0 + i * step;
      v[i] = r < end ? __ldcg(src + (size_t)r * stride) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kStripeLoads; ++i)
      if (r0 + i * step < end) g += v[i];
  }
  return g;
}

// Tenant m's Xᵀr over this CTA's columns [col0, col1) from its k CTA
// partials, in one round: thread i < stripes·cols takes column col0 + i %
// cols and stripe i / cols, rows [s·len, (s+1)·len) of the k partial rows
// summed in ascending order (adjacent threads on adjacent columns); the
// stripes meet in `red` and are added in stripe order. With one stripe
// (a slice wider than half the CTA, or k = 1) a thread sums its columns'
// k rows alone, cols apart. Then use(f, Σ) in the thread that holds it.
// Every thread must call it: it crosses one __syncthreads.
template <class Use>
__device__ __forceinline__ void tenant_column_sums(const float* partials, int fpad, float* red,
                                                   int col0, int col1, int k, Use use) {
  const int cols = col1 - col0;
  const int most = cols > 0 ? min(k, kThreads / cols) : 1;
  const int len = (k + max(most, 1) - 1) / max(most, 1);
  const int stripes = most > 1 ? (k + len - 1) / len : 1;
  if (stripes == 1) {
    for (int c = threadIdx.x; c < cols; c += kThreads) {
      float g = 0.f;
#pragma unroll 4
      for (int r = 0; r < k; ++r) g += __ldcg(partials + (size_t)r * fpad + col0 + c);
      use(col0 + c, g);
    }
    __syncthreads();
    return;
  }
  const int i = threadIdx.x;
  if (i < stripes * cols) {
    const int c = i % cols, s = i / cols;
    const int n = min(k, (s + 1) * len) - s * len;  // this stripe's rows
    const float* src = partials + (size_t)s * len * fpad + col0 + c;
    float g = 0.f;
    if (n <= kStripeLoads) {  // every load issued before the first add
      float v[kStripeLoads];
#pragma unroll
      for (int r = 0; r < kStripeLoads; ++r) v[r] = r < n ? __ldcg(src + (size_t)r * fpad) : 0.f;
#pragma unroll
      for (int r = 0; r < kStripeLoads; ++r)
        if (r < n) g += v[r];
    } else {
      for (int r = 0; r < n; ++r) g += __ldcg(src + (size_t)r * fpad);
    }
    red[i] = g;
  }
  __syncthreads();
  if (i < cols) {
    float g = red[i];
    for (int s = 1; s < stripes; ++s) g += red[s * cols + i];
    use(col0 + i, g);
  }
}

// The CTA's ‖Δw‖² and ‖w‖² partials from every thread's d and n: each
// warp's sum, then thread 0 adds the kWarps sums in warp order (`red2`,
// two floats a warp); with `warp0` (a slice of at most 32 columns: only
// warp 0 updated any) warp 0's sum alone. Every thread must call it: it
// crosses one __syncthreads unless warp0.
__device__ __forceinline__ void tenant_store_norms(const Params& p, float* red2, int cta, float d,
                                                   float n, bool warp0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp0) {
    if (warp == 0) store_norms(p, cta, d, n);
    return;
  }
  d = warp_sum(d);
  n = warp_sum(n);
  if (lane == 0) {
    red2[2 * warp] = d;
    red2[2 * warp + 1] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ds = red2[0], ns = red2[1];
    for (int w = 1; w < kWarps; ++w) {
      ds += red2[2 * w];
      ns += red2[2 * w + 1];
    }
    p.norm_part[2 * cta] = ds;
    p.norm_part[2 * cta + 1] = ns;
  }
}

// converged() on a norm table in shared memory: the same sums in the same
// order.
__device__ __forceinline__ bool tenant_converged(const float* norms, int ncta, float tol,
                                                 int lane) {
  float ds = 0.f, ns = 0.f;
  for (int c = lane; c < ncta; c += 32) {
    ds += norms[2 * c];
    ns += norms[2 * c + 1];
  }
  return converged_norms(warp_sum(ds), warp_sum(ns), tol);
}

template <bool kLogistic, bool kProbe>
__global__ void __launch_bounds__(kThreads, 1)
    tenant_sgd_kernel(const Params p, const TenantTable t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(p.fpad, p.rows_cap);
  float* w_s = reinterpret_cast<float*>(smem);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* y_s = reinterpret_cast<float*>(smem + lay.y);
  float* r_s = reinterpret_cast<float*>(smem + lay.r);
  float* scratch = reinterpret_cast<float*>(smem + lay.scratch);
  unsigned* finished_s = reinterpret_cast<unsigned*>(scratch + kConvergedSlot);
  uint4* x_s = reinterpret_cast<uint4*>(smem + lay.x);

  cg::grid_group grid = cg::this_grid();
  const int cta = blockIdx.x, ncta = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fpad = p.fpad, features = p.features, rows = t.batch_rows;
  int m = 0;  // this CTA's tenant: first_cta[m] <= cta < first_cta[m + 1]
  while (cta >= t.first_cta[m + 1]) ++m;
  const int c0 = t.first_cta[m], k = t.first_cta[m + 1] - c0, j = cta - c0;
  const int valid = t.valid[m];
  // row0 indexes the [tenants·rows] rows of X, labels, mask and preds: B1's
  // code reads tenant m's part as rows m·B.. of one batch, and the CTA's
  // partials, count, norms and spilled rows by its index in the grid
  const int row0 = m * rows + (int)((long long)j * valid / k);
  const int my_rows = m * rows + (int)((long long)(j + 1) * valid / k) - row0;
  const int cols_per_cta = (fpad + k - 1) / k;
  const int col0 = min(j * cols_per_cta, fpad);
  const int col1 = min(col0 + cols_per_cta, fpad);
  const bool narrow = p.nvec <= kTileGroups;
  float* wbuf = p.wbuf + (size_t)m * fpad;  // tenant m's w after each update
  const int slot = cta == 0 ? 0 : j == k - 1 ? 1 + m : -1;  // the probe's
  probe_stamp<kProbe>(t, slot, 0);

  // ---- prologue: w0, then the CTA's valid rows of X from device memory, once
  const float* w0 = p.w0 + (size_t)m * features;
  for (int f = threadIdx.x; f < fpad; f += kThreads) w_s[f] = f < features ? __ldg(w0 + f) : 0.f;
  for (int f = col0 + threadIdx.x; f < min(col1, features); f += kThreads)
    p.w_out[(size_t)m * features + f] = __ldg(w0 + f);  // the result when no update runs
  const bool vec4 = features % 4 == 0 && (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
  for (int l = warp; l < my_rows; l += kWarps) stage_row(p, x_s, y_s, cta, row0, l, lane, vec4);
  if (warp == 0) {  // this CTA's share of its tenant's count, in a fixed order
    float s = 0.f;
    for (int i = lane; i < my_rows; i += 32) s += __ldg(p.mask + row0 + i);
    s = warp_sum(s);
    if (lane == 0) p.count_part[cta] = s;
  }
  if (threadIdx.x == 0) *finished_s = 0u;
  // what no CTA's row pass writes: the preds of rows past each tenant's
  // valid ones, and a dry tenant's w_out (w0) and iterations (0)
  const long long gthreads = (long long)gridDim.x * kThreads;
  const long long gtid = (long long)cta * kThreads + threadIdx.x;
  for (long long i = gtid; i < (long long)t.tenants * rows; i += gthreads)
    if ((int)(i % rows) >= t.valid[i / rows]) p.preds[i] = 0.f;
  for (long long i = gtid; i < (long long)t.tenants * features; i += gthreads)
    if (t.valid[i / features] == 0) p.w_out[i] = __ldg(p.w0 + i);
  if (gtid < t.tenants && t.valid[gtid] == 0) p.iterations[gtid] = 0.f;
  probe_stamp<kProbe>(t, slot, 1);
  grid.sync();
  probe_stamp<kProbe>(t, slot, 2);

  // ---- every CTA: each tenant's count, and which tenants train no
  // iteration, from the count table in shared memory (warp u: tenant u)
  float* table = red;  // the counts [ncta], later the norms [2, ncta]
  for (int i = threadIdx.x; i < ncta; i += kThreads) table[i] = __ldcg(p.count_part + i);
  __syncthreads();
  for (int u = warp; u < t.tenants; u += kWarps) {
    const int a = t.first_cta[u], n = t.first_cta[u + 1] - a;
    float s = 0.f;
    for (int c = lane; c < n; c += 32) s += table[a + c];
    s = warp_sum(s);
    if (lane == 0) {
      if (u == m) scratch[kCountSlot] = s;
      if (!(p.num_iterations > 0 && s > 0.f)) atomicOr(finished_s, 1u << u);
    }
  }
  __syncthreads();
  const float denom = fmaxf(scratch[kCountSlot], 1.f);
  const unsigned idle = *finished_s;
  const unsigned all = t.tenants == 32 ? ~0u : (1u << t.tenants) - 1u;
  unsigned finished = idle;
  probe_stamp<kProbe>(t, slot, 3);

  for (int it = 1;; ++it) {
    const bool training = !((finished >> m) & 1u);  // the same in every CTA of tenant m
    const int e0 = kPrologueEdges + kIterEdges * (it - 1);
    // ---- one pass over the CTA's rows (preds on the first), the CTA's Xᵀr
    if (it == 1 || training) {
      if (narrow) {
        float acc[kVpl][8];
        narrow_rows<kLogistic>(p, w_s, y_s, x_s, cta, row0, my_rows, it == 1, training, acc);
        probe_stamp<kProbe>(t, slot, e0);
        if (training) cta_reduce_tile(acc, red, p.partials + (size_t)cta * fpad, 0, fpad);
      } else {
        row_pass_wide<kLogistic>(p, w_s, y_s, r_s, x_s, red, cta, row0, my_rows, it == 1,
                                 training);
        probe_stamp<kProbe>(t, slot, e0);
      }
    } else {
      probe_stamp<kProbe>(t, slot, e0);
    }
    probe_stamp<kProbe>(t, slot, e0 + 1);
    if (finished == all) break;  // no tenant trains at all
    Params tenant = p;  // tenant m's step size and L2, for η and 1 − η·λ before the barrier
    tenant.step_size = t.step_size[m];
    tenant.l2_reg = t.l2_reg[m];
    const StepScalars ks = step_scalars(tenant, it);
    grid.sync();
    probe_stamp<kProbe>(t, slot, e0 + 2);

    // ---- tenant m's update of this CTA's columns with Xᵀr summed over its
    // CTAs in one round, then the CTA's ‖Δw‖², ‖w‖²
    if (training) {
      Params u = p;  // tenant m's partials and w
      u.partials += (size_t)c0 * fpad;
      u.w_out += (size_t)m * features;
      u.wbuf = wbuf;
      float d = 0.f, n = 0.f;
      auto use = [&](int f, float g) { update_column(u, f, w_s[f], g, ks, denom, d, n); };
      if (col1 - col0 <= 8)  // B1's reduce takes 8 columns in one round
        column_sums(u, red, col0, col1, k, use);
      else
        tenant_column_sums(u.partials, fpad, red, col0, col1, k, use);
      tenant_store_norms(p, red + kThreads, cta, d, n, col1 - col0 <= 32);
    }
    probe_stamp<kProbe>(t, slot, e0 + 3);
    grid.sync();
    probe_stamp<kProbe>(t, slot, e0 + 4);

    // ---- every CTA: its tenant's new w and every training tenant's
    // decision in one round of loads: up to kDirectTenants tenants, warp u
    // takes tenant u's from L2 (converged()) while the other warps reload
    // w; more, the whole norm table into shared memory with w, then warp u
    // takes tenants u, u + kWarps, ...
    if (t.tenants <= kDirectTenants) {
      const int deciders = 32 * t.tenants;
      if (warp < t.tenants) {
        const int a = t.first_cta[warp];
        if (!((finished >> warp) & 1u) &&
            converged(p.norm_part + 2 * a, t.first_cta[warp + 1] - a, p.tol, lane) && lane == 0)
          atomicOr(finished_s, 1u << warp);
      } else if (training) {
        for (int f = threadIdx.x - deciders; f < fpad; f += kThreads - deciders)
          w_s[f] = __ldcg(wbuf + f);
      }
    } else {
      for (int i = threadIdx.x; i < 2 * ncta; i += kThreads) table[i] = __ldcg(p.norm_part + i);
      if (training)
        for (int f = threadIdx.x; f < fpad; f += kThreads) w_s[f] = __ldcg(wbuf + f);
      __syncthreads();
      for (int u = warp; u < t.tenants; u += kWarps) {
        if ((finished >> u) & 1u) continue;
        const int a = t.first_cta[u];
        if (tenant_converged(table + 2 * a, t.first_cta[u + 1] - a, p.tol, lane) && lane == 0)
          atomicOr(finished_s, 1u << u);
      }
    }
    __syncthreads();
    finished = *finished_s;
    probe_stamp<kProbe>(t, slot, e0 + 5);
    if (training && j == 0 && threadIdx.x == 0 &&
        (((finished >> m) & 1u) || it >= p.num_iterations))
      p.iterations[m] = (float)it;
    if (finished == all || it >= p.num_iterations) break;
  }
  if (((idle >> m) & 1u) && j == 0 && threadIdx.x == 0) p.iterations[m] = 0.f;
}

// ------------------------------------------------------------ tenant split (B10 b)
//
// The vmap form of a tenant stack over a data axis: the JAX package runs
// jax.vmap of the data-parallel step inside shard_map, so the M tenants'
// psums over the data axis become one collective. Here M tenants' splits
// run as one: each iteration is ONE cooperative launch of
// tenant_iteration_kernel on this rank's rows of every tenant, and between
// launches ONE all-reduce (SUM, on the host's side) of gbuf, [tenants, fpad
// + 1] floats: each tenant's Xᵀr, then its count. At iteration `it` the
// launch does, in order:
//   (a) it >= 2: the update of iteration it − 1 of EVERY tenant still
//       training, from the all-reduced gbuf, each with its own step size and
//       L2 (update_column), over column slices shared grid-wide: CTA c takes
//       slices c, c + grid, ... of every tenant, and the (tenant, column)
//       pairs of a slice spread over update_lanes() lanes a tenant
//       (tenant_split_update: the count, w and Xᵀr loaded together, η and
//       1 − η·λ computed while they are in flight), each tenant's ‖Δw‖²,
//       ‖w‖² of the slice summed by its lanes' shuffles in an order set by M
//       and the slice alone. Meanwhile the warps the update leaves free load
//       the CTA's tenant's labels. A grid barrier; then every CTA takes
//       every training tenant's converged decision while its other warps
//       reload the CTA's tenant's new w (one round of loads; up to
//       kDirectTenants warp u decides tenant u from L2, more from a table of
//       lane sums in shared memory, both in converged()'s order). A tenant
//       whose global count is 0 makes no update and ends there, as the
//       split's step does. The finished tenants are one bit each in `state`;
//   (b) the row pass of each CTA's tenant, if it still trains: the tenant
//       grid's CTAs and rows (tenant t's CTAs [first_cta[t], first_cta[t+1])
//       split its rows [0, valid[t]) on this rank as B1 splits a batch), the
//       split's row pass over rows staged in a device buffer. The first
//       launch stages X (stage_row), writes the predictions (0 past a
//       tenant's valid rows) and each CTA's masked count;
//   (c) a grid barrier, then every training tenant's Xᵀr over its CTAs into
//       its row of gbuf, all tenants in one round (tenant_split_reduce:
//       column_sums with its 12 warps shared among the tenants; above 12
//       tenants a thread a (tenant, column) pair), and each tenant's count:
//       summed from the CTAs' counts by the first launch, which keeps it in
//       `counts`, and copied from there by every later one.
// After the last all-reduce one launch in update-only mode does (a) alone:
// N + 1 launches and N all-reduces a step, whatever M. The host builds the
// launch's parameters once a step (twtml_tenant_split_prepare) and each
// launch passes only the handle, `it`, `row_pass` and the stream.
// The trap of a tenant grid here: a tenant may have no row on this rank
// (no CTA in the plan) and rows on another. Every rank holds the whole
// replicated stack, so every rank must update that tenant all the same:
// the update's slices are every tenant's columns, whoever owns the rows,
// and a tenant with no CTA adds zeros to the all-reduce. The slices are
// B1's grid at the parts' padded rows (ops/fused_sgd.py tenant_split_plan),
// the same on every rank whatever its valid rows, so every rank sums each
// tenant's ‖Δw‖² and ‖w‖² in one order: the ranks hold the same finished
// bits and weights, and once every tenant has finished a launch returns at
// entry, with no host read of convergence.
// At one tenant whose rows are all valid the grid, rows a CTA, slices and
// every order of summation are the split's (dense_iteration_kernel: B1's
// lanes 0-7 in the update, converged()'s order, column_sums' in the reduce),
// so it gives the split's w and preds bit for bit.
// What bounds it: bytes, as the split. An iteration streams this rank's
// staged bf16 rows once (at 4 tenants x 2,048 valid rows of 8,192 padded,
// F = 1,004: 8,192 rows x 1,024 stored columns, 16.8 MB); the update and
// the reduce move M x (fpad + 1) floats and a few KB of partials. What the
// timing probe (kProbe: CTA 0 and each tenant's last CTA stamp 7 edges a
// launch) found in the first design at 4 x 2,048 on an H100, against one
// tenant of all the rows: the reloads of w and the labels after the
// decisions (2.3 µs for the decisions and reloads at either M) and the
// reduce in one column_sums round a tenant (2.3 µs at M = 4, 0.9 at one).
// This design overlaps the reloads with the decisions and barrier 1 and
// reduces every tenant in one round: the decisions and reloads take
// 0.9-1.1 µs, the reduce 0.9 at M = 4 (0.7 at one tenant); the labels'
// two dependent loads now sit beside (a), which takes 1.0 µs. What is left
// on top of the row pass (4.4-4.6 µs, the split's) is the launch itself
// (its event time less the stamped span: ~3 µs), two grid barriers and an
// L2 round trip or two in each of (a), the decisions and (c). Issuing
// (a)'s loads and the labels' at entry, beside the state's, measured
// slower on the H100 than issuing them after it.
// Left out: keeping rows on chip across launches (a persistent launch that
// waits on a flag the host's all-reduce sets: bound up with C6 and B11
// (a)/(d) in ROADMAP); text counts in 8 bits (measured slower in the
// tenant grid: a byte takes two instructions to unpack); tensor cores
// (each product is matrix x vector, N = 1, and bf16 operands would round w
// and r, which the f32 twin does not).

struct TenantSplitState {
  int* state;     // [1]: the finished tenants, one bit each
  float* gbuf;    // [tenants, fpad + 1]: this rank's Xᵀr and count, then the global ones
  float* counts;  // [tenants]: each tenant's count on this rank, from the first launch
  int slices;     // column slices of the update and the reduce, alike on every rank
};

// The lanes that take one tenant's columns of a slice in the update: at one
// tenant B1's 8 (lanes 0-7 of warp 0, 8 columns apart); more, a power of
// two up to 32 and the slice's columns, with every tenant's lanes in one
// pass of the CTA. It depends on M and the slice's width alone, so every
// rank sums each tenant's ‖Δw‖² and ‖w‖² of a slice in one order.
__host__ __device__ inline int update_lanes(int tenants, int cols) {
  if (tenants == 1) return 8;
  int g = 1;
  while (g < 32 && g < cols && tenants * g * 2 <= kThreads) g *= 2;
  return g;
}

// (a) of slice q: every tenant that still trains (not in `prev`, global
// count > 0) updated over columns [q0, q1) with its own step size and L2
// from the all-reduced gbuf, its ‖Δw‖², ‖w‖² of the slice into its row of
// the norm table. Thread u·G + l takes tenant u's columns q0 + l, q0 + l +
// G, ... (G = update_lanes), then each tenant's G lanes sum their terms by
// shuffles. At one tenant that is warp_sum's order over lanes 0-7: the
// lanes past them hold +0 (sums of squares start at +0), so warp_sum's
// offsets 16 and 8 add nothing to lanes 0-7.
__device__ __forceinline__ void tenant_split_update(const Params& p, const TenantTable& t,
                                                    const TenantSplitState& s, unsigned prev,
                                                    int uit, int q, int q0, int q1, int lanes) {
  const int tenants = t.tenants, fpad = p.fpad;
  if (threadIdx.x >= ((tenants * lanes + 31) & ~31)) return;  // whole warps past the pairs
  const int u = threadIdx.x / lanes, l = threadIdx.x % lanes;
  float d = 0.f, n = 0.f;
  bool active = false;
  if (u < tenants && !((prev >> u) & 1u)) {
    Params tp = p;  // tenant u's w, step size and L2
    tp.wbuf = p.wbuf + (size_t)u * fpad;
    tp.w_out = p.w_out + (size_t)u * p.features;
    tp.step_size = t.step_size[u];
    tp.l2_reg = t.l2_reg[u];
    const float* g = s.gbuf + u * ((size_t)fpad + 1);
    // the count with the first column's w and Xᵀr, one round trip; η and
    // 1 − η·λ while it is in flight
    const float count = __ldcg(g + fpad);
    float wo = 0.f, go = 0.f;
    if (q0 + l < q1) {
      wo = __ldcg(tp.wbuf + q0 + l);
      go = __ldcg(g + q0 + l);
    }
    const StepScalars ks = step_scalars(tp, uit);
    if (count > 0.f) {
      active = true;
      const float denom = fmaxf(count, 1.f);
      for (int f = q0 + l; f < q1; f += lanes) {
        update_column(tp, f, wo, go, ks, denom, d, n);
        if (f + lanes < q1) {
          wo = __ldcg(tp.wbuf + f + lanes);
          go = __ldcg(g + f + lanes);
        }
      }
    }
  }
  for (int o = lanes >> 1; o > 0; o >>= 1) {
    d += __shfl_xor_sync(0xffffffffu, d, o);
    n += __shfl_xor_sync(0xffffffffu, n, o);
  }
  if (active && l == 0) {
    p.norm_part[2 * ((size_t)u * s.slices + q)] = d;
    p.norm_part[2 * ((size_t)u * s.slices + q) + 1] = n;
  }
}

// (c) of slice [q0, q1): every training tenant's Xᵀr over its CTA partials
// into gbuf, all tenants in one round. Up to kWarps tenants: column_sums
// with its warps shared among the tenants. Tenant u takes warps [u·W,
// (u+1)·W), W = kWarps / M; lane & 7 takes column f0 + (lane & 7) and
// warp u·W + w reads the tenant's partial rows 4w + (lane >> 3), + 4W, ...
// in ascending order (a load instruction covers 4 rows x 8 adjacent
// columns); the warp's 4 row groups meet by shuffles, then thread 8u + l
// adds the tenant's W warps in order. 8 columns a round, two
// __syncthreads a round; at M = 1 it is column_sums' layout and order (W =
// kWarps), so one tenant sums as the split does. More tenants: each thread
// takes whole (tenant, column) pairs and sums the tenant's k_u rows in
// order. A tenant with no CTA on this rank writes zeros. Every thread must
// call it.
__device__ __forceinline__ void tenant_split_reduce(const Params& p, const TenantTable& t,
                                                    const TenantSplitState& s, float* red,
                                                    unsigned finished, int q0, int q1) {
  const int tenants = t.tenants, fpad = p.fpad;
  const size_t gstride = (size_t)fpad + 1;
  if (tenants > kWarps) {
    const int cols = q1 - q0;
    for (int i = threadIdx.x; i < tenants * cols; i += kThreads) {
      const int u = i / cols, c = i % cols;
      if ((finished >> u) & 1u) continue;
      s.gbuf[u * gstride + q0 + c] =
          strided_sum(p.partials + (size_t)t.first_cta[u] * fpad + q0 + c, (size_t)fpad, 0, 1,
                      t.first_cta[u + 1] - t.first_cta[u]);
    }
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = kWarps / tenants, u = warp / per, w = warp - u * per;
  const bool reads = u < tenants && !((finished >> u) & 1u);
  const int a = reads ? t.first_cta[u] : 0, k = reads ? t.first_cta[u + 1] - a : 0;
  for (int f0 = q0; f0 < q1; f0 += 8) {
    const int f = f0 + (lane & 7);
    float g = 0.f;
    if (f < q1)
      g = strided_sum(p.partials + (size_t)a * fpad + f, (size_t)fpad, 4 * w + (lane >> 3),
                      4 * per, k);
    g += __shfl_xor_sync(0xffffffffu, g, 8);
    g += __shfl_xor_sync(0xffffffffu, g, 16);
    if (lane < 8) red[warp * 8 + lane] = g;
    __syncthreads();
    const int v = threadIdx.x >> 3, l = threadIdx.x & 7;
    if (v < tenants && !((finished >> v) & 1u) && f0 + l < q1) {
      const float* part = red + v * per * 8 + l;
      float gs = part[0];
#pragma unroll
      for (int x = 1; x < kWarps; ++x)  // unrolled: the loads issued together
        if (x < per) gs += part[8 * x];
      s.gbuf[v * gstride + f0 + l] = gs;
    }
    __syncthreads();
  }
}

// Lane `lane`'s share of a norm table of n (‖Δw‖², ‖w‖²) pairs, in
// converged()'s order, every load of a table of up to 256 pairs issued
// before the first add.
__device__ __forceinline__ void norm_lane_sums(const float* norms, int n, int lane, float& ds,
                                               float& ns) {
  constexpr int kLoads = 8;
  ds = 0.f;
  ns = 0.f;
  for (int c0 = lane; c0 < n; c0 += 32 * kLoads) {
    float d[kLoads], m[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = c0 + 32 * i;
      d[i] = c < n ? __ldcg(norms + 2 * c) : 0.f;
      m[i] = c < n ? __ldcg(norms + 2 * c + 1) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i)
      if (c0 + 32 * i < n) {
        ds += d[i];
        ns += m[i];
      }
  }
}

template <bool kLogistic, bool kProbe>
__global__ void __launch_bounds__(kThreads, 1)
    tenant_iteration_kernel(const Params p, const TenantTable t, const TenantSplitState s,
                            const int it, const int row_pass) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool first = row_pass && it == 1;
  const int tenants = t.tenants;
  const unsigned all = tenants == 32 ? ~0u : (1u << tenants) - 1u;
  const unsigned prev = first ? 0u : (unsigned)__ldcg(s.state);
  if (prev == all) return;  // every tenant finished in an earlier launch
  const Layout lay = layout(p.fpad, p.rows_cap);
  float* w_s = reinterpret_cast<float*>(smem);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* y_s = reinterpret_cast<float*>(smem + lay.y);
  float* r_s = reinterpret_cast<float*>(smem + lay.r);
  float* scratch = reinterpret_cast<float*>(smem + lay.scratch);
  unsigned* finished_s = reinterpret_cast<unsigned*>(scratch + kConvergedSlot);
  cg::grid_group grid = cg::this_grid();
  const int cta = blockIdx.x, ncta = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fpad = p.fpad, features = p.features, rows = t.batch_rows;
  int m = 0;  // this CTA's tenant: first_cta[m] <= cta < first_cta[m + 1]
  while (cta >= t.first_cta[m + 1]) ++m;
  const int k = t.first_cta[m + 1] - t.first_cta[m], j = cta - t.first_cta[m];
  const int valid = t.valid[m];
  const int row0 = m * rows + (int)((long long)j * valid / k);
  const int my_rows = m * rows + (int)((long long)(j + 1) * valid / k) - row0;
  const int cols = (fpad + s.slices - 1) / s.slices;  // a slice's columns
  const size_t gstride = (size_t)fpad + 1;
  const float* wbuf = p.wbuf + (size_t)m * fpad;  // tenant m's w after each update
  const int slot = cta == 0 ? 0 : j == k - 1 ? 1 + m : -1;  // the probe's
  probe_stamp<kProbe>(t, slot, 0);
  unsigned finished = prev;
  if (first) {
    const float* w0 = p.w0 + (size_t)m * features;
    for (int f = threadIdx.x; f < fpad; f += kThreads)
      w_s[f] = f < features ? __ldg(w0 + f) : 0.f;
    // every tenant's w where no update runs, this CTA's slices
    for (int q = cta; q < s.slices; q += ncta) {
      const int q0 = min(q * cols, fpad), n = min(q0 + cols, fpad) - q0;
      for (int i = threadIdx.x; i < tenants * n; i += kThreads) {
        const int u = i / n, f = q0 + i % n;
        const float v = f < features ? __ldg(p.w0 + (size_t)u * features + f) : 0.f;
        p.wbuf[(size_t)u * fpad + f] = v;
        if (f < features) p.w_out[(size_t)u * features + f] = v;
      }
    }
    if (cta == 0 && threadIdx.x < tenants) p.iterations[threadIdx.x] = 0.f;
    if (cta == 0 && threadIdx.x == 0) *s.state = 0;
    const bool vec4 = features % 4 == 0 && (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
    for (int l = warp; l < my_rows; l += kWarps)
      stage_row(p, nullptr, y_s, cta, row0, l, lane, vec4);
    if (warp == 0) {  // this CTA's share of its tenant's count, as B1 sums it
      float c = 0.f;
      for (int i = lane; i < my_rows; i += 32) c += __ldg(p.mask + row0 + i);
      c = warp_sum(c);
      if (lane == 0) p.count_part[cta] = c;
    }
    // the preds no row pass writes: rows past each tenant's valid ones
    const long long gthreads = (long long)ncta * kThreads;
    for (long long i = (long long)cta * kThreads + threadIdx.x; i < (long long)tenants * rows;
         i += gthreads)
      if ((int)(i % rows) >= t.valid[i / rows]) p.preds[i] = 0.f;
    __threadfence();  // the staged rows are read back through L2 below
    __syncthreads();
  } else {
    const int uit = row_pass ? it - 1 : it;  // the iteration this launch updates
    const bool reload = row_pass && !((prev >> m) & 1u);  // w and y for the row pass
    const int lanes = update_lanes(tenants, cols);
    // this rank's labels of the CTA's tenant, by the warps the update leaves
    // free (a warp that loads a label waits for it before its next load):
    // in flight through (a) and barrier 1
    const int busy = min((tenants * lanes + 31) & ~31, kThreads - 32);
    if (reload && (int)threadIdx.x >= busy)
      for (int l = threadIdx.x - busy; l < my_rows; l += kThreads - busy)
        y_s[l] = __ldg(p.mask + row0 + l) > 0.f ? __ldg(p.labels + row0 + l) : 0.f;
    // ---- (a) every training tenant's update of iteration uit, this CTA's slices
    for (int q = cta; q < s.slices; q += ncta)
      tenant_split_update(p, t, s, prev, uit, q, min(q * cols, fpad),
                          min(q * cols + cols, fpad), lanes);
    if (threadIdx.x == 0) *finished_s = prev;  // the grid barrier orders it before the ORs
    probe_stamp<kProbe>(t, slot, 1);
    grid.sync();
    probe_stamp<kProbe>(t, slot, 2);

    // ---- every CTA: every tenant's decision, the same in each, in one round
    // of loads with the CTA's tenant's new w (used only if it still trains).
    // Up to kDirectTenants tenants warp u takes tenant u's from L2
    // (converged()) while the other warps reload w; more, thread (u, lane)
    // sums lane `lane`'s share of tenant u's norm table (converged()'s own
    // order) into shared memory with the count while every thread reloads
    // w, then warp u takes tenants u, u + kWarps, ... from there (both in
    // converged()'s order of summation)
    if (tenants <= kDirectTenants) {
      if (warp < tenants) {
        if (!((prev >> warp) & 1u)) {
          const bool live = __ldcg(s.gbuf + warp * gstride + fpad) > 0.f;
          float ds, ns;
          norm_lane_sums(p.norm_part + 2 * (size_t)warp * s.slices, s.slices, lane, ds, ns);
          const bool conv = converged_norms(warp_sum(ds), warp_sum(ns), p.tol);
          if (lane == 0) {
            if (!live || conv) atomicOr(finished_s, 1u << warp);
            if (cta == 0 && live) p.iterations[warp] = (float)uit;
          }
        }
      } else if (reload) {
        for (int f = threadIdx.x - 32 * tenants; f < fpad; f += kThreads - 32 * tenants)
          w_s[f] = __ldcg(wbuf + f);
      }
    } else {
      float* table = red;  // [tenants, 32] lane sums of ‖Δw‖², ‖w‖², then the counts
      for (int i = threadIdx.x; i < 32 * tenants; i += kThreads) {
        const int u = i >> 5, l = i & 31;
        if ((prev >> u) & 1u) continue;
        float ds, ns;
        norm_lane_sums(p.norm_part + 2 * (size_t)u * s.slices, s.slices, l, ds, ns);
        table[2 * i] = ds;
        table[2 * i + 1] = ns;
        if (l == 0) table[64 * tenants + u] = __ldcg(s.gbuf + u * gstride + fpad);
      }
      if (reload)
        for (int f = threadIdx.x; f < fpad; f += kThreads) w_s[f] = __ldcg(wbuf + f);
      __syncthreads();
      for (int u = warp; u < tenants; u += kWarps) {
        if ((prev >> u) & 1u) continue;
        const bool live = table[64 * tenants + u] > 0.f;
        const float ds = warp_sum(table[2 * (32 * u + lane)]);
        const float ns = warp_sum(table[2 * (32 * u + lane) + 1]);
        if (lane == 0) {
          if (!live || converged_norms(ds, ns, p.tol)) atomicOr(finished_s, 1u << u);
          if (cta == 0 && live) p.iterations[u] = (float)uit;
        }
      }
    }
    __syncthreads();
    finished = *finished_s;
    if (cta == 0 && threadIdx.x == 0) *s.state = (int)finished;
    probe_stamp<kProbe>(t, slot, 3);
    if (!row_pass || finished == all) return;
  }

  // ---- (b) the row pass of this CTA's tenant: its Xᵀr into the CTA's partials
  if (!((finished >> m) & 1u)) {
    if (p.nvec <= kTileGroups)
      row_pass_narrow<kLogistic>(p, w_s, y_s, nullptr, red, cta, row0, my_rows, first, true);
    else
      row_pass_wide<kLogistic>(p, w_s, y_s, r_s, nullptr, red, cta, row0, my_rows, first,
                               true);
  }
  // a later launch's counts: each tenant's on this rank, constant through the step
  const bool copy_count = !first && cta == 0 && (int)threadIdx.x < tenants;
  const float count = copy_count ? __ldcg(s.counts + threadIdx.x) : 0.f;
  probe_stamp<kProbe>(t, slot, 4);
  grid.sync();
  probe_stamp<kProbe>(t, slot, 5);

  // ---- (c) each training tenant's Xᵀr over its CTAs, this CTA's slices, and
  // each tenant's count
  for (int q = cta; q < s.slices; q += ncta)
    tenant_split_reduce(p, t, s, red, finished, min(q * cols, fpad), min(q * cols + cols, fpad));
  if (first && cta == 0) {  // warp u sums tenant u's CTA counts, as the split sums its own
    for (int u = warp; u < tenants; u += kWarps) {
      const int a = t.first_cta[u], ku = t.first_cta[u + 1] - a;
      float c = 0.f;
      for (int i = lane; i < ku; i += 32) c += __ldcg(p.count_part + a + i);
      c = warp_sum(c);
      if (lane == 0) s.gbuf[u * gstride + fpad] = s.counts[u] = c;
    }
  } else if (copy_count && !((finished >> threadIdx.x) & 1u)) {
    s.gbuf[threadIdx.x * gstride + fpad] = count;
  }
  probe_stamp<kProbe>(t, slot, 6);
}

// ------------------------------------------------------------------ predict

struct PredictParams {
  const float* x;     // [rows, features] f32, row stride features
  const float* mask;  // [rows] f32
  const float* w0;    // [features] f32
  float* w_out;       // [features] f32: w0
  float* preds;       // [rows] f32
  float* iterations;  // [1] f32: 0
  int rows, features, fpad, nvec;
};

// The f32 columns of the groups v0 + lane + 32k (k < kVpl) of one row:
// 16-byte read-only loads where a group lies whole inside the row, else
// per column, zero past `features` (as stage_row reads them).
__device__ __forceinline__ void load_groups_f32(const float* xr, int features, int v0,
                                                int lane, bool vec4, float4 (&a)[kVpl],
                                                float4 (&b)[kVpl]) {
#pragma unroll
  for (int k = 0; k < kVpl; ++k) {
    const int c0 = (v0 + lane + 32 * k) * 8;
    if (vec4 && c0 + 8 <= features) {
      a[k] = __ldg(reinterpret_cast<const float4*>(xr + c0));
      b[k] = __ldg(reinterpret_cast<const float4*>(xr + c0 + 4));
    } else {  // ragged edge, zero padding, or X not 16-byte aligned
      float f8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f8[e] = c0 + e < features ? __ldg(xr + c0 + e) : 0.f;
      a[k] = make_float4(f8[0], f8[1], f8[2], f8[3]);
      b[k] = make_float4(f8[4], f8[5], f8[6], f8[7]);
    }
  }
}

// One narrow row in flight: its f32 columns and its mask.
struct RowF32 {
  float4 a[kVpl], b[kVpl];
  float m;
};

__device__ __forceinline__ void load_row_f32(const PredictParams& p, int row, int lane,
                                             bool vec4, RowF32& r) {
  load_groups_f32(p.x + (size_t)row * p.features, p.features, 0, lane, vec4, r.a, r.b);
  r.m = __ldg(p.mask + row);
}

// narrow_row's dot on the first pass, from stage_row's bf16 groups.
__device__ __forceinline__ void predict_narrow_row(const PredictParams& p, const RowF32& r,
                                                   const float (&wr)[kVpl][8], int row,
                                                   int lane) {
  const bool keep = r.m > 0.f;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  float dot = dot8(keep ? pack8(r.a[0], r.b[0]) : zero, wr[0], 0.f);
#pragma unroll
  for (int k = 1; k < kVpl; ++k) dot += dot8(keep ? pack8(r.a[k], r.b[k]) : zero, wr[k], 0.f);
  dot = warp_sum(dot);
  if (lane == 0) p.preds[row] = dot;
}

__global__ void __launch_bounds__(kPredictThreads, 2) fused_predict_kernel(const PredictParams p) {
  extern __shared__ __align__(16) float w_s[];  // w0, zero past features
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = gridDim.x * kPredictWarps;  // warps in the grid
  const int rows = p.rows, features = p.features, nvec = p.nvec;
  const bool narrow = nvec <= kTileGroups;
  const bool vec4 = features % 4 == 0 && (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
  int row = blockIdx.x * kPredictWarps + warp;
  RowF32 cur, nxt;
  if (narrow && row < rows) load_row_f32(p, row, lane, vec4, cur);  // in flight meanwhile
  const int wcols = narrow ? kTileCols : p.fpad;
  for (int f = threadIdx.x; f < wcols; f += kPredictThreads)
    w_s[f] = f < features ? __ldg(p.w0 + f) : 0.f;
  for (int f = blockIdx.x * kPredictThreads + threadIdx.x; f < features;
       f += gridDim.x * kPredictThreads)
    p.w_out[f] = __ldg(p.w0 + f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.iterations = 0.f;
  __syncthreads();

  if (narrow) {  // w in registers; the next row's loads in flight while this one computes
    float wr[kVpl][8];
#pragma unroll
    for (int k = 0; k < kVpl; ++k) load_w8(w_s, lane + 32 * k, wr[k]);
    while (row < rows) {
      if (row + stride < rows) load_row_f32(p, row + stride, lane, vec4, nxt);
      predict_narrow_row(p, cur, wr, row, lane);
      row += stride;
      if (row >= rows) break;
      if (row + stride < rows) load_row_f32(p, row + stride, lane, vec4, cur);
      predict_narrow_row(p, nxt, wr, row, lane);
      row += stride;
    }
    return;
  }
  // wide: row_pass_wide's order, the dot carried across tiles of 1024 columns
  for (; row < rows; row += stride) {
    const float* xr = p.x + (size_t)row * features;
    const bool keep = __ldg(p.mask + row) > 0.f;
    float dot = 0.f;
    for (int g0 = 0; g0 < nvec; g0 += kTileGroups) {
      float4 a[kVpl], b[kVpl];
      load_groups_f32(xr, features, g0, lane, vec4, a, b);
#pragma unroll
      for (int k = 0; k < kVpl; ++k) {
        const int v = g0 + lane + 32 * k;
        if (v < nvec) {
          float w8[8];
          load_w8(w_s, v, w8);
          dot = dot8(keep ? pack8(a[k], b[k]) : make_uint4(0u, 0u, 0u, 0u), w8, dot);
        }
      }
    }
    dot = warp_sum(dot);
    if (lane == 0) p.preds[row] = dot;
  }
}

}  // namespace

// Once a device, before its first launch: the SM count and the opt-in
// shared memory a block may use on `device` (for the launch plan), and both
// instantiations' dynamic shared-memory limit raised to that opt-in there,
// so that a launch makes no set-up call of its own (the split's and the
// tenant grid's kernels too). Returns a CUDA error code, 0 on success.
extern "C" int twtml_fused_sgd_setup(int device, int* sm_count, int* shared_optin) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(shared_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_sgd_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *shared_optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_sgd_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *shared_optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dense_iteration_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *shared_optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dense_iteration_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *shared_optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tenant_sgd_kernel<false, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *shared_optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tenant_sgd_kernel<true, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *shared_optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tenant_sgd_kernel<false, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *shared_optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tenant_sgd_kernel<true, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *shared_optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tenant_iteration_kernel<false, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *shared_optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tenant_iteration_kernel<true, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *shared_optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tenant_iteration_kernel<false, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *shared_optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tenant_iteration_kernel<true, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *shared_optin);
  const cudaError_t restored = cudaSetDevice(current);
  return (int)(err != cudaSuccess ? err : restored);
}

// The whole loop for one batch, one cooperative launch on `stream` (the
// current device's, set up by twtml_fused_sgd_setup). Pointers are device
// pointers:
//   x [rows, features] f32 contiguous, labels/mask [rows] f32, w0 [features]
//   f32 (inputs, unchanged); w_out [features], preds [rows] f32 (outputs);
//   spill [grid·spill_per_cta·8·plan_layout[5]] bf16 and scratch [grid·fpad
//   + fpad + 3·grid + 1] f32 (its last float receives the iterations run).
// grid, rows_cap (most rows a CTA owns), resident (rows a CTA keeps in
// shared memory), spill_per_cta, shared_bytes and `plan_layout` (host
// memory: the plan's byte offsets of the reduction slots, y, r, scratch and
// the resident rows, then the 16-byte groups a stored row takes) come from
// the launch plan; a plan whose layout differs from layout() and
// row_groups() here is refused. `residual_mode` picks the loss: 0 least
// squares, 1 logistic (any other value is refused). Returns the CUDA error
// of the launch (a refused cooperative launch included), 0 when it was
// taken.
extern "C" int twtml_fused_dense_sgd(
    const void* x, const void* labels, const void* mask, const void* w0, void* w_out,
    void* preds, void* spill, void* scratch, int rows, int features, int fpad, int grid,
    int rows_cap, int resident, int spill_per_cta, int shared_bytes, const int* plan_layout,
    int num_iterations, float step_size, float l2_reg, float tol, int residual_mode,
    void* stream) {
  const Layout lay = layout(fpad, rows_cap);
  const int stride = row_groups(fpad);
  if (rows < 1 || features < 1 || fpad % 8 != 0 || features > fpad || grid < 1 ||
      (long long)rows_cap * grid < rows || resident < 0 || resident > rows_cap ||
      spill_per_cta != rows_cap - resident || num_iterations < 0 ||
      (residual_mode != 0 && residual_mode != 1) ||
      (size_t)plan_layout[0] != lay.red || (size_t)plan_layout[1] != lay.y ||
      (size_t)plan_layout[2] != lay.r || (size_t)plan_layout[3] != lay.scratch ||
      (size_t)plan_layout[4] != lay.x || plan_layout[5] != stride ||
      (size_t)shared_bytes < lay.x + (size_t)resident * stride * 16)
    return (int)cudaErrorInvalidValue;

  Params p;
  p.x = static_cast<const float*>(x);
  p.labels = static_cast<const float*>(labels);
  p.mask = static_cast<const float*>(mask);
  p.w0 = static_cast<const float*>(w0);
  p.w_out = static_cast<float*>(w_out);
  p.preds = static_cast<float*>(preds);
  p.spill = static_cast<__nv_bfloat16*>(spill);
  p.partials = static_cast<float*>(scratch);
  p.wbuf = p.partials + (size_t)grid * fpad;
  p.count_part = p.wbuf + fpad;
  p.norm_part = p.count_part + grid;
  p.iterations = p.norm_part + 2 * grid;
  p.rows = rows;
  p.features = features;
  p.fpad = fpad;
  p.nvec = fpad / 8;
  p.stride = stride;
  p.rows_cap = rows_cap;
  p.resident = resident;
  p.spill_per_cta = spill_per_cta;
  p.num_iterations = num_iterations;
  p.step_size = step_size;
  p.l2_reg = l2_reg;
  p.tol = tol;
  void* args[] = {&p};
  const void* kernel = residual_mode == 1
                           ? reinterpret_cast<const void*>(fused_sgd_kernel<true>)
                           : reinterpret_cast<const void*>(fused_sgd_kernel<false>);
  return (int)cudaLaunchCooperativeKernel(kernel,
                                          dim3(grid), dim3(kThreads), args,
                                          (size_t)shared_bytes, static_cast<cudaStream_t>(stream));
}

// The predict-only mode (N = 0) for one batch, one plain launch on `stream`:
// x [rows, features] f32 contiguous, mask [rows], w0 [features] f32 (inputs);
// preds [rows], w_out [features] (= w0) and iterations [1] (= 0) f32
// (outputs). `grid` comes from the predict plan (ops/fused_sgd.py
// predict_plan: warp w of the grid takes rows w, w + 8·grid, ...), and
// shared_bytes = 4·max(fpad, 1024) (w0); a plan that differs is refused.
// Returns the launch's CUDA error, 0 when it was taken.
extern "C" int twtml_fused_dense_predict(const void* x, const void* mask, const void* w0,
                                         void* w_out, void* preds, void* iterations, int rows,
                                         int features, int fpad, int grid, int shared_bytes,
                                         void* stream) {
  if (rows < 1 || features < 1 || fpad % 8 != 0 || features > fpad || fpad - features >= 8 ||
      grid < 1 || shared_bytes != 4 * (fpad <= kTileCols ? kTileCols : fpad))
    return (int)cudaErrorInvalidValue;
  PredictParams p;
  p.x = static_cast<const float*>(x);
  p.mask = static_cast<const float*>(mask);
  p.w0 = static_cast<const float*>(w0);
  p.w_out = static_cast<float*>(w_out);
  p.preds = static_cast<float*>(preds);
  p.iterations = static_cast<float*>(iterations);
  p.rows = rows;
  p.features = features;
  p.fpad = fpad;
  p.nvec = fpad / 8;
  fused_predict_kernel<<<grid, kPredictThreads, (size_t)shared_bytes,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// ---- the split's two C entries (each one cooperative launch on `stream`) --
//
// Shared by both: the launch plan of one B1 call on the rank's rows
// (ops/fused_sgd.py split_plan: B1's grid and rows_cap, no resident rows,
// shared_bytes = the layout's x offset), `scratch` B1's [grid·fpad + fpad +
// 3·grid + 1] f32 (partials, w, counts, norms, iterations run), `state`
// int32 [1] and `gbuf` f32 [fpad + 1]; `it` >= 1 and the step's step size,
// L2 and tolerance. Each returns the launch's CUDA error (a refused
// cooperative launch included; cudaErrorInvalidValue for a plan that
// differs from layout()), 0 when it was taken.
namespace {
int split_params(Params& p, const void* x, const void* labels, const void* mask,
                 const void* w0, void* w_out, void* preds, void* staged, void* scratch,
                 int rows, int features, int fpad, int grid, int rows_cap, int shared_bytes,
                 const int* plan_layout, int it, float step_size, float l2_reg, float tol) {
  const Layout lay = layout(fpad, rows_cap);
  const int stride = row_groups(fpad);
  if (rows < 1 || features < 1 || fpad % 8 != 0 || features > fpad || grid < 1 || it < 1 ||
      (long long)rows_cap * grid < rows || (size_t)plan_layout[0] != lay.red ||
      (size_t)plan_layout[1] != lay.y || (size_t)plan_layout[2] != lay.r ||
      (size_t)plan_layout[3] != lay.scratch || (size_t)plan_layout[4] != lay.x ||
      plan_layout[5] != stride || (size_t)shared_bytes != lay.x)
    return (int)cudaErrorInvalidValue;
  p.x = static_cast<const float*>(x);
  p.labels = static_cast<const float*>(labels);
  p.mask = static_cast<const float*>(mask);
  p.w0 = static_cast<const float*>(w0);
  p.w_out = static_cast<float*>(w_out);
  p.preds = static_cast<float*>(preds);
  p.spill = static_cast<__nv_bfloat16*>(staged);
  p.partials = static_cast<float*>(scratch);
  p.wbuf = p.partials + (size_t)grid * fpad;
  p.count_part = p.wbuf + fpad;
  p.norm_part = p.count_part + grid;
  p.iterations = p.norm_part + 2 * grid;
  p.rows = rows;
  p.features = features;
  p.fpad = fpad;
  p.nvec = fpad / 8;
  p.stride = stride;
  p.rows_cap = rows_cap;
  p.resident = 0;  // every row in the staged buffer
  p.spill_per_cta = rows_cap;
  p.num_iterations = 0;
  p.step_size = step_size;
  p.l2_reg = l2_reg;
  p.tol = tol;
  return 0;
}

int launch_iteration(Params p, void* state, void* gbuf, int it, int row_pass, int residual_mode,
                     int grid, int shared_bytes, void* stream) {
  SplitState s{static_cast<int*>(state), static_cast<float*>(gbuf)};
  void* args[] = {&p, &s, &it, &row_pass};
  const void* kernel = residual_mode == 1
                           ? reinterpret_cast<const void*>(dense_iteration_kernel<true>)
                           : reinterpret_cast<const void*>(dense_iteration_kernel<false>);
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                          (size_t)shared_bytes, static_cast<cudaStream_t>(stream));
}
}  // namespace

// Iteration `it` of a step on this rank's rows: (a) the update of it − 1
// from the all-reduced gbuf (it >= 2), (b) the row pass (it == 1 also stages
// X from x [rows, features] f32, reads labels/mask [rows] and w0 [features]
// f32, and writes preds [rows] and w_out [features] = w0), (c) this rank's
// Xᵀr and count into gbuf. `staged` is the bf16 X [grid·rows_cap·8·
// plan_layout[5]]. `residual_mode`: 0 least squares, 1 logistic.
extern "C" int twtml_fused_dense_grad(const void* x, const void* labels, const void* mask,
                                      const void* w0, void* w_out, void* preds, void* staged,
                                      void* scratch, void* state, void* gbuf, int rows,
                                      int features, int fpad, int grid, int rows_cap,
                                      int shared_bytes, const int* plan_layout, int it,
                                      float step_size, float l2_reg, float tol,
                                      int residual_mode, void* stream) {
  Params p;
  const int err = split_params(p, x, labels, mask, w0, w_out, preds, staged, scratch, rows,
                               features, fpad, grid, rows_cap, shared_bytes, plan_layout, it,
                               step_size, l2_reg, tol);
  if (err != 0 || (residual_mode != 0 && residual_mode != 1)) return (int)cudaErrorInvalidValue;
  return launch_iteration(p, state, gbuf, it, 1, residual_mode, grid, shared_bytes, stream);
}

// The update of iteration `it` alone, after the step's last all-reduce: (a)
// with no row pass; w_out [features] f32 receives the weights.
extern "C" int twtml_fused_dense_update(void* w_out, void* scratch, void* state, void* gbuf,
                                        int rows, int features, int fpad, int grid,
                                        int rows_cap, int shared_bytes, const int* plan_layout,
                                        int it, float step_size, float l2_reg, float tol,
                                        void* stream) {
  Params p;
  const int err = split_params(p, nullptr, nullptr, nullptr, nullptr, w_out, nullptr, nullptr,
                               scratch, rows, features, fpad, grid, rows_cap, shared_bytes,
                               plan_layout, it, step_size, l2_reg, tol);
  if (err != 0) return err;
  return launch_iteration(p, state, gbuf, it, 0, 0, grid, shared_bytes, stream);
}

// M tenants' loops, one cooperative launch on `stream` (tenant_sgd_kernel;
// the current device's, set up by twtml_fused_sgd_setup). Device pointers:
// x [tenants, rows, features] f32 contiguous, labels/mask [tenants, rows]
// f32, w0 [tenants, features] f32 (inputs, unchanged); w_out [tenants,
// features], preds [tenants, rows] f32 (outputs); spill [grid·spill_per_cta
// ·8·plan_layout[5]] bf16 and scratch [grid·fpad + tenants·fpad + 3·grid +
// tenants] f32 (its last `tenants` floats receive each tenant's iterations
// run). Host arrays from the tenant plan (ops/fused_sgd.py
// tenant_launch_plan): first_cta [tenants + 1] (tenant t owns CTAs
// [first_cta[t], first_cta[t+1]), first_cta[tenants] = grid), valid
// [tenants] (rows read as X), step_sizes and l2_regs [tenants]; rows_cap
// (most rows a CTA owns), resident, spill_per_cta, shared_bytes and
// plan_layout as B1's. With `probe` (int64 [1 + tenants, probe_edges, 2],
// zeroed) the timing instantiation runs. A plan that breaks these, or whose
// layout differs from layout() and row_groups(), is refused. Returns the
// launch's CUDA error (a refused cooperative launch included), 0 when it
// was taken.
extern "C" int twtml_fused_dense_sgd_tenants(
    const void* x, const void* labels, const void* mask, const void* w0, void* w_out,
    void* preds, void* spill, void* scratch, int tenants, int rows, int features, int fpad,
    int grid, int rows_cap, int resident, int spill_per_cta, int shared_bytes,
    const int* plan_layout, const int* first_cta, const int* valid, const float* step_sizes,
    const float* l2_regs, int num_iterations, float tol, int residual_mode, void* probe,
    int probe_edges, void* stream) {
  const Layout lay = layout(fpad, rows_cap);
  const int stride = row_groups(fpad);
  if (tenants < 1 || tenants > kMaxTenants || rows < 1 || features < 1 || fpad % 8 != 0 ||
      features > fpad || grid < 1 || rows_cap < 1 || resident < 0 || resident > rows_cap ||
      spill_per_cta != rows_cap - resident || num_iterations < 0 ||
      (residual_mode != 0 && residual_mode != 1) || first_cta[0] != 0 ||
      first_cta[tenants] != grid || (size_t)plan_layout[0] != lay.red ||
      (size_t)plan_layout[1] != lay.y || (size_t)plan_layout[2] != lay.r ||
      (size_t)plan_layout[3] != lay.scratch || (size_t)plan_layout[4] != lay.x ||
      plan_layout[5] != stride || (size_t)shared_bytes < lay.x + (size_t)resident * stride * 16 ||
      (probe != nullptr && probe_edges < 1))
    return (int)cudaErrorInvalidValue;
  TenantTable t;
  t.probe = static_cast<unsigned long long*>(probe);
  t.probe_edges = probe != nullptr ? probe_edges : 0;
  t.tenants = tenants;
  t.batch_rows = rows;
  for (int u = 0; u <= tenants; ++u) t.first_cta[u] = first_cta[u];
  for (int u = 0; u < tenants; ++u) {
    const int k = first_cta[u + 1] - first_cta[u];
    // rows in [0, B]; a tenant with rows has CTAs, and none holds more than rows_cap
    if (k < 0 || valid[u] < 0 || valid[u] > rows || (valid[u] > 0 && k == 0) ||
        (k > 0 && (valid[u] + k - 1) / k > rows_cap))
      return (int)cudaErrorInvalidValue;
    t.valid[u] = valid[u];
    t.step_size[u] = step_sizes[u];
    t.l2_reg[u] = l2_regs[u];
  }
  for (int u = tenants; u < kMaxTenants; ++u) {
    t.first_cta[u + 1] = grid;
    t.valid[u] = 0;
    t.step_size[u] = t.l2_reg[u] = 0.f;
  }
  Params p;
  p.x = static_cast<const float*>(x);
  p.labels = static_cast<const float*>(labels);
  p.mask = static_cast<const float*>(mask);
  p.w0 = static_cast<const float*>(w0);
  p.w_out = static_cast<float*>(w_out);
  p.preds = static_cast<float*>(preds);
  p.spill = static_cast<__nv_bfloat16*>(spill);
  p.partials = static_cast<float*>(scratch);
  p.wbuf = p.partials + (size_t)grid * fpad;
  p.count_part = p.wbuf + (size_t)tenants * fpad;
  p.norm_part = p.count_part + grid;
  p.iterations = p.norm_part + 2 * grid;
  p.rows = rows;
  p.features = features;
  p.fpad = fpad;
  p.nvec = fpad / 8;
  p.stride = stride;
  p.rows_cap = rows_cap;
  p.resident = resident;
  p.spill_per_cta = spill_per_cta;
  p.num_iterations = num_iterations;
  p.step_size = 0.f;  // each tenant's own, from the table
  p.l2_reg = 0.f;
  p.tol = tol;
  void* args[] = {&p, &t};
  const void* kernels[2][2] = {
      {reinterpret_cast<const void*>(tenant_sgd_kernel<false, false>),
       reinterpret_cast<const void*>(tenant_sgd_kernel<false, true>)},
      {reinterpret_cast<const void*>(tenant_sgd_kernel<true, false>),
       reinterpret_cast<const void*>(tenant_sgd_kernel<true, true>)}};
  const void* kernel = kernels[residual_mode][probe != nullptr];
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                          (size_t)shared_bytes, static_cast<cudaStream_t>(stream));
}

// The split with a tenant grid on this rank's rows, set up once a step:
// twtml_tenant_split_prepare checks the plan and builds the launch's
// Params, TenantTable and TenantSplitState into a host handle; each
// iteration's launch then passes only the handle, `it`, `row_pass` and the
// stream (twtml_tenant_split_launch); twtml_tenant_split_release frees the
// handle. Device pointers: x [tenants, rows, features] f32, labels/mask
// [tenants, rows] f32 and w0 [tenants, features] f32 (inputs); w_out
// [tenants, features] and preds [tenants, rows] f32 (outputs); `staged` the
// bf16 X [grid·rows_cap·8·plan_layout[5]], `scratch` f32 [grid·fpad +
// tenants·fpad + grid + tenants + 2·tenants·slices + tenants] (partials,
// each tenant's w, the CTAs' counts, each tenant's count, the norm table;
// its last `tenants` floats receive each tenant's iterations run), `state`
// int32 [1], `gbuf`
// f32 [tenants, fpad + 1]. The tenant table (host arrays first_cta, valid,
// step_sizes, l2_regs), rows_cap and plan_layout come from
// ops/fused_sgd.py tenant_split_plan (no resident rows, shared_bytes = the
// layout's x offset), `slices` >= 1 too. With `probe` (int64 [1 + tenants,
// probe_edges, 2], zeroed) the launches run the timing instantiation. A
// plan that breaks these is refused with cudaErrorInvalidValue and no
// handle. The launch is on the device that was current at prepare.
namespace {
struct TenantSplitLaunch {
  Params p;
  TenantTable t;
  TenantSplitState s;
  const void* kernel;
  int grid, shared_bytes, device;
};
}  // namespace

extern "C" int twtml_tenant_split_prepare(
    const void* x, const void* labels, const void* mask, const void* w0, void* w_out,
    void* preds, void* staged, void* scratch, void* state, void* gbuf, int tenants, int rows,
    int features, int fpad, int grid, int rows_cap, int shared_bytes, const int* plan_layout,
    const int* first_cta, const int* valid, const float* step_sizes, const float* l2_regs,
    int slices, float tol, int residual_mode, void* probe, int probe_edges, void** handle) {
  *handle = nullptr;
  const Layout lay = layout(fpad, rows_cap);
  const int stride = row_groups(fpad);
  if (tenants < 1 || tenants > kMaxTenants || rows < 1 || features < 1 || fpad % 8 != 0 ||
      features > fpad || grid < 1 || rows_cap < 1 || slices < 1 ||
      (residual_mode != 0 && residual_mode != 1) || first_cta[0] != 0 ||
      first_cta[tenants] != grid || (size_t)plan_layout[0] != lay.red ||
      (size_t)plan_layout[1] != lay.y || (size_t)plan_layout[2] != lay.r ||
      (size_t)plan_layout[3] != lay.scratch || (size_t)plan_layout[4] != lay.x ||
      plan_layout[5] != stride || (size_t)shared_bytes != lay.x ||
      (probe != nullptr && probe_edges < 1))
    return (int)cudaErrorInvalidValue;
  TenantSplitLaunch h;
  TenantTable& t = h.t;
  t.probe = static_cast<unsigned long long*>(probe);
  t.probe_edges = probe != nullptr ? probe_edges : 0;
  t.tenants = tenants;
  t.batch_rows = rows;
  for (int u = 0; u <= tenants; ++u) t.first_cta[u] = first_cta[u];
  for (int u = 0; u < tenants; ++u) {
    const int k = first_cta[u + 1] - first_cta[u];
    // rows in [0, B]; a tenant with rows has CTAs, and none holds more than rows_cap
    if (k < 0 || valid[u] < 0 || valid[u] > rows || (valid[u] > 0 && k == 0) ||
        (k > 0 && (valid[u] + k - 1) / k > rows_cap))
      return (int)cudaErrorInvalidValue;
    t.valid[u] = valid[u];
    t.step_size[u] = step_sizes[u];
    t.l2_reg[u] = l2_regs[u];
  }
  for (int u = tenants; u < kMaxTenants; ++u) {
    t.first_cta[u + 1] = grid;
    t.valid[u] = 0;
    t.step_size[u] = t.l2_reg[u] = 0.f;
  }
  Params& p = h.p;
  p.x = static_cast<const float*>(x);
  p.labels = static_cast<const float*>(labels);
  p.mask = static_cast<const float*>(mask);
  p.w0 = static_cast<const float*>(w0);
  p.w_out = static_cast<float*>(w_out);
  p.preds = static_cast<float*>(preds);
  p.spill = static_cast<__nv_bfloat16*>(staged);
  p.partials = static_cast<float*>(scratch);
  p.wbuf = p.partials + (size_t)grid * fpad;
  p.count_part = p.wbuf + (size_t)tenants * fpad;
  float* counts = p.count_part + grid;
  p.norm_part = counts + tenants;
  p.iterations = p.norm_part + 2 * (size_t)tenants * slices;
  p.rows = rows;
  p.features = features;
  p.fpad = fpad;
  p.nvec = fpad / 8;
  p.stride = stride;
  p.rows_cap = rows_cap;
  p.resident = 0;  // every row in the staged buffer
  p.spill_per_cta = rows_cap;
  p.num_iterations = 0;
  p.step_size = 0.f;  // each tenant's own, from the table
  p.l2_reg = 0.f;
  p.tol = tol;
  TenantSplitState& st = h.s;
  st.state = static_cast<int*>(state);
  st.gbuf = static_cast<float*>(gbuf);
  st.counts = counts;
  st.slices = slices;
  const void* kernels[2][2] = {
      {reinterpret_cast<const void*>(tenant_iteration_kernel<false, false>),
       reinterpret_cast<const void*>(tenant_iteration_kernel<false, true>)},
      {reinterpret_cast<const void*>(tenant_iteration_kernel<true, false>),
       reinterpret_cast<const void*>(tenant_iteration_kernel<true, true>)}};
  h.kernel = kernels[residual_mode][probe != nullptr];
  h.grid = grid;
  h.shared_bytes = shared_bytes;
  const cudaError_t err = cudaGetDevice(&h.device);
  if (err != cudaSuccess) return (int)err;
  *handle = new TenantSplitLaunch(h);
  return 0;
}

// Iteration `it` >= 1 of the step a handle was prepared for, one
// cooperative launch of tenant_iteration_kernel on `stream`: with row_pass
// 1, (a) the update of it − 1 from the all-reduced gbuf (it >= 2), (b) the
// row pass (it == 1 also stages X and writes preds and w_out = w0), (c)
// every training tenant's Xᵀr and count into gbuf; with row_pass 0, the
// update of `it` alone. Returns the launch's CUDA error (a refused
// cooperative launch included; cudaErrorInvalidValue for a bad `it` or
// `row_pass`), 0 when it was taken.
extern "C" int twtml_tenant_split_launch(void* handle, int it, int row_pass, void* stream) {
  TenantSplitLaunch* h = static_cast<TenantSplitLaunch*>(handle);
  if (h == nullptr || it < 1 || (row_pass != 0 && row_pass != 1))
    return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != h->device) err = cudaSetDevice(h->device);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&h->p, &h->t, &h->s, &it, &row_pass};
  err = cudaLaunchCooperativeKernel(h->kernel, dim3(h->grid), dim3(kThreads), args,
                                    (size_t)h->shared_bytes, static_cast<cudaStream_t>(stream));
  if (current != h->device) {
    const cudaError_t restored = cudaSetDevice(current);
    if (err == cudaSuccess) err = restored;
  }
  return (int)err;
}

extern "C" int twtml_tenant_split_release(void* handle) {
  delete static_cast<TenantSplitLaunch*>(handle);
  return 0;
}
