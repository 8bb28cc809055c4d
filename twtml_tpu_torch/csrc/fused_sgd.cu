// Fused predict-then-train dense SGD for Hopper (sm_90a).
//
// Replaces twtml_tpu/ops/pallas_sgd.py::_sgd_kernel, the TPU kernel that
// runs MLlib's GradientDescent loop on a [B, F] design matrix held in VMEM:
//   preds = X·w0; then for it = 1..N:
//     r = X·w − y;  g = Xᵀr / max(count, 1);  η = stepSize/√it;
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
// What Hopper offers and this design leaves out: tensor cores. Both
// products are matrix × vector (N = 1, while wgmma takes N >= 8), and bf16
// operands would round w and r at each product, which the f32 twin does
// not; so the kernel stays on the f32 FMA units, and so does its bound.
// TMA and clusters buy nothing for a one-time, row-contiguous prologue.

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

// The launch plan (ops/fused_sgd.py) sizes the shared memory from its own
// copy of these constants; ops/_build.py passes that copy as -D flags, so
// the two cannot drift apart without the build failing here.
#if !defined(TWTML_SGD_THREADS) || !defined(TWTML_SGD_TILE_COLUMNS) || \
    !defined(TWTML_SGD_REDUCE_SLOTS) || !defined(TWTML_SGD_SCRATCH_FLOATS)
#error "build through twtml_tpu_torch/ops/_build.py, which passes the launch plan's constants"
#endif
static_assert(kThreads == TWTML_SGD_THREADS, "THREADS differs from ops/fused_sgd.py");
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

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
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
// pass), then acc += (dot − y)·x from the same registers.
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
    const float r = dot - y_s[l];
#pragma unroll
    for (int k = 0; k < kVpl; ++k) axpy8(r, x[k], acc[k]);
  }
}

// One pass over the CTA's rows, fpad <= kTileCols: w and the Xᵀr
// accumulator in registers, each row read once; the next row of the warp
// is loaded into the other register buffer while this one computes.
__device__ void row_pass_narrow(const Params& p, const float* w_s, const float* y_s,
                                const uint4* x_s, float* red, int cta, int row0,
                                int my_rows, bool first, bool train) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float wr[kVpl][8], acc[kVpl][8];
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
    narrow_row(p, wr, acc, xa, y_s, row0, l, lane, first, train);
    l += kWarps;
    if (l >= my_rows) break;
    if (l + kWarps < my_rows) load_row_narrow(p, x_s, cta, l + kWarps, lane, xa);
    narrow_row(p, wr, acc, xb, y_s, row0, l, lane, first, train);
    l += kWarps;
  }
  if (train) cta_reduce_tile(acc, red, p.partials + (size_t)cta * p.fpad, 0, p.fpad);
}

// fpad > kTileCols: w stays in shared memory; r for every row first, then
// Xᵀr one tile of columns at a time (two passes over each row).
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
      r_s[l] = dot - y_s[l];
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
      if (v < p.stride)
        dst[v] = make_uint4(pack_bf16x2(a[k].x, a[k].y), pack_bf16x2(a[k].z, a[k].w),
                            pack_bf16x2(b[k].x, b[k].y), pack_bf16x2(b[k].z, b[k].w));
    }
  }
  if (lane == 0) y_s[l] = keep ? __ldg(p.labels + row) : 0.f;
}

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
    // ---- one pass over X: r = X·w − y (preds on the first), CTA's Xᵀr
    if (narrow)
      row_pass_narrow(p, w_s, y_s, x_s, red, cta, row0, my_rows, it == 1, train);
    else
      row_pass_wide(p, w_s, y_s, r_s, x_s, red, cta, row0, my_rows, it == 1, train);
    if (!train) break;
    // the JAX loop's f32 arithmetic operation for operation (no FMA
    // contraction): η = step/√it, w·(1 − η·λ) − (η·g)/max(count, 1)
    const float eta = __fdiv_rn(p.step_size, __fsqrt_rn((float)it));
    const float scale = __fsub_rn(1.f, __fmul_rn(eta, p.l2_reg));
    grid.sync();

    // ---- update of this CTA's columns, 8 at a time: lane & 7 takes column
    // f0 + (lane & 7), and the warps read partial rows 4·warp + (lane >> 3)
    // + 48j, so a load instruction covers 4 partial rows × 8 adjacent
    // columns (whole 32-byte sectors); sums in a fixed order
    float d = 0.f, n = 0.f;  // in lanes 0-7 of warp 0
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
        const float wo = w_s[f];
        const float wn = __fsub_rn(__fmul_rn(wo, scale), __fdiv_rn(__fmul_rn(eta, gs), denom));
        const float dw = __fsub_rn(wn, wo);
        d = fmaf(dw, dw, d);
        n = fmaf(wn, wn, n);
        p.wbuf[f] = wn;
        if (f < features) p.w_out[f] = wn;
      }
      __syncthreads();
    }
    if (warp == 0) {
      d = warp_sum(d);
      n = warp_sum(n);
      if (lane == 0) {
        p.norm_part[2 * cta] = d;
        p.norm_part[2 * cta + 1] = n;
      }
    }
    grid.sync();

    // ---- every CTA: the new w, and the same converged decision
    for (int f = threadIdx.x - 32; warp > 0 && f < fpad; f += kThreads - 32)
      w_s[f] = __ldcg(p.wbuf + f);
    if (warp == 0) {
      float ds = 0.f, ns = 0.f;
      for (int c = lane; c < ncta; c += 32) {
        ds += __ldcg(p.norm_part + 2 * c);
        ns += __ldcg(p.norm_part + 2 * c + 1);
      }
      ds = warp_sum(ds);
      ns = warp_sum(ns);
      if (lane == 0)
        scratch[kConvergedSlot] =
            (p.tol > 0.f && sqrtf(ds) < p.tol * fmaxf(sqrtf(ns), 1.f)) ? 1.f : 0.f;
    }
    __syncthreads();
    if (scratch[kConvergedSlot] != 0.f || it >= p.num_iterations) break;
  }
  if (cta == 0 && threadIdx.x == 0) *p.iterations = train ? (float)it : 0.f;
}

}  // namespace

// Once a device, before its first launch: the SM count and the opt-in
// shared memory a block may use on `device` (for the launch plan), and the
// kernel's dynamic shared-memory limit raised to that opt-in there, so that
// a launch makes no set-up call of its own. Returns a CUDA error code, 0 on
// success.
extern "C" int twtml_fused_sgd_setup(int device, int* sm_count, int* shared_optin) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(shared_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_sgd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *shared_optin);
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
// row_groups() here is refused. Returns the CUDA error of the launch (a
// refused cooperative launch included), 0 when it was taken.
extern "C" int twtml_fused_dense_sgd(
    const void* x, const void* labels, const void* mask, const void* w0, void* w_out,
    void* preds, void* spill, void* scratch, int rows, int features, int fpad, int grid,
    int rows_cap, int resident, int spill_per_cta, int shared_bytes, const int* plan_layout,
    int num_iterations, float step_size, float l2_reg, float tol, void* stream) {
  const Layout lay = layout(fpad, rows_cap);
  const int stride = row_groups(fpad);
  if (rows < 1 || features < 1 || fpad % 8 != 0 || features > fpad || grid < 1 ||
      (long long)rows_cap * grid < rows || resident < 0 || resident > rows_cap ||
      spill_per_cta != rows_cap - resident || num_iterations < 0 ||
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
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_sgd_kernel),
                                          dim3(grid), dim3(kThreads), args,
                                          (size_t)shared_bytes, static_cast<cudaStream_t>(stream));
}
