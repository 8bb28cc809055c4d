// The sparse regime's Gram route for Hopper (sm_90a): three kernels.
//
// They replace XLA fusions of the JAX package, not TPU kernels (no
// function of twtml_tpu/ops/gram.py or twtml_tpu/models/sgd.py reaches
// pl.pallas_call). Per micro-batch of B rows, F = 2^18 hashed text features
// and N iterations, the route is
//   B4 count build:  C [B, F] = the rows' (idx, val) pairs summed per feature
//                    (twtml_tpu/ops/gram.py onehot_counts_int8 / onehot_counts
//                    / densify_text);
//   the G product:   G = C·Cᵀ (+ N·Nᵀ), a library GEMM outside these kernels
//                    (torch._int_mm in the int8 plane, an f32 matmul else);
//   B7 dual loop:    MLlib's N iterations on the dual state {c, α}
//                    (twtml_tpu/models/sgd.py run_dual_loop over
//                    sgd_inner_loop, with gram.py dual_norm_sq);
//   B8 write-back:   W_new = c·W_prev + Zᵀα (twtml_tpu/ops/gram.py
//                    dual_writeback).
// No kernel uses float atomics: every sum has a fixed order, and reruns
// on one card are bitwise equal.
//
// ---- B4, count_build_kernel<T> (T = int8_t for the int8 plane, float else)
// What bounds it on an H100: bytes. It writes every byte of C once, zeros
// included (512 MiB of int8 at B = 2048, F = 2^18: 0.16 ms at 3.35 TB/s);
// the [B, L] tokens it reads are ~1/1000 of that. Design: one CTA a row of
// C. The CTA zero-fills its row with 16-byte stores, stages the row's L
// (idx, val) pairs in shared memory and, after a barrier (which orders the
// zero-fill before what follows), each thread takes tokens j: if no k < j
// holds the same index, it sums val over every k >= j with that index in
// token order and writes the count once. No atomics, no separate memset.
// The token scan is O(L²) a row in shared memory (L <= ~300 for a tweet).
//
// ---- B7, dual_sgd_kernel<kLogistic>
// Each iteration is one [B, B]·[B] product (G·α) plus elementwise work on
// [B] vectors; the convergence test reads Δαᵀ·G·Δα, which this kernel takes
// from a second product (G·Δα) and four dot products. The function needs
// only the one product (G·Δα = G·α_new − G·α_old), so its bound counts
// 2·B² flops an iteration. What bounds it: neither bytes nor operations of
// the arithmetic (8.4 MFLOP an iteration at B = 2048), but latency:
// grid-wide barriers and reading G each iteration. Design, B1's pattern
// (csrc/fused_sgd.cu): one persistent cooperative launch a batch, at most
// one CTA an SM; CTA c owns rows [c·B/grid, (c+1)·B/grid) of G and keeps
// them in shared memory as f32 (16 MiB at B = 2048: ~124 KB a CTA over 132
// SMs); rows that do not fit (B = 3072, 4096) are staged once into a spill
// buffer and read through L2. α, Δα and the validity mask of the whole
// batch, and u, y and G·α of the CTA's rows, live in shared memory. An
// iteration: each CTA updates α on its rows (r = residual(c·u + G·α, y)·sel;
// α <- α·(1 − ηλ) − (η·r)/max(count, 1)) into a global double buffer;
// grid barrier; every CTA reads the new α and Δα and computes G·α and
// G·Δα for its rows (a warp a row, lanes over float4 columns, a shuffle
// sum) and the CTA's partials of Δαᵀ·G·Δα, αᵀ·G·α, u·Δα and u·α; grid
// barrier; every CTA sums the partials in the same order and takes the
// same converged decision (MLlib's test through dual_norm_sq), so the grid
// leaves the loop together. With tolerance 0 the second barrier goes; the
// last iteration needs no product. count is Σ mask·masks[i] over the whole
// batch, the same bits in every CTA; an iteration with count 0 makes no
// update and is not convergence. Rows with mask <= 0 are zeroed where they
// are staged (their u and y, their rows and columns of G), so NaN/Inf
// there is ignored. The update and the step scalars use the JAX loop's f32
// operations without contraction; the products sum in another order than
// torch's, so the twin holds B7 within tolerance.
//
// ---- B8, writeback_kernel<T>
// What bounds it: bytes, one read of C (B·F bytes in the int8 plane). Design:
// a block owns 128 text columns: 32 column groups of 4 (a warp reads 128
// contiguous bytes of a row of int8 C) by 8 row segments; each thread sums
// count·α over its segment's rows in row order, the 8 segments are summed
// in order in shared memory, and w = c·w_prev + Σ. The last block computes
// the 4 numeric columns, w_num·c + Nᵀα, in a fixed-order block reduction.
// It sums count·α where the JAX scatter adds val·α per occurrence, so the
// twin holds it within tolerance.
//
// What Hopper offers and these designs leave out: tensor cores and TMA.
// B4 and B8 stream bytes; B7's products are matrix × vector (N = 1) and
// keep f32 operands as the twin does. The G product itself runs on the
// tensor cores (cuBLASLt's int8 GEMM behind torch._int_mm).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCountThreads = 256;
constexpr int kDualThreads = 256;
constexpr int kDualWarps = kDualThreads / 32;
constexpr int kDualRedFloats = 64;
constexpr int kRedFlag = 48;  // the converged flag's slot in the scratch
constexpr int kWbThreads = 256;
constexpr int kWbGroups = 32;                // 4-column groups a block
constexpr int kWbSegments = kWbThreads / kWbGroups;  // row segments a block
constexpr int kWbCols = 4 * kWbGroups;       // 128 text columns a block

// ops/fused_gram.py sizes the launches from its own copy of these
// constants; ops/_build.py passes that copy as -D flags, so the two cannot
// drift apart without the build failing here.
#if !defined(TWTML_GRAM_COUNT_THREADS) || !defined(TWTML_GRAM_DUAL_THREADS) || \
    !defined(TWTML_GRAM_DUAL_RED_FLOATS) || !defined(TWTML_GRAM_WRITEBACK_THREADS) || \
    !defined(TWTML_GRAM_WRITEBACK_COLUMNS)
#error "build through twtml_tpu_torch/ops/_build.py, which passes the launch plan's constants"
#endif
static_assert(kCountThreads == TWTML_GRAM_COUNT_THREADS, "COUNT_THREADS differs");
static_assert(kDualThreads == TWTML_GRAM_DUAL_THREADS, "DUAL_THREADS differs");
static_assert(kDualRedFloats == TWTML_GRAM_DUAL_RED_FLOATS, "DUAL_RED_FLOATS differs");
static_assert(kWbThreads == TWTML_GRAM_WRITEBACK_THREADS, "WRITEBACK_THREADS differs");
static_assert(kWbCols == TWTML_GRAM_WRITEBACK_COLUMNS, "WRITEBACK_COLUMNS differs");

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;  // the same bits in every lane
}

// ------------------------------------------------------------------ B4

template <typename T>
__device__ __forceinline__ T to_count(float s);
template <>
__device__ __forceinline__ int8_t to_count<int8_t>(float s) {
  return (int8_t)__float2int_rz(s);  // an integer in [-127, 127] by the plane's gate
}
template <>
__device__ __forceinline__ float to_count<float>(float s) {
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kCountThreads) count_build_kernel(
    const int* __restrict__ idx, const float* __restrict__ val, int rows, int tokens,
    int features, T* __restrict__ out, int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_idx = reinterpret_cast<int*>(smem);
  float* s_val = reinterpret_cast<float*>(smem + align16((size_t)tokens * 4));
  const int b = blockIdx.x;
  T* row = out + (size_t)b * cols;
  uint4* row4 = reinterpret_cast<uint4*>(row);
  const int n4 = (int)((size_t)cols * sizeof(T) / 16);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < n4; i += kCountThreads) row4[i] = zero;
  if (b >= rows) return;  // a padding row: zeros only (uniform across the CTA)
  const int* ri = idx + (size_t)b * tokens;
  const float* rv = val + (size_t)b * tokens;
  for (int j = threadIdx.x; j < tokens; j += kCountThreads) {
    s_idx[j] = __ldg(ri + j);
    s_val[j] = __ldg(rv + j);
  }
  __syncthreads();  // the tokens staged, and the zero-fill ordered before the writes below
  for (int j = threadIdx.x; j < tokens; j += kCountThreads) {
    const int f = s_idx[j];
    if (f < 0 || f >= features) continue;
    bool first = true;
    for (int k = 0; k < j; ++k) {
      if (s_idx[k] == f) {
        first = false;
        break;
      }
    }
    if (!first) continue;
    float s = s_val[j];
    for (int k = j + 1; k < tokens; ++k)
      if (s_idx[k] == f) s = __fadd_rn(s, s_val[k]);
    row[f] = to_count<T>(s);
  }
}

// ------------------------------------------------------------------ B7

struct DualParams {
  const float* g;        // [>= rows, ldg] f32
  long long ldg;
  const float* u;        // [rows] f32: Z·W_prev
  const float* y;        // [rows] f32
  const float* mask;     // [rows] f32: validity
  const float* masks;    // [iterations, rows] f32 Bernoulli draws, or null
  const float* p_prev;   // [1] f32: ||W_prev||²
  float* alpha_out;      // [rows] f32
  float* abuf;           // [2][2][bp] f32: α and Δα, double-buffered by update
  float* partials;       // [grid][4] f32
  float* c_out;          // [1]
  float* iterations;     // [1]: the iteration that converged, else N
  float* spill;          // [grid][spill_per_cta][bp] f32
  int rows, bp, rows_cap, resident, spill_per_cta, num_iterations;
  float step_size, l2_reg, tol;
};

// Byte offsets of the dynamic shared memory, each 16-byte aligned: α [bp]
// at 0, Δα [bp], the mask [bp], u, y and G·α [rows_cap] of the CTA's rows,
// the reduction scratch, then the resident rows of G [bp] f32 each. The
// launch plan (ops/fused_gram.py dual_plan) computes the same.
struct DualLayout {
  size_t dalpha, mask, u, y, s, red, g;
};

__host__ __device__ inline DualLayout dual_layout(int bp, int rows_cap) {
  DualLayout l;
  const size_t vec = align16((size_t)bp * 4), own = align16((size_t)rows_cap * 4);
  l.dalpha = vec;
  l.mask = 2 * vec;
  l.u = 3 * vec;
  l.y = l.u + own;
  l.s = l.y + own;
  l.red = l.s + own;
  l.g = l.red + kDualRedFloats * 4;
  return l;
}

// Σ of every thread's v in a fixed order: the same bits in every thread
// (and in every CTA, for the same inputs). red[0..kDualWarps) is its scratch.
__device__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kDualWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

template <bool kLogistic>
__device__ __forceinline__ float dual_residual(float raw, float y) {
  if constexpr (kLogistic) {
    return __fsub_rn(1.f / (1.f + expf(-raw)), y);
  } else {
    return __fsub_rn(raw, y);
  }
}

template <bool kLogistic>
__global__ void __launch_bounds__(kDualThreads, 1) dual_sgd_kernel(const DualParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DualLayout lay = dual_layout(p.bp, p.rows_cap);
  float* alpha_s = reinterpret_cast<float*>(smem);
  float* dalpha_s = reinterpret_cast<float*>(smem + lay.dalpha);
  float* mask_s = reinterpret_cast<float*>(smem + lay.mask);
  float* u_s = reinterpret_cast<float*>(smem + lay.u);
  float* y_s = reinterpret_cast<float*>(smem + lay.y);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* g_s = reinterpret_cast<float*>(smem + lay.g);

  cg::grid_group grid = cg::this_grid();
  const int cta = blockIdx.x, ncta = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = p.rows, bp = p.bp, nvec = bp / 4;
  const int row0 = (int)((long long)cta * rows / ncta);
  const int my_rows = (int)((long long)(cta + 1) * rows / ncta) - row0;

  // ---- prologue: the batch's mask, the CTA's u, y and rows of G, once
  for (int k = tid; k < bp; k += kDualThreads) {
    alpha_s[k] = 0.f;
    dalpha_s[k] = 0.f;
    mask_s[k] = k < rows ? __ldg(p.mask + k) : 0.f;
  }
  __syncthreads();
  for (int l = tid; l < my_rows; l += kDualThreads) {
    const bool keep = mask_s[row0 + l] > 0.f;
    u_s[l] = keep ? __ldg(p.u + row0 + l) : 0.f;
    y_s[l] = keep ? __ldg(p.y + row0 + l) : 0.f;
    s_s[l] = 0.f;  // G·α with α = 0
  }
  for (int l = warp; l < my_rows; l += kDualWarps) {
    const int r = row0 + l;
    const bool keep = mask_s[r] > 0.f;
    float* dst = l < p.resident
                     ? g_s + (size_t)l * bp
                     : p.spill + ((size_t)cta * p.spill_per_cta + (l - p.resident)) * bp;
    const float* src = p.g + (size_t)r * p.ldg;
    for (int k = lane; k < bp; k += 32)
      dst[k] = keep && mask_s[k] > 0.f ? __ldg(src + k) : 0.f;  // mask_s is 0 past rows
  }
  float count_all;
  {
    float v = 0.f;
    for (int k = tid; k < rows; k += kDualThreads) v += mask_s[k];
    count_all = block_sum(v, red);  // also orders the staging above before the loop
  }
  const float pp = __ldg(p.p_prev);

  float c = 1.f;
  int ran = p.num_iterations;
  int updates = 0;
  bool final_in_smem = true;  // else the last update wrote alpha_out itself
  for (int it = 1; it <= p.num_iterations; ++it) {
    const float* draw = p.masks ? p.masks + (size_t)(it - 1) * rows : nullptr;
    float count = count_all;
    if (draw) {
      float v = 0.f;
      for (int k = tid; k < rows; k += kDualThreads) v += mask_s[k] * __ldg(draw + k);
      count = block_sum(v, red);
    }
    if (!(count > 0.f)) continue;  // no sampled row: no update, and not convergence
    // the JAX loop's f32 arithmetic, operation for operation
    const float eta = __fdiv_rn(p.step_size, __fsqrt_rn((float)it));
    const float scale = __fsub_rn(1.f, __fmul_rn(eta, p.l2_reg));
    const float denom = fmaxf(count, 1.f);
    const bool last = it == p.num_iterations;
    float* a_buf = p.abuf + (size_t)(updates & 1) * 2 * bp;
    float* d_buf = a_buf + bp;
    ++updates;
    for (int l = tid; l < my_rows; l += kDualThreads) {
      const int r = row0 + l;
      const float sel = draw ? mask_s[r] * __ldg(draw + r) : mask_s[r];
      float res = 0.f;
      if (mask_s[r] > 0.f) {
        const float raw = __fadd_rn(__fmul_rn(c, u_s[l]), s_s[l]);
        res = __fmul_rn(dual_residual<kLogistic>(raw, y_s[l]), sel);
      }
      const float a_old = alpha_s[r];
      const float a_new =
          __fsub_rn(__fmul_rn(a_old, scale), __fdiv_rn(__fmul_rn(eta, res), denom));
      if (last) {
        p.alpha_out[r] = a_new;
      } else {
        a_buf[r] = a_new;
        d_buf[r] = __fsub_rn(a_new, a_old);
      }
    }
    const float c_new = __fmul_rn(c, scale);  // c·(1 − ηλ) − η·0/denom
    if (last) {  // nothing reads G·α after the last update
      c = c_new;
      final_in_smem = false;
      break;
    }
    grid.sync();
    for (int k = tid; k < rows; k += kDualThreads) {
      alpha_s[k] = __ldcg(a_buf + k);
      dalpha_s[k] = __ldcg(d_buf + k);
    }
    __syncthreads();
    // ---- G·α and G·Δα of the CTA's rows, a warp a row
    const bool test = p.tol > 0.f;
    float qd = 0.f, qa = 0.f, ud = 0.f, ua = 0.f;  // lane 0's partials
    for (int l = warp; l < my_rows; l += kDualWarps) {
      const bool resident = l < p.resident;
      const float4* gr = reinterpret_cast<const float4*>(
          resident ? g_s + (size_t)l * bp
                   : p.spill + ((size_t)cta * p.spill_per_cta + (l - p.resident)) * bp);
      const float4* a4 = reinterpret_cast<const float4*>(alpha_s);
      const float4* d4 = reinterpret_cast<const float4*>(dalpha_s);
      float s = 0.f, t = 0.f;
      for (int v = lane; v < nvec; v += 32) {
        const float4 gv = resident ? gr[v] : __ldcg(gr + v);
        const float4 av = a4[v];
        s = fmaf(gv.x, av.x, s);
        s = fmaf(gv.y, av.y, s);
        s = fmaf(gv.z, av.z, s);
        s = fmaf(gv.w, av.w, s);
        if (test) {
          const float4 dv = d4[v];
          t = fmaf(gv.x, dv.x, t);
          t = fmaf(gv.y, dv.y, t);
          t = fmaf(gv.z, dv.z, t);
          t = fmaf(gv.w, dv.w, t);
        }
      }
      s = warp_sum(s);
      if (test) t = warp_sum(t);
      if (lane == 0) {
        const int r = row0 + l;
        s_s[l] = s;
        qd = fmaf(dalpha_s[r], t, qd);
        qa = fmaf(alpha_s[r], s, qa);
        ud = fmaf(u_s[l], dalpha_s[r], ud);
        ua = fmaf(u_s[l], alpha_s[r], ua);
      }
    }
    const float c_prev = c;
    c = c_new;
    if (test) {
      if (lane == 0) {
        red[16 + 4 * warp] = qd;
        red[17 + 4 * warp] = qa;
        red[18 + 4 * warp] = ud;
        red[19 + 4 * warp] = ua;
      }
      __syncthreads();
      if (tid < 4) {
        float v = 0.f;
        for (int w = 0; w < kDualWarps; ++w) v += red[16 + 4 * w + tid];
        p.partials[4 * cta + tid] = v;
      }
      grid.sync();
      if (warp == 0) {
        float q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = 0.f;
          for (int k = lane; k < ncta; k += 32) v += __ldcg(p.partials + 4 * k + j);
          q[j] = warp_sum(v);
        }
        if (lane == 0) {
          // dual_norm_sq: Δc²·p + 2·Δc·(u·Δα) + Δαᵀ·G·Δα, and the same of the new state
          const float dc = c - c_prev;
          const float d2 = dc * dc * pp + 2.f * dc * q[2] + q[0];
          const float n2 = c * c * pp + 2.f * c * q[3] + q[1];
          red[kRedFlag] = sqrtf(d2) < p.tol * fmaxf(sqrtf(n2), 1.f) ? 1.f : 0.f;
        }
      }
      __syncthreads();
      if (red[kRedFlag] != 0.f) {
        ran = it;
        break;
      }
    } else {
      __syncthreads();  // s_s written before the next update reads it
    }
  }
  if (final_in_smem)
    for (int l = tid; l < my_rows; l += kDualThreads) p.alpha_out[row0 + l] = alpha_s[row0 + l];
  if (cta == 0 && tid == 0) {
    *p.c_out = c;
    *p.iterations = (float)ran;
  }
}

// ------------------------------------------------------------------ B8

template <typename T>
struct Vec4;
template <>
struct Vec4<int8_t> {
  static __device__ __forceinline__ float4 load(const int8_t* p) {
    const char4 v = __ldg(reinterpret_cast<const char4*>(p));
    return make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
  }
};
template <>
struct Vec4<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
};

template <typename T>
__global__ void __launch_bounds__(kWbThreads) writeback_kernel(
    const T* __restrict__ counts, int rows, int cols, int features,
    const float* __restrict__ alpha, const float* __restrict__ c_ptr,
    const float* __restrict__ w_prev, const float* __restrict__ numeric,
    float* __restrict__ w_out) {
  __shared__ float part[kWbSegments][kWbCols];
  const float c = __ldg(c_ptr);
  const int tid = threadIdx.x;
  if (blockIdx.x == gridDim.x - 1) {  // the 4 numeric columns: w_num·c + Nᵀα
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int b = tid; b < rows; b += kWbThreads) {
      const float a = __ldg(alpha + b);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(__ldg(numeric + 4 * (size_t)b + j), a, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = warp_sum(acc[j]);
    if ((tid & 31) == 0)
      for (int j = 0; j < 4; ++j) part[j][tid >> 5] = acc[j];
    __syncthreads();
    if (tid < 4) {
      float s = 0.f;
      for (int w = 0; w < kWbThreads / 32; ++w) s += part[tid][w];
      w_out[features + tid] = __fadd_rn(__fmul_rn(__ldg(w_prev + features + tid), c), s);
    }
    return;
  }
  const int group = tid % kWbGroups, seg = tid / kWbGroups;
  const int col0 = blockIdx.x * kWbCols + 4 * group;
  const int b0 = (int)((long long)seg * rows / kWbSegments);
  const int b1 = (int)((long long)(seg + 1) * rows / kWbSegments);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (col0 < cols) {  // cols is a multiple of 16: the 4 columns are inside
    const T* src = counts + col0;
#pragma unroll 8
    for (int b = b0; b < b1; ++b) {
      const float a = __ldg(alpha + b);
      const float4 v = Vec4<T>::load(src + (size_t)b * cols);
      acc[0] = fmaf(v.x, a, acc[0]);
      acc[1] = fmaf(v.y, a, acc[1]);
      acc[2] = fmaf(v.z, a, acc[2]);
      acc[3] = fmaf(v.w, a, acc[3]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) part[seg][4 * group + e] = acc[e];
  __syncthreads();
  if (tid < kWbCols) {
    const int f = blockIdx.x * kWbCols + tid;
    if (f < features) {
      float s = part[0][tid];
#pragma unroll
      for (int k = 1; k < kWbSegments; ++k) s += part[k][tid];
      w_out[f] = __fadd_rn(__fmul_rn(__ldg(w_prev + f), c), s);
    }
  }
}

}  // namespace

// Once a device, before its first launch: the SM count and the opt-in
// shared memory a block may use on `device`, and the dynamic shared-memory
// limit of the count build and of both dual-loop modes raised to that
// opt-in there. Returns a CUDA error code, 0 on success.
extern "C" int twtml_gram_setup(int device, int* sm_count, int* shared_optin) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(shared_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const void* kernels[] = {
      reinterpret_cast<const void*>(count_build_kernel<int8_t>),
      reinterpret_cast<const void*>(count_build_kernel<float>),
      reinterpret_cast<const void*>(dual_sgd_kernel<false>),
      reinterpret_cast<const void*>(dual_sgd_kernel<true>),
  };
  for (const void* k : kernels)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, *shared_optin);
  const cudaError_t restored = cudaSetDevice(current);
  return (int)(err != cudaSuccess ? err : restored);
}

// B4: idx [rows, tokens] int32 and val [rows, tokens] f32 (device, contiguous)
// -> out [rows_out, cols] (kind 0: int8, 1: f32), cols a multiple of 16,
// rows_out >= rows; shared_bytes = 2·align16(4·tokens). Returns the launch's
// CUDA error, 0 when it was taken.
extern "C" int twtml_count_build(const void* idx, const void* val, void* out, int rows,
                                 int tokens, int features, int rows_out, int cols, int kind,
                                 int shared_bytes, void* stream) {
  if (rows < 1 || tokens < 1 || features < 1 || rows_out < rows || cols < features ||
      cols % 16 != 0 || (kind != 0 && kind != 1) ||
      (size_t)shared_bytes != 2 * align16((size_t)tokens * 4))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    count_build_kernel<int8_t><<<rows_out, kCountThreads, shared_bytes, s>>>(
        static_cast<const int*>(idx), static_cast<const float*>(val), rows, tokens, features,
        static_cast<int8_t*>(out), cols);
  else
    count_build_kernel<float><<<rows_out, kCountThreads, shared_bytes, s>>>(
        static_cast<const int*>(idx), static_cast<const float*>(val), rows, tokens, features,
        static_cast<float*>(out), cols);
  return (int)cudaGetLastError();
}

// B7: the whole dual loop for one batch, one cooperative launch on `stream`
// (the current device's, set up by twtml_gram_setup). g [>= rows, ldg] f32;
// u, y, mask [rows] f32; masks [iterations, rows] f32 or null; p_prev [1]
// f32; alpha_out [rows] f32; scratch [4·bp + 4·grid + 2] f32 (its last two
// floats receive c and the iterations run); spill [grid·spill_per_cta·bp]
// f32. The plan's values and `plan_layout` (host memory: dual_layout()'s
// offsets of Δα, the mask, u, y, G·α, the scratch and the resident rows)
// come from ops/fused_gram.py dual_plan; a plan that differs is refused.
// `residual_mode` 0 least squares, 1 logistic. Returns the launch's CUDA
// error (a refused cooperative launch included), 0 when it was taken.
extern "C" int twtml_dual_sgd(const void* g, long long ldg, const void* u, const void* y,
                              const void* mask, const void* masks, const void* p_prev,
                              void* alpha_out, void* scratch, void* spill, int rows, int bp,
                              int grid, int rows_cap, int resident, int spill_per_cta,
                              int shared_bytes, const int* plan_layout, int num_iterations,
                              float step_size, float l2_reg, float tol, int residual_mode,
                              void* stream) {
  const DualLayout lay = dual_layout(bp, rows_cap);
  if (rows < 1 || ldg < rows || bp < rows || bp % 4 != 0 || grid < 1 ||
      (long long)rows_cap * grid < rows || resident < 0 || resident > rows_cap ||
      spill_per_cta != rows_cap - resident || num_iterations < 0 ||
      (residual_mode != 0 && residual_mode != 1) || (size_t)plan_layout[0] != lay.dalpha ||
      (size_t)plan_layout[1] != lay.mask || (size_t)plan_layout[2] != lay.u ||
      (size_t)plan_layout[3] != lay.y || (size_t)plan_layout[4] != lay.s ||
      (size_t)plan_layout[5] != lay.red || (size_t)plan_layout[6] != lay.g ||
      (size_t)shared_bytes < lay.g + (size_t)resident * bp * 4)
    return (int)cudaErrorInvalidValue;
  DualParams p;
  p.g = static_cast<const float*>(g);
  p.ldg = ldg;
  p.u = static_cast<const float*>(u);
  p.y = static_cast<const float*>(y);
  p.mask = static_cast<const float*>(mask);
  p.masks = static_cast<const float*>(masks);
  p.p_prev = static_cast<const float*>(p_prev);
  p.alpha_out = static_cast<float*>(alpha_out);
  p.abuf = static_cast<float*>(scratch);
  p.partials = p.abuf + 4 * (size_t)bp;
  p.c_out = p.partials + 4 * (size_t)grid;
  p.iterations = p.c_out + 1;
  p.spill = static_cast<float*>(spill);
  p.rows = rows;
  p.bp = bp;
  p.rows_cap = rows_cap;
  p.resident = resident;
  p.spill_per_cta = spill_per_cta;
  p.num_iterations = num_iterations;
  p.step_size = step_size;
  p.l2_reg = l2_reg;
  p.tol = tol;
  void* args[] = {&p};
  const void* kernel = residual_mode == 1 ? reinterpret_cast<const void*>(dual_sgd_kernel<true>)
                                          : reinterpret_cast<const void*>(dual_sgd_kernel<false>);
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kDualThreads), args,
                                          (size_t)shared_bytes,
                                          static_cast<cudaStream_t>(stream));
}

// B8: counts [>= rows, cols] (kind 0: int8, 1: f32; cols a multiple of 16),
// alpha [rows], c [1], w_prev [features + 4], numeric [rows, 4] (f32, device,
// contiguous) -> w_out [features + 4]. Returns the launch's CUDA error.
extern "C" int twtml_dual_writeback(const void* counts, int kind, int rows, int cols,
                                    int features, const void* alpha, const void* c,
                                    const void* w_prev, const void* numeric, void* w_out,
                                    void* stream) {
  if (rows < 1 || cols < features || cols % 16 != 0 || features < 1 || (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  const int blocks = (features + kWbCols - 1) / kWbCols + 1;  // + the numeric block
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  const float* cp = static_cast<const float*>(c);
  const float* wp = static_cast<const float*>(w_prev);
  const float* num = static_cast<const float*>(numeric);
  float* wo = static_cast<float*>(w_out);
  if (kind == 0)
    writeback_kernel<int8_t><<<blocks, kWbThreads, 0, s>>>(
        static_cast<const int8_t*>(counts), rows, cols, features, a, cp, wp, num, wo);
  else
    writeback_kernel<float><<<blocks, kWbThreads, 0, s>>>(
        static_cast<const float*>(counts), rows, cols, features, a, cp, wp, num, wo);
  return (int)cudaGetLastError();
}
