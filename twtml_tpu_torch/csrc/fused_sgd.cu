// Fused predict-then-train dense SGD for Hopper (sm_90a).
//
// Replaces twtml_tpu/ops/pallas_sgd.py::_sgd_kernel, the TPU kernel that
// runs MLlib's GradientDescent loop on a [B, F] design matrix held in VMEM:
//   preds = X·w0; then for it = 1..N:
//     r = X·w − y;  g = Xᵀr / max(count, 1);  η = stepSize/√it;
//     w ← w·(1 − η·λ) − η·g   (skipped when count == 0);
//     frozen from the next iteration once ‖Δw‖ < tol·max(‖w‖, 1).
//
// What bounds it on an H100: bytes. Each iteration reads X twice (X·w, then
// Xᵀr) and does 2 flops per element read; X is stored in bf16 (the bigram
// counts are small integers, exact in bf16), so at the operating point
// (16384 × 1004) X is 32.9 MB and fits the 50 MB L2. Every sum, w, r and g
// stay in f32: no per-product rounding of w or r as on the TPU.
//
// Design (the first, simple one): three launches per iteration on the
// caller's stream, with all state (w, count, the converged flag) on the
// device, so a batch needs no host sync.
//   1. matvec_kernel: one warp per row, 16-byte loads of 8 bf16 along the
//      row, warp-shuffle sum in a fixed order: r = X·w − y (preds = X·w0 in
//      the one launch before the loop).
//   2. xtr_partial_kernel: Xᵀr straight from row-major X (no Xᵀ copy).
//      A block owns a chunk of rows and every column; a thread owns 8
//      adjacent columns, so a warp's loads along a row stay coalesced. Two
//      row groups per block combine in shared memory; the block writes one
//      row of per-chunk partial sums.
//   3. update_kernel: one block reduces the partials in chunk order, updates
//      w, reduces ‖Δw‖² and ‖w‖² in a fixed tree and sets the flag. Later
//      launches read the flag and return at once.
// No float atomics anywhere: reruns are bitwise equal. Launches per call:
// 1 + 3·N. Row-major X, padded to a multiple of 8 columns by the caller, is
// the only layout taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMatvecThreads = 256;  // 8 warps, one row each
constexpr int kGradThreads = 256;    // kGradGroups row groups of kGradLanes
constexpr int kGradLanes = 128;
constexpr int kGradGroups = kGradThreads / kGradLanes;
constexpr int kUpdateThreads = 1024;

__device__ __forceinline__ void unpack_bf16x8(const uint4 packed, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&packed);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

// out[row] = X[row]·w − y[row], or X[row]·w when y is null.
__global__ void __launch_bounds__(kMatvecThreads)
matvec_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ y, float* __restrict__ out,
              const int* __restrict__ converged, int rows, int nvec) {
  if (converged != nullptr && *converged) return;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kMatvecThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * nvec * 8);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float acc = 0.f;
#pragma unroll 4
  for (int v = lane; v < nvec; v += 32) {
    float xf[8];
    unpack_bf16x8(__ldg(xr + v), xf);
    const float4 wa = __ldg(w4 + 2 * v);
    const float4 wb = __ldg(w4 + 2 * v + 1);
    acc = fmaf(xf[0], wa.x, acc);
    acc = fmaf(xf[1], wa.y, acc);
    acc = fmaf(xf[2], wa.z, acc);
    acc = fmaf(xf[3], wa.w, acc);
    acc = fmaf(xf[4], wb.x, acc);
    acc = fmaf(xf[5], wb.y, acc);
    acc = fmaf(xf[6], wb.z, acc);
    acc = fmaf(xf[7], wb.w, acc);
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, offset);
  if (lane == 0) out[row] = (y != nullptr) ? acc - y[row] : acc;
}

// partials[chunk][f] = Σ_{row in chunk} r[row]·X[row][f]
__global__ void __launch_bounds__(kGradThreads)
xtr_partial_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ r, float* __restrict__ partials,
                   const int* __restrict__ converged, int rows, int nvec,
                   int rows_per_chunk) {
  if (*converged) return;
  __shared__ float stage[kGradGroups - 1][8][kGradLanes];
  const int lane = threadIdx.x % kGradLanes;
  const int group = threadIdx.x / kGradLanes;
  const int chunk = blockIdx.x;
  const int row0 = chunk * rows_per_chunk;
  const int row1 = min(row0 + rows_per_chunk, rows);
  const size_t fpad = (size_t)nvec * 8;
  for (int v0 = 0; v0 < nvec; v0 += kGradLanes) {  // block-uniform loop
    const int v = v0 + lane;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (v < nvec) {
#pragma unroll 4
      for (int row = row0 + group; row < row1; row += kGradGroups) {
        const float rv = __ldg(r + row);
        float xf[8];
        unpack_bf16x8(__ldg(reinterpret_cast<const uint4*>(x + row * fpad) + v), xf);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = fmaf(rv, xf[k], acc[k]);
      }
    }
    if (group > 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) stage[group - 1][k][lane] = acc[k];
    }
    __syncthreads();
    if (group == 0 && v < nvec) {
      for (int g = 0; g < kGradGroups - 1; ++g) {
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] += stage[g][k][lane];
      }
      float4* dst = reinterpret_cast<float4*>(partials + chunk * fpad + (size_t)v * 8);
      dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = (lane < (int)(blockDim.x >> 5)) ? scratch[lane] : 0.f;
  if (warp == 0) {
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;  // valid in warp 0
}

// One block: g = Σ_chunk partials, w update, convergence test.
__global__ void __launch_bounds__(kUpdateThreads)
update_kernel(const float* __restrict__ partials, int num_chunks,
              const float* __restrict__ count_ptr, float* __restrict__ w,
              int* __restrict__ converged, int features, int fpad, int it,
              float step_size, float l2_reg, float tol) {
  __shared__ float scratch_d[32];
  __shared__ float scratch_n[32];
  if (*converged) return;  // block-uniform: read before any write below
  const float count = *count_ptr;
  const float denom = fmaxf(count, 1.f);
  // the JAX loop's f32 arithmetic, operation for operation (no FMA
  // contraction): η = step/√it, w·(1 − η·λ) − (η·g)/denom
  const float eta = __fdiv_rn(step_size, __fsqrt_rn((float)it));
  const float scale = __fsub_rn(1.f, __fmul_rn(eta, l2_reg));
  float d = 0.f, n = 0.f;
  for (int f = threadIdx.x; f < features; f += blockDim.x) {
    float g = 0.f;
    for (int c = 0; c < num_chunks; ++c) g += partials[(size_t)c * fpad + f];
    const float wo = w[f];
    float wn = __fsub_rn(__fmul_rn(wo, scale), __fdiv_rn(__fmul_rn(eta, g), denom));
    if (!(count > 0.f)) wn = wo;  // zero-sample iteration: no update
    const float dw = wn - wo;
    d = fmaf(dw, dw, d);
    n = fmaf(wn, wn, n);
    w[f] = wn;
  }
  d = block_sum(d, scratch_d);
  n = block_sum(n, scratch_n);
  if (threadIdx.x == 0 && tol > 0.f && count > 0.f &&
      sqrtf(d) < tol * fmaxf(sqrtf(n), 1.f))
    *converged = 1;
}

}  // namespace

// The whole loop for one batch. Pointers are device pointers on `stream`:
//   x [rows, fpad] bf16 (masked rows zeroed), y [rows] f32 (masked to 0),
//   count [1] f32, w [fpad] f32 (w0 in, new weights out), preds [rows] f32,
//   residual [rows] f32 and partials [ceil(rows/rows_per_chunk), fpad] f32
//   scratch, converged [1] int32 set to 0 by the caller.
// Returns the first CUDA error of a launch, 0 when all launches were taken.
extern "C" int twtml_fused_dense_sgd(
    const void* x, const void* y, const void* count, void* w, void* preds,
    void* residual, void* partials, void* converged, int rows, int features,
    int fpad, int rows_per_chunk, int num_iterations, float step_size,
    float l2_reg, float tol, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  float* wf = static_cast<float*>(w);
  int* flag = static_cast<int*>(converged);
  const int nvec = fpad / 8;
  const int num_chunks = (rows + rows_per_chunk - 1) / rows_per_chunk;
  const int mv_blocks = (rows + kMatvecThreads / 32 - 1) / (kMatvecThreads / 32);
  cudaError_t err;

  matvec_kernel<<<mv_blocks, kMatvecThreads, 0, s>>>(
      xb, wf, nullptr, static_cast<float*>(preds), nullptr, rows, nvec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int it = 1; it <= num_iterations; ++it) {
    matvec_kernel<<<mv_blocks, kMatvecThreads, 0, s>>>(
        xb, wf, static_cast<const float*>(y), static_cast<float*>(residual),
        flag, rows, nvec);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    xtr_partial_kernel<<<num_chunks, kGradThreads, 0, s>>>(
        xb, static_cast<const float*>(residual), static_cast<float*>(partials),
        flag, rows, nvec, rows_per_chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    update_kernel<<<1, kUpdateThreads, 0, s>>>(
        static_cast<const float*>(partials), num_chunks,
        static_cast<const float*>(count), wf, flag, features, fpad, it,
        step_size, l2_reg, tol);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
