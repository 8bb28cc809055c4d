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
// included (512 MiB of int8 at B = 2048, F = 2^18: 0.16 ms at 3.35 TB/s; 2
// GiB of f32: 0.64 ms); the [B, L] tokens it reads are ~1/1000 of that.
// Design: one CTA a row of C (rows from a tenant table, below: one tenant
// for a single batch), in two steps.
//   1. The token pass, O(L log L) in shared memory: each token becomes one
//      64-bit key, idx << ceil(log2 L) | j (an index outside [0, features)
//      becomes the all-ones key, which sorts last and counts nothing); a
//      bitonic sort over the next power of two puts the keys in (idx, j)
//      order, so equal indices sit together in token order. Shared memory:
//      8 bytes of key and 4 of value a token, whatever the row's width.
//   2. The row, written once, in steps of 32 adjacent 16-byte chunks (512
//      contiguous bytes, a store of the warp): each warp writes its own run
//      of steps, one eighth of the row, and carries a cursor, its first key
//      not yet counted (a binary search finds the run's first). A step that
//      ends at or before the cursor key's feature is zeros: one compare in
//      registers.
//      Otherwise each lane loads one of the 32 keys from the cursor on, a
//      ballot tells the step's own, those are shuffled across the warp in
//      sorted order, and the lane whose chunk holds a key adds its value
//      with __fadd_rn, from 0; where the step holds more than 32 keys, each
//      lane finds its chunk's first key by binary search instead. Sorted
//      order is token order: the twin's additions, in its order (bitwise
//      equal to it, and run to run).
// So no byte is written twice, no count waits for a zero-fill to land, and
// no store is a scattered 4-byte one; the store stream of the other CTAs on
// the SM covers a CTA's token pass. No atomics.
//
// ---- B7, dual_sgd_kernel<kLogistic, kInRegisters>
// Each iteration is one [B, B]·[B] product (G·α) plus elementwise work on
// [B] vectors; the convergence test reads Δαᵀ·G·Δα, αᵀ·G·α, u·Δα and u·α.
// What bounds it: neither bytes nor operations of the arithmetic (8.4
// MFLOP an iteration at B = 2048), but latency: a grid-wide barrier each
// iteration, since every row's next α needs the whole batch's α. Design:
// one persistent cooperative launch a batch, at most one CTA an SM; CTA c
// owns rows [c·B/grid, (c+1)·B/grid) of G. Up to 16 rows a CTA and B <=
// 2048 they live in registers across the loop (kInRegisters: 2 float4
// columns of each row a thread, 128 floats at B = 2048 over 132 SMs);
// otherwise in shared memory, and rows that do not fit (B = 3072, 4096) are
// staged once into a spill buffer and read through L2; the product then
// takes groups of up to 16 rows, all resident or all spilled, and a thread
// issues a column's loads of a group together, so that the spilled rows'
// L2 latencies overlap. An iteration (an update k):
//   1. if the decision of test k − 2 is in, the CTA reads it: if that test
//      converged, α_{k−2} (kept in shared memory by parity) and c_{k−2}
//      are the result and the grid leaves the loop together;
//   2. warp 0 updates α on the CTA's rows, a lane a row (r = residual(c·u
//      + G·α, y)·sel; α <- α·(1 − ηλ) − (η·r)/max(count, 1)), and publishes
//      them into a global double buffer;
//   3. one grid barrier (cooperative groups' grid.sync());
//   4. the last warp loads the CTAs' partials of test k − 1; G·α of the
//      CTA's rows: every thread loads its columns of the new α from L2
//      (16-byte loads) and takes them against its columns of every row, a
//      reduce-scatter sums 16 rows across the warp, the warps in order;
//   5. warp 0 writes the partials of test k over the CTA's rows, from the
//      one product: Δαᵀ·G·Δα as Σ Δα·(G·α_new − G·α_old) (a CPU model
//      holds the iterations this runs to the twin's and the JAX loop's,
//      tests/test_torch_dual_form.py), into a double buffer by update;
//      meanwhile the last warp sums test k − 1's partials in a fixed order,
//      the same bits in every CTA, off the path the other warps wait on.
// So an update crosses one barrier, which also carries the last test; the
// last update crosses it only when a test is pending (never at tolerance
// 0) and decides it at once, and a loop that stops at iteration i < N
// crosses i + 1. The kernel writes the barriers it crossed beside c and
// the iterations run. count is Σ mask·masks[i] over the whole batch, the
// same bits in every CTA; an iteration with count 0 makes no update and is
// not convergence. Rows with mask <= 0 are zeroed where they are staged
// (their u and y, their rows and columns of G), so NaN/Inf there is
// ignored; so is α's padding [B, bp) in the global buffers, once, since
// the product loads it as whole float4s. The update and the step scalars use the JAX loop's f32
// operations without contraction; the product sums in another order than
// torch's, so the twin holds B7 within tolerance. What is left is latency:
// at B = 2048 an iteration is about one grid.sync() crossing (~1.1 µs on
// an H100) plus L2 round trips and the CTA's own reductions.
//
// ---- B8, writeback_kernel<T>
// What bounds it: bytes, one read of C (B·F bytes in the int8 plane). Design:
// a block (over column blocks x the tenants of a table: one tenant for a
// single batch) owns 128 text columns: 32 column groups of 4 (a warp reads 128
// contiguous bytes of a row of int8 C) by 8 row segments; each thread sums
// count·α over its segment's rows in row order, the 8 segments are summed
// in order in shared memory, and w = c·w_prev + Σ. The last block computes
// the 4 numeric columns, w_num·c + Nᵀα, in a fixed-order block reduction.
// It sums count·α where the JAX scatter adds val·α per occurrence, so the
// twin holds it within tolerance.
//
// ---- The tenant forms: B4's and B8's tenant tables, dual_tenants_kernel<kLogistic>
// They replace the same XLA fusions under jax.vmap: the JAX package's
// tenant stack with mapping="vmap" (twtml_tpu/parallel/tenants.py:329-330)
// maps the step over M parts of B rows, each tenant with its own step size
// and L2. A part's rows past its last valid one are padding, so each form
// works on a tenant's valid rows v only (the host counts them before the
// copy), from a per-tenant table passed by value (at most kGramTenants
// tenants a launch).
// - B4's (bound: bytes, C's Σ padded v rows written once): B4 itself, a CTA
//   a row of one counts buffer that holds every tenant's block of C (v rows
//   padded as B4 pads a batch): each block is B4's on those rows bit for
//   bit, since a single batch is the table of one tenant. The tenants of a launch share
//   a Gram plane (the caller launches once a plane present), so a tenant
//   with a tweet-length row does not widen the others to f32 counts.
// - B7's (bound: operations, Σ iterations·(2v² + 12v) f32; in practice the
//   barriers' latency): M dual loops behind one grid barrier. Tenant u's
//   CTAs are a run of the grid, in proportion to its v² rows of G; each
//   keeps B7's layout of its rows (shared memory, then a spill buffer
//   through L2), reads its text G (the int8 plane's s32 product read as
//   f32, exactly) and adds N·Nᵀ as it stages G, runs B7's update, product
//   and test partials over its rows, and freezes where its test converges;
//   the launch ends when every tenant with rows has converged or N is
//   reached. An iteration crosses two barriers where B7 crosses one: the
//   first publishes α, the second the test's partials, after which every
//   CTA takes every tenant's decision (lane u of one warp sums tenant u's
//   CTAs in CTA order: the same bits in every CTA). Simple first: B7's
//   speculative update past a pending test is left out. An iteration whose
//   draws select none of a tenant's rows leaves that tenant as it is and
//   is not its convergence. A dry tenant gets no CTA: CTA 0 writes its c =
//   1, α = 0 and N iterations.
// - B8's (bound: bytes, each tenant's v rows of C read once): B8 itself,
//   its blocks over (column block, tenant): each tenant's row of W is B8's
//   on the same rows bit for bit (a dry tenant's is c·W_prev).
//
// What Hopper offers and these designs leave out: tensor cores and TMA.
// B4 and B8 stream bytes; B7's product is matrix × vector (N = 1) on f32
// operands, as the twin's, from a G that stays in registers: its time is
// the barrier's and L2's latency, which neither unit shortens. The G
// product itself runs on the tensor cores (cuBLASLt's int8 GEMM behind
// torch._int_mm).

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCountThreads = 256;
constexpr int kCountWarps = kCountThreads / 32;
using CountKey = unsigned long long;  // a count-build sort key
constexpr int kCountKeyBytes = sizeof(CountKey);
constexpr int kDualThreads = 256;
constexpr int kDualWarps = kDualThreads / 32;
constexpr int kDualRows = 16;     // rows of G a product pass sums at once
constexpr int kDualRegCols = 2;   // float4 columns of each row of G a thread holds in registers
constexpr int kDualMaxGrid = 160;  // CTAs a launch: the decider reads 5 CTAs' partials a lane
constexpr int kDecider = kDualWarps - 1;  // the warp that sums the tests' partials
// the reduction scratch: the row partials [kDualWarps][kDualRows], then
// block_sum's [kDualWarps] at kRedSum, then the converged flag
constexpr int kRedSum = kDualWarps * kDualRows;
constexpr int kRedFlag = kRedSum + kDualWarps;
constexpr int kDualRedFloats = (kRedFlag + 4) & ~3;  // a multiple of 16 bytes
constexpr int kWbThreads = 256;
constexpr int kWbGroups = 32;                // 4-column groups a block
constexpr int kWbSegments = kWbThreads / kWbGroups;  // row segments a block
constexpr int kWbCols = 4 * kWbGroups;       // 128 text columns a block
constexpr int kGramTenants = 32;  // tenants a tenant-form launch: a lane of the decider warp each

// ops/fused_gram.py sizes the launches from its own copy of these
// constants; ops/_build.py passes that copy as -D flags, so the two cannot
// drift apart without the build failing here.
#if !defined(TWTML_GRAM_COUNT_THREADS) || !defined(TWTML_GRAM_COUNT_KEY_BYTES) || \
    !defined(TWTML_GRAM_DUAL_THREADS) || !defined(TWTML_GRAM_DUAL_ROWS) || \
    !defined(TWTML_GRAM_DUAL_REG_COLUMNS) || !defined(TWTML_GRAM_DUAL_MAX_GRID) || \
    !defined(TWTML_GRAM_DUAL_RED_FLOATS) || !defined(TWTML_GRAM_WRITEBACK_THREADS) || \
    !defined(TWTML_GRAM_WRITEBACK_COLUMNS) || !defined(TWTML_GRAM_TENANTS_PER_LAUNCH)
#error "build through twtml_tpu_torch/ops/_build.py, which passes the launch plan's constants"
#endif
static_assert(kCountThreads == TWTML_GRAM_COUNT_THREADS, "COUNT_THREADS differs");
static_assert(kCountKeyBytes == TWTML_GRAM_COUNT_KEY_BYTES, "COUNT_KEY_BYTES differs");
static_assert(kDualThreads == TWTML_GRAM_DUAL_THREADS, "DUAL_THREADS differs");
static_assert(kDualRows == TWTML_GRAM_DUAL_ROWS, "DUAL_ROWS differs");
static_assert(kDualRegCols == TWTML_GRAM_DUAL_REG_COLUMNS, "DUAL_REG_COLUMNS differs");
static_assert(kDualMaxGrid == TWTML_GRAM_DUAL_MAX_GRID, "DUAL_MAX_GRID differs");
static_assert(kDualRedFloats == TWTML_GRAM_DUAL_RED_FLOATS, "DUAL_RED_FLOATS differs");
static_assert(kWbThreads == TWTML_GRAM_WRITEBACK_THREADS, "WRITEBACK_THREADS differs");
static_assert(kWbCols == TWTML_GRAM_WRITEBACK_COLUMNS, "WRITEBACK_COLUMNS differs");
static_assert(kGramTenants == TWTML_GRAM_TENANTS_PER_LAUNCH, "TENANTS_PER_LAUNCH differs");
static_assert(kGramTenants <= 32, "the tenant form's decisions take a lane a tenant");

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

// A 16-byte chunk of a row of C: the kPer counts it holds, packed.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kPer = 4;
  static __device__ __forceinline__ uint4 pack(const float (&s)[kPer]) {
    return make_uint4(__float_as_uint(s[0]), __float_as_uint(s[1]), __float_as_uint(s[2]),
                      __float_as_uint(s[3]));
  }
};
template <>
struct Chunk<int8_t> {
  static constexpr int kPer = 16;
  static __device__ __forceinline__ uint4 pack(const float (&s)[kPer]) {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[q] |= (uint32_t)(uint8_t)to_count<int8_t>(s[4 * q + e]) << (8 * e);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

constexpr CountKey kNoKey = ~CountKey(0);  // sorts after every valid key

// Byte offsets of a count-build CTA's dynamic shared memory, each 16-byte
// aligned: the sort keys [width] at 0, the values [tokens] f32, then the
// end. ops/fused_gram.py count_layout computes the same.
struct CountLayout {
  int token_bits, width;
  size_t vals, end;
};

__host__ __device__ inline CountLayout count_layout(int tokens) {
  CountLayout l;
  l.token_bits = 0;  // ceil(log2 tokens)
  while ((1 << l.token_bits) < tokens) ++l.token_bits;
  l.width = 1 << l.token_bits;
  l.vals = align16((size_t)l.width * sizeof(CountKey));
  l.end = l.vals + align16((size_t)tokens * 4);
  return l;
}

// Ascending bitonic sort of keys[0, width) (width a power of two) by the
// whole CTA; ends with a barrier.
__device__ void bitonic_sort(CountKey* keys, int width) {
  for (int size = 2; size <= width; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < width / 2; i += kCountThreads) {
        const int lo = 2 * i - (i & (stride - 1));  // the pair (lo, lo + stride)
        const CountKey a = keys[lo], c = keys[lo + stride];
        if ((a > c) == ((lo & size) == 0)) {
          keys[lo] = c;
          keys[lo + stride] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The counts of the chunk holding features [f0, f0 + kPer): the first key
// at or past f0 by binary search in [lo, width), then each key of the
// chunk's indices in sorted (= token) order, its value added with __fadd_rn
// into its slot.
template <typename T>
__device__ __forceinline__ uint4 chunk_counts(const CountKey* keys, const float* vals, int lo,
                                              int width, int token_bits, int f0) {
  constexpr int kPer = Chunk<T>::kPer;
  const CountKey first = (CountKey)f0 << token_bits;
  int hi = width;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < first)
      lo = mid + 1;
    else
      hi = mid;
  }
  float s[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) s[e] = 0.f;
  const CountKey jmask = ((CountKey)1 << token_bits) - 1;
  for (int q = lo; q < width; ++q) {
    const CountKey key = keys[q];
    if (key == kNoKey) break;
    const int slot = (int)(key >> token_bits) - f0;
    if (slot >= kPer) break;
    const float v = vals[(int)(key & jmask)];
#pragma unroll
    for (int e = 0; e < kPer; ++e) s[e] = slot == e ? __fadd_rn(s[e], v) : s[e];
  }
  return Chunk<T>::pack(s);
}

// The counts of the lane's chunk, features [f0, f0 + kPer), from the
// step's n keys held by lanes [0, n) of the warp: each key in sorted (=
// token) order, its value added with __fadd_rn into its slot by the lane
// whose chunk holds it. Called by the whole warp.
template <typename T>
__device__ __forceinline__ uint4 window_counts(CountKey key, int n, const float* vals,
                                               int token_bits, int f0) {
  constexpr int kPer = Chunk<T>::kPer;
  const CountKey jmask = ((CountKey)1 << token_bits) - 1;
  float s[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) s[e] = 0.f;
  for (int t = 0; t < n; ++t) {
    const CountKey kt = __shfl_sync(0xffffffffu, key, t);
    const int slot = (int)(kt >> token_bits) - f0;
    if (slot >= 0 && slot < kPer) {
      const float v = vals[(int)(kt & jmask)];
#pragma unroll
      for (int e = 0; e < kPer; ++e) s[e] = slot == e ? __fadd_rn(s[e], v) : s[e];
    }
  }
  return Chunk<T>::pack(s);
}

// One row of C by the whole CTA: the row's tokens ri/rv [tokens] (when
// `real`; else a padding row, zeros only, uniform across the CTA) summed
// into out_row [cols].
template <typename T>
__device__ __forceinline__ void count_row(const int* __restrict__ ri,
                                          const float* __restrict__ rv, bool real, int tokens,
                                          int features, T* __restrict__ out_row, int cols,
                                          unsigned char* smem) {
  constexpr int kPer = Chunk<T>::kPer;
  const CountLayout lay = count_layout(tokens);
  CountKey* keys = reinterpret_cast<CountKey*>(smem);
  float* s_val = reinterpret_cast<float*>(smem + lay.vals);
  const int tid = threadIdx.x, lane = tid & 31;
  const int token_bits = lay.token_bits, width = lay.width;
  if (real) {
    // ---- the token pass
    for (int j = tid; j < width; j += kCountThreads) {
      CountKey key = kNoKey;
      if (j < tokens) {
        const int f = __ldg(ri + j);
        s_val[j] = __ldg(rv + j);
        if (f >= 0 && f < features) key = ((CountKey)f << token_bits) | (CountKey)j;
      }
      keys[j] = key;
    }
    __syncthreads();
    bitonic_sort(keys, width);
  }
  // ---- the row, every 16-byte chunk stored once. A step is 32 adjacent
  // chunks (512 bytes); warp w writes the w-th of kCountWarps runs of
  // steps. Its cursor q (uniform across the warp) is its first key not yet
  // counted, `next` that key's feature: a step that ends at or before it
  // is zeros.
  constexpr int kStepFeatures = 32 * kPer;
  constexpr unsigned kFull = 0xffffffffu;
  uint4* row4 = reinterpret_cast<uint4*>(out_row);
  const int chunks = (int)((size_t)cols * sizeof(T) / 16);
  const int steps = (chunks + 31) / 32, run = (steps + kCountWarps - 1) / kCountWarps;
  const int s0 = (tid >> 5) * run, s1 = min(s0 + run, steps);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  int q = width;
  if (real && s0 < s1) {  // the first key at or past the run's first feature
    const CountKey first = (CountKey)s0 * kStepFeatures << token_bits;
    int lo = 0, hi = width;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (keys[mid] < first)
        lo = mid + 1;
      else
        hi = mid;
    }
    q = lo;
  }
  // the cursor key's feature (INT_MAX when none is left), and the step's end
  int next = q < width && keys[q] != kNoKey ? (int)(keys[q] >> token_bits) : INT_MAX;
  int end = s0 * kStepFeatures;
  for (int step = s0; step < s1; ++step) {
    const int i = step * 32 + lane;
    end += kStepFeatures;
    uint4 v = zero;
    if (next < end) {  // the step holds keys[q], ...: each lane loads one of 32
      const CountKey key_end = (CountKey)end << token_bits;
      CountKey key = q + lane < width ? keys[q + lane] : kNoKey;
      unsigned inside = __ballot_sync(kFull, key < key_end);  // a run of lanes from 0
      if (inside != kFull) {  // all the step's keys
        v = window_counts<T>(key, __popc(inside), s_val, token_bits, i * kPer);
        q += __popc(inside);
      } else {  // more than 32: each chunk's first key by binary search
        if (i < chunks) v = chunk_counts<T>(keys, s_val, q, width, token_bits, i * kPer);
        do {
          q += 32;
          key = q + lane < width ? keys[q + lane] : kNoKey;
          inside = __ballot_sync(kFull, key < key_end);
        } while (inside == kFull);
        q += __popc(inside);
      }
      next = q < width && keys[q] != kNoKey ? (int)(keys[q] >> token_bits) : INT_MAX;
    }
    if (i < chunks) row4[i] = v;
  }
}

// B4's row table (a launch's tenants, in the stack's order; a single
// batch is one tenant): the tenant's first row in the [M·B, L] tokens, its
// valid rows, and its first row of C (out_row[tenants]: C's rows in all).
struct CountTenants {
  int tenants;
  int src_row[kGramTenants];
  int valid[kGramTenants];
  int out_row[kGramTenants + 1];
};

// B4: CTA b writes row b of C, row b − out_row[u] of tenant u's block: that tenant's token row when it is one of its valid rows,
// else a padding row of zeros.
template <typename T>
__global__ void __launch_bounds__(kCountThreads) count_build_kernel(
    const int* __restrict__ idx, const float* __restrict__ val, int tokens, int features,
    T* __restrict__ out, int cols, const CountTenants t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  int u = 0;  // the CTA's tenant (a dry tenant owns no row: the scan steps past it)
  while (u + 1 < t.tenants && t.out_row[u + 1] <= b) ++u;
  const int r = b - t.out_row[u];
  const bool real = r < t.valid[u];
  const size_t src = (size_t)(t.src_row[u] + (real ? r : 0)) * tokens;
  count_row<T>(idx + src, val + src, real, tokens, features, out + (size_t)b * cols, cols, smem);
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
  float* abuf;           // [2][bp] f32: α, double-buffered by update
  float* partials;       // [2][grid][4] f32: the tests' partials, double-buffered by update
  float* c_out;          // [1]
  float* iterations;     // [1]: the iteration that converged, else N
  float* barriers;       // [1]: grid barriers crossed
  float* spill;          // [grid][spill_per_cta][bp] f32
  int rows, bp, rows_cap, resident, spill_per_cta, num_iterations;
  float step_size, l2_reg, tol;
};

// Byte offsets of the dynamic shared memory, each 16-byte aligned: α of
// the whole batch [bp] at 0 (staged from L2 each iteration, when G's rows
// are not in registers), the mask [bp], then the CTA's rows: u and y
// [rows_cap] each, α and G·α [2][rows_cap] each (by the parity of the
// update that made them); the reduction scratch; then the resident rows
// of G [bp] f32 each (none when G's rows live in registers). The launch
// plan (ops/fused_gram.py dual_plan) computes the same.
struct DualLayout {
  size_t own, mask, u, y, a, s, red, g;  // own: the stride of a [rows_cap] vector
};

__host__ __device__ inline DualLayout dual_layout(int bp, int rows_cap) {
  DualLayout l;
  const size_t vec = align16((size_t)bp * 4);
  l.own = align16((size_t)rows_cap * 4);
  l.mask = vec;
  l.u = 2 * vec;
  l.y = l.u + l.own;
  l.a = l.y + l.own;
  l.s = l.a + 2 * l.own;
  l.red = l.s + 2 * l.own;
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

// The warp's sums of kDualRows per-lane values at once (a reduce-scatter:
// 16 shuffles where a warp_sum each would take 80): returns, in lanes 2j
// and 2j + 1, Σ over the 32 lanes of acc[j], each row in a fixed order.
__device__ __forceinline__ float rows_sum(const float (&acc)[kDualRows], int lane) {
  static_assert(kDualRows == 16, "the reduce-scatter below takes 16 rows");
  constexpr unsigned kFull = 0xffffffffu;
  float v8[8], v4[4], v2[2];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
#pragma unroll
  for (int j = 0; j < 8; ++j)  // rows 8·b4 + j
    v8[j] = (b4 ? acc[j + 8] : acc[j]) + __shfl_xor_sync(kFull, b4 ? acc[j] : acc[j + 8], 16);
#pragma unroll
  for (int j = 0; j < 4; ++j)  // rows 8·b4 + 4·b3 + j
    v4[j] = (b3 ? v8[j + 4] : v8[j]) + __shfl_xor_sync(kFull, b3 ? v8[j] : v8[j + 4], 8);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    v2[j] = (b2 ? v4[j + 2] : v4[j]) + __shfl_xor_sync(kFull, b2 ? v4[j] : v4[j + 2], 4);
  const float v1 = (b1 ? v2[1] : v2[0]) + __shfl_xor_sync(kFull, b1 ? v2[0] : v2[1], 2);
  return v1 + __shfl_xor_sync(kFull, v1, 1);  // row (lane >> 1) & 15
}

__device__ __forceinline__ float dot4(float4 g, float4 a, float acc) {
  acc = fmaf(g.x, a.x, acc);
  acc = fmaf(g.y, a.y, acc);
  acc = fmaf(g.z, a.z, acc);
  return fmaf(g.w, a.w, acc);
}

// Each thread's partial sums of n <= kDualRows consecutive rows of G
// ([n][nvec] float4 at g4: all in shared memory, or all in the spill
// buffer, read through L2) against α (alpha4, shared), over its columns.
// A column's n loads are issued together, so a spilled row's L2 latency
// overlaps the other rows'.
template <bool kSpilled>
__device__ __forceinline__ void rows_partials(const float4* g4, const float4* alpha4, int nvec,
                                              int n, float (&acc)[kDualRows]) {
#pragma unroll
  for (int j = 0; j < kDualRows; ++j) acc[j] = 0.f;
  for (int v = threadIdx.x; v < nvec; v += kDualThreads) {
    float4 gv[kDualRows];
#pragma unroll
    for (int j = 0; j < kDualRows; ++j)
      if (j < n) gv[j] = kSpilled ? __ldcg(g4 + (size_t)j * nvec + v) : g4[(size_t)j * nvec + v];
    const float4 av = alpha4[v];
#pragma unroll
    for (int j = 0; j < kDualRows; ++j)
      if (j < n) acc[j] = dot4(gv[j], av, acc[j]);
  }
}

// Rows [r0, r0 + n) of the CTA's G·α from every thread's partial sums:
// each warp's reduce-scatter into red[warp][j], then lane (r0 + j) & 31 of
// warp 0 (the thread that updates that row) sums the warps in order into
// sn[r0 + j]. Ends with warp 0's reads of red pending: a caller that
// writes red again first crosses a __syncthreads.
__device__ __forceinline__ void finish_rows(const float (&acc)[kDualRows], int r0, int n,
                                            float* red, float* sn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float v = rows_sum(acc, lane);
  if ((lane & 1) == 0) red[warp * kDualRows + (lane >> 1)] = v;
  __syncthreads();
  const int j = (lane - r0) & 31;
  if (warp == 0 && j < n) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kDualWarps; ++w) s += red[w * kDualRows + j];
    sn[r0 + j] = s;
  }
}

template <bool kLogistic>
__device__ __forceinline__ float dual_residual(float raw, float y) {
  if constexpr (kLogistic) {
    return __fsub_rn(1.f / (1.f + expf(-raw)), y);
  } else {
    return __fsub_rn(raw, y);
  }
}

// kInRegisters: the CTA's rows of G (at most kDualRows) live in registers,
// kDualRegCols float4 columns of each a thread; else in shared memory, and
// past `resident` in the spill buffer, read through L2.
template <bool kLogistic, bool kInRegisters>
__global__ void __launch_bounds__(kDualThreads, 1) dual_sgd_kernel(const DualParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DualLayout lay = dual_layout(p.bp, p.rows_cap);
  float* alpha_s = reinterpret_cast<float*>(smem);
  float* mask_s = reinterpret_cast<float*>(smem + lay.mask);
  float* u_s = reinterpret_cast<float*>(smem + lay.u);
  float* y_s = reinterpret_cast<float*>(smem + lay.y);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  const float4* g4_s = reinterpret_cast<const float4*>(smem + lay.g);
  // α and G·α of the CTA's rows made by an update of parity q
  const auto a_s = [&](int q) { return reinterpret_cast<float*>(smem + lay.a + q * lay.own); };
  const auto s_s = [&](int q) { return reinterpret_cast<float*>(smem + lay.s + q * lay.own); };

  cg::grid_group grid = cg::this_grid();
  const int cta = blockIdx.x, ncta = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = p.rows, bp = p.bp, nvec = bp / 4;
  const int row0 = (int)((long long)cta * rows / ncta);
  const int my_rows = (int)((long long)(cta + 1) * rows / ncta) - row0;
  const bool test = p.tol > 0.f;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // ---- prologue: the batch's mask, the CTA's u, y and rows of G, once
  for (int k = tid; k < bp; k += kDualThreads) mask_s[k] = k < rows ? __ldg(p.mask + k) : 0.f;
  __syncthreads();
  for (int l = tid; l < my_rows; l += kDualThreads) {
    const bool keep = mask_s[row0 + l] > 0.f;
    u_s[l] = keep ? __ldg(p.u + row0 + l) : 0.f;
    y_s[l] = keep ? __ldg(p.y + row0 + l) : 0.f;
    a_s(0)[l] = 0.f;  // α = 0, the state before update 1
    s_s(0)[l] = 0.f;  // G·α with α = 0
  }
  // The padding [rows, bp) of both α buffers, which the updates never
  // write but G·α loads as whole float4s: zero, so that whatever the
  // scratch held there (NaN, Inf) meets G's zero columns as 0. The first
  // barrier orders these writes before any load.
  if (cta == 0)
    for (int k = rows + tid; k < bp; k += kDualThreads) p.abuf[k] = p.abuf[bp + k] = 0.f;
  // mask_s is 0 past rows: a masked row's or column's G is 0
  float4 greg[kInRegisters ? kDualRows : 1][kInRegisters ? kDualRegCols : 1];
  if constexpr (kInRegisters) {
#pragma unroll
    for (int j = 0; j < kDualRows; ++j) {
      const bool keep = j < my_rows && mask_s[row0 + j] > 0.f;
      const float* src = p.g + (size_t)(row0 + j) * p.ldg;
#pragma unroll
      for (int q = 0; q < kDualRegCols; ++q) {
        const int k = 4 * (tid + q * kDualThreads);
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          e[i] = keep && k + i < bp && mask_s[k + i] > 0.f ? __ldg(src + k + i) : 0.f;
        greg[j][q] = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
  } else {
    for (int l = warp; l < my_rows; l += kDualWarps) {
      const int r = row0 + l;
      const bool keep = mask_s[r] > 0.f;
      float* dst = l < p.resident
                       ? reinterpret_cast<float*>(smem + lay.g) + (size_t)l * bp
                       : p.spill + ((size_t)cta * p.spill_per_cta + (l - p.resident)) * bp;
      const float* src = p.g + (size_t)r * p.ldg;
      for (int k = lane; k < bp; k += 32) dst[k] = keep && mask_s[k] > 0.f ? __ldg(src + k) : 0.f;
    }
  }
  float count_all;
  {
    float v = 0.f;
    for (int k = tid; k < rows; k += kDualThreads) v += mask_s[k];
    count_all = block_sum(v, red + kRedSum);  // also orders the staging above before the loop
  }
  const float pp = __ldg(p.p_prev);

  // The convergence test of update k: its partials are written after G·α_k,
  // loaded by the decider warp past the barrier of update k + 1 (the only
  // barrier an update crosses) and summed after that update's product, off
  // the path the other warps wait on; the CTA reads the decision at the top
  // of the next update. If it converged, α_k and c_k are the result (α_k is
  // kept until update k + 2 would overwrite it) and the speculative update
  // k + 1 is dropped.
  float4 t[kDualMaxGrid / 32];  // the decider's loads of a test's partials
  const auto load_partials = [&](int parity) {  // the decider warp
    const float4* part = reinterpret_cast<const float4*>(p.partials) + (size_t)parity * ncta;
#pragma unroll
    for (int i = 0; i < kDualMaxGrid / 32; ++i) {
      const int k = lane + 32 * i;
      t[i] = k < ncta ? __ldcg(part + k) : zero4;
    }
  };
  const auto decide = [&](float c_new, float c_old) {  // the decider warp, after load_partials
    // each lane's CTAs in order, then the lanes: the same bits in every CTA
    float q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kDualMaxGrid / 32; ++i) {
      q[0] += t[i].x;
      q[1] += t[i].y;
      q[2] += t[i].z;
      q[3] += t[i].w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = warp_sum(q[j]);
    if (lane == 0) {
      // dual_norm_sq: Δc²·p + 2·Δc·(u·Δα) + Δαᵀ·G·Δα, and the same of the new state
      const float dc = c_new - c_old;
      const float d2 = dc * dc * pp + 2.f * dc * q[2] + q[0];
      const float n2 = c_new * c_new * pp + 2.f * c_new * q[3] + q[1];
      red[kRedFlag] = sqrtf(d2) < p.tol * fmaxf(sqrtf(n2), 1.f) ? 1.f : 0.f;
    }
  };

  float c = 1.f, c_prev = 1.f;  // c of the latest update and of the one before
  int cur = 0;                  // the parity of the latest state's α and G·α
  int ran = p.num_iterations, barriers = 0, updates = 0;
  int undecided = -1, undecided_it = 0;  // the test whose partials await the next barrier
  int decided_it = 0;                    // the test the decider summed, its flag unread
  float decided_c = 1.f;
  int result = -1;  // the parity of the result's α, once the loop stopped
  for (int it = 1; it <= p.num_iterations; ++it) {
    const float* draw = p.masks ? p.masks + (size_t)(it - 1) * rows : nullptr;
    float count = count_all;
    if (draw) {
      float v = 0.f;
      for (int k = tid; k < rows; k += kDualThreads) v += mask_s[k] * __ldg(draw + k);
      count = block_sum(v, red + kRedSum);
    }
    if (!(count > 0.f)) continue;  // no sampled row: no update, and not convergence
    if (decided_it > 0) {  // the decider's flag, before this update overwrites its α
      __syncthreads();
      if (red[kRedFlag] != 0.f) {
        ran = decided_it;
        c = decided_c;
        result = cur ^ 1;
        break;
      }
      decided_it = 0;
    }
    // the JAX loop's f32 arithmetic, operation for operation
    const float eta = __fdiv_rn(p.step_size, __fsqrt_rn((float)it));
    const float scale = __fsub_rn(1.f, __fmul_rn(eta, p.l2_reg));
    const float denom = fmaxf(count, 1.f);
    const bool last = it == p.num_iterations;
    const int nxt = cur ^ 1;
    ++updates;
    float* a_pub = p.abuf + (size_t)(updates & 1) * bp;
    if (warp == 0) {  // the update of the CTA's rows, a lane a row
      const float* a_old = a_s(cur);
      const float* s_old = s_s(cur);
      float* a_new = a_s(nxt);
      for (int l = lane; l < my_rows; l += 32) {
        const int r = row0 + l;
        const float m = mask_s[r];
        const float sel = draw ? m * __ldg(draw + r) : m;
        float res = 0.f;
        if (m > 0.f) {
          const float raw = __fadd_rn(__fmul_rn(c, u_s[l]), s_old[l]);
          res = __fmul_rn(dual_residual<kLogistic>(raw, y_s[l]), sel);
        }
        const float a =
            __fsub_rn(__fmul_rn(a_old[l], scale), __fdiv_rn(__fmul_rn(eta, res), denom));
        a_new[l] = a;
        if (!last) a_pub[r] = a;
      }
    }
    const float c_new = __fmul_rn(c, scale);  // c·(1 − ηλ) − η·0/denom
    if (last && undecided < 0) {  // nothing reads G·α after the last update
      c = c_new;
      result = nxt;
      break;
    }
    grid.sync();
    ++barriers;
    const bool deciding = undecided >= 0;
    if (deciding && warp == kDecider) load_partials(undecided);
    if (last) {  // the pending test decides between this update and the last
      if (warp == kDecider) decide(c, c_prev);
      __syncthreads();
      const bool stop = red[kRedFlag] != 0.f;
      ran = stop ? undecided_it : ran;
      c = stop ? c : c_new;
      result = stop ? cur : nxt;
      break;
    }
    // ---- G·α_new of the CTA's rows: a thread's columns of every row (α of
    // the batch, 16 bytes a load from L2), then the rows' sums across the
    // CTA in a fixed order
    float* s_new = s_s(nxt);
    const float4* a4 = reinterpret_cast<const float4*>(a_pub);
    if constexpr (kInRegisters) {
      float4 av[kDualRegCols];
#pragma unroll
      for (int q = 0; q < kDualRegCols; ++q) {
        const int v = tid + q * kDualThreads;
        av[q] = v < nvec ? __ldcg(a4 + v) : zero4;
      }
      float acc[kDualRows];
#pragma unroll
      for (int j = 0; j < kDualRows; ++j) {
        acc[j] = 0.f;
#pragma unroll
        for (int q = 0; q < kDualRegCols; ++q) acc[j] = dot4(greg[j][q], av[q], acc[j]);
      }
      finish_rows(acc, 0, my_rows, red, s_new);
    } else {
      for (int v = tid; v < nvec; v += kDualThreads)
        reinterpret_cast<float4*>(alpha_s)[v] = __ldcg(a4 + v);
      __syncthreads();
      const float4* alpha4 = reinterpret_cast<const float4*>(alpha_s);
      const float4* spill4 =
          reinterpret_cast<const float4*>(p.spill) + (size_t)cta * p.spill_per_cta * nvec;
      const int kept = min(my_rows, p.resident);
      // groups of up to 16 rows, each all resident or all spilled
      for (int r0 = 0; r0 < my_rows;) {
        if (r0 > 0) __syncthreads();  // warp 0 has read red
        const bool spilled = r0 >= kept;
        const int n = min(kDualRows, (spilled ? my_rows : kept) - r0);
        float acc[kDualRows];
        if (spilled)
          rows_partials<true>(spill4 + (size_t)(r0 - p.resident) * nvec, alpha4, nvec, n, acc);
        else
          rows_partials<false>(g4_s + (size_t)r0 * nvec, alpha4, nvec, n, acc);
        finish_rows(acc, r0, n, red, s_new);
        r0 += n;
      }
    }
    // ---- the partials of this update's test over the CTA's rows in order
    // (lane l holds rows l, l + 32, ...; finish_rows wrote its s_new): the
    // one product gives Δαᵀ·G·Δα as Σ Δα·(G·α_new − G·α_old)
    if (test && warp == 0) {
      const float *a_old = a_s(cur), *s_old = s_s(cur), *a_new = a_s(nxt);
      float qd = 0.f, qa = 0.f, ud = 0.f, ua = 0.f;
      for (int l = lane; l < my_rows; l += 32) {
        const float an = a_new[l], sn = s_new[l];
        const float d = __fsub_rn(an, a_old[l]);
        qd = fmaf(d, __fsub_rn(sn, s_old[l]), qd);
        qa = fmaf(an, sn, qa);
        ud = fmaf(u_s[l], d, ud);
        ua = fmaf(u_s[l], an, ua);
      }
      qd = warp_sum(qd);
      qa = warp_sum(qa);
      ud = warp_sum(ud);
      ua = warp_sum(ua);
      if (lane == 0)
        reinterpret_cast<float4*>(p.partials)[(size_t)(updates & 1) * ncta + cta] =
            make_float4(qd, qa, ud, ua);
    }
    if (deciding) {  // the last test, its loads landed during the product
      if (warp == kDecider) decide(c, c_prev);
      decided_it = undecided_it;
      decided_c = c;
    }
    undecided = test ? (updates & 1) : -1;
    undecided_it = it;
    cur = nxt;
    c_prev = c;
    c = c_new;
  }
  if (result < 0) {  // the loop ran out, its last iterations selecting no row
    result = cur;
    if (decided_it > 0) {
      __syncthreads();
      if (red[kRedFlag] != 0.f) {
        ran = decided_it;
        c = decided_c;
        result = cur ^ 1;
        undecided = -1;
      }
    }
    if (undecided >= 0) {  // one more barrier decides the last test
      grid.sync();
      ++barriers;
      if (warp == kDecider) {
        load_partials(undecided);
        decide(c, c_prev);
      }
      __syncthreads();
      if (red[kRedFlag] != 0.f) ran = undecided_it;
    }
  }
  if (warp == 0)
    for (int l = lane; l < my_rows; l += 32) p.alpha_out[row0 + l] = a_s(result)[l];
  if (cta == 0 && tid == 0) {
    *p.c_out = c;
    *p.iterations = (float)ran;
    *p.barriers = (float)barriers;
  }
}

// ---- B7's tenant form: M dual loops in one cooperative launch

// A launch's tenants (in the stack's order): CTAs [first_cta[u],
// first_cta[u + 1]) run tenant u's loop over its v = valid[u] rows, each
// CTA k of them rows [k·v/ctas, (k+1)·v/ctas); `slot` is its row m of the
// stack (its u, y, mask and numeric rows start at m·B, its c, iterations
// and p_prev at m); `resident` of a CTA's rows live in shared memory, the
// rest in the spill buffer from float `spill_at` on (a CTA's rows_cap −
// resident rows after the one before's); its α at float `abuf_at` of each
// half of the α double buffer; its text G [>= v, ldg] f32, or int32 (the
// int8 plane's s32 product, exact in f32).
struct DualTenants {
  int tenants, batch_rows;
  int first_cta[kGramTenants + 1];
  int valid[kGramTenants], slot[kGramTenants], rows_cap[kGramTenants];
  int resident[kGramTenants], g_int32[kGramTenants];
  long long spill_at[kGramTenants], abuf_at[kGramTenants], ldg[kGramTenants];
  const void* g[kGramTenants];
  float step_size[kGramTenants], l2_reg[kGramTenants];
};

struct DualTenantParams {
  const float* u;        // [M·B] f32: Z·W_prev of every tenant's rows
  const float* y;        // [M·B]
  const float* mask;     // [M·B]
  const float* numeric;  // [M·B, 4]: N, whose N·Nᵀ the prologue adds to G
  const float* masks;    // [iterations, B] Bernoulli draws every tenant shares, or null
  const float* p_prev;   // [M]: ||W_prev||² of each tenant
  float* alpha_out;      // [M, B]: zero past each tenant's valid rows
  float* c_out;          // [M]
  float* iterations;     // [M]: the iteration that converged, else N
  float* abuf;           // [2][abuf_floats]
  float* partials;       // [grid][8]: each CTA's test partials, then (active, c_new, c, p)
  float* spill;
  long long abuf_floats;
  int bp_max, rows_cap_max, num_iterations;
  float tol;
};

// G's element (r, k) of a tenant as B7 reads it: the text G's, in f32,
// plus (N·Nᵀ)[r, k] summed as one fixed fma chain; 0 where row r or
// column k is masked.
__device__ __forceinline__ float tenant_g(const void* g, bool int32, long long ldg, int r, int k,
                                          const float (&nr)[4], const float* numeric) {
  const float text = int32 ? (float)__ldg(static_cast<const int*>(g) + r * ldg + k)
                           : __ldg(static_cast<const float*>(g) + r * ldg + k);
  const float* nk = numeric + 4 * (size_t)k;
  const float nn =
      fmaf(nr[3], __ldg(nk + 3), fmaf(nr[2], __ldg(nk + 2), fmaf(nr[1], __ldg(nk + 1),
                                                                   nr[0] * __ldg(nk))));
  return __fadd_rn(text, nn);
}

template <bool kLogistic>
__global__ void __launch_bounds__(kDualThreads, 1)
    dual_tenants_kernel(const DualTenantParams p, const DualTenants t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DualLayout lay = dual_layout(p.bp_max, p.rows_cap_max);
  float* alpha_s = reinterpret_cast<float*>(smem);
  float* mask_s = reinterpret_cast<float*>(smem + lay.mask);
  float* u_s = reinterpret_cast<float*>(smem + lay.u);
  float* y_s = reinterpret_cast<float*>(smem + lay.y);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  const float4* g4_s = reinterpret_cast<const float4*>(smem + lay.g);
  const auto a_s = [&](int q) { return reinterpret_cast<float*>(smem + lay.a + q * lay.own); };
  const auto s_s = [&](int q) { return reinterpret_cast<float*>(smem + lay.s + q * lay.own); };

  cg::grid_group grid = cg::this_grid();
  const int cta = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int batch = t.batch_rows;
  int me = 0;  // the CTA's tenant (a dry tenant owns no CTA, unless every tenant is dry)
  while (me + 1 < t.tenants && t.first_cta[me + 1] <= cta) ++me;
  const int k = cta - t.first_cta[me], ctas = t.first_cta[me + 1] - t.first_cta[me];
  const int v = t.valid[me], bp = (v + 3) & ~3, nvec = bp / 4;
  const int row0 = (int)((long long)k * v / ctas);
  const int my_rows = (int)((long long)(k + 1) * v / ctas) - row0;
  const size_t base = (size_t)t.slot[me] * batch;
  const float* numeric = p.numeric + 4 * base;
  const bool test = p.tol > 0.f;
  unsigned live = 0;  // tenants with rows: the loop ends when each has converged
  for (int u = 0; u < t.tenants; ++u) live |= t.valid[u] > 0 ? 1u << u : 0u;

  // the dry tenants' results: c = 1, α = 0, N iterations (no row, no update)
  if (cta == 0)
    for (int u = 0; u < t.tenants; ++u)
      if (t.valid[u] == 0) {
        const int m = t.slot[u];
        for (int r = tid; r < batch; r += kDualThreads) p.alpha_out[(size_t)m * batch + r] = 0.f;
        if (tid == 0) {
          p.c_out[m] = 1.f;
          p.iterations[m] = (float)p.num_iterations;
        }
      }

  // ---- prologue: the tenant's mask, the CTA's u, y and rows of G, once
  for (int i = tid; i < p.bp_max; i += kDualThreads)
    mask_s[i] = i < v ? __ldg(p.mask + base + i) : 0.f;
  __syncthreads();
  for (int l = tid; l < my_rows; l += kDualThreads) {
    const bool keep = mask_s[row0 + l] > 0.f;
    u_s[l] = keep ? __ldg(p.u + base + row0 + l) : 0.f;
    y_s[l] = keep ? __ldg(p.y + base + row0 + l) : 0.f;
    a_s(0)[l] = 0.f;
    s_s(0)[l] = 0.f;
  }
  const long long ab = t.abuf_at[me];
  if (k == 0 && v > 0)  // α's padding [v, bp) in both halves: G's zero columns meet it as 0
    for (int i = v + tid; i < bp; i += kDualThreads)
      p.abuf[ab + i] = p.abuf[p.abuf_floats + ab + i] = 0.f;
  const int resident = t.resident[me];
  float* spill = p.spill + t.spill_at[me] + (size_t)k * (t.rows_cap[me] - resident) * bp;
  for (int l = warp; l < my_rows; l += kDualWarps) {
    const int r = row0 + l;
    const bool keep = mask_s[r] > 0.f;
    float nr[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) nr[j] = keep ? __ldg(numeric + 4 * (size_t)r + j) : 0.f;
    float* dst = l < resident ? reinterpret_cast<float*>(smem + lay.g) + (size_t)l * bp
                              : spill + (size_t)(l - resident) * bp;
    for (int i = lane; i < bp; i += 32)
      dst[i] = keep && mask_s[i] > 0.f
                   ? tenant_g(t.g[me], t.g_int32[me] != 0, t.ldg[me], r, i, nr, numeric)
                   : 0.f;
  }
  float count_all;
  {
    float s = 0.f;
    for (int i = tid; i < v; i += kDualThreads) s += mask_s[i];
    count_all = block_sum(s, red + kRedSum);  // also orders the staging before the loop
  }
  const float pp = v > 0 ? __ldg(p.p_prev + t.slot[me]) : 0.f;
  const float step = t.step_size[me], l2 = t.l2_reg[me];

  float c = 1.f;
  int cur = 0, ran = p.num_iterations;
  unsigned frozen = 0;  // the launch's tenants that converged: frozen at that state
  float4* part4 = reinterpret_cast<float4*>(p.partials);
  for (int it = 1; it <= p.num_iterations && (frozen & live) != live; ++it) {
    const float* draw = p.masks ? p.masks + (size_t)(it - 1) * batch : nullptr;
    const bool mine_frozen = (frozen >> me & 1u) != 0;
    float count = count_all;
    if (draw && !mine_frozen) {
      float s = 0.f;
      for (int i = tid; i < v; i += kDualThreads) s += mask_s[i] * __ldg(draw + i);
      count = block_sum(s, red + kRedSum);
    }
    // an iteration that selects no row makes no update and is not convergence
    const bool active = !mine_frozen && count > 0.f;
    // the JAX loop's f32 arithmetic, operation for operation
    const float eta = __fdiv_rn(step, __fsqrt_rn((float)it));
    const float scale = __fsub_rn(1.f, __fmul_rn(eta, l2));
    const float denom = fmaxf(count, 1.f);
    const int nxt = cur ^ 1;
    float* a_pub = p.abuf + (size_t)(it & 1) * p.abuf_floats + ab;
    if (active && warp == 0) {  // the update of the CTA's rows, a lane a row
      const float *a_old = a_s(cur), *s_old = s_s(cur);
      float* a_new = a_s(nxt);
      for (int l = lane; l < my_rows; l += 32) {
        const int r = row0 + l;
        const float m = mask_s[r];
        const float sel = draw ? m * __ldg(draw + r) : m;
        float res = 0.f;
        if (m > 0.f) {
          const float raw = __fadd_rn(__fmul_rn(c, u_s[l]), s_old[l]);
          res = __fmul_rn(dual_residual<kLogistic>(raw, y_s[l]), sel);
        }
        const float a =
            __fsub_rn(__fmul_rn(a_old[l], scale), __fdiv_rn(__fmul_rn(eta, res), denom));
        a_new[l] = a;
        a_pub[r] = a;
      }
    }
    const float c_new = __fmul_rn(c, scale);  // c·(1 − ηλ) − η·0/denom
    if (it == p.num_iterations) {  // the last update: nothing reads G·α or a test after it
      if (active) {
        cur = nxt;
        c = c_new;
      }
      break;
    }
    grid.sync();
    float* s_new = s_s(nxt);
    if (active) {  // G·α_new of the CTA's rows, in groups of up to 16 rows
      const float4* a4 = reinterpret_cast<const float4*>(a_pub);
      for (int i = tid; i < nvec; i += kDualThreads)
        reinterpret_cast<float4*>(alpha_s)[i] = __ldcg(a4 + i);
      __syncthreads();
      const float4* alpha4 = reinterpret_cast<const float4*>(alpha_s);
      const float4* spill4 = reinterpret_cast<const float4*>(spill);
      const int kept = min(my_rows, resident);
      for (int r0 = 0; r0 < my_rows;) {
        if (r0 > 0) __syncthreads();  // warp 0 has read red
        const bool spilled = r0 >= kept;
        const int n = min(kDualRows, (spilled ? my_rows : kept) - r0);
        float acc[kDualRows];
        if (spilled)
          rows_partials<true>(spill4 + (size_t)(r0 - resident) * nvec, alpha4, nvec, n, acc);
        else
          rows_partials<false>(g4_s + (size_t)r0 * nvec, alpha4, nvec, n, acc);
        finish_rows(acc, r0, n, red, s_new);
        r0 += n;
      }
    }
    if (test) {
      // this update's test partials over the CTA's rows (lane l holds rows
      // l, l + 32, ...: finish_rows wrote its s_new), and whether the
      // tenant updated, with its c before and after
      if (warp == 0) {
        float qd = 0.f, qa = 0.f, ud = 0.f, ua = 0.f;
        if (active) {
          const float *a_old = a_s(cur), *s_old = s_s(cur), *a_new = a_s(nxt);
          for (int l = lane; l < my_rows; l += 32) {
            const float an = a_new[l], sn = s_new[l];
            const float d = __fsub_rn(an, a_old[l]);
            qd = fmaf(d, __fsub_rn(sn, s_old[l]), qd);
            qa = fmaf(an, sn, qa);
            ud = fmaf(u_s[l], d, ud);
            ua = fmaf(u_s[l], an, ua);
          }
          qd = warp_sum(qd);
          qa = warp_sum(qa);
          ud = warp_sum(ud);
          ua = warp_sum(ua);
        }
        if (lane == 0) {
          part4[2 * (size_t)cta] = make_float4(qd, qa, ud, ua);
          part4[2 * (size_t)cta + 1] = make_float4(active ? 1.f : 0.f, c_new, c, pp);
        }
      }
      grid.sync();
      // every tenant's decision in every CTA, the same bits everywhere: lane
      // u of the decider warp sums tenant u's CTAs' partials in CTA order
      if (warp == kDecider) {
        bool conv = false;
        if (lane < t.tenants && t.valid[lane] > 0) {
          const int c0 = t.first_cta[lane], c1 = t.first_cta[lane + 1];
          const float4 meta = __ldcg(part4 + 2 * (size_t)c0 + 1);
          if (meta.x != 0.f) {
            float q[4] = {0.f, 0.f, 0.f, 0.f};
            for (int cc = c0; cc < c1; ++cc) {
              const float4 pq = __ldcg(part4 + 2 * (size_t)cc);
              q[0] += pq.x;
              q[1] += pq.y;
              q[2] += pq.z;
              q[3] += pq.w;
            }
            // dual_norm_sq: Δc²·p + 2·Δc·(u·Δα) + Δαᵀ·G·Δα, and of the new state
            const float dc = meta.y - meta.z;
            const float d2 = dc * dc * meta.w + 2.f * dc * q[2] + q[0];
            const float n2 = meta.y * meta.y * meta.w + 2.f * meta.y * q[3] + q[1];
            conv = sqrtf(d2) < p.tol * fmaxf(sqrtf(n2), 1.f);
          }
        }
        const unsigned bits = __ballot_sync(0xffffffffu, conv);
        if (lane == 0) reinterpret_cast<unsigned*>(red)[kRedFlag] = bits;
      }
      __syncthreads();
      const unsigned conv = reinterpret_cast<const unsigned*>(red)[kRedFlag];
      if (conv >> me & 1u) ran = it;
      frozen |= conv;
    }
    if (active) {
      cur = nxt;
      c = c_new;
    }
  }
  if (v > 0) {
    if (warp == 0)
      for (int l = lane; l < my_rows; l += 32) p.alpha_out[base + row0 + l] = a_s(cur)[l];
    if (k == 0) {
      for (int r = v + tid; r < batch; r += kDualThreads) p.alpha_out[base + r] = 0.f;
      if (tid == 0) {
        p.c_out[t.slot[me]] = c;
        p.iterations[t.slot[me]] = (float)ran;
      }
    }
  }
}

// The probe that times B7's grid barrier: `crossings` grid.sync()s and
// nothing else, on B7's block size. Cooperative groups keep the barrier's
// arrival counter in the launch's own workspace, so B7 keeps no barrier
// state in its scratch and a replayed CUDA graph starts it afresh.
__global__ void __launch_bounds__(kDualThreads, 1) barrier_probe_kernel(int crossings) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < crossings; ++i) grid.sync();
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

// Block `block` of `blocks` of one write-back: text columns [128·block,
// 128·block + 128), or the 4 numeric columns in the last block.
template <typename T>
__device__ __forceinline__ void writeback_block(
    const T* __restrict__ counts, int rows, int cols, int features,
    const float* __restrict__ alpha, const float* __restrict__ c_ptr,
    const float* __restrict__ w_prev, const float* __restrict__ numeric,
    float* __restrict__ w_out, int block, int blocks) {
  __shared__ float part[kWbSegments][kWbCols];
  const float c = __ldg(c_ptr);
  const int tid = threadIdx.x;
  if (block == blocks - 1) {  // the 4 numeric columns: w_num·c + Nᵀα
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
  const int col0 = block * kWbCols + 4 * group;
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
    const int f = block * kWbCols + tid;
    if (f < features) {
      float s = part[0][tid];
#pragma unroll
      for (int k = 1; k < kWbSegments; ++k) s += part[k][tid];
      w_out[f] = __fadd_rn(__fmul_rn(__ldg(w_prev + f), c), s);
    }
  }
}

// B8's tenant table (a single batch is one tenant): block (x, u) is block
// x of tenant u's write-back, over its valid rows of its block of C (from row c_row[u]),
// its α and numeric rows (from row src_row[u] of the [M·B] rows), its c
// and its row `slot[u]` of the [M, features + 4] stacks.
struct WritebackTenants {
  int tenants;
  int slot[kGramTenants];
  int c_row[kGramTenants];
  int valid[kGramTenants];
  int src_row[kGramTenants];
};

template <typename T>
__global__ void __launch_bounds__(kWbThreads) writeback_kernel(
    const T* __restrict__ counts, int cols, int features, const float* __restrict__ alpha,
    const float* __restrict__ c, const float* __restrict__ w_prev,
    const float* __restrict__ numeric, float* __restrict__ w_out, const WritebackTenants t) {
  const int u = blockIdx.y;
  const size_t w_row = (size_t)t.slot[u] * (features + 4);
  writeback_block<T>(counts + (size_t)t.c_row[u] * cols, t.valid[u], cols, features,
                     alpha + t.src_row[u], c + t.slot[u], w_prev + w_row,
                     numeric + (size_t)t.src_row[u] * 4, w_out + w_row, blockIdx.x, gridDim.x);
}

}  // namespace

// Once a device, before its first launch: the SM count and the opt-in
// shared memory a block may use on `device`, and the dynamic shared-memory
// limit of the count build and of every dual-loop instantiation raised to that
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
      reinterpret_cast<const void*>(dual_sgd_kernel<false, false>),
      reinterpret_cast<const void*>(dual_sgd_kernel<false, true>),
      reinterpret_cast<const void*>(dual_sgd_kernel<true, false>),
      reinterpret_cast<const void*>(dual_sgd_kernel<true, true>),
      reinterpret_cast<const void*>(count_build_kernel<int8_t>),
      reinterpret_cast<const void*>(count_build_kernel<float>),
      reinterpret_cast<const void*>(dual_tenants_kernel<false>),
      reinterpret_cast<const void*>(dual_tenants_kernel<true>),
  };
  for (const void* k : kernels)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, *shared_optin);
  const cudaError_t restored = cudaSetDevice(current);
  return (int)(err != cudaSuccess ? err : restored);
}

// B7: the whole dual loop for one batch, one cooperative launch on `stream`
// (the current device's, set up by twtml_gram_setup). g [>= rows, ldg] f32;
// u, y, mask [rows] f32; masks [iterations, rows] f32 or null; p_prev [1]
// f32; alpha_out [rows] f32; scratch [2·bp + 8·grid + 3] f32 (α's double
// buffer, the tests' partials; its last three floats receive c, the
// iterations run and the grid barriers crossed); spill [grid·spill_per_cta·bp] f32. The plan's values and
// `plan_layout` (host memory: dual_layout()'s offsets of the mask, u, y,
// α and G·α by parity, the scratch and the resident rows) come
// from ops/fused_gram.py dual_plan; a plan that differs is refused.
// `in_registers` 1 keeps the CTA's rows of G in registers (at most
// kDualRows rows, B <= 4·kDualThreads·kDualRegCols; nothing of G in shared
// memory or spilled). `residual_mode` 0 least squares, 1 logistic. Returns the
// launch's CUDA error (a refused cooperative launch included), 0 when it
// was taken.
extern "C" int twtml_dual_sgd(const void* g, long long ldg, const void* u, const void* y,
                              const void* mask, const void* masks, const void* p_prev,
                              void* alpha_out, void* scratch, void* spill, int rows, int bp,
                              int grid, int rows_cap, int resident, int spill_per_cta,
                              int in_registers, int shared_bytes, const int* plan_layout,
                              int num_iterations, float step_size, float l2_reg, float tol,
                              int residual_mode, void* stream) {
  const DualLayout lay = dual_layout(bp, rows_cap);
  const size_t offsets[] = {lay.mask, lay.u, lay.y, lay.a, lay.s, lay.red, lay.g};
  bool ok = rows >= 1 && ldg >= rows && bp >= rows && bp % 4 == 0 && grid >= 1 &&
            grid <= kDualMaxGrid &&
            (long long)rows_cap * grid >= rows && resident >= 0 && resident <= rows_cap &&
            spill_per_cta == rows_cap - resident && num_iterations >= 0 &&
            (residual_mode == 0 || residual_mode == 1) &&
            (in_registers == 0 || in_registers == 1) &&
            (size_t)shared_bytes >= lay.g + (size_t)(in_registers ? 0 : resident) * bp * 4;
  if (in_registers)
    ok = ok && rows_cap <= kDualRows && bp <= 4 * kDualThreads * kDualRegCols &&
         resident == rows_cap;
  for (int i = 0; i < 7; ++i) ok = ok && (size_t)plan_layout[i] == offsets[i];
  if (!ok) return (int)cudaErrorInvalidValue;
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
  p.partials = p.abuf + 2 * (size_t)bp;
  p.c_out = p.partials + 8 * (size_t)grid;
  p.iterations = p.c_out + 1;
  p.barriers = p.c_out + 2;
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
  const void* kernels[2][2] = {
      {reinterpret_cast<const void*>(dual_sgd_kernel<false, false>),
       reinterpret_cast<const void*>(dual_sgd_kernel<false, true>)},
      {reinterpret_cast<const void*>(dual_sgd_kernel<true, false>),
       reinterpret_cast<const void*>(dual_sgd_kernel<true, true>)},
  };
  return (int)cudaLaunchCooperativeKernel(kernels[residual_mode][in_registers], dim3(grid),
                                          dim3(kDualThreads), args, (size_t)shared_bytes,
                                          static_cast<cudaStream_t>(stream));
}

// The barrier probe: `crossings` of B7's grid barrier on `grid` CTAs of
// B7's block size, one cooperative launch on `stream`. Returns the launch's
// CUDA error.
extern "C" int twtml_dual_barrier_probe(int grid, int crossings, void* stream) {
  if (grid < 1 || grid > kDualMaxGrid || crossings < 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&crossings};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(barrier_probe_kernel),
                                          dim3(grid), dim3(kDualThreads), args, 0,
                                          static_cast<cudaStream_t>(stream));
}

// B4: idx [*, tokens] int32 and val [*, tokens] f32 (a batch's rows, or a
// tenant stack's [M·B]) -> out [out_row[tenants], cols] (kind 0: int8, 1:
// f32), a CTA a row of out (a single batch of B rows is one tenant:
// src_row 0, valid B, out_row {0, rows_out}): tenant u's block is rows [out_row[u],
// out_row[u + 1]), its first valid[u] rows counted from token row
// src_row[u] on, the rest zeros. Host arrays of `tenants` (out_row of
// tenants + 1, from 0). shared_bytes = count_layout(tokens)'s end. Returns
// the launch's CUDA error, 0 when it was taken.
extern "C" int twtml_count_build(const void* idx, const void* val, void* out, int tenants,
                                 int tokens, int features, int cols, int kind, int shared_bytes,
                                 const int* src_row, const int* valid, const int* out_row,
                                 void* stream) {
  if (tenants < 1 || tenants > kGramTenants || tokens < 1 || features < 1 || cols < features ||
      cols % 16 != 0 || (kind != 0 && kind != 1) || out_row[0] != 0 ||
      (size_t)shared_bytes != count_layout(tokens).end)
    return (int)cudaErrorInvalidValue;
  CountTenants t;
  t.tenants = tenants;
  t.out_row[0] = 0;
  for (int u = 0; u < kGramTenants; ++u) {
    const bool in = u < tenants;
    if (in && (src_row[u] < 0 || valid[u] < 0 || out_row[u + 1] - out_row[u] < valid[u]))
      return (int)cudaErrorInvalidValue;
    t.src_row[u] = in ? src_row[u] : 0;
    t.valid[u] = in ? valid[u] : 0;
    t.out_row[u + 1] = in ? out_row[u + 1] : out_row[tenants];
  }
  const int rows = out_row[tenants];
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    count_build_kernel<int8_t><<<rows, kCountThreads, shared_bytes, s>>>(
        static_cast<const int*>(idx), static_cast<const float*>(val), tokens, features,
        static_cast<int8_t*>(out), cols, t);
  else
    count_build_kernel<float><<<rows, kCountThreads, shared_bytes, s>>>(
        static_cast<const int*>(idx), static_cast<const float*>(val), tokens, features,
        static_cast<float*>(out), cols, t);
  return (int)cudaGetLastError();
}

// B7's tenant form: every tenant's dual loop in one cooperative launch on
// `stream`. u, y, mask [M·B] f32, numeric [M·B, 4] f32, masks [iterations,
// B] f32 or null, p_prev [M] f32 -> alpha_out [M, B], c_out and
// iterations [M] (each tenant's row m = slot[u]); abuf [2·abuf_floats],
// partials [8·grid] and spill f32 scratch. The plan's values and
// `plan_layout` (dual_layout(bp_max, rows_cap_max)'s offsets, as B7's)
// come from ops/fused_gram.py dual_tenants_plan; a plan that differs is
// refused. g[u]: tenant u's text G, int32 where g_int32[u], else f32, row
// stride ldg[u] (null for a dry tenant). `residual_mode` 0 least squares,
// 1 logistic. Returns the launch's CUDA error, 0 when it was taken.
extern "C" int twtml_dual_sgd_tenants(
    const void* u, const void* y, const void* mask, const void* numeric, const void* masks,
    const void* p_prev, void* alpha_out, void* c_out, void* iterations, void* abuf,
    void* partials, void* spill, long long abuf_floats, int tenants, int batch_rows, int grid,
    int bp_max, int rows_cap_max, int shared_bytes, const int* plan_layout,
    const int* first_cta, const int* valid, const int* slot, const int* rows_cap,
    const int* resident, const long long* spill_at, const long long* abuf_at,
    const void* const* g, const long long* ldg, const int* g_int32, const float* step_sizes,
    const float* l2_regs, int num_iterations, float tol, int residual_mode, void* stream) {
  const DualLayout lay = dual_layout(bp_max, rows_cap_max);
  const size_t offsets[] = {lay.mask, lay.u, lay.y, lay.a, lay.s, lay.red, lay.g};
  bool ok = tenants >= 1 && tenants <= kGramTenants && batch_rows >= 1 && grid >= 1 &&
            grid <= kDualMaxGrid && bp_max >= 4 && bp_max % 4 == 0 && rows_cap_max >= 1 &&
            abuf_floats >= 4 && abuf_floats % 4 == 0 && num_iterations >= 0 &&
            (residual_mode == 0 || residual_mode == 1) && first_cta[0] == 0 &&
            first_cta[tenants] == grid && (size_t)shared_bytes >= lay.g;
  for (int i = 0; i < 7; ++i) ok = ok && (size_t)plan_layout[i] == offsets[i];
  DualTenants t;
  t.tenants = tenants;
  t.batch_rows = batch_rows;
  t.first_cta[0] = 0;
  for (int w = 0; ok && w < kGramTenants; ++w) {
    const bool in = w < tenants;
    const int k = in ? first_cta[w + 1] - first_cta[w] : 0;
    const int v = in ? valid[w] : 0, bp = (v + 3) & ~3;
    if (in)
      ok = k >= 0 && v >= 0 && v <= batch_rows && bp <= bp_max && slot[w] >= 0 &&
           resident[w] >= 0 && resident[w] <= rows_cap[w] && rows_cap[w] <= rows_cap_max &&
           spill_at[w] >= 0 && abuf_at[w] >= 0 && abuf_at[w] % 4 == 0 &&
           abuf_at[w] + bp <= abuf_floats &&
           (size_t)shared_bytes >= lay.g + (size_t)resident[w] * bp * 4 &&
           (v == 0 || (k > 0 && (v + k - 1) / k <= rows_cap[w] && g[w] != nullptr &&
                       ldg[w] >= v));
    t.first_cta[w + 1] = in ? first_cta[w + 1] : grid;
    t.valid[w] = v;
    t.slot[w] = in ? slot[w] : 0;
    t.rows_cap[w] = in ? rows_cap[w] : 0;
    t.resident[w] = in ? resident[w] : 0;
    t.g_int32[w] = in ? g_int32[w] : 0;
    t.spill_at[w] = in ? spill_at[w] : 0;
    t.abuf_at[w] = in ? abuf_at[w] : 0;
    t.ldg[w] = in ? ldg[w] : 0;
    t.g[w] = in ? g[w] : nullptr;
    t.step_size[w] = in ? step_sizes[w] : 0.f;
    t.l2_reg[w] = in ? l2_regs[w] : 0.f;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  DualTenantParams p;
  p.u = static_cast<const float*>(u);
  p.y = static_cast<const float*>(y);
  p.mask = static_cast<const float*>(mask);
  p.numeric = static_cast<const float*>(numeric);
  p.masks = static_cast<const float*>(masks);
  p.p_prev = static_cast<const float*>(p_prev);
  p.alpha_out = static_cast<float*>(alpha_out);
  p.c_out = static_cast<float*>(c_out);
  p.iterations = static_cast<float*>(iterations);
  p.abuf = static_cast<float*>(abuf);
  p.partials = static_cast<float*>(partials);
  p.spill = static_cast<float*>(spill);
  p.abuf_floats = abuf_floats;
  p.bp_max = bp_max;
  p.rows_cap_max = rows_cap_max;
  p.num_iterations = num_iterations;
  p.tol = tol;
  void* args[] = {&p, &t};
  const void* kernel = residual_mode ? reinterpret_cast<const void*>(dual_tenants_kernel<true>)
                                     : reinterpret_cast<const void*>(dual_tenants_kernel<false>);
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kDualThreads), args,
                                          (size_t)shared_bytes, static_cast<cudaStream_t>(stream));
}

// B8: for each tenant u of `tenants` (a single batch of B rows is one
// tenant: slot, c_row and src_row 0, valid B), w_out[slot[u]] =
// c[slot[u]]·w_prev[slot[u]] + Cᵀα over its valid[u] rows of counts (from
// row c_row[u]; kind 0: int8, 1: f32; cols a multiple of 16) and α and
// numeric (from row src_row[u] of the [M·B] rows), as B8 on those rows.
// w_prev, w_out [M, features + 4], c [M] f32. Returns the launch's CUDA
// error.
extern "C" int twtml_dual_writeback(const void* counts, int kind, int cols, int features,
                                    const void* alpha, const void* c, const void* w_prev,
                                    const void* numeric, void* w_out, int tenants,
                                    const int* slot, const int* c_row, const int* valid,
                                    const int* src_row, void* stream) {
  if (tenants < 1 || tenants > kGramTenants || cols < features || cols % 16 != 0 ||
      features < 1 || (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  WritebackTenants t;
  t.tenants = tenants;
  for (int u = 0; u < kGramTenants; ++u) {
    const bool in = u < tenants;
    if (in && (slot[u] < 0 || c_row[u] < 0 || valid[u] < 0 || src_row[u] < 0))
      return (int)cudaErrorInvalidValue;
    t.slot[u] = in ? slot[u] : 0;
    t.c_row[u] = in ? c_row[u] : 0;
    t.valid[u] = in ? valid[u] : 0;
    t.src_row[u] = in ? src_row[u] : 0;
  }
  const dim3 blocks((features + kWbCols - 1) / kWbCols + 1, tenants);  // + the numeric block
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  const float* cp = static_cast<const float*>(c);
  const float* wp = static_cast<const float*>(w_prev);
  const float* num = static_cast<const float*>(numeric);
  float* wo = static_cast<float*>(w_out);
  if (kind == 0)
    writeback_kernel<int8_t><<<blocks, kWbThreads, 0, s>>>(
        static_cast<const int8_t*>(counts), cols, features, a, cp, wp, num, wo, t);
  else
    writeback_kernel<float><<<blocks, kWbThreads, 0, s>>>(
        static_cast<const float*>(counts), cols, features, a, cp, wp, num, wo, t);
  return (int)cudaGetLastError();
}
