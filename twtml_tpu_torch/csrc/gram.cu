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
//   B8 write-back:   W_new = c·W_prev + Zᵀα from the batch's tokens
//                    (twtml_tpu/ops/gram.py dual_writeback).
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
// ---- B7, dual_tenants_kernel<kLogistic, kInRegisters, kProbe>: M tenants'
// dual loops in one launch (a single batch is the table of one tenant)
// Each iteration of a tenant of v rows is one [v, v]·[v] product (G·α) plus
// elementwise work on [v] vectors; the convergence test reads Δαᵀ·G·Δα,
// αᵀ·G·α, u·Δα and u·α. What bounds it: neither bytes nor operations of the
// arithmetic (Σ iterations·(2v² + 12v) f32: 8.4 MFLOP an iteration at B =
// 2048), but latency: a grid-wide barrier each iteration, since every
// row's next α needs the whole tenant's α. Design: one persistent
// cooperative launch, at most one CTA an SM; tenant u's CTAs are a run of
// the grid, in proportion to its v² rows of G (ops/fused_gram.py
// dual_tenants_plan), CTA k of them owning its rows [k·v/ctas,
// (k+1)·v/ctas). A CTA stages its rows of G once, its text G (f32, or the
// int8 plane's s32 product read as f32, exactly) with N·Nᵀ added in a fixed
// fma chain (a single batch's G holds N·Nᵀ already: read whole). When every
// tenant's CTAs hold at most 16 rows of at most 2048 columns (config #4's 4
// parts of ~515 rows, B = 2048) they live in registers across the loop
// (kInRegisters: 2 float4 columns of each row a thread); otherwise in
// shared memory, and rows that do not fit (B = 3072, 4096) are staged into
// a spill buffer and read through L2, in groups of up to 16 rows all
// resident or all spilled, a column's loads of a group issued together so
// that the spilled rows' L2 latencies overlap. An iteration (the tenant's
// update k):
//   1. if decisions are in (the last iteration's), the CTA reads them: if
//      its tenant's test k − 1 converged, α and G·α of that update (kept in
//      shared memory by parity) and its c are the result, the update made
//      since (if any) is dropped, and the tenant freezes; once every tenant
//      with rows froze, the grid leaves the loop together;
//   2. warp 0 updates α on the CTA's rows, a lane a row (r = residual(c·u
//      + G·α, y)·sel; α <- α·(1 − ηλ) − (η·r)/max(count, 1)), and publishes
//      them into the tenant's half of a global double buffer;
//   3. one grid barrier (cooperative groups' grid.sync());
//   4. the decider warp (the last) loads every CTA's partials of the
//      pending tests (lane λ CTAs λ + 32·i, 16 bytes each, all issued at
//      once) and, with more than one tenant with rows, each tenant's
//      (tested, c_new, c_old, p); G·α of the CTA's rows: every thread loads
//      its columns of the tenant's new α from L2 (16-byte loads, straight
//      into registers when G is there) against its columns of every row, a
//      reduce-scatter sums 16 rows across the warp, the warps in order;
//   5. warp 0 writes the partials of the tenant's test k over the CTA's
//      rows, from the one product: Δαᵀ·G·Δα as Σ Δα·(G·α_new − G·α_old) (a
//      CPU model holds the iterations this runs to the plain version's and
//      the JAX loop's: tests/test_torch_dual_form.py for one tenant,
//      tests/test_torch_dual_tenants_form.py for M), into a double buffer
//      by parity; meanwhile the decider sums the pending tests: at one
//      tenant B7's order (each lane's CTAs in i order, then warp_sum), with
//      more every tenant at once (the partials staged in shared memory by
//      CTA, L lanes a tenant, each its CTAs with stride L in order, then
//      their butterfly), the same bits in every CTA, off the path the other
//      warps wait on.
// So an iteration crosses one barrier, which also carries the last tests,
// and each tenant's update past its pending test is speculative. A tenant
// that froze updates no more, but its CTAs still cross the barriers. The
// last update crosses a barrier only when a test is pending (never at
// tolerance 0) and decides it at once. With one tenant with rows (B7) an
// iteration whose draws select no row is skipped whole, barrier included,
// and a loop that stops at iteration i < N crosses i + 1; with more,
// every iteration crosses one, and the launch ends at the top of the
// iteration after the barrier that decided the last freeze. The kernel
// writes the barriers it crossed. count is Σ mask·masks[i] over the
// tenant's rows, the same bits in every CTA of it; an iteration with count
// 0 makes no update of that tenant and is not its convergence. Rows with
// mask <= 0 are zeroed where they are staged (their u and y, their rows
// and columns of G), so NaN/Inf there is ignored; so is α's padding [v,
// bp) in the global buffers, once, since the product loads it as whole
// float4s. The update and the step scalars use the JAX loop's f32
// operations without contraction; the product sums in another order than
// torch's, so the plain version holds the kernel within tolerance. A dry
// tenant gets no CTA: CTA 0 writes its c = 1, α = 0 and N iterations. What
// is left is latency: an iteration is about one grid.sync() crossing (~1.1
// µs on an H100) plus L2 round trips and the CTA's own reductions. The
// timing instantiation (kProbe) stamps %globaltimer and clock64 at each
// phase edge in CTA 0 and each tenant's last CTA (dual_stamp); no launch
// the port makes for training uses it.
//
// ---- B8, writeback_kernel: W_new = c·W_prev + Zᵀα from the batch's tokens
// What it must move: the [B, L] tokens (8 bytes an occurrence), α and the
// numeric rows, and W read and written once (2·(F + 4)·4 bytes a tenant):
// 3.2 MB at B = 2048, L = 63, F = 2^18, under a microsecond at 3.35 TB/s.
// It reads no C. The work is a scatter of B·L occurrences into F columns,
// with heavy skew (synthetic tweets put ~1,500 occurrences in each of 85
// columns; padding and a model axis's clamped tokens pile into columns 0
// and f − 1), and no float atomics, so each column is summed in a fixed
// tree. One cooperative launch, two passes and one grid barrier:
//   1. the tile pass: tile k of tenant u is its occurrences [512·k, 512·k +
//      512) in (row, j) order. A CTA loads the tile's (idx, val) and α,
//      forms each contribution val·α (f32, rounded) and the key slot << 9
//      | position (the column's slot, wb_slot; 32 bits while the slots stay
//      below 2^23, else 64; an index outside [0, features) gets the all-ones
//      key: it counts nothing), sorts the keys
//      in shared memory (wb_sort: a bitonic network whose strides below 64
//      run in registers, a warp's 64 keys at a time, so 512 keys cross 10
//      barriers, not 45) and sums each column's run of the tile pairwise:
//      the run's positions r = 0, 2d, 4d, ... add r + d, for d = 1, 2, 4,
//      ..., all runs at once, a barrier a step. It writes the tile's runs
//      (slot, sum), compacted in slot order, and for each bucket (256 slots:
//      the 32 lines of 8 columns b, b + buckets, ..., so that the clusters
//      hashed text makes spread over the buckets) the tile's first run in
//      it: its row of a table [tiles][buckets + 1], one coalesced store.
//   2. the bucket pass, after the barrier: a CTA an item, an item a bucket
//      of a tenant (its 256 columns, a thread each; 8 threads a 32-byte
//      line of W) or a tenant's 4 numeric
//      columns. The CTA reads the bucket's run range of each of the
//      tenant's tiles from the table (2048 tiles at a time, 8 a thread, a
//      block scan of their counts) and gathers those tile sums in tile
//      order, at most 2048 at once; wb_sort by (column, gathered position)
//      puts each column's sums together in tile order. A column's sums are
//      added into its running pairwise sum, a binary counter of partial
//      sums (level l holding 2^l tile sums): so the sums of n tiles form
//      the same tree as the tile pass's pairwise steps over n (the larger
//      power-of-two block first, the rest after), whatever the windows. The
//      CTA adds, in parallel steps as the tile pass does, every block of
//      2^j sums aligned to the column's running count inside the window,
//      and the column's thread pushes the largest such blocks into the
//      counter: O(log n) pushes, not n, the same tree as n pushes. Then w =
//      c·w_prev + that sum, or exactly c·w_prev for a column no token hit.
//      The numeric item computes w_num·c + Nᵀα over the tenant's rows in
//      a fixed-order block reduction (exactly c·w_num for a dry tenant).
// So a column's sum is a tree of depth log2 of its occurrences, whatever
// the skew: one hot column is 512 occurrences a tile summed in nine
// parallel steps, then its tile sums in parallel steps of the bucket
// pass. The work is a sort: latency (the barriers, L2 round trips between
// the passes), not bytes, sets the time. The scratch (tile sums, the
// table) is a torch tensor: no allocation in the kernel, so CUDA graph
// capture takes it. tests/test_torch_writeback_form.py models this order
// in numpy (one tile sum pushed at a time) and holds it against the JAX
// scatter; fused_gram.dual_writeback_in_order computes it on the host.
//
// ---- The tenant forms: B4's, B7's and B8's tenant tables
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
//   barrier's latency): B7 itself over the table (above).
// - B8's (bound: bytes, each tenant's tokens, α and numeric rows, and its row
//   of W read and written): B8 itself over the table, each tenant's tiles
//   its own and its buckets keyed by tenant, so each tenant's row of W is
//   B8's on the same rows bit for bit (a dry tenant's is c·W_prev). The
//   tenants share a launch whatever their Gram planes: B8 reads no C.
// Over a data axis (the vmap inside shard_map, twtml_tpu/parallel/
// tenants.py:324-352) every rank gathers every tenant's rows, and tenant
// t's block holds its valid rows from every rank in rank order. B4's table
// takes one entry a (tenant, rank) segment, which skips each rank's
// padding, so a block is still B4's on its rows bit for bit. B7 runs
// replicated over the blocks, each tenant with its own draws
// (masks_tenants: a row of a block keeps its global position's draw). B8
// runs over this rank's rows of each block on zero weights (its table's
// token_row is the rank's first row of the tenant's gathered part, src_row
// the rank's first row of its block), and the ranks' sums are all-reduced.
//
// What Hopper offers and these designs leave out: tensor cores and TMA.
// B4 streams bytes and B8 sorts small tiles in shared memory; B7's
// product is matrix × vector (N = 1) on f32 operands, as the twin's, from
// a G that stays in registers: its time is the barrier's and L2's
// latency, which neither unit shortens. The G
// product itself runs on the tensor cores (cuBLASLt's int8 GEMM behind
// torch._int_mm).

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
constexpr int kWbWarps = kWbThreads / 32;
constexpr int kWbCols = kWbThreads;  // columns of a bucket: a thread each in the bucket pass
constexpr int kWbTileBits = 9;
constexpr int kWbTile = 1 << kWbTileBits;  // occurrences a tile of the tile pass
constexpr int kWbWindowBits = 11;
constexpr int kWbWindow = 1 << kWbWindowBits;  // tile sums the bucket pass sorts at once
constexpr int kWbDepth = 32;  // levels of a column's pairwise sum: 2^32 − 1 tile sums
constexpr int kWbGroupPer = 8;  // tiles a thread reads the table of at once in the bucket pass
constexpr int kWbGroup = kWbGroupPer * kWbThreads;  // tiles the bucket pass gathers from at once
constexpr int kGramTenants = 32;  // tenants a tenant-form launch: a lane of the decider warp each
// the tenant form's timing probe: phase edges it stamps, the prologue's
// (entry, G staged) then an iteration's (update, barrier 1, product,
// partials, barrier 2, decision)
constexpr int kDualProbePrologue = 2;
constexpr int kDualProbeIteration = 6;

// ops/fused_gram.py sizes the launches from its own copy of these
// constants; ops/_build.py passes that copy as -D flags, so the two cannot
// drift apart without the build failing here.
#if !defined(TWTML_GRAM_COUNT_THREADS) || !defined(TWTML_GRAM_COUNT_KEY_BYTES) || \
    !defined(TWTML_GRAM_DUAL_THREADS) || !defined(TWTML_GRAM_DUAL_ROWS) || \
    !defined(TWTML_GRAM_DUAL_REG_COLUMNS) || !defined(TWTML_GRAM_DUAL_MAX_GRID) || \
    !defined(TWTML_GRAM_DUAL_RED_FLOATS) || !defined(TWTML_GRAM_WRITEBACK_THREADS) || \
    !defined(TWTML_GRAM_WRITEBACK_COLUMNS) || !defined(TWTML_GRAM_TENANTS_PER_LAUNCH) || \
    !defined(TWTML_GRAM_DUAL_PROBE_PROLOGUE_EDGES) || !defined(TWTML_GRAM_DUAL_PROBE_ITERATION_EDGES) || \
    !defined(TWTML_GRAM_WRITEBACK_TILE) || !defined(TWTML_GRAM_WRITEBACK_WINDOW) || \
    !defined(TWTML_GRAM_WRITEBACK_GROUP)
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
static_assert(kWbTile == TWTML_GRAM_WRITEBACK_TILE, "WRITEBACK_TILE differs");
static_assert(kWbWindow == TWTML_GRAM_WRITEBACK_WINDOW, "WRITEBACK_WINDOW differs");
static_assert(kWbGroup == TWTML_GRAM_WRITEBACK_GROUP, "WRITEBACK_GROUP differs");
static_assert(kWbTile >= 64 && kWbWindow >= 64, "wb_sort sorts 64 keys or more");
static_assert(kWbTile <= 32767, "the tile pass keeps run heads and lengths as shorts");
static_assert(kWbCols == 256, "a bucket is 32 lines of 8 columns (wb_slot)");
static_assert(kWbCols < (1 << (32 - kWbWindowBits)), "a bucket pass key is column << 11 | position");
static_assert(kGramTenants == TWTML_GRAM_TENANTS_PER_LAUNCH, "TENANTS_PER_LAUNCH differs");
static_assert(kGramTenants <= 32, "the tenant form's decisions take a lane a tenant");
static_assert(kDualProbePrologue == TWTML_GRAM_DUAL_PROBE_PROLOGUE_EDGES,
              "DUAL_PROBE_PROLOGUE_EDGES differs");
static_assert(kDualProbeIteration == TWTML_GRAM_DUAL_PROBE_ITERATION_EDGES,
              "DUAL_PROBE_ITERATION_EDGES differs");

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

// Byte offsets of the dynamic shared memory, each 16-byte aligned: α of
// the whole batch [bp] at 0 (staged from L2 each iteration, when G's rows
// are not in registers), the mask [bp], then the CTA's rows: u and y
// [rows_cap] each, α and G·α [2][rows_cap] each (by the parity of the
// update that made them); the reduction scratch; the decisions' staging
// [stage] float4 (a launch of more than one tenant with rows: every CTA's
// test partials, for the decider's sums); then the resident rows of G
// [bp] f32 each (none when G's rows live in registers). The launch plan
// (ops/fused_gram.py dual_tenants_plan) computes the same.
struct DualLayout {
  size_t own, mask, u, y, a, s, red, stage, g;  // own: the stride of a [rows_cap] vector
};

__host__ __device__ inline DualLayout dual_layout(int bp, int rows_cap, int stage) {
  DualLayout l;
  const size_t vec = align16((size_t)bp * 4);
  l.own = align16((size_t)rows_cap * 4);
  l.mask = vec;
  l.u = 2 * vec;
  l.y = l.u + l.own;
  l.a = l.y + l.own;
  l.s = l.a + 2 * l.own;
  l.red = l.s + 2 * l.own;
  l.stage = l.red + kDualRedFloats * 4;
  l.g = l.stage + (size_t)stage * 16;
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

// ---- B7 over its tenant table: M dual loops in one cooperative launch (a
// single batch is the table of one tenant)

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
  // the timing probe (kProbe instantiations): [1 + tenants, probe_edges]
  // pairs of (%globaltimer, clock64), or null
  unsigned long long* probe;
  int probe_edges;
};

// kProbe only: after every thread of the CTA has reached it, thread 0 of a
// stamping CTA (slot >= 0: CTA 0 is slot 0, tenant u's last CTA slot 1 + u)
// writes the time at phase edge `edge`.
template <bool kProbe>
__device__ __forceinline__ void dual_stamp(const DualTenants& t, int slot, int edge) {
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

struct DualTenantParams {
  const float* u;        // [M·B] f32: Z·W_prev of every tenant's rows
  const float* y;        // [M·B]
  const float* mask;     // [M·B]
  const float* numeric;  // [M·B, 4]: N, whose N·Nᵀ the prologue adds to G; null: G holds it
  const float* masks;    // Bernoulli draws, or null: [iterations, B] every tenant shares,
                         // or each tenant's own [iterations, M, B] (masks_tenants = M)
  const float* p_prev;   // [M]: ||W_prev||² of each tenant
  float* alpha_out;      // [M, B]: zero past each tenant's valid rows
  float* c_out;          // [M]
  float* iterations;     // [M]: the iteration that converged, else N
  float* barriers;       // [1]: the grid barriers the launch crossed
  float* abuf;           // [2][abuf_floats]
  float* partials;       // [2][grid][8]: by parity, each CTA's test partials, then
                         // (tested, c_new, c_old, p) of its tenant's update
  float* spill;
  long long abuf_floats;
  int bp_max, rows_cap_max, stage, num_iterations;  // stage: the decisions' float4s
  int masks_tenants;  // 0: one [iterations, B] draw for every tenant; M: [iterations, M, B]
  float tol;
};

// G's element (r, k) of a tenant as B7 reads it, from its text G's row r
// (T: f32, or the int8 plane's s32 product, exact in f32): the text
// element plus, with kNumeric, (N·Nᵀ)[r, k] summed as one fixed fma chain
// (nr: N's row r); without it G holds N·Nᵀ already.
template <typename T, bool kNumeric>
__device__ __forceinline__ float g_element(const T* row, int k, const float (&nr)[4],
                                           const float* numeric) {
  const float text = (float)__ldg(row + k);
  if constexpr (kNumeric) {
    const float4 nk = __ldg(reinterpret_cast<const float4*>(numeric) + k);
    const float nn = fmaf(nr[3], nk.w, fmaf(nr[2], nk.z, fmaf(nr[1], nk.y, nr[0] * nk.x)));
    return __fadd_rn(text, nn);
  } else {
    return text;
  }
}

// N's row r where the row is kept (else 0), for g_element.
template <bool kNumeric>
__device__ __forceinline__ void numeric_row(const float* numeric, int r, bool keep,
                                            float (&nr)[4]) {
  float4 n = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (kNumeric)
    if (keep) n = __ldg(reinterpret_cast<const float4*>(numeric) + r);
  nr[0] = n.x;
  nr[1] = n.y;
  nr[2] = n.z;
  nr[3] = n.w;
}

// The CTA's rows [row0, row0 + my_rows) of a tenant's G into registers
// (kDualRegCols float4 columns of each row a thread), 0 where the row or
// the column is masked (mask_s is 0 past the tenant's rows).
template <typename T, bool kNumeric>
__device__ __forceinline__ void stage_registers(float4 (&greg)[kDualRows][kDualRegCols],
                                                const T* g, long long ldg, int row0,
                                                int my_rows, int bp, const float* mask_s,
                                                const float* numeric) {
#pragma unroll
  for (int j = 0; j < kDualRows; ++j) {
    const int r = row0 + j;
    const bool keep = j < my_rows && mask_s[r] > 0.f;
    float nr[4];
    numeric_row<kNumeric>(numeric, r, keep, nr);
    const T* src = g + (size_t)r * ldg;
#pragma unroll
    for (int q = 0; q < kDualRegCols; ++q) {
      const int c0 = 4 * (threadIdx.x + q * kDualThreads);
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        e[i] = keep && c0 + i < bp && mask_s[c0 + i] > 0.f
                   ? g_element<T, kNumeric>(src, c0 + i, nr, numeric)
                   : 0.f;
      greg[j][q] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
}

// The CTA's rows of a tenant's G, a warp a row: the first `resident` into
// shared memory (g_s, bp floats a row), the rest into the CTA's part of the
// spill buffer; 0 where the row or the column is masked.
template <typename T, bool kNumeric>
__device__ __forceinline__ void stage_rows(float* g_s, float* spill, const T* g, long long ldg,
                                           int row0, int my_rows, int resident, int bp,
                                           const float* mask_s, const float* numeric) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int l = warp; l < my_rows; l += kDualWarps) {
    const int r = row0 + l;
    const bool keep = mask_s[r] > 0.f;
    float nr[4];
    numeric_row<kNumeric>(numeric, r, keep, nr);
    float* dst = l < resident ? g_s + (size_t)l * bp : spill + (size_t)(l - resident) * bp;
    const T* src = g + (size_t)r * ldg;
#pragma unroll 4
    for (int i = lane; i < bp; i += 32)
      dst[i] = keep && mask_s[i] > 0.f ? g_element<T, kNumeric>(src, i, nr, numeric) : 0.f;
  }
}

// kInRegisters: every CTA's rows of G (at most kDualRows) live in
// registers, kDualRegCols float4 columns of each a thread, as B7's; else
// in shared memory, and past `resident` in the spill buffer, read through
// L2. kSolo: the launch has one tenant with rows (B7's own launch is one):
// every CTA is its, and the loop is B7's, an iteration that selects no row
// skipped whole (no barrier); else more than one. kProbe: the timing
// instantiation (dual_stamp), never a training launch's.
template <bool kLogistic, bool kInRegisters, bool kSolo, bool kProbe>
__global__ void __launch_bounds__(kDualThreads, 1)
    dual_tenants_kernel(const DualTenantParams p, const DualTenants t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DualLayout lay = dual_layout(p.bp_max, p.rows_cap_max, p.stage);
  float* alpha_s = reinterpret_cast<float*>(smem);
  float* mask_s = reinterpret_cast<float*>(smem + lay.mask);
  float* u_s = reinterpret_cast<float*>(smem + lay.u);
  float* y_s = reinterpret_cast<float*>(smem + lay.y);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  unsigned* flag = reinterpret_cast<unsigned*>(red + kRedFlag);  // the decisions' bits
  float4* stage_s = reinterpret_cast<float4*>(smem + lay.stage);
  const float4* g4_s = reinterpret_cast<const float4*>(smem + lay.g);
  // α and G·α of the CTA's rows made by an update of parity q
  const auto a_s = [&](int q) { return reinterpret_cast<float*>(smem + lay.a + q * lay.own); };
  const auto s_s = [&](int q) { return reinterpret_cast<float*>(smem + lay.s + q * lay.own); };

  cg::grid_group grid = cg::this_grid();
  const int cta = blockIdx.x, ncta = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int batch = t.batch_rows;
  // the tenant of CTA c (a dry tenant owns no CTA, unless every tenant is dry)
  const auto tenant_of = [&](int c) {
    int u = 0;
    while (u + 1 < t.tenants && t.first_cta[u + 1] <= c) ++u;
    return u;
  };
  const int me = tenant_of(cta);
  const int k = cta - t.first_cta[me], ctas = t.first_cta[me + 1] - t.first_cta[me];
  const int v = t.valid[me], bp = (v + 3) & ~3, nvec = bp / 4;
  const int row0 = (int)((long long)k * v / ctas);
  const int my_rows = (int)((long long)(k + 1) * v / ctas) - row0;
  const size_t base = (size_t)t.slot[me] * batch;
  const float* numeric = p.numeric ? p.numeric + 4 * base : nullptr;
  const bool test = p.tol > 0.f;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  unsigned live = 0;  // tenants with rows: the loop ends when each has converged
  for (int u = 0; u < t.tenants; ++u) live |= t.valid[u] > 0 ? 1u << u : 0u;
  constexpr bool solo = kSolo;
  const int slot = cta == 0 ? 0 : k == ctas - 1 ? 1 + me : -1;  // the probe's
  dual_stamp<kProbe>(t, slot, 0);

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
    a_s(0)[l] = 0.f;  // α = 0, the state before update 1
    s_s(0)[l] = 0.f;  // G·α with α = 0
  }
  const long long ab = t.abuf_at[me];
  // α's padding [v, bp) in both halves, which the updates never write but
  // G·α loads as whole float4s: zero, so that whatever the scratch held
  // there meets G's zero columns as 0. The first barrier orders these
  // writes before any load.
  if (k == 0 && v > 0)
    for (int i = v + tid; i < bp; i += kDualThreads)
      p.abuf[ab + i] = p.abuf[p.abuf_floats + ab + i] = 0.f;
  const int resident = t.resident[me];
  float* spill = p.spill + t.spill_at[me] + (size_t)k * (t.rows_cap[me] - resident) * bp;
  const void* g_text = t.g[me];
  const bool g_int32 = t.g_int32[me] != 0;
  const long long ldg = t.ldg[me];
  // mask_s is 0 past v: a masked row's or column's G is 0
  float4 greg[kInRegisters ? kDualRows : 1][kInRegisters ? kDualRegCols : 1];
  if (v > 0) {
    const auto stage = [&](auto kind, auto with_numeric) {
      using T = decltype(kind);
      constexpr bool kNumeric = decltype(with_numeric)::value;
      const T* g = static_cast<const T*>(g_text);
      if constexpr (kInRegisters)
        stage_registers<T, kNumeric>(greg, g, ldg, row0, my_rows, bp, mask_s, numeric);
      else
        stage_rows<T, kNumeric>(reinterpret_cast<float*>(smem + lay.g), spill, g, ldg, row0,
                                my_rows, resident, bp, mask_s, numeric);
    };
    using with = std::true_type;
    using without = std::false_type;
    if (g_int32)
      numeric ? stage(int(), with()) : stage(int(), without());
    else
      numeric ? stage(float(), with()) : stage(float(), without());
  }
  float count_all;
  {
    float s = 0.f;
    for (int i = tid; i < v; i += kDualThreads) s += mask_s[i];
    count_all = block_sum(s, red + kRedSum);  // also orders the staging before the loop
  }
  dual_stamp<kProbe>(t, slot, 1);
  const float pp = v > 0 ? __ldg(p.p_prev + t.slot[me]) : 0.f;
  const float step = t.step_size[me], l2 = t.l2_reg[me];

  // Each tenant's convergence test of an update: its CTAs' partials are
  // written after the update's G·α, into a double buffer by parity; the
  // decider warp of EVERY CTA loads them past the next barrier (the one
  // barrier an iteration crosses) and sums every tenant's during that
  // iteration's product, off the path the other warps wait on; the CTA
  // reads the decisions at the top of the iteration after. Where its
  // tenant's test converged, the speculative update made meanwhile (if
  // any) is dropped: α of the tested update (kept in shared memory by
  // parity) and its c are the result. Lane λ loads CTAs λ + 32·i (B7's
  // layout of the loads, all issued at once). With one tenant with rows
  // the sums are B7's: each lane's CTAs in i order, then the lanes by
  // warp_sum, and lane 0 decides from the CTA's own c. With more, the lanes
  // stage the partials in shared memory by CTA, and L lanes take each
  // tenant (L the largest power of two with L·tenants <= 32): lane j of
  // tenant u's sums its CTAs first + j, first + j + L, ... in order, the L
  // lanes' sums are added by a butterfly, and lane 0 of them decides tenant
  // u from the (tested, c_new, c_old, p) its first CTA wrote: every tenant
  // at once. The same bits in every CTA.
  const float4* part4 = reinterpret_cast<const float4*>(p.partials);
  float4 tq[kDualMaxGrid / 32];  // the decider's loads of a test's partials
  float4 tm = zero4;             // lane u·L: tenant u's (tested, c_new, c_old, p)
  // lanes a tenant in the decisions of more than one tenant with rows
  const int lanes = solo ? 32 : 32 >> (32 - __clz(t.tenants - 1));
  const int lane_tenant = lane / lanes, lane_j = lane % lanes;
  const auto load_partials = [&](int parity) {  // the decider warp
    const float4* part = part4 + (size_t)parity * 2 * ncta;
#pragma unroll
    for (int i = 0; i < kDualMaxGrid / 32; ++i) {
      const int c = lane + 32 * i;
      tq[i] = c < ncta ? __ldcg(part + 2 * (size_t)c) : zero4;
    }
    if (!solo)
      tm = lane_j == 0 && lane_tenant < t.tenants && t.valid[lane_tenant] > 0
               ? __ldcg(part + 2 * (size_t)t.first_cta[lane_tenant] + 1)
               : zero4;
  };
  // the test of an update (c_new, c_old, p) on its summed partials q:
  // dual_norm_sq of the step, Δc²·p + 2·Δc·(u·Δα) + Δαᵀ·G·Δα, against that
  // of the new state
  const auto converged = [&](float c_new, float c_old, float pq, const float (&q)[4]) {
    const float dc = c_new - c_old;
    const float d2 = dc * dc * pq + 2.f * dc * q[2] + q[0];
    const float n2 = c_new * c_new * pq + 2.f * c_new * q[3] + q[1];
    return sqrtf(d2) < p.tol * fmaxf(sqrtf(n2), 1.f);
  };
  // the decider warp, after load_partials; (c_new, c_old): the CTA's
  // tenant's tested update (read with one tenant with rows only)
  const auto decide = [&](float c_new, float c_old) {
    float q[4] = {0.f, 0.f, 0.f, 0.f};
    if (solo) {
#pragma unroll
      for (int i = 0; i < kDualMaxGrid / 32; ++i) {
        q[0] += tq[i].x;
        q[1] += tq[i].y;
        q[2] += tq[i].z;
        q[3] += tq[i].w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] = warp_sum(q[j]);
      if (lane == 0) *flag = converged(c_new, c_old, pp, q) ? 1u << me : 0u;
      return;
    }
#pragma unroll
    for (int i = 0; i < kDualMaxGrid / 32; ++i)
      if (lane + 32 * i < ncta) stage_s[lane + 32 * i] = tq[i];
    __syncwarp();
    if (lane_tenant < t.tenants)
      for (int c = t.first_cta[lane_tenant] + lane_j; c < t.first_cta[lane_tenant + 1];
           c += lanes) {
        const float4 x = stage_s[c];
        q[0] += x.x;
        q[1] += x.y;
        q[2] += x.z;
        q[3] += x.w;
      }
    for (int off = lanes >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] += __shfl_xor_sync(0xffffffffu, q[j], off);
    const bool conv = tm.x != 0.f && converged(tm.y, tm.z, tm.w, q);
    // tenant u's decision from lane u·L to lane u, then one bit a tenant
    const bool its = __shfl_sync(0xffffffffu, conv, (lane * lanes) & 31);
    const unsigned bits = __ballot_sync(0xffffffffu, lane < t.tenants && its);
    if (lane == 0) *flag = bits;
  };

  float c = 1.f, c_prev = 1.f;  // c of the CTA's tenant's latest state and of the one before
  int cur = 0;                  // the parity of its α and G·α in shared memory
  int ran = p.num_iterations, barriers = 0, pubs = 0, writes = 0;
  bool mine_frozen = !(live >> me & 1u);  // all dry: nothing to run
  unsigned frozen = 0;                    // tenants whose test converged
  int undecided = -1;    // the parity of partials awaiting the next barrier
  int undecided_it = 0;  // the iteration of the tenant's update tested there, 0: none
  bool decided = false;  // the decisions of the last barrier's tests await in *flag
  int decided_it = 0;    // the tenant's iteration among them
  float decided_c = 1.f;
  bool decided_spec = false;  // the tenant updated after that test
  bool finished = live == 0;
  for (int it = 1; it <= p.num_iterations && !finished; ++it) {
    // the iteration's draws of the tenant's rows: shared, or its own row of them
    const float* draw =
        p.masks ? p.masks + ((size_t)(it - 1) * (p.masks_tenants ? p.masks_tenants : 1) +
                             (p.masks_tenants ? t.slot[me] : 0)) * batch
                : nullptr;
    float count = count_all;
    if (draw && !mine_frozen) {
      float s = 0.f;
      for (int i = tid; i < v; i += kDualThreads) s += mask_s[i] * __ldg(draw + i);
      count = block_sum(s, red + kRedSum);
    }
    // an iteration that selects no row makes no update and is not convergence
    bool active = !mine_frozen && count > 0.f;
    if (solo && !active) continue;
    if (decided) {  // the decisions, before this update overwrites the tested α
      __syncthreads();
      const unsigned conv = *flag;
      decided = false;
      if (!mine_frozen && (conv >> me & 1u)) {
        ran = decided_it;
        c = decided_c;
        cur ^= solo || decided_spec ? 1 : 0;  // one tenant: the decision came with an update
        mine_frozen = true;
        active = false;
      }
      frozen |= conv;
      if (solo ? mine_frozen : (frozen & live) == live) {
        finished = true;
        break;
      }
    }
    // the JAX loop's f32 arithmetic, operation for operation
    const float eta = __fdiv_rn(step, __fsqrt_rn((float)it));
    const float scale = __fsub_rn(1.f, __fmul_rn(eta, l2));
    const float denom = fmaxf(count, 1.f);
    const bool last = it == p.num_iterations;
    const int nxt = cur ^ 1;
    pubs += active ? 1 : 0;
    float* a_pub = p.abuf + (size_t)(pubs & 1) * p.abuf_floats + ab;
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
        if (!last) a_pub[r] = a;
      }
    }
    const float c_new = active ? __fmul_rn(c, scale) : c;  // c·(1 − ηλ) − η·0/denom
    const int e0 = kDualProbePrologue + kDualProbeIteration * (it - 1);
    dual_stamp<kProbe>(t, slot, e0);
    if (last && undecided < 0) {  // nothing reads G·α or a test after the last update
      if (active) {
        cur = nxt;
        c = c_new;
      }
      finished = true;
      break;
    }
    grid.sync();
    ++barriers;
    dual_stamp<kProbe>(t, slot, e0 + 1);
    const bool deciding = undecided >= 0;
    if (deciding && warp == kDecider) load_partials(undecided);
    if (last) {  // the pending tests decide between this update and the tested one
      if (warp == kDecider) decide(c, c_prev);
      __syncthreads();
      if (!mine_frozen && (*flag >> me & 1u)) {
        ran = undecided_it;  // the tested state stays: this update is dropped
      } else if (active) {
        cur = nxt;
        c = c_new;
      }
      finished = true;
      break;
    }
    // ---- G·α_new of the CTA's rows: a thread's columns of every row (α of
    // the tenant, 16 bytes a load from L2), then the rows' sums across the
    // CTA in a fixed order
    float* s_new = s_s(nxt);
    if (active) {
      const float4* a4 = reinterpret_cast<const float4*>(a_pub);
      if constexpr (kInRegisters) {
        float4 av[kDualRegCols];
#pragma unroll
        for (int q = 0; q < kDualRegCols; ++q) {
          const int i = tid + q * kDualThreads;
          av[q] = i < nvec ? __ldcg(a4 + i) : zero4;
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
        for (int i = tid; i < nvec; i += kDualThreads)
          reinterpret_cast<float4*>(alpha_s)[i] = __ldcg(a4 + i);
        __syncthreads();
        const float4* alpha4 = reinterpret_cast<const float4*>(alpha_s);
        const float4* spill4 = reinterpret_cast<const float4*>(spill);
        const int kept = min(my_rows, resident);
        // groups of up to 16 rows, each all resident or all spilled
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
    }
    dual_stamp<kProbe>(t, slot, e0 + 2);
    // ---- the partials of this update's test over the CTA's rows in order
    // (lane l holds rows l, l + 32, ...; finish_rows wrote its s_new): the
    // one product gives Δαᵀ·G·Δα as Σ Δα·(G·α_new − G·α_old); a tenant that
    // made no update writes zeros and no test
    const int wpar = writes & 1;
    if (test && warp == 0) {
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
        float4* out = reinterpret_cast<float4*>(p.partials) + ((size_t)wpar * ncta + cta) * 2;
        out[0] = make_float4(qd, qa, ud, ua);
        if (!solo) out[1] = make_float4(active ? 1.f : 0.f, c_new, c, pp);
      }
    }
    dual_stamp<kProbe>(t, slot, e0 + 3);
    dual_stamp<kProbe>(t, slot, e0 + 4);  // no second barrier: an empty phase
    if (deciding) {  // the last tests, their loads landed during the product
      if (warp == kDecider) decide(c, c_prev);
      decided = true;
      decided_it = undecided_it;
      decided_c = c;
      decided_spec = active;
    }
    dual_stamp<kProbe>(t, slot, e0 + 5);
    undecided = test ? wpar : -1;
    undecided_it = active ? it : 0;
    writes += test ? 1 : 0;
    if (active) {
      cur = nxt;
      c_prev = c;
      c = c_new;
    }
  }
  if (solo && !finished) {  // the loop ran out, its last iterations selecting no row (B7's tail)
    if (decided) {
      __syncthreads();
      if (!mine_frozen && (*flag >> me & 1u)) {
        ran = decided_it;
        c = decided_c;
        cur ^= decided_spec ? 1 : 0;
        mine_frozen = true;
      }
    }
    if (undecided >= 0 && !mine_frozen) {  // one more barrier decides the last test
      grid.sync();
      ++barriers;
      if (warp == kDecider) {
        load_partials(undecided);
        decide(c, c_prev);
      }
      __syncthreads();
      if (*flag >> me & 1u) ran = undecided_it;
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
  if (cta == 0 && tid == 0) *p.barriers = (float)barriers;
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

// B8's tenant table (a single batch is one tenant): tenant u's valid[u]
// rows start at row token_row[u] of the [*, tokens] tokens and at row
// src_row[u] of the [*] α and [*, 4] numeric rows; its sums go to row
// slot[u] of the [M, features + 4] stacks, with c[slot[u]]; its tiles are
// [first_tile[u], first_tile[u + 1]) of the launch's.
struct WritebackTenants {
  int tenants;
  int slot[kGramTenants];
  int token_row[kGramTenants];
  int valid[kGramTenants];
  int src_row[kGramTenants];
  int first_tile[kGramTenants + 1];
};

struct WritebackParams {
  const int* idx;
  const float* val;
  const float* alpha;
  const float* c;
  const float* w_prev;
  const float* numeric;
  float* w_out;
  int* run_col;    // [tiles·kWbTile]: each tile's runs' column slots, compacted
  float* run_sum;  // [tiles·kWbTile]: their sums
  int* table;      // [tiles][buckets + 1]: a tile's first run in each bucket
  int tokens, features, buckets, tiles;
};

// The tile pass's shared memory, and the bucket pass's, in one buffer.
struct WbTileSmem {
  CountKey keys[kWbTile];  // slot << kWbTileBits | position, sorted (as K: 32 or 64 bits)
  union {
    float contrib[kWbTile];  // val·α by position, until the sums are staged
    int runs[kWbTile];       // then the runs' slots, compacted
  };
  float sums[kWbTile];      // by sorted position: the pairwise sums
  short head[kWbTile];      // by sorted position: the run's first
  short len[kWbTile];       // by sorted position: the run's length (0: no key)
  int scan[kWbWarps];
};
struct WbBucketSmem {
  unsigned keys[kWbWindow];   // slot in the bucket << kWbWindowBits | position
  float vals[kWbWindow];      // the gathered tile sums by position
  float sums[kWbWindow];      // by sorted position: the aligned block sums
  int pre[kWbGroup + 1];      // a group's tiles: the exclusive scan of their runs
  int first[kWbGroup];        // each tile's first run in the bucket
  int col_first[kWbCols];     // each column's first sorted position in the window
  int col_len[kWbCols];       // its tile sums in the window
  unsigned col_rank[kWbCols]; // its tile sums before the window (its running count)
  int scan[kWbWarps];
};
union WbSmem {
  WbTileSmem tile;
  WbBucketSmem bucket;
};

template <typename K>
__device__ __forceinline__ int lower_bound_in(const K* a, int n, K key) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (a[lo + half] < key) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// The exclusive prefix of each thread's v in thread order, the total in
// *total; scan [kWbWarps] is its scratch. The whole CTA calls it; it ends
// with a barrier.
__device__ int block_scan(int v, int* scan, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scan[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWbWarps; ++w) {
    before += w < warp ? scan[w] : 0;
    all += scan[w];
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// One compare-exchange step of a bitonic sort on a warp's 64 keys in
// registers: key x at index i (a at base + lane, b at base + 32 + lane),
// partner i ^ stride, the pair ascending where i & size is 0.
template <typename K>
__device__ __forceinline__ K wb_exchange(K x, K partner, int i, int stride, int size) {
  const bool low = (i & stride) == 0, ascending = (i & size) == 0;
  return low == ascending ? (partner < x ? partner : x) : (partner < x ? x : partner);
}

template <typename K>
__device__ __forceinline__ void wb_steps(K& a, K& b, int i, int size, int first_stride) {
  for (int stride = first_stride; stride > 0; stride >>= 1) {
    if (stride == 32) {  // a and b are the pair
      const bool ascending = (i & size) == 0;
      const K lo = b < a ? b : a, hi = b < a ? a : b;
      a = ascending ? lo : hi;
      b = ascending ? hi : lo;
    } else {
      const K pa = __shfl_xor_sync(0xffffffffu, a, stride);
      const K pb = __shfl_xor_sync(0xffffffffu, b, stride);
      a = wb_exchange(a, pa, i, stride, size);
      b = wb_exchange(b, pb, i + 32, stride, size);
    }
  }
}

// B8's ascending bitonic sort of keys[0, width) (a power of two, at least
// 64) by the whole CTA: every stride below 64 in registers, a warp's 64
// keys at a time (a shuffle a step, no barrier), the wider strides in
// shared memory, a barrier each; so a sort of 512 keys crosses 10
// barriers, not 45. The same network as bitonic_sort. Ends with a barrier.
template <typename K>
__device__ void wb_sort(K* keys, int width) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int size = 64; size <= width; size <<= 1) {
    for (int stride = size >> 1; stride >= 64; stride >>= 1) {
      for (int i = threadIdx.x; i < width / 2; i += kWbThreads) {
        const int lo = 2 * i - (i & (stride - 1));  // the pair (lo, lo + stride)
        const K a = keys[lo], c = keys[lo + stride];
        if ((a > c) == ((lo & size) == 0)) {
          keys[lo] = c;
          keys[lo + stride] = a;
        }
      }
      __syncthreads();
    }
    for (int base = 64 * warp; base < width; base += 64 * kWbWarps) {
      const int i = base + lane;
      K a = keys[i], b = keys[i + 32];
      if (size == 64) {  // sizes 2 to 64: every stride
        for (int s = 2; s <= 64; s <<= 1) wb_steps(a, b, i, s, s >> 1);
      } else {
        wb_steps(a, b, i, size, 32);
      }
      keys[i] = a;
      keys[i + 32] = b;
    }
    __syncthreads();
  }
}

// A column's running pairwise sum: a binary counter of partial sums, level
// l holding the sum of 2^l values. Adding n values one at a time gives the
// tree of the tile pass's pairwise steps over n values: x[r] += x[r + d]
// for r = 0, 2d, 4d, ... and d = 1, 2, 4, ..., the result x[0].
struct PairSum {
  float level[kWbDepth];
  unsigned count;
  // the pairwise sum of 2^l values that follow the count's multiple of
  // 2^l: as pushing them one at a time
  __device__ __forceinline__ void push(float v, int l = 0) {
    const unsigned added = 1u << l;
    for (unsigned n = count >> l; n & 1u; n >>= 1, ++l) v = __fadd_rn(level[l], v);
    level[l] = v;
    count += added;
  }
  __device__ __forceinline__ float total() const {  // count > 0
    float acc = 0.f;
    bool any = false;
    for (int l = 0; l < kWbDepth; ++l)
      if ((count >> l) & 1u) {
        acc = any ? __fadd_rn(level[l], acc) : level[l];
        any = true;
      }
    return acc;
  }
};

// A column's slot: bucket b holds the 32 lines of 8 columns b, b +
// buckets, b + 2·buckets, ... (a line a 32-byte sector of W), slots [256·b,
// 256·b + 256). Hashed text clusters (ASCII bigrams fill a few runs of
// columns), so neighbouring lines go to different buckets: a cluster's
// columns spread over the bucket pass's CTAs. The slot order only groups
// the columns; each column's sum is the same whatever its bucket.
__device__ __forceinline__ int wb_slot(int f, int buckets) {
  const int line = f >> 3;
  return (line % buckets) * kWbCols + (line / buckets) * 8 + (f & 7);
}

__device__ __forceinline__ int wb_column(int slot, int buckets) {
  const int local = slot & (kWbCols - 1);
  return ((local >> 3) * buckets + slot / kWbCols) * 8 + (local & 7);
}

// The tile pass on launch tile `tile`: its column runs' pairwise sums, and
// its row of the bucket table. K: the sort key, 32 bits where idx << 10 |
// position fits below the all-ones key, else 64.
template <typename K>
__device__ void wb_tile(const WritebackParams& p, const WritebackTenants& t, int tile,
                        WbTileSmem& s) {
  constexpr K kNone = ~K(0);
  K* keys = reinterpret_cast<K*>(s.keys);
  int u = 0;
  while (u + 1 < t.tenants && t.first_tile[u + 1] <= tile) ++u;
  const long long o0 = (long long)(tile - t.first_tile[u]) * kWbTile;
  const int n = (int)min((long long)kWbTile, (long long)t.valid[u] * p.tokens - o0);
  int width = 64;  // wb_sort's least
  while (width < n) width <<= 1;
  const int tid = threadIdx.x;
  const float* alpha = p.alpha + t.src_row[u];
  for (int i = tid; i < width; i += kWbThreads) {
    K key = kNone;
    if (i < n) {
      const long long o = o0 + i;
      const int r = (int)(o / p.tokens), j = (int)(o - (long long)r * p.tokens);
      const size_t at = (size_t)(t.token_row[u] + r) * p.tokens + j;
      const int f = __ldg(p.idx + at);
      s.contrib[i] = __fmul_rn(__ldg(p.val + at), __ldg(alpha + r));
      if (f >= 0 && f < p.features) key = ((K)wb_slot(f, p.buckets) << kWbTileBits) | (K)i;
    }
    keys[i] = key;
  }
  __syncthreads();
  wb_sort(keys, width);
  for (int i = tid; i < width; i += kWbThreads) {
    const K key = keys[i];
    int h = i, len = 0;
    if (key != kNone) {
      const K first = key >> kWbTileBits << kWbTileBits;
      h = lower_bound_in(keys, width, first);
      len = lower_bound_in(keys, width, (K)(first + (K)kWbTile)) - h;
      s.sums[i] = s.contrib[(int)(key & (K)(kWbTile - 1))];
    }
    s.head[i] = (short)h;
    s.len[i] = (short)len;
  }
  __syncthreads();
  // each run's pairwise sum, every run at once: step d adds r + d into r
  // for the run's positions r = 0, 2d, 4d, ...
  for (int d = 1; d < width; d <<= 1) {
    for (int i = tid; i < width; i += kWbThreads) {
      const int r = i - s.head[i];
      if ((r & (2 * d - 1)) == 0 && r + d < s.len[i]) s.sums[i] = __fadd_rn(s.sums[i], s.sums[i + d]);
    }
    __syncthreads();
  }
  // the runs, compacted in column order: thread tid's sorted positions
  // [e0, e1) in order
  const int per = (width + kWbThreads - 1) / kWbThreads;
  const int e0 = min(tid * per, width), e1 = min(e0 + per, width);
  int heads = 0;
  for (int i = e0; i < e1; ++i) heads += s.len[i] > 0 && s.head[i] == i;
  int runs;
  int k = block_scan(heads, s.scan, &runs);
  const size_t base = (size_t)tile * kWbTile;
  for (int i = e0; i < e1; ++i)
    if (s.len[i] > 0 && s.head[i] == i) {
      const int f = (int)(keys[i] >> kWbTileBits);  // the column's slot
      s.runs[k] = f;
      p.run_col[base + k] = f;
      p.run_sum[base + k] = s.sums[i];
      ++k;
    }
  __syncthreads();
  int* row = p.table + (size_t)tile * (p.buckets + 1);
  for (int b = tid; b <= p.buckets; b += kWbThreads) row[b] = lower_bound_in(s.runs, runs, b * kWbCols);
}

// The bucket pass on bucket b of tenant u: its 256 columns, a thread each.
// The tenant's tiles are read kWbGroup at a time (the table's counts, a
// block scan) and their tile sums in the bucket gathered in tile order,
// kWbWindow at a time, sorted by (column, gathered position). Column c's
// sums in a window are its tile sums of running ranks [k0, k0 + m): the
// window's steps add, in parallel, every aligned block of 2^j of them that
// lies inside (rank r ≡ 0 mod 2d adds r + d where r + 2d <= k0 + m), and
// the column's thread pushes the largest aligned blocks that cover [k0, k0
// + m), in order, into its running sum: the same tree as pushing each.
__device__ void wb_bucket(const WritebackParams& p, const WritebackTenants& t, int u, int b,
                          WbBucketSmem& s) {
  const int tid = threadIdx.x;
  PairSum sum;
  sum.count = 0;
  const int t1 = t.first_tile[u + 1];
  for (int g0 = t.first_tile[u]; g0 < t1; g0 += kWbGroup) {
    // this thread's kWbGroupPer tiles of the group: their counts at once
    int lo[kWbGroupPer], cnt[kWbGroupPer], mine = 0;
#pragma unroll
    for (int k = 0; k < kWbGroupPer; ++k) {
      const int gt = g0 + tid * kWbGroupPer + k;
      lo[k] = cnt[k] = 0;
      if (gt < t1) {
        const int* row = p.table + (size_t)gt * (p.buckets + 1) + b;
        lo[k] = __ldcg(row);
        cnt[k] = __ldcg(row + 1) - lo[k];
      }
      mine += cnt[k];
    }
    int total;
    int before = block_scan(mine, s.scan, &total);
#pragma unroll
    for (int k = 0; k < kWbGroupPer; ++k) {
      s.pre[tid * kWbGroupPer + k] = before;
      s.first[tid * kWbGroupPer + k] = lo[k];
      before += cnt[k];
    }
    if (tid == 0) s.pre[kWbGroup] = total;
    __syncthreads();
    for (int w0 = 0; w0 < total; w0 += kWbWindow) {
      const int n = min(kWbWindow, total - w0);
      int width = 64;  // wb_sort's least
      while (width < n) width <<= 1;
      for (int i = tid; i < width; i += kWbThreads) {
        unsigned key = ~0u;
        if (i < n) {
          const int g = w0 + i;
          const int k = lower_bound_in(s.pre, kWbGroup + 1, g + 1) - 1;  // the tile of entry g
          const size_t at = (size_t)(g0 + k) * kWbTile + s.first[k] + (g - s.pre[k]);
          s.vals[i] = __ldcg(p.run_sum + at);
          key = (unsigned)(__ldcg(p.run_col + at) - b * kWbCols) << kWbWindowBits | (unsigned)i;
        }
        s.keys[i] = key;
      }
      __syncthreads();
      wb_sort(s.keys, width);
      const unsigned own = (unsigned)tid << kWbWindowBits;
      const int a = lower_bound_in(s.keys, width, own);
      const int m = lower_bound_in(s.keys, width, own + (unsigned)kWbWindow) - a;
      s.col_first[tid] = a;
      s.col_len[tid] = m;
      s.col_rank[tid] = sum.count;
      for (int i = tid; i < width; i += kWbThreads) {
        const unsigned key = s.keys[i];
        if (key != ~0u) s.sums[i] = s.vals[key & (unsigned)(kWbWindow - 1)];
      }
      __syncthreads();
      for (int d = 1; d < width; d <<= 1) {
        for (int i = tid; i < width; i += kWbThreads) {
          const unsigned key = s.keys[i];
          if (key == ~0u) continue;
          const int c = (int)(key >> kWbWindowBits), q = i - s.col_first[c];
          const unsigned r = s.col_rank[c] + (unsigned)q;  // the running rank
          if ((r & (unsigned)(2 * d - 1)) == 0 && q + 2 * d <= s.col_len[c])
            s.sums[i] = __fadd_rn(s.sums[i], s.sums[i + d]);
        }
        __syncthreads();
      }
      // the largest aligned blocks covering this column's ranks, in order
      for (int q = 0; q < m;) {
        const unsigned r = sum.count;
        int l = 0;
        while (l < 31 && ((r >> l) & 1u) == 0 && q + (2 << l) <= m) ++l;
        sum.push(s.sums[a + q], l);
        q += 1 << l;
      }
      __syncthreads();
    }
  }
  const int col = wb_column(b * kWbCols + tid, p.buckets);
  if (col < p.features) {
    const size_t at = (size_t)t.slot[u] * (p.features + 4) + col;
    const float cw = __fmul_rn(__ldg(p.w_prev + at), __ldg(p.c + t.slot[u]));
    p.w_out[at] = sum.count ? __fadd_rn(cw, sum.total()) : cw;
  }
}

// Tenant u's 4 numeric columns: w_num·c + Nᵀα over its rows, each thread's
// rows in order, then the warp's butterfly, then the warps in order;
// exactly c·w_num for a dry tenant. red [4·kWbWarps] is its scratch.
__device__ void wb_numeric(const WritebackParams& p, const WritebackTenants& t, int u,
                           float* red) {
  const int tid = threadIdx.x, rows = t.valid[u];
  const float* alpha = p.alpha + t.src_row[u];
  const float* num = p.numeric + (size_t)t.src_row[u] * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = tid; r < rows; r += kWbThreads) {
    const float a = __ldg(alpha + r);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = fmaf(__ldg(num + 4 * (size_t)r + j), a, acc[j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = warp_sum(acc[j]);
  if ((tid & 31) == 0)
    for (int j = 0; j < 4; ++j) red[j * kWbWarps + (tid >> 5)] = acc[j];
  __syncthreads();
  if (tid < 4) {
    const size_t at = (size_t)t.slot[u] * (p.features + 4) + p.features + tid;
    const float cw = __fmul_rn(__ldg(p.w_prev + at), __ldg(p.c + t.slot[u]));
    float s = 0.f;
    for (int w = 0; w < kWbWarps; ++w) s += red[tid * kWbWarps + w];
    p.w_out[at] = rows ? __fadd_rn(cw, s) : cw;
  }
}

// B8: the tile pass over the launch's tiles, one grid barrier, the bucket
// pass over its items (each tenant's buckets, then its numeric columns).
// A cooperative launch: every CTA resident at once.
template <typename K>
__global__ void __launch_bounds__(kWbThreads) writeback_kernel(const WritebackParams p,
                                                               const WritebackTenants t) {
  __shared__ __align__(16) WbSmem smem;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    wb_tile<K>(p, t, tile, smem.tile);
    __syncthreads();
  }
  cg::this_grid().sync();
  const int per = p.buckets + 1;
  for (int item = blockIdx.x; item < t.tenants * per; item += gridDim.x) {
    const int u = item / per, b = item - u * per;
    if (b < p.buckets)
      wb_bucket(p, t, u, b, smem.bucket);
    else
      wb_numeric(p, t, u, smem.bucket.vals);
    __syncthreads();
  }
}

// every instantiation of B7's tenant form for a residual mode, as
// [in registers][one tenant with rows][probe]
#define DUAL_TENANT_KERNELS(logistic)                                                  \
  {                                                                                    \
    {{reinterpret_cast<const void*>(dual_tenants_kernel<logistic, false, false, false>), \
      reinterpret_cast<const void*>(dual_tenants_kernel<logistic, false, false, true>)}, \
     {reinterpret_cast<const void*>(dual_tenants_kernel<logistic, false, true, false>),  \
      reinterpret_cast<const void*>(dual_tenants_kernel<logistic, false, true, true>)}}, \
    {{reinterpret_cast<const void*>(dual_tenants_kernel<logistic, true, false, false>),  \
      reinterpret_cast<const void*>(dual_tenants_kernel<logistic, true, false, true>)},  \
     {reinterpret_cast<const void*>(dual_tenants_kernel<logistic, true, true, false>),   \
      reinterpret_cast<const void*>(dual_tenants_kernel<logistic, true, true, true>)}}   \
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
      reinterpret_cast<const void*>(count_build_kernel<int8_t>),
      reinterpret_cast<const void*>(count_build_kernel<float>),
  };
  const void* dual[2][2][2][2] = {DUAL_TENANT_KERNELS(false), DUAL_TENANT_KERNELS(true)};
  for (const void* k : kernels)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, *shared_optin);
  for (int i = 0; i < 16; ++i)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute((&dual[0][0][0][0])[i],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, *shared_optin);
  const cudaError_t restored = cudaSetDevice(current);
  return (int)(err != cudaSuccess ? err : restored);
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
// `stream` (B7 itself is the table of one tenant). u, y, mask [M·B] f32,
// numeric [M·B, 4] f32 (null: each G holds N·Nᵀ already), masks
// [iterations, B] f32 every tenant shares (masks_tenants 0), each tenant's
// own [iterations, masks_tenants, B] (tenant u's at row slot[u]: the rows of
// a data axis's gathered blocks, each tenant's at its own global
// positions), or null, p_prev [M] f32 -> alpha_out [M, B], c_out
// and iterations [M] (each tenant's row m = slot[u]), barriers [1] (the
// grid barriers the launch crossed); abuf [2·abuf_floats], partials
// [16·grid] and spill f32 scratch. The plan's values and `plan_layout`
// (dual_layout(bp_max, rows_cap_max, stage)'s offsets, stage = grid where
// more than one tenant has rows, else 0) come from ops/fused_gram.py
// dual_tenants_plan; a plan that differs is refused.
// `in_registers` 1 keeps every CTA's rows of G in registers (each tenant at
// most kDualRows rows a CTA, bp <= 4·kDualThreads·kDualRegCols; nothing of G
// in shared memory or spilled). g[u]: tenant u's text G, int32 where
// g_int32[u], else f32, row stride ldg[u] (null for a dry tenant).
// `residual_mode` 0 least squares, 1 logistic. `probe` (or null): the
// timing instantiation's stamps [1 + tenants, probe_edges] of (globaltimer,
// clock64). Returns the launch's CUDA error, 0 when it was taken.
extern "C" int twtml_dual_sgd_tenants(
    const void* u, const void* y, const void* mask, const void* numeric, const void* masks,
    int masks_tenants, const void* p_prev, void* alpha_out, void* c_out, void* iterations,
    void* barriers, void* abuf, void* partials, void* spill, long long abuf_floats, int tenants,
    int batch_rows, int grid, int bp_max, int rows_cap_max, int shared_bytes, int in_registers,
    const int* plan_layout, const int* first_cta, const int* valid, const int* slot,
    const int* rows_cap, const int* resident, const long long* spill_at,
    const long long* abuf_at, const void* const* g, const long long* ldg, const int* g_int32,
    const float* step_sizes, const float* l2_regs, int num_iterations, float tol,
    int residual_mode, void* probe, int probe_edges, void* stream) {
  int live = 0;  // tenants with rows: more than one stage the decisions
  for (int w = 0; w < tenants && w < kGramTenants; ++w) live += valid[w] > 0 ? 1 : 0;
  const int stage = live > 1 ? grid : 0;
  const DualLayout lay = dual_layout(bp_max, rows_cap_max, stage);
  const size_t offsets[] = {lay.mask, lay.u, lay.y, lay.a, lay.s, lay.red, lay.stage, lay.g};
  bool ok = tenants >= 1 && tenants <= kGramTenants && batch_rows >= 1 && grid >= 1 &&
            grid <= kDualMaxGrid && bp_max >= 4 && bp_max % 4 == 0 && rows_cap_max >= 1 &&
            abuf_floats >= 4 && abuf_floats % 4 == 0 && num_iterations >= 0 &&
            (residual_mode == 0 || residual_mode == 1) &&
            (in_registers == 0 || in_registers == 1) && first_cta[0] == 0 &&
            masks_tenants >= 0 &&
            first_cta[tenants] == grid && (size_t)shared_bytes >= lay.g && barriers != nullptr &&
            (probe == nullptr || probe_edges >= 1);
  for (int i = 0; i < 8; ++i) ok = ok && (size_t)plan_layout[i] == offsets[i];
  DualTenants t;
  t.probe = static_cast<unsigned long long*>(probe);
  t.probe_edges = probe ? probe_edges : 0;
  t.tenants = tenants;
  t.batch_rows = batch_rows;
  t.first_cta[0] = 0;
  for (int w = 0; ok && w < kGramTenants; ++w) {
    const bool in = w < tenants;
    const int k = in ? first_cta[w + 1] - first_cta[w] : 0;
    const int v = in ? valid[w] : 0, bp = (v + 3) & ~3;
    if (in)
      ok = k >= 0 && v >= 0 && v <= batch_rows && bp <= bp_max && slot[w] >= 0 &&
           (masks_tenants == 0 || slot[w] < masks_tenants) &&
           resident[w] >= 0 && resident[w] <= rows_cap[w] && rows_cap[w] <= rows_cap_max &&
           spill_at[w] >= 0 && abuf_at[w] >= 0 && abuf_at[w] % 4 == 0 &&
           abuf_at[w] + bp <= abuf_floats &&
           (size_t)shared_bytes >= lay.g + (size_t)(in_registers ? 0 : resident[w]) * bp * 4 &&
           (v == 0 || (k > 0 && (v + k - 1) / k <= rows_cap[w] && g[w] != nullptr &&
                       ldg[w] >= v)) &&
           (!in_registers || (rows_cap[w] <= kDualRows &&
                              bp <= 4 * kDualThreads * kDualRegCols &&
                              resident[w] == rows_cap[w]));
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
  p.masks_tenants = masks_tenants;
  p.p_prev = static_cast<const float*>(p_prev);
  p.alpha_out = static_cast<float*>(alpha_out);
  p.c_out = static_cast<float*>(c_out);
  p.iterations = static_cast<float*>(iterations);
  p.barriers = static_cast<float*>(barriers);
  p.abuf = static_cast<float*>(abuf);
  p.partials = static_cast<float*>(partials);
  p.spill = static_cast<float*>(spill);
  p.abuf_floats = abuf_floats;
  p.bp_max = bp_max;
  p.rows_cap_max = rows_cap_max;
  p.stage = stage;
  p.num_iterations = num_iterations;
  p.tol = tol;
  void* args[] = {&p, &t};
  // [residual mode][in registers][one tenant with rows][probe]
  const void* kernels[2][2][2][2] = {
      DUAL_TENANT_KERNELS(false),
      DUAL_TENANT_KERNELS(true),
  };
  const void* kernel = kernels[residual_mode][in_registers][live == 1][probe != nullptr];
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kDualThreads), args,
                                          (size_t)shared_bytes, static_cast<cudaStream_t>(stream));
}

// B8's cooperative launch's CTAs an SM at most, on the current device (the
// occupancy of writeback_kernel at its block size). Returns a CUDA error.
extern "C" int twtml_writeback_blocks_per_sm(int* blocks) {
  int wide = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, reinterpret_cast<const void*>(writeback_kernel<unsigned>), kWbThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &wide, reinterpret_cast<const void*>(writeback_kernel<CountKey>), kWbThreads, 0);
  *blocks = wide < *blocks ? wide : *blocks;
  return (int)err;
}

// B8: for each tenant u of `tenants` (a single batch of B rows is one
// tenant: slot, token_row and src_row 0, valid B), w_out[slot[u]] =
// c[slot[u]]·w_prev[slot[u]] + Σ val·α over the occurrences of its valid[u]
// token rows (idx int32 and val f32 [*, tokens], from row token_row[u]; an
// index outside [0, features) counts nothing) with α of its rows (from row
// src_row[u] of α [*] f32), and w_num·c + Nᵀα over its numeric rows ([*, 4]
// f32, from row src_row[u]). w_prev, w_out [M, features + 4] (not the same
// memory), c [M] f32. scratch: `scratch_ints` 4-byte words, at least
// writeback_scratch_ints' (ops/fused_gram.py). One cooperative launch of
// `grid` CTAs on `stream`. Returns the launch's CUDA error.
extern "C" int twtml_dual_writeback(const void* idx, const void* val, int tokens, int features,
                                    const void* alpha, const void* c, const void* w_prev,
                                    const void* numeric, void* w_out, void* scratch,
                                    long long scratch_ints, int grid, int tenants,
                                    const int* slot, const int* token_row, const int* valid,
                                    const int* src_row, void* stream) {
  if (tenants < 1 || tenants > kGramTenants || tokens < 1 || features < 1 || grid < 1 ||
      features > INT_MAX - kWbCols - 4 || w_prev == w_out)
    return (int)cudaErrorInvalidValue;
  WritebackTenants t;
  t.tenants = tenants;
  t.first_tile[0] = 0;
  long long tiles = 0;
  for (int u = 0; u < kGramTenants; ++u) {
    const bool in = u < tenants;
    if (in && (slot[u] < 0 || token_row[u] < 0 || valid[u] < 0 || src_row[u] < 0))
      return (int)cudaErrorInvalidValue;
    t.slot[u] = in ? slot[u] : 0;
    t.token_row[u] = in ? token_row[u] : 0;
    t.valid[u] = in ? valid[u] : 0;
    t.src_row[u] = in ? src_row[u] : 0;
    if (in) tiles += ((long long)valid[u] * tokens + kWbTile - 1) / kWbTile;
    if (tiles > INT_MAX / kWbTile) return (int)cudaErrorInvalidValue;
    t.first_tile[u + 1] = (int)tiles;
  }
  WritebackParams p;
  p.tokens = tokens;
  p.features = features;
  p.buckets = (features + kWbCols - 1) / kWbCols;
  p.tiles = (int)tiles;
  const long long runs = tiles * kWbTile;
  if (scratch_ints < 2 * runs + (p.buckets + 1LL) * tiles || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  p.idx = static_cast<const int*>(idx);
  p.val = static_cast<const float*>(val);
  p.alpha = static_cast<const float*>(alpha);
  p.c = static_cast<const float*>(c);
  p.w_prev = static_cast<const float*>(w_prev);
  p.numeric = static_cast<const float*>(numeric);
  p.w_out = static_cast<float*>(w_out);
  p.run_col = static_cast<int*>(scratch);
  p.run_sum = reinterpret_cast<float*>(p.run_col + runs);
  p.table = p.run_col + 2 * runs;
  void* args[] = {&p, &t};
  // 32-bit sort keys where slot << kWbTileBits | position stays below ~0u
  const void* kernel = (long long)p.buckets * kWbCols <= (long long)(UINT_MAX >> kWbTileBits)
                           ? reinterpret_cast<const void*>(writeback_kernel<unsigned>)
                           : reinterpret_cast<const void*>(writeback_kernel<CountKey>);
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kWbThreads), args, 0,
                                          static_cast<cudaStream_t>(stream));
}
