// Row gather, row scatter-set and row scatter-add kernels for Hopper
// (sm_90a). Plain C interface, built by kernels/_build.py with nvcc and
// bound with ctypes in kernels/embedding_lookup.py, whose wrappers count
// launches (embedding_lookup.launches, embedding_scatter.launches,
// embedding_scatter_add.launches).
//
// The gather replaces src/repro/kernels/embedding_lookup.py:30
// embedding_lookup (_gather_kernel: a scalar-prefetch grid that DMAs one
// table row a step), out[i] = table[ids[i]]; the scatter-set replaces :122
// embedding_scatter (_scatter_set_kernel: an aliased in/out table written
// one row a step), table[ids[i]] = upd[i] with unique ids. Rows are copied
// as raw bytes, so any dtype is bit-exact and rows of any width work (D =
// 1, 8 and 9 float32 for the CTR arenas and the serve cache, 1,536 bf16
// for the LM's token rows). The copy word is the widest of 16/8/4/2/1
// bytes that divides the row's bytes and both pointers (the wrapper's
// copy_plan); a 36-byte row (D = 9) takes 4-byte words.
//
// What bounds them on this card: bytes, each row read once and written
// once plus 4 bytes of id a row (131,072 x 36-byte rows: 9.96 MB, 0.0030
// ms at 3.35 TB/s). A 36-byte row at a random 4-byte-aligned offset spans
// two 32-byte sectors, so a row read moves 64 bytes; and a batch the
// caller repeats sits in the 50 MB L2, where what is left is latency: the
// id's round trip before the row's, and how many words each thread keeps
// in flight. The design (see copy_narrow_kernel, copy_wide_kernel): warp
// tiles whose ids are loaded once, coalesced, and handed out by shuffle
// (the next tile's ids in flight with this tile's rows); every load of a
// lane issued before its first store; a row's word found by a 32-bit
// divide by a compile-time constant; a grid of what the card holds at
// once, walking the rest. Nothing is staged in shared memory: no byte is
// read twice.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (chip_smoke.py, scripts/compare_copy_kernels.py; graph replays, so the
// rows sit in L2), 131,072 ids into 2^21 rows: at D = 9 float32 the gather
// 0.0040 ms (index_select 0.0059; the one-thread-a-word kernel this
// replaced 0.0078) and the scatter-set 0.0056 ms (index_copy_ 0.0067;
// before 0.0073); at D = 1 and 8, 0.0025-0.0036 ms (before 0.0030-0.0039).
// The LM token gather, 8,192 x 3,072 bytes: 0.0165 ms, bound 0.0150. With
// a cold L2 at D = 9 (16 id batches in turn): 0.0070 and 0.0137 ms
// (index_select 0.0108, index_copy_ 0.0163). The scatter-set trails the
// gather at D = 9; that each 36-byte row it writes covers two 32-byte
// sectors in part is a likely cause, not isolated.
//
// The scatter-add is the LM's embedding gradient (the transpose of the
// token gather): table[ids[i]] += upd[i] with duplicate ids accumulating.
// It is bound by bytes too, and a long segment of one id by its chain of
// adds. See scatter_add_rows_kernel.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Replaces src/repro/kernels/embedding_lookup.py: embedding_scatter_add
// (_scatter_add_kernel), whose TPU grid walks the SORTED ids in sequence,
// so a row's duplicates meet one VMEM-resident block and `+=` in input
// order, rounding to the table's dtype after every add. Bit-equality with
// that leaves no freedom in the sums: each element's chain of adds is
// sequential, in input order, and a segment is never split into partial
// sums. What is parallel is the segments and the columns.
//
// What bounds it on this card: bytes (each update row read once, each
// distinct table row read and written once: 0.011 ms for the LM's 4,096 x
// 1,536 bf16 gradient at 3.35 TB/s), and for a long segment of one id the
// rate at which one warp streams rows through it. The design:
// - No permuted copy. The wrapper passes the stable sort's ids (int32) and
//   its `order` as torch.sort returns it (int64, so no cast launch);
//   sorted position j reads update row order[j] in place, through the
//   caller's row stride.
// - 16-byte lanes in column slices. A work item is (segment start, slice):
//   one warp, whose lanes each own one word of the row (16 bytes where the
//   pointers, the row and the stride allow, else 8, 4 or 2), so a warp
//   covers 512 bytes and a 1,536-wide bf16 row has 6 slices. A block holds
//   WARPS consecutive positions of one slice, and consecutive blocks hold
//   the slices of the same positions, so a segment's slices start
//   together, on different SMs. (On the H100 a slice-major grid started
//   the last slice of a 4,096-long segment ~7 us late, behind ~2,500
//   blocks of warps that exit.) Warps at positions that start no segment
//   exit at once. The segment's end is found by a warp-wide galloping
//   search over the sorted ids (one probe of 32 positions for a short
//   segment).
// - Long segments stream. The update rows go through a ring in shared
//   memory by cp.async, GROUP rows a commit group, predicated in PTX (no
//   branch), so the copies of a whole ring are in flight ahead of the
//   adds; `order` comes 32 rows a register and is broadcast by shuffles.
//   Each warp owns SHARE ring rows, and a segment takes the shares of the
//   warps it covers in its block (they exit), up to MAX_DEPTH rows.
//   On the H100 the short segments of a uniform batch run near the bytes
//   bound, and a long segment streams at ~16 ns a row. Which pipe sets
//   that rate is not known (the SM's pipes could not be profiled): not
//   the adds (dropping them changed nothing), and deeper rings, four
//   warps of one SM splitting the columns, quarters of a slice on other
//   SMs, the bulk copy engine (one 512-byte copy a row) and a ring of 16
//   or 32 rows in registers fed by plain loads were no faster.
// No float atomics: their order would change the sum from run to run.
//
// The add: f32 is __fadd_rn (so nvcc contracts nothing). bf16 is one
// correctly rounded add of two bf16 values (fma.rn.bf16x2 with a = x * 1,
// two lanes of a 32-bit word at once); the plain version adds in f32 and
// rounds to bf16, which is the same number, since f32's 24 bits >= 2 * 8 +
// 2 make the double rounding innocuous.
constexpr int WARPS = 8;           // warps (work items) per block
constexpr int SHARE = 8;           // ring rows of shared memory per warp
constexpr int GROUP = 4;           // rows a commit group, added in a batch
constexpr int DEEP_GROUP = 8;      // the same at MAX_DEPTH
constexpr int MAX_DEPTH = 64;      // rows in flight for a long segment
constexpr int MIN_BLOCKS = 4;      // resident blocks an SM (caps registers)
static_assert(WARPS * SHARE >= MAX_DEPTH, "");
constexpr unsigned FULL = 0xffffffffu;

// One lane's word from device memory into shared memory if `ok`,
// asynchronously (cp.async, predicated in PTX so that the caller has no
// branch; completion by commit and wait groups). There is no 2-byte
// cp.async: a 2-byte word (a bf16 row of odd width or alignment) is
// copied in place, which waits on its load.
template <typename V>
__device__ __forceinline__ void copy_async(bool ok, V* dst, const V* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(V) == 16) {
    asm volatile("{ .reg .pred p; setp.ne.b32 p, %2, 0;\n"
                 "  @p cp.async.cg.shared.global [%0], [%1], 16; }"
                 :: "r"(d), "l"(src), "r"((int)ok) : "memory");
  } else if constexpr (sizeof(V) >= 4) {
    asm volatile("{ .reg .pred p; setp.ne.b32 p, %2, 0;\n"
                 "  @p cp.async.ca.shared.global [%0], [%1], %3; }"
                 :: "r"(d), "l"(src), "r"((int)ok), "n"((int)sizeof(V))
                 : "memory");
  } else {
    if (ok) *dst = *src;
  }
}
__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_groups() {  // all but the newest N
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

template <bool BF16>
__device__ __forceinline__ uint32_t add_word(uint32_t a, uint32_t b) {
  if constexpr (BF16) {
    uint32_t d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;"
        : "=r"(d) : "r"(a), "r"(0x3F803F80u), "r"(b));
    return d;
  } else {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  }
}
template <bool BF16>
__device__ __forceinline__ uint4 add_vec(uint4 a, uint4 b) {
  return make_uint4(add_word<BF16>(a.x, b.x), add_word<BF16>(a.y, b.y),
                    add_word<BF16>(a.z, b.z), add_word<BF16>(a.w, b.w));
}
template <bool BF16>
__device__ __forceinline__ uint2 add_vec(uint2 a, uint2 b) {
  return make_uint2(add_word<BF16>(a.x, b.x), add_word<BF16>(a.y, b.y));
}
template <bool BF16>
__device__ __forceinline__ uint32_t add_vec(uint32_t a, uint32_t b) {
  return add_word<BF16>(a, b);
}
template <bool BF16>  // one bf16 (a row of odd bf16 width or alignment)
__device__ __forceinline__ uint16_t add_vec(uint16_t a, uint16_t b) {
  static_assert(BF16, "a 2-byte word is one bf16");
  float s = __fadd_rn(__uint_as_float((uint32_t)a << 16),
                      __uint_as_float((uint32_t)b << 16));
  return __bfloat16_as_ushort(__float2bfloat16_rn(s));
}

// The end of the segment of `id` that starts at sorted position i, given
// `hit`, the number of leading positions of [i, i + 32) that hold `id`.
// The ids are sorted, so they hold `id` exactly on [i, end): probe 32
// positions `step` apart, widening the step 32-fold while all match, then
// narrowing it 32-fold inside the last gap.
__device__ __forceinline__ long long segment_end(const int* __restrict__ ids,
                                                 long long n, long long i,
                                                 int id, int hit, int lane) {
  long long lo = i + hit - 1;      // ids[lo] == id
  if (hit < 32) return lo + 1;
  long long step = 32;
  bool grow = true;
  while (true) {
    long long p = lo + (long long)(lane + 1) * step;
    int h = __popc(__ballot_sync(FULL, p < n && ids[p] == id));
    if (h == 32 && grow) {
      lo += 32 * step;
      step *= 32;
      continue;
    }
    lo += h * step;                // ids[lo] == id, ids[lo + step] != id
    if (step == 1) return lo + 1;
    step /= 32;
    grow = false;
  }
}

__device__ __forceinline__ int load_order(const long long* __restrict__ order,
                                          long long p, long long end) {
  return p < end ? (int)order[p] : 0;
}

// Update row o's word: one 32 x 32 -> 64-bit multiply-add.
template <typename V>
__device__ __forceinline__ const V* row_word(const V* col, int o,
                                             unsigned ubytes) {
  return (const V*)((const char*)col + (unsigned long long)(unsigned)o * ubytes);
}

// Adds the `cnt` update rows of one segment (sorted positions i ..) into
// `acc`, streaming them through a ring of D rows of LW words in shared
// memory: row r lands in slot[r % D], G rows a cp.async commit group (an
// empty group past the segment's end). A group's rows are read into
// registers together and added in order; then their slots are refilled
// with the rows D further on. `order` comes 32 rows a register (a lane
// each), loaded a span (max(D, 32) rows) before its first use; `o0` holds
// the first 32. Lanes at or past LW are not `live`.
template <int D, int LW, typename V, bool BF16>
__device__ __forceinline__ V stream_rows(V (*slot)[LW], V acc,
                                         const V* __restrict__ col,
                                         unsigned ubytes,
                                         const long long* __restrict__ order,
                                         long long i, int cnt, int lane,
                                         bool live, int o0) {
  constexpr int G = D == MAX_DEPTH ? DEEP_GROUP : GROUP < D ? GROUP : D / 2;
  constexpr int SPAN = D > 32 ? D : 32;
  constexpr int NEED = (SPAN + D - 1) / 32 + 1;   // chunks a span refills from
  constexpr int NC = NEED + SPAN / 32;             // and the next span's
  static_assert(SPAN % D == 0 && D % G == 0 && D / G >= 2, "");
  const int w = lane & (LW - 1);                   // this lane's slot word
  const long long end = i + cnt;
  int ord[NC];
  ord[0] = o0;
#pragma unroll
  for (int c = 1; c < NEED; ++c) ord[c] = load_order(order, i + 32 * c + lane, end);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const int o = __shfl_sync(FULL, ord[k / 32], k % 32);
    copy_async(live && k < cnt, &slot[k][w], row_word(col, o, ubytes));
    if (k % G == G - 1) commit_group();
  }
  for (int base = 0; base < cnt; base += SPAN) {
#pragma unroll
    for (int c = NEED; c < NC; ++c)
      ord[c] = load_order(order, i + base + 32 * c + lane, end);
#pragma unroll
    for (int g = 0; g < SPAN; g += G) {
      if (base + g >= cnt) break;         // warp-uniform
      wait_groups<D / G - 1>();            // rows base + g .. have landed
      V v[G];
      int o[G];                            // the rows that refill the slots
#pragma unroll
      for (int j = 0; j < G; ++j) {
        v[j] = slot[(g + j) % D][w];
        o[j] = __shfl_sync(FULL, ord[(g + j + D) / 32], (g + j + D) % 32);
      }
#pragma unroll
      for (int j = 0; j < G; ++j)
        acc = live && base + g + j < cnt ? add_vec<BF16>(acc, v[j]) : acc;
#pragma unroll
      for (int j = 0; j < G; ++j)
        copy_async(live && base + g + j + D < cnt, &slot[(g + j) % D][w],
                   row_word(col, o[j], ubytes));
      commit_group();
    }
#pragma unroll
    for (int c = 0; c < NEED; ++c) ord[c] = ord[c + SPAN / 32];
  }
  return acc;
}

// stream_rows at the deepest ring the segment can use: D doubles while
// the segment is longer than D and `spare` warps' shares hold 2 D rows.
template <int D, typename V, bool BF16>
__device__ __forceinline__ V stream_deepest(int spare, V (*slot)[32], V acc,
                                            const V* __restrict__ col,
                                            unsigned ubytes,
                                            const long long* __restrict__ order,
                                            long long i, int cnt, int lane,
                                            bool live, int o0) {
  if constexpr (2 * D <= MAX_DEPTH) {
    if (cnt > D && spare * SHARE >= 2 * D)
      return stream_deepest<2 * D, V, BF16>(spare, slot, acc, col, ubytes,
                                            order, i, cnt, lane, live, o0);
  }
  return stream_rows<D, 32, V, BF16>(slot, acc, col, ubytes, order, i, cnt,
                                     lane, live, o0);
}

// table: (rows, wpr) words; ids: n int32 and order: n int64, the stable
// sort of the caller's ids and its permutation; upd: update rows `ubytes`
// bytes apart.
template <typename V, bool BF16>
__global__ void __launch_bounds__(32 * WARPS, MIN_BLOCKS)
scatter_add_rows_kernel(V* __restrict__ table, const int* __restrict__ ids,
                        const long long* __restrict__ order, long long n,
                        long long wpr, long long slices,
                        const V* __restrict__ upd, unsigned ubytes) {
  // SHARE ring rows per warp. A warp's positions are consecutive within
  // its slice, so the warps after a segment's first, up to its length,
  // exit below without touching the ring: their shares are the segment's
  // too (`spare`), and a long segment streams deeper.
  extern __shared__ uint4 ring_words[];
  V (*ring)[32] = (V (*)[32])ring_words;
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  const long long s = blockIdx.x % slices;  // consecutive blocks: slices
  const long long i = (long long)(blockIdx.x / slices) * WARPS + q;
  if (i >= n) return;
  // one load each for the first 32 positions' ids and order, before the
  // early exit, so that a short segment waits on memory twice in all
  const int win = i + lane < n ? ids[i + lane] : 0;
  const int oc = load_order(order, i + lane, n);
  const int prev = i > 0 ? ids[i - 1] : 0;
  const int id = __shfl_sync(FULL, win, 0);
  if (i > 0 && prev == id) return;        // not the segment's first
  const long long c = s * 32 + lane;      // this lane's word of the row
  const bool live = c < wpr;
  V* cell = table + (long long)id * wpr + c;
  V acc = live ? *cell : V{};
  const int hit = __popc(__ballot_sync(FULL, i + lane < n && win == id));
  const int cnt = (int)(segment_end(ids, n, i, id, hit, lane) - i);
  const int spare = WARPS - q < cnt ? WARPS - q : cnt;
  acc = stream_deepest<SHARE, V, BF16>(spare, ring + q * SHARE, acc, upd + c,
                                       ubytes, order, i, cnt, lane, live, oc);
  if (live) *cell = acc;
}

int word_bytes(const void* a, const void* b, long long row_bytes) {
  unsigned long long m =
      (unsigned long long)a | (unsigned long long)b | (unsigned long long)row_bytes;
  if (m % 16 == 0) return 16;
  if (m % 8 == 0) return 8;
  if (m % 4 == 0) return 4;
  if (m % 2 == 0) return 2;
  return 1;
}

// The row gather and the row scatter-set, in warp tiles. One kernel body
// serves both: the gather reads the addressed table rows and writes the
// rows contiguously, the scatter-set reads the rows contiguously and
// writes the addressed table rows (its ids are unique, so no two lanes
// write one word, and no atomics are needed). W is the copy word (16, 8,
// 4, 2 or 1 bytes); WPR the words a row when known at compile time (the
// widths the port runs), else 0 and `wpr` is read at run time.
constexpr int COPY_WARPS = 8;   // warps a block
constexpr int NARROW = 32;      // rows of fewer words go in narrow tiles
constexpr int CHUNK = 8;        // words in flight a lane where WPR is 0

template <typename W, bool SCATTER>
__device__ __forceinline__ W copy_load(const W* table, const W* rows,
                                       size_t cell, int flat, bool ok) {
  return ok ? __ldg(SCATTER ? rows + flat : table + cell) : W{};
}
template <typename W, bool SCATTER>
__device__ __forceinline__ void copy_store(W* table, W* rows, size_t cell,
                                           int flat, bool ok, W v) {
  if (ok) *(SCATTER ? table + cell : rows + flat) = v;
}

// Narrow rows (fewer than NARROW words): a warp owns a tile of 32
// consecutive positions. Lane l loads the tile's id l (one coalesced load,
// issued with the previous tile's rows), then moves the tile's flat words
// l, l + 32, ...: the word's row is a 32-bit divide by a compile-time
// constant (or a 16-bit multiply-shift, exact for the words of a tile when
// WPR is 0), its id comes by shuffle, and every load of the lane is issued
// before its first store. The tile's contiguous side covers consecutive
// rows, so those accesses are coalesced.
template <typename W, int WPR, bool SCATTER>
__global__ void __launch_bounds__(32 * COPY_WARPS)
copy_narrow_kernel(W* __restrict__ table, const int* __restrict__ ids, int n,
                   int wpr, W* __restrict__ rows) {
  constexpr int K = WPR > 0 ? WPR : CHUNK;
  const int words = WPR > 0 ? WPR : wpr;
  const unsigned magic = (65535u + words) / words;  // ceil(2^16 / words)
  const int lane = threadIdx.x & 31;
  const int tiles = (n + 31) >> 5, step = gridDim.x * COPY_WARPS;
  int t = blockIdx.x * COPY_WARPS + (threadIdx.x >> 5);
  int id = t < tiles && (t << 5) + lane < n ? __ldg(ids + (t << 5) + lane) : 0;
  for (; t < tiles; t += step) {
    const int base = t << 5, here = min(32, n - base), u = t + step;
    const int next =
        u < tiles && (u << 5) + lane < n ? __ldg(ids + (u << 5) + lane) : 0;
    W* tile = rows + (size_t)base * words;
    for (int k0 = 0; k0 < words; k0 += K) {  // one pass when WPR > 0
      W v[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int f = lane + 32 * (k0 + j);
        const int r = WPR > 0 ? f / WPR : (int)(((unsigned)f * magic) >> 16);
        const int rid = __shfl_sync(FULL, id, r & 31);
        const bool ok = (WPR > 0 || k0 + j < words) && r < here;
        v[j] = copy_load<W, SCATTER>(table, tile,
                                     (size_t)rid * words + (f - r * words), f,
                                     ok);
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int f = lane + 32 * (k0 + j);
        const int r = WPR > 0 ? f / WPR : (int)(((unsigned)f * magic) >> 16);
        const int rid = __shfl_sync(FULL, id, r & 31);
        const bool ok = (WPR > 0 || k0 + j < words) && r < here;
        copy_store<W, SCATTER>(table, tile,
                               (size_t)rid * words + (f - r * words), f, ok,
                               v[j]);
      }
    }
    id = next;
  }
}

// Wide rows (NARROW words or more, such as the LM's 3,072-byte token rows
// in 16-byte words): a warp a row. Its id is one load (the same address for
// every lane, one request), issued with the previous row's words; lane l
// moves words l, l + 32, ..., all loads before the first store (six 16-byte
// loads a lane for 3,072 bytes), in passes of CHUNK when WPR is 0.
template <typename W, int WPR, bool SCATTER>
__global__ void __launch_bounds__(32 * COPY_WARPS)
copy_wide_kernel(W* __restrict__ table, const int* __restrict__ ids, int n,
                 int wpr, W* __restrict__ rows) {
  constexpr int K = WPR > 0 ? (WPR + 31) / 32 : CHUNK;
  const int words = WPR > 0 ? WPR : wpr;
  const int lane = threadIdx.x & 31, step = gridDim.x * COPY_WARPS;
  int i = blockIdx.x * COPY_WARPS + (threadIdx.x >> 5);
  int id = i < n ? __ldg(ids + i) : 0;
  for (; i < n; i += step) {
    const int next = i + step < n ? __ldg(ids + i + step) : 0;
    W* row = rows + (size_t)i * words;
    const size_t cell = (size_t)id * words;
    for (int c0 = 0; c0 < words; c0 += 32 * K) {  // one pass when WPR > 0
      W v[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int c = c0 + lane + 32 * j;
        v[j] = copy_load<W, SCATTER>(table, row, cell + c, c, c < words);
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int c = c0 + lane + 32 * j;
        copy_store<W, SCATTER>(table, row, cell + c, c, c < words, v[j]);
      }
    }
    id = next;
  }
}

// Launches KERNEL over `work` warps of work: as many blocks as the card
// holds at once (SMs x resident blocks), the warps walking the rest.
template <auto KERNEL, typename W>
int launch_copy(long long work, W* table, const int* ids, int n, int wpr,
                W* rows, cudaStream_t s) {
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, KERNEL,
                                                  32 * COPY_WARPS, 0);
    return b > 0 ? b : 1;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long cap = (long long)(sms > 0 ? sms : 1) * per_sm;
  const long long want = (work + COPY_WARPS - 1) / COPY_WARPS;
  KERNEL<<<(unsigned)(want < cap ? want : cap), 32 * COPY_WARPS, 0, s>>>(
      table, ids, n, wpr, rows);
  return (int)cudaGetLastError();
}

template <typename W, bool SCATTER>
int copy_rows(void* table_, const int* ids, int n, int wpr, void* rows_,
              bool wide, cudaStream_t s) {
  W* table = (W*)table_;
  W* rows = (W*)rows_;
  if (wide) {
    if constexpr (sizeof(W) == 16)  // the LM's 1,536-wide bf16 rows
      if (wpr == 192)
        return launch_copy<copy_wide_kernel<W, 192, SCATTER>>(
            n, table, ids, n, wpr, rows, s);
    return launch_copy<copy_wide_kernel<W, 0, SCATTER>>(n, table, ids, n,
                                                        wpr, rows, s);
  }
  const long long tiles = (n + 31) / 32;
  if constexpr (sizeof(W) == 4) {   // D = 1 and 9 float32
    if (wpr == 1)
      return launch_copy<copy_narrow_kernel<W, 1, SCATTER>>(
          tiles, table, ids, n, wpr, rows, s);
    if (wpr == 9)
      return launch_copy<copy_narrow_kernel<W, 9, SCATTER>>(
          tiles, table, ids, n, wpr, rows, s);
  }
  if constexpr (sizeof(W) == 16)    // D = 8 float32
    if (wpr == 2)
      return launch_copy<copy_narrow_kernel<W, 2, SCATTER>>(
          tiles, table, ids, n, wpr, rows, s);
  return launch_copy<copy_narrow_kernel<W, 0, SCATTER>>(tiles, table, ids, n,
                                                        wpr, rows, s);
}

// The C entries' common part: checks the plan (word, wide) the wrapper
// made (kernels/embedding_lookup.py copy_plan) and launches.
template <bool SCATTER>
int copy_entry(void* table, long long row_bytes, const void* ids, long long n,
               void* rows, int word, int wide, void* stream) {
  const long long wpr = word > 0 ? row_bytes / word : 0;
  if (n < 0 || n >= (1LL << 30) || word < 1 || word > 16 ||
      (word & (word - 1)) || word_bytes(table, rows, row_bytes) < word ||
      wpr < 1 || wpr >= (1LL << 30) || (!wide && wpr >= NARROW))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* id = (const int*)ids;
  switch (word) {
    case 16: return copy_rows<uint4, SCATTER>(table, id, (int)n, (int)wpr, rows, wide, s);
    case 8: return copy_rows<uint2, SCATTER>(table, id, (int)n, (int)wpr, rows, wide, s);
    case 4: return copy_rows<uint32_t, SCATTER>(table, id, (int)n, (int)wpr, rows, wide, s);
    case 2: return copy_rows<uint16_t, SCATTER>(table, id, (int)n, (int)wpr, rows, wide, s);
    default: return copy_rows<uint8_t, SCATTER>(table, id, (int)n, (int)wpr, rows, wide, s);
  }
}
template <typename V, bool BF16>
int launch_scatter_add(void* table, const int* ids, const long long* order,
                       long long n, long long row_bytes, const void* upd,
                       long long ustride_bytes, cudaStream_t s) {
  const long long wpr = row_bytes / (long long)sizeof(V);
  const long long slices = (wpr + 31) / 32;
  const int threads = 32 * WARPS;
  const long long blocks = (n + WARPS - 1) / WARPS * slices;
  if (blocks > 0x7fffffffLL || ustride_bytes >= (1LL << 32))
    return (int)cudaErrorInvalidValue;
  const int ring = WARPS * SHARE * 32 * (int)sizeof(V);
  const cudaError_t e = cudaFuncSetAttribute(
      scatter_add_rows_kernel<V, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, ring);
  if (e != cudaSuccess) return (int)e;
  scatter_add_rows_kernel<V, BF16><<<(unsigned)blocks, threads, ring, s>>>(
      (V*)table, ids, order, n, wpr, slices, (const V*)upd,
      (unsigned)ustride_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table: (rows, d) of dtype (0 float32, 1 bfloat16), updated in place;
// ids: n int32 in [0, rows), SORTED by a stable sort; order: n int64, the
// sort's permutation (sorted position j adds update row order[j]); upd:
// rows of d elements of the table's dtype, `upd_stride` elements apart;
// word: the lane's bytes (16, 8, 4, or 2 for bf16), which must divide the
// pointers, the row and the stride (the wrapper's scatter_add_word).
// Returns cudaGetLastError() after launch, or cudaErrorInvalidValue.
int embedding_scatter_add(void* table, long long d, const void* ids,
                          const void* order, long long n, const void* upd,
                          long long upd_stride, int dtype, int word,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long size = dtype == 0 ? 4 : 2;
  const long long row = d * size, stride = upd_stride * size;
  if ((dtype != 0 && dtype != 1) || word < size || word > 16 ||
      (word & (word - 1)) || word_bytes(table, upd, row | stride) < word)
    return (int)cudaErrorInvalidValue;
  const int* id = (const int*)ids;
  const long long* ord = (const long long*)order;
  if (dtype == 0) {
    switch (word) {
      case 16: return launch_scatter_add<uint4, false>(table, id, ord, n, row, upd, stride, s);
      case 8: return launch_scatter_add<uint2, false>(table, id, ord, n, row, upd, stride, s);
      default: return launch_scatter_add<uint32_t, false>(table, id, ord, n, row, upd, stride, s);
    }
  }
  switch (word) {
    case 16: return launch_scatter_add<uint4, true>(table, id, ord, n, row, upd, stride, s);
    case 8: return launch_scatter_add<uint2, true>(table, id, ord, n, row, upd, stride, s);
    case 4: return launch_scatter_add<uint32_t, true>(table, id, ord, n, row, upd, stride, s);
    default: return launch_scatter_add<uint16_t, true>(table, id, ord, n, row, upd, stride, s);
  }
}

// The scatter-add's ring rows per warp (a segment longer than that
// streams deeper where its block's ring allows), for tests of segments
// around it.
int embedding_scatter_add_share() { return SHARE; }

// table: (rows, row_bytes) bytes; ids: n int32 in [0, rows); out: n rows,
// written; word, wide: the plan (kernels/embedding_lookup.py copy_plan):
// the bytes a lane moves at a time, which must divide both pointers and
// row_bytes, and whether a warp moves a row (1) or a tile of 32 rows (0,
// rows of fewer than 32 words). Returns cudaGetLastError() after launch,
// or cudaErrorInvalidValue.
int embedding_lookup(const void* table, long long row_bytes, const void* ids,
                     long long n, void* out, int word, int wide,
                     void* stream) {
  return copy_entry<false>((void*)table, row_bytes, ids, n, out, word, wide,
                           stream);
}

// table: (rows, row_bytes) bytes, written in place; ids: n UNIQUE int32 in
// [0, rows); upd: n rows of the table's dtype; word, wide: as above.
int embedding_scatter(void* table, long long row_bytes, const void* ids,
                      long long n, const void* upd, int word, int wide,
                      void* stream) {
  return copy_entry<true>(table, row_bytes, ids, n, (void*)upd, word, wide,
                          stream);
}

}  // extern "C"
