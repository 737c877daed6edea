// Row gather, row scatter-set and row scatter-add kernels for Hopper
// (sm_90a). Plain C interface, built by kernels/_build.py with nvcc and
// bound with ctypes in kernels/embedding_lookup.py, whose wrappers count
// launches (embedding_lookup.launches, embedding_scatter.launches,
// embedding_scatter_add.launches).
//
// Rows are copied as raw bytes, so any dtype is bit-exact and rows of any
// width work (D = 1 for the LR "w" group, 8 for FM "v", 9 for the serve
// cache's combined row). The copy word is the widest of 16/8/4/2/1 bytes
// that divides the row's byte width and the pointers' alignment; one
// thread copies one word, so a row is copied by a group of consecutive
// threads and neighbouring threads touch neighbouring addresses.
//
// What bounds both on this card is bytes moved: each row read once and
// written once, plus 4 bytes of id per row. Rows of a few tens of bytes
// at random table rows cost whole 32-byte sectors, so narrow rows run
// below the device's stream rate; nothing is staged in shared memory
// because no byte is read twice.
//
// The scatter-add is the LM's embedding gradient (the transpose of the
// token gather): table[ids[i]] += upd[i] with duplicate ids accumulating.
// It is bound by bytes too, and a long segment of one id by its chain of
// adds. See scatter_add_rows_kernel.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Replaces src/repro/kernels/embedding_lookup.py: embedding_lookup
// (_gather_kernel), where a scalar-prefetch grid DMAs one table row per
// step. out[i] = table[ids[i]], ids int32 and in bounds.
template <typename W>
__global__ void gather_rows_kernel(const W* __restrict__ table,
                                   const int* __restrict__ ids, long long n,
                                   long long wpr, W* __restrict__ out) {
  long long total = n * wpr;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    long long i = t / wpr;
    long long c = t - i * wpr;
    out[t] = table[(long long)ids[i] * wpr + c];
  }
}

// Replaces src/repro/kernels/embedding_lookup.py: embedding_scatter
// (_scatter_set_kernel), an aliased in/out table whose grid writes one
// row per step. table[ids[i]] = upd[i] in place; ids UNIQUE, so no two
// threads write one word.
template <typename W>
__global__ void scatter_rows_kernel(W* __restrict__ table,
                                    const int* __restrict__ ids, long long n,
                                    long long wpr,
                                    const W* __restrict__ upd) {
  long long total = n * wpr;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    long long i = t / wpr;
    long long c = t - i * wpr;
    table[(long long)ids[i] * wpr + c] = upd[t];
  }
}

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

unsigned grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  const long long cap = 132LL * 32;  // SMs x resident blocks, grid-stride beyond
  return (unsigned)(blocks < cap ? blocks : cap);
}

template <typename W>
void launch_gather(const void* table, const int* ids, long long n,
                   long long row_bytes, void* out, cudaStream_t s) {
  long long wpr = row_bytes / (long long)sizeof(W);
  const int threads = 256;
  gather_rows_kernel<W><<<grid_for(n * wpr, threads), threads, 0, s>>>(
      (const W*)table, ids, n, wpr, (W*)out);
}

template <typename W>
void launch_scatter(void* table, const int* ids, long long n,
                    long long row_bytes, const void* upd, cudaStream_t s) {
  long long wpr = row_bytes / (long long)sizeof(W);
  const int threads = 256;
  scatter_rows_kernel<W><<<grid_for(n * wpr, threads), threads, 0, s>>>(
      (W*)table, ids, n, wpr, (const W*)upd);
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

// table: (rows, row_bytes) bytes; ids: n int32 in [0, rows); out: n rows.
// Returns cudaGetLastError() after launch.
int embedding_lookup(const void* table, long long row_bytes, const void* ids,
                     long long n, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* id = (const int*)ids;
  switch (word_bytes(table, out, row_bytes)) {
    case 16: launch_gather<uint4>(table, id, n, row_bytes, out, s); break;
    case 8: launch_gather<uint2>(table, id, n, row_bytes, out, s); break;
    case 4: launch_gather<uint32_t>(table, id, n, row_bytes, out, s); break;
    case 2: launch_gather<uint16_t>(table, id, n, row_bytes, out, s); break;
    default: launch_gather<uint8_t>(table, id, n, row_bytes, out, s); break;
  }
  return (int)cudaGetLastError();
}

// table: (rows, row_bytes) bytes, written in place; ids: n UNIQUE int32 in
// [0, rows); upd: n rows of the table's dtype.
int embedding_scatter(void* table, long long row_bytes, const void* ids,
                      long long n, const void* upd, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* id = (const int*)ids;
  switch (word_bytes(table, upd, row_bytes)) {
    case 16: launch_scatter<uint4>(table, id, n, row_bytes, upd, s); break;
    case 8: launch_scatter<uint2>(table, id, n, row_bytes, upd, s); break;
    case 4: launch_scatter<uint32_t>(table, id, n, row_bytes, upd, s); break;
    case 2: launch_scatter<uint16_t>(table, id, n, row_bytes, upd, s); break;
    default: launch_scatter<uint8_t>(table, id, n, row_bytes, upd, s); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
