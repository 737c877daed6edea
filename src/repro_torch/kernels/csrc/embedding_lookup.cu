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
// It too is bound by bytes: each update row read once, each distinct
// table row read and written once. See scatter_add_rows_kernel.

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
// order. Blocks here run in no order, so the order is kept inside a warp:
// ids arrive sorted by a stable sort (the wrapper), and the warp of each
// position i that starts a segment (i == 0 || ids[i] != ids[i-1], as the
// Pallas kernel decides its first visit) owns that id's whole segment;
// every other warp exits. Its lanes stride over the columns; each lane
// starts from table[id][c] and adds upd[j][c] for j in the segment, in
// input order, rounding to the table's dtype after every add as the
// Pallas `+=` on a block of that dtype does. No float atomics: their
// order would change the sum from run to run.
//
// bf16: the add is an f32 add of two bf16 values (__fadd_rn, so nvcc
// contracts nothing) rounded back to nearest-even; f32 keeps 24 bits >=
// 2 * 8 + 2, so the double rounding equals one bf16 rounding of the exact
// sum. A segment of many duplicates runs on one warp (one long serial
// chain of adds per column): the simple design, not the fast one.
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ __nv_bfloat16 add_rn(__nv_bfloat16 a,
                                                __nv_bfloat16 b) {
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

template <typename T>
__global__ void scatter_add_rows_kernel(T* __restrict__ table,
                                        const int* __restrict__ ids,
                                        long long n, long long d,
                                        const T* __restrict__ upd) {
  const int lane = threadIdx.x & 31;
  long long i = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (i >= n) return;
  const int id = ids[i];
  if (i > 0 && ids[i - 1] == id) return;   // not the segment's first
  long long end = i + 1;
  while (end < n && ids[end] == id) ++end;
  T* row = table + (long long)id * d;
  for (long long c = lane; c < d; c += 32) {
    T acc = row[c];
    for (long long j = i; j < end; ++j) acc = add_rn(acc, upd[j * d + c]);
    row[c] = acc;
  }
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

}  // namespace

extern "C" {

// table: (rows, d) of dtype (0 float32, 1 bfloat16), updated in place;
// ids: n int32 in [0, rows), SORTED (duplicates adjacent, in input order);
// upd: (n, d) of the table's dtype, in the ids' order. Returns
// cudaGetLastError() after launch.
int embedding_scatter_add(void* table, long long d, const void* ids,
                          long long n, const void* upd, int dtype,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;                       // 8 warps, one per id
  unsigned blocks = (unsigned)((n + (threads / 32) - 1) / (threads / 32));
  if (dtype == 0) {
    scatter_add_rows_kernel<float><<<blocks, threads, 0, s>>>(
        (float*)table, (const int*)ids, n, d, (const float*)upd);
  } else if (dtype == 1) {
    scatter_add_rows_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (__nv_bfloat16*)table, (const int*)ids, n, d,
        (const __nv_bfloat16*)upd);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}


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
