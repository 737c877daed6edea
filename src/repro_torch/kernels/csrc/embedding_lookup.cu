// Row gather and row scatter-set kernels for Hopper (sm_90a). Plain C
// interface, built by kernels/_build.py with nvcc and bound with ctypes in
// kernels/embedding_lookup.py, whose wrappers count launches
// (embedding_lookup.launches, embedding_scatter.launches).
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

#include <cstdint>
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
