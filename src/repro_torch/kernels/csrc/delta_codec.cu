// Row-wise absmax int8 codec for Hopper (sm_90a): the sync stream's
// quantize (pusher side) and dequantize (scatter side). Plain C interface,
// built by kernels/_build.py with nvcc and bound with ctypes in
// kernels/delta_codec.py, whose wrappers count launches
// (quantize_rows.launches, dequantize_rows.launches).
//
// quantize_rows replaces src/repro/kernels/delta_codec.py: quantize_rows
// (_quant_kernel), and dequantize_rows replaces dequantize_rows
// (_dequant_kernel); both were Pallas passes over (block_rows, D) tiles
// with the row reduction in vector registers.
//
//   scale = max(absmax(x_row) * f32(1/127), 1e-12)
//   q     = clip(rint(x / scale), -127, 127) as int8
//   x'    = f32(q) * scale
//
// What bounds both on this card is bytes: 4 B read and 1 B written per
// element (the reverse for dequantize) plus 4 B of scale per row, against
// one divide or multiply per element. Quantize needs the row's absmax
// before any q, so one warp owns a row: a lane-strided max, a butterfly
// of __shfl_xor_sync maxes, then the lanes write the row's codes. The
// row is re-read for the codes, from L1/L2 rather than device memory.
// Dequantize is one multiply per element, one thread each.
//
// Bit-equality with Int8Transform._quantize_np is the contract: the
// 1/127 constant is the f32 rounding of the double quotient and is a
// multiply (as in the reference, which writes it out so that XLA, the
// oracle and NumPy agree), the floor is the f32 rounding of 1e-12, the
// divide is IEEE (__fdiv_rn) and the rounding is rintf, half to even like
// np.rint and jnp.round, never roundf. An all-zero row gets scale 1e-12
// and codes 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kInv127 = (float)(1.0 / 127.0);

__global__ void quantize_rows_kernel(const float* __restrict__ x,
                                     long long rows, long long d,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ scale) {
  const int lane = threadIdx.x & 31;
  long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r = warp; r < rows; r += warps) {  // uniform per warp
    const float* xr = x + r * d;
    float m = 0.0f;
    for (long long c = lane; c < d; c += 32) m = fmaxf(m, fabsf(xr[c]));
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = fmaxf(__fmul_rn(m, kInv127), 1e-12f);
    int8_t* qr = q + r * d;
    for (long long c = lane; c < d; c += 32) {
      float v = rintf(__fdiv_rn(xr[c], s));
      qr[c] = (int8_t)fminf(fmaxf(v, -127.0f), 127.0f);
    }
    if (lane == 0) scale[r] = s;
  }
}

__global__ void dequantize_rows_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scale,
                                       long long rows, long long d,
                                       float* __restrict__ out) {
  long long total = rows * d;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride)
    out[i] = __fmul_rn((float)q[i], scale[i / d]);
}

unsigned grid_for(long long work_items, int per_block) {
  long long blocks = (work_items + per_block - 1) / per_block;
  const long long cap = 132LL * 16;  // SMs x resident blocks, grid-stride beyond
  return (unsigned)(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" {

// x: rows x d f32, contiguous; q: rows x d int8; scale: rows f32.
// Returns cudaGetLastError() after launch.
int quantize_rows(const void* x, long long rows, long long d, void* q,
                  void* scale, void* stream) {
  const int threads = 256;  // 8 warps, 8 rows per block
  quantize_rows_kernel<<<grid_for(rows, threads / 32), threads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)x, rows, d, (int8_t*)q, (float*)scale);
  return (int)cudaGetLastError();
}

// q: rows x d int8; scale: rows f32; out: rows x d f32.
// Returns cudaGetLastError() after launch.
int dequantize_rows(const void* q, const void* scale, long long rows,
                    long long d, void* out, void* stream) {
  const int threads = 256;
  dequantize_rows_kernel<<<grid_for(rows * d, threads), threads, 0,
                           (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)scale, rows, d, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
