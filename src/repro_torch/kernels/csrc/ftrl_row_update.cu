// FTRL-proximal row update for Hopper (sm_90a). Plain C interface, built
// by kernels/_build.py with nvcc and bound with ctypes in
// kernels/ftrl_row_update.py, whose wrapper counts launches
// (ftrl_row_update.launches).
//
// Replaces src/repro/kernels/ftrl_row_update.py: ftrl_row_update
// (_ftrl_kernel), a Pallas pass over (block_rows, D) tiles in VMEM. Given
// gathered rows (z, n) and gradient rows g it writes
//
//   w   = w_from(z, n)
//   n'  = n + g*g
//   s   = (sqrt(n') - sqrt(n)) / alpha
//   z'  = (z + g) - s*w
//   w'  = w_from(z', n')
//
// with w_from(z, n) = |z| > l1 ? (sign(z)*l1 - z) / ((sqrt(n) + beta)/alpha
// + l2) : +0. The elements are independent, so one thread updates one
// element in a grid-stride loop; a row of D floats is D neighbouring
// threads and every load and store is coalesced.
//
// What bounds it on this card is bytes: 3 floats read and 3 written per
// element (24 B) against ~20 flops, far below the ~20 flop/B where fp32
// arithmetic would take over. Nothing is staged in shared memory because
// no byte is read twice.
//
// Bit-equality with the NumPy route (FTRL.update_rows / _np_weights) is
// the contract, so every operation is written with a round-to-nearest
// intrinsic: nvcc would otherwise contract n + g*g and (z + g) - s*w into
// fused multiply-adds, which round once where NumPy rounds twice. Divide
// and square root are the IEEE ones (__fdiv_rn, __fsqrt_rn), never the
// fast approximations. The hyper-parameters arrive as float, each rounded
// to f32 once, as NumPy rounds a Python scalar against an f32 array.

#include <cuda_runtime.h>

namespace {

struct FtrlParams {
  float alpha, beta, l1, l2;
};

__device__ __forceinline__ float ftrl_weight(float z, float n,
                                             const FtrlParams& p) {
  // denom = ((sqrt(n) + beta) / alpha) + l2, in _np_weights' order
  float denom = __fadd_rn(__fdiv_rn(__fadd_rn(__fsqrt_rn(n), p.beta),
                                    p.alpha),
                          p.l2);
  float sgn = (z > 0.0f) ? 1.0f : ((z < 0.0f) ? -1.0f : 0.0f);
  float w = __fdiv_rn(__fsub_rn(__fmul_rn(sgn, p.l1), z), denom);
  return fabsf(z) > p.l1 ? w : 0.0f;
}

__global__ void ftrl_row_update_kernel(const float* __restrict__ z,
                                       const float* __restrict__ n,
                                       const float* __restrict__ g,
                                       long long count, FtrlParams p,
                                       float* __restrict__ z_out,
                                       float* __restrict__ n_out,
                                       float* __restrict__ w_out) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    float zi = z[i], ni = n[i], gi = g[i];
    float w_old = ftrl_weight(zi, ni, p);
    float n_new = __fadd_rn(ni, __fmul_rn(gi, gi));
    float sigma = __fdiv_rn(__fsub_rn(__fsqrt_rn(n_new), __fsqrt_rn(ni)),
                            p.alpha);
    float z_new = __fsub_rn(__fadd_rn(zi, gi), __fmul_rn(sigma, w_old));
    z_out[i] = z_new;
    n_out[i] = n_new;
    w_out[i] = ftrl_weight(z_new, n_new, p);
  }
}

unsigned grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  const long long cap = 132LL * 16;  // SMs x resident blocks, grid-stride beyond
  return (unsigned)(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" {

// z, n, g: count f32 each (B x D rows, contiguous); z_out, n_out, w_out:
// count f32 each. Returns cudaGetLastError() after launch.
int ftrl_row_update(const void* z, const void* n, const void* g,
                    long long count, float alpha, float beta, float l1,
                    float l2, void* z_out, void* n_out, void* w_out,
                    void* stream) {
  const int threads = 256;
  FtrlParams p{alpha, beta, l1, l2};
  ftrl_row_update_kernel<<<grid_for(count, threads), threads, 0,
                           (cudaStream_t)stream>>>(
      (const float*)z, (const float*)n, (const float*)g, count, p,
      (float*)z_out, (float*)n_out, (float*)w_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
