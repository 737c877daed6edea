// FTRL-proximal row update for Hopper (sm_90a): one element update behind
// two entries. Plain C interface, built by kernels/_build.py with nvcc and
// bound with ctypes in kernels/ftrl_row_update.py, whose wrappers count
// launches (ftrl_row_update.launches, both entries).
//
// Replaces src/repro/kernels/ftrl_row_update.py: ftrl_row_update
// (_ftrl_kernel), a Pallas pass over (block_rows, D) tiles in VMEM. Given
// rows (z, n) and gradient rows g it writes
//
//   w   = w_from(z, n)
//   n'  = n + g*g
//   s   = (sqrt(n') - sqrt(n)) / alpha
//   z'  = (z + g) - s*w
//   w'  = w_from(z', n')
//
// with w_from(z, n) = |z| > l1 ? (sign(z)*l1 - z) / ((sqrt(n) + beta)/alpha
// + l2) : +0.
//
// - ftrl_row_update: contiguous (z, n, g) in, (z', n', w') out, the Pallas
//   kernel's own function (FTRL.update_rows(backend="torch")).
// - ftrl_apply_slots: the sparse train push after its probe, in one pass
//   (ops.fused_ftrl_apply). A row's arena slot is found ? slot_of[pos] : 0;
//   the pass reads (z, n) from the arenas there, updates them and writes
//   (z', n', w') back into the arenas in place and into the row outputs the
//   host copies back. It takes the place of the chain slot translate (three
//   torch launches) -> two gathers -> update -> three scatter-sets, whose
//   rows crossed device memory twice: 64 bytes an element against the 36
//   this pass moves (z, n, g read; z', n', w' written twice).
//
// What bounds it on this card. Bytes: 24 an element for ftrl_row_update,
// 36 for ftrl_apply_slots plus the rows' pos and found and the 32-byte
// sectors of slot_of and of the arenas that the rows touch (a 4-byte row
// of the w push moves a whole sector). Instruction issue: an element
// issues nine IEEE divides and square roots, each a sequence of FFMAs
// around one MUFU.RCP or MUFU.RSQ behind a branch to its slow path;
// chip_smoke.py counts them in this library's SASS (cuobjdump -sass) and
// sets them against the H100's issue rates. On a push of ~32k rows the
// bytes bound the time (0.0019 ms standalone, 0.0031 for the v push's
// pass), and what the time is made of is a launch, the pass's dependent
// round trips (pos -> slot_of -> arena row) and the update's own chain of
// dependent divides and roots.
//
// The design: a thread per float, consecutive floats in consecutive
// threads (every access of a warp coalesced), one wave of 256-thread
// blocks for a push, no loop. Every load of a thread is issued before its
// first store: the gradient (.nc) and the row's pos and found first, then
// the slot_of read, then the arena row (ordinary loads: the same pass
// writes it). float4 lanes (a thread owning four floats of a row), two
// lanes a thread, were the first design: they put eight dependent update
// chains in one thread, each divide and root behind a branch the compiler
// does not interleave across, and on an H100 80GB HBM3 at 700 W
// (scripts/compare_kernels.py --ftrl-row-update) the standalone call took
// 0.0045 ms and the v push's pass 0.0056, where a thread per float takes
// 0.0027 and 0.0041. Nothing is staged in shared memory: no byte is read
// twice.
//
// Bit-equality with the NumPy route (FTRL.update_rows / _np_weights) is
// the contract, so every operation is written with a round-to-nearest
// intrinsic: nvcc would otherwise contract n + g*g and (z + g) - s*w into
// fused multiply-adds, which round once where NumPy rounds twice. Divide
// and square root are the IEEE ones (__fdiv_rn, __fsqrt_rn), never the
// fast approximations. The hyper-parameters arrive as float, each rounded
// to f32 once, as NumPy rounds a Python scalar against an f32 array. A w
// arena of float16 or bfloat16 takes w' rounded to nearest even
// (__float2half_rn, __float2bfloat16_rn), as the chain's cast does.
//
// Ids must be unique and present in the map (the reference's contract).
// An absent id reads and writes arena row 0, where two such rows race;
// SparseTable.fused_ftrl_update raises and drops the mirror's arenas then.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block

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

// One element: (z, n, g) -> (z', n', w').
__device__ __forceinline__ void ftrl_element(float z, float n, float g,
                                             const FtrlParams& p,
                                             float& z_new, float& n_new,
                                             float& w_new) {
  float w_old = ftrl_weight(z, n, p);
  n_new = __fadd_rn(n, __fmul_rn(g, g));
  float sigma = __fdiv_rn(__fsub_rn(__fsqrt_rn(n_new), __fsqrt_rn(n)),
                          p.alpha);
  z_new = __fsub_rn(__fadd_rn(z, g), __fmul_rn(sigma, w_old));
  w_new = ftrl_weight(z_new, n_new, p);
}

// w' into the w arena, rounded to nearest even where its type T is 16-bit
template <typename T>
__device__ __forceinline__ void store_w(void* arena, long long at, float w);
template <>
__device__ __forceinline__ void store_w<float>(void* arena, long long at,
                                               float w) {
  static_cast<float*>(arena)[at] = w;
}
template <>
__device__ __forceinline__ void store_w<__half>(void* arena, long long at,
                                                float w) {
  static_cast<__half*>(arena)[at] = __float2half_rn(w);
}
template <>
__device__ __forceinline__ void store_w<__nv_bfloat16>(void* arena,
                                                       long long at, float w) {
  static_cast<__nv_bfloat16*>(arena)[at] = __float2bfloat16_rn(w);
}

struct Args {
  const float* z;  // ftrl_row_update: the rows (z, n)
  const float* n;
  const float* g;
  const int* pos;  // ftrl_apply_slots: the probe's results and the map's
  const unsigned char* found;  // value table (bool found)
  const int* slot_of;
  float* z_arena;
  float* n_arena;
  void* w_arena;
  float* z_out;
  float* n_out;
  float* w_out;
  unsigned count;  // floats
  unsigned d;      // row width in floats (ftrl_apply_slots)
  FtrlParams p;
};

// A thread per float. kSlots: ftrl_apply_slots (rows through the slots,
// written back in place); else ftrl_row_update (contiguous rows). T: the
// w arena's type.
template <bool kSlots, typename T>
__global__ void __launch_bounds__(kThreads) ftrl_kernel(Args a) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.count) return;
  // what needs no other load first: the gradient, the row's probe result
  const float g = __ldg(a.g + i);
  float z, n;
  long long at = i;  // where the element's (z, n) lie
  if constexpr (kSlots) {
    const unsigned row = a.d == 1 ? i : i / a.d;
    const int pos = __ldg(a.pos + row);
    const bool hit = __ldg(a.found + row) != 0;
    // the arena slot, the chain's rule: found ? slot_of[pos] : 0
    const int slot = hit ? __ldg(a.slot_of + pos) : 0;
    at = (long long)slot * a.d + (i - row * a.d);
    z = a.z_arena[at];  // ordinary loads: this pass writes these rows
    n = a.n_arena[at];
  } else {
    z = __ldg(a.z + i);
    n = __ldg(a.n + i);
  }
  float zo, no, wo;
  ftrl_element(z, n, g, a.p, zo, no, wo);
  a.z_out[i] = zo;
  a.n_out[i] = no;
  a.w_out[i] = wo;
  if constexpr (kSlots) {
    a.z_arena[at] = zo;
    a.n_arena[at] = no;
    store_w<T>(a.w_arena, at, wo);
  }
}

template <bool kSlots, typename T>
int launch(const Args& a, void* stream) {
  if (a.count == 0) return 0;
  const unsigned blocks = (a.count + kThreads - 1) / kThreads;
  ftrl_kernel<kSlots, T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// z, n, g: count f32 each (B x D rows, contiguous); z_out, n_out, w_out:
// count f32 each. Returns cudaGetLastError() after launch (or
// cudaErrorInvalidValue for a count past 2^31 - 1).
int ftrl_row_update(const void* z, const void* n, const void* g,
                    long long count, float alpha, float beta, float l1,
                    float l2, void* z_out, void* n_out, void* w_out,
                    void* stream) {
  if (count < 0 || count > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args a{};
  a.z = (const float*)z, a.n = (const float*)n, a.g = (const float*)g;
  a.z_out = (float*)z_out, a.n_out = (float*)n_out, a.w_out = (float*)w_out;
  a.count = (unsigned)count;
  a.d = 1;
  a.p = FtrlParams{alpha, beta, l1, l2};
  return launch<false, float>(a, stream);
}

// pos (rows,) int32 and found (rows,) bool: the probe's results for the
// push's ids; slot_of: the map's value table (key slot -> arena slot),
// int32; z_arena, n_arena: (R, d) f32, w_arena: (R, d) of w_dtype (0 f32,
// 1 bf16, 2 f16), all contiguous, updated in place; g: (rows, d) f32;
// z_out, n_out, w_out: (rows, d) f32. Returns cudaGetLastError() after
// launch (or cudaErrorInvalidValue for arguments the kernel does not
// take).
int ftrl_apply_slots(const void* pos, const void* found, const void* slot_of,
                     void* z_arena, void* n_arena, void* w_arena, int w_dtype,
                     const void* g, long long rows, long long d, float alpha,
                     float beta, float l1, float l2, void* z_out,
                     void* n_out, void* w_out, void* stream) {
  if (rows < 0 || d < 1 || rows * d > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.g = (const float*)g, a.pos = (const int*)pos;
  a.found = (const unsigned char*)found, a.slot_of = (const int*)slot_of;
  a.z_arena = (float*)z_arena, a.n_arena = (float*)n_arena;
  a.w_arena = w_arena;
  a.z_out = (float*)z_out, a.n_out = (float*)n_out, a.w_out = (float*)w_out;
  a.count = (unsigned)(rows * d);
  a.d = (unsigned)d;
  a.p = FtrlParams{alpha, beta, l1, l2};
  switch (w_dtype) {
    case 0:
      return launch<true, float>(a, stream);
    case 1:
      return launch<true, __nv_bfloat16>(a, stream);
    case 2:
      return launch<true, __half>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
