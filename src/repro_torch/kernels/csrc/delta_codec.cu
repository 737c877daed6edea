// Row-wise absmax int8 codec for Hopper (sm_90a): the sync stream's
// quantize (pusher side, and ModelSyncEngine's dense leaves under
// --codec int8) and dequantize (scatter side). Plain C interface, built by
// kernels/_build.py with nvcc and bound with ctypes in
// kernels/delta_codec.py, whose wrappers count launches
// (quantize_rows.launches, dequantize_rows.launches).
//
// quantize_rows replaces src/repro/kernels/delta_codec.py: quantize_rows
// (_quant_kernel), and dequantize_rows replaces dequantize_rows
// (_dequant_kernel); both were Pallas passes over (block_rows, D) tiles
// with the row reduction in vector registers.
//
//   scale = max(absmax(x_row) * f32(1/127), 1e-12)   (NaN propagates)
//   q     = clip(rint(x / scale), -127, 127) as int8  (NaN quotient -> 0)
//   x'    = f32(q) * scale
//
// What bounds both on this card is bytes: 4 B read and 1 B written per
// element (the reverse for dequantize) plus 4 B of scale per row, against
// one divide or multiply per element. Quantize needs the row's absmax
// before any code, so the design is a plan by row width (the wrapper's
// codec_plan picks it, the C entries check it):
//
//   narrow (D <= 16): a thread owns a row; neighbouring lanes own
//     neighbouring rows, so a warp's loads are one coalesced run. The row
//     sits in registers: read once, no shuffles. D = 1, 8 and 9 (the CTR
//     groups w, v and the serve arena) are compile-time widths; D = 8
//     moves two 16-byte loads and one 8-byte code store a row.
//   warp (D <= 2,048) / block (D <= 16,384): a team of 1 or 8 warps owns
//     a row and holds it in registers (64 floats a lane), reads it once,
//     reduces it (redux.sync, then shared memory across warps) and writes
//     the codes from what it holds.
//   split (wider, e.g. the LM's dense leaves, ONE row of 385M floats):
//     the row is cut into tiles of 4,096 elements spread over the whole
//     card. Pass 1 takes each warp's maximum and atomicMax-es it into a
//     per-row uint32 that the wrapper zeroes; pass 2 reads the row again
//     and writes the codes. The row cannot stay on chip, so its honest
//     bound is 9 bytes an element, not 5. Two launches, no host sync, no
//     grid barrier: a CUDA graph captures it.
//
// Dequantize follows the same plan (a thread a row; a team a row; tiles)
// with no per-element division: the row comes from the thread, the team
// or the tile.
//
// The absmax is taken on the uint32 bits of |x|: non-negative floats
// order as unsigned integers and NaN (sign cleared) lies above +Inf, so
// a row holding a NaN gets a NaN scale, as in the reference; max is
// exact, so any split of a row's reduction gives the same bits. The scale
// floor keeps NaN (a compare, not fmaxf, which would drop it), and a NaN
// quotient (+-Inf / Inf, anything / NaN) becomes code 0 explicitly, as
// the reference's conversion gives on the host.
//
// Bit-equality with Int8Transform._quantize_np is the contract: the
// 1/127 constant is the f32 rounding of the double quotient and is a
// multiply (__fmul_rn: nvcc must not contract it), the floor is the f32
// rounding of 1e-12, the divide is IEEE (__fdiv_rn; a reciprocal
// multiply changes codes) and the rounding is rintf, half to even like
// np.rint and jnp.round. An all-zero row gets scale 1e-12 and codes 0.
//
// Grids hold what the card runs at once (SMs x resident blocks from the
// occupancy API, cached per kernel) and walk the rest. In-row offsets are
// 32-bit, row bases 64-bit; rows of 2^31 or more elements are refused.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kInv127 = (float)(1.0 / 127.0);
constexpr int THREADS = 256;
// the plan's limits (kernels/delta_codec.py NARROW_MAX, WARP_MAX, ...)
constexpr int NARROW_MAX = 16;    // elements of a row a thread owns
constexpr int LANE_FLOATS = 64;   // floats a lane of a team holds
constexpr int TILE = 4096;        // elements of a split-row tile
constexpr int TILE_PER_THREAD = TILE / THREADS;
enum Regime { NARROW = 0, WARP = 1, BLOCK = 2, SPLIT = 3 };

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ float scale_of(unsigned absmax_bits) {
  const float s = __fmul_rn(__uint_as_float(absmax_bits), kInv127);
  return s < 1e-12f ? 1e-12f : s;  // NaN stays NaN
}

__device__ __forceinline__ uint32_t code(float x, float s) {
  // __fdiv_rn takes its slow path for a zero numerator, and rows of sparse
  // weights hold many zeros; s / 4 instead gives 0.25, code 0, on the fast
  // path (and NaN, code 0, where s is NaN or inf, as 0 / s does). A
  // select, not a branch: a branch slowed the rows that hold no zeros.
  const float v = __fdiv_rn(x == 0.0f ? 0.25f * s : x, s);
  if (v != v) return 0u;
  return (uint32_t)(uint8_t)(int8_t)(int)fminf(fmaxf(rintf(v), -127.0f),
                                                127.0f);
}

__device__ __forceinline__ uint32_t code4(float4 v, float s) {
  return code(v.x, s) | code(v.y, s) << 8 | code(v.z, s) << 16 |
         code(v.w, s) << 24;
}

__device__ __forceinline__ unsigned max4(unsigned m, float4 v) {
  return max(max(m, abs_bits(v.x)), max(max(abs_bits(v.y), abs_bits(v.z)),
                                        abs_bits(v.w)));
}

__device__ __forceinline__ float4 decode4(uint32_t c, float s) {
  return make_float4(__fmul_rn((float)(int8_t)c, s),
                     __fmul_rn((float)(int8_t)(c >> 8), s),
                     __fmul_rn((float)(int8_t)(c >> 16), s),
                     __fmul_rn((float)(int8_t)(c >> 24), s));
}

// ---- narrow: a thread a row --------------------------------------------
// D > 0 a compile-time width, else d <= NARROW_MAX at run time; VEC: the
// row is read as float4 (D % 4 == 0, 16-byte aligned pointers).
template <int D, bool VEC>
__global__ void __launch_bounds__(THREADS)
quantize_narrow_kernel(const float* __restrict__ x, long long rows, int d,
                       int8_t* __restrict__ q, float* __restrict__ scale) {
  constexpr int N = D > 0 ? D : NARROW_MAX;
  if (D > 0) d = D;
  for (long long r = (long long)blockIdx.x * THREADS + threadIdx.x; r < rows;
       r += (long long)gridDim.x * THREADS) {
    const float* xr = x + r * d;
    float v[N];
    unsigned m = 0;
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < N / 4; ++j)
        if (4 * j < d) {
          const float4 w = ((const float4*)xr)[j];
          v[4 * j] = w.x; v[4 * j + 1] = w.y;
          v[4 * j + 2] = w.z; v[4 * j + 3] = w.w;
          m = max4(m, w);
        }
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < d) { v[j] = xr[j]; m = max(m, abs_bits(v[j])); }
    }
    const float s = scale_of(m);
    int8_t* qr = q + r * d;
    if constexpr (VEC) {
      uint32_t c[N / 4];
#pragma unroll
      for (int j = 0; j < N / 4; ++j)
        if (4 * j < d)
          c[j] = code4(make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2],
                                   v[4 * j + 3]), s);
      if constexpr (D == 8) {
        *(uint2*)qr = make_uint2(c[0], c[1]);
      } else {
#pragma unroll
        for (int j = 0; j < N / 4; ++j)
          if (4 * j < d) ((uint32_t*)qr)[j] = c[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < d) qr[j] = (int8_t)code(v[j], s);
    }
    scale[r] = s;
  }
}

template <int D, bool VEC>
__global__ void __launch_bounds__(THREADS)
dequantize_narrow_kernel(const int8_t* __restrict__ q,
                         const float* __restrict__ scale, long long rows,
                         int d, float* __restrict__ out) {
  constexpr int N = D > 0 ? D : NARROW_MAX;
  if (D > 0) d = D;
  for (long long r = (long long)blockIdx.x * THREADS + threadIdx.x; r < rows;
       r += (long long)gridDim.x * THREADS) {
    const int8_t* qr = q + r * d;
    float* o = out + r * d;
    const float s = scale[r];
    if constexpr (VEC) {
      uint32_t c[N / 4];
      if constexpr (D == 8) {
        const uint2 w = *(const uint2*)qr;
        c[0] = w.x; c[1] = w.y;
      } else {
#pragma unroll
        for (int j = 0; j < N / 4; ++j)
          if (4 * j < d) c[j] = ((const uint32_t*)qr)[j];
      }
#pragma unroll
      for (int j = 0; j < N / 4; ++j)
        if (4 * j < d) ((float4*)o)[j] = decode4(c[j], s);
    } else {
      int8_t c[N];
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < d) c[j] = qr[j];
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < d) o[j] = __fmul_rn((float)c[j], s);
    }
  }
}

// ---- warp / block: a team of W warps a row, the row in registers -------
// A lane holds words tl, tl + 32W, ... of its row (a word: a float4 when
// VEC, else one float), LANE_FLOATS floats in all.
template <int W, bool VEC>
__global__ void __launch_bounds__(THREADS)
quantize_team_kernel(const float* __restrict__ x, long long rows, int d,
                     int8_t* __restrict__ q, float* __restrict__ scale) {
  constexpr int TEAMS = THREADS / (32 * W);
  constexpr int WF = VEC ? 4 : 1;  // floats a word
  constexpr int K = LANE_FLOATS / WF;
  __shared__ unsigned part[THREADS / 32];
  const int tl = threadIdx.x % (32 * W);
  const int words = d / WF;
  for (long long r = (long long)blockIdx.x * TEAMS + threadIdx.x / (32 * W);
       r < rows; r += (long long)gridDim.x * TEAMS) {  // uniform per team
    const float* xr = x + r * d;
    float v[K][WF];
    unsigned m = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = tl + 32 * W * j;
      if (c < words) {
        if constexpr (VEC) {
          const float4 w = ((const float4*)xr)[c];
          v[j][0] = w.x; v[j][1] = w.y; v[j][2] = w.z; v[j][3] = w.w;
          m = max4(m, w);
        } else {
          v[j][0] = xr[c];
          m = max(m, abs_bits(v[j][0]));
        }
      }
    }
    m = __reduce_max_sync(0xffffffffu, m);
    if constexpr (W > 1) {
      if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = m;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < W; ++w) m = max(m, part[w]);
      __syncthreads();  // part is rewritten by the next row
    }
    const float s = scale_of(m);
    int8_t* qr = q + r * d;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = tl + 32 * W * j;
      if (c < words) {
        if constexpr (VEC)
          ((uint32_t*)qr)[c] =
              code4(make_float4(v[j][0], v[j][1], v[j][2], v[j][3]), s);
        else
          qr[c] = (int8_t)code(v[j][0], s);
      }
    }
    if (tl == 0) scale[r] = s;
  }
}

template <int W, bool VEC>
__global__ void __launch_bounds__(THREADS)
dequantize_team_kernel(const int8_t* __restrict__ q,
                       const float* __restrict__ scale, long long rows,
                       int d, float* __restrict__ out) {
  constexpr int TEAMS = THREADS / (32 * W);
  const int tl = threadIdx.x % (32 * W);
  const int words = VEC ? d / 4 : d;
  for (long long r = (long long)blockIdx.x * TEAMS + threadIdx.x / (32 * W);
       r < rows; r += (long long)gridDim.x * TEAMS) {
    const int8_t* qr = q + r * d;
    float* o = out + r * d;
    const float s = scale[r];
#pragma unroll 4
    for (int c = tl; c < words; c += 32 * W) {
      if constexpr (VEC)
        ((float4*)o)[c] = decode4(((const uint32_t*)qr)[c], s);
      else
        o[c] = __fmul_rn((float)qr[c], s);
    }
  }
}

// ---- split: tiles of TILE elements of a row over the whole card --------
// Tile t is slice t % slices of row t / slices; a thread moves
// TILE_PER_THREAD elements of it, as float4 words (VEC) or floats, each
// word index the thread's own plus a multiple of THREADS (coalesced).
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
absmax_split_kernel(const float* __restrict__ x, long long rows, int d,
                    unsigned* __restrict__ absmax) {
  constexpr int WF = VEC ? 4 : 1;
  constexpr int K = TILE_PER_THREAD / WF;
  const int slices = (d + TILE - 1) / TILE;
  const int words = d / WF;
  const long long tiles = rows * slices;
  long long cur = -1;
  unsigned m = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r = t / slices;             // uniform per block
    if (r != cur) {
      m = __reduce_max_sync(0xffffffffu, m);
      if (threadIdx.x % 32 == 0 && m) atomicMax(absmax + cur, m);
      cur = r;
      m = 0;
    }
    const float* xr = x + r * d;
    const int w0 = (int)(t - r * slices) * (TILE / WF);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = w0 + threadIdx.x + THREADS * j;
      if (c < words) {
        if constexpr (VEC) m = max4(m, ((const float4*)xr)[c]);
        else m = max(m, abs_bits(xr[c]));
      }
    }
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if (threadIdx.x % 32 == 0 && m) atomicMax(absmax + cur, m);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
quantize_split_kernel(const float* __restrict__ x, long long rows, int d,
                      const unsigned* __restrict__ absmax,
                      int8_t* __restrict__ q, float* __restrict__ scale) {
  constexpr int WF = VEC ? 4 : 1;
  constexpr int K = TILE_PER_THREAD / WF;
  const int slices = (d + TILE - 1) / TILE;
  const int words = d / WF;
  const long long tiles = rows * slices;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r = t / slices;
    const int slice = (int)(t - r * slices);
    const float s = scale_of(absmax[r]);
    if (slice == 0 && threadIdx.x == 0) scale[r] = s;
    const float* xr = x + r * d;
    int8_t* qr = q + r * d;
    const int w0 = slice * (TILE / WF);
    if constexpr (VEC) {
      float4 v[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int c = w0 + threadIdx.x + THREADS * j;
        if (c < words) v[j] = ((const float4*)xr)[c];
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int c = w0 + threadIdx.x + THREADS * j;
        if (c < words) ((uint32_t*)qr)[c] = code4(v[j], s);
      }
    } else {
      float v[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int c = w0 + threadIdx.x + THREADS * j;
        if (c < words) v[j] = xr[c];
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int c = w0 + threadIdx.x + THREADS * j;
        if (c < words) qr[c] = (int8_t)code(v[j], s);
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
dequantize_split_kernel(const int8_t* __restrict__ q,
                        const float* __restrict__ scale, long long rows,
                        int d, float* __restrict__ out) {
  constexpr int WF = VEC ? 4 : 1;
  constexpr int K = TILE_PER_THREAD / WF;
  const int slices = (d + TILE - 1) / TILE;
  const int words = d / WF;
  const long long tiles = rows * slices;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r = t / slices;
    const float s = scale[r];
    const int8_t* qr = q + r * d;
    float* o = out + r * d;
    const int w0 = (int)(t - r * slices) * (TILE / WF);
    if constexpr (VEC) {
      uint32_t c4[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int c = w0 + threadIdx.x + THREADS * j;
        if (c < words) c4[j] = ((const uint32_t*)qr)[c];
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int c = w0 + threadIdx.x + THREADS * j;
        if (c < words) ((float4*)o)[c] = decode4(c4[j], s);
      }
    } else {
      int8_t c1[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int c = w0 + threadIdx.x + THREADS * j;
        if (c < words) c1[j] = qr[c];
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int c = w0 + threadIdx.x + THREADS * j;
        if (c < words) o[c] = __fmul_rn((float)c1[j], s);
      }
    }
  }
}

// ---- launch ------------------------------------------------------------
// As many blocks of THREADS as the card holds at once (SMs x resident
// blocks, asked of the occupancy API once per kernel), or fewer when the
// work is smaller; the blocks walk the rest.
template <auto KERNEL, typename... A>
int launch(long long blocks, cudaStream_t s, A... args) {
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, KERNEL, THREADS, 0);
    return b > 0 ? b : 1;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long cap = (long long)(sms > 0 ? sms : 1) * per_sm;
  KERNEL<<<(unsigned)(blocks < cap ? blocks : cap), THREADS, 0, s>>>(args...);
  return (int)cudaGetLastError();
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The plan the wrapper made (kernels/delta_codec.py codec_plan), checked:
// the regime's width limits, and float4 words only where the width and
// both pointers allow them.
bool plan_ok(long long rows, long long d, int regime, int word,
             const void* f32, const void* codes) {
  if (rows < 1 || d < 1 || d >= (1LL << 31) || (word != 4 && word != 16))
    return false;
  if (word == 16 && (d % 4 || ((uintptr_t)f32 | (uintptr_t)codes) % 16))
    return false;
  switch (regime) {
    case NARROW: return d <= NARROW_MAX;
    case WARP: return d <= 32LL * LANE_FLOATS;
    case BLOCK: return d <= 8LL * 32 * LANE_FLOATS;
    case SPLIT: return true;
    default: return false;
  }
}

template <int D, bool VEC>
int narrow_quantize(const float* x, long long rows, int d, int8_t* q,
                    float* scale, cudaStream_t s) {
  return launch<quantize_narrow_kernel<D, VEC>>(cdiv(rows, THREADS), s, x,
                                                rows, d, q, scale);
}

template <int D, bool VEC>
int narrow_dequantize(const int8_t* q, const float* scale, long long rows,
                      int d, float* out, cudaStream_t s) {
  return launch<dequantize_narrow_kernel<D, VEC>>(cdiv(rows, THREADS), s, q,
                                                  scale, rows, d, out);
}

}  // namespace

extern "C" {

// x: rows x d f32, contiguous; q: rows x d int8; scale: rows f32;
// regime / word: the wrapper's codec_plan (0 narrow, 1 warp, 2 block,
// 3 split; word 16 = float4 loads, 4 = float loads). A split row takes two
// launches, phase 1 (absmax into `absmax`, rows uint32 zeroed by the
// caller) then phase 2 (codes and scales); the other regimes take one,
// phase 0. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a plan or phase it cannot run.
int quantize_rows(const void* x_, long long rows, long long d, void* q_,
                  void* scale_, void* absmax_, int regime, int word,
                  int phase, void* stream) {
  if (!plan_ok(rows, d, regime, word, x_, q_) ||
      (regime == SPLIT) != (phase == 1 || phase == 2) ||
      (regime != SPLIT && phase != 0) ||
      (regime == SPLIT && absmax_ == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* x = (const float*)x_;
  int8_t* q = (int8_t*)q_;
  float* scale = (float*)scale_;
  unsigned* absmax = (unsigned*)absmax_;
  const bool vec = word == 16;
  const int di = (int)d;
  switch (regime) {
    case NARROW:
      if (d == 1) return narrow_quantize<1, false>(x, rows, di, q, scale, s);
      if (d == 8 && vec) return narrow_quantize<8, true>(x, rows, di, q, scale, s);
      if (d == 9) return narrow_quantize<9, false>(x, rows, di, q, scale, s);
      return vec ? narrow_quantize<0, true>(x, rows, di, q, scale, s)
                 : narrow_quantize<0, false>(x, rows, di, q, scale, s);
    case WARP:
      if (vec)
        return launch<quantize_team_kernel<1, true>>(
            cdiv(rows, THREADS / 32), s, x, rows, di, q, scale);
      return launch<quantize_team_kernel<1, false>>(
          cdiv(rows, THREADS / 32), s, x, rows, di, q, scale);
    case BLOCK:
      if (vec)
        return launch<quantize_team_kernel<8, true>>(rows, s, x, rows, di, q,
                                                     scale);
      return launch<quantize_team_kernel<8, false>>(rows, s, x, rows, di, q,
                                                    scale);
    default: {
      const long long tiles = rows * cdiv(d, TILE);
      if (phase == 1)
        return vec ? launch<absmax_split_kernel<true>>(tiles, s, x, rows, di,
                                                       absmax)
                   : launch<absmax_split_kernel<false>>(tiles, s, x, rows, di,
                                                        absmax);
      return vec ? launch<quantize_split_kernel<true>>(
                       tiles, s, x, rows, di, (const unsigned*)absmax, q,
                       scale)
                 : launch<quantize_split_kernel<false>>(
                       tiles, s, x, rows, di, (const unsigned*)absmax, q,
                       scale);
    }
  }
}

// q: rows x d int8; scale: rows f32; out: rows x d f32; regime / word as
// for quantize_rows (one launch in every regime). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue.
int dequantize_rows(const void* q_, const void* scale_, long long rows,
                    long long d, void* out_, int regime, int word,
                    void* stream) {
  if (!plan_ok(rows, d, regime, word, out_, q_))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* q = (const int8_t*)q_;
  const float* scale = (const float*)scale_;
  float* out = (float*)out_;
  const bool vec = word == 16;
  const int di = (int)d;
  switch (regime) {
    case NARROW:
      if (d == 1) return narrow_dequantize<1, false>(q, scale, rows, di, out, s);
      if (d == 8 && vec) return narrow_dequantize<8, true>(q, scale, rows, di, out, s);
      if (d == 9) return narrow_dequantize<9, false>(q, scale, rows, di, out, s);
      return vec ? narrow_dequantize<0, true>(q, scale, rows, di, out, s)
                 : narrow_dequantize<0, false>(q, scale, rows, di, out, s);
    case WARP:
      if (vec)
        return launch<dequantize_team_kernel<1, true>>(
            cdiv(rows, THREADS / 32), s, q, scale, rows, di, out);
      return launch<dequantize_team_kernel<1, false>>(
          cdiv(rows, THREADS / 32), s, q, scale, rows, di, out);
    case BLOCK:
      if (vec)
        return launch<dequantize_team_kernel<8, true>>(rows, s, q, scale,
                                                       rows, di, out);
      return launch<dequantize_team_kernel<8, false>>(rows, s, q, scale, rows,
                                                      di, out);
    default: {
      const long long tiles = rows * cdiv(d, TILE);
      return vec ? launch<dequantize_split_kernel<true>>(tiles, s, q, scale,
                                                         rows, di, out)
                 : launch<dequantize_split_kernel<false>>(tiles, s, q, scale,
                                                          rows, di, out);
    }
  }
}

}  // extern "C"
