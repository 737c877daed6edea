// Single-token GQA attention against a ragged KV cache (flash-decode) for
// Hopper (sm_90a). Plain C interface, built by kernels/_build.py with nvcc and
// bound with ctypes in kernels/decode_attention.py, whose wrapper counts
// launches (decode_attention.launches).
//
// Replaces src/repro/kernels/decode_attention.py: decode_attention
// (_decode_kernel), a Pallas kernel whose grid (batch, kv head, kv block)
// runs the kv blocks in order on one TPU core with all m = H / G query heads
// of the group in one (m, D) VMEM tile, carrying the online-softmax state
// (m, l, acc) in scratch. Given q (B, H, D), a cache k, v (B, S, G, D) and
// lengths (B,) it computes, per query head,
//
//   s   = (q * D^-0.5) . k^T        fp32, q scaled on fp32 values
//   s   = -1e30 at cache rows >= lengths[b]
//   out = acc / max(l, 1e-30)       online softmax in fp32, cast to q's dtype
//
// The query and the cache have their own dtypes (fp32 or bf16 each): the
// serving driver keeps an fp32 cache under a bf16 model. A length outside
// [1, S] fails a device-side assert (the TPU kernel returns zeros for 0, the
// plain attention the mean of V): the launch stays free of host syncs, so a
// decode step can be captured in a CUDA graph, and the fault surfaces as a
// RuntimeError at the caller's next synchronisation, as PyTorch's own
// out-of-range indices do.
//
// Design. One block per (kv group, batch row) holds the group's m query heads
// (pre-scaled, fp32) in shared memory and walks the cache in chunks of
// BK = 64 rows up to lengths[b] only: unlike the TPU grid, rows past the
// length are never read. Per chunk: the K and V rows are staged as fp32 in
// shared memory (coalesced 16- or 8-byte loads); 4 threads per cache row
// compute its scores for up to 8 heads at once (interleaved dimensions, a
// two-step xor-shuffle sum), so each K element read from shared memory feeds
// up to 8 FMAs; one warp per head takes the chunk's max and sum and updates
// (m, l); then each (head, dimension) pair rescales its accumulator and adds
// the chunk's P.V. m, l and acc live in shared memory, since m is a run-time
// value.
//
// Bound on this card: bytes. The kernel must read the valid K and V rows once
// (2 * sum(lengths) * G * D * cache bytes), against 4 flops per cache element
// and head: at batch 4, length 4000, qwen2-1.5b's G = 2, D = 128 and an fp32
// cache that is 32.8 MB, 0.0098 ms at 3.35 TB/s. One block per (group, row)
// launches only B * G blocks (8 on 132 SMs at batch 4), so a call is bound by
// what 8 SMs can pull, far from the card's rate: splitting the cache across
// blocks with a second combine pass (split-KV) is a later change.

#include <cassert>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BK = 64;             // cache rows per chunk
constexpr int THREADS = 256;       // = BK rows x 4 threads in the score step
constexpr int HEADS_PER_PASS = 8;  // query heads a score thread holds
constexpr int kMaxSmem = 232448;   // bytes of shared memory a block may use

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&u.x);
  __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&u.y);
  float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float load1(const float* p) { return *p; }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  // element strides (the last axis is contiguous): q and o (B,H,D) by batch
  // and head; k and v (B,S,G,D) by batch, row and group
  long long q_sb, q_sh, k_sb, k_st, k_sg, v_sb, v_st, v_sg, o_sb, o_sh;
  int H, G, S;
  float scale;
};

template <int D>
int smem_floats(int m) {
  return m * D            // q
       + BK * (D + 4)     // k, rows padded by 4 floats
       + BK * D           // v
       + m * BK           // scores, then probabilities
       + m * D            // acc
       + 3 * m;           // running max, denominator, rescale factor
}

template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(DecodeArgs a) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int KS = D + 4;
  constexpr int V4 = D / 4;
  const int g = blockIdx.x, b = blockIdx.y;
  const int m = a.H / a.G;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + m * D;
  float* v_s = k_s + BK * KS;
  float* p_s = v_s + BK * D;
  float* acc_s = p_s + m * BK;
  float* m_s = acc_s + m * D;
  float* l_s = m_s + m;
  float* alpha_s = l_s + m;

  const TQ* qp = static_cast<const TQ*>(a.q) + b * a.q_sb;
  const TC* kp = static_cast<const TC*>(a.k) + b * a.k_sb + g * a.k_sg;
  const TC* vp = static_cast<const TC*>(a.v) + b * a.v_sb + g * a.v_sg;
  TQ* op = static_cast<TQ*>(a.o) + b * a.o_sb;

  for (int i = tid; i < m * D; i += THREADS) {
    const int j = i / D, d = i % D;
    q_s[i] = load1(qp + (long long)(g * m + j) * a.q_sh + d) * a.scale;
    acc_s[i] = 0.f;
  }
  for (int j = tid; j < m; j += THREADS) {
    m_s[j] = kNegInf;
    l_s[j] = 0.f;
  }

  const int length = a.lengths[b];
  assert(length >= 1 && length <= a.S);
  const int row = tid / 4, part = tid % 4;    // the score step's cache row
  for (int t0 = 0; t0 < length; t0 += BK) {
    const int n = min(BK, length - t0);
    __syncthreads();               // the last chunk's K, V and P reads done
    for (int i = tid; i < BK * V4; i += THREADS) {
      const int r = i / V4, c = (i % V4) * 4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (r < n) {
        kk = load4(kp + (long long)(t0 + r) * a.k_st + c);
        vv = load4(vp + (long long)(t0 + r) * a.v_st + c);
      }
      *reinterpret_cast<float4*>(k_s + r * KS + c) = kk;
      *reinterpret_cast<float4*>(v_s + r * D + c) = vv;
    }
    __syncthreads();

    for (int j0 = 0; j0 < m; j0 += HEADS_PER_PASS) {
      const int nj = min(HEADS_PER_PASS, m - j0);
      float s[HEADS_PER_PASS];
#pragma unroll
      for (int jj = 0; jj < HEADS_PER_PASS; ++jj) s[jj] = 0.f;
#pragma unroll 4
      for (int d = part; d < D; d += 4) {
        const float kd = k_s[row * KS + d];
#pragma unroll
        for (int jj = 0; jj < HEADS_PER_PASS; ++jj)
          if (jj < nj) s[jj] = fmaf(q_s[(j0 + jj) * D + d], kd, s[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < HEADS_PER_PASS; ++jj) {
        s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], 1);
        s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], 2);
      }
      if (part == 0) {
#pragma unroll
        for (int jj = 0; jj < HEADS_PER_PASS; ++jj)
          if (jj < nj) p_s[(j0 + jj) * BK + row] = row < n ? s[jj] : kNegInf;
      }
    }
    __syncthreads();

    for (int j = warp; j < m; j += THREADS / 32) {
      const float s0 = p_s[j * BK + lane], s1 = p_s[j * BK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[j];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      p_s[j * BK + lane] = p0;
      p_s[j * BK + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[j] = alpha;
        l_s[j] = l_s[j] * alpha + sum;
        m_s[j] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < m * D; i += THREADS) {
      const int j = i / D, d = i % D;
      const float* pj = p_s + j * BK;
      float acc = acc_s[i] * alpha_s[j];
      for (int c = 0; c < n; ++c) acc = fmaf(pj[c], v_s[c * D + d], acc);
      acc_s[i] = acc;
    }
  }
  __syncthreads();

  for (int i = tid; i < m * D; i += THREADS) {
    const int j = i / D, d = i % D;
    store1(op + (long long)(g * m + j) * a.o_sh + d,
           acc_s[i] / fmaxf(l_s[j], 1e-30f));
  }
}

// Raises a kernel's dynamic shared memory limit to `bytes` once per device
// (the first launch on each device, outside any CUDA-graph capture).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, unsigned* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (*done >> dev & 1u)) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) *done |= 1u << dev;
  return err;
}

template <typename TQ, typename TC, int D>
int launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  static unsigned done = 0;
  const int smem = smem_floats<D>(a.H / a.G) * (int)sizeof(float);
  // the limit is set once to the most any launch may use (227 KB); each
  // launch asks for what its m heads need
  cudaError_t err =
      allow_smem(decode_attention_kernel<TQ, TC, D>, kMaxSmem, &done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.G, B);
  decode_attention_kernel<TQ, TC, D><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC>
int dispatch(const DecodeArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<TQ, TC, 64>(a, B, stream);
    case 128: return launch<TQ, TC, 128>(a, B, stream);
    case 256: return launch<TQ, TC, 256>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory a launch needs, in bytes, for head dim D and m query heads
// per KV group (the wrapper refuses shapes above the card's 227 KB).
long long decode_attention_smem_bytes(int D, int m) {
  switch (D) {
    case 64: return (long long)smem_floats<64>(m) * 4;
    case 128: return (long long)smem_floats<128>(m) * 4;
    case 256: return (long long)smem_floats<256>(m) * 4;
    default: return -1;
  }
}

// q (B,H,D), k and v (B,S,G,D), o (B,H,D): device pointers, the last axis
// contiguous and every cache row 16-byte aligned; lengths (B,) int32 on the
// device, each in [1, S] (asserted on the device); strides: 10 element strides
// (q batch, head; k batch, row, group; v batch, row, group; o batch, head)
// on the host. q_dtype (also o's) and kv_dtype: 0 float32, 1 bfloat16.
// D in {64, 128, 256}. Returns cudaGetLastError() after the launch.
int decode_attention(const void* q, const void* k, const void* v,
                     const int* lengths, void* o, const long long* strides,
                     int B, int H, int G, int S, int D, int q_dtype,
                     int kv_dtype, float scale, void* stream) {
  DecodeArgs a{q, k, v, lengths, o,
               strides[0], strides[1], strides[2], strides[3], strides[4],
               strides[5], strides[6], strides[7], strides[8], strides[9],
               H, G, S, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 0 && kv_dtype == 0) return dispatch<float, float>(a, B, D, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return dispatch<float, __nv_bfloat16>(a, B, D, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return dispatch<__nv_bfloat16, float>(a, B, D, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(a, B, D, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
