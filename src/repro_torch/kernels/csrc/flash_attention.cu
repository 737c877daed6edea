// Blocked online-softmax GQA attention (prefill) in float32 on the CUDA
// cores, for Hopper (sm_90a). Plain C interface, built by kernels/_build.py
// with nvcc and bound with ctypes in kernels/flash_attention.py, which sends
// float32 calls here and bfloat16 calls to flash_attention_sm90.cu (wgmma
// and TMA); the wrapper counts launches of both (flash_attention.launches).
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention
// (_flash_kernel), a Pallas kernel whose grid (batch, head, q block, kv
// block) runs the kv axis in order on one TPU core, carrying the running
// max m, denominator l and accumulator acc in VMEM scratch from one kv
// block to the next. Given q (B, H, S, D) and k, v (B, G, T, D) with
// H = G * m it computes, per query row,
//
//   s   = (q * D^-0.5) . k^T             fp32, q scaled on fp32 values
//   s   = -1e30 where masked             causal: key index > query index
//   out = softmax(s) . v                 online: m, l, acc in fp32
//   out = acc / max(l, 1e-30)            cast to q's dtype
//
// The -1e30 mask (not -inf) keeps exp(m_prev - m_new) away from inf - inf.
//
// Design. One block per (q tile of BQ = 64 rows, head, batch); the loop over
// kv tiles of BK = 64 keys inside the block takes the place of the TPU's
// sequential kv grid axis, so m, l and acc stay in registers for the whole
// sweep. Causal: kv tiles wholly above the diagonal are never visited, and
// the q tiles are handed out last-first so the longest sweeps start first.
// The head's KV group is h / (H / G), as the TPU index map has it. The ragged
// edge is masked here rather than padded by the caller: keys >= T score
// -1e30 (their rows are zero-filled), queries >= S run on zeros and are never
// written. 256 threads; thread (ty, tx) = (tid / 16, tid % 16) owns query rows
// ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and output columns
// 4 tx + 64 jj .. + 3. A row's 64 scores live in the 16 lanes of one
// half-warp, so its max and sum are four xor-shuffles. Q (pre-scaled) and K
// tiles sit in shared memory as fp32 with rows padded by 4 floats (no bank
// conflicts for the 16-byte loads); P = exp(s - m) goes through shared memory
// (reusing the K tile) for the P.V product.
//
// Bound on this card: operations, 2 * B * H * S^2 * D flops for causal
// prefill. This kernel computes in fp32 on the CUDA cores (67 TFLOP/s peak)
// and so stays far from the 989 TFLOP/s of the bf16 tensor cores; it keeps
// the float32 path within 2e-5 of the plain version, which TF32 tensor cores
// (about three digits) would not. No main path runs attention in float32:
// the model's bf16 prefill and training run on flash_attention_sm90.cu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides of the batch, head and row axes (the last axis is
  // contiguous): q (B,H,S,D), k and v (B,G,T,D), o (B,H,S,D)
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int H, G, S, T, causal;
  float scale;
};

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 4) + BK * (D + 4) + BK * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(FlashArgs a) {
  static_assert(D % 64 == 0, "D must be a multiple of 64");
  constexpr int QS = D + 4;        // padded row stride of the Q and K tiles
  constexpr int PS = BK + 4;       // padded row stride of P (in the K tile)
  constexpr int V4 = D / 4;        // 4-element vectors in a row
  constexpr int DJ = D / 64;       // output vectors per thread and row
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + BQ * QS;
  float* v_s = k_s + BK * QS;
  float* p_s = k_s;                // P reuses the K tile once scores are in

  const int n_qt = (a.S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh;
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < BQ * V4; i += THREADS) {
    const int r = i / V4, c = (i % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < a.S) x = load4(qp + (long long)(q0 + r) * a.q_ss + c);
    x.x *= a.scale; x.y *= a.scale; x.z *= a.scale; x.w *= a.scale;
    store4(q_s + r * QS + c, x);
  }

  float m_run[4], l_run[4], acc[4][DJ * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DJ * 4; ++e) acc[i][e] = 0.f;
  }

  int n_kt = (a.T + BK - 1) / BK;
  if (a.causal) {
    const int last_q = min(q0 + BQ, a.S) - 1;
    n_kt = min(n_kt, last_q / BK + 1);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();               // the last tile's P and V reads are done
    for (int i = tid; i < BK * V4; i += THREADS) {
      const int r = i / V4, c = (i % V4) * 4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (k0 + r < a.T) {
        kk = load4(kp + (long long)(k0 + r) * a.k_ss + c);
        vv = load4(vp + (long long)(k0 + r) * a.v_ss + c);
      }
      store4(k_s + r * QS + c, kk);
      store4(v_s + r * D + c, vv);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(q_s + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = load4(k_s + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    __syncthreads();               // every K read is done: P may overwrite

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < a.T && (!a.causal || qpos >= kpos);
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[(ty + 16 * i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int e = 0; e < DJ * 4; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = load4(p_s + (ty + 16 * i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          const float4 vv = load4(v_s + (c + cc) * D + 4 * tx + 64 * jj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y
                          : cc == 2 ? pv[i].z : pv[i].w;
            acc[i][jj * 4 + 0] = fmaf(p, vv.x, acc[i][jj * 4 + 0]);
            acc[i][jj * 4 + 1] = fmaf(p, vv.y, acc[i][jj * 4 + 1]);
            acc[i][jj * 4 + 2] = fmaf(p, vv.z, acc[i][jj * 4 + 2]);
            acc[i][jj * 4 + 3] = fmaf(p, vv.w, acc[i][jj * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.S) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      float4 o;
      o.x = acc[i][jj * 4 + 0] / l;
      o.y = acc[i][jj * 4 + 1] / l;
      o.z = acc[i][jj * 4 + 2] / l;
      o.w = acc[i][jj * 4 + 3] / l;
      store4(op + (long long)row * a.o_ss + 4 * tx + 64 * jj, o);
    }
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

template <typename T, int D>
int launch(const FlashArgs& a, int B, cudaStream_t stream) {
  static unsigned done = 0;
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = allow_smem(flash_attention_kernel<T, D>, smem, &done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  flash_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const FlashArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    case 256: return launch<T, 256>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B,H,S,D), k and v (B,G,T,D), o (B,H,S,D): device pointers, the last
// axis contiguous and every row 16-byte aligned; strides: 12 element
// strides (batch, head, row) of q, k, v, o in that order, on the host.
// dtype: 0 float32 (q, k, v and o alike; bfloat16 goes to
// flash_attention_sm90). D in {64, 128, 256}. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unsupported D or dtype).
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    const long long* strides, int B, int H, int G, int S,
                    int T, int D, int causal, int dtype, float scale,
                    void* stream) {
  FlashArgs a{q, k, v, o,
              strides[0], strides[1], strides[2], strides[3], strides[4],
              strides[5], strides[6], strides[7], strides[8], strides[9],
              strides[10], strides[11],
              H, G, S, T, causal, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(a, B, D, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
