// Single-token GQA attention against a ragged KV cache (flash-decode) for
// Hopper (sm_90a), split across the card's SMs (split-KV). Plain C
// interface, built by kernels/_build.py with nvcc and bound with ctypes in
// kernels/decode_attention.py, whose wrapper plans the split, allocates the
// workspace and counts launches (decode_attention.launches).
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
// Design. The grid is (split, KV group, sequence): split i of a sequence
// owns cache rows [i * rows, (i + 1) * rows), and the wrapper chooses rows
// (a multiple of the 32-row chunk) from the capacity S and from B * G
// alone (kernels/decode_attention.py: split_plan), so that the grid covers
// the 132 SMs at least twice without reading the lengths on the host. A
// split block holds the group's m pre-scaled queries in shared memory and
// walks its rows only up to lengths[b], in chunks of CH = 32 rows copied by
// 16-byte cp.async into a double buffer (the next chunk is in flight while
// this one is used): rows past the length are never read. Per chunk, 4
// threads a row compute its scores for up to 8 heads at once, one warp per
// head takes the chunk's max and sum, and each thread rescales and adds
// P.V into its (head, dimension) accumulators in registers. The block then
// writes its partial (acc[m][D], m, l) in fp32 to the workspace; a split
// that starts at or past the length writes the empty partial (m = -1e30,
// l = 0) and reads no cache row. The last block of each (sequence, group)
// to finish, found with an atomic ticket on a counter the wrapper zeroes,
// combines the used splits in index order (m* = max m_i, weights
// e^(m_i - m*) on l_i and acc_i) and writes acc / max(l, 1e-30) in q's
// dtype: one launch a call, and a fixed order, so two calls are bit-equal.
//
// Bound on this card: bytes. The kernel must read the valid K and V rows once
// (2 * sum(lengths) * G * D * cache bytes), against 4 flops per cache element
// and head: at batch 4, length 4000, qwen2-1.5b's G = 2, D = 128 and an fp32
// cache that is 32.8 MB, 0.0098 ms at 3.35 TB/s. The cache holds about 6
// flops a byte, so the CUDA cores suffice; what the design buys is enough
// blocks (512 at that shape) and enough bytes in flight on every SM.

#include <cassert>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int CH = 32;             // cache rows a chunk
constexpr int THREADS = 128;       // = CH rows x 4 threads in the score step
constexpr int HEADS_PER_PASS = 8;  // query heads a score thread holds
constexpr int MAX_HEADS = 16;      // query heads per KV group
constexpr int kMaxSmem = 232448;   // bytes of shared memory a block may use

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  float* part;      // (B, G, splits, P): acc[m][D], m[m], l[m], P the
                    // multiple of 4 at or above m * (D + 2)
  int* tickets;     // (B, G) zeros: blocks of the (sequence, group) done
  // element strides (the last axis is contiguous): q and o (B,H,D) by batch
  // and head; k and v (B,S,G,D) by batch, row and group
  long long q_sb, q_sh, k_sb, k_st, k_sg, v_sb, v_st, v_sg, o_sb, o_sh;
  int H, G, S, splits, rows;
  float scale;
};

// Shared memory of a block: q (m x D fp32), two chunk stages of K (rows
// padded by KPAD elements) and V, the chunk's scores (m x CH), m, l, alpha,
// and the flag of the combining block (all dynamic: the limit set below is
// the most a block may use). At most 154 KB (m = 16, D = 256, fp32 cache).
constexpr int KPAD = 16;
template <typename TC, int D>
int smem_bytes(int m) {
  return 4 * m * D + 2 * CH * (2 * D + KPAD) * (int)sizeof(TC)
       + 4 * m * CH + 4 * 3 * m + 4;
}

// n consecutive values of a shared-memory row as floats, in one load of
// 4 * n or 2 * n bytes (or two of 16).
template <int N>
__device__ __forceinline__ void load_row(const float* p, float* out) {
  static_assert(N == 2 || N == 4 || N == 8, "2, 4 or 8 values");
  if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      out[i] = x.x; out[i + 1] = x.y; out[i + 2] = x.z; out[i + 3] = x.w;
    }
  }
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
  static_assert(N == 2 || N == 4 || N == 8, "2, 4 or 8 values");
  uint32_t u[N / 2];
  if constexpr (N == 2) {
    u[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    u[0] = x.x; u[1] = x.y;
  } else {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    u[0] = x.x; u[1] = x.y; u[2] = x.z; u[3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(DecodeArgs a) {
  static_assert(D % 64 == 0 && D <= 256, "D of 64, 128 or 256");
  constexpr int VEC = 16 / (int)sizeof(TC);       // elements a 16-byte copy
  constexpr int RV = D / VEC;                     // copies a row
  // K rows padded so that a quarter-warp's 16-byte (8-byte for bf16) reads
  // of 2 (4) rows x 4 column blocks fall in distinct banks
  constexpr int KS = D + KPAD;
  constexpr int STAGE = CH * (KS + D);            // elements of a stage
  // the P.V step: warp w adds the chunk's rows 8 w .. 8 w + 7; lane owns
  // dimensions VPT * lane .. + VPT - 1 of every head
  constexpr int VPT = D / 32;
  constexpr int RPW = CH / (THREADS / 32);
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int m = a.H / a.G;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  TC* kv_s = reinterpret_cast<TC*>(q_s + m * D);  // stage st: K, then V
  float* p_s = reinterpret_cast<float*>(kv_s + 2 * STAGE);
  float* m_s = p_s + m * CH;
  float* l_s = m_s + m;
  float* alpha_s = l_s + m;
  int* last = reinterpret_cast<int*>(alpha_s + m);

  const TQ* qp = static_cast<const TQ*>(a.q) + b * a.q_sb;
  const TC* kp = static_cast<const TC*>(a.k) + b * a.k_sb + g * a.k_sg;
  const TC* vp = static_cast<const TC*>(a.v) + b * a.v_sb + g * a.v_sg;
  // a partial: acc (m x D), m (m), l (m), padded to 16 bytes
  const int pstride = (m * (D + 2) + 3) / 4 * 4;
  float* part_bg = a.part + (long long)(b * a.G + g) * a.splits * pstride;
  float* part = part_bg + split * pstride;

  const int length = a.lengths[b];
  assert(length >= 1 && length <= a.S);
  const int t_begin = split * a.rows;
  const int t_end = min(t_begin + a.rows, length);

  auto load_chunk = [&](int st, int t0) {
    const int n = min(CH, t_end - t0);
    TC* k_st = kv_s + st * STAGE;
    TC* v_st = k_st + CH * KS;
    for (int i = tid; i < n * RV; i += THREADS) {
      const int r = i / RV, c = (i % RV) * VEC;
      cp_async16(k_st + r * KS + c, kp + (long long)(t0 + r) * a.k_st + c);
      cp_async16(v_st + r * D + c, vp + (long long)(t0 + r) * a.v_st + c);
    }
    cp_async_commit();
  };

  if (t_begin < t_end) {
    load_chunk(0, t_begin);
    for (int i = tid; i < m * D; i += THREADS) {
      const int j = i / D, d = i % D;
      q_s[i] = to_f32(qp[(long long)(g * m + j) * a.q_sh + d]) * a.scale;
    }
    for (int j = tid; j < m; j += THREADS) {
      m_s[j] = kNegInf;
      l_s[j] = 0.f;
    }
    float acc[MAX_HEADS][VPT];
#pragma unroll
    for (int j = 0; j < MAX_HEADS; ++j)
#pragma unroll
      for (int e = 0; e < VPT; ++e) acc[j][e] = 0.f;

    // the score step: 4 threads a cache row, each over the column blocks
    // 4 qpart + 16 i
    const int row = tid / 4, qpart = tid % 4;
    for (int t0 = t_begin, st = 0; t0 < t_end; t0 += CH, st ^= 1) {
      const int n = min(CH, t_end - t0);
      if (t0 + CH < t_end) {
        load_chunk(st ^ 1, t0 + CH);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();             // this chunk (and q on the first) is in
      const TC* k_st = kv_s + st * STAGE;
      const TC* v_st = k_st + CH * KS;

      for (int j0 = 0; j0 < m; j0 += HEADS_PER_PASS) {
        const int nj = min(HEADS_PER_PASS, m - j0);
        float s[HEADS_PER_PASS];
#pragma unroll
        for (int jj = 0; jj < HEADS_PER_PASS; ++jj) s[jj] = 0.f;
        if (row < n) {
#pragma unroll 2
          for (int d = 4 * qpart; d < D; d += 16) {
            float kd[4];
            load_row<4>(k_st + row * KS + d, kd);
#pragma unroll
            for (int jj = 0; jj < HEADS_PER_PASS; ++jj)
              if (jj < nj) {
                const float4 qv =
                    *reinterpret_cast<const float4*>(q_s + (j0 + jj) * D + d);
                s[jj] = fmaf(qv.x, kd[0], s[jj]);
                s[jj] = fmaf(qv.y, kd[1], s[jj]);
                s[jj] = fmaf(qv.z, kd[2], s[jj]);
                s[jj] = fmaf(qv.w, kd[3], s[jj]);
              }
          }
        }
#pragma unroll
        for (int jj = 0; jj < HEADS_PER_PASS; ++jj) {
          s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], 1);
          s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], 2);
        }
        if (qpart == 0) {
#pragma unroll
          for (int jj = 0; jj < HEADS_PER_PASS; ++jj)
            if (jj < nj)
              p_s[(j0 + jj) * CH + row] = row < n ? s[jj] : kNegInf;
        }
      }
      __syncthreads();

      for (int j = warp; j < m; j += THREADS / 32) {
        const float x = p_s[j * CH + lane];
        float mx = x;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = m_s[j];
        const float m_new = fmaxf(m_old, mx);
        const float p = expf(x - m_new);
        p_s[j * CH + lane] = p;
        float sum = p;
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

#pragma unroll
      for (int j = 0; j < MAX_HEADS; ++j)
        if (j < m)
#pragma unroll
          for (int e = 0; e < VPT; ++e) acc[j][e] *= alpha_s[j];
      const int r0 = RPW * warp;
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        if (r0 + rr < n) {
          float vv[VPT];
          load_row<VPT>(v_st + (r0 + rr) * D + VPT * lane, vv);
#pragma unroll
          for (int j = 0; j < MAX_HEADS; ++j)
            if (j < m) {
              const float p = p_s[j * CH + r0 + rr];
#pragma unroll
              for (int e = 0; e < VPT; ++e)
                acc[j][e] = fmaf(p, vv[e], acc[j][e]);
            }
        }
      }
      __syncthreads();             // the stage is free for the next copy
    }

    // the warps' row sums, added in warp order through the stage buffers
    float* red = reinterpret_cast<float*>(kv_s);
#pragma unroll
    for (int j = 0; j < MAX_HEADS; ++j)
      if (j < m)
#pragma unroll
        for (int e = 0; e < VPT; ++e)
          red[(warp * m + j) * D + VPT * lane + e] = acc[j][e];
    __syncthreads();
    for (int i = tid; i < m * D; i += THREADS) {
      float x = red[i];
      for (int w = 1; w < THREADS / 32; ++w) x += red[w * m * D + i];
      part[i] = x;
    }
    for (int j = tid; j < m; j += THREADS) {
      part[m * D + j] = m_s[j];
      part[m * D + m + j] = l_s[j];
    }
  } else {                         // past the length: the empty partial
    for (int j = tid; j < m; j += THREADS) {
      part[m * D + j] = kNegInf;
      part[m * D + m + j] = 0.f;
    }
  }

  // the last block of this (sequence, group) to finish combines
  __threadfence();
  __syncthreads();
  if (tid == 0)
    *last = atomicAdd(a.tickets + b * a.G + g, 1) == a.splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();

  // m* of each head: one warp a head, its lanes over the used splits
  const int used = (length + a.rows - 1) / a.rows;   // splits with rows
  for (int j = warp; j < m; j += THREADS / 32) {
    float mx = kNegInf;
    for (int i = lane; i < used; i += 32)
      mx = fmaxf(mx, __ldcg(part_bg + i * pstride + m * D + j));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) m_s[j] = mx;
  }
  // then the partials in batches through the stage buffers (16-byte
  // cp.async, all in flight at once), summed in split order: thread t owns
  // the float4s t + THREADS * u of the (m, D) accumulator
  constexpr int SLOTS = MAX_HEADS * D / 4 / THREADS;
  float4 acc[SLOTS];
  float l[SLOTS];
#pragma unroll
  for (int u = 0; u < SLOTS; ++u) {
    acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    l[u] = 0.f;
  }
  float* buf = reinterpret_cast<float*>(kv_s);
  const int batch = 2 * STAGE * (int)sizeof(TC) / (4 * pstride);
  for (int i0 = 0; i0 < used; i0 += batch) {
    const int nb = min(batch, used - i0);
    __syncthreads();               // m_s is set; the last batch is read
    for (int e = tid; e < nb * pstride / 4; e += THREADS)
      cp_async16(buf + 4 * e, part_bg + i0 * pstride + 4 * e);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      const int e = tid + THREADS * u, j = 4 * e / D;
      if (j < m) {
        for (int i = 0; i < nb; ++i) {
          const float* pi = buf + i * pstride;
          const float wgt = expf(pi[m * D + j] - m_s[j]);
          const float4 x = reinterpret_cast<const float4*>(pi)[e];
          acc[u].x = fmaf(x.x, wgt, acc[u].x);
          acc[u].y = fmaf(x.y, wgt, acc[u].y);
          acc[u].z = fmaf(x.z, wgt, acc[u].z);
          acc[u].w = fmaf(x.w, wgt, acc[u].w);
          l[u] = fmaf(pi[m * D + m + j], wgt, l[u]);
        }
      }
    }
  }
  TQ* op = static_cast<TQ*>(a.o) + b * a.o_sb;
#pragma unroll
  for (int u = 0; u < SLOTS; ++u) {
    const int e = tid + THREADS * u, j = 4 * e / D, d = 4 * e % D;
    if (j < m) {
      const float l_max = fmaxf(l[u], 1e-30f);
      TQ* out = op + (long long)(g * m + j) * a.o_sh + d;
      store1(out, acc[u].x / l_max);
      store1(out + 1, acc[u].y / l_max);
      store1(out + 2, acc[u].z / l_max);
      store1(out + 3, acc[u].w / l_max);
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

template <typename TQ, typename TC, int D>
int launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  static unsigned done = 0;
  const int smem = smem_bytes<TC, D>(a.H / a.G);
  // the limit is set once to the most any launch may use (227 KB); each
  // launch asks for what its m heads need
  cudaError_t err =
      allow_smem(decode_attention_kernel<TQ, TC, D>, kMaxSmem, &done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.splits, a.G, B);
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

// q (B,H,D), k and v (B,S,G,D), o (B,H,D): device pointers, the last axis
// contiguous and every cache row 16-byte aligned; lengths (B,) int32 on the
// device, each in [1, S] (asserted on the device); strides: 10 element strides
// (q batch, head; k batch, row, group; v batch, row, group; o batch, head)
// on the host. q_dtype (also o's) and kv_dtype: 0 float32, 1 bfloat16.
// D in {64, 128, 256}, H / G at most 16. The split: `splits` blocks of
// `rows` cache rows (a multiple of 32) for each (sequence, group), with
// splits * rows >= S; part: B * G * splits * (H / G) * (D + 2) floats of
// workspace; tickets: B * G int32 zeros. Returns cudaGetLastError() after
// the launch.
int decode_attention(const void* q, const void* k, const void* v,
                     const int* lengths, void* o, const long long* strides,
                     int B, int H, int G, int S, int D, int q_dtype,
                     int kv_dtype, float scale, void* part, int* tickets,
                     int splits, int rows, void* stream) {
  if (H / G > MAX_HEADS || rows % CH || (long long)splits * rows < S)
    return (int)cudaErrorInvalidValue;
  DecodeArgs a{q, k, v, lengths, o, static_cast<float*>(part), tickets,
               strides[0], strides[1], strides[2], strides[3], strides[4],
               strides[5], strides[6], strides[7], strides[8], strides[9],
               H, G, S, splits, rows, scale};
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
