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
//   s   = (q * D^-0.5) . k^T        fp32, q scaled on fp32 values (the
//                                   tensor-core path: q . k^T, then scaled)
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
// Two paths, chosen by the dtypes alone (the C entry point below): a bf16
// query against a bf16 cache takes the tensor-core kernel
// (decode_attention_mma_kernel); every other pair (an fp32 cache, an fp32
// query) takes the CUDA-core kernel (decode_attention_kernel). Both split
// each sequence's cache into runs of rows planned by the wrapper from the
// capacity S and from B * G alone (kernels/decode_attention.py:
// split_plan, mma_split_plan), so that the lengths stay on the card; both
// combine the splits in one launch through an atomic ticket, in split
// order, so two calls are bit-equal.
//
// The CUDA-core path. The grid is (split, KV group, sequence): split i of
// a sequence owns cache rows [i * rows, (i + 1) * rows), rows a multiple
// of the 32-row chunk, chosen so that the grid covers the 132 SMs at
// least twice. A split block holds the group's m pre-scaled queries in
// shared memory and walks its rows only up to lengths[b], in chunks of
// CH = 32 rows copied by 16-byte cp.async into a double buffer (the next
// chunk is in flight while this one is used): rows past the length are
// never read. Per chunk, 4 threads a row compute its scores for up to 8
// heads at once, one warp per head takes the chunk's max and sum, and
// each thread rescales and adds P.V into its (head, dimension)
// accumulators in registers. The block then writes its partial (acc[m][D],
// m, l) in fp32 to the workspace; a split that starts at or past the
// length writes the empty partial (m = -1e30, l = 0) and reads no cache
// row. The last block of each (sequence, group) to finish, found with an
// atomic ticket on a counter the wrapper zeroes, combines the used splits
// in index order (m* = max m_i, weights e^(m_i - m*) on l_i and acc_i) and
// writes acc / max(l, 1e-30) in q's dtype.
//
// Its bound: bytes. It must read the valid K and V rows once (2 *
// sum(lengths) * G * D * cache bytes), against 4 flops per cache element
// and head: at batch 4, length 4000, qwen2-1.5b's G = 2, D = 128 and an
// fp32 cache that is 32.8 MB, 0.0098 ms at 3.35 TB/s. An fp32 cache holds
// 2 m / 4 = 3 flops a byte at m = 6 heads a group, so for an fp32 cache the
// CUDA cores suffice; what the design buys is enough blocks (512 at that
// shape) and enough bytes in flight on every SM.
//
// The tensor-core path (bf16 q and cache, D of 64, 128 or 256, m <= 16).
// At the qwen2-1.5b decode cell's shape (B 128, H 12, G 2, D 128, S 16,384,
// lengths in [6,144, 12,288)) a call reads ~1.21 GB of live rows, 0.36 ms
// at 3.35 TB/s, against 2 m / 2 = 6 flops a cache byte (m = 6 heads a
// group): far below the ~295 flops a byte where the tensor cores become
// the limit, so the bound is bytes again. But at 6 flops a byte of bf16,
// the CUDA-core
// loop needs ~20 TFLOP/s of fp32 FMA with a 4-byte shared-memory read of q
// for each, which caps it near the shared-memory port's rate (~45% of the
// bound even with enough splits). So here:
//
// - Products on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//   accumulate). The group's m query heads are the M rows (rows past m
//   zero) and stay in registers as A fragments for the whole walk; K and V
//   go from shared memory to the tensor cores by ldmatrix, each element
//   read once, not once per head. Scores are the exact products of the
//   bf16 values summed in fp32, then times `scale` in fp32; the online
//   softmax stays in fp32 in registers; P enters P.V as a bf16 hi + lo pair
//   (two products into the same fp32 accumulator), so P keeps ~16 bits of
//   significand and is never rounded to bf16 alone. l sums the fp32 P.
// - A copy ring per warp. Each of the block's 4 warps walks its own 16 of
//   every 64-row step (rows 16 w .. 16 w + 15) through a ring of NST = 3
//   stages of K and V (16 rows each, padded rows so ldmatrix reads hit
//   distinct banks), filled by 16-byte cp.async with zero fill past the
//   length, so rows past it are never read and score -1e30 against zeros.
//   A warp waits only on its own copies (cp.async.wait_group, __syncwarp):
//   no block barrier in the walk. Two stages of every warp are in flight
//   while it computes: 128 KB a SM at D = 128 (two 102 KB blocks a SM).
// - A plan that keeps the card fed (mma_split_plan): splits of S * B * G /
//   264 rows, rounded up to the 64-row step and held within [256, 1024].
//   A short or narrow cache runs about one wave of blocks, each walking
//   four steps or more (a block's set-up, merge and partial cost as much
//   as a few steps: on an H100, 64-row splits ran 1.8-2.1 times as long
//   at batch 4); a
//   long one runs many waves of 1,024-row splits, and no block walks more
//   than that alone. A split past the length writes the empty partial
//   and exits. After the walk the warps' states are merged in
//   warp order through shared memory into the block's partial, and the
//   ticket's last block combines the used splits as on the CUDA-core path.

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

// ---- the tensor-core path: bf16 q against a bf16 cache ----

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int WROWS = 16;                  // cache rows a warp takes a step
constexpr int TILE = MMA_WARPS * WROWS;    // rows a block takes a step
constexpr int NST = 3;                     // ring stages of each warp
constexpr int RPAD = 8;                    // bf16 elements of row padding

// Shared memory of a block: each warp's ring of NST stages of K and V
// (WROWS rows of D + RPAD elements each); after the walk the same bytes
// hold the warps' states for the merge. 102 KB at D = 128, 198 KB at 256.
template <int D>
constexpr int mma_smem_bytes() {
  return MMA_WARPS * NST * 2 * WROWS * (D + RPAD) * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes (nothing read) where
// `valid` is false.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Two fp32 values as bf16 pairs hi + lo: hi the nearest bf16, lo the
// nearest bf16 to what hi leaves.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Fragments (mma.sync m16n8k16): lane l holds, of the 16 x 8 accumulator,
// rows r = l / 4 and r + 8 at columns c = 2 (l % 4) and c + 1 (c[0], c[1]
// and c[2], c[3]). Rows are query heads; columns are cache rows (scores) or
// dimensions (P.V).
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
decode_attention_mma_kernel(DecodeArgs a) {
  static_assert(D % 64 == 0 && D <= 256, "D of 64, 128 or 256");
  constexpr int RS = D + RPAD;         // elements a ring row
  constexpr int BUF = WROWS * RS;      // elements of K (or V) a stage
  constexpr int KSTEPS = D / 16;       // k-steps of q . k^T
  constexpr int NT = D / 8;            // n-tiles of P . V
  constexpr int CPR = D / 8;           // 16-byte copies a row
  constexpr int CPL = WROWS * CPR / 32;  // copies a lane of K (and V) a step
  using bf16 = __nv_bfloat16;
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int m = a.H / a.G;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int fr = lane / 4, fc = 2 * (lane % 4);   // fragment row, column

  extern __shared__ float4 smem4[];
  bf16* ring = reinterpret_cast<bf16*>(smem4) + warp * NST * 2 * BUF;
  __shared__ float m_s[MAX_HEADS];
  __shared__ int last;

  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb
                 + (long long)g * m * a.q_sh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + g * a.k_sg;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + g * a.v_sg;
  const int pstride = (m * (D + 2) + 3) / 4 * 4;
  float* part_bg = a.part + (long long)(b * a.G + g) * a.splits * pstride;
  float* part = part_bg + split * pstride;

  const int length = a.lengths[b];
  assert(length >= 1 && length <= a.S);
  const int t_begin = split * a.rows;
  const int t_end = min(t_begin + a.rows, length);

  if (t_begin < t_end) {
    // this warp's rows of step i: t_begin + TILE i + WROWS warp + [0, WROWS)
    const int w0 = t_begin + WROWS * warp;
    const int steps = w0 < t_end ? (t_end - w0 + TILE - 1) / TILE : 0;
    auto load = [&](int i) {
      if (i < steps) {
        const int t0 = w0 + TILE * i;
        bf16* k_st = ring + (i % NST) * 2 * BUF;
        bf16* v_st = k_st + BUF;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int e = lane + 32 * c, r = e / CPR, col = e % CPR * 8;
          const bool ok = t0 + r < t_end;
          const long long t = ok ? t0 + r : t_begin;
          cp_async16_zfill(k_st + r * RS + col, kp + t * a.k_st + col, ok);
          cp_async16_zfill(v_st + r * RS + col, vp + t * a.v_st + col, ok);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < NST - 1; ++i) load(i);

    // q as A fragments: heads fr and fr + 8 (zero past m), dimensions
    // 16 ks + fc (+1) and + 8
    uint32_t qa[KSTEPS][4];
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = fr + 8 * (r & 1), d = 16 * ks + fc + 8 * (r >> 1);
        qa[ks][r] = j < m ? *reinterpret_cast<const uint32_t*>(
                                qp + (long long)j * a.q_sh + d)
                          : 0u;
      }

    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    float mrow[2] = {kNegInf, kNegInf}, lrow[2] = {0.f, 0.f};
    // ldmatrix addresses: lane l feeds row l % 8 of matrix l / 8
    const int lm = lane / 8, lr = lane % 8;

    for (int i = 0; i < steps; ++i) {
      __syncwarp();                // step i - 1's stage is read
      load(i + NST - 1);
      cp_async_wait<NST - 1>();    // this lane's copies of step i are in
      __syncwarp();                // and every lane's
      const bf16* k_st = ring + (i % NST) * 2 * BUF;
      const bf16* v_st = k_st + BUF;

      // scores of 16 heads x 16 rows: n-tile n holds rows 8 n + [0, 8)
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        // matrix lm of four: rows 8 (lm / 2) +, dims 16 ks + 8 (lm % 2) +
        uint32_t kb[4];
        ldmatrix_x4(kb, k_st + (8 * (lm >> 1) + lr) * RS + 16 * ks
                            + 8 * (lm & 1));
        mma_bf16(s[0], qa[ks], kb[0], kb[1]);
        mma_bf16(s[1], qa[ks], kb[2], kb[3]);
      }
      const int t0 = w0 + TILE * i;
      float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = t0 + 8 * n + fc + (e & 1) < t_end;
          s[n][e] = ok ? s[n][e] * a.scale : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = expf(mrow[h] - mx[h]);
        mrow[h] = mx[h];
        lrow[h] *= alpha[h];
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = expf(s[n][e] - mx[e >> 1]);
          lrow[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
        o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
      }
      // P as A fragments (rows 8 n-tile + fc of the k-step), hi and lo
      uint32_t ph[4], pl[4];
      split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
      split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
      split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
      split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        // matrix lm of four: rows 8 (lm % 2) +, dims 16 dt + 8 (lm / 2) +
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_st + (8 * (lm & 1) + lr) * RS + 16 * dt
                                  + 8 * (lm >> 1));
        mma_bf16(o[2 * dt], ph, vb[0], vb[1]);
        mma_bf16(o[2 * dt], pl, vb[0], vb[1]);
        mma_bf16(o[2 * dt + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * dt + 1], pl, vb[2], vb[3]);
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 1);
      lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 2);
    }

    // merge the warps' states in warp order through the ring's bytes:
    // o (m x D), then m and l of each head, a warp after another
    __syncthreads();
    float* st = reinterpret_cast<float*>(smem4);
    const int wstride = m * (D + 2);
    float* mine = st + warp * wstride;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = fr + 8 * h;
      if (j < m) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<float2*>(mine + j * D + 8 * n + fc) =
              make_float2(o[n][2 * h], o[n][2 * h + 1]);
        if (lane % 4 == 0) {
          mine[m * D + j] = mrow[h];
          mine[m * D + m + j] = lrow[h];
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < m * D + m; idx += MMA_THREADS) {
      const int j = idx < m * D ? idx / D : idx - m * D;
      float mb = kNegInf;
#pragma unroll
      for (int w = 0; w < MMA_WARPS; ++w)
        mb = fmaxf(mb, st[w * wstride + m * D + j]);
      float x = 0.f;
      const int from = idx < m * D ? idx : m * D + m + j;
#pragma unroll
      for (int w = 0; w < MMA_WARPS; ++w)
        x = fmaf(st[w * wstride + from],
                 expf(st[w * wstride + m * D + j] - mb), x);
      if (idx < m * D) {
        part[idx] = x;
      } else {
        part[m * D + j] = mb;
        part[m * D + m + j] = x;
      }
    }
  } else {                         // past the length: the empty partial
    for (int j = tid; j < m; j += MMA_THREADS) {
      part[m * D + j] = kNegInf;
      part[m * D + m + j] = 0.f;
    }
  }

  // the last block of this (sequence, group) to finish combines the used
  // splits in index order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + b * a.G + g, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int used = (length + a.rows - 1) / a.rows;
  for (int j = warp; j < m; j += MMA_WARPS) {
    float mx = kNegInf;
    for (int i = lane; i < used; i += 32)
      mx = fmaxf(mx, __ldcg(part_bg + i * pstride + m * D + j));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) m_s[j] = mx;
  }
  __syncthreads();
  bf16* op = static_cast<bf16*>(a.o) + b * a.o_sb;
  for (int e = tid; e < m * D / 4; e += MMA_THREADS) {
    const int j = 4 * e / D, d = 4 * e % D;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
#pragma unroll 4
    for (int i = 0; i < used; ++i) {
      const float* pi = part_bg + i * pstride;
      const float wgt = expf(__ldcg(pi + m * D + j) - m_s[j]);
      const float4 x = __ldcg(reinterpret_cast<const float4*>(pi) + e);
      acc.x = fmaf(x.x, wgt, acc.x);
      acc.y = fmaf(x.y, wgt, acc.y);
      acc.z = fmaf(x.z, wgt, acc.z);
      acc.w = fmaf(x.w, wgt, acc.w);
      l = fmaf(__ldcg(pi + m * D + m + j), wgt, l);
    }
    const float l_max = fmaxf(l, 1e-30f);
    bf16* out = op + (long long)(g * m + j) * a.o_sh + d;
    store1(out, acc.x / l_max);
    store1(out + 1, acc.y / l_max);
    store1(out + 2, acc.z / l_max);
    store1(out + 3, acc.w / l_max);
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

template <int D>
int launch_mma(const DecodeArgs& a, int B, cudaStream_t stream) {
  static unsigned done = 0;
  constexpr int smem = mma_smem_bytes<D>();
  cudaError_t err = allow_smem(decode_attention_mma_kernel<D>, smem, &done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.splits, a.G, B);
  decode_attention_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch_mma(const DecodeArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_mma<64>(a, B, stream);
    case 128: return launch_mma<128>(a, B, stream);
    case 256: return launch_mma<256>(a, B, stream);
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
// `rows` cache rows (a multiple of 32; of 64 where q and the cache are both
// bfloat16, the tensor-core path) for each (sequence, group), with
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
    return rows % TILE ? (int)cudaErrorInvalidValue
                       : dispatch_mma(a, B, D, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
