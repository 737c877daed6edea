// Blocked online-softmax GQA attention (prefill) in bfloat16 on Hopper's
// tensor cores (sm_90a): wgmma on bf16 tiles fed by TMA. Plain C interface,
// built by kernels/_build.py with nvcc (linked with -lcuda for the tensor-map
// encoder) and bound with ctypes in kernels/flash_attention.py, which sends
// bfloat16 calls here and float32 calls to flash_attention.cu; the wrapper
// counts launches of both (flash_attention.launches).
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention
// (_flash_kernel), a Pallas kernel whose grid (batch, head, q block, kv
// block) runs the kv axis in order on one TPU core, carrying the running
// max m, denominator l and accumulator acc in VMEM scratch. Given q
// (B, H, S, D) and k, v (B, G, T, D) with H = G * m it computes, per query
// row,
//
//   s   = (q . k^T) * D^-0.5             bf16 x bf16 products summed in fp32,
//                                        then scaled in fp32
//   s   = -1e30 where masked             key >= T; causal: key > query
//   p   = exp(s - m), rounded to bf16    online softmax: m, l in fp32
//   out = (p . v) / max(l, 1e-30)        l sums the unrounded p; cast to bf16
//
// Two departures from the plain version (kernels/ref.py), which scales q on
// fp32 values before the product and keeps p in fp32: scaling after the
// product differs only by fp32 rounding (a bf16 x bf16 product is exact in
// fp32), and p is rounded to bf16 to be wgmma's A operand. The output is
// bf16 anyway; tests/test_torch_attention_sm90.py holds an emulation of both
// roundings within 2e-2 of the reference's Pallas kernel on the CPU.
//
// Design. One CTA per (128-query tile, head, batch): two consumer
// warpgroups of 64 query rows each share one K/V stream, and a producer
// warpgroup (one elected thread) issues the TMA loads; setmaxnreg moves its
// registers to the consumers (24 and 240 a thread). Q is loaded once; K and V
// tiles of BN keys go through a ring of 2 stages in shared memory, each with
// a full mbarrier (the TMA's transaction count) and an empty one (every
// consumer thread arrives when its wgmmas have read the stage). The tensors
// are described as 4-D TMA maps over the caller's strides (d, row, head,
// batch; the last axis contiguous), so the transposed (B, S, heads, D) views
// the model passes load as they are. With the 128-byte swizzle a box is 64
// bf16 wide, so a row of D = 128 or 256 loads as D/64 boxes. TMA zero-fills
// rows past S or T; keys >= T are still masked by index, since a zero key
// scores 0, not -1e30.
//   Per K/V tile each consumer warpgroup issues S = Q.K^T as D/16
// m64nBNk16 wgmmas with both operands K-major in swizzled shared memory,
// scales the fp32 fragment, masks by index only on the diagonal tile and
// the ragged last tile, and updates m and l in registers (a row lives in
// the 4 threads of a quad: the max is two xor-shuffles; l stays per thread
// and is summed once at the end). P is rounded to bf16 in registers, where
// the accumulator fragment is already wgmma's A-operand layout, and
// O += P.V runs as BN/16 m64nDk16 wgmmas with V's tile (keys x D, D
// contiguous) as the MN-major B operand. Causal tiles wholly above a
// warpgroup's diagonal are skipped, and the q tiles are handed out
// longest-first: the grid's slowest axis walks them from the last, so
// every head's longest sweeps start first. The epilogue divides by
// max(l, 1e-30), rounds to bf16 and stores in q's strides; rows >= S are
// never written. BN = 128 keys for D = 64 and 128, 64 for D = 256
// (registers: the O fragment is D/2 floats a thread).
//
// Bound on this card: operations. Causal prefill does about
// 2 * B * H * S^2 * D flops (Q.K^T and P.V over the lower triangle) on
// B * (H + 2G) * S * D * 2 bytes: at 4 x 12 x 2048 x 128 that is 51.5 GFLOP,
// 0.052 ms at the 989 TFLOP/s bf16 tensor-core peak. float32 calls stay on
// the CUDA-core kernel in flash_attention.cu: tensor cores would need TF32,
// which keeps about three digits, and break the 2e-5 agreement of the
// float32 path; no main path runs attention in float32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int BQ = 128;              // query rows a CTA (two warpgroups)
constexpr int STAGES = 2;            // K/V ring depth
constexpr int THREADS = 3 * 128;     // two consumer warpgroups + producer
constexpr int BOX = 64;              // bf16 a TMA box row: 128 bytes
constexpr int kEncodeError = 10000;  // + the CUresult of a failed encode

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One 4-D TMA box (64 x rows x 1 x 1) into shared memory, reported to `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all >> 4); the tiles sit on 1024-byte boundaries,
// so the base offset is 0.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF)
       | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
       | (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in
// shared memory (128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, A and B K-major in
// shared memory (128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (bf16 pairs),
// B MN-major in shared memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers (bf16 pairs),
// B MN-major in shared memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] . B[16 x 256], A in registers (bf16 pairs),
// B MN-major in shared memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "S tile of 64 or 128 keys");
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "D of 64, 128 or 256");
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

struct FlashArgs {
  void* o;
  long long o_sb, o_sh, o_ss;      // element strides of o (batch, head, row)
  int H, G, S, T, causal;
  float scale;
};

template <int D>
__host__ __device__ constexpr int block_keys() { return D == 256 ? 64 : 128; }

// Q tile, the K/V ring, 1 + 2 * STAGES mbarriers, and room to align the
// tiles to 1024 bytes.
template <int D>
constexpr int smem_bytes() {
  return BQ * D * 2 + STAGES * 2 * block_keys<D>() * D * 2
       + 8 * (1 + 2 * STAGES) + 1024;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            FlashArgs a) {
  constexpr int BN = block_keys<D>();
  constexpr int CH = D / BOX;                  // 64-wide boxes in a row
  constexpr int Q_BYTES = BQ * D * 2;
  constexpr int KV_BYTES = BN * D * 2;         // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + Q_BYTES;         // stage st: K, then V
  const uint32_t q_full = kv_s + STAGES * 2 * KV_BYTES;
  auto full = [&](int st) { return q_full + 8 * (1 + st); };
  auto empty = [&](int st) { return q_full + 8 * (1 + STAGES + st); };

  const int n_qt = (a.S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.z) * BQ;   // longest first
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (a.H / a.G);
  int n_kt = (a.T + BN - 1) / BN;
  if (a.causal) n_kt = min(n_kt, (min(q0 + BQ, a.S) - 1) / BN + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {                // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(q_full, Q_BYTES);
      for (int c = 0; c < CH; ++c)
        tma_load(q_s + c * BQ * 128, &q_map, q_full, c * BOX, q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % STAGES;
        mbar_wait(empty(st), ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * KV_BYTES);
        const uint32_t k_tile = kv_s + st * 2 * KV_BYTES;
        for (int c = 0; c < CH; ++c) {
          tma_load(k_tile + c * BN * 128, &k_map, full(st), c * BOX,
                   kt * BN, g, b);
          tma_load(k_tile + KV_BYTES + c * BN * 128, &v_map, full(st),
                   c * BOX, kt * BN, g, b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // consumer warpgroup w holds query rows q0 + 64 w .. + 63; this thread
  // rows row_a and row_a + 8, and in each 8-key block j of a fragment the
  // keys 8 j + 2 (lane % 4) + {0, 1}
  const int w = threadIdx.x / 128, t = threadIdx.x % 128;
  const int lane = t % 32;
  const int wg_first = q0 + 64 * w;
  const int row_a = wg_first + 16 * (t / 32) + lane / 4;
  const int col_a = 2 * (lane % 4);
  const float scale = a.scale * kLog2e;        // softmax in base 2
  const uint32_t q_wg = q_s + 64 * w * 128;

  float o[D / 2], s[BN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % STAGES;
    const int k0 = kt * BN;
    const uint32_t k_tile = kv_s + st * 2 * KV_BYTES;
    const uint32_t v_tile = k_tile + KV_BYTES;
    mbar_wait(full(st), (kt / STAGES) & 1);
    if (a.causal && k0 > wg_first + 63) {      // above this diagonal
      mbar_arrive(empty(st));
      continue;
    }

    // S = Q . K^T: K-major operands, 16 d a step (32 bytes into a box)
    fence_operands<BN / 2>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<BN>(s, gmma_desc(q_wg + (kk / 4) * BQ * 128 + off, 16, 1024),
                   gmma_desc(k_tile + (kk / 4) * BN * 128 + off, 16, 1024),
                   kk > 0);
    }
    wgmma_commit_wait();
    fence_operands<BN / 2>(s);

    const bool edge = (a.causal && k0 + BN - 1 > wg_first) || k0 + BN > a.T;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_a + 8 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * j + 2 * i + c] * scale;
          if (edge) {
            const int key = k0 + 8 * j + col_a + c;
            if (key >= a.T || (a.causal && key > row)) x = kNegInf;
          }
          s[4 * j + 2 * i + c] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(s[4 * j + 2 * i + c] - m_new);
          s[4 * j + 2 * i + c] = p;
          sum += p;
        }
      l_run[i] = l_run[i] * alpha + sum;       // this thread's share
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * i] *= alpha;
        o[4 * j + 2 * i + 1] *= alpha;
      }
    }

    // P in bf16: the S fragment of keys 16 kk .. + 15 is wgmma's A fragment
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    // O += P . V: V MN-major, 16 keys (2048 bytes) a step; the D/64 boxes
    // lie BN * 128 bytes apart (leading offset), 8-key groups 1024 (stride)
    fence_operands<D / 2>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], gmma_desc(v_tile + kk * 2048, BN * 128, 1024));
    wgmma_commit_wait();
    fence_operands<D / 2>(o);
    mbar_arrive(empty(st));
  }

  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb
                    + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int row = row_a + 8 * i;
    if (row >= a.S) continue;
    __nv_bfloat16* orow = op + (long long)row * a.o_ss + col_a;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] / l,
                                o[4 * j + 2 * i + 1] / l);
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

// A 4-D map of a (batch, heads, rows, D) bf16 tensor, innermost first;
// `st` holds its element strides (batch, head, row). Boxes are 64 x
// box_rows, swizzled by 128 bytes; rows past the end load as zeros.
CUresult encode(CUtensorMap* map, const void* ptr, int d, int rows,
                int heads, int batch, const long long* st, int box_rows) {
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads,
                        (cuuint64_t)batch};
  cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                           (cuuint64_t)st[0] * 2};
  cuuint32_t box[4] = {BOX, (cuuint32_t)box_rows, 1, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const long long* st,
           const FlashArgs& a, int B, cudaStream_t stream) {
  static unsigned done = 0;
  CUtensorMap qm, km, vm;
  CUresult res = encode(&qm, q, D, a.S, a.H, B, st, BQ);
  if (res == CUDA_SUCCESS)
    res = encode(&km, k, D, a.T, a.G, B, st + 3, block_keys<D>());
  if (res == CUDA_SUCCESS)
    res = encode(&vm, v, D, a.T, a.G, B, st + 6, block_keys<D>());
  if (res != CUDA_SUCCESS) return kEncodeError + (int)res;
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = allow_smem(flash_attention_sm90_kernel<D>, smem, &done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.H, B, (a.S + BQ - 1) / BQ);
  flash_attention_sm90_kernel<D><<<grid, THREADS, smem, stream>>>(qm, km, vm,
                                                                  a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,H,S,D), k and v (B,G,T,D), o (B,H,S,D): bfloat16 device pointers,
// the last axis contiguous, every pointer and stride a multiple of 16 bytes;
// strides: 12 element strides (batch, head, row) of q, k, v, o in that
// order, on the host. D in {64, 128, 256}. Returns cudaGetLastError() after
// the launch, cudaErrorInvalidValue for another D, or 10000 + the CUresult
// when a tensor map cannot be encoded.
int flash_attention_sm90(const void* q, const void* k, const void* v,
                         void* o, const long long* strides, int B, int H,
                         int G, int S, int T, int D, int causal, float scale,
                         void* stream) {
  FlashArgs a{o, strides[9], strides[10], strides[11], H, G, S, T, causal,
              scale};
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch<64>(q, k, v, strides, a, B, st);
    case 128: return launch<128>(q, k, v, strides, a, B, st);
    case 256: return launch<256>(q, k, v, strides, a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
