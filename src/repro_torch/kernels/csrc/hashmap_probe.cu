// Hash-map probe kernels for Hopper (sm_90a): resolve a batch of int64 ids
// against an IdHashMap key table on the device. Plain C interface, built
// by kernels/_build.py with nvcc and bound with ctypes in
// kernels/hashmap_probe.py, whose wrappers count launches
// (hashmap_probe.launches, hashmap_probe_hbm.launches).
//
// Contract (both kernels): pos[i] is the table slot of ids[i] where
// found[i] is 1, bit-equal to core/hashmap.py IdHashMap._probe; where
// found[i] is 0, pos[i] is the id's home slot. Query ids <= TOMB are
// never found.
//
// Hashing: the TPU kernels split ids into uint32 limbs and rebuild the
// top word of id * floor(2^64/phi) from 16-bit partial products, because
// the TPU has no int64 vector arithmetic. Here the multiply is one native
// 64-bit multiply: home = (id * 0x9E3779B97F4A7C15) >> shift.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kEmpty = (long long)0x8000000000000000ULL;  // -2^63
constexpr long long kTomb = kEmpty + 1;                         // -2^63 + 1
constexpr unsigned long long kFib = 0x9E3779B97F4A7C15ULL;
constexpr int kWindow = 8;     // core/hashmap.py _WINDOW
constexpr int kMaxChunks = 8;  // 256-slot window / 32 lanes

__device__ __forceinline__ long long home_slot(long long id, int shift) {
  return (long long)(((unsigned long long)id * kFib) >> shift);
}

// Replaces src/repro/kernels/hashmap_probe.py: hashmap_probe
// (_probe_kernel), which streams the whole key table into VMEM.
//
// One thread per id. The table is read in place: a map of up to
// VMEM_SLOT_BOUND (2^21) slots is 16 MiB of keys and stays in the H100's
// 50 MB L2 across a batch, this card's counterpart of "the whole table in
// VMEM". What bounds it is random 32-byte sectors: one per id at the home
// slot (most ids resolve there at <= 25% load), two or three more per
// 8-slot tail window. The walk is the host's: home slot, then windows of
// 8 from home + 1; the first hit in a window wins, a window with an EMPTY
// and no hit ends the walk, TOMB is neither.
__global__ void probe_walk_kernel(const long long* __restrict__ keys,
                                  long long imask, int shift,
                                  long long max_rounds,
                                  const long long* __restrict__ ids,
                                  long long n, int* __restrict__ pos,
                                  unsigned char* __restrict__ found) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long id = ids[i];
  if (id <= kTomb) {
    pos[i] = 0;
    found[i] = 0;
    return;
  }
  long long home = home_slot(id, shift);
  pos[i] = (int)home;
  long long k = keys[home];
  if (k == id) {
    found[i] = 1;
    return;
  }
  found[i] = 0;
  if (k == kEmpty) return;
  long long cur = (home + 1) & imask;
  for (long long r = 0; r < max_rounds; ++r) {
    bool empty = false;
#pragma unroll
    for (int j = 0; j < kWindow; ++j) {
      long long s = (cur + j) & imask;
      long long kj = keys[s];
      if (kj == id) {
        pos[i] = (int)s;
        found[i] = 1;
        return;
      }
      empty |= (kj == kEmpty);
    }
    if (empty) return;
    cur = (cur + kWindow) & imask;
  }
}

__device__ __forceinline__ unsigned bit_range(int lo, int hi) {
  // bits [lo, hi) of a 32-bit mask, 0 <= lo < 32, lo < hi <= 32
  unsigned upto = hi >= 32 ? 0xffffffffu : ((1u << hi) - 1u);
  return upto & ~((1u << lo) - 1u);
}

// Replaces src/repro/kernels/hashmap_probe.py: hashmap_probe_hbm
// (_dma_probe_kernel, _dma_probe_pass), which DMAs 256-slot windows of a
// table left in HBM into double-buffered VMEM.
//
// One warp per id over the wrap-padded table (cap + w slots, w =
// min(256, cap)), so a window starting anywhere below cap never wraps.
// Each pass the warp reads the window as coalesced 8-byte loads (lane l
// reads offsets l, l + 32, ...), turns hits and EMPTYs into ballots, and
// resolves the lowest 8-slot group holding either: a hit in that group
// beats an EMPTY in it. Pass structure as in _dma_probe_kernel: the first
// pass checks the home slot (offset 0), then (w - 1) / 8 groups from
// offset 1; later passes check w / 8 groups from offset 0. What bounds it
// is bytes: 2 KiB of keys per id per pass, where the function itself
// needs one 32-byte sector per id at the home slot; the window makes long
// collision chains cost one pass, not one round trip per 8 slots.
__global__ void probe_window_kernel(const long long* __restrict__ keys,
                                    long long cap, int shift, int w,
                                    long long max_passes,
                                    const long long* __restrict__ ids,
                                    long long n, int* __restrict__ pos,
                                    unsigned char* __restrict__ found) {
  long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= n) return;  // uniform across the warp
  long long id = ids[warp];
  if (id <= kTomb) {
    if (lane == 0) {
      pos[warp] = 0;
      found[warp] = 0;
    }
    return;
  }
  long long imask = cap - 1;
  long long home = home_slot(id, shift);
  long long cur = home;
  int chunks = (w + 31) >> 5;
  for (long long r = 0; r < max_passes; ++r) {
    const long long* win = keys + cur;
    int start = r == 0 ? 1 : 0;
    int end = start + kWindow * (r == 0 ? (w - 1) / kWindow : w / kWindow);
    if (r == 0) {
      long long k0 = win[0];
      if (k0 == id || k0 == kEmpty) {
        if (lane == 0) {
          pos[warp] = (int)cur;
          found[warp] = k0 == id;
        }
        return;
      }
    }
    unsigned hitm[kMaxChunks], evm[kMaxChunks];
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      bool hit = false, ev = false;
      int o = c * 32 + lane;
      if (c < chunks && o < w) {
        long long k = win[o];
        bool valid = o >= start && o < end;
        hit = valid && k == id;
        ev = hit || (valid && k == kEmpty);
      }
      hitm[c] = __ballot_sync(0xffffffffu, hit);
      evm[c] = __ballot_sync(0xffffffffu, ev);
    }
    int first_ev = -1;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (first_ev < 0 && evm[c]) first_ev = c * 32 + __ffs(evm[c]) - 1;
    }
    if (first_ev >= 0) {
      // the resolving group is the one holding the first event; no hit
      // precedes that event in the group (a hit is an event), so the
      // first hit in [first_ev, group end) is the group's first hit
      int gend = start + kWindow * ((first_ev - start) / kWindow + 1);
      int hit_off = -1;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        int lo = first_ev - c * 32, hi = gend - c * 32;
        if (hit_off < 0 && hi > 0 && lo < 32) {
          unsigned m = hitm[c] & bit_range(lo < 0 ? 0 : lo, hi > 32 ? 32 : hi);
          if (m) hit_off = c * 32 + __ffs(m) - 1;
        }
      }
      if (lane == 0) {
        pos[warp] = hit_off >= 0 ? (int)((cur + hit_off) & imask) : (int)home;
        found[warp] = hit_off >= 0;
      }
      return;
    }
    cur = (cur + end) & imask;
  }
  if (lane == 0) {
    pos[warp] = (int)home;
    found[warp] = 0;
  }
}

}  // namespace

extern "C" {

// keys: >= cap int64 slots (only the first cap are read); cap a power of
// two, shift = 64 - log2(cap). Returns cudaGetLastError() after launch.
int hashmap_probe_walk(const void* keys, long long cap, int shift,
                       const void* ids, long long n, void* pos, void* found,
                       void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  probe_walk_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, cap - 1, shift, cap / kWindow + 2,
      (const long long*)ids, n, (int*)pos, (unsigned char*)found);
  return (int)cudaGetLastError();
}

// keys: cap + w int64 slots, wrap-padded (slot cap + t mirrors slot t).
int hashmap_probe_window(const void* keys, long long cap, int shift, int w,
                         const void* ids, long long n, void* pos, void* found,
                         void* stream) {
  const int threads = 256;  // 8 warps, one id each
  long long blocks = (n * 32 + threads - 1) / threads;
  probe_window_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, cap, shift, w, cap / kWindow + 2,
      (const long long*)ids, n, (int*)pos, (unsigned char*)found);
  return (int)cudaGetLastError();
}

}  // extern "C"
