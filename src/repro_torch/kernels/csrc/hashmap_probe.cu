// Hash-map probe kernels for Hopper (sm_90a): resolve a batch of int64 ids
// against an IdHashMap key table on the device. Plain C interface, built
// by kernels/_build.py with nvcc and bound with ctypes in
// kernels/hashmap_probe.py, whose wrappers count launches
// (hashmap_probe.launches, hashmap_probe_hbm.launches).
//
// Contract (both kernels): pos[i] is the table slot of ids[i] where
// found[i] is 1, bit-equal to core/hashmap.py IdHashMap._probe; where
// found[i] is 0, pos[i] is the id's home slot. Query ids <= TOMB are
// never found, and their pos is 0.
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

// Replaces src/repro/kernels/hashmap_probe.py: hashmap_probe_hbm
// (_dma_probe_kernel, _dma_probe_pass), which DMAs 256-slot windows of a
// table left in HBM into double-buffered VMEM. The 256-slot window was
// the TPU's DMA unit; this card reads 32-byte sectors, so the design
// reads only the sectors a chain needs and keeps the whole batch in
// flight at once.
//
// What bounds it is latency, not bytes: the master and replica tables
// (64 and 128 MB) lie beyond the 50 MB L2, so an id costs one dependent
// DRAM round trip at its home slot, and another for each tail step.
//
//   Home round, a thread per id. The grid is one wave (occupancy API),
//   warps walking 32 ids at a time past it. A thread loads its id
//   (coalesced), hashes it and reads keys[home] once; a hit or an EMPTY
//   resolves it there (at <= 25% load most ids), sentinel ids (<= TOMB)
//   resolve as not found. Its pos and found are stored coalesced.
//   Lane group. A lane that home left open reads the host's
//   first 8-slot group, home + 1 .. home + 8, alone (eight independent
//   loads, one round trip): every open lane of a warp at once, so a warp
//   with many short tails pays one round trip, not one per tail.
//   Warp walk. Lanes still open take a ballot. The warp walks the lowest
//   open lane's chain in 32-slot steps (four host groups, 256 bytes, one
//   coalesced load: lane l reads slot cur + l), and in the same step
//   resolves every open lane whose chain stands at the same cur (a
//   cluster of ids sharing a home costs chain / 32 round trips in all):
//   EMPTYs become a ballot, and each lane finds its own id among the 32
//   keys by shuffles. The lowest group holding a hit or an EMPTY
//   decides, and a hit in it beats an EMPTY in it, as the host's window
//   does. A lane takes at most the host walk's cap / 8 + 2 groups, so a
//   table with no EMPTY slot ends as not found.
//
// Offsets fold through & (cap - 1), so no read leaves the table and the
// wrap pad (cap + min(256, cap) slots, which the wrapper checks) is never
// read: it is shorter than a 32-slot read when cap < 32.
constexpr int kThreads = 256;
constexpr int kStep = 32;  // slots a warp step reads: four host groups
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
    probe_hbm_kernel(const long long* __restrict__ keys, long long cap,
                     int shift, const long long* __restrict__ ids,
                     long long n, int* __restrict__ pos,
                     unsigned char* __restrict__ found) {
  const long long imask = cap - 1;
  const int lane = threadIdx.x & 31;
  // host groups are home + 1 + 8g for g < cap / 8 + 2; the lane group
  // takes the first, and a warp step covers four of the rest
  constexpr int kGroups = kStep / kWindow;
  const long long groups = cap / kWindow + 1;
  const long long max_steps = (groups + kGroups - 1) / kGroups;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // base is the warp's first id: uniform across the warp, so every lane
  // runs every ballot and shuffle below
  for (long long base = (long long)blockIdx.x * blockDim.x + threadIdx.x -
                        lane;
       base < n; base += stride) {
    const long long i = base + lane;
    const bool live = i < n;
    const long long id = live ? ids[i] : kEmpty;
    const bool valid = id > kTomb;
    const long long home = valid ? home_slot(id, shift) : 0;
    int p = (int)home;
    bool f = false, open = false;
    if (valid) {
      const long long k = __ldg(keys + home);
      f = k == id;
      open = !f && k != kEmpty;
    }
    long long cur = (home + 1) & imask;
    if (open) {
      long long kg[kWindow];
#pragma unroll
      for (int j = 0; j < kWindow; ++j)
        kg[j] = __ldg(keys + ((cur + j) & imask));
      int hit = -1;
      bool empty = false;
#pragma unroll
      for (int j = kWindow - 1; j >= 0; --j) {
        if (kg[j] == id) hit = j;
        empty |= kg[j] == kEmpty;
      }
      if (hit >= 0) {
        p = (int)((cur + hit) & imask);
        f = true;
      }
      open = hit < 0 && !empty;
      cur = (cur + kWindow) & imask;
    }
    long long left = max_steps;
    for (unsigned pending = __ballot_sync(kFull, open); pending;
         pending = __ballot_sync(kFull, open)) {
      const long long c = __shfl_sync(kFull, cur, __ffs(pending) - 1);
      const long long k = __ldg(keys + ((c + lane) & imask));
      const unsigned empties = __ballot_sync(kFull, k == kEmpty);
      // each lane compares its own id with the 32 keys read: independent
      // shuffles, the same cost for one open lane as for 32
      unsigned hits = 0;
#pragma unroll
      for (int j = 0; j < kStep; ++j)
        hits |= (unsigned)(__shfl_sync(kFull, k, j) == id) << j;
      if (open && cur == c) {
        const unsigned events = hits | empties;
        if (events) {
          // the deciding group: the one holding the first event
          const unsigned group = 0xffu
                                 << ((__ffs(events) - 1) & ~(kWindow - 1));
          if (hits & group) {
            p = (int)((c + __ffs(hits & group) - 1) & imask);
            f = true;
          }
          open = false;
        } else if (--left == 0) {
          open = false;
        } else {
          cur = (c + kStep) & imask;
        }
      }
    }
    if (live) {
      pos[i] = p;
      found[i] = f;
    }
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

// keys: cap + min(256, cap) int64 slots, wrap-padded (slot cap + t mirrors
// slot t; the kernel folds offsets and reads only the first cap). One wave
// of blocks (SMs x resident blocks, asked of the occupancy API once), or
// fewer when the batch is smaller. No host sync, no allocation: a CUDA
// graph captures it.
int hashmap_probe_hbm(const void* keys, long long cap, int shift,
                      const void* ids, long long n, void* pos, void* found,
                      void* stream) {
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, probe_hbm_kernel,
                                                  kThreads, 0);
    return b > 0 ? b : 1;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long wave = (long long)(sms > 0 ? sms : 1) * per_sm;
  const long long want = (n + kThreads - 1) / kThreads;
  if (want > 0)
    probe_hbm_kernel<<<(unsigned)(want < wave ? want : wave), kThreads, 0,
                       (cudaStream_t)stream>>>((const long long*)keys, cap,
                                               shift, (const long long*)ids,
                                               n, (int*)pos,
                                               (unsigned char*)found);
  return (int)cudaGetLastError();
}

}  // extern "C"
