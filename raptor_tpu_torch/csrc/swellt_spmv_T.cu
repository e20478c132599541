// Sorted-scatter transposed sparse matrix-vector product ("wellt", the
// restriction format) for Hopper (sm_90a), summed in shared memory before
// its global atomics.
//
// Replaces raptor_tpu/device/pallas_kernels.py:swellt_spmv_T_pallas.
//
//   y = B^T x:  out[s, (qb[s, t*Kp + k] + qrel)*128 + lout] += vals[s, t, e] * x[s, t*128 + srcl]
//
// for every packed entry e < cnt[s, t*Kp + k] of slot k = e / 128 of source
// tile t, with meta[s, t, e] = srcl | qrel << 7 | lout << 12, over S
// stacked shards. The packer fills a slot from lane 0, so the entries at or
// past its count (device/formats.py:swellt_counts) are padding and are
// never read; an unused slot counts 0. Targets at or past n_out are dropped
// (the JAX version slices them off).
//
// Bound: memory. The real entries are streamed once, E * (itemsize + 4)
// bytes for E entries, plus qb and the counts (8 B a slot), x read and the
// output written once; one multiply-add per nonzero. The 128^3 level-0 P^T
// holds 8,450,947 entries in 16,384 tiles of 7 slots (58% filled), which
// land on 170,752 targets: about 49 on each. On an H100 80GB HBM3 at 700 W
// (PERF.md) this kernel takes 0.094 ms there against a 0.023 ms bound, in
// float.
//
// Design: one CTA of kWarps warps per `group` consecutive source tiles of
// one shard, grid (ceil(T / group), S). The CTA stages its tiles' x (the
// 128 values of tile t are x[t*128 : t*128 + 128], so no x is gathered from
// global memory) and their slots' window bases and counts in shared
// memory, and finds the least window base of the slots that hold an
// entry. Its accumulator, kSpan 128-blocks of shared memory from that
// base, takes every contribution whose target falls inside it; a target
// outside it takes a global atomic add at once. Then the CTA flushes each
// nonzero accumulator entry with one global atomic add. The tiles of a
// group reach the same coarse targets, so the global atomics fall from one
// per nonzero to about one per distinct target of a group (a host model of
// that count, not a device reading: device/kernels.py:
// swellt_modelled_global_atomics).
//
// Each warp takes one slot of the group at a time, kSlots slots in flight
// (4 entries a lane each), all their loads issued before the first add;
// it loads nothing of an unused slot and no entry past a count. A lane
// does no division per entry: a slot's entries are contiguous and share
// their tile and window base. The wrapper zero-fills the output. The TPU
// kernel's one-hot MXU scatter, its VMEM-resident output and its SMEM
// table of window bases become the shared-memory accumulator and its
// flush. The float sum order still changes from run to run (atomics).
//
// What bounds it now: a float atomic add to shared memory is a
// compare-and-swap loop on this card (ATOMS.CAST.SPIN in the SASS), and
// lanes of one instruction that hit one target retry in turn.
//
// The launch shape is fixed here: kGroup = 32 source tiles a CTA (fewer
// when their slot tables would pass kMaxSlots slots) and kSpan = 64
// blocks (two SWELLT_AMAX windows: 8,192 targets, 32 KB in float, 64 KB in
// double). A sweep on the card chose it (chip_sweep.py, which builds
// variants of this file with -DSWELLT_GROUP and -DSWELLT_SPAN; PERF.md).
// The kernel library is built with neither flag.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#ifndef SWELLT_GROUP
#define SWELLT_GROUP 32
#endif
#ifndef SWELLT_SPAN
#define SWELLT_SPAN 64
#endif

namespace {

constexpr int kLane = 128;         // sources of a tile, entries of a slot
constexpr int kWarps = 8;          // warps of a CTA
constexpr int kThreads = kWarps * 32;
constexpr int kSlots = 4;          // slots a warp has in flight at once
constexpr int kPer = kLane / 32;   // entries of a slot per lane
constexpr int kGroup = SWELLT_GROUP;  // source tiles of a CTA, at most
constexpr int kSpan = SWELLT_SPAN;    // 128-blocks of the accumulator
constexpr int kAcc = kSpan * kLane;
constexpr int kMaxSlots = 4096;    // slots a CTA stages, unless Kp is more
constexpr int kMaxDevices = 64;
static_assert(kGroup > 0 && kSpan > 0, "a CTA takes a tile and a window");

// source tiles of a CTA for Kp slots a tile
constexpr int group_of(int Kp) {
  return Kp >= kMaxSlots ? 1
                         : (kMaxSlots / Kp < kGroup ? kMaxSlots / Kp : kGroup);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
swellt_spmv_T_kernel(const int* __restrict__ meta, const T* __restrict__ vals,
                     const int* __restrict__ qb, const int* __restrict__ cnt,
                     const T* __restrict__ x, T* __restrict__ out,
                     long long n_tiles, int Kp, long long n_out, long long C,
                     int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* acc = reinterpret_cast<T*>(smem);                  // [kSpan * 128]
  T* xs = acc + kAcc;                                   // [group * 128]
  int* s_qb = reinterpret_cast<int*>(xs + group * kLane);  // [group * Kp]
  int* s_cnt = s_qb + group * Kp;                       // [group * Kp]
  __shared__ int s_base;
  const long long s = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * group;
  const int g_n = (int)(n_tiles - t0 < group ? n_tiles - t0 : group);
  const int n_slots = g_n * Kp;
  if (threadIdx.x == 0) s_base = INT_MAX;
  for (int i = threadIdx.x; i < kAcc; i += kThreads) acc[i] = T(0);
  for (int i = threadIdx.x; i < g_n * kLane; i += kThreads) {
    const long long j = t0 * kLane + i;
    xs[i] = j < C ? __ldg(x + s * C + j) : T(0);
  }
  __syncthreads();
  const long long slot0 = (s * n_tiles + t0) * Kp;
  for (int i = threadIdx.x; i < n_slots; i += kThreads) {
    const int c = __ldg(cnt + slot0 + i);
    const int q = __ldg(qb + slot0 + i);
    s_cnt[i] = c;
    s_qb[i] = q;
    if (c > 0) atomicMin(&s_base, q);
  }
  __syncthreads();
  const int base = s_base;
  if (base == INT_MAX) return;        // no entry in the group: all return
  const long long lo = (long long)base * kLane;
  // the group's slots are consecutive in memory: slot j (tile j / Kp, slot
  // j % Kp of it) starts at entry e0 + j * 128
  const long long e0 = (s * n_tiles + t0) * Kp * kLane;
  T* outs = out + s * n_out;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int j0 = warp; j0 < n_slots; j0 += kWarps * kSlots) {
    T v[kSlots][kPer];
    int m[kSlots][kPer];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int j = j0 + u * kWarps;
      const int n = j < n_slots ? s_cnt[j] : 0;      // the same for the warp
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = lane + 32 * i;
        v[u][i] = T(0);
        m[u][i] = 0;
        if (e < n) {
          v[u][i] = __ldg(vals + e0 + (long long)j * kLane + e);
          m[u][i] = __ldg(meta + e0 + (long long)j * kLane + e);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int j = j0 + u * kWarps;
      if (j >= n_slots) continue;
      const long long wb = (long long)s_qb[j] * kLane;  // the slot's window
      const T* xg = xs + (j / Kp) * kLane;             // its tile's x
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (v[u][i] == T(0)) continue;
        const int mm = m[u][i];
        const long long tgt =
            wb + ((mm >> 7) & 31) * kLane + ((mm >> 12) & 127);
        if (tgt >= n_out) continue;
        const T c = v[u][i] * xg[mm & 127];
        const long long l = tgt - lo;
        if (l >= 0 && l < kAcc)
          atomicAdd(acc + l, c);
        else
          atomicAdd(outs + tgt, c);
      }
    }
  }
  __syncthreads();
  // only targets below n_out were added, so lo + i < n_out where acc != 0
  for (int i = threadIdx.x; i < kAcc; i += kThreads) {
    const T a = acc[i];
    if (a != T(0)) atomicAdd(outs + lo + i, a);
  }
}

template <typename T>
size_t smem_bytes(int group, int Kp) {
  return (size_t)(kSpan + group) * kLane * sizeof(T) +
         2 * sizeof(int) * (size_t)group * Kp;
}

// Dynamic shared memory past the default 48 KB needs the kernel's limit
// raised. It is raised once per device to the most a launch has needed so
// far, not at every launch.
template <typename T>
cudaError_t allow_smem(size_t smem) {
  static std::atomic<size_t> granted[kMaxDevices];
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  size_t had = granted[dev].load();
  if (smem <= had) return cudaSuccess;
  err = cudaFuncSetAttribute(swellt_spmv_T_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  while (had < smem && !granted[dev].compare_exchange_weak(had, smem)) {
  }
  return cudaSuccess;
}

template <typename T>
int launch(const void* meta, const void* vals, const void* qb,
           const void* cnt, const void* x, void* out, int S,
           long long n_tiles, int Kp, long long n_out, long long C,
           void* stream) {
  if (S <= 0 || n_tiles <= 0 || Kp <= 0 || n_out <= 0) return 0;
  const int group = group_of(Kp);
  const size_t smem = smem_bytes<T>(group, Kp);
  const cudaError_t err = allow_smem<T>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n_tiles + group - 1) / group), (unsigned)S);
  swellt_spmv_T_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)meta, (const T*)vals, (const int*)qb, (const int*)cnt,
      (const T*)x, (T*)out, n_tiles, Kp, n_out, C, group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int swellt_spmv_T_f32(const void* meta, const void* vals,
                                 const void* qb, const void* cnt,
                                 const void* x, void* out, int S,
                                 long long n_tiles, int Kp, long long n_out,
                                 long long C, void* stream) {
  return launch<float>(meta, vals, qb, cnt, x, out, S, n_tiles, Kp, n_out, C,
                       stream);
}

extern "C" int swellt_spmv_T_f64(const void* meta, const void* vals,
                                 const void* qb, const void* cnt,
                                 const void* x, void* out, int S,
                                 long long n_tiles, int Kp, long long n_out,
                                 long long C, void* stream) {
  return launch<double>(meta, vals, qb, cnt, x, out, S, n_tiles, Kp, n_out,
                        C, stream);
}

// The launch shape for Kp slots a tile: the source tiles a CTA sums and the
// 128-blocks of its accumulator. The host model of the kernel's global
// atomics reads it; it launches nothing.
extern "C" void swellt_spmv_T_shape(int Kp, int* group, int* span) {
  *group = group_of(Kp > 0 ? Kp : 1);
  *span = kSpan;
}
