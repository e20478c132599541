// BELL (block-ELL of plane slots) sparse matrix-vector product for Hopper
// (sm_90a), over the real slots of each row block only.
//
// Replaces raptor_tpu/device/pallas_kernels.py:bell_spmv_pallas.
//
//   out[s, a*128 + l] = sum_{w < cnt[s, a]} vals[s, w, a, l] * x[s, src[s, w, a]*128 + idx[s, w, a, l]]
//
// over S stacked shards and the row blocks a < ceil(rows / 128), with x
// zero outside [0, C). Slot (w, a) holds one source 128-block of x for the
// 128 rows of target block a; idx (int8, 0-127) is each row's lane in that
// block. The packer gives a block's slots the ranks 0, 1, ... in turn, so
// the slots at or past cnt[s, a] (device/formats.py:bell_counts) are
// padding that adds only 0 * x, and are never read. The layout pads every
// block to the fullest block's W slots: on the embedded 128^3 level-0 P^T
// (W = 447) only 1,334 of 16,384 row blocks hold a slot, and 6% of the
// padded slots are real; on level-0 P (W = 23) 72% are.
//
// Bound: memory. The real slots are streamed once, N * 128 * (itemsize +
// 1) bytes plus N int32 source block ids for N real slots, with the counts
// (4 B per row block), x read and the output written once. On an H100
// 80GB HBM3 at 700 W (PERF.md): that P^T 0.148 ms against a 0.089 ms bound
// (the padded layout's bound: 1.41 ms), P 0.073 ms against 0.057 ms, in
// float.
//
// Design: one CTA of kWarps warps per (row block, shard), grid (nblk, S),
// as the BDIA kernel (csrc/bdia_spmv.cu) with a per-slot source block in
// place of a plane offset. An empty block writes zeros and returns. The
// CTA stages its block's source block ids in shared memory (kChunk at a
// time), so the loop over slots waits on two dependent loads (the slot,
// then x) and not three. Warp w then takes the slots w, w + kWarps, ...,
// kUnroll at a time: it loads the values and lane ids of kUnroll slots,
// then all their x, then does the multiply-adds, so every load of a step is
// in flight at once. A thread covers 4 rows of a slot: their values arrive
// as one 16-byte load (float4; two double2 in double), their lane ids as
// one 4-byte load, so a warp reads a whole slot in one coalesced pass. The
// x loads are straight-line code, none behind a branch; an index outside
// [0, C) reads x[0] and is masked after the load (the TPU kernel's padded
// copy of x in VMEM, and its 4 MB cap, become this bounds check). The
// wrapper picks kWarps (4, 8 or 16) from the fullest block's slots
// (device/kernels.py:bell_warps), so a layout with a few dozen slots in a
// block does not idle 16 warps at the reduction. The warps' partial sums
// meet in shared memory and are added in warp order, one thread per row,
// so the result does not vary from run to run.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kLane = 128;    // rows of a row block, lanes of a slot
constexpr int kUnroll = 2;    // slots a warp has in flight at once
constexpr int kChunk = 1024;  // source block ids staged at a time

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 q0 = __ldg(reinterpret_cast<const double2*>(p));
  const double2 q1 = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}

template <typename T, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
bell_spmv_kernel(const int* __restrict__ src, const int8_t* __restrict__ idx,
                 const T* __restrict__ vals, const int* __restrict__ cnt,
                 const T* __restrict__ x, T* __restrict__ out, int W,
                 long long A128, long long rows, long long C) {
  static_assert(kWarps * 32 >= kLane, "one thread per row in the reduction");
  __shared__ int s_src[kChunk];
  __shared__ T s_part[kWarps][kLane];
  const long long a = blockIdx.x;
  const long long s = blockIdx.y;
  const long long r = a * kLane + threadIdx.x;    // the row this thread sums
  const int n = min(__ldg(cnt + s * A128 + a), W);
  if (n <= 0) {                                   // the same for the block
    if (threadIdx.x < kLane && r < rows) out[s * rows + r] = T(0);
    return;
  }
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const T* xs = x + s * C;
  const long long plane = A128 * kLane;
  const long long e0 = s * W * plane + a * kLane + 4 * t;
  const int* srcb = src + s * W * A128 + a;       // src[s, w, a] = srcb[w * A128]
  T acc[4] = {T(0), T(0), T(0), T(0)};
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int m = min(kChunk, n - c0);
    if (c0 > 0) __syncthreads();                  // the last chunk is read
    for (int i = threadIdx.x; i < m; i += kWarps * 32)
      s_src[i] = __ldg(srcb + (long long)(c0 + i) * A128);
    __syncthreads();
    for (int k = warp; k < m; k += kWarps * kUnroll) {
      T v[kUnroll][4];
      uint32_t id[kUnroll];
      long long base[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // past the end of the chunk: reload slot k (real) and zero it
        const int kk = k + u * kWarps;
        const int kc = kk < m ? kk : k;
        const long long e = e0 + (long long)(c0 + kc) * plane;
        load4(vals + e, v[u]);
        id[u] = __ldg(reinterpret_cast<const uint32_t*>(idx + e));
        base[u] = (long long)s_src[kc] * kLane;
        if (kk >= m) v[u][0] = v[u][1] = v[u][2] = v[u][3] = T(0);
      }
      T xv[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const long long j = base[u] + ((id[u] >> (8 * l)) & 0x7f);
          xv[u][l] = __ldg(xs + (j >= 0 && j < C ? j : 0));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const long long j = base[u] + ((id[u] >> (8 * l)) & 0x7f);
          acc[l] += v[u][l] * (j >= 0 && j < C ? xv[u][l] : T(0));
        }
      }
    }
  }
#pragma unroll
  for (int l = 0; l < 4; ++l) s_part[warp][4 * t + l] = acc[l];
  __syncthreads();
  if (threadIdx.x < kLane && r < rows) {
    T sum = s_part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += s_part[w][threadIdx.x];
    out[s * rows + r] = sum;
  }
}

template <typename T, int kWarps>
void launch_warps(const void* src, const void* idx, const void* vals,
                  const void* cnt, const void* x, void* out, int S, int W,
                  long long A128, long long rows, long long C,
                  void* stream) {
  const dim3 grid((unsigned)((rows + kLane - 1) / kLane), (unsigned)S);
  bell_spmv_kernel<T, kWarps><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int*)src, (const int8_t*)idx, (const T*)vals, (const int*)cnt,
      (const T*)x, (T*)out, W, A128, rows, C);
}

template <typename T>
int launch(const void* src, const void* idx, const void* vals,
           const void* cnt, const void* x, void* out, int S, int W,
           long long A128, long long rows, long long C, int warps,
           void* stream) {
  if (S <= 0 || rows <= 0) return 0;
  switch (warps) {
    case 4:
      launch_warps<T, 4>(src, idx, vals, cnt, x, out, S, W, A128, rows, C,
                         stream);
      break;
    case 8:
      launch_warps<T, 8>(src, idx, vals, cnt, x, out, S, W, A128, rows, C,
                         stream);
      break;
    case 16:
      launch_warps<T, 16>(src, idx, vals, cnt, x, out, S, W, A128, rows, C,
                          stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bell_spmv_f32(const void* src, const void* idx,
                             const void* vals, const void* cnt, const void* x,
                             void* out, int S, int W, long long A128,
                             long long rows, long long C, int warps,
                             void* stream) {
  return launch<float>(src, idx, vals, cnt, x, out, S, W, A128, rows, C,
                       warps, stream);
}

extern "C" int bell_spmv_f64(const void* src, const void* idx,
                             const void* vals, const void* cnt, const void* x,
                             void* out, int S, int W, long long A128,
                             long long rows, long long C, int warps,
                             void* stream) {
  return launch<double>(src, idx, vals, cnt, x, out, S, W, A128, rows, C,
                        warps, stream);
}
