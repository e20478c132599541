// BDIA (block-diagonal planes with lane ids) sparse matrix-vector product
// for Hopper (sm_90a), over the non-empty tiles only.
//
// Replaces raptor_tpu/device/pallas_kernels.py:bdia_spmv_pallas.
//
//   out[s, a*128 + l] = sum_p vals[s, p, a, l] * x[s, (a + d_p)*128 + idx[s, p, a, l]]
//
// over S stacked shards, the row blocks a < ceil(rows / 128) and P planes,
// with x zero outside [0, C). Plane p holds, for every row, at most one
// entry whose column lies d_p 128-blocks from the row's block; idx (int8)
// is its lane inside that block. A tile is the 128 slots of one plane in
// one row block. tplane[s, tptr[s, a] : tptr[s, a + 1]] lists the planes
// whose tile in row block a holds a nonzero (device/formats.py:bdia_tiles);
// a tile left out adds only 0 * x, so it is never read. The coarse Galerkin
// operators fill 40-80% of their tiles, the embedded transfer operators
// 7-35%.
//
// Bound: memory. The listed tiles are streamed once, tiles * 128 *
// (itemsize + 1) bytes, plus the list (4 B per row block and per tile), x
// read and the output written once (about 2 * rows * itemsize).
//
// Design: one CTA of kWarps warps per (row block, shard), grid (nblk, S).
// The CTA first stages its row block's plane ids and block offsets in
// shared memory, so the loop over tiles waits on two dependent loads (the
// tile, then x) and not four. Warp w then takes the tiles w, w + kWarps,
// ..., kUnroll at a time: it loads the values and lane ids of kUnroll
// tiles, then all their x, then does the multiply-adds, so every load of a
// step is in flight at once. A thread covers 4 lanes of a tile: their
// values arrive as one 16-byte load (float4; two double2 in double), their
// lane ids as one 4-byte load, so a warp reads a whole tile in one
// coalesced pass. The x loads are straight-line code, none behind a
// branch, so none waits for another; a lane whose value is 0 (lane id 0,
// as packed) reads the block its tile reads anyway. x is read through
// the read-only path: the 128-blocks a + d_p that neighbouring row blocks
// share stay in L1/L2. The bounds check on j takes the place of the TPU
// kernel's zero-padded x window in VMEM, and the TPU's block size (A_pad)
// only sets the plane stride. The tiles are spread unevenly: the embedded
// restrictions and the coarse A's of the embedded spaces put hundreds of
// tiles in a few row blocks and none in the rest (128^3 level-1 P^T: 683
// tiles in the fullest of 157 non-empty blocks out of 1,334), while the
// 2-D transfer operators hold 6-36 tiles in every block. 16 warps share a
// block's list: enough that the few full blocks keep the card busy, and on
// the light blocks the idle warps only wait at the reduction. An empty
// block writes zeros and returns. The warps' partial sums meet in shared
// memory and are added in warp order, one thread per row, so the result
// does not vary from run to run.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kLane = 128;       // rows of a row block, slots of a tile
constexpr int kWarps = 16;       // warps of a CTA, sharing one block's tiles
constexpr int kUnroll = 2;       // tiles a warp has in flight at once
constexpr int kMaxTiles = 1024;  // planes a row block can list (P <= this)
static_assert(kWarps * 32 >= kLane, "one thread per row in the reduction");

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 q0 = __ldg(reinterpret_cast<const double2*>(p));
  const double2 q1 = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
bdia_spmv_kernel(const int8_t* __restrict__ idx, const T* __restrict__ vals,
                 const T* __restrict__ x, const int* __restrict__ d_offsets,
                 const int* __restrict__ tptr,
                 const int* __restrict__ tplane, T* __restrict__ out, int P,
                 long long A_pad, long long rows, long long C,
                 long long Tmax) {
  __shared__ int s_plane[kMaxTiles];
  __shared__ int s_d[kMaxTiles];
  __shared__ T s_part[kWarps][kLane];
  const long long a = blockIdx.x;
  const long long s = blockIdx.y;
  const long long r = a * kLane + threadIdx.x;    // the row this thread sums
  const int* ptr = tptr + s * (gridDim.x + 1) + a;
  const int k0 = __ldg(ptr);
  const int n = __ldg(ptr + 1) - k0;
  if (n == 0) {                                   // the same for the block
    if (threadIdx.x < kLane && r < rows) out[s * rows + r] = T(0);
    return;
  }
  for (int i = threadIdx.x; i < n; i += kWarps * 32) {
    const int p = __ldg(tplane + s * Tmax + k0 + i);
    s_plane[i] = p;
    s_d[i] = __ldg(d_offsets + p);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const T* xs = x + s * C;
  const long long plane = A_pad * kLane;
  const long long e0 = s * P * plane + a * kLane + 4 * t;
  T acc[4] = {T(0), T(0), T(0), T(0)};
  for (int k = warp; k < n; k += kWarps * kUnroll) {
    T v[kUnroll][4];
    uint32_t id[kUnroll];
    long long base[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // past the end of the list: reload tile k (valid) and zero it
      const int kk = k + u * kWarps;
      const int kc = kk < n ? kk : k;
      const long long e = e0 + s_plane[kc] * plane;
      load4(vals + e, v[u]);
      id[u] = __ldg(reinterpret_cast<const uint32_t*>(idx + e));
      base[u] = (a + s_d[kc]) * kLane;
      if (kk >= n) v[u][0] = v[u][1] = v[u][2] = v[u][3] = T(0);
    }
    // every x load of the step is issued before the first is used: an
    // index outside [0, C) reads x[0] and is masked after the load
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

template <typename T>
int launch(const void* idx, const void* vals, const void* x,
           const void* d_offsets, const void* tptr, const void* tplane,
           void* out, int S, int P, long long A_pad, long long rows,
           long long C, long long Tmax, void* stream) {
  if (S <= 0 || rows <= 0) return 0;
  if (P > kMaxTiles) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((rows + kLane - 1) / kLane), (unsigned)S);
  bdia_spmv_kernel<T><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)idx, (const T*)vals, (const T*)x,
      (const int*)d_offsets, (const int*)tptr, (const int*)tplane, (T*)out,
      P, A_pad, rows, C, Tmax);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bdia_spmv_f32(const void* idx, const void* vals,
                             const void* x, const void* d_offsets,
                             const void* tptr, const void* tplane, void* out,
                             int S, int P, long long A_pad, long long rows,
                             long long C, long long Tmax, void* stream) {
  return launch<float>(idx, vals, x, d_offsets, tptr, tplane, out, S, P,
                       A_pad, rows, C, Tmax, stream);
}

extern "C" int bdia_spmv_f64(const void* idx, const void* vals,
                             const void* x, const void* d_offsets,
                             const void* tptr, const void* tplane, void* out,
                             int S, int P, long long A_pad, long long rows,
                             long long C, long long Tmax, void* stream) {
  return launch<double>(idx, vals, x, d_offsets, tptr, tplane, out, S, P,
                        A_pad, rows, C, Tmax, stream);
}
