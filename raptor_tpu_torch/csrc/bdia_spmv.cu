// BDIA (block-diagonal planes with lane ids) sparse matrix-vector product
// for Hopper (sm_90a).
//
// Replaces raptor_tpu/device/pallas_kernels.py:bdia_spmv_pallas.
//
//   out[s, a*128 + l] = sum_p vals[s, p, a, l] * x[s, (a + d_p)*128 + idx[s, p, a, l]]
//
// over S stacked shards and P planes, with x zero outside [0, C). Plane p
// holds, for every row, at most one entry whose column lies d_p 128-blocks
// from the row's block; idx (int8) is its lane inside that block.
//
// Bound: memory. The planes are streamed once: P * A_pad * 128 *
// (itemsize + 1) bytes, plus x read and the output written once
// (about 2 * R * itemsize), at one multiply-add per plane slot.
//
// Design: one thread per output element (a, l). For every plane the
// threads of a warp read 32 neighbouring values and lane ids (coalesced),
// then load x from the same or a neighbouring 128-block of x, which the
// other rows of the block and the other planes reuse through L1/L2. The
// bounds check takes the place of the TPU kernel's zero-padded x window in
// VMEM, and the 4-block rounding of that window (a DMA tiling rule) has no
// counterpart here. The block offsets are a small device array read at
// the same index by every thread. Shards are the grid's y dimension.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename T>
__global__ void bdia_spmv_kernel(const int8_t* __restrict__ idx,
                                 const T* __restrict__ vals,
                                 const T* __restrict__ x,
                                 const int* __restrict__ d_offsets,
                                 T* __restrict__ out, int P,
                                 long long A_pad, long long rows,
                                 long long C) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const long long s = blockIdx.y;
  const long long a = r >> 7;
  const long long plane = A_pad * 128;
  const long long e0 = s * P * plane + r;
  const T* xs = x + s * C;
  T acc = T(0);
  for (int p = 0; p < P; ++p) {
    const long long e = e0 + (long long)p * plane;
    const long long j = (a + __ldg(d_offsets + p)) * 128 + __ldg(idx + e);
    const T xv = (j >= 0 && j < C) ? __ldg(xs + j) : T(0);
    acc += __ldg(vals + e) * xv;
  }
  out[s * rows + r] = acc;
}

template <typename T>
int launch(const void* idx, const void* vals, const void* x,
           const void* d_offsets, void* out, int S, int P, long long A_pad,
           long long rows, long long C, void* stream) {
  if (S <= 0 || rows <= 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned)((rows + threads - 1) / threads), (unsigned)S);
  bdia_spmv_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)idx, (const T*)vals, (const T*)x,
      (const int*)d_offsets, (T*)out, P, A_pad, rows, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bdia_spmv_f32(const void* idx, const void* vals,
                             const void* x, const void* d_offsets, void* out,
                             int S, int P, long long A_pad, long long rows,
                             long long C, void* stream) {
  return launch<float>(idx, vals, x, d_offsets, out, S, P, A_pad, rows, C,
                       stream);
}

extern "C" int bdia_spmv_f64(const void* idx, const void* vals,
                             const void* x, const void* d_offsets, void* out,
                             int S, int P, long long A_pad, long long rows,
                             long long C, void* stream) {
  return launch<double>(idx, vals, x, d_offsets, out, S, P, A_pad, rows, C,
                        stream);
}
