// BELL (block-ELL of plane slots) sparse matrix-vector product for Hopper
// (sm_90a).
//
// Replaces raptor_tpu/device/pallas_kernels.py:bell_spmv_pallas.
//
//   out[s, a*128 + l] = sum_w vals[s, w, a, l] * x[s, src[s, w, a]*128 + idx[s, w, a, l]]
//
// over S stacked shards and W slot layers, for the rows a*128 + l < rows,
// with x zero outside [0, C). Slot (w, a) holds one source 128-block of x
// for the 128 rows of target block a; idx (int8, 0-127) is each row's lane
// in that block.
//
// Bound: memory. The slots are streamed once:
// W * A128 * 128 * (itemsize + 1) bytes plus W * A128 int32 block ids, with
// x read and the output written once, at one multiply-add per slot entry.
//
// Design: one thread per output row (a, l), a loop over w. A warp's 32
// threads share a, so src[s, w, a] is one broadcast load per warp and
// slot, and the x loads of a warp fall inside one 128-block (a 512-byte
// or 1 KB segment) that the other slots reuse through L1/L2. idx and vals
// are read coalesced. The bounds check replaces the TPU kernel's
// VMEM-resident padded copy of x (and its 4 MB cap); the SMEM block table
// becomes the broadcast load. Shards are the grid's y dimension.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename T>
__global__ void bell_spmv_kernel(const int* __restrict__ src,
                                 const int8_t* __restrict__ idx,
                                 const T* __restrict__ vals,
                                 const T* __restrict__ x,
                                 T* __restrict__ out, int W, long long A128,
                                 long long rows, long long C) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const long long s = blockIdx.y;
  const long long a = r >> 7;
  const long long plane = A128 * 128;
  const long long e0 = s * W * plane + r;
  const long long b0 = s * W * A128 + a;
  const T* xs = x + s * C;
  T acc = T(0);
  for (int w = 0; w < W; ++w) {
    const long long e = e0 + (long long)w * plane;
    const long long j =
        (long long)__ldg(src + b0 + (long long)w * A128) * 128 + __ldg(idx + e);
    const T xv = (j >= 0 && j < C) ? __ldg(xs + j) : T(0);
    acc += __ldg(vals + e) * xv;
  }
  out[s * rows + r] = acc;
}

template <typename T>
int launch(const void* src, const void* idx, const void* vals, const void* x,
           void* out, int S, int W, long long A128, long long rows,
           long long C, void* stream) {
  if (S <= 0 || rows <= 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned)((rows + threads - 1) / threads), (unsigned)S);
  bell_spmv_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)src, (const int8_t*)idx, (const T*)vals, (const T*)x,
      (T*)out, W, A128, rows, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bell_spmv_f32(const void* src, const void* idx,
                             const void* vals, const void* x, void* out, int S,
                             int W, long long A128, long long rows,
                             long long C, void* stream) {
  return launch<float>(src, idx, vals, x, out, S, W, A128, rows, C, stream);
}

extern "C" int bell_spmv_f64(const void* src, const void* idx,
                             const void* vals, const void* x, void* out, int S,
                             int W, long long A128, long long rows,
                             long long C, void* stream) {
  return launch<double>(src, idx, vals, x, out, S, W, A128, rows, C, stream);
}
