// Windowed-ELL sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces raptor_tpu/device/pallas_kernels.py:wind_ell_spmv_pallas.
//
//   out[s, r] = sum_w vals[s, w, r] * x[s, ws[s, r / tile_rows]*128 + rel[s, w, r]]
//
// over S stacked shards, for the rows r < rows of the packed row space
// (R rows, a multiple of tile_rows = ba*128), with x zero outside [0, C).
//
// Bound: memory. rel (int32) and vals are streamed once:
// W * R * (4 + itemsize) bytes, plus ws, x read once and the output written
// once, at one multiply-add per slot.
//
// Design: one thread per packed row, a loop over the W slots. Neighbouring
// threads read neighbouring rel/vals (coalesced). The x index is the tile's
// window start plus the window-relative column: a plain indexed load, which
// the whole Pallas machinery (the VMEM window DMA, and the jlo/jhi
// window-row scan that stands in for the dynamic sublane gather Mosaic
// lacks) reduces to on a GPU. The x windows of neighbouring rows overlap,
// so x is read from L1/L2 and the streamed bytes are the slots. The
// bounds check against the real x length replaces the zero-padded copy of
// x up to the window height that the JAX wrapper builds; jlo/jhi are not
// read. Shards are the grid's y dimension.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename T>
__global__ void wind_ell_spmv_kernel(const int* __restrict__ ws,
                                     const int* __restrict__ rel,
                                     const T* __restrict__ vals,
                                     const T* __restrict__ x,
                                     T* __restrict__ out, int W,
                                     int n_tiles, long long R,
                                     long long tile_rows, long long rows,
                                     long long C) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const long long s = blockIdx.y;
  const long long base =
      (long long)__ldg(ws + s * n_tiles + r / tile_rows) * 128;
  const T* xs = x + s * C;
  const long long e0 = s * (long long)W * R + r;
  T acc = T(0);
  for (int w = 0; w < W; ++w) {
    const long long e = e0 + (long long)w * R;
    const long long j = base + __ldg(rel + e);
    const T xv = (j >= 0 && j < C) ? __ldg(xs + j) : T(0);
    acc += __ldg(vals + e) * xv;
  }
  out[s * rows + r] = acc;
}

template <typename T>
int launch(const void* ws, const void* rel, const void* vals, const void* x,
           void* out, int S, int W, int n_tiles, long long R,
           long long tile_rows, long long rows, long long C, void* stream) {
  if (S <= 0 || rows <= 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned)((rows + threads - 1) / threads), (unsigned)S);
  wind_ell_spmv_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)ws, (const int*)rel, (const T*)vals, (const T*)x, (T*)out,
      W, n_tiles, R, tile_rows, rows, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wind_ell_spmv_f32(const void* ws, const void* rel,
                                 const void* vals, const void* x, void* out,
                                 int S, int W, int n_tiles, long long R,
                                 long long tile_rows, long long rows,
                                 long long C, void* stream) {
  return launch<float>(ws, rel, vals, x, out, S, W, n_tiles, R, tile_rows,
                       rows, C, stream);
}

extern "C" int wind_ell_spmv_f64(const void* ws, const void* rel,
                                 const void* vals, const void* x, void* out,
                                 int S, int W, int n_tiles, long long R,
                                 long long tile_rows, long long rows,
                                 long long C, void* stream) {
  return launch<double>(ws, rel, vals, x, out, S, W, n_tiles, R, tile_rows,
                        rows, C, stream);
}
