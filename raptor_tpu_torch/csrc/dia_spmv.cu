// DIA sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces raptor_tpu/device/pallas_kernels.py:dia_spmv_pallas.
//
//   out[s, i] = sum_k vals[s, k, i] * x[s, i + offsets[k]]   (x zero outside [0, C))
//
// over S stacked shards, K <= 64 diagonals, R rows and C columns per shard.
//
// Bound: memory. Each row reads its K diagonal values once and writes one
// output, and x is read about once (its K shifted windows overlap), so the
// least traffic is (K + 2) * R * itemsize bytes per shard at about one
// multiply-add per 4 (f32) or 8 (f64) bytes: far below the card's
// operations-per-byte balance.
//
// Design: one thread per row. For every k the threads of a warp read
// neighbouring vals[k, i] (coalesced) and neighbouring x[i + off_k]: the K
// windows of x overlap, so after the first diagonal they hit L1/L2 instead
// of device memory. The bounds check replaces the padded copy of x the
// TPU kernel stages in VMEM. The offsets are a small device array read at
// the same index by every thread (a broadcast through the L1 cache).
// Shards are the grid's y dimension.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void dia_spmv_kernel(const T* __restrict__ vals,
                                const T* __restrict__ x,
                                const int* __restrict__ offsets,
                                T* __restrict__ out, int K, long long R,
                                long long C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const long long s = blockIdx.y;
  const T* vs = vals + s * K * R + i;
  const T* xs = x + s * C;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const long long j = i + __ldg(offsets + k);
    const T xv = (j >= 0 && j < C) ? __ldg(xs + j) : T(0);
    acc += __ldg(vs + (long long)k * R) * xv;
  }
  out[s * R + i] = acc;
}

template <typename T>
int launch(const void* vals, const void* x, const void* offsets, void* out,
           int S, int K, long long R, long long C, void* stream) {
  if (S <= 0 || R <= 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned)((R + threads - 1) / threads), (unsigned)S);
  dia_spmv_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)vals, (const T*)x, (const int*)offsets, (T*)out, K, R, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dia_spmv_f32(const void* vals, const void* x,
                            const void* offsets, void* out, int S, int K,
                            long long R, long long C, void* stream) {
  return launch<float>(vals, x, offsets, out, S, K, R, C, stream);
}

extern "C" int dia_spmv_f64(const void* vals, const void* x,
                            const void* offsets, void* out, int S, int K,
                            long long R, long long C, void* stream) {
  return launch<double>(vals, x, offsets, out, S, K, R, C, stream);
}
