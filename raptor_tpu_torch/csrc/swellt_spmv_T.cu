// Sorted-scatter transposed sparse matrix-vector product ("wellt", the
// restriction format) for Hopper (sm_90a).
//
// Replaces raptor_tpu/device/pallas_kernels.py:swellt_spmv_T_pallas.
//
//   y = B^T x:  out[s, (qb[s, t*Kp + k] + qrel)*128 + lout] += vals[s, t, e] * x[s, t*128 + srcl]
//
// for every packed entry e of source tile t (slot k = e / 128), with
// meta[s, t, e] = srcl | qrel << 7 | lout << 12, over S stacked shards.
// Targets at or past n_out are dropped (the JAX version slices them off).
//
// Bound: memory. vals is streamed once, T * Kp * 128 * itemsize bytes, and
// meta (int32) only where val != 0, 4 * nnz bytes; plus qb, x read once and
// the output written once; one multiply-add per nonzero, issued as an
// atomic add.
//
// Design: one thread per packed entry; the wrapper zero-fills the output
// and the kernel adds into it with atomicAdd (native for float and, on
// sm_90, for double). The TPU kernel's one-hot MXU scatter, its
// VMEM-resident output and the SMEM table of window bases all become this
// one atomic add at the decoded target. Padding entries (val 0, meta 0, qb
// 0) would all hit out[s, 0] and serialise on that address, so entries
// with val == 0 are skipped. Entries of a slot share their target window
// (SWELLT_AMAX rows), so the atomics of a warp land in a few L2 lines.
// The float sum order changes from run to run. Shards are the grid's y
// dimension.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename T>
__global__ void swellt_spmv_T_kernel(const int* __restrict__ meta,
                                     const T* __restrict__ vals,
                                     const int* __restrict__ qb,
                                     const T* __restrict__ x,
                                     T* __restrict__ out, long long n_tiles,
                                     long long KL, long long n_out,
                                     long long C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_shard = n_tiles * KL;
  if (i >= per_shard) return;
  const long long s = blockIdx.y;
  const long long e = s * per_shard + i;
  const T v = __ldg(vals + e);
  if (v == T(0)) return;
  const int m = __ldg(meta + e);
  const long long t = i / KL;
  const long long xi = t * 128 + (m & 127);
  if (xi >= C) return;
  const long long slot = i / 128;  // t * Kp + k
  const long long tgt =
      ((long long)__ldg(qb + s * (per_shard / 128) + slot) + ((m >> 7) & 31)) *
          128 +
      ((m >> 12) & 127);
  if (tgt < 0 || tgt >= n_out) return;
  atomicAdd(out + s * n_out + tgt, v * __ldg(x + s * C + xi));
}

template <typename T>
int launch(const void* meta, const void* vals, const void* qb, const void* x,
           void* out, int S, long long n_tiles, long long KL,
           long long n_out, long long C, void* stream) {
  const long long per_shard = n_tiles * KL;
  if (S <= 0 || per_shard <= 0 || n_out <= 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned)((per_shard + threads - 1) / threads),
                  (unsigned)S);
  swellt_spmv_T_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)meta, (const T*)vals, (const int*)qb, (const T*)x, (T*)out,
      n_tiles, KL, n_out, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int swellt_spmv_T_f32(const void* meta, const void* vals,
                                 const void* qb, const void* x, void* out,
                                 int S, long long n_tiles, long long KL,
                                 long long n_out, long long C, void* stream) {
  return launch<float>(meta, vals, qb, x, out, S, n_tiles, KL, n_out, C,
                       stream);
}

extern "C" int swellt_spmv_T_f64(const void* meta, const void* vals,
                                 const void* qb, const void* x, void* out,
                                 int S, long long n_tiles, long long KL,
                                 long long n_out, long long C, void* stream) {
  return launch<double>(meta, vals, qb, x, out, S, n_tiles, KL, n_out, C,
                        stream);
}
