// Windowed-ELL sparse matrix-vector product for Hopper (sm_90a), over the
// sliced layout of raptor_tpu_torch/device/formats.py:well_slices.
//
// Replaces raptor_tpu/device/pallas_kernels.py:wind_ell_spmv_pallas.
//
//   out[s, r] = sum_e cvals[s, e] * x[s, ws[s, tile(r)]*128 + crel[s, e]]
//
// over the real entries e of row r, for the rows r < rows of S stacked
// shards (R = n_tiles * tile_rows packed rows), with x zero outside [0, C).
// Within a tile the rows are sorted by entry count, longest first, and cut
// into slices of 32; lane l of slice k holds row tile*tile_rows +
// perm[k*32 + l], and slice k's entries are [sptr[k]*32, sptr[k+1]*32) of
// crel/cvals, slot-major (slot j of lane l at (sptr[k] + j)*32 + l).
//
// Bound: memory. The sliced entries (crel, 2 or 4 bytes, and cvals), the
// row map (2 bytes a row), the slice offsets (4 bytes a slice), ws, x and
// the output, each read or written once; one multiply-add an entry. On top
// of those bytes come the x gathers, which the bound does not count: a
// warp's gather of one slot touches up to 32 sectors of 32 bytes of x, in
// L1 or L2 (chip_smoke.py models their count; PERF.md).
//
// Design: the padded [W, R] layout that the TPU kernel reads is padding in
// 63% of its slots on the 128^3 level-0 P and 40% on its P^T, and its
// packer spreads a row's entries over all W slots, so a kernel that skipped
// zero slots would still touch three quarters of the 32-byte sectors. The
// sliced layout drops the padding: with rows sorted by length a slice is
// as wide as its longest row and 96-98% of its slots are real. One warp
// per slice, one lane per row: a slot of a slice is one coalesced load of
// 32 values (128 bytes in f32) and 32 columns (64 bytes as int16). A lane
// works in steps of kInFlight slots and issues the column and value loads
// of the next step before it gathers x for this one (through __ldg, from
// the tile's window), so a step's stream loads overlap the previous
// step's gathers. It adds the products in slot order: no atomics, the same
// result on every run, and the same as the padded loop, whose extra terms
// are 0 * x. Each lane writes its row once, a scatter within the tile's
// outputs. The grid runs over slices, kWarps to a CTA, and shards are its
// y dimension.

#include <cuda_runtime.h>
#include <cstdint>

// slots a lane keeps in flight and warps a CTA (constants of the source;
// chip_sweep.py builds variants of them with -DWELL_INFLIGHT and
// -DWELL_WARPS; PERF.md holds the sweep that chose them)
#ifndef WELL_INFLIGHT
#define WELL_INFLIGHT 4
#endif
#ifndef WELL_WARPS
#define WELL_WARPS 16
#endif

namespace {

constexpr int kSlice = 32;      // rows of a slice: formats.WELL_SLICE
constexpr int kWarps = WELL_WARPS;
constexpr int kInFlight = WELL_INFLIGHT;
static_assert(kInFlight >= 1 && kInFlight <= 16, "WELL_INFLIGHT: 1 to 16");
static_assert(kWarps >= 1 && kWarps <= 32, "WELL_WARPS: 1 to 32");

// One warp a slice, one row a lane. A lane issues the column and value
// loads of the next kInFlight slots before it gathers x for this step's,
// then adds this step's products in slot order. Offsets within a shard are
// 32-bit (the wrapper keeps R, E and C below 2^31).
template <typename T, typename I>
__global__ void __launch_bounds__(kWarps * 32)
wind_ell_spmv_kernel(const int* __restrict__ ws,
                     const short* __restrict__ perm,
                     const int* __restrict__ sptr,
                     const I* __restrict__ crel,
                     const T* __restrict__ cvals,
                     const T* __restrict__ x, T* __restrict__ out,
                     int n_tiles, int tile_rows, long long E, int rows,
                     int C) {
  const int n_slices = n_tiles * tile_rows / kSlice;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= n_slices) return;
  const int lane = threadIdx.x & 31;
  const long long s = blockIdx.y;
  const int p = k * kSlice + lane;
  const int tile = p / tile_rows;
  const int row = tile * tile_rows +
                  (unsigned short)__ldg(perm + s * n_tiles * tile_rows + p);
  const unsigned base = (unsigned)__ldg(ws + s * n_tiles + tile) * 128u;
  const int* sp = sptr + s * (n_slices + 1) + k;
  const int s0 = __ldg(sp);
  const int width = __ldg(sp + 1) - s0;
  const I* cr = crel + s * E + s0 * kSlice + lane;
  const T* cv = cvals + s * E + s0 * kSlice + lane;
  const T* xs = x + s * C;

  I c[kInFlight];
  T v[kInFlight];
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    c[u] = u < width ? __ldg(cr + u * kSlice) : I(0);
    v[u] = u < width ? __ldg(cv + u * kSlice) : T(0);
  }
  T acc = T(0);
  for (int j = 0; j < width; j += kInFlight) {
    I cn[kInFlight];
    T vn[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int jn = j + kInFlight + u;
      cn[u] = jn < width ? __ldg(cr + jn * kSlice) : I(0);
      vn[u] = jn < width ? __ldg(cv + jn * kSlice) : T(0);
    }
    T xv[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const unsigned col = base + (unsigned)c[u];
      xv[u] = (j + u < width && col < (unsigned)C) ? __ldg(xs + col) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (j + u < width) acc += v[u] * xv[u];
      c[u] = cn[u];
      v[u] = vn[u];
    }
  }
  if (row < rows) out[s * rows + row] = acc;
}

template <typename T, typename I>
int launch_cols(const void* ws, const void* perm, const void* sptr,
                const void* crel, const void* cvals, const void* x,
                void* out, int S, int n_tiles, int tile_rows, long long E,
                int rows, int C, void* stream) {
  const int n_slices = n_tiles * tile_rows / kSlice;
  const dim3 grid((unsigned)((n_slices + kWarps - 1) / kWarps), (unsigned)S);
  wind_ell_spmv_kernel<T, I><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int*)ws, (const short*)perm, (const int*)sptr, (const I*)crel,
      (const T*)cvals, (const T*)x, (T*)out, n_tiles, tile_rows, E, rows, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* ws, const void* perm, const void* sptr,
           const void* crel, const void* cvals, const void* x, void* out,
           int S, int n_tiles, int tile_rows, long long E, long long rows,
           long long C, int col_bytes, void* stream) {
  if (S <= 0 || n_tiles <= 0 || rows <= 0) return 0;
  const long long R = (long long)n_tiles * tile_rows;
  if (tile_rows <= 0 || tile_rows % kSlice || R >= (1LL << 31) ||
      E >= (1LL << 31) || C >= (1LL << 31) || rows > R)
    return (int)cudaErrorInvalidValue;
  if (col_bytes == 2)
    return launch_cols<T, short>(ws, perm, sptr, crel, cvals, x, out, S,
                                 n_tiles, tile_rows, E, (int)rows, (int)C,
                                 stream);
  if (col_bytes == 4)
    return launch_cols<T, int>(ws, perm, sptr, crel, cvals, x, out, S,
                               n_tiles, tile_rows, E, (int)rows, (int)C,
                               stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// the slots in flight and warps a CTA this library was built with
extern "C" void wind_ell_spmv_shape(int* inflight, int* warps) {
  *inflight = kInFlight;
  *warps = kWarps;
}

extern "C" int wind_ell_spmv_f32(const void* ws, const void* perm,
                                 const void* sptr, const void* crel,
                                 const void* cvals, const void* x, void* out,
                                 int S, int n_tiles, int tile_rows,
                                 long long E, long long rows, long long C,
                                 int col_bytes, void* stream) {
  return launch<float>(ws, perm, sptr, crel, cvals, x, out, S, n_tiles,
                       tile_rows, E, rows, C, col_bytes, stream);
}

extern "C" int wind_ell_spmv_f64(const void* ws, const void* perm,
                                 const void* sptr, const void* crel,
                                 const void* cvals, const void* x, void* out,
                                 int S, int n_tiles, int tile_rows,
                                 long long E, long long rows, long long C,
                                 int col_bytes, void* stream) {
  return launch<double>(ws, perm, sptr, crel, cvals, x, out, S, n_tiles,
                        tile_rows, E, rows, C, col_bytes, stream);
}
