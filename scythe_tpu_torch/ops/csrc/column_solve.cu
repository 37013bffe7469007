// Fused AI2* vertical column solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scythe_tpu/ops/pallas_semiimplicit.py
// (fused_column_solve, kernel _kernel).  For a batch of vertical columns
// [ncols, nz] (z contiguous) it computes, per column,
//
//     xf = F  x*                 truncation refit of xi*
//     g  = ts' Pxi (Dz x*) - w*
//     g  <- [0, 0, g[1], ..., g[nz-2]]   BC rows (g[0], g[nz-1] dropped)
//     a  = Hinv g                precomputed Helmholtz inverse
//     w  = S a
//     xi = xf - ts' (Ds a)
//
// five dependent [nz, nz] products with a row shift between two of them,
// so the intermediates never leave shared memory.
//
// What bounds it: at the moist3d shape (9216 columns, nz 48, f32) a call
// reads x* and w* and writes w and xi, 4 x 9216 x 48 x 4 B = 7.1 MB, and
// does 5 x 2 x 48 x 48 x 9216 = 0.21 GFLOP: about 30 FLOP per byte, near
// the card's f32 balance point (~67 TFLOP/s over 3.35 TB/s, ~20).  In this
// simple design the inner loop reads shared memory for every FMA, so
// shared-memory bandwidth, not HBM, is the expected limit; PERF.md has the
// measured time.
//
// Design: a 1-D grid over tiles of kTileCols columns; the ragged last tile
// is masked here, not padded by the caller.  A block stages its x* and w*
// tile in dynamic shared memory, holds xf there until the end, and stages
// ONE operator at a time (transposed, so a warp's reads of consecutive
// output levels z fall on consecutive banks).  Shared memory is
// (nz^2 + 4 kTileCols nz) elements: 21 KB at nz 48 in f32, 131 KB at nz 100
// in f64, 192 KB at the largest supported nz (128) in f64, under the
// 227 KB a block may use.  Each thread owns one output level z for
// kColsPerThread columns, so every operator element it reads is reused from
// a register kColsPerThread times.  No wgmma or TMA yet.

#include <cuda_runtime.h>

namespace {

constexpr int kColsPerThread = 4;
constexpr int kColGroups = 4;
constexpr int kTileCols = kColsPerThread * kColGroups;  // 16 columns a block
constexpr int kMaxNz = 128;

template <typename T>
__device__ __forceinline__ void stage_operator(T* __restrict__ opT,
                                               const T* __restrict__ op,
                                               int nz) {
  // opT[k * nz + z] = op[z * nz + k]; the global read is coalesced
  const int n = nz * nz;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int z = i / nz;
    const int k = i - z * nz;
    opT[k * nz + z] = op[i];
  }
}

// acc[j] = sum_k op[z][k] * in[c_j][k] for the thread's columns c_j
template <typename T>
__device__ __forceinline__ void apply(const T* __restrict__ opT,
                                      const T* __restrict__ in, int nz,
                                      int cg, int z,
                                      T (&acc)[kColsPerThread]) {
  const T* col = in + cg * kColsPerThread * nz;
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) acc[j] = T(0);
  for (int k = 0; k < nz; ++k) {
    const T o = opT[k * nz + z];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[j] += o * col[j * nz + k];
  }
}

template <typename T>
__global__ void column_solve_kernel(const T* __restrict__ x,
                                    const T* __restrict__ w,
                                    const T* __restrict__ F,
                                    const T* __restrict__ Dz,
                                    const T* __restrict__ Hinv,
                                    const T* __restrict__ S,
                                    const T* __restrict__ Ds,
                                    T* __restrict__ w_out,
                                    T* __restrict__ xi_out, int ncols, int nz,
                                    T tp, T ts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* opT = reinterpret_cast<T*>(smem_raw);  // [nz, nz], one operator
  const int tile = kTileCols * nz;
  T* xs = opT + nz * nz;  // x*, later a
  T* ws = xs + tile;      // w*
  T* xf = ws + tile;      // F x*
  T* gs = xf + tile;      // shifted g

  const long long col0 = static_cast<long long>(blockIdx.x) * kTileCols;
  const long long base = col0 * nz;
  const int ncols_here = static_cast<int>(
      ncols - col0 < kTileCols ? ncols - col0 : kTileCols);
  const int nvalid = ncols_here * nz;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const bool ok = i < nvalid;
    xs[i] = ok ? x[base + i] : T(0);
    ws[i] = ok ? w[base + i] : T(0);
  }
  stage_operator(opT, F, nz);
  __syncthreads();

  const bool active = threadIdx.x < kColGroups * nz;
  const int cg = threadIdx.x / nz;
  const int z = threadIdx.x - cg * nz;
  T acc[kColsPerThread];

  // xf = F x*
  if (active) {
    apply(opT, xs, nz, cg, z, acc);
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
      xf[(cg * kColsPerThread + j) * nz + z] = acc[j];
  }
  __syncthreads();
  stage_operator(opT, Dz, nz);
  __syncthreads();

  // g = ts' Pxi (Dz x*) - w*, written shifted: slot z+1 takes g[z] for
  // z in [1, nz-2]; the threads of z = 0 and z = nz-1 zero slots 0 and 1
  if (active) {
    apply(opT, xs, nz, cg, z, acc);
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = cg * kColsPerThread + j;
      T* gc = gs + c * nz;
      if (z == 0) {
        gc[0] = T(0);
      } else if (z == nz - 1) {
        gc[1] = T(0);
      } else {
        gc[z + 1] = tp * acc[j] - ws[c * nz + z];
      }
    }
  }
  __syncthreads();
  stage_operator(opT, Hinv, nz);
  __syncthreads();

  // a = Hinv g, into the x* buffer (x* is dead after the Dz stage)
  if (active) {
    apply(opT, gs, nz, cg, z, acc);
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
      xs[(cg * kColsPerThread + j) * nz + z] = acc[j];
  }
  __syncthreads();
  stage_operator(opT, S, nz);
  __syncthreads();

  // w = S a
  if (active) {
    apply(opT, xs, nz, cg, z, acc);
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = cg * kColsPerThread + j;
      if (c < ncols_here) w_out[base + c * nz + z] = acc[j];
    }
  }
  __syncthreads();
  stage_operator(opT, Ds, nz);
  __syncthreads();

  // xi = xf - ts' (Ds a)
  if (active) {
    apply(opT, xs, nz, cg, z, acc);
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = cg * kColsPerThread + j;
      if (c < ncols_here) xi_out[base + c * nz + z] = xf[c * nz + z] - ts * acc[j];
    }
  }
}

template <typename T>
int launch(const T* x, const T* w, const T* F, const T* Dz, const T* Hinv,
           const T* S, const T* Ds, T* w_out, T* xi_out, int ncols, int nz,
           double ts_term, double pxi, void* stream) {
  if (ncols < 1 || nz < 3 || nz > kMaxNz) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      (static_cast<size_t>(nz) * nz + 4 * static_cast<size_t>(kTileCols) * nz) *
      sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        column_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = ((kColGroups * nz + 31) / 32) * 32;
  const int blocks = (ncols + kTileCols - 1) / kTileCols;
  column_solve_kernel<T><<<blocks, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      x, w, F, Dz, Hinv, S, Ds, w_out, xi_out, ncols, nz,
      static_cast<T>(ts_term * pxi), static_cast<T>(ts_term));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int scythe_column_solve_max_nz() { return kMaxNz; }

int scythe_column_solve_f32(const float* x, const float* w, const float* F,
                            const float* Dz, const float* Hinv, const float* S,
                            const float* Ds, float* w_out, float* xi_out,
                            int ncols, int nz, double ts_term, double pxi,
                            void* stream) {
  return launch<float>(x, w, F, Dz, Hinv, S, Ds, w_out, xi_out, ncols, nz,
                       ts_term, pxi, stream);
}

int scythe_column_solve_f64(const double* x, const double* w, const double* F,
                            const double* Dz, const double* Hinv,
                            const double* S, const double* Ds, double* w_out,
                            double* xi_out, int ncols, int nz, double ts_term,
                            double pxi, void* stream) {
  return launch<double>(x, w, F, Dz, Hinv, S, Ds, w_out, xi_out, ncols, nz,
                        ts_term, pxi, stream);
}

const char* scythe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
