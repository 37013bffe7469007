// RLZ spectral analysis for Hopper (sm_90a): physical -> spectral in one pass.
//
// Replaces the Pallas TPU kernel scythe_tpu/ops/pallas_transforms.py
// (build_rlz_analysis, its inner kernel).  For every variable v of the
// physical field x [V, R, L, Z] (z contiguous) it computes
//
//     a[r,k,z]     = mask[r,k] * sum_l la[k,l] x[v,r,l,z]   lambda real DFT + ring mask
//     c[b,k,z]     = sum_r an[v,b,r] a[r,k,z]               radial quadrature + solve
//     out[v,b,k,K] = sum_z az[v,K,z] c[b,k,z]               vertical Chebyshev analysis
//
// and writes only out [V, B, L, Z]: neither the azimuthal coefficients nor
// the radial contraction ever reach device memory.  The operators are read
// in the field's own dtype (f32 or f64); the TPU kernel's bf16 hi/lo split
// is that chip's route to f32 accuracy and is not carried over.
//
// What bounds it: at the moist3d shape ([9, 144, 64, 48] -> b_rDim 51, f32)
// a call reads 16 MB and writes 5.6 MB, and does 2 V R L^2 Z (lambda) +
// 2 V B R L Z (radial) + 2 V B L Z^2 (vertical) = 1.05 GFLOP: ~49 FLOP per
// byte, above the card's f32 balance point (~20), so arithmetic, and in this
// simple design shared-memory traffic (every FMA reads shared memory), is
// the expected limit, not HBM.
//
// Design.  The TPU kernel keeps a whole [b_rDim, nz, nl] accumulator resident
// per variable (2.1 MB at the RLZ transform shape, b_rDim 67, nz 60, nl 128);
// a Hopper block may use 227 KB.  So the output is tiled: one block per
// (k-tile of KB azimuthal wavenumbers, b-tile of BB radial coefficients,
// variable), holding its [BB, KB, Z] accumulator in shared memory while it
// streams r in chunks of RC rows, and l in chunks of LC points, through
// shared memory:
//
//   for each r-chunk:  a-chunk [RC, KB, Z]  = mask * (la x)   (l streamed)
//                      acc     [BB, KB, Z] += an-chunk a-chunk
//   then:              out-tile [BB, KB, Z] = az acc
//
// The plan (make_plan below) sizes the tiles from nz, b_rDim and the dtype
// with the arithmetic of column_solve.cu: the accumulator gets at most
// kAccBudget (96 KB), so KB = 4 at f64 for both moist3d (51 x 4 x 48 x 8 B =
// 78 KB) and the TC grid (103 x 4 x 24 x 8 B = 79 KB), with KB halved and
// then b tiled where b_rDim x nz is larger; the x chunk gets at most
// kStageBudget (32 KB).  At the largest shape taken (nz 128, f64) the whole
// block is under 184 KB of the 227 KB a block may use.  Each element of a
// stage is owned by one thread, which keeps its partial sums in place across
// the l and r chunks, so the only barriers are the ones around staging.
// No wgmma or TMA yet.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNz = 128;    // the column solve's limit (column_solve.cu)
constexpr int kMaxNl = 2048;   // the dense DFT's limit (grids/base.py)
constexpr int kMaxKb = 4;      // azimuthal wavenumbers a block
constexpr int kMaxBb = 128;    // radial coefficients a block
constexpr int kRc = 8;         // radial rows a chunk
constexpr size_t kAccBudget = 96 * 1024;
constexpr size_t kStageBudget = 32 * 1024;

struct Plan {
  int kb, bb, rc, lc;
  size_t smem;
};

template <typename T>
__host__ __device__ constexpr T min_of(T a, T b) { return a < b ? a : b; }

Plan make_plan(int R, int L, int Z, int B, size_t es) {
  Plan p;
  p.kb = min_of(kMaxKb, L);
  while (p.kb > 1 && static_cast<size_t>(B) * p.kb * Z * es > kAccBudget) {
    p.kb /= 2;
  }
  const size_t bfit = kAccBudget / (static_cast<size_t>(p.kb) * Z * es);
  p.bb = static_cast<int>(min_of<size_t>(min_of<size_t>(B, kMaxBb), bfit));
  p.rc = min_of(kRc, R);
  const size_t lfit = kStageBudget / (static_cast<size_t>(p.rc) * Z * es);
  p.lc = static_cast<int>(min_of<size_t>(L, lfit < 1 ? 1 : lfit));
  p.smem = es * (static_cast<size_t>(p.bb) * p.kb * Z    // accumulator
                 + static_cast<size_t>(p.rc) * p.kb * Z  // a chunk
                 + static_cast<size_t>(p.rc) * p.lc * Z  // x chunk
                 + static_cast<size_t>(p.kb) * p.lc      // la chunk
                 + static_cast<size_t>(p.bb) * p.rc      // an chunk
                 + static_cast<size_t>(p.rc) * p.kb);    // mask chunk
  return p;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rlz_analysis_kernel(const T* __restrict__ x, const T* __restrict__ la,
                    const T* __restrict__ mask, const T* __restrict__ an,
                    const T* __restrict__ az, T* __restrict__ out, int R,
                    int L, int Z, int B, int kb, int bb, int rc, int lc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);                 // [nb][nk][Z]
  T* as = acc + static_cast<size_t>(bb) * kb * Z;          // [nr][nk][Z]
  T* xs = as + static_cast<size_t>(rc) * kb * Z;           // [nr][lc][Z]
  T* las = xs + static_cast<size_t>(rc) * lc * Z;          // [nk][lc]
  T* ans = las + static_cast<size_t>(kb) * lc;             // [nb][rc]
  T* ms = ans + static_cast<size_t>(bb) * rc;              // [nr][kb]

  const int k0 = blockIdx.x * kb;
  const int b0 = blockIdx.y * bb;
  const int v = blockIdx.z;
  const int nk = min_of(kb, L - k0);
  const int nb = min_of(bb, B - b0);
  const int tid = threadIdx.x;
  const int nkz = nk * Z;
  const int nacc = nb * nkz;
  const T* xv = x + static_cast<size_t>(v) * R * L * Z;
  const T* anv = an + static_cast<size_t>(v) * B * R;

  for (int e = tid; e < nacc; e += kThreads) acc[e] = T(0);

  for (int r0 = 0; r0 < R; r0 += rc) {
    const int nr = min_of(rc, R - r0);
    const int na = nr * nkz;
    for (int e = tid; e < nb * nr; e += kThreads) {
      const int b = e / nr;
      const int rr = e - b * nr;
      ans[b * rc + rr] = anv[static_cast<size_t>(b0 + b) * R + r0 + rr];
    }
    for (int e = tid; e < nr * nk; e += kThreads) {
      const int rr = e / nk;
      const int k = e - rr * nk;
      ms[rr * kb + k] = mask[static_cast<size_t>(r0 + rr) * L + k0 + k];
    }

    // stage 1: a = mask * (la x), l streamed in chunks of lc points; each
    // thread sums its own elements of a in place across the chunks
    for (int l0 = 0; l0 < L; l0 += lc) {
      const int nl = min_of(lc, L - l0);
      const int nlz = nl * Z;
      for (int e = tid; e < nr * nlz; e += kThreads) {
        const int rr = e / nlz;
        const int rem = e - rr * nlz;  // ll * Z + z, contiguous in x
        xs[rr * lc * Z + rem] =
            xv[(static_cast<size_t>(r0 + rr) * L + l0) * Z + rem];
      }
      for (int e = tid; e < nk * nl; e += kThreads) {
        const int k = e / nl;
        const int ll = e - k * nl;
        las[k * lc + ll] = la[static_cast<size_t>(k0 + k) * L + l0 + ll];
      }
      __syncthreads();
      const bool last = l0 + lc >= L;
      for (int e = tid; e < na; e += kThreads) {
        const int rr = e / nkz;
        const int rem = e - rr * nkz;
        const int k = rem / Z;
        const int z = rem - k * Z;
        const T* xr = xs + rr * lc * Z + z;
        const T* lr = las + k * lc;
        T s = T(0);
        for (int ll = 0; ll < nl; ++ll) s += lr[ll] * xr[ll * Z];
        T a = l0 == 0 ? s : as[e] + s;
        if (last) a *= ms[rr * kb + k];
        as[e] = a;
      }
      __syncthreads();
    }

    // stage 2: acc += an-chunk a-chunk
    for (int e = tid; e < nacc; e += kThreads) {
      const int b = e / nkz;
      const int rem = e - b * nkz;  // k * Z + z
      const T* ab = ans + b * rc;
      T s = T(0);
      for (int rr = 0; rr < nr; ++rr) s += ab[rr] * as[rr * nkz + rem];
      acc[e] += s;
    }
    __syncthreads();
  }

  // stage 3: out[v, b0 + b, k0 + k, K] = sum_z az[v, K, z] acc[b, k, z]
  const T* azv = az + static_cast<size_t>(v) * Z * Z;
  for (int e = tid; e < nacc; e += kThreads) {
    const int bk = e / Z;
    const int K = e - bk * Z;
    const int b = bk / nk;
    const int k = bk - b * nk;
    const T* cr = acc + bk * Z;
    const T* ar = azv + static_cast<size_t>(K) * Z;
    T s = T(0);
    for (int z = 0; z < Z; ++z) s += __ldg(ar + z) * cr[z];
    out[((static_cast<size_t>(v) * B + b0 + b) * L + k0 + k) * Z + K] = s;
  }
}

template <typename T>
int launch(const T* x, const T* la, const T* mask, const T* an, const T* az,
           T* out, int V, int R, int L, int Z, int B, void* stream) {
  if (V < 1 || R < 1 || B < 1 || L < 1 || L > kMaxNl || Z < 1 ||
      Z > kMaxNz) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(R, L, Z, B, sizeof(T));
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rlz_analysis_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((L + p.kb - 1) / p.kb, (B + p.bb - 1) / p.bb, V);
  rlz_analysis_kernel<T><<<grid, kThreads, p.smem,
                           static_cast<cudaStream_t>(stream)>>>(
      x, la, mask, an, az, out, R, L, Z, B, p.kb, p.bb, p.rc, p.lc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int scythe_rlz_analysis_max_nz() { return kMaxNz; }

int scythe_rlz_analysis_max_nl() { return kMaxNl; }

// The tiles and shared memory a launch at this shape uses:
// out = {KB, BB, RC, LC, shared-memory bytes}.
void scythe_rlz_analysis_plan(int R, int L, int Z, int B, int elem_size,
                              int* out) {
  const Plan p = make_plan(R, L, Z, B, static_cast<size_t>(elem_size));
  out[0] = p.kb;
  out[1] = p.bb;
  out[2] = p.rc;
  out[3] = p.lc;
  out[4] = static_cast<int>(p.smem);
}

int scythe_rlz_analysis_f32(const float* x, const float* la,
                            const float* mask, const float* an,
                            const float* az, float* out, int V, int R, int L,
                            int Z, int B, void* stream) {
  return launch<float>(x, la, mask, an, az, out, V, R, L, Z, B, stream);
}

int scythe_rlz_analysis_f64(const double* x, const double* la,
                            const double* mask, const double* an,
                            const double* az, double* out, int V, int R,
                            int L, int Z, int B, void* stream) {
  return launch<double>(x, la, mask, an, az, out, V, R, L, Z, B, stream);
}

}  // extern "C"
