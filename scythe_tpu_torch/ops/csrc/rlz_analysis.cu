// RLZ spectral analysis for Hopper (sm_90a): physical -> spectral in one
// launch, as thread-block clusters that split r.
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
// the radial contraction reach device memory.  The plain mode reads the
// operators in the field's own dtype (f32 or f64).
//
// The comp mode (template flag C, f32) is the TPU kernel's own arithmetic,
// for a compensated grid: each operator comes as its bf16 pair [hi, lo]
// (the grid's split, rounded to nearest even), the activation is split in
// the kernel as hi = bf16(v), lo = bf16(v - hi) (__float2bfloat16_rn, never
// by truncation) before each contraction -- x, the masked lambda
// coefficients as the radial stage reads them, the reduced radial sums as
// the vertical stage reads them: where the TPU kernel re-splits -- and each
// product is hi·hi + lo·hi + hi·lo, three FFMAs into the f32 accumulator
// (fma3).  The same tiles, staging and cluster reduction serve both modes;
// comp stages each operator tile twice (hi, then lo) and does three times
// the FMAs, so it is the plain kernel's FFMA-bound design at three times
// its arithmetic (PERF.md has its times).
//
// What bounded the first design (one block per (k-tile of 4, b-tile,
// variable), r walked serially inside it): too few blocks (9 at the TC
// shape [9, 300, 4, 24], 144 at moist3d [9, 144, 64, 48], on 132 SMs); every
// FMA read two shared-memory operands in one dependent chain a thread, so
// shared-memory latency set the rate (~1.1 TFLOP/s at moist3d); staging and
// compute never overlapped; and x was re-read from L2 once per 4
// wavenumbers.  It ran 3.6-9x slower than the plain cuBLAS chain.
//
// What bounds this one.  moist3d does 2VRL^2Z + 2VBRLZ + 2VBLZ^2 = 1.05
// GFLOP, the RLZ transform shape [8, 192, 128, 60] 5.1 GFLOP: 16 and 76 us
// at the card's 67 TFLOP/s f32 FFMA peak, the rate of this kernel's
// arithmetic.  On the tensor cores at f32 accuracy (3xTF32, a third of 495
// TFLOP/s) moist3d's would take 6.4 us, level with its bytes (22 MB, 6.6 us
// at 3.35 TB/s): that is its bound.  x is re-read from L2 once per k-tile, 8x at
// moist3d (127 MB) and 16x at the transform shape (754 MB).  Timed by phase
// with clock64 on an H100 (a block's cycles, f32): at moist3d ~74k, of
// which the lambda and radial stages ~44k, waiting for x ~8k, the vertical
// stage ~8k, the cluster reduction and its barriers ~7k; at the transform
// shape ~306k, of which the two stages ~217k, waiting for x ~40k, the
// vertical stage ~28k.  The two stages run at 40-46 FMA a clock on an SM,
// a third of its FFMA rate; the lambda loop is 8 LDS.128, 12 integer ops
// and 64 FFMA per 4 azimuths.  In A/B builds on the card: a quarter fewer
// shared loads a FMA with twice the independent accumulators (a lane pair
// sharing an 8 k x 4 z tile over alternate l) was 1-3% slower;
// a larger tile a thread on fewer warps (8 k x 4 z, or 2 rows of it:
// spills at the 128 registers a thread that 512 threads leave) was 6-15%
// slower, and more warps at work (r-chunks of 20, so shorter l-chunks) 10%
// slower; leaving out the l_analysis copies (results discarded) saved
// 1.5-3.6%, and the x copies too 3-14%.  The TC shape does 0.06 GFLOP:
// set-up, waiting for the first piece of x, barriers and the epilogue
// (~15k of ~23k cycles) bound it.
//
// Design.
//  1. A block owns (r-slice, k-tile of KT wavenumbers, b-tile of BT radial
//     coefficients, variable).  The C <= 8 r-slices of one (k-tile, b-tile,
//     variable) are one cluster (gridDim.x == C).  Each block accumulates
//     its partial [BT, KT, Z] over its own rows; after cluster.sync() block
//     j sums its 1/C share of the (b, k) rows over the C partials, read
//     through distributed shared memory in rank order (deterministic, no
//     atomics), applies the vertical stage to them and stores them; a second
//     cluster.sync() keeps every block's shared memory alive until its peers
//     have read it.  This is the TPU kernel's sequential reduction over its
//     r grid axis, moved onto Hopper's distributed shared memory: 216
//     blocks at moist3d and at the TC shape, 256 at the transform shape,
//     not 144, 9 and 256 with r walked serially.
//  2. Warp specialisation.  The last warp of the block is the producer: it
//     streams x in pieces (RC rows x LC azimuths) into a ring of ST slots,
//     one TMA tensor copy (cp.async.bulk.tensor) a piece with its bytes
//     counted on the slot's mbarrier, and the transposed operator tiles
//     (l_analysis, analysis_r, the mask) with cp.async element copies that
//     arrive on the same mbarriers.  The other warps consume: they wait on a
//     slot's "full" barrier, compute, and release it on its "empty" barrier,
//     so no block-wide barrier sits in the lambda loop and the copy of the
//     next pieces overlaps the work on this one.  Measured: a version in
//     which every thread issued its own 16-byte cp.async copies spent a
//     third of its cycles issuing them, and one with a 1D bulk copy a row
//     of x waited on the copy engine twice as long as the tensor copy.
//  3. Every stage is register-tiled: a thread owns a 4 x 4 tile of outputs
//     in independent accumulators; its operands come from shared memory in
//     16-byte loads (float4, or two double2), one of them broadcast across
//     the warp, so each pair of loads feeds 16 FMAs.  A consumer keeps its
//     lambda tile in registers across all l-pieces of an r-chunk (at f32 it
//     sums each piece apart and adds it, a blocked sum over nl up to 2048).
//     analysis_z is staged in shared memory for the vertical stage,
//     transposed, in chunks of ZC of its rows where nz is large at f64; the
//     first chunk's copies are issued before the cluster reduction, so they
//     land while it runs.
//  4. The tiles come from ops/rlz_analysis.py plan(), pure Python, the
//     plan's only home; this file lays out shared memory from them
//     (Layout, mirrored by smem_layout there) and refuses a plan whose
//     bytes differ, exceed 232,448, or leave no cluster resident.
//  5. No tensor cores.  The value chain is true FP32 or FP64 (no TF32), so
//     an f32 tensor-core route is 3xTF32 (mma.sync m16n8k8 with a hi/lo
//     split, as the TPU kernel's bf16 hi/lo), which needs its own accuracy
//     gate; DMMA would serve only the f64 parity runs.  The two stages it
//     would speed up take ~0.045 ms of moist3d's ~0.077, about 2% of a
//     device-busy step.  So the arithmetic is FFMA/DFMA.
//
// Padding: z rows are padded to Zp = 4*ceil(Z/4), and the k and b extents
// of the tiles to multiples of 4.  Shared memory is zeroed once, copies
// write only real elements, and every contraction runs over real indices
// only, so padding never reaches a stored output.  x goes by the copy
// engine when nz is a multiple of 4 (rows of whole 16-byte units, z not
// padded), else element by element.  The mask is multiplied in, not used
// to skip work, so a NaN in x reaches out where the plain chain puts it.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxNz = 128;     // the column solve's limit (column_solve.cu)
constexpr int kMaxNl = 2048;    // the dense DFT's limit (grids/base.py)
constexpr int kMaxKt = 16;      // azimuthal wavenumbers a tile
constexpr int kMaxRc = 64;      // radial rows a chunk
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxSt = 4;       // slots in the staging ring
constexpr int kBarBytes = 128;  // the mbarriers, ahead of the tiles
constexpr size_t kMaxSmem = 232448;

// a refused plan (ops/rlz_analysis.py PLAN_ERRORS)
constexpr int kBadShape = -1;
constexpr int kBadTile = -2;
constexpr int kBadSmem = -3;
constexpr int kNoCluster = -4;
constexpr int kNoTensorMap = -5;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int up4(int n) { return cdiv(n, 4) * 4; }
__host__ __device__ constexpr int min_of(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int max_of(int a, int b) { return a > b ? a : b; }

struct Tiles {
  int kt, bt, c, rc, lc, zc, st;  // st: slots in the staging ring
};

// Shared-memory layout in elements after the mbarriers: the accumulator,
// then a region used by the main loop's staging and, after it, by the
// epilogue.  ``nops``: parts an operator tile is staged in (1; the comp
// mode 2: hi, then lo right after it).
struct Layout {
  int zp, ktp, btp;
  int acc_n, x_n, la_n, an_n, ms_n, a_n, red_n, az_n;
  int x_off, la_off, an_off, ms_off, a_off, red_off, az_off, total;
  __host__ __device__ Layout(int Z, const Tiles& t, int elem_size, int nops)
      : zp(up4(Z)), ktp(up4(t.kt)), btp(up4(t.bt)) {
    acc_n = btp * ktp * zp;
    // a piece of x [RC][LC][Zp], each slot 128-byte aligned for the copy
    // engine
    const int align = 128 / elem_size;
    x_n = cdiv(t.rc * t.lc * zp, align) * align;
    la_n = nops * t.lc * ktp;  // l_analysis transposed [nops][LC][KTp]
    an_n = nops * t.rc * btp;  // analysis_r transposed [nops][RC][BTp]
    ms_n = t.rc * ktp;       // ring mask [RC][KTp]
    a_n = t.rc * ktp * zp;   // the chunk's lambda coefficients [RC][KTp][Zp]
    x_off = acc_n;
    la_off = x_off + t.st * x_n;
    an_off = la_off + t.st * la_n;
    ms_off = an_off + 2 * an_n;
    a_off = ms_off + 2 * ms_n;
    const int stage_n = a_off + a_n - acc_n;
    red_n = up4(cdiv(t.bt * t.kt, t.c)) * zp;  // this block's share of rows
    az_n = nops * zp * up4(t.zc);  // analysis_z^T chunk [nops][Zp][ZCp]
    red_off = acc_n;
    az_off = red_off + red_n;
    total = acc_n + max_of(stage_n, red_n + az_n);
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "n"(N)
               : "memory");
}

// a box {Z, LC, RC} of x, viewed as [V * R][L][Z], by the copy engine from
// (row, l0): one instruction a piece; its bytes complete on bar
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int l0,
                                            int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(l0), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// arrives on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the consumer warps only (named barrier 1)
template <int N>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ld4(const float* p, float (&r)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}

__device__ __forceinline__ void ld4(const double* p, double (&r)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  r[0] = a.x;
  r[1] = a.y;
  r[2] = b.x;
  r[3] = b.y;
}

__device__ __forceinline__ void st4(float* p, const float (&r)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ void st4(double* p, const double (&r)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(r[0], r[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(r[2], r[3]);
}

// f(o, i) for every o < n_o, i < n_i, spread over the block's NT threads
// with i on neighbouring threads; one division a call, none an element
template <int NT, typename F>
__device__ __forceinline__ void for_2d(int n_o, int n_i, F&& f) {
  if (n_i >= NT) {
    for (int o = 0; o < n_o; ++o) {
      for (int i = threadIdx.x; i < n_i; i += NT) f(o, i);
    }
    return;
  }
  const int per = NT / n_i;  // rows of i a pass
  const int o0 = threadIdx.x / n_i;
  if (o0 >= per) return;
  const int i = threadIdx.x - o0 * n_i;
  for (int o = o0; o < n_o; o += per) f(o, i);
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// the comp mode's split of an activation: hi = bf16(v), lo = bf16(v - hi),
// each rounded to nearest even, kept as floats
__device__ __forceinline__ void split_bf16(float v, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(v));
  lo = __bfloat162float(__float2bfloat16_rn(v - hi));
}

// s + the compensated product of an operator (oh, ol) and an activation
// (xh, xl): oh xh + ol xh + oh xl, the lo·lo term dropped; each product of
// two bf16 values is exact in f32
__device__ __forceinline__ float fma3(float oh, float ol, float xh, float xl, float s) {
  return __fmaf_rn(oh, xl, __fmaf_rn(ol, xh, __fmaf_rn(oh, xh, s)));
}

// NT threads: NT - 32 consumers and one producer warp; C: the comp mode
// (T = float; la, an and az then point at [2][...]: hi, then lo)
template <typename T, int NT, bool C>
__global__ void __launch_bounds__(NT, 512 / NT)
rlz_analysis_kernel(const T* __restrict__ x, const T* __restrict__ la,
                    const T* __restrict__ mask, const T* __restrict__ an,
                    const T* __restrict__ az, T* __restrict__ out, int R,
                    int L, int Z, int B, Tiles t, int n_kt,
                    const __grid_constant__ CUtensorMap xmap, bool xtma) {
  constexpr int kNc = NT - 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);  // [st] a piece landed
  uint64_t* empty = full + kMaxSt;                         // [st] a slot is free
  uint64_t* an_full = empty + kMaxSt;                      // [2] a chunk's operators
  uint64_t* an_empty = an_full + 2;                        // [2]
  T* sm = reinterpret_cast<T*>(smem_raw + kBarBytes);
  const Layout lay(Z, t, static_cast<int>(sizeof(T)), C ? 2 : 1);
  const int zp = lay.zp, ktp = lay.ktp, btp = lay.btp;
  cg::cluster_group cluster = cg::this_cluster();
  const int j = static_cast<int>(cluster.block_rank());  // the r-slice
  const int k0 = (blockIdx.y % n_kt) * t.kt;
  const int b0 = (blockIdx.y / n_kt) * t.bt;
  const int v = blockIdx.z;
  const int nk = min_of(t.kt, L - k0);
  const int nb = min_of(t.bt, B - b0);
  const int nkp = up4(nk);
  const int tid = threadIdx.x;
  const T* xv = x + static_cast<size_t>(v) * R * L * Z;
  const T* anv = an + static_cast<size_t>(v) * B * R;
  // the comp mode's lo parts: after all V variables' hi parts
  const T* anv_lo = an + (static_cast<size_t>(gridDim.z) + v) * B * R;
  const T* la_lo = la + static_cast<size_t>(L) * L;
  T* acc = sm;  // [BTp][KTp][Zp]
  T* as = sm + lay.a_off;

  {
    uint4* sm16 = reinterpret_cast<uint4*>(sm);
    const int n16 = lay.total * static_cast<int>(sizeof(T)) / 16;
    for (int e = tid; e < n16; e += NT) sm16[e] = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    for (int s = 0; s < t.st; ++s) {
      mbar_init(&full[s], 33);  // the producer's 32 lanes + its byte count
      mbar_init(&empty[s], kNc / 32);
    }
    for (int a = 0; a < 2; ++a) {
      mbar_init(&an_full[a], 32);
      mbar_init(&an_empty[a], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the zeros before any copy-engine write to the same bytes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int rs = cdiv(R, t.c);
  const int r_lo = min_of(R, j * rs);
  const int r_hi = min_of(R, r_lo + rs);
  const int n_lc = cdiv(L, t.lc);
  const int n_rc = cdiv(r_hi - r_lo, t.rc);

  if (tid >= kNc) {
    // producer: piece p = (r-chunk p / n_lc, l-chunk p % n_lc) into slot
    // p % st; the first piece of an r-chunk also brings its analysis_r and
    // mask rows into operator slot (r-chunk) % 2
    const int lane = tid - kNc;
    for (int p = 0; p < n_rc * n_lc; ++p) {
      const int s = p % t.st;
      const int ci = p / n_lc;
      const int li = p - ci * n_lc;
      const int r0 = r_lo + ci * t.rc;
      const int nr = min_of(t.rc, r_hi - r0);
      const int l0 = li * t.lc;
      const int nl = min_of(t.lc, L - l0);
      if (li == 0) {
        const int a = ci & 1;
        if (ci >= 2) mbar_wait(&an_empty[a], ((ci >> 1) - 1) & 1);
        T* ans = sm + lay.an_off + a * lay.an_n;
        for (int e = lane; e < nb * nr; e += 32) {
          const int b = e / nr;
          const int rr = e - b * nr;
          cp_async<sizeof(T)>(ans + rr * btp + b,
                              anv + static_cast<size_t>(b0 + b) * R + r0 + rr);
          if constexpr (C) {
            cp_async<sizeof(T)>(ans + t.rc * btp + rr * btp + b,
                                anv_lo + static_cast<size_t>(b0 + b) * R + r0 + rr);
          }
        }
        T* mss = sm + lay.ms_off + a * lay.ms_n;
        for (int e = lane; e < nr * nk; e += 32) {
          const int rr = e / nk;
          const int k = e - rr * nk;
          cp_async<sizeof(T)>(mss + rr * ktp + k,
                              mask + static_cast<size_t>(r0 + rr) * L + k0 + k);
        }
        mbar_arrive_cp_async(&an_full[a]);
      }
      if (p >= t.st) mbar_wait(&empty[s], (p / t.st - 1) & 1);
      T* xs = sm + lay.x_off + s * lay.x_n;
      const T* xr = xv + (static_cast<size_t>(r0) * L + l0) * Z;
      if (xtma) {
        // the whole box lands and counts, rows or azimuths past the piece
        // included (zeros past the tensor's end; never read)
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], t.rc * t.lc * Z * static_cast<unsigned>(sizeof(T)));
          tensor_copy(xs, &xmap, l0, v * R + r0, &full[s]);
        }
      } else {
        if (lane == 0) mbar_arrive(&full[s]);
        const int nlz = nl * Z;
        for (int e = lane; e < nr * nlz; e += 32) {
          const int rr = e / nlz;
          const int q = e - rr * nlz;
          const int ll = q / Z;
          cp_async<sizeof(T)>(xs + (rr * t.lc + ll) * zp + q - ll * Z,
                              xr + static_cast<size_t>(rr) * L * Z + q);
        }
      }
      T* las = sm + lay.la_off + s * lay.la_n;
      for (int e = lane; e < nk * nl; e += 32) {
        const int k = e / nl;
        const int ll = e - k * nl;
        cp_async<sizeof(T)>(las + ll * ktp + k,
                            la + static_cast<size_t>(k0 + k) * L + l0 + ll);
        if constexpr (C) {
          cp_async<sizeof(T)>(las + t.lc * ktp + ll * ktp + k,
                              la_lo + static_cast<size_t>(k0 + k) * L + l0 + ll);
        }
      }
      mbar_arrive_cp_async(&full[s]);
    }
  } else {
    // consumers, r-chunk by r-chunk; a lambda tile's lanes: z-groups
    // fastest, then k-groups, then rows
    const int zg_n = zp / 4;
    const int per_r = nkp / 4 * zg_n;
    for (int ci = 0; ci < n_rc; ++ci) {
      const int nr = min_of(t.rc, r_hi - r_lo - ci * t.rc);
      // stage 1: a[rr][k][z] = sum_l laT[l][k] x[rr][l][z], a 4 k x 4 z
      // tile a thread, in registers across the chunk's l-pieces
      const int rr = tid / per_r;
      const int kg = (tid - rr * per_r) / zg_n;
      const int zg = tid - rr * per_r - kg * zg_n;
      const bool mine = rr < nr;
      T s[4][4] = {};
      for (int li = 0; li < n_lc; ++li) {
        const int p = ci * n_lc + li;
        const int sl = p % t.st;
        const int nl = min_of(t.lc, L - li * t.lc);
        mbar_wait(&full[sl], (p / t.st) & 1);
        if (mine) {
          const T* xp = sm + lay.x_off + sl * lay.x_n + rr * t.lc * zp + zg * 4;
          const T* lp = sm + lay.la_off + sl * lay.la_n + kg * 4;
          auto piece = [&](T(&sum)[4][4]) {
#pragma unroll 4
            for (int ll = 0; ll < nl; ++ll) {
              T xr[4], lr[4];
              ld4(xp + ll * zp, xr);
              ld4(lp + ll * ktp, lr);
              if constexpr (C) {
                T lo[4], xh[4], xl[4];
                ld4(lp + t.lc * ktp + ll * ktp, lo);
#pragma unroll
                for (int q = 0; q < 4; ++q) split_bf16(xr[q], xh[q], xl[q]);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
#pragma unroll
                  for (int q = 0; q < 4; ++q) {
                    sum[i][q] = fma3(lr[i], lo[i], xh[q], xl[q], sum[i][q]);
                  }
                }
              } else {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
#pragma unroll
                  for (int q = 0; q < 4; ++q) sum[i][q] = fma_t(lr[i], xr[q], sum[i][q]);
                }
              }
            }
          };
          if constexpr (sizeof(T) == 4) {
            // f32 sums each l-piece apart, then adds it (blocked summation:
            // nl may reach 2048); f64 sums straight through
            T part[4][4] = {};
            piece(part);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int q = 0; q < 4; ++q) s[i][q] += part[i][q];
            }
          } else {
            piece(s);
          }
        }
        __syncwarp();
        if ((tid & 31) == 0) mbar_arrive(&empty[sl]);
      }
      const int a = ci & 1;
      mbar_wait(&an_full[a], (ci >> 1) & 1);
      if (mine) {
        const T* mss = sm + lay.ms_off + a * lay.ms_n + rr * ktp + kg * 4;
        T* ap = as + (rr * ktp + kg * 4) * zp + zg * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const T m = mss[i];
#pragma unroll
          for (int q = 0; q < 4; ++q) s[i][q] *= m;
          st4(ap + i * zp, s[i]);
        }
      }
      consumer_sync<kNc>();  // the chunk's a is complete

      // stage 2: acc[b][k][z] += sum_rr anT[rr][b] a[rr][k][z], 4 b x 4 kz
      const T* ans = sm + lay.an_off + a * lay.an_n;
      const int kz_n = ktp * zp;
      const int kzg_n = nkp * zp / 4;
      const int n_items = cdiv(nb, 4) * kzg_n;
      for (int it = tid; it < n_items; it += kNc) {
        const int bg = it / kzg_n;
        const int kzg = it - bg * kzg_n;
        const T* ap = as + kzg * 4;
        const T* bp = ans + bg * 4;
        T c4[4][4] = {};
#pragma unroll 4
        for (int r2 = 0; r2 < nr; ++r2) {
          T ar[4], br[4];
          ld4(ap + r2 * kz_n, ar);
          ld4(bp + r2 * btp, br);
          if constexpr (C) {
            T bl[4], ah[4], al[4];
            ld4(bp + t.rc * btp + r2 * btp, bl);
#pragma unroll
            for (int q = 0; q < 4; ++q) split_bf16(ar[q], ah[q], al[q]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int q = 0; q < 4; ++q) c4[i][q] = fma3(br[i], bl[i], ah[q], al[q], c4[i][q]);
            }
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int q = 0; q < 4; ++q) c4[i][q] = fma_t(br[i], ar[q], c4[i][q]);
            }
          }
        }
        T* cp = acc + bg * 4 * kz_n + kzg * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          T prev[4];
          ld4(cp + i * kz_n, prev);
#pragma unroll
          for (int q = 0; q < 4; ++q) prev[q] += c4[i][q];
          st4(cp + i * kz_n, prev);
        }
      }
      consumer_sync<kNc>();  // a and the operator slot are free
      if (tid == 0) mbar_arrive(&an_empty[a]);
    }
  }
  __syncthreads();

  // the first chunk of analysis_z^T, over the staging region, in flight
  // through the cluster's reduction
  const T* azv = az + static_cast<size_t>(v) * Z * Z;
  const T* azv_lo = az + (static_cast<size_t>(gridDim.z) + v) * Z * Z;  // comp
  T* azs = sm + lay.az_off;  // [nops][Zp][ZCp]
  const int kcp = up4(t.zc);
  const int az_lo = zp * kcp;  // the comp mode's lo part, after the hi part
  auto stage_az = [&](int K0) {
    for_2d<NT>(min_of(t.zc, Z - K0), zp, [&](int Kr, int z) {
      if (z < Z) {
        cp_async<sizeof(T)>(azs + z * kcp + Kr, azv + static_cast<size_t>(K0 + Kr) * Z + z);
        if constexpr (C) {
          cp_async<sizeof(T)>(azs + az_lo + z * kcp + Kr,
                              azv_lo + static_cast<size_t>(K0 + Kr) * Z + z);
        }
      } else {
        azs[z * kcp + Kr] = T(0);
        if constexpr (C) azs[az_lo + z * kcp + Kr] = T(0);
      }
    });
  };
  stage_az(0);

  // every partial is complete; block j reduces its share of the (b, k)
  // rows over the cluster's partials, in rank order
  cluster.sync();
  const int share = cdiv(t.bt * t.kt, t.c);
  const int q0 = min_of(nb * nk, j * share);
  const int nq = min_of(nb * nk, q0 + share) - q0;
  T* red = sm + lay.red_off;  // [share][Zp], over the staging region
  {
    const int zg_n = zp / 4;
    for (int e = tid; e < nq * zg_n; e += NT) {
      const int q = e / zg_n;
      const int zg = e - q * zg_n;
      const int b = (q0 + q) / nk;
      const int k = q0 + q - b * nk;
      T* src = acc + (b * ktp + k) * zp + zg * 4;
      T part[kMaxCluster][4];
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) {
        if (c < t.c) ld4(cluster.map_shared_rank(src, c), part[c]);
      }
      T sum[4] = {part[0][0], part[0][1], part[0][2], part[0][3]};
#pragma unroll
      for (int c = 1; c < kMaxCluster; ++c) {
        if (c < t.c) {
#pragma unroll
          for (int q2 = 0; q2 < 4; ++q2) sum[q2] += part[c][q2];
        }
      }
      st4(red + q * zp + zg * 4, sum);
    }
  }
  cluster.sync();  // no block leaves, or reuses acc, while a peer reads it

  // stage 3: out[v, b, k, K] = sum_z red[q][z] azT[z][K], 4 rows x 4 K a
  // thread, 4 z at a time (red broadcast across the warp, azT on
  // neighbouring lanes); analysis_z staged transposed in chunks of ZC of
  // its rows K, z padded with zeros
  for (int K0 = 0; K0 < Z; K0 += t.zc) {
    const int nzc = min_of(t.zc, Z - K0);
    if (K0 > 0) {
      __syncthreads();  // the previous chunk is read
      stage_az(K0);
    }
    cp_async_wait_all();
    __syncthreads();
    const int Kg_n = cdiv(nzc, 4);
    const int n_items = cdiv(nq, 4) * Kg_n;
    for (int it = tid; it < n_items; it += NT) {
      const int qg = it / Kg_n;
      const int Kg = it - qg * Kg_n;
      const T* rp = red + qg * 4 * zp;
      const T* ap = azs + Kg * 4;
      T s[4][4] = {};
      for (int z = 0; z < zp; z += 4) {
        T cr[4][4], ar[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ld4(rp + i * zp + z, cr[i]);
#pragma unroll
        for (int w = 0; w < 4; ++w) ld4(ap + (z + w) * kcp, ar[w]);
        if constexpr (C) {
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            T al[4];
            ld4(ap + az_lo + (z + w) * kcp, al);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              T xh, xl;
              split_bf16(cr[i][w], xh, xl);
#pragma unroll
              for (int q = 0; q < 4; ++q) s[i][q] = fma3(ar[w][q], al[q], xh, xl, s[i][q]);
            }
          }
        } else {
#pragma unroll
          for (int w = 0; w < 4; ++w) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int q = 0; q < 4; ++q) s[i][q] = fma_t(cr[i][w], ar[w][q], s[i][q]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = qg * 4 + i;
        if (q >= nq) break;
        const int b = (q0 + q) / nk;
        const int k = q0 + q - b * nk;
        T* o = out + ((static_cast<size_t>(v) * B + b0 + b) * L + k0 + k) * Z + K0;
#pragma unroll
        for (int q2 = 0; q2 < 4; ++q2) {
          if (Kg * 4 + q2 < nzc) o[Kg * 4 + q2] = s[i][q2];
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, found through the runtime (no link to it)
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// x as a [V * R][L][Z] tensor, in boxes of {Z, LC, RC}
template <typename T>
int encode_x_map(CUtensorMap* map, const T* x, int V, int R, int L, int Z, const Tiles& t) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoTensorMap;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Z), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(V) * R};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Z) * sizeof(T),
                                 static_cast<cuuint64_t>(L) * Z * sizeof(T)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(Z), static_cast<cuuint32_t>(t.lc),
                             static_cast<cuuint32_t>(t.rc)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
      3, const_cast<T*>(x), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kNoTensorMap;
}

template <typename T, int NT, bool C>
int launch(const T* x, const T* la, const T* mask, const T* an, const T* az,
           T* out, int V, int R, int L, int Z, int B, const Tiles& t, int smem,
           void* stream) {
  if (V < 1 || V > 65535 || R < 1 || B < 1 || L < 1 || L > kMaxNl || Z < 1 ||
      Z > kMaxNz) {
    return kBadShape;
  }
  const int per_r = up4(t.kt) / 4 * (up4(Z) / 4);  // lambda tiles a row
  if (t.kt < 1 || t.kt > min_of(L, kMaxKt) || t.bt < 1 || t.bt > B ||
      t.c < 1 || t.c > kMaxCluster || t.c > R || t.rc < 1 || t.rc > kMaxRc ||
      t.rc * per_r > NT - 32 || t.lc < 1 || t.lc > min_of(L, 256) || t.zc < 1 || t.zc > Z ||
      t.st < 2 || t.st > kMaxSt) {
    return kBadTile;
  }
  const Layout lay(Z, t, static_cast<int>(sizeof(T)), C ? 2 : 1);
  if (static_cast<size_t>(smem) !=
          kBarBytes + static_cast<size_t>(lay.total) * sizeof(T) ||
      static_cast<size_t>(smem) > kMaxSmem) {
    return kBadSmem;
  }
  const int n_kt = cdiv(L, t.kt);
  const int n_bt = cdiv(B, t.bt);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = t.c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(t.c, n_kt * n_bt, V);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // checked once for each (shared memory, cluster size) a process launches
  static int smem_set = 48 * 1024;
  static int checked_smem = -1, checked_c = -1;
  if (smem != checked_smem || t.c != checked_c) {
    if (smem > smem_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          rlz_analysis_kernel<T, NT, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      smem_set = smem;
    }
    int clusters = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveClusters(&clusters, rlz_analysis_kernel<T, NT, C>, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (clusters < 1) return kNoCluster;
    checked_smem = smem;
    checked_c = t.c;
  }
  // x by the copy engine where its rows are whole 16-byte units (z not
  // padded), else element by element
  CUtensorMap xmap = {};
  const bool xtma = reinterpret_cast<std::uintptr_t>(x) % 16 == 0 && Z % 4 == 0 &&
                    (static_cast<size_t>(Z) * sizeof(T)) % 16 == 0;
  if (xtma) {
    const int err = encode_x_map(&xmap, x, V, R, L, Z, t);
    if (err != 0) return err;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, rlz_analysis_kernel<T, NT, C>, x,
                                           la, mask, an, az, out, R, L, Z, B,
                                           t, n_kt, xmap, xtma);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool C = false>
int dispatch(const T* x, const T* la, const T* mask, const T* an, const T* az,
             T* out, int V, int R, int L, int Z, int B, const Tiles& t,
             int threads, int smem, void* stream) {
  switch (threads) {
    case 256:
      return launch<T, 256, C>(x, la, mask, an, az, out, V, R, L, Z, B, t, smem, stream);
    case 512:
      return launch<T, 512, C>(x, la, mask, an, az, out, V, R, L, Z, B, t, smem, stream);
    default:
      return kBadTile;
  }
}

}  // namespace

extern "C" {

int scythe_rlz_analysis_max_nz() { return kMaxNz; }

int scythe_rlz_analysis_max_nl() { return kMaxNl; }

// the plan of ops/rlz_analysis.py: tiles KT, BT, C, RC, LC, ZC, ring
// slots, threads a block and shared memory a block in bytes; returns 0, a
// CUDA error, or a refusal of the plan (< 0)
int scythe_rlz_analysis_f32(const float* x, const float* la,
                            const float* mask, const float* an,
                            const float* az, float* out, int V, int R, int L,
                            int Z, int B, int kt, int bt, int c, int rc,
                            int lc, int zc, int st, int threads, int smem,
                            void* stream) {
  return dispatch<float>(x, la, mask, an, az, out, V, R, L, Z, B,
                         Tiles{kt, bt, c, rc, lc, zc, st}, threads, smem, stream);
}

// the comp mode: la [2][L][L], an [2][V][B][R], az [2][V][Z][Z], each its
// bf16 hi part then its lo part
int scythe_rlz_analysis_comp(const float* x, const float* la,
                             const float* mask, const float* an,
                             const float* az, float* out, int V, int R, int L,
                             int Z, int B, int kt, int bt, int c, int rc,
                             int lc, int zc, int st, int threads, int smem,
                             void* stream) {
  return dispatch<float, true>(x, la, mask, an, az, out, V, R, L, Z, B,
                               Tiles{kt, bt, c, rc, lc, zc, st}, threads, smem, stream);
}

int scythe_rlz_analysis_f64(const double* x, const double* la,
                            const double* mask, const double* an,
                            const double* az, double* out, int V, int R,
                            int L, int Z, int B, int kt, int bt, int c, int rc,
                            int lc, int zc, int st, int threads, int smem,
                            void* stream) {
  return dispatch<double>(x, la, mask, an, az, out, V, R, L, Z, B,
                          Tiles{kt, bt, c, rc, lc, zc, st}, threads, smem, stream);
}

}  // extern "C"
