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
// The comp mode (f32, a body of its own: rlz_analysis_comp_kernel; see
// "Comp body" below) is the TPU kernel's own arithmetic, for a compensated
// grid, on Hopper's bf16 tensor cores: every contraction is mma.sync
// m16n8k16 bf16 with f32 accumulation, three products a pair, O_hi x_hi +
// O_lo x_hi + O_hi x_lo (the lo·lo term dropped).  The operators come as
// the grid's bf16 hi and lo, packed once a grid in fragment order
// (ops/rlz_analysis.py pack_comp_operators); each activation is split where
// the TPU kernel splits it, hi = bf16(v), lo = bf16(v - hi), each rounded
// to nearest even (__float2bfloat16_rn): x, the masked lambda
// coefficients, the reduced radial sums.
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
//  5. No tensor cores in the plain modes.  Their value chain is true FP32
//     or FP64 (no TF32), so an f32 tensor-core route is 3xTF32, which needs
//     its own accuracy gate; DMMA would serve only the f64 parity runs.  So
//     their arithmetic is FFMA/DFMA.  The comp mode's is bf16 by definition
//     and runs on the tensor cores (below).
//
// Padding (plain modes): z rows are padded to Zp = 4*ceil(Z/4), and the k
// and b extents of the tiles to multiples of 4.  Shared memory is zeroed once, copies
// write only real elements, and every contraction runs over real indices
// only, so padding never reaches a stored output.  x goes by the copy
// engine when nz is a multiple of 4 (rows of whole 16-byte units, z not
// padded), else element by element.  The mask is multiplied in, not used
// to skip work, so a NaN in x reaches out where the plain chain puts it.
//
// Comp body (rlz_analysis_comp_kernel).  The same clusters, TMA producer
// warp, rank-ordered DSMEM reduction and plan() as above; 7 or 15 consumer
// warps (8 or 16 warps a block: with 17, registers are allocated as for 20
// and ptxas held the body to 96 a thread, with spills).  Each contraction
// is mma.sync m16n8k16 bf16 (three products a pair) with its operand
// fragments in the order the instruction reads them:
//  1. Lambda: A = x, rows (r, z) by 16 azimuths, read straight from the
//     f32 piece that TMA landed and split in registers as it is read (each
//     value of x once a block; the k-slots of a lane hold azimuths t, t+4,
//     t+8, t+12, and a row of x is ZB = 8 or 24 mod 32 words, so the
//     scalar loads hit distinct banks); B = l_analysis' packed fragments.
//     A warp interleaves up to four m-tiles.  Each l-piece's product is
//     summed on the tensor cores from zero and added into an f32 register
//     sum (round to nearest): nl reaches 2048 and the tensor cores add
//     with truncation.
//  2. The ring mask, then the split: the coefficients go to shared memory
//     as bf16 hi and lo, [r][k][z], for ldmatrix.trans.
//  3. Radial: A = analysis_r's packed fragments, B = the coefficients, K =
//     the r-slice's rows.  Where the slice fits as one chunk the stage runs
//     once and writes its partial sums over the ring of x, which the lambda
//     stage has freed: the accumulator costs no shared memory of its own;
//     else chunks of 16-64 rows add into sums of their own region.
//  4. The cluster's reduction in rank order, split into bf16 hi and lo
//     (ldmatrix); vertical: B = analysis_z's packed fragments, K = nz.
// What bounds it on an H100 (clock64 marks, tools/torch_comp_analysis_check.py
// --profile; PERF.md): not the tensor cores (moist3d's 3.2 GFLOP of bf16
// products take ~3 us of a ~75 us call) but the work around them.  A
// moist3d block (216 blocks, two waves of clusters of 3) spends ~49k cycles
// in its main loop: ~23k in the lambda stage, where splitting x costs ~3
// ALU instructions a value and x is split again for each of the 8 k-tiles
// (x is read and split once per (k-tile, b-tile): the f32 partial sums
// [bt][kt][nz] a block take the shared memory that larger tiles would
// need), ~8k in the radial stage, ~7k in the coefficients' store, ~7k
// waiting for x, ~4k in set-up; then ~13k in the cluster reduction and its
// barriers and ~6k in the vertical stage.  The body it replaced did the
// same arithmetic as three FFMAs a product (0.164 ms at moist3d, 0.641 at
// the RLZ transform shape); this one takes 0.076 and 0.48 there.  The
// plain modes keep their FFMA/DFMA bodies.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

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
// epilogue.
struct Layout {
  int zp, ktp, btp;
  int acc_n, x_n, la_n, an_n, ms_n, a_n, red_n, az_n;
  int x_off, la_off, an_off, ms_off, a_off, red_off, az_off, total;
  __host__ __device__ Layout(int Z, const Tiles& t, int elem_size)
      : zp(up4(Z)), ktp(up4(t.kt)), btp(up4(t.bt)) {
    acc_n = btp * ktp * zp;
    // a piece of x [RC][LC][Zp], each slot 128-byte aligned for the copy
    // engine
    const int align = 128 / elem_size;
    x_n = cdiv(t.rc * t.lc * zp, align) * align;
    la_n = t.lc * ktp;       // l_analysis transposed [LC][KTp]
    an_n = t.rc * btp;       // analysis_r transposed [RC][BTp]
    ms_n = t.rc * ktp;       // ring mask [RC][KTp]
    a_n = t.rc * ktp * zp;   // the chunk's lambda coefficients [RC][KTp][Zp]
    x_off = acc_n;
    la_off = x_off + t.st * x_n;
    an_off = la_off + t.st * la_n;
    ms_off = an_off + 2 * an_n;
    a_off = ms_off + 2 * ms_n;
    const int stage_n = a_off + a_n - acc_n;
    red_n = up4(cdiv(t.bt * t.kt, t.c)) * zp;  // this block's share of rows
    az_n = zp * up4(t.zc);   // analysis_z^T chunk [Zp][ZCp]
    red_off = acc_n;
    az_off = red_off + red_n;
    total = acc_n + max_of(stage_n, red_n + az_n);
  }
};

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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
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

// NT threads: NT - 32 consumers and one producer warp
template <typename T, int NT>
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
  const Layout lay(Z, t, static_cast<int>(sizeof(T)));
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
#pragma unroll
              for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int q = 0; q < 4; ++q) sum[i][q] = fma_t(lr[i], xr[q], sum[i][q]);
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
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int q = 0; q < 4; ++q) c4[i][q] = fma_t(br[i], ar[q], c4[i][q]);
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
  T* azs = sm + lay.az_off;  // [Zp][ZCp]
  const int kcp = up4(t.zc);
  auto stage_az = [&](int K0) {
    for_2d<NT>(min_of(t.zc, Z - K0), zp, [&](int Kr, int z) {
      if (z < Z) {
        cp_async<sizeof(T)>(azs + z * kcp + Kr, azv + static_cast<size_t>(K0 + Kr) * Z + z);
      } else {
        azs[z * kcp + Kr] = T(0);
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
#pragma unroll
        for (int w = 0; w < 4; ++w) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int q = 0; q < 4; ++q) s[i][q] = fma_t(cr[i][w], ar[w][q], s[i][q]);
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

// ---------------------------------------------------------------------------
// The comp mode: bf16x3 on the tensor cores (mma.sync m16n8k16 bf16, f32
// accumulation).  Its own body: the header's "Comp mode" says what it does.

constexpr int kCompMaxRc = 256;  // radial rows a slice (the radial stage's K)
constexpr int kCompMaxRp = 32;  // radial rows a piece of x
constexpr int kCompMaxLc = 64;  // azimuths a piece of x

__host__ __device__ constexpr int up8(int n) { return cdiv(n, 8) * 8; }
__host__ __device__ constexpr int up16(int n) { return cdiv(n, 16) * 16; }
__host__ __device__ constexpr int up128(int n) { return cdiv(n, 128) * 128; }

struct CompTiles {
  int kt, bt, c, rc, rp, lc, st;  // rc: rows a slice; rp: rows a piece of x (it divides rc)
};

// Shared-memory layout in bytes after the mbarriers (ops/rlz_analysis.py
// comp_smem_layout mirrors it), two regions, each used twice, every part on
// 128 bytes:
//  * A: the slice's lambda coefficients [RC][AS] in bf16, hi then lo (a row
//    [KT8][ZA] padded to an odd number of 16-byte units: ldmatrix rows on
//    distinct banks), analysis_r's fragments [mt][ks][hi, lo][32 lanes] and
//    the ring mask [RC][KT8]; then, once the radial stage has read them,
//    the reduced rows [up16(share)][Z16 + 8] in bf16, hi then lo, and
//    analysis_z's fragments [ks][nt][32];
//  * B: the ring of x pieces [RP][LC][ZB] f32 (a row ZB = 8 or 24 mod 32
//    words: the lambda stage's four lanes of a row read distinct banks)
//    with l_analysis' fragments [ks][nt][32];
//  * the block's partial sums [BT][BS] f32 (a row [KT8][ZA] padded to 8 mod
//    32 words), which the cluster's blocks read: over B where the slice is
//    one chunk (the radial stage runs once, after the lambda stage has
//    freed the ring), after it where the slice takes several chunks.
struct CompLayout {
  int za, zb, z16, kt8, bs, as, rz, mtb, share16;
  int acc, x, la, an, ms, a, red, az;  // bytes of one of each
  int an_off, ms_off, red_off, az_off, b_off, x_off, la_off, acc_off, total;
  __host__ __device__ CompLayout(int Z, int R, const CompTiles& t) {
    za = up8(Z);                      // z in the products: 8-wide groups
    zb = za % 16 == 0 ? za + 8 : za;
    z16 = up16(Z);                    // the vertical stage's K
    kt8 = up8(t.kt);
    bs = kt8 * za + (40 - (kt8 * za) % 32) % 32;
    as = kt8 * za + ((kt8 * za / 8) % 2 == 0 ? 8 : 0);
    rz = z16 + 8;
    mtb = cdiv(t.bt, 16);
    share16 = up16(cdiv(t.bt * t.kt, t.c));
    a = up128(2 * t.rc * as * 2);
    an = mtb * (t.rc / 16) * 1024;
    ms = up128(t.rc * kt8 * 4);
    red = up128(2 * share16 * rz * 2);
    az = (z16 / 16) * (za / 8) * 512;
    x = up128(t.rp * t.lc * zb * 4);
    la = cdiv(t.lc, 16) * (kt8 / 8) * 512;
    acc = up128(t.bt * bs * 4);
    an_off = a;
    ms_off = an_off + an;
    red_off = 0;
    az_off = red;
    b_off = max_of(ms_off + ms, red + az);
    x_off = b_off;
    la_off = x_off + t.st * x;
    const bool one_chunk = t.rc >= up16(cdiv(R, t.c));
    acc_off = one_chunk ? b_off : la_off + t.st * la;
    total = one_chunk ? b_off + max_of(t.st * (x + la), acc) : acc_off + acc;
  }
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A B, bf16x3: A's (hi, lo) fragments ah, al, B's {hi b0, hi b1, lo
// b0, lo b1}; lo·hi and hi·lo first, then hi·hi (the lo·lo term dropped)
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint4 b) {
  mma_bf16(c, al, b.x, b.y);
  mma_bf16(c, ah, b.z, b.w);
  mma_bf16(c, ah, b.x, b.y);
}

// the same with B's hi and lo fragments apart (bh, bl: b0, b1 each)
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma_bf16(c, al, bh0, bh1);
  mma_bf16(c, ah, bl0, bl1);
  mma_bf16(c, ah, bh0, bh1);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void split1(float v, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// x / d for 0 <= x < 2^16 by one wide multiply: m = ceil(2^32 / d), d < 2^16
struct FastDiv {
  unsigned long long m;
  __device__ __forceinline__ explicit FastDiv(int d)
      : m((0x100000000ull + static_cast<unsigned>(d) - 1) / static_cast<unsigned>(d)) {}
  __device__ __forceinline__ int operator()(int x) const {
    return static_cast<int>((static_cast<unsigned long long>(x) * m) >> 32);
  }
};

// the lambda stage's A fragment of rows (p0: g, p1: g + 8) over the 16
// azimuths of one k-step, split as it is read.  The k-slots 2t, 2t + 1,
// 2t + 8, 2t + 9 of lane t hold azimuths t, t + 4, t + 8, t + 12 (the
// packing of l_analysis uses the same order), so the four lanes of a row
// read rows of x ZB words apart: distinct banks.  Rows past the chunk's
// real rows and azimuths past the piece read as zero.
__device__ __forceinline__ void lambda_frag(const float* p0, const float* p1, bool ok0,
                                            bool ok1, int l, int nl, int zb4,
                                            uint32_t (&ah)[4], uint32_t (&al)[4]) {
  float v[2][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool in = l + 4 * q < nl;
    v[0][q] = ok0 && in ? p0[q * zb4] : 0.0f;
    v[1][q] = ok1 && in ? p1[q * zb4] : 0.0f;
  }
  split2(v[0][0], v[0][1], ah[0], al[0]);
  split2(v[1][0], v[1][1], ah[1], al[1]);
  split2(v[0][2], v[0][3], ah[2], al[2]);
  split2(v[1][2], v[1][3], ah[3], al[3]);
}

// clock64 marks of the comp kernel's profile, a block's slots: consumer
// warp 0's cycles waiting for x, in lambda products, in the coefficients'
// store (with the operator wait), in the radial stage (with its barriers);
// the block's main loop from its start, the reduction with its cluster
// barriers, the vertical stage; warp 0's set-up before its first piece and
// its wait at the barrier after the coefficients' store
constexpr int kProfWait = 0, kProfLambda = 1, kProfStore = 2, kProfRadial = 3,
              kProfMain = 4, kProfReduce = 5, kProfVertical = 6, kProfSetup = 7,
              kProfSync = 8, kProfSlots = 10;

// NT threads: NT - 32 consumers and one producer warp; NTK: 8-wide
// wavenumber tiles of the lambda stage (KT8 / 8).  la, an, az: the
// operators packed by ops/rlz_analysis.py (pack_comp_operators) in
// fragment order; an and az hold vop variables, variable v reads v % vop.
template <int NT, int NTK>
__global__ void __launch_bounds__(NT, NT < 512 ? 2 : 1)
rlz_analysis_comp_kernel(const float* __restrict__ x, const uint4* __restrict__ la,
                         const float* __restrict__ mask, const uint4* __restrict__ an,
                         const uint4* __restrict__ az, float* __restrict__ out, int R, int L,
                         int Z, int B, int vop, CompTiles t, int n_kt,
                         const __grid_constant__ CUtensorMap xmap, bool xtma,
                         unsigned long long* __restrict__ prof) {
  // prof (null but in tools/torch_comp_analysis_check.py --profile): a
  // block's clock64 marks and consumer warp 0's cycles by phase (kProf*)
  const long long t_start = clock64();
  long long t_wait = 0, t_lambda = 0, t_store = 0, t_radial = 0, t_setup = 0, t_sync = 0;
  long long t_mark = t_start;
  auto lap = [&](long long& into) {
    if (prof != nullptr) {
      const long long now = clock64();
      into += now - t_mark;
      t_mark = now;
    }
  };
  constexpr int kW = (NT - 32) / 32;  // consumer warps
  constexpr int kIpw = 4 / NTK;       // lambda items a consumer warp at most
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);  // [st] a piece landed
  uint64_t* empty = full + kMaxSt;                         // [st] a slot is free
  uint64_t* an_full = empty + kMaxSt;                      // a chunk's operators landed
  uint64_t* an_empty = an_full + 1;                        // their slot is free
  unsigned char* sm = smem_raw + kBarBytes;
  const CompLayout lay(Z, R, t);
  const int za = lay.za, zb = lay.zb, kt8 = lay.kt8, bs = lay.bs, as = lay.as;
  cg::cluster_group cluster = cg::this_cluster();
  const int j = static_cast<int>(cluster.block_rank());  // the r-slice
  const int k0 = (blockIdx.y % n_kt) * t.kt;
  const int b0 = (blockIdx.y / n_kt) * t.bt;
  const int v = blockIdx.z;
  const int vo = v % vop;
  const int nk = min_of(t.kt, L - k0);
  const int nb = min_of(t.bt, B - b0);
  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int warp = tid >> 5;
  // packed extents: l_analysis [L16/16][L8/8], analysis_r [vop][B16/16][R16/16],
  // analysis_z [vop][Z16/16][Z8/8]
  const int la_nt = cdiv(L, 8);
  const int an_mt = cdiv(B, 16), an_ks = cdiv(R, 16);
  __nv_bfloat16* a_h = reinterpret_cast<__nv_bfloat16*>(sm);  // [RC][AS]
  __nv_bfloat16* a_l = a_h + t.rc * as;
  float* acc = reinterpret_cast<float*>(sm + lay.acc_off);  // [BT][BS]

  {
    // zeros where copies leave padding that is read: the mask's rows and
    // wavenumbers past the chunk's, l_analysis' wavenumber tiles past nl,
    // and x's rows past Z where it is copied element by element (the copy
    // engine fills them)
    const auto zero = [&](int off, int bytes) {
      uint4* p = reinterpret_cast<uint4*>(sm + off);
      for (int e = tid; e < bytes / 16; e += NT) p[e] = make_uint4(0, 0, 0, 0);
    };
    zero(lay.ms_off, lay.ms);
    zero(lay.la_off, t.st * lay.la);
    if (!xtma) zero(lay.x_off, t.st * lay.x);
  }
  if (tid == 0) {
    for (int s = 0; s < t.st; ++s) {
      mbar_init(&full[s], 33);  // the producer's 32 lanes + its byte count
      mbar_init(&empty[s], kW);
    }
    mbar_init(an_full, 32);
    mbar_init(an_empty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // the r-slice (a multiple of 16 rows: analysis_r is packed in 16-row
  // k-steps), in chunks of RC rows
  const int rs = up16(cdiv(R, t.c));
  const int r_lo = min_of(R, j * rs);
  const int r_hi = min_of(R, r_lo + rs);
  const int n_rc = cdiv(r_hi - r_lo, t.rc);
  const int n_lc = cdiv(L, t.lc);
  const int n_pass = t.rc / t.rp;

  if (tid >= NT - 32) {
    // producer: chunk by chunk, its analysis_r fragments and mask rows
    // first (once the radial stage is done with the last chunk's), then
    // piece p = (pass of RP rows, l-chunk) into slot p % st
    const int pl = tid - (NT - 32);
    int s = 0;
    unsigned ph = 0;
    for (int ci = 0, p = 0; ci < n_rc; ++ci) {
      const int r0 = r_lo + ci * t.rc;
      const int nr = min_of(t.rc, r_hi - r0);
      if (ci > 0) mbar_wait(an_empty, (ci - 1) & 1);
      uint4* ans = reinterpret_cast<uint4*>(sm + lay.an_off);
      const int nks = cdiv(nr, 16);
      const int per_mt = nks * 64;  // 16-byte units of one m-tile's k-steps
      for (int e = pl; e < lay.mtb * per_mt; e += 32) {
        const int m = e / per_mt;
        const int q = e - m * per_mt;  // (ks, part, lane)
        if ((b0 >> 4) + m < an_mt) {
          cp_async<16>(ans + m * (t.rc / 16) * 64 + q,
                       an + ((static_cast<size_t>(vo) * an_mt + (b0 >> 4) + m) * an_ks +
                             (r0 >> 4)) * 64 + q);
        }
      }
      float* mss = reinterpret_cast<float*>(sm + lay.ms_off);
      for (int e = pl; e < nr * nk; e += 32) {
        const int rr = e / nk;
        const int k = e - rr * nk;
        cp_async<4>(mss + rr * kt8 + k, mask + static_cast<size_t>(r0 + rr) * L + k0 + k);
      }
      mbar_arrive_cp_async(an_full);
      for (int pi = 0; pi < n_pass; ++pi) {
        const int pr0 = r0 + pi * t.rp;
        for (int li = 0; li < n_lc; ++li, ++p) {
          const int l0 = li * t.lc;
          const int nl = min_of(t.lc, L - l0);
          if (p >= t.st) mbar_wait(&empty[s], ph ^ 1);
          float* xs = reinterpret_cast<float*>(sm + lay.x_off + s * lay.x);
          if (xtma) {
            // the whole box lands and counts: z past Z zero-filled (the row
            // padding to ZB), rows and azimuths past the piece guarded
            if (pl == 0) {
              mbar_arrive_expect_tx(&full[s], t.rp * t.lc * zb * 4u);
              tensor_copy(xs, &xmap, l0, v * R + pr0, &full[s]);
            }
          } else {
            if (pl == 0) mbar_arrive(&full[s]);
            const int nrr = min_of(t.rp, r0 + nr - pr0);
            const int nlz = nl * Z;
            const float* xr = x + (static_cast<size_t>(v) * R + pr0) * L * Z +
                              static_cast<size_t>(l0) * Z;
            for (int e = pl; e < nrr * nlz; e += 32) {
              const int rr = e / nlz;
              const int q = e - rr * nlz;
              const int ll = q / Z;
              cp_async<4>(xs + (rr * t.lc + ll) * zb + q - ll * Z,
                          xr + static_cast<size_t>(rr) * L * Z + q);
            }
          }
          uint4* las = reinterpret_cast<uint4*>(sm + lay.la_off + s * lay.la);
          const int nnt = min_of(kt8 / 8, la_nt - (k0 >> 3));
          const int nks_l = cdiv(nl, 16);
          for (int e = pl; e < nks_l * nnt * 32; e += 32) {
            const int ks = e / (nnt * 32);
            const int q = e - ks * nnt * 32;  // (nt, lane)
            cp_async<16>(las + ks * NTK * 32 + q,
                         la + (static_cast<size_t>((l0 >> 4) + ks) * la_nt + (k0 >> 3)) * 32 +
                             q);
          }
          mbar_arrive_cp_async(&full[s]);
          if (++s == t.st) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    const int gpr = za / 8;                // 8-wide z groups a row
    const FastDiv div_gpr(gpr);
    const int n_m1 = t.rp * gpr / 2;       // lambda m-tiles a piece
    const int n_nt = kt8 * gpr;            // radial n-tiles over (k, z group)
    const int n_np = cdiv(n_nt, 2);
    const FastDiv div_np(n_np);
    const int n_mg = cdiv(lay.mtb, 4);
    const int n_it = cdiv(n_m1 - warp, kW);  // lambda items of this warp
    lap(t_setup);
    const float* mss = reinterpret_cast<const float*>(sm + lay.ms_off);
    int sl = 0;       // the ring slot of the next piece
    unsigned ph = 0;  // its barrier phase
    for (int ci = 0; ci < n_rc; ++ci) {
      const int nr = min_of(t.rc, r_hi - r_lo - ci * t.rc);
      for (int pi = 0; pi < n_pass; ++pi) {
        // stage 1: a[(r, z)][k] = sum_l x[r][l][z] laT[l][k]; an item is one
        // m-tile (two 8-wide z groups of the pass' rows) by all KT8
        // wavenumbers, a warp's items interleaved; each l-piece's product is
        // summed apart on the tensor cores, then added in f32 round to nearest
        const int rows_ok = nr - pi * t.rp;
        // this warp's items: x offsets of rows g, g + 8 at the lane's first
        // azimuth, and whether they are real rows
        int off[kIpw][2];
        bool ok[kIpw][2];
#pragma unroll
        for (int it = 0; it < kIpw; ++it) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gi = 2 * (warp + it * kW) + h;
            const int rr = div_gpr(gi);
            off[it][h] = (rr * t.lc + tq) * zb + (gi - rr * gpr) * 8 + g;
            ok[it][h] = rr < rows_ok;
          }
        }
        float s[kIpw][NTK][4] = {};
        for (int li = 0; li < n_lc; ++li) {
          const int nl = min_of(t.lc, L - li * t.lc);
          const int nks = cdiv(nl, 16);
          lap(t_store);
          mbar_wait(&full[sl], ph);
          lap(t_wait);
          const float* xs = reinterpret_cast<const float*>(sm + lay.x_off + sl * lay.x);
          const uint4* las = reinterpret_cast<const uint4*>(sm + lay.la_off + sl * lay.la);
          float c[kIpw][NTK][4] = {};
          for (int ks = 0; ks < nks; ++ks) {
            uint4 b[NTK];
#pragma unroll
            for (int nt = 0; nt < NTK; ++nt) b[nt] = las[(ks * NTK + nt) * 32 + lane];
#pragma unroll
            for (int it = 0; it < kIpw; ++it) {
              if (it < n_it) {
                uint32_t ah[4], al[4];
                const int k16 = ks * 16 * zb;
                lambda_frag(xs + off[it][0] + k16, xs + off[it][1] + k16, ok[it][0], ok[it][1],
                            ks * 16 + tq, nl, 4 * zb, ah, al);
#pragma unroll
                for (int nt = 0; nt < NTK; ++nt) mma3(c[it][nt], ah, al, b[nt]);
              }
            }
          }
#pragma unroll
          for (int it = 0; it < kIpw; ++it) {
#pragma unroll
            for (int nt = 0; nt < NTK; ++nt) {
#pragma unroll
              for (int i = 0; i < 4; ++i) s[it][nt][i] += c[it][nt][i];
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[sl]);
          if (++sl == t.st) {
            sl = 0;
            ph ^= 1;
          }
          lap(t_lambda);
        }
        if (pi == 0) mbar_wait(an_full, ci & 1);
        // the ring mask, then the split as the radial stage reads it: a
        // [r][k][z], hi and lo.  Every mask value is read before the first
        // store (the compiler cannot tell the two apart in shared memory and
        // would otherwise order each load after the store before it).
        float m[kIpw][2][NTK][2];
        int ao[kIpw][2];
#pragma unroll
        for (int it = 0; it < kIpw; ++it) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gi = 2 * (warp + it * kW) + h;
            const int rq = div_gpr(gi);
            const int rr = pi * t.rp + rq;
            ao[it][h] = rr * as + (gi - rq * gpr) * 8 + g;
#pragma unroll
            for (int nt = 0; nt < NTK; ++nt) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                m[it][h][nt][e] = it < n_it ? mss[rr * kt8 + nt * 8 + 2 * tq + e] : 0.0f;
              }
            }
          }
        }
#pragma unroll
        for (int it = 0; it < kIpw; ++it) {
          if (it < n_it) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int nt = 0; nt < NTK; ++nt) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int k = nt * 8 + 2 * tq + e;
                  __nv_bfloat16 hi, lo;
                  split1(s[it][nt][2 * h + e] * m[it][h][nt][e], hi, lo);
                  a_h[ao[it][h] + k * za] = hi;
                  a_l[ao[it][h] + k * za] = lo;
                }
              }
            }
          }
        }
      }
      lap(t_store);
      consumer_sync<NT - 32>();  // the chunk's a is complete (one chunk: the ring is free)
      lap(t_sync);

      // stage 2: acc[b][(k, z)] (+)= sum_r an[b][r] a[r][(k, z)] over the
      // chunk's rows; an item is up to four 16-row b tiles by two n-tiles of
      // (k, z), its products summed on the tensor cores, then stored (the
      // first chunk) or added into acc in f32
      const uint4* ans = reinterpret_cast<const uint4*>(sm + lay.an_off);
      const int nks2 = cdiv(nr, 16);
      const int rstep = t.rc / 16;
      for (int item = warp; item < n_mg * n_np; item += kW) {
        const int mg = div_np(item);
        const int np = item - mg * n_np;
        // this lane's ldmatrix row: matrix lane / 8 = (k half, n-tile)
        const int nt_l = min_of(2 * np + (lane >> 4), n_nt - 1);
        const int kk = div_gpr(nt_l);
        const int col = kk * za + (nt_l - kk * gpr) * 8;
        const int row = ((lane >> 3) & 1) * 8 + (lane & 7);
        const __nv_bfloat16* bh_p = a_h + row * as + col;
        const __nv_bfloat16* bl_p = a_l + row * as + col;
        float c[4][2][4] = {};
        for (int ks = 0; ks < nks2; ++ks) {
          uint32_t bh[4], bl[4];
          ldsm_x4_trans(bh, bh_p + ks * 16 * as);
          ldsm_x4_trans(bl, bl_p + ks * 16 * as);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int mt = mg * 4 + m;
            if (mt < lay.mtb) {
              const uint4* ap = ans + (mt * rstep + ks) * 64 + lane;
              const uint4 hi = ap[0], lo = ap[32];
              const uint32_t aH[4] = {hi.x, hi.y, hi.z, hi.w};
              const uint32_t aL[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
              for (int jn = 0; jn < 2; ++jn) {
                mma3(c[m][jn], aH, aL, bh[2 * jn], bh[2 * jn + 1], bl[2 * jn], bl[2 * jn + 1]);
              }
            }
          }
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int mt = mg * 4 + m;
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) {
            const int nt = 2 * np + jn;
            if (mt >= lay.mtb || nt >= n_nt) continue;
            const int k = div_gpr(nt);
            const int z = (nt - k * gpr) * 8 + 2 * tq;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int b = mt * 16 + g + 8 * h;
              if (b < nb) {
                float2* pa = reinterpret_cast<float2*>(acc + b * bs + k * za + z);
                float2 sum = make_float2(c[m][jn][2 * h], c[m][jn][2 * h + 1]);
                if (ci > 0) {
                  const float2 prev = *pa;
                  sum.x += prev.x;
                  sum.y += prev.y;
                }
                *pa = sum;
              }
            }
          }
        }
      }
      if (n_rc > 1) {
        consumer_sync<NT - 32>();  // a and the operator slot are free
        if (tid == 0) mbar_arrive(an_empty);
      }
      lap(t_radial);
    }
  }
  __syncthreads();

  const long long t_main = clock64();
  // analysis_z's fragments for this variable, over the staging region, in
  // flight through the cluster's reduction
  uint4* azs = reinterpret_cast<uint4*>(sm + lay.az_off);
  const int n_nt3 = za / 8, n_ks3 = lay.z16 / 16;
  {
    const uint4* azv = az + static_cast<size_t>(vo) * n_ks3 * n_nt3 * 32;
    for (int e = tid; e < n_ks3 * n_nt3 * 32; e += NT) cp_async<16>(azs + e, azv + e);
  }

  // every partial is complete; block j reduces its share of the (b, k)
  // rows over the cluster's partials, in rank order, and splits them as
  // the vertical stage reads them
  cluster.sync();
  const int share = cdiv(t.bt * t.kt, t.c);
  const int q0 = min_of(nb * nk, j * share);
  const int nq = min_of(nb * nk, q0 + share) - q0;
  const int rz = lay.rz;
  __nv_bfloat16* red_h = reinterpret_cast<__nv_bfloat16*>(sm + lay.red_off);  // [SH16][RZ]
  __nv_bfloat16* red_l = red_h + lay.share16 * rz;
  const FastDiv div_nk(nk);
  {
    const int zg_n = lay.z16 / 8;
    const FastDiv div_zg(zg_n);
    for (int e = tid; e < lay.share16 * zg_n; e += NT) {
      const int q = div_zg(e);
      const int zg = e - q * zg_n;
      float sum[8] = {};
      if (q < nq && zg * 8 < za) {
        const int b = div_nk(q0 + q);
        const int k = q0 + q - b * nk;
        float* src = acc + b * bs + k * za + zg * 8;
        float4 part[kMaxCluster][2];  // every peer's loads in flight at once
#pragma unroll
        for (int c = 0; c < kMaxCluster; ++c) {
          if (c < t.c) {
            const float4* pc = reinterpret_cast<const float4*>(cluster.map_shared_rank(src, c));
            part[c][0] = pc[0];
            part[c][1] = pc[1];
          }
        }
#pragma unroll
        for (int c = 0; c < kMaxCluster; ++c) {  // rank order
          if (c < t.c) {
            sum[0] += part[c][0].x;
            sum[1] += part[c][0].y;
            sum[2] += part[c][0].z;
            sum[3] += part[c][0].w;
            sum[4] += part[c][1].x;
            sum[5] += part[c][1].y;
            sum[6] += part[c][1].z;
            sum[7] += part[c][1].w;
          }
        }
      }
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split2(sum[2 * i], sum[2 * i + 1], hi[i], lo[i]);
      *reinterpret_cast<uint4*>(red_h + q * rz + zg * 8) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(red_l + q * rz + zg * 8) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
  cp_async_wait_all();
  cluster.sync();  // no block leaves, or reuses acc, while a peer reads it
  const long long t_reduced = clock64();

  // stage 3: out[v, b, k, K] = sum_z red[q][z] az[K][z]; an item is a
  // 16-row tile of the share by up to four 8-wide K tiles, every warp
  const int n_ng3 = cdiv(n_nt3, 4);
  const FastDiv div_ng3(n_ng3);
  const int n_mt3 = cdiv(nq, 16);
  for (int item = warp; item < n_mt3 * n_ng3; item += NT / 32) {
    const int mt = div_ng3(item);
    const int ng = item - mt * n_ng3;
    const int row = mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
    const __nv_bfloat16* ph = red_h + row * rz + (lane >> 4) * 8;
    const __nv_bfloat16* pl = red_l + row * rz + (lane >> 4) * 8;
    float c[4][4] = {};
    for (int ks = 0; ks < n_ks3; ++ks) {
      uint32_t ah[4], al[4];
      ldsm_x4(ah, ph + ks * 16);
      ldsm_x4(al, pl + ks * 16);
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int nt = ng * 4 + jn;
        if (nt < n_nt3) mma3(c[jn], ah, al, azs[(ks * n_nt3 + nt) * 32 + lane]);
      }
    }
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int K = (ng * 4 + jn) * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = mt * 16 + g + 8 * h;
        if (q >= nq) continue;
        const int b = div_nk(q0 + q);
        const int k = q0 + q - b * nk;
        float* o = out + ((static_cast<size_t>(v) * B + b0 + b) * L + k0 + k) * Z;
        if (K < Z) o[K] = c[jn][2 * h];
        if (K + 1 < Z) o[K + 1] = c[jn][2 * h + 1];
      }
    }
  }
  if (prof != nullptr) {
    __syncthreads();
    if (tid == 0) {
      unsigned long long* pb =
          prof + kProfSlots * (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z));
      pb[kProfWait] = t_wait;
      pb[kProfLambda] = t_lambda;
      pb[kProfStore] = t_store;
      pb[kProfRadial] = t_radial;
      pb[kProfMain] = t_main - t_start;
      pb[kProfReduce] = t_reduced - t_main;
      pb[kProfVertical] = clock64() - t_reduced;
      pb[kProfSetup] = t_setup;
      pb[kProfSync] = t_sync;
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

// x as a [V * R][L][Z] tensor, in boxes of {bz, bl, br}; a box past Z
// (the comp mode's row padding) lands zeros there
template <typename T>
int encode_x_map(CUtensorMap* map, const T* x, int V, int R, int L, int Z, int bz, int bl,
                 int br) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoTensorMap;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Z), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(V) * R};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Z) * sizeof(T),
                                 static_cast<cuuint64_t>(L) * Z * sizeof(T)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(bz), static_cast<cuuint32_t>(bl),
                             static_cast<cuuint32_t>(br)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
      3, const_cast<T*>(x), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kNoTensorMap;
}

// a cluster launch of kernel with the plan's shared memory; the kernel's
// shared-memory limit and the cluster's fit are checked once for each
// (shared memory, cluster size) a process launches it with
template <typename K, typename... A>
int launch_clusters(K kernel, dim3 grid, int threads, int c, int smem, void* stream,
                    int& smem_set, int& checked_smem, int& checked_c, A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (smem != checked_smem || c != checked_c) {
    if (smem > smem_set) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      smem_set = smem;
    }
    int clusters = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (clusters < 1) return kNoCluster;
    checked_smem = smem;
    checked_c = c;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NT>
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
  const Layout lay(Z, t, static_cast<int>(sizeof(T)));
  if (static_cast<size_t>(smem) !=
          kBarBytes + static_cast<size_t>(lay.total) * sizeof(T) ||
      static_cast<size_t>(smem) > kMaxSmem) {
    return kBadSmem;
  }
  const int n_kt = cdiv(L, t.kt);
  // x by the copy engine where its rows are whole 16-byte units (z not
  // padded), else element by element
  CUtensorMap xmap = {};
  const bool xtma = reinterpret_cast<std::uintptr_t>(x) % 16 == 0 && Z % 4 == 0 &&
                    (static_cast<size_t>(Z) * sizeof(T)) % 16 == 0;
  if (xtma) {
    const int err = encode_x_map(&xmap, x, V, R, L, Z, Z, t.lc, t.rc);
    if (err != 0) return err;
  }
  static int smem_set = 48 * 1024, checked_smem = -1, checked_c = -1;
  return launch_clusters(rlz_analysis_kernel<T, NT>, dim3(t.c, n_kt * cdiv(B, t.bt), V), NT,
                         t.c, smem, stream, smem_set, checked_smem, checked_c, x, la, mask,
                         an, az, out, R, L, Z, B, t, n_kt, xmap, xtma);
}

template <typename T>
int dispatch(const T* x, const T* la, const T* mask, const T* an, const T* az,
             T* out, int V, int R, int L, int Z, int B, const Tiles& t,
             int threads, int smem, void* stream) {
  switch (threads) {
    case 256:
      return launch<T, 256>(x, la, mask, an, az, out, V, R, L, Z, B, t, smem, stream);
    case 512:
      return launch<T, 512>(x, la, mask, an, az, out, V, R, L, Z, B, t, smem, stream);
    default:
      return kBadTile;
  }
}

template <int NT, int NTK>
int launch_comp(const float* x, const uint4* la, const float* mask, const uint4* an,
                const uint4* az, float* out, int V, int R, int L, int Z, int B, int vop,
                const CompTiles& t, int smem, void* stream, void* prof) {
  const CompLayout lay(Z, R, t);
  const int w = (NT - 32) / 32;
  if (t.kt < 1 || t.kt > min_of(L, kMaxKt) || (t.kt % 8 != 0 && t.kt != L) || t.bt < 1 ||
      t.bt > B || (t.bt % 16 != 0 && t.bt != B) || t.c < 1 || t.c > kMaxCluster ||
      t.c > R || t.rc < 16 || t.rc % 16 != 0 || t.rc > kCompMaxRc || t.rp < 2 ||
      t.rp % 2 != 0 || t.rp > kCompMaxRp || t.rc % t.rp != 0 || t.lc < 1 ||
      t.lc > min_of(L, kCompMaxLc) || (t.lc % 16 != 0 && t.lc != L) || t.st < 2 ||
      t.st > kMaxSt || t.rp * (lay.za / 8) / 2 > w * (4 / NTK)) {
    return kBadTile;
  }
  if (static_cast<size_t>(smem) != kBarBytes + static_cast<size_t>(lay.total) ||
      static_cast<size_t>(smem) > kMaxSmem) {
    return kBadSmem;
  }
  const int n_kt = cdiv(L, t.kt);
  // x by the copy engine in boxes {ZB, LC, RP} where its rows are whole
  // 16-byte units, else element by element into the same layout
  CUtensorMap xmap = {};
  const bool xtma = reinterpret_cast<std::uintptr_t>(x) % 16 == 0 && Z % 4 == 0;
  if (xtma) {
    const int err = encode_x_map(&xmap, x, V, R, L, Z, lay.zb, t.lc, t.rp);
    if (err != 0) return err;
  }
  static int smem_set = 48 * 1024, checked_smem = -1, checked_c = -1;
  return launch_clusters(rlz_analysis_comp_kernel<NT, NTK>,
                         dim3(t.c, n_kt * cdiv(B, t.bt), V), NT, t.c, smem, stream, smem_set,
                         checked_smem, checked_c, x, la, mask, an, az, out, R, L, Z, B, vop,
                         t, n_kt, xmap, xtma, static_cast<unsigned long long*>(prof));
}

int dispatch_comp(const float* x, const uint4* la, const float* mask, const uint4* an,
                  const uint4* az, float* out, int V, int R, int L, int Z, int B, int vop,
                  const CompTiles& t, int threads, int smem, void* stream, void* prof) {
  if (V < 1 || V > 65535 || R < 1 || B < 1 || L < 1 || L > kMaxNl || Z < 1 ||
      Z > kMaxNz || vop < 1 || V % vop != 0) {
    return kBadShape;
  }
  const bool two = up8(t.kt) == 16;
  switch (threads) {
    case 256:
      return two ? launch_comp<256, 2>(x, la, mask, an, az, out, V, R, L, Z, B, vop, t, smem,
                                       stream, prof)
                 : launch_comp<256, 1>(x, la, mask, an, az, out, V, R, L, Z, B, vop, t, smem,
                                       stream, prof);
    case 512:
      return two ? launch_comp<512, 2>(x, la, mask, an, az, out, V, R, L, Z, B, vop, t, smem,
                                       stream, prof)
                 : launch_comp<512, 1>(x, la, mask, an, az, out, V, R, L, Z, B, vop, t, smem,
                                       stream, prof);
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

// the comp mode: la, an, az packed by ops/rlz_analysis.py
// (pack_comp_operators), an and az for vop variables (variable v reads v %
// vop); the comp plan's tiles KT, BT, C, RC, RP, LC, ring slots, threads
// and shared memory
int scythe_rlz_analysis_comp(const float* x, const void* la, const float* mask,
                             const void* an, const void* az, float* out, int V, int R,
                             int L, int Z, int B, int vop, int kt, int bt, int c, int rc,
                             int rp, int lc, int st, int threads, int smem, void* stream,
                             void* prof) {
  return dispatch_comp(x, static_cast<const uint4*>(la), mask, static_cast<const uint4*>(an),
                       static_cast<const uint4*>(az), out, V, R, L, Z, B, vop,
                       CompTiles{kt, bt, c, rc, rp, lc, st}, threads, smem, stream, prof);
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
