// AI2* vertical column solve for Hopper (sm_90a): one composed operator
// applied on the tensor cores.
//
// Replaces the Pallas TPU kernel scythe_tpu/ops/pallas_semiimplicit.py
// (fused_column_solve, kernels _kernel and _kernel_comp).  That kernel runs
// the corrector's chain over a batch of columns [ncols, nz] (z contiguous):
//
//     xf = F x*;  g = ts' Pxi Dz x* - w*;  g <- [0, 0, g[1], ..., g[nz-2]]
//     a  = Hinv g;  w = S a;  xi = xf - ts' Ds a
//
// Every stage, the BC shift included, is linear in (x*, w*), so the chain is
// one [2nz, 2nz] matrix M for each (ts', Hinv) pair, composed once in
// float64 on the host (ops/column_solve.py compose_column_operator), and this
// kernel computes
//
//     [w | xi] = [x* | w*] M^T
//
// reading the two K halves from x* and w* and writing the two N halves to w
// and xi: nothing is concatenated in device memory.
//
// What bounds it.  At the moist3d shape (9216 columns, nz 48, f32) a call
// reads x* and w* and writes w and xi, 4 x 9216 x 48 x 4 B = 7.08 MB, and
// reads M, 37 KB: 2.12 us at 3.35 TB/s.  The product is 2 x 9216 x 96^2 =
// 170 MFLOP: 1.03 us at the card's f32-accurate tensor-core rate (3xTF32, a
// third of its 495 TFLOP/s dense TF32), so HBM binds: 2.12 us.  At the TC
// shape (1200 x 24) the bound is 0.14 us, also HBM; there launch and
// latency rule.  What bounds this kernel in practice
// (tools/torch_column_solve_ablation.py on an H100, PERF.md):
// the compensated product is three TF32 tensor-core products, ~2 us of the
// moist3d call at about half the card's dense TF32 rate through mma.sync,
// and the copies and stores (~3 us with the launch, near their HBM floor)
// overlap them little.
//
// What the first design (16 columns a block, five operators in turn) did
// wrong, and what this one does instead:
//  1. Every block staged all five operators from L2, one at a time (~26 MB
//     of L2 traffic a call against 7 MB of HBM).  Here the blocks are
//     persistent, at most one or two an SM, and each stages the one composed
//     operator once, by one bulk copy of the copy engine (TMA); the row
//     groups of warps of a block share it.
//  2. The staging was a transposing copy whose stores hit 2 of the 32 banks.
//     Here M arrives already in the order the tensor-core fragments read it
//     (pack_operator in ops/column_solve.py), so each operand read is one
//     conflict-free 16-byte load a lane.  The column tiles are padded to a
//     row stride S = K + 4 (S = 4 mod 8), so the A-fragment loads are
//     conflict-free too.
//  3. Ten __syncthreads a block.  Here a row group of warps meets one named
//     barrier a column tile: tiles go through its ring of ST slots by
//     cp.async, each slot's landing counted on an mbarrier, the next tiles'
//     loads in flight while this one is multiplied.
//  4. Five shared loads per four FMAs.  Here, per 8-deep K step, a warp
//     loads its A fragment (4 words a lane) once and one 16-byte B fragment
//     for each of its two 8-wide output tiles, and issues six tensor-core
//     products of 16 x 8 x 8.
//
// f32 is compensated 3xTF32: a = hi + lo with hi = tf32(a), lo = tf32(a -
// hi) (round to nearest, ties away, as cvt.rna; the low 13 mantissa bits
// cleared), likewise for M (split once, in pack_operator); lo(a) hi(b) and
// hi(a) lo(b) go to accumulators of their own, and hi(a) hi(b) is summed
// two K steps at a time and added in f32 (the tensor cores add into an
// accumulator with truncation: accumulated there over all of K, the f32
// error reached 3.6x the plain chain's; see PERF.md for the trade of one
// step against two).  Single-pass TF32 keeps ~3
// decimal digits and is not used.  f64 (the parity runs) is DMMA, mma.sync
// m8n8k4, on the same structure: a warp's 16 rows are two 8-row products.
//
// The comp mode (the TPU kernel's _kernel_comp, fused_column_solve's
// default there) has a body of its own, below column_solve_comp_kernel, on
// the bf16 tensor cores: its section says what it does.
//
// Layout and padding.  K = N = 2 up8(nz): each half (x* | w* in, w | xi out)
// is padded to a multiple of 8.  A block's shared memory is the mbarriers,
// M's slab [KSLAB/8][N/8][32 lanes] of 16-byte fragment slots, then each row
// group's ring [ST][16][S].  The K padding of every ring slot is zeroed
// once; rows past ncols in the last tile are never stored.  Where the whole
// of M does not fit beside the ring (large nz), it streams through shared
// memory in K slabs (one row group then), restaged for every tile; plan()
// decides, not a second kernel.  The tiles come from ops/column_solve.py
// plan(), pure Python, the plan's only home; this file lays out shared
// memory from the same numbers and refuses a plan whose bytes differ.  No
// atomics: a call is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kMaxNz = 128;
constexpr int kTile = 16;   // columns a tile: one m16 row of tensor-core tiles
constexpr int kNtw = 2;     // 8-wide output tiles a warp (N/8 is even)
constexpr int kMaxSt = 4;    // slots in the ring
constexpr int kMaxThreads = 576;  // 65536 / 576: 113 registers a thread
constexpr int kMaxSmem = 232448;
constexpr int kMaxRg = 4;    // row groups a block
constexpr int kBarBytes = 256;  // the mbarriers (M's, one a ring slot), ahead of M

// a refused plan (ops/column_solve.py PLAN_ERRORS)
constexpr int kBadShape = -1;
constexpr int kBadPlan = -2;
constexpr int kBadSmem = -3;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int up8(int n) { return cdiv(n, 8) * 8; }
__host__ __device__ constexpr int min_of(int a, int b) { return a < b ? a : b; }

struct Plan {
  int rg, kslab, st, threads, smem, blocks;
};

// shared memory in bytes: the mbarriers, M's slab of 16-byte fragment
// slots, then each row group's ring of tiles [ST][TC][S], rows [x* | w*]
// of S = K + 4
struct Layout {
  int kh, K, S, nt, slot_run, m_bytes, ring_bytes, total;
  __host__ __device__ Layout(int nz, const Plan& p, int elem_size)
      : kh(up8(nz)), K(2 * kh), S(K + 4), nt(K / 8) {
    slot_run = nt * 32 * 16;  // one K step's slots
    m_bytes = (p.kslab / 8) * slot_run;
    ring_bytes = p.rg * p.st * kTile * S * elem_size;
    total = kBarBytes + m_bytes + ring_bytes;
  }
};

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(N)
                 : "memory");
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one bulk copy by the copy engine (TMA), its bytes counted on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// tf32(v): round to nearest, ties away from zero, low 13 mantissa bits
// cleared (as cvt.rna.tf32.f32)
__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(v);
  lo = tf32_bits(v - __uint_as_float(hi));
}

// c += a b
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

__device__ __forceinline__ void mma_f64(double& c0, double& c1, double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

// A warp's operands of one 8-deep K step: its A fragment (rows g, g + 8 at
// k = t, t + 4) and the lane's B slots of its kNtw output tiles
template <typename T>
struct Frag {
  T a[4];
  uint4 b[kNtw];

  __device__ __forceinline__ void load(const T* a_g, int S, int k, const uint4* bs) {
    a[0] = a_g[k];
    a[1] = a_g[8 * S + k];
    a[2] = a_g[k + 4];
    a[3] = a_g[8 * S + k + 4];
#pragma unroll
    for (int j = 0; j < kNtw; ++j) b[j] = bs[j * 32];
  }
};

// A warp's accumulators: 16 rows x kNtw 8-wide output tiles, in the m16n8
// C-fragment order (rows g, g + 8; columns 2t, 2t + 1).  ``step`` takes one
// 8-deep K step's operands.
template <typename T>
struct Acc;

template <>
struct Acc<float> {
  float hh[kNtw][4];       // hi(a) hi(b)
  float lh[2][kNtw][4];    // lo(a) hi(b), even and odd K steps
  float hl[2][kNtw][4];    // hi(a) lo(b), even and odd K steps
  float part[kNtw][4];     // hi(a) hi(b) of a trip's two K steps

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < kNtw; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hh[j][i] = 0.0f;
#pragma unroll
        for (int q = 0; q < 2; ++q) lh[q][j][i] = hl[q][j][i] = 0.0f;
      }
  }

  // The tensor cores add into their accumulator with truncation, so the
  // large hi-hi term of each trip (two K steps, P = 0 and 1) is summed from
  // zero there and added here in round-to-nearest; the cross terms are
  // 2^-11 smaller, in accumulators of their own for even and odd steps, so
  // no product waits on one of the step before.
  template <int P>
  __device__ __forceinline__ void step(const Frag<float>& f) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(f.a[i], ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < kNtw; ++j) {
      const uint4 b = f.b[j];  // {hi b0, hi b1, lo b0, lo b1}
      mma_tf32(lh[P][j], al, b.x, b.y);
      mma_tf32(hl[P][j], ah, b.z, b.w);
      if (P == 0) {
        mma_tf32_zero(part[j], ah, b.x, b.y);
      } else {
        mma_tf32(part[j], ah, b.x, b.y);
#pragma unroll
        for (int i = 0; i < 4; ++i) hh[j][i] += part[j][i];
      }
    }
  }

  __device__ __forceinline__ float get(int j, int i) const {
    return hh[j][i] + ((lh[0][j][i] + lh[1][j][i]) + (hl[0][j][i] + hl[1][j][i]));
  }
};

template <>
struct Acc<double> {
  double c[kNtw][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < kNtw; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[j][i] = 0.0;
  }

  // a[0], a[1]: rows g, g + 8 at k = t; a[2], a[3]: the same rows at k = t + 4
  template <int P>
  __device__ __forceinline__ void step(const Frag<double>& f) {
#pragma unroll
    for (int j = 0; j < kNtw; ++j) {
      const double2 b = reinterpret_cast<const double2&>(f.b[j]);  // k = t, t + 4
      mma_f64(c[j][0], c[j][1], f.a[0], b.x);
      mma_f64(c[j][2], c[j][3], f.a[1], b.x);
      mma_f64(c[j][0], c[j][1], f.a[2], b.y);
      mma_f64(c[j][2], c[j][3], f.a[3], b.y);
    }
  }

  __device__ __forceinline__ double get(int j, int i) const { return c[j][i]; }
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    column_solve_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const uint4* __restrict__ mp, T* __restrict__ w_out,
                        T* __restrict__ xi_out, int ncols, int nz, Plan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Layout L(nz, p, sizeof(T));
  const int groups = L.nt / kNtw;  // warps a row group
  const int tg = 32 * groups;      // threads a row group
  const int rgi = threadIdx.x / tg;  // this thread's row group
  const int lt = threadIdx.x - rgi * tg;
  const int lane = threadIdx.x & 31;
  const int wn = lt >> 5;  // the warp's kNtw output tiles
  const int g = lane >> 2;
  const int t = lane & 3;
  uint64_t* m_full = reinterpret_cast<uint64_t*>(smem_raw);  // M's slab landed
  uint64_t* full = m_full + 1 + rgi * p.st;  // [ST]: the group's slot landed
  uint4* ms = reinterpret_cast<uint4*>(smem_raw + kBarBytes);  // [KSLAB/8][N/8][32]
  const int tile_n = kTile * L.S;
  T* ring = reinterpret_cast<T*>(smem_raw + kBarBytes + L.m_bytes) +
            rgi * p.st * tile_n;  // the group's [ST][TC][S]
  const int ntiles = cdiv(ncols, kTile);
  const int nkb = L.K / 8;
  const int kb_slab = p.kslab / 8;
  const int nslab = cdiv(nkb, kb_slab);
  const bool resident = nslab == 1;
  // a tile goes by cp.async: in 16-byte pieces where its rows are whole
  // 16-byte units, else element by element.  A thread's pieces of a tile
  // are (row r, piece q of the row's 2 pcs) stepped by the group's threads,
  // and it arrives on the slot's barrier once they have landed.
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = nz % kVec == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  const int elems = vec ? kVec : 1;  // elements a piece
  const int pcs = nz / elems;        // pieces a row half
  const int q0 = lt % (2 * pcs);
  const int r0 = lt / (2 * pcs);
  const int dq = tg % (2 * pcs);
  const int dr = tg / (2 * pcs);
  const bool pairs = nz % 2 == 0;  // stores of two neighbouring outputs

  // the row group's threads only (named barrier 1 + group)
  auto group_sync = [&] {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rgi), "r"(tg) : "memory");
  };

  // M's K steps [kb0, kb0 + n), one bulk copy by the copy engine (TMA)
  auto load_m = [&](int kb0, int n) {
    mbar_arrive_expect_tx(m_full, n * L.slot_run);
    bulk_copy(ms, mp + static_cast<size_t>(kb0) * L.nt * 32, n * L.slot_run, m_full);
  };

  // a column tile into one of the group's slots; its landing completes
  // full[slot]
  auto load_tile = [&](int tile, int slot) {
    T* dst = ring + slot * tile_n;
    const int c0 = tile * kTile;
    const int rows = min_of(kTile, ncols - c0);
    const T* xs = x + static_cast<size_t>(c0) * nz;
    const T* ws = w + static_cast<size_t>(c0) * nz;
    for (int r = r0, q = q0; r < rows;) {
      const int half = q >= pcs;
      const int z = (q - half * pcs) * elems;
      T* d = dst + r * L.S + half * L.kh + z;
      const T* src = (half ? ws : xs) + r * nz + z;
      if (vec) {
        cp_async<16>(d, src);
      } else {
        cp_async<sizeof(T)>(d, src);
      }
      q += dq;
      r += dr;
      if (q >= 2 * pcs) {
        q -= 2 * pcs;
        ++r;
      }
    }
    mbar_arrive_cp_async(&full[slot]);
  };

  if (threadIdx.x == 0) {
    mbar_init(m_full, 1);
    for (int s = 0; s < p.rg * p.st; ++s) mbar_init(m_full + 1 + s, tg);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (resident) load_m(0, nkb);
  }
  // the K padding of every slot stays zero: copies never write it
  if (L.kh > nz) {
    const int pad = L.kh - nz;
    T* all = reinterpret_cast<T*>(smem_raw + kBarBytes + L.m_bytes);
    for (int i = threadIdx.x; i < p.rg * p.st * kTile * 2 * pad; i += blockDim.x) {
      const int q = i / pad;  // (slot row, half)
      all[(q >> 1) * L.S + (q & 1) * L.kh + nz + (i - q * pad)] = T(0);
    }
  }
  __syncthreads();  // the barriers are initialised
  // the groups of the blocks take tiles round robin: group r of block b
  // takes b + G r, then every G R-th
  const int first = blockIdx.x + gridDim.x * rgi;
  const int step = gridDim.x * p.rg;
  for (int s = 0; s < p.st - 1; ++s) {  // prologue: the first tiles
    const int tile = first + s * step;
    if (tile < ntiles) load_tile(tile, s);
  }

  Acc<T> acc;
  unsigned m_phase = 0;
  for (int i = 0;; ++i) {
    const int tile = first + i * step;
    if (tile >= ntiles) break;
    group_sync();  // the group is done with the slot refilled here
    const int ahead = first + (i + p.st - 1) * step;
    if (ahead < ntiles) load_tile(ahead, (i + p.st - 1) % p.st);
    mbar_wait(&full[i % p.st], (i / p.st) & 1);  // this tile landed
    if (resident && i == 0) mbar_wait(m_full, 0);
    const T* a_g = ring + (i % p.st) * tile_n + g * L.S + t;  // rows g, g + 8
    const uint4* b_lane = ms + wn * kNtw * 32 + lane;
    acc.zero();
    for (int sl = 0; sl < nslab; ++sl) {
      const int kb0 = sl * kb_slab;
      const int n = min_of(kb_slab, nkb - kb0);
      if (!resident) {  // one row group (plan): the group is the block
        if (sl > 0) group_sync();  // the previous slab is read
        if (threadIdx.x == 0) {
          fence_proxy_async();
          load_m(kb0, n);
        }
        mbar_wait(m_full, m_phase & 1);
        ++m_phase;
      }
      {
        // two K steps a trip, even and odd (n is even: K/8 is, and so is
        // every slab); the next step's operands load while this one
        // multiplies, with no branch in the loop (the last trip reloads a
        // step it does not use)
        auto load = [&](Frag<T>& f, int kl) {
          f.load(a_g, L.S, (kb0 + kl) * 8, b_lane + kl * L.nt * 32);
        };
        Frag<T> f0, f1;
        load(f0, 0);
        for (int kl = 0; kl < n; kl += 2) {
          load(f1, kl + 1);
          acc.template step<0>(f0);
          load(f0, min_of(kl + 2, n - 1));
          acc.template step<1>(f1);
        }
      }
    }
    {
#pragma unroll
      for (int j = 0; j < kNtw; ++j) {
        const int n = (wn * kNtw + j) * 8 + 2 * t;  // padded
        const int half = n >= L.kh;
        const int z = n - half * L.kh;
        T* out = half ? xi_out : w_out;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int cc = tile * kTile + g + 8 * r;
          if (cc >= ncols || z >= nz) continue;
          T* dst = out + static_cast<size_t>(cc) * nz + z;
          if (pairs) {  // z even, so z + 1 < nz and dst is aligned
            *reinterpret_cast<typename Vec2<T>::type*>(dst) = {acc.get(j, 2 * r),
                                                               acc.get(j, 2 * r + 1)};
          } else {
            dst[0] = acc.get(j, 2 * r);
            if (z + 1 < nz) dst[1] = acc.get(j, 2 * r + 1);
          }
        }
      }
    }
  }
}

int check(int ncols, int nz, const Plan& p, int elem_size) {
  if (ncols < 1 || nz < 3 || nz > kMaxNz) return kBadShape;
  const Layout L(nz, p, elem_size);
  if (p.rg < 1 || p.rg > kMaxRg || p.kslab < 16 || p.kslab > L.K ||
      p.kslab % 16 != 0 || (p.rg > 1 && p.kslab != L.K) || p.st < 2 || p.st > kMaxSt ||
      p.blocks < 1 || p.threads != p.rg * 32 * (L.nt / kNtw) || p.threads > kMaxThreads) {
    return kBadPlan;
  }
  if (p.smem != L.total || L.total > kMaxSmem) return kBadSmem;
  return 0;
}

template <typename T>
int launch(const T* x, const T* w, const void* mp, T* w_out, T* xi_out, int ncols,
           int nz, const Plan& p, void* stream) {
  const int bad = check(ncols, nz, p, sizeof(T));
  if (bad != 0) return bad;
  auto kernel = column_solve_kernel<T>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<p.blocks, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, static_cast<const uint4*>(mp), w_out, xi_out, ncols, nz, p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The comp mode: bf16x3 on the bf16 tensor cores, a body of its own.
//
// What it computes is what the TPU kernel's _kernel_comp computes, on the
// composed M: M and [x* | w*] each split into bf16 hi and lo, rounded to
// nearest even (hi = bf16(v), lo = bf16(v - hi), as __float2bfloat16_rn and
// the JAX package's astype), and the three products hi·hi + lo·hi + hi·lo
// (lo·lo dropped, as _mm3 drops it) with f32 accumulation.  Each product is
// mma.sync m16n8k16 bf16: a 16-deep K step's hi·hi starts from zero on the
// tensor cores and is added into an f32 register sum in round-to-nearest
// (the tensor cores add into an accumulator with truncation); the cross
// terms, 2^-8 smaller, go in accumulators of their own.  No TF32 product is
// left here.  The TPU kernel splits each of its five operators; splitting
// the composed M differs from it by bf16x3-sized rounding.
//
// What bounds it: as the plain f32 mode, HBM (7.08 MB at 9216 x 48: 2.12 us);
// the products are 3 x 170 MFLOP of bf16, 0.52 us at 989 TFLOP/s.  What the
// design does about the four faults of the first comp body (the plain body
// run with TF32 products on bf16 values):
//  1. Tensor-core work: one m16n8k16 bf16 instruction a product and 16 K,
//     half the instructions of m16n8k8 TF32, at twice the rate a FLOP.
//  2. Redundant splitting: a row group splits each 16-column tile once
//     (the split pass), into bf16 hi and lo tiles [16][K + 8], whose rows
//     are an odd number of 16-byte units apart, so ldmatrix.x4 reads each
//     warp's A fragments without bank conflicts; every warp of the group
//     reads them, none splits them again.
//  3. Copies off the compute threads: a tile of 16 columns of x* is one
//     contiguous run of 64 nz bytes, as is w*'s; each lands by one bulk copy
//     of the copy engine (TMA) on the group's mbarrier, issued by the
//     group's first thread, the next tile's as soon as the split pass has
//     read this one.  The outputs go from the registers, fire and forget:
//     staging them in shared memory for bulk stores, shared to global, was
//     measured slower at every shape (the staging barrier and the wait for
//     the copy engine to read them before the block ends, PERF.md §6),
//     as were deeper rings of tiles (the first tile lands later).
//  4. Uneven tiles: a block takes a contiguous range of ``span`` columns, a
//     multiple of 4 (so every tile but the very last starts and ends on 16
//     bytes), spread over the SMs so that no SM moves more than 4 columns
//     over its share; its last tile may be partial.  At 9216 columns that
//     is 128 blocks of 72 columns, against 576 tiles of 16 over 132 SMs
//     (5 tiles on some, 4 on others).
// Where nz is large and M does not fit in shared memory beside a row group,
// the plan splits N in two: a block computes w or xi of its range, with its
// half of M resident (nsplit 2); M is never streamed.  Where x* or w* is not
// 16-byte aligned, or a last tile is not whole 16-byte units, the split pass
// reads that tile from device memory itself, and outputs not aligned so
// are stored from the registers: no fallback to the plain version.
// The plan comes from ops/column_solve.py plan_comp(), the plan's only home;
// this file lays out shared memory from the same numbers and refuses a plan
// whose bytes differ.  No atomics: a call is deterministic.
//
// Shared memory: the mbarriers (M's; one a row group), M's fragments
// [nb8][K/16][32 lanes] of 16 bytes (a part's n-tiles, n-tile major: {hi b0,
// hi b1, lo b0, lo b1}, each a bf16 pair; ops/column_solve.py
// pack_operator(M, float32, "bf16")), then each row group's raw tile (x*
// [16][nz] then w* [16][nz] f32) and its A tiles (hi, lo [16][K + 8] bf16).
// The products run a 16-deep K step at a time with no branch, the next
// step's operands loaded before this step's hi·hi is added; the set-up
// computes no run-time division before the first copies go out.

constexpr int kCompMaxThreads = 512;  // 65536 / 512: 128 registers a thread
constexpr int kCompMaxRg = 8;         // row groups a block

struct CompPlan {
  int span, nsplit, rg, ntw, threads, smem, blocks;
};

struct CompLayout {
  int kh, K, ks, nb8, as, m_bytes, raw_bytes, a_bytes, group_bytes, total;
  __host__ __device__ CompLayout(int nz, const CompPlan& p)
      : kh(up8(nz)), K(2 * kh), ks(K / 16), nb8((K / 8) >> (p.nsplit - 1)), as(K + 8) {
    m_bytes = nb8 * ks * 32 * 16;
    raw_bytes = 2 * kTile * nz * 4;
    a_bytes = 2 * kTile * as * 2;
    group_bytes = raw_bytes + a_bytes;
    total = kBarBytes + m_bytes + p.rg * group_bytes;
  }
};

// c += a b
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// x / d for 0 <= x < 2^16 and 0 < d < 2^16 by the high word of one multiply:
// m = floor((2^32 - 1) / d) + 1 >= 2^32 / d, over by less than d / 2^32, so
// the quotient is exact (no 64-bit division: that is a long software routine)
struct FastDiv {
  unsigned m;
  __device__ __forceinline__ explicit FastDiv(int d)
      : m(0xffffffffu / static_cast<unsigned>(d) + 1u) {}
  __device__ __forceinline__ int operator()(int x) const {
    return static_cast<int>(__umulhi(static_cast<unsigned>(x), m));
  }
};

// The split pass of one tile: the [x* | w*] rows (xs, ws: [rows][nz]) as
// bf16 hi and lo [16][as], zero past nz in each half and past the rows.  A
// thread takes quads of K, e = lt, lt + tg, ...; kVec4 (nz % 4 == 0, xs and
// ws 16-byte aligned): a quad is one 16-byte load.
template <bool kVec4>
__device__ __forceinline__ void split_tile(const float* xs, const float* ws, int rows, int nz,
                                           int kh, int as, int qr, const FastDiv& div_qr,
                                           int lt, int tg, __nv_bfloat16* a_hi,
                                           __nv_bfloat16* a_lo) {
  const int n = kTile * qr;
#pragma unroll 2
  for (int e = lt; e < n; e += tg) {
    const int r = div_qr(e);
    const int k = 4 * (e - r * qr);
    const int half = k >= kh;
    const int z = k - half * kh;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < rows && z < nz) {
      const float* src = (half ? ws : xs) + r * nz + z;
      if constexpr (kVec4) {
        v = *reinterpret_cast<const float4*>(src);
      } else {
        v.x = src[0];
        if (z + 1 < nz) v.y = src[1];
        if (z + 2 < nz) v.z = src[2];
        if (z + 3 < nz) v.w = src[3];
      }
    }
    uint2 hi, lo;
    split2(v.x, v.y, hi.x, lo.x);
    split2(v.z, v.w, hi.y, lo.y);
    *reinterpret_cast<uint2*>(a_hi + r * as + k) = hi;
    *reinterpret_cast<uint2*>(a_lo + r * as + k) = lo;
  }
}

// the same from device memory, for a tile that did not go by bulk copy (x*
// or w* not 16-byte aligned, or a last tile not whole 16-byte units); out of
// line, off the common path
__device__ __noinline__ void split_tile_global(const float* xs, const float* ws, int rows,
                                               int nz, int kh, int as, int qr,
                                               FastDiv div_qr, int lt, int tg,
                                               __nv_bfloat16* a_hi, __nv_bfloat16* a_lo) {
  split_tile<false>(xs, ws, rows, nz, kh, as, qr, div_qr, lt, tg, a_hi, a_lo);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// NTW: 8-wide output tiles a warp
template <int NTW>
__global__ void __launch_bounds__(kCompMaxThreads)
    column_solve_comp_kernel(const float* __restrict__ x, const float* __restrict__ w,
                             const uint4* __restrict__ mp, float* __restrict__ w_out,
                             float* __restrict__ xi_out, int ncols, int nz, CompPlan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // set-up without run-time divisions (each a long dependent sequence on
  // the way to the first copies): nsplit is 1 or 2, the rest are counted
  const CompLayout L(nz, p);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wpg = (L.nb8 + NTW - 1) / NTW;  // warps a row group
  int rgi = 0;                              // this thread's row group: warp / wpg
  for (int v = warp; v >= wpg; v -= wpg) ++rgi;
  const int tg = 32 * wpg;  // threads a row group
  const int lt = threadIdx.x - rgi * tg;
  const int n0 = (warp - rgi * wpg) * NTW;  // the warp's first n-tile of the part
  const int g = lane >> 2;
  const int t = lane & 3;
  const int npart = p.nsplit == 2 ? static_cast<int>(blockIdx.x & 1) : 0;  // 0: w, 1: xi
  const int c_lo = static_cast<int>(p.nsplit == 2 ? blockIdx.x >> 1 : blockIdx.x) * p.span;
  const int c_hi = min_of(ncols, c_lo + p.span);  // the block's columns [c_lo, c_hi)
  const int ntiles = (c_hi - c_lo + kTile - 1) / kTile;
  int mine = 0;  // the group's tiles: the block's rgi, rgi + rg, ...
  for (int l = rgi; l < ntiles; l += p.rg) ++mine;
  uint64_t* m_full = reinterpret_cast<uint64_t*>(smem_raw);  // M landed
  uint64_t* full = m_full + 1 + rgi;                         // the group's raw tile landed
  const uint4* ms = reinterpret_cast<const uint4*>(smem_raw + kBarBytes);
  unsigned char* gs = smem_raw + kBarBytes + L.m_bytes + rgi * L.group_bytes;
  float* raw = reinterpret_cast<float*>(gs);  // [x*, w*][16][nz]
  __nv_bfloat16* a_hi = reinterpret_cast<__nv_bfloat16*>(gs + L.raw_bytes);
  __nv_bfloat16* a_lo = a_hi + kTile * L.as;
  const bool leader = lt == 0;
  const bool in_bulk = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) &
                        15) == 0;
  // float2 stores of output pairs
  const bool pairs = nz % 2 == 0 && ((reinterpret_cast<uintptr_t>(w_out) |
                                      reinterpret_cast<uintptr_t>(xi_out)) & 7) == 0;

  // the row group's threads only (named barrier 1 + group)
  auto group_sync = [&] {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rgi), "r"(tg) : "memory");
  };
  // the group's i-th tile: group r takes the block's tiles r, r + rg, ...
  auto first_col = [&](int i) { return c_lo + (rgi + i * p.rg) * kTile; };
  auto rows_of = [&](int c0) { return min_of(kTile, c_hi - c0); };
  // whole 16-byte units (every tile but a last one of ncols % 4 columns)
  auto whole = [&](int rows) { return rows * nz % 4 == 0; };

  // the group's i-th tile into its raw buffer, one bulk copy for x* and one
  // for w*; a tile that cannot go so is read by the split pass from device
  // memory, and the barrier completes at once
  auto load_tile = [&](int i) {
    const int c0 = first_col(i);
    const int rows = rows_of(c0);
    if (in_bulk && whole(rows)) {
      const unsigned bytes = rows * nz * 4;
      mbar_arrive_expect_tx(full, 2 * bytes);
      bulk_copy(raw, x + static_cast<size_t>(c0) * nz, bytes, full);
      bulk_copy(raw + kTile * nz, w + static_cast<size_t>(c0) * nz, bytes, full);
    } else {
      mbar_arrive(full);
    }
  };

  // each group's first thread initialises its barrier and issues its first
  // tile's copies at once, thread 0 M's after its own; the block's threads
  // meet after that
  if (leader) {
    mbar_init(full, 1);
    if (threadIdx.x == 0) mbar_init(m_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (mine > 0) load_tile(0);
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(m_full, L.m_bytes);
      bulk_copy(smem_raw + kBarBytes, mp + static_cast<size_t>(npart) * L.nb8 * L.ks * 32,
                L.m_bytes, m_full);
    }
  }
  __syncthreads();  // the barriers are initialised

  const int qr = L.K / 4;  // quads of K a row
  const FastDiv div_qr(qr);
  // this lane's ldmatrix row: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15)
  const int a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * L.as + (lane >> 4) * 8;
  // the warp's output tiles; a last warp of a group with fewer than NTW
  // repeats the group's last tile (its results are not stored), so the K
  // loop has no branch
  int b_off[NTW];
#pragma unroll
  for (int j = 0; j < NTW; ++j) b_off[j] = min_of(n0 + j, L.nb8 - 1) * L.ks * 32 + lane;
  for (int i = 0; i < mine; ++i) {
    const int c0 = first_col(i);
    const int rows = rows_of(c0);
    mbar_wait(full, i & 1);  // this tile landed
    {  // the split pass: the tile's [x* | w*] rows as bf16 hi and lo
      if (in_bulk && whole(rows)) {  // in shared memory
        if (nz % 4 == 0) {
          split_tile<true>(raw, raw + kTile * nz, rows, nz, L.kh, L.as, qr, div_qr, lt, tg,
                           a_hi, a_lo);
        } else {
          split_tile<false>(raw, raw + kTile * nz, rows, nz, L.kh, L.as, qr, div_qr, lt, tg,
                            a_hi, a_lo);
        }
      } else {
        split_tile_global(x + static_cast<size_t>(c0) * nz, w + static_cast<size_t>(c0) * nz,
                          rows, nz, L.kh, L.as, qr, div_qr, lt, tg, a_hi, a_lo);
      }
    }
    group_sync();  // the A tiles are whole; the raw tile is read
    if (leader && i + 1 < mine) {
      fence_proxy_async();
      load_tile(i + 1);
    }
    if (i == 0) mbar_wait(m_full, 0);

    // the products, a 16-deep K step at a time: its operands loaded before
    // the step's hi·hi is added, so the add's wait on the tensor cores
    // overlaps the loads
    float hh[NTW][4], lh[NTW][4], hl[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) hh[j][q] = lh[j][q] = hl[j][q] = 0.0f;
    }
    uint32_t ah[4], al[4];
    uint4 b[NTW];  // {hi b0, hi b1, lo b0, lo b1}
    auto load_step = [&](int ks) {
      ldsm_x4(ah, a_hi + a_off + ks * 16);
      ldsm_x4(al, a_lo + a_off + ks * 16);
#pragma unroll
      for (int j = 0; j < NTW; ++j) b[j] = ms[b_off[j] + ks * 32];
    };
    load_step(0);
    for (int ks = 0; ks < L.ks; ++ks) {
      float d[NTW][4];
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        mma_bf16(lh[j], al, b[j].x, b[j].y);
        mma_bf16(hl[j], ah, b[j].z, b[j].w);
        mma_bf16_zero(d[j], ah, b[j].x, b[j].y);
      }
      if (ks + 1 < L.ks) load_step(ks + 1);
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) hh[j][q] += d[j][q];
      }
    }

    // the outputs, stored from the registers (fire and forget)
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int n = (npart * L.nb8 + n0 + j) * 8 + 2 * t;  // of [w | xi], padded
      const int half = n >= L.kh;
      const int z = n - half * L.kh;
      if (n0 + j >= L.nb8 || z >= nz) continue;
      float* o = (half ? xi_out : w_out) + static_cast<size_t>(c0 + g) * nz + z;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (g + 8 * r >= rows) continue;
        const float v0 = hh[j][2 * r] + (lh[j][2 * r] + hl[j][2 * r]);
        const float v1 = hh[j][2 * r + 1] + (lh[j][2 * r + 1] + hl[j][2 * r + 1]);
        float* d = o + 8 * r * nz;
        if (pairs) {  // z even, so z + 1 < nz and d is 8-byte aligned
          *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
        } else {
          d[0] = v0;
          if (z + 1 < nz) d[1] = v1;
        }
      }
    }
    if (i + 1 < mine) group_sync();  // the A tiles are read
  }
}

int check_comp(int ncols, int nz, const CompPlan& p) {
  if (ncols < 1 || nz < 3 || nz > kMaxNz) return kBadShape;
  if (p.nsplit != 1 && p.nsplit != 2) return kBadPlan;
  const CompLayout L(nz, p);
  if (p.span < 4 || p.span % 4 != 0 || (p.ntw != 2 && p.ntw != 4) || p.rg < 1 ||
      p.rg > min_of(kCompMaxRg, cdiv(min_of(p.span, ncols), kTile)) ||
      p.blocks != p.nsplit * cdiv(ncols, p.span) ||
      p.threads != p.rg * 32 * cdiv(L.nb8, p.ntw) || p.threads > kCompMaxThreads) {
    return kBadPlan;
  }
  if (p.smem != L.total || L.total > kMaxSmem) return kBadSmem;
  return 0;
}

int launch_comp(const float* x, const float* w, const void* mp, float* w_out, float* xi_out,
                int ncols, int nz, const CompPlan& p, void* stream) {
  const int bad = check_comp(ncols, nz, p);
  if (bad != 0) return bad;
  auto kernel = p.ntw == 4 ? column_solve_comp_kernel<4> : column_solve_comp_kernel<2>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<p.blocks, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, static_cast<const uint4*>(mp), w_out, xi_out, ncols, nz, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int scythe_column_solve_max_nz() { return kMaxNz; }

// x, w: [ncols, nz]; mp: M packed by ops/column_solve.py pack_operator;
// the plan's fields as ops/column_solve.py plan() sets them
int scythe_column_solve_f32(const float* x, const float* w, const void* mp, float* w_out,
                            float* xi_out, int ncols, int nz, int rg, int kslab, int st,
                            int threads, int smem, int blocks, void* stream) {
  const Plan p{rg, kslab, st, threads, smem, blocks};
  return launch<float>(x, w, mp, w_out, xi_out, ncols, nz, p, stream);
}

// the comp mode: mp packed by pack_operator(M, float32, "bf16"); the plan's
// fields as ops/column_solve.py plan_comp() sets them
int scythe_column_solve_comp(const float* x, const float* w, const void* mp,
                             float* w_out, float* xi_out, int ncols, int nz, int span,
                             int nsplit, int rg, int ntw, int threads, int smem, int blocks,
                             void* stream) {
  const CompPlan p{span, nsplit, rg, ntw, threads, smem, blocks};
  return launch_comp(x, w, mp, w_out, xi_out, ncols, nz, p, stream);
}

int scythe_column_solve_f64(const double* x, const double* w, const void* mp,
                            double* w_out, double* xi_out, int ncols, int nz, int rg,
                            int kslab, int st, int threads, int smem, int blocks,
                            void* stream) {
  const Plan p{rg, kslab, st, threads, smem, blocks};
  return launch<double>(x, w, mp, w_out, xi_out, ncols, nz, p, stream);
}

const char* scythe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
