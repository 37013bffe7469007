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
// default there) is the same kernel with a bf16 split (kBf16): a = hi + lo
// with hi = bf16(a) and lo = bf16(a - hi), each rounded to nearest even
// (__float2bfloat16_rn, never by truncation), likewise for M (split once in
// pack_operator with split="bf16"), and the three products hi·hi + lo·hi +
// hi·lo with f32 accumulation.  It reuses the TF32 tensor-core products on
// purpose: a bf16 value (8 significant bits) is exact in TF32 (11), so
// mma.sync m16n8k8 TF32 on the bf16-valued hi/lo parts forms exactly the
// products that mma.sync m16n8k16 bf16 would, with the same fragment
// layout, the same packing of M and the same accumulation as the plain
// mode; the bf16 instruction would halve the K steps but needs a packing
// of its own (K padded to 16, pairs of bf16 a register).  The TPU kernel
// splits each of its five operators; here the composed M is split, which
// differs from it by bf16x3-sized rounding.
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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

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

// arrives on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
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

// bf16(v) as a float: round to nearest even (the comp mode's split)
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void split_bf16(float v, uint32_t& hi, uint32_t& lo) {
  const float h = bf16_round(v);
  hi = __float_as_uint(h);
  lo = __float_as_uint(bf16_round(v - h));
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
template <typename T, bool kBf16 = false>
struct Acc;

// kBf16: the comp mode, the activations split by bf16 (M arrives split so)
template <bool kBf16>
struct Acc<float, kBf16> {
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
    for (int i = 0; i < 4; ++i) {
      if constexpr (kBf16) {
        split_bf16(f.a[i], ah[i], al[i]);
      } else {
        split(f.a[i], ah[i], al[i]);
      }
    }
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
struct Acc<double, false> {
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

template <typename T, bool kBf16>
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

  Acc<T, kBf16> acc;
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

template <typename T, bool kBf16 = false>
int launch(const T* x, const T* w, const void* mp, T* w_out, T* xi_out, int ncols,
           int nz, const Plan& p, void* stream) {
  const int bad = check(ncols, nz, p, sizeof(T));
  if (bad != 0) return bad;
  auto kernel = column_solve_kernel<T, kBf16>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
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

// the comp mode: mp packed by pack_operator(M, float32, "bf16")
int scythe_column_solve_comp(const float* x, const float* w, const void* mp,
                             float* w_out, float* xi_out, int ncols, int nz, int rg,
                             int kslab, int st, int threads, int smem, int blocks,
                             void* stream) {
  const Plan p{rg, kslab, st, threads, smem, blocks};
  return launch<float, true>(x, w, mp, w_out, xi_out, ncols, nz, p, stream);
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
