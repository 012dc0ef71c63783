// Dense flash attention for Hopper (sm_90a): online softmax over kv tiles,
// causal tile skip, f32 inputs and outputs, QK^T and P x V on the TF32
// tensor cores split in three so that the f32 tolerance holds.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_single (body _flash_kernel).  It computes the same
// function; the oracle both are held against is the dense softmax of
// src/repro/kernels/ref.py:flash_attention.
//
// What bounds it on the H100: operations.  Per reachable tile pair it does
// 2 * rows * keys * (D + Dv) flops, each f32 product as three TF32
// tensor-core products (494.7 TFLOP/s dense, so 164.9 TFLOP/s of f32-accurate
// work), and reads q, K, V once and writes out once from device memory.
// The splits, the softmax (an expf a pair) and the fragment loads run on
// the CUDA cores and the shared-memory pipe beside the MMAs.
//
// Design.
//  * Split TF32.  Each f32 operand x becomes hi = x rounded to TF32 (to
//    nearest, ties away from zero: cvt.rna.tf32.f32 for every finite x) and
//    lo = x - hi, exact in f32, which the MMA reads truncated to TF32
//    (|x - hi - lo'| < 2^-21 |x|).  A product is lo*hi + hi*lo + hi*hi,
//    three mma.sync.m16n8k8 TF32 MMAs in that order (the small terms
//    first); the dropped lo*lo and the truncations cost at most
//    1.25 * 2^-20 |a||b| a product.  Q is split once per block, K and V by
//    each warp as it loads its fragments, P in registers.  Hi and lo planes
//    of K and V in shared memory would double every warp's shared-memory
//    reads and the ring's size.
//  * f32 sums in the reference's places.  The MMAs of a 16-wide d pair of
//    QK^T accumulate into a fresh f32 fragment that is then added to the
//    score, and a tile's P x V into a fresh fragment, so that acc = acc *
//    corr + P V as in the reference: the tensor cores' own additions never
//    run over a long sum.
//  * One block of 4 warps per (slice, 64 q rows), one launch for all
//    slices, heaviest causal q tiles first (block b takes q tile
//    n_qt - 1 - b / N), so the short tiles fill the last wave.  A warp owns
//    16 whole rows, the m16n8 accumulator layout: lane (g, t) =
//    (lane / 4, lane % 4) holds rows g and g + 8 and columns 2t, 2t + 1 of
//    every 8-wide n-tile.  A row's max and sum are quad shuffles, and the
//    score accumulator is P's A fragment as it stands (P x V's k order is
//    keys 2t (k = t) and 2t + 1 (k = t + 4) of each 8-key step).
//  * The k order of QK^T is permuted inside each 16-wide d pair of k-steps:
//    lane t holds d = 16p + 4t .. 16p + 4t + 3 across the pair, so one
//    16-byte shared load gives it the B words of two k-steps.  q's split A
//    operands, in the same order, lie lane-private in shared memory.  D is
//    padded to a multiple of 16 with zero columns.
//  * K and V tiles of KT keys (64 for value widths up to 64, else 32) come
//    with cp.async into a ring of two stages and arrive on an mbarrier a
//    stage; a tile is copied while the tile before it is in the MMAs, and a
//    stage is refilled once every warp has released it (a second mbarrier).
//    No block barrier sits in the kv loop.  K rows are 16-byte chunks
//    swizzled by row parity and V rows padded to Dv + 4 words, so that
//    fragment loads do not conflict on banks.  Rows past Sk are copies of
//    row Sk - 1 (finite) whose scores are -inf, so their weights are 0.
//    Rows that do not start on 16 bytes come in 4-byte copies.
//  * The reference's bq and bk only decide which keys share a tile.  A
//    query row that sees at least one key sees key 0, so its state is real
//    from the first tile on and every masked or skipped key weighs exactly
//    0: such a row comes out as the reference's whatever the tiling.  Only
//    rows that see no key (causal with Sq > Sk) depend on the reference's
//    tiles: they get what the reference gives them, the mean of V over the
//    last kv tile their q tile reaches (0 if none).  Tiles past the block's
//    last visible key are skipped, as the reference skips a kv tile with
//    k_start > q_start + bq - 1.
//  * The reference's float steps, in its order: s = dot * sm_scale, masked
//    entries set to the finite NEG_INF = -1e30, m_new = max(m_prev, max s),
//    p = exp(s - m_new), corr = 0 while m_prev is NEG_INF, l = l * corr +
//    sum p, acc = acc * corr + P V, out = acc / max(l, 1e-30).  Sums run in
//    another order than the plain version's, so the two agree within a
//    stated tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // q rows of a block
constexpr int kStages = 2;           // K/V ring
constexpr int kBarBytes = 64;        // full[kStages], then empty[kStages]
constexpr int kMaxTile = 128;        // the reference's largest bq, bk
constexpr int kMaxD = 160;           // head widths the tiles fit in shared
                                     // memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of `bar` with this parity.  A wait of more than 2^35
// cycles (seconds) can only be a fault of the copy protocol: it traps, and
// the launch fails, rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// This thread's arrival on `bar` once its cp.async copies so far have
// landed.
__device__ __forceinline__ void copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void plain_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(
          smem_addr(bar))
      : "memory");
}

template <int B>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(B)
                 : "memory");
}

// The split of an f32 operand: hi = x rounded to TF32, to nearest with ties
// away from zero (cvt.rna.tf32.f32 for every finite x: 2^12 added to the
// magnitude's bits, the 13 low bits cleared), and lo = x - hi, exact in
// f32.  The MMA reads the 19 high bits of each operand, so lo enters it
// truncated to TF32: x = hi + lo' + r with |r| < 2^-21 |x|.  Three integer
// and float operations instead of the eight that two cvt.rna compile to;
// a NaN reaches the products through lo, an infinity through hi.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a (16 x 8, row) x b (8 x 8, col), TF32 operands, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(kFull, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(kFull, x, 2));
}

// f(r, c) for the cells i = tid, tid + kThreads, ... of a rows x cols grid
// in row-major order, without a division a cell.
template <class F>
__device__ __forceinline__ void for_grid(int rows, int cols, int tid, F f) {
  int r = tid / cols, c = tid - r * cols;
  const int dr = kThreads / cols, dc = kThreads - dr * cols;
  while (r < rows) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

template <int DV>
struct Tile {
  static constexpr int KT = DV <= 64 ? 64 : 32;   // keys of a stage
  static constexpr int NT = KT / 8;   // n-tiles of S, k-steps of P x V
  static constexpr int VT = DV / 8;   // n-tiles of acc
  static constexpr int VS = DV + 4;   // V row stride in words
};

// Shared memory: the barriers, q's split A operands ([warp][pair][hi of
// k-steps 2p, 2p + 1, then lo][lane] uint4), the ring ([stage] K [KT][Dp],
// then V [KT][DV + 4]).
template <int DV>
size_t smem_bytes(int Dp) {
  return kBarBytes + (size_t)kWarps * (Dp / 16) * 4 * 32 * 16 +
         (size_t)kStages * Tile<DV>::KT * (Dp + Tile<DV>::VS) * sizeof(float);
}

template <int DV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q,    // [N, Sq, D]
             const float* __restrict__ k,    // [N, Sk, D]
             const float* __restrict__ v,    // [N, Sk, DV]
             float* __restrict__ out,        // [N, Sq, DV]
             int N, int Sq, int Sk, int D, int Dp, int bq, int bk,
             int causal, int q_offset, float sm_scale, int vec) {
  using T = Tile<DV>;
  constexpr int KT = T::KT, NT = T::NT, VT = T::VT, VS = T::VS;
  const int n_qt = (Sq + kRows - 1) / kRows;
  const int qt = n_qt - 1 - (int)(blockIdx.x / N);
  const int n = (int)(blockIdx.x % N);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kRows;
  const int pairs = Dp / 16;             // k-step pairs of QK^T
  // 16-byte chunk swizzle of K rows: with a row of a multiple of 8 chunks,
  // odd rows swap chunk halves, so that rows 2i and 2i + 1 of one load use
  // disjoint banks; otherwise their offsets differ by 4 chunks already.
  const int swz = pairs % 2 == 0 ? 4 : 0;
  const int stage_floats = KT * (Dp + VS);

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  uint4* qf = reinterpret_cast<uint4*>(smem + kBarBytes) +
              (size_t)warp * pairs * 4 * 32 + lane;
  float* ring = reinterpret_cast<float*>(smem + kBarBytes) +
                (size_t)kWarps * pairs * 4 * 32 * 4;

  // The keys the block reaches: up to its last row's last visible key.
  const int rows_valid = min(kRows, Sq - q0);
  int last_key = Sk - 1;
  if (causal) last_key = min(last_key, q0 + rows_valid - 1 + q_offset);
  const int n_tiles = last_key < 0 ? 0 : last_key / KT + 1;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kThreads);
      mbar_init(&empty[s], kWarps);
    }
  }
  // Padding columns of K (d in [D, Dp)) are zero in every stage and never
  // copied over.
  if (D < Dp) {
    const int w = Dp - (D & ~3);
    for (int i = tid; i < kStages * KT * w; i += kThreads) {
      const int s = i / (KT * w), r = (i / w) % KT, d = (D & ~3) + i % w;
      if (d < D) continue;
      const int phys = (((d >> 2) ^ ((r & 1) ? swz : 0)) << 2) | (d & 3);
      ring[s * stage_floats + r * Dp + phys] = 0.f;
    }
  }
  __syncthreads();

  const float* kn = k + (size_t)n * Sk * D;
  const float* vn = v + (size_t)n * Sk * DV;
  // Every thread copies its share of tile `tile` into stage s and arrives
  // on full[s] once its copies have landed.
  auto fill = [&](int tile, int s) {
    float* ks = ring + s * stage_floats;
    float* vs = ks + KT * Dp;
    const float* kt = kn + (size_t)tile * KT * D;
    const float* vt = vn + (size_t)tile * KT * DV;
    const int rows = min(KT, Sk - tile * KT);   // rows past Sk: row Sk - 1
    if (vec) {
      for_grid(KT, D >> 2, tid, [&](int r, int c) {
        copy_async<16>(ks + r * Dp + ((c ^ ((r & 1) ? swz : 0)) << 2),
                       kt + (size_t)min(r, rows - 1) * D + 4 * c);
      });
      for_grid(KT, DV / 4, tid, [&](int r, int c) {
        copy_async<16>(vs + r * VS + 4 * c,
                       vt + (size_t)min(r, rows - 1) * DV + 4 * c);
      });
    } else {
      for_grid(KT, D, tid, [&](int r, int d) {
        const int phys = (((d >> 2) ^ ((r & 1) ? swz : 0)) << 2) | (d & 3);
        copy_async<4>(ks + r * Dp + phys,
                      kt + (size_t)min(r, rows - 1) * D + d);
      });
      for_grid(KT, DV, tid, [&](int r, int d) {
        copy_async<4>(vs + r * VS + d, vt + (size_t)min(r, rows - 1) * DV + d);
      });
    }
    copies_arrive(&full[s]);
  };
  for (int s = 0; s < kStages && s < n_tiles; ++s) fill(s, s);

  // q's split A fragments, lane-private, stored as the MMA operands: pair p
  // holds, for k-step 2p and 2p + 1, hi then lo, the values of rows g and
  // g + 8 at d = 16p + 4t + {0, 1} and {2, 3} (rows past Sq repeat row
  // Sq - 1, columns past D are zero).
  {
    const float* qn = q + (size_t)n * Sq * D;
    const float* qrow[2] = {
        qn + (size_t)min(q0 + warp * 16 + g, Sq - 1) * D,
        qn + (size_t)min(q0 + warp * 16 + g + 8, Sq - 1) * D};
    for (int p = 0; p < pairs; ++p) {
#pragma unroll
      for (int ks2 = 0; ks2 < 2; ++ks2) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {   // a_i: row g + 8 (i & 1), k = t (+4)
          const int d = 16 * p + 4 * t + 2 * ks2 + (i >> 1);
          split(d < D ? qrow[i & 1][d] : 0.f, hi[i], lo[i]);
        }
        qf[(p * 4 + ks2) * 32] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        qf[(p * 4 + 2 + ks2) * 32] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  }

  // Key positions rows g and g + 8 see up to (causal), and the warp's
  // first row's: a tile past it needs masks.
  const int warp_pos = q0 + warp * 16 + q_offset;
  const int rpos[2] = {warp_pos + g, warp_pos + g + 8};
  float acc[VT][4];
#pragma unroll
  for (int j = 0; j < VT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int k0 = it * KT;
    mbar_wait(&full[s], parity);
    const float* ks = ring + s * stage_floats;
    const float* vs = ks + KT * Dp;

    float S[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[j][e] = 0.f;
    for (int p = 0; p < pairs; ++p) {
      const uint4 qa[2][2] = {{qf[(p * 4) * 32], qf[(p * 4 + 2) * 32]},
                              {qf[(p * 4 + 1) * 32], qf[(p * 4 + 3) * 32]}};
      const int chunk = (4 * p + t) ^ ((g & 1) ? swz : 0);
      // All n-tiles' B words first, then each product over all n-tiles, so
      // that dependent MMAs on one accumulator stand NT MMAs apart.
      uint32_t bh[NT][4], bl[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(
            ks + (8 * j + g) * Dp + 4 * chunk);
        split(b.x, bh[j][0], bl[j][0]);
        split(b.y, bh[j][1], bl[j][1]);
        split(b.z, bh[j][2], bl[j][2]);
        split(b.w, bh[j][3], bl[j][3]);
      }
      float T[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) T[j][e] = 0.f;
#pragma unroll
      for (int ks2 = 0; ks2 < 2; ++ks2) {
        const uint4 ah = qa[ks2][0], al = qa[ks2][1];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_tf32(T[j], al.x, al.y, al.z, al.w, bh[j][2 * ks2],
                   bh[j][2 * ks2 + 1]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_tf32(T[j], ah.x, ah.y, ah.z, ah.w, bl[j][2 * ks2],
                   bl[j][2 * ks2 + 1]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_tf32(T[j], ah.x, ah.y, ah.z, ah.w, bh[j][2 * ks2],
                   bh[j][2 * ks2 + 1]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) S[j][e] = __fadd_rn(S[j][e], T[j][e]);
    }

    // Online softmax.  Keys past Sk score -inf (weight 0, no effect on
    // the max); causally masked keys the reference's NEG_INF.
    const bool edge = (causal && k0 + KT - 1 > warp_pos) || k0 + KT > Sk;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(S[j][e], sm_scale);
        if (edge) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          if (causal && col > rpos[e >> 1]) x = kNegInf;
          if (col >= Sk) x = -INFINITY;
        }
        S[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_run[h], quad_max(mx[h]));
      corr[h] = m_run[h] == kNegInf ? 0.f : expf(__fsub_rn(m_run[h], m_new));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(__fsub_rn(S[j][2 * h + e], m_new));
          S[j][2 * h + e] = p;
          sum = __fadd_rn(sum, p);
        }
      l_run[h] = __fadd_rn(__fmul_rn(l_run[h], corr[h]), quad_sum(sum));
      m_run[h] = m_new;
    }
    // pv = P V: k-step j takes keys 8j + 2t (k = t) and 8j + 2t + 1
    // (k = t + 4), which are S[j]'s columns of this lane.
    float pv[VT][4];
#pragma unroll
    for (int c = 0; c < VT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[c][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ph[4], pl[4];
      split(S[j][0], ph[0], pl[0]);
      split(S[j][2], ph[1], pl[1]);
      split(S[j][1], ph[2], pl[2]);
      split(S[j][3], ph[3], pl[3]);
      const float* v0 = vs + (8 * j + 2 * t) * VS + g;
      uint32_t bh[VT][2], bl[VT][2];
#pragma unroll
      for (int c = 0; c < VT; ++c) {
        split(v0[8 * c], bh[c][0], bl[c][0]);
        split(v0[VS + 8 * c], bh[c][1], bl[c][1]);
      }
#pragma unroll
      for (int c = 0; c < VT; ++c)
        mma_tf32(pv[c], pl[0], pl[1], pl[2], pl[3], bh[c][0], bh[c][1]);
#pragma unroll
      for (int c = 0; c < VT; ++c)
        mma_tf32(pv[c], ph[0], ph[1], ph[2], ph[3], bl[c][0], bl[c][1]);
#pragma unroll
      for (int c = 0; c < VT; ++c)
        mma_tf32(pv[c], ph[0], ph[1], ph[2], ph[3], bh[c][0], bh[c][1]);
    }

#pragma unroll
    for (int c = 0; c < VT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[c][e] = __fadd_rn(__fmul_rn(acc[c][e], corr[e >> 1]), pv[c][e]);

    // Release the stage; refill it with the tile kStages ahead once every
    // warp has released it.
    __syncwarp();
    if (lane == 0) plain_arrive(&empty[s]);
    if (it + kStages < n_tiles) {
      mbar_wait(&empty[s], parity);
      fill(it + kStages, s);
    }
  }

  float* on = out + (size_t)n * Sq * DV;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= Sq) continue;
    float2* orow = reinterpret_cast<float2*>(on + (size_t)row * DV);
    if (causal && rpos[h] < 0) {
      // A row that sees no key: in the reference every tile its q tile
      // reaches gives it weights 1 and corr 0, so it ends as the mean of V
      // over the last of them (0 if there is none).
      const int last = (row / bq) * bq + q_offset + bq - 1;
      const int kb = last < 0 ? -1 : min(last / bk, Sk / bk - 1);
#pragma unroll
      for (int c = 0; c < VT; ++c) {
        float a0 = 0.f, a1 = 0.f;
        if (kb >= 0) {
          const float* vt = vn + (size_t)kb * bk * DV + 8 * c + 2 * t;
          for (int j = 0; j < bk; ++j) {
            a0 = __fadd_rn(a0, vt[(size_t)j * DV]);
            a1 = __fadd_rn(a1, vt[(size_t)j * DV + 1]);
          }
          a0 = __fdiv_rn(a0, (float)bk);
          a1 = __fdiv_rn(a1, (float)bk);
        }
        orow[4 * c + t] = make_float2(a0, a1);
      }
      continue;
    }
    const float inv = fmaxf(l_run[h], 1e-30f);
#pragma unroll
    for (int c = 0; c < VT; ++c)
      orow[4 * c + t] = make_float2(__fdiv_rn(acc[c][2 * h], inv),
                                    __fdiv_rn(acc[c][2 * h + 1], inv));
  }
}

template <int DV>
int launch(const float* q, const float* k, const float* v, float* out, int N,
           int Sq, int Sk, int D, int bq, int bk, int causal, float sm_scale,
           cudaStream_t stream) {
  const int Dp = (D + 15) / 16 * 16;
  const size_t smem = smem_bytes<DV>(Dp);
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  // 16-byte copies where every K and V row starts 16-byte aligned.
  const int vec = D % 4 == 0 && (uintptr_t)k % 16 == 0 &&
                  (uintptr_t)v % 16 == 0;
  const long long blocks = (long long)N * ((Sq + kRows - 1) / kRows);
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  flash_kernel<DV><<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, k, v, out, N, Sq, Sk, D, Dp, bq, bk, causal, causal ? Sk - Sq : 0,
      sm_scale, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Wide heads: the CUDA-core form.
//
// At head width 256 the tensor-core kernel's q operands and two K/V stages
// need more than the card's 227 KB of shared memory, and its fragments are
// instantiated per value width.  flash_wide_kernel runs every width of the
// cache-free kernels' rule (kernels/runtime.py, width_refusal) that the
// tensor-core kernel does not: one block of 4 warps per (slice, kWideRows q
// rows), a warp owning kWideRows / 4 whole rows.  A kv tile of kWideKt keys comes to shared
// memory (K rows padded by one word, so that lane j's reads of key j meet
// no bank twice); lane j scores key j against each of the warp's rows with
// f32 fused multiply-adds in d order, and owns V columns lane, lane + 32,
// ... of the output.  The online softmax takes the tensor-core kernel's
// float steps in its order (s = dot * sm_scale, NEG_INF masks, corr = 0
// while m is NEG_INF, l = l * corr + sum p, acc = acc * corr + P V), and
// rows that see no key get the reference's mean of V, as there.  What bounds
// this form: the f32 CUDA-core rate (67 TFLOP/s), for 2 * rows * keys *
// (D + Dv) flops a reachable tile pair, 2.5x the function's bound at the
// split-TF32 rate; nothing here is tuned beyond being right, and at width
// 256 it is slower than the plain version.  A tensor-core wide tile is
// ROADMAP B8.
constexpr int kMaxWide = 256;
constexpr int kWideRows = 16;
constexpr int kWideKt = 32;
constexpr int kWideRpw = kWideRows / kWarps;   // rows a warp owns
constexpr int kWideCols = kMaxWide / 32;       // V columns a lane owns

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

size_t wide_smem_bytes(int D, int Dv) {
  return ((size_t)kWideRows * D + (size_t)kWideKt * (D + 1) +
          (size_t)kWideKt * Dv) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
flash_wide_kernel(const float* __restrict__ q,    // [N, Sq, D]
                  const float* __restrict__ k,    // [N, Sk, D]
                  const float* __restrict__ v,    // [N, Sk, Dv]
                  float* __restrict__ out,        // [N, Sq, Dv]
                  int N, int Sq, int Sk, int D, int Dv, int bq, int bk,
                  int causal, int q_offset, float sm_scale) {
  const int n_qt = (Sq + kWideRows - 1) / kWideRows;
  const int qt = n_qt - 1 - (int)(blockIdx.x / N);
  const int n = (int)(blockIdx.x % N);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * kWideRows;
  const int KS = D + 1;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);       // [kWideRows, D]
  float* k_s = q_s + kWideRows * D;                  // [kWideKt, D + 1]
  float* v_s = k_s + kWideKt * KS;                   // [kWideKt, Dv]

  const float* qn = q + (size_t)n * Sq * D;
  const float* kn = k + (size_t)n * Sk * D;
  const float* vn = v + (size_t)n * Sk * Dv;
  for (int i = tid; i < kWideRows * D; i += kThreads) {
    const int r = i / D;
    q_s[i] = qn[(size_t)min(q0 + r, Sq - 1) * D + (i - r * D)];
  }

  const int rows_valid = min(kWideRows, Sq - q0);
  int last_key = Sk - 1;
  if (causal) last_key = min(last_key, q0 + rows_valid - 1 + q_offset);
  const int n_tiles = last_key < 0 ? 0 : last_key / kWideKt + 1;

  int rpos[kWideRpw];
  float m_run[kWideRpw], l_run[kWideRpw], acc[kWideRpw][kWideCols];
#pragma unroll
  for (int i = 0; i < kWideRpw; ++i) {
    rpos[i] = q0 + warp * kWideRpw + i + q_offset;
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int u = 0; u < kWideCols; ++u) acc[i][u] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kWideKt;
    const int rows = min(kWideKt, Sk - k0);   // rows past Sk: row Sk - 1
    __syncthreads();                          // the last tile is read
    for (int i = tid; i < kWideKt * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      k_s[r * KS + d] = kn[(size_t)(k0 + min(r, rows - 1)) * D + d];
    }
    for (int i = tid; i < kWideKt * Dv; i += kThreads) {
      const int r = i / Dv, c = i - r * Dv;
      v_s[i] = vn[(size_t)(k0 + min(r, rows - 1)) * Dv + c];
    }
    __syncthreads();

    const int col = k0 + lane;                // this lane's key
    const float* krow = k_s + lane * KS;
#pragma unroll
    for (int i = 0; i < kWideRpw; ++i) {
      const float* qrow = q_s + (warp * kWideRpw + i) * D;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = __fmaf_rn(qrow[d], krow[d], dot);
      float x = __fmul_rn(dot, sm_scale);
      if (causal && col > rpos[i]) x = kNegInf;
      if (col >= Sk) x = -INFINITY;
      const float m_new = fmaxf(m_run[i], warp_max(x));
      const float corr =
          m_run[i] == kNegInf ? 0.f : expf(__fsub_rn(m_run[i], m_new));
      const float p = expf(__fsub_rn(x, m_new));
      l_run[i] = __fadd_rn(__fmul_rn(l_run[i], corr), warp_sum(p));
      m_run[i] = m_new;
      float pv[kWideCols];
#pragma unroll
      for (int u = 0; u < kWideCols; ++u) pv[u] = 0.f;
      for (int j = 0; j < kWideKt; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
        const float* vrow = v_s + j * Dv;
#pragma unroll
        for (int u = 0; u < kWideCols; ++u)
          if (lane + 32 * u < Dv)
            pv[u] = __fmaf_rn(pj, vrow[lane + 32 * u], pv[u]);
      }
#pragma unroll
      for (int u = 0; u < kWideCols; ++u)
        acc[i][u] = __fadd_rn(__fmul_rn(acc[i][u], corr), pv[u]);
    }
  }

  float* on = out + (size_t)n * Sq * Dv;
#pragma unroll
  for (int i = 0; i < kWideRpw; ++i) {
    const int row = q0 + warp * kWideRpw + i;
    if (row >= Sq) continue;
    float* orow = on + (size_t)row * Dv;
    if (causal && rpos[i] < 0) {
      // A row that sees no key: the mean of V over the last of the
      // reference's kv tiles its q tile reaches (0 if there is none).
      const int last = (row / bq) * bq + q_offset + bq - 1;
      const int kb = last < 0 ? -1 : min(last / bk, Sk / bk - 1);
      for (int c = lane; c < Dv; c += 32) {
        float a = 0.f;
        if (kb >= 0) {
          for (int j = 0; j < bk; ++j)
            a = __fadd_rn(a, vn[((size_t)kb * bk + j) * Dv + c]);
          a = __fdiv_rn(a, (float)bk);
        }
        orow[c] = a;
      }
      continue;
    }
    const float inv = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int u = 0; u < kWideCols; ++u)
      if (lane + 32 * u < Dv) orow[lane + 32 * u] = __fdiv_rn(acc[i][u], inv);
  }
}

int launch_wide(const float* q, const float* k, const float* v, float* out,
                int N, int Sq, int Sk, int D, int Dv, int bq, int bk,
                int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(D, Dv);
  cudaError_t e = cudaFuncSetAttribute(
      flash_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks =
      (long long)N * ((Sq + kWideRows - 1) / kWideRows);
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  flash_wide_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, k, v, out, N, Sq, Sk, D, Dv, bq, bk, causal, causal ? Sk - Sq : 0,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  q [N, Sq, D], k [N, Sk, D],
// v [N, Sk, Dv], out [N, Sq, Dv], all contiguous f32; bq | Sq, bk | Sk,
// both at most 128.  The widths are the cache-free kernels' rule
// (kernels/runtime.py, width_refusal): D up to 160, or a multiple of 16 up
// to 256; Dv a multiple of 16 up to 256.  D at most 160 with Dv one of 16,
// 32, 64, 128, 160 runs the tensor-core kernel, every other width the
// CUDA-core form.  Returns the CUDA error code of the launch (0 on
// success); the caller raises on anything else.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int N, int Sq,
                                      int Sk, int D, int Dv, int bq, int bk,
                                      int causal, float sm_scale,
                                      void* stream) {
  if (N == 0 || Sq == 0) return 0;
  if (bq < 1 || bk < 1 || bq > kMaxTile || bk > kMaxTile || Sq % bq ||
      Sk % bk || N > 65535 || D < 1 || D > kMaxWide ||
      (D > kMaxD && D % 16) || Dv < 16 || Dv > kMaxWide || Dv % 16)
    return (int)cudaErrorInvalidValue;
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_LAUNCH(DV) \
  return launch<DV>(qf, kf, vf, of, N, Sq, Sk, D, bq, bk, causal, sm_scale, s)
  if (D <= kMaxD) switch (Dv) {
      case 16: FLASH_LAUNCH(16);
      case 32: FLASH_LAUNCH(32);
      case 64: FLASH_LAUNCH(64);
      case 128: FLASH_LAUNCH(128);
      case 160: FLASH_LAUNCH(160);
    }
  return launch_wide(qf, kf, vf, of, N, Sq, Sk, D, Dv, bq, bk, causal,
                     sm_scale, s);
#undef FLASH_LAUNCH
}
