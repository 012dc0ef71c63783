// Dense flash attention for Hopper (sm_90a): online softmax over kv tiles,
// causal tile skip, f32 throughout.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_single (body _flash_kernel).  It computes the same
// function; the oracle both are held against is the dense softmax of
// src/repro/kernels/ref.py:flash_attention.
//
// Design.
//  * One thread block per (slice, q tile) and one launch for all slices.  A
//    loop over the kv tiles in order takes the place of the sequential kv
//    grid axis, so the running max m, normalizer l and accumulator acc stay
//    in registers.  Tiles are the reference's: bq = bk = min(128, S).
//  * 256 threads in a 16 x 16 grid; thread (ty, tx) owns rows ty + 16 i and
//    columns tx + 16 j (i, j < 8) of the bq x bk score tile, and the same
//    rows of acc at columns tx + 16 c.  A row's 16 threads sit in one half
//    warp, so its max and sum are shuffle reductions, and every thread of
//    the row holds the row's m and l.
//  * Shared memory: the q tile, the K tile (then the V tile, in the same
//    space), and the probability tile P, which the P x V product reads.
//    Rows of q and K are padded to D + 1 words so that neither the loads nor
//    the dot products conflict on banks.  Widths over 128 (stablelm-12b's
//    160) would not fit the card's 227 KB: the K tile then comes in two
//    halves of head_dim and the V tile in two halves of its columns, one
//    after the other in the same space (the sums over d and over kv tokens
//    keep their order).
//  * The reference's float steps, in its order: s = dot * sm_scale, masked
//    entries set to the finite NEG_INF = -1e30, m_new = max(m_prev, max s),
//    p = exp(s - m_new) (masked entries included, as in the reference),
//    corr = 0 while m_prev is NEG_INF, l = l * corr + sum p,
//    acc = acc * corr + P V, out = acc / max(l, 1e-30).  Dots are f32 FMAs
//    on the CUDA cores: TF32 would break the reference's f32 tolerance.
//    Sums run in another order than the plain version's, so the two agree
//    within a stated tolerance, not bit for bit.
//
// What bounds it on the H100: operations.  Per reachable tile pair it does
// 2 * bq * bk * (D + Dv) flops on f32 CUDA cores (67 TFLOP/s), and reads
// only q, K, V once and writes out once from device memory.  The simple
// design keeps one block of 8 warps per SM (the tiles need about 140 KB of
// shared memory) and loads each K and V tile only after the previous tile's
// products, so it runs well below the f32 peak; double-buffered tile loads
// and tensor-core MMA in a precision that keeps the tolerance are the next
// steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kGrid = 16;    // threads per row group and row groups
constexpr int kMicro = 8;    // rows (and columns) of the tile per thread
constexpr int kMaxTile = kGrid * kMicro;   // 128
constexpr int kMaxD = 160;   // head widths the tiles fit in shared memory

__device__ __forceinline__ float row_max(float x) {
  for (int off = kGrid / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int off = kGrid / 2; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// KCH: chunks of the K tile, 1 (head_dim up to 128) or 2 (its halves).
template <int DV, int KCH>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const float* __restrict__ q,    // [N, Sq, D]
             const float* __restrict__ k,    // [N, Sk, D]
             const float* __restrict__ v,    // [N, Sk, DV]
             float* __restrict__ out,        // [N, Sq, DV]
             int Sq, int Sk, int D, int bq, int bk, int causal, int q_offset,
             float sm_scale) {
  constexpr int kCols = DV / kGrid;
  // V columns of a thread per V-tile chunk: all, or half beyond 128.
  constexpr int kVc = DV <= 128 ? kCols : kCols / 2;
  constexpr int kVw = kVc * kGrid;          // V-tile chunk width
  const int qi = blockIdx.x;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % kGrid, ty = tid / kGrid;
  const int ld = D + 1;
  const int kc = KCH == 1 ? D : (D + 1) / 2;   // K-tile chunk width
  const int ldk = kc + 1;    // K-tile rows, padded like q's
  const int ldp = bk + 16;   // rows ty, ty + 1 of P land 16 banks apart
  const int n_kb = Sk / bk;
  const int q_start = qi * bq + q_offset;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                                  // [bq, ld]
  float* kv_s = q_s + bq * ld;              // [bk, ldk] / [bk, kVw]
  float* p_s = kv_s + bk * (ldk > kVw ? ldk : kVw);   // [bq, ldp]

  const float* qn = q + ((size_t)n * Sq + (size_t)qi * bq) * D;
  for (int i = tid; i < bq * D; i += kThreads)
    q_s[(i / D) * ld + i % D] = qn[i];

  // Rows and columns past a small tile read a clamped index; their values
  // are never written out and never enter a valid row's reductions.
  int rr[kMicro], cc[kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    rr[i] = min(ty + kGrid * i, bq - 1);
    cc[i] = min(tx + kGrid * i, bk - 1);
  }

  float m_run[kMicro], l_run[kMicro], acc[kMicro][kCols];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k_start = kb * bk;
    // Causal: a tile is live iff its first column is visible to its last
    // row; later tiles start further right, so none of them is.
    if (causal && k_start > q_start + bq - 1) break;
    const float* kt = k + ((size_t)n * Sk + k_start) * D;
    float s[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int ch = 0; ch < KCH; ++ch) {
      const int d0 = ch * kc, w = KCH == 1 ? D : min(kc, D - d0);
      __syncthreads();   // the previous chunk's or tile's reads are done
      if constexpr (KCH == 1) {
        for (int i = tid; i < bk * D; i += kThreads)
          kv_s[(i / D) * ld + i % D] = kt[i];
      } else {
        for (int i = tid; i < bk * w; i += kThreads)
          kv_s[(i / w) * ldk + i % w] = kt[(size_t)(i / w) * D + d0 + i % w];
      }
      __syncthreads();
      for (int dd = 0; dd < w; ++dd) {
        float a[kMicro], b[kMicro];
#pragma unroll
        for (int i = 0; i < kMicro; ++i) {
          a[i] = q_s[rr[i] * ld + d0 + dd];
          b[i] = kv_s[cc[i] * ldk + dd];
        }
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j)
            s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int row = ty + kGrid * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const int col = tx + kGrid * j;
        float x = __fmul_rn(s[i][j], sm_scale);
        if (causal && q_start + row < k_start + col) x = kNegInf;
        s[i][j] = x;
        if (col < bk) mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m_run[i], row_max(mx));
      float lsum = 0.f;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const int col = tx + kGrid * j;
        const float p = (col < bk) ? expf(__fsub_rn(s[i][j], m_new)) : 0.f;
        lsum = __fadd_rn(lsum, p);
        if (row < bq && col < bk) p_s[row * ldp + col] = p;
      }
      const float corr =
          (m_run[i] == kNegInf) ? 0.f : expf(__fsub_rn(m_run[i], m_new));
      l_run[i] = __fadd_rn(__fmul_rn(l_run[i], corr), row_sum(lsum));
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = __fmul_rn(acc[i][c], corr);
    }
    const float* vt = v + ((size_t)n * Sk + k_start) * DV;
#pragma unroll
    for (int c0 = 0; c0 < kCols; c0 += kVc) {
      __syncthreads();   // K (or the previous V chunk) reads done, P written
      if constexpr (kVc == kCols) {
        for (int i = tid; i < bk * DV; i += kThreads) kv_s[i] = vt[i];
      } else {
        for (int i = tid; i < bk * kVw; i += kThreads)
          kv_s[i] = vt[(size_t)(i / kVw) * DV + c0 * kGrid + i % kVw];
      }
      __syncthreads();
      for (int kk = 0; kk < bk; ++kk) {
        float a[kMicro], b[kVc];
#pragma unroll
        for (int i = 0; i < kMicro; ++i) a[i] = p_s[rr[i] * ldp + kk];
#pragma unroll
        for (int c = 0; c < kVc; ++c) b[c] = kv_s[kk * kVw + tx + kGrid * c];
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int c = 0; c < kVc; ++c)
            acc[i][c0 + c] = fmaf(a[i], b[c], acc[i][c0 + c]);
      }
    }
  }

  float* on = out + ((size_t)n * Sq + (size_t)qi * bq) * DV;
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int row = ty + kGrid * i;
    if (row >= bq) continue;
    const float inv = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      on[(size_t)row * DV + tx + kGrid * c] = __fdiv_rn(acc[i][c], inv);
  }
}

size_t smem_bytes(int D, int Dv, int bq, int bk) {
  const int ldk = (D <= 128 ? D : (D + 1) / 2) + 1;
  const int vw = Dv <= 128 ? Dv : Dv / 2;
  return ((size_t)bq * (D + 1) + (size_t)bk * (ldk > vw ? ldk : vw) +
          (size_t)bq * (bk + 16)) * sizeof(float);
}

template <int DV>
int launch(const float* q, const float* k, const float* v, float* out, int N,
           int Sq, int Sk, int D, int bq, int bk, int causal, float sm_scale,
           cudaStream_t stream) {
  const auto kernel = D <= 128 ? flash_kernel<DV, 1> : flash_kernel<DV, 2>;
  const size_t smem = smem_bytes(D, DV, bq, bk);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Sq / bq, N);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, k, v, out, Sq, Sk, D, bq, bk, causal, causal ? Sk - Sq : 0,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  q [N, Sq, D], k [N, Sk, D],
// v [N, Sk, Dv], out [N, Sq, Dv], all contiguous f32; bq | Sq, bk | Sk,
// both at most 128; D at most 160; Dv one of 16, 32, 64, 128, 160.
// Returns the CUDA error code of the launch (0 on success); the caller
// raises on anything else.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int N, int Sq,
                                      int Sk, int D, int Dv, int bq, int bk,
                                      int causal, float sm_scale,
                                      void* stream) {
  if (N == 0 || Sq == 0) return 0;
  if (bq < 1 || bk < 1 || bq > kMaxTile || bk > kMaxTile || Sq % bq ||
      Sk % bk || N > 65535 || D < 1 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_LAUNCH(DV) \
  return launch<DV>(qf, kf, vf, of, N, Sq, Sk, D, bq, bk, causal, sm_scale, s)
  switch (Dv) {
    case 16: FLASH_LAUNCH(16);
    case 32: FLASH_LAUNCH(32);
    case 64: FLASH_LAUNCH(64);
    case 128: FLASH_LAUNCH(128);
    case 160: FLASH_LAUNCH(160);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_LAUNCH
}
