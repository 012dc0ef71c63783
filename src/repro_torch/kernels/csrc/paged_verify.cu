// Fused paged BESF verify for Hopper (sm_90a): speculative decoding's
// draft-block scorer.  Each serving slot brings an Sq-token draft block
// (the last sampled token, then up to Sq-1 drafts) and every query is
// scored exactly as the Sq=1 paged decode would score it at its position.
//
// Replaces the TPU kernel src/repro/kernels/paged_verify.py:
// paged_bitstopper_verify (body _paged_verify_kernel, pl.pallas_call at
// :335).  It computes the same function; the oracle both are held against
// is src/repro/core/besf.py:besf_attention_verify_paged, which routes every
// (slot, query) row through the Sq=1 paged decode.
//
// Design.
//  * One thread block per (slot, KV head), holding that head's Sq x G query
//    rows.  Pages are walked in logical order: LATS carries each row's
//    prefix-max lower bound across pages, so one (slot, head) is never split
//    over blocks.  The structure is paged_decode.cu's: LATS margins and
//    scales in shared memory, integer partial scores, plane 0 of the next
//    reachable page copied ahead with cp.async.
//  * Union liveness.  Liveness is tracked per (query, KV head), but a
//    page's plane r is loaded once for the whole block while ANY query of
//    the block still has a live candidate on the page, and its V page once
//    when any query has a survivor.  Dots, LATS updates and the softmax
//    update run only for the queries that are still live (a dead query's
//    state stays frozen, as in the oracle).  A page no query can reach
//    (past every fill level, after every position, outside every window) is
//    not touched; a padding query (fill level 0) reaches no page.
//  * Causal masking inside the draft comes from per-query fill levels and
//    positions: query s sees tokens t <= q_pos[s] and t < lengths[s].
//  * Rounds are counted per (query, KV head) and written as rounds_h
//    [B, Hkv, Sq, MB]; the slot-wide count per query of the Pallas kernel is
//    their max over KV heads, taken by the wrapper (per head the live rounds
//    form a prefix; tests/test_torch_paged_verify.py proves the rule).
//  * Exactness: int32 partial scores, separate IEEE adds and multiplies
//    (__fadd_rn/__fmul_rn, built with -fmad=false), the finite NEG_INF of
//    -1e30, V quantized as rintf after a true division.  Every row runs the
//    very float operations of paged_decode.cu in the same order, so a real
//    query's output equals the Sq=1 decode kernel's at its position.
//
// What bounds it on the H100: bytes.  Per call it must read, per (slot, KV
// head, page), the planes that the most persistent query of the draft block
// keeps alive (the union over the block, bs/8 * D bytes per plane) and the V
// page when any query has a survivor (bs * Dv * 4 bytes).  Under union
// liveness that is about the bytes of ONE Sq=1 decode, not Sq times them;
// the arithmetic (one int dot per live query, plane and token) is far below
// the tensor-core line.  What the design does about it: each plane and V
// page is loaded once into shared memory and consumed there by every live
// query of the block, so the draft block costs the slot one walk over its
// pages instead of Sq walks.  Like paged_decode.cu it does not hide the
// latency of the dependent per-round plane loads (only plane 0 of the next
// page is fetched ahead); that is the next step for both kernels.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kLanesPerDot = 8;   // threads that share one (row, token) dot

__device__ __forceinline__ bool token_valid(int tpos, int qp, int len,
                                            int has_window, int window) {
  bool v = (tpos <= qp) && (tpos < len);
  if (has_window) v = v && (tpos > qp - window);
  return v;
}

// Asynchronous copy of one head's plane r of a page, bs/8 rows of D bytes at
// stride Hkv * D, into dst [bs/8, D] (4-byte pieces: D % 4 == 0).
__device__ __forceinline__ void copy_plane(uint8_t* dst, const uint8_t* kq,
                                           int phys, int r, int h, int bits,
                                           int bs8, int Hkv, int D) {
  const uint8_t* src = kq + (((size_t)phys * bits + r) * bs8 * Hkv + h) * D;
  const int words = D / 4;
  for (int i = threadIdx.x; i < bs8 * words; i += blockDim.x) {
    const int row = i / words, w = 4 * (i % words);
    __pipeline_memcpy_async(dst + row * D + w,
                            src + (size_t)row * Hkv * D + w, 4);
  }
  __pipeline_commit();
}

// Does some query of the block have a valid token on page j?  plo/phi hold
// each query's first and last reachable page (phi < plo: none).
__device__ __forceinline__ bool page_reached(const int* plo, const int* phi,
                                             int Sq, int j) {
  for (int s = 0; s < Sq; ++s)
    if (plo[s] <= j && j <= phi[s]) return true;
  return false;
}

__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const int32_t* __restrict__ q_int,  // [B*Sq, Hq, D]
                    const float* __restrict__ m_min,    // [bits, B*Sq, Hq]
                    const float* __restrict__ m_max,    // [bits, B*Sq, Hq]
                    const float* __restrict__ scale_total,   // [B*Sq, Hq]
                    const float* __restrict__ alpha_radius,  // [B*Sq, Hq]
                    const float* __restrict__ v_scale,       // [Hkv]
                    const uint8_t* __restrict__ kq,  // [P, bits, bs/8, Hkv, D]
                    const float* __restrict__ v,             // [P, bs, Hkv, Dv]
                    const int32_t* __restrict__ table,       // [B, MB]
                    const int32_t* __restrict__ lengths,     // [B, Sq]
                    const int32_t* __restrict__ q_pos,       // [B, Sq]
                    float* __restrict__ out,                 // [B*Sq, Hq, Dv]
                    int32_t* __restrict__ rounds_h,   // [B, Hkv, Sq, MB]
                    int8_t* __restrict__ surv,  // [B, Sq*Hq, MB*bs] or null
                    int B, int Sq, int Hq, int Hkv, int D, int Dv, int bits,
                    int bs, int MB, int min_rounds, int quantize_v,
                    int has_window, int window) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int R = Sq * G;                  // query rows of this block
  const int bs8 = bs / 8;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int hq0 = h * G;                 // first query head of this KV head
  const int RB = R * bs;
  const int GB = G * bs;

  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* q_s = reinterpret_cast<int32_t*>(smem);   // [R, D]
  int32_t* part_s = q_s + R * D;                      // [R, bs]
  int32_t* alive_s = part_s + RB;                     // [R, bs] 0/1
  int32_t* qp_s = alive_s + RB;                       // [Sq] position
  int32_t* len_s = qp_s + Sq;                         // [Sq] fill level
  int32_t* plo_s = len_s + Sq;                        // [Sq] first page
  int32_t* phi_s = plo_s + Sq;                        // [Sq] last page
  int32_t* live_s = phi_s + Sq;                       // [Sq] page still live
  int32_t* rnd_s = live_s + Sq;                       // [Sq] planes this page
  float* mlow_s = reinterpret_cast<float*>(rnd_s + Sq);  // [R]
  float* mrun_s = mlow_s + R;                         // [R]
  float* lrun_s = mrun_s + R;                         // [R]
  float* corr_s = lrun_s + R;                         // [R]
  float* eta_s = corr_s + R;                          // [R]
  float* ar_s = eta_s + R;                            // [R] alpha * radius
  float* st_s = ar_s + R;                             // [R] scale_total
  float* mmin_s = st_s + R;                           // [bits, R]
  float* mmax_s = mmin_s + bits * R;                  // [bits, R]
  float* p_s = mmax_s + bits * R;                     // [R, bs]
  float* acc_s = p_s + RB;                            // [R, Dv]
  float* v_s = acc_s + R * Dv;                        // [bs, Dv]
  uint8_t* plane_s = reinterpret_cast<uint8_t*>(v_s + bs * Dv);  // [bs8, D]
  uint8_t* plane0_s = plane_s + bs8 * D;  // [bs8, D]: a page's plane 0

  // Global flat row of (query s, local head g): (b*Sq + s)*Hq + hq0 + g.
  auto grow = [&](int i) -> size_t {
    return ((size_t)b * Sq + i / G) * Hq + hq0 + i % G;
  };

  for (int s = tid; s < Sq; s += nt) {
    const int len = lengths[(size_t)b * Sq + s];
    const int qp = q_pos[(size_t)b * Sq + s];
    // Valid tokens [lo, hi] are contiguous: the reachable pages of query s
    // are [lo / bs, min(hi / bs, MB - 1)], empty when hi < lo.
    const int lo = has_window ? max(0, qp - window + 1) : 0;
    const int hi = min(qp, len - 1);
    qp_s[s] = qp;
    len_s[s] = len;
    plo_s[s] = lo / bs;
    phi_s[s] = (hi < lo) ? -1 : min(hi / bs, MB - 1);
  }
  for (int i = tid; i < R * D; i += nt)
    q_s[i] = q_int[grow(i / D) * D + i % D];
  for (int i = tid; i < bits * R; i += nt) {
    const size_t src = (size_t)(i / R) * B * Sq * Hq + grow(i % R);
    mmin_s[i] = m_min[src];
    mmax_s[i] = m_max[src];
  }
  for (int i = tid; i < R; i += nt) {
    mlow_s[i] = kNegInf;
    mrun_s[i] = kNegInf;
    lrun_s[i] = 0.f;
    ar_s[i] = alpha_radius[grow(i)];
    st_s[i] = scale_total[grow(i)];
  }
  for (int i = tid; i < R * Dv; i += nt) acc_s[i] = 0.f;
  __syncthreads();

  int j_first = MB, j_last = -1;
  for (int s = 0; s < Sq; ++s)
    if (plo_s[s] <= phi_s[s]) {
      j_first = min(j_first, plo_s[s]);
      j_last = max(j_last, phi_s[s]);
    }
  int32_t* rounds_b = rounds_h + ((size_t)b * Hkv + h) * Sq * MB;
  for (int i = tid; i < Sq * MB; i += nt)
    if (i % MB < j_first || i % MB > j_last) rounds_b[i] = 0;
  if (j_first <= j_last)
    copy_plane(plane0_s, kq, table[(size_t)b * MB + j_first], 0, h, bits,
               bs8, Hkv, D);

  const int qmax = (1 << (bits - 1)) - 1;
  const float vs = v_scale[h];
  const int lane = tid % kLanesPerDot;
  const int pairs_per_pass = nt / kLanesPerDot;

  for (int j = j_first; j <= j_last; ++j) {
    __syncthreads();   // the previous page's epilogue is done with live_s
    if (!page_reached(plo_s, phi_s, Sq, j)) {
      for (int s = tid; s < Sq; s += nt) rounds_b[s * MB + j] = 0;
      continue;
    }
    const int phys = table[(size_t)b * MB + j];
    for (int i = tid; i < RB; i += nt) {
      const int s = i / GB;
      part_s[i] = 0;
      alive_s[i] = token_valid(j * bs + i % bs, qp_s[s], len_s[s],
                               has_window, window);
    }
    for (int s = tid; s < Sq; s += nt) {
      live_s[s] = plo_s[s] <= j && j <= phi_s[s];
      rnd_s[s] = 0;
    }
    __syncthreads();

    int any_live = 1;
    for (int r = 0; r < bits && any_live; ++r) {
      for (int s = tid; s < Sq; s += nt) rnd_s[s] += live_s[s];
      if (r > 0)
        copy_plane(plane_s, kq, phys, r, h, bits, bs8, Hkv, D);
      __pipeline_wait_prior(0);
      __syncthreads();
      const uint8_t* plane = (r == 0) ? plane0_s : plane_s;

      // Integer partial scores of the live queries: kLanesPerDot threads
      // per (row, token).  The plane in shared memory serves every query.
      const int wr = (r == 0) ? -(1 << (bits - 1)) : (1 << (bits - 1 - r));
      for (int base = 0; base < RB; base += pairs_per_pass) {
        const int pair = base + tid / kLanesPerDot;
        const bool mine = pair < RB && live_s[pair / GB];
        int dot = 0;
        if (mine) {
          const int i = pair / bs, t = pair % bs;
          const int32_t* qrow = q_s + i * D;
          const uint8_t* prow = plane + (t >> 3) * D;
          const int sh = t & 7;
          for (int d = lane; d < D; d += kLanesPerDot)
            dot += ((prow[d] >> sh) & 1) ? qrow[d] : 0;
        }
        for (int off = kLanesPerDot / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (mine && lane == 0) part_s[pair] += wr * dot;
      }
      __syncthreads();
      // Plane 0 of this page has been consumed: fetch the next reachable
      // page's (read whatever LATS decides, every reachable page runs round
      // 0 for the queries that reach it).
      if (r == 0) {
        int jn = j + 1;
        while (jn <= j_last && !page_reached(plo_s, phi_s, Sq, jn)) ++jn;
        if (jn <= j_last)
          copy_plane(plane0_s, kq, table[(size_t)b * MB + jn], 0, h, bits,
                     bs8, Hkv, D);
      }

      // LATS threshold per live row: prefix max of the live lower bounds.
      for (int i = tid; i < R; i += nt) {
        if (!live_s[i / G]) continue;
        const float mmin = mmin_s[r * R + i];
        float low_here = kNegInf;
        for (int t = 0; t < bs; ++t)
          if (alive_s[i * bs + t])
            low_here = fmaxf(low_here,
                             __fadd_rn(__int2float_rn(part_s[i * bs + t]),
                                       mmin));
        const float mlow_new = fmaxf(mlow_s[i], low_here);
        mlow_s[i] = mlow_new;
        eta_s[i] = __fsub_rn(mlow_new, ar_s[i]);
      }
      __syncthreads();

      if (r >= min_rounds - 1)
        for (int k = tid; k < RB; k += nt) {
          const int i = k / bs;
          if (alive_s[k] && live_s[i / G]) {
            const float upper = __fadd_rn(__int2float_rn(part_s[k]),
                                          mmax_s[r * R + i]);
            alive_s[k] = upper >= eta_s[i];
          }
        }
      __syncthreads();
      int still = 0;
      for (int s = tid; s < Sq; s += nt) {
        if (live_s[s]) {
          int a = 0;
          for (int k = s * GB; k < (s + 1) * GB && !a; ++k) a = alive_s[k];
          live_s[s] = a;
        }
        still |= live_s[s];
      }
      any_live = __syncthreads_or(still);
    }
    // A query's page dies only when none of its tokens is alive, so after
    // the loop its survivors are exactly its alive tokens and live_s says
    // whether it has any.
    for (int s = tid; s < Sq; s += nt) rounds_b[s * MB + j] = rnd_s[s];
    if (surv != nullptr)
      for (int k = tid; k < RB; k += nt)
        surv[grow(k / bs) * MB * bs + j * bs + k % bs] = (int8_t)alive_s[k];
    if (!any_live) continue;

    // Epilogue: online softmax over each live query's survivors, then S x V
    // with the V page read once for the whole block.
    for (int i = tid; i < R; i += nt) {
      if (!live_s[i / G]) continue;
      const float st = st_s[i];
      float mx = kNegInf;
      for (int t = 0; t < bs; ++t)
        if (alive_s[i * bs + t])
          mx = fmaxf(mx, __fmul_rn(__int2float_rn(part_s[i * bs + t]), st));
      const float m_prev = mrun_s[i];
      const float m_new = fmaxf(m_prev, mx);
      float lsum = 0.f;
      for (int t = 0; t < bs; ++t) {
        float p = 0.f;
        if (alive_s[i * bs + t])
          p = expf(__fsub_rn(
              __fmul_rn(__int2float_rn(part_s[i * bs + t]), st), m_new));
        p_s[i * bs + t] = p;
        lsum = __fadd_rn(lsum, p);
      }
      const float corr = (m_prev == kNegInf) ? 0.f : expf(m_prev - m_new);
      lrun_s[i] = __fadd_rn(__fmul_rn(lrun_s[i], corr), lsum);
      corr_s[i] = corr;
      mrun_s[i] = m_new;
    }
    for (int i = tid; i < bs * Dv; i += nt) {
      const int t = i / Dv, dv = i % Dv;
      float x = v[(((size_t)phys * bs + t) * Hkv + h) * Dv + dv];
      if (quantize_v) {
        float qv = rintf(__fdiv_rn(x, vs));
        qv = fminf(fmaxf(qv, (float)(-qmax - 1)), (float)qmax);
        x = __fmul_rn(qv, vs);
      }
      v_s[i] = x;
    }
    __syncthreads();
    for (int k = tid; k < R * Dv; k += nt) {
      const int i = k / Dv, dv = k % Dv;
      if (!live_s[i / G]) continue;
      float sum = 0.f;
      for (int t = 0; t < bs; ++t)
        sum = __fadd_rn(sum, __fmul_rn(p_s[i * bs + t], v_s[t * Dv + dv]));
      acc_s[k] = __fadd_rn(__fmul_rn(acc_s[k], corr_s[i]), sum);
    }
  }

  __syncthreads();
  for (int k = tid; k < R * Dv; k += nt)
    out[grow(k / Dv) * Dv + k % Dv] =
        __fdiv_rn(acc_s[k], fmaxf(lrun_s[k / Dv], 1e-30f));
}

size_t smem_bytes(int Sq, int G, int D, int Dv, int bs, int bits) {
  const size_t R = (size_t)Sq * G;
  const size_t words = R * D + 3 * R * bs + 6 * (size_t)Sq + 7 * R +
                       2 * (size_t)bits * R + R * Dv + (size_t)bs * Dv;
  return words * 4 + 2 * (size_t)(bs / 8) * D;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns the CUDA error code of
// the launch (0 on success); the caller raises on anything else.
extern "C" int paged_verify_launch(
    const void* q_int, const void* m_min, const void* m_max,
    const void* scale_total, const void* alpha_radius, const void* v_scale,
    const void* kq, const void* v, const void* table, const void* lengths,
    const void* q_pos, void* out, void* rounds_h, void* surv, int B, int Sq,
    int Hq, int Hkv, int D, int Dv, int bits, int bs, int MB, int min_rounds,
    int quantize_v, int has_window, int window, void* stream) {
  if (B == 0 || Sq == 0 || Hkv == 0) return 0;
  const size_t smem = smem_bytes(Sq, Hq / Hkv, D, Dv, bs, bits);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_verify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(Hkv, B);
  paged_verify_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)q_int, (const float*)m_min, (const float*)m_max,
      (const float*)scale_total, (const float*)alpha_radius,
      (const float*)v_scale, (const uint8_t*)kq, (const float*)v,
      (const int32_t*)table, (const int32_t*)lengths, (const int32_t*)q_pos,
      (float*)out, (int32_t*)rounds_h, (int8_t*)surv, B, Sq, Hq, Hkv, D, Dv,
      bits, bs, MB, min_rounds, quantize_v, has_window, window);
  return (int)cudaGetLastError();
}
