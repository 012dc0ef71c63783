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
// Design: the decode kernel's page walk (paged_walk.cuh), one walk warp per
// row.
//  * A row is a (draft query, query head) pair with its own fill level,
//    position and page range.  One thread block per (KV head, slot, query
//    group); a group holds whole queries, at most max(1, 4 / G) of them, so
//    a block has at most four rows at G <= 4 and one query's G rows
//    beyond.  Walk warps (min(rows, 4), looping over rows beyond that) run
//    each row's page exactly as the decode kernel runs a query head: the
//    same dots, LATS passes, verdict and epilogue, from the same header, so
//    a real query equals the decode at its position bit for bit by
//    construction.  Keeping a query's heads in one block keeps the max over
//    them (rounds_h) inside one block.
//  * The block walks the union of its rows' page ranges in logical order,
//    from a list of the pages some row reaches (a page no row reaches
//    issues no copy).  All planes of a listed page are copied with cp.async
//    two pages ahead onto mbarriers, as in the decode.  On a listed page
//    outside a row's range the row is skipped: its LATS bound, softmax
//    state and accumulator stay untouched, its round count there is 0 and
//    it has no survivors.  A padding query (fill level 0) reaches no page.
//  * Union V: a page's V is copied when any row of the block has a
//    survivor there.  The epilogue warps run, one page behind the walk, the
//    softmax of every row whose query has a survivor on the page: the rows
//    the decode at that query's position would run.
//  * Rounds are per row; a query's count per KV head is the max over its G
//    rows, written as rounds_h [B, Hkv, Sq, MB]; the wrapper takes the max
//    over KV heads (per head the live rounds form a prefix;
//    tests/test_torch_paged_verify.py proves the rule).
//  * Launches given a survivors output add the plane and V bytes they
//    request to a device counter (paged_verify_copied_bytes).  Physical
//    plane bytes are every plane of every page some row of a block
//    reaches, once per block: a (slot, KV head) with two query groups reads
//    its pages twice.
//
// What bounds it on the H100: as for the decode, the latency of a row's
// serial page walk, far above the bytes one call needs (the planes the most
// persistent query keeps alive and the V pages with a survivor, once per
// slot and KV head).  The design gives each row of a draft block its own
// walk warp, so a block's page costs about one decode page whatever Sq is
// at G = 1, and adds blocks (query groups) rather than serial work.
//
// Pages of more than 256 tokens run the striped walk of paged_walk.cuh, as
// the decode does, with the same query groups.
//
// Limits, those of the decode: bs <= 1024, bits <= 16, D <= 256 and a
// multiple of 16, Dv a multiple of 4, pools 16-byte aligned, the block's
// shared memory within the card's 227 KB; the wrapper raises on anything
// else (on the last through the launch's error).

#include "paged_walk.cuh"

namespace {

using namespace walk;

// Queries of a block's group, and the rows a block is laid out for.
__host__ __device__ inline int group_queries(int G) {
  return G < 4 ? 4 / G : 1;
}

// NB: planes rounded up to a multiple of 4 (4, 8, 12 or 16).  KT: token
// chunks of 32 a walk lane may hold (1 for pages of up to 32 tokens, 8 for
// up to 256).
template <int NB, int KT>
__global__ void __launch_bounds__(kMaxThreads, 1)
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
  const int QG = group_queries(G);
  const int s0 = blockIdx.z * QG;        // the group's first query
  const int nq = min(QG, Sq - s0);       // its queries
  const int RL = QG * G;                 // rows the block is laid out for
  const int R = nq * G;                  // its rows: row r = (s0 + r/G, r%G)
  const int bs8 = bs / 8;
  const int W = D / 4;                   // plane words per byte row
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nwk = walk_warps(RL);        // warps 0 .. nwk-1 walk the pages
  const int eph = epilogue_share(RL);    // epilogue warps per walk warp
  const int nep = nwk * eph;             // warps nwk .. nwk+nep-1
  const int hq0 = h * G;                 // first query head of this KV head
  const int RB = RL * bs;
  const int plane_bytes = bits * bs8 * D;   // one page; D % 16 == 0

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* pbar = reinterpret_cast<uint64_t*>(smem);      // [2] planes
  uint64_t* vbar = pbar + 2;                               // [2] V
  uint8_t* pbuf = smem + 32;                               // [2, bits, bs8, D]
  float* vbuf = reinterpret_cast<float*>(pbuf + 2 * plane_bytes);  // [2,bs,Dv]
  float* acc_s = vbuf + 2 * bs * Dv;                       // [RL, Dv]
  uint32_t* qlo_s = reinterpret_cast<uint32_t*>(acc_s + RL * Dv);  // [RL, W]
  uint32_t* qhi_s = qlo_s + RL * W;                        // [RL, W]
  // A page's final partials and survivors, written by the walk warps in
  // its iteration and read by the epilogue warps in the next: three buffers.
  int32_t* fin_s = reinterpret_cast<int32_t*>(qhi_s + RL * W);  // [3, RL, bs]
  int32_t* sv_s = fin_s + 3 * RB;                          // [3, RL, bs] 0/1
  int32_t* rounds_s = sv_s + 3 * RB;                       // [2, RL]
  int32_t* live_s = rounds_s + 2 * RL;                     // [2, RL]
  int32_t* tab_s = live_s + 2 * RL;                        // [MB]
  int32_t* pg_s = tab_s + MB;                              // [MB] pages walked
  int32_t* qry_s = pg_s + MB;          // [4, QG]: position, fill, plo, phi
  int32_t* npg_s = qry_s + 4 * QG;                         // [1] pages walked
  float* mmin_s = reinterpret_cast<float*>(npg_s + 1);     // [bits, RL]
  float* mmax_s = mmin_s + bits * RL;                      // [bits, RL]
  float* mlow_s = mmax_s + bits * RL;                      // [RL]
  float* ar_s = mlow_s + RL;                               // [RL]
  float* st_s = ar_s + RL;                                 // [RL]
  float* mrun_s = st_s + RL;                               // [eph, RL]
  float* lrun_s = mrun_s + eph * RL;                       // [eph, RL]
  float* p_s = lrun_s + eph * RL;                          // [nep, bs]

  // Global row of block row r: (b*Sq + s0 + r/G)*Hq + hq0 + r%G.
  auto grow = [&](int r) -> size_t {
    return ((size_t)b * Sq + s0 + r / G) * Hq + hq0 + r % G;
  };

  // The planes come from one warp, V from every epilogue warp.
  if (tid < 4) mbar_init(pbar + tid, tid < 2 ? 32 : nep * 32);
  if (warp == 0) {
    // Every lane takes the group's page ranges; lane s < nq keeps query
    // s's.  Then the list of pages some query reaches, in logical order;
    // the rounds of every other page are 0.
    int plo[4], phi[4];
    for (int s = 0; s < nq; ++s) {
      const int qp = q_pos[(size_t)b * Sq + s0 + s];
      const int len = lengths[(size_t)b * Sq + s0 + s];
      page_range(qp, len, has_window, window, bs, MB, plo + s, phi + s);
      if (lane == s) {
        qry_s[s] = qp;
        qry_s[QG + s] = len;
        qry_s[2 * QG + s] = plo[s];
        qry_s[3 * QG + s] = phi[s];
      }
    }
    int n = 0;
    for (int j0 = 0; j0 < MB; j0 += 32) {
      const int j = j0 + lane;
      bool reached = false;
      for (int s = 0; s < nq; ++s)
        reached |= plo[s] <= j && j <= phi[s];
      reached &= j < MB;
      const unsigned m = __ballot_sync(kFull, reached);
      if (reached) pg_s[n + __popc(m & ((1u << lane) - 1))] = j;
      else if (j < MB)
        for (int s = 0; s < nq; ++s)
          rounds_h[(((size_t)b * Hkv + h) * Sq + s0 + s) * MB + j] = 0;
      n += __popc(m);
    }
    if (lane == 0) *npg_s = n;
  }
  for (int i = tid; i < MB; i += blockDim.x)
    tab_s[i] = table[(size_t)b * MB + i];
  for (int i = tid; i < R * W; i += blockDim.x) {
    const int32_t* qs = q_int + grow(i / W) * D + 4 * (i % W);
    uint32_t l = 0, u = 0;
    for (int c = 0; c < 4; ++c) {
      l |= (uint32_t)(qs[c] & 255) << (8 * c);
      u |= (uint32_t)((qs[c] >> 8) & 255) << (8 * c);
    }
    qlo_s[i] = l;
    qhi_s[i] = u;
  }
  for (int i = tid; i < bits * R; i += blockDim.x) {
    const size_t src = (size_t)(i / R) * B * Sq * Hq + grow(i % R);
    mmin_s[(i / R) * RL + i % R] = m_min[src];
    mmax_s[(i / R) * RL + i % R] = m_max[src];
  }
  for (int r = tid; r < R; r += blockDim.x) {
    mlow_s[r] = kNegInf;
    ar_s[r] = alpha_radius[grow(r)];
    st_s[r] = scale_total[grow(r)];
  }
  for (int i = tid; i < eph * RL; i += blockDim.x) {
    mrun_s[i] = kNegInf;
    lrun_s[i] = 0.f;
  }
  for (int i = tid; i < R * Dv; i += blockDim.x) acc_s[i] = 0.f;
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();
  const int npg = *npg_s;
  // The planes of the first two pages; the epilogue warps request every
  // later page two pages ahead.
  const bool count = surv != nullptr;       // count the requested bytes
  if (warp == 0 && npg > 0)
    copy_planes(pbuf, kq, tab_s[pg_s[0]], h, bits, bs8, Hkv, D, pbar, lane,
                count);
  if (warp == 0 && npg > 1)
    copy_planes(pbuf + plane_bytes, kq, tab_s[pg_s[1]], h, bits, bs8, Hkv, D,
                pbar + 1, lane, count);

  const WalkLane wl(bs, lane);
  // An epilogue warp's row slot and its share of the V columns.
  const int ew = warp - nwk;
  const int hs = ew / eph, cpart = ew % eph;

  const int qmax = (1 << (bits - 1)) - 1;
  const float vs = v_scale[h];
  const float vs_recip = recip(vs);
  const bool vs_fast = vs >= 0x1p-32f && vs <= 0x1p32f;
  unsigned prev_live = 0;     // bit s: query s had a survivor on the last page
  uint32_t vloads = 0;        // bit k: parity of the next V load into buffer k

  for (int i = 0; i <= npg; ++i) {
    const int cur = i & 1;
    const int fb = i % 3;                    // this page's fin_s/sv_s
    const bool page = i < npg;
    const int j = page ? pg_s[i] : -1;

    if (warp < nwk) {
      // ---- Walk warps: the rounds of page j, one warp per row.
      if (page) {
        mbar_wait(pbar + cur, (i >> 1) & 1);
        const uint32_t* pw = reinterpret_cast<const uint32_t*>(
            pbuf + cur * plane_bytes);
        for (int r = warp; r < R; r += nwk) {
          const int s = r / G;
          if (j < qry_s[2 * QG + s] || j > qry_s[3 * QG + s]) {
            // Outside the row's range: untouched, 0 rounds, no survivors.
            if (lane == 0) {
              rounds_s[cur * RL + r] = 0;
              live_s[cur * RL + r] = 0;
            }
            continue;
          }
          unsigned alive = page_alive<KT>(wl, j, bs, qry_s[s], qry_s[QG + s],
                                          has_window, window);
          int prt[KT][NB];
          plane_dots<NB, KT>(prt, wl, pw, qlo_s + r * W, qhi_s + r * W, bits,
                             bs, bs8, W);
          float mlow = mlow_s[r];
          const int rounds = lats_passes<NB, KT>(
              prt, alive, mlow, ar_s[r], mmin_s + r, mmax_s + r, RL, bits,
              min_rounds);
          const bool any = page_verdict<NB, KT>(
              prt, alive, wl, bs, fin_s + (fb * RL + r) * bs,
              sv_s + (fb * RL + r) * bs,
              surv == nullptr ? nullptr : surv + grow(r) * MB * bs + j * bs);
          if (lane == 0) {
            mlow_s[r] = mlow;
            rounds_s[cur * RL + r] = rounds;
            live_s[cur * RL + r] = any;
          }
        }
      }
    }
    // The page barrier: every row's verdict on page j is in; the walk warps
    // are done with the previous page's planes and the epilogue warps with
    // V of the page before.
    __syncthreads();
    if (warp < nwk) continue;

    // ---- Epilogue warps: the planes of page i+2 (into the buffer of page
    // i, whose rounds are over), page i's verdict and V request, then page
    // i-1's online softmax over its survivors and S x V.
    if (ew == nep - 1 && i + 2 < npg)
      copy_planes(pbuf + cur * plane_bytes, kq, tab_s[pg_s[i + 2]], h, bits,
                  bs8, Hkv, D, pbar + cur, lane, count);
    unsigned live = 0;
    if (page) {
      for (int s = 0; s < nq; ++s) {
        int rmax = 0;
        for (int g = 0; g < G; ++g) {
          rmax = max(rmax, rounds_s[cur * RL + s * G + g]);
          live |= (unsigned)(live_s[cur * RL + s * G + g] != 0) << s;
        }
        if (ew == 0 && lane == 0)
          rounds_h[(((size_t)b * Hkv + h) * Sq + s0 + s) * MB + j] = rmax;
      }
      if (live)
        copy_v(vbuf + cur * bs * Dv, v, tab_s[j], h, bs, Hkv, Dv, vbar + cur,
               ew * 32 + lane, nep * 32, count);
    }
    if (prev_live) {
      const int pc = cur ^ 1;
      mbar_wait(vbar + pc, (vloads >> pc) & 1);
      vloads ^= 1u << pc;
      float* vp = vbuf + pc * bs * Dv;
      if (quantize_v)
        quantize_v_page(vp,
                        v + ((size_t)tab_s[pg_s[i - 1]] * bs * Hkv + h) * Dv,
                        bs, Dv, Hkv, ew * 32 + lane, nep * 32, vs, vs_recip,
                        vs_fast, qmax);
      const int pfb = (fb + 2) % 3;         // page i-1's fin_s/sv_s
      for (int r = hs; r < R; r += nwk)
        if ((prev_live >> (r / G)) & 1)
          softmax_row<KT>(fin_s + (pfb * RL + r) * bs,
                          sv_s + (pfb * RL + r) * bs, st_s[r], p_s + ew * bs,
                          vp, mrun_s + cpart * RL + r, lrun_s + cpart * RL + r,
                          acc_s + r * Dv, bs, Dv, cpart, eph, lane);
    }
    prev_live = live;
  }

  // Each epilogue lane writes the columns it accumulated.
  if (warp >= nwk)
    for (int r = hs; r < R; r += nwk)
      for (int dv = cpart * 32 + lane; dv < Dv; dv += eph * 32)
        out[grow(r) * Dv + dv] = __fdiv_rn(
            acc_s[r * Dv + dv], fmaxf(lrun_s[cpart * RL + r], 1e-30f));
}

int block_threads(int G) {
  const int RL = group_queries(G) * G;
  return 32 * walk_warps(RL) * (1 + epilogue_share(RL));
}

size_t smem_bytes(int G, int D, int Dv, int bs, int bits, int MB) {
  const size_t QG = group_queries(G), RL = QG * G;
  const size_t eph = epilogue_share((int)RL);
  const size_t nep = walk_warps((int)RL) * eph;
  const size_t words = 2 * (size_t)bs * Dv + RL * Dv + 2 * RL * (D / 4) +
                       6 * RL * bs + 4 * RL + 2 * (size_t)MB + 4 * QG + 1 +
                       2 * (size_t)bits * RL + 3 * RL + 2 * eph * RL +
                       nep * bs;
  return 32 + 2 * (size_t)bits * (bs / 8) * D + words * 4;
}

#define PV_PARAMS                                                             \
  const void *q_int, const void *m_min, const void *m_max,                    \
      const void *scale_total, const void *alpha_radius,                      \
      const void *v_scale, const void *kq, const void *v, const void *table,  \
      const void *lengths, const void *q_pos, void *out, void *rounds_h,      \
      void *surv, int B, int Sq, int Hq, int Hkv, int D, int Dv, int bits,    \
      int bs, int MB, int min_rounds, int quantize_v, int has_window,         \
      int window, void *stream
#define PV_ARGS                                                              \
  q_int, m_min, m_max, scale_total, alpha_radius, v_scale, kq, v, table,     \
      lengths, q_pos, out, rounds_h, surv, B, Sq, Hq, Hkv, D, Dv, bits, bs,  \
      MB, min_rounds, quantize_v, has_window, window, stream

template <int NB, int KT>
int launch(PV_PARAMS) {
  const int G = Hq / Hkv;
  const size_t smem = smem_bytes(G, D, Dv, bs, bits, MB);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_verify_kernel<NB, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int QG = group_queries(G);
  dim3 grid(Hkv, B, (Sq + QG - 1) / QG);
  paged_verify_kernel<NB, KT><<<grid, block_threads(G), smem,
                                (cudaStream_t)stream>>>(
      (const int32_t*)q_int, (const float*)m_min, (const float*)m_max,
      (const float*)scale_total, (const float*)alpha_radius,
      (const float*)v_scale, (const uint8_t*)kq, (const float*)v,
      (const int32_t*)table, (const int32_t*)lengths, (const int32_t*)q_pos,
      (float*)out, (int32_t*)rounds_h, (int8_t*)surv, B, Sq, Hq, Hkv, D, Dv,
      bits, bs, MB, min_rounds, quantize_v, has_window, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns the CUDA error code of
// the launch (0 on success); the caller raises on anything else.
extern "C" int paged_verify_launch(PV_PARAMS) {
  if (B == 0 || Sq == 0 || Hkv == 0) return 0;
  if (bs % 8 || bs > kMaxStripedBs || bits < 2 || bits > kMaxBits ||
      D % 16 || D > kMaxD || Dv % 4 ||
      (reinterpret_cast<uintptr_t>(kq) | reinterpret_cast<uintptr_t>(v)) & 15)
    return (int)cudaErrorInvalidValue;
  if (bs > kMaxBs)   // the striped walk (paged_walk.cuh)
    return launch_striped(q_int, m_min, m_max, scale_total, alpha_radius,
                          v_scale, kq, v, table, lengths, q_pos, out,
                          rounds_h, surv, B, Sq, Hq, Hkv, D, Dv, bits, bs, MB,
                          min_rounds, quantize_v, has_window, window,
                          group_queries(Hq / Hkv), stream);
  if (bs > 32) {
    if (bits <= 4) return launch<4, 8>(PV_ARGS);
    if (bits <= 8) return launch<8, 8>(PV_ARGS);
    if (bits <= 12) return launch<12, 8>(PV_ARGS);
    return launch<16, 8>(PV_ARGS);
  }
  if (bits <= 4) return launch<4, 1>(PV_ARGS);
  if (bits <= 8) return launch<8, 1>(PV_ARGS);
  if (bits <= 12) return launch<12, 1>(PV_ARGS);
  return launch<16, 1>(PV_ARGS);
}

// The bytes the kernel has requested with cp.async, planes in host[0] and V
// in host[1], summed over the launches given a survivors output since the
// last call, which zeroes them.  Returns the CUDA error code.
extern "C" int paged_verify_copied_bytes(unsigned long long* host) {
  return walk::take_copied(host);
}
