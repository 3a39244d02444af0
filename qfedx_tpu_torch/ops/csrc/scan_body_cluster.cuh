// The cluster instance of the scan-body kernel: each sample's (R, 128)
// re/im state lives in the shared memory of a thread-block cluster of K
// CTAs for the whole sweep (see scan_body.cu's header for the design and
// the bound; the wrapper picks K and this instance in
// ops/scan_body.py::_launch_config).
//
// CTA `rank` of a cluster owns the rows r with r mod K == rank (local row
// r / K), in two ping-pong buffers of shared memory (re, then im, per
// buffer), as f32 in both instances: the bf16 instance (T = bf16) reads
// bf16 from global memory, rounds each op's result to bf16 (rnd) and
// keeps the rounded values as f32, so that the buffers and K are those
// of f32; only its ring holds bf16 (the coefficients as they lie in
// global memory, converted when read). Interleaving puts the lowest row
// bits — the selecting bit of the ansatz's glane — in the rank, so such
// a CTA needs one branch matrix, not two. Row-local ops (lane, glane,
// mask, a lane/lane CNOT, a row-control/lane-target CNOT) read only the
// CTA's own rows. Ops that mix rows (rowmat, growmat, rowpair, rowperm, a
// CNOT with a row target) read the other CTAs' buffers through
// distributed shared memory. Each CTA writes only its own rows, into the
// buffer the op does not read.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "scan_body_common.cuh"

namespace qfx {

namespace cg = cooperative_groups;

constexpr int CL_THREADS = 256;
constexpr int CL_ROW_GROUPS = CL_THREADS / LANES;  // threads per lane
constexpr int MAX_CLUSTER = 16;
// The stage region streams coefficients (and, for row ops, state rows)
// through shared memory, in units of UNIT_ELEMS elements of the launch's
// type T: one slab of JS rows of one 128x128 branch matrix, re and im.
// The launch gives it what the state leaves of the block's shared
// memory, 4 to 8 units (128 KB in f32, 64 KB in bf16).
constexpr int JS = 16;
constexpr int NSLAB = LANES / JS;
constexpr int UNIT_ELEMS = 2 * JS * LANES;
constexpr int MAX_UNITS = 8;

// Does op `d` read rows other than the ones it writes?
__device__ __forceinline__ bool reads_other_rows(const int* d, int rbits) {
  switch (d[D_KIND]) {
    case K_ROWMAT:
    case K_GROWMAT:
    case K_ROWPAIR:
    case K_ROWPERM:
      return true;
    case K_CNOT:
      return d[D_Q1] < rbits;  // a row target flips rows
    default:
      return false;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Async bulk store (TMA engine) of `bytes` from this CTA's shared memory
// to global memory, in the calling thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* gdst, const void* ssrc,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(gdst), "r"(smem_addr(ssrc)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async16(void* sdst, const void* gsrc) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               ::"r"(smem_addr(sdst)), "l"(gsrc) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* m, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               ::"r"(smem_addr(m)), "r"(count) : "memory");
}

// This CTA's one arrival on `m`, expecting `bytes` more to land on it.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* m, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(m)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* m, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(m)), "r"(parity) : "memory");
  } while (!done);
}

// Bulk copy (TMA engine) of `bytes` from global memory to the same
// shared-memory offset `sdst` in every CTA of `mask`, each of which
// counts the bytes on its own barrier at offset `m`.
__device__ __forceinline__ void bulk_load_multicast(void* sdst,
                                                    const void* gsrc,
                                                    unsigned bytes,
                                                    uint64_t* m,
                                                    unsigned short mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;"
      ::"r"(smem_addr(sdst)), "l"(gsrc), "r"(bytes), "r"(smem_addr(m)),
      "h"(mask) : "memory");
}

// Geometry of one CTA's share of a sample.
struct Slice {
  int rbits;   // log2 R
  int kbits;   // log2 K
  int rkbits;  // log2 RK (rows per CTA)
  int rank;    // this CTA's rank: it owns rows (local << kbits) | rank
  int part;    // floats per (buffer, re|im) part = RK * 128
  int units;       // stage region size, in UNIT_ELEMS elements of T
  uint64_t* mbar;  // one barrier per stage of the lane products' ring
};

__device__ __forceinline__ int global_row(const Slice& sl, int local) {
  return (local << sl.kbits) | sl.rank;
}

// Element (row s, lane k) of part p (0 = re, 1 = im) of buffer `buf` in
// whichever CTA of the cluster owns row s.
__device__ __forceinline__ float remote_at(float* const* rbase,
                                           const Slice& sl, int buf, int p,
                                           int s, int k) {
  const float* base = rbase[s & ((1 << sl.kbits) - 1)];
  return base[(2 * buf + p) * sl.part + ((s >> sl.kbits) << LANE_BITS) + k];
}

// Local row of the i-th row of the CTA's tiles. With a glane whose
// selecting bit is local bit `lbit` (it varies inside the CTA), rows are
// ordered branch 0 first, then branch 1, so a tile of TR <= RK/2
// consecutive indices shares one branch.
__device__ __forceinline__ int tile_row(int i, int rk, int lbit) {
  if (lbit < 0) return i;
  const int half = rk >> 1;
  const int g = i >= half;
  const int j = i - g * half;
  return ((j >> lbit) << (lbit + 1)) | (g << lbit) | (j & ((1 << lbit) - 1));
}

// Which CTAs of the cluster stage the same branches of a lane product:
// all of them, or (a glane whose selecting bit lies in the rank) the
// half whose rank has this CTA's value of that bit. Each member loads
// its share of every slab and multicasts it to the whole group, so the
// group reads each slab from L2 once.
struct Group {
  unsigned short mask;
  int size;
  int index;  // this CTA's place in the group
};

__device__ __forceinline__ Group lane_group(const Slice& sl, int kcl,
                                            int bit) {
  Group g;
  if (bit >= 0 && bit < sl.kbits) {
    const int beta = (sl.rank >> bit) & 1;
    g.mask = 0;
    for (int r = 0; r < kcl; ++r)
      if (((r >> bit) & 1) == beta) g.mask |= (unsigned short)(1u << r);
    g.size = kcl >> 1;
    g.index = ((sl.rank >> (bit + 1)) << bit) | (sl.rank & ((1 << bit) - 1));
  } else {
    g.mask = (unsigned short)((1u << kcl) - 1);
    g.size = kcl;
    g.index = sl.rank;
  }
  return g;
}

// Thread 0: slab `sb` (rows sb*JS .. +JS) of branches b_lo .. b_lo+nb-1
// of a 128x128 matrix into stage `st` (laid out [branch][re|im][JS][128])
// of every CTA of the group, completing on barrier `m` of each. A share
// is 128 to 2048 elements (256 B to 8 KB in bf16), so every copy's size
// and addresses stay multiples of 16 bytes.
template <class T>
__device__ __forceinline__ void issue_slab(T* st, uint64_t* m, const T* mre,
                                           const T* mim, int sb, int b_lo,
                                           int nb, bool has_im,
                                           const Group& g) {
  const int parts = has_im ? 2 : 1;
  const int share = JS * LANES / g.size;  // elements each member loads
  mbar_expect_tx(m, (unsigned)(nb * parts * JS * LANES * sizeof(T)));
  for (int bb = 0; bb < nb; ++bb)
    for (int p = 0; p < parts; ++p)
      bulk_load_multicast(
          st + (bb * 2 + p) * JS * LANES + g.index * share,
          (p ? mim : mre) + (size_t)(b_lo + bb) * LANES * LANES +
              (size_t)sb * JS * LANES + g.index * share,
          share * (unsigned)sizeof(T), m, g.mask);
}

// Every CTA of the cluster (or this one alone) at the same point.
__device__ __forceinline__ void all_sync(cg::cluster_group& cluster,
                                         int kcl) {
  if (kcl > 1)
    cluster.sync();
  else
    __syncthreads();
}

// out[r,k] = sum_j s[r,j] * M[j,k] for the CTA's own rows. M streams
// through a ring of shared-memory stages in JS-row slabs, as many in
// flight as the stage region holds (all eight of one branch at n=12):
// bulk copies multicast over the CTAs that need the same branches (see
// Group), each stage completing on its barrier. Each thread computes a
// tile of TR rows x 1 lane, so every M value it reads serves TR rows and
// every state read (a float4 broadcast) four terms. `bit` is the
// selecting row bit of a glane (M = branch of that bit), -1 for a lane
// op. `phase` holds each stage barrier's parity, the same in every
// thread of the cluster. In bf16 (BF) the four real products of a
// complex coefficient accumulate apart and round at the end (cre_of).
template <class T, int TR, bool HAS_IM>
__device__ void cl_lane(const float* s_re, const float* s_im, float* d_re,
                        float* d_im, const T* __restrict__ mre,
                        const T* __restrict__ mim, T* stage,
                        const Slice& sl, cg::cluster_group& cluster,
                        int kcl, int bit, unsigned& phase) {
  constexpr bool BF = IS_BF16<T> && HAS_IM;
  const int k = threadIdx.x & (LANES - 1);
  const int rk = 1 << sl.rkbits;
  const int tiles = rk / TR;
  int b_lo = 0, nb = 1, lbit = -1;
  if (bit >= 0) {
    if (bit < sl.kbits) {
      b_lo = (sl.rank >> bit) & 1;  // one branch for the whole CTA
    } else {
      nb = 2;
      lbit = bit - sl.kbits;
    }
  }
  const Group grp = lane_group(sl, kcl, bit);
  const int stage_elems = nb * UNIT_ELEMS;
  int nst = sl.units / nb;  // stages in the ring (>= 2)
  if (nst > NSLAB) nst = NSLAB;
  const int depth = nst - 1;  // slabs loading ahead of the one in use
  const bool lead = threadIdx.x == 0;
  const int passes = (tiles + CL_ROW_GROUPS - 1) / CL_ROW_GROUPS;
  for (int pass = 0; pass < passes; ++pass) {
    // No CTA of the group may still read (or write) the stage region the
    // multicasts below fill in every member: the caller's barrier before
    // the op sees to it for the first pass (see the kernel), this one
    // for the others.
    if (pass > 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      all_sync(cluster, kcl);
    }
    const int t = pass * CL_ROW_GROUPS + (threadIdx.x >> LANE_BITS);
    const bool active = t < tiles;
    int lr[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i)
      lr[i] = active ? tile_row(t * TR + i, rk, lbit) : 0;
    const int rel = lbit >= 0 ? (lr[0] >> lbit) & 1 : 0;
    float acr[TR], aci[TR];
    float aii[BF ? TR : 1], ari[BF ? TR : 1];  // bf16: v*b and u*b apart
#pragma unroll
    for (int i = 0; i < TR; ++i) acr[i] = aci[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (BF ? TR : 1); ++i) aii[i] = ari[i] = 0.f;
    if (lead)
      for (int sb = 0; sb < depth; ++sb)
        issue_slab(stage + sb * stage_elems, sl.mbar + sb, mre, mim, sb,
                   b_lo, nb, HAS_IM, grp);
    for (int sb = 0; sb < NSLAB; ++sb) {
      const int nxt = sb + depth;
      const int ns = nxt % nst;  // the stage slab sb - 1 used (now free)
      if (lead && nxt < NSLAB)
        issue_slab(stage + ns * stage_elems, sl.mbar + ns, mre, mim, nxt,
                   b_lo, nb, HAS_IM, grp);
      const int st = sb % nst;
      mbar_wait(sl.mbar + st, (phase >> st) & 1u);
      phase ^= 1u << st;
      if (active) {
        const T* sa = stage + st * stage_elems + rel * 2 * JS * LANES + k;
        const T* sbm = sa + JS * LANES;
#pragma unroll
        for (int jj = 0; jj < JS; jj += 4) {
          float a[4], b[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            a[q] = to_f32(sa[(jj + q) * LANES]);
            if (HAS_IM) b[q] = to_f32(sbm[(jj + q) * LANES]);
          }
          const int j = sb * JS + jj;
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const float4 u4 = *reinterpret_cast<const float4*>(
                s_re + (lr[i] << LANE_BITS) + j);
            const float4 v4 = *reinterpret_cast<const float4*>(
                s_im + (lr[i] << LANE_BITS) + j);
            const float u[4] = {u4.x, u4.y, u4.z, u4.w};
            const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acr[i] = fmaf(u[q], a[q], acr[i]);
              aci[i] = fmaf(v[q], a[q], aci[i]);
              if (BF) {
                aii[BF ? i : 0] = fmaf(v[q], b[q], aii[BF ? i : 0]);
                ari[BF ? i : 0] = fmaf(u[q], b[q], ari[BF ? i : 0]);
              } else if (HAS_IM) {
                acr[i] = fmaf(-v[q], b[q], acr[i]);
                aci[i] = fmaf(u[q], b[q], aci[i]);
              }
            }
          }
        }
      }
      // The next iteration refills this stage in every member only if a
      // slab is still to come for it: then every member must be done.
      if (sb + nst < NSLAB) all_sync(cluster, kcl);
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        float re = acr[i], im = aci[i];
        if (BF) {
          re = cre_of<T>(re, aii[BF ? i : 0]);
          im = cim_of<T>(im, ari[BF ? i : 0]);
        } else {
          re = rnd<T>(re);
          im = rnd<T>(im);
        }
        d_re[(lr[i] << LANE_BITS) + k] = re;
        d_im[(lr[i] << LANE_BITS) + k] = im;
      }
    }
  }
}

// out[r,k] = sum_s M[r,s] * x[s,k] for the CTA's own rows r. Chunk by
// chunk of `cs` rows s, every thread first copies into the stage region
// (1) those rows of x from the CTA of the cluster that owns each
// (buffer `sb`, distributed shared memory, coalesced float4 loads) and
// (2) the matching columns of this pass's rows of M (both branches of a
// growmat; cp.async), then reads both locally. Each thread computes a tile of TR
// rows x 1 lane: every state value serves TR rows. `shift` is the
// selecting lane bit of a growmat (M = branch of that bit), -1 for a
// rowmat. The state rows stage as f32, the M columns in T (VEC elements
// per 16-byte copy).
template <class T, int TR, bool HAS_IM>
__device__ void cl_row(float* const* rbase, int sb, float* d_re, float* d_im,
                       const T* __restrict__ mre,
                       const T* __restrict__ mim, float* stage,
                       const Slice& sl, int shift) {
  constexpr bool BF = IS_BF16<T> && HAS_IM;
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CS_MIN = VEC > 4 ? VEC : 4;
  const int k = threadIdx.x & (LANES - 1);
  const int rows = 1 << sl.rbits;
  const int rk = 1 << sl.rkbits;
  const int tiles = rk / TR;
  const int kmask = (1 << sl.kbits) - 1;
  const int nbr = shift >= 0 ? 2 : 1;
  const int prow = rk < CL_ROW_GROUPS * TR ? rk : CL_ROW_GROUPS * TR;
  // Largest power-of-two chunk whose state rows and M columns fit.
  int cs = rows;
  while (cs > CS_MIN &&
         cs * (2 * LANES * 4 + prow * nbr * 2 * (int)sizeof(T)) >
             sl.units * UNIT_ELEMS * (int)sizeof(T))
    cs >>= 1;
  float* xs = stage;  // [re|im][cs][128]
  // [prow][branch][re|im][cs]
  T* ms = reinterpret_cast<T*>(stage + 2 * cs * LANES);
  const int bsel = shift >= 0 ? (k >> shift) & 1 : 0;
  const int passes = (tiles + CL_ROW_GROUPS - 1) / CL_ROW_GROUPS;
  for (int pass = 0; pass < passes; ++pass) {
    const int rg = threadIdx.x >> LANE_BITS;
    const int t = pass * CL_ROW_GROUPS + rg;
    const bool active = t < tiles;
    const int lr0 = pass * CL_ROW_GROUPS * TR;  // first local row of the pass
    float acr[TR], aci[TR];
    float aii[BF ? TR : 1], ari[BF ? TR : 1];  // bf16: v*b and u*b apart
#pragma unroll
    for (int i = 0; i < TR; ++i) acr[i] = aci[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (BF ? TR : 1); ++i) aii[i] = ari[i] = 0.f;
    for (int c0 = 0; c0 < rows; c0 += cs) {
      // (2) first, asynchronously, so its latency overlaps (1).
      const int parts = HAS_IM ? 2 : 1;
      const int qv = cs / VEC;
      const int nm = prow * nbr * parts * qv;
      for (int e = threadIdx.x; e < nm; e += CL_THREADS) {
        const int f = e % qv;
        int rest = e / qv;
        const int p = rest % parts;
        rest /= parts;
        const int bb = rest % nbr;
        const int lrp = rest / nbr;
        const size_t src = (size_t)bb * rows * rows +
                           (size_t)global_row(sl, lr0 + lrp) * rows + c0 +
                           f * VEC;
        cp_async16(ms + ((lrp * nbr + bb) * 2 + p) * cs + f * VEC,
                   (p ? mim : mre) + src);
      }
      const int nx = 2 * cs * (LANES / 4);
#pragma unroll 4
      for (int e = threadIdx.x; e < nx; e += CL_THREADS) {
        const int p = e >= nx / 2;
        const int f = e - p * (nx / 2);
        const int s = c0 + (f >> 5);
        const float4 val = *reinterpret_cast<const float4*>(
            rbase[s & kmask] + (2 * sb + p) * sl.part +
            ((s >> sl.kbits) << LANE_BITS) + (f & 31) * 4);
        *reinterpret_cast<float4*>(xs + p * cs * LANES + f * 4) = val;
      }
      cp_async_wait_all();
      __syncthreads();
      if (active) {
        const float* xr = xs + k;
        const float* xi = xs + cs * LANES + k;
        const T* mt = ms + ((rg * TR) * nbr + bsel) * 2 * cs;
        for (int s = 0; s < cs; s += 4) {
          float u[4], v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            u[q] = xr[(s + q) * LANES];
            v[q] = xi[(s + q) * LANES];
          }
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const T* mrow = mt + i * nbr * 2 * cs + s;
            const float4 a4 = load4(mrow);
            const float a[4] = {a4.x, a4.y, a4.z, a4.w};
            float b[4] = {0.f, 0.f, 0.f, 0.f};
            if (HAS_IM) {
              const float4 b4 = load4(mrow + cs);
              b[0] = b4.x; b[1] = b4.y; b[2] = b4.z; b[3] = b4.w;
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acr[i] = fmaf(u[q], a[q], acr[i]);
              aci[i] = fmaf(v[q], a[q], aci[i]);
              if (BF) {
                aii[BF ? i : 0] = fmaf(v[q], b[q], aii[BF ? i : 0]);
                ari[BF ? i : 0] = fmaf(u[q], b[q], ari[BF ? i : 0]);
              } else if (HAS_IM) {
                acr[i] = fmaf(-v[q], b[q], acr[i]);
                aci[i] = fmaf(u[q], b[q], aci[i]);
              }
            }
          }
        }
      }
      __syncthreads();  // the chunk is free for the next one
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        float re = acr[i], im = aci[i];
        if (BF) {
          re = cre_of<T>(re, aii[BF ? i : 0]);
          im = cim_of<T>(im, ari[BF ? i : 0]);
        } else {
          re = rnd<T>(re);
          im = rnd<T>(im);
        }
        d_re[((t * TR + i) << LANE_BITS) + k] = re;
        d_im[((t * TR + i) << LANE_BITS) + k] = im;
      }
    }
  }
}

// TR from RK: the largest tile (<= 8 rows; <= RK/2, so that a glane tile
// shares one branch) that gives both row groups of threads a tile.
template <class T, bool HAS_IM>
__device__ void cl_lane_any(const float* s_re, const float* s_im,
                            float* d_re, float* d_im, const T* mre,
                            const T* mim, T* stage, const Slice& sl,
                            cg::cluster_group& cluster, int kcl, int bit,
                            unsigned& phase) {
#define QFX_LANE(TR)                                                    \
  cl_lane<T, TR, HAS_IM>(s_re, s_im, d_re, d_im, mre, mim, stage, sl,   \
                         cluster, kcl, bit, phase)
  if (sl.rkbits >= 4)
    QFX_LANE(8);
  else if (sl.rkbits == 3)
    QFX_LANE(4);
  else if (sl.rkbits == 2)
    QFX_LANE(2);
  else
    QFX_LANE(1);
#undef QFX_LANE
}

template <class T, bool HAS_IM>
__device__ void cl_row_any(float* const* rbase, int sb, float* d_re,
                           float* d_im, const T* mre, const T* mim,
                           float* stage, const Slice& sl, int shift) {
  if (sl.rkbits >= 4)
    cl_row<T, 8, HAS_IM>(rbase, sb, d_re, d_im, mre, mim, stage, sl, shift);
  else if (sl.rkbits == 3)
    cl_row<T, 4, HAS_IM>(rbase, sb, d_re, d_im, mre, mim, stage, sl, shift);
  else if (sl.rkbits == 2)
    cl_row<T, 2, HAS_IM>(rbase, sb, d_re, d_im, mre, mim, stage, sl, shift);
  else
    cl_row<T, 1, HAS_IM>(rbase, sb, d_re, d_im, mre, mim, stage, sl, shift);
}

// grid = tb * K CTAs in clusters of K (launched with the cluster
// attribute); dynamic shared memory = 2 buffers x (re, im) x RK x 128
// floats, then the stage region of `units` x UNIT_ELEMS elements of T,
// then the n_ops x DESC_W descriptor table.
template <class T, bool BND>
__global__ void __launch_bounds__(CL_THREADS, 1)
scan_body_cluster_kernel(const T* __restrict__ in_re,
                         const T* __restrict__ in_im, T* out_re, T* out_im,
                         T* bnd_re, T* bnd_im,
                         const int* __restrict__ desc_g, int n_ops,
                         const T* __restrict__ coeffs,
                         const int* __restrict__ statics, int tb, int n,
                         int length, int units) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float* rbase[MAX_CLUSTER];
  __shared__ __align__(8) uint64_t mbar[MAX_UNITS];
  cg::cluster_group cluster = cg::this_cluster();
  const int kcl = (int)cluster.num_blocks();
  const int b = blockIdx.x / kcl;
  const int tid = threadIdx.x;

  Slice sl;
  sl.rbits = n - LANE_BITS;
  sl.kbits = 0;
  while ((1 << sl.kbits) < kcl) ++sl.kbits;
  sl.rkbits = sl.rbits - sl.kbits;
  sl.rank = (int)cluster.block_rank();
  sl.part = (1 << sl.rkbits) << LANE_BITS;
  sl.units = units;
  sl.mbar = mbar;
  unsigned phase = 0;  // parity of each stage barrier's current phase
  const int part = sl.part;
  const int rk = 1 << sl.rkbits;
  const size_t size = (size_t)1 << n;
  const size_t boff = (size_t)b * size;

  float* stage = smem + 4 * part;
  T* tstage = reinterpret_cast<T*>(stage);  // the lane products' ring
  int* desc = reinterpret_cast<int*>(tstage + units * UNIT_ELEMS);
  for (int i = tid; i < n_ops * DESC_W; i += CL_THREADS) desc[i] = desc_g[i];
  if (tid < kcl) rbase[tid] = cluster.map_shared_rank(smem, tid);
  if (tid == 0) {
    for (int i = 0; i < MAX_UNITS; ++i) mbar_init(mbar + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Input rows -> buffer 0 (32 groups of 4 per row; rows are K apart).
  for (int e = tid; e < part / 4; e += CL_THREADS) {
    const size_t g = boff + ((size_t)global_row(sl, e >> 5) << LANE_BITS) +
                     (e & 31) * 4;
    reinterpret_cast<float4*>(smem)[e] = load4(in_re + g);
    reinterpret_cast<float4*>(smem + part)[e] = load4(in_im + g);
  }
  // Every CTA of the cluster has started and holds its input rows.
  cluster.sync();

  int cur = 0;  // buffer holding the current state
  for (int l = 0; l < length; ++l) {
    const size_t loff = ((size_t)l * tb + b) * size;
    if (BND && !IS_BF16<T> && tid < 32) {
      // Layer-entry state -> slot (l, b): async bulk stores (one per row
      // and part, issued by warp 0) that run under the layer's first op,
      // which only reads this buffer, and are awaited before the buffer
      // is written again.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      for (int i = tid; i < 2 * rk; i += 32) {
        const int p = i & 1, lr = i >> 1;
        T* dst = (p ? bnd_im : bnd_re) + loff +
                 ((size_t)global_row(sl, lr) << LANE_BITS);
        bulk_store(dst, smem + (2 * cur + p) * part + (lr << LANE_BITS),
                   LANES * 4u);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    if (BND && IS_BF16<T>) {
      // bf16: the f32 buffer converts on the way out, so every thread
      // stores its share (the values are bf16 already: exact).
      for (int e = tid; e < part / 2; e += CL_THREADS) {
        const int p = e >= part / 4;
        const int f = e - p * (part / 4);
        const size_t g = loff +
                         ((size_t)global_row(sl, f >> 5) << LANE_BITS) +
                         (f & 31) * 4;
        const float4* src =
            reinterpret_cast<const float4*>(smem + (2 * cur + p) * part);
        store4((p ? bnd_im : bnd_re) + g, src[f]);
      }
    }
    for (int o = 0; o < n_ops; ++o) {
      const int* d = desc + o * DESC_W;
      const int kind = d[D_KIND];
      const size_t cidx =
          ((size_t)l * d[D_GROUPS] + (size_t)b * d[D_GROUPS] / tb) *
          (size_t)d[D_GSIZE];
      const T* cre = coeffs + d[D_RE] + cidx;
      const T* cim = d[D_IM] >= 0 ? coeffs + d[D_IM] + cidx : nullptr;
      const float* s_re = smem + 2 * cur * part;
      const float* s_im = s_re + part;
      float* d_re = smem + 2 * (cur ^ 1) * part;
      float* d_im = d_re + part;
      const int q0 = d[D_Q0], q1 = d[D_Q1];
      const int rbits = sl.rbits;

      switch (kind) {
        case K_LANE:
        case K_GLANE: {
          const int bit = kind == K_GLANE ? rbits - 1 - q0 : -1;
          if (cim)
            cl_lane_any<T, true>(s_re, s_im, d_re, d_im, cre, cim, tstage,
                                 sl, cluster, kcl, bit, phase);
          else
            cl_lane_any<T, false>(s_re, s_im, d_re, d_im, cre, cim, tstage,
                                  sl, cluster, kcl, bit, phase);
          break;
        }
        case K_ROWMAT:
        case K_GROWMAT: {
          const int shift = kind == K_GROWMAT ? n - 1 - q0 : -1;
          if (cim)
            cl_row_any<T, true>(rbase, cur, d_re, d_im, cre, cim, stage, sl,
                                shift);
          else
            cl_row_any<T, false>(rbase, cur, d_re, d_im, cre, cim, stage, sl,
                                 shift);
          break;
        }
        case K_MASK: {
          for (int e = tid; e < part; e += CL_THREADS) {
            const size_t g =
                ((size_t)global_row(sl, e >> LANE_BITS) << LANE_BITS) +
                (e & (LANES - 1));
            const float u = s_re[e], v = s_im[e], a = ldg_f32(cre + g);
            if (cim && IS_BF16<T>) {
              const float w = ldg_f32(cim + g);
              d_re[e] = cre_of<T>(u * a, v * w);
              d_im[e] = cim_of<T>(v * a, u * w);
            } else if (cim) {
              const float w = ldg_f32(cim + g);
              d_re[e] = fmaf(u, a, -v * w);
              d_im[e] = fmaf(v, a, u * w);
            } else {
              d_re[e] = rnd<T>(u * a);
              d_im[e] = rnd<T>(v * a);
            }
          }
          break;
        }
        case K_ROWPERM: {
          const int* perm = statics + d[D_STATIC];
#pragma unroll 4
          for (int e = tid; e < part; e += CL_THREADS) {
            const int src = __ldg(perm + global_row(sl, e >> LANE_BITS));
            const int k = e & (LANES - 1);
            d_re[e] = remote_at(rbase, sl, cur, 0, src, k);
            d_im[e] = remote_at(rbase, sl, cur, 1, src, k);
          }
          break;
        }
        case K_ROWPAIR: {
          // out[r] = sum_d g[o, o^d] * s[flip_d(r)], o = (bit q0, bit q1);
          // in bf16 the sum rounds term by term, as the reference's _emit.
          const int m1 = 1 << (rbits - 1 - q0);
          const int m2 = 1 << (rbits - 1 - q1);
          for (int e = tid; e < part; e += CL_THREADS) {
            const int r = global_row(sl, e >> LANE_BITS);
            const int k = e & (LANES - 1);
            const int oo = (((r & m1) != 0) << 1) | ((r & m2) != 0);
            float accr = 0.f, acci = 0.f;
#pragma unroll
            for (int dd = 0; dd < 4; ++dd) {
              const int rr = r ^ ((dd & 2) ? m1 : 0) ^ ((dd & 1) ? m2 : 0);
              const float u = remote_at(rbase, sl, cur, 0, rr, k);
              const float v = remote_at(rbase, sl, cur, 1, rr, k);
              const float a = ldg_f32(cre + oo * 4 + (oo ^ dd));
              if (IS_BF16<T>) {
                accr = rnd<T>(accr + rnd<T>(u * a));
                acci = rnd<T>(acci + rnd<T>(v * a));
              } else {
                accr = fmaf(u, a, accr);
                acci = fmaf(v, a, acci);
              }
              if (cim) {
                const float w = ldg_f32(cim + oo * 4 + (oo ^ dd));
                if (IS_BF16<T>) {
                  accr = rnd<T>(accr - rnd<T>(v * w));
                  acci = rnd<T>(acci + rnd<T>(u * w));
                } else {
                  accr = fmaf(-v, w, accr);
                  acci = fmaf(u, w, acci);
                }
              }
            }
            d_re[e] = accr;
            d_im[e] = acci;
          }
          break;
        }
        case K_CNOT: {
          const bool c_row = q0 < rbits, t_row = q1 < rbits;
#pragma unroll 4
          for (int e = tid; e < part; e += CL_THREADS) {
            int r = global_row(sl, e >> LANE_BITS);
            int k = e & (LANES - 1);
            if (c_row && t_row) {
              if ((r >> (rbits - 1 - q0)) & 1) r ^= 1 << (rbits - 1 - q1);
            } else if (!c_row && !t_row) {
              if ((k >> (n - 1 - q0)) & 1) k ^= 1 << (n - 1 - q1);
            } else if (c_row) {
              if ((r >> (rbits - 1 - q0)) & 1) k ^= 1 << (n - 1 - q1);
            } else {
              if ((k >> (n - 1 - q0)) & 1) r ^= 1 << (rbits - 1 - q1);
            }
            if (t_row) {
              d_re[e] = remote_at(rbase, sl, cur, 0, r, k);
              d_im[e] = remote_at(rbase, sl, cur, 1, r, k);
            } else {  // same row: this CTA's own
              const int src = (e & ~(LANES - 1)) | k;
              d_re[e] = s_re[src];
              d_im[e] = s_im[src];
            }
          }
          break;
        }
        default:
          break;
      }
      if (BND && !IS_BF16<T> && o == 0 && tid < 32)
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      // A cluster barrier where this op read other CTAs' rows (they must
      // not overwrite that buffer before every reader is done), where the
      // next op will (it must see every CTA's output), or where the next
      // op is a lane product (its multicasts write every CTA's stage
      // region, which must be done with this op); else the CTA's.
      const int* nd = (o + 1 < n_ops) ? d + DESC_W
                      : (l + 1 < length ? desc : nullptr);
      const bool next_lane =
          nd && (nd[D_KIND] == K_LANE || nd[D_KIND] == K_GLANE);
      if (next_lane)  // order this op's stage-region use before the copies
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const bool wide = kcl > 1 && (reads_other_rows(d, rbits) || next_lane ||
                                    (nd && reads_other_rows(nd, rbits)));
      if (wide)
        cluster.sync();
      else
        __syncthreads();
      cur ^= 1;
    }
  }
  for (int e = tid; e < part / 4; e += CL_THREADS) {
    const size_t g = boff + ((size_t)global_row(sl, e >> 5) << LANE_BITS) +
                     (e & 31) * 4;
    const float4* fin = reinterpret_cast<const float4*>(smem + 2 * cur * part);
    store4(out_re + g, fin[e]);
    store4(out_im + g, fin[part / 4 + e]);
  }
  if (BND && !IS_BF16<T> && tid < 32)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace qfx
