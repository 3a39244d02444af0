// The bf16 cluster instance's lane and row products on Hopper's tensor
// cores (included by scan_body_cluster.cuh, whose helpers it uses).
//
// What it computes is the FFMA loops' function (cl_lane, cl_row): the four
// real products of a complex product (u*a, v*b, v*a, u*b; u, v the state's
// re and im, a, b the coefficient's) each summed in f32 and rounded by
// cre_of / cim_of, as the reference's _emit rounds its f32-accumulated
// jnp.dot (pallas_body.py:281-284). A product of two bf16 values is exact
// in f32, so a bf16 mma with f32 accumulation gives the same terms; only
// the order of the f32 sum changes.
//
// Instruction: mma.sync m16n8k16 (bf16 operands, f32 accumulators), not
// wgmma. wgmma reads its shared-memory operands in its core-matrix
// layouts, which neither the ring's 1-D bulk copies nor the state (a new
// operand every op) lie in; mma.sync takes its fragments from whatever
// rows ldmatrix addresses.
//
// The transposed product at every rows-per-CTA shape RK: lanes are the M
// dimension (8 warps x 16 lanes = 128), the CTA's rows the N dimension
// (n8 tiles, padded when RK < 8), the contraction (j for a lane product,
// s for a row product) the K dimension:
//   lane product  out^T[k, r] = sum_j M[j, k] s[r, j]:  A = M^T from the
//                 ring (ldmatrix.trans), B = the state rows from a bf16
//                 copy of the CTA's rows in tile order (ldmatrix);
//   row product   out^T[k, r] = sum_s x[s, k] M[r, s]:  A = x^T from the
//                 state rows copied into the stage (ldmatrix.trans), B =
//                 the CTA's rows of M (ldmatrix).
// The row-major form (rows as M) would put both glane branches in one m16
// tile at RK = 16; here an n8 tile holds one branch at every RK >= 16
// (tile_row orders rows branch 0 first), and at RK <= 8, where a tile
// mixes them, each branch's product takes the tile with the other
// branch's columns zeroed. A growmat stages x with the lanes in branch
// order (lanes whose selecting bit is 0, then 1), so each warp's m16 tile
// of lanes has one branch.
//
// A pass covers at most 32 rows (4 n8 tiles, 64 f32 accumulators a
// thread): one pass over the ring at RK <= 32; at RK = 64 two, each
// streaming only the branches its rows select.
//
// The ring: every slab is one bulk copy per (branch, part) and member, as
// in the FFMA design, but the host stores each lane matrix's rows
// swizzled (ops/scan_body.py::_ring_swizzle: the 16-byte chunk c of row j
// at chunk c ^ (j mod 8)), so the eight rows of an ldmatrix tile fall in
// eight bank groups; and the ring takes up to 16 units, so that each of
// a glane's eight slabs (both branches) has a stage of its own: none is
// refilled inside the op, and no barrier stands between slabs. The bf16
// copy of the state rows and the row product's staged x rows are written
// by threads at OPND_PITCH, staged M rows at an odd multiple of 16 B.
//
// Bound (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py): Launch A at
// tb = 256 takes ~0.09 ms, ~22x its bound at the tensor cores' rate, and
// reads its 115 MB of ring bytes from L2 at ~1.3 TB/s over that time;
// PERF.md has the split by op kind and what holds each op.
#pragma once

namespace qfx {

// bf16 elements from one row of the state's bf16 copy (or of the staged
// x rows) to the next: 256 B + 16 B.
constexpr int OPND_PITCH = LANES + 8;
// The tensor-core instance's stage region: 4 to 16 units of UNIT_ELEMS.
constexpr int MMA_MAX_UNITS = 2 * MAX_UNITS;

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// d += a * b for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Offset of lane L's row for an x4.trans A fragment of this warp's 16
// columns m of a [k][m] array at OPND_PITCH: matrix i = L/8 covers k rows
// (i/2)*8.. and columns warp*16 + (i%2)*8.., so the registers come out as
// the m16n8k16 A fragment of the transposed array.
__device__ __forceinline__ int opnd_afrag_off() {
  const int l = threadIdx.x & 31, i = l >> 3, warp = threadIdx.x >> 5;
  return ((i >> 1) * 8 + (l & 7)) * OPND_PITCH + warp * 16 + (i & 1) * 8;
}

// The same for a ring slab (M^T for this warp's 16 lanes), whose rows
// are 128 lanes long with their 16-byte chunks swizzled.
__device__ __forceinline__ int ring_afrag_off() {
  const int l = threadIdx.x & 31, i = l >> 3, warp = threadIdx.x >> 5;
  return ((i >> 1) * 8 + (l & 7)) * LANES +
         (((warp * 2 + (i & 1)) ^ (l & 7)) << 3);
}

// The complex product's four real products, each in its accumulator (a
// real coefficient: u*a and v*a), rounded where _emit rounds.
template <bool HAS_IM>
__device__ __forceinline__ void store_products(float* d_re, float* d_im,
                                               int idx, float rr, float ii,
                                               float ir, float ri) {
  if (HAS_IM) {
    d_re[idx] = cre_of<bf16>(rr, ii);
    d_im[idx] = cim_of<bf16>(ir, ri);
  } else {
    d_re[idx] = rnd<bf16>(rr);
    d_im[idx] = rnd<bf16>(ir);
  }
}

// out[r,k] = sum_j s[r,j] * M[j,k] for the CTA's own rows on the tensor
// cores, NT n8 tiles (8*NT rows) a pass. The ring, its copies, groups and
// barriers are cl_lane's (its slabs swizzled by the host). `opnd` takes
// the CTA's rows as bf16 in tile order (re, then im; RK rows each).
template <int NT, bool HAS_IM>
__device__ void tc_lane(const float* s_re, const float* s_im, float* d_re,
                        float* d_im, const bf16* __restrict__ mre,
                        const bf16* __restrict__ mim, bf16* stage,
                        bf16* opnd, const Slice& sl,
                        cg::cluster_group& cluster, int kcl, int bit,
                        unsigned& phase) {
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int g = l >> 2, t = l & 3;
  const int rk = 1 << sl.rkbits;
  int b_cta = 0, lbit = -1;
  if (bit >= 0) {
    if (bit < sl.kbits)
      b_cta = (sl.rank >> bit) & 1;  // one branch for the whole CTA
    else
      lbit = bit - sl.kbits;
  }
  // At RK <= 8 a local selecting bit puts both branches in the one tile.
  const bool mixed = lbit >= 0 && rk < 16;
  const Group grp = lane_group(sl, kcl, bit);
  const int prow = rk < NT * 8 ? rk : NT * 8;
  const int passes = rk / prow;
  const int a_off = ring_afrag_off();
  bf16* const op_v = opnd + rk * OPND_PITCH;
  for (int pass = 0; pass < passes; ++pass) {
    if (pass > 0) {  // see cl_lane
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      all_sync(cluster, kcl);
    }
    const int i0 = pass * prow;  // first tile index of the pass
    int b_lo = b_cta, nb = 1;
    if (lbit >= 0) {
      b_lo = i0 >= (rk >> 1);
      nb = (i0 + prow - 1 >= (rk >> 1)) - b_lo + 1;
    }
    const int stage_elems = nb * UNIT_ELEMS;
    int nst = sl.units / nb;
    if (nst > NSLAB) nst = NSLAB;
    const int depth = nst - 1;
    const bool lead = threadIdx.x == 0;
    if (lead)
      for (int sb = 0; sb < depth; ++sb)
        issue_slab(stage + sb * stage_elems, sl.mbar + sb, mre, mim, sb, b_lo,
                   nb, HAS_IM, grp);
    if (pass == 0) {
      // The state's rows as bf16 (exact: the buffers hold bf16 values).
      for (int e = threadIdx.x; e < rk * (LANES / 4); e += CL_THREADS) {
        const int i = e >> 5, c = (e & 31) * 4;
        const int src = (tile_row(i, rk, lbit) << LANE_BITS) + c;
        store4(opnd + i * OPND_PITCH + c, load4(s_re + src));
        store4(op_v + i * OPND_PITCH + c, load4(s_im + src));
      }
      __syncthreads();
    }
    float rr[NT][4], ir[NT][4];
    float ii[HAS_IM ? NT : 1][4], ri[HAS_IM ? NT : 1][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        rr[nt][q] = ir[nt][q] = 0.f;
        if (HAS_IM) ii[HAS_IM ? nt : 0][q] = ri[HAS_IM ? nt : 0][q] = 0.f;
      }
    // Lane l's row for the B fragments: matrix l/8 = (part, j half).
    const int q = l >> 3;
    for (int sb = 0; sb < NSLAB; ++sb) {
      const int nxt = sb + depth;
      const int ns = nxt % nst;
      if (lead && nxt < NSLAB)
        issue_slab(stage + ns * stage_elems, sl.mbar + ns, mre, mim, nxt, b_lo,
                   nb, HAS_IM, grp);
      const int st = sb % nst;
      mbar_wait(sl.mbar + st, (phase >> st) & 1u);
      phase ^= 1u << st;
      const bf16* sa = stage + st * stage_elems + a_off;
      unsigned are[2][4], aim[2][4];
      ldsm_x4_t(are[0], sa);
      if (HAS_IM) ldsm_x4_t(aim[0], sa + JS * LANES);
      if (nb > 1) {
        ldsm_x4_t(are[1], sa + 2 * JS * LANES);
        if (HAS_IM) ldsm_x4_t(aim[1], sa + 3 * JS * LANES);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        int i = i0 + nt * 8 + (l & 7);
        if (i >= rk) i = rk - 1;  // padding columns: read, never stored
        unsigned b[4];  // u (j lo, j hi), v (j lo, j hi)
        ldsm_x4(b, ((q >> 1) ? op_v : opnd) + i * OPND_PITCH + sb * JS +
                       (q & 1) * 8);
        float(&dii)[4] = ii[HAS_IM ? nt : 0];
        float(&dri)[4] = ri[HAS_IM ? nt : 0];
        if (!mixed) {
          // The tile's one branch: the stage's second when it holds two.
          const bool hi = nb > 1 && i0 + nt * 8 >= (rk >> 1);
          unsigned a[4], ai[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a[e] = hi ? are[1][e] : are[0][e];
            ai[e] = hi ? aim[1][e] : aim[0][e];
          }
          mma_bf16(rr[nt], a, b[0], b[1]);
          mma_bf16(ir[nt], a, b[2], b[3]);
          if (HAS_IM) {
            mma_bf16(dii, ai, b[2], b[3]);
            mma_bf16(dri, ai, b[0], b[1]);
          }
        } else {
          // This thread's B column g is tile index g: branch g >= RK/2.
          const unsigned keep1 = g >= (rk >> 1) ? ~0u : 0u;
#pragma unroll
          for (int bb = 0; bb < 2; ++bb) {
            const unsigned k = bb ? keep1 : ~keep1;
            const unsigned(&a)[4] = are[bb];
            const unsigned(&ai)[4] = aim[bb];
            mma_bf16(rr[nt], a, b[0] & k, b[1] & k);
            mma_bf16(ir[nt], a, b[2] & k, b[3] & k);
            if (HAS_IM) {
              mma_bf16(dii, ai, b[2] & k, b[3] & k);
              mma_bf16(dri, ai, b[0] & k, b[1] & k);
            }
          }
        }
      }
      if (sb + nst < NSLAB) all_sync(cluster, kcl);
    }
    // D[m][n]: lanes warp*16 + g (+8), tile indices 2t (+1).
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + nt * 8 + 2 * t + (e & 1);
        if (i - i0 < prow) {
          const int k = warp * 16 + g + (e >> 1) * 8;
          const int idx = (tile_row(i, rk, lbit) << LANE_BITS) + k;
          store_products<HAS_IM>(d_re, d_im, idx, rr[nt][e],
                                 ii[HAS_IM ? nt : 0][e], ir[nt][e],
                                 ri[HAS_IM ? nt : 0][e]);
        }
      }
  }
}

// Position of lane k when a growmat's lanes are staged in branch order
// (selecting bit `shift` 0 first), and back; the identity for shift < 0.
__device__ __forceinline__ int lane_pos(int k, int shift) {
  if (shift < 0) return k;
  return (((k >> shift) & 1) << 6) | ((k >> (shift + 1)) << shift) |
         (k & ((1 << shift) - 1));
}
__device__ __forceinline__ int pos_lane(int p, int shift) {
  return shift < 0 ? p : tile_row(p, LANES, shift);
}

// out[r,k] = sum_s M[r,s] * x[s,k] for the CTA's own rows on the tensor
// cores, NT n8 tiles a pass. Chunk by chunk of `cs` rows s, every thread
// copies (1) those rows of x from the CTA of the cluster that owns each
// (buffer `sb`, distributed shared memory) into the stage as bf16, lanes
// in branch order for a growmat, and (2) the pass's rows of M, those
// columns (both branches of a growmat; cp.async); each warp then takes
// 16 staged lanes, whose branch is one, against every row of the pass.
// `shift` is the selecting lane bit of a growmat, -1 for a rowmat.
template <int NT, bool HAS_IM>
__device__ void tc_row(float* const* rbase, int sb, float* d_re, float* d_im,
                       const bf16* __restrict__ mre,
                       const bf16* __restrict__ mim, bf16* stage,
                       const Slice& sl, int shift) {
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int g = l >> 2, t = l & 3;
  const int rows = 1 << sl.rbits;
  const int rk = 1 << sl.rkbits;
  const int kmask = (1 << sl.kbits) - 1;
  const int nbr = shift >= 0 ? 2 : 1;
  const int parts = HAS_IM ? 2 : 1;
  const int prow = rk < NT * 8 ? rk : NT * 8;
  const int passes = rk / prow;
  // Largest power-of-two chunk whose x rows and M columns fit the stage
  // (padded with zero rows to one k-step of 16 where R = 8).
  int cs = rows;
  while (cs > 8) {
    const int kp = cs < 16 ? 16 : cs;
    if ((2 * kp * OPND_PITCH + prow * nbr * 2 * (kp + 8)) <=
        sl.units * UNIT_ELEMS)
      break;
    cs >>= 1;
  }
  const int kp = cs < 16 ? 16 : cs;  // the chunk's k extent
  const int mp = kp + 8;  // M row pitch: an odd multiple of 16 B
  bf16* xs = stage;  // [re|im][kp][OPND_PITCH], lanes in branch order
  bf16* ms = stage + 2 * kp * OPND_PITCH;  // [prow][branch][re|im][mp]
  const int wb = shift >= 0 ? warp >> 2 : 0;  // the warp's lanes' branch
  const int a_off = opnd_afrag_off();
  const int q = l >> 3;
  for (int pass = 0; pass < passes; ++pass) {
    const int lr0 = pass * prow;
    float rr[NT][4], ir[NT][4];
    float ii[HAS_IM ? NT : 1][4], ri[HAS_IM ? NT : 1][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        rr[nt][e] = ir[nt][e] = 0.f;
        if (HAS_IM) ii[HAS_IM ? nt : 0][e] = ri[HAS_IM ? nt : 0][e] = 0.f;
      }
    for (int c0 = 0; c0 < rows; c0 += cs) {
      // (2) first, asynchronously, so its latency overlaps (1).
      const int qv = cs / 8;
      for (int e = threadIdx.x; e < prow * nbr * parts * qv;
           e += CL_THREADS) {
        const int f = e % qv;
        int rest = e / qv;
        const int p = rest % parts;
        rest /= parts;
        const int bb = rest % nbr;
        const int lrp = rest / nbr;
        cp_async16(ms + ((lrp * nbr + bb) * 2 + p) * mp + f * 8,
                   (p ? mim : mre) + (size_t)bb * rows * rows +
                       (size_t)global_row(sl, lr0 + lrp) * rows + c0 + f * 8);
      }
      if (cs < kp) {  // R = 8: zero the k-step's other half
        const bf16 z = __float2bfloat16_rn(0.f);
        for (int e = threadIdx.x; e < 2 * (kp - cs) * LANES; e += CL_THREADS)
          xs[(e / LANES / (kp - cs)) * kp * OPND_PITCH +
             (cs + (e / LANES) % (kp - cs)) * OPND_PITCH + e % LANES] = z;
        for (int e = threadIdx.x; e < prow * nbr * 2 * (kp - cs);
             e += CL_THREADS)
          ms[(e / (kp - cs)) * mp + cs + e % (kp - cs)] = z;
      }
      const int nx = 2 * cs * (LANES / 4);
#pragma unroll 4
      for (int e = threadIdx.x; e < nx; e += CL_THREADS) {
        const int p = e >= nx / 2;
        const int f = e - p * (nx / 2);
        const int s = c0 + (f >> 5);
        const int k = (f & 31) * 4;
        const float4 val = *reinterpret_cast<const float4*>(
            rbase[s & kmask] + (2 * sb + p) * sl.part +
            ((s >> sl.kbits) << LANE_BITS) + k);
        bf16* row = xs + (p * kp + (f >> 5)) * OPND_PITCH;
        if (shift < 0 || shift >= 2) {  // four lanes in order
          store4(row + lane_pos(k, shift), val);
        } else {  // two lanes of each branch, in order within it
          const float4 v =
              shift == 0 ? make_float4(val.x, val.z, val.y, val.w) : val;
          *reinterpret_cast<__nv_bfloat162*>(row + lane_pos(k, shift)) =
              __floats2bfloat162_rn(v.x, v.y);
          *reinterpret_cast<__nv_bfloat162*>(
              row + lane_pos(k + (shift == 0 ? 1 : 2), shift)) =
              __floats2bfloat162_rn(v.z, v.w);
        }
      }
      cp_async_wait_all();
      __syncthreads();
      for (int ks = 0; ks < kp; ks += 16) {
        unsigned xu[4], xv[4];
        ldsm_x4_t(xu, xs + ks * OPND_PITCH + a_off);
        ldsm_x4_t(xv, xs + (kp + ks) * OPND_PITCH + a_off);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          int r = nt * 8 + (l & 7);
          if (r >= prow) r = prow - 1;  // padding columns: never stored
          unsigned b[4];  // a (s lo, s hi), b (s lo, s hi)
          ldsm_x4(b, ms + ((r * nbr + wb) * 2 + (HAS_IM ? q >> 1 : 0)) * mp +
                         ks + (q & 1) * 8);
          mma_bf16(rr[nt], xu, b[0], b[1]);
          mma_bf16(ir[nt], xv, b[0], b[1]);
          if (HAS_IM) {
            mma_bf16(ii[HAS_IM ? nt : 0], xv, b[2], b[3]);
            mma_bf16(ri[HAS_IM ? nt : 0], xu, b[2], b[3]);
          }
        }
      }
      __syncthreads();  // the chunk is free for the next one
    }
    // D[m][n]: staged lanes warp*16 + g (+8), the pass's rows 2t (+1).
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = nt * 8 + 2 * t + (e & 1);
        if (r < prow) {
          const int k = pos_lane(warp * 16 + g + (e >> 1) * 8, shift);
          store_products<HAS_IM>(d_re, d_im, ((lr0 + r) << LANE_BITS) + k,
                                 rr[nt][e], ii[HAS_IM ? nt : 0][e],
                                 ir[nt][e], ri[HAS_IM ? nt : 0][e]);
        }
      }
  }
}

// NT from RK: 4 n8 tiles (two passes at RK = 64), 2 at RK = 16, one
// (padded) below.
template <bool HAS_IM>
__device__ void tc_lane_any(const float* s_re, const float* s_im,
                            float* d_re, float* d_im, const bf16* mre,
                            const bf16* mim, bf16* stage, bf16* opnd,
                            const Slice& sl, cg::cluster_group& cluster,
                            int kcl, int bit, unsigned& phase) {
  if (sl.rkbits >= 5)
    tc_lane<4, HAS_IM>(s_re, s_im, d_re, d_im, mre, mim, stage, opnd, sl,
                       cluster, kcl, bit, phase);
  else if (sl.rkbits == 4)
    tc_lane<2, HAS_IM>(s_re, s_im, d_re, d_im, mre, mim, stage, opnd, sl,
                       cluster, kcl, bit, phase);
  else
    tc_lane<1, HAS_IM>(s_re, s_im, d_re, d_im, mre, mim, stage, opnd, sl,
                       cluster, kcl, bit, phase);
}

template <bool HAS_IM>
__device__ void tc_row_any(float* const* rbase, int sb, float* d_re,
                           float* d_im, const bf16* mre, const bf16* mim,
                           bf16* stage, const Slice& sl, int shift) {
  if (sl.rkbits >= 5)
    tc_row<4, HAS_IM>(rbase, sb, d_re, d_im, mre, mim, stage, sl, shift);
  else if (sl.rkbits == 4)
    tc_row<2, HAS_IM>(rbase, sb, d_re, d_im, mre, mim, stage, sl, shift);
  else
    tc_row<1, HAS_IM>(rbase, sb, d_re, d_im, mre, mim, stage, sl, shift);
}

}  // namespace qfx
