// Scan-body kernel for Hopper (sm_90a): one forward sweep of a stacked
// fused layer program over every state block, in ONE launch.
//
// Replaces: qfedx_tpu/ops/pallas_body.py::_make_kernel, launched by
// _run -> pl.pallas_call in all three of its launches: the forward
// (Launch A, with_boundaries=False), the forward that also writes the
// layer-entry boundary states (Launch B, _pallas_scan_fwd), and the same
// sweep over the adjointed program with the cotangent as the state
// (Launch C, _pallas_scan_bwd; the adjointing is host-side data, see
// ops/scan_body.py). It computes what those launches compute: for each
// state block b (one (R,128) re/im slab per sample) and each layer l,
// optionally write the block to boundary slot (l, b), then apply the
// layer's op sequence (lane / rowmat / mask / glane / growmat / rowperm /
// rowpair / cnot in its four placements) to the block, layer after layer.
// The op program arrives as data: an int32 descriptor table (DESC_W ints
// per op), the stacked coefficients packed in one buffer of the launch's
// element type laid out (L, G, gate...) per op (re, then im when
// present), and the static rowperm indices in one int32 buffer.
// glane/growmat compute only the branch each row / lane selects, a lane
// CNOT is an index permutation, and every complex product accumulates in
// f32.
//
// Built once per element type: -DQFX_INSTANCE=0 compiles only the f32
// instances, -DQFX_INSTANCE=1 only the bf16 ones (each C entry below
// refuses the other dtype code), so the two libraries build in parallel.
//
// Every instance comes in two element types (template parameter T), as
// the reference's kernel is generic in the state's dtype: f32, and bf16
// (QFEDX_DTYPE=bf16), which reads and writes bf16 state, boundaries and
// coefficients in global memory, accumulates every product in f32 and
// rounds each op's result to bf16 where the reference's _emit rounds it
// (pallas_body.py:268-398): each of a complex product's four real
// products, then their bf16 difference and sum; a mask's products; a
// rowpair's running sum term by term; copies are exact. The bf16 cluster
// instance runs its lane, glane, rowmat and growmat products on the
// tensor cores (mma.sync bf16 with f32 accumulation,
// scan_body_mma.cuh), as the reference's jnp.dot runs on the TPU's matrix
// unit; its other ops, the bf16 global instance and every f32 instance
// are f32 FMAs on the CUDA cores.
//
// Bound on an H100 (HBM 3.35 TB/s): at the served n=12, L=3 HEA body
// (glane + growmat, complex coefficients) the useful work per block per
// layer is 8*R*128^2 + 8*R^2*128 FLOP = 5.24 MFLOP (R=32), 15.7 MFLOP per
// block for the sweep, 0.50 GFLOP at 32 blocks, against ~2.1 MB of state
// in+out and 0.84 MB of coefficients: about 170 FLOP per byte. In f32
// (CUDA cores, 67 TFLOP/s) the sweep is bound by operations (~7.5 us at
// 32 blocks), not bytes; the f32 instance keeps off the tensor cores,
// whose TF32 keeps ~3 decimal digits against parity bounds of 1e-5. In
// bf16 the bytes halve and the FLOP run at the tensor cores' 989
// TFLOP/s, so its bound is the bytes (or, at large tb, the FLOP); what
// holds the bf16 cluster instance above it is the coefficients it
// streams from L2 into every cluster (the ring, below), not HBM.
//
// Two instances; the wrapper picks one per (width, tb) before the launch
// (ops/scan_body.py::_launch_config), never after a failure:
//
// - the CLUSTER instance (scan_body_cluster.cuh), every width whose state
//   fits a cluster's shared memory (n <= 17 at K <= 16): a thread-block
//   cluster of K CTAs per sample, the largest K whose tb clusters the
//   card keeps resident in one wave (an H100 SXM: K=16 at tb <= 7, 8 at
//   tb <= 15, 4 at tb <= 30, 2 at tb <= 66). Each CTA holds R/K rows
//   of the state (rows interleaved over the ranks), ping-ponged between
//   two shared-memory buffers, for the whole sweep; state leaves shared
//   memory only for the input read, the output write and (B, C) the
//   boundary write, which is an async bulk store (TMA engine) issued at
//   the top of the layer, overlapping its first op and awaited before
//   that buffer is written again. Lane products stream the 128x128
//   matrices through a ring of up to 128 KB in 16-row slabs, each slab
//   loaded once per group of CTAs that need it and multicast to the
//   group (bulk copies completing on one barrier per stage). Row
//   products copy the state over distributed shared memory in coalesced
//   chunks, beside their rows of the matrix. In f32 threads hold register
//   tiles of up to 8 rows x 1 lane, so each loaded coefficient serves
//   several rows and each state load (a float4 broadcast) several terms
//   (in bf16, warps hold m16n8k16 tiles, scan_body_mma.cuh); cluster
//   barriers stand only where an op reads other CTAs' rows or a stage is
//   refilled.
// - the GLOBAL instance (below), every wider width: one CTA per sample,
//   the state ping-ponged between the output and a scratch block in
//   global memory, one output element per thread per pass.
//
// Both copy the boundary only in their BND=true instance, chosen at
// launch (Launch A runs the copy-free one): compiled into the one
// global-memory kernel, the copy made the whole sweep ~1.45x slower on
// an NVIDIA H100 80GB HBM3 (700 W) even with null pointers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "scan_body_cluster.cuh"
#include "scan_body_common.cuh"

using namespace qfx;

namespace {

constexpr int THREADS = 256;

// out[r,k] = sum_j s[r,j] * M[j,k] (M picked per row by `sel`).
template <class T, bool HAS_IM>
__device__ void lane_product(const T* sre, const T* sim, T* dre, T* dim,
                             const T* __restrict__ mre,
                             const T* __restrict__ mim, int size,
                             int sel_shift, bool select_rows) {
  for (int e = threadIdx.x; e < size; e += blockDim.x) {
    const int r = e >> LANE_BITS;
    const int k = e & (LANES - 1);
    size_t moff = 0;
    if (select_rows) moff = (size_t)((r >> sel_shift) & 1) * LANES * LANES;
    const T* xr = sre + (size_t)r * LANES;
    const T* xi = sim + (size_t)r * LANES;
    const T* ar = mre + moff + k;
    float accr = 0.f, acci = 0.f;
    if (HAS_IM && IS_BF16<T>) {  // four products, each rounded apart
      const T* ai = mim + moff + k;
      float ii = 0.f, ri = 0.f;
#pragma unroll 8
      for (int j = 0; j < LANES; ++j) {
        const float a = to_f32(ar[j * LANES]), b = to_f32(ai[j * LANES]);
        const float u = to_f32(xr[j]), v = to_f32(xi[j]);
        accr = fmaf(u, a, accr);
        ii = fmaf(v, b, ii);
        acci = fmaf(v, a, acci);
        ri = fmaf(u, b, ri);
      }
      accr = cre_of<T>(accr, ii);
      acci = cim_of<T>(acci, ri);
    } else if (HAS_IM) {
      const T* ai = mim + moff + k;
#pragma unroll 8
      for (int j = 0; j < LANES; ++j) {
        const float a = to_f32(ar[j * LANES]), b = to_f32(ai[j * LANES]);
        const float u = to_f32(xr[j]), v = to_f32(xi[j]);
        accr = fmaf(u, a, accr);
        accr = fmaf(-v, b, accr);
        acci = fmaf(v, a, acci);
        acci = fmaf(u, b, acci);
      }
    } else {
#pragma unroll 8
      for (int j = 0; j < LANES; ++j) {
        const float a = to_f32(ar[j * LANES]);
        accr = fmaf(to_f32(xr[j]), a, accr);
        acci = fmaf(to_f32(xi[j]), a, acci);
      }
    }
    dre[e] = from_f32<T>(accr);
    dim[e] = from_f32<T>(acci);
  }
}

// out[r,k] = sum_s M[r,s] * x[s,k] (M picked per lane by `sel`).
template <class T, bool HAS_IM>
__device__ void row_product(const T* sre, const T* sim, T* dre, T* dim,
                            const T* __restrict__ mre,
                            const T* __restrict__ mim, int rows, int size,
                            int sel_shift, bool select_lanes) {
  for (int e = threadIdx.x; e < size; e += blockDim.x) {
    const int r = e >> LANE_BITS;
    const int k = e & (LANES - 1);
    size_t moff = (size_t)r * rows;
    if (select_lanes) moff += (size_t)((k >> sel_shift) & 1) * rows * rows;
    const T* ar = mre + moff;
    float accr = 0.f, acci = 0.f;
    if (HAS_IM && IS_BF16<T>) {  // four products, each rounded apart
      const T* ai = mim + moff;
      float ii = 0.f, ri = 0.f;
      for (int s = 0; s < rows; ++s) {
        const float a = to_f32(ar[s]), b = to_f32(ai[s]);
        const float u = to_f32(sre[s * LANES + k]);
        const float v = to_f32(sim[s * LANES + k]);
        accr = fmaf(u, a, accr);
        ii = fmaf(v, b, ii);
        acci = fmaf(v, a, acci);
        ri = fmaf(u, b, ri);
      }
      accr = cre_of<T>(accr, ii);
      acci = cim_of<T>(acci, ri);
    } else if (HAS_IM) {
      const T* ai = mim + moff;
      for (int s = 0; s < rows; ++s) {
        const float a = to_f32(ar[s]), b = to_f32(ai[s]);
        const float u = to_f32(sre[s * LANES + k]);
        const float v = to_f32(sim[s * LANES + k]);
        accr = fmaf(u, a, accr);
        accr = fmaf(-v, b, accr);
        acci = fmaf(v, a, acci);
        acci = fmaf(u, b, acci);
      }
    } else {
      for (int s = 0; s < rows; ++s) {
        const float a = to_f32(ar[s]);
        accr = fmaf(to_f32(sre[s * LANES + k]), a, accr);
        acci = fmaf(to_f32(sim[s * LANES + k]), a, acci);
      }
    }
    dre[e] = from_f32<T>(accr);
    dim[e] = from_f32<T>(acci);
  }
}

}  // namespace

// The global-memory instance: one CTA per state block (see the header).
template <class T, bool BND>
__global__ void __launch_bounds__(THREADS)
scan_body_kernel(const T* in_re, const T* in_im, T* out_re, T* out_im,
                 T* tmp_re, T* tmp_im, T* bnd_re, T* bnd_im,
                 const int* __restrict__ desc, int n_ops,
                 const T* __restrict__ coeffs,
                 const int* __restrict__ statics, int tb, int n,
                 int length) {
  const int b = blockIdx.x;
  const int rbits = n - LANE_BITS;
  const int rows = 1 << rbits;
  const int size = rows << LANE_BITS;
  const size_t boff = (size_t)b * size;

  T* buf_re[2] = {out_re + boff, tmp_re + boff};
  T* buf_im[2] = {out_im + boff, tmp_im + boff};
  // The last of the length*n_ops ops must write the output buffer.
  const int first = ((length * n_ops) & 1) ? 0 : 1;
  const T* sre = in_re + boff;
  const T* sim = in_im + boff;

  int step = 0;
  for (int l = 0; l < length; ++l) {
    if (BND) {
      const size_t loff = ((size_t)l * tb + b) * size;
      for (int e = threadIdx.x; e < size; e += blockDim.x) {
        bnd_re[loff + e] = sre[e];
        bnd_im[loff + e] = sim[e];
      }
    }
    for (int o = 0; o < n_ops; ++o, ++step) {
      const int* d = desc + o * DESC_W;
      const int kind = d[D_KIND];
      const int groups = d[D_GROUPS];
      const size_t gsize = (size_t)d[D_GSIZE];
      const size_t cidx = ((size_t)l * groups + (size_t)b * groups / tb) * gsize;
      const T* cre = coeffs + d[D_RE] + cidx;
      const T* cim = d[D_IM] >= 0 ? coeffs + d[D_IM] + cidx : nullptr;
      const int dst = (first + step) & 1;
      T* dre = buf_re[dst];
      T* dim = buf_im[dst];
      const int q0 = d[D_Q0], q1 = d[D_Q1];

      switch (kind) {
        case K_LANE:
        case K_GLANE: {
          const bool sel = kind == K_GLANE;
          const int shift = rbits - 1 - q0;
          if (cim)
            lane_product<T, true>(sre, sim, dre, dim, cre, cim, size, shift,
                                  sel);
          else
            lane_product<T, false>(sre, sim, dre, dim, cre, cim, size, shift,
                                   sel);
          break;
        }
        case K_ROWMAT:
        case K_GROWMAT: {
          const bool sel = kind == K_GROWMAT;
          const int shift = n - 1 - q0;
          if (cim)
            row_product<T, true>(sre, sim, dre, dim, cre, cim, rows, size,
                                 shift, sel);
          else
            row_product<T, false>(sre, sim, dre, dim, cre, cim, rows, size,
                                  shift, sel);
          break;
        }
        case K_MASK: {
          for (int e = threadIdx.x; e < size; e += blockDim.x) {
            const float u = to_f32(sre[e]), v = to_f32(sim[e]);
            const float a = to_f32(cre[e]);
            if (cim && IS_BF16<T>) {
              const float w = to_f32(cim[e]);
              dre[e] = from_f32<T>(cre_of<T>(u * a, v * w));
              dim[e] = from_f32<T>(cim_of<T>(v * a, u * w));
            } else if (cim) {
              const float w = to_f32(cim[e]);
              dre[e] = from_f32<T>(fmaf(u, a, -v * w));
              dim[e] = from_f32<T>(fmaf(v, a, u * w));
            } else {
              dre[e] = from_f32<T>(u * a);
              dim[e] = from_f32<T>(v * a);
            }
          }
          break;
        }
        case K_ROWPERM: {
          const int* perm = statics + d[D_STATIC];
          for (int e = threadIdx.x; e < size; e += blockDim.x) {
            const int r = e >> LANE_BITS;
            const int src = (perm[r] << LANE_BITS) | (e & (LANES - 1));
            dre[e] = sre[src];
            dim[e] = sim[src];
          }
          break;
        }
        case K_ROWPAIR: {
          // out[r] = sum_d g[o, o^d] * s[flip_d(r)], o = (bit q0, bit q1).
          const int m1 = 1 << (rbits - 1 - q0);
          const int m2 = 1 << (rbits - 1 - q1);
          for (int e = threadIdx.x; e < size; e += blockDim.x) {
            const int r = e >> LANE_BITS;
            const int k = e & (LANES - 1);
            const int o = (((r & m1) != 0) << 1) | ((r & m2) != 0);
            float accr = 0.f, acci = 0.f;
#pragma unroll
            for (int dd = 0; dd < 4; ++dd) {
              const int rr = r ^ ((dd & 2) ? m1 : 0) ^ ((dd & 1) ? m2 : 0);
              const int src = (rr << LANE_BITS) | k;
              const float u = to_f32(sre[src]), v = to_f32(sim[src]);
              const float a = to_f32(cre[o * 4 + (o ^ dd)]);
              if (IS_BF16<T>) {  // bf16 sums, term by term (_emit)
                accr = rnd<T>(accr + rnd<T>(u * a));
                acci = rnd<T>(acci + rnd<T>(v * a));
              } else {
                accr = fmaf(u, a, accr);
                acci = fmaf(v, a, acci);
              }
              if (cim) {
                const float w = to_f32(cim[o * 4 + (o ^ dd)]);
                if (IS_BF16<T>) {
                  accr = rnd<T>(accr - rnd<T>(v * w));
                  acci = rnd<T>(acci + rnd<T>(u * w));
                } else {
                  accr = fmaf(-v, w, accr);
                  acci = fmaf(u, w, acci);
                }
              }
            }
            dre[e] = from_f32<T>(accr);
            dim[e] = from_f32<T>(acci);
          }
          break;
        }
        case K_CNOT: {
          const bool c_row = q0 < rbits, t_row = q1 < rbits;
          for (int e = threadIdx.x; e < size; e += blockDim.x) {
            int r = e >> LANE_BITS;
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
            const int src = (r << LANE_BITS) | k;
            dre[e] = sre[src];
            dim[e] = sim[src];
          }
          break;
        }
        default:
          break;
      }
      __syncthreads();
      sre = dre;
      sim = dim;
    }
  }
}


namespace {

// Returned when the card cannot co-schedule one cluster of the requested
// size and shared memory (cudaOccupancyMaxActiveClusters gives 0).
constexpr int ERR_CLUSTER_UNSCHEDULABLE = 100000;

std::mutex config_mutex;
// The cluster instances' codes, as the C entries take them: 0 = f32, 1 =
// bf16 (tensor-core products, MMA = true).
template <class T, bool MMA>
constexpr int CODE = IS_BF16<T> ? 1 : 0;
// Per cluster instance [code][BND]: the dynamic shared memory its
// attribute allows, the non-portable cluster size switched on, and per K
// the largest shared memory whose cluster was checked to fit the card.
int smem_allowed[2][2];
bool nonportable_on[2][2];
int cluster_checked[2][2][MAX_CLUSTER + 1];

// Raise the cluster kernel's attributes to `smem` bytes of dynamic shared
// memory and, above 8 CTAs, the non-portable cluster size (the caller
// holds config_mutex).
template <class T, bool BND, bool MMA>
cudaError_t cluster_attrs(int cluster, int smem) {
  auto kern = scan_body_cluster_kernel<T, BND, MMA>;
  constexpr int C = CODE<T, MMA>;
  cudaError_t err;
  if (smem_allowed[C][BND] < smem) {  // the attribute only grows
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_allowed[C][BND] = smem;
  }
  if (cluster > 8 && !nonportable_on[C][BND]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    nonportable_on[C][BND] = true;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t cluster_config(int tb, int cluster, int smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tb * cluster));
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <class T, bool BND, bool MMA>
int launch_cluster(const T* in_re, const T* in_im, T* out_re, T* out_im,
                   T* bnd_re, T* bnd_im, const int* desc, int n_ops,
                   const T* coeffs, const int* statics, int tb, int n,
                   int length, int cluster, int smem, cudaStream_t stream) {
  auto kern = scan_body_cluster_kernel<T, BND, MMA>;
  constexpr bool TC = IS_BF16<T> && MMA;
  constexpr int C = CODE<T, MMA>;
  // What the state buffers (f32), the tensor-core instance's bf16 copy of
  // its rows and the descriptor table leave of `smem` is the stage region,
  // in units of UNIT_ELEMS elements of T (ops/scan_body.py::_cluster_smem
  // sizes it).
  const int rk = (1 << (n - LANE_BITS)) / cluster;
  const int opnd_bytes = TC ? 2 * rk * OPND_PITCH * (int)sizeof(T) : 0;
  const int units = (smem - 2 * 2 * rk * LANES * 4 - opnd_bytes -
                     n_ops * DESC_W * 4) /
                    (UNIT_ELEMS * (int)sizeof(T));
  if (units < 4 || units > (TC ? MMA_MAX_UNITS : MAX_UNITS))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(tb, cluster, smem, stream, attr);
  {
    std::lock_guard<std::mutex> lock(config_mutex);
    cudaError_t err = cluster_attrs<T, BND, MMA>(cluster, smem);
    if (err != cudaSuccess) return (int)err;
    if (cluster_checked[C][BND][cluster] < smem) {
      int active = 0;
      err = cudaOccupancyMaxActiveClusters(&active, (const void*)kern, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (active < 1) return ERR_CLUSTER_UNSCHEDULABLE;
      cluster_checked[C][BND][cluster] = smem;
    }
  }
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, in_re, in_im, out_re,
                                       out_im, bnd_re, bnd_im, desc, n_ops,
                                       coeffs, statics, tb, n, length,
                                       units);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class T, bool MMA>
int launch(const void* in_re, const void* in_im, void* out_re, void* out_im,
           void* tmp_re, void* tmp_im, void* bnd_re, void* bnd_im,
           const int* desc, int n_ops, const void* coeffs,
           const int* statics, int tb, int n, int length, cudaStream_t st,
           int cluster, int smem) {
  const T* ir = (const T*)in_re;
  const T* ii = (const T*)in_im;
  T* orr = (T*)out_re;
  T* oi = (T*)out_im;
  T* br = (T*)bnd_re;
  T* bi = (T*)bnd_im;
  const T* c = (const T*)coeffs;
  if (cluster > 0) {
    if (cluster > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
    if (br != nullptr)
      return launch_cluster<T, true, MMA>(ir, ii, orr, oi, br, bi, desc,
                                          n_ops, c, statics, tb, n, length,
                                          cluster, smem, st);
    return launch_cluster<T, false, MMA>(ir, ii, orr, oi, br, bi, desc,
                                         n_ops, c, statics, tb, n, length,
                                         cluster, smem, st);
  }
  if (br != nullptr)
    scan_body_kernel<T, true><<<tb, THREADS, 0, st>>>(
        ir, ii, orr, oi, (T*)tmp_re, (T*)tmp_im, br, bi, desc, n_ops, c,
        statics, tb, n, length);
  else
    scan_body_kernel<T, false><<<tb, THREADS, 0, st>>>(
        ir, ii, orr, oi, (T*)tmp_re, (T*)tmp_im, br, bi, desc, n_ops, c,
        statics, tb, n, length);
  return (int)cudaGetLastError();
}

template <class T, bool MMA>
int max_clusters(int cluster, int smem, int* active) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(1, cluster, smem, nullptr, attr);
  std::lock_guard<std::mutex> lock(config_mutex);
  cudaError_t err = cluster_attrs<T, false, MMA>(cluster, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(
      active, (const void*)scan_body_cluster_kernel<T, false, MMA>, &cfg);
}

template <class T, bool MMA>
cudaError_t attrs_of(cudaFuncAttributes* a, int cluster, int bnd) {
  if (cluster)
    return bnd ? cudaFuncGetAttributes(
                     a, scan_body_cluster_kernel<T, true, MMA>)
               : cudaFuncGetAttributes(
                     a, scan_body_cluster_kernel<T, false, MMA>);
  return bnd ? cudaFuncGetAttributes(a, scan_body_kernel<T, true>)
             : cudaFuncGetAttributes(a, scan_body_kernel<T, false>);
}

}  // namespace

#ifndef QFX_INSTANCE
#error "build with -DQFX_INSTANCE=0 (the f32 instances) or 1 (the bf16 ones)"
#elif QFX_INSTANCE == 0
using Elem = float;  // this library's element type and its dtype code
constexpr bool kMma = false;
#else
using Elem = bf16;
constexpr bool kMma = true;
#endif

// Plain C entry (bound with ctypes). Pointers are device pointers; the
// kernel runs on `stream` and is not synchronised. `dtype` names the
// element type of the state, boundaries and coefficients: 0 = f32, 1 =
// bf16 (the instance of that type runs; there is no conversion; the bf16
// cluster instance takes its lane and row products on the tensor cores).
// bnd_re/bnd_im are both null (no boundaries) or both (L, tb, R, 128)
// outputs. `cluster` = 0 launches the global instance (tmp_re/tmp_im: a
// scratch block like the output); `cluster` = K >= 1 launches the cluster
// instance with K CTAs per sample and `smem` bytes of dynamic shared
// memory (tmp unused). Returns the CUDA error of the launch (0 =
// launched), or ERR_CLUSTER_UNSCHEDULABLE.
extern "C" int qfx_scan_body_launch(const void* in_re, const void* in_im,
                                    void* out_re, void* out_im, void* tmp_re,
                                    void* tmp_im, void* bnd_re, void* bnd_im,
                                    const int* desc, int n_ops,
                                    const void* coeffs, const int* statics,
                                    int tb, int n, int length, int device,
                                    void* stream, int cluster, int smem,
                                    int dtype) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype != QFX_INSTANCE) return (int)cudaErrorInvalidValue;
  return launch<Elem, kMma>(in_re, in_im, out_re, out_im, tmp_re, tmp_im,
                            bnd_re, bnd_im, desc, n_ops, coeffs, statics, tb,
                            n, length, st, cluster, smem);
}

// How many clusters of `cluster` CTAs with `smem` bytes of dynamic shared
// memory each the card keeps resident at once (cudaOccupancyMaxActive-
// Clusters) for the instance of `dtype`, into *active. Returns the CUDA
// error (0 = filled).
extern "C" int qfx_scan_body_max_clusters(int cluster, int smem, int dtype,
                                          int* active) {
  if (dtype != QFX_INSTANCE) return (int)cudaErrorInvalidValue;
  return max_clusters<Elem, kMma>(cluster, smem, active);
}

// Registers, local (spill) bytes and static shared memory of one compiled
// instance (cluster != 0: the cluster kernel; bnd != 0: its BND one; dtype
// as above), by cudaFuncGetAttributes. Returns the CUDA error (0 =
// filled).
extern "C" int qfx_scan_body_attrs(int cluster, int bnd, int dtype,
                                   int* regs, int* local_bytes,
                                   int* static_smem) {
  cudaFuncAttributes a;
  if (dtype != QFX_INSTANCE) return (int)cudaErrorInvalidValue;
  cudaError_t err = attrs_of<Elem, kMma>(&a, cluster, bnd);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *static_smem = (int)a.sharedSizeBytes;
  return 0;
}
