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
// optionally copy the block to boundary slot (l, b), then apply the
// layer's op sequence (lane / rowmat / mask / glane / growmat / rowperm /
// rowpair / cnot in its four placements) to the block, layer after layer.
//
// Design (simple and right first):
// - grid = tb blocks, one CTA per state block; the TPU's sequential layer
//   grid axis becomes a loop over the L layers inside the CTA, with the op
//   sequence inside that loop and __syncthreads() between ops (row ops
//   read other rows).
// - boundaries (bnd_re/bnd_im non-null, each (L, tb, R, 128)): at the top
//   of layer l the CTA copies its current state -- the input at l = 0,
//   else whichever ping-pong buffer the previous op wrote, published by
//   that op's trailing __syncthreads() -- to slot (l, b). The first op of
//   the layer reads the same buffer and writes the other one, so the copy
//   needs no barrier of its own. The copy is a template parameter chosen
//   at launch (null pointers = Launch A), not a runtime test: compiled
//   into the one kernel, it made the whole sweep ~1.45x slower on an H100
//   even with null pointers, so Launch A keeps the copy-free instance.
// - the state ping-pongs between the output block and a scratch block in
//   global memory (both allocated by the wrapper); the first op reads the
//   input, and the buffer the first op writes is chosen so that the last
//   op of the sweep lands in the output. At n=12 a block is 32 KB (re+im),
//   so the working set stays in L1/L2.
// - the op program arrives as an int32 descriptor table (DESC_W ints per
//   op), the stacked coefficients packed in one f32 buffer laid out
//   (L, G, gate...) per op (re, then im when present), and the static
//   rowperm indices in one int32 buffer. A lane CNOT is applied as its
//   index permutation, glane/growmat compute only the branch each row /
//   lane selects, and every complex product is f32 FMAs (4 real products,
//   2 when the coefficients are real).
//
// Bound on an H100 (f32 CUDA cores, 67 TFLOP/s; HBM 3.35 TB/s): at the
// served n=12, L=3 HEA body (glane + growmat, complex coefficients) the
// useful work per block per layer is 8*R*128^2 + 8*R^2*128 FLOP = 5.24
// MFLOP (R=32), 15.7 MFLOP per block for the sweep, 0.50 GFLOP at bucket
// 32, against ~2.1 MB of state in+out and 0.84 MB of coefficients: about
// 170 FLOP per byte, so the sweep is bound by operations (~7.5 us at
// bucket 32), not bytes. This first version keeps every operand in global
// memory and one output element per thread per pass; it does not reach
// that bound — wgmma/TF32 tiles and shared-memory staging are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int LANE_BITS = 7;
constexpr int DESC_W = 8;
constexpr int THREADS = 256;

// Descriptor fields.
constexpr int D_KIND = 0;    // op kind code (below)
constexpr int D_Q0 = 1;      // first qubit (control for glane/growmat/cnot)
constexpr int D_Q1 = 2;      // second qubit (rowpair q2, cnot target)
constexpr int D_RE = 3;      // offset of the re coefficients (floats)
constexpr int D_IM = 4;      // offset of the im coefficients, -1 = real
constexpr int D_GROUPS = 5;  // coefficient groups G (G divides tb)
constexpr int D_GSIZE = 6;   // floats per (layer, group) gate
constexpr int D_STATIC = 7;  // offset into the int32 statics (rowperm)

enum Kind {
  K_LANE = 0,
  K_ROWMAT = 1,
  K_MASK = 2,
  K_GLANE = 3,
  K_GROWMAT = 4,
  K_ROWPERM = 5,
  K_ROWPAIR = 6,
  K_CNOT = 7,
};

// out[r,k] = sum_j s[r,j] * M[j,k] (M picked per row by `sel`).
template <bool HAS_IM>
__device__ void lane_product(const float* sre, const float* sim, float* dre,
                             float* dim, const float* __restrict__ mre,
                             const float* __restrict__ mim, int size,
                             int sel_shift, bool select_rows) {
  for (int e = threadIdx.x; e < size; e += blockDim.x) {
    const int r = e >> LANE_BITS;
    const int k = e & (LANES - 1);
    size_t moff = 0;
    if (select_rows) moff = (size_t)((r >> sel_shift) & 1) * LANES * LANES;
    const float* xr = sre + (size_t)r * LANES;
    const float* xi = sim + (size_t)r * LANES;
    const float* ar = mre + moff + k;
    float accr = 0.f, acci = 0.f;
    if (HAS_IM) {
      const float* ai = mim + moff + k;
#pragma unroll 8
      for (int j = 0; j < LANES; ++j) {
        const float a = ar[j * LANES], b = ai[j * LANES];
        const float u = xr[j], v = xi[j];
        accr = fmaf(u, a, accr);
        accr = fmaf(-v, b, accr);
        acci = fmaf(v, a, acci);
        acci = fmaf(u, b, acci);
      }
    } else {
#pragma unroll 8
      for (int j = 0; j < LANES; ++j) {
        const float a = ar[j * LANES];
        accr = fmaf(xr[j], a, accr);
        acci = fmaf(xi[j], a, acci);
      }
    }
    dre[e] = accr;
    dim[e] = acci;
  }
}

// out[r,k] = sum_s M[r,s] * x[s,k] (M picked per lane by `sel`).
template <bool HAS_IM>
__device__ void row_product(const float* sre, const float* sim, float* dre,
                            float* dim, const float* __restrict__ mre,
                            const float* __restrict__ mim, int rows,
                            int size, int sel_shift, bool select_lanes) {
  for (int e = threadIdx.x; e < size; e += blockDim.x) {
    const int r = e >> LANE_BITS;
    const int k = e & (LANES - 1);
    size_t moff = (size_t)r * rows;
    if (select_lanes) moff += (size_t)((k >> sel_shift) & 1) * rows * rows;
    const float* ar = mre + moff;
    float accr = 0.f, acci = 0.f;
    if (HAS_IM) {
      const float* ai = mim + moff;
      for (int s = 0; s < rows; ++s) {
        const float a = ar[s], b = ai[s];
        const float u = sre[s * LANES + k], v = sim[s * LANES + k];
        accr = fmaf(u, a, accr);
        accr = fmaf(-v, b, accr);
        acci = fmaf(v, a, acci);
        acci = fmaf(u, b, acci);
      }
    } else {
      for (int s = 0; s < rows; ++s) {
        const float a = ar[s];
        accr = fmaf(sre[s * LANES + k], a, accr);
        acci = fmaf(sim[s * LANES + k], a, acci);
      }
    }
    dre[e] = accr;
    dim[e] = acci;
  }
}

}  // namespace

template <bool BND>
__global__ void __launch_bounds__(THREADS)
scan_body_kernel(const float* in_re, const float* in_im, float* out_re,
                 float* out_im, float* tmp_re, float* tmp_im,
                 float* bnd_re, float* bnd_im,
                 const int* __restrict__ desc, int n_ops,
                 const float* __restrict__ coeffs,
                 const int* __restrict__ statics, int tb, int n,
                 int length) {
  const int b = blockIdx.x;
  const int rbits = n - LANE_BITS;
  const int rows = 1 << rbits;
  const int size = rows << LANE_BITS;
  const size_t boff = (size_t)b * size;

  float* buf_re[2] = {out_re + boff, tmp_re + boff};
  float* buf_im[2] = {out_im + boff, tmp_im + boff};
  // The last of the length*n_ops ops must write the output buffer.
  const int first = ((length * n_ops) & 1) ? 0 : 1;
  const float* sre = in_re + boff;
  const float* sim = in_im + boff;

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
      const float* cre = coeffs + d[D_RE] + cidx;
      const float* cim = d[D_IM] >= 0 ? coeffs + d[D_IM] + cidx : nullptr;
      const int dst = (first + step) & 1;
      float* dre = buf_re[dst];
      float* dim = buf_im[dst];
      const int q0 = d[D_Q0], q1 = d[D_Q1];

      switch (kind) {
        case K_LANE:
        case K_GLANE: {
          const bool sel = kind == K_GLANE;
          const int shift = rbits - 1 - q0;
          if (cim)
            lane_product<true>(sre, sim, dre, dim, cre, cim, size, shift, sel);
          else
            lane_product<false>(sre, sim, dre, dim, cre, cim, size, shift, sel);
          break;
        }
        case K_ROWMAT:
        case K_GROWMAT: {
          const bool sel = kind == K_GROWMAT;
          const int shift = n - 1 - q0;
          if (cim)
            row_product<true>(sre, sim, dre, dim, cre, cim, rows, size, shift,
                              sel);
          else
            row_product<false>(sre, sim, dre, dim, cre, cim, rows, size, shift,
                               sel);
          break;
        }
        case K_MASK: {
          for (int e = threadIdx.x; e < size; e += blockDim.x) {
            const float u = sre[e], v = sim[e], a = cre[e];
            if (cim) {
              const float w = cim[e];
              dre[e] = fmaf(u, a, -v * w);
              dim[e] = fmaf(v, a, u * w);
            } else {
              dre[e] = u * a;
              dim[e] = v * a;
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
              const float u = sre[src], v = sim[src];
              const float a = cre[o * 4 + (o ^ dd)];
              accr = fmaf(u, a, accr);
              acci = fmaf(v, a, acci);
              if (cim) {
                const float w = cim[o * 4 + (o ^ dd)];
                accr = fmaf(-v, w, accr);
                acci = fmaf(u, w, acci);
              }
            }
            dre[e] = accr;
            dim[e] = acci;
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

// Plain C entry (bound with ctypes). Pointers are device pointers; the
// kernel runs on `stream` and is not synchronised. bnd_re/bnd_im are both
// null (no boundaries) or both (L, tb, R, 128) f32 outputs. Returns the
// CUDA error of the launch (0 = launched).
extern "C" int qfx_scan_body_launch(const float* in_re, const float* in_im,
                                    float* out_re, float* out_im,
                                    float* tmp_re, float* tmp_im,
                                    float* bnd_re, float* bnd_im,
                                    const int* desc, int n_ops,
                                    const float* coeffs, const int* statics,
                                    int tb, int n, int length, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bnd_re != nullptr)
    scan_body_kernel<true><<<tb, THREADS, 0, (cudaStream_t)stream>>>(
        in_re, in_im, out_re, out_im, tmp_re, tmp_im, bnd_re, bnd_im, desc,
        n_ops, coeffs, statics, tb, n, length);
  else
    scan_body_kernel<false><<<tb, THREADS, 0, (cudaStream_t)stream>>>(
        in_re, in_im, out_re, out_im, tmp_re, tmp_im, bnd_re, bnd_im, desc,
        n_ops, coeffs, statics, tb, n, length);
  return (int)cudaGetLastError();
}
