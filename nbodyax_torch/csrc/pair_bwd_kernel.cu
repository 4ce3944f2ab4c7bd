// Analytic backward pass of the fused all-pairs kernel, for one NVIDIA Hopper
// card.
//
// Replaces the TPU kernel nbodyax/physics/kernels_bwd.py::_bwd_kernel
// (launched by _bwd_pass through raw_backward), in both of its forms, D = 2
// and D = 3. It computes the VJP of the raw channels of pair_kernel.cu with
// respect to both feature operands; the per-pair formulas are in
// nbodyax_torch/physics/kernels_bwd.py, whose raw_backward_reference is the
// plain PyTorch version of this kernel.
//
// Inputs: the i bodies f32[Ni, 8] and the j bodies f32[Nj, 8]
// (body_features layout: pos[0:D], vel[D:2D], mass at 2D, radius at 2D+1,
// zero padding), the raw-channel cotangent g f32[Ni, 8] of the i bodies
// (force at 0..D-1; gained mass and radius at D, D+1 in reference mode; dv
// at D..2D-1 in elastic mode), and the global ids of row 0 of each side.
// Outputs d_fi f32[Ni, 8] and d_fj f32[Nj, 8]: the gradients of the
// features, in the same layout. Each output row sums over every partner of
// the other side; which side a block computes is its blockIdx.z:
//
//   side i: rows are the i bodies; each row's own cotangent stays in
//           registers and the j partners stream through shared memory;
//   side j: rows are the j bodies; the i partners stream through shared
//           memory together with their cotangents.
//
// What bounds it: FP32 work on the CUDA cores, about 29 flops and one rsqrt
// a pair and side on the force path in 2-D (the forward's distance and
// gates, the cube, g.u, the 3 s (g.u)/d2e term, two gradient components,
// the sums) and 39 in 3-D (a third subtract, its square and add into d2,
// a third product and add in g.u, a third gradient component of four flops
// and its add), twice that a pair for the two sides; each partner is read
// from device memory once per block. No wgmma, for the forward's reason:
// distances are computed subtract-first so that the gates round as the
// forward's do.
//
// Design (the forward's, pair_kernel.cu; the partner split and the combine
// are in pair_common.cuh and below):
//
// - One launch computes both sides: the grid is (row blocks) x (splits) x
//   (side), each side with its own split count, so one call fills the card
//   once. With one split a side writes its output; with more it writes
//   f32[S, rows, 8] partials, and pair_bwd_combine Kahan-adds them in split
//   order for every side that has them (a second launch). No atomics, so
//   gradients repeat bit for bit.
// - Each thread owns kRows rows; one float4 partner from shared memory
//   ((x, y, m, r) in 2-D; (x, y, z, m) plus a float radius in 3-D), its
//   velocity in elastic mode (float2, or float4 (vx, vy, vz, 0)) and, on
//   side j, the float4 of the partner's cotangent (g0..g3), plus a float2
//   (g4, g5) in 3-D reference and elastic mode, feed kRows pair chains.
// - Position and mass gradients are summed plainly over kSub = 32 partners
//   and Kahan-added into the row's total.
// - rsqrt is the SFU's own (rsqrt_sfu in pair_common.cuh).
// - The dimension is a template parameter: the 2-D instantiation is the
//   code and the results of the 2-D-only kernel.
//
// Gates: the backward must leave out exactly the pairs the forward left out,
// or a pair at the overlap threshold is gravity in one pass and contact in
// the other. d2, rsum^2 and v.p (each summed over the axes left to right)
// are therefore rounded as pair_kernel.cu rounds them (__fmul_rn /
// __fadd_rn, never contracted into FMAs); u is p_j - p_i on both sides, as
// in the forward. Every pair is gated on m_j > 0 and not-self by int32
// global id; the force term also on d2 + eps2 > 0 and, outside elastic
// mode, on not overlapping; the elastic term on overlapping, approaching
// and d2 > 0. The elastic terms use IEEE division (no -use_fast_math).

#include <algorithm>
#include <type_traits>

#include "pair_common.cuh"

namespace {

using namespace nbodyax;

constexpr int kRows = 2;                      // rows a thread owns
constexpr int kBlockRows = kThreads * kRows;

enum SideId { kSideI = 0, kSideJ = 1 };

// One side of the call: its rows, its partners and where its sums go (the
// output with one split, the partial buffer with more).
struct Side {
  const float* rows;
  const float* cols;
  float* dst;
  int nr, nc, r_off, c_off, splits, chunk;
};

// Cotangent channels each mode reads: force (0..D-1) always; reference adds
// the gained mass and radius (D, D+1) on side j; elastic adds the halved dv
// (D..2D-1). In 3-D the channels past 3 (g4, g5) ride a second vector.
template <int MODE, int SIDE, int DIM>
struct Uses {
  static constexpr bool kMergeG = MODE == kReference && SIDE == kSideJ;
  static constexpr bool kVel = MODE == kElastic;
  static constexpr bool kG45 = DIM == 3 && (kMergeG || kVel);
};

// The shared staging of one tile of partners (declared in pair_bwd_kernel).
template <int DIM>
struct Stage {
  using Vel = std::conditional_t<DIM == 3, float4, float2>;
  float4* sp;     // 2-D: x, y, m, r; 3-D: x, y, z, m
  float* sr;      // 3-D: r
  Vel* sv;        // elastic: velocity
  float4* sg;     // side j: g0..g3
  float2* sg45;   // side j, 3-D reference and elastic: g4, g5
};

template <int MODE, int SIDE, int DIM>
__device__ __forceinline__ void bwd_side(const Side& sd,
                                         const float* __restrict__ g,
                                         float eps2, float growth,
                                         const Stage<DIM>& st) {
  using U = Uses<MODE, SIDE, DIM>;
  using Vel = typename Stage<DIM>::Vel;
  constexpr bool kRowsAreI = SIDE == kSideI;
  if (static_cast<int>(blockIdx.x) * kBlockRows >= sd.nr ||
      static_cast<int>(blockIdx.y) >= sd.splits) {
    return;                                   // the whole block: uniform
  }
  float* dst = sd.dst + static_cast<long long>(blockIdx.y) * sd.nr * kFeats;

  const int row0 = blockIdx.x * kBlockRows + threadIdx.x;
  float xr[kRows], yr[kRows], zr[kRows], vxr[kRows], vyr[kRows], vzr[kRows];
  float mr[kRows], rr[kRows];
  float4 gr[kRows];                           // side i: own cotangent g0..g3
  float2 gr45[kRows];                         // and g4, g5
  int gid[kRows];
  float px[kRows], py[kRows], pz[kRows], pm[kRows];   // Kahan sums: position,
  float cpx[kRows], cpy[kRows], cpz[kRows], cpm[kRows];   // mass, and their
  float dvx[kRows], dvy[kRows], dvz[kRows], drad[kRows];  // compensations
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = row0 + k * kThreads;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    gr[k] = a;
    gr45[k] = make_float2(0.f, 0.f);
    if (row < sd.nr) {
      load_row(sd.rows + static_cast<long long>(row) * kFeats, a, b);
      if constexpr (kRowsAreI) {
        const float4* q = reinterpret_cast<const float4*>(
            g + static_cast<long long>(row) * kCh);
        gr[k] = q[0];
        if constexpr (U::kG45) gr45[k] = make_float2(q[1].x, q[1].y);
      }
    }
    if constexpr (DIM == 3) {
      xr[k] = a.x; yr[k] = a.y; zr[k] = a.z;
      vxr[k] = a.w; vyr[k] = b.x; vzr[k] = b.y;
      mr[k] = b.z; rr[k] = b.w;
    } else {
      xr[k] = a.x; yr[k] = a.y; zr[k] = 0.f;
      vxr[k] = a.z; vyr[k] = a.w; vzr[k] = 0.f;
      mr[k] = b.x; rr[k] = b.y;
    }
    gid[k] = sd.r_off + row;
    px[k] = py[k] = pz[k] = pm[k] = 0.f;
    cpx[k] = cpy[k] = cpz[k] = cpm[k] = 0.f;
    dvx[k] = dvy[k] = dvz[k] = drad[k] = 0.f;
  }

  const int cb = blockIdx.y * sd.chunk;
  const int ce = min(sd.nc, cb + sd.chunk);
  for (int base = cb; base < ce; base += kTile) {
    const int count = min(kTile, ce - base);
    for (int t = threadIdx.x; t < count; t += kThreads) {
      float4 a, b;
      load_row(sd.cols + static_cast<long long>(base + t) * kFeats, a, b);
      if constexpr (DIM == 3) {
        st.sp[t] = make_float4(a.x, a.y, a.z, b.z);
        st.sr[t] = b.w;
        if constexpr (U::kVel) st.sv[t] = make_float4(a.w, b.x, b.y, 0.f);
      } else {
        st.sp[t] = make_float4(a.x, a.y, b.x, b.y);
        if constexpr (U::kVel) st.sv[t] = make_float2(a.z, a.w);
      }
      // side j: the partners are the i bodies, whose cotangents stream too
      if constexpr (!kRowsAreI) {
        const float4* q = reinterpret_cast<const float4*>(
            g + static_cast<long long>(base + t) * kCh);
        st.sg[t] = q[0];
        if constexpr (U::kG45) st.sg45[t] = make_float2(q[1].x, q[1].y);
      }
    }
    __syncthreads();
    for (int t0 = 0; t0 < count; t0 += kSub) {
      const int t1 = min(count, t0 + kSub);
      float sx[kRows], sy[kRows], sz[kRows], sm[kRows];  // this sub-tile
#pragma unroll
      for (int k = 0; k < kRows; ++k) sx[k] = sy[k] = sz[k] = sm[k] = 0.f;
#pragma unroll 2
      for (int t = t0; t < t1; ++t) {
        const float4 p = st.sp[t];
        float pzc = 0.f, pmc, prc;              // the partner's z, m, r
        if constexpr (DIM == 3) {
          pzc = p.z; pmc = p.w; prc = st.sr[t];
        } else {
          pmc = p.z; prc = p.w;
        }
        const int gc = sd.c_off + base + t;
        float4 ph = make_float4(0.f, 0.f, 0.f, 0.f);
        float2 ph45 = make_float2(0.f, 0.f);
        if constexpr (!kRowsAreI) {
          ph = st.sg[t];
          if constexpr (U::kG45) ph45 = st.sg45[t];
        }
        Vel pv{};
        if constexpr (U::kVel) pv = st.sv[t];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          // the i and j bodies of this pair, whichever side the rows are
          const float xi = kRowsAreI ? xr[k] : p.x;
          const float yi = kRowsAreI ? yr[k] : p.y;
          const float zi = kRowsAreI ? zr[k] : pzc;
          const float xj = kRowsAreI ? p.x : xr[k];
          const float yj = kRowsAreI ? p.y : yr[k];
          const float zj = kRowsAreI ? pzc : zr[k];
          const float mi = kRowsAreI ? mr[k] : pmc;
          const float mj = kRowsAreI ? pmc : mr[k];
          const float ri = kRowsAreI ? rr[k] : prc;
          const float rj = kRowsAreI ? prc : rr[k];
          const int gi = kRowsAreI ? gid[k] : gc;
          const int gj = kRowsAreI ? gc : gid[k];
          // the cotangent of body i: force, merge and dv channels
          const float4 h = kRowsAreI ? gr[k] : ph;
          const float2 h45 = kRowsAreI ? gr45[k] : ph45;
          float gfx, gfy, gfz = 0.f, gm, grad, gvx, gvy, gvz = 0.f;
          if constexpr (DIM == 3) {
            gfx = h.x; gfy = h.y; gfz = h.z;
            gm = h.w; grad = h45.x;
            gvx = h.w; gvy = h45.x; gvz = h45.y;
          } else {
            gfx = h.x; gfy = h.y;
            gm = h.z; grad = h.w;
            gvx = h.z; gvy = h.w;
          }

          // the forward's roundings (pair_kernel.cu): u = p_j - p_i
          const float ux = __fsub_rn(xj, xi);
          const float uy = __fsub_rn(yj, yi);
          float d2 = __fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy));
          float uz = 0.f;
          if constexpr (DIM == 3) {
            uz = __fsub_rn(zj, zi);
            d2 = __fadd_rn(d2, __fmul_rn(uz, uz));
          }
          const float rsum = __fadd_rn(ri, rj);
          const bool overlap = d2 <= __fmul_rn(rsum, rsum);
          const bool live = mj > 0.f && gi != gj;
          const float d2e = __fadd_rn(d2, eps2);

          float ex = 0.f, ey = 0.f, ez = 0.f, em = 0.f;   // this pair's row
          const bool c = live && d2e > 0.f && (MODE == kElastic || !overlap);
          if (c) {
            const float inv = rsqrt_sfu(d2e);
            const float s = inv * inv * inv;
            float gdotu = gfx * ux + gfy * uy;
            if constexpr (DIM == 3) gdotu = gdotu + gfz * uz;
            const float tt = 3.f * (inv * inv) * s * gdotu;
            if constexpr (kRowsAreI) {
              ex = mj * (tt * ux - s * gfx);
              ey = mj * (tt * uy - s * gfy);
              if constexpr (DIM == 3) ez = mj * (tt * uz - s * gfz);
            } else {
              ex = mj * (s * gfx - tt * ux);
              ey = mj * (s * gfy - tt * uy);
              if constexpr (DIM == 3) ez = mj * (s * gfz - tt * uz);
              em = s * gdotu;
            }
          }
          if constexpr (U::kMergeG) {
            if (overlap && live && mi >= mj) {
              em += gm;
              drad[k] += growth * grad;
            }
          }
          if constexpr (U::kVel) {
            float vxi, vyi, vzi = 0.f, vxj, vyj, vzj = 0.f;
            if constexpr (DIM == 3) {
              vxi = kRowsAreI ? vxr[k] : pv.x;
              vyi = kRowsAreI ? vyr[k] : pv.y;
              vzi = kRowsAreI ? vzr[k] : pv.z;
              vxj = kRowsAreI ? pv.x : vxr[k];
              vyj = kRowsAreI ? pv.y : vyr[k];
              vzj = kRowsAreI ? pv.z : vzr[k];
            } else {
              vxi = kRowsAreI ? vxr[k] : pv.x;
              vyi = kRowsAreI ? vyr[k] : pv.y;
              vxj = kRowsAreI ? pv.x : vxr[k];
              vyj = kRowsAreI ? pv.y : vyr[k];
            }
            const float rvx = vxj - vxi;
            const float rvy = vyj - vyi;
            float vdotp = __fadd_rn(__fmul_rn(rvx, ux), __fmul_rn(rvy, uy));
            float rvz = 0.f;
            if constexpr (DIM == 3) {
              rvz = vzj - vzi;
              vdotp = __fadd_rn(vdotp, __fmul_rn(rvz, uz));
            }
            if (overlap && live && vdotp < 0.f && d2 > 0.f) {
              const float invd2 = 1.f / d2;
              const float minv = 1.f / (mi + mj);
              const float recip = minv * invd2;
              const float q = vdotp * recip;
              float hdotu = gvx * ux + gvy * uy;
              if constexpr (DIM == 3) hdotu = hdotu + gvz * uz;
              const float gq = hdotu * recip;
              const float sgn = kRowsAreI ? -1.f : 1.f;
              const float w = 2.f * vdotp * invd2;
              ex += sgn * (mj * (gq * (rvx - w * ux) + q * gvx));
              ey += sgn * (mj * (gq * (rvy - w * uy) + q * gvy));
              dvx[k] += sgn * (mj * gq * ux);
              dvy[k] += sgn * (mj * gq * uy);
              if constexpr (DIM == 3) {
                ez += sgn * (mj * (gq * (rvz - w * uz) + q * gvz));
                dvz[k] += sgn * (mj * gq * uz);
              }
              em += sgn * (hdotu * q * minv * (kRowsAreI ? mj : mi));
            }
          }
          sx[k] += ex;
          sy[k] += ey;
          if constexpr (DIM == 3) sz[k] += ez;
          if constexpr (!kRowsAreI || MODE == kElastic) sm[k] += em;
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        kahan_add(px[k], cpx[k], sx[k]);
        kahan_add(py[k], cpy[k], sy[k]);
        if constexpr (DIM == 3) kahan_add(pz[k], cpz[k], sz[k]);
        if constexpr (!kRowsAreI || MODE == kElastic) {
          kahan_add(pm[k], cpm[k], sm[k]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = row0 + k * kThreads;
    if (row >= sd.nr) continue;
    float* o = dst + static_cast<long long>(row) * kFeats;
    if constexpr (DIM == 3) {
      store_row(o, make_float4(px[k], py[k], pz[k], dvx[k]),
                make_float4(dvy[k], dvz[k], pm[k], drad[k]));
    } else {
      store_row(o, make_float4(px[k], py[k], dvx[k], dvy[k]),
                make_float4(pm[k], drad[k], 0.f, 0.f));
    }
  }
}

template <int MODE, int DIM>
__global__ void __launch_bounds__(kThreads, 4)
pair_bwd_kernel(Side si, Side sj, const float* __restrict__ g, float eps2,
                float growth) {
  using Vel = typename Stage<DIM>::Vel;
  constexpr bool kG45 = Uses<MODE, kSideJ, DIM>::kG45;
  __shared__ float4 sp[kTile];
  __shared__ float sr[DIM == 3 ? kTile : 1];
  __shared__ Vel sv[MODE == kElastic ? kTile : 1];
  __shared__ float4 sg[kTile];
  __shared__ float2 sg45[kG45 ? kTile : 1];
  const Stage<DIM> st{sp, sr, sv, sg, sg45};
  if (blockIdx.z == kSideI) {
    bwd_side<MODE, kSideI, DIM>(si, g, eps2, growth, st);
  } else {
    bwd_side<MODE, kSideJ, DIM>(sj, g, eps2, growth, st);
  }
}

// Reduces the partials of each side that has more than one split, in split
// order, one thread a row: rows [0, ni) of side i, then [ni, ni + nj) of
// side j (ni or nj is 0 for a side written directly). Every channel is a
// sum (in 2-D channels 6 and 7 stay 0).
__global__ void __launch_bounds__(kThreads)
pair_bwd_combine(const float* __restrict__ part_i, int ni, int splits_i,
                 float* __restrict__ out_i, const float* __restrict__ part_j,
                 int nj, int splits_j, float* __restrict__ out_j) {
  int row = blockIdx.x * kThreads + threadIdx.x;
  const float* part = part_i;
  float* out = out_i;
  int n = ni, splits = splits_i;
  if (row >= ni) {
    row -= ni;
    part = part_j;
    out = out_j;
    n = nj;
    splits = splits_j;
    if (row >= nj) return;
  }
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float c[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int sp = 0; sp < splits; ++sp) {
    float4 a, b;
    load_row(part + (static_cast<long long>(sp) * n + row) * kFeats, a, b);
    kahan_add(s[0], c[0], a.x);
    kahan_add(s[1], c[1], a.y);
    kahan_add(s[2], c[2], a.z);
    kahan_add(s[3], c[3], a.w);
    kahan_add(s[4], c[4], b.x);
    kahan_add(s[5], c[5], b.y);
    kahan_add(s[6], c[6], b.z);
    kahan_add(s[7], c[7], b.w);
  }
  store_row(out + static_cast<long long>(row) * kFeats,
            make_float4(s[0], s[1], s[2], s[3]),
            make_float4(s[4], s[5], s[6], s[7]));
}

template <int DIM>
void launch_dim(int mode, dim3 grid, cudaStream_t s, const Side& si,
                const Side& sj, const float* g, float eps2, float growth) {
  switch (mode) {
    case kReference:
      pair_bwd_kernel<kReference, DIM><<<grid, kThreads, 0, s>>>(
          si, sj, g, eps2, growth);
      break;
    case kMomentum:
      pair_bwd_kernel<kMomentum, DIM><<<grid, kThreads, 0, s>>>(
          si, sj, g, eps2, growth);
      break;
    case kElastic:
      pair_bwd_kernel<kElastic, DIM><<<grid, kThreads, 0, s>>>(
          si, sj, g, eps2, growth);
      break;
    default:
      pair_bwd_kernel<kNone, DIM><<<grid, kThreads, 0, s>>>(
          si, sj, g, eps2, growth);
      break;
  }
}

template <int MODE, int DIM>
int blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, pair_bwd_kernel<MODE, DIM>, kThreads, 0);
  return n;
}

template <int DIM>
int blocks_per_sm(int mode) {
  switch (mode) {
    case kReference: return blocks_per_sm<kReference, DIM>();
    case kMomentum: return blocks_per_sm<kMomentum, DIM>();
    case kElastic: return blocks_per_sm<kElastic, DIM>();
    default: return blocks_per_sm<kNone, DIM>();
  }
}

}  // namespace

// The pass kernel's launch shape for ctypes: how many of its blocks one SM
// holds at once in `mode` and dimension `dim` (occupancy API, current
// device) and how many rows a block owns. The wrapper picks each side's
// splits from these.
extern "C" int nbodyax_pair_backward_launch_shape(int mode, int dim,
                                                  int* blocks, int* rows) {
  if (mode < kReference || mode > kNone || (dim != 2 && dim != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *blocks = dim == 3 ? blocks_per_sm<3>(mode) : blocks_per_sm<2>(mode);
  *rows = kBlockRows;
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry point for ctypes: both sides of the backward pass. Side i's
// rows are fi (ni of them, with g's rows), side j's are fj; `dim` (2 or 3)
// is the layout of the rows. A side with more than one split needs its
// partial buffer (f32[splits, rows, 8]), which the caller allocates; a
// second launch then combines. Returns cudaGetLastError() after the launches
// (0 on success); an unknown mode or dimension or a split count below 1
// returns cudaErrorInvalidValue.
extern "C" int nbodyax_pair_backward(
    const float* fi, int ni, const float* fj, int nj, int i_off, int j_off,
    const float* g, int mode, int dim, float eps2, float growth,
    int splits_i, int splits_j, float* part_i, float* part_j, float* d_fi,
    float* d_fj, void* stream) {
  if (splits_i < 1 || splits_j < 1 || mode < kReference || mode > kNone ||
      (dim != 2 && dim != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ni == 0 && nj == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Side si{fi, fj, splits_i > 1 ? part_i : d_fi, ni, nj, i_off, j_off,
                splits_i, split_chunk(nj, splits_i)};
  const Side sj{fj, fi, splits_j > 1 ? part_j : d_fj, nj, ni, j_off, i_off,
                splits_j, split_chunk(ni, splits_j)};
  const dim3 grid((std::max(ni, nj) + kBlockRows - 1) / kBlockRows,
                  std::max(splits_i, splits_j), 2);
  if (dim == 3) {
    launch_dim<3>(mode, grid, s, si, sj, g, eps2, growth);
  } else {
    launch_dim<2>(mode, grid, s, si, sj, g, eps2, growth);
  }
  const int ci = splits_i > 1 ? ni : 0;
  const int cj = splits_j > 1 ? nj : 0;
  if (ci + cj > 0) {
    pair_bwd_combine<<<(ci + cj + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        part_i, ci, splits_i, d_fi, part_j, cj, splits_j, d_fj);
  }
  return static_cast<int>(cudaGetLastError());
}
