// Analytic backward pass of the fused all-pairs kernel, for one NVIDIA Hopper
// card.
//
// Replaces the TPU kernel nbodyax/physics/kernels_bwd.py::_bwd_kernel
// (launched by _bwd_pass through raw_backward). It computes the VJP of the
// raw channels of pair_kernel.cu with respect to both feature operands; the
// per-pair formulas are in nbodyax_torch/physics/kernels_bwd.py, whose
// raw_backward_reference is the plain PyTorch version of this kernel.
//
// Inputs: the i bodies f32[Ni, 8] and the j bodies f32[Nj, 8]
// (body_features layout: x, y, vx, vy, mass, radius, 0, 0), the raw-channel
// cotangent g f32[Ni, 8] of the i bodies, and the global ids of row 0 of
// each side. Outputs d_fi f32[Ni, 8] and d_fj f32[Nj, 8]: the gradients of
// the features (x, y, vx, vy, mass, radius, 0, 0). Each output row sums over
// every partner of the other side; which side a block computes is its
// blockIdx.z:
//
//   side i: rows are the i bodies; each row's own cotangent stays in
//           registers and the j partners stream through shared memory;
//   side j: rows are the j bodies; the i partners stream through shared
//           memory together with their cotangents.
//
// What bounds it: FP32 work on the CUDA cores, about 29 flops and one rsqrt
// a pair and side on the force path (the forward's distance and gates, the
// cube, g.u, the 3 s (g.u)/d2e term, two gradient components, the sums),
// twice that a pair for the two sides; each partner is read from device
// memory once per block. No wgmma, for the forward's reason: distances are
// computed subtract-first so that the gates round as the forward's do.
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
// - Each thread owns kRows rows; one float4 partner (x, y, m, r) from shared
//   memory, a float2 velocity in elastic mode and, on side j, the float4 of
//   the partner's cotangent (g0..g3) feed kRows pair chains.
// - Position and mass gradients are summed plainly over kSub = 32 partners
//   and Kahan-added into the row's total.
// - rsqrt is the SFU's own (rsqrt_sfu in pair_common.cuh).
//
// Gates: the backward must leave out exactly the pairs the forward left out,
// or a pair at the overlap threshold is gravity in one pass and contact in
// the other. d2, rsum^2 and v.p are therefore rounded as pair_kernel.cu
// rounds them (__fmul_rn / __fadd_rn, never contracted into FMAs); u is
// p_j - p_i on both sides, as in the forward. Every pair is gated on
// m_j > 0 and not-self by int32 global id; the force term also on
// d2 + eps2 > 0 and, outside elastic mode, on not overlapping; the elastic
// term on overlapping, approaching and d2 > 0. The elastic terms use IEEE
// division (no -use_fast_math).

#include <algorithm>

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

// Cotangent channels each mode reads: force (0-1) always; reference adds the
// gained mass and radius (2-3) on side j; elastic adds the halved dv (2-3).
template <int MODE, int SIDE>
struct Uses {
  static constexpr bool kMergeG = MODE == kReference && SIDE == kSideJ;
  static constexpr bool kVel = MODE == kElastic;
  static constexpr bool kG23 = kMergeG || kVel;
};

template <int MODE, int SIDE>
__device__ __forceinline__ void bwd_side(const Side& sd,
                                         const float* __restrict__ g,
                                         float eps2, float growth, float4* sp,
                                         float2* sv, float4* sg) {
  using U = Uses<MODE, SIDE>;
  constexpr bool kRowsAreI = SIDE == kSideI;
  if (static_cast<int>(blockIdx.x) * kBlockRows >= sd.nr ||
      static_cast<int>(blockIdx.y) >= sd.splits) {
    return;                                   // the whole block: uniform
  }
  float* dst = sd.dst + static_cast<long long>(blockIdx.y) * sd.nr * kFeats;

  const int row0 = blockIdx.x * kBlockRows + threadIdx.x;
  float xr[kRows], yr[kRows], vxr[kRows], vyr[kRows], mr[kRows], rr[kRows];
  float4 gr[kRows];                           // side i: own cotangent
  int gid[kRows];
  float px[kRows], py[kRows], pm[kRows];      // Kahan sums: position, mass
  float cpx[kRows], cpy[kRows], cpm[kRows];   // and their compensations
  float dvx[kRows], dvy[kRows], drad[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = row0 + k * kThreads;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    gr[k] = a;
    if (row < sd.nr) {
      load_row(sd.rows + static_cast<long long>(row) * kFeats, a, b);
      if constexpr (kRowsAreI) {
        gr[k] = *reinterpret_cast<const float4*>(
            g + static_cast<long long>(row) * kCh);
      }
    }
    xr[k] = a.x; yr[k] = a.y; vxr[k] = a.z; vyr[k] = a.w;
    mr[k] = b.x; rr[k] = b.y;
    gid[k] = sd.r_off + row;
    px[k] = py[k] = pm[k] = cpx[k] = cpy[k] = cpm[k] = 0.f;
    dvx[k] = dvy[k] = drad[k] = 0.f;
  }

  const int cb = blockIdx.y * sd.chunk;
  const int ce = min(sd.nc, cb + sd.chunk);
  for (int base = cb; base < ce; base += kTile) {
    const int count = min(kTile, ce - base);
    for (int t = threadIdx.x; t < count; t += kThreads) {
      float4 a, b;
      load_row(sd.cols + static_cast<long long>(base + t) * kFeats, a, b);
      sp[t] = make_float4(a.x, a.y, b.x, b.y);
      if constexpr (U::kVel) sv[t] = make_float2(a.z, a.w);
      // side j: the partners are the i bodies, whose cotangents stream too
      if constexpr (!kRowsAreI) {
        sg[t] = *reinterpret_cast<const float4*>(
            g + static_cast<long long>(base + t) * kCh);
      }
    }
    __syncthreads();
    for (int t0 = 0; t0 < count; t0 += kSub) {
      const int t1 = min(count, t0 + kSub);
      float sx[kRows], sy[kRows], sm[kRows];    // this sub-tile, plain
#pragma unroll
      for (int k = 0; k < kRows; ++k) sx[k] = sy[k] = sm[k] = 0.f;
#pragma unroll 2
      for (int t = t0; t < t1; ++t) {
        const float4 p = sp[t];
        const int gc = sd.c_off + base + t;
        float4 ph = make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (!kRowsAreI) ph = sg[t];
        float2 pv = make_float2(0.f, 0.f);
        if constexpr (U::kVel) pv = sv[t];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          // the i and j bodies of this pair, whichever side the rows are
          const float xi = kRowsAreI ? xr[k] : p.x;
          const float yi = kRowsAreI ? yr[k] : p.y;
          const float xj = kRowsAreI ? p.x : xr[k];
          const float yj = kRowsAreI ? p.y : yr[k];
          const float mi = kRowsAreI ? mr[k] : p.z;
          const float mj = kRowsAreI ? p.z : mr[k];
          const float ri = kRowsAreI ? rr[k] : p.w;
          const float rj = kRowsAreI ? p.w : rr[k];
          const int gi = kRowsAreI ? gid[k] : gc;
          const int gj = kRowsAreI ? gc : gid[k];
          const float4 h = kRowsAreI ? gr[k] : ph;   // cotangent of body i

          // the forward's roundings (pair_kernel.cu): u = p_j - p_i
          const float ux = __fsub_rn(xj, xi);
          const float uy = __fsub_rn(yj, yi);
          const float d2 = __fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy));
          const float rsum = __fadd_rn(ri, rj);
          const bool overlap = d2 <= __fmul_rn(rsum, rsum);
          const bool live = mj > 0.f && gi != gj;
          const float d2e = __fadd_rn(d2, eps2);

          float ex = 0.f, ey = 0.f, em = 0.f;    // this pair's row gradient
          const bool c = live && d2e > 0.f && (MODE == kElastic || !overlap);
          if (c) {
            const float inv = rsqrt_sfu(d2e);
            const float s = inv * inv * inv;
            const float gdotu = h.x * ux + h.y * uy;
            const float tt = 3.f * (inv * inv) * s * gdotu;
            if constexpr (kRowsAreI) {
              ex = mj * (tt * ux - s * h.x);
              ey = mj * (tt * uy - s * h.y);
            } else {
              ex = mj * (s * h.x - tt * ux);
              ey = mj * (s * h.y - tt * uy);
              em = s * gdotu;
            }
          }
          if constexpr (U::kMergeG) {
            if (overlap && live && mi >= mj) {
              em += h.z;
              drad[k] += growth * h.w;
            }
          }
          if constexpr (MODE == kElastic) {
            const float vxi = kRowsAreI ? vxr[k] : pv.x;
            const float vyi = kRowsAreI ? vyr[k] : pv.y;
            const float vxj = kRowsAreI ? pv.x : vxr[k];
            const float vyj = kRowsAreI ? pv.y : vyr[k];
            const float rvx = vxj - vxi;
            const float rvy = vyj - vyi;
            const float vdotp = __fadd_rn(__fmul_rn(rvx, ux),
                                          __fmul_rn(rvy, uy));
            if (overlap && live && vdotp < 0.f && d2 > 0.f) {
              const float invd2 = 1.f / d2;
              const float minv = 1.f / (mi + mj);
              const float recip = minv * invd2;
              const float q = vdotp * recip;
              const float hdotu = h.z * ux + h.w * uy;
              const float gq = hdotu * recip;
              const float sgn = kRowsAreI ? -1.f : 1.f;
              const float w = 2.f * vdotp * invd2;
              ex += sgn * (mj * (gq * (rvx - w * ux) + q * h.z));
              ey += sgn * (mj * (gq * (rvy - w * uy) + q * h.w));
              dvx[k] += sgn * (mj * gq * ux);
              dvy[k] += sgn * (mj * gq * uy);
              em += sgn * (hdotu * q * minv * (kRowsAreI ? mj : mi));
            }
          }
          sx[k] += ex;
          sy[k] += ey;
          if constexpr (!kRowsAreI || MODE == kElastic) sm[k] += em;
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        kahan_add(px[k], cpx[k], sx[k]);
        kahan_add(py[k], cpy[k], sy[k]);
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
    store_row(dst + static_cast<long long>(row) * kFeats,
              make_float4(px[k], py[k], dvx[k], dvy[k]),
              make_float4(pm[k], drad[k], 0.f, 0.f));
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 4)
pair_bwd_kernel(Side si, Side sj, const float* __restrict__ g, float eps2,
                float growth) {
  __shared__ float4 sp[kTile];                            // x, y, m, r
  __shared__ float2 sv[MODE == kElastic ? kTile : 1];     // vx, vy
  __shared__ float4 sg[kTile];                            // side j: g0..g3
  if (blockIdx.z == kSideI) {
    bwd_side<MODE, kSideI>(si, g, eps2, growth, sp, sv, sg);
  } else {
    bwd_side<MODE, kSideJ>(sj, g, eps2, growth, sp, sv, sg);
  }
}

// Reduces the partials of each side that has more than one split, in split
// order, one thread a row: rows [0, ni) of side i, then [ni, ni + nj) of
// side j (ni or nj is 0 for a side written directly).
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
  float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float c[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int sp = 0; sp < splits; ++sp) {
    float4 a, b;
    load_row(part + (static_cast<long long>(sp) * n + row) * kFeats, a, b);
    kahan_add(s[0], c[0], a.x);
    kahan_add(s[1], c[1], a.y);
    kahan_add(s[2], c[2], a.z);
    kahan_add(s[3], c[3], a.w);
    kahan_add(s[4], c[4], b.x);
    kahan_add(s[5], c[5], b.y);
  }
  store_row(out + static_cast<long long>(row) * kFeats,
            make_float4(s[0], s[1], s[2], s[3]),
            make_float4(s[4], s[5], 0.f, 0.f));
}

template <int MODE>
int blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pair_bwd_kernel<MODE>,
                                                kThreads, 0);
  return n;
}

}  // namespace

// The pass kernel's launch shape for ctypes: how many of its blocks one SM
// holds at once in `mode` (occupancy API, current device) and how many rows
// a block owns. The wrapper picks each side's splits from these.
extern "C" int nbodyax_pair_backward_launch_shape(int mode, int* blocks,
                                                  int* rows) {
  switch (mode) {
    case kReference: *blocks = blocks_per_sm<kReference>(); break;
    case kMomentum: *blocks = blocks_per_sm<kMomentum>(); break;
    case kElastic: *blocks = blocks_per_sm<kElastic>(); break;
    case kNone: *blocks = blocks_per_sm<kNone>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  *rows = kBlockRows;
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry point for ctypes: both sides of the backward pass. Side i's
// rows are fi (ni of them, with g's rows), side j's are fj. A side with
// more than one split needs its partial buffer (f32[splits, rows, 8]),
// which the caller allocates; a second launch then combines. Returns
// cudaGetLastError() after the launches (0 on success); an unknown mode or
// a split count below 1 returns cudaErrorInvalidValue.
extern "C" int nbodyax_pair_backward(
    const float* fi, int ni, const float* fj, int nj, int i_off, int j_off,
    const float* g, int mode, float eps2, float growth, int splits_i,
    int splits_j, float* part_i, float* part_j, float* d_fi, float* d_fj,
    void* stream) {
  if (splits_i < 1 || splits_j < 1 || mode < kReference || mode > kNone) {
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
  switch (mode) {
    case kReference:
      pair_bwd_kernel<kReference><<<grid, kThreads, 0, s>>>(si, sj, g, eps2,
                                                            growth);
      break;
    case kMomentum:
      pair_bwd_kernel<kMomentum><<<grid, kThreads, 0, s>>>(si, sj, g, eps2,
                                                           growth);
      break;
    case kElastic:
      pair_bwd_kernel<kElastic><<<grid, kThreads, 0, s>>>(si, sj, g, eps2,
                                                          growth);
      break;
    default:
      pair_bwd_kernel<kNone><<<grid, kThreads, 0, s>>>(si, sj, g, eps2,
                                                       growth);
      break;
  }
  const int ci = splits_i > 1 ? ni : 0;
  const int cj = splits_j > 1 ? nj : 0;
  if (ci + cj > 0) {
    pair_bwd_combine<<<(ci + cj + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        part_i, ci, splits_i, d_fi, part_j, cj, splits_j, d_fj);
  }
  return static_cast<int>(cudaGetLastError());
}
