// Analytic backward pass of the fused all-pairs kernel, for one NVIDIA Hopper
// card.
//
// Replaces the TPU kernel nbodyax/physics/kernels_bwd.py::_bwd_kernel
// (launched by _bwd_pass through raw_backward). It computes the VJP of the
// raw channels of pair_kernel.cu with respect to both feature operands; the
// per-pair formulas are in nbodyax_torch/physics/kernels_bwd.py, whose
// raw_backward_reference is the plain PyTorch version of this kernel.
//
// Inputs: rows f32[R, 8] and partners f32[C, 8] (body_features layout: x, y,
// vx, vy, mass, radius, 0, 0), the raw-channel cotangent g f32[Ni, 8] of the
// i bodies, and the global ids of row 0 of each side. Output f32[R, 8]: the
// gradient of the row bodies' features (x, y, vx, vy, mass, radius, 0, 0).
// SIDE selects which operand the rows are:
//
//   side i: rows are the i bodies; each row's own cotangent stays in
//           registers and the j partners stream through shared memory;
//   side j: rows are the j bodies; the i partners stream through shared
//           memory together with their cotangents.
//
// One backward call is two launches, one for each side.
//
// Design: B1's. One thread owns one output row and walks every partner,
// staged through shared memory one block-width tile at a time. Sums stay in
// registers and are written once, with no atomics, so gradients repeat bit
// for bit.
//
// Gates: the backward must leave out exactly the pairs the forward left out,
// or a pair at the overlap threshold is gravity in one pass and contact in
// the other. d2, rsum^2 and v.p are therefore rounded as pair_kernel.cu
// rounds them (__fmul_rn / __fadd_rn, never contracted into FMAs); u is
// p_j - p_i on both sides, as in the forward. Every pair is gated on
// m_j > 0 and not-self by int32 global id; the force term also on
// d2 + eps2 > 0 and, outside elastic mode, on not overlapping; the elastic
// term on overlapping, approaching and d2 > 0.
//
// Summation: the position and mass gradients are sums over every partner,
// taken with Kahan compensation as the forward's force is (a plain running
// sum over 16,384 partners drifted 20x over the forward's gate). The
// velocity and radius gradients sum over overlapping partners only. The
// elastic terms use IEEE division (no -use_fast_math).
//
// What bounds it: FP32 ALU work, about 40 flops a pair with the compensated
// sums and one rsqrt; nothing is read from device memory inside the partner
// loop. Known limit, as for the forward: one thread per row leaves SMs idle
// and too few warps on the busy ones at N = 16,384; splitting the partners
// across blocks is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kFeats = 8;
constexpr int kCh = 8;
constexpr int kThreads = 128;

enum Mode { kReference = 0, kMomentum = 1, kElastic = 2, kNone = 3 };
enum Side { kSideI = 0, kSideJ = 1 };

__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = __fsub_rn(x, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

// Cotangent channels each mode reads: force (0-1) always; reference adds the
// gained mass and radius (2-3) on side j; elastic adds the halved dv (2-3).
template <int MODE, int SIDE>
struct Uses {
  static constexpr bool kMergeG = MODE == kReference && SIDE == kSideJ;
  static constexpr bool kVel = MODE == kElastic;
  static constexpr bool kG23 = kMergeG || kVel;
};

template <int MODE, int SIDE>
__global__ void __launch_bounds__(kThreads)
pair_bwd_kernel(const float* __restrict__ rows, int nr,
                const float* __restrict__ cols, int nc, int r_off, int c_off,
                const float* __restrict__ g, float eps2, float growth,
                float* __restrict__ out) {
  using U = Uses<MODE, SIDE>;
  constexpr bool kRowsAreI = SIDE == kSideI;
  __shared__ float sx[kThreads], sy[kThreads], sm[kThreads], sr[kThreads];
  __shared__ float svx[U::kVel ? kThreads : 1], svy[U::kVel ? kThreads : 1];
  // side j: the partners are the i bodies, whose cotangents stream too
  __shared__ float sg0[kRowsAreI ? 1 : kThreads];
  __shared__ float sg1[kRowsAreI ? 1 : kThreads];
  __shared__ float sg2[!kRowsAreI && U::kG23 ? kThreads : 1];
  __shared__ float sg3[!kRowsAreI && U::kG23 ? kThreads : 1];

  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool has_row = row < nr;
  float xr = 0.f, yr = 0.f, vxr = 0.f, vyr = 0.f, mr = 0.f, rr = 0.f;
  float g0 = 0.f, g1 = 0.f, g2 = 0.f, g3 = 0.f;   // side i: own cotangent
  if (has_row) {
    const float* f = rows + static_cast<long long>(row) * kFeats;
    xr = f[0]; yr = f[1]; vxr = f[2]; vyr = f[3]; mr = f[4]; rr = f[5];
    if constexpr (kRowsAreI) {
      const float* gg = g + static_cast<long long>(row) * kCh;
      g0 = gg[0]; g1 = gg[1];
      if constexpr (U::kG23) { g2 = gg[2]; g3 = gg[3]; }
    }
  }
  const int gr = r_off + row;

  float px = 0.f, py = 0.f, pm = 0.f;      // Kahan sums: position, mass
  float cpx = 0.f, cpy = 0.f, cpm = 0.f;   // and their compensations
  float dvx = 0.f, dvy = 0.f, drad = 0.f;

  for (int base = 0; base < nc; base += kThreads) {
    const int k = base + threadIdx.x;
    if (k < nc) {
      const float* f = cols + static_cast<long long>(k) * kFeats;
      sx[threadIdx.x] = f[0];
      sy[threadIdx.x] = f[1];
      sm[threadIdx.x] = f[4];
      sr[threadIdx.x] = f[5];
      if constexpr (U::kVel) {
        svx[threadIdx.x] = f[2];
        svy[threadIdx.x] = f[3];
      }
      if constexpr (!kRowsAreI) {
        const float* gg = g + static_cast<long long>(k) * kCh;
        sg0[threadIdx.x] = gg[0];
        sg1[threadIdx.x] = gg[1];
        if constexpr (U::kG23) {
          sg2[threadIdx.x] = gg[2];
          sg3[threadIdx.x] = gg[3];
        }
      }
    }
    __syncthreads();
    const int count = min(kThreads, nc - base);
#pragma unroll 2
    for (int t = 0; t < count; ++t) {
      // the i and j bodies of this pair, whichever side the rows are
      const float xi = kRowsAreI ? xr : sx[t];
      const float yi = kRowsAreI ? yr : sy[t];
      const float xj = kRowsAreI ? sx[t] : xr;
      const float yj = kRowsAreI ? sy[t] : yr;
      const float mi = kRowsAreI ? mr : sm[t];
      const float mj = kRowsAreI ? sm[t] : mr;
      const float ri = kRowsAreI ? rr : sr[t];
      const float rj = kRowsAreI ? sr[t] : rr;
      const int gi = kRowsAreI ? gr : c_off + base + t;
      const int gj = kRowsAreI ? c_off + base + t : gr;
      float h0 = g0, h1 = g1, h2 = g2, h3 = g3;     // cotangent of body i
      if constexpr (!kRowsAreI) {
        h0 = sg0[t]; h1 = sg1[t];
        if constexpr (U::kG23) { h2 = sg2[t]; h3 = sg3[t]; }
      }

      // the forward's roundings (pair_kernel.cu): u = p_j - p_i
      const float ux = __fsub_rn(xj, xi);
      const float uy = __fsub_rn(yj, yi);
      const float d2 = __fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy));
      const float rsum = __fadd_rn(ri, rj);
      const bool overlap = d2 <= __fmul_rn(rsum, rsum);
      const bool live = mj > 0.f && gi != gj;
      const float d2e = __fadd_rn(d2, eps2);

      float ex = 0.f, ey = 0.f, em = 0.f;      // this pair's row gradient
      const bool c = live && d2e > 0.f && (MODE == kElastic || !overlap);
      if (c) {
        const float inv = rsqrtf(d2e);
        const float s = inv * inv * inv;
        const float gdotu = h0 * ux + h1 * uy;
        const float tt = 3.f * (inv * inv) * s * gdotu;
        if constexpr (kRowsAreI) {
          ex = mj * (tt * ux - s * h0);
          ey = mj * (tt * uy - s * h1);
        } else {
          ex = mj * (s * h0 - tt * ux);
          ey = mj * (s * h1 - tt * uy);
          em = s * gdotu;
        }
      }
      if constexpr (U::kMergeG) {
        if (overlap && live && mi >= mj) {
          em += h2;
          drad += growth * h3;
        }
      }
      if constexpr (MODE == kElastic) {
        const float vxi = kRowsAreI ? vxr : svx[t];
        const float vyi = kRowsAreI ? vyr : svy[t];
        const float vxj = kRowsAreI ? svx[t] : vxr;
        const float vyj = kRowsAreI ? svy[t] : vyr;
        const float rvx = vxj - vxi;
        const float rvy = vyj - vyi;
        const float vdotp = __fadd_rn(__fmul_rn(rvx, ux), __fmul_rn(rvy, uy));
        if (overlap && live && vdotp < 0.f && d2 > 0.f) {
          const float invd2 = 1.f / d2;
          const float minv = 1.f / (mi + mj);
          const float recip = minv * invd2;
          const float q = vdotp * recip;
          const float hdotu = h2 * ux + h3 * uy;
          const float gq = hdotu * recip;
          const float sgn = kRowsAreI ? -1.f : 1.f;
          const float w = 2.f * vdotp * invd2;
          ex += sgn * (mj * (gq * (rvx - w * ux) + q * h2));
          ey += sgn * (mj * (gq * (rvy - w * uy) + q * h3));
          dvx += sgn * (mj * gq * ux);
          dvy += sgn * (mj * gq * uy);
          em += sgn * (hdotu * q * minv * (kRowsAreI ? mj : mi));
        }
      }
      kahan_add(px, cpx, ex);
      kahan_add(py, cpy, ey);
      if constexpr (!kRowsAreI || MODE == kElastic) kahan_add(pm, cpm, em);
    }
    __syncthreads();
  }

  if (!has_row) return;
  float* o = out + static_cast<long long>(row) * kFeats;
  o[0] = px;
  o[1] = py;
  o[2] = dvx;
  o[3] = dvy;
  o[4] = pm;
  o[5] = drad;
  o[6] = 0.f;
  o[7] = 0.f;
}

template <int MODE, int SIDE>
void launch(const float* rows, int nr, const float* cols, int nc, int r_off,
            int c_off, const float* g, float eps2, float growth, float* out,
            cudaStream_t stream) {
  const int blocks = (nr + kThreads - 1) / kThreads;
  pair_bwd_kernel<MODE, SIDE><<<blocks, kThreads, 0, stream>>>(
      rows, nr, cols, nc, r_off, c_off, g, eps2, growth, out);
}

template <int MODE>
int launch_side(int side, const float* rows, int nr, const float* cols,
                int nc, int r_off, int c_off, const float* g, float eps2,
                float growth, float* out, cudaStream_t stream) {
  if (side == kSideI) {
    launch<MODE, kSideI>(rows, nr, cols, nc, r_off, c_off, g, eps2, growth,
                         out, stream);
  } else if (side == kSideJ) {
    launch<MODE, kSideJ>(rows, nr, cols, nc, r_off, c_off, g, eps2, growth,
                         out, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// Plain C entry point for ctypes: one side of the backward pass. side 0: the
// rows are the i bodies (g has nr rows); side 1: the rows are the j bodies
// (g has nc rows). Returns cudaGetLastError() after the launch (0 on
// success); an unknown mode or side returns cudaErrorInvalidValue.
extern "C" int nbodyax_pair_backward(
    const float* rows, int nr, const float* cols, int nc, int r_off,
    int c_off, const float* g, int mode, int side, float eps2, float growth,
    float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nr > 0) {
    int bad = 0;
    switch (mode) {
      case kReference:
        bad = launch_side<kReference>(side, rows, nr, cols, nc, r_off, c_off,
                                      g, eps2, growth, out, s);
        break;
      case kMomentum:
        bad = launch_side<kMomentum>(side, rows, nr, cols, nc, r_off, c_off,
                                     g, eps2, growth, out, s);
        break;
      case kElastic:
        bad = launch_side<kElastic>(side, rows, nr, cols, nc, r_off, c_off,
                                    g, eps2, growth, out, s);
        break;
      case kNone:
        bad = launch_side<kNone>(side, rows, nr, cols, nc, r_off, c_off, g,
                                 eps2, growth, out, s);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (bad != 0) return bad;
  }
  return static_cast<int>(cudaGetLastError());
}
