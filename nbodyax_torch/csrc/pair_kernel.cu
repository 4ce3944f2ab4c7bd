// Fused all-pairs gravity and collision bookkeeping for one NVIDIA Hopper card.
//
// Replaces the TPU kernel nbodyax/physics/kernels.py::_pair_kernel (launched
// by _raw_impl through tile_accumulators_raw / pallas_pair_accumulators). The
// per-pair semantics are those of nbodyax/physics/pairwise.py, the oracle the
// port's nbodyax_torch/physics/pairwise.py mirrors:
//
//   overlap  d2 <= (r_i + r_j)^2, self pair excluded by global id
//   force    sum m_j (p_j - p_i) / (d2 + eps2)^{3/2}, overlapping pairs left
//            out except in elastic mode
//   reference  gained mass, gained radius (r_j * growth), died count, for
//              overlapping pairs with m_i >= m_j (quirk Q1) / m_i < m_j
//   momentum   heaviest overlapping j that beats i, ties to the lowest id
//   elastic    m_j/(m_i+m_j) * (v_j-v_i).(p_j-p_i)/d2 * (p_j-p_i) for
//              approaching overlapping pairs (decode_raw applies the 2)
//
// Inputs are the body_features rows: f32[N, 8] = x, y, vx, vy, mass,
// radius (0 for dead bodies), 0, 0. Output is the 8-channel f32 layout of
// the TPU kernel: ch0-1 force, ch2-4 the mode channels, ch5 0, ch6 best
// mass (-FLT_MAX when none), ch7 0; momentum mode also writes one int32
// parent id per row (INT_MAX when none). i_off / j_off are the global ids of
// row 0 of each side, so a caller may pass any i range against any j range.
//
// Design: one thread owns one i row and walks every j, staged through shared
// memory one block-width tile at a time. All sums stay in registers and are
// written once, with no atomics, so merge decisions and the momentum argmax
// come out the same on every run.
//
// Rounding: the overlap test decides merges exactly, so it must round like
// the CPU oracle. nvcc would contract dx*dx + dy*dy and rsum*rsum into FMAs;
// d2, rsum^2, the elastic v.p test and the gained radius are therefore
// computed with __fmul_rn / __fadd_rn, which are never contracted. The
// elastic impulse uses an IEEE division (no -use_fast_math).
//
// Summation: the force is a sum over every partner, and a plain running
// sum over 16,384 of them drifted 4.2e-5 of the largest force from the
// plain PyTorch version on the H100 (whose tree reduction is ~2e-7 from a
// float64 sum). The force is therefore summed with Kahan compensation,
// which costs four adds a component and keeps the error independent of N.
// The mode channels sum over overlapping partners only, a handful a row.
//
// What bounds it: FP32 ALU work, about 30 flops a pair with the compensated
// sums, and one rsqrt a pair; there is no device-memory traffic inside the
// j loop. Known limit: at N = 16,384 one thread per row is 128 blocks of 4
// warps, so 4 of the 132 SMs idle and each busy SM holds too few warps to
// hide the ALU latency; splitting j across blocks fixes that and is left
// for later work.

#include <cuda_runtime.h>
#include <cfloat>
#include <climits>

namespace {

constexpr int kFeats = 8;
constexpr int kCh = 8;
constexpr int kThreads = 128;

enum Mode { kReference = 0, kMomentum = 1, kElastic = 2, kNone = 3 };

// Compensated (Kahan) running sum: s + c carries the sum to about one
// rounding whatever the number of terms. Written with _rn intrinsics so the
// compiler can neither contract nor reorder the compensation away.
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = __fsub_rn(x, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
pair_kernel(const float* __restrict__ fi, int ni,
            const float* __restrict__ fj, int nj,
            int i_off, int j_off, float eps2, float growth,
            float* __restrict__ out, int* __restrict__ parent) {
  __shared__ float sx[kThreads], sy[kThreads], sm[kThreads], sr[kThreads];
  __shared__ float svx[MODE == kElastic ? kThreads : 1];
  __shared__ float svy[MODE == kElastic ? kThreads : 1];

  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool has_row = row < ni;
  float xi = 0.f, yi = 0.f, vxi = 0.f, vyi = 0.f, mi = 0.f, ri = 0.f;
  if (has_row) {
    const float* f = fi + static_cast<long long>(row) * kFeats;
    xi = f[0]; yi = f[1]; vxi = f[2]; vyi = f[3]; mi = f[4]; ri = f[5];
  }
  const int gi = i_off + row;

  float fx = 0.f, fy = 0.f, cx = 0.f, cy = 0.f;   // force sum, compensation
  float c2 = 0.f, c3 = 0.f, c4 = 0.f;
  float best = -FLT_MAX;
  int best_j = INT_MAX;

  for (int base = 0; base < nj; base += kThreads) {
    const int j = base + threadIdx.x;
    if (j < nj) {
      const float* f = fj + static_cast<long long>(j) * kFeats;
      sx[threadIdx.x] = f[0];
      sy[threadIdx.x] = f[1];
      sm[threadIdx.x] = f[4];
      sr[threadIdx.x] = f[5];
      if constexpr (MODE == kElastic) {
        svx[threadIdx.x] = f[2];
        svy[threadIdx.x] = f[3];
      }
    }
    __syncthreads();
    const int count = min(kThreads, nj - base);
#pragma unroll 4
    for (int t = 0; t < count; ++t) {
      const float dx = __fsub_rn(sx[t], xi);
      const float dy = __fsub_rn(sy[t], yi);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      const float rsum = __fadd_rn(ri, sr[t]);
      // overlap includes the self pair (d2 = 0); for the force that is
      // exactly the set of pairs to leave out
      const bool overlap = d2 <= __fmul_rn(rsum, rsum);
      const float mj = sm[t];
      const float inv = rsqrtf(d2 + eps2);
      const float wm = mj * (inv * inv * inv);
      float w;
      if constexpr (MODE == kElastic) {
        w = (eps2 > 0.f || d2 > 0.f) ? wm : 0.f;
      } else {
        w = overlap ? 0.f : wm;
      }
      kahan_add(fx, cx, w * dx);
      kahan_add(fy, cy, w * dy);
      const int gj = j_off + base + t;
      if constexpr (MODE == kReference) {
        if (overlap && gj != gi) {
          if (mi >= mj) {
            c2 += mj;
            c3 += __fmul_rn(sr[t], growth);
          } else {
            c4 += 1.f;
          }
        }
      } else if constexpr (MODE == kMomentum) {
        // beats excludes the self pair: equal mass and equal id
        const bool beats = mj > mi || (mj == mi && gj < gi);
        if (overlap && beats && (mj > best || (mj == best && gj < best_j))) {
          best = mj;
          best_j = gj;
        }
      } else if constexpr (MODE == kElastic) {
        const float vdotp = __fadd_rn(__fmul_rn(svx[t] - vxi, dx),
                                      __fmul_rn(svy[t] - vyi, dy));
        // vdotp < 0 excludes the self pair and coincident bodies (dx = dy = 0)
        if (overlap && vdotp < 0.f) {
          const float coef = vdotp * mj / ((mi + mj) * d2);
          c2 += coef * dx;
          c3 += coef * dy;
        }
      }
    }
    __syncthreads();
  }

  if (!has_row) return;
  float* o = out + static_cast<long long>(row) * kCh;
  o[0] = fx;
  o[1] = fy;
  o[2] = c2;
  o[3] = c3;
  o[4] = c4;
  o[5] = 0.f;
  o[6] = best;
  o[7] = 0.f;
  if constexpr (MODE == kMomentum) parent[row] = best_j;
}

template <int MODE>
void launch(const float* fi, int ni, const float* fj, int nj, int i_off,
            int j_off, float eps2, float growth, float* out, int* parent,
            cudaStream_t stream) {
  const int blocks = (ni + kThreads - 1) / kThreads;
  pair_kernel<MODE><<<blocks, kThreads, 0, stream>>>(
      fi, ni, fj, nj, i_off, j_off, eps2, growth, out, parent);
}

}  // namespace

// Plain C entry point for ctypes. Returns cudaGetLastError() after the
// launch (0 on success); an unknown mode returns cudaErrorInvalidValue.
extern "C" int nbodyax_pair_accumulators(
    const float* fi, int ni, const float* fj, int nj, int i_off, int j_off,
    int mode, float eps2, float growth, float* out, int* parent,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ni > 0) {
    switch (mode) {
      case kReference:
        launch<kReference>(fi, ni, fj, nj, i_off, j_off, eps2, growth, out,
                           parent, s);
        break;
      case kMomentum:
        launch<kMomentum>(fi, ni, fj, nj, i_off, j_off, eps2, growth, out,
                          parent, s);
        break;
      case kElastic:
        launch<kElastic>(fi, ni, fj, nj, i_off, j_off, eps2, growth, out,
                         parent, s);
        break;
      case kNone:
        launch<kNone>(fi, ni, fj, nj, i_off, j_off, eps2, growth, out, parent,
                      s);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
