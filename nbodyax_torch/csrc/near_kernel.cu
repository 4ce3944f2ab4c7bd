// Exact near field of forceModel=bh over the slot grid, for one NVIDIA
// Hopper card.
//
// Replaces the TPU kernel nbodyax/physics/near_pallas.py::_near_kernel
// (launched by slots_near_raw from barneshut._near_field_cells). The
// per-pair rules are those of barneshut._gathered_pair_accum, which the
// port's plain version (near_kernel.slots_near_reference) evaluates:
//
//   valid    m_i > 0, m_j > 0, id_i != id_j
//   overlap  d2 <= (r_i + r_j)^2 on a valid pair
//   force    sum m_j (p_j - p_i) / (d2 + eps2)^{3/2} over valid pairs that do
//            not overlap (every valid pair in elastic mode)
//   reference  gained mass m_j and radius r_j * growth where m_i >= m_j,
//              died where m_i < m_j, on overlap
//   momentum   heaviest overlapping j that beats i (heavier, or equal mass
//              and lower id), ties to the lowest id
//   elastic    2 m_j v.p / ((m_i + m_j) d2) * p for approaching overlaps,
//              with the TPU kernel's rsqrt-squared coefficient
//
// Input: the slot grid f32[ncells, S, L] of a 2-D grid of side g (cell
// c = y * g + x), each cell's first S cell-sorted bodies and zero rows past
// its count; a row is x, y, [vx, vy], mass, radius, id hi, id lo, with the
// global id split over two exact f32 lanes (hi * 4096 + lo). Output:
// f32[ncells, ci, 8] for each cell's first ci slots, slot-major: ch0-1
// force, then reference gained mass, gained radius, died (0/1); momentum
// best mass (-inf when none), parent id hi, parent id lo (the slot's own id
// when none); elastic dv x, y; zeros elsewhere. (The TPU kernel writes a
// lane-merged channel-major block; that layout is a TPU artefact.)
//
// Design: one warp a cell, four cells a block. Lane t owns i slot i0 + t
// and sums over every partner in registers, with no atomics, so merge
// decisions and the momentum argmax repeat bit for bit. The window is the
// (2 ring + 1) rows of (2 ring + 1) cells around the cell, clipped to the
// grid (no x-wrap: out-of-grid cells are never read); the cells of one row
// are adjacent in the slot grid, so a row is one contiguous run of
// partners, staged through shared memory 32 at a time. Any S and ci up to
// the 1024-slot ceiling work: ci > 32 loops over groups of 32 i slots.
// Pad partners (mass 0) are skipped warp-uniformly; a group with no live i
// slot skips the window and writes the dead-row outputs.
//
// Rounding: d2, rsum^2 and v.p are computed with __fmul_rn / __fadd_rn,
// which nvcc never contracts into FMAs (a contracted d2 flipped overlap
// tests in the all-pairs kernel); the force is a Kahan sum.
//
// What bounds it: FP32 ALU work, about 30 flops and one rsqrt a live pair;
// the window rows are read from device memory once a cell (about 9 S L
// floats) and mostly hit L2, since neighbouring cells share rows.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kCh = 8;
constexpr int kMaxL = 8;

enum Mode { kReference = 0, kMomentum = 1, kElastic = 2, kNone = 3 };

__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = __fsub_rn(x, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

__device__ __forceinline__ int unpack_id(float hi, float lo) {
  return static_cast<int>(hi) * 4096 + static_cast<int>(lo);
}

template <int MODE, bool EPS_POS>
__global__ void __launch_bounds__(kWarps * 32)
near_kernel(const float* __restrict__ grid, int g, int ring, int S, int ci,
            int L, float eps2, float growth, float* __restrict__ out) {
  __shared__ float stage[kWarps][32][kMaxL + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long ncells = static_cast<long long>(g) * g;
  const long long cell = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (cell >= ncells) return;          // the whole warp leaves together
  const int cx = static_cast<int>(cell % g);
  const int cy = static_cast<int>(cell / g);
  constexpr int rest = MODE == kElastic ? 4 : 2;   // lane of the mass
  const float* cbase = grid + cell * S * L;
  float(*sh)[kMaxL + 1] = stage[warp];

  for (int i0 = 0; i0 < ci; i0 += 32) {
    const int islot = i0 + lane;
    const bool has = islot < ci;
    float xi = 0.f, yi = 0.f, vxi = 0.f, vyi = 0.f, mi = 0.f, ri = 0.f;
    int idi = 0;
    if (has) {
      const float* f = cbase + static_cast<long long>(islot) * L;
      xi = f[0];
      yi = f[1];
      if constexpr (MODE == kElastic) {
        vxi = f[2];
        vyi = f[3];
      }
      mi = f[rest];
      ri = f[rest + 1];
      idi = unpack_id(f[rest + 2], f[rest + 3]);
    }
    const bool live = has && mi > 0.f;

    float fx = 0.f, fy = 0.f, kx = 0.f, ky = 0.f;   // force, compensation
    float c2 = 0.f, c3 = 0.f, c4 = 0.f;
    float best = -INFINITY;
    int best_id = idi;

    if (__any_sync(0xffffffffu, live)) {
      const int x0 = max(cx - ring, 0);
      const int x1 = min(cx + ring, g - 1);
      const int total = (x1 - x0 + 1) * S;
      for (int dy = -ring; dy <= ring; ++dy) {
        const int y = cy + dy;
        if (y < 0 || y >= g) continue;
        const float* wbase =
            grid + (static_cast<long long>(y) * g + x0) * S * L;
        for (int p0 = 0; p0 < total; p0 += 32) {
          const int p = p0 + lane;
          __syncwarp();
          if (p < total) {
            const float* f = wbase + static_cast<long long>(p) * L;
            for (int k = 0; k < L; ++k) sh[lane][k] = f[k];
          }
          __syncwarp();
          const int cnt = min(32, total - p0);
          for (int t = 0; t < cnt; ++t) {
            const float* q = sh[t];
            const float mj = q[rest];
            if (!(mj > 0.f)) continue;        // pad slot: same on every lane
            const int idj = unpack_id(q[rest + 2], q[rest + 3]);
            const bool valid = live && idj != idi;
            const float dx = __fsub_rn(q[0], xi);
            const float dy2 = __fsub_rn(q[1], yi);
            const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy2, dy2));
            const float rsum = __fadd_rn(ri, q[rest + 1]);
            const bool overlap = valid && d2 <= __fmul_rn(rsum, rsum);
            const bool fmask =
                MODE == kElastic ? valid : (valid && !overlap);
            const float d2e = __fadd_rn(d2, eps2);
            float w;
            if constexpr (EPS_POS) {
              const float inv = rsqrtf(d2e);
              w = fmask ? mj * (inv * inv * inv) : 0.f;
            } else {
              const bool safe = fmask && d2e > 0.f;
              const float inv = rsqrtf(safe ? d2e : 1.f);
              w = safe ? mj * (inv * inv * inv) : 0.f;
            }
            kahan_add(fx, kx, w * dx);
            kahan_add(fy, ky, w * dy2);
            if constexpr (MODE == kReference) {
              if (overlap) {
                if (mi >= mj) {
                  c2 += mj;
                  c3 += __fmul_rn(q[rest + 1], growth);
                } else {
                  c4 = 1.f;
                }
              }
            } else if constexpr (MODE == kMomentum) {
              const bool beats = mj > mi || (mj == mi && idj < idi);
              if (overlap && beats &&
                  (mj > best || (mj == best && idj < best_id))) {
                best = mj;
                best_id = idj;
              }
            } else if constexpr (MODE == kElastic) {
              const float vdotp =
                  __fadd_rn(__fmul_rn(__fsub_rn(q[2], vxi), dx),
                            __fmul_rn(__fsub_rn(q[3], vyi), dy2));
              if (overlap && vdotp < 0.f && d2 > 0.f) {
                const float rs = rsqrtf(__fmul_rn(__fadd_rn(mi, mj), d2));
                const float coef = 2.f * vdotp * (rs * rs) * mj;
                c2 += coef * dx;
                c3 += coef * dy2;
              }
            }
          }
        }
      }
    }

    if (has) {
      float* o = out + (cell * ci + islot) * kCh;
      o[0] = fx;
      o[1] = fy;
      if constexpr (MODE == kMomentum) {
        o[2] = best;
        o[3] = static_cast<float>(best_id >> 12);
        o[4] = static_cast<float>(best_id & 0xFFF);
      } else {
        o[2] = c2;
        o[3] = c3;
        o[4] = c4;
      }
      o[5] = 0.f;
      o[6] = 0.f;
      o[7] = 0.f;
    }
  }
}

template <int MODE>
void launch(const float* grid, int g, int ring, int S, int ci, int L,
            float eps2, float growth, float* out, cudaStream_t stream) {
  const long long ncells = static_cast<long long>(g) * g;
  const int blocks = static_cast<int>((ncells + kWarps - 1) / kWarps);
  if (eps2 > 0.f) {
    near_kernel<MODE, true><<<blocks, kWarps * 32, 0, stream>>>(
        grid, g, ring, S, ci, L, eps2, growth, out);
  } else {
    near_kernel<MODE, false><<<blocks, kWarps * 32, 0, stream>>>(
        grid, g, ring, S, ci, L, eps2, growth, out);
  }
}

}  // namespace

// Plain C entry point for ctypes. Returns cudaGetLastError() after the
// launch (0 on success); an unknown mode or a row wider than 8 floats
// returns cudaErrorInvalidValue.
extern "C" int nbodyax_slots_near(const float* grid, int g, int ring, int S,
                                  int ci, int L, int mode, float eps2,
                                  float growth, float* out, void* stream) {
  if (L > kMaxL || ci > S) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g > 0) {
    switch (mode) {
      case kReference:
        launch<kReference>(grid, g, ring, S, ci, L, eps2, growth, out, s);
        break;
      case kMomentum:
        launch<kMomentum>(grid, g, ring, S, ci, L, eps2, growth, out, s);
        break;
      case kElastic:
        launch<kElastic>(grid, g, ring, S, ci, L, eps2, growth, out, s);
        break;
      case kNone:
        launch<kNone>(grid, g, ring, S, ci, L, eps2, growth, out, s);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
