// Slot-grid pack of the bh near field, with the finest-level FMM moments,
// for one NVIDIA Hopper card.
//
// Replaces the two TPU kernels of nbodyax/physics/slotpack_pallas.py:
//   _pack_kernel      (B4, launched by _pack_call through build_jrows_pallas)
//   _pack_mom_kernel  (B5, launched by _pack_mom_call)
//
// What it computes. The cell-sorted feature pack sf[n + 1, L] (one row a
// body: pos, [vel], mass, radius, id hi, id lo; see bh_grid._partner_
// structure) holds each finest cell's bodies in one contiguous range
// [starts[c], ends[c]). The slot grid rows[ncells, S, L] is each cell's
// first min(count, S) rows followed by zero rows: exactly the gather of
// nbodyax's _build_slot_grid, bit for bit (a copy and zero fill, no
// arithmetic). With kMoments the kernel also reduces each cell's WHOLE
// range to the six order-2 moments of _finest_moments_scatter about the
// cell centre mins + (c + 0.5) * csz: m, m*rx, m*ry, m*rx*rx, m*rx*ry,
// m*ry*ry, with r = pos - centre. The centre, r and the products are
// computed with the same f32 operations in the same order as the plain
// version (__fmul_rn / __fadd_rn, never contracted into FMAs); only the
// order of the sums differs.
//
// Design: one warp a cell, four cells a block. The warp copies the cell's
// rows as one coalesced stream of S*L floats, then strides over its bodies
// for the moments and folds the 32 partial sums with shuffles. There are
// no atomics and no shared memory, so every run gives the same bits. The
// TPU kernel needs a static VMEM capacity and a runtime fallback to the
// gather for crowded blocks; here a cell of any occupancy is one warp's
// loop, so that branch has no counterpart.
//
// What bounds it: device-memory bandwidth. The slot grid is ncells*S*L
// floats written (63 MB at N = 1M, S = 40, L = 6) and the sorted pack is
// read once; the moments add a second read of pos and mass.
//
// mins and csz arrive as a device array geom = {mins_x, mins_y, csz_x,
// csz_y}, so the caller never reads the extent back to the host.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kNumMoments = 6;

template <bool kMoments>
__global__ void __launch_bounds__(kWarps * 32)
slot_pack_kernel(const float* __restrict__ sf, int L,
                 const long long* __restrict__ starts,
                 const long long* __restrict__ ends, int ncells, int S,
                 int g, const float* __restrict__ geom,
                 float* __restrict__ rows, float* __restrict__ mom) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * kWarps + warp;
  if (cell >= ncells) return;
  const long long st = starts[cell];
  const long long en = ends[cell];
  const long long count = en - st;
  const int valid = static_cast<int>(count < S ? count : S) * L;
  const int total = S * L;
  const float* src = sf + st * L;
  float* dst = rows + static_cast<long long>(cell) * total;
  for (int e = lane; e < total; e += 32) dst[e] = e < valid ? src[e] : 0.f;

  if constexpr (kMoments) {
    const int cx = cell % g;
    const int cy = cell / g;
    const float ctrx = __fadd_rn(
        geom[0], __fmul_rn(__fadd_rn(static_cast<float>(cx), 0.5f), geom[2]));
    const float ctry = __fadd_rn(
        geom[1], __fmul_rn(__fadd_rn(static_cast<float>(cy), 0.5f), geom[3]));
    float s[kNumMoments] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (long long b = st + lane; b < en; b += 32) {
      const float* f = sf + b * L;
      const float m = f[L - 4];
      const float rx = __fsub_rn(f[0], ctrx);
      const float ry = __fsub_rn(f[1], ctry);
      const float mrx = __fmul_rn(m, rx);
      const float mry = __fmul_rn(m, ry);
      s[0] = __fadd_rn(s[0], m);
      s[1] = __fadd_rn(s[1], mrx);
      s[2] = __fadd_rn(s[2], mry);
      s[3] = __fadd_rn(s[3], __fmul_rn(mrx, rx));
      s[4] = __fadd_rn(s[4], __fmul_rn(mrx, ry));
      s[5] = __fadd_rn(s[5], __fmul_rn(mry, ry));
    }
#pragma unroll
    for (int k = 0; k < kNumMoments; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s[k] = __fadd_rn(s[k], __shfl_down_sync(0xffffffffu, s[k], off));
    }
    if (lane == 0) {
      float* o = mom + static_cast<long long>(cell) * kNumMoments;
#pragma unroll
      for (int k = 0; k < kNumMoments; ++k) o[k] = s[k];
    }
  }
}

inline int blocks_for(int ncells) { return (ncells + kWarps - 1) / kWarps; }

}  // namespace

// B4: rows only. Plain C entry point for ctypes; returns cudaGetLastError().
extern "C" int nbodyax_slot_pack(const float* sf, int L,
                                 const long long* starts,
                                 const long long* ends, int ncells, int S,
                                 float* rows, void* stream) {
  if (ncells > 0) {
    slot_pack_kernel<false>
        <<<blocks_for(ncells), kWarps * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(sf, L, starts, ends, ncells,
                                                S, 0, nullptr, rows, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// B5: rows plus the [ncells, 6] order-2 moments of a 2-D grid of side g.
extern "C" int nbodyax_slot_pack_moments(const float* sf, int L,
                                         const long long* starts,
                                         const long long* ends, int ncells,
                                         int S, int g, const float* geom,
                                         float* rows, float* mom,
                                         void* stream) {
  if (ncells > 0) {
    slot_pack_kernel<true>
        <<<blocks_for(ncells), kWarps * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(sf, L, starts, ends, ncells,
                                                S, g, geom, rows, mom);
  }
  return static_cast<int>(cudaGetLastError());
}
