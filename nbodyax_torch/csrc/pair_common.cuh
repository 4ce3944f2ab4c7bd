// Shared by the all-pairs kernels pair_kernel.cu (forward, B1) and
// pair_bwd_kernel.cu (backward, B2): the layout constants, the compensated
// add and the partner split.
//
// Partner split: a call's grid is (row blocks) x (splits). Split s walks
// the partners [s * chunk, min((s + 1) * chunk, n)), with chunk = ceil(n /
// splits) rounded up to kSub, so a trailing split may be empty and then
// writes the identity. The wrapper picks the number of splits (its
// choose_splits); with one split the pass kernel writes the output itself,
// with more it writes a partial buffer f32[splits, rows, 8] that a combine
// kernel reduces in split order. Nothing uses atomics, so a call repeats bit
// for bit on one card.

#pragma once

#include <cuda_runtime.h>

namespace nbodyax {

constexpr int kFeats = 8;     // body_features row: pos, vel, m, r, padding
constexpr int kCh = 8;        // output row
constexpr int kThreads = 128;
constexpr int kTile = 256;    // partners staged in shared memory at a time
constexpr int kSub = 32;      // partners summed plainly before a Kahan add

enum Mode { kReference = 0, kMomentum = 1, kElastic = 2, kNone = 3 };

// Compensated (Kahan) running sum: s + c carries the sum to about one
// rounding whatever the number of terms. Written with _rn intrinsics so the
// compiler can neither contract nor reorder the compensation away. Adding
// small integers (the died count) with it is an exact sum.
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = __fsub_rn(x, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

// rsqrt on the SFU without the rescaling of denormal inputs that rsqrtf
// adds outside -ftz. Only a denormal input differs (+inf instead of about
// 1e19 or more), and every caller cubes the result, which is +inf either
// way.
__device__ __forceinline__ float rsqrt_sfu(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Partners a split walks; a multiple of kSub.
inline int split_chunk(int n, int splits) {
  const int c = (n + splits - 1) / splits;
  return (c + kSub - 1) / kSub * kSub;
}

// One 32-byte row as two 16-byte loads; rows are 16-byte aligned (the
// wrappers check).
__device__ __forceinline__ void load_row(const float* p, float4& a,
                                         float4& b) {
  const float4* q = reinterpret_cast<const float4*>(p);
  a = q[0];
  b = q[1];
}

__device__ __forceinline__ void store_row(float* p, float4 a, float4 b) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = a;
  q[1] = b;
}

}  // namespace nbodyax
