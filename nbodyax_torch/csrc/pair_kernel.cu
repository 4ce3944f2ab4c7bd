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
// What bounds it: FP32 work on the CUDA cores, about 18 flops and one rsqrt
// a pair (two subtracts, the squared distance, the radius test, the
// softened d2, rsqrt, its cube, the mass, two force terms, two adds). Each
// partner is read from device memory once per block, so nothing else comes
// near. No wgmma: the distance is computed subtract-first, as nbodyax does
// (nbodyax/physics/kernels.py:18-25); the GEMM expansion
// |p_i|^2 + |p_j|^2 - 2 p_i.p_j rounds differently and would move overlap
// decisions, which are part of the result.
//
// Design, against what held the first version (one thread a row, one block
// of 4 warps an SM at N = 16,384, a dependent chain of shared loads, rsqrt
// and a Kahan add per pair) to ~10% of that bound:
//
// - The partners are split across blocks (pair_common.cuh): the grid is
//   (row blocks) x (splits), and the wrapper picks the splits from the SM
//   count and the blocks an SM holds (nbodyax_pair_launch_shape) so that
//   the grid fills one wave of the card. With one split the
//   pass writes the output; with more, pair_combine reduces the partials
//   f32[S, Ni, 8] / i32[S, Ni] in split order: the force and mode channels
//   by a Kahan add, the died count exactly, best mass and parent by larger
//   mass then lower id from (-FLT_MAX, INT_MAX). Two launches, no atomics,
//   results repeat bit for bit (a cluster reduction through distributed
//   shared memory was the other choice; it caps the splits at 8 and ties the
//   grid's split dimension to the cluster size, which lopsided calls such as
//   Ni = 1 against Nj = 16,384 do not fit).
// - Each thread owns kRows rows (strided by the block width, so loads and
//   stores stay coalesced): one float4 partner (x, y, m, r) read from shared
//   memory, plus a float2 velocity in elastic mode, feeds kRows independent
//   pair chains.
// - Partners are staged kTile = 256 at a time, each row read once as two
//   16-byte loads.
// - The force is summed plainly over kSub = 32 partners and that sub-sum is
//   Kahan-added into the row's total: one add a pair instead of four, with
//   the error still independent of N.
// - rsqrt is the SFU's own (rsqrt_sfu), without the three instructions a
//   pair rsqrtf spends rescaling denormal inputs, whose cube overflows to
//   +inf either way.
//
// What is left is instruction throughput: about 20 FP32 and SFU
// instructions a pair, most of them single adds and multiplies that must
// not fuse (the rounding rules below), so the 67 TFLOP/s FP32 peak, which
// counts an FMA as two flops, is out of reach by about half.
//
// Rounding: the overlap test decides merges exactly, so it must round like
// the CPU oracle. nvcc would contract dx*dx + dy*dy and rsum*rsum into FMAs;
// d2, rsum^2, the elastic v.p test and the gained radius are therefore
// computed with __fmul_rn / __fadd_rn, which are never contracted. The
// elastic impulse uses an IEEE division (no -use_fast_math). Ids are exact
// int32 at any offset.

#include <cfloat>
#include <climits>

#include "pair_common.cuh"

namespace {

using namespace nbodyax;

constexpr int kRows = 4;                      // rows a thread owns
constexpr int kBlockRows = kThreads * kRows;

template <int MODE>
__global__ void __launch_bounds__(kThreads, 4)
pair_kernel(const float* __restrict__ fi, int ni,
            const float* __restrict__ fj, int nj,
            int i_off, int j_off, float eps2, float growth, int chunk,
            float* __restrict__ out, int* __restrict__ parent) {
  __shared__ float4 sp[kTile];                            // x, y, m, r
  __shared__ float2 sv[MODE == kElastic ? kTile : 1];     // vx, vy

  // split blockIdx.y writes its own slice of the partial buffer
  out += static_cast<long long>(blockIdx.y) * ni * kCh;
  if constexpr (MODE == kMomentum) {
    parent += static_cast<long long>(blockIdx.y) * ni;
  }

  const int row0 = blockIdx.x * kBlockRows + threadIdx.x;
  float xi[kRows], yi[kRows], vxi[kRows], vyi[kRows], mi[kRows], ri[kRows];
  int gi[kRows];
  float fx[kRows], fy[kRows], cx[kRows], cy[kRows];   // force, compensation
  float c2[kRows], c3[kRows], c4[kRows];
  float best[kRows];
  int best_j[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = row0 + k * kThreads;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (row < ni) load_row(fi + static_cast<long long>(row) * kFeats, a, b);
    xi[k] = a.x; yi[k] = a.y; vxi[k] = a.z; vyi[k] = a.w;
    mi[k] = b.x; ri[k] = b.y;
    gi[k] = i_off + row;
    fx[k] = fy[k] = cx[k] = cy[k] = 0.f;
    c2[k] = c3[k] = c4[k] = 0.f;
    best[k] = -FLT_MAX;
    best_j[k] = INT_MAX;
  }

  const int jb = blockIdx.y * chunk;
  const int je = min(nj, jb + chunk);
  for (int base = jb; base < je; base += kTile) {
    const int count = min(kTile, je - base);
    for (int t = threadIdx.x; t < count; t += kThreads) {
      float4 a, b;
      load_row(fj + static_cast<long long>(base + t) * kFeats, a, b);
      sp[t] = make_float4(a.x, a.y, b.x, b.y);
      if constexpr (MODE == kElastic) sv[t] = make_float2(a.z, a.w);
    }
    __syncthreads();
    for (int t0 = 0; t0 < count; t0 += kSub) {
      const int t1 = min(count, t0 + kSub);
      float sx[kRows], sy[kRows];       // this sub-tile's force, plain
#pragma unroll
      for (int k = 0; k < kRows; ++k) sx[k] = sy[k] = 0.f;
#pragma unroll 2
      for (int t = t0; t < t1; ++t) {
        const float4 p = sp[t];
        const float mj = p.z;
        const int gj = j_off + base + t;
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const float dx = __fsub_rn(p.x, xi[k]);
          const float dy = __fsub_rn(p.y, yi[k]);
          const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          const float rsum = __fadd_rn(ri[k], p.w);
          // overlap includes the self pair (d2 = 0); for the force that is
          // exactly the set of pairs to leave out
          const bool overlap = d2 <= __fmul_rn(rsum, rsum);
          const float inv = rsqrt_sfu(d2 + eps2);
          const float wm = mj * (inv * inv * inv);
          float w;
          if constexpr (MODE == kElastic) {
            w = (eps2 > 0.f || d2 > 0.f) ? wm : 0.f;
          } else {
            w = overlap ? 0.f : wm;
          }
          sx[k] += w * dx;
          sy[k] += w * dy;
          if constexpr (MODE == kReference) {
            if (overlap && gj != gi[k]) {
              if (mi[k] >= mj) {
                c2[k] += mj;
                c3[k] += __fmul_rn(p.w, growth);
              } else {
                c4[k] += 1.f;
              }
            }
          } else if constexpr (MODE == kMomentum) {
            // beats excludes the self pair: equal mass and equal id
            const bool beats = mj > mi[k] || (mj == mi[k] && gj < gi[k]);
            if (overlap && beats &&
                (mj > best[k] || (mj == best[k] && gj < best_j[k]))) {
              best[k] = mj;
              best_j[k] = gj;
            }
          } else if constexpr (MODE == kElastic) {
            const float2 v = sv[t];
            const float vdotp = __fadd_rn(__fmul_rn(v.x - vxi[k], dx),
                                          __fmul_rn(v.y - vyi[k], dy));
            // vdotp < 0 excludes the self pair and coincident bodies
            if (overlap && vdotp < 0.f) {
              const float coef = vdotp * mj / ((mi[k] + mj) * d2);
              c2[k] += coef * dx;
              c3[k] += coef * dy;
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        kahan_add(fx[k], cx[k], sx[k]);
        kahan_add(fy[k], cy[k], sy[k]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = row0 + k * kThreads;
    if (row >= ni) continue;
    store_row(out + static_cast<long long>(row) * kCh,
              make_float4(fx[k], fy[k], c2[k], c3[k]),
              make_float4(c4[k], 0.f, best[k], 0.f));
    if constexpr (MODE == kMomentum) parent[row] = best_j[k];
  }
}

// Reduces the partials of `splits` splits in split order, one thread a row.
__global__ void __launch_bounds__(kThreads)
pair_combine(const float* __restrict__ part, const int* __restrict__ ppart,
             int ni, int splits, float* __restrict__ out,
             int* __restrict__ parent) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= ni) return;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
  float died = 0.f;
  float best = -FLT_MAX;
  int best_j = INT_MAX;
  for (int sp = 0; sp < splits; ++sp) {
    const long long r = static_cast<long long>(sp) * ni + row;
    float4 a, b;
    load_row(part + r * kCh, a, b);
    kahan_add(s[0], c[0], a.x);
    kahan_add(s[1], c[1], a.y);
    kahan_add(s[2], c[2], a.z);
    kahan_add(s[3], c[3], a.w);
    died = __fadd_rn(died, b.x);       // counts: an exact sum
    if (ppart != nullptr) {
      const int id = ppart[r];
      if (b.z > best || (b.z == best && id < best_j)) {
        best = b.z;
        best_j = id;
      }
    }
  }
  store_row(out + static_cast<long long>(row) * kCh,
            make_float4(s[0], s[1], s[2], s[3]),
            make_float4(died, 0.f, best, 0.f));
  if (parent != nullptr) parent[row] = best_j;
}

template <int MODE>
void launch_pass(const float* fi, int ni, const float* fj, int nj, int i_off,
                 int j_off, float eps2, float growth, int splits, float* out,
                 int* parent, cudaStream_t stream) {
  const dim3 grid((ni + kBlockRows - 1) / kBlockRows, splits);
  pair_kernel<MODE><<<grid, kThreads, 0, stream>>>(
      fi, ni, fj, nj, i_off, j_off, eps2, growth, split_chunk(nj, splits),
      out, parent);
}

template <int MODE>
int blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pair_kernel<MODE>,
                                                kThreads, 0);
  return n;
}

}  // namespace

// The pass kernel's launch shape for ctypes: how many of its blocks one SM
// holds at once in `mode` (from the occupancy API, on the current device)
// and how many rows a block owns. The wrapper picks the splits from these.
extern "C" int nbodyax_pair_launch_shape(int mode, int* blocks, int* rows) {
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

// Plain C entry point for ctypes. `splits` >= 1 splits the partners across
// blocks; with more than one, `part` (f32[splits, ni, 8]) and, in momentum
// mode, `ppart` (i32[splits, ni]) are scratch the caller allocates, and a
// second launch combines them into `out` / `parent`. Returns
// cudaGetLastError() after the launches (0 on success); an unknown mode or
// a split count below 1 returns cudaErrorInvalidValue.
extern "C" int nbodyax_pair_accumulators(
    const float* fi, int ni, const float* fj, int nj, int i_off, int j_off,
    int mode, float eps2, float growth, int splits, float* part, int* ppart,
    float* out, int* parent, void* stream) {
  if (splits < 1 || mode < kReference || mode > kNone) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ni == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits == 1 ? out : part;
  int* pdst = mode != kMomentum ? nullptr : splits == 1 ? parent : ppart;
  switch (mode) {
    case kReference:
      launch_pass<kReference>(fi, ni, fj, nj, i_off, j_off, eps2, growth,
                              splits, dst, pdst, s);
      break;
    case kMomentum:
      launch_pass<kMomentum>(fi, ni, fj, nj, i_off, j_off, eps2, growth,
                             splits, dst, pdst, s);
      break;
    case kElastic:
      launch_pass<kElastic>(fi, ni, fj, nj, i_off, j_off, eps2, growth,
                            splits, dst, pdst, s);
      break;
    default:
      launch_pass<kNone>(fi, ni, fj, nj, i_off, j_off, eps2, growth, splits,
                         dst, pdst, s);
      break;
  }
  if (splits > 1) {
    pair_combine<<<(ni + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        part, pdst, ni, splits, out, mode == kMomentum ? parent : nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
