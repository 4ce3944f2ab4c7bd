// Fused all-pairs gravity and collision bookkeeping for one NVIDIA Hopper card.
//
// Replaces the TPU kernel nbodyax/physics/kernels.py::_pair_kernel (launched
// by _raw_impl through tile_accumulators_raw / pallas_pair_accumulators), in
// both of its forms, D = 2 and D = 3. The per-pair semantics are those of
// nbodyax/physics/pairwise.py, the oracle the port's
// nbodyax_torch/physics/pairwise.py mirrors:
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
// Inputs are the body_features rows, f32[N, 8]: pos[0:D], vel[D:2D], mass at
// 2D, radius at 2D+1 (0 for dead bodies), zero padding. D is an argument of
// the entry point: the rows do not encode it. Output is the 8-channel f32
// layout of the TPU kernel: ch0..D-1 force; chD, D+1, D+2 the mode channels
// (gained mass, gained radius, died count in reference mode; dv in elastic
// mode, whose third component exists only in 3-D); ch6 best mass (-FLT_MAX
// when none); the rest 0. Momentum mode also writes one int32 parent id per
// row (INT_MAX when none). i_off / j_off are the global ids of row 0 of each
// side, so a caller may pass any i range against any j range.
//
// What bounds it: FP32 work on the CUDA cores, about 18 flops and one rsqrt
// a pair in 2-D (two subtracts, the squared distance, the radius test, the
// softened d2, rsqrt, its cube, the mass, two force terms, two adds) and 23
// in 3-D (a third subtract, its square and add into d2, a third force term
// and add). Each partner is read from device memory once per block, so
// nothing else comes near. No wgmma: the distance is computed
// subtract-first, as nbodyax does (nbodyax/physics/kernels.py:18-25); the
// GEMM expansion |p_i|^2 + |p_j|^2 - 2 p_i.p_j rounds differently and would
// move overlap decisions, which are part of the result.
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
//   f32[S, Ni, 8] / i32[S, Ni] in split order: channels 0-5 by a Kahan add
//   (exact for the died count, a sum of small integers), best mass and
//   parent by larger mass then lower id from (-FLT_MAX, INT_MAX). Two
//   launches, no atomics, results repeat bit for bit (a cluster reduction
//   through distributed shared memory was the other choice; it caps the
//   splits at 8 and ties the grid's split dimension to the cluster size,
//   which lopsided calls such as Ni = 1 against Nj = 16,384 do not fit).
// - Each thread owns kRows rows (4 in 2-D, 3 in 3-D; strided by the block
//   width, so loads and stores stay coalesced): one float4 partner read
//   from shared memory, (x, y, m, r) in 2-D, (x, y, z, m) plus a float
//   radius in 3-D, and in elastic mode a float2 (vx, vy) or float4 (vx, vy,
//   vz, 0) velocity, feeds kRows independent pair chains.
// - Partners are staged kTile = 256 at a time, each row read once as two
//   16-byte loads.
// - The force is summed plainly over kSub = 32 partners and that sub-sum is
//   Kahan-added into the row's total: one add a pair instead of four, with
//   the error still independent of N.
// - rsqrt is the SFU's own (rsqrt_sfu), without the three instructions a
//   pair rsqrtf spends rescaling denormal inputs, whose cube overflows to
//   +inf either way.
// - The dimension is a template parameter: the 2-D instantiation is the
//   code and the results of the 2-D-only kernel, and a 3-D row adds z, vz,
//   a z force sum and its compensation, and a third mode channel.
//
// What is left is instruction throughput: about 20 FP32 and SFU
// instructions a pair in 2-D, most of them single adds and multiplies that
// must not fuse (the rounding rules below), so the 67 TFLOP/s FP32 peak,
// which counts an FMA as two flops, is out of reach by about half.
//
// Rounding: the overlap test decides merges exactly, so it must round like
// the CPU oracle. nvcc would contract dx*dx + dy*dy and rsum*rsum into FMAs;
// d2 (summed ((dx*dx + dy*dy) + dz*dz), left to right as the oracle sums
// it), rsum^2, the elastic v.p test and the gained radius are therefore
// computed with __fmul_rn / __fadd_rn, which are never contracted. The
// elastic impulse uses an IEEE division (no -use_fast_math). Ids are exact
// int32 at any offset.

#include <cfloat>
#include <climits>
#include <type_traits>

#include "pair_common.cuh"

namespace {

using namespace nbodyax;

// Rows a thread owns: 4 in 2-D; 3 in 3-D, where four rows' z, vz, z force
// sum and compensation and third mode channel spilled past the 128
// registers a thread that __launch_bounds__(kThreads, 4) leaves (ptxas on
// sm_90a: 52 bytes of spill stores in reference mode, 28 in momentum).
template <int DIM>
constexpr int kRowsOf = DIM == 3 ? 3 : 4;

template <int DIM>
constexpr int kBlockRowsOf = kThreads * kRowsOf<DIM>;

template <int MODE, int DIM>
__global__ void __launch_bounds__(kThreads, 4)
pair_kernel(const float* __restrict__ fi, int ni,
            const float* __restrict__ fj, int nj,
            int i_off, int j_off, float eps2, float growth, int chunk,
            float* __restrict__ out, int* __restrict__ parent) {
  constexpr int kRows = kRowsOf<DIM>;
  constexpr int kBlockRows = kBlockRowsOf<DIM>;
  using Vel = std::conditional_t<DIM == 3, float4, float2>;
  __shared__ float4 sp[kTile];            // 2-D: x, y, m, r; 3-D: x, y, z, m
  __shared__ float sr[DIM == 3 ? kTile : 1];              // 3-D: r
  __shared__ Vel sv[MODE == kElastic ? kTile : 1];        // velocity

  // split blockIdx.y writes its own slice of the partial buffer
  out += static_cast<long long>(blockIdx.y) * ni * kCh;
  if constexpr (MODE == kMomentum) {
    parent += static_cast<long long>(blockIdx.y) * ni;
  }

  const int row0 = blockIdx.x * kBlockRows + threadIdx.x;
  float xi[kRows], yi[kRows], zi[kRows], vxi[kRows], vyi[kRows], vzi[kRows];
  float mi[kRows], ri[kRows];
  int gi[kRows];
  float fx[kRows], fy[kRows], fz[kRows];      // force
  float cx[kRows], cy[kRows], cz[kRows];      // and its compensation
  float m0[kRows], m1[kRows], m2[kRows];      // mode channels D, D+1, D+2
  float best[kRows];
  int best_j[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = row0 + k * kThreads;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (row < ni) load_row(fi + static_cast<long long>(row) * kFeats, a, b);
    if constexpr (DIM == 3) {
      xi[k] = a.x; yi[k] = a.y; zi[k] = a.z;
      vxi[k] = a.w; vyi[k] = b.x; vzi[k] = b.y;
      mi[k] = b.z; ri[k] = b.w;
    } else {
      xi[k] = a.x; yi[k] = a.y; zi[k] = 0.f;
      vxi[k] = a.z; vyi[k] = a.w; vzi[k] = 0.f;
      mi[k] = b.x; ri[k] = b.y;
    }
    gi[k] = i_off + row;
    fx[k] = fy[k] = fz[k] = cx[k] = cy[k] = cz[k] = 0.f;
    m0[k] = m1[k] = m2[k] = 0.f;
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
      if constexpr (DIM == 3) {
        sp[t] = make_float4(a.x, a.y, a.z, b.z);
        sr[t] = b.w;
        if constexpr (MODE == kElastic) {
          sv[t] = make_float4(a.w, b.x, b.y, 0.f);
        }
      } else {
        sp[t] = make_float4(a.x, a.y, b.x, b.y);
        if constexpr (MODE == kElastic) sv[t] = make_float2(a.z, a.w);
      }
    }
    __syncthreads();
    for (int t0 = 0; t0 < count; t0 += kSub) {
      const int t1 = min(count, t0 + kSub);
      float sx[kRows], sy[kRows], sz[kRows];    // this sub-tile's force
#pragma unroll
      for (int k = 0; k < kRows; ++k) sx[k] = sy[k] = sz[k] = 0.f;
#pragma unroll 2
      for (int t = t0; t < t1; ++t) {
        const float4 p = sp[t];
        float pz = 0.f, mj, rj;
        if constexpr (DIM == 3) {
          pz = p.z; mj = p.w; rj = sr[t];
        } else {
          mj = p.z; rj = p.w;
        }
        const int gj = j_off + base + t;
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const float dx = __fsub_rn(p.x, xi[k]);
          const float dy = __fsub_rn(p.y, yi[k]);
          float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          float dz = 0.f;
          if constexpr (DIM == 3) {
            dz = __fsub_rn(pz, zi[k]);
            d2 = __fadd_rn(d2, __fmul_rn(dz, dz));
          }
          const float rsum = __fadd_rn(ri[k], rj);
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
          if constexpr (DIM == 3) sz[k] += w * dz;
          if constexpr (MODE == kReference) {
            if (overlap && gj != gi[k]) {
              if (mi[k] >= mj) {
                m0[k] += mj;
                m1[k] += __fmul_rn(rj, growth);
              } else {
                m2[k] += 1.f;
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
            const Vel v = sv[t];
            float vdotp = __fadd_rn(__fmul_rn(v.x - vxi[k], dx),
                                    __fmul_rn(v.y - vyi[k], dy));
            if constexpr (DIM == 3) {
              vdotp = __fadd_rn(vdotp, __fmul_rn(v.z - vzi[k], dz));
            }
            // vdotp < 0 excludes the self pair and coincident bodies
            if (overlap && vdotp < 0.f) {
              const float coef = vdotp * mj / ((mi[k] + mj) * d2);
              m0[k] += coef * dx;
              m1[k] += coef * dy;
              if constexpr (DIM == 3) m2[k] += coef * dz;
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        kahan_add(fx[k], cx[k], sx[k]);
        kahan_add(fy[k], cy[k], sy[k]);
        if constexpr (DIM == 3) kahan_add(fz[k], cz[k], sz[k]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = row0 + k * kThreads;
    if (row >= ni) continue;
    float* o = out + static_cast<long long>(row) * kCh;
    if constexpr (DIM == 3) {
      store_row(o, make_float4(fx[k], fy[k], fz[k], m0[k]),
                make_float4(m1[k], m2[k], best[k], 0.f));
    } else {
      store_row(o, make_float4(fx[k], fy[k], m0[k], m1[k]),
                make_float4(m2[k], 0.f, best[k], 0.f));
    }
    if constexpr (MODE == kMomentum) parent[row] = best_j[k];
  }
}

// Reduces the partials of `splits` splits in split order, one thread a row.
// Channels 0-5 are sums in either dimension (force, the mode channels, the
// died count, and 2-D's unused channel 5, which stays 0), so one Kahan rule
// serves both; on small integers it is an exact sum.
__global__ void __launch_bounds__(kThreads)
pair_combine(const float* __restrict__ part, const int* __restrict__ ppart,
             int ni, int splits, float* __restrict__ out,
             int* __restrict__ parent) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= ni) return;
  float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float c[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
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
    kahan_add(s[4], c[4], b.x);
    kahan_add(s[5], c[5], b.y);
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
            make_float4(s[4], s[5], best, 0.f));
  if (parent != nullptr) parent[row] = best_j;
}

template <int MODE, int DIM>
void launch_pass(const float* fi, int ni, const float* fj, int nj, int i_off,
                 int j_off, float eps2, float growth, int splits, float* out,
                 int* parent, cudaStream_t stream) {
  const dim3 grid((ni + kBlockRowsOf<DIM> - 1) / kBlockRowsOf<DIM>, splits);
  pair_kernel<MODE, DIM><<<grid, kThreads, 0, stream>>>(
      fi, ni, fj, nj, i_off, j_off, eps2, growth, split_chunk(nj, splits),
      out, parent);
}

template <int DIM>
void launch_dim(int mode, const float* fi, int ni, const float* fj, int nj,
                int i_off, int j_off, float eps2, float growth, int splits,
                float* out, int* parent, cudaStream_t s) {
  switch (mode) {
    case kReference:
      launch_pass<kReference, DIM>(fi, ni, fj, nj, i_off, j_off, eps2,
                                   growth, splits, out, parent, s);
      break;
    case kMomentum:
      launch_pass<kMomentum, DIM>(fi, ni, fj, nj, i_off, j_off, eps2,
                                  growth, splits, out, parent, s);
      break;
    case kElastic:
      launch_pass<kElastic, DIM>(fi, ni, fj, nj, i_off, j_off, eps2,
                                 growth, splits, out, parent, s);
      break;
    default:
      launch_pass<kNone, DIM>(fi, ni, fj, nj, i_off, j_off, eps2, growth,
                              splits, out, parent, s);
      break;
  }
}

template <int MODE, int DIM>
int blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pair_kernel<MODE, DIM>,
                                                kThreads, 0);
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
// holds at once in `mode` and dimension `dim` (from the occupancy API, on
// the current device) and how many rows a block owns. The wrapper picks the
// splits from these.
extern "C" int nbodyax_pair_launch_shape(int mode, int dim, int* blocks,
                                         int* rows) {
  if (mode < kReference || mode > kNone || (dim != 2 && dim != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *blocks = dim == 3 ? blocks_per_sm<3>(mode) : blocks_per_sm<2>(mode);
  *rows = dim == 3 ? kBlockRowsOf<3> : kBlockRowsOf<2>;
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry point for ctypes. `dim` (2 or 3) is the layout of the rows.
// `splits` >= 1 splits the partners across blocks; with more than one,
// `part` (f32[splits, ni, 8]) and, in momentum mode, `ppart`
// (i32[splits, ni]) are scratch the caller allocates, and a second launch
// combines them into `out` / `parent`. Returns cudaGetLastError() after the
// launches (0 on success); an unknown mode or dimension or a split count
// below 1 returns cudaErrorInvalidValue.
extern "C" int nbodyax_pair_accumulators(
    const float* fi, int ni, const float* fj, int nj, int i_off, int j_off,
    int mode, int dim, float eps2, float growth, int splits, float* part,
    int* ppart, float* out, int* parent, void* stream) {
  if (splits < 1 || mode < kReference || mode > kNone ||
      (dim != 2 && dim != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ni == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits == 1 ? out : part;
  int* pdst = mode != kMomentum ? nullptr : splits == 1 ? parent : ppart;
  if (dim == 3) {
    launch_dim<3>(mode, fi, ni, fj, nj, i_off, j_off, eps2, growth, splits,
                  dst, pdst, s);
  } else {
    launch_dim<2>(mode, fi, ni, fj, nj, i_off, j_off, eps2, growth, splits,
                  dst, pdst, s);
  }
  if (splits > 1) {
    pair_combine<<<(ni + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        part, pdst, ni, splits, out, mode == kMomentum ? parent : nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
