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
// [starts[c], ends[c]); the ranges follow each other in cell order. The
// slot grid rows[ncells, S, L] is each cell's first min(count, S) rows
// followed by zero rows: exactly the gather of nbodyax's _build_slot_grid,
// bit for bit (a copy and zero fill, no arithmetic), for any row width L
// the near field uses: DIM + 4, or 2 DIM + 4 in elastic mode, so 6 and 8 in
// 2-D and 7 and 10 in 3-D. (The TPU kernel hands L = 10 to the gather,
// because it exceeds its 8-sublane tile; this card has no such tile.) B5
// also reduces each cell's WHOLE range to the order-2 moments of
// _finest_moments_scatter about the cell centre mins + (c + 0.5) * csz of
// a grid of side g in DIM = 2 or 3 dimensions (cell c has coordinate
// (c / g^d) % g on axis d): m, m*r_a, then m*r_a*r_b for a <= b in
// _moment_pairs' order, with r = pos - centre: 6 moments in 2-D (m, m*rx,
// m*ry, m*rx*rx, m*rx*ry, m*ry*ry), 10 in 3-D (m, m*rx, m*ry, m*rz, xx, xy,
// xz, yy, yz, zz). The centre, r and the products are computed with the
// same f32 operations in the same order as the plain version (__fmul_rn /
// __fadd_rn, never contracted into FMAs); only the order of the sums
// differs.
//
// What bounds it: device-memory bandwidth. The slot grid is ncells*S*L
// floats written (63 MB at N = 1M, S = 40, L = 6), the occupied rows of
// the pack are read once, and the moments read pos and mass again; about
// 0.031 ms at 3.35 TB/s for B5 at N = 1M in 2-D.
//
// Design.
//
// - The copy (B4 and B5): one warp a cell, four cells a block. The warp
//   writes the cell's S*L floats as one stream of 16-byte stores where S*L
//   is a multiple of 4 and L is even (8-byte stores where only L is even,
//   each made of 8-byte loads from sf; 4-byte loads and stores for the odd
//   L = 7 of 3-D, whose rows are only 4-byte aligned), and the pad past
//   the count as zeros with the same stores.
// - The crowded-cell tail. One warp reducing a whole cell's range is a
//   serial loop as long as the cell: a cell holding a quarter of a
//   crowded N = 262,144 state (28,000 bodies) took 0.38 ms while the rest
//   of the card idled (a uniform state of the same N: 0.033 ms). So a cell
//   of at most kChunk = 256 bodies is still reduced by its copy warp
//   (strided loads, a fixed shuffle tree), but a larger cell is cut into
//   the fixed chunks of kChunk bodies of the sorted pack: a first kernel,
//   slot_pack_moments_chunk, gives each chunk a warp. A chunk meets at
//   most two cells of more than kChunk bodies, its first and its last
//   (any cell between them lies inside the chunk), so the warp finds those
//   two cells by a 16-ary search of `ends` and reduces the part of each
//   inside the chunk to a partial: slot 0 of the chunk for a cell that
//   began before the chunk, slot 1 for one that begins in it. The copy
//   warp of such a cell then folds its partials in chunk order (slot 1 of
//   its first chunk, slot 0 of the others), lanes striding the chunks
//   with Kahan sums and a fixed shuffle tree. Deterministic, no atomics,
//   and no cell is more than kChunk bodies of one warp's work, plus a fold
//   of count / kChunk partials.
//
// mins and csz arrive as a device array geom = {mins[DIM], csz[DIM]}, so
// the caller never reads the extent back to the host. The partials are
// f32[nchunks, 2, 6 or 10], nchunks = ceil(n / kChunk), which the wrapper
// allocates (slotpack_kernel.moment_plan).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
// order-2 moments of a cell in DIM dimensions: 6 in 2-D, 10 in 3-D
__host__ __device__ constexpr int num_moments(int dim) {
  return 1 + dim + dim * (dim + 1) / 2;
}
constexpr int kChunk = 256;     // must equal slotpack_kernel.MOMENT_CHUNK
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = __fsub_rn(x, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The centre of cell c of a DIM-dimensional grid of side g, as the plain
// version rounds it: mins + (c + 0.5) * csz on each axis, axis d at stride
// g^d of the flat cell id.
template <int DIM>
__device__ __forceinline__ void centre(int c, int g, const float* geom,
                                       float (&ctr)[DIM]) {
  if constexpr (DIM == 3) {
    ctr[0] = __fadd_rn(geom[0],
                       __fmul_rn(__fadd_rn(static_cast<float>(c % g), 0.5f),
                                 geom[3]));
    ctr[1] = __fadd_rn(
        geom[1], __fmul_rn(__fadd_rn(static_cast<float>((c / g) % g), 0.5f),
                           geom[4]));
    ctr[2] = __fadd_rn(
        geom[2], __fmul_rn(__fadd_rn(static_cast<float>(c / (g * g)), 0.5f),
                           geom[5]));
  } else {
    ctr[0] = __fadd_rn(geom[0],
                       __fmul_rn(__fadd_rn(static_cast<float>(c % g), 0.5f),
                                 geom[2]));
    ctr[1] = __fadd_rn(geom[1],
                       __fmul_rn(__fadd_rn(static_cast<float>(c / g), 0.5f),
                                 geom[3]));
  }
}

// The moments of the bodies [b0, b1) about ctr, summed by the warp's lanes
// in a fixed order; lane 0 holds the result.
template <int DIM>
__device__ __forceinline__ void warp_moments(const float* __restrict__ sf,
                                             int L, long long b0,
                                             long long b1,
                                             const float (&ctr)[DIM],
                                             int lane,
                                             float (&s)[num_moments(DIM)]) {
  constexpr int kNumMoments = num_moments(DIM);
#pragma unroll
  for (int k = 0; k < kNumMoments; ++k) s[k] = 0.f;
  for (long long b = b0 + lane; b < b1; b += 32) {
    const float* f = sf + b * L;
    const float m = f[L - 4];
    const float rx = __fsub_rn(f[0], ctr[0]);
    const float ry = __fsub_rn(f[1], ctr[1]);
    const float mrx = __fmul_rn(m, rx);
    const float mry = __fmul_rn(m, ry);
    s[0] = __fadd_rn(s[0], m);
    s[1] = __fadd_rn(s[1], mrx);
    s[2] = __fadd_rn(s[2], mry);
    if constexpr (DIM == 3) {
      const float rz = __fsub_rn(f[2], ctr[2]);
      const float mrz = __fmul_rn(m, rz);
      s[3] = __fadd_rn(s[3], mrz);
      s[4] = __fadd_rn(s[4], __fmul_rn(mrx, rx));
      s[5] = __fadd_rn(s[5], __fmul_rn(mrx, ry));
      s[6] = __fadd_rn(s[6], __fmul_rn(mrx, rz));
      s[7] = __fadd_rn(s[7], __fmul_rn(mry, ry));
      s[8] = __fadd_rn(s[8], __fmul_rn(mry, rz));
      s[9] = __fadd_rn(s[9], __fmul_rn(mrz, rz));
    } else {
      s[3] = __fadd_rn(s[3], __fmul_rn(mrx, rx));
      s[4] = __fadd_rn(s[4], __fmul_rn(mrx, ry));
      s[5] = __fadd_rn(s[5], __fmul_rn(mry, ry));
    }
  }
#pragma unroll
  for (int k = 0; k < kNumMoments; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s[k] = __fadd_rn(s[k], __shfl_down_sync(kFull, s[k], off));
  }
}

// The cells holding body ba (lanes 0-15 answer) and body bb (lanes
// 16-31): the first c with ends[c] > b, by a 16-ary search in each half
// warp, 4 rounds of loads over 65,536 cells. Needs b < ends[ncells - 1].
__device__ int cells_of(const long long* __restrict__ ends, int ncells,
                        long long ba, long long bb, int lane) {
  const int h = lane >> 4;
  const int hl = lane & 15;
  const long long b = h ? bb : ba;
  int lo = 0, hi = ncells;               // the answer lies in [lo, hi)
  for (;;) {
    const int size = hi - lo;
    const bool more = size > 16;
    if (!__any_sync(kFull, more)) break;
    int step = 0;
    bool hit = false;
    if (more) {
      step = (size + 15) / 16;
      hit = ends[min(lo + (hl + 1) * step - 1, hi - 1)] > b;
    }
    const unsigned m = (__ballot_sync(kFull, hit) >> (16 * h)) & 0xFFFFu;
    if (more) {
      const int f = __ffs(m) - 1;        // the last sample always hits
      hi = min(lo + (f + 1) * step, hi);
      lo += f * step;
    }
  }
  const int idx = lo + hl;
  const bool hit = idx < hi && ends[idx] > b;
  const unsigned m = (__ballot_sync(kFull, hit) >> (16 * h)) & 0xFFFFu;
  return lo + __ffs(m) - 1;
}

// B5, first pass: a warp a chunk of kChunk sorted bodies; the partial
// moments of the chunk's cells of more than kChunk bodies.
template <int DIM>
__global__ void __launch_bounds__(kWarps * 32)
slot_pack_moments_chunk(const float* __restrict__ sf, int L,
                        const long long* __restrict__ starts,
                        const long long* __restrict__ ends, int ncells,
                        int nchunks, int g, const float* __restrict__ geom,
                        float* __restrict__ part) {
  constexpr int kNumMoments = num_moments(DIM);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarps + warp;
  if (chunk >= nchunks) return;
  const long long nb = ends[ncells - 1];          // bodies in cells
  const long long b0 = static_cast<long long>(chunk) * kChunk;
  if (b0 >= nb) return;
  const long long b1 = min(b0 + kChunk, nb);
  const int c = cells_of(ends, ncells, b0, b1 - 1, lane);
  const int first = __shfl_sync(kFull, c, 0);
  const int last = __shfl_sync(kFull, c, 16);
  for (int side = 0; side < (first == last ? 1 : 2); ++side) {
    const int cc = side ? last : first;
    const long long st = starts[cc];
    const long long en = ends[cc];
    if (en - st <= kChunk) continue;               // its copy warp reduces it
    float ctr[DIM], s[kNumMoments];
    centre<DIM>(cc, g, geom, ctr);
    warp_moments<DIM>(sf, L, max(st, b0), min(en, b1), ctr, lane, s);
    if (lane == 0) {
      float* o = part + (static_cast<long long>(chunk) * 2 + (st < b0 ? 0 : 1))
                            * kNumMoments;
#pragma unroll
      for (int k = 0; k < kNumMoments; ++k) o[k] = s[k];
    }
  }
}

// The copy, a warp a cell (B4, and B5's second pass): rows, and with
// kMoments the cell's moments in DIM dimensions, reduced here or folded
// from the chunk pass's partials (DIM is unused without kMoments).
template <bool kMoments, int kVec, int DIM>
__global__ void __launch_bounds__(kWarps * 32)
slot_pack_kernel(const float* __restrict__ sf, int L,
                 const long long* __restrict__ starts,
                 const long long* __restrict__ ends, int ncells, int S,
                 int g, const float* __restrict__ geom,
                 const float* __restrict__ part, float* __restrict__ rows,
                 float* __restrict__ mom) {
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
  // valid and e are multiples of 2 when kVec > 1, so each 8-byte half is
  // wholly inside or wholly past the cell's rows
  for (int e = lane * kVec; e < total; e += 32 * kVec) {
    if constexpr (kVec == 4) {
      const float2 a = e < valid ? load2(src + e) : make_float2(0.f, 0.f);
      const float2 b =
          e + 2 < valid ? load2(src + e + 2) : make_float2(0.f, 0.f);
      *reinterpret_cast<float4*>(dst + e) = make_float4(a.x, a.y, b.x, b.y);
    } else if constexpr (kVec == 2) {
      *reinterpret_cast<float2*>(dst + e) =
          e < valid ? load2(src + e) : make_float2(0.f, 0.f);
    } else {
      dst[e] = e < valid ? src[e] : 0.f;
    }
  }

  if constexpr (kMoments) {
    constexpr int kNumMoments = num_moments(DIM);
    float s[kNumMoments];
    if (count > kChunk) {
      // fold the partials in a fixed order: lane l takes chunks js + l,
      // js + l + 32, ... with Kahan sums, then a shuffle tree
      const long long js = st / kChunk;
      const long long je = (en - 1) / kChunk;
      float c[kNumMoments];
#pragma unroll
      for (int k = 0; k < kNumMoments; ++k) s[k] = c[k] = 0.f;
      for (long long j = js + lane; j <= je; j += 32) {
        const float* p = part + (j * 2 + (j == js ? 1 : 0)) * kNumMoments;
#pragma unroll
        for (int k = 0; k < kNumMoments; ++k) kahan_add(s[k], c[k], p[k]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < kNumMoments; ++k) {
          const float os = __shfl_down_sync(kFull, s[k], off);
          const float oc = __shfl_down_sync(kFull, c[k], off);
          kahan_add(s[k], c[k], os);
          kahan_add(s[k], c[k], -oc);
        }
      }
    } else {
      float ctr[DIM];
      centre<DIM>(cell, g, geom, ctr);
      warp_moments<DIM>(sf, L, st, en, ctr, lane, s);
    }
    if (lane == 0) {
      float* o = mom + static_cast<long long>(cell) * kNumMoments;
#pragma unroll
      for (int k = 0; k < kNumMoments; ++k) o[k] = s[k];
    }
  }
}

inline int blocks_for(long long items) {
  return static_cast<int>((items + kWarps - 1) / kWarps);
}

template <bool kMoments, int DIM>
void launch_pack(const float* sf, int L, const long long* starts,
                 const long long* ends, int ncells, int S, int g,
                 const float* geom, const float* part, float* rows,
                 float* mom, cudaStream_t s) {
  const dim3 grid(blocks_for(ncells)), block(kWarps * 32);
  if (L % 2 != 0) {
    slot_pack_kernel<kMoments, 1, DIM><<<grid, block, 0, s>>>(
        sf, L, starts, ends, ncells, S, g, geom, part, rows, mom);
  } else if ((S * L) % 4 != 0) {
    slot_pack_kernel<kMoments, 2, DIM><<<grid, block, 0, s>>>(
        sf, L, starts, ends, ncells, S, g, geom, part, rows, mom);
  } else {
    slot_pack_kernel<kMoments, 4, DIM><<<grid, block, 0, s>>>(
        sf, L, starts, ends, ncells, S, g, geom, part, rows, mom);
  }
}

template <int DIM>
void launch_moments(const float* sf, int L, const long long* starts,
                    const long long* ends, int ncells, int S, int g,
                    const float* geom, int nchunks, float* part, float* rows,
                    float* mom, cudaStream_t s) {
  if (nchunks > 0) {
    slot_pack_moments_chunk<DIM><<<blocks_for(nchunks), kWarps * 32, 0, s>>>(
        sf, L, starts, ends, ncells, nchunks, g, geom, part);
  }
  launch_pack<true, DIM>(sf, L, starts, ends, ncells, S, g, geom, part, rows,
                         mom, s);
}

}  // namespace

// B4: rows only. Plain C entry point for ctypes; returns cudaGetLastError().
// sf must be 8-byte aligned where L is even and rows 16-byte aligned (the
// wrapper checks).
extern "C" int nbodyax_slot_pack(const float* sf, int L,
                                 const long long* starts,
                                 const long long* ends, int ncells, int S,
                                 float* rows, void* stream) {
  if (ncells > 0) {
    launch_pack<false, 2>(sf, L, starts, ends, ncells, S, 0, nullptr,
                          nullptr, rows, nullptr,
                          static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

// B5: rows plus the [ncells, 6 or 10] order-2 moments of a grid of side g
// in dim = 2 or 3 dimensions (ncells = g^dim); geom is {mins[dim],
// csz[dim]}, part the f32[nchunks, 2, 6 or 10] scratch of the chunk pass,
// nchunks = ceil(n / 256) for the n bodies of sf. Two launches. Any other
// dim returns cudaErrorInvalidValue.
extern "C" int nbodyax_slot_pack_moments(const float* sf, int L,
                                         const long long* starts,
                                         const long long* ends, int ncells,
                                         int S, int g, int dim,
                                         const float* geom, int nchunks,
                                         float* part, float* rows,
                                         float* mom, void* stream) {
  if (dim != 2 && dim != 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ncells > 0) {
    if (dim == 3) {
      launch_moments<3>(sf, L, starts, ends, ncells, S, g, geom, nchunks,
                        part, rows, mom, s);
    } else {
      launch_moments<2>(sf, L, starts, ends, ncells, S, g, geom, nchunks,
                        part, rows, mom, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
