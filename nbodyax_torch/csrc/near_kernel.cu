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
// Input: the slot grid f32[ncells, S, L] of a grid of side g in DIM = 2 or
// 3 dimensions (cell c = (z * g + y) * g + x, x fastest), each cell's first
// S cell-sorted bodies and zero rows past its count; a row is pos[DIM],
// [vel[DIM]], mass, radius, id hi, id lo, with the global id split over
// two exact f32 lanes (hi * 4096 + lo); L is DIM + 4, or 2 DIM + 4 in
// elastic mode (6 / 8 in 2-D, 7 / 10 in 3-D). Output: f32[ncells, ci, 8]
// for each cell's first ci slots, slot-major: the DIM force channels, then
// reference gained mass, gained radius, died (0/1); momentum best mass
// (-inf when none), parent id hi, parent id lo (the slot's own id when
// none); elastic dv[DIM]; zeros elsewhere. A slot that holds no live body
// (a pad, or a dead body) gets exactly those "none" values. (The TPU
// kernel writes a lane-merged channel-major block; that layout is a TPU
// artefact.)
//
// The cell slice, the sharded bh step's form (near_pallas.py's cell_base /
// ncells_eval, :369-389, and the kernel's cbase, :116-119): a launch may
// evaluate only the cells [cell_base, cell_base + ncells_eval) and write
// them as rows 0 .. ncells_eval - 1 of its output. The slot grid stays the
// whole grid, so a window reads the cells beyond the slice's edges. A cell
// runs exactly as it does in a launch over every cell, so its output is
// bit for bit the same.
//
// What bounds it: FP32 work on the live pairs only, about 18 flops and one
// rsqrt a pair in 2-D and 23 in 3-D (dz, its square and add, w * dz and
// its add): 151,273,380 live pairs at the 2-D N = 1M scene (levels 8, S 40,
// ci 32), 0.04 ms at 67 TFLOP/s; a 3-D window has 27 cells, so the 3-D
// N = 1M scene (levels 5, S 80, ci 64) has about six times the pairs. No wgmma: the distance is computed subtract-first,
// as nbodyax does, because the GEMM expansion |p_i|^2 + |p_j|^2 - 2 p_i.p_j
// rounds differently and moves overlap decisions, which are part of the
// result. So the work is the CUDA cores' instruction rate, and the design
// spends it on live pairs and keeps every lane busy:
//
// - One warp a cell, four cells a block. The window is the (2 ring + 1)
//   rows (2-D; (2 ring + 1)^2 rows over y and z in 3-D) of (2 ring + 1)
//   cells along x around the cell, clipped to the grid (no x-wrap:
//   out-of-grid cells are never read); the cells of one row are adjacent
//   in the slot grid, so a row is one contiguous run of slots.
// - Live partners only. The warp reads the runs 32 slots at a time, a slot
//   a lane with 8- or 16-byte loads (4-byte ones for the 7-float rows of
//   3-D, which are only 4-byte aligned), and compacts the slots with
//   mass > 0 (__ballot_sync, __popc prefix) into a staging buffer in shared
//   memory: x, y, m, r as a float4, the id as an int (unpacked once a
//   partner, at staging), the velocity as a float2 in elastic mode; in 3-D
//   x, y, z, m as a float4, r and the id as a word each, the velocity as
//   three words (6 words a partner, 9 in elastic mode). The buffer holds
//   `cap` partners (the wrapper's near_plan: the window rounded up to 32,
//   at most 256), so shared memory is fixed whatever S and ring are; when
//   the next 32 slots might not fit, or the window ends, the warp computes
//   on it. A window that fit whole stays staged for the cell's next part
//   of i slots (rare in 3-D, whose window of 27 S slots refills the
//   buffer several times a cell). (Loading four batches at once, to have more loads in
//   flight, was measured slower: 72-95 registers cut the warps an SM
//   holds, and the kernel is bound by instruction throughput, not by
//   latency.)
// - Full lanes. The cell's live i slots are compacted the same way (dead
//   bodies may sit between live ones, so they need not be a prefix): n_i
//   of them in each group of 32 slots (ci > 32 loops over such groups).
//   They go through the window in one part, or in two when n_i = p + q
//   with p a power of two and q <= p / 2 (20 = 16 + 4: 32 lanes carry 16
//   and then 4 slots, instead of 20 slots on 32 lanes with 12 idle). A
//   part of n slots gives each k = 32 / next_pow2(n) lanes, and lane
//   `share` of the k takes staged partners share, share + k, ... The k
//   partials are folded by __shfl_xor_sync in a fixed order: the force
//   Kahan-combined, gained mass and radius and the elastic dv added, died
//   or-ed, the momentum best by larger mass and then lower id.
// - Cheap pairs: the force is summed plainly over up to 32 partners and
//   the sub-sum Kahan-added into the lane's total; rsqrt is the SFU's own
//   (rsqrt_sfu), whose cube equals rsqrtf's wherever rsqrtf's is finite.
//   No atomics: every call repeats bit for bit.
//
// Rounding: d2, rsum^2 and v.p are computed with __fmul_rn / __fadd_rn,
// summed left to right over x, y, z as the plain version sums them, which
// nvcc never contracts into FMAs (a contracted d2 flipped overlap tests in
// the all-pairs kernel). Every 3-D term sits in an `if constexpr (DIM ==
// 3)` beside the unchanged 2-D expression, so the 2-D instantiations keep
// their arithmetic bit for bit. The elastic coefficient keeps rsqrtf,
// whose square can stay finite for a denormal argument.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kCh = 8;
constexpr int kSub = 32;      // partners a lane sums plainly before a Kahan add
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kReference = 0, kMomentum = 1, kElastic = 2, kNone = 3 };

__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = __fsub_rn(x, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

// rsqrt on the SFU without rsqrtf's rescaling of denormal inputs: only a
// denormal input differs (+inf against about 1e19 or more), and the force
// cubes it, which is +inf either way.
__device__ __forceinline__ float rsqrt_sfu(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int unpack_id(float hi, float lo) {
  return static_cast<int>(hi) * 4096 + static_cast<int>(lo);
}

// One slot row of L floats: L = 8 by two 16-byte loads, L = 6 or 10 by
// 8-byte loads, L = 7 by 4-byte loads; the rows are aligned to that size.
template <int L>
__device__ __forceinline__ void load_slot(const float* f, float (&r)[L]) {
  if constexpr (L % 2 != 0) {
#pragma unroll
    for (int k = 0; k < L; ++k) r[k] = f[k];
  } else if constexpr (L == 8) {
    const float4 a = reinterpret_cast<const float4*>(f)[0];
    const float4 b = reinterpret_cast<const float4*>(f)[1];
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
  } else {
    const float2* q = reinterpret_cast<const float2*>(f);
#pragma unroll
    for (int k = 0; k < L / 2; ++k) {
      const float2 v = q[k];
      r[2 * k] = v.x;
      r[2 * k + 1] = v.y;
    }
  }
}

// Words (4 bytes) of a warp's staging buffer: in 2-D a float4 and an int a
// partner and a float2 more with velocities (5 or 7), in 3-D a float4, the
// radius and the id and three words more with velocities (6 or 9), and 32
// ints of compacted i lanes.
__host__ __device__ constexpr int warp_words(bool vel, int cap, int dim) {
  return cap * (dim == 3 ? (vel ? 9 : 6) : (vel ? 7 : 5)) + 32;
}

// 2-D: at most 64 registers (8 blocks, 32 warps an SM): measured 3.5%
// faster at the 1M scene than the 63-72 registers the compiler picks alone.
// 3-D carries one more coordinate, force sum and dv component and a longer
// row, so it gets more registers: 6 blocks an SM (80 registers), and 5 (96)
// in elastic mode, which also carries the velocities. Measured at the
// uniform 3-D N = 1M state with 4, 5, 6 and 8 blocks an SM: reference mode
// 1.81, 1.81, 1.69 and 1.82 ms, elastic mode 2.57, 2.38, 2.79 and 2.92 ms.
__host__ __device__ constexpr int blocks_per_sm(int mode, int dim) {
  return dim == 3 ? (mode == kElastic ? 5 : 6) : 8;
}

template <int MODE, bool EPS_POS, int DIM>
__global__ void __launch_bounds__(kWarps * 32, blocks_per_sm(MODE, DIM))
near_kernel(const float* __restrict__ grid, int g, int ring, int S, int ci,
            int cap, float eps2, float growth, long long cell_base,
            long long ncells_eval, float* __restrict__ out) {
  constexpr bool kVel = MODE == kElastic;
  constexpr int L = DIM + 4 + (kVel ? DIM : 0);
  constexpr int rest = kVel ? 2 * DIM : DIM;   // lane of the mass
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= ncells_eval) return;      // the whole warp leaves together
  const long long cell = cell_base + row;
  const int cx = static_cast<int>(cell % g);
  const int cyz = static_cast<int>(cell / g);
  const int cy = DIM == 3 ? cyz % g : cyz;
  const int cz = DIM == 3 ? cyz / g : 0;
  const unsigned below = (1u << lane) - 1u;

  float* wbuf =
      reinterpret_cast<float*>(smem) + warp * warp_words(kVel, cap, DIM);
  // 2-D: x y m r; 3-D: x y z m, with the radius in sr
  float4* sp = reinterpret_cast<float4*>(wbuf);
  float2* sv = reinterpret_cast<float2*>(wbuf + 4 * cap);      // 2-D vx vy
  float* sr = wbuf + 4 * cap;                                   // 3-D radius
  float* sv3 = wbuf + 5 * cap;              // 3-D vx[cap] vy[cap] vz[cap]
  int* sid = reinterpret_cast<int*>(
      wbuf + (DIM == 3 ? (kVel ? 8 : 5) : (kVel ? 6 : 4)) * cap);
  int* ilane = sid + cap;

  const float* cbase = grid + cell * S * L;
  const int x0 = max(cx - ring, 0);
  const int x1 = min(cx + ring, g - 1);
  const int run = (x1 - x0 + 1) * S;   // slots of one window row
  // the window's rows: y in [y0, y1] and, in 3-D, z in [z0, z1]
  const int y0 = max(cy - ring, 0);
  const int y1 = min(cy + ring, g - 1);
  const int z0 = DIM == 3 ? max(cz - ring, 0) : 0;
  const int z1 = DIM == 3 ? min(cz + ring, g - 1) : 0;

  int count = 0;         // staged partners, warp-uniform
  bool whole = false;    // the buffer holds the whole window's partners

  for (int i0 = 0; i0 < ci; i0 += 32) {
    // this group's i slots, a lane each
    const int islot = i0 + lane;
    const bool has = islot < ci;
    float r[L];
#pragma unroll
    for (int k = 0; k < L; ++k) r[k] = 0.f;
    if (has) load_slot<L>(cbase + static_cast<long long>(islot) * L, r);
    const bool live = has && r[rest] > 0.f;
    const int own_id = unpack_id(r[rest + 2], r[rest + 3]);
    if (has && !live) {                // pad or dead: the "none" outputs
      float4* o = reinterpret_cast<float4*>(out + (row * ci + islot) * kCh);
      const float hi = static_cast<float>(own_id >> 12);
      const float lo = static_cast<float>(own_id & 0xFFF);
      if constexpr (MODE != kMomentum) {
        o[0] = make_float4(0.f, 0.f, 0.f, 0.f);
        o[1] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if constexpr (DIM == 3) {
        o[0] = make_float4(0.f, 0.f, 0.f, -INFINITY);
        o[1] = make_float4(hi, lo, 0.f, 0.f);
      } else {
        o[0] = make_float4(0.f, 0.f, -INFINITY, hi);
        o[1] = make_float4(lo, 0.f, 0.f, 0.f);
      }
    }
    const unsigned imask = __ballot_sync(kFull, live);
    if (imask == 0u) continue;         // warp-uniform
    const int ni = __popc(imask);
    __syncwarp();                      // earlier readers of ilane are done
    if (live) ilane[__popc(imask & below)] = lane;
    __syncwarp();

    // The ni live slots in one or two parts, each of a power of two of
    // slots or fewer with k = 32 / next_pow2(size) lanes a slot: ni = p + q
    // with p the largest power of two <= ni splits when next_pow2(q) < p
    // (q <= p / 2), which spends 32 lanes on p + next_pow2(q) slots
    // instead of 2p.
    const int top = 1 << (31 - __clz(ni));
    const int rem = ni - top;
    const bool split = rem > 0 && 2 * rem <= top;
    for (int part = 0; part < (split ? 2 : 1); ++part) {
      const int j0 = part ? top : 0;
      const int nj = split ? (part ? rem : top) : ni;
      const int klog = 5 - (32 - __clz(nj - 1));
      const int k = 1 << klog;
      const int jj = lane >> klog;
      const int share = lane & (k - 1);
      const bool act = jj < nj;
      const int src = act ? ilane[j0 + jj] : lane;
      const float xi = __shfl_sync(kFull, r[0], src);
      const float yi = __shfl_sync(kFull, r[1], src);
      float zi = 0.f;
      if constexpr (DIM == 3) zi = __shfl_sync(kFull, r[2], src);
      const float mi = __shfl_sync(kFull, r[rest], src);
      const float ri = __shfl_sync(kFull, r[rest + 1], src);
      const int idi = __shfl_sync(kFull, own_id, src);
      float vxi = 0.f, vyi = 0.f, vzi = 0.f;
      if constexpr (kVel) {
        vxi = __shfl_sync(kFull, r[DIM], src);
        vyi = __shfl_sync(kFull, r[DIM + 1], src);
        if constexpr (DIM == 3) vzi = __shfl_sync(kFull, r[DIM + 2], src);
      }

      float fx = 0.f, fy = 0.f, kx = 0.f, ky = 0.f;  // force, compensation
      float fz = 0.f, kz = 0.f;                      // 3-D only
      // the mode's summed channels: reference gained mass, gained radius,
      // died; elastic dv x, y and (3-D) z in c2, c3, c4
      float c2 = 0.f, c3 = 0.f, c4 = 0.f;
      float best = -INFINITY;
      int best_id = idi;

      // the pairs of this lane's share of staged partners [0, n)
      auto compute = [&](int n) {
        __syncwarp();                  // the staged rows are visible
        if (act) {
          for (int t0 = share; t0 < n; t0 += k * kSub) {
            const int t1 = min(n, t0 + k * kSub);
            float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll 4
            for (int t = t0; t < t1; t += k) {
              const float4 p = sp[t];
              const int idj = sid[t];
              float mj, rj, dz = 0.f;
              if constexpr (DIM == 3) {
                mj = p.w;
                rj = sr[t];
              } else {
                mj = p.z;
                rj = p.w;
              }
              const float dx = __fsub_rn(p.x, xi);
              const float dy = __fsub_rn(p.y, yi);
              float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
              if constexpr (DIM == 3) {
                dz = __fsub_rn(p.z, zi);
                d2 = __fadd_rn(d2, __fmul_rn(dz, dz));
              }
              const float rsum = __fadd_rn(ri, rj);
              const bool valid = idj != idi;
              const bool touch = d2 <= __fmul_rn(rsum, rsum);
              const bool overlap = valid && touch;
              const bool fmask = kVel ? valid : (valid && !touch);
              const float d2e = __fadd_rn(d2, eps2);
              const float inv = rsqrt_sfu(d2e);
              const float wm = mj * (inv * inv * inv);
              const float w =
                  (EPS_POS ? fmask : (fmask && d2e > 0.f)) ? wm : 0.f;
              sx += w * dx;
              sy += w * dy;
              if constexpr (DIM == 3) sz += w * dz;
              if constexpr (MODE == kReference) {
                if (overlap) {
                  if (mi >= mj) {
                    c2 += mj;
                    c3 += __fmul_rn(rj, growth);
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
                float vdotp;
                if constexpr (DIM == 3) {
                  vdotp = __fadd_rn(
                      __fadd_rn(__fmul_rn(__fsub_rn(sv3[t], vxi), dx),
                                __fmul_rn(__fsub_rn(sv3[cap + t], vyi), dy)),
                      __fmul_rn(__fsub_rn(sv3[2 * cap + t], vzi), dz));
                } else {
                  const float2 v = sv[t];
                  vdotp = __fadd_rn(__fmul_rn(__fsub_rn(v.x, vxi), dx),
                                    __fmul_rn(__fsub_rn(v.y, vyi), dy));
                }
                if (overlap && vdotp < 0.f && d2 > 0.f) {
                  const float rs = rsqrtf(__fmul_rn(__fadd_rn(mi, mj), d2));
                  const float coef = 2.f * vdotp * (rs * rs) * mj;
                  c2 += coef * dx;
                  c3 += coef * dy;
                  if constexpr (DIM == 3) c4 += coef * dz;
                }
              }
            }
            kahan_add(fx, kx, sx);
            kahan_add(fy, ky, sy);
            if constexpr (DIM == 3) kahan_add(fz, kz, sz);
          }
        }
        __syncwarp();                  // done reading before restaging
      };

      if (whole) {
        compute(count);                // the window is staged already
      } else {
        // stage the window's live partners, computing whenever the next
        // batch of slots might not fit
        count = 0;
        whole = true;
        for (int wz = z0; wz <= z1; ++wz) {
          for (int wy = y0; wy <= y1; ++wy) {
            const float* wrow =
                grid + ((static_cast<long long>(wz) * g + wy) * g + x0) * S * L;
            for (int p0 = 0; p0 < run; p0 += 32) {
              if (count + min(32, run - p0) > cap) {
                compute(count);
                count = 0;
                whole = false;
              }
              const int p = p0 + lane;
              float q[L];
              bool lv = false;
              if (p < run) {
                load_slot<L>(wrow + static_cast<long long>(p) * L, q);
                lv = q[rest] > 0.f;
              }
              const unsigned m = __ballot_sync(kFull, lv);
              if (lv) {
                const int at = count + __popc(m & below);
                sid[at] = unpack_id(q[rest + 2], q[rest + 3]);
                if constexpr (DIM == 3) {
                  sp[at] = make_float4(q[0], q[1], q[2], q[rest]);
                  sr[at] = q[rest + 1];
                  if constexpr (kVel) {
                    sv3[at] = q[3];
                    sv3[cap + at] = q[4];
                    sv3[2 * cap + at] = q[5];
                  }
                } else {
                  sp[at] = make_float4(q[0], q[1], q[rest], q[rest + 1]);
                  if constexpr (kVel) sv[at] = make_float2(q[2], q[3]);
                }
              }
              count += __popc(m);
            }
          }
        }
        if (count > 0) compute(count);
      }

      // fold the k shares of each i slot, in a fixed order
      for (int off = k >> 1; off > 0; off >>= 1) {
        const float ofx = __shfl_xor_sync(kFull, fx, off);
        const float okx = __shfl_xor_sync(kFull, kx, off);
        const float ofy = __shfl_xor_sync(kFull, fy, off);
        const float oky = __shfl_xor_sync(kFull, ky, off);
        kahan_add(fx, kx, ofx);
        kahan_add(fx, kx, -okx);
        kahan_add(fy, ky, ofy);
        kahan_add(fy, ky, -oky);
        if constexpr (DIM == 3) {
          const float ofz = __shfl_xor_sync(kFull, fz, off);
          const float okz = __shfl_xor_sync(kFull, kz, off);
          kahan_add(fz, kz, ofz);
          kahan_add(fz, kz, -okz);
        }
        if constexpr (MODE == kReference) {
          c2 = __fadd_rn(c2, __shfl_xor_sync(kFull, c2, off));
          c3 = __fadd_rn(c3, __shfl_xor_sync(kFull, c3, off));
          c4 = fmaxf(c4, __shfl_xor_sync(kFull, c4, off));
        } else if constexpr (MODE == kMomentum) {
          const float ob = __shfl_xor_sync(kFull, best, off);
          const int oid = __shfl_xor_sync(kFull, best_id, off);
          if (ob > best || (ob == best && oid < best_id)) {
            best = ob;
            best_id = oid;
          }
        } else if constexpr (MODE == kElastic) {
          c2 = __fadd_rn(c2, __shfl_xor_sync(kFull, c2, off));
          c3 = __fadd_rn(c3, __shfl_xor_sync(kFull, c3, off));
          if constexpr (DIM == 3)
            c4 = __fadd_rn(c4, __shfl_xor_sync(kFull, c4, off));
        }
      }

      if (act && share == 0) {
        const int slot = i0 + ilane[j0 + jj];
        float4* o = reinterpret_cast<float4*>(out + (row * ci + slot) * kCh);
        const float hi = static_cast<float>(best_id >> 12);
        const float lo = static_cast<float>(best_id & 0xFFF);
        if constexpr (DIM == 3) {
          if constexpr (MODE == kMomentum) {
            o[0] = make_float4(fx, fy, fz, best);
            o[1] = make_float4(hi, lo, 0.f, 0.f);
          } else {
            o[0] = make_float4(fx, fy, fz, c2);
            o[1] = make_float4(c3, c4, 0.f, 0.f);
          }
        } else if constexpr (MODE == kMomentum) {
          o[0] = make_float4(fx, fy, best, hi);
          o[1] = make_float4(lo, 0.f, 0.f, 0.f);
        } else {
          o[0] = make_float4(fx, fy, c2, c3);
          o[1] = make_float4(c4, 0.f, 0.f, 0.f);
        }
      }
    }
  }
}

template <int MODE, int DIM>
int launch(const float* grid, int g, int ring, int S, int ci, int cap,
           float eps2, float growth, long long cell_base,
           long long ncells_eval, float* out, cudaStream_t stream) {
  const int blocks = static_cast<int>((ncells_eval + kWarps - 1) / kWarps);
  const size_t smem = static_cast<size_t>(kWarps) *
                      warp_words(MODE == kElastic, cap, DIM) * 4;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (eps2 > 0.f) {
    near_kernel<MODE, true, DIM><<<blocks, kWarps * 32, smem, stream>>>(
        grid, g, ring, S, ci, cap, eps2, growth, cell_base, ncells_eval,
        out);
  } else {
    near_kernel<MODE, false, DIM><<<blocks, kWarps * 32, smem, stream>>>(
        grid, g, ring, S, ci, cap, eps2, growth, cell_base, ncells_eval,
        out);
  }
  return 0;
}

template <int DIM>
int launch_mode(int mode, const float* grid, int g, int ring, int S, int ci,
                int cap, float eps2, float growth, long long cell_base,
                long long ncells_eval, float* out, cudaStream_t s) {
  switch (mode) {
    case kReference:
      return launch<kReference, DIM>(grid, g, ring, S, ci, cap, eps2, growth,
                                     cell_base, ncells_eval, out, s);
    case kMomentum:
      return launch<kMomentum, DIM>(grid, g, ring, S, ci, cap, eps2, growth,
                                     cell_base, ncells_eval, out, s);
    case kElastic:
      return launch<kElastic, DIM>(grid, g, ring, S, ci, cap, eps2, growth,
                                     cell_base, ncells_eval, out, s);
    default:
      return launch<kNone, DIM>(grid, g, ring, S, ci, cap, eps2, growth,
                                cell_base, ncells_eval, out, s);
  }
}

}  // namespace

// Shared bytes a block of B3 takes in `mode` and `dim` dimensions with a
// staging capacity of `cap` partners a warp; the wrapper's near_plan
// computes the same.
extern "C" int nbodyax_near_shared_bytes(int mode, int cap, int dim) {
  return kWarps * warp_words(mode == kElastic, cap, dim) * 4;
}

// Plain C entry point for ctypes. `dim` is 2 or 3; `cap` (a multiple of
// 32, at least 32) is the staging capacity from the wrapper's near_plan.
// The launch evaluates the cells [cell_base, cell_base + ncells_eval) of
// the grid into `out` f32[ncells_eval, ci, 8]; ncells_eval = 0 means
// every cell (then cell_base must be 0). Returns cudaGetLastError() after
// the launch (0 on success); an unknown mode or dim, a row width other
// than the mode's (dim + 4, or 2 dim + 4 in elastic mode), ci > S, a bad
// capacity or a slice that leaves the grid returns cudaErrorInvalidValue.
extern "C" int nbodyax_slots_near(const float* grid, int g, int ring, int S,
                                  int ci, int L, int cap, int mode, int dim,
                                  float eps2, float growth,
                                  long long cell_base, long long ncells_eval,
                                  float* out, void* stream) {
  const long long ncells =
      static_cast<long long>(g) * g * (dim == 3 ? g : 1);
  if (ncells_eval == 0) ncells_eval = ncells;
  if (mode < kReference || mode > kNone || (dim != 2 && dim != 3) ||
      L != (mode == kElastic ? 2 * dim : dim) + 4 || ci > S || cap < 32 ||
      cap % 32 != 0 || cell_base < 0 || ncells_eval < 0 ||
      cell_base + ncells_eval > ncells) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (ncells_eval > 0) {
    err = dim == 3 ? launch_mode<3>(mode, grid, g, ring, S, ci, cap, eps2,
                                    growth, cell_base, ncells_eval, out, s)
                   : launch_mode<2>(mode, grid, g, ring, S, ci, cap, eps2,
                                    growth, cell_base, ncells_eval, out, s);
  }
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}
