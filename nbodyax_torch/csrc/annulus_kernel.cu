// The exact-target annulus of forceModel=bh's FMM far field, for one NVIDIA
// Hopper card.
//
// Replaces no TPU kernel: nbodyax computes the annulus in jnp
// (nbodyax/physics/barneshut.py::_annulus_force_cells), and the port's
// plain version, fmm._annulus_force_cells, is whole-tensor torch. That
// plain version builds [cells, slots, shell cells] temporaries and streams
// them through device memory once per elementwise op of the order-2
// formula: about 161 kernels over 100-MB temporaries a chunk of cells, 85%
// of the 3-D million-body step's device time. This kernel keeps every
// intermediate in registers.
//
// What it computes. The finest grid of side g in DIM = 2 or 3 dimensions
// (flat cell c = (z * g + y) * g + x, x fastest) carries each cell's
// order-2 moments about its centre, packed[ncells, NM]: m, m r_a, then
// m r_a r_b for a <= b (NM = 6 in 2-D, 10 in 3-D). A cell's shell is the
// cells at offsets w_near < |delta|_inf <= w_far, in the order of
// fmm._annulus_offsets (the first axis slowest), clipped to the grid. For
// each of a cell's first ci cell-sorted bodies (its slots) the kernel sums
// the monopole and quadrupole force of every shell cell of mass > 0, with
// fmm._far_window_force's order-2 formula:
//
//   M, com = centre + S1 / M, q_ab = S2_ab - (S1_a / M) S1_b, tr = sum q_aa
//   d = com - p, d2 = |d|^2 + eps2, inv = rsqrt(d2)
//   f = M inv^3 d + [-1.5 (2 u + d tr inv^5) + 7.5 (d.u inv^2) d]
//   with u_a = (sum_b q_ab d_b) inv^5
//
// Every product and sum is the plain version's float32 operation in the
// plain version's order (__fmul_rn / __fadd_rn / __fsub_rn: never
// contracted into FMAs; IEEE division; rsqrtf as torch.rsqrt on the card),
// so a shell cell's term is the plain version's bit for bit; only the sum
// over shell cells runs in another order (here: shell order, one after
// another), so the force differs by float32 reordering alone. Output, for
// the cells [cell_first, cell_first + ncells_eval) as rows 0 ..
// ncells_eval - 1: force[ncells_eval * ci, DIM] and the slot's body id
// ids[ncells_eval * ci] (int64, hi * 4096 + lo from the row's last two
// lanes; n for a slot past the cell's count, whose force is 0, where the
// plain version computes a value no consumer reads). A slot's result
// depends only on its cell, so cell slices tile the full launch bit for
// bit; no atomics, so two launches on the same input are bitwise equal.
//
// The slot rows: the slot grid f32[ncells, S, L] (S > 0; row (c, j) at
// (c S + j) L) or the cell-sorted pack sf[n + 1, L] (S = 0; row
// starts[c] + j). A row is pos[DIM], [vel[DIM]], mass, radius, id hi, id lo.
//
// What bounds it: FP32 issue. A live slot against a shell cell of mass is
// 67 float32 operations in 3-D (43 in 2-D) and one rsqrt, none of them
// fused; at the 3-D million-body scene (levels 5, ci 64, ring 1: 98 shell
// cells, fewer at the grid's faces) 9.0e7 such pairs, 6.1e9 flops, 0.09 ms
// at 67 TFLOP/s. The bytes are the slot positions (under 60 MB) and the
// moment grid, which L2 holds.
//
// Design.
//
// - A block of 128 threads takes cpb consecutive cells (the wrapper's
//   annulus_plan chooses them; the launch refuses a block whose shells
//   pass 48 KB of shared memory, shared_bytes). One warp a cell stages the
//   cell's shell in shared memory: lanes walk the (2 w_far + 1)^DIM cube
//   32 offsets at a time, drop the inner block, the cells off the grid and
//   the empty ones, and compact the rest in shell order (__ballot_sync,
//   __popc prefix). Each staged cell holds what the formula needs of it
//   alone, computed once: com, M, q, tr (8 floats in 2-D, 12 in 3-D, as
//   float4s).
// - Live slots only: the block's slots below their cells' counts are
//   numbered across its cells and dealt to its threads, so a cell's empty
//   slots (about half of them under the auto slot budget of twice the mean
//   occupancy) take no lanes; the empty slots get their 0 and n in a
//   separate write loop. Threads of one cell read the same staged entry
//   at a time (a broadcast), sum the force in registers, and write DIM
//   floats and an id once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// float4s a staged shell cell
template <int DIM>
constexpr int kVecs = DIM == 3 ? 3 : 2;

// One shell cell's values (fmm._far_window_force's per-cell part): row is
// its moments, w its coordinates. 2-D: (com_x, com_y, M, tr), (q00, q01,
// q11, 0); 3-D: (com_x, com_y, com_z, M), (q00, q01, q02, q11),
// (q12, q22, tr, 0).
template <int DIM>
__device__ __forceinline__ void stage_cell(const float* row, const int* w,
                                           const float* mins,
                                           const float* csz, float4* out) {
  const float M = row[0];
  const float minv = __fdiv_rn(1.0f, M);
  float com[DIM], rb[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    const float centre = add(mins[d], mul(add(__int2float_rn(w[d]), 0.5f),
                                          csz[d]));
    com[d] = add(centre, mul(row[1 + d], minv));
    rb[d] = mul(row[1 + d], minv);
  }
  float q[DIM * (DIM + 1) / 2];
  int k = 0;
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
#pragma unroll
    for (int b = a; b < DIM; ++b, ++k) {
      q[k] = sub(row[1 + DIM + k], mul(rb[a], row[1 + b]));
    }
  }
  if constexpr (DIM == 3) {
    const float tr = add(add(q[0], q[3]), q[5]);
    out[0] = make_float4(com[0], com[1], com[2], M);
    out[1] = make_float4(q[0], q[1], q[2], q[3]);
    out[2] = make_float4(q[4], q[5], tr, 0.0f);
  } else {
    const float tr = add(q[0], q[2]);
    out[0] = make_float4(com[0], com[1], M, tr);
    out[1] = make_float4(q[0], q[1], q[2], 0.0f);
  }
}

// One shell cell's force on the target p, added to acc in shell order.
template <int DIM>
__device__ __forceinline__ void add_force(const float4* e, const float* p,
                                          float eps2, float* acc) {
  const float4 A = e[0], B = e[1];
  float d[DIM], u[DIM], M, tr;
  if constexpr (DIM == 3) {
    M = A.w;
    tr = e[2].z;
    d[2] = sub(A.z, p[2]);
  } else {
    M = A.z;
    tr = A.w;
  }
  d[0] = sub(A.x, p[0]);
  d[1] = sub(A.y, p[1]);
  float d2 = mul(d[0], d[0]);
#pragma unroll
  for (int a = 1; a < DIM; ++a) d2 = add(d2, mul(d[a], d[a]));
  d2 = add(d2, eps2);
  const float inv = rsqrtf(d2);
  const float inv2 = mul(inv, inv);
  const float inv3 = mul(inv2, inv);
  const float wgt = mul(M, inv3);
  const float inv5 = mul(inv3, inv2);
  if constexpr (DIM == 3) {
    // q rows: (q00 q01 q02), (q01 q11 q12), (q02 q12 q22)
    const float4 C = e[2];
    u[0] = mul(add(add(mul(B.x, d[0]), mul(B.y, d[1])), mul(B.z, d[2])),
               inv5);
    u[1] = mul(add(add(mul(B.y, d[0]), mul(B.w, d[1])), mul(C.x, d[2])),
               inv5);
    u[2] = mul(add(add(mul(B.z, d[0]), mul(C.x, d[1])), mul(C.y, d[2])),
               inv5);
  } else {
    // q rows: (q00 q01), (q01 q11)
    u[0] = mul(add(mul(B.x, d[0]), mul(B.y, d[1])), inv5);
    u[1] = mul(add(mul(B.y, d[0]), mul(B.z, d[1])), inv5);
  }
  const float tr5 = mul(tr, inv5);
  float dud = mul(d[0], u[0]);
#pragma unroll
  for (int a = 1; a < DIM; ++a) dud = add(dud, mul(d[a], u[a]));
  const float t7 = mul(7.5f, mul(dud, inv2));
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    const float quad = add(mul(-1.5f, add(mul(2.0f, u[a]), mul(d[a], tr5))),
                           mul(t7, d[a]));
    acc[a] = add(acc[a], add(mul(wgt, d[a]), quad));
  }
}

template <int DIM>
__global__ void __launch_bounds__(kThreads) annulus_kernel(
    const float* __restrict__ packed, const float* __restrict__ geom,
    const float* __restrict__ rows, int L, int S,
    const long long* __restrict__ starts, const long long* __restrict__ ends,
    int g, int w_near, int w_far, int K, int ci, long long n, int cell_first,
    int ncells_eval, int cpb, float eps2, float* __restrict__ force,
    long long* __restrict__ ids) {
  constexpr int NM = DIM == 3 ? 10 : 6;
  constexpr int NV = kVecs<DIM>;
  // [cpb, K, NV] staged cells, then each cell's first row, shell and live
  // counts (shared_bytes)
  extern __shared__ float4 stage[];
  long long* first_row =
      reinterpret_cast<long long*>(stage + static_cast<long long>(cpb) * K
                                               * NV);
  int* nshell = reinterpret_cast<int*>(first_row + cpb);
  int* nlive = nshell + cpb;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c_block = cell_first + blockIdx.x * cpb;
  const int c_end = cell_first + ncells_eval;
  float mins[DIM], csz[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    mins[d] = geom[d];
    csz[d] = geom[DIM + d];
  }

  // stage each cell's shell: one warp a cell, 32 cube offsets at a time
  const int side = 2 * w_far + 1;
  int cube = side;
#pragma unroll
  for (int d = 1; d < DIM; ++d) cube *= side;
  for (int s = warp; s < cpb; s += kWarps) {
    const int c = c_block + s;
    int count = 0;
    if (c < c_end) {
      int cc[DIM];
      int rem = c;
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        cc[d] = rem % g;
        rem /= g;
      }
      for (int i0 = 0; i0 < cube; i0 += 32) {
        const int i = i0 + lane;
        bool has = false;
        float4 v[NV];
        if (i < cube) {
          int w[DIM];
          bool inner = true, inside = true;
          int r = i;
#pragma unroll
          for (int d = DIM - 1; d >= 0; --d) {     // the first axis slowest
            const int o = r % side - w_far;
            r /= side;
            inner = inner && abs(o) <= w_near;
            w[d] = cc[d] + o;
            inside = inside && w[d] >= 0 && w[d] < g;
          }
          if (!inner && inside) {
            long long flat = w[DIM - 1];
#pragma unroll
            for (int d = DIM - 2; d >= 0; --d) flat = flat * g + w[d];
            const float* row = packed + flat * NM;
            if (row[0] > 0.0f) {
              has = true;
              stage_cell<DIM>(row, w, mins, csz, v);
            }
          }
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, has);
        if (has) {
          const int at = count + __popc(ballot & ((1u << lane) - 1u));
          float4* dst = stage + (static_cast<long long>(s) * K + at) * NV;
#pragma unroll
          for (int k = 0; k < NV; ++k) dst[k] = v[k];
        }
        count += __popc(ballot);
      }
    }
    if (lane == 0) {
      nshell[s] = count;
      if (c < c_end) {
        const long long st = starts[c];
        const long long live = ends[c] - st;
        nlive[s] = static_cast<int>(live < ci ? live : ci);
        first_row[s] = st;
      } else {
        nlive[s] = 0;
      }
    }
  }
  __syncthreads();

  // the block's live slots, numbered across its cells
  int total = 0;
  for (int s = 0; s < cpb; ++s) total += nlive[s];
  for (int f = threadIdx.x; f < total; f += kThreads) {
    int s = 0, j = f;
    while (j >= nlive[s]) {
      j -= nlive[s];
      ++s;
    }
    const int c = c_block + s;
    const float* row =
        rows + (S > 0 ? static_cast<long long>(c) * S + j : first_row[s] + j)
                   * L;
    float p[DIM], acc[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      p[d] = row[d];
      acc[d] = 0.0f;
    }
    const float4* sh = stage + static_cast<long long>(s) * K * NV;
    const int ne = nshell[s];
#pragma unroll 2
    for (int e = 0; e < ne; ++e) add_force<DIM>(sh + e * NV, p, eps2, acc);
    const long long slot = static_cast<long long>(c - cell_first) * ci + j;
#pragma unroll
    for (int d = 0; d < DIM; ++d) force[slot * DIM + d] = acc[d];
    ids[slot] = static_cast<long long>(row[L - 2]) * 4096
                + static_cast<long long>(row[L - 1]);
  }

  // the empty slots: force 0, id n
  for (int f = threadIdx.x; f < cpb * ci; f += kThreads) {
    const int s = f / ci, j = f - s * ci;
    if (c_block + s < c_end && j >= nlive[s]) {
      const long long slot =
          static_cast<long long>(c_block + s - cell_first) * ci + j;
#pragma unroll
      for (int d = 0; d < DIM; ++d) force[slot * DIM + d] = 0.0f;
      ids[slot] = n;
    }
  }
}

// The shell's offset count: the (2 w_far + 1)^DIM cube less the
// (2 w_near + 1)^DIM inner block.
template <int DIM>
int shell_cells(int w_near, int w_far) {
  int cube = 1, inner = 1;
  for (int d = 0; d < DIM; ++d) {
    cube *= 2 * w_far + 1;
    inner *= 2 * w_near + 1;
  }
  return cube - inner;
}

// A block's dynamic shared memory: the staged shells and, per cell, its
// first row and two counts. The launch refuses more than 48 KB (no opt-in).
template <int DIM>
size_t shared_bytes(int cpb, int K) {
  return static_cast<size_t>(cpb)
         * (static_cast<size_t>(K) * kVecs<DIM> * sizeof(float4)
            + sizeof(long long) + 2 * sizeof(int));
}

template <int DIM>
int launch(const float* packed, const float* geom, const float* rows, int L,
           int S, const long long* starts, const long long* ends, int g,
           int w_near, int w_far, int ci, long long n, int cell_first,
           int ncells_eval, int cpb, float eps2, float* force,
           long long* ids, cudaStream_t stream) {
  if (cpb < 1 || w_near < 0 || w_far <= w_near) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int K = shell_cells<DIM>(w_near, w_far);
  const int blocks = (ncells_eval + cpb - 1) / cpb;
  annulus_kernel<DIM><<<blocks, kThreads, shared_bytes<DIM>(cpb, K),
                        stream>>>(
      packed, geom, rows, L, S, starts, ends, g, w_near, w_far, K, ci, n,
      cell_first, ncells_eval, cpb, eps2, force, ids);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The annulus force and ids of the cells [cell_first, cell_first +
// ncells_eval) of a grid of side g in dim = 2 or 3 dimensions. packed:
// f32[g^dim, 6 or 10]; geom: {mins[dim], csz[dim]}; rows: the slot grid
// f32[g^dim, S, L] (S > 0) or the sorted pack f32[n + 1, L] (S = 0); cpb:
// cells a block. Plain C entry point for ctypes; returns cudaGetLastError()
// (cudaErrorInvalidValue for another dim, a bad shell, or a cpb whose
// shells pass 48 KB of shared memory).
extern "C" int nbodyax_annulus_cells(
    const float* packed, const float* geom, const float* rows, int L, int S,
    const long long* starts, const long long* ends, int g, int dim,
    int w_near, int w_far, int ci, long long n, int cell_first,
    int ncells_eval, int cpb, float eps2, float* force, long long* ids,
    void* stream) {
  if (ncells_eval <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    return launch<3>(packed, geom, rows, L, S, starts, ends, g, w_near,
                     w_far, ci, n, cell_first, ncells_eval, cpb, eps2,
                     force, ids, s);
  }
  if (dim == 2) {
    return launch<2>(packed, geom, rows, L, S, starts, ends, g, w_near,
                     w_far, ci, n, cell_first, ncells_eval, cpb, eps2,
                     force, ids, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
