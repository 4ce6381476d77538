// Per-problem fused ADMM iteration for batches of QPs that each carry their
// own scaled KKT inverse, constraint matrix and cost matrix (the MPC fleet on
// per-member clocks, where every member is transcribed and factorized on its
// own).
//
// Replaces the TPU kernel smooth_feedback_tpu/qp/pallas_kernel.py::
// _admm_kernel (called through admm_iterate_pallas).  It computes the same
// function: per problem b, the ADMM loop
//
//     rhs = sigma x - qs + (rho z - y) As      xt = rhs Minv      zt = As xt
//     x   <- alpha xt + (1 - alpha) x
//     z   <- clip(alpha zt + (1 - alpha) z + y / rho, ls, us)
//     y   <- y + rho (alpha zt + (1 - alpha) z - z_new)
//
// with the unscaled-residual stopping check, the primal/dual infeasibility
// certificates and the non-finite test every stop_check_iter-th iteration
// (it % k == 1 % k).  Each problem runs its own loop until it stops or
// reaches max_iter (members still running come back as MaxIterations), so
// its iteration count is exact; a problem whose status0 is not Running does
// not iterate (x0/z0/y0 back, iters 0, pres = dres = inf).
//
// What bounds it on an H100: device memory.  Every problem has its own
// Minv, Ps (n x n) and As (m x n): 277 KB at n = 163, m = 99, and 284 MB for
// a fleet of 1024, more than the 50 MB L2.  The least the card could do is
// read them once (0.085 ms at 3.35 TB/s); the FMAs are about 4 GFLOP for a
// whole solve (0.06 ms at 67 TFLOP/s f32).
//
// Design: one thread block per problem, and the two matrices every iteration
// needs stay on chip.
//
// - Resident route (taken when Minv, As and the vectors fit a block's
//   232,448 bytes of shared memory; 189 KB at n = 163, m = 99): the block
//   copies As, then Minv, into shared memory once with cp.async and runs
//   every iteration from there; iteration 0 starts on As while Minv is still
//   in flight.  Problem b's matrices start at b n n floats, which is not a
//   multiple of 16 bytes in general: each matrix keeps its layout and lands
//   at the same offset modulo 16 bytes as its source, so the body of the
//   copy moves 16 bytes a request and only the ragged head and tail move 4.
//   Ps is needed only at checks and stays in device memory (the block asks
//   for it to be brought into L2 when it starts); a check reads it once for
//   x and dx together, four rows' loads in flight per warp, and As from
//   shared memory.  Device-memory traffic is then the matrices once plus Ps
//   per check, instead of Minv once and As twice on every iteration.
// - Products from shared memory are laid out so that a matrix entry is the
//   only thing a lane reads per FMA (shared memory delivers 128 bytes a
//   clock to the registers, and a broadcast costs as much as any load).
//   Lanes own columns (lane, lane + 32, ...).  v M: warp w sums rows w,
//   w + nwarps, ... into per-lane accumulators, one broadcast of v[r] per
//   row; the warps' partial sums meet in shared memory and are added in warp
//   order.  M v: lanes keep their entries of v in registers, a warp takes
//   four rows at a time and folds their four sums in six shuffles (the same
//   summation tree as a butterfly).  Both walks read consecutive words, so
//   no row stride needs padding, and results are deterministic.  That walk
//   (one pass over Minv and two over As per iteration, 128 bytes a clock) is
//   this design's own floor: 0.2 ms for the path's warm solve if nothing but
//   the matrices were read.  The vector broadcasts, the partial sums and the
//   shuffles go through the same 128 bytes a clock, and a whole iteration
//   (with the z, y update and its barriers) measures 3.7 times that floor;
//   a warm solve of the path's fleet (B = 1024, 22 iterations, 3 checks)
//   takes 1.0130 ms on an H100 80GB HBM3 at 700 W (11.7 times the bound),
//   about 60 % of it iterations, 28 % checks (Ps from device memory) and
//   11 % the copies, which one block an SM does not overlap with the
//   previous problem's iterations (PERF.md).
// - Streaming route (shapes that do not fit, e.g. n = m = 600): the matrices
//   stream from device memory on every iteration, coalesced in both shapes
//   (a warp per output row with a butterfly reduction for M v, a thread per
//   column for v M; Minv is the symmetric inverse L^-T L^-1, so rhs Minv is
//   read row by row).  The launch decides by size alone.
//
// The iterates and the per-row data live in shared memory on both routes.
// No padding of the inputs: n and m are runtime values and the ragged edges
// are loop bounds.  Norms and sums are reduced per warp, then over the block
// from shared memory in a fixed order, so every thread holds bit-identical
// results and the loop control stays block-uniform.  IEEE f32 throughout (no
// fast math): the max propagates NaN like jnp.max, the bounds' +-inf rows
// use finite copies so 0 * inf never appears, and the divergence test relies
// on IEEE inf/NaN.
//
// Plain C interface, loaded with ctypes; the launch uses the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRunning = -1;
constexpr int kOptimal = 0;
constexpr int kPrimalInf = 2;
constexpr int kDualInf = 3;
constexpr int kMaxIter = 4;
constexpr int kUnknown = 6;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 16;  // __launch_bounds__(512)
constexpr int kMaxReduce = 10;  // values reduced over the block at once
constexpr size_t kSmemLimit = 232448;  // what one block may hold on an H100
constexpr size_t kStaticSmem = 4 * kMaxReduce * kMaxWarps;  // red[]

struct Args {
  const float* Minv;  // (B, n, n)
  const float* As;    // (B, m, n)
  const float* Ps;    // (B, n, n)
  const float* rho;   // (B, m)
  const float* sx;    // (B, n)
  const float* sy;    // (B, m)
  const float* c;     // (B,)
  const float* qs;    // (B, n)
  const float* ls;    // (B, m)
  const float* us;    // (B, m)
  const float* l;     // (B, m)
  const float* u;     // (B, m)
  const float* x0;    // (B, n)
  const float* z0;    // (B, m)
  const float* y0;    // (B, m)
  const int* status0; // (B,)
  float* x;
  float* z;
  float* y;
  int* status;
  int* iters;
  float* pres;
  float* dres;
  int B, n, m;
  float alpha, sigma, eps_abs, eps_rel, eps_pinf, eps_dinf;
  int max_iter, stop_check_iter;
};

// max that propagates NaN, like jnp.max / torch.max
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// butterfly reductions: every lane ends with the same value
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nanmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Reduce N values over the block: bit k of sum_mask makes value k a sum,
// else a NaN-propagating max.  Warps reduce first; then every thread
// combines the per-warp results in the same order, so all threads end with
// bit-identical values.  Starts and ends with the block synchronised.
template <int N>
__device__ __forceinline__ void block_reduce(float (&v)[N], unsigned sum_mask, float* red,
                                             int warp, int lane, int nwarps) {
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = ((sum_mask >> k) & 1u) ? warp_sum(v[k]) : warp_max(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[k * kMaxWarps + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const bool is_sum = (sum_mask >> k) & 1u;
    float r = red[k * kMaxWarps];
    for (int w = 1; w < nwarps; ++w) {
      const float o = red[k * kMaxWarps + w];
      r = is_sum ? r + o : nanmax(r, o);
    }
    v[k] = r;
  }
  __syncthreads();
}

// ---- asynchronous copies from device to shared memory (cp.async)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}
// ---- end of the asynchronous-copy primitives

// floats between p and the 16-byte boundary below it
__device__ __forceinline__ int misalign(const float* p) {
  return (int)(((uintptr_t)p & 15u) >> 2);
}

// Copy count contiguous floats to shared memory.  dst and src have the same
// address modulo 16 bytes: the head up to the first boundary and the tail
// after the last move 4 bytes a request, the body 16.
__device__ __forceinline__ void copy_async(float* dst, const float* src, int count, int tid,
                                           int nt) {
  int head = (4 - misalign(src)) & 3;
  if (head > count) head = count;
  const int body = (count - head) >> 2;
  const int tail = head + 4 * body;
  if (tid < head) cp_async4(dst + tid, src + tid);
  for (int i = tid; i < body; i += nt) cp_async16(dst + head + 4 * i, src + head + 4 * i);
  if (tid < count - tail) cp_async4(dst + tail + tid, src + tail + tid);
}

// Fold four per-lane partial sums (of four rows) over the warp in six
// shuffles; the lanes with (lane >> 3) == j end with row j's total, summed
// in the order of a butterfly over offsets 16, 8, 4, 2, 1.
__device__ __forceinline__ float fold4(const float (&a)[4], int lane) {
  const bool h16 = lane & 16;
  const float b0 = (h16 ? a[2] : a[0]) + __shfl_xor_sync(kFull, h16 ? a[0] : a[2], 16);
  const float b1 = (h16 ? a[3] : a[1]) + __shfl_xor_sync(kFull, h16 ? a[1] : a[3], 16);
  const bool h8 = lane & 8;
  float v = (h8 ? b1 : b0) + __shfl_xor_sync(kFull, h8 ? b0 : b1, 8);
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// v M from shared memory: out[c] = sum_r v[r] M[r ld + c] for c < cols <=
// 32 KC.  Warp w sums rows w, w + nwarps, ... for the columns its lanes own
// and leaves them in part[w n4 + c]; the caller synchronises and adds the
// nwarps partial sums in warp order (combine).
template <int KC>
__device__ __forceinline__ void smem_cols(const float* M, int ld, int rows, int cols,
                                          const float* v, float* part, int n4, int warp,
                                          int lane, int nwarps) {
  int cidx[KC];
  float acc[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    cidx[k] = min(lane + 32 * k, cols - 1);  // lanes past the edge repeat the last column
    acc[k] = 0.f;
  }
#pragma unroll 4
  for (int r = warp; r < rows; r += nwarps) {
    const float vr = v[r];
    const float* row = M + r * ld;
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] = fmaf(vr, row[cidx[k]], acc[k]);
  }
#pragma unroll
  for (int k = 0; k < KC; ++k)
    if (lane + 32 * k < cols) part[warp * n4 + lane + 32 * k] = acc[k];
}

// output c of a product whose nwarps partial sums lie in part
__device__ __forceinline__ float combine(const float* part, int nwarps, int n4, int c) {
  float s = part[c];
  for (int w = 1; w < nwarps; ++w) s += part[w * n4 + c];
  return s;
}

// M v for cols <= 32 KC, NV right-hand sides a pass, M in shared or device
// memory: out[r] = sum_c M[r ld + c] v[c].  Lanes keep their entries of v in
// registers; a warp takes rows w, w + nwarps, w + 2 nwarps, w + 3 nwarps
// together, all their loads in flight at once (from device memory that is
// one round trip for four rows).
template <int KC, int NV>
__device__ __forceinline__ void tile_rows(const float* M, int ld, int rows, int cols,
                                          const float* va, const float* vb, float* outa,
                                          float* outb, int warp, int lane, int nwarps) {
  int cidx[KC];
  float ra[KC], rb[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int c = lane + 32 * k;
    cidx[k] = min(c, cols - 1);
    ra[k] = c < cols ? va[c] : 0.f;
    rb[k] = (NV == 2 && c < cols) ? vb[c] : 0.f;
  }
  const int mine = (lane >> 3) * nwarps;  // the row of the four whose total this lane gets
  for (int r0 = warp; r0 < rows; r0 += 4 * nwarps) {
    float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + j * nwarps;
      if (r < rows) {  // warp-uniform
        const float* row = M + r * ld;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const float mk = row[cidx[k]];
          a[j] = fmaf(mk, ra[k], a[j]);
          if (NV == 2) b[j] = fmaf(mk, rb[k], b[j]);
        }
      }
    }
    const float sa = fold4(a, lane);
    const float sb = NV == 2 ? fold4(b, lane) : 0.f;
    if ((lane & 7) == 0 && r0 + mine < rows) {
      outa[r0 + mine] = sa;
      if (NV == 2) outb[r0 + mine] = sb;
    }
  }
}

// Products from device memory, NV right-hand sides a pass.
// out[r] = sum_c M[r, c] v[c] for r < rows (M is rows x cols, row-major):
// a warp takes four rows at a time (their loads are in flight together),
// lanes over the columns
template <int NV>
__device__ __forceinline__ void gmem_rows(const float* __restrict__ M, const float* va,
                                          const float* vb, int rows, int cols, float* outa,
                                          float* outb, int warp, int lane, int nwarps) {
  const int mine = (lane >> 3) * nwarps;
  for (int r0 = warp; r0 < rows; r0 += 4 * nwarps) {
    float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
    const float* row[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + j * nwarps;
      row[j] = M + (size_t)(r < rows ? r : r0) * cols;  // rows past the edge repeat r0, unused
    }
    for (int c = lane; c < cols; c += 32) {
      float mk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) mk[j] = __ldg(row[j] + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j] = fmaf(mk[j], va[c], a[j]);
        if (NV == 2) b[j] = fmaf(mk[j], vb[c], b[j]);
      }
    }
    const float sa = fold4(a, lane);
    const float sb = NV == 2 ? fold4(b, lane) : 0.f;
    if ((lane & 7) == 0 && r0 + mine < rows) {
      outa[r0 + mine] = sa;
      if (NV == 2) outb[r0 + mine] = sb;
    }
  }
}

// out[c] = sum_r v[r] M[r, c] for c < cols: one thread per output column,
// kColSums interleaved partial sums of the rows added pairwise at the end
// (the resident route's column products likewise sum a warp's rows apiece,
// then the warps').  One running sum over all m rows carries f32 rounding
// that grows with m: at n = 147, m = 294 the iterates drifted twice as far
// from a float64 run as the plain version's, the dual residual stayed above
// an eps of 1e-6, and solves ran on to max_iter where float64 stops.  Four
// sums follow float64 there as closely as eight, and keep the streaming
// instantiation within its registers (eight spill: PERF.md).
constexpr int kColSums = 4;

template <int NV>
__device__ __forceinline__ void gmem_cols(const float* __restrict__ M, const float* va,
                                          const float* vb, int rows, int cols, float* outa,
                                          float* outb, int tid, int nt) {
  for (int c = tid; c < cols; c += nt) {
    float a[kColSums], b[kColSums];
#pragma unroll
    for (int k = 0; k < kColSums; ++k) a[k] = b[k] = 0.f;
    int r = 0;
    for (; r + kColSums <= rows; r += kColSums) {
#pragma unroll
      for (int k = 0; k < kColSums; ++k) {
        const float mk = __ldg(M + (size_t)(r + k) * cols + c);
        a[k] = fmaf(va[r + k], mk, a[k]);
        if (NV == 2) b[k] = fmaf(vb[r + k], mk, b[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kColSums; ++k) {
      if (r + k < rows) {
        const float mk = __ldg(M + (size_t)(r + k) * cols + c);
        a[k] = fmaf(va[r + k], mk, a[k]);
        if (NV == 2) b[k] = fmaf(vb[r + k], mk, b[k]);
      }
    }
#pragma unroll
    for (int w = kColSums / 2; w > 0; w /= 2) {
#pragma unroll
      for (int k = 0; k < w; ++k) {
        a[k] += a[k + w];
        if (NV == 2) b[k] += b[k + w];
      }
    }
    outa[c] = a[0];
    if (NV == 2) outb[c] = b[0];
  }
}

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }
// floats of a shared-memory region that holds count floats at any offset of
// 0..3 floats from its 16-byte-aligned start
__host__ __device__ constexpr int region(int count) { return round4(count + 3); }

// KC > 0: Minv and As resident in shared memory, n <= 32 KC columns a warp
// covers; KC == 0: streamed from device memory
template <int KC>
__global__ void __launch_bounds__(32 * kMaxWarps) admm_problem_kernel(const Args a) {
  constexpr bool RES = KC > 0;
  constexpr int KR = RES ? KC : 1;
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[kMaxReduce * kMaxWarps];
  const int n = a.n, m = a.m;
  const int n4 = round4(n), m4 = round4(m);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int b = blockIdx.x;

  const float* gMinv = a.Minv + (size_t)b * n * n;
  const float* gAs = a.As + (size_t)b * m * n;
  const float* gPs = a.Ps + (size_t)b * n * n;

  // the resident matrices, then n-vectors, m-vectors and the warps' partial
  // sums (plan() below counts them); every vector starts on a 16-byte boundary
  float* sAs = sm + (RES ? misalign(gAs) : 0);
  float* sMinv = sm + (RES ? region(m * n) + misalign(gMinv) : 0);
  float* x = sm + (RES ? region(m * n) + region(n * n) : 0);
  float* xn = x + n4;
  float* qs = xn + n4;
  float* sx = qs + n4;
  float* icsx = sx + n4;  // 1 / (c sx)
  float* vn1 = icsx + n4;
  float* vn2 = vn1 + n4;
  float* vn3 = vn2 + n4;
  float* vn4 = vn3 + n4;
  float* vn5 = vn4 + n4;
  float* z = vn5 + n4;
  float* zn = z + m4;
  float* y = zn + m4;
  float* yn = y + m4;
  float* ls = yn + m4;
  float* us = ls + m4;
  float* rho = us + m4;
  float* sy = rho + m4;
  float* isy = sy + m4;  // 1 / sy
  float* lv = isy + m4;
  float* uv = lv + m4;
  float* rzy = uv + m4;  // rho z - y of the current iterate
  float* vm1 = rzy + m4;
  float* vm2 = vm1 + m4;
  float* vm3 = vm2 + m4;
  float* part = vm3 + m4;  // nwarps x n4 (resident route)

  const size_t on = (size_t)b * n, om = (size_t)b * m;
  const float c = a.c[b];
  const float INF = __int_as_float(0x7f800000);

  int status = a.status0[b];
  int iters = 0;
  float pres = INF, dres = INF;

  if (RES && status == kRunning) {
    // As first: the first product of iteration 0 needs it, the second Minv
    copy_async(sAs, gAs, m * n, tid, nt);
    cp_async_commit();
    copy_async(sMinv, gMinv, n * n, tid, nt);
    cp_async_commit();
    // the first check comes at iteration 1: start Ps on its way to L2 (128-byte lines)
    for (int off = 32 * tid; off < n * n; off += 32 * nt) prefetch_l2(gPs + off);
  }

  for (int j = tid; j < n; j += nt) {
    x[j] = a.x0[on + j];
    qs[j] = a.qs[on + j];
    sx[j] = a.sx[on + j];
    icsx[j] = 1.f / (c * sx[j]);
  }
  for (int i = tid; i < m; i += nt) {
    z[i] = a.z0[om + i];
    y[i] = a.y0[om + i];
    ls[i] = a.ls[om + i];
    us[i] = a.us[om + i];
    rho[i] = a.rho[om + i];
    sy[i] = a.sy[om + i];
    isy[i] = 1.f / sy[i];
    lv[i] = a.l[om + i];
    uv[i] = a.u[om + i];
    rzy[i] = rho[i] * z[i] - y[i];
  }
  if (RES) cp_async_wait<1>();  // As has landed
  __syncthreads();

  if (status == kRunning) {
    const float alpha = a.alpha, sigma = a.sigma;
    const int sci = a.stop_check_iter;
    const int check_phase = 1 % sci;

    for (int it = 0; it < a.max_iter && status == kRunning; ++it) {
      // rhs = sigma x - qs + (rho z - y) As, xt = rhs Minv, zt = As xt
      if (RES) {
        smem_cols<KR>(sAs, n, m, n, rzy, part, n4, warp, lane, nwarps);
        __syncthreads();
        for (int j = tid; j < n; j += nt)
          vn1[j] = sigma * x[j] - qs[j] + combine(part, nwarps, n4, j);
        cp_async_wait<0>();  // Minv has landed (iteration 0; nothing to wait for later)
        __syncthreads();
        smem_cols<KR>(sMinv, n, n, n, vn1, part, n4, warp, lane, nwarps);
        __syncthreads();
        for (int j = tid; j < n; j += nt) {
          const float xt = combine(part, nwarps, n4, j);
          vn2[j] = xt;
          xn[j] = alpha * xt + (1.f - alpha) * x[j];
        }
        __syncthreads();
        tile_rows<KR, 1>(sAs, n, m, n, vn2, nullptr, vm2, nullptr, warp, lane, nwarps);
      } else {
        gmem_cols<1>(gAs, rzy, nullptr, m, n, vn1, nullptr, tid, nt);
        for (int j = tid; j < n; j += nt) vn1[j] = sigma * x[j] - qs[j] + vn1[j];  // same thread
        __syncthreads();
        gmem_rows<1>(gMinv, vn1, nullptr, n, n, vn2, nullptr, warp, lane, nwarps);  // xt
        __syncthreads();
        gmem_rows<1>(gAs, vn2, nullptr, m, n, vm2, nullptr, warp, lane, nwarps);  // zt
        for (int j = tid; j < n; j += nt) xn[j] = alpha * vn2[j] + (1.f - alpha) * x[j];
      }
      __syncthreads();
      for (int i = tid; i < m; i += nt) {
        const float zr = alpha * vm2[i] + (1.f - alpha) * z[i];
        const float v = zr + y[i] / rho[i];
        const float zc = (v != v) ? v : fminf(fmaxf(v, ls[i]), us[i]);
        const float yc = y[i] + rho[i] * (zr - zc);
        zn[i] = zc;
        yn[i] = yc;
        rzy[i] = rho[i] * zc - yc;  // for the next iteration
      }
      __syncthreads();

      int new_status = kRunning;
      float pres_n = pres, dres_n = dres;
      if (it % sci == check_phase) {
        // ---- the steps dy, dx, then Ps once (x and dx), As by rows (x and
        // dx) and As by columns (y, dy)
        for (int i = tid; i < m; i += nt) vm2[i] = yn[i] - y[i];
        for (int j = tid; j < n; j += nt) vn3[j] = xn[j] - x[j];
        __syncthreads();
        if (RES) {
          tile_rows<KR, 2>(gPs, n, n, n, xn, vn3, vn1, vn5, warp, lane, nwarps);  // Ps x, Ps dx
          tile_rows<KR, 2>(sAs, n, m, n, xn, vn3, vm1, vm3, warp, lane, nwarps);  // As x, As dx
          smem_cols<KR>(sAs, n, m, n, yn, part, n4, warp, lane, nwarps);
          __syncthreads();
          for (int j = tid; j < n; j += nt) vn2[j] = combine(part, nwarps, n4, j);  // y As
          __syncthreads();
          smem_cols<KR>(sAs, n, m, n, vm2, part, n4, warp, lane, nwarps);
          __syncthreads();
          for (int j = tid; j < n; j += nt) vn4[j] = combine(part, nwarps, n4, j);  // dy As
        } else {
          gmem_rows<2>(gPs, xn, vn3, n, n, vn1, vn5, warp, lane, nwarps);  // Ps x, Ps dx
          gmem_rows<2>(gAs, xn, vn3, m, n, vm1, vm3, warp, lane, nwarps);
          gmem_cols<2>(gAs, yn, vm2, m, n, vn2, vn4, tid, nt);
        }
        __syncthreads();

        // r: pres, |Ax|, |z|, dres, |Px|, |q|, |A'y|, E = |dy_us|, |dx_us|, non-finite
        float r[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int i = tid; i < m; i += nt) {
          const float ax = vm1[i] * isy[i];
          const float zu = zn[i] * isy[i];
          r[0] = nanmax(r[0], fabsf(ax - zu));
          r[1] = nanmax(r[1], fabsf(ax));
          r[2] = nanmax(r[2], fabsf(zu));
          r[7] = nanmax(r[7], fabsf(sy[i] * vm2[i] / c));
          if (!(fabsf(yn[i]) < INF)) r[9] = 1.f;
        }
        for (int j = tid; j < n; j += nt) {
          const float px = vn1[j] * icsx[j];
          const float aty = vn2[j] * icsx[j];
          const float qv = qs[j] * icsx[j];
          r[3] = nanmax(r[3], fabsf(px + qv + aty));
          r[4] = nanmax(r[4], fabsf(px));
          r[5] = nanmax(r[5], fabsf(qv));
          r[6] = nanmax(r[6], fabsf(aty));
          r[8] = nanmax(r[8], fabsf(sx[j] * vn3[j]));
          if (!(fabsf(xn[j]) < INF)) r[9] = 1.f;
        }
        block_reduce(r, 0u, red, warp, lane, nwarps);
        pres_n = r[0];
        dres_n = r[3];
        const bool prim_ok = pres_n <= a.eps_abs + a.eps_rel * nanmax(r[1], r[2]);
        const bool dual_ok = dres_n <= a.eps_abs + a.eps_rel * nanmax(r[4], nanmax(r[5], r[6]));
        const float thr = a.eps_pinf * r[7];
        const float tol = a.eps_dinf * r[8];

        // ---- certificates, from A' dy (vn4), Ps dx (vn5), As dx (vm3)
        // s: violated sign row, sum term, |A'dy|, failed row, |Pdx|, q'dx
        float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int i = tid; i < m; i += nt) {
          const float dyus = sy[i] * vm2[i] / c;
          const bool uinf = uv[i] >= INF;
          const bool linf = lv[i] <= -INF;
          if ((uinf && dyus > thr) || (linf && dyus < -thr)) s[0] = 1.f;
          s[1] += (uinf ? 0.f : uv[i]) * fmaxf(0.f, dyus) + (linf ? 0.f : lv[i]) * fminf(0.f, dyus);
          const float adx = vm3[i] * isy[i];
          const bool ok = uinf ? adx >= -tol : (linf ? adx <= tol : fabsf(adx) < tol);
          if (!ok) s[3] = 1.f;
        }
        for (int j = tid; j < n; j += nt) {
          s[2] = nanmax(s[2], fabsf(vn4[j] * icsx[j]));
          s[4] = nanmax(s[4], fabsf(vn5[j] * icsx[j]));
          s[5] += qs[j] * icsx[j] * (sx[j] * vn3[j]);
        }
        block_reduce(s, (1u << 1) | (1u << 5), red, warp, lane, nwarps);
        const bool prim_inf = !(s[0] > 0.5f) && nanmax(s[2], s[1]) < thr;
        const bool dual_inf = s[4] <= tol && s[5] <= tol && !(s[3] > 0.5f);
        const bool diverged = r[9] > 0.5f;

        new_status = diverged ? kUnknown
                     : (prim_ok && dual_ok) ? kOptimal
                     : prim_inf ? kPrimalInf
                     : dual_inf ? kDualInf
                     : kRunning;
      }

      // commit the iterate (block-uniform pointer swap)
      float* t;
      t = x; x = xn; xn = t;
      t = z; z = zn; zn = t;
      t = y; y = yn; yn = t;
      status = new_status;
      iters = it + 1;
      pres = pres_n;
      dres = dres_n;
    }
    if (status == kRunning) status = kMaxIter;
  }

  for (int j = tid; j < n; j += nt) a.x[on + j] = x[j];
  for (int i = tid; i < m; i += nt) {
    a.z[om + i] = z[i];
    a.y[om + i] = y[i];
  }
  if (tid == 0) {
    a.status[b] = status;
    a.iters[b] = iters;
    a.pres[b] = pres;
    a.dres[b] = dres;
  }
}

// The route a shape takes and the dynamic shared memory one block needs
// (qp/cuda_kernel.py's problem_route mirrors it): 10 n-vectors and 15
// m-vectors, each padded to 16 bytes; on the resident route also one n-vector
// of partial sums per warp, As and Minv, each with room for its source's
// offset from a 16-byte boundary.
struct Plan {
  bool resident;
  size_t smem;
};

Plan plan(int n, int m, int warps) {
  const size_t vectors = (size_t)10 * round4(n) + (size_t)15 * round4(m);
  const size_t partial = (size_t)warps * round4(n);
  // (sizes beyond int are far beyond shared memory: compare in 64 bits first)
  const size_t mats = (size_t)m * n + (size_t)n * n;
  if (4 * (mats + 16 + vectors + partial) + kStaticSmem <= kSmemLimit)
    return {true, 4 * ((size_t)region(m * n) + region(n * n) + vectors + partial)};
  return {false, 4 * vectors};
}

template <int KC>
cudaError_t launch(const Args& a, int warps, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(admm_problem_kernel<KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  admm_problem_kernel<KC><<<a.B, 32 * warps, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// 1 when (n, m) takes the resident route, else 0; *smem gets the dynamic
// shared memory of one block in bytes
extern "C" int admm_problem_route(int n, int m, int warps, int* smem) {
  const Plan p = plan(n, m, warps);
  if (smem) *smem = (int)p.smem;
  return p.resident ? 1 : 0;
}

extern "C" int admm_problem_launch(
    const float* Minv, const float* As, const float* Ps, const float* rho, const float* sx,
    const float* sy, const float* c, const float* qs, const float* ls, const float* us,
    const float* l, const float* u, const float* x0, const float* z0, const float* y0,
    const int* status0, float* x, float* z, float* y, int* status, int* iters, float* pres,
    float* dres, int B, int n, int m, int warps, float alpha, float sigma, float eps_abs,
    float eps_rel, float eps_pinf, float eps_dinf, int max_iter, int stop_check_iter,
    void* stream) {
  if (B <= 0) return 0;
  if (n <= 0 || m <= 0 || warps < 1 || warps > kMaxWarps || stop_check_iter < 1)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(n, m, warps);
  if (p.smem + kStaticSmem > kSmemLimit) return (int)cudaErrorInvalidValue;
  Args a{Minv, As, Ps, rho, sx, sy, c, qs, ls, us, l, u, x0, z0, y0, status0,
         x, z, y, status, iters, pres, dres, B, n, m,
         alpha, sigma, eps_abs, eps_rel, eps_pinf, eps_dinf, max_iter, stop_check_iter};
  cudaStream_t s = (cudaStream_t)stream;
  if (!p.resident) return (int)launch<0>(a, warps, p.smem, s);
  // a resident n is at most 241: the columns a warp covers, in steps of 64
  if (n <= 64) return (int)launch<2>(a, warps, p.smem, s);
  if (n <= 128) return (int)launch<4>(a, warps, p.smem, s);
  if (n <= 192) return (int)launch<6>(a, warps, p.smem, s);
  return (int)launch<8>(a, warps, p.smem, s);
}
