// Shared-matrix fused ADMM iteration, cluster route: fleets of QPs that share
// one scaled KKT inverse, constraint matrix and cost matrix too large for one
// block's shared memory (max(n, m) > 128) but small enough that a
// thread-block cluster of up to 16 blocks holds Minv and As in its
// distributed shared memory.
//
// Replaces, with csrc/admm_shared.cu (the resident route) and
// csrc/admm_shared_stream.cu (the streaming route), the TPU kernel
// smooth_feedback_tpu/qp/pallas_kernel.py::_admm_kernel_shared (called
// through admm_iterate_pallas_shared); qp/cuda_kernel.py's shared_route
// decides by shape, and sends this kernel the shapes whose slices need a
// cluster of 16 blocks (square 426 to 640).  It computes the same function
// as the streaming route: per problem, the ADMM loop
//
//     rhs = sigma x - qs + (rho z - y) As      xt = rhs Minv      zt = xt As'
//     x   <- alpha xt + (1 - alpha) x
//     z   <- clip(alpha zt + (1 - alpha) z + y / rho, ls, us)
//     y   <- y + rho (alpha zt + (1 - alpha) z - z_new)
//
// with the unscaled-residual stopping check, the primal/dual infeasibility
// certificates and the non-finite test every stop_check_iter-th iteration
// (it % k == 1 % k).  A member that stops freezes; members still running at
// max_iter come back as MaxIterations; members whose status0 is not Running
// come back untouched (iters 0, pres = dres = inf).  Outputs in scaled
// variables.
//
// What bounds it on an H100: the FMAs, 2 m n + n^2 a problem-iteration (and
// six products at a check), at 67 TFLOP/s of f32.  The streaming route reads
// every matrix from L2 on every iteration, and each of its blocks runs as
// long as its slowest member: at bench.py's (602, 602) fleet, where ~1 % of
// members run to max_iter, its warm solve costs 200 block-iterations.
//
// Design.  A cluster of C blocks (plan() below: the smallest of 1, 2, 4, 8,
// 16 whose slices fit, 16 being a non-portable size) keeps the matrices in
// shared memory for the whole launch: block r holds Minv's output columns
// r Wn .. r Wn + Wn - 1 (every row) and As's rows r Wm .. r Wm + Wm - 1
// (every column, at the odd row stride n | 1, so row and column walks are
// free of bank conflicts), copied in once with cp.async.  Ps is read at
// checks only and stays in device memory (its transpose, written into the
// caller's scratch first).  A cluster advances a group of G problems in
// lockstep, every iterate in shared memory, block r owning x's columns and
// z's and y's rows of its slices.  The products, on fp32 FMAs, each thread
// summing one output for all G problems against one matrix entry a row:
//   - xt = rhs Minv and zt = xt As' (and P x, A x, P dx, A dx at a check):
//     every block gathers the whole input vector of its G problems from its
//     peers' shared memory (DSMEM) into its own, then sums its own outputs
//     over every input row, the rows split over segments of threads;
//   - (rho z - y) As (and y As, dy As at a check): each block sums its own
//     rows of As for every output column, and the owner of a column adds the
//     C partial sums in rank order, read from its peers' shared memory.
// The iteration's elementwise work (the rhs, the z and y updates with their
// division and clip, the commit) is spread over (output, problem) pairs on
// every thread.  Clusters are persistent: the grid is as many clusters as
// can be resident (cudaOccupancyMaxActiveClusters), and each takes the next
// group from a work counter in the caller's scratch (zeroed on the caller's
// stream by every launch) until none is left, so a group whose slowest
// member runs to max_iter holds one cluster while the others drain the
// batch.  Every block of a cluster makes the same loop decisions: the group
// index comes from rank 0, and each block reduces a check's per-problem
// quantities over the whole cluster in the same order, so the statuses agree
// bit for bit.  cluster.sync() (barrier.cluster arrive.release /
// wait.acquire) orders every DSMEM exchange; a buffer that peers read is
// written again only after a later barrier, and no block leaves while a peer
// can still read it.
//
// What that bought (PERF.md, H100): an iteration of a group is a chain of
// three cluster barriers, two gathers and three products on thin slices,
// bound by latency, not by FMAs or shared-memory bandwidth (two- to
// eight-output thread tiles and other unroll depths were no faster).  Per
// iteration it is slower than the streaming route at every sweep shape; the
// persistent clusters win where stragglers set the streaming route's time,
// at (602, 602), whose slices need 16 blocks.
//
// Summation order, on purpose: a product's output sums its input rows in
// ascending order in runs of 32 rows, each run in one fmaf chain from 0;
// where a block splits the runs of an output over S thread segments, each
// segment adds its runs in order and the segments are added in order, and
// the cross-rank partials are added in rank order.  A member's arithmetic
// depends on nothing but its own data and the shape: C, G, the slices and
// the thread layout come from (n, m) alone, never from B or from what is
// resident; members past B in the last group read nothing and store nothing.
// Norms and sums of a check reduce per thread, per warp, over the warps in
// order, then over the ranks in order.
//
// No tensor cores (fp32 FMAs on the CUDA cores: bf16 gave 0 of 2048 Optimal),
// IEEE division, no fast math: the divergence test relies on IEEE inf and
// NaN, and the max propagates NaN like jnp.max.
//
// Plain C interface, loaded with ctypes; the launch uses the caller's
// stream, allocates nothing and returns the first CUDA error.  Where no
// cluster of the planned size can be resident, it returns an error and
// launches nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

constexpr int kRunning = -1;
constexpr int kOptimal = 0;
constexpr int kPrimalInf = 2;
constexpr int kDualInf = 3;
constexpr int kMaxIter = 4;
constexpr int kUnknown = 6;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // a block's threads
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 32;       // rows a partial sum covers
constexpr size_t kSmemLimit = 232448;  // what one block may hold on an H100
constexpr int kSizes[] = {1, 2, 4, 8, 16};  // cluster sizes, smallest first
constexpr int kGroups[] = {8, 4};           // problems a cluster advances, widest first

// the quantities a check reduces over the cluster, per problem
enum Q : int {
  qNz, qE, qSum, qAty, qAtdy, qDxn, qQdx, qFin, qRd, qPx, qQv, qRp, qAx, qPdx,
  qRu,  // max of -A dx over the rows unbounded above
  qRl,  // max of A dx over the rows unbounded below only
  qRf,  // max of |A dx| over the bounded rows
  qVu,  // max of dy over the rows unbounded above (NaN skipped)
  qVl,  // max of -dy over the rows unbounded below (NaN skipped)
  kNQ
};

// how a quantity combines: max of values >= 0 (NaN on top), sum, max
// propagating NaN, max skipping NaN
enum Kind : int { kAbs, kSum, kNan, kDrop };

__host__ __device__ constexpr Kind kind_of(int q) {
  return (q == qSum || q == qQdx) ? kSum
         : (q == qRu || q == qRl || q == qRf) ? kNan
         : (q == qVu || q == qVl) ? kDrop
                                  : kAbs;
}

// Where everything sits in a block's dynamic shared memory, in floats: the
// gathered input U (max(n, m) rows of G), the product's per-segment sums,
// the check's per-warp and per-block quantities, the vectors of the block's
// own columns (x, xn, the rhs and xt exchanged, dx, y As) and rows (z, y, zn,
// yn, rho z - y, dy), the status words, then the matrix slices.
struct Layout {
  int Wn, Wm, ldA;
  int U, RED, QW, QB, QF, X, XN, XE, XT, DX, ATY, Z, Y, ZN, YN, WV, DY, INTS, MS, AS;
  int floats;
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

__host__ __device__ inline Layout make_layout(int n, int m, int C, int G) {
  Layout L;
  L.Wn = (n + C - 1) / C;
  L.Wm = (m + C - 1) / C;
  L.ldA = n | 1;
  const int D = n > m ? n : m;
  const int cols = L.Wn * G, rows = L.Wm * G;  // multiples of 4
  int o = 0;
  L.U = o;    o += round4(D * G);
  L.RED = o;  o += kThreads * G;
  L.QW = o;   o += kNQ * kWarps * G;
  L.QB = o;   o += round4(kNQ * G);
  L.QF = o;   o += round4(kNQ * G);
  L.X = o;    o += cols;
  L.XN = o;   o += cols;
  L.XE = o;   o += cols;
  L.XT = o;   o += cols;
  L.DX = o;   o += cols;
  L.ATY = o;  o += cols;
  L.Z = o;    o += rows;
  L.Y = o;    o += rows;
  L.ZN = o;   o += rows;
  L.YN = o;   o += rows;
  L.WV = o;   o += rows;
  L.DY = o;   o += rows;
  L.INTS = o; o += round4(7 * G + 1);  // st, its, nst, pr, dr, npr, ndr; the group slot
  L.MS = o;   o += n * L.Wn;
  L.AS = o;   o += L.Wm * L.ldA;
  L.floats = o;
  return L;
}

size_t smem_bytes(int n, int m, int C, int G) {
  return 4 * (size_t)make_layout(n, m, C, G).floats;
}

struct Args {
  const float* Minv;  // (n, n)
  const float* As;    // (m, n)
  const float* PsT;   // (n, n), scratch
  const float* rho;   // (m,)
  const float* sx;    // (n,)
  const float* sy;    // (m,)
  const float* c;     // scalar
  const float* qs;    // (B, n)
  const float* ls;    // (B, m)
  const float* us;    // (B, m)
  const float* l;     // (B, m)
  const float* u;     // (B, m)
  const float* x0;    // (B, n)
  const float* z0;    // (B, m)
  const float* y0;    // (B, m)
  const int* status0; // (B,)
  float* x;           // (B, n)
  float* z;           // (B, m)
  float* y;           // (B, m)
  int* status;
  int* iters;
  float* pres;
  float* dres;
  int* counter;       // scratch: the next group
  int B, n, m, groups;
  float alpha, sigma, eps_abs, eps_rel, eps_pinf, eps_dinf;
  int max_iter, stop_check_iter;
};

// max that propagates NaN, like jnp.max / torch.max
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float combine(Kind k, float a, float b) {
  return k == kSum ? a + b : k == kDrop ? fmaxf(a, b) : nanmax(a, b);
}

__device__ __forceinline__ float identity(Kind k) {
  return (k == kNan || k == kDrop) ? -__int_as_float(0x7f800000) : 0.f;
}

// butterfly over the warp, lane 0's value is the one kept; values >= +0 or
// NaN with the sign bit clear (kAbs) order as unsigned integers
template <Kind K>
__device__ __forceinline__ float warp_reduce(float v) {
  if constexpr (K == kAbs) {
    return __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(v)));
  } else {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = combine(K, v, __shfl_xor_sync(kFull, v, o));
    return v;
  }
}

// this thread's values v of the G problems -> QW[q][warp][g]
template <Kind K, int G>
__device__ __forceinline__ void put(float* QW, int q, const float (&v)[G]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float r = warp_reduce<K>(v[g]);
    if (lane == 0) QW[(q * kWarps + warp) * G + g] = r;
  }
}

template <int G>
__device__ __forceinline__ void load_g(const float* p, float (&b)[G]) {
#pragma unroll
  for (int c = 0; c < G / 4; ++c) {
    const float4 v = reinterpret_cast<const float4*>(p)[c];
    b[4 * c] = v.x;
    b[4 * c + 1] = v.y;
    b[4 * c + 2] = v.z;
    b[4 * c + 3] = v.w;
  }
}

template <int G>
__device__ __forceinline__ void store_g(float* p, const float (&b)[G]) {
#pragma unroll
  for (int c = 0; c < G / 4; ++c)
    reinterpret_cast<float4*>(p)[c] = make_float4(b[4 * c], b[4 * c + 1], b[4 * c + 2], b[4 * c + 3]);
}

template <int G>
__device__ __forceinline__ void zero_g(float (&b)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) b[g] = 0.f;
}

// v[g] = p[g stride] for the live members (0 past them): every load issued
// before any use, so the G round trips to device memory overlap
template <int G>
__device__ __forceinline__ void fetch(const float* __restrict__ p, size_t stride, int live,
                                      float (&v)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) v[g] = g < live ? __ldg(p + g * stride) : 0.f;
}

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// acc[g] += the runs r0 .. r1 - 1 of sum_k In[k G + g] M[k sk + o so], each
// run of kRun rows one fmaf chain from 0, added in order
template <int G, bool kGlobal>
__device__ __forceinline__ void runs(const float* In, const float* M, int K, int sk, int so,
                                     int o, int r0, int r1, float (&acc)[G]) {
  for (int r = r0; r < r1; ++r) {
    const int k0 = r * kRun;
    const int len = min(kRun, K - k0);
    const float* Mr = M + k0 * sk + o * so;
    const float* Ir = In + k0 * G;
    float part[G];
    zero_g(part);
#pragma unroll 8
    for (int i = 0; i < len; ++i) {
      const float w = kGlobal ? __ldg(Mr + i * sk) : Mr[i * sk];
      float b[G];
      load_g<G>(Ir + i * G, b);
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = fmaf(b[g], w, part[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] += part[g];
  }
}

// fn(o, out) for every o < O, out[g] = sum_{k < K} In[k G + g] M[k sk + o so]
// (In in shared memory, [row][problem]; M in shared memory, or in device
// memory with kGlobal).  Where the block has more threads than outputs the
// runs of an output are split over S segments of threads, whose sums meet in
// `red` (a barrier inside; S depends on O and K alone, the same for every
// thread of the block); else each thread sums whole outputs (no barrier).
// With kPairs, fn(o, g, out[g]) takes one problem's output at a time, and
// where the segments meet in `red` the (output, problem) pairs are spread
// over every thread of the block, so an epilogue heavier than the sum does
// not wait on the few threads that own outputs.
template <int G, bool kGlobal, bool kPairs = false, class Fn>
__device__ __forceinline__ void product(const float* In, const float* M, int K, int sk, int so,
                                        int O, float* red, Fn&& fn) {
  if (O <= 0) return;
  const int t = threadIdx.x;
  const int R = (K + kRun - 1) / kRun;
  int S = kThreads / O;
  S = S > R ? R : S;
  if (S <= 1) {
    for (int o = t; o < O; o += kThreads) {
      float acc[G];
      zero_g(acc);
      runs<G, kGlobal>(In, M, K, sk, so, o, 0, R, acc);
      if constexpr (kPairs) {
#pragma unroll
        for (int g = 0; g < G; ++g) fn(o, g, acc[g]);
      } else {
        fn(o, acc);
      }
    }
    return;
  }
  const int o = t % O, s = t / O;
  float acc[G];
  zero_g(acc);
  if (s < S) runs<G, kGlobal>(In, M, K, sk, so, o, s * R / S, (s + 1) * R / S, acc);
  __syncthreads();  // the previous product's sums are read
  if (s < S) store_g(red + (s * O + o) * G, acc);
  __syncthreads();
  if constexpr (kPairs) {
    for (int p = t; p < O * G; p += kThreads) {
      const int po = p / G, pg = p - po * G;
      float r = 0.f;
      for (int s2 = 0; s2 < S; ++s2) r += red[(s2 * O + po) * G + pg];
      fn(po, pg, r);
    }
  } else if (t < O) {
    float r[G];
    zero_g(r);
    for (int s2 = 0; s2 < S; ++s2) {
      float b[G];
      load_g<G>(red + (s2 * O + t) * G, b);
#pragma unroll
      for (int g = 0; g < G; ++g) r[g] += b[g];
    }
    fn(t, r);
  }
}

// U[(q Wn + jj) G + g] = src of rank q [jj G + g] for every rank q and each
// of its valid columns jj (the whole n-vector of the G problems)
template <int G>
__device__ __forceinline__ void gather(cg::cluster_group& cluster, float* U, float* src, int Wn,
                                       int n, int C) {
  const int per = Wn * G / 4;  // float4s of a rank's slice
  const int total = C * per;
  for (int f0 = threadIdx.x; f0 < total; f0 += 4 * kThreads) {
    float4 v[4];
    int at[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int f = f0 + k * kThreads;
      const int q = f / per, e = f - q * per;
      at[k] = (f < total && q * Wn * G + 4 * e < n * G) ? f : -1;
      if (at[k] >= 0) v[k] = reinterpret_cast<const float4*>(cluster.map_shared_rank(src, q))[e];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (at[k] >= 0) reinterpret_cast<float4*>(U)[at[k]] = v[k];
  }
}

// out[g] = sum over the ranks in order of U of rank q [row G + g]
template <int G>
__device__ __forceinline__ void rank_sum(cg::cluster_group& cluster, float* U, int row, int C,
                                         float (&out)[G]) {
  zero_g(out);
#pragma unroll 4
  for (int q = 0; q < C; ++q) {
    float b[G];
    load_g<G>(cluster.map_shared_rank(U, q) + row * G, b);
#pragma unroll
    for (int g = 0; g < G; ++g) out[g] += b[g];
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads, 1) admm_shared_cluster_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) float smem[];
  const int n = a.n, m = a.m, t = threadIdx.x;
  const Layout L = make_layout(n, m, C, G);
  float* U = smem + L.U;
  float* red = smem + L.RED;
  float* QW = smem + L.QW;
  float* QB = smem + L.QB;
  float* QF = smem + L.QF;
  float* X = smem + L.X;      // x on the block's columns
  float* XN = smem + L.XN;    // this iteration's x
  float* XE = smem + L.XE;    // rhs, for the peers
  float* XT = smem + L.XT;    // xt, for the peers
  float* DX = smem + L.DX;    // xn - x at a check, for the peers
  float* ATY = smem + L.ATY;  // y As at a check
  float* Z = smem + L.Z;      // z on the block's rows
  float* Y = smem + L.Y;
  float* ZN = smem + L.ZN;
  float* YN = smem + L.YN;
  float* WV = smem + L.WV;    // rho z - y
  float* DY = smem + L.DY;    // yn - y at a check
  int* st = reinterpret_cast<int*>(smem + L.INTS);
  int* its = st + G;
  int* nst = its + G;
  float* pr = reinterpret_cast<float*>(nst + G);
  float* dr = pr + G;
  float* npr = dr + G;
  float* ndr = npr + G;
  int* slot = reinterpret_cast<int*>(ndr + G);
  float* MS = smem + L.MS;  // Minv[i][c0 + jj] at i Wn + jj
  float* AS = smem + L.AS;  // As[r0 + jj][i] at jj ldA + i
  const int Wn = L.Wn, Wm = L.Wm, ldA = L.ldA;
  const int c0 = rank * Wn, r0 = rank * Wm;
  const int wn = max(0, min(Wn, n - c0)), wm = max(0, min(Wm, m - r0));
  const float INF = __int_as_float(0x7f800000);
  const float alpha = a.alpha, sigma = a.sigma, cc = *a.c;
  const int sci = a.stop_check_iter, check_phase = 1 % sci;

  // the block's slices, once a launch; zeros past the matrices' edges
  for (int e = t; e < n * Wn; e += kThreads) {
    const int i = e / Wn, jj = e - i * Wn;
    if (jj < wn) copy_async(MS + e, a.Minv + (size_t)i * n + c0 + jj);
    else MS[e] = 0.f;
  }
  for (int e = t; e < Wm * ldA; e += kThreads) {
    const int jj = e / ldA, i = e - jj * ldA;
    if (jj < wm && i < n) copy_async(AS + e, a.As + (size_t)(r0 + jj) * n + i);
    else AS[e] = 0.f;
  }
  copy_wait();
  __syncthreads();

  for (;;) {
    // the next group, the same for every block of the cluster
    if (rank == 0 && t == 0) *slot = atomicAdd(a.counter, 1);
    cluster.sync();
    const int grp = *cluster.map_shared_rank(slot, 0);
    cluster.sync();  // every block has read rank 0's slot
    if (grp >= a.groups) break;
    const int first = grp * G;
    const int live = min(G, a.B - first);  // members past B: not read, not stored
    auto on = [&](int g, int j) { return (size_t)(first + g) * n + j; };
    auto om = [&](int g, int j) { return (size_t)(first + g) * m + j; };

    if (t < G) {
      st[t] = t < live ? a.status0[first + t] : kMaxIter;
      its[t] = 0;
      pr[t] = INF;
      dr[t] = INF;
    }
    for (int jj = t; jj < Wn; jj += kThreads) {
      float v[G];
      fetch<G>(a.x0 + on(0, c0 + jj), n, jj < wn ? live : 0, v);
      store_g(X + jj * G, v);
    }
    for (int jj = t; jj < Wm; jj += kThreads) {
      float v[G], w[G];
      fetch<G>(a.z0 + om(0, r0 + jj), m, jj < wm ? live : 0, v);
      fetch<G>(a.y0 + om(0, r0 + jj), m, jj < wm ? live : 0, w);
      store_g(Z + jj * G, v);
      store_g(Y + jj * G, w);
    }
    __syncthreads();

    for (int it = 0; it < a.max_iter; ++it) {
      bool any_run = false;
#pragma unroll
      for (int g = 0; g < G; ++g) any_run = any_run || st[g] == kRunning;
      if (!any_run) break;

      // WV = rho z - y on the block's rows
      for (int p = t; p < wm * G; p += kThreads) WV[p] = a.rho[r0 + p / G] * Z[p] - Y[p];
      __syncthreads();
      // U = the block's rows' share of (rho z - y) As, every column
      product<G, false>(WV, AS, wm, ldA, 1, n, red,
                        [&](int o, const float (&s)[G]) { store_g(U + o * G, s); });
      cluster.sync();
      // rhs = sigma x - qs + (rho z - y) As on the block's columns, one
      // (column, problem) pair a thread at a time
      for (int p = t; p < wn * G; p += kThreads) {
        const int jj = p / G, g = p - jj * G;
        const float q = g < live ? __ldg(a.qs + on(g, c0 + jj)) : 0.f;
        float s = 0.f;
        for (int r = 0; r < C; ++r) s += cluster.map_shared_rank(U, r)[c0 * G + p];
        XE[p] = g < live ? sigma * X[p] - q + s : 0.f;
      }
      cluster.sync();
      gather<G>(cluster, U, XE, Wn, n, C);
      __syncthreads();
      // xt = rhs Minv on the block's columns; xn = alpha xt + (1 - alpha) x
      product<G, false, true>(U, MS, n, Wn, 1, wn, red, [&](int o, int g, float xt) {
        XT[o * G + g] = xt;
        XN[o * G + g] = alpha * xt + (1.f - alpha) * X[o * G + g];
      });
      cluster.sync();
      gather<G>(cluster, U, XT, Wn, n, C);
      __syncthreads();
      // zt = xt As' on the block's rows: the z and y updates
      product<G, false, true>(U, AS, n, 1, ldA, wm, red, [&](int o, int g, float zt) {
        const int j = r0 + o;
        float zv = 0.f, yv = 0.f;
        if (g < live) {
          const float rj = a.rho[j];
          const float lo = __ldg(a.ls + om(g, j)), hi = __ldg(a.us + om(g, j));
          const float zo = Z[o * G + g], yo = Y[o * G + g];
          const float zr = alpha * zt + (1.f - alpha) * zo;
          const float v = zr + yo / rj;
          zv = (v != v) ? v : fminf(fmaxf(v, lo), hi);
          yv = yo + rj * (zr - zv);
        }
        ZN[o * G + g] = zv;
        YN[o * G + g] = yv;
      });

      const bool check = it % sci == check_phase;
      if (check) {
        __syncthreads();  // U is read no more
        float fin[G];  // 1 where a non-finite iterate was seen
        zero_g(fin);
        {
          // ---- y side: dy; |z|, E, the certificate's sum and its rows
          float nz[G], e[G], s[G], vu[G], vl[G];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            nz[g] = e[g] = s[g] = 0.f;
            vu[g] = vl[g] = -INF;
          }
          for (int jj = t; jj < wm; jj += kThreads) {
            const int j = r0 + jj;
            const float syj = a.sy[j], inv_sy = 1.f / syj;
            float lo[G], hi[G];
            fetch<G>(a.l + om(0, j), m, live, lo);
            fetch<G>(a.u + om(0, j), m, live, hi);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              float dy = 0.f;
              if (g < live) {
                const float ynv = YN[jj * G + g];
                dy = ynv - Y[jj * G + g];
                nz[g] = nanmax(nz[g], fabsf(ZN[jj * G + g] * inv_sy));
                const float dy_us = syj * dy / cc;
                e[g] = nanmax(e[g], fabsf(dy_us));
                const float lv = lo[g], uv = hi[g];
                const bool uinf = uv >= INF, linf = lv <= -INF;
                const float ufin = uinf ? 0.f : uv;
                const float lfin = linf ? 0.f : lv;
                s[g] += ufin * fmaxf(0.f, dy_us) + lfin * fminf(0.f, dy_us);
                if (uinf) vu[g] = fmaxf(vu[g], dy_us);
                if (linf) vl[g] = fmaxf(vl[g], -dy_us);
                if (!(fabsf(ynv) < INF)) fin[g] = 1.f;
              }
              DY[jj * G + g] = dy;
            }
          }
          put<kAbs, G>(QW, qNz, nz);
          put<kAbs, G>(QW, qE, e);
          put<kSum, G>(QW, qSum, s);
          put<kDrop, G>(QW, qVu, vu);
          put<kDrop, G>(QW, qVl, vl);
        }
        {
          // ---- x side: dx; |sx dx|, the q'dx sum
          float dxn[G], qdx[G];
          zero_g(dxn);
          zero_g(qdx);
          for (int jj = t; jj < wn; jj += kThreads) {
            const int j = c0 + jj;
            const float sxj = a.sx[j], inv_csx = 1.f / (cc * sxj);
            float q[G];
            fetch<G>(a.qs + on(0, j), n, live, q);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              float dx = 0.f;
              if (g < live) {
                const float xnv = XN[jj * G + g];
                dx = xnv - X[jj * G + g];
                dxn[g] = nanmax(dxn[g], fabsf(sxj * dx));
                qdx[g] += q[g] * inv_csx * (sxj * dx);
                if (!(fabsf(xnv) < INF)) fin[g] = 1.f;
              }
              DX[jj * G + g] = dx;
            }
          }
          put<kAbs, G>(QW, qDxn, dxn);
          put<kSum, G>(QW, qQdx, qdx);
          put<kAbs, G>(QW, qFin, fin);
        }
        __syncthreads();  // DY
        // y As (kept for the dual residual) from the ranks' partial sums
        product<G, false>(YN, AS, wm, ldA, 1, n, red,
                          [&](int o, const float (&v)[G]) { store_g(U + o * G, v); });
        cluster.sync();
        {
          float n1[G];
          zero_g(n1);
          for (int jj = t; jj < wn; jj += kThreads) {
            float v[G];
            rank_sum<G>(cluster, U, c0 + jj, C, v);
            const float inv_csx = 1.f / (cc * a.sx[c0 + jj]);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              ATY[jj * G + g] = v[g];
              if (g < live) n1[g] = nanmax(n1[g], fabsf(v[g] * inv_csx));
            }
          }
          put<kAbs, G>(QW, qAty, n1);
        }
        cluster.sync();  // the peers have read U
        // dy As
        product<G, false>(DY, AS, wm, ldA, 1, n, red,
                          [&](int o, const float (&v)[G]) { store_g(U + o * G, v); });
        cluster.sync();
        {
          float n1[G];
          zero_g(n1);
          for (int jj = t; jj < wn; jj += kThreads) {
            float v[G];
            rank_sum<G>(cluster, U, c0 + jj, C, v);
            const float inv_csx = 1.f / (cc * a.sx[c0 + jj]);
#pragma unroll
            for (int g = 0; g < G; ++g)
              if (g < live) n1[g] = nanmax(n1[g], fabsf(v[g] * inv_csx));
          }
          put<kAbs, G>(QW, qAtdy, n1);
        }
        cluster.sync();  // the peers have read U
        gather<G>(cluster, U, XN, Wn, n, C);
        __syncthreads();
        {
          // P x: the dual residual and its scale
          float rd[G], npx[G], nq[G];
          zero_g(rd);
          zero_g(npx);
          zero_g(nq);
          product<G, true>(U, a.PsT + c0, n, n, 1, wn, red, [&](int o, const float (&v)[G]) {
            const int j = c0 + o;
            const float inv_csx = 1.f / (cc * a.sx[j]);
            float q[G];
            fetch<G>(a.qs + on(0, j), n, live, q);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              if (g >= live) continue;
              const float px = v[g] * inv_csx;
              const float aty = ATY[o * G + g] * inv_csx;
              const float qv = q[g] * inv_csx;
              rd[g] = nanmax(rd[g], fabsf(px + qv + aty));
              npx[g] = nanmax(npx[g], fabsf(px));
              nq[g] = nanmax(nq[g], fabsf(qv));
            }
          });
          put<kAbs, G>(QW, qRd, rd);
          put<kAbs, G>(QW, qPx, npx);
          put<kAbs, G>(QW, qQv, nq);
        }
        {
          // A x: the primal residual and its scale
          float rp[G], nax[G];
          zero_g(rp);
          zero_g(nax);
          product<G, false>(U, AS, n, 1, ldA, wm, red, [&](int o, const float (&v)[G]) {
            const float inv_sy = 1.f / a.sy[r0 + o];
#pragma unroll
            for (int g = 0; g < G; ++g) {
              if (g >= live) continue;
              const float ax = v[g] * inv_sy;
              const float zu = ZN[o * G + g] * inv_sy;
              rp[g] = nanmax(rp[g], fabsf(ax - zu));
              nax[g] = nanmax(nax[g], fabsf(ax));
            }
          });
          put<kAbs, G>(QW, qRp, rp);
          put<kAbs, G>(QW, qAx, nax);
        }
        __syncthreads();  // U is read no more
        gather<G>(cluster, U, DX, Wn, n, C);
        __syncthreads();
        {
          // P dx
          float npdx[G];
          zero_g(npdx);
          product<G, true>(U, a.PsT + c0, n, n, 1, wn, red, [&](int o, const float (&v)[G]) {
            const float inv_csx = 1.f / (cc * a.sx[c0 + o]);
#pragma unroll
            for (int g = 0; g < G; ++g)
              if (g < live) npdx[g] = nanmax(npdx[g], fabsf(v[g] * inv_csx));
          });
          put<kAbs, G>(QW, qPdx, npdx);
        }
        {
          // A dx against the bounds' rows: its extremes on each kind of row,
          // held against eps_dinf |sx dx| once the cluster has reduced it
          float ru[G], rl[G], rf[G];
#pragma unroll
          for (int g = 0; g < G; ++g) ru[g] = rl[g] = rf[g] = -INF;
          product<G, false>(U, AS, n, 1, ldA, wm, red, [&](int o, const float (&v)[G]) {
            const int j = r0 + o;
            const float inv_sy = 1.f / a.sy[j];
            float lo[G], hi[G];
            fetch<G>(a.l + om(0, j), m, live, lo);
            fetch<G>(a.u + om(0, j), m, live, hi);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              if (g >= live) continue;
              const float adx = v[g] * inv_sy;
              const float lv = lo[g], uv = hi[g];
              if (uv >= INF) ru[g] = nanmax(ru[g], -adx);
              else if (lv <= -INF) rl[g] = nanmax(rl[g], adx);
              else rf[g] = nanmax(rf[g], fabsf(adx));
            }
          });
          put<kNan, G>(QW, qRu, ru);
          put<kNan, G>(QW, qRl, rl);
          put<kNan, G>(QW, qRf, rf);
        }
        __syncthreads();  // QW
        if (t < kNQ * G) {
          // the block's value over its warps in order, then the cluster's
          // over the ranks in order (every block alike)
          const int q = t / G;
          const Kind k = kind_of(q);
          float r = identity(k);
          for (int w = 0; w < kWarps; ++w) r = combine(k, r, QW[(q * kWarps + w) * G + t - q * G]);
          QB[t] = r;
        }
        cluster.sync();
        if (t < kNQ * G) {
          const Kind k = kind_of(t / G);
          float r = identity(k);
          for (int q = 0; q < C; ++q) r = combine(k, r, cluster.map_shared_rank(QB, q)[t]);
          QF[t] = r;
        }
        __syncthreads();
        if (t < G) {
          const int g = t;
          auto F = [&](int q) { return QF[q * G + g]; };
          const float pres_n = F(qRp), dres_n = F(qRd);
          const bool prim_ok = pres_n <= a.eps_abs + a.eps_rel * nanmax(F(qAx), F(qNz));
          const float dscale = nanmax(F(qPx), nanmax(F(qQv), F(qAty)));
          const bool dual_ok = dres_n <= a.eps_abs + a.eps_rel * dscale;
          const float thr = a.eps_pinf * F(qE);
          const float tol = a.eps_dinf * F(qDxn);
          const bool viol = F(qVu) > thr || F(qVl) > thr;
          const bool prim_inf = !viol && nanmax(F(qAtdy), F(qSum)) < thr;
          const bool row_ok = F(qRu) <= tol && F(qRl) <= tol && F(qRf) < tol;
          const bool dual_inf = F(qPdx) <= tol && F(qQdx) <= tol && row_ok;
          const bool diverged = F(qFin) != 0.f;
          nst[g] = diverged ? kUnknown
                   : (prim_ok && dual_ok) ? kOptimal
                   : prim_inf ? kPrimalInf
                   : dual_inf ? kDualInf
                   : kRunning;
          npr[g] = pres_n;
          ndr[g] = dres_n;
        }
      }
      __syncthreads();

      // commit the members still running; the others stay frozen
      for (int p = t; p < wn * G; p += kThreads)
        if (p % G < live && st[p % G] == kRunning) X[p] = XN[p];
      for (int p = t; p < wm * G; p += kThreads)
        if (p % G < live && st[p % G] == kRunning) {
          Z[p] = ZN[p];
          Y[p] = YN[p];
        }
      __syncthreads();
      if (t < G && st[t] == kRunning) {
        its[t] = it + 1;
        if (check) {
          st[t] = nst[t];
          pr[t] = npr[t];
          dr[t] = ndr[t];
        }
      }
      __syncthreads();
    }

    // the group's results
    for (int jj = t; jj < wn; jj += kThreads)
      for (int g = 0; g < live; ++g) a.x[on(g, c0 + jj)] = X[jj * G + g];
    for (int jj = t; jj < wm; jj += kThreads)
      for (int g = 0; g < live; ++g) {
        a.z[om(g, r0 + jj)] = Z[jj * G + g];
        a.y[om(g, r0 + jj)] = Y[jj * G + g];
      }
    if (rank == 0 && t < live) {
      const int b = first + t;
      a.status[b] = st[t] == kRunning ? kMaxIter : st[t];
      a.iters[b] = its[t];
      a.pres[b] = pr[t];
      a.dres[b] = dr[t];
    }
  }
}

// out (cols, rows) = in (rows, cols)', 32 x 32 tiles through shared memory
__global__ void transpose_kernel(const float* __restrict__ in, float* __restrict__ out, int rows,
                                 int cols) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const int i = r0 + r, j = c0 + threadIdx.x;
    if (i < rows && j < cols) tile[r][threadIdx.x] = in[(size_t)i * cols + j];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const int j = c0 + r, i = r0 + threadIdx.x;
    if (i < rows && j < cols) out[(size_t)j * rows + i] = tile[threadIdx.x][r];
  }
}

cudaError_t transpose(const float* in, float* out, int rows, int cols, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((cols + 31) / 32, (rows + 31) / 32, 1);
  cfg.blockDim = dim3(32, 8, 1);
  cfg.stream = s;
  return cudaLaunchKernelEx(&cfg, transpose_kernel, in, out, rows, cols);
}

// How a launch is laid out (qp/cuda_kernel.py's cluster_plan mirrors all but
// the clusters, which the device decides).
struct Plan {
  int C;        // blocks a cluster
  int G;        // problems a cluster advances together
  size_t smem;  // dynamic shared memory a block, bytes
};

// C and G from the shape alone: the widest G of kGroups for which some
// cluster size holds the slices, with the smallest such size; C = 0 where
// none does (the streaming route's shapes).
Plan plan(int n, int m) {
  for (int G : kGroups)
    for (int C : kSizes)
      if (smem_bytes(n, m, C, G) <= kSmemLimit) return Plan{C, G, smem_bytes(n, m, C, G)};
  return Plan{0, 0, 0};
}

template <int G>
cudaLaunchConfig_t config(int C, size_t smem, int clusters, cudaLaunchAttribute* attr,
                          cudaStream_t s) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * clusters, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the clusters of C blocks that can be resident at once (0: none); the
// kernel may then take up to kSmemLimit of dynamic shared memory, whatever
// shape launches it later
template <int G>
cudaError_t resident(int C, size_t smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(admm_shared_cluster_kernel<G>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmemLimit);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(admm_shared_cluster_kernel<G>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<G>(C, smem, 1, attr, 0);
  return cudaOccupancyMaxActiveClusters(out, admm_shared_cluster_kernel<G>, &cfg);
}

// resident<G> once a device and plan (it also sets the kernel's attributes)
cudaError_t resident_clusters(const Plan& p, int* out) {
  static std::mutex lock;
  static std::map<std::tuple<int, int, int, size_t>, int> known;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_tuple(dev, p.C, p.G, p.smem);
  std::lock_guard<std::mutex> hold(lock);
  const auto found = known.find(key);
  if (found != known.end()) {
    *out = found->second;
    return cudaSuccess;
  }
  e = p.G == 4 ? resident<4>(p.C, p.smem, out) : resident<8>(p.C, p.smem, out);
  if (e == cudaSuccess) known[key] = *out;
  return e;
}

template <int G>
cudaError_t launch(const Args& a, const Plan& p, int clusters, cudaStream_t s) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<G>(p.C, p.smem, clusters, attr, s);
  return cudaLaunchKernelEx(&cfg, admm_shared_cluster_kernel<G>, a);
}

}  // namespace

// The layout a launch of B problems of shape (n, m) takes: out[0..4] =
// blocks a cluster, problems a cluster advances together, warps a block,
// dynamic shared memory a block in bytes, clusters the launch runs (as many
// as can be resident, no more than there are groups).  Returns 0, or a CUDA
// error code for a shape no cluster holds or a size the device cannot make
// resident.
extern "C" int admm_shared_cluster_plan(int B, int n, int m, int* out) {
  if (B <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan(n, m);
  if (p.C == 0) return (int)cudaErrorInvalidValue;
  int most = 0;
  const cudaError_t e = resident_clusters(p, &most);
  if (e != cudaSuccess) return (int)e;
  if (most < 1) return (int)cudaErrorInvalidConfiguration;
  const int groups = (B + p.G - 1) / p.G;
  out[0] = p.C;
  out[1] = p.G;
  out[2] = kWarps;
  out[3] = (int)p.smem;
  out[4] = most < groups ? most : groups;
  return 0;
}

// Floats of scratch a launch needs: the work counter (4 floats' room), then
// Ps' (n n).
extern "C" long long admm_shared_cluster_scratch(int B, int n, int m) {
  (void)B;
  (void)m;
  return 4 + (long long)n * n;
}

extern "C" int admm_shared_cluster_launch(
    const float* Minv, const float* As, const float* Ps, const float* rho, const float* sx,
    const float* sy, const float* c, const float* qs, const float* ls, const float* us,
    const float* l, const float* u, const float* x0, const float* z0, const float* y0,
    const int* status0, float* x, float* z, float* y, int* status, int* iters, float* pres,
    float* dres, float* scratch, int B, int n, int m, float alpha, float sigma, float eps_abs,
    float eps_rel, float eps_pinf, float eps_dinf, int max_iter, int stop_check_iter,
    void* stream) {
  if (B <= 0) return 0;
  if (n <= 0 || m <= 0 || stop_check_iter < 1) return (int)cudaErrorInvalidValue;
  int out[5];
  const int planned = admm_shared_cluster_plan(B, n, m, out);
  if (planned != 0) return planned;
  const Plan p{out[0], out[1], (size_t)out[3]};
  cudaStream_t s = (cudaStream_t)stream;
  int* counter = reinterpret_cast<int*>(scratch);
  float* PsT = scratch + 4;
  cudaError_t e = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  e = transpose(Ps, PsT, n, n, s);
  if (e != cudaSuccess) return (int)e;
  Args a{Minv, As, PsT, rho, sx, sy, c, qs, ls, us, l, u, x0, z0, y0, status0,
         x, z, y, status, iters, pres, dres, counter,
         B, n, m, (B + p.G - 1) / p.G,
         alpha, sigma, eps_abs, eps_rel, eps_pinf, eps_dinf, max_iter, stop_check_iter};
  e = p.G == 4 ? launch<4>(a, p, out[4], s) : launch<8>(a, p, out[4], s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
