// Shared-matrix fused ADMM iteration, streaming route: fleets of QPs that
// share one scaled KKT inverse, constraint matrix and cost matrix too large
// for a block's shared memory (max(n, m) > 128: the sparse MPC fleets and the
// long-horizon condensed ones).
//
// Replaces the rest of the TPU kernel smooth_feedback_tpu/qp/pallas_kernel.py::
// _admm_kernel_shared (called through admm_iterate_pallas_shared): every
// shape the JAX package's shared_kernel_fits admits past the resident route
// of csrc/admm_shared.cu (qp/cuda_kernel.py's shared_route decides).  It
// computes the same function as that route: per problem, the ADMM loop
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
// six products at a check), if each block pulls the matrices from L2 seldom
// enough.  Three matrices of 4 n^2 bytes no longer fit a block (1.14 MB at
// n = m = 308, 4.44 MB at 608) but fit the 50 MB L2 many times over.
//
// Design: a block advances G problems together (G = 16, fewer where its
// staging does not fit; plan() below), the TPU kernel's GEMM form on the
// CUDA cores.  Every product is v M with M row-major in device memory.  The
// block's threads form H parts (two where G >= 8 and max(n, m) <= 512, else
// one), part h owning problems h G / H .. (h + 1) G / H - 1; within a part,
// thread t owns output columns t, t + Tc, ... (two a pass, as many passes as
// the widest vector needs) for its part's problems, and walks the input
// rows: a row costs two coalesced loads of matrix entries, which feed 2 G /
// H FMAs, and a broadcast load of those problems' inputs from shared
// memory.  The parts read the same entries, the second from L1, so a block
// reads each matrix from L2 once an iteration for G problems.  Products As' v (zt,
// and A x at a check) and Ps v read transposed copies AsT and PsT, which the
// launch writes into the caller's scratch first (one small transpose kernel
// each).  The product's inputs are staged in shared memory ([row][problem],
// two buffers, one a product's input while the other takes its output); the
// iterates and the check's temporaries live in device memory (the outputs
// x, z, y and the caller's scratch), each entry read and written only by
// the thread that owns its column, so no fence is needed.  Norms and sums
// of a check reduce per thread, then per warp, then over the warps in
// order.  A member's arithmetic depends on nothing but its own data and the
// shape (the thread layout comes from max(n, m) and G, and G from the shape
// alone), not on B or its neighbours in the block; a frozen member keeps
// being computed in lockstep and is not committed.  Members past B in the last block read nothing and
// store nothing.
//
// Summation order, on purpose: every output entry sums its input rows in
// ascending order in runs of 32 rows, each run in one fmaf chain from 0, and
// adds the runs in order to the total.  One chain over 608 rows is the f32
// failure the per-problem streaming route met at (147, 294); runs of 32 keep
// the rounding of a sum to O(32 + k / 32) ulps.
//
// No tensor cores (fp32 FMAs on the CUDA cores: bf16 gave 0 of 2048 Optimal),
// IEEE division, no fast math: the divergence test relies on IEEE inf and
// NaN, and the max propagates NaN like jnp.max.  Not in this version:
// asynchronous copies, double buffering, clusters (PERF.md).
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
constexpr int kMaxWarps = 16;   // __launch_bounds__(512): up to 128 registers a thread
constexpr int kCols = 2;        // output columns a thread owns in one pass
constexpr int kRun = 32;        // rows a partial sum covers
constexpr int kNQ = 16;         // per-problem quantities a check reduces
constexpr size_t kSmemLimit = 232448;  // what one block may hold on an H100

// the quantities a check reduces over the block, per problem
enum Q {
  qNz, qE, qSum, qAty, qAtdy, qDxn, qQdx, qFin, qRd, qPx, qQv, qRp, qAx, qPdx, qRow, qViol
};

struct Args {
  const float* Minv;  // (n, n)
  const float* As;    // (m, n)
  const float* AsT;   // (n, m), scratch
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
  float* x;           // (B, n): the iterates during the loop
  float* z;           // (B, m)
  float* y;           // (B, m)
  int* status;
  int* iters;
  float* pres;
  float* dres;
  float* xn;          // (B, n), scratch: this iteration's x
  float* zn;          // (B, m), scratch
  float* yn;          // (B, m), scratch
  float* aty;         // (B, n), scratch: y As at a check
  int B, n, m, D;     // D = max(n, m)
  float alpha, sigma, eps_abs, eps_rel, eps_pinf, eps_dinf;
  int max_iter, stop_check_iter;
};

// max that propagates NaN, like jnp.max / torch.max
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Warp max of values that are >= +0 or NaN with the sign bit clear: their
// order as unsigned integers is their order as floats with NaN on top.
__device__ __forceinline__ float warp_absmax(float v) {
  return __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(v)));
}

// butterfly sum: every lane ends with the same value
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Q consecutive floats (Q = 2 or a multiple of 4) at an address aligned to
// min(Q, 4) floats, with the widest loads
template <int Q>
__device__ __forceinline__ void load_q(const float* p, float (&b)[Q]) {
  if constexpr (Q % 4 == 0) {
#pragma unroll
    for (int c = 0; c < Q / 4; ++c) {
      const float4 v = reinterpret_cast<const float4*>(p)[c];
      b[4 * c] = v.x;
      b[4 * c + 1] = v.y;
      b[4 * c + 2] = v.z;
      b[4 * c + 3] = v.w;
    }
  } else {
    static_assert(Q == 2, "Q is 2 or a multiple of 4");
    const float2 v = *reinterpret_cast<const float2*>(p);
    b[0] = v.x;
    b[1] = v.y;
  }
}

// Where a thread sits: a block's threads form H equal parts, part h owning
// problems g0 = h G / H .. g0 + G / H - 1 of the block; within its part a
// thread's column lane c0 owns output columns c0, c0 + Tc, ... (Tc threads a
// part).
struct Seat {
  int Tc, c0, g0, Wc;  // threads a part, column lane, first problem, warps a part
};

// acc[c][gg] = sum_{i < k} S[i G + g0 + gg] M[i ld + j_c] for this thread's
// columns j_c = c0 + Tc (q0 + c) of one pass (entries past `cols` read
// column cols - 1 and are not used).  Rows in runs of kRun, each run one
// fmaf chain.
template <int G, int GT>
__device__ __forceinline__ void product(const Seat& st, const float* S,
                                        const float* __restrict__ M, int k, int ld, int cols,
                                        int q0, float (&acc)[kCols][GT]) {
  int off[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) off[c] = min(st.c0 + st.Tc * (q0 + c), cols - 1);
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int g = 0; g < GT; ++g) acc[c][g] = 0.f;
  for (int i0 = 0; i0 < k; i0 += kRun) {
    const int len = min(kRun, k - i0);
    const float* Mr = M + (size_t)i0 * ld;
    const float* Sr = S + (size_t)i0 * G + st.g0;
    float part[kCols][GT];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int g = 0; g < GT; ++g) part[c][g] = 0.f;
#pragma unroll 8
    for (int i = 0; i < len; ++i) {
      float w[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) w[c] = __ldg(Mr + (size_t)i * ld + off[c]);
      float b[GT];
      load_q<GT>(Sr + i * G, b);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int g = 0; g < GT; ++g) part[c][g] = fmaf(b[g], w[c], part[c][g]);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int g = 0; g < GT; ++g) acc[c][g] += part[c][g];
  }
}

// Every pass of one product: fn(j, acc[c]) for each owned column j < cols.
// Threads with no column in a pass skip it (no barrier inside).
template <int G, int GT, class Fn>
__device__ __forceinline__ void product_cols(const Seat& st, const float* S,
                                             const float* __restrict__ M, int k, int ld,
                                             int cols, Fn&& fn) {
  for (int q0 = 0; st.Tc * q0 < cols; q0 += kCols) {
    if (st.c0 + st.Tc * q0 >= cols) continue;
    float acc[kCols][GT];
    product<G, GT>(st, S, M, k, ld, cols, q0, acc);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = st.c0 + st.Tc * (q0 + c);
      if (j < cols) fn(j, acc[c]);
    }
  }
}

// this thread's partials v of its part's problems -> red[q][warp][g] (max of
// |.| or sum)
template <int G, int GT>
__device__ __forceinline__ void put_max(const Seat& st, float* red, int q, const float (&v)[GT]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const float r = warp_absmax(v[g]);
    if (lane == 0) red[(q * kMaxWarps + warp) * G + st.g0 + g] = r;
  }
}

template <int G, int GT>
__device__ __forceinline__ void put_sum(const Seat& st, float* red, int q, const float (&v)[GT]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const float r = warp_sum(v[g]);
    if (lane == 0) red[(q * kMaxWarps + warp) * G + st.g0 + g] = r;
  }
}

// the block's value of quantity q for problem g, over the warps of its part
// in order
template <int G, int GT>
__device__ __forceinline__ float get_max(const Seat& st, const float* red, int q, int g) {
  float r = 0.f;
  const int w0 = g / GT * st.Wc;
  for (int w = w0; w < w0 + st.Wc; ++w) r = nanmax(r, red[(q * kMaxWarps + w) * G + g]);
  return r;
}

template <int G, int GT>
__device__ __forceinline__ float get_sum(const Seat& st, const float* red, int q, int g) {
  float r = 0.f;
  const int w0 = g / GT * st.Wc;
  for (int w = w0; w < w0 + st.Wc; ++w) r += red[(q * kMaxWarps + w) * G + g];
  return r;
}

// G problems a block, in H parts of GT = G / H problems a thread
template <int G, int H>
__global__ void __launch_bounds__(32 * kMaxWarps) admm_shared_stream_kernel(const Args a) {
  constexpr int GT = G / H;
  extern __shared__ __align__(16) float smem[];
  const int n = a.n, m = a.m, D = a.D;
  float* S1 = smem;                  // [row][problem] staging
  float* S2 = S1 + (size_t)D * G;
  float* red = S2 + (size_t)D * G;   // [kNQ][kMaxWarps][G]
  int* st = reinterpret_cast<int*>(red + kNQ * kMaxWarps * G);  // status
  int* its = st + G;
  float* pr = reinterpret_cast<float*>(its + G);
  float* dr = pr + G;
  int* nst = reinterpret_cast<int*>(dr + G);  // this check's status
  float* npr = reinterpret_cast<float*>(nst + G);
  float* ndr = npr + G;
  float* thr = ndr + G;  // eps_pinf E
  float* tol = thr + G;  // eps_dinf |sx dx|

  const int tid = threadIdx.x;
  Seat seat;
  seat.Tc = blockDim.x / H;
  const int h = tid / seat.Tc;
  seat.c0 = tid - h * seat.Tc;
  seat.g0 = h * GT;
  seat.Wc = seat.Tc >> 5;
  const int Tc = seat.Tc, c0 = seat.c0, g0 = seat.g0;
  const float INF = __int_as_float(0x7f800000);
  const float alpha = a.alpha, sigma = a.sigma, c = *a.c;
  const int first = blockIdx.x * G;
  const int live = min(G, a.B - first);  // members past B: not read, not stored
  const int sci = a.stop_check_iter, check_phase = 1 % sci;
  // offsets of member g's n- and m-vectors
  auto on = [&](int g) { return (size_t)(first + g) * n; };
  auto om = [&](int g) { return (size_t)(first + g) * m; };

  if (tid < G) {
    st[tid] = tid < live ? a.status0[first + tid] : kMaxIter;
    its[tid] = 0;
    pr[tid] = INF;
    dr[tid] = INF;
  }
  for (int j = c0; j < D; j += Tc) {
    for (int g = g0; g < g0 + GT && g < live; ++g) {
      if (j < n) a.x[on(g) + j] = a.x0[on(g) + j];
      if (j < m) {
        a.z[om(g) + j] = a.z0[om(g) + j];
        a.y[om(g) + j] = a.y0[om(g) + j];
      }
    }
  }
  __syncthreads();

  for (int it = 0; it < a.max_iter; ++it) {
    bool any_run = false;
#pragma unroll
    for (int g = 0; g < G; ++g) any_run = any_run || st[g] == kRunning;
    if (!any_run) break;

    // S1 = rho z - y
    for (int j = c0; j < m; j += Tc) {
      const float rj = a.rho[j];
#pragma unroll
      for (int gg = 0; gg < GT; ++gg) {
        const int g = g0 + gg;
        S1[j * G + g] = g < live ? rj * a.z[om(g) + j] - a.y[om(g) + j] : 0.f;
      }
    }
    __syncthreads();
    // S2 = rhs = sigma x - qs + (rho z - y) As
    product_cols<G, GT>(seat, S1, a.As, m, n, n, [&](int j, const float (&s)[GT]) {
#pragma unroll
      for (int gg = 0; gg < GT; ++gg) {
        const int g = g0 + gg;
        S2[j * G + g] = g < live ? sigma * a.x[on(g) + j] - a.qs[on(g) + j] + s[gg] : 0.f;
      }
    });
    __syncthreads();
    // S1 = xt = rhs Minv;  xn = alpha xt + (1 - alpha) x
    product_cols<G, GT>(seat, S2, a.Minv, n, n, n, [&](int j, const float (&xt)[GT]) {
#pragma unroll
      for (int gg = 0; gg < GT; ++gg) {
        const int g = g0 + gg;
        S1[j * G + g] = xt[gg];
        if (g < live) a.xn[on(g) + j] = alpha * xt[gg] + (1.f - alpha) * a.x[on(g) + j];
      }
    });
    __syncthreads();
    // zt = xt As': the z and y updates
    product_cols<G, GT>(seat, S1, a.AsT, n, m, m, [&](int j, const float (&zt)[GT]) {
      const float rj = a.rho[j];
#pragma unroll
      for (int gg = 0; gg < GT; ++gg) {
        const int g = g0 + gg;
        if (g >= live) continue;
        const size_t o = om(g) + j;
        const float zo = a.z[o], yo = a.y[o];
        const float zr = alpha * zt[gg] + (1.f - alpha) * zo;
        const float v = zr + yo / rj;
        const float zv = (v != v) ? v : fminf(fmaxf(v, a.ls[o]), a.us[o]);
        a.zn[o] = zv;
        a.yn[o] = yo + rj * (zr - zv);
      }
    });

    const bool check = it % sci == check_phase;
    if (check) {
      __syncthreads();  // S1 is read no more
      float fin[GT];  // 1 where a non-finite iterate was seen
#pragma unroll
      for (int gg = 0; gg < GT; ++gg) fin[gg] = 0.f;
      {
        // ---- y side: S1 = yn, S2 = dy; |z|, E, the certificate's sum
        float nz[GT], e[GT], s[GT];
#pragma unroll
        for (int gg = 0; gg < GT; ++gg) nz[gg] = e[gg] = s[gg] = 0.f;
        for (int j = c0; j < m; j += Tc) {
          const float syj = a.sy[j], inv_sy = 1.f / syj;
#pragma unroll
          for (int gg = 0; gg < GT; ++gg) {
            const int g = g0 + gg;
            float ynv = 0.f, dy = 0.f;
            if (g < live) {
              const size_t o = om(g) + j;
              ynv = a.yn[o];
              dy = ynv - a.y[o];
              nz[gg] = nanmax(nz[gg], fabsf(a.zn[o] * inv_sy));
              const float dy_us = syj * dy / c;
              e[gg] = nanmax(e[gg], fabsf(dy_us));
              const float lv = a.l[o], uv = a.u[o];
              const float ufin = uv >= INF ? 0.f : uv;
              const float lfin = lv <= -INF ? 0.f : lv;
              s[gg] += ufin * fmaxf(0.f, dy_us) + lfin * fminf(0.f, dy_us);
              if (!(fabsf(ynv) < INF)) fin[gg] = 1.f;
            }
            S1[j * G + g] = ynv;
            S2[j * G + g] = dy;
          }
        }
        put_max<G, GT>(seat, red, qNz, nz);
        put_max<G, GT>(seat, red, qE, e);
        put_sum<G, GT>(seat, red, qSum, s);
      }
      __syncthreads();
      {
        // y As (kept for the dual residual) and dy As
        float n1[GT];
#pragma unroll
        for (int gg = 0; gg < GT; ++gg) n1[gg] = 0.f;
        product_cols<G, GT>(seat, S1, a.As, m, n, n, [&](int j, const float (&v)[GT]) {
          const float inv_csx = 1.f / (c * a.sx[j]);
#pragma unroll
          for (int gg = 0; gg < GT; ++gg) {
            const int g = g0 + gg;
            if (g >= live) continue;
            a.aty[on(g) + j] = v[gg];
            n1[gg] = nanmax(n1[gg], fabsf(v[gg] * inv_csx));
          }
        });
        put_max<G, GT>(seat, red, qAty, n1);
#pragma unroll
        for (int gg = 0; gg < GT; ++gg) n1[gg] = 0.f;
        product_cols<G, GT>(seat, S2, a.As, m, n, n, [&](int j, const float (&v)[GT]) {
          const float inv_csx = 1.f / (c * a.sx[j]);
#pragma unroll
          for (int gg = 0; gg < GT; ++gg) n1[gg] = nanmax(n1[gg], fabsf(v[gg] * inv_csx));
        });
        put_max<G, GT>(seat, red, qAtdy, n1);
      }
      __syncthreads();
      {
        // ---- x side: S1 = xn, S2 = dx; |sx dx|, the q'dx sum
        float dxn[GT], qdx[GT];
#pragma unroll
        for (int gg = 0; gg < GT; ++gg) dxn[gg] = qdx[gg] = 0.f;
        for (int j = c0; j < n; j += Tc) {
          const float sxj = a.sx[j], inv_csx = 1.f / (c * sxj);
#pragma unroll
          for (int gg = 0; gg < GT; ++gg) {
            const int g = g0 + gg;
            float xnv = 0.f, dx = 0.f;
            if (g < live) {
              const size_t o = on(g) + j;
              xnv = a.xn[o];
              dx = xnv - a.x[o];
              dxn[gg] = nanmax(dxn[gg], fabsf(sxj * dx));
              qdx[gg] += a.qs[o] * inv_csx * (sxj * dx);
              if (!(fabsf(xnv) < INF)) fin[gg] = 1.f;
            }
            S1[j * G + g] = xnv;
            S2[j * G + g] = dx;
          }
        }
        put_max<G, GT>(seat, red, qDxn, dxn);
        put_sum<G, GT>(seat, red, qQdx, qdx);
        put_max<G, GT>(seat, red, qFin, fin);
      }
      __syncthreads();
      if (tid < G) {
        thr[tid] = a.eps_pinf * get_max<G, GT>(seat, red, qE, tid);
        tol[tid] = a.eps_dinf * get_max<G, GT>(seat, red, qDxn, tid);
      }
      {
        // P x: the dual residual and its scale
        float rd[GT], npx[GT], nq[GT];
#pragma unroll
        for (int gg = 0; gg < GT; ++gg) rd[gg] = npx[gg] = nq[gg] = 0.f;
        product_cols<G, GT>(seat, S1, a.PsT, n, n, n, [&](int j, const float (&v)[GT]) {
          const float inv_csx = 1.f / (c * a.sx[j]);
#pragma unroll
          for (int gg = 0; gg < GT; ++gg) {
            const int g = g0 + gg;
            if (g >= live) continue;
            const size_t o = on(g) + j;
            const float px = v[gg] * inv_csx;
            const float aty = a.aty[o] * inv_csx;
            const float qv = a.qs[o] * inv_csx;
            rd[gg] = nanmax(rd[gg], fabsf(px + qv + aty));
            npx[gg] = nanmax(npx[gg], fabsf(px));
            nq[gg] = nanmax(nq[gg], fabsf(qv));
          }
        });
        put_max<G, GT>(seat, red, qRd, rd);
        put_max<G, GT>(seat, red, qPx, npx);
        put_max<G, GT>(seat, red, qQv, nq);
      }
      {
        // A x: the primal residual and its scale
        float rp[GT], nax[GT];
#pragma unroll
        for (int gg = 0; gg < GT; ++gg) rp[gg] = nax[gg] = 0.f;
        product_cols<G, GT>(seat, S1, a.AsT, n, m, m, [&](int j, const float (&v)[GT]) {
          const float inv_sy = 1.f / a.sy[j];
#pragma unroll
          for (int gg = 0; gg < GT; ++gg) {
            const int g = g0 + gg;
            if (g >= live) continue;
            const float ax = v[gg] * inv_sy;
            const float zu = a.zn[om(g) + j] * inv_sy;
            rp[gg] = nanmax(rp[gg], fabsf(ax - zu));
            nax[gg] = nanmax(nax[gg], fabsf(ax));
          }
        });
        put_max<G, GT>(seat, red, qRp, rp);
        put_max<G, GT>(seat, red, qAx, nax);
      }
      {
        // P dx
        float npdx[GT];
#pragma unroll
        for (int gg = 0; gg < GT; ++gg) npdx[gg] = 0.f;
        product_cols<G, GT>(seat, S2, a.PsT, n, n, n, [&](int j, const float (&v)[GT]) {
          const float inv_csx = 1.f / (c * a.sx[j]);
#pragma unroll
          for (int gg = 0; gg < GT; ++gg) npdx[gg] = nanmax(npdx[gg], fabsf(v[gg] * inv_csx));
        });
        put_max<G, GT>(seat, red, qPdx, npdx);
      }
      __syncthreads();  // thr and tol
      {
        // A dx against the bounds' rows, and the dy direction against them
        float bad[GT], viol[GT];
#pragma unroll
        for (int gg = 0; gg < GT; ++gg) bad[gg] = viol[gg] = 0.f;
        product_cols<G, GT>(seat, S2, a.AsT, n, m, m, [&](int j, const float (&v)[GT]) {
          const float syj = a.sy[j], inv_sy = 1.f / syj;
#pragma unroll
          for (int gg = 0; gg < GT; ++gg) {
            const int g = g0 + gg;
            if (g >= live) continue;
            const size_t o = om(g) + j;
            const float adx = v[gg] * inv_sy;
            const float lv = a.l[o], uv = a.u[o];
            const bool uinf = uv >= INF, linf = lv <= -INF;
            const float t = tol[g];
            bool ok;
            if (uinf) ok = adx >= -t;
            else if (linf) ok = adx <= t;
            else ok = fabsf(adx) < t;
            if (!ok) bad[gg] = 1.f;
            const float dy_us = syj * (a.yn[o] - a.y[o]) / c;
            if ((uinf && dy_us > thr[g]) || (linf && dy_us < -thr[g])) viol[gg] = 1.f;
          }
        });
        put_max<G, GT>(seat, red, qRow, bad);
        put_max<G, GT>(seat, red, qViol, viol);
      }
      __syncthreads();
      if (tid < G) {
        const int g = tid;
        auto mx = [&](int q) { return get_max<G, GT>(seat, red, q, g); };
        auto sm = [&](int q) { return get_sum<G, GT>(seat, red, q, g); };
        const float pres_n = mx(qRp), dres_n = mx(qRd);
        const bool prim_ok = pres_n <= a.eps_abs + a.eps_rel * nanmax(mx(qAx), mx(qNz));
        const float dscale = nanmax(mx(qPx), nanmax(mx(qQv), mx(qAty)));
        const bool dual_ok = dres_n <= a.eps_abs + a.eps_rel * dscale;
        const bool prim_inf = mx(qViol) == 0.f && nanmax(mx(qAtdy), sm(qSum)) < thr[g];
        const bool dual_inf = mx(qPdx) <= tol[g] && sm(qQdx) <= tol[g] && mx(qRow) == 0.f;
        const bool diverged = mx(qFin) != 0.f;
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
    for (int j = c0; j < D; j += Tc) {
#pragma unroll
      for (int gg = 0; gg < GT; ++gg) {
        const int g = g0 + gg;
        if (g >= live || st[g] != kRunning) continue;
        if (j < n) a.x[on(g) + j] = a.xn[on(g) + j];
        if (j < m) {
          a.z[om(g) + j] = a.zn[om(g) + j];
          a.y[om(g) + j] = a.yn[om(g) + j];
        }
      }
    }
    __syncthreads();
    if (tid < G && st[tid] == kRunning) {
      its[tid] = it + 1;
      if (check) {
        st[tid] = nst[tid];
        pr[tid] = npr[tid];
        dr[tid] = ndr[tid];
      }
    }
    __syncthreads();
  }

  if (tid < live) {
    const int b = first + tid;
    a.status[b] = st[tid] == kRunning ? kMaxIter : st[tid];
    a.iters[b] = its[tid];
    a.pres[b] = pr[tid];
    a.dres[b] = dr[tid];
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
  const dim3 grid((cols + 31) / 32, (rows + 31) / 32), block(32, 8);
  transpose_kernel<<<grid, block, 0, s>>>(in, out, rows, cols);
  return cudaGetLastError();
}

// How a launch is laid out (qp/cuda_kernel.py's shared_plan mirrors it).
struct Plan {
  int G;        // problems a block advances together
  int H;        // parts the block's threads form, G / H problems each
  int warps;    // warps a block
  size_t smem;  // dynamic shared memory a block, bytes
};

// Parts of a block of G problems over a widest vector of D: two (G / 2
// problems a thread, so no more than 8 problems' sums in registers) where G
// >= 8 and each part still covers D in one pass of at most 8 warps, else one.
// shared_stream_variants.py on an H100 80GB HBM3 at 700 W, 20 iterations at
// bench.py's sweep sizes: two parts 3.311 ms against one part's 4.438 at D =
// 158, 1.409 against 3.000 at 200, 4.121 against 6.389 at 302.  At 602 each
// of two parts would need two passes of 8 warps; one part of 10 warps covers
// it in one, and is what runs there.
int parts(int G, int D) {
  return G >= 8 && (D + kCols - 1) / kCols <= 32 * (kMaxWarps / 2) ? 2 : 1;
}

// two staging buffers of max(n, m) rows of G floats, the check's partials,
// nine per-problem scalars
size_t stream_smem(int D, int G) {
  return 4 * (2 * (size_t)D * G + (size_t)kNQ * kMaxWarps * G + 9 * (size_t)G);
}

// G: the widest of 16, 8, 4, 2 whose block fits; 0 where none does.  The
// warps: in each of the H parts, enough for two columns a thread of the
// widest vector in as few passes as 16 / H warps a part allow, spread evenly
// over the passes.
Plan plan(int n, int m) {
  const int D = n > m ? n : m;
  Plan p{0, 1, 0, 0};
  for (int G = 16; G >= 2; G /= 2) {
    if (stream_smem(D, G) <= kSmemLimit) {
      p.G = G;
      p.smem = stream_smem(D, G);
      break;
    }
  }
  p.H = parts(p.G, D);
  const int threads = (D + kCols - 1) / kCols;      // a part's, in one pass
  const int most = 32 * (kMaxWarps / p.H);           // a part's threads at most
  const int passes = (threads + most - 1) / most;
  p.warps = p.H * ((threads + 32 * passes - 1) / (32 * passes));
  return p;
}

template <int G, int H>
cudaError_t launch(const Args& a, const Plan& p, cudaStream_t stream) {
  if (p.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(admm_shared_stream_kernel<G, H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return e;
  }
  const int grid = (a.B + G - 1) / G;
  admm_shared_stream_kernel<G, H><<<grid, 32 * p.warps, p.smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The layout a launch of B problems of shape (n, m) takes: out[0..3] =
// problems a block advances together (all of them in lockstep), problems a
// block, warps a block, dynamic shared memory in bytes.  Returns 0, or a
// CUDA error code for a shape no block holds.
extern "C" int admm_shared_stream_plan(int B, int n, int m, int* out) {
  if (B <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan(n, m);
  if (p.G == 0) return (int)cudaErrorInvalidValue;
  out[0] = p.G;
  out[1] = p.G;
  out[2] = p.warps;
  out[3] = (int)p.smem;
  return 0;
}

// Floats of scratch a launch needs, in this order: As' (n m), Ps' (n n),
// then for each problem this iteration's x (n), z (m), y (m) and y As at a
// check (n).
extern "C" long long admm_shared_stream_scratch(int B, int n, int m) {
  return (long long)n * m + (long long)n * n + (long long)B * (2 * n + 2 * m);
}

extern "C" int admm_shared_stream_launch(
    const float* Minv, const float* As, const float* Ps, const float* rho, const float* sx,
    const float* sy, const float* c, const float* qs, const float* ls, const float* us,
    const float* l, const float* u, const float* x0, const float* z0, const float* y0,
    const int* status0, float* x, float* z, float* y, int* status, int* iters, float* pres,
    float* dres, float* scratch, int B, int n, int m, float alpha, float sigma, float eps_abs,
    float eps_rel, float eps_pinf, float eps_dinf, int max_iter, int stop_check_iter,
    void* stream) {
  if (B <= 0) return 0;
  if (n <= 0 || m <= 0 || stop_check_iter < 1) return (int)cudaErrorInvalidValue;
  const Plan p = plan(n, m);
  if (p.G == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* AsT = scratch;
  float* PsT = AsT + (size_t)n * m;
  float* xn = PsT + (size_t)n * n;
  float* zn = xn + (size_t)B * n;
  float* yn = zn + (size_t)B * m;
  float* aty = yn + (size_t)B * m;
  cudaError_t e = transpose(As, AsT, m, n, s);
  if (e != cudaSuccess) return (int)e;
  e = transpose(Ps, PsT, n, n, s);
  if (e != cudaSuccess) return (int)e;
  Args a{Minv, As, AsT, PsT, rho, sx, sy, c, qs, ls, us, l, u, x0, z0, y0, status0,
         x, z, y, status, iters, pres, dres, xn, zn, yn, aty,
         B, n, m, n > m ? n : m,
         alpha, sigma, eps_abs, eps_rel, eps_pinf, eps_dinf, max_iter, stop_check_iter};
  switch (p.G) {
    case 16: e = p.H == 2 ? launch<16, 2>(a, p, s) : launch<16, 1>(a, p, s); break;
    case 8: e = p.H == 2 ? launch<8, 2>(a, p, s) : launch<8, 1>(a, p, s); break;
    case 4: e = launch<4, 1>(a, p, s); break;
    default: e = launch<2, 1>(a, p, s); break;
  }
  return (int)e;
}
