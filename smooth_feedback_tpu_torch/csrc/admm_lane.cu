// The lane backend's whole solve for fleets of tiny per-problem QPs (the
// ASIF safety filter's n = 3, m = 53) in one launch: scaling, per-row rho,
// factorization, the ADMM loop with adaptive rho and its refactorizations,
// and the unscaled solution.
//
// Replaces no TPU kernel: the JAX package runs this backend
// (smooth_feedback_tpu/qp/solver.py::_solve_qp_batch_lane, :645-846, with
// _factorize_lane :463, _ruiz_lane :415 and _finalize_solution :1192) as one
// compiled XLA program over batch-trailing stacks, and that program's
// counterpart here is one kernel.  Per problem b, from the unscaled P, q, A,
// l, u (each with a batch stride, 0 for a field the batch shares):
//
//   prologue  modified-Ruiz equilibration (c, sx, sy; up to 11 sweeps, each
//             member stopping on its own, which is the batch loop's function
//             since a member that stops never changes again), per-row rho
//             (1e-6 on rows free on both sides, rho_eq_scale rho on equality
//             rows), As = Sy A Sx, qs, ls, us, the scaled warm start (x0 =
//             x_w / sx, y0 = c y_w / sy, z0 = sy A x_w) and the trivial
//             infeasibility status; then Mred = Ps + sigma I + As' diag(rho)
//             As and Minv = Mred^-1 by Cholesky (a factor that is not finite
//             makes a running member Unknown).  Given factors (c, sx, sy,
//             rho, Ps, As, Mred, Minv, fact_ok) skip all of it but the
//             scaled vectors and the warm start.
//   loop      rhs = sigma x - qs + As' (rho z - y), xt = Minv rhs (+ refine
//             sweeps xt += Minv (rhs - Mred xt)), zt = As xt, the relaxed
//             x, z clipped to [ls, us], y; every stop_check_iter-th
//             iteration (it % k == 1 % k) the check on the UNSCALED data
//             (plain or compensated residuals, both certificates, the
//             non-finite test); with adaptive rho a running member whose
//             normalized residual balance leaves [1/tol, tol] takes rho <-
//             clip(rho sqrt(ratio), 1e-6, 1e6) (free rows stay at 1e-6) and
//             refactorizes, keeping the previous rho and factors when the
//             new factor is not finite.  The JAX package refactorizes the
//             whole fleet when any member adapts; a member that does not
//             adapt gets its own factors back, so refactorizing the adapting
//             members alone is the same function (PERF.md states the two
//             rounding-level exceptions).
//   epilogue  primal = sx x, dual = sy y / c, objective = x'(P x / 2 + q),
//             and, when asked (polish runs after, in torch), the scaled
//             iterates and the scalings.
//
// What bounds it on an H100: neither bytes nor FMAs.  The ASIF fleet (B =
// 256, n = 3, m = 53) reads 0.2 MB (0.07 us at 3.35 TB/s) and needs a few
// hundred kFLOP a solve; what a warp waits on is the chain of dependent
// products of each iteration.
//
// Design: one warp per problem, as many problems a block as fit (at most 8)
// and no more than it takes to give every SM a block: a problem's time is
// its warp's dependent chain, and an SM's four schedulers take a warp each.
// A warp keeps As, Minv, Mred, two matrices of refactorization scratch and
// every vector in shared memory at the odd row stride n | 1 (lanes walking
// rows or columns hit distinct banks), and where a block has room also the
// unscaled P and A (then a check reads no device memory; where not, P and A
// are read from device memory, L1/L2, as the checks and the Ruiz sweeps
// need them).
//
// Up to n = 8 (the register path, one instantiation for each n, so that no
// product carries a bound check) every lane works on every product: a lane
// owns the rows i = lane, lane + 32, ... and keeps x, xt, rhs, qs and Minv
// in registers, replicated in every lane.  An iteration is one pass over
// the lane's own rows, two at a time (rows i and i + 32 loaded, updated and
// stored together so their chains overlap: zt_i = As_i xt, the z and y
// updates, and w_i = rho_i z_i - y_i with its n partial sums of As' w for
// the next iteration), a butterfly sum of those n partials across the warp,
// and Minv rhs in registers: no shared-memory traffic between lanes and no
// __syncwarp in the loop.  Each per-row quotient takes a reciprocal kept
// beside its divisor (1 / rho, renewed with rho; 1 / sy; 1 / c), so no
// division sits in the loop.  A check makes its own pass over the rows (it
// keeps the previous y_i), where A' y and A' dy are partial sums over the
// lane's rows summed the same way; their compensated forms carry (hi, lo)
// pairs combined across lanes with two_sum (error-free, so the pair is the
// same in every lane).  The Ruiz sweeps take the column maxima the same
// way, and a (re)factorization sums As' diag(rho) As over the lane's rows,
// then every lane runs the Cholesky factor and the inverse in registers.
// Above n = 8 a lane owns outputs: rows for As x,
// columns for As' v, each a dot product in four interleaved partial sums
// added pairwise (one f32 chain over m = 294 rows drifted from float64 in
// csrc/admm_problem.cu), the warp synchronising between products with
// __syncwarp; the Cholesky is right-looking in shared memory, a lane per
// row below the pivot, the inverse a forward and a backward substitution a
// column, a lane per column.  Norms and sums are butterfly reductions, so
// every lane holds bit-identical results and the loop control is
// warp-uniform.  IEEE f32 throughout: the max propagates NaN like jnp.max,
// and the compensated transforms use __fmul_rn, __fmaf_rn and __fadd_rn so
// that no contraction can break them.
//
// With a clock buffer, one member's warp adds clock64() cycles to six phase
// sums (prologue, factorization, iterations without a check, iterations with
// one, refactorizations, epilogue) and counts the two kinds of iterations.
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
constexpr int kMaxWarps = 8;  // problems a block, __launch_bounds__(256)
constexpr int kVecN = 9;      // n-vectors a problem keeps
constexpr int kVecM = 14;     // m-vectors a problem keeps
constexpr int kSMs = 132;
constexpr size_t kSmemLimit = 232448;  // what one block may hold on an H100
constexpr int kMaxRuiz = 10;           // _ruiz_lane's max_ruiz_iter
constexpr int kSmallMax = 8;  // the register path's widest n (an instantiation each n)
constexpr int kClocks = 8;

enum { kClkPrologue, kClkFactor, kClkIter, kClkCheckIter, kClkRefactor, kClkEpilogue,
       kClkIters, kClkChecks };

struct Args {
  // the unscaled problem: P (n, n), q (n), A (m, n), l, u (m) a member, each
  // with its batch stride in floats (0: shared by the batch)
  const float *P, *q, *A, *l, *u;
  // the unscaled warm start (primal (n), dual (m) a member) or null
  const float *xw, *yw;
  // given per-problem factors (batch-leading, contiguous) or null
  const float *fc, *fsx, *fsy, *frho, *fPs, *fAs, *fMred, *fMinv;
  const unsigned char* fok;
  // the solution, batch-leading
  float *primal, *dual, *objective, *pres, *dres;
  int *status, *iters, *refactors, *sweeps;
  // the scaled iterates and the scalings, or null
  float *x, *z, *y, *c, *sx, *sy;
  long long* clocks;  // kClocks sums of member clock_b's warp, or null
  long long bP, bq, bA, bl, bu, bxw, byw;
  int clock_b, B, n, m, ppb, resident;
  float alpha, sigma, rho, rho_eq, eps_abs, eps_rel, eps_pinf, eps_dinf, rho_tol;
  int max_iter, stop_check_iter, refine, adaptive, compensated, scaling;
};

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// floats of shared memory one problem keeps (qp/cuda_kernel.py's
// lane_problem_bytes mirrors it): As, Minv, Mred and two scratch matrices at
// row stride n | 1, with ``resident`` also the unscaled P and A there, then
// the vectors
__host__ __device__ inline int problem_floats(int n, int m, int resident) {
  const int ld = n | 1;
  return round4(ld * (m + 4 * n) + (resident ? ld * (n + m) : 0) + kVecN * n + kVecM * m);
}

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

// max / min that skip NaN (the certificates' one-sided row tests)
__device__ __forceinline__ float warp_fmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_fmin(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// sum_k a[k sa] b[k sb] for k < len, in four interleaved partial sums
// added pairwise
__device__ __forceinline__ float dot4(const float* a, int sa, const float* b, int sb, int len) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int k = 0;
  for (; k + 4 <= len; k += 4) {
    s0 = fmaf(a[k * sa], b[k * sb], s0);
    s1 = fmaf(a[(k + 1) * sa], b[(k + 1) * sb], s1);
    s2 = fmaf(a[(k + 2) * sa], b[(k + 2) * sb], s2);
    s3 = fmaf(a[(k + 3) * sa], b[(k + 3) * sb], s3);
  }
  if (k < len) s0 = fmaf(a[k * sa], b[k * sb], s0);
  if (k + 1 < len) s1 = fmaf(a[(k + 1) * sa], b[(k + 1) * sb], s1);
  if (k + 2 < len) s2 = fmaf(a[(k + 2) * sa], b[(k + 2) * sb], s2);
  return (s0 + s2) + (s1 + s3);
}

// ---- error-free transforms (utils/compensated.py), never contracted
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  const float t = __fadd_rn(a, b);
  const float bp = __fsub_rn(t, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(t, bp)), __fsub_rn(b, bp));
  s = t;
}

__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  const float t = __fmul_rn(a, b);
  e = __fmaf_rn(a, b, -t);
  p = t;
}

// one step of the compensated dot product (Ogita-Rump-Oishi Dot2): (s, c)
// += a b, s the running sum, c its accumulated rounding errors
__device__ __forceinline__ void dot2_step(float a, float b, float& s, float& c) {
  float p, pe, t, e;
  two_prod(a, b, p, pe);
  two_sum(s, p, t, e);
  s = t;
  c = __fadd_rn(c, __fadd_rn(e, pe));
}

// hi + lo = sum_k a[k sa] b[k sb] to ~eps^2 relative accumulation error
__device__ __forceinline__ void cdot(const float* a, int sa, const float* b, int sb, int len,
                                     float& hi, float& lo) {
  float s = 0.f, c = 0.f;
  for (int k = 0; k < len; ++k) dot2_step(a[k * sa], b[k * sb], s, c);
  hi = s;
  lo = c;
}

// (s, c) of every lane summed across the warp: two_sum of the running sums,
// their errors added to the corrections.  two_sum's error is exact, so both
// lanes of a pair compute the same (s, c) and every lane ends with it.
__device__ __forceinline__ void warp_dot2(float& s, float& c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float so = __shfl_xor_sync(kFull, s, o), co = __shfl_xor_sync(kFull, c, o);
    float t, e;
    two_sum(s, so, t, e);
    s = t;
    c = __fadd_rn(__fadd_rn(c, co), e);
  }
}
// ---- end of the error-free transforms

struct Clock {
  bool on;
  long long t, sum[kClocks];
  __device__ void start() {
    if (on) {
      for (int k = 0; k < kClocks; ++k) sum[k] = 0;
      t = clock64();
    }
  }
  __device__ void lap(int k) {
    if (on) {
      const long long now = clock64();
      sum[k] += now - t;
      t = now;
    }
  }
  __device__ void count(int k) {
    if (on) ++sum[k];
  }
};

// One problem's warp: its shared memory, where its unscaled P and A are, and
// its scalars.
struct Prob {
  float *As, *Minv, *Mred, *S1, *S2;
  float *x, *xn, *qs, *q, *sx, *rhs, *xt, *t1, *t2;
  float *z, *zn, *y, *yn, *ls, *us, *lv, *uv, *rho, *rho_new, *sy, *w, *m1, *m2;
  const float *P, *A;  // unscaled, at row strides pld and ald
  const float* gPs;    // given scaled P (row stride n) or null: c sx P sx on the fly
  float c;
  int n, m, ld, pld, ald, lane;

  // the scaled P, Ps = c Sx P Sx, in the JAX package's order of products
  __device__ __forceinline__ float ps(int j, int k) const {
    return gPs ? gPs[j * n + k] : ((c * sx[j]) * sx[k]) * P[j * pld + k];
  }
};

// ---------------------------------------------------------------- prologue

// c = 1 / max(1e-6, max(mean of P's column maxima (0 -> 1), |q|_inf))
__device__ float cost_scale(const Prob& p) {
  float s = 0.f, qm = 0.f;
  for (int j = p.lane; j < p.n; j += 32) {
    float cm = 0.f;
    for (int i = 0; i < p.n; ++i) cm = nanmax(cm, fabsf(p.P[i * p.pld + j]));
    s += cm == 0.f ? 1.f : cm;
    qm = nanmax(qm, fabsf(p.q[j]));
  }
  s = warp_sum(s);
  qm = warp_max(qm);
  return 1.f / nanmax(1e-6f, nanmax(s / (float)p.n, qm));
}

// the Ruiz sweep's row maximum of |sy_i A_i sx| (0 -> 1)
__device__ __forceinline__ float ruiz_row(const Prob& p, int i, const float* sx) {
  const float syi = p.sy[i];
  const float* Ai = p.A + i * p.ald;
  float r = 0.f;
  for (int j = 0; j < p.n; ++j) r = nanmax(r, fabsf((syi * Ai[j]) * sx[j]));
  return r == 0.f ? 1.f : r;
}

// Modified-Ruiz sweeps with lanes over rows (sy_inc) and over columns
// (sx_inc), sx and sy in shared memory.  Returns the sweeps run.
__device__ int ruiz_general(Prob& p) {
  const int n = p.n, m = p.m, lane = p.lane;
  for (int j = lane; j < n; j += 32) p.sx[j] = 1.f;
  for (int i = lane; i < m; i += 32) p.sy[i] = 1.f;
  __syncwarp();
  float err = __int_as_float(0x7f800000);
  int it = 0;
  for (; it == 0 || (it <= kMaxRuiz && err > 0.1f); ++it) {
    float e = 0.f;
    for (int i = lane; i < m; i += 32) {
      const float r = ruiz_row(p, i, p.sx);
      p.w[i] = r;
      e = nanmax(e, fabsf(r - 1.f));
    }
    for (int j = lane; j < n; j += 32) {
      const float sxj = p.sx[j];
      float cm = 0.f;
      for (int i = 0; i < n; ++i) cm = nanmax(cm, fabsf(((p.c * p.sx[i]) * sxj) * p.P[i * p.pld + j]));
      for (int i = 0; i < m; ++i) cm = nanmax(cm, fabsf((p.sy[i] * p.A[i * p.ald + j]) * sxj));
      cm = cm == 0.f ? 1.f : cm;
      p.t1[j] = cm;
      e = nanmax(e, fabsf(cm - 1.f));
    }
    err = warp_max(e);
    __syncwarp();
    for (int j = lane; j < n; j += 32) p.sx[j] *= 1.f / sqrtf(nanmax(p.t1[j], 1e-8f));
    for (int i = lane; i < m; i += 32) p.sy[i] *= 1.f / sqrtf(nanmax(p.w[i], 1e-8f));
    __syncwarp();
  }
  return it;
}

// The same sweeps with every lane on every product (n = N): a lane takes
// the row maxima of its own rows and partial column maxima, the P part is
// replicated in every lane, and a butterfly max gives every lane sx_inc; a
// lane reads and writes sy of its own rows only.  sx ends in shared memory.
template <int N>
__device__ int ruiz_small(Prob& p) {
  const int m = p.m, lane = p.lane;
  float sx[N];
#pragma unroll
  for (int j = 0; j < N; ++j) sx[j] = 1.f;
  for (int i = lane; i < m; i += 32) p.sy[i] = 1.f;
  float err = __int_as_float(0x7f800000);
  int it = 0;
  for (; it == 0 || (it <= kMaxRuiz && err > 0.1f); ++it) {
    float cm[N], e = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      cm[j] = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i)
        cm[j] = nanmax(cm[j], fabsf(((p.c * sx[i]) * sx[j]) * p.P[i * p.pld + j]));
    }
    for (int i = lane; i < m; i += 32) {
      const float syi = p.sy[i];
      const float* Ai = p.A + i * p.ald;
      float r = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float v = fabsf((syi * Ai[j]) * sx[j]);
        r = nanmax(r, v);
        cm[j] = nanmax(cm[j], v);
      }
      r = r == 0.f ? 1.f : r;
      p.w[i] = r;
      e = nanmax(e, fabsf(r - 1.f));
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float v = warp_max(cm[j]);
      v = v == 0.f ? 1.f : v;
      e = nanmax(e, fabsf(v - 1.f));
      sx[j] *= 1.f / sqrtf(nanmax(v, 1e-8f));
    }
    err = warp_max(e);
    for (int i = lane; i < m; i += 32) p.sy[i] *= 1.f / sqrtf(nanmax(p.w[i], 1e-8f));
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j == lane) p.sx[j] = sx[j];
  __syncwarp();
  return it;
}

// Per-row rho, ls, us, As (and the row test of trivial infeasibility), qs.
// Returns whether some row is trivially infeasible.
__device__ bool scale_rows(const Args& a, Prob& p, bool given) {
  const int n = p.n, m = p.m, ld = p.ld, lane = p.lane;
  const float INF = __int_as_float(0x7f800000);
  bool bad = false;
  for (int i = lane; i < m; i += 32) {
    const float li = p.lv[i], ui = p.uv[i], syi = p.sy[i];
    if (!given) {
      // NaN (inf - inf) compares False => inequality row
      const bool unbounded = li == -INF && ui == INF;
      const bool eq = syi * fabsf(li - ui) < 1e-5f;
      p.rho[i] = unbounded ? 1e-6f : (eq ? a.rho_eq : a.rho);
      const float* Ai = p.A + i * p.ald;
      for (int j = 0; j < n; ++j) p.As[i * ld + j] = (syi * Ai[j]) * p.sx[j];
    }
    p.ls[i] = syi * li;
    p.us[i] = syi * ui;
    bad |= li == INF || ui == -INF || (ui - li) < 0.f;
  }
  for (int j = lane; j < n; j += 32) p.qs[j] = (p.c * p.sx[j]) * p.q[j];
  __syncwarp();
  return __any_sync(kFull, bad);
}

// The scaled warm start, or zeros.
__device__ void warm_start(const Args& a, Prob& p, int b) {
  const int n = p.n, m = p.m, lane = p.lane;
  if (a.xw) {
    const float* xw = a.xw + b * a.bxw;
    const float* yw = a.yw + b * a.byw;
    for (int j = lane; j < n; j += 32) {
      p.t2[j] = xw[j];
      p.x[j] = xw[j] / p.sx[j];
    }
    __syncwarp();
    for (int i = lane; i < m; i += 32) {
      p.y[i] = (p.c * yw[i]) / p.sy[i];
      p.z[i] = p.sy[i] * dot4(p.A + i * p.ald, 1, p.t2, 1, n);
    }
  } else {
    for (int j = lane; j < n; j += 32) p.x[j] = 0.f;
    for (int i = lane; i < m; i += 32) p.z[i] = p.y[i] = 0.f;
  }
  __syncwarp();
}

// ------------------------------------------------------------ factorization

// Refactorize at rho_src with lanes over entries (n > 8): S1 = Ps + sigma I +
// As' diag(rho_src) As, its Cholesky factor in S2 (right-looking, a lane per
// row below the pivot), and, when every entry of the factor is finite, Minv
// = L^-T L^-1 (a forward and a backward substitution a column, a lane per
// column) and Mred <-> S1.  Returns false, changing neither Minv nor Mred,
// when the factor is not finite.  Starts and ends with the warp
// synchronised.
__device__ bool refactor_general(Prob& p, const float* rho_src, float sigma) {
  const int n = p.n, m = p.m, ld = p.ld, lane = p.lane;
  const float* As = p.As;
  float *S1 = p.S1, *S2 = p.S2, *Minv = p.Minv;
  for (int e = lane; e < n * n; e += 32) {
    const int j = e / n, k = e - j * n;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    int i = 0;
    for (; i + 4 <= m; i += 4) {
      s0 = fmaf(As[i * ld + j] * rho_src[i], As[i * ld + k], s0);
      s1 = fmaf(As[(i + 1) * ld + j] * rho_src[i + 1], As[(i + 1) * ld + k], s1);
      s2 = fmaf(As[(i + 2) * ld + j] * rho_src[i + 2], As[(i + 2) * ld + k], s2);
      s3 = fmaf(As[(i + 3) * ld + j] * rho_src[i + 3], As[(i + 3) * ld + k], s3);
    }
    if (i < m) s0 = fmaf(As[i * ld + j] * rho_src[i], As[i * ld + k], s0);
    if (i + 1 < m) s1 = fmaf(As[(i + 1) * ld + j] * rho_src[i + 1], As[(i + 1) * ld + k], s1);
    if (i + 2 < m) s2 = fmaf(As[(i + 2) * ld + j] * rho_src[i + 2], As[(i + 2) * ld + k], s2);
    const float v = (p.ps(j, k) + (j == k ? sigma : 0.f)) + ((s0 + s2) + (s1 + s3));
    S1[j * ld + k] = v;
    S2[j * ld + k] = v;
  }
  __syncwarp();
  for (int j = 0; j < n; ++j) {
    const float d = sqrtf(S2[j * ld + j]);  // every lane reads the same word
    const float inv_d = 1.f / d;
    __syncwarp();
    if (lane == 0) S2[j * ld + j] = d;
    for (int i = j + 1 + lane; i < n; i += 32) S2[i * ld + j] *= inv_d;
    __syncwarp();
    for (int i = j + 1 + lane; i < n; i += 32) {
      const float lij = S2[i * ld + j];
      for (int k = j + 1; k <= i; ++k) S2[i * ld + k] = fmaf(-lij, S2[k * ld + j], S2[i * ld + k]);
    }
    __syncwarp();
  }
  bool bad = false;
  for (int i = lane; i < n; i += 32)
    for (int k = 0; k <= i; ++k) bad |= !isfinite(S2[i * ld + k]);
  if (__any_sync(kFull, bad)) return false;
  for (int col = lane; col < n; col += 32) {
    for (int i = 0; i < n; ++i) {  // L Y = e_col
      float acc = i == col ? 1.f : 0.f;
      for (int j = 0; j < i; ++j) acc = fmaf(-S2[i * ld + j], Minv[j * ld + col], acc);
      Minv[i * ld + col] = acc / S2[i * ld + i];
    }
    for (int i = n - 1; i >= 0; --i) {  // L' X = Y
      float acc = Minv[i * ld + col];
      for (int j = i + 1; j < n; ++j) acc = fmaf(-S2[j * ld + i], Minv[j * ld + col], acc);
      Minv[i * ld + col] = acc / S2[i * ld + i];
    }
  }
  p.S1 = p.Mred;
  p.Mred = S1;
  __syncwarp();
  return true;
}

// Refactorize at rho_src with every lane on every product (n = N): each
// lane sums As' diag(rho) As over its own rows (the lower triangle), a
// butterfly sum gives every lane the whole of it, and every lane factors
// it (chol_lane's left-looking order) and inverts it (chol_solve_lane's
// substitutions) in registers.  When every entry of the factor is finite,
// Minv (registers) and Mred (shared memory) take the new matrices and it
// returns true; otherwise it changes neither.  Reads rho_src of the lane's
// own rows only; ends with the warp synchronised.
template <int N>
__device__ bool refactor_small(const Prob& p, const float* rho_src, float sigma,
                               float (&Mi)[N * N]) {
  constexpr int T = N * (N + 1) / 2;
  const int m = p.m, ld = p.ld, lane = p.lane;
  float L[T];
#pragma unroll
  for (int t = 0; t < T; ++t) L[t] = 0.f;
  for (int i = lane; i < m; i += 32) {
    const float* Asi = p.As + i * ld;
    const float ri = rho_src[i];
    float ar[N];
#pragma unroll
    for (int j = 0; j < N; ++j) ar[j] = Asi[j];
#pragma unroll
    for (int j = 0, t = 0; j < N; ++j)
#pragma unroll
      for (int k = 0; k <= j; ++k, ++t) L[t] = fmaf(ar[j] * ri, ar[k], L[t]);
  }
#pragma unroll
  for (int j = 0, t = 0; j < N; ++j)
#pragma unroll
    for (int k = 0; k <= j; ++k, ++t) {
      const float s = warp_sum(L[t]);
      L[t] = (p.ps(j, k) + (j == k ? sigma : 0.f)) + s;
    }
  // Mred (lower triangle mirrored), written once the factor is known good
  float M[T];
#pragma unroll
  for (int t = 0; t < T; ++t) M[t] = L[t];
  bool bad = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int jj = j * (j + 1) / 2;
    float acc = L[jj + j];
#pragma unroll
    for (int k = 0; k < j; ++k) acc = acc - L[jj + k] * L[jj + k];
    const float d = sqrtf(acc);
    L[jj + j] = d;
    const float inv_d = 1.f / d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      const int ii = i * (i + 1) / 2;
      float a2 = L[ii + j];
#pragma unroll
      for (int k = 0; k < j; ++k) a2 = a2 - L[ii + k] * L[jj + k];
      L[ii + j] = a2 * inv_d;
    }
  }
#pragma unroll
  for (int t = 0; t < T; ++t) bad |= !isfinite(L[t]);
  if (bad) return false;  // warp-uniform: every lane holds the same factor
#pragma unroll
  for (int col = 0; col < N; ++col) {
    float yv[N], xv[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {  // L Y = e_col
      const int ii = i * (i + 1) / 2;
      float acc = i == col ? 1.f : 0.f;
#pragma unroll
      for (int j = 0; j < i; ++j) acc = acc - L[ii + j] * yv[j];
      yv[i] = acc / L[ii + i];
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {  // L' X = Y
      float acc = yv[i];
#pragma unroll
      for (int j = i + 1; j < N; ++j) acc = acc - L[j * (j + 1) / 2 + i] * xv[j];
      xv[i] = acc / L[i * (i + 1) / 2 + i];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) Mi[i * N + col] = xv[i];
  }
#pragma unroll
  for (int j = 0, t = 0; j < N; ++j)
#pragma unroll
    for (int k = 0; k <= j; ++k, ++t)
      if (((j * N + k) & 31) == lane) {
        p.Mred[j * ld + k] = M[t];
        p.Mred[k * ld + j] = M[t];
      }
  __syncwarp();
  return true;
}

// ------------------------------------------------------------------- loops

struct LoopOut {
  int status, iters, nref;
  float pres, dres;
};

// the stopping check's verdict from its reductions
__device__ __forceinline__ int check_status(const Args& a, bool diverged, float rp, float rax,
                                            float rz, float rd, float rpx, float rq, float raty,
                                            bool prim_inf, bool dual_inf, float& ratio) {
  const float pscale = nanmax(rax, rz);
  const float dscale = nanmax(rpx, nanmax(rq, raty));
  const bool prim_ok = rp <= a.eps_abs + a.eps_rel * pscale;
  const bool dual_ok = rd <= a.eps_abs + a.eps_rel * dscale;
  // normalized-residual balance for adaptive rho (OSQP sec. 5.2)
  const float tiny = 1.17549435e-38f;  // FLT_MIN
  const float pn = rp / nanmax(pscale, tiny);
  const float dn = rd / nanmax(dscale, tiny);
  ratio = (pn > 0.f && dn > 0.f) ? pn / nanmax(dn, tiny) : 1.f;
  return diverged ? kUnknown
         : (prim_ok && dual_ok) ? kOptimal
         : prim_inf ? kPrimalInf
         : dual_inf ? kDualInf
         : kRunning;
}

// whether a member still running adapts its rho at this balance
__device__ __forceinline__ bool adapts(const Args& a, int new_status, float ratio) {
  const float mult = sqrtf(ratio);
  return a.adaptive && new_status == kRunning && (mult > a.rho_tol || mult < 1.f / a.rho_tol);
}

// rho_new of the lane's own rows: rho sqrt(ratio) clipped, free rows pinned
__device__ __forceinline__ void adapt_rows(const Prob& p, float ratio) {
  const float INF = __int_as_float(0x7f800000);
  const float mult = sqrtf(ratio);
  for (int i = p.lane; i < p.m; i += 32) {
    const bool pinned = p.lv[i] == -INF && p.uv[i] == INF;
    p.rho_new[i] = pinned ? 1e-6f : fminf(fmaxf(p.rho[i] * mult, 1e-6f), 1e6f);
  }
}

// The partial sums of As' (rho z - y) over the lane's own rows.
template <int N>
__device__ __forceinline__ void w_partials(const Prob& p, float (&part)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) part[j] = 0.f;
  for (int i = p.lane; i < p.m; i += 32) {
    const float* Asi = p.As + i * p.ld;
    const float wi = p.rho[i] * p.z[i] - p.y[i];
#pragma unroll
    for (int j = 0; j < N; ++j) part[j] = fmaf(Asi[j], wi, part[j]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) part[j] = warp_sum(part[j]);
}

// One row of the register path's pass: As_i in registers, the row's iterate,
// rho, 1 / rho and bounds.
template <int N>
struct Row {
  float a[N];
  float z, y, r, ir, ls, us;
};

template <int N>
__device__ __forceinline__ void row_load(const Prob& p, const float* irho, int i, Row<N>& R) {
  const float* Asi = p.As + i * p.ld;
#pragma unroll
  for (int j = 0; j < N; ++j) R.a[j] = Asi[j];
  R.z = p.z[i];
  R.y = p.y[i];
  R.r = p.rho[i];
  R.ir = irho[i];
  R.ls = p.ls[i];
  R.us = p.us[i];
}

// zt = As_i xt, the relaxed z_i clipped to [ls, us] and y_i
template <int N>
__device__ __forceinline__ void row_update(const Row<N>& R, const float (&xt)[N], float alpha,
                                           float& zc, float& yn) {
  float zt = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) zt = fmaf(R.a[j], xt[j], zt);
  const float zr = alpha * zt + (1.f - alpha) * R.z;
  const float v = zr + R.y * R.ir;
  const float clipped = fminf(fmaxf(v, R.ls), R.us);  // both bounds read on every path
  zc = (v != v) ? v : clipped;
  yn = R.y + R.r * (zr - zc);
}

// A stopping check's sums and maxima over the lane's rows.
template <int N>
struct CheckAcc {
  float E, rp, rax, rz, sum_term, umax, lmin;
  bool nonfinite, row_fail;
  float aty[N], atyc[N], atdy[N];
};

// A check's terms of row i: the unscaled A_i, the committed z_i and y_i,
// and y_i before the iteration (yold)
template <int N>
__device__ __forceinline__ void row_check(const Args& a, const Prob& p, const float* isy,
                                          const float* yold, int i, float ic,
                                          const float (&xus)[N], const float (&dxus)[N],
                                          float tol, CheckAcc<N>& C) {
  const float zc = p.z[i], yn = p.y[i];
  const float syi = p.sy[i];
  const float m1 = syi * yn * ic;
  const float m2 = syi * (yn - yold[i]) * ic;
  C.E = nanmax(C.E, fabsf(m2));
  C.nonfinite |= !isfinite(m1);
  const float* Ai = p.A + i * p.ald;
  float ar[N];
#pragma unroll
  for (int j = 0; j < N; ++j) ar[j] = Ai[j];
  const float zus = zc * isy[i];
  float ax, adx = 0.f;
  if (a.compensated) {
    float hi = 0.f, lo = 0.f, s, e;
#pragma unroll
    for (int j = 0; j < N; ++j) dot2_step(ar[j], xus[j], hi, lo);
    two_sum(hi, -zus, s, e);
    C.rp = nanmax(C.rp, fabsf(s + (e + lo)));
    ax = hi;
#pragma unroll
    for (int j = 0; j < N; ++j) dot2_step(ar[j], m1, C.aty[j], C.atyc[j]);
  } else {
    ax = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      ax = fmaf(ar[j], xus[j], ax);
      C.aty[j] = fmaf(ar[j], m1, C.aty[j]);
    }
    C.rp = nanmax(C.rp, fabsf(ax - zus));
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    adx = fmaf(ar[j], dxus[j], adx);
    C.atdy[j] = fmaf(ar[j], m2, C.atdy[j]);
  }
  C.rax = nanmax(C.rax, fabsf(ax));
  C.rz = nanmax(C.rz, fabsf(zus));
  const float uvi = p.uv[i], lvi = p.lv[i];
  const bool uinf = isinf(uvi), linf = isinf(lvi);
  if (uinf) C.umax = fmaxf(C.umax, m2);
  if (linf) C.lmin = fminf(C.lmin, m2);
  C.sum_term += (uinf ? 0.f : uvi * fmaxf(0.f, m2)) + (linf ? 0.f : lvi * fminf(0.f, m2));
  C.row_fail |= !(uinf ? adx >= -tol : (linf ? adx <= tol : fabsf(adx) < tol));
}

// 1 / rho of the lane's own rows
__device__ __forceinline__ void invert_rows(const Prob& p, float* irho) {
  for (int i = p.lane; i < p.m; i += 32) irho[i] = 1.f / p.rho[i];
}

// The loop with every lane on every product (n = N); Minv in registers.
// A lane's rows go two at a time (rows i and i + 32 loaded, updated and
// stored together, so their chains overlap), and every per-row quotient
// takes a reciprocal kept beside its divisor: 1 / rho (renewed with rho),
// 1 / sy and 1 / c.
template <int N>
__device__ LoopOut loop_small(const Args& a, Prob& p, int status, float (&Mi)[N * N],
                              Clock& clk) {
  const int m = p.m, ld = p.ld, lane = p.lane;
  const float INF = __int_as_float(0x7f800000);
  const float alpha = a.alpha, sigma = a.sigma, ic = 1.f / p.c;
  float* irho = p.zn;  // the register path keeps no zn, yn, m1: they hold 1 / rho,
  float* isy = p.yn;   // 1 / sy and, at a check, y before the iteration
  float* yold = p.m1;
  float x[N], qs[N], part[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    part[j] = 0.f;
    x[j] = p.x[j];
    qs[j] = p.qs[j];
  }
  for (int i = lane; i < m; i += 32) isy[i] = 1.f / p.sy[i];
  invert_rows(p, irho);
  LoopOut o{status, 0, 0, INF, INF};
  if (status == kRunning) w_partials<N>(p, part);
  // between checks the balance is 1: whether a member adapts there is fixed
  const bool adapt_between = adapts(a, kRunning, 1.f);
  int next_check = 1 % a.stop_check_iter;
  for (int it = 0; it < a.max_iter && o.status == kRunning; ++it) {
    float xt[N], xn[N];
    {
      float rhs[N];
#pragma unroll
      for (int j = 0; j < N; ++j) rhs[j] = sigma * x[j] - qs[j] + part[j];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < N; ++k) s = fmaf(Mi[j * N + k], rhs[k], s);
        xt[j] = s;
      }
      for (int r = 0; r < a.refine; ++r) {
        float t[N];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < N; ++k) s = fmaf(p.Mred[j * ld + k], xt[k], s);
          t[j] = rhs[j] - s;
        }
#pragma unroll
        for (int j = 0; j < N; ++j) {
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < N; ++k) s = fmaf(Mi[j * N + k], t[k], s);
          xt[j] += s;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) xn[j] = alpha * xt[j] + (1.f - alpha) * x[j];

    const bool check = it == next_check;
    if (check) next_check += a.stop_check_iter;
    // one pass over the lane's rows, two at a time (rows i and i + 32
    // loaded, updated and stored together, so their chains overlap): the
    // updates and the next iteration's partial sums of As' w; a check keeps
    // the previous y_i for its own pass
#pragma unroll
    for (int j = 0; j < N; ++j) part[j] = 0.f;
    for (int i0 = lane; i0 < m; i0 += 64) {
      const bool two = i0 + 32 < m;
      const int i1 = two ? i0 + 32 : i0;
      Row<N> R0, R1;
      row_load<N>(p, irho, i0, R0);
      row_load<N>(p, irho, i1, R1);
      float zc0, yn0, zc1, yn1;
      row_update<N>(R0, xt, alpha, zc0, yn0);
      row_update<N>(R1, xt, alpha, zc1, yn1);
      p.z[i0] = zc0;
      p.y[i0] = yn0;
      if (check) yold[i0] = R0.y;
      const float w0 = R0.r * zc0 - yn0;
#pragma unroll
      for (int j = 0; j < N; ++j) part[j] = fmaf(R0.a[j], w0, part[j]);
      if (two) {
        p.z[i1] = zc1;
        p.y[i1] = yn1;
        if (check) yold[i1] = R1.y;
        const float w1 = R1.r * zc1 - yn1;
#pragma unroll
        for (int j = 0; j < N; ++j) part[j] = fmaf(R1.a[j], w1, part[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) part[j] = warp_sum(part[j]);

    int new_status = kRunning;
    float pres_n = o.pres, dres_n = o.dres, ratio = 1.f;
    if (check) {
      // the unscaled iterate and step (replicated), then a pass over the
      // lane's rows for their terms of the residuals and certificates
      float xus[N], dxus[N], dxn = 0.f;
      CheckAcc<N> C;
      C.E = C.rp = C.rax = C.rz = C.sum_term = 0.f;
      C.umax = -INF;
      C.lmin = INF;
      C.nonfinite = C.row_fail = false;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float sxj = p.sx[j];
        xus[j] = sxj * xn[j];
        dxus[j] = sxj * (xn[j] - x[j]);
        dxn = nanmax(dxn, fabsf(dxus[j]));
        C.nonfinite |= !isfinite(xus[j]);
        C.aty[j] = C.atyc[j] = C.atdy[j] = 0.f;
      }
      const float tol = a.eps_dinf * dxn;
      for (int i = lane; i < m; i += 32) row_check<N>(a, p, isy, yold, i, ic, xus, dxus, tol, C);
      const bool diverged = __any_sync(kFull, C.nonfinite);
      const float E = warp_max(C.E);
      const float thr = a.eps_pinf * E;
      const float rp = warp_max(C.rp), rax = warp_max(C.rax), rz = warp_max(C.rz);
      const float sum_term = warp_sum(C.sum_term);
      const bool viol = warp_fmax(C.umax) > thr || warp_fmin(C.lmin) < -thr;
      const bool row_fail = __any_sync(kFull, C.row_fail);
      if (a.compensated) {
#pragma unroll
        for (int j = 0; j < N; ++j) warp_dot2(C.aty[j], C.atyc[j]);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) C.aty[j] = warp_sum(C.aty[j]);
      }
#pragma unroll
      for (int j = 0; j < N; ++j) C.atdy[j] = warp_sum(C.atdy[j]);
      // columns: P x_us, P dx_us (replicated), A' y_us, A' dy_us (summed
      // over the lanes); the dual residual
      float rd = 0.f, rpx = 0.f, rq = 0.f, raty = 0.f, ratdy = 0.f, rpdx = 0.f, qdx = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float* Pj = p.P + j * p.pld;
        const float qj = p.q[j];
        float pr[N];
#pragma unroll
        for (int k = 0; k < N; ++k) pr[k] = Pj[k];
        float px, pdx = 0.f;
        if (a.compensated) {
          float phi = 0.f, plo = 0.f, s, e, s2, e2;
#pragma unroll
          for (int k = 0; k < N; ++k) dot2_step(pr[k], xus[k], phi, plo);
          two_sum(phi, C.aty[j], s, e);
          two_sum(s, qj, s2, e2);
          rd = nanmax(rd, fabsf(s2 + (((e2 + e) + plo) + C.atyc[j])));
          px = phi;
        } else {
          px = 0.f;
#pragma unroll
          for (int k = 0; k < N; ++k) px = fmaf(pr[k], xus[k], px);
          rd = nanmax(rd, fabsf(px + qj + C.aty[j]));
        }
#pragma unroll
        for (int k = 0; k < N; ++k) pdx = fmaf(pr[k], dxus[k], pdx);
        rpx = nanmax(rpx, fabsf(px));
        rq = nanmax(rq, fabsf(qj));
        raty = nanmax(raty, fabsf(C.aty[j]));
        ratdy = nanmax(ratdy, fabsf(C.atdy[j]));
        rpdx = nanmax(rpdx, fabsf(pdx));
        qdx += qj * dxus[j];
      }
      pres_n = rp;
      dres_n = rd;
      const bool prim_inf = !viol && nanmax(ratdy, sum_term) < thr;
      const bool dual_inf = rpdx <= tol && qdx <= tol && !row_fail;
      new_status = check_status(a, diverged, rp, rax, rz, rd, rpx, rq, raty, prim_inf, dual_inf,
                                ratio);
    }

    // commit the iterate
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = xn[j];
    o.status = new_status;
    o.iters = it + 1;
    o.pres = pres_n;
    o.dres = dres_n;
    if (check) {
      clk.lap(kClkCheckIter);
      clk.count(kClkChecks);
    } else {
      clk.lap(kClkIter);
      clk.count(kClkIters);
    }

    if (check ? adapts(a, new_status, ratio) : adapt_between) {
      adapt_rows(p, ratio);
      ++o.nref;
      // a failed refactorization keeps the previous rho and factors
      if (refactor_small<N>(p, p.rho_new, sigma, Mi)) {
        float* t = p.rho;
        p.rho = p.rho_new;
        p.rho_new = t;
        invert_rows(p, irho);
        w_partials<N>(p, part);
      }
      clk.lap(kClkRefactor);
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j == lane) p.x[j] = x[j];
  __syncwarp();
  return o;
}

// The loop with a lane per output (n > 8), vectors in shared memory.
__device__ LoopOut loop_general(const Args& a, Prob& p, int status, Clock& clk) {
  const int n = p.n, m = p.m, ld = p.ld, lane = p.lane;
  const float INF = __int_as_float(0x7f800000);
  const float alpha = a.alpha, sigma = a.sigma, c = p.c;
  LoopOut o{status, 0, 0, INF, INF};
  const int sci = a.stop_check_iter, check_phase = 1 % sci;
  for (int it = 0; it < a.max_iter && o.status == kRunning; ++it) {
    float *x = p.x, *xn = p.xn, *z = p.z, *zn = p.zn, *y = p.y, *yn = p.yn;
    float *rhs = p.rhs, *xt = p.xt, *t1 = p.t1, *t2 = p.t2, *w = p.w, *m1 = p.m1, *m2 = p.m2;
    const float *As = p.As, *rho = p.rho, *sx = p.sx, *sy = p.sy;
    for (int i = lane; i < m; i += 32) w[i] = rho[i] * z[i] - y[i];
    __syncwarp();
    for (int j = lane; j < n; j += 32) rhs[j] = sigma * x[j] - p.qs[j] + dot4(As + j, ld, w, 1, m);
    __syncwarp();
    for (int j = lane; j < n; j += 32) xt[j] = dot4(p.Minv + j * ld, 1, rhs, 1, n);
    __syncwarp();
    for (int r = 0; r < a.refine; ++r) {
      for (int j = lane; j < n; j += 32) t1[j] = rhs[j] - dot4(p.Mred + j * ld, 1, xt, 1, n);
      __syncwarp();
      for (int j = lane; j < n; j += 32) xt[j] += dot4(p.Minv + j * ld, 1, t1, 1, n);
      __syncwarp();
    }
    for (int j = lane; j < n; j += 32) xn[j] = alpha * xt[j] + (1.f - alpha) * x[j];
    for (int i = lane; i < m; i += 32) {
      const float zti = dot4(As + i * ld, 1, xt, 1, n);
      const float zr = alpha * zti + (1.f - alpha) * z[i];
      const float v = zr + y[i] / rho[i];
      const float zc = (v != v) ? v : fminf(fmaxf(v, p.ls[i]), p.us[i]);
      zn[i] = zc;
      yn[i] = y[i] + rho[i] * (zr - zc);
    }
    __syncwarp();

    int new_status = kRunning;
    float pres_n = o.pres, dres_n = o.dres, ratio = 1.f;
    const bool check = it % sci == check_phase;
    if (check) {
      // unscaled iterate and steps; |dx_us|, |dy_us| and non-finite first
      float dxn = 0.f, E = 0.f;
      bool nonfinite = false;
      for (int j = lane; j < n; j += 32) {
        t1[j] = sx[j] * xn[j];
        t2[j] = sx[j] * (xn[j] - x[j]);
        dxn = nanmax(dxn, fabsf(t2[j]));
        nonfinite |= !isfinite(t1[j]);
      }
      for (int i = lane; i < m; i += 32) {
        m1[i] = sy[i] * yn[i] / c;
        m2[i] = sy[i] * (yn[i] - y[i]) / c;
        E = nanmax(E, fabsf(m2[i]));
        nonfinite |= !isfinite(m1[i]);
      }
      dxn = warp_max(dxn);
      E = warp_max(E);
      const bool diverged = __any_sync(kFull, nonfinite);
      __syncwarp();
      const float thr = a.eps_pinf * E, tol = a.eps_dinf * dxn;

      // rows of A: A x_us, A dx_us; the primal residual and the row tests
      float rp = 0.f, rax = 0.f, rz = 0.f, sum_term = 0.f;
      bool viol = false, row_fail = false;
      for (int i = lane; i < m; i += 32) {
        const float* Ai = p.A + i * p.ald;
        const float zus = zn[i] / sy[i];
        float ax;
        if (a.compensated) {
          float hi, lo, s, e;
          cdot(Ai, 1, t1, 1, n, hi, lo);
          two_sum(hi, -zus, s, e);
          rp = nanmax(rp, fabsf(s + (e + lo)));
          ax = hi;
        } else {
          ax = dot4(Ai, 1, t1, 1, n);
          rp = nanmax(rp, fabsf(ax - zus));
        }
        rax = nanmax(rax, fabsf(ax));
        rz = nanmax(rz, fabsf(zus));
        const float dy = m2[i];
        const bool uinf = isinf(p.uv[i]), linf = isinf(p.lv[i]);
        viol |= (uinf && dy > thr) || (linf && dy < -thr);
        sum_term += (uinf ? 0.f : p.uv[i] * fmaxf(0.f, dy)) + (linf ? 0.f : p.lv[i] * fminf(0.f, dy));
        const float adx = dot4(Ai, 1, t2, 1, n);
        row_fail |= !(uinf ? adx >= -tol : (linf ? adx <= tol : fabsf(adx) < tol));
      }
      // columns: P x_us, A' y_us, A' dy_us, P dx_us; the dual residual
      float rd = 0.f, rpx = 0.f, rq = 0.f, raty = 0.f, ratdy = 0.f, rpdx = 0.f, qdx = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float* Pj = p.P + j * p.pld;
        const float* Aj = p.A + j;
        const float qj = p.q[j];
        float px, aty;
        if (a.compensated) {
          float phi, plo, ahi, alo, s, e, s2, e2;
          cdot(Pj, 1, t1, 1, n, phi, plo);
          cdot(Aj, p.ald, m1, 1, m, ahi, alo);
          two_sum(phi, ahi, s, e);
          two_sum(s, qj, s2, e2);
          rd = nanmax(rd, fabsf(s2 + (((e2 + e) + plo) + alo)));
          px = phi;
          aty = ahi;
        } else {
          px = dot4(Pj, 1, t1, 1, n);
          aty = dot4(Aj, p.ald, m1, 1, m);
          rd = nanmax(rd, fabsf(px + qj + aty));
        }
        rpx = nanmax(rpx, fabsf(px));
        rq = nanmax(rq, fabsf(qj));
        raty = nanmax(raty, fabsf(aty));
        ratdy = nanmax(ratdy, fabsf(dot4(Aj, p.ald, m2, 1, m)));
        rpdx = nanmax(rpdx, fabsf(dot4(Pj, 1, t2, 1, n)));
        qdx += qj * t2[j];
      }
      rp = warp_max(rp);
      rax = warp_max(rax);
      rz = warp_max(rz);
      rd = warp_max(rd);
      rpx = warp_max(rpx);
      rq = warp_max(rq);
      raty = warp_max(raty);
      ratdy = warp_max(ratdy);
      rpdx = warp_max(rpdx);
      sum_term = warp_sum(sum_term);
      qdx = warp_sum(qdx);
      viol = __any_sync(kFull, viol);
      row_fail = __any_sync(kFull, row_fail);
      pres_n = rp;
      dres_n = rd;
      const bool prim_inf = !viol && nanmax(ratdy, sum_term) < thr;
      const bool dual_inf = rpdx <= tol && qdx <= tol && !row_fail;
      new_status = check_status(a, diverged, rp, rax, rz, rd, rpx, rq, raty, prim_inf, dual_inf,
                                ratio);
    }

    // commit the iterate (warp-uniform pointer swaps)
    p.x = xn;
    p.xn = x;
    p.z = zn;
    p.zn = z;
    p.y = yn;
    p.yn = y;
    o.status = new_status;
    o.iters = it + 1;
    o.pres = pres_n;
    o.dres = dres_n;
    if (check) {
      clk.lap(kClkCheckIter);
      clk.count(kClkChecks);
    } else {
      clk.lap(kClkIter);
      clk.count(kClkIters);
    }

    // ratio is 1 between checks
    if (adapts(a, new_status, ratio)) {
      adapt_rows(p, ratio);
      __syncwarp();
      ++o.nref;
      // a failed refactorization keeps the previous rho and factors
      if (refactor_general(p, p.rho_new, sigma)) {
        float* t = p.rho;
        p.rho = p.rho_new;
        p.rho_new = t;
      }
      clk.lap(kClkRefactor);
    }
    __syncwarp();
  }
  return o;
}

// ------------------------------------------------------------------ kernel

template <int NS>
__global__ void __launch_bounds__(32 * kMaxWarps) admm_lane_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * a.ppb + warp;
  if (b >= a.B) return;  // a whole warp: nothing below synchronises the block
  const int n = a.n, m = a.m, ld = n | 1;
  Clock clk{a.clocks != nullptr && b == a.clock_b, 0, {}};
  clk.start();

  Prob p;
  p.n = n;
  p.m = m;
  p.ld = ld;
  p.lane = lane;
  p.As = sm + (size_t)warp * problem_floats(n, m, a.resident);
  p.Minv = p.As + m * ld;
  p.Mred = p.Minv + n * ld;
  p.S1 = p.Mred + n * ld;
  p.S2 = p.S1 + n * ld;
  float* v = p.S2 + n * ld;
  const float* gP = a.P + b * a.bP;
  const float* gA = a.A + b * a.bA;
  if (a.resident) {
    float* sP = v;
    float* sA = sP + n * ld;
    v = sA + m * ld;
    for (int e = lane; e < n * n; e += 32) {
      const int j = e / n;
      sP[j * ld + e - j * n] = gP[e];
    }
    for (int e = lane; e < m * n; e += 32) {
      const int i = e / n;
      sA[i * ld + e - i * n] = gA[e];
    }
    p.P = sP;
    p.A = sA;
    p.pld = p.ald = ld;
  } else {
    p.P = gP;
    p.A = gA;
    p.pld = p.ald = n;
  }
  p.x = v;
  p.xn = p.x + n;
  p.qs = p.xn + n;
  p.q = p.qs + n;
  p.sx = p.q + n;
  p.rhs = p.sx + n;
  p.xt = p.rhs + n;
  p.t1 = p.xt + n;  // Ruiz: sx_inc; refinement residual; x_us at a check
  p.t2 = p.t1 + n;  // the warm start; dx_us at a check
  p.z = p.t2 + n;
  p.zn = p.z + m;
  p.y = p.zn + m;
  p.yn = p.y + m;
  p.ls = p.yn + m;
  p.us = p.ls + m;
  p.lv = p.us + m;
  p.uv = p.lv + m;
  p.rho = p.uv + m;
  p.rho_new = p.rho + m;
  p.sy = p.rho_new + m;
  p.w = p.sy + m;   // Ruiz: sy_inc; rho z - y
  p.m1 = p.w + m;   // y_us at a check
  p.m2 = p.m1 + m;  // dy_us at a check

  const size_t on = (size_t)b * n, om = (size_t)b * m;
  const float* gq = a.q + b * a.bq;
  const float* gl = a.l + b * a.bl;
  const float* gu = a.u + b * a.bu;
  for (int j = lane; j < n; j += 32) p.q[j] = gq[j];
  for (int i = lane; i < m; i += 32) {
    p.lv[i] = gl[i];
    p.uv[i] = gu[i];
  }
  const bool given = a.fc != nullptr;
  int sweeps = 0;
  if (given) {
    p.gPs = a.fPs + on * n;
    p.c = a.fc[b];
    const float* gAs = a.fAs + om * n;
    const float* gMinv = a.fMinv + on * n;
    const float* gMred = a.fMred + on * n;
    for (int e = lane; e < m * n; e += 32) {
      const int i = e / n;
      p.As[i * ld + e - i * n] = gAs[e];
    }
    for (int e = lane; e < n * n; e += 32) {
      const int j = e / n;
      p.Minv[j * ld + e - j * n] = gMinv[e];
      p.Mred[j * ld + e - j * n] = gMred[e];
    }
    for (int j = lane; j < n; j += 32) p.sx[j] = a.fsx[on + j];
    for (int i = lane; i < m; i += 32) {
      p.sy[i] = a.fsy[om + i];
      p.rho[i] = a.frho[om + i];
    }
    __syncwarp();
  } else {
    p.gPs = nullptr;
    __syncwarp();
    if (a.scaling) {
      p.c = cost_scale(p);
      if constexpr (NS > 0) sweeps = ruiz_small<NS>(p);
      else sweeps = ruiz_general(p);
    } else {
      p.c = 1.f;
      for (int j = lane; j < n; j += 32) p.sx[j] = 1.f;
      for (int i = lane; i < m; i += 32) p.sy[i] = 1.f;
      __syncwarp();
    }
  }
  const bool trivially_infeasible = scale_rows(a, p, given);
  warm_start(a, p, b);
  int status = trivially_infeasible ? kPrimalInf
               : (given && !a.fok[b]) ? kUnknown
               : kRunning;
  clk.lap(kClkPrologue);

  LoopOut o;
  if constexpr (NS > 0) {
    float Mi[NS * NS];
    bool ok = true;
    if (given) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int k = 0; k < NS; ++k) Mi[j * NS + k] = p.Minv[j * ld + k];
    } else {
      ok = refactor_small<NS>(p, p.rho, a.sigma, Mi);
    }
    if (!ok && status == kRunning) status = kUnknown;
    clk.lap(kClkFactor);
    o = loop_small<NS>(a, p, status, Mi, clk);
  } else {
    if (!given && !refactor_general(p, p.rho, a.sigma) && status == kRunning) status = kUnknown;
    clk.lap(kClkFactor);
    o = loop_general(a, p, status, clk);
  }
  if (o.status == kRunning) o.status = kMaxIter;

  // the unscaled solution and its objective x'(P x / 2 + q)
  const float c = p.c;
  for (int j = lane; j < n; j += 32) p.t2[j] = p.sx[j] * p.x[j];
  __syncwarp();
  float obj = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float pj = p.t2[j];
    a.primal[on + j] = pj;
    obj += pj * (0.5f * dot4(p.P + j * p.pld, 1, p.t2, 1, n) + p.q[j]);
  }
  obj = warp_sum(obj);
  for (int i = lane; i < m; i += 32) a.dual[om + i] = p.sy[i] * p.y[i] / c;
  if (a.x) {
    for (int j = lane; j < n; j += 32) {
      a.x[on + j] = p.x[j];
      a.sx[on + j] = p.sx[j];
    }
    for (int i = lane; i < m; i += 32) {
      a.z[om + i] = p.z[i];
      a.y[om + i] = p.y[i];
      a.sy[om + i] = p.sy[i];
    }
  }
  clk.lap(kClkEpilogue);
  if (lane == 0) {
    a.objective[b] = obj;
    a.status[b] = o.status;
    a.iters[b] = o.iters;
    a.pres[b] = o.pres;
    a.dres[b] = o.dres;
    a.refactors[b] = o.nref;
    a.sweeps[b] = sweeps;
    if (a.x) a.c[b] = c;
    if (clk.on)
      for (int k = 0; k < kClocks; ++k) a.clocks[k] = clk.sum[k];
  }
}

// problems a block, the dynamic shared memory of a block, whether the
// unscaled P and A sit in shared memory, and n where the register path
// takes it, else 0 (qp/cuda_kernel.py's lane_plan mirrors it): a warp a problem, the unscaled
// matrices resident wherever one problem with them fits a block, as many
// problems a block as fit, at most kMaxWarps, and no more than it takes to
// give every SM a block (each problem's time is its own warp's chain, so
// spreading the fleet over the SMs first gives each warp a scheduler of its
// own where the fleet allows).  0 problems when one problem does not fit.
struct Plan {
  int ppb;
  size_t smem;
  int resident, small;
};

Plan plan(int B, int n, int m) {
  if (n < 1 || m < 1 || (size_t)n * (size_t)(m + 4 * n) > kSmemLimit) return {0, 0, 0, 0};
  if (4 * (size_t)problem_floats(n, m, 0) > kSmemLimit) return {0, 0, 0, 0};
  const int resident = 4 * (size_t)problem_floats(n, m, 1) <= kSmemLimit;
  const size_t per = 4 * (size_t)problem_floats(n, m, resident);
  int ppb = (int)(kSmemLimit / per);
  if (ppb > kMaxWarps) ppb = kMaxWarps;
  const int spread = B > kSMs ? (B + kSMs - 1) / kSMs : 1;
  if (ppb > spread) ppb = spread;
  return {ppb, ppb * per, resident, n <= kSmallMax ? n : 0};
}

template <int NS>
int launch(const Args& a, const Plan& p, cudaStream_t stream) {
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(admm_lane_kernel<NS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (a.B + a.ppb - 1) / a.ppb;
  admm_lane_kernel<NS><<<blocks, 32 * a.ppb, p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 when one problem of (n, m) fits, else 0; out[0] problems a block, out[1]
// dynamic shared memory a block in bytes, out[2] 1 where the unscaled P and A
// sit in shared memory, out[3] n on the register path (0: a lane per output)
extern "C" int admm_lane_plan(int B, int n, int m, int* out) {
  const Plan p = plan(B, n, m);
  if (out) {
    out[0] = p.ppb;
    out[1] = (int)p.smem;
    out[2] = p.resident;
    out[3] = p.small;
  }
  return p.ppb > 0 ? 1 : 0;
}

extern "C" int admm_lane_launch(
    const float* P, const float* q, const float* A, const float* l, const float* u,
    const float* xw, const float* yw, const float* fc, const float* fsx, const float* fsy,
    const float* frho, const float* fPs, const float* fAs, const float* fMred, const float* fMinv,
    const unsigned char* fok, float* primal, float* dual, float* objective, float* pres,
    float* dres, int* status, int* iters, int* refactors, int* sweeps, float* x, float* z,
    float* y, float* c, float* sx, float* sy, long long* clocks, long long bP, long long bq,
    long long bA, long long bl, long long bu, long long bxw, long long byw, int clock_b, int B,
    int n, int m, int ppb, float alpha, float sigma, float rho, float rho_eq, float eps_abs,
    float eps_rel, float eps_pinf, float eps_dinf, float rho_tol, int max_iter,
    int stop_check_iter, int refine, int adaptive, int compensated, int scaling, void* stream) {
  if (B <= 0) return 0;
  if (n <= 0 || m <= 0 || stop_check_iter < 1 || refine < 0) return (int)cudaErrorInvalidValue;
  const bool given = fc != nullptr;
  if (given != (fsx != nullptr) || given != (fsy != nullptr) || given != (frho != nullptr) ||
      given != (fPs != nullptr) || given != (fAs != nullptr) || given != (fMred != nullptr) ||
      given != (fMinv != nullptr) || given != (fok != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool scaled = x != nullptr;
  if (scaled != (z != nullptr) || scaled != (y != nullptr) || scaled != (c != nullptr) ||
      scaled != (sx != nullptr) || scaled != (sy != nullptr) || (xw == nullptr) != (yw == nullptr))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, n, m);
  if (p.ppb == 0 || ppb != p.ppb) return (int)cudaErrorInvalidValue;
  Args a{P, q, A, l, u, xw, yw, fc, fsx, fsy, frho, fPs, fAs, fMred, fMinv, fok,
         primal, dual, objective, pres, dres, status, iters, refactors, sweeps,
         x, z, y, c, sx, sy, clocks, bP, bq, bA, bl, bu, bxw, byw,
         clock_b, B, n, m, ppb, p.resident,
         alpha, sigma, rho, rho_eq, eps_abs, eps_rel, eps_pinf, eps_dinf, rho_tol,
         max_iter, stop_check_iter, refine, adaptive, compensated, scaling};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (p.small) {
    case 1: return launch<1>(a, p, s);
    case 2: return launch<2>(a, p, s);
    case 3: return launch<3>(a, p, s);
    case 4: return launch<4>(a, p, s);
    case 5: return launch<5>(a, p, s);
    case 6: return launch<6>(a, p, s);
    case 7: return launch<7>(a, p, s);
    case 8: return launch<8>(a, p, s);
    default: return launch<0>(a, p, s);
  }
}
