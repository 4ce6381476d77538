// The lane backend's whole ADMM loop for fleets of tiny per-problem QPs
// (the ASIF safety filter's n = 3, m = 53), one launch a solve, with
// adaptive rho and its refactorizations inside the kernel.
//
// Replaces no TPU kernel: the JAX package runs this backend
// (smooth_feedback_tpu/qp/solver.py::_solve_qp_batch_lane, :645-846) as one
// XLA lax.while_loop over batch-trailing stacks, and a compiled loop's
// counterpart here is one kernel (eager torch would dispatch a few dozen
// small ops an iteration from the host).  It computes the same function:
// per problem b, from the scaled iterates,
//
//     rhs = sigma x - qs + As' (rho z - y)      xt = Minv rhs   (+ kkt_refine_iters
//     zt  = As xt                                 sweeps xt += Minv (rhs - Mred xt))
//     x   <- alpha xt + (1 - alpha) x
//     z   <- clip(alpha zt + (1 - alpha) z + y / rho, ls, us)
//     y   <- y + rho (alpha zt + (1 - alpha) z - z_new)
//
// with the stopping check on the UNSCALED data every stop_check_iter-th
// iteration (it % k == 1 % k): residuals (plain, or compensated with
// error-free transforms), the primal/dual infeasibility certificates and
// the non-finite test.  With adaptive rho, a member still running whose
// normalized residual balance leaves [1/tol, tol] takes rho <- clip(rho
// sqrt(ratio), 1e-6, 1e6) (rows unbounded on both sides stay at 1e-6) and
// refactorizes Mred = Ps + sigma I + As' diag(rho) As here: a Cholesky
// factor that is not finite keeps the previous rho and factors.  The JAX
// package refactorizes the whole fleet when any member adapts; a member that
// does not adapt gets its own factors back (its rho is unchanged), so
// refactorizing the adapting members alone is the same function (PERF.md
// states the two rounding-level exceptions).  Without given factors the
// kernel factorizes each member first; a failed factor makes a running
// member Unknown.  Each member runs until it stops or reaches max_iter.
//
// What bounds it on an H100: neither bytes nor FMAs.  The ASIF fleet (B =
// 256, n = 3, m = 53) reads 0.5 MB once (0.15 us at 3.35 TB/s) and needs
// about 0.5 MFLOP a solve; what a warp waits on is the chain of dependent
// matrix-vector products of each iteration, each a few hundred cycles of
// shared-memory loads, FMAs and warp synchronisation.
//
// Design: one warp per problem, several problems a block (one block an SM
// where the fleet is small).  A warp keeps its problem's As, Minv, Mred, two
// matrices of refactorization scratch and every vector in shared memory, at
// the odd row stride n | 1 so that lanes walking rows or columns hit
// distinct banks; the unscaled P and A, read only at checks, and Ps, read
// only to refactorize, stay in device memory (L1/L2).  A product gives each
// lane outputs of its own (rows for As x, columns for As' v), each a dot
// product in four interleaved partial sums added pairwise (one f32 chain
// over m = 294 rows drifted from float64 in csrc/admm_problem.cu); the
// warp synchronises between products with __syncwarp only.  Norms and sums
// are butterfly reductions, so every lane holds bit-identical results and
// the loop control is warp-uniform.  The Cholesky is right-looking in shared
// memory, a lane per row below the pivot; the inverse is one forward and
// one backward substitution a column, a lane per column.  One problem per
// warp (not one per thread with the batch on the lanes, the JAX layout)
// because at n = 32, m = 256 a problem's matrices take 50 KB, which leaves
// no room for 32 of them in one block.  IEEE f32 throughout: the max
// propagates NaN like jnp.max, the compensated transforms use __fmul_rn,
// __fmaf_rn and __fadd_rn so that no contraction can break them.
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

struct Args {
  const float* P;     // (B, n, n) unscaled, for the checks
  const float* q;     // (B, n)
  const float* A;     // (B, m, n)
  const float* l;     // (B, m)
  const float* u;     // (B, m)
  const float* c;     // (B,)
  const float* sx;    // (B, n)
  const float* sy;    // (B, m)
  const float* rho;   // (B, m)
  const float* Ps;    // (B, n, n) scaled
  const float* As;    // (B, m, n) scaled
  const float* Mred;  // (B, n, n) or null: the kernel factorizes
  const float* Minv;  // (B, n, n) or null
  const float* qs;    // (B, n)
  const float* ls;    // (B, m)
  const float* us;    // (B, m)
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
  int* refactors;
  int B, n, m, ppb;
  float alpha, sigma, eps_abs, eps_rel, eps_pinf, eps_dinf, rho_tol;
  int max_iter, stop_check_iter, refine, adaptive, compensated;
};

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// floats of shared memory one problem keeps (qp/cuda_kernel.py's
// lane_problem_bytes mirrors it): As, Minv, Mred and two scratch matrices at
// row stride n | 1, then the vectors
__host__ __device__ inline int problem_floats(int n, int m) {
  const int ld = n | 1;
  return round4(ld * (m + 4 * n) + kVecN * n + kVecM * m);
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

// compensated dot product (Ogita-Rump-Oishi Dot2): hi + lo = sum_k a[k sa]
// b[k sb] to ~eps^2 relative accumulation error
__device__ __forceinline__ void cdot(const float* a, int sa, const float* b, int sb, int len,
                                     float& hi, float& lo) {
  float s = 0.f, c = 0.f;
  for (int k = 0; k < len; ++k) {
    float p, pe, t, e;
    two_prod(a[k * sa], b[k * sb], p, pe);
    two_sum(s, p, t, e);
    s = t;
    c = __fadd_rn(c, __fadd_rn(e, pe));
  }
  hi = s;
  lo = c;
}
// ---- end of the error-free transforms

// Refactorize one problem's reduced KKT matrix at rho_src: S1 = Ps + sigma I
// + As' diag(rho_src) As, its Cholesky factor in S2 (right-looking, a lane
// per row below the pivot), and, when every entry of the factor is finite,
// Minv = L^-T L^-1 (a forward and a backward substitution a column, a lane
// per column) and Mred <-> S1.  Returns false, changing neither Minv nor
// Mred, when the factor is not finite.  Starts and ends with the warp
// synchronised.
__device__ bool refactor(const float* __restrict__ gPs, const float* As, const float* rho_src,
                         float*& Mred, float*& S1, float* S2, float* Minv, int n, int m, int ld,
                         float sigma, int lane) {
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
    const float v = (__ldg(gPs + e) + (j == k ? sigma : 0.f)) + ((s0 + s2) + (s1 + s3));
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
  float* t = Mred;
  Mred = S1;
  S1 = t;
  __syncwarp();
  return true;
}

__global__ void __launch_bounds__(32 * kMaxWarps) admm_lane_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * a.ppb + warp;
  if (b >= a.B) return;  // a whole warp: nothing below synchronises the block
  const int n = a.n, m = a.m, ld = n | 1;

  float* As = sm + (size_t)warp * problem_floats(n, m);
  float* Minv = As + m * ld;
  float* Mred = Minv + n * ld;
  float* S1 = Mred + n * ld;
  float* S2 = S1 + n * ld;
  float* x = S2 + n * ld;
  float* xn = x + n;
  float* qs = xn + n;
  float* q = qs + n;
  float* sx = q + n;
  float* rhs = sx + n;
  float* xt = rhs + n;
  float* t1 = xt + n;  // refinement residual; x_us at a check
  float* t2 = t1 + n;  // dx_us at a check
  float* z = t2 + n;
  float* zn = z + m;
  float* y = zn + m;
  float* yn = y + m;
  float* ls = yn + m;
  float* us = ls + m;
  float* lv = us + m;
  float* uv = lv + m;
  float* rho = uv + m;
  float* rho_new = rho + m;
  float* sy = rho_new + m;
  float* w = sy + m;   // rho z - y
  float* m1 = w + m;   // y_us at a check
  float* m2 = m1 + m;  // dy_us at a check

  const size_t on = (size_t)b * n, om = (size_t)b * m;
  const float* gP = a.P + (size_t)b * n * n;
  const float* gA = a.A + (size_t)b * m * n;
  const float* gPs = a.Ps + (size_t)b * n * n;
  const float* gAs = a.As + (size_t)b * m * n;
  const float c = a.c[b];
  const float INF = __int_as_float(0x7f800000);

  for (int e = lane; e < m * n; e += 32) {
    const int i = e / n;
    As[i * ld + e - i * n] = __ldg(gAs + e);
  }
  if (a.Minv) {
    const float* gMinv = a.Minv + (size_t)b * n * n;
    const float* gMred = a.Mred + (size_t)b * n * n;
    for (int e = lane; e < n * n; e += 32) {
      const int j = e / n;
      Minv[j * ld + e - j * n] = __ldg(gMinv + e);
      Mred[j * ld + e - j * n] = __ldg(gMred + e);
    }
  }
  for (int j = lane; j < n; j += 32) {
    x[j] = a.x0[on + j];
    qs[j] = a.qs[on + j];
    q[j] = a.q[on + j];
    sx[j] = a.sx[on + j];
  }
  for (int i = lane; i < m; i += 32) {
    z[i] = a.z0[om + i];
    y[i] = a.y0[om + i];
    ls[i] = a.ls[om + i];
    us[i] = a.us[om + i];
    lv[i] = a.l[om + i];
    uv[i] = a.u[om + i];
    rho[i] = a.rho[om + i];
    sy[i] = a.sy[om + i];
  }
  __syncwarp();

  int status = a.status0[b];
  int iters = 0, nref = 0;
  float pres = INF, dres = INF;
  if (!a.Minv && !refactor(gPs, As, rho, Mred, S1, S2, Minv, n, m, ld, a.sigma, lane) &&
      status == kRunning)
    status = kUnknown;

  const float alpha = a.alpha, sigma = a.sigma;
  const int sci = a.stop_check_iter, check_phase = 1 % sci;
  for (int it = 0; it < a.max_iter && status == kRunning; ++it) {
    for (int i = lane; i < m; i += 32) w[i] = rho[i] * z[i] - y[i];
    __syncwarp();
    for (int j = lane; j < n; j += 32) rhs[j] = sigma * x[j] - qs[j] + dot4(As + j, ld, w, 1, m);
    __syncwarp();
    for (int j = lane; j < n; j += 32) xt[j] = dot4(Minv + j * ld, 1, rhs, 1, n);
    __syncwarp();
    for (int r = 0; r < a.refine; ++r) {
      for (int j = lane; j < n; j += 32) t1[j] = rhs[j] - dot4(Mred + j * ld, 1, xt, 1, n);
      __syncwarp();
      for (int j = lane; j < n; j += 32) xt[j] += dot4(Minv + j * ld, 1, t1, 1, n);
      __syncwarp();
    }
    for (int j = lane; j < n; j += 32) xn[j] = alpha * xt[j] + (1.f - alpha) * x[j];
    for (int i = lane; i < m; i += 32) {
      const float zti = dot4(As + i * ld, 1, xt, 1, n);
      const float zr = alpha * zti + (1.f - alpha) * z[i];
      const float v = zr + y[i] / rho[i];
      const float zc = (v != v) ? v : fminf(fmaxf(v, ls[i]), us[i]);
      zn[i] = zc;
      yn[i] = y[i] + rho[i] * (zr - zc);
    }
    __syncwarp();

    int new_status = kRunning;
    float pres_n = pres, dres_n = dres, ratio = 1.f;
    if (it % sci == check_phase) {
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
        const float* Ai = gA + (size_t)i * n;
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
        const bool uinf = isinf(uv[i]), linf = isinf(lv[i]);
        viol |= (uinf && dy > thr) || (linf && dy < -thr);
        sum_term += (uinf ? 0.f : uv[i] * fmaxf(0.f, dy)) + (linf ? 0.f : lv[i] * fminf(0.f, dy));
        const float adx = dot4(Ai, 1, t2, 1, n);
        row_fail |= !(uinf ? adx >= -tol : (linf ? adx <= tol : fabsf(adx) < tol));
      }
      // columns: P x_us, A' y_us, A' dy_us, P dx_us; the dual residual
      float rd = 0.f, rpx = 0.f, rq = 0.f, raty = 0.f, ratdy = 0.f, rpdx = 0.f, qdx = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float* Pj = gP + (size_t)j * n;
        float px, aty;
        if (a.compensated) {
          float phi, plo, ahi, alo, s, e, s2, e2;
          cdot(Pj, 1, t1, 1, n, phi, plo);
          cdot(gA + j, n, m1, 1, m, ahi, alo);
          two_sum(phi, ahi, s, e);
          two_sum(s, q[j], s2, e2);
          rd = nanmax(rd, fabsf(s2 + (((e2 + e) + plo) + alo)));
          px = phi;
          aty = ahi;
        } else {
          px = dot4(Pj, 1, t1, 1, n);
          aty = dot4(gA + j, n, m1, 1, m);
          rd = nanmax(rd, fabsf(px + q[j] + aty));
        }
        rpx = nanmax(rpx, fabsf(px));
        rq = nanmax(rq, fabsf(q[j]));
        raty = nanmax(raty, fabsf(aty));
        ratdy = nanmax(ratdy, fabsf(dot4(gA + j, n, m2, 1, m)));
        rpdx = nanmax(rpdx, fabsf(dot4(Pj, 1, t2, 1, n)));
        qdx += q[j] * t2[j];
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
      const float pscale = nanmax(rax, rz);
      const float dscale = nanmax(rpx, nanmax(rq, raty));
      const bool prim_ok = rp <= a.eps_abs + a.eps_rel * pscale;
      const bool dual_ok = rd <= a.eps_abs + a.eps_rel * dscale;
      // normalized-residual balance for adaptive rho (OSQP sec. 5.2)
      const float tiny = 1.17549435e-38f;  // FLT_MIN
      const float pn = rp / nanmax(pscale, tiny);
      const float dn = rd / nanmax(dscale, tiny);
      ratio = (pn > 0.f && dn > 0.f) ? pn / nanmax(dn, tiny) : 1.f;
      const bool prim_inf = !viol && nanmax(ratdy, sum_term) < thr;
      const bool dual_inf = rpdx <= tol && qdx <= tol && !row_fail;
      new_status = diverged ? kUnknown
                   : (prim_ok && dual_ok) ? kOptimal
                   : prim_inf ? kPrimalInf
                   : dual_inf ? kDualInf
                   : kRunning;
    }

    // commit the iterate (warp-uniform pointer swaps)
    float* t;
    t = x; x = xn; xn = t;
    t = z; z = zn; zn = t;
    t = y; y = yn; yn = t;
    status = new_status;
    iters = it + 1;
    pres = pres_n;
    dres = dres_n;

    if (a.adaptive) {
      // ratio is 1 between checks
      const float mult = sqrtf(ratio);
      if (new_status == kRunning && (mult > a.rho_tol || mult < 1.f / a.rho_tol)) {
        for (int i = lane; i < m; i += 32) {
          const bool pinned = lv[i] == -INF && uv[i] == INF;
          rho_new[i] = pinned ? 1e-6f : fminf(fmaxf(rho[i] * mult, 1e-6f), 1e6f);
        }
        __syncwarp();
        ++nref;
        // a failed refactorization keeps the previous rho and factors
        if (refactor(gPs, As, rho_new, Mred, S1, S2, Minv, n, m, ld, sigma, lane)) {
          t = rho; rho = rho_new; rho_new = t;
        }
      }
    }
    __syncwarp();
  }
  if (status == kRunning) status = kMaxIter;

  for (int j = lane; j < n; j += 32) a.x[on + j] = x[j];
  for (int i = lane; i < m; i += 32) {
    a.z[om + i] = z[i];
    a.y[om + i] = y[i];
  }
  if (lane == 0) {
    a.status[b] = status;
    a.iters[b] = iters;
    a.pres[b] = pres;
    a.dres[b] = dres;
    a.refactors[b] = nref;
  }
}

// problems a block and the dynamic shared memory of a block
// (qp/cuda_kernel.py's lane_plan mirrors it): a warp a problem, as many
// problems as fit, at most kMaxWarps, and no more than it takes to give
// every SM a block.  0 problems when one problem does not fit.
struct Plan {
  int ppb;
  size_t smem;
};

Plan plan(int B, int n, int m) {
  const size_t per = 4 * (size_t)problem_floats(n, m);
  if (n < 1 || m < 1 || per > kSmemLimit) return {0, 0};
  int ppb = (int)(kSmemLimit / per);
  if (ppb > kMaxWarps) ppb = kMaxWarps;
  const int spread = B > kSMs ? (B + kSMs - 1) / kSMs : 1;
  if (ppb > spread) ppb = spread;
  return {ppb, ppb * per};
}

}  // namespace

// 1 when one problem of (n, m) fits, else 0; out[0] problems a block, out[1]
// dynamic shared memory a block in bytes
extern "C" int admm_lane_plan(int B, int n, int m, int* out) {
  if (n < 1 || m < 1 || (size_t)n * (size_t)(m + 4 * n) > kSmemLimit) {
    if (out) out[0] = out[1] = 0;
    return 0;
  }
  const Plan p = plan(B, n, m);
  if (out) {
    out[0] = p.ppb;
    out[1] = (int)p.smem;
  }
  return p.ppb > 0 ? 1 : 0;
}

extern "C" int admm_lane_launch(
    const float* P, const float* q, const float* A, const float* l, const float* u,
    const float* c, const float* sx, const float* sy, const float* rho, const float* Ps,
    const float* As, const float* Mred, const float* Minv, const float* qs, const float* ls,
    const float* us, const float* x0, const float* z0, const float* y0, const int* status0,
    float* x, float* z, float* y, int* status, int* iters, float* pres, float* dres,
    int* refactors, int B, int n, int m, int ppb, float alpha, float sigma, float eps_abs,
    float eps_rel, float eps_pinf, float eps_dinf, float rho_tol, int max_iter,
    int stop_check_iter, int refine, int adaptive, int compensated, void* stream) {
  if (B <= 0) return 0;
  if (n <= 0 || m <= 0 || stop_check_iter < 1 || refine < 0 || (Mred == nullptr) != (Minv == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((size_t)n * (size_t)(m + 4 * n) > kSmemLimit) return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, n, m);
  if (p.ppb == 0 || ppb != p.ppb) return (int)cudaErrorInvalidValue;
  Args a{P, q, A, l, u, c, sx, sy, rho, Ps, As, Mred, Minv, qs, ls, us, x0, z0, y0, status0,
         x, z, y, status, iters, pres, dres, refactors, B, n, m, ppb,
         alpha, sigma, eps_abs, eps_rel, eps_pinf, eps_dinf, rho_tol,
         max_iter, stop_check_iter, refine, adaptive, compensated};
  if (p.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(admm_lane_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + ppb - 1) / ppb;
  admm_lane_kernel<<<blocks, 32 * ppb, p.smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
