// Per-problem fused ADMM iteration for batches of QPs that each carry their
// own scaled KKT inverse, constraint matrix and cost matrix (the MPC fleet on
// per-member clocks, where every member is transcribed and factorized on its
// own).
//
// Replaces the TPU kernel smooth_feedback_tpu/qp/pallas_kernel.py::
// _admm_kernel (called through admm_iterate_pallas).  It computes the same
// function: per problem b, the ADMM loop
//
//     rhs = sigma x - qs + (rho z - y) As      xt = Minv rhs      zt = As xt
//     x   <- alpha xt + (1 - alpha) x
//     z   <- clip(alpha zt + (1 - alpha) z + y / rho, ls, us)
//     y   <- y + rho (alpha zt + (1 - alpha) z - z_new)
//
// with the unscaled-residual stopping check, the primal/dual infeasibility
// certificates and the non-finite test every stop_check_iter-th iteration
// (it % k == 1 % k).  Each problem runs its own loop until it stops or
// reaches max_iter (members still running come back as MaxIterations), so
// its iteration count is exact; a problem whose status0 is not Running does
// not iterate (x0/z0/y0 back, iters 0, pres = dres = inf).  Minv is the
// symmetric inverse L^-T L^-1, so Minv rhs is read row by row.
//
// What bounds it on an H100: device memory.  Every problem has its own
// Minv, Ps (n x n) and As (m x n): 277 KB at n = 163, m = 99, more than the
// 227 KB of shared memory a block can hold, and 284 MB for a fleet of 1024,
// more than the 50 MB L2.  The least the card could do is read them once
// (0.085 ms at 3.35 TB/s); the FMAs are about 4 GFLOP for a whole solve
// (0.06 ms at 67 TFLOP/s f32).  This first version streams Minv and As from
// device memory on every iteration (and Ps at each check), so it moves
// ~240 KB per problem per iteration and sits well above that bound; keeping
// Minv and As (171 KB) resident in shared memory is the next step.
//
// Design: one thread block per problem, 8 warps.  The iterates and the
// per-row data live in shared memory.  Products are coalesced in both
// shapes: M v (As x, Minv r, Ps x) takes a warp per output row, lanes over
// the columns and a butterfly reduction; v M (v As) takes a thread per
// column, looping over the rows.  No padding: n and m are runtime values
// and the ragged edges are masked by the loop bounds.  Norms and sums are
// reduced per warp, then over the block from shared memory in a fixed
// order, so every thread holds bit-identical results and the loop control
// stays block-uniform.  IEEE f32 throughout (no fast math): the max
// propagates NaN like jnp.max, the bounds' +-inf rows use finite copies so
// 0 * inf never appears, and the divergence test relies on IEEE inf/NaN.
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
constexpr int kMaxWarps = 8;  // __launch_bounds__(256)
constexpr int kMaxReduce = 10;  // values reduced over the block at once

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

// out[r] = sum_c M[r, c] v[c] for r < rows (M is rows x cols, row-major):
// one warp per output row, lanes over the columns
__device__ __forceinline__ void mv_rows(const float* __restrict__ M, const float* v, int rows,
                                        int cols, float* out, int warp, int lane, int nwarps) {
  for (int r = warp; r < rows; r += nwarps) {
    const float* row = M + (size_t)r * cols;
    float acc = 0.f;
    for (int c = lane; c < cols; c += 32) acc = fmaf(__ldg(row + c), v[c], acc);
    acc = warp_sum(acc);
    if (lane == 0) out[r] = acc;
  }
}

// out[c] = sum_r v[r] M[r, c] for c < cols: one thread per output column
__device__ __forceinline__ void mv_cols(const float* __restrict__ M, const float* v, int rows,
                                        int cols, float* out, int tid, int nthreads) {
  for (int c = tid; c < cols; c += nthreads) {
    float acc = 0.f;
#pragma unroll 4
    for (int r = 0; r < rows; ++r) acc = fmaf(v[r], __ldg(M + (size_t)r * cols + c), acc);
    out[c] = acc;
  }
}

__global__ void __launch_bounds__(32 * kMaxWarps) admm_problem_kernel(const Args a) {
  extern __shared__ float sm[];
  __shared__ float red[kMaxReduce * kMaxWarps];
  const int n = a.n, m = a.m;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int b = blockIdx.x;

  // n-vectors, then m-vectors (smem_bytes below counts them)
  float* x = sm;
  float* xn = x + n;
  float* qs = xn + n;
  float* sx = qs + n;
  float* icsx = sx + n;  // 1 / (c sx)
  float* vn1 = icsx + n;
  float* vn2 = vn1 + n;
  float* vn3 = vn2 + n;
  float* z = vn3 + n;
  float* zn = z + m;
  float* y = zn + m;
  float* yn = y + m;
  float* ls = yn + m;
  float* us = ls + m;
  float* rho = us + m;
  float* sy = rho + m;
  float* isy = sy + m;  // 1 / sy
  float* lv = isy + m;
  float* uv = lv + m;
  float* vm1 = uv + m;
  float* vm2 = vm1 + m;

  const float* Minv = a.Minv + (size_t)b * n * n;
  const float* As = a.As + (size_t)b * m * n;
  const float* Ps = a.Ps + (size_t)b * n * n;
  const size_t on = (size_t)b * n, om = (size_t)b * m;
  const float c = a.c[b];
  const float INF = __int_as_float(0x7f800000);

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
  }
  __syncthreads();

  int status = a.status0[b];
  int iters = 0;
  float pres = INF, dres = INF;

  if (status == kRunning) {
    const float alpha = a.alpha, sigma = a.sigma;
    const int sci = a.stop_check_iter;
    const int check_phase = 1 % sci;

    for (int it = 0; it < a.max_iter && status == kRunning; ++it) {
      // rhs = sigma x - qs + (rho z - y) As
      for (int i = tid; i < m; i += nt) vm1[i] = rho[i] * z[i] - y[i];
      __syncthreads();
      mv_cols(As, vm1, m, n, vn1, tid, nt);
      for (int j = tid; j < n; j += nt) vn1[j] = sigma * x[j] - qs[j] + vn1[j];  // same thread
      __syncthreads();
      mv_rows(Minv, vn1, n, n, vn2, warp, lane, nwarps);  // xt
      __syncthreads();
      mv_rows(As, vn2, m, n, vm2, warp, lane, nwarps);  // zt
      __syncthreads();

      for (int j = tid; j < n; j += nt) xn[j] = alpha * vn2[j] + (1.f - alpha) * x[j];
      for (int i = tid; i < m; i += nt) {
        const float zr = alpha * vm2[i] + (1.f - alpha) * z[i];
        const float v = zr + y[i] / rho[i];
        const float zc = (v != v) ? v : fminf(fmaxf(v, ls[i]), us[i]);
        zn[i] = zc;
        yn[i] = y[i] + rho[i] * (zr - zc);
      }
      __syncthreads();

      int new_status = kRunning;
      float pres_n = pres, dres_n = dres;
      if (it % sci == check_phase) {
        // ---- products at the new point, and the steps dy, dx
        mv_rows(As, xn, m, n, vm1, warp, lane, nwarps);  // As x
        mv_rows(Ps, xn, n, n, vn1, warp, lane, nwarps);  // Ps x
        mv_cols(As, yn, m, n, vn2, tid, nt);             // y As
        for (int i = tid; i < m; i += nt) vm2[i] = yn[i] - y[i];
        for (int j = tid; j < n; j += nt) vn3[j] = xn[j] - x[j];
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

        // ---- certificates: A' dy, Ps dx, As dx
        mv_cols(As, vm2, m, n, vn2, tid, nt);            // dy As
        mv_rows(Ps, vn3, n, n, vn1, warp, lane, nwarps);  // Ps dx
        mv_rows(As, vn3, m, n, vm1, warp, lane, nwarps);  // As dx
        __syncthreads();

        // s: violated sign row, sum term, |A'dy|, failed row, |Pdx|, q'dx
        float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int i = tid; i < m; i += nt) {
          const float dyus = sy[i] * vm2[i] / c;
          const bool uinf = uv[i] >= INF;
          const bool linf = lv[i] <= -INF;
          if ((uinf && dyus > thr) || (linf && dyus < -thr)) s[0] = 1.f;
          s[1] += (uinf ? 0.f : uv[i]) * fmaxf(0.f, dyus) + (linf ? 0.f : lv[i]) * fminf(0.f, dyus);
          const float adx = vm1[i] * isy[i];
          const bool ok = uinf ? adx >= -tol : (linf ? adx <= tol : fabsf(adx) < tol);
          if (!ok) s[3] = 1.f;
        }
        for (int j = tid; j < n; j += nt) {
          s[2] = nanmax(s[2], fabsf(vn2[j] * icsx[j]));
          s[4] = nanmax(s[4], fabsf(vn1[j] * icsx[j]));
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

}  // namespace

// Dynamic shared memory one block needs, in bytes (qp/cuda_kernel.py's
// problem_smem_bytes mirrors it): 8 n-vectors and 13 m-vectors.
static size_t smem_bytes(int n, int m) { return 4 * ((size_t)8 * n + (size_t)13 * m); }

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
  Args a{Minv, As, Ps, rho, sx, sy, c, qs, ls, us, l, u, x0, z0, y0, status0,
         x, z, y, status, iters, pres, dres, B, n, m,
         alpha, sigma, eps_abs, eps_rel, eps_pinf, eps_dinf, max_iter, stop_check_iter};
  const size_t smem = smem_bytes(n, m);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(admm_problem_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  admm_problem_kernel<<<B, 32 * warps, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
