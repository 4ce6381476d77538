// Shared-matrix fused ADMM iteration for fleets of QPs that share one scaled
// KKT inverse, constraint matrix and cost matrix (the condensed MPC fleet).
//
// Replaces the TPU kernel smooth_feedback_tpu/qp/pallas_kernel.py::
// _admm_kernel_shared (called through admm_iterate_pallas_shared).  It
// computes the same function: per problem, the ADMM loop
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
// come back untouched (iters 0, pres = dres = inf).
//
// What bounds it on an H100: not device memory.  The three shared matrices
// (3 n^2 floats, 33 KB at n = m = 52) sit in shared memory for the whole
// solve and each problem's vectors sit in registers, so HBM traffic is one
// read of the inputs and one write of the outputs.  What is left is the
// latency of a dependent chain of three matrix-vector products per iteration
// and the FMA issue rate (3 n m FMAs per iteration per problem, plus six
// products at each check).
//
// Design: one warp per problem.  Because a frozen member never changes and
// every member counts its check cadence from the same zero, a member's
// result does not depend on the other members of a block, so each warp runs
// its own loop and exits on its own; the results equal the block-lockstep
// semantics of the TPU kernel.  Lane t owns vector entries t, t + 32, ...;
// a product broadcasts its input vector through a per-warp shared-memory
// buffer and each lane accumulates its own outputs with fp32 FMAs (no tensor
// cores, IEEE division, no fast math: the divergence test relies on IEEE inf
// and NaN).  The matrices are stored with an odd row stride, so both row
// access (v M) and column access (v M') are free of bank conflicts.  A block
// holds `warps` problems that share one copy of the matrices.
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

struct Args {
  const float* Minv;  // (n, n)
  const float* As;    // (m, n)
  const float* Ps;    // (n, n)
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
  float* x;
  float* z;
  float* y;
  int* status;
  int* iters;
  float* pres;
  float* dres;
  int B, n, m, ld, vpad;
  float alpha, sigma, eps_abs, eps_rel, eps_pinf, eps_dinf;
  int max_iter, stop_check_iter;
};

// max that propagates NaN, like jnp.max / torch.max
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// butterfly reductions: every lane ends with the same value (each pairwise
// step is commutative, so partners compute bit-identical results)
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

// broadcast this lane's entries of a vector of length len through buf
template <int K>
__device__ __forceinline__ void put(float* buf, const float (&v)[K], int len, int lane) {
  __syncwarp();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    if (j < len) buf[j] = v[k];
  }
  __syncwarp();
}

// out_j = sum_i buf[i] M[i, j]   (i < nin, j = lane + 32 k < nout)
template <int K>
__device__ __forceinline__ void mv_row(const float* buf, const float* M, int nin, int nout,
                                       int ld, int lane, float (&out)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = 0.f;
  for (int i = 0; i < nin; ++i) {
    const float b = buf[i];
    const float* row = M + i * ld;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + 32 * k;
      if (j < nout) out[k] = fmaf(b, row[j], out[k]);
    }
  }
}

// out_i = sum_j buf[j] M[i, j]   (j < nin, i = lane + 32 k < nout)
template <int K>
__device__ __forceinline__ void mv_col(const float* buf, const float* M, int nin, int nout,
                                       int ld, int lane, float (&out)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = 0.f;
  for (int j = 0; j < nin; ++j) {
    const float b = buf[j];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane + 32 * k;
      if (i < nout) out[k] = fmaf(b, M[i * ld + j], out[k]);
    }
  }
}

// at most 8 warps a block: at K = 4 a lane holds ~160 registers
template <int K>
__global__ void __launch_bounds__(256) admm_shared_kernel(const Args a) {
  extern __shared__ float smem[];
  const int n = a.n, m = a.m, ld = a.ld;
  float* sMinv = smem;
  float* sAs = sMinv + n * ld;
  float* sPs = sAs + m * ld;
  float* scratch = sPs + n * ld;

  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int r = idx / n, cc = idx - r * n;
    sMinv[r * ld + cc] = a.Minv[idx];
    sPs[r * ld + cc] = a.Ps[idx];
  }
  for (int idx = threadIdx.x; idx < m * n; idx += blockDim.x) {
    const int r = idx / n, cc = idx - r * n;
    sAs[r * ld + cc] = a.As[idx];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= a.B) return;  // whole warp leaves together
  float* buf = scratch + warp * a.vpad;

  const size_t on = (size_t)b * n, om = (size_t)b * m;
  const float INF = __int_as_float(0x7f800000);

  bool vn[K], vm[K];
  float x[K], z[K], y[K], qs[K], ls[K], us[K], rho[K], sx[K], sy[K];
  float ufin[K], lfin[K];
  bool uinf[K], linf[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    vn[k] = j < n;
    vm[k] = j < m;
    x[k] = vn[k] ? a.x0[on + j] : 0.f;
    qs[k] = vn[k] ? a.qs[on + j] : 0.f;
    sx[k] = vn[k] ? a.sx[j] : 1.f;
    z[k] = vm[k] ? a.z0[om + j] : 0.f;
    y[k] = vm[k] ? a.y0[om + j] : 0.f;
    ls[k] = vm[k] ? a.ls[om + j] : 0.f;
    us[k] = vm[k] ? a.us[om + j] : 0.f;
    rho[k] = vm[k] ? a.rho[j] : 1.f;
    sy[k] = vm[k] ? a.sy[j] : 1.f;
    const float lv = vm[k] ? a.l[om + j] : 0.f;
    const float uv = vm[k] ? a.u[om + j] : 0.f;
    uinf[k] = uv >= INF;
    linf[k] = lv <= -INF;
    ufin[k] = uinf[k] ? 0.f : uv;
    lfin[k] = linf[k] ? 0.f : lv;
  }

  int status = a.status0[b];
  int iters = 0;
  float pres = INF, dres = INF;

  if (status == kRunning) {
    const float c = *a.c;
    const float alpha = a.alpha, sigma = a.sigma;
    const int sci = a.stop_check_iter;
    const int check_phase = 1 % sci;
    float inv_sy[K], inv_csx[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      inv_sy[k] = 1.f / sy[k];
      inv_csx[k] = 1.f / (c * sx[k]);
    }

    for (int it = 0; it < a.max_iter && status == kRunning; ++it) {
      float t[K], rhs[K], xt[K], zt[K];
#pragma unroll
      for (int k = 0; k < K; ++k) t[k] = rho[k] * z[k] - y[k];
      put(buf, t, m, lane);
      mv_row(buf, sAs, m, n, ld, lane, t);
#pragma unroll
      for (int k = 0; k < K; ++k) rhs[k] = sigma * x[k] - qs[k] + t[k];
      put(buf, rhs, n, lane);
      mv_row(buf, sMinv, n, n, ld, lane, xt);
      put(buf, xt, n, lane);
      mv_col(buf, sAs, n, m, ld, lane, zt);

      float xn[K], zn[K], yn[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        xn[k] = alpha * xt[k] + (1.f - alpha) * x[k];
        const float zr = alpha * zt[k] + (1.f - alpha) * z[k];
        const float v = zr + y[k] / rho[k];
        zn[k] = (v != v) ? v : fminf(fmaxf(v, ls[k]), us[k]);
        yn[k] = y[k] + rho[k] * (zr - zn[k]);
      }

      int new_status = kRunning;
      float pres_n = pres, dres_n = dres;
      if (it % sci == check_phase) {
        // ---- optimality (unscaled residuals)
        float Ax[K], Px[K], Aty[K];
        put(buf, xn, n, lane);
        mv_col(buf, sAs, n, m, ld, lane, Ax);
        mv_col(buf, sPs, n, n, ld, lane, Px);
        put(buf, yn, m, lane);
        mv_row(buf, sAs, m, n, ld, lane, Aty);
        float r_p = 0.f, n_ax = 0.f, n_z = 0.f;
        float r_d = 0.f, n_px = 0.f, n_q = 0.f, n_aty = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float ax = Ax[k] * inv_sy[k];
          const float zu = zn[k] * inv_sy[k];
          r_p = nanmax(r_p, fabsf(ax - zu));
          n_ax = nanmax(n_ax, fabsf(ax));
          n_z = nanmax(n_z, fabsf(zu));
          const float px = Px[k] * inv_csx[k];
          const float aty = Aty[k] * inv_csx[k];
          const float qv = qs[k] * inv_csx[k];
          r_d = nanmax(r_d, fabsf(px + qv + aty));
          n_px = nanmax(n_px, fabsf(px));
          n_q = nanmax(n_q, fabsf(qv));
          n_aty = nanmax(n_aty, fabsf(aty));
        }
        pres_n = warp_max(r_p);
        dres_n = warp_max(r_d);
        n_ax = warp_max(n_ax);
        n_z = warp_max(n_z);
        n_px = warp_max(n_px);
        n_q = warp_max(n_q);
        n_aty = warp_max(n_aty);
        const bool prim_ok = pres_n <= a.eps_abs + a.eps_rel * nanmax(n_ax, n_z);
        const float dscale = nanmax(n_px, nanmax(n_q, n_aty));
        const bool dual_ok = dres_n <= a.eps_abs + a.eps_rel * dscale;
        const bool optimal = prim_ok && dual_ok;

        // ---- primal infeasibility certificate (dy direction)
        float dy[K], dy_us[K], Atdy[K];
        float e_loc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          dy[k] = yn[k] - y[k];
          dy_us[k] = sy[k] * dy[k] / c;
          e_loc = nanmax(e_loc, fabsf(dy_us[k]));
        }
        const float E = warp_max(e_loc);
        put(buf, dy, m, lane);
        mv_row(buf, sAs, m, n, ld, lane, Atdy);
        const float thr = a.eps_pinf * E;
        bool viol = false;
        float s_loc = 0.f, n_atdy = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          viol = viol || (uinf[k] && dy_us[k] > thr) || (linf[k] && dy_us[k] < -thr);
          s_loc += ufin[k] * fmaxf(0.f, dy_us[k]) + lfin[k] * fminf(0.f, dy_us[k]);
          n_atdy = nanmax(n_atdy, fabsf(Atdy[k] * inv_csx[k]));
        }
        viol = __any_sync(kFull, viol);
        const float sum_term = warp_sum(s_loc);
        n_atdy = warp_max(n_atdy);
        const bool prim_inf = !viol && nanmax(n_atdy, sum_term) < thr;

        // ---- dual infeasibility certificate (dx direction)
        float dx[K], Pdx[K], Adx[K];
        float dxn_loc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          dx[k] = xn[k] - x[k];
          dxn_loc = nanmax(dxn_loc, fabsf(sx[k] * dx[k]));
        }
        const float dxn = warp_max(dxn_loc);
        put(buf, dx, n, lane);
        mv_col(buf, sPs, n, n, ld, lane, Pdx);
        mv_col(buf, sAs, n, m, ld, lane, Adx);
        const float tol = a.eps_dinf * dxn;
        bool row_ok = true;
        float n_pdx = 0.f, qdx_loc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float adx = Adx[k] * inv_sy[k];
          bool ok_k;
          if (uinf[k]) ok_k = adx >= -tol;
          else if (linf[k]) ok_k = adx <= tol;
          else ok_k = fabsf(adx) < tol;
          row_ok = row_ok && (!vm[k] || ok_k);
          n_pdx = nanmax(n_pdx, fabsf(Pdx[k] * inv_csx[k]));
          qdx_loc += qs[k] * inv_csx[k] * (sx[k] * dx[k]);
        }
        row_ok = __all_sync(kFull, row_ok);
        n_pdx = warp_max(n_pdx);
        const float qdx = warp_sum(qdx_loc);
        const bool dual_inf = n_pdx <= tol && qdx <= tol && row_ok;

        // ---- divergence: non-finite scaled iterates
        bool fin = true;
#pragma unroll
        for (int k = 0; k < K; ++k) fin = fin && fabsf(xn[k]) < INF && fabsf(yn[k]) < INF;
        const bool diverged = !__all_sync(kFull, fin);

        new_status = diverged ? kUnknown
                     : optimal ? kOptimal
                     : prim_inf ? kPrimalInf
                     : dual_inf ? kDualInf
                     : kRunning;
      }

#pragma unroll
      for (int k = 0; k < K; ++k) {
        x[k] = xn[k];
        z[k] = zn[k];
        y[k] = yn[k];
      }
      status = new_status;
      iters = it + 1;
      pres = pres_n;
      dres = dres_n;
    }
    if (status == kRunning) status = kMaxIter;
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    if (vn[k]) a.x[on + j] = x[k];
    if (vm[k]) {
      a.z[om + j] = z[k];
      a.y[om + j] = y[k];
    }
  }
  if (lane == 0) {
    a.status[b] = status;
    a.iters[b] = iters;
    a.pres[b] = pres;
    a.dres[b] = dres;
  }
}

template <int K>
cudaError_t launch(const Args& a, int warps, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(admm_shared_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int grid = (a.B + warps - 1) / warps;
  admm_shared_kernel<K><<<grid, 32 * warps, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block needs, in bytes (qp/cuda_kernel.py's
// smem_bytes mirrors it): three matrices at row stride ld, one broadcast
// buffer of 32 K floats per warp.
static size_t smem_bytes(int n, int m, int warps) {
  const int ld = n | 1;
  const int K = ((n > m ? n : m) + 31) / 32;
  return 4 * ((size_t)ld * (2 * n + m) + (size_t)warps * 32 * K);
}

extern "C" int admm_shared_launch(
    const float* Minv, const float* As, const float* Ps, const float* rho, const float* sx,
    const float* sy, const float* c, const float* qs, const float* ls, const float* us,
    const float* l, const float* u, const float* x0, const float* z0, const float* y0,
    const int* status0, float* x, float* z, float* y, int* status, int* iters, float* pres,
    float* dres, int B, int n, int m, int warps, float alpha, float sigma, float eps_abs,
    float eps_rel, float eps_pinf, float eps_dinf, int max_iter, int stop_check_iter,
    void* stream) {
  const int K = ((n > m ? n : m) + 31) / 32;
  if (B <= 0) return 0;
  if (n <= 0 || m <= 0 || K > 4 || warps < 1 || warps > 8 || stop_check_iter < 1)
    return (int)cudaErrorInvalidValue;
  Args a{Minv, As, Ps, rho, sx, sy, c, qs, ls, us, l, u, x0, z0, y0, status0,
         x, z, y, status, iters, pres, dres, B, n, m, n | 1, 32 * K,
         alpha, sigma, eps_abs, eps_rel, eps_pinf, eps_dinf, max_iter, stop_check_iter};
  const size_t smem = smem_bytes(n, m, warps);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  switch (K) {
    case 1: e = launch<1>(a, warps, smem, s); break;
    case 2: e = launch<2>(a, warps, smem, s); break;
    case 3: e = launch<3>(a, warps, smem, s); break;
    default: e = launch<4>(a, warps, smem, s); break;
  }
  return (int)e;
}
