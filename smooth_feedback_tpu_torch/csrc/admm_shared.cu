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
// read of the inputs and one write of the outputs.  What is left is the 128
// bytes a clock that an SM's shared memory delivers to the registers (a
// broadcast load fills 32 lanes and costs what any load of its width costs)
// against four FMA instructions a clock: 3 n m FMAs per iteration per
// problem, plus six products at each check.
//
// Design: the TPU kernel's GEMM form on the CUDA cores.  A warp advances P
// problems together (P = 2; 1 for a block of one problem and for fleets too
// small to give every warp scheduler a warp).  Lane t owns vector entries t,
// t + 32, ... (K of them) of all P problems in registers; a product stages
// its P input vectors in a per-warp [row][problem] buffer, and for each row
// a lane reads the P inputs in one broadcast load and one matrix entry per
// owned output, which feeds P FMAs: P + K floats for K P FMAs, where one
// problem a warp reads 1 + K for K.  At a check x and dx (and y and dy) go
// through a matrix together, 2 P right-hand sides a pass, and l and u are
// read from device memory there instead of living in registers.  The P
// problems run in lockstep with per-member freeze masks, the TPU kernel's
// semantics: a stopped member's x, z, y, status, iters, pres, dres no longer
// change and the group leaves when all P have stopped.  A frozen member
// never changes and every member counts its check cadence from the same
// zero, so a member's result does not depend on its neighbours.  Every
// output keeps one fmaf chain over ascending rows, so iterates do not depend
// on P either.  At K = 2, P = 2 a problem-row costs 2 clocks of shared-memory
// bandwidth, and the kernel measures what that predicts: 9.5 us an iteration
// for B = 8192 on an H100 80GB HBM3 at 700 W, 0.2516 ms a warm solve (8.9
// times the bound; PERF.md).  P = 4 was measured too (the code below is
// generic in P): it reads a quarter less per FMA but holds more than 200
// registers a lane, so an SM keeps 8 warps instead of 16, and its solve took
// longer than P = 2's; it is not instantiated.  fp32 FMAs (no tensor cores, IEEE
// division, no fast math: the divergence test relies on IEEE inf and NaN).
// The matrices are stored with an odd row stride, so both row access (v M)
// and column access (v M') are free of bank conflicts.  A block holds `pb`
// problems (at most 8) that share one copy of the matrices, a group to each
// of its warps.  (A persistent grid whose warps draw their
// next group from a counter in device memory was measured: 7 % faster on
// batches whose members differ in their iteration counts, nothing on the
// fleet path's steady state, where they do not; it was not kept.)
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
constexpr int kMaxWarps = 8;    // __launch_bounds__(256): up to 255 registers a lane
constexpr int kMaxBlock = 8;    // problems per block: a group for each warp
constexpr int kSMs = 132;
constexpr int kSchedulers = 4 * kSMs;

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
  int B, n, m, ld;
  int pb;    // problems per block
  int wbuf;  // floats of staging buffer per warp
  float alpha, sigma, eps_abs, eps_rel, eps_pinf, eps_dinf;
  int max_iter, stop_check_iter;
};

// max that propagates NaN, like jnp.max / torch.max
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Warp max of values that are >= +0 or NaN with the sign bit clear (results
// of fabsf): their order as unsigned integers is their order as floats with
// NaN on top, so one integer reduction gives the NaN-propagating max in
// every lane.
__device__ __forceinline__ float warp_absmax(float v) {
  return __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(v)));
}

// butterfly sum: every lane ends with the same value (each pairwise step is
// commutative, so partners compute bit-identical results)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Q consecutive floats (Q = 1, 2 or a multiple of 4) at an address aligned
// to min(Q, 4) floats, with the widest loads and stores
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
  } else if constexpr (Q == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    b[0] = v.x;
    b[1] = v.y;
  } else {
    static_assert(Q == 1, "Q is 1, 2 or a multiple of 4");
    b[0] = p[0];
  }
}

template <int Q>
__device__ __forceinline__ void store_q(float* p, const float (&b)[Q]) {
  if constexpr (Q % 4 == 0) {
#pragma unroll
    for (int c = 0; c < Q / 4; ++c)
      reinterpret_cast<float4*>(p)[c] =
          make_float4(b[4 * c], b[4 * c + 1], b[4 * c + 2], b[4 * c + 3]);
  } else if constexpr (Q == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(b[0], b[1]);
  } else {
    static_assert(Q == 1, "Q is 1, 2 or a multiple of 4");
    p[0] = b[0];
  }
}

// stage this lane's entries of Q vectors as buf[row][q]
template <int K, int Q>
__device__ __forceinline__ void put(float* buf, const float (&v)[K][Q], int lane) {
  __syncwarp();
#pragma unroll
  for (int k = 0; k < K; ++k) store_q<Q>(buf + (lane + 32 * k) * Q, v[k]);
  __syncwarp();
}

// out[k][q] = sum_{i < nin} buf[i][q] M[i si + off[k]], zero where !ok[k]:
// (si, off) = (ld, column) is v M, (1, row * ld) is M v.  off is clamped
// into the matrix for entries this lane does not own.
template <int K, int Q>
__device__ __forceinline__ void mv(const float* buf, const float* M, int nin, int si,
                                   const int (&off)[K], const bool (&ok)[K],
                                   float (&out)[K][Q]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int q = 0; q < Q; ++q) out[k][q] = 0.f;
#pragma unroll 8
  for (int i = 0; i < nin; ++i) {
    float b[Q];
    load_q<Q>(buf + i * Q, b);
    const float* row = M + i * si;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float w = row[off[k]];
#pragma unroll
      for (int q = 0; q < Q; ++q) out[k][q] = fmaf(b[q], w, out[k][q]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int q = 0; q < Q; ++q) out[k][q] = ok[k] ? out[k][q] : 0.f;
}

// K entries a lane, P problems a warp
template <int K, int P>
__global__ void __launch_bounds__(32 * kMaxWarps) admm_shared_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int n = a.n, m = a.m, ld = a.ld;
  float* sMinv = smem;
  float* sAs = sMinv + n * ld;
  float* sPs = sAs + m * ld;
  float* scratch = smem + ((ld * (2 * n + m) + 3) & ~3);  // 16-byte aligned

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
  float* buf = scratch + warp * a.wbuf;
  const float INF = __int_as_float(0x7f800000);

  // what the batch shares, per owned entry
  bool vn[K], vm[K];
  int coln[K], rown[K], rowm[K];  // clamped offsets into the matrices
  float rho[K], sx[K], sy[K], inv_sy[K], inv_csx[K];
  const float c = *a.c;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    vn[k] = j < n;
    vm[k] = j < m;
    coln[k] = min(j, n - 1);
    rown[k] = coln[k] * ld;
    rowm[k] = min(j, m - 1) * ld;
    sx[k] = vn[k] ? a.sx[j] : 1.f;
    rho[k] = vm[k] ? a.rho[j] : 1.f;
    sy[k] = vm[k] ? a.sy[j] : 1.f;
    inv_sy[k] = 1.f / sy[k];
    inv_csx[k] = 1.f / (c * sx[k]);
  }
  const float alpha = a.alpha, sigma = a.sigma;
  const int sci = a.stop_check_iter;
  const int check_phase = 1 % sci;

  // this block's problems, a group of P to each warp
  const int first = blockIdx.x * a.pb;
  const int last = min(a.B, first + a.pb);
  const int b0 = first + warp * P;
  if (b0 < last) {
    // members past the block's last problem read member b0 and store nothing
    bool live[P];
    size_t on[P], om[P];  // offsets of the members' n- and m-vectors
    int status[P], iters[P];
    float pres[P], dres[P];
    float x[K][P], z[K][P], y[K][P], qs[K][P], ls[K][P], us[K][P];
    bool any_run = false;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      live[p] = b0 + p < last;
      const int b = live[p] ? b0 + p : b0;
      on[p] = (size_t)b * n;
      om[p] = (size_t)b * m;
      status[p] = live[p] ? a.status0[b] : kMaxIter;
      iters[p] = 0;
      pres[p] = INF;
      dres[p] = INF;
      any_run = any_run || status[p] == kRunning;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = lane + 32 * k;
        x[k][p] = vn[k] ? a.x0[on[p] + j] : 0.f;
        qs[k][p] = vn[k] ? a.qs[on[p] + j] : 0.f;
        z[k][p] = vm[k] ? a.z0[om[p] + j] : 0.f;
        y[k][p] = vm[k] ? a.y0[om[p] + j] : 0.f;
        ls[k][p] = vm[k] ? a.ls[om[p] + j] : 0.f;
        us[k][p] = vm[k] ? a.us[om[p] + j] : 0.f;
      }
    }

    for (int it = 0; it < a.max_iter && any_run; ++it) {
      float t[K][P], xt[K][P], zt[K][P];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int p = 0; p < P; ++p) t[k][p] = rho[k] * z[k][p] - y[k][p];
      put<K, P>(buf, t, lane);
      mv<K, P>(buf, sAs, m, ld, coln, vn, t);
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int p = 0; p < P; ++p) t[k][p] = sigma * x[k][p] - qs[k][p] + t[k][p];
      put<K, P>(buf, t, lane);
      mv<K, P>(buf, sMinv, n, ld, coln, vn, xt);
      put<K, P>(buf, xt, lane);
      mv<K, P>(buf, sAs, n, 1, rowm, vm, zt);

      float xn[K][P], zn[K][P], yn[K][P];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int p = 0; p < P; ++p) {
          xn[k][p] = alpha * xt[k][p] + (1.f - alpha) * x[k][p];
          const float zr = alpha * zt[k][p] + (1.f - alpha) * z[k][p];
          const float v = zr + y[k][p] / rho[k];
          zn[k][p] = (v != v) ? v : fminf(fmaxf(v, ls[k][p]), us[k][p]);
          yn[k][p] = y[k][p] + rho[k] * (zr - zn[k][p]);
        }

      int new_status[P];
      float pres_n[P], dres_n[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        new_status[p] = kRunning;
        pres_n[p] = pres[p];
        dres_n[p] = dres[p];
      }
      if (it % sci == check_phase) {
        // every matrix once: x and dx through As and Ps, y and dy through As
        float w[K][2 * P], Ax[K][2 * P], Px[K][2 * P], Aty[K][2 * P];
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int p = 0; p < P; ++p) {
            w[k][p] = xn[k][p];
            w[k][P + p] = xn[k][p] - x[k][p];
          }
        put<K, 2 * P>(buf, w, lane);
        mv<K, 2 * P>(buf, sAs, n, 1, rowm, vm, Ax);  // As x | As dx
        mv<K, 2 * P>(buf, sPs, n, 1, rown, vn, Px);  // Ps x | Ps dx
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int p = 0; p < P; ++p) {
            w[k][p] = yn[k][p];
            w[k][P + p] = yn[k][p] - y[k][p];
          }
        put<K, 2 * P>(buf, w, lane);
        mv<K, 2 * P>(buf, sAs, m, ld, coln, vn, Aty);  // y As | dy As

#pragma unroll
        for (int p = 0; p < P; ++p) {
          // ---- optimality (unscaled residuals)
          float r_p = 0.f, n_ax = 0.f, n_z = 0.f;
          float r_d = 0.f, n_px = 0.f, n_q = 0.f, n_aty = 0.f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float ax = Ax[k][p] * inv_sy[k];
            const float zu = zn[k][p] * inv_sy[k];
            r_p = nanmax(r_p, fabsf(ax - zu));
            n_ax = nanmax(n_ax, fabsf(ax));
            n_z = nanmax(n_z, fabsf(zu));
            const float px = Px[k][p] * inv_csx[k];
            const float aty = Aty[k][p] * inv_csx[k];
            const float qv = qs[k][p] * inv_csx[k];
            r_d = nanmax(r_d, fabsf(px + qv + aty));
            n_px = nanmax(n_px, fabsf(px));
            n_q = nanmax(n_q, fabsf(qv));
            n_aty = nanmax(n_aty, fabsf(aty));
          }
          pres_n[p] = warp_absmax(r_p);
          dres_n[p] = warp_absmax(r_d);
          n_ax = warp_absmax(n_ax);
          n_z = warp_absmax(n_z);
          n_px = warp_absmax(n_px);
          n_q = warp_absmax(n_q);
          n_aty = warp_absmax(n_aty);
          const bool prim_ok = pres_n[p] <= a.eps_abs + a.eps_rel * nanmax(n_ax, n_z);
          const float dscale = nanmax(n_px, nanmax(n_q, n_aty));
          const bool dual_ok = dres_n[p] <= a.eps_abs + a.eps_rel * dscale;
          const bool optimal = prim_ok && dual_ok;

          // ---- primal infeasibility certificate (dy direction)
          float dy_us[K];
          float e_loc = 0.f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float dy = yn[k][p] - y[k][p];
            dy_us[k] = sy[k] * dy / c;
            e_loc = nanmax(e_loc, fabsf(dy_us[k]));
          }
          const float E = warp_absmax(e_loc);
          const float thr = a.eps_pinf * E;
          bool uinf[K], linf[K];
          bool viol = false;
          float s_loc = 0.f, n_atdy = 0.f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int j = lane + 32 * k;
            const float lv = vm[k] ? a.l[om[p] + j] : 0.f;
            const float uv = vm[k] ? a.u[om[p] + j] : 0.f;
            uinf[k] = uv >= INF;
            linf[k] = lv <= -INF;
            const float ufin = uinf[k] ? 0.f : uv;
            const float lfin = linf[k] ? 0.f : lv;
            viol = viol || (uinf[k] && dy_us[k] > thr) || (linf[k] && dy_us[k] < -thr);
            s_loc += ufin * fmaxf(0.f, dy_us[k]) + lfin * fminf(0.f, dy_us[k]);
            n_atdy = nanmax(n_atdy, fabsf(Aty[k][P + p] * inv_csx[k]));
          }
          viol = __any_sync(kFull, viol);
          const float sum_term = warp_sum(s_loc);
          n_atdy = warp_absmax(n_atdy);
          const bool prim_inf = !viol && nanmax(n_atdy, sum_term) < thr;

          // ---- dual infeasibility certificate (dx direction)
          float dx[K];
          float dxn_loc = 0.f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            dx[k] = xn[k][p] - x[k][p];
            dxn_loc = nanmax(dxn_loc, fabsf(sx[k] * dx[k]));
          }
          const float dxn = warp_absmax(dxn_loc);
          const float tol = a.eps_dinf * dxn;
          bool row_ok = true;
          float n_pdx = 0.f, qdx_loc = 0.f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float adx = Ax[k][P + p] * inv_sy[k];
            bool ok_k;
            if (uinf[k]) ok_k = adx >= -tol;
            else if (linf[k]) ok_k = adx <= tol;
            else ok_k = fabsf(adx) < tol;
            row_ok = row_ok && (!vm[k] || ok_k);
            n_pdx = nanmax(n_pdx, fabsf(Px[k][P + p] * inv_csx[k]));
            qdx_loc += qs[k][p] * inv_csx[k] * (sx[k] * dx[k]);
          }
          row_ok = __all_sync(kFull, row_ok);
          n_pdx = warp_absmax(n_pdx);
          const float qdx = warp_sum(qdx_loc);
          const bool dual_inf = n_pdx <= tol && qdx <= tol && row_ok;

          // ---- divergence: non-finite scaled iterates
          bool fin = true;
#pragma unroll
          for (int k = 0; k < K; ++k)
            fin = fin && fabsf(xn[k][p]) < INF && fabsf(yn[k][p]) < INF;
          const bool diverged = !__all_sync(kFull, fin);

          new_status[p] = diverged ? kUnknown
                          : optimal ? kOptimal
                          : prim_inf ? kPrimalInf
                          : dual_inf ? kDualInf
                          : kRunning;
        }
      }

      // commit the members still running; the others stay frozen
      any_run = false;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const bool run = status[p] == kRunning;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          x[k][p] = run ? xn[k][p] : x[k][p];
          z[k][p] = run ? zn[k][p] : z[k][p];
          y[k][p] = run ? yn[k][p] : y[k][p];
        }
        status[p] = run ? new_status[p] : status[p];
        iters[p] = run ? it + 1 : iters[p];
        pres[p] = run ? pres_n[p] : pres[p];
        dres[p] = run ? dres_n[p] : dres[p];
        any_run = any_run || status[p] == kRunning;
      }
    }

#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (!live[p]) continue;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = lane + 32 * k;
        if (vn[k]) a.x[on[p] + j] = x[k][p];
        if (vm[k]) {
          a.z[om[p] + j] = z[k][p];
          a.y[om[p] + j] = y[k][p];
        }
      }
      if (lane == 0) {
        const int b = b0 + p;
        a.status[b] = status[p] == kRunning ? kMaxIter : status[p];
        a.iters[b] = iters[p];
        a.pres[b] = pres[p];
        a.dres[b] = dres[p];
      }
    }
  }
}

// How a launch is laid out (qp/cuda_kernel.py's shared_plan mirrors it).
struct Plan {
  int K;       // entries a lane
  int P;       // problems a warp advances together
  int pb;      // problems per block
  int warps;   // warps per block
  size_t smem; // dynamic shared memory per block, bytes
};

// widest group for a block of `block` problems: 2 problems a warp, and never
// more than the block
int block_group(int block) { return block >= 2 ? 2 : 1; }

// Dynamic shared memory for blocks of `block` problems, whatever B: three
// matrices at row stride ld and, for each problem of a block (whole groups),
// 64 K floats of staging (32 K rows of two right-hand sides).
size_t smem_bytes(int n, int m, int block) {
  const int ld = n | 1;
  const int K = ((n > m ? n : m) + 31) / 32;
  const int P = block_group(block);
  const int slots = (block + P - 1) / P * P;
  return 4 * ((((size_t)ld * (2 * n + m) + 3) & ~(size_t)3) + (size_t)64 * K * slots);
}

Plan plan(int B, int n, int m, int block) {
  Plan p;
  p.K = ((n > m ? n : m) + 31) / 32;
  p.P = block_group(block);
  // small fleets: a warp on every scheduler comes before wider groups
  if (p.P > 1 && (B + p.P - 1) / p.P < kSchedulers) p.P = 1;
  // ... and a block on every SM before larger blocks
  const int share = (B + kSMs - 1) / kSMs;
  p.pb = min(block, max(p.P, share));
  p.warps = min(kMaxWarps, (p.pb + p.P - 1) / p.P);
  p.smem = smem_bytes(n, m, block);
  return p;
}

template <int K, int P>
cudaError_t launch(const Args& a, const Plan& p, cudaStream_t stream) {
  if (p.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(admm_shared_kernel<K, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return e;
  }
  const int grid = (a.B + p.pb - 1) / p.pb;
  admm_shared_kernel<K, P><<<grid, 32 * p.warps, p.smem, stream>>>(a);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_k(const Args& a, const Plan& p, cudaStream_t stream) {
  return p.P == 2 ? launch<K, 2>(a, p, stream) : launch<K, 1>(a, p, stream);
}

}  // namespace

// The layout a launch of B problems of shape (n, m) in blocks of `block`
// takes: out[0..3] = problems a warp advances together, problems per block,
// warps per block, dynamic shared memory in bytes.  Returns 0, or a CUDA
// error code for a shape or block the kernel does not take.
extern "C" int admm_shared_plan(int B, int n, int m, int block, int* out) {
  const int K = ((n > m ? n : m) + 31) / 32;
  if (B <= 0 || n <= 0 || m <= 0 || K > 4 || block < 1 || block > kMaxBlock)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, n, m, block);
  out[0] = p.P;
  out[1] = p.pb;
  out[2] = p.warps;
  out[3] = (int)p.smem;
  return 0;
}

extern "C" int admm_shared_launch(
    const float* Minv, const float* As, const float* Ps, const float* rho, const float* sx,
    const float* sy, const float* c, const float* qs, const float* ls, const float* us,
    const float* l, const float* u, const float* x0, const float* z0, const float* y0,
    const int* status0, float* x, float* z, float* y, int* status, int* iters, float* pres,
    float* dres, int B, int n, int m, int block, float alpha, float sigma, float eps_abs,
    float eps_rel, float eps_pinf, float eps_dinf, int max_iter, int stop_check_iter,
    void* stream) {
  const int K = ((n > m ? n : m) + 31) / 32;
  if (B <= 0) return 0;
  if (n <= 0 || m <= 0 || K > 4 || block < 1 || block > kMaxBlock || stop_check_iter < 1)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, n, m, block);
  Args a{Minv, As, Ps, rho, sx, sy, c, qs, ls, us, l, u, x0, z0, y0, status0,
         x, z, y, status, iters, pres, dres, B, n, m, n | 1, p.pb, 64 * K * p.P,
         alpha, sigma, eps_abs, eps_rel, eps_pinf, eps_dinf, max_iter, stop_check_iter};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  switch (K) {
    case 1: e = launch_k<1>(a, p, s); break;
    case 2: e = launch_k<2>(a, p, s); break;
    case 3: e = launch_k<3>(a, p, s); break;
    default: e = launch_k<4>(a, p, s); break;
  }
  return (int)e;
}
