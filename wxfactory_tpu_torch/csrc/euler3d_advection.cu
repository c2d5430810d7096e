// Tracer advection under prescribed winds on the cubed sphere (DCMIP 11 and
// 12): an interface pass and a volume pass a call (below).
//
// Replaces no TPU kernel: the JAX package runs this operator in XLA, as
// _euler3d_rhs_core(..., advection_only=True) (wxfactory_tpu/models/
// euler_cubesphere.py:90-291; make_rhs_euler_cubesphere returns that XLA
// RHS for advection_only, :733). It was added because the port's main path
// on the card runs hand-written kernels only, and the five-variable 3D
// kernels (euler3d_operator.cu) hold exactly five rows. The plain torch
// version of the same function is wxfactory_tpu_torch/ops/
// euler3d_operator.py::euler3d_advection_plain; the wrapper
// euler3d_advection there launches these kernels.
//
// What it computes. The state holds the five dynamical rows (rho, rho*u1,
// rho*u2, rho*w, rho*theta) and NT tracer rows rho*q_k. The winds are
// prescribed (the step loop overwrites the momenta after every step), so
// the RHS of rows 0-4 is exactly 0 and each tracer row k is
//   -(1/sqrt(g)) (sum_d D_d(sqrt(g) u_d rho q_k) + boundary corrections),
// u_d = (rho u_d) / rho at the nodes. At an interface the flux is the
// Rusanov flux with the advective eigenvalue only,
//   0.5 (sqrt(g) vL qL + sqrt(g) vR qR - max(|vL|, |vR|) sqrt(g) (qR - qL)),
// from each side's trace: rho extrapolated in log space (exp(E.log rho)),
// the normal momentum and the tracers linearly; v = normal momentum / rho.
// At the ground and the lid the mirror state has w odd, so the flux there
// is exactly 0. Modes: RHS; stage a*x + b*y + cdt*RHS(y) over all rows (x
// read only when given: rows 0-4 are then a*x + b*y); and in stage mode the
// output's panel-edge traces of every row, (S, N, W, E), rho and rho*theta
// through log space as ops/euler3d_operator.py::edge_traces has them. The
// rotating planet's time Christoffels enter only rows that are zeroed, so
// no kernel reads them; the metric is one panel's (the flat metric: DCMIP
// 11 and 12 have no topography).
//
// Layouts (C order, T = float or double; nh = nel_h, nk = nel_v, NV = 5 + NT):
//   q, x, out       (NV, 6*nk*nh*nh, s^3)   element (panel, ez, ey, ex),
//                                           node (kz*s + ky)*s + kx
//   halo, traces    (NV, 4, 6, nk, nh, s^2) sides (S, N, W, E), face point
//                                           kz*s + k_along
//   ops1d           en (s) | ep (s) | cn (s) | cp (s) | D (s, s) | HF (s, s)
//   fields          (28, nk*nh*nh, s^3) one panel's metric; rows 0 (sqrt(g))
//                   and 1 (1/sqrt(g)) are read
//   itf_x/y/z       (4, ...) the interface metric of euler3d_operator.cu;
//                   row 0 (sqrt(g)) is read
//
// Design: the five-variable operator's two passes, in a source and a
// library of their own so that those kernels keep their registers and
// bits. The helpers it shares with its Jacobian action
// (euler3d_advection_tangent.cu) are in euler3d_advection_common.cuh. The interface pass (euler3d_advection_interface_kernel) takes one
// thread per interface point of the sphere: both sides' traces (rho, the
// normal momentum and the NT tracers) re-extrapolated from the elements'
// states in device memory in the fma order of euler3d_operator.cu's
// nb_trace (and of the trace emission below), or the halo at a panel edge;
// each tracer's flux, once, into device memory (rows from a pool of the
// library's own). The volume pass (euler3d_advection_volume_kernel) takes
// one thread per solution point, EB = 256 / s^3 elements a block: the
// pointwise fluxes sqrt(g) u_d q_k into shared memory, the divergence with
// the 1D derivative along one axis at a time, the boundary corrections
// from the stored fluxes of the element's six faces, the stage combination,
// the output and its panel-edge traces. Both elements of an interface read
// the one stored flux, so each tracer's mass integral of the RHS is zero to
// round-off within a panel (across a panel edge each panel forms the flux
// from the exchanged halo, as the five-variable operator does).
//
// What bounds it (NVIDIA H100 SXM, 3.35 TB/s; float64, 30x30x20, s = 3,
// NT = 4, 2,916,000 nodes): a call must read q (9 rows, 210 MB), sqrt(g)
// and 1/sqrt(g) (one panel, 7.8 MB), the interface sqrt(g) and write out
// (210 MB), in stage mode also read x (210 MB): 0.43-0.64 GB, 0.13-0.19 ms.
// Its ~0.1 GFLOP take ~3 us at the 34 TFLOP/s f64 vector peak: bytes bound
// it. The interface pass also re-reads the neighbour nodes along each face
// line (s loads a trace row, two sides) and writes and reads NT flux rows a
// point (f64: 4 x 8 bytes x ~2.8 M points each way), so the design's floor
// sits above the function's. A first kernel, right and simple; kernels/
// check.py::euler3d_advection_work counts the function's bytes and
// operations.

#include "euler3d_advection_common.cuh"

namespace {

using namespace e3adv;

// The interface pass: one thread per interface point of the sphere, each
// computed once. Both sides' traces from the elements' states in device
// memory or from the halo; each tracer's Rusanov flux with (L, R) in the
// fixed west/south/lower order into `rows`. The ground and the lid mirror
// the element's own trace with w odd: their flux is exactly 0.
template <typename T, int S, int NT>
__global__ void __launch_bounds__(kItfThreads) euler3d_advection_interface_kernel(
    const T* __restrict__ q, const T* __restrict__ halo, const T* __restrict__ ops, const T* __restrict__ itf_x,
    const T* __restrict__ itf_y, const T* __restrict__ itf_z, T* __restrict__ rows, int nh, int nk) {
  using Ops = Shape<T, S>;
  constexpr int S2 = S * S;
  __shared__ __align__(16) T sOps[2 * Ops::PS];  // en | ep, each on a 16-byte boundary
  if (threadIdx.x < 2 * S) sOps[(threadIdx.x / S) * Ops::PS + threadIdx.x % S] = ops[threadIdx.x];
  __syncthreads();
  const ItfLayout lay(nh, nk, S);
  long long i = blockIdx.x * (long long)kItfThreads + threadIdx.x;
  int d = 0;
  if (i >= lay.nx) {
    i -= lay.nx;
    d = 1;
    if (i >= lay.nx) {
      i -= lay.nx;
      d = 2;
      if (i >= lay.nz) return;
    }
  }
  const int per_panel = nk * nh * nh;
  const long long nq = (long long)kPanels * per_panel * S * S2;  // stride between variables
  const long long hv = 4LL * kPanels * nk * nh * S2;            // stride between halo variables
  const int k = (int)(i % S2);
  unsigned t = (unsigned)(i / S2);  // the interface in its family
  const unsigned uh = nh, uk = nk;
  T* row = rows + lay.base(d, NT) + i;
  const long long rs = lay.count(d);  // stride between rows
  int p, kz, gy, gx;
  bool halo_l = false, halo_r = false;
  long long el = 0, er = 0, hl = 0, hr = 0, iidx;
  const T* itf;
  if (d == 0) {  // between elements gx-1 (L) and gx (R) of row gy
    gx = (int)(t % (uh + 1));
    t /= uh + 1;
    gy = (int)(t % uh);
    t /= uh;
    kz = (int)(t % uk);
    p = (int)(t / uk);
    halo_l = gx == 0;
    halo_r = gx == nh;
    hl = ((((long long)2 * kPanels + p) * nk + kz) * nh + gy) * S2 + k;  // W side
    hr = ((((long long)3 * kPanels + p) * nk + kz) * nh + gy) * S2 + k;  // E side
    el = (long long)p * per_panel + (kz * nh + gy) * nh + gx - 1;
    er = el + 1;
    itf = itf_x;
    iidx = ((long long)(kz * nh + gy) * (nh + 1) + gx) * S2 + k;
  } else if (d == 1) {  // between elements gy-1 (L) and gy (R) of column gx
    gx = (int)(t % uh);
    t /= uh;
    gy = (int)(t % (uh + 1));
    t /= uh + 1;
    kz = (int)(t % uk);
    p = (int)(t / uk);
    halo_l = gy == 0;
    halo_r = gy == nh;
    hl = ((((long long)0 * kPanels + p) * nk + kz) * nh + gx) * S2 + k;  // S side
    hr = ((((long long)1 * kPanels + p) * nk + kz) * nh + gx) * S2 + k;  // N side
    el = (long long)p * per_panel + (kz * nh + gy - 1) * nh + gx;
    er = el + nh;
    itf = itf_y;
    iidx = ((long long)(kz * (nh + 1) + gy) * nh + gx) * S2 + k;
  } else {  // between levels kz-1 (L) and kz (R) of column (gy, gx)
    gx = (int)(t % uh);
    t /= uh;
    gy = (int)(t % uh);
    t /= uh;
    kz = (int)(t % (uk + 1));
    if (kz == 0 || kz == nk) {  // ground / rigid lid: the mirror's flux is 0
#pragma unroll
      for (int n = 0; n < NT; ++n) row[n * rs] = T(0);
      return;
    }
    p = (int)(t / (uk + 1));
    el = (long long)p * per_panel + ((kz - 1) * nh + gy) * nh + gx;
    er = el + nh * nh;
    itf = itf_z;
    iidx = ((long long)(kz * nh + gy) * nh + gx) * S2 + k;
  }
  T rhoL, momL, L[NT], rhoR, momR, R[NT];
  if (halo_l)
    halo_trace<T, NT>(halo, hv, hl, d, rhoL, momL, L);
  else
    device_trace<T, S, NT>(q, nq, el, d, k, sOps + Ops::PS, rhoL, momL, L);
  if (halo_r)
    halo_trace<T, NT>(halo, hv, hr, d, rhoR, momR, R);
  else
    device_trace<T, S, NT>(q, nq, er, d, k, sOps, rhoR, momR, R);
  const T sg = itf[iidx];
  const T vL = momL / rhoL, vR = momR / rhoR;
  const T eig = fmax(fabs(vL), fabs(vR));
  const T sl = sg * vL, sr = sg * vR, es = eig * sg;
#pragma unroll
  for (int n = 0; n < NT; ++n) row[n * rs] = T(0.5) * (sl * L[n] + sr * R[n] - es * (R[n] - L[n]));
}

// Shared memory of the volume pass (in T): ops1d, then per element [the
// state's NV rows (s^3 each; the output once it is formed, for the traces)
// | the pointwise fluxes (3 directions x NT tracers x s^3)]. Every region
// starts on a 16-byte boundary.
template <typename T, int S, int NT>
struct VolShape {
  using Sh = Shape<T, S>;
  static constexpr int NV = kDyn + NT;
  static constexpr int S2 = Sh::S2, S3 = Sh::S3, EB = Sh::EB;
  static constexpr int OFF_F = Sh::pad(NV * S3);
  static constexpr int PER_ELEM = OFF_F + Sh::pad(3 * NT * S3);
  static constexpr int SIZE = Sh::N_OPS + EB * PER_ELEM;
};

// The volume pass: one thread per solution point, EB = 256 / s^3 elements
// per block (the panel the fastest block index, so the one-panel metric is
// read from device memory about once and from L2 by the other five
// panels): the pointwise fluxes, the divergence, the boundary corrections
// from the stored fluxes of the element's six faces, rows 0-4 exactly 0 in
// the RHS, the stage combination, the output and its panel-edge traces.
template <typename T, int S, int NT>
__global__ void __launch_bounds__(kThreads) euler3d_advection_volume_kernel(
    const T* __restrict__ q, const T* __restrict__ ops, const T* __restrict__ fields, const T* __restrict__ x,
    const T* __restrict__ rows, T* __restrict__ out, T* __restrict__ traces, int nh, int nk, T a, T b, T cdt,
    int stage) {
  using Sh = VolShape<T, S, NT>;
  using Ops = Shape<T, S>;
  constexpr int S2 = Sh::S2, S3 = Sh::S3, NV = Sh::NV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const T* sEn = smem;
  const T* sEp = smem + Ops::PS;
  const T* sCn = smem + 2 * Ops::PS;
  const T* sCp = smem + 3 * Ops::PS;
  const T* sD = smem + 4 * Ops::PS;

  const int tid = threadIdx.x;
  const int e_loc = tid / S3;
  const int j = tid - e_loc * S3;
  const int per_panel = nk * nh * nh;
  const int p = blockIdx.x % kPanels;
  const int pe = (blockIdx.x / kPanels) * Sh::EB + e_loc;
  const bool valid = pe < per_panel;
  const long long elem = (long long)p * per_panel + pe;
  const long long nq = (long long)kPanels * per_panel * S3;  // stride between variables
  const long long fstride = (long long)per_panel * S3;       // stride between metric fields

  T* sQ = smem + Ops::N_OPS + e_loc * Sh::PER_ELEM;
  T* sF = sQ + Sh::OFF_F;
  load_ops<T, S>(ops, smem);

  int kz = 0, ey = 0, ex = 0;
  const T* fld = fields + (long long)(valid ? pe : 0) * S3 + j;
  if (valid) {
    kz = pe / (nh * nh);
    const int r = pe - kz * nh * nh;
    ey = r / nh;
    ex = r - ey * nh;
    // --- Pointwise: sqrt(g) u_d q_k, u_d = (rho u_d) / rho.
    const T* qn = q + elem * S3 + j;
    const T rho = qn[0];
    const T sqrtg = fld[F_SQRTG * fstride];
    const T su[3] = {sqrtg * (qn[nq] / rho), sqrtg * (qn[2 * nq] / rho), sqrtg * (qn[3 * nq] / rho)};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const T qk = qn[(kDyn + n) * nq];
#pragma unroll
      for (int d = 0; d < 3; ++d) sF[(d * NT + n) * S3 + j] = su[d] * qk;
    }
  }
  __syncthreads();

  // --- Divergence + corrections, stage.
  if (valid) {
    const int jx = j % S, jy = (j / S) % S, jz = j / S2;
    const int lx = (jz * S + jy) * S, ly = jz * S2 + jx, lz = jy * S + jx;  // line bases
    const int kxf = jz * S + jy, kyf = jz * S + jx, kzf = jy * S + jx;    // face points
    const T* Dx = sD + jx * S;
    const T* Dy = sD + jy * S;
    const T* Dz = sD + jz * S;
    // This node's six interface points (W, E, S, N, D, U) in the flux rows.
    const ItfLayout lay(nh, nk, S);
    const T* rx = rows;
    const T* ry = rows + lay.base(1, NT);
    const T* rz = rows + lay.base(2, NT);
    const long long nx = lay.nx, nz = lay.nz;
    const int iw = (((p * nk + kz) * nh + ey) * (nh + 1) + ex) * S2 + kxf, ie = iw + S2;
    const int is = (((p * nk + kz) * (nh + 1) + ey) * nh + ex) * S2 + kyf, in = is + nh * S2;
    const int id = (((p * (nk + 1) + kz) * nh + ey) * nh + ex) * S2 + kzf, iu = id + nh * nh * S2;
    const T cnx = sCn[jx], cpx = sCp[jx], cny = sCn[jy], cpy = sCp[jy], cnz = sCn[jz], cpz = sCp[jz];
    const T invsg = fld[F_INVSG * fstride];
    T r[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const T* fx = sF + n * S3;
      const T* fy = sF + (NT + n) * S3;
      const T* fz = sF + (2 * NT + n) * S3;
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < S; ++i) acc = fmadd(Dx[i], fx[lx + i], acc);
#pragma unroll
      for (int i = 0; i < S; ++i) acc = fmadd(Dy[i], fy[ly + i * S], acc);
#pragma unroll
      for (int i = 0; i < S; ++i) acc = fmadd(Dz[i], fz[lz + i * S2], acc);
      const T corr = cnx * rx[n * nx + iw] + cpx * rx[n * nx + ie] + cny * ry[n * nx + is] +
                     cpy * ry[n * nx + in] + cnz * rz[n * nz + id] + cpz * rz[n * nz + iu];
      r[n] = -invsg * (acc + corr);
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const long long o = v * nq + elem * S3 + j;
      T val = v < kDyn ? T(0) : r[v - kDyn];
      if (stage) {
        val = b * q[o] + cdt * val;
        if (x != nullptr) val = a * x[o] + val;
      }
      out[o] = val;
      sQ[v * S3 + j] = val;  // only this thread reads this slot before the barrier below
    }
  }

  // --- Panel-edge traces of the output state (x and y faces on an edge):
  // rho and rho*theta through log space, the other rows linear, in the fma
  // order of the interface pass's device_trace, which re-extrapolates them.
  if (traces != nullptr) {
    __syncthreads();
    if (valid) {
      for (int fi = j; fi < 4 * S2; fi += S3) {
        const int face = fi / S2;
        const int k = fi - face * S2;
        bool on_edge;
        int tside, along;
        switch (face) {
          case 0: on_edge = ex == 0;      tside = 2; along = ey; break;
          case 1: on_edge = ex == nh - 1; tside = 3; along = ey; break;
          case 2: on_edge = ey == 0;      tside = 0; along = ex; break;
          default: on_edge = ey == nh - 1; tside = 1; along = ex; break;
        }
        if (!on_edge) continue;
        int base, stride;
        face_line<S>(face >> 1, k, base, stride);
        const T* coef = (face & 1) ? sEp : sEn;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const bool lg = v == 0 || v == 4;
          const long long t = ((((long long)(v * 4 + tside) * kPanels + p) * nk + kz) * nh + along) * S2 + k;
          T acc = T(0);
#pragma unroll
          for (int i = 0; i < S; ++i) {
            const T val = sQ[v * S3 + base + i * stride];
            acc = fmadd(lg ? tlog(val) : val, coef[i], acc);
          }
          traces[t] = lg ? texp(acc) : acc;
        }
      }
    }
  }
}

// The flux rows of a call live between its two launches: stream-ordered
// allocations from a memory pool of this library's own (one a device),
// which keeps freed memory for the next call (the C entry takes no scratch
// buffer).
cudaError_t rows_alloc(void** ptr, size_t bytes, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static cudaMemPool_t pools[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (pools[dev] == nullptr) {
    cudaMemPoolProps props = {};
    props.allocType = cudaMemAllocationTypePinned;
    props.location.type = cudaMemLocationTypeDevice;
    props.location.id = dev;
    cudaMemPool_t pool;
    err = cudaMemPoolCreate(&pool, &props);
    if (err != cudaSuccess) return err;
    unsigned long long keep = ~0ULL;
    err = cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold, &keep);
    if (err != cudaSuccess) return err;
    pools[dev] = pool;
  }
  return cudaMallocFromPoolAsync(ptr, bytes, pools[dev], stream);
}

template <typename T, int S, int NT>
cudaError_t launch(int nh, int nk, const void* q, const void* halo, const void* ops, const void* fields,
                   const void* itf_x, const void* itf_y, const void* itf_z, const void* x, void* out, void* traces,
                   double a, double b, double cdt, int stage, cudaStream_t stream) {
  using Sh = VolShape<T, S, NT>;
  const size_t smem = sizeof(T) * (size_t)Sh::SIZE;
  static bool configured = false;
  cudaError_t err = configure(euler3d_advection_volume_kernel<T, S, NT>, smem, configured);
  if (err != cudaSuccess) return err;
  const ItfLayout lay(nh, nk, S);
  void* rows = nullptr;
  err = rows_alloc(&rows, sizeof(T) * NT * (size_t)lay.points(), stream);
  if (err != cudaSuccess) return err;
  const unsigned itf_blocks = (unsigned)((lay.points() + kItfThreads - 1) / kItfThreads);
  euler3d_advection_interface_kernel<T, S, NT><<<itf_blocks, kItfThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(halo), static_cast<const T*>(ops),
      static_cast<const T*>(itf_x), static_cast<const T*>(itf_y), static_cast<const T*>(itf_z),
      static_cast<T*>(rows), nh, nk);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    const int blocks = kPanels * ((nk * nh * nh + Sh::EB - 1) / Sh::EB);
    euler3d_advection_volume_kernel<T, S, NT><<<blocks, Sh::EB * Sh::S3, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(ops), static_cast<const T*>(fields),
        static_cast<const T*>(x), static_cast<const T*>(rows), static_cast<T*>(out), static_cast<T*>(traces), nh,
        nk, T(a), T(b), T(cdt), stage);
    err = cudaGetLastError();
  }
  const cudaError_t freed = cudaFreeAsync(rows, stream);
  return err != cudaSuccess ? err : freed;
}

template <typename T, int NT>
cudaError_t dispatch(int s, int nh, int nk, const void* q, const void* halo, const void* ops, const void* fields,
                     const void* itf_x, const void* itf_y, const void* itf_z, const void* x, void* out, void* traces,
                     double a, double b, double cdt, int stage, cudaStream_t stream) {
#define ADV_CASE(S)                                                                                          \
  case S:                                                                                                    \
    return launch<T, S, NT>(nh, nk, q, halo, ops, fields, itf_x, itf_y, itf_z, x, out, traces, a, b, cdt, stage, \
                            stream);
  switch (s) {
    ADV_CASE(2) ADV_CASE(3) ADV_CASE(4) ADV_CASE(5) ADV_CASE(6)
    default: return cudaErrorInvalidValue;
  }
#undef ADV_CASE
}

template <typename T>
cudaError_t dispatch_nt(int nt, int s, int nh, int nk, const void* q, const void* halo, const void* ops,
                        const void* fields, const void* itf_x, const void* itf_y, const void* itf_z, const void* x,
                        void* out, void* traces, double a, double b, double cdt, int stage, cudaStream_t stream) {
  if (nt == 1)
    return dispatch<T, 1>(s, nh, nk, q, halo, ops, fields, itf_x, itf_y, itf_z, x, out, traces, a, b, cdt, stage,
                          stream);
  if (nt == 4)
    return dispatch<T, 4>(s, nh, nk, q, halo, ops, fields, itf_x, itf_y, itf_z, x, out, traces, a, b, cdt, stage,
                          stream);
  return cudaErrorInvalidValue;
}

template <typename T, int S, int NT>
cudaError_t resources(int kernel, int* info) {
  if (kernel == 0) return kernel_resources(euler3d_advection_interface_kernel<T, S, NT>, kItfThreads, 0, info);
  using Sh = VolShape<T, S, NT>;
  return kernel_resources(euler3d_advection_volume_kernel<T, S, NT>, Sh::EB * Sh::S3, sizeof(T) * (size_t)Sh::SIZE,
                          info);
}

template <typename T, int NT>
cudaError_t dispatch_resources(int s, int kernel, int* info) {
  switch (s) {
    case 2: return resources<T, 2, NT>(kernel, info);
    case 3: return resources<T, 3, NT>(kernel, info);
    case 4: return resources<T, 4, NT>(kernel, info);
    case 5: return resources<T, 5, NT>(kernel, info);
    case 6: return resources<T, 6, NT>(kernel, info);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_resources_nt(int nt, int s, int kernel, int* info) {
  if (nt == 1) return dispatch_resources<T, 1>(s, kernel, info);
  if (nt == 4) return dispatch_resources<T, 4>(s, kernel, info);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* euler3d_advection_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The advection operator on q (5 + nt rows) with its halo (layouts above);
// nt is 1 (DCMIP 12) or 4 (DCMIP 11). x == NULL: no x term; traces == NULL:
// no trace emission (emission needs stage != 0); stage == 0: out = RHS(q).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int euler3d_advection_launch(int is_f64, int s, int nt, int nh, int nk, const void* q, const void* halo,
                                        const void* ops, const void* fields, const void* itf_x, const void* itf_y,
                                        const void* itf_z, const void* x, void* out, void* traces, double a,
                                        double b, double cdt, int stage, void* stream) {
  if (nh < 2 || nk < 1 || (traces != nullptr && !stage)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_f64 ? dispatch_nt<double>(nt, s, nh, nk, q, halo, ops, fields, itf_x, itf_y, itf_z, x, out, traces, a, b,
                                   cdt, stage, st)
             : dispatch_nt<float>(nt, s, nh, nk, q, halo, ops, fields, itf_x, itf_y, itf_z, x, out, traces, a, b,
                                  cdt, stage, st);
  return (int)err;
}

// What the runtime reports of the two kernels (kernel 0: the interface
// pass, 1: the volume pass): info = [registers, local (spill) bytes a
// thread, dynamic shared memory bytes a block, resident blocks an SM,
// threads a block].
extern "C" int euler3d_advection_resources(int is_f64, int s, int nt, int kernel, int* info) {
  return (int)(is_f64 ? dispatch_resources_nt<double>(nt, s, kernel, info)
                      : dispatch_resources_nt<float>(nt, s, kernel, info));
}
