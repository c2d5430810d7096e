// The Jacobian action J(q).v of the tracer-advection operator of DCMIP 11
// and 12 (euler3d_advection.cu): a prep once per linearisation point and a
// linear apply once per direction (below).
//
// Replaces no TPU kernel: the JAX package takes jax.jvp of its XLA
// advection-only RHS (_euler3d_rhs_core(..., advection_only=True),
// wxfactory_tpu/models/euler_cubesphere.py:90-291). It was added because a
// Krylov loop on these cases needs J.v on the card, and torch.func.jvp cannot
// pass through a kernel launched with ctypes. The plain torch versions of the
// two kernels are wxfactory_tpu_torch/ops/euler3d_operator.py::
// euler3d_advection_tangent_prep_plain and _apply_plain; the wrappers
// euler3d_advection_tangent_prep and _apply there launch these kernels.
//
// What it computes. For v = (d rho, d m_1..3, d rho*theta, d T_k), rows 0-4
// of J.v are exactly 0 and d rho*theta enters nothing; each tracer row is
//   -(1/sqrt(g)) (sum_d D_d(sqrt(g) (u_d dT_k + (T_k/rho)(dm_d - u_d d rho)))
//                 + the boundary corrections of the flux derivative),
// and at an interface the derivative of the Rusanov flux of the RHS,
//   0.5 (sg (dvL TL + vL dTL) + sg (dvR TR + vR dTR)
//        - sg (d eig (TR - TL) + eig (dTR - dTL))),
// from the direction's traces d rho_L = rho_L E.(d rho / rho), dm_L = E.dm,
// dT_L = E.dT, dv_L = (dm_L - v_L d rho_L) / rho_L (the halo of v at a panel
// edge: ops/euler3d_operator.py::edge_traces_tangent), and d eig = c_L dv_L
// + c_R dv_R with eig = max(|vL|, |vR|): jax.jvp's rules, d|x| = +dx at x = 0
// and at -0, the mean of both sides' derivatives at a tie |vL| = |vR|. At
// the ground and the lid the flux derivative is exactly 0.
//
// Layouts (C order, T = float or double; nh = nel_h, nk = nel_v, NV = 5 + NT,
// nodes = 6*nk*nh*nh*s^3):
//   q, v, out        (NV, 6*nk*nh*nh, s^3) as in euler3d_advection.cu
//   halo_q, halo_v   (NV, 4, 6, nk, nh, s^2)
//   coef             node rows (4 + NT, nodes): 1/rho, u_1, u_2, u_3, T_k/rho;
//                    then the x, y and z families of FaceLayout (the
//                    interface points off the ground and the lid), each
//                    (7 + 2 NT, family points): rho_L, rho_R, v_L, v_R, eig,
//                    c_L, c_R, T_L (NT), T_R (NT)
//                    (ops/euler3d_operator.py::advection_tangent_layout)
//   rows             the apply's scratch: NT flux rows a family of ItfLayout
//   ops1d, fields, itf_x/y/z as in euler3d_advection.cu
//
// Design: the prep is two passes, one thread a node (the node rows, with
// the divisions) and one thread an interface point off the ground and the
// lid (both sides' primal traces re-extrapolated from q with the RHS's
// device_trace, euler3d_advection_common.cuh, or taken from the halo at a
// panel edge; the normal speeds, the eigenvalue and the tie weights). The
// apply is the RHS kernel's two passes, linear in v, with no transcendental
// and two divisions an interface point: the interface pass forms each
// tracer's flux derivative once, into the caller's scratch rows, from the
// direction's traces re-extrapolated from v and the node rows (or the halo
// of v), and writes 0 at the ground and the lid; the volume pass (EB = 256 /
// s^3 elements a block) puts the pointwise flux derivatives into shared
// memory and takes the divergence and the boundary corrections from the
// stored fluxes of the element's six faces. Both elements of an interface
// read one stored flux, so each tracer's mass integral of J.v is zero to
// round-off within a panel.
//
// What bounds it (NVIDIA H100 SXM, 3.35 TB/s; float64, 30x30x20, s = 3,
// NT = 4, 2,916,000 nodes): J.v from q and v must read rho, the momenta and
// the tracers of q and of v (8 rows each, 187 MB each), the halos, one
// panel's sqrt(g) and 1/sqrt(g), the interface sqrt(g), and write J.v (9
// rows, 210 MB): ~0.6 GB, ~0.18 ms; its ~0.2 GFLOP take ~6 us at the 34
// TFLOP/s float64 peak, so bytes bound it. The apply reads the coefficient
// buffer instead of q (8 node rows and 15 rows an interface point: ~0.5 GB
// at this shape), its price for doing no transcendental and no division at
// the nodes: its own floor sits above the function's (kernels/check.py::
// euler3d_advection_tangent_{work,prep_work,apply_work}). A first kernel,
// right and simple.

#include "euler3d_advection_common.cuh"

namespace {

using namespace e3adv;

constexpr int kNodeRows = 4;   // 1/rho, u_1, u_2, u_3 ahead of T_k / rho
constexpr int kFaceRows = 7;   // rho_L .. c_R ahead of T_L, T_R

// Face rows.
constexpr int R_RHO_L = 0, R_RHO_R = 1, R_V_L = 2, R_V_R = 3, R_EIG = 4, R_C_L = 5, R_C_R = 6;

// Where the face rows live: the interface points of ItfLayout less the
// ground's and the lid's (no flux derivative to form there), x (6, nk, nh,
// nh+1, s^2), y (6, nk, nh+1, nh, s^2) and z (6, nk-1, nh, nh, s^2); row r
// of point f of family d at base(d, rows) + r * count(d) + f.
struct FaceLayout {
  long long nx, nz;
  __host__ __device__ FaceLayout(int nh, int nk, int s) {
    nx = (long long)kPanels * nk * nh * (nh + 1) * s * s;
    nz = (long long)kPanels * (nk - 1) * nh * nh * s * s;
  }
  __device__ __forceinline__ long long count(int d) const { return d == 2 ? nz : nx; }
  __device__ __forceinline__ long long base(int d, int rows) const { return d * rows * nx; }
};

// One interface point as a thread of an interface pass decodes it (the
// decoding of euler3d_advection.cu's interface pass): its family d, its
// index i there (its flux rows') and f in FaceLayout (its face rows'), its
// face point k, the elements on its two sides (el, er) or their halo
// entries (hl, hr) at a panel edge and its interface-metric entry; or, for
// the z family, that it lies on the ground (kz == 0) or the lid (kz == nk),
// where the flux derivative is exactly 0 and nothing else is decoded.
struct Point {
  int d, k;
  long long i, f, el, er, hl, hr, iidx;
  bool halo_l, halo_r, ground_or_lid;
};

template <int S>
__device__ __forceinline__ bool decode_point(long long i, int nh, int nk, Point& pt) {
  constexpr int S2 = S * S;
  const ItfLayout lay(nh, nk, S);
  int d = 0;
  if (i >= lay.nx) {
    i -= lay.nx;
    d = 1;
    if (i >= lay.nx) {
      i -= lay.nx;
      d = 2;
      if (i >= lay.nz) return false;
    }
  }
  const int per_panel = nk * nh * nh;
  const int k = (int)(i % S2);
  unsigned t = (unsigned)(i / S2);
  const unsigned uh = nh, uk = nk;
  int p, kz, gy, gx;
  pt.d = d;
  pt.k = k;
  pt.i = i;
  pt.f = i;
  pt.halo_l = pt.halo_r = pt.ground_or_lid = false;
  pt.el = pt.er = pt.hl = pt.hr = 0;
  if (d == 0) {  // between elements gx-1 (L) and gx (R) of row gy
    gx = (int)(t % (uh + 1));
    t /= uh + 1;
    gy = (int)(t % uh);
    t /= uh;
    kz = (int)(t % uk);
    p = (int)(t / uk);
    pt.halo_l = gx == 0;
    pt.halo_r = gx == nh;
    pt.hl = ((((long long)2 * kPanels + p) * nk + kz) * nh + gy) * S2 + k;  // W side
    pt.hr = ((((long long)3 * kPanels + p) * nk + kz) * nh + gy) * S2 + k;  // E side
    pt.el = (long long)p * per_panel + (kz * nh + gy) * nh + gx - 1;
    pt.er = pt.el + 1;
    pt.iidx = ((long long)(kz * nh + gy) * (nh + 1) + gx) * S2 + k;
  } else if (d == 1) {  // between elements gy-1 (L) and gy (R) of column gx
    gx = (int)(t % uh);
    t /= uh;
    gy = (int)(t % (uh + 1));
    t /= uh + 1;
    kz = (int)(t % uk);
    p = (int)(t / uk);
    pt.halo_l = gy == 0;
    pt.halo_r = gy == nh;
    pt.hl = ((((long long)0 * kPanels + p) * nk + kz) * nh + gx) * S2 + k;  // S side
    pt.hr = ((((long long)1 * kPanels + p) * nk + kz) * nh + gx) * S2 + k;  // N side
    pt.el = (long long)p * per_panel + (kz * nh + gy - 1) * nh + gx;
    pt.er = pt.el + nh;
    pt.iidx = ((long long)(kz * (nh + 1) + gy) * nh + gx) * S2 + k;
  } else {  // between levels kz-1 (L) and kz (R) of column (gy, gx)
    gx = (int)(t % uh);
    t /= uh;
    gy = (int)(t % uh);
    t /= uh;
    kz = (int)(t % (uk + 1));
    p = (int)(t / (uk + 1));
    pt.ground_or_lid = kz == 0 || kz == nk;
    if (pt.ground_or_lid) return true;
    pt.f = ((((long long)p * (nk - 1) + kz - 1) * nh + gy) * nh + gx) * S2 + k;
    pt.el = (long long)p * per_panel + ((kz - 1) * nh + gy) * nh + gx;
    pt.er = pt.el + nh * nh;
    pt.iidx = ((long long)(kz * nh + gy) * nh + gx) * S2 + k;
  }
  return true;
}

// One side's direction trace, from v and the node rows in device memory:
// d rho = rho_face E.(d rho / rho) (d rho / rho formed at each node from the
// node row 1/rho), the normal momentum and the tracers linearly.
template <typename T, int S, int NT>
__device__ __forceinline__ void direction_trace(const T* v, const T* irho, long long nq, long long elem, int d,
                                                int k, const T* coef, T rho_face, T& drho, T& dmom, T* dtr) {
  constexpr int S3 = S * S * S;
  int base, stride;
  face_line<S>(d, k, base, stride);
  const long long off = elem * S3 + base;
  const T* src = v + off;
  const T* ir = irho + off;
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < S; ++i) acc = fmadd(src[i * stride] * ir[i * stride], coef[i], acc);
  drho = rho_face * acc;
  acc = T(0);
#pragma unroll
  for (int i = 0; i < S; ++i) acc = fmadd(src[(1 + d) * nq + i * stride], coef[i], acc);
  dmom = acc;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    acc = T(0);
#pragma unroll
    for (int i = 0; i < S; ++i) acc = fmadd(src[(kDyn + t) * nq + i * stride], coef[i], acc);
    dtr[t] = acc;
  }
}

// --- The prep.

// Node pass: one thread a node, the node rows 1/rho, u_d = m_d / rho and
// T_k / rho.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads) euler3d_advection_tangent_prep_node_kernel(const T* __restrict__ q,
                                                                                      T* __restrict__ coef,
                                                                                      long long nq) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= nq) return;
  const T rho = q[i];
  coef[i] = T(1) / rho;
#pragma unroll
  for (int d = 0; d < 3; ++d) coef[(1 + d) * nq + i] = q[(1 + d) * nq + i] / rho;
#pragma unroll
  for (int n = 0; n < NT; ++n) coef[(kNodeRows + n) * nq + i] = q[(kDyn + n) * nq + i] / rho;
}

// Interface pass: one thread an interface point off the ground and the lid,
// both sides' primal traces (from q, in the RHS's device_trace, or the
// halo), the normal speeds, the eigenvalue max(|vL|, |vR|) and its
// derivative's weights, into the face rows.
template <typename T, int S, int NT>
__global__ void __launch_bounds__(kItfThreads) euler3d_advection_tangent_prep_interface_kernel(
    const T* __restrict__ q, const T* __restrict__ halo, const T* __restrict__ ops, T* __restrict__ coef, int nh,
    int nk) {
  using Ops = Shape<T, S>;
  constexpr int S2 = S * S;
  constexpr int NF = kFaceRows + 2 * NT;
  __shared__ __align__(16) T sOps[2 * Ops::PS];  // en | ep, each on a 16-byte boundary
  if (threadIdx.x < 2 * S) sOps[(threadIdx.x / S) * Ops::PS + threadIdx.x % S] = ops[threadIdx.x];
  __syncthreads();
  Point pt;
  if (!decode_point<S>(blockIdx.x * (long long)kItfThreads + threadIdx.x, nh, nk, pt) || pt.ground_or_lid) return;
  const FaceLayout lay(nh, nk, S);
  const long long nq = (long long)kPanels * nk * nh * nh * S * S2;  // stride between variables (and node rows)
  const long long hv = 4LL * kPanels * nk * nh * S2;               // stride between halo variables
  const int d = pt.d;
  T rhoL, momL, L[NT], rhoR, momR, R[NT];
  if (pt.halo_l)
    halo_trace<T, NT>(halo, hv, pt.hl, d, rhoL, momL, L);
  else
    device_trace<T, S, NT>(q, nq, pt.el, d, pt.k, sOps + Ops::PS, rhoL, momL, L);
  if (pt.halo_r)
    halo_trace<T, NT>(halo, hv, pt.hr, d, rhoR, momR, R);
  else
    device_trace<T, S, NT>(q, nq, pt.er, d, pt.k, sOps, rhoR, momR, R);
  const T vL = momL / rhoL, vR = momR / rhoR;
  const T aL = fabs(vL), aR = fabs(vR);
  // d max(aL, aR): the larger side's derivative, the mean of both at a tie;
  // d|x| = +dx at x >= 0 (and -0).
  const T wL = aL > aR ? T(1) : (aL < aR ? T(0) : T(0.5));
  const T wR = T(1) - wL;
  T* row = coef + (long long)(kNodeRows + NT) * nq + lay.base(d, NF) + pt.f;
  const long long rs = lay.count(d);
  row[R_RHO_L * rs] = rhoL;
  row[R_RHO_R * rs] = rhoR;
  row[R_V_L * rs] = vL;
  row[R_V_R * rs] = vR;
  row[R_EIG * rs] = fmax(aL, aR);
  row[R_C_L * rs] = vL >= T(0) ? wL : -wL;
  row[R_C_R * rs] = vR >= T(0) ? wR : -wR;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    row[(kFaceRows + n) * rs] = L[n];
    row[(kFaceRows + NT + n) * rs] = R[n];
  }
}

// --- The apply.

// Interface pass: one thread an interface point, each tracer's flux
// derivative once into `rows` (NT rows a family in ItfLayout; 0 at the
// ground and the lid), from the face rows and both sides' direction traces.
template <typename T, int S, int NT>
__global__ void __launch_bounds__(kItfThreads) euler3d_advection_tangent_interface_kernel(
    const T* __restrict__ v, const T* __restrict__ halo, const T* __restrict__ ops, const T* __restrict__ itf_x,
    const T* __restrict__ itf_y, const T* __restrict__ itf_z, const T* __restrict__ coef, T* __restrict__ rows,
    int nh, int nk) {
  using Ops = Shape<T, S>;
  constexpr int S2 = S * S;
  constexpr int NF = kFaceRows + 2 * NT;
  __shared__ __align__(16) T sOps[2 * Ops::PS];  // en | ep
  if (threadIdx.x < 2 * S) sOps[(threadIdx.x / S) * Ops::PS + threadIdx.x % S] = ops[threadIdx.x];
  __syncthreads();
  Point pt;
  if (!decode_point<S>(blockIdx.x * (long long)kItfThreads + threadIdx.x, nh, nk, pt)) return;
  const ItfLayout lay(nh, nk, S);
  const int d = pt.d;
  T* row = rows + lay.base(d, NT) + pt.i;
  const long long rs = lay.count(d);
  if (pt.ground_or_lid) {  // the mirror's flux derivative is exactly 0
#pragma unroll
    for (int n = 0; n < NT; ++n) row[n * rs] = T(0);
    return;
  }
  const long long nq = (long long)kPanels * nk * nh * nh * S * S2;
  const long long hv = 4LL * kPanels * nk * nh * S2;
  const FaceLayout fl(nh, nk, S);
  const long long fs = fl.count(d);  // stride between face rows
  const T* face = coef + (long long)(kNodeRows + NT) * nq + fl.base(d, NF) + pt.f;
  const T rhoL = face[R_RHO_L * fs], rhoR = face[R_RHO_R * fs];
  T drL, dmL, dL[NT], drR, dmR, dR[NT];
  if (pt.halo_l)
    halo_trace<T, NT>(halo, hv, pt.hl, d, drL, dmL, dL);
  else
    direction_trace<T, S, NT>(v, coef, nq, pt.el, d, pt.k, sOps + Ops::PS, rhoL, drL, dmL, dL);
  if (pt.halo_r)
    halo_trace<T, NT>(halo, hv, pt.hr, d, drR, dmR, dR);
  else
    direction_trace<T, S, NT>(v, coef, nq, pt.er, d, pt.k, sOps, rhoR, drR, dmR, dR);
  const T vL = face[R_V_L * fs], vR = face[R_V_R * fs];
  const T dvL = (dmL - vL * drL) / rhoL;
  const T dvR = (dmR - vR * drR) / rhoR;
  const T deig = face[R_C_L * fs] * dvL + face[R_C_R * fs] * dvR;
  const T sg = (d == 0 ? itf_x : d == 1 ? itf_y : itf_z)[pt.iidx];
  const T sl = sg * vL, sr = sg * vR, es = sg * face[R_EIG * fs];
  const T sdl = sg * dvL, sdr = sg * dvR, sde = sg * deig;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const T TL = face[(kFaceRows + n) * fs], TR = face[(kFaceRows + NT + n) * fs];
    row[n * rs] =
        T(0.5) * ((sdl * TL + sl * dL[n]) + (sdr * TR + sr * dR[n]) - (sde * (TR - TL) + es * (dR[n] - dL[n])));
  }
}

// Shared memory of the volume pass (in T): ops1d, then per element the
// pointwise flux derivatives (3 directions x NT tracers x s^3).
template <typename T, int S, int NT>
struct VolShape {
  using Sh = Shape<T, S>;
  static constexpr int S2 = Sh::S2, S3 = Sh::S3, EB = Sh::EB;
  static constexpr int PER_ELEM = Sh::pad(3 * NT * S3);
  static constexpr int SIZE = Sh::N_OPS + EB * PER_ELEM;
};

// Volume pass: one thread per solution point, EB = 256 / s^3 elements per
// block (the panel the fastest block index, as the RHS's volume pass): the
// pointwise flux derivatives sqrt(g) (u_d dT_k + (T_k/rho) (dm_d - u_d d rho)),
// their divergence, the boundary corrections from the stored flux
// derivatives of the element's six faces; rows 0-4 exactly 0.
template <typename T, int S, int NT>
__global__ void __launch_bounds__(kThreads) euler3d_advection_tangent_volume_kernel(
    const T* __restrict__ v, const T* __restrict__ ops, const T* __restrict__ fields, const T* __restrict__ coef,
    const T* __restrict__ rows, T* __restrict__ out, int nh, int nk) {
  using Sh = VolShape<T, S, NT>;
  using Ops = Shape<T, S>;
  constexpr int S2 = Sh::S2, S3 = Sh::S3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
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

  T* sF = smem + Ops::N_OPS + e_loc * Sh::PER_ELEM;
  load_ops<T, S>(ops, smem);

  int kz = 0, ey = 0, ex = 0;
  const T* fld = fields + (long long)(valid ? pe : 0) * S3 + j;
  if (valid) {
    kz = pe / (nh * nh);
    const int r = pe - kz * nh * nh;
    ey = r / nh;
    ex = r - ey * nh;
    // --- Pointwise flux derivatives.
    const long long o = elem * S3 + j;
    const T* vn = v + o;
    const T* cn = coef + o;
    const T sqrtg = fld[F_SQRTG * fstride];
    const T drho = vn[0];
    T u[3], w[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      u[d] = cn[(1 + d) * nq];
      w[d] = vn[(1 + d) * nq] - u[d] * drho;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const T dt = vn[(kDyn + n) * nq];
      const T phi = cn[(kNodeRows + n) * nq];
#pragma unroll
      for (int d = 0; d < 3; ++d) sF[(d * NT + n) * S3 + j] = sqrtg * (u[d] * dt + phi * w[d]);
    }
  }
  __syncthreads();

  // --- Divergence + corrections.
  if (valid) {
    const int jx = j % S, jy = (j / S) % S, jz = j / S2;
    const int lx = (jz * S + jy) * S, ly = jz * S2 + jx, lz = jy * S + jx;  // line bases
    const int kxf = jz * S + jy, kyf = jz * S + jx, kzf = jy * S + jx;    // face points
    const T* Dx = sD + jx * S;
    const T* Dy = sD + jy * S;
    const T* Dz = sD + jz * S;
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
    const long long o = elem * S3 + j;
#pragma unroll
    for (int vrow = 0; vrow < kDyn; ++vrow) out[vrow * nq + o] = T(0);
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
      out[(kDyn + n) * nq + o] = -invsg * (acc + corr);
    }
  }
}

unsigned blocks_of(long long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

template <typename T, int S, int NT>
cudaError_t prep(int nh, int nk, const void* q, const void* halo, const void* ops, void* coef, cudaStream_t stream) {
  const long long nq = (long long)kPanels * nk * nh * nh * S * S * S;
  euler3d_advection_tangent_prep_node_kernel<T, NT><<<blocks_of(nq, kThreads), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(coef), nq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const ItfLayout lay(nh, nk, S);
  euler3d_advection_tangent_prep_interface_kernel<T, S, NT><<<blocks_of(lay.points(), kItfThreads), kItfThreads, 0,
                                                              stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(halo), static_cast<const T*>(ops), static_cast<T*>(coef), nh,
      nk);
  return cudaGetLastError();
}

template <typename T, int S, int NT>
cudaError_t apply(int nh, int nk, const void* v, const void* halo, const void* ops, const void* fields,
                  const void* itf_x, const void* itf_y, const void* itf_z, const void* coef, void* rows,
                  void* out, cudaStream_t stream) {
  using Sh = VolShape<T, S, NT>;
  const size_t smem = sizeof(T) * (size_t)Sh::SIZE;
  static bool configured = false;
  cudaError_t err = configure(euler3d_advection_tangent_volume_kernel<T, S, NT>, smem, configured);
  if (err != cudaSuccess) return err;
  const ItfLayout lay(nh, nk, S);
  euler3d_advection_tangent_interface_kernel<T, S, NT><<<blocks_of(lay.points(), kItfThreads), kItfThreads, 0,
                                                         stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(halo), static_cast<const T*>(ops),
      static_cast<const T*>(itf_x), static_cast<const T*>(itf_y), static_cast<const T*>(itf_z),
      static_cast<const T*>(coef), static_cast<T*>(rows), nh, nk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = kPanels * ((nk * nh * nh + Sh::EB - 1) / Sh::EB);
  euler3d_advection_tangent_volume_kernel<T, S, NT><<<blocks, Sh::EB * Sh::S3, smem, stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(ops), static_cast<const T*>(fields),
      static_cast<const T*>(coef), static_cast<const T*>(rows), static_cast<T*>(out), nh, nk);
  return cudaGetLastError();
}

template <typename T, int S, int NT>
cudaError_t resources(int kernel, int* info) {
  using Sh = VolShape<T, S, NT>;
  switch (kernel) {
    case 0: return kernel_resources(euler3d_advection_tangent_prep_node_kernel<T, NT>, kThreads, 0, info);
    case 1: return kernel_resources(euler3d_advection_tangent_prep_interface_kernel<T, S, NT>, kItfThreads, 0, info);
    case 2: return kernel_resources(euler3d_advection_tangent_interface_kernel<T, S, NT>, kItfThreads, 0, info);
    case 3:
      return kernel_resources(euler3d_advection_tangent_volume_kernel<T, S, NT>, Sh::EB * Sh::S3,
                              sizeof(T) * (size_t)Sh::SIZE, info);
    default: return cudaErrorInvalidValue;
  }
}

// The instantiations: f32 and f64, s = 2..6, NT = 1 (DCMIP 12) and 4 (11).
#define ADV_T_CASES(X) X(2) X(3) X(4) X(5) X(6)

template <typename T, int NT>
cudaError_t dispatch_prep(int s, int nh, int nk, const void* q, const void* halo, const void* ops, void* coef,
                          cudaStream_t st) {
#define ADV_T_PREP(S) \
  case S: return prep<T, S, NT>(nh, nk, q, halo, ops, coef, st);
  switch (s) {
    ADV_T_CASES(ADV_T_PREP)
    default: return cudaErrorInvalidValue;
  }
#undef ADV_T_PREP
}

template <typename T, int NT>
cudaError_t dispatch_apply(int s, int nh, int nk, const void* v, const void* halo, const void* ops,
                           const void* fields, const void* itf_x, const void* itf_y, const void* itf_z,
                           const void* coef, void* rows, void* out, cudaStream_t st) {
#define ADV_T_APPLY(S) \
  case S: return apply<T, S, NT>(nh, nk, v, halo, ops, fields, itf_x, itf_y, itf_z, coef, rows, out, st);
  switch (s) {
    ADV_T_CASES(ADV_T_APPLY)
    default: return cudaErrorInvalidValue;
  }
#undef ADV_T_APPLY
}

template <typename T, int NT>
cudaError_t dispatch_resources(int s, int kernel, int* info) {
#define ADV_T_RES(S) \
  case S: return resources<T, S, NT>(kernel, info);
  switch (s) {
    ADV_T_CASES(ADV_T_RES)
    default: return cudaErrorInvalidValue;
  }
#undef ADV_T_RES
}

}  // namespace

extern "C" const char* euler3d_advection_tangent_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The linearisation at q (5 + nt rows) with its halo: the coefficient buffer
// (layout above); nt is 1 (DCMIP 12) or 4 (DCMIP 11). Returns the
// cudaError_t of the launches (0 on success).
extern "C" int euler3d_advection_tangent_prep_launch(int is_f64, int s, int nt, int nh, int nk, const void* q,
                                                     const void* halo, const void* ops, void* coef, void* stream) {
  if (nh < 2 || nk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (nt == 1)
    err = is_f64 ? dispatch_prep<double, 1>(s, nh, nk, q, halo, ops, coef, st)
                 : dispatch_prep<float, 1>(s, nh, nk, q, halo, ops, coef, st);
  else if (nt == 4)
    err = is_f64 ? dispatch_prep<double, 4>(s, nh, nk, q, halo, ops, coef, st)
                 : dispatch_prep<float, 4>(s, nh, nk, q, halo, ops, coef, st);
  return (int)err;
}

// J.v from the coefficient buffer, the direction v (5 + nt rows) and its
// halo into out (5 + nt rows, rows 0-4 zero); rows: the caller's scratch of
// nt words an interface point (ItfLayout), the flux derivatives between the
// two passes.
extern "C" int euler3d_advection_tangent_apply_launch(int is_f64, int s, int nt, int nh, int nk, const void* v,
                                                      const void* halo, const void* ops, const void* fields,
                                                      const void* itf_x, const void* itf_y, const void* itf_z,
                                                      const void* coef, void* rows, void* out, void* stream) {
  if (nh < 2 || nk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (nt == 1)
    err = is_f64 ? dispatch_apply<double, 1>(s, nh, nk, v, halo, ops, fields, itf_x, itf_y, itf_z, coef, rows, out, st)
                 : dispatch_apply<float, 1>(s, nh, nk, v, halo, ops, fields, itf_x, itf_y, itf_z, coef, rows, out, st);
  else if (nt == 4)
    err = is_f64 ? dispatch_apply<double, 4>(s, nh, nk, v, halo, ops, fields, itf_x, itf_y, itf_z, coef, rows, out, st)
                 : dispatch_apply<float, 4>(s, nh, nk, v, halo, ops, fields, itf_x, itf_y, itf_z, coef, rows, out, st);
  return (int)err;
}

// What the runtime reports of the four kernels (0: the prep's node pass, 1:
// its interface pass, 2: the apply's interface pass, 3: its volume pass):
// info = [registers, local (spill) bytes a thread, dynamic shared memory
// bytes a block, resident blocks an SM, threads a block].
extern "C" int euler3d_advection_tangent_resources(int is_f64, int s, int nt, int kernel, int* info) {
  cudaError_t err = cudaErrorInvalidValue;
  if (nt == 1)
    err = is_f64 ? dispatch_resources<double, 1>(s, kernel, info) : dispatch_resources<float, 1>(s, kernel, info);
  else if (nt == 4)
    err = is_f64 ? dispatch_resources<double, 4>(s, kernel, info) : dispatch_resources<float, 4>(s, kernel, info);
  return (int)err;
}
