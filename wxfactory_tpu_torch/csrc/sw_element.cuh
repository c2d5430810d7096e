// Device code shared by the shallow-water kernels (csrc/sw_operator.cu and
// csrc/sw_run.cu): the element-block body of the DFR operator in its absolute
// and perturbation forms, the panel-edge traces of a state and the halo
// exchange of traces. Every kernel that computes one of these functions calls
// the same device function, with each sum and each fused multiply-add written
// out in a fixed order, so the per-stage kernels and the whole-run kernel give
// the same bits for the same inputs.
//
// Layouts (C order, T = float or double):
//   q, x, out  (3, 6*nel*nel, s^2)   element (panel, ey, ex), node ky*s + kx
//   halo       (3, 4, 6, nel, s)     neighbour traces, sides (S, N, W, E)
//   traces     (3, 4, 6, nel, s)     a state's own panel-edge traces
//   ops        EE (s^2, 4s) | DD (2s^2, s^2) | CC (4s, s^2), faces (W, E, S, N)
//   fields     (13, nel*nel, s^2)    one panel's metric (identical on all six)
//   gridrot    (6*nel*nel, s^2)      panel-dependent factor of the time Christoffels
//   itf_x      (3, nel, nel+1, s)    sqrt(g), H^11, H^21 at x1 interfaces
//   itf_y      (3, nel+1, nel, s)    sqrt(g), H^22, H^12 at x2 interfaces
// Perturbation form (the 14 base planes of pallas_sw_gen.build_base_planes in
// the model layout): q0 (3, ...) and u0 = hu0/h0 (2, ...) at the nodes, itf0
// (3, 6*nel*nel, 4s) the base state's face traces, halo0 (3, 4, 6, nel, s) its
// halo, rhs0 (3, ...) its float64 RHS cast to T.
// Halo tables: src (24) the neighbour's (side*6 + panel) row feeding each
// (side*6 + panel) row, flip (24) 1 where that edge runs opposite, conv
// (4, 24, nel*s) the 2x2 contravariant rotation c11, c12, c21, c22.

#pragma once

#include <cuda_runtime.h>

namespace swk {

constexpr double kGravity = 9.80616;
constexpr int kThreads = 256;

__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float sqrt_rn(float v) { return __fsqrt_rn(v); }
__device__ __forceinline__ double sqrt_rn(double v) { return __dsqrt_rn(v); }

// Column `col` of an (n, ncol) row-major matrix applied to a length-n vector.
// Explicit fma in a fixed order: the result does not depend on where the
// vector lives (shared or global memory) or on the compiler's contraction.
template <typename T, int N>
__device__ __forceinline__ T dot_col(const T* v, const T* m, int ncol, int col) {
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) acc = fmadd(v[i], m[i * ncol + col], acc);
  return acc;
}

// AUSM Mach-splitting flux at one interface point (reference rhs_sw.py:170-207,
// term order of pallas_sw._ausm_slots). is_x: the normal momentum is hu1.
template <typename T>
__device__ __forceinline__ void ausm(const T* L, const T* R, T msg, T mhd, T mho, bool is_x, T* F) {
  const T g = T(kGravity);
  const T half_g = T(0.5 * kGravity);
  const T hL = L[0], hR = R[0];
  const T aL = sqrt_rn(g * hL * mhd);
  const T aR = sqrt_rn(g * hR * mhd);
  const T qnL = is_x ? L[1] : L[2];
  const T qnR = is_x ? R[1] : R[2];
  const T tmpL = hL * aL;
  const T tmpR = hR * aR;
  const T mL = tmpL != T(0) ? qnL / tmpL : T(0);
  const T mR = tmpR != T(0) ? qnR / tmpR : T(0);
  const T big_m = T(0.25) * ((mL + T(1)) * (mL + T(1)) - (mR - T(1)) * (mR - T(1)));
  const T adv_l = (big_m > T(0) ? big_m : T(0)) * aL;
  const T adv_r = (big_m < T(0) ? big_m : T(0)) * aR;
#pragma unroll
  for (int v = 0; v < 3; ++v) F[v] = msg * (adv_l * L[v] + adv_r * R[v]);
  const T pres_l = (T(1) + mL) * (msg * half_g) * (hL * hL);
  const T pres_r = (T(1) - mR) * (msg * half_g) * (hR * hR);
  const T pres_diag = T(0.5) * (mhd * pres_l + mhd * pres_r);
  const T pres_off = T(0.5) * (mho * pres_l + mho * pres_r);
  F[1] += is_x ? pres_diag : pres_off;
  F[2] += is_x ? pres_off : pres_diag;
}

// Term-level delta of `ausm` around the base states (L0, R0) for the
// perturbations (dL, dR), term for term as pallas_sw._ausm_delta_slots: the
// sound-speed delta g*mhd*dh/(a + a0), Mach-number deltas as differences of
// the full and the base Mach numbers, the split Mach terms as max(0, M) -
// max(0, M0) and min(0, M) - min(0, M0), and the pressure term's exact
// expansion; the divide guards of the absolute form are kept.
template <typename T>
__device__ __forceinline__ void ausm_delta(const T* L0, const T* R0, const T* dL, const T* dR, T msg,
                                           T mhd, T mho, bool is_x, T* F) {
  const T g = T(kGravity);
  const T hL0 = L0[0], hR0 = R0[0];
  const T dhL = dL[0], dhR = dR[0];
  const T hL = hL0 + dhL, hR = hR0 + dhR;
  const T aL0 = sqrt_rn(g * hL0 * mhd);
  const T aR0 = sqrt_rn(g * hR0 * mhd);
  const T aL = sqrt_rn(g * hL * mhd);
  const T aR = sqrt_rn(g * hR * mhd);
  const T daL = aL + aL0 > T(0) ? g * mhd * dhL / (aL + aL0) : T(0);
  const T daR = aR + aR0 > T(0) ? g * mhd * dhR / (aR + aR0) : T(0);
  const T qn0L = is_x ? L0[1] : L0[2];
  const T qn0R = is_x ? R0[1] : R0[2];
  const T dqnL = is_x ? dL[1] : dL[2];
  const T dqnR = is_x ? dR[1] : dR[2];
  const T tmpL0 = hL0 * aL0, tmpL = hL * aL;
  const T tmpR0 = hR0 * aR0, tmpR = hR * aR;
  const T mL0 = tmpL0 != T(0) ? qn0L / tmpL0 : T(0);
  const T mR0 = tmpR0 != T(0) ? qn0R / tmpR0 : T(0);
  const T mL = tmpL != T(0) ? (qn0L + dqnL) / tmpL : T(0);
  const T mR = tmpR != T(0) ? (qn0R + dqnR) / tmpR : T(0);
  const T dmL = mL - mL0, dmR = mR - mR0;
  const T M0 = T(0.25) * ((mL0 + T(1)) * (mL0 + T(1)) - (mR0 - T(1)) * (mR0 - T(1)));
  const T dM = T(0.25) * ((mL + mL0 + T(2)) * dmL - (mR + mR0 - T(2)) * dmR);
  const T M = M0 + dM;
  const T P0 = M0 > T(0) ? M0 : T(0);
  const T dP = (M > T(0) ? M : T(0)) - P0;
  const T N0 = M0 < T(0) ? M0 : T(0);
  const T dN = (M < T(0) ? M : T(0)) - N0;
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const T l = L0[v] + dL[v], r = R0[v] + dR[v];
    F[v] = msg * (dP * aL * l + P0 * (daL * l + aL0 * dL[v]) + dN * aR * r + N0 * (daR * r + aR0 * dR[v]));
  }
  const T dterm = dmL * hL * hL + (T(1) + mL0) * (hL + hL0) * dhL - dmR * hR * hR + (T(1) - mR0) * (hR + hR0) * dhR;
  const T dpres = T(0.25 * kGravity) * msg * dterm;
  F[1] += (is_x ? mhd : mho) * dpres;
  F[2] += (is_x ? mho : mhd) * dpres;
}

// Shared memory (in T): EE, DD, CC, then per element [q (3 s^2) | fx, fy
// (6 s^2) | face fluxes (3 * 4s)].
template <int S>
struct Shape {
  static constexpr int S2 = S * S;
  static constexpr int NF = 4 * S;
  static constexpr int N_OPS = S2 * NF + 2 * S2 * S2 + NF * S2;
  static constexpr int PER_ELEM = 9 * S2 + 3 * NF;
  static constexpr int EB = kThreads / S2 > 0 ? kThreads / S2 : 1;
  static constexpr int THREADS = EB * S2;
  static size_t smem_bytes(size_t item) { return item * (N_OPS + (size_t)EB * PER_ELEM); }
};

template <typename T>
struct OpArgs {
  const T* q;     // stage input state (the perturbation in the perturbation form)
  const T* halo;  // its halo, or with HALO_FROM_TRACES its panel-edge traces
  const T* ops;
  const T* fields;
  const T* gridrot;
  const T* itf_x;
  const T* itf_y;
  const T* x;     // stage a-term state, nullptr: no a*x term
  T* out;
  T* traces;      // nullptr: no trace emission
  // perturbation base (PERT only)
  const T* q0;
  const T* u0;
  const T* itf0;
  const T* halo0;
  const T* rhs0;
  // halo tables (HALO_FROM_TRACES only)
  const int* hsrc;
  const int* hflip;
  const T* hconv;
  int nel;
  T a, b, cdt;
  int stage;  // 0: out = RHS(q)
};

// The halo values (h, hu1, hu2) that (side, panel) row `row` = side*6 + panel
// receives at edge point i (0 <= i < nel*s), from the outgoing traces: the
// neighbour row's trace at i (or npts-1-i across an opposite edge), the
// momenta rotated into the local contravariant basis (the function of
// pallas_sw.kh_exchange / _halo_math, and of the plain halo_from_traces).
template <typename T>
__device__ __forceinline__ void halo_point(const T* traces, const int* src, const int* flip, const T* conv,
                                           int npts, int row, int i, T* out) {
  const long long vstride = 24LL * npts;
  const int r = src[row];
  const long long at = (long long)r * npts + (flip[row] ? npts - 1 - i : i);
  const T a1 = traces[vstride + at];
  const T a2 = traces[2 * vstride + at];
  const long long ci = (long long)row * npts + i;
  out[0] = traces[at];
  out[1] = fmadd(conv[ci], a1, conv[vstride + ci] * a2);
  out[2] = fmadd(conv[2 * vstride + ci], a1, conv[3 * vstride + ci] * a2);
}

// Trace value t = ((v*4 + side)*6 + p)*nel*s + along*s + k of state q: its
// edge element's face point extrapolated with EE (the same fma order as the
// operator's emission from shared memory).
template <typename T, int S>
__device__ __forceinline__ T trace_point(const T* q, const T* ee, int nel, long long t) {
  constexpr int S2 = S * S, NF = 4 * S;
  const int npts = nel * S;
  const int k = (int)(t % S);
  const int along = (int)((t / S) % nel);
  const int row = (int)((t / npts) % 24);
  const int v = (int)(t / (24LL * npts));
  const int side = row / 6, p = row - side * 6;
  int ey, ex, col;
  switch (side) {
    case 0: ey = 0;       ex = along;   col = 2 * S + k; break;  // south
    case 1: ey = nel - 1; ex = along;   col = 3 * S + k; break;  // north
    case 2: ey = along;   ex = 0;       col = k;         break;  // west
    default: ey = along;  ex = nel - 1; col = S + k;     break;  // east
  }
  const long long nq = 6LL * nel * nel * S2;
  const long long elem = ((long long)p * nel + ey) * nel + ex;
  return dot_col<T, S2>(q + v * nq + elem * S2, ee, NF, col);
}

// One block of EB elements of the operator, called by every thread of the
// block (it synchronises the block). `smem` holds EE/DD/CC already (loaded
// by the caller, visible after the caller's or this function's first
// barrier); the per-element regions follow them.
//
// Each element computes the AUSM flux at its own four faces from (own trace,
// neighbour trace or halo) with qL/qR in a fixed order: the neighbour's trace
// is re-extrapolated from its state in global memory with the same fma
// sequence that neighbour uses for its own trace, so both sides of an interior
// interface get bit-identical fluxes (mass is conserved to round-off). West
// and south panel-edge interfaces take qL from the halo, east and north take
// qR from it. In the perturbation form (PERT) the state, halo, output and
// traces carry deltas: base traces come from itf0 (the neighbour's entry for
// the neighbour's face, so again the same bits on both sides) and halo0, and
// every flux is the term-level delta around them; the output is rhs0 + delta
// (or the stage combination of delta states). With HALO_FROM_TRACES,
// `halo` holds the traces and each panel-edge face computes its halo value
// with `halo_point`.
template <typename T, int S, bool PERT, bool HALO_FROM_TRACES>
__device__ __forceinline__ void element_block(const OpArgs<T>& A, int blk, T* smem) {
  using Sh = Shape<S>;
  constexpr int S2 = Sh::S2, NF = Sh::NF;
  const T* sEE = smem;
  const T* sDD = sEE + S2 * NF;
  const T* sCC = sDD + 2 * S2 * S2;

  const int nel = A.nel;
  const int tid = threadIdx.x;
  const int e_loc = tid / S2;
  const int j = tid - e_loc * S2;
  const int per_panel = nel * nel;
  const int nelem = 6 * per_panel;
  const int elem = blk * Sh::EB + e_loc;
  const bool valid = e_loc < Sh::EB && elem < nelem;
  const long long nq = (long long)nelem * S2;           // stride between variables
  const long long fstride = (long long)per_panel * S2;  // stride between metric fields
  const long long pt = (long long)elem * S2 + j;

  T* sQ = smem + Sh::N_OPS + e_loc * Sh::PER_ELEM;
  T* sF = sQ + 3 * S2;
  T* sFl = sF + 6 * S2;

  int p = 0, pe = 0, ey = 0, ex = 0;
  if (valid) {
    p = elem / per_panel;
    pe = elem - p * per_panel;
    ey = pe / nel;
    ex = pe - ey * nel;
#pragma unroll
    for (int v = 0; v < 3; ++v) sQ[v * S2 + j] = A.q[v * nq + pt];
  }
  __syncthreads();

  // --- Pointwise fluxes, forcing, and the fluxes at this element's faces.
  T force1 = T(0), force2 = T(0), invsg = T(0);
  if (valid) {
    const T* fld = A.fields + (long long)pe * S2 + j;
    const T sqrtg = fld[0], h11 = fld[fstride], h12 = fld[2 * fstride], h22 = fld[3 * fstride];
    const T g101 = fld[4 * fstride], g102 = fld[5 * fstride];
    const T g201 = fld[6 * fstride], g202 = fld[7 * fstride];
    const T c111 = fld[8 * fstride], c112 = fld[9 * fstride];
    const T c212 = fld[10 * fstride], c222 = fld[11 * fstride];
    invsg = fld[12 * fstride];
    const T half_g = T(0.5 * kGravity);
    const T rot2 = T(2) * A.gridrot[pt];
    if constexpr (PERT) {
      // Term-level delta of the pointwise stage (pallas_sw._element_stage_pert).
      const T h0 = A.q0[pt], hu10 = A.q0[nq + pt], hu20 = A.q0[2 * nq + pt];
      const T u10 = A.u0[pt], u20 = A.u0[nq + pt];
      const T dh = sQ[j], dhu1 = sQ[S2 + j], dhu2 = sQ[2 * S2 + j];
      const T h = h0 + dh;
      const T du1 = (dhu1 - u10 * dh) / h;
      const T du2 = (dhu2 - u20 * dh) / h;
      const T u1 = u10 + du1, u2 = u20 + du2;
      const T hph0 = h + h0;
      const T d11 = dhu1 * u1 + hu10 * du1;
      const T d12 = dhu1 * u2 + hu10 * du2;
      const T d21 = dhu2 * u1 + hu20 * du1;
      const T d22 = dhu2 * u2 + hu20 * du2;
      sF[0 * S2 + j] = sqrtg * dhu1;
      sF[1 * S2 + j] = sqrtg * (d11 + half_g * h11 * hph0 * dh);
      sF[2 * S2 + j] = sqrtg * (d21 + half_g * h12 * hph0 * dh);
      sF[3 * S2 + j] = sqrtg * dhu2;
      sF[4 * S2 + j] = sqrtg * (d12 + half_g * h12 * hph0 * dh);
      sF[5 * S2 + j] = sqrtg * (d22 + half_g * h22 * hph0 * dh);
      force1 = rot2 * (g101 * dhu1 + g102 * dhu2) + c111 * d11 + T(2) * c112 * d12;
      force2 = rot2 * (g201 * dhu1 + g202 * dhu2) + T(2) * c212 * d12 + c222 * d22;
    } else {
      const T h = sQ[j], hu1 = sQ[S2 + j], hu2 = sQ[2 * S2 + j];
      const T u1 = hu1 / h, u2 = hu2 / h, hsq = h * h;
      sF[0 * S2 + j] = sqrtg * hu1;
      sF[1 * S2 + j] = sqrtg * (hu1 * u1 + half_g * h11 * hsq);
      sF[2 * S2 + j] = sqrtg * (hu2 * u1 + half_g * h12 * hsq);
      sF[3 * S2 + j] = sqrtg * hu2;
      sF[4 * S2 + j] = sqrtg * (hu1 * u2 + half_g * h12 * hsq);
      sF[5 * S2 + j] = sqrtg * (hu2 * u2 + half_g * h22 * hsq);
      force1 = rot2 * (g101 * hu1 + g102 * hu2) + c111 * hu1 * u1 + T(2) * c112 * hu1 * u2;
      force2 = rot2 * (g201 * hu1 + g202 * hu2) + T(2) * c212 * hu1 * u2 + c222 * hu2 * u2;
    }

    const int npts = nel * S;
    for (int fi = j; fi < NF; fi += S2) {
      const int side = fi / S;  // EE column blocks: 0 west, 1 east, 2 south, 3 north
      const int k = fi - side * S;
      bool at_edge;
      int nb_elem, nb_col, hside, along;
      switch (side) {
        case 0: at_edge = ex == 0;       nb_elem = elem - 1;   nb_col = S + k;     hside = 2; along = ey; break;
        case 1: at_edge = ex == nel - 1; nb_elem = elem + 1;   nb_col = k;         hside = 3; along = ey; break;
        case 2: at_edge = ey == 0;       nb_elem = elem - nel; nb_col = 3 * S + k; hside = 0; along = ex; break;
        default: at_edge = ey == nel - 1; nb_elem = elem + nel; nb_col = 2 * S + k; hside = 1; along = ex; break;
      }
      const long long hidx = ((long long)(hside * 6 + p) * nel + along) * S + k;  // within one variable
      const long long hvar = 24LL * npts;
      T own[3], nb[3];
      if (at_edge) {
        if constexpr (HALO_FROM_TRACES) {
          halo_point(A.halo, A.hsrc, A.hflip, A.hconv, npts, hside * 6 + p, along * S + k, nb);
        } else {
#pragma unroll
          for (int v = 0; v < 3; ++v) nb[v] = A.halo[v * hvar + hidx];
        }
      } else {
#pragma unroll
        for (int v = 0; v < 3; ++v) nb[v] = dot_col<T, S2>(A.q + v * nq + (long long)nb_elem * S2, sEE, NF, nb_col);
      }
#pragma unroll
      for (int v = 0; v < 3; ++v) own[v] = dot_col<T, S2>(sQ + v * S2, sEE, NF, fi);
      // West/south faces: the neighbour (or halo) is on the left.
      const bool own_right = side == 0 || side == 2;
      T L[3], R[3], F[3];
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        L[v] = own_right ? nb[v] : own[v];
        R[v] = own_right ? own[v] : nb[v];
      }
      const bool is_x = side < 2;
      const T* itf = is_x ? A.itf_x : A.itf_y;
      const int istride = nel * (nel + 1) * S;
      const int iidx = is_x ? ((ey * (nel + 1) + ex + (side == 1)) * S + k)
                            : (((ey + (side == 3)) * nel + ex) * S + k);
      if constexpr (PERT) {
        const long long tvar = (long long)nelem * NF;
        T own0[3], nb0[3], L0[3], R0[3];
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          own0[v] = A.itf0[v * tvar + (long long)elem * NF + fi];
          nb0[v] = at_edge ? A.halo0[v * hvar + hidx] : A.itf0[v * tvar + (long long)nb_elem * NF + nb_col];
          L0[v] = own_right ? nb0[v] : own0[v];
          R0[v] = own_right ? own0[v] : nb0[v];
        }
        ausm_delta(L0, R0, L, R, itf[iidx], itf[istride + iidx], itf[2 * istride + iidx], is_x, F);
      } else {
        ausm(L, R, itf[iidx], itf[istride + iidx], itf[2 * istride + iidx], is_x, F);
      }
#pragma unroll
      for (int v = 0; v < 3; ++v) sFl[v * NF + fi] = F[v];
    }
  }
  __syncthreads();

  // --- Interior divergence + boundary correction, stage combination.
  if (valid) {
    T r[3];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      T div = T(0);
      for (int i = 0; i < S2; ++i) div = fmadd(sF[v * S2 + i], sDD[i * S2 + j], div);
      for (int i = 0; i < S2; ++i) div = fmadd(sF[(3 + v) * S2 + i], sDD[(S2 + i) * S2 + j], div);
      T corr = T(0);
      for (int fi = 0; fi < NF; ++fi) corr = fmadd(sFl[v * NF + fi], sCC[fi * S2 + j], corr);
      const T force = v == 0 ? T(0) : (v == 1 ? force1 : force2);
      r[v] = (-invsg * div - force) - invsg * corr;
      if constexpr (PERT) r[v] = r[v] + A.rhs0[v * nq + pt];
    }
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const long long o = v * nq + pt;
      T val = r[v];
      if (A.stage) {
        val = A.b * sQ[v * S2 + j] + A.cdt * r[v];
        if (A.x != nullptr) val = A.a * A.x[o] + val;
      }
      A.out[o] = val;
      sQ[v * S2 + j] = val;  // only this thread reads this slot from here on
    }
  }

  // --- Panel-edge traces of the output state.
  if (A.traces != nullptr) {
    __syncthreads();
    if (valid) {
      const int npts = nel * S;
      for (int fi = j; fi < NF; fi += S2) {
        const int side = fi / S;
        const int k = fi - side * S;
        bool on_edge;
        int tside, along;
        switch (side) {
          case 0: on_edge = ex == 0;       tside = 2; along = ey; break;
          case 1: on_edge = ex == nel - 1; tside = 3; along = ey; break;
          case 2: on_edge = ey == 0;       tside = 0; along = ex; break;
          default: on_edge = ey == nel - 1; tside = 1; along = ex; break;
        }
        if (on_edge) {
#pragma unroll
          for (int v = 0; v < 3; ++v)
            A.traces[v * 24LL * npts + ((long long)(tside * 6 + p) * nel + along) * S + k] =
                dot_col<T, S2>(sQ + v * S2, sEE, NF, fi);
        }
      }
    }
  }
}

template <typename T, int S>
__device__ __forceinline__ void load_ops(const T* ops, T* smem) {
  for (int i = threadIdx.x; i < Shape<S>::N_OPS; i += blockDim.x) smem[i] = ops[i];
}

}  // namespace swk
