// Code shared by the tracer-advection kernels (csrc/euler3d_advection.cu,
// the RHS, and csrc/euler3d_advection_tangent.cu, its Jacobian action): the
// 1D operators' shared-memory layout, the face lines, the layout of the
// interface points, the primal trace of one side of an interface (from an
// element's state or from the halo) and the host helpers of the launches.
// Each library includes it into a translation unit of its own. The prep of
// the Jacobian action re-extrapolates the primal traces with the same
// device_trace as the RHS's interface pass, so the two see the same bits.

#pragma once

#include <cuda_runtime.h>

namespace e3adv {

constexpr int kThreads = 256;
constexpr int kItfThreads = 128;
constexpr int kPanels = 6;
constexpr int kDyn = 5;  // the dynamical rows ahead of the tracers

// Indices into `fields`.
constexpr int F_SQRTG = 0, F_INVSG = 1;

__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float tlog(float v) { return logf(v); }
__device__ __forceinline__ double tlog(double v) { return log(v); }
__device__ __forceinline__ float texp(float v) { return expf(v); }
__device__ __forceinline__ double texp(double v) { return exp(v); }

// The 1D operators' layout in shared memory (in T) and the elements a block
// of the volume pass takes (EB = 256 / s^3, one thread a node). Every region
// starts on a 16-byte boundary.
template <typename T, int S>
struct Shape {
  static constexpr int S2 = S * S;
  static constexpr int S3 = S * S * S;
  static constexpr int A = 16 / sizeof(T);
  static constexpr int pad(int n) { return (n + A - 1) / A * A; }
  static constexpr int PS = pad(S), PS2 = pad(S2);
  static constexpr int N_OPS = 4 * PS + 2 * PS2;
  static constexpr int EB = kThreads / S3 > 0 ? kThreads / S3 : 1;
};

// ops1d into shared memory, each segment on a 16-byte boundary.
template <typename T, int S>
__device__ __forceinline__ void load_ops(const T* ops, T* smem) {
  using Sh = Shape<T, S>;
  for (int i = threadIdx.x; i < 4 * S + 2 * Sh::S2; i += blockDim.x) {
    const int dst = i < 4 * S ? (i / S) * Sh::PS + i % S
                              : 4 * Sh::PS + ((i - 4 * S) / Sh::S2) * Sh::PS2 + (i - 4 * S) % Sh::S2;
    smem[dst] = ops[i];
  }
}

// The line of s nodes through face point k of a face normal to direction d:
// node(i) = base + i * stride (x: k = kz*s+ky; y: k = kz*s+kx; z: k = ky*s+kx).
template <int S>
__device__ __forceinline__ void face_line(int d, int k, int& base, int& stride) {
  if (d == 0) {
    base = k * S;
    stride = 1;
  } else if (d == 1) {
    base = (k / S) * S * S + k % S;
    stride = S;
  } else {
    base = k;
    stride = S * S;
  }
}

// The interface points, and where the flux rows live between the two passes
// of a call: three families in the interface metric's order with the panel
// in front, x (6, nk, nh, nh+1, s^2), y (6, nk, nh+1, nh, s^2) and z (6,
// nk+1, nh, nh, s^2), each family row-major (row r of point i of family d
// at base(d, rows) + r * count(d) + i).
struct ItfLayout {
  long long nx, nz;  // points of the x (and y) family and of the z family
  __host__ __device__ ItfLayout(int nh, int nk, int s) {
    nx = (long long)kPanels * nk * nh * (nh + 1) * s * s;
    nz = (long long)kPanels * (nk + 1) * nh * nh * s * s;
  }
  __host__ __device__ long long points() const { return 2 * nx + nz; }
  __device__ __forceinline__ long long count(int d) const { return d == 2 ? nz : nx; }
  __device__ __forceinline__ long long base(int d, int rows) const { return d * rows * nx; }
};

// One side's trace at a face point of a face normal to d, from its element's
// state in device memory: rho through log space, the normal momentum (row
// 1 + d) and the NT tracers linearly, each as a fixed fma sequence in the
// order of euler3d_operator.cu's nb_trace and of the RHS volume pass's trace
// emission (euler3d_advection.cu).
template <typename T, int S, int NT>
__device__ __forceinline__ void device_trace(const T* q, long long nq, long long elem, int d, int k,
                                             const T* coef, T& rho, T& mom, T* tr) {
  constexpr int S3 = S * S * S;
  int base, stride;
  face_line<S>(d, k, base, stride);
  const T* src = q + elem * S3 + base;
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < S; ++i) acc = fmadd(tlog(src[i * stride]), coef[i], acc);
  rho = texp(acc);
  acc = T(0);
#pragma unroll
  for (int i = 0; i < S; ++i) acc = fmadd(src[(1 + d) * nq + i * stride], coef[i], acc);
  mom = acc;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    acc = T(0);
#pragma unroll
    for (int i = 0; i < S; ++i) acc = fmadd(src[(kDyn + t) * nq + i * stride], coef[i], acc);
    tr[t] = acc;
  }
}

// The same from the halo (a panel edge): entry h of each row, rows hv apart.
template <typename T, int NT>
__device__ __forceinline__ void halo_trace(const T* halo, long long hv, long long h, int d, T& rho, T& mom, T* tr) {
  rho = halo[h];
  mom = halo[(1 + d) * hv + h];
#pragma unroll
  for (int t = 0; t < NT; ++t) tr[t] = halo[(kDyn + t) * hv + h];
}

// Dynamic shared memory of one block, after raising the kernel's limit
// above the default 48 KB once.
template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem, bool& configured) {
  if (configured || smem <= 48 * 1024) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) configured = true;
  return err;
}

template <typename Kernel>
cudaError_t kernel_resources(Kernel kernel, int threads, size_t smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  bool configured = false;
  err = configure(kernel, smem, configured);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)smem;
  info[3] = blocks;
  info[4] = threads;
  return err;
}

}  // namespace e3adv
