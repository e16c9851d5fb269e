// Eigenpairs of a batch of Hermitian (or real symmetric) matrices by
// cuSOLVER's Jacobi solver (heevj / syevj), one matrix after another on the
// caller's stream: the retry of solvers/davidson.py::_eigh where cuSOLVER's
// divide and conquer (heevd, which torch.linalg.eigh runs) reports that it
// failed to converge (ROADMAP queue 3, item 16).
//
// a [batch, n, n] row-major on entry, overwritten column by column with the
// eigenvectors of its column-major reading (for a Hermitian matrix that is
// its complex conjugate; kernels/eigh_jacobi.py turns them back); w [batch,
// n] the eigenvalues in ascending order; info [batch] int32, 0 where the
// matrix converged. Returns 0, a cudaError_t of the workspace, or 1000 plus
// a cusolverStatus_t.

#include <cuComplex.h>
#include <cuda_runtime.h>
#include <cusolverDn.h>

namespace {

cusolverDnHandle_t g_handle = nullptr;
syevjInfo_t g_params = nullptr;

constexpr cusolverEigMode_t kJob = CUSOLVER_EIG_MODE_VECTOR;
constexpr cublasFillMode_t kUplo = CUBLAS_FILL_MODE_LOWER;

cusolverStatus_t buffer_size(int n, float* a, float* w, int* lwork) {
  return cusolverDnSsyevj_bufferSize(g_handle, kJob, kUplo, n, a, n, w, lwork,
                                     g_params);
}
cusolverStatus_t buffer_size(int n, double* a, double* w, int* lwork) {
  return cusolverDnDsyevj_bufferSize(g_handle, kJob, kUplo, n, a, n, w, lwork,
                                     g_params);
}
cusolverStatus_t buffer_size(int n, cuComplex* a, float* w, int* lwork) {
  return cusolverDnCheevj_bufferSize(g_handle, kJob, kUplo, n, a, n, w, lwork,
                                     g_params);
}
cusolverStatus_t buffer_size(int n, cuDoubleComplex* a, double* w,
                             int* lwork) {
  return cusolverDnZheevj_bufferSize(g_handle, kJob, kUplo, n, a, n, w, lwork,
                                     g_params);
}

cusolverStatus_t solve(int n, float* a, float* w, float* work, int lwork,
                       int* info) {
  return cusolverDnSsyevj(g_handle, kJob, kUplo, n, a, n, w, work, lwork,
                          info, g_params);
}
cusolverStatus_t solve(int n, double* a, double* w, double* work, int lwork,
                       int* info) {
  return cusolverDnDsyevj(g_handle, kJob, kUplo, n, a, n, w, work, lwork,
                          info, g_params);
}
cusolverStatus_t solve(int n, cuComplex* a, float* w, cuComplex* work,
                       int lwork, int* info) {
  return cusolverDnCheevj(g_handle, kJob, kUplo, n, a, n, w, work, lwork,
                          info, g_params);
}
cusolverStatus_t solve(int n, cuDoubleComplex* a, double* w,
                       cuDoubleComplex* work, int lwork, int* info) {
  return cusolverDnZheevj(g_handle, kJob, kUplo, n, a, n, w, work, lwork,
                          info, g_params);
}

template <typename T, typename R>
int eigh_jacobi_batch(void* a, void* w, int n, int batch, void* info,
                      void* stream) {
  cusolverStatus_t st = CUSOLVER_STATUS_SUCCESS;
  if (g_handle == nullptr) {
    st = cusolverDnCreate(&g_handle);
    if (st != CUSOLVER_STATUS_SUCCESS) return 1000 + st;
    st = cusolverDnCreateSyevjInfo(&g_params);
    if (st != CUSOLVER_STATUS_SUCCESS) return 1000 + st;
    // ascending eigenvalues, as torch.linalg.eigh returns them; the default
    // tolerance (machine precision) and at most 100 sweeps
    cusolverDnXsyevjSetSortEig(g_params, 1);
    cusolverDnXsyevjSetMaxSweeps(g_params, 100);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  st = cusolverDnSetStream(g_handle, s);
  if (st != CUSOLVER_STATUS_SUCCESS) return 1000 + st;
  T* pa = static_cast<T*>(a);
  R* pw = static_cast<R*>(w);
  int* pinfo = static_cast<int*>(info);
  int lwork = 0;
  st = buffer_size(n, pa, pw, &lwork);
  if (st != CUSOLVER_STATUS_SUCCESS) return 1000 + st;
  T* work = nullptr;
  cudaError_t err = cudaMallocAsync(reinterpret_cast<void**>(&work),
                                    sizeof(T) * (size_t)(lwork > 0 ? lwork : 1),
                                    s);
  if (err != cudaSuccess) return err;
  const size_t stride = (size_t)n * n;
  for (int b = 0; b < batch && st == CUSOLVER_STATUS_SUCCESS; ++b)
    st = solve(n, pa + b * stride, pw + (size_t)b * n, work, lwork,
               pinfo + b);
  err = cudaFreeAsync(work, s);
  if (st != CUSOLVER_STATUS_SUCCESS) return 1000 + st;
  return err;
}

}  // namespace

extern "C" int eigh_jacobi_f32(void* a, void* w, int n, int batch, void* info, void* stream) {
  return eigh_jacobi_batch<float, float>(a, w, n, batch, info, stream);
}

extern "C" int eigh_jacobi_f64(void* a, void* w, int n, int batch, void* info, void* stream) {
  return eigh_jacobi_batch<double, double>(a, w, n, batch, info, stream);
}

extern "C" int eigh_jacobi_c64(void* a, void* w, int n, int batch, void* info, void* stream) {
  return eigh_jacobi_batch<cuComplex, float>(a, w, n, batch, info, stream);
}

extern "C" int eigh_jacobi_c128(void* a, void* w, int n, int batch, void* info, void* stream) {
  return eigh_jacobi_batch<cuDoubleComplex, double>(a, w, n, batch, info,
                                                     stream);
}
