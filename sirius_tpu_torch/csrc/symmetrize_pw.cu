// K6: plane-wave symmetrization over the space group, as a gather.
//
// Replaces sirius_tpu/dft/density.py::symmetrize_pw_device (:348-358) and
// its host twin symmetrize_pw (:155-187). For every target G' of the set:
//   out[g'] = (1/nops) sum_op  f[g(op, g')] * (e^{-2 pi i m_g' . t_op} s_op)
// where g(op, g') is the G whose Miller index is w_k^{-1} m_g' (the JAX
// package scatters f[g] to its image w_k m_g, the same sum read from the
// target side), t_op the fractional translation and s_op the spin sign of
// the op for the z-component of an axial field (1 otherwise).
//
// The JAX package builds dense [nops, ng] index and phase tables: at the
// 16-atom cell (384 ops, 291,693 G) that is 2.2 GB. Here each thread
// rotates its own Miller index with the op's integer matrix, wraps it into
// the fine FFT box, reads the source G from a box -> G lookup table
// ([N_fine] int32, -1 off the sphere) and generates the phase with
// sincospi. The host checks once, when the tables are built, that every
// rotated Miller lands in the G set; the kernel traps on a -1 slot rather
// than read a wrong coefficient.
//
// The factorised sum. The ops whose rotation is the identity are the pure
// translations T of the group; the ops of one rotation w are {T_j} o rep,
// with t = t_rep + T_j (mod 1) and s = s_rep s_j, and share the source G.
// So
//   out[g'] = (tau(g') / nops) sum_rep f[g(rep, g')] (e^{-2 pi i m_g' . t_rep} s_rep)
// with tau(g') = sum_j s_j e^{-2 pi i m_g' . T_j}, a character summed over a
// group: |T| or 0. The host (kernels/symmetrize_pw.py::build_cosets) keeps
// one op of each rotation in index order and the list of live G (tau =
// |T|, with the spin signs for an axial field, without for a scalar one);
// the kernel sums the representatives over the live G only and divides by
// their count, nreps = nops / |T|. At the 54-atom cell (1296 ops, |T| = 27,
// 984,161 G) that is 36,325 live G x 48 representatives, 730x fewer
// (op, G) pairs than the unfactorised sum. A group without translations
// has every G live and every op a representative: the arithmetic is then
// that of the unfactorised kernel, in the same order.
//
// Bound on the H100: bytes. Writing out (every G; the dead ones by a
// cudaMemsetAsync before the launch, skipped when every G is live) and
// reading the live G's f, Millers and index; the gathers of f and of the
// box -> G lookup hit L2 (f 16 B a G, the lookup 4 B a box slot).
//
// Design: the representatives' tables are staged in shared memory once a
// block; one thread per live G (grid stride) sums the representatives in
// index order, then divides by nreps: no atomics, bit-reproducible.
//
// K6v (symmetrize_vector_pw) is the axial-vector form, replacing the host
// scatter of sirius_tpu/dft/potential_nc.py::symmetrize_vector_pw (:47-67):
//   out_i[g'] = (1/nops) sum_op sum_j A_op[i][j] f_j[g(op, g')] e^{-2 pi i m_g' . t_op}
// over the three components f [3, ng] in one launch, with A_op = det(R) R the
// op's Cartesian rotation of an axial vector. The JAX package scatters the
// rotated vector of g to its image w_k g; read from the target side the
// source is g = w_k^{-1} g' and the rotation applied to it is the same
// A_op (the op moves both the point and the vector). A pure translation has
// A = 1, so K6v factorises with the scalar character: one thread per live G
// sums the representatives in order, all three components at once.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cuComplex.h>

namespace {

// the most representatives a group has (the 48 rotations of m-3m)
constexpr int kMaxReps = 48;
constexpr int kThreads = 128;

__device__ __forceinline__ int wrap(int m, int n) {
    const int r = m % n;
    return r < 0 ? r + n : r;
}

__global__ void __launch_bounds__(kThreads)
symmetrize_pw_kernel(const cuDoubleComplex* __restrict__ f,
                     const int* __restrict__ millers,
                     const int* __restrict__ live, long long nlive,
                     const int* __restrict__ lut,
                     const int* __restrict__ rot,
                     const double* __restrict__ trans,
                     const double* __restrict__ sign,
                     cuDoubleComplex* __restrict__ out, int nreps, int n1,
                     int n2, int n3) {
    __shared__ int s_rot[9 * kMaxReps];
    __shared__ double s_trans[3 * kMaxReps];
    __shared__ double s_sign[kMaxReps];
    for (int i = threadIdx.x; i < 9 * nreps; i += blockDim.x) s_rot[i] = rot[i];
    for (int i = threadIdx.x; i < 3 * nreps; i += blockDim.x)
        s_trans[i] = trans[i];
    if (sign != nullptr)
        for (int i = threadIdx.x; i < nreps; i += blockDim.x)
            s_sign[i] = sign[i];
    __syncthreads();
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < nlive; i += (long long)gridDim.x * blockDim.x) {
        const long long g = live[i];
        const int m0 = millers[3 * g], m1 = millers[3 * g + 1],
                  m2 = millers[3 * g + 2];
        double acc_re = 0.0, acc_im = 0.0;
        for (int op = 0; op < nreps; ++op) {
            const int* r = s_rot + 9 * op;
            const int s0 = r[0] * m0 + r[1] * m1 + r[2] * m2;
            const int s1 = r[3] * m0 + r[4] * m1 + r[5] * m2;
            const int s2 = r[6] * m0 + r[7] * m1 + r[8] * m2;
            const int src = lut[((long long)wrap(s0, n1) * n2 + wrap(s1, n2)) * n3
                                + wrap(s2, n3)];
            if (src < 0) __trap();
            const double* t = s_trans + 3 * op;
            const double x = (double)m0 * t[0] + (double)m1 * t[1] + (double)m2 * t[2];
            double sn, cs;
            sincospi(-2.0 * x, &sn, &cs);
            if (sign != nullptr) {
                cs *= s_sign[op];
                sn *= s_sign[op];
            }
            const cuDoubleComplex v = f[src];
            acc_re += v.x * cs - v.y * sn;
            acc_im += v.x * sn + v.y * cs;
        }
        out[g] = make_cuDoubleComplex(acc_re / nreps, acc_im / nreps);
    }
}

__global__ void __launch_bounds__(kThreads)
symmetrize_vector_kernel(const cuDoubleComplex* __restrict__ f,
                         const int* __restrict__ millers,
                         const int* __restrict__ live, long long nlive,
                         const int* __restrict__ lut,
                         const int* __restrict__ rot,
                         const double* __restrict__ trans,
                         const double* __restrict__ srot,
                         cuDoubleComplex* __restrict__ out, int nreps,
                         long long ng, int n1, int n2, int n3) {
    __shared__ int s_rot[9 * kMaxReps];
    __shared__ double s_trans[3 * kMaxReps];
    __shared__ double s_srot[9 * kMaxReps];
    for (int i = threadIdx.x; i < 9 * nreps; i += blockDim.x) {
        s_rot[i] = rot[i];
        s_srot[i] = srot[i];
    }
    for (int i = threadIdx.x; i < 3 * nreps; i += blockDim.x)
        s_trans[i] = trans[i];
    __syncthreads();
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < nlive; i += (long long)gridDim.x * blockDim.x) {
        const long long g = live[i];
        const int m0 = millers[3 * g], m1 = millers[3 * g + 1],
                  m2 = millers[3 * g + 2];
        double acc_re[3] = {0.0, 0.0, 0.0}, acc_im[3] = {0.0, 0.0, 0.0};
        for (int op = 0; op < nreps; ++op) {
            const int* r = s_rot + 9 * op;
            const int s0 = r[0] * m0 + r[1] * m1 + r[2] * m2;
            const int s1 = r[3] * m0 + r[4] * m1 + r[5] * m2;
            const int s2 = r[6] * m0 + r[7] * m1 + r[8] * m2;
            const int src = lut[((long long)wrap(s0, n1) * n2 + wrap(s1, n2)) * n3
                                + wrap(s2, n3)];
            if (src < 0) __trap();
            const double* t = s_trans + 3 * op;
            const double x = (double)m0 * t[0] + (double)m1 * t[1] + (double)m2 * t[2];
            double sn, cs;
            sincospi(-2.0 * x, &sn, &cs);
            cuDoubleComplex v[3];
            for (int j = 0; j < 3; ++j) v[j] = f[j * ng + src];
            const double* a = s_srot + 9 * op;
            for (int c = 0; c < 3; ++c) {
                const double vr = a[3 * c] * v[0].x + a[3 * c + 1] * v[1].x
                                  + a[3 * c + 2] * v[2].x;
                const double vi = a[3 * c] * v[0].y + a[3 * c + 1] * v[1].y
                                  + a[3 * c + 2] * v[2].y;
                acc_re[c] += vr * cs - vi * sn;
                acc_im[c] += vr * sn + vi * cs;
            }
        }
        for (int c = 0; c < 3; ++c)
            out[c * ng + g] = make_cuDoubleComplex(acc_re[c] / nreps,
                                                   acc_im[c] / nreps);
    }
}

int grid_of(long long nlive) {
    long long blocks = (nlive + kThreads - 1) / kThreads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    return (int)blocks;
}

}  // namespace

// live: [nlive] int32 indices of the G to compute, every other G of out is
// zeroed; rot, trans, sign / srot: the nreps representatives' tables
// (nreps <= 48, checked by the wrapper).
extern "C" int symmetrize_vector_pw(const void* f, const int* millers,
                                    const int* live, long long nlive,
                                    const int* lut, const int* rot,
                                    const double* trans, const double* srot,
                                    void* out, int nreps, long long ng, int n1,
                                    int n2, int n3, void* stream) {
    if (nlive < ng) {
        const cudaError_t e = cudaMemsetAsync(out, 0, 3 * ng * sizeof(cuDoubleComplex),
                                              (cudaStream_t)stream);
        if (e != cudaSuccess) return (int)e;
    }
    if (nlive > 0)
        symmetrize_vector_kernel<<<grid_of(nlive), kThreads, 0,
                                   (cudaStream_t)stream>>>(
            (const cuDoubleComplex*)f, millers, live, nlive, lut, rot, trans,
            srot, (cuDoubleComplex*)out, nreps, ng, n1, n2, n3);
    return (int)cudaGetLastError();
}

extern "C" int symmetrize_pw(const void* f, const int* millers,
                             const int* live, long long nlive, const int* lut,
                             const int* rot, const double* trans,
                             const double* sign, void* out, int nreps,
                             long long ng, int n1, int n2, int n3,
                             void* stream) {
    if (nlive < ng) {
        const cudaError_t e = cudaMemsetAsync(out, 0, ng * sizeof(cuDoubleComplex),
                                              (cudaStream_t)stream);
        if (e != cudaSuccess) return (int)e;
    }
    if (nlive > 0)
        symmetrize_pw_kernel<<<grid_of(nlive), kThreads, 0,
                               (cudaStream_t)stream>>>(
            (const cuDoubleComplex*)f, millers, live, nlive, lut, rot, trans,
            sign, (cuDoubleComplex*)out, nreps, n1, n2, n3);
    return (int)cudaGetLastError();
}
