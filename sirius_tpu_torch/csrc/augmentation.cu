// K4 and K5: the ultrasoft augmentation charge and the D operator, with
// the atomic structure-factor phases generated on the fly.
//
// K4 replaces sirius_tpu/ops/augmentation.py::rho_aug_g_device (:250-263)
// for one atom type (a group of its atoms):
//   out[s, g] (+)= sum_a sum_q e^{-2 pi i m_g . tau_a}
//                              w_q Re(dm[s, gidx[a, q]]) Q[q, g]
// K5 replaces d_operator_device (:266-282) for one atom type:
//   vq[a, q] = Omega Re sum_g Q[q, g] conj(V[g]) e^{-2 pi i m_g . tau_a}
//   D[gidx[a, q]] += vq[a, q];  D[lo_idx[a, q]] += vq[a, q] lo_mask[q]
// dm is complex128 [ns, nbeta * nbeta] (ns channels: 1, 2, or the 4
// non-collinear component blocks), Q complex128 [nqlm, ng], V
// complex128 [ng], the Millers m int32 [ng, 3], tau float64 [na, 3]
// (fractional), D float64 [nbeta * nbeta].
//
// The JAX package stores the phases as a dense [ng, na] table (75 MB at
// the 16-atom cell); here each thread computes them with sincospi from the
// integer Miller index and the fractional position, as SIRIUS's
// generate_phase_factors.cu does.
//
// Bound on the H100: bytes. K4 reads Q once and writes out once; K5 reads
// Q, V and the Millers once. The operations side is one sincospi per
// (G, atom) and per chunk of 8 q (K4), or per (G, atom) (K5).
//
// Design, deterministic, no atomics:
// - K4: one thread per G (grid stride). The tiny dmp[s, a, q] table is
//   staged in shared memory; the thread sums over atoms into 8-wide
//   registers per q chunk, then contracts with its column of Q.
// - K5: two passes. Pass 1: each block reduces a fixed chunk of G (tiles of
//   32 G staged in shared memory: Q and Z = conj(V) e^{-i G tau}) into a
//   partial [nblocks, na, nqlm]; each thread owns whole (a, q) pairs, so
//   the sum over G runs in a fixed order in registers. Pass 2: one block
//   sums the partials in block order and scatters into D; every (a, q)
//   writes distinct positions (diagonal pairs skip the mirrored write,
//   whose mask is zero).
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cuComplex.h>

namespace {

constexpr int QC = 8;        // q chunk held in registers by K4
constexpr int TG = 32;       // G tile of K5 pass 1
constexpr int PMAX = 4;      // (a, q) pairs per thread in K5 pass 1
constexpr int THREADS = 256;

__device__ __forceinline__ double miller_dot(const int* m, const double* t) {
    return (double)m[0] * t[0] + (double)m[1] * t[1] + (double)m[2] * t[2];
}

template <int NS>
__global__ void rho_aug_kernel(const cuDoubleComplex* __restrict__ dm,
                               const int* __restrict__ gidx,
                               const double* __restrict__ w,
                               const int* __restrict__ millers,
                               const double* __restrict__ pos,
                               const cuDoubleComplex* __restrict__ q,
                               cuDoubleComplex* __restrict__ out,
                               long long nbeta2, int na, int nqlm,
                               long long ng, int accumulate) {
    extern __shared__ double smem[];
    double* dmp = smem;                      // [NS][na][nqlm]
    double* tau = smem + NS * na * nqlm;     // [na][3]
    const int nd = NS * na * nqlm;
    for (int i = threadIdx.x; i < nd; i += blockDim.x) {
        const int s = i / (na * nqlm);
        const int aq = i - s * na * nqlm;
        const int qq = aq % nqlm;
        dmp[i] = w[qq] * dm[s * nbeta2 + gidx[aq]].x;
    }
    for (int i = threadIdx.x; i < 3 * na; i += blockDim.x) tau[i] = pos[i];
    __syncthreads();

    for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         g < ng; g += (long long)gridDim.x * blockDim.x) {
        const int* m = millers + 3 * g;
        double acc_re[NS], acc_im[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) acc_re[s] = acc_im[s] = 0.0;
        for (int q0 = 0; q0 < nqlm; q0 += QC) {
            double u_re[NS][QC], u_im[NS][QC];
#pragma unroll
            for (int s = 0; s < NS; ++s)
#pragma unroll
                for (int j = 0; j < QC; ++j) u_re[s][j] = u_im[s][j] = 0.0;
            for (int a = 0; a < na; ++a) {
                double sn, cs;
                sincospi(-2.0 * miller_dot(m, tau + 3 * a), &sn, &cs);
#pragma unroll
                for (int s = 0; s < NS; ++s) {
                    const double* c = dmp + (s * na + a) * nqlm + q0;
#pragma unroll
                    for (int j = 0; j < QC; ++j) {
                        if (q0 + j < nqlm) {
                            u_re[s][j] += cs * c[j];
                            u_im[s][j] += sn * c[j];
                        }
                    }
                }
            }
#pragma unroll
            for (int j = 0; j < QC; ++j) {
                if (q0 + j < nqlm) {
                    const cuDoubleComplex qv = q[(long long)(q0 + j) * ng + g];
#pragma unroll
                    for (int s = 0; s < NS; ++s) {
                        acc_re[s] += u_re[s][j] * qv.x - u_im[s][j] * qv.y;
                        acc_im[s] += u_re[s][j] * qv.y + u_im[s][j] * qv.x;
                    }
                }
            }
        }
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            cuDoubleComplex* o = out + s * ng + g;
            if (accumulate) {
                o->x += acc_re[s];
                o->y += acc_im[s];
            } else {
                *o = make_cuDoubleComplex(acc_re[s], acc_im[s]);
            }
        }
    }
}

__global__ void d_operator_partial_kernel(const int* __restrict__ millers,
                                          const double* __restrict__ pos,
                                          const cuDoubleComplex* __restrict__ q,
                                          const cuDoubleComplex* __restrict__ v,
                                          double* __restrict__ partial,
                                          int na, int nqlm, long long ng,
                                          long long chunk) {
    extern __shared__ double smem[];
    double2* qs = (double2*)smem;            // [nqlm][TG]
    double2* zs = qs + nqlm * TG;            // [na][TG]
    double* tau = (double*)(zs + na * TG);   // [na][3]
    const int npairs = na * nqlm;
    for (int i = threadIdx.x; i < 3 * na; i += blockDim.x) tau[i] = pos[i];
    const long long gbeg = blockIdx.x * chunk;
    const long long gend = gbeg + chunk < ng ? gbeg + chunk : ng;
    double acc[PMAX];
#pragma unroll
    for (int k = 0; k < PMAX; ++k) acc[k] = 0.0;
    __syncthreads();
    for (long long g0 = gbeg; g0 < gend; g0 += TG) {
        for (int i = threadIdx.x; i < nqlm * TG; i += blockDim.x) {
            const int qq = i / TG;
            const long long g = g0 + (i - qq * TG);
            const cuDoubleComplex z =
                g < gend ? q[(long long)qq * ng + g] : make_cuDoubleComplex(0.0, 0.0);
            qs[i] = make_double2(z.x, z.y);
        }
        for (int i = threadIdx.x; i < na * TG; i += blockDim.x) {
            const int a = i / TG;
            const long long g = g0 + (i - a * TG);
            double2 z = make_double2(0.0, 0.0);
            if (g < gend) {
                double sn, cs;
                sincospi(-2.0 * miller_dot(millers + 3 * g, tau + 3 * a), &sn, &cs);
                const cuDoubleComplex vg = v[g];
                // conj(V) * (cs + i sn)
                z.x = vg.x * cs + vg.y * sn;
                z.y = vg.x * sn - vg.y * cs;
            }
            zs[i] = z;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < PMAX; ++k) {
            const int p = threadIdx.x + k * blockDim.x;
            if (p < npairs) {
                const int a = p / nqlm;
                const int qq = p - a * nqlm;
                const double2* qr = qs + qq * TG;
                const double2* zr = zs + a * TG;
                double sum = acc[k];
                for (int j = 0; j < TG; ++j)
                    sum += qr[j].x * zr[j].x - qr[j].y * zr[j].y;
                acc[k] = sum;
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < PMAX; ++k) {
        const int p = threadIdx.x + k * blockDim.x;
        if (p < npairs) partial[blockIdx.x * (long long)npairs + p] = acc[k];
    }
}

__global__ void d_operator_finish_kernel(const double* __restrict__ partial,
                                         int nblocks, int npairs, int nqlm,
                                         const int* __restrict__ gidx,
                                         const int* __restrict__ lo_idx,
                                         const double* __restrict__ lo_mask,
                                         double omega, double* __restrict__ d) {
    for (int p = threadIdx.x; p < npairs; p += blockDim.x) {
        double s = 0.0;
        for (int b = 0; b < nblocks; ++b) s += partial[(long long)b * npairs + p];
        const double vq = omega * s;
        const int qq = p % nqlm;
        d[gidx[p]] += vq;
        if (lo_mask[qq] != 0.0) d[lo_idx[p]] += vq * lo_mask[qq];
    }
}

template <int NS>
int launch_rho_aug(const void* dm, const int* gidx, const double* w,
                   const int* millers, const double* pos, const void* q,
                   void* out, long long nbeta2, int na, int nqlm, long long ng,
                   int accumulate, size_t shmem, long long blocks,
                   cudaStream_t st) {
    // above the default 48 KB a block must opt in to dynamic shared memory
    if (shmem > 48 * 1024)
        cudaFuncSetAttribute(rho_aug_kernel<NS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shmem);
    rho_aug_kernel<NS><<<(int)blocks, THREADS, shmem, st>>>(
        (const cuDoubleComplex*)dm, gidx, w, millers, pos,
        (const cuDoubleComplex*)q, (cuDoubleComplex*)out, nbeta2, na, nqlm,
        ng, accumulate);
    return (int)cudaGetLastError();
}

}  // namespace

// ns is the number of channels: 1 (unpolarized), 2 (collinear spins) or 4
// (the non-collinear (rho, m_x, m_y, m_z) component blocks).
extern "C" int rho_aug(const void* dm, const int* gidx, const double* w,
                       const int* millers, const double* pos, const void* q,
                       void* out, int ns, long long nbeta2, int na, int nqlm,
                       long long ng, int accumulate, void* stream) {
    const size_t shmem = (size_t)(ns * na * nqlm + 3 * na) * sizeof(double);
    long long blocks = (ng + THREADS - 1) / THREADS;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    if (blocks <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    switch (ns) {
        case 1:
            return launch_rho_aug<1>(dm, gidx, w, millers, pos, q, out, nbeta2,
                                     na, nqlm, ng, accumulate, shmem, blocks, st);
        case 2:
            return launch_rho_aug<2>(dm, gidx, w, millers, pos, q, out, nbeta2,
                                     na, nqlm, ng, accumulate, shmem, blocks, st);
        case 4:
            return launch_rho_aug<4>(dm, gidx, w, millers, pos, q, out, nbeta2,
                                     na, nqlm, ng, accumulate, shmem, blocks, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

extern "C" int d_operator(const int* millers, const double* pos,
                          const void* q, const void* v, double* partial,
                          int nblocks, long long chunk, const int* gidx,
                          const int* lo_idx, const double* lo_mask,
                          double omega, double* d, int na, int nqlm,
                          long long ng, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const size_t shmem = (size_t)(nqlm + na) * TG * sizeof(double2)
                         + (size_t)3 * na * sizeof(double);
    if (shmem > 48 * 1024)
        cudaFuncSetAttribute(d_operator_partial_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shmem);
    if (nblocks > 0)
        d_operator_partial_kernel<<<nblocks, THREADS, shmem, st>>>(
            millers, pos, (const cuDoubleComplex*)q, (const cuDoubleComplex*)v,
            partial, na, nqlm, ng, chunk);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    d_operator_finish_kernel<<<1, THREADS, 0, st>>>(
        partial, nblocks, na * nqlm, nqlm, gidx, lo_idx, lo_mask, omega, d);
    return (int)cudaGetLastError();
}
