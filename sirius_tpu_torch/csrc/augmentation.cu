// K4 and K5: the ultrasoft augmentation charge and the D operator, with
// the atomic structure-factor phases generated on the fly.
//
// K4 replaces sirius_tpu/ops/augmentation.py::rho_aug_g_device (:250-263)
// for one atom type (a group of its atoms):
//   out[s, g] (+)= sum_a sum_q e^{-2 pi i m_g . tau_a}
//                              w_q Re(dm[s, gidx[a, q]]) Q[q, g]
// K5 replaces d_operator_device (:266-282) for one atom type and every
// channel c of one potential update at once:
//   vq[c, a, q] = Omega Re sum_g Q[q, g] conj(V[c, g]) e^{-2 pi i m_g . tau_a}
//   D[c][gidx[a, q]] += vq[c, a, q];  D[c][lo_idx[a, q]] += vq lo_mask[q]
// dm is complex128 [ns, nbeta * nbeta] (ns channels: 1, 2, or the 4
// non-collinear component blocks), Q complex128 [nqlm, ng], V
// complex128 [nch, ng] (nch 1, 2 collinear spins V +- B_z, or 4: V, B_x,
// B_y, B_z), the Millers m int32 [ng, 3], tau float64 [na, 3]
// (fractional), D float64 [nch, nbeta * nbeta].
//
// The JAX package stores the phases as a dense [ng, na] table (75 MB at
// the 16-atom cell); here they come from sincospi of the integer Miller
// index and the fractional position, as SIRIUS's
// generate_phase_factors.cu does.
//
// Bound on the H100: bytes. K4 reads Q once and writes out once; K5 reads
// Q, V and the Millers once. The operations side is one sincospi per
// (G, atom) and per chunk of 8 q (K4), or per (G, atom) (K5), and K5's
// contraction, 4 nch na nqlm flops a G.
//
// Design, deterministic, no atomics:
// - K4: one thread per G (grid stride). The tiny dmp[s, a, q] table is
//   staged in shared memory; the thread sums over atoms into 8-wide
//   registers per q chunk, then contracts with its column of Q.
// - K5 is a skinny real GEMM, M = nch na rows (channel, atom), N = nqlm,
//   K = 2 ng, split over K. Pass 1: enough blocks to fill the card
//   (kernels/augmentation.py::d_operator_plan), each streaming a fixed
//   chunk of G in tiles of tg through a STAGES-deep cp.async pipeline
//   (the next tiles' Q, V and Millers in flight while the current one is
//   contracted). Per tile the phases are computed once per (atom, G) into
//   Z = conj(V) e^{-i G tau} in shared memory, for every channel; then
//   each thread accumulates a TM x TN register tile of (row, q) outer
//   products over its share of the tile's G (the threads of one output
//   tile split the G, in a fixed order). At the end the tile's threads are
//   summed in thread order into partial[block, row, q]. Q and the phases
//   are read and computed once for all channels. Pass 2: one warp per
//   (channel, atom, q) sums the partials in a fixed order (strided lanes,
//   then a shuffle tree) and scatters into D; every (c, a, q) writes
//   distinct positions (diagonal pairs skip the mirrored write, whose mask
//   is zero). The same inputs give D bit for bit on every launch.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cuComplex.h>

namespace {

constexpr int QC = 8;        // q chunk held in registers by K4
constexpr int THREADS = 256;
constexpr int TM = 4;        // (channel, atom) rows of a K5 thread's tile
constexpr int TN = 5;        // q columns of a K5 thread's tile
constexpr int STAGES = 3;    // K5's copy pipeline depth

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

// ---- K5 -----------------------------------------------------------------
// K5's pass-1 shared memory, in bytes; kernels/augmentation.py::
// d_operator_layout mirrors it. Per pipeline stage: the Q tile [npad][tgp]
// (q rows padded to whole TN tiles, G rows to tg + 1 double2 against bank
// conflicts), V [nch][tg] and the Millers [tg][3]; the stages share their
// bytes with the final cross-lane reduction. Then Z [mpad][tgp] (the
// (channel, atom) rows padded to whole TM tiles) and the positions.
struct DopLayout {
    int tgp, npad, mpad;
    size_t q_bytes, v_bytes, stage_bytes, z_off, tau_off, total;
};

__host__ __device__ inline DopLayout dop_layout(int na, int nqlm, int nch,
                                                int tg) {
    DopLayout L;
    L.tgp = tg + 1;
    L.npad = (nqlm + TN - 1) / TN * TN;
    L.mpad = (nch * na + TM - 1) / TM * TM;
    L.q_bytes = (size_t)L.npad * L.tgp * 16;
    L.v_bytes = (size_t)nch * tg * 16;
    L.stage_bytes = L.q_bytes + L.v_bytes + (size_t)tg * 12;
    const size_t red = (size_t)THREADS * TM * TN * 8;
    L.z_off = STAGES * L.stage_bytes > red ? STAGES * L.stage_bytes : red;
    L.tau_off = L.z_off + (size_t)L.mpad * L.tgp * 16;
    L.total = L.tau_off + ((size_t)na * 24 + 15) / 16 * 16;
    return L;
}

// 16-byte asynchronous copy global -> shared; the bytes past src_bytes
// (all 16 when it is 0) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Pass 1: block blockIdx.x contracts G in [blockIdx.x chunk, + chunk) in
// tiles of tg into partial[blockIdx.x][nch * na][nqlm]. Rows are
// (channel, atom) pairs, row = c * na + a.
__global__ void __launch_bounds__(THREADS, 3)
d_operator_partial_kernel(const int* __restrict__ millers,
                          const double* __restrict__ pos,
                          const double2* __restrict__ q,
                          const double2* __restrict__ v,
                          double* __restrict__ partial, int na, int nqlm,
                          int nch, long long ng, long long chunk, int tg) {
    // (named apart from K4's extern shared array, whose type differs)
    extern __shared__ __align__(16) unsigned char dop_smem[];
    const DopLayout L = dop_layout(na, nqlm, nch, tg);
    const int tgp = L.tgp;
    const int m = nch * na;
    const int mgn = L.mpad / TM, qgn = L.npad / TN;
    const int ntile = mgn * qgn;      // output tiles (<= THREADS: the plan)
    const int lanes = THREADS / ntile;  // threads of one tile, split over G
    double2* zs = (double2*)(dop_smem + L.z_off);
    double* tau = (double*)(dop_smem + L.tau_off);
    const int t = threadIdx.x;
    auto q_stage = [&](int s) {
        return (double2*)(dop_smem + s * L.stage_bytes);
    };
    auto v_stage = [&](int s) {
        return (double2*)(dop_smem + s * L.stage_bytes + L.q_bytes);
    };
    auto m_stage = [&](int s) {
        return (int*)(dop_smem + s * L.stage_bytes + L.q_bytes + L.v_bytes);
    };

    // constant rows: the positions, and zeros in the pad rows of Q and Z,
    // which no copy and no phase writes (visible after the first barrier)
    for (int i = t; i < 3 * na; i += THREADS) tau[i] = pos[i];
    for (int s = 0; s < STAGES; ++s)
        for (int i = t; i < (L.npad - nqlm) * tgp; i += THREADS)
            q_stage(s)[nqlm * tgp + i] = make_double2(0.0, 0.0);
    for (int i = t; i < (L.mpad - m) * tgp; i += THREADS)
        zs[m * tgp + i] = make_double2(0.0, 0.0);

    const long long gbeg = (long long)blockIdx.x * chunk;
    const long long gend = gbeg + chunk < ng ? gbeg + chunk : ng;
    const int ntiles = gend > gbeg ? (int)((gend - gbeg + tg - 1) / tg) : 0;

    // one tile's Q, V and Millers into a stage; G at or past gend read as
    // zeros (Q and V zero: those G add exactly nothing)
    auto load = [&](int s, long long g0) {
        double2* qs = q_stage(s);
        double2* vs = v_stage(s);
        int* ms = m_stage(s);
        for (int i = t; i < nqlm * tg; i += THREADS) {
            const int qq = i / tg;
            const int gg = i - qq * tg;
            const long long g = g0 + gg;
            const bool ok = g < gend;
            cp_async16(qs + qq * tgp + gg, q + (ok ? (long long)qq * ng + g : 0),
                       ok ? 16 : 0);
        }
        for (int i = t; i < nch * tg; i += THREADS) {
            const int c = i / tg;
            const long long g = g0 + (i - c * tg);
            const bool ok = g < gend;
            cp_async16(vs + i, v + (ok ? (long long)c * ng + g : 0),
                       ok ? 16 : 0);
        }
        // Millers as 16-byte runs of 4 ints (g0 is a multiple of 4, so
        // every run starts on a 16-byte boundary)
        for (int i = t; i < 3 * tg / 4; i += THREADS) {
            const long long o = g0 * 3 + 4LL * i;
            long long valid = gend * 3 - o;
            valid = valid < 0 ? 0 : (valid > 4 ? 4 : valid);
            cp_async16(ms + 4 * i, millers + (valid ? o : 0), (int)valid * 4);
        }
    };

    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < ntiles) load(s, gbeg + (long long)s * tg);
        cp_async_commit();
    }
    const bool active = t < ntile * lanes;
    const int u = t % ntile;
    const int lane = t / ntile;
    const int mg = u % mgn;
    const int qg = u / mgn;
    double acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0;

    for (int it = 0; it < ntiles; ++it) {
        // tile it has landed; every thread is past tile it - 1, whose
        // stage the next copies overwrite
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        const int nxt = it + STAGES - 1;
        if (nxt < ntiles) load(nxt % STAGES, gbeg + (long long)nxt * tg);
        cp_async_commit();
        const int s = it % STAGES;
        // Z = conj(V) e^{-2 pi i m . tau}: one sincospi per (atom, G),
        // applied to every channel. tg divides THREADS, so a thread keeps
        // one G of the tile (its Miller index converted once) and walks
        // atoms
        {
            const double2* vs = v_stage(s);
            const int* mi = m_stage(s) + 3 * (t % tg);
            const double m0 = mi[0], m1 = mi[1], m2 = mi[2];
            for (int a = t / tg; a < na; a += THREADS / tg) {
                const double* ta = tau + 3 * a;
                double sn, cs;
                sincospi(-2.0 * (m0 * ta[0] + m1 * ta[1] + m2 * ta[2]), &sn,
                         &cs);
                for (int c = 0; c < nch; ++c) {
                    const double2 vg = vs[c * tg + t % tg];
                    zs[(c * na + a) * tgp + t % tg] = make_double2(
                        vg.x * cs + vg.y * sn, vg.x * sn - vg.y * cs);
                }
            }
        }
        __syncthreads();
        // the thread's TM x TN outer products over its G of the tile; tile
        // (mg, qg) owns rows mg + i mgn and q qg + j qgn, so the threads of
        // one G read neighbouring rows (no bank conflicts: tgp is odd)
        if (active) {
            const double2* zr = zs + mg * tgp;
            const double2* qr = q_stage(s) + qg * tgp;
            for (int gg = lane; gg < tg; gg += lanes) {
                double2 z[TM], qv[TN];
#pragma unroll
                for (int i = 0; i < TM; ++i) z[i] = zr[i * mgn * tgp + gg];
#pragma unroll
                for (int j = 0; j < TN; ++j) qv[j] = qr[j * qgn * tgp + gg];
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j) {
                        acc[i][j] = fma(qv[j].x, z[i].x, acc[i][j]);
                        acc[i][j] = fma(-qv[j].y, z[i].y, acc[i][j]);
                    }
            }
        }
    }
    // the lanes of each tile summed in lane order, over the stage bytes
    cp_async_wait<0>();
    __syncthreads();
    double* red = (double*)dop_smem;  // [lanes][ntile][TM * TN]
    if (active) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
                red[((size_t)lane * ntile + u) * (TM * TN) + i * TN + j] =
                    acc[i][j];
    }
    __syncthreads();
    for (int o = t; o < ntile * TM * TN; o += THREADS) {
        double sum = 0.0;
        for (int k = 0; k < lanes; ++k)
            sum += red[(size_t)k * ntile * (TM * TN) + o];
        const int uu = o / (TM * TN);
        const int e = o - uu * (TM * TN);
        const int row = (e / TN) * mgn + uu % mgn;
        const int qq = (e % TN) * qgn + uu / mgn;
        if (row < m && qq < nqlm)
            partial[(size_t)blockIdx.x * m * nqlm + (size_t)row * nqlm + qq] =
                sum;
    }
}

// Pass 2: one warp per (channel, atom, q) sums the blocks' partials (lane
// l takes blocks l, l + 32, ..., then a fixed shuffle tree) and scatters
// Omega times the sum into that channel's D.
__global__ void d_operator_finish_kernel(const double* __restrict__ partial,
                                         int nblocks, int na, int nqlm,
                                         int nch, const int* __restrict__ gidx,
                                         const int* __restrict__ lo_idx,
                                         const double* __restrict__ lo_mask,
                                         double omega, double* __restrict__ d,
                                         long long nbeta2) {
    const int nout = nch * na * nqlm;
    const long long o = (blockIdx.x * (long long)blockDim.x + threadIdx.x) / 32;
    const int lane = threadIdx.x & 31;
    if (o >= nout) return;  // whole warps
    double s = 0.0;
    for (int b = lane; b < nblocks; b += 32) s += partial[(size_t)b * nout + o];
    for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) {
        const int row = (int)(o / nqlm);
        const int qq = (int)(o - (long long)row * nqlm);
        const int c = row / na;
        const int p = (row - c * na) * nqlm + qq;
        const double vq = omega * s;
        double* dc = d + c * nbeta2;
        dc[gidx[p]] += vq;
        if (lo_mask[qq] != 0.0) dc[lo_idx[p]] += vq * lo_mask[qq];
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
                          int nblocks, long long chunk, int tg,
                          const int* gidx, const int* lo_idx,
                          const double* lo_mask, double omega, double* d,
                          int nch, int na, int nqlm, long long ng,
                          long long nbeta2, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (na <= 0 || nqlm <= 0) return (int)cudaGetLastError();
    if (nch < 1 || tg <= 0 || tg % 4 || THREADS % tg || nblocks < 0 ||
        (nblocks > 0 && (chunk <= 0 || chunk % tg)))
        return (int)cudaErrorInvalidValue;
    const DopLayout L = dop_layout(na, nqlm, nch, tg);
    if ((L.mpad / TM) * (L.npad / TN) > THREADS)
        return (int)cudaErrorInvalidValue;
    if (nblocks > 0) {
        // above the default 48 KB a block must opt in to dynamic shared memory
        if (L.total > 48 * 1024)
            cudaFuncSetAttribute(d_operator_partial_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)L.total);
        d_operator_partial_kernel<<<nblocks, THREADS, L.total, st>>>(
            millers, pos, (const double2*)q, (const double2*)v, partial, na,
            nqlm, nch, ng, chunk, tg);
        const int rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
    }
    const long long warps = (long long)nch * na * nqlm;
    d_operator_finish_kernel<<<(unsigned)((warps * 32 + THREADS - 1) / THREADS),
                               THREADS, 0, st>>>(
        partial, nblocks, na, nqlm, nch, gidx, lo_idx, lo_mask, omega, d,
        nbeta2);
    return (int)cudaGetLastError();
}
