// K4 and K5: the ultrasoft augmentation charge and the D operator, with
// the atomic structure-factor phases generated on the fly.
//
// K4 replaces sirius_tpu/ops/augmentation.py::rho_aug_g_device (:250-263)
// for one atom type:
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
// Bound on the H100 (as chip_smoke.py counts it): bytes, at every shape
// of K4 and K5. K4 reads Q once and writes out once; its operations, a
// sincospi and the atom sum (2 ns nqlm fused multiply-adds, the shape of
// a matrix product) once a (G, -G) row, take less time at the data-sheet
// rates. K5 reads Q, V and the Millers once.
//
// Design, deterministic, no atomics:
// - K4 (kernels/augmentation.py::rho_aug_plan sizes it): a block walks tiles
//   of tg rows of the (G, -G) table (kernels/augmentation.py::gvec_pairs;
//   G = 0 is its own row). Per tile it asks for the rows' Q columns in L2,
//   computes each row's phases once per atom into shared memory, where the
//   packed coefficients dmp[s, a, q] = w_q Re dm[s, gidx[a, q]] also lie,
//   and thread (s, k, r) of the block's ns x ksplit x tg threads sums
//   channel s of row r over the atoms in registers, q chunk by q chunk (8,
//   then 4, 2, 1 wide) over its share k of q; thread k = 0 contracts every
//   chunk with Q's columns of G and of -G in the order of q, taking the
//   other share's sums from shared memory. Re(dm) is real, so the atom sum
//   of -G is the conjugate of G's: one sum serves both (the card's
//   sincospi(-y) is (-sin, cos) of y bit for bit but for a zero's sign;
//   tools/torch_port_k4.py counts it over every (G, atom) argument of the
//   decks). Every sum keeps its order and every update its expression,
//   operand for operand, as the one-thread-a-G kernel before it, so nvcc
//   contracts the same fused multiply-adds and the output keeps its bits;
//   a fused fp64 tensor-core product would sum in an order of its own. A
//   type whose atoms do not fit shared memory at once is summed over atom
//   tiles in the same chain, its phases then recomputed per q chunk.
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

namespace {

constexpr int QC = 8;        // widest q chunk a K4 thread holds in registers
constexpr int RA_MAX_THREADS = 512;  // K4's largest block: 4 channels x 128
constexpr int THREADS = 256;
constexpr int TM = 4;        // (channel, atom) rows of a K5 thread's tile
constexpr int TN = 5;        // q columns of a K5 thread's tile
constexpr int STAGES = 3;    // K5's copy pipeline depth

__device__ __forceinline__ double miller_dot(const int* m, const double* t) {
    return (double)m[0] * t[0] + (double)m[1] * t[1] + (double)m[2] * t[2];
}

// e^{-2 pi i m . tau} as (sin, cos) of -2 m . tau, the expression K4 has
// always evaluated
__device__ __forceinline__ double2 aug_phase(const int* m, const double* t) {
    double sn, cs;
    sincospi(-2.0 * miller_dot(m, t), &sn, &cs);
    return make_double2(sn, cs);
}

// -x, out of the compiler's sight, so that the update of -G below keeps
// the form of G's (and so its fused multiply-adds)
__device__ __forceinline__ double neg_opaque(double x) {
    double r;
    asm("neg.f64 %0, %1;" : "=d"(r) : "d"(x));
    return r;
}

// asks for the 32-byte sector of p in L2, without waiting for it
__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// K4's shared memory in bytes; kernels/augmentation.py::rho_aug_layout
// mirrors it: the packed coefficients dmp [ns][atoms][nqlm], the
// positions [atoms][3], the phases [atoms][tg] (sin, cos) of one atom tile
// and, with ksplit 2, the atom sums [ns][nqlm - nqlm / 2][tg] of the upper
// q half, which its threads hand to the lower half's for the contraction
struct RaLayout {
    size_t tau_off, ph_off, u_off, total;
};

__host__ __device__ inline RaLayout ra_layout(int ns, int nqlm, int tg,
                                              int atoms, int ksplit) {
    RaLayout L;
    L.tau_off = ((size_t)ns * atoms * nqlm * 8 + 15) / 16 * 16;
    L.ph_off = L.tau_off + ((size_t)atoms * 24 + 15) / 16 * 16;
    L.u_off = L.ph_off + (size_t)atoms * tg * 16;
    L.total = L.u_off + (size_t)ns * (nqlm - nqlm / ksplit) * tg * 16;
    return L;
}

struct RaArgs {
    const double2* dm;    // [ns, nbeta2]
    const int* gidx;      // [na, nqlm]
    const double* w;      // [nqlm]
    const int* millers;   // [ng, 3]
    const double* pos;    // [na, 3]
    const int2* pairs;    // [nrow]: (g, index of -g)
    const double2* q;     // [nqlm, ng]
    double2* out;         // [ns, ng]
    long long nbeta2, ng;
    int nrow, ns, na, nqlm, tg, atoms, ksplit, accumulate;
};

// the widest q chunk (8, 4, 2 or 1) that fits in the left q of a range
__device__ __forceinline__ int chunk_width(int left) {
    return left >= QC ? QC : left >= 4 ? 4 : left >= 2 ? 2 : 1;
}

// channel s of one row, atoms [0, acnt) of the staged tile: the running
// sums u of NQ q (the coefficients from c, a row of nqlm an atom)
template <int NQ>
__device__ __forceinline__ void ra_sum(const double2* ph, const double* c,
                                       int acnt, int tg, int r, int nqlm,
                                       double* u_re, double* u_im) {
#pragma unroll 2
    for (int a = 0; a < acnt; ++a) {
        const double2 p = ph[a * tg + r];
        const double sn = p.x, cs = p.y;
        const double* ca = c + a * nqlm;
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
            u_re[j] += cs * ca[j];
            u_im[j] += sn * ca[j];
        }
    }
}

// the chunk's q into the sums of G (g) and, where it is another G, of -G
// (gp), whose atom sum is the conjugate of G's
template <int NQ>
__device__ __forceinline__ void ra_contract(const double2* __restrict__ q,
                                            long long ng, int q0,
                                            long long g, long long gp,
                                            const double* u_re,
                                            const double* u_im, double& acc_re,
                                            double& acc_im, double& accp_re,
                                            double& accp_im) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
        const double2 qv = q[(long long)(q0 + j) * ng + g];
        acc_re += u_re[j] * qv.x - u_im[j] * qv.y;
        acc_im += u_re[j] * qv.y + u_im[j] * qv.x;
    }
    if (gp != g) {
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
            const double2 qv = q[(long long)(q0 + j) * ng + gp];
            const double ui = neg_opaque(u_im[j]);
            accp_re += u_re[j] * qv.x - ui * qv.y;
            accp_im += u_re[j] * qv.y + ui * qv.x;
        }
    }
}

__device__ __forceinline__ void ra_store(double2* o, double re, double im,
                                         int accumulate) {
    if (accumulate) {
        o->x += re;
        o->y += im;
    } else {
        *o = make_double2(re, im);
    }
}

// Block: ns x ksplit x tg threads, thread (s, k, r) with r = threadIdx.x %
// tg, k and s the next digits. It walks the row tiles blockIdx.x,
// + gridDim.x, ...; thread (s, k, r) sums channel s of row r over q in
// [k nqlm / ksplit, (k + 1) nqlm / ksplit); k = 0 contracts all of them,
// in the order of q (ksplit 2 only where one atom tile holds the type).
__global__ void __launch_bounds__(RA_MAX_THREADS)
rho_aug_kernel(const RaArgs A) {
    extern __shared__ __align__(16) unsigned char ra_smem[];
    const RaLayout L = ra_layout(A.ns, A.nqlm, A.tg, A.atoms, A.ksplit);
    double* dmp = (double*)ra_smem;
    double* tau = (double*)(ra_smem + L.tau_off);
    double2* ph = (double2*)(ra_smem + L.ph_off);
    double2* ubuf = (double2*)(ra_smem + L.u_off);
    const int t = threadIdx.x;
    const int r = t % A.tg;
    const int k = (t / A.tg) % A.ksplit;
    const int s = t / (A.tg * A.ksplit);
    const int qlo = k * A.nqlm / A.ksplit;
    const int qhi = (k + 1) * A.nqlm / A.ksplit;
    const int qmid = A.nqlm / A.ksplit;  // the q of thread k = 0
    const int ntiles = (A.nrow + A.tg - 1) / A.tg;
    const int atiles = (A.na + A.atoms - 1) / A.atoms;
    bool staged = false;  // the coefficients of atom tile 0 lie in dmp
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int row = tile * A.tg + r;
        const bool live = row < A.nrow;
        long long g = 0, gp = 0;
        if (live) {
            const int2 pr = A.pairs[row];
            g = pr.x;
            gp = pr.y;
        }
        // stage atoms [a0, a0 + acnt): every thread is done with the
        // previous tile; the coefficients and positions when they change,
        // then the rows' phases, thread (s, k, r) taking row r's atoms
        // s ksplit + k, + ns ksplit, ...
        auto stage = [&](int a0, int acnt) {
            __syncthreads();
            if (atiles > 1 || !staged) {
                const int nd = A.ns * acnt * A.nqlm;
                for (int i = t; i < nd; i += blockDim.x) {
                    const int c = i / (acnt * A.nqlm);
                    const int aq = i - c * acnt * A.nqlm;
                    const int qq = aq % A.nqlm;
                    dmp[i] = A.w[qq] *
                             A.dm[c * A.nbeta2 + A.gidx[a0 * A.nqlm + aq]].x;
                }
                for (int i = t; i < 3 * acnt; i += blockDim.x)
                    tau[i] = A.pos[3 * a0 + i];
                staged = true;
                __syncthreads();
            }
            if (live) {
                const int* m = A.millers + 3 * g;
                const int step = A.ns * A.ksplit;
#pragma unroll 4
                for (int a = s * A.ksplit + k; a < acnt; a += step)
                    ph[a * A.tg + r] = aug_phase(m, tau + 3 * a);
            }
            __syncthreads();
        };
        // Q's columns of the row, which the contraction reads after the
        // phases and atom sums: on their way to L2 meanwhile, thread
        // (s, k) of a row taking q = s ksplit + k, + ns ksplit, ...
        if (live) {
            for (int qq = s * A.ksplit + k; qq < A.nqlm;
                 qq += A.ns * A.ksplit) {
                prefetch_l2(A.q + (long long)qq * A.ng + g);
                if (gp != g) prefetch_l2(A.q + (long long)qq * A.ng + gp);
            }
        }
        if (atiles == 1) stage(0, A.na);
        double acc_re = 0.0, acc_im = 0.0, accp_re = 0.0, accp_im = 0.0;
        for (int q0 = qlo; q0 < qhi;) {
            const int nq = chunk_width(qhi - q0);
            double u_re[QC], u_im[QC];
#pragma unroll
            for (int j = 0; j < QC; ++j) u_re[j] = u_im[j] = 0.0;
            for (int a0 = 0; a0 < A.na; a0 += A.atoms) {
                const int acnt = A.na - a0 < A.atoms ? A.na - a0 : A.atoms;
                if (atiles > 1) stage(a0, acnt);
                if (live) {
                    const double* c = dmp + (size_t)s * acnt * A.nqlm + q0;
                    switch (nq) {
                        case QC:
                            ra_sum<QC>(ph, c, acnt, A.tg, r, A.nqlm, u_re,
                                       u_im);
                            break;
                        case 4:
                            ra_sum<4>(ph, c, acnt, A.tg, r, A.nqlm, u_re,
                                      u_im);
                            break;
                        case 2:
                            ra_sum<2>(ph, c, acnt, A.tg, r, A.nqlm, u_re,
                                      u_im);
                            break;
                        default:
                            ra_sum<1>(ph, c, acnt, A.tg, r, A.nqlm, u_re,
                                      u_im);
                    }
                }
            }
            if (live && k == 0) {
                switch (nq) {
                    case QC:
                        ra_contract<QC>(A.q, A.ng, q0, g, gp, u_re, u_im,
                                        acc_re, acc_im, accp_re, accp_im);
                        break;
                    case 4:
                        ra_contract<4>(A.q, A.ng, q0, g, gp, u_re, u_im,
                                       acc_re, acc_im, accp_re, accp_im);
                        break;
                    case 2:
                        ra_contract<2>(A.q, A.ng, q0, g, gp, u_re, u_im,
                                       acc_re, acc_im, accp_re, accp_im);
                        break;
                    default:
                        ra_contract<1>(A.q, A.ng, q0, g, gp, u_re, u_im,
                                       acc_re, acc_im, accp_re, accp_im);
                }
            } else if (live) {
                double2* u = ubuf + ((size_t)s * (A.nqlm - qmid) + q0 - qmid) *
                                        A.tg + r;
#pragma unroll
                for (int j = 0; j < QC; ++j)
                    if (j < nq) u[j * A.tg] = make_double2(u_re[j], u_im[j]);
            }
            q0 += nq;
        }
        if (A.ksplit > 1) {
            // the upper half's sums, contracted on in the order of q
            __syncthreads();
            if (live && k == 0) {
                const double2* u =
                    ubuf + (size_t)s * (A.nqlm - qmid) * A.tg + r;
                for (int q0 = qmid; q0 < A.nqlm;) {
                    const int nq = chunk_width(A.nqlm - q0);
                    double u_re[QC], u_im[QC];
#pragma unroll
                    for (int j = 0; j < QC; ++j) {
                        const double2 v = j < nq ? u[(q0 - qmid + j) * A.tg]
                                                 : make_double2(0.0, 0.0);
                        u_re[j] = v.x;
                        u_im[j] = v.y;
                    }
                    switch (nq) {
                        case QC:
                            ra_contract<QC>(A.q, A.ng, q0, g, gp, u_re, u_im,
                                            acc_re, acc_im, accp_re, accp_im);
                            break;
                        case 4:
                            ra_contract<4>(A.q, A.ng, q0, g, gp, u_re, u_im,
                                           acc_re, acc_im, accp_re, accp_im);
                            break;
                        case 2:
                            ra_contract<2>(A.q, A.ng, q0, g, gp, u_re, u_im,
                                           acc_re, acc_im, accp_re, accp_im);
                            break;
                        default:
                            ra_contract<1>(A.q, A.ng, q0, g, gp, u_re, u_im,
                                           acc_re, acc_im, accp_re, accp_im);
                    }
                    q0 += nq;
                }
            }
        }
        if (live && k == 0) {
            ra_store(A.out + s * A.ng + g, acc_re, acc_im, A.accumulate);
            if (gp != g)
                ra_store(A.out + s * A.ng + gp, accp_re, accp_im,
                         A.accumulate);
        }
    }
}

// The premise of one atom sum a (G, -G) row, on this card: for every row
// (g, gp != g) of pairs and atom a, the phase of gp is (-sin, cos) of g's
// bit for bit, from an argument -2 m . tau that is the exact negation of
// g's. A difference in a zero's sign alone is counted apart: such a zero
// adds nothing to a sum that holds any nonzero term. counts: [0] the
// (row, atom) arguments checked; arguments, sines and cosines that differ
// otherwise [1], [3], [5] and only in a zero's sign [2], [4], [6].
__device__ __forceinline__ void bits_differ(double want, double got,
                                            unsigned long long& other,
                                            unsigned long long& zero) {
    const long long a = __double_as_longlong(want);
    const long long b = __double_as_longlong(got);
    if (a == b) return;
    if (want == 0.0 && got == 0.0)
        zero += 1;
    else
        other += 1;
}

__global__ void rho_aug_phase_check_kernel(const int* __restrict__ millers,
                                           const double* __restrict__ pos,
                                           const int2* __restrict__ pairs,
                                           long long nrow, int na,
                                           unsigned long long* counts) {
    unsigned long long c[7] = {0, 0, 0, 0, 0, 0, 0};
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < nrow * na; i += (long long)gridDim.x * blockDim.x) {
        const int2 pr = pairs[i / na];
        if (pr.x == pr.y) continue;
        const double* t = pos + 3 * (i % na);
        const int* m = millers + 3 * (long long)pr.x;
        const int* mp = millers + 3 * (long long)pr.y;
        const double2 p = aug_phase(m, t);
        const double2 pp = aug_phase(mp, t);
        c[0] += 1;
        bits_differ(-(-2.0 * miller_dot(m, t)), -2.0 * miller_dot(mp, t),
                    c[1], c[2]);
        bits_differ(-p.x, pp.x, c[3], c[4]);
        bits_differ(p.y, pp.y, c[5], c[6]);
    }
    for (int k = 0; k < 7; ++k) atomicAdd(counts + k, c[k]);
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

}  // namespace

// ns is the number of channels: 1 (unpolarized), 2 (collinear spins) or 4
// (the non-collinear (rho, m_x, m_y, m_z) component blocks); pairs the
// nrow (G, -G) rows; tg, atoms and ksplit the plan of
// kernels/augmentation.py::rho_aug_plan. The grid is every block the card
// holds resident at once (at most one a row tile).
extern "C" int rho_aug(const void* dm, const int* gidx, const double* w,
                       const int* millers, const double* pos, const int* pairs,
                       const void* q, void* out, int ns, long long nbeta2,
                       int na, int nqlm, long long ng, long long nrow, int tg,
                       int atoms, int ksplit, int accumulate, void* stream) {
    if (nrow <= 0) return (int)cudaGetLastError();
    if ((ns != 1 && ns != 2 && ns != 4) || na <= 0 || nqlm <= 0 || tg <= 0 ||
        (ksplit != 1 && ksplit != 2) || ksplit > nqlm ||
        (ksplit > 1 && atoms < na) || ns * ksplit * tg > RA_MAX_THREADS ||
        atoms <= 0 || atoms > na || nrow > ng || ng > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const RaLayout L = ra_layout(ns, nqlm, tg, atoms, ksplit);
    if (L.total > 227 * 1024) return (int)cudaErrorInvalidValue;
    // above the default 48 KB a block must opt in to dynamic shared memory
    if (L.total > 48 * 1024)
        cudaFuncSetAttribute(rho_aug_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L.total);
    int device = 0, sms = 0, resident = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, rho_aug_kernel,
                                                  ns * ksplit * tg, L.total);
    const long long tiles = (nrow + tg - 1) / tg;
    long long blocks = (long long)resident * sms;
    if (blocks > tiles) blocks = tiles;
    if (blocks <= 0) {
        const int rc = (int)cudaGetLastError();
        return rc ? rc : (int)cudaErrorInvalidConfiguration;
    }
    RaArgs A;
    A.dm = (const double2*)dm;
    A.gidx = gidx;
    A.w = w;
    A.millers = millers;
    A.pos = pos;
    A.pairs = (const int2*)pairs;
    A.q = (const double2*)q;
    A.out = (double2*)out;
    A.nbeta2 = nbeta2;
    A.ng = ng;
    A.nrow = (int)nrow;
    A.ns = ns;
    A.na = na;
    A.nqlm = nqlm;
    A.tg = tg;
    A.atoms = atoms;
    A.ksplit = ksplit;
    A.accumulate = accumulate;
    rho_aug_kernel<<<(int)blocks, ns * ksplit * tg, L.total,
                     (cudaStream_t)stream>>>(A);
    return (int)cudaGetLastError();
}

// counts [7] unsigned 64-bit, zeroed by the caller: see
// rho_aug_phase_check_kernel
extern "C" int rho_aug_phase_check(const int* millers, const double* pos,
                                   const int* pairs, long long nrow, int na,
                                   void* counts, void* stream) {
    if (nrow <= 0 || na <= 0) return (int)cudaGetLastError();
    const long long n = nrow * na;
    long long blocks = (n + THREADS - 1) / THREADS;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    rho_aug_phase_check_kernel<<<(int)blocks, THREADS, 0,
                                 (cudaStream_t)stream>>>(
        millers, pos, (const int2*)pairs, nrow, na,
        (unsigned long long*)counts);
    return (int)cudaGetLastError();
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
