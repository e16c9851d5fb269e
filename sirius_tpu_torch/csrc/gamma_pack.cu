// K8: the Gamma packed-real layout around the two FFTs of the H application.
//
// Replaces the XLA fusions of sirius_tpu/ops/gamma.py::apply_h_s_gamma:
//   K8a unpack_to_box (:216-226): x * mask_p, the gathers through slot_re /
//       slot_im, c = scale * x[slot_re] + i * (scale * im_sign) * x[slot_im],
//       and the scatter-add of c into a zeroed box at fft_index;
//   K8b box_to_packed_hx (:230-245 with _pack_device :248-268): the gather
//       of v(G) back from the transformed box, the two-image average into
//       the packed real slots, hx = ekin_p * x + vpack, and the mask.
//
// Layout (one Gamma sphere of ngk lanes, P (G, -G) pairs): packed slot 0 is
// Re c(0), slots 1..P are sqrt2 Re c(G_rep), slots P+1..2P are sqrt2 Im
// c(G_rep), slots past 1+2P are padding (mask_p 0).
//
// Bound on the H100: bytes. K8a writes the whole [B, R, nbox] box (the zero
// fill is ~nbox/ngk = 28x the sphere's traffic), K8b reads 2P+1 box entries
// of each row and writes two real sphere rows; a few flops per element.
//
// Design: K8a is a zero fill (cudaMemsetAsync) then a scatter of the valid
// sphere lanes only.
// Padded lanes carry scale 0 and fft_index 0, which is the G = 0 slot: a
// plain store of every lane would clobber c(0), so lanes with scale 0 are
// skipped (valid indices are one-to-one: no atomics, deterministic). K8b is
// a pure gather, one thread per (G, -G) pair: the JAX package scatter-adds
// both pair members into each slot; here a thread reads the pair's two box
// entries once each, as whole complex values (16 bytes for complex128, 8
// for complex64), and writes both of the pair's slots, 1 + k (the real
// parts) and 1 + P + k (the imaginary ones), the same two products in a
// commutative sum, so no atomics and the same bits (the _rn intrinsics keep
// nvcc from contracting a product and a sum into one fused multiply-add,
// which rounds once instead of twice). Pairs run in sphere order, so x, hx
// and sx are read and written coalesced; the box reads are gathers (the
// sphere is sorted by |G|, neighbouring pairs lie far apart in the box),
// each pulling in a 32-byte sector of its own. Walking the pairs in box
// order instead coalesces the gathers but scatters the packed side, three
// 4- or 8-byte accesses a slot against two box entries a pair, and on the
// H100 it ran 3x slower; staging a row's packed potential in shared memory
// (box order in, sphere order out) ran no faster than this kernel. Each
// thread loads its pair's tables once and walks a tile of PACK_ROWS rows
// (blockIdx.y), all loads of the tile issued before the stores (the grid
// is kernels/gamma_pack.py::pack_plan's). Slot 0 and the padding slots
// past 2P take the threads past P.
//
// Each entry point comes in two instantiations of one template: float64
// packed blocks with complex128 boxes (the plain names) and float32 packed
// blocks with complex64 boxes and float32 tables (the *_f32 names, the fp32
// wave-function path of sirius_tpu/ops/gamma.py::make_gamma_params with
// rdtype float32; there _pack_device's sqrt2 / 2 is the float32 rounding of
// the same double). The fp32 ones move half the bytes with the same design.
//
// Plain C interface (loaded with ctypes); every launch goes on the stream
// passed in, allocates nothing, and the function returns cudaGetLastError().
#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

// sqrt(2) / 2 rounded once: the same double as the JAX package's
// float(0.5 * np.sqrt(2.0)), and its float32 rounding
template <typename R>
__device__ __forceinline__ R half_sqrt2() {
    return R(0.70710678118654752440);
}

// x [rows, ngk] packed real -> box [rows, nbox]; the lane tables are [ngk].
template <typename R>
__global__ void unpack_scatter(const R* __restrict__ x,
                               const R* __restrict__ mask_p,
                               const int* __restrict__ slot_re,
                               const int* __restrict__ slot_im,
                               const R* __restrict__ im_sign,
                               const R* __restrict__ scale,
                               const int* __restrict__ fft_index,
                               cplx_t<R>* __restrict__ box, int ngk,
                               long long nbox, long long total) {
    for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         t < total; t += (long long)gridDim.x * blockDim.x) {
        const int g = (int)(t % ngk);
        const long long row = t / ngk;
        const R sc = scale[g];
        if (sc == R(0)) continue;  // padded lane
        const int a = slot_re[g];
        const int b = slot_im[g];
        const R xr = x[row * ngk + a] * mask_p[a];
        const R xi = x[row * ngk + b] * mask_p[b];
        box[row * nbox + fft_index[g]] =
            make_cplx<R>(sc * xr, (sc * im_sign[g]) * xi);
    }
}

// One packed slot p of one row: vp is its value gathered from the box; the
// mask, the kinetic term and the products in the order of the JAX package.
template <typename R>
__device__ __forceinline__ void store_slot(R vp, R xv, R m, R ek,
                                           R* __restrict__ hx,
                                           R* __restrict__ sx, long long t) {
    const R xm = xv * m;
    hx[t] = add_rn(mul_rn(ek, xm), vp) * m;
    sx[t] = xm * m;
}

// rows a thread: on an H100 at 54 atoms (258 rows) 2 rows ran 3 % faster
// than 1
constexpr int PACK_ROWS = 2;

// box [rows, nbox] -> hx, sx [rows, ngk] packed real. Thread j < P takes
// the pair j (both its slots), thread P slot 0, threads past P the padding
// slots 1 + 2P.. ngk - 1; each walks the PACK_ROWS rows of its tile.
template <typename R>
__global__ void pack_pairs(const cplx_t<R>* __restrict__ box,
                           const R* __restrict__ x,
                           const R* __restrict__ ekin_p,
                           const R* __restrict__ mask_p,
                           const int* __restrict__ rep_box,
                           const int* __restrict__ par_box,
                           long long zero_box, int npair,
                           R* __restrict__ hx, R* __restrict__ sx, int nrows,
                           int ngk, long long nbox) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= ngk - npair) return;
    const int row0 = blockIdx.y * PACK_ROWS;
    const R h = half_sqrt2<R>();
    if (j < npair) {
        // the per-pair tables, loaded once for the PACK_ROWS rows
        const int a = 1 + j, b = 1 + npair + j;
        const long long ra = rep_box[j], rb = par_box[j];
        const R ma = mask_p[a], mb = mask_p[b];
        const R ea = ma > R(0) ? ekin_p[a] : R(0);
        const R eb = mb > R(0) ? ekin_p[b] : R(0);
        cplx_t<R> u[PACK_ROWS], w[PACK_ROWS];
        R xa[PACK_ROWS], xb[PACK_ROWS];
#pragma unroll
        for (int i = 0; i < PACK_ROWS; ++i) {
            const long long row = row0 + i;
            if (row < nrows) {
                u[i] = box[row * nbox + ra];
                w[i] = box[row * nbox + rb];
                xa[i] = x[row * ngk + a];
                xb[i] = x[row * ngk + b];
            }
        }
#pragma unroll
        for (int i = 0; i < PACK_ROWS; ++i) {
            const long long row = row0 + i;
            if (row < nrows) {
                store_slot(add_rn(mul_rn(h, u[i].x), mul_rn(h, w[i].x)),
                           xa[i], ma, ea, hx, sx, row * ngk + a);
                store_slot(sub_rn(mul_rn(h, u[i].y), mul_rn(h, w[i].y)),
                           xb[i], mb, eb, hx, sx, row * ngk + b);
            }
        }
    } else {
        // slot 0 (Re c(0)) or a padding slot (vp 0, mask 0)
        const int p = j == npair ? 0 : j + npair;
        const R m = mask_p[p];
        const R ek = m > R(0) ? ekin_p[p] : R(0);
#pragma unroll
        for (int i = 0; i < PACK_ROWS; ++i) {
            const long long row = row0 + i;
            if (row < nrows)
                store_slot(p == 0 ? box[row * nbox + zero_box].x : R(0),
                           x[row * ngk + p], m, ek, hx, sx, row * ngk + p);
        }
    }
}

inline int grid_for(long long n, int threads) {
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    if (blocks < 1) blocks = 1;
    return (int)blocks;
}

template <typename R>
int unpack(const R* x, const R* mask_p, const int* slot_re, const int* slot_im,
           const R* im_sign, const R* scale, const int* fft_index, void* box,
           int nrows, int ngk, long long nbox, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 256;
    const long long nfill = (long long)nrows * nbox;
    // all-zero bits are a complex zero
    const cudaError_t e =
        cudaMemsetAsync(box, 0, nfill * sizeof(cplx_t<R>), s);
    if (e != cudaSuccess) return (int)e;
    const long long total = (long long)nrows * ngk;
    if (total > 0)
        unpack_scatter<R><<<grid_for(total, threads), threads, 0, s>>>(
            x, mask_p, slot_re, slot_im, im_sign, scale, fft_index,
            (cplx_t<R>*)box, ngk, nbox, total);
    return (int)cudaGetLastError();
}

// pack_pairs, 256 threads a block, PACK_ROWS rows a thread
template <typename R>
int pack(const void* box, const R* x, const R* ekin_p, const R* mask_p,
         const int* rep_box, const int* par_box, long long zero_box,
         int npair, R* hx, R* sx, int nrows, int ngk, long long nbox,
         void* stream) {
    const int threads = 256;
    const int items = ngk - npair;
    if (nrows <= 0 || items <= 0) return (int)cudaGetLastError();
    dim3 grid((unsigned)((items + threads - 1) / threads),
              (unsigned)((nrows + PACK_ROWS - 1) / PACK_ROWS));
    pack_pairs<R><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const cplx_t<R>*)box, x, ekin_p, mask_p, rep_box, par_box, zero_box,
        npair, hx, sx, nrows, ngk, nbox);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int unpack_to_box(const double* x, const double* mask_p,
                             const int* slot_re, const int* slot_im,
                             const double* im_sign, const double* scale,
                             const int* fft_index, void* box, int nrows,
                             int ngk, long long nbox, void* stream) {
    return unpack<double>(x, mask_p, slot_re, slot_im, im_sign, scale,
                          fft_index, box, nrows, ngk, nbox, stream);
}

extern "C" int unpack_to_box_f32(const float* x, const float* mask_p,
                                 const int* slot_re, const int* slot_im,
                                 const float* im_sign, const float* scale,
                                 const int* fft_index, void* box, int nrows,
                                 int ngk, long long nbox, void* stream) {
    return unpack<float>(x, mask_p, slot_re, slot_im, im_sign, scale,
                         fft_index, box, nrows, ngk, nbox, stream);
}

extern "C" int box_to_packed_hx(const void* box, const double* x,
                                const double* ekin_p, const double* mask_p,
                                const int* rep_box, const int* par_box,
                                long long zero_box, int npair, double* hx,
                                double* sx, int nrows, int ngk, long long nbox,
                                void* stream) {
    return pack<double>(box, x, ekin_p, mask_p, rep_box, par_box, zero_box,
                        npair, hx, sx, nrows, ngk, nbox, stream);
}

extern "C" int box_to_packed_hx_f32(const void* box, const float* x,
                                    const float* ekin_p, const float* mask_p,
                                    const int* rep_box, const int* par_box,
                                    long long zero_box, int npair, float* hx,
                                    float* sx, int nrows, int ngk,
                                    long long nbox, void* stream) {
    return pack<float>(box, x, ekin_p, mask_p, rep_box, par_box, zero_box,
                       npair, hx, sx, nrows, ngk, nbox, stream);
}
