// K10a / K10b: the G-space halves of the GGA gradient and divergence.
//
// K10a replaces sirius_tpu/dft/potential.py::_gradient_r (:57-61; device
// form gradient_r :282-283) up to its inverse FFTs: for each field f(G) on
// the fine G set and each Cartesian direction c, the box holding
// i G_c f(G) at fft_index and zero elsewhere -- three pw_to_box scatters
// and the [3, ng] products of the JAX code in one pass.
// K10b replaces _divergence_g (:64-69; device form :285-288) after its
// forward FFTs: the three transformed boxes F_c gathered at fft_index and
// combined as sum_c i G_c F_c(G), summed from zero in the order c = 0, 1, 2
// as the JAX code does -- three box_to_pw gathers, the products and the sum.
//
// Bound on the H100: bytes. K10a writes three whole complex boxes per field
// (48 bytes a box point) and reads 16 + 24 + 4 bytes a G vector; K10b reads
// 48 + 24 + 4 bytes a G vector and writes 16. The fine G set is a sphere of
// about a third of the box, so K10a's stores of whole boxes dominate.
//
// Design: K10a walks the box in slot order, one thread a slot. It reads the
// slot's G index from box_to_g (the inverse of fft_index, -1 off the G set,
// built once by dft/density.py::grid_tables), gathers G's Cartesian
// components once and f(G) of each field, and stores i G_c f(G), or an
// exact zero off the G set, into each of the 3 S boxes. Neighbouring threads
// store to neighbouring slots, so every store is coalesced and each box byte
// is written once (no zero fill before a scatter). K10b is one thread per
// (field, G), three gathers and the sum in registers. Products and sums use
// __dmul_rn / __dadd_rn, so the compiler cannot fuse them: the results are
// the plain version's bits, whatever order the walk takes.
//
// Plain C interface (loaded with ctypes); every launch goes on the stream
// passed in, allocates nothing, and each function returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <cuComplex.h>

namespace {

// f [nfield, ng] -> box [nfield, 3, nbox], one thread a box slot
__global__ void gradient_walk(const cuDoubleComplex* __restrict__ f,
                              const double* __restrict__ gcart,
                              const int* __restrict__ box_to_g,
                              cuDoubleComplex* __restrict__ box, int nfield,
                              int ng, long long nbox) {
    for (long long slot = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         slot < nbox; slot += (long long)gridDim.x * blockDim.x) {
        const int g = box_to_g[slot];
        if (g < 0) {
            const cuDoubleComplex zero = make_cuDoubleComplex(0.0, 0.0);
            for (int sc = 0; sc < 3 * nfield; ++sc) box[sc * nbox + slot] = zero;
            continue;
        }
        const double gc[3] = {gcart[3 * g], gcart[3 * g + 1], gcart[3 * g + 2]};
        for (int s = 0; s < nfield; ++s) {
            const cuDoubleComplex v = f[(long long)s * ng + g];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                // i G_c f = (-G_c Im f, G_c Re f)
                box[(s * 3 + c) * nbox + slot] = make_cuDoubleComplex(
                    -__dmul_rn(gc[c], v.y), __dmul_rn(gc[c], v.x));
            }
        }
    }
}

// box [nfield, 3, nbox] -> out [nfield, ng]
__global__ void divergence_gather(const cuDoubleComplex* __restrict__ box,
                                  const double* __restrict__ gcart,
                                  const int* __restrict__ fft_index,
                                  cuDoubleComplex* __restrict__ out, int ng,
                                  long long nbox, long long total) {
    for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         t < total; t += (long long)gridDim.x * blockDim.x) {
        const int g = (int)(t % ng);
        const long long s = t / ng;
        const long long slot = fft_index[g];
        double re = 0.0, im = 0.0;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const double gc = gcart[3 * g + c];
            const cuDoubleComplex v = box[(s * 3 + c) * nbox + slot];
            re = __dadd_rn(re, -__dmul_rn(gc, v.y));
            im = __dadd_rn(im, __dmul_rn(gc, v.x));
        }
        out[t] = make_cuDoubleComplex(re, im);
    }
}

inline int grid_for(long long n, int threads) {
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    if (blocks < 1) blocks = 1;
    return (int)blocks;
}

}  // namespace

// box_to_g [nbox] int32: the G index of each box slot, -1 off the G set
extern "C" int gradient_boxes(const void* f, const double* gcart,
                              const int* box_to_g, void* box, int nfield,
                              int ng, long long nbox, void* stream) {
    const int threads = 256;
    if (nbox > 0 && nfield > 0)
        gradient_walk<<<grid_for(nbox, threads), threads, 0,
                        (cudaStream_t)stream>>>(
            (const cuDoubleComplex*)f, gcart, box_to_g, (cuDoubleComplex*)box,
            nfield, ng, nbox);
    return (int)cudaGetLastError();
}

extern "C" int divergence_pw(const void* box, const double* gcart,
                             const int* fft_index, void* out, int nfield,
                             int ng, long long nbox, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 256;
    const long long total = (long long)nfield * ng;
    if (total > 0)
        divergence_gather<<<grid_for(total, threads), threads, 0, s>>>(
            (const cuDoubleComplex*)box, gcart, fft_index,
            (cuDoubleComplex*)out, ng, nbox, total);
    return (int)cudaGetLastError();
}
