// Row-gather microbenchmarks for Hopper (sm_90a): the access patterns of the
// seeding probe, measured apart from it.
//
// Replaces the three Pallas DMA kernels of tools/microbench_pallas_gather.py:
//   gather_flat    dma_flat   (:107)  out[i]    = src[idx[i]]
//   gather_window  dma_window (:144)  out[i]    = src[idx[i] : idx[i] + rows]
//   gather_chain   dma_chain  (:203)  x <- (src[x, 0] ^ (x << 1)) mod N,
//                                     rounds times, one lane a thread
// On the TPU every row fetch was an async DMA issued by the scalar core into
// VMEM; on a GPU a thread loads from global memory itself, so each kernel is
// a plain grid of loads. The row width in words is a runtime argument: 128
// words (512 B) are the TPU tool's rows, 4 words (16 B) are the rank rows the
// seeding kernel reads.
//
// Bounds: gather_flat and gather_window are bound by bytes (32-byte sectors
// read and written over the HBM rate) once a call moves megabytes: 512-byte
// rows for 65536 lanes are 32 MB each way. Where the row width is a multiple
// of four words and both pointers are 16-byte aligned, one thread moves 16
// bytes (a uint4): a 16-byte rank row is one load and one store, a 512-byte
// row one coalesced access of a warp. Other widths move a word a thread. The
// thread's lane comes from a shift when a lane's span is a power of two, else
// from one division. At the rank-row case of the seeding batch (16-byte rows,
// 4096 lanes: 64 KB a call) the card's work is a few microseconds and the
// call is bound by the host's launch path (ops/launch.py).
// gather_chain is bound by the latency of a dependent random load, rounds
// times over; nothing hides it inside a lane, only more lanes in flight do.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// out[i, r, j] = src[idx[i] + r, j] for r < rows, j < width; rows == 1 is
// the flat gather. One thread a unit V (a word, or four words as a uint4);
// span = a lane's units, width = a row's, total = all of them. shift >= 0
// says span == 1 << shift.
template <class V>
__global__ void gather_rows_kernel(const V* __restrict__ src,
                                   const int32_t* __restrict__ idx,
                                   V* __restrict__ out, long long total,
                                   int span, int width, int shift) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= total) return;
    long long lane;
    int within;
    if (shift >= 0) {
        lane = t >> shift;
        within = (int)(t & (span - 1));
    } else {
        lane = t / span;
        within = (int)(t - lane * span);
    }
    out[t] = src[(long long)idx[lane] * width + within];
}

__global__ void gather_chain_kernel(const uint32_t* __restrict__ src,
                                    const int32_t* __restrict__ idx,
                                    int32_t* __restrict__ out, int lanes,
                                    int n_rows, int width, int rounds) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= lanes) return;
    int32_t x = idx[i];
    for (int k = 0; k < rounds; ++k) {
        int32_t row0 = (int32_t)src[(long long)x * width];
        int32_t y = (int32_t)((uint32_t)x << 1);  // int32 wrap
        int32_t r = (row0 ^ y) % n_rows;
        x = r < 0 ? r + n_rows : r;
    }
    out[i] = x;
}

template <class V>
int launch_rows(const void* src, const void* idx, void* out, long long lanes,
                int span, int width, void* stream) {
    int shift = -1;
    if ((span & (span - 1)) == 0)
        for (shift = 0; (1 << shift) < span; ++shift) {}
    const long long total = lanes * span;
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    gather_rows_kernel<V><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const V*)src, (const int32_t*)idx, (V*)out, total, span, width,
        shift);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gather_rows_launch(const void* src, const void* idx, void* out, int lanes,
                       int rows, int width, void* stream) {
    if ((long long)lanes * rows * width == 0) return 0;
    const bool vec = width % 4 == 0 &&
                     ((uintptr_t)src | (uintptr_t)out) % 16 == 0;
    return vec ? launch_rows<uint4>(src, idx, out, lanes, rows * (width / 4),
                                    width / 4, stream)
               : launch_rows<uint32_t>(src, idx, out, lanes, rows * width,
                                       width, stream);
}

int gather_chain_launch(const void* src, const void* idx, void* out, int lanes,
                        int n_rows, int width, int rounds, void* stream) {
    if (lanes == 0) return 0;
    const int threads = 128;
    gather_chain_kernel<<<(lanes + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t*)src, (const int32_t*)idx, (int32_t*)out, lanes,
        n_rows, width, rounds);
    return (int)cudaGetLastError();
}

}  // extern "C"
