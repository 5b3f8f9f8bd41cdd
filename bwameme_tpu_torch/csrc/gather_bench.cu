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
// read and written over the HBM rate); one thread copies one word, so the
// threads of a warp read neighbouring words of a row and the stores coalesce.
// gather_chain is bound by the latency of a dependent random load, rounds
// times over; nothing hides it inside a lane, only more lanes in flight do.

#include <cstdint>
#include <cuda_runtime.h>

extern "C" {

// out[i, r, j] = src[idx[i] + r, j] for r < rows, j < width; rows == 1 is
// the flat gather. One thread a word.
__global__ void gather_rows_kernel(const uint32_t* __restrict__ src,
                                   const int32_t* __restrict__ idx,
                                   uint32_t* __restrict__ out,
                                   long long total, int span, int width) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= total) return;
    long long lane = t / span;
    int within = (int)(t - lane * span);
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

int gather_rows_launch(const void* src, const void* idx, void* out, int lanes,
                       int rows, int width, void* stream) {
    long long total = (long long)lanes * rows * width;
    if (total == 0) return 0;
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    gather_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)src, (const int32_t*)idx, (uint32_t*)out, total,
        rows * width, width);
    return (int)cudaGetLastError();
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
