// Gather kernels for Hopper (sm_90a): rows, lanes and columns of f32 tables.
//
// They replace the Pallas gather probes of the JAX package:
//   gather_rows   scripts/probe_pallas_gather.py   gather_a  (table [32768, 4])
//                 scripts/probe_pallas_gather.py   gather_a2 (table [16384, 128])
//                 scripts/probe_pallas_gather2.py  make_a, make_b
//                 (work slab [98304, 8], sorted indices with duplicates);
//                 the two Mosaic formulations (ref indexing, jnp.take) are one
//                 function here
//   gather_lanes  scripts/probe_pallas_gather.py   gather_b
//                 (take_along_axis on the last axis)
//   gather_cols   scripts/probe_pallas_gather2.py  make_c
//                 (transposed table [8, 98304])
// and gather_rows is the mapper's per-step gather of the work slab
// (clid_slam_torch/mapping/mapper.py).
//
// What bounds them on the H100: bytes. A gather does no arithmetic; it reads
// each index once, touches the table and writes each output element once.
// At the shapes above every table is at most 8.4 MB and stays in the 50 MB
// L2, so the HBM byte count is a floor rather than a target and a launch is
// dominated by its own latency.
//
// Design: the simplest form that keeps memory transactions wide.
//   gather_rows   one thread per 16-byte piece of an output row: neighbouring
//                 threads read neighbouring pieces of one table row and write
//                 neighbouring float4s, so a warp stores 512 contiguous bytes.
//   gather_lanes  one thread per output element; a warp reads 32 selectors
//                 and writes 32 floats contiguously, the reads stay inside
//                 one source row.
//   gather_cols   one thread per output element, index j fastest: stores are
//                 contiguous, the index vector is re-read once per table row
//                 from L1/L2.
// No shared-memory staging, cp.async or TMA yet. The index type (int32 or
// int64) is a template argument. Indices are not checked or clamped: an index
// outside the table is the caller's error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename IdxT>
__global__ void gather_rows_kernel(const float4* __restrict__ table,
                                   const IdxT* __restrict__ idx,
                                   float4* __restrict__ out,
                                   long long n_pieces, int c4) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_pieces) return;
    long long row = t / c4;
    int piece = (int)(t - row * c4);
    long long src = (long long)idx[row];
    out[t] = __ldg(table + src * c4 + piece);
}

template <typename IdxT>
__global__ void gather_lanes_kernel(const float* __restrict__ src,
                                    const IdxT* __restrict__ sel,
                                    float* __restrict__ out,
                                    long long n_out, int lanes_in, int lanes_out) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_out) return;
    long long row = t / lanes_out;
    long long lane = (long long)sel[t];
    out[t] = __ldg(src + row * lanes_in + lane);
}

template <typename IdxT>
__global__ void gather_cols_kernel(const float* __restrict__ table_t,
                                   const IdxT* __restrict__ idx,
                                   float* __restrict__ out,
                                   long long n_out, long long width, long long n) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_out) return;
    long long f = t / n;
    long long j = t - f * n;
    long long col = (long long)idx[j];
    out[t] = __ldg(table_t + f * width + col);
}

inline bool grid_for(long long n_threads, unsigned* blocks) {
    long long b = (n_threads + kThreads - 1) / kThreads;
    if (b < 1 || b > 2147483647LL) return false;
    *blocks = (unsigned)b;
    return true;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t (0 = launched). Shape, type and alignment checks
// live in the Python wrapper; sizes the launch cannot take return
// cudaErrorInvalidValue. idx64 != 0 selects int64 indices, else int32.

int clid_gather_rows(const void* table, const void* idx, void* out,
                     long long n, int c4, int idx64, void* stream) {
    unsigned blocks;
    if (n < 1 || c4 < 1 || !grid_for(n * c4, &blocks)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (idx64)
        gather_rows_kernel<int64_t><<<blocks, kThreads, 0, s>>>(
            (const float4*)table, (const int64_t*)idx, (float4*)out, n * c4, c4);
    else
        gather_rows_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
            (const float4*)table, (const int32_t*)idx, (float4*)out, n * c4, c4);
    return (int)cudaGetLastError();
}

int clid_gather_lanes(const void* src, const void* sel, void* out,
                      long long n, int lanes_in, int lanes_out, int idx64,
                      void* stream) {
    unsigned blocks;
    if (n < 1 || lanes_in < 1 || lanes_out < 1 || !grid_for(n * lanes_out, &blocks))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (idx64)
        gather_lanes_kernel<int64_t><<<blocks, kThreads, 0, s>>>(
            (const float*)src, (const int64_t*)sel, (float*)out, n * lanes_out,
            lanes_in, lanes_out);
    else
        gather_lanes_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
            (const float*)src, (const int32_t*)sel, (float*)out, n * lanes_out,
            lanes_in, lanes_out);
    return (int)cudaGetLastError();
}

int clid_gather_cols(const void* table_t, const void* idx, void* out,
                     long long rows, long long width, long long n, int idx64,
                     void* stream) {
    unsigned blocks;
    if (rows < 1 || width < 1 || n < 1 || !grid_for(rows * n, &blocks))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (idx64)
        gather_cols_kernel<int64_t><<<blocks, kThreads, 0, s>>>(
            (const float*)table_t, (const int64_t*)idx, (float*)out, rows * n, width, n);
    else
        gather_cols_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
            (const float*)table_t, (const int32_t*)idx, (float*)out, rows * n, width, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
