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
// gather_rows also runs the main path's gathers: the mapper's work slab
// (clid_slam_torch/mapping/mapper.py) and the hash-mirror probes
// (models/neural_map.py neighborhood_probe and insert_points,
// models/local_map.py region_specific_sdf).
//
// What bounds them on the H100: bytes. A gather does no arithmetic; it reads
// each index once, touches the table and writes each output element once.
//
// gather_rows, designed for the hash mirrors: 16-byte rows picked at random
// out of a 64 MB (2^22 rows) or 32 MB (2^21) table, 0.07-1.33 M lookups a
// call, up to 21 MB written. Each lookup costs one 32-byte sector of device
// memory behind a dependent pair of loads (index, then row); its bound is
// those sectors, the indices and the output at 3.35 TB/s.
//   - One 16-byte piece a thread (single floats for rows that are not a
//     multiple of 4 floats: feature_dim 6); the grid holds as many blocks
//     as the card keeps resident (8 of 256 threads on each SM) and strides
//     over the pieces.
//   - Table rows are read with an L2 evict-last policy, the indices with
//     streaming loads (__ldcs) and the output stored streaming (__stcs), so
//     the rows that neighbouring points share stay in the 50 MB L2 while
//     the output and the indices pass through it.
//     The main path's kernels that follow take the same time after it as
//     after PyTorch's gather (profile, PERF.md section 6).
//   - No shared-memory staging: a gather reuses nothing within a block.
//   Measured (PERF.md section 6, tools/probe_gather.py --main-path on an
//   H100 80GB HBM3 at 700 W, cold, against the kernel before it, which had
//   plain loads and one thread a piece with no grid stride, in one run):
//   13.6 us at the mapper's probe (1.33 M lookups, bound 9.7 us; before
//   14.6; PyTorch's table[idx] 800), 11.1 at the local map's (bound 7.0;
//   before 11.5-11.9), 7.5-7.7 at the tracker's (bound 4.9; the same as
//   before), 2.0 at the insert's (65 k lookups: launch latency); 18
//   registers a thread. Several pieces a thread with all their loads in
//   flight before any store, the design first planned, was slower at every
//   shape: with the dependent index load in each chain, more resident warps
//   hide the latency better than fewer, longer threads.
//   gather_lanes  one thread per output element; a warp reads 32 selectors
//                 and writes 32 floats contiguously, the reads stay inside
//                 one source row.
//   gather_cols   one thread per output element, index j fastest: stores are
//                 contiguous, the index vector is re-read once per table row
//                 from L1/L2.
// The index type (int32 or int64) is a template argument. Indices are not
// checked or clamped: an index outside the table is the caller's error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// blocks an SM holds at once (2048 threads); __launch_bounds__ keeps the
// registers low enough for that
constexpr int kBlocksPerSm = 2048 / kThreads;

__device__ __forceinline__ unsigned long long l2_evict_last() {
    unsigned long long policy;
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
    return policy;
}

// read-only table loads that ask the L2 to keep the line
__device__ __forceinline__ float4 load_kept(const float4* p, unsigned long long policy) {
    float4 v;
    asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "l"(policy));
    return v;
}

__device__ __forceinline__ float load_kept(const float* p, unsigned long long policy) {
    float v;
    asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(policy));
    return v;
}

__device__ __forceinline__ long long load_index(const int32_t* p) { return __ldcs(p); }
__device__ __forceinline__ long long load_index(const int64_t* p) {
    return __ldcs(reinterpret_cast<const long long*>(p));
}

// out piece t = table piece idx[t / c4] * c4 + t % c4, for t < n_pieces:
// one piece a thread, the grid striding over the pieces, each store
// coalesced across the warp.
template <typename IdxT, typename Piece>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
gather_rows_kernel(const Piece* __restrict__ table, const IdxT* __restrict__ idx,
                   Piece* __restrict__ out, long long n_pieces, int c4) {
    const unsigned long long policy = l2_evict_last();
    const long long stride = (long long)gridDim.x * kThreads;
    for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < n_pieces; t += stride) {
        const long long row = c4 == 1 ? t : t / c4;
        const long long src = load_index(idx + row) * c4 + (t - row * c4);
        __stcs(out + t, load_kept(table + src, policy));
    }
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

// a grid of as many blocks as the card holds at once (kBlocksPerSm a SM),
// fewer for a short call
template <typename IdxT, typename Piece>
int launch_rows(const void* table, const void* idx, void* out, long long n_pieces, int c4,
                cudaStream_t s) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (n_pieces + kThreads - 1) / kThreads;
    const long long cap = (long long)sms * kBlocksPerSm;
    gather_rows_kernel<IdxT, Piece><<<(unsigned)(blocks < cap ? blocks : cap), kThreads, 0, s>>>(
        (const Piece*)table, (const IdxT*)idx, (Piece*)out, n_pieces, c4);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t (0 = launched). Shape, type and alignment checks
// live in the Python wrapper; sizes the launch cannot take return
// cudaErrorInvalidValue. idx64 != 0 selects int64 indices, else int32.

// pieces: 16-byte pieces per row when wide != 0, else floats per row
int clid_gather_rows(const void* table, const void* idx, void* out, long long n, int pieces,
                     int wide, int idx64, void* stream) {
    if (n < 1 || pieces < 1 || n > (1LL << 40)) return (int)cudaErrorInvalidValue;
    const long long n_pieces = n * pieces;
    cudaStream_t s = (cudaStream_t)stream;
    if (wide)
        return idx64 ? launch_rows<int64_t, float4>(table, idx, out, n_pieces, pieces, s)
                     : launch_rows<int32_t, float4>(table, idx, out, n_pieces, pieces, s);
    return idx64 ? launch_rows<int64_t, float>(table, idx, out, n_pieces, pieces, s)
                 : launch_rows<int32_t, float>(table, idx, out, n_pieces, pieces, s);
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
