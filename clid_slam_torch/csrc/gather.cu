// Gather kernels for Hopper (sm_90a): rows and columns of f32 tables, and
// lanes of any 1-, 4-, 8- or 16-byte element.
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
// models/local_map.py region_specific_sdf). gather_lanes runs the kNN
// selection: the K nearest of 81 candidate buckets a point picks out of
// the probe's d2 (f32), bucket (int64), valid (bool) and mirror rows (16
// bytes) (mapping/mapper.py build_cache, odometry/iekf.py
// build_candidates, models/neural_map.py query_feature).
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
//
// gather_lanes: out[n, j] = src[n, sel[n, j]], a lane being one element of
// 1, 4 or 8 bytes or a 16-byte piece (a [N, L, 4] f32 table), copied as
// bits (the lane size is a template argument). Two regimes:
//   - narrow (K of L lanes picked, K << L: the main path's 6 or 16 of 81):
//     one thread an output lane on a grid of the card's resident blocks,
//     striding. The source lane is read through the read-only path (a
//     point's 81-lane row is at most 11 sectors, 41 for 16-byte lanes, and
//     its K picks meet in L1), the selectors with streaming loads, the
//     output stored streaming and coalesced. Nothing is staged: a pick
//     touches one sector. Selector rows may be strided (the first K columns
//     of smallest_k's sort), lanes within a row adjacent.
//   - staged (K of the order of L: the probe's [16384, 128] <- [16384,
//     128]): a block copies a tile of whole source rows (contiguous in
//     memory) into shared memory with 16-byte read-only loads, then each
//     thread takes 4 consecutive output lanes of the tile: one 16-byte
//     selector load (two for int64), 4 shared-memory reads and 16 bytes of
//     streaming stores for f32. Every source byte then comes from device
//     memory once and coalesced, not through K scattered reads a row.
//     It needs contiguous selectors, K % 4 == 0, rows of a multiple of 16
//     bytes (at most kStageBytes) and 16-byte aligned source and selectors.
//   The shapes alone pick the regime: staged where it can run and
//   K >= L / kStagedRatio, narrow elsewhere (kStagedRatio is the one place
//   that decides). At [16384, 128] f32 with K uniform picks a row the two
//   met at K = L / 4 on the card (PERF.md section 6, H100 80GB HBM3 at
//   700 W): below it the narrow regime's few scattered reads cost less than
//   staging whole rows, above it the staged copy wins.
//   Measured (PERF.md section 6; tools/probe_gather.py on an H100 80GB HBM3
//   at 700 W, cold = graph-replayed past the L2): 8.5 us at the probe's
//   [16384, 128] <- [16384, 128] (staged; bound 7.5; the kernel before, one
//   thread an element, 11.2). The stage copy through the read-only path
//   (L1-allocating) rather than evict-first loads costs 0.15 us cold there
//   and saves 2.1 us when the source sits in the L2. At the selection's
//   shapes the narrow regime takes 2.7-4.2 us cold (bounds 0.5-1.9 us:
//   launch latency) against 9.1-9.8 for torch.gather(1); 18 registers.
//
// gather_cols: out[f, j] = table_t[f, idx[j]] for the F rows of a
// transposed table. Each thread takes 4 consecutive j: one 16-byte index
// load (two for int64), the F x 4 table loads (read-only path), then F
// 16-byte streaming stores, on a grid of the card's resident blocks (4 of
// 256 threads on each SM: the launch bounds leave a thread 64 registers
// for its unrolled loads). The probe's indices are sorted with duplicates,
// so neighbouring j read neighbouring columns. Where the count is not a multiple of 4 or the
// indices or the output are not 16-byte aligned, the same thread layout
// loads and stores single floats.
//   Measured (as above): 3.8 us cold at [8, 98304] against a 2.0 us bound
//   (the kernel before, one thread an element re-reading the index for
//   each row: 4.8); what remains is launch latency (the insert's 65 k
//   lookups take 1.95 us). gather_rows' L2 evict-last policy on the table
//   reads changed nothing here (3.78-3.79 us without, 3.80-3.82 with), so
//   the loads are plain.
//
// The index type (int32 or int64) is a template argument. Indices are not
// checked or clamped: an index outside the table is the caller's error.

// Python.h first, as the Python API asks: the wrappers in ops/gather.py
// call the entries at the end of this file as a Python extension module
#include <Python.h>

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// blocks an SM holds at once (2048 threads); __launch_bounds__ keeps the
// registers low enough for that
constexpr int kBlocksPerSm = 2048 / kThreads;
// gather_cols' blocks an SM holds at once
constexpr int kColsBlocksPerSm = kBlocksPerSm / 2;
// gather_lanes' staged regime: most bytes of source rows a block stages
// (static shared memory stays under the 48 KB a launch gets unasked), and
// the least K that takes it, as a fraction of L
constexpr int kStageBytes = 16384;
constexpr int kStagedRatio = 4;

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

// 4 consecutive indices from a 16-byte aligned address
__device__ __forceinline__ void load_index4(const int32_t* p, long long c[4]) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
    c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
}
__device__ __forceinline__ long long join64(int lo, int hi) {
    return (long long)(((unsigned long long)(unsigned)hi << 32) | (unsigned)lo);
}
__device__ __forceinline__ void load_index4(const int64_t* p, long long c[4]) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(p));
    const int4 b = __ldcs(reinterpret_cast<const int4*>(p) + 1);
    c[0] = join64(a.x, a.y); c[1] = join64(a.z, a.w);
    c[2] = join64(b.x, b.y); c[3] = join64(b.z, b.w);
}

// 4 consecutive lanes, streaming, to an address aligned to their size (16
// bytes at most)
__device__ __forceinline__ void store4(unsigned char* p, const unsigned char v[4]) {
    __stcs(reinterpret_cast<unsigned int*>(p),
           v[0] | (unsigned)v[1] << 8 | (unsigned)v[2] << 16 | (unsigned)v[3] << 24);
}
__device__ __forceinline__ void store4(unsigned int* p, const unsigned int v[4]) {
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store4(unsigned long long* p, const unsigned long long v[4]) {
    for (int k = 0; k < 4; k += 2)
        __stcs(reinterpret_cast<uint4*>(p + k),
               make_uint4((unsigned)v[k], (unsigned)(v[k] >> 32), (unsigned)v[k + 1],
                          (unsigned)(v[k + 1] >> 32)));
}
__device__ __forceinline__ void store4(uint4* p, const uint4 v[4]) {
    for (int k = 0; k < 4; ++k) __stcs(p + k, v[k]);
}

// the type one lane of `bytes` bytes is copied as
template <int bytes> struct Lane;
template <> struct Lane<1> { using T = unsigned char; };
template <> struct Lane<4> { using T = unsigned int; };
template <> struct Lane<8> { using T = unsigned long long; };
template <> struct Lane<16> { using T = uint4; };

// a grid of as many blocks as the card holds at once (per_sm a SM, as the
// kernel's launch bounds ask), fewer for a short call
inline int resident_grid(long long work, int per_sm, unsigned* blocks) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const long long need = (work + kThreads - 1) / kThreads;
    const long long cap = (long long)sms * per_sm;
    *blocks = (unsigned)(need < cap ? need : cap);
    return 0;
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

// out[t] = src[row, sel[row * sel_ld + j]] with row = t / lanes_out and
// j = t % lanes_out: one output lane a thread, the grid striding.
template <typename IdxT, typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
gather_lanes_narrow(const T* __restrict__ src, const IdxT* __restrict__ sel,
                    T* __restrict__ out, long long n_out, int lanes_in, int lanes_out,
                    long long sel_ld) {
    const long long stride = (long long)gridDim.x * kThreads;
    for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < n_out; t += stride) {
        const long long row = t / lanes_out;
        const long long j = t - row * lanes_out;
        __stcs(out + t, __ldg(src + row * lanes_in + load_index(sel + row * sel_ld + j)));
    }
}

// one block a tile of tile_rows source rows: the rows (contiguous) go to
// shared memory in 16-byte read-only (__ldg) loads, then each thread takes
// groups of 4 consecutive output lanes (one row's, as lanes_out % 4 == 0).
template <typename IdxT, typename T>
__global__ void __launch_bounds__(kThreads)
gather_lanes_staged(const T* __restrict__ src, const IdxT* __restrict__ sel,
                    T* __restrict__ out, long long n, int lanes_in, int lanes_out,
                    int tile_rows) {
    __shared__ uint4 stage[kStageBytes / 16];
    const T* rows_s = reinterpret_cast<const T*>(stage);
    const long long r0 = (long long)blockIdx.x * tile_rows;
    const int rows = (int)(n - r0 < tile_rows ? n - r0 : tile_rows);
    const uint4* src16 = reinterpret_cast<const uint4*>(src + r0 * lanes_in);
    const int n16 = rows * lanes_in * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < n16; i += kThreads) stage[i] = __ldg(src16 + i);
    __syncthreads();
    const IdxT* sel_t = sel + r0 * lanes_out;
    T* out_t = out + r0 * lanes_out;
    const int groups = rows * lanes_out / 4;
    for (int g = threadIdx.x; g < groups; g += kThreads) {
        const int q = 4 * g;
        const T* row = rows_s + (q / lanes_out) * lanes_in;
        long long s[4];
        load_index4(sel_t + q, s);
        T v[4];
        for (int k = 0; k < 4; ++k) v[k] = row[s[k]];
        store4(out_t + q, v);
    }
}

template <typename IdxT>
__device__ __forceinline__ void load_cols4(const IdxT* idx, long long j, long long n, bool vec,
                                           long long c[4]) {
    if (vec) {
        load_index4(idx + j, c);
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) c[k] = j + k < n ? load_index(idx + j + k) : 0;
    }
}

// out[f, j] for 4 consecutive j a thread and every f < rows, the grid
// striding over the groups of 4; kVec: n % 4 == 0 and the indices and the
// output are 16-byte aligned, so indices and stores move 16 bytes at once
template <typename IdxT, bool kVec>
__global__ void __launch_bounds__(kThreads, kColsBlocksPerSm)
gather_cols_kernel(const float* __restrict__ table_t, const IdxT* __restrict__ idx,
                   float* __restrict__ out, int rows, long long width, long long n) {
    const long long groups = (n + 3) / 4;
    const long long stride = (long long)gridDim.x * kThreads;
    for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < groups; g += stride) {
        const long long j = 4 * g;
        long long c[4];
        load_cols4(idx, j, n, kVec, c);
        const int m = n - j < 4 ? (int)(n - j) : 4;
#pragma unroll 4
        for (int f = 0; f < rows; ++f) {
            const float* row = table_t + f * width;
            float* o = out + f * n + j;
            if (kVec) {
                __stcs(reinterpret_cast<float4*>(o), make_float4(__ldg(row + c[0]), __ldg(row + c[1]),
                                                                 __ldg(row + c[2]), __ldg(row + c[3])));
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    if (k < m) __stcs(o + k, __ldg(row + c[k]));
            }
        }
    }
}

template <typename IdxT, typename Piece>
int launch_rows(const void* table, const void* idx, void* out, long long n_pieces, int c4,
                cudaStream_t s) {
    unsigned blocks;
    const int err = resident_grid(n_pieces, kBlocksPerSm, &blocks);
    if (err != 0) return err;
    gather_rows_kernel<IdxT, Piece><<<blocks, kThreads, 0, s>>>(
        (const Piece*)table, (const IdxT*)idx, (Piece*)out, n_pieces, c4);
    return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename IdxT, int bytes>
int launch_lanes(const void* src, const void* sel, void* out, long long n, int lanes_in,
                 int lanes_out, long long sel_ld, cudaStream_t s) {
    using T = typename Lane<bytes>::T;
    const long long row_bytes = (long long)lanes_in * bytes;
    const bool can_stage = sel_ld == lanes_out && lanes_out % 4 == 0 && row_bytes % 16 == 0
                           && row_bytes <= kStageBytes && aligned16(src) && aligned16(sel);
    if (can_stage && (long long)lanes_out * kStagedRatio >= lanes_in) {
        long long tile = 4LL * kThreads / lanes_out;  // 4 lanes a thread in one pass
        if (tile > kStageBytes / row_bytes) tile = kStageBytes / row_bytes;
        if (tile < 1) tile = 1;
        const long long blocks = (n + tile - 1) / tile;
        if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
        gather_lanes_staged<IdxT, T><<<(unsigned)blocks, kThreads, 0, s>>>(
            (const T*)src, (const IdxT*)sel, (T*)out, n, lanes_in, lanes_out, (int)tile);
    } else {
        unsigned blocks;
        const int err = resident_grid(n * lanes_out, kBlocksPerSm, &blocks);
        if (err != 0) return err;
        gather_lanes_narrow<IdxT, T><<<blocks, kThreads, 0, s>>>(
            (const T*)src, (const IdxT*)sel, (T*)out, n * lanes_out, lanes_in, lanes_out, sel_ld);
    }
    return (int)cudaGetLastError();
}

template <typename IdxT>
int launch_lanes_of(const void* src, const void* sel, void* out, long long n, int lanes_in,
                    int lanes_out, long long sel_ld, int bytes, cudaStream_t s) {
    switch (bytes) {
        case 1: return launch_lanes<IdxT, 1>(src, sel, out, n, lanes_in, lanes_out, sel_ld, s);
        case 4: return launch_lanes<IdxT, 4>(src, sel, out, n, lanes_in, lanes_out, sel_ld, s);
        case 8: return launch_lanes<IdxT, 8>(src, sel, out, n, lanes_in, lanes_out, sel_ld, s);
        case 16: return launch_lanes<IdxT, 16>(src, sel, out, n, lanes_in, lanes_out, sel_ld, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename IdxT>
int launch_cols(const void* table_t, const void* idx, void* out, int rows, long long width,
                long long n, cudaStream_t s) {
    unsigned blocks;
    const int err = resident_grid((n + 3) / 4, kColsBlocksPerSm, &blocks);
    if (err != 0) return err;
    if (n % 4 == 0 && aligned16(idx) && aligned16(out))
        gather_cols_kernel<IdxT, true><<<blocks, kThreads, 0, s>>>(
            (const float*)table_t, (const IdxT*)idx, (float*)out, rows, width, n);
    else
        gather_cols_kernel<IdxT, false><<<blocks, kThreads, 0, s>>>(
            (const float*)table_t, (const IdxT*)idx, (float*)out, rows, width, n);
    return (int)cudaGetLastError();
}

// The kernels' entries. Each returns a cudaError_t (0 = launched). Shape,
// type and alignment checks live in the Python wrapper; sizes the launch
// cannot take return cudaErrorInvalidValue. idx64 != 0 selects int64
// indices, else int32.

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

// src [n, lanes_in] lanes of `mode & 31` bytes (1, 4, 8 or 16), sel rows
// sel_ld indices apart, out [n, lanes_out]. mode bit 5: int64 selectors.
int clid_gather_lanes(const void* src, const void* sel, void* out, long long n, int lanes_in,
                      int lanes_out, long long sel_ld, int mode, void* stream) {
    if (n < 1 || lanes_in < 1 || lanes_out < 1 || sel_ld < lanes_out || n > (1LL << 40))
        return (int)cudaErrorInvalidValue;
    const int bytes = mode & 31;
    cudaStream_t s = (cudaStream_t)stream;
    return (mode & 32)
        ? launch_lanes_of<int64_t>(src, sel, out, n, lanes_in, lanes_out, sel_ld, bytes, s)
        : launch_lanes_of<int32_t>(src, sel, out, n, lanes_in, lanes_out, sel_ld, bytes, s);
}

int clid_gather_cols(const void* table_t, const void* idx, void* out,
                     long long rows, long long width, long long n, int idx64,
                     void* stream) {
    if (rows < 1 || rows > 65536 || width < 1 || n < 1 || n > (1LL << 40))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return idx64 ? launch_cols<int64_t>(table_t, idx, out, (int)rows, width, n, s)
                 : launch_cols<int32_t>(table_t, idx, out, (int)rows, width, n, s);
}

// The Python entry points: module clid_gather, one METH_FASTCALL function a
// kernel taking the entry's arguments as Python ints (pointers and the
// stream as their addresses) and returning its cudaError_t. A call costs the
// host less than the same call through ctypes (PERF.md section 6).
template <int N, typename Entry>
PyObject* call_with_ints(PyObject* const* args, Py_ssize_t nargs, Entry entry) {
    if (nargs != N) {
        PyErr_Format(PyExc_TypeError, "expected %d int arguments, got %zd", N, nargs);
        return nullptr;
    }
    long long a[N];
    for (int i = 0; i < N; ++i) a[i] = PyLong_AsLongLong(args[i]);
    if (PyErr_Occurred()) return nullptr;
    return PyLong_FromLong(entry(a));
}

inline void* ptr(long long v) { return (void*)(intptr_t)v; }

PyObject* py_gather_rows(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
    return call_with_ints<8>(args, nargs, [](const long long* a) {
        return clid_gather_rows(ptr(a[0]), ptr(a[1]), ptr(a[2]), a[3], (int)a[4], (int)a[5],
                                (int)a[6], ptr(a[7]));
    });
}

PyObject* py_gather_lanes(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
    return call_with_ints<9>(args, nargs, [](const long long* a) {
        return clid_gather_lanes(ptr(a[0]), ptr(a[1]), ptr(a[2]), a[3], (int)a[4], (int)a[5],
                                 a[6], (int)a[7], ptr(a[8]));
    });
}

PyObject* py_gather_cols(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
    return call_with_ints<8>(args, nargs, [](const long long* a) {
        return clid_gather_cols(ptr(a[0]), ptr(a[1]), ptr(a[2]), a[3], a[4], a[5], (int)a[6],
                                ptr(a[7]));
    });
}

PyMethodDef methods[] = {
    {"gather_rows", (PyCFunction)(void (*)(void))py_gather_rows, METH_FASTCALL, nullptr},
    {"gather_lanes", (PyCFunction)(void (*)(void))py_gather_lanes, METH_FASTCALL, nullptr},
    {"gather_cols", (PyCFunction)(void (*)(void))py_gather_cols, METH_FASTCALL, nullptr},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef gather_module = {PyModuleDef_HEAD_INIT, "clid_gather", nullptr, -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_clid_gather(void) { return PyModule_Create(&gather_module); }
