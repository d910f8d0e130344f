// Fused per-frame mapping Adam loop for Hopper (sm_90a).
//
// Replaces clid_slam_tpu/ops/pallas_mapping.py:make_pallas_map_loop (the
// Pallas TPU kernel that the tracked-frame mapping body calls at
// clid_slam_tpu/mapping/mapper.py:1084).
//
// What one call computes: n_iters Adam steps (n_iters is a device scalar,
// at most max_iters) over two parameter sets,
//   * the expanded kNN features f [bs, K, 8] of one replay batch, and
//   * the SDF MLP (D -> H -> [H ->] 1, ReLU, D = 8 + P),
// on the loss  sdf_bce + weight_e * eikonal, where
//   pred      = MLP([sum_k w0[b,k] LN?(f[b,k]), encw0[b]]) * sdf_scale,
//   sdf_bce   = sum_b wsel[b] * BCE(pred/sigma, label_op[b]) * denom_inv,
//   eikonal   = sum_j vd[j] (|g_j| - 1)^2 * eik_den_inv, with g_j the central
//               difference of 6 tap predictions of sample b = j*dec_step that
//               reuse its features with the cached tap weights wtap[t, j, :]
//               and tap encodings enctapw[t, j, :];
// Adam: betas 0.9/0.99, eps adam_eps, bias correction with t = it + 1;
// features at lr, MLP at mlp_lr (scal[1]).
//
// What bounds it on the H100: by the work, operations: 1.24 GFLOP of plain
// f32 for one call at the bench shapes (bs 16384, K 6, P 3, H 64, 10 steps),
// 18.5 us at 67 TFLOP/s against 2.2 us for its bytes. In practice, latency:
// one block of 8 warps per SM walks each tile phase as a chain of
// shared-memory loads behind a __syncthreads, and every step pays two grid
// syncs and a cross-block reduction. No tensor cores: the reference runs
// every product at full f32 (TF32 loses the tracker,
// clid_slam_torch/device.py), and 3xTF32 would buy little, since the
// products are a small part of a step and the grid syncs and reduction alone
// cost more than the bound.
//
// Rounding: products and sums are plain f32 (fmaf), the loss and the
// eikonal term use IEEE division, sqrtf, expf and log1pf as the reference
// does. Approximate operations, each a few ulp at most: Adam's step
// (adam_step: reciprocal bias corrections, __fdividef and a square root
// through rsqrtf, for the speed of the feature update, which runs on
// every feature element each step), and layer norm's rsqrtf, as PyTorch's
// rsqrt on CUDA.
//
// Design: one persistent cooperative launch per call. It replaced a launch
// pair per step with one warp per sample, the state in device memory and
// each tap sample's 12 extra MLP passes on a single warp, which left the
// other warps of its block idle (6.3x slower at the bench shapes).
//   * As many blocks as fit on the card at once (one per SM at the bench
//     shapes). Block c owns samples [c*spc, (c+1)*spc) and the taps of those
//     samples (tap j belongs to sample j*dec_step). It copies that slab
//     (features, weights, encodings, targets, taps) into shared memory once;
//     the features and both Adam moments stay there for all steps and only
//     the features are written back, at the end. When the slab does not fit
//     (large bs), the RES=false instantiation keeps it in device memory and
//     works on it there; the code is the same, only the pointers differ.
//     The copy is plain coalesced loads, not cp.async.bulk: the slab's
//     ranges start at s0*K or s0*P floats, not on 16-byte boundaries, and
//     the copy happens once per call.
//   * The MLP runs on rows, not on warps: a step has spc sample rows plus 6
//     rows per owned tap. They go through tiles of 128 rows (64 with two
//     hidden layers); a tap tile holds 21 (10) whole taps, so a tap's
//     eikonal term stays inside its tile. Each product is register-tiled
//     f32 (a thread owns a few rows x 4 hidden units, operands are
//     shared-memory broadcasts or float4 rows); the pre-activations stay in
//     registers or shared memory from forward to backward, so no row is
//     evaluated twice.
//   * The MLP gradient of each block is summed in registers in a fixed
//     order, written as one partial row, then grid sync; block c owns a
//     column slice, sums it over the partial rows in a fixed order and
//     applies Adam to it (its Adam state stays in its shared memory); grid
//     sync; every block reloads the MLP. No float atomics: the result
//     repeats bit for bit.
//   * n_iters is read on the device, so there is no host sync and no idle
//     launch when n_iters < max_iters.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kFeat = 8;    // feature_dim: the mapper runs this kernel at 8
constexpr int kMaxK = 8;    // neighbours per sample
constexpr int kMaxD = 16;   // MLP input width 8 + P
constexpr int kNT = 256;    // threads per block
// rows per tile: 128 with one hidden layer, 64 with two (their buffers
// would not fit beside the slab); a tap tile holds TR/6 whole taps
__host__ __device__ constexpr int tile_rows(int nh) { return nh == 1 ? 128 : 64; }
constexpr int kXS = kMaxD + 4;    // row stride of the input tile (float4 rows)
constexpr int kRed = 4096;        // reduction buffer: W1's gradient by row group
constexpr float kLnEps = 1e-5f;
constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.99f;
constexpr float kC1 = 0.1f;   // 1 - beta1, rounded once as the reference does
constexpr float kC2 = 0.01f;  // 1 - beta2

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// taps a block of spc samples can own: its samples hold at most
// ceil(spc / dec_step) multiples of dec_step
__host__ __device__ inline int tap_cap(int spc, int dec_step, int bd) {
  const int n = cdiv(spc, dec_step);
  return n < bd ? n : bd;
}

// Shared-memory (and, for RES=false, per-block scratch) layout in floats.
// Every region starts on a 16-byte boundary.
struct Layout {
  // always in shared memory
  int W1, b1, W2, W2T, b2, wo, X, B1, B2, pred, dpred, red, cst, fixed;
  // the block's slab: shared memory when resident, else device memory
  int f, m, v, w0, enc, lbl, wsel, wtap, etap, vd, slab;
  // per-step work arrays: after the slab when resident, else block scratch
  int ln, dfw, work;
  int smem_floats;
};

// MLP parameters (the kernel's flat layout, ops/map_loop.py:flatten_mlp)
__host__ __device__ inline int mlp_params(int P, int H, int nh) {
  return (kFeat + P) * H + H + (nh == 2 ? H * H + H : 0) + H + 1;
}

__host__ __device__ inline Layout make_layout(int K, int P, int H, int nh, bool ln, int spc,
                                              int ntap, int cpb, bool resident) {
  Layout L;
  const int HS = H + 4;
  int o = 0;
  auto take = [&o](int n) { const int at = o; o += round4(n); return at; };
  L.W1 = take(kMaxD * HS);
  L.b1 = take(H);
  L.W2 = take(nh == 2 ? H * HS : 0);
  L.W2T = take(nh == 2 ? H * HS : 0);
  L.b2 = take(nh == 2 ? H : 0);
  L.wo = take(H + 1);  // w_out, then b_out
  const int TR = tile_rows(nh);
  L.X = take(TR * kXS);
  L.B1 = take(nh == 2 ? TR * HS : 0);
  L.B2 = take(TR * HS);
  L.pred = take(TR);
  L.dpred = take(TR);
  L.red = take(kRed);
  L.cst = take(3 * cpb);  // Adam state and value of the MLP columns this block owns
  L.fixed = o;
  o = resident ? o : 0;
  const int nf = spc * K * kFeat;
  L.f = take(nf);
  L.m = take(nf);
  L.v = take(nf);
  L.w0 = take(spc * K);
  L.enc = take(spc * P);
  L.lbl = take(spc);
  L.wsel = take(spc);
  L.wtap = take(6 * ntap * K);
  L.etap = take(6 * ntap * P);
  L.vd = take(ntap);
  L.slab = o - (resident ? L.fixed : 0);
  if (!resident) o = 0;
  L.ln = take(ln ? spc * K * 2 : 0);
  L.dfw = take((spc + 6 * ntap) * kFeat);
  L.work = o - (resident ? L.fixed + L.slab : 0);
  L.smem_floats = resident ? L.fixed + L.slab + L.work : L.fixed;
  return L;
}

struct Params {
  const float* f_in;
  float* f_out;
  float* m;
  float* v;
  const float* w0;
  const float* encw0;
  const float* label_op;
  const float* wsel;
  const float* wtap;
  const float* enctapw;
  const float* vd;
  float* mlp;
  float* partials;  // [grid][npg]
  float* scratch;   // [grid][work] when the slab streams
  float* losses;
  const float* scal;  // [n_iters, mlp_lr, denom_inv, eik_den_inv]
  int bs, K, P, D, Dp, H, bd, dec_step, max_iters, spc, ntap, cpb;
  int off_b1, off_w2, off_b2, off_wo, off_bo, n_params, npg;
  float sdf_scale, sigma, lr, adam_eps, weight_e, inv2eps;
  Layout L;
};

// The block's slab and work arrays, wherever they live. Sample s is local
// (0 .. ns), tap lt local (0 .. nt); the tap arrays are [6][tstr][K|P].
struct Slab {
  float* f;
  float* m;
  float* v;
  const float* w0;
  const float* enc;
  const float* lbl;
  const float* wsel;
  const float* wtap;
  const float* etap;
  const float* vd;
  float* ln;
  float* dfw;
  int tstr;
};

// Thread layout of a [rows x H] product: a thread owns RPT rows x 4 hidden
// units; TX threads of one warp share a row group.
template <int H, int TR>
struct Tile {
  static constexpr int HS = H + 4;       // row stride of H-wide buffers
  static constexpr int TX = H / 4;       // threads across the hidden units
  static constexpr int TY = kNT / TX;    // row groups
  static constexpr int RPT = TR / TY;    // rows per thread
  static constexpr int TAPS = TR / 6;    // whole taps in a tap tile
  static constexpr int CPT = kFeat * TR / kNT;  // d(fw) columns per thread
  static constexpr int IPT = H * H / (4 * kNT);  // W2 gradient rows per thread
  static constexpr int GR = kNT / (H / 4 * 4);   // row groups of W1's gradient
};

// acc[i][c] = bias[4tx+c] + sum_k In[r_i][k] W[k][4tx+c], r_i = ty*RPT + i;
// In relu'd on the fly when RELU. depth and in_stride are multiples of 4.
// Rows at or past rv keep the bias.
template <int H, int TR, bool RELU>
__device__ __forceinline__ void dense_rows(const float* In, int in_stride, int depth,
                                           const float* W, const float* bias,
                                           float (&acc)[Tile<H, TR>::RPT][4], int tx, int ty,
                                           int rv) {
  using T = Tile<H, TR>;
  const float4 b = *reinterpret_cast<const float4*>(bias + 4 * tx);
#pragma unroll
  for (int i = 0; i < T::RPT; ++i) {
    acc[i][0] = b.x;
    acc[i][1] = b.y;
    acc[i][2] = b.z;
    acc[i][3] = b.w;
  }
  if (ty * T::RPT >= rv) return;
  const float* in = In + ty * T::RPT * in_stride;
#pragma unroll 2
  for (int k = 0; k < depth; k += 4) {
    float4 w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = *reinterpret_cast<const float4*>(W + (k + u) * T::HS + 4 * tx);
#pragma unroll
    for (int i = 0; i < T::RPT; ++i) {
      const float4 a4 = *reinterpret_cast<const float4*>(in + i * in_stride + k);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float a = RELU ? fmaxf(av[u], 0.f) : av[u];
        acc[i][0] = fmaf(a, w[u].x, acc[i][0]);
        acc[i][1] = fmaf(a, w[u].y, acc[i][1]);
        acc[i][2] = fmaf(a, w[u].z, acc[i][2]);
        acc[i][3] = fmaf(a, w[u].w, acc[i][3]);
      }
    }
  }
}

// Adam's bias-corrected step m^ / (sqrt(v^) + eps), with the corrections
// as reciprocals and an approximate square root and quotient (a few ulp),
// cheaper than IEEE division and sqrtf on every feature element
__device__ __forceinline__ float adam_step(float m, float v, float ibc1, float ibc2, float eps) {
  const float vh = v * ibc2;
  return __fdividef(m * ibc1, (vh > 0.f ? vh * rsqrtf(vh) : 0.f) + eps);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// One row of a tile: which sample it reads, its IDW weights and encoding,
// and where its d(loss)/d(weighted features) goes.
struct Row {
  int s;  // local sample, -1 for an empty row
  int out;
  const float* w;
  const float* e;
};

struct BlockRange {
  int s0, ns, j0, nt, ntt, nst;
};

template <int TR>
__device__ __forceinline__ Row row_of(const Params& p, const Slab& S, const BlockRange& br,
                                      int q, int r) {
  constexpr int TAPS = TR / 6;
  Row row{-1, 0, nullptr, nullptr};
  if (q < br.ntt) {  // tap tile: TAPS whole taps, 6 rows each
    const int lt = q * TAPS + r / 6, t = r % 6;
    if (r < 6 * TAPS && lt < br.nt) {
      row.s = (br.j0 + lt) * p.dec_step - br.s0;
      row.out = p.spc + 6 * lt + t;
      row.w = S.wtap + (t * S.tstr + lt) * p.K;
      row.e = S.etap + (t * S.tstr + lt) * p.P;
    }
  } else {
    const int s = (q - br.ntt) * TR + r;
    if (s < br.ns) {
      row.s = s;
      row.out = s;
      row.w = S.w0 + s * p.K;
      row.e = S.enc + s * p.P;
    }
  }
  return row;
}

// rows of tile q that hold data
template <int TR>
__device__ __forceinline__ int rows_in(const BlockRange& br, int q) {
  if (q < br.ntt) return 6 * min(TR / 6, br.nt - q * (TR / 6));
  return min(TR, br.ns - (q - br.ntt) * TR);
}

// the MLP from device memory into shared memory (W2 also transposed);
// __ldcg: other blocks wrote it during this launch
template <int NH, int H>
__device__ void load_mlp(const Params& p, float* sm) {
  constexpr int HS = H + 4;
  const Layout& L = p.L;
#pragma unroll 4
  for (int e = threadIdx.x; e < p.D * H; e += kNT)
    sm[L.W1 + (e / H) * HS + e % H] = __ldcg(p.mlp + e);
  for (int e = threadIdx.x; e < H; e += kNT) {
    sm[L.b1 + e] = __ldcg(p.mlp + p.off_b1 + e);
    sm[L.wo + e] = __ldcg(p.mlp + p.off_wo + e);
    if (NH == 2) sm[L.b2 + e] = __ldcg(p.mlp + p.off_b2 + e);
  }
  if (threadIdx.x == 0) sm[L.wo + H] = __ldcg(p.mlp + p.off_bo);
  if (NH == 2) {
#pragma unroll 4
    for (int e = threadIdx.x; e < H * H; e += kNT) {
      const float w = __ldcg(p.mlp + p.off_w2 + e);
      const int i = e / H, j = e % H;
      sm[L.W2 + i * HS + j] = w;
      sm[L.W2T + j * HS + i] = w;
    }
  }
}

// dst[j] = sum over the row groups ty (in order) of v held by thread (ty, j/4)
template <int H, int TR>
__device__ __forceinline__ void sum_row_groups(float* red, const float (&v)[4], float* dst,
                                               int tid, int tx, int ty) {
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 4; ++c) red[ty * H + 4 * tx + c] = v[c];
  __syncthreads();
  if (tid < H) {
    float s = 0.f;
    for (int y = 0; y < Tile<H, TR>::TY; ++y) s += red[y * H + tid];
    dst[tid] = s;
  }
}

// one block per SM may take up to 255 registers a thread: capped at 128
// (two blocks per SM), the 128-row tiles and the two-layer backward spill
template <int NH, int H, bool LN, bool RES>
__global__ void __launch_bounds__(kNT, 1) map_loop_kernel(Params p) {
  constexpr int TR = tile_rows(NH);
  using T = Tile<H, TR>;
  constexpr int HS = T::HS, RPT = T::RPT, IPT = T::IPT, GR = T::GR;
  extern __shared__ __align__(16) float sm[];
  cg::grid_group grid = cg::this_grid();
  const Layout& L = p.L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % T::TX, ty = tid / T::TX;
  const int K = p.K, P = p.P, D = p.D, spc = p.spc, dec = p.dec_step;
  const int n_it = min(static_cast<int>(__ldg(p.scal)), p.max_iters);

  BlockRange br;
  br.s0 = blockIdx.x * spc;
  br.ns = max(0, min(spc, p.bs - br.s0));
  br.j0 = cdiv(br.s0, dec);
  br.nt = max(0, min(p.bd, cdiv(br.s0 + br.ns, dec)) - br.j0);
  br.ntt = cdiv(br.nt, T::TAPS);
  br.nst = cdiv(br.ns, TR);
  const int nf = br.ns * K * kFeat;

  // the block's slab, copied in once (RES) or worked on in place
  Slab S;
  if (RES) {
    S = Slab{sm + L.f, sm + L.m, sm + L.v, sm + L.w0, sm + L.enc, sm + L.lbl, sm + L.wsel,
             sm + L.wtap, sm + L.etap, sm + L.vd, sm + L.ln, sm + L.dfw, p.ntap};
    const float* fin = p.f_in + br.s0 * K * kFeat;
    for (int e = tid; e < nf / 4; e += kNT) {
      reinterpret_cast<float4*>(S.f)[e] = __ldg(reinterpret_cast<const float4*>(fin) + e);
      reinterpret_cast<float4*>(S.m)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(S.v)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int e = tid; e < br.ns * K; e += kNT) sm[L.w0 + e] = __ldg(p.w0 + br.s0 * K + e);
    for (int e = tid; e < br.ns * P; e += kNT) sm[L.enc + e] = __ldg(p.encw0 + br.s0 * P + e);
    for (int e = tid; e < br.ns; e += kNT) {
      sm[L.lbl + e] = __ldg(p.label_op + br.s0 + e);
      sm[L.wsel + e] = __ldg(p.wsel + br.s0 + e);
    }
    for (int e = tid; e < 6 * br.nt * K; e += kNT) {
      const int t = e / (br.nt * K), r = e % (br.nt * K);
      sm[L.wtap + t * p.ntap * K + r] = __ldg(p.wtap + (t * p.bd + br.j0) * K + r);
    }
    for (int e = tid; e < 6 * br.nt * P; e += kNT) {
      const int t = e / (br.nt * P), r = e % (br.nt * P);
      sm[L.etap + t * p.ntap * P + r] = __ldg(p.enctapw + (t * p.bd + br.j0) * P + r);
    }
    for (int e = tid; e < br.nt; e += kNT) sm[L.vd + e] = __ldg(p.vd + br.j0 + e);
  } else {
    float* work = p.scratch + static_cast<long long>(blockIdx.x) * L.work;
    const long long fo = static_cast<long long>(br.s0) * K * kFeat;
    S = Slab{p.f_out + fo, p.m + fo, p.v + fo, p.w0 + br.s0 * K, p.encw0 + br.s0 * P,
             p.label_op + br.s0, p.wsel + br.s0, p.wtap + br.j0 * K, p.enctapw + br.j0 * P,
             p.vd + br.j0, work + L.ln, work + L.dfw, p.bd};
    for (int e = tid; e < nf / 4; e += kNT) {
      reinterpret_cast<float4*>(S.f)[e] = __ldg(reinterpret_cast<const float4*>(p.f_in + fo) + e);
      reinterpret_cast<float4*>(S.m)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(S.v)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  load_mlp<NH, H>(p, sm);
  // W1's rows past D up to the float4 depth stay zero
  for (int e = tid; e < (p.Dp - D) * HS; e += kNT) sm[L.W1 + D * HS + e] = 0.f;
  // the MLP columns this block owns: Adam state and current value
  const int col0 = blockIdx.x * p.cpb;
  float* cst = sm + L.cst;
  for (int c = tid; c < p.cpb; c += kNT) {
    cst[c] = 0.f;
    cst[p.cpb + c] = 0.f;
    cst[2 * p.cpb + c] = col0 + c < p.n_params ? __ldg(p.mlp + col0 + c) : 0.f;
  }
  __syncthreads();

  float* X = sm + L.X;
  float* B1 = sm + L.B1;
  float* B2 = sm + L.B2;
  float* DH = NH == 2 ? B1 : B2;  // d(loss)/d(first pre-activation)
  const float* W1 = sm + L.W1;
  const float* wo = sm + L.wo;
  float* pred = sm + L.pred;
  float* dpred = sm + L.dpred;
  float* red = sm + L.red;
  const int n_tiles = br.ntt + br.nst;

  // the MLP gradient this thread owns (fixed summation order: tile by
  // tile, row by row)
  float gW1[4][4];
  float gW2[IPT][4];
  float gwo[4] = {0.f, 0.f, 0.f, 0.f}, gbl[4] = {0.f, 0.f, 0.f, 0.f};
  float gb1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int a = 0; a < IPT; ++a) gW2[a][0] = gW2[a][1] = gW2[a][2] = gW2[a][3] = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) gW1[a][0] = gW1[a][1] = gW1[a][2] = gW1[a][3] = 0.f;
  float gbo = 0.f, loss_sdf = 0.f, loss_eik = 0.f;

  for (int it = 0; it < n_it; ++it) {
    // Adam's bias corrections of this step, as reciprocals
    const float tstep = static_cast<float>(it + 1);
    const float ibc1 = 1.f / (1.f - powf(kB1, tstep)), ibc2 = 1.f / (1.f - powf(kB2, tstep));
    if (LN) {
      for (int q = tid; q < br.ns * K; q += kNT) {
        const float4 a = ld4(S.f + q * kFeat), b = ld4(S.f + q * kFeat + 4);
        const float mu = (a.x + a.y + a.z + a.w + b.x + b.y + b.z + b.w) * (1.f / kFeat);
        const float d[8] = {a.x - mu, a.y - mu, a.z - mu, a.w - mu,
                            b.x - mu, b.y - mu, b.z - mu, b.w - mu};
        float var = 0.f;
#pragma unroll
        for (int c = 0; c < kFeat; ++c) var = fmaf(d[c], d[c], var);
        S.ln[2 * q] = mu;
        S.ln[2 * q + 1] = rsqrtf(var * (1.f / kFeat) + kLnEps);
      }
      __syncthreads();
    }

    for (int q = 0; q < n_tiles; ++q) {
      const int rv = rows_in<TR>(br, q);
      // input tile X = [sum_k w_k LN?(f_k), enc, 0 up to Dp], rows past rv zero
      for (int e = tid; e < TR * kFeat; e += kNT) {
        const int r = e >> 3, c = e & 7;
        float val = 0.f;
        if (r < rv) {
          const Row row = row_of<TR>(p, S, br, q, r);
          const float* fr = S.f + row.s * K * kFeat + c;
          float w[kMaxK], y[kMaxK];
#pragma unroll
          for (int k = 0; k < kMaxK; ++k) {
            w[k] = k < K ? row.w[k] : 0.f;
            y[k] = k < K ? fr[k * kFeat] : 0.f;
            if (LN && k < K) {
              const float2 st = *reinterpret_cast<const float2*>(S.ln + 2 * (row.s * K + k));
              y[k] = (y[k] - st.x) * st.y;
            }
          }
#pragma unroll
          for (int k = 0; k < kMaxK; ++k) val = fmaf(w[k], y[k], val);
        }
        X[r * kXS + c] = val;
      }
      for (int e = tid; e < TR * (p.Dp - kFeat); e += kNT) {
        const int r = e / (p.Dp - kFeat), c = e % (p.Dp - kFeat);
        X[r * kXS + kFeat + c] = r < rv && c < P ? row_of<TR>(p, S, br, q, r).e[c] : 0.f;
      }
      __syncthreads();

      // forward
      float acc[RPT][4];
      dense_rows<H, TR, false>(X, kXS, p.Dp, W1, sm + L.b1, acc, tx, ty, rv);
      if (NH == 2) {
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          st4(B1 + (ty * RPT + i) * HS + 4 * tx, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        __syncthreads();
        dense_rows<H, TR, true>(B1, HS, H, sm + L.W2, sm + L.b2, acc, tx, ty, rv);
      }
      {
        const float4 w = ld4(wo + 4 * tx);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          float o = fmaxf(acc[i][0], 0.f) * w.x;
          o = fmaf(fmaxf(acc[i][1], 0.f), w.y, o);
          o = fmaf(fmaxf(acc[i][2], 0.f), w.z, o);
          o = fmaf(fmaxf(acc[i][3], 0.f), w.w, o);
#pragma unroll
          for (int off = T::TX / 2; off > 0; off >>= 1) o += __shfl_xor_sync(0xffffffffu, o, off);
          if (tx == 0) pred[ty * RPT + i] = o + wo[H];
        }
      }
      __syncthreads();

      // loss and d(loss)/d(unscaled prediction) of each row
      if (q < br.ntt) {
        const int nq = rv / 6;
        if (tid < nq) {
          const int lt = q * T::TAPS + tid;
          float tp[6];
#pragma unroll
          // rounded products, never fused into the differences below: equal
          // tap predictions must give exactly g = 0, where the eikonal
          // gradient g/|g| is singular
          for (int t = 0; t < 6; ++t) tp[t] = __fmul_rn(pred[6 * tid + t], p.sdf_scale);
          const float gx = (tp[0] - tp[3]) * p.inv2eps;
          const float gy = (tp[1] - tp[4]) * p.inv2eps;
          const float gz = (tp[2] - tp[5]) * p.inv2eps;
          const float gn = sqrtf(gx * gx + gy * gy + gz * gz + 1e-20f);
          const float r = gn - 1.f;
          const float vdj = S.vd[lt];
          loss_eik += r * r * vdj;
          const float dgn = 2.f * r * vdj * __ldg(p.scal + 3) * p.weight_e;
          const float ign = dgn / gn;
          const float dg[3] = {ign * gx, ign * gy, ign * gz};
#pragma unroll
          for (int t = 0; t < 6; ++t) {
            const float sgn = t < 3 ? p.inv2eps : -p.inv2eps;
            const float d = dg[t % 3] * sgn * p.sdf_scale;
            dpred[6 * tid + t] = d;
            gbo += d;
          }
        }
        if (tid >= rv && tid < TR) dpred[tid] = 0.f;
      } else if (tid < TR) {
        float d = 0.f;
        if (tid < rv) {
          const int s = (q - br.ntt) * TR + tid;
          const float z = pred[tid] * p.sdf_scale / p.sigma;
          const float lbl = S.lbl[s], ws = S.wsel[s];
          const float sg = 1.f / (1.f + expf(-z));
          loss_sdf += ws * (fmaxf(z, 0.f) - z * lbl + log1pf(expf(-fabsf(z))));
          d = ws * (sg - lbl) * (__ldg(p.scal + 2) / p.sigma) * p.sdf_scale;
          gbo += d;
        }
        dpred[tid] = d;
      }
      __syncthreads();

      // backward through the output layer: B2 = d(last pre-activation)
      {
        const float4 w = ld4(wo + 4 * tx);
        const float wc[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = ty * RPT + i;
          const float d = dpred[r];
          float dh[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            gwo[c] = fmaf(fmaxf(acc[i][c], 0.f), d, gwo[c]);
            dh[c] = acc[i][c] > 0.f ? d * wc[c] : 0.f;
            gbl[c] += dh[c];
          }
          st4(B2 + r * HS + 4 * tx, dh[0], dh[1], dh[2], dh[3]);
        }
      }
      __syncthreads();

      if (NH == 2) {
        // W2's gradient: h1^T dH2 over the tile's rows
        {
          const int i0 = (tid / T::TX) * IPT;
          for (int r = 0; r < rv; ++r) {
            const float4 d2 = ld4(B2 + r * HS + 4 * tx);
            float hv[IPT];
            if (IPT == 4) {
              const float4 h4 = ld4(B1 + r * HS + i0);
              hv[0] = h4.x;
              hv[IPT > 1 ? 1 : 0] = h4.y;
              hv[IPT > 2 ? 2 : 0] = h4.z;
              hv[IPT > 3 ? 3 : 0] = h4.w;
            } else {
              hv[0] = B1[r * HS + i0];
            }
#pragma unroll
            for (int a = 0; a < IPT; ++a) {
              const float h = fmaxf(hv[a], 0.f);
              gW2[a][0] = fmaf(h, d2.x, gW2[a][0]);
              gW2[a][1] = fmaf(h, d2.y, gW2[a][1]);
              gW2[a][2] = fmaf(h, d2.z, gW2[a][2]);
              gW2[a][3] = fmaf(h, d2.w, gW2[a][3]);
            }
          }
        }
        // dH1 = relu'(pre1) (dH2 W2^T), into B1 once every thread has read it
        float g[RPT][4];
#pragma unroll
        for (int i = 0; i < RPT; ++i) g[i][0] = g[i][1] = g[i][2] = g[i][3] = 0.f;
        if (ty * RPT < rv) {
          const float* W2T = sm + L.W2T;
#pragma unroll 2
          for (int j = 0; j < H; j += 4) {
            float4 w[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) w[u] = ld4(W2T + (j + u) * HS + 4 * tx);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const float4 a4 = ld4(B2 + (ty * RPT + i) * HS + j);
              const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                g[i][0] = fmaf(av[u], w[u].x, g[i][0]);
                g[i][1] = fmaf(av[u], w[u].y, g[i][1]);
                g[i][2] = fmaf(av[u], w[u].z, g[i][2]);
                g[i][3] = fmaf(av[u], w[u].w, g[i][3]);
              }
            }
          }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          float* b = B1 + (ty * RPT + i) * HS + 4 * tx;
          const float4 pre = ld4(b);
          const float pc[4] = {pre.x, pre.y, pre.z, pre.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            g[i][c] = pc[c] > 0.f ? g[i][c] : 0.f;
            gb1[c] += g[i][c];
          }
          st4(b, g[i][0], g[i][1], g[i][2], g[i][3]);
        }
        __syncthreads();
      }

      // W1's gradient (X^T dH1) and d(loss)/d(weighted features) (dH1 W1[:8]^T)
      {
        // thread (gr, gd, tx) owns W1[4gd..4gd+3][4tx..4tx+3] over rows gr, gr+GR, ...
        const int gd = (tid / T::TX) & 3, gr = tid / (4 * T::TX);
        if (4 * gd < D) {
          for (int r = gr; r < rv; r += GR) {
            const float4 x4 = ld4(X + r * kXS + 4 * gd);
            const float4 g = ld4(DH + r * HS + 4 * tx);
            const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              gW1[a][0] = fmaf(xv[a], g.x, gW1[a][0]);
              gW1[a][1] = fmaf(xv[a], g.y, gW1[a][1]);
              gW1[a][2] = fmaf(xv[a], g.z, gW1[a][2]);
              gW1[a][3] = fmaf(xv[a], g.w, gW1[a][3]);
            }
          }
        }
        constexpr int CPT = T::CPT;
        const int r = tid / (kFeat / CPT), c0 = CPT * (tid % (kFeat / CPT));
        if (r < rv) {
          float sc[CPT];
#pragma unroll
          for (int u = 0; u < CPT; ++u) sc[u] = 0.f;
#pragma unroll 4
          for (int j = 0; j < H; j += 4) {
            const float4 g = ld4(DH + r * HS + j);
#pragma unroll
            for (int u = 0; u < CPT; ++u) {
              const float4 a = ld4(W1 + (c0 + u) * HS + j);
              sc[u] = fmaf(g.x, a.x, fmaf(g.y, a.y, fmaf(g.z, a.z, fmaf(g.w, a.w, sc[u]))));
            }
          }
          float* out = S.dfw + row_of<TR>(p, S, br, q, r).out * kFeat + c0;
#pragma unroll
          for (int u = 0; u < CPT; ++u) out[u] = sc[u];
        }
      }
      __syncthreads();
    }

    // features: gradient of each (sample, neighbour) row from its own row
    // and its taps' rows, then Adam in place
    {
      for (int q = tid; q < br.ns * K; q += kNT) {
        const int s = q / K, k = q % K;
        float* fp = S.f + q * kFeat;
        const float4 fa = ld4(fp), fb = ld4(fp + 4);
        const float f[8] = {fa.x, fa.y, fa.z, fa.w, fb.x, fb.y, fb.z, fb.w};
        const float a = S.w0[s * K + k];
        const float* ds = S.dfw + s * kFeat;
        float dy[8];
#pragma unroll
        for (int c = 0; c < kFeat; ++c) dy[c] = a * ds[c];
        const int b = br.s0 + s;
        if (b % dec == 0 && b / dec < p.bd) {
          const int lt = b / dec - br.j0;
#pragma unroll
          for (int t6 = 0; t6 < 6; ++t6) {
            const float wt = S.wtap[(t6 * S.tstr + lt) * K + k];
            const float* dt = S.dfw + (spc + 6 * lt + t6) * kFeat;
#pragma unroll
            for (int c = 0; c < kFeat; ++c) dy[c] = fmaf(wt, dt[c], dy[c]);
          }
        }
        float g[8];
        if (LN) {
          const float mu = S.ln[2 * q], inv = S.ln[2 * q + 1];
          float xh[8], m0 = 0.f, mx = 0.f;
#pragma unroll
          for (int c = 0; c < kFeat; ++c) {
            xh[c] = (f[c] - mu) * inv;
            m0 += dy[c];
            mx = fmaf(dy[c], xh[c], mx);
          }
          m0 *= 1.f / kFeat;
          mx *= 1.f / kFeat;
#pragma unroll
          for (int c = 0; c < kFeat; ++c) g[c] = inv * (dy[c] - m0 - xh[c] * mx);
        } else {
#pragma unroll
          for (int c = 0; c < kFeat; ++c) g[c] = dy[c];
        }
        float* mp = S.m + q * kFeat;
        float* vp = S.v + q * kFeat;
        const float4 ma = ld4(mp), mb = ld4(mp + 4), va = ld4(vp), vb = ld4(vp + 4);
        const float mo[8] = {ma.x, ma.y, ma.z, ma.w, mb.x, mb.y, mb.z, mb.w};
        const float vo[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
        float mn[8], vn[8], fn[8];
#pragma unroll
        for (int c = 0; c < kFeat; ++c) {
          mn[c] = kB1 * mo[c] + kC1 * g[c];
          vn[c] = kB2 * vo[c] + kC2 * g[c] * g[c];
          fn[c] = f[c] - p.lr * adam_step(mn[c], vn[c], ibc1, ibc2, p.adam_eps);
        }
        st4(mp, mn[0], mn[1], mn[2], mn[3]);
        st4(mp + 4, mn[4], mn[5], mn[6], mn[7]);
        st4(vp, vn[0], vn[1], vn[2], vn[3]);
        st4(vp + 4, vn[4], vn[5], vn[6], vn[7]);
        st4(fp, fn[0], fn[1], fn[2], fn[3]);
        st4(fp + 4, fn[4], fn[5], fn[6], fn[7]);
      }
    }

    // this block's partial row of the MLP gradient and the two losses
    {
      float* prow = p.partials + static_cast<long long>(blockIdx.x) * p.npg;
      // W1's gradient: the GR row groups summed in order
      {
        const int gd = (tid / T::TX) & 3, gr = tid / (4 * T::TX);
        __syncthreads();
#pragma unroll
        for (int a = 0; a < 4; ++a)
          st4(red + (gr * kMaxD + 4 * gd + a) * H + 4 * tx, gW1[a][0], gW1[a][1], gW1[a][2],
              gW1[a][3]);
        __syncthreads();
        for (int e = tid; e < D * H; e += kNT) {
          float s = 0.f;
#pragma unroll
          for (int g = 0; g < GR; ++g) s += red[g * kMaxD * H + e];
          prow[e] = s;
        }
      }
      if (NH == 2) {
        const int i0 = (tid / T::TX) * IPT;
#pragma unroll
        for (int a = 0; a < IPT; ++a) {
#pragma unroll
          for (int c = 0; c < 4; ++c) prow[p.off_w2 + (i0 + a) * H + 4 * tx + c] = gW2[a][c];
        }
      }
      // per-hidden-unit sums held by every row group, summed in ty order
      sum_row_groups<H, TR>(red, gwo, prow + p.off_wo, tid, tx, ty);
      sum_row_groups<H, TR>(red, gbl, prow + (NH == 2 ? p.off_b2 : p.off_b1), tid, tx, ty);
      if (NH == 2) sum_row_groups<H, TR>(red, gb1, prow + p.off_b1, tid, tx, ty);
      // b_out's gradient and the losses: a fixed shuffle tree in each warp,
      // then the warps in order
      float sc[3] = {gbo, loss_sdf, loss_eik};
#pragma unroll
      for (int u = 0; u < 3; ++u) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], off);
      }
      __syncthreads();
      if (lane == 0) {
        red[warp] = sc[0];
        red[kNT / 32 + warp] = sc[1];
        red[2 * kNT / 32 + warp] = sc[2];
      }
      __syncthreads();
      if (tid < 3) {
        float s = 0.f;
        for (int w = 0; w < kNT / 32; ++w) s += red[tid * (kNT / 32) + w];
        prow[tid == 0 ? p.off_bo : p.n_params + tid - 1] = s;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        gwo[c] = gbl[c] = gb1[c] = 0.f;
        gW1[0][c] = gW1[1][c] = gW1[2][c] = gW1[3][c] = 0.f;
      }
#pragma unroll
      for (int a = 0; a < IPT; ++a) gW2[a][0] = gW2[a][1] = gW2[a][2] = gW2[a][3] = 0.f;
      gbo = loss_sdf = loss_eik = 0.f;
    }
    grid.sync();

    // block c owns MLP columns [c*cpb, (c+1)*cpb): it sums them over the
    // partial rows (chunks of blocks, then the chunks in order), applies
    // Adam and publishes the new values; the last step writes the losses
    for (int cb = 0; cb < p.cpb; cb += kNT) {
      const int ncol = min(kNT, p.cpb - cb), nch = kNT / ncol;
      const int G = gridDim.x;
      if (tid < nch * ncol) {
        const int col = col0 + cb + tid % ncol, ch = tid / ncol;
        float s = 0.f;
        if (col < p.npg) {
#pragma unroll 8
          for (int b = ch; b < G; b += nch)
            s += __ldcg(p.partials + static_cast<long long>(b) * p.npg + col);
        }
        red[tid] = s;
      }
      __syncthreads();
      const int c = cb + tid, col = col0 + c;
      if (tid < ncol && col < p.npg) {
        float s = 0.f;
        for (int ch = 0; ch < nch; ++ch) s += red[ch * ncol + tid];
        if (col < p.n_params) {
          const float mn = kB1 * cst[c] + kC1 * s;
          const float vn = kB2 * cst[p.cpb + c] + kC2 * s * s;
          cst[c] = mn;
          cst[p.cpb + c] = vn;
          const float w = cst[2 * p.cpb + c] -
                          __ldg(p.scal + 1) * adam_step(mn, vn, ibc1, ibc2, p.adam_eps);
          cst[2 * p.cpb + c] = w;
          p.mlp[col] = w;
        } else if (it == n_it - 1) {
          p.losses[col - p.n_params] = s * __ldg(p.scal + (col == p.n_params ? 2 : 3));
        }
      }
      __syncthreads();
    }
    if (it + 1 < n_it) {
      grid.sync();
      load_mlp<NH, H>(p, sm);
      __syncthreads();
    }
  }

  if (RES) {
    __syncthreads();
    float* fout = p.f_out + static_cast<long long>(br.s0) * K * kFeat;
    for (int e = tid; e < nf / 4; e += kNT)
      reinterpret_cast<float4*>(fout)[e] = reinterpret_cast<const float4*>(S.f)[e];
  }
}

using KernelFn = void (*)(Params);

template <int NH, int H, bool LN>
KernelFn pick_res(bool res) {
  return res ? &map_loop_kernel<NH, H, LN, true> : &map_loop_kernel<NH, H, LN, false>;
}

KernelFn pick(int nh, int H, bool ln, bool res) {
  if (nh == 1) {
    if (H == 64) return ln ? pick_res<1, 64, true>(res) : pick_res<1, 64, false>(res);
    return ln ? pick_res<1, 32, true>(res) : pick_res<1, 32, false>(res);
  }
  if (H == 64) return ln ? pick_res<2, 64, true>(res) : pick_res<2, 64, false>(res);
  return ln ? pick_res<2, 32, true>(res) : pick_res<2, 32, false>(res);
}

bool shapes_ok(int bs, int K, int P, int H, int nh, int bd, int dec_step) {
  return K >= 1 && K <= kMaxK && P >= 0 && kFeat + P <= kMaxD && (H == 32 || H == 64) &&
         (nh == 1 || nh == 2) && bs >= 1 && bd >= 1 && dec_step >= 1 &&
         (bd - 1) * static_cast<long long>(dec_step) < bs;
}

}  // namespace

extern "C" {

// How one call runs on the current device: out = {grid, samples per block,
// tap rows per block (capacity), resident (1) or streamed (0), dynamic
// shared memory bytes, scratch floats per block}. mode 0 keeps the slab in
// shared memory where it fits, 1 streams it. The caller sizes partials as
// [grid, npg] and scratch as [grid, work]. Returns a cudaError_t.
int clid_map_loop_plan(int bs, int K, int P, int H, int n_hidden, int layer_norm, int bd,
                       int dec_step, int mode, int* out) {
  if (!shapes_ok(bs, K, P, H, n_hidden, bd, dec_step) || mode < 0 || mode > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev, n_sm, optin, coop;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const bool ln = layer_norm != 0;
  const int npg = mlp_params(P, H, n_hidden) + 2;  // a partial row: gradient, losses
  int spc = cdiv(bs, n_sm);
  bool res = mode == 0 &&
             make_layout(K, P, H, n_hidden, ln, spc, tap_cap(spc, dec_step, bd),
                         cdiv(npg, n_sm), true)
                     .smem_floats * 4 <= optin;
  const KernelFn fn = pick(n_hidden, H, ln, res);
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Layout L0 =
      make_layout(K, P, H, n_hidden, ln, spc, tap_cap(spc, dec_step, bd), cdiv(npg, n_sm), res);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kNT, L0.smem_floats * 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = n_sm * per_sm;
  spc = cdiv(bs, grid);  // no larger than before, so per_sm blocks still fit
  const int ntap = tap_cap(spc, dec_step, bd);
  const Layout L = make_layout(K, P, H, n_hidden, ln, spc, ntap, cdiv(npg, grid), res);
  out[0] = grid;
  out[1] = spc;
  out[2] = ntap;
  out[3] = res ? 1 : 0;
  out[4] = L.smem_floats * 4;
  out[5] = res ? 0 : L.work;
  return 0;
}

// One cooperative launch of the whole loop on `stream`, with a plan from
// clid_map_loop_plan. Returns a cudaError_t (0 = launched). Argument checks
// live in the Python wrapper; values the kernel cannot take return
// cudaErrorInvalidValue.
int clid_map_loop(const float* f_in, float* f_out, float* m, float* v, const float* w0,
                  const float* encw0, const float* label_op, const float* wsel,
                  const float* wtap, const float* enctapw, const float* vd, float* mlp,
                  float* partials, float* scratch, float* losses,
                  const float* scal, int bs, int K, int P, int H, int n_hidden,
                  int layer_norm, int bd, int dec_step, int max_iters, int grid, int spc,
                  int ntap, int resident, float sdf_scale, float sigma, float lr,
                  float adam_eps, float weight_e, float num_grad_eps, void* stream) {
  if (!shapes_ok(bs, K, P, H, n_hidden, bd, dec_step) || max_iters < 0 || grid < 1 ||
      spc != cdiv(bs, grid) || ntap != tap_cap(spc, dec_step, bd))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.f_in = f_in;
  p.f_out = f_out;
  p.m = m;
  p.v = v;
  p.w0 = w0;
  p.encw0 = encw0;
  p.label_op = label_op;
  p.wsel = wsel;
  p.wtap = wtap;
  p.enctapw = enctapw;
  p.vd = vd;
  p.mlp = mlp;
  p.partials = partials;
  p.scratch = scratch;
  p.losses = losses;
  p.scal = scal;
  p.bs = bs;
  p.K = K;
  p.P = P;
  p.D = kFeat + P;
  p.Dp = round4(p.D);
  p.H = H;
  p.bd = bd;
  p.dec_step = dec_step;
  p.max_iters = max_iters;
  p.spc = spc;
  p.ntap = ntap;
  p.off_b1 = p.D * H;
  p.off_w2 = p.off_b1 + H;
  p.off_b2 = p.off_w2 + (n_hidden == 2 ? H * H : 0);
  p.off_wo = p.off_b2 + (n_hidden == 2 ? H : 0);
  p.off_bo = p.off_wo + H;
  p.n_params = mlp_params(P, H, n_hidden);
  p.npg = p.n_params + 2;
  p.cpb = cdiv(p.npg, grid);
  p.sdf_scale = sdf_scale;
  p.sigma = sigma;
  p.lr = lr;
  p.adam_eps = adam_eps;
  p.weight_e = weight_e;
  p.inv2eps = 1.f / (2.f * num_grad_eps);
  const bool ln = layer_norm != 0, res = resident != 0;
  p.L = make_layout(K, P, H, n_hidden, ln, spc, ntap, p.cpb, res);
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(pick(n_hidden, H, ln, res)), dim3(grid), dim3(kNT), args,
      static_cast<size_t>(p.L.smem_floats) * 4, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
