// ObjectAwareCrossAttention forward: one softmax over an image strip and a
// layout strip.
//
// Replaces the TPU kernel `_oaca_kernel` (lidarcrafter_tpu/ops/pallas_attention.py:183,
// called through `oaca_attention` / `_oaca_call`).  For each (batch, head):
//
//   q     = [q_c | ipe]                       (Lq, DC+DP)   image queries
//   k_img = [k_c | ipe_k]                     (Lk, DC+DP)   image keys
//   k_l                                       (L2, DC+DP)   layout keys
//   s     = scale^2 * q . [k_img ; k_l]^T     f32 logits
//   out   = softmax(s) . [v_c ; v_l]          (Lq, DV)
//
// In one process the image keys are the queries' own tokens: Lk = Lq and
// ipe_k is ipe.  Under the azimuth axis (parallel/mesh.py, sp > 1) a rank's
// queries are its columns of the image, and its keys k_c, v_c are every
// rank's columns gathered in the global token order, with the whole
// positional strip as ipe_k (Lk = sp * Lq: the v1-v6 stacks at 32^3, the v0
// LayoutUnet at 64^3).  Every route and instantiation takes any Lk: the
// image key tiles run over Lk rows, the last one masked past Lk (n_full
// counts the whole tiles of Lk).
//
// The TPU kernel kept the whole K/V strip in VMEM and took one plain
// softmax.  On Hopper the strip does not fit a block's shared memory (at
// ds=4 it is 2048 x 96 values per head), so it streams through the
// warp-specialised Hopper core of hopper_flash.cuh (`Oaca` below): a TMA
// producer warp builds each image key tile from separate boxes -- k_c and
// ipe_k each into chunks of their own width (a part of 64 bytes or less is
// one 64-byte chunk, 64B swizzle; wider parts 128-byte chunks), with v_c
// beside them -- and the q tile [q_c | ipe] the same way; S accumulates over
// the content and positional chunks in one f32 accumulator.  Nothing is
// interleaved into one row: a bf16 head of 32 is one dense 64-byte chunk, so
// (32, 64, 32) is a 128-byte ipe chunk beside a 64-byte q_c chunk, and DP =
// 16 runs in the (32, 32, 32) build, its chunk zero-filled past 16 columns by
// TMA (zeros change no logit).  The layout strip k_l / v_l (L2 <= 64 rows,
// the rest zero-filled; k_l's content and positional columns through two
// maps, each in its part's width) is one more key tile after the image
// tiles, masked past L2, and the scale^2 goes onto the f32 logits.  Two
// consumer warpgroups own 64 query rows each (128 a block).  bf16 on
// wgmma with the q tile's fragments in registers (S reads only K from
// shared memory), P V with P in registers:
//
//   * 32^3 (and DP = 16): 64-key tiles, two blocks an SM (80 registers at
//     launch, 104 a consumer thread); q 16 KB + 4 stages x 12 KB;
//   * (32, 64, 32): 128-key tiles, one block an SM;
//   * 64^3 (the v0 LayoutUnet: 512 channels at ds=4, 8 heads): 128-key
//     tiles; q 32 KB + 4 stages x 48 KB = 224 KB.
//
// f32 on 3xTF32 mma.sync from the same swizzled tiles, 64-key tiles, at
// 64^3 (q 64 KB + 3 stages x 48 KB = 208 KB).  f32 at the 32-wide head dims
// stays on the cp.async + mma.sync loader of flash_mma.cuh (`launch`
// below, by the fixed rule `takes_mma`): one block of 4 warps per
// (batch*head, query tile), q_c / ipe and k_c / ipe_k assembled into one
// padded shared row by two cp.async sources, the layout strip staged once
// and folded in after the image tiles 16 keys at a time.  Its warps own 32
// query rows, so each K / V fragment is split into its tf32 parts once for
// two products; a core consumer's warp owns 16, and the core measured
// 1.2-1.6x slower there.  Every route stays reachable by name
// (`oaca_forward_on`), for the kernel table.
//
// No concatenation, padding or scale pre-multiply is materialised in device
// memory: operands are read and the output written through their (batch,
// head, row) strides, so the per-head views of the fused qkv projection
// need no copy and the output can land directly in (batch, row, head)
// order.  Every pointer and stride is 16-byte aligned (the wrapper checks
// it), as cp.async and TMA need.
//
// Bound on the H100 at ds=4, B=8, both bound by operations:
//   * 32^3 (64 heads, 2048 queries, 2048 + 13 keys, 2 * 64 * 2048 * 2061 *
//     96 = 52 GFLOP): bf16 0.052 ms at 989 TFLOP/s against 42 MB of
//     operands and output (0.013 ms); f32 (3xTF32, three TF32 products per
//     product) 0.31 ms at 495 / 3 TFLOP/s against 84 MB (0.025 ms);
//   * 64^3 (the v0 stack, same token counts, 2 * 64 * 2048 * 2061 * 192 =
//     104 GFLOP): bf16 0.105 ms against 84 MB; f32 0.63 ms against 168 MB.
// Every product runs on the tensor cores with P kept in registers, every
// load of the core's routes on TMA, and in bf16 every product on wgmma,
// the only path to the tensor cores' full rate; the exponentials of the
// online softmax (one per logit, on the special function units) are what
// the design leaves beside them.

#include <stdint.h>
#include <string.h>

#include "flash_mma.cuh"
#include "hopper_flash.cuh"

// All fields are 8 bytes wide so the ctypes mirror has no padding to match.
struct OacaArgs {
  const void* qc;
  const void* ipe;
  const void* kc;
  const void* kl;
  const void* vc;
  const void* vl;
  void* out;
  // (batch, head, row) strides in elements; the last dim is contiguous
  int64_t qc_s[3];
  int64_t ipe_s[3];
  int64_t kc_s[3];
  int64_t kl_s[3];
  int64_t vc_s[3];
  int64_t vl_s[3];
  int64_t out_s[3];
  int64_t B, H, Lq, L2;
  double scale2;
  const void* ipe_k;  // the image keys' positional rows (Lk of them)
  int64_t ipe_k_s[3];
  int64_t Lk;
};

namespace {

using namespace flash;

// ---------------------------------------------------------- the cp.async + mma.sync loader
//
// f32 at head dims (32, 16 | 32 | 64, 32) (`takes_mma`); any dtype by name.

constexpr int LSLICE = 16;  // layout keys per fold

template <typename T, int DQK, int DV>
struct Smem {
  static constexpr int LDQ = ld_qk<DQK>(), LDV = ld_v<T, DV>(), BQ = block_rows<DQK>();
  // K stages 0 and 1, V stages 0 and 1, the q tile, then the layout strip
  // of l2p rows
  static constexpr int kV = 2 * BK * LDQ, kQ = kV + 2 * BK * LDV, kL = kQ + BQ * LDQ;
  static size_t bytes(int l2p) { return sizeof(T) * (kL + l2p * (LDQ + LDV)); }
};

// DP is the positional width the kernel is built for; dp <= DP is the
// operands' (the columns of ipe and k_l past DC + dp are zero-filled)
template <typename T, int DC, int DP, int DV>
__global__ void __launch_bounds__(NT) oaca_fwd_kernel(const OacaArgs a, const int dp) {
  constexpr int DQK = DC + DP;
  using S = Smem<T, DQK, DV>;
  constexpr int LDQ = S::LDQ, LDV = S::LDV, BQ = S::BQ;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + S::kV;
  T* sQ = sK + S::kQ;
  T* sKl = sK + S::kL;
  const int L2 = (int)a.L2, l2p = (L2 + LSLICE - 1) / LSLICE * LSLICE;
  T* sVl = sKl + l2p * LDQ;

  const int64_t bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const int Lq = (int)a.Lq, Lk = (int)a.Lk;
  const T* qc = (const T*)a.qc + b * a.qc_s[0] + h * a.qc_s[1];
  const T* ipe = (const T*)a.ipe + b * a.ipe_s[0] + h * a.ipe_s[1];
  const T* ipe_k = (const T*)a.ipe_k + b * a.ipe_k_s[0] + h * a.ipe_k_s[1];
  const T* kc = (const T*)a.kc + b * a.kc_s[0] + h * a.kc_s[1];
  const T* kl = (const T*)a.kl + b * a.kl_s[0] + h * a.kl_s[1];
  const T* vc = (const T*)a.vc + b * a.vc_s[0] + h * a.vc_s[1];
  const T* vl = (const T*)a.vl + b * a.vl_s[0] + h * a.vl_s[1];

  // image tile t: keys [k_c | ipe_k], values v_c
  auto stage_image = [&](int t) {
    const int k0 = t * BK, n = min(BK, Lk - k0);
    T* dk = sK + (t & 1) * BK * LDQ;
    stage_rows<T, DC, BK>(dk, LDQ, kc, a.kc_s[2], k0, n, DC);
    stage_rows<T, DP, BK>(dk + DC, LDQ, ipe_k, a.ipe_k_s[2], k0, n, dp);
    stage_rows<T, DV, BK>(sV + (t & 1) * BK * LDV, LDV, vc, a.vc_s[2], k0, n, DV);
    cp_async_commit();
  };
  // queries [q_c | ipe]
  stage_rows<T, DC, BQ>(sQ, LDQ, qc, a.qc_s[2], q0, Lq - q0, DC);
  stage_rows<T, DP, BQ>(sQ + DC, LDQ, ipe, a.ipe_s[2], q0, Lq - q0, dp);
  // layout strip: keys k_l (already [k_lc | lpe]), values v_l
  stage_rows_n<T, DQK>(sKl, LDQ, l2p, kl, a.kl_s[2], 0, L2, DC + dp);
  stage_rows_n<T, DV>(sVl, LDV, l2p, vl, a.vl_s[2], 0, L2, DV);
  stage_image(0);

  using Warp = FlashWarp<T, DQK, DV>;
  Warp::fill_ones(sV, 2 * BK);
  Warp::fill_ones(sVl, l2p);
  Warp w;
  w.init((float)a.scale2);
  const int n_tiles = (Lk + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; every warp is done with tile t-1
    if (t == 0) w.load_q(sQ);
    if (t + 1 < n_tiles) stage_image(t + 1);  // overlaps the products of tile t
    const T* k_t = sK + (t & 1) * BK * LDQ;
    const T* v_t = sV + (t & 1) * BK * LDV;
    if (Lk - t * BK < BK)
      w.template attend<BK, true>(k_t, v_t, Lk - t * BK);
    else
      w.template attend<BK, false>(k_t, v_t, BK);
  }
  for (int j0 = 0; j0 < L2; j0 += LSLICE)
    w.template attend<LSLICE, true>(sKl + j0 * LDQ, sVl + j0 * LDV, L2 - j0);

  T* out = (T*)a.out + b * a.out_s[0] + h * a.out_s[1];
  w.store(out, a.out_s[2], q0, Lq, DV);
}

template <typename T, int DC, int DP, int DV>
int launch(const OacaArgs& a, int dp, cudaStream_t s) {
  using S = Smem<T, DC + DP, DV>;
  const size_t bytes = S::bytes((int)((a.L2 + LSLICE - 1) / LSLICE * LSLICE));
  const dim3 grid((unsigned)((a.Lq + S::BQ - 1) / S::BQ), (unsigned)(a.B * a.H));
  auto* kernel = oaca_fwd_kernel<T, DC, DP, DV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, bytes, s>>>(a, dp);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- the Hopper core

struct OacaParams {
  // q_c, ipe (64 query rows a box); k_c, ipe_k over Lk rows; k_l's content
  // and positional columns (two maps: each part in its own chunk width) and
  // v_l over L2 rows (unset if L2 = 0); v_c over Lk rows
  CUtensorMap qc, ipe_q, kc, ipe_k, kl_c, kl_p, vc, vl;
  int32_t L2, Lk, n_img;
  hflash::Common c;
};

// OACA at head dims (DC, DP, DC) on the core.  A q / k row is its content
// part (q_c / k_c, DC columns) and its positional part (ipe / ipe_k, DP
// columns) as separate chunks, each in its own width: a part of 64 bytes or
// less is one 64-byte chunk (DP = 16 zero-filled past its 16 columns),
// wider ones are 128-byte chunks.  The 128-byte chunks lead the row
// (content's, then positional's), the 64-byte ones follow in the same
// order, and S accumulates over all of them in one f32 accumulator (the
// k16 steps of every chunk in bf16, the k8 steps in f32).  The image key
// tiles come first; the layout strip k_l / v_l (L2 <= 64 rows, the rest
// zero-filled) is one more key tile after them, masked past L2.  bf16:
// 128-key tiles, the q tile in registers; f32: 64-key tiles.
template <typename T, int DC, int DP, int BK = (is_f32<T>() ? 64 : 128), int MB = 1>
struct Oaca {
  using Type = T;
  using Params = OacaParams;
  static constexpr bool kF32 = is_f32<T>();
  static constexpr bool kSplit = false;
  static constexpr int E = (int)sizeof(T);
  static constexpr int CB = DC * E, PB = DP * E;  // bytes of each part's row
  static constexpr int C128 = CB / hflash::CHUNK, P128 = PB / hflash::CHUNK;  // 128-byte chunks (0: one 64-byte one)
  static_assert(CB <= hflash::HALF ? C128 == 0 : CB % hflash::CHUNK == 0, "content: one 64-byte chunk or 128-byte ones");
  static_assert(PB <= hflash::HALF ? P128 == 0 : PB % hflash::CHUNK == 0, "positional: one 64-byte chunk or 128-byte ones");
  static constexpr int NQC = C128 + P128;                  // 128-byte chunks of a q / k row
  static constexpr int kQH = (C128 ? 0 : 1) + (P128 ? 0 : 1);  // 64-byte ones after them
  static constexpr int kBK = BK, kNV = DC, kMinBlocks = MB;
  static constexpr int kNQ = kF32 ? 0 : 4 * NQC + 2 * kQH;
  static constexpr int CWC = (C128 ? hflash::CHUNK : hflash::HALF) / E;  // columns of a content chunk
  static constexpr int CWP = (P128 ? hflash::CHUNK : hflash::HALF) / E;  // of a positional chunk
  static constexpr int VB = DC * E < hflash::CHUNK ? hflash::HALF : hflash::CHUNK;  // bytes of a V chunk's row
  static constexpr int NVC = DC * E / VB;  // V chunks

  // byte offset of chunk i of a q / k row in a tile of `rows` rows
  static __device__ __forceinline__ int off(int i, int rows) {
    return i < NQC ? i * rows * hflash::CHUNK : NQC * rows * hflash::CHUNK + (i - NQC) * rows * hflash::HALF;
  }
  // the chunk index of content chunk j / positional chunk j
  static __device__ __forceinline__ int content(int j) { return C128 ? j : NQC; }
  static __device__ __forceinline__ int positional(int j) { return P128 ? C128 + j : NQC + (C128 ? 0 : 1); }

  // [q_c | ipe] for both consumers' 64 rows
  static __device__ __forceinline__ void load_q(const Params& p, unsigned char* sQ, uint64_t* bar,
                                                int q0, int h, int b) {
    for (int g = 0; g < 2; ++g) {
      unsigned char* dst = sQ + g * p.c.lay.q_wg;
      const int row = q0 + hflash::ROWS * g;
      for (int j = 0; j < (C128 ? C128 : 1); ++j)
        hflash::tma_load(dst + off(content(j), hflash::ROWS), &p.qc, bar, j * CWC, row, h, b);
      for (int j = 0; j < (P128 ? P128 : 1); ++j)
        hflash::tma_load(dst + off(positional(j), hflash::ROWS), &p.ipe_q, bar, j * CWP, row, h, b);
    }
  }

  // image tile t: K = [k_c | ipe_k], V = v_c; the tile after them: k_l, v_l
  static __device__ __forceinline__ void load_k(const Params& p, unsigned char* sk, uint64_t* bar,
                                                int t, int h, int b) {
    const bool img = t < p.n_img;
    const int row = img ? t * kBK : 0;
    for (int j = 0; j < (C128 ? C128 : 1); ++j)
      hflash::tma_load(sk + off(content(j), kBK), img ? &p.kc : &p.kl_c, bar, j * CWC, row, h, b);
    for (int j = 0; j < (P128 ? P128 : 1); ++j)
      hflash::tma_load(sk + off(positional(j), kBK), img ? &p.ipe_k : &p.kl_p, bar, (img ? 0 : DC) + j * CWP,
                       row, h, b);
  }

  static __device__ __forceinline__ void load_v(const Params& p, unsigned char* sv, uint64_t* bar,
                                                int t, int h, int b) {
    const CUtensorMap* map = t < p.n_img ? &p.vc : &p.vl;
    const int row = t < p.n_img ? t * kBK : 0;
    for (int j = 0; j < NVC; ++j) hflash::tma_load(sv + j * kBK * VB, map, bar, j * (VB / E), row, h, b);
  }

  static __device__ __forceinline__ int valid(const Params& p, int t) {
    return t < p.n_img ? min(kBK, p.Lk - t * kBK) : p.L2;
  }
};

// (32, 32, 32): in bf16 (a q / k row of two 64-byte chunks, O 64 bytes
// wide) 64-key tiles and two blocks an SM, the consumers at 104 registers
// (S 32, P 16, O 16, q 16); in f32 64-key tiles, one block, as the rest.
template <typename T>
using Oaca32 = Oaca<T, 32, 32, 64, is_f32<T>() ? 1 : 2>;

// The core's shared-memory plan of problem P; `kernels/oaca.py::plan`
// mirrors it.
template <class P>
hflash::Layout oaca_layout() {
  const int qk_row = P::NQC * hflash::CHUNK + P::kQH * hflash::HALF, v_row = P::NVC * P::VB;
  const int out = 2 * ((P::kNV * P::E + hflash::CHUNK - 1) / hflash::CHUNK) * hflash::ROWS * hflash::CHUNK;
  return hflash::plan_layout(false, P::kBK, qk_row, v_row, out, P::kMinBlocks);
}

// One launch of problem P (head dims (DC, DP, DC)); dp <= DP is the
// operands' positional width (its maps' extent: columns past it are
// zero-filled, so dp = 16 runs in a DP = 32 build)
template <class P>
int launch_core(const OacaArgs& a, int dp, cudaStream_t s) {
  constexpr bool f32 = P::kF32;
  constexpr int BK = P::kBK, R = hflash::ROWS, DC = P::kNV;
  constexpr int WC = P::C128 ? hflash::CHUNK : hflash::HALF, WP = P::P128 ? hflash::CHUNK : hflash::HALF;
  OacaParams p;
  memset(&p, 0, sizeof(p));
  p.c.lay = oaca_layout<P>();
  const int64_t dqk = DC + dp;
  int err = hflash::make_map(&p.qc, a.qc, f32, DC, a.Lq, a.H, a.B, a.qc_s, R, WC);
  if (!err) err = hflash::make_map(&p.ipe_q, a.ipe, f32, dp, a.Lq, a.H, a.B, a.ipe_s, R, WP);
  if (!err) err = hflash::make_map(&p.kc, a.kc, f32, DC, a.Lk, a.H, a.B, a.kc_s, BK, WC);
  if (!err) err = hflash::make_map(&p.ipe_k, a.ipe_k, f32, dp, a.Lk, a.H, a.B, a.ipe_k_s, BK, WP);
  if (!err) err = hflash::make_map(&p.vc, a.vc, f32, DC, a.Lk, a.H, a.B, a.vc_s, BK, P::VB);
  if (!err && a.L2 > 0) err = hflash::make_map(&p.kl_c, a.kl, f32, dqk, a.L2, a.H, a.B, a.kl_s, BK, WC);
  if (!err && a.L2 > 0) err = hflash::make_map(&p.kl_p, a.kl, f32, dqk, a.L2, a.H, a.B, a.kl_s, BK, WP);
  if (!err && a.L2 > 0) err = hflash::make_map(&p.vl, a.vl, f32, DC, a.L2, a.H, a.B, a.vl_s, BK, P::VB);
  if (!err) err = hflash::make_map(&p.c.out, a.out, f32, DC, a.Lq, a.H, a.B, a.out_s, R);
  if (err) return err;
  p.L2 = (int32_t)a.L2;
  p.Lk = (int32_t)a.Lk;
  p.n_img = (int32_t)((a.Lk + BK - 1) / BK);
  p.c.H = (int32_t)a.H;
  p.c.Lq = (int32_t)a.Lq;
  p.c.dv = DC;
  p.c.n_tiles = p.n_img + (a.L2 > 0 ? 1 : 0);
  p.c.n_full = (int32_t)(a.Lk / BK);  // the layout tile is always masked
  p.c.scale = (float)a.scale2;
  return hflash::launch_flash<P>(p, a.Lq, a.B * a.H, s);
}

// The route a call takes: the core at every head dims, except f32 at the
// 32-wide ones, which stays on the cp.async + mma.sync loader above: its
// warps own 32 query rows (two m16 tiles), so each K / V fragment is split
// into its tf32 parts once for two products, where a core consumer's warp
// owns 16 and splits it for one; the core measured 1.2-1.6x slower there
// (`kernels/oaca.py::route` mirrors the rule).
inline bool takes_mma(bool f32, int dc, int dp) {
  (void)dp;
  return f32 && dc == 32;
}

template <typename T>
int launch_mma(const OacaArgs& a, int dc, int dp, int dv, cudaStream_t s) {
  // DP = 16 (channels_scale_for_positional_embedding 0.5) runs in the
  // 32-wide build: its zero-filled columns change no logit
  if (dc == 32 && (dp == 16 || dp == 32) && dv == 32) return launch<T, 32, 32, 32>(a, dp, s);
  if (dc == 32 && dp == 64 && dv == 32) return launch<T, 32, 64, 32>(a, dp, s);
  return (int)cudaErrorInvalidValue;
}

// core: the core whatever the rule says
template <typename T>
int launch_dims(const OacaArgs& a, int dc, int dp, int dv, cudaStream_t s, bool core = false) {
  if (!core && dc == 32 && dv == 32 && (dp == 16 || dp == 32 || dp == 64) && takes_mma(is_f32<T>(), dc, dp))
    return launch_mma<T>(a, dc, dp, dv, s);
  if (dc == 32 && dp == 32 && dv == 32) return launch_core<Oaca32<T>>(a, dp, s);
  if (dc == 32 && dp == 64 && dv == 32) return launch_core<Oaca<T, 32, 64>>(a, dp, s);
  if (dc == 32 && dp == 16 && dv == 32) {  // bf16: 16 columns zero-filled in the 32 build's 64-byte chunk
    if constexpr (is_f32<T>()) return launch_core<Oaca<T, 32, 16>>(a, dp, s);
    return launch_core<Oaca32<T>>(a, dp, s);
  }
  if (dc == 64 && dp == 64 && dv == 64) return launch_core<Oaca<T, 64, 64>>(a, dp, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns a cudaError_t code; cudaErrorInvalidValue for head dims other than
// (32, 16, 32), (32, 32, 32), (32, 64, 32) and (64, 64, 64), a layout length
// this build does not cover, or a scale that is not positive.
static int check_args(const OacaArgs& a, int dtype) {
  if (a.L2 < 0 || a.L2 > BK || a.Lq <= 0 || a.Lk <= 0 || a.B <= 0 || a.H <= 0 || a.B * a.H > 65535 ||
      !(a.scale2 > 0) || (dtype != kFloat32 && dtype != kBFloat16))
    return (int)cudaErrorInvalidValue;
  return 0;
}

extern "C" int oaca_forward(OacaArgs a, int dtype, int dc, int dp, int dv, void* stream) {
  if (int err = check_args(a, dtype)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == kFloat32 ? launch_dims<float>(a, dc, dp, dv, s) : launch_dims<__nv_bfloat16>(a, dc, dp, dv, s);
}

// One route by name, whatever `takes_mma` says (route 0: the core; 1: the
// cp.async + mma.sync loader, head dims (32, 16 | 32 | 64, 32)): the routes
// side by side on the same operands in one process, for the kernel table's
// comparison.
extern "C" int oaca_forward_on(OacaArgs a, int dtype, int dc, int dp, int dv, int route, void* stream) {
  if (int err = check_args(a, dtype)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 0)
    return dtype == kFloat32 ? launch_dims<float>(a, dc, dp, dv, s, true)
                             : launch_dims<__nv_bfloat16>(a, dc, dp, dv, s, true);
  if (route == 1)
    return dtype == kFloat32 ? launch_mma<float>(a, dc, dp, dv, s) : launch_mma<__nv_bfloat16>(a, dc, dp, dv, s);
  return (int)cudaErrorInvalidValue;
}

// The core's plan for (dtype, dc, dp, dv), for `kernels/oaca.py`'s mirror
// to be held against: out = {bk, blocks an SM, stages, smem bytes}.
// Returns 0, or cudaErrorInvalidValue for head dims the kernel does not
// take.
extern "C" int oaca_plan(int dtype, int dc, int dp, int dv, int32_t* out) {
  const bool f32 = dtype == kFloat32;
  if ((dtype != kFloat32 && dtype != kBFloat16) || dv != dc) return (int)cudaErrorInvalidValue;
  using B = __nv_bfloat16;
  hflash::Layout L{};
  int bk = f32 ? 64 : 128, blocks = 1;
  if (dc == 32 && (dp == 32 || dp == 16) && !f32) {
    L = oaca_layout<Oaca32<B>>();
    bk = Oaca32<B>::kBK;
    blocks = Oaca32<B>::kMinBlocks;
  } else if (dc == 32 && dp == 32) {
    L = oaca_layout<Oaca32<float>>();
  } else if (dc == 32 && dp == 64) {
    L = f32 ? oaca_layout<Oaca<float, 32, 64>>() : oaca_layout<Oaca<B, 32, 64>>();
  } else if (dc == 32 && dp == 16) {
    L = oaca_layout<Oaca<float, 32, 16>>();
  } else if (dc == 64 && dp == 64) {
    L = f32 ? oaca_layout<Oaca<float, 64, 64>>() : oaca_layout<Oaca<B, 64, 64>>();
  } else {
    return (int)cudaErrorInvalidValue;
  }
  out[0] = bk;
  out[1] = blocks;
  out[2] = L.stages;
  out[3] = L.smem;
  return 0;
}
