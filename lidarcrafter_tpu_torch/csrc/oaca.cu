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
// positional strip as ipe_k (Lk = sp * Lq).  The 32-wide loader below takes
// any Lk; the (64, 64, 64) route takes Lk = Lq only.
//
// The TPU kernel kept the whole K/V strip in VMEM and took one plain
// softmax.  On Hopper the strip does not fit a block's shared memory (at
// ds=4 it is 2048 x 96 values per head), so this kernel is a thin loader
// around the tensor-core flash core of flash_mma.cuh: one block of 4 warps
// per (batch*head, query tile),
//
//   * the q tile is assembled while it is staged: q_c goes to columns
//     0..DC-1 and ipe to columns DC..DC+DP-1 of each shared row, by two
//     cp.async sources;
//   * 64-key image tiles are assembled the same way from k_c and ipe, with
//     v_c beside them, in two stages filled with cp.async so that the next
//     tile loads while the products of this one run;
//   * the L2 <= 64 layout keys k_l (DC+DP wide) and values v_l (DV wide)
//     are staged once at block start into their own buffer, rounded up to
//     16 rows, and folded in after the image tiles, 16 keys at a time,
//     masked past L2 (L2 = 0 skips them);
//   * the scale^2 goes onto the f32 logits.
//
// Two head-dim instantiations of that loader, (DC, DP, DV) = (32, 32, 32)
// for the v1-v6 and auto-reg stacks and (32, 64, 32) for a positional
// strip twice as wide as the content (`channels_scale_for_positional_
// embedding` = 2 on 32-channel heads).  A strip half as wide (scale 0.5,
// DP = 16) runs in the (32, 32, 32) build: columns DC + 16 .. DC + 31 of
// every q, k_img and k_l row are zero-filled in shared memory, and zeros
// change no logit.  128 query rows a block (two m16 tiles a warp) at
// width 64, 64 (one a warp) at width 96.  The (32, 64, 32) build stays on
// this loader: its q/k rows would be a 64-byte k_c box beside a 128-byte
// ipe box, and a TMA box lands as a dense tile of its own width, so the
// two cannot share the 128-byte swizzled rows of the route below.
//
// (64, 64, 64), the v0 LayoutUnet (512 channels at ds=4, 8 heads, a
// positional strip as wide as the content), runs on the warp-specialised
// Hopper core of hopper_flash.cuh (`Oaca128` below): a TMA producer warp
// builds each image key tile from two boxes per 128-byte chunk -- k_c into
// q/k columns 0-63 and ipe into 64-127 (one 128B-swizzle span each in
// bf16) -- with v_c beside them, and the q tile [q_c | ipe] the same way;
// the layout strip k_l / v_l (L2 <= 64 rows, the rest zero-filled) is one
// more key tile after the image tiles, masked past L2.  Two consumer
// warpgroups own 64 query rows each (128 a block).  bf16 on wgmma: 128-key
// tiles, the q tile's fragments held in registers so that S = Q K^T
// (m64n128) reads only K from shared memory, P V m64n64 with P in
// registers; shared memory q 32 KB + 4 stages x 48 KB = 224 KB.  f32 on
// 3xTF32 mma.sync from the swizzled tiles, 64-key tiles; q 64 KB + 3
// stages x 48 KB = 208 KB.

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
// Every product runs on the tensor cores with P kept in registers; the
// exponentials of the online softmax (one per logit, on the special
// function units) are what the design leaves beside them.  The 64^3
// route also takes every load off the consumers (TMA) and, in bf16,
// every product onto wgmma, the only path to the tensor cores' full rate.

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

// ---------------------------------------------------------- (64, 64, 64)

struct OacaParams {
  CUtensorMap qc, ipe_q, kc, ipe_k, kl, vc, vl;  // kl / vl over their L2 rows (unset if L2 = 0)
  int32_t L2, n_img;
  hflash::Common c;
};

// bf16 takes 128-key tiles and keeps its q tile in registers (S reads only
// K from shared memory); f32 64-key tiles
template <typename T>
struct Oaca128 {
  using Type = T;
  using Params = OacaParams;
  static constexpr bool kF32 = is_f32<T>();
  static constexpr bool kSplit = false;
  static constexpr int kBK = kF32 ? 64 : 128, kNV = 64, kNQ = kF32 ? 0 : 8;
  static constexpr int CW = hflash::CHUNK / (int)sizeof(T);
  static constexpr int HC = 64 / CW;  // chunks of a 64-wide operand
  static constexpr int QC = hflash::ROWS * hflash::CHUNK, KC = kBK * hflash::CHUNK;

  // [q_c | ipe] for both consumers' 64 rows
  static __device__ __forceinline__ void load_q(const Params& p, unsigned char* sQ, uint64_t* bar,
                                                int q0, int h, int b) {
    for (int g = 0; g < 2; ++g) {
      unsigned char* dst = sQ + g * p.c.lay.q_wg;
      const int row = q0 + hflash::ROWS * g;
      for (int c = 0; c < HC; ++c) {
        hflash::tma_load(dst + c * QC, &p.qc, bar, c * CW, row, h, b);
        hflash::tma_load(dst + (HC + c) * QC, &p.ipe_q, bar, c * CW, row, h, b);
      }
    }
  }

  // image tile t: K = [k_c | ipe], V = v_c; the tile after them: k_l, v_l
  static __device__ __forceinline__ void load_k(const Params& p, unsigned char* sk, uint64_t* bar,
                                                int t, int h, int b) {
    if (t < p.n_img) {
      for (int c = 0; c < HC; ++c) {
        hflash::tma_load(sk + c * KC, &p.kc, bar, c * CW, t * kBK, h, b);
        hflash::tma_load(sk + (HC + c) * KC, &p.ipe_k, bar, c * CW, t * kBK, h, b);
      }
    } else {
      for (int c = 0; c < 2 * HC; ++c) hflash::tma_load(sk + c * KC, &p.kl, bar, c * CW, 0, h, b);
    }
  }

  static __device__ __forceinline__ void load_v(const Params& p, unsigned char* sv, uint64_t* bar,
                                                int t, int h, int b) {
    const CUtensorMap* map = t < p.n_img ? &p.vc : &p.vl;
    const int row = t < p.n_img ? t * kBK : 0;
    for (int c = 0; c < HC; ++c) hflash::tma_load(sv + c * KC, map, bar, c * CW, row, h, b);
  }

  static __device__ __forceinline__ int valid(const Params& p, int t) {
    return t < p.n_img ? min(kBK, p.c.Lq - t * kBK) : p.L2;
  }
};

// The 128-wide route's shared-memory plan; `kernels/oaca.py` mirrors it.
template <typename T>
hflash::Layout oaca128_layout() {
  constexpr int cw = Oaca128<T>::CW;
  return hflash::plan_layout(false, Oaca128<T>::kBK, 128 / cw, 64 / cw, 2 * 64 / cw);
}

template <typename T>
int launch_128(const OacaArgs& a, cudaStream_t s) {
  constexpr bool f32 = is_f32<T>();
  constexpr int BK = Oaca128<T>::kBK, R = hflash::ROWS;
  OacaParams p;
  memset(&p, 0, sizeof(p));
  p.c.lay = oaca128_layout<T>();
  int err = hflash::make_map(&p.qc, a.qc, f32, 64, a.Lq, a.H, a.B, a.qc_s, R);
  if (!err) err = hflash::make_map(&p.ipe_q, a.ipe, f32, 64, a.Lq, a.H, a.B, a.ipe_s, R);
  if (!err) err = hflash::make_map(&p.kc, a.kc, f32, 64, a.Lq, a.H, a.B, a.kc_s, BK);
  if (!err) err = hflash::make_map(&p.ipe_k, a.ipe_k, f32, 64, a.Lq, a.H, a.B, a.ipe_k_s, BK);
  if (!err) err = hflash::make_map(&p.vc, a.vc, f32, 64, a.Lq, a.H, a.B, a.vc_s, BK);
  if (!err && a.L2 > 0) err = hflash::make_map(&p.kl, a.kl, f32, 128, a.L2, a.H, a.B, a.kl_s, BK);
  if (!err && a.L2 > 0) err = hflash::make_map(&p.vl, a.vl, f32, 64, a.L2, a.H, a.B, a.vl_s, BK);
  if (!err) err = hflash::make_map(&p.c.out, a.out, f32, 64, a.Lq, a.H, a.B, a.out_s, R);
  if (err) return err;
  p.L2 = (int32_t)a.L2;
  p.n_img = (int32_t)((a.Lq + BK - 1) / BK);
  p.c.H = (int32_t)a.H;
  p.c.Lq = (int32_t)a.Lq;
  p.c.dv = 64;
  p.c.n_tiles = p.n_img + (a.L2 > 0 ? 1 : 0);
  p.c.n_full = (int32_t)(a.Lq / BK);  // the layout tile is always masked
  p.c.scale = (float)a.scale2;
  return hflash::launch_flash<Oaca128<T>>(p, a.Lq, a.B * a.H, s);
}

template <typename T>
int launch_dims(const OacaArgs& a, int dc, int dp, int dv, cudaStream_t s) {
  // DP = 16 (channels_scale_for_positional_embedding 0.5) runs in the
  // 32-wide build: its zero-filled columns change no logit
  if (dc == 32 && (dp == 16 || dp == 32) && dv == 32) return launch<T, 32, 32, 32>(a, dp, s);
  if (dc == 32 && dp == 64 && dv == 32) return launch<T, 32, 64, 32>(a, dp, s);
  if (dc == 64 && dp == 64 && dv == 64 && a.Lk == a.Lq) return launch_128<T>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns a cudaError_t code; cudaErrorInvalidValue for head dims other than
// (32, 16, 32), (32, 32, 32), (32, 64, 32) and (64, 64, 64) (Lk = Lq only), a
// layout length this build does not cover, or a scale that is not positive.
extern "C" int oaca_forward(OacaArgs a, int dtype, int dc, int dp, int dv, void* stream) {
  if (a.L2 < 0 || a.L2 > BK || a.Lq <= 0 || a.Lk <= 0 || a.B <= 0 || a.H <= 0 || a.B * a.H > 65535 ||
      !(a.scale2 > 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kFloat32) return launch_dims<float>(a, dc, dp, dv, s);
  if (dtype == kBFloat16) return launch_dims<__nv_bfloat16>(a, dc, dp, dv, s);
  return (int)cudaErrorInvalidValue;
}
