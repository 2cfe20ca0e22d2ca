// Softmax attention forward: out = softmax(scale * q . k^T) . v over the
// first kv_len keys, f32 logits and softmax, output in the operands' dtype.
//
// Replaces the TPU kernel `_attn_kernel` (lidarcrafter_tpu/ops/pallas_attention.py:40,
// called through `flash_attention` / `attention_bhld`).  Users: the
// EfficientUNet's `SelfAttention2d` (scale 1/sqrt(dh)) and the MeanFlow
// `MFSelfAttention2d` (q already scaled, scale 1), in `d_block4` and
// `u_block4`; GLIDE's attention block (scale 1/sqrt(dh)) in the layout UNet
// and in `OpenAIUNet`.
//
// The TPU kernel kept a whole K/V strip of a head in VMEM and took one plain
// softmax.  Here it is a thin loader around the tensor-core flash core of
// flash_mma.cuh: one block of 4 warps per (batch*head, query tile) -- 128
// queries up to head dim 64, else 64; the q tile and two stages of 64-key
// k/v tiles are filled with cp.async, so that the next tile loads while
// the products of this one run.  Keys past kv_len
// score -inf inside the last tile; tiles past it are never loaded.
//
// Operands are read, and the output written, through their (batch, head,
// row) strides: the per-head views of a fused (B, L, 3C) projection need no
// copy and the output lands directly in (B, L, heads*dv) order.  Head dims
// up to 128 are zero-padded to D = 32, 64 or 128 inside shared memory; dqk
// may differ from dv.  Every pointer and stride is 16-byte aligned (the
// wrapper checks it), as cp.async and TMA need.  The GLIDE block's keys
// and values are its encoder's tokens followed by the image's (Lkv = 13 +
// Lq on the layout stacks).
//
// Head dims from 129 to 512 (OpenAIUNet's one head as wide as the block:
// 256 and 512) take the wide route, `Wide` below, on the warp-specialised
// Hopper core of hopper_flash.cuh: a TMA producer warp fills a ring of
// K/V stages (tensor maps built per call over the operands' strides, rows
// past kv_len and columns past the head dims zero-filled), and two
// consumer warpgroups fold the key tiles into an online softmax.  Q K^T
// runs once per (query tile, key tile) for the whole dv -- no block
// recomputes S for a slice of dv.  Tiles and shared memory (227 KB a
// block), by `wide_plan`:
//
//   * bf16, dqk and dv <= 256: 128 query rows a block, each consumer its
//     own 64 (a q tile of 64 x dqk) and the whole dv (an m64n128 or
//     m64n256 f32 accumulator, <= 128 registers a thread); 80-key stages
//     of K (80 x dqk) and V (80 x 128 or 256): S is m64n80, whose
//     operands' shared-memory reads per key are 10% below m64n64's, and
//     two stages still fit.  S and P V on wgmma.  At d = 256: q 64 KB + 2
//     stages x 80 KB = 224 KB.
//   * bf16 above 256: 64 query rows shared by both consumers: each
//     computes S over half of dqk's 64-column chunks, the halves are
//     summed through shared memory, and each computes P V on half of dv
//     (128 or 256 columns).  32-key stages.  At d = 512: q 64 KB + 2 x 64
//     KB stages + 32 KB of score exchange = 224 KB.
//   * f32 (3xTF32), every wide shape: the split block above, its products
//     on mma.sync m16n8k8 (wgmma takes tf32 only K-major, and V is
//     MN-major); 32-key stages where two fit, else 16.  At d = 256: q
//     64 KB + 2 x 64 KB + 32 KB; at d = 512: q 128 KB + 1 x 64 KB + 16 KB.
//
// Bound on the H100 at the main shape (B=8, 8 heads, L=512, d=64), 4 *
// 64 * 512 * 512 * 64 = 4.3 GFLOP:
//   * bf16 (mma.sync bf16): bytes, 17 MB of operands and output, 0.005 ms
//     (the products alone are 0.004 ms at 989 TFLOP/s);
//   * f32 (3xTF32): operations, three TF32 products per product, 0.026 ms
//     at 495 / 3 TFLOP/s, against 34 MB (0.010 ms).
// At this size the call is launch- and latency-bound (256 or 512 blocks, 8
// key tiles each); the design keeps every product on the tensor cores, P in
// registers and the loads asynchronous, so what remains is the softmax's
// exponentials and the per-tile synchronisation.

#include <stdint.h>
#include <string.h>

#include "flash_mma.cuh"
#include "hopper_flash.cuh"

// All fields are 8 bytes wide so the ctypes mirror has no padding to match.
struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  // (batch, head, row) strides in elements; the last dim is contiguous
  int64_t q_s[3];
  int64_t k_s[3];
  int64_t v_s[3];
  int64_t out_s[3];
  int64_t B, H, Lq, Lkv, kv_len, dqk, dv;
  double scale;
};

namespace {

using namespace flash;

template <typename T, int D>
struct Smem {
  static constexpr int LDQ = ld_qk<D>(), LDV = ld_v<T, D>(), BQ = block_rows<D>();
  // K stages 0 and 1, V stages 0 and 1, then the q tile; a 64-row q tile
  // (head dim 128) instead borrows K stage 1 until its fragments are loaded
  static constexpr bool kQAlias = BQ == BK;
  static constexpr int kV = 2 * BK * LDQ, kEnd = kV + 2 * BK * LDV;
  static constexpr int kQ = kQAlias ? BK * LDQ : kEnd;
  static constexpr size_t bytes = sizeof(T) * (kQAlias ? kEnd : kEnd + BQ * LDQ);
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) attention_fwd_kernel(const AttnArgs a) {
  using S = Smem<T, D>;
  constexpr int LDQ = S::LDQ, LDV = S::LDV, BQ = S::BQ;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + S::kV;
  T* sQ = sK + S::kQ;

  const int64_t bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const int Lq = (int)a.Lq, kv_len = (int)a.kv_len, dqk = (int)a.dqk, dv = (int)a.dv;
  const T* q = (const T*)a.q + b * a.q_s[0] + h * a.q_s[1];
  const T* k = (const T*)a.k + b * a.k_s[0] + h * a.k_s[1];
  const T* v = (const T*)a.v + b * a.v_s[0] + h * a.v_s[1];

  auto stage_kv = [&](int t) {
    const int k0 = t * BK, n = min(BK, kv_len - k0);
    stage_rows<T, D, BK>(sK + (t & 1) * BK * LDQ, LDQ, k, a.k_s[2], k0, n, dqk);
    stage_rows<T, D, BK>(sV + (t & 1) * BK * LDV, LDV, v, a.v_s[2], k0, n, dv);
    cp_async_commit();
  };
  stage_rows<T, D, BQ>(sQ, LDQ, q, a.q_s[2], q0, Lq - q0, dqk);
  stage_kv(0);

  using Warp = FlashWarp<T, D, D>;
  Warp::fill_ones(sV, 2 * BK);
  Warp w;
  w.init((float)a.scale);
  const int n_tiles = (kv_len + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; every warp is done with tile t-1
    if (t == 0) {
      w.load_q(sQ);
      if constexpr (S::kQAlias) __syncthreads();  // the q tile's stage is free for tile 1
    }
    if (t + 1 < n_tiles) stage_kv(t + 1);  // overlaps the products of tile t
    const T* k_t = sK + (t & 1) * BK * LDQ;
    const T* v_t = sV + (t & 1) * BK * LDV;
    if (kv_len - t * BK < BK)
      w.template attend<BK, true>(k_t, v_t, kv_len - t * BK);
    else
      w.template attend<BK, false>(k_t, v_t, BK);
  }
  T* out = (T*)a.out + b * a.out_s[0] + h * a.out_s[1];
  w.store(out, a.out_s[2], q0, Lq, dv);
}

template <typename T, int D>
int launch(const AttnArgs& a, cudaStream_t s) {
  const size_t bytes = Smem<T, D>::bytes;
  constexpr int BQ = Smem<T, D>::BQ;
  const dim3 grid((unsigned)((a.Lq + BQ - 1) / BQ), (unsigned)(a.B * a.H));
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  attention_fwd_kernel<T, D><<<grid, NT, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- wide heads

constexpr int kMaxHeadDim = 512;

struct WideParams {
  CUtensorMap q, k, v;  // K and V over their first kv_len rows
  int32_t kv_len;
  hflash::Common c;
};

template <typename T, bool SPLIT, int BK, int NV>
struct Wide {
  using Type = T;
  using Params = WideParams;
  static constexpr bool kSplit = SPLIT;
  static constexpr int kBK = BK, kNV = NV, kNQ = 0, CW = hflash::CHUNK / (int)sizeof(T);

  static __device__ __forceinline__ void load_q(const Params& p, unsigned char* sQ, uint64_t* bar,
                                                int q0, int h, int b) {
    for (int g = 0; g < (SPLIT ? 1 : 2); ++g)
      for (int c = 0; c < p.c.lay.nqc; ++c)
        hflash::tma_load(sQ + g * p.c.lay.q_wg + c * hflash::ROWS * hflash::CHUNK, &p.q, bar,
                         c * CW, q0 + hflash::ROWS * g, h, b);
  }

  static __device__ __forceinline__ void load_k(const Params& p, unsigned char* sk, uint64_t* bar,
                                                int t, int h, int b) {
    for (int c = 0; c < p.c.lay.nqc; ++c)
      hflash::tma_load(sk + c * BK * hflash::CHUNK, &p.k, bar, c * CW, t * BK, h, b);
  }

  static __device__ __forceinline__ void load_v(const Params& p, unsigned char* sv, uint64_t* bar,
                                                int t, int h, int b) {
    for (int c = 0; c < p.c.lay.nvt; ++c)
      hflash::tma_load(sv + c * BK * hflash::CHUNK, &p.v, bar, c * CW, t * BK, h, b);
  }

  static __device__ __forceinline__ int valid(const Params& p, int t) {
    return min(BK, p.kv_len - t * BK);
  }
};

// The wide route's tiling for (dqk, dv); `kernels/attention.py::wide_plan`
// mirrors it.  bf16 with both dims <= 256: not split, 80-key tiles, O as
// wide as dv (128 or 256 columns).  Otherwise split, each consumer's O
// half as wide (128 or 256 columns); 32-key tiles, except in f32 where a
// 256-column half or fewer than two stages of 32 keys take 16.
struct WidePlan {
  int split, bk, nv;
  hflash::Layout lay;
};

inline WidePlan wide_plan(bool f32, int dqk, int dv) {
  const int cw = hflash::CHUNK / (f32 ? 4 : 2), nqc = (dqk + cw - 1) / cw;
  WidePlan w{};
  if (!f32 && dqk <= 256 && dv <= 256) {
    w.split = 0;
    w.nv = dv <= 128 ? 128 : 256;
    w.bk = 80;
  } else {
    w.split = 1;
    w.nv = (dv + 1) / 2 <= 128 ? 128 : 256;
    w.bk = f32 && (w.nv == 256 ||
                   hflash::plan_layout(true, 32, nqc, 2 * w.nv / cw, 2 * w.nv / cw).stages < 2)
               ? 16
               : 32;
  }
  w.lay = hflash::plan_layout(w.split, w.bk, nqc, (w.split ? 2 : 1) * w.nv / cw, 2 * w.nv / cw);
  return w;
}

template <typename T>
int launch_wide(const AttnArgs& a, cudaStream_t s) {
  constexpr bool f32 = is_f32<T>();
  const WidePlan w = wide_plan(f32, (int)a.dqk, (int)a.dv);
  if (w.lay.stages < 1) return (int)cudaErrorInvalidValue;
  WideParams p;
  memset(&p, 0, sizeof(p));
  int err = hflash::make_map(&p.q, a.q, f32, a.dqk, a.Lq, a.H, a.B, a.q_s, hflash::ROWS);
  if (!err) err = hflash::make_map(&p.k, a.k, f32, a.dqk, a.kv_len, a.H, a.B, a.k_s, w.bk);
  if (!err) err = hflash::make_map(&p.v, a.v, f32, a.dv, a.kv_len, a.H, a.B, a.v_s, w.bk);
  if (!err) err = hflash::make_map(&p.c.out, a.out, f32, a.dv, a.Lq, a.H, a.B, a.out_s, hflash::ROWS);
  if (err) return err;
  p.kv_len = (int32_t)a.kv_len;
  p.c.H = (int32_t)a.H;
  p.c.Lq = (int32_t)a.Lq;
  p.c.dv = (int32_t)a.dv;
  p.c.n_tiles = (int32_t)((a.kv_len + w.bk - 1) / w.bk);
  p.c.n_full = (int32_t)(a.kv_len / w.bk);
  p.c.scale = (float)a.scale;
  p.c.lay = w.lay;
  const int64_t BH = a.B * a.H;
  if constexpr (!f32) {
    if (!w.split)
      return w.nv == 128 ? hflash::launch_flash<Wide<T, false, 80, 128>>(p, a.Lq, BH, s)
                         : hflash::launch_flash<Wide<T, false, 80, 256>>(p, a.Lq, BH, s);
    return w.nv == 128 ? hflash::launch_flash<Wide<T, true, 32, 128>>(p, a.Lq, BH, s)
                       : hflash::launch_flash<Wide<T, true, 32, 256>>(p, a.Lq, BH, s);
  } else {
    if (w.nv == 256) return hflash::launch_flash<Wide<T, true, 16, 256>>(p, a.Lq, BH, s);
    return w.bk == 32 ? hflash::launch_flash<Wide<T, true, 32, 128>>(p, a.Lq, BH, s)
                      : hflash::launch_flash<Wide<T, true, 16, 128>>(p, a.Lq, BH, s);
  }
}

template <typename T>
int launch_dim(const AttnArgs& a, cudaStream_t s) {
  const int64_t d = a.dqk > a.dv ? a.dqk : a.dv;
  if (d <= 32) return launch<T, 32>(a, s);
  if (d <= 64) return launch<T, 64>(a, s);
  if (d <= 128) return launch<T, 128>(a, s);
  return launch_wide<T>(a, s);
}

}  // namespace

// Returns a cudaError_t code; cudaErrorInvalidValue for head dims above 512
// or not a whole number of 16-byte pieces, an empty or over-long kv_len, a
// scale that is not positive, or a grid this build does not cover.
extern "C" int attention_forward(AttnArgs a, int dtype, void* stream) {
  const int64_t piece = dtype == kFloat32 ? 4 : 8;  // elements per 16 bytes
  if (a.dqk < 1 || a.dqk > kMaxHeadDim || a.dv < 1 || a.dv > kMaxHeadDim || a.dqk % piece ||
      a.dv % piece)
    return (int)cudaErrorInvalidValue;
  if (a.kv_len < 1 || a.kv_len > a.Lkv || a.Lq < 1 || a.B < 1 || a.H < 1 ||
      a.B * a.H > 65535 || !(a.scale > 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kFloat32) return launch_dim<float>(a, s);
  if (dtype == kBFloat16) return launch_dim<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// The wide route's plan for (dtype, dqk, dv), for `kernels/attention.py`'s
// mirror to be held against: out = {split, bk, nv, stages, smem bytes}.
// Returns 0, or cudaErrorInvalidValue for dims the wide route does not take.
extern "C" int attention_wide_plan(int dtype, int dqk, int dv, int32_t* out) {
  if ((dqk <= 128 && dv <= 128) || dqk > kMaxHeadDim || dv > kMaxHeadDim || dqk < 1 || dv < 1 ||
      (dtype != kFloat32 && dtype != kBFloat16))
    return (int)cudaErrorInvalidValue;
  const WidePlan w = wide_plan(dtype == kFloat32, dqk, dv);
  out[0] = w.split;
  out[1] = w.bk;
  out[2] = w.nv;
  out[3] = w.lay.stages;
  out[4] = w.lay.smem;
  return 0;
}
