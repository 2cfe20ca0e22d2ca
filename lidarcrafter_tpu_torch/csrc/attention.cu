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
// softmax.  Here the strip streams through the warp-specialised Hopper core
// of hopper_flash.cuh (`Attn` below): a TMA producer warp fills a ring of
// K/V stages (tensor maps built per call over the operands' strides, rows
// past kv_len and columns past the head dims zero-filled, no tile past
// kv_len loaded; keys past kv_len score -inf inside the last tile), and two
// consumer warpgroups fold the key tiles into an online softmax.  Q K^T runs
// once per (query tile, key tile) for the whole dv.  Tiles and shared memory
// (227 KB a block), by `core_plan`:
//
//   * head dims up to 128 (the EfficientUNet's 64 and 32, GLIDE's 32): 128
//     query rows a block, each consumer its own 64, both dims padded to 32,
//     64 or 128.  bf16 on wgmma with the q tile in registers: at 32 every
//     q / k / v row is one 64-byte chunk (64B swizzle), 64-key tiles, two
//     blocks an SM (80 registers at launch, 104 a consumer thread: a block's
//     softmax runs while the other's products do); at 64 and 128, 128-key
//     tiles, one block an SM.  At d = 64: q 16 KB + 4 stages x 32 KB.
//   * bf16, dqk and dv <= 256: each consumer its own 64 rows and the whole
//     dv (an m64n128 or m64n256 f32 accumulator, <= 128 registers a thread);
//     80-key stages of K (80 x dqk) and V (80 x 128 or 256): S is m64n80,
//     whose operands' shared-memory reads per key are 10% below m64n64's,
//     and two stages still fit.  At d = 256: q 64 KB + 2 stages x 80 KB.
//   * bf16 above 256: 64 query rows shared by both consumers: each
//     computes S over half of dqk's 64-column chunks, the halves are summed
//     through shared memory, and each computes P V on half of dv (128 or
//     256 columns).  32-key stages.  At d = 512: q 64 KB + 2 x 64 KB stages
//     + 32 KB of score exchange = 224 KB.
//   * f32 (3xTF32), above 128: the split block above, its products on
//     mma.sync m16n8k8 (wgmma takes tf32 only K-major, and V is MN-major);
//     32-key stages where two fit, else 16.
//
// f32 at head dims up to 128 stays on the cp.async + mma.sync loader of
// flash_mma.cuh (`launch` below, by the fixed rule `takes_mma`): one block
// of 4 warps per (batch*head, query tile), 128 queries up to head dim 64,
// else 64, the q tile and two stages of 64-key k/v tiles filled with
// cp.async, D = 32, 64 or 128 zero-padded in shared memory.  Its warps own
// 32 query rows, so each K / V fragment is split into its tf32 parts once
// for two products; a core consumer's warp owns 16 (wgmma's m64 over 4
// warps), and the core measured 1.3-1.6x slower there.  Every route stays
// reachable by name (`attention_forward_on`), for the kernel table.
//
// Operands are read, and the output written, through their (batch, head,
// row) strides: the per-head views of a fused (B, L, 3C) projection need no
// copy and the output lands directly in (B, L, heads*dv) order.  dqk may
// differ from dv.  Every pointer and stride is 16-byte aligned (the wrapper
// checks it), as cp.async and TMA need.  The GLIDE block's keys and values
// are its encoder's tokens followed by the image's (Lkv = 13 + Lq on the
// layout stacks).
//
// Bound on the H100 at the main shape (B=8, 8 heads, L=512, d=64), 4 *
// 64 * 512 * 512 * 64 = 4.3 GFLOP:
//   * bf16 (wgmma): bytes, 17 MB of operands and output, 0.005 ms (the
//     products alone are 0.004 ms at 989 TFLOP/s);
//   * f32 (3xTF32): operations, three TF32 products per product, 0.026 ms
//     at 495 / 3 TFLOP/s, against 34 MB (0.010 ms).
// At this size the call is launch- and latency-bound (256 blocks of 4
// key tiles); what remains beside the tensor cores is the softmax's
// exponentials (one per logit on the special function units) and the
// per-tile synchronisation.

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

// ---------------------------------------------------------- the cp.async + mma.sync loader
//
// f32 at head dims up to 128 (`takes_mma`); any dtype by name.

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

// ---------------------------------------------------------- the Hopper core

constexpr int kMaxHeadDim = 512;

struct AttnParams {
  CUtensorMap q, k, v;  // K and V over their first kv_len rows
  int32_t kv_len;
  hflash::Common c;
};

// One instantiation of the core for attention: QH 64-byte chunks end a
// q / k row (a bf16 head of 32: the whole row), NQ > 0 holds the bf16 q
// tile in registers; a V row is the plan's nvt 128-byte chunks, or one
// 64-byte chunk where NV bf16 columns are 64 bytes.
template <typename T, bool SPLIT, int BK, int NV, int NQ = 0, int QH = 0, int MB = 1>
struct Attn {
  using Type = T;
  using Params = AttnParams;
  static constexpr bool kSplit = SPLIT;
  static constexpr int kBK = BK, kNV = NV, kNQ = NQ, kQH = QH, kMinBlocks = MB;
  static constexpr int E = (int)sizeof(T), CW = hflash::CHUNK / E, HW = hflash::HALF / E;

  // chunk c of a q / k row (nqc 128-byte chunks, then QH 64-byte ones) in a
  // tile of `rows` rows: its byte offset and first column
  static __device__ __forceinline__ void chunk(int c, int nqc, int rows, int& off, int& col) {
    off = c < nqc ? c * rows * hflash::CHUNK : nqc * rows * hflash::CHUNK + (c - nqc) * rows * hflash::HALF;
    col = c < nqc ? c * CW : nqc * CW + (c - nqc) * HW;
  }

  static __device__ __forceinline__ void load_q(const Params& p, unsigned char* sQ, uint64_t* bar,
                                                int q0, int h, int b) {
    for (int g = 0; g < (SPLIT ? 1 : 2); ++g)
      for (int c = 0; c < p.c.lay.nqc + QH; ++c) {
        int off, col;
        chunk(c, p.c.lay.nqc, hflash::ROWS, off, col);
        hflash::tma_load(sQ + g * p.c.lay.q_wg + off, &p.q, bar, col, q0 + hflash::ROWS * g, h, b);
      }
  }

  static __device__ __forceinline__ void load_k(const Params& p, unsigned char* sk, uint64_t* bar,
                                                int t, int h, int b) {
    for (int c = 0; c < p.c.lay.nqc + QH; ++c) {
      int off, col;
      chunk(c, p.c.lay.nqc, BK, off, col);
      hflash::tma_load(sk + off, &p.k, bar, col, t * BK, h, b);
    }
  }

  static __device__ __forceinline__ void load_v(const Params& p, unsigned char* sv, uint64_t* bar,
                                                int t, int h, int b) {
    if (p.c.lay.nvt == 0) hflash::tma_load(sv, &p.v, bar, 0, t * BK, h, b);  // one 64-byte chunk
    for (int c = 0; c < p.c.lay.nvt; ++c)
      hflash::tma_load(sv + c * BK * hflash::CHUNK, &p.v, bar, c * CW, t * BK, h, b);
  }

  static __device__ __forceinline__ int valid(const Params& p, int t) {
    return min(BK, p.kv_len - t * BK);
  }
};

// The core's tiling for (dqk, dv); `kernels/attention.py::plan` mirrors it.
//
//   * Head dims up to 128: the block's 128 query rows each consumer's own
//     64, both dims padded to d = 32, 64 or 128 (the larger, rounded up;
//     TMA zero-fills the columns past each), O d wide.  bf16: the q tile in
//     registers (d / 16 k16 steps); a head of 32 in 64-byte chunks (one
//     dense 64-byte row: half the shared memory and none of the Q K^T work
//     of a zero-filled 128-byte one), 64-key tiles and two blocks an SM (the
//     consumers at 104 registers: S 32, P 16, O 16, q 8); 64 and 128,
//     128-key tiles, one block an SM.  f32 64-key tiles.  As many stages as
//     fit, at most 4.
//   * Wider, bf16 with both dims <= 256: not split, 80-key tiles, O as wide
//     as dv (128 or 256 columns).  Otherwise split, each consumer's O half
//     as wide (128 or 256 columns); 32-key tiles, except in f32 where a
//     256-column half or fewer than two stages of 32 keys take 16.
struct Plan {
  int split, bk, nv, nq, qh, blocks;  // blocks: an SM's
  hflash::Layout lay;
};

inline Plan core_plan(bool f32, int dqk, int dv) {
  const int e = f32 ? 4 : 2, cw = hflash::CHUNK / e;
  Plan w{};
  w.blocks = 1;
  const int d = dqk > dv ? dqk : dv;
  if (d <= 128) {
    const int dp = d <= 32 ? 32 : d <= 64 ? 64 : 128, row = dp * e;
    w.split = 0;
    w.nv = dp;
    w.bk = f32 || dp == 32 ? 64 : 128;
    w.blocks = !f32 && dp == 32 ? 2 : 1;
    w.nq = f32 ? 0 : dp / 16;
    w.qh = row < hflash::CHUNK ? 1 : 0;
    const int out = 2 * ((row + hflash::CHUNK - 1) / hflash::CHUNK) * hflash::ROWS * hflash::CHUNK;
    w.lay = hflash::plan_layout(false, w.bk, row, row, out, w.blocks);
    return w;
  }
  const int nqc = (dqk + cw - 1) / cw;
  if (!f32 && dqk <= 256 && dv <= 256) {
    w.split = 0;
    w.nv = dv <= 128 ? 128 : 256;
    w.bk = 80;
  } else {
    w.split = 1;
    w.nv = (dv + 1) / 2 <= 128 ? 128 : 256;
    const int half = 2 * w.nv * e;  // bytes of both halves' V row
    w.bk = f32 && (w.nv == 256 || hflash::plan_layout(true, 32, nqc * hflash::CHUNK, half,
                                                      half * hflash::ROWS).stages < 2)
               ? 16
               : 32;
  }
  const int v_row = (w.split ? 2 : 1) * w.nv * e;
  w.lay = hflash::plan_layout(w.split, w.bk, nqc * hflash::CHUNK, v_row, 2 * w.nv * e * hflash::ROWS);
  return w;
}

// One launch of problem P by plan w: the tensor maps over the operands'
// strides (a q / k row of one 64-byte chunk, a bf16 head of 32, is read
// through 64B-swizzled maps; V too where O is 64 bytes wide), then the grid.
template <class P>
int launch_core(const AttnArgs& a, const Plan& w, cudaStream_t s) {
  constexpr bool f32 = is_f32<typename P::Type>();
  if (w.lay.stages < 1) return (int)cudaErrorInvalidValue;
  AttnParams p;
  memset(&p, 0, sizeof(p));
  const int qk_w = w.qh ? hflash::HALF : hflash::CHUNK, v_w = w.lay.nvt ? hflash::CHUNK : hflash::HALF;
  int err = hflash::make_map(&p.q, a.q, f32, a.dqk, a.Lq, a.H, a.B, a.q_s, hflash::ROWS, qk_w);
  if (!err) err = hflash::make_map(&p.k, a.k, f32, a.dqk, a.kv_len, a.H, a.B, a.k_s, w.bk, qk_w);
  if (!err) err = hflash::make_map(&p.v, a.v, f32, a.dv, a.kv_len, a.H, a.B, a.v_s, w.bk, v_w);
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
  return hflash::launch_flash<P>(p, a.Lq, a.B * a.H, s);
}

template <typename T>
int launch_plan(const AttnArgs& a, cudaStream_t s) {
  const Plan w = core_plan(is_f32<T>(), (int)a.dqk, (int)a.dv);
  if constexpr (!is_f32<T>()) {
    if (w.nq) {  // head dims up to 128
      if (w.nv == 32) return launch_core<Attn<T, false, 64, 32, 2, 1, 2>>(a, w, s);
      if (w.nv == 64) return launch_core<Attn<T, false, 128, 64, 4>>(a, w, s);
      return launch_core<Attn<T, false, 128, 128, 8>>(a, w, s);
    }
    if (!w.split)
      return w.nv == 128 ? launch_core<Attn<T, false, 80, 128>>(a, w, s)
                         : launch_core<Attn<T, false, 80, 256>>(a, w, s);
    return w.nv == 128 ? launch_core<Attn<T, true, 32, 128>>(a, w, s)
                       : launch_core<Attn<T, true, 32, 256>>(a, w, s);
  } else {
    if (!w.split) {  // head dims up to 128
      if (w.nv == 32) return launch_core<Attn<T, false, 64, 32>>(a, w, s);
      if (w.nv == 64) return launch_core<Attn<T, false, 64, 64>>(a, w, s);
      return launch_core<Attn<T, false, 64, 128>>(a, w, s);
    }
    if (w.nv == 256) return launch_core<Attn<T, true, 16, 256>>(a, w, s);
    return w.bk == 32 ? launch_core<Attn<T, true, 32, 128>>(a, w, s)
                      : launch_core<Attn<T, true, 16, 128>>(a, w, s);
  }
}

// The route a call takes: the core at every head dim, except f32 at head
// dims up to 128, which stays on the cp.async + mma.sync loader above: its
// warps own 32 query rows (two m16 tiles), so each K / V fragment is split
// into its tf32 parts once for two products, where a core consumer's warp
// owns 16 (wgmma's m64 over 4 warps) and splits it for one; the core
// measured 1.3-1.6x slower there (`kernels/attention.py::route` mirrors
// the rule).
inline bool takes_mma(bool f32, int64_t d) { return f32 && d <= 128; }

template <typename T>
int launch_mma(const AttnArgs& a, cudaStream_t s) {
  const int64_t d = a.dqk > a.dv ? a.dqk : a.dv;
  if (d <= 32) return launch<T, 32>(a, s);
  if (d <= 64) return launch<T, 64>(a, s);
  return launch<T, 128>(a, s);
}

template <typename T>
int launch_dim(const AttnArgs& a, cudaStream_t s) {
  const int64_t d = a.dqk > a.dv ? a.dqk : a.dv;
  if (d <= 128 && takes_mma(is_f32<T>(), d)) return launch_mma<T>(a, s);
  return launch_plan<T>(a, s);
}

}  // namespace

// Returns a cudaError_t code; cudaErrorInvalidValue for head dims above 512
// or not a whole number of 16-byte pieces, an empty or over-long kv_len, a
// scale that is not positive, or a grid this build does not cover.
static int check_args(const AttnArgs& a, int dtype, int64_t max_d) {
  const int64_t piece = dtype == kFloat32 ? 4 : 8;  // elements per 16 bytes
  if (a.dqk < 1 || a.dqk > max_d || a.dv < 1 || a.dv > max_d || a.dqk % piece || a.dv % piece)
    return (int)cudaErrorInvalidValue;
  if (a.kv_len < 1 || a.kv_len > a.Lkv || a.Lq < 1 || a.B < 1 || a.H < 1 || a.B * a.H > 65535 ||
      !(a.scale > 0) || (dtype != kFloat32 && dtype != kBFloat16))
    return (int)cudaErrorInvalidValue;
  return 0;
}

extern "C" int attention_forward(AttnArgs a, int dtype, void* stream) {
  if (int err = check_args(a, dtype, kMaxHeadDim)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == kFloat32 ? launch_dim<float>(a, s) : launch_dim<__nv_bfloat16>(a, s);
}

// One route by name, whatever `takes_mma` says (route 0: the core; 1: the
// cp.async + mma.sync loader, head dims up to 128): the routes side by side
// on the same operands in one process, for the kernel table's comparison.
extern "C" int attention_forward_on(AttnArgs a, int dtype, int route, void* stream) {
  if (int err = check_args(a, dtype, route == 1 ? 128 : kMaxHeadDim)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 0) return dtype == kFloat32 ? launch_plan<float>(a, s) : launch_plan<__nv_bfloat16>(a, s);
  if (route == 1) return dtype == kFloat32 ? launch_mma<float>(a, s) : launch_mma<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// The core's plan for (dtype, dqk, dv), for `kernels/attention.py`'s
// mirror to be held against: out = {split, bk, nv, blocks an SM, stages,
// smem bytes}.
// Returns 0, or cudaErrorInvalidValue for dims the kernel does not take.
extern "C" int attention_plan(int dtype, int dqk, int dv, int32_t* out) {
  if (dqk > kMaxHeadDim || dv > kMaxHeadDim || dqk < 1 || dv < 1 ||
      (dtype != kFloat32 && dtype != kBFloat16))
    return (int)cudaErrorInvalidValue;
  const Plan w = core_plan(dtype == kFloat32, dqk, dv);
  out[0] = w.split;
  out[1] = w.bk;
  out[2] = w.nv;
  out[3] = w.blocks;
  out[4] = w.lay.stages;
  out[5] = w.lay.smem;
  return 0;
}
