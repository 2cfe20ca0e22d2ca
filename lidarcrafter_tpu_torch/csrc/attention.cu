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
// may differ from dv.  Head dims from 129 to 512 (OpenAIUNet's one head as
// wide as the block: 256 and 512) take a second kernel,
// `attention_fwd_wide_kernel` below, which splits dqk into 128-wide chunks
// and dv into 128-wide slices.  Every pointer and stride is 16-byte
// aligned (the wrapper checks it), as cp.async needs.  The GLIDE block's
// keys and values are its encoder's tokens followed by the image's (Lkv =
// 13 + Lq on the layout stacks).
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

#include "flash_mma.cuh"

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
//
// Head dims above 128 (up to kMaxHeadDim): the shared tiles of the kernel
// above would not fit (a 64-row f32 q tile at d = 512 is 128 KB, and two
// K/V stages of 64 x 512 would be 512 KB).  Here a block owns 64 query rows
// and one WD-wide slice of dv (grid.z = ceil(dv / WD)).  Its whole q tile
// sits in shared memory, dqk padded to whole WD-wide chunks; each key tile
// comes in as a stream of items through two WD-wide buffers: the tile's K
// in nq = ceil(dqk / WD) chunks, then the tile's V slice.  For a K chunk
// the warps load that chunk of their Q fragments from the q tile and add
// its products to the logits S, kept in registers across the chunks; for
// the V slice they fold S into the online softmax and O.  Each item loads
// while the one before it is used (cp.async, one group ahead).  So every
// block recomputes S: the products of Q K^T run ceil(dv / WD) times.
// This is the simple design; a wgmma / TMA route would not need it.

constexpr int WD = 128;           // chunk of dqk and slice of dv
constexpr int kMaxHeadDim = 512;  // f32: a 64 x 520 q tile + two 64 x 136 buffers, 202,752 B

template <typename T>
struct WideSmem {
  static constexpr int BQ = block_rows<WD>(), LDB = ld_qk<WD>();  // 64 rows; K chunk and V rows
  // q tile row stride, padded by 8 as LDQ is (no bank conflicts)
  __host__ __device__ static int ldq(int nq) { return nq * WD + 8; }
  static size_t bytes(int nq) { return sizeof(T) * ((size_t)BQ * ldq(nq) + 2 * BK * LDB); }
};

template <typename T>
__global__ void __launch_bounds__(NT) attention_fwd_wide_kernel(const AttnArgs a) {
  using S = WideSmem<T>;
  using Warp = FlashWarp<T, WD, WD>;
  constexpr int BQ = S::BQ, LDB = S::LDB, LDV = Warp::LDV;
  static_assert(Warp::LDQ == LDB && LDV <= LDB, "a V slice fits a K chunk's buffer");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int dqk = (int)a.dqk, nq = (dqk + WD - 1) / WD, ldq = S::ldq(nq);
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sB = sQ + BQ * ldq;

  const int64_t bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BQ, v0 = blockIdx.z * WD;
  const int Lq = (int)a.Lq, kv_len = (int)a.kv_len, dvz = min(WD, (int)a.dv - v0);
  const T* q = (const T*)a.q + b * a.q_s[0] + h * a.q_s[1];
  const T* k = (const T*)a.k + b * a.k_s[0] + h * a.k_s[1];
  const T* v = (const T*)a.v + b * a.v_s[0] + h * a.v_s[1] + v0;

  for (int c = 0; c < nq; ++c)
    stage_rows<T, WD, BQ>(sQ + c * WD, ldq, q + c * WD, a.q_s[2], q0, Lq - q0, dqk - c * WD);
  // item j: part j % (nq + 1) of key tile j / (nq + 1), K chunks first, then V
  auto stage_item = [&](int j) {
    const int tile = j / (nq + 1), part = j % (nq + 1);
    const int k0 = tile * BK, n = min(BK, kv_len - k0);
    T* dst = sB + (j & 1) * BK * LDB;
    if (part < nq)
      stage_rows<T, WD, BK>(dst, LDB, k + part * WD, a.k_s[2], k0, n, dqk - part * WD);
    else
      stage_rows<T, WD, BK>(dst, LDV, v, a.v_s[2], k0, n, dvz);
    cp_async_commit();
  };
  stage_item(0);  // one group with the q tile

  // the ones columns of the V rows (bf16): the K chunks write columns < WD only
  Warp::fill_ones(sB, BK);
  Warp::fill_ones(sB + BK * LDB, BK);
  Warp w;
  w.init((float)a.scale);
  float s[1][BK / 8][4];
  const int n_items = (kv_len + BK - 1) / BK * (nq + 1);
  for (int j = 0; j < n_items; ++j) {
    cp_async_wait_all();
    __syncthreads();  // item j has landed; every warp is done with item j-1
    if (j + 1 < n_items) stage_item(j + 1);  // overlaps the products of item j
    const int tile = j / (nq + 1), part = j % (nq + 1);
    const T* buf = sB + (j & 1) * BK * LDB;
    if (part < nq) {
      if (part == 0) Warp::template zero_scores<BK>(s);
      w.load_q(sQ + part * WD, ldq);
      w.template scores<BK>(s, buf);
    } else if (kv_len - tile * BK < BK) {
      w.template fold<BK, true>(s, buf, kv_len - tile * BK);
    } else {
      w.template fold<BK, false>(s, buf, BK);
    }
  }
  T* out = (T*)a.out + b * a.out_s[0] + h * a.out_s[1] + v0;
  w.store(out, a.out_s[2], q0, Lq, dvz);
}

template <typename T>
int launch_wide(const AttnArgs& a, cudaStream_t s) {
  using S = WideSmem<T>;
  const size_t bytes = S::bytes((int)((a.dqk + WD - 1) / WD));
  const dim3 grid((unsigned)((a.Lq + S::BQ - 1) / S::BQ), (unsigned)(a.B * a.H),
                  (unsigned)((a.dv + WD - 1) / WD));
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_wide_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  attention_fwd_wide_kernel<T><<<grid, NT, bytes, s>>>(a);
  return (int)cudaGetLastError();
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
