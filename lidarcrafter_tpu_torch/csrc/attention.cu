// Softmax attention forward: out = softmax(scale * q . k^T) . v over the
// first kv_len keys, f32 logits and softmax, output in the operands' dtype.
//
// Replaces the TPU kernel `_attn_kernel` (lidarcrafter_tpu/ops/pallas_attention.py:40,
// called through `flash_attention` / `attention_bhld`).  Users: the
// EfficientUNet's `SelfAttention2d` (scale 1/sqrt(dh)) and the MeanFlow
// `MFSelfAttention2d` (q already scaled, scale 1), in `d_block4` and
// `u_block4`.
//
// The TPU kernel kept a whole K/V strip of a head in VMEM and took one plain
// softmax.  Here one block of 256 threads owns (batch*head, 64-query tile):
//
//   * the q tile is staged once in shared memory, transposed, as f32;
//   * a loop over 64-key tiles stages k (transposed) and v as f32; the
//     threads form a 16 x 16 grid and each scores a 4-query x 4-key patch of
//     the 64 x 64 logit tile (two 16-byte shared loads per 16 FMAs), then
//     takes the row max with shuffles across the 16 lanes that share the
//     rows and folds the tile into a running max and sum (online softmax);
//   * the tile's probabilities go through shared memory, and each thread
//     accumulates a 4-query x (D/16)-column patch of the output;
//   * keys past kv_len score -inf inside the last tile; tiles past it are
//     never loaded.
//
// Operands are read, and the output written, through their (batch, head,
// row) strides: the per-head views of a fused (B, L, 3C) projection need no
// copy and the output lands directly in (B, L, heads*dv) order.  Head dims
// up to 128 are zero-padded to D = 32, 64 or 128 inside shared memory.
//
// Bound on the H100 at the main shape (B=8, 8 heads, L=512, d=64): in f32,
// operations: 4 * 64 * 512 * 512 * 64 = 4.3 GFLOP, 0.064 ms at the 67
// TFLOP/s f32 peak, against 34 MB of operands and output (0.010 ms).  In
// bf16 the tensor cores would make it bound by bytes (17 MB, 0.005 ms).  This
// first version runs every product as f32 FMAs on the CUDA cores, which keeps
// f32 inputs exact (TF32 would not hold 1e-4); bf16 inputs are widened on
// load.  mma.sync / wgmma for bf16, TMA staging and deeper register tiles
// are later work.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

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

constexpr int BQ = 64;    // queries per block
constexpr int BK = 64;    // keys per shared-memory tile
constexpr int NT = 256;   // threads: a 16 x 16 grid, 4 x 4 logits each
constexpr int PAD = 4;    // row padding (floats) of the shared tiles
constexpr int LDQ = BQ + PAD;  // row length of the transposed q and p tiles
constexpr int LDK = BK + PAD;  // row length of the transposed k tile
constexpr unsigned FULL = 0xffffffffu;

template <int D>
struct Layout {
  static constexpr int kQ = D * LDQ;        // qs [D][LDQ]
  static constexpr int kK = D * LDK;        // ks [D][LDK]
  static constexpr int kV = BK * (D + PAD); // vs [BK][D + PAD]
  static constexpr int kP = BK * LDQ;       // ps [BK][LDQ]
  static constexpr size_t bytes = sizeof(float) * (kQ + kK + kV + kP);
  // output columns per thread: NV groups of VEC adjacent columns
  static constexpr int VEC = D >= 64 ? 4 : 2;
  static constexpr int NV = D / (16 * VEC);
  static constexpr int CW = VEC * NV;
};

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) attention_fwd_kernel(const AttnArgs a) {
  using L = Layout<D>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;          // q tile, transposed: qs[d * LDQ + row]
  float* ks = qs + L::kQ;    // k tile, transposed: ks[d * LDK + key]
  float* vs = ks + L::kK;    // v tile: vs[key * (D + PAD) + col]
  float* ps = vs + L::kV;    // probabilities, transposed: ps[key * LDQ + row]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const int Lq = (int)a.Lq, kv_len = (int)a.kv_len;
  const int dqk = (int)a.dqk, dv = (int)a.dv;
  const float scale = (float)a.scale;

  const T* q = (const T*)a.q + b * a.q_s[0] + h * a.q_s[1];
  const T* k = (const T*)a.k + b * a.k_s[0] + h * a.k_s[1];
  const T* v = (const T*)a.v + b * a.v_s[0] + h * a.v_s[1];

  // q tile, zero past Lq and past dqk; consecutive threads read consecutive
  // columns of one row, so the global reads coalesce
  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D;
    qs[c * LDQ + r] = (q0 + r < Lq && c < dqk)
                          ? to_f<T>(q[(int64_t)(q0 + r) * a.q_s[2] + c]) : 0.0f;
  }

  float o[4][L::CW];
  float m[4], l[4];  // running max; this thread's share of the running sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < L::CW; ++c) o[i][c] = 0.0f;
  }

  const int n_tiles = (kv_len + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK, nk = min(BK, kv_len - k0);
    __syncthreads();  // the previous tile (and the q staging) is done
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, c = e % D;
      const int64_t row = k0 + r;
      ks[c * LDK + r] = (r < nk && c < dqk) ? to_f<T>(k[row * a.k_s[2] + c]) : 0.0f;
      vs[r * (D + PAD) + c] = (r < nk && c < dv) ? to_f<T>(v[row * a.v_s[2] + c]) : 0.0f;
    }
    __syncthreads();

    // logits of rows ty*4 + i against keys tx*4 + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + d * LDQ + ty * 4);
      const float4 kb = *reinterpret_cast<const float4*>(ks + d * LDK + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax: every row has at least key k0 unmasked, so m_new is
    // finite and corr = exp(-inf) = 0 on the first tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (tx * 4 + j < nk) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int c = 0; c < L::CW; ++c) o[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ps + (tx * 4 + j) * LDQ + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // o += p . v over the tile; masked keys have p = 0 and zero v rows
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(ps + j * LDQ + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float* vr = vs + j * (D + PAD) + tx * L::VEC;
      float vv[L::CW];
#pragma unroll
      for (int u = 0; u < L::NV; ++u) {
        if constexpr (L::VEC == 4) {
          const float4 w = *reinterpret_cast<const float4*>(vr + u * 64);
          vv[4 * u + 0] = w.x;
          vv[4 * u + 1] = w.y;
          vv[4 * u + 2] = w.z;
          vv[4 * u + 3] = w.w;
        } else {
          const float2 w = *reinterpret_cast<const float2*>(vr + u * 32);
          vv[2 * u + 0] = w.x;
          vv[2 * u + 1] = w.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < L::CW; ++c) o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
    }
  }

  T* out = (T*)a.out + b * a.out_s[0] + h * a.out_s[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.0f / row_sum16(l[i]);
    const int row = q0 + ty * 4 + i;
    if (row >= Lq) continue;
#pragma unroll
    for (int c = 0; c < L::CW; ++c) {
      const int col = (c / L::VEC) * 16 * L::VEC + tx * L::VEC + c % L::VEC;
      if (col < dv) out[(int64_t)row * a.out_s[2] + col] = from_f<T>(o[i][c] * inv);
    }
  }
}

template <typename T, int D>
int launch(const AttnArgs& a, dim3 grid, cudaStream_t s) {
  const size_t bytes = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  attention_fwd_kernel<T, D><<<grid, NT, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const AttnArgs& a, dim3 grid, cudaStream_t s) {
  const int64_t d = a.dqk > a.dv ? a.dqk : a.dv;
  if (d <= 32) return launch<T, 32>(a, grid, s);
  if (d <= 64) return launch<T, 64>(a, grid, s);
  return launch<T, 128>(a, grid, s);
}

}  // namespace

// Returns a cudaError_t code; cudaErrorInvalidValue for head dims above 128,
// an empty or over-long kv_len, or a grid this build does not cover.
extern "C" int attention_forward(AttnArgs a, int dtype, void* stream) {
  if (a.dqk < 1 || a.dqk > 128 || a.dv < 1 || a.dv > 128) return (int)cudaErrorInvalidValue;
  if (a.kv_len < 1 || a.kv_len > a.Lkv || a.Lq < 1 || a.B < 1 || a.H < 1 ||
      a.B * a.H > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((a.Lq + BQ - 1) / BQ), (unsigned)(a.B * a.H));
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kFloat32) return launch_dim<float>(a, grid, s);
  if (dtype == kBFloat16) return launch_dim<__nv_bfloat16>(a, grid, s);
  return (int)cudaErrorInvalidValue;
}
