// GroupNorm + per-batch affine with the scale-shift conditioning folded in +
// optional SiLU over a channels-last (B, HW, C) tensor, in ONE launch.
//
// Replaces the TPU kernel `_gn_kernel` (lidarcrafter_tpu/ops/pallas_groupnorm.py,
// called through `fused_group_norm`).  The TPU kernel kept each image's slab
// resident in VMEM and did one HBM read and one write.  On Hopper no block
// holds a slab (up to 8 MB a level-0 image), blocks run in no order, and the
// statistics of an image need all of its blocks, so:
//
//   * each image is split into `k` blocks of contiguous rows, B*k blocks at
//     most one per SM, launched cooperatively.  Each block writes its
//     per-group partials (count, mean, M2) to global scratch; after one grid
//     sync every block merges the k partials of its image in block order,
//     so all of them get the same statistics and two calls on one input are
//     bit-identical (no float atomics).  Norms of one block an image (k = 1:
//     the token norms) skip the sync.  Thread-block clusters (one per image,
//     partials through distributed shared memory) were tried first: an H100
//     holds 7 clusters of 16 blocks at a time, so B=8 images ran in two
//     waves, and clusters of 8 left half the SMs idle;
//   * statistics are direct-variance, never E[x^2] - mean^2: a thread takes
//     the exact mean and M2 of each register chunk of kUnroll pieces and
//     folds it into its running state with one Chan merge (no division per
//     element); threads and channels, then blocks, are merged exactly in two
//     passes (mean, then M2 about it) by warp segments, in a fixed order.
//     The 26-element groups of the token norms (13 tokens x 2 channels) are
//     as exact as the 65536-element groups of level 0;
//   * the slab is read from HBM once where it fits: the first `stage_rows`
//     rows of a block (up to ~210 KB) are copied to shared memory by one TMA
//     bulk copy issued at the start, while the other rows stream through
//     registers; the staged rows are normalised
//     from shared memory, the streamed ones re-read after the sync, last
//     rows first, so the re-read finds the most recently read lines in the
//     50 MB L2 (the staged copies and the output carry evict-first hints);
//   * the per-batch affine gamma*(1+s), beta*(1+s)+t is folded in f32 from
//     the raw operands (weight, bias: (C,) or (B, C); scale, shift: (B, C)
//     views with a row stride; f32 or bf16; any of them absent) in the
//     plain version's order while the copies fly, and held in registers
//     with the channel's mean; a thread owns fixed channels, so the inner
//     loops do no 64-bit division or modulo.
//
// Bound on the H100: bytes, one read and one write of the slab; the
// arithmetic is ~10 operations per element on the CUDA cores.
//
// The azimuth-sharded norms (parallel/mesh.py, sp > 1) hold a slab whose
// statistics span every shard, so the same kernel runs as two launches
// around an exchange of B * 3 * G floats between the ranks:
//
//   * gn_partials: this shard's per-(image, group) count, mean and M2,
//     computed as above (the blocks of an image merged after a grid sync),
//     written to `stats` (B, 3, G) instead of normalising;
//   * gn_apply: every block merges the S shards' partials (S, B, 3, G), in
//     rank order, with the same two-pass merge, then normalises its rows
//     with the folded affine, scale-shift and SiLU as above.  Every rank
//     merges the same partials in the same order, so all of them get the
//     same statistics, bit for bit; with `work` given, block 0 of an image
//     writes the merged mean and 1/sigma there (B, 2, G).  No grid sync:
//     the rows are re-read from HBM (nothing is staged).

#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

// Mirror of `GnArgs` in kernels/loader.py (every field 8 bytes).
struct GnArgs {
  const void* x;
  void* y;
  const void* w;  // weight, bias, scale, shift: nullptr when absent
  const void* b;
  const void* s;
  const void* t;
  int64_t w_bs, b_bs, s_bs, t_bs;  // batch strides in elements (0: shared)
  int64_t w_dt, b_dt, s_dt, t_dt;  // dtype codes of the four operands
  void* work;                      // B * k * 3 * G floats when k > 1
  int64_t dtype, B, HW, C, G;
  int64_t k, rows_par, stage_rows, silu;  // blocks an image, rows in flight a block
  double eps;
  void* stats;      // gn_partials: (B, 3, G) out; gn_apply: (n_parts, B, 3, G) in
  int64_t n_parts;  // gn_apply: the shards whose partials `stats` holds
};

namespace {

constexpr int kUnroll = 8;        // pieces a thread streams at once
constexpr int kMaxParts = 8;      // parts a lane holds in the two-pass merges
constexpr int kMaxThreads = 512;
constexpr int kFoldPer = 8;       // channels a thread folds: C <= 8 * threads
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use

// what a launch does: the one-launch norm, a shard's partials, or the norm
// from every shard's partials
enum Mode { kFused = 0, kPartials = 1, kApply = 2 };

struct Params {
  const void* x;
  void* y;
  const void* w;
  const void* b;
  const void* s;
  const void* t;
  int64_t w_bs, b_bs, s_bs, t_bs;
  int w_dt, b_dt, s_dt, t_dt;
  float* work;
  float* stats;
  int B, HW, C, G, k, rows_per_block, stage_rows, n_parts;
  float eps;
};

// Shared memory: a 16-byte mbarrier slot, the staged rows, then scratch of
// per-thread partials [2][VEC][threads] + counts [threads], the folded gamma
// and beta [2][C], the group means and rstds [2][G] (floats).
// kernels/groupnorm.py::plan sizes the staging area with the same formula.
constexpr int scratch_bytes(int threads, int vec, int C, int G) {
  return 16 + 4 * (threads * (2 * vec + 1) + 2 * C + 2 * G);
}

template <typename T, int VEC>
using Raw = std::conditional_t<VEC * sizeof(T) == 16, uint4, uint2>;

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}
__device__ __forceinline__ uint32_t word(const uint2& r, int i) { return i == 0 ? r.x : r.y; }

// element j of a raw piece, as float (bf16 -> f32 is exact: the high half)
template <typename T, typename R>
__device__ __forceinline__ float elem(const R& r, int j) {
  if constexpr (std::is_same_v<T, float>) {
    return __uint_as_float(word(r, j));
  } else {
    const uint32_t w = word(r, j >> 1);
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> pack(const float (&v)[VEC]) {
  Raw<T, VEC> r;
  uint32_t* w = reinterpret_cast<uint32_t*>(&r);
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) w[j] = __float_as_uint(v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC / 2; ++j) {
      __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      w[j] = *reinterpret_cast<uint32_t*>(&h);
    }
  }
  return r;
}

// SiLU: in f32 y / (1 + e^-y) (two special-function operations); in bf16,
// whose output rounds to 2^-9, y * (1 + tanh(y / 2)) / 2 with the one-
// operation tanh.approx (relative error ~2^-11), which halves the load on
// the special function units that bounds the bf16 normalise pass.
template <typename T>
__device__ __forceinline__ float silu(float y) {
  if constexpr (std::is_same_v<T, float>) {
    return __fdividef(y, 1.0f + __expf(-y));
  } else {
    float th;
    asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(0.5f * y));
    return 0.5f * y * (1.0f + th);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy rows [r0, rs) of the image (contiguous) into `stage`, evict-first in
// L2: one TMA bulk copy completing on the mbarrier `bar` for 16-byte
// pieces, an 8-byte cp.async per piece (each thread its own) otherwise.
template <typename R>
__device__ __forceinline__ void issue_staging(R* stage, const R* xv, uint64_t* bar, int r0, int rs, int r_first,
                                           int rows_par, int cpr, int cv, bool active) {
  uint64_t evict_first;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(evict_first));
  if constexpr (sizeof(R) == 16) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   "fence.mbarrier_init.release.cluster;\n" ::"r"(smem_addr(bar)));
      if (rs > r0) {
        const uint32_t bytes = (uint32_t)((rs - r0) * cpr * sizeof(R));
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes));
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
            ::"r"(smem_addr(stage)), "l"(xv - cv + r0 * cpr), "r"(bytes), "r"(smem_addr(bar)), "l"(evict_first)
            : "memory");
      }
    }
  } else if (active) {
    for (int r = r_first; r < rs; r += rows_par)
      asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 8, %2;\n"
                   ::"r"(smem_addr(&stage[(r - r0) * cpr + cv])), "l"(xv + r * cpr), "l"(evict_first));
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
}

// Wait until this thread may read its staged pieces.
template <typename R>
__device__ __forceinline__ void wait_staged(uint64_t* bar, bool any) {
  if constexpr (sizeof(R) == 16) {
    if (any)
      asm volatile(
          "{\n.reg .pred done;\nWAIT:\n"
          "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
          "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)) : "memory");
  } else {
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // each thread reads back only its own pieces
  }
}

__device__ __forceinline__ float param(const void* p, int dt, int64_t i) {
  return dt == kFloat32 ? static_cast<const float*>(p)[i]
                        : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// Sum over the `width` lanes (a power of two <= 32) of a segment of the
// warp, every lane getting the segment's first lane's value (the lanes of an
// xor butterfly add in different orders).  All 32 lanes call it.
__device__ __forceinline__ float seg_sum(float v, int width) {
  for (int off = width / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off, width);
  return __shfl_sync(0xffffffffu, v, 0, width);
}

__device__ __forceinline__ int pow2_at_least(int v) { return v <= 1 ? 1 : 1 << (32 - __clz(v - 1)); }
__device__ __forceinline__ int pow2_at_most(int v) { return v <= 1 ? 1 : 1 << (31 - __clz(v)); }

// (count, mean, M2) of the union of parts (n_e, mean_e, M2_e), e < count,
// by the `width` lanes of a warp segment, exactly, in two passes:
// mean = sum n_e mean_e / n, then M2 = sum M2_e + n_e (mean_e - mean)^2.
// A lane keeps kMaxParts parts in registers, loaded at once by `part(e)`.
template <typename Part>
__device__ __forceinline__ float3 seg_merge(int count, int width, Part part) {
  const int sl = threadIdx.x % width, step = width * kMaxParts;
  float3 v[kMaxParts];
  auto load = [&](int e0) {
#pragma unroll
    for (int u = 0; u < kMaxParts; ++u) {
      const int e = e0 + sl + u * width;
      v[u] = e < count ? part(e) : make_float3(0.0f, 0.0f, 0.0f);
    }
  };
  float sn = 0.0f, ss = 0.0f;
  for (int e0 = 0; e0 < count; e0 += step) {
    load(e0);
#pragma unroll
    for (int u = 0; u < kMaxParts; ++u) {
      sn += v[u].x;
      ss = fmaf(v[u].x, v[u].y, ss);
    }
  }
  sn = seg_sum(sn, width);
  ss = seg_sum(ss, width);
  const float mean = sn > 0.0f ? ss / sn : 0.0f;
  float q = 0.0f;
  for (int e0 = 0; e0 < count; e0 += step) {
    if (count > step) load(e0);  // a single load is still in registers
#pragma unroll
    for (int u = 0; u < kMaxParts; ++u) {
      const float d = v[u].y - mean;
      q += fmaf(v[u].x * d, d, v[u].z);
    }
  }
  return make_float3(sn, mean, seg_sum(q, width));
}

template <int VEC>
struct State {
  float n = 0.0f, mean[VEC] = {}, m2[VEC] = {};
};

// Fold this thread's pieces of rows [a, e) (those r with r = r_first mod
// rows_par) into `st`, kUnroll pieces a chunk; `load(r)` gives row r's piece.
template <typename T, int VEC, typename R, typename Load>
__device__ __forceinline__ void accumulate(State<VEC>& st, int r_first, int a, int e, int rows_par,
                                           Load load) {
  const int start = r_first + (a > r_first ? (a - r_first + rows_par - 1) / rows_par * rows_par : 0);
  for (int r = start; r < e; r += kUnroll * rows_par) {
    R v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * rows_par < e) v[u] = load(r + u * rows_par);
    const int m = min(kUnroll, (e - r + rows_par - 1) / rows_par);
    const float inv_m = __frcp_rn((float)m);
    const float nn = st.n + (float)m;
    const float fb = __fdividef((float)m, nn);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (u < m) sum += elem<T>(v[u], j);
      const float cmean = sum * inv_m;
      float q = 0.0f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (u < m) {
          const float d = elem<T>(v[u], j) - cmean;
          q = fmaf(d, d, q);
        }
      const float delta = cmean - st.mean[j];
      st.mean[j] += delta * fb;
      st.m2[j] += q + delta * delta * st.n * fb;
    }
    st.n = nn;
  }
}

template <typename T, int VEC, bool SILU, int MODE>
__global__ void __launch_bounds__(kMaxThreads) gn_fused_kernel(const Params p) {
  using R = Raw<T, VEC>;
  const int C = p.C, G = p.G, HW = p.HW, cpr = C / VEC, cpg = C / G;
  const int nt = blockDim.x, t = threadIdx.x;
  const int cv = t % cpr, lane = t / cpr;
  const int rows_par = nt / cpr;  // rows in flight; threads past them only merge
  const bool active = lane < rows_par;
  const int img = blockIdx.x / p.k, part = blockIdx.x % p.k;
  const int r0 = min(HW, part * p.rows_per_block);  // rows of the image
  const int r1 = min(HW, r0 + p.rows_per_block);
  const int rs = min(r1, r0 + p.stage_rows);  // rows [r0, rs) are staged

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // 16 bytes
  R* stage = reinterpret_cast<R*>(smem + 16);
  float* p_mean = reinterpret_cast<float*>(smem + 16 + (size_t)p.stage_rows * C * sizeof(T));
  float* p_m2 = p_mean + VEC * nt;
  float* p_n = p_m2 + VEC * nt;
  float* f_gamma = p_n + nt;
  float* f_beta = f_gamma + C;
  float* s_mean = f_beta + C;
  float* s_rstd = s_mean + G;

  const R* xv = reinterpret_cast<const R*>(p.x) + (int64_t)img * HW * cpr + cv;  // row r's piece: xv[r * cpr]
  R* yv = reinterpret_cast<R*>(p.y) + (int64_t)img * HW * cpr + cv;
  const int r_first = r0 + lane;
  auto from_stage = [&](int r) { return stage[(r - r0) * cpr + cv]; };

  State<VEC> st;
  if constexpr (MODE != kApply) {
    // ---- the staged rows all in flight
    issue_staging(stage, xv, bar, r0, rs, r_first, rows_par, cpr, cv, active);
    // ---- meanwhile the other rows' statistics, streamed through registers
    if (active) accumulate<T, VEC, R>(st, r_first, rs, r1, rows_par, [&](int r) { return __ldcg(xv + r * cpr); });
  }
  // ---- and the per-batch affine, folded in f32 in the plain version's
  // order: gamma = w * (1 + s), beta = b * (1 + s) + t; all of a thread's
  // loads first, then the arithmetic (C <= kFoldPer * threads)
  if constexpr (MODE != kPartials) {
    float w[kFoldPer], b[kFoldPer], s[kFoldPer], tt[kFoldPer];
#pragma unroll
    for (int u = 0; u < kFoldPer; ++u) {
      const int c = t + u * nt;
      if (c < C) {
        w[u] = p.w ? param(p.w, p.w_dt, img * p.w_bs + c) : 1.0f;
        b[u] = p.b ? param(p.b, p.b_dt, img * p.b_bs + c) : 0.0f;
        s[u] = p.s ? param(p.s, p.s_dt, img * p.s_bs + c) : 0.0f;
        tt[u] = p.t ? param(p.t, p.t_dt, img * p.t_bs + c) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kFoldPer; ++u) {
      const int c = t + u * nt;
      if (c < C) {
        float gam = w[u], bet = b[u];
        if (p.s) {
          const float s1 = __fadd_rn(1.0f, s[u]);
          gam = __fmul_rn(gam, s1);
          bet = __fmul_rn(bet, s1);
        }
        if (p.t) bet = __fadd_rn(bet, tt[u]);
        f_gamma[c] = gam;
        f_beta[c] = bet;
      }
    }
  }
  if constexpr (MODE == kApply) {
    // ---- the image's groups from every shard's partials, in rank order
    const int ws = min(32, max(pow2_at_least((p.n_parts + kMaxParts - 1) / kMaxParts), pow2_at_most(nt / G)));
    for (int base = 0; base < G; base += nt / ws) {
      const int g = base + t / ws;
      const float3 r = seg_merge(g < G ? p.n_parts : 0, ws, [&](int e) {
        const float* w = p.stats + ((int64_t)e * p.B + img) * 3 * G + g;
        return make_float3(w[0], w[G], w[2 * G]);
      });
      if (g < G && t % ws == 0) {
        s_mean[g] = r.y;
        s_rstd[g] = 1.0f / sqrtf(r.z / r.x + p.eps);
        if (p.work && part == 0) {
          p.work[(int64_t)img * 2 * G + g] = s_mean[g];
          p.work[(int64_t)img * 2 * G + G + g] = s_rstd[g];
        }
      }
    }
  } else {
    if (sizeof(R) == 16) __syncthreads();  // the barrier's init before anyone waits on it
    if (active) {
      wait_staged<R>(bar, rs > r0);
      accumulate<T, VEC, R>(st, r_first, r0, rs, rows_par, from_stage);
    }

    // ---- the block's groups: a warp segment a group merges its (thread,
    // channel) parts
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      p_mean[j * nt + t] = st.mean[j];
      p_m2[j * nt + t] = st.m2[j];
    }
    p_n[t] = st.n;
    __syncthreads();
    // part e is (thread row e / cpg, channel e % cpg of the group); e < 2^21,
    // so the quotient by a float reciprocal is exact
    const int parts = rows_par * cpg;
    const float inv_cpg = 1.0f / (float)cpg;
    const int width = min(32, max(pow2_at_least((parts + kMaxParts - 1) / kMaxParts), pow2_at_most(nt / G)));
    for (int base = 0; base < G; base += nt / width) {
      const int g = base + t / width;
      const float3 r = seg_merge(g < G ? parts : 0, width, [&](int e) {
        const int l = (int)(((float)e + 0.5f) * inv_cpg), c = g * cpg + e - l * cpg;
        const int tt = l * cpr + c / VEC, j = c % VEC;
        return make_float3(p_n[tt], p_mean[j * nt + tt], p_m2[j * nt + tt]);
      });
      if (g < G && t % width == 0) {
        if (p.k > 1 || MODE == kPartials) {  // a block's parts, or the shard's partials
          float* w = p.k > 1 ? p.work + (int64_t)blockIdx.x * 3 * G : p.stats + (int64_t)img * 3 * G;
          w[g] = r.x;
          w[G + g] = r.y;
          w[2 * G + g] = r.z;
        } else {  // the block is the whole image
          s_mean[g] = r.y;
          s_rstd[g] = 1.0f / sqrtf(r.z / r.x + p.eps);
        }
      }
    }

    // ---- the image's groups: after the grid sync a warp segment a group
    // merges the image's k blocks' parts, in block order
    if (p.k > 1) {
      __threadfence();
      cg::this_grid().sync();
      const int wb = min(32, max(pow2_at_least((p.k + kMaxParts - 1) / kMaxParts), pow2_at_most(nt / G)));
      const float* w0 = p.work + (int64_t)img * p.k * 3 * G;
      for (int base = 0; base < G; base += nt / wb) {
        const int g = base + t / wb;
        const float3 r = seg_merge(g < G ? p.k : 0, wb, [&](int e) {
          const float* w = w0 + e * 3 * G + g;
          return make_float3(__ldcg(w), __ldcg(w + G), __ldcg(w + 2 * G));
        });
        if (g < G && t % wb == 0) {
          if (MODE == kPartials) {
            if (part == 0) {
              float* w = p.stats + (int64_t)img * 3 * G;
              w[g] = r.x;
              w[G + g] = r.y;
              w[2 * G + g] = r.z;
            }
          } else {
            s_mean[g] = r.y;
            s_rstd[g] = 1.0f / sqrtf(r.z / r.x + p.eps);
          }
        }
      }
    }
    if constexpr (MODE == kPartials) return;
  }
  __syncthreads();
  if (!active) return;

  // ---- normalise: per-channel mean, scale and shift in registers
  float mu[VEC], sc[VEC], sh[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = cv * VEC + j, g = c / cpg;
    mu[j] = s_mean[g];
    sc[j] = s_rstd[g] * f_gamma[c];
    sh[j] = f_beta[c];
  }
  auto apply = [&](const R& v) {
    float o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float y = fmaf(elem<T>(v, j) - mu[j], sc[j], sh[j]);
      if (SILU) y = silu<T>(y);
      o[j] = y;
    }
    return pack<T, VEC>(o);
  };
  // staged rows from shared memory
#pragma unroll 4
  for (int r = r_first; r < rs; r += rows_par) __stcs(yv + r * cpr, apply(from_stage(r)));
  // streamed rows from L2, last first
  if (r1 - 1 < r_first) return;
  for (int r = r_first + (r1 - 1 - r_first) / rows_par * rows_par; r >= rs; r -= kUnroll * rows_par) {
    R v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r - u * rows_par >= rs) v[u] = __ldcs(xv + (r - u * rows_par) * cpr);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r - u * rows_par >= rs) __stcs(yv + (r - u * rows_par) * cpr, apply(v[u]));
  }
}

template <typename T, int VEC, bool SILU, int MODE>
int launch(const GnArgs& a, cudaStream_t stream) {
  auto kernel = gn_fused_kernel<T, VEC, SILU, MODE>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int C = (int)a.C, G = (int)a.G, cpr = C / VEC;
  const int threads = ((int)a.rows_par * cpr + 31) / 32 * 32;
  const int64_t rows_per_block = (a.HW + a.k - 1) / a.k;
  const int64_t smem = a.stage_rows * C * (int64_t)sizeof(T) + scratch_bytes(threads, VEC, C, G);
  if (threads > kMaxThreads || smem > kSmemMax || a.stage_rows > rows_per_block || a.HW > INT32_MAX / C ||
      C > kFoldPer * threads ||
      (MODE != kApply && a.k > 1 && !a.work) || (MODE != kFused && !a.stats) ||
      (MODE == kApply && (a.n_parts < 1 || a.stage_rows != 0)))
    return (int)cudaErrorInvalidValue;

  Params p;
  p.x = a.x; p.y = a.y; p.w = a.w; p.b = a.b; p.s = a.s; p.t = a.t;
  p.w_bs = a.w_bs; p.b_bs = a.b_bs; p.s_bs = a.s_bs; p.t_bs = a.t_bs;
  p.w_dt = (int)a.w_dt; p.b_dt = (int)a.b_dt; p.s_dt = (int)a.s_dt; p.t_dt = (int)a.t_dt;
  p.work = static_cast<float*>(a.work);
  p.stats = static_cast<float*>(a.stats);
  p.n_parts = (int)a.n_parts;
  p.B = (int)a.B; p.HW = (int)a.HW; p.C = C; p.G = G; p.k = (int)a.k;
  p.rows_per_block = (int)rows_per_block;
  p.stage_rows = (int)a.stage_rows;
  p.eps = (float)a.eps;

  const dim3 grid((unsigned)(a.B * a.k)), block((unsigned)threads);
  if (a.k > 1 && MODE != kApply) {  // every block resident at once: the caller keeps B * k <= SMs
    void* args[] = {&p};
    const cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel, grid, block, args, (size_t)smem, stream);
    if (err != cudaSuccess) return (int)err;
  } else {
    kernel<<<grid, block, (size_t)smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <bool SILU, int MODE>
int dispatch(const GnArgs& a, cudaStream_t stream) {
  if (a.dtype == kFloat32) return launch<float, 4, SILU, MODE>(a, stream);
  if (a.C % 8 == 0) return launch<__nv_bfloat16, 8, SILU, MODE>(a, stream);
  return launch<__nv_bfloat16, 4, SILU, MODE>(a, stream);
}

bool valid(const GnArgs& a) {
  return a.B > 0 && a.HW > 0 && a.C > 0 && a.G > 0 && a.C % a.G == 0 && a.C % 4 == 0 && a.k >= 1 && a.k <= a.HW &&
         a.rows_par >= 1 && a.stage_rows >= 0 && (a.dtype == kFloat32 || a.dtype == kBFloat16);
}

}  // namespace

// x, y: (B, HW, C) contiguous, 16-byte aligned; B * k blocks, k to an image
// (k > 1: cooperative, at most one block per SM).  Returns a cudaError_t code.
extern "C" int gn_forward(GnArgs a, void* stream) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return a.silu ? dispatch<true, kFused>(a, s) : dispatch<false, kFused>(a, s);
}

// A shard's partials: x (B, HW, C) as gn_forward takes it, `stats` (B, 3, G)
// float32 out (count, mean, M2 of each group); y and the affine unused.
extern "C" int gn_partials(GnArgs a, void* stream) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  return dispatch<false, kPartials>(a, (cudaStream_t)stream);
}

// The norm of a shard from every shard's partials, `stats` (n_parts, B, 3, G)
// float32 in rank order; nothing staged (stage_rows 0), no grid sync; `work`,
// when given, takes the merged mean and 1/sigma (B, 2, G).
extern "C" int gn_apply(GnArgs a, void* stream) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return a.silu ? dispatch<true, kApply>(a, s) : dispatch<false, kApply>(a, s);
}
