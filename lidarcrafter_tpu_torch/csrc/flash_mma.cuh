// The cp.async + mma.sync flash-attention loader of the port's two attention
// kernels (csrc/attention.cu, csrc/oaca.cu): their f32 route at the narrow
// head dims (attention up to 128, OACA's 32-wide builds), and in bf16 the
// route the Hopper core (hopper_flash.cuh) replaced, kept reachable by name
// for the kernel table's comparison.  The core also takes its helpers
// (`mma_3xtf32`, `split_tf32`, `ex2`, `pack_bf16`, `ldsm_x4`).
//
// One block of 4 warps owns 128 query rows (32 per warp; 64 and 16 at head
// dim 128, see `m_tiles`) of one (batch, head).  The caller stages its Q
// tile and its 64-key K/V tiles into shared memory with `stage_rows`
// (16-byte cp.async.cg copies, zero-filled past the last row and past the
// head dim), two K/V stages so that the next tile loads while this one is
// used, and hands each tile to `FlashWarp::attend`, which folds it into an
// online softmax kept in registers:
//
//   S = Q K^T                    (f32 accumulators)
//   m = max(m, rowmax S);  P = 2^(log2(e) * scale * (S - m));  corr = ...
//   l = l * corr + rowsum P;  O = O * corr + P V
//
// with the scale applied to the f32 logits inside the exponent, and
// `FlashWarp::store` writes O / l.  A row's maximum is taken over the four
// lanes (a quad) that share it with two __shfl_xor_sync.  Keys at or past
// the caller's valid count score -inf (only the last tile of a strip is
// masked).
//
// Two routes, picked by the operand type T:
//
// * bf16: mma.sync.m16n8k16 bf16 x bf16 -> f32.  Q is held as A fragments
//   (ldmatrix.x4), K fragments come from ldmatrix.x4, V fragments from
//   ldmatrix.x4.trans.  P is rounded to bf16 in registers and reused as the
//   A fragment of P V: the accumulators of two adjacent n8 tiles of S are
//   exactly one k16 A fragment, so P never touches shared memory.  Rounding
//   P to the value type is what the TPU kernels do (`w.astype(v.dtype)`).
// * f32: 3xTF32 on mma.sync.m16n8k8 tf32 x tf32 -> f32.  Each operand x
//   splits into big = tf32(x) and small = tf32(x - big); a product is
//   small*big + big*small + big*big, accumulated in f32, which keeps ~22
//   mantissa bits (TF32 alone keeps 10 and misses the 1e-4 limit).  P V uses
//   the same split.  The m16n8k8 A fragment wants columns t and t+4 of a
//   thread's rows where the S accumulator holds columns 2t and 2t+1, so the
//   k index of every 8-wide chunk is permuted (A column t <-> key 2t, A
//   column t+4 <-> key 2t+1) and the B fragments are read with the same
//   permutation: P is reused in registers with no shuffle and no shared
//   tile.  The permutation is applied to Q K^T's head dim as well, which
//   turns each fragment read into one 64-bit shared load.
//
// Shared tiles are padded so that no fragment read has a bank conflict:
// bf16 rows by 16 bytes (the 8 rows of an ldmatrix fall on 8 distinct
// 16-byte bank groups); f32 Q/K rows by 8 floats (a half-warp's 64-bit
// loads hit 32 distinct banks); f32 V rows by 4 floats (rows 2t and 2t+1 of
// the permuted B fragment fall 8 banks apart).

#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace flash {

constexpr int BK = 64;     // keys per shared K/V tile
constexpr int NWARP = 4;
constexpr int NT = 32 * NWARP;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__host__ __device__ constexpr bool is_f32() { return std::is_same<T, float>::value; }

// row strides (elements) of the shared Q/K tiles and V tiles of D columns
template <int D>
__host__ __device__ constexpr int ld_qk() { return D + 8; }
template <typename T, int D>
__host__ __device__ constexpr int ld_v() { return is_f32<T>() ? D + 4 : D + 8; }

// ------------------------------------------------------------ async copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid == false nothing is read (src-size
// 0) and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy rows [r0, r0 + n) of a row-strided operand (columns [0, d)) into
// rows 0..nr-1, columns [0, W) of a shared tile with row stride ld; rows at
// or past n and columns at or past d are zero-filled.  Consecutive threads
// copy consecutive 16-byte pieces of a row, so the global reads coalesce.
// The caller guarantees 16-byte alignment of src, src_ld and d (the
// wrappers check it).  `stage_rows` takes nr at compile time, so that its
// loop unrolls into straight-line copies (the per-tile path);
// `stage_rows_n` takes it at run time (the layout strip, once per block).
template <typename T, int W>
__device__ __forceinline__ void stage_piece(T* dst, int ld, const T* src, int64_t src_ld,
                                            int64_t r0, int n, int d, int i) {
  constexpr int E = 16 / sizeof(T);  // elements per copy
  constexpr int C = W / E;           // copies per row
  const int r = i / C, c = (i % C) * E;
  const bool ok = r < n && c < d;
  cp_async16(dst + r * ld + c, ok ? src + (r0 + r) * src_ld + c : src, ok);
}

template <typename T, int W, int NR>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, int64_t src_ld,
                                           int64_t r0, int n, int d) {
  constexpr int P = NR * W / (16 / sizeof(T));  // pieces
#pragma unroll
  for (int j = 0; j < (P + NT - 1) / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    if (P % NT == 0 || i < P) stage_piece<T, W>(dst, ld, src, src_ld, r0, n, d, i);
  }
}

template <typename T, int W>
__device__ __forceinline__ void stage_rows_n(T* dst, int ld, int nr, const T* src, int64_t src_ld,
                                             int64_t r0, int n, int d) {
  for (int i = threadIdx.x; i < nr * (W / (16 / (int)sizeof(T))); i += NT)
    stage_piece<T, W>(dst, ld, src, src_ld, r0, n, d, i);
}

// ------------------------------------------------------------ tensor cores

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b, m16n8k8, tf32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (nearest, ties away from zero, as cvt.rna.tf32.f32)
// with two integer operations; operands are finite
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c += a b in 3xTF32: small*big + big*small + big*big, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(c, a_small, b_big[0], b_big[1]);
  mma_tf32(c, a_big, b_small[0], b_small[1]);
  mma_tf32(c, a_big, b_big[0], b_big[1]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------ one warp

// Query rows per warp, in m16 tiles: two up to head dim 64, so that every
// K/V fragment read from shared memory (and, on the 3xTF32 route, split)
// feeds two MMAs; one at head dim 128, where two would not fit the
// registers.
template <int D>
__host__ __device__ constexpr int m_tiles() { return D > 64 ? 1 : 2; }

// query rows of a block
template <int D>
__host__ __device__ constexpr int block_rows() { return NWARP * 16 * m_tiles<D>(); }

__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 16 * MT query rows of one warp: Q fragments, output accumulators and
// the online-softmax state of rows g = lane/4 and g + 8 of each m16 tile
// (this thread's share).  The scale must be positive: row maxima are taken
// on the raw logits and the scale is folded into the exponent.
//
// On the bf16 route the row sums come out of the tensor cores too: the 8
// padding columns of every shared V row hold ones (`fill_ones`), and one
// more n8 tile of P V over them accumulates sum_k P[row, k] -- over the
// same bf16-rounded P as the output, rescaled with it, and with no
// per-logit additions or closing shuffles.
template <typename T, int DQK, int DV, int MT = m_tiles<(DQK > DV ? DQK : DV)>()>
struct FlashWarp {
  static constexpr bool kF32 = is_f32<T>();
  static constexpr int LDQ = ld_qk<DQK>();
  static constexpr int LDV = ld_v<T, DV>();
  static constexpr int KQ = kF32 ? DQK / 8 : DQK / 16;  // k steps of Q K^T
  static constexpr int NO = DV / 8 + (kF32 ? 0 : 1);    // n8 tiles of O (+ row sums)
  static_assert(DQK % 32 == 0 && DV % 16 == 0, "head dims are padded to 32, 64 or 128");

  uint32_t q[MT][KQ][4];  // A fragments of Q (f32 bits on the 3xTF32 route)
  float o[MT][NO][4];
  float m[MT][2], l[MT][2];  // running max (raw logits); 3xTF32: this thread's part of the sum
  float scale_log2;
  int lane, row0;  // row0: the warp's first row of the block's tile

  // ones into the padding columns DV..DV+7 of rows 0..rows-1 of a shared V
  // tile (bf16 route; cp.async never writes them)
  static __device__ __forceinline__ void fill_ones(T* sV, int rows) {
    if constexpr (!kF32) {
      const uint4 ones = make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u);
      for (int r = threadIdx.x; r < rows; r += NT)
        *reinterpret_cast<uint4*>(sV + r * LDV + DV) = ones;
    }
  }

  __device__ __forceinline__ void init(float scale) {
    lane = threadIdx.x & 31;
    row0 = (threadIdx.x >> 5) * 16 * MT;
    scale_log2 = scale * LOG2E;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[mt][i] = -INFINITY;
        l[mt][i] = 0.0f;
      }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.0f;
    }
  }

  // Q A-fragments from the shared Q tile (row stride ldq, LDQ unless the
  // tile is wider than DQK and this is one DQK-wide chunk of it)
  __device__ __forceinline__ void load_q(const T* sQ, int ldq = LDQ) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = row0 + mt * 16;
      if constexpr (kF32) {
        const int g = lane >> 2, t = lane & 3;
        const float* r0 = sQ + (r + g) * ldq + 2 * t;
        const float* r1 = r0 + 8 * ldq;
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk) {
          const float2 a = *reinterpret_cast<const float2*>(r0 + kk * 8);
          const float2 b = *reinterpret_cast<const float2*>(r1 + kk * 8);
          q[mt][kk][0] = __float_as_uint(a.x);  // (row g,   head dim 2t)
          q[mt][kk][1] = __float_as_uint(b.x);  // (row g+8, head dim 2t)
          q[mt][kk][2] = __float_as_uint(a.y);  // (row g,   head dim 2t+1)
          q[mt][kk][3] = __float_as_uint(b.y);  // (row g+8, head dim 2t+1)
        }
      } else {
        const T* p = sQ + (r + (lane & 7) + ((lane >> 3) & 1) * 8) * ldq + (lane >> 4) * 8;
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk) ldsm_x4(q[mt][kk], p + kk * 16);
      }
    }
  }

  // Fold keys 0..NK-1 of a shared K tile (row stride LDQ) and V tile (row
  // stride LDV) into the running softmax.  NK is 64 (a full tile) or 16 (a
  // slice of the layout strip).  With MASK, keys at or past n_valid score
  // -inf; only the last tile of a strip needs it.
  template <int NK, bool MASK>
  __device__ __forceinline__ void attend(const T* sK, const T* sV, int n_valid) {
    float s[MT][NK / 8][4];
    zero_scores<NK>(s);
    scores<NK>(s, sK);
    fold<NK, MASK>(s, sV, n_valid);
  }

  template <int NK>
  static __device__ __forceinline__ void zero_scores(float (&s)[MT][NK / 8][4]) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.0f;
  }

  // S += Q K^T over the DQK columns of the loaded Q fragments and of a
  // shared K tile (row stride LDQ): one DQK-wide chunk of the head dim
  template <int NK>
  __device__ __forceinline__ void scores(float (&s)[MT][NK / 8][4], const T* sK) {
    const int g = lane >> 2, t = lane & 3;
    if constexpr (kF32) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        uint32_t ab[MT][4], as[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(q[mt][kk][e]), ab[mt][e], as[mt][e]);
        const float* kp = sK + g * LDQ + kk * 8 + 2 * t;
#pragma unroll
        for (int n = 0; n < NK / 8; ++n) {
          // B fragment: (head dim 2t, key g), (head dim 2t+1, key g)
          const float2 kv = *reinterpret_cast<const float2*>(kp + n * 8 * LDQ);
          uint32_t bb[2], bs[2];
          split_tf32(kv.x, bb[0], bs[0]);
          split_tf32(kv.y, bb[1], bs[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_3xtf32(s[mt][n], ab[mt], as[mt], bb, bs);
        }
      }
    } else {
      const T* kp = sK + ((lane & 7) + (lane >> 4) * 8) * LDQ + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
        for (int np = 0; np < NK / 16; ++np) {
          uint32_t b[4];
          ldsm_x4(b, kp + np * 16 * LDQ + kk * 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * np], q[mt][kk], b[0], b[1]);
            mma_bf16(s[mt][2 * np + 1], q[mt][kk], b[2], b[3]);
          }
        }
    }
  }

  // Fold the logits S of keys 0..NK-1 and their shared V tile (row stride
  // LDV) into the running softmax and O
  template <int NK, bool MASK>
  __device__ __forceinline__ void fold(float (&s)[MT][NK / 8][4], const T* sV, int n_valid) {
    const int g = lane >> 2, t = lane & 3;
    // online softmax; the accumulator of n tile n holds keys 8n + 2t and
    // 8n + 2t + 1 of rows g (e = 0, 1) and g + 8 (e = 2, 3)
    if constexpr (MASK) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n * 8 + 2 * t + (e & 1) >= n_valid) s[mt][n][e] = -INFINITY;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // row maxima (and sums) over two partial chains each (even and odd n
      // tiles), so that the dependent chains are half as long
      float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
      for (int n = 0; n < NK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1][n & 1] = fmaxf(mx[e >> 1][n & 1], s[mt][n][e]);
      float base[2];  // the new max in log2 units: p = 2^(s * scale_log2 - base)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float r = fmaxf(mx[i][0], mx[i][1]);
        r = fmaxf(r, __shfl_xor_sync(FULL, r, 1));
        r = fmaxf(r, __shfl_xor_sync(FULL, r, 2));
        const float m_new = fmaxf(m[mt][i], r);
        base[i] = m_new == -INFINITY ? 0.0f : m_new * scale_log2;  // no valid key yet
        const float corr = ex2(m[mt][i] * scale_log2 - base[i]);    // 0 while m is -inf
        m[mt][i] = m_new;
        l[mt][i] *= corr;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[mt][n][2 * i] *= corr;
          o[mt][n][2 * i + 1] *= corr;
        }
      }
      float sum[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
      for (int n = 0; n < NK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][n][e] = ex2(fmaf(s[mt][n][e], scale_log2, -base[e >> 1]));
          if constexpr (kF32) sum[e >> 1][n & 1] += s[mt][n][e];
        }
      if constexpr (kF32) {
#pragma unroll
        for (int i = 0; i < 2; ++i) l[mt][i] += sum[i][0] + sum[i][1];
      }
    }

    // O += P V
    if constexpr (kF32) {
      const float* vp = sV + 2 * t * LDV + g;
#pragma unroll
      for (int j = 0; j < NK / 8; ++j) {
        // A fragment of P: (g, key 2t), (g+8, key 2t), (g, key 2t+1), (g+8, key 2t+1)
        uint32_t pb[MT][4], ps[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float pa[4] = {s[mt][j][0], s[mt][j][2], s[mt][j][1], s[mt][j][3]};
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(pa[e], pb[mt][e], ps[mt][e]);
        }
        const float* v0 = vp + j * 8 * LDV;
#pragma unroll
        for (int n = 0; n < DV / 8; ++n) {
          // B fragment: (key 2t, column g), (key 2t+1, column g)
          uint32_t bb[2], bs[2];
          split_tf32(v0[n * 8], bb[0], bs[0]);
          split_tf32(v0[LDV + n * 8], bb[1], bs[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_3xtf32(o[mt][n], pb[mt], ps[mt], bb, bs);
        }
      }
    } else {
      const T* vp = sV + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDV + (lane >> 4) * 8;
      const T* vo = sV + (lane & 15) * LDV + DV;  // the ones columns
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int np = 0; np < DV / 16; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(b, vp + kk * 16 * LDV + np * 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][2 * np], a[mt], b[0], b[1]);
            mma_bf16(o[mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
        uint32_t b[2];
        ldsm_x2_trans(b, vo + kk * 16 * LDV);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(o[mt][DV / 8], a[mt], b[0], b[1]);
      }
    }
  }

  // O / l for the warp's rows of the tile starting at query q0; rows at or
  // past Lq and columns at or past dv are not written.  out points at
  // (batch, head, row 0) with row stride out_ld.
  __device__ __forceinline__ void store(T* out, int64_t out_ld, int q0, int Lq, int dv) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float sum;
        if constexpr (kF32) {
          sum = l[mt][i];
          sum += __shfl_xor_sync(FULL, sum, 1);
          sum += __shfl_xor_sync(FULL, sum, 2);
        } else {
          sum = o[mt][DV / 8][2 * i];  // every column of the ones tile holds the row sum
        }
        const float inv = 1.0f / sum;
        const int row = q0 + row0 + mt * 16 + g + 8 * i;
        if (row >= Lq) continue;
        T* orow = out + (int64_t)row * out_ld;
#pragma unroll
        for (int n = 0; n < DV / 8; ++n) {
          const int col = n * 8 + 2 * t;
          if (col >= dv) continue;
          const float x = o[mt][n][2 * i] * inv, y = o[mt][n][2 * i + 1] * inv;
          if constexpr (kF32)
            *reinterpret_cast<float2*>(orow + col) = make_float2(x, y);
          else
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x, y);
        }
      }
  }
};

}  // namespace flash
