// Hopper flash-attention core shared by the attention kernel (csrc/
// attention.cu: bf16 at every head dim, 8-512; f32 above 128) and OACA
// (csrc/oaca.cu: bf16 at (32, 16 | 32 | 64, 32) and (64, 64, 64); f32 at
// (64, 64, 64)).  f32 at the narrow head dims stays on flash_mma.cuh's
// cp.async loader by a fixed rule (see the kernels' headers); the core's f32
// instantiations there remain reachable by name.  Built for sm_90a only.
//
// One block of three warpgroups (384 threads), warp-specialised:
//
//   * warpgroup 0, the producer: after `setmaxnreg.dec` to 24 registers,
//     one thread starts every load as a TMA copy (`cp.async.bulk.tensor`)
//     from a tensor map that the host builds per call over the operand's
//     own (batch, head, row) strides.  The q tile is loaded once; the key
//     tiles stream through `Layout::stages` K/V stages, K and V each paced
//     by a full and an empty `mbarrier` a stage.
//   * warpgroups 1 and 2, the consumers (`setmaxnreg.inc` to 240, or to 104
//     where a problem asks for two blocks an SM): each holds 64
//     query rows (wgmma's m64) and folds every key tile into an online
//     softmax kept in f32 registers, with the O accumulator beside it.  K of
//     a tile is released as soon as its S has landed, V once its P V has.
//     In bf16 a tile's P V is deferred by one tile: S of tile t and P V of
//     tile t-1 go out together and the softmax of tile t runs while that
//     P V is on the tensor cores; and, not split, the two consumers take
//     turns starting their products (named barriers), so that one's
//     products run while the other's softmax does.
//
// Every shared tile is cut into "chunks" of 128 or 64 bytes a row: a chunk
// holds that many bytes of each of its rows, rows packed densely, in TMA's
// swizzle of the same width (the 16-byte piece j of row r sits at piece
// j ^ (r % 8) in a 128-byte chunk, j ^ (r / 2 % 4) in a 64-byte one: the
// address bits 7-9, resp. 7-8, XORed into bits 4-6, resp. 4-5).  A q / k row
// is `Layout::nqc` 128-byte chunks followed by a problem's `kQH` 64-byte ones
// (0-2: a bf16 head of 32 is one 64-byte chunk, a dense tile of its own
// width rather than half of a zero-filled 128-byte one); a V row is nvt
// 128-byte chunks, or one 64-byte chunk where a consumer's O is 64 bytes
// wide.  A q tile's chunks hold 64 rows, a K / V tile's BK rows; every 128-
// byte chunk starts 1024-byte aligned and every 64-byte one 512-byte
// aligned, as the swizzles and the wgmma descriptors need.  Columns past a
// head dim and rows past a strip's end are zero-filled by TMA (the tensor
// map's extents are the real ones), so no tile is ever padded in device
// memory.
//
// Two consumer routes, by the operand type:
//
//   * bf16 (`ConsumerBf16`): S = Q K^T is a `wgmma` m64nBKk16 with both
//     operands in shared memory (K-major descriptors), or, where the q
//     tile's fragments fit the registers, with Q from registers (NQ k16
//     steps, over 128- and 64-byte chunks alike); P is rounded to bf16 in
//     registers, where the S accumulators of keys 16k..16k+15 are exactly
//     the A fragment of the k-th k16 step, and O += P V is a `wgmma`
//     m64nNVk16 with P from registers and V read MN-major (the transposed-B
//     descriptor spans the V chunks at its leading byte offset).
//   * f32 (`ConsumerF32`, 3xTF32): `wgmma` takes tf32 only K-major, and V
//     is MN-major in shared memory (TMA cannot transpose it), so the f32
//     route runs 3xTF32 `mma.sync` m16n8k8 inside the same warp-
//     specialised, TMA-fed block: each warp owns 16 of its warpgroup's 64
//     rows, reads its fragments from the swizzled chunks (every read
//     conflict-free in either width) and splits each operand into big +
//     small tf32 parts (flash_mma.cuh's `mma_3xtf32`).
//
// Two ways to share the work of a block (`SPLIT`):
//
//   * not split: 128 query rows, each consumer with its own 64 rows, its
//     own q tile and the whole width of O (NV <= 256 columns);
//   * split: 64 query rows shared by both consumers.  Consumer c computes
//     its half of the head dim's chunks of S = Q K^T, the two halves are
//     exchanged through shared memory (one named barrier a tile) and summed
//     in both -- a + b == b + a exactly, so both hold the same S, the same
//     softmax and the same P -- and each then computes P V on its half of
//     dv (NV columns).  S is computed once per (query tile, key tile) for
//     the whole dv, and a 64 x 512 accumulator (256 registers a thread) is
//     never needed.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace hflash {

using flash::ex2;
using flash::FULL;
using flash::LOG2E;
using flash::mma_3xtf32;
using flash::pack_bf16;
using flash::split_tf32;

constexpr int NTHREADS = 384;       // producer warpgroup + two consumers
constexpr int ROWS = 64;            // query rows of a consumer (wgmma m64)
constexpr int CHUNK = 128;          // bytes of a wide chunk's row (one 128B-swizzle span)
constexpr int HALF = 64;            // bytes of a narrow chunk's row (one 64B-swizzle span)
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use on sm_90
constexpr int kSmemLimit2 = 115712; // each of two blocks an SM (228 KB, 1 KB of it reserved a block)
constexpr int kAlign = 1024;        // slack to align the dynamic base to the swizzle repeat
constexpr int kMaxStages = 4;
constexpr int kConsumerWarps = 8;   // arrivals that release a stage
constexpr int kBarBytes = 8 * (4 * kMaxStages + 1);  // K and V full / empty rings, the q barrier

// ------------------------------------------------------------ the plan
//
// Byte offsets of a launch's shared tiles, computed on the host
// (`plan_layout`) and read by the kernel.  All fields are 32-bit.
struct Layout {
  int32_t stages;   // K/V stages in the ring (0: the operands do not fit)
  int32_t nqc;      // 128-byte chunks of a q / k row (its 64-byte chunks follow them)
  int32_t nvt;      // 128-byte chunks of a V row loaded per key tile (0: one 64-byte chunk)
  int32_t q_wg;     // bytes of one consumer's q tile (64 rows)
  int32_t q_bytes;  // bytes of the block's q tile(s)
  int32_t kv;       // offset of stage 0
  int32_t k_bytes;  // bytes of a stage's K tile (its V tile follows)
  int32_t stage;    // bytes of a stage
  int32_t x;        // offset of the split route's score exchange
  int32_t bar;      // offset of the mbarriers: K full / empty, V full / empty (kMaxStages each), q
  int32_t smem;     // dynamic shared memory to ask for
};

// The shared-memory plan of a block whose q / k rows are qk_row bytes and
// whose V rows are v_row bytes a key tile: q tile(s), then the ring of as
// many K/V stages as fit (at most kMaxStages; a stage is a K tile and then a
// V tile), then the split route's score exchange (2 buffers x 2 consumers x
// 128 threads x BK/2 floats), then the barriers.  At the end the block's
// output, out_bytes, is staged from offset 0 and must fit below the
// barriers.  Two blocks an SM share its shared memory: `blocks` 2 halves
// the limit.  `kernels/loader.py::hopper_layout` mirrors it.
inline Layout plan_layout(bool split, int bk, int qk_row, int v_row, int out_bytes, int blocks = 1) {
  Layout L{};
  L.nqc = qk_row / CHUNK;
  L.nvt = v_row / CHUNK;
  L.q_wg = ROWS * qk_row;
  L.q_bytes = L.q_wg * (split ? 1 : 2);
  L.k_bytes = bk * qk_row;
  L.stage = bk * (qk_row + v_row);
  const int x_bytes = split ? 2 * 2 * 128 * (bk / 2) * 4 : 0;
  const int room = (blocks == 1 ? kSmemLimit : kSmemLimit2) - kAlign - L.q_bytes - x_bytes - kBarBytes;
  L.stages = room < L.stage ? 0 : (room / L.stage < kMaxStages ? room / L.stage : kMaxStages);
  L.kv = L.q_bytes;
  L.x = L.kv + L.stages * L.stage;
  L.bar = L.x + x_bytes;
  L.smem = L.bar + kBarBytes + kAlign;
  if (L.bar < out_bytes) L.stages = 0;  // the epilogue's staging must fit below the barriers
  return L;
}

// ------------------------------------------------------------ tensor maps
//
// cuTensorMapEncodeTiled lives in libcuda; it is reached through the
// runtime's entry-point query, so the libraries need no -lcuda.

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A tensor map over a (B, H, rows, cols) operand with (batch, head, row)
// strides s (elements; the last dim contiguous) whose box is one chunk:
// `width` (128 or 64) bytes of columns by box_rows rows, in the swizzle of
// that width.  Reads past `rows` or `cols` are zero-filled.  A dim of
// extent 1 gets a stride it never uses (its natural one), so a size-1
// batch or head of any stride works.  Returns a cudaError_t code.
inline int make_map(CUtensorMap* map, const void* ptr, bool f32, int64_t cols, int64_t rows,
                    int64_t H, int64_t B, const int64_t s[3], int box_rows, int width = CHUNK) {
  EncodeTiledFn encode = encode_tiled();
  if (!encode) return (int)cudaErrorSymbolNotFound;
  const int64_t elt = f32 ? 4 : 2;
  cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)H, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)(s[2] * elt), (cuuint64_t)(s[1] * elt),
                           (cuuint64_t)(s[0] * elt)};
  int64_t extent = (cols * elt + 15) / 16 * 16;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) strides[i] = (cuuint64_t)extent;
    extent = (int64_t)strides[i] * (int64_t)dims[i + 1];
  }
  cuuint32_t box[4] = {(cuuint32_t)(width / elt), (cuuint32_t)box_rows, 1, 1};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  CUresult r = encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      4, const_cast<void*>(ptr), dims, strides, box, estride,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      width == HALF ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// arrive and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box of shared memory to a 4D tensor map (rows and columns past the
// map's extents are not written), in the thread's bulk async-group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the thread's bulk stores are committed, and have read their shared memory
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the thread's shared-memory writes become visible to TMA (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may not move their other uses across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[i][e])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// wgmma shared-memory descriptor of a tile of W-byte (128 or 64) swizzled
// chunks: start address, leading and stride byte offsets (16-byte units),
// layout type 1 (128B swizzle) or 2 (64B).  K-major (Q, K): 8-row groups
// 8 W bytes apart, lbo unused (1).  MN-major (V): 8-key groups 8 W bytes
// apart, chunks (W / 2 bf16 columns each) `lbo` bytes apart.
template <int W>
__device__ __forceinline__ uint64_t desc_sw(const void* p, uint32_t lbo) {
  static_assert(W == CHUNK || W == HALF, "128- or 64-byte chunks");
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(8 * W >> 4) << 32) | ((W == CHUNK ? 1ull : 2ull) << 62);
}

// S (+)= Q K^T: m64nNk16, both operands K-major in shared memory
// (128B swizzle); acc = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n80(float (&d)[10][4], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(acc));
}

// d (+)= A B: m64nNk16, A (bf16) in registers, B in shared memory (128B
// or 64B swizzle), K-major (TRANS_B 0: K for S = Q K^T) or MN-major (1: V
// for O += P V); acc = 0 overwrites d
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[32][4], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TRANS_B));
}


// ------------------------------------------------------------ consumers

// The 64 query rows of a consumer warpgroup: this thread's logits S of one
// key tile (BK keys) and its O accumulators (NV columns), in the layout
// that wgmma's m64nN accumulators and a warp's mma.sync m16n8 tiles share
// -- n8 tile j, element e: row 16 * warp + lane / 4 + 8 * (e >> 1), column
// 8 j + 2 (lane % 4) + (e & 1) -- with the running max m (raw logits) and
// this thread's part l of the row sums, for its two rows.  The scale is
// positive: maxima are taken on the raw logits and the scale is folded
// into the exponent.
template <int BK, int NV>
struct Flash {
  float s[BK / 8][4];
  float o[NV / 8][4];
  float m[2], l[2];
  float scale_log2;

  __device__ __forceinline__ void init(float scale) {
    scale_log2 = scale * LOG2E;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.0f;
    }
#pragma unroll
    for (int n = 0; n < NV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  }

  __device__ __forceinline__ void zero_scores() {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
  }

  // Split route: add the other consumer's half of S.  Each thread writes
  // its partial logits to its slots of buffer `buf` and reads the same
  // slots of the other consumer's, which hold the same (row, key) pairs;
  // the two buffers alternate by tile, so one barrier a tile suffices.
  __device__ __forceinline__ void exchange(float4* x, int buf, int c, int tid) {
    float4* mine = x + (buf * 2 + c) * (BK / 8) * 128 + tid;
    const float4* other = x + (buf * 2 + 1 - c) * (BK / 8) * 128 + tid;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) mine[n * 128] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    named_sync(1, 256);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float4 v = other[n * 128];
      s[n][0] += v.x;
      s[n][1] += v.y;
      s[n][2] += v.z;
      s[n][3] += v.w;
    }
  }

  // The tile's logits into P = 2^(scale_log2 * S - base) in place, with
  // the new maxima; corr (2^ of the old maxima less the new) rescales l
  // here and O in `rescale`.  With MASK, keys at or past n_valid score
  // -inf (only a strip's trailing tiles need it).
  template <bool MASK>
  __device__ __forceinline__ void softmax(int n_valid, float (&corr)[2]) {
    if constexpr (MASK) {
      const int lim = n_valid - 2 * (threadIdx.x & 3);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = n * 8 + (e & 1) < lim ? s[n][e] : -INFINITY;
    }
    // row maxima and sums over two partial chains (even and odd n tiles)
    float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1][n & 1] = fmaxf(mx[e >> 1][n & 1], s[n][e]);
    float base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float r = fmaxf(mx[i][0], mx[i][1]);
      r = fmaxf(r, __shfl_xor_sync(FULL, r, 1));
      r = fmaxf(r, __shfl_xor_sync(FULL, r, 2));
      const float m_new = fmaxf(m[i], r);
      base[i] = m_new == -INFINITY ? 0.0f : m_new * scale_log2;
      corr[i] = ex2(m[i] * scale_log2 - base[i]);  // 0 while m is -inf
      m[i] = m_new;
    }
    float sum[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = ex2(fmaf(s[n][e], scale_log2, -base[e >> 1]));
        sum[e >> 1][n & 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = fmaf(l[i], corr[i], sum[i][0] + sum[i][1]);
  }

  // O *= corr, skipped by a warp none of whose rows' maxima moved
  __device__ __forceinline__ void rescale(const float (&corr)[2]) {
    if (__all_sync(FULL, corr[0] == 1.0f && corr[1] == 1.0f)) return;
#pragma unroll
    for (int n = 0; n < NV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
  }

  // O / l of the consumer's 64 rows, in T, into ceil(NV / CW) chunks of 64 rows
  // x 128 bytes in the 128B swizzle, from which TMA stores them (T's pair
  // at columns 8 n + 2 t of row r lands in piece (byte / 16) ^ (r % 8):
  // a warp's rows g hit 8 distinct pieces, no bank conflict)
  template <typename T>
  __device__ __forceinline__ void stage(unsigned char* chunks) {
    constexpr int CW = CHUNK / (int)sizeof(T);
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = l[i];
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      const float inv = 1.0f / sum;
      const int r = 16 * warp + g + 8 * i;
#pragma unroll
      for (int n = 0; n < NV / 8; ++n) {
        const int col = n * 8 + 2 * t, byte = (col % CW) * (int)sizeof(T);
        unsigned char* dst = chunks + (col / CW) * ROWS * CHUNK + r * CHUNK +
                             (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15);
        const float x = o[n][2 * i] * inv, y = o[n][2 * i + 1] * inv;
        if constexpr (std::is_same<T, float>::value)
          *reinterpret_cast<float2*>(dst) = make_float2(x, y);
        else
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
      }
    }
  }
};

// bf16: both products on asynchronous wgmma -- a tile's S = Q K^T
// and the previous tile's O += P V go out together, the softmax of the
// tile runs while P V is still on the tensor cores.  With NQ > 0 the
// consumer holds its q tile's NQ k16 steps in registers (`load_q`) and S
// reads only K from shared memory (register-A wgmma), half the shared-
// memory traffic of S; the q / k row is then (NQ - 2 QH) / 4 128-byte
// chunks followed by QH 64-byte ones (4 and 2 k16 steps each).  With NQ = 0
// both operands come from shared memory, over the layout's nqc 128-byte
// chunks.  O's NV columns are read from V chunks of 128 bytes, or from one
// 64-byte chunk at NV = 32.
template <int BK, int NV, int NQ = 0, int QH = 0>
struct ConsumerBf16 : Flash<BK, NV> {
  using Flash<BK, NV>::s;
  using Flash<BK, NV>::o;
  static_assert(NQ ? (BK == 64 || BK == 128) : (BK == 32 || BK == 64 || BK == 80), "S tiles of m64n32 to m64n128");
  static_assert(NV == 32 || NV == 64 || NV == 128 || NV == 256, "O tiles are m64n32 to m64n256");
  static_assert(NQ > 0 || QH == 0, "64-byte q / k chunks are read with the q tile in registers");
  static constexpr int N128 = (NQ - 2 * QH) / 4;  // 128-byte chunks of a q / k row (NQ > 0)
  static_assert(NQ == 0 || 4 * N128 + 2 * QH == NQ, "a q / k row is whole chunks");
  static constexpr int VW = 2 * NV < CHUNK ? HALF : CHUNK;  // bytes of a V chunk's row
  uint32_t p[BK / 16][4];          // the kept tile's P, bf16: the A fragments of its P V
  uint32_t q[NQ ? NQ : 1][4];      // A fragments of the q tile (NQ > 0)

  // k16 step kk of a q / k row: the offset of its chunk in a tile of `rows`
  // rows, and its 32-byte step within the chunk's rows
  static __device__ __forceinline__ constexpr int chunk_of(int kk, int rows) {
    return kk < 4 * N128 ? (kk / 4) * rows * CHUNK : N128 * rows * CHUNK + (kk - 4 * N128) / 2 * rows * HALF;
  }
  static __device__ __forceinline__ constexpr int step_of(int kk) {
    return kk < 4 * N128 ? kk % 4 : (kk - 4 * N128) % 2;
  }

  // the A fragments of the consumer's q tile (64 rows): ldmatrix.x4 of rows
  // 16 warp + lane % 16, 16-byte piece 2 step + lane / 16 of the step's
  // chunk, swizzled by the row (r % 8 in 128-byte chunks, r / 2 % 4 in 64)
  __device__ __forceinline__ void load_q(const unsigned char* sQ) {
    if constexpr (NQ > 0) {
      const int lane = threadIdx.x & 31, r = 16 * ((threadIdx.x >> 5) & 3) + (lane & 15);
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        const int piece = 2 * step_of(kk) + (lane >> 4);
        const unsigned char* c = sQ + chunk_of(kk, ROWS);
        flash::ldsm_x4(q[kk], kk < 4 * N128 ? c + r * CHUNK + ((piece ^ (r & 7)) << 4)
                                            : c + r * HALF + ((piece ^ ((r >> 1) & 3)) << 4));
      }
    }
  }

  // S = Q K^T over chunks [c0, c1) of the q tile (64 rows) and the K tile
  // (BK rows), or with NQ > 0 over the whole row; a k16 step is 32 bytes
  // further along a chunk's rows.  The first product overwrites S (an empty
  // range, a split consumer without a chunk, zeroes it).  One commit group.
  __device__ __forceinline__ void start_scores(const unsigned char* sQ, const unsigned char* sK,
                                               int c0, int c1) {
    if (NQ == 0 && c0 >= c1) this->zero_scores();
    fence_regs(s);
    if constexpr (NQ > 0) fence_regs(q);
    wg_fence();
    if constexpr (NQ > 0) {
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        const unsigned char* c = sK + chunk_of(kk, BK);
        const uint64_t dk = (kk < 4 * N128 ? desc_sw<CHUNK>(c, 16) : desc_sw<HALF>(c, 16)) + 2 * step_of(kk);
        if constexpr (BK == 128)
          wgmma_rs_n128<0>(s, q[kk], dk, kk > 0);
        else
          wgmma_rs_n64<0>(s, q[kk], dk, kk > 0);
      }
    } else {
      for (int c = c0; c < c1; ++c) {
        const uint64_t dq = desc_sw<CHUNK>(sQ + c * ROWS * CHUNK, 16);
        const uint64_t dk = desc_sw<CHUNK>(sK + c * BK * CHUNK, 16);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int acc = c > c0 || kk > 0;
          if constexpr (BK == 80)
            wgmma_ss_n80(s, dq + 2 * kk, dk + 2 * kk, acc);
          else if constexpr (BK == 64)
            wgmma_ss_n64(s, dq + 2 * kk, dk + 2 * kk, acc);
          else
            wgmma_ss_n32(s, dq + 2 * kk, dk + 2 * kk, acc);
        }
      }
    }
    wg_commit();
  }

  // S has landed (the P V started after it may still run)
  template <int PENDING>
  __device__ __forceinline__ void wait_scores() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
    fence_regs(s);
  }

  // O += P V for the kept P, over the NV columns from chunk vc of a V tile:
  // V MN-major, 8-key groups 8 VW bytes apart, chunks BK VW bytes apart
  __device__ __forceinline__ void start_pv(const unsigned char* sV, int vc) {
    fence_regs(o);
    fence_regs(p);
    wg_fence();
    const uint64_t dv = desc_sw<VW>(sV + vc * BK * VW, BK * VW);
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) {
      const uint64_t d = dv + k * (16 * VW >> 4);
      if constexpr (NV == 32)
        wgmma_rs_n32<1>(o, p[k], d, 1);
      else if constexpr (NV == 64)
        wgmma_rs_n64<1>(o, p[k], d, 1);
      else if constexpr (NV == 128)
        wgmma_rs_n128<1>(o, p[k], d, 1);
      else
        wgmma_rs_n256<1>(o, p[k], d, 1);
    }
    wg_commit();
  }

  __device__ __forceinline__ void wait_pv() {
    wg_wait0();
    fence_regs(o);
    fence_regs(p);
    if constexpr (NQ > 0) fence_regs(q);
  }

  // keep the tile's P for its P V: rounded to bf16, keys 16k..16k+15 (S
  // tiles 2k and 2k+1) are exactly the A fragment of k16 step k
  __device__ __forceinline__ void keep_p() {
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) {
      p[k][0] = pack_bf16(s[2 * k][0], s[2 * k][1]);
      p[k][1] = pack_bf16(s[2 * k][2], s[2 * k][3]);
      p[k][2] = pack_bf16(s[2 * k + 1][0], s[2 * k + 1][1]);
      p[k][3] = pack_bf16(s[2 * k + 1][2], s[2 * k + 1][3]);
    }
  }
};

// f32: 3xTF32 mma.sync, each warp on its 16 rows, run synchronously;
// a tile's P V follows its softmax at once (nothing to overlap).  In a
// 128-byte chunk (32 floats a row) element (r, col) sits at float r * 32 +
// (((col >> 2) ^ (r & 7)) << 2) + (col & 3); in a 64-byte chunk (16 floats)
// at r * 16 + (((col >> 2) ^ (r / 2 % 4)) << 2) + (col & 3).  The q / k
// row is the range's 128-byte chunks, then (not split) QH 64-byte ones.
template <int BK, int NV, int QH = 0>
struct ConsumerF32 : Flash<BK, NV> {
  using Flash<BK, NV>::s;
  using Flash<BK, NV>::o;

  __device__ __forceinline__ void load_q(const unsigned char*) {}

  // S += Q K^T over one chunk of W bytes (rows W / 4 floats apart), whose
  // swizzle of rows 16 warp + g, + 8 and of key rows 8 n + g is sw.  A k8
  // step reads head dims t and t+4 of a chunk's 8-column group (A columns
  // t and t+4, B rows t and t+4): rows g..g+7 land in 8 distinct 16-byte
  // pieces of two 128-byte bank lines, so a warp's 32 reads hit 32 banks.
  template <int W>
  __device__ __forceinline__ void chunk_scores(const float* q, const float* k, int r0, int g, int t, int sw) {
    constexpr int F = W / 4;
#pragma unroll
    for (int kk = 0; kk < W / 32; ++kk) {
      const int lo = (((2 * kk) ^ sw) << 2) + t, hi = (((2 * kk + 1) ^ sw) << 2) + t;
      uint32_t ab[4], as[4];
      split_tf32(q[r0 * F + lo], ab[0], as[0]);
      split_tf32(q[(r0 + 8) * F + lo], ab[1], as[1]);
      split_tf32(q[r0 * F + hi], ab[2], as[2]);
      split_tf32(q[(r0 + 8) * F + hi], ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const float* kr = k + (8 * n + g) * F;
        uint32_t bb[2], bs[2];
        split_tf32(kr[lo], bb[0], bs[0]);
        split_tf32(kr[hi], bb[1], bs[1]);
        mma_3xtf32(s[n], ab, as, bb, bs);
      }
    }
  }

  // S = Q K^T over 128-byte chunks [c0, c1), then the QH 64-byte chunks
  // that follow chunk c1 (not split: c1 is the row's nqc)
  __device__ __forceinline__ void start_scores(const unsigned char* sQ, const unsigned char* sK,
                                               int c0, int c1) {
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
    const int r0 = 16 * warp + g;
    this->zero_scores();
    for (int c = c0; c < c1; ++c)
      chunk_scores<CHUNK>(reinterpret_cast<const float*>(sQ + c * ROWS * CHUNK),
                          reinterpret_cast<const float*>(sK + c * BK * CHUNK), r0, g, t, g);
#pragma unroll
    for (int h = 0; h < QH; ++h)
      chunk_scores<HALF>(reinterpret_cast<const float*>(sQ + c1 * ROWS * CHUNK + h * ROWS * HALF),
                         reinterpret_cast<const float*>(sK + c1 * BK * CHUNK + h * BK * HALF), r0, g, t,
                         (g >> 1) & 3);
  }

  // O += P V for the tile's P (in S's registers), over the NV columns from
  // chunk vc.  P is reused in registers with the key order of each 8-key step permuted (A
  // column t <-> key 2t, t+4 <-> key 2t+1), and V's B fragments are read
  // with the same permutation: rows 2t and 2t+1, column g of an 8-column
  // group.
  __device__ __forceinline__ void start_pv(const unsigned char* sV, int vc) {
    static_assert(NV % 32 == 0, "f32 O in whole 128-byte V chunks");
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
      uint32_t pb[4], ps[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(pa[e], pb[e], ps[e]);
      const int ra = (8 * j + 2 * t) * 32, rb = ra + 32;
#pragma unroll
      for (int n = 0; n < NV / 8; ++n) {
        const float* v = reinterpret_cast<const float*>(sV + (vc + n / 4) * BK * CHUNK);
        const int wc = 2 * (n % 4) + (g >> 2), wi = g & 3;
        uint32_t bb[2], bs[2];
        split_tf32(v[ra + ((wc ^ (2 * t)) << 2) + wi], bb[0], bs[0]);
        split_tf32(v[rb + ((wc ^ (2 * t + 1)) << 2) + wi], bb[1], bs[1]);
        mma_3xtf32(o[n], pb, ps, bb, bs);
      }
    }
  }
};

// ------------------------------------------------------------ the kernel

// Fields every problem's parameters carry (after its tensor maps).
struct Common {
  CUtensorMap out;  // the (B, H, Lq, dv) output, a chunk-wide box of 64 rows
  int32_t H, Lq, dv, n_tiles;
  int32_t n_full;  // leading key tiles with no key to mask
  float scale;
  Layout lay;
};

// A problem P gives the operand type `Type`, `kSplit`, the key tile `kBK`,
// a consumer's O width `kNV`, `kNQ` (the bf16 q tile's k16 steps to hold in
// registers, 0 for none), `kQH` (the 64-byte chunks that end a q / k row),
// `kMinBlocks` (blocks an SM: 1, or 2 with the consumers' registers cut
// from 240 to 104), its `Params` (tensor maps, then `Common c`)
// and four device functions: `load_q(p, sQ, bar, q0, h, b)` starts the
// q tile's boxes (both consumers' unless split), `load_k(p, sK, bar, t,
// h, b)` / `load_v(p, sV, bar, t, h, b)` key tile t's nqc K chunks / nvt V
// chunks, and `valid(p, t)` its count of real keys.
//
// In bf16 K and V have rings of their own (full / empty barriers a stage
// each): a tile's K is released as soon as its S has landed and its V one
// tile later, after the deferred P V, so the producer refills each as early
// as it can.  In f32 without the split (OACA) they share the K ring's
// barriers.
template <class P>
__global__ void __launch_bounds__(NTHREADS, P::kMinBlocks)
    flash_kernel(__grid_constant__ const typename P::Params p) {
  using T = typename P::Type;
  constexpr bool kSplit = P::kSplit;
  constexpr int BK = P::kBK, NV = P::kNV, CW = CHUNK / (int)sizeof(T);
  constexpr int OC = (NV + CW - 1) / CW;  // 128-byte chunks of a consumer's staged O
  static_assert(P::kMinBlocks == 1 || P::kMinBlocks == 2, "one or two blocks an SM");
  using Consumer = typename std::conditional<flash::is_f32<T>(), ConsumerF32<BK, NV, P::kQH>,
                                             ConsumerBf16<BK, NV, P::kNQ, P::kQH>>::type;
  // f32 not split (OACA, 3 stages) consumes a tile's K and V in one go (S,
  // softmax, P V, all synchronous), so the two share one full / empty pair
  // a stage; the split f32 route (1-2 stages) releases K after S so that
  // the next K loads during P V, and bf16 releases V one tile later: K and
  // V on rings of their own
  constexpr bool kJoint = flash::is_f32<T>() && !kSplit;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~(uintptr_t)(kAlign - 1));
  const Layout& L = p.c.lay;
  uint64_t* kfull = reinterpret_cast<uint64_t*>(base + L.bar);
  uint64_t* kempty = kfull + kMaxStages;
  uint64_t* vfull = kempty + kMaxStages;
  uint64_t* vempty = vfull + kMaxStages;
  uint64_t* qbar = vempty + kMaxStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < L.stages; ++i) {
      mbar_init(&kfull[i], 1);
      mbar_init(&kempty[i], kConsumerWarps);
      mbar_init(&vfull[i], 1);
      mbar_init(&vempty[i], kConsumerWarps);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int h = blockIdx.y % p.c.H, b = blockIdx.y / p.c.H;
  const int q0 = blockIdx.x * (kSplit ? ROWS : 2 * ROWS);
  const int n_tiles = p.c.n_tiles;

  if (threadIdx.x < 128) {
    // producer: one thread keeps both rings full
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, L.q_bytes);
      P::load_q(p, base, qbar, q0, h, b);
      int st = 0, ph = 0;
      for (int t = 0; t < n_tiles; ++t) {
        unsigned char* stage = base + L.kv + st * L.stage;
        mbar_wait(&kempty[st], ph ^ 1);
        if constexpr (kJoint) {  // K and V of a tile on the K barriers
          mbar_expect_tx(&kfull[st], L.stage);
          P::load_k(p, stage, &kfull[st], t, h, b);
          P::load_v(p, stage + L.k_bytes, &kfull[st], t, h, b);
        } else {
          mbar_expect_tx(&kfull[st], L.k_bytes);
          P::load_k(p, stage, &kfull[st], t, h, b);
          mbar_wait(&vempty[st], ph ^ 1);
          mbar_expect_tx(&vfull[st], L.stage - L.k_bytes);
          P::load_v(p, stage + L.k_bytes, &vfull[st], t, h, b);
        }
        if (++st == L.stages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // one block an SM: 65,536 registers, 168 a thread at launch, the
    // producer's 144 x 128 freed ones to the consumers (24 + 2 x 240 per
    // thread triple); two: 80 at launch, 104 a consumer thread
    regs_inc<P::kMinBlocks == 1 ? 240 : 104>();
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const bool lead = (tid & 31) == 0;  // a warp's arrival on an empty barrier
    Consumer w;
    w.init(p.c.scale);
    const unsigned char* sQ = base + (kSplit ? 0 : c * L.q_wg);
    const int c0 = kSplit ? c * L.nqc / 2 : 0, c1 = kSplit ? (c + 1) * L.nqc / 2 : L.nqc;
    const int vc = kSplit ? c * (NV / CW) : 0;  // the consumer's first V chunk
    mbar_wait(qbar, 0);
    w.load_q(sQ);
    float4* x = reinterpret_cast<float4*>(base + L.x);
    const unsigned char* kv = base + L.kv;
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lead) mbar_arrive(bar);
    };
    int st = 0, ph = 0;
    auto advance = [&]() {
      if (++st == L.stages) {
        st = 0;
        ph ^= 1;
      }
    };
    // tiles [0, n_full) hold BK real keys each; the rest are masked
    const int n_full = p.c.n_full;
    float corr[2];
    if constexpr (flash::is_f32<T>()) {
      // one loop body: the products' unrolled 3xTF32 code is large, and a
      // second copy of it for the masked tiles would crowd the instruction
      // cache
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(&kfull[st], ph);
        w.start_scores(sQ, kv + st * L.stage, c0, c1);
        if constexpr (!kJoint) release(&kempty[st]);
        if constexpr (kSplit) w.exchange(x, t & 1, c, tid);
        if (t < n_full)
          w.template softmax<false>(BK, corr);
        else
          w.template softmax<true>(P::valid(p, t), corr);
        w.rescale(corr);
        if constexpr (!kJoint) mbar_wait(&vfull[st], ph);
        w.start_pv(kv + st * L.stage + L.k_bytes, vc);
        release(kJoint ? &kempty[st] : &vempty[st]);
        advance();
      }
    } else {
      // Not split, the two consumers take turns on the tensor cores: one
      // starts its products while the other runs its softmax (named
      // barriers 2 and 3, consumer c's turn on 2 + c, consumer 1 letting
      // consumer 0 go first; consumer 0 takes the last turn back at the end).
      auto my_turn = [&]() {
        if constexpr (!kSplit) named_sync(2 + c, 256);
      };
      auto your_turn = [&]() {
        if constexpr (!kSplit) named_arrive(3 - c, 256);
      };
      if (c == 1) your_turn();
      // tile 0
      mbar_wait(&kfull[st], ph);
      my_turn();
      w.start_scores(sQ, kv + st * L.stage, c0, c1);
      your_turn();
      w.template wait_scores<0>();
      release(&kempty[st]);
      if constexpr (kSplit) w.exchange(x, 0, c, tid);
      w.template softmax<true>(P::valid(p, 0), corr);
      w.keep_p();
      int pst = st, pph = ph;
      advance();
      // tile t's S goes out with tile t-1's P V (stage pst, phase pph)
      auto step = [&](int t, auto mask) {
        mbar_wait(&kfull[st], ph);
        mbar_wait(&vfull[pst], pph);
        my_turn();
        w.start_scores(sQ, kv + st * L.stage, c0, c1);
        w.start_pv(kv + pst * L.stage + L.k_bytes, vc);
        your_turn();
        w.template wait_scores<1>();
        release(&kempty[st]);
        if constexpr (kSplit) w.exchange(x, t & 1, c, tid);
        w.template softmax<decltype(mask)::value>(P::valid(p, t), corr);
        w.wait_pv();
        release(&vempty[pst]);
        w.rescale(corr);
        w.keep_p();
        pst = st;
        pph = ph;
        advance();
      };
      const int n_first = n_full > 1 ? n_full : 1;
      for (int t = 1; t < n_first; ++t) step(t, std::false_type());
      for (int t = n_first; t < n_tiles; ++t) step(t, std::true_type());
      mbar_wait(&vfull[pst], pph);
      my_turn();
      w.start_pv(kv + pst * L.stage + L.k_bytes, vc);
      your_turn();
      if (c == 0) my_turn();
      w.wait_pv();
    }
    // Epilogue: once both consumers are done with every stage, each stages
    // its O in shared memory from offset 0 (its NV / CW chunks after the
    // other's) and one thread of it stores the chunks with TMA, which
    // clips rows past Lq and columns past dv.  The store writes whole
    // 128-byte rows, where a thread's own stores would write 4 or 8 bytes
    // of 8 rows at once; with one wave of blocks (the wide heads) nothing
    // else would hide that tail.
    named_sync(4, 256);
    unsigned char* out = base + c * OC * ROWS * CHUNK;
    w.template stage<T>(out);
    fence_async_shared();
    named_sync(5 + c, 128);
    if (tid == 0) {
      const int row = kSplit ? q0 : q0 + ROWS * c;
      for (int j = 0; j < OC; ++j) {
        const int col = (kSplit ? c * NV : 0) + j * CW;
        if (col < p.c.dv) tma_store(&p.c.out, out + j * ROWS * CHUNK, col, row, h, b);
      }
      tma_store_drain();
    }
  }
}

// One launch of problem P; grid.x covers the query tiles (64 rows split,
// 128 not), grid.y the (batch, head) pairs.  Returns a cudaError_t code.
template <class P>
int launch_flash(const typename P::Params& p, int64_t Lq, int64_t BH, cudaStream_t s) {
  const int rows = P::kSplit ? ROWS : 2 * ROWS;
  const dim3 grid((unsigned)((Lq + rows - 1) / rows), (unsigned)BH);
  auto* kernel = flash_kernel<P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.c.lay.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NTHREADS, p.c.lay.smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace hflash
