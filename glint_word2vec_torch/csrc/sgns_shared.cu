// Fused shared-pool SGNS training step for NVIDIA Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel glint_word2vec_tpu/ops/pallas/sgns_kernel.py:_sgns_tile_kernel
// and computes what glint_word2vec_tpu/ops/sgns.py:sgns_step_shared_core computes
// (its plain PyTorch twin is glint_word2vec_torch/ops/sgns.py), for f32 parameters
// (the bf16 forms are described below the design):
//
//   e = syn0[c], p = syn1[x], Z = syn1[neg]          (old values, gathered first)
//   f_pos = e.p                 g_pos = (1 - sig(f_pos)) * alpha * mask
//   f_neg = E Z^T  [B, P]       g_neg = -sig(f_neg) * alpha * valid * n/P
//   syn0[c]   += g_pos * p + g_neg Z
//   syn1[x]   += g_pos * e
//   syn1[neg] += g_neg^T E
//
// with valid = (x != neg) * mask, sig exact or clipped at +-6, duplicate indices
// SUMMED (the Pallas kernel writes duplicates last-wins; this kernel does not).
//
// Concurrency: blocks run in no order, so no block may write a parameter row that
// another block still has to read. Every read of old parameters happens in the first
// launch, which copies the touched rows into scratch; the later launches read only
// scratch and scatter into syn0/syn1 with fp32 atomicAdd. Four launches on one stream:
//   1. gather:  the pool rows Z = syn1[neg], stored and transposed (Z^T), both split
//               into TF32 parts (32 x 32 tiles, one warp each); then one warp per pair:
//               E = syn0[c], Pc = syn1[x], f_pos, g_pos;
//   2. fneg:    G = coeff(E Z^T), one block per 64 x 128 (pair, pool) tile, written as G
//               and as G^T split into TF32 parts, plus the per-block partial sums of the
//               negative loss;
//   3. update:  d_in = g_pos * Pc + G Z scattered into syn0 and d_pos = g_pos * E into
//               syn1 (64 x 128 tiles of pairs x D), and dZ^T = E^T G (64 x 128 tiles of
//               D x pool, split over the batch in chunks of 1024 pairs) written to
//               scratch as one partial sum per chunk; block 0 also finishes the step's
//               metrics;
//   4. dz_scatter: syn1[neg] += dZ, the chunks' partial sums added in chunk order.
// The atomics make the summation order of duplicate rows vary from run to run; the
// products themselves use a fixed order.
//
// What bounds it on the H100: the three products are 6*B*P*D flops (4.8 GFLOP at
// B=8192, P=256, D=384; 4.2 GFLOP over the real pairs of the smoke batch) against
// ~26 MB of touched rows. In plain fp32 on CUDA cores that is ~63 us at 67 TFLOP/s;
// as 3xTF32 on the tensor cores (three TF32 products per fp32 product) ~26 us at
// 495 TFLOP/s; the rows' bytes alone are ~8 us at 3.35 TB/s. Besides the products the
// step moves ~150 MB of scratch (E, Pc, G, G^T, the dZ partials) and issues ~1.4M
// float4 atomics.
//
// Design:
//   * 3xTF32 products on the tensor cores, fp32 accumulate. Each fp32 operand x splits
//     into big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big); a product is
//     small_a*big_b + big_a*small_b + big_a*big_b and drops small*small, the split
//     CUTLASS uses for fp32-accurate GEMM: its error is of the order of an fp32
//     product's, where plain 1xTF32 keeps ~3 decimal digits. The plain emulation of this
//     arithmetic is glint_word2vec_torch/ops/tf32.py.
//   * wgmma (m64n128k8, tf32), one warpgroup per block, two blocks per SM. A comes from
//     registers, loaded from shared memory in the fragment layout and split there, so
//     any A layout serves. B must be K-major in shared memory (tf32 wgmma has no
//     transpose), so every product takes a B stored [n][k]: E Z^T reads Z, G Z reads
//     Z^T, and dZ is computed transposed, dZ^T = E^T G, reading G^T. Those B operands
//     are written already split by the launch that produces them (Z and Z^T by launch
//     1, G^T by launch 2), so the tiles arrive in shared memory as big and small parts,
//     each in the 128-byte swizzle.
//   * The tensor cores' own accumulation drops low-order bits toward zero (it does not
//     round to nearest). Each k-slice's 12 wgmma (4 k8 steps x 3 terms) therefore start
//     from a zero accumulator, and the slice's sum is added to the running sum with an
//     fp32 add; a running sum kept in the tensor cores would carry that bias through
//     the product and, over the hundreds of duplicate updates a Zipf-hot row takes,
//     raise the step's difference from the plain version.
//   * A 2-stage ring of shared-memory tiles filled by cp.async (16 bytes a thread,
//     coalesced along each operand's contiguous dimension), so the next k-slice loads
//     while the current one multiplies. The scratch operands are padded to multiples of
//     128 rows and columns (zeros), so every tile load is aligned and unguarded.
//   * Epilogues that wait on no global load: each block reads its rows' indices, masks
//     and g_pos into shared memory up front; G and G^T leave through shared memory as
//     whole rows; the sigmoid is branch-free. The update tiles go through shared memory
//     too, and each thread adds 4 contiguous columns with one float4 atomicAdd (sm_90),
//     with a scalar path for rows that are not 16-byte aligned (D % 4 != 0). Masked
//     pairs add exact zeros and are skipped.
//   * The order of the fp32 additions into a hot row is the plain version's. dZ is split
//     over the batch so its K = B reduction fills the card, but a chunk's partial sum
//     does not go to syn1 by itself: the chunks write to scratch and launch 4 adds each
//     pool entry's whole dZ once, after every d_pos. A hot syn1 row (under Zipf 1.3 the
//     top row is a quarter of the contexts, many small d_pos, and of the pool, a few
//     large dZ) then rounds its small updates while it is still small, as the plain
//     version's index_add_ of d_pos, then of dZ, does. dZ atomics issued per chunk,
//     interleaved with the d_pos ones, put the kernel several times farther from a
//     float64 step than the plain version on such rows.
// At B=8192, P=256, D=384 the fneg grid is 2 x 128 = 256 blocks (one wave at two per
// SM on 132 SMs), the update grid 96 dZ blocks (32 k-slices each) then 384 d_in
// blocks (8 k-slices each), and the dZ scatter 96 blocks of 256 threads.
//
// bf16 forms (the JAX step's param_dtype, compute_dtype and logits_dtype; flags below).
// The kernel rounds to bf16 where the JAX step casts (glint_word2vec_tpu/ops/sgns.py,
// sgns_step_shared_core and shared_pool_coeffs), so the plain version with the same
// dtypes is its twin:
//   * compute bf16: launch 1 rounds the gathered E, Pc and Z to bf16, and f_pos is the
//     f32 sum of the bf16-rounded products, rounded to bf16 (with bf16_chain: the f32
//     sum of the exact products, unrounded). f_neg is rounded to bf16 (the bf16
//     product's output), G and G^T are rounded to bf16 before the products, and the
//     epilogues round G Z, g_pos * Pc, d_in, d_pos and dZ to bf16 as the bf16 ops of
//     the JAX step do. A bf16 value is exact in TF32, so the 3xTF32 split's small parts
//     are zero: the products run as ONE TF32 wgmma term, which gives exactly the bf16
//     products with f32 accumulation that a bf16 wgmma (k16) would.
//   * logits bf16: f_neg is rounded to bf16 and the coefficient chain rounds after each
//     of its bf16 operations, classic ((0 - sig) * alpha * valid * n/P) or fused
//     (sig * bf16(alpha * -n/P)).
//   * bf16 storage: the gathers widen bf16 rows, and no update goes to a parameter row
//     from this kernel. Launch 3 writes d_in and d_pos, launch 4 dZ, each rounded to
//     bf16, to bf16 scratch ([B, D] and [B + P, D], the pool rows after the pairs'),
//     and the wrapper applies them with the row-scatter kernel's bf16 path
//     (csrc/scatter_rows.cu): each row's updates summed in f32 and the row rounded
//     once. bf16 atomics would round after every add and lose exactly the small updates
//     of the hot rows. This also makes the d_pos / dZ ordering of launch 4 moot.
// The bf16 forms keep the f32 design; their products' bound is 4.2 GFLOP at the card's
// bf16 tensor-core rate (~4.3 us at 989 TFLOP/s) where the single TF32 term runs at
// half that rate, and their bytes are the touched rows at 2 bytes plus the f32 scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // tile rows (one warpgroup, one wgmma m64)
constexpr int BN = 128;   // tile cols (one wgmma n128)
constexpr int BK = 32;    // k-slice depth: one 128-byte swizzle row of fp32
constexpr int NT = 128;   // threads per tile block: one warpgroup
constexpr int STAGES = 2; // cp.async ring depth
constexpr int BLOCKS_PER_SM = 2;  // tile blocks resident on one SM
// A stage holds the B tile [BN][BK], pre-split: its big parts, then its small parts,
// each in the 128-byte swizzle (1024-byte aligned); then the A tile, [BM][BK] in the
// same swizzle or k-major [BK][KMAJ_LD] for dZ^T's E^T.
constexpr int KMAJ_LD = BM + 8;  // 72 = 8 mod 32: conflict-free fragment loads
constexpr int B_TILE_BYTES = BN * BK * 4;                    // 16,384 per part
constexpr int A_TILE_BYTES = BK * KMAJ_LD * 4;               // 9,216 >= BM * BK * 4
constexpr int STAGE_BYTES = 2 * B_TILE_BYTES + A_TILE_BYTES; // 41,984 = 41 KB
// 84,992 bytes with the alignment slack: two blocks per SM
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
constexpr int PAD = 128;        // scratch rows and columns are padded to this multiple
constexpr int DZ_KCHUNK = 1024; // pairs per dZ block (split over the batch)
constexpr int GATHER_WARPS = 8; // rows per gather block
constexpr int DZ_THREADS = 256; // threads per dZ scatter block
constexpr float MAX_EXP = 6.0f;

static_assert(STAGE_BYTES % 1024 == 0, "B tiles must stay 1024-byte aligned");
static_assert(BM * BK * 4 <= A_TILE_BYTES, "row-layout A tile must fit");
static_assert((BM * (BN + 4) + BN * (BM + 4)) * 4 <= STAGES * STAGE_BYTES &&
                  2 * BM * (BN + 4) * 4 <= STAGES * STAGE_BYTES,
              "epilogue staging must fit the ring");
static_assert(PAD % BM == 0 && PAD % BN == 0 && PAD % BK == 0 && DZ_KCHUNK % BK == 0,
              "padding must cover whole tiles");

enum Mode { FNEG = 0, DZ = 1, DIN = 2 };
// flags of glint_sgns_shared_step
enum Flags { STORE_BF16 = 1, COMPUTE_BF16 = 2, LOGITS_BF16 = 4, FUSED = 8, BF16_CHAIN = 16 };

struct StepArgs {
  void* syn0;              // [V, D] f32, or bf16 with STORE_BF16
  void* syn1;              // [V, D]
  unsigned short* upd0;    // STORE_BF16: [B, D] bf16 out: d_in
  unsigned short* upd1;    // STORE_BF16: [B + P, D] bf16 out: d_pos, then dZ
  const int64_t* centers;  // [B]
  const int64_t* contexts; // [B]
  const float* mask;       // [B]
  const int64_t* negatives;// [P]
  float* E;                // [Bp, Dp] scratch: syn0[centers], zero-padded
  float* Pc;               // [Bp, Dp] scratch: syn1[contexts], zero-padded
  // The products' B operands, pre-split into TF32 big and small parts:
  float* Zb;               // [Pp, Dp] scratch: syn1[negatives], zero-padded
  float* Zs;
  float* Ztb;              // [Dp, Pp] scratch: Z^T
  float* Zts;
  float* G;                // [Bp, Pp] scratch: g_neg (zero outside [B, P])
  float* Gtb;              // [Pp, Bp] scratch: G^T
  float* Gts;
  float* dz_part;          // [k_chunks, Pp, Dp] scratch: dZ of each batch chunk
  float* gpos;             // [Bp]    scratch: g_pos
  float* pos_loss;         // [Bp]    scratch: softplus(-f_pos) * mask
  float* fpos;             // [Bp]    scratch: f_pos * mask
  float* neg_part;         // [n_neg_part] scratch: sum softplus(f_neg) * valid
  float* metrics;          // [3] out: loss, mean f_pos (both 0 without metrics), pairs
  int B, P, D;
  int Bp, Pp, Dp;          // padded to multiples of PAD
  int n_neg_part;
  int k_chunks;            // batch chunks of DZ_KCHUNK pairs
  const float* alpha;      // [1] on the device: the step's learning rate
  float ratio;             // num_negatives / P
  int clipped;
  int with_metrics;
  int flags;
};

// The step's learning rate, read from the device (a CUDA graph replays the launch
// arguments it captured, so a value argument would keep the alpha of the step it was
// captured on). Each thread reads it once, at its kernel's start.
__device__ __forceinline__ float step_alpha(const StepArgs& a) { return __ldg(a.alpha); }

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}
// The kernels are instantiated twice: X = false is the f32 step with no flag set, whose
// code the flags must not touch (they are the constant 0 there); X = true reads them.
template <bool X>
__device__ __forceinline__ int flags_of(const StepArgs& a) { return X ? a.flags : 0; }
// Element i of a parameter matrix, widened to f32.
__device__ __forceinline__ float param_at(int flags, const void* m, int64_t i) {
  return (flags & STORE_BF16)
             ? __uint_as_float((unsigned)static_cast<const unsigned short*>(m)[i] << 16)
             : static_cast<const float*>(m)[i];
}
// A gathered value as the step computes with it.
__device__ __forceinline__ float compute_value(int flags, float v) {
  return (flags & COMPUTE_BF16) ? bf16r(v) : v;
}

// sig(f) without branches (fast exp and divide, a few ulp: far inside the step's f32
// tolerance), so the epilogues' unrolled element loops interleave; "clipped" saturates to
// 1 above +6 and 0 below -6, as the reference's table does.
__device__ __forceinline__ float sigmoid_f(float f, int clipped) {
  const float s = __fdividef(1.0f, 1.0f + __expf(-f));
  return clipped ? (f > MAX_EXP ? 1.0f : (f < -MAX_EXP ? 0.0f : s)) : s;
}

__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.0f) + __logf(1.0f + __expf(-fabsf(x)));
}

// Sum over the block in a fixed order (warp shuffles, then warp 0 over the warp
// totals); the result is valid in thread 0.
__device__ float block_sum(float v, float* shm) {
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) shm[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += shm[w];
  }
  return s;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small + O(2^-22 |x|): both parts TF32, rounded to nearest, ties away.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// Launch 1. Blocks [0, pool_blocks) copy the pool rows Z = syn1[negatives], pre-split,
// as stored [Pp][Dp] and transposed [Dp][Pp]: one warp per 32 x 32 tile, transposed
// through shared memory. The other blocks take one pair per warp: E, Pc, f_pos, g_pos.
template <bool X>
__global__ void __launch_bounds__(GATHER_WARPS * 32) gather_kernel(StepArgs a,
                                                                   int pool_blocks) {
  __shared__ float tile[GATHER_WARPS][32][33];
  const int flags = flags_of<X>(a);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = a.D, Dp = a.Dp;
  if ((int)blockIdx.x < pool_blocks) {
    const int dt = Dp / 32, task = blockIdx.x * GATHER_WARPS + w;
    if (task >= (a.Pp / 32) * dt) return;
    const int q0 = (task / dt) * 32, d0 = (task % dt) * 32, d = d0 + lane;
    for (int i = 0; i < 32; ++i) {
      const int q = q0 + i;
      const float v = (q < a.P && d < D)
                          ? compute_value(flags, param_at(flags, a.syn1,
                                                          a.negatives[q] * (int64_t)D + d))
                          : 0.0f;
      uint32_t big, small;
      split_tf32(v, big, small);
      a.Zb[(int64_t)q * Dp + d] = __uint_as_float(big);
      a.Zs[(int64_t)q * Dp + d] = __uint_as_float(small);
      tile[w][i][lane] = v;
    }
    __syncwarp();
    for (int i = 0; i < 32; ++i) {
      uint32_t big, small;
      split_tf32(tile[w][lane][i], big, small);  // Z[q0 + lane][d0 + i]
      const int64_t off = (int64_t)(d0 + i) * a.Pp + q0 + lane;
      a.Ztb[off] = __uint_as_float(big);
      a.Zts[off] = __uint_as_float(small);
    }
    return;
  }
  const int b = (blockIdx.x - pool_blocks) * GATHER_WARPS + w;
  if (b >= a.Bp) return;
  float* eo = a.E + (int64_t)b * Dp;
  float* po = a.Pc + (int64_t)b * Dp;
  if (b >= a.B) {  // padding rows
    for (int d = lane; d < Dp; d += 32) eo[d] = po[d] = 0.0f;
    if (lane == 0) a.gpos[b] = 0.0f;
    return;
  }
  const int64_t e = a.centers[b] * (int64_t)D;
  const int64_t p = a.contexts[b] * (int64_t)D;
  // compute bf16 without bf16_chain: the bf16 product of each element, summed in f32
  const bool round_products = (flags & (COMPUTE_BF16 | BF16_CHAIN)) == COMPUTE_BF16;
  float dot = 0.0f;
  for (int d = lane; d < Dp; d += 32) {
    const float ev = d < D ? compute_value(flags, param_at(flags, a.syn0, e + d)) : 0.0f;
    const float pv = d < D ? compute_value(flags, param_at(flags, a.syn1, p + d)) : 0.0f;
    eo[d] = ev;
    po[d] = pv;
    dot = round_products ? dot + bf16r(ev * pv) : fmaf(ev, pv, dot);
  }
  for (int off = 16; off; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
  if (round_products) dot = bf16r(dot);
  if (lane == 0) {
    const float m = a.mask[b];
    a.gpos[b] = (1.0f - sigmoid_f(dot, a.clipped)) * step_alpha(a) * m;
    if (a.with_metrics) {
      a.pos_loss[b] = softplus_f(-dot) * m;
      a.fpos[b] = dot * m;
    }
  }
}

// ---- tensor-core building blocks -------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle: 8-row
// groups 1024 bytes apart (SBO), leading byte offset unused (1), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keep a register's value (and its register) in place across an asynchronous wgmma.
__device__ __forceinline__ void pin(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// d (+)= a b: one m64n128k8 tf32 wgmma of the warpgroup, A from registers, B from the
// descriptor; scale_d = 0 ignores d's old value.
__device__ __forceinline__ void wgmma_tf32(float d[64], const uint32_t a[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Row tile: ROWS rows x 32 floats of g (row stride ld) in the 128-byte swizzle: the
// 16-byte chunk q of row r lands at chunk q ^ (r & 7).
template <int ROWS>
__device__ __forceinline__ void load_row_tile(float* s, const float* g, int ld) {
#pragma unroll
  for (int i = 0; i < (ROWS * BK / 4) / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    const int r = c >> 3, q = c & 7;
    cp_async16(s + r * BK + ((q ^ (r & 7)) << 2), g + (int64_t)r * ld + q * 4);
  }
}

// K-major tile: 32 rows (k) x BM floats (m), padded rows.
__device__ __forceinline__ void load_kmaj_tile(float* s, const float* g, int ld) {
#pragma unroll
  for (int i = 0; i < (BM * BK / 4) / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    const int r = c / (BM / 4), q = c % (BM / 4);
    cp_async16(s + r * KMAJ_LD + q * 4, g + (int64_t)r * ld + q * 4);
  }
}

// Operands per mode (row-major scratch in global memory), C [M, N] = A [M, K] B [K, N],
// B read K-major as [N][K]:
//   FNEG: C = E Z^T    A = E  [b][d]          B = Z   [p][d]   M=B, N=P, K=D
//   DIN:  C = G Z      A = G  [b][p]          B = Z^T [d][p]   M=B, N=D, K=P
//   DZ:   C = E^T G    A = E  [b][d] as k-major             B = G^T [p][b]   M=D, N=P, K=B
template <int MODE>
__device__ __forceinline__ void load_stage(const StepArgs& a, uint8_t* st, int m0, int n0,
                                           int k0) {
  float* sBb = reinterpret_cast<float*>(st);
  float* sBs = reinterpret_cast<float*>(st + B_TILE_BYTES);
  float* sA = reinterpret_cast<float*>(st + 2 * B_TILE_BYTES);
  if (MODE == FNEG) {
    load_row_tile<BM>(sA, a.E + (int64_t)m0 * a.Dp + k0, a.Dp);
    load_row_tile<BN>(sBb, a.Zb + (int64_t)n0 * a.Dp + k0, a.Dp);
    load_row_tile<BN>(sBs, a.Zs + (int64_t)n0 * a.Dp + k0, a.Dp);
  } else if (MODE == DIN) {
    load_row_tile<BM>(sA, a.G + (int64_t)m0 * a.Pp + k0, a.Pp);
    load_row_tile<BN>(sBb, a.Ztb + (int64_t)n0 * a.Pp + k0, a.Pp);
    load_row_tile<BN>(sBs, a.Zts + (int64_t)n0 * a.Pp + k0, a.Pp);
  } else {
    load_kmaj_tile(sA, a.E + (int64_t)k0 * a.Dp + m0, a.Dp);
    load_row_tile<BN>(sBb, a.Gtb + (int64_t)n0 * a.Bp + k0, a.Bp);
    load_row_tile<BN>(sBs, a.Gts + (int64_t)n0 * a.Bp + k0, a.Bp);
  }
}

template <bool KMAJ>
__device__ __forceinline__ float a_elem(const float* sA, int r, int k) {
  return KMAJ ? sA[k * KMAJ_LD + r] : sA[r * BK + ((((k >> 2) ^ (r & 7))) << 2) + (k & 3)];
}

// One staged k-slice into acc: load and split this thread's A fragments, then 4 k8
// steps x 3 wgmma (B's big and small parts staged as they are) into a zeroed
// accumulator t, and acc += t.
template <int MODE>
__device__ __forceinline__ void compute_slice(const uint8_t* st, float acc[64], float t[64],
                                              bool one_term) {
  const float* sA = reinterpret_cast<const float*>(st + 2 * B_TILE_BYTES);
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int tq = lane & 3;
  uint32_t ab[4][4], as[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k = kk * 8 + tq;
    split_tf32(a_elem<MODE == DZ>(sA, r0, k), ab[kk][0], as[kk][0]);
    split_tf32(a_elem<MODE == DZ>(sA, r0 + 8, k), ab[kk][1], as[kk][1]);
    split_tf32(a_elem<MODE == DZ>(sA, r0, k + 4), ab[kk][2], as[kk][2]);
    split_tf32(a_elem<MODE == DZ>(sA, r0 + 8, k + 4), ab[kk][3], as[kk][3]);
  }
  const uint32_t big = smem_u32(st), small = big + B_TILE_BYTES;
  wgmma_fence();
  if (one_term) {  // bf16-valued operands: the small parts are zero
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_tf32(t, ab[kk], sw128_desc(big + kk * 32), kk > 0);
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_tf32(t, as[kk], sw128_desc(big + kk * 32), kk > 0);
      wgmma_tf32(t, ab[kk], sw128_desc(small + kk * 32), 1);
      wgmma_tf32(t, ab[kk], sw128_desc(big + kk * 32), 1);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      pin(ab[kk][q]);
      pin(as[kk][q]);
    }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    pin(t[i]);
    acc[i] += t[i];
  }
}

// One BM x BN output tile of C = A B over k in [k_begin, k_end) (a multiple of BK),
// accumulated into acc, through the cp.async ring. Ends with the ring free. one_term:
// the operands are bf16-valued (one TF32 term per product).
template <int MODE>
__device__ __forceinline__ void gemm_tile(const StepArgs& a, int m0, int n0, int k_begin,
                                          int k_end, uint8_t* smem, float acc[64],
                                          bool one_term) {
  float t[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) t[i] = 0.0f;
  const int n_k = (k_end - k_begin) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load_stage<MODE>(a, smem + s * STAGE_BYTES, m0, n0, k_begin + s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of slice kt have landed
    fence_proxy_async();          // ... and are visible to wgmma (the async proxy)
    __syncthreads();              // ... for every thread; slice kt-1 is done with
    const int nk = kt + STAGES - 1;
    if (nk < n_k)
      load_stage<MODE>(a, smem + (nk % STAGES) * STAGE_BYTES, m0, n0, k_begin + nk * BK);
    cp_async_commit();
    compute_slice<MODE>(smem + (kt % STAGES) * STAGE_BYTES, acc, t, one_term);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The dynamic shared memory, 1024-byte aligned for the swizzled tiles.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t off = (1024 - (smem_u32(raw) & 1023)) & 1023;
  return raw + off;
}

// ---- launches 2 and 3 ------------------------------------------------------------

// row[d..d+3] += v (the columns below D), one float4 atomic or up to four scalar ones.
template <bool VEC>
__device__ __forceinline__ void add_cols(float* row, int d, int D, float4 v) {
  if (d >= D) return;
  if (VEC) {
    atomicAdd(reinterpret_cast<float4*>(row + d), v);
  } else {
    atomicAdd(row + d, v.x);
    if (d + 1 < D) atomicAdd(row + d + 1, v.y);
    if (d + 2 < D) atomicAdd(row + d + 2, v.z);
    if (d + 3 < D) atomicAdd(row + d + 3, v.w);
  }
}

// row[d..d+3] = v rounded to bf16 (the columns below D): one 8-byte store or up to
// four 2-byte ones.
template <bool VEC>
__device__ __forceinline__ void store_bf16_cols(unsigned short* row, int d, int D, float4 v) {
  if (d >= D) return;
  if (VEC) {
    *reinterpret_cast<uint2*>(row + d) = make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16),
                                                    bf16_bits(v.z) | (bf16_bits(v.w) << 16));
  } else {
    row[d] = (unsigned short)bf16_bits(v.x);
    if (d + 1 < D) row[d + 1] = (unsigned short)bf16_bits(v.y);
    if (d + 2 < D) row[d + 2] = (unsigned short)bf16_bits(v.z);
    if (d + 3 < D) row[d + 3] = (unsigned short)bf16_bits(v.w);
  }
}

// g_neg of one (pair, pool) entry from its logit f (already rounded as the step's f_neg)
// and its validity (the pair's mask, or 0): the classic chain or the fused select, in
// f32 or rounding after each bf16 operation as the JAX step's bf16 chain does.
__device__ __forceinline__ float neg_coeff(const StepArgs& a, int flags, float alpha,
                                           float f, float valid) {
  const float s = sigmoid_f(f, a.clipped);
  if (!(flags & LOGITS_BF16)) {
    if (flags & FUSED) return valid != 0.0f ? s * (alpha * (0.0f - a.ratio)) : 0.0f;
    return (0.0f - s) * alpha * valid * a.ratio;
  }
  const float sb = bf16r(s);
  if (flags & FUSED)
    return valid != 0.0f ? bf16r(sb * bf16r(alpha * (0.0f - a.ratio))) : 0.0f;
  return bf16r(bf16r(bf16r((0.0f - sb) * bf16r(alpha)) * valid) * bf16r(a.ratio));
}

template <bool METRICS, bool X>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM) fneg_kernel(StepArgs a) {
  const int flags = flags_of<X>(a);
  const float alpha = step_alpha(a);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ float red[NT / 32];
  // the tile's pool ids and its pairs' contexts and masks, read once up front so the
  // epilogue waits on no global load
  __shared__ int64_t s_neg[BN], s_ctx[BM];
  __shared__ float s_mask[BM];
  uint8_t* smem = aligned_smem(smem_raw);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  for (int i = threadIdx.x; i < BN; i += NT) {
    const int p = n0 + i;
    s_neg[i] = p < a.P ? a.negatives[p] : -1;
  }
  for (int i = threadIdx.x; i < BM; i += NT) {
    const int b = m0 + i;
    s_ctx[i] = b < a.B ? a.contexts[b] : -2;
    s_mask[i] = b < a.B ? a.mask[b] : 0.0f;
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  gemm_tile<FNEG>(a, m0, n0, 0, a.Dp, smem, acc,  // its barriers publish s_*
                  (flags & COMPUTE_BF16) != 0);
  // acc[4i + 2h + j] is C(row r0 + 8h, col 8i + 2tq + j). The coefficients go to shared
  // memory twice, as [pair][pool] and as [pool][pair], then out as whole rows of G and
  // G^T.
  constexpr int LD = BN + 4, LDT = BM + 4;
  float* sG = reinterpret_cast<float*>(smem);
  float* sGt = sG + BM * LD;
  const int lane = threadIdx.x & 31, tq = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
  float lsum = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = r0 + 8 * h, c = 8 * i + 2 * tq + j;
        const float f0 = acc[4 * i + 2 * h + j];
        const float f = (flags & (COMPUTE_BF16 | LOGITS_BF16)) ? bf16r(f0) : f0;
        const int64_t ng = s_neg[c];
        const float valid = (ng >= 0 && s_ctx[r] != ng) ? s_mask[r] : 0.0f;
        const float g = neg_coeff(a, flags, alpha, f, valid);
        const float gv = (flags & COMPUTE_BF16) ? bf16r(g) : g;  // G in compute dtype
        if (METRICS) lsum += softplus_f(f) * valid;
        sG[r * LD + c] = gv;
        sGt[c * LDT + r] = gv;
      }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN / 4; idx += NT) {
    const int r = idx / (BN / 4), q = idx % (BN / 4);
    *reinterpret_cast<float4*>(a.G + (int64_t)(m0 + r) * a.Pp + n0 + 4 * q) =
        *reinterpret_cast<const float4*>(sG + r * LD + 4 * q);
    const int rt = idx / (BM / 4), qt = idx % (BM / 4);
    const float4 v = *reinterpret_cast<const float4*>(sGt + rt * LDT + 4 * qt);
    uint32_t b0, b1, b2, b3, s0, s1, s2, s3;
    split_tf32(v.x, b0, s0);
    split_tf32(v.y, b1, s1);
    split_tf32(v.z, b2, s2);
    split_tf32(v.w, b3, s3);
    const int64_t off = (int64_t)(n0 + rt) * a.Bp + m0 + 4 * qt;
    *reinterpret_cast<float4*>(a.Gtb + off) =
        make_float4(__uint_as_float(b0), __uint_as_float(b1), __uint_as_float(b2),
                    __uint_as_float(b3));
    *reinterpret_cast<float4*>(a.Gts + off) =
        make_float4(__uint_as_float(s0), __uint_as_float(s1), __uint_as_float(s2),
                    __uint_as_float(s3));
  }
  if (METRICS) {
    const float s = block_sum(lsum, red);
    if (threadIdx.x == 0) a.neg_part[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// Blocks [0, n_dz) take dZ^T tiles (D tile x pool tile x batch chunk), the rest take
// d_in/d_pos tiles (pair tile x D tile). Block 0 also reduces the loss partials.
template <bool VEC, bool X>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM) update_kernel(StepArgs a, int n_dz) {
  const int flags = flags_of<X>(a);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ float red[NT / 32];
  // per output row, read once up front: the target row of syn1 (dZ: the pool id), or of
  // syn0 and syn1 with g_pos (d_in/d_pos); -1 marks a row that adds nothing
  __shared__ int64_t s_row0[BN], s_row1[BM];
  __shared__ float s_gp[BM];
  uint8_t* smem = aligned_smem(smem_raw);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  int id = blockIdx.x;
  const bool dz = id < n_dz;
  int m0, n0, kc = 0;
  if (dz) {
    kc = id % a.k_chunks;
    id /= a.k_chunks;  // the dZ tile
    m0 = (id % (a.Dp / BM)) * BM;  // D
    n0 = (id / (a.Dp / BM)) * BN;  // pool
    const int k_begin = kc * DZ_KCHUNK;
    gemm_tile<DZ>(a, m0, n0, k_begin, min(a.Bp, k_begin + DZ_KCHUNK), smem, acc,
                  (flags & COMPUTE_BF16) != 0);
  } else {
    id -= n_dz;
    n0 = (id % (a.Dp / BN)) * BN;  // D
    m0 = (id / (a.Dp / BN)) * BM;  // pairs
    for (int i = threadIdx.x; i < BM; i += NT) {
      const int b = m0 + i;
      const bool live = b < a.B && a.mask[b] != 0.0f;  // masked pairs add exact zeros
      s_row0[i] = live ? a.centers[b] : -1;
      s_row1[i] = live ? a.contexts[b] : -1;
      s_gp[i] = live ? a.gpos[b] : 0.0f;
    }
    gemm_tile<DIN>(a, m0, n0, 0, a.Pp, smem, acc,  // its barriers publish s_*
                   (flags & COMPUTE_BF16) != 0);
  }
  // Stage the accumulator tile in the (free) ring as [pair or pool row][D column]:
  // dZ^T transposed back (128 pool rows x 64 columns), or d_in (64 pair rows x 128
  // columns) with d_pos beside it.
  const int cols = dz ? BM : BN;
  const int ld = cols + 4;
  float* sC = reinterpret_cast<float*>(smem);
  float* sP = sC + BM * (BN + 4);  // d_pos
  {
    const int lane = threadIdx.x & 31, tq = lane & 3;
    const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, c = 8 * i + 2 * tq;
        const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
        if (dz) {
          sC[c * ld + r] = v0;
          sC[(c + 1) * ld + r] = v1;
        } else {
          *reinterpret_cast<float2*>(sC + r * ld + c) = make_float2(v0, v1);
        }
      }
  }
  __syncthreads();
  const int c4 = cols / 4;  // float4 per row: 16 or 32
  if (dz) {
    // this batch chunk's dZ goes to scratch; launch 4 sums the chunks and scatters them
    float* part = a.dz_part + (int64_t)kc * a.Pp * a.Dp;
    for (int idx = threadIdx.x; idx < BM * BN / 4; idx += NT) {
      const int r = idx / c4, q = idx % c4;
      *reinterpret_cast<float4*>(part + (int64_t)(n0 + r) * a.Dp + m0 + 4 * q) =
          *reinterpret_cast<const float4*>(sC + r * ld + 4 * q);
    }
  } else {
    // d_in = g_pos * Pc + G Z and d_pos = g_pos * E, reading the scratch rows before
    // any atomic is issued, so the loads pipeline
#pragma unroll 4
    for (int idx = threadIdx.x; idx < BM * BN / 4; idx += NT) {
      const int r = idx / c4, q = idx % c4;
      if (s_row0[r] < 0) continue;
      const float gp = s_gp[r];
      const int64_t off = (int64_t)(m0 + r) * a.Dp + n0 + 4 * q;
      const float4 pc = *reinterpret_cast<const float4*>(a.Pc + off);
      const float4 e = *reinterpret_cast<const float4*>(a.E + off);
      float4* c = reinterpret_cast<float4*>(sC + r * ld + 4 * q);
      const float4 v = *c;
      if (flags & COMPUTE_BF16) {  // bf16(bf16(g_pos * Pc) + bf16(G Z)), bf16(g_pos * E)
        const float g = bf16r(gp);
        *c = make_float4(bf16r(bf16r(g * pc.x) + bf16r(v.x)), bf16r(bf16r(g * pc.y) + bf16r(v.y)),
                         bf16r(bf16r(g * pc.z) + bf16r(v.z)), bf16r(bf16r(g * pc.w) + bf16r(v.w)));
        *reinterpret_cast<float4*>(sP + r * ld + 4 * q) =
            make_float4(bf16r(g * e.x), bf16r(g * e.y), bf16r(g * e.z), bf16r(g * e.w));
      } else {
        *c = make_float4(fmaf(gp, pc.x, v.x), fmaf(gp, pc.y, v.y), fmaf(gp, pc.z, v.z),
                         fmaf(gp, pc.w, v.w));
        *reinterpret_cast<float4*>(sP + r * ld + 4 * q) =
            make_float4(gp * e.x, gp * e.y, gp * e.z, gp * e.w);
      }
    }
    __syncthreads();
    const bool to_scratch = flags & STORE_BF16;
    for (int idx = threadIdx.x; idx < BM * BN / 4; idx += NT) {
      const int r = idx / c4, q = idx % c4;
      if (s_row0[r] < 0) continue;
      const int d = n0 + 4 * q;
      const float4 din = *reinterpret_cast<const float4*>(sC + r * ld + 4 * q);
      const float4 dpos = *reinterpret_cast<const float4*>(sP + r * ld + 4 * q);
      if (to_scratch) {  // bf16 rows: the row-scatter kernel applies them
        store_bf16_cols<VEC>(a.upd0 + (int64_t)(m0 + r) * a.D, d, a.D, din);
        store_bf16_cols<VEC>(a.upd1 + (int64_t)(m0 + r) * a.D, d, a.D, dpos);
      } else {
        add_cols<VEC>(static_cast<float*>(a.syn0) + s_row0[r] * (int64_t)a.D, d, a.D, din);
        add_cols<VEC>(static_cast<float*>(a.syn1) + s_row1[r] * (int64_t)a.D, d, a.D, dpos);
      }
    }
  }
  if (blockIdx.x == 0) {  // the step's metrics, each sum in a fixed order
    float pairs = 0.0f, pos = 0.0f, fp = 0.0f, neg = 0.0f;
    for (int b = threadIdx.x; b < a.B; b += NT) {
      pairs += a.mask[b];
      if (a.with_metrics) {
        pos += a.pos_loss[b];
        fp += a.fpos[b];
      }
    }
    if (a.with_metrics)
      for (int q = threadIdx.x; q < a.n_neg_part; q += NT) neg += a.neg_part[q];
    const float pairs_s = block_sum(pairs, red);
    const float pos_s = block_sum(pos, red);
    const float fp_s = block_sum(fp, red);
    const float neg_s = block_sum(neg, red);
    if (threadIdx.x == 0) {
      const float denom = fmaxf(pairs_s, 1.0f);
      a.metrics[0] = a.with_metrics ? (pos_s + neg_s * a.ratio) / denom : 0.0f;
      a.metrics[1] = a.with_metrics ? fp_s / denom : 0.0f;
      a.metrics[2] = pairs_s;
    }
  }
}

// Launch 4: syn1[neg] += dZ, one thread per pool entry and 4 columns, the batch chunks'
// partial sums added in chunk order. It runs after every d_pos atomic of launch 3, so
// a hot syn1 row takes its many small d_pos updates first and its few large dZ ones
// last, the order of the plain version's two index_add_ calls.
template <bool VEC, bool X>
__global__ void __launch_bounds__(DZ_THREADS) dz_scatter_kernel(StepArgs a) {
  const int flags = flags_of<X>(a);
  const int64_t t = (int64_t)blockIdx.x * DZ_THREADS + threadIdx.x;
  const int p = (int)(t / (a.Dp / 4)), d = (int)(t % (a.Dp / 4)) * 4;
  if (p >= a.P || d >= a.D) return;
  const float* src = a.dz_part + (int64_t)p * a.Dp + d;
  float4 v = *reinterpret_cast<const float4*>(src);
  for (int k = 1; k < a.k_chunks; ++k) {
    const float4 u = *reinterpret_cast<const float4*>(src + (int64_t)k * a.Pp * a.Dp);
    v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
  }
  if (flags & STORE_BF16) {  // rounded by the store; the row-scatter kernel applies it
    store_bf16_cols<VEC>(a.upd1 + (int64_t)(a.B + p) * a.D, d, a.D, v);
    return;
  }
  if (flags & COMPUTE_BF16) v = make_float4(bf16r(v.x), bf16r(v.y), bf16r(v.z), bf16r(v.w));
  add_cols<VEC>(static_cast<float*>(a.syn1) + a.negatives[p] * (int64_t)a.D, d, a.D, v);
}

inline int64_t cdiv(int64_t x, int64_t y) { return (x + y - 1) / y; }
inline int pad(int x) { return (int)(cdiv(x, PAD) * PAD); }

// Raise the tile kernels' dynamic shared memory limit once per device.
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  const void* fns[] = {
      (const void*)fneg_kernel<false, false>, (const void*)fneg_kernel<true, false>,
      (const void*)fneg_kernel<false, true>, (const void*)fneg_kernel<true, true>,
      (const void*)update_kernel<false, false>, (const void*)update_kernel<true, false>,
      (const void*)update_kernel<false, true>, (const void*)update_kernel<true, true>};
  for (const void* fn : fns) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
  }
  if (dev >= 0 && dev < 64) done[dev] = true;
  return cudaSuccess;
}

// The step's four launches in order on `st`; returns the first CUDA error.
template <bool X>
cudaError_t launch_step(const StepArgs& a, cudaStream_t st, bool with_metrics, bool vec) {
  const int pool_blocks = (int)cdiv((a.Pp / 32) * (a.Dp / 32), GATHER_WARPS);
  gather_kernel<X><<<(unsigned)(pool_blocks + cdiv(a.Bp, GATHER_WARPS)), GATHER_WARPS * 32,
                     0, st>>>(a, pool_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 fgrid((unsigned)(a.Pp / BN), (unsigned)(a.Bp / BM));
  if (with_metrics)
    fneg_kernel<true, X><<<fgrid, NT, SMEM_BYTES, st>>>(a);
  else
    fneg_kernel<false, X><<<fgrid, NT, SMEM_BYTES, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n_dz = (a.Pp / BN) * (a.Dp / BM) * a.k_chunks;
  const int n_din = (a.Bp / BM) * (a.Dp / BN);
  if (vec)
    update_kernel<true, X><<<(unsigned)(n_dz + n_din), NT, SMEM_BYTES, st>>>(a, n_dz);
  else
    update_kernel<false, X><<<(unsigned)(n_dz + n_din), NT, SMEM_BYTES, st>>>(a, n_dz);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const unsigned dz_blocks = (unsigned)cdiv((int64_t)a.P * (a.Dp / 4), DZ_THREADS);
  if (vec)
    dz_scatter_kernel<true, X><<<dz_blocks, DZ_THREADS, 0, st>>>(a);
  else
    dz_scatter_kernel<false, X><<<dz_blocks, DZ_THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch one step needs; the caller allocates them on the device.
int64_t glint_sgns_scratch_floats(int B, int P, int D) {
  const int64_t Bp = pad(B), Pp = pad(P), Dp = pad(D);
  const int64_t n_neg_part = (Bp / BM) * (Pp / BN);
  const int64_t k_chunks = cdiv(Bp, DZ_KCHUNK);
  return 2 * Bp * Dp + 4 * Pp * Dp + 3 * Bp * Pp + k_chunks * Pp * Dp + 3 * Bp +
         n_neg_part;
}

// One fused step, in place on f32 syn0/syn1; with STORE_BF16 in `flags` (bf16 syn0 and
// syn1) the updates go instead to upd0 ([B, D] bf16: d_in) and upd1 ([B + P, D] bf16:
// d_pos, then dZ), which the caller applies (the masked pairs' rows of upd0 and upd1 are
// not written). `alpha` is the device address of the step's learning rate (one float),
// which the kernels read at run time: a CUDA graph that captures this call takes each
// replay's alpha from that address. The host side makes no call that a stream capture
// forbids (it allocates and synchronizes nothing; the shared-memory limit is raised once
// per device, before any capture of the trainer, which warms the step up first).
// Returns cudaGetLastError() after the launches (0 = launched); the launches are
// asynchronous on `stream`.
int glint_sgns_shared_step(void* syn0, void* syn1, const void* centers,
                           const void* contexts, const void* mask,
                           const void* negatives, void* scratch, void* metrics,
                           void* upd0, void* upd1, int B, int P, int D,
                           const void* alpha, float ratio, int clipped, int with_metrics,
                           int flags, void* stream) {
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  StepArgs a;
  if (!alpha || ((flags & STORE_BF16) && (!upd0 || !upd1)))
    return (int)cudaErrorInvalidValue;
  a.syn0 = syn0;
  a.syn1 = syn1;
  a.upd0 = static_cast<unsigned short*>(upd0);
  a.upd1 = static_cast<unsigned short*>(upd1);
  a.flags = flags;
  a.centers = static_cast<const int64_t*>(centers);
  a.contexts = static_cast<const int64_t*>(contexts);
  a.mask = static_cast<const float*>(mask);
  a.negatives = static_cast<const int64_t*>(negatives);
  a.B = B;
  a.P = P;
  a.D = D;
  a.Bp = pad(B);
  a.Pp = pad(P);
  a.Dp = pad(D);
  float* s = static_cast<float*>(scratch);
  a.E = s;
  s += (int64_t)a.Bp * a.Dp;
  a.Pc = s;
  s += (int64_t)a.Bp * a.Dp;
  a.Zb = s;
  s += (int64_t)a.Pp * a.Dp;
  a.Zs = s;
  s += (int64_t)a.Pp * a.Dp;
  a.Ztb = s;
  s += (int64_t)a.Pp * a.Dp;
  a.Zts = s;
  s += (int64_t)a.Pp * a.Dp;
  a.G = s;
  s += (int64_t)a.Bp * a.Pp;
  a.Gtb = s;
  s += (int64_t)a.Bp * a.Pp;
  a.Gts = s;
  s += (int64_t)a.Bp * a.Pp;
  a.k_chunks = (int)cdiv(a.Bp, DZ_KCHUNK);
  a.dz_part = s;
  s += (int64_t)a.k_chunks * a.Pp * a.Dp;
  a.gpos = s;
  s += a.Bp;
  a.pos_loss = s;
  s += a.Bp;
  a.fpos = s;
  s += a.Bp;
  a.neg_part = s;
  a.n_neg_part = (a.Bp / BM) * (a.Pp / BN);
  a.metrics = static_cast<float*>(metrics);
  a.alpha = static_cast<const float*>(alpha);
  a.ratio = ratio;
  a.clipped = clipped;
  a.with_metrics = with_metrics;
  // float4 atomics need 16-byte aligned rows, the bf16 scratch stores 8-byte ones
  const bool vec = D % 4 == 0 &&
                   ((flags & STORE_BF16)
                        ? reinterpret_cast<uintptr_t>(upd0) % 8 == 0 &&
                              reinterpret_cast<uintptr_t>(upd1) % 8 == 0
                        : reinterpret_cast<uintptr_t>(syn0) % 16 == 0 &&
                              reinterpret_cast<uintptr_t>(syn1) % 16 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  return (int)(flags ? launch_step<true>(a, st, with_metrics, vec)
                     : launch_step<false>(a, st, with_metrics, vec));
}

}  // extern "C"
