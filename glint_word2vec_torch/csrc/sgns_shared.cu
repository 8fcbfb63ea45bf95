// Fused shared-pool SGNS training step for NVIDIA Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel glint_word2vec_tpu/ops/pallas/sgns_kernel.py:_sgns_tile_kernel
// and computes what glint_word2vec_tpu/ops/sgns.py:sgns_step_shared_core computes
// (its plain PyTorch twin is glint_word2vec_torch/ops/sgns.py), for f32 parameters:
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
// launch, which copies the touched rows into scratch (E, Pc, Z); the later launches
// read only scratch and scatter into syn0/syn1 with fp32 atomicAdd. Three launches on
// one stream:
//   1. gather_pos:  row gathers into scratch, f_pos, g_pos (one warp per row);
//   2. fneg:        G = coeff(E Z^T), tiled over (pair tile, pool tile), plus the
//                   per-block partial sums of the negative loss;
//   3. update:      d_in = g_pos * Pc + G Z scattered into syn0 and d_pos = g_pos * E
//                   into syn1 (tiles of pairs x D), and dZ = G^T E scattered into
//                   syn1[neg] (tiles of pool x D, split over the batch), plus the final
//                   fixed-order reduction of the loss partials.
// The atomics make the summation order of duplicate rows vary from run to run; the
// products themselves use a fixed order.
//
// What bounds it: the three products are 6*B*P*D flops (4.8 GFLOP at B=8192, P=256,
// D=384) against ~80 MB of row traffic, so on fp32 CUDA cores it is compute-bound
// (~72 us at 67 TFLOP/s). The design keeps the products on CUDA cores in full fp32
// (no TF32: it would break the f32 tolerance against the reference) with a 64x64 tile,
// 16-deep k-slices in shared memory and a 4x4 register block per thread; wgmma, TMA
// and a sorted scatter are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // tile rows
constexpr int BN = 64;    // tile cols
constexpr int BK = 16;    // k-slice depth
constexpr int NT = 256;   // threads per tile block (16 x 16, 4 x 4 outputs each)
constexpr int DZ_KCHUNK = 1024;  // pairs per dZ block (split over the batch)
constexpr int GATHER_WARPS = 8;  // rows per gather block
constexpr float MAX_EXP = 6.0f;

enum Mode { FNEG = 0, DZ = 1, DIN = 2 };

struct StepArgs {
  float* syn0;             // [V, D]
  float* syn1;             // [V, D]
  const int64_t* centers;  // [B]
  const int64_t* contexts; // [B]
  const float* mask;       // [B]
  const int64_t* negatives;// [P]
  float* E;                // [B, D] scratch: syn0[centers]
  float* Pc;               // [B, D] scratch: syn1[contexts]
  float* Z;                // [P, D] scratch: syn1[negatives]
  float* G;                // [B, P] scratch: g_neg
  float* gpos;             // [B]    scratch: g_pos
  float* pos_loss;         // [B]    scratch: softplus(-f_pos) * mask
  float* fpos;             // [B]    scratch: f_pos * mask
  float* neg_part;         // [n_fneg_blocks] scratch: sum softplus(f_neg) * valid
  float* metrics;          // [2] out: loss numerator, f_pos numerator
  int B, P, D;
  int n_neg_part;
  float alpha;
  float ratio;             // num_negatives / P
  int clipped;
  int with_metrics;
};

__device__ __forceinline__ float sigmoid_f(float f, int clipped) {
  if (clipped) {
    if (f > MAX_EXP) return 1.0f;
    if (f < -MAX_EXP) return 0.0f;
  }
  return 1.0f / (1.0f + expf(-f));
}

__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
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

__global__ void __launch_bounds__(GATHER_WARPS * 32) gather_pos_kernel(StepArgs a) {
  const int row = blockIdx.x * GATHER_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int D = a.D;
  if (row < a.B) {
    const float* e = a.syn0 + a.centers[row] * (int64_t)D;
    const float* p = a.syn1 + a.contexts[row] * (int64_t)D;
    float* eo = a.E + (int64_t)row * D;
    float* po = a.Pc + (int64_t)row * D;
    float dot = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float ev = e[d], pv = p[d];
      eo[d] = ev;
      po[d] = pv;
      dot = fmaf(ev, pv, dot);
    }
    for (int off = 16; off; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) {
      const float m = a.mask[row];
      a.gpos[row] = (1.0f - sigmoid_f(dot, a.clipped)) * a.alpha * m;
      if (a.with_metrics) {
        a.pos_loss[row] = softplus_f(-dot) * m;
        a.fpos[row] = dot * m;
      }
    }
  } else if (row < a.B + a.P) {
    const int q = row - a.B;
    const float* z = a.syn1 + a.negatives[q] * (int64_t)D;
    float* zo = a.Z + (int64_t)q * D;
    for (int d = lane; d < D; d += 32) zo[d] = z[d];
  }
}

// One BM x BN output tile of C = A B over k in [k_begin, k_end), accumulated into acc.
// Operand layouts per mode (all row-major in global memory):
//   FNEG: A(m,k) = E[m, k]    B(k,n) = Z[n, k]     M=B, N=P, K=D
//   DZ:   A(m,k) = G[k, m]    B(k,n) = E[k, n]     M=P, N=D, K=B
//   DIN:  A(m,k) = G[m, k]    B(k,n) = Z[k, n]     M=B, N=D, K=P
// Tiles are staged k-major in shared memory, so the inner loop reads 4 consecutive
// rows and 4 consecutive cols of each k-slice as float4.
template <int MODE>
__device__ void gemm_tile(const StepArgs& a, int m0, int n0, int k_begin, int k_end,
                          float (*As)[BM + 4], float (*Bs)[BN + 4], float acc[4][4]) {
  const int M = MODE == DZ ? a.P : a.B;
  const int N = MODE == FNEG ? a.P : a.D;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / NT; ++i) {
      const int e = tid + i * NT;
      // consecutive threads walk the operand's contiguous dimension
      const int mm = MODE == DZ ? e % BM : e / BK;
      const int kk = MODE == DZ ? e / BM : e % BK;
      const int m = m0 + mm, k = k0 + kk;
      float v = 0.0f;
      if (m < M && k < k_end) {
        if (MODE == FNEG) v = a.E[(int64_t)m * a.D + k];
        else if (MODE == DZ) v = a.G[(int64_t)k * a.P + m];
        else v = a.G[(int64_t)m * a.P + k];
      }
      As[kk][mm] = v;
    }
#pragma unroll
    for (int i = 0; i < (BN * BK) / NT; ++i) {
      const int e = tid + i * NT;
      const int nn = MODE == FNEG ? e / BK : e % BN;
      const int kk = MODE == FNEG ? e % BK : e / BN;
      const int n = n0 + nn, k = k0 + kk;
      float v = 0.0f;
      if (n < N && k < k_end) {
        if (MODE == FNEG) v = a.Z[(int64_t)n * a.D + k];
        else if (MODE == DZ) v = a.E[(int64_t)k * a.D + n];
        else v = a.Z[(int64_t)k * a.D + n];
      }
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT) fneg_kernel(StepArgs a) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  __shared__ float red[NT / 32];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  gemm_tile<FNEG>(a, m0, n0, 0, a.D, As, Bs, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float lsum = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = m0 + ty * 4 + i;
    if (b >= a.B) continue;
    const int64_t ctx = a.contexts[b];
    const float m = a.mask[b];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = n0 + tx * 4 + j;
      if (p >= a.P) continue;
      const float f = acc[i][j];
      const float valid = ctx != a.negatives[p] ? m : 0.0f;
      a.G[(int64_t)b * a.P + p] =
          (0.0f - sigmoid_f(f, a.clipped)) * a.alpha * valid * a.ratio;
      if (a.with_metrics) lsum += softplus_f(f) * valid;
    }
  }
  if (a.with_metrics) {
    const float s = block_sum(lsum, red);
    if (threadIdx.x == 0) a.neg_part[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// Blocks [0, n_dz) take dZ tiles (pool tile x D tile x batch chunk), the rest take
// d_in/d_pos tiles (pair tile x D tile). Block 0 also reduces the loss partials.
__global__ void __launch_bounds__(NT) update_kernel(StepArgs a, int n_dz, int d_tiles,
                                                    int k_chunks) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  __shared__ float red[NT / 32];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  int id = blockIdx.x;
  if (id < n_dz) {
    const int kc = id % k_chunks;
    id /= k_chunks;
    const int n0 = (id % d_tiles) * BN, m0 = (id / d_tiles) * BM;
    const int k_begin = kc * DZ_KCHUNK;
    const int k_end = min(a.B, k_begin + DZ_KCHUNK);
    gemm_tile<DZ>(a, m0, n0, k_begin, k_end, As, Bs, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = m0 + ty * 4 + i;
      if (p >= a.P) continue;
      float* row = a.syn1 + a.negatives[p] * (int64_t)a.D;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = n0 + tx * 4 + j;
        if (d < a.D) atomicAdd(row + d, acc[i][j]);
      }
    }
  } else {
    id -= n_dz;
    const int n0 = (id % d_tiles) * BN, m0 = (id / d_tiles) * BM;
    gemm_tile<DIN>(a, m0, n0, 0, a.P, As, Bs, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = m0 + ty * 4 + i;
      if (b >= a.B || a.mask[b] == 0.0f) continue;  // masked pairs add exact zeros
      const float gp = a.gpos[b];
      float* r0 = a.syn0 + a.centers[b] * (int64_t)a.D;
      float* r1 = a.syn1 + a.contexts[b] * (int64_t)a.D;
      const float* e = a.E + (int64_t)b * a.D;
      const float* p = a.Pc + (int64_t)b * a.D;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = n0 + tx * 4 + j;
        if (d >= a.D) continue;
        atomicAdd(r0 + d, gp * p[d] + acc[i][j]);
        atomicAdd(r1 + d, gp * e[d]);
      }
    }
  }
  if (blockIdx.x == 0 && a.with_metrics) {
    float pos = 0.0f, fp = 0.0f, neg = 0.0f;
    for (int b = threadIdx.x; b < a.B; b += NT) {
      pos += a.pos_loss[b];
      fp += a.fpos[b];
    }
    for (int q = threadIdx.x; q < a.n_neg_part; q += NT) neg += a.neg_part[q];
    const float pos_s = block_sum(pos, red);
    const float fp_s = block_sum(fp, red);
    const float neg_s = block_sum(neg, red);
    if (threadIdx.x == 0) {
      a.metrics[0] = pos_s + neg_s * a.ratio;
      a.metrics[1] = fp_s;
    }
  }
}

inline int64_t cdiv(int64_t x, int64_t y) { return (x + y - 1) / y; }

}  // namespace

extern "C" {

// Floats of scratch one step needs; the caller allocates them on the device.
int64_t glint_sgns_scratch_floats(int B, int P, int D) {
  const int64_t n_neg_part = cdiv(B, BM) * cdiv(P, BN);
  return 2 * (int64_t)B * D + (int64_t)P * D + (int64_t)B * P + 3 * (int64_t)B +
         n_neg_part;
}

// One fused step, in place on syn0/syn1. Returns cudaGetLastError() after the
// launches (0 = launched); the launches are asynchronous on `stream`.
int glint_sgns_shared_step(void* syn0, void* syn1, const void* centers,
                           const void* contexts, const void* mask,
                           const void* negatives, void* scratch, void* metrics,
                           int B, int P, int D, float alpha, float ratio, int clipped,
                           int with_metrics, void* stream) {
  StepArgs a;
  a.syn0 = static_cast<float*>(syn0);
  a.syn1 = static_cast<float*>(syn1);
  a.centers = static_cast<const int64_t*>(centers);
  a.contexts = static_cast<const int64_t*>(contexts);
  a.mask = static_cast<const float*>(mask);
  a.negatives = static_cast<const int64_t*>(negatives);
  float* s = static_cast<float*>(scratch);
  a.E = s;
  s += (int64_t)B * D;
  a.Pc = s;
  s += (int64_t)B * D;
  a.Z = s;
  s += (int64_t)P * D;
  a.G = s;
  s += (int64_t)B * P;
  a.gpos = s;
  s += B;
  a.pos_loss = s;
  s += B;
  a.fpos = s;
  s += B;
  a.neg_part = s;
  a.metrics = static_cast<float*>(metrics);
  a.B = B;
  a.P = P;
  a.D = D;
  a.n_neg_part = (int)(cdiv(B, BM) * cdiv(P, BN));
  a.alpha = alpha;
  a.ratio = ratio;
  a.clipped = clipped;
  a.with_metrics = with_metrics;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  gather_pos_kernel<<<(unsigned)cdiv(B + P, GATHER_WARPS), GATHER_WARPS * 32, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dim3 fgrid((unsigned)cdiv(P, BN), (unsigned)cdiv(B, BM));
  fneg_kernel<<<fgrid, NT, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int d_tiles = (int)cdiv(D, BN);
  const int k_chunks = (int)cdiv(B, DZ_KCHUNK);
  const int n_dz = (int)cdiv(P, BM) * d_tiles * k_chunks;
  const int n_din = (int)cdiv(B, BM) * d_tiles;
  update_kernel<<<(unsigned)(n_dz + n_din), NT, 0, st>>>(a, n_dz, d_tiles, k_chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
