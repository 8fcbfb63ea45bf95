// Row scatter-add for NVIDIA Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel tools/pallas_vmem_scatter.py:kernel (line 58), the Pallas
// probe that applies Zipf-hot update rows one by one to their targets in on-chip
// memory. It computes, in place,
//
//   mat[idx[i], :] += upd[i, :]        for every i < n with live[i] != 0
//                                      (every i < n when live is null)
//
// for f32 mat [v, d], int64 idx [n], f32 upd [n, d], with duplicate indices SUMMED, as
// torch's index_add_ and JAX's .at[].add do. The Pallas probe is the special case of a
// zeroed [H, d] target. Every row scatter of the port's per-pair skip-gram step and of
// its scatter CBOW steps goes through this kernel; the wrapper and the plain version are
// glint_word2vec_torch/ops/scatter.py.
//
// Rows with live[i] == 0 are skipped: the steps pass their masks there, and a masked
// row's update is exactly zero, so skipping it changes nothing, while the padded slots
// it spares all point at row 0, the most frequent word, whose atomics would otherwise
// serialize. Indices outside [0, v) are not written; they set *err to 1, which the
// wrapper reads back and raises on (JAX's .at[].add drops them silently).
//
// Design: one warp per update row; a block of WARPS warps takes rows_per_block
// consecutive rows, each warp walking them with a stride of WARPS. A lane moves 16 bytes
// at a time: float4 loads of the update row and float4 atomicAdd into the target row
// (the vector atomic exists for global memory on sm_90). A scalar loop serves a row
// width that is not a multiple of 4 or a base that is not 16-byte aligned (vec == 0).
//
// What bounds it on an H100: bytes. The n update rows are read once (n*d*4 bytes), each
// of the u distinct target rows is read and written once (the atomics resolve in L2),
// the indices read once: at the per-pair syn1 shape (n = 49152, d = 384) that is 75.5 MB
// of update rows plus the targets, ~25-30 us at 3.35 TB/s. Atomics on one Zipf-hot row
// serialize in the L2 slice that holds it; the later designs (a shared-memory
// accumulator for the contiguous hot head, sort plus segmented reduce) attack that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // warps per block

__global__ void __launch_bounds__(WARPS * 32)
scatter_rows_kernel(float* __restrict__ mat, const int64_t* __restrict__ idx,
                    const float* __restrict__ upd, const float* __restrict__ live,
                    int64_t n, int64_t v, int d, int rows_per_block, int vec,
                    int* __restrict__ err) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t first = (int64_t)blockIdx.x * rows_per_block;
  const int64_t last = first + rows_per_block < n ? first + rows_per_block : n;
  for (int64_t i = first + warp; i < last; i += WARPS) {
    if (live != nullptr && live[i] == 0.0f) continue;
    const int64_t row = idx[i];
    if (row < 0 || row >= v) {
      if (lane == 0) atomicExch(err, 1);
      continue;
    }
    const float* src = upd + i * (int64_t)d;
    float* dst = mat + row * (int64_t)d;
    if (vec) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* t4 = reinterpret_cast<float4*>(dst);
      for (int j = lane; j < (d >> 2); j += 32) atomicAdd(t4 + j, s4[j]);
    } else {
      for (int j = lane; j < d; j += 32) atomicAdd(dst + j, src[j]);
    }
  }
}

}  // namespace

extern "C" {

// mat[idx[i]] += upd[i] for i < n (rows with live[i] == 0 skipped; live may be null),
// asynchronously on `stream`. Returns cudaGetLastError() after the launch (0 =
// launched). vec = 1 requires d % 4 == 0 and 16-byte aligned mat and upd.
int glint_scatter_rows(void* mat, const void* idx, const void* upd, const void* live,
                       int64_t n, int64_t v, int d, int rows_per_block, int vec,
                       void* err, void* stream) {
  if (n <= 0) return 0;
  if (rows_per_block <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  scatter_rows_kernel<<<(unsigned)blocks, WARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(mat), static_cast<const int64_t*>(idx),
      static_cast<const float*>(upd), static_cast<const float*>(live), n, v, d,
      rows_per_block, vec, static_cast<int*>(err));
  return (int)cudaGetLastError();
}

}  // extern "C"
