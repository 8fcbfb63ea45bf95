// What bounds a one-warp-per-update-row scatter on an NVIDIA Hopper card (sm_90a):
// the measuring half of glint_word2vec_torch/scatterprobe.py --variants, plain C ABI.
//
// Mode 0 is the row scatter as the port shipped it first (one warp per update row,
// float4 loads, one vector atomicAdd per 16 bytes into the target row), kept as the
// yardstick the grouped kernel (csrc/scatter_rows.cu) is compared with on one card.
// The other modes keep its loop and change only what it writes, so that their times
// say what the atomics cost:
//   1  a plain float4 store into the same target row (racy: timing only);
//   2  a plain load-add-store into the same target row (racy: timing only);
//   3  a vector atomicAdd into row i of a [n, d] sink: distinct rows, no contention;
//   4  a plain float4 store into row i of the sink.
// Rows with live[i] == 0 are skipped in every mode; indices are trusted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int ROWS_PER_BLOCK = 32;

template <int MODE>
__global__ void __launch_bounds__(WARPS * 32)
probe_kernel(float* __restrict__ mat, const int64_t* __restrict__ idx,
             const float* __restrict__ upd, const float* __restrict__ live,
             float* __restrict__ sink, int64_t n, int d4) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t first = (int64_t)blockIdx.x * ROWS_PER_BLOCK;
  const int64_t last = first + ROWS_PER_BLOCK < n ? first + ROWS_PER_BLOCK : n;
  for (int64_t i = first + warp; i < last; i += WARPS) {
    if (live != nullptr && live[i] == 0.0f) continue;
    const float4* s4 = reinterpret_cast<const float4*>(upd) + i * d4;
    const int64_t row = (MODE <= 2) ? idx[i] : i;
    float4* t4 = reinterpret_cast<float4*>(MODE <= 2 ? mat : sink) + row * d4;
    for (int j = lane; j < d4; j += 32) {
      const float4 s = s4[j];
      if (MODE == 0 || MODE == 3) {
        atomicAdd(t4 + j, s);
      } else if (MODE == 2) {
        const float4 t = t4[j];
        t4[j] = make_float4(t.x + s.x, t.y + s.y, t.z + s.z, t.w + s.w);
      } else {
        t4[j] = s;
      }
    }
  }
}

}  // namespace

extern "C" {

// One launch of probe mode `mode` (0-4) over n update rows of d floats (d % 4 == 0,
// 16-byte aligned rows); sink is [n, d] for modes 3 and 4. Returns cudaGetLastError().
int glint_scatter_probe(int mode, void* mat, const void* idx, const void* upd,
                        const void* live, void* sink, int64_t n, int d, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mat);
  const int64_t* ix = static_cast<const int64_t*>(idx);
  const float* u = static_cast<const float*>(upd);
  const float* lv = static_cast<const float*>(live);
  float* sk = static_cast<float*>(sink);
  const int d4 = d / 4;
  switch (mode) {
    case 0: probe_kernel<0><<<blocks, WARPS * 32, 0, s>>>(m, ix, u, lv, sk, n, d4); break;
    case 1: probe_kernel<1><<<blocks, WARPS * 32, 0, s>>>(m, ix, u, lv, sk, n, d4); break;
    case 2: probe_kernel<2><<<blocks, WARPS * 32, 0, s>>>(m, ix, u, lv, sk, n, d4); break;
    case 3: probe_kernel<3><<<blocks, WARPS * 32, 0, s>>>(m, ix, u, lv, sk, n, d4); break;
    case 4: probe_kernel<4><<<blocks, WARPS * 32, 0, s>>>(m, ix, u, lv, sk, n, d4); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
