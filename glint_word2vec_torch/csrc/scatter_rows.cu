// Row scatter-add for NVIDIA Hopper (sm_90a), its updates grouped by target row within
// each warp (one launch) or across the call (four), plain C ABI.
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
// glint_word2vec_torch/ops/scatter.py. Rows with live[i] == 0 are skipped (the steps'
// masks: a masked row's update is exactly zero). Indices outside [0, v) are not written;
// they set *err to 1, which the wrapper reads back and raises on.
//
// What bounds it on an H100. The function's least traffic is bytes: the live update
// rows and their indices read once, each distinct target row read and written once.
// The port's first kernel issued one float4 atomicAdd (a reduction in L2) per 16 bytes
// of every live update row, one warp per row. Measured at the main path's shapes
// (scatterprobe.py --variants, which keeps that loop in csrc/probes/scatter_bound.cu;
// PERF.md), it ran at 47-51% of the byte bound on the device; the same loop with plain
// stores in place of the atomics ran 28-42% faster into the 1M-row matrices, while
// atomics into distinct rows cost as much as atomics into the Zipf-hot ones. So the
// L2's atomic throughput per update row set its pace, not HBM and not contention on
// hot rows.
//
// Two paths, chosen by the wrapper (ops/scatter.py: GROUP_RATIO) from the slots per
// target row, the one thing the host knows of the draw without a synchronisation.
//
// One launch (warp_kernel), unless the slots outnumber the rows twice over: every step
// of the model's 1M-word vocabulary. Each warp groups its 32 slots by row, sums each
// group in registers with 8 update rows in flight per lane, and adds the sum with one
// vector atomicAdd per 16 bytes. Against the first kernel it takes the atomics of a
// row's repeats within a warp (runs of equal centers, the Zipf head) and keeps many
// more loads in flight; it needs no state and no scratch. On the main shapes it ran at
// 66-76% of the byte bound (PERF.md).
//
// Grouped by row, when there are at least two slots per row: every distinct row gets
// one owner, which reads and writes it once with plain loads and stores, so the
// atomics leave the per-update path. Four launches, enqueued by one call, no host
// synchronisation:
//   A rank_kernel   each live, in-range slot takes its rank within its row. A block of
//                   1024 slots gathers its equal rows in a shared-memory hash table
//                   and takes each distinct row's ranks with one integer atomicAdd on
//                   count[row].
//   B plan_kernel   the slot of rank 0 plans its row: its count m (count[row] is
//                   cleared), a segment of m slots (pos[row] = its start) and
//                   ceil(m / chunk) work items. A block of 1024 slots scans its rows'
//                   needs and takes its segments and items with one 64-bit atomicAdd
//                   on a cursor that packs both counts; all its threads write the items.
//   C place_kernel  each ranked slot writes its index to perm[pos[row] + rank].
//   D reduce_kernel a persistent grid of warps walks the work items, each warp
//                   prefetching its next item. A warp loads a single-owner row's target
//                   while its updates are in flight, sums its chunk's update rows in
//                   registers (16-byte loads along d, IN_FLIGHT slots at a time) in perm
//                   order, and stores target + sum: the row's only writer. Update rows
//                   are loaded and target rows stored evict-first (__ldcs, __stcs). A
//                   hot row with more than `chunk` slots is cut into chunks whose warps add
//                   their sums with one vector atomicAdd per 16 bytes (ceil(m / chunk)
//                   atomics per column instead of m). The first chunk's warp clears
//                   pos[row].
// Why these choices (scatterprobe.py --variants, PERF.md): a first version, which took
// its place with one atomic per warp on global counters and summed 32-slot chunks two
// slots at a time, was slower than the atomic loop; its hot rows' long chunks set the
// reduce's tail, so chunks are short (ops/scatter.py: CHUNK). Rank and plan then still
// took 20-25 us at the per-pair shape whatever their atomics or barriers: their table
// accesses missed in L2 and waited behind the write-back of the target rows the
// previous reduce had left dirty there. With evict-first stores the reduce writes them
// back itself, at no cost to its own time, and rank and plan fell to 5 and 8 us.
// count and pos are persistent int32 [V] tables owned by the wrapper: zeroed once when
// allocated and left zeroed by every call (B clears count, D clears pos), so no call
// pays a memset. The counters live at the head of the scratch and are reset by C.
// The order of the slots within a row comes from the integer atomics (on the one-launch
// path, the order of the warps' atomics), so the fp32 sum is not bit-reproducible from
// run to run; it stays within the recursive-summation
// bound of any order, as the atomics' did. Grouping costs ~30 bytes per slot (ranks,
// permutation, work items, the [V] tables' touched entries), and its three launches
// take 10-17 us at 50k-80k slots whatever the draw: more than the one-launch path
// saves over the reduce alone unless rows repeat across warps, as they must when
// the slots outnumber the rows (the crossover lies between 1 and 4 slots per row).
//
// A scalar path (T = float) serves a row width that is not a multiple of 4 or a base
// that is not 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;       // place and reduce
constexpr int WARP_THREADS = 64;   // the one-launch path: two warps of 32 slots
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 1024;        // rank and plan: slots per block
constexpr int TABLE = 2 * GROUP;   // rank's hash table of a block's rows
constexpr int IN_FLIGHT = 4;       // update rows a reduce warp loads before it adds them
constexpr unsigned FULL = 0xffffffffu;
constexpr int HEAD = 16;  // ints at the head of the scratch: the counters below
// counters: ints 0-1 are one 64-bit cursor (low word: work items, high word: slots),
// advanced by B; int 2 is the work items of this call (C -> D)
enum { CURSOR = 0, WORK_ITEMS = 2 };
enum { FIRST_CHUNK = 1, SHARED_ROW = 2 };  // work item flags

__global__ void __launch_bounds__(GROUP)
rank_kernel(const int64_t* __restrict__ idx, const float* __restrict__ live, int n,
            int64_t v, int* __restrict__ count, int* __restrict__ rank,
            int* __restrict__ err) {
  __shared__ int keys[TABLE], tally[TABLE];
#pragma unroll
  for (int e = 0; e < TABLE; e += GROUP) {
    keys[e + threadIdx.x] = -1;
    tally[e + threadIdx.x] = 0;
  }
  const int i = blockIdx.x * GROUP + threadIdx.x;
  int row = -1;
  if (i < n) {  // both loads in flight at once
    const int64_t r = idx[i];
    const bool on = live == nullptr || live[i] != 0.0f;
    if (on && (r < 0 || r >= v)) {
      *reinterpret_cast<volatile int*>(err) = 1;  // host memory: a plain store
    } else if (on) {
      row = (int)r;
    }
  }
  __syncthreads();
  int h = 0, local = 0;
  if (row >= 0) {  // the block's slot of this row in the table (linear probing)
    h = (int)(((unsigned)row * 2654435761u) >> 21);  // 11 bits: TABLE = 2048
    for (;;) {
      const int k = atomicCAS(keys + h, -1, row);
      if (k == -1 || k == row) break;
      h = (h + 1) & (TABLE - 1);
    }
    local = atomicAdd(tally + h, 1);
  }
  __syncthreads();
  // one global atomic per distinct row of the block; tally becomes the block's base
  int key[TABLE / GROUP], got[TABLE / GROUP];
#pragma unroll
  for (int j = 0; j < TABLE / GROUP; ++j) {
    key[j] = keys[j * GROUP + threadIdx.x];
    if (key[j] >= 0) got[j] = atomicAdd(count + key[j], tally[j * GROUP + threadIdx.x]);
  }
#pragma unroll
  for (int j = 0; j < TABLE / GROUP; ++j) {
    if (key[j] >= 0) tally[j * GROUP + threadIdx.x] = got[j];
  }
  __syncthreads();
  if (i < n) rank[i] = row >= 0 ? tally[h] + local : -1;  // -1: the slot is skipped
}

// The block's inclusive scans of (m, c); warp 0 scans the warp sums and its lane 31
// advances the 64-bit cursor by the block's totals, so that one barrier after the
// warp sums serves both. Returns the thread's inclusive sums; *base gets the block's
// first slot and first work item.
__device__ __forceinline__ int2 plan_scan(int m, int c, int2* warp_sums, int2* base,
                                          int* counters) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const int ym = __shfl_up_sync(FULL, m, off);
    const int yc = __shfl_up_sync(FULL, c, off);
    if (lane >= off) {
      m += ym;
      c += yc;
    }
  }
  if (lane == 31) warp_sums[warp] = make_int2(m, c);
  __syncthreads();
  if (warp == 0) {  // GROUP / 32 == 32 warp sums, one per lane
    const int2 own = warp_sums[lane];
    int sm = own.x, sc = own.y;
    for (int off = 1; off < 32; off <<= 1) {
      const int ym = __shfl_up_sync(FULL, sm, off);
      const int yc = __shfl_up_sync(FULL, sc, off);
      if (lane >= off) {
        sm += ym;
        sc += yc;
      }
    }
    warp_sums[lane] = make_int2(sm - own.x, sc - own.y);
    if (lane == 31) {  // one atomic per block advances both cursors
      const unsigned long long old = atomicAdd(
          reinterpret_cast<unsigned long long*>(counters + CURSOR),
          ((unsigned long long)sm << 32) | (unsigned)sc);
      *base = make_int2((int)(old >> 32), (int)(old & 0xffffffffu));
    }
  }
  __syncthreads();
  const int2 before = warp_sums[warp];
  return make_int2(m + before.x, c + before.y);
}

__global__ void __launch_bounds__(GROUP)
plan_kernel(const int64_t* __restrict__ idx, const int* __restrict__ rank, int n,
            int* __restrict__ count, int* __restrict__ pos, int4* __restrict__ work,
            int* __restrict__ counters, int chunk) {
  static_assert(GROUP == 32 * 32, "plan_scan gives warp 0 one warp sum per lane");
  __shared__ int2 warp_sums[GROUP / 32], base;
  __shared__ int s_row[GROUP], s_start[GROUP], s_m[GROUP], s_cend[GROUP];
  const int i = blockIdx.x * GROUP + threadIdx.x;
  int row = 0, m = 0, c = 0;
  if (i < n) {
    const int r = rank[i];
    const int64_t x = idx[i];  // in flight with rank[i]
    if (r == 0) {  // the row's slot of rank 0 plans the row
      row = (int)x;
      m = count[row];
      count[row] = 0;
      c = (m + chunk - 1) / chunk;
    }
  }
  const int2 end = plan_scan(m, c, warp_sums, &base, counters);
  const int start = base.x + end.x - m;
  if (c > 0) pos[row] = start;
  s_row[threadIdx.x] = row;
  s_start[threadIdx.x] = start;
  s_m[threadIdx.x] = m;
  s_cend[threadIdx.x] = end.y;
  __syncthreads();
  const int total_c = s_cend[GROUP - 1];
  // the block's work items, spread over its threads: item k belongs to the first
  // thread whose inclusive chunk count exceeds k
  for (int k = threadIdx.x; k < total_c; k += GROUP) {
    int lo = 0, hi = GROUP - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_cend[mid] > k) hi = mid; else lo = mid + 1;
    }
    const int cm = (s_m[lo] + chunk - 1) / chunk;
    const int q = k - (s_cend[lo] - cm);
    work[base.y + k] = make_int4(s_row[lo], s_start[lo] + q * chunk,
                                 min(chunk, s_m[lo] - q * chunk),
                                 (cm > 1 ? SHARED_ROW : 0) | (q == 0 ? FIRST_CHUNK : 0));
  }
}

__global__ void __launch_bounds__(THREADS)
place_kernel(const int64_t* __restrict__ idx, const int* __restrict__ rank,
             const int* __restrict__ pos, int* __restrict__ perm, int n,
             int* __restrict__ counters) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i == 0) {  // B has finished with the cursor: hand D its work items, reset it
    counters[WORK_ITEMS] = counters[CURSOR];
    *reinterpret_cast<unsigned long long*>(counters + CURSOR) = 0;
  }
  if (i < n) {
    const int r = rank[i];
    if (r >= 0) perm[pos[(int)idx[i]] + r] = i;
  }
}

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }

template <typename T, int U>
__device__ __forceinline__ void add_row(float* mat, int row, int cols, int c0,
                                        const T (&acc)[U]) {
  T* dst = reinterpret_cast<T*>(mat) + (int64_t)row * cols;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (c0 + 32 * u < cols) atomicAdd(dst + c0 + 32 * u, acc[u]);
  }
}

// T = float4 (cols = d / 4) or float (cols = d); U = columns of T per lane per pass.
template <typename T, int U>
__global__ void __launch_bounds__(THREADS)
reduce_kernel(float* __restrict__ mat, const float* __restrict__ upd,
              const int* __restrict__ perm, const int4* __restrict__ work,
              int* __restrict__ pos, const int* __restrict__ counters, int cols) {
  const int lane = threadIdx.x & 31;
  const int items = counters[WORK_ITEMS];
  const int stride = gridDim.x * WARPS;
  const T* src = reinterpret_cast<const T*>(upd);
  int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  int4 it = w < items ? work[w] : make_int4(0, 0, 0, 0);
  while (w < items) {
    const int4 next = w + stride < items ? work[w + stride] : it;  // prefetched
    const int row = it.x, start = it.y, len = it.z, flags = it.w;
    const bool shared = flags & SHARED_ROW;
    if ((flags & FIRST_CHUNK) && lane == 0) pos[row] = 0;
    T* dst = reinterpret_cast<T*>(mat) + (int64_t)row * cols;
    for (int base = 0; base < cols; base += 32 * U) {  // warp-uniform: shuffles inside
      const int c0 = base + lane;
      T acc[U], old[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        acc[u] = zero<T>();
        // the sole owner of a row reads it while the updates are in flight
        if (!shared && c0 + 32 * u < cols) old[u] = dst[c0 + 32 * u];
      }
      for (int s0 = 0; s0 < len; s0 += 32) {
        const int mine = s0 + lane < len ? perm[start + s0 + lane] : 0;
        const int cnt = min(32, len - s0);
        for (int t = 0; t < cnt; t += IN_FLIGHT) {
          T x[IN_FLIGHT][U];
#pragma unroll
          for (int j = 0; j < IN_FLIGHT; ++j) {
            const int slot = __shfl_sync(FULL, mine, (t + j) & 31);
            if (t + j < cnt) {
              const T* r = src + (int64_t)slot * cols + c0;
#pragma unroll
              for (int u = 0; u < U; ++u) {
                // read once: evict-first, so the stream does not push the [V]
                // tables and the target rows out of L2
                if (c0 + 32 * u < cols) x[j][u] = __ldcs(r + 32 * u);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < IN_FLIGHT; ++j) {
            if (t + j < cnt) {
#pragma unroll
              for (int u = 0; u < U; ++u) {
                if (c0 + 32 * u < cols) acc[u] = add(acc[u], x[j][u]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int col = c0 + 32 * u;
        if (col >= cols) continue;
        if (shared) {
          atomicAdd(dst + col, acc[u]);
        } else {
          // evict-first: the row is written back during this launch, not while
          // the next call's grouping waits on L2 misses behind it
          __stcs(dst + col, add(old[u], acc[u]));
        }
      }
    }
    it = next;
    w += stride;
  }
}

// W: the whole call in one launch (the path taken unless the slots outnumber the
// target's rows). Each warp takes 32 consecutive slots and groups them by row
// (__match_any_sync), orders them group by group in slot order, and walks that order F
// update rows at a time: it sums a group's rows in registers and adds the sum to the
// target row with one vector atomicAdd per 16 bytes. A row's slots within a warp cost
// one atomic row; runs of equal rows (the per-pair step's centers) most of all.
template <typename T, int U>
__global__ void __launch_bounds__(WARP_THREADS)
warp_kernel(float* __restrict__ mat, const int64_t* __restrict__ idx,
             const float* __restrict__ upd, const float* __restrict__ live, int n,
             int64_t v, int cols, int* __restrict__ err) {
  constexpr int F = 24 / U;  // update rows in flight per lane: 24 registers of T
  __shared__ int order[WARP_THREADS / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = (blockIdx.x * (WARP_THREADS / 32) + warp) * 32;
  if (seg >= n) return;  // warp-uniform
  int row = -1;
  if (seg + lane < n) {
    const int64_t r = idx[seg + lane];
    const bool on = live == nullptr || live[seg + lane] != 0.0f;
    if (on && (r < 0 || r >= v)) {
      *reinterpret_cast<volatile int*>(err) = 1;  // host memory: a plain store
    } else if (on) {
      row = (int)r;
    }
  }
  // the warp's groups, laid out by their first lane: lane p of the order holds the
  // p-th live slot, groups contiguous and each in slot order
  const unsigned same = __match_any_sync(FULL, row);
  const int leader = __ffs(same) - 1;
  const int size = lane == leader && row >= 0 ? __popc(same) : 0;
  int ends = size;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, ends, off);
    if (lane >= off) ends += y;
  }
  const int start = __shfl_sync(FULL, ends - size, leader);
  const int total = __popc(__ballot_sync(FULL, row >= 0));
  if (row >= 0) order[warp][start + __popc(same & ((1u << lane) - 1))] = lane;
  __syncwarp();
  const int src = lane < total ? order[warp][lane] : 0;
  const int p_row = __shfl_sync(FULL, row, src);
  const int p_slot = seg + src;
  const T* in = reinterpret_cast<const T*>(upd);
  for (int base = 0; base < cols; base += 32 * U) {  // warp-uniform: shuffles inside
    const int c0 = base + lane;
    T acc[U];
    int cur = -1;  // the row acc belongs to
    for (int t = 0; t < total; t += F) {
      T x[F][U];
      int rj[F];
#pragma unroll
      for (int j = 0; j < F; ++j) {
        const int slot = __shfl_sync(FULL, p_slot, (t + j) & 31);
        rj[j] = __shfl_sync(FULL, p_row, (t + j) & 31);
        if (t + j < total) {
          const T* r = in + (int64_t)slot * cols + c0;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (c0 + 32 * u < cols) x[j][u] = __ldcs(r + 32 * u);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < F; ++j) {
        if (t + j >= total) break;
        if (rj[j] != cur) {  // a new group: add the last one's sum to its row
          if (cur >= 0) add_row<T, U>(mat, cur, cols, c0, acc);
          cur = rj[j];
#pragma unroll
          for (int u = 0; u < U; ++u) acc[u] = zero<T>();
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (c0 + 32 * u < cols) acc[u] = add(acc[u], x[j][u]);
        }
      }
    }
    if (cur >= 0) add_row<T, U>(mat, cur, cols, c0, acc);
  }
}

int64_t work_offset(int64_t n) { return (HEAD + 2 * n + 3) & ~int64_t(3); }

struct Occupancy {
  int sms = 0;
  int blocks[2][4] = {};  // [vec][U - 1]: resident blocks of reduce_kernel per SM
};
Occupancy occupancy[64];

template <typename T, int U>
int reduce_blocks(int sms) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reduce_kernel<T, U>, THREADS, 0);
  return per_sm * sms;
}

template <typename T, int U>
void launch_reduce(int blocks, cudaStream_t s, float* mat, const float* upd,
                   const int* perm, const int4* work, int* pos, const int* counters,
                   int cols) {
  reduce_kernel<T, U><<<blocks, THREADS, 0, s>>>(mat, upd, perm, work, pos, counters,
                                                  cols);
}

}  // namespace

extern "C" {

// Bytes of scratch a grouped call over n slots needs: the counters, ranks, permutation
// and work items (at most one per live slot).
int64_t glint_scatter_scratch_bytes(int64_t n) { return 4 * (work_offset(n) + 4 * n); }

// mat[idx[i]] += upd[i] for i < n (rows with live[i] == 0 skipped; live may be null),
// asynchronously on `stream`: grouped by row in four launches when `grouped` is set,
// else in one. An index outside [0, v) sets the int32 *err to 1: a word of mapped host
// memory from glint_scatter_flag_create (its device pointer), which the host reads
// once the launches have run. For a grouped call, count and pos are int32 tables of at
// least v entries, all zero, and are left so, and scratch holds
// glint_scatter_scratch_bytes(n) bytes, 16-byte aligned; the one-launch path uses none
// of the three (they may be null). chunk is the most slots one owner sums. n < 2^31,
// v <= 2^31. Returns the first CUDA error of the enqueue (0 = launched).
int glint_scatter_rows(void* mat, const void* idx, const void* upd, const void* live,
                       int64_t n, int64_t v, int d, int chunk, int grouped, void* count,
                       void* pos, void* scratch, void* err, void* stream) {
  if (n <= 0) return 0;
  if (chunk <= 0 || d <= 0 || n >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(mat) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(upd) % 16 == 0;
  const int cols = vec ? d / 4 : d;
  const int lanes_u = (cols + 31) / 32;
  const int U = lanes_u < 4 ? lanes_u : 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mat);
  const float* u = static_cast<const float*>(upd);
  const int64_t* ix = static_cast<const int64_t*>(idx);
  const float* lv = static_cast<const float*>(live);
  const int ni = (int)n;
  if (!grouped) {
    const unsigned blocks = (unsigned)((n + WARP_THREADS - 1) / WARP_THREADS);
    int* e = static_cast<int*>(err);
    if (!vec) {
      warp_kernel<float, 4><<<blocks, WARP_THREADS, 0, s>>>(m, ix, u, lv, ni, v, cols, e);
    } else if (U == 1) {
      warp_kernel<float4, 1><<<blocks, WARP_THREADS, 0, s>>>(m, ix, u, lv, ni, v, cols, e);
    } else if (U == 2) {
      warp_kernel<float4, 2><<<blocks, WARP_THREADS, 0, s>>>(m, ix, u, lv, ni, v, cols, e);
    } else if (U == 3) {
      warp_kernel<float4, 3><<<blocks, WARP_THREADS, 0, s>>>(m, ix, u, lv, ni, v, cols, e);
    } else {
      warp_kernel<float4, 4><<<blocks, WARP_THREADS, 0, s>>>(m, ix, u, lv, ni, v, cols, e);
    }
    return (int)cudaGetLastError();
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  Occupancy& occ = occupancy[dev];
  if (occ.sms == 0) {
    e = cudaDeviceGetAttribute(&occ.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    occ.blocks[1][0] = reduce_blocks<float4, 1>(occ.sms);
    occ.blocks[1][1] = reduce_blocks<float4, 2>(occ.sms);
    occ.blocks[1][2] = reduce_blocks<float4, 3>(occ.sms);
    occ.blocks[1][3] = reduce_blocks<float4, 4>(occ.sms);
    occ.blocks[0][3] = reduce_blocks<float, 4>(occ.sms);
  }
  int* head = static_cast<int*>(scratch);
  int* rank = head + HEAD;
  int* perm = rank + n;
  int4* work = reinterpret_cast<int4*>(head + work_offset(n));
  int* cnt = static_cast<int*>(count);
  int* ps = static_cast<int*>(pos);
  const unsigned slot_blocks = (unsigned)((n + THREADS - 1) / THREADS);
  const unsigned group_blocks = (unsigned)((n + GROUP - 1) / GROUP);

  rank_kernel<<<group_blocks, GROUP, 0, s>>>(ix, lv, ni, v, cnt, rank,
                                             static_cast<int*>(err));
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  plan_kernel<<<group_blocks, GROUP, 0, s>>>(ix, rank, ni, cnt, ps, work, head, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  place_kernel<<<slot_blocks, THREADS, 0, s>>>(ix, rank, ps, perm, ni, head);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  int blocks = vec ? occ.blocks[1][U - 1] : occ.blocks[0][3];
  const int64_t want = (n + WARPS - 1) / WARPS;  // one warp per slot at most
  if (blocks > want) blocks = (int)want;
  if (blocks < 1) blocks = 1;
  if (!vec) {
    launch_reduce<float, 4>(blocks, s, m, u, perm, work, ps, head, cols);
  } else if (U == 1) {
    launch_reduce<float4, 1>(blocks, s, m, u, perm, work, ps, head, cols);
  } else if (U == 2) {
    launch_reduce<float4, 2>(blocks, s, m, u, perm, work, ps, head, cols);
  } else if (U == 3) {
    launch_reduce<float4, 3>(blocks, s, m, u, perm, work, ps, head, cols);
  } else {
    launch_reduce<float4, 4>(blocks, s, m, u, perm, work, ps, head, cols);
  }
  return (int)cudaGetLastError();
}

// A zeroed int32 word of pinned host memory mapped into the device's address space
// (the kernels' error flag), or null on failure. It lives as long as the process.
void* glint_scatter_flag_create(void) {
  void* host = nullptr;
  if (cudaHostAlloc(&host, sizeof(int), cudaHostAllocMapped) != cudaSuccess) return nullptr;
  *static_cast<volatile int*>(host) = 0;
  return host;
}

// The device pointer of a word from glint_scatter_flag_create, or null on failure.
void* glint_scatter_flag_device(void* host) {
  void* dev = nullptr;
  if (cudaHostGetDevicePointer(&dev, host, 0) != cudaSuccess) return nullptr;
  return dev;
}

}  // extern "C"
