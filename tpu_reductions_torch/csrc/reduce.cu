// Hand-written Hopper (sm_90a) kernels of the single-chip reduction
// benchmark, bound to Python with ctypes (tpu_reductions_torch/ops/_cuda.py).
//
// Replaces two TPU kernels of the JAX package:
//   k6  tpu_reductions/ops/pallas_reduce.py::single_pass_call
//       (pallas_call at :209 via _accumulator_call, kernel :182-201,
//       fold _tile_to_sublane :167-179);
//   k7  tpu_reductions/ops/pallas_reduce.py::two_pass_call
//       (kernel _two_pass_kernel :364-387), relaunched by _multipass_finish.
//
// Both read a staged (rows, 128) array, rows a multiple of SUB (8 rows; 16
// for bf16), and fill accumulator slots that are defined independently of
// the launch geometry: slot (r, c) of a (SUB, 128) block is the combine,
// over the rows that block covers and that are congruent to r modulo SUB,
// of column c. k6 covers every row in one (SUB, 128) block; k7 block i
// covers rows [i*span, (i+1)*span) below `rows`, so rows that the tiling
// counts past the end of the array read as the op's identity (what an
// identity padding would hold). So the geometry is free, and int32 and
// MIN/MAX results equal the JAX kernels' accumulators element by element.
//
// Bound: each kernel reads every staged byte once and writes a few KiB, so
// both are bound by device-memory bytes (rows * 128 * itemsize over the
// card's bandwidth), never by arithmetic. What the design does about it:
//   - 16-byte loads, deep. A team of 256 threads covers one SUB x 128 slot
//     group (4 KiB; 8 KiB of f64): thread t loads the 16-byte vectors t
//     (and, for f64, t + 256) of each group, 4 int32/f32, 2 f64 or 8 bf16
//     neighbouring slots of one row, so one warp load is 512 contiguous
//     bytes. The group walk is unrolled by 8, so a CTA of two teams keeps
//     64 KiB in flight, and the loads ask L2 for whole 256-byte spans and
//     skip L1 (the data is read once).
//   - Enough CTAs, in clusters where the blocks are too few. About 64 such
//     CTAs, one per two SMs, read at the card's full rate. fold_span folds
//     each partial block with a thread-block cluster of S CTAs: CTA s of
//     the cluster takes a contiguous, SUB-row-aligned share of the block's
//     span, its teams fold their slots through shared memory, and the
//     cluster's rank 0 folds the S CTAs' slots over distributed shared
//     memory, in rank order, and alone writes the partial. A cluster launch
//     costs about a microsecond more than a plain one, so the wrapper
//     (ops/kernel_reduce.plan_k6 / plan_k7) takes S > 1 only where the
//     partial blocks alone would leave the card short: k6 runs 8 clusters
//     of 8 CTAs, k7's default P = 64 one CTA per block, P = 2 clusters of 8.
//   - A short second pass. k6 leaves one partial per cluster, and
//     fold_blocks spreads them over SUB CTAs, one per slot row, instead of
//     one CTA reading them all.
// No floating-point atomics: the order of every combine depends on the
// shape and the device (its SM count and cluster occupancy) alone, so the
// same staged tensor gives the same bits on every call, float SUM
// included.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tr;

constexpr int TEAMS = 2;           // teams of TEAM threads of one CTA
constexpr int CTA = TEAM * TEAMS;  // threads of one CTA
constexpr int UNROLL = 8;          // groups a team walks per step
constexpr int MAX_CLUSTER = 8;     // the portable cluster-size limit

__device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}

// One pass over a staged (rows, 128) array: partial block i of `out` is
// the (SUB, 128) fold of rows [i*span, min((i+1)*span, rows)), folded by
// the cluster of CTAs [i*S, (i+1)*S). Cluster rank s folds the share
// [i*span + s*share, +share) of that span; team w of the CTA takes the
// share's groups w, w + TEAMS, ... in order.
template <int OP, class T, class O, int SUB>
__global__ void __launch_bounds__(CTA, 2)
fold_span(const T* __restrict__ in, O* __restrict__ out, long long rows,
          long long span, long long share) {
  using R = decltype(widen(T()));
  using L = Layout<T, SUB>;
  __shared__ R fold[TEAMS][SUB * LANES];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const long long block = blockIdx.x / cluster.num_blocks();
  const int team = threadIdx.x / TEAM;
  const int t = threadIdx.x % TEAM;

  const long long first = block * span + rank * share;
  const long long end = lmin(first + share, lmin((block + 1) * span, rows));
  const uint4* src = reinterpret_cast<const uint4*>(in) + t;
  long long g = first / SUB + team;
  const long long g_end = end / SUB;

  R acc[L::SLOTS];
#pragma unroll
  for (int s = 0; s < L::SLOTS; ++s) acc[s] = identity<OP, R>();
  for (; g + (UNROLL - 1) * TEAMS < g_end; g += UNROLL * TEAMS) {
    uint4 v[UNROLL][L::LOADS];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < L::LOADS; ++k) {
        v[u][k] = ld_stream(src + (g + u * TEAMS) * L::GROUP + k * TEAM);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int s = 0; s < L::SLOTS; ++s) {
        acc[s] = combine<OP>(acc[s], lane(v[u][s / L::VEC], s % L::VEC, T()));
      }
    }
  }
  for (; g < g_end; g += TEAMS) {
    uint4 v[L::LOADS];
#pragma unroll
    for (int k = 0; k < L::LOADS; ++k) v[k] = ld_stream(src + g * L::GROUP + k * TEAM);
#pragma unroll
    for (int s = 0; s < L::SLOTS; ++s) {
      acc[s] = combine<OP>(acc[s], lane(v[s / L::VEC], s % L::VEC, T()));
    }
  }

  // Slot s of thread t sits at fold[team][s * TEAM + t], so that a warp
  // touches 32 neighbouring words. Thread (w, t) folds slots s = w, w +
  // TEAMS, ... over the teams, in team order, into fold[0]; then, in rank
  // 0 of the cluster, over the ranks, in rank order, loading the other
  // ranks' fold[0] all at once over distributed shared memory.
#pragma unroll
  for (int s = 0; s < L::SLOTS; ++s) fold[team][s * TEAM + t] = acc[s];
  __syncthreads();
  for (int s = team; s < L::SLOTS; s += TEAMS) {
    R a = fold[0][s * TEAM + t];
    for (int w = 1; w < TEAMS; ++w) a = combine<OP>(a, fold[w][s * TEAM + t]);
    fold[0][s * TEAM + t] = a;
  }
  const int ranks = static_cast<int>(cluster.num_blocks());
  if (ranks > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  if (rank == 0) {
    O* dst = out + block * SUB * LANES;
    for (int s = team; s < L::SLOTS; s += TEAMS) {
      R v[MAX_CLUSTER];
#pragma unroll
      for (int r = 1; r < MAX_CLUSTER; ++r) {
        if (r < ranks) v[r] = cluster.map_shared_rank(&fold[0][0], r)[s * TEAM + t];
      }
      R a = fold[0][s * TEAM + t];
#pragma unroll
      for (int r = 1; r < MAX_CLUSTER; ++r) {
        if (r < ranks) a = combine<OP>(a, v[r]);
      }
      store(dst + L::slot(t, s), a);
    }
  }
  // each CTA's shared memory lives until rank 0 has read it
  if (ranks > 1) cluster.sync();
}

// k6's pass 2: CTA r folds slot row r of the (blocks, SUB, 128) partials
// over the blocks. Thread (q, c) folds column c of blocks q, q + LINES, ...
// in order; line 0 then folds the LINES results in order.
template <int OP, class O, int SUB>
__global__ void __launch_bounds__(CTA)
fold_blocks(const O* __restrict__ partials, O* __restrict__ out, int blocks) {
  using R = decltype(widen(O()));
  constexpr int LINES = CTA / LANES;
  __shared__ R line[LINES][LANES];
  const int c = threadIdx.x % LANES;
  const int q = threadIdx.x / LANES;
  const O* col = partials + blockIdx.x * LANES + c;
  R acc = identity<OP, R>();
#pragma unroll 8
  for (int b = q; b < blocks; b += LINES) {
    acc = combine<OP>(acc, widen(col[static_cast<long long>(b) * SUB * LANES]));
  }
  line[q][c] = acc;
  __syncthreads();
  if (q == 0) {
    for (int k = 1; k < LINES; ++k) acc = combine<OP>(acc, line[k][c]);
    store(out + blockIdx.x * LANES + c, acc);
  }
}

// The launch configuration of fold_span: `blocks` clusters of `cluster`
// CTAs along x.
struct SpanConfig {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;

  SpanConfig(int blocks, int cluster, cudaStream_t stream) : attr{}, cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(static_cast<unsigned>(blocks) * cluster);
    cfg.blockDim = dim3(CTA);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = cluster > 1 ? 1 : 0;
  }
};

template <int OP, class T, class O, int SUB>
cudaError_t launch_span(const void* in, void* out, long long rows,
                        long long span, long long share, int blocks,
                        int cluster, cudaStream_t stream) {
  const SpanConfig launch(blocks, cluster, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &launch.cfg, fold_span<OP, T, O, SUB>, static_cast<const T*>(in),
      static_cast<O*>(out), rows, span, share);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// k6: one fold_span pass of `blocks` clusters into `partials`, then
// fold_blocks into `out` (SUB, 128); with one cluster, the pass writes
// `out` itself.
struct K6 {
  const void* in;
  void* partials;
  void* out;
  long long rows;
  long long span;
  long long share;
  int blocks;
  int cluster;
  cudaStream_t stream;

  template <int OP, class T, class O, int SUB>
  cudaError_t run() const {
    const cudaError_t err = launch_span<OP, T, O, SUB>(
        in, blocks > 1 ? partials : out, rows, span, share, blocks, cluster,
        stream);
    if (err != cudaSuccess || blocks == 1) return err;
    fold_blocks<OP, O, SUB><<<SUB, CTA, 0, stream>>>(
        static_cast<const O*>(partials), static_cast<O*>(out), blocks);
    return cudaGetLastError();
  }
};

// k7: one fold_span pass, partial block i into block i of `out`
// (blocks*SUB, 128).
struct K7 {
  const void* in;
  void* out;
  long long rows;
  long long span;
  long long share;
  int blocks;
  int cluster;
  cudaStream_t stream;

  template <int OP, class T, class O, int SUB>
  cudaError_t run() const {
    return launch_span<OP, T, O, SUB>(in, out, rows, span, share, blocks,
                                      cluster, stream);
  }
};

// How many clusters of `cluster` fold_span CTAs the device holds at once.
struct ActiveClusters {
  int cluster;
  int* clusters;

  template <int OP, class T, class O, int SUB>
  cudaError_t run() const {
    const SpanConfig launch(1, cluster, nullptr);
    return cudaOccupancyMaxActiveClusters(clusters, fold_span<OP, T, O, SUB>,
                                          &launch.cfg);
  }
};

}  // namespace

// Each returns the CUDA error of its launches or query: 0 on success.
extern "C" int tr_k6_reduce(const void* in, void* partials, void* out,
                            long long rows, long long span, long long share,
                            int blocks, int cluster, int op, int dtype,
                            void* stream) {
  const K6 launch{in,     partials, out,     rows,
                  span,   share,    blocks,  cluster,
                  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(tr::by_op(op, dtype, launch));
}

extern "C" int tr_k7_reduce(const void* in, void* out, long long rows,
                            long long span, long long share, int blocks,
                            int cluster, int op, int dtype, void* stream) {
  const K7 launch{in,      out,     rows, span, share, blocks,
                  cluster, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(tr::by_op(op, dtype, launch));
}

extern "C" int tr_span_active_clusters(int cluster, int op, int dtype,
                                       int* clusters) {
  const ActiveClusters query{cluster, clusters};
  return static_cast<int>(tr::by_op(op, dtype, query));
}
