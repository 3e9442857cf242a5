// Margin-ranking SGD on the {ent, rel} tables, in place, on Hopper: a whole
// epoch of steps in one launch of one thread-block cluster.
//
// Replaces the JAX package's kernels/sparse_update/sparse_update.py::
// sparse_sgd_step_fwd / _sparse_step_kernel and _margin_grads (Pallas, TPU),
// and the lax.scan over it in kge/engine.py::train_scan_graph: for each of
// nb minibatches of B positive triples and their B corruptions, score both
// (TransE l1 / l2, DistMult dot), take the analytic gradients of
// mean(relu(margin - s_pos + s_neg)), sum them per touched row, write
// row -= lr * g into the tables, and store the step's loss. Step i + 1 reads
// the rows step i wrote.
//
// The Pallas kernel runs one step on a (1,) grid and the reference scans it
// as one compiled program: the epoch never leaves the device. A step moves
// ~0.3 MB; what it costs is latency. So the epoch is one launch of one
// cluster of 16 blocks (the non-portable size, which the launch opts in to;
// it measured faster than the portable 8 on the H100, PERF.md) on
// neighbouring SMs, and each step is two phases between cluster barriers, each barrier
// split into barrier.cluster.arrive.release and wait.acquire with local
// work between them:
//   (a) each block takes its batch rows (block k rows [k*rpb, (k+1)*rpb),
//       one warp a row), gathers the six rows, scores them, and keeps the
//       six gathered rows, the six per-occurrence gradient rows and the
//       row's hinge in its own shared memory. Nothing is written to the
//       tables. Arrive; meanwhile the block asks L2 for the rows of its
//       batch rows of the next step (prefetch.global.L2; the ids do not
//       depend on the tables). Wait.
//   (b) each block takes the occurrences of its own batch rows, one warp
//       each, in the occurrence lists -- entities [pos_h | pos_t | neg_h |
//       neg_t] (4B), relations [pos_r | neg_r] (2B). An occurrence whose id
//       appears earlier in its list owns nothing; the first occurrence owns
//       the row: it sums the gradient rows of every occurrence of its id in
//       ascending occurrence order -- its own in this block's shared memory,
//       a repeat's in another block's (distributed shared memory,
//       cluster.map_shared_rank) -- and writes the row once, from the copy
//       it gathered in (a). Block 0 sums the B hinges in a fixed order into
//       losses[i]. Arrive; meanwhile the block turns the next step's ids
//       (copied by cp.async during this step) into its occurrence lists, and
//       starts the copy of the step after. Wait.
// No global scratch, no float atomics, no host sync.
//
// Coherence: the tables are written and read by different SMs of the
// cluster from one step to the next. So they are not declared __restrict__
// const (which would allow ld.global.nc, not coherent with this kernel's own
// writes), and every table access is ld.global.cg / st.global.cg: cached in
// L2 only, so no SM can read a row it holds in L1 from an earlier step after
// another SM wrote it. The cluster barriers order the writes of one phase
// before the reads of the next at cluster scope.
//
// The batch must fit the cluster's shared memory: 48 * d bytes for each
// batch row of a block (its gradient and gathered rows) and 120 bytes for
// each row of the batch (the ids), per block, caps B at 544 at d = 100. The
// trainer, the federation and the handshake all take B = 100; the wrapper
// raises past the cap.
//
// Conventions follow _margin_grads exactly: relu'(0) = 0 (act > 0 strictly),
// sign(0) = 0, the L2 norm is sqrt(sum x^2 + 1e-12), DistMult sums h*r*t.
// Every product, sum and the update use the _rn intrinsics, so nvcc contracts
// nothing into an FMA, and each row's sum runs in occurrence order: each
// value is rounded where the plain PyTorch version rounds it, and on inputs
// whose sums are exact the two agree bit for bit, step after step.
//
// What bounds it: a step at B = 100, d = 100 must move ~0.32 MB (each touched
// row read and written once), 0.1 us at 3.35 TB/s. What it pays is a chain
// of latencies: the gather from L2, the owners' shared-memory round, their
// stores reaching L2 before the release, two cluster barriers; ~5.8 us a
// step on the H100 (PERF.md), against the ~11.5 us of device time and ~60 us
// of Python of the two launches a step it replaces.
#include <assert.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace sparse_update {

enum Mode { L1 = 0, L2 = 1, DOT = 2 };
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
// blocks of the one cluster (the non-portable size: the launch opts in)
constexpr int CLUSTER = 16;
// dynamic shared memory a block may opt in to on Hopper (227 KB)
constexpr size_t SMEM_LIMIT = 232448;

struct Args {
  float* ent;                // (E, d)
  float* rel;                // (R, d)
  const int64_t* pos;        // (nb, B, 3)
  const int64_t* neg;        // (nb, B, 3)
  float* losses;             // (nb,)
  long long E, R;
  int nb, B, d, rpb;         // rpb: batch rows per block
  float lr, margin;
};

// Shared memory of one block, in bytes: [next ids (int64, 6B) | gradient
// rows (6 * rpb * d) | the gathered rows (6 * rpb * d) | hinges (rpb) |
// occurrence ids, each occurrence's place in a step's ids and its location
// (int, 6B each)].
inline size_t smem_bytes(int B, int d, int rpb) {
  return (size_t)6 * B * (sizeof(int64_t) + 3 * sizeof(int)) +
         (size_t)12 * rpb * d * sizeof(float) + (size_t)rpb * sizeof(float);
}

// Butterfly sum: every lane ends with the same value (fp add commutes).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float sign_of(float x) {
  return (float)((x > 0.f) - (x < 0.f));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

// Occurrence o of a step (slot o / B: 0 pos_h, 1 pos_t, 2 neg_h, 3 neg_t,
// 4 pos_r, 5 neg_r; batch row o % B): its offset in the step's pos (when
// `neg` is false) or neg ids.
__device__ __forceinline__ int occ_offset(int o, int B, bool& neg) {
  const int slot = o / B, i = o - slot * B;
  neg = slot == 2 || slot == 3 || slot == 5;
  const int col = slot >= 4 ? 1 : (slot & 1) ? 2 : 0;
  return 3 * i + col;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Copy one step's ids, [pos (3B) | neg (3B)], into shared memory (cp.async).
__device__ __forceinline__ void copy_ids(int64_t* next, const int64_t* pos, const int64_t* neg,
                                         int n3) {
  for (int k = threadIdx.x; k < 2 * n3; k += THREADS)
    cp_async8(next + k, k < n3 ? pos + k : neg + (k - n3));
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1) epoch_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const int B = a.B, d = a.d, n6 = 6 * B, rpb = a.rpb;
  int64_t* next = reinterpret_cast<int64_t*>(base);  // [pos (3B) | neg (3B)] of the next step
  float* grads = reinterpret_cast<float*>(base + (size_t)n6 * sizeof(int64_t));
  float* vals = grads + (size_t)6 * rpb * d;  // the rows as gathered
  float* hinge = vals + (size_t)6 * rpb * d;
  int* occ = reinterpret_cast<int*>(hinge + rpb);  // the step's ids, by occurrence
  int* src = occ + n6;  // each occurrence's place in a step's ids
  int* loc = src + n6;  // its block (<< 16) and row of grads / vals there

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = rank * rpb, row1 = min(B, row0 + rpb), nrows = max(row1 - row0, 0);
  const int n3 = 3 * B;

  // Where occurrence o's id sits in a step's [pos (3B) | neg (3B)] (the same
  // each step), the block that keeps its gradient row and the row there.
  for (int o = threadIdx.x; o < n6; o += THREADS) {
    bool is_neg;
    const int k = occ_offset(o, B, is_neg);
    src[o] = (is_neg ? n3 : 0) + k;
    const int slot = o / B, i = o - slot * B, blk = i / rpb;
    loc[o] = (blk << 16) | (slot * rpb + i - blk * rpb);
  }
  // The occurrence lists of a step -- entities [0, 4B), relations [4B, 6B)
  // -- from its ids in shared memory.
  auto convert = [&]() {
    for (int o = threadIdx.x; o < n6; o += THREADS) {
      const int64_t id = next[src[o]];
      assert(id >= 0 && id < (o >= 4 * B ? a.R : a.E));
      occ[o] = (int)id;
    }
  };

  copy_ids(next, a.pos, a.neg, n3);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  convert();
  __syncthreads();
  if (a.nb > 1) copy_ids(next, a.pos + n3, a.neg + n3, n3);
  cluster.sync();  // every block of the cluster runs before any reads another's memory

  for (int step = 0; step < a.nb; ++step) {
    // ---- (a) gradients of this block's batch rows, one warp a row. Columns go
    // in groups of 128, four a lane, so that a group's loads are all in flight
    // together (the stores of one group may alias the loads of the next).
    for (int i = row0 + warp; i < row1; i += WARPS) {
      const int li = i - row0;
      const float* rows[6] = {
          a.ent + (size_t)occ[i] * d,         a.ent + (size_t)occ[B + i] * d,
          a.ent + (size_t)occ[2 * B + i] * d, a.ent + (size_t)occ[3 * B + i] * d,
          a.rel + (size_t)occ[4 * B + i] * d, a.rel + (size_t)occ[5 * B + i] * d};
      // slot s of this row: [h, t, nh, nt, r, nr]; its gathered rows in shared memory
      float* slot[6];
      float* vslot[6];
#pragma unroll
      for (int s = 0; s < 6; ++s) {
        slot[s] = grads + ((size_t)s * rpb + li) * d;
        vslot[s] = vals + ((size_t)s * rpb + li) * d;
      }
      // scores: lane sums its columns in ascending order, then the warp sums
      float sp = 0.f, sn = 0.f;
      for (int c0 = 0; c0 < d; c0 += 128) {
        float v[6][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = c0 + 32 * u + lane;
#pragma unroll
          for (int s = 0; s < 6; ++s) v[s][u] = j < d ? __ldcg(rows[s] + j) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = c0 + 32 * u + lane;
          if (j >= d) continue;
          // kept for the gradients below and for the owners' updates
#pragma unroll
          for (int s = 0; s < 6; ++s) vslot[s][j] = v[s][u];
          const float he = v[0][u], te = v[1][u], nhe = v[2][u], nte = v[3][u];
          const float re = v[4][u], nre = v[5][u];
          if (MODE == DOT) {
            sp = __fadd_rn(sp, __fmul_rn(__fmul_rn(he, re), te));
            sn = __fadd_rn(sn, __fmul_rn(__fmul_rn(nhe, nre), nte));
          } else {
            const float dp = __fsub_rn(__fadd_rn(he, re), te);
            const float dn = __fsub_rn(__fadd_rn(nhe, nre), nte);
            if (MODE == L1) {
              sp = __fadd_rn(sp, fabsf(dp));
              sn = __fadd_rn(sn, fabsf(dn));
            } else {
              sp = __fadd_rn(sp, __fmul_rn(dp, dp));
              sn = __fadd_rn(sn, __fmul_rn(dn, dn));
            }
          }
        }
      }
      sp = warp_sum(sp);
      sn = warp_sum(sn);
      float np_ = 1.f, nn_ = 1.f;
      if (MODE == L1) {
        sp = -sp;
        sn = -sn;
      } else if (MODE == L2) {
        np_ = __fsqrt_rn(__fadd_rn(sp, 1e-12f));
        nn_ = __fsqrt_rn(__fadd_rn(sn, 1e-12f));
        sp = -np_;
        sn = -nn_;
      }
      const float act = __fadd_rn(__fsub_rn(a.margin, sp), sn);
      // dL/ds_pos = -w, dL/ds_neg = +w with w = 1[act > 0] / B
      const float w = act > 0.f ? __fdiv_rn(1.0f, (float)B) : 0.f;
      if (lane == 0) hinge[li] = isnan(act) ? act : fmaxf(act, 0.f);
      const float nw = -w;
      for (int c0 = 0; c0 < d; c0 += 128) {
        float v[6][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = c0 + 32 * u + lane;
#pragma unroll
          for (int s = 0; s < 6; ++s)
            v[s][u] = j >= d ? 0.f : vslot[s][j];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = c0 + 32 * u + lane;
          if (j >= d) continue;
          const float he = v[0][u], te = v[1][u], nhe = v[2][u], nte = v[3][u];
          const float re = v[4][u], nre = v[5][u];
          float g[6];
          if (MODE == DOT) {
            g[0] = __fmul_rn(nw, __fmul_rn(re, te));
            g[1] = __fmul_rn(nw, __fmul_rn(he, re));
            g[4] = __fmul_rn(nw, __fmul_rn(he, te));
            g[2] = __fmul_rn(w, __fmul_rn(nre, nte));
            g[3] = __fmul_rn(w, __fmul_rn(nhe, nre));
            g[5] = __fmul_rn(w, __fmul_rn(nhe, nte));
          } else {
            const float dp = __fsub_rn(__fadd_rn(he, re), te);
            const float dn = __fsub_rn(__fadd_rn(nhe, nre), nte);
            float gp, gn;
            if (MODE == L1) {
              gp = sign_of(dp);
              gn = sign_of(dn);
            } else {
              gp = __fdiv_rn(dp, np_);
              gn = __fdiv_rn(dn, nn_);
            }
            // s_pos = -||h + r - t||: d s_pos/dh = -g, d/dt = +g, d/dr = -g
            const float ap = __fmul_rn(w, gp), an = __fmul_rn(w, gn);
            g[0] = ap; g[1] = -ap; g[4] = ap;
            g[2] = -an; g[3] = an; g[5] = -an;
          }
#pragma unroll
          for (int s = 0; s < 6; ++s) slot[s][j] = g[s];
        }
      }
    }
    cluster_arrive();  // this block's gradients are written
    if (step + 1 < a.nb) {
      // meanwhile: bring the rows of this block's batch rows of the next step
      // into L2, so that its gather does not wait on device memory
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      const int lines = (d * (int)sizeof(float) + 127) / 128 + 1;
      for (int e = threadIdx.x; e < 6 * nrows * lines; e += THREADS) {
        const int r = e / lines, ln = e - r * lines;
        const int s = r / nrows, i = row0 + r - s * nrows;
        const int64_t id = next[src[s * B + i]];
        const char* row = reinterpret_cast<const char*>((s >= 4 ? a.rel : a.ent) + id * d);
        const char* line = reinterpret_cast<const char*>(
            (reinterpret_cast<uintptr_t>(row) & ~(uintptr_t)127) + 128 * ln);
        if (line < row + d * sizeof(float))
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(line));
      }
    }
    cluster_wait();

    // ---- (b) a block owns the occurrences of its own batch rows, one warp
    // each: what the first occurrence of an id needs of itself is in the
    // block's shared memory, and only repeated ids read another block's.
    // Block 0 also sums the loss.
    for (int tk = warp; tk < 6 * nrows + (rank == 0); tk += WARPS) {
      if (tk == 6 * nrows) {  // loss = mean of the hinges, summed in a fixed order
        float s = 0.f;
        for (int i = lane; i < B; i += 32)
          s = __fadd_rn(s, *cluster.map_shared_rank(hinge + (i % rpb), i / rpb));
        s = warp_sum(s);
        if (lane == 0) a.losses[step] = __fdiv_rn(s, (float)B);
        continue;
      }
      const int slot_k = tk / nrows, li = tk - slot_k * nrows;
      const int k = slot_k * B + row0 + li;  // the occurrence: slot, batch row
      const bool is_rel = slot_k >= 4;
      const int* ids = is_rel ? occ + 4 * B : occ;  // this occurrence's list
      const int o0 = is_rel ? 4 * B : 0;            // its first occurrence
      const int n = is_rel ? 2 * B : 4 * B;
      const int kk = k - o0;
      const int id = ids[kk];
      float* out = (is_rel ? a.rel : a.ent) + (size_t)id * d;
      // the row as the step found it: the copy this occurrence gathered, in
      // this block's shared memory
      const float* found = vals + ((size_t)slot_k * rpb + li) * d;
      float row[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 32 * u + lane;
        row[u] = c >= d ? 0.f : found[c];
      }
      bool owned = true;  // no earlier occurrence names the id (128 a round)
      for (int j0 = 0; j0 < kk && owned; j0 += 128) {
        bool hit = false;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + 32 * u + lane;
          hit |= j < kk && ids[j] == id;
        }
        owned = !__any_sync(FULL, hit);
      }
      if (!owned) continue;
      for (int c0 = 0; c0 < d; c0 += 128) {
        float acc[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = c0 + 32 * u + lane;
          if (c0 > 0) row[u] = c >= d ? 0.f : found[c];
          acc[u] = 0.f;
        }
        // the gradients of every occurrence of the id, in ascending occurrence order
        for (int j0 = kk; j0 < n; j0 += 128) {
          unsigned mm[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = j0 + 32 * u + lane;
            mm[u] = __ballot_sync(FULL, j < n && ids[j] == id);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            unsigned m = mm[u];
            while (m) {
              const int o = o0 + j0 + 32 * u + __ffs(m) - 1;
              m &= m - 1;
              const int at = loc[o], blk = at >> 16;
              const float* gj = grads + (size_t)(at & 0xffff) * d;
              if (blk != rank) gj = cluster.map_shared_rank(gj, blk);
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                const int c = c0 + 32 * v + lane;
                acc[v] = __fadd_rn(acc[v], c < d ? gj[c] : 0.f);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = c0 + 32 * u + lane;
          if (c < d) __stcg(out + c, __fsub_rn(row[u], __fmul_rn(a.lr, acc[u])));
        }
      }
    }
    cluster_arrive();  // the rows are written, the other blocks' gradients read
    if (step + 1 < a.nb) {  // meanwhile: the next step's occurrence lists
      __syncthreads();      // this block is done with this step's
      convert();
      __syncthreads();
      if (step + 2 < a.nb)
        copy_ids(next, a.pos + (size_t)(step + 2) * n3, a.neg + (size_t)(step + 2) * n3, n3);
    }
    cluster_wait();
  }
}

template <int MODE>
int launch(const Args& a, cudaStream_t s) {
  auto kern = epoch_kernel<MODE>;
  const size_t smem = smem_bytes(a.B, a.d, a.rpb);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)CLUSTER, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;  // the cluster cannot be placed
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Runs `fn` with `device` current in this library's CUDA runtime (it keeps
// its own current device, separate from the caller's), then restores.
template <typename F>
inline int on_device(int device, F&& fn) {
  int prev = -1;
  cudaGetDevice(&prev);
  if (prev != device) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  const int rc = fn();
  if (prev != device && prev >= 0) cudaSetDevice(prev);
  return rc;
}

}  // namespace sparse_update

// Shared memory one block of the cluster needs for batch B at width d.
extern "C" long long sparse_update_smem_bytes(int B, int d) {
  const int rpb = (B + sparse_update::CLUSTER - 1) / sparse_update::CLUSTER;
  return (long long)sparse_update::smem_bytes(B, d, rpb);
}

// nb steps over pos / neg (nb, B, 3) int64, in place on ent (E, d) and rel
// (R, d), losses (nb,).
extern "C" int sparse_update_epoch(void* ent, void* rel, const void* pos, const void* neg,
                                   void* losses, int nb, int B, long long E, long long R, int d,
                                   float lr, float margin, int mode, int device, void* stream) {
  using namespace sparse_update;
  if (nb <= 0 || B <= 0 || d <= 0 || E <= 0 || R <= 0 || E > INT32_MAX || R > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int rpb = (B + CLUSTER - 1) / CLUSTER;
  if (smem_bytes(B, d, rpb) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  Args a{static_cast<float*>(ent), static_cast<float*>(rel),
         static_cast<const int64_t*>(pos), static_cast<const int64_t*>(neg),
         static_cast<float*>(losses), E, R, nb, B, d, rpb, lr, margin};
  auto s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    switch (mode) {
      case L1: return launch<L1>(a, s);
      case L2: return launch<L2>(a, s);
      case DOT: return launch<DOT>(a, s);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

extern "C" const char* sparse_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
