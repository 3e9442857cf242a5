// Streaming filtered rank counts on Hopper.
//
// Replaces the JAX package's kernels/triple_score/triple_score.py::
// fused_rank_fwd / _fused_rank_kernel (Pallas, TPU):
//   out[i] = sum_e 1[score(q_i, e) > gold_i], over entities e < E that are
//   not listed in filt[i] (pad -1). The (B, E) score matrix never exists.
//
// The TPU kernel accumulates into one output block revisited across a
// sequential entity grid. Hopper runs blocks in parallel and in no order,
// so this kernel splits the ENTITY axis across a persistent grid instead:
// each block walks its entity tiles with the register micro-kernel of
// tile_score.cuh (a copying warp streams the tiles into two buffers) and
// counts, per query, the entities that beat gold in per-thread integer
// counters. At the end a warp reduction and a shared-memory sum give one
// global atomicAdd per (block, query). Integer atomics keep the count exact in any order, and at
// B <= 64 one query tile covers the batch, so the table is read from device
// memory once per batch.
//
// The filter is not tested in the inner loop. The count covers every live
// entity; then, in the same launch, the blocks of a query tile share out its
// (query, filter slot) pairs and subtract 1 for each DISTINCT id
// 0 <= f < E of the row whose score beats gold (-1 pads, ids >= E and
// repeats are skipped). `pair_score` rescores the pair from device memory
// with the tile's own term functions in the same column order, so it is the
// same float the tile compared, and the subtraction is exact. The pairs are
// scored while the block's first tiles are in flight. (Scanning the filter
// row for every pair that beats gold, inside the tile, costs a scan for
// about half the pairs at a random gold.)
//
// What bounds it: at the serving shape (B = 64, E = 491,078, d = 100, l1)
// the table read is E*d*4 = 196 MB (59 us at 3.35 TB/s) and the arithmetic
// 2*B*E*d = 6.29e9 fp32 instructions (188 us at 33.5 T instructions/s):
// the fp32 pipe. At B = 8 the same table read binds (59 us against 23 us).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_score.cuh"

namespace triple_score {

template <int MODE, int QT>
__global__ void __launch_bounds__(BLOCK)
fused_rank_kernel(const float* __restrict__ q, const float* __restrict__ ent,
                  const float* __restrict__ gold, const int* __restrict__ filt,
                  int* __restrict__ out, int B, int E, int d, int F, int vec) {
  using T = Micro<QT>;
  extern __shared__ float4 smem4[];
  const Geo G = make_geo(d, MODE);
  const Smem S = carve<QT>(smem4, G);
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, B - q0);
  setup<MODE, QT>(S, q, q0, B, G, vec);
  if (threadIdx.x >= THREADS) {
    produce<MODE>(S, ent, E, G, vec);
    return;
  }

  for (int j = threadIdx.x; j < QT; j += THREADS) {
    S.cnt[j] = 0;
    S.qq[j] = MODE == L2 && j < nq ? row_norm(q + (size_t)(q0 + j) * d, d) : 0.0f;
  }

  // the filter correction: pair w to block w % gridDim.x, so that every
  // block of the row takes a few
  for (int w = blockIdx.x + gridDim.x * threadIdx.x; w < nq * F; w += gridDim.x * THREADS) {
    const int j = w / F, i = w - j * F;
    const int* row = filt + (size_t)(q0 + j) * F;
    const int f = row[i];
    if (f < 0 || f >= E) continue;
    bool first = true;
    for (int k = 0; k < i && first; ++k) first = row[k] != f;
    if (!first) continue;
    const float* qr = q + (size_t)(q0 + j) * d;
    const float s = pair_score<MODE>(qr, ent + (size_t)f * d, G,
                                     MODE == L2 ? row_norm(qr, d) : 0.0f);
    if (s > gold[q0 + j]) atomicSub(&out[q0 + j], 1);
  }

  constexpr int MQ = T::MQ, ME = T::ME;
  const int qrow = T::qrow0(), erow = T::erow0();
  int cnt[MQ];
  float g[MQ];
#pragma unroll
  for (int m = 0; m < MQ; ++m) {
    cnt[m] = 0;
    const int j = qrow + LQ * m;
    g[m] = j < nq ? gold[q0 + j] : INFINITY;  // a pad query never counts
  }
  queries_landed();

  consume<MODE, QT>(S, E, G, [&](int e0, const float (&sc)[MQ][ME]) {
#pragma unroll
    for (int i = 0; i < ME; ++i) {
      const bool live = e0 + erow + LE * i < E;
#pragma unroll
      for (int m = 0; m < MQ; ++m) cnt[m] += live && sc[m][i] > g[m];
    }
  });

  // sum over the LE lanes that share a query, then one shared add per query
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < MQ; ++m) {
    int v = cnt[m];
#pragma unroll
    for (int o = LQ; o < 32; o *= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane < LQ && v) atomicAdd(&S.cnt[qrow + LQ * m], v);
  }
  compute_sync();
  for (int j = threadIdx.x; j < nq; j += THREADS) {
    if (S.cnt[j]) atomicAdd(&out[q0 + j], S.cnt[j]);
  }
}

template <int MODE, int QT>
static int launch(const float* q, const float* ent, const float* gold, const int* filt,
                  int* out, int B, int E, int d, int F, int vec, int device,
                  cudaStream_t stream) {
  static PlanCache cache;
  auto kernel = fused_rank_kernel<MODE, QT>;
  Plan plan;
  int rc = cache.get(kernel, device, d, smem_bytes(make_geo(d, MODE), QT), &plan);
  if (rc) return rc;
  kernel<<<persistent_grid(plan.blocks, B, E, QT), BLOCK, plan.smem, stream>>>(
      q, ent, gold, filt, out, B, E, d, F, vec);
  return (int)cudaGetLastError();
}

template <int MODE>
static int launch_mode(const float* q, const float* ent, const float* gold, const int* filt,
                       int* out, int B, int E, int d, int F, int vec, int device,
                       cudaStream_t s) {
  switch (pick_query_tile(B, make_geo(d, MODE), max_dynamic_smem(device))) {
    case 8: return launch<MODE, 8>(q, ent, gold, filt, out, B, E, d, F, vec, device, s);
    case 16: return launch<MODE, 16>(q, ent, gold, filt, out, B, E, d, F, vec, device, s);
    case 32: return launch<MODE, 32>(q, ent, gold, filt, out, B, E, d, F, vec, device, s);
    case 64: return launch<MODE, 64>(q, ent, gold, filt, out, B, E, d, F, vec, device, s);
    default: return (int)cudaErrorInvalidValue;  // rows too long for shared memory
  }
}

}  // namespace triple_score

extern "C" int triple_score_fused_ranks(const void* q, const void* ent, const void* gold,
                                        const void* filt, void* out, int B, int E, int d,
                                        int F, int mode, int device, void* stream) {
  using namespace triple_score;
  if (B <= 0 || E <= 0) return 0;
  if (d <= 0 || F <= 0 || (mode == CL1 && d % 2)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto ef = static_cast<const float*>(ent);
  auto gf = static_cast<const float*>(gold);
  auto fi = static_cast<const int*>(filt);
  auto o = static_cast<int*>(out);
  const int vec = rows_aligned16(q, ent, d, mode);
  return on_device(device, [&]() -> int {
    switch (mode) {
      case L1: return launch_mode<L1>(qf, ef, gf, fi, o, B, E, d, F, vec, device, s);
      case L2: return launch_mode<L2>(qf, ef, gf, fi, o, B, E, d, F, vec, device, s);
      case DOT: return launch_mode<DOT>(qf, ef, gf, fi, o, B, E, d, F, vec, device, s);
      case CL1: return launch_mode<CL1>(qf, ef, gf, fi, o, B, E, d, F, vec, device, s);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

extern "C" const char* triple_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
