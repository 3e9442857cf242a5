// Pairwise (B, E) scores on Hopper.
//
// Replaces the JAX package's kernels/triple_score/triple_score.py::
// pairwise_scores_fwd / _score_kernel (Pallas, TPU), whose tile math is
// `_tile_scores`: out[i, e] = score(q_i, ent_e) in mode l1 | l2 | dot | cl1.
// The serving tier's top-k scores each entity chunk with it.
//
// The Pallas kernel pads B and E up to block multiples; here a persistent
// grid walks 128-entity tiles (and B in query tiles of 8-64 rows), and the
// ragged edges are masked instead of padded. The scores come from the
// register micro-kernel of tile_score.cuh (a copying warp streams the
// tiles into two buffers; an MQ x ME micro-tile per thread on a 4 x 8 lane
// grid). A thread's ME
// entities are 8 rows apart, so each store instruction of a warp writes 8
// consecutive scores (32 bytes, one sector) in each of 4 query rows, and the
// (B, E) output streams to device memory beside the arithmetic. (Float4
// stores of four consecutive entities per thread would put a thread's entity
// rows on one bank group of shared memory; the strided rows keep the loads
// conflict-free.)
//
// What bounds it: at a serving top-k batch over the whole table (B = 64,
// E = 491,078, d = 100, l1) it reads 196 MB of table and writes 126 MB of
// scores (96 us at 3.35 TB/s) against 6.29e9 fp32 instructions (188 us at
// 33.5 T instructions/s): the fp32 pipe. At B = 8 the bytes bind.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_score.cuh"

namespace triple_score {

template <int MODE, int QT>
__global__ void __launch_bounds__(BLOCK)
pairwise_kernel(const float* __restrict__ q, const float* __restrict__ ent,
                float* __restrict__ out, int B, int E, int d, int vec) {
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
  if (MODE == L2) {
    for (int j = threadIdx.x; j < QT; j += THREADS) {
      S.qq[j] = j < nq ? row_norm(q + (size_t)(q0 + j) * d, d) : 0.0f;
    }
  }
  queries_landed();

  constexpr int MQ = T::MQ, ME = T::ME;
  const int qrow = T::qrow0(), erow = T::erow0();
  consume<MODE, QT>(S, E, G, [&](int e0, const float (&sc)[MQ][ME]) {
#pragma unroll
    for (int m = 0; m < MQ; ++m) {
      if (qrow + LQ * m >= nq) break;
      float* orow = out + (size_t)(q0 + qrow + LQ * m) * E + e0 + erow;
#pragma unroll
      for (int i = 0; i < ME; ++i) {
        if (e0 + erow + LE * i < E) orow[LE * i] = sc[m][i];
      }
    }
  });
}

template <int MODE, int QT>
static int launch(const float* q, const float* ent, float* out, int B, int E, int d, int vec,
                  int device, cudaStream_t stream) {
  static PlanCache cache;
  auto kernel = pairwise_kernel<MODE, QT>;
  Plan plan;
  int rc = cache.get(kernel, device, d, smem_bytes(make_geo(d, MODE), QT), &plan);
  if (rc) return rc;
  kernel<<<persistent_grid(plan.blocks, B, E, QT), BLOCK, plan.smem, stream>>>(
      q, ent, out, B, E, d, vec);
  return (int)cudaGetLastError();
}

template <int MODE>
static int launch_mode(const float* q, const float* ent, float* out, int B, int E, int d,
                       int vec, int device, cudaStream_t s) {
  switch (pick_query_tile(B, make_geo(d, MODE), max_dynamic_smem(device))) {
    case 8: return launch<MODE, 8>(q, ent, out, B, E, d, vec, device, s);
    case 16: return launch<MODE, 16>(q, ent, out, B, E, d, vec, device, s);
    case 32: return launch<MODE, 32>(q, ent, out, B, E, d, vec, device, s);
    case 64: return launch<MODE, 64>(q, ent, out, B, E, d, vec, device, s);
    default: return (int)cudaErrorInvalidValue;  // rows too long for shared memory
  }
}

}  // namespace triple_score

extern "C" int triple_score_pairwise(const void* q, const void* ent, void* out, int B, int E,
                                     int d, int mode, int device, void* stream) {
  using namespace triple_score;
  if (B <= 0 || E <= 0) return 0;
  if (d <= 0 || (mode == CL1 && d % 2)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto ef = static_cast<const float*>(ent);
  auto o = static_cast<float*>(out);
  const int vec = rows_aligned16(q, ent, d, mode);
  return on_device(device, [&]() -> int {
    switch (mode) {
      case L1: return launch_mode<L1>(qf, ef, o, B, E, d, vec, device, s);
      case L2: return launch_mode<L2>(qf, ef, o, B, E, d, vec, device, s);
      case DOT: return launch_mode<DOT>(qf, ef, o, B, E, d, vec, device, s);
      case CL1: return launch_mode<CL1>(qf, ef, o, B, E, d, vec, device, s);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

extern "C" const char* triple_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
