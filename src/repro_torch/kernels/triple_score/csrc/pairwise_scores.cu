// Pairwise (B, E) scores on Hopper.
//
// Replaces the JAX package's kernels/triple_score/triple_score.py::
// pairwise_scores_fwd / _score_kernel (Pallas, TPU), whose tile math is
// `_tile_scores`: out[i, e] = score(q_i, ent_e) in mode l1 | l2 | dot | cl1.
// The serving tier's top-k scores each entity chunk with it.
//
// The Pallas kernel pads B and E up to block multiples; here the grid covers
// E with a persistent loop over 64-entity tiles (and B with query tiles of up
// to 64 rows), and the ragged edges are masked instead of padded. Each block
// stages an entity tile and its query tile in shared memory (tile_score.cuh),
// every thread scores one entity against 4 queries at a time, and a warp
// writes 32 consecutive scores of one query row: coalesced 128-byte stores.
//
// What bounds it: the (B, E) output. At a serving top-k batch over the whole
// table (B = 64, E = 491,078, d = 100) it reads 196 MB of table and writes
// 126 MB of scores, 96 us at 3.35 TB/s, against about 6.3 GFLOP of fp32
// (94 us at 67 TFLOP/s): the two are close, and this simple version runs
// into shared-memory throughput on the arithmetic side first (see fused_ranks.cu).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_score.cuh"

namespace triple_score {

template <int MODE>
__global__ void __launch_bounds__(THREADS)
pairwise_kernel(const float* __restrict__ q, const float* __restrict__ ent,
                float* __restrict__ out, int B, int E, int d, int qt) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = make_layout(d, MODE);
  float* e_s = smem;                     // TE * s
  float* q_s = e_s + (size_t)TE * L.s;   // qt * s
  float* qq_s = q_s + (size_t)qt * L.s;  // qt |q|^2 (L2)

  const int q0 = blockIdx.y * qt;
  const int nq = min(qt, B - q0);
  stage_rows<MODE>(q_s, q, q0, qt, B, L);
  __syncthreads();
  if (MODE == L2) {
    for (int j = threadIdx.x; j < qt; j += blockDim.x) qq_s[j] = row_sq(q_s + (size_t)j * L.s, L);
  }

  const int el = threadIdx.x % TE;
  const int grp = threadIdx.x / TE;
  const int ntiles = (E + TE - 1) / TE;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int e0 = tile * TE;
    __syncthreads();
    stage_rows<MODE>(e_s, ent, e0, TE, E, L);
    __syncthreads();
    const int eid = e0 + el;
    const bool live = eid < E;
    const float* er = e_s + (size_t)el * L.s;
    const float ee = MODE == L2 ? row_sq(er, L) : 0.0f;
    for (int base = grp; base < nq; base += GROUPS * QB) {
      const float* qrow[QB];
      float qq[QB];
      int js[QB];
#pragma unroll
      for (int m = 0; m < QB; ++m) {
        js[m] = base + GROUPS * m;
        const int jr = js[m] < nq ? js[m] : base;
        qrow[m] = q_s + (size_t)jr * L.s;
        qq[m] = MODE == L2 ? qq_s[jr] : 0.0f;
      }
      float s[QB];
      score_rows<MODE>(er, qrow, qq, ee, L, s);
      if (live) {
#pragma unroll
        for (int m = 0; m < QB; ++m) {
          if (js[m] < nq) out[(size_t)(q0 + js[m]) * E + eid] = s[m];
        }
      }
    }
  }
}

template <int MODE>
static int launch(const float* q, const float* ent, float* out, int B, int E, int d,
                  int device, cudaStream_t stream) {
  static PlanCache cache;
  auto kernel = pairwise_kernel<MODE>;
  Plan plan;
  int rc = cache.get(kernel, device, d, 0, &plan, [&](Plan& p) -> int {
    const Layout L = make_layout(d, MODE);
    p.qt = pick_query_tile(L, 1, 0, max_dynamic_smem(device));
    if (p.qt == 0) return (int)cudaErrorInvalidValue;
    p.smem = tile_smem_bytes(L, p.qt, p.qt);
    return 0;
  });
  if (rc) return rc;
  kernel<<<persistent_grid(plan, B, E), THREADS, plan.smem, stream>>>(q, ent, out, B, E, d,
                                                                       plan.qt);
  return (int)cudaGetLastError();
}

}  // namespace triple_score

extern "C" int triple_score_pairwise(const void* q, const void* ent, void* out, int B, int E,
                                     int d, int mode, int device, void* stream) {
  using namespace triple_score;
  if (B <= 0 || E <= 0) return 0;
  if (d <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto ef = static_cast<const float*>(ent);
  auto o = static_cast<float*>(out);
  return on_device(device, [&]() -> int {
    switch (mode) {
      case L1: return launch<L1>(qf, ef, o, B, E, d, device, s);
      case L2: return launch<L2>(qf, ef, o, B, E, d, device, s);
      case DOT: return launch<DOT>(qf, ef, o, B, E, d, device, s);
      case CL1: return launch<CL1>(qf, ef, o, B, E, d, device, s);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

extern "C" const char* triple_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
