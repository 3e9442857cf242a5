// Streaming filtered rank counts on Hopper.
//
// Replaces the JAX package's kernels/triple_score/triple_score.py::
// fused_rank_fwd / _fused_rank_kernel (Pallas, TPU):
//   out[i] = sum_e 1[score(q_i, e) > gold_i], over entities e < E that are
//   not listed in filt[i] (pad -1). The (B, E) score matrix never exists.
//
// The TPU kernel accumulates into one output block revisited across a
// sequential entity grid. Hopper runs blocks in parallel and in no order,
// and serving batches are 8-64 rows, so a grid over query blocks alone would
// fill at most a handful of the 132 SMs. This kernel splits the ENTITY axis
// across blocks instead: each block loops over entity tiles (a persistent
// grid sized by occupancy), stages each tile in shared memory, scores it
// against every query of its query tile, counts beats per query with a warp
// ballot, and at the end adds its int32 partial counts to the output with
// one atomicAdd per query. Integer atomics keep the count exact in any order,
// and the table is read from device memory once per batch.
//
// What bounds it: at the serving shape (B = 64, E = 491,078, d = 100) the
// table read is E*d*4 = 196 MB (59 us at 3.35 TB/s) and the arithmetic is
// about 2*B*E*d = 6.3 GFLOP of fp32 (94 us at 67 TFLOP/s), so the bound is
// the fp32 pipe. This simple version executes one shared-memory load per
// fused sub/abs/add for the query operand (a broadcast) and amortizes the
// entity operand over QB = 4 queries, so shared-memory throughput, not the
// FP32 pipe, is what it runs into first.
//
// The filter row of a query is tested only for entities that beat gold.
// It is staged in shared memory when QT*F ints fit in 32 KB, else read from
// device memory (it is small and stays in L1/L2).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_score.cuh"

namespace triple_score {

constexpr int FILT_SMEM_LIMIT = 32 * 1024;

template <int MODE>
__global__ void __launch_bounds__(THREADS)
fused_rank_kernel(const float* __restrict__ q, const float* __restrict__ ent,
                  const float* __restrict__ gold, const int* __restrict__ filt,
                  int* __restrict__ out, int B, int E, int d, int F, int qt,
                  int filt_in_smem) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = make_layout(d, MODE);
  float* e_s = smem;                               // TE * s
  float* q_s = e_s + (size_t)TE * L.s;             // qt * s
  float* g_s = q_s + (size_t)qt * L.s;             // qt gold scores
  float* qq_s = g_s + qt;                          // qt |q|^2 (L2)
  int* cnt_s = reinterpret_cast<int*>(qq_s + qt);  // qt partial counts
  int* f_s = cnt_s + qt;                           // qt * F filter ids

  const int q0 = blockIdx.y * qt;
  const int nq = min(qt, B - q0);
  stage_rows<MODE>(q_s, q, q0, qt, B, L);
  for (int j = threadIdx.x; j < qt; j += blockDim.x) {
    g_s[j] = j < nq ? gold[q0 + j] : 0.0f;
    cnt_s[j] = 0;
  }
  if (filt_in_smem) {
    for (int i = threadIdx.x; i < nq * F; i += blockDim.x) f_s[i] = filt[(size_t)q0 * F + i];
  }
  __syncthreads();
  if (MODE == L2) {
    for (int j = threadIdx.x; j < qt; j += blockDim.x) qq_s[j] = row_sq(q_s + (size_t)j * L.s, L);
  }
  const int* frows = filt_in_smem ? f_s : filt + (size_t)q0 * F;

  const int lane = threadIdx.x & 31;
  const int el = threadIdx.x % TE;      // this thread's entity in the tile
  const int grp = threadIdx.x / TE;     // this thread's query group (warp-uniform)
  const int ntiles = (E + TE - 1) / TE;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int e0 = tile * TE;
    __syncthreads();  // the previous tile is fully consumed
    stage_rows<MODE>(e_s, ent, e0, TE, E, L);
    __syncthreads();
    const int eid = e0 + el;
    const bool live = eid < E;
    const float* er = e_s + (size_t)el * L.s;
    const float ee = MODE == L2 ? row_sq(er, L) : 0.0f;
    // queries of group `grp`: grp, grp + GROUPS, ...; QB of them per pass
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
#pragma unroll
      for (int m = 0; m < QB; ++m) {
        const int j = js[m];
        if (j >= nq) break;  // warp-uniform
        bool beats = live && s[m] > g_s[j];
        if (beats) {
          const int* fr = frows + (size_t)j * F;
          for (int f = 0; f < F; ++f) {
            if (fr[f] == eid) { beats = false; break; }
          }
        }
        const unsigned bal = __ballot_sync(0xffffffffu, beats);
        if (lane == 0 && bal) atomicAdd(&cnt_s[j], __popc(bal));
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nq; j += blockDim.x) {
    if (cnt_s[j]) atomicAdd(&out[q0 + j], cnt_s[j]);
  }
}

template <int MODE>
static int launch(const float* q, const float* ent, const float* gold, const int* filt,
                  int* out, int B, int E, int d, int F, int device, cudaStream_t stream) {
  static PlanCache cache;
  auto kernel = fused_rank_kernel<MODE>;
  Plan plan;
  int rc = cache.get(kernel, device, d, F, &plan, [&](Plan& p) -> int {
    const Layout L = make_layout(d, MODE);
    const int limit = max_dynamic_smem(device);
    p.qt = pick_query_tile(L, 3, 0, limit);
    if (p.qt == 0) return (int)cudaErrorInvalidValue;
    p.filt_smem = (size_t)p.qt * F * sizeof(int) <= (size_t)FILT_SMEM_LIMIT &&
                  tile_smem_bytes(L, p.qt, p.qt * (3 + F)) <= (size_t)limit;
    p.smem = tile_smem_bytes(L, p.qt, p.qt * (3 + (p.filt_smem ? F : 0)));
    return 0;
  });
  if (rc) return rc;
  kernel<<<persistent_grid(plan, B, E), THREADS, plan.smem, stream>>>(
      q, ent, gold, filt, out, B, E, d, F, plan.qt, plan.filt_smem);
  return (int)cudaGetLastError();
}

}  // namespace triple_score

extern "C" int triple_score_fused_ranks(const void* q, const void* ent, const void* gold,
                                        const void* filt, void* out, int B, int E, int d,
                                        int F, int mode, int device, void* stream) {
  using namespace triple_score;
  if (B <= 0 || E <= 0) return 0;
  if (d <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto ef = static_cast<const float*>(ent);
  auto gf = static_cast<const float*>(gold);
  auto fi = static_cast<const int*>(filt);
  auto o = static_cast<int*>(out);
  return on_device(device, [&]() -> int {
    switch (mode) {
      case L1: return launch<L1>(qf, ef, gf, fi, o, B, E, d, F, device, s);
      case L2: return launch<L2>(qf, ef, gf, fi, o, B, E, d, F, device, s);
      case DOT: return launch<DOT>(qf, ef, gf, fi, o, B, E, d, F, device, s);
      case CL1: return launch<CL1>(qf, ef, gf, fi, o, B, E, d, F, device, s);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

extern "C" const char* triple_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
