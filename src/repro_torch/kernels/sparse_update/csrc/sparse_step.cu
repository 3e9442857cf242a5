// One margin-ranking SGD step on the {ent, rel} tables, in place, on Hopper.
//
// Replaces the JAX package's kernels/sparse_update/sparse_update.py::
// sparse_sgd_step_fwd / _sparse_step_kernel and _margin_grads (Pallas, TPU):
// for a minibatch of B positive triples and their B corruptions, score both
// (TransE l1 / l2, DistMult dot), take the analytic gradients of
// mean(relu(margin - s_pos + s_neg)), sum them per touched row, and write
// row -= lr * g into the tables; return the loss.
//
// The Pallas kernel runs on a (1,) grid: one program gathers the unique rows,
// segment-sums with a one-hot matmul and scatters them in a serial loop.
// Three things of that design do not carry over to a parallel grid:
//   1. the serial scatter loop is what made its writes race-free;
//   2. its unique set is padded with fill slots that alias row 0 with a zero
//      gradient -- in parallel, a fill that reads row 0 before the real slot
//      writes it and writes after would undo that update;
//   3. pos and neg share rows, so every occurrence must be scored from the
//      tables as they were before the step.
// So this is two launches on one stream, which orders them:
//   A (grads): one warp per batch row gathers its six rows straight from the
//     tables, scores them, and writes the six per-occurrence gradient rows
//     into a scratch buffer -- entity occurrences [pos_h | pos_t | neg_h |
//     neg_t] (4B rows), relation occurrences [pos_r | neg_r] (2B rows) -- and
//     the row's hinge. Nothing is written to the tables.
//   B (scatter): one warp per occurrence. Each block stages the 6B
//     occurrence ids in shared memory. An occurrence whose id appears
//     earlier in its list owns nothing and stops; the first occurrence owns
//     the row, sums the gradients of all occurrences of its id in occurrence
//     order into a per-warp accumulator row in shared memory (so the d
//     column loads of one match go out together), and writes the row once.
//     No fill slots, no float atomics, and no row the batch did not touch is
//     written. One more warp sums the B hinges in a fixed order into the
//     loss. Every block scans all 6B ids, O(B^2) work in all: small at the
//     trainer's B = 100, and the reason the wrapper caps B.
// Nothing comes back to the host, so a step costs the host no sync.
//
// Conventions follow _margin_grads exactly: relu'(0) = 0 (act > 0 strictly),
// sign(0) = 0, the L2 norm is sqrt(sum x^2 + 1e-12), DistMult sums h*r*t.
// Every product, sum and the update use the _rn intrinsics, so nvcc contracts
// nothing into an FMA: each value is rounded where the plain PyTorch version
// rounds it, and on inputs whose sums are exact the two agree bit for bit.
//
// What bounds it: at B = 100, d = 100 the step moves about 1 MB (6B gathered
// rows, the 6B scratch rows written and read, at most 4B + 2B rows read and
// written), 0.3 us at 3.35 TB/s. The two launches, each a few us of latency
// on a dozen or a hundred warps, are what it actually costs; batching steps
// (a persistent kernel, or CUDA graphs) is the lever, left for later.
#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sparse_update {

enum Mode { L1 = 0, L2 = 1, DOT = 2 };
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
// dynamic shared memory a block may opt in to on Hopper (227 KB)
constexpr size_t SMEM_LIMIT = 232448;

// Butterfly sum: every lane ends with the same value (fp add commutes).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float sign_of(float x) {
  return (float)((x > 0.f) - (x < 0.f));
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
grads_kernel(const float* __restrict__ ent, const float* __restrict__ rel,
             const int64_t* __restrict__ pos, const int64_t* __restrict__ neg,
             float* __restrict__ g_e, float* __restrict__ g_r, float* __restrict__ hinge,
             int B, int64_t E, int64_t R, int d, float margin) {
  const int row = (int)((blockIdx.x * (unsigned)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;
  const int64_t h = pos[3 * row], r = pos[3 * row + 1], t = pos[3 * row + 2];
  const int64_t nh = neg[3 * row], nr = neg[3 * row + 1], nt = neg[3 * row + 2];
  assert(h >= 0 && h < E && t >= 0 && t < E && nh >= 0 && nh < E && nt >= 0 && nt < E);
  assert(r >= 0 && r < R && nr >= 0 && nr < R);
  const float* he = ent + h * d;
  const float* re = rel + r * d;
  const float* te = ent + t * d;
  const float* nhe = ent + nh * d;
  const float* nre = rel + nr * d;
  const float* nte = ent + nt * d;

  // scores (lanes stride the width, then a warp sum)
  float sp = 0.f, sn = 0.f;
  for (int j = lane; j < d; j += 32) {
    if (MODE == DOT) {
      sp = __fadd_rn(sp, __fmul_rn(__fmul_rn(he[j], re[j]), te[j]));
      sn = __fadd_rn(sn, __fmul_rn(__fmul_rn(nhe[j], nre[j]), nte[j]));
    } else {
      const float dp = __fsub_rn(__fadd_rn(he[j], re[j]), te[j]);
      const float dn = __fsub_rn(__fadd_rn(nhe[j], nre[j]), nte[j]);
      if (MODE == L1) {
        sp = __fadd_rn(sp, fabsf(dp));
        sn = __fadd_rn(sn, fabsf(dn));
      } else {
        sp = __fadd_rn(sp, __fmul_rn(dp, dp));
        sn = __fadd_rn(sn, __fmul_rn(dn, dn));
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
  const float act = __fadd_rn(__fsub_rn(margin, sp), sn);
  // dL/ds_pos = -a, dL/ds_neg = +a with a = 1[act > 0] / B
  const float a = act > 0.f ? __fdiv_rn(1.0f, (float)B) : 0.f;
  if (lane == 0) hinge[row] = isnan(act) ? act : fmaxf(act, 0.f);

  // per-occurrence gradients (the rows are re-read: they sit in L1)
  float* ge_h = g_e + (size_t)row * d;
  float* ge_t = g_e + (size_t)(B + row) * d;
  float* ge_nh = g_e + (size_t)(2 * B + row) * d;
  float* ge_nt = g_e + (size_t)(3 * B + row) * d;
  float* gr_p = g_r + (size_t)row * d;
  float* gr_n = g_r + (size_t)(B + row) * d;
  const float na = -a;
  for (int j = lane; j < d; j += 32) {
    if (MODE == DOT) {
      ge_h[j] = __fmul_rn(na, __fmul_rn(re[j], te[j]));
      ge_t[j] = __fmul_rn(na, __fmul_rn(he[j], re[j]));
      gr_p[j] = __fmul_rn(na, __fmul_rn(he[j], te[j]));
      ge_nh[j] = __fmul_rn(a, __fmul_rn(nre[j], nte[j]));
      ge_nt[j] = __fmul_rn(a, __fmul_rn(nhe[j], nre[j]));
      gr_n[j] = __fmul_rn(a, __fmul_rn(nhe[j], nte[j]));
    } else {
      const float dp = __fsub_rn(__fadd_rn(he[j], re[j]), te[j]);
      const float dn = __fsub_rn(__fadd_rn(nhe[j], nre[j]), nte[j]);
      float gp, gn;
      if (MODE == L1) {
        gp = sign_of(dp);
        gn = sign_of(dn);
      } else {
        gp = __fdiv_rn(dp, np_);
        gn = __fdiv_rn(dn, nn_);
      }
      // s_pos = -||h + r - t||: d s_pos/dh = -g, d/dt = +g, d/dr = -g
      const float ap = __fmul_rn(a, gp), an = __fmul_rn(a, gn);
      ge_h[j] = ap;
      ge_t[j] = -ap;
      gr_p[j] = ap;
      ge_nh[j] = -an;
      ge_nt[j] = an;
      gr_n[j] = -an;
    }
  }
}

// Row id of entity occurrence k of [pos_h | pos_t | neg_h | neg_t].
__device__ __forceinline__ int64_t ent_occ(const int64_t* pos, const int64_t* neg, int k,
                                           int B) {
  const int q = k / B, i = k - q * B;
  return (q < 2 ? pos : neg)[3 * i + ((q & 1) ? 2 : 0)];
}

// Row id of relation occurrence k of [pos_r | neg_r].
__device__ __forceinline__ int64_t rel_occ(const int64_t* pos, const int64_t* neg, int k,
                                           int B) {
  return k < B ? pos[3 * k + 1] : neg[3 * (k - B) + 1];
}

// Warp-wide: occurrence k of the n ids in `ids` (shared memory) owns its row
// iff no earlier occurrence names the same id; the owner sums the gradient
// rows of every occurrence of that id in ascending order into `acc` (d
// floats of shared memory, column c touched only by lane c % 32) and
// writes the row once.
__device__ __forceinline__ void own_row(float* __restrict__ table, const float* __restrict__ g,
                                        const int* ids, int k, int n, int d, float lr,
                                        float* acc, int lane) {
  const int id = ids[k];
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int j = j0 + lane;
    if (__any_sync(FULL, j < k && ids[j] == id)) return;  // an earlier occurrence owns it
  }
  for (int c = lane; c < d; c += 32) acc[c] = 0.f;
  for (int j0 = k; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    unsigned m = __ballot_sync(FULL, j < n && ids[j] == id);
    while (m) {
      const int b = __ffs(m) - 1;
      m &= m - 1;
      const float* gj = g + (size_t)(j0 + b) * d;
      for (int c = lane; c < d; c += 32) acc[c] = __fadd_rn(acc[c], gj[c]);
    }
  }
  float* out = table + (size_t)id * d;
  for (int c = lane; c < d; c += 32) out[c] = __fsub_rn(out[c], __fmul_rn(lr, acc[c]));
}

// Dynamic shared memory of the scatter launch: 6B ids, then one d-float
// accumulator row per warp.
inline size_t scatter_smem(int B, int d) {
  return (size_t)6 * B * sizeof(int) + (size_t)WARPS * d * sizeof(float);
}

__global__ void __launch_bounds__(THREADS)
scatter_kernel(float* __restrict__ ent, float* __restrict__ rel,
               const int64_t* __restrict__ pos, const int64_t* __restrict__ neg,
               const float* __restrict__ g_e, const float* __restrict__ g_r,
               const float* __restrict__ hinge, float* __restrict__ loss, int B, int d,
               float lr) {
  extern __shared__ float4 smem4[];
  int* ids = reinterpret_cast<int*>(smem4);  // [4B entity ids | 2B relation ids]
  float* acc = reinterpret_cast<float*>(ids + 6 * B) + (size_t)(threadIdx.x >> 5) * d;
  const int ne = 4 * B, nr = 2 * B;
  for (int k = threadIdx.x; k < ne + nr; k += blockDim.x)
    ids[k] = (int)(k < ne ? ent_occ(pos, neg, k, B) : rel_occ(pos, neg, k - ne, B));
  __syncthreads();
  const int w = (int)((blockIdx.x * (unsigned)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (w < ne) {
    own_row(ent, g_e, ids, w, ne, d, lr, acc, lane);
  } else if (w < ne + nr) {
    own_row(rel, g_r, ids + ne, w - ne, nr, d, lr, acc, lane);
  } else if (w == ne + nr) {
    // loss = mean of the hinges, summed in a fixed order
    float s = 0.f;
    for (int i = lane; i < B; i += 32) s = __fadd_rn(s, hinge[i]);
    s = warp_sum(s);
    if (lane == 0) loss[0] = __fdiv_rn(s, (float)B);
  }
}

template <int MODE>
int launch(float* ent, float* rel, const int64_t* pos, const int64_t* neg, float* g_e,
           float* g_r, float* hinge, float* loss, int B, int64_t E, int64_t R, int d, float lr,
           float margin, cudaStream_t s) {
  const int blocks_a = (B + WARPS - 1) / WARPS;
  grads_kernel<MODE><<<blocks_a, THREADS, 0, s>>>(ent, rel, pos, neg, g_e, g_r, hinge, B, E,
                                                  R, d, margin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps_b = 6 * B + 1;
  const int blocks_b = (warps_b + WARPS - 1) / WARPS;
  const size_t smem = scatter_smem(B, d);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  scatter_kernel<<<blocks_b, THREADS, smem, s>>>(ent, rel, pos, neg, g_e, g_r, hinge, loss, B,
                                                 d, lr);
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

extern "C" int sparse_update_step(void* ent, void* rel, const void* pos, const void* neg,
                                  void* g_e, void* g_r, void* hinge, void* loss, int B,
                                  long long E, long long R, int d, float lr, float margin,
                                  int mode, int device, void* stream) {
  using namespace sparse_update;
  if (B <= 0 || d <= 0 || E <= 0 || R <= 0 || E > INT32_MAX || R > INT32_MAX ||
      scatter_smem(B, d) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto ef = static_cast<float*>(ent);
  auto rf = static_cast<float*>(rel);
  auto pi = static_cast<const int64_t*>(pos);
  auto ni = static_cast<const int64_t*>(neg);
  auto ge = static_cast<float*>(g_e);
  auto gr = static_cast<float*>(g_r);
  auto hi = static_cast<float*>(hinge);
  auto lo = static_cast<float*>(loss);
  return on_device(device, [&]() -> int {
    switch (mode) {
      case L1: return launch<L1>(ef, rf, pi, ni, ge, gr, hi, lo, B, E, R, d, lr, margin, s);
      case L2: return launch<L2>(ef, rf, pi, ni, ge, gr, hi, lo, B, E, R, d, lr, margin, s);
      case DOT: return launch<DOT>(ef, rf, pi, ni, ge, gr, hi, lo, B, E, R, d, lr, margin, s);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

extern "C" const char* sparse_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
