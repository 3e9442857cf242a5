// Tile math shared by the two triple_score kernels, the Hopper counterpart
// of `_tile_scores` in the JAX package's kernels/triple_score/triple_score.py.
//
// A block stages a tile of TE entity rows and a tile of up to QT query rows
// in shared memory, then every thread scores ONE entity of the tile against
// QB queries at a time, keeping the QB partial sums in registers. The four
// modes are a template parameter:
//   L1  : -sum |q - e|
//   L2  : -sqrt(max(|q|^2 - 2 q.e + |e|^2, 0) + 1e-12)   (clamped expansion)
//   DOT : q . e
//   CL1 : -sum_k sqrt((qr_k - er_k)^2 + (qi_k - ei_k)^2 + 1e-12)
//         over the [re | im] halves of a row (RotatE).
//
// Shared-memory row layout: a row of d floats is stored with stride S
// floats, S a multiple of 4 with S/4 odd. Threads of a warp read 16 bytes
// each from 32 consecutive rows; a 128-bit shared load is served 8 lanes at
// a time, and an odd stride in float4 units puts those 8 lanes on distinct
// bank groups, so the loads are conflict-free. Pad columns are zero, which
// adds nothing to L1, L2 or DOT sums. CL1 rows keep the real half at
// [0, h) and the imaginary half at [hp, hp + h) with hp = h rounded up to
// 4, so both halves are float4-aligned (a row's imaginary half in device
// memory is not 16-byte aligned at d = 100); CL1 masks columns >= h since
// its pad term would be sqrt(1e-12), not 0.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace triple_score {

enum Mode { L1 = 0, L2 = 1, DOT = 2, CL1 = 3 };

constexpr int THREADS = 256;            // threads per block
constexpr int TE = 64;                  // entities per tile
constexpr int GROUPS = THREADS / TE;    // query groups: 4, two warps each
constexpr int QB = 4;                   // queries per register block
constexpr int QT_MAX = 64;              // largest query tile

struct Layout {
  int d;   // floats per row in device memory
  int h;   // columns summed per half (CL1) or per row (others)
  int hp;  // h rounded up to a multiple of 4
  int s;   // shared-memory row stride in floats
};

__host__ __device__ inline Layout make_layout(int d, int mode) {
  Layout L;
  L.d = d;
  int span;
  if (mode == CL1) {
    L.h = d / 2;
    L.hp = (L.h + 3) & ~3;
    span = 2 * L.hp;
  } else {
    L.h = d;
    L.hp = (d + 3) & ~3;
    span = L.hp;
  }
  if (span < 4) span = 4;
  if ((span / 4) % 2 == 0) span += 4;
  L.s = span;
  return L;
}

// Shared-memory floats a block needs: entity tile, query tile, and `extra`
// per-query words (gold, |q|^2, counts).
__host__ __device__ inline size_t tile_smem_bytes(const Layout& L, int qt, int extra_words) {
  return sizeof(float) * ((size_t)(TE + qt) * L.s + (size_t)extra_words);
}

// Copy rows [row0, row0 + nrows) of a row-major (total, d) matrix into the
// shared layout; rows past `total` and all pad columns become 0. One warp per
// row, lanes on consecutive columns: coalesced, and safe for any alignment.
template <int MODE>
__device__ inline void stage_rows(float* __restrict__ dst, const float* __restrict__ src,
                                  int row0, int nrows, int total, const Layout& L) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < nrows; r += nwarps) {
    const int gr = row0 + r;
    float* drow = dst + (size_t)r * L.s;
    const bool live = gr < total;
    const float* srow = src + (size_t)(live ? gr : 0) * L.d;
    for (int c = lane; c < L.s; c += 32) {
      int sc;  // source column of shared column c, or -1 for a pad column
      if (MODE == CL1) {
        sc = c < L.h ? c : (c >= L.hp && c < L.hp + L.h ? L.h + (c - L.hp) : -1);
      } else {
        sc = c < L.d ? c : -1;
      }
      drow[c] = (live && sc >= 0) ? srow[sc] : 0.0f;
    }
  }
}

// Sum of squares of one staged row (the |e|^2 or |q|^2 of the L2 expansion).
__device__ inline float row_sq(const float* __restrict__ row, const Layout& L) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float acc = 0.0f;
  for (int k = 0; k < L.hp / 4; ++k) {
    const float4 v = r4[k];
    acc += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
  return acc;
}

__device__ inline float cl1_term(float dr, float di, bool live) {
  return live ? sqrtf(dr * dr + di * di + 1e-12f) : 0.0f;
}

// Scores of one staged entity row `er` against the QB staged query rows
// `qrow[m]`. For L2, `qq[m]` is |q|^2 and `ee` is |e|^2.
template <int MODE>
__device__ inline void score_rows(const float* __restrict__ er,
                                  const float* const (&qrow)[QB],
                                  const float (&qq)[QB], float ee,
                                  const Layout& L, float (&out)[QB]) {
  float acc[QB];
#pragma unroll
  for (int m = 0; m < QB; ++m) acc[m] = 0.0f;
  const int n4 = L.hp / 4;
  const float4* e4 = reinterpret_cast<const float4*>(er);
  if (MODE == CL1) {
    for (int k = 0; k < n4; ++k) {
      const float4 a = e4[k];
      const float4 b = e4[n4 + k];
      const int c = 4 * k;
#pragma unroll
      for (int m = 0; m < QB; ++m) {
        const float4* q4 = reinterpret_cast<const float4*>(qrow[m]);
        const float4 x = q4[k];
        const float4 y = q4[n4 + k];
        acc[m] += cl1_term(x.x - a.x, y.x - b.x, c + 0 < L.h)
                + cl1_term(x.y - a.y, y.y - b.y, c + 1 < L.h)
                + cl1_term(x.z - a.z, y.z - b.z, c + 2 < L.h)
                + cl1_term(x.w - a.w, y.w - b.w, c + 3 < L.h);
      }
    }
  } else {
    for (int k = 0; k < n4; ++k) {
      const float4 a = e4[k];
#pragma unroll
      for (int m = 0; m < QB; ++m) {
        const float4 x = reinterpret_cast<const float4*>(qrow[m])[k];
        if (MODE == L1) {
          acc[m] += fabsf(x.x - a.x) + fabsf(x.y - a.y)
                  + fabsf(x.z - a.z) + fabsf(x.w - a.w);
        } else {
          acc[m] += x.x * a.x + x.y * a.y + x.z * a.z + x.w * a.w;
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < QB; ++m) {
    if (MODE == L1 || MODE == CL1) {
      out[m] = -acc[m];
    } else if (MODE == DOT) {
      out[m] = acc[m];
    } else {
      out[m] = -sqrtf(fmaxf(qq[m] - 2.0f * acc[m] + ee, 0.0f) + 1e-12f);
    }
  }
}

// Largest dynamic shared memory a block may use on this device.
inline int max_dynamic_smem(int device) {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return v;
}

// Query-tile height: the largest of 64, 32, 16 whose tile fits in `limit`
// bytes together with `extra_words` per query row and `fixed_bytes`; 0 when
// even 16 rows do not fit.
inline int pick_query_tile(const Layout& L, int words_per_query, size_t fixed_bytes, int limit) {
  for (int qt = QT_MAX; qt >= 16; qt /= 2) {
    if (tile_smem_bytes(L, qt, qt * words_per_query) + fixed_bytes <= (size_t)limit) return qt;
  }
  return 0;
}

// Launch shape of one kernel instantiation for one (device, d, F): worked
// out on the first launch and reused, so later launches make no attribute or
// occupancy query. `blocks` is the number of blocks resident on the whole
// device at once.
struct Plan {
  int device, d, f;  // key (f = 0 where the kernel takes no filter)
  int qt;            // query-tile height
  int filt_smem;     // filter rows staged in shared memory (fused ranks)
  size_t smem;       // dynamic shared memory bytes
  int blocks;
};

constexpr int MAX_PLANS = 64;

// A small table of plans for one kernel instantiation. Past MAX_PLANS keys a
// plan is worked out anew on every launch, which is slower but still right.
struct PlanCache {
  std::mutex mu;
  Plan plans[MAX_PLANS];
  int n = 0;

  // Sets *out to the plan for the key; on first use `make(plan)` fills
  // plan.qt, .filt_smem and .smem (returning a cudaError_t code, 0 when it
  // succeeds), and the block count is read from occupancy.
  template <typename Kernel, typename Make>
  int get(Kernel kernel, int device, int d, int f, Plan* out, Make&& make) {
    std::lock_guard<std::mutex> guard(mu);
    for (int i = 0; i < n; ++i) {
      const Plan& p = plans[i];
      if (p.device == device && p.d == d && p.f == f) {
        *out = p;
        return 0;
      }
    }
    Plan p{device, d, f, 0, 0, 0, 0};
    int rc = make(p);
    if (rc) return rc;
    // The largest opt-in size, not this plan's: plans of one kernel with
    // different sizes then never shrink each other's allowance.
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           max_dynamic_smem(device));
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, p.smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    p.blocks = per_sm * sms;
    if (n < MAX_PLANS) plans[n++] = p;
    *out = p;
    return 0;
  }
};

// Grid of a persistent launch: entity-tile blocks per query tile, so that
// all query tiles together fill the device once, and never more blocks than
// entity tiles.
inline dim3 persistent_grid(const Plan& p, int B, int E) {
  const int ntiles = (E + TE - 1) / TE;
  const int qtiles = (B + p.qt - 1) / p.qt;
  int gx = p.blocks / qtiles;
  if (gx < 1) gx = 1;
  if (gx > ntiles) gx = ntiles;
  return dim3(gx, qtiles);
}

// Runs `launch` with `device` current in this library's CUDA runtime (it
// keeps its own current device, separate from the caller's), then restores.
template <typename F>
inline int on_device(int device, F&& launch) {
  int prev = -1;
  cudaGetDevice(&prev);
  if (prev != device) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  int rc = launch();
  if (prev != device && prev >= 0) cudaSetDevice(prev);
  return rc;
}

}  // namespace triple_score
