// Top-k of the pairwise scores on Hopper, selected inside the pairwise kernel.
//
// out[i] = the kb best (score, entity) pairs of query i over the entities
// e < E not listed in filt[i] (pad -1), best first, in the order of the
// serving tier's blockwise top-k scan (ops.py::topk_scan): by
// score, ties to the lower entity id, -0.0 tying with +0.0. Places that no
// such entity fills hold (-inf, -1). The (B, E) scores never reach device
// memory: the scan wrote them, masked them, keyed them and radix-selected
// them chunk by chunk, about twenty launches a chunk; here a batch is two.
//
// 1. `pairwise_kernel_topk` scores as `pairwise_kernel` does (the copying
//    warp, two buffers, the MQ x ME register micro-tiles of tile_score.cuh,
//    a persistent grid over 128-entity tiles and query tiles), and instead of
//    storing a tile's scores it offers them to top-k lists in shared memory.
//    Each compute warp keeps one list per query row it scores: the kb best
//    keys it has kept, in descending order, and CAND candidate slots. A
//    score is tested against its list's threshold (the kb-th kept key, read
//    as a float once per tile); only one that beats it is keyed and pushed
//    into a candidate slot with a shared atomic, each lane's in turn, the
//    lanes side by side. That is rare once the threshold has risen. A warp
//    one of whose lists is full folds its full lists (a lane each: a
//    candidate that still beats the threshold and is not in the row's
//    filter, staged in shared memory when it fits, is inserted) and
//    retries the pushes that found one full, so no barrier is shared
//    between warps while the tiles stream. At the end the warps that share
//    a row fold their lists into one (the whole warp a list: each key's
//    place among both sets is counted and the key written there), and each
//    block writes kb keys a row to a (B, blocks per query tile, kb) scratch.
//    The kernel's name keeps `pairwise_kernel`: the benchmark's roofline
//    reader finds the pairwise work's device time by that fragment.
// 2. `topk_merge_kernel` folds each row's per-block lists into kb keys, one
//    block a row, and writes the scores and int32 ids.
//
// A key is unique and orders as the scan does: the high 32 bits are the
// order-preserving image of score + 0.0 (the scan's `_ordered_keys`), the
// low 32 the id reversed (bits 31..1), so that the lower id wins a tie, and
// in bit 0 whether the score was -0.0, so the score comes back raw, as
// `pairwise_kernel` writes it. No key of an entity reaches EMPTY, the key of
// -inf past every id, so a list starts as EMPTY and -inf never enters it.
//
// What bounds it: at the tier's top-k batch (B = 2,048 padded, E = 491,078,
// d = 100, l1) the scoring is 2 * B * E * d = 2.0e11 fp32 instructions
// (6.0 ms at 33.5 T instructions/s) and reads the table once per 64-row query
// tile (6.3 GB, 1.9 ms at 3.35 TB/s); the threshold test adds about two
// instructions to a score's two hundred.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_score.cuh"

namespace triple_score {

typedef unsigned long long Key;

constexpr int CAND = 16;  // candidate slots of a list
constexpr Key EMPTY = (0x007FFFFFull << 32) | 0xFFFFFFFFull;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ Key topk_key(float s, int id) {
  const uint32_t b = __float_as_uint(__fadd_rn(s, 0.0f));  // -0.0 -> +0.0
  const uint32_t o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((Key)o << 32) | ((uint32_t)(0x7FFFFFFF - id) << 1) |
         (uint32_t)(__float_as_uint(s) == 0x80000000u);
}

// The score whose image is the key's high half: a float no larger than the
// score of any key at or above `k` (-inf for EMPTY).
__device__ __forceinline__ float key_floor(Key k) {
  const uint32_t o = (uint32_t)(k >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__device__ __forceinline__ float key_score(Key k) { return k & 1 ? -0.0f : key_floor(k); }

__device__ __forceinline__ int key_id(Key k) { return 0x7FFFFFFF - (int)((uint32_t)k >> 1); }

// Folds `cand` (lane l < c holds one; c is the same in every lane) into
// kept[0, kb), the kb largest keys so far in descending order, EMPTY past
// the last, so that it holds the kb largest of both. A candidate goes to the
// number of keys above it in both sets; a kept key at p to p plus the
// candidates above it, so kept keys only move towards the end, and they are
// moved in slices of 32 from the end, each read before it is written.
// Candidates at or below EMPTY are dropped.
__device__ __forceinline__ void fold(Key* kept, int kb, Key cand, int c) {
  const int lane = threadIdx.x & 31;
  int place = 0;
  for (int j = 0; j < c; ++j) place += __shfl_sync(FULL, cand, j) > cand;
  int lo = 0, hi = kb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kept[mid] > cand) lo = mid + 1;
    else hi = mid;
  }
  place += lo;
  for (int p0 = (kb - 1) & ~31; p0 >= 0; p0 -= 32) {
    const int p = p0 + lane;
    const Key k = p < kb ? kept[p] : 0;
    int up = 0;
    for (int j = 0; j < c; ++j) up += __shfl_sync(FULL, cand, j) > k;
    __syncwarp();
    if (p < kb && p + up < kb) kept[p + up] = k;
    __syncwarp();
  }
  if (lane < c && cand > EMPTY && place < kb) kept[place] = cand;
  __syncwarp();
}

// Folds the sorted list `other` (shared or device memory) into `base`,
// 32 keys at a time, up to its first key that cannot enter.
__device__ __forceinline__ void merge_list(Key* base, const Key* other, int kb) {
  const int lane = threadIdx.x & 31;
  for (int p0 = 0; p0 < kb; p0 += 32) {
    if (!(other[p0] > base[kb - 1])) break;
    const int c = min(32, kb - p0);
    fold(base, kb, lane < c ? other[p0 + lane] : 0, c);
  }
}

// Keys of a list: kb kept, then CAND candidates, then one more if that is
// even, so that the lanes of a warp, each at its own list, hit distinct banks.
__host__ __device__ inline int list_keys(int kb) { return (kb + CAND) | 1; }

// The top-k state of a block, after tile_score.cuh's layout: one list per
// (compute warp, query row of the warp), then the staged filter.
struct Lists {
  Key* keys;   // slots * list_keys(kb)
  Key* thk;    // slots: the kb-th kept key
  float* thf;  // slots: key_floor(thk)
  int* cnt;    // slots: candidates pushed since the last fold
  int* filt;   // QT * F, if staged
  int kb;
  __device__ Key* list(int slot) const { return keys + (size_t)slot * list_keys(kb); }
};

// Query rows of a compute warp for each query tile.
__host__ __device__ constexpr int warp_rows(int qt) {
  return qt == 64 ? LQ * Tiling<64>::MQ
                  : qt == 32 ? LQ * Tiling<32>::MQ : qt == 16 ? LQ * Tiling<16>::MQ
                                                              : LQ * Tiling<8>::MQ;
}

__host__ __device__ inline size_t list_bytes(int qt, int kb) {
  return (size_t)WARPS * warp_rows(qt) * ((size_t)list_keys(kb) * sizeof(Key) + 16);
}

template <int QT>
__device__ inline Lists carve_lists(float4* smem4, const Geo& G, int kb) {
  constexpr int SLOTS = WARPS * warp_rows(QT);
  Lists L;
  L.keys = reinterpret_cast<Key*>(reinterpret_cast<char*>(smem4) + smem_bytes(G, QT));
  L.thk = L.keys + (size_t)SLOTS * list_keys(kb);
  L.thf = reinterpret_cast<float*>(L.thk + SLOTS);
  L.cnt = reinterpret_cast<int*>(L.thf + SLOTS);
  L.filt = L.cnt + SLOTS;
  L.kb = kb;
  return L;
}

__device__ __forceinline__ bool listed(const int* frow, int F, int id) {
  int f = 0;
  while (f < F && frow[f] != id) ++f;
  return f < F;
}

// Folds the candidates of every list of this warp whose count reaches
// `at_least` (those not listed in the row's filter, at frows + row * F,
// where row is the list's place in the warp) and sets its threshold. A
// few full lists are folded one after another by the whole warp, a
// candidate a lane; many, as at the start when a warp's lists fill
// together, side by side, a list a lane, by insertion.
template <int RW>
__device__ __forceinline__ void fold_lists(const Lists& L, int at_least, const int* frows,
                                           int F) {
  constexpr int SIDE_BY_SIDE = 8;  // full lists from which lanes fold a list each
  const int lane = threadIdx.x & 31, slot0 = (threadIdx.x >> 5) * RW;
  const int kb = L.kb;
  __syncwarp();  // the pushes of every lane are in place
  unsigned todo = __ballot_sync(FULL, lane < RW && L.cnt[slot0 + lane] >= at_least);
  if (__popc(todo) > SIDE_BY_SIDE) {
    if (todo >> lane & 1) {
      Key* kept = L.list(slot0 + lane);
      const int c = min(L.cnt[slot0 + lane], CAND);
      for (int j = 0; j < c; ++j) {
        const Key x = kept[kb + j];
        if (!(x > kept[kb - 1]) || listed(frows + (size_t)lane * F, F, key_id(x))) continue;
        int p = kb - 1;
        for (; p > 0 && kept[p - 1] < x; --p) kept[p] = kept[p - 1];
        kept[p] = x;
      }
    }
  } else {
    for (unsigned rest = todo; rest; rest &= rest - 1) {
      const int r = __ffs(rest) - 1;
      Key* kept = L.list(slot0 + r);
      const int c = min(L.cnt[slot0 + r], CAND);
      Key x = lane < c ? kept[kb + lane] : 0;
      if (x > kept[kb - 1] && listed(frows + (size_t)r * F, F, key_id(x))) x = 0;
      fold(kept, kb, x, c);
    }
  }
  __syncwarp();
  if (todo >> lane & 1) {
    const Key t = L.list(slot0 + lane)[kb - 1];
    L.cnt[slot0 + lane] = 0;
    L.thk[slot0 + lane] = t;
    L.thf[slot0 + lane] = key_floor(t);
  }
  __syncwarp();
}

// One score offered to list `slot`: true if it is settled (pushed, or
// below the threshold), false if the list was full (fold, then retry). The
// filter is checked when the list is folded.
__device__ __forceinline__ bool offer(const Lists& L, int slot, float s, int id) {
  const Key key = topk_key(s, id);
  if (!(key > L.thk[slot])) return true;
  const int at = atomicAdd(&L.cnt[slot], 1);
  if (at >= CAND) return false;
  L.list(slot)[L.kb + at] = key;
  return true;
}

template <int MODE, int QT>
__global__ void __launch_bounds__(BLOCK)
pairwise_kernel_topk(const float* __restrict__ q, const float* __restrict__ ent,
                     const int* __restrict__ filt, Key* __restrict__ part, int B, int E, int d,
                     int F, int kb, int staged, int vec) {
  using T = Micro<QT>;
  constexpr int MQ = T::MQ, ME = T::ME, RW = warp_rows(QT), SLOTS = WARPS * RW;
  static_assert(RW == LQ * MQ && RW <= 32 && MQ * ME <= 32, "lists");
  extern __shared__ float4 smem4[];
  const Geo G = make_geo(d, MODE);
  const Smem S = carve<QT>(smem4, G);
  const Lists L = carve_lists<QT>(smem4, G, kb);
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
  for (int i = threadIdx.x; i < SLOTS * list_keys(kb); i += THREADS) L.keys[i] = EMPTY;
  for (int i = threadIdx.x; i < SLOTS; i += THREADS) {
    L.thk[i] = EMPTY;
    L.thf[i] = -INFINITY;
    L.cnt[i] = 0;
  }
  if (staged) {
    for (int i = threadIdx.x; i < nq * F; i += THREADS) L.filt[i] = filt[(size_t)q0 * F + i];
  }
  queries_landed();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qrow = T::qrow0(), erow = T::erow0();
  const int slot0 = warp * RW + (lane & (LQ - 1));  // list of query row qrow + LQ * m
  // filter rows of the warp's query rows, the first at (warp % WQ) * RW
  const int* frows = (staged ? L.filt : filt + (size_t)q0 * F) + (size_t)(warp % T::WQ) * RW * F;
  uint32_t rows = 0;  // this thread's (m, i) bits of live query rows
#pragma unroll
  for (int m = 0; m < MQ; ++m) {
    if (qrow + LQ * m < nq) rows |= ((1u << ME) - 1) << (m * ME);
  }

  consume<MODE, QT>(S, E, G, [&](int e0, const float (&sc)[MQ][ME]) {
    uint32_t pend = 0;
#pragma unroll
    for (int m = 0; m < MQ; ++m) {
      const float t = L.thf[slot0 + LQ * m];
#pragma unroll
      for (int i = 0; i < ME; ++i) {
        if (!(sc[m][i] < t)) pend |= 1u << (m * ME + i);
      }
    }
    pend &= rows;
    if (e0 + TE > E) {  // the table's ragged last tile
#pragma unroll
      for (int i = 0; i < ME; ++i) {
        if (e0 + erow + LE * i >= E) {
#pragma unroll
          for (int m = 0; m < MQ; ++m) pend &= ~(1u << (m * ME + i));
        }
      }
    }
    // each lane offers its own scores one at a time, the lanes side by side
    while (__any_sync(FULL, pend)) {
      uint32_t todo = pend;
      while (__any_sync(FULL, todo)) {
        if (todo) {
          const int b = __ffs(todo) - 1;
          todo &= todo - 1;
          float s = 0.0f;
#pragma unroll
          for (int m = 0; m < MQ; ++m)
#pragma unroll
            for (int i = 0; i < ME; ++i) s = b == m * ME + i ? sc[m][i] : s;
          const int m = b / ME, i = b - m * ME;
          if (offer(L, slot0 + LQ * m, s, e0 + erow + LE * i)) pend &= ~(1u << b);
        }
      }
      if (!__any_sync(FULL, pend)) break;
      fold_lists<RW>(L, CAND, frows, F);
    }
  });

  fold_lists<RW>(L, 1, frows, F);
  compute_sync();
  // fold the lists of the WE warps that share a row into the first one's
  for (int j = warp; j < nq; j += WARPS) {
    const int w0 = j / RW, r = j - w0 * RW;
    Key* base = L.list(w0 * RW + r);
    for (int t = 1; t < T::WE; ++t) merge_list(base, L.list((w0 + T::WQ * t) * RW + r), kb);
    Key* out = part + ((size_t)(q0 + j) * gridDim.x + blockIdx.x) * kb;
    for (int p = lane; p < kb; p += 32) out[p] = base[p];
  }
}

// One block a row: each warp folds every WARPS-th of the row's `nblk`
// lists, then warp 0 folds the warps' results and writes the row.
__global__ void __launch_bounds__(THREADS)
topk_merge_kernel(const Key* __restrict__ part, float* __restrict__ vals, int* __restrict__ ids,
                  int nblk, int kb) {
  extern __shared__ Key merged[];  // WARPS * kb
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row = blockIdx.x;
  Key* mine = merged + (size_t)warp * kb;
  for (int p = lane; p < kb; p += 32) mine[p] = EMPTY;
  __syncwarp();
  for (int l = warp; l < nblk; l += WARPS) merge_list(mine, part + (row * nblk + l) * kb, kb);
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < WARPS && w < nblk; ++w) merge_list(mine, merged + (size_t)w * kb, kb);
  for (int p = lane; p < kb; p += 32) {
    const Key k = mine[p];
    vals[row * kb + p] = k > EMPTY ? key_score(k) : -INFINITY;
    ids[row * kb + p] = k > EMPTY ? key_id(k) : -1;
  }
}

// ------------------------------------------------------------- launching
struct TopkArgs {
  const float* q;
  const float* ent;
  const int* filt;
  Key* part;
  float* vals;
  int* ids;
  int B, E, d, F, kb, vec, device;
  cudaStream_t stream;
};

// Query tile, whether the filter is staged, and shared memory of a launch;
// qt 0 if not even a tile of 8 rows holds kb.
struct Shape {
  int qt, staged;
  size_t smem;
};

inline Shape topk_shape(int B, const Geo& G, int kb, int F, int limit) {
  Shape s{pick_query_tile(B, G, limit), 0, 0};
  while (s.qt > 8 && smem_bytes(G, s.qt) + list_bytes(s.qt, kb) > (size_t)limit) s.qt /= 2;
  if (s.qt == 0 || smem_bytes(G, s.qt) + list_bytes(s.qt, kb) > (size_t)limit) return {0, 0, 0};
  s.smem = smem_bytes(G, s.qt) + list_bytes(s.qt, kb);
  const size_t staged = sizeof(int) * (size_t)s.qt * F;
  s.staged = s.smem + staged <= (size_t)limit;
  if (s.staged) s.smem += staged;
  return s;
}

// With `launch` false, only sets *nblk, the blocks of a query tile's grid
// row; with it true, launches both kernels (a.part holds B * *nblk * kb).
template <int MODE, int QT>
static int run(const TopkArgs& a, const Shape& sh, bool launch, int* nblk) {
  static PlanCache cache;
  auto kernel = pairwise_kernel_topk<MODE, QT>;
  Plan plan;
  // keyed by the shared memory size, which alone sets the occupancy here
  int rc = cache.get(kernel, a.device, (int)sh.smem, sh.smem, &plan);
  if (rc) return rc;
  const dim3 grid = persistent_grid(plan.blocks, a.B, a.E, QT);
  if (!launch) {
    *nblk = (int)grid.x;
    return 0;
  }
  if ((int)grid.x != *nblk) return (int)cudaErrorInvalidValue;
  kernel<<<grid, BLOCK, sh.smem, a.stream>>>(a.q, a.ent, a.filt, a.part, a.B, a.E, a.d, a.F,
                                              a.kb, sh.staged, a.vec);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  topk_merge_kernel<<<a.B, THREADS, sizeof(Key) * WARPS * a.kb, a.stream>>>(
      a.part, a.vals, a.ids, grid.x, a.kb);
  return (int)cudaGetLastError();
}

template <int MODE>
static int run_mode(const TopkArgs& a, bool launch, int* nblk) {
  const Shape sh = topk_shape(a.B, make_geo(a.d, MODE), a.kb, a.F, max_dynamic_smem(a.device));
  switch (sh.qt) {
    case 8: return run<MODE, 8>(a, sh, launch, nblk);
    case 16: return run<MODE, 16>(a, sh, launch, nblk);
    case 32: return run<MODE, 32>(a, sh, launch, nblk);
    case 64: return run<MODE, 64>(a, sh, launch, nblk);
    default: return (int)cudaErrorInvalidValue;  // kb or the rows too long for shared memory
  }
}

static int dispatch(const TopkArgs& a, int mode, bool launch, int* nblk) {
  if (a.B <= 0 || a.E <= 0 || a.kb <= 0 || a.kb > a.E || a.F <= 0 || a.d <= 0 ||
      (mode == CL1 && a.d % 2)) {
    return (int)cudaErrorInvalidValue;
  }
  return on_device(a.device, [&]() -> int {
    switch (mode) {
      case L1: return run_mode<L1>(a, launch, nblk);
      case L2: return run_mode<L2>(a, launch, nblk);
      case DOT: return run_mode<DOT>(a, launch, nblk);
      case CL1: return run_mode<CL1>(a, launch, nblk);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

}  // namespace triple_score

// The largest kb that a query tile of 8 rows holds at row width d.
extern "C" int triple_score_topk_cap(int d, int mode, int device) {
  using namespace triple_score;
  if (d <= 0) return 0;
  int limit = 0;
  const int rc = on_device(device, [&]() -> int {
    limit = max_dynamic_smem(device);
    return 0;
  });
  if (rc) return 0;
  const long long room = (long long)limit - (long long)smem_bytes(make_geo(d, mode), 8);
  const long long slots = (long long)WARPS * warp_rows(8);
  long long kb = (room / slots - 16) / (long long)sizeof(Key) - CAND;
  if (kb > 0 && list_keys((int)kb) > kb + CAND) --kb;  // the odd pad key
  return kb > 0 ? (int)kb : 0;
}

// Blocks of a query tile's grid row for this batch (the scratch's middle
// extent) in *nblk.
extern "C" int triple_score_topk_blocks(int B, int E, int d, int F, int kb, int mode,
                                        int device, int* nblk) {
  using namespace triple_score;
  TopkArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B, E, d, F, kb, 1, device,
             nullptr};
  return dispatch(a, mode, false, nblk);
}

extern "C" int triple_score_topk(const void* q, const void* ent, const void* filt, void* part,
                                 void* vals, void* ids, int B, int E, int d, int F, int kb,
                                 int nblk, int mode, int device, void* stream) {
  using namespace triple_score;
  TopkArgs a{static_cast<const float*>(q), static_cast<const float*>(ent),
             static_cast<const int*>(filt), static_cast<Key*>(part), static_cast<float*>(vals),
             static_cast<int*>(ids), B, E, d, F, kb, rows_aligned16(q, ent, d, mode), device,
             static_cast<cudaStream_t>(stream)};
  return dispatch(a, mode, true, &nblk);
}

extern "C" const char* triple_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
