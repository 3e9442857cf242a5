// Tile math shared by the two triple_score kernels, the Hopper counterpart
// of `_tile_scores` in the JAX package's kernels/triple_score/triple_score.py.
//
// The four modes are a template parameter:
//   L1  : -sum |q - e|
//   L2  : -sqrt(max(|q|^2 - 2 q.e + |e|^2, 0) + 1e-12)   (clamped expansion)
//   DOT : q . e
//   CL1 : -sum_k sqrt((qr_k - er_k)^2 + (qi_k - ei_k)^2 + 1e-12)
//         over the [re | im] halves of a row (RotatE).
//
// What bounds the work: l1 and cl1 are no products, so the tensor cores
// cannot take them; an l1 term is two fp32 instructions (a subtract, then an
// add with the |.| operand modifier) on the fp32 pipe, 33.5 T instructions/s
// on an H100 SXM. At B = 64, E = 491,078, d = 100 that is 0.188 ms against
// 0.059 ms of table read, so the design below is an SGEMM-like register
// micro-kernel that keeps the fp32 pipe fed:
//
// * A block holds a query tile of QT rows (8, 16, 32 or 64: the launcher
//   picks the smallest that covers the batch), staged in shared memory once,
//   and walks a persistent sequence of 128-entity tiles. Its 8 compute warps
//   each keep an MQ x ME micro-tile of partial sums per thread in registers
//   (8 x 4 at QT = 64): per float4 step along the row a thread loads MQ
//   query and ME entity float4 from shared memory and spends 8 * MQ * ME
//   fp32 instructions on them (l1), loading the next step's operands while
//   it computes.
// * A warp's lanes form a 4 x 8 grid over queries and entities, as in an
//   SGEMM warp tile: lane (ql, el) takes query rows ql, ql + 4, ... and
//   entity rows el, el + 8, ... of its warp's slice. A 128-bit shared load
//   then reads 4 distinct query rows (or 8 distinct entity rows): consecutive
//   rows, which the odd row stride in float4 puts on distinct bank groups,
//   so every load is one conflict-free wavefront.
// * A ninth warp only copies: it fills two entity buffers in turn with
//   asynchronous bulk copies (one cp.async.bulk of the whole tile when its
//   rows are contiguous in shared memory too, as at d = 100, else one per
//   row), and full/empty mbarriers hand each buffer between it and the
//   compute warps, so no block-wide barrier stalls the arithmetic and the
//   compute warps spend no instruction on copies. Rows are staged in chunks
//   of CHUNK columns (CHUNK / 2 pairs for CL1), so any d up to a few
//   thousand fits. Rows whose address is not 16-byte aligned (d % 4 != 0, a
//   chunk view table[c0:c1] with such a d, or CL1's imaginary half at
//   d / 2 % 4 != 0) take 4-byte cp.async copies instead, which zero-fill
//   rows past E and columns past the row.
// * Each (query, entity) sum stays in one thread and runs over the row in
//   column order, with explicitly rounded intrinsics (no contraction): a
//   score recomputed by `pair_score` from device memory is the same float
//   as the tile's, and dyadic inputs give the plain version's bits. Zero pad
//   columns add exactly nothing to L1, L2 and DOT sums; CL1 masks its pad
//   pairs, whose term would be sqrt(1e-12). Scores of entity rows past E
//   are computed from whatever the buffer holds and dropped.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "split_tf32.cuh"  // cp.async helpers

namespace triple_score {

enum Mode { L1 = 0, L2 = 1, DOT = 2, CL1 = 3 };

constexpr int THREADS = 256;          // compute threads per block
constexpr int WARPS = THREADS / 32;
constexpr int BLOCK = THREADS + 32;   // and one copying warp
constexpr int TE = 128;               // entities per tile
constexpr int QT_MAX = 64;            // largest query tile
constexpr int CHUNK = 128;            // floats of a row per stage (a multiple of 8)

// Register micro-tile of a thread for each query tile: MQ queries x ME
// entities. A warp's lanes are LQ x LE over queries and entities; WQ warps
// split the query tile and WE the entity tile, and every choice covers
// QT queries and TE entities.
constexpr int LQ = 4, LE = 8;
template <int QT> struct Tiling;
template <> struct Tiling<64> { static constexpr int MQ = 8, ME = 4; };
template <> struct Tiling<32> { static constexpr int MQ = 4, ME = 4; };
template <> struct Tiling<16> { static constexpr int MQ = 4, ME = 2; };
template <> struct Tiling<8> { static constexpr int MQ = 2, ME = 2; };

template <int QT>
struct Micro {
  static constexpr int MQ = Tiling<QT>::MQ;
  static constexpr int ME = Tiling<QT>::ME;
  static constexpr int WQ = QT / (LQ * MQ);
  static constexpr int WE = WARPS / WQ;
  static_assert(WQ * LQ * MQ == QT && WE * WQ == WARPS && WE * LE * ME == TE, "tiling");
  // first query and entity row of this thread; its others are LQ and LE apart
  __device__ static int qrow0() {
    return ((threadIdx.x >> 5) % WQ) * (LQ * MQ) + (threadIdx.x & (LQ - 1));
  }
  __device__ static int erow0() {
    return ((threadIdx.x >> 5) / WQ) * (LE * ME) + ((threadIdx.x & 31) / LQ);
  }
};

// Row geometry of one launch, the same on host and device.
struct Geo {
  int d;    // floats per row in device memory
  int h;    // terms per row: d / 2 pairs (CL1), d columns otherwise
  int kc;   // terms per chunk (the last chunk may hold fewer)
  int nch;  // chunks per row
  int c4;   // float4 per chunk row (per half for CL1)
  int s4;   // shared-memory row stride in float4: odd
};

__host__ __device__ inline Geo make_geo(int d, int mode) {
  Geo G;
  G.d = d;
  G.h = mode == CL1 ? d / 2 : d;
  const int cap = mode == CL1 ? CHUNK / 2 : CHUNK;
  G.kc = G.h < cap ? G.h : cap;
  G.nch = (G.h + G.kc - 1) / G.kc;
  G.c4 = (G.kc + 3) / 4;
  G.s4 = (mode == CL1 ? 2 * G.c4 : G.c4) | 1;
  return G;
}

// Dynamic shared memory of a block: two entity buffers of TE rows, the
// query tile (QT rows for each chunk), QT words of |q|^2 (L2), QT words of
// counts (fused ranks), then the four mbarriers.
struct Bars {
  uint64_t full[2], empty[2];
};

__host__ __device__ inline size_t smem_bytes(const Geo& G, int qt) {
  return sizeof(float4) * (size_t)(2 * TE + G.nch * qt) * G.s4 + 2 * sizeof(float) * (size_t)qt +
         sizeof(Bars);
}

struct Smem {
  float4* ebuf;   // two entity buffers, TE * s4 float4 each
  float4* qtile;  // nch * QT rows
  float* qq;      // QT
  int* cnt;       // QT
  Bars* bars;
};

template <int QT>
__device__ inline Smem carve(float4* smem4, const Geo& G) {
  Smem S;
  S.ebuf = smem4;
  S.qtile = smem4 + (size_t)2 * TE * G.s4;
  S.qq = reinterpret_cast<float*>(S.qtile + (size_t)G.nch * QT * G.s4);
  S.cnt = reinterpret_cast<int*>(S.qq + QT);
  S.bars = reinterpret_cast<Bars*>(S.cnt + QT);  // 8-byte aligned: QT is a multiple of 8
  return S;
}

// ------------------------------------------------------------ the terms
// One term of a row's sum. Every site that scores a (query, entity) pair
// goes through these, in column order, so they all round alike.
__device__ __forceinline__ float l1_term(float acc, float x, float a) {
  return __fadd_rn(acc, fabsf(__fsub_rn(x, a)));
}

__device__ __forceinline__ float dot_term(float acc, float x, float a) {
  return __fmaf_rn(x, a, acc);
}

__device__ __forceinline__ float cl1_term(float acc, float xr, float xi, float ar, float ai) {
  const float dr = __fsub_rn(xr, ar);
  const float di = __fsub_rn(xi, ai);
  return __fadd_rn(acc, __fsqrt_rn(__fadd_rn(__fmaf_rn(dr, dr, __fmul_rn(di, di)), 1e-12f)));
}

// The score from the row sum `acc`; for L2 `qq` = |q|^2 and `ee` = |e|^2.
template <int MODE>
__device__ __forceinline__ float finish(float acc, float qq, float ee) {
  if (MODE == DOT) return acc;
  if (MODE == L2) {
    const float d2 = __fadd_rn(__fsub_rn(qq, __fmul_rn(2.0f, acc)), ee);
    return -__fsqrt_rn(__fadd_rn(fmaxf(d2, 0.0f), 1e-12f));
  }
  return -acc;
}

// |x|^2 of a row in device memory, in column order.
__device__ inline float row_norm(const float* __restrict__ x, int d) {
  float acc = 0.0f;
  for (int k = 0; k < d; ++k) acc = dot_term(acc, x[k], x[k]);
  return acc;
}

// The score of one (query, entity) pair read from device memory: the same
// float as the tile's score of the pair.
template <int MODE>
__device__ inline float pair_score(const float* __restrict__ q, const float* __restrict__ e,
                                   const Geo& G, float qq) {
  float acc = 0.0f, ee = 0.0f;
  if (MODE == CL1) {
    for (int k = 0; k < G.h; ++k) acc = cl1_term(acc, q[k], q[G.h + k], e[k], e[G.h + k]);
  } else {
    for (int k = 0; k < G.d; ++k) {
      acc = MODE == L1 ? l1_term(acc, q[k], e[k]) : dot_term(acc, q[k], e[k]);
      if (MODE == L2) ee = dot_term(ee, e[k], e[k]);
    }
  }
  return finish<MODE>(acc, qq, ee);
}

// ---------------------------------------------------- mbarriers, bulk copies
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tf32x3::smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tf32x3::smem_addr(bar))
               : "memory");
}

// An arrival that also announces `bytes` of bulk copies to complete.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   tf32x3::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = tf32x3::smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One arrival on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   tf32x3::smem_addr(bar))
               : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device to
// shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(tf32x3::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(tf32x3::smem_addr(bar))
      : "memory");
}

// Barrier of the compute warps alone (the copying warp never joins it).
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// ------------------------------------------------------------- staging
// Copies chunk `chunk` of rows [row0, row0 + nrows) of a (total, d) matrix
// into `dst` (row r at dst + r * s4) with cp.async, thread `t` of `nt`. The
// threads walk the rows' float4 (or, on the 4-byte path, floats) in one flat
// sequence, so neighbouring threads copy neighbouring addresses and no lane
// idles at a row's end. Rows at or past `total`, and columns past the row
// up to its last float4, are zero-filled.
__device__ __forceinline__ void stage_rows(float4* __restrict__ dst,
                                           const float* __restrict__ src, int row0, int nrows,
                                           int total, int chunk, int halves, const Geo& G,
                                           bool vec, int t, int nt) {
  const int k0 = chunk * G.kc;
  const int kc = min(G.kc, G.h - k0);
  const int w = vec ? kc >> 2 : 4 * ((kc + 3) >> 2);  // items per row half
  const int per_row = halves * w;
  const int dr = nt / per_row, dc = nt - dr * per_row;
  int r = t / per_row, c = t - r * per_row;
  for (int it = t; it < nrows * per_row; it += nt) {
    const int half = c >= w;
    const int cc = c - half * w;
    const int gr = row0 + r;
    const float* row = src + (size_t)(gr < total ? gr : 0) * G.d + k0 + half * G.h;
    if (vec) {
      tf32x3::cp_async16(dst + (size_t)r * G.s4 + half * G.c4 + cc, row + 4 * cc, gr < total);
    } else {
      const bool ok = gr < total && cc < kc;
      tf32x3::cp_async4(reinterpret_cast<float*>(dst + (size_t)r * G.s4 + half * G.c4) + cc,
                        ok ? row + cc : src, ok);
    }
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// Run by every thread of the block first: thread 0 sets up the mbarriers,
// the compute threads start copying the query tile (every chunk) with
// cp.async; then one block-wide barrier, the only one. The compute threads
// wait for their copies with `queries_landed`.
template <int MODE, int QT>
__device__ __forceinline__ void setup(const Smem& S, const float* __restrict__ q, int q0, int B,
                                      const Geo& G, bool vec) {
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      bar_init(&S.bars->full[b], 32);
      bar_init(&S.bars->empty[b], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < THREADS) {
    for (int c = 0; c < G.nch; ++c) {
      stage_rows(S.qtile + (size_t)c * QT * G.s4, q, q0, QT, B, c, MODE == CL1 ? 2 : 1, G, vec,
                 threadIdx.x, THREADS);
    }
    tf32x3::cp_async_commit();
  }
  __syncthreads();
}

__device__ __forceinline__ void queries_landed() {
  tf32x3::cp_async_wait<0>();
  compute_sync();
}

__device__ __forceinline__ int block_stages(int E, const Geo& G) {
  const int ntiles = (E + TE - 1) / TE;
  return G.nch * ((ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x);
}

// The copying warp: entity tile blockIdx.x, then every gridDim.x-th, chunk
// by chunk, into buffer s % 2 for stage s once the compute warps have
// released it.
template <int MODE>
__device__ void produce(const Smem& S, const float* __restrict__ ent, int E, const Geo& G,
                        bool vec) {
  const int lane = threadIdx.x & 31;
  const int halves = MODE == CL1 ? 2 : 1;
  const int nst = block_stages(E, G);
  // a tile's rows lie back to back in shared memory as in device memory
  const bool whole = vec && G.nch == 1 && halves * G.c4 == G.s4;
  int tile = blockIdx.x, chunk = 0;
  for (int s = 0; s < nst; ++s) {
    const int b = s & 1;
    if (s >= 2) bar_wait(&S.bars->empty[b], ((s >> 1) - 1) & 1);
    float4* dst = S.ebuf + (size_t)b * TE * G.s4;
    uint64_t* full = &S.bars->full[b];
    const int e0 = tile * TE;
    const int rows = min(TE, E - e0);
    if (!vec) {
      stage_rows(dst, ent, e0, TE, E, chunk, halves, G, false, lane, 32);
      cp_async_arrive(full);
    } else if (whole) {
      if (lane == 0) {
        const uint32_t bytes = (uint32_t)rows * G.d * sizeof(float);
        bar_arrive_tx(full, bytes);
        bulk_copy(dst, ent + (size_t)e0 * G.d, bytes, full);
      } else {
        bar_arrive(full);
      }
    } else {
      const int k0 = chunk * G.kc;
      const uint32_t row_bytes = 4 * min(G.kc, G.h - k0);
      uint32_t mine = 0;
      for (int r = lane; r < rows; r += 32) mine += halves * row_bytes;
      bar_arrive_tx(full, mine);
      for (int r = lane; r < rows; r += 32) {
        const float* src = ent + (size_t)(e0 + r) * G.d + k0;
        for (int half = 0; half < halves; ++half) {
          bulk_copy(dst + (size_t)r * G.s4 + half * G.c4, src + half * G.h, row_bytes, full);
        }
      }
    }
    if (++chunk == G.nch) {
      chunk = 0;
      tile += gridDim.x;
    }
  }
  // stay until the last copies have landed
  if (nst > 0) bar_wait(&S.bars->full[(nst - 1) & 1], ((nst - 1) >> 1) & 1);
}

// ------------------------------------------------------------ the micro-kernel
// The first n (<= 4) pair terms of a float4 step of CL1.
__device__ __forceinline__ float cl1_step(float acc, const float4 xr, const float4 xi,
                                          const float4 ar, const float4 ai, int n) {
  acc = cl1_term(acc, xr.x, xi.x, ar.x, ai.x);
  if (n > 1) acc = cl1_term(acc, xr.y, xi.y, ar.y, ai.y);
  if (n > 2) acc = cl1_term(acc, xr.z, xi.z, ar.z, ai.z);
  if (n > 3) acc = cl1_term(acc, xr.w, xi.w, ar.w, ai.w);
  return acc;
}

// Adds one staged chunk of `kc` terms to the thread's micro-tile. `qb` is
// its first query row (the others LQ rows apart), `eb` its first entity row
// (the others LE rows apart); `ee` gathers |e|^2 for L2.
template <int MODE, int MQ, int ME>
__device__ __forceinline__ void mac_chunk(const float4* __restrict__ qb,
                                          const float4* __restrict__ eb, const Geo& G, int kc,
                                          float (&acc)[MQ][ME], float (&ee)[ME]) {
  const int qs = LQ * G.s4, es = LE * G.s4;
  if (MODE == CL1) {
    const int c4 = G.c4;
    const int full = kc >> 2;
    for (int k = 0; k <= full; ++k) {
      const int n = k < full ? 4 : (kc & 3);
      if (n == 0) break;
      float4 ar[ME], ai[ME];
#pragma unroll
      for (int i = 0; i < ME; ++i) {
        ar[i] = eb[i * es + k];
        ai[i] = eb[i * es + c4 + k];
      }
#pragma unroll
      for (int m = 0; m < MQ; ++m) {
        const float4 xr = qb[m * qs + k];
        const float4 xi = qb[m * qs + c4 + k];
        if (n == 4) {
#pragma unroll
          for (int i = 0; i < ME; ++i) acc[m][i] = cl1_step(acc[m][i], xr, xi, ar[i], ai[i], 4);
        } else {
#pragma unroll
          for (int i = 0; i < ME; ++i) acc[m][i] = cl1_step(acc[m][i], xr, xi, ar[i], ai[i], n);
        }
      }
    }
  } else {
    // operands of step k + 1 are loaded while step k is computed
    const int n4 = (kc + 3) >> 2;
    float4 av[ME], xv[MQ];
#pragma unroll
    for (int i = 0; i < ME; ++i) av[i] = eb[i * es];
#pragma unroll
    for (int m = 0; m < MQ; ++m) xv[m] = qb[m * qs];
    for (int k = 0; k < n4; ++k) {
      float a[4][ME], x[4][MQ];
#pragma unroll
      for (int i = 0; i < ME; ++i) {
        a[0][i] = av[i].x, a[1][i] = av[i].y, a[2][i] = av[i].z, a[3][i] = av[i].w;
      }
#pragma unroll
      for (int m = 0; m < MQ; ++m) {
        x[0][m] = xv[m].x, x[1][m] = xv[m].y, x[2][m] = xv[m].z, x[3][m] = xv[m].w;
      }
      if (k + 1 < n4) {
#pragma unroll
        for (int i = 0; i < ME; ++i) av[i] = eb[i * es + k + 1];
#pragma unroll
        for (int m = 0; m < MQ; ++m) xv[m] = qb[m * qs + k + 1];
      }
      // column by column, every accumulator once per column: MQ * ME
      // independent terms between two that depend on each other
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (MODE == L2) {
#pragma unroll
          for (int i = 0; i < ME; ++i) ee[i] = dot_term(ee[i], a[c][i], a[c][i]);
        }
#pragma unroll
        for (int m = 0; m < MQ; ++m)
#pragma unroll
          for (int i = 0; i < ME; ++i)
            acc[m][i] = MODE == L1 ? l1_term(acc[m][i], x[c][m], a[c][i])
                                   : dot_term(acc[m][i], x[c][m], a[c][i]);
      }
    }
  }
}

// The compute warps: score the query tile against the block's entity tiles
// as the copying warp delivers them, and hand each finished tile to
// `epi(e0, scores)`: scores[m][i] of query row Micro::qrow0() + LQ * m and
// entity e0 + Micro::erow0() + LE * i. The query tile and, for L2, S.qq
// must be in place (`queries_landed`).
template <int MODE, int QT, typename Epi>
__device__ __forceinline__ void consume(const Smem& S, int E, const Geo& G, Epi&& epi) {
  using T = Micro<QT>;
  constexpr int MQ = T::MQ, ME = T::ME;
  const int qrow = T::qrow0(), erow = T::erow0();
  const int lane = threadIdx.x & 31;
  const int nst = block_stages(E, G);

  float acc[MQ][ME], ee[ME];
#pragma unroll
  for (int m = 0; m < MQ; ++m)
#pragma unroll
    for (int i = 0; i < ME; ++i) acc[m][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < ME; ++i) ee[i] = 0.0f;

  int tile = blockIdx.x, chunk = 0;
  for (int s = 0; s < nst; ++s) {
    const int b = s & 1;
    bar_wait(&S.bars->full[b], (s >> 1) & 1);
    mac_chunk<MODE, MQ, ME>(S.qtile + (size_t)(chunk * QT + qrow) * G.s4,
                            S.ebuf + ((size_t)b * TE + erow) * G.s4, G,
                            min(G.kc, G.h - chunk * G.kc), acc, ee);
    __syncwarp();
    if (lane == 0) bar_arrive(&S.bars->empty[b]);  // the buffer is free again
    if (chunk == G.nch - 1) {
      float sc[MQ][ME];
#pragma unroll
      for (int m = 0; m < MQ; ++m) {
        const float qq = MODE == L2 ? S.qq[qrow + LQ * m] : 0.0f;
#pragma unroll
        for (int i = 0; i < ME; ++i) {
          sc[m][i] = finish<MODE>(acc[m][i], qq, ee[i]);
          acc[m][i] = 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < ME; ++i) ee[i] = 0.0f;
      epi(tile * TE, sc);
    }
    if (++chunk == G.nch) {
      chunk = 0;
      tile += gridDim.x;
    }
  }
}

// 16-byte copies are possible for every row of both matrices.
inline bool rows_aligned16(const void* q, const void* ent, int d, int mode) {
  const int span = mode == CL1 ? d / 2 : d;
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(ent) & 15) == 0 && d % 4 == 0 && span % 4 == 0;
}

// Query tile for a batch of B rows: the smallest of 8, 16, 32, 64 that
// holds the batch's share of one grid row (batches past 64 rows take
// ceil(B / 64) grid rows), halved while the block's shared memory would
// exceed `limit` bytes (long rows); 0 if not even 8 rows fit.
inline int pick_query_tile(int B, const Geo& G, int limit) {
  const int rows = (B + QT_MAX - 1) / QT_MAX;
  const int per = (B + rows - 1) / rows;
  int qt = per <= 8 ? 8 : per <= 16 ? 16 : per <= 32 ? 32 : 64;
  while (qt > 8 && smem_bytes(G, qt) > (size_t)limit) qt /= 2;
  return smem_bytes(G, qt) <= (size_t)limit ? qt : 0;
}

// ------------------------------------------------------------- launching
// Largest dynamic shared memory a block may use on this device.
inline int max_dynamic_smem(int device) {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return v;
}

// Launch shape of one kernel instantiation for one (device, d): worked out
// on the first launch and reused, so later launches make no attribute or
// occupancy query. `blocks` is the number of blocks resident on the whole
// device at once.
struct Plan {
  int device, d;  // key
  size_t smem;    // dynamic shared memory bytes
  int blocks;
};

constexpr int MAX_PLANS = 64;

// A small table of plans for one kernel instantiation. Past MAX_PLANS keys a
// plan is worked out anew on every launch, which is slower but still right.
struct PlanCache {
  std::mutex mu;
  Plan plans[MAX_PLANS];
  int n = 0;

  template <typename Kernel>
  int get(Kernel kernel, int device, int d, size_t smem, Plan* out) {
    std::lock_guard<std::mutex> guard(mu);
    for (int i = 0; i < n; ++i) {
      if (plans[i].device == device && plans[i].d == d) {
        *out = plans[i];
        return 0;
      }
    }
    const int limit = max_dynamic_smem(device);
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    // The largest opt-in size, not this plan's: plans of one kernel with
    // different sizes then never shrink each other's allowance.
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    Plan p{device, d, smem, per_sm * sms};
    if (n < MAX_PLANS) plans[n++] = p;
    *out = p;
    return 0;
  }
};

// Grid of a persistent launch: one row per query tile, and per row as many
// blocks as keep the resident ones busy in equal rounds: with R rounds of
// tiles, ceil(ntiles / R) blocks, so the last round is not mostly empty.
inline dim3 persistent_grid(int blocks, int B, int E, int qt) {
  const int ntiles = (E + TE - 1) / TE;
  const int qtiles = (B + qt - 1) / qt;
  int per_row = blocks / qtiles;
  if (per_row < 1) per_row = 1;
  const int rounds = (ntiles + per_row - 1) / per_row;
  return dim3((ntiles + rounds - 1) / rounds, qtiles);
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
