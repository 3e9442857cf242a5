// Relation-grouped projected filtered ranks on Hopper: TransR's link
// prediction, s(h, r, t) = -|h M_r + r - t M_r|_1 with one d x d matrix M_r
// per relation.
//
// Replaces no Pallas kernel: the JAX package streams TransR's ranks through
// `score_triples` by index expansion, which gathers a d x d matrix for every
// (query, entity) pair. Here a batch's rows come sorted by relation, with
// group offsets, and one launch counts every row's filtered rank:
//   out[order[p]] = #{ e < E not listed in filt[order[p]] :
//                      -|q_p - e M_r|_1 > gold_p },
//   q_p = fixed_p M_r + sign * r   (sign +1: tails, fixed = h; -1: heads,
//                                   fixed = t, the candidates are heads),
//   gold_p = -|q_p - g_p M_r|_1    (g = the gold entity).
//
// What bounds it: a relation's ranks need the whole entity table projected
// through M_r, 2 E d^2 FLOP (9.8 GFLOP at E = 491,078, d = 100) for each
// distinct relation of the batch. In split TF32 (three TF32 products a
// product, include/split_tf32.cuh, as accurate as fp32) at 495 TFLOP/s that
// is 0.06 ms a relation, about 0.11 s for the ~1,900 relations of a
// 2,048-row batch of uniform relations; the L1 scan of the projected rows is
// 2 b E d fp32 instructions (6 ms at b = 2,048) and the bytes a few hundred
// MB. So the projection is a tensor-core GEMM and the rest is small beside
// it. The design keeps the projected table out of device memory:
//
// * One cooperative launch of a persistent grid (one block of two
//   warpgroups an SM). Phase 1: blocks take relation groups in turn, stage
//   M_r in shared memory in mma.sync's fragment order and project each
//   query's fixed and gold entity rows (a 16-row tile holds 8 queries' two
//   rows), writing q and the gold entity's projected row to a (B, DP)
//   scratch, then the gold score. A grid barrier follows (the launch is
//   cooperative, so every block is resident).
// * Phase 2: work units are (slab of 128 entity rows, chunk of GC groups),
//   handed out by an atomic counter, slab-fastest, so the blocks at work at
//   one time share the chunk's matrices in L2. Each warpgroup holds its 64
//   entity rows as split A fragments in registers for the whole unit and,
//   for each group, issues wgmma.m64n104k8.tf32 three times a k-step (A
//   from registers, B = M_r^T from shared memory: K-major core matrices of 8
//   rows x 16 bytes, no swizzle, hi and lo tiles). The next group's M_r,
//   copied raw by cp.async one group ahead, is transposed and split into the
//   other pair of tiles in two parts: warpgroup 1 splits the first before
//   issuing its products, while warpgroup 0's run, and warpgroup 0 the rest
//   while warpgroup 1's run, then copies the group after's matrix and the
//   next group's queries, gold scores and rows in (an mma-issuing warp runs
//   what follows its products only once they are done, so each warpgroup's
//   share of the staging has to sit beside the other's products). One block
//   barrier and one named barrier a group hand the tiles over.
//   Then each thread adds |q - projected| over its accumulator columns for
//   its two rows, four shuffles finish a row's L1 sum, and a row that beats
//   gold counts unless the query's filter row lists it (a membership test,
//   so repeated ids and the gold id itself are left out once; no pair has to
//   be rescored). A warp adds its count to `out` with one atomic a query.
// * d is padded to DP = 104 inside the kernel only (zero columns of the
//   rows and of M_r add exact zeros), so d <= 104.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_score.cuh"

namespace projected {

using triple_score::l1_term;
using namespace tf32x3;

constexpr int WARPS = 8;             // two warpgroups
constexpr int THREADS = 32 * WARPS;
constexpr int NK = 13;               // k-steps of 8
constexpr int DP = 8 * NK;           // padded width: the wgmma's N
constexpr int SLAB = 128;            // entity rows a unit, 64 a warpgroup
constexpr int GC = 32;               // relation groups a unit
constexpr int QH = 8;                // queries of a group staged in shared memory
constexpr int FS = 16;               // filter ids of a staged query kept beside it
constexpr int SBO = DP / 4 * 32;     // floats between 8-row groups of a split tile
constexpr int TILE = DP * DP;        // floats of a split tile
constexpr unsigned FULL = 0xffffffffu;
constexpr int SLOTS = 2;             // query slots: groups g and g + 1
// split tiles [2][hi, lo][TILE], raw M [TILE], queries [SLOTS][QH][DP], then
// gold, rows [SLOTS][QH] each, filter ids [SLOTS][QH][FS], the unit's groups
// (first position, size, relation) [3][GC] and the unit number
constexpr size_t SMEM = 4 * ((size_t)5 * TILE + SLOTS * QH * (DP + 2 + FS) + 3 * GC + 1);
static_assert(SMEM <= 232448, "one block per SM");
static_assert((size_t)NK * NK * 32 * 16 <= 4 * TILE * sizeof(float), "phase 1 fits");

struct Args {
  const float* ent;      // (E, d)
  const float* proj;     // (R, d, d)
  const float* rel;      // (R, d)
  const int* fixed;      // (B,) the fixed entity of each row (request order)
  const int* gold_id;    // (B,) its gold entity
  const int* rel_id;     // (B,) its relation
  const int* filt;       // (B, F) ids each row leaves out (pad -1)
  const int* order;      // (B,) sorted position -> request row
  const int* offsets;    // (B + 1,) group starts, B past the last group
  float* qp;             // (B, DP) scratch: projected queries, by sorted position
  float* gp;             // (B, DP) scratch: projected gold entities
  float* gold;           // (B,) scratch: gold scores
  unsigned* barrier;     // zeroed by the caller
  int* work;             // zeroed by the caller
  int* out;              // (B,) zeroed by the caller
  int B, E, d, F;
  float sign;
  int vec;               // 16-byte copies of M_r
};

// Phase 1's shape: the same passes of n-tiles as mma.sync's accumulators
constexpr int NPASS = (NK + 6) / 7;
constexpr int NPT = (NK + NPASS - 1) / NPASS;

// hi = x rounded to TF32 (by the bit pattern, as cvt.rna does for finite x),
// lo = the rest rounded to TF32
__device__ __forceinline__ void split_fast(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32x3::tf32_rna_bits(x);
  lo = tf32x3::tf32_rna_bits(x - __uint_as_float(hi));
}

// Number of groups: offsets rise and equal B exactly from the first empty one.
__device__ int count_groups(const int* offsets, int B) {
  int lo = 0, hi = B;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (__ldg(offsets + mid) >= B) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// M (d x d, row = input column, col = output column) into B fragments of
// every (k-step, n-tile): lane (g, t) holds M[8k + t][8n + g] and
// M[8k + t + 4][8n + g], as {hi, hi, lo, lo}.
// The loop is unrolled, so a thread's loads are all in flight at once.
__device__ void stage_m(uint4* S, const float* __restrict__ M, int d) {
  constexpr int TOTAL = NK * NK * 32, ITER = (TOTAL + THREADS - 1) / THREADS;
  float b[ITER][2];
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int lane = i & 31, kn = i >> 5;
    const int k = kn / NK, n = kn - k * NK;
    const int row = 8 * k + (lane & 3), col = 8 * n + (lane >> 2);
    const bool in = i < TOTAL && col < d;
    b[it][0] = in && row < d ? __ldg(M + (size_t)row * d + col) : 0.0f;
    b[it][1] = in && row + 4 < d ? __ldg(M + (size_t)(row + 4) * d + col) : 0.0f;
  }
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (i < TOTAL) {
      uint32_t h0, l0, h1, l1;
      tf32x3::split(b[it][0], h0, l0);
      tf32x3::split(b[it][1], h1, l1);
      S[i] = make_uint4(h0, h1, l0, l1);
    }
  }
}

// acc[n] += A · B_(n0 + n) over one k-step for the n-tiles n0 + n < NK of
// a pass, A given split (ah, al): each pair of B fragments is read at once,
// and each of the three products goes over both accumulators of the pair
// before the next, so no mma waits on the one just issued.
__device__ __forceinline__ void mma_k(float (&acc)[NPT][4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], const uint4* S, int k, int n0,
                                      int lane) {
#pragma unroll
  for (int n2 = 0; n2 < NPT; n2 += 2) {
    uint32_t bh[2][2], bl[2][2];
    bool on[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      on[u] = n2 + u < NPT && n0 + n2 + u < NK;
      const uint4 b = on[u] ? S[(k * NK + n0 + n2 + u) * 32 + lane] : make_uint4(0, 0, 0, 0);
      bh[u][0] = b.x, bh[u][1] = b.y, bl[u][0] = b.z, bl[u][1] = b.w;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (on[u]) tf32x3::mma(acc[n2 + u], al, bh[u]);
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (on[u]) tf32x3::mma(acc[n2 + u], ah, bl[u]);
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (on[u]) tf32x3::mma(acc[n2 + u], ah, bh[u]);
  }
}

// Phase 1: each group's queries and gold scores, with mma.sync.
__device__ void project_queries(const Args& a, uint4* S, int G) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  for (int g = blockIdx.x; g < G; g += gridDim.x) {
    const int p0 = __ldg(a.offsets + g), n = __ldg(a.offsets + g + 1) - p0;
    const int rid = __ldg(a.rel_id + __ldg(a.order + p0));
    stage_m(S, a.proj + (size_t)rid * a.d * a.d, a.d);
    __syncthreads();
    // a 16-row tile: row g8 the fixed entity of query 8c + g8, row g8 + 8 its gold
    for (int c = warp; 8 * c < n; c += WARPS) {
      const int qi = 8 * c + g8;
      const bool live = qi < n;
      int ia = 0, ig = 0;
      if (live) {
        const int row = __ldg(a.order + p0 + qi);
        ia = __ldg(a.fixed + row);
        ig = __ldg(a.gold_id + row);
      }
      const float* ra = a.ent + (size_t)ia * a.d;
      const float* rg = a.ent + (size_t)ig * a.d;
      const size_t p = (size_t)(p0 + qi) * DP;
      const float* rr = a.rel + (size_t)rid * a.d;
#pragma unroll 1
      for (int pass = 0; pass < NPASS; ++pass) {
        float acc[NPT][4];
#pragma unroll
        for (int nn = 0; nn < NPT; ++nn) acc[nn][0] = acc[nn][1] = acc[nn][2] = acc[nn][3] = 0.0f;
#pragma unroll 1
        for (int k = 0; k < NK; ++k) {
          const int c0 = 8 * k + t4, c1 = c0 + 4;
          const float x[4] = {live && c0 < a.d ? __ldg(ra + c0) : 0.0f,
                              live && c0 < a.d ? __ldg(rg + c0) : 0.0f,
                              live && c1 < a.d ? __ldg(ra + c1) : 0.0f,
                              live && c1 < a.d ? __ldg(rg + c1) : 0.0f};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) split_fast(x[i], ah[i], al[i]);
          mma_k(acc, ah, al, S, k, pass * NPT, lane);
        }
        if (live) {
#pragma unroll
          for (int nn = 0; nn < NPT; ++nn) {
            const int col = 8 * (pass * NPT + nn) + 2 * t4;
            if (col >= DP) continue;
            const float r0 = col < a.d ? a.sign * __ldg(rr + col) : 0.0f;
            const float r1 = col + 1 < a.d ? a.sign * __ldg(rr + col + 1) : 0.0f;
            __stcg(reinterpret_cast<float2*>(a.qp + p + col),
                   make_float2(__fadd_rn(acc[nn][0], r0), __fadd_rn(acc[nn][1], r1)));
            __stcg(reinterpret_cast<float2*>(a.gp + p + col), make_float2(acc[nn][2], acc[nn][3]));
          }
        }
      }
    }
    __syncthreads();  // also: every warp is done with S before the next group
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const size_t p = (size_t)(p0 + i) * DP;
      float s = 0.0f;
      for (int c = 0; c < a.d; ++c) s = l1_term(s, __ldcg(a.qp + p + c), __ldcg(a.gp + p + c));
      __stcg(a.gold + p0 + i, -s);
    }
  }
}

// One-shot barrier of the whole (co-resident) grid.
__device__ void grid_barrier(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    while (*reinterpret_cast<volatile unsigned*>(count) < gridDim.x) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// ------------------------------------------------------------- phase 2
// wgmma descriptor of a K-major tile without swizzle: core matrices of 8 rows
// x 16 bytes, 128 bytes apart along K (leading byte offset), `sbo` bytes
// apart along N (stride byte offset).
__device__ __forceinline__ uint64_t make_desc(const float* tile, uint32_t sbo) {
  const uint32_t addr = smem_addr(tile);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

using Acc = float[52];

// D (64 x 104, fp32) += A (64 x 8, tf32, registers) · B (8 x 104, tf32,
// shared memory), or D = A · B when INIT. Per warp w of the warpgroup,
// a = A[16 w + g][t], A[16 w + g + 8][t], A[16 w + g][t + 4],
// A[16 w + g + 8][t + 4] and d[4 i + 2 h + e] = D[16 w + g + 8 h][8 i + 2 t + e]
// (g = lane / 4, t = lane % 4).
#define PR_WGMMA_D(c)                                                                      \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]), \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), c(d[17]),      \
      c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),      \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31]), c(d[32]), c(d[33]),      \
      c(d[34]), c(d[35]), c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]), c(d[41]),      \
      c(d[42]), c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), c(d[49]),      \
      c(d[50]), c(d[51])
#define PR_WGMMA_ASM                                                                       \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"                                              \
  "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 "                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51}, "       \
  "{%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
#define PR_IN_OUT(x) "+f"(x)
#define PR_OUT(x) "=f"(x)
template <bool INIT>
__device__ __forceinline__ void wgmma_tf32(Acc& d, const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (INIT) {
    asm volatile(PR_WGMMA_ASM
                 : PR_WGMMA_D(PR_OUT)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
  } else {
    asm volatile(PR_WGMMA_ASM
                 : PR_WGMMA_D(PR_IN_OUT)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory, made visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving reads of an accumulator above its wait.
__device__ __forceinline__ void fence_acc(Acc& d) {
#pragma unroll
  for (int i = 0; i < 52; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Copies M_r raw (d x d, as in device memory) into `raw` by cp.async,
// thread t of nt.
__device__ __forceinline__ void copy_m(const Args& a, float* raw, int rid, int t, int nt) {
  const float* M = a.proj + (size_t)rid * a.d * a.d;
  const int dd = a.d * a.d;
  if (a.vec) {
    for (int c = t; c < dd / 4; c += nt) cp_async16(raw + 4 * c, M + 4 * c, true);
  } else {
    for (int c = t; c < dd; c += nt) cp_async4(raw + c, M + c, true);
  }
}

// Query slot `s` of the block's shared memory: the first QH queries of a
// group, their gold scores, rows and (where F <= FS) filter ids.
struct Slots {
  float* q;     // [SLOTS][QH][DP]
  float* gold;  // [SLOTS][QH]
  int* row;     // [SLOTS][QH]
  int* filt;    // [SLOTS][QH][FS]
};

// Copies the group at positions [p0, p0 + n) into slot `s`, thread t of nt
// (the rows by plain loads and stores, the rest by cp.async).
__device__ __forceinline__ void copy_queries(const Args& a, const Slots& S, int s, int p0, int n,
                                             int t, int nt) {
  const int nq = min(QH, n);
  const float* src = a.qp + (size_t)p0 * DP;
  float* q = S.q + s * QH * DP;
  for (int c = t; c < nq * DP / 4; c += nt) cp_async16(q + 4 * c, src + 4 * c, true);
  if (t < nq) {
    const int row = __ldg(a.order + p0 + t);
    S.row[s * QH + t] = row;
    cp_async4(S.gold + s * QH + t, a.gold + p0 + t, true);
    if (a.F <= FS) {
      for (int f = 0; f < a.F; ++f)
        cp_async4(S.filt + (s * QH + t) * FS + f, a.filt + (size_t)row * a.F + f, true);
    }
  }
}

// M_r^T from `raw` into a hi and a lo K-major tile: element (n, k) = M[k][n]
// at (n / 8) SBO + (k / 4) 32 + (n % 8) 4 + k % 4, a thread a 16-byte quad of
// k at a time, SPLIT_BATCH quads' reads in flight. Entries past d are never
// written (zero from the start).
constexpr int SPLIT_ITEMS = DP * (DP / 4);  // (n, k quad) items of a padded tile
constexpr int SPLIT_BATCH = 4;
// the split's share of warpgroup 1, which runs it before its products
constexpr int SPLIT_FIRST = SPLIT_ITEMS / 2;
// Items [i_lo, i_hi) by thread t of nt.
__device__ __forceinline__ void split_m(const float* raw, float* hi, int d, int t, int nt,
                                        int i_lo, int i_hi) {
  for (int i0 = i_lo + t; i0 < i_hi; i0 += SPLIT_BATCH * nt) {
    float x[SPLIT_BATCH][4];
#pragma unroll
    for (int j = 0; j < SPLIT_BATCH; ++j) {
      const int it = i0 + j * nt;
      const int q = it / DP, n = it - q * DP, k = 4 * q;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        x[j][u] = it < i_hi && n < d && k + u < d ? raw[(k + u) * d + n] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < SPLIT_BATCH; ++j) {
      const int it = i0 + j * nt;
      const int q = it / DP, n = it - q * DP;
      if (it < i_hi && n < d && 4 * q < d) {
        uint4 hv, lv;
        split_fast(x[j][0], hv.x, lv.x);
        split_fast(x[j][1], hv.y, lv.y);
        split_fast(x[j][2], hv.z, lv.z);
        split_fast(x[j][3], hv.w, lv.w);
        const int off = (n >> 3) * SBO + q * 32 + (n & 7) * 4;
        *reinterpret_cast<uint4*>(hi + off) = hv;
        *reinterpret_cast<uint4*>(hi + TILE + off) = lv;
      }
    }
  }
}

// Whether entity e is listed in the filter row of request row `row`: its
// staged ids `fs` when there are some, else the row in device memory.
__device__ __forceinline__ bool listed(const Args& a, const int* fs, int row, int e) {
  if (fs != nullptr) {
    for (int i = 0; i < a.F; ++i)
      if (fs[i] == e) return true;
    return false;
  }
  const int* fr = a.filt + (size_t)row * a.F;
  for (int i = 0; i < a.F; ++i)
    if (__ldg(fr + i) == e) return true;
  return false;
}

// Named barrier SPLIT: warpgroup 1 arrives once its part of the next
// group's split is written, warpgroup 0 waits for it before copying over the
// raw matrix both parts read. One arrival a group, and the next one only
// after the block barrier that follows warpgroup 0's wait.
constexpr int SPLIT = 1;
__device__ __forceinline__ void split_arrive() {
  asm volatile("bar.arrive %0, %1;\n" ::"n"(SPLIT), "n"(THREADS) : "memory");
}
__device__ __forceinline__ void split_wait() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(SPLIT), "n"(THREADS) : "memory");
}

__global__ void __launch_bounds__(THREADS, 1) projected_rank_kernel(Args a) {
  extern __shared__ __align__(128) float smem[];
  float* sb = smem;                            // [2][hi, lo][TILE]
  float* raw = sb + 4 * TILE;                  // [TILE]
  Slots S;
  S.q = raw + TILE;
  S.gold = S.q + SLOTS * QH * DP;
  S.row = reinterpret_cast<int*>(S.gold + SLOTS * QH);
  S.filt = S.row + SLOTS * QH;
  int* grp = S.filt + SLOTS * QH * FS;         // [3][GC]
  int* unit_s = grp + 3 * GC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;

  if (tid == 0) *unit_s = count_groups(a.offsets, a.B);
  __syncthreads();
  const int G = *unit_s;

  project_queries(a, reinterpret_cast<uint4*>(smem), G);
  grid_barrier(a.barrier);
  // the split tiles start as zeros: entries past d stay so
  for (int i = tid; i < TILE; i += THREADS) reinterpret_cast<float4*>(sb)[i] = make_float4(0, 0, 0, 0);

  const int nslab = (a.E + SLAB - 1) / SLAB;
  const int nunit = nslab * ((G + GC - 1) / GC);
  uint32_t ah[NK][4], al[NK][4];
  Acc acc;
  for (;;) {
    __syncthreads();  // also: the previous unit is done with the tiles and groups
    if (tid == 0) *unit_s = atomicAdd(a.work, 1);
    __syncthreads();
    const int u = *unit_s;
    if (u >= nunit) break;
    const int g0 = (u / nslab) * GC, ng = min(G - g0, GC);
    // this warp's 16 rows: entity row0 + g8 + 8 h
    const int row0 = (u % nslab) * SLAB + 16 * warp;
    // the unit's groups: first position, size and relation
    int* gp0 = grp;
    int* gn = grp + GC;
    int* grid = grp + 2 * GC;
    if (tid < ng) {
      const int p0 = __ldg(a.offsets + g0 + tid);
      gp0[tid] = p0;
      gn[tid] = __ldg(a.offsets + g0 + tid + 1) - p0;
      grid[tid] = __ldg(a.rel_id + __ldg(a.order + p0));
    }
    __syncthreads();

    // the first group's tiles and queries, and the second's raw matrix,
    // staged before the loop
    copy_m(a, raw, grid[0], tid, THREADS);
    copy_queries(a, S, 0, gp0[0], gn[0], tid, THREADS);
    cp_async_commit();
#pragma unroll
    for (int ks = 0; ks < NK; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + g8 + 8 * (e & 1);
        const int k = 8 * ks + t4 + 4 * (e >> 1);
        const float x = r < a.E && k < a.d ? __ldg(a.ent + (size_t)r * a.d + k) : 0.0f;
        tf32x3::split(x, ah[ks][e], al[ks][e]);
      }
    cp_async_wait<0>();
    __syncthreads();
    split_m(raw, sb, a.d, tid, THREADS, 0, SPLIT_ITEMS);
    fence_proxy_async();
    __syncthreads();
    if (ng > 1) copy_m(a, raw, grid[1], tid, THREADS);
    cp_async_commit();

    for (int g = 0; g < ng; ++g) {
      const int b = g & 1;
      // (A) M_(g+1) raw and group g's queries have landed (copied by
      // warpgroup 0); group g's tiles are split; every warp is done with
      // group g - 1
      cp_async_wait<0>();
      __syncthreads();
      // warpgroup 1 splits the first part of M_(g+1) while warpgroup 0's
      // products run, and warpgroup 0 the rest while warpgroup 1's run
      float* next = sb + (b ^ 1) * 2 * TILE;
      const int wg = warp >> 2, wt = tid & 127;
      const bool more = g + 1 < ng;
      if (wg == 1 && more) {
        split_m(raw, next, a.d, wt, 128, 0, SPLIT_FIRST);
        fence_proxy_async();
        split_arrive();
      }
      const float* hi = sb + b * 2 * TILE;
      const uint64_t dh = make_desc(hi, 4 * SBO), dl = make_desc(hi + TILE, 4 * SBO);
      wgmma_fence();
      wgmma_tf32<true>(acc, al[0], dh);
#pragma unroll
      for (int ks = 0; ks < NK; ++ks) {
        const uint64_t off = (uint64_t)(ks * 2 * 128) >> 4;  // two core matrices a k-step
        if (ks > 0) wgmma_tf32<false>(acc, al[ks], dh + off);
        wgmma_tf32<false>(acc, ah[ks], dl + off);
        wgmma_tf32<false>(acc, ah[ks], dh + off);
      }
      wgmma_commit();
      if (wg == 0 && more) {
        // the rest of the split, then (raw read by both parts) the copies
        split_m(raw, next, a.d, wt, 128, SPLIT_FIRST, SPLIT_ITEMS);
        fence_proxy_async();
        split_wait();
        if (g + 2 < ng) copy_m(a, raw, grid[g + 2], wt, 128);
        copy_queries(a, S, b ^ 1, gp0[g + 1], gn[g + 1], wt, 128);
        cp_async_commit();
      }
      wgmma_wait0();
      fence_acc(acc);

      // the L1 sums of this thread's two rows against each query, over its
      // columns 8 i + 2 t4 (+1); four lanes make a row
      const int p0 = gp0[g], n = gn[g], sl = b;
      for (int j = 0; j < n; ++j) {
        const bool staged = j < QH;
        const float* q = staged ? S.q + (sl * QH + j) * DP : a.qp + (size_t)(p0 + j) * DP;
        float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // [row][column parity]
#pragma unroll
        for (int i = 0; i < NK; ++i) {
          const int col = 8 * i + 2 * t4;
          const float2 qv = staged ? *reinterpret_cast<const float2*>(q + col)
                                   : __ldcg(reinterpret_cast<const float2*>(q + col));
          s[0][0] = l1_term(s[0][0], qv.x, acc[4 * i]);
          s[0][1] = l1_term(s[0][1], qv.y, acc[4 * i + 1]);
          s[1][0] = l1_term(s[1][0], qv.x, acc[4 * i + 2]);
          s[1][1] = l1_term(s[1][1], qv.y, acc[4 * i + 3]);
        }
        float s0 = s[0][0] + s[0][1], s1 = s[1][0] + s[1][1];
        s0 += __shfl_xor_sync(FULL, s0, 1);
        s1 += __shfl_xor_sync(FULL, s1, 1);
        s0 += __shfl_xor_sync(FULL, s0, 2);
        s1 += __shfl_xor_sync(FULL, s1, 2);
        const float gj = staged ? S.gold[sl * QH + j] : __ldcg(a.gold + p0 + j);
        const int row = staged ? S.row[sl * QH + j] : __ldg(a.order + p0 + j);
        const int* fs = staged && a.F <= FS ? S.filt + (sl * QH + j) * FS : nullptr;
        const int e0 = row0 + g8, e1 = e0 + 8;
        int beat = 0;
        if (t4 == 0) {
          beat += e0 < a.E && -s0 > gj && !listed(a, fs, row, e0);
          beat += e1 < a.E && -s1 > gj && !listed(a, fs, row, e1);
        }
#pragma unroll
        for (int o = 4; o < 32; o *= 2) beat += __shfl_xor_sync(FULL, beat, o);
        if (lane == 0 && beat) atomicAdd(a.out + row, beat);
      }
    }
  }
}

// Blocks resident on `device` at once, worked out on the first launch there.
static int resident_blocks(int device, int* blocks) {
  static std::mutex mu;
  static int cached[64];  // 0: not yet known
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(mu);
  if (!cached[device]) {
    if (SMEM > (size_t)triple_score::max_dynamic_smem(device)) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(projected_rank_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, projected_rank_kernel, THREADS,
                                                        SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached[device] = per_sm * sms;
  }
  *blocks = cached[device];
  return 0;
}

}  // namespace projected

// `scratch` holds B * (2 * 104 + 1) floats; `counters` two zeroed words.
extern "C" int triple_score_projected_ranks(const void* ent, const void* proj, const void* rel,
                                            const void* fixed, const void* gold_id,
                                            const void* rel_id, const void* filt,
                                            const void* order, const void* offsets,
                                            void* scratch, void* counters, void* out, int B,
                                            int E, int d, int F, int side, int device,
                                            void* stream) {
  using namespace projected;
  if (B <= 0 || E <= 0) return 0;
  if (d <= 0 || d > DP || F <= 0) return (int)cudaErrorInvalidValue;
  auto sc = static_cast<float*>(scratch);
  Args a{static_cast<const float*>(ent), static_cast<const float*>(proj),
         static_cast<const float*>(rel), static_cast<const int*>(fixed),
         static_cast<const int*>(gold_id), static_cast<const int*>(rel_id),
         static_cast<const int*>(filt), static_cast<const int*>(order),
         static_cast<const int*>(offsets), sc, sc + (size_t)B * DP, sc + (size_t)2 * B * DP,
         static_cast<unsigned*>(counters), static_cast<int*>(counters) + 1,
         static_cast<int*>(out), B, E, d, F, side ? -1.0f : 1.0f,
         (reinterpret_cast<uintptr_t>(proj) & 15) == 0 && d % 4 == 0};
  return triple_score::on_device(device, [&]() -> int {
    int blocks = 0;
    const int rc = resident_blocks(device, &blocks);
    if (rc) return rc;
    void* args[] = {&a};
    return (int)cudaLaunchCooperativeKernel((const void*)projected_rank_kernel, dim3(blocks),
                                            dim3(THREADS), args, SMEM,
                                            static_cast<cudaStream_t>(stream));
  });
}

extern "C" const char* triple_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
