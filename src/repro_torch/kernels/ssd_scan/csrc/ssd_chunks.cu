// Mamba2 SSD intra-chunk kernel on Hopper's tensor cores.
//
// Replaces the JAX package's kernels/ssd_scan/ssd_scan.py::ssd_chunks_fwd /
// _ssd_chunk_kernel (Pallas, TPU). Per (batch b, head h, chunk c) of Q
// positions, with da_t = dt_t * a_h and cum the inclusive cumulative sum of
// da over the chunk:
//     y_intra[s]  = sum_{t <= s} (C_s . B_t) * exp(cum_s - cum_t) * dt_t * x_t    (Q, P)
//     state[p, n] = sum_t x_t[p] * (exp(cum_{Q-1} - cum_t) * dt_t) * B_t[n]        (P, N)
//     decay[s]    = exp(cum_s)                                                    (Q,)
// with one group: B and C are shared by all heads. The inter-chunk recurrence
// stays outside, in ops.py, as the JAX wrapper's lax.scan does.
//
// Design. A block owns one chunk of one batch row and a group of G heads
// (grid: head group, chunk, batch; the wrapper picks G from the card's SM
// count so that the grid fills it in as few waves as it can, and the last
// group of a head count that G does not divide is shorter). C B^T does not
// depend on the head, so the block forms it once for its G heads:
//   1. dt of the G heads is staged, and thread g sums head g's cum, left to
//      right with __fmul_rn / __fadd_rn -- the order and rounding of the
//      plain version's sequential cumsum: at the full card cum reaches about
//      -1e3 within a chunk, where any other order would move exp(cum_s -
//      cum_t) by ~1e-3 relative. exp(cum) goes out as the decay.
//   2. For each 64-row tile of s, and each band of at most 256 columns of
//      t <= s (one band for chunks up to 256): the band of S = C_s B_t^T
//      (warp tiles wholly above the diagonal are skipped) goes to shared
//      memory once. Then, head by head, W = S * exp(cum_s - cum_t) * dt_t is
//      formed in registers as the A operand of y += W x, exp only where
//      t <= s (for t > s it would overflow, and inf * 0 is NaN). Warps split
//      the tile's rows four ways and its t columns two ways, so every W
//      element is formed once; the two halves are added through shared
//      memory. Chunks longer than 256 add each band into y in place.
//   3. Head by head, state = (x * decay_end)^T B over the chunk.
// Products: split TF32 (include/split_tf32.cuh) on mma.sync.m16n8k8: each
// fp32 product is lo.hi + hi.lo + hi.hi of TF32 values, summed in fp32, so
// the outputs keep fp32 accuracy (tests/test_torch_tf32_split.py emulates
// this kernel's three products on one mamba2-2.7b chunk: within 1e-5 of the
// plain output's largest magnitude, where one TF32 product is not). Operands
// are split per fragment, in registers, by rounding their bit patterns with
// integer adds (split_bits); each warp forms all its W values of a tile
// before its products, and issues the three products of all its n-tiles
// pass by pass. Splitting each x and B tile once per block in shared memory
// measured slower (an extra pass and barrier per tile). W's exponential is
// __expf of the difference cum_s - cum_t (which is exact to a few ulp): its
// error, relative and ~1e-6 at most where W matters, stays under the 1e-5
// check. x, B and C tiles are staged by 16-byte cp.async copies through two
// buffers, zero-filled past Q and N, the x tiles of all of a block's heads
// as one sequence (the next head's first tile is copied during the last
// tile of the head before); the wrapper copies views whose pointer or
// strides are not 16-byte aligned, and pads rows of B and C whose length N
// is not a multiple of 4.
//
// What bounds it: at mamba2-2.7b's prefill (B = 1, S = 2,048, H = 80, P =
// 64, N = 128, Q = 256; 8 chunks) the function needs 5.45e9 FLOP with C B^T
// once per chunk over the triangle (0.0813 ms on the fp32 pipes at 67
// TFLOP/s; 0.033 ms as split TF32, three TF32 products at 495 TFLOP/s) and
// moves 108 MB (0.032 ms at 3.35 TB/s). This design forms C B^T once per
// head group: 5.45e9 + (80 / G - 1) * 8 * 8.4e6 FLOP, 6.46e9 at G = 5 (the
// previous design formed it per head: 1.1e10). One block of 8 warps an SM
// (the shared memory of the S band and staging), in one wave at G = 5; the
// measured time is ~0.3 ms (PERF.md): the warps wait on shared-memory and
// tensor-core latencies more than they issue.
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_tf32.cuh"

namespace ssd {

using namespace tf32x3;

constexpr int TS = 64;        // rows of s (and t) per tile
constexpr int BAND = 256;     // t columns of S kept in shared memory at once
constexpr int NK = 32;        // N-chunk staged per step of the C B^T product
constexpr int NW = 128;       // N columns of the state per pass
constexpr int THREADS = 256;  // 8 warps
constexpr int LDS = BAND + 4; // row stride of the S band
constexpr int LDK = NK + 4;   // row stride of the staged C and B chunks
constexpr int LDB = NW + 8;   // row stride of the state's B tile
// shared memory a block may opt in to on Hopper (227 KB)
constexpr size_t SMEM_LIMIT = 232448;

struct Params {
  const float* x;
  const float* dt;
  const float* a;
  const float* bm;
  const float* cm;
  float* y;
  float* state;
  float* decay;
  int H, NC, Q, N, G;
  long long xb, xh, xc, xq;     // strides (elements); each last dim is contiguous
  long long db, dh, dc, dq;     // dt
  long long bb, bc, bq;         // B
  long long cb, cc, cq;         // C
  long long yb, yh, yc, yq;     // y_intra
  long long eb, eh, ec, eq;     // decay
};

template <int P>
struct Layout {
  static constexpr int LDX = P + 8;                  // row stride of an x tile
  static constexpr int XT = TS * LDX;                // one x tile
  static constexpr int SB = TS * LDS;                // the S band
  static constexpr int STG = 2 * 2 * TS * LDK;       // C and B chunks, two buffers
  static constexpr int RED = 4 * (P / 8) * 4 * 32;   // the second t half's partial y
  static_assert(RED <= STG, "the partial y takes the C/B staging's place");
  static constexpr int Y_PHASE = SB + STG + 2 * XT;
  static constexpr int STATE_PHASE = 2 * XT + 2 * TS * LDB;
  static constexpr int MAIN = Y_PHASE > STATE_PHASE ? Y_PHASE : STATE_PHASE;
};

template <int P>
constexpr size_t smem_floats(int G, int Q) {
  return (size_t)Layout<P>::MAIN + (size_t)(2 * G + 1) * Q;
}

// D_i += A B_i for NT n-tiles sharing one A fragment, each in three TF32
// products (lo.hi, hi.lo, hi.hi, as mma3), issued pass by pass across the
// tiles so that no product waits on the one before it.
template <int NT>
__device__ __forceinline__ void mma3_tiles(float (&d)[NT][4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[NT][2],
                                           const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) mma(d[i], al, bh[i]);
#pragma unroll
  for (int i = 0; i < NT; ++i) mma(d[i], ah, bl[i]);
#pragma unroll
  for (int i = 0; i < NT; ++i) mma(d[i], ah, bh[i]);
}

// Stage rows [r0, r0 + TS) x columns [k0, k0 + width) of a row-major matrix
// (row stride ld elements, rows < nrows and columns < ncols valid, the rest
// zero) into dst (row stride lds), by 16-byte copies. width % 4 == 0.
__device__ __forceinline__ void stage(float* dst, int lds, const float* src, long long ld,
                                      int r0, int nrows, int k0, int width, int ncols,
                                      int tid) {
  const int per_row = width / 4;
  for (int e = tid; e < TS * per_row; e += THREADS) {
    const int r = e / per_row, k = 4 * (e - r * per_row);
    const bool ok = r0 + r < nrows && k0 + k < ncols;
    const float* g = ok ? src + (long long)(r0 + r) * ld + k0 + k : src;
    cp_async16(dst + r * lds + k, g, ok);
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS, 1) ssd_chunk_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  using L = Layout<P>;
  constexpr int NT = P / 8;  // n-tiles of y's P columns
  float* sband = smem;                 // [TS][LDS]
  float* stg = sband + L::SB;          // C, B chunks [2][2][TS][LDK]; the partial y
  float* xt = stg + L::STG;            // x tiles [2][TS][LDX]
  float* sx = smem;                    // state phase: x tiles [2][TS][LDX]
  float* sbt = smem + 2 * L::XT;       // state phase: B tiles [2][TS][LDB]
  const int Q = p.Q, N = p.N, G = p.G;
  float* cum = smem + L::MAIN;         // [G][Q]
  float* dts = cum + (size_t)G * Q;    // [G][Q]
  float* de = dts + (size_t)G * Q;     // [Q]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row and column of the lane
  const int h0 = blockIdx.x * G, c = blockIdx.y, b = blockIdx.z;
  const int ng = min(G, p.H - h0);
  const float* bg = p.bm + b * p.bb + c * p.bc;
  const float* cg = p.cm + b * p.cb + c * p.cc;

  // ---- 1. dt, cum (one thread per head, in order), decay = exp(cum)
  for (int e = tid; e < ng * Q; e += THREADS) {
    const int g = e / Q, t = e - g * Q;
    dts[e] = p.dt[b * p.db + (h0 + g) * p.dh + c * p.dc + (long long)t * p.dq];
  }
  __syncthreads();
  if (tid < ng) {  // eight dt at a time in flight, the sum still one by one
    const float a = p.a[h0 + tid];
    const float* dg = dts + tid * Q;
    float* cs = cum + tid * Q;
    float run = 0.0f;
    int t = 0;
    for (; t + 8 <= Q; t += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = dg[t + u];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        run = __fadd_rn(run, __fmul_rn(v[u], a));
        cs[t + u] = run;
      }
    }
    for (; t < Q; ++t) {
      run = __fadd_rn(run, __fmul_rn(dg[t], a));
      cs[t] = run;
    }
  }
  __syncthreads();
  for (int e = tid; e < ng * Q; e += THREADS) {
    const int g = e / Q, t = e - g * Q;
    p.decay[b * p.eb + (h0 + g) * p.eh + c * p.ec + (long long)t * p.eq] = expf(cum[e]);
  }

  // ---- 2. y_intra: 64-row tiles of s, bands of t <= s
  const int rg = warp & 3;   // 16-row group of the tile
  const int kh = warp >> 2;  // S: 32-column half of a t tile; W x: 32-column half of t
  for (int s0 = 0; s0 < Q; s0 += TS) {
    const int tend = min(s0 + TS, Q);
    const int srow = s0 + 16 * rg + gq;  // this lane's rows: srow and srow + 8
    for (int tb = 0; tb < tend; tb += BAND) {
      const int ntile = (min(BAND, tend - tb) + TS - 1) / TS;
      // -- S band = C[s0, s0 + 64) . B[tb, tb + 64 ntile)^T, k over N in NK chunks
      const int nkc = (N + NK - 1) / NK;
      const int nsteps = ntile * nkc;
      auto issue_s = [&](int st) {
        const int j = st / nkc, k0 = (st - j * nkc) * NK;
        float* buf = stg + (st & 1) * 2 * TS * LDK;
        stage(buf, LDK, cg, p.cq, s0, Q, k0, NK, N, tid);
        stage(buf + TS * LDK, LDK, bg, p.bq, tb + TS * j, Q, k0, NK, N, tid);
        cp_async_commit();
      };
      float sacc[4][4];
      issue_s(0);
      for (int st = 0; st < nsteps; ++st) {
        const int j = st / nkc, kc = st - j * nkc;
        if (st + 1 < nsteps) {
          issue_s(st + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (kc == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int r = 0; r < 4; ++r) sacc[i][r] = 0.0f;
        }
        // warp tile: rows 16 rg, t columns 32 kh of tile j; skip it above the diagonal
        const bool live = tb + TS * j + 32 * kh <= s0 + 16 * rg + 15;
        if (live) {
          const float* cs = stg + (st & 1) * 2 * TS * LDK;
          const float* bs = cs + TS * LDK;
#pragma unroll
          for (int k0 = 0; k0 < NK; k0 += 8) {
            uint32_t ah[4], al[4], bh[4][2], bl[4][2];
            const float* ar = cs + (16 * rg + gq) * LDK + k0 + tq;
            split_bits(ar[0], ah[0], al[0]);
            split_bits(ar[8 * LDK], ah[1], al[1]);
            split_bits(ar[4], ah[2], al[2]);
            split_bits(ar[8 * LDK + 4], ah[3], al[3]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float* br = bs + (32 * kh + 8 * i + gq) * LDK + k0 + tq;
              split_bits(br[0], bh[i][0], bl[i][0]);
              split_bits(br[4], bh[i][1], bl[i][1]);
            }
            mma3_tiles<4>(sacc, ah, al, bh, bl);
          }
        }
        if (kc == nkc - 1 && live) {  // the tile's S goes to the band
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* o = sband + (16 * rg + gq) * LDS + TS * j + 32 * kh + 8 * i + 2 * tq;
            *reinterpret_cast<float2*>(o) = make_float2(sacc[i][0], sacc[i][1]);
            *reinterpret_cast<float2*>(o + 8 * LDS) = make_float2(sacc[i][2], sacc[i][3]);
          }
        }
        __syncthreads();
      }

      // -- per head: y[s0 tile] += W x over the band. The x tiles of all the
      // heads go through the two buffers as one sequence (item q: head
      // q / ntile, tile q % ntile), the next head's first copied meanwhile.
      const int nitems = ng * ntile;
      auto issue_x = [&](int q) {
        const int hq = h0 + q / ntile, jq = q % ntile;
        stage(xt + (q & 1) * L::XT, L::LDX, p.x + b * p.xb + hq * p.xh + c * p.xc, p.xq,
              tb + TS * jq, Q, 0, P, P, tid);
        cp_async_commit();
      };
      issue_x(0);
      for (int g = 0; g < ng; ++g) {
        const int h = h0 + g;
        const float* cumg = cum + g * Q;
        const float* dtg = dts + g * Q;
        const float cs0 = srow < Q ? cumg[srow] : 0.0f;
        const float cs1 = srow + 8 < Q ? cumg[srow + 8] : 0.0f;
        float acc[NT][4];
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][r] = 0.0f;
        for (int j = 0; j < ntile; ++j) {
          const int q = g * ntile + j;
          if (q + 1 < nitems) {
            issue_x(q + 1);
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
          const int t0 = tb + TS * j + 32 * kh;  // this warp's 32 columns of t
          if (t0 <= s0 + 16 * rg + 15) {
            const float* xs = xt + (q & 1) * L::XT + 32 * kh * L::LDX;
            const float* sr = sband + (16 * rg + gq) * LDS + TS * j + 32 * kh;
            // W over the warp's 16 rows and 32 columns first: 16 independent
            // values a lane, a0..a3 of each k-step at (g, t) (g+8, t) (g, t+4) (g+8, t+4)
            uint32_t wh[4][4], wl[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r8 = (e & 1) * 8, col = 8 * kk + tq + (e >> 1) * 4;
                const int s = srow + r8, t = t0 + col;
                float w = 0.0f;
                if (t <= s && s < Q)  // exp of cum_s - cum_t only where it is <= 0
                  w = __fmul_rn(
                      __fmul_rn(sr[r8 * LDS + col], __expf((r8 ? cs1 : cs0) - cumg[t])), dtg[t]);
                split_bits(w, wh[kk][e], wl[kk][e]);
              }
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float* xr = xs + (8 * kk + tq) * L::LDX + gq;
              uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
              for (int i = 0; i < NT; ++i) {
                split_bits(xr[8 * i], bh[i][0], bl[i][0]);
                split_bits(xr[4 * L::LDX + 8 * i], bh[i][1], bl[i][1]);
              }
              mma3_tiles<NT>(acc, wh[kk], wl[kk], bh, bl);
            }
          }
          __syncthreads();
        }
        // the second t half's partial sums go through shared memory to the first
        float* red = stg + (size_t)rg * NT * 4 * 32;
        if (kh == 1) {
#pragma unroll
          for (int i = 0; i < NT; ++i)
#pragma unroll
            for (int r = 0; r < 4; ++r) red[(i * 4 + r) * 32 + lane] = acc[i][r];
        }
        __syncthreads();
        if (kh == 0) {
          float* yg = p.y + b * p.yb + h * p.yh + c * p.yc;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int s = srow + 8 * half;
            if (s >= Q) continue;
            float* yr = yg + (long long)s * p.yq + 2 * tq;
#pragma unroll
            for (int i = 0; i < NT; ++i) {
              float v0 = __fadd_rn(acc[i][2 * half], red[(i * 4 + 2 * half) * 32 + lane]);
              float v1 = __fadd_rn(acc[i][2 * half + 1], red[(i * 4 + 2 * half + 1) * 32 + lane]);
              float2* o = reinterpret_cast<float2*>(yr + 8 * i);
              if (tb > 0) {  // a later band of a long chunk adds to what the earlier ones wrote
                const float2 prev = *o;
                v0 = __fadd_rn(prev.x, v0);
                v1 = __fadd_rn(prev.y, v1);
              }
              *o = make_float2(v0, v1);
            }
          }
        }
        // the partial sums are read before the next head's are written
        __syncthreads();
      }
    }
  }

  // ---- 3. chunk state (P, N) = (x * decay_end)^T B, head by head
  constexpr int MT = P / 16;       // 16-row tiles of p
  constexpr int WN = 8 / MT;       // warps sharing one of them
  constexpr int NTW = NW / 8 / WN; // n-tiles of a warp in an NW-column pass
  const int mt = warp / WN, wn = warp - mt * WN;
  const int nt0 = wn * NTW;
  // the x and B tiles of all the heads' passes as one sequence through the
  // two buffers (item q: head, 128-column pass of N, tile of t)
  const int ntiles = (Q + TS - 1) / TS;
  const int per_head = (N + NW - 1) / NW * ntiles;
  auto issue = [&](int q) {
    const int hq = h0 + q / per_head, r = q % per_head;
    stage(sx + (q & 1) * L::XT, L::LDX, p.x + b * p.xb + hq * p.xh + c * p.xc, p.xq,
          TS * (r % ntiles), Q, 0, P, P, tid);
    stage(sbt + (q & 1) * TS * LDB, LDB, bg, p.bq, TS * (r % ntiles), Q, NW * (r / ntiles), NW,
          N, tid);
    cp_async_commit();
  };
  issue(0);
  for (int g = 0; g < ng; ++g) {
    const int h = h0 + g;
    const float* cumg = cum + g * Q;
    const float* dtg = dts + g * Q;
    const float cum_end = cumg[Q - 1];
    for (int t = tid; t < Q; t += THREADS)  // the last item's products are done with de[]
      de[t] = __fmul_rn(expf(cum_end - cumg[t]), dtg[t]);
    float* sg = p.state + ((((long long)b * p.H + h) * p.NC + c) * P) * N;
    for (int n0 = 0; n0 < N; n0 += NW) {
      float acc[NTW][4];
#pragma unroll
      for (int i = 0; i < NTW; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][r] = 0.0f;
      for (int j = 0; j < ntiles; ++j) {
        const int q = g * per_head + n0 / NW * ntiles + j;
        if (q + 1 < ng * per_head) {
          issue(q + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // also orders de[] before its first use
        const float* xs = sx + (q & 1) * L::XT;
        const float* bs = sbt + (q & 1) * TS * LDB;
#pragma unroll 2
        for (int k0 = 0; k0 < TS; k0 += 8) {
          const int t = TS * j + k0 + tq;
          const float d0 = t < Q ? de[t] : 0.0f, d1 = t + 4 < Q ? de[t + 4] : 0.0f;
          const float* xr = xs + (k0 + tq) * L::LDX + 16 * mt + gq;
          uint32_t ah[4], al[4], bh[NTW][2], bl[NTW][2];
          split_bits(__fmul_rn(xr[0], d0), ah[0], al[0]);
          split_bits(__fmul_rn(xr[8], d0), ah[1], al[1]);
          split_bits(__fmul_rn(xr[4 * L::LDX], d1), ah[2], al[2]);
          split_bits(__fmul_rn(xr[4 * L::LDX + 8], d1), ah[3], al[3]);
#pragma unroll
          for (int i = 0; i < NTW; ++i) {  // columns past N are zero-filled in the tile
            const float* br = bs + (k0 + tq) * LDB + 8 * (nt0 + i) + gq;
            split_bits(br[0], bh[i][0], bl[i][0]);
            split_bits(br[4 * LDB], bh[i][1], bl[i][1]);
          }
          if (n0 + 8 * nt0 < N) mma3_tiles<NTW>(acc, ah, al, bh, bl);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        const int n = n0 + 8 * (nt0 + i) + 2 * tq;
        const int pr = 16 * mt + gq;
        if (n < N) {
          sg[(long long)pr * N + n] = acc[i][0];
          sg[(long long)(pr + 8) * N + n] = acc[i][2];
        }
        if (n + 1 < N) {
          sg[(long long)pr * N + n + 1] = acc[i][1];
          sg[(long long)(pr + 8) * N + n + 1] = acc[i][3];
        }
      }
    }
  }
}

template <int P>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<P>(p.G, p.Q);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.H + p.G - 1) / p.G, p.NC, B);
  ssd_chunk_kernel<P><<<grid, THREADS, smem, stream>>>(p);
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

}  // namespace ssd

// Shared memory (bytes) of one block for head dim P, G heads per block and
// chunk Q; 0 for a P the kernel is not built for.
extern "C" long long ssd_chunks_smem_bytes(int P, int G, int Q) {
  using namespace ssd;
  switch (P) {
    case 16: return (long long)(sizeof(float) * smem_floats<16>(G, Q));
    case 32: return (long long)(sizeof(float) * smem_floats<32>(G, Q));
    case 64: return (long long)(sizeof(float) * smem_floats<64>(G, Q));
    case 128: return (long long)(sizeof(float) * smem_floats<128>(G, Q));
    default: return 0;
  }
}

// x (B, H, NC, Q, P), dt (B, H, NC, Q), a (H,), B/C (B, NC, Q, N), y_intra
// (B, H, NC, Q, P) and decay (B, H, NC, Q) through their strides (elements;
// x, B, C and y with a contiguous last dim; x, B and C rows 16-byte aligned
// and readable up to a multiple of 4 columns), state (B, H, NC, P, N)
// contiguous. All float32. G heads per block.
extern "C" int ssd_chunks_fwd(const void* x, const void* dt, const void* a, const void* bm,
                              const void* cm, void* y, void* state, void* decay, int B, int H,
                              int NC, int Q, int P, int N, int G, long long xb, long long xh,
                              long long xc, long long xq, long long db, long long dh,
                              long long dc, long long dq, long long bb, long long bc,
                              long long bq, long long cb, long long cc, long long cq,
                              long long yb, long long yh, long long yc, long long yq,
                              long long eb, long long eh, long long ec, long long eq,
                              int device, void* stream) {
  using namespace ssd;
  if (B <= 0 || H <= 0 || NC <= 0) return 0;
  if (Q <= 0 || N <= 0 || G <= 0 || G > THREADS || NC > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const float*>(x), static_cast<const float*>(dt),
           static_cast<const float*>(a), static_cast<const float*>(bm),
           static_cast<const float*>(cm), static_cast<float*>(y), static_cast<float*>(state),
           static_cast<float*>(decay), H, NC, Q, N, G, xb, xh, xc, xq, db, dh, dc, dq, bb, bc,
           bq, cb, cc, cq, yb, yh, yc, yq, eb, eh, ec, eq};
  return on_device(device, [&]() -> int {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (P) {
      case 16: return launch<16>(p, B, st);
      case 32: return launch<32>(p, B, st);
      case 64: return launch<64>(p, B, st);
      case 128: return launch<128>(p, B, st);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

extern "C" const char* ssd_chunks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
