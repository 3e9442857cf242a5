// Mamba2 SSD intra-chunk kernel on Hopper.
//
// Replaces the JAX package's kernels/ssd_scan/ssd_scan.py::ssd_chunks_fwd /
// _ssd_chunk_kernel (Pallas, TPU). Per (batch b, head h, chunk c) of Q
// positions, with da_t = dt_t * a_h and cum the inclusive cumulative sum of
// da over the chunk:
//     y_intra[s]  = sum_{t <= s} (C_s . B_t) * exp(cum_s - cum_t) * dt_t * x_t    (Q, P)
//     state[p, n] = sum_t x_t[p] * (exp(cum_{Q-1} - cum_t) * dt_t) * B_t[n]        (P, N)
//     decay[s]    = exp(cum_s)                                                    (Q,)
// with one group (B and C shared by all heads). The inter-chunk recurrence
// stays outside, in ops.py, as the JAX wrapper's lax.scan does.
//
// The Pallas kernel holds the whole (Q, Q) matrix in VMEM; at Q = 256 that is
// 256 KB in fp32, above the 227 KB a block may have here. So one block of 256
// threads walks 64-row tiles of s, and for each the 64-column tiles of t <= s
// (tiles above the diagonal are not visited): the 64 x 64 C B^T tile from
// 32-wide N-chunks of C and B rows staged in shared memory (each thread a 4 x 4
// register tile, rows ty + 16 i, columns tx + 16 j), weighted in registers and
// staged as W, then W times the x tile into a register accumulator. exp of
// cum_s - cum_t is only evaluated where t <= s: for t > s it would overflow,
// and inf * 0 is NaN.
//
// cum is summed by one thread, left to right, with __fmul_rn / __fadd_rn
// (no fused multiply-add), the same order and rounding as the plain version's
// sequential cumsum: at the full card cum reaches about -1e3 within a chunk,
// where cum_s - cum_t near the diagonal keeps only a few digits and any other
// summation order would move L by ~1e-3 relative.
//
// What bounds it: the arithmetic. At mamba2-2.7b's prefill (S = 2048, H = 80,
// P = 64, N = 128, Q = 256) the work that one call needs is 5.4e9 FLOP if
// C B^T is formed once per chunk for all heads (0.08 ms at the card's 67
// TFLOP/s fp32) and it moves 108 MB (0.03 ms). This version, like the Pallas
// kernel, forms C B^T again for every head: 1.1e10 FLOP.
#include <cuda_runtime.h>
#include <stdint.h>

namespace ssd {

constexpr int TS = 64;        // rows of s (and t) per tile
constexpr int NK = 32;        // N-chunk staged per step of the C B^T product
constexpr int THREADS = 256;  // 16 x 16: thread (ty, tx)
constexpr int LDN = NK + 4;   // row stride of the staged C and B chunks
constexpr int LDW = TS + 4;   // row stride of the W tile

struct Params {
  const float* x;
  const float* dt;
  const float* a;
  const float* bm;
  const float* cm;
  float* y;
  float* state;
  float* decay;
  int H, NC, Q, N;
  long long xb, xh, xc, xq;     // strides (elements); each last dim is contiguous
  long long db, dh, dc, dq;     // dt
  long long bb, bc, bq;         // B
  long long cb, cc, cq;         // C
  long long yb, yh, yc, yq;     // y_intra
  long long eb, eh, ec, eq;     // decay
};

// Accumulator columns of a thread: g * 16 * CW + CW * tx + w (g < NG, w < CW).
template <int P>
struct Cols {
  static constexpr int CW = P >= 64 ? 4 : P / 16;
  static constexpr int NG = P / (16 * CW);
  static constexpr int N = CW * NG;
};

template <int P>
constexpr size_t tile_floats() {
  // C and B chunks (reused as the 64 x 64 B tile of the state product), W, x
  return (size_t)2 * TS * LDN + (size_t)TS * LDW + (size_t)TS * P;
}

template <int P>
__global__ void __launch_bounds__(THREADS, 2) ssd_chunk_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  using C = Cols<P>;
  float* cs = smem;              // [TS][LDN]
  float* bs = cs + TS * LDN;     // [TS][LDN]
  float* bn = cs;                // [TS][TS], the state product's B tile (aliases cs, bs)
  float* ws = bs + TS * LDN;     // [TS][LDW]
  float* xs = ws + TS * LDW;     // [TS][P]
  float* cum = xs + TS * P;      // [Q]
  float* dts = cum + p.Q;        // [Q]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Q = p.Q, N = p.N;
  const float* xg = p.x + b * p.xb + h * p.xh + c * p.xc;
  const float* dtg = p.dt + b * p.db + h * p.dh + c * p.dc;
  const float* bg = p.bm + b * p.bb + c * p.bc;
  const float* cg = p.cm + b * p.cb + c * p.cc;
  const float a = p.a[h];

  for (int t = tid; t < Q; t += THREADS) dts[t] = dtg[(long long)t * p.dq];
  __syncthreads();
  if (tid == 0) {
    float run = 0.0f;
    for (int t = 0; t < Q; ++t) {
      run = __fadd_rn(run, __fmul_rn(dts[t], a));
      cum[t] = run;
    }
  }
  __syncthreads();
  {
    float* dg = p.decay + b * p.eb + h * p.eh + c * p.ec;
    for (int t = tid; t < Q; t += THREADS) dg[(long long)t * p.eq] = expf(cum[t]);
  }

  // ---- y_intra, one 64-row tile of s at a time
  float* yg = p.y + b * p.yb + h * p.yh + c * p.yc;
  for (int s0 = 0; s0 < Q; s0 += TS) {
    float acc[4][C::N];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < C::N; ++k) acc[i][k] = 0.0f;

    for (int t0 = 0; t0 <= s0; t0 += TS) {
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
      for (int n0 = 0; n0 < N; n0 += NK) {
        __syncthreads();
        for (int e = tid; e < TS * NK; e += THREADS) {
          const int r = e / NK, k = e % NK;
          const bool kin = n0 + k < N;
          cs[r * LDN + k] = (kin && s0 + r < Q) ? cg[(long long)(s0 + r) * p.cq + n0 + k] : 0.0f;
          bs[r * LDN + k] = (kin && t0 + r < Q) ? bg[(long long)(t0 + r) * p.bq + n0 + k] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < NK; k += 4) {
          float4 ca[4], ba[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) ca[i] = *reinterpret_cast<const float4*>(&cs[(ty + 16 * i) * LDN + k]);
#pragma unroll
          for (int j = 0; j < 4; ++j) ba[j] = *reinterpret_cast<const float4*>(&bs[(tx + 16 * j) * LDN + k]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              sc[i][j] = fmaf(ca[i].x, ba[j].x, sc[i][j]);
              sc[i][j] = fmaf(ca[i].y, ba[j].y, sc[i][j]);
              sc[i][j] = fmaf(ca[i].z, ba[j].z, sc[i][j]);
              sc[i][j] = fmaf(ca[i].w, ba[j].w, sc[i][j]);
            }
        }
      }
      __syncthreads();  // the previous W x product is done with ws and xs
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t0 + tx + 16 * j;
          float w = 0.0f;
          if (t <= s && s < Q)  // exp of cum_s - cum_t only where it is <= 0
            w = __fmul_rn(__fmul_rn(sc[i][j], expf(cum[s] - cum[t])), dts[t]);
          ws[(ty + 16 * i) * LDW + tx + 16 * j] = w;
        }
      }
      for (int e = tid; e < TS * P; e += THREADS) {
        const int r = e / P, k = e % P;
        xs[e] = t0 + r < Q ? xg[(long long)(t0 + r) * p.xq + k] : 0.0f;
      }
      __syncthreads();
#pragma unroll 2
      for (int t = 0; t < TS; t += 4) {
        float4 wa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wa[i] = *reinterpret_cast<const float4*>(&ws[(ty + 16 * i) * LDW + t]);
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
          float xv[C::N];
#pragma unroll
          for (int g = 0; g < C::NG; ++g)
#pragma unroll
            for (int w = 0; w < C::CW; ++w)
              xv[g * C::CW + w] = xs[(t + tt) * P + g * 16 * C::CW + C::CW * tx + w];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float wv = tt == 0 ? wa[i].x : tt == 1 ? wa[i].y : tt == 2 ? wa[i].z : wa[i].w;
#pragma unroll
            for (int k = 0; k < C::N; ++k) acc[i][k] = fmaf(wv, xv[k], acc[i][k]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + ty + 16 * i;
      if (s >= Q) continue;
      float* yrow = yg + (long long)s * p.yq;
#pragma unroll
      for (int g = 0; g < C::NG; ++g)
#pragma unroll
        for (int w = 0; w < C::CW; ++w)
          yrow[g * 16 * C::CW + C::CW * tx + w] = acc[i][g * C::CW + w];
    }
  }

  // ---- chunk state (P, N): thread rows p = ty + 16 i, columns n0 + 4 tx + w
  constexpr int PR = P / 16;
  const float cum_end = cum[Q - 1];
  float* sg = p.state + ((((long long)b * p.H + h) * p.NC + c) * P) * N;
  for (int n0 = 0; n0 < N; n0 += TS) {
    float st[PR][4];
#pragma unroll
    for (int i = 0; i < PR; ++i)
#pragma unroll
      for (int w = 0; w < 4; ++w) st[i][w] = 0.0f;
    for (int t0 = 0; t0 < Q; t0 += TS) {
      __syncthreads();
      for (int e = tid; e < TS * P; e += THREADS) {
        const int r = e / P, k = e % P;
        const int t = t0 + r;
        xs[e] = t < Q ? __fmul_rn(xg[(long long)t * p.xq + k],
                                  __fmul_rn(expf(cum_end - cum[t]), dts[t]))
                      : 0.0f;
      }
      for (int e = tid; e < TS * TS; e += THREADS) {
        const int r = e / TS, k = e % TS;
        bn[e] = (t0 + r < Q && n0 + k < N) ? bg[(long long)(t0 + r) * p.bq + n0 + k] : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int t = 0; t < TS; ++t) {
        const float4 bv = *reinterpret_cast<const float4*>(&bn[t * TS + 4 * tx]);
#pragma unroll
        for (int i = 0; i < PR; ++i) {
          const float xv = xs[t * P + ty + 16 * i];
          st[i][0] = fmaf(xv, bv.x, st[i][0]);
          st[i][1] = fmaf(xv, bv.y, st[i][1]);
          st[i][2] = fmaf(xv, bv.z, st[i][2]);
          st[i][3] = fmaf(xv, bv.w, st[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PR; ++i) {
      float* srow = sg + (long long)(ty + 16 * i) * N;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int n = n0 + 4 * tx + w;
        if (n < N) srow[n] = st[i][w];
      }
    }
  }
}

template <int P>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (tile_floats<P>() + 2 * (size_t)p.Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.NC, p.H, B);
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

// x (B, H, NC, Q, P), dt (B, H, NC, Q), a (H,), B/C (B, NC, Q, N), y_intra
// (B, H, NC, Q, P) and decay (B, H, NC, Q) through their strides (elements;
// x, B, C and y with a contiguous last dim), state (B, H, NC, P, N)
// contiguous. All float32.
extern "C" int ssd_chunks_fwd(const void* x, const void* dt, const void* a, const void* bm,
                              const void* cm, void* y, void* state, void* decay, int B, int H,
                              int NC, int Q, int P, int N, long long xb, long long xh,
                              long long xc, long long xq, long long db, long long dh,
                              long long dc, long long dq, long long bb, long long bc,
                              long long bq, long long cb, long long cc, long long cq,
                              long long yb, long long yh, long long yc, long long yq,
                              long long eb, long long eh, long long ec, long long eq,
                              int device, void* stream) {
  using namespace ssd;
  if (B <= 0 || H <= 0 || NC <= 0) return 0;
  if (Q <= 0 || N < 0 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  Params p{static_cast<const float*>(x), static_cast<const float*>(dt),
           static_cast<const float*>(a), static_cast<const float*>(bm),
           static_cast<const float*>(cm), static_cast<float*>(y), static_cast<float*>(state),
           static_cast<float*>(decay), H, NC, Q, N, xb, xh, xc, xq, db, dh, dc, dq, bb, bc, bq,
           cb, cc, cq, yb, yh, yc, yq, eb, eh, ec, eq};
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
