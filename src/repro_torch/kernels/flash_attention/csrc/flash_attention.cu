// Blocked online-softmax attention (flash attention, forward) on Hopper.
//
// Replaces the JAX package's kernels/flash_attention/flash_attention.py::
// flash_attention_fwd / _attn_kernel (Pallas, TPU): for q (B, H, S, Dh) and
// k, v (B, KV, T, Dh), out[b, h, s] = softmax_t(q_s · k_t · scale) v_t over
// the visible keys, with GQA (KV head h / (H / KV)), causal (k <= q) and
// sliding-window (q - k < window) masks, keys past T masked, fp32 running
// max, denominator and accumulator, masked scores at -1e30, p = 0 for a row
// whose max is still -1e30, and a final divide by max(l, 1e-30).
//
// The Pallas kernel walks a sequential (b, h, q-block, k-block) grid with the
// running state in VMEM scratch, and needs S and T to be block multiples.
// Here one block of 256 threads owns a 64-row query tile of one (b, h) and
// loops over 64-key tiles itself, keeping m, l and the accumulator in
// registers; nothing is split over keys, so there are no atomics. Tiles wholly
// above the diagonal or behind the window are not visited; the ragged edges
// of S and T are masked in the kernel, with no padding copies.
//
// Layout: q, k, v and out are read and written through their (b, h, s)
// strides with a contiguous last dimension, so the model's (B, S, H, Dh)
// projections need no transposed copy. fp32 and bf16 inputs are converted at
// load; all math is fp32 (expf, not __expf: the card check holds the kernel to
// its plain version within 1e-5 at fp32); the output is in the input dtype.
//
// Per key tile: the 64 x 64 score tile S = Q K^T from a 64 x Dh Q tile and a
// 64 x Dh K tile in shared memory (each thread a 4 x 4 register tile: rows
// ty + 16 i, columns tx + 16 j, operands as float4 rows, row stride Dh + 4 so
// the 16 column threads hit distinct banks), the row max and sum over the 16
// threads of a row by warp shuffles, then P (64 x 64, shared) times the V
// tile, which reuses the K tile's shared memory. Shared memory at Dh = 128:
// Q 33.8 KB + K/V 33.8 KB + P 17.4 KB = 85 KB, dynamic, two blocks per SM.
//
// What bounds it: the arithmetic. At qwen3-0.6b's prefill (S = 2048, H = 16,
// Dh = 128, causal) one call does 1.7e10 fp32 FLOP (0.26 ms at the card's 67
// TFLOP/s outside the tensor cores) and moves 50 MB (0.015 ms). No tensor
// cores in this version: a TF32 product would not stay within 1e-5 of the
// fp32 plain version; a bf16 wgmma design is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace fa {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16: thread (ty, tx)
constexpr int LDP = BK + 4;   // row stride of the P tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qb, qh, qs;  // strides (elements) of b, h, s; the last dim is contiguous
  long long kb, kh, ks;
  long long vb, vh, vs;
  long long ob, oh, os;
  int S, T, group;       // group = H / KV
  int causal, window;
  float scale;
};

// Each thread owns accumulator columns g * 16 * CW + CW * tx + w (g < NG,
// w < CW): CW contiguous floats, so a row of the V tile is read as float4
// (Dh >= 64) or float2 (Dh = 32) without bank conflicts.
template <int DH>
struct Cols {
  static constexpr int CW = DH >= 64 ? 4 : DH / 16;
  static constexpr int NG = DH / (16 * CW);
  static constexpr int N = CW * NG;
};

template <int CW>
__device__ __forceinline__ void load_cw(const float* p, float* out) {
  if constexpr (CW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (CW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = p[0];
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + BK) * (DH + 4) + (size_t)BQ * LDP);
}

// Stage rows [r0, r0 + 64) of a (rows, DH) matrix with row stride `ld` into
// `dst` (row stride DH + 4), zeros past `rows`.
template <int DH, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ld, int r0, int rows,
                                      int tid) {
  constexpr int LD = DH + 4;
  for (int i = tid; i < 64 * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    const int g = r0 + r;
    dst[r * LD + d] = g < rows ? to_f(src[(long long)g * ld + d]) : 0.0f;
  }
}

template <int DH, typename T>
__global__ void __launch_bounds__(THREADS, 2) attn_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = DH + 4;
  using C = Cols<DH>;
  float* qs = smem;             // [BQ][LD]
  float* kv = qs + BQ * LD;     // [BK][LD]: the K tile, then the V tile
  float* ps = kv + BK * LD;     // [BQ][LDP]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const T* qg = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* kg = static_cast<const T*>(p.k) + b * p.kb + hk * p.kh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vb + hk * p.vh;

  stage<DH, T>(qs, qg, p.qs, q0, p.S, tid);

  float m[4], l[4], acc[4][C::N];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < C::N; ++c) acc[i][c] = 0.0f;
  }

  // key tiles that hold a visible key for some row of this query tile
  int k_hi = p.T;
  if (p.causal) k_hi = min(k_hi, q0 + BQ);
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1) / BK * BK;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's V reads (and the Q staging) are done
    stage<DH, T>(kv, kg, p.ks, k0, p.T, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = *reinterpret_cast<const float4*>(&kv[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // mask, online softmax; the 16 threads of a row share m, l by shuffles
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < p.T && (!p.causal || kpos <= qpos) &&
                        (p.window <= 0 || qpos - kpos < p.window);
        s[i][j] = ok ? s[i][j] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = m_new == NEG_INF ? 0.0f : expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      sum = row_sum16(sum);
      const float alpha = m[i] == NEG_INF ? 0.0f : expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C::N; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done with the K tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
    stage<DH, T>(kv, vg, p.vs, k0, p.T, tid);
    __syncthreads();

#pragma unroll 2
    for (int t = 0; t < BK; t += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = *reinterpret_cast<const float4*>(&ps[(ty + 16 * i) * LDP + t]);
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        float vv[C::N];
#pragma unroll
        for (int g = 0; g < C::NG; ++g)
          load_cw<C::CW>(&kv[(t + tt) * LD + g * 16 * C::CW + C::CW * tx], &vv[g * C::CW]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = tt == 0 ? pa[i].x : tt == 1 ? pa[i].y : tt == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int c = 0; c < C::N; ++c) acc[i][c] = fmaf(pv, vv[c], acc[i][c]);
        }
      }
    }
  }

  T* og = static_cast<T*>(p.o) + b * p.ob + h * p.oh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s_ = q0 + ty + 16 * i;
    if (s_ >= p.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = og + (long long)s_ * p.os;
#pragma unroll
    for (int g = 0; g < C::NG; ++g)
#pragma unroll
      for (int w = 0; w < C::CW; ++w)
        store(&orow[g * 16 * C::CW + C::CW * tx + w], acc[i][g * C::CW + w] / denom);
  }
}

template <int DH, typename T>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(attn_kernel<DH, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.S + BQ - 1) / BQ, H, B);
  attn_kernel<DH, T><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int B, int H, int dh, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<32, T>(p, B, H, stream);
    case 64: return launch<64, T>(p, B, H, stream);
    case 128: return launch<128, T>(p, B, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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

}  // namespace fa

// dtype: 0 = float32, 1 = bfloat16. Strides in elements, (b, h, s) of q, k,
// v and out in that order; every last dimension is contiguous.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int KV, int S, int T, int Dh, long long qb,
                                   long long qh, long long qs, long long kb, long long kh,
                                   long long ks, long long vb, long long vh, long long vs,
                                   long long ob, long long oh, long long os, int causal,
                                   int window, float scale, int dtype, int device,
                                   void* stream) {
  using namespace fa;
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV || T < 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os,
           S, T, H / KV, causal, window, scale};
  return on_device(device, [&]() -> int {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch<float>(p, B, H, Dh, st);
    if (dtype == 1) return dispatch<__nv_bfloat16>(p, B, H, Dh, st);
    return (int)cudaErrorInvalidValue;
  });
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
