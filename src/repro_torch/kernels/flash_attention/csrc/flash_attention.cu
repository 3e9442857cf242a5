// Blocked online-softmax attention (flash attention, forward) on Hopper's
// tensor cores.
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
// Here one block of 8 warps owns a 128-row query tile of one (b, h), each
// warp 16 rows (FlashAttention-2's split: no state is shared between warps),
// and loops over 64-key tiles itself, keeping m, l and the accumulator in
// registers. Tiles wholly above the diagonal or behind the window are not
// visited, by the block or, within a visited tile, by a warp none of whose
// rows sees a key of it; the ragged edges of S and T are zero-filled by the
// copies and masked, with no padding in device memory. Blocks start
// longest-first (the last query tiles see the most keys under the causal
// mask).
//
// Products: split TF32 (include/split_tf32.cuh) on mma.sync.m16n8k8. S = Q Kᵀ
// and O += P V are each lo·hi + hi·lo + hi·hi, accumulated in fp32, so the
// output keeps fp32 accuracy: a CPU emulation of the scheme holds the card
// check's 1e-5 on causal and windowed attention where one TF32 product breaks
// it (tests/test_torch_tf32_split.py). Where scores reach ~50 (qk-norm off),
// fp32 itself is more than 1e-5 from the truth, and the kernel is held to
// twice fp32's distance. bf16 inputs are exact in TF32 (lo = 0), so for bf16
// the kernel skips the products of Q's, K's and V's lo parts: Q Kᵀ is one
// product, and P V two (P, computed in fp32, is still split; as 0 <= p <= 1,
// its split needs no clamp against overflow).
//
// Layout of the products. Q's fragments are loaded once into registers. The
// scores' accumulator fragment (row g, keys 2t and 2t+1 of each 8-key tile)
// is reused as the A operand of P V by numbering the keys of each 8-key step
// as 2t -> t, 2t+1 -> t+4, and loading V's B fragment in the same order
// (rows 2t and 2t+1): P never leaves registers. K (T, Dh) is already K-major
// for Q Kᵀ; V (T, Dh) is read as B[t][n] = V[t][n] straight from its staged
// rows, which is why this is mma.sync and not wgmma (wgmma's tf32 form takes
// only K-major B from shared memory: V would need a transposing copy, and
// the split, which has to be formed in registers, could not feed it).
//
// Splits. Q's and P's are formed in registers, per warp. Each K and V tile
// is split once for the block, right after it lands: hi over the raw values
// in place, lo into one extra tile; the warps then load both halves of their
// B fragments from shared memory. (A first version of this kernel split the
// B fragments in every warp, and spent most of its instructions there.)
//
// Head dims: 32, 64, 112 (kimi-k2-1t: 14 k-steps of Q Kᵀ and 14 n-tiles of
// O) and 128. Every Dh is a multiple of 16, so a row is whole 16-byte chunks
// in both types and its padded stride Dh + PAD keeps 16-byte alignment; at
// Dh 112 the fp32 stride 116 (= 20 mod 32 banks) still spreads a fragment's
// 8 rows x 4 columns over 32 distinct banks.
//
// Staging: Q (through two buffers), then K and V tiles (K0, V0, K1, V1, ...)
// go through a ring of three tile buffers by 16-byte cp.async copies, two
// tiles in flight while one is split and multiplied: two __syncthreads per
// tile. Row stride Dh + 4 floats (Dh + 8 bf16): conflict-free fragment
// loads. Shared memory at Dh = 128, fp32: 4 x 33.8 KB = 135 KB (the ring and
// the lo tile), dynamic, one block of 8 warps per SM. q, k, v and out
// are read and written through their (b, h, s) strides with a contiguous last
// dimension, so the model's (B, S, H, Dh) projections need no transposed copy;
// the copies need 16-byte aligned pointers and strides (the wrapper checks).
// Softmax runs on the accumulator fragments with expf (not __expf).
//
// What bounds it: at qwen3-0.6b's prefill (B = 1, S = 2,048, H = 16, Dh = 128,
// causal) one call does 1.72e10 FLOP of products over the causal triangle,
// three times over in TF32: 0.104 ms at 495 TFLOP/s (0.26 ms on the fp32
// pipes); q/k/v/o are 50 MB (0.015 ms). The products set the bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "split_tf32.cuh"

namespace fa {

using namespace tf32x3;

constexpr int BQ = 128;       // query rows per block, 16 per warp
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 8 warps
constexpr int RING = 3;       // tile buffers
constexpr float NEG_INF = -1e30f;

// PAD: row padding in elements (16 bytes); EXACT: the type converts exactly to TF32
template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int PAD = 4;
  static constexpr bool EXACT = false;
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int PAD = 8;
  static constexpr bool EXACT = true;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

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

// The ring of RING tiles, and for fp32 one more tile for the lo halves.
template <int DH, typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)(RING + !Elem<T>::EXACT) * BK * (DH + Elem<T>::PAD);
}

// Copy rows [r0, r0 + 64) of a (rows, DH) matrix with row stride `ld` into
// `dst`, zeros past `rows`. The tile's 16-byte chunks need not be a multiple
// of the block's threads (Dh 112 in bf16: 896 chunks over 256 threads).
template <int DH, typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long ld, int r0, int rows,
                                      int tid) {
  constexpr int CH = 16 / sizeof(T);
  constexpr int PER_ROW = DH / CH;
  constexpr int LD = DH + Elem<T>::PAD;
  constexpr int CHUNKS = BK * PER_ROW;
  static_assert(DH % CH == 0, "rows are copied in 16-byte chunks");
#pragma unroll
  for (int i = 0; i < (CHUNKS + THREADS - 1) / THREADS; ++i) {
    const int idx = tid + THREADS * i;
    if (CHUNKS % THREADS != 0 && idx >= CHUNKS) break;
    const int r = idx / PER_ROW, c = CH * (idx % PER_ROW);
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * LD + c, ok ? src + (long long)(r0 + r) * ld + c : src, ok);
  }
}

// Split a staged fp32 tile in place: hi over the raw values, lo into `lo`.
template <int DH>
__device__ __forceinline__ void split_tile(float* tile, float* lo, int tid) {
  constexpr int LD = DH + 4;
  static_assert(BK * DH / 4 % THREADS == 0, "a whole number of float4s per thread");
#pragma unroll
  for (int i = 0; i < BK * DH / 4 / THREADS; ++i) {
    const int f = tid + THREADS * i;
    const int off = f / (DH / 4) * LD + 4 * (f % (DH / 4));
    const float4 x = *reinterpret_cast<const float4*>(tile + off);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(tile + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// A operand from four floats: split in two, or (exact types) the float's bits
template <bool EXACT>
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (EXACT) {
      hi[e] = __float_as_uint(x[e]);
    } else {
      split(x[e], hi[e], lo[e]);
    }
  }
}

// B operand (hi, lo) of an element of a staged tile: for fp32 the split
// halves, for bf16 the exact value (lo unused).
template <typename T>
__device__ __forceinline__ void b_operand(const T* tile, const float* lo, int off, uint32_t& bh,
                                          uint32_t& bl) {
  if constexpr (Elem<T>::EXACT) {
    bh = __float_as_uint(to_f(tile[off]));
  } else {
    bh = __float_as_uint(tile[off]);
    bl = __float_as_uint(lo[off]);
  }
}

template <int DH, typename T>
__global__ void __launch_bounds__(THREADS, 1) attn_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DH + Elem<T>::PAD;
  constexpr int TILE = BK * LD;
  constexpr int KS = DH / 8;  // 8-wide steps of Dh: k-steps of Q Kᵀ, n-tiles of O
  constexpr bool EXACT = Elem<T>::EXACT;
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* lo = reinterpret_cast<float*>(ring + RING * TILE);  // fp32: lo halves of a tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest-first under the causal mask
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const T* qg = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* kg = static_cast<const T*>(p.k) + b * p.kb + hk * p.kh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vb + hk * p.vh;

  // key tiles that hold a visible key for some row of this query tile, and
  // the keys visible to some row of this warp's 16
  int k_hi = p.T, kw_hi = p.T;
  if (p.causal) {
    k_hi = min(k_hi, q0 + BQ);
    kw_hi = min(kw_hi, q0 + 16 * warp + 16);
  }
  int k_lo = 0, kw_lo = 0;
  if (p.window > 0) {
    k_lo = max(0, q0 - p.window + 1) / BK * BK;
    kw_lo = max(0, q0 + 16 * warp - p.window + 1);
  }
  const int n_tiles = k_hi > k_lo ? 2 * ((k_hi - k_lo + BK - 1) / BK) : 0;  // K0, V0, K1, ...

  auto issue = [&](int u) {  // tile u into buffer u % RING
    if (u < n_tiles) {
      const bool is_v = u & 1;
      stage<DH, T>(ring + (u % RING) * TILE, is_v ? vg : kg, is_v ? p.vs : p.ks,
                   k_lo + (u >> 1) * BK, p.T, tid);
    }
    cp_async_commit();
  };

  // Q's 128 rows through buffers 1 and 2 while K0 comes into buffer 0
  stage<DH, T>(ring + TILE, qg, p.qs, q0, p.S, tid);
  stage<DH, T>(ring + 2 * TILE, qg, p.qs, q0 + BK, p.S, tid);
  cp_async_commit();
  issue(0);
  cp_async_wait<1>();
  __syncthreads();
  float qf[KS][4];  // this warp's 16 query rows: A fragments of each k-step
  {
    const T* qs = ring + TILE + (16 * warp + g) * LD + t;  // rows 64.. continue in buffer 2
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qf[kk][0] = to_f(qs[8 * kk]);
      qf[kk][1] = to_f(qs[8 * LD + 8 * kk]);
      qf[kk][2] = to_f(qs[8 * kk + 4]);
      qf[kk][3] = to_f(qs[8 * LD + 8 * kk + 4]);
    }
  }
  __syncthreads();  // Q is in registers: buffers 1 and 2 are free
  issue(1);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};  // rows g and g + 8
  float o[KS][4];
#pragma unroll
  for (int c = 0; c < KS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.0f;
  float s[BK / 8][4];  // the key tile's scores, then probabilities

  for (int u = 0; u < n_tiles; ++u) {
    cp_async_wait<1>();
    __syncthreads();  // tile u has landed; every warp is done with tile u - 1 (and its lo)
    issue(u + 2);     // into tile u - 1's buffer
    T* tile = ring + (u % RING) * TILE;
    if constexpr (!EXACT) {
      split_tile<DH>(reinterpret_cast<float*>(tile), lo, tid);
      __syncthreads();  // the split tile is complete
    }
    const int k0 = k_lo + (u >> 1) * BK;
    if (k0 >= kw_hi || k0 + BK <= kw_lo) continue;  // no key of this tile is visible to this warp

    if ((u & 1) == 0) {  // S = Q Kᵀ, mask, online softmax
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ah[4], al[4];
        split4<EXACT>(qf[kk], ah, al);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const int off = (8 * j + g) * LD + 8 * kk + t;
          uint32_t bh[2], bl[2];
          b_operand(tile, lo, off, bh[0], bl[0]);
          b_operand(tile, lo, off + 4, bh[1], bl[1]);
          if constexpr (EXACT) {
            mma(s[j], ah, bh);
          } else {
            mma3(s[j], ah, al, bh, bl);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = q0 + 16 * warp + g + 8 * r;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + 8 * j + 2 * t + e;
            const bool ok = kpos < p.T && (!p.causal || kpos <= qpos) &&
                            (p.window <= 0 || qpos - kpos < p.window);
            const float x = ok ? s[j][2 * r + e] * p.scale : NEG_INF;
            s[j][2 * r + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));  // the 4 threads of a row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pv = m_new == NEG_INF ? 0.0f : expf(s[j][2 * r + e] - m_new);
            s[j][2 * r + e] = pv;
            sum += pv;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float alpha = m[r] == NEG_INF ? 0.0f : expf(m[r] - m_new);
        l[r] = alpha * l[r] + sum;
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < KS; ++c) {
          o[c][2 * r] *= alpha;
          o[c][2 * r + 1] *= alpha;
        }
      }
    } else {  // O += P V, one 8-key step per score tile
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};  // keys 2t -> t, 2t+1 -> t+4
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_bounded(pa[e], ph[e], pl[e]);  // 0 <= p <= 1
#pragma unroll
        for (int c = 0; c < KS; ++c) {
          const int off = (8 * j + 2 * t) * LD + 8 * c + g;
          uint32_t bh[2], bl[2];
          b_operand(tile, lo, off, bh[0], bl[0]);
          b_operand(tile, lo, off + LD, bh[1], bl[1]);
          if constexpr (EXACT) {
            mma(o[c], pl, bh);
            mma(o[c], ph, bh);
          } else {
            mma3(o[c], ph, pl, bh, bl);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  T* og = static_cast<T*>(p.o) + b * p.ob + h * p.oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int srow = q0 + 16 * warp + g + 8 * r;
    if (srow >= p.S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = og + (long long)srow * p.os + 2 * t;
#pragma unroll
    for (int c = 0; c < KS; ++c) store2(orow + 8 * c, o[c][2 * r] / denom, o[c][2 * r + 1] / denom);
  }
}

template <int DH, typename T>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH, T>();
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
    case 112: return launch<112, T>(p, B, H, stream);  // kimi-k2-1t
    case 128: return launch<128, T>(p, B, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// 16-byte aligned pointer and (b, h, s) strides: what the cp.async staging needs
inline bool aligned16(const void* ptr, long long sb, long long sh, long long ss, int elem) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (sb * elem) % 16 == 0 &&
         (sh * elem) % 16 == 0 && (ss * elem) % 16 == 0;
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
// v and out in that order; every last dimension is contiguous, and every
// pointer and stride 16-byte aligned.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int KV, int S, int T, int Dh, long long qb,
                                   long long qh, long long qs, long long kb, long long kh,
                                   long long ks, long long vb, long long vh, long long vs,
                                   long long ob, long long oh, long long os, int causal,
                                   int window, float scale, int dtype, int device,
                                   void* stream) {
  using namespace fa;
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV || T < 0 || H > 65535 || B > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  if (!aligned16(q, qb, qh, qs, elem) || !aligned16(k, kb, kh, ks, elem) ||
      !aligned16(v, vb, vh, vs, elem) || !aligned16(o, ob, oh, os, elem))
    return (int)cudaErrorMisalignedAddress;
  Params p{q, k, v, o, qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os,
           S, T, H / KV, causal, window, scale};
  return on_device(device, [&]() -> int {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch<float>(p, B, H, Dh, st);
    return dispatch<__nv_bfloat16>(p, B, H, Dh, st);
  });
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
