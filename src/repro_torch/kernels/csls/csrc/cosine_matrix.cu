// Cosine-similarity matrix for CSLS on Hopper's tensor cores.
//
// Replaces the JAX package's kernels/csls/csls.py::cosine_matrix_fwd /
// _cos_kernel (Pallas, TPU): out[i, j] = cos(a_i, b_j) for a (n, d) and
// b (m, d), with the rows' L2 normalisation fused into the tile, so the
// normalised copies never go to device memory. CSLS (core/alignment.py) adds
// the top-k means around it in PyTorch.
//
// Products: split TF32 (include/split_tf32.cuh). Each operand is split into
// hi = tf32(x) and lo = tf32(x - hi), and every dot product is lo·hi + hi·lo
// + hi·hi on the tensor cores, accumulated in fp32. The dropped lo·lo term is
// below 2^-22 of each product, so the cosines keep fp32 accuracy: a CPU
// emulation of the scheme holds the card check's 1e-5 at d = 100 and 33
// where one TF32 product breaks it (tests/test_torch_tf32_split.py).
//
// Design: wgmma with A in registers, and a helper warpgroup. A block owns
// 128 rows of `a` and walks a strided run of b tiles (persistent: about one
// block per SM). Warpgroups 0 and 1 (consumers, 64 a rows each) split their
// A fragments once, for the whole of d, into registers (13 k-steps of 8, so
// d <= 104 is one chunk, zero-filled past d; a longer d is walked in chunks
// of 104 with the fragments reloaded, without overlap), and per b tile
// issue wgmma.m64n72k8.tf32 three times per k-step (A from registers, B from
// shared memory). `a` and `b` both lie K-major, the only operand order
// wgmma's tf32 form accepts, so nothing is transposed. Warpgroup 2 (helper)
// stages the raw b tiles by cp.async in a two-stage ring, splits each into
// hi and lo tiles in wgmma's K-major core-matrix layout (8 rows x 16 bytes
// per core matrix, no swizzle; double-buffered) and sums the rows' squares,
// while the consumers multiply the previous tile; two block barriers per tile
// hand the split tiles over. Measured on the card: an mma.sync version (8
// warps of 64 x 32 tiles, split per fragment) spent most of its time loading
// and splitting fragments, and a version whose wgmma-issuing warps also split
// and stored ran that work after the products instead of beside them.
//
// Output. m = 123,853 is odd, so output rows start at every alignment, and a
// tile edge that cuts a 32-byte sector leaves partial writes (scalar stores
// at every tile edge cost more than the rest of the output on the card). So
// tile j computes b rows [64 j, 64 j + 72) and each output row takes from it
// the 64 columns that start at the row's first 32-byte boundary at or after
// column 64 j: a row is written in whole, aligned sectors except its own
// first and last few columns, for 12.5% more products. Each consumer warp
// scales its 16 x 72 accumulator into a shared-memory staging tile,
//     cos = dot * inv_a * inv_b,   inv = 1 / sqrt_rn(sum x^2 + 1e-18)
// (correctly rounded sqrt and reciprocal, sums of squares in fp32 from the
// raw values, so a zero row gives exactly 0 as in the reference), each row
// shifted by its output address mod 4, and hands each row's whole 16-byte
// quads to the bulk-copy engine (cp.async.bulk), which writes them while the
// next tile's products run. Ragged n, m and d are zero-filled by the copies,
// with no padding in device memory: 16-byte copies when d is a multiple of 4
// and the pointers 16-byte aligned, 4-byte copies otherwise.
//
// What bounds it: for one retrieval block of n = 4,096 rows against
// m = 123,853 at d = 100 the output is 2.03 GB (0.61 ms at 3.35 TB/s); the
// products are 1.01e11 FLOP, three times over in TF32 (0.61 ms at 495
// TFLOP/s; 1.5 ms on the fp32 pipes). Writing the output sets the bound,
// with the tensor cores just under it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_tf32.cuh"

namespace csls {

using namespace tf32x3;

constexpr int BM = 128;       // a rows per block, 64 per warpgroup
constexpr int TS = 64;        // output columns per tile
constexpr int BN = 72;        // b rows per tile: the wgmma's N (TS + one 32-byte sector)
constexpr int NG = BN / 8;    // 8-row core-matrix groups of a b tile
constexpr int CONSUMERS = 256;  // two warpgroups: the products and the epilogue
constexpr int HELPERS = 128;    // one warpgroup: copies in, splits, norms of b
constexpr int THREADS = CONSUMERS + HELPERS;
constexpr int KS = 13;        // k-steps of 8 per chunk: d = 100 in one
constexpr int KP = 8 * KS;    // d columns per chunk (zero-filled past d)
constexpr int LDO = 76;       // output staging row stride: >= BN + 3, = 4 (mod 32)
constexpr int STAGE_FLOATS = (CONSUMERS / 32) * 16 * LDO;
constexpr int THIRDS = 3;       // a b row's columns are split in three parts

// Shared memory: split tiles [2][hi, lo][NG][KP / 4 core matrices][32], raw
// ring [2][BN][KP + 4], output staging, inverse norms of a and b
// [BM + 2 BN], partial sums of squares [2][THIRDS][BN].
constexpr int SMEM_BYTES = (int)sizeof(float) * (4 * BN * KP + 2 * BN * (KP + 4) +
                                                 STAGE_FLOATS + BM + 2 * BN + 2 * THIRDS * BN);
static_assert(SMEM_BYTES <= 232448, "one block per SM");

// wgmma descriptor of a K-major tile without swizzle: core matrices of 8 rows
// x 16 bytes, 128 bytes apart along K (leading byte offset), `sbo` bytes
// apart along N (stride byte offset).
__device__ __forceinline__ uint64_t make_desc(const float* tile, uint32_t sbo) {
  const uint32_t addr = smem_addr(tile);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

using Acc = float[36];

// D (64 x 72, fp32) += A (64 x 8, tf32, registers) · B (8 x 72, tf32, shared
// memory), or D = A · B when INIT (so the old D is not an input). Per warp w
// of the warpgroup, a = A[16 w + g][t], A[16 w + g + 8][t], A[16 w + g][t + 4],
// A[16 w + g + 8][t + 4] and d[4 i + 2 h + e] = D[16 w + g + 8 h][8 i + 2 t + e]
// (g = lane / 4, t = lane % 4).
#define CSLS_WGMMA_D(c)                                                                    \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]), \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), c(d[17]),      \
      c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),      \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31]), c(d[32]), c(d[33]),      \
      c(d[34]), c(d[35])
#define CSLS_WGMMA_ASM                                                                     \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"                                              \
  "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, " \
  "{%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
#define CSLS_IN_OUT(x) "+f"(x)
#define CSLS_OUT(x) "=f"(x)
template <bool INIT>
__device__ __forceinline__ void wgmma_tf32(Acc& d, const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (INIT) {
    asm volatile(CSLS_WGMMA_ASM
                 : CSLS_WGMMA_D(CSLS_OUT)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
  } else {
    asm volatile(CSLS_WGMMA_ASM
                 : CSLS_WGMMA_D(CSLS_IN_OUT)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Generic-proxy writes to shared memory, made visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving reads of an accumulator above its wait.
__device__ __forceinline__ void fence_acc(Acc& d) {
#pragma unroll
  for (int i = 0; i < 36; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Bulk copy (TMA engine) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from shared to global memory, and its group commit and waits.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {  // the sources may be overwritten
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {  // the writes are done
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float inv_norm(float ss) {
  return __frcp_rn(__fsqrt_rn(__fadd_rn(ss, 1e-18f)));
}

// VEC: 16-byte copies. CHUNKED: d > KP.
//
// Warpgroups 0 and 1 (consumers) hold the A fragments and run the products
// and the epilogue; warpgroup 2 (helper) stages the b tiles, splits them and
// computes their norms, so that this work runs beside the products. Two
// block-wide barriers per tile hand the split tiles over.
template <bool VEC, bool CHUNKED>
__global__ void __launch_bounds__(THREADS, 1)
cosine_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ out, int n, int m, int d, int col_groups) {
  constexpr int RS = KP + 4;        // raw row stride: conflict-free 16-byte reads
  constexpr int SBO = KP / 4 * 32;  // floats between 8-row groups of a split tile
  constexpr int TILE = BN * KP;
  constexpr int QT = (KP / 4 + THIRDS - 1) / THIRDS;  // column quads per third of a row
  extern __shared__ __align__(128) float smem[];
  float* sb = smem;                      // [2][hi, lo][TILE]
  float* raw = sb + 4 * TILE;            // [2][BN][RS]
  float* stage = raw + 2 * BN * RS;      // [8 warps][16][LDO]
  float* inv_a = stage + STAGE_FLOATS;   // [BM]
  float* inv_b = inv_a + BM;             // [2 tiles][BN]
  float* part = inv_b + 2 * BN;          // [2 tiles][THIRDS][BN]

  const int nch = CHUNKED ? (d + KP - 1) / KP : 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool helper = tid >= CONSUMERS;
  const int hid = tid - CONSUMERS;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * BM;
  const int wrow = 64 * (warp >> 2) + 16 * (warp & 3);  // a consumer warp's first row
  const int n_tiles = (m + TS - 1) / TS;
  const int my_tiles =
      (int)blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / col_groups + 1 : 0;
  const int units = my_tiles * nch;  // (tile, chunk) pairs, chunks fastest
  if (units == 0) return;
  auto tile_of = [&](int u) { return (int)blockIdx.x + (u / nch) * col_groups; };

  // ------------------------------------------------------------- helper
  auto issue = [&](int u) {  // raw b rows of unit u into ring stage u % 2
    if (u < units) {
      float* dst = raw + (u & 1) * BN * RS;
      const int r0 = tile_of(u) * TS, k0 = (u % nch) * KP;
      if constexpr (VEC) {
        for (int i = hid; i < BN * (KP / 4); i += HELPERS) {
          const int r = i / (KP / 4), q = 4 * (i % (KP / 4));
          const bool ok = r0 + r < m && k0 + q < d;
          cp_async16(dst + r * RS + q, ok ? b + (size_t)(r0 + r) * d + k0 + q : b, ok);
        }
      } else {
        for (int i = hid; i < BN * KP; i += HELPERS) {
          const int r = i / KP, q = i % KP;
          const bool ok = r0 + r < m && k0 + q < d;
          cp_async4(dst + r * RS + q, ok ? b + (size_t)(r0 + r) * d + k0 + q : b, ok);
        }
      }
    }
    cp_async_commit();
  };

  // Split the raw rows of unit u into hi and lo core-matrix tiles. The
  // helper's thread hid takes the (row, third) units hid and hid + 128 of
  // 72 x 3 (row fastest) and sums their squares.
  float ssp[2] = {0.0f, 0.0f};
  auto split_unit = [&](int u) {
    const float* src = raw + (u & 1) * BN * RS;
    float* hi = sb + (u & 1) * 2 * TILE;
    float* lo = hi + TILE;
    if (u % nch == 0) ssp[0] = ssp[1] = 0.0f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int v = hid + HELPERS * k;
      if (v >= BN * THIRDS) break;
      const int r = v % BN, third = v / BN;
      const int q1 = min(KP / 4, QT * (third + 1));
      for (int q = QT * third; q < q1; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(src + r * RS + 4 * q);
        ssp[k] = fmaf(x.x, x.x, ssp[k]);
        ssp[k] = fmaf(x.y, x.y, ssp[k]);
        ssp[k] = fmaf(x.z, x.z, ssp[k]);
        ssp[k] = fmaf(x.w, x.w, ssp[k]);
        uint4 hv, lv;
        split(x.x, hv.x, lv.x);
        split(x.y, hv.y, lv.y);
        split(x.z, hv.z, lv.z);
        split(x.w, hv.w, lv.w);
        const int off = (r >> 3) * SBO + q * 32 + (r & 7) * 4;
        *reinterpret_cast<uint4*>(hi + off) = hv;
        *reinterpret_cast<uint4*>(lo + off) = lv;
      }
      if (u % nch == nch - 1) part[((u / nch) & 1) * THIRDS * BN + third * BN + r] = ssp[k];
    }
    fence_proxy_async();  // the split tiles are read by wgmma
  };

  auto finish_norms = [&](int u) {  // inverse norms of unit u's b rows, once fully split
    if (u < units && u % nch == nch - 1 && hid < BN) {
      const int par = (u / nch) & 1;
      const float* p = part + par * THIRDS * BN + hid;
      inv_b[par * BN + hid] = inv_norm((p[0] + p[BN]) + p[2 * BN]);
    }
  };

  // ---------------------------------------------------------- consumers
  uint32_t ah[KS][4], al[KS][4];  // A fragments of one chunk, split
  auto load_a = [&](int c) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wrow + g + 8 * (e & 1);
        const int k = c * KP + 8 * ks + t + 4 * (e >> 1);
        const float x = r < n && k < d ? a[(size_t)r * d + k] : 0.0f;
        split(x, ah[ks][e], al[ks][e]);
      }
  };

  Acc acc;
  auto mma_unit = [&](int u) {  // issues the products of unit u; returns at once
    const float* hi = sb + (u & 1) * 2 * TILE;
    const uint64_t dh = make_desc(hi, 4 * SBO), dl = make_desc(hi + TILE, 4 * SBO);
    wgmma_fence();
    if (!CHUNKED || u % nch == 0) {
      wgmma_tf32<true>(acc, al[0], dh);
    } else {
      wgmma_tf32<false>(acc, al[0], dh);
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint64_t off = (uint64_t)(ks * 2 * 128) >> 4;  // two core matrices per k-step
      if (ks > 0) wgmma_tf32<false>(acc, al[ks], dh + off);
      wgmma_tf32<false>(acc, ah[ks], dl + off);
      wgmma_tf32<false>(acc, ah[ks], dh + off);
    }
    wgmma_commit();
  };

  const unsigned long long out_word = reinterpret_cast<uintptr_t>(out) >> 2;
  float* st = stage + warp * 16 * LDO;
  // The epilogue of unit u's tile, in two parts. stage_acc scales this warp's
  // 16 x 72 accumulator by the inverse norms into its staging tile, each row
  // shifted by its output address mod 4 so that aligned quads stay aligned;
  // store_tile then hands each row to the bulk-copy engine while the next
  // tile's products run. A row takes columns [lo, hi) of the tile: from its
  // first 32-byte boundary at or after the tile's first column (from 0 in the
  // first tile) to where the next tile's row starts.
  auto stage_acc = [&](int u) {
    bulk_wait_read();  // the previous tile's bulk copies have read the staging tile
    __syncwarp();
    const int col0 = tile_of(u) * TS;
    const float* ib = inv_b + ((u / nch) & 1) * BN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lrow = wrow + g + 8 * h;
      const float ia = inv_a[lrow];
      const int s = (int)((out_word + (unsigned long long)(row0 + lrow) * m + col0) & 3ull);
      float* trow = st + (g + 8 * h) * LDO + s;
#pragma unroll
      for (int i = 0; i < NG; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * i + 2 * t + e;
          trow[col] = __fmul_rn(__fmul_rn(acc[4 * i + 2 * h + e], ia), ib[col]);
        }
    }
    fence_proxy_async();  // the staging tile is read by the bulk copies
    __syncwarp();
  };
  auto store_tile = [&](int u) {  // lane r < 16 writes row r of this warp's 16
    const int jt = tile_of(u), col0 = jt * TS;
    const int grow = row0 + wrow + lane;
    if (lane < 16 && grow < n) {
      const unsigned long long base = out_word + (unsigned long long)grow * m + col0;
      const int s = (int)(base & 3ull);
      const int al8 = (int)((8 - (base & 7ull)) & 7ull);
      const int lo = jt == 0 ? 0 : al8;
      const int hi = min(al8 + TS, m - col0);
      const int cb = min(hi, lo + (int)((4 - ((base + lo) & 3ull)) & 3ull));  // whole quads
      const int ce = max(cb, hi - (int)((base + hi) & 3ull));
      const float* trow = st + lane * LDO + s;  // column c at trow[c]
      float* orow = out + (size_t)grow * m + col0;
      if (ce > cb) bulk_store(orow + cb, trow + cb, 4 * (ce - cb));
      for (int c = lo; c < cb; ++c) __stcs(orow + c, trow[c]);
      for (int c = ce; c < hi; ++c) __stcs(orow + c, trow[c]);
      bulk_commit();
    }
  };

  // ------------------------------------------------------------ schedule
  if (helper) {
    issue(0);
    issue(1);
    cp_async_wait<1>();
  } else {
    if (tid < BM) {  // inverse norms of the block's a rows, over all of d
      float ss = 0.0f;
      if (row0 + tid < n) {
        const float* r = a + (size_t)(row0 + tid) * d;
#pragma unroll 8
        for (int k = 0; k < d; ++k) ss = fmaf(r[k], r[k], ss);
      }
      inv_a[tid] = inv_norm(ss);
    }
    if (!CHUNKED) load_a(0);
  }
  __syncthreads();
  if (helper) split_unit(0);
  __syncthreads();
  if (helper) {
    finish_norms(0);
    issue(2);
  }
  // Per unit u: the consumers run its products (and write tile u - 1 beside
  // them) while the helper splits unit u + 1; the two barriers hand over
  // the split tiles and the raw stage.
  for (int u = 0; u < units; ++u) {
    if (helper) cp_async_wait<1>();  // unit u + 1's raw tile has landed
    __syncthreads();  // unit u is split; the consumers are done with unit u - 1's tiles
    if (helper) {
      if (u + 1 < units) split_unit(u + 1);
    } else {
      if (CHUNKED) load_a(u % nch);  // the previous unit's products are complete
      mma_unit(u);
      if (u > 0 && (u - 1) % nch == nch - 1) store_tile(u - 1);
      wgmma_wait<0>();
      fence_acc(acc);
      if (u % nch == nch - 1) stage_acc(u);
    }
    __syncthreads();  // unit u + 1 is split; its raw stage is free
    if (helper) {
      finish_norms(u + 1);
      issue(u + 3);
    }
  }
  if (helper) {
    cp_async_wait<0>();
  } else {
    store_tile(units - 1);
    bulk_wait();
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

template <bool VEC, bool CHUNKED>
int launch(const float* a, const float* b, float* out, int n, int m, int d, int device,
           cudaStream_t stream) {
  auto kernel = cosine_kernel<VEC, CHUNKED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int row_blocks = (n + BM - 1) / BM, n_tiles = (m + TS - 1) / TS;
  const int col_groups = max(1, min(n_tiles, sms / row_blocks));  // about one block per SM
  kernel<<<dim3(col_groups, row_blocks), THREADS, SMEM_BYTES, stream>>>(a, b, out, n, m, d,
                                                                        col_groups);
  return (int)cudaGetLastError();
}

}  // namespace csls

extern "C" int csls_cosine_matrix(const void* a, const void* b, void* out, int n, int m, int d,
                                  int device, void* stream) {
  using namespace csls;
  if (n <= 0 || m <= 0) return 0;
  if (d < 0 || (n + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0;
  return on_device(device, [&]() -> int {
    const float* fa = static_cast<const float*>(a);
    const float* fb = static_cast<const float*>(b);
    float* fo = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d > KP)
      return vec ? launch<true, true>(fa, fb, fo, n, m, d, device, st)
                 : launch<false, true>(fa, fb, fo, n, m, d, device, st);
    return vec ? launch<true, false>(fa, fb, fo, n, m, d, device, st)
               : launch<false, false>(fa, fb, fo, n, m, d, device, st);
  });
}

extern "C" const char* csls_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
