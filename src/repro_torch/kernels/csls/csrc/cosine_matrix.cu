// Cosine-similarity matrix for CSLS on Hopper.
//
// Replaces the JAX package's kernels/csls/csls.py::cosine_matrix_fwd /
// _cos_kernel (Pallas, TPU): out[i, j] = cos(a_i, b_j) for a (n, d) and
// b (m, d), with the rows' L2 normalisation fused into the tile, so the
// normalised copies never go to device memory. CSLS (core/alignment.py) adds
// the top-k means around it in PyTorch.
//
// The Pallas kernel normalises each 128-row block and hands the product to
// the MXU; its inputs are zero-padded to the block. Here one block computes a
// 128 x 128 output tile: it stages d-chunks of 16 columns of its a rows and
// b rows in shared memory (transposed, so each k is one contiguous row),
// every thread accumulates an 8 x 8 register tile of raw dot products with
// fp32 FMAs, and the same loop sums each row's squares (threads 0..127 the a
// rows, 128..255 the b rows). The epilogue writes
//     cos = dot * inv_a * inv_b,   inv = 1 / sqrt_rn(sum x^2 + 1e-18)
// with correctly rounded sqrt and reciprocal, so a zero row gives exactly 0
// as in the reference. Ragged n, m and d are masked in the kernel: no
// padding copies. No TF32 and no tensor cores: CSLS argmaxes are compared up
// to near-ties, which a 10-bit mantissa would exceed.
//
// What bounds it: the arithmetic. For one retrieval block of n = 4,096 rows
// against m = 123,853 at d = 100 it does 1.01e11 fp32 FLOP (1.5 ms at the
// card's 67 TFLOP/s outside the tensor cores) and writes 2.0 GB (0.6 ms at
// 3.35 TB/s). Per k each thread makes 4 128-bit shared loads for 64 FMAs,
// so the FMA pipes, not shared memory, should be the limit of this version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace csls {

constexpr int BM = 128;       // a rows per tile
constexpr int BN = 128;       // b rows per tile
constexpr int BK = 16;        // d columns staged per step
constexpr int THREADS = 256;  // 16 x 16; thread (ty, tx)
constexpr int LD = BM + 4;    // shared row stride: 16-byte aligned, offsets banks

// Each thread owns rows {4ty + i, 64 + 4ty + i} and columns
// {4tx + j, 64 + 4tx + j}, i, j < 4: its operands are two float4 of the a
// tile and two of the b tile per k.
__global__ void __launch_bounds__(THREADS)
cosine_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ out, int n, int m, int d) {
  __shared__ __align__(16) float as[BK][LD];
  __shared__ __align__(16) float bs[BK][LD];
  __shared__ float inv_a[BM];
  __shared__ float inv_b[BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  // staging: thread loads column lk of rows lr + 16 p (p < 8) of both tiles;
  // 16 neighbouring threads read 16 consecutive floats of one row
  const int lk = tid % BK, lr = tid / BK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float ss = 0.0f;  // tid < 128: sum of squares of a row row0 + tid, else of b row col0 + tid - 128

  for (int k0 = 0; k0 < d; k0 += BK) {
    const int kc = k0 + lk;
    const bool kin = kc < d;
#pragma unroll
    for (int p = 0; p < BM / 16; ++p) {
      const int r = lr + 16 * p;
      const int ga = row0 + r, gb = col0 + r;
      as[lk][r] = (kin && ga < n) ? a[(size_t)ga * d + kc] : 0.0f;
      bs[lk][r] = (kin && gb < m) ? b[(size_t)gb * d + kc] : 0.0f;
    }
    __syncthreads();

    {
      const float* col = tid < BM ? &as[0][tid] : &bs[0][tid - BM];
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float v = col[kk * LD];
        ss = fmaf(v, v, ss);
      }
    }

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + 4 * tx]);
      const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(ss, 1e-18f)));
  if (tid < BM) {
    inv_a[tid] = inv;
  } else {
    inv_b[tid - BM] = inv;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lrow = 4 * ty + (i & 3) + 64 * (i >> 2);
    const int r = row0 + lrow;
    if (r >= n) continue;
    const float ia = inv_a[lrow];
    float* orow = out + (size_t)r * m;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int lcol = 4 * tx + (j & 3) + 64 * (j >> 2);
      const int c = col0 + lcol;
      if (c < m) orow[c] = __fmul_rn(__fmul_rn(acc[i][j], ia), inv_b[lcol]);
    }
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

}  // namespace csls

extern "C" int csls_cosine_matrix(const void* a, const void* b, void* out, int n, int m, int d,
                                  int device, void* stream) {
  using namespace csls;
  if (n <= 0 || m <= 0) return 0;
  if (d < 0 || (n + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  return on_device(device, [&]() -> int {
    const dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
    cosine_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out),
        n, m, d);
    return (int)cudaGetLastError();
  });
}

extern "C" const char* csls_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
