// Split-TF32 ("3xTF32") products on Hopper's tensor cores, and cp.async
// staging: the building blocks of the csls cosine and flash-attention kernels.
//
// A float x is split into two TF32 values, hi = tf32_rna(x) and
// lo = tf32_rna(x - hi), so x = hi + lo to 2^-22 of |x|, and a product is
//     a·b ≈ hi_a·hi_b + hi_a·lo_b + lo_a·hi_b
// (the dropped lo_a·lo_b is below 2^-22 of |a·b|). Each partial product of
// two TF32 values is exact in fp32, and the tensor cores accumulate in fp32,
// so a dot product in three TF32 products is as accurate as an fp32 one;
// one TF32 product keeps only 2^-11 of each operand. This is CUTLASS's "fast
// fp32" scheme (OpMultiplyAddFastF32), written here with mma.sync.
//
// Near FLT_MAX, cvt.rna rounds up to infinity; hi is therefore formed from x
// clamped to 0x7F7FEFFF, the largest float whose TF32 rounding is finite.
// There hi is x truncated to TF32 and lo = x - hi is exact, so the split still
// holds x to 2^-22. NaN and ±inf still propagate through lo.
#pragma once
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float lim = __uint_as_float(0x7f7fefffu);
  hi = tf32_rna(fminf(fmaxf(x, -lim), lim));
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The same split for |x| <= 2^127 (such as probabilities), where the
// rounding of hi cannot overflow: no clamp.
__device__ __forceinline__ void split_bounded(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The same split with the rounding done on the bit pattern by an integer add
// and a mask: for finite x, cvt.rna's result (ties away from zero, as the
// magnitude bits carry), at two integer instructions where ptxas expands
// cvt.rna.tf32 into a longer sequence. The SSD kernel, which splits every
// operand of its products, uses this one.
__device__ __forceinline__ uint32_t tf32_rna_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_bits(float x, uint32_t& hi, uint32_t& lo) {
  const float lim = __uint_as_float(0x7f7fefffu);
  hi = tf32_rna_bits(fminf(fmaxf(x, -lim), lim));
  lo = tf32_rna_bits(x - __uint_as_float(hi));
}

// D += A·B for one m16n8k8 tile: A 16 x 8 (row), B 8 x 8 (col), fp32 sums.
// Fragments (g = lane / 4, t = lane % 4): a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1].
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D += A·B in three TF32 products, the two small ones first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copies into shared memory; `valid` false writes zeros and
// reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tf32x3
