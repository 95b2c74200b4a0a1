// Hopper building blocks shared by the tensor-core kernels (convlstm_wgmma.cu,
// conv_int8_wgmma.cu): mbarriers, the bulk (TMA-engine) copy, cp.async,
// 16-byte shared stores and the no-swizzle K-major wgmma descriptor. sm_90a
// only.
#pragma once

#include <stdint.h>

namespace lut {

// a broken pipeline traps (a launch error) instead of hanging the card
constexpr long long kSpinLimit = 1LL << 26;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > kSpinLimit) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// one contiguous global -> shared copy on the async proxy, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16-byte cp.async; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t addr, const uint32_t (&w)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(w[0]), "r"(w[1]),
               "r"(w[2]), "r"(w[3])
               : "memory");
}

// no-swizzle K-major wgmma descriptor: LBO = bytes between the two core
// matrices of one k step (32 bytes of K), SBO = bytes between 8-row core
// matrices
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

}  // namespace lut

// the accumulator operands of an m64n128 (64) or m64n256 (128) wgmma, as
// asm text
#define LUT_ACC_0_63                                                                    \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18," \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35," \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52," \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define LUT_ACC_64_127                                                                  \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80," \
  "%81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97," \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"    \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125,"  \
  "%126, %127"
