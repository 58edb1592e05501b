// What the two chunked-WKV kernels share (`wkv_intra.cu`, its backward
// `wkv_intra_bwd.cu`): the sub-chunk that both factor the exponent by, and
// 16-byte asynchronous copies into shared memory.
#pragma once

#include <cstdint>

namespace wkv {

// rows of a sub-chunk; a chunk of at most 128 rows has at most eight
constexpr int kMaxChunk = 128;
constexpr int kSub = 16;
constexpr int kMaxSub = kMaxChunk / kSub;

// Copies 16 bytes from `gmem` to `smem` without passing through
// registers; with `valid` false it writes 16 zero bytes and reads
// nothing (`gmem` must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most `kPending` of this thread's committed groups are
// still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

}  // namespace wkv
