// Asynchronous copies from device memory into shared memory (cp.async),
// shared by the kernels of this directory (dataflow_fire.cu,
// schedule_fire.cu).  A copy lands when the thread that issued it waits;
// another thread sees it after a barrier.
#pragma once

#include <cstdint>

// 16 bytes, both addresses 16-byte aligned (through L2 only).
__device__ __forceinline__ void cp_async16(int* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// 4 bytes.
__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Closes the group of copies this thread issued since the last one.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for every copy this thread issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Threads t, t + nt, ... of a group copy n ints from g to s (s 16-byte
// aligned): in 16-byte pieces when g is 16-byte aligned, then the tail 4
// bytes a copy; 4 bytes a copy otherwise.  Nothing is read past g[n - 1].
__device__ __forceinline__ void stage_ints(int* s, const int* g, int n, int t,
                                           int nt) {
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int n4 = n >> 2;
    for (int k = t; k < n4; k += nt) cp_async16(s + 4 * k, g + 4 * k);
    i0 = 4 * n4;
  }
  for (int i = i0 + t; i < n; i += nt) cp_async4(s + i, g + i);
}
