// Field-row packer for Hopper: ROWS f32 vectors of n -> one [ROWS, n] pack.
//
// Replaces the Pallas TPU kernel scripts/r4_glue_micro.py:pallas_pack
// (candidate D of the glue micro-benchmark), which concatenates [1, 32768]
// blocks of each row along the sublane axis in a grid of n // 32768 steps.
// The plain PyTorch version is torch.stack(rows, 0)
// (sph_tpu_torch/ops/pack.py:pack_plain), which this kernel is checked
// against bit for bit.
//
// Design. A pure copy: one thread per column (per 4 columns when n and every
// pointer allow 16-byte accesses). The row pointers arrive by value in a
// struct of at most MAX_ROWS; the row loop is unrolled over MAX_ROWS with a
// guard, so every pointer is read from the parameter space at a constant
// index (a loop indexing the struct at run time made the compiler copy it
// to local memory) and each thread issues all its row loads before its
// stores. Neighbouring threads touch neighbouring addresses of each row,
// so every load and store is coalesced. The grid covers all n columns at
// any n, the ragged tail included (the Pallas kernel's grid of n // 32768
// steps leaves the last n % 32768 columns unwritten).
//
// What bounds it on this card: bytes. It reads ROWS * n * 4 B and writes as
// many, and does no arithmetic: at ROWS = 8 and n = 232,192 that is
// 14.9 MB, 4.44 us at 3.35 TB/s. At that size a launch is a few
// microseconds, so launch latency is of the same order as the copy.
#include <cuda_runtime.h>

#define SPH_PACK_MAX_ROWS 16

struct PackRows {
  const float* rows[SPH_PACK_MAX_ROWS];
};

// T = float (any n) or float4 (n % 4 == 0, 16-byte aligned pointers; n and
// the rows are then counted in float4s).
template <typename T>
__global__ void pack_rows(PackRows in, int n_rows, long long n,
                          T* __restrict__ out) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  T v[SPH_PACK_MAX_ROWS];
#pragma unroll
  for (int r = 0; r < SPH_PACK_MAX_ROWS; ++r)
    if (r < n_rows) v[r] = __ldg(reinterpret_cast<const T*>(in.rows[r]) + j);
#pragma unroll
  for (int r = 0; r < SPH_PACK_MAX_ROWS; ++r)
    if (r < n_rows) out[r * n + j] = v[r];
}

extern "C" {

// rows: a host array of n_rows device pointers, each to n contiguous f32;
// out: [n_rows, n] contiguous f32 on the device. Launches on `stream` and
// returns the launch's cudaError_t (0 on success); does not synchronise.
int sph_pack_rows(const float* const* rows, int n_rows, long long n,
                  float* out, void* stream) {
  if (n_rows < 1 || n_rows > SPH_PACK_MAX_ROWS || n < 1)
    return (int)cudaErrorInvalidValue;
  PackRows in = {};
  bool vec = (n % 4 == 0) && ((unsigned long long)out % 16 == 0);
  for (int r = 0; r < n_rows; ++r) {
    in.rows[r] = rows[r];
    vec = vec && ((unsigned long long)rows[r] % 16 == 0);
  }
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    long long n4 = n / 4;
    pack_rows<float4><<<(unsigned)((n4 + threads - 1) / threads), threads, 0,
                        s>>>(in, n_rows, n4, reinterpret_cast<float4*>(out));
  } else {
    pack_rows<float><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                       s>>>(in, n_rows, n, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
