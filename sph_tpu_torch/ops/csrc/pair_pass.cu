// Blocked all-pairs passes of the wall-compact (fastw) engine, for Hopper.
//
// Replaces the Pallas TPU driver sph_tpu/ops/pair_kernels.py:_make_pass and
// four of its tile functions:
//   RhoStar  <- sph_tpu/ops/pair_kernels.py:make_rho_star_pass (raw sums)
//   ViscSurf <- sph_tpu/ops/pair_kernels.py:make_viscsurf_pass
//   PAccel   <- sph_tpu/ops/pair_kernels.py:make_paccel_pass
//   Boundary <- sph_tpu/ops/pair_kernels.py:make_boundary_pass
// The plain PyTorch versions in sph_tpu_torch/ops/pair_kernels.py compute
// the same sums and are what the kernels are checked against.
//
// Design. One CTA per own block, one thread per own row (blockDim = block).
// A thread reads its own fields from the column-major pack at
// ob + b*block + tid (coalesced: the packs are SoA). The block's tiles come
// straight from the 6-tuple chunk tables (tile s -> chunk
// c = 3b + (s >= s0[3b+1]) + (s >= s0[3b+2]), column
// aln[c] + (s - s0[c]) * ccol) with no static caps, so no tile is dropped.
// Each tile's slab rows x ccol f32 are staged in shared memory by the whole
// CTA (coalesced rows, at most 7 x 512 x 4 B = 14 KB), then every thread
// loops over the tile's columns with f32 register accumulators; the
// shared-memory reads are warp broadcasts. Reductions are direct f32 sums:
// the TPU's bf16-split MXU dots, identity-matmul transposes, group-of-8
// blocks and DMA ring exist only for the TPU and are not carried over.
// Masking follows the maskless invariant of the JAX module: a tile's
// columns outside the block's window are >= h away (every term vanishes)
// and pad columns sit at `far`. Tile columns beyond the slab width are
// skipped, own rows beyond the own width write zeros.
//
// What bounds it on this card: pair arithmetic. A moving row meets ~1.6k
// candidate columns per pass (~20-30 flops each); slab bytes are reused
// from shared memory by all 256 rows of the block, so device-memory traffic
// is small. The loads of a tile are not overlapped with the compute of the
// previous one (no cp.async/TMA double buffering), and no per-warp tile skip
// is applied; both are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: sqrtf, rsqrtf and division keep
// their IEEE behaviour). Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

struct RhoStar {
  static constexpr int kSlabRows = 3;  // predicted x, y, z
  struct Own { float x, y, z; };
  struct Acc { float s; };
  float h2;

  __device__ Own load(const float* own, long long w, long long i) const {
    return {own[i], own[w + i], own[2 * w + i]};
  }
  __device__ void pair(const Own& o, const float* t, int ccol, int j,
                       Acc& a) const {
    const float dx = o.x - t[j];
    const float dy = o.y - t[ccol + j];
    const float dz = o.z - t[2 * ccol + j];
    const float q = fmaxf(h2 - (dx * dx + dy * dy + dz * dz), 0.0f);
    a.s += q * q * q;
  }
  __device__ void store(float* out, long long n, long long i,
                        const Acc& a) const {
    out[i] = a.s;
  }
};

struct ViscSurf {
  static constexpr int kSlabRows = 7;  // x, y, z, vx, vy, vz, 1/rho
  struct Own { float x, y, z, vx, vy, vz; };
  struct Acc { float vx, vy, vz, sx, sy, sz; };
  float h, h2, inv_h;

  __device__ Own load(const float* own, long long w, long long i) const {
    return {own[i], own[w + i], own[2 * w + i],
            own[3 * w + i], own[4 * w + i], own[5 * w + i]};
  }
  __device__ void pair(const Own& o, const float* t, int ccol, int j,
                       Acc& a) const {
    const float dx = o.x - t[j];
    const float dy = o.y - t[ccol + j];
    const float dz = o.z - t[2 * ccol + j];
    const float r2 = dx * dx + dy * dy + dz * dz;
    const float wv = fmaxf(h - sqrtf(r2), 0.0f) * t[6 * ccol + j];
    a.vx += wv * (t[3 * ccol + j] - o.vx);
    a.vy += wv * (t[4 * ccol + j] - o.vy);
    a.vz += wv * (t[5 * ccol + j] - o.vz);
    if (r2 < h2) {
      a.sx += dx;
      a.sy += dy;
      a.sz += dz;
    }
  }
  __device__ void store(float* out, long long n, long long i,
                        const Acc& a) const {
    out[i] = a.vx * inv_h;
    out[n + i] = a.vy * inv_h;
    out[2 * n + i] = a.vz * inv_h;
    out[3 * n + i] = a.sx;
    out[4 * n + i] = a.sy;
    out[5 * n + i] = a.sz;
  }
};

struct PAccel {
  static constexpr int kSlabRows = 5;  // x, y, z, 1/rho*, p
  struct Own { float x, y, z, p; };
  struct Acc { float x, y, z; };
  float h, h4, rho0_delta, out_c;

  __device__ Own load(const float* own, long long w, long long i) const {
    return {own[i], own[w + i], own[2 * w + i], own[4 * w + i]};
  }
  __device__ void pair(const Own& o, const float* t, int ccol, int j,
                       Acc& a) const {
    const float dx = o.x - t[j];
    const float dy = o.y - t[ccol + j];
    const float dz = o.z - t[2 * ccol + j];
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (!(r2 > 0.0f)) return;  // self and coincident pairs
    const float inv_r = rsqrtf(fmaxf(r2, 1e-30f));
    const float r = r2 * inv_r;
    const float tt = fmaxf(h - r, 0.0f);
    const float cm = h4 - r;
    const float term = (cm > 0.0f ? cm * cm * rho0_delta
                                  : tt * tt * (o.p + t[4 * ccol + j]))
                       * t[3 * ccol + j];
    const float w = term * inv_r;
    a.x += w * dx;
    a.y += w * dy;
    a.z += w * dz;
  }
  __device__ void store(float* out, long long n, long long i,
                        const Acc& a) const {
    out[i] = a.x * out_c;
    out[n + i] = a.y * out_c;
    out[2 * n + i] = a.z * out_c;
  }
};

struct Boundary {
  static constexpr int kSlabRows = 7;  // x, y, z, nx, ny, nz, is_boundary
  struct Own { float x, y, z; };       // post-integrate positions
  struct Acc { float nx, ny, nz, w, w2; };
  float r0, inv_r0;

  __device__ Own load(const float* own, long long w, long long i) const {
    return {own[3 * w + i], own[4 * w + i], own[5 * w + i]};
  }
  __device__ void pair(const Own& o, const float* t, int ccol, int j,
                       Acc& a) const {
    const float dx = o.x - t[j];
    const float dy = o.y - t[ccol + j];
    const float dz = o.z - t[2 * ccol + j];
    const float d = r0 - sqrtf(dx * dx + dy * dy + dz * dz);
    const float w = fmaxf(0.0f, d * inv_r0) * t[6 * ccol + j];
    a.nx += w * t[3 * ccol + j];
    a.ny += w * t[4 * ccol + j];
    a.nz += w * t[5 * ccol + j];
    a.w += w;
    a.w2 += w * d;
  }
  __device__ void store(float* out, long long n, long long i,
                        const Acc& a) const {
    out[i] = a.nx;
    out[n + i] = a.ny;
    out[2 * n + i] = a.nz;
    out[3 * n + i] = a.w;
    out[4 * n + i] = a.w2;
  }
};

template <class P>
__global__ void __launch_bounds__(1024)
pair_pass(P p, const float* __restrict__ own, long long own_w,
          const float* __restrict__ slab, long long slab_w,
          const int* __restrict__ aln, const int* __restrict__ s0,
          const int* __restrict__ cnt, const int* __restrict__ ob,
          float* __restrict__ out, int ccol) {
  extern __shared__ float tile[];  // [kSlabRows][ccol]
  const int b = blockIdx.x;
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const long long n_pad = (long long)gridDim.x * nthr;
  const long long i_out = (long long)b * nthr + tid;
  const long long row = (long long)ob[0] + i_out;
  const bool live = row >= 0 && row < own_w;
  const typename P::Own o = p.load(own, own_w, live ? row : 0);
  typename P::Acc acc{};

  const int n_s = cnt[b];
  const int s1 = s0[3 * b + 1];
  const int s2 = s0[3 * b + 2];
  for (int s = 0; s < n_s; ++s) {
    const int c = 3 * b + (s >= s1) + (s >= s2);
    const long long off = (long long)aln[c] + (long long)(s - s0[c]) * ccol;
    long long avail = slab_w - off;
    if (off < 0) avail = 0;
    const int ncol = (int)(avail < ccol ? (avail > 0 ? avail : 0) : ccol);
    __syncthreads();  // the previous tile is consumed
    for (int r = 0; r < P::kSlabRows; ++r) {
      const float* src = slab + (long long)r * slab_w + off;
      for (int j = tid; j < ncol; j += nthr) tile[r * ccol + j] = src[j];
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int j = 0; j < ncol; ++j) p.pair(o, tile, ccol, j, acc);
    }
  }
  if (!live) acc = typename P::Acc{};
  p.store(out, n_pad, i_out, acc);
}

template <class P>
int launch(const P& p, const float* own, long long own_w, const float* slab,
           long long slab_w, const int* aln, const int* s0, const int* cnt,
           const int* ob, float* out, int n_blocks, int block, int ccol,
           void* stream) {
  if (n_blocks <= 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(float) * P::kSlabRows * (size_t)ccol;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pair_pass<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pair_pass<P><<<n_blocks, block, smem, (cudaStream_t)stream>>>(
      p, own, own_w, slab, slab_w, aln, s0, cnt, ob, out, ccol);
  return (int)cudaGetLastError();
}

}  // namespace

#define SPH_PAIR_ARGS                                                       \
  const float *own, long long own_w, const float *slab, long long slab_w,  \
      const int *aln, const int *s0, const int *cnt, const int *ob,        \
      float *out, int n_blocks, int block, int ccol, float c0, float c1,   \
      float c2, float c3, void *stream
#define SPH_PAIR_FWD \
  own, own_w, slab, slab_w, aln, s0, cnt, ob, out, n_blocks, block, ccol, stream

extern "C" {

int sph_pair_rho_star(SPH_PAIR_ARGS) {
  return launch(RhoStar{c0}, SPH_PAIR_FWD);
}

int sph_pair_viscsurf(SPH_PAIR_ARGS) {
  return launch(ViscSurf{c0, c1, c2}, SPH_PAIR_FWD);
}

int sph_pair_paccel(SPH_PAIR_ARGS) {
  return launch(PAccel{c0, c1, c2, c3}, SPH_PAIR_FWD);
}

int sph_pair_boundary(SPH_PAIR_ARGS) {
  return launch(Boundary{c0, c1}, SPH_PAIR_FWD);
}

const char* sph_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
