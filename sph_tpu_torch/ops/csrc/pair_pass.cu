// Blocked all-pairs passes of the fast and wall-compact engines, for Hopper.
//
// Replaces the Pallas TPU kernels sph_tpu/ops/pair_kernels.py:_make_pass and
// _make_sub_pass (the subgroup gate, template flag Gated below) and seven of
// their tile functions:
//   Density  <- sph_tpu/ops/pair_kernels.py:make_density_pass, and
//               make_rho_star_pass(raw=False) (the same function of the
//               iteration pack)
//   RhoStar  <- sph_tpu/ops/pair_kernels.py:make_rho_star_pass (raw sums)
//   ViscSurf <- sph_tpu/ops/pair_kernels.py:make_viscsurf_pass
//   PAccel   <- sph_tpu/ops/pair_kernels.py:make_paccel_pass
//   Boundary <- sph_tpu/ops/pair_kernels.py:make_boundary_pass
//   Spring   <- sph_tpu/ops/pair_kernels.py:make_spring_pass
//   Membrane <- sph_tpu/ops/pair_kernels.py:make_membrane_pass
// The plain PyTorch versions in sph_tpu_torch/ops/pair_kernels.py compute
// the same sums and are what the kernels are checked against.
//
// Two drivers and a list kernel. pair_ring<P, R, TPR, STAGES, ROWS_CTA,
// Exit, Gated, CHUNK> runs Density, RhoStar, ViscSurf, PAccel,
// Boundary and Membrane, each launch after its box kernel
// pair_ring_boxes<CHUNK> (the box cull's column boxes, see below; the same
// entry point launches both); spring_list runs Spring. pair_pass<P,
// Gated>, the first design, runs no pass of the engines: it keeps the
// first designs of the seven redesigned kernels for chip_smoke.py's
// comparison (the sph_pair_<kind>_prev entry points), as the
// sph_pair_<kind>_nocull entry points keep pair_ring without the box cull
// (CHUNK 0). The functors below are shared by the drivers.
//
// pair_pass: one CTA per own block, one thread per own row (blockDim =
// block).
// A thread reads its own fields from the column-major pack at
// ob + b*block + tid (coalesced: the packs are SoA). The block's tiles come
// straight from the 6-tuple chunk tables (tile s -> chunk
// c = 3b + (s >= s0[3b+1]) + (s >= s0[3b+2]), column
// aln[c] + (s - s0[c]) * ccol) with no static caps, so no tile is dropped.
// Each tile's slab rows x ccol f32 are staged in shared memory by the whole
// CTA (coalesced rows; sizes below), then every thread
// loops over the tile's columns with f32 register accumulators; the
// shared-memory reads are warp broadcasts. Reductions are direct f32 sums:
// the TPU's bf16-split MXU dots, identity-matmul transposes, group-of-8
// blocks and DMA ring exist only for the TPU and are not carried over.
// Masking follows the maskless invariant of the JAX module: a tile's
// columns outside the block's window are >= h away (every term vanishes)
// and pad columns sit at `far`. Tile columns beyond the slab width are
// skipped, own rows beyond the own width write zeros.
//
// Shared memory per CTA = slab rows x ccol x 4 B, one tile, dynamic. The
// five liquid passes stage 3-7 rows (at most 7 x 512 x 4 B = 14 KB).
// Membrane's first design stages 45 of its pack's 48 rows (the x(t) rows
// are not read): 45 x 256 x 4 B = 46,080 B, under the 48 KB default.
// Spring's first design stages 3 + 3 * n_slots rows, a scene property
// passed at run time: 51 rows x 256 x 4 B = 52,224 B at 16 slots (the
// worm), 101,376 B at 32; above 48 KB the launcher opts in with
// cudaFuncAttributeMaxDynamicSharedMemorySize (the card allows 227 KB a
// CTA).
//
// What bounds it on this card: pair arithmetic. A moving row meets ~1.6k
// candidate columns per liquid pass (~13-29 flops each; Density 13, as
// RhoStar: its epilogue is one clamp a row, fused into store); slab bytes
// are reused from shared memory by all 256 rows of the block, so
// device-memory traffic is small. Membrane tests the distance first and
// runs the 7-triangle side test (~170 flops) only within r0 of the column,
// where the weight is nonzero: the sums are unchanged, every skipped term
// is w = 0. In this driver the loads of a tile are not overlapped with the
// compute of the previous one and every field is read as a scalar.
//
// spring_list (Spring). As a pair pass Spring compared the own row's
// sorted id with each candidate column's n_slots partner ids (~90
// operations a pair at 16 slots) to find the worm's 137,804 slot entries
// among ~10^8 candidate pairs: its time was the id compares. The list
// (ops/pair_kernels.py spring_list, built once per resort period) holds
// only the entries that match, a CSR over the own rows in the order the
// pair pass meets them (tile, column, slot), so the kernel's work is
// O(springs): one thread a row walks its entries, merges consecutive
// entries of one column and adds Spring::term, the code the pair pass runs
// for a matched column. Same pairs, same order, same expressions: its sums
// are bitwise the pair pass's. Bound: bytes, the entries (4 B), their
// rest and activation terms and the columns' positions, row_ptr and the
// outputs: a few MB, a few microseconds, so its time is the launch's.
//
// pair_ring, for the kernels that take most of a step (PAccel 6, RhoStar
// 12, ViscSurf 2, Boundary 1 and Membrane 1 launches a fastw worm step;
// Density 4 a fast-engine step, 32 % of the device-bound dam-break's).
// What held them back in pair_pass: (1) on the worm's launch shapes (510
// and ~208 blocks of 256 rows, 3-4 tiles each) one CTA a block leaves the
// card in one partial wave set by its heaviest blocks; (2) one scalar LDS
// a field a pair (5 against ~25 FP32 instructions in PAccel, 3 against ~10
// in RhoStar and Density, 7 in ViscSurf and Boundary) takes issue slots
// from the FP32 pipe that bounds them; (3) tiles staged by plain loads and
// two barriers, not overlapped with compute; (4) PAccel, ViscSurf and
// Boundary ran their bodies (and ViscSurf and Boundary their IEEE sqrtf)
// for every candidate pair, ~97 % of them beyond h (Boundary's weight
// reaches only r0 = h/2);
// (5) Membrane staged 45 rows a tile (46 KB: few CTAs an SM, ~45 scalar
// loads a thread a tile) where the distance test that ends almost every
// pair reads 3. The design:
//  * a ring of STAGES tiles in dynamic shared memory, each filled by one
//    thread with one 1-D bulk copy (cp.async.bulk, the TMA) a slab row and
//    completed on an mbarrier (arrive.expect_tx), so tile s+1.. land while
//    tile s is computed; one __syncthreads a tile frees its stage for the
//    refill. The slab must be 16-byte aligned with a width and ccol that
//    are multiples of 4, and every tile offset aln[c] + k * ccol a
//    multiple of 4 (launch_ring refuses the first three; the tables' aln
//    are multiples of ALIGN = 128 by construction);
//  * each field is read as a float4 over 4 consecutive columns (a warp
//    broadcast), and a thread may hold R own rows, so one LDS.128 feeds
//    4 R pairs: NF / (4 R) shared loads a pair (PAccel NF = 5, RhoStar 3,
//    ViscSurf 7);
//  * a row may be split over TPR threads (part q takes the row's 4-column
//    groups q, q + TPR, ...) whose partial sums are added at the end in a
//    fixed order (shuffles: pairs, then pairs of pairs), so more warps are
//    in flight than there are rows: the worm has too few rows to fill the
//    card with one thread a row (~31 warps an SM on its largest launch);
//  * a CTA takes ROWS_CTA rows of a block, not the whole block (block /
//    ROWS_CTA CTAs a block, each streaming the block's tiles), so the
//    worm's launches give several CTAs an SM and the load evens out;
//  * the early exits (Exit) skip a pair's body where every term is an
//    exact zero, so the sums are unchanged: PAccel's where tt = 0 and
//    cm <= 0 as computed; ViscSurf's, Boundary's and Membrane's where r2 >=
//    their reach, before the sqrtf (see each functor); the distance test
//    still runs for every pair;
//  * a functor's staged rows need not start at slab row 0 (kRow0): the
//    ring stages only the rows that every pair reads. Membrane stages
//    x(t+1) (rows 42-44: 3 x ccol x 4 B a stage, 6 KB at 2 stages of 256
//    columns) and reads a near pair's 42 triangle floats from device memory
//    by the read-only path (RegCol::slab; the worm's whole pack is ~2 MB
//    and stays in L2).
// Density (the time-t density and rho*, 4 launches a fast-engine step, a
// third of the device-bound dam-break's step on pair_pass) is RhoStar's
// sum with the clamp fused into store. What bounds it on this card: the
// FP32 pipe's issue slots. A pair is 13 flops, which chip_smoke.py's bound
// charges at 67 TFLOP/s, an FFMA counting two; but it issues ~10
// FP32-pipe instructions, three of them FFMAs, so the pipe caps it at
// ~13 / 20 = 0.65 of that bound. pair_pass added one scalar LDS a field a
// pair, tiles staged between two barriers and one CTA of 256 threads a
// block. The ring reads 3 float4 for 4 columns shared by R = 2 rows (3/8
// LDS a pair), overlaps the tile copies with the sums and takes 128 rows a
// CTA, TPR 2 (its matrix, PERF.md; the dam-break's 3,592 blocks fill the
// card, TPR 4 won only on the fast worm's 912). Under the box cull R = 1
// won (16 rows a warp: a tighter box than 32), 0.40 ms a launch on the
// dam-break against 0.85 unculled (PERF.md).
// Each row meets its tiles in table order and each thread its columns in
// ascending order, adding the functor's f32 expressions as written. With
// TPR 1 a row's sums are bitwise those of pair_pass; with TPR > 1 they
// are the same on every run but differ from pair_pass's by the rounding of
// the split (chip_smoke.py holds them to the kernel tolerance). Stages, R,
// TPR, ROWS_CTA and Exit were chosen by timing a matrix of them on the card
// (PERF.md): R 1-2, TPR 4 and 64 rows a CTA won on the worm's launches, R 4
// spilled and lost (ViscSurf, Boundary and Membrane: their own matrices,
// PERF.md; TPR 2 won for the three, and 128 rows a CTA for Membrane;
// Density: R 2, TPR 2, 128 rows a CTA on the dam-break). With the box cull
// the matrix was timed again with TPR fixed (CHUNK 16, 32, 64; R, STAGES
// and ROWS_CTA each moved): 16-column chunks won for every kind (RhoStar:
// 32 a tie), so CHUNK is one constant; Density took R 1, and STAGES 3-4
// and other ROWS_CTA moved nothing beyond the noise or spilled (PERF.md).
// The shipped values are owned by ops/pair_kernels.py (RING, CHUNK) and
// reach this file as -DSPH_<KIND>_<FIELD> and -DSPH_RING_CHUNK defines
// from ops/_build.py.
//
// The subgroup gate (Gated = true; Density, ViscSurf, PAccel). A block's
// window is the union of its rows' reach: a 256-row block spans several
// pencils, so every row meets the columns of all of them. With the gate,
// rows g*sub .. (g+1)*sub-1 compute a tile only when its columns
// [off, off + ccol) overlap one of the group's three dz-band windows
// [glo, ghi) (tables at (3b + dz) * (block/sub) + g). Each thread loads its
// group's six window bounds into registers once (pair_ring: six a row, or
// six a thread where its rows share a subgroup); per tile the test is six
// integer compares. What it saves is the pair
// arithmetic that bounds these passes: on the worm the JAX records count
// 1,617 -> 819 computed columns a particle at sub 32, ccol 128
// (sph_tpu/core/fast.py:55-60). At sub 32 a group is one warp and the skip
// is warp-uniform (no divergence); at sub 8 and 16 lanes of a warp idle
// while others compute. Every thread still stages the tile and meets the
// barriers. A skipped term is an exact zero at sort time (the windows are
// the maskless windows of the group), and the tiles and columns keep their
// order, so a row's sum is the ungated one.
//
// The box cull (CHUNK > 0 in pair_ring). What it bounds: the candidate
// set. A block's tiles hold whole pencils of three z-bands, so a row meets
// every column of up to ~12 pencils and ~98 % of the pairs a pass
// evaluates lie beyond h (1.2 % within h on the dam-break, 1.8 % on the
// worm's moving rows): the FP32 pipe that bounds the passes spends its
// issue slots on exact zeros. Columns are sorted by (pencil, y) and so are
// a warp's rows, so an aligned run of CHUNK columns and a warp's run of
// rows are compact boxes in space. pair_ring_boxes (launched by
// launch_ring just before the ring kernel, on the slab it is given, into
// the caller's buffer; named for the driver it serves, so profiles count
// it with the pair kernels) writes each aligned CHUNK-column run's box,
// min and max of the three position rows the distance test reads (rows
// kRow0 .. kRow0 + 2), from exactly the f32 values the ring stages; pad
// columns at `far` only widen a box. pair_ring reduces its warp's live
// rows to one box at start (shuffles); per tile, lane c loads chunk c's
// box, computes the squared gap g2 between the two boxes and the warp
// ballots the chunks with g2 < cull; the j loop then runs over the kept
// chunks only. A tile wider than 32 CHUNK (ccol above 512, which no
// engine's default makes) runs the unculled kernel instead: one lane a
// chunk keeps the test one ballot. One test a (warp, chunk) stands for
// 32 R / TPR x CHUNK pairs. The warp's rows are one consecutive
// run (a thread's R rows are consecutive), so its box is tight.
//
// Why the sums stay bitwise. cull is the functor's cull reach: an f32 r2
// at or above which the kernel's every term of the pair is an exact zero,
// raised by a margin (ops/pair_kernels.py PairPass.cull_reach): Density
// and RhoStar h2 (q = fmaxf(h2 - r2, 0) is +0), ViscSurf, Boundary and
// Membrane their exit's reach, each x (1 + 2^-20) rounded up; PAccel h2 x
// (1 + 2^-18) (r = r2 rsqrtf(r2) >= h, so tt = 0 and cm < 0). The margin
// covers the rounding between the box test and the pair: rounding is
// monotone, so |dx| as computed is at least the gap as computed on each
// axis; a sum of three squares, fused or not, is within (1 +- u)^3 of its
// exact value (u = 2^-24), so the pair's r2 >= g2 (1 - 6.1 u); Density's
// h2 - r2, however nvcc contracts it, is negative once r2 >= h2 (1 + 6 u);
// rsqrtf's 2 ulps and r's rounding take r below sqrt(r2) by < 5 u. 16 u
// (64 u for PAccel) holds all of them with room. A culled pair therefore
// adds +0 to a sum that is +0 or positive (Density, RhoStar: no change)
// or is one the exit skips anyway (the others), and the kept columns are
// met in the same order by the same part q (CHUNK is a multiple of 4 TPR),
// so with TPR unchanged every output is bitwise the unculled kernel's. A
// tile whose offset is not a multiple of CHUNK, which the tables never
// make (aln is a multiple of ALIGN = 128), is computed whole. counts, when
// not null (the graphs the tracer replays), gets each warp's chunks tested
// and culled, one atomic each at its end.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: sqrtf, rsqrtf and division keep
// their IEEE behaviour). Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

// A column of a staged tile as the functors of the ring driver read it:
// t(f) is staged field f (slab row P::kRow0 + f), t.slab(r) is slab row r
// of the same column, staged or not. TileCol reads shared memory, where
// pair_pass stages every slab row a pass reads from row 0 (field f at
// t[(row0 + f) * ccol + j]); RegCol<C> reads component C of the float4
// that the ring driver loaded for field f (columns j .. j + 3), and an
// unstaged row from device memory at the column's slab index col (the
// read-only path). Both give a functor the same floats; functors that read
// only staged fields never touch slab() and pay nothing for it.
struct TileCol {
  const float* t;
  int ccol, j;
  int row0 = 0;
  __device__ float operator()(int f) const { return t[(row0 + f) * ccol + j]; }
  __device__ float slab(int r) const { return t[r * ccol + j]; }
};

template <int C>
struct RegCol {
  const float4* v;
  const float* g;  // the slab pack, [rows][w]
  long long w, col;
  __device__ float operator()(int f) const {
    return C == 0 ? v[f].x : C == 1 ? v[f].y : C == 2 ? v[f].z : v[f].w;
  }
  __device__ float slab(int r) const { return __ldg(g + r * w + col); }
};

struct Density {
  // slab rows: x, y, z (the main pack, or the predicted positions)
  static constexpr int kRows = 3, kRow0 = 0;
  __host__ __device__ constexpr int slab_rows() const { return kRows; }
  struct Own { float x, y, z; };
  struct Acc { float s; };
  float h2, self3, inv_h6, c_rho;

  __device__ Own load(const float* own, long long w, long long i) const {
    return {own[i], own[w + i], own[2 * w + i]};
  }
  // t(f): field f of the column (see TileCol, RegCol). No exit: one
  // skipping the pair where h2 - r2 <= 0 (exact: the term is a zero) won
  // in no configuration on the card (up to 4 % slower on the dam-break),
  // the body after the test being ~4 instructions. Box cull reach: h2 (1
  // + 2^-20), rounded up: at r2 >= h2 (1 + 6 u) h2 - r2 is negative
  // however nvcc contracts it, so q = +0 and the sum is unchanged
  template <bool Exit, class T>
  __device__ void pair_at(const Own& o, const T& t, Acc& a) const {
    const float dx = o.x - t(0);
    const float dy = o.y - t(1);
    const float dz = o.z - t(2);
    const float q = fmaxf(h2 - (dx * dx + dy * dy + dz * dz), 0.0f);
    a.s += q * q * q;
  }
  __device__ void pair(const Own& o, const float* t, int ccol, int j,
                       Acc& a) const {
    pair_at<false>(o, TileCol{t, ccol, j}, a);
  }
  // the wrapper's epilogue, fused: the self term (included in the sum) is
  // subtracted exactly as f32 (h2 h2) h2, then scaled and clamped. A row
  // without a tile (a gated-out wall block, a phantom) sums 0: c_rho
  __device__ void store(float* out, long long n, long long i,
                        const Acc& a) const {
    out[i] = c_rho * fmaxf((a.s - self3) * inv_h6, 1.0f);
  }
};

struct RhoStar {
  // slab rows: predicted x, y, z
  static constexpr int kRows = 3, kRow0 = 0;
  __host__ __device__ constexpr int slab_rows() const { return kRows; }
  struct Own { float x, y, z; };
  struct Acc { float s; };
  float h2;

  __device__ Own load(const float* own, long long w, long long i) const {
    return {own[i], own[w + i], own[2 * w + i]};
  }
  // t(f): field f of the column (see TileCol, RegCol). Box cull reach:
  // Density's, h2 (1 + 2^-20)
  template <bool Exit, class T>
  __device__ void pair_at(const Own& o, const T& t, Acc& a) const {
    const float dx = o.x - t(0);
    const float dy = o.y - t(1);
    const float dz = o.z - t(2);
    const float q = fmaxf(h2 - (dx * dx + dy * dy + dz * dz), 0.0f);
    a.s += q * q * q;
  }
  __device__ void pair(const Own& o, const float* t, int ccol, int j,
                       Acc& a) const {
    pair_at<false>(o, TileCol{t, ccol, j}, a);
  }
  __device__ void store(float* out, long long n, long long i,
                        const Acc& a) const {
    out[i] = a.s;
  }
};

struct ViscSurf {
  // slab rows: x, y, z, vx, vy, vz, 1/rho
  static constexpr int kRows = 7, kRow0 = 0;
  __host__ __device__ constexpr int slab_rows() const { return kRows; }
  struct Own { float x, y, z, vx, vy, vz; };
  struct Acc { float vx, vy, vz, sx, sy, sz; };
  // reach: the least f32 r2 at which both terms are exact zeros,
  // max(h2, the least t with sqrtf(t) >= h) (ops/pair_kernels.py)
  float h, h2, inv_h, reach;

  __device__ Own load(const float* own, long long w, long long i) const {
    return {own[i], own[w + i], own[2 * w + i],
            own[3 * w + i], own[4 * w + i], own[5 * w + i]};
  }
  // Exit: skip the pair before its sqrtf where r2 >= reach: there
  // h - sqrtf(r2) <= 0 (sqrtf is correctly rounded, so monotone) and not
  // r2 < h2, so both terms are exact zeros and the sums are unchanged.
  // Box cull reach: reach (1 + 2^-20), rounded up: the pair's r2 as
  // computed is then >= reach, a pair the exit skips
  template <bool Exit, class T>
  __device__ void pair_at(const Own& o, const T& t, Acc& a) const {
    const float dx = o.x - t(0);
    const float dy = o.y - t(1);
    const float dz = o.z - t(2);
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (Exit && r2 >= reach) return;
    const float wv = fmaxf(h - sqrtf(r2), 0.0f) * t(6);
    a.vx += wv * (t(3) - o.vx);
    a.vy += wv * (t(4) - o.vy);
    a.vz += wv * (t(5) - o.vz);
    if (r2 < h2) {
      a.sx += dx;
      a.sy += dy;
      a.sz += dz;
    }
  }
  __device__ void pair(const Own& o, const float* t, int ccol, int j,
                       Acc& a) const {
    pair_at<false>(o, TileCol{t, ccol, j}, a);
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
  // slab rows: x, y, z, 1/rho*, p
  static constexpr int kRows = 5, kRow0 = 0;
  __host__ __device__ constexpr int slab_rows() const { return kRows; }
  struct Own { float x, y, z, p; };
  struct Acc { float x, y, z; };
  float h, h4, rho0_delta, out_c;

  __device__ Own load(const float* own, long long w, long long i) const {
    return {own[i], own[w + i], own[2 * w + i], own[4 * w + i]};
  }
  // Exit: skip the force body where every term is an exact zero (r >= h:
  // tt = 0 and the close branch is off), tested on r as computed. Box
  // cull reach: h^2 (1 + 2^-18), rounded up: rsqrtf's 2 ulps and r's
  // rounding take r = r2 rsqrtf(r2) below sqrt(r2) by < 5 u, which 32 u
  // on r covers, so r >= h and the exit skips the pair
  template <bool Exit, class T>
  __device__ void pair_at(const Own& o, const T& t, Acc& a) const {
    const float dx = o.x - t(0);
    const float dy = o.y - t(1);
    const float dz = o.z - t(2);
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (!(r2 > 0.0f)) return;  // self and coincident pairs
    const float inv_r = rsqrtf(fmaxf(r2, 1e-30f));
    const float r = r2 * inv_r;
    const float tt = fmaxf(h - r, 0.0f);
    const float cm = h4 - r;
    if (Exit && tt == 0.0f && !(cm > 0.0f)) return;
    const float term = (cm > 0.0f ? cm * cm * rho0_delta
                                  : tt * tt * (o.p + t(4)))
                       * t(3);
    const float w = term * inv_r;
    a.x += w * dx;
    a.y += w * dy;
    a.z += w * dz;
  }
  __device__ void pair(const Own& o, const float* t, int ccol, int j,
                       Acc& a) const {
    pair_at<false>(o, TileCol{t, ccol, j}, a);
  }
  __device__ void store(float* out, long long n, long long i,
                        const Acc& a) const {
    out[i] = a.x * out_c;
    out[n + i] = a.y * out_c;
    out[2 * n + i] = a.z * out_c;
  }
};

struct Boundary {
  // slab rows: x, y, z, nx, ny, nz, is_boundary
  static constexpr int kRows = 7, kRow0 = 0;
  __host__ __device__ constexpr int slab_rows() const { return kRows; }
  struct Own { float x, y, z; };       // post-integrate positions
  struct Acc { float nx, ny, nz, w, w2; };
  // reach: the least f32 r2 with sqrtf(r2) >= r0 (ops/pair_kernels.py
  // sqrt_reach)
  float r0, inv_r0, reach;

  __device__ Own load(const float* own, long long w, long long i) const {
    return {own[3 * w + i], own[4 * w + i], own[5 * w + i]};
  }
  // Exit: skip the pair before its sqrtf where r2 >= reach. There
  // sqrtf(r2) >= r0 (sqrtf is correctly rounded, so monotone), so d <= 0
  // and w = fmaxf(0, d inv_r0) isb is +0 or -0; every term it adds (w n,
  // w, w d) is then +0 or -0, and adding a zero to the accumulators (which
  // start at +0) changes none of them: the sums are bitwise those without
  // the exit. Box cull reach: reach (1 + 2^-20), rounded up (ViscSurf's
  // argument)
  template <bool Exit, class T>
  __device__ void pair_at(const Own& o, const T& t, Acc& a) const {
    const float dx = o.x - t(0);
    const float dy = o.y - t(1);
    const float dz = o.z - t(2);
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (Exit && r2 >= reach) return;
    const float d = r0 - sqrtf(r2);
    const float w = fmaxf(0.0f, d * inv_r0) * t(6);
    a.nx += w * t(3);
    a.ny += w * t(4);
    a.nz += w * t(5);
    a.w += w;
    a.w2 += w * d;
  }
  __device__ void pair(const Own& o, const float* t, int ccol, int j,
                       Acc& a) const {
    pair_at<false>(o, TileCol{t, ccol, j}, a);
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

struct Spring {
  // slab rows: x, y, z, then n_slots partner ids (sorted row ids as f32, -1
  // pad), n_slots rest lengths (m), n_slots activation force terms
  __host__ __device__ int slab_rows() const { return 3 + 3 * n_slots; }
  struct Own { float x, y, z, gid; };
  struct Acc { float x, y, z; };
  float inv_h, inv_h_sq, h_scale, k_spring;
  int n_slots;

  // i is the own row's sorted id (its column in the own pack)
  __device__ Own load(const float* own, long long w, long long i) const {
    return {own[i], own[w + i], own[2 * w + i], (float)i};
  }
  // the pair pass (the first design, kept for chip_smoke.py's comparison)
  __device__ void pair(const Own& o, const float* t, int ccol, int j,
                       Acc& a) const {
    float msum = 0.0f, rest = 0.0f, actf = 0.0f;
    const float* ids = t + 3 * ccol + j;
    const int n = n_slots;
    for (int s = 0; s < n; ++s) {
      if (ids[s * ccol] == o.gid) {  // a partner listed twice counts twice
        msum += 1.0f;
        rest += ids[(n + s) * ccol];
        actf += ids[(2 * n + s) * ccol];
      }
    }
    if (!(msum > 0.0f)) return;
    term(o, t[j], t[ccol + j], t[2 * ccol + j], msum, rest, actf, a);
  }
  // one (own row, column) term, the column's matched slots summed; the
  // pair pass and the list kernel share it, so nvcc contracts the same FMAs
  __device__ __forceinline__ void term(const Own& o, float xj, float yj,
                                       float zj, float msum, float rest,
                                       float actf, Acc& a) const {
    const float dx = o.x - xj;
    const float dy = o.y - yj;
    const float dz = o.z - zj;
    const float q2 = (dx * dx + dy * dy + dz * dz) * inv_h_sq;
    if (!(q2 > 0.0f)) return;
    const float inv_q = rsqrtf(fmaxf(q2, 1e-30f));
    const float r_m = q2 * inv_q * h_scale;  // r in meters
    const float coef = -(r_m * msum - rest) * k_spring - actf;
    const float w = coef * inv_q * inv_h;
    a.x += w * dx;
    a.y += w * dy;
    a.z += w * dz;
  }
  __device__ void store(float* out, long long n, long long i,
                        const Acc& a) const {
    out[i] = a.x;
    out[n + i] = a.y;
    out[2 * n + i] = a.z;
  }
};

struct Membrane {
  // slab rows: 7 x (unit normal, vertex) at 6t..6t+5, then x(t+1) at 42-44.
  // The ring stages x(t+1) alone (kRows from kRow0), what the distance test
  // reads for every pair; the triangle rows are read per pair within r0
  // (t.slab); pair_pass stages rows 0-44
  static constexpr int kRows = 3, kRow0 = 42;
  __host__ __device__ constexpr int slab_rows() const { return kRow0 + kRows; }
  struct Own { float x, y, z; };       // post-integrate positions
  struct Acc { float nx, ny, nz, w, w2; };
  // reach: the least f32 r2 with sqrtf(r2) >= r0 (ops/pair_kernels.py
  // sqrt_reach)
  float r0, reach;

  __device__ Own load(const float* own, long long w, long long i) const {
    return {own[3 * w + i], own[4 * w + i], own[5 * w + i]};
  }
  // beyond r0 the weight is 0 and every term of the five sums with it: the
  // pair returns at !(d > 0). Exit tests the same predicate before the
  // sqrtf: r2 >= reach exactly where sqrtf(r2) >= r0, i.e. d <= 0. Box
  // cull reach: reach (1 + 2^-20), rounded up (ViscSurf's argument)
  template <bool Exit, class T>
  __device__ void pair_at(const Own& o, const T& t, Acc& a) const {
    const float dx = o.x - t(0);
    const float dy = o.y - t(1);
    const float dz = o.z - t(2);
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (Exit && r2 >= reach) return;
    const float d = r0 - sqrtf(r2);
    if (!(d > 0.0f)) return;
    float cnt = 0.0f, vx = 0.0f, vy = 0.0f, vz = 0.0f;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const float nx = t.slab(6 * k), ny = t.slab(6 * k + 1),
                  nz = t.slab(6 * k + 2);
      const float s = (o.x - t.slab(6 * k + 3)) * nx
                      + (o.y - t.slab(6 * k + 4)) * ny
                      + (o.z - t.slab(6 * k + 5)) * nz;
      if (nx * nx + ny * ny + nz * nz > 0.0f && s != 0.0f) {
        const float sgn = s > 0.0f ? 1.0f : -1.0f;
        cnt += 1.0f;
        vx += sgn * nx;
        vy += sgn * ny;
        vz += sgn * nz;
      }
    }
    if (!(cnt > 0.0f)) return;  // a column without a triangle
    const float w = fmaxf(0.0f, d / r0);
    const float wc = w * (1.0f / fmaxf(cnt, 1.0f));
    a.nx += wc * vx;
    a.ny += wc * vy;
    a.nz += wc * vz;
    a.w += w;
    a.w2 += w * d;
  }
  __device__ void pair(const Own& o, const float* t, int ccol, int j,
                       Acc& a) const {
    pair_at<false>(o, TileCol{t, ccol, j, kRow0}, a);
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

template <class P, bool Gated>
__global__ void __launch_bounds__(1024)
pair_pass(P p, const float* __restrict__ own, long long own_w,
          const float* __restrict__ slab, long long slab_w,
          const int* __restrict__ aln, const int* __restrict__ s0,
          const int* __restrict__ cnt, const int* __restrict__ ob,
          const int* __restrict__ glo, const int* __restrict__ ghi, int sub,
          float* __restrict__ out, int ccol) {
  extern __shared__ float tile[];  // [slab_rows][ccol]
  const int b = blockIdx.x;
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const long long n_pad = (long long)gridDim.x * nthr;
  const long long i_out = (long long)b * nthr + tid;
  const long long row = (long long)ob[0] + i_out;
  const bool live = row >= 0 && row < own_w;
  const typename P::Own o = p.load(own, own_w, live ? row : 0);
  typename P::Acc acc{};
  // the gate: this thread's group's three column windows
  int wlo[3] = {0, 0, 0}, whi[3] = {0, 0, 0};
  if (Gated) {
    const int ng = nthr / sub;
    const int g = tid / sub;
    for (int d = 0; d < 3; ++d) {
      wlo[d] = glo[(3 * b + d) * ng + g];
      whi[d] = ghi[(3 * b + d) * ng + g];
    }
  }

  const int n_rows = p.slab_rows();
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
    for (int r = 0; r < n_rows; ++r) {
      const float* src = slab + (long long)r * slab_w + off;
      for (int j = tid; j < ncol; j += nthr) tile[r * ccol + j] = src[j];
    }
    __syncthreads();
    bool on = live;
    if (Gated) {
      const long long end = off + ccol;
      on = on && ((whi[0] > off && wlo[0] < end) ||
                  (whi[1] > off && wlo[1] < end) ||
                  (whi[2] > off && wlo[2] < end));
    }
    if (on) {
#pragma unroll 4
      for (int j = 0; j < ncol; ++j) p.pair(o, tile, ccol, j, acc);
    }
  }
  if (!live) acc = typename P::Acc{};
  p.store(out, n_pad, i_out, acc);
}

template <bool Gated, class P>
int launch(const P& p, const float* own, long long own_w, const float* slab,
           long long slab_w, const int* aln, const int* s0, const int* cnt,
           const int* ob, const int* glo, const int* ghi, int sub,
           float* out, int n_blocks, int block, int ccol, void* stream) {
  if (n_blocks <= 0) return (int)cudaGetLastError();
  if (Gated && (sub <= 0 || block % sub != 0 || !glo || !ghi))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * p.slab_rows() * (size_t)ccol;
  if (smem > 48 * 1024) {  // opt in on every such launch: the grant is per
                           // device, and the call is cheap beside a launch
    cudaError_t e = cudaFuncSetAttribute(
        pair_pass<P, Gated>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pair_pass<P, Gated><<<n_blocks, block, smem, (cudaStream_t)stream>>>(
      p, own, own_w, slab, slab_w, aln, s0, cnt, ob, glo, ghi, sub, out,
      ccol);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The spring list kernel (see the header comment)
// ---------------------------------------------------------------------------

// One own row a thread: the row's entries row_ptr[i] .. row_ptr[i+1] - 1
// (entry j * n_slots + s: slot s of slab column j), consecutive entries of
// one column merged (their slots summed in slot order, as Spring::pair sums
// the slots that match), one term a column, in the list's order: the pair
// pass's. Entries outside the slab's slots are skipped.
__global__ void __launch_bounds__(256)
spring_list(Spring p, const float* __restrict__ own, long long own_w,
            const float* __restrict__ slab, long long slab_w,
            const int* __restrict__ row_ptr, const int* __restrict__ ent,
            const int* __restrict__ ob, float* __restrict__ out, int n_pad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  const long long row = (long long)ob[0] + i;
  Spring::Acc acc{};
  if (row >= 0 && row < own_w) {
    const Spring::Own o = p.load(own, own_w, row);
    const int n = p.n_slots;
    const long long cap = (long long)n * slab_w;
    int e = row_ptr[i];
    const int end = row_ptr[i + 1];
    while (e < end) {
      const int v = ent[e];
      if (v < 0 || v >= cap) {
        ++e;
        continue;
      }
      const int j = v / n;
      const int lo = j * n;
      float msum = 0.0f, rest = 0.0f, actf = 0.0f;
      int w = v;
      do {
        const long long s = w - lo;
        msum += 1.0f;
        rest += slab[(3 + n + s) * slab_w + j];
        actf += slab[(3 + 2 * n + s) * slab_w + j];
        ++e;
      } while (e < end && (w = ent[e]) >= lo && w < lo + n);
      p.term(o, slab[j], slab[slab_w + j], slab[2 * slab_w + j], msum, rest,
             actf, acc);
    }
  }
  p.store(out, n_pad, i, acc);
}

// ---------------------------------------------------------------------------
// The ring driver (RhoStar, ViscSurf, PAccel, Boundary, Membrane; see
// the header comment)
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

// one arrival that also sets the bytes the phase waits for
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spin > (1ll << 24)) __trap();  // a tile that never lands: fail
  }
}

// 1-D bulk copy (TMA) global -> shared, completion counted on ``bar``
__device__ __forceinline__ void bulk_load(unsigned dst, const float* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// first slab column and column count of tile s of block b (pair_pass's
// arithmetic)
__device__ __forceinline__ void tile_at(const int* aln, const int* s0, int b,
                                        int s1, int s2, int s, int ccol,
                                        long long slab_w, long long& off,
                                        int& ncol) {
  const int c = 3 * b + (s >= s1) + (s >= s2);
  off = (long long)aln[c] + (long long)(s - s0[c]) * ccol;
  long long avail = slab_w - off;
  if (off < 0) avail = 0;
  ncol = (int)(avail < ccol ? (avail > 0 ? avail : 0) : ccol);
}

// Tile s into ring stage s % STAGES: one arrival with its byte count, then
// one bulk copy per staged slab row (rows ROW0 .. ROW0 + NF - 1). Called by
// one thread.
template <int NF, int ROW0, int STAGES>
__device__ __forceinline__ void fetch_tile(const float* slab, long long slab_w,
                                           const int* aln, const int* s0,
                                           int b, int s1, int s2, int s,
                                           int ccol, unsigned ring0,
                                           unsigned bar0) {
  long long off;
  int ncol;
  tile_at(aln, s0, b, s1, s2, s, ccol, slab_w, off, ncol);
  const int st = s % STAGES;
  const unsigned bar = bar0 + 8u * st;
  mbar_expect(bar, 4u * NF * ncol);
  if (ncol > 0) {
#pragma unroll
    for (int f = 0; f < NF; ++f)
      bulk_load(ring0 + 4u * (unsigned)((st * NF + f) * ccol),
                slab + (long long)(ROW0 + f) * slab_w + off, 4u * ncol, bar);
  }
}

// One column C of the four a float4 load holds (slab column col + C), for
// each of a thread's R rows.
template <int C, bool Exit, int R, class P>
__device__ __forceinline__ void ring_column(const P& p,
                                            const typename P::Own* o,
                                            const float4* v,
                                            const float* slab,
                                            long long slab_w, long long col,
                                            typename P::Acc* acc) {
  const RegCol<C> t{v, slab, slab_w, col + C};
#pragma unroll
  for (int k = 0; k < R; ++k) p.template pair_at<Exit>(o[k], t, acc[k]);
}

// The box of each aligned run of CHUNK slab columns (see the header
// comment): boxes[2 b] = (min x, min y, min z, 0), boxes[2 b + 1] = the
// maxima, over columns b CHUNK .. b CHUNK + CHUNK - 1 below slab_w of slab
// rows row0 .. row0 + 2. One warp a 128 columns, a float4 a lane and
// field (the slab is 16-byte aligned with a width that is a multiple of
// 4), then xor shuffles over the CHUNK / 4 lanes of a chunk. Bound: bytes,
// 12 a column read, 32 a chunk written.
template <int CHUNK>
__global__ void __launch_bounds__(256)
pair_ring_boxes(const float* __restrict__ slab, long long slab_w, int row0,
                float4* __restrict__ boxes) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long col = warp * 128 + 4 * lane;
  const bool in = col < slab_w;
  float lo[3], hi[3];
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    lo[f] = __int_as_float(0x7f800000);   // +inf: an empty box
    hi[f] = -lo[f];
    if (in) {
      const float4 v = *reinterpret_cast<const float4*>(
          slab + (long long)(row0 + f) * slab_w + col);
      lo[f] = fminf(fminf(v.x, v.y), fminf(v.z, v.w));
      hi[f] = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
    }
  }
#pragma unroll
  for (int m = 1; m < CHUNK / 4; m <<= 1) {
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      lo[f] = fminf(lo[f], __shfl_xor_sync(0xffffffffu, lo[f], m));
      hi[f] = fmaxf(hi[f], __shfl_xor_sync(0xffffffffu, hi[f], m));
    }
  }
  if (in && lane % (CHUNK / 4) == 0) {
    const long long c = col / CHUNK;
    boxes[2 * c] = make_float4(lo[0], lo[1], lo[2], 0.0f);
    boxes[2 * c + 1] = make_float4(hi[0], hi[1], hi[2], 0.0f);
  }
}

// The box cull's test of the n_ch (<= 32) chunks of the tile at column
// off (a warp's call; see the header comment): lane c loads chunk
// c's box and keeps the chunk where its squared gap to the warp's row box
// (rlo, rhi) lies under cull, or where the tile does not start on a
// multiple of CHUNK; the warp's ballot of the kept chunks.
template <int CHUNK>
__device__ __forceinline__ unsigned cull_ballot(
    const float4* __restrict__ boxes, long long off, int n_ch, float3 rlo,
    float3 rhi, float cull) {
  const int c = (int)(threadIdx.x & 31);
  bool kept = c < n_ch;
  if (kept && off % CHUNK == 0) {
    const long long bi = off / CHUNK + c;
    const float4 lo = __ldg(boxes + 2 * bi);
    const float4 hi = __ldg(boxes + 2 * bi + 1);
    const float gx = fmaxf(fmaxf(lo.x - rhi.x, rlo.x - hi.x), 0.0f);
    const float gy = fmaxf(fmaxf(lo.y - rhi.y, rlo.y - hi.y), 0.0f);
    const float gz = fmaxf(fmaxf(lo.z - rhi.z, rlo.z - hi.z), 0.0f);
    kept = !(gx * gx + gy * gy + gz * gz >= cull);
  }
  return __ballot_sync(0xffffffffu, kept);
}

// R: own rows a thread; TPR: threads a row (part q of a row's TPR threads
// takes its 4-column groups q, q + TPR, ...; the partial sums are added at
// the end in a fixed order); STAGES: tiles in the ring; ROWS_CTA: the
// consecutive rows of one own block a CTA takes (block / ROWS_CTA CTAs a
// block, ROWS_CTA / R * TPR threads); Exit: the functor's early exit;
// Gated: the subgroup gate; CHUNK: the box cull's columns a chunk (0: no
// cull, the unculled form).
// Threads u * TPR .. u * TPR + TPR - 1 share rows u R .. u R + R - 1, so
// each warp covers one run of 32 R / TPR consecutive rows: the box cull's
// row box (a warp's box over two runs would be loose), and in the gated
// form a thread's rows lie in one subgroup (R must divide sub): the thread
// keeps one set of windows and computes a tile for all its rows or for
// none, with no test a row and column (with rows u and u + ROWS_CTA / R,
// which sit in different subgroups, a thread would stream every tile that
// either group takes and test each row at every column: ~1.4x the time on
// the fast worm at sub 32), and a warp's rows lie in one subgroup where
// that many divide sub. A row's sum does not depend on which thread holds
// it; a row that is not live computes a sum that is thrown away.
template <class P, int R, int TPR, int STAGES, int ROWS_CTA, bool Exit,
          bool Gated, int CHUNK>
__global__ void __launch_bounds__(ROWS_CTA / R * TPR)
pair_ring(P p, const float* __restrict__ own, long long own_w,
          const float* __restrict__ slab, long long slab_w,
          const int* __restrict__ aln, const int* __restrict__ s0,
          const int* __restrict__ cnt, const int* __restrict__ ob,
          const int* __restrict__ glo, const int* __restrict__ ghi, int sub,
          float* __restrict__ out, long long n_pad, int block, int ccol,
          const float4* __restrict__ boxes, float cull,
          unsigned long long* __restrict__ counts) {
  constexpr int NF = P::kRows, ROW0 = P::kRow0;
  constexpr unsigned FULL = 0xffffffffu;
  // [STAGES][NF][ccol]: slab rows ROW0 .. ROW0 + NF - 1 of a tile
  extern __shared__ __align__(16) float ring[];
  __shared__ __align__(8) unsigned long long full[STAGES];
  const int splits = block / ROWS_CTA;
  const int b = blockIdx.x / splits;
  const int r_first = (blockIdx.x - b * splits) * ROWS_CTA;
  const int u = threadIdx.x / TPR;
  const int part = threadIdx.x - u * TPR;
  // the thread's first row in its block
  const int r0 = r_first + u * R;

  typename P::Own o[R];
  typename P::Acc acc[R];
  bool live[R];
  bool any_live = false;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const long long row = (long long)ob[0] + (long long)b * block + r0 + k;
    live[k] = row >= 0 && row < own_w;
    any_live = any_live || live[k];
    o[k] = p.load(own, own_w, live[k] ? row : 0);
    acc[k] = typename P::Acc{};
  }
  // the gate: the windows of the thread's subgroup
  int wlo[3], whi[3];
  if (Gated) {
    const int ng = block / sub;
    for (int d = 0; d < 3; ++d) {
      wlo[d] = glo[(3 * b + d) * ng + r0 / sub];
      whi[d] = ghi[(3 * b + d) * ng + r0 / sub];
    }
  }
  // the box cull: the warp's live rows' box (an empty box, +inf to -inf,
  // where none is live: every chunk is culled, the sums are thrown away)
  float3 rlo, rhi;
  unsigned long long n_tested = 0, n_culled = 0;
  if constexpr (CHUNK > 0) {
    const float inf = __int_as_float(0x7f800000);
    rlo = make_float3(inf, inf, inf);
    rhi = make_float3(-inf, -inf, -inf);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (live[k]) {
        rlo = make_float3(fminf(rlo.x, o[k].x), fminf(rlo.y, o[k].y),
                          fminf(rlo.z, o[k].z));
        rhi = make_float3(fmaxf(rhi.x, o[k].x), fmaxf(rhi.y, o[k].y),
                          fmaxf(rhi.z, o[k].z));
      }
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) {
      rlo.x = fminf(rlo.x, __shfl_xor_sync(FULL, rlo.x, m));
      rlo.y = fminf(rlo.y, __shfl_xor_sync(FULL, rlo.y, m));
      rlo.z = fminf(rlo.z, __shfl_xor_sync(FULL, rlo.z, m));
      rhi.x = fmaxf(rhi.x, __shfl_xor_sync(FULL, rhi.x, m));
      rhi.y = fmaxf(rhi.y, __shfl_xor_sync(FULL, rhi.y, m));
      rhi.z = fmaxf(rhi.z, __shfl_xor_sync(FULL, rhi.z, m));
    }
  }

  const int n_s = cnt[b];
  const int s1 = s0[3 * b + 1];
  const int s2 = s0[3 * b + 2];
  const unsigned ring0 = smem_addr(ring);
  const unsigned bar0 = smem_addr(full);
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(bar0 + 8u * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES && s < n_s; ++s)
      fetch_tile<NF, ROW0, STAGES>(slab, slab_w, aln, s0, b, s1, s2, s,
                                   ccol, ring0, bar0);
  }

  for (int s = 0; s < n_s; ++s) {
    long long off;
    int ncol;
    tile_at(aln, s0, b, s1, s2, s, ccol, slab_w, off, ncol);
    bool any = !Gated;
    if (Gated) {
      const long long end = off + ccol;
      any = any_live && ((whi[0] > off && wlo[0] < end) ||
                         (whi[1] > off && wlo[1] < end) ||
                         (whi[2] > off && wlo[2] < end));
    }
    // the box cull: lane c tests chunk c of the tile (columns c CHUNK ..
    // c CHUNK + CHUNK - 1, at most 32 chunks a tile: launch_ring sends a
    // wider tile to the unculled kernel); keep: the warp's ballot of the
    // chunks whose box comes within cull of the warp's
    unsigned keep = 0;
    if constexpr (CHUNK > 0) {
      if (!Gated || __any_sync(FULL, any)) {
        const int n_ch = (ncol + CHUNK - 1) / CHUNK;
        keep = cull_ballot<CHUNK>(boxes, off, n_ch, rlo, rhi, cull);
        if (counts) {
          const unsigned valid = n_ch >= 32 ? FULL : (1u << n_ch) - 1u;
          n_tested += __popc(valid);
          n_culled += __popc(valid & ~keep);
        }
      }
    }
    const int st = s % STAGES;
    mbar_wait(bar0 + 8u * st, (unsigned)(s / STAGES) & 1u);
    if (any) {
      const float* t = ring + st * NF * ccol;
      // columns j .. j + 3 of the tile, each field read as one float4
      auto columns4 = [&](int j) {
        float4 v[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f)
          v[f] = *reinterpret_cast<const float4*>(t + f * ccol + j);
        const long long col = off + j;
        ring_column<0, Exit, R>(p, o, v, slab, slab_w, col, acc);
        ring_column<1, Exit, R>(p, o, v, slab, slab_w, col, acc);
        ring_column<2, Exit, R>(p, o, v, slab, slab_w, col, acc);
        ring_column<3, Exit, R>(p, o, v, slab, slab_w, col, acc);
      };
      if constexpr (CHUNK > 0) {
        // the kept chunks in ascending order; within one, part q's 4-column
        // groups are those it takes in the whole tile (CHUNK is a multiple
        // of 4 TPR)
        for (unsigned m = keep; m; m &= m - 1) {
          const int j0 = (__ffs(m) - 1) * CHUNK;
#pragma unroll
          for (int q = 0; q < CHUNK / (4 * TPR); ++q) {
            const int j = j0 + 4 * (part + q * TPR);
            if (j < ncol) columns4(j);
          }
        }
      } else {
#pragma unroll 2
        for (int j = 4 * part; j < ncol; j += 4 * TPR) columns4(j);
      }
    }
    if (s + STAGES < n_s) {
      __syncthreads();  // every thread is done with stage st
      if (threadIdx.x == 0) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        fetch_tile<NF, ROW0, STAGES>(slab, slab_w, aln, s0, b, s1, s2,
                                     s + STAGES, ccol, ring0, bar0);
      }
    }
  }
  if constexpr (CHUNK > 0) {
    if (counts && (threadIdx.x & 31) == 0) {
      atomicAdd(counts, n_tested);
      atomicAdd(counts + 1, n_culled);
    }
  }

#pragma unroll
  for (int k = 0; k < R; ++k) {
    if constexpr (TPR > 1) {  // pairs of partial sums, then pairs of
                              // pairs: the same sum on every part
      float* a = reinterpret_cast<float*>(&acc[k]);
#pragma unroll
      for (int m = 1; m < TPR; m <<= 1)
#pragma unroll
        for (int e = 0; e < (int)(sizeof(acc[k]) / sizeof(float)); ++e)
          a[e] += __shfl_xor_sync(FULL, a[e], m);
    }
    if (part == 0) {
      if (!live[k]) acc[k] = typename P::Acc{};
      p.store(out, n_pad, (long long)b * block + r0 + k, acc[k]);
    }
  }
}

// With CHUNK > 0 and ccol <= 32 CHUNK, first the box kernel on the slab's
// rows kRow0 .. kRow0 + 2 into boxes (ceil(slab_w / CHUNK) boxes of 8
// floats), then the ring kernel, both on `stream`.
template <int R, int TPR, int STAGES, int ROWS_CTA, bool Exit, bool Gated,
          int CHUNK, class P>
int launch_ring(const P& p, const float* own, long long own_w,
                const float* slab, long long slab_w, const int* aln,
                const int* s0, const int* cnt, const int* ob, const int* glo,
                const int* ghi, int sub, float* out, int n_blocks, int block,
                int ccol, void* stream, float* boxes = nullptr,
                float cull = 0.0f, unsigned long long* counts = nullptr) {
  constexpr int nthr = ROWS_CTA / R * TPR;
  static_assert(TPR == 1 || TPR == 2 || TPR == 4, "threads a row: 1, 2, 4");
  static_assert(STAGES >= 1 && ROWS_CTA % R == 0 && nthr % 32 == 0 &&
                    nthr <= 512, "ring configuration");
  static_assert(CHUNK == 0 || (128 % CHUNK == 0 && CHUNK % (4 * TPR) == 0 &&
                               CHUNK >= 4),
                "a chunk divides ALIGN = 128 and holds whole rounds of a "
                "row's parts");
  if (n_blocks <= 0) return (int)cudaGetLastError();
  if (Gated && (sub <= 0 || block % sub != 0 || sub % R != 0 || !glo ||
                !ghi))
    return (int)cudaErrorInvalidValue;
  if (block % ROWS_CTA != 0) return (int)cudaErrorInvalidConfiguration;
  // the bulk copies move 16-byte units between 16-byte-aligned addresses
  if (ccol % 4 != 0 || slab_w % 4 != 0 ||
      reinterpret_cast<unsigned long long>(slab) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if constexpr (CHUNK > 0) {
    // a lane tests a chunk: a tile wider than 32 chunks takes the unculled
    // kernel, whose sums are the same
    if (ccol > 32 * CHUNK)
      return launch_ring<R, TPR, STAGES, ROWS_CTA, Exit, Gated, 0>(
          p, own, own_w, slab, slab_w, aln, s0, cnt, ob, glo, ghi, sub, out,
          n_blocks, block, ccol, stream);
    if (!boxes) return (int)cudaErrorInvalidValue;
    if (slab_w > 0) {
      const long long threads = (slab_w + 127) / 128 * 32;
      pair_ring_boxes<CHUNK><<<(unsigned)((threads + 255) / 256), 256, 0,
                               (cudaStream_t)stream>>>(
          slab, slab_w, P::kRow0, reinterpret_cast<float4*>(boxes));
    }
  }
  const size_t smem = sizeof(float) * P::kRows * (size_t)ccol * STAGES;
  auto* kernel = pair_ring<P, R, TPR, STAGES, ROWS_CTA, Exit, Gated, CHUNK>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = n_blocks * (block / ROWS_CTA);
  kernel<<<grid, nthr, smem, (cudaStream_t)stream>>>(
      p, own, own_w, slab, slab_w, aln, s0, cnt, ob, glo, ghi, sub, out,
      (long long)n_blocks * block, block, ccol,
      reinterpret_cast<const float4*>(boxes), cull, counts);
  return (int)cudaGetLastError();
}

// The shipped configuration of a ring kind, from ops/pair_kernels.py RING
// (the -DSPH_<KIND>_<FIELD> defines of ops/_build.py): R, TPR, STAGES,
// ROWS_CTA, Exit; and the box cull's CHUNK, one for every kind
// (pair_kernels.CHUNK, -DSPH_RING_CHUNK).
#if !defined(SPH_DENSITY_ROWS) || !defined(SPH_RHO_STAR_ROWS) ||      \
    !defined(SPH_VISCSURF_ROWS) || !defined(SPH_PACCEL_ROWS) ||         \
    !defined(SPH_BOUNDARY_ROWS) || !defined(SPH_MEMBRANE_ROWS) ||       \
    !defined(SPH_RING_CHUNK)
#error "build with the ring defines of sph_tpu_torch/ops/_build.py"
#endif
#define SPH_RING(K)                                                          \
  SPH_##K##_ROWS, SPH_##K##_TPR, SPH_##K##_STAGES, SPH_##K##_ROWS_CTA,       \
      (SPH_##K##_EXIT != 0)

}  // namespace

// glo, ghi, sub: the gate's windows and group size; null, null, 0 for the
// ungated kernel (the only one of the passes without a gated form)
#define SPH_PAIR_ARGS                                                       \
  const float *own, long long own_w, const float *slab, long long slab_w,  \
      const int *aln, const int *s0, const int *cnt, const int *ob,        \
      const int *glo, const int *ghi, int sub, float *out, int n_blocks,   \
      int block, int ccol, float c0, float c1, float c2, float c3, int i0, \
      void *stream
#define SPH_PAIR_FWD                                                        \
  own, own_w, slab, slab_w, aln, s0, cnt, ob, glo, ghi, sub, out,          \
      n_blocks, block, ccol, stream
// the ring kinds' entry points also take the box cull's inputs: a buffer
// of ceil(slab_w / CHUNK) boxes of 8 floats that the box kernel fills
// before the ring kernel reads it (the caller's: ops/pair_kernels.py keeps
// one a device), the kind's cull reach and the counters (null: none)
#define SPH_RING_ARGS                                                       \
  SPH_PAIR_ARGS, float *boxes, float cull, unsigned long long *counts
#define SPH_RING_FWD SPH_PAIR_FWD, boxes, cull, counts
#define SPH_UNGATED(P) \
  (sub != 0 ? (int)cudaErrorInvalidValue : launch<false>(P, SPH_PAIR_FWD))
#define SPH_GATED(P) \
  (sub != 0 ? launch<true>(P, SPH_PAIR_FWD) : launch<false>(P, SPH_PAIR_FWD))
// the shipped ring kernel of kind K after its box kernel (gated where
// sub != 0 and G), and its unculled form (CHUNK 0, no box kernel)
#define SPH_RING_CALL(K, G, C, P, ...)                                      \
  (sub != 0 ? (G ? launch_ring<SPH_RING(K), G, C>(P, __VA_ARGS__)          \
                 : (int)cudaErrorInvalidValue)                              \
            : launch_ring<SPH_RING(K), false, C>(P, __VA_ARGS__))
#define SPH_CULL_CALL(K, G, P) \
  SPH_RING_CALL(K, G, SPH_RING_CHUNK, P, SPH_RING_FWD)
#define SPH_NOCULL_CALL(K, G, P) SPH_RING_CALL(K, G, 0, P, SPH_PAIR_FWD)

extern "C" {

int sph_pair_density(SPH_RING_ARGS) {
  return SPH_CULL_CALL(DENSITY, true, (Density{c0, c1, c2, c3}));
}

int sph_pair_rho_star(SPH_RING_ARGS) {
  return SPH_CULL_CALL(RHO_STAR, false, RhoStar{c0});
}

int sph_pair_viscsurf(SPH_RING_ARGS) {
  return SPH_CULL_CALL(VISCSURF, true, (ViscSurf{c0, c1, c2, c3}));
}

int sph_pair_paccel(SPH_RING_ARGS) {
  return SPH_CULL_CALL(PACCEL, true, (PAccel{c0, c1, c2, c3}));
}

int sph_pair_boundary(SPH_RING_ARGS) {
  return SPH_CULL_CALL(BOUNDARY, false, (Boundary{c0, c1, c2}));
}

int sph_pair_membrane(SPH_RING_ARGS) {
  return SPH_CULL_CALL(MEMBRANE, false, (Membrane{c0, c1}));
}

// the ring kernels without the box cull, kept for chip_smoke.py's bitwise
// comparison; no wrapper or engine calls these.
int sph_pair_density_nocull(SPH_PAIR_ARGS) {
  return SPH_NOCULL_CALL(DENSITY, true, (Density{c0, c1, c2, c3}));
}

int sph_pair_rho_star_nocull(SPH_PAIR_ARGS) {
  return SPH_NOCULL_CALL(RHO_STAR, false, RhoStar{c0});
}

int sph_pair_viscsurf_nocull(SPH_PAIR_ARGS) {
  return SPH_NOCULL_CALL(VISCSURF, true, (ViscSurf{c0, c1, c2, c3}));
}

int sph_pair_paccel_nocull(SPH_PAIR_ARGS) {
  return SPH_NOCULL_CALL(PACCEL, true, (PAccel{c0, c1, c2, c3}));
}

int sph_pair_boundary_nocull(SPH_PAIR_ARGS) {
  return SPH_NOCULL_CALL(BOUNDARY, false, (Boundary{c0, c1, c2}));
}

int sph_pair_membrane_nocull(SPH_PAIR_ARGS) {
  return SPH_NOCULL_CALL(MEMBRANE, false, (Membrane{c0, c1}));
}

// pair_pass for the kinds the ring driver and the spring list took over,
// kept for chip_smoke.py's in-call comparison; no wrapper or engine calls
// these.
int sph_pair_density_prev(SPH_PAIR_ARGS) {
  return SPH_GATED((Density{c0, c1, c2, c3}));
}

int sph_pair_rho_star_prev(SPH_PAIR_ARGS) {
  return SPH_UNGATED(RhoStar{c0});
}

int sph_pair_paccel_prev(SPH_PAIR_ARGS) {
  return SPH_GATED((PAccel{c0, c1, c2, c3}));
}

int sph_pair_viscsurf_prev(SPH_PAIR_ARGS) {
  return SPH_GATED((ViscSurf{c0, c1, c2, c3}));
}

int sph_pair_spring_prev(SPH_PAIR_ARGS) {
  return SPH_UNGATED((Spring{c0, c1, c2, c3, i0}));
}

int sph_pair_boundary_prev(SPH_PAIR_ARGS) {
  return SPH_UNGATED((Boundary{c0, c1, c2}));
}

int sph_pair_membrane_prev(SPH_PAIR_ARGS) {
  return SPH_UNGATED((Membrane{c0, c1}));
}

// the spring pass on its list (ops/pair_kernels.py spring_list): row_ptr
// [n_pad + 1], ent [n_slots * slab_w]
int sph_pair_spring(const float* own, long long own_w, const float* slab,
                    long long slab_w, const int* row_ptr, const int* ent,
                    const int* ob, float* out, int n_pad, float c0, float c1,
                    float c2, float c3, int n_slots, void* stream) {
  if (n_pad <= 0) return (int)cudaGetLastError();
  if (n_slots < 1) return (int)cudaErrorInvalidValue;
  constexpr int nthr = 256;
  spring_list<<<(n_pad + nthr - 1) / nthr, nthr, 0, (cudaStream_t)stream>>>(
      Spring{c0, c1, c2, c3, n_slots}, own, own_w, slab, slab_w, row_ptr,
      ent, ob, out, n_pad);
  return (int)cudaGetLastError();
}

const char* sph_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
