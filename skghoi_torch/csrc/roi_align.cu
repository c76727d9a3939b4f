// Multi-scale RoIAlign for Hopper (sm_90a), NHWC feature maps: the forward
// and its adjoint (the gradient of the maps), in one translation unit so that
// both take their sample cells and weights from the same device functions
// (axis_sample, rank_axis) and agree at exact cell boundaries.
//
// The forward replaces the Pallas TPU kernel skghoi_tpu/ops/pallas_roi_align.py::
// pallas_multiscale_roi_align (pallas_call at :213, body _kernel :90-117)
// together with its overflow rescue roi_align_exact (:344-368): torchvision
// roi_align, aligned=False, 7x7 output, sampling ratio 2, one FPN level per
// box, exact for every box whatever its span.  The adjoint replaces the
// kernel's custom-VJP backward _roi_backward (:222-265), whole-level GEMM
// pairs made for the TPU's MXU; see roi_align_adjoint_kernel below.
//
// Adjoint, bound on the card: bytes.  It writes the four map gradients whole
// (380 MB in bf16 at the main path's shapes, almost all zeros) and reads the
// 6 MB cotangent: 0.115 ms at 3.35 TB/s; its <50 M multiply-adds do not bind.
// So it writes each gradient cell once, from a tile owner that sums the boxes
// reaching its tile in registers, and never forms the GEMMs' dense
// interpolation matrices.
//
// Forward, bound on the card: bytes.  It does about one fp32 multiply-add per
// byte it reads, far below the ~295 operations per byte where the tensor cores
// would be the limit, so the TPU's A_y W A_x^T matmul form (made for the MXU)
// is not carried over.  The floor is the distinct map cells the boxes touch, read
// once, plus the output, written once, over HBM bandwidth: at the main path's
// shapes (bf16, 8 x 30 boxes, C=256, 832x1344 pyramid) 18.6 MB + 6.0 MB,
// 7.35 us on an H100 SXM at 3.35 TB/s.
//
// Design: stage each work item's distinct cells in shared memory with 16-byte
// asynchronous copies, then interpolate from shared memory.
//   * Work item: (box, channel slice of 256 bytes = 128 bf16 or 64 fp32
//     channels; the last slice may be narrower).  Persistent CTAs, two per SM.
//     CTA k starts with item k; its later items are chosen by estimated work
//     (4 classes), so that a CTA with a large first item gets a small next one
//     (plan_items, run by the consumer warps while the first rows load).
//   * Warp roles: 2 producer warps fetch boxes, build each item's geometry and
//     issue the copies; 7 consumer warps interpolate, warp px output pixel px.
//     One barrier per output row; the producers' copies and geometry for later
//     rows overlap the consumers' arithmetic on this one.
//   * Geometry, per item: the 14 y and 14 x sample positions (the plain
//     version's fp32 formula, round-to-nearest intrinsics so nothing is
//     contracted into an FMA), the sorted lists of distinct rows and columns
//     (at most 28 each, from two ballots: build_axis), and per output row and
//     column a bin: the at most 4 distinct cells its two samples touch, with
//     their summed weights.  An output value is then a sum over bin x bin
//     cells (at most 16, 6-9 for most boxes) rather than over 16 corners.
//   * Staging: output row py needs the distinct map rows of its y bin, at
//     most 4.  Rows stream, each once, into a ring of 12 row slots (28 columns
//     x 256 bytes) with cp.async.cg, 16 bytes a thread, neighbouring threads
//     on neighbouring addresses; one commit group per output row, two rows
//     ahead of the one being computed.  The stream runs on across items, so
//     the next item's first rows are in flight while this one finishes.
//   * Interpolation: lane l of a consumer warp owns channel bytes 8l..8l+7 of
//     the slice, so a warp covers a pixel's 256 bytes: 8-byte shared loads,
//     fp32 accumulation, one 8-byte store a lane in the maps' dtype.  Code is
//     specialised for each (rows, columns) bin size, all loads before the
//     first multiply-add.  (With 16 bytes a lane a pixel would take half a
//     warp, and the other half would have to work on another sample and add
//     by shuffles; 8 bytes a lane needs no shuffle and keeps every lane busy.)
// Against the design it replaces (one block per box and output row, 16
// corners read from global memory, 4 bytes a thread):
//   1. re-reads: each distinct cell of an item leaves global memory once, not
//      once per corner of every row-block that needs it;
//   2. narrow loads: copies are 16 bytes a thread;
//   3. serial pixels: feature values come from shared memory, so no output
//      store can alias the next pixel's loads;
//   4. serial prologue: the next item's geometry is built by the producers
//      during this item's first output row, from a box fetched one item
//      earlier.
// What limits it now is not memory: a warm L2 saves it a few percent, and
// padding slots alone (2x2 cells an item) take two thirds of its time.  The
// rest is latency (each item's start: box, geometry, first copies; each
// output row's barrier) and the warps' instruction streams (PERF.md).
// TMA (cp.async.bulk.tensor) is not used: a box's distinct cells form a dense
// rectangle only while its samples are under a cell apart; larger boxes touch
// a strided subset of rows and columns that a tensor-map box would over-fetch
// (up to 4x the bytes for a 28-cell span), and a second path for the dense
// case would double what has to be tested.
//
// The level of each box comes from the caller (the same LevelMapper op the
// plain version uses), so both pick the same level at an exact boundary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPooled = 7;
constexpr int kSr = 2;
constexpr int kSamples = kPooled * kSr;   // samples per axis
constexpr int kMaxCells = 2 * kSamples;   // distinct rows (or columns) of an item, at most
constexpr int kSliceBytes = 256;          // channels of a work item
constexpr int kVecs = kSliceBytes / 16;   // 16-byte vectors in a slice
constexpr int kConsumers = kPooled;       // warp px < 7 interpolates output pixel px
constexpr int kProducers = 2;             // warps 7 and 8 stage rows and build geometry
constexpr int kWarps = kConsumers + kProducers;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxOrdered = 4096;         // items the work order is planned for; beyond, index order
constexpr int kColStep = 32 * kProducers / kVecs;  // columns a producer lane steps by
constexpr int kColsPerLane = (kMaxCells + kColStep - 1) / kColStep;
constexpr int kAhead = 2;                 // output rows staged ahead of the one computed
constexpr int kSlots = 4 * (kAhead + 1);  // an output row needs at most 4 map rows
constexpr int kSlotBytes = kMaxCells * kSliceBytes;
constexpr int kRingBytes = kSlots * kSlotBytes;  // 86,016 bytes of dynamic shared memory
constexpr int kBlocksPerSm = 2;
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  const void* maps[4];
  int h[4];
  int w[4];
  float scale[4];  // 1 / stride
};

// One output row (y) or column (x): the distinct cells its two samples touch,
// cells first .. first+n-1 of the item's sorted distinct list (n <= 4: no
// other sample's cell lies between them), with the summed weights of those
// cells (y: times the 1/4 of the mean over the 2x2 samples).
struct __align__(16) Bin {
  int first, n;
  float w[4];
};

// One work item: where its slice starts, and its sample geometry.
struct Geom {
  const char* src;  // this image's map at row 0, column 0, the slice's first channel
  int w;            // map width
  int box;          // box index in [0, B*N)
  int c0;           // first channel of the slice
  int nvec;         // 16-byte vectors in the slice
  int ny, nx;       // distinct rows and columns
  int row[kMaxCells], col[kMaxCells];  // sorted distinct map rows and columns
  Bin yb[kPooled], xb[kPooled];
};

// 16 bytes from global memory to the shared-memory address `smem`.
__device__ __forceinline__ void cp_async16(unsigned smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc += w * (8 bytes of channels).
__device__ __forceinline__ void fma8(float (&acc)[2], uint2 u, float w) {
  acc[0] += w * __uint_as_float(u.x);
  acc[1] += w * __uint_as_float(u.y);
}
__device__ __forceinline__ void fma8(float (&acc)[4], uint2 u, float w) {
  acc[0] += w * __uint_as_float(u.x << 16);  // element 2i in the low half of word i
  acc[1] += w * __uint_as_float(u.x & 0xffff0000u);
  acc[2] += w * __uint_as_float(u.y << 16);
  acc[3] += w * __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void store8(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

// One sample position along one axis: low/high cell and their weights, with
// torchvision's boundary rules.  Out-of-bounds samples get zero weights.
__device__ __forceinline__ void axis_sample(float start, float roi_len, int size, int s, int* lo,
                                            int* hi, float* w_lo, float* w_hi) {
  const float bin_len = __fdiv_rn(roi_len, (float)kPooled);
  const float rel = __fadd_rn((float)(s / kSr), ((float)(s % kSr) + 0.5f) / kSr);
  float pos = __fadd_rn(start, __fmul_rn(rel, bin_len));
  const bool oob = pos < -1.0f || pos > (float)size;
  pos = fmaxf(pos, 0.0f);
  const int low = min((int)floorf(pos), size - 1);
  pos = fminf(pos, (float)(size - 1));
  const float frac = __fsub_rn(pos, (float)low);
  *lo = low;
  *hi = min(low + 1, size - 1);
  *w_lo = oob ? 0.0f : 1.0f - frac;
  *w_hi = oob ? 0.0f : frac;
}

// One axis of a box, by one whole warp; lane s < 14 holds sample s (lanes
// beyond repeat sample 13).  The samples are monotone and hi <= lo + 1, so
// the sequence lo0, hi0, lo1, hi1, ... is sorted once repeated samples (lo
// equal to the previous sample's) are dropped: a cell is new where it exceeds
// the one before it, and its index in the sorted distinct list is the count
// of new cells before it.  A repeated sample takes the indices of the first
// sample of its run.  The forward (build_axis) and the adjoint (adjoint_axis)
// both start here, so they pick the same cells with the same weights.
struct AxisRank {
  int lo, hi;           // the lane's sample's low and high cell
  float wl, wh;         // their weights, 0 for a sample outside [-1, size]
  int r_lo, r_hi;       // their indices in the sorted list of distinct cells
  bool new_lo, new_hi;  // lo (hi) enters that list at this lane, at r_lo (r_hi)
  int n;                // distinct cells, at most kMaxCells
};

__device__ __forceinline__ AxisRank rank_axis(float start, float roi_len, int size) {
  const int lane = threadIdx.x & 31;
  AxisRank a;
  axis_sample(start, roi_len, size, min(lane, kSamples - 1), &a.lo, &a.hi, &a.wl, &a.wh);
  const int prev_lo = __shfl_up_sync(kFull, a.lo, 1), prev_hi = __shfl_up_sync(kFull, a.hi, 1);
  const bool live = lane < kSamples;
  const bool head = live && (lane == 0 || a.lo != prev_lo);  // first sample of a run
  a.new_lo = head && (lane == 0 || a.lo > prev_hi);
  a.new_hi = head && a.hi > a.lo;
  const unsigned m_lo = __ballot_sync(kFull, a.new_lo), m_hi = __ballot_sync(kFull, a.new_hi);
  const unsigned m_head = __ballot_sync(kFull, head);
  const unsigned below = (1u << lane) - 1u;
  const int before = __popc(m_lo & below) + __popc(m_hi & below);
  const int r_lo_head = a.new_lo ? before : before - 1;
  const int r_hi_head = a.new_hi ? before + (a.new_lo ? 1 : 0) : r_lo_head;
  a.n = __popc(m_lo) + __popc(m_hi);
  const int run = 31 - __clz(m_head & (below | (1u << lane)));  // lane of the run's head
  a.r_lo = __shfl_sync(kFull, r_lo_head, live ? run : 0);
  a.r_hi = __shfl_sync(kFull, r_hi_head, live ? run : 0);
  return a;
}

// One axis of an item's geometry, by one whole warp: the sorted distinct
// cells, and lanes 0-6 merge samples 2b and 2b+1 into bin b.
__device__ __forceinline__ void build_axis(float start, float roi_len, int size, float w_scale,
                                           int* cells, Bin* bins, int* n) {
  const int lane = threadIdx.x & 31;
  const AxisRank a = rank_axis(start, roi_len, size);
  if (a.new_lo) cells[a.r_lo] = a.lo;
  if (a.new_hi) cells[a.r_hi] = a.hi;
  if (lane == 0) *n = a.n;

  const int b = lane % kPooled, s0 = kSr * b, s1 = s0 + 1;
  const int lo0 = __shfl_sync(kFull, a.r_lo, s0), hi0 = __shfl_sync(kFull, a.r_hi, s0);
  const int lo1 = __shfl_sync(kFull, a.r_lo, s1), hi1 = __shfl_sync(kFull, a.r_hi, s1);
  const float wl0 = __shfl_sync(kFull, a.wl, s0) * w_scale, wh0 = __shfl_sync(kFull, a.wh, s0) * w_scale;
  const float wl1 = __shfl_sync(kFull, a.wl, s1) * w_scale, wh1 = __shfl_sync(kFull, a.wh, s1) * w_scale;
  if (lane < kPooled) {
    Bin bin;
    bin.first = lo0;
    bin.n = hi1 - lo0 + 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cell = lo0 + i;
      bin.w[i] = (lo0 == cell ? wl0 : 0.0f) + (hi0 == cell ? wh0 : 0.0f) +
                 (lo1 == cell ? wl1 : 0.0f) + (hi1 == cell ? wh1 : 0.0f);
    }
    bins[b] = bin;
  }
}

// A box's start and length on one axis of a level (scale = 1 / stride), the
// length at least one cell.
__device__ __forceinline__ void axis_extent(float4 box, bool is_x, float scale, float* start,
                                            float* len) {
  *start = (is_x ? box.x : box.y) * scale;
  *len = fmaxf(__fsub_rn((is_x ? box.z : box.w) * scale, *start), 1.0f);
}

// The geometry of the item (box b, channel slice `slice`) into g: producer
// warp 0 its x axis and where its slice starts, producer warp 1 its y axis;
// consumer warps return.
template <typename T>
__device__ __forceinline__ void build_geom(Levels lv, float4 box, int level, int b, int slice,
                                           int n_boxes, int c, Geom& g) {
  const int pw = (threadIdx.x >> 5) - kConsumers;
  if (pw < 0) return;
  const void* map = lv.maps[0];
  int h = lv.h[0], w = lv.w[0];
  float scale = lv.scale[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {  // selects, not a run-time index into the parameter block
    if (level == i) {
      map = lv.maps[i];
      h = lv.h[i];
      w = lv.w[i];
      scale = lv.scale[i];
    }
  }
  const bool is_x = pw == 0;
  float start, len;
  axis_extent(box, is_x, scale, &start, &len);
  if (is_x) {
    build_axis(start, len, w, 1.0f, g.col, g.xb, &g.nx);
    if ((threadIdx.x & 31) == 0) {
      const int c0 = slice * (kSliceBytes / (int)sizeof(T));
      g.box = b;
      g.c0 = c0;
      g.w = w;
      g.nvec = min(kVecs, (c - c0) * (int)sizeof(T) / 16);
      g.src = static_cast<const char*>(map) +
              ((size_t)(b / n_boxes) * h * w * c + c0) * sizeof(T);
    }
  } else {
    build_axis(start, len, h, 1.0f / (kSr * kSr), g.row, g.yb, &g.ny);
  }
}

// Last distinct row that output row py of the item in g reads.
__device__ __forceinline__ int last_row(const Geom& g, int py) {
  return g.yb[py].first + g.yb[py].n - 1;
}

// What a producer lane needs of an item to stage its rows: the lane keeps one
// 16-byte vector v of the slice and takes the columns k0, k0 + 4, ... of each
// row, whose byte offsets it holds.
struct StageLane {
  const char* src;  // the item's map at row 0, column 0, vector v
  size_t row_bytes;
  unsigned dst;     // shared address of ring slot 0, column k0, vector v
  unsigned col[kColsPerLane];  // byte offsets of columns k0 + kColStep * i in a map row
  int ncol;         // of them in the item
};

template <typename T>
__device__ __forceinline__ StageLane stage_lane(const Geom& g, int c, unsigned ring) {
  const int t = threadIdx.x - 32 * kConsumers;
  const int v = t % kVecs, k0 = t / kVecs;
  const unsigned cell_bytes = (unsigned)c * sizeof(T);
  StageLane s;
  const int nx = v < g.nvec ? g.nx : 0;
  s.ncol = nx > k0 ? (nx - k0 + kColStep - 1) / kColStep : 0;
#pragma unroll
  for (int i = 0; i < kColsPerLane; ++i) {
    s.col[i] = i < s.ncol ? (unsigned)g.col[k0 + kColStep * i] * cell_bytes : 0u;
  }
  s.src = g.src + v * 16;
  s.row_bytes = (size_t)g.w * cell_bytes;
  s.dst = ring + k0 * kSliceBytes + v * 16;
  return s;
}

// Issue the copies of the map rows that output row py of the item in g needs
// and no earlier output row of it did.  Distinct row d of the item goes to
// ring slot (base + d) % kSlots.
__device__ __forceinline__ void stage_rows(const Geom& g, const StageLane& s, int py, int base) {
  if (s.ncol == 0) return;
  const int d1 = last_row(g, py);
  for (int d = py == 0 ? 0 : last_row(g, py - 1) + 1; d <= d1; ++d) {
    const char* row = s.src + (size_t)g.row[d] * s.row_bytes;
    const unsigned dst = s.dst + ((base + d) % kSlots) * kSlotBytes;
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) {
      if (i < s.ncol) cp_async16(dst + i * kColStep * kSliceBytes, row + s.col[i]);
    }
  }
}

// What a consumer thread needs of an item to interpolate: its pixel's column
// bin (byte offset of its first cell in a ring row, weights) and its output
// address.  Warp px computes output pixel (py, px); lane l owns channel bytes
// 8l..8l+7 of the slice, so a warp reads and writes the slice's 256 bytes.
template <typename T>
struct PixelLane {
  int col_off, n;
  float w[4];
  T* out;  // output row 0, this warp's pixel, this lane's channels
  bool live;
};

template <typename T>
__device__ __forceinline__ PixelLane<T> pixel_lane(const Geom& g, int c, T* out) {
  const int px = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Bin xb = g.xb[px];
  PixelLane<T> p;
  p.col_off = xb.first * kSliceBytes + lane * 8;
  p.n = xb.n;
#pragma unroll
  for (int i = 0; i < 4; ++i) p.w[i] = xb.w[i];
  p.live = lane < 2 * g.nvec;
  p.out = out + ((size_t)g.box * kPooled * kPooled + px) * c + g.c0 + lane * (8 / sizeof(T));
  return p;
}

// acc += the weighted sum over NY rows (from ring slot `slot` on, wrapping)
// and NX columns (from byte `col` of a row) of the ring.  All loads are
// issued before the first multiply-add, so their latencies overlap.
template <int NY, int NX, int N>
__device__ __forceinline__ void sum_cells(float (&acc)[N], const unsigned char* ring, int slot,
                                          int col, const float (&wy)[4], const float (&wx)[4]) {
  uint2 v[NY][NX];
#pragma unroll
  for (int i = 0; i < NY; ++i) {
    const unsigned char* r = ring + slot * kSlotBytes + col;
#pragma unroll
    for (int k = 0; k < NX; ++k) v[i][k] = *reinterpret_cast<const uint2*>(r + k * kSliceBytes);
    slot = slot + 1 == kSlots ? 0 : slot + 1;
  }
#pragma unroll
  for (int i = 0; i < NY; ++i) {
#pragma unroll
    for (int k = 0; k < NX; ++k) fma8(acc, v[i][k], wy[i] * wx[k]);
  }
}

// Output row py of the item in g, from the ring: the weighted sum over the
// distinct cells of the row's y bin and the pixel's x bin, fp32 accumulation.
// The bins' sizes are uniform over the warp; each of the 16 pairs has its own
// code, so a row does only the loads and multiply-adds its cells need.
template <typename T>
__device__ __forceinline__ void interpolate_row(const Geom& g, const PixelLane<T>& p, int py,
                                                int base, int c, const unsigned char* ring) {
  if (!p.live) return;
  const Bin yb = g.yb[py];
  const int slot = (base + yb.first) % kSlots;
  float acc[8 / sizeof(T)];
#pragma unroll
  for (int i = 0; i < (int)(8 / sizeof(T)); ++i) acc[i] = 0.0f;
  switch ((yb.n - 1) * 4 + p.n - 1) {
#define SKGHOI_CASE(NY, NX)                                   \
  case (NY - 1) * 4 + NX - 1:                                 \
    sum_cells<NY, NX>(acc, ring, slot, p.col_off, yb.w, p.w); \
    break;
    SKGHOI_CASE(1, 1) SKGHOI_CASE(1, 2) SKGHOI_CASE(1, 3) SKGHOI_CASE(1, 4)
    SKGHOI_CASE(2, 1) SKGHOI_CASE(2, 2) SKGHOI_CASE(2, 3) SKGHOI_CASE(2, 4)
    SKGHOI_CASE(3, 1) SKGHOI_CASE(3, 2) SKGHOI_CASE(3, 3) SKGHOI_CASE(3, 4)
    SKGHOI_CASE(4, 1) SKGHOI_CASE(4, 2) SKGHOI_CASE(4, 3) SKGHOI_CASE(4, 4)
#undef SKGHOI_CASE
  }
  store8(p.out + (size_t)py * kPooled * c, acc);
}

// Work class of a box, 0-3: its distinct cells, estimated as
// min(side / stride + 2, 28) per axis, in quarters of the most (28 x 28).
__device__ __forceinline__ int work_class(float4 box, int level, const Levels& lv) {
  float scale = lv.scale[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) scale = level == i ? lv.scale[i] : scale;
  const float w = fminf(fmaxf((box.z - box.x) * scale + 2.0f, 1.0f), 28.0f);
  const float h = fminf(fmaxf((box.w - box.y) * scale + 2.0f, 1.0f), 28.0f);
  return min(3, (int)(w * h * (4.0f / 785.0f)));
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumers) : "memory");
}
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(32 * kProducers) : "memory");
}

// Consumer warps, while the first rows are in flight: how the CTA's items
// after the first are chosen.  CTA k's first item is item k; `rank` is its
// place among the first round's G items by work class, largest first (then
// by position).  The later items, ordered the same way into `rest`, are dealt
// back and forth by rank (later_item), so the CTAs with the largest first
// items get the smallest next ones, or none.  Each box's class is computed
// once into `box_class`; a position in `rest` is where its class starts,
// plus the items of its class before it: in earlier rounds of 224, in
// earlier warps (`cnt`), in earlier lanes (ballot).
__device__ __forceinline__ void plan_items(const float4* boxes, const int* levels,
                                           const Levels& lv, int n_items, int n_slices,
                                           uint8_t* box_class, uint16_t* rest,
                                           int (&cnt)[kConsumers][4], int* rank) {
  constexpr int kN = 32 * kConsumers;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = gridDim.x;
  for (int i = t; i < n_items / n_slices; i += kN) {
    box_class[i] = (uint8_t)work_class(boxes[i], levels[i], lv);
  }
  if (t == 0) *rank = 0;
  consumer_sync();
  const int mine = box_class[blockIdx.x / n_slices];
  int before = 0;
  for (int p = t; p < g; p += kN) {
    const int k = box_class[p / n_slices];
    before += k > mine || (k == mine && p < (int)blockIdx.x);
  }
  before = __reduce_add_sync(kFull, before);
  if (lane == 0) atomicAdd(rank, before);
  const int n = n_items - g;
  int start[4] = {0, 0, 0, 0};  // first position of each class still free
  for (int sweep = 0; sweep < 2; ++sweep) {  // 0: class sizes; 1: positions
    for (int base = 0; base < n; base += kN) {
      const int i = base + t;
      const int k = i < n ? box_class[(g + i) / n_slices] : -1;
      unsigned mk = 0;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const unsigned m = __ballot_sync(kFull, k == kk);
        if (lane == 0) cnt[warp][kk] = __popc(m);
        mk = k == kk ? m : mk;
      }
      consumer_sync();
      if (sweep == 1 && i < n) {
        int pos = 0;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) pos = k == kk ? start[kk] : pos;
        for (int w = 0; w < warp; ++w) pos += cnt[w][k];
        rest[pos + __popc(mk & ((1u << lane) - 1u))] = (uint16_t)i;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        for (int w = 0; w < kConsumers; ++w) start[kk] += cnt[w][kk];
      }
      consumer_sync();
    }
    if (sweep == 0) {  // sizes -> starts, largest class first
      const int s3 = start[3], s2 = start[2], s1 = start[1];
      start[3] = 0;
      start[2] = s3;
      start[1] = s3 + s2;
      start[0] = s3 + s2 + s1;
    }
  }
}

// Item of the CTA's j-th round (j >= 1), or -1: see plan_items.
__device__ __forceinline__ int later_item(int j, int rank, int n_items, bool ordered,
                                          const uint16_t* rest) {
  const int g = gridDim.x;
  const int q = (j - 1) * g + ((j & 1) ? g - 1 - rank : rank);
  if (q >= n_items - g) return -1;
  return g + (ordered ? rest[q] : q);
}

// Producer warps: fetch boxes, build geometry, stage rows.  Consumer warps:
// plan the later items, then interpolate.  One barrier per output row: after
// it, the row's cells are in the ring and the previous row's reads are done,
// so the producers may refill the slots that row no longer needs.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
roi_align_staged_kernel(Levels lv, const float4* __restrict__ boxes,
                        const int* __restrict__ levels, T* __restrict__ out, int n_boxes,
                        int n_items, int n_slices, int c) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ Geom geom[2];  // item j's geometry in geom[j & 1]
  __shared__ uint16_t rest[kMaxOrdered];
  __shared__ uint8_t box_class[kMaxOrdered];
  __shared__ int class_count[kConsumers][4];
  __shared__ int first_rank;
  const bool producer = threadIdx.x >= 32 * kConsumers;
  const bool ordered = n_items <= kMaxOrdered;
  const unsigned ring_s = static_cast<unsigned>(__cvta_generic_to_shared(ring));

  // Box, slice and level of the next item whose geometry is built, fetched ahead.
  float4 box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int b = 0, slice = 0, level = 0;
  auto fetch = [&](int p) {
    b = p / n_slices;
    slice = p - b * n_slices;
    box = boxes[b];
    level = levels[b];
  };

  StageLane sl, sl_next;
  if (producer) {
    fetch((int)blockIdx.x);  // grid <= n_items
    build_geom<T>(lv, box, level, b, slice, n_boxes, c, geom[0]);
    producer_sync();
    sl = stage_lane<T>(geom[0], c, ring_s);
    sl_next = sl;
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      stage_rows(geom[0], sl, q, 0);
      cp_async_commit();
    }
  } else if (ordered) {
    plan_items(boxes, levels, lv, n_items, n_slices, box_class, rest, class_count, &first_rank);
  }
  __syncthreads();
  const int rank = ordered ? first_rank : blockIdx.x;
  int n_mine = 1;
  while (later_item(n_mine, rank, n_items, ordered, rest) >= 0) ++n_mine;
  if (producer && n_mine > 1) fetch(later_item(1, rank, n_items, ordered, rest));

  int base = 0;  // ring slot of the current item's distinct row 0
  for (int j = 0; j < n_mine; ++j) {
    const Geom& g = geom[j & 1];
    const int base_next = (base + g.ny) % kSlots;
    PixelLane<T> pl;
    if (!producer) pl = pixel_lane<T>(g, c, out);
    for (int py = 0; py < kPooled; ++py) {
      if (producer) cp_async_wait<kAhead - 1>();  // output row py's rows have landed
      __syncthreads();
      if (!producer) {
        interpolate_row<T>(g, pl, py, base, c, ring);
        continue;
      }
      const int qa = py + kAhead;
      if (qa < kPooled) {
        stage_rows(g, sl, qa, base);
      } else if (j + 1 < n_mine) {  // built at py == 0, visible since the barrier at py == 1
        if (qa == kPooled) sl_next = stage_lane<T>(geom[(j + 1) & 1], c, ring_s);
        stage_rows(geom[(j + 1) & 1], sl_next, qa - kPooled, base_next);
      }
      cp_async_commit();  // possibly empty: one group per output row keeps the count fixed
      if (py == 0 && j + 1 < n_mine) {  // geom[(j+1)&1] was item j-1's, no longer read
        build_geom<T>(lv, box, level, b, slice, n_boxes, c, geom[(j + 1) & 1]);
        if (j + 2 < n_mine) fetch(later_item(j + 2, rank, n_items, ordered, rest));
      }
    }
    base = base_next;
    sl = sl_next;
  }
  if (producer) cp_async_wait<0>();
}

template <typename T>
int launch(const void* f0, const void* f1, const void* f2, const void* f3, const int* hw,
           const float* scales, const float* boxes, const int* levels, void* out,
           int n_images, int n_boxes, int c, void* stream) {
  Levels lv;
  const void* maps[4] = {f0, f1, f2, f3};
  for (int i = 0; i < 4; ++i) {
    lv.maps[i] = maps[i];
    lv.h[i] = hw[2 * i];
    lv.w[i] = hw[2 * i + 1];
    lv.scale[i] = scales[i];
  }
  const int slice = kSliceBytes / (int)sizeof(T);
  const int n_slices = (c + slice - 1) / slice;
  const int n_items = n_images * n_boxes * n_slices;
  if (n_items == 0) return (int)cudaSuccess;

  // Set up once per device, outside any stream capture that may follow.
  static int sms[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(roi_align_staged_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
    if (err == cudaSuccess) {  // room for kBlocksPerSm rings on an SM
      err = cudaFuncSetAttribute(roi_align_staged_kernel<T>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) {
      sms[dev] = 0;
      return (int)err;
    }
  }
  const int grid = n_items < kBlocksPerSm * sms[dev] ? n_items : kBlocksPerSm * sms[dev];
  roi_align_staged_kernel<T><<<grid, kThreads, kRingBytes, static_cast<cudaStream_t>(stream)>>>(
      lv, reinterpret_cast<const float4*>(boxes), levels, static_cast<T*>(out), n_boxes, n_items,
      n_slices, c);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The adjoint: the gradient of the four maps from the cotangent of the output.
//
// dF_l[b, y, x, :] = sum over the boxes n of image b assigned to level l, in
// index order, of sum over bins (py, px) of A_y[n, py, y] A_x[n, px, x]
// g[b, n, py, px, :], where A_y and A_x hold each bin's bilinear weights
// (the forward's, from rank_axis) and A_y the 1/4 of the 2x2 mean.  Every
// box slot counts, padding slots too, as in _roi_backward.
//
// A CTA owns one kTile x kTile tile of one level's map, for one image and one
// 256-byte channel slice: it writes every cell of it exactly once (zeros where
// no box reaches), so there is no memset, no atomic, and the sums run in one
// fixed order (deterministic).  It walks the image's boxes in chunks of 256:
// one thread a box tests whether the box's samples reach the tile (its first
// sample's low cell and its last sample's high cell on each axis), and a
// ballot compacts the hits in index order.  For each hit, all threads stage
// the box's 7x7 cotangent slice (12.5 KB) in shared memory with 16-byte
// cp.async copies while warp 0 builds the y axis and warp 1 the x axis
// (adjoint_axis); then warp i accumulates tile row i: lane l owns channel
// bytes 8l..8l+7 of the slice for the tile's 8 cells of that row, fp32 in
// registers.  A tile no box reaches only scans the boxes and stores zeros.
constexpr int kTile = 8;                   // a CTA's tile: kTile x kTile map cells
constexpr int kBwdWarps = kTile;           // warp i accumulates tile row i
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdBlocksPerSm = 4;

struct GradLevels {
  void* grads[4];
  int h[4];
  int w[4];
  float scale[4];    // 1 / stride
  int tiles_x[4];    // tiles across a level's row
  int first[4];      // the level's first CTA
};

// Whether a box's samples on one axis reach cells t0 .. t0 + kTile - 1: the
// samples are monotone, so its first sample's low cell and its last sample's
// high cell bound every cell it touches.
__device__ __forceinline__ bool box_meets(float4 box, bool is_x, float scale, int size, int t0) {
  float start, len, w0, w1;
  axis_extent(box, is_x, scale, &start, &len);
  int lo, hi, other;
  axis_sample(start, len, size, 0, &lo, &other, &w0, &w1);
  axis_sample(start, len, size, kSamples - 1, &other, &hi, &w0, &w1);
  return lo < t0 + kTile && hi >= t0;
}

// One axis of a box's adjoint geometry, by one whole warp, for the tile's
// cells t0 .. t0 + kTile - 1 on that axis: map[i] is the index of cell t0 + i
// in the box's sorted distinct list, or -1; for distinct cell d, wt[d][p] is
// its weight in bin p (the forward's bin sums, times w_scale: both weights of
// a sample clamped to the edge land on one cell and are added) and span[d]
// holds the first and last bin whose samples touch it (first | last << 8).
__device__ __forceinline__ void adjoint_axis(float start, float roi_len, int size, float w_scale,
                                             int t0, int* map, float (*wt)[kPooled + 1],
                                             int* span) {
  const int lane = threadIdx.x & 31;
  if (lane < kTile) map[lane] = -1;
  const AxisRank a = rank_axis(start, roi_len, size);
  __syncwarp();
  if (a.new_lo && (unsigned)(a.lo - t0) < (unsigned)kTile) map[a.lo - t0] = a.r_lo;
  if (a.new_hi && (unsigned)(a.hi - t0) < (unsigned)kTile) map[a.hi - t0] = a.r_hi;
  int first = kPooled, last = -1;
#pragma unroll
  for (int p = 0; p < kPooled; ++p) {
    const int s0 = kSr * p, s1 = s0 + 1;
    const int lo0 = __shfl_sync(kFull, a.r_lo, s0), hi0 = __shfl_sync(kFull, a.r_hi, s0);
    const int lo1 = __shfl_sync(kFull, a.r_lo, s1), hi1 = __shfl_sync(kFull, a.r_hi, s1);
    const float wl0 = __shfl_sync(kFull, a.wl, s0) * w_scale, wh0 = __shfl_sync(kFull, a.wh, s0) * w_scale;
    const float wl1 = __shfl_sync(kFull, a.wl, s1) * w_scale, wh1 = __shfl_sync(kFull, a.wh, s1) * w_scale;
    if (lane < kMaxCells) {
      wt[lane][p] = (lo0 == lane ? wl0 : 0.0f) + (hi0 == lane ? wh0 : 0.0f) +
                    (lo1 == lane ? wl1 : 0.0f) + (hi1 == lane ? wh1 : 0.0f);
    }
    if (lo0 == lane || hi0 == lane || lo1 == lane || hi1 == lane) {
      first = min(first, p);
      last = p;
    }
  }
  if (lane < kMaxCells) span[lane] = first | (last << 8);
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSm)
roi_align_adjoint_kernel(GradLevels lv, const float4* __restrict__ boxes,
                         const int* __restrict__ levels, const T* __restrict__ cot, int n_boxes,
                         int n_slices, int c) {
  constexpr int kE = 8 / sizeof(T);  // channels a lane owns
  __shared__ __align__(16) unsigned char gs[kPooled * kPooled * kSliceBytes];  // the box's cotangent slice
  __shared__ float wy[kMaxCells][kPooled + 1], wx[kMaxCells][kPooled + 1];
  __shared__ int span_y[kMaxCells], span_x[kMaxCells];
  __shared__ int row_of[kTile], col_of[kTile];
  __shared__ int hits[kBwdThreads];
  __shared__ int warp_hits[kBwdWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // This CTA's level, image, slice and tile (selects, not a run-time index
  // into the parameter block).
  int level = 0;
#pragma unroll
  for (int i = 1; i < 4; ++i) level = (int)blockIdx.x >= lv.first[i] ? i : level;
  void* grad = lv.grads[0];
  int h = lv.h[0], w = lv.w[0], tiles_x = lv.tiles_x[0], first = lv.first[0];
  float scale = lv.scale[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (level == i) {
      grad = lv.grads[i];
      h = lv.h[i];
      w = lv.w[i];
      tiles_x = lv.tiles_x[i];
      first = lv.first[i];
      scale = lv.scale[i];
    }
  }
  const int tiles = tiles_x * ((h + kTile - 1) / kTile);
  const int idx = (int)blockIdx.x - first;
  const int tile = idx % tiles, rest = idx / tiles;
  const int slice = rest % n_slices, b = rest / n_slices;
  const int y0 = tile / tiles_x * kTile, x0 = tile % tiles_x * kTile;
  const int c0 = slice * (kSliceBytes / (int)sizeof(T));
  const int nvec = min(kVecs, (c - c0) * (int)sizeof(T) / 16);
  const bool live = lane < 2 * nvec;
  const unsigned gs_s = static_cast<unsigned>(__cvta_generic_to_shared(gs));

  float acc[kTile][kE];
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[j][e] = 0.0f;
  }

  for (int base = 0; base < n_boxes; base += kBwdThreads) {
    const int n = base + (int)threadIdx.x;
    bool hit = false;
    if (n < n_boxes && levels[b * n_boxes + n] == level) {
      const float4 box = boxes[b * n_boxes + n];
      hit = box_meets(box, false, scale, h, y0) && box_meets(box, true, scale, w, x0);
    }
    const unsigned m = __ballot_sync(kFull, hit);
    if (lane == 0) warp_hits[warp] = __popc(m);
    __syncthreads();
    int pos = __popc(m & ((1u << lane) - 1u)), count = 0;
#pragma unroll
    for (int i = 0; i < kBwdWarps; ++i) {
      pos += i < warp ? warp_hits[i] : 0;
      count += warp_hits[i];
    }
    if (hit) hits[pos] = n;
    __syncthreads();

    for (int k = 0; k < count; ++k) {
      const int bn = b * n_boxes + hits[k];
      const char* src = reinterpret_cast<const char*>(cot) +
                        ((size_t)bn * kPooled * kPooled * c + c0) * sizeof(T);
      for (int i = threadIdx.x; i < kPooled * kPooled * kVecs; i += kBwdThreads) {
        const int q = i / kVecs, v = i % kVecs;
        if (v < nvec) cp_async16(gs_s + q * kSliceBytes + v * 16, src + (size_t)q * c * sizeof(T) + v * 16);
      }
      cp_async_commit();
      if (warp < 2) {
        float start, len;
        axis_extent(boxes[bn], warp == 1, scale, &start, &len);
        if (warp == 1) {
          adjoint_axis(start, len, w, 1.0f, x0, col_of, wx, span_x);
        } else {
          adjoint_axis(start, len, h, 1.0f / (kSr * kSr), y0, row_of, wy, span_y);
        }
      }
      cp_async_wait<0>();
      __syncthreads();

      const int dy = row_of[warp];
      if (dy >= 0 && live) {
        const int sy = span_y[dy];
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          const int dx = col_of[j];
          if (dx < 0) continue;
          const int sx = span_x[dx];
          for (int py = sy & 0xff; py <= (sy >> 8); ++py) {
            const unsigned char* g_row = gs + py * kPooled * kSliceBytes + lane * 8;
            float t[kE];
#pragma unroll
            for (int e = 0; e < kE; ++e) t[e] = 0.0f;
            for (int px = sx & 0xff; px <= (sx >> 8); ++px) {
              fma8(t, *reinterpret_cast<const uint2*>(g_row + px * kSliceBytes), wx[dx][px]);
            }
            const float a = wy[dy][py];
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[j][e] += a * t[e];
          }
        }
      }
      __syncthreads();  // the next box overwrites the stage and the geometry
    }
  }

  const int y = y0 + warp;
  if (y < h && live) {
    T* row = static_cast<T*>(grad) + (((size_t)b * h + y) * w + x0) * c + c0 + lane * kE;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (x0 + j < w) store8(row + (size_t)j * c, acc[j]);
    }
  }
}

template <typename T>
int launch_adjoint(void* g0, void* g1, void* g2, void* g3, const int* hw, const float* scales,
                   const float* boxes, const int* levels, const void* cot, int n_images,
                   int n_boxes, int c, void* stream) {
  GradLevels lv;
  void* grads[4] = {g0, g1, g2, g3};
  const int slice = kSliceBytes / (int)sizeof(T);
  const long long n_slices = (c + slice - 1) / slice;
  long long total = 0;
  for (int i = 0; i < 4; ++i) {
    lv.grads[i] = grads[i];
    lv.h[i] = hw[2 * i];
    lv.w[i] = hw[2 * i + 1];
    lv.scale[i] = scales[i];
    lv.tiles_x[i] = (lv.w[i] + kTile - 1) / kTile;
    lv.first[i] = (int)total;
    total += n_images * n_slices * lv.tiles_x[i] * ((lv.h[i] + kTile - 1) / kTile);
    if (total > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  }
  if (total == 0) return (int)cudaSuccess;
  roi_align_adjoint_kernel<T><<<(unsigned)total, kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, reinterpret_cast<const float4*>(boxes), levels, static_cast<const T*>(cot), n_boxes,
      (int)n_slices, c);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers except
// `hw` ([4][2] level sizes) and `scales` ([4]), which live on the host.
// `levels` holds each box's level.  The maps, boxes and output must be 16-byte
// aligned and c a multiple of 8.  Returns cudaGetLastError() after the launch
// (0 = cudaSuccess).
extern "C" int skghoi_roi_align_fwd_f32(const void* f0, const void* f1, const void* f2,
                                        const void* f3, const int* hw, const float* scales,
                                        const float* boxes, const int* levels, void* out,
                                        int n_images, int n_boxes, int c, void* stream) {
  return launch<float>(f0, f1, f2, f3, hw, scales, boxes, levels, out, n_images, n_boxes, c,
                       stream);
}

extern "C" int skghoi_roi_align_fwd_bf16(const void* f0, const void* f1, const void* f2,
                                         const void* f3, const int* hw, const float* scales,
                                         const float* boxes, const int* levels, void* out,
                                         int n_images, int n_boxes, int c, void* stream) {
  return launch<__nv_bfloat16>(f0, f1, f2, f3, hw, scales, boxes, levels, out, n_images,
                               n_boxes, c, stream);
}

// The adjoint: g0..g3 ([B, H_l, W_l, C], every element written) from the
// cotangent ([B, N, 7, 7, C]) in the same dtype; the other arguments as for
// the forward.  No atomics: the same inputs give the same bits every call.
extern "C" int skghoi_roi_align_bwd_f32(void* g0, void* g1, void* g2, void* g3, const int* hw,
                                        const float* scales, const float* boxes,
                                        const int* levels, const void* grad_out, int n_images,
                                        int n_boxes, int c, void* stream) {
  return launch_adjoint<float>(g0, g1, g2, g3, hw, scales, boxes, levels, grad_out, n_images,
                               n_boxes, c, stream);
}

extern "C" int skghoi_roi_align_bwd_bf16(void* g0, void* g1, void* g2, void* g3, const int* hw,
                                         const float* scales, const float* boxes,
                                         const int* levels, const void* grad_out, int n_images,
                                         int n_boxes, int c, void* stream) {
  return launch_adjoint<__nv_bfloat16>(g0, g1, g2, g3, hw, scales, boxes, levels, grad_out,
                                       n_images, n_boxes, c, stream);
}
