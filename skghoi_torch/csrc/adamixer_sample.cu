// AdaMixer's adaptive 3D sampling (skghoi_torch/detect/adamixer.py::_sample_grouped)
// for Hopper (sm_90a), one kernel a stage each way:
//
//   forward   out[p, :] = sum over levels l = 0..L-1 (in that order) of
//             bilinear(feat_l[b, g], x_p / s_l, y_p / s_l) * wts[p, l]
//   adjoint   the gradients of the L level maps, of x_p and y_p, and of wts
//
// for every point p of a [B, G, M] grid, point group g reading its own
// c = C/G channels of each level, laid out [B, G, H_l * W_l, c] and
// contiguous (detect/adamixer.py::group_pyramid).  Bilinear taps clamp to
// the map (border padding); align_corners=False puts pixel centres at +0.5.
//
// It replaces no Pallas kernel: the JAX package samples with XLA gathers
// (skghoi_tpu/detect/adamixer.py::sample_3d), which XLA fuses on the TPU.
// Eagerly the sampling is some 220 launches a stage (4 taps of 7 ops on
// each of 4 levels, the blends, the weights and the level sum) and its
// autograd backward about as many again, with a zero fill of a whole level
// map and a scatter-add for each gather.
//
// Bound on the card: bytes.  The compulsory traffic is the points, the
// weights and the [B, G, M, c] output (forward) or its gradient (adjoint)
// once, plus each distinct tap cell of the pyramid read once (and, in the
// adjoint, its gradient written once): under 100 MB a stage at the training
// cell's size.  So:
//   * 16 lanes a point, each with one 16-byte vector of the 64-channel
//     slice (4 float32 or 2 float64 channels; a lane loops when the slice is
//     wider), so a warp holds two points and every tap is a 256-byte row
//     read by 16 neighbouring lanes.  A group's points are consecutive in
//     p, and a query's 32 points sit around its box, so neighbouring warps
//     share the taps' L2 lines; the taps are read through the read-only
//     path (__ldg), 16 independent 16-byte loads a lane in flight;
//   * the forward writes one 16-byte vector a lane; the adjoint adds its
//     four tap gradients into the zeroed level gradients with one vector
//     float atomic each (float4 atomicAdd, red.global.add.v4.f32 on sm_90;
//     two double atomicAdds in float64), and reduces the per-channel
//     products of grad x, grad y and grad wts across the 16 lanes by
//     shuffles.
//
// Bits: the forward equals the eager route's output bit for bit in float32
// and float64.  Each step is one correctly rounded operation, in the eager
// route's order, with __fmul_rn/__fadd_rn/__fsub_rn (double: __d*_rn) so
// nothing is contracted into an FMA: x * (1/s) (PyTorch divides by a scalar
// through its reciprocal), - 0.5, floor, wx = xf - x0, the taps
// iy.clamp(0, H-1) * W + ix.clamp(0, W-1) of x0, x0 + 1, y0, y0 + 1,
// top = t00 * (1 - wx) + t10 * wx, bot alike, r = top * (1 - wy) + bot * wy,
// times wts[l], summed over the levels from 0.  The adjoint's atomics sum in
// an order that changes from run to run, and its reductions in another order
// than autograd's: it agrees with the plain adjoint to rounding.  floor
// passes no gradient; a clamped tap passes its gradient through its weights,
// as autograd does.
//
// C interface (ctypes): dtype 0 float32, 2 float64; feats/grads, heights,
// widths and inv_strides are host arrays of `levels` (at most 4) entries;
// pts [B*G*M, 3] (x, y in image pixels; z unused), wts [B*G*M, levels],
// out / grad_out [B*G*M, c], grad_pts [B*G*M, 3] (z written 0), grad_wts
// like wts; bg = B*G, m = M.  Each returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 16;  // lanes a point
constexpr int POINTS_PER_BLOCK = THREADS / LANES;
constexpr int MAX_LEVELS = 4;

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float floor_(float a) { return floorf(a); }
};

template <>
struct Num<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double floor_(double a) { return floor(a); }
};

template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T>
__device__ __forceinline__ Vec<T> load_ro(const T* p) {
  union {
    int4 raw;
    Vec<T> vec;
  } u;
  u.raw = __ldg(reinterpret_cast<const int4*>(p));
  return u.vec;
}

__device__ __forceinline__ void atomic_add_vec(float* p, const Vec<float>& d) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(d.v[0], d.v[1], d.v[2], d.v[3]));
}

__device__ __forceinline__ void atomic_add_vec(double* p, const Vec<double>& d) {
  atomicAdd(p, d.v[0]);
  atomicAdd(p + 1, d.v[1]);
}

struct Levels {
  const void* feat[MAX_LEVELS];
  void* grad[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  double inv_stride[MAX_LEVELS];
  int count;
};

// A tap index as the eager route computes it: v.long().clamp(0, n - 1).  The
// conversion saturates (and takes NaN to 0), as PyTorch's does on the card.
__device__ __forceinline__ int64_t clamp_index(float v, int n) {
  const int64_t i = static_cast<int64_t>(v);
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

__device__ __forceinline__ int64_t clamp_index(double v, int n) {
  const int64_t i = static_cast<int64_t>(v);
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// One level's four taps of one point: each tap's element offset in the
// level's [B, G, H*W, c] tensor, and the blend weights.
template <typename T>
struct Taps {
  int64_t o00, o10, o01, o11;
  T wx, wy, omx, omy;
};

template <typename T>
__device__ __forceinline__ Taps<T> taps_at(T x, T y, const Levels& lv, int l, int64_t bg, int c) {
  using N = Num<T>;
  const int h = lv.h[l], w = lv.w[l];
  const T inv = static_cast<T>(lv.inv_stride[l]);
  const T xf = N::sub(N::mul(x, inv), T(0.5));
  const T yf = N::sub(N::mul(y, inv), T(0.5));
  const T x0 = N::floor_(xf), y0 = N::floor_(yf);
  Taps<T> t;
  t.wx = N::sub(xf, x0);
  t.wy = N::sub(yf, y0);
  t.omx = N::sub(T(1), t.wx);
  t.omy = N::sub(T(1), t.wy);
  const int64_t ix0 = clamp_index(x0, w), ix1 = clamp_index(N::add(x0, T(1)), w);
  const int64_t iy0 = clamp_index(y0, h), iy1 = clamp_index(N::add(y0, T(1)), h);
  const int64_t base = bg * static_cast<int64_t>(h) * w;
  t.o00 = (base + iy0 * w + ix0) * c;
  t.o10 = (base + iy0 * w + ix1) * c;
  t.o01 = (base + iy1 * w + ix0) * c;
  t.o11 = (base + iy1 * w + ix1) * c;
  return t;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
adamixer_sample_forward_kernel(Levels lv, const T* __restrict__ pts, const T* __restrict__ wts,
                               T* __restrict__ out, int64_t points, int64_t m, int c) {
  using N = Num<T>;
  constexpr int VEC = Vec<T>::N;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * POINTS_PER_BLOCK + threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  if (p >= points) return;
  const int64_t bg = p / m;
  const T x = __ldg(pts + 3 * p), y = __ldg(pts + 3 * p + 1);
  Taps<T> taps[MAX_LEVELS];
  T wl[MAX_LEVELS];
#pragma unroll
  for (int l = 0; l < MAX_LEVELS; ++l) {
    if (l < lv.count) {
      taps[l] = taps_at(x, y, lv, l, bg, c);
      wl[l] = __ldg(wts + p * lv.count + l);
    }
  }
  for (int v = lane * VEC; v < c; v += LANES * VEC) {
    Vec<T> acc;
#pragma unroll
    for (int l = 0; l < MAX_LEVELS; ++l) {
      if (l >= lv.count) break;
      const T* feat = static_cast<const T*>(lv.feat[l]) + v;
      const Taps<T>& t = taps[l];
      const Vec<T> t00 = load_ro(feat + t.o00), t10 = load_ro(feat + t.o10);
      const Vec<T> t01 = load_ro(feat + t.o01), t11 = load_ro(feat + t.o11);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const T top = N::add(N::mul(t00.v[e], t.omx), N::mul(t10.v[e], t.wx));
        const T bot = N::add(N::mul(t01.v[e], t.omx), N::mul(t11.v[e], t.wx));
        const T term = N::mul(N::add(N::mul(top, t.omy), N::mul(bot, t.wy)), wl[l]);
        acc.v[e] = l == 0 ? term : N::add(acc.v[e], term);
      }
    }
    *reinterpret_cast<Vec<T>*>(out + p * c + v) = acc;
  }
}

template <typename T>
__device__ __forceinline__ T lanes_sum(T v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off, LANES);
  return v;
}

// Every lane of a warp runs to the shuffles: the lanes of a point past the
// end keep zeros and touch no memory.
template <typename T>
__global__ void __launch_bounds__(THREADS)
adamixer_sample_adjoint_kernel(Levels lv, const T* __restrict__ pts, const T* __restrict__ wts,
                               const T* __restrict__ grad_out, T* __restrict__ grad_pts,
                               T* __restrict__ grad_wts, int64_t points, int64_t m, int c) {
  using N = Num<T>;
  constexpr int VEC = Vec<T>::N;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * POINTS_PER_BLOCK + threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const bool active = p < points;
  T gwx[MAX_LEVELS], gwy[MAX_LEVELS], gw[MAX_LEVELS];
#pragma unroll
  for (int l = 0; l < MAX_LEVELS; ++l) gwx[l] = gwy[l] = gw[l] = T(0);
  if (active) {
    const int64_t bg = p / m;
    const T x = __ldg(pts + 3 * p), y = __ldg(pts + 3 * p + 1);
    Taps<T> taps[MAX_LEVELS];
    T wl[MAX_LEVELS];
#pragma unroll
    for (int l = 0; l < MAX_LEVELS; ++l) {
      if (l < lv.count) {
        taps[l] = taps_at(x, y, lv, l, bg, c);
        wl[l] = __ldg(wts + p * lv.count + l);
      }
    }
    for (int v = lane * VEC; v < c; v += LANES * VEC) {
      const Vec<T> g = load_ro(grad_out + p * c + v);
#pragma unroll
      for (int l = 0; l < MAX_LEVELS; ++l) {
        if (l >= lv.count) break;
        const T* feat = static_cast<const T*>(lv.feat[l]) + v;
        T* grad = static_cast<T*>(lv.grad[l]) + v;
        const Taps<T>& t = taps[l];
        const Vec<T> t00 = load_ro(feat + t.o00), t10 = load_ro(feat + t.o10);
        const Vec<T> t01 = load_ro(feat + t.o01), t11 = load_ro(feat + t.o11);
        Vec<T> d00, d10, d01, d11;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const T top = N::add(N::mul(t00.v[e], t.omx), N::mul(t10.v[e], t.wx));
          const T bot = N::add(N::mul(t01.v[e], t.omx), N::mul(t11.v[e], t.wx));
          const T r = N::add(N::mul(top, t.omy), N::mul(bot, t.wy));
          const T gr = N::mul(g.v[e], wl[l]);
          const T gtop = N::mul(gr, t.omy), gbot = N::mul(gr, t.wy);
          d00.v[e] = N::mul(gtop, t.omx);
          d10.v[e] = N::mul(gtop, t.wx);
          d01.v[e] = N::mul(gbot, t.omx);
          d11.v[e] = N::mul(gbot, t.wx);
          gwx[l] += gtop * (t10.v[e] - t00.v[e]) + gbot * (t11.v[e] - t01.v[e]);
          gwy[l] += gr * (bot - top);
          gw[l] += g.v[e] * r;
        }
        atomic_add_vec(grad + t.o00, d00);
        atomic_add_vec(grad + t.o10, d10);
        atomic_add_vec(grad + t.o01, d01);
        atomic_add_vec(grad + t.o11, d11);
      }
    }
  }
  T gx = T(0), gy = T(0);
#pragma unroll
  for (int l = 0; l < MAX_LEVELS; ++l) {
    if (l >= lv.count) break;
    const T inv = static_cast<T>(lv.inv_stride[l]);
    gx += lanes_sum(gwx[l]) * inv;  // d(x / s)/dx; floor passes nothing
    gy += lanes_sum(gwy[l]) * inv;
    gw[l] = lanes_sum(gw[l]);
  }
  if (active && lane == 0) {
    grad_pts[3 * p] = gx;
    grad_pts[3 * p + 1] = gy;
    grad_pts[3 * p + 2] = T(0);
#pragma unroll
    for (int l = 0; l < MAX_LEVELS; ++l) {
      if (l < lv.count) grad_wts[p * lv.count + l] = gw[l];
    }
  }
}

cudaError_t levels_from(const void* const* feats, void* const* grads, const int* heights,
                        const int* widths, const double* inv_strides, int levels, Levels* lv) {
  if (levels < 1 || levels > MAX_LEVELS) return cudaErrorInvalidValue;
  *lv = Levels{};
  lv->count = levels;
  for (int l = 0; l < levels; ++l) {
    lv->feat[l] = feats[l];
    lv->grad[l] = grads == nullptr ? nullptr : grads[l];
    lv->h[l] = heights[l];
    lv->w[l] = widths[l];
    lv->inv_stride[l] = inv_strides[l];
  }
  return cudaSuccess;
}

unsigned blocks_for(int64_t points) {
  return static_cast<unsigned>((points + POINTS_PER_BLOCK - 1) / POINTS_PER_BLOCK);
}

}  // namespace

extern "C" int skghoi_adamixer_sample_fwd(int dtype, const void* const* feats, const int* heights,
                                          const int* widths, const double* inv_strides,
                                          int levels, const void* pts, const void* wts, void* out,
                                          int64_t bg, int64_t m, int c, void* stream) {
  Levels lv;
  cudaError_t err = levels_from(feats, nullptr, heights, widths, inv_strides, levels, &lv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t points = bg * m;
  if (points == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      adamixer_sample_forward_kernel<float><<<blocks_for(points), THREADS, 0, s>>>(
          lv, static_cast<const float*>(pts), static_cast<const float*>(wts),
          static_cast<float*>(out), points, m, c);
      break;
    case 2:
      adamixer_sample_forward_kernel<double><<<blocks_for(points), THREADS, 0, s>>>(
          lv, static_cast<const double*>(pts), static_cast<const double*>(wts),
          static_cast<double*>(out), points, m, c);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int skghoi_adamixer_sample_bwd(int dtype, const void* const* feats, void* const* grads,
                                          const int* heights, const int* widths,
                                          const double* inv_strides, int levels, const void* pts,
                                          const void* wts, const void* grad_out, void* grad_pts,
                                          void* grad_wts, int64_t bg, int64_t m, int c,
                                          void* stream) {
  Levels lv;
  cudaError_t err = levels_from(feats, grads, heights, widths, inv_strides, levels, &lv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t points = bg * m;
  if (points == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      adamixer_sample_adjoint_kernel<float><<<blocks_for(points), THREADS, 0, s>>>(
          lv, static_cast<const float*>(pts), static_cast<const float*>(wts),
          static_cast<const float*>(grad_out), static_cast<float*>(grad_pts),
          static_cast<float*>(grad_wts), points, m, c);
      break;
    case 2:
      adamixer_sample_adjoint_kernel<double><<<blocks_for(points), THREADS, 0, s>>>(
          lv, static_cast<const double*>(pts), static_cast<const double*>(wts),
          static_cast<const double*>(grad_out), static_cast<double*>(grad_pts),
          static_cast<double*>(grad_wts), points, m, c);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
