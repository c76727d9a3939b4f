// FrozenBatchNorm's epilogue in the ResNet-50 body, for Hopper (sm_90a):
//
//   forward   out = act(round(round(x * inv) + shift) [+ residual])
//   backward  g = relu ? (out <= 0 ? 0 : gy) : gy;  gx = round(g * inv);
//             and g itself as the residual's gradient
//
// per channel, one kernel a site each way.  inv and shift are the frozen
// statistics folded into a scale and a shift (models/resnet.py), in the
// activation's dtype.
//
// It replaces no Pallas kernel: on the TPU, XLA fuses the multiply-add into
// the convolution, and the residual add and ReLU into the same fusion
// (skghoi_tpu/models/resnet.py:44).  Eager PyTorch runs the chain as four
// passes over the activation (multiply, add, residual add, ReLU), the first
// two on the generic, unvectorised broadcast path that a [1, C, 1, 1]
// operand over a channels_last tensor takes.
//
// Bound on the card: bytes.  It does two to four flops an element against 4
// to 6 bytes moved in bf16.  The floor is each activation read once and
// written once, and the residual read once: 9.89 GB for the 53 sites of a
// detect batch (bf16, 832x1344, batch 8), 2.95 ms at 3.35 TB/s.  So:
//   * one pass a site, forward and backward: the intermediate roundings
//     stay in registers;
//   * 16-byte loads and stores (8 bf16, 4 float32 or 2 float64 elements a
//     thread), neighbouring threads on neighbouring addresses.  Channels
//     last, the 8 lanes of a bf16 vector are 8 neighbouring channels of one
//     pixel (every C of the body is a multiple of 8), and their constants
//     are one 16-byte load, which L1 serves after the first pixel.  NCHW
//     (also taken) has one channel a vector when H*W is a multiple of the
//     vector; anything unaligned or indivisible runs the same code one
//     element a thread;
//   * a grid-stride loop over as many blocks as the SMs hold at once, with
//     the channel carried from one step to the next by an addition, so the
//     loop divides nothing.
//
// Bits: the output equals the eager composition's bit for bit in bf16,
// float32 and float64.  Each step is one correctly rounded operation in
// float (double for float64) followed by rounding to the storage type, as
// PyTorch's elementwise kernels compute: __fmul_rn/__fadd_rn (__dmul_rn/
// __dadd_rn) so nothing is contracted into an FMA, __float2bfloat16_rn for
// each bf16 step.  The ReLU keeps a NaN as clamp_min does (the train step's
// NaN guard depends on it); the backward zeroes by threshold_backward's rule
// on the saved output, and multiplies the zero too, as autograd does.
//
// C interface (ctypes): dtype 0 float32, 1 bfloat16, 2 float64; n elements of
// C channels and H*W = hw; nhwc 1 for channels_last-contiguous, 0 for
// NCHW-contiguous; residual, out (backward: relu_out) and gres may be null;
// sms, the device's SM count.  Each returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// Storage type T and arithmetic type A.  relu keeps a NaN (v != v), as clamp_min does.
template <typename T>
struct Num;

template <>
struct Num<float> {
  using A = float;
  static __device__ __forceinline__ A up(float v) { return v; }
  static __device__ __forceinline__ float down(A v) { return v; }
  static __device__ __forceinline__ A mul(A a, A b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ A add(A a, A b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ A relu(A v) { return v != v ? v : fmaxf(v, 0.0f); }
};

template <>
struct Num<double> {
  using A = double;
  static __device__ __forceinline__ A up(double v) { return v; }
  static __device__ __forceinline__ double down(A v) { return v; }
  static __device__ __forceinline__ A mul(A a, A b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ A add(A a, A b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ A relu(A v) { return v != v ? v : fmax(v, 0.0); }
};

template <>
struct Num<__nv_bfloat16> {
  using A = float;
  static __device__ __forceinline__ A up(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 down(A v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ A mul(A a, A b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ A add(A a, A b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ A relu(A v) { return v != v ? v : fmaxf(v, 0.0f); }
};

// One rounding to the storage type, kept in the arithmetic type.
template <typename T>
__device__ __forceinline__ typename Num<T>::A rnd(typename Num<T>::A v) {
  return Num<T>::up(Num<T>::down(v));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Where a thread's first vector lies: its channel, and (NCHW) its place in the
// H*W plane.  `step` elements later the channel is c + step_c (+1 when the
// plane wraps), so the loop carries both forward by additions.
struct Cursor {
  int64_t p;
  int c;
};

template <bool NHWC>
__device__ __forceinline__ Cursor cursor_at(int64_t i, int channels, int64_t hw) {
  if constexpr (NHWC) {
    return Cursor{0, static_cast<int>(i % channels)};
  } else {
    return Cursor{i % hw, static_cast<int>((i / hw) % channels)};
  }
}

template <bool NHWC>
__device__ __forceinline__ void advance(Cursor& at, int channels, int64_t hw, int64_t step_p,
                                        int step_c) {
  if constexpr (NHWC) {
    at.c += step_c;
  } else {
    at.p += step_p;
    at.c += step_c;
    if (at.p >= hw) {
      at.p -= hw;
      at.c += 1;
    }
  }
  if (at.c >= channels) at.c -= channels;
}

// The VEC constants of a vector's elements: VEC neighbouring channels
// (channels last) or one channel for all (NCHW).
template <typename T, int VEC, bool NHWC>
__device__ __forceinline__ Pack<T, VEC> constants_at(const T* __restrict__ table, int c) {
  Pack<T, VEC> out;
  if constexpr (NHWC) {
    out = *reinterpret_cast<const Pack<T, VEC>*>(table + c);
  } else {
    const T value = table[c];
#pragma unroll
    for (int l = 0; l < VEC; ++l) out.v[l] = value;
  }
  return out;
}

template <typename T, int VEC, bool NHWC>
__global__ void __launch_bounds__(THREADS)
frozen_bn_forward_kernel(const T* __restrict__ x, const T* __restrict__ residual,
                         const T* __restrict__ inv, const T* __restrict__ shift,
                         T* __restrict__ out, int64_t nvec, int channels, int64_t hw,
                         int64_t step_p, int step_c, int relu) {
  using N = Num<T>;
  using A = typename N::A;
  using P = Pack<T, VEC>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  int64_t v = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (v >= nvec) return;
  Cursor at = cursor_at<NHWC>(v * VEC, channels, hw);
  for (; v < nvec; v += stride) {
    const P xv = reinterpret_cast<const P*>(x)[v];
    P rv;
    if (residual != nullptr) rv = reinterpret_cast<const P*>(residual)[v];
    const P iv = constants_at<T, VEC, NHWC>(inv, at.c);
    const P sv = constants_at<T, VEC, NHWC>(shift, at.c);
    P o;
#pragma unroll
    for (int l = 0; l < VEC; ++l) {
      A y = rnd<T>(N::mul(N::up(xv.v[l]), N::up(iv.v[l])));
      y = rnd<T>(N::add(y, N::up(sv.v[l])));
      if (residual != nullptr) y = rnd<T>(N::add(y, N::up(rv.v[l])));
      if (relu) y = N::relu(y);
      o.v[l] = N::down(y);
    }
    reinterpret_cast<P*>(out)[v] = o;
    advance<NHWC>(at, channels, hw, step_p, step_c);
  }
}

template <typename T, int VEC, bool NHWC>
__global__ void __launch_bounds__(THREADS)
frozen_bn_backward_kernel(const T* __restrict__ gy, const T* __restrict__ relu_out,
                          const T* __restrict__ inv, T* __restrict__ gx, T* __restrict__ gres,
                          int64_t nvec, int channels, int64_t hw, int64_t step_p, int step_c) {
  using N = Num<T>;
  using A = typename N::A;
  using P = Pack<T, VEC>;
  const T zero = N::down(A(0));
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  int64_t v = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (v >= nvec) return;
  Cursor at = cursor_at<NHWC>(v * VEC, channels, hw);
  for (; v < nvec; v += stride) {
    P g = reinterpret_cast<const P*>(gy)[v];
    if (relu_out != nullptr) {
      const P yv = reinterpret_cast<const P*>(relu_out)[v];
#pragma unroll
      for (int l = 0; l < VEC; ++l) {
        if (N::up(yv.v[l]) <= A(0)) g.v[l] = zero;
      }
    }
    const P iv = constants_at<T, VEC, NHWC>(inv, at.c);
    P o;
#pragma unroll
    for (int l = 0; l < VEC; ++l) o.v[l] = N::down(N::mul(N::up(g.v[l]), N::up(iv.v[l])));
    reinterpret_cast<P*>(gx)[v] = o;
    if (gres != nullptr) reinterpret_cast<P*>(gres)[v] = g;
    advance<NHWC>(at, channels, hw, step_p, step_c);
  }
}

// Grid and the cursor's steps for n elements in vectors of VEC.
struct Launch {
  int64_t blocks, nvec, step_p;
  int step_c;
};

// per_sm: the kernel's resident blocks an SM, asked once and kept by the caller.
template <typename Kernel>
cudaError_t plan(Kernel kernel, int& per_sm, int vec, bool nhwc, int64_t n, int channels,
                 int64_t hw, int sms, Launch* launch) {
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                          THREADS, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
  }
  launch->nvec = n / vec;
  launch->blocks = (launch->nvec + THREADS - 1) / THREADS;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  if (launch->blocks > resident) launch->blocks = resident;
  const int64_t step = launch->blocks * THREADS * vec;
  if (nhwc) {
    launch->step_p = 0;
    launch->step_c = static_cast<int>(step % channels);
  } else {
    launch->step_p = step % hw;
    launch->step_c = static_cast<int>((step / hw) % channels);
  }
  return cudaSuccess;
}

template <typename T, int VEC, bool NHWC>
cudaError_t forward_as(const void* x, const void* residual, const void* inv, const void* shift,
                       void* out, int64_t n, int channels, int64_t hw, int relu, int sms,
                       cudaStream_t stream) {
  auto kernel = frozen_bn_forward_kernel<T, VEC, NHWC>;
  static int per_sm = 0;
  Launch l;
  cudaError_t err = plan(kernel, per_sm, VEC, NHWC, n, channels, hw, sms, &l);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(l.blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(residual), static_cast<const T*>(inv),
      static_cast<const T*>(shift), static_cast<T*>(out), l.nvec, channels, hw, l.step_p,
      l.step_c, relu);
  return cudaGetLastError();
}

template <typename T, int VEC, bool NHWC>
cudaError_t backward_as(const void* gy, const void* relu_out, const void* inv, void* gx,
                        void* gres, int64_t n, int channels, int64_t hw, int sms,
                        cudaStream_t stream) {
  auto kernel = frozen_bn_backward_kernel<T, VEC, NHWC>;
  static int per_sm = 0;
  Launch l;
  cudaError_t err = plan(kernel, per_sm, VEC, NHWC, n, channels, hw, sms, &l);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(l.blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(gy), static_cast<const T*>(relu_out), static_cast<const T*>(inv),
      static_cast<T*>(gx), static_cast<T*>(gres), l.nvec, channels, hw, l.step_p, l.step_c);
  return cudaGetLastError();
}

// Whether 16-byte vectors fit: every pointer 16-byte aligned, and a vector
// never crosses a pixel (channels last) or a channel plane (NCHW).
template <typename T>
bool vectors_fit(uintptr_t pointers, int channels, int64_t hw, int nhwc) {
  constexpr int VEC = 16 / sizeof(T);
  return pointers % 16 == 0 && (nhwc ? channels % VEC == 0 : hw % VEC == 0);
}

template <typename T>
cudaError_t forward_typed(const void* x, const void* residual, const void* inv, const void* shift,
                          void* out, int64_t n, int channels, int64_t hw, int nhwc, int relu,
                          int sms, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const uintptr_t pointers = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(residual) |
                             reinterpret_cast<uintptr_t>(inv) | reinterpret_cast<uintptr_t>(shift) |
                             reinterpret_cast<uintptr_t>(out);
  const bool vec = vectors_fit<T>(pointers, channels, hw, nhwc);
  if (nhwc) {
    return vec ? forward_as<T, VEC, true>(x, residual, inv, shift, out, n, channels, hw, relu, sms, stream)
               : forward_as<T, 1, true>(x, residual, inv, shift, out, n, channels, hw, relu, sms, stream);
  }
  return vec ? forward_as<T, VEC, false>(x, residual, inv, shift, out, n, channels, hw, relu, sms, stream)
             : forward_as<T, 1, false>(x, residual, inv, shift, out, n, channels, hw, relu, sms, stream);
}

template <typename T>
cudaError_t backward_typed(const void* gy, const void* relu_out, const void* inv, void* gx,
                           void* gres, int64_t n, int channels, int64_t hw, int nhwc, int sms,
                           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const uintptr_t pointers = reinterpret_cast<uintptr_t>(gy) | reinterpret_cast<uintptr_t>(relu_out) |
                             reinterpret_cast<uintptr_t>(inv) | reinterpret_cast<uintptr_t>(gx) |
                             reinterpret_cast<uintptr_t>(gres);
  const bool vec = vectors_fit<T>(pointers, channels, hw, nhwc);
  if (nhwc) {
    return vec ? backward_as<T, VEC, true>(gy, relu_out, inv, gx, gres, n, channels, hw, sms, stream)
               : backward_as<T, 1, true>(gy, relu_out, inv, gx, gres, n, channels, hw, sms, stream);
  }
  return vec ? backward_as<T, VEC, false>(gy, relu_out, inv, gx, gres, n, channels, hw, sms, stream)
             : backward_as<T, 1, false>(gy, relu_out, inv, gx, gres, n, channels, hw, sms, stream);
}

}  // namespace

extern "C" int skghoi_frozen_bn_fwd(int dtype, const void* x, const void* residual,
                                    const void* inv, const void* shift, void* out, int64_t n,
                                    int channels, int64_t hw, int nhwc, int relu, int sms,
                                    void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return forward_typed<float>(x, residual, inv, shift, out, n, channels, hw, nhwc, relu, sms, s);
    case 1:
      return forward_typed<__nv_bfloat16>(x, residual, inv, shift, out, n, channels, hw, nhwc,
                                          relu, sms, s);
    case 2:
      return forward_typed<double>(x, residual, inv, shift, out, n, channels, hw, nhwc, relu, sms, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int skghoi_frozen_bn_bwd(int dtype, const void* gy, const void* relu_out,
                                    const void* inv, void* gx, void* gres, int64_t n,
                                    int channels, int64_t hw, int nhwc, int sms, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return backward_typed<float>(gy, relu_out, inv, gx, gres, n, channels, hw, nhwc, sms, s);
    case 1:
      return backward_typed<__nv_bfloat16>(gy, relu_out, inv, gx, gres, n, channels, hw, nhwc,
                                           sms, s);
    case 2:
      return backward_typed<double>(gy, relu_out, inv, gx, gres, n, channels, hw, nhwc, sms, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
