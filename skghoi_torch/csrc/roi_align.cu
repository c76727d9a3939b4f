// Multi-scale RoIAlign forward for Hopper (sm_90a), NHWC feature maps.
//
// Replaces the Pallas TPU kernel skghoi_tpu/ops/pallas_roi_align.py
// (pallas_multiscale_roi_align / _kernel, together with its overflow rescue
// roi_align_exact): torchvision roi_align, aligned=False, 7x7 output,
// sampling ratio 2, one FPN level per box.  It computes every box exactly,
// whatever its span: samples are read straight from global memory / L2, so
// there is no window and no rescue path.
//
// Bound on the card: bytes.  Per output value it does 16 multiply-adds over
// 16 loads, so the time floor is the distinct map cells the boxes touch plus
// the output, over HBM bandwidth.  Design for that:
//   * one block per (box, output row), threads over channels, two channels a
//     thread: every load is a coalesced 4-byte (bf16x2) or 8-byte (float2)
//     access along the contiguous C axis of NHWC;
//   * the row's 2 y samples and the box's 14 x samples (low/high index,
//     weights, out-of-bounds zeroing, clamp-to-edge, minimum RoI of 1 cell)
//     are computed once into shared memory by 16 threads;
//   * fp32 accumulation, one store in the maps' dtype.
// Neighbouring samples share corners, so repeated reads hit L1/L2 and DRAM
// traffic stays near the distinct-cell floor.
//
// The level of each box comes from the caller (the same LevelMapper op the
// plain version uses), so both pick the same level at an exact boundary.
// Sample positions use the plain version's fp32 formula with explicit
// round-to-nearest intrinsics, so the compiler cannot contract them into FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPooled = 7;
constexpr int kSr = 2;
constexpr int kSamples = kPooled * kSr;  // samples per axis
constexpr int kThreads = 128;

struct Levels {
  const void* maps[4];
  int h[4];
  int w[4];
  float scale[4];  // 1 / stride
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

// One sample position along one axis: low/high cell and their weights, with
// torchvision's boundary rules.  Out-of-bounds samples get zero weights.
__device__ __forceinline__ void axis_sample(float start, float roi_len, int size, int s,
                                            int* lo, int* hi, float* w_lo, float* w_hi) {
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(Levels lv, const float* __restrict__ boxes,
                     const int* __restrict__ levels, T* __restrict__ out, int n_boxes, int c) {
  const int row = blockIdx.x % kPooled;
  const int box = blockIdx.x / kPooled;
  const int img = box / n_boxes;
  const int l = levels[box];
  const int h = lv.h[l], w = lv.w[l];
  const float scale = lv.scale[l];

  __shared__ int x_lo[kSamples], x_hi[kSamples], y_lo[kSr], y_hi[kSr];
  __shared__ float xw_lo[kSamples], xw_hi[kSamples], yw_lo[kSr], yw_hi[kSr];

  const int t = threadIdx.x;
  if (t < kSamples + kSr) {
    const float* bx = boxes + (size_t)box * 4;
    const bool is_x = t < kSamples;
    const int axis = is_x ? 0 : 1;
    const float start = bx[axis] * scale;
    const float roi_len = fmaxf(__fsub_rn(bx[axis + 2] * scale, start), 1.0f);
    if (is_x) {
      axis_sample(start, roi_len, w, t, &x_lo[t], &x_hi[t], &xw_lo[t], &xw_hi[t]);
    } else {
      const int i = t - kSamples;
      axis_sample(start, roi_len, h, row * kSr + i, &y_lo[i], &y_hi[i], &yw_lo[i], &yw_hi[i]);
    }
  }
  __syncthreads();

  const T* fm = static_cast<const T*>(lv.maps[l]) + (size_t)img * h * w * c;
  T* o = out + ((size_t)box * kPooled + row) * kPooled * c;
  for (int ch = 2 * t; ch < c; ch += 2 * kThreads) {
    for (int px = 0; px < kPooled; ++px) {
      float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int sy = 0; sy < kSr; ++sy) {
        const T* r_lo = fm + (size_t)y_lo[sy] * w * c + ch;
        const T* r_hi = fm + (size_t)y_hi[sy] * w * c + ch;
#pragma unroll
        for (int sx = 0; sx < kSr; ++sx) {
          const int s = px * kSr + sx;
          const float w00 = yw_lo[sy] * xw_lo[s], w01 = yw_lo[sy] * xw_hi[s];
          const float w10 = yw_hi[sy] * xw_lo[s], w11 = yw_hi[sy] * xw_hi[s];
          const float2 v00 = load2(r_lo + (size_t)x_lo[s] * c);
          const float2 v01 = load2(r_lo + (size_t)x_hi[s] * c);
          const float2 v10 = load2(r_hi + (size_t)x_lo[s] * c);
          const float2 v11 = load2(r_hi + (size_t)x_hi[s] * c);
          acc.x += w00 * v00.x + w01 * v01.x + w10 * v10.x + w11 * v11.x;
          acc.y += w00 * v00.y + w01 * v01.y + w10 * v10.y + w11 * v11.y;
        }
      }
      const float inv = 1.0f / (kSr * kSr);
      store2(o + (size_t)px * c + ch, make_float2(acc.x * inv, acc.y * inv));
    }
  }
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
  const int blocks = n_images * n_boxes * kPooled;
  if (blocks > 0) {
    roi_align_fwd_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        lv, boxes, levels, static_cast<T*>(out), n_boxes, c);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers except
// `hw` ([4][2] level sizes) and `scales` ([4]), which live on the host.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
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
