// Eval-mode batch norm on the H100, in flax's order and rounding, in one
// pass over the activation.
//
// The counterpart of flax's nn.BatchNorm(use_running_average=True) in
// float32 (odtpu/models/common.py:177-180), which XLA fuses into the
// conv's consumer on the TPU (no Pallas kernel). Per element of channel c:
//     y = ((x - mean[c]) * mul[c]) + bias[c],  mul = rsqrt(var + eps) * scale
// with each operation rounded on its own (no fused multiply-add: flax
// rounds the product and the sum apart, and an FMA would move the last
// bit, which int8 serving's quantization then spreads), in float32 for a
// bfloat16 or float32 activation and in float64 for a float64 one; y is
// rounded to the activation's dtype as it is stored (round to nearest
// even, as torch's cast). The caller computes `mul` in torch, so this
// kernel and its plain twin (ops/cuda/batch_norm.py) share it.
//
// What bounds it: one read and one write of the activation (4 bytes an
// element in bfloat16) and 3 floating-point operations an element, so
// HBM at 3.35 TB/s, never the ALUs. The plain torch version takes four
// passes (subtract, multiply, add into a float32 temporary, cast), ~28
// bytes an element.
//
// Layout: NCHW, either contiguous (channel = (i / HW) % C) or
// channels-last (channel = i % C), told by `inner` (HW or 1). A thread
// takes 8 consecutive elements with one 16-byte (bf16) or 32-byte (f32)
// load and store when 8 divides the row of one channel (inner) or C
// (channels-last) and the pointers are aligned; channels-last, it reads
// the 8 channels' mean, mul and bias as packs too. Otherwise one element
// at a time.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 8;
constexpr int kThreads = 256;

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }

__device__ __forceinline__ void from_acc(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void from_acc(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_acc(double v, double* out) {
  *out = v;
}

__device__ __forceinline__ float norm(float x, float m, float k, float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, m), k), b);
}
__device__ __forceinline__ double norm(double x, double m, double k,
                                       double b) {
  return __dadd_rn(__dmul_rn(__dsub_rn(x, m), k), b);
}

template <typename T> struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

// channel of element i; I is 32-bit where the tensor allows it (a
// 64-bit division is emulated in ~70 instructions)
template <typename I>
__device__ __forceinline__ int channel(I i, I inner, I c) {
  return int((i / inner) % c);
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    bn_eval_vec_kernel(const T* __restrict__ x,
                       const typename Acc<T>::type* __restrict__ mean,
                       const typename Acc<T>::type* __restrict__ mul,
                       const typename Acc<T>::type* __restrict__ bias,
                       T* __restrict__ y, I packs, I c, I inner) {
  using A = typename Acc<T>::type;
  const Pack<T>* xp = reinterpret_cast<const Pack<T>*>(x);
  Pack<T>* yp = reinterpret_cast<Pack<T>*>(y);
  for (I p = blockIdx.x * I(kThreads) + threadIdx.x; p < packs;
       p += I(gridDim.x) * kThreads) {
    const Pack<T> in = xp[p];
    Pack<T> out;
    const I i = p * kVec;
    if (inner == 1) {  // channels-last: 8 consecutive channels, their
                       // parameters read as packs too
      const int c0 = int(i % c);
      const Pack<A> m = *reinterpret_cast<const Pack<A>*>(mean + c0);
      const Pack<A> k = *reinterpret_cast<const Pack<A>*>(mul + c0);
      const Pack<A> b = *reinterpret_cast<const Pack<A>*>(bias + c0);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        from_acc(norm(to_acc(in.v[e]), m.v[e], k.v[e], b.v[e]), &out.v[e]);
      }
    } else {  // contiguous: 8 elements of one channel
      const int ch = channel(i, inner, c);
      const A m = mean[ch], k = mul[ch], b = bias[ch];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        from_acc(norm(to_acc(in.v[e]), m, k, b), &out.v[e]);
      }
    }
    yp[p] = out;
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    bn_eval_kernel(const T* __restrict__ x,
                   const typename Acc<T>::type* __restrict__ mean,
                   const typename Acc<T>::type* __restrict__ mul,
                   const typename Acc<T>::type* __restrict__ bias,
                   T* __restrict__ y, I n, I c, I inner) {
  for (I i = blockIdx.x * I(kThreads) + threadIdx.x; i < n;
       i += I(gridDim.x) * kThreads) {
    const int ch = channel(i, inner, c);
    from_acc(norm(to_acc(x[i]), mean[ch], mul[ch], bias[ch]), &y[i]);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (count <= 0) count = 132;
  }
  return count;
}

template <typename T, typename I>
cudaError_t launch(const void* x, const void* mean, const void* mul,
                   const void* bias, void* y, I n, I c, I inner,
                   cudaStream_t stream) {
  using A = typename Acc<T>::type;
  auto at = [](const void* p, size_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const bool aligned = at(x, sizeof(Pack<T>)) && at(y, sizeof(Pack<T>));
  const bool params = at(mean, sizeof(Pack<A>)) &&
                      at(mul, sizeof(Pack<A>)) && at(bias, sizeof(Pack<A>));
  const bool vec = aligned && (inner == 1 ? c % kVec == 0 && params
                                          : inner % kVec == 0);
  const I work = vec ? n / kVec : n;
  // enough blocks to fill every SM several times over, each thread then
  // striding through the rest
  const int64_t want = (int64_t(work) + kThreads - 1) / kThreads;
  const int blocks = int(want < 16 * sm_count() ? want : 16 * sm_count());
  if (vec) {
    bn_eval_vec_kernel<T, I><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const A*>(mean),
        static_cast<const A*>(mul), static_cast<const A*>(bias),
        static_cast<T*>(y), work, c, inner);
  } else {
    bn_eval_kernel<T, I><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const A*>(mean),
        static_cast<const A*>(mul), static_cast<const A*>(bias),
        static_cast<T*>(y), n, c, inner);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y = bn(x) for n elements of C channels; dtype 0 = bfloat16 (mean, mul,
// bias float32), 1 = float32 (float32), 2 = float64 (float64). `inner`
// is H*W for a contiguous NCHW tensor, 1 for channels-last. Launches on
// `stream` and returns the launch's error code. The caller checks
// shapes, dtypes, devices and layouts.
cudaError_t odtpu_bn_eval(const void* x, const void* mean, const void* mul,
                          const void* bias, void* y, int64_t n, int c,
                          int64_t inner, int dtype, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  // a grid-stride index stays below n + blocks * threads
  if (n < (int64_t(1) << 30)) {
    const int32_t n32 = int32_t(n), c32 = c, in32 = int32_t(inner);
    switch (dtype) {
      case 0:
        return launch<__nv_bfloat16, int32_t>(x, mean, mul, bias, y, n32,
                                              c32, in32, stream);
      case 1:
        return launch<float, int32_t>(x, mean, mul, bias, y, n32, c32, in32,
                                      stream);
      case 2:
        return launch<double, int32_t>(x, mean, mul, bias, y, n32, c32,
                                       in32, stream);
    }
    return cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0:
      return launch<__nv_bfloat16, int64_t>(x, mean, mul, bias, y, n,
                                            int64_t(c), inner, stream);
    case 1:
      return launch<float, int64_t>(x, mean, mul, bias, y, n, int64_t(c),
                                    inner, stream);
    case 2:
      return launch<double, int64_t>(x, mean, mul, bias, y, n, int64_t(c),
                                     inner, stream);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
