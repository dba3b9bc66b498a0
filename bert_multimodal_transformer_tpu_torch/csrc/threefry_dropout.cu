// Kernel T: Flax `nn.Dropout` on JAX's threefry2x32 stream, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel. Under `--rng_impl threefry2x32` the JAX
// package draws every hidden, MAG and einsum-probs dropout mask with XLA's
// own threefry op and `jax.random.bernoulli` (flax/linen/stochastic.py,
// `Dropout.__call__`: `bernoulli(make_rng("dropout"), 1 - rate, shape)`,
// then `select(mask, x / keep_prob, 0)`). Plain PyTorch would take about a
// hundred elementwise launches over the activation per site (twenty
// rounds of add, rotate and xor on int64 words); this is one launch.
//
// What it computes. For each element of x, a tensor that may be a slice of
// the full tensor the JAX model draws for (a tensor-parallel rank's heads
// or columns, a data rank's rows), the 64-bit flat index n of the element
// in the FULL shape (base + sum of i_d * stride_d), its 32 random bits
//   bits = y0 ^ y1,  (y0, y1) = Threefry2x32-20(key, (n >> 32, n & ~0u))
// (jax `_threefry_random_bits_partitionable`), the uniform
//   u = float((bits >> 9) | 0x3f800000) - 1    (jax `uniform`, float32)
// and out = (u < keep_prob) ? x / divisor : 0 in x's dtype, the division
// in fp32 and rounded once to x's dtype (divisor is 1 - rate rounded to
// x's dtype, as Flax's weak-typed scalar is). The backward applies the
// same function to the cotangent: the mask is regenerated from the key,
// nothing is saved. `ops/dropout.py::threefry_dropout_plain` is the same
// function in plain PyTorch; the two agree bit for bit.
//
// What bounds it on the card: integer work. An element costs 20 rounds of
// (add, funnel-shift rotate, xor), five key injections of three adds and
// the two initial adds, 77 32-bit integer operations, and its bytes (x
// read once, out written once: 4 bytes an element in bf16, 8 in fp32).
// The H100's 64 INT32 lanes an SM (132 SMs at 1.98 GHz, 16.7 TOP/s) take
// 77 ops in 4.6 ps an element against 1.2 ps for 4 bytes at 3.35 TB/s, so
// the operations bound it, in both dtypes.
//
// What the design does about that: nothing is spent but the Threefry
// itself. Each thread takes four consecutive elements (one 8-byte bf16x4
// or 16-byte float4 load and store when the tensor allows), walks their
// full-shape index with an increment and carry (no division past the
// first element), and the key schedule's three words are computed once.
// A grid-stride loop over at most 16 blocks an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace tfd {

constexpr int kThreads = 256;
constexpr int kVec = 4;

struct Layout {
  // x as [n0, n1, n2, n3] (row-major, contiguous); element (i0..i3) sits
  // at flat index base + i0*f0 + i1*f1 + i2*f2 + i3*f3 of the full shape.
  long long n;  // n0 * n1 * n2 * n3
  int n1, n2, n3;
  long long base, f0, f1, f2, f3;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

// Threefry-2x32, 20 rounds (jax/_src/prng.py `_threefry2x32_lowering`),
// returning the two output words xored.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t k2, uint32_t x0,
                                                  uint32_t x1) {
  x0 += k0;
  x1 += k1;
#define TFD_ROUND(r) \
  x0 += x1;          \
  x1 = rotl(x1, r) ^ x0;
  TFD_ROUND(13) TFD_ROUND(15) TFD_ROUND(26) TFD_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TFD_ROUND(17) TFD_ROUND(29) TFD_ROUND(16) TFD_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TFD_ROUND(13) TFD_ROUND(15) TFD_ROUND(26) TFD_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TFD_ROUND(17) TFD_ROUND(29) TFD_ROUND(16) TFD_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TFD_ROUND(13) TFD_ROUND(15) TFD_ROUND(26) TFD_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
#undef TFD_ROUND
  return x0 ^ x1;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four consecutive elements as one load and one store.
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using Raw = float4;
  __device__ static void unpack(const Raw& r, float v[4]) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  __device__ static Raw pack(const float v[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec4<__nv_bfloat16> {
  using Raw = uint2;
  __device__ static void unpack(const Raw& r, float v[4]) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&r.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&r.y);
    v[0] = __low2float(a); v[1] = __high2float(a);
    v[2] = __low2float(b); v[3] = __high2float(b);
  }
  __device__ static Raw pack(const float v[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    Raw r;
    r.x = *reinterpret_cast<const uint32_t*>(&a);
    r.y = *reinterpret_cast<const uint32_t*>(&b);
    return r;
  }
};

// The flat index (in the full shape) of local element i, and the local
// coordinates it decomposes into.
struct Walker {
  int i1, i2, i3;
  long long flat;
  __device__ Walker(const Layout& L, long long i) {
    i3 = (int)(i % L.n3);
    long long r = i / L.n3;
    i2 = (int)(r % L.n2);
    r /= L.n2;
    i1 = (int)(r % L.n1);
    const long long i0 = r / L.n1;
    flat = L.base + i0 * L.f0 + i1 * L.f1 + (long long)i2 * L.f2 +
           (long long)i3 * L.f3;
  }
  // Steps to the next local element.
  __device__ void next(const Layout& L) {
    flat += L.f3;
    if (++i3 < L.n3) return;
    i3 = 0;
    flat += L.f2 - (long long)L.n3 * L.f3;
    if (++i2 < L.n2) return;
    i2 = 0;
    flat += L.f1 - (long long)L.n2 * L.f2;
    if (++i1 < L.n1) return;
    i1 = 0;
    flat += L.f0 - (long long)L.n1 * L.f1;
  }
};

__device__ __forceinline__ float drop(float x, long long flat, uint32_t k0,
                                      uint32_t k1, uint32_t k2,
                                      float keep_prob, float divisor) {
  const uint32_t bits = threefry_bits(
      k0, k1, k2, (uint32_t)((unsigned long long)flat >> 32),
      (uint32_t)((unsigned long long)flat & 0xffffffffull));
  const float u = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
  return u < keep_prob ? __fdiv_rn(x, divisor) : 0.0f;
}

template <typename T, bool kVectorized>
__global__ void __launch_bounds__(kThreads)
    threefry_dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
                            Layout L, uint32_t k0, uint32_t k1,
                            float keep_prob, float divisor) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const long long stride = (long long)gridDim.x * kThreads * kVec;
  for (long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * kVec;
       i < L.n; i += stride) {
    Walker w(L, i);
    if (kVectorized) {
      // n is a multiple of 4 and x, out are aligned for the vector
      float v[4];
      Vec4<T>::unpack(*reinterpret_cast<const typename Vec4<T>::Raw*>(x + i),
                      v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        v[j] = drop(v[j], w.flat, k0, k1, k2, keep_prob, divisor);
        if (j + 1 < kVec) w.next(L);
      }
      *reinterpret_cast<typename Vec4<T>::Raw*>(out + i) = Vec4<T>::pack(v);
    } else {
      const int m = (int)(L.n - i < kVec ? L.n - i : kVec);
      for (int j = 0; j < m; ++j) {
        out[i + j] = from_float<T>(drop(to_float(x[i + j]), w.flat, k0, k1,
                                        k2, keep_prob, divisor));
        if (j + 1 < m) w.next(L);
      }
    }
  }
}

template <typename T>
int launch(const void* x, void* out, const Layout& L, uint32_t k0,
           uint32_t k1, float keep_prob, float divisor, cudaStream_t st) {
  const long long groups = (L.n + kVec - 1) / kVec;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 16LL * sms) blocks = 16LL * sms;
  const size_t align = sizeof(typename Vec4<T>::Raw);
  const bool vec = L.n % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % align == 0 &&
                   reinterpret_cast<uintptr_t>(out) % align == 0;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vec)
    threefry_dropout_kernel<T, true><<<(int)blocks, kThreads, 0, st>>>(
        xt, ot, L, k0, k1, keep_prob, divisor);
  else
    threefry_dropout_kernel<T, false><<<(int)blocks, kThreads, 0, st>>>(
        xt, ot, L, k0, k1, keep_prob, divisor);
  return (int)cudaGetLastError();
}

}  // namespace tfd

extern "C" {

// out = Flax dropout of x (both contiguous, n elements laid out as
// [n / (n1·n2·n3), n1, n2, n3]) on the threefry key (k0, k1): element
// (i0, i1, i2, i3) draws the bits of flat index base + Σ i_d·f_d of the
// full shape and is kept iff its uniform float32 < keep_prob, then
// divided by divisor. dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch (0 on success).
int threefry_dropout(const void* x, void* out, long long n, int n1, int n2,
                     int n3, long long base, long long f0, long long f1,
                     long long f2, long long f3, unsigned int k0,
                     unsigned int k1, float keep_prob, float divisor,
                     int dtype, void* stream) {
  if (n < 1 || n1 < 1 || n2 < 1 || n3 < 1 || n % ((long long)n1 * n2 * n3))
    return (int)cudaErrorInvalidValue;
  const tfd::Layout L{n, n1, n2, n3, base, f0, f1, f2, f3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return tfd::launch<float>(x, out, L, k0, k1, keep_prob, divisor, st);
    case 1:
      return tfd::launch<__nv_bfloat16>(x, out, L, k0, k1, keep_prob,
                                        divisor, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
