// K1: the three ADD stems in one launch (eval, BN folded into scale/bias).
//
// Replaces auto_dynamic_deeplab_tpu/kernels/stems.py::fused_stems (Pallas
// body _stems_kernel). It computes, for every image of the batch,
//
//   stem0: conv3x3 s2  3->64  + BN + ReLU           kept in shared memory
//   stem1: conv3x3 s1 64->64  + BN        -> s0     written (pre-ReLU)
//   stem2: ReLU + conv3x3 s2 64->128 + BN -> s1     written
//
// with each output size (n-1)//2+1 and zero padding in the post-ReLU domain
// (rows and columns outside the image are 0 there, never the BN bias).
//
// Bound on an H100 SXM at 1025x2049, batch 1: 60.0 GFLOP (stem1 38.8, stem2
// 19.4, stem0 1.8) and 126 MB of traffic with bf16 outputs (fp32 x 25 MB,
// s0 67 MB, s1 34 MB). At the 989 TFLOP/s bf16 tensor-core rate that is
// 61 us; at 3.35 TB/s the bytes take 38 us. This kernel does its FMAs on
// the CUDA cores (67 TFLOP/s fp32), so it cannot go below about 0.9 ms:
// it is bound by operations. Moving stem1 and stem2 onto the tensor cores
// (mma.sync / wgmma) is later work.
//
// Design. Each block owns a TQ x TW tile of s1 (all 128 channels) and the
// 2TQ x 2TW s0 pixels that map onto it (s0 row r belongs to the block that
// owns s1 row r//2; likewise columns), so every s0 pixel is written once.
//   1. The x window the tile needs, with halo, goes to shared memory (fp32;
//      rounded to bf16 first under the bf16 policy, as the reference casts
//      its conv inputs).
//   2. stem0 + BN + ReLU for the (2TQ+3)-row window -> shared memory.
//   3. stem1 + BN for the (2TQ+1)-row window: the block's own pixels go to
//      s0; ReLU(s0), with its one-row/one-column halo, stays in shared
//      memory.
//   4. stem2 + BN -> s1.
// stem0 and ReLU(s0) never touch device memory. Each thread of stems 1 and
// 2 accumulates a few pixels x 8 output channels in fp32 registers,
// reading activations from shared memory and 8 weights per tap as two
// float4 loads (the weights, 184 KB in fp32, are shared by every block and
// stay in L1/L2). Storage is fp32 or bf16 (template T); the grid's third
// dimension is the batch. Outputs are NHWC, the memory of the channels_last
// tensors the cells consume.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 2;                  // s1 rows per block
constexpr int TW = 16;                 // s1 columns per block
constexpr int R1 = 2 * TQ + 1;         // ReLU(s0) rows held: tile + halo row above
constexpr int C1 = 2 * TW + 1;         // ReLU(s0) columns held
constexpr int PX1 = 3;                 // stem1 pixels per thread item (C1 % PX1 == 0)
constexpr int R0 = R1 + 2;             // stem0 rows held
constexpr int C0 = C1 + 2;             // stem0 columns held
constexpr int RX = 2 * R0 + 1;         // x rows held
constexpr int CX = 2 * C0 + 1;         // x columns held
constexpr int PX2 = 2;                 // stem2 pixels per thread item
constexpr int CO0 = 64, CO1 = 64, CO2 = 128;
constexpr int THREADS = 256;

static_assert(C1 % PX1 == 0, "stem1 items must tile the held columns");
static_assert(TW % PX2 == 0, "stem2 items must tile the block's columns");
static_assert(TQ * (TW / PX2) * (CO2 / 8) == THREADS, "one stem2 item per thread");

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float to(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16(v); }
};

__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[8]) {
  __align__(16) __nv_bfloat162 p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void load8(const float* w, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(w));
  const float4 b = __ldg(reinterpret_cast<const float4*>(w) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Shared memory: a0 (stem0's output), then one region that holds the x
// window and stem0's weights until stem0 is done and ReLU(s0) after it, so
// that two fp32 blocks (four bf16 ones) fit on an SM.
constexpr size_t X_BYTES = sizeof(float) * (3 * RX * CX + 27 * CO0);

template <typename T>
__host__ __device__ constexpr size_t a0_bytes() {
  return (sizeof(T) * CO0 * R0 * C0 + 15) / 16 * 16;
}

template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return a0_bytes<T>() + (X_BYTES > sizeof(T) * CO1 * R1 * C1 ? X_BYTES : sizeof(T) * CO1 * R1 * C1);
}

// Weights are fp32 in [kh][kw][ci][co] order (values already rounded to bf16
// under the bf16 policy); sc*/bi* are the folded BN scale and bias.
template <typename TIn, typename T>
__global__ void __launch_bounds__(THREADS) stems_kernel(
    const TIn* __restrict__ x,                                    // (N, H, W, 3)
    const float* __restrict__ w0, const float* __restrict__ sc0, const float* __restrict__ bi0,
    const float* __restrict__ w1, const float* __restrict__ sc1, const float* __restrict__ bi1,
    const float* __restrict__ w2, const float* __restrict__ sc2, const float* __restrict__ bi2,
    T* __restrict__ s0,                                           // (N, H0, W0, 64)
    T* __restrict__ s1,                                           // (N, H1, W1, 128)
    int H, int W, int H0, int W0, int H1, int W1) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* a0 = reinterpret_cast<T*>(smem);                             // [CO0][R0][C0]
  float* xs = reinterpret_cast<float*>(smem + a0_bytes<T>());     // [3][RX][CX], phases 1-2
  float* w0s = xs + 3 * RX * CX;                                  // [27][CO0], phases 1-2
  T* a1 = reinterpret_cast<T*>(smem + a0_bytes<T>());             // [CO1][R1][C1], phases 3-4

  const size_t n = blockIdx.z;
  const int q0 = blockIdx.y * TQ, p0 = blockIdx.x * TW;
  const int ra = 2 * q0 - 2, ca = 2 * p0 - 2;  // stem0 coordinates of a0[.][0][0]
  const int rb = 2 * q0 - 1, cb = 2 * p0 - 1;  // s0 coordinates of a1[.][0][0]
  const int rx = 2 * ra - 1, cx = 2 * ca - 1;  // x coordinates of xs[.][0][0]
  x += n * H * W * 3;
  s0 += n * H0 * W0 * CO1;
  s1 += n * H1 * W1 * CO2;

  // 1. x window (zero outside the image: stem0's own padding)
  for (int i = threadIdx.x; i < RX * CX * 3; i += THREADS) {
    const int ci = i % 3, c = (i / 3) % CX, r = i / (3 * CX);
    const int gr = rx + r, gc = cx + c;
    float v = 0.f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W)
      v = Cvt<T>::to(Cvt<T>::from(Cvt<TIn>::to(x[((size_t)gr * W + gc) * 3 + ci])));
    xs[(ci * RX + r) * CX + c] = v;
  }
  for (int i = threadIdx.x; i < 27 * CO0; i += THREADS) w0s[i] = w0[i];
  __syncthreads();

  // 2. stem0 + BN + ReLU; zero outside [0,H0)x[0,W0) (stem1's padding)
  for (int i = threadIdx.x; i < CO0 * R0 * C0; i += THREADS) {
    const int co = i % CO0, c = (i / CO0) % C0, r = i / (CO0 * C0);
    float acc = 0.f;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int ci = 0; ci < 3; ++ci)
          acc = fmaf(xs[(ci * RX + 2 * r + kh) * CX + 2 * c + kw],
                     w0s[((kh * 3 + kw) * 3 + ci) * CO0 + co], acc);
    const int gr = ra + r, gc = ca + c;
    const bool inside = gr >= 0 && gr < H0 && gc >= 0 && gc < W0;
    a0[(co * R0 + r) * C0 + c] =
        Cvt<T>::from(inside ? fmaxf(fmaf(acc, sc0[co], bi0[co]), 0.f) : 0.f);
  }
  __syncthreads();

  // 3. stem1 + BN: own pixels -> s0 (pre-ReLU); ReLU(s0) with halo -> a1
  constexpr int SEG1 = C1 / PX1, G1 = CO1 / 8;
  for (int item = threadIdx.x; item < R1 * SEG1 * G1; item += THREADS) {
    const int g = item % G1, seg = (item / G1) % SEG1, r = item / (G1 * SEG1);
    const int c = seg * PX1;
    float acc[PX1][8] = {};
    for (int ci = 0; ci < CO0; ++ci) {
      const T* ap = a0 + (ci * R0 + r) * C0 + c;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        float av[PX1 + 2];
#pragma unroll
        for (int j = 0; j < PX1 + 2; ++j) av[j] = Cvt<T>::to(ap[kh * C0 + j]);
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          float wv[8];
          load8(w1 + ((kh * 3 + kw) * CO0 + ci) * CO1 + g * 8, wv);
#pragma unroll
          for (int px = 0; px < PX1; ++px)
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[px][k] = fmaf(av[px + kw], wv[k], acc[px][k]);
        }
      }
    }
    const int gr = rb + r;
#pragma unroll
    for (int px = 0; px < PX1; ++px) {
      const int cc = c + px, gc = cb + cc;
      const bool inside = gr >= 0 && gr < H0 && gc >= 0 && gc < W0;
      float y[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int co = g * 8 + k;
        y[k] = fmaf(acc[px][k], sc1[co], bi1[co]);
        a1[(co * R1 + r) * C1 + cc] = Cvt<T>::from(inside ? fmaxf(y[k], 0.f) : 0.f);
      }
      if (inside && r >= 1 && cc >= 1) store8(s0 + ((size_t)gr * W0 + gc) * CO1 + g * 8, y);
    }
  }
  __syncthreads();

  // 4. stem2 + BN -> s1 (one item per thread)
  {
    constexpr int SEG2 = TW / PX2, G2 = CO2 / 8;
    const int g = threadIdx.x % G2, seg = (threadIdx.x / G2) % SEG2;
    const int q = threadIdx.x / (G2 * SEG2);
    float acc[PX2][8] = {};
    for (int ci = 0; ci < CO1; ++ci) {
      const T* ap = a1 + (ci * R1 + 2 * q) * C1 + 2 * PX2 * seg;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        float av[2 * PX2 + 1];
#pragma unroll
        for (int j = 0; j < 2 * PX2 + 1; ++j) av[j] = Cvt<T>::to(ap[kh * C1 + j]);
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          float wv[8];
          load8(w2 + ((kh * 3 + kw) * CO1 + ci) * CO2 + g * 8, wv);
#pragma unroll
          for (int px = 0; px < PX2; ++px)
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[px][k] = fmaf(av[2 * px + kw], wv[k], acc[px][k]);
        }
      }
    }
    const int gq = q0 + q;
#pragma unroll
    for (int px = 0; px < PX2; ++px) {
      const int gp = p0 + seg * PX2 + px;
      if (gq >= H1 || gp >= W1) continue;
      float y[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) y[k] = fmaf(acc[px][k], sc2[g * 8 + k], bi2[g * 8 + k]);
      store8(s1 + ((size_t)gq * W1 + gp) * CO2 + g * 8, y);
    }
  }
}

template <typename TIn, typename T>
cudaError_t launch(const void* x, const float* const* p, void* s0, void* s1, int N, int H,
                   int W, cudaStream_t stream) {
  const int H0 = (H - 1) / 2 + 1, W0 = (W - 1) / 2 + 1;
  const int H1 = (H0 - 1) / 2 + 1, W1 = (W0 - 1) / 2 + 1;
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      stems_kernel<TIn, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W1 + TW - 1) / TW, (H1 + TQ - 1) / TQ, N);
  stems_kernel<TIn, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const TIn*>(x), p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8],
      static_cast<T*>(s0), static_cast<T*>(s1), H, W, H0, W0, H1, W1);
  return cudaGetLastError();
}

}  // namespace

// x: (N, H, W, 3) fp32 or bf16. w0/w1/w2: fp32 [kh][kw][ci][co]. sc*/bi*:
// folded BN, fp32. s0: (N, H0, W0, 64), s1: (N, H1, W1, 128), fp32 or bf16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int add_stems_forward(const void* x, int x_is_bf16, const void* w0,
                                 const void* sc0, const void* bi0, const void* w1,
                                 const void* sc1, const void* bi1, const void* w2,
                                 const void* sc2, const void* bi2, void* s0, void* s1,
                                 int out_is_bf16, int N, int H, int W, void* stream) {
  const float* p[9] = {
      static_cast<const float*>(w0), static_cast<const float*>(sc0), static_cast<const float*>(bi0),
      static_cast<const float*>(w1), static_cast<const float*>(sc1), static_cast<const float*>(bi1),
      static_cast<const float*>(w2), static_cast<const float*>(sc2), static_cast<const float*>(bi2)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_is_bf16) {
    err = out_is_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, p, s0, s1, N, H, W, st)
                      : launch<__nv_bfloat16, float>(x, p, s0, s1, N, H, W, st);
  } else {
    err = out_is_bf16 ? launch<float, __nv_bfloat16>(x, p, s0, s1, N, H, W, st)
                      : launch<float, float>(x, p, s0, s1, N, H, W, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* add_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
