// K1: the three ADD stems in one launch (eval, BN folded), on the tensor cores.
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
// Bound on an H100 SXM at 1025x2049, batch 1: 60.0 GFLOP, of which the
// stem1 and stem2 products are 58.2 (38.8 and 19.4) and stem0 1.8, and
// 126 MB of traffic with bf16 outputs (fp32 x 25 MB, s0 67 MB, s1 34 MB).
// Every product runs on the tensor cores: bf16 at 989 TFLOP/s (59 us for
// the 60 GFLOP), fp32 by 3xTF32 at 495 / 3 TFLOP/s (364 us); the bytes
// take 38 us. It is bound by operations.
//
// Design. Each block owns a tq x tw tile of s1 (all 128 channels) and the
// 2tq x 2tw s0 pixels that map onto it (s0 row r belongs to the block
// that owns s1 row r//2; likewise columns), so every s0 pixel is written
// once. Its three convolutions are implicit GEMMs on the pieces of the
// tap-GEMM routine of K3-K6 (tap_gemm.cuh: mma.sync, bf16 m16n8k16 or
// fp32 in the 3xTF32 split; operands in the mma layout, rows of Cpad
// channels plus 16 bytes; each tap's weights, packed (tap, out, Cpad) on
// the host, streamed through two cp.async stages by tap_stream). 8 warps.
// Fragment loads from shared memory bound the products (every warp loads
// the tap's B fragments), so a warp of stem1 and stem2 takes two
// m-fragments that share each B fragment (warp_product_m): 40% fewer
// ldmatrix bytes a product than one m-fragment with 64 channels.
//   1. stem0 as one K = 32 product: the a0 window's (2tq+3) x (2tw+3)
//      pixels, each an im2col row of its 27 inputs (kh, kw, ci) and 5
//      zeros, read from the image (rounded to bf16 under the bf16 policy,
//      0 outside it); + bias, ReLU, 0 outside the s0 grid (stem1's
//      padding), rounded -> the a0 window; a warp's share 16 pixels x 64
//      channels, in passes of 8 fragments.
//   2. stem1 over the ReLU(s0) window, the tile's s0 pixels with a halo
//      row above and a halo column left, (2tq+1) x (2tw+1) pixels, 9 taps
//      of K = 64 on the a0 window at stride 1; a warp's share 32 pixels x
//      64 channels, so that 7 x 8's 16 fragments take one pass (the halo
//      is recomputed: stem1 runs on 1.14x the owned pixels). The epilogue
//      adds the bias and writes the block's own pixels to s0, rounded
//      once, and ReLU(s0) (0 outside the image, stem2's padding), rounded,
//      to the window.
//   3. stem2 at stride 2 over the tq x tw tile: a warp's share 32 pixels
//      x 32 of the 128 channels. The ReLU(s0) window keeps its rows in order and each
//      row's even columns before its odd ones, so that stem2's A rows (s1
//      pixel (q, p), tap (a, b) reads window pixel (2q + a, 2p + b)) are
//      consecutive pixels of one column parity: ldmatrix's 8 rows then hit
//      8 bank groups, as at stride 1 (P_HALVES; without it the rows lie 2
//      pixels apart and two of them share a bank group).
// stem0's output and ReLU(s0) never touch device memory. Shared memory:
// the a0 window (stem2's weight stages once stem1 is done), the ReLU(s0)
// window (stem0's im2col before), and the weight stages of stem0 and
// stem1; 104 KB in bf16 (two blocks an SM) and 196 KB in fp32 (one) at
// 7 x 8. Each phase's first weight tap is copied while the previous
// phase's epilogue runs. Storage is fp32 or bf16 (template T, the input
// TIn either); the grid's third dimension is the batch; outputs are NHWC,
// the memory of the channels_last tensors the cells consume.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tap_gemm.cuh"

// Mirrored by kernels/stems.py::_StemArgs (ctypes). Outside the anonymous
// namespace: the C entry points take it and must stay external.
struct StemArgs {
  const void* x;                        // (N, H, W, 3), fp32 or bf16
  const void* pk0;                      // (1, 64, 32): stem0, inputs (kh, kw, ci) then 5 zeros
  const void* pk1;                      // (9, 64, 64): stem1, (tap, out, in)
  const void* pk2;                      // (9, 128, 64): stem2
  const float* b0;                      // folded BN biases, fp32: (64,)
  const float* b1;                      // (64,)
  const float* b2;                      // (128,)
  void* s0;                             // (N, H0, W0, 64)
  void* s1;                             // (N, H1, W1, 128)
  int N, H, W, x_is_bf16, is_bf16;
  int tq, tw, smem;                     // the s1 tile and the shared-memory grant
};

namespace {

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int K0 = 32;  // stem0's depth: 27 products (kh, kw, ci) and 5 zeros
constexpr int SMEM_MAX = 232448;
constexpr bool P_HALVES = true;  // the ReLU(s0) window's columns by parity

__host__ __device__ inline size_t larger(size_t a, size_t b) { return a > b ? a : b; }

// The carve-up of a tq x tw tile: from byte 0 the a0 window (r0 x c0
// pixels) or stem2's two stages of 128 weight rows; from p the ReLU(s0)
// window (r1 rows of cp pixels) or stem0's im2col (r0 c0 rows of K0);
// from w two stages of 64 weight rows (stem0's in stage 1, stem1's taps
// in both).
struct Layout {
  int r0, c0, r1, c1, cp;
  size_t p, w, total;
};

__host__ __device__ inline Layout stem_layout(int tq, int tw, int eb) {
  Layout l;
  l.r0 = 2 * tq + 3;
  l.c0 = 2 * tw + 3;
  l.r1 = 2 * tq + 1;
  l.c1 = 2 * tw + 1;
  l.cp = P_HALVES ? 2 * tw + 2 : l.c1;
  const size_t pb = (size_t)dense_pitch(64, eb) * eb, pb0 = (size_t)dense_pitch(K0, eb) * eb;
  l.p = larger((size_t)l.r0 * l.c0 * pb, 2 * 128 * pb);
  l.w = l.p + larger((size_t)l.r1 * l.cp * pb, (size_t)l.r0 * l.c0 * pb0);
  l.total = l.w + 2 * 64 * pb;
  return l;
}

// Column of ReLU(s0) window column j in its row
__device__ __forceinline__ int p_col(int j, int tw) { return P_HALVES ? (j & 1) * (tw + 1) + (j >> 1) : j; }

__device__ __forceinline__ float2 bias2(const float* b, int co) {
  return __ldg(reinterpret_cast<const float2*>(b + co));
}

template <int MF, int NF>
__device__ __forceinline__ void zero(float (&acc)[MF][NF][4], float (&acc_lo)[MF][NF][4]) {
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = acc_lo[m][j][i] = 0.f;
}

// One depth step's products of MF m-fragments (A) and NF n8 fragments
// (B). fp32: 3xTF32, each B fragment split once for the MF products.
template <typename T, int MF, int NF>
__device__ __forceinline__ void mma_step(const uint32_t (&a)[MF][4], const uint32_t (&b)[NF][2],
                                         float (&acc)[MF][NF][4], float (&acc_lo)[MF][NF][4]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int m = 0; m < MF; ++m) mma_bf16(acc[m][j], a[m], b[j][0], b[j][1]);
  } else {
    uint32_t ahi[MF][4], alo[MF][4];
#pragma unroll
    for (int m = 0; m < MF; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[m][i]), ahi[m][i], alo[m][i]);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      uint32_t bhi[2], blo[2];
      split_tf32(__uint_as_float(b[j][0]), bhi[0], blo[0]);
      split_tf32(__uint_as_float(b[j][1]), bhi[1], blo[1]);
#pragma unroll
      for (int m = 0; m < MF; ++m) {
        mma_tf32(acc_lo[m][j], alo[m], bhi[0], bhi[1]);
        mma_tf32(acc_lo[m][j], ahi[m], blo[0], blo[1]);
        mma_tf32(acc[m][j], ahi[m], bhi[0], bhi[1]);
      }
    }
  }
}

// A warp's MF m-fragments (A rows at a[m], the lane's ldmatrix addresses)
// times NF n8 fragments (B at bp, rows at pitch pb) over KS depth steps of
// 32 bytes. Each B fragment is loaded once for the MF m-fragments, which
// share it: MF m-fragments move (MF + NF / 2) / MF ldmatrix.x4 a fragment
// and step instead of 1 + NF / 2. The next step's fragments are loaded
// before this step's products.
template <typename T, int MF, int NF, int KS>
__device__ __forceinline__ void warp_product_m(const unsigned char* const (&a)[MF], const unsigned char* bp, int pb,
                                               float (&acc)[MF][NF][4], float (&acc_lo)[MF][NF][4]) {
  uint32_t fa[2][MF][4], fb[2][NF][2];
  auto load = [&](int s, int buf) {
#pragma unroll
    for (int m = 0; m < MF; ++m) ldmatrix_x4(fa[buf][m], a[m] + s * 32);
    load_b(bp + s * 32, pb, NF, fb[buf]);
  };
  load(0, 0);
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if (s + 1 < KS) load(s + 1, (s + 1) & 1);
    mma_step<T>(fa[s & 1], fb[s & 1], acc, acc_lo);
  }
}

template <typename TIn, typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1) stems_kernel(const StemArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int EB = sizeof(T);
  const int tq = a.tq, tw = a.tw;
  const Layout l = stem_layout(tq, tw, EB);
  const int pb = dense_pitch(64, EB) * EB, pb0 = dense_pitch(K0, EB) * EB;
  unsigned char* A0 = smem;         // the a0 window; stem2's weight stages after stem1
  unsigned char* P = smem + l.p;    // stem0's im2col; the ReLU(s0) window after stem0
  unsigned char* WS = smem + l.w;   // stem1's weight stages; stem0's weights in stage 1
  const int H0 = (a.H - 1) / 2 + 1, W0 = (a.W - 1) / 2 + 1;
  const int H1 = (H0 - 1) / 2 + 1, W1 = (W0 - 1) / 2 + 1;
  const int n = blockIdx.z, q0 = blockIdx.y * tq, p0 = blockIdx.x * tw;
  const int ra = 2 * q0 - 2, ca = 2 * p0 - 2;  // s0-grid coordinates of a0 window pixel (0, 0)
  const int rb = 2 * q0 - 1, cb = 2 * p0 - 1;  // s0 coordinates of ReLU(s0) window pixel (0, 0)
  const int warp = threadIdx.x / 32;
  const unsigned char* pk1 = static_cast<const unsigned char*>(a.pk1);
  const unsigned char* pk2 = static_cast<const unsigned char*>(a.pk2);

  // stem0's weights into stage 1, then stem1's first tap into stage 0
  // (it lands during stem0)
  stage_rows<T>(static_cast<const unsigned char*>(a.pk0), 64, K0, WS + (size_t)64 * pb, pb0);
  cp_async_commit();
  stage_rows<T>(pk1, 64, 64, WS, pb);
  cp_async_commit();

  // 1. stem0's im2col: row p (a0 window pixel (i, j)) holds x at rows
  // 2(ra + i) - 1 + kh, columns 2(ca + j) - 1 + kw, channels ci, at
  // (kh * 3 + kw) * 3 + ci, rounded to T, 0 outside the image; a thread
  // issues a pixel's 27 loads before its stores
  const TIn* x = static_cast<const TIn*>(a.x) + (size_t)n * a.H * a.W * 3;
  const int m0 = l.r0 * l.c0;
  for (int p = threadIdx.x; p < m0; p += THREADS) {
    const int i = p / l.c0, gr = 2 * (ra + i) - 1, gc = 2 * (ca + p - i * l.c0) - 1;
    float v[K0];
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const bool in = gr + kh >= 0 && gr + kh < a.H && gc + kw >= 0 && gc + kw < a.W;
        const size_t at = in ? ((size_t)(gr + kh) * a.W + gc + kw) * 3 : 0;
#pragma unroll
        for (int ci = 0; ci < 3; ++ci) v[(kh * 3 + kw) * 3 + ci] = in ? Cvt<TIn>::to(x[at + ci]) : 0.f;
      }
#pragma unroll
    for (int k = 27; k < K0; ++k) v[k] = 0.f;
    T* d = reinterpret_cast<T*>(P + (size_t)p * pb0);
#pragma unroll
    for (int k = 0; k < K0; k += 2) store2(d + k, v[k], v[k + 1]);
  }
  cp_async_wait<1>();  // stem0's weights have landed
  __syncthreads();

  // 2. stem0: a0 = ReLU(im2col w0 + b0), 0 outside the s0 grid, rounded
  const int frags0 = (m0 + 15) / 16;
  for (int mf = warp; mf < frags0; mf += WARPS) {
    const WarpTile w(mf, 0, 8, pb0, true);
    float acc[1][8][4], acc_lo[1][8][4];
    zero(acc, acc_lo);
    const unsigned char* a_lane[1] = {w.a_row(P, l.c0, l.c0, m0)};
    warp_product_m<T, 1, 8, K0 * EB / 32>(a_lane, WS + (size_t)64 * pb + w.b_off(), pb0, acc, acc_lo);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pp = mf * 16 + w.g() + 8 * h;
      if (pp >= m0) continue;
      const int i = pp / l.c0, gr = ra + i, gc = ca + pp - i * l.c0;
      const bool inside = gr >= 0 && gr < H0 && gc >= 0 && gc < W0;
      T* o = reinterpret_cast<T*>(A0 + (size_t)pp * pb);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = j * 8 + 2 * w.t();
        const float2 b = bias2(a.b0, co);
        const float y0 = acc_lo[0][j][2 * h] + acc[0][j][2 * h] + b.x;
        const float y1 = acc_lo[0][j][2 * h + 1] + acc[0][j][2 * h + 1] + b.y;
        store2(o + co, inside ? fmaxf(y0, 0.f) : 0.f, inside ? fmaxf(y1, 0.f) : 0.f);
      }
    }
  }
  __syncthreads();  // stem0's weights (stage 1) are spent before stem1 refills the stage

  // 3. stem1 + BN over the ReLU(s0) window: a warp takes two fragments,
  // 2 mp and 2 mp + 1, times all 64 output channels, WARPS pairs a pass
  constexpr int KS = 64 * EB / 32;
  T* s0 = static_cast<T*>(a.s0) + (size_t)n * H0 * W0 * 64;
  const int m1 = l.r1 * l.c1, frags1 = (m1 + 15) / 16, pairs1 = (frags1 + 1) / 2;
  for (int pass = 0; pass * WARPS < pairs1; ++pass) {
    const int mp = pass * WARPS + warp;
    const WarpTile w(2 * mp, 0, 8, pb, true);
    const unsigned char* a_lane[2] = {w.a_row(A0, l.c0, l.c1, m1),
                                      WarpTile(2 * mp + 1, 0, 8, pb, true).a_row(A0, l.c0, l.c1, m1)};
    float acc[2][8][4], acc_lo[2][8][4];
    zero(acc, acc_lo);
    tap_stream<T>(9, pk1, (size_t)64 * 64 * EB, 64, 64, WS, pb, true, [&](int t, const unsigned char* stage) {
      if (mp >= pairs1) return;
      const size_t off = (size_t)(t / 3 * l.c0 + t % 3) * pb;
      const unsigned char* at[2] = {a_lane[0] + off, a_lane[1] + off};
      warp_product_m<T, 2, 8, KS>(at, stage + w.b_off(), pb, acc, acc_lo);
    });
    // the stream ended on a barrier after its last tap (stage 0): the
    // next product's first tap is copied during this epilogue
    if ((pass + 1) * WARPS < pairs1)
      stage_rows<T>(pk1, 64, 64, WS, pb);
    else
      stage_rows<T>(pk2, 128, 64, A0, pb);  // the a0 window is spent
    if (mp >= pairs1) continue;
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pp = (2 * mp + f) * 16 + w.g() + 8 * h;
        if (pp >= m1) continue;
        const int i = pp / l.c1, j = pp - i * l.c1, gr = rb + i, gc = cb + j;
        const bool inside = gr >= 0 && gr < H0 && gc >= 0 && gc < W0;
        const bool own = inside && i > 0 && j > 0;
        T* o = s0 + ((size_t)(own ? gr : 0) * W0 + (own ? gc : 0)) * 64;
        T* r = reinterpret_cast<T*>(P + ((size_t)i * l.cp + p_col(j, tw)) * pb);
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const int co = jn * 8 + 2 * w.t();
          const float2 b = bias2(a.b1, co);
          const float y0 = acc_lo[f][jn][2 * h] + acc[f][jn][2 * h] + b.x;
          const float y1 = acc_lo[f][jn][2 * h + 1] + acc[f][jn][2 * h + 1] + b.y;
          if (own) store2(o + co, y0, y1);
          store2(r + co, inside ? fmaxf(y0, 0.f) : 0.f, inside ? fmaxf(y1, 0.f) : 0.f);
        }
      }
  }

  // 4. stem2 + BN -> s1 over the tile's tq x tw pixels (tq tw <= 64: at
  // most two fragment pairs): a warp takes a pair times 32 of the 128
  // output channels; s1 pixel (q, p) reads window row 2q + a and column
  // 2p + b
  {
    const int m2 = tq * tw, pairs2 = ((m2 + 15) / 16 + 1) / 2;
    const int mp = warp % pairs2, group = warp / pairs2;  // four groups of 32 channels
    const WarpTile w(2 * mp, 4 * group, 4, pb, true);
    const unsigned char* a_lane[2];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int p = min((2 * mp + f) * 16 + (w.lane & 15), m2 - 1), lq = p / tw, lp = p - lq * tw;
      a_lane[f] = P + ((size_t)2 * lq * l.cp + (P_HALVES ? lp : 2 * lp)) * pb + (w.lane >> 4) * 16;
    }
    float acc[2][4][4], acc_lo[2][4][4];
    zero(acc, acc_lo);
    tap_stream<T>(9, pk2, (size_t)128 * 64 * EB, 128, 64, A0, pb, true, [&](int t, const unsigned char* stage) {
      if (group >= 4) return;
      const size_t off = (size_t)(t / 3 * l.cp + p_col(t % 3, tw)) * pb;
      const unsigned char* at[2] = {a_lane[0] + off, a_lane[1] + off};
      warp_product_m<T, 2, 4, KS>(at, stage + w.b_off(), pb, acc, acc_lo);
    });
    if (group >= 4) return;
    T* s1 = static_cast<T*>(a.s1) + (size_t)n * H1 * W1 * 128;
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pp = (2 * mp + f) * 16 + w.g() + 8 * h;
        const int q = pp / tw, gq = q0 + q, gp = p0 + pp - q * tw;
        if (pp >= m2 || gq >= H1 || gp >= W1) continue;
        T* o = s1 + ((size_t)gq * W1 + gp) * 128;
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          const int co = (4 * group + jn) * 8 + 2 * w.t();
          const float2 b = bias2(a.b2, co);
          store2(o + co, acc_lo[f][jn][2 * h] + acc[f][jn][2 * h] + b.x,
                 acc_lo[f][jn][2 * h + 1] + acc[f][jn][2 * h + 1] + b.y);
        }
      }
  }
}

bool args_ok(const StemArgs& a) {
  return a.x && a.pk0 && a.pk1 && a.pk2 && a.b0 && a.b1 && a.b2 && a.s0 && a.s1 && a.N > 0 && a.H > 0 &&
         a.W > 0 && a.tq > 0 && a.tw > 0 && a.tq * a.tw <= 64 &&
         (size_t)a.smem >= stem_layout(a.tq, a.tw, a.is_bf16 ? 2 : 4).total && a.smem <= SMEM_MAX;
}

template <typename TIn, typename T>
int launch(const StemArgs& a, cudaStream_t stream) {
  const auto kernel = stems_kernel<TIn, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int H0 = (a.H - 1) / 2 + 1, W0 = (a.W - 1) / 2 + 1;
  const int H1 = (H0 - 1) / 2 + 1, W1 = (W0 - 1) / 2 + 1;
  const dim3 grid((W1 + a.tw - 1) / a.tw, (H1 + a.tq - 1) / a.tq, a.N);
  kernel<<<grid, THREADS, a.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() after the launch
// (0 on success); arguments the kernel does not take (a tile of more than
// 64 s1 pixels, a grant below the carve-up) return cudaErrorInvalidValue
// without launching.
extern "C" int add_stems_forward(const StemArgs* a, void* stream) {
  if (!args_ok(*a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->x_is_bf16)
    return a->is_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(*a, st) : launch<__nv_bfloat16, float>(*a, st);
  return a->is_bf16 ? launch<float, __nv_bfloat16>(*a, st) : launch<float, float>(*a, st);
}

// Shared-memory bytes the kernel carves for these arguments, and
// sizeof(StemArgs): the host's plan and ctypes structure are checked
// against both.
extern "C" long long add_stems_smem_bytes(const StemArgs* a) {
  return (long long)stem_layout(a->tq, a->tw, a->is_bf16 ? 2 : 4).total;
}

extern "C" int add_stems_args_size() { return (int)sizeof(StemArgs); }

extern "C" const char* add_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
