// K3-K6: the cell-DAG kernels of the `--cell-exec flat` path (eval, BN folded).
//
// They replace the Pallas functions of auto_dynamic_deeplab_tpu/kernels/cell_ops.py:
//   K3 block_kernel        block_stage :765 (_block_kernel :566, pallas_call :826)
//   K4 sep_fused_kernel    sep_fused   :385 (_sep_fused_kernel :335, pallas_call :413)
//   K5 sep_stage_kernel    sep_stage   :466 (_sep_stage_kernel :240, pallas_call :450)
//   K6 dense_stage_kernel  dense_stage :495 (_dense_stage_kernel :280, pallas_call :450)
//
// What they compute, for each image n and every output pixel of a C-channel
// state (C in = C out):
//   sep  edge (SepConv k, dilation 1): ReLU -> dw k x k -> round -> pw -> +b1
//        -> ReLU -> round (= mid, exactly 0 outside the image) -> dw k x k
//        -> round -> pw -> +b2
//   dil  edge (DilConv k, dilation 2): ReLU -> dense k x k conv -> +b
//   skip edge: the source as it is
//   K3: one DAG block, the sum of its 1-2 edges in fp32, rounded once;
//   K4: one sep edge, rounded; K6: one dil edge, rounded;
//   K5: one sep stage (optional ReLU on input and on output), rounded.
// BN is folded into the pointwise / dense weights (scale, folded in fp32,
// then cast to the state dtype) and an fp32 bias. Depthwise taps stay fp32.
// "round" is the cast to the state dtype (a no-op in fp32); those are the
// places where the Pallas kernels round (cell_ops.py :267, :366, :371,
// :684-685). Zero padding is in the post-ReLU domain: every value read
// from outside the image, and stage 1's output there, is 0.
//
// Layout. A state is NCHW logical, channels_last memory: pixel (n, h, w)
// starts at n * img_stride + (h * W + w) * ps and holds C contiguous
// channels. ps > C for a channel slice of the cell's concat buffer, which
// K3 writes into directly. Weights: dwk (C, k*k) fp32; pw (C, O8) and the
// dense Q (k*k, C, O8) in the state dtype, output channels innermost and
// zero-padded to O8 = C rounded up to 8 (16-byte loads); biases (O8,) fp32.
// K6 reads the same dense weights packed as (k*k, O8, Cpad), input
// channels innermost and zero-padded to Cpad (one 32-byte mma depth step).
//
// Bound on an H100 SXM. A cell's DAG is about 8.2 GFLOP at every level of
// the flagship (dil5 = 50 C^2 FLOP a pixel, sep = 4 C (k^2 + C)), 98.7
// GFLOP for the 12 cells at 1025x2049, against 0.66 GB of state traffic in
// fp32 (0.33 GB in bf16): operation-bound, 1.47 ms at the 67 TFLOP/s fp32
// rate. K3-K5 do every product on the CUDA cores in fp32 (bf16 operands
// are widened), so they cannot reach the 989 TFLOP/s bf16 tensor-core
// bound of 0.10 ms; at 33x65 their tile grid has 25-45 blocks for the
// card's 132 SMs. K6 runs its product on the tensor cores (below); K3's
// dil edges through the same routine, and its pointwise products, are
// later work.
//
// K6 design (dense_stage_kernel). An implicit GEMM per block: M = the
// pixels of a th x tw tile (one warp per 16, times 1-2 warp groups that
// split N), N = an ns-channel slice of the outputs (ns | O8, ns <= 40; the
// host's plan splits N over blockIdx.z so that the grid fills the SMs:
// 45 tiles x 5 slices of 32 at 33x65, C=160), K = taps x Cpad. The window with its dilated halo is copied raw once by
// cp.async (16-byte copies where the source's address and strides allow,
// zero-filled outside the image; elementwise otherwise) at a row pitch of
// Cpad plus 16 bytes, so that ldmatrix's 8 rows hit 8 bank groups; for tap
// (a, b) the A rows are the window pixels (r + a*dil, q + b*dil) and no
// im2col is built. The tap's ns x Cpad weights stream through a two-stage
// cp.async buffer. ReLU is applied to the A fragments. bf16:
// mma.sync m16n8k16 with fp32 accumulators. fp32: m16n8k8 tf32 in the
// 3xTF32 split (x = hi + lo, both tf32, hi*hi + hi*lo + lo*hi summed in
// fp32, ~2^-21 a product), since the port's fp32 policy is full fp32 and
// plain TF32 misses 1e-4; both halves are split in registers, which keeps
// the fp32 weight stages at one copy (220 KB a block at C=160, dil5).
// The epilogue adds the fp32 bias, rounds once and stores channel pairs.
//
// Design of K3-K5. A block of THREADS threads owns a TH x TW output tile of one
// image and all C channels (TH, TW from the host's plan). The source
// window with its halo is loaded once into shared memory (ReLU on load,
// 0 outside the image), channel-innermost with an odd channel pitch so
// that the pixel groups a warp reads fall on different banks. The
// depthwise stage runs one (pixel, channel) per thread; the pointwise and
// dense products are tiles of PX pixels x 8 output channels per thread,
// accumulated in fp32 registers, with the weights read as 16-byte __ldg
// loads (shared by every block, they stay in L1/L2). The fused SepConv
// recomputes stage 1 on the tile plus a k//2 halo, so the intermediate
// never leaves shared memory; the input window's space then holds the mid
// and the stage-1 depthwise space the stage-2 one. K3 keeps the block sum
// in an fp32 tile in shared memory, runs its edges one after another over
// the same working space, and writes the state once.
// Every kernel launches on the caller's stream, allocates nothing, and
// checks the host's shared-memory grant against its own carve-up.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored by kernels/cell_ops.py::_Edge / _Args (ctypes). Outside the
// anonymous namespace: the C entry points take them and must stay external.
struct Edge {
  const void* src;       // the edge's source state
  long long img_stride;  // elements between images
  int ps;                // elements between pixels
  int kind, k, dil;
  const float* dwk1;     // sep: stage-1 dw taps (C, k*k); K5: the stage's
  const void* w1;        // sep: stage-1 pw (C, O8); dil: Q (k*k, C, O8)
  const float* b1;       // (O8,)
  const float* dwk2;     // sep: stage 2
  const void* w2;        // sep: stage-2 pw; K6: packed Q (k*k, O8, Cpad)
  const float* b2;
};

struct Args {
  Edge e[2];
  int n_edges, in_relu, out_relu, is_bf16;
  void* out;
  long long out_img_stride;
  int out_ps, N, H, W, C, O8, th, tw, smem;
  int ns, ng;  // K6: output channels a block computes (its N-slice), warp groups over them
};

namespace {

// 5 warps: the flagship's C = 40 * 2^level gives 5 * 2^level groups of 8
// output channels, so a tile's GEMM items come in multiples of 160.
constexpr int THREADS = 160;
constexpr int PX = 4;   // pixels of one GEMM item, along a tile row
constexpr int OG = 8;   // output channels of one GEMM item
constexpr int SMEM_MAX = 232448;

enum { SKIP = 0, SEP = 1, DIL = 2 };

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float to(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16(v); }
};

__device__ __forceinline__ void load8(const float* w, float (&v)[OG]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(w));
  const float4 b = __ldg(reinterpret_cast<const float4*>(w) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* w, float (&v)[OG]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(w));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// ------------------------------------------------ shared-memory carve-up
// (kernels/cell_ops.py's plan functions compute the same bytes)

__host__ __device__ inline int pitch(int C) { return C | 1; }
__host__ __device__ inline size_t r16(size_t b) { return (b + 15) / 16 * 16; }

__host__ __device__ inline size_t window_bytes(int h, int w, int C, int eb) {
  return r16((size_t)h * w * pitch(C) * eb);
}

// one edge's working space on a th x tw tile
__host__ __device__ inline size_t edge_bytes(int kind, int k, int dil, int C, int eb, int th, int tw) {
  if (kind == SEP) {
    const int r = k / 2;
    return window_bytes(th + 4 * r, tw + 4 * r, C, eb) + window_bytes(th + 2 * r, tw + 2 * r, C, eb);
  }
  if (kind == DIL) {
    const int R = dil * (k / 2);
    return window_bytes(th + 2 * R, tw + 2 * R, C, eb);
  }
  return 0;
}

__host__ __device__ inline size_t acc_bytes(int th, int tw, int C) {
  return r16((size_t)th * tw * C * sizeof(float));
}

inline int elem_bytes(const Args& a) { return a.is_bf16 ? 2 : 4; }

size_t block_smem(const Args& a) {
  size_t m = 0;
  for (int i = 0; i < a.n_edges; ++i) {
    const size_t b = edge_bytes(a.e[i].kind, a.e[i].k, a.e[i].dil, a.C, elem_bytes(a), a.th, a.tw);
    m = b > m ? b : m;
  }
  return acc_bytes(a.th, a.tw, a.C) + m;
}

size_t edge_smem(const Args& a) {
  return edge_bytes(a.e[0].kind, a.e[0].k, a.e[0].dil, a.C, elem_bytes(a), a.th, a.tw);
}

size_t stage_smem(const Args& a) {
  const int r = a.e[0].k / 2;
  return window_bytes(a.th + 2 * r, a.tw + 2 * r, a.C, elem_bytes(a)) +
         window_bytes(a.th, a.tw, a.C, elem_bytes(a));
}

// K6: channels padded to one mma depth step of 32 bytes (16 bf16, 8 fp32),
// and a row pitch 16 bytes longer, so that a pitch is an odd multiple of 16
// bytes and the 8 rows an ldmatrix reads fall on 8 different bank groups.
__host__ __device__ inline int dense_cpad(int C, int eb) {
  const int q = 32 / eb;
  return (C + q - 1) / q * q;
}
__host__ __device__ inline int dense_pitch(int C, int eb) { return dense_cpad(C, eb) + 16 / eb; }

// the window with its dilated halo, then two stages of ns weight rows
size_t dense_smem(const Args& a) {
  const int eb = elem_bytes(a), R = a.e[0].dil * (a.e[0].k / 2);
  const size_t rows = (size_t)(a.th + 2 * R) * (a.tw + 2 * R) + 2 * (size_t)a.ns;
  return rows * dense_pitch(a.C, eb) * eb;
}

// ------------------------------------------------------ device pieces

// win[(i * ww + j) * cp + c] = src pixel (r0 + i, c0 + j), channel c, for
// i < wh, j < ww; 0 outside the image, ReLU'd when `relu`.
template <typename T>
__device__ void load_window(const Edge& e, int n, int H, int W, int C, int r0, int c0, int wh,
                            int ww, bool relu, T* win) {
  const T* src = static_cast<const T*>(e.src) + n * e.img_stride;
  const int cp = pitch(C);
  const int total = wh * ww * C;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i % C, p = i / C;
    const int gr = r0 + p / ww, gc = c0 + p % ww;
    float v = 0.f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
      v = Cvt<T>::to(src[((long long)gr * W + gc) * e.ps + c]);
      if (relu) v = fmaxf(v, 0.f);
    }
    win[p * cp + c] = Cvt<T>::from(v);
  }
}

// dst (dh x dw pixels) = round(depthwise k x k of src (row pitch sw
// pixels)), dst pixel (i, j) reading src pixels (i..i+k-1, j..j+k-1).
template <typename T>
__device__ void depthwise(const T* src, int sw, int C, int k, const float* __restrict__ dwk, T* dst,
                          int dh, int dw) {
  const int cp = pitch(C), kk = k * k;
  const int total = dh * dw * C;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i % C, p = i / C;
    const T* s = src + ((p / dw) * sw + p % dw) * cp + c;
    const float* wk = dwk + c * kk;
    float acc = 0.f;
    for (int a = 0; a < k; ++a)
      for (int b = 0; b < k; ++b)
        acc = fmaf(Cvt<T>::to(s[(a * sw + b) * cp]), __ldg(wk + a * k + b), acc);
    dst[p * cp + c] = Cvt<T>::from(acc);
  }
}

// acc[px][o] = sum_c src[p0 + px][c] * w[c][og*8 + o] over the np pixels
// of a linear region (pixels past np read the last one; callers drop them).
template <typename T>
__device__ __forceinline__ void pw_item(const T* src, int C, int p0, int np, const T* __restrict__ w,
                                        int O8, int og, float (&acc)[PX][OG]) {
  const int cp = pitch(C);
  const T* s[PX];
#pragma unroll
  for (int px = 0; px < PX; ++px) {
    s[px] = src + min(p0 + px, np - 1) * cp;
#pragma unroll
    for (int o = 0; o < OG; ++o) acc[px][o] = 0.f;
  }
  const T* wp = w + og * OG;
  for (int c = 0; c < C; ++c) {
    float wv[OG];
    load8(wp + (size_t)c * O8, wv);
#pragma unroll
    for (int px = 0; px < PX; ++px) {
      const float v = Cvt<T>::to(s[px][c]);
#pragma unroll
      for (int o = 0; o < OG; ++o) acc[px][o] = fmaf(v, wv[o], acc[px][o]);
    }
  }
}

// Implicit GEMM of the dense k x k conv at dilation `dil`: tile pixels
// (r, q..q+PX-1) of a window with row pitch ww pixels whose origin is the
// tile's minus the reach; acc[px][o] = sum_{a,b,c} win[r+a*dil][q+px+b*dil][c]
// * Q[a*k+b][c][og*8+o].
template <typename T>
__device__ __forceinline__ void dil_item(const T* win, int ww, int C, int k, int dil, int r, int q,
                                         const T* __restrict__ Q, int O8, int og,
                                         float (&acc)[PX][OG]) {
  const int cp = pitch(C);
#pragma unroll
  for (int px = 0; px < PX; ++px)
#pragma unroll
    for (int o = 0; o < OG; ++o) acc[px][o] = 0.f;
  for (int a = 0; a < k; ++a)
    for (int b = 0; b < k; ++b) {
      const T* s = win + ((r + a * dil) * ww + q + b * dil) * cp;
      const T* wp = Q + (size_t)(a * k + b) * C * O8 + og * OG;
      for (int c = 0; c < C; ++c) {
        float wv[OG];
        load8(wp + (size_t)c * O8, wv);
#pragma unroll
        for (int px = 0; px < PX; ++px) {
          const float v = Cvt<T>::to(s[px * cp + c]);
#pragma unroll
          for (int o = 0; o < OG; ++o) acc[px][o] = fmaf(v, wv[o], acc[px][o]);
        }
      }
    }
}

// The whole SepConv of edge e on the block's tile, stage 1 recomputed on a
// k//2 halo. Calls epi(p, o, y) for tile pixel p (row-major), output
// channel o < C, with y = pw2 . dw2(mid) + b2 in fp32.
template <typename T, typename Epi>
__device__ void sep_edge(const Edge& e, const Args& a, int n, int r0, int c0, unsigned char* space,
                         Epi epi) {
  const int C = a.C, cp = pitch(C), k = e.k, r = k / 2, th = a.th, tw = a.tw;
  const int xh = th + 4 * r, xw = tw + 4 * r, eh = th + 2 * r, ew = tw + 2 * r;
  T* X = reinterpret_cast<T*>(space);  // input window, then mid
  T* D = reinterpret_cast<T*>(space + window_bytes(xh, xw, C, sizeof(T)));  // dw1, then dw2
  load_window<T>(e, n, a.H, a.W, C, r0 - 2 * r, c0 - 2 * r, xh, xw, true, X);
  __syncthreads();
  depthwise<T>(X, xw, C, k, e.dwk1, D, eh, ew);
  __syncthreads();
  const int G = a.O8 / OG;
  const int np1 = eh * ew, ng1 = (np1 + PX - 1) / PX;
  for (int item = threadIdx.x; item < ng1 * G; item += blockDim.x) {
    const int og = item % G, p0 = (item / G) * PX;
    float acc[PX][OG];
    pw_item<T>(D, C, p0, np1, static_cast<const T*>(e.w1), a.O8, og, acc);
#pragma unroll
    for (int px = 0; px < PX; ++px) {
      const int p = p0 + px;
      if (p >= np1) continue;
      const int gr = r0 - r + p / ew, gc = c0 - r + p % ew;
      const bool inside = gr >= 0 && gr < a.H && gc >= 0 && gc < a.W;
#pragma unroll
      for (int o = 0; o < OG; ++o) {
        const int co = og * OG + o;
        if (co < C)
          X[p * cp + co] = Cvt<T>::from(inside ? fmaxf(acc[px][o] + e.b1[co], 0.f) : 0.f);
      }
    }
  }
  __syncthreads();
  depthwise<T>(X, ew, C, k, e.dwk2, D, th, tw);
  __syncthreads();
  const int np2 = th * tw, ng2 = np2 / PX;
  for (int item = threadIdx.x; item < ng2 * G; item += blockDim.x) {
    const int og = item % G, p0 = (item / G) * PX;
    float acc[PX][OG];
    pw_item<T>(D, C, p0, np2, static_cast<const T*>(e.w2), a.O8, og, acc);
#pragma unroll
    for (int px = 0; px < PX; ++px)
#pragma unroll
      for (int o = 0; o < OG; ++o) {
        const int co = og * OG + o;
        if (co < C) epi(p0 + px, co, acc[px][o] + e.b2[co]);
      }
  }
}

// The DilConv of edge e on the block's tile: epi(p, o, conv + b) in fp32.
template <typename T, typename Epi>
__device__ void dil_edge(const Edge& e, const Args& a, int n, int r0, int c0, unsigned char* space,
                         Epi epi) {
  const int C = a.C, th = a.th, tw = a.tw, R = e.dil * (e.k / 2);
  const int wh = th + 2 * R, ww = tw + 2 * R;
  T* X = reinterpret_cast<T*>(space);
  load_window<T>(e, n, a.H, a.W, C, r0 - R, c0 - R, wh, ww, true, X);
  __syncthreads();
  const int G = a.O8 / OG, gpr = tw / PX, ng = th * gpr;
  for (int item = threadIdx.x; item < ng * G; item += blockDim.x) {
    const int og = item % G, pg = item / G;
    const int r = pg / gpr, q = (pg % gpr) * PX;
    float acc[PX][OG];
    dil_item<T>(X, ww, C, e.k, e.dil, r, q, static_cast<const T*>(e.w1), a.O8, og, acc);
#pragma unroll
    for (int px = 0; px < PX; ++px)
#pragma unroll
      for (int o = 0; o < OG; ++o) {
        const int co = og * OG + o;
        if (co < C) epi(r * tw + q + px, co, acc[px][o] + e.b1[co]);
      }
  }
}

// Stores y (rounded) at tile pixel p, channel c, when the pixel is inside.
template <typename T>
struct Store {
  T* out;
  int ps, H, W, r0, c0, tw;
  bool relu;
  __device__ void operator()(int p, int c, float y) const {
    const int gr = r0 + p / tw, gc = c0 + p % tw;
    if (gr < H && gc < W)
      out[((long long)gr * W + gc) * ps + c] = Cvt<T>::from(relu ? fmaxf(y, 0.f) : y);
  }
};

template <typename T>
__device__ Store<T> make_store(const Args& a, int n, int r0, int c0, bool relu) {
  return Store<T>{static_cast<T*>(a.out) + n * a.out_img_stride, a.out_ps, a.H, a.W, r0, c0, a.tw,
                  relu};
}

// ------------------------------------------------------------- kernels

// K3: one DAG block, its 1-2 edges summed in an fp32 tile, written once.
template <typename T>
__global__ void __launch_bounds__(THREADS) block_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.z, r0 = blockIdx.y * a.th, c0 = blockIdx.x * a.tw;
  const int C = a.C, npx = a.th * a.tw;
  float* acc = reinterpret_cast<float*>(smem);
  unsigned char* space = smem + acc_bytes(a.th, a.tw, C);
  for (int i = threadIdx.x; i < npx * C; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  auto add = [&](int p, int c, float y) { acc[p * C + c] += y; };
  for (int ei = 0; ei < a.n_edges; ++ei) {
    const Edge& e = a.e[ei];
    if (e.kind == SKIP) {
      const T* src = static_cast<const T*>(e.src) + n * e.img_stride;
      for (int i = threadIdx.x; i < npx * C; i += blockDim.x) {
        const int c = i % C, p = i / C;
        const int gr = r0 + p / a.tw, gc = c0 + p % a.tw;
        if (gr < a.H && gc < a.W) acc[i] += Cvt<T>::to(src[((long long)gr * a.W + gc) * e.ps + c]);
      }
    } else if (e.kind == SEP) {
      sep_edge<T>(e, a, n, r0, c0, space, add);
    } else {
      dil_edge<T>(e, a, n, r0, c0, space, add);
    }
    __syncthreads();
  }
  const Store<T> store = make_store<T>(a, n, r0, c0, false);
  for (int i = threadIdx.x; i < npx * C; i += blockDim.x) store(i / C, i % C, acc[i]);
}

// K4: one whole SepConv edge.
template <typename T>
__global__ void __launch_bounds__(THREADS) sep_fused_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.z, r0 = blockIdx.y * a.th, c0 = blockIdx.x * a.tw;
  sep_edge<T>(a.e[0], a, n, r0, c0, smem, make_store<T>(a, n, r0, c0, false));
}

// K5: one dw k x k -> round -> pw -> +b stage, ReLU on input / output by flag.
template <typename T>
__global__ void __launch_bounds__(THREADS) sep_stage_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Edge& e = a.e[0];
  const int n = blockIdx.z, r0 = blockIdx.y * a.th, c0 = blockIdx.x * a.tw;
  const int C = a.C, r = e.k / 2, th = a.th, tw = a.tw;
  const int wh = th + 2 * r, ww = tw + 2 * r;
  T* X = reinterpret_cast<T*>(smem);
  T* D = reinterpret_cast<T*>(smem + window_bytes(wh, ww, C, sizeof(T)));
  load_window<T>(e, n, a.H, a.W, C, r0 - r, c0 - r, wh, ww, a.in_relu != 0, X);
  __syncthreads();
  depthwise<T>(X, ww, C, e.k, e.dwk1, D, th, tw);
  __syncthreads();
  const Store<T> store = make_store<T>(a, n, r0, c0, a.out_relu != 0);
  const int G = a.O8 / OG, np = th * tw, ng = np / PX;
  for (int item = threadIdx.x; item < ng * G; item += blockDim.x) {
    const int og = item % G, p0 = (item / G) * PX;
    float acc[PX][OG];
    pw_item<T>(D, C, p0, np, static_cast<const T*>(e.w1), a.O8, og, acc);
#pragma unroll
    for (int px = 0; px < PX; ++px)
#pragma unroll
      for (int o = 0; o < OG; ++o) {
        const int co = og * OG + o;
        if (co < C) store(p0 + px, co, acc[px][o] + e.b1[co]);
      }
  }
}

// ------------------------------------------- K6: tensor-core implicit GEMM

constexpr int DENSE_MWARPS = 4;  // warps along M, one per 16 tile pixels: at most 4
constexpr int DENSE_GROUPS = 2;  // warp groups that split the N-slice: at most 2
constexpr int NF_MAX = 5;        // n8 fragments a warp holds, so ns <= 40

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: x = hi + lo, hi = tf32(x) (round to nearest, ties away), lo =
// tf32(x - hi); x - hi is exact in fp32, so hi + lo keeps ~22 bits of x
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ uint32_t relu_bf16x2(uint32_t x) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
  v = __hmax2(v, __float2bfloat162_rn(0.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

// The fragments of one 32-byte depth step (16 bf16 / 8 fp32 input
// channels) of one warp's 16 x (8 nf) product: A from the window at the
// lane's address, B from the staged weights. The two dtypes share the byte
// layout of their fragments: an ldmatrix.x4 gives the m16n8k16 bf16 A
// fragment and the m16n8k8 tf32 one alike, and an x4 over two n8 row
// blocks gives both B registers of two fragments.
struct Frags {
  uint32_t a[4];
  uint32_t b[NF_MAX][2];
};

__device__ __forceinline__ void dense_load(const unsigned char* a_ptr, const unsigned char* b_ptr,
                                           int b_pitch_bytes, int nf, Frags& f) {
  ldmatrix_x4(f.a, a_ptr);
#pragma unroll
  for (int j = 0; j < NF_MAX; j += 2) {
    if (j >= nf) break;
    if (j + 1 < nf) {
      uint32_t r[4];
      ldmatrix_x4(r, b_ptr + j * 8 * b_pitch_bytes);
      f.b[j][0] = r[0];
      f.b[j][1] = r[1];
      f.b[j + 1][0] = r[2];
      f.b[j + 1][1] = r[3];
    } else {
      ldmatrix_x2(f.b[j][0], f.b[j][1], b_ptr + j * 8 * b_pitch_bytes);
    }
  }
}

// bf16: ReLU on the loaded A fragment (not on load), run on the next
// step's fragments after this step's mmas are issued. fp32 ReLUs and
// splits inside dense_mma instead: holding split fragments for two steps
// ran slower (PERF.md §6).
template <typename T>
__device__ __forceinline__ void dense_prep(Frags& f) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f.a[i] = relu_bf16x2(f.a[i]);
  }
}

// One step's products. fp32: 3xTF32 (A ReLU'd, A and B split into tf32
// high and low halves), the two small terms into their own accumulators,
// which halves each chain of dependent mmas; the kernel adds the two at
// the end.
template <typename T>
__device__ __forceinline__ void dense_mma(const Frags& f, int nf, float (&acc)[NF_MAX][4],
                                          float (&acc_lo)[NF_MAX][4]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int j = 0; j < NF_MAX; ++j)
      if (j < nf) mma_bf16(acc[j], f.a, f.b[j][0], f.b[j][1]);
  } else {
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(fmaxf(__uint_as_float(f.a[i]), 0.f), ahi[i], alo[i]);
#pragma unroll
    for (int j = 0; j < NF_MAX; ++j) {
      if (j >= nf) break;
      uint32_t bhi[2], blo[2];
      split_tf32(__uint_as_float(f.b[j][0]), bhi[0], blo[0]);
      split_tf32(__uint_as_float(f.b[j][1]), bhi[1], blo[1]);
      mma_tf32(acc_lo[j], alo, bhi[0], bhi[1]);
      mma_tf32(acc_lo[j], ahi, blo[0], blo[1]);
      mma_tf32(acc[j], ahi, bhi[0], bhi[1]);
    }
  }
}

// Calls f(r, c) for r < rows, c < cols over the block's threads, in the
// order of i = r * cols + c from threadIdx.x in steps of blockDim.x,
// without a division inside the loop.
template <typename F>
__device__ __forceinline__ void for_2d(int rows, int cols, F f) {
  const int dr = blockDim.x / cols, dc = blockDim.x % cols;
  int r = threadIdx.x / cols, c = threadIdx.x % cols;
  while (r < rows) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// K6: one DilConv edge as an implicit GEMM on the tensor cores. A block
// owns a th x tw tile of one image and an N-slice of ns output channels
// (blockIdx.z = image * slices + slice); its warps are ng groups of one
// warp per 16 tile pixels (rows past th * tw repeat the last pixel and are
// not stored), and group i holds the i-th run of the slice's fragments.
// M = tile pixels, N = ns, K = taps x Cpad; for tap (ta, tb) the A rows
// are the window pixels (r + ta*dil, q + tb*dil), whose channels are
// contiguous in shared memory, so no im2col is built. The raw window is
// copied once by cp.async (zero outside the image and in the pad
// channels); the tap's ns x Cpad weights stream through a two-stage
// cp.async buffer. Epilogue: + fp32 bias, one rounding, channel pairs
// stored together where the layout allows.
template <typename T>
__global__ void __launch_bounds__(DENSE_MWARPS * DENSE_GROUPS * 32)
    dense_stage_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int EB = sizeof(T);
  const Edge& e = a.e[0];
  const int slices = a.O8 / a.ns;
  const int n = blockIdx.z / slices, n0 = (blockIdx.z % slices) * a.ns;
  const int r0 = blockIdx.y * a.th, c0 = blockIdx.x * a.tw;
  const int C = a.C, k = e.k, dil = e.dil, R = dil * (k / 2), kk = k * k;
  const int wh = a.th + 2 * R, ww = a.tw + 2 * R;
  const int cpad = dense_cpad(C, EB), pb = dense_pitch(C, EB) * EB;  // pitch in bytes
  const int chunks = cpad * EB / 16;                                  // 16-byte pieces a row
  unsigned char* win = smem;
  unsigned char* wst = smem + (size_t)wh * ww * pb;  // stage s, row r at (s * ns + r) * pb

  // the window, raw: 16-byte cp.async where the source allows, else by element
  const unsigned char* src =
      static_cast<const unsigned char*>(e.src) + (size_t)n * e.img_stride * EB;
  const int cbytes = C * EB;
  const bool vec = cbytes % 16 == 0 && (e.ps * EB) % 16 == 0 && (e.img_stride * EB) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(e.src) % 16 == 0;
  if (vec) {
    const int cc = cbytes / 16;
    for_2d(wh * ww, chunks, [&](int p, int j) {
      const int wr = p / ww, gr = r0 - R + wr, gc = c0 - R + p - wr * ww;
      unsigned char* dst = win + (size_t)p * pb + j * 16;
      if (j < cc) {
        const bool inside = gr >= 0 && gr < a.H && gc >= 0 && gc < a.W;
        const unsigned char* s =
            inside ? src + (((size_t)gr * a.W + gc) * e.ps) * EB + j * 16 : src;
        cp_async16(dst, s, inside);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    });
  } else {
    const T* s = reinterpret_cast<const T*>(src);
    for (int i = threadIdx.x; i < wh * ww * cpad; i += blockDim.x) {
      const int c = i % cpad, p = i / cpad;
      const int gr = r0 - R + p / ww, gc = c0 - R + p % ww;
      const bool inside = c < C && gr >= 0 && gr < a.H && gc >= 0 && gc < a.W;
      reinterpret_cast<T*>(win + (size_t)p * pb)[c] =
          inside ? s[((size_t)gr * a.W + gc) * e.ps + c] : Cvt<T>::from(0.f);
    }
  }

  const unsigned char* q = static_cast<const unsigned char*>(e.w2);
  auto load_tap = [&](int tap, int stage) {
    const unsigned char* g = q + ((size_t)tap * a.O8 + n0) * cpad * EB;
    unsigned char* d = wst + (size_t)stage * a.ns * pb;
    for_2d(a.ns, chunks, [&](int r, int j) {
      cp_async16(d + r * pb + j * 16, g + r * cpad * EB + j * 16, true);
    });
  };
  load_tap(0, 0);
  cp_async_commit();

  // warp = (m-warp mw: tile pixels [16 mw, 16 mw + 16), group: a run of
  // nf of the slice's n8 fragments starting at j0)
  const int M = a.th * a.tw, mws = (M + 15) / 16, lane = threadIdx.x % 32;
  const int mw = (threadIdx.x / 32) % mws, group = threadIdx.x / 32 / mws;
  const int per = (a.ns / 8 + a.ng - 1) / a.ng, j0 = group * per;
  const int nf = max(0, min(per, a.ns / 8 - j0));
  // this lane's ldmatrix rows: A pixel (tile row pr, column pc) and k half;
  // B row (output channel within a pair of n8 blocks) and k half
  const int p = min(mw * 16 + (lane & 15), M - 1), pr = p / a.tw, pc = p % a.tw;
  const unsigned char* a_lane = win + (size_t)(pr * ww + pc) * pb + (lane >> 4) * 16;
  const int b_row = j0 * 8 + (lane & 7) + ((lane >> 4) << 3);
  const int b_off = b_row * pb + ((lane >> 3) & 1) * 16;

  float acc[NF_MAX][4], acc_lo[NF_MAX][4];
#pragma unroll
  for (int j = 0; j < NF_MAX; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = acc_lo[j][i] = 0.f;

  const int ksteps = cpad * EB / 32;
  for (int tap = 0; tap < kk; ++tap) {
    if (tap + 1 < kk) load_tap(tap + 1, (tap + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // the window and this tap's weights have landed
    __syncthreads();
    const int ta = tap / k, tb = tap % k;
    const unsigned char* ap = a_lane + (size_t)(ta * dil * ww + tb * dil) * pb;
    const unsigned char* bp = wst + (size_t)((tap & 1) * a.ns) * pb + b_off;
    if (nf > 0) {
      // the next step's fragments are loaded before this step's products,
      // into the other of two register sets (no copies between them)
      Frags f0, f1;
      dense_load(ap, bp, pb, nf, f0);
      dense_prep<T>(f0);
      for (int s = 0; s < ksteps; s += 2) {
        if (s + 1 < ksteps) dense_load(ap + (s + 1) * 32, bp + (s + 1) * 32, pb, nf, f1);
        dense_mma<T>(f0, nf, acc, acc_lo);
        if (s + 1 < ksteps) {
          dense_prep<T>(f1);
          if (s + 2 < ksteps) dense_load(ap + (s + 2) * 32, bp + (s + 2) * 32, pb, nf, f0);
          dense_mma<T>(f1, nf, acc, acc_lo);
          if (s + 2 < ksteps) dense_prep<T>(f0);
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration
  }

  // epilogue: lane holds rows g, g + 8 and channel pair 2t, 2t + 1 of each fragment
  T* out = static_cast<T*>(a.out) + (size_t)n * a.out_img_stride;
  const bool pairs = (a.out_ps % 2 == 0) && (a.out_img_stride % 2 == 0) &&
                     reinterpret_cast<uintptr_t>(a.out) % (2 * EB) == 0;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pp = mw * 16 + g + 8 * h;
    const int gr = r0 + pp / a.tw, gc = c0 + pp % a.tw;
    if (pp >= M || gr >= a.H || gc >= a.W) continue;
    T* o = out + ((size_t)gr * a.W + gc) * a.out_ps;
#pragma unroll
    for (int j = 0; j < NF_MAX; ++j) {
      if (j >= nf) break;
      const int co = n0 + (j0 + j) * 8 + 2 * t;
      const float y0 = acc_lo[j][2 * h] + acc[j][2 * h] + e.b1[co];
      const float y1 = acc_lo[j][2 * h + 1] + acc[j][2 * h + 1] + e.b1[co + 1];
      if (pairs && co + 1 < C) {
        if constexpr (EB == 2)
          *reinterpret_cast<__nv_bfloat162*>(o + co) = __floats2bfloat162_rn(y0, y1);
        else
          *reinterpret_cast<float2*>(o + co) = make_float2(y0, y1);
      } else {
        if (co < C) o[co] = Cvt<T>::from(y0);
        if (co + 1 < C) o[co + 1] = Cvt<T>::from(y1);
      }
    }
  }
}

int launch(const void* kernel, const Args& a, size_t need, void* stream) {
  if (a.th <= 0 || a.tw <= 0 || a.tw % PX || a.O8 % OG || a.O8 < a.C || a.C <= 0 ||
      (size_t)a.smem < need || a.smem > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.W + a.tw - 1) / a.tw, (a.H + a.th - 1) / a.th, a.N);
  void* params[] = {const_cast<Args*>(&a)};
  err = cudaLaunchKernel(kernel, grid, dim3(THREADS), params, a.smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int launch_dense(const Args& a, void* stream) {
  const Edge& e = a.e[0];
  const int M = a.th * a.tw;
  if (a.th <= 0 || a.tw <= 0 || M > DENSE_MWARPS * 16 || a.ng < 1 || a.ng > DENSE_GROUPS ||
      a.C <= 0 || a.O8 % OG || a.O8 < a.C ||
      a.ns <= 0 || a.ns % OG || a.ns > OG * NF_MAX || a.O8 % a.ns || e.kind != DIL || e.k <= 0 ||
      e.dil <= 0 || e.w2 == nullptr || (size_t)a.smem < dense_smem(a) || a.smem > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = a.is_bf16 ? (const void*)dense_stage_kernel<__nv_bfloat16>
                                 : (const void*)dense_stage_kernel<float>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.W + a.tw - 1) / a.tw, (a.H + a.th - 1) / a.th, a.N * (a.O8 / a.ns));
  void* params[] = {const_cast<Args*>(&a)};
  err = cudaLaunchKernel(kernel, grid, dim3((M + 15) / 16 * a.ng * 32), params, a.smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() after the launch (0 on success); a shared-memory
// grant below the kernel's carve-up, or a tile it does not take, returns
// cudaErrorInvalidValue without launching.
extern "C" int add_cell_block(const Args* a, void* stream) {
  return a->is_bf16 ? launch((const void*)block_kernel<__nv_bfloat16>, *a, block_smem(*a), stream)
                    : launch((const void*)block_kernel<float>, *a, block_smem(*a), stream);
}

extern "C" int add_cell_sep_fused(const Args* a, void* stream) {
  return a->is_bf16
             ? launch((const void*)sep_fused_kernel<__nv_bfloat16>, *a, edge_smem(*a), stream)
             : launch((const void*)sep_fused_kernel<float>, *a, edge_smem(*a), stream);
}

extern "C" int add_cell_sep_stage(const Args* a, void* stream) {
  return a->is_bf16
             ? launch((const void*)sep_stage_kernel<__nv_bfloat16>, *a, stage_smem(*a), stream)
             : launch((const void*)sep_stage_kernel<float>, *a, stage_smem(*a), stream);
}

extern "C" int add_cell_dense_stage(const Args* a, void* stream) { return launch_dense(*a, stream); }

// Shared-memory bytes a kernel carves for these arguments (0 block, 1 sep
// fused, 2 sep stage, 3 dense stage), and sizeof(Args): the host's plans
// and ctypes structure are checked against both.
extern "C" long long add_cell_smem_bytes(int which, const Args* a) {
  switch (which) {
    case 0: return (long long)block_smem(*a);
    case 1: return (long long)edge_smem(*a);
    case 2: return (long long)stage_smem(*a);
    case 3: return (long long)dense_smem(*a);
    default: return -1;
  }
}

extern "C" int add_cell_args_size() { return (int)sizeof(Args); }

extern "C" const char* add_cell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
