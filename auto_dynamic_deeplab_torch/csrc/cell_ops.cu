// K3-K6: the cell-DAG kernels of the `--cell-exec flat` path (eval, BN folded).
//
// They replace the Pallas functions of auto_dynamic_deeplab_tpu/kernels/cell_ops.py:
//   K3 block_kernel        block_stage :765 (_block_kernel :566, pallas_call :826)
//   K4 block_kernel        sep_fused   :385 (_sep_fused_kernel :335, pallas_call :413),
//                          launched with one sep edge
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
// K3 writes into directly. Weights: dwk (C, k*k) fp32; biases (O8,) fp32,
// O8 = C rounded up to 8. The kernels read the pointwise and dense weights
// packed as (taps, O8, Cpad) in the state dtype: input channels innermost,
// zero-padded to Cpad (one 32-byte mma depth step); a pointwise weight is
// one tap.
//
// Bound on an H100 SXM. A flagship cell's DAG is about 8.2 GFLOP at every
// level (dil5 = 50 C^2 FLOP a pixel, sep = 4 C (k^2 + C)), 98.7 GFLOP for
// the 12 cells at 1025x2049, against 0.66 GB of state traffic in fp32
// (0.33 GB in bf16). The products are 95-99% of it and run on the tensor
// cores (989 TFLOP/s bf16; fp32 by 3xTF32 at 495 / 3); the depthwise taps
// run on the CUDA cores in fp32 (67 TFLOP/s).
//
// The tap-GEMM routine (tap_gemm, tap_gemm.cuh, shared with K1). An implicit GEMM per
// block: M = the pixels of a th x tw tile (one warp per 16, times 1-2 warp
// groups that split N), N = an ns-channel slice of the outputs (ns | O8,
// ns <= 40; the host's plan splits N over blockIdx.z so that the grid
// fills the SMs: 45 tiles x 4-5 slices at 33x65, C=160), K = taps x Cpad.
// A is a window in shared memory at a row pitch of Cpad plus 16 bytes, so
// that ldmatrix's 8 rows hit 8 bank groups; for tap (a, b) the A rows are
// the window pixels (r + a*dil, q + b*dil) and no im2col is built. The
// tap's ns x Cpad weights stream through a two-stage cp.async buffer.
// bf16: mma.sync m16n8k16 with fp32 accumulators. fp32: m16n8k8 tf32 in
// the 3xTF32 split (x = hi + lo, both tf32, hi*hi + hi*lo + lo*hi summed
// in fp32, ~2^-21 a product), since the port's fp32 policy is full fp32
// and plain TF32 misses 1e-4; both halves are split in registers, which
// keeps the fp32 weight stages at one copy. A DilConv is k x k taps at
// dilation 2 on its raw window (copied once by cp.async, ReLU applied to
// the A fragments); a pointwise product is one tap on a depthwise output.
//
// K6 (dense_stage_kernel): one DilConv, the routine on its window; the
// epilogue adds the fp32 bias, rounds once and stores channel pairs.
//
// K3/K4 (block_kernel): a block owns a th x tw tile of one image and an
// ns-channel slice of the outputs, and runs its 1-2 edges one after
// another over the same working space, accumulating their products into
// the same fp32 registers. A dil edge is the routine on its window. A sep
// edge copies its input window with a 2(k//2) halo raw by cp.async; the
// depthwise runs on the CUDA cores in fp32 (taps in registers, one channel
// pair a thread, ReLU at the read for stage 1), rounded and written at the
// mma pitch with 0 in the pad channels; pw1 is the routine over the
// stage-1 region (tile plus a k//2 halo), every output channel, in chunks
// of ns, with an epilogue (+b1, ReLU, 0 outside the image, round) that
// writes the mid over the spent input window; dw2, then pw2 over the
// block's slice only. So every slice recomputes stage 1 for all C
// channels; the plan weighs that against the waves a wider grid saves.
// The epilogue sums the edges' biases and skip sources, rounds once and
// writes the block's channel slice of the concat.
//
// K5 (sep_stage_kernel): a block owns a th x tw tile of one image and an
// ns-channel slice of the outputs, as K3 and K6 do, and takes the input
// channels in chunks of 128 bytes (32 fp32, 64 bf16: four mma depth
// steps), so that its shared memory does not grow with C (57.6 KB for
// sep5 on 8x8 in either dtype). Chunk j + 1's raw window (tile plus a
// k//2 halo) and its ns weight rows are copied by cp.async into the other
// of two stages while chunk j computes: its depthwise on the CUDA cores
// (fp32 taps in registers, ReLU at the read by flag, rounded, 0 in the pad
// channels) into an A chunk at the mma pitch, then that chunk's mma k-steps
// into the block's fp32 accumulators. Every slice recomputes the depthwise
// for all C channels (k^2 taps against C products a pixel). The epilogue
// adds the fp32 bias, ReLUs by flag and rounds once.
// Every kernel launches on the caller's stream, allocates nothing, and
// checks the host's shared-memory grant against its own carve-up.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tap_gemm.cuh"

// Mirrored by kernels/cell_ops.py::_Edge / _Args (ctypes). Outside the
// anonymous namespace: the C entry points take them and must stay external.
struct Edge {
  const void* src;       // the edge's source state
  long long img_stride;  // elements between images
  int ps;                // elements between pixels
  int kind, k, dil;
  const float* dwk1;     // sep: stage-1 dw taps (C, k*k); K5: the stage's
  const float* b1;       // (O8,): sep stage 1, dil, K5's stage
  const void* pk1;       // packed (taps, O8, Cpad): sep stage-1 (K5: the stage's) pw (1 tap), dil (k*k taps)
  const float* dwk2;     // sep: stage 2
  const float* b2;
  const void* pk2;       // sep: stage-2 pw, packed (1, O8, Cpad)
};

struct Args {
  Edge e[2];
  int n_edges, in_relu, out_relu, is_bf16;
  void* out;
  long long out_img_stride;
  int out_ps, N, H, W, C, O8, th, tw, smem;
  int ns, ng;  // output channels a block computes (its N-slice), warp groups over them
};

namespace {

constexpr int OG = 8;  // output channels of one n8 mma fragment
constexpr int SMEM_MAX = 232448;
// K5: bytes of input channels in one chunk (32 fp32, 64 bf16: four mma
// depth steps); its A and B chunk rows are 16 bytes longer (ldmatrix)
constexpr int STAGE_CHUNK = 128;
constexpr int STAGE_PITCH = STAGE_CHUNK + 16;

enum { SKIP = 0, SEP = 1, DIL = 2 };

// ------------------------------------------------ shared-memory carve-up
// (kernels/cell_ops.py's plan functions compute the same bytes)

inline int elem_bytes(const Args& a) { return a.is_bf16 ? 2 : 4; }

// K5: two stages of a chunk's raw window (tile plus a k//2 halo, rows of
// STAGE_CHUNK bytes) and of its ns weight rows, and the chunk's A rows
size_t stage_smem(const Args& a) {
  const int r = a.e[0].k / 2;
  return 2 * ((size_t)(a.th + 2 * r) * (a.tw + 2 * r) * STAGE_CHUNK + (size_t)a.ns * STAGE_PITCH) +
         (size_t)a.th * a.tw * STAGE_PITCH;
}

// Rows (pixels) of one edge's working space on a th x tw tile: a sep
// edge's input window with a 2(k//2) halo plus its stage-1 region (tile
// plus a k//2 halo), a dil edge's window with its dilated halo.
__host__ __device__ inline int edge_rows(int kind, int k, int dil, int th, int tw) {
  if (kind == SEP) {
    const int r = k / 2;
    return (th + 4 * r) * (tw + 4 * r) + (th + 2 * r) * (tw + 2 * r);
  }
  if (kind == DIL) {
    const int R = dil * (k / 2);
    return (th + 2 * R) * (tw + 2 * R);
  }
  return 0;
}

__host__ __device__ inline int space_rows(const Args& a) {
  int m = 0;
  for (int i = 0; i < a.n_edges; ++i) {
    const int r = edge_rows(a.e[i].kind, a.e[i].k, a.e[i].dil, a.th, a.tw);
    m = r > m ? r : m;
  }
  return m;
}

// Edges of a K3 block with products (not skip)
__host__ __device__ inline int product_edges(const Args& a) {
  int m = 0;
  for (int i = 0; i < a.n_edges; ++i) m += a.e[i].kind != SKIP;
  return m;
}

// Floats a thread of K3 parks between two edges with products: its
// accumulators, 4 for each of its group's n8 fragments
__host__ __device__ inline int stash_floats(const Args& a) {
  return product_edges(a) > 1 ? 4 * ((a.ns / 8 + a.ng - 1) / a.ng) : 0;
}

// K3, K4 and K6: the largest edge's space, then two stages of ns weight
// rows, then K3's stash, stash_floats for each of the block's threads
size_t block_smem(const Args& a) {
  const int eb = elem_bytes(a), threads = (a.th * a.tw + 15) / 16 * a.ng * 32;
  return ((size_t)space_rows(a) + 2 * (size_t)a.ns) * dense_pitch(a.C, eb) * eb +
         (size_t)threads * stash_floats(a) * sizeof(float);
}

// ------------------------------------------------------ shared pieces

constexpr int MMA_MWARPS = 4;  // warps along M, one per 16 tile pixels: at most 4
constexpr int MMA_GROUPS = 2;  // warp groups that split the N-slice: at most 2
constexpr int NF_MAX = 5;      // n8 fragments a warp holds, so ns <= 40

// Channels [ch0, ch0 + cw) of the window of source pixels (r0 + i, c0 +
// j), i < wh, j < ww, raw (no ReLU): pixel i * ww + j at that row times pb
// bytes, 0 outside the image and in channels >= C. 16-byte cp.async where
// the source's address and strides allow (the caller commits and waits),
// else element by element. ch0 and cw are whole 32-byte depth steps.
template <typename T>
__device__ __forceinline__ void load_raw_channels(const Edge& e, int n, int H, int W, int C, int r0,
                                                  int c0, int wh, int ww, int ch0, int cw,
                                                  unsigned char* win, int pb) {
  constexpr int EB = sizeof(T);
  const unsigned char* src =
      static_cast<const unsigned char*>(e.src) + (size_t)n * e.img_stride * EB;
  const int cbytes = C * EB;
  const bool vec = cbytes % 16 == 0 && (e.ps * EB) % 16 == 0 && (e.img_stride * EB) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(e.src) % 16 == 0;
  if (vec) {
    const int cc = (C - ch0) * EB / 16;  // the segments that hold channels < C
    for_2d(wh * ww, cw * EB / 16, [&](int p, int j) {
      const int wr = p / ww, gr = r0 + wr, gc = c0 + p - wr * ww;
      unsigned char* dst = win + (size_t)p * pb + j * 16;
      if (j < cc) {
        const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
        const unsigned char* s = inside ? src + (((size_t)gr * W + gc) * e.ps + ch0) * EB + j * 16 : src;
        cp_async16(dst, s, inside);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    });
  } else {
    const T* s = reinterpret_cast<const T*>(src);
    for (int i = threadIdx.x; i < wh * ww * cw; i += blockDim.x) {
      const int c = i % cw, p = i / cw;
      const int gr = r0 + p / ww, gc = c0 + p % ww;
      const bool inside = ch0 + c < C && gr >= 0 && gr < H && gc >= 0 && gc < W;
      reinterpret_cast<T*>(win + (size_t)p * pb)[c] =
          inside ? s[((size_t)gr * W + gc) * e.ps + ch0 + c] : Cvt<T>::from(0.f);
    }
  }
}

// The whole window (every channel) in the mma layout
template <typename T>
__device__ __forceinline__ void load_raw_window(const Edge& e, int n, int H, int W, int C, int r0,
                                                int c0, int wh, int ww, unsigned char* win) {
  constexpr int EB = sizeof(T);
  load_raw_channels<T>(e, n, H, W, C, r0, c0, wh, ww, 0, dense_cpad(C, EB), win, dense_pitch(C, EB) * EB);
}

// dst (dh x dw pixels, rows of dpb bytes) = round(depthwise K x K of src
// (rows of spb bytes, sw pixels a row)), dst pixel (i, j) reading src
// pixels (i..i+K-1, j..j+K-1), ReLU'd at the read when RELU, over the
// cpad channels of a row; 0 in channels >= C. A thread keeps one channel
// pair's fp32 taps in registers and walks the pixels two at a time along a
// row (dw is even), loading K + 1 input columns a tap row instead of 2K.
template <typename T, bool RELU, int K>
__device__ __forceinline__ void depthwise_mma(const unsigned char* src, int sw, int spb, int C,
                                              int cpad, const float* __restrict__ dwk,
                                              unsigned char* dst, int dpb, int dh, int dw) {
  const int pairs = cpad / 2, per = blockDim.x / pairs;
  const int c = 2 * (threadIdx.x % pairs);
  int p = threadIdx.x / pairs;
  if (p >= per) return;
  float w0[K * K], w1[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) {
    w0[i] = c < C ? __ldg(dwk + c * K * K + i) : 0.f;
    w1[i] = c + 1 < C ? __ldg(dwk + (c + 1) * K * K + i) : 0.f;
  }
  const int hw2 = dw / 2;  // two adjacent pixels a step: the regions' widths are even
  for (; p < dh * hw2; p += per) {
    const int i = p / hw2, j = 2 * (p - i * hw2);
    const unsigned char* s = src + ((size_t)i * sw + j) * spb + c * sizeof(T);
    float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll
    for (int ta = 0; ta < K; ++ta) {
      float2 v[K + 1];
#pragma unroll
      for (int tb = 0; tb <= K; ++tb) {
        v[tb] = load2(reinterpret_cast<const T*>(s + (size_t)(ta * sw + tb) * spb));
        if (RELU) {
          v[tb].x = fmaxf(v[tb].x, 0.f);
          v[tb].y = fmaxf(v[tb].y, 0.f);
        }
      }
#pragma unroll
      for (int tb = 0; tb < K; ++tb) {
        a0 = fmaf(v[tb].x, w0[ta * K + tb], a0);
        a1 = fmaf(v[tb].y, w1[ta * K + tb], a1);
        b0 = fmaf(v[tb + 1].x, w0[ta * K + tb], b0);
        b1 = fmaf(v[tb + 1].y, w1[ta * K + tb], b1);
      }
    }
    T* o = reinterpret_cast<T*>(dst + ((size_t)i * dw + j) * dpb) + c;
    store2(o, c < C ? a0 : 0.f, c + 1 < C ? a1 : 0.f);
    store2(reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(o) + dpb), c < C ? b0 : 0.f,
           c + 1 < C ? b1 : 0.f);
  }
}

template <typename T, bool RELU>
__device__ __forceinline__ void depthwise_k(int k, const unsigned char* src, int sw, int spb, int C,
                                            int cpad, const float* dwk, unsigned char* dst, int dpb,
                                            int dh, int dw) {
  if (k == 3)
    depthwise_mma<T, RELU, 3>(src, sw, spb, C, cpad, dwk, dst, dpb, dh, dw);
  else
    depthwise_mma<T, RELU, 5>(src, sw, spb, C, cpad, dwk, dst, dpb, dh, dw);
}

// The epilogue of K5 and K6: y = the products (acc_lo + acc) + the fp32
// bias, ReLU'd when `relu`, rounded once, at the lane's rows g, g + 8 and
// channel pair 2t, 2t + 1 of each of its fragments of the block's slice
// (output channels from n0); channel pairs stored together where the
// layout allows; pixels outside the image and pad channels skipped.
template <typename T>
__device__ __forceinline__ void store_slice(const Args& a, const WarpTile& w, int n, int n0, int r0,
                                            int c0, const float* bias, bool relu,
                                            const float (&acc)[NF_MAX][4], const float (&acc_lo)[NF_MAX][4]) {
  constexpr int EB = sizeof(T);
  const int C = a.C;
  T* out = static_cast<T*>(a.out) + (size_t)n * a.out_img_stride;
  const bool pairs = (a.out_ps % 2 == 0) && (a.out_img_stride % 2 == 0) &&
                     reinterpret_cast<uintptr_t>(a.out) % (2 * EB) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pp = w.mw * 16 + w.g() + 8 * h;
    const int gr = r0 + pp / a.tw, gc = c0 + pp % a.tw;
    if (pp >= a.th * a.tw || gr >= a.H || gc >= a.W) continue;
    T* o = out + ((size_t)gr * a.W + gc) * a.out_ps;
#pragma unroll
    for (int j = 0; j < NF_MAX; ++j) {
      if (j >= w.nf) break;
      const int co = n0 + (w.j0 + j) * 8 + 2 * w.t();
      float y0 = acc_lo[j][2 * h] + acc[j][2 * h] + bias[co];
      float y1 = acc_lo[j][2 * h + 1] + acc[j][2 * h + 1] + bias[co + 1];
      if (relu) {
        y0 = fmaxf(y0, 0.f);
        y1 = fmaxf(y1, 0.f);
      }
      if (pairs && co + 1 < C) {
        store2(o + co, y0, y1);
      } else {
        if (co < C) o[co] = Cvt<T>::from(y0);
        if (co + 1 < C) o[co + 1] = Cvt<T>::from(y1);
      }
    }
  }
}

// ------------------------------------------------------------- K5

// K5: one [ReLU] -> dw k x k -> round -> pw -> +b -> [ReLU] stage. A block
// owns a th x tw tile of one image and an N-slice of ns output channels
// (blockIdx.z = image * slices + slice) and walks the input channels in
// chunks of STAGE_CHUNK bytes: chunk j + 1's raw window and weight rows
// are copied into the other stage while chunk j's depthwise and products
// run; two barriers a chunk.
template <typename T>
__global__ void __launch_bounds__(MMA_MWARPS * MMA_GROUPS * 32) sep_stage_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int EB = sizeof(T), CH = STAGE_CHUNK / EB;
  const Edge& e = a.e[0];
  const int slices = a.O8 / a.ns;
  const int n = blockIdx.z / slices, n0 = (blockIdx.z % slices) * a.ns;
  const int r0 = blockIdx.y * a.th, c0 = blockIdx.x * a.tw;
  const int C = a.C, k = e.k, r = k / 2, wh = a.th + 2 * r, ww = a.tw + 2 * r, M = a.th * a.tw;
  const int cpad = dense_cpad(C, EB), chunks = (cpad + CH - 1) / CH;
  const size_t raw_bytes = (size_t)wh * ww * STAGE_CHUNK;
  unsigned char* raw = smem;                                 // two stages of a chunk's raw window
  unsigned char* A = raw + 2 * raw_bytes;                    // the chunk's depthwise output, M rows
  unsigned char* B = A + (size_t)M * STAGE_PITCH;            // two stages of the chunk's ns weight rows
  const unsigned char* pk = static_cast<const unsigned char*>(e.pk1) + (size_t)n0 * cpad * EB;
  auto load_chunk = [&](int j) {
    const int ch0 = j * CH, cw = min(CH, cpad - ch0), st = j & 1;
    load_raw_channels<T>(e, n, a.H, a.W, C, r0 - r, c0 - r, wh, ww, ch0, cw, raw + st * raw_bytes,
                         STAGE_CHUNK);
    unsigned char* b = B + (size_t)st * a.ns * STAGE_PITCH;
    for_2d(a.ns, cw * EB / 16, [&](int row, int q) {
      cp_async16(b + row * STAGE_PITCH + q * 16, pk + ((size_t)row * cpad + ch0) * EB + q * 16, true);
    });
  };
  const WarpTile w(M, a.ns, a.ng, STAGE_PITCH);
  const unsigned char* a_lane = w.a_row(A, a.tw, a.tw, M);
  const int b_off = w.b_off();

  float acc[NF_MAX][4], acc_lo[NF_MAX][4];
#pragma unroll
  for (int j = 0; j < NF_MAX; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = acc_lo[j][i] = 0.f;
  load_chunk(0);
  cp_async_commit();
  for (int j = 0; j < chunks; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // chunk j has landed; chunk j - 1's products are done with A and the other stage
    if (j + 1 < chunks) load_chunk(j + 1);
    cp_async_commit();
    const int ch0 = j * CH, cw = min(CH, cpad - ch0);
    const unsigned char* src = raw + (j & 1) * raw_bytes;
    if (a.in_relu)
      depthwise_k<T, true>(k, src, ww, STAGE_CHUNK, C - ch0, cw, e.dwk1 + ch0 * k * k, A, STAGE_PITCH, a.th, a.tw);
    else
      depthwise_k<T, false>(k, src, ww, STAGE_CHUNK, C - ch0, cw, e.dwk1 + ch0 * k * k, A, STAGE_PITCH, a.th, a.tw);
    __syncthreads();  // the A chunk is written
    warp_product<T, false>(a_lane, B + (size_t)(j & 1) * a.ns * STAGE_PITCH + b_off, STAGE_PITCH, w.nf,
                           cw * EB / 32, acc, acc_lo);
  }
  store_slice<T>(a, w, n, n0, r0, c0, e.b1, a.out_relu != 0, acc, acc_lo);
}

// ------------------------------------------------------------- K6

// K6: one DilConv edge, the tap-GEMM routine on its window. A block owns
// a th x tw tile of one image and an N-slice of ns output channels
// (blockIdx.z = image * slices + slice). Epilogue: + fp32 bias, one
// rounding (store_slice).
template <typename T>
__global__ void __launch_bounds__(MMA_MWARPS * MMA_GROUPS * 32) dense_stage_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int EB = sizeof(T);
  const Edge& e = a.e[0];
  const int slices = a.O8 / a.ns;
  const int n = blockIdx.z / slices, n0 = (blockIdx.z % slices) * a.ns;
  const int r0 = blockIdx.y * a.th, c0 = blockIdx.x * a.tw;
  const int C = a.C, R = e.dil * (e.k / 2);
  const int wh = a.th + 2 * R, ww = a.tw + 2 * R;
  const int cpad = dense_cpad(C, EB), pb = dense_pitch(C, EB) * EB;
  unsigned char* win = smem;
  unsigned char* wst = smem + (size_t)wh * ww * pb;
  load_raw_window<T>(e, n, a.H, a.W, C, r0 - R, c0 - R, wh, ww, win);
  const WarpTile w(a.th * a.tw, a.ns, a.ng, pb);

  float acc[NF_MAX][4], acc_lo[NF_MAX][4];
#pragma unroll
  for (int j = 0; j < NF_MAX; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = acc_lo[j][i] = 0.f;
  tap_gemm<T, true>(w.a_row(win, ww, a.tw, a.th * a.tw), ww, e.k, e.dil,
                    static_cast<const unsigned char*>(e.pk1) + (size_t)n0 * cpad * EB,
                    (size_t)a.O8 * cpad * EB, a.ns, cpad, wst, w, acc, acc_lo);

  store_slice<T>(a, w, n, n0, r0, c0, e.b1, false, acc, acc_lo);
}

// ---------------------------------------------------------- K3 and K4

// One sep edge's products into the block's accumulators: stage 1 on the
// tile plus a k//2 halo for every output channel, dw2, then pw2 over the
// block's slice (output channels n0..n0+ns) without its bias.
template <typename T>
__device__ __forceinline__ void sep_products(const Edge& e, const Args& a, int n, int n0, int r0,
                                             int c0, unsigned char* space, unsigned char* wst,
                                             const WarpTile& w, float (&acc)[NF_MAX][4],
                                             float (&acc_lo)[NF_MAX][4]) {
  constexpr int EB = sizeof(T);
  const int C = a.C, cpad = dense_cpad(C, EB), pb = w.pb, k = e.k, r = k / 2;
  const int th = a.th, tw = a.tw, xh = th + 4 * r, xw = tw + 4 * r, eh = th + 2 * r,
            ew = tw + 2 * r, M1 = eh * ew, ns = a.ns;
  const size_t rb = (size_t)cpad * EB;  // one packed weight row
  unsigned char* X = space;                       // the input window, then the mid
  unsigned char* D = space + (size_t)xh * xw * pb;  // dw1, then dw2
  const unsigned char* pk1 = static_cast<const unsigned char*>(e.pk1);
  load_raw_window<T>(e, n, a.H, a.W, C, r0 - 2 * r, c0 - 2 * r, xh, xw, X);
  stage_rows<T>(pk1, ns, cpad, wst, pb);  // pw1's first chunk of output channels
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  depthwise_k<T, true>(k, X, xw, pb, C, cpad, e.dwk1, D, pb, eh, ew);

  // pw1 over the M1 stage-1 pixels and all O8 outputs, in chunks of ns
  // output channels (the warp's fragments of a chunk as of the slice);
  // epilogue +b1, ReLU, 0 outside the image, round: the mid, over X
  const int chunks = a.O8 / ns, mfr = (M1 + 15) / 16, ksteps = cpad * EB / 32, b_off = w.b_off();
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) stage_rows<T>(pk1 + (ch + 1) * ns * rb, ns, cpad, wst + ((ch + 1) & 1) * ns * pb, pb);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // dw1 is written (first chunk), this chunk has landed
    const unsigned char* bp = wst + (size_t)(ch & 1) * ns * pb + b_off;
    for (int mf = w.mw; mf < mfr; mf += w.mws) {
      float m[NF_MAX][4], m_lo[NF_MAX][4];
#pragma unroll
      for (int j = 0; j < NF_MAX; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) m[j][i] = m_lo[j][i] = 0.f;
      const int p = min(mf * 16 + (w.lane & 15), M1 - 1);
      warp_product<T, false>(D + (size_t)p * pb + (w.lane >> 4) * 16, bp, pb, w.nf, ksteps, m, m_lo);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pp = mf * 16 + w.g() + 8 * h;
        if (pp >= M1) continue;
        const int pr = pp / ew, gr = r0 - r + pr, gc = c0 - r + pp - pr * ew;
        const bool inside = gr >= 0 && gr < a.H && gc >= 0 && gc < a.W;
        T* o = reinterpret_cast<T*>(X + (size_t)pp * pb);
#pragma unroll
        for (int j = 0; j < NF_MAX; ++j) {
          if (j >= w.nf) break;
          const int co = ch * ns + (w.j0 + j) * 8 + 2 * w.t();
          const float y0 = m_lo[j][2 * h] + m[j][2 * h] + e.b1[co];
          const float y1 = m_lo[j][2 * h + 1] + m[j][2 * h + 1] + e.b1[co + 1];
          store2(o + co, inside ? fmaxf(y0, 0.f) : 0.f, inside ? fmaxf(y1, 0.f) : 0.f);
        }
      }
    }
    __syncthreads();  // the stage is refilled next; the mid is whole after the last
  }
  depthwise_k<T, false>(k, X, ew, pb, C, cpad, e.dwk2, D, pb, th, tw);
  // pw2: one tap on dw2 (rows of tw pixels) over the block's slice; the
  // routine's first barrier orders dw2's writes before its reads
  tap_gemm<T, false>(w.a_row(D, tw, tw, th * tw), tw, 1, 1, static_cast<const unsigned char*>(e.pk2) + n0 * rb,
                     0, ns, cpad, wst, w, acc, acc_lo);
}

// K3 (and K4, with one sep edge): one DAG block. A block owns a th x tw
// tile of one image and an ns-channel slice of the outputs (blockIdx.z =
// image * slices + slice). Each edge's products accumulate from zero in
// fp32 registers; between two edges with products a thread parks its sums
// in its own shared-memory slots (no barrier), so that no accumulators
// are live through the next edge's stage 1. The epilogue adds the parked
// sums, the biases and the skip sources, rounds once and writes the slice.
// One instance for each warp-group count NG (= a.ng): with one group the
// registers are held to 168 a thread, so that three 128-thread blocks
// share an SM where the shared memory allows; with two, one 256-thread
// block takes what it needs (PERF.md §6).
template <typename T, int NG>
__global__ void __launch_bounds__(MMA_MWARPS * 32 * NG, NG == 1 ? 3 : 1) block_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int EB = sizeof(T);
  const int slices = a.O8 / a.ns;
  const int n = blockIdx.z / slices, n0 = (blockIdx.z % slices) * a.ns;
  const int r0 = blockIdx.y * a.th, c0 = blockIdx.x * a.tw;
  const int C = a.C, cpad = dense_cpad(C, EB), pb = dense_pitch(C, EB) * EB;
  unsigned char* space = smem;
  unsigned char* wst = smem + (size_t)space_rows(a) * pb;
  // slot (j * 4 + i) of thread x at stash[(j * 4 + i) * blockDim.x + x]
  float* stash = reinterpret_cast<float*>(wst + 2 * (size_t)a.ns * pb);
  const WarpTile w(a.th * a.tw, a.ns, a.ng, pb);

  float acc[NF_MAX][4], acc_lo[NF_MAX][4];
  int left = product_edges(a);
  bool parked = false;
  for (int ei = 0; ei < a.n_edges; ++ei) {
    const Edge& e = a.e[ei];
    if (e.kind == SKIP) continue;
#pragma unroll
    for (int j = 0; j < NF_MAX; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = acc_lo[j][i] = 0.f;
    if (e.kind == DIL) {
      const int R = e.dil * (e.k / 2), ww = a.tw + 2 * R;
      load_raw_window<T>(e, n, a.H, a.W, C, r0 - R, c0 - R, a.th + 2 * R, ww, space);
      tap_gemm<T, true>(w.a_row(space, ww, a.tw, a.th * a.tw), ww, e.k, e.dil,
                        static_cast<const unsigned char*>(e.pk1) + (size_t)n0 * cpad * EB,
                        (size_t)a.O8 * cpad * EB, a.ns, cpad, wst, w, acc, acc_lo);
    } else {
      sep_products<T>(e, a, n, n0, r0, c0, space, wst, w, acc, acc_lo);
    }
    if (--left > 0) {
#pragma unroll
      for (int j = 0; j < NF_MAX; ++j) {
        if (j >= w.nf) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float& slot = stash[(j * 4 + i) * blockDim.x + threadIdx.x];
          slot = (parked ? slot : 0.f) + acc_lo[j][i] + acc[j][i];
        }
      }
      parked = true;
    }
  }
  if (product_edges(a) == 0) {
#pragma unroll
    for (int j = 0; j < NF_MAX; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = acc_lo[j][i] = 0.f;
  }

  // epilogue: lane holds rows g, g + 8 and channel pair 2t, 2t + 1 of each fragment
  T* out = static_cast<T*>(a.out) + (size_t)n * a.out_img_stride;
  const bool pairs = (a.out_ps % 2 == 0) && (a.out_img_stride % 2 == 0) &&
                     reinterpret_cast<uintptr_t>(a.out) % (2 * EB) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pp = w.mw * 16 + w.g() + 8 * h;
    const int gr = r0 + pp / a.tw, gc = c0 + pp % a.tw;
    if (pp >= a.th * a.tw || gr >= a.H || gc >= a.W) continue;
    const size_t pix = (size_t)gr * a.W + gc;
    T* o = out + pix * a.out_ps;
#pragma unroll
    for (int j = 0; j < NF_MAX; ++j) {
      if (j >= w.nf) break;
      const int co = n0 + (w.j0 + j) * 8 + 2 * w.t();
      if (co >= C) continue;
      float y0 = acc_lo[j][2 * h] + acc[j][2 * h];
      float y1 = acc_lo[j][2 * h + 1] + acc[j][2 * h + 1];
      if (parked) {
        y0 += stash[(j * 4 + 2 * h) * blockDim.x + threadIdx.x];
        y1 += stash[(j * 4 + 2 * h + 1) * blockDim.x + threadIdx.x];
      }
      for (int ei = 0; ei < a.n_edges; ++ei) {
        const Edge& e = a.e[ei];
        if (e.kind == SKIP) {
          const T* s = static_cast<const T*>(e.src) + n * e.img_stride + pix * e.ps + co;
          y0 += Cvt<T>::to(s[0]);
          if (co + 1 < C) y1 += Cvt<T>::to(s[1]);
        } else {
          const float* b = e.kind == SEP ? e.b2 : e.b1;
          y0 += b[co];
          y1 += b[co + 1];
        }
      }
      if (pairs && co + 1 < C) {
        store2(o + co, y0, y1);
      } else {
        o[co] = Cvt<T>::from(y0);
        if (co + 1 < C) o[co + 1] = Cvt<T>::from(y1);
      }
    }
  }
}

// ------------------------------------------------------------ launches

int launch_kernel(const void* kernel, const Args& a, dim3 grid, int threads, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {const_cast<Args*>(&a)};
  err = cudaLaunchKernel(kernel, grid, dim3(threads), params, a.smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K3-K6 share their plan's checks: a tile of at most 64 pixels, an
// N-slice of whole n8 fragments that divides O8, a grant that covers the
// kernel's carve-up `carve`.
bool mma_plan_ok(const Args& a, size_t carve) {
  const int M = a.th * a.tw;
  return a.th > 0 && a.tw > 0 && M <= MMA_MWARPS * 16 && a.ng >= 1 && a.ng <= MMA_GROUPS &&
         a.C > 0 && a.O8 % OG == 0 && a.O8 >= a.C && a.ns > 0 && a.ns % OG == 0 &&
         a.ns <= OG * NF_MAX && a.O8 % a.ns == 0 && (size_t)a.smem >= carve && a.smem <= SMEM_MAX;
}

dim3 mma_grid(const Args& a) {
  return dim3((a.W + a.tw - 1) / a.tw, (a.H + a.th - 1) / a.th, a.N * (a.O8 / a.ns));
}

int mma_threads(const Args& a) { return (a.th * a.tw + 15) / 16 * a.ng * 32; }

int launch_stage(const Args& a, void* stream) {
  const Edge& e = a.e[0];
  // the depthwise gives each thread one channel pair and two pixels of a row
  if (a.n_edges != 1 || !mma_plan_ok(a, stage_smem(a)) || e.kind != SEP || (e.k != 3 && e.k != 5) ||
      a.tw % 2 || !e.dwk1 || !e.b1 || !e.pk1)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = a.is_bf16 ? (const void*)sep_stage_kernel<__nv_bfloat16>
                                 : (const void*)sep_stage_kernel<float>;
  return launch_kernel(kernel, a, mma_grid(a), mma_threads(a), stream);
}

int launch_dense(const Args& a, void* stream) {
  const Edge& e = a.e[0];
  if (a.n_edges != 1 || !mma_plan_ok(a, block_smem(a)) || e.kind != DIL || e.k <= 0 || e.dil <= 0 ||
      e.pk1 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = a.is_bf16 ? (const void*)dense_stage_kernel<__nv_bfloat16>
                                 : (const void*)dense_stage_kernel<float>;
  return launch_kernel(kernel, a, mma_grid(a), mma_threads(a), stream);
}

int launch_block(const Args& a, bool one_sep, void* stream) {
  if (a.n_edges < 1 || a.n_edges > 2 || !mma_plan_ok(a, block_smem(a))) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < a.n_edges; ++i) {
    const Edge& e = a.e[i];
    // a sep edge's depthwise gives each thread one channel pair and two pixels of a row
    const bool ok = e.kind == SKIP ||
                    (e.kind == SEP && (e.k == 3 || e.k == 5) && e.pk1 && e.pk2 && e.dwk1 && e.dwk2 &&
                     dense_cpad(a.C, elem_bytes(a)) / 2 <= mma_threads(a) && a.tw % 2 == 0) ||
                    (e.kind == DIL && e.k > 0 && e.dil > 0 && e.pk1);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (one_sep && (a.n_edges != 1 || a.e[0].kind != SEP)) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = a.is_bf16 ? (a.ng == 1 ? (const void*)block_kernel<__nv_bfloat16, 1>
                                              : (const void*)block_kernel<__nv_bfloat16, 2>)
                                 : (a.ng == 1 ? (const void*)block_kernel<float, 1>
                                              : (const void*)block_kernel<float, 2>);
  return launch_kernel(kernel, a, mma_grid(a), mma_threads(a), stream);
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() after the launch (0 on success); a shared-memory
// grant below the kernel's carve-up, or a plan it does not take, returns
// cudaErrorInvalidValue without launching.
extern "C" int add_cell_block(const Args* a, void* stream) { return launch_block(*a, false, stream); }

extern "C" int add_cell_sep_fused(const Args* a, void* stream) { return launch_block(*a, true, stream); }

extern "C" int add_cell_sep_stage(const Args* a, void* stream) { return launch_stage(*a, stream); }

extern "C" int add_cell_dense_stage(const Args* a, void* stream) { return launch_dense(*a, stream); }

// Shared-memory bytes a kernel carves for these arguments (0 block, 1 sep
// fused, 2 sep stage, 3 dense stage), and sizeof(Args): the host's plans
// and ctypes structure are checked against both.
extern "C" long long add_cell_smem_bytes(int which, const Args* a) {
  switch (which) {
    case 0:
    case 1:
    case 3: return (long long)block_smem(*a);
    case 2: return (long long)stage_smem(*a);
    default: return -1;
  }
}

extern "C" int add_cell_args_size() { return (int)sizeof(Args); }

extern "C" const char* add_cell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
