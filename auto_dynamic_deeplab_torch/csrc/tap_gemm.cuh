// The tensor-core pieces shared by K1 (stems.cu) and K3, K4, K6
// (cell_ops.cu): the mma layout, cp.async copies, ldmatrix fragments,
// mma.sync products (bf16 m16n8k16; fp32 by 3xTF32 on m16n8k8 tf32) and
// the tap-GEMM routine, an implicit GEMM whose A rows are pixels of a
// window in shared memory and whose B is a tap's packed weights (taps,
// out, Cpad) streamed through two cp.async stages (tap_stream). A warp's
// share of a product is 16 rows x NF n8 fragments, NF a template
// parameter that the accumulator arrays fix (K3-K6: 5; K1: 8 and 4).
//
// Included by each kernel source, which nvcc compiles into its own
// library: kernels/_build.py hashes this header into every library's name.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float to(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16(v); }
};

// The mma layout: channels padded to one mma depth step of 32 bytes (16
// bf16, 8 fp32), and a row pitch 16 bytes longer, so that a pitch is an
// odd multiple of 16 bytes and the 8 rows an ldmatrix reads fall on 8
// different bank groups.
__host__ __device__ inline int dense_cpad(int C, int eb) {
  const int q = 32 / eb;
  return (C + q - 1) / q * q;
}
__host__ __device__ inline int dense_pitch(int C, int eb) { return dense_cpad(C, eb) + 16 / eb; }

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
template <int NF>
struct Frags {
  uint32_t a[4];
  uint32_t b[NF][2];
};

// B fragments j < nf of one depth step: an ldmatrix.x4 for each pair of
// n8 row blocks, an x2 for an odd last one
template <int NF>
__device__ __forceinline__ void load_b(const unsigned char* b_ptr, int b_pitch_bytes, int nf, uint32_t (&b)[NF][2]) {
#pragma unroll
  for (int j = 0; j < NF; j += 2) {
    if (j >= nf) break;
    if (j + 1 < nf) {
      uint32_t r[4];
      ldmatrix_x4(r, b_ptr + j * 8 * b_pitch_bytes);
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    } else {
      ldmatrix_x2(b[j][0], b[j][1], b_ptr + j * 8 * b_pitch_bytes);
    }
  }
}

template <int NF>
__device__ __forceinline__ void dense_load(const unsigned char* a_ptr, const unsigned char* b_ptr,
                                           int b_pitch_bytes, int nf, Frags<NF>& f) {
  ldmatrix_x4(f.a, a_ptr);
  load_b(b_ptr, b_pitch_bytes, nf, f.b);
}

// bf16: ReLU (for a DilConv's raw window) on the loaded A fragment, run on
// the next step's fragments after this step's mmas are issued. fp32 ReLUs
// and splits inside dense_mma instead: holding split fragments for two
// steps ran slower (PERF.md §6).
template <typename T, bool RELU, int NF>
__device__ __forceinline__ void dense_prep(Frags<NF>& f) {
  if constexpr (sizeof(T) == 2 && RELU) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f.a[i] = relu_bf16x2(f.a[i]);
  }
}

// One step's products. fp32: 3xTF32 (A and B split into tf32 high and low
// halves), the two small terms into their own accumulators, which halves
// each chain of dependent mmas; the epilogues add the two at the end.
template <typename T, bool RELU, int NF>
__device__ __forceinline__ void dense_mma(const Frags<NF>& f, int nf, float (&acc)[NF][4],
                                          float (&acc_lo)[NF][4]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int j = 0; j < NF; ++j)
      if (j < nf) mma_bf16(acc[j], f.a, f.b[j][0], f.b[j][1]);
  } else {
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = __uint_as_float(f.a[i]);
      split_tf32(RELU ? fmaxf(x, 0.f) : x, ahi[i], alo[i]);
    }
#pragma unroll
    for (int j = 0; j < NF; ++j) {
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

// One warp's 16 x (8 nf) product over `ksteps` depth steps of 32 bytes:
// A rows from a_ptr (the lane's row), B from b_ptr (the lane's weight row)
// at pitch pb. The next step's fragments are loaded before this step's
// products, into the other of two register sets (no copies between them).
template <typename T, bool RELU, int NF>
__device__ __forceinline__ void warp_product(const unsigned char* ap, const unsigned char* bp, int pb,
                                             int nf, int ksteps, float (&acc)[NF][4],
                                             float (&acc_lo)[NF][4]) {
  if (nf <= 0) return;
  Frags<NF> f0, f1;
  dense_load(ap, bp, pb, nf, f0);
  dense_prep<T, RELU>(f0);
  for (int s = 0; s < ksteps; s += 2) {
    if (s + 1 < ksteps) dense_load(ap + (s + 1) * 32, bp + (s + 1) * 32, pb, nf, f1);
    dense_mma<T, RELU>(f0, nf, acc, acc_lo);
    if (s + 1 < ksteps) {
      dense_prep<T, RELU>(f1);
      if (s + 2 < ksteps) dense_load(ap + (s + 2) * 32, bp + (s + 2) * 32, pb, nf, f0);
      dense_mma<T, RELU>(f1, nf, acc, acc_lo);
      if (s + 2 < ksteps) dense_prep<T, RELU>(f0);
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

// rows x Cpad packed weights from global g into a stage at pitch pb, by cp.async
template <typename T>
__device__ __forceinline__ void stage_rows(const unsigned char* g, int rows, int cpad,
                                           unsigned char* d, int pb) {
  const int rb = cpad * sizeof(T);
  for_2d(rows, rb / 16, [&](int r, int j) { cp_async16(d + r * pb + j * 16, g + r * rb + j * 16, true); });
}

// A warp's place in a block's product: m-warp mw (tile pixels [16 mw,
// 16 mw + 16)) of mws, and the run of nf of the slice's n8 fragments from
// j0 that its group holds; g() and t() index the lane's accumulator rows
// and channel pair (worked out where the epilogues need them, so that they
// hold no registers through the products); pb is the mma layout's row
// pitch in bytes. a_row(win, ww,
// tw, M) is the lane's ldmatrix address for tile pixel p (rows past the
// tile's M pixels repeat the last one) in a window of ww-pixel rows whose
// origin is the tile's; b_off the lane's weight row and half. The tile's
// sizes stay in the kernel's parameters, not in registers.
struct WarpTile {
  int lane, mw, mws, j0, nf, pb;
  __device__ WarpTile(int M, int ns, int ng, int pb_) : pb(pb_) {
    mws = (M + 15) / 16;
    lane = threadIdx.x % 32;
    mw = (threadIdx.x / 32) % mws;
    const int group = threadIdx.x / 32 / mws, per = (ns / 8 + ng - 1) / ng;
    j0 = group * per;
    nf = max(0, min(per, ns / 8 - j0));
  }
  // a warp the caller places: m-warp mw, nf fragments from j0
  __device__ WarpTile(int mw_, int j0_, int nf_, int pb_, bool)
      : lane(threadIdx.x % 32), mw(mw_), mws(0), j0(j0_), nf(nf_), pb(pb_) {}
  __device__ int g() const { return lane / 4; }
  __device__ int t() const { return lane % 4; }
  __device__ const unsigned char* a_row(const unsigned char* win, int ww, int tw, int M) const {
    const int p = min(mw * 16 + (lane & 15), M - 1), pr = p / tw, pc = p % tw;
    return win + (size_t)(pr * ww + pc) * pb + (lane >> 4) * 16;
  }
  __device__ int b_off() const {
    return (j0 * 8 + (lane & 7) + ((lane >> 4) << 3)) * pb + ((lane >> 3) & 1) * 16;
  }
};

// The weight stream of the tap-GEMM routine: for tap = 0 .. taps - 1,
// tap t's ns packed weight rows (at g + t * tap_bytes) are copied into
// stage t & 1 of the two-stage buffer wst (rows at pitch pb) while the
// previous tap's products run, then product(t, stage) runs after a
// barrier. Every thread of the block calls it (it holds barriers), and it
// ends on a barrier. With `staged` the caller has issued tap 0's copies
// into stage 0 itself, so that they land while it works; copies the caller
// issued and did not commit land with tap 0's weights.
template <typename T, typename Product>
__device__ __forceinline__ void tap_stream(int taps, const unsigned char* g, size_t tap_bytes, int ns, int cpad,
                                           unsigned char* wst, int pb, bool staged, Product product) {
  auto load_tap = [&](int tap, int stage) {
    stage_rows<T>(g + tap * tap_bytes, ns, cpad, wst + (size_t)stage * ns * pb, pb);
  };
  if (!staged) load_tap(0, 0);
  cp_async_commit();
  for (int tap = 0; tap < taps; ++tap) {
    if (tap + 1 < taps) load_tap(tap + 1, (tap + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // the window and this tap's weights have landed
    __syncthreads();
    product(tap, wst + (size_t)((tap & 1) * ns) * pb);
    __syncthreads();  // the stage is refilled by the next iteration
  }
}

// The tap-GEMM routine of K3, K4 and K6: acc (+ acc_lo) += the sum over
// the k x k taps (ta, tb) at dilation dil of A B^T, A the lane's window
// row a_lane shifted by (ta dil, tb dil) pixels (rows of ww pixels), B the
// tap's ns packed weight rows streamed by tap_stream (a warp with nf = 0
// only copies).
template <typename T, bool RELU, int NF>
__device__ __forceinline__ void tap_gemm(const unsigned char* a_lane, int ww, int k, int dil,
                                         const unsigned char* g, size_t tap_bytes, int ns, int cpad,
                                         unsigned char* wst, const WarpTile& w, float (&acc)[NF][4],
                                         float (&acc_lo)[NF][4]) {
  const int ksteps = cpad * sizeof(T) / 32, b_off = w.b_off();
  tap_stream<T>(k * k, g, tap_bytes, ns, cpad, wst, w.pb, false, [&](int tap, const unsigned char* stage) {
    const int ta = tap / k, tb = tap % k;
    warp_product<T, RELU>(a_lane + (size_t)(ta * dil * ww + tb * dil) * w.pb, stage + b_off, w.pb, w.nf, ksteps,
                          acc, acc_lo);
  });
}

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

}  // namespace
