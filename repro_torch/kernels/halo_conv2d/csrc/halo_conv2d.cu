// One 3x3 VALID convolution + leaky-ReLU over a batch of halo-padded NHWC
// tiles, as a tensor-core implicit GEMM: one layer of the paper's
// halo-partitioned YoloV2 conv block.
//
// Replaces: src/repro/kernels/halo_conv2d/kernel.py::halo_conv_block_tiles
//   (Pallas body _halo_block_kernel with _conv3x3_tile).  The wrapper
//   (ops.py::halo_conv_block_tiles) launches this kernel once per layer of
//   the block; each layer's output tile is one ring smaller than its input,
//   exactly the paper's shrinking expansion border.
//
// What bounds it on the H100 SXM (data sheet at its 700 W limit: 3.35 TB/s
//   of HBM, 989 TFLOP/s bf16 in the tensor cores, 67 TFLOP/s of f32
//   outside them): operations.  A layer does 2 * 9 * Cin * Cout flops per
//   output pixel and reads each input pixel's Cin values once: at YoloV2's
//   widths (Cin = Cout = 128 to 512) that is over 500 flops per byte.
//
// What the design does about it:
//   - GEMM view per layer: M = tiles x Hout x Wout output pixels (flattened
//     row-major across each tile and across tiles, so only the last M tile
//     of a layer overhangs), N = Cout, K = 9 x Cin.  The weights
//     [3, 3, Cin, Cout] are already the row-major K x N matrix; A's row for
//     pixel (t, oh, ow) and tap (di, dj) is the contiguous run of Cin values
//     at (t, oh + di, ow + dj) of the input tile, so no im2col is written.
//   - Tensor cores: mma.sync.m16n8k16 bf16 x bf16 -> f32, fragments by
//     ldmatrix from XOR-swizzled shared memory (conflict-free).  wgmma
//     (m64nNk16 from descriptors) is the route to the card's full rate and
//     is the next design; this one keeps one 32 x 32 warp tile and two CTA
//     tiles (64x64, 32x64): the wrapper takes the larger one where it
//     still gives at least two CTAs per SM (64x128 tiles, one CTA per SM
//     at 128 registers, measured 1.3x slower at 104x104x128).
//   - f32 accuracy from bf16 tensor cores by split operands: an f32 value x
//     is stored as three bf16 planes hi = bf16(x), mid = bf16(x - hi),
//     lo = bf16(x - hi - mid), which hold it exactly, and bf16 x bf16
//     products are exact in f32.  Passes per K slice, in this fixed order:
//     bf16 x bf16 one (0,0); three planes x bf16 three (0,0) (1,0) (2,0);
//     three x three six (0,0) (0,1) (1,0) (0,2) (1,1) (2,0): the dropped
//     mid.lo, lo.mid, lo.lo terms are about 2^-24 of each product.  An f32
//     layer input arrives as planes: the wrapper splits the first layer's
//     input and f32 weights with halo_split_launch below, and a layer
//     whose output feeds another writes its f32 result straight as the
//     three planes the next layer reads.
//   - Loads: a ring of 3 shared-memory stages filled by 16-byte cp.async
//     (cg, L2 only), so the next K slice arrives while this one is
//     multiplied.  Every plane's channel stride is a multiple of 8 (the
//     wrapper pads ragged channel counts with zeros when it splits), so
//     every row is whole 16-byte units; units past the data (rows past M,
//     channels past the stride, K rows past Cin) are zero-filled
//     (cp.async src-size 0).
//   - Summation: the tensor cores add into their f32 accumulator with
//     truncation, so one accumulator over the whole K walk (432 products a
//     layer in f32 at Cin = 128) drifts by about 2e-5 of |y|, twice the f32
//     tolerance.  Each K slice's products therefore start from a zero
//     accumulator, and the slice's sum is added to the running f32 sum
//     with one rounded FADD.
//   - Exact tiling invariance: every output element sums its terms in one
//     K walk that depends only on Cin and the plane counts (tap, then
//     32-channel chunk, then the two k16 halves, then the passes), never on
//     M, the tile, the CTA tile or the position, and the tensor cores sum a
//     k16 slice the same way at every (m, n); so a halo pixel recomputed by
//     a neighbouring tile gets the same bits.  No split-K.
//   - Epilogue: leaky-ReLU in f32, then pairs of adjacent channels stored
//     as one 8-byte (f32) or 4-byte (bf16, planes) store.
//   What it does not do yet: wgmma, TMA, a persistent grid, and the block's
//   layers fused in one launch (the f32 intermediate passes through L2).
//
// Types: A and B are bf16 planes (1 or 3); the output is f32, bf16, or the
//   three bf16 planes of an f32 result.  Launch: grid (M tiles, N tiles),
//   BM * BN / 32 threads, 3 stages of dynamic shared memory; the C entry
//   points return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32;                // K slice: 32 input channels, one tap
constexpr int kAUnits = kBK / 8;       // 16-byte units in a slice of an A row
constexpr int kStages = 3;

// The CTA tiles, by the code the wrapper passes (ops.py TILES).
constexpr int kTileM[2] = {64, 32};
constexpr int kTileN[2] = {64, 64};

// Split pass q of three planes x three: (A piece, B piece).  With one B
// plane the passes are (q, 0).  Same list as ops.py PASSES.
__host__ __device__ constexpr int pass_a(int b_planes, int q) {
  return b_planes == 1 ? q : (q == 2 || q == 4) ? 1 : q == 5 ? 2 : 0;
}
__host__ __device__ constexpr int pass_b(int b_planes, int q) {
  return b_planes == 1 ? 0 : (q == 1 || q == 4) ? 1 : q == 3 ? 2 : 0;
}
__host__ __device__ constexpr int n_passes(int a_planes, int b_planes) {
  return a_planes == 1 ? 1 : b_planes == 1 ? 3 : 6;
}

struct Params {
  const __nv_bfloat16* a;    // [a_planes][tiles * Hin * Win][a_cstride]
  long long a_plane;
  int a_cstride;
  const __nv_bfloat16* b;    // [b_planes][9 * Cin][b_cstride]
  long long b_plane;
  int b_cstride;
  void* y;                   // mode 0 f32 / 1 bf16: [M][Cout];
  int y_mode;                // mode 2: 3 bf16 planes [3][M][y_cstride]
  long long y_plane;
  int y_cstride;
  int Hin, Win, Cin, Cout, M;
  float leaky;
};

__device__ __forceinline__ void split3(float x, __nv_bfloat16& hi,
                                       __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float leaky_relu(float v, float s) {
  return v >= 0.f ? v : s * v;
}

// Shared memory of one stage: PA planes of A [BM][32] (64-byte rows, their
// four 16-byte units XOR-swizzled by (row >> 1) & 3), then PB planes of B
// [32][BN] (units swizzled by k & 7).  Both make every ldmatrix phase hit
// eight distinct 16-byte bank groups.
template <int BM, int BN, int PA, int PB>
struct Tile {
  static constexpr int kThreads = BM * BN / 32;   // one warp per 32 x 32
  static constexpr int kWarpsM = BM / 32;
  static constexpr int kABytes = BM * kBK * 2;
  static constexpr int kBBytes = kBK * BN * 2;
  static constexpr int kStageBytes = PA * kABytes + PB * kBBytes;
  static constexpr int kSmem = kStages * kStageBytes;
  static constexpr int kAIters = BM * kAUnits / kThreads;
  static constexpr int kBIters = kBK * BN / 8 / kThreads;
  static_assert(kAIters >= 1 && kBIters >= 1, "tile too small");
};

__device__ __forceinline__ uint32_t a_off(int row, int unit) {
  return row * (kBK * 2) + ((unit ^ ((row >> 1) & 3)) << 4);
}
template <int BN>
__device__ __forceinline__ uint32_t b_off(int k, int unit) {
  return k * BN * 2 + ((unit ^ (k & 7)) << 4);
}

template <int BM, int BN, int PA, int PB>
__global__ void __launch_bounds__(Tile<BM, BN, PA, PB>::kThreads)
conv3x3_mma_kernel(const Params p) {
  using T = Tile<BM, BN, PA, PB>;
  constexpr int kPasses = n_passes(PA, PB);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % T::kWarpsM;
  const int wn = warp / T::kWarpsM;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int Wout = p.Win - 2;
  const int hw = (p.Hin - 2) * Wout;

  // The input pixel of tap (0, 0) for each A row this thread loads (-1
  // past M).
  int a_pix[T::kAIters];
#pragma unroll
  for (int j = 0; j < T::kAIters; ++j) {
    const int m = m0 + (tid + j * T::kThreads) / kAUnits;
    a_pix[j] = -1;
    if (m < p.M) {
      const int t = m / hw;
      const int rem = m - t * hw;
      const int oh = rem / Wout;
      a_pix[j] = (t * p.Hin + oh) * p.Win + (rem - oh * Wout);
    }
  }

  const int n_chunks = (p.Cin + kBK - 1) / kBK;
  const int num_k = 9 * n_chunks;

  auto load = [&](int kt, int stage) {
    const int tap = kt / n_chunks;
    const int c0 = (kt - tap * n_chunks) * kBK;
    const int di = tap / 3;
    const int shift = di * p.Win + (tap - 3 * di);
    const uint32_t sa = s0 + stage * T::kStageBytes;
    const uint32_t sb = sa + PA * T::kABytes;
#pragma unroll
    for (int j = 0; j < T::kAIters; ++j) {
      const int idx = tid + j * T::kThreads;
      const int r = idx / kAUnits;
      const int u = idx % kAUnits;
      const int ch = c0 + u * 8;
      const bool ok = a_pix[j] >= 0 && ch < p.a_cstride;
      const __nv_bfloat16* src =
          p.a + (ok ? (long long)(a_pix[j] + shift) * p.a_cstride + ch : 0);
#pragma unroll
      for (int pl = 0; pl < PA; ++pl)
        cp_async16(sa + pl * T::kABytes + a_off(r, u), src + pl * p.a_plane,
                   ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < T::kBIters; ++j) {
      const int idx = tid + j * T::kThreads;
      const int kr = idx / (BN / 8);
      const int u = idx % (BN / 8);
      const int k = c0 + kr;
      const int n = n0 + u * 8;
      const bool ok = k < p.Cin && n < p.b_cstride;
      const __nv_bfloat16* src =
          p.b + (ok ? (long long)(tap * p.Cin + k) * p.b_cstride + n : 0);
#pragma unroll
      for (int pl = 0; pl < PB; ++pl)
        cp_async16(sb + pl * T::kBBytes + b_off<BN>(kr, u),
                   src + pl * p.b_plane, ok ? 16 : 0);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < num_k) load(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < num_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt landed; slice kt - 1 fully consumed
    if (kt + kStages - 1 < num_k)
      load(kt + kStages - 1, (kt + kStages - 1) % kStages);
    cp_async_commit();

    const uint32_t sa = s0 + (kt % kStages) * T::kStageBytes;
    const uint32_t sb = sa + PA * T::kABytes;
    float part[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[PA][2][4];
      uint32_t bfr[PB][4][2];
#pragma unroll
      for (int pl = 0; pl < PA; ++pl)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(af[pl][mi],
                      sa + pl * T::kABytes +
                          a_off(wm * 32 + mi * 16 + (lane & 15),
                                kk * 2 + (lane >> 4)));
#pragma unroll
      for (int pl = 0; pl < PB; ++pl)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, sb + pl * T::kBBytes +
                                   b_off<BN>(kk * 16 + (lane & 15),
                                             wn * 4 + nj * 2 + (lane >> 4)));
          bfr[pl][2 * nj][0] = r[0];
          bfr[pl][2 * nj][1] = r[1];
          bfr[pl][2 * nj + 1][0] = r[2];
          bfr[pl][2 * nj + 1][1] = r[3];
        }
#pragma unroll
      for (int q = 0; q < kPasses; ++q)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(part[mi][ni], af[pass_a(PB, q)][mi],
                     bfr[pass_b(PB, q)][ni][0], bfr[pass_b(PB, q)][ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
  }
  cp_async_wait<0>();

  // Epilogue: element (row lane / 4 (+8), columns 2 (lane % 4) + {0, 1})
  // of each 16 x 8 accumulator.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + mi * 16 + (lane >> 2) + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
        const float v0 = leaky_relu(acc[mi][ni][2 * h], p.leaky);
        const float v1 = leaky_relu(acc[mi][ni][2 * h + 1], p.leaky);
        if (p.y_mode == 2) {          // three planes; the stride is even
          if (n >= p.y_cstride) continue;
          __nv_bfloat16 h0, m0_, l0, h1, m1, l1;
          split3(v0, h0, m0_, l0);
          split3(v1, h1, m1, l1);
          __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(p.y) + (long long)m * p.y_cstride +
              n);
          const long long ps = p.y_plane / 2;
          y[0] = __halves2bfloat162(h0, h1);
          y[ps] = __halves2bfloat162(m0_, m1);
          y[2 * ps] = __halves2bfloat162(l0, l1);
        } else if (p.y_mode == 0) {
          float* y = static_cast<float*>(p.y) + (long long)m * p.Cout + n;
          if (n + 1 < p.Cout && !(p.Cout & 1)) {
            *reinterpret_cast<float2*>(y) = make_float2(v0, v1);
          } else {
            if (n < p.Cout) y[0] = v0;
            if (n + 1 < p.Cout) y[1] = v1;
          }
        } else {
          __nv_bfloat16* y =
              static_cast<__nv_bfloat16*>(p.y) + (long long)m * p.Cout + n;
          if (n + 1 < p.Cout && !(p.Cout & 1)) {
            *reinterpret_cast<__nv_bfloat162*>(y) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (n < p.Cout) y[0] = __float2bfloat16_rn(v0);
            if (n + 1 < p.Cout) y[1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
}

template <int BM, int BN, int PA, int PB>
cudaError_t launch(const Params& p, cudaStream_t st) {
  using T = Tile<BM, BN, PA, PB>;
  auto kern = conv3x3_mma_kernel<BM, BN, PA, PB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + BM - 1) / BM, (p.Cout + BN - 1) / BN);
  kern<<<grid, T::kThreads, T::kSmem, st>>>(p);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_planes(int pa, int pb, const Params& p, cudaStream_t st) {
  if (pa == 1 && pb == 1) return launch<BM, BN, 1, 1>(p, st);
  if (pa == 3 && pb == 1) return launch<BM, BN, 3, 1>(p, st);
  if (pa == 3 && pb == 3) return launch<BM, BN, 3, 3>(p, st);
  return cudaErrorInvalidValue;
}

int smem_bytes(int pa, int pb, int cfg) {
  if (cfg < 0 || cfg > 1 || !((pa == 1 && pb == 1) || (pa == 3 && pb == 1) ||
                              (pa == 3 && pb == 3)))
    return -1;
  return kStages * (pa * kTileM[cfg] + pb * kTileN[cfg]) * kBK * 2;
}

template <typename TIn>
__global__ void split_kernel(const TIn* __restrict__ src,
                             __nv_bfloat16* __restrict__ dst, long long rows,
                             int cols, int cols_pad, int planes) {
  const long long total = rows * cols_pad;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / cols_pad;
    const int c = (int)(i - r * cols_pad);
    float v = 0.f;
    if (c < cols) {
      if constexpr (sizeof(TIn) == 4)
        v = src[r * cols + c];
      else
        v = __bfloat162float(src[r * cols + c]);
    }
    if (planes == 1) {
      dst[i] = __float2bfloat16_rn(v);
    } else {
      __nv_bfloat16 hi, mid, lo;
      split3(v, hi, mid, lo);
      dst[i] = hi;
      dst[total + i] = mid;
      dst[2 * total + i] = lo;
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// Dynamic shared memory a CTA of tile code cfg takes with pa x pb planes
// (-1 for a combination the kernel does not take).
extern "C" int halo_conv3x3_smem_bytes(int a_planes, int b_planes, int cfg) {
  return smem_bytes(a_planes, b_planes, cfg);
}

// One layer.  a: a_planes bf16 planes [tiles * Hin * Win][a_cstride], plane
// stride a_plane elements; b: b_planes bf16 planes [9 * Cin][b_cstride];
// y: y_mode 0 f32 / 1 bf16 [tiles * (Hin-2) * (Win-2)][Cout], or 2: three
// bf16 planes [.][y_cstride] of the f32 result, plane stride y_plane.
// Channel strides are multiples of 8 with zeros past Cin / Cout; pointers
// 16-byte aligned; all on the current device.  cfg picks the CTA tile.
extern "C" int halo_conv3x3_launch(
    const void* a, long long a_plane, int a_planes, int a_cstride,
    const void* b, long long b_plane, int b_planes, int b_cstride, void* y,
    int y_mode, long long y_plane, int y_cstride, int tiles, int Hin,
    int Win, int Cin, int Cout, float leaky, int cfg, void* stream) {
  const long long m = (long long)tiles * (Hin - 2) * (Win - 2);
  if (tiles < 1 || Hin < 3 || Win < 3 || Cin < 1 || Cout < 1 ||
      (long long)tiles * Hin * Win >= (1LL << 31) ||
      a_cstride < Cin || a_cstride % 8 || b_cstride < Cout ||
      b_cstride % 8 || a_plane % 8 || b_plane % 8 || !aligned16(a) ||
      !aligned16(b) || y_mode < 0 || y_mode > 2 ||
      (y_mode == 2 && (y_cstride < Cout || y_cstride % 8 || y_plane % 8 ||
                       !aligned16(y))) ||
      smem_bytes(a_planes, b_planes, cfg) < 0 ||
      (Cout + kTileN[cfg] - 1) / kTileN[cfg] > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const __nv_bfloat16*>(a), a_plane, a_cstride,
           static_cast<const __nv_bfloat16*>(b), b_plane, b_cstride,
           y, y_mode, y_plane, y_cstride, Hin, Win, Cin, Cout, (int)m, leaky};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cfg == 0) return (int)launch_planes<64, 64>(a_planes, b_planes, p, st);
  return (int)launch_planes<32, 64>(a_planes, b_planes, p, st);
}

// src [rows][cols] (0 = f32, 1 = bf16) -> planes bf16 planes
// [planes][rows][cols_pad], zeros past cols: three pieces of an f32 source
// (hi, mid, lo), or one bf16 copy.
extern "C" int halo_split_launch(const void* src, int src_dtype, void* dst,
                                 long long rows, int cols, int cols_pad,
                                 int planes, void* stream) {
  if (rows < 1 || cols < 1 || cols_pad < cols ||
      !(planes == 1 || planes == 3) || src_dtype < 0 || src_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = rows * cols_pad;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads < 132 * 16
                               ? (total + threads - 1) / threads
                               : 132 * 16);
  auto* out = static_cast<__nv_bfloat16*>(dst);
  if (src_dtype == 0)
    split_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(src), out, rows, cols, cols_pad, planes);
  else
    split_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(src), out, rows, cols, cols_pad,
        planes);
  return (int)cudaGetLastError();
}
