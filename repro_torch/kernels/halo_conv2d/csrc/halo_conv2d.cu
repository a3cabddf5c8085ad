// One 3x3 VALID convolution + leaky-ReLU over a batch of halo-padded NHWC
// tiles: one layer of the paper's halo-partitioned YoloV2 conv block.
//
// Replaces: src/repro/kernels/halo_conv2d/kernel.py::halo_conv_block_tiles
//   (Pallas body _halo_block_kernel with _conv3x3_tile).  The wrapper
//   (ops.py::halo_conv_block_tiles) launches this kernel once per layer of
//   the block; each layer's output tile is one ring smaller than its input,
//   exactly the paper's shrinking expansion border.
//
// What bounds it on the H100 SXM (data sheet at its 700 W limit: 3.35 TB/s
//   of HBM, 67 TFLOP/s of f32 outside the tensor cores, 989 TFLOP/s bf16 in
//   them): operations.  A layer does 2 * 9 * Cin * Cout flops per output
//   pixel and reads each input pixel's Cin values once: at YoloV2's widths
//   (Cin = Cout = 128 to 512) that is over 500 flops per byte, far above the
//   card's ridge.
//
// What the design does about it: the Pallas kernel holds a whole padded
//   tile in VMEM and runs the block's layers back to back; at YoloV2's
//   widths one tile (56 x 56 x 128 f32 = 1.6 MB for the 104 x 104 x 128
//   layer split 2 x 2) is far above the 227 KB of shared memory an SM has.
//   Here each CTA computes an 8 x 16 block of output pixels for 64 output
//   channels of one tile, staging the 10 x 18 input window and the 3 x 3
//   weights of one 16-channel chunk of Cin at a time in shared memory.
//   Each of the 256 threads keeps 8 pixels x 4 channels of f32 sums in
//   registers.  Intermediate layers go through a global f32 scratch buffer
//   between launches.  Every output element sums its terms in one fixed
//   order (Cin chunk, then channel, then tap), whatever its position in the
//   block or the tile, so a halo pixel recomputed by a neighbouring tile
//   gets the same bits and the block's result does not depend on the
//   tiling.  What it does not do yet: its products run on CUDA cores in
//   f32; the taps as tensor-core products (wgmma over im2col tiles) are the
//   next design.
//
// Types: input, weights and output each f32 or bf16 (any mix: the wrapper
//   passes the tiles' dtype for the first layer's input and the last
//   layer's output, f32 between layers); all sums in f32.  Launch: grid
//   (blocks of 8 x 16 output pixels, blocks of 64 output channels, tiles),
//   256 threads, static shared memory; the C entry point returns
//   cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBH = 8;                 // output rows per CTA
constexpr int kBW = 16;                // output columns per CTA
constexpr int kBC = 64;                // output channels per CTA
constexpr int kCK = 16;                // input channels per staged chunk
constexpr int kThreads = 256;
constexpr int kLanes = 16;             // channel lanes: co = lane + 16 * u
constexpr int kCPT = kBC / kLanes;     // 4 channels per thread
constexpr int kInH = kBH + 2;
constexpr int kInW = kBW + 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename TIn, typename TW, typename TOut>
__global__ void __launch_bounds__(kThreads)
conv3x3_leaky_kernel(const TIn* __restrict__ x, const TW* __restrict__ w,
                     TOut* __restrict__ y, int Hin, int Win, int Cin,
                     int Cout, float leaky) {
  const int Hout = Hin - 2;
  const int Wout = Win - 2;
  const int blocks_w = (Wout + kBW - 1) / kBW;
  const int oh0 = (blockIdx.x / blocks_w) * kBH;
  const int ow0 = (blockIdx.x % blocks_w) * kBW;
  const int co0 = blockIdx.y * kBC;
  const int tile = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;       // output channels lane + 16 * u
  const int col = tid / kLanes;        // output column ow0 + col, rows 0..7

  __shared__ float x_s[kInH * kInW * kCK];   // [row][col][ci]
  __shared__ float w_s[9 * kCK * kBC];       // [tap][ci][co]

  const TIn* xt = x + (size_t)tile * Hin * Win * Cin;
  float acc[kBH][kCPT];
#pragma unroll
  for (int k = 0; k < kBH; ++k)
#pragma unroll
    for (int u = 0; u < kCPT; ++u) acc[k][u] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kCK) {
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = tid; i < kInH * kInW * kCK; i += kThreads) {
      const int ci = i % kCK;
      const int pix = i / kCK;
      const int ih = oh0 + pix / kInW;
      const int iw = ow0 + pix % kInW;
      float v = 0.f;
      if (ih < Hin && iw < Win && c0 + ci < Cin)
        v = to_f32(xt[((size_t)ih * Win + iw) * Cin + c0 + ci]);
      x_s[i] = v;
    }
    for (int i = tid; i < 9 * kCK * kBC; i += kThreads) {
      const int co = i % kBC;
      const int ci = (i / kBC) % kCK;
      const int tap = i / (kBC * kCK);
      float v = 0.f;
      if (c0 + ci < Cin && co0 + co < Cout)
        v = to_f32(w[((size_t)tap * Cin + c0 + ci) * Cout + co0 + co]);
      w_s[i] = v;
    }
    __syncthreads();

    for (int ci = 0; ci < kCK; ++ci) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int di = tap / 3;
        const int dj = tap % 3;
        float wv[kCPT];
#pragma unroll
        for (int u = 0; u < kCPT; ++u)
          wv[u] = w_s[(tap * kCK + ci) * kBC + lane + kLanes * u];
#pragma unroll
        for (int k = 0; k < kBH; ++k) {
          const float xv = x_s[((k + di) * kInW + col + dj) * kCK + ci];
#pragma unroll
          for (int u = 0; u < kCPT; ++u) acc[k][u] = fmaf(xv, wv[u], acc[k][u]);
        }
      }
    }
  }

  TOut* yt = y + (size_t)tile * Hout * Wout * Cout;
  const int ow = ow0 + col;
#pragma unroll
  for (int k = 0; k < kBH; ++k) {
    const int oh = oh0 + k;
    if (oh >= Hout || ow >= Wout) continue;
#pragma unroll
    for (int u = 0; u < kCPT; ++u) {
      const int co = co0 + lane + kLanes * u;
      if (co < Cout) {
        const float v = acc[k][u];
        yt[((size_t)oh * Wout + ow) * Cout + co] =
            from_f32<TOut>(v >= 0.f ? v : leaky * v);
      }
    }
  }
}

template <typename TIn, typename TW, typename TOut>
cudaError_t launch(const void* x, const void* w, void* y, int tiles,
                   int Hin, int Win, int Cin, int Cout, float leaky,
                   cudaStream_t stream) {
  const int Hout = Hin - 2;
  const int Wout = Win - 2;
  const dim3 grid(((Hout + kBH - 1) / kBH) * ((Wout + kBW - 1) / kBW),
                  (Cout + kBC - 1) / kBC, tiles);
  conv3x3_leaky_kernel<TIn, TW, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<const TW*>(w),
      static_cast<TOut*>(y), Hin, Win, Cin, Cout, leaky);
  return cudaGetLastError();
}

template <typename TIn, typename TW>
cudaError_t launch_out(int out_dtype, const void* x, const void* w, void* y,
                       int tiles, int Hin, int Win, int Cin, int Cout,
                       float leaky, cudaStream_t st) {
  switch (out_dtype) {
    case 0:
      return launch<TIn, TW, float>(x, w, y, tiles, Hin, Win, Cin, Cout,
                                    leaky, st);
    case 1:
      return launch<TIn, TW, __nv_bfloat16>(x, w, y, tiles, Hin, Win, Cin,
                                            Cout, leaky, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TIn>
cudaError_t launch_w(int w_dtype, int out_dtype, const void* x,
                     const void* w, void* y, int tiles, int Hin, int Win,
                     int Cin, int Cout, float leaky, cudaStream_t st) {
  switch (w_dtype) {
    case 0:
      return launch_out<TIn, float>(out_dtype, x, w, y, tiles, Hin, Win,
                                    Cin, Cout, leaky, st);
    case 1:
      return launch_out<TIn, __nv_bfloat16>(out_dtype, x, w, y, tiles, Hin,
                                            Win, Cin, Cout, leaky, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16.  x [tiles, Hin, Win, Cin],
// w [3, 3, Cin, Cout], y [tiles, Hin - 2, Win - 2, Cout]; all contiguous
// on the current device.
extern "C" int halo_conv3x3_launch(const void* x, const void* w, void* y,
                                   int tiles, int Hin, int Win, int Cin,
                                   int Cout, float leaky, int x_dtype,
                                   int w_dtype, int y_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tiles < 1 || Hin < 3 || Win < 3 || Cin < 1 || Cout < 1 ||
      tiles > 65535)
    return (int)cudaErrorInvalidValue;
  switch (x_dtype) {
    case 0:
      return (int)launch_w<float>(w_dtype, y_dtype, x, w, y, tiles, Hin, Win,
                                  Cin, Cout, leaky, st);
    case 1:
      return (int)launch_w<__nv_bfloat16>(w_dtype, y_dtype, x, w, y, tiles,
                                          Hin, Win, Cin, Cout, leaky, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
