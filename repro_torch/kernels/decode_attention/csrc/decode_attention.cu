// Single-token GQA decode attention over a position-tracked KV cache.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::decode_attention
//   (Pallas body _decode_kernel), which the serve step runs once per layer
//   for every generated token.
//
// What bounds it on the H100 SXM (data sheet at its 700 W limit: 3.35 TB/s
//   of HBM, 67 TFLOP/s of f32 outside the tensor cores): memory.  One call
//   reads the whole cache, 2 * B * S * KV * D elements, and does
//   4 * B * H * S * D flops on them: G / 2 flops per byte in f32 (G = H / KV
//   query heads per KV head), far below that card's ridge of 20 f32 flops
//   per byte.  At the serving shapes (B=1, H=14, KV=2, D=64, S=256) the
//   f32 cache is 256 KiB per layer, some 80 ns of HBM time.
//
// What the design does about it: the Pallas kernel carries the online
//   softmax state (m, l, acc) across a sequential grid axis over S.  CUDA
//   blocks run in no order, so here one CTA owns one (batch, KV head) pair
//   and walks all of S itself, one tile of kTileS slots at a time.  Each K/V
//   tile is staged once in shared memory and serves all G query heads of
//   the group, so every cache element is read from device memory exactly
//   once.  Slots past S are masked, so any S works (the Pallas kernel needs
//   S % 128 == 0).  A query head with no valid slot returns 0, as the
//   model's masked_softmax does, not the mean of V.  What it does not do
//   yet: it runs only B * KV CTAs (2 at the serving shapes) and each walks
//   S alone, so the card is mostly idle and latency, not bandwidth, sets
//   its time; splitting S across CTAs with a combine pass is the next
//   design.
//
// Types: f32 or bf16 in and out (the dtype of q); all arithmetic in f32.
// Launch: grid (KV, B), kThreads threads, dynamic shared memory from
//   smem_bytes(); the C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileS = 64;

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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory in floats, in the order the kernel carves it.  K rows are
// padded to D + 1 so that threads reading one column of different rows hit
// different banks.
size_t smem_bytes(int G, int D) {
  size_t floats = (size_t)G * D            // q
                  + (size_t)kTileS * (D + 1)  // k tile
                  + (size_t)kTileS * D        // v tile
                  + (size_t)G * kTileS        // scores / probabilities
                  + (size_t)G * D             // acc
                  + 3 * (size_t)G;            // m, l, alpha
  return floats * sizeof(float) + kTileS * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ positions,
                        T* __restrict__ out, int S, int H, int KV, int D,
                        int pos, int window, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int DP = D + 1;

  extern __shared__ float smem[];
  float* q_s = smem;                       // [G, D]
  float* k_s = q_s + G * D;                // [kTileS, D + 1]
  float* v_s = k_s + kTileS * DP;          // [kTileS, D]
  float* p_s = v_s + kTileS * D;           // [G, kTileS]
  float* acc_s = p_s + G * kTileS;         // [G, D]
  float* m_s = acc_s + G * D;              // [G]
  float* l_s = m_s + G;                    // [G]
  float* alpha_s = l_s + G;                // [G]
  int* valid_s = reinterpret_cast<int*>(alpha_s + G);  // [kTileS]

  const size_t head0 = ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(q[head0 + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += kTileS) {
    const int n = min(kTileS, S - s0);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = tid; i < kTileS * D; i += kThreads) {
      const int s = i / D;
      const int d = i - s * D;
      float kx = 0.f, vx = 0.f;
      if (s < n) {
        const size_t off = (((size_t)b * S + s0 + s) * KV + kvh) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      k_s[s * DP + d] = kx;
      v_s[i] = vx;
    }
    for (int s = tid; s < kTileS; s += kThreads) {
      int ok = 0;
      if (s < n) {
        const int stored = positions[(size_t)b * S + s0 + s];
        ok = stored >= 0 && stored <= pos &&
             (window <= 0 || stored > pos - window);
      }
      valid_s[s] = ok;
    }
    __syncthreads();

    // scores[g, s] = scale * q[g] . k[s], -inf where the slot is not valid
    for (int i = tid; i < G * kTileS; i += kThreads) {
      const int g = i / kTileS;
      const int s = i - g * kTileS;
      float sc = -INFINITY;
      if (valid_s[s]) {
        const float* qg = q_s + g * D;
        const float* ks = k_s + s * DP;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qg[d], ks[d], dot);
        sc = dot * scale;
      }
      p_s[i] = sc;
    }
    __syncthreads();

    // online softmax, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* row = p_s + g * kTileS;
      float mt = -INFINITY;
      for (int s = lane; s < kTileS; s += 32) mt = fmaxf(mt, row[s]);
      mt = warp_max(mt);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mt);
      float sum = 0.f;
      float alpha = 1.f;
      if (m_new == -INFINITY) {          // nothing valid yet
        for (int s = lane; s < kTileS; s += 32) row[s] = 0.f;
      } else {
        alpha = expf(m_old - m_new);
        for (int s = lane; s < kTileS; s += 32) {
          const float p = expf(row[s] - m_new);
          row[s] = p;
          sum += p;
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g, d] = alpha[g] * acc[g, d] + sum_s p[g, s] * v[s, d]
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* row = p_s + g * kTileS;
      float a = acc_s[i] * alpha_s[g];
      for (int s = 0; s < n; ++s) a = fmaf(row[s], v_s[s * D + d], a);
      acc_s[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += kThreads) {
    const float l = l_s[i / D];
    out[head0 + i] = from_f32<T>(l > 0.f ? acc_s[i] / l : 0.f);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* positions, void* out, int B, int S, int H,
                   int KV, int D, int pos, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KV, D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale = 1.0f / sqrtf((float)D);
  decode_attention_kernel<T><<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(positions),
      static_cast<T*>(out), S, H, KV, D, pos, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out [B, H, D], k/v [B, S, KV, D],
// positions [B, S] int32, all contiguous on the current device.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* positions,
                                       void* out, int B, int S, int H, int KV,
                                       int D, int pos, int window, int dtype,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || D < 1)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)launch<float>(q, k, v, positions, out, B, S, H, KV, D, pos,
                                window, st);
    case 1:
      return (int)launch<__nv_bfloat16>(q, k, v, positions, out, B, S, H, KV,
                                        D, pos, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
