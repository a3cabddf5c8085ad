// Blocked online-softmax (flash) attention for prefill, GQA-native.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention
//   (Pallas body _flash_kernel).  The JAX model computes the same function
//   with einsums (models/layers/attention.py, full-sequence branch); the
//   port's prefill runs it once per layer for every prompt.
//
// What bounds it on the H100 SXM (data sheet at its 700 W limit: 3.35 TB/s
//   of HBM, 67 TFLOP/s of f32 outside the tensor cores): memory at the
//   serving shapes.  A prompt of T = 16 tokens at H = 14, KV = 2, D = 64
//   moves about 130 KB and does about 0.5 Mflop of causal attention per
//   layer, some 4 flops per byte, below that card's f32 ridge of 20; only
//   prompts of thousands of tokens would be bound by operations (and would
//   then want wgmma, a later change).
//
// What the design does about it: one CTA per (query tile of kBQ rows,
//   query head, batch) stages its Q tile once in shared memory and walks
//   the K/V rows in tiles of kBK, carrying the online-softmax state
//   (m, l, acc) in shared memory, so the T x S score matrix never reaches
//   device memory.  It reads the model's layouts directly, q/out [B, T, H, D]
//   and k/v [B, S, KV, D], so no transpose pass runs before or after it, and
//   query head h reads KV head h / (H / KV), so K/V are never repeated per
//   query head in memory (the Pallas kernel needs equal head counts).
//   Ragged T and S are masked instead of asserted.  The mask comes from
//   absolute positions (q_pos [T], k_pos [S]): causal, causal with a
//   sliding window, or none.  A row with no valid key returns 0, as the
//   model's masked_softmax does.
//
// Types: f32 or bf16 in and out (the dtype of q); all arithmetic in f32.
// Launch: grid (ceil(T / kBQ), H, B), kThreads threads, dynamic shared
//   memory from smem_bytes(); the C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 32;
constexpr int kBK = 32;   // one key per lane in the softmax pass

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

// K rows are padded to D + 1 so that threads reading one column of
// different rows hit different banks.
size_t smem_bytes(int D) {
  size_t floats = (size_t)kBQ * D            // q tile
                  + (size_t)kBK * (D + 1)    // k tile
                  + (size_t)kBK * D          // v tile
                  + (size_t)kBQ * kBK        // scores / probabilities
                  + (size_t)kBQ * D          // acc
                  + 3 * (size_t)kBQ;         // m, l, alpha
  return floats * sizeof(float) + (kBQ + kBK) * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos, T* __restrict__ out,
                       int T_, int S, int H, int KV, int D, int causal,
                       int window, float scale) {
  const int t0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int DP = D + 1;
  const int nq = min(kBQ, T_ - t0);

  extern __shared__ float smem[];
  float* q_s = smem;                       // [kBQ, D]
  float* k_s = q_s + kBQ * D;              // [kBK, D + 1]
  float* v_s = k_s + kBK * DP;             // [kBK, D]
  float* p_s = v_s + kBK * D;              // [kBQ, kBK]
  float* acc_s = p_s + kBQ * kBK;          // [kBQ, D]
  float* m_s = acc_s + kBQ * D;            // [kBQ]
  float* l_s = m_s + kBQ;                  // [kBQ]
  float* alpha_s = l_s + kBQ;              // [kBQ]
  int* qp_s = reinterpret_cast<int*>(alpha_s + kBQ);  // [kBQ]
  int* kp_s = qp_s + kBQ;                              // [kBK]

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    float x = 0.f;
    if (r < nq) x = to_f32(q[(((size_t)b * T_ + t0 + r) * H + h) * D + d]);
    q_s[i] = x;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    qp_s[r] = r < nq ? q_pos[t0 + r] : 0;
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += kBK) {
    const int n = min(kBK, S - s0);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
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
    for (int s = tid; s < kBK; s += kThreads) kp_s[s] = s < n ? k_pos[s0 + s] : 0;
    __syncthreads();

    // scores[r, c] = scale * q[r] . k[c], -inf where masked
    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK;
      const int c = i - r * kBK;
      bool ok = c < n;
      if (causal) {
        const int qp = qp_s[r];
        const int kp = kp_s[c];
        ok = ok && kp <= qp && (window <= 0 || kp > qp - window);
      }
      float sc = -INFINITY;
      if (ok) {
        const float* qr = q_s + r * D;
        const float* kc = k_s + c * DP;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kc[d], dot);
        sc = dot * scale;
      }
      p_s[i] = sc;
    }
    __syncthreads();

    // online softmax, one warp per query row, one key per lane
    for (int r = warp; r < kBQ; r += kWarps) {
      float* row = p_s + r * kBK;
      const float sc = row[lane];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(sc));
      float p = 0.f;
      float alpha = 1.f;
      if (m_new != -INFINITY) {          // else nothing valid yet
        alpha = expf(m_old - m_new);
        p = expf(sc - m_new);
      }
      row[lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc[r, d] = alpha[r] * acc[r, d] + sum_c p[r, c] * v[c, d]
    for (int i = tid; i < kBQ * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      const float* row = p_s + r * kBK;
      float a = acc_s[i] * alpha_s[r];
      for (int c = 0; c < n; ++c) a = fmaf(row[c], v_s[c * D + d], a);
      acc_s[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < nq * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const float l = l_s[r];
    out[(((size_t)b * T_ + t0 + r) * H + h) * D + d] =
        from_f32<T>(l > 0.f ? acc_s[i] / l : 0.f);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_pos, const void* k_pos, void* out, int B,
                   int T_, int S, int H, int KV, int D, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale = 1.0f / sqrtf((float)D);
  const dim3 grid((T_ + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<T*>(out), T_, S, H, KV, D,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out [B, T, H, D], k/v [B, S, KV, D],
// q_pos [T] and k_pos [S] int32, all contiguous on the current device.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* q_pos,
                                      const void* k_pos, void* out, int B,
                                      int T, int S, int H, int KV, int D,
                                      int causal, int window, int dtype,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || S < 1 || KV < 1 || H % KV != 0 || D < 1)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)launch<float>(q, k, v, q_pos, k_pos, out, B, T, S, H, KV,
                                D, causal, window, st);
    case 1:
      return (int)launch<__nv_bfloat16>(q, k, v, q_pos, k_pos, out, B, T, S,
                                        H, KV, D, causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
