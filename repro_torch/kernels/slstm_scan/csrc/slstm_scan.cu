// sLSTM recurrence with exponential gating over T steps.
//
// Replaces: src/repro/kernels/slstm_scan/kernel.py::slstm_scan (Pallas body
//   _slstm_kernel), which xLSTM's sLSTM layers run over their gate
//   pre-activations: once over the prompt in prefill, one step per decode
//   token.
//
// Per step t and head, with f32 accumulation:
//   pre = wx_t + h_{t-1} R + b                     (gates i, f, z, o)
//   logf = log_sigmoid(f_pre) = -softplus(-f_pre)
//   m_t = max(logf + m, i_pre); i' = exp(i_pre - m_t); f' = exp(logf + m - m_t)
//   c_t = f' c + i' tanh(z);  n_t = max(f' n + i', 1e-6);  h_t = sigmoid(o) c_t / n_t
// The carry starts from a given (h, c, n, m) or from (0, 0, 1, 0), as the
// Pallas kernel does, and the state after step T-1 is written out: no
// padded steps are run, so the returned state is the real one.
//
// What bounds it on the H100 SXM (data sheet at its 700 W limit: 3.35 TB/s
//   of HBM, 67 TFLOP/s of f32 outside the tensor cores): memory.  One call
//   must read R once, 4 * H * dh * dh elements (16.8 MB in f32 at xLSTM-1.3B's
//   H=4, dh=512), plus wx and hs: about 5 us of HBM time, against 2 * B * T *
//   4 * H * dh * dh flops (0.13 GFLOP at B=1, T=16; 2 us).
//
// What the design does about it: the Pallas kernel keeps R resident in VMEM
//   (4.19 MB per head), far above the 227 KB of shared memory an SM has, and
//   carries the state across a sequential grid axis that CUDA does not have.
//   Here one CTA per (head, batch row) owns the whole time loop and streams
//   its head's R slice from global memory every step; after the first step
//   it comes from L2 (one layer's R is 16.8 MB of the 50 MB L2).  Each step
//   needs the whole h_{t-1} of the head before any output column can start,
//   so h lives in shared memory (double-buffered) and a block-wide barrier
//   ends each step.  The 1024 threads split the product four ways along k
//   (256 threads x 4 columns x 4 gates each, reading R rows coalesced), sum
//   the four partials in a fixed order, and then thread j owns state column
//   j in registers for the exponential gating.  What it does not do yet: it
//   runs only B * H CTAs (4 at the serving shapes), so each SM streams 4 MB
//   of R per step alone and the kernel is far from its bound; splitting R's
//   output columns across a thread-block cluster or a cooperative grid, with
//   a barrier per step, is the next design.
//
// Types: wx and R in f32 or bf16 (one dtype), bias and state in f32, hs
//   [B, T, H, dh] in f32.  Launch: grid (H, B), kThreads threads, dynamic
//   shared memory from smem_bytes(); the C entry point returns
//   cudaGetLastError().  The final-state outputs may alias the state inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kColThreads = 256;                 // threads per k-split
constexpr int kSplit = kThreads / kColThreads;   // 4 partial sums along k
constexpr int kMaxCols = 4;                      // columns per product thread
constexpr int kMaxDh = kColThreads * kMaxCols;   // 1024 (= kThreads)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// log(sigmoid(x)) = -softplus(-x) = min(x, 0) - log1p(exp(-|x|)), stable for
// both signs.
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

size_t smem_bytes(int dh) {
  return (size_t)(2 + 4 * kSplit) * dh * sizeof(float);  // h x2, partials
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
slstm_scan_kernel(const T* __restrict__ wx, const T* __restrict__ r,
                  const float* __restrict__ bias, const float* h0,
                  const float* c0, const float* n0, const float* m0,
                  float* __restrict__ hs, float* h_out, float* c_out,
                  float* n_out, float* m_out, int steps, int H, int dh) {
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* h_s = smem;              // [2][dh]: h_{t-1} and h_t
  float* part = h_s + 2 * dh;     // [kSplit][4][dh] partial products

  // Thread tid < dh owns state column j = tid for the whole scan.
  const bool owner = tid < dh;
  const size_t sidx = ((size_t)b * H + head) * dh + tid;
  float h = 0.f, c = 0.f, n = 1.f, m = 0.f;
  float bg[4] = {0.f, 0.f, 0.f, 0.f};
  if (owner) {
    if (h0 != nullptr) {
      h = h0[sidx];
      c = c0[sidx];
      n = n0[sidx];
      m = m0[sidx];
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) bg[g] = bias[((size_t)g * H + head) * dh + tid];
    h_s[tid] = h;
  }
  __syncthreads();

  // Product phase: thread (ks, col) sums k in [k0, k1) for columns
  // col + u * kColThreads of all four gates.
  const int ks = tid / kColThreads;
  const int col = tid - ks * kColThreads;
  const int kchunk = (dh + kSplit - 1) / kSplit;
  const int k0 = min(dh, ks * kchunk);
  const int k1 = min(dh, k0 + kchunk);
  const size_t gate_stride = (size_t)H * dh * dh;
  const T* r_head = r + (size_t)head * dh * dh;

  int cur = 0;
  for (int t = 0; t < steps; ++t) {
    const float* hp = h_s + cur * dh;
    float acc[4][kMaxCols];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int u = 0; u < kMaxCols; ++u) acc[g][u] = 0.f;
    for (int k = k0; k < k1; ++k) {
      const float hk = hp[k];
      const T* rk = r_head + (size_t)k * dh;
#pragma unroll
      for (int u = 0; u < kMaxCols; ++u) {
        const int j = col + u * kColThreads;
        if (j < dh) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            acc[g][u] = fmaf(hk, to_f32(rk[g * gate_stride + j]), acc[g][u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kMaxCols; ++u) {
      const int j = col + u * kColThreads;
      if (j < dh) {
#pragma unroll
        for (int g = 0; g < 4; ++g) part[(ks * 4 + g) * dh + j] = acc[g][u];
      }
    }
    __syncthreads();

    // Gating phase: thread j combines the partials (fixed order) and
    // updates its column of the state.
    if (owner) {
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float rec = 0.f;
#pragma unroll
        for (int s = 0; s < kSplit; ++s) rec += part[(s * 4 + g) * dh + tid];
        const size_t wi = ((((size_t)b * steps + t) * 4 + g) * H + head) * dh + tid;
        pre[g] = (to_f32(wx[wi]) + rec) + bg[g];
      }
      const float logf = log_sigmoid(pre[1]);
      const float m_new = fmaxf(logf + m, pre[0]);
      const float i_eff = expf(pre[0] - m_new);
      const float f_eff = expf(logf + m - m_new);
      const float o = 1.f / (1.f + expf(-pre[3]));
      c = f_eff * c + i_eff * tanhf(pre[2]);
      n = fmaxf(f_eff * n + i_eff, 1e-6f);
      h = o * c / n;
      m = m_new;
      hs[(((size_t)b * steps + t) * H + head) * dh + tid] = h;
      h_s[(cur ^ 1) * dh + tid] = h;
    }
    cur ^= 1;
    __syncthreads();  // h_t complete, partials consumed
  }

  if (owner) {
    h_out[sidx] = h;
    c_out[sidx] = c;
    n_out[sidx] = n;
    m_out[sidx] = m;
  }
}

template <typename T>
cudaError_t launch(const void* wx, const void* r, const void* bias,
                   const void* h0, const void* c0, const void* n0,
                   const void* m0, void* hs, void* h_out, void* c_out,
                   void* n_out, void* m_out, int B, int steps, int H, int dh,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        slstm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  slstm_scan_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(wx), static_cast<const T*>(r),
      static_cast<const float*>(bias), static_cast<const float*>(h0),
      static_cast<const float*>(c0), static_cast<const float*>(n0),
      static_cast<const float*>(m0), static_cast<float*>(hs),
      static_cast<float*>(h_out), static_cast<float*>(c_out),
      static_cast<float*>(n_out), static_cast<float*>(m_out), steps, H, dh);
  return cudaGetLastError();
}

}  // namespace

// dtype (of wx and r): 0 = float32, 1 = bfloat16.  wx [B, T, 4, H, dh],
// r [4, H, dh, dh], bias [4, H, dh] f32, state in/out [B, H, dh] f32 (the
// four inputs all null for the zero state), hs [B, T, H, dh] f32; all
// contiguous on the current device.
extern "C" int slstm_scan_launch(const void* wx, const void* r,
                                 const void* bias, const void* h0,
                                 const void* c0, const void* n0,
                                 const void* m0, void* hs, void* h_out,
                                 void* c_out, void* n_out, void* m_out, int B,
                                 int T, int H, int dh, int dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || H < 1 || dh < 1 || dh > kMaxDh)
    return (int)cudaErrorInvalidValue;
  const bool has_state = h0 != nullptr;
  if (has_state != (c0 != nullptr) || has_state != (n0 != nullptr) ||
      has_state != (m0 != nullptr))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)launch<float>(wx, r, bias, h0, c0, n0, m0, hs, h_out, c_out,
                                n_out, m_out, B, T, H, dh, st);
    case 1:
      return (int)launch<__nv_bfloat16>(wx, r, bias, h0, c0, n0, m0, hs,
                                        h_out, c_out, n_out, m_out, B, T, H,
                                        dh, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
