// Single-token GQA decode attention over a position-tracked KV cache.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::decode_attention
//   (Pallas body _decode_kernel), which the serve step runs once per layer
//   for every generated token.
//
// What bounds it on the H100 SXM (data sheet at its 700 W limit: 3.35 TB/s
//   of HBM, 67 TFLOP/s of f32 outside the tensor cores): memory, and at the
//   serving shapes latency.  One call needs the valid K/V rows, 2 * S_valid
//   * KV * D elements, and does 4 * H * S_valid * D flops on them: G / 2
//   flops per byte in f32 (G = H / KV query heads per KV head), far below
//   the card's ridge of 20.  At the serving shapes (B=1, H=14, KV=2, D=64,
//   S=256 with 40 valid slots) that is 40 KiB, some 15 ns of HBM time, far
//   below a launch's own latency: what is left to win is round trips to
//   memory and idle SMs.  Tensor cores do not pay: one token gives M = G = 7
//   rows, a wgmma tile wastes 57 of its 64 rows, and the work is bound by
//   bytes anyway.  The Hopper features that matter are the 16-byte
//   asynchronous copies (cp.async) and the 132 SMs.
//
// Design: grid (n_split, KV, B).  Each CTA owns one chunk of at most
//   kMaxChunk consecutive slots of one (batch, KV head) pair and serves all G
//   query heads of the group from it, so every cache byte is read once.
//   The wrapper (ops.py plan_split) picks the chunk so that a long cache
//   fills the card.  A CTA:
//   1. reads its chunk's stored positions (coalesced) and stages q in f32;
//      a warp vote gives the valid slots, compacted in order.  Validity comes
//      from the stored positions only, never from slot order (rotating
//      caches exist): 0 <= stored <= pos and, with a window,
//      stored > pos - window.  The current position is the argument
//      `pos`, or (kPosAt) the int32 that `pos_at` points to, read on the
//      card there, so that a launch captured once in a CUDA graph replays
//      at every position; this test is its only use.
//   2. a chunk with no valid slot loads no K/V and writes the partial
//      (m = -inf, l = 0).  Otherwise the valid K rows, then the valid V rows,
//      are copied into shared memory with 16-byte cp.async, every copy
//      issued before the first wait; scores start when K has landed, while
//      V is still in flight.  A D or a base pointer that 16 bytes do not
//      divide takes scalar loads into the same layout.
//   3. scores, softmax and the unnormalised sum p V over the valid rows give
//      the chunk's partial (m, l, acc[G, D]) in f32, written to a workspace.
//   4. one launch, no second combine pass: each CTA takes a ticket
//      (__threadfence, atomicAdd on a per-(batch, KV head) counter); the
//      last CTA of the group merges the partials by log-sum-exp (partials
//      with l = 0 are skipped, so exp(-inf - -inf) is never formed; all of
//      them empty gives 0, as the model's masked_softmax does) and writes
//      out, then sets its counter back to 0, so that the next call, and a
//      CUDA graph's replay, find it at 0.  Partials are read through L2
//      (__ldcg).
//   Shared memory rows of K and V are an odd number of 16-byte units apart,
//   so the 8 threads of a 16-byte load phase, on 8 consecutive rows, hit
//   disjoint banks.
//
// Types: f32 or bf16 in and out (the dtype of q); all arithmetic in f32.
// Launch: grid (n_split, KV, B), kThreads threads, dynamic shared memory from
//   layout(); the C entry point allocates nothing and returns
//   cudaGetLastError().  The counters are zero-initialised int32, one per
//   (batch, KV head), kept by the caller; calls that share them must be
//   ordered on one stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 64;     // slots per CTA: warps 0 and 1 vote on them

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

// 16 bytes of shared memory as f32: 4 floats or 8 bf16 values.
__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&x)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Merge a softmax partial (m, l) into the running (mx, sum).  A partial with
// l = 0 holds no valid slot and is skipped, so exp(-inf - -inf) never forms.
__device__ __forceinline__ void merge_partial(float& mx, float& sum, float m,
                                              float l) {
  if (!(l > 0.f)) return;
  const float mn = fmaxf(mx, m);
  sum = sum * expf(mx - mn) + l * expf(m - mn);
  mx = mn;
}

__host__ __device__ __forceinline__ size_t round16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Shared memory, in bytes from the base, every part 16-byte aligned.
struct Layout {
  int dv;        // D rounded up to whole 16-byte vectors of the input type
  int pitch;     // elements from one K (or V) row to the next
  int pstride;   // floats from one score row to the next
  size_t q, p, k, v, idx, stat, total;
};

__host__ __device__ __forceinline__ Layout layout(int G, int D, int chunk,
                                                  int esz) {
  Layout L;
  const int vec = 16 / esz;
  const int units = (D + vec - 1) / vec;
  L.dv = units * vec;
  L.pitch = (units | 1) * vec;          // an odd number of 16-byte units
  L.pstride = chunk + 1;
  L.q = 0;                                              // [G, dv] f32
  L.p = L.q + round16((size_t)G * L.dv * 4);            // [G, pstride] f32
  L.k = L.p + round16((size_t)G * L.pstride * 4);       // [chunk, pitch] T
  L.v = L.k + (size_t)chunk * L.pitch * esz;            // [chunk, pitch] T
  L.idx = L.v + (size_t)chunk * L.pitch * esz;          // [chunk] int
  L.stat = L.idx + round16((size_t)chunk * 4);          // 4 ints, m[G], l[G]
  L.total = L.stat + 16 + (size_t)2 * G * 4;
  return L;
}

template <typename T, bool kPosAt>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ positions,
                        T* __restrict__ out, float* __restrict__ ws,
                        int* __restrict__ counters,
                        const int* __restrict__ pos_at, int S, int H, int KV,
                        int D, int chunk, int pos, int window, float scale,
                        int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_split = gridDim.x;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Layout L = layout(G, D, chunk, sizeof(T));

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  T* k_s = reinterpret_cast<T*>(smem + L.k);
  T* v_s = reinterpret_cast<T*>(smem + L.v);
  int* idx_s = reinterpret_cast<int*>(smem + L.idx);
  int* int_s = reinterpret_cast<int*>(smem + L.stat);  // votes, last flag
  float* m_s = reinterpret_cast<float*>(int_s + 4);
  float* l_s = m_s + G;

  const int s0 = split * chunk;
  const int n = min(chunk, S - s0);
  const size_t head0 = ((size_t)b * H + (size_t)kvh * G) * D;
  const size_t row = (size_t)D + 2;                  // workspace floats a head
  float* part = ws + (((size_t)b * KV + kvh) * n_split + split) * G * row;

  // 1. validity of the chunk's slots; q staged in f32, zero past D
  int ok = 0;
  if (tid < n) {
    // read here, by the threads that vote: the same read at the kernel's
    // top compiled to a kernel 1.5x slower on the H100 (43 against 29 us a
    // launch at qwen2-0.5b's heads over 8193 slots)
    const int p = kPosAt ? __ldg(pos_at) : pos;
    const int stored = positions[(size_t)b * S + s0 + tid];
    ok = stored >= 0 && stored <= p && (window <= 0 || stored > p - window);
  }
  const unsigned vote = __ballot_sync(0xffffffffu, ok);
  if (warp < 2 && lane == 0) int_s[warp] = (int)vote;
  for (int i = tid; i < G * L.dv; i += kThreads) {
    const int g = i / L.dv;
    const int d = i - g * L.dv;
    q_s[i] = d < D ? to_f32(q[head0 + (size_t)g * D + d]) : 0.f;
  }
  __syncthreads();
  const unsigned vote0 = (unsigned)int_s[0];
  const unsigned vote1 = (unsigned)int_s[1];
  const int nv = __popc(vote0) + __popc(vote1);
  if (ok) {                       // the valid slots, compacted in slot order
    const unsigned below = (1u << lane) - 1u;
    idx_s[warp == 0 ? __popc(vote0 & below)
                    : __popc(vote0) + __popc(vote1 & below)] = tid;
  }

  if (nv == 0) {
    for (int g = tid; g < G; g += kThreads) {
      part[g * row + D] = -INFINITY;
      part[g * row + D + 1] = 0.f;
    }
  } else {
    __syncthreads();              // idx_s complete
    // 2. stage the valid K rows, then the valid V rows
    const size_t slot_stride = (size_t)KV * D;
    const size_t base = ((size_t)b * S + s0) * slot_stride + (size_t)kvh * D;
    const T* kb = k + base;
    const T* vb = v + base;
    if (vec_ok) {
      const int per_row = D / VEC;
      for (int i = tid; i < nv * per_row; i += kThreads) {
        const int j = i / per_row;
        const int c = (i - j * per_row) * VEC;
        cp_async16(k_s + j * L.pitch + c,
                   kb + (size_t)idx_s[j] * slot_stride + c);
      }
      cp_async_commit();
      for (int i = tid; i < nv * per_row; i += kThreads) {
        const int j = i / per_row;
        const int c = (i - j * per_row) * VEC;
        cp_async16(v_s + j * L.pitch + c,
                   vb + (size_t)idx_s[j] * slot_stride + c);
      }
      cp_async_commit();
      cp_async_wait<1>();         // this thread's K copies have landed
    } else {
#pragma unroll 4
      for (int i = tid; i < nv * L.dv; i += kThreads) {
        const int j = i / L.dv;
        const int d = i - j * L.dv;
        const size_t src = (size_t)idx_s[j] * slot_stride + d;
        const T zero = from_f32<T>(0.f);
        k_s[j * L.pitch + d] = d < D ? kb[src] : zero;
        v_s[j * L.pitch + d] = d < D ? vb[src] : zero;
      }
    }
    __syncthreads();

    // 3a. scores[g, j] = scale * q[g] . k[j] over the valid rows
    for (int i = tid; i < G * nv; i += kThreads) {
      const int g = i / nv;
      const int j = i - g * nv;
      const float* qg = q_s + g * L.dv;
      const T* kj = k_s + j * L.pitch;
      float dot = 0.f;
      for (int c = 0; c < L.dv; c += VEC) {
        float kx[VEC];
        load_vec(kj + c, kx);
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qg + c + e);
          dot = fmaf(qq.x, kx[e], dot);
          dot = fmaf(qq.y, kx[e + 1], dot);
          dot = fmaf(qq.z, kx[e + 2], dot);
          dot = fmaf(qq.w, kx[e + 3], dot);
        }
      }
      p_s[g * L.pstride + j] = dot * scale;
    }
    __syncthreads();

    // 3b. softmax statistics of the chunk, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* prow = p_s + g * L.pstride;
      float mx = -INFINITY;
      for (int j = lane; j < nv; j += 32) mx = fmaxf(mx, prow[j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < nv; j += 32) {
        const float p = expf(prow[j] - mx);
        prow[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[g] = mx;
        l_s[g] = sum;
      }
    }
    if (vec_ok) cp_async_wait<0>();
    __syncthreads();

    // 3c. acc[g, d] = sum_j p[g, j] * v[j, d]
    const int nvec = L.dv / VEC;
    for (int i = tid; i < G * nvec; i += kThreads) {
      const int g = i / nvec;
      const int c = (i - g * nvec) * VEC;
      const float* prow = p_s + g * L.pstride;
      float a[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) a[e] = 0.f;
      for (int j = 0; j < nv; ++j) {
        float vx[VEC];
        load_vec(v_s + j * L.pitch + c, vx);
        const float p = prow[j];
#pragma unroll
        for (int e = 0; e < VEC; ++e) a[e] = fmaf(p, vx[e], a[e]);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (c + e < D) part[g * row + c + e] = a[e];
    }
    for (int g = tid; g < G; g += kThreads) {
      part[g * row + D] = m_s[g];
      part[g * row + D + 1] = l_s[g];
    }
  }

  // 4. ticket: the last CTA of the (batch, KV head) group combines
  __threadfence();
  __syncthreads();
  int* counter = counters + (size_t)b * KV + kvh;
  if (tid == 0) int_s[2] = atomicAdd(counter, 1) == n_split - 1;
  __syncthreads();
  if (!int_s[2]) return;
  __threadfence();

  // 5. combine.  (M, L) per head in one pass: each lane merges its
  // partials online, then the warp merges the lanes' pairs.  A pair with no
  // valid slot is (-inf, 0) and is skipped, never subtracted from.
  const float* parts = ws + ((size_t)b * KV + kvh) * n_split * G * row;
  for (int g = warp; g < G; g += kWarps) {
    float mx = -INFINITY, sum = 0.f;
    for (int i = lane; i < n_split; i += 32) {
      const float* r = parts + ((size_t)i * G + g) * row;
      merge_partial(mx, sum, __ldcg(r + D), __ldcg(r + D + 1));
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, mx, o);
      const float ol = __shfl_xor_sync(0xffffffffu, sum, o);
      merge_partial(mx, sum, om, ol);
    }
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum > 0.f ? 1.f / sum : 0.f;
    }
  }
  __syncthreads();
  // out = sum_i exp(m_i - M) acc_i / L.  An empty partial has m_i = -inf,
  // so its weight is 0 and its acc, never written, is not used; the loads
  // of all partials are independent and go out together.
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    const float inv = l_s[g];
    const float mx = m_s[g];
    float a = 0.f;
    if (inv > 0.f) {
#pragma unroll 4
      for (int s = 0; s < n_split; ++s) {
        const float* r = parts + ((size_t)s * G + g) * row;
        const float w = expf(__ldcg(r + D) - mx);
        const float x = __ldcg(r + d);
        a = w > 0.f ? fmaf(w, x, a) : a;
      }
    }
    out[head0 + i] = from_f32<T>(a * inv);
  }
  if (tid == 0) *counter = 0;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* positions, void* out, void* ws, void* counters,
                   const void* pos_at, int B, int S, int H, int KV, int D,
                   int chunk, int n_split, int pos, int window,
                   cudaStream_t stream) {
  auto kernel = pos_at != nullptr ? decode_attention_kernel<T, true>
                                  : decode_attention_kernel<T, false>;
  const size_t smem = layout(H / KV, D, chunk, sizeof(T)).total;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int vec_ok = (D * sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const float scale = 1.0f / sqrtf((float)D);
  kernel<<<dim3(n_split, KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(positions),
      static_cast<T*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), static_cast<const int*>(pos_at), S, H,
      KV, D, chunk, pos, window, scale, vec_ok);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out [B, H, D], k/v [B, S, KV, D],
// positions [B, S] int32, all contiguous on the current device.  The slots
// are cut into n_split chunks of `chunk` (the last one ragged): n_split =
// ceil(S / chunk).  ws is f32 [B, KV, n_split, H / KV, D + 2] (each head's
// acc[D], m, l) and counters int32 [B * KV], all 0.  The current position
// is `pos`, or, where pos_at is not null, the int32 it points to on the
// current device, read there (`pos` is then unused): a launch captured in a
// CUDA graph serves whatever position is written there before each replay.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* positions,
                                       void* out, void* ws, void* counters,
                                       const void* pos_at, int B, int S,
                                       int H, int KV, int D, int chunk,
                                       int n_split, int pos, int window,
                                       int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || D < 1 || chunk < 1 ||
      chunk > kMaxChunk || n_split != (S + chunk - 1) / chunk ||
      ws == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)launch<float>(q, k, v, positions, out, ws, counters,
                                pos_at, B, S, H, KV, D, chunk, n_split, pos,
                                window, st);
    case 1:
      return (int)launch<__nv_bfloat16>(q, k, v, positions, out, ws,
                                        counters, pos_at, B, S, H, KV, D,
                                        chunk, n_split, pos, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a CTA takes, in bytes (for reports).
extern "C" int decode_attention_smem_bytes(int H, int KV, int D, int chunk,
                                           int dtype) {
  return (int)layout(H / KV, D, chunk, dtype == 1 ? 2 : 4).total;
}
