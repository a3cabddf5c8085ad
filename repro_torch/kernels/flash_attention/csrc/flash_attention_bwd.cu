// Backward of the flash attention kernel: dQ, dK and dV of GQA attention
// over a whole sequence (causal, windowed or unmasked), for training.
//
// Replaces: no TPU kernel.  The Pallas flash kernel
//   (src/repro/kernels/flash_attention/kernel.py::flash_attention) has no
//   backward; the JAX train step differentiates the jnp attention
//   (models/layers/attention.py::_gqa_scores_to_out) with XLA's autodiff.
//   The port's attention runs the forward kernel on the card, so its
//   gradient needs a kernel too (ops.py FlashAttentionFn).
//
// What bounds it on the H100 SXM (data sheet at its 700 W limit: 3.35 TB/s
//   of HBM, 67 TFLOP/s of f32 outside the tensor cores): operations.  At
//   qwen2-0.5b's training shape (T = 4096, H = 14, KV = 2, D = 64, causal)
//   the three launches do about 7 products of [T, T/2, D] per head, 105
//   Gflop, on 9 MB of inputs and outputs.
//
// What the design does about it (a first design, right and simple; wgmma,
//   TMA and a fused dK/dV/dQ pass are later work):
//   - Three launches on the caller's stream, no atomics, so every output
//     element is summed by one thread in a fixed order and the result is
//     the same run after run:
//       (a) bwd_stats_kernel: per query row, the log-sum-exp of its scores
//           over the valid keys (log2 domain) and delta = rowsum(dO * O);
//       (b) bwd_dkdv_kernel: one CTA per (batch row x KV head, K tile)
//           walks the query rows of all G heads of the group, recomputes
//           P = exp(S - lse) and dS = P * (dP - delta), and sums dV = P^T dO
//           and dK = scale dS^T Q in registers: dK and dV of a KV head sum
//           over its G query heads inside one CTA;
//       (c) bwd_dq_kernel: one CTA per (batch row x KV head, query row
//           tile) walks the K tiles and sums dQ = scale dS K.
//   - Rows are folded as in the forward: KV head kvh has M = G x T rows,
//     row r being query head kvh * G + r / T at token r % T, so a K/V tile
//     loaded once serves every query head of its group.
//   - Tiles with no valid pair are skipped before they are loaded, by the
//     forward's rule on the min and max of the tile's positions (tile_rule,
//     ops.py tile_rule): any order of positions works.
//   - SIMT f32 FMA on a 16 x 16 grid of threads: each thread owns a few
//     rows and keys (or columns) strided by 16, operands are read from
//     shared memory rows padded to an odd stride (no bank conflicts), and
//     inputs of either dtype are held in f32 in shared memory.  bf16 inputs
//     and outputs, f32 arithmetic throughout.
//   - A row with no valid key has lse = +inf and every P = 0: its dQ is 0
//     and it adds nothing to dK and dV, as the model's masked_softmax (0
//     output) implies.
//
// Types: f32 or bf16 in and out (the dtype of q); lse and delta scratch in
//   f32, [B, H, T].  Launch: 256 threads a CTA, the tile sizes by width
//   class (D up to 64, 128, 256) from the tables below, dynamic shared
//   memory from the layouts below, which the wrapper's plan must match
//   (ops.py plan_flash_bwd).  flash_attention_bwd_setup sets the kernels'
//   shared-memory limit once per device, before any launch or graph
//   capture.  The C entry points allocate nothing and return a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // a 16 x 16 grid
constexpr int kMaxSmem = 232448;          // 227 KB a CTA on the H100
constexpr int kMaxHeadDim = 256;
// Same tables as ops.py BWD_*: width class, and by class the query rows a
// step and keys a tile of the row kernels (a, c), the keys a CTA and query
// rows a step of the dK/dV kernel (b).
constexpr int kDMax[3] = {64, 128, 256};
constexpr int kRowBM[3] = {64, 64, 32};
constexpr int kRowBN[3] = {64, 64, 32};
constexpr int kKeyBN[3] = {32, 32, 32};
constexpr int kKeyBM[3] = {64, 64, 32};

struct Params {
  const void* q;          // [B, T, H, D]
  const void* k;          // [B, S, KV, D]
  const void* v;
  const void* out;        // [B, T, H, D], the forward's output
  const void* dout;
  const int* q_pos;       // [T]
  const int* k_pos;       // [S]
  void* dq;
  void* dk;
  void* dv;
  float* lse;             // [B, KV, M] = [B, H, T], log2 domain
  float* delta;
  int T, S, H, KV, D, G, M;
  bool causal;
  int window;
  float scale;            // 1 / sqrt(D)
  float scale_log2;       // log2(e) / sqrt(D)
};

// Dynamic shared memory of each kernel, in bytes; same sums as ops.py
// bwd_smem_bytes.  Tiles are f32 rows of kDMax + 1 floats; P and dS tiles
// have rows of (tile + 16) floats.
template <int C>
struct Geo {
  static constexpr int kDP = kDMax[C];
  static constexpr int kLD = kDP + 1;
  static constexpr int kRM = kRowBM[C], kRN = kRowBN[C];
  static constexpr int kKN = kKeyBN[C], kKM = kKeyBM[C];
  static constexpr int kRed = 16 * 4;      // block_minmax scratch
  static constexpr int kStats =
      (kRM + kRN) * kLD * 4 + kRM * 8 + kRM * 4 + kRN * 4 + kRed;
  static constexpr int kDq = 2 * (kRM + kRN) * kLD * 4 +
                             kRM * (kRN + 16) * 4 + kRM * 8 + 3 * kRM * 4 +
                             kRN * 4 + kRed;
  static constexpr int kDkdv = 2 * (kKN + kKM) * kLD * 4 +
                               2 * kKN * (kKM + 16) * 4 + kKM * 8 +
                               3 * kKM * 4 + kKN * 4 + kRed;
  static_assert(kRM % 16 == 0 && kRN % 16 == 0 && kKN % 16 == 0 &&
                kKM % 16 == 0 && kRM <= kThreads && kKM <= kThreads,
                "tile shape");
  static_assert(kStats <= kMaxSmem && kDq <= kMaxSmem &&
                kDkdv <= kMaxSmem, "shared memory");
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Element offset of fold row r of KV head kvh, batch row b.
__device__ __forceinline__ long long row_off(const Params& p, int b, int kvh,
                                             int r) {
  const int h = kvh * p.G + r / p.T, t = r % p.T;
  return ((long long)b * p.T + t) * p.H * p.D + (long long)h * p.D;
}

__device__ __forceinline__ long long key_off(const Params& p, int b, int kvh,
                                             int n) {
  return ((long long)b * p.S + n) * p.KV * p.D + (long long)kvh * p.D;
}

// 0: no pair of the tile is valid; 1: some are; 2: all are (whole tile).
// Same rule as the forward kernel's tile_rule and ops.py tile_rule.
__device__ __forceinline__ int tile_rule(int qmin, int qmax, int kmin,
                                         int kmax, bool whole, bool causal,
                                         int window) {
  if (!causal) return whole ? 2 : 1;
  if (kmin > qmax) return 0;
  if (window > 0 && kmax <= qmin - window) return 0;
  const bool every = kmax <= qmin && (window <= 0 || kmin > qmax - window);
  return whole && every ? 2 : 1;
}

__device__ __forceinline__ bool pair_ok(int qp, int kp, bool causal,
                                        int window) {
  return !causal || (kp <= qp && (window <= 0 || kp > qp - window));
}

// Min and max over the CTA (every thread passes INT_MAX / INT_MIN or a
// value); also a barrier for the shared memory written before it.
__device__ int2 block_minmax(int lo, int hi, int* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int w = threadIdx.x >> 5;
  __syncthreads();                      // red is free again
  if ((threadIdx.x & 31) == 0) {
    red[2 * w] = lo;
    red[2 * w + 1] = hi;
  }
  __syncthreads();
  lo = red[0];
  hi = red[1];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) {
    lo = min(lo, red[2 * i]);
    hi = max(hi, red[2 * i + 1]);
  }
  return make_int2(lo, hi);
}

// R rows of D values into dst [R][DP + 1] as f32, zero past D and for rows
// whose offset is -1.
template <typename T, int DP>
__device__ void load_rows(float* dst, const T* src, const long long* offs,
                          int R, int D) {
  for (int i = threadIdx.x; i < R * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (c < D && offs[r] >= 0) x = ld(src + offs[r] + c);
    dst[r * (DP + 1) + c] = x;
  }
}

// keys n0 .. n0 + R - 1 of KV head kvh into dst [R][DP + 1], zero past S.
template <typename T, int DP>
__device__ void load_keys(float* dst, const T* src, const Params& p, int b,
                          int kvh, int n0, int R) {
  for (int i = threadIdx.x; i < R * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (c < p.D && n0 + r < p.S) x = ld(src + key_off(p, b, kvh, n0 + r) + c);
    dst[r * (DP + 1) + c] = x;
  }
}

// The rows m0 .. m0 + R - 1 of the CTA's fold: offsets (-1 past M), query
// positions and, with lse/dlt, their statistics (lse = +inf, delta = 0
// past M).  Returns the min and max position (a barrier).
__device__ int2 setup_rows(const Params& p, int b, int kvh, int m0, int R,
                           long long* roff, int* qpos, float* lse,
                           float* dlt, int* red) {
  int lo = INT_MAX, hi = INT_MIN;
  const int tid = threadIdx.x;
  if (tid < R) {
    const int r = m0 + tid;
    const long long at = (long long)(b * p.KV + kvh) * p.M + r;
    if (r < p.M) {
      roff[tid] = row_off(p, b, kvh, r);
      qpos[tid] = lo = hi = p.q_pos[r % p.T];
      if (lse) {
        lse[tid] = p.lse[at];
        dlt[tid] = p.delta[at];
      }
    } else {
      roff[tid] = -1;
      qpos[tid] = 0;
      if (lse) {
        lse[tid] = INFINITY;
        dlt[tid] = 0.f;
      }
    }
  }
  return block_minmax(lo, hi, red);
}

// Positions of keys n0 .. n0 + R - 1 into kpos; min and max (a barrier).
__device__ int2 setup_keys(const Params& p, int n0, int R, int* kpos,
                           int* red) {
  int lo = INT_MAX, hi = INT_MIN;
  if ((int)threadIdx.x < R) {
    const int n = n0 + threadIdx.x;
    kpos[threadIdx.x] = 0;
    if (n < p.S) kpos[threadIdx.x] = lo = hi = p.k_pos[n];
  }
  return block_minmax(lo, hi, red);
}

// (a) Row statistics.  Grid (B x KV, ceil(M / RM)).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    bwd_stats_kernel(const Params p) {
  using G = Geo<C>;
  constexpr int DP = G::kDP, LD = G::kLD, BM = G::kRM, BN = G::kRN;
  constexpr int RI = BM / 16, RJ = BN / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BM * LD;
  long long* roff = reinterpret_cast<long long*>(Ks + BN * LD);
  int* qpos = reinterpret_cast<int*>(roff + BM);
  int* kpos = qpos + BM;
  int* red = kpos + BN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bkv = blockIdx.x, b = bkv / p.KV, kvh = bkv % p.KV;
  const int m0 = blockIdx.y * BM;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* o = static_cast<const T*>(p.out);
  const T* dout = static_cast<const T*>(p.dout);

  const int2 qr = setup_rows(p, b, kvh, m0, BM, roff, qpos, nullptr,
                             nullptr, red);
  load_rows<T, DP>(Qs, q, roff, BM, p.D);
  // delta: row ty + 16 i, columns tx, tx + 16, ..., summed over the 16
  // threads of a half warp
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int rl = ty + 16 * i;
    float acc = 0.f;
    if (roff[rl] >= 0)
      for (int c = tx; c < p.D; c += 16)
        acc = fmaf(ld(o + roff[rl] + c), ld(dout + roff[rl] + c), acc);
#pragma unroll
    for (int w = 8; w; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (tx == 0 && m0 + rl < p.M)
      p.delta[(long long)bkv * p.M + m0 + rl] = acc;
  }

  float mrow[RI], lrow[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.f;
  }
  const int n_kt = (p.S + BN - 1) / BN;
  for (int j = 0; j < n_kt; ++j) {
    const int n0 = j * BN;
    const int2 kr = setup_keys(p, n0, BN, kpos, red);
    if (!tile_rule(qr.x, qr.y, kr.x, kr.y, n0 + BN <= p.S, p.causal,
                   p.window))
      continue;
    load_keys<T, DP>(Ks, k, p, b, kvh, n0, BN);
    __syncthreads();
    float s[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < p.D; ++d) {
      float a[RI], bb[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) bb[jj] = Ks[(tx + 16 * jj) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jj = 0; jj < RJ; ++jj) s[i][jj] = fmaf(a[i], bb[jj], s[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int rl = ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        const int nl = tx + 16 * jj;
        if (m0 + rl < p.M && n0 + nl < p.S &&
            pair_ok(qpos[rl], kpos[nl], p.causal, p.window)) {
          const float x = s[i][jj] * p.scale_log2;
          if (x > mrow[i]) {
            lrow[i] = lrow[i] * exp2f(mrow[i] - x) + 1.f;
            mrow[i] = x;
          } else {
            lrow[i] += exp2f(x - mrow[i]);
          }
        }
      }
    }
    __syncthreads();                    // Ks and kpos are refilled next
  }
  // merge the 16 threads' (m, l) of each row; -inf - -inf is never formed
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    float m = mrow[i], l = lrow[i];
#pragma unroll
    for (int w = 8; w; w >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, w);
      const float lo = __shfl_xor_sync(0xffffffffu, l, w);
      const float mn = fmaxf(m, mo);
      l = (m == -INFINITY ? 0.f : l * exp2f(m - mn)) +
          (mo == -INFINITY ? 0.f : lo * exp2f(mo - mn));
      m = mn;
    }
    const int rl = ty + 16 * i;
    if (tx == 0 && m0 + rl < p.M)
      p.lse[(long long)bkv * p.M + m0 + rl] =
          l > 0.f ? m + log2f(l) : INFINITY;
  }
}

// (b) dK and dV.  Grid (B x KV, ceil(S / KN)).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    bwd_dkdv_kernel(const Params p) {
  using G = Geo<C>;
  constexpr int DP = G::kDP, LD = G::kLD, BN = G::kKN, BM = G::kKM;
  constexpr int LS = BM + 16, RI = BN / 16, RJ = BM / 16, RC = DP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BN * LD;
  float* Qs = Vs + BN * LD;
  float* dOs = Qs + BM * LD;
  float* Ps = dOs + BM * LD;
  float* dSs = Ps + BN * LS;
  long long* roff = reinterpret_cast<long long*>(dSs + BN * LS);
  int* qpos = reinterpret_cast<int*>(roff + BM);
  float* lse = reinterpret_cast<float*>(qpos + BM);
  float* dlt = lse + BM;
  int* kpos = reinterpret_cast<int*>(dlt + BM);
  int* red = kpos + BN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bkv = blockIdx.x, b = bkv / p.KV, kvh = bkv % p.KV;
  const int n0 = blockIdx.y * BN;
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);

  const int2 kr = setup_keys(p, n0, BN, kpos, red);
  const bool whole = n0 + BN <= p.S;
  load_keys<T, DP>(Ks, static_cast<const T*>(p.k), p, b, kvh, n0, BN);
  load_keys<T, DP>(Vs, static_cast<const T*>(p.v), p, b, kvh, n0, BN);

  float acc_k[RI][RC], acc_v[RI][RC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < RC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int n_rt = (p.M + BM - 1) / BM;
  for (int it = 0; it < n_rt; ++it) {
    const int m0 = it * BM;
    const int2 qr = setup_rows(p, b, kvh, m0, BM, roff, qpos, lse, dlt,
                               red);
    if (!tile_rule(qr.x, qr.y, kr.x, kr.y, whole, p.causal, p.window))
      continue;
    load_rows<T, DP>(Qs, q, roff, BM, p.D);
    load_rows<T, DP>(dOs, dout, roff, BM, p.D);
    __syncthreads();
    // S^T and dP^T: key ty + 16 i, row tx + 16 jj
    float s[RI][RJ], dp[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < p.D; ++d) {
      float ak[RI], av[RI], bq[RJ], bg[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        ak[i] = Ks[(ty + 16 * i) * LD + d];
        av[i] = Vs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        bq[jj] = Qs[(tx + 16 * jj) * LD + d];
        bg[jj] = dOs[(tx + 16 * jj) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jj = 0; jj < RJ; ++jj) {
          s[i][jj] = fmaf(ak[i], bq[jj], s[i][jj]);
          dp[i][jj] = fmaf(av[i], bg[jj], dp[i][jj]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int nl = ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        const int rl = tx + 16 * jj;
        float pr = 0.f;
        if (n0 + nl < p.S && m0 + rl < p.M &&
            pair_ok(qpos[rl], kpos[nl], p.causal, p.window))
          pr = exp2f(s[i][jj] * p.scale_log2 - lse[rl]);
        Ps[nl * LS + rl] = pr;
        dSs[nl * LS + rl] = pr * (dp[i][jj] - dlt[rl]);
      }
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q: key ty + 16 i, column tx + 16 c
#pragma unroll 2
    for (int m = 0; m < BM; ++m) {
      float pa[RI], da[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        pa[i] = Ps[(ty + 16 * i) * LS + m];
        da[i] = dSs[(ty + 16 * i) * LS + m];
      }
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const float g = dOs[m * LD + tx + 16 * c];
        const float qq = Qs[m * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          acc_v[i][c] = fmaf(pa[i], g, acc_v[i][c]);
          acc_k[i][c] = fmaf(da[i], qq, acc_k[i][c]);
        }
      }
    }
    __syncthreads();                    // Qs, dOs and the rows refill next
  }
  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= p.S) continue;
    const long long off = key_off(p, b, kvh, n);
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int col = tx + 16 * c;
      if (col < p.D) {
        st(dk + off + col, acc_k[i][c] * p.scale);
        st(dv + off + col, acc_v[i][c]);
      }
    }
  }
}

// (c) dQ.  Grid (B x KV, ceil(M / RM)).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const Params p) {
  using G = Geo<C>;
  constexpr int DP = G::kDP, LD = G::kLD, BM = G::kRM, BN = G::kRN;
  constexpr int LS = BN + 16, RI = BM / 16, RJ = BN / 16, RC = DP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BM * LD;
  float* Ks = dOs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* dSs = Vs + BN * LD;
  long long* roff = reinterpret_cast<long long*>(dSs + BM * LS);
  int* qpos = reinterpret_cast<int*>(roff + BM);
  float* lse = reinterpret_cast<float*>(qpos + BM);
  float* dlt = lse + BM;
  int* kpos = reinterpret_cast<int*>(dlt + BM);
  int* red = kpos + BN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bkv = blockIdx.x, b = bkv / p.KV, kvh = bkv % p.KV;
  const int m0 = blockIdx.y * BM;
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  const int2 qr = setup_rows(p, b, kvh, m0, BM, roff, qpos, lse, dlt, red);
  load_rows<T, DP>(Qs, static_cast<const T*>(p.q), roff, BM, p.D);
  load_rows<T, DP>(dOs, static_cast<const T*>(p.dout), roff, BM, p.D);

  float acc[RI][RC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[i][c] = 0.f;

  const int n_kt = (p.S + BN - 1) / BN;
  for (int j = 0; j < n_kt; ++j) {
    const int n0 = j * BN;
    const int2 kr = setup_keys(p, n0, BN, kpos, red);
    if (!tile_rule(qr.x, qr.y, kr.x, kr.y, n0 + BN <= p.S, p.causal,
                   p.window))
      continue;
    load_keys<T, DP>(Ks, k, p, b, kvh, n0, BN);
    load_keys<T, DP>(Vs, v, p, b, kvh, n0, BN);
    __syncthreads();
    // S and dP: row ty + 16 i, key tx + 16 jj
    float s[RI][RJ], dp[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < p.D; ++d) {
      float aq[RI], ag[RI], bk[RJ], bv[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        aq[i] = Qs[(ty + 16 * i) * LD + d];
        ag[i] = dOs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        bk[jj] = Ks[(tx + 16 * jj) * LD + d];
        bv[jj] = Vs[(tx + 16 * jj) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jj = 0; jj < RJ; ++jj) {
          s[i][jj] = fmaf(aq[i], bk[jj], s[i][jj]);
          dp[i][jj] = fmaf(ag[i], bv[jj], dp[i][jj]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int rl = ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        const int nl = tx + 16 * jj;
        float ds = 0.f;
        if (m0 + rl < p.M && n0 + nl < p.S &&
            pair_ok(qpos[rl], kpos[nl], p.causal, p.window))
          ds = exp2f(s[i][jj] * p.scale_log2 - lse[rl]) *
               (dp[i][jj] - dlt[rl]);
        dSs[rl * LS + nl] = ds;
      }
    }
    __syncthreads();
    // dQ += dS K: row ty + 16 i, column tx + 16 c
#pragma unroll 2
    for (int n = 0; n < BN; ++n) {
      float a[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = dSs[(ty + 16 * i) * LS + n];
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const float kk = Ks[n * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][c] = fmaf(a[i], kk, acc[i][c]);
      }
    }
    __syncthreads();                    // Ks, Vs and kpos refill next
  }
  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int rl = ty + 16 * i;
    if (roff[rl] < 0) continue;
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int col = tx + 16 * c;
      if (col < p.D) st(dq + roff[rl] + col, acc[i][c] * p.scale);
    }
  }
}

template <typename T, int C>
cudaError_t launch(const Params& p, int B, int smem_a, int smem_b,
                   int smem_c, cudaStream_t st) {
  using G = Geo<C>;
  if (smem_a != G::kStats || smem_b != G::kDkdv || smem_c != G::kDq)
    return cudaErrorInvalidValue;
  const int row_tiles = (p.M + G::kRM - 1) / G::kRM;
  const int key_tiles = (p.S + G::kKN - 1) / G::kKN;
  if (row_tiles > 65535 || key_tiles > 65535 ||
      (long long)p.KV * B > INT_MAX)
    return cudaErrorInvalidValue;
  const dim3 rows(p.KV * B, row_tiles, 1), keys(p.KV * B, key_tiles, 1);
  bwd_stats_kernel<T, C><<<rows, kThreads, smem_a, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<T, C><<<keys, kThreads, smem_b, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T, C><<<rows, kThreads, smem_c, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_class(const Params& p, int B, int sa, int sb, int sc,
                         cudaStream_t st) {
  if (p.D <= kDMax[0]) return launch<T, 0>(p, B, sa, sb, sc, st);
  if (p.D <= kDMax[1]) return launch<T, 1>(p, B, sa, sb, sc, st);
  return launch<T, 2>(p, B, sa, sb, sc, st);
}

template <typename T, int C>
cudaError_t set_class_limits() {
  const void* fns[3] = {(const void*)bwd_stats_kernel<T, C>,
                        (const void*)bwd_dkdv_kernel<T, C>,
                        (const void*)bwd_dq_kernel<T, C>};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t set_limits() {
  cudaError_t err = set_class_limits<T, 0>();
  if (err == cudaSuccess) err = set_class_limits<T, 1>();
  if (err == cudaSuccess) err = set_class_limits<T, 2>();
  return err;
}

}  // namespace

// Lets every backward instance use up to kMaxSmem of dynamic shared memory
// on the current device.  Call once per device, before the first launch
// and outside CUDA-graph capture.
extern "C" int flash_attention_bwd_setup() {
  cudaError_t err = set_limits<float>();
  if (err == cudaSuccess) err = set_limits<__nv_bfloat16>();
  return (int)err;
}

// dtype: 0 = float32, 1 = bfloat16.  q/out/d_out/dq [B, T, H, D], k/v/dk/dv
// [B, S, KV, D], q_pos [T] and k_pos [S] int32, lse and delta f32 [B, H, T]
// scratch, all contiguous on the current device.  smem_*: the dynamic
// shared memory of the stats, dK/dV and dQ kernels, which must equal
// Geo's sums (ops.py plan_flash_bwd).  Three launches on `stream`.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* k_pos, const void* out, const void* d_out, void* dq,
    void* dk, void* dv, void* lse, void* delta, int B, int T, int S, int H,
    int KV, int D, int causal, int window, int dtype, int smem_a, int smem_b,
    int smem_c, void* stream) {
  if (B < 1 || T < 1 || S < 1 || KV < 1 || H % KV != 0 || D < 1 ||
      D > kMaxHeadDim || B > 65535 || KV > 65535 ||
      (long long)(H / KV) * T > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out; p.dout = d_out;
  p.q_pos = static_cast<const int*>(q_pos);
  p.k_pos = static_cast<const int*>(k_pos);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.T = T; p.S = S; p.H = H; p.KV = KV; p.D = D;
  p.G = H / KV;
  p.M = p.G * T;
  p.causal = causal != 0;
  p.window = window;
  p.scale = (float)(1.0 / sqrt((double)D));
  p.scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_class<float>(p, B, smem_a, smem_b, smem_c, st);
    case 1:
      return (int)launch_class<__nv_bfloat16>(p, B, smem_a, smem_b, smem_c,
                                              st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
