// Backward of the flash attention kernel: dQ, dK and dV of GQA attention
// over a whole sequence (causal, windowed or unmasked), for training, on the
// tensor cores.
//
// Replaces: no TPU kernel.  The Pallas flash kernel
//   (src/repro/kernels/flash_attention/kernel.py::flash_attention) has no
//   backward; the JAX train step differentiates the jnp attention
//   (models/layers/attention.py::_gqa_scores_to_out) with XLA's autodiff.
//   The port's attention runs the forward kernel on the card, so its
//   gradient needs a kernel too (ops.py FlashAttentionFn).
//
// What bounds it on the H100 SXM (data sheet at its 700 W limit: 3.35 TB/s
//   of HBM, 989 TFLOP/s of bf16 on the tensor cores): operations.  At
//   qwen2-0.5b's training shape (T = 4096, H = 14, KV = 2, D = 64, causal)
//   the three launches do eight products of [G T, T / 2, D] per KV head
//   (S in the statistics; S, dP, dV and dK in dK/dV; S, dP and dQ in dQ),
//   and in f32 each is six bf16 tensor-core passes: some 1.8 x 10^8
//   m16n8k16 products on 67 MB of inputs and outputs.  Per step, a CTA's
//   copies, masks, exponentials and f32 splits cost about as much issue
//   time as its products, so those are kept off the inner loops.
//
// What the design does about it:
//   - Tensor cores: mma.sync.m16n8k16 bf16 x bf16 -> f32 with ldmatrix
//     fragments, the forward kernel's helpers and arrangement.  f32 operands
//     (Q, K, V, dO, P and dS) are three exact bf16 pieces; each 16-deep
//     slice takes six passes, small first (lo.hi, hi.lo, mid.mid, mid.hi,
//     hi.mid, hi.hi), sums from zero and is added to the running f32 sum
//     with one rounded FADD (the tensor cores truncate inside their
//     accumulator).  bf16 operands take one pass, P and dS rounded to bf16
//     before their products, as the forward rounds P.
//   - Three launches on the caller's stream, no atomics, so every output
//     element is summed in a fixed order and the result is the same run
//     after run:
//       (a) bwd_stats_kernel: per query row the log-sum-exp of its scores
//           (log2 domain) over the K tiles and delta = rowsum(dO * O).  It
//           also writes Q, dO, K and V once into bf16 planes in a scratch
//           buffer: three exact pieces each in f32, a copy in bf16, rows in
//           the fold order below, D padded with zeros to a multiple of 16.
//           So every f32 value is split once, and the other two kernels
//           load 16-byte aligned tiles with cp.async whatever D is.
//       (b) bwd_dkdv_kernel: a CTA holds BN keys of one KV head (16 a
//           warp) and walks the query rows of all G heads of the group in
//           steps through a ring of 2 stages.  It computes S^T = K Q^T and
//           dP^T = V dO^T with the keys as rows, so P^T and dS^T come out
//           of the accumulators as the A operand of dV += P^T dO and
//           dK += dS^T Q, which read dO and Q by ldmatrix.trans: nothing is
//           staged through shared memory.  Where the G x T rows are too
//           few CTAs (qwen2: KV = 2), the rows are cut into n_split chunks
//           (ops.py plan_flash_bwd) whose f32 partials are summed in chunk
//           order by (c).  CTAs run longest first (earliest keys).
//       (c) bwd_dq_kernel: a CTA holds rows of the fold (16 a warp, latest
//           first) and walks the K/V tiles; S and dP with the rows as rows,
//           dS from the accumulators as A of dQ += dS K (K by
//           ldmatrix.trans).  Before that, each CTA sums a slice of the dK
//           and dV partials in chunk order, where there are any.
//   - At the wide classes, where 16 rows of three f32 planes of Q and dO
//     (or of K and V) would leave room for few warps, KP warps share 16
//     rows (or keys): each sums S and dP over its part of D, the parts meet
//     in shared memory and are added in part order by every warp of the
//     group, and each accumulates the output columns of its part.
//   - Ring copies are 16-byte units at addresses fixed per thread, and a
//     tile or step that needs no per-pair mask (most of them) takes a
//     branch without the pair tests.
//   - Rows are folded as in the forward: KV head kvh has M = G x T rows,
//     row r being query head kvh * G + r / T at token r % T, so a K/V tile
//     loaded once serves every query head of its group.
//   - Tiles and row steps with no valid pair are skipped before they are
//     loaded, by the forward's rule on the min and max of their positions
//     (tile_rule, ops.py tile_rule), through a visit list built once a CTA:
//     any order of positions works.
//   - Shared-memory rows are (class + 8) bf16 values apart: an odd number
//     of 16-byte units, so each ldmatrix phase hits eight distinct bank
//     groups.  Zero-filled rows past T, S and D add nothing.
//   - A row with no valid key has lse = +inf and every P = 0: its dQ is 0
//     and it adds nothing to dK and dV, as the model's masked_softmax (0
//     output) implies.
//   What it does not do yet: wgmma, TMA, warp specialisation, a persistent
//   grid, and lse from the forward (which would save launch (a)'s product);
//   at the 256 class in f32, four warps still share 16 rows, repeating the
//   masks and exponentials four times.
//
// Types: f32 or bf16 in and out (the dtype of q); lse and delta f32
//   [B, H, T]; the planes scratch bf16; dK/dV partials f32 [n_split, B, S,
//   KV, D] where n_split > 1.  Launch: tiles, warps and shared memory by
//   dtype and width class (D up to 64, 128, 256) from the tables below,
//   which the wrapper's plan must match (ops.py plan_flash_bwd).
//   flash_attention_bwd_setup sets the kernels' shared-memory limit once per
//   device, before any launch or graph capture.  The C entry points
//   allocate nothing and return a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxSmem = 232448;          // 227 KB a CTA on the H100
constexpr int kMaxHeadDim = 256;
constexpr int kStages = 2;                // the cp.async ring of (b), (c)
constexpr int kFull = 1 << 30;            // visit-list flag: no mask needed
// Width classes and, by dtype (f32, bf16) and class, the tiles of the three
// kernels.  Same tables as ops.py D_CLASSES, BWD_STATS, BWD_KEYS, BWD_ROWS.
constexpr int kDMax[3] = {64, 128, 256};
// (a) query rows a CTA (16 a warp, 2 threads a row; half as many where the
// visit list would not fit) and keys a K tile
constexpr int kStatsRows[2][3] = {{128, 128, 128}, {128, 128, 64}};
constexpr int kStatsKeys[2][3] = {{32, 32, 16}, {64, 32, 16}};
// (b) warps, warps sharing 16 keys (a part of D each), query rows a step
constexpr int kKeyWarps[2][3] = {{8, 8, 8}, {8, 8, 8}};
constexpr int kKeyParts[2][3] = {{1, 2, 4}, {1, 2, 2}};
constexpr int kKeyStep[2][3] = {{32, 16, 16}, {64, 32, 32}};
// (c) warps, warps sharing 16 rows (a part of D each), keys a K tile
constexpr int kRowWarps[2][3] = {{8, 8, 8}, {8, 8, 8}};
constexpr int kRowParts[2][3] = {{1, 2, 4}, {1, 1, 1}};
constexpr int kRowKeys[2][3] = {{32, 16, 16}, {64, 64, 32}};

// Split pass q (of six) of three pieces x three: (A piece, B piece), the
// small products first: (2,0) (0,2) (1,1) (1,0) (0,1) (0,0).  Same order as
// the forward kernel and ops.py PASSES.
__host__ __device__ constexpr int pass_a(int q) {
  return q == 0 ? 2 : q == 2 ? 1 : q == 3 ? 1 : 0;
}
__host__ __device__ constexpr int pass_b(int q) {
  return q == 1 ? 2 : q == 2 ? 1 : q == 4 ? 1 : 0;
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

template <typename T, int C>
struct Geo {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kI = kF32 ? 0 : 1;
  static constexpr int kDM = kDMax[C];
  static constexpr int kPl = kF32 ? 3 : 1;           // bf16 planes an operand
  static constexpr int kRs = (kDM + 8) * 2;          // bytes a row in smem
  static constexpr int kUpr = kDM / 8;               // 16-byte units a row
  static constexpr int kSl = kDM / 16;               // 16-column slices
  // (a)
  static constexpr int kSR = kStatsRows[kI][C];
  static constexpr int kSN = kStatsKeys[kI][C];
  // (b): keys a CTA, rows a step
  static constexpr int kKW = kKeyWarps[kI][C];
  static constexpr int kKP = kKeyParts[kI][C];
  static constexpr int kKN = 16 * kKW / kKP;
  static constexpr int kKM = kKeyStep[kI][C];
  // (c): rows a CTA, keys a tile
  static constexpr int kQW = kRowWarps[kI][C];
  static constexpr int kQP = kRowParts[kI][C];
  static constexpr int kQR = 16 * kQW / kQP;
  static constexpr int kQN = kRowKeys[kI][C];
  static_assert(kSN % (kSR / 16) == 0 && kKW % kKP == 0 &&
                kQW % kQP == 0 && kKM % 16 == 0 && kQN % 16 == 0 &&
                kSN % 16 == 0, "tile shape");
};

// Dynamic shared memory, in bytes from the base, every part 16-byte
// aligned; each kernel ends with the visit list of n entries (tile flags
// [n] bytes, the list [n] ints, its length).  Same sums as ops.py
// bwd_smem_bytes.
__host__ __device__ constexpr int list_bytes(int n) {
  return round16(n) + round16(4 * n) + 16;
}
// (a) Q planes [PL][R][RS]; K planes [PL][BN][RS]; k_pos [BN]; the list.
// R is the table's kStatsRows, or half of it where the list would not fit.
template <typename T, int C, int R>
__host__ __device__ constexpr int stats_fixed() {
  using G = Geo<T, C>;
  return G::kPl * (R + G::kSN) * G::kRs + round16(4 * G::kSN);
}
// (b) K, V planes [2][PL][BN][RS]; k_pos [BN]; the ring of kStages stages
// {Q, dO planes [2][PL][BM][RS], q_pos, lse, delta [BM] each}; with KP > 1
// the parts' S, dP [W][2][BM / 8][4][32] f32; the list.
template <typename T, int C>
__host__ __device__ constexpr int dkdv_stage() {
  using G = Geo<T, C>;
  return 2 * G::kPl * G::kKM * G::kRs + 12 * G::kKM;
}
template <typename T, int C>
__host__ __device__ constexpr int dkdv_ring() {         // where the ring starts
  using G = Geo<T, C>;
  return 2 * G::kPl * G::kKN * G::kRs + round16(4 * G::kKN);
}
template <typename T, int C>
__host__ __device__ constexpr int dkdv_exch() {         // where S, dP meet
  return dkdv_ring<T, C>() + kStages * dkdv_stage<T, C>();
}
template <typename T, int C>
__host__ __device__ constexpr int dkdv_fixed() {
  using G = Geo<T, C>;
  return dkdv_exch<T, C>() +
         (G::kKP > 1 ? G::kKW * 2 * 16 * G::kKM * 4 : 0);
}
// (c) Q, dO planes [2][PL][R][RS]; lse, delta [R]; the ring of kStages
// stages {K, V planes [2][PL][BN][RS], k_pos [BN]}; with KP > 1 the parts'
// S, dP [W][2][BN / 8][4][32] f32; the list.
template <typename T, int C>
__host__ __device__ constexpr int dq_stage() {
  using G = Geo<T, C>;
  return 2 * G::kPl * G::kQN * G::kRs + round16(4 * G::kQN);
}
template <typename T, int C>
__host__ __device__ constexpr int dq_ring() {           // where the ring starts
  using G = Geo<T, C>;
  return 2 * G::kPl * G::kQR * G::kRs + 8 * G::kQR;
}
template <typename T, int C>
__host__ __device__ constexpr int dq_exch() {           // where S, dP meet
  return dq_ring<T, C>() + kStages * dq_stage<T, C>();
}
template <typename T, int C>
__host__ __device__ constexpr int dq_fixed() {
  using G = Geo<T, C>;
  return dq_exch<T, C>() + (G::kQP > 1 ? G::kQW * 2 * 16 * G::kQN * 4 : 0);
}

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
  __nv_bfloat16* qp;      // planes [B x KV][PL][M][dp] in the fold order
  __nv_bfloat16* dop;
  __nv_bfloat16* kp;      // planes [B x KV][PL][S][dp]
  __nv_bfloat16* vp;
  float* part_k;          // [n_split][B, S, KV, D], n_split > 1 only
  float* part_v;
  long long n_out;        // B x S x KV x D
  int T, S, H, KV, D, G, M;
  int dp;                 // D rounded up to 16
  int causal, window;
  int n_split, chunk;     // (b): the rows cut into chunks of `chunk`
  int vec_rows, vec_k;    // (a): Q, O, dO and K, V by vector loads
  float scale;            // 1 / sqrt(D)
  float scale_log2;       // log2(e) / sqrt(D)
};

// 0: no pair of the tile is valid (skip it); 1: mask pair by pair; 2: every
// pair is valid.  `whole`: no key of the tile lies past S.  Same rule as the
// forward kernel and ops.py tile_rule.
__host__ __device__ inline int tile_rule(int qp_min, int qp_max, int kp_min,
                                         int kp_max, bool whole, int causal,
                                         int window) {
  if (!causal) return whole ? 2 : 1;
  if (kp_min > qp_max) return 0;
  if (window > 0 && kp_max <= qp_min - window) return 0;
  const bool all = kp_max <= qp_min && (window <= 0 || kp_min > qp_max - window);
  return whole && all ? 2 : 1;
}

__device__ __forceinline__ bool pair_ok(int qp, int kp, int causal,
                                        int window) {
  return !causal || (kp <= qp && (window <= 0 || kp > qp - window));
}

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
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void split3(float x, __nv_bfloat16& hi,
                                       __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo_col,
                                         __nv_bfloat16 hi_col) {
  const __nv_bfloat162 v = __halves2bfloat162(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Columns col .. col + 3 of a row (zero past D): one 16- or 8-byte load
// where `vec` (D a multiple of 4, the base aligned), else one load each.
template <typename T>
__device__ __forceinline__ float4 load4(const T* row, int col, int D,
                                        bool vec) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) {
    if (col < D) {
      if constexpr (sizeof(T) == 4) {
        x = *reinterpret_cast<const float4*>(row + col);
      } else {
        const uint2 w = *reinterpret_cast<const uint2*>(row + col);
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w.x));
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w.y));
        x = make_float4(a.x, a.y, b.x, b.y);
      }
    }
  } else {
    if (col < D) x.x = to_f32(row[col]);
    if (col + 1 < D) x.y = to_f32(row[col + 1]);
    if (col + 2 < D) x.z = to_f32(row[col + 2]);
    if (col + 3 < D) x.w = to_f32(row[col + 3]);
  }
  return x;
}

// Four values as PL bf16 planes at dst (8-byte aligned, planes `stride`
// values apart), one 8-byte store a plane.
template <int PL>
__device__ __forceinline__ void put4(__nv_bfloat16* dst, long long stride,
                                     float4 x) {
  if constexpr (PL == 1) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(
        pack(__float2bfloat16_rn(x.x), __float2bfloat16_rn(x.y)),
        pack(__float2bfloat16_rn(x.z), __float2bfloat16_rn(x.w)));
  } else {
    __nv_bfloat16 h[4], m[4], l[4];
    split3(x.x, h[0], m[0], l[0]);
    split3(x.y, h[1], m[1], l[1]);
    split3(x.z, h[2], m[2], l[2]);
    split3(x.w, h[3], m[3], l[3]);
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack(h[0], h[1]), pack(h[2], h[3]));
    *reinterpret_cast<uint2*>(dst + stride) =
        make_uint2(pack(m[0], m[1]), pack(m[2], m[3]));
    *reinterpret_cast<uint2*>(dst + 2 * stride) =
        make_uint2(pack(l[0], l[1]), pack(l[2], l[3]));
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// No side effects: not volatile, so the compiler may interleave the
// products of independent accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction (2 ulp; results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// acc += A B over one 16-deep slice: a single product of bf16 operands, or
// the six split passes summed from zero and added with one rounded FADD.
// b[pl] holds two 8-column B fragments; `half` picks one.
template <int PL>
__device__ __forceinline__ void slice_mma(float (&acc)[4],
                                          const uint32_t (&a)[PL][4],
                                          const uint32_t (&b)[PL][4],
                                          int half) {
  if constexpr (PL == 1) {
    mma_bf16(acc, a[0], b[0][2 * half], b[0][2 * half + 1]);
  } else {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 6; ++q)
      mma_bf16(part, a[pass_a(q)], b[pass_b(q)][2 * half],
               b[pass_b(q)][2 * half + 1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += part[e];
  }
}

// The A fragment (16 rows x 16 columns) from the accumulators of two
// adjacent 8-column tiles: as bf16, or as three bf16 pieces.
template <int PL>
__device__ __forceinline__ void acc_fragment(uint32_t (&a)[PL][4],
                                             const float (&s0)[4],
                                             const float (&s1)[4]) {
  const float x[8] = {s0[0], s0[1], s0[2], s0[3], s1[0], s1[1], s1[2], s1[3]};
  if constexpr (PL == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[0][i] = pack(__float2bfloat16_rn(x[2 * i]),
                     __float2bfloat16_rn(x[2 * i + 1]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat16 h0, m0, l0, h1, m1, l1;
      split3(x[2 * i], h0, m0, l0);
      split3(x[2 * i + 1], h1, m1, l1);
      a[0][i] = pack(h0, h1);
      a[1][i] = pack(m0, m1);
      a[2][i] = pack(l0, l1);
    }
  }
}

// ldmatrix lane offsets within a tile of rows RS bytes apart: A (16 rows x
// 16 columns), B with the rows as n (two 8-row tiles, k along the row),
// B with the rows as k (ldmatrix.trans; two 8-column tiles).
template <int RS>
__device__ __forceinline__ uint32_t a_lane(int lane) {
  return (lane & 15) * RS + (lane >> 4) * 16;
}
template <int RS>
__device__ __forceinline__ uint32_t b_lane(int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * RS + ((lane >> 3) & 1) * 16;
}

// acc0[2 NP][4] += A0 B0^T and acc1 += A1 B1^T over the column slices
// [c0, c1) of D, the two products interleaved (independent mma chains): A
// the 16 rows at a0, a1 (planes a_pl bytes apart, a_lane included), B the
// 16 NP rows at b0, b1 (planes b_pl apart, b_lane included); accumulator
// tile n covers B rows 8 n .. 8 n + 7.  With TWO false only acc0.  SPM
// bounds c1 - c0.
template <int PL, int NP, int SPM, int RS, bool TWO>
__device__ __forceinline__ void rows_product(float (&acc0)[2 * NP][4],
                                             float (&acc1)[2 * NP][4],
                                             uint32_t a0, uint32_t a1,
                                             int a_pl, uint32_t b0,
                                             uint32_t b1, int b_pl, int c0,
                                             int c1) {
  constexpr int NM = TWO ? 2 : 1;
#pragma unroll
  for (int j = 0; j < SPM; ++j) {
    const int c = c0 + j;
    if (c < c1) {
      uint32_t af[NM][PL][4];
      uint32_t bf[NM][NP][PL][4];
#pragma unroll
      for (int m = 0; m < NM; ++m) {
#pragma unroll
        for (int pl = 0; pl < PL; ++pl)
          ldmatrix_x4(af[m][pl], (m ? a1 : a0) + pl * a_pl + c * 32);
#pragma unroll
        for (int np = 0; np < NP; ++np)
#pragma unroll
          for (int pl = 0; pl < PL; ++pl)
            ldmatrix_x4(bf[m][np][pl],
                        (m ? b1 : b0) + pl * b_pl + np * 16 * RS + c * 32);
      }
#pragma unroll
      for (int np = 0; np < NP; ++np)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          slice_mma<PL>(acc0[2 * np + h], af[0], bf[0][np], h);
          if constexpr (TWO)
            slice_mma<PL>(acc1[2 * np + h], af[NM - 1], bf[NM - 1][np], h);
        }
    }
  }
}

// acc0[2 SPM][4] += X0 B0 and acc1 += X1 B1 over the column slices [c0,
// c1), interleaved: X the 16 x 16 NK values in the accumulators x0, x1 (as
// A fragments), B the 16 NK rows at b0, b1 (ldmatrix.trans, planes b_pl
// apart, a_lane included); accumulator tile 2 j + h covers columns
// 16 (c0 + j) + 8 h .. + 7.  With TWO false only acc0.
template <int PL, int NK, int SPM, int RS, bool TWO>
__device__ __forceinline__ void cols_product(float (&acc0)[2 * SPM][4],
                                             float (&acc1)[2 * SPM][4],
                                             const float (&x0)[2 * NK][4],
                                             const float (&x1)[2 * NK][4],
                                             uint32_t b0, uint32_t b1,
                                             int b_pl, int c0, int c1) {
  constexpr int NM = TWO ? 2 : 1;
#pragma unroll
  for (int kc = 0; kc < NK; ++kc) {
    uint32_t xa[NM][PL][4];
    acc_fragment<PL>(xa[0], x0[2 * kc], x0[2 * kc + 1]);
    if constexpr (TWO) acc_fragment<PL>(xa[NM - 1], x1[2 * kc], x1[2 * kc + 1]);
#pragma unroll
    for (int j = 0; j < SPM; ++j) {
      const int c = c0 + j;
      if (c < c1) {
        uint32_t bf[NM][PL][4];
#pragma unroll
        for (int m = 0; m < NM; ++m)
#pragma unroll
          for (int pl = 0; pl < PL; ++pl)
            ldmatrix_x4_trans(bf[m][pl], (m ? b1 : b0) + pl * b_pl +
                                             kc * 16 * RS + c * 32);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          slice_mma<PL>(acc0[2 * j + h], xa[0], bf[0], h);
          if constexpr (TWO)
            slice_mma<PL>(acc1[2 * j + h], xa[NM - 1], bf[NM - 1], h);
        }
      }
    }
  }
}

// With KP warps sharing 16 rows: every warp's partial S and dP (over its
// part of D) into shared memory, then each warp of the group sums the
// group's partials in part order (so all hold the same sums).  A barrier;
// the next step's top barrier frees `ex` again.
template <int NT, int KP>
__device__ __forceinline__ void sum_parts(float (&s)[NT][4], float (&g)[NT][4],
                                          float* ex, int warp, int lane) {
  constexpr int WS = 2 * NT * 4 * 32;          // floats a warp
  float* mine = ex + warp * WS;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mine[(nt * 4 + e) * 32 + lane] = s[nt][e];
      mine[((NT + nt) * 4 + e) * 32 + lane] = g[nt][e];
    }
  __syncthreads();
  const float* grp = ex + (warp / KP) * KP * WS;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float a = 0.f, c = 0.f;
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        a += grp[j * WS + (nt * 4 + e) * 32 + lane];
        c += grp[j * WS + ((NT + nt) * 4 + e) * 32 + lane];
      }
      s[nt][e] = a;
      g[nt][e] = c;
    }
}

__device__ __forceinline__ long long row_off(const Params& p, int b, int kvh,
                                             int r) {
  const int g = r / p.T, t = r - g * p.T;
  return ((long long)b * p.T + t) * p.H * p.D + (long long)(kvh * p.G + g) * p.D;
}
__device__ __forceinline__ long long key_off(const Params& p, int b, int kvh,
                                             int n) {
  return ((long long)b * p.S + n) * p.KV * p.D + (long long)kvh * p.D;
}

// Min and max of pos(i) for i in [lo, hi) over the warp (every lane gets
// them).
template <typename PosFn>
__device__ __forceinline__ int2 warp_minmax(int lo_i, int hi_i, PosFn pos) {
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = lo_i + (threadIdx.x & 31); i < hi_i; i += 32) {
    const int x = pos(i);
    lo = min(lo, x);
    hi = max(hi, x);
  }
  return make_int2(__reduce_min_sync(0xffffffffu, lo),
                   __reduce_max_sync(0xffffffffu, hi));
}

// The CTA's visit list: of n tiles of `tile` elements (element i < limit
// at position pos(i)), those holding a valid pair, in order, each with
// kFull if it needs no mask.  Key tiles are held against the CTA's query
// positions [own.x, own.y]; row tiles (key_tiles false) against its keys,
// `own_whole` if none lies past S.  Returns the list's length (barriers).
template <typename PosFn>
__device__ int visit_list(const Params& p, int n, int tile, int limit,
                          PosFn pos, bool key_tiles, int2 own, bool own_whole,
                          unsigned char* smem_list) {
  unsigned char* flags = smem_list;
  int* list = reinterpret_cast<int*>(smem_list + round16(n));
  int* count_s = reinterpret_cast<int*>(smem_list + round16(n) + round16(4 * n));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int j = warp; j < n; j += nw) {
    const int2 t = warp_minmax(j * tile, min(limit, (j + 1) * tile), pos);
    if (lane == 0)
      flags[j] = (unsigned char)(
          key_tiles ? tile_rule(own.x, own.y, t.x, t.y,
                                (j + 1) * tile <= limit, p.causal, p.window)
                    : tile_rule(t.x, t.y, own.x, own.y, own_whole, p.causal,
                                p.window));
  }
  __syncthreads();
  if (warp == 0) {                 // compact the tiles to visit, in order
    int c = 0;
    for (int base = 0; base < n; base += 32) {
      const int j = base + lane;
      const int f = j < n ? flags[j] : 0;
      const unsigned vote = __ballot_sync(0xffffffffu, f != 0);
      if (f) list[c + __popc(vote & ((1u << lane) - 1u))] = f == 2 ? j | kFull : j;
      c += __popc(vote);
    }
    if (lane == 0) *count_s = c;
  }
  __syncthreads();
  return *count_s;
}

// ---- (a) row statistics and the planes --------------------------------- //
// Grid (B x KV, ceil(M / R)), 2 R threads.
template <typename T, int C, int R>
__global__ void __launch_bounds__(2 * R, 1)
bwd_stats_kernel(const Params p) {
  using G = Geo<T, C>;
  constexpr int PL = G::kPl, RS = G::kRs, DM = G::kDM;
  constexpr int BN = G::kSN, W = R / 16;
  constexpr int NT = BN / 8;
  // a thread copies 4 columns (unit u4) of rows r4, r4 + RPP, ...
  constexpr int U4 = DM / 4, RPP = 2 * R / U4, UPT = BN / RPP;
  static_assert((2 * R) % U4 == 0 && BN % RPP == 0 && R % RPP == 0,
                "4-column copies");
  constexpr int O_K = PL * R * RS;                  // K planes
  constexpr int O_KPOS = O_K + PL * BN * RS;
  constexpr int O_LIST = O_KPOS + round16(4 * BN);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + O_K);
  int* kpos_s = reinterpret_cast<int*>(smem + O_KPOS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bkv = blockIdx.x, b = bkv / p.KV, kvh = bkv % p.KV;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * R;   // latest rows first
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* o = static_cast<const T*>(p.out);
  const T* dout = static_cast<const T*>(p.dout);

  const int2 own = warp_minmax(m0, min(m0 + R, p.M),
                               [&](int r) { return p.q_pos[r % p.T]; });
  const int count = visit_list(p, (p.S + BN - 1) / BN, BN, p.S,
                               [&](int i) { return p.k_pos[i]; }, true, own,
                               false, smem + O_LIST);
  const int* list = reinterpret_cast<const int*>(
      smem + O_LIST + round16((p.S + BN - 1) / BN));

  // Q rows into planes (here and in the scratch), dO into the scratch,
  // delta = rowsum(dO * O): thread (u4, r4) takes 4 columns of rows r4,
  // r4 + RPP, ...; a row's dot products are summed over its U4 threads by
  // shuffles and, past a warp, in shared memory (over the K planes' room)
  constexpr int SEG = U4 > 32 ? U4 / 32 : 1, LPS = U4 / SEG;
  float* dpart = reinterpret_cast<float*>(smem + O_K);      // [R][SEG]
  const int u4 = tid % U4, r4 = tid / U4;
  const long long q_plane = (long long)p.M * p.dp;
#pragma unroll 4
  for (int rl = r4; rl < R; rl += RPP) {
    const int r = m0 + rl;
    const bool ok = r < p.M;
    float4 xq = make_float4(0.f, 0.f, 0.f, 0.f), xg = xq, xo = xq;
    if (ok) {
      const long long off = row_off(p, b, kvh, r);
      xq = load4(q + off, 4 * u4, p.D, p.vec_rows);
      xg = load4(dout + off, 4 * u4, p.D, p.vec_rows);
      xo = load4(o + off, 4 * u4, p.D, p.vec_rows);
    }
    put4<PL>(qs + rl * (RS / 2) + 4 * u4, R * (RS / 2), xq);
    if (ok && 4 * u4 < p.dp) {
      const long long at = ((long long)bkv * PL * p.M + r) * p.dp + 4 * u4;
      put4<PL>(p.qp + at, q_plane, xq);
      put4<PL>(p.dop + at, q_plane, xg);
    }
    float dot = xo.x * xg.x;
    dot = fmaf(xo.y, xg.y, dot);
    dot = fmaf(xo.z, xg.z, dot);
    dot = fmaf(xo.w, xg.w, dot);
#pragma unroll
    for (int w = LPS / 2; w; w >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, w);
    if (u4 % LPS == 0) dpart[rl * SEG + u4 / LPS] = dot;
  }
  // this CTA's share of K and V into the scratch
  {
    const int per = (p.S + gridDim.y - 1) / gridDim.y;
    const int n_end = min(p.S, (int)blockIdx.y * per + per);
    const long long kv_plane = (long long)p.S * p.dp;
    if (4 * u4 < p.dp) {
#pragma unroll 4
      for (int n = blockIdx.y * per + r4; n < n_end; n += RPP) {
        const long long off = key_off(p, b, kvh, n);
        const long long at = ((long long)bkv * PL * p.S + n) * p.dp + 4 * u4;
        put4<PL>(p.kp + at, kv_plane, load4(k + off, 4 * u4, p.D, p.vec_k));
        put4<PL>(p.vp + at, kv_plane, load4(v + off, 4 * u4, p.D, p.vec_k));
      }
    }
  }
  __syncthreads();
  if (tid < R && m0 + tid < p.M) {
    float dsum = 0.f;
#pragma unroll
    for (int sg = 0; sg < SEG; ++sg) dsum += dpart[tid * SEG + sg];
    p.delta[(long long)bkv * p.M + m0 + tid] = dsum;
  }

  // K tiles: the next one is loaded into registers while this one is used
  float4 kx[UPT];
  int kpv = 0;
  auto fetch = [&](int j) {
    const int n0 = j * BN;
#pragma unroll
    for (int u = 0; u < UPT; ++u) {
      const int n = n0 + r4 + u * RPP;
      kx[u] = n < p.S ? load4(k + key_off(p, b, kvh, n), 4 * u4, p.D, p.vec_k)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (tid < BN) kpv = n0 + tid < p.S ? p.k_pos[n0 + tid] : 0;
  };
  if (count > 0) fetch(list[0] & ~kFull);

  // this thread's two rows: lane / 4 and lane / 4 + 8 of the warp's 16
  const int wr0 = m0 + warp * 16;
  int qpr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + (lane >> 2) + 8 * h;
    qpr[h] = r < p.M ? p.q_pos[r % p.T] : 0;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};          // this thread's columns; quad-summed
  const uint32_t q_a = sbase + warp * 16 * RS + a_lane<RS>(lane);
  const uint32_t k_b = sbase + O_K + b_lane<RS>(lane);
  const int nsl = p.dp / 16;
  for (int i = 0; i < count; ++i) {
    __syncthreads();                    // tile i - 1 consumed; Q stored
#pragma unroll
    for (int u = 0; u < UPT; ++u)
      put4<PL>(ks + (r4 + u * RPP) * (RS / 2) + 4 * u4, BN * (RS / 2), kx[u]);
    if (tid < BN) kpos_s[tid] = kpv;
    __syncthreads();
    const int entry = list[i];
    const int n0 = (entry & ~kFull) * BN;
    const bool full = entry & kFull;
    if (i + 1 < count) fetch(list[i + 1] & ~kFull);

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    rows_product<PL, NT / 2, G::kSl, RS, false>(s, s, q_a, q_a, R * RS, k_b,
                                                k_b, BN * RS, 0, nsl);
    // scores in the log2 domain, -inf where masked (the pair tests only
    // where the tile needs them: a branch uniform over the CTA)
    auto scores = [&](auto masked) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bool ok = true;
            if constexpr (decltype(masked)::value) {
              const int c = nt * 8 + 2 * (lane & 3) + e;
              ok = n0 + c < p.S &&
                   pair_ok(qpr[h], kpos_s[c], p.causal, p.window);
            }
            float& x = s[nt][2 * h + e];
            x = ok ? x * p.scale_log2 : -INFINITY;
          }
    };
    if (full)
      scores(std::false_type());
    else
      scores(std::true_type());
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      // a row with nothing valid yet keeps m = -inf and its sum 0
      const float base = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) sum += ex2(s[nt][2 * h + e] - base);
      l_run[h] = l_run[h] * ex2(m_run[h] - base) + sum;
      m_run[h] = m_new;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = wr0 + (lane >> 2) + 8 * h;
    if ((lane & 3) == 0 && r < p.M)
      p.lse[(long long)bkv * p.M + r] = l > 0.f ? m_run[h] + log2f(l) : INFINITY;
  }
}

// ---- (b) dK and dV ------------------------------------------------------ //
// Grid (B x KV, key tiles x n_split): key tile blockIdx.y / n_split, row
// chunk blockIdx.y % n_split; 32 W threads.
template <typename T, int C>
__global__ void __launch_bounds__((32 * Geo<T, C>::kKW), 1)
bwd_dkdv_kernel(const Params p) {
  using G = Geo<T, C>;
  constexpr int PL = G::kPl, RS = G::kRs, UPR = G::kUpr;
  constexpr int W = G::kKW, KP = G::kKP, BN = G::kKN, BM = G::kKM;
  constexpr int NT = BM / 8, SPM = (G::kSl + KP - 1) / KP;
  constexpr int STAGE = dkdv_stage<T, C>();
  constexpr int O_KPOS = 2 * PL * BN * RS;
  constexpr int O_RING = O_KPOS + round16(4 * BN);
  constexpr int O_EXCH = dkdv_exch<T, C>();
  constexpr int O_LIST = dkdv_fixed<T, C>();
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kb = warp / KP, part = warp % KP;    // 16 keys, part of D
  const int bkv = blockIdx.x, b = bkv / p.KV, kvh = bkv % p.KV;
  const int sp = blockIdx.y % p.n_split;
  const int n0 = blockIdx.y / p.n_split * BN;
  const int c0 = sp * p.chunk, c1 = min(c0 + p.chunk, p.M);
  const int n_steps = (c1 - c0 + BM - 1) / BM;

  const int2 own = warp_minmax(n0, min(n0 + BN, p.S),
                               [&](int n) { return p.k_pos[n]; });
  const int count = visit_list(p, n_steps, BM, c1 - c0,
                               [&](int i) { return p.q_pos[(c0 + i) % p.T]; },
                               false, own, n0 + BN <= p.S, smem + O_LIST);
  const int* list = reinterpret_cast<const int*>(smem + O_LIST + round16(n_steps));

  // K and V planes of the CTA's keys, and their positions; zero past S
  for (int i = tid; i < 2 * PL * BN * UPR; i += blockDim.x) {
    const int u = i % UPR, rr = i / UPR;
    if (u * 8 < p.dp) {
      const int pl = rr / BN % PL, key = n0 + rr % BN;
      const bool ok = key < p.S;
      const __nv_bfloat16* src = (rr < PL * BN ? p.kp : p.vp) +
          (((long long)bkv * PL + pl) * p.S + (ok ? key : 0)) * p.dp + u * 8;
      cp_async16(sbase + rr * RS + u * 16, src, ok ? 16 : 0);
    }
  }
  for (int i = tid; i < BN; i += blockDim.x) {
    const bool ok = n0 + i < p.S;
    cp_async4(sbase + O_KPOS + 4 * i, p.k_pos + (ok ? n0 + i : 0), ok ? 4 : 0);
  }
  // step i of the walk: Q and dO planes of its BM rows, their positions,
  // lse and delta (rows past M zero: they add nothing); a thread copies
  // unit lu of rows lr, lr + LR, ... of each plane
  constexpr int LR = 32 * W / UPR;
  static_assert(BM % LR == 0, "ring copy");
  const int lu = tid % UPR, lr = tid / UPR;
  const long long plane = (long long)p.M * p.dp;
  const __nv_bfloat16* q_src = p.qp + bkv * PL * plane + lu * 8;
  const __nv_bfloat16* g_src = p.dop + bkv * PL * plane + lu * 8;
  auto load_step = [&](int i, int st) {
    const int m0 = c0 + (list[i] & ~kFull) * BM;
    const uint32_t base = sbase + O_RING + st * STAGE;
    if (lu * 8 < p.dp) {
#pragma unroll
      for (int t = 0; t < 2 * PL; ++t)
#pragma unroll
        for (int r = 0; r < BM; r += LR) {
          const int row = m0 + lr + r;
          const bool ok = row < p.M;
          cp_async16(base + (t * BM + lr + r) * RS + lu * 16,
                     (t < PL ? q_src : g_src) + (t % PL) * plane +
                         (long long)(ok ? row : 0) * p.dp,
                     ok ? 16 : 0);
        }
    }
    for (int x = tid; x < BM; x += blockDim.x) {
      const int row = m0 + x;
      const bool ok = row < p.M;
      const long long at = ok ? (long long)bkv * p.M + row : 0;
      const uint32_t d = base + 2 * PL * BM * RS + 4 * x;
      cp_async4(d, p.q_pos + (ok ? row % p.T : 0), ok ? 4 : 0);
      cp_async4(d + 4 * BM, p.lse + at, ok ? 4 : 0);
      cp_async4(d + 8 * BM, p.delta + at, ok ? 4 : 0);
    }
  };
  if (count > 0) load_step(0, 0);
  cp_async_commit();

  const int nsl = p.dp / 16, spp = (nsl + KP - 1) / KP;
  const int sa = part * spp, sb = min(nsl, sa + spp);  // this warp's slices
  float acc_k[2 * SPM][4], acc_v[2 * SPM][4];
#pragma unroll
  for (int j = 0; j < 2 * SPM; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;
  const uint32_t a_k = sbase + kb * 16 * RS + a_lane<RS>(lane);
  const uint32_t a_v = a_k + PL * BN * RS;
  const int* kpos_s = reinterpret_cast<const int*>(smem + O_KPOS);
  float* ex = reinterpret_cast<float*>(smem + O_EXCH);
  const int kl0 = kb * 16 + (lane >> 2);           // this thread's keys
  for (int i = 0; i < count; ++i) {
    cp_async_wait_all();
    __syncthreads();                    // step i landed; step i - 1 consumed
    if (i + 1 < count) load_step(i + 1, (i + 1) % kStages);
    cp_async_commit();
    const int entry = list[i];
    const bool full = entry & kFull;
    const int m0 = c0 + (entry & ~kFull) * BM;
    const int st = O_RING + (i % kStages) * STAGE;
    const uint32_t q_rows = sbase + st;
    const uint32_t g_rows = q_rows + PL * BM * RS;
    const int* qpos_s = reinterpret_cast<const int*>(smem + st + 2 * PL * BM * RS);
    const float* lse_s = reinterpret_cast<const float*>(qpos_s + BM);
    const float* dlt_s = lse_s + BM;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BM rows
    float s[NT][4], g[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = g[nt][e] = 0.f;
    rows_product<PL, NT / 2, SPM, RS, true>(
        s, g, a_k, a_v, BN * RS, q_rows + b_lane<RS>(lane),
        g_rows + b_lane<RS>(lane), BM * RS, sa, sb);
    if constexpr (KP > 1) sum_parts<NT, KP>(s, g, ex, warp, lane);
    // P^T and dS^T = P^T (dP^T - delta); the pair tests only where the
    // step needs them (a branch uniform over the CTA)
    auto probs = [&](auto masked) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = nt * 8 + 2 * (lane & 3);
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 dl = *reinterpret_cast<const float2*>(dlt_s + c);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bool ok = true;
            if constexpr (decltype(masked)::value) {
              const int kl = kl0 + 8 * h;
              ok = n0 + kl < p.S && m0 + c + e < p.M &&
                   pair_ok(qpos_s[c + e], kpos_s[kl], p.causal, p.window);
            }
            float& x = s[nt][2 * h + e];
            const float pr = ok ? ex2(x * p.scale_log2 - (e ? ls.y : ls.x)) : 0.f;
            g[nt][2 * h + e] = pr * (g[nt][2 * h + e] - (e ? dl.y : dl.x));
            x = pr;
          }
      }
    };
    if (full)
      probs(std::false_type());
    else
      probs(std::true_type());
    // dV += P^T dO and dK += dS^T Q over this warp's columns
    cols_product<PL, NT / 2, SPM, RS, true>(
        acc_v, acc_k, s, g, g_rows + a_lane<RS>(lane),
        q_rows + a_lane<RS>(lane), BM * RS, sa, sb);
  }
  cp_async_wait_all();

  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + kl0 + 8 * h;
    if (n >= p.S) continue;
    const long long off = key_off(p, b, kvh, n);
#pragma unroll
    for (int j = 0; j < SPM; ++j) {
      if (sa + j >= sb) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = (sa + j) * 16 + hf * 8 + 2 * (lane & 3) + e;
          if (col >= p.D) continue;
          const float xk = acc_k[2 * j + hf][2 * h + e];
          const float xv = acc_v[2 * j + hf][2 * h + e];
          if (p.n_split == 1) {
            dk[off + col] = from_f32<T>(xk * p.scale);
            dv[off + col] = from_f32<T>(xv);
          } else {
            const long long at = sp * p.n_out + off + col;
            p.part_k[at] = xk;
            p.part_v[at] = xv;
          }
        }
    }
  }
}

// ---- (c) dQ, and dK, dV from the chunks' partials ------------------------ //
// Grid (B x KV, ceil(M / R)), 32 W threads.
template <typename T, int C>
__global__ void __launch_bounds__((32 * Geo<T, C>::kQW), 1)
bwd_dq_kernel(const Params p) {
  using G = Geo<T, C>;
  constexpr int PL = G::kPl, RS = G::kRs, UPR = G::kUpr;
  constexpr int W = G::kQW, KP = G::kQP, R = G::kQR, BN = G::kQN;
  constexpr int NT = BN / 8, SPM = (G::kSl + KP - 1) / KP;
  constexpr int STAGE = dq_stage<T, C>();
  constexpr int O_LSE = 2 * PL * R * RS;
  constexpr int O_RING = dq_ring<T, C>();
  constexpr int O_EXCH = dq_exch<T, C>();
  constexpr int O_LIST = dq_fixed<T, C>();
  static_assert(W * 32 >= R, "a thread for each row's statistics");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rb = warp / KP, part = warp % KP;    // 16 rows, part of D
  const int bkv = blockIdx.x, b = bkv / p.KV, kvh = bkv % p.KV;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * R;   // latest rows first
  const int n_kt = (p.S + BN - 1) / BN;

  if (p.n_split > 1) {            // dK, dV: the chunks' sums in chunk order
    T* dk = static_cast<T*>(p.dk);
    T* dv = static_cast<T*>(p.dv);
    const long long ctas = (long long)gridDim.x * gridDim.y;
    const long long per = (p.n_out + ctas - 1) / ctas;
    const long long at = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * per;
    const long long end = min(p.n_out, at + per);
    for (long long e = at + tid; e < end; e += blockDim.x) {
      float xk = 0.f, xv = 0.f;
      for (int sp = 0; sp < p.n_split; ++sp) {
        xk += p.part_k[sp * p.n_out + e];
        xv += p.part_v[sp * p.n_out + e];
      }
      dk[e] = from_f32<T>(xk * p.scale);
      dv[e] = from_f32<T>(xv);
    }
  }

  const int2 own = warp_minmax(m0, min(m0 + R, p.M),
                               [&](int r) { return p.q_pos[r % p.T]; });
  const int count = visit_list(p, n_kt, BN, p.S,
                               [&](int i) { return p.k_pos[i]; }, true, own,
                               false, smem + O_LIST);
  const int* list = reinterpret_cast<const int*>(smem + O_LIST + round16(n_kt));

  // the CTA's rows: Q and dO planes, lse and delta (zero past M)
  for (int x = tid; x < 2 * PL * R * UPR; x += blockDim.x) {
    const int u = x % UPR, rr = x / UPR;
    if (u * 8 < p.dp) {
      const int pl = rr / R % PL, row = m0 + rr % R;
      const bool ok = row < p.M;
      const __nv_bfloat16* src = (rr < PL * R ? p.qp : p.dop) +
          (((long long)bkv * PL + pl) * p.M + (ok ? row : 0)) * p.dp + u * 8;
      cp_async16(sbase + rr * RS + u * 16, src, ok ? 16 : 0);
    }
  }
  if (tid < R) {
    const bool ok = m0 + tid < p.M;
    const long long at = ok ? (long long)bkv * p.M + m0 + tid : 0;
    cp_async4(sbase + O_LSE + 4 * tid, p.lse + at, ok ? 4 : 0);
    cp_async4(sbase + O_LSE + 4 * R + 4 * tid, p.delta + at, ok ? 4 : 0);
  }
  // K tile j: K and V planes of its BN keys and their positions; a thread
  // copies unit lu of rows lr, lr + LR, ... of each plane
  constexpr int LR = 32 * W / UPR;
  static_assert(BN % LR == 0, "ring copy");
  const int lu = tid % UPR, lr = tid / UPR;
  const long long plane = (long long)p.S * p.dp;
  const __nv_bfloat16* k_src = p.kp + bkv * PL * plane + lu * 8;
  const __nv_bfloat16* v_src = p.vp + bkv * PL * plane + lu * 8;
  auto load_tile = [&](int i, int st) {
    const int n0 = (list[i] & ~kFull) * BN;
    const uint32_t base = sbase + O_RING + st * STAGE;
    if (lu * 8 < p.dp) {
#pragma unroll
      for (int t = 0; t < 2 * PL; ++t)
#pragma unroll
        for (int r = 0; r < BN; r += LR) {
          const int key = n0 + lr + r;
          const bool ok = key < p.S;
          cp_async16(base + (t * BN + lr + r) * RS + lu * 16,
                     (t < PL ? k_src : v_src) + (t % PL) * plane +
                         (long long)(ok ? key : 0) * p.dp,
                     ok ? 16 : 0);
        }
    }
    for (int x = tid; x < BN; x += blockDim.x) {
      const bool ok = n0 + x < p.S;
      cp_async4(base + 2 * PL * BN * RS + 4 * x, p.k_pos + (ok ? n0 + x : 0),
                ok ? 4 : 0);
    }
  };
  if (count > 0) load_tile(0, 0);
  cp_async_commit();

  const int nsl = p.dp / 16, spp = (nsl + KP - 1) / KP;
  const int sa = part * spp, sb = min(nsl, sa + spp);  // this warp's slices
  const int rl0 = rb * 16 + (lane >> 2);               // this thread's rows
  int qpr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + rl0 + 8 * h;
    qpr[h] = r < p.M ? p.q_pos[r % p.T] : 0;
  }
  float lse_r[2] = {0.f, 0.f}, dlt_r[2] = {0.f, 0.f};
  float acc[2 * SPM][4];
#pragma unroll
  for (int j = 0; j < 2 * SPM; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const uint32_t a_q = sbase + rb * 16 * RS + a_lane<RS>(lane);
  const uint32_t a_g = a_q + PL * R * RS;
  float* ex = reinterpret_cast<float*>(smem + O_EXCH);
  for (int i = 0; i < count; ++i) {
    cp_async_wait_all();
    __syncthreads();                    // tile i landed; tile i - 1 consumed
    if (i == 0) {
      const float* lse_s = reinterpret_cast<const float*>(smem + O_LSE);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lse_r[h] = lse_s[rl0 + 8 * h];
        dlt_r[h] = lse_s[R + rl0 + 8 * h];
      }
    }
    if (i + 1 < count) load_tile(i + 1, (i + 1) % kStages);
    cp_async_commit();
    const int entry = list[i];
    const bool full = entry & kFull;
    const int n0 = (entry & ~kFull) * BN;
    const int st = O_RING + (i % kStages) * STAGE;
    const uint32_t k_rows = sbase + st;
    const uint32_t v_rows = k_rows + PL * BN * RS;
    const int* kpos_s = reinterpret_cast<const int*>(smem + st + 2 * PL * BN * RS);

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x BN keys
    float s[NT][4], g[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = g[nt][e] = 0.f;
    rows_product<PL, NT / 2, SPM, RS, true>(
        s, g, a_q, a_g, R * RS, k_rows + b_lane<RS>(lane),
        v_rows + b_lane<RS>(lane), BN * RS, sa, sb);
    if constexpr (KP > 1) sum_parts<NT, KP>(s, g, ex, warp, lane);
    // dS = P (dP - delta); the pair tests only where the tile needs them
    // (a branch uniform over the CTA)
    auto dsoft = [&](auto masked) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bool ok = true;
            if constexpr (decltype(masked)::value) {
              const int c = nt * 8 + 2 * (lane & 3) + e;
              ok = m0 + rl0 + 8 * h < p.M && n0 + c < p.S &&
                   pair_ok(qpr[h], kpos_s[c], p.causal, p.window);
            }
            const float pr =
                ok ? ex2(s[nt][2 * h + e] * p.scale_log2 - lse_r[h]) : 0.f;
            g[nt][2 * h + e] = pr * (g[nt][2 * h + e] - dlt_r[h]);
          }
    };
    if (full)
      dsoft(std::false_type());
    else
      dsoft(std::true_type());
    // dQ += dS K over this warp's columns
    cols_product<PL, NT / 2, SPM, RS, false>(acc, acc, g, g,
                                             k_rows + a_lane<RS>(lane),
                                             k_rows, BN * RS, sa, sb);
  }
  cp_async_wait_all();

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + rl0 + 8 * h;
    if (r >= p.M) continue;
    const long long off = row_off(p, b, kvh, r);
#pragma unroll
    for (int j = 0; j < SPM; ++j) {
      if (sa + j >= sb) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = (sa + j) * 16 + hf * 8 + 2 * (lane & 3) + e;
          if (col < p.D)
            dq[off + col] = from_f32<T>(acc[2 * j + hf][2 * h + e] * p.scale);
        }
    }
  }
}

template <typename T, int C>
cudaError_t launch(const Params& p, int B, int stats_rows, int smem_a,
                   int smem_b, int smem_c, cudaStream_t st) {
  using G = Geo<T, C>;
  constexpr int SR = G::kSR, SR2 = G::kSR / 2;
  const int stats_tiles = (p.M + stats_rows - 1) / stats_rows;
  const int dq_tiles = (p.M + G::kQR - 1) / G::kQR;
  const long long key_tiles = (long long)(p.S + G::kKN - 1) / G::kKN * p.n_split;
  const int stats_list = list_bytes((p.S + G::kSN - 1) / G::kSN);
  if ((stats_rows != SR && stats_rows != SR2) ||
      p.chunk < G::kKM || p.chunk % G::kKM ||
      p.n_split != (p.M + p.chunk - 1) / p.chunk ||
      smem_a != (stats_rows == SR ? stats_fixed<T, C, SR>()
                                  : stats_fixed<T, C, SR2>()) + stats_list ||
      smem_b != dkdv_fixed<T, C>() + list_bytes(p.chunk / G::kKM) ||
      smem_c != dq_fixed<T, C>() + list_bytes((p.S + G::kQN - 1) / G::kQN) ||
      smem_a > kMaxSmem || smem_b > kMaxSmem || smem_c > kMaxSmem ||
      stats_tiles > 65535 || dq_tiles > 65535 || key_tiles > 65535 ||
      (long long)p.KV * B > INT_MAX)
    return cudaErrorInvalidValue;
  // every KV head's longest CTAs first
  const dim3 stats_grid(p.KV * B, stats_tiles);
  if (stats_rows == SR)
    bwd_stats_kernel<T, C, SR><<<stats_grid, 2 * SR, smem_a, st>>>(p);
  else
    bwd_stats_kernel<T, C, SR2><<<stats_grid, 2 * SR2, smem_a, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 key_grid(p.KV * B, (int)key_tiles);
  bwd_dkdv_kernel<T, C><<<key_grid, 32 * G::kKW, smem_b, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 row_grid(p.KV * B, dq_tiles);
  bwd_dq_kernel<T, C><<<row_grid, 32 * G::kQW, smem_c, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_class(const Params& p, int B, int rows, int sa, int sb,
                         int sc, cudaStream_t st) {
  if (p.D <= kDMax[0]) return launch<T, 0>(p, B, rows, sa, sb, sc, st);
  if (p.D <= kDMax[1]) return launch<T, 1>(p, B, rows, sa, sb, sc, st);
  return launch<T, 2>(p, B, rows, sa, sb, sc, st);
}

template <typename T, int C>
cudaError_t set_class_limits() {
  using G = Geo<T, C>;
  const void* fns[4] = {(const void*)bwd_stats_kernel<T, C, G::kSR>,
                        (const void*)bwd_stats_kernel<T, C, G::kSR / 2>,
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
// scratch, planes bf16 scratch (2 B KV PL (H / KV T + S) dp values, PL = 3
// in f32 and 1 in bf16, dp = D rounded up to 16), partials f32 scratch of
// 2 n_split B S KV D values (unused at n_split = 1), all contiguous on the
// current device.  The plan: the statistics' rows a CTA (kStatsRows or half
// of it), n_split chunks of `chunk` query rows for the dK/dV grid; smem_*:
// the dynamic shared memory of the stats, dK/dV and dQ kernels, which must
// equal the layouts' sums (ops.py plan_flash_bwd).
// Three launches on `stream`.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* k_pos, const void* out, const void* d_out, void* dq,
    void* dk, void* dv, void* lse, void* delta, void* planes, void* partials,
    int B, int T, int S, int H, int KV, int D, int causal, int window,
    int dtype, int stats_rows, int n_split, int chunk, int smem_a,
    int smem_b, int smem_c, void* stream) {
  if (B < 1 || T < 1 || S < 1 || KV < 1 || H % KV != 0 || D < 1 ||
      D > kMaxHeadDim || B > 65535 || KV > 65535 || n_split < 1 ||
      chunk < 1 || (n_split > 1 && partials == nullptr) ||
      (long long)(H / KV) * T > INT_MAX / 2 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int pl = dtype == 0 ? 3 : 1;
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
  p.dp = (D + 15) / 16 * 16;
  const long long rows = (long long)B * KV * pl * p.M * p.dp;
  const long long keys = (long long)B * KV * pl * S * p.dp;
  p.qp = static_cast<__nv_bfloat16*>(planes);
  p.dop = p.qp + rows;
  p.kp = p.dop + rows;
  p.vp = p.kp + keys;
  p.n_out = (long long)B * S * KV * D;
  p.part_k = static_cast<float*>(partials);
  p.part_v = n_split > 1 ? p.part_k + n_split * p.n_out : nullptr;
  p.causal = causal != 0;
  p.window = window;
  p.n_split = n_split;
  p.chunk = chunk;
  // 4 values a load: D a multiple of 4 and every base aligned to them
  const uintptr_t mask = 4 * (dtype == 0 ? 4 : 2) - 1;
  auto aligned = [mask](const void* x) {
    return (reinterpret_cast<uintptr_t>(x) & mask) == 0;
  };
  p.vec_rows = D % 4 == 0 && aligned(q) && aligned(out) && aligned(d_out);
  p.vec_k = D % 4 == 0 && aligned(k) && aligned(v);
  p.scale = (float)(1.0 / sqrt((double)D));
  p.scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_class<float>(p, B, stats_rows, smem_a, smem_b, smem_c,
                                    st);
  return (int)launch_class<__nv_bfloat16>(p, B, stats_rows, smem_a, smem_b,
                                          smem_c, st);
}
