// Blocked online-softmax (flash) attention for prefill, GQA-native, on the
// tensor cores.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention
//   (Pallas body _flash_kernel).  The JAX model computes the same function
//   with einsums (models/layers/attention.py, full-sequence branch); the
//   port's prefill runs it once per layer for every prompt.
//
// What bounds it on the H100 SXM (data sheet at its 700 W limit: 3.35 TB/s
//   of HBM, 989 TFLOP/s of bf16 on the tensor cores): at the serving shape
//   (T = 16, H = 14, KV = 2, D = 64) neither: it moves about 130 KB and
//   does 0.5 Mflop, so a launch and two round trips to memory set its time.
//   Long prompts are bound by operations (T = 1024 at the same heads does
//   1.9 Gflop of causal attention on 1 MB), short prompts at wide heads by
//   bytes.
//
// What the design does about it:
//   - Grid (KV x B, row tiles): a CTA owns `rows` (16 a warp, 64 or 128) of
//     the M = G x T rows of one KV head, row r being (query head g = r / T
//     of the group, token t = r % T).  So every K/V tile it loads serves all
//     G query heads of the group, and a T = 16 prompt at G = 7 fills 112 rows
//     instead of 7 tiles of 16.  Row tiles run latest first, those of all KV
//     heads and batch rows side by side, so the CTAs with the most K tiles
//     under a causal mask start first.  At the 64 width class, where a
//     prompt spans several K tiles on a grid of at most a CTA an SM, the CTA
//     has two key groups of warps over the same rows: group g walks visits
//     g, g + 2, ... of the K tiles, and group 1's (m, l, O) merge into group
//     0's through shared memory at the end, which halves the longest CTA's
//     walk and doubles the threads that copy.  ops.py plan_flash picks rows
//     and key groups from the shapes (PERF.md has the measurements).
//   - Tiles that hold no valid pair are never loaded.  Before the walk each
//     warp takes the min and max of some K tiles' positions (coalesced, a
//     warp reduction) and compares them with the min and max of the CTA's
//     query positions: a causal tile is skipped when kp_min > qp_max, or,
//     with a window, when kp_max <= qp_min - window; it needs no per-pair
//     mask when every pair is valid.  Positions are arbitrary integers and
//     the rule holds for any order; sorted ones only make it skip more.  A
//     warp then compacts the tiles to visit into a list in shared memory;
//     the decision is made before a tile is loaded, which is why it is not
//     taken from the tile's staged positions.  The list keeps the branch
//     uniform over the CTA.
//   - Tensor cores: mma.sync.m16n8k16 bf16 x bf16 -> f32, fragments by
//     ldmatrix.  S = Q K^T and the O accumulator stay in registers in the
//     FlashAttention-2 arrangement: each warp owns 16 rows, the S
//     accumulator fragments of two adjacent 8-key tiles are the A fragment
//     of P V, row max and sum come from shuffles within a quad, and only
//     the tile's positions are read from shared memory for the mask.
//   - f32 to within 2e-5 from bf16 tensor cores: Q, K, V and P are split
//     into three bf16 pieces hi = bf16(x), mid = bf16(x - hi), lo = bf16(x
//     - hi - mid), which hold an f32 value exactly, and a product of two
//     bf16 values is exact in f32.  Each 16-deep slice (a 16-column chunk of
//     D for S, 16 keys for P V) takes six passes, the small ones first:
//     lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, then hi.hi; the dropped mid.lo,
//     lo.mid and lo.lo terms are below 2^-24 of each product.  The tensor
//     cores add into their accumulator with truncation, so each slice sums
//     from zero and is added to the running f32 sum with one rounded FADD
//     (the halo conv kernel's finding, PERF.md).  3xTF32 (hi/lo TF32 pairs,
//     three m16n8k8 products) costs the same tensor time per 16-deep slice
//     and keeps 2^-22 instead of 2^-24.  bf16 inputs take one pass, with P
//     rounded to bf16 (held to 2e-2).
//   - Loads: K/V tiles and their positions go through a ring of 2 or 3
//     stages (a tile for each key group) filled by 16-byte cp.async (cg: L2
//     only), zero-filled (src-size 0) past S and past D; each thread copies
//     one fixed 16-byte column unit of every few rows, with no division.
//     bf16 stays bf16 in shared memory and is read by ldmatrix as it
//     landed; an f32 tile lands as f32 and all threads split it into bf16
//     planes once (a second barrier a step, in f32 only).
//     D is padded with zeros to a multiple of 16 (exact), and the kernel
//     instance is picked by width class (64, 128, 256), so every D takes the
//     same path.  Rows are (class + 8) bf16 values apart: an odd number of
//     16-byte units, so each ldmatrix phase hits eight distinct bank groups.
//     A D or a base pointer that 16 bytes do not divide takes scalar loads
//     into the same layout.
//   - A row with no valid key so far keeps m = -inf; its exponentials are
//     then taken against 0 instead of m, so p = 0 and the rescale factor is
//     0 while its sums are still 0: exp(-inf - -inf) is never formed (the
//     key groups' merge does the same), and a row with no valid key at all
//     returns 0, as the model's masked_softmax does.
//   What it does not do yet: wgmma, TMA, a persistent grid, warp
//   specialisation.
//
// Types: f32 or bf16 in and out (the dtype of q); softmax and sums in f32.
// Launch: grid (KV x B, ceil(M / rows)), 2 x rows x key groups threads,
//   dynamic shared memory from layout(), which the wrapper's plan must match;
//   flash_attention_setup sets the kernels' shared-memory limit once per
//   device, before any launch or graph capture.  The C entry points
//   allocate nothing and return a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;          // 227 KB a CTA on the H100
constexpr int kMaxRows = 128;             // rows a CTA: 8 warps of 16
constexpr int kMaxHeadDim = 256;
// Width classes and, by dtype (f32, bf16) and class, keys a K tile and
// stages of the ring.  Same tables as ops.py D_CLASSES, TILE_KEYS, STAGES.
constexpr int kDMax[3] = {64, 128, 256};
constexpr int kBK[2][3] = {{32, 32, 16}, {64, 64, 32}};
constexpr int kStages[2][3] = {{2, 2, 2}, {3, 2, 2}};
constexpr int kFull = 1 << 30;            // visit-list flag: no mask needed

// Split pass q (of six) of three pieces x three: (A piece, B piece), the
// small products first: (2,0) (0,2) (1,1) (1,0) (0,1) (0,0).  Same order as
// ops.py PASSES.
__host__ __device__ constexpr int pass_a(int q) {
  return q == 0 ? 2 : q == 2 ? 1 : q == 3 ? 1 : 0;
}
__host__ __device__ constexpr int pass_b(int q) {
  return q == 1 ? 2 : q == 2 ? 1 : q == 4 ? 1 : 0;
}

template <typename T, int C>
struct Geo {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kDM = kDMax[C];
  static constexpr int kBKeys = kBK[kF32 ? 0 : 1][C];
  static constexpr int kSt = kStages[kF32 ? 0 : 1][C];
  static constexpr int kPl = kF32 ? 3 : 1;           // bf16 planes an operand
  static constexpr int kRs = (kDM + 8) * 2;          // bytes a bf16 row
  static constexpr int kRawRs = kF32 ? kDM * 4 : kRs;  // bytes a staged row
  static constexpr int kEpu = 16 / sizeof(T);        // elements a 16 B unit
  static constexpr int kUpr = kDM / kEpu;            // units a staged row
  static constexpr int kStage = 2 * kBKeys * kRawRs + kBKeys * 4;
  static constexpr int kPlanes = kF32 ? 6 * kBKeys * kRs : 0;
  static_assert(kBKeys % 16 == 0 && kDM % 16 == 0, "tile shape");
};

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Dynamic shared memory, in bytes from the base, every part 16-byte
// aligned: Q planes [kPl][rows][kRs]; the ring, kSt stages of ks tiles
// {K [BK][raw], V [BK][raw], k_pos [BK]} (with ks key groups, the merge's
// partials of group 1 later reuse it); in f32 the split tiles ks x {K [3][BK]
// [kRs], V [3][BK][kRs]}; the tile flags [n_kt] bytes; the visit list [n_kt]
// ints; its length.  Same sum as ops.py smem_bytes.
struct Layout {
  int ring, planes, flags, list, count, total;
};
template <typename T, int C>
__host__ __device__ Layout layout(int rows, int ks, int n_kt) {
  using G = Geo<T, C>;
  Layout L;
  L.ring = G::kPl * rows * G::kRs;
  const int ring = G::kSt * ks * G::kStage;
  const int merge = ks > 1 ? 2 * rows * (G::kDM / 2 + 4) * 4 : 0;
  L.planes = L.ring + (ring > merge ? ring : merge);
  L.flags = L.planes + ks * G::kPlanes;
  L.list = L.flags + round16(n_kt);
  L.count = L.list + round16(4 * n_kt);
  L.total = L.count + 16;
  return L;
}

struct Params {
  const void* q;          // [B, T, H, D]
  const void* k;          // [B, S, KV, D]
  const void* v;
  const int* q_pos;       // [T]
  const int* k_pos;       // [S]
  void* out;              // [B, T, H, D]
  int T, S, H, KV, D;
  int G;                  // H / KV
  int M;                  // G x T rows a KV head
  int dp;                 // D rounded up to 16
  int causal, window;
  int n_kt;               // K tiles: ceil(S / BK)
  int ks;                 // key groups: group g takes visits g, g + ks, ...
  int vec;                // 16-byte loads and paired stores
  float scale_log2;       // log2(e) / sqrt(D)
};

// 0: no pair of the tile is valid (skip it); 1: mask pair by pair; 2: every
// pair is valid.  `whole`: the tile holds BK keys (none past S).  Same rule
// as ops.py tile_rule.
__host__ __device__ inline int tile_rule(int qp_min, int qp_max, int kp_min,
                                         int kp_max, bool whole, int causal,
                                         int window) {
  if (!causal) return whole ? 2 : 1;
  if (kp_min > qp_max) return 0;
  if (window > 0 && kp_max <= qp_min - window) return 0;
  const bool all = kp_max <= qp_min && (window <= 0 || kp_min > qp_max - window);
  return whole && all ? 2 : 1;
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
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// The A fragment (16 rows x 16 keys) of P from the S accumulators of two
// adjacent 8-key tiles: as bf16, or as three bf16 pieces.
template <int PL>
__device__ __forceinline__ void p_fragment(uint32_t (&a)[PL][4],
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

// KS key groups: with one, every per-tile value is uniform over the CTA;
// with two, a warp's group comes from its index, so nothing that depends
// on the group's tile may guard ldmatrix or mma (their .aligned forms then
// cost a divergence check each): a ragged last tile is multiplied whole,
// its zero-filled keys masked.
template <typename T, int C, int KS>
__global__ void __launch_bounds__(kMaxRows * 2)
flash_attention_kernel(const Params p) {
  using G = Geo<T, C>;
  constexpr int BK = G::kBKeys;
  constexpr int ST = G::kSt;
  constexpr int PL = G::kPl;
  constexpr int RS = G::kRs;
  constexpr int RAW = G::kRawRs;
  constexpr int UPR = G::kUpr;
  constexpr int EPU = G::kEpu;
  constexpr int DM = G::kDM;
  constexpr int NT = BK / 8;                   // 8-key accumulator tiles
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;             // a multiple of UPR
  const int nwarps = nthreads >> 5;
  constexpr int ks = KS;
  const int gwarps = nwarps / ks;              // warps of a key group
  const int rows = gwarps * 16;                // 16 a warp
  const int grp = KS == 1 ? 0 : warp / gwarps;  // this warp's key group
  const int wl = warp - grp * gwarps;          // and its rows in the tile
  // row tiles latest first (causal work grows with t), all KV heads and
  // batch rows of one row tile next to each other
  const int m0 = (gridDim.y - 1 - blockIdx.y) * rows;
  const int m_end = min(m0 + rows, p.M);
  const int kvh = blockIdx.x % p.KV;
  const int b = blockIdx.x / p.KV;
  const Layout L = layout<T, C>(rows, ks, p.n_kt);
  constexpr int TILE = G::kStage;              // bytes of a staged tile
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  // Each thread copies one 16-byte unit u of a row (a fixed column range)
  // for rows kk, kk + kstep, ...: the same pattern for Q, K and V.
  const int u = tid % UPR;
  const int kk = tid / UPR;
  const int kstep = nthreads / UPR;
  const bool u_live = u * EPU < p.dp;          // inside D padded to 16
  const bool u_data = u * EPU < p.D;           // else zero-filled

  // Q in bf16 by cp.async, with 16-byte rows: it lands with the first tile.
  if constexpr (!G::kF32) {
    if (p.vec && u_live) {
      for (int r = kk; r < rows; r += kstep) {
        const int gr = m0 + r;
        const bool ok = u_data && gr < p.M;
        const T* src = q;
        if (ok) {
          const int g = gr / p.T;
          const int t = gr - g * p.T;
          src += (((long long)b * p.T + t) * p.H + kvh * p.G + g) * p.D +
                 u * EPU;
        }
        cp_async16(sbase + r * RS + u * 16, src, ok ? 16 : 0);
      }
    }
  }

  // Q of f32 (split into three planes) or of rows 16 bytes do not divide:
  // a thread's rows rq, rq + rstep, ... in batches of QB, all loads of a
  // batch issued before the first is split.  The first batch is in flight
  // during the tile flags below, the rest while the first tiles load.
  constexpr int UQ = DM / 4;                   // groups of 4 columns
  constexpr int QB = 8;
  const bool q_sync = G::kF32 || !p.vec;
  const int uq = tid % UQ;
  const int rq = tid / UQ;
  const int rstep = nthreads / UQ;
  auto q_load = [&](int r0, float (&x)[QB][4]) {
#pragma unroll
    for (int n = 0; n < QB; ++n) {
      const int gr = m0 + r0 + n * rstep;
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
      if (uq * 4 < p.dp && r0 + n * rstep < rows && gr < p.M) {
        const int g = gr / p.T;
        const int t = gr - g * p.T;
        const T* row =
            q + (((long long)b * p.T + t) * p.H + kvh * p.G + g) * p.D;
        if (G::kF32 && p.vec) {
          const float4 f = *reinterpret_cast<const float4*>(row + uq * 4);
          x[n][0] = f.x; x[n][1] = f.y; x[n][2] = f.z; x[n][3] = f.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (uq * 4 + e < p.D) x[n][e] = to_f32(row[uq * 4 + e]);
        }
      }
    }
  };
  auto q_store = [&](int r0, const float (&x)[QB][4]) {
    if (uq * 4 >= p.dp) return;
#pragma unroll
    for (int n = 0; n < QB; ++n) {
      if (r0 + n * rstep >= rows) break;
      unsigned char* dst = smem + (r0 + n * rstep) * RS + uq * 8;
      if constexpr (PL == 3) {
        __nv_bfloat16 h[4], md[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split3(x[n][e], h[e], md[e], lo[e]);
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(pack(h[0], h[1]), pack(h[2], h[3]));
        *reinterpret_cast<uint2*>(dst + rows * RS) =
            make_uint2(pack(md[0], md[1]), pack(md[2], md[3]));
        *reinterpret_cast<uint2*>(dst + 2 * rows * RS) =
            make_uint2(pack(lo[0], lo[1]), pack(lo[2], lo[3]));
      } else {
        *reinterpret_cast<uint2*>(dst) = make_uint2(
            pack(__float2bfloat16_rn(x[n][0]), __float2bfloat16_rn(x[n][1])),
            pack(__float2bfloat16_rn(x[n][2]), __float2bfloat16_rn(x[n][3])));
      }
    }
  };
  float qx[QB][4];
  if (q_sync) q_load(rq, qx);

  // ---- which K tiles hold a valid pair for these rows ------------------- //
  // All loads of a warp are issued before the first is used: the query
  // positions of the CTA's rows (at most 4 a lane), then 4 K tiles at a time.
  int qp_min = INT_MAX, qp_max = INT_MIN;
  {
    int qv[kMaxRows / 32];
#pragma unroll
    for (int n = 0; n < kMaxRows / 32; ++n) {
      const int r = m0 + lane + 32 * n;
      qv[n] = r < m_end ? p.q_pos[r % p.T] : 0;
    }
#pragma unroll
    for (int n = 0; n < kMaxRows / 32; ++n)
      if (m0 + lane + 32 * n < m_end) {
        qp_min = min(qp_min, qv[n]);
        qp_max = max(qp_max, qv[n]);
      }
  }
  qp_min = __reduce_min_sync(0xffffffffu, qp_min);
  qp_max = __reduce_max_sync(0xffffffffu, qp_max);
  unsigned char* flags = smem + L.flags;
  int* list = reinterpret_cast<int*>(smem + L.list);
  int* count_s = reinterpret_cast<int*>(smem + L.count);
  constexpr int KPL = (BK + 31) / 32;          // positions a lane per tile
  for (int j0 = warp; j0 < p.n_kt; j0 += 4 * nwarps) {
    int kv_[4][KPL];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const int s = (j0 + n * nwarps) * BK + lane + 32 * c;
        const bool in = lane + 32 * c < BK && j0 + n * nwarps < p.n_kt &&
                        s < p.S;
        kv_[n][c] = in ? p.k_pos[s] : 0;
      }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = j0 + n * nwarps;
      if (j >= p.n_kt) break;                  // warp-uniform
      int kp_min = INT_MAX, kp_max = INT_MIN;
#pragma unroll
      for (int c = 0; c < KPL; ++c)
        if (lane + 32 * c < BK && j * BK + lane + 32 * c < p.S) {
          kp_min = min(kp_min, kv_[n][c]);
          kp_max = max(kp_max, kv_[n][c]);
        }
      kp_min = __reduce_min_sync(0xffffffffu, kp_min);
      kp_max = __reduce_max_sync(0xffffffffu, kp_max);
      if (lane == 0)
        flags[j] = (unsigned char)tile_rule(qp_min, qp_max, kp_min, kp_max,
                                            (j + 1) * BK <= p.S, p.causal,
                                            p.window);
    }
  }
  __syncthreads();
  if (warp == 0) {                 // compact the tiles to visit, in order
    int n = 0;
    for (int base = 0; base < p.n_kt; base += 32) {
      const int j = base + lane;
      const int f = j < p.n_kt ? flags[j] : 0;
      const unsigned vote = __ballot_sync(0xffffffffu, f != 0);
      if (f) list[n + __popc(vote & ((1u << lane) - 1u))] = f == 2 ? j | kFull : j;
      n += __popc(vote);
    }
    if (lane == 0) *count_s = n;
  }
  __syncthreads();
  const int count = *count_s;

  // ---- K/V tile j into stage st ----------------------------------------- //
  const long long kv_row = (long long)p.KV * p.D;      // elements a key
  const T* k_base = k + ((long long)b * p.S * p.KV + kvh) * p.D + u * EPU;
  const T* v_base = v + ((long long)b * p.S * p.KV + kvh) * p.D + u * EPU;
  auto load_tile = [&](int j, int st, int slot) {
    const int k0 = j * BK;
    const int stage = L.ring + (st * ks + slot) * TILE;
    if (p.vec) {
      if (u_live) {
        const uint32_t dst = sbase + stage + u * 16;
#pragma unroll 4
        for (int key = kk; key < BK; key += kstep) {
          const bool ok = u_data && k0 + key < p.S;
          const long long off = (k0 + key) * kv_row;
          cp_async16(dst + key * RAW, ok ? k_base + off : k, ok ? 16 : 0);
          cp_async16(dst + BK * RAW + key * RAW, ok ? v_base + off : v,
                     ok ? 16 : 0);
        }
      }
      if (tid < BK / 4) {
        const int left = p.S - k0 - 4 * tid;        // keys from this unit on
        const int bytes = left >= 4 ? 16 : left > 0 ? 4 * left : 0;
        cp_async16(sbase + stage + 2 * BK * RAW + 16 * tid,
                   p.k_pos + (bytes ? k0 + 4 * tid : 0), bytes);
      }
    } else {
      for (int i = tid; i < 2 * BK * p.dp; i += nthreads) {
        const int which = i / (BK * p.dp);
        const int rem = i - which * (BK * p.dp);
        const int key = rem / p.dp;
        const int d = rem - key * p.dp;
        const T* src = which ? v : k;
        T x = from_f32<T>(0.f);
        if (k0 + key < p.S && d < p.D)
          x = src[(((long long)b * p.S + k0 + key) * p.KV + kvh) * p.D + d];
        *reinterpret_cast<T*>(smem + stage + which * BK * RAW + key * RAW +
                              d * sizeof(T)) = x;
      }
      int* kp_s = reinterpret_cast<int*>(smem + stage + 2 * BK * RAW);
      for (int i = tid; i < BK; i += nthreads)
        kp_s[i] = k0 + i < p.S ? p.k_pos[k0 + i] : 0;
    }
  };

  // step i of the walk: visits i * ks + g, one a key group, into one stage
  const int n_steps = (count + ks - 1) / ks;
  auto load_step = [&](int i, int st) {
    for (int g = 0; g < ks; ++g)
      if (i * ks + g < count) load_tile(list[i * ks + g] & ~kFull, st, g);
  };
#pragma unroll
  for (int st = 0; st < ST - 1; ++st) {
    if (st < n_steps) load_step(st, st);
    cp_async_commit();
  }
  if (q_sync) q_store(rq, qx);

  if (q_sync) {                 // the rest of Q, loaded and split here
#pragma unroll 1
    for (int r0 = rq + QB * rstep; r0 < rows; r0 += QB * rstep) {
      float x[QB][4];
      q_load(r0, x);
      q_store(r0, x);
    }
  }

  // This thread's two rows: r0 = lane / 4 and r0 + 8 of the warp's 16.
  const int wr0 = m0 + wl * 16;
  const bool active = wr0 < p.M;
  int qpr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + (lane >> 2) + 8 * h;
    qpr[h] = r < p.M ? p.q_pos[r % p.T] : 0;
  }

  float o[DM / 8][4];
#pragma unroll
  for (int nd = 0; nd < DM / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};          // this thread's columns; quad-summed

  const uint32_t q_a = sbase + (wl * 16 + (lane & 15)) * RS + (lane >> 4) * 16;
  // ldmatrix row and unit offsets of this lane: K (not transposed) and V
  const uint32_t k_lane =
      ((lane & 7) + ((lane >> 4) << 3)) * RS + ((lane >> 3) & 1) * 16;
  const uint32_t v_lane = (lane & 15) * RS + (lane >> 4) * 16;
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<ST - 2>();
    __syncthreads();          // step i landed; step i - 1 fully consumed
    if (i + ST - 1 < n_steps) load_step(i + ST - 1, (i + ST - 1) % ST);
    cp_async_commit();

    const int visit = i * ks + grp;
    const int entry = visit < count ? list[visit] : 0;
    const int k0 = (entry & ~kFull) * BK;
    const bool full = entry & kFull;
    const int stage = L.ring + ((i % ST) * ks + grp) * TILE;
    uint32_t k_op = sbase + stage;
    uint32_t v_op = k_op + BK * RS;
    if constexpr (G::kF32) {
      // split the landed f32 tiles into bf16 planes: unit u of rows kk, ...
      if (u_live) {
        const unsigned char* src = smem + L.ring + (i % ST) * ks * TILE + u * 16;
        unsigned char* dst = smem + L.planes + u * 8;
        const int slots = min(ks, count - i * ks);   // tiles in the step
#pragma unroll 4
        for (int key = kk; key < 2 * BK * slots; key += kstep) {  // K, V
          const int slot = key / (2 * BK);
          const int which = (key / BK) & 1;
          const int kr = key % BK;
          const float4 f = *reinterpret_cast<const float4*>(
              src + slot * TILE + (key % (2 * BK)) * RAW);
          __nv_bfloat16 h[4], md[4], lo[4];
          split3(f.x, h[0], md[0], lo[0]);
          split3(f.y, h[1], md[1], lo[1]);
          split3(f.z, h[2], md[2], lo[2]);
          split3(f.w, h[3], md[3], lo[3]);
          unsigned char* d =
              dst + (slot * 2 + which) * 3 * BK * RS + kr * RS;
          *reinterpret_cast<uint2*>(d) =
              make_uint2(pack(h[0], h[1]), pack(h[2], h[3]));
          *reinterpret_cast<uint2*>(d + BK * RS) =
              make_uint2(pack(md[0], md[1]), pack(md[2], md[3]));
          *reinterpret_cast<uint2*>(d + 2 * BK * RS) =
              make_uint2(pack(lo[0], lo[1]), pack(lo[2], lo[3]));
        }
      }
      __syncthreads();        // the planes are whole
      k_op = sbase + L.planes + grp * 6 * BK * RS;
      v_op = k_op + 3 * BK * RS;
    }
    if (!active || visit >= count) continue;
    const int* kp_s = reinterpret_cast<const int*>(smem + stage + 2 * BK * RAW);
    // 16-key slices to multiply
    const int n_pairs = KS == 1 ? (min(BK, p.S - k0) + 15) / 16 : BK / 16;

    // S = Q K^T for 16 rows x BK keys; a chunk's fragments are all loaded
    // before its first product
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int c = 0; c < DM / 16; ++c) {
      if (c * 16 < p.dp) {
        uint32_t qa[PL][4];
        uint32_t kf[BK / 16][PL][4];
#pragma unroll
        for (int pl = 0; pl < PL; ++pl)
          ldmatrix_x4(qa[pl], q_a + pl * rows * RS + c * 32);
#pragma unroll
        for (int np = 0; np < BK / 16; ++np)
          if (np < n_pairs)
#pragma unroll
            for (int pl = 0; pl < PL; ++pl)
              ldmatrix_x4(kf[np][pl], k_op + pl * BK * RS + np * 16 * RS +
                                          k_lane + c * 32);
#pragma unroll
        for (int np = 0; np < BK / 16; ++np)
          if (np < n_pairs) {
            slice_mma<PL>(s[2 * np], qa, kf[np], 0);
            slice_mma<PL>(s[2 * np + 1], qa, kf[np], 1);
          }
      }
    }

    // mask, online softmax; s becomes P
    int kp[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int2 x = *reinterpret_cast<const int2*>(kp_s + nt * 8 +
                                                    2 * (lane & 3));
      kp[nt][0] = x.x;
      kp[nt][1] = x.y;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = nt * 8 + 2 * (lane & 3) + e;
          const int kq = kp[nt][e];
          const bool ok =
              full || (k0 + c < p.S &&
                       (!p.causal ||
                        (kq <= qpr[h] &&
                         (p.window <= 0 || kq > qpr[h] - p.window))));
          const float x = ok ? s[nt][2 * h + e] * p.scale_log2 : -INFINITY;
          s[nt][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      // a row with nothing valid yet keeps m = -inf: P = 0, sums stay 0
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = ex2(m_run[h] - base);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = ex2(s[nt][2 * h + e] - base);
          s[nt][2 * h + e] = pe;
          sum += pe;
        }
      m_run[h] = m_new;
      l_run[h] = l_run[h] * alpha + sum;
#pragma unroll
      for (int nd = 0; nd < DM / 8; ++nd) {
        o[nd][2 * h] *= alpha;
        o[nd][2 * h + 1] *= alpha;
      }
    }

    // O += P V; V fragments loaded VB column pairs at a time
    constexpr int VB = PL == 3 ? 2 : 4;
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      if (kc < n_pairs) {
        uint32_t pa[PL][4];
        p_fragment<PL>(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
        for (int d0 = 0; d0 < DM / 16; d0 += VB) {
          if (d0 * 16 < p.dp) {
            uint32_t vf[VB][PL][4];
#pragma unroll
            for (int dq = 0; dq < VB; ++dq)
              if ((d0 + dq) * 16 < p.dp)
#pragma unroll
                for (int pl = 0; pl < PL; ++pl)
                  ldmatrix_x4_trans(vf[dq][pl],
                                    v_op + pl * BK * RS + kc * 16 * RS +
                                        v_lane + (d0 + dq) * 32);
#pragma unroll
            for (int dq = 0; dq < VB; ++dq)
              if ((d0 + dq) * 16 < p.dp) {
                slice_mma<PL>(o[2 * (d0 + dq)], pa, vf[dq], 0);
                slice_mma<PL>(o[2 * (d0 + dq) + 1], pa, vf[dq], 1);
              }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // ---- key groups: group 1's partials merge into group 0's ------------- //
  if (KS > 1 && count > 1) {
    __syncthreads();                 // the ring is free
    float* part = reinterpret_cast<float*>(smem + L.ring);
    const int gt = nthreads / ks;    // threads a group; same rows, columns
    const int slot = tid - grp * gt;
    if (grp == 1) {
#pragma unroll
      for (int nd = 0; nd < DM / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[(nd * 4 + e) * gt + slot] = o[nd][e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        part[(DM / 2 + h) * gt + slot] = m_run[h];
        part[(DM / 2 + 2 + h) * gt + slot] = l_run[h];
      }
    }
    __syncthreads();
    if (grp == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m1 = part[(DM / 2 + h) * gt + slot];
        const float l1 = part[(DM / 2 + 2 + h) * gt + slot];
        const float m = fmaxf(m_run[h], m1);
        const float base = m == -INFINITY ? 0.f : m;
        const float a0 = ex2(m_run[h] - base);
        const float a1 = ex2(m1 - base);
        l_run[h] = l_run[h] * a0 + l1 * a1;
#pragma unroll
        for (int nd = 0; nd < DM / 8; ++nd)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            o[nd][2 * h + e] = o[nd][2 * h + e] * a0 +
                               part[(nd * 4 + 2 * h + e) * gt + slot] * a1;
      }
    }
  }
  if (KS > 1 && grp != 0) return;

  // ---- O / l into out[b, t, kvh * G + g, :] ------------------------------ //
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int r = wr0 + (lane >> 2) + 8 * h;
    if (!active || r >= p.M) continue;
    const int g = r / p.T;
    const int t = r - g * p.T;
    T* row = out + (((long long)b * p.T + t) * p.H + kvh * p.G + g) * p.D;
#pragma unroll
    for (int nd = 0; nd < DM / 8; ++nd) {
      const int d = nd * 8 + 2 * (lane & 3);
      if (d >= p.D) continue;
      const float v0 = o[nd][2 * h] * inv;
      const float v1 = o[nd][2 * h + 1] * inv;
      if (p.vec) {               // D is even: d + 1 < D
        if constexpr (G::kF32)
          *reinterpret_cast<float2*>(row + d) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(row + d) =
              __floats2bfloat162_rn(v0, v1);
      } else {
        row[d] = from_f32<T>(v0);
        if (d + 1 < p.D) row[d + 1] = from_f32<T>(v1);
      }
    }
  }
}

template <typename T, int C, int KS>
cudaError_t launch(Params p, int B, int rows, int smem, cudaStream_t st) {
  using G = Geo<T, C>;
  p.n_kt = (p.S + G::kBKeys - 1) / G::kBKeys;
  const int threads = 2 * rows * KS;
  const int row_tiles = (p.M + rows - 1) / rows;
  // each thread copies fixed 16-byte units: the threads cover whole rows
  if ((rows * 2) % (G::kDM / 4) != 0 || threads > 2 * kMaxRows ||
      row_tiles > 65535 || (long long)p.KV * B > INT_MAX ||
      layout<T, C>(rows, KS, p.n_kt).total != smem)
    return cudaErrorInvalidValue;
  const dim3 grid(p.KV * B, row_tiles, 1);
  flash_attention_kernel<T, C, KS><<<grid, threads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_class(const Params& p, int B, int rows, int smem,
                         cudaStream_t st) {
  if (p.D <= kDMax[0])
    return p.ks == 2 ? launch<T, 0, 2>(p, B, rows, smem, st)
                     : launch<T, 0, 1>(p, B, rows, smem, st);
  if (p.ks != 1) return cudaErrorInvalidValue;  // two groups: 64 class only
  if (p.D <= kDMax[1]) return launch<T, 1, 1>(p, B, rows, smem, st);
  return launch<T, 2, 1>(p, B, rows, smem, st);
}

template <typename T>
cudaError_t set_limits() {
  const void* fns[4] = {(const void*)flash_attention_kernel<T, 0, 1>,
                        (const void*)flash_attention_kernel<T, 0, 2>,
                        (const void*)flash_attention_kernel<T, 1, 1>,
                        (const void*)flash_attention_kernel<T, 2, 1>};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// Lets every instance use up to kMaxSmem of dynamic shared memory on the
// current device.  Call once per device, before the first launch and
// outside CUDA-graph capture.
extern "C" int flash_attention_setup() {
  cudaError_t err = set_limits<float>();
  if (err == cudaSuccess) err = set_limits<__nv_bfloat16>();
  return (int)err;
}

// dtype: 0 = float32, 1 = bfloat16.  q/out [B, T, H, D], k/v [B, S, KV, D],
// q_pos [T] and k_pos [S] int32, all contiguous on the current device.  The
// plan: rows a CTA (16 to 128, a multiple of 16) and its dynamic shared
// memory, which must equal layout() (ops.py plan_flash).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* q_pos,
                                      const void* k_pos, void* out, int B,
                                      int T, int S, int H, int KV, int D,
                                      int causal, int window, int dtype,
                                      int rows, int ks, int smem,
                                      void* stream) {
  if (B < 1 || T < 1 || S < 1 || KV < 1 || H % KV != 0 || D < 1 ||
      D > kMaxHeadDim || B > 65535 || KV > 65535 || rows < 16 ||
      rows > kMaxRows || rows % 16 != 0 || ks < 1 || ks > 2 || smem < 0 ||
      smem > kMaxSmem ||
      (long long)(H / KV) * T > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  const int esz = dtype == 0 ? 4 : 2;
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.q_pos = static_cast<const int*>(q_pos);
  p.k_pos = static_cast<const int*>(k_pos);
  p.out = out;
  p.T = T; p.S = S; p.H = H; p.KV = KV; p.D = D;
  p.G = H / KV;
  p.M = p.G * T;
  p.dp = (D + 15) / 16 * 16;
  p.causal = causal != 0;
  p.window = window;
  p.n_kt = 0;
  p.ks = ks;
  p.vec = (D * esz) % 16 == 0 && aligned16(q) && aligned16(k) &&
          aligned16(v) && aligned16(out) && aligned16(k_pos);
  p.scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_class<float>(p, B, rows, smem, st);
    case 1:
      return (int)launch_class<__nv_bfloat16>(p, B, rows, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
