// Backward of the sLSTM recurrence (slstm_scan.cu): a reverse scan over T
// steps, one thread-block cluster per (head, batch row).
//
// Replaces: nothing on the TPU.  The JAX package has no Pallas backward for
//   slstm_scan (src/repro/kernels/slstm_scan/kernel.py:71); its train step
//   differentiates lax.scan over _slstm_step
//   (src/repro/models/layers/xlstm.py:311).  This kernel is that gradient,
//   run by xLSTM's sLSTM layers once a layer a train step.
//
// The forward, in its saving mode, wrote every step's f32 pre-activations
// pre_t (gates i, f, z, o) and the state (c, n, m) after it.  Step t, per
// state column, with a = log_sigmoid(f~) + m_{t-1}, m_t = max(a, i~),
// i' = exp(i~ - m_t), f' = exp(a - m_t), u = f' n_{t-1} + i',
// n_t = max(u, 1e-6), h_t = sigmoid(o~) c_t / n_t, is undone in reverse from
// dh_t (the upstream gradient of h_t plus the recurrence's) and the carries
// dc, dn, dm of the later steps:
//   do~ = dh c_t / n_t * o (1 - o);  dc += dh o / n_t;  dn -= dh o c_t / n_t^2
//   du = dn [u > 1e-6] (half on a tie);  dz~ = dc i' (1 - tanh(z~)^2)
//   e_i = (dc tanh(z~) + du) i';  e_f = (dc c_{t-1} + du n_{t-1}) f'
//   dm_t = dm - e_i - e_f, routed by max(a, i~) (half to each on a tie):
//   di~ = e_i (+ dm_t), da = e_f (+ dm_t);  df~ = da sigmoid(-f~)
//   carries into step t-1: dc f', du f', dm_{t-1} = da
// and the recurrence's share of dh_{t-1}:
//   dh_{t-1}[k] = sum_g sum_j R[g, k, j] dpre_t[g, j]  (+ upstream dhs_{t-1})
// After step 0 the same product gives dh of the initial state.  The kernel
// writes dpre for every step and the initial state's gradient; dR
// (= h_{t-1}^T dpre over B x T) and db (the sum of dpre) are plain large
// reductions the wrapper leaves to torch.einsum and torch.sum, as the JAX
// package leaves them to XLA.
//
// What bounds it on the H100 SXM (data sheet at its 700 W limit: 3.35 TB/s
// of HBM, 67 TFLOP/s of f32 outside the tensor cores): the product's
// 2 * B * T * 4 * H * dh * dh flops (0.513 ms at xLSTM-1.3B's H=4, dh=512,
// B=1, T=4096), against the bytes of pre, c, n, m, dhs in and dpre out
// (about 0.1 ms there).  And, being a recurrence, T times the latency of
// one step: every column of dh_{t-1} needs the whole dpre_t of its head, so
// the head's CTAs exchange dpre once a step.  A step is a chain: wait for
// the peers' dpre, the product (bound by shared-memory reads of R^T and of
// dpre), the partial sums across the CTA, the gating, the sends.
//
// What the design does about it: the forward's design, transposed.
//   - One cluster of n_cta CTAs (16 at dh=512) per (head, batch row), grid
//     (n_cta, H, B).  CTA q owns state columns k in [q * cols, (q + 1) *
//     cols): their backward gating is local (the threads of column k hold
//     its carries dc, dn, dm in registers), and it sums dh_{t-1}[k] over all
//     j and gates itself.
//   - The wrapper hands the kernel R^T (rt[g][h][j][k] = R[g][h][k][j]), so
//     CTA q reads rows j of rt at its columns k exactly as the forward reads
//     rows k of R at its columns j: coalesced, 16-byte cp.async into shared
//     memory.  The product's thread (sub, group) sums kColsPer = 4 adjacent
//     columns over one of kSubs = 32 j subslices (16 rows at dh=512): a
//     quarter-warp covers the CTA's 32 columns over one subslice, so one
//     float4 load of dpre_t serves a warp four rows (one a quarter-warp, in
//     the 4 cycles a float4 load takes in any case), and each row's float4
//     feeds 16 fused multiply-adds: the product's shared-memory reads of
//     dpre are a quarter of what one column a thread would need.
//   - R^T stays on the chip for the whole call: each thread keeps the first
//     kRegRows rows of its subslice (4 gates x 4 columns a row) in
//     registers (two bf16 columns a word), the CTA the next ones in shared
//     memory (a float4 of 4 columns a gate, conflict-free), and only what
//     fits in neither (dh > 512, in the 512-thread build) is read from L2
//     every step.  The registers are free for rows because the step's
//     inputs wait in shared memory, not in registers:
//   - A step's inputs (the CTA's columns of pre's four gates, of c, n, m of
//     the step before and of dhs: eight contiguous runs, 1 KB at 32
//     columns) are staged kStages - 1 steps ahead in a ring in shared
//     memory by one thread of a product-only warp, with 1-D bulk copies
//     (cp.async.bulk, the TMA's linear mode) counted on one mbarrier a
//     stage.  The gating threads wait on that mbarrier and read shared
//     memory: no load from device memory is left in the step.  The
//     producer refills a stage right after the partial-sum barrier of the
//     next iteration, when every gating thread has read it.
//   - The gating that needs no dh_t (the exponentials, tanh, the new c and
//     n, both maxima's shares: most of its latency) runs at the top of the
//     iteration, while the peers' dpre is in flight, and waits in shared
//     memory; after the product only the chain from dh_t is left.
//   - dpre_t is exchanged in distributed shared memory: the four gate
//     gradients of a column are 16 contiguous bytes, sent with one
//     st.async.v4 to each peer and counted on the peer's mbarrier for that
//     buffer (16 * dh bytes a step), double-buffered as the forward's h.
//     Each thread of the product reads them as one broadcast float4 a row.
//   - The j range is cut into kSubs subslices that depend on dh alone;
//     a thread sums its subslice in j order with one accumulator a gate
//     and column, adds a column's four as (g0 + g1) + (g2 + g3), a shuffle
//     adds subslices 2k and 2k + 1, and the gating thread adds the 16 pair
//     sums in four runs of four in order, then the runs as
//     (r0 + r1) + (r2 + r3).  So every number is independent of n_cta and
//     of where R's rows live: two cluster sizes give bit-identical results,
//     and so do two runs.  No atomics and no global counters.
//   - The exchange's mbarrier is armed each step by the block's last
//     thread, which never touches device memory in the step: the arrive's
//     release semantics would make a thread with loads or stores in flight
//     wait for them first, and every thread waits on that arrive.
//
// Types: R in f32 or bf16 (as the forward took it), everything else f32.
//   The host plan (ops.py plan_scan(..., backward=True)) picks n_cta, cols
//   and the shared-memory rows per subslice; the launch checks them and the
//   dynamic shared memory against smem_bytes().  slstm_scan_bwd_setup sets
//   the function attributes once per device, before any launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSlices = 8;    // blocks of cols_pad threads: the block size
constexpr int kGaters = 4;    // the first ones gate: a warp a scheduler
constexpr int kSubs = 32;                        // j subslices; fixed by dh
constexpr int kColsPer = 4;   // adjacent columns a thread's product sums
static_assert(kSubs == 32, "the gating sums four runs of four pairs");
constexpr int kMaxCols = 64;                     // state columns a CTA owns
constexpr int kMaxCluster = 16;                  // non-portable above 8
// rows of its subslice (4 gates x kColsPer columns each) that a thread of
// the 256-thread build keeps in registers: 10 of 16 at dh=512, f32 or bf16
// (two columns a word); more spill (ptxas)
constexpr int kRegRows = 10;
constexpr int kStages = 8;     // steps of inputs in the ring, 7 staged ahead
constexpr int kRuns = 8;       // pre's 4 gates, c, n, m of t - 1, dhs of t
constexpr int kGated = 9;      // values a gating thread keeps for its dh_t
constexpr int kMaxDh = 1024;
constexpr int kMaxSmem = 232448;                 // 227 KB a CTA on the H100

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// log(sigmoid(x)) as the forward computes it.
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// d max(x, y) / dx as jnp.maximum: 1 where x > y, 1/2 on a tie.
__device__ __forceinline__ float max_share(float x, float y) {
  return x > y ? 1.f : (x == y ? 0.5f : 0.f);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// The shared::cluster address of a local shared address in CTA `rank`.
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}
// 16 bytes into a peer's shared memory, counted on the peer's mbarrier.
__device__ __forceinline__ void st_async4(unsigned addr, float4 v,
                                          unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}
// A 1-D bulk copy (the TMA's linear mode) of `bytes` (a multiple of 16,
// both addresses 16-byte aligned) from global into this CTA's shared
// memory, counted on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__host__ __device__ __forceinline__ int pad32(int x) {
  return (x + 31) / 32 * 32;
}
__host__ __device__ __forceinline__ int pad4(int x) { return (x + 3) / 4 * 4; }
__host__ __device__ __forceinline__ int pad16(int x) {
  return (x + 15) / 16 * 16;
}

// The mbarriers (two of the exchange, one a ring stage, padded to 16
// bytes), dpre[2][dh][4], the subslice pairs' sums [2][kSubs / 2][cols_pad],
// the ring [kStages][kRuns][cols_pad + 4] (a run's copy may start up to 3
// floats before its first column), the initial state and the seed of dh
// [4][cols_pad], each gating thread's values for its dh_t
// [kGaters][kGated][cols_pad], all f32, then R^T's shared-memory rows
// [kSubs][rps][4][cols_pad].
size_t smem_bytes(int dh, int cols, int rps, int elem) {
  const size_t cp = (size_t)pad32(cols);
  return pad16((2 + kStages) * 8) + 2 * (size_t)pad4(dh) * 4 * sizeof(float) +
         kSubs * cp * sizeof(float) +
         kStages * kRuns * (cp + 4) * sizeof(float) + 4 * cp * sizeof(float) +
         kGaters * kGated * cp * sizeof(float) +
         kSubs * (size_t)rps * 4 * cp * elem;
}

struct Args {
  const void* rt;       // [4, H, dh, dh]: rt[g][h][j][k] = R[g][h][k][j]
  const float* pre;     // [B, T, 4, H, dh]
  const float* c_all;   // [B, T, H, dh] each: the state after every step
  const float* n_all;
  const float* m_all;
  const float* c0;      // [B, H, dh] each, or all null (c 0, n 1, m 0)
  const float* n0;
  const float* m0;
  const float* dhs;     // [B, T, H, dh]
  const float* dh_T;    // [B, H, dh] each: the final state's gradient, or
  const float* dc_T;    // all null (zero)
  const float* dn_T;
  const float* dm_T;
  float* dpre;          // [B, T, 4, H, dh]
  float* dh0;           // [B, H, dh] each: the initial state's gradient
  float* dc0;
  float* dn0;
  float* dm0;
  int steps, H, dh, cols, rps;
};

// Ring run `run` of step t (pre's gates 0..3, then c, n, m of step t - 1,
// then dhs of step t): its tensor and the element index of column col0.
__device__ __forceinline__ const float* run_base(const Args& a, int run) {
  switch (run) {
    case 4: return a.c_all;
    case 5: return a.n_all;
    case 6: return a.m_all;
    case 7: return a.dhs;
    default: return a.pre;
  }
}
__device__ __forceinline__ size_t run_start(const Args& a, int run, int t,
                                            int b, int head, int col0) {
  if (run < 4)
    return ((((size_t)b * a.steps + t) * 4 + run) * a.H + head) * a.dh + col0;
  const int step = run < 7 ? t - 1 : t;
  return (((size_t)b * a.steps + step) * a.H + head) * a.dh + col0;
}

// R^T at rows [j0, j0 + n) of this thread's kColsPer columns, all four
// gates: [row][gate][column], 0 past the owned columns.
template <typename T, int kChunk>
__device__ __forceinline__ void load_chunk(T (&v)[kChunk][4][kColsPer],
                                           const T* rcols, size_t gate_stride,
                                           int dh, int j0, int n, int n_cols) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    if (u < n) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int i = 0; i < kColsPer; ++i)
          v[u][g][i] = i < n_cols
                           ? rcols[g * gate_stride + (size_t)(j0 + u) * dh + i]
                           : zero<T>();
      }
    }
  }
}

// 16-byte asynchronous copy global -> shared; bytes past src_bytes are 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// R^T values held in registers as 32-bit words: one f32 column, or two bf16
// columns (the lower half the even one), per word.
__device__ __forceinline__ unsigned row_bits(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ unsigned row_bits(__nv_bfloat16 x) {
  return (unsigned)__bfloat16_as_ushort(x);
}
template <typename T>
__device__ __forceinline__ float word_row(unsigned w, int half);
template <>
__device__ __forceinline__ float word_row<float>(unsigned w, int) {
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ float word_row<__nv_bfloat16>(unsigned w,
                                                         int half) {
  return __uint_as_float(half ? (w & 0xffff0000u) : (w << 16));
}

// kColsPer adjacent values of a shared-memory row, as f32: one 16-byte (f32)
// or 8-byte (bf16) load.
__device__ __forceinline__ void load4(const float* p, float (&r)[kColsPer]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  r[0] = x.x;
  r[1] = x.y;
  r[2] = x.z;
  r[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&r)[kColsPer]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  r[0] = word_row<__nv_bfloat16>(x.x, 0);
  r[1] = word_row<__nv_bfloat16>(x.x, 1);
  r[2] = word_row<__nv_bfloat16>(x.y, 0);
  r[3] = word_row<__nv_bfloat16>(x.y, 1);
}

// One row j: acc[column][gate] += dpre_t[gate, j] * R^T[gate][j][column].
__device__ __forceinline__ void fma_row(float (&acc)[kColsPer][4], float4 d,
                                        int g, const float (&r)[kColsPer]) {
  const float dg = g == 0 ? d.x : g == 1 ? d.y : g == 2 ? d.z : d.w;
#pragma unroll
  for (int i = 0; i < kColsPer; ++i) acc[i][g] = fmaf(dg, r[i], acc[i][g]);
}

// kThreads: the block size it is built for, 256 (up to 32 columns a CTA) or
// 512 (up to 64); kRows: rows of its subslice a thread keeps in registers;
// kChunk: streamed rows a thread holds in registers at a time (0: the build
// streams none; the launch checks that the plan keeps every row in
// registers or shared memory).
template <typename T, int kThreads, int kRows, int kChunk>
__global__ void __launch_bounds__(kThreads, 1)
slstm_bwd_kernel(const Args a) {
  constexpr int kPer = 4 / sizeof(T);           // columns a register word holds
  constexpr int kWords = kColsPer / kPer;       // words a row and gate
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int dh = a.dh, H = a.H, steps = a.steps;
  const int cols_pad = pad32(a.cols);

  // gating thread (ks, c): owned column col0 + c, gated alike by the
  // threads of the first kGaters blocks
  const int tid = threadIdx.x;
  const int ks = tid / cols_pad;
  const int c = tid - ks * cols_pad;
  const int col0 = rank * a.cols;
  const int n_own = min(a.cols, dh - col0);
  const bool active = c < n_own;
  const bool gater = active && ks < kGaters;
  const bool owner = active && ks == 0;
  const int col = col0 + (active ? c : 0);
  // the ring's producer: the first thread of the first non-gating block;
  // the exchange's armer: the last thread, never a gater or the producer
  const bool producer = tid == kGaters * cols_pad;
  const bool armer = tid == (int)blockDim.x - 1;

  // product thread (sub, grp): columns [4 grp, 4 grp + 4) of the CTA over j
  // subslice sub = [jbeg, jend): its first nreg rows in registers, the next
  // nres in shared memory, the rest streamed
  const int n_groups = cols_pad / kColsPer;
  const int sub = tid / n_groups;
  const int grp = tid - sub * n_groups;
  const int n_cols = max(0, min(kColsPer, n_own - kColsPer * grp));
  const bool pactive = n_cols > 0;
  const int kc = (dh + kSubs - 1) / kSubs;
  const int jbeg = min(dh, sub * kc);
  const int jend = min(dh, jbeg + kc);
  const int nreg = min(kRows, jend - jbeg);
  const int nres = min(a.rps, jend - jbeg - nreg);
  const int nstr = jend - jbeg - nreg - nres;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dh4 = pad4(dh);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem_raw);
  float4* v_s = reinterpret_cast<float4*>(smem_raw +
                                          pad16((2 + kStages) * 8));
  float* part = reinterpret_cast<float*>(v_s + 2 * dh4);  // [2][16][cp]
  const int part_elems = kSubs / 2 * cols_pad;
  float* ring = part + 2 * part_elems;             // [kStages][kRuns][run]
  const int run_elems = cols_pad + 4;
  const int stage_elems = kRuns * run_elems;
  float* init = ring + kStages * stage_elems;      // [4][cols_pad]
  float* gate_s = init + 4 * cols_pad;             // [kGaters][kGated][cp]
  T* r_s = reinterpret_cast<T*>(gate_s + kGaters * kGated * cols_pad);
  if (tid == 0) {
    for (int i = 0; i < 2 + kStages; ++i) mbar_init(smem_addr(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  const size_t gate_stride = (size_t)H * dh * dh;
  const T* rt_head = static_cast<const T*>(a.rt) + (size_t)head * dh * dh;
  const T* rcols = rt_head + col0 + kColsPer * grp;

  // the register rows: loads started first, in flight through the set-up
  unsigned rw[kRows > 0 ? kRows : 1][4][kWords];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        unsigned bits = 0u;
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          const int i = w * kPer + p;
          if (u < nreg && i < n_cols)
            bits |= row_bits(rcols[g * gate_stride + (size_t)(jbeg + u) * dh +
                                   i])
                    << (16 * p);
        }
        rw[u][g][w] = bits;
      }
    }
  }

  // the carries of column col from the later steps: zero, or the final
  // state's gradient; held by every gating thread of the column alike.  The
  // state before step 0 and the seed of dh_{T-1} wait in shared memory.
  const size_t sidx = ((size_t)b * H + head) * dh + col;
  float dc = 0.f, dn = 0.f, dm = 0.f;
  if (active && a.dh_T != nullptr) {
    dc = a.dc_T[sidx];
    dn = a.dn_T[sidx];
    dm = a.dm_T[sidx];
  }
  if (owner) {
    const bool given = a.c0 != nullptr;
    init[c] = given ? a.c0[sidx] : 0.f;
    init[cols_pad + c] = given ? a.n0[sidx] : 1.f;
    init[2 * cols_pad + c] = given ? a.m0[sidx] : 0.f;
    init[3 * cols_pad + c] = a.dh_T != nullptr ? a.dh_T[sidx] : 0.f;
  }
  // every mbarrier of the cluster is initialised before any peer writes
  cluster_arrive();

  // R^T's shared-memory rows of this CTA's columns, once: 16-byte cp.async
  // where rows and column blocks are 16-byte aligned (a block past the
  // owned columns or rows is zero-filled), else elementwise
  const int row_elems = 4 * cols_pad;
  const int slice_elems = a.rps * row_elems;
  constexpr int kVec = 16 / sizeof(T);
  if (a.rps > 0) {
    const bool vec = (dh % kVec) == 0 && (a.cols % kVec) == 0 &&
                     reinterpret_cast<uintptr_t>(a.rt) % 16 == 0;
    const int per = vec ? kVec : 1;           // elements a copy moves
    const int lanes = cols_pad / per;         // copies a gate row
    const int j = (tid % lanes) * per;
    const int row0 = tid / lanes;
    const int row_step = blockDim.x / lanes;
    for (int s = 0; s < kSubs; ++s) {
      const int sb = min(dh, s * kc);
      const int s_reg = min(kRows, min(dh, sb + kc) - sb);
      const int s_len = min(dh, sb + kc) - sb - s_reg;
      T* dst_s = r_s + (size_t)s * slice_elems;
      for (int f = row0; f < a.rps * 4; f += row_step) {
        const int i = f >> 2, g = f & 3;
        const bool ok = i < s_len && j < n_own;
        const T* src = rt_head + g * gate_stride +
                       (size_t)(ok ? sb + s_reg + i : 0) * dh + col0 +
                       (ok ? j : 0);
        T* dst = dst_s + (size_t)f * cols_pad + j;
        if (vec) {
          cp_async16(dst, src, ok ? 16 : 0);
        } else {
          *dst = ok ? *src : zero<T>();
        }
      }
    }
    cp_async_wait_all();
  }
  cluster_wait();
  __syncthreads();              // every thread's shared-memory rows landed

  // the ring: iteration s's inputs in stage s % kStages, counted on its
  // mbarrier; a run's copy covers its owned columns, widened to 16-byte
  // bounds (the tensors are 16-byte aligned, so it never leaves the 16
  // bytes that hold a column), and the gating thread reads it at the
  // column's offset in the copy
  const unsigned ring_bar = smem_addr(bars + 2);
  const unsigned ring_base = smem_addr(ring);
  const bool even = dh % 4 == 0 && a.cols % 4 == 0;   // every run at column 0
  auto fill = [&](int it) {
    if (it >= steps) return;
    const int tt = steps - 1 - it;
    const int st = it % kStages;
    const int runs = tt > 0 ? kRuns : 4;     // step 0's c, n, m: the state
    unsigned bytes = 0;
    for (int run = 0; run < kRuns; ++run) {
      if (run >= runs && run < 7) continue;
      const size_t e0 = run_start(a, run, tt, b, head, col0);
      bytes += (unsigned)((((e0 + n_own + 3) & ~(size_t)3) -
                           (e0 & ~(size_t)3)) * sizeof(float));
    }
    // reads of this stage by the generic proxy come before the copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect(ring_bar + 8u * st, bytes);
    for (int run = 0; run < kRuns; ++run) {
      if (run >= runs && run < 7) continue;
      const size_t e0 = run_start(a, run, tt, b, head, col0);
      const size_t a0 = e0 & ~(size_t)3;
      bulk_copy(ring_base + (unsigned)((st * stage_elems + run * run_elems) *
                                       sizeof(float)),
                run_base(a, run) + a0,
                (unsigned)((((e0 + n_own + 3) & ~(size_t)3) - a0) *
                           sizeof(float)),
                ring_bar + 8u * st);
    }
  };
  if (producer)
    for (int it = 0; it < kStages; ++it) fill(it);

  // gating thread (ks, c) sends column col's dpre to peers ks, ks + kGaters
  const unsigned v_base = smem_addr(v_s);
  const unsigned bar_base = smem_addr(bars);
  auto send = [&](float4 v, int buf) {
    for (int p = ks; p < n_cta; p += kGaters)
      st_async4(map_rank(v_base + (unsigned)(buf * dh4 + col) * 16u, p), v,
                map_rank(bar_base + 8u * buf, p));
  };

  const T* rs = r_s + (size_t)sub * slice_elems + kColsPer * grp;
  const int j_res = jbeg + nreg;            // first shared-memory row
  const int j_str = j_res + nres;           // first streamed row
  T v[kChunk > 0 ? kChunk : 1][4][kColsPer];
  // iteration s gates step t = steps - 1 - s (none at s = steps) after the
  // product of dpre_{t+1}, received in iteration s - 1's buffer
  for (int s = 0; s <= steps; ++s) {
    const int t = steps - 1 - s;
    float rec = 0.f;
    // step t's inputs landed long ago: wait for them here, and gate what
    // needs no dh_t (the exponentials, the new state, both maxima's
    // shares) while the peers' dpre is in flight; it waits in gate_s
    const int st = s % kStages;
    const float* in = ring + st * stage_elems + c;
    auto at = [&](int run) {      // column c of the run in the stage
      return in[run * run_elems +
                (even ? 0 : (int)(run_start(a, run, t, b, head, col0) & 3))];
    };
    if (gater && t >= 0) {
      mbar_wait(ring_bar + 8u * st, (s / kStages) & 1);
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) pre[g] = at(g);
      float c_prev = init[c], n_prev = init[cols_pad + c];
      float m_prev = init[2 * cols_pad + c];
      if (t > 0) {
        c_prev = at(4);
        n_prev = at(5);
        m_prev = at(6);
      }
      const float av = log_sigmoid(pre[1]) + m_prev;
      const float m_new = fmaxf(av, pre[0]);
      const float i_eff = expf(pre[0] - m_new);
      const float f_eff = expf(av - m_new);
      const float z = tanhf(pre[2]);
      const float u = f_eff * n_prev + i_eff;
      float* kept = gate_s + ks * kGated * cols_pad + c;
      kept[0] = i_eff;
      kept[cols_pad] = f_eff;
      kept[2 * cols_pad] = z;
      kept[3 * cols_pad] = 1.f / (1.f + expf(-pre[3]));         // o
      kept[4 * cols_pad] = f_eff * c_prev + i_eff * z;           // c_t
      kept[5 * cols_pad] = fmaxf(u, 1e-6f);                      // n_t
      kept[6 * cols_pad] = max_share(u, 1e-6f);
      kept[7 * cols_pad] = max_share(av, pre[0]);                // m_t
      kept[8 * cols_pad] = 1.f / (1.f + expf(pre[1]));           // sigma(-f~)
    }
    if (s > 0) {
      // dpre_{t+1} of every CTA lands in v_s[cur]: use number q / 2 of its
      // mbarrier, armed for 16 * dh bytes by one thread
      const int q = s - 1, cur = q & 1;
      const unsigned bar = bar_base + 8u * cur;
      if (armer) mbar_expect(bar, 16u * dh);
      if constexpr (kChunk > 0) {
        if (pactive)
          load_chunk(v, rcols, gate_stride, dh, j_str, min(kChunk, nstr),
                     n_cols);
      }
      mbar_wait(bar, (q >> 1) & 1);

      const float4* vp = v_s + cur * dh4;
      float acc[kColsPer][4] = {};
      if (pactive) {
        // register rows: with no branch between them where the subslice
        // fills them all, so the dpre loads can run ahead of the FMAs
        auto reg_row = [&](int u) {
          const float4 d = vp[jbeg + u];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float r[kColsPer];
#pragma unroll
            for (int i = 0; i < kColsPer; ++i)
              r[i] = word_row<T>(rw[u][g][i / kPer], i % kPer);
            fma_row(acc, d, g, r);
          }
        };
        if (nreg == kRows) {
#pragma unroll
          for (int u = 0; u < kRows; ++u) reg_row(u);
        } else {
#pragma unroll
          for (int u = 0; u < kRows; ++u)
            if (u < nreg) reg_row(u);
        }
        // shared-memory rows
#pragma unroll 2
        for (int i = 0; i < nres; ++i) {
          const float4 d = vp[j_res + i];
          const T* row = rs + (size_t)i * row_elems;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float r[kColsPer];
            load4(row + g * cols_pad, r);
            fma_row(acc, d, g, r);
          }
        }
        // streamed rows, a chunk at a time
        if constexpr (kChunk > 0) for (int s0 = 0; s0 < nstr; s0 += kChunk) {
          if (s0 > 0)
            load_chunk(v, rcols, gate_stride, dh, j_str + s0,
                       min(kChunk, nstr - s0), n_cols);
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            if (s0 + u < nstr) {
              const float4 d = vp[j_str + s0 + u];
#pragma unroll
              for (int g = 0; g < 4; ++g) {
                float r[kColsPer];
#pragma unroll
                for (int i = 0; i < kColsPer; ++i) r[i] = to_f32(v[u][g][i]);
                fma_row(acc, d, g, r);
              }
            }
          }
        }
      }
      // partial sums double-buffered: a thread may start the next product
      // while another of its CTA still gates this step
      float* pt = part + cur * part_elems;
      float4 p =
          make_float4((acc[0][0] + acc[0][1]) + (acc[0][2] + acc[0][3]),
                      (acc[1][0] + acc[1][1]) + (acc[1][2] + acc[1][3]),
                      (acc[2][0] + acc[2][1]) + (acc[2][2] + acc[2][3]),
                      (acc[3][0] + acc[3][1]) + (acc[3][2] + acc[3][3]));
      // subslices 2k and 2k + 1 sit n_groups lanes apart in one warp (a
      // quarter-warp, or a half-warp in the 512-thread build): one shuffle
      // adds them, and the even one's threads store the pair's sum
      p.x += __shfl_xor_sync(0xffffffffu, p.x, n_groups);
      p.y += __shfl_xor_sync(0xffffffffu, p.y, n_groups);
      p.z += __shfl_xor_sync(0xffffffffu, p.z, n_groups);
      p.w += __shfl_xor_sync(0xffffffffu, p.w, n_groups);
      if ((sub & 1) == 0)
        *reinterpret_cast<float4*>(pt + (sub >> 1) * cols_pad +
                                   kColsPer * grp) = p;
      __syncthreads();
      // the recurrence's share of dh_t: column c's 16 pair sums, in four
      // runs of four, then the runs in pairs
      if (gater) {
        float run[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          run[r] = pt[(4 * r) * cols_pad + c];
#pragma unroll
          for (int m = 1; m < 4; ++m) run[r] += pt[(4 * r + m) * cols_pad + c];
        }
        rec = (run[0] + run[1]) + (run[2] + run[3]);
      }
      // every gating thread read iteration s - 1's stage before the
      // barrier: refill it with iteration s + kStages - 1's inputs
      if (producer) fill(s + kStages - 1);
    }

    if (!gater) continue;
    if (t < 0) {                  // s == steps: rec is dh of the initial h
      if (owner) {
        a.dh0[sidx] = rec;
        a.dc0[sidx] = dc;
        a.dn0[sidx] = dn;
        a.dm0[sidx] = dm;
      }
      continue;
    }
    // the rest of the gating, from dh_t: what the gating before the
    // exchange left in gate_s, and c, n of step t - 1 and dhs from the ring
    const float* kept = gate_s + ks * kGated * cols_pad + c;
    const float i_eff = kept[0], f_eff = kept[cols_pad];
    const float z = kept[2 * cols_pad], o = kept[3 * cols_pad];
    const float c_new = kept[4 * cols_pad], n_new = kept[5 * cols_pad];
    const float u_share = kept[6 * cols_pad], share = kept[7 * cols_pad];
    const float sig_f = kept[8 * cols_pad];
    float c_prev = init[c], n_prev = init[cols_pad + c];
    if (t > 0) {
      c_prev = at(4);
      n_prev = at(5);
    }
    float dh_up = at(7);
    if (t == steps - 1) dh_up += init[3 * cols_pad + c];
    const float dhv = dh_up + rec;
    // h = o c / n
    const float d_o = dhv * c_new / n_new;
    dc += dhv * o / n_new;
    dn -= dhv * o * c_new / (n_new * n_new);
    const float du = dn * u_share;
    const float e_i = (dc * z + du) * i_eff;       // through exp(i~ - m_t)
    const float e_f = (dc * c_prev + du * n_prev) * f_eff;   // exp(a - m_t)
    const float dmt = dm - e_i - e_f;
    const float da = e_f + dmt * share;            // m_t = max(a, i~)
    const float4 d = make_float4(e_i + dmt * (1.f - share), da * sig_f,
                                 dc * i_eff * (1.f - z * z),
                                 d_o * o * (1.f - o));
    dc *= f_eff;
    dn = du * f_eff;
    dm = da;
    send(d, s & 1);
    if (owner) {
      float* dp = a.dpre + (((size_t)b * steps + t) * 4 * H + head) * dh + col;
      const size_t gs = (size_t)H * dh;
      dp[0] = d.x;
      dp[gs] = d.y;
      dp[2 * gs] = d.z;
      dp[3 * gs] = d.w;
    }
  }
}

// The instantiation for a dtype and a column count: 256 threads up to 32
// columns a CTA (kRegRows rows of each subslice in registers, none
// streamed), 512 up to 64 (no register rows, rows streamed one at a time:
// the 512-thread build has 128 registers a thread).
template <typename T>
void* kernel_fn(int cols) {
  return cols <= 32
             ? reinterpret_cast<void*>(
                   slstm_bwd_kernel<T, 256, kRegRows, 0>)
             : reinterpret_cast<void*>(slstm_bwd_kernel<T, 512, 0, 1>);
}

void* kernel_for(int dtype, int cols) {
  switch (dtype) {
    case 0: return kernel_fn<float>(cols);
    case 1: return kernel_fn<__nv_bfloat16>(cols);
    default: return nullptr;
  }
}

cudaLaunchConfig_t cluster_config(dim3 grid, int n_cta, int cols, int smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kSlices * pad32(cols));
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)n_cta;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Once per device and dtype, outside any CUDA-graph capture: allow the
// largest dynamic shared memory and clusters above the portable 8.
extern "C" int slstm_scan_bwd_setup(int dtype) {
  const int widths[2] = {32, kMaxCols};
  for (int cols : widths) {
    const void* fn = kernel_for(dtype, cols);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// How many clusters of n_cta CTAs, each of kSlices * pad32(cols) threads and
// smem bytes of dynamic shared memory, the card can hold at once -> *out.
extern "C" int slstm_scan_bwd_max_clusters(int dtype, int n_cta, int cols,
                                           int smem, void* out) {
  const void* fn = kernel_for(dtype, cols);
  if (fn == nullptr || n_cta < 1 || n_cta > kMaxCluster || cols < 1 ||
      cols > kMaxCols || out == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(dim3(n_cta, 1, 1), n_cta, cols, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(static_cast<int*>(out), fn, &cfg);
}

// dtype (of rt): 0 = float32, 1 = bfloat16.  rt [4, H, dh, dh] (R
// transposed in its last two dims), pre [B, T, 4, H, dh], c_all, n_all,
// m_all, dhs [B, T, H, dh], the initial c0, n0, m0 [B, H, dh] (all null for
// the zero state), the final state's gradient dh_T, dc_T, dn_T, dm_T
// [B, H, dh] (all null for zero), outputs dpre [B, T, 4, H, dh] and dh0,
// dc0, dn0, dm0 [B, H, dh]; all f32 but rt, contiguous on the current
// device; pre, c_all, n_all, m_all and dhs 16-byte aligned (the bulk
// copies').  The plan: n_cta CTAs a cluster, cols state columns a CTA, rps
// shared-memory rows a j slice, smem bytes of dynamic shared memory
// (smem_bytes()).
extern "C" int slstm_scan_bwd_launch(
    const void* rt, const void* pre, const void* c_all, const void* n_all,
    const void* m_all, const void* c0, const void* n0, const void* m0,
    const void* dhs, const void* dh_T, const void* dc_T, const void* dn_T,
    const void* dm_T, void* dpre, void* dh0, void* dc0, void* dn0, void* dm0,
    int B, int T, int H, int dh, int dtype, int n_cta, int cols, int rps,
    int smem, void* stream) {
  if (B < 1 || T < 1 || H < 1 || dh < 1 || dh > kMaxDh || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  if (rt == nullptr || pre == nullptr || c_all == nullptr ||
      n_all == nullptr || m_all == nullptr || dhs == nullptr ||
      dpre == nullptr || dh0 == nullptr || dc0 == nullptr ||
      dn0 == nullptr || dm0 == nullptr)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(pre) || !aligned16(c_all) || !aligned16(n_all) ||
      !aligned16(m_all) || !aligned16(dhs))
    return (int)cudaErrorMisalignedAddress;
  const bool has_state = c0 != nullptr;
  if (has_state != (n0 != nullptr) || has_state != (m0 != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool seeded = dh_T != nullptr;
  if (seeded != (dc_T != nullptr) || seeded != (dn_T != nullptr) ||
      seeded != (dm_T != nullptr))
    return (int)cudaErrorInvalidValue;
  // every column owned by exactly one CTA, none empty
  if (n_cta < 1 || n_cta > kMaxCluster || cols < 1 || cols > kMaxCols ||
      (long)n_cta * cols < dh || (long)(n_cta - 1) * cols >= dh)
    return (int)cudaErrorInvalidValue;
  const int kc = (dh + kSubs - 1) / kSubs;
  if (cols <= 32 && kRegRows + rps < kc)   // the 256-thread build streams none
    return (int)cudaErrorInvalidValue;
  if (rps < 0 || rps > kc || smem > kMaxSmem ||
      (size_t)smem != smem_bytes(dh, cols, rps, dtype == 1 ? 2 : 4))
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_for(dtype, cols);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;

  Args a{rt,
         static_cast<const float*>(pre),
         static_cast<const float*>(c_all),
         static_cast<const float*>(n_all),
         static_cast<const float*>(m_all),
         static_cast<const float*>(c0),
         static_cast<const float*>(n0),
         static_cast<const float*>(m0),
         static_cast<const float*>(dhs),
         static_cast<const float*>(dh_T),
         static_cast<const float*>(dc_T),
         static_cast<const float*>(dn_T),
         static_cast<const float*>(dm_T),
         static_cast<float*>(dpre),
         static_cast<float*>(dh0),
         static_cast<float*>(dc0),
         static_cast<float*>(dn0),
         static_cast<float*>(dm0),
         T, H, dh, cols, rps};
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(dim3(n_cta, H, B), n_cta, cols,
                                          smem,
                                          static_cast<cudaStream_t>(stream),
                                          &attr);
  void* params[] = {&a};
  cudaError_t err = cudaLaunchKernelExC(&cfg, fn, params);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
