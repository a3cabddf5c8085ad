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
// the head's CTAs exchange dpre once a step.
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
//     memory.  R^T stays on the chip for the whole call: each thread keeps
//     the first kRegWords words of its j slice in registers (16 f32 rows or
//     32 bf16 rows: the backward's gating holds more live values than the
//     forward's, so fewer rows than the forward's 32), the CTA the next
//     ones in shared memory, and only what fits in neither (dh > 512, in the
//     512-thread build) is read from L2 every step.
//   - dpre_t is exchanged in distributed shared memory: the four gate
//     gradients of a column are 16 contiguous bytes, sent with one
//     st.async.v4 to each peer and counted on the peer's mbarrier for that
//     buffer (16 * dh bytes a step), double-buffered as the forward's h.
//     Each thread of the product reads them as one broadcast float4 a row.
//   - The j range is cut into kSlices slices that depend on dh alone;
//     thread (slice, column) sums its slice in j order with one accumulator
//     a gate, adds the four in a fixed order, and the slices are added in
//     order.  So every number is independent of n_cta and of where R's rows
//     live: two cluster sizes give bit-identical results, and so do two
//     runs.  No atomics and no global counters.
//
// Types: R in f32 or bf16 (as the forward took it), everything else f32.
//   The host plan (ops.py plan_scan(..., backward=True)) picks n_cta, cols
//   and the shared-memory rows per slice; the launch checks them and the
//   dynamic shared memory against smem_bytes().  slstm_scan_bwd_setup sets
//   the function attributes once per device, before any launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSlices = 8;                       // j slices; fixed by dh alone
constexpr int kGaters = 4;    // slices whose threads gate: a warp a scheduler
constexpr int kMaxCols = 64;                     // state columns a CTA owns
constexpr int kMaxCluster = 16;                  // non-portable above 8
constexpr int kRegWords = 16;  // R^T words a gate a thread of the 256-thread
                               // build keeps in registers (two bf16 rows each)
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

// Two mbarriers (16 bytes), dpre[2][dh][4], the slices' partial sums
// [2][kSlices][cols_pad], then R^T's shared-memory rows
// [kSlices][rps][4][cols_pad].
size_t smem_bytes(int dh, int cols, int rps, int elem) {
  const size_t cp = (size_t)pad32(cols);
  return 16 + 2 * (size_t)pad4(dh) * 4 * sizeof(float) +
         2 * kSlices * cp * sizeof(float) +
         kSlices * (size_t)rps * 4 * cp * elem;
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

// Rows [j0, j0 + n) of this thread's column of rt, all four gates.
template <typename T, int kChunk>
__device__ __forceinline__ void load_chunk(T (&v)[kChunk][4], const T* rcol,
                                           size_t gate_stride, int dh, int j0,
                                           int n) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    if (u < n) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        v[u][g] = rcol[g * gate_stride + (size_t)(j0 + u) * dh];
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

// R^T rows held in registers as 32-bit words: one f32 row, or two bf16 rows
// (the lower half the even row), per word and gate.
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

__device__ __forceinline__ void fma4(float (&acc)[4], float4 d, float r0,
                                     float r1, float r2, float r3) {
  acc[0] = fmaf(d.x, r0, acc[0]);
  acc[1] = fmaf(d.y, r1, acc[1]);
  acc[2] = fmaf(d.z, r2, acc[2]);
  acc[3] = fmaf(d.w, r3, acc[3]);
}

// kThreads: the block size it is built for, 256 (up to 32 columns a CTA) or
// 512 (up to 64); kWords: 32-bit words of R^T a thread keeps in registers
// per gate; kChunk: streamed rows a thread holds in registers at a time (0:
// the build streams none; the launch checks that the plan keeps every row in
// registers or shared memory).
template <typename T, int kThreads, int kWords, int kChunk>
__global__ void __launch_bounds__(kThreads, 1)
slstm_bwd_kernel(const Args a) {
  constexpr int kPer = 4 / sizeof(T);           // rows a register word holds
  constexpr int kRegRows = kWords * kPer;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int dh = a.dh, H = a.H, steps = a.steps;
  const int cols_pad = pad32(a.cols);

  // thread (ks, c): j slice ks, owned column col0 + c
  const int tid = threadIdx.x;
  const int ks = tid / cols_pad;
  const int c = tid - ks * cols_pad;
  const int col0 = rank * a.cols;
  const int n_own = min(a.cols, dh - col0);
  const bool active = c < n_own;
  const bool gater = active && ks < kGaters;
  const bool owner = active && ks == 0;
  const int col = col0 + (active ? c : 0);

  // slice ks is j in [jbeg, jend): its first nreg rows in registers, the
  // next nres in shared memory, the rest streamed
  const int kc = (dh + kSlices - 1) / kSlices;
  const int jbeg = min(dh, ks * kc);
  const int jend = min(dh, jbeg + kc);
  const int nreg = min(kRegRows, jend - jbeg);
  const int nres = min(a.rps, jend - jbeg - nreg);
  const int nstr = jend - jbeg - nreg - nres;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dh4 = pad4(dh);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem_raw);
  float4* v_s = reinterpret_cast<float4*>(smem_raw + 16);      // [2][dh4]
  float* part = reinterpret_cast<float*>(v_s + 2 * dh4);  // [2][kSlices][cp]
  const int part_elems = kSlices * cols_pad;
  T* r_s = reinterpret_cast<T*>(part + 2 * part_elems);
  if (tid == 0) {
    mbar_init(smem_addr(&bars[0]), 1);
    mbar_init(smem_addr(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  const size_t gate_stride = (size_t)H * dh * dh;
  const T* rt_head = static_cast<const T*>(a.rt) + (size_t)head * dh * dh;
  const T* rcol = rt_head + col;

  // the register rows: loads started first, in flight through the set-up
  unsigned rw[kWords > 0 ? kWords : 1][4];
  if (active) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        unsigned bits = 0u;
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          const int u = w * kPer + p;
          if (u < nreg)
            bits |= row_bits(rcol[g * gate_stride + (size_t)(jbeg + u) * dh])
                    << (16 * p);
        }
        rw[w][g] = bits;
      }
    }
  }

  // the carries of column col from the later steps: zero, or the final
  // state's gradient; held by every gating thread of the column alike
  const size_t sidx = ((size_t)b * H + head) * dh + col;
  float dh_seed = 0.f, dc = 0.f, dn = 0.f, dm = 0.f;
  if (active && a.dh_T != nullptr) {
    dh_seed = a.dh_T[sidx];
    dc = a.dc_T[sidx];
    dn = a.dn_T[sidx];
    dm = a.dm_T[sidx];
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
    for (int s = 0; s < kSlices; ++s) {
      const int sb = min(dh, s * kc);
      const int s_reg = min(kRegRows, min(dh, sb + kc) - sb);
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

  // gating thread (ks, c) sends column col's dpre to peers ks, ks + kGaters
  const unsigned v_base = smem_addr(v_s);
  const unsigned bar_base = smem_addr(bars);
  auto send = [&](float4 v, int buf) {
    for (int p = ks; p < n_cta; p += kGaters)
      st_async4(map_rank(v_base + (unsigned)(buf * dh4 + col) * 16u, p), v,
                map_rank(bar_base + 8u * buf, p));
  };

  const T* rs = r_s + (size_t)ks * slice_elems + c;
  const int j_res = jbeg + nreg;            // first shared-memory row
  const int j_str = j_res + nres;           // first streamed row
  T v[kChunk > 0 ? kChunk : 1][4];
  // iteration s gates step t = steps - 1 - s (none at s = steps) after the
  // product of dpre_{t+1}, received in iteration s - 1's buffer
  for (int s = 0; s <= steps; ++s) {
    const int t = steps - 1 - s;
    // independent of the exchange: started before the wait
    float pre[4] = {0.f, 0.f, 0.f, 0.f};
    float c_prev = 0.f, n_prev = 1.f, m_prev = 0.f, dh_up = 0.f;
    if (gater && t >= 0) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        pre[g] = a.pre[((((size_t)b * steps + t) * 4 + g) * H + head) * dh +
                       col];
      if (t > 0) {
        const size_t p = (((size_t)b * steps + t - 1) * H + head) * dh + col;
        c_prev = a.c_all[p];
        n_prev = a.n_all[p];
        m_prev = a.m_all[p];
      } else if (a.c0 != nullptr) {
        c_prev = a.c0[sidx];
        n_prev = a.n0[sidx];
        m_prev = a.m0[sidx];
      }
      dh_up = a.dhs[(((size_t)b * steps + t) * H + head) * dh + col];
      if (t == steps - 1) dh_up += dh_seed;
    }
    float rec = 0.f;
    if (s > 0) {
      if constexpr (kChunk > 0) {
        if (active)
          load_chunk(v, rcol, gate_stride, dh, j_str, min(kChunk, nstr));
      }
      // dpre_{t+1} of every CTA lands in v_s[cur]: use number q / 2 of its
      // mbarrier, armed for 16 * dh bytes by one thread
      const int q = s - 1, cur = q & 1;
      const unsigned bar = bar_base + 8u * cur;
      if (tid == 0) mbar_expect(bar, 16u * dh);
      mbar_wait(bar, (q >> 1) & 1);

      const float4* vp = v_s + cur * dh4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (active) {
        // register rows
#pragma unroll
        for (int u = 0; u < kRegRows; ++u) {
          if (u < nreg) {
            const float4 d = vp[jbeg + u];
            fma4(acc, d, word_row<T>(rw[u / kPer][0], u % kPer),
                 word_row<T>(rw[u / kPer][1], u % kPer),
                 word_row<T>(rw[u / kPer][2], u % kPer),
                 word_row<T>(rw[u / kPer][3], u % kPer));
          }
        }
        // shared-memory rows
#pragma unroll 4
        for (int i = 0; i < nres; ++i) {
          const T* row = rs + (size_t)i * row_elems;
          fma4(acc, vp[j_res + i], to_f32(row[0]), to_f32(row[cols_pad]),
               to_f32(row[2 * cols_pad]), to_f32(row[3 * cols_pad]));
        }
        // streamed rows, a chunk at a time
        if constexpr (kChunk > 0) for (int s0 = 0; s0 < nstr; s0 += kChunk) {
          if (s0 > 0)
            load_chunk(v, rcol, gate_stride, dh, j_str + s0,
                       min(kChunk, nstr - s0));
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            if (s0 + u < nstr)
              fma4(acc, vp[j_str + s0 + u], to_f32(v[u][0]), to_f32(v[u][1]),
                   to_f32(v[u][2]), to_f32(v[u][3]));
          }
        }
      }
      // partial sums double-buffered: a thread may start the next product
      // while another of its CTA still gates this step
      float* pt = part + cur * part_elems;
      pt[ks * cols_pad + c] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      __syncthreads();
      if (gater) {
#pragma unroll
        for (int sl = 0; sl < kSlices; ++sl) rec += pt[sl * cols_pad + c];
      }
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
    const float dhv = dh_up + rec;
    const float av = log_sigmoid(pre[1]) + m_prev;
    const float m_new = fmaxf(av, pre[0]);
    const float i_eff = expf(pre[0] - m_new);
    const float f_eff = expf(av - m_new);
    const float z = tanhf(pre[2]);
    const float o = 1.f / (1.f + expf(-pre[3]));
    const float c_new = f_eff * c_prev + i_eff * z;
    const float u = f_eff * n_prev + i_eff;
    const float n_new = fmaxf(u, 1e-6f);
    // h = o c / n
    const float d_o = dhv * c_new / n_new;
    dc += dhv * o / n_new;
    dn -= dhv * o * c_new / (n_new * n_new);
    const float du = dn * max_share(u, 1e-6f);
    const float e_i = (dc * z + du) * i_eff;       // through exp(i~ - m_t)
    const float e_f = (dc * c_prev + du * n_prev) * f_eff;   // exp(a - m_t)
    const float dmt = dm - e_i - e_f;
    const float share = max_share(av, pre[0]);     // m_t = max(a, i~)
    const float da = e_f + dmt * share;
    const float4 d = make_float4(e_i + dmt * (1.f - share),
                                 da * (1.f / (1.f + expf(pre[1]))),
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
// columns a CTA (kRegWords words of each slice in registers, none
// streamed), 512 up to 64 (no register rows, 8-row streamed chunks).
template <typename T>
void* kernel_fn(int cols) {
  return cols <= 32
             ? reinterpret_cast<void*>(slstm_bwd_kernel<T, 256, kRegWords, 0>)
             : reinterpret_cast<void*>(slstm_bwd_kernel<T, 512, 0, 8>);
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
// device.  The plan: n_cta CTAs a cluster, cols state columns a CTA, rps
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
  const int kc = (dh + kSlices - 1) / kSlices;
  const int reg_rows = cols > 32 ? 0 : kRegWords * (dtype == 1 ? 2 : 1);
  if (cols <= 32 && reg_rows + rps < kc)   // the 256-thread build streams none
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
