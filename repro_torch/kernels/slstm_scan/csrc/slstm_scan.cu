// sLSTM recurrence with exponential gating over T steps, one thread-block
// cluster per (head, batch row).
//
// Replaces: src/repro/kernels/slstm_scan/kernel.py:71 (slstm_scan, Pallas body
//   _slstm_kernel), which xLSTM's sLSTM layers run over their gate
//   pre-activations: once over the prompt in prefill, one step per decode
//   token, and in training over the sequence, in saving mode, twice a layer
//   a step under recompute.
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
//   of HBM, 67 TFLOP/s of f32 outside the tensor cores): the bytes of R,
//   4 * H * dh * dh elements (16.8 MB in f32 at xLSTM-1.3B's H=4, dh=512),
//   read once, about 5 us; the product's 2 * B * T * 4 * H * dh * dh flops
//   (0.13 GFLOP at B=1, T=16) take 2 us.  And, being a recurrence, T times
//   the latency of one step: every output column of step t needs the whole
//   h_{t-1} of its head, so the head's CTAs exchange h once per step.
//
// What the design does about it:
//   - One cluster of n_cta CTAs (16 at dh=512, so 64 SMs at B=1, H=4) per
//     (head, batch row); grid (n_cta, H, B), launched with a cluster
//     dimension.  CTA q owns state columns [q * cols, (q + 1) * cols) of all
//     four gates and sums over the whole k range for them, so the gating is
//     local: the threads of column j hold its c, n, m in registers.
//   - R stays on the chip for the whole call.  A CTA's slice is 4 * dh * cols
//     elements (256 KB in f32, 128 KB in bf16 at dh=512, n_cta=16): each
//     thread keeps the first 32 rows of its k slice in registers (two bf16
//     rows a word), the CTA the next ones in shared memory (copied once with
//     16-byte cp.async), and only what fits in neither (dh > 512, in the
//     512-thread build) is read from L2 every step, a chunk of rows at a
//     time into registers.  A T=1 launch takes the same path: every row is
//     read once, with all the loads in flight together.  Warps read 32
//     consecutive columns of a row: coalesced, conflict-free, and with no
//     alignment needed for ragged dh outside the 16-byte copies.
//   - h_{t-1} is exchanged in distributed shared memory.  The threads of
//     column j in the first kGaters slices (a warp a scheduler) gate it
//     alike from the same partial sums, and thread (slice s, column j)
//     writes h_t[j] with st.async into the h buffer (t+1) % 2 of CTAs s,
//     s + kGaters, ...; st.async counts its 4 bytes on the
//     receiver's mbarrier for that buffer, which one thread arms for dh * 4
//     bytes each step and every thread waits on.  No cluster barrier runs
//     per step: its release would wait for all of the CTA's earlier
//     stores, and every CTA for the slowest of the cluster.  Double
//     buffering is enough: a peer's h_t arrives only after that peer had
//     all of h_{t-1}, hence after every CTA finished reading h_{t-2} from
//     the buffer it overwrites (partial sums are double-buffered for the
//     same reason).  One cluster barrier, at the start, orders the mbarrier
//     initialisation before any remote write; every CTA waits for all the
//     bytes sent to it, so none is written after it exits.  Each CTA reads
//     only its own columns of h0 and writes its final state at the end:
//     the final state may alias the initial one.
//   - The products stay on CUDA cores (at B=1 each step is a matrix-vector
//     product).  The k range is cut into kSlices slices that depend on dh
//     alone; thread (slice, column) sums its slice in k order, whether a row
//     comes from registers, shared memory or L2, and the slices are added in
//     order.  So every number is independent of n_cta and of where R's rows
//     live: two cluster sizes give bit-identical results.
//   - No atomics and no global counters: the barriers are in hardware.
//
// Saving mode (training): with pre, c_all, n_all and m_all given, the owner
//   thread of each column also writes the step's f32 pre-activations
//   [B, T, 4, H, dh] and the state (c, n, m) after it, [B, T, H, dh] each:
//   what the backward (slstm_scan_bwd.cu) reads.  Serving passes none and
//   writes nothing more.
//
// Types: wx and R in f32 or bf16 (one dtype), bias and state in f32, hs
//   [B, T, H, dh] in f32.  The host plan (ops.py plan_scan) picks n_cta,
//   cols and the shared-memory rows per slice; the launch checks them and
//   the dynamic shared memory against smem_bytes().  slstm_scan_setup sets
//   the function attributes once per device, before any launch or capture.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSlices = 8;                       // k slices; fixed by dh alone
constexpr int kGaters = 4;    // slices whose threads gate: a warp a scheduler
constexpr int kMaxCols = 64;                     // state columns a CTA owns
constexpr int kMaxCluster = 16;                  // non-portable above 8
// R words a gate that a thread of the 256-thread build keeps in registers:
// 32 f32 rows, or 32 bf16 rows (two a word; their unpacking needs registers
// too, and more words spill)
template <typename T>
constexpr int reg_words() {
  return sizeof(T) == 4 ? 32 : 16;
}
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

// log(sigmoid(x)) = -softplus(-x) = min(x, 0) - log1p(exp(-|x|)), stable for
// both signs.
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// The exchange of h: an mbarrier per h buffer counts the bytes that land in
// it (transaction count); each step one thread arms it for dh * 4 bytes and
// every thread waits for the phase.  Peers write with st.async, which
// completes its bytes on the receiver's mbarrier.
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
// 4 bytes into a peer's shared memory, counted on the peer's mbarrier.
__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
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

// Two mbarriers (16 bytes), h[2][dh], the slices' partial sums
// [2][kSlices][4][cols_pad], then R's shared-memory rows
// [kSlices][rps][4][cols_pad].
size_t smem_bytes(int dh, int cols, int rps, int elem) {
  const size_t cp = (size_t)pad32(cols);
  return 16 + 2 * (size_t)pad4(dh) * sizeof(float) +
         2 * kSlices * 4 * cp * sizeof(float) +
         kSlices * (size_t)rps * 4 * cp * elem;
}

struct Args {
  const void* wx;      // [B, T, 4, H, dh]
  const void* r;       // [4, H, dh, dh]
  const float* bias;   // [4, H, dh]
  const float* h0;     // [B, H, dh] each, or all null
  const float* c0;
  const float* n0;
  const float* m0;
  float* hs;           // [B, T, H, dh]
  float* h_out;        // [B, H, dh] each; may alias the inputs
  float* c_out;
  float* n_out;
  float* m_out;
  float* pre;          // [B, T, 4, H, dh] and [B, T, H, dh] each, or all
  float* c_all;        // null (saving mode off)
  float* n_all;
  float* m_all;
  int steps, H, dh, cols, rps;
};

// Rows [k0, k0 + n) of this thread's column, all four gates, into registers.
template <typename T, int kChunk>
__device__ __forceinline__ void load_chunk(T (&v)[kChunk][4], const T* rcol,
                                           size_t gate_stride, int dh, int k0,
                                           int n) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    if (u < n) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        v[u][g] = rcol[g * gate_stride + (size_t)(k0 + u) * dh];
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

// R rows held in registers as 32-bit words: one f32 row, or two bf16 rows
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

// kThreads: the block size it is built for, 256 (up to 32 columns a CTA) or
// 512 (up to 64); kRegWords: 32-bit words of R a thread keeps in registers
// per gate (kRegWords * 4 / sizeof(T) rows); kChunk: streamed rows a thread
// holds in registers at a time (0: the build streams none; the launch
// checks that the plan keeps every row in registers or shared memory).
template <typename T, int kThreads, int kRegWords, int kChunk>
__global__ void __launch_bounds__(kThreads, 1)
slstm_cluster_kernel(const Args a) {
  constexpr int kPer = 4 / sizeof(T);           // rows a register word holds
  constexpr int kRegRows = kRegWords * kPer;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int dh = a.dh, H = a.H, steps = a.steps;
  const int cols_pad = pad32(a.cols);

  // thread (ks, c): k slice ks, owned column col0 + c
  const int tid = threadIdx.x;
  const int ks = tid / cols_pad;
  const int c = tid - ks * cols_pad;
  const int col0 = rank * a.cols;
  const int n_own = min(a.cols, dh - col0);
  const bool active = c < n_own;
  const bool gater = active && ks < kGaters;
  const bool owner = active && ks == 0;
  const int col = col0 + (active ? c : 0);

  // slice ks is k in [kbeg, kend): its first nreg rows in registers, the
  // next nres in shared memory, the rest streamed
  const int kc = (dh + kSlices - 1) / kSlices;
  const int kbeg = min(dh, ks * kc);
  const int kend = min(dh, kbeg + kc);
  const int nreg = min(kRegRows, kend - kbeg);
  const int nres = min(a.rps, kend - kbeg - nreg);
  const int nstr = kend - kbeg - nreg - nres;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dh4 = pad4(dh);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem_raw);
  float* h_s = reinterpret_cast<float*>(smem_raw + 16);        // [2][dh4]
  float* part = h_s + 2 * dh4;              // [2][kSlices][4][cols_pad]
  const int part_elems = kSlices * 4 * cols_pad;
  T* r_s = reinterpret_cast<T*>(part + 2 * part_elems);
  if (tid == 0) {
    mbar_init(smem_addr(&bars[0]), 1);
    mbar_init(smem_addr(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  const T* wx = static_cast<const T*>(a.wx);
  const size_t gate_stride = (size_t)H * dh * dh;
  const T* r_head = static_cast<const T*>(a.r) + (size_t)head * dh * dh;
  const T* rcol = r_head + col;

  // the register rows: loads started first, in flight through the set-up
  unsigned rw[kRegWords > 0 ? kRegWords : 1][4];
  if (active) {
#pragma unroll
    for (int w = 0; w < kRegWords; ++w) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        unsigned bits = 0u;
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          const int u = w * kPer + p;
          if (u < nreg)
            bits |= row_bits(rcol[g * gate_stride + (size_t)(kbeg + u) * dh])
                    << (16 * p);
        }
        rw[w][g] = bits;
      }
    }
  }

  // the carry of column col: read by each CTA for its own columns only, and
  // held by every slice's thread of the column, which all gate alike
  const size_t sidx = ((size_t)b * H + head) * dh + col;
  float h = 0.f, cs = 0.f, n = 1.f, m = 0.f;
  float bg[4] = {0.f, 0.f, 0.f, 0.f};
  if (active) {
    if (a.h0 != nullptr) {
      h = a.h0[sidx];
      cs = a.c0[sidx];
      n = a.n0[sidx];
      m = a.m0[sidx];
    }
#pragma unroll
    for (int g = 0; g < 4; ++g)
      bg[g] = a.bias[((size_t)g * H + head) * dh + col];
  }
  // every mbarrier of the cluster is initialised before any peer writes
  cluster_arrive();

  // R's shared-memory rows of this CTA's columns, once: 16-byte cp.async
  // where rows and column blocks are 16-byte aligned (a block past the
  // owned columns or rows is zero-filled), else elementwise
  const int row_elems = 4 * cols_pad;
  const int slice_elems = a.rps * row_elems;
  constexpr int kVec = 16 / sizeof(T);
  if (a.rps > 0) {
    const bool vec = (dh % kVec) == 0 && (a.cols % kVec) == 0 &&
                     reinterpret_cast<uintptr_t>(a.r) % 16 == 0;
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
        const T* src = r_head + g * gate_stride +
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

  // gating thread (ks, c) sends column col's h to peers ks, ks + kGaters, ...
  const unsigned h_base = smem_addr(h_s);
  const unsigned bar_base = smem_addr(bars);
  auto send = [&](float v, int buf) {
    if (!gater) return;
    for (int p = ks; p < n_cta; p += kGaters)
      st_async(map_rank(h_base + (unsigned)(buf * dh4 + col) * 4u, p), v,
               map_rank(bar_base + 8u * buf, p));
  };
  send(h, 0);
  __syncthreads();

  const T* rs = r_s + (size_t)ks * slice_elems + c;
  const int k_res = kbeg + nreg;            // first shared-memory row
  const int k_str = k_res + nres;           // first streamed row
  int cur = 0;
  T v[kChunk > 0 ? kChunk : 1][4];
  for (int t = 0; t < steps; ++t) {
    // independent of h_{t-1}: started before the wait, in flight during it
    float xw[4] = {0.f, 0.f, 0.f, 0.f};
    if (active) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        xw[g] = to_f32(
            wx[((((size_t)b * steps + t) * 4 + g) * H + head) * dh + col]);
    }
    if constexpr (kChunk > 0) {
      if (active)
        load_chunk(v, rcol, gate_stride, dh, k_str, min(kChunk, nstr));
    }
    // h_{t-1} of every CTA of the cluster lands in h_s[cur]: its mbarrier's
    // use number t / 2, armed for dh * 4 bytes by one thread
    const unsigned bar = bar_base + 8u * cur;
    if (tid == 0) mbar_expect(bar, 4u * dh);
    mbar_wait(bar, (t >> 1) & 1);

    const float* hp = h_s + cur * dh4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (active) {
      // register rows, h read four at a time where k is 16-byte aligned
      const bool hvec = (kbeg & 3) == 0;
      if (hvec && nreg == kRegRows) {     // a full slice: no guards
#pragma unroll
        for (int u4 = 0; u4 < kRegRows; u4 += 4) {
          const float4 q = *reinterpret_cast<const float4*>(hp + kbeg + u4);
          const float hk[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int g = 0; g < 4; ++g)
              acc[g] = fmaf(
                  hk[e], word_row<T>(rw[(u4 + e) / kPer][g], (u4 + e) % kPer),
                  acc[g]);
          }
        }
      } else {
#pragma unroll
      for (int u4 = 0; u4 < kRegRows; u4 += 4) {
        if (u4 < nreg) {
          float hk[4];
          if (hvec) {
            const float4 q = *reinterpret_cast<const float4*>(hp + kbeg + u4);
            hk[0] = q.x, hk[1] = q.y, hk[2] = q.z, hk[3] = q.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              hk[e] = u4 + e < nreg ? hp[kbeg + u4 + e] : 0.f;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int u = u4 + e;
            if (u < nreg) {
#pragma unroll
              for (int g = 0; g < 4; ++g)
                acc[g] = fmaf(hk[e], word_row<T>(rw[u / kPer][g], u % kPer),
                              acc[g]);
            }
          }
        }
      }
      }
      // shared-memory rows, four at a time where k is 16-byte aligned
      int i = 0;
      if ((k_res & 3) == 0) {
#pragma unroll 2
        for (; i + 4 <= nres; i += 4) {
          const float4 q = *reinterpret_cast<const float4*>(hp + k_res + i);
          const float hk[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const T* row = rs + (size_t)(i + e) * row_elems;
#pragma unroll
            for (int g = 0; g < 4; ++g)
              acc[g] = fmaf(hk[e], to_f32(row[g * cols_pad]), acc[g]);
          }
        }
      }
      for (; i < nres; ++i) {
        const float hk = hp[k_res + i];
        const T* row = rs + (size_t)i * row_elems;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          acc[g] = fmaf(hk, to_f32(row[g * cols_pad]), acc[g]);
      }
      // streamed rows, a chunk at a time
      if constexpr (kChunk > 0) for (int s0 = 0; s0 < nstr; s0 += kChunk) {
        if (s0 > 0)
          load_chunk(v, rcol, gate_stride, dh, k_str + s0,
                     min(kChunk, nstr - s0));
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (s0 + u < nstr) {
            const float hk = hp[k_str + s0 + u];
#pragma unroll
            for (int g = 0; g < 4; ++g)
              acc[g] = fmaf(hk, to_f32(v[u][g]), acc[g]);
          }
        }
      }
    }
    // partial sums double-buffered: a thread may start step t+1 while
    // another of its CTA still gates step t
    float* pt = part + (t & 1) * part_elems;
#pragma unroll
    for (int g = 0; g < 4; ++g) pt[(ks * 4 + g) * cols_pad + c] = acc[g];
    __syncthreads();

    if (gater) {
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float rec = 0.f;
#pragma unroll
        for (int s = 0; s < kSlices; ++s) rec += pt[(s * 4 + g) * cols_pad + c];
        pre[g] = (xw[g] + rec) + bg[g];
      }
      const float logf = log_sigmoid(pre[1]);
      const float m_new = fmaxf(logf + m, pre[0]);
      const float i_eff = expf(pre[0] - m_new);
      const float f_eff = expf(logf + m - m_new);
      const float o = 1.f / (1.f + expf(-pre[3]));
      cs = f_eff * cs + i_eff * tanhf(pre[2]);
      n = fmaxf(f_eff * n + i_eff, 1e-6f);
      h = o * cs / n;
      m = m_new;
      if (t + 1 < steps) send(h, cur ^ 1);
      if (owner) {
        const size_t o = (((size_t)b * steps + t) * H + head) * dh + col;
        a.hs[o] = h;
        if (a.pre != nullptr) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            a.pre[((((size_t)b * steps + t) * 4 + g) * H + head) * dh + col] =
                pre[g];
          a.c_all[o] = cs;
          a.n_all[o] = n;
          a.m_all[o] = m;
        }
      }
    }
    cur ^= 1;
  }

  if (owner) {
    a.h_out[sidx] = h;
    a.c_out[sidx] = cs;
    a.n_out[sidx] = n;
    a.m_out[sidx] = m;
  }
}

// The instantiation for a dtype and a column count: 256 threads up to 32
// columns a CTA (32 rows of each slice in registers, none streamed), 512 up
// to 64 (128 registers a thread: no register rows, 8-row streamed chunks).
template <typename T>
void* kernel_fn(int cols) {
  return cols <= 32
             ? reinterpret_cast<void*>(
                   slstm_cluster_kernel<T, 256, reg_words<T>(), 0>)
             : reinterpret_cast<void*>(slstm_cluster_kernel<T, 512, 0, 8>);
}

void* kernel_for(int dtype, int cols) {
  switch (dtype) {
    case 0: return kernel_fn<float>(cols);
    case 1: return kernel_fn<__nv_bfloat16>(cols);
    default: return nullptr;
  }
}

// Grid, kSlices * pad32(cols) threads, smem bytes, and a cluster of n_cta
// CTAs along x.
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
extern "C" int slstm_scan_setup(int dtype) {
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
// smem bytes of dynamic shared memory, the card can hold at once
// (cudaOccupancyMaxActiveClusters) -> *out.
extern "C" int slstm_scan_max_clusters(int dtype, int n_cta, int cols,
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

// dtype (of wx and r): 0 = float32, 1 = bfloat16.  wx [B, T, 4, H, dh],
// r [4, H, dh, dh], bias [4, H, dh] f32, state in/out [B, H, dh] f32 (the
// four inputs all null for the zero state), hs [B, T, H, dh] f32, and in
// saving mode pre [B, T, 4, H, dh], c_all, n_all, m_all [B, T, H, dh] f32
// (all four null otherwise); all contiguous on the current device.  The plan: n_cta CTAs a cluster, cols
// state columns a CTA, rps shared-memory rows a k slice, smem bytes of
// dynamic shared memory (smem_bytes()).
extern "C" int slstm_scan_launch(const void* wx, const void* r,
                                 const void* bias, const void* h0,
                                 const void* c0, const void* n0,
                                 const void* m0, void* hs, void* h_out,
                                 void* c_out, void* n_out, void* m_out,
                                 void* pre, void* c_all, void* n_all,
                                 void* m_all, int B, int T, int H, int dh,
                                 int dtype, int n_cta, int cols, int rps,
                                 int smem, void* stream) {
  if (B < 1 || T < 1 || H < 1 || dh < 1 || dh > kMaxDh || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const bool has_state = h0 != nullptr;
  if (has_state != (c0 != nullptr) || has_state != (n0 != nullptr) ||
      has_state != (m0 != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool saving = pre != nullptr;
  if (saving != (c_all != nullptr) || saving != (n_all != nullptr) ||
      saving != (m_all != nullptr))
    return (int)cudaErrorInvalidValue;
  // every column owned by exactly one CTA, none empty
  if (n_cta < 1 || n_cta > kMaxCluster || cols < 1 || cols > kMaxCols ||
      (long)n_cta * cols < dh || (long)(n_cta - 1) * cols >= dh)
    return (int)cudaErrorInvalidValue;
  const int kc = (dh + kSlices - 1) / kSlices;
  const int reg_rows = cols > 32 ? 0
                       : dtype == 1 ? 2 * reg_words<__nv_bfloat16>()
                                    : reg_words<float>();
  if (cols <= 32 && reg_rows + rps < kc)   // the 256-thread build streams none
    return (int)cudaErrorInvalidValue;
  if (rps < 0 || rps > kc || smem > kMaxSmem ||
      (size_t)smem != smem_bytes(dh, cols, rps, dtype == 1 ? 2 : 4))
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_for(dtype, cols);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;

  Args a{wx,
         r,
         static_cast<const float*>(bias),
         static_cast<const float*>(h0),
         static_cast<const float*>(c0),
         static_cast<const float*>(n0),
         static_cast<const float*>(m0),
         static_cast<float*>(hs),
         static_cast<float*>(h_out),
         static_cast<float*>(c_out),
         static_cast<float*>(n_out),
         static_cast<float*>(m_out),
         static_cast<float*>(pre),
         static_cast<float*>(c_all),
         static_cast<float*>(n_all),
         static_cast<float*>(m_all),
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
