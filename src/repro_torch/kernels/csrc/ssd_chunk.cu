// Fused Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_chunk.py:
//   ssd_chunk_fwd  <- ssd_chunk_fused (body _ssd_kernel)
//
// What it computes, per (bh) and chunk (q rows, seg = the within-chunk
// running sum of dt * a):
//   y_i    = sum_{j<=i} (c_i . b_j) exp(seg_i - seg_j) (x_j dt_j)
//          + (c_i . state) exp(seg_i)                 state before the chunk
//   state  = state exp(seg_last) + sum_j b_j exp(seg_last - seg_j) (x_j dt_j)^T
// with the state [N, P] starting at zero; the final state is returned.
//
// What bounds it on this card.  Per chunk the arithmetic is q^2/2 (N + P)
// multiply-adds for the intra-chunk term plus 2 q N P for the inter-chunk
// term and the state update, against (2P + 2N + 1) q elements streamed:
// at mamba2-130m's N = 128, P = 64, q = 256 that is ~50 flop per byte of
// f32 (~100 of bf16).  f32 inputs stay off the tensor cores (the reference
// holds them to 2e-5, which TF32 breaks), so the fp32 FMA rate (67 TFLOP/s)
// bounds them; bf16 inputs run on the tensor cores and the bytes bound
// them (chip_smoke.py reports both sides).
//
// What the design does about it.  The scan splits across CTAs as the SSD
// algorithm allows, in three kernels on the caller's stream:
//   1. ssd_state_simt (f32) / ssd_state_tc (bf16), per (bh, chunk, 64 x 64
//      tile of [N, P]): the chunk's own state contribution
//        st_c = sum_j b_j exp(seg_last - seg_j) dt_j x_j^T,
//      seg_last, and (tile 0) seg and dt of the chunk's rows for kernel 3.
//   2. ssd_state_pass, per (bh, elements of [N, P]): the recurrence
//        state_k = state_{k-1} exp(seg_last_k) + st_c_k,
//      serial over the chunks only; it leaves the state entering each
//      chunk in the workspace and writes the final state.
//   3. ssd_out_simt (f32) / ssd_out_tc (bf16), per (bh, chunk, row tile,
//      64 columns of P): the inter-chunk term (c_i . state_in) exp(seg_i),
//      then the intra-chunk term over the column tiles up to the diagonal,
//      the weights (c_i . b_j) exp(seg_i - seg_j) dt_j computed in fp32
//      and applied to x.  Row tiles launch heaviest (furthest from the
//      chunk's start) first, so the last wave is the light ones.
// The workspace comes from the caller, and nothing in shared memory is
// sized by the chunk.  bf16 inputs run every product on
// mma.sync.m16n8k16 with fp32 accumulators: C B^T exactly, the weights and
// B exp(.) dt rounded once to bf16, the incoming state rounded to bf16;
// operands through ldmatrix from a two-deep cp.async ring.  f32 inputs run
// SIMT FMA with an 8 x 8 register block per thread, operands from a
// two-deep cp.async ring.
//
// seg comes from a warp scan of the f32 products dt * a in f64, correctly
// rounded to f32: exp(seg_i - seg_j) inherits seg's absolute error, and
// |seg| reaches hundreds at a real layer's decay rates.  The f64 sums of
// these products are exact at any realistic range, so every CTA that
// sums a stretch of seg gets the same bits as the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using u16 = unsigned short;   // bf16 bits

constexpr int kMaxNTc = 128;  // N held by the bf16 kernel's C fragments
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; the bytes past src_bytes are zero-filled
// (src_bytes 0: no read at all).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes from global to shared
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// inclusive f64 scan and f64 sum over a warp
__device__ __forceinline__ double warp_scan(double v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Warp-wide: seg of this lane's entry, whose dt is d (0 outside the range),
// from the f64 running sum `carry` of the products before the warp's 32
// entries, which it advances by their products.  Entries outside get 0.
__device__ __forceinline__ float seg_of(float d, float a, bool in, double& carry) {
  const double v = warp_scan((double)__fmul_rn(d, a)) + carry;
  carry = __shfl_sync(0xffffffffu, v, 31);
  return in ? (float)v : 0.f;
}

__host__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// Warp-wide: seg_last of a chunk, the f64 sum of its products dt * a,
// rounded to f32.  The loads go out eight a lane at a time: one latency
// per 256 entries.
template <typename TD>
__device__ __forceinline__ float seg_total(const TD* dt, float a, int chunk) {
  double sum = 0.0;
  for (int jb = threadIdx.x % 32; jb < chunk; jb += 256) {
    float d[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) d[u] = jb + 32 * u < chunk ? to_f32(dt[jb + 32 * u]) : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) sum += (double)__fmul_rn(d[u], a);
  }
  return (float)warp_sum(sum);
}

// Kernel 2: the recurrence over the chunks,
//   state_k = state_{k-1} exp(seg_last_k) + st_c_k,
// elementwise over [N, P]: serial over the chunks only.  St holds each
// chunk's st_c on entry and the state entering the chunk on exit; Fin the
// final state.  A block owns kPassE * 256 consecutive elements of one bh;
// each thread kPassE of them, 256 apart, whose loads are in flight at
// once, the next chunk's issued before this chunk's stores.
constexpr int kPassE = 4;

__global__ void __launch_bounds__(256)
ssd_state_pass(float* __restrict__ St, const float* __restrict__ SegLast,
               float* __restrict__ Fin, int np, int nc, int blocks_per_bh) {
  const int bh = blockIdx.x / blocks_per_bh;
  const int e0 = (blockIdx.x % blocks_per_bh) * 256 * kPassE + threadIdx.x;
  float* st = St + (long long)bh * nc * np;
  const float* sl = SegLast + (long long)bh * nc;
  float state[kPassE], c[kPassE], next[kPassE];
#pragma unroll
  for (int u = 0; u < kPassE; ++u) {
    state[u] = next[u] = 0.f;
    c[u] = e0 + 256 * u < np ? st[e0 + 256 * u] : 0.f;
  }
#pragma unroll 1
  for (int k = 0; k < nc; ++k) {
    float* stk = st + (long long)k * np;
    if (k + 1 < nc) {
#pragma unroll
      for (int u = 0; u < kPassE; ++u)
        if (e0 + 256 * u < np) next[u] = stk[np + e0 + 256 * u];
    }
    const float decay = expf(sl[k]);
#pragma unroll
    for (int u = 0; u < kPassE; ++u) {
      const int e = e0 + 256 * u;
      if (e >= np) continue;
      stk[e] = state[u];
      state[u] = __fadd_rn(__fmul_rn(state[u], decay), c[u]);
      c[u] = next[u];
    }
  }
#pragma unroll
  for (int u = 0; u < kPassE; ++u) {
    const int e = e0 + 256 * u;
    if (e < np) Fin[(long long)bh * np + e] = state[u];
  }
}

// ---------------------------------------------------------------- f32 SIMT

namespace simt {

constexpr int kJC = 32;        // rows of a j-stage (kernel 1), k-chunk (kernel 3)
constexpr int kLDS = 68;       // pitch of a 64-wide f32 tile row

// dst[r][c] (pitch ld_dst) = src[r * ld_src + c] for r < rows, c < cols,
// else 0, over ROWS x COLS (COLS a multiple of 4, ROWS * COLS / 4 a
// multiple of NT).  VEC: every source row 16-byte aligned, so one cp.async
// per 4 floats (`safe`: a valid address for the copies that read
// nothing); otherwise element loads.  A kernel is built for each, so
// neither carries the other's code.
template <int ROWS, int COLS, int NT, bool VEC>
__device__ __forceinline__ void load_f32(float* dst, int ld_dst, const float* src,
                                         long long ld_src, int rows, int cols,
                                         const float* safe) {
  constexpr int Q = COLS / 4;
  static_assert(ROWS * Q % NT == 0, "whole passes only");
  if constexpr (VEC) {
#pragma unroll
    for (int it = 0; it < ROWS * Q / NT; ++it) {
      const int i = it * NT + threadIdx.x;
      const int r = i / Q, c = i % Q * 4;
      const bool in = r < rows && c < cols;
      cp_async16(dst + r * ld_dst + c, in ? src + r * ld_src + c : safe,
                 in ? 4 * min(4, cols - c) : 0);
    }
  } else {
#pragma unroll 1
    for (int it = 0; it < ROWS * Q / NT; ++it) {
      const int i = it * NT + threadIdx.x;
      const int r = i / Q, c = i % Q * 4;
      const bool in = r < rows && c < cols;
      const float* g = src + r * ld_src + c;
      float4 v;
      v.x = in ? g[0] : 0.f;
      v.y = in && c + 1 < cols ? g[1] : 0.f;
      v.z = in && c + 2 < cols ? g[2] : 0.f;
      v.w = in && c + 3 < cols ? g[3] : 0.f;
      *reinterpret_cast<float4*>(dst + r * ld_dst + c) = v;
    }
  }
}

// Kernel 1, f32.  grid (bh * nc, n tiles * p tiles), kThreads1 threads; a
// CTA owns a 64 x 64 tile of [N, P], in two groups of 64 threads that take
// the two 16-row halves of every stage; thread (tn, tp) of a group owns
// rows {4 tn + r, 32 + 4 tn + r} and columns {4 tp + u, 32 + 4 tp + u}, r,
// u < 4: an 8 x 8 block.  The groups' sums are added in one order at the
// end.  Tile 0's CTAs also write seg and dt (f32) of the chunk's rows.
constexpr int kThreads1 = 128;

template <typename TD, bool VEC>
__global__ void __launch_bounds__(kThreads1, 3)
ssd_state_simt(const float* __restrict__ X, const TD* __restrict__ DT,
               const float* __restrict__ A, const float* __restrict__ Bm,
               float* __restrict__ St, float* __restrict__ Seg, float* __restrict__ DtF,
               float* __restrict__ SegLast, int s, int p, int n, int chunk, int nc) {
  __shared__ __align__(16) float sB[2][kJC][kLDS];
  __shared__ __align__(16) float sX[2][kJC][kLDS];
  __shared__ float sScale[2][kJC];
  __shared__ float sLast;
  const int ptiles = (p + 63) / 64;
  const int bc = blockIdx.x, bh = bc / nc, ci = bc % nc;
  const int n0 = blockIdx.y / ptiles * 64, p0 = blockIdx.y % ptiles * 64;
  const int tid = threadIdx.x, warp = tid / 32, group = tid / 64;
  const int tn = tid % 64 / 8, tp = tid % 8;
  const long long base = (long long)bh * s + (long long)ci * chunk;
  const float* Bc = Bm + base * n + n0;
  const float* Xc = X + base * p + p0;
  const TD* dt = DT + base;
  const float a = A[bh];

  double carry = 0.0;   // warp 0: the f64 running sum before the next stage
  float d_next = 0.f;   // warp 0: dt of this lane's row of the next stage
  if (warp == 0) {
    const float last = seg_total(dt, a, chunk);
    if (tid == 0) {
      sLast = last;
      if (blockIdx.y == 0) SegLast[bc] = last;
    }
    if (tid < chunk) d_next = to_f32(dt[tid]);
  }
  __syncthreads();
  const float seg_last = sLast;

  // stage k: rows [32 k, 32 k + 32) of B and x, and warp 0 their weights
  // exp(seg_last - seg_j) dt_j (dt read a stage ahead)
  auto issue = [&](int k) {
    const int buf = k & 1, j0 = k * kJC;
    load_f32<kJC, 64, kThreads1, VEC>(&sB[buf][0][0], kLDS, Bc + (long long)j0 * n, n,
                                      chunk - j0, n - n0, Bm);
    load_f32<kJC, 64, kThreads1, VEC>(&sX[buf][0][0], kLDS, Xc + (long long)j0 * p, p,
                                      chunk - j0, p - p0, X);
    cp_async_commit();
    if (warp == 0) {
      const float d = d_next;
      const bool in = j0 + tid < chunk;
      d_next = j0 + kJC + tid < chunk ? to_f32(dt[j0 + kJC + tid]) : 0.f;
      const float seg = seg_of(d, a, in, carry);
      sScale[buf][tid] = in ? expf(seg_last - seg) * d : 0.f;
      if (in && blockIdx.y == 0) {
        Seg[base + j0 + tid] = seg;
        DtF[base + j0 + tid] = d;
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[r][u] = 0.f;
  const int nk = (chunk + kJC - 1) / kJC;
  issue(0);
  for (int k = 0; k < nk; ++k) {
    cp_async_wait_all();
    __syncthreads();   // stage k landed; stage k - 1's buffer is free
    if (k + 1 < nk) issue(k + 1);
    if (n0 + 4 * tn >= n) continue;   // rows past N: nothing to sum
    const int buf = k & 1;
#pragma unroll 4
    for (int j = group * kJC / 2; j < (group + 1) * kJC / 2; ++j) {
      const float sc = sScale[buf][j];
      const float4 b0 = *reinterpret_cast<const float4*>(&sB[buf][j][4 * tn]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sB[buf][j][32 + 4 * tn]);
      const float4 x0 = *reinterpret_cast<const float4*>(&sX[buf][j][4 * tp]);
      const float4 x1 = *reinterpret_cast<const float4*>(&sX[buf][j][32 + 4 * tp]);
      const float bv[8] = {b0.x * sc, b0.y * sc, b0.z * sc, b0.w * sc,
                           b1.x * sc, b1.y * sc, b1.z * sc, b1.w * sc};
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[r][u] = fmaf(bv[r], xv[u], acc[r][u]);
    }
  }

  // group 1's sums through shared memory (the B ring is free), added to
  // group 0's
  float* part = &sB[0][0][0];
  static_assert(64 * 64 <= 2 * kJC * kLDS, "a tile of sums fits in the B ring");
  __syncthreads();
  if (group == 1) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int u = 0; u < 8; ++u) part[(r * 8 + u) * 64 + tid % 64] = acc[r][u];
  }
  __syncthreads();
  if (group == 1) return;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[r][u] += part[(r * 8 + u) * 64 + tid];
  float* out = St + (long long)bc * n * p;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = n0 + (r < 4 ? 4 * tn + r : 32 + 4 * tn + r - 4);
    if (row >= n) continue;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int col = p0 + (u < 4 ? 4 * tp + u : 32 + 4 * tp + u - 4);
      if (col < p) out[(long long)row * p + col] = acc[r][u];
    }
  }
}

// Kernel 3, f32: 64 rows x 64 columns of y a CTA, 64 threads; thread
// (tr, tc) owns rows {tr + 8 a} and y columns {4 tc + u, 32 + 4 tc + u}
// (an 8 x 8 block) and score columns {tc + 8 b} of each 64-column tile.
// 64-row tiles leave a fifth of a 256-row chunk's C B^T above the
// diagonal (128-row ones a third), and four CTAs share an SM.
constexpr int kThreads = 64;
constexpr int kR = 64, kT = 64, kPT = 64;
constexpr int kLDA = kJC + 4;            // C chunk [kR][kLDA], B chunk [kT][kLDA]
constexpr int kLDW = kT + 4;             // weights [kR][kLDW]
constexpr int kAFloats = kR * kLDA;
constexpr int kBXFloats = kT * kLDA;     // >= kJC * kLDS: x or state chunk [kJC][kLDS]
constexpr int kSmem = (2 * kAFloats + 2 * kBXFloats + kR * kLDW + kR + 4 * kT) * 4;

// s[a][b] += sum_k A[tr + 8 a][k] B[tc + 8 b][k] over a k-chunk, two k a
// step (8-byte shared-memory loads).  DIAG (the diagonal column tile):
// only b <= a, the thread's blocks that reach on or below the diagonal.
template <bool DIAG>
__device__ __forceinline__ void mma_nt(float (&s)[8][8], const float* A, const float* B, int tr,
                                       int tc) {
#pragma unroll 2
  for (int k = 0; k < kJC; k += 2) {
    float2 av[8], bv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = *reinterpret_cast<const float2*>(A + (tr + 8 * i) * kLDA + k);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bv[j] = *reinterpret_cast<const float2*>(B + (tc + 8 * j) * kLDA + k);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < (DIAG ? i + 1 : 8); ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
      }
  }
}

// y[a][u] += sum_k A[tr + 8 a][k] Xs[k][col u] over a k-chunk, two k a
// step, for a >= A0 (the rows below: where A's rows are all zero, as the
// diagonal tile's weights are for rows 0..31 against its columns 32..63)
template <int LDA, int A0 = 0>
__device__ __forceinline__ void mma_nn(float (&y)[8][8], const float* A, const float* Xs, int tr,
                                       int tc) {
#pragma unroll 2
  for (int k = 0; k < kJC; k += 2) {
    float2 av[8];
#pragma unroll
    for (int i = A0; i < 8; ++i)
      av[i] = *reinterpret_cast<const float2*>(A + (tr + 8 * i) * LDA + k);
    const float4 x00 = *reinterpret_cast<const float4*>(Xs + k * kLDS + 4 * tc);
    const float4 x01 = *reinterpret_cast<const float4*>(Xs + k * kLDS + 32 + 4 * tc);
    const float4 x10 = *reinterpret_cast<const float4*>(Xs + (k + 1) * kLDS + 4 * tc);
    const float4 x11 = *reinterpret_cast<const float4*>(Xs + (k + 1) * kLDS + 32 + 4 * tc);
    const float xa[8] = {x00.x, x00.y, x00.z, x00.w, x01.x, x01.y, x01.z, x01.w};
    const float xb[8] = {x10.x, x10.y, x10.z, x10.w, x11.x, x11.y, x11.z, x11.w};
#pragma unroll
    for (int i = A0; i < 8; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        y[i][u] = fmaf(av[i].x, xa[u], y[i][u]);
        y[i][u] = fmaf(av[i].y, xb[u], y[i][u]);
      }
  }
}

// seg and dt of the 64 entries from j0 of a chunk into seg[64] and dts[64]
// (thread i: entry i), by 4-byte cp.async; 0 past the chunk
__device__ __forceinline__ void load_seg_dt(float* seg, float* dts, const float* Seg,
                                            const float* DtF, int j0, int chunk) {
  const int i = threadIdx.x, j = j0 + i;
  if (j < chunk) {
    cp_async4(seg + i, Seg + j);
    cp_async4(dts + i, DtF + j);
  } else {
    seg[i] = dts[i] = 0.f;
  }
}

// The weights of one 64 x 64 tile of C B^T, sc (rows tr + 8 a, columns
// tc + 8 b) into sW, and sc back to zero: sc exp(seg_i - seg_j) dt_j.  Off
// the diagonal every pair is below it; on it (DIAG, the tile's columns are
// its rows) a block b > a is above and 0, and a block b = a holds the
// diagonal.  Rows at or past `rows` (the chunk's end) get 0.
template <bool DIAG>
__device__ __forceinline__ void weights(float (&sc)[8][8], float* sW, const float* segr,
                                        const float* segc, const float* dtc, int tr, int tc,
                                        int rows) {
  float sj[8], dj[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sj[j] = segc[tc + 8 * j];
    dj[j] = dtc[tc + 8 * j];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int il = tr + 8 * i;
    const float si = segr[il];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float w = 0.f;
      if (!DIAG || j <= i) {
        const bool below = il < rows && (!DIAG || j < i || tc <= tr);
        w = sc[i][j] * (expf(below ? si - sj[j] : -1e30f) * dj[j]);
      }
      sW[il * kLDW + tc + 8 * j] = w;
      sc[i][j] = 0.f;
    }
  }
}

// grid (bh * nc * p tiles, row tiles), kThreads.  A run of stages, each one
// cp.async group into one of two buffers: per column tile the k-chunks of
// C B^T, then the two 32-row halves of x.  In chunks after the first, the
// stages of column tile 0 also bring the k-chunks of the incoming state
// (into the halves of the weights' buffer, free until that tile's weights)
// for the inter-chunk term C state, from the C chunks already there.
static_assert(2 * kJC * kLDS <= kR * kLDW, "two state k-chunks fit in the weights' buffer");

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 4)
ssd_out_simt(const float* __restrict__ X, const float* __restrict__ Seg,
             const float* __restrict__ DtF, const float* __restrict__ Bm,
             const float* __restrict__ Cm, const float* __restrict__ St,
             float* __restrict__ Y, int s, int p, int n, int chunk, int nc, int ptiles) {
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                        // [2][kR][kLDA]
  float* sBX = sA + 2 * kAFloats;          // [2][kBXFloats]
  float* sW = sBX + 2 * kBXFloats;         // [kR][kLDW]; tile 0: two state k-chunks
  float* sSegR = sW + kR * kLDW;           // [kR]
  float* sSegC = sSegR + kR;               // [2][kT]
  float* sDtC = sSegC + 2 * kT;            // [2][kT]
  const int tid = threadIdx.x;
  const int tr = tid / 8, tc = tid % 8;
  const int pt = blockIdx.x % ptiles, bc = blockIdx.x / ptiles, ci = bc % nc;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kR, p0 = pt * kPT;   // heaviest first
  const int rows = min(kR, chunk - i0);
  const long long base = (long long)(bc / nc) * s + (long long)ci * chunk;
  const float* Cc = Cm + (base + i0) * n;
  const float* Bc = Bm + base * n;
  const float* Xc = X + base * p + p0;
  const float* Sc = St + (long long)bc * n * p + p0;   // the state entering the chunk
  const bool inter = ci > 0;
  const int ntj = (i0 + rows + kT - 1) / kT;   // column tiles up to the diagonal
  const int nk = (n + kJC - 1) / kJC;
  const int per_tile = nk + kT / kJC;
  const int nstages = ntj * per_tile;

  if (i0 + tid < chunk) cp_async4(sSegR + tid, Seg + base + i0 + tid);
  else sSegR[tid] = 0.f;

  auto issue = [&](int st) {
    const int tj = st / per_tile, r = st % per_tile, j0 = tj * kT;
    float* bd = sBX + (st & 1) * kBXFloats;
    if (r < nk) {
      const int k0 = r * kJC;
      load_f32<kR, kJC, kThreads, VEC>(sA + (st & 1) * kAFloats, kLDA, Cc + k0, n, rows, n - k0,
                                       Cm);
      load_f32<kT, kJC, kThreads, VEC>(bd, kLDA, Bc + (long long)j0 * n + k0, n, chunk - j0,
                                       n - k0, Bm);
      if (tj == 0 && inter)
        load_f32<kJC, kPT, kThreads, VEC>(sW + (r & 1) * kJC * kLDS, kLDS,
                                          Sc + (long long)k0 * p, p, n - k0, p - p0, St);
      if (r == 0)
        load_seg_dt(sSegC + (tj & 1) * kT, sDtC + (tj & 1) * kT, Seg + base, DtF + base, j0,
                    chunk);
    } else {
      const int jx = j0 + (r - nk) * kJC;
      load_f32<kJC, kPT, kThreads, VEC>(bd, kLDS, Xc + (long long)jx * p, p, chunk - jx,
                                        p - p0, X);
    }
    cp_async_commit();
  };

  float y[8][8], sc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) y[i][j] = sc[i][j] = 0.f;

  issue(0);
  for (int st = 0; st < nstages; ++st) {
    cp_async_wait_all();
    __syncthreads();   // stage st landed; the other buffer's last reader is done
    if (st + 1 < nstages) issue(st + 1);
    const float* as = sA + (st & 1) * kAFloats;
    const float* bs = sBX + (st & 1) * kBXFloats;
    const int tj = st / per_tile, r = st % per_tile;
    const bool diag = tj == ntj - 1;   // kR == kT: the last column tile holds the diagonal
    static_assert(kR == kT && kT == 2 * kJC, "the diagonal tile's shape");
    if (r >= nk) {
      if (diag && r > nk) mma_nn<kLDW, 4>(y, sW + kJC, bs, tr, tc);
      else mma_nn<kLDW>(y, sW + (r - nk) * kJC, bs, tr, tc);
      continue;
    }
    if (diag) mma_nt<true>(sc, as, bs, tr, tc);
    else mma_nt<false>(sc, as, bs, tr, tc);
    if (tj == 0 && inter) mma_nn<kLDA>(y, as, sW + (r & 1) * kJC * kLDS, tr, tc);
    if (r < nk - 1) continue;
    if (tj == 0 && inter) {   // the inter-chunk term is complete: times exp(seg_i)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float e = expf(sSegR[tr + 8 * i]);
#pragma unroll
        for (int u = 0; u < 8; ++u) y[i][u] *= e;
      }
      __syncthreads();   // every thread is done with the state k-chunks in sW
    }
    // C B^T of the tile is complete: the weights into sW
    if (diag) weights<true>(sc, sW, sSegR, sSegC + (tj & 1) * kT, sDtC + (tj & 1) * kT, tr, tc,
                            chunk - i0);
    else weights<false>(sc, sW, sSegR, sSegC + (tj & 1) * kT, sDtC + (tj & 1) * kT, tr, tc,
                        chunk - i0);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = i0 + tr + 8 * i;
    if (row >= chunk) continue;
    float* yr = Y + (base + row) * p + p0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int col = u < 4 ? 4 * tc + u : 32 + 4 * tc + u - 4;
      if (p0 + col < p) yr[col] = y[i][u];
    }
  }
}

}  // namespace simt

// ------------------------------------------------------------ bf16 tensor cores

namespace tc {

constexpr int kThreads = 128;   // 4 warps, 16 rows each
constexpr int kR = 64, kT = 64, kPD = 64;
constexpr int kLDP = kPD + 8;   // pitch of a 64-wide bf16 tile row: conflict-free ldmatrix

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const u16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const u16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) @ b (16 x 8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, the hardware's approximation (relative error ~2^-22); ex2(-inf) is 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// the bf16 pair in w times (lo, hi), rounded to bf16 again
__device__ __forceinline__ unsigned scale_pair(unsigned w, float lo, float hi) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  return pack_bf16(f.x * lo, f.y * hi);
}

// Rows [0, ROWS) x columns [0, COLS) of a bf16 matrix (row r at src + r *
// ld) -> dst [ROWS][COLS + 8], zero at rows >= rows and columns >= cols.
// vec: every source row 16-byte aligned and cols a multiple of 8 or the
// tile's edge past it, so every 16-byte unit is one cp.async; otherwise
// element loads.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(u16* dst, const u16* src, long long ld, int rows,
                                          int cols, int vec, const u16* safe) {
  constexpr int CH = COLS / 8, LD = COLS + 8, N = ROWS * CH;
#pragma unroll 1
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const int r = i / CH, c = i % CH * 8;
    u16* d = dst + r * LD + c;
    const bool in = r < rows && c < cols;
    const u16* g = src + r * ld + c;
    if (vec) {
      cp_async16(d, in ? g : safe, in ? 2 * min(8, cols - c) : 0);
    } else {
      unsigned w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned lo = in && c + 2 * e < cols ? g[2 * e] : 0u;
        const unsigned hi = in && c + 2 * e + 1 < cols ? g[2 * e + 1] : 0u;
        w[e] = lo | hi << 16;
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): accumulator
// elements 0, 1 are row g, columns 2t, 2t + 1 of an n8 tile; elements 2, 3
// the same columns of row g + 8.  ldmatrix lane addresses: A rows
// (a_lane), B stored [n][k] (k_lane; with .trans, A stored [k][m]) and B
// stored [k][n] (v_lane, with .trans).
__device__ __forceinline__ int a_lane(int lane, int ld) { return (lane % 16) * ld + lane / 16 * 8; }
__device__ __forceinline__ int k_lane(int lane, int ld) {
  return (lane / 16 * 8 + lane % 8) * ld + lane / 8 % 2 * 8;
}
__device__ __forceinline__ int v_lane(int lane, int ld) { return (lane % 16) * ld + lane / 16 * 8; }

// Kernel 1, bf16.  grid (bh * nc, n tiles * p tiles of 64), kThreads; warp
// w owns rows n0 + 16 w .. + 15 of st_c, all 64 columns.  A = (B exp(.)
// dt)^T through ldmatrix.trans of B's [j][n] tile, scaled in registers and
// rounded to bf16; B operand x [j][p] through ldmatrix.trans.  Tile 0's
// CTAs also write seg and dt (f32) of the chunk's rows.
template <typename TD>
__global__ void __launch_bounds__(kThreads)
ssd_state_tc(const u16* __restrict__ X, const TD* __restrict__ DT, const float* __restrict__ A,
             const u16* __restrict__ Bm, float* __restrict__ St, float* __restrict__ Seg,
             float* __restrict__ DtF, float* __restrict__ SegLast, int s, int p, int n,
             int chunk, int nc, int vec_n, int vec_p) {
  __shared__ __align__(16) u16 sB[2][kT][kLDP];
  __shared__ __align__(16) u16 sX[2][kT][kLDP];
  __shared__ float sScale[2][kT];
  __shared__ float sLast;
  const int ptiles = (p + kPD - 1) / kPD;
  const int bc = blockIdx.x, bh = bc / nc, ci = bc % nc;
  const int n0 = blockIdx.y / ptiles * 64, p0 = blockIdx.y % ptiles * kPD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const long long base = (long long)bh * s + (long long)ci * chunk;
  const u16* Bc = Bm + base * n + n0;
  const u16* Xc = X + base * p + p0;
  const TD* dt = DT + base;
  const float a = A[bh];

  double carry = 0.0;   // warp 0: the f64 running sum before the next stage
  float d_next[2] = {0.f, 0.f};   // warp 0: dt of this lane's rows of the next stage
  if (warp == 0) {
    const float last = seg_total(dt, a, chunk);
    if (tid == 0) {
      sLast = last;
      if (blockIdx.y == 0) SegLast[bc] = last;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (32 * h + lane < chunk) d_next[h] = to_f32(dt[32 * h + lane]);
  }
  __syncthreads();
  const float seg_last = sLast;

  auto issue = [&](int k) {
    const int buf = k & 1, j0 = k * kT;
    load_tile<kT, 64>(&sB[buf][0][0], Bc + (long long)j0 * n, n, chunk - j0, n - n0, vec_n, Bm);
    load_tile<kT, kPD>(&sX[buf][0][0], Xc + (long long)j0 * p, p, chunk - j0, p - p0, vec_p, X);
    cp_async_commit();
    if (warp == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + 32 * h + lane;
        const float d = d_next[h];
        d_next[h] = j + kT < chunk ? to_f32(dt[j + kT]) : 0.f;
        const float seg = seg_of(d, a, j < chunk, carry);
        sScale[buf][32 * h + lane] = j < chunk ? expf(seg_last - seg) * d : 0.f;
        if (j < chunk && blockIdx.y == 0) {
          Seg[base + j] = seg;
          DtF[base + j] = d;
        }
      }
    }
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int ka = k_lane(lane, kLDP) + 16 * warp, kv = v_lane(lane, kLDP);
  const int nk = (chunk + kT - 1) / kT;
  issue(0);
  for (int k = 0; k < nk; ++k) {
    cp_async_wait_all();
    __syncthreads();
    if (k + 1 < nk) issue(k + 1);
    const int buf = k & 1;
    if (n0 + 16 * warp >= n) continue;   // rows past N
    const float* sc = sScale[buf];
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      unsigned af[4];
      ldsm_x4_trans(af, &sB[buf][0][0] + kk * 16 * kLDP + ka);
      const float s0 = sc[kk * 16 + 2 * t], s1 = sc[kk * 16 + 2 * t + 1];
      const float s8 = sc[kk * 16 + 2 * t + 8], s9 = sc[kk * 16 + 2 * t + 9];
      af[0] = scale_pair(af[0], s0, s1);
      af[1] = scale_pair(af[1], s0, s1);
      af[2] = scale_pair(af[2], s8, s9);
      af[3] = scale_pair(af[3], s8, s9);
#pragma unroll
      for (int np = 0; np < kPD / 16; ++np) {
        unsigned b[4];
        ldsm_x4_trans(b, &sX[buf][0][0] + kk * 16 * kLDP + kv + np * 16);
        mma_bf16(acc[2 * np], af, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], af, b[2], b[3]);
      }
    }
  }

  float* out = St + (long long)bc * n * p;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = n0 + 16 * warp + g + 8 * h;
    if (row >= n) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = p0 + 8 * i + 2 * t;
      if (col < p) out[(long long)row * p + col] = acc[i][2 * h];
      if (col + 1 < p) out[(long long)row * p + col + 1] = acc[i][2 * h + 1];
    }
  }
}

// Kernel 3, bf16: 64 rows x 64 columns of y a CTA, kThreads; warp w owns
// rows 16 w .. + 15, its C fragments held in registers for the whole CTA
// (ND / 16 of them: N <= kMaxNTc).  Shared memory: C [64][ND + 8], the B
// ring [2][64][ND + 8], the x ring [2][64][kLDP], the incoming state
// [ND][kLDP] in bf16, and seg / dt of the rows and of the column tiles.
template <int ND>
struct OutCfg {
  static constexpr int LDN = ND + 8;
  static constexpr int SMEM = (kR * LDN + 2 * kT * LDN + 2 * kT * kLDP + ND * kLDP) * 2 +
                              (kR + 4 * kT) * 4;
};

template <int ND>
__global__ void __launch_bounds__(kThreads)
ssd_out_tc(const u16* __restrict__ X, const float* __restrict__ Seg,
           const float* __restrict__ DtF, const u16* __restrict__ Bm,
           const u16* __restrict__ Cm, const float* __restrict__ St, u16* __restrict__ Y,
           int s, int p, int n, int chunk, int nc, int ptiles, int vec_n, int vec_p) {
  constexpr int LDN = OutCfg<ND>::LDN, KS = ND / 16, NO = kPD / 8;
  extern __shared__ __align__(16) u16 smem16[];
  u16* sC = smem16;                    // [kR][LDN]
  u16* sB = sC + kR * LDN;             // [2][kT][LDN]
  u16* sX = sB + 2 * kT * LDN;         // [2][kT][kLDP]
  u16* sS = sX + 2 * kT * kLDP;        // [ND][kLDP]
  float* sSegR = reinterpret_cast<float*>(sS + ND * kLDP);   // [kR]
  float* sSegC = sSegR + kR;                                   // [2][kT]
  float* sDtC = sSegC + 2 * kT;                                // [2][kT]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int pt = blockIdx.x % ptiles, bc = blockIdx.x / ptiles, ci = bc % nc;
  const int ti = gridDim.y - 1 - blockIdx.y;   // heaviest first
  const int i0 = ti * kR, p0 = pt * kPD;
  const int rows = min(kR, chunk - i0);
  const long long base = (long long)(bc / nc) * s + (long long)ci * chunk;
  const u16* Bc = Bm + base * n;
  const u16* Xc = X + base * p + p0;
  const float* Sg = Seg + base;
  const float* Dg = DtF + base;

  load_tile<kR, ND>(sC, Cm + (base + i0) * n, n, rows, n, vec_n, Cm);
  if (tid < kR) {
    if (i0 + tid < chunk) cp_async4(sSegR + tid, Sg + i0 + tid);
    else sSegR[tid] = 0.f;
  }
  auto issue = [&](int tj) {   // column tile tj: B, x, seg and dt
    const int slot = tj & 1, j0 = tj * kT;
    load_tile<kT, ND>(sB + slot * kT * LDN, Bc + (long long)j0 * n, n, chunk - j0, n, vec_n, Bm);
    load_tile<kT, kPD>(sX + slot * kT * kLDP, Xc + (long long)j0 * p, p, chunk - j0, p - p0,
                       vec_p, X);
    const int i = tid % kT, j = j0 + i;
    float* d = (tid < kT ? sSegC : sDtC) + slot * kT + i;
    if (j < chunk) cp_async4(d, (tid < kT ? Sg : Dg) + j);
    else *d = 0.f;
    cp_async_commit();
  };
  issue(0);
  if (ci > 0) {   // the incoming state, rounded to bf16
    const float* Sc = St + (long long)bc * n * p + p0;
#pragma unroll 1
    for (int i = tid; i < ND * kPD / 2; i += kThreads) {
      const int r = i / (kPD / 2), c = i % (kPD / 2) * 2;
      const bool in = r < n;
      const float lo = in && p0 + c < p ? Sc[(long long)r * p + c] : 0.f;
      const float hi = in && p0 + c + 1 < p ? Sc[(long long)r * p + c + 1] : 0.f;
      *reinterpret_cast<unsigned*>(sS + r * kLDP + c) = pack_bf16(lo, hi);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  unsigned cf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) ldsm_x4(cf[ks], sC + 16 * warp * LDN + a_lane(lane, LDN) + 16 * ks);
  const int kb = k_lane(lane, LDN), kv = v_lane(lane, kLDP);
  const int row0 = i0 + 16 * warp + g;   // this lane's rows: row0, row0 + 8
  const float segr[2] = {sSegR[16 * warp + g], sSegR[16 * warp + g + 8]};

  float y[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) y[i][0] = y[i][1] = y[i][2] = y[i][3] = 0.f;
  if (ci > 0) {   // y = (C state) exp(seg_i)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        unsigned b[4];
        ldsm_x4_trans(b, sS + ks * 16 * kLDP + kv + np * 16);
        mma_bf16(y[2 * np], cf[ks], b[0], b[1]);
        mma_bf16(y[2 * np + 1], cf[ks], b[2], b[3]);
      }
    const float e0 = ex2(segr[0] * kLog2e), e1 = ex2(segr[1] * kLog2e);
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      y[i][0] *= e0;
      y[i][1] *= e0;
      y[i][2] *= e1;
      y[i][3] *= e1;
    }
  }

  const int ntj = ti + 1;   // kR == kT: column tiles 0 .. ti
  for (int tj = 0; tj < ntj; ++tj) {
    if (tj > 0) {
      cp_async_wait_all();
      __syncthreads();   // tile tj landed; every warp is done with tile tj - 1's slot
    }
    if (tj + 1 < ntj) issue(tj + 1);
    const int slot = tj & 1;
    const u16* Bt = sB + slot * kT * LDN;
    const u16* Xt = sX + slot * kT * kLDP;
    const float* segc = sSegC + slot * kT;
    const float* dtc = sDtC + slot * kT;

    // S = C B^T
    float sc[kT / 8][4];
#pragma unroll
    for (int i = 0; i < kT / 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < kT / 16; ++np) {
        unsigned b[4];
        ldsm_x4(b, Bt + np * 16 * LDN + kb + ks * 16);
        mma_bf16(sc[2 * np], cf[ks], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], cf[ks], b[2], b[3]);
      }

    // weights exp(seg_i - seg_j) dt_j below the diagonal, packed to bf16 A
    // fragments
    unsigned w[kT / 16][4];
    const int j0 = tj * kT;
#pragma unroll
    for (int i = 0; i < kT / 8; ++i) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = 8 * i + 2 * t + (e & 1);
        const int row = row0 + 8 * (e / 2);
        v[e] = j0 + jl <= row ? sc[i][e] * (ex2((segr[e / 2] - segc[jl]) * kLog2e) * dtc[jl])
                              : 0.f;
      }
      w[i / 2][(i & 1) * 2] = pack_bf16(v[0], v[1]);
      w[i / 2][(i & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
    }

    // y += W x
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        unsigned b[4];
        ldsm_x4_trans(b, Xt + kk * 16 * kLDP + kv + np * 16);
        mma_bf16(y[2 * np], w[kk], b[0], b[1]);
        mma_bf16(y[2 * np + 1], w[kk], b[2], b[3]);
      }
  }

  const bool pair = p % 2 == 0 && (reinterpret_cast<unsigned long long>(Y) & 3) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= chunk) continue;
    u16* yr = Y + (base + row) * p + p0;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int col = 8 * i + 2 * t;
      if (p0 + col >= p) continue;
      if (pair) {
        *reinterpret_cast<__nv_bfloat162*>(yr + col) =
            __floats2bfloat162_rn(y[i][2 * h], y[i][2 * h + 1]);
      } else {
        yr[col] = __bfloat16_as_ushort(__float2bfloat16(y[i][2 * h]));
        if (p0 + col + 1 < p) yr[col + 1] = __bfloat16_as_ushort(__float2bfloat16(y[i][2 * h + 1]));
      }
    }
  }
}

}  // namespace tc

// The attributes of a kernel that uses more than 48 KB of shared memory
// (and the carveout that lets two CTAs share an SM), set once per device.
template <typename K>
cudaError_t set_smem(K kernel, int bytes, int& set_device) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device != set_device) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess) set_device = device;
  }
  return err;
}

// The workspace (floats): each chunk's state [bh][nc][n][p], seg and dt of
// every row, each chunk's seg_last.
struct Plan {
  int nc;
  long long st, seg, dtf, seg_last, total;
};

Plan make_plan(int bh, int s, int p, int n, int chunk) {
  Plan g;
  g.nc = s / chunk;
  g.st = 0;
  g.seg = g.st + (long long)bh * g.nc * n * p;
  g.dtf = g.seg + (long long)bh * s;
  g.seg_last = g.dtf + (long long)bh * s;
  g.total = g.seg_last + (long long)bh * g.nc;
  return g;
}

struct Args {
  const void *x, *dt, *b, *c;
  const float* a;
  void* y;
  float* fin;
  float* ws;
  int bh, s, p, n, chunk;
  cudaStream_t stream;
};

// kernel 2, after either route's kernel 1
int launch_pass(const Args& g, const Plan& pl) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int np = g.n * g.p, per = (np + 256 * kPassE - 1) / (256 * kPassE);
  ssd_state_pass<<<g.bh * per, 256, 0, g.stream>>>(g.ws + pl.st, g.ws + pl.seg_last, g.fin, np,
                                                   pl.nc, per);
  return (int)cudaGetLastError();
}

template <bool VEC>
int run_f32(const Args& g, const Plan& pl) {
  const int ptiles = (g.p + 63) / 64, rtiles = (g.chunk + simt::kR - 1) / simt::kR;
  const float* x = static_cast<const float*>(g.x);
  const float* b = static_cast<const float*>(g.b);
  simt::ssd_state_simt<float, VEC>
      <<<dim3(g.bh * pl.nc, (g.n + 63) / 64 * ptiles), simt::kThreads1, 0, g.stream>>>(
          x, static_cast<const float*>(g.dt), g.a, b, g.ws + pl.st, g.ws + pl.seg,
          g.ws + pl.dtf, g.ws + pl.seg_last, g.s, g.p, g.n, g.chunk, pl.nc);
  const int err = launch_pass(g, pl);
  if (err != 0) return err;
  auto kernel = simt::ssd_out_simt<VEC>;
  static int set_device = -1;
  const cudaError_t e = set_smem(kernel, simt::kSmem, set_device);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(g.bh * pl.nc * ptiles, rtiles), simt::kThreads, simt::kSmem, g.stream>>>(
      x, g.ws + pl.seg, g.ws + pl.dtf, b, static_cast<const float*>(g.c), g.ws + pl.st,
      static_cast<float*>(g.y), g.s, g.p, g.n, g.chunk, pl.nc, ptiles);
  return (int)cudaGetLastError();
}

template <int ND>
int launch_out_tc(const Args& g, const Plan& pl, int ptiles, int rtiles, int vec_n, int vec_p) {
  auto kernel = tc::ssd_out_tc<ND>;
  static int set_device = -1;
  const cudaError_t e = set_smem(kernel, tc::OutCfg<ND>::SMEM, set_device);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(g.bh * pl.nc * ptiles, rtiles), tc::kThreads, tc::OutCfg<ND>::SMEM, g.stream>>>(
      static_cast<const u16*>(g.x), g.ws + pl.seg, g.ws + pl.dtf, static_cast<const u16*>(g.b),
      static_cast<const u16*>(g.c), g.ws + pl.st, static_cast<u16*>(g.y), g.s, g.p, g.n,
      g.chunk, pl.nc, ptiles, vec_n, vec_p);
  return (int)cudaGetLastError();
}

template <typename TD>
int run_bf16(const Args& g, const Plan& pl) {
  const int ptiles = (g.p + tc::kPD - 1) / tc::kPD, rtiles = (g.chunk + tc::kR - 1) / tc::kR;
  const int vec_n = g.n % 8 == 0 && aligned16(g.b) && aligned16(g.c);
  const int vec_p = g.p % 8 == 0 && aligned16(g.x);
  tc::ssd_state_tc<TD><<<dim3(g.bh * pl.nc, (g.n + 63) / 64 * ptiles), tc::kThreads, 0,
                         g.stream>>>(
      static_cast<const u16*>(g.x), static_cast<const TD*>(g.dt), g.a,
      static_cast<const u16*>(g.b), g.ws + pl.st, g.ws + pl.seg, g.ws + pl.dtf,
      g.ws + pl.seg_last, g.s, g.p, g.n, g.chunk, pl.nc, vec_n, vec_p);
  const int err = launch_pass(g, pl);
  if (err != 0) return err;
  if (g.n <= 32) return launch_out_tc<32>(g, pl, ptiles, rtiles, vec_n, vec_p);
  if (g.n <= 64) return launch_out_tc<64>(g, pl, ptiles, rtiles, vec_n, vec_p);
  return launch_out_tc<128>(g, pl, ptiles, rtiles, vec_n, vec_p);
}

bool takes(int x_bf16, int dt_bf16, int bh, int s, int p, int n, int chunk) {
  if (bh < 1 || s < 1 || p < 1 || n < 1 || chunk < 1 || s % chunk != 0 || (dt_bf16 && !x_bf16) ||
      (x_bf16 && n > kMaxNTc))
    return false;
  const long long nc = s / chunk, ptiles = (p + 63) / 64, rtiles = (chunk + 63) / 64;
  return bh * nc <= 0x7fffffffLL && bh * nc * ptiles <= 0x7fffffffLL && rtiles <= 65535 &&
         bh * (((long long)n * p + 1023) / 1024) <= 0x7fffffffLL &&
         (long long)n * p < 0x7fffffffLL && ((n + 63) / 64) * ptiles <= 65535;
}

}  // namespace

extern "C" {

// y, final state = SSD(x, dt, a, b, c).  x, y: [bh, s, p]; dt: [bh, s];
// a: [bh] f32; b, c: [bh, s, n]; fin: [bh, n, p] f32; all contiguous.
// x/b/c/y are bf16 (x_bf16 = 1) or f32; dt is bf16 (dt_bf16 = 1) or f32.
// s must be a multiple of chunk; bf16 takes n <= 128.  ws: the caller's
// f32 workspace of bh * (nc * n * p + 2 * s + nc) floats, nc = s / chunk
// (Plan).  Launches the three kernels on `stream`; returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// arguments it does not take.
int ssd_chunk_fwd(int x_bf16, int dt_bf16, const void* x, const void* dt, const void* a,
                  const void* b, const void* c, void* y, void* fin, void* ws, int bh, int s,
                  int p, int n, int chunk, void* stream) {
  if (!takes(x_bf16, dt_bf16, bh, s, p, n, chunk)) return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(bh, s, p, n, chunk);
  const Args g{x, dt, b, c, static_cast<const float*>(a), y, static_cast<float*>(fin),
               static_cast<float*>(ws), bh, s, p, n, chunk, static_cast<cudaStream_t>(stream)};
  if (!x_bf16) {
    // every f32 row the kernels copy 16-byte aligned: cp.async; else element loads
    const bool vec = n % 4 == 0 && p % 4 == 0 && aligned16(x) && aligned16(b) &&
                     aligned16(c) && aligned16(ws);
    return vec ? run_f32<true>(g, pl) : run_f32<false>(g, pl);
  }
  return dt_bf16 ? run_bf16<__nv_bfloat16>(g, pl) : run_bf16<float>(g, pl);
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
