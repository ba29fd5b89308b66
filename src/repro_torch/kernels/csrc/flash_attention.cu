// Flash attention forward for Hopper (sm_90a): two kernels, one per input type.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention_fwd  <- flash_attention (:69, body _flash_kernel at :27),
//                           reached through ops.flash_mha
// The wrapper (kernels/flash_attention.py, flash_route) picks the kernel and
// passes its choice in: bf16 inputs go to flash_fwd_tc (tensor cores), f32
// inputs to flash_fwd_kernel (SIMT fp32; the reference holds f32 to
// rel_err < 1e-5, which TF32 would break).
//
// What both compute.  O[bh] = softmax(scale * Q[bh] K[kv]^T, masked) V[kv]
// with kv = bh / group (GQA without copying the kv heads).  The mask is
// top-left causal (row i sees columns j <= i) with the finite -1e30 of the
// reference; kv positions in [skv, skv_pad) are zero keys and zero values
// (the reference's zero padding to a multiple of block_kv, seen by every
// row the mask lets see them), and positions at or beyond skv_pad do not
// exist.  Running max, sum and accumulator are fp32; the output is
// acc / max(l, 1e-30) in Q's type.  Masked entries add exactly zero once a
// row has seen column 0, which is in its first tile, so the reference's
// block-skip rule changes no number and both kernels skip at their own
// tile granularity.
//
// What bounds them on this card.  4 * D flop per (row, visible column)
// pair against (2 + 2 / group) * S * D elements moved.  In bf16 the bytes
// over 3.35 TB/s bound a causal layer up to S near 1000 (885 at group 2),
// and the operations over the tensor cores' 989 TFLOP/s above it.  In f32
// the operations over the 67 TFLOP/s fp32 peak bound it from S near 160
// at group 1, 120 at group 2 (chip_smoke.py reports both sides).  What sets the f32 kernel's pace
// is shared memory, not the FMA pipes: a warp's 16-byte shared load takes
// four of the SM's cycles however many lanes share its address, so a
// thread tile of R x C products fed by float4s of four columns caps the
// FMA pipes at 2 R C / (R + C) / 8 of peak: 67% at 8 x 4, 100% at 8 x 8.
//
// flash_fwd_tc (bf16): the FlashAttention-2 pattern on mma.sync.  A CTA
// of 4 warps takes 64 * MT query rows of one bh, each warp 16 * MT rows;
// the grid issues the heaviest query tiles (the last ones under causality)
// of every head first.  With mma.sync every operand goes through
// registers, and the ldmatrix traffic from shared memory sets the pace (a
// warp's K and V fragments serve only its own rows).  So on grids that
// fill the card twice over with 128-row CTAs, each warp owns two m16 tiles
// (MT = 2, D <= 128) and every K and V fragment feeds both; Q is then
// re-read by ldmatrix at each tile.  On smaller grids (a prefill layer at
// S 512) 64-row CTAs keep more SMs busy, and Q's fragments are loaded once,
// into registers.  Key tiles of 64 rows (32 where the accumulators leave
// fewer registers) come through a 2-deep cp.async ring: tile j + 1 is in
// flight during the whole of tile j's S = Q K^T, softmax and O += P V.
// Rows past the sequence (keys >= skv, queries >= sq) and columns past D
// (padded up to 16) are zero-filled in shared memory, which changes no
// sum.  S is m16n8k16 bf16 products with fp32 accumulate, K rows as stored
// being the .col B operand; it is scaled in fp32 after the product (scale
// * log2(e), for the hardware's 2^x), then masked with -1e30 only on the
// tiles that need it.  Row max and sum go across the 4 lanes of a quad.
// P is packed to bf16 straight from S's accumulator layout into A
// fragments (no trip through shared memory) and multiplied with V by
// ldmatrix.trans.  That rounding of each probability to bf16 (relative
// error <= 2^-9) is the one the reference does not make; the row sum l
// keeps the fp32 probabilities.  Padded rows are never written.
//
// flash_fwd_kernel (f32): SIMT fp32 FMAs (TF32 would break the
// reference's 1e-5).  A CTA takes BQ query rows of one bh, each warp its
// own rows and each thread RM of them in both products, so a row's max,
// sum and rescale stay in the lanes that share it (warp shuffles); the
// grid issues the heaviest query tiles first.  Per head dim padded to KD
// (thread tiles of S = Q K^T and of O, and the caps they leave):
//   KD 32, 64: 128 rows of 4 warps, 64-key tiles; S 8 x 8, O 8 x 4 / 8 x 8
//              (100%, 67% / 100%); two CTAs an SM;
//   KD 80:     128 rows of 4 warps, 32-key tiles; S 4 x 8, O 4 x 20
//              (67%, 83%); two CTAs an SM;
//   KD 128:    64-key tiles; S 8 x 4, O 8 x 8 (67%, 100%); 64 rows of 4
//              warps, two CTAs an SM (112 KB each), or, on grids of
//              2 bh ceil(sq / 128) >= 3 SMs, 128 rows of 8 warps, one CTA
//              an SM, which halves the K and V copies a row costs;
//   KD 256:    64 rows of 8 warps, 64-key tiles; S 4 x 4, O 4 x 16 (50%,
//              80%); one CTA an SM (208 KB).  8 x 16 accumulators spill.
// Q (scaled once, in shared memory), one K tile and one V tile come by
// 16-byte cp.async: K and V alternate through their one buffer each, K_{j+1}
// in flight during tile j's softmax and P V, V_{j+1} during tile j + 1's
// Q K^T, so two barriers a tile serve the ring; copies of whole tiles at
// d == KD take no masks.  D not a multiple of 4 (33, 100), or unaligned
// tensors, take element loads instead.  P goes from S's registers to the
// warp's own rows of shared memory (a __syncwarp, no CTA barrier).  Each
// score is one fmaf chain over the columns in order, of q * scale (rounded
// as the plain version rounds it) and k, so logits in the thousands still
// match it; probabilities are ex2((s - m) log2 e).  Only tiles that
// straddle the diagonal or the padded end are masked, and a warp whose
// rows all lie above a tile skips its products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

// ------------------------------------------------- bf16: the tensor cores

namespace tc {

using u16 = unsigned short;  // bf16 bits: copied, fed to mma, never converted

constexpr int kThreads = 128;              // 4 warps
constexpr int kStages = 2;                 // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

// The tile per padded head dim KD (a multiple of 16, >= d) and MT, the
// m16 row tiles each warp owns (the CTA takes 64 * MT query rows).  What
// sets the pace is ldmatrix traffic: each K and V fragment a warp loads
// feeds MT m16 tiles, and with MT = 1 the Q fragments are loaded once, into
// registers.  The key tile BN is as large as the registers allow without
// spills (MT = 2 holds KD accumulators a thread).
template <int KD, int MT>
struct Cfg {
  static constexpr int ROWS = 64 * MT;   // query rows per CTA
  static constexpr int BN = KD > 128 || (MT == 2 && KD > 80) ? 32 : 64;   // keys per tile
  static constexpr bool QREG = MT == 1;  // Q fragments in registers, else re-read per tile
  static constexpr int LD = KD + 8;      // smem pitch: 16-byte rows, conflict-free ldmatrix
  static constexpr int SMEM = (ROWS + 2 * kStages * BN) * LD * (int)sizeof(u16);
};

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// 2^x, the hardware's approximation (relative error ~2^-22); ex2(-1e30) is 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [row0, row0 + R) of a [rows][d] matrix -> dst [R][KD + 8], zero past
// row `rows` and column d.  vec: d % 8 == 0 and src 16-byte aligned, so
// every 16-byte unit is one cp.async; otherwise element loads (any d).
template <int R, int KD>
__device__ __forceinline__ void load_tile(u16* dst, const u16* src, int row0, int rows, int d,
                                          bool vec) {
  constexpr int CH = KD / 8, LD = KD + 8, N = R * CH;
  // not unrolled: the accumulators leave no registers for hoisted addresses
#pragma unroll 1
  for (int it = 0; it < (N + kThreads - 1) / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    if (N % kThreads != 0 && i >= N) break;
    const int r = i / CH, c = i % CH * 8, row = row0 + r;
    u16* s = dst + r * LD + c;
    const bool in = row < rows && c < d;
    const u16* g = src + (long long)row * d + c;
    if (vec) {
      cp_async16(s, in ? g : src, in ? 16 : 0);
    } else {
      unsigned w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned lo = in && c + 2 * e < d ? g[2 * e] : 0u;
        const unsigned hi = in && c + 2 * e + 1 < d ? g[2 * e + 1] : 0u;
        w[e] = lo | hi << 16;
      }
      *reinterpret_cast<uint4*>(s) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Columns col, col + 1 of one output row (bf16 bits), those below d.
__device__ __forceinline__ void store_pair(u16* row, int col, int d, bool pair, float x,
                                           float y) {
  if (col >= d) return;
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x, y);
  } else {
    row[col] = __bfloat16_as_ushort(__float2bfloat16(x));
    if (col + 1 < d) row[col + 1] = __bfloat16_as_ushort(__float2bfloat16(y));
  }
}

// grid (bh, query tiles); block kThreads.  Fragment layout of m16n8k16
// (g = lane / 4, t = lane % 4): accumulator elements 0, 1 are row g,
// columns 2t, 2t + 1 of an n8 tile; elements 2, 3 the same columns of row
// g + 8.  Warp w owns rows [16 MT w, 16 MT (w + 1)) of the CTA's tile.
template <int KD, int MT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc(const u16* __restrict__ Q, const u16* __restrict__ K, const u16* __restrict__ V,
             u16* __restrict__ O, int group, int sq, int skv, int skv_pad, int d,
             float scale_log2, int causal, int vec) {
  using C = Cfg<KD, MT>;
  constexpr int BN = C::BN, LD = C::LD, ROWS = C::ROWS;
  constexpr int KS = KD / 16;   // k16 steps of Q K^T
  constexpr int NS = BN / 8;    // n8 tiles of a score row block
  constexpr int NO = KD / 8;    // n8 tiles of an output row block
  extern __shared__ __align__(16) u16 tc_smem[];
  u16* sQ = tc_smem;                  // [ROWS][LD]
  u16* sK = sQ + ROWS * LD;           // [kStages][BN][LD]
  u16* sV = sK + kStages * BN * LD;   // [kStages][BN][LD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;   // heaviest tiles first
  const int wrow = q0 + warp * 16 * MT;                 // this warp's first row
  const u16* Qb = Q + (long long)bh * sq * d;
  const u16* Kb = K + (long long)(bh / group) * skv * d;
  const u16* Vb = V + (long long)(bh / group) * skv * d;

  // columns at or beyond skv_pad do not exist; causal rows stop at the diagonal
  const int kv_end = causal ? min(skv_pad, min(q0 + ROWS, sq)) : skv_pad;
  const int ntiles = (kv_end + BN - 1) / BN;

  load_tile<ROWS, KD>(sQ, Qb, q0, sq, d, vec);
  load_tile<BN, KD>(sK, Kb, 0, skv, d, vec);
  load_tile<BN, KD>(sV, Vb, 0, skv, d, vec);
  cp_async_commit();

  // ldmatrix addresses of this lane: A rows (Q), B rows of K (keys, d
  // halves) and of V (keys, for .trans)
  const u16* q_lane = sQ + (warp * 16 * MT + lane % 16) * LD + lane / 16 * 8;
  const int k_lane = (lane / 16 * 8 + lane % 8) * LD + lane / 8 % 2 * 8;
  const int v_lane = (lane % 16) * LD + lane / 16 * 8;

  float o[MT][NO][4];
  float m[MT][2], l[MT][2];   // rows g, g + 8 of each m16 tile; m in log2 units
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NO; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }
  unsigned qf[C::QREG ? KS : 1][4];

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();   // tile j has landed; every warp is done with tile j - 1's slot
    if (j + 1 < ntiles) {
      const int slot = (j + 1) % kStages;
      load_tile<BN, KD>(sK + slot * BN * LD, Kb, (j + 1) * BN, skv, d, vec);
      load_tile<BN, KD>(sV + slot * BN * LD, Vb, (j + 1) * BN, skv, d, vec);
    }
    cp_async_commit();
    if constexpr (C::QREG) {
      if (j == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) ldsm_x4(qf[ks], q_lane + ks * 16);
      }
    }
    const int k0 = j * BN;
    if (causal && k0 > wrow + 16 * MT - 1) continue;   // the tile is above all our rows
    const u16* Kt = sK + (j % kStages) * BN * LD;
    const u16* Vt = sV + (j % kStages) * BN * LD;

    // S = Q K^T
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NS; ++i) s[mt][i][0] = s[mt][i][1] = s[mt][i][2] = s[mt][i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (C::QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[mt][e] = qf[ks][e];
        } else {
          ldsm_x4(a[mt], q_lane + mt * 16 * LD + ks * 16);
        }
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        unsigned b[4];
        ldsm_x4(b, Kt + np * 16 * LD + k_lane + ks * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }

    // scale in fp32, mask where the tile needs it, online softmax; then P
    // packed from S's accumulators into A fragments
    const bool mask = (causal && k0 + BN - 1 > wrow) || k0 + BN > skv_pad;
    unsigned p[MT][NS / 2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][i][e] * scale_log2;
          if (mask) {
            const int col = k0 + i * 8 + 2 * t + (e & 1);
            const int row = wrow + mt * 16 + g + e / 2 * 8;
            if (col >= skv_pad || (causal && col > row)) x = kNegInf;
          }
          s[mt][i][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[mt][h], quad_max(mx[h]));
        alpha[h] = ex2(m[mt][h] - m_new);
        m[mt][h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][i][e] = ex2(s[mt][i][e] - m[mt][e / 2]);
          rs[e / 2] += s[mt][i][e];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[mt][h] = l[mt][h] * alpha[h] + rs[h];   // lane partials
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[mt][n][0] *= alpha[0];
        o[mt][n][1] *= alpha[0];
        o[mt][n][2] *= alpha[1];
        o[mt][n][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        p[mt][kk][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        p[mt][kk][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        p[mt][kk][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        p[mt][kk][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        unsigned b[4];
        ldsm_x4_trans(b, Vt + kk * 16 * LD + v_lane + np * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * np], p[mt][kk], b[0], b[1]);
          mma_bf16(o[mt][2 * np + 1], p[mt][kk], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool pair = d % 2 == 0 && (reinterpret_cast<unsigned long long>(O) & 3) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wrow + mt * 16 + g + h * 8;
      const float li = fmaxf(quad_sum(l[mt][h]), 1e-30f);
      if (row >= sq) continue;
      u16* orow = O + ((long long)bh * sq + row) * d;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        store_pair(orow, n * 8 + 2 * t, d, pair, o[mt][n][2 * h] / li,
                   o[mt][n][2 * h + 1] / li);
    }
  }
}

__host__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

template <int KD, int MT>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int group, int sq,
           int skv, int skv_pad, int d, float scale, int causal, cudaStream_t stream) {
  using C = Cfg<KD, MT>;
  auto kernel = flash_fwd_tc<KD, MT>;
  // the shared memory above 48 KB, and the carveout that lets two CTAs
  // share an SM, set once per device
  static int set_device = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device != set_device) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess) set_device = device;
  }
  if (err != cudaSuccess) return (int)err;
  const int tiles = (sq + C::ROWS - 1) / C::ROWS;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  kernel<<<dim3(bh, tiles), kThreads, C::SMEM, stream>>>(
      static_cast<const u16*>(q), static_cast<const u16*>(k), static_cast<const u16*>(v),
      static_cast<u16*>(o), group, sq, skv, skv_pad, d, scale * kLog2e, causal, vec);
  return (int)cudaGetLastError();
}

// The current device's SM count, read once per device.
cudaError_t sm_count(int* sms) {
  static int read_device = -1, read_sms = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device != read_device) {
    err = cudaDeviceGetAttribute(&read_sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) read_device = device;
  }
  *sms = read_sms;
  return err;
}

// 128-row CTAs (two m16 tiles a warp: each K and V fragment feeds both,
// and each K/V tile is read from L2 once per 128 rows) where the
// accumulators fit and the grid fills the card's two CTAs an SM at least
// twice over; 64-row CTAs otherwise.  The tile changes no row's sums.
template <int KD>
int launch_rows(const void* q, const void* k, const void* v, void* o, int bh, int group,
                int sq, int skv, int skv_pad, int d, float scale, int causal, cudaStream_t s) {
  if constexpr (KD <= 128) {
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return (int)err;
    if ((long long)bh * ((sq + 127) / 128) >= 4LL * sms)
      return launch<KD, 2>(q, k, v, o, bh, group, sq, skv, skv_pad, d, scale, causal, s);
  }
  return launch<KD, 1>(q, k, v, o, bh, group, sq, skv, skv_pad, d, scale, causal, s);
}

// The smallest instantiated head dim that holds d; the columns past d are
// zero in shared memory.
int dispatch(const void* q, const void* k, const void* v, void* o, int bh, int group, int sq,
             int skv, int skv_pad, int d, float scale, int causal, cudaStream_t s) {
#define FLASH_TC(KD)                                                                       \
  if (d <= KD) return launch_rows<KD>(q, k, v, o, bh, group, sq, skv, skv_pad, d, scale, \
                                      causal, s);
  FLASH_TC(32) FLASH_TC(64) FLASH_TC(80) FLASH_TC(128) FLASH_TC(256)
#undef FLASH_TC
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// ---------------------------------------------------- f32: the SIMT fp32 pipes

namespace simt {

// The CTA tile per padded head dim KD (a multiple of 4, >= d), in lanes.
// LC lanes share each row: a thread's keys in S = Q K^T and its columns of
// O.  A warp is LR = 32 / LC rows of lanes, and owns WR = LR * RM query rows
// (RM a thread); NW warps make the CTA's BQ rows.  Thread (rl, cl) of warp
// w owns rows w WR + rl + LR i (i < RM) in both products, so a row's max,
// sum and rescale stay in its LC lanes; keys 4 cl + 4 LC h + e (h < RN / 4,
// e < 4) of each BKV-key tile, and output columns 4 (cl + LC n) + e
// (n < NC).  Every shared-memory read is a float4: Q's rows and P's rows as
// four of their columns (one address a quarter-warp when LC >= 8), K's
// rows as four of theirs, V's rows as four output columns.
template <int KD_, int LC_, int RM_, int BKV_, int NW_>
struct Cfg {
  static constexpr int KD = KD_, LC = LC_, RM = RM_, BKV = BKV_, NW = NW_;
  static constexpr int LR = 32 / LC, WR = LR * RM, BQ = NW * WR, T = 32 * NW;
  static constexpr int RN = BKV / LC, NC = KD / (4 * LC), CPR = KD / 4;
  // K's 16-byte units are stored permuted by (row / 4) % SWZ, so the keys a
  // quarter-warp reads at one column fall on distinct banks.  With LC < 8 a
  // quarter-warp reads two rows of Q and of P: pitches of 4 units mod 8
  // keep them apart.
  static constexpr int SWZ = LC < 8 ? LC : 8;
  static constexpr int PP = LC < 8 ? BKV + 16 : BKV;   // P's row pitch, floats
  static constexpr int SMEM = (BQ * KD + 2 * BKV * KD + BQ * PP) * (int)sizeof(float);
  static constexpr int MIN_CTAS = T == 128 ? 2 : 1;
  static_assert(LC >= 4 && 32 % LC == 0 && RN % 4 == 0 && KD % (4 * LC) == 0 &&
                    CPR % SWZ == 0, "tile");
  static_assert(LC >= 8 || (CPR % 8 == 4 && PP / 4 % 8 == 4), "two rows a quarter-warp");
};

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ const float4& f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [row0, row0 + R) of a [rows][d] matrix -> dst [R][KD], zero past row
// `rows` and column d; K's units swizzled.  Unit u of the tile (row u / CPR,
// columns 4 (u % CPR) + 0-3) is thread u % T's.  vec: d % 4 == 0 and every
// pointer 16-byte aligned, so each unit is one cp.async, and a tile of real
// rows at d == KD takes no mask; otherwise element loads (any d).
template <class C, int R, bool SWIZZLE>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int rows, int d,
                                          bool vec) {
  constexpr int N = R * C::CPR;
  const bool whole = vec && d == C::KD && row0 + R <= rows;
#pragma unroll
  for (int it = 0; it < (N + C::T - 1) / C::T; ++it) {
    const int u = threadIdx.x + it * C::T;
    if (N % C::T != 0 && u >= N) break;
    const int r = u / C::CPR, q = u % C::CPR, c = 4 * q, row = row0 + r;
    float* s = dst + r * C::KD + 4 * (SWIZZLE ? q ^ (r >> 2 & (C::SWZ - 1)) : q);
    const float* g = src + (long long)row * d + c;
    if (whole) {
      tc::cp_async16(s, g, 16);
    } else if (vec) {
      const bool in = row < rows && c < d;
      tc::cp_async16(s, in ? g : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = row < rows && c + e < d ? g[e] : 0.f;
    }
  }
}

// Qs *= scale over the units this thread loaded: its own copies are
// complete, and visible to it, once its copy groups have landed.
template <class C>
__device__ __forceinline__ void scale_rows(float* Qs, float scale) {
  constexpr int N = C::BQ * C::CPR;
#pragma unroll
  for (int it = 0; it < (N + C::T - 1) / C::T; ++it) {
    const int u = threadIdx.x + it * C::T;
    if (N % C::T != 0 && u >= N) break;
    float4& x = reinterpret_cast<float4*>(Qs)[u];
    x.x = __fmul_rn(x.x, scale);
    x.y = __fmul_rn(x.y, scale);
    x.z = __fmul_rn(x.z, scale);
    x.w = __fmul_rn(x.w, scale);
  }
}

// grid (bh, query tiles), heaviest tiles first; block T.  K and V tiles
// alternate through one buffer each: K_{j+1} is copied during tile j's
// softmax and P V, V_{j+1} during tile j + 1's Q K^T, so two barriers a
// tile serve the ring.  P goes through this warp's own rows of shared
// memory (a __syncwarp, no CTA barrier).  Each score is one fmaf chain
// over the columns in order, of q * scale (rounded as the plain version
// rounds it) and k, so the logits match it where they are large.
template <class C>
__global__ void __launch_bounds__(C::T, C::MIN_CTAS)
flash_fwd_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                 const float* __restrict__ V, float* __restrict__ O, int group, int sq, int skv,
                 int skv_pad, int d, float scale, int causal, int vec) {
  constexpr int KD = C::KD, LC = C::LC, LR = C::LR, RM = C::RM, RN = C::RN, NC = C::NC;
  constexpr int BKV = C::BKV, PP = C::PP, H = RN / 4;
  extern __shared__ __align__(16) float simt_smem[];
  float* Qs = simt_smem;                // [BQ][KD], q * scale
  float* Ks = Qs + C::BQ * KD;          // [BKV][KD], units swizzled
  float* Vs = Ks + BKV * KD;            // [BKV][KD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rl = lane / LC, cl = lane % LC;
  float* Ps = Vs + BKV * KD + warp * C::WR * PP;   // this warp's [WR][PP]
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;
  const int wrow = q0 + warp * C::WR;             // this warp's first row
  const float* Qb = Q + (long long)bh * sq * d;
  const float* Kb = K + (long long)(bh / group) * skv * d;
  const float* Vb = V + (long long)(bh / group) * skv * d;

  // columns at or beyond skv_pad do not exist; causal rows stop at the diagonal
  const int kv_end = causal ? min(skv_pad, min(q0 + C::BQ, sq)) : skv_pad;
  const int ntiles = (kv_end + BKV - 1) / BKV;

  load_rows<C, C::BQ, false>(Qs, Qb, q0, sq, d, vec);
  load_rows<C, BKV, true>(Ks, Kb, 0, skv, d, vec);
  tc::cp_async_commit();
  load_rows<C, BKV, false>(Vs, Vb, 0, skv, d, vec);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();   // Q and K_0 (this thread's units)
  scale_rows<C>(Qs, scale);
  __syncthreads();

  const float* q_at = Qs + (warp * C::WR + rl) * KD;   // row i: + LR i KD
  const float* k_at = Ks + 4 * cl * KD;                // key (h, e): + (4 LC h + e) KD
  const int sw = cl & (C::SWZ - 1);                    // the swizzle of all our keys
  float* p_at = Ps + rl * PP;                          // row i: + LR i PP
  const float* v_at = Vs + 4 * cl;                     // unit n: + 4 LC n; key j: + j KD

  float m[RM], l[RM], acc[RM][NC][4];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
  }

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BKV;
    // some row of this warp sees the tile (warp-uniform)
    const bool live = !causal || k0 <= wrow + C::WR - 1;
    float s[RM][RN];
    if (live) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int t = 0; t < RN; ++t) s[i][t] = 0.f;
      // S = (q * scale) K^T
#pragma unroll 4
      for (int u = 0; u < C::CPR; ++u) {
        float4 qv[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) qv[i] = f4(q_at + i * LR * KD + 4 * u);
        const float* kp = k_at + 4 * (u ^ sw);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          float4 kv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) kv[e] = f4(kp + (4 * LC * h + e) * KD);
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                s[i][4 * h + e] = fmaf(lane_of(qv[i], c), lane_of(kv[e], c), s[i][4 * h + e]);
        }
      }
    }
    tc::cp_async_wait<0>();   // V_j (this thread's units)
    __syncthreads();          // every warp is done with K_j; V_j has landed
    if (j + 1 < ntiles) load_rows<C, BKV, true>(Ks, Kb, k0 + BKV, skv, d, vec);
    tc::cp_async_commit();

    if (live) {
      // mask where the tile needs it, online softmax, P to this warp's rows
      const bool mask = (causal && k0 + BKV - 1 > wrow) || k0 + BKV > skv_pad;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int row = wrow + rl + LR * i;
        float mx = kNegInf;
#pragma unroll
        for (int t = 0; t < RN; ++t) {
          if (mask) {
            const int col = k0 + 4 * cl + 4 * LC * (t / 4) + t % 4;
            if (col >= skv_pad || (causal && col > row)) s[i][t] = kNegInf;
          }
          mx = fmaxf(mx, s[i][t]);
        }
#pragma unroll
        for (int o = 1; o < LC; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = tc::ex2((m[i] - m_new) * kLog2e);
        m[i] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int t = 0; t < RN; ++t) {
          s[i][t] = tc::ex2((s[i][t] - m_new) * kLog2e);
          rs += s[i][t];
        }
        l[i] = l[i] * alpha + rs;   // this lane's part of the row sum
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] *= alpha;
#pragma unroll
        for (int h = 0; h < H; ++h)
          *reinterpret_cast<float4*>(p_at + LR * i * PP + 4 * cl + 4 * LC * h) =
              make_float4(s[i][4 * h], s[i][4 * h + 1], s[i][4 * h + 2], s[i][4 * h + 3]);
      }
      __syncwarp();

      // O += P V
#pragma unroll 2
      for (int kb = 0; kb < BKV / 4; ++kb) {
        float4 pv[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) pv[i] = f4(p_at + LR * i * PP + 4 * kb);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float4 vv[NC];
#pragma unroll
          for (int n = 0; n < NC; ++n) vv[n] = f4(v_at + (4 * kb + e) * KD + 4 * LC * n);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float p = lane_of(pv[i], e);
#pragma unroll
            for (int n = 0; n < NC; ++n) {
              acc[i][n][0] = fmaf(p, vv[n].x, acc[i][n][0]);
              acc[i][n][1] = fmaf(p, vv[n].y, acc[i][n][1]);
              acc[i][n][2] = fmaf(p, vv[n].z, acc[i][n][2]);
              acc[i][n][3] = fmaf(p, vv[n].w, acc[i][n][3]);
            }
          }
        }
      }
    }
    tc::cp_async_wait<0>();   // K_{j+1}
    __syncthreads();          // every warp is done with V_j; K_{j+1} has landed
    if (j + 1 < ntiles) load_rows<C, BKV, false>(Vs, Vb, k0 + BKV, skv, d, vec);
    tc::cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = wrow + rl + LR * i;
    float li = l[i];
#pragma unroll
    for (int o = 1; o < LC; o <<= 1) li += __shfl_xor_sync(0xffffffffu, li, o);
    li = fmaxf(li, 1e-30f);
    if (row >= sq) continue;
    float* orow = O + ((long long)bh * sq + row) * d;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = 4 * (cl + LC * n);
      if (c >= d) continue;
      if (vec) {
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(acc[i][n][0] / li, acc[i][n][1] / li, acc[i][n][2] / li,
                        acc[i][n][3] / li);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < d) orow[c + e] = acc[i][n][e] / li;
      }
    }
  }
}

template <class C>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int group, int sq,
           int skv, int skv_pad, int d, float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<C>;
  // the shared memory above 48 KB, and the carveout that lets two CTAs
  // share an SM, set once per device
  static int set_device = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device != set_device) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess) set_device = device;
  }
  if (err != cudaSuccess) return (int)err;
  const int tiles = (sq + C::BQ - 1) / C::BQ;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const int vec = d % 4 == 0 && tc::aligned16(q) && tc::aligned16(k) && tc::aligned16(v) &&
                  tc::aligned16(o);
  kernel<<<dim3(bh, tiles), C::T, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), group, sq, skv, skv_pad, d, scale, causal, vec);
  return (int)cudaGetLastError();
}

// fn(C{}) for the tile C that bh rows of sq queries at head dim d take:
// the smallest instantiated head dim that holds d (the columns past it are
// zero in shared memory), and at d <= 128 the 128-row tile of 8 warps, one
// CTA an SM, where its grid fills the card one and a half times over
// (2 bh tiles >= 3 SMs), else the 64-row tile of 4 warps, two an SM.
template <class F>
int with_tile(int bh, int sq, int d, F fn) {
  if (d <= 32) return fn(Cfg<32, 8, 8, 64, 4>{});
  if (d <= 64) return fn(Cfg<64, 8, 8, 64, 4>{});
  if (d <= 80) return fn(Cfg<80, 4, 4, 32, 4>{});
  if (d <= 128) {
    using Large = Cfg<128, 16, 8, 64, 8>;
    int sms = 0;
    const cudaError_t err = tc::sm_count(&sms);
    if (err != cudaSuccess) return (int)err;
    if (2LL * bh * ((sq + Large::BQ - 1) / Large::BQ) >= 3LL * sms) return fn(Large{});
    return fn(Cfg<128, 16, 8, 64, 4>{});
  }
  return fn(Cfg<256, 16, 4, 64, 8>{});
}

int dispatch(const void* q, const void* k, const void* v, void* o, int bh, int group, int sq,
             int skv, int skv_pad, int d, float scale, int causal, cudaStream_t s) {
  return with_tile(bh, sq, d, [&](auto c) {
    return launch<decltype(c)>(q, k, v, o, bh, group, sq, skv, skv_pad, d, scale, causal, s);
  });
}

}  // namespace simt

}  // namespace

extern "C" {

// O = attention(Q, K, V).  Q, O: [bh, sq, d]; K, V: [bh / group, skv, d];
// all contiguous.  skv_pad >= skv is the padded kv extent.  use_tc = 1
// runs flash_fwd_tc on bf16 tensors, 0 flash_fwd_kernel on f32 ones.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take.
int flash_attention_fwd(int use_tc, const void* q, const void* k, const void* v, void* o,
                        int bh, int group, int sq, int skv, int skv_pad, int d, float scale,
                        int causal, void* stream) {
  if (d < 1 || d > kMaxD || bh < 1 || bh > 65535 || group < 1 || sq < 1 || skv < 1 ||
      skv_pad < skv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_tc) return tc::dispatch(q, k, v, o, bh, group, sq, skv, skv_pad, d, scale, causal, s);
  return simt::dispatch(q, k, v, o, bh, group, sq, skv, skv_pad, d, scale, causal, s);
}

// The f32 kernel's CTA tile for bh rows of sq queries at head dim d on the
// current device: tile = {query rows, keys, warps}.  Returns a CUDA error,
// or cudaErrorInvalidValue for a d the kernel does not take.
int flash_simt_tile(int bh, int sq, int d, int* tile) {
  if (d < 1 || d > kMaxD || bh < 1 || sq < 1) return (int)cudaErrorInvalidValue;
  return simt::with_tile(bh, sq, d, [&](auto c) {
    using C = decltype(c);
    tile[0] = C::BQ;
    tile[1] = C::BKV;
    tile[2] = C::NW;
    return 0;
  });
}

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
