// RASA-scheduled GEMM for Hopper (sm_90a): C (+)= A @ B, fp32 accumulation.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/rasa_gemm.py:
//   rasa_ws_chunk<base>  <- _ws_call(schedule="base")  (body _accum_kernel)
//   rasa_ws_chunk<wlbp>  <- _ws_call(schedule="wlbp")  (body _accum_kernel)
//   rasa_wls             <- rasa_gemm(schedule="wls")  (body _scratch_kernel)
//
// What bounds it on this card.  At qwen3-1.7b decode (M = batch = 4) every
// step reads all ~3.44 GB of bf16 weights once, so the floor is the HBM
// rate: >= 1.03 ms per step at 3.35 TB/s.  At prefill (M = 512) the
// layers' GEMMs are 1.44 TFLOP, >= 1.46 ms at the 989 TFLOP/s bf16
// tensor-core peak, and their inputs and outputs, each moved once, take
// >= 1.54 ms at 3.35 TB/s: the two bounds are close, so prefill needs the
// tensor cores (fp32 FMA outside them peaks at 67 TFLOP/s, >= 21.5 ms)
// and operand reuse in shared memory.
//
// Three tile paths, chosen by M and the inputs' type:
//   M > 4, bf16 (prefill): the tensor cores (namespace tc below).  128 x 64
//         CTA tiles of 8 warps, each warp 32 x 32 outputs as 2 x 4
//         mma.sync.m16n8k16 (bf16 in, fp32 accumulate) fed by ldmatrix;
//         operands arrive by 16-byte cp.async copies through a 3-deep
//         ring of 64-deep k slabs, so two slabs are in flight while one
//         is multiplied.
//   M > 4, f32 (namespace simt below): SIMT fp32 FMA (TF32 would break the
//         reference's rel_err < 1e-5 for f32 inputs), so the bound is the
//         67 TFLOP/s fp32 rate.  On this card a 16-byte shared load costs
//         a quarter-warp a cycle however many lanes share its address, so
//         shared-memory bandwidth caps a thread tile of RM x 8 outputs at
//         RM / (RM + 8) * 2 of the FMA rate: 67% at 4 x 8, 100% at 8 x 8.
//         base and wls: 128 x 64 (or 64 x 64) CTA tiles of 4 x 8 outputs a
//         thread, which fill the SMs at M = 512; wlbp: 256 x 64 tiles of
//         8 x 8.  Operands arrive by 16-byte cp.async copies, A unchanged
//         as [m][k], through a 3-deep ring of 32-deep k slabs.
//   M <= 4 (decode, namespace dec below), bound by the bytes of B, in both
//         dtypes and all three schedules.  What it does about each limit
//         of the design it replaced (one CTA of 16 columns per SM, a whole
//         chunk staged in registers and then in shared memory):
//         - occupancy: nothing is staged; 256 threads of <= 128 registers
//           and 16 KB of shared memory, so two CTAs an SM;
//         - bytes in flight: each thread keeps its next batch of four
//           16-byte read-only loads of B (and the A values they meet) in
//           flight while it sums the current one, across chunk ends;
//         - small grids: the row-major tile narrows (64, 32, 16 or 8
//           columns in bf16) until the grid gives about one CTA an SM, so
//           the N = 1024 and 2048 GEMMs fill the card without splitting a
//           chunk across CTAs;
//         - serial chunk launches: base and wlbp launch through launch_ex,
//           each chunk after the first with programmatic dependent launch;
//         - per-call overheads: embedding.T is read along k in place (no
//           transposed 2-byte commit), and the wrapper no longer zero-fills
//           C (c_init = 0: the first sum is added to zero).
//         Nothing scales with bk: no shared memory holds a chunk, and the
//         work follows the chunk's real depth, min(bk, K - k0).
//         With one M tile, base and wlbp make the same traversal here.
// The schedules keep their meaning on every path:
//   base  one launch per k-chunk, one CTA per (M tile, N tile); each CTA
//         loads its own B slab, so B is re-read from HBM once per M tile.
//   wlbp  one launch per k-chunk; the chunk's bk x TN block of B is read
//         from HBM once per N slab, stays in shared memory, and the M
//         tiles are walked over it (the WLBP weight-load skip).  A cluster
//         of G <= 8 CTAs along M shares the block: each loads 1/G of it
//         from HBM and walks its own M tiles.  bf16: each gathers the rest
//         into a copy of the whole block on its first tile.  f32 (twice
//         the bytes): each keeps only its share, and reads the others'
//         slabs from their shared memory into a two-slot ring one slab
//         ahead of use; so G also grows with the chunk's depth, and a
//         chunk up to 3072 deep fits a cluster of 8.
//   wls   output-stationary: one CTA per output tile keeps an fp32
//         accumulator seeded from C (in registers; f32 M > 4: in shared
//         memory), walks all k-chunks, writes C once.
//
// Numerics.  The three schedules are bit-identical.  On each path every
// output's partial sum over one k-chunk is formed in one fixed order by one
// shared routine (tc::mma_slab: mma k16 steps ascending from a zero
// accumulator; fma_slab: a k-ascending fp32 FMA chain from 0; the decode
// path's decode_kernel: FMA chains over each thread's k, then fixed trees
// over the threads that share a column),
// and is then added to C with one rounded add, exactly as the reference's
// `c_in + dot` and `acc += dot`.
//
// No padding: the kernels mask the ragged edge (zero padding is exact), and
// take B's strides, so the tied LM head reads embedding.T without a copy.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ------------------------------------------------------- bf16 prefill path
// M > 4 with bf16 inputs, on the tensor cores.  A CTA owns a TM x TN tile
// of outputs; warp (wm, wn) of its TM / 32 x 2 warps owns 32 x 32 of them as
// 2 x 4 fragments of mma.sync.m16n8k16.  Shared memory holds A as [m][k]
// and B as [k][n], each row padded by 16 bytes, so that the 8 rows one
// ldmatrix reads fall on distinct banks; ldmatrix.trans turns B's [k][n]
// rows into the mma's column operand.  Operands arrive in KT-deep slabs
// by 16-byte cp.async copies.  A 16-byte unit that crosses the matrix's or
// the chunk's edge, or whose source is not 16-byte aligned (a column
// slice of A, an odd K), is copied element by element with the same
// masking; a B that is not n-fast (embedding.T) is transposed on the way
// in.  So every B lands in one layout, and one ldmatrix path serves all.
//
// The shared routine is mma_slab: part += one slab's product, in k16 steps
// ascending.  A chunk's partial is mma_slab over its slabs from a zeroed
// part, with zeros beyond the chunk's end, and is added to C (or to wls's
// accumulator) with one __fadd_rn per output; the mma accumulator is never
// seeded with C.  Every schedule forms every output's partial by the same
// mma sequence at the same tile position, so the three are bit-identical.
//
// Tile choice: 128 x 64 with 8 warps (32 x 32 each: 4 ldmatrix per 8
// mma), 64-deep slabs, 3 in the ring (81 KB, so two CTAs fit on an SM);
// 64 x 64 with 4 warps where 128-row tiles would give fewer CTAs than
// three quarters of the SMs (tall_tiles).  At qwen3-1.7b's prefill
// (M = 512) that is 128 CTAs for N = 2048 and 384 for N = 6144 on 132 SMs,
// and 128 of 64 rows for N = 1024.  On an H100 it was as fast as or faster
// than 64 x 64 tiles throughout, 4-5 stages, and 32- or 128-deep slabs.
// Its copies set its pace more than its mma: a 512 x 2048 x 2048 GEMM
// moves 96 MB from L2 into shared memory.

namespace tc {

namespace cg = cooperative_groups;

using u16 = unsigned short;  // bf16 bits: this path only copies them
constexpr int TN = 64, KT = 64, kStages = 3;
constexpr int LDA = KT + 8, LDB = TN + 8;    // padded pitches, in elements
constexpr int B_SLAB = KT * LDB;             // elements per B slab
constexpr int kMaxCluster = 8;               // the portable cluster size
static_assert(LDA * 2 % 16 == 0 && LDB * 2 % 16 == 0, "16-byte rows for cp.async, ldmatrix");

// A CTA tile of TM rows (128, or 64 where 128-row tiles would leave SMs
// idle): TM / 32 x 2 warps of 32 x 32 outputs.
template <int TM>
struct Shape {
  static constexpr int NT = TM * 2;                             // threads
  static constexpr int A_SLAB = TM * LDA;                       // elements
  static constexpr int RA = NT / (KT / 8), RB = NT / (TN / 8);  // rows per pass
  static constexpr int kGather = KT * TN / 8 / NT;              // see gather_load
  static_assert(TM * KT / 8 % NT == 0 && KT * TN / 8 % NT == 0, "whole units per thread");
};

// [m16 tile][n8 tile][mma register] of a warp's 32 x 32 outputs.  Register
// e of tile (i, j) is output (i * 16 + lane / 4 + e / 2 * 8,
// j * 8 + lane % 4 * 2 + e % 2) of the warp's tile.
struct Frag {
  float v[2][4][4];
};

__device__ __forceinline__ void zero(Frag& f) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) f.v[i][j][e] = 0.f;
}

// acc += part, one rounded add per output (the reference's `c_in + dot`
// and `acc += dot`); part restarts from zero for the next chunk.
__device__ __forceinline__ void fold(Frag& acc, Frag& part) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc.v[i][j][e] = __fadd_rn(acc.v[i][j][e], part.v[i][j][e]);
        part.v[i][j][e] = 0.f;
      }
}

// fn(v0, v1, c, row, n, vec) for each pair of neighbouring registers of f
// (e = 2h and 2h + 1 of a tile: outputs (m, n) and (m, n + 1)): c is the
// pair's address in C, row whether m < M, vec whether the pair can move as
// one aligned float2 (whole 32-byte sectors for a warp's four lanes).
template <class F>
__device__ __forceinline__ void each_pair(Frag& f, float* Cm, int M, int N, int m0, int n0,
                                          F fn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = m0 + warp / 2 * 32 + lane / 4, c0 = n0 + warp % 2 * 32 + lane % 4 * 2;
  const bool even = N % 2 == 0 && (reinterpret_cast<unsigned long long>(Cm) & 7) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + i * 16 + h * 8, n = c0 + j * 8;
        fn(f.v[i][j][2 * h], f.v[i][j][2 * h + 1], Cm + (long long)m * N + n, m < M,
           n, even && n + 1 < N);
      }
}

// acc = C over the tile (0 outside M x N).
__device__ __forceinline__ void seed(Frag& acc, float* Cm, int M, int N, int m0, int n0) {
  each_pair(acc, Cm, M, N, m0, n0, [&](float& v0, float& v1, const float* c, bool row, int n,
                                       bool vec) {
    if (row && vec) {
      const float2 x = *reinterpret_cast<const float2*>(c);
      v0 = x.x;
      v1 = x.y;
    } else {
      v0 = row && n < N ? c[0] : 0.f;
      v1 = row && n + 1 < N ? c[1] : 0.f;
    }
  });
}

// C = acc over the tile.  C is updated in place: the wrapper owns it.
__device__ __forceinline__ void store(Frag& acc, float* Cm, int M, int N, int m0, int n0) {
  each_pair(acc, Cm, M, N, m0, n0, [&](float& v0, float& v1, float* c, bool row, int n,
                                       bool vec) {
    if (row && vec) {
      *reinterpret_cast<float2*>(c) = make_float2(v0, v1);
    } else {
      if (row && n < N) c[0] = v0;
      if (row && n + 1 < N) c[1] = v1;
    }
  });
}

// Programmatic dependent launch.  A chunk's partial product does not read
// C, so base and wlbp launch each chunk's kernel with the attribute that
// lets it start while the previous chunk's kernel drains: let_next_start
// allows the next kernel on the stream to begin once every CTA of this one
// has called it, and wait_for_previous returns once every earlier kernel on
// the stream has finished and its writes to C are visible.  The fold into
// C stays in chunk order.  Without the attribute (wls) there is nothing to
// wait for.
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
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

// The one order every schedule shares: part += the product of one slab,
// As [TM][LDA] and Bs [KT][LDB] at the slab's first k, for this warp's
// 32 x 32 outputs, in k16 steps ascending.
__device__ __forceinline__ void mma_slab(Frag& part, const u16* As, const u16* Bs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const u16* a_row = As + (warp / 2 * 32 + lane % 16) * LDA + lane / 16 * 8;
  const u16* b_row = Bs + (lane % 16) * LDB + warp % 2 * 32 + lane / 16 * 8;
#pragma unroll
  for (int kk = 0; kk < KT; kk += 16) {
    unsigned a[2][4], b[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) ldsm_x4(a[i], a_row + i * 16 * LDA + kk);
    // b[h]: k 0-7 and 8-15 of columns h * 16 + 0-7, then of h * 16 + 8-15
#pragma unroll
    for (int h = 0; h < 2; ++h) ldsm_x4_trans(b[h], b_row + kk * LDB + h * 16);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_bf16(part.v[i][j], a[i], b[j / 2][j % 2 * 2], b[j / 2][j % 2 * 2 + 1]);
  }
}

// A[m0 : m0 + TM, ks : ks + KT] -> As[r * LDA + kk], zero outside m < M and
// k < kend.  Eight threads cover one row's 128 bytes.
template <int TM>
__device__ __forceinline__ void load_a_slab(u16* As, const u16* A, long long lda, int M,
                                            int m0, int ks, int kend) {
  constexpr int U = KT / 8, NT = Shape<TM>::NT;  // 16-byte units per row, threads
#pragma unroll
  for (int i = 0; i < TM * U / NT; ++i) {
    const int u = threadIdx.x + i * NT;
    const int r = u / U, kk = u % U * 8, m = m0 + r, k = ks + kk;
    u16* dst = As + r * LDA + kk;
    const u16* src = A + (long long)m * lda + k;
    if (m < M && k + 8 <= kend && aligned16(src)) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = (m < M && k + j < kend) ? src[j] : u16(0);
    }
  }
}

// B[ks : ks + KT, n0 : n0 + TN] -> Bs[kk * LDB + c], zero outside k < kend
// and n < N.  An n-fast B (a row-major weight) goes in 16-byte units along
// n; any other (embedding.T is k-fast) in units of 8 k along a column,
// read with one 16-byte load where its k stride is 1, and transposed into
// the same [k][n] layout.
template <int TM>
__device__ __forceinline__ void load_b_slab(u16* Bs, const u16* B, long long sbk,
                                            long long sbn, int N, int n0, int ks, int kend) {
  constexpr int NT = Shape<TM>::NT;
  if (sbn == 1) {
    constexpr int U = TN / 8;  // units per row
#pragma unroll
    for (int i = 0; i < KT * U / NT; ++i) {
      const int u = threadIdx.x + i * NT;
      const int kk = u / U, c = u % U * 8, k = ks + kk, n = n0 + c;
      u16* dst = Bs + kk * LDB + c;
      const u16* src = B + k * sbk + n;
      if (k < kend && n + 8 <= N && aligned16(src)) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[j] = (k < kend && n + j < N) ? src[j] : u16(0);
      }
    }
  } else {
    constexpr int U = KT / 8;  // units per column
#pragma unroll
    for (int i = 0; i < KT * TN / 8 / NT; ++i) {
      const int u = threadIdx.x + i * NT;
      const int c = u / U, kk = u % U * 8, k = ks + kk, n = n0 + c;
      const u16* src = B + k * sbk + n * sbn;
      alignas(16) u16 v[8];
      if (sbk == 1 && k + 8 <= kend && n < N && aligned16(src)) {
        *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = (k + j < kend && n < N) ? src[j * sbk] : u16(0);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) Bs[(kk + j) * LDB + c] = v[j];
    }
  }
}

// Where this thread's 16-byte units of an A and a B slab come from (at
// k = 0) and go to, set up once per CTA tile.  Unit i of A is row
// a_row + i * RA of the tile, columns a_col + 0-7 of the slab; unit i of B
// is slab row b_row + i * RB, columns b_col + 0-7 (RA, RB: Shape).
// a_fast (b_fast) holds when every such unit of a whole slab is one
// aligned cp.async: the tile
// lies inside M (N), the pointer and the row stride keep 16-byte alignment
// (and B is n-fast).  A whole slab lies inside the chunk and starts on a
// multiple of 8; every other slab goes through the masked loaders.
struct CopyPlan {
  const u16* a;  // A + (m0 + a_row) * lda + a_col
  const u16* b;  // B + b_row * sbk + n0 + b_col
  long long a_step, b_step;  // RA rows of A, RB rows of B
  int a_dst, b_dst;          // shared-memory offsets of unit 0
  bool a_fast, b_fast;
};

template <int TM>
__device__ __forceinline__ CopyPlan make_plan(const u16* A, long long lda, const u16* B,
                                              long long sbk, long long sbn, int M, int N,
                                              int m0, int n0) {
  const int a_row = threadIdx.x / (KT / 8), a_col = threadIdx.x % (KT / 8) * 8;
  const int b_row = threadIdx.x / (TN / 8), b_col = threadIdx.x % (TN / 8) * 8;
  CopyPlan p;
  p.a = A + (long long)(m0 + a_row) * lda + a_col;
  p.b = B + b_row * sbk + n0 + b_col;
  p.a_step = Shape<TM>::RA * lda;
  p.b_step = Shape<TM>::RB * sbk;
  p.a_dst = a_row * LDA + a_col;
  p.b_dst = b_row * LDB + b_col;
  p.a_fast = m0 + TM <= M && aligned16(A) && lda % 8 == 0;
  p.b_fast = n0 + TN <= N && sbn == 1 && aligned16(B) && sbk % 8 == 0;
  return p;
}

__device__ __forceinline__ bool whole_slab(int ks, int kend) {
  return ks + KT <= kend && (ks & 7) == 0;
}

// The A slab at ks -> As, by the plan where it can, masked otherwise.
template <int TM>
__device__ __forceinline__ void copy_a(u16* As, const CopyPlan& p, const u16* A, long long lda,
                                       int M, int m0, int ks, int kend) {
  constexpr int RA = Shape<TM>::RA;
  if (p.a_fast && whole_slab(ks, kend)) {
#pragma unroll
    for (int i = 0; i < TM / RA; ++i)
      cp_async16(As + p.a_dst + i * RA * LDA, p.a + i * p.a_step + ks);
  } else {
    load_a_slab<TM>(As, A, lda, M, m0, ks, kend);
  }
}

// The B slab at ks -> Bs, by the plan where it can, masked otherwise.
template <int TM>
__device__ __forceinline__ void copy_b(u16* Bs, const CopyPlan& p, const u16* B, long long sbk,
                                       long long sbn, int N, int n0, int ks, int kend) {
  constexpr int RB = Shape<TM>::RB;
  if (p.b_fast && whole_slab(ks, kend)) {
    const u16* src = p.b + ks * sbk;
#pragma unroll
    for (int i = 0; i < KT / RB; ++i)
      cp_async16(Bs + p.b_dst + i * RB * LDB, src + i * p.b_step);
  } else {
    load_b_slab<TM>(Bs, B, sbk, sbn, N, n0, ks, kend);
  }
}

// base (one chunk: kbeg = k0, kstop = min(k0 + bk, K), chained) and wls
// (kbeg = 0, kstop = K): the CTA of output tile (blockIdx.y, blockIdx.x)
// adds each chunk's partial to its accumulator, seeded from C, with one
// rounded add, and writes C once.  The ring runs across chunk boundaries:
// the next chunk's first slabs are in flight while this chunk's last ones
// are multiplied.  A chained launch reads C only once the previous kernel
// on the stream has finished, before its last slab's mma.
template <int TM>
__global__ void __launch_bounds__(Shape<TM>::NT, 2)
tile_kernel(const u16* A, long long lda, const u16* B, long long sbk, long long sbn,
            float* Cm, int M, int N, int kbeg, int kstop, int bk, int chained) {
  constexpr int A_SLAB = Shape<TM>::A_SLAB;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  u16* As = reinterpret_cast<u16*>(tc_smem);
  u16* Bs = As + kStages * A_SLAB;
  let_next_start();
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const CopyPlan plan = make_plan<TM>(A, lda, B, sbk, sbn, M, N, m0, n0);
  Frag acc, part;
  bool seeded = !chained;
  if (seeded) seed(acc, Cm, M, N, m0, n0);
  zero(part);
  int pk0 = kbeg, pks = kbeg;  // the next slab to copy: its chunk and k
  auto issue = [&](int stage) {
    if (pk0 < kstop) {
      const int pend = min(pk0 + bk, kstop);
      copy_a<TM>(As + stage * A_SLAB, plan, A, lda, M, m0, pks, pend);
      copy_b<TM>(Bs + stage * B_SLAB, plan, B, sbk, sbn, N, n0, pks, pend);
      pks += KT;
      if (pks >= pend) pk0 = pks = pend;
    }
    cp_async_commit();  // empty groups keep the count that wait relies on
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  int ck0 = kbeg, cks = kbeg;  // the slab to multiply: its chunk and k
  for (int i = 0; ck0 < kstop; ++i) {
    cp_async_wait<kStages - 2>();  // slab i has landed (this thread's part)
    __syncthreads();               // ... everyone's; slab i - 1 is read
    issue((i + kStages - 1) % kStages);
    const int cend = min(ck0 + bk, kstop);
    const bool last = cks + KT >= cend;  // the chunk's last slab
    if (last && !seeded) {
      wait_for_previous();
      seed(acc, Cm, M, N, m0, n0);  // in flight during the mma below
      seeded = true;
    }
    mma_slab(part, As + i % kStages * A_SLAB, Bs + i % kStages * B_SLAB);
    cks += KT;
    if (last) {  // the chunk's partial is whole
      fold(acc, part);
      ck0 = cks = cend;
    }
  }
  store(acc, Cm, M, N, m0, n0);
}

// A slab of the chunk's B block from the shared memory of cluster CTA
// `owner` into this CTA's (the TN data columns of its KT rows), through
// kGather 16-byte registers per thread: gather_load issues the reads,
// gather_store writes them once they are needed.
template <int TM>
__device__ __forceinline__ void gather_load(uint4 (&g)[Shape<TM>::kGather], u16* slab,
                                            int owner) {
  const u16* src = cg::this_cluster().map_shared_rank(slab, owner);
#pragma unroll
  for (int i = 0; i < Shape<TM>::kGather; ++i) {
    const int u = threadIdx.x + i * Shape<TM>::NT;
    g[i] = *reinterpret_cast<const uint4*>(src + u / (TN / 8) * LDB + u % (TN / 8) * 8);
  }
}

template <int TM>
__device__ __forceinline__ void gather_store(const uint4 (&g)[Shape<TM>::kGather], u16* slab) {
#pragma unroll
  for (int i = 0; i < Shape<TM>::kGather; ++i) {
    const int u = threadIdx.x + i * Shape<TM>::NT;
    *reinterpret_cast<uint4*>(slab + u / (TN / 8) * LDB + u % (TN / 8) * 8) = g[i];
  }
}

// wlbp, one k-chunk [k0, kend) of nslab slabs.  The cluster (blockIdx.x,
// its G CTAs along M) owns N slab blockIdx.y: CTA r copies slabs r, r + G,
// ... of the chunk's B block from HBM, and then walks M tiles r, r + G,
// ... over the resident block, A streaming through a ring of kWlbpStages
// slabs (two, so that two CTAs fit on an SM beside the block).  On its
// first tile it takes the other CTAs' slabs from their shared memory one
// slab ahead of their use, so the gather overlaps the mma.  Each tile's
// partial is added to C, which it reads once the previous kernel on the
// stream has finished, before its last slab's mma.
constexpr int kWlbpStages = 2;

template <int TM>
__global__ void __launch_bounds__(Shape<TM>::NT, 2)
wlbp_kernel(const u16* A, long long lda, const u16* B, long long sbk, long long sbn,
            float* Cm, int M, int N, int k0, int kend, int nslab) {
  constexpr int S = kWlbpStages, A_SLAB = Shape<TM>::A_SLAB;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  u16* Bblk = reinterpret_cast<u16*>(tc_smem);  // nslab x [KT][LDB]
  u16* As = Bblk + nslab * B_SLAB;              // the ring of A slabs
  let_next_start();
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int n0 = blockIdx.y * TN;
  const CopyPlan share = make_plan<TM>(A, lda, B, sbk, sbn, M, N, r * TM, n0);
  for (int s = r; s < nslab; s += G)
    copy_b<TM>(Bblk + s * B_SLAB, share, B, sbk, sbn, N, n0, k0 + s * KT, kend);
  cp_async_commit();
  cp_async_wait<0>();
  cluster.sync();  // every CTA's share of the block has landed
  bool first = true;
  for (int m0 = r * TM; m0 < M; m0 += G * TM) {
    const CopyPlan plan = make_plan<TM>(A, lda, B, sbk, sbn, M, N, m0, n0);
    Frag acc, part;
    zero(part);
    auto issue = [&](int s) {
      if (s < nslab) copy_a<TM>(As + s % S * A_SLAB, plan, A, lda, M, m0, k0 + s * KT, kend);
      cp_async_commit();
    };
    const auto remote = [&](int s) { return first && s < nslab && s % G != r; };
    uint4 g[Shape<TM>::kGather];
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      issue(s);
      if (remote(s)) {
        gather_load<TM>(g, Bblk + s * B_SLAB, s % G);
        gather_store<TM>(g, Bblk + s * B_SLAB);
      }
    }
    int pending = -1;  // the slab whose gathered units wait in g
    for (int s = 0; s < nslab; ++s) {
      if (pending >= 0) gather_store<TM>(g, Bblk + pending * B_SLAB);
      pending = -1;
      cp_async_wait<S - 2>();
      __syncthreads();
      issue(s + S - 1);
      if (remote(s + S - 1)) {
        pending = s + S - 1;
        gather_load<TM>(g, Bblk + pending * B_SLAB, pending % G);
      }
      if (s == nslab - 1) {
        if (first) wait_for_previous();
        seed(acc, Cm, M, N, m0, n0);  // in flight during the mma below
      }
      mma_slab(part, As + s % S * A_SLAB, Bblk + s * B_SLAB);
    }
    fold(acc, part);
    store(acc, Cm, M, N, m0, n0);
    first = false;
    __syncthreads();  // the next tile's first copies reuse the ring
  }
  cluster.sync();  // no CTA leaves while another may still read its block
}

template <int TM>
int smem_bytes(int a_stages, int b_slabs) {
  return (a_stages * Shape<TM>::A_SLAB + b_slabs * B_SLAB) * (int)sizeof(u16);
}


}  // namespace tc

// ---------------------------------------------------------- f32 M > 4 path
// M > 4 with f32 inputs, on the SIMT fp32 units.  A warp's lanes are 4 x 8
// (ty, tx); a thread owns RM x 8 outputs: rows ty + 4 i (i < RM) of its
// warp's 4 RM rows, columns tx * 4 + 0-3 and 32 + tx * 4 + 0-3 of the 64.
// Shared memory holds A as [m][k] and B as [k][n], each row padded by 16
// bytes: A arrives by cp.async along k unchanged (no transposing stores),
// and a thread reads its A as one float4 of four k per row, its B as two
// float4s per k.  The four rows of an A read and the 128 bytes of a B read
// fall on distinct banks.
//
// What bounds it: a warp's 16-byte shared load takes four cycles of the
// SM's shared memory whether or not its lanes share addresses (a variant
// whose B loads had 32 distinct addresses took the same time), so a
// thread that loads RM + 8 floats per k for RM x 8 FMAs keeps the SM's four
// FMA pipes at most RM / (RM + 8) * 2 busy: 67% at 4 x 8, 100% at 8 x 8.
// The tiles (host side below) trade that against filling 132 SMs at
// M = 512 and against registers: 4 x 8 for base and wls (128 registers;
// 128-row CTAs of 256 threads or 64-row CTAs of 128), 8 x 8 for wlbp
// (256-row CTAs of 256 threads).  32-deep slabs through a 3-deep ring keep
// the barriers to one per 32 k.  Every copy of a whole slab inside the
// tile is one precomputed cp.async per 16 bytes (CopyPlan); only edge
// slabs take the masked copies.  No accumulator beside the chunk's partial
// lives in registers: base and wlbp add the partial to C at the chunk's
// end, wls to its accumulator in shared memory.
//
// The shared routine is fma_slab: for each output, p = fma(a[k], b[k], p)
// for k ascending over one KT-deep slab.  A chunk's partial is fma_slab
// over its slabs from zero (zeros past the chunk's end add nothing), and
// is added to C, or to wls's accumulator seeded from C, with one
// __fadd_rn: the order of every output's sum is the same whatever the tile
// or the schedule, so the three are bit-identical, and equal to the SIMT
// kernels they replaced.
namespace simt {

namespace cg = cooperative_groups;

constexpr int TN = 64, KT = 32, kStages = 3;
constexpr int LDA = KT + 4, LDB = TN + 4;  // padded pitches, in floats
constexpr int B_SLAB = KT * LDB;           // floats per B slab
constexpr int kMaxCluster = 8;             // the portable cluster size
constexpr int kSmemMax = 232448;           // bytes a CTA may use

// A CTA tile of TM x TN outputs, RM x 8 of them a thread: NT threads, each
// warp 4 RM rows.
template <int TM_, int RM_>
struct Shape {
  static constexpr int TM = TM_, RM = RM_;
  static constexpr int NT = TM * TN / (RM * 8);          // threads
  static constexpr int A_SLAB = TM * LDA;                // floats per A slab
  static constexpr int AU = TM * KT / 4 / NT;            // 16-byte units of A a thread
  static constexpr int BU = KT * TN / 4 / NT;            // ... of B
  // CTAs an SM must hold: 8 x 8 may take 255 registers a thread, 4 x 8 128
  static constexpr int MIN_CTAS = RM == 8 ? 1 : 65536 / (NT * 128);
  static_assert(TM * KT / 4 % NT == 0 && KT * TN / 4 % NT == 0, "whole units per thread");
};

// This thread's first output row and column in the CTA tile.
template <int RM>
__device__ __forceinline__ int row0() {
  return threadIdx.x / 32 * 4 * RM + threadIdx.x % 32 / 8;
}

__device__ __forceinline__ int col0() { return threadIdx.x % 8 * 4; }

// [row i][half h][column j] of this thread's outputs: row row0 + 4 i,
// column col0 + 32 h + j.
template <int RM>
struct Frag {
  float v[RM][2][4];
};

template <int RM>
__device__ __forceinline__ void zero(Frag<RM>& f) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) f.v[i][j / 4][j % 4] = 0.f;
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The one order every schedule shares: part += the product of one slab,
// As at this thread's first row of the slab and Bs at its first column,
// k ascending.
template <int RM>
__device__ __forceinline__ void fma_slab(Frag<RM>& part, const float* As, const float* Bs) {
#pragma unroll
  for (int kq = 0; kq < KT; kq += 4) {
    float4 a[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = *reinterpret_cast<const float4*>(As + i * 4 * LDA + kq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + (kq + kk) * LDB);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + (kq + kk) * LDB + 32);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float ai = lane_of(a[i], kk);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float& p = part.v[i][j / 4][j % 4];
          p = __fmaf_rn(ai, b[j], p);
        }
      }
    }
  }
}

// A[m0 : m0 + TM, ks : ks + KT] -> As[r * LDA + kk], zero outside m < M and
// k < kend.  A 16-byte unit (four k of a row) that lies inside and whose
// source is aligned is one cp.async; any other (the ragged edge, a column
// slice of A) is copied element by element.
template <class S>
__device__ __forceinline__ void copy_a(float* As, const float* A, long long lda, int M, int m0,
                                       int ks, int kend) {
#pragma unroll
  for (int i = 0; i < S::AU; ++i) {
    const int u = threadIdx.x + i * S::NT;
    const int r = u / (KT / 4), kk = u % (KT / 4) * 4, m = m0 + r, k = ks + kk;
    float* dst = As + r * LDA + kk;
    const float* src = A + (long long)m * lda + k;
    if (m < M && k + 4 <= kend && tc::aligned16(src)) {
      tc::cp_async16(dst, src);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j] = (m < M && k + j < kend) ? src[j] : 0.f;
    }
  }
}

// B[ks : ks + KT, n0 : n0 + TN] -> Bs[kk * LDB + c], zero outside k < kend
// and n < N.  An n-fast B goes in 16-byte units along n, as copy_a; any
// other (embedding.T is k-fast) in units of four k down a column, element
// by element, transposed into the same [k][n] layout.
template <class S>
__device__ __forceinline__ void copy_b(float* Bs, const float* B, long long sbk, long long sbn,
                                       int N, int n0, int ks, int kend) {
  if (sbn == 1) {
#pragma unroll
    for (int i = 0; i < S::BU; ++i) {
      const int u = threadIdx.x + i * S::NT;
      const int kk = u / (TN / 4), c = u % (TN / 4) * 4, k = ks + kk, n = n0 + c;
      float* dst = Bs + kk * LDB + c;
      const float* src = B + k * sbk + n;
      if (k < kend && n + 4 <= N && tc::aligned16(src)) {
        tc::cp_async16(dst, src);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[j] = (k < kend && n + j < N) ? src[j] : 0.f;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < S::BU; ++i) {
      const int u = threadIdx.x + i * S::NT;
      const int c = u / (KT / 4), kk = u % (KT / 4) * 4, k = ks + kk, n = n0 + c;
      const float* src = B + k * sbk + n * sbn;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Bs[(kk + j) * LDB + c] = (k + j < kend && n < N) ? src[j * sbk] : 0.f;
    }
  }
}

// Where this thread's 16-byte units of an A and a B slab come from (at
// k = 0) and go to, set up once per CTA tile.  Unit i of A is row
// a_row + i * RA of the tile, columns a_col + 0-3 of the slab; unit i of B
// is slab row b_row + i * RB, columns b_col + 0-3 (RA = 4 NT / KT,
// RB = NT / 16 rows per pass).  a_fast (b_fast) holds when every such unit
// of a whole slab is one aligned cp.async: the tile lies inside M (N), the
// pointer and the row stride keep 16-byte alignment (and B is n-fast).  A
// whole slab lies inside the chunk and starts on a multiple of 4; every
// other slab goes through the masked copy_a and copy_b.
struct CopyPlan {
  const float* a;            // A + (m0 + a_row) * lda + a_col
  const float* b;            // B + b_row * sbk + n0 + b_col
  long long a_step, b_step;  // RA rows of A, RB rows of B
  int a_dst, b_dst;          // shared-memory offsets of unit 0
  bool a_fast, b_fast;
};

template <class S>
__device__ __forceinline__ CopyPlan make_plan(const float* A, long long lda, const float* B,
                                              long long sbk, long long sbn, int M, int N, int m0,
                                              int n0) {
  const int a_row = threadIdx.x / (KT / 4), a_col = threadIdx.x % (KT / 4) * 4;
  const int b_row = threadIdx.x / (TN / 4), b_col = threadIdx.x % (TN / 4) * 4;
  CopyPlan p;
  p.a = A + (long long)(m0 + a_row) * lda + a_col;
  p.b = B + b_row * sbk + n0 + b_col;
  p.a_step = (long long)(S::NT / (KT / 4)) * lda;
  p.b_step = (long long)(S::NT / (TN / 4)) * sbk;
  p.a_dst = a_row * LDA + a_col;
  p.b_dst = b_row * LDB + b_col;
  p.a_fast = m0 + S::TM <= M && tc::aligned16(A) && lda % 4 == 0;
  p.b_fast = n0 + TN <= N && sbn == 1 && tc::aligned16(B) && sbk % 4 == 0;
  return p;
}

__device__ __forceinline__ bool whole_slab(int ks, int kend) {
  return ks + KT <= kend && (ks & 3) == 0;
}

// The A slab at ks -> As, by the plan where it can, masked otherwise.
template <class S>
__device__ __forceinline__ void plan_a(float* As, const CopyPlan& p, const float* A, long long lda,
                                       int M, int m0, int ks, int kend) {
  if (p.a_fast && whole_slab(ks, kend)) {
#pragma unroll
    for (int i = 0; i < S::AU; ++i)
      tc::cp_async16(As + p.a_dst + i * (S::NT / (KT / 4)) * LDA, p.a + i * p.a_step + ks);
  } else {
    copy_a<S>(As, A, lda, M, m0, ks, kend);
  }
}

// The B slab at ks -> Bs, by the plan where it can, masked otherwise.
template <class S>
__device__ __forceinline__ void plan_b(float* Bs, const CopyPlan& p, const float* B, long long sbk,
                                       long long sbn, int N, int n0, int ks, int kend) {
  if (p.b_fast && whole_slab(ks, kend)) {
    const float* src = p.b + ks * sbk;
#pragma unroll
    for (int i = 0; i < S::BU; ++i)
      tc::cp_async16(Bs + p.b_dst + i * (S::NT / (TN / 4)) * LDB, src + i * p.b_step);
  } else {
    copy_b<S>(Bs, B, sbk, sbn, N, n0, ks, kend);
  }
}

// fn(q, v, c, n, vec) for each run of four of this thread's outputs in a
// row inside M: q its index (2 i + h), v its four values in f, c its
// address in C, n its first column, vec whether it lies inside N and can
// move as one aligned float4.
template <int RM, class F>
__device__ __forceinline__ void each_run(Frag<RM>& f, float* Cm, int M, int N, int m0, int n0,
                                         F fn) {
  const int r0 = m0 + row0<RM>(), c0 = n0 + col0();
  const bool vec = N % 4 == 0 && tc::aligned16(Cm);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = r0 + 4 * i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = c0 + 32 * h;
      if (m < M) fn(2 * i + h, f.v[i][h], Cm + (long long)m * N + n, n, vec && n < N);
    }
  }
}

// C += part over the tile, one rounded add per output.  C is updated in
// place: the wrapper owns it.
template <int RM>
__device__ __forceinline__ void add_to_c(Frag<RM>& part, float* Cm, int M, int N, int m0, int n0) {
  each_run(part, Cm, M, N, m0, n0, [&](int, float (&v)[4], float* c, int n, bool vec) {
    if (vec) {
      float4 x = *reinterpret_cast<const float4*>(c);
      x.x = __fadd_rn(x.x, v[0]);
      x.y = __fadd_rn(x.y, v[1]);
      x.z = __fadd_rn(x.z, v[2]);
      x.w = __fadd_rn(x.w, v[3]);
      *reinterpret_cast<float4*>(c) = x;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < N) c[j] = __fadd_rn(c[j], v[j]);
    }
  });
}

// wls's accumulator, in shared memory: run q of thread t at
// Cs[(q * NT + t) * 4], so a warp's accesses are 512 contiguous bytes.
// Each thread touches only its own runs, so no barrier guards it.
template <class S>
__device__ __forceinline__ float* run_at(float* Cs, int q) {
  return Cs + (q * S::NT + threadIdx.x) * 4;
}

// Cs = C over the tile: aligned runs by cp.async, in the copy group of the
// ring's first slab, the rest element by element (0 outside N; runs outside
// M are never read).
template <class S, int RM>
__device__ __forceinline__ void seed_acc(float* Cs, Frag<RM>& f, float* Cm, int M, int N, int m0,
                                         int n0) {
  each_run(f, Cm, M, N, m0, n0, [&](int q, float (&)[4], const float* c, int n, bool vec) {
    float* d = run_at<S>(Cs, q);
    if (vec) {
      tc::cp_async16(d, c);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) d[j] = n + j < N ? c[j] : 0.f;
    }
  });
}

// Cs += part, one rounded add per output; part restarts from zero.
template <class S, int RM>
__device__ __forceinline__ void fold_acc(float* Cs, Frag<RM>& part) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4* d = reinterpret_cast<float4*>(run_at<S>(Cs, 2 * i + h));
      float4 x = *d;
      float(&v)[4] = part.v[i][h];
      x.x = __fadd_rn(x.x, v[0]);
      x.y = __fadd_rn(x.y, v[1]);
      x.z = __fadd_rn(x.z, v[2]);
      x.w = __fadd_rn(x.w, v[3]);
      *d = x;
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
}

// C = Cs over the tile.
template <class S, int RM>
__device__ __forceinline__ void store_acc(float* Cs, Frag<RM>& f, float* Cm, int M, int N, int m0,
                                          int n0) {
  each_run(f, Cm, M, N, m0, n0, [&](int q, float (&)[4], float* c, int n, bool vec) {
    const float4 x = *reinterpret_cast<const float4*>(run_at<S>(Cs, q));
    if (vec) {
      *reinterpret_cast<float4*>(c) = x;
    } else {
      const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < N) c[j] = v[j];
    }
  });
}

// base (one chunk: kbeg = k0, kstop = min(k0 + bk, K), chained) and wls
// (kbeg = 0, kstop = K, not chained): the CTA of output tile (blockIdx.y,
// blockIdx.x) forms each chunk's partial in registers.  base adds it to C
// with one rounded add, reading C once the previous kernel on the stream
// has finished; wls adds it to its accumulator in shared memory, seeded
// from C, and writes C once.  Slabs arrive through a ring of kStages that
// runs across chunk boundaries, two in flight while one is multiplied.
template <int TM, int RM>
__global__ void __launch_bounds__(Shape<TM, RM>::NT, Shape<TM, RM>::MIN_CTAS)
sgemm_tile(const float* A, long long lda, const float* B, long long sbk, long long sbn,
           float* Cm, int M, int N, int kbeg, int kstop, int bk, int chained) {
  using S = Shape<TM, RM>;
  extern __shared__ __align__(16) float simt_smem[];
  float* As = simt_smem;
  float* Bs = As + kStages * S::A_SLAB;
  float* Cs = Bs + kStages * B_SLAB;  // wls only: TM x TN accumulators
  tc::let_next_start();
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int a_at = row0<RM>() * LDA, b_at = col0();
  const CopyPlan plan = make_plan<S>(A, lda, B, sbk, sbn, M, N, m0, n0);
  Frag<RM> part;
  zero(part);
  if (!chained) seed_acc<S>(Cs, part, Cm, M, N, m0, n0);
  int pk0 = kbeg, pks = kbeg;  // the next slab to copy: its chunk and k
  auto issue = [&](int stage) {
    if (pk0 < kstop) {
      const int pend = min(pk0 + bk, kstop);
      plan_a<S>(As + stage * S::A_SLAB, plan, A, lda, M, m0, pks, pend);
      plan_b<S>(Bs + stage * B_SLAB, plan, B, sbk, sbn, N, n0, pks, pend);
      pks += KT;
      if (pks >= pend) pk0 = pks = pend;
    }
    tc::cp_async_commit();  // empty groups keep the count that wait relies on
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  int ck0 = kbeg, cks = kbeg;  // the slab to multiply: its chunk and k
  for (int i = 0; ck0 < kstop; ++i) {
    tc::cp_async_wait<kStages - 2>();  // slab i has landed (this thread's part)
    __syncthreads();                   // ... everyone's; slab i - 1 is read
    issue((i + kStages - 1) % kStages);
    const int st = i % kStages;
    fma_slab(part, As + st * S::A_SLAB + a_at, Bs + st * B_SLAB + b_at);
    cks += KT;
    const int cend = min(ck0 + bk, kstop);
    if (cks >= cend) {  // the chunk's partial is whole
      if (chained) {
        tc::wait_for_previous();
        add_to_c(part, Cm, M, N, m0, n0);
      } else {
        fold_acc<S>(Cs, part);
      }
      ck0 = cks = cend;
    }
  }
  if (!chained) store_acc<S>(Cs, part, Cm, M, N, m0, n0);
}

// A slab of the chunk's B block from the shared memory of cluster CTA
// `owner` into this CTA's (the TN data columns of its KT rows), through
// BU 16-byte registers per thread: gather_load issues the reads,
// gather_store writes them once their slot is free.
template <class S>
__device__ __forceinline__ void gather_load(float4 (&g)[S::BU], float* slab, int owner) {
  const float* src = cg::this_cluster().map_shared_rank(slab, owner);
#pragma unroll
  for (int i = 0; i < S::BU; ++i) {
    const int u = threadIdx.x + i * S::NT;
    g[i] = *reinterpret_cast<const float4*>(src + u / (TN / 4) * LDB + u % (TN / 4) * 4);
  }
}

template <class S>
__device__ __forceinline__ void gather_store(const float4 (&g)[S::BU], float* slab) {
#pragma unroll
  for (int i = 0; i < S::BU; ++i) {
    const int u = threadIdx.x + i * S::NT;
    *reinterpret_cast<float4*>(slab + u / (TN / 4) * LDB + u % (TN / 4) * 4) = g[i];
  }
}

// wlbp, one k-chunk [k0, kend) of nslab slabs.  The cluster (blockIdx.x,
// its G CTAs along M) owns N slab blockIdx.y, and the chunk's B block stays
// in the cluster's shared memory, read from HBM once: CTA r copies slabs
// r, r + G, ... (its share, which it keeps), and then walks M tiles r,
// r + G, ... over the whole block, A streaming through a ring of kStages
// slabs.  A slab of another CTA's share is read from that CTA's shared
// memory into a two-slot ring one slab ahead of its use, so the gather
// overlaps the FMAs.  Keeping only a share puts two CTAs on an SM at
// bk 512, and lets G rise to kMaxCluster for a block deeper than one CTA
// holds (CTAs past the last M tile then only serve their share).  Each
// tile's partial is added to C once the previous kernel on the stream has
// finished.
template <int TM, int RM>
__global__ void __launch_bounds__(Shape<TM, RM>::NT, Shape<TM, RM>::MIN_CTAS)
sgemm_wlbp(const float* A, long long lda, const float* B, long long sbk, long long sbn,
           float* Cm, int M, int N, int k0, int kend, int nslab) {
  using S = Shape<TM, RM>;
  constexpr int R = kStages;
  extern __shared__ __align__(16) float simt_smem[];
  float* As = simt_smem;               // the ring of A slabs
  float* Bring = As + R * S::A_SLAB;   // two slabs gathered from other CTAs
  float* Bown = Bring + 2 * B_SLAB;    // this CTA's share: slab r + j G at j * B_SLAB
  tc::let_next_start();
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int n0 = blockIdx.y * TN;
  const CopyPlan share = make_plan<S>(A, lda, B, sbk, sbn, M, N, r * TM, n0);
  for (int s = r; s < nslab; s += G)
    plan_b<S>(Bown + s / G * B_SLAB, share, B, sbk, sbn, N, n0, k0 + s * KT, kend);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  cluster.sync();  // every CTA's share of the block has landed
  const int a_at = row0<RM>() * LDA, b_at = col0();
  const auto slab = [&](int s) {
    return s % G == r ? Bown + s / G * B_SLAB : Bring + s % 2 * B_SLAB;
  };
  bool first = true;
  for (int m0 = r * TM; m0 < M; m0 += G * TM) {
    const CopyPlan plan = make_plan<S>(A, lda, B, sbk, sbn, M, N, m0, n0);
    Frag<RM> part;
    zero(part);
    auto issue = [&](int s) {
      if (s < nslab) plan_a<S>(As + s % R * S::A_SLAB, plan, A, lda, M, m0, k0 + s * KT, kend);
      tc::cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < R - 1; ++s) issue(s);
    float4 g[S::BU];
    if (r != 0) {  // slab 0 is CTA 0's
      gather_load<S>(g, Bown, 0);
      gather_store<S>(g, Bring);
    }
    int pending = -1;  // the slab whose gathered units wait in g
    for (int s = 0; s < nslab; ++s) {
      if (pending >= 0) gather_store<S>(g, Bring + pending % 2 * B_SLAB);
      pending = -1;
      tc::cp_async_wait<R - 2>();
      __syncthreads();
      issue(s + R - 1);
      const int nx = s + 1;
      if (nx < nslab && nx % G != r) {
        gather_load<S>(g, Bown + nx / G * B_SLAB, nx % G);
        pending = nx;
      }
      fma_slab(part, As + s % R * S::A_SLAB + a_at, slab(s) + b_at);
    }
    if (first) tc::wait_for_previous();
    first = false;
    add_to_c(part, Cm, M, N, m0, n0);
    __syncthreads();  // the next tile's first copies reuse the rings
  }
  cluster.sync();  // no CTA leaves while another may still read its share
}

}  // namespace simt

// ------------------------------------------------------------- decode path
// M <= 4.  A decode GEMM does 8 operations per weight byte, so it is bound
// by the bytes of B, and the design is about keeping HBM busy: B is never
// staged in shared memory.  Every thread streams its share of B straight
// into registers with 16-byte read-only loads (ld.global.nc,
// L1::no_allocate), converts to fp32 and runs FMA chains against the four
// rows of A, which it loads beside B (A is small and stays in L2).  One
// CTA of 256 threads owns a tile of columns and all of K.
//
// Two layouts of B:
//   row-major (sbn == 1): LN lanes x 16 bytes cover one k row of the tile
//     (LN in 8, 4, 2, 1: 64 to 8 columns in bf16, 32 to 4 in f32), so the
//     CTA reads 256 / LN rows a step; thread row r takes rows r, r + 256 /
//     LN, ... of each chunk and holds 4 x V fp32 partials.
//   k-fast (embedding.T, or any other strides): each column is contiguous
//     along k, so a warp owns 4 columns and its lanes run along k, 16 bytes
//     each (256 k in bf16 a step); the four columns reuse one read of A.

namespace dec {

constexpr int NT = 256, kWarps = NT / 32;
constexpr int kCols = 4;  // k-fast: columns per warp

// The tile of one CTA.  LN > 0: row-major B, LN lanes of 16 bytes cover a
// row of the tile (LN * V columns) and the CTA takes NT / LN rows a step.
// LN == 0: k-fast B, a warp owns kCols columns and its lanes take 32 * V
// consecutive k a step.
template <int LN, typename T>
struct Dec {
  static constexpr bool KF = LN == 0;
  static constexpr int V = 16 / (int)sizeof(T);          // elements per 16 bytes
  static constexpr int STEP = KF ? 32 * V : NT / (KF ? 1 : LN);  // k rows a step
  static constexpr int UB = KF ? 1 : 4;                  // steps a batch of loads
  static constexpr int NL = KF ? kCols : UB;             // 16-byte loads of B a batch
  static constexpr int TN = KF ? kWarps * kCols : LN * V;  // tile columns
  static constexpr int PC = KF ? kCols : V;              // partial columns per thread
  static constexpr int OUT = 4 * TN;                     // outputs per tile
};

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ unsigned bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }

// Elements p[j * step] for j < valid, zero beyond, packed as a 16-byte
// vector load would have packed them (the fallback for unaligned B and the
// ragged edge).
template <typename T>
__device__ __forceinline__ uint4 ld_elems(const T* p, long long step, int valid) {
  constexpr int V = 16 / (int)sizeof(T);
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (j < valid) {
      const unsigned x = bits(p[j * step]);
      if constexpr (V == 8) w[j / 2] |= x << (16 * (j % 2));
      else w[j] = x;
    }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A value from bits() of it, as fp32.
template <typename T>
__device__ __forceinline__ float from_bits(unsigned x) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(x);
  else return __uint_as_float(x << 16);
}

// Element j of a unit, as fp32.
template <typename T>
__device__ __forceinline__ float elem(const uint4& u, int j) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 4) return __uint_as_float(w[j]);
  else return __uint_as_float(j % 2 ? w[j / 2] & 0xffff0000u : w[j / 2] << 16);
}

// One launch: the nc chunks of bk from k0 (base and wlbp: one; wls: all).
struct Args {
  const void* A;
  long long lda;
  const void* B;
  long long sbk, sbn;
  float* C;
  int M, N, K, k0, bk, nc, vec_ok, a_vec, c_init, chained;
};

// Where one batch of loads lies: UB steps from step j of chunk c, which
// spans [kbase, kstop) in `steps` steps.
struct Batch {
  int c, j, kbase, kstop, steps;
  __device__ void enter(const Args& a, int step) {
    const long long kc = (long long)a.k0 + (long long)c * a.bk;
    kbase = (int)kc;
    kstop = (int)min(kc + a.bk, (long long)a.K);
    steps = (kstop - kbase + step - 1) / step;
  }
  __device__ void next(const Args& a, int step, int ub) {
    j += ub;
    if (j >= steps) {
      j = 0;
      if (++c < a.nc) enter(a, step);
    }
  }
};

// C = A @ B over the launch's chunks for the N tile of blockIdx.x.  Each
// output's partial over a chunk is formed in one fixed order: each
// thread's FMA chain over its k of the chunk, ascending from 0; then a
// fixed xor-butterfly over the lanes that share its columns; then (row-
// major) a fixed pairwise tree over the 8 warps.  It is then added with
// one __fadd_rn to C (base, wlbp: c_init = 0 adds it to zero instead) or
// to wls's accumulator, seeded from C, in chunk order.  Every schedule
// runs this kernel with the tile that N alone chooses, so all three make
// the same sums.
template <int LN, typename T>
__global__ void __launch_bounds__(NT, 2) decode_kernel(Args a) {
  using D = Dec<LN, T>;
  constexpr bool KF = D::KF;
  constexpr int V = D::V, STEP = D::STEP, UB = D::UB, NL = D::NL, TN = D::TN, OUT = D::OUT;
  // lanes l and l ^ x share their columns for x = LW, 2 LW, ... < 32
  constexpr int PC = D::PC, LW = KF ? 1 : LN;
  __shared__ float red[KF ? 1 : 2 * kWarps * OUT];  // row-major: [chunk % 2][warp][OUT]
  tc::let_next_start();
  const T* A = static_cast<const T*>(a.A);
  const T* B = static_cast<const T*>(a.B);
  const int n0 = blockIdx.x * TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // Whole 16-byte units everywhere (uniform per CTA): plain loads, zero
  // beyond the chunk; else element loads masked by N and the chunk.
  const bool fast = a.vec_ok && n0 + TN <= a.N;
  // row-major: thread row r = t / LN of each step, LN threads covering the
  // tile's units of a row; k-fast: lane l takes k l * V .. + V of each
  // step, for the warp's kCols columns
  const int r = KF ? lane * V : threadIdx.x / LW;
  const int n = KF ? n0 + warp * kCols : n0 + threadIdx.x % LW * V;
  const int cols = KF ? 0 : min(V, a.N - n);
  // the output this thread adds up: row-major, t < OUT; k-fast, lane < 16
  // of each warp (m = lane / kCols)
  const int om = KF ? lane / kCols : threadIdx.x / TN;
  const int on = KF ? n + lane % kCols : n0 + threadIdx.x % TN;
  const bool mine = KF ? lane < 4 * kCols : threadIdx.x < OUT;

  // One batch in registers: B's units and (row-major) the bits of the four
  // rows of A at each unit's k.  A is small and read by every CTA: it
  // comes from L2.  k-fast A (a lane's V k of each row, shared by its four
  // columns) is loaded when its batch is summed, to stay under 128
  // registers.
  struct Regs {
    uint4 b[NL];
    unsigned ar[KF ? 1 : UB][4];
  };
  auto fetch = [&](Regs& x, const Batch& bt) {
    if (bt.c >= a.nc) return;
    const int k0 = bt.kbase + bt.j * STEP + r;
    if constexpr (!KF) {
      const long long qs = (long long)STEP * a.sbk;
      const T* q = B + (long long)k0 * a.sbk + n;
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const int k = k0 + u * STEP;
        const bool in = k < bt.kstop;
        if (fast) x.b[u] = in ? ld_stream(q + u * qs) : make_uint4(0u, 0u, 0u, 0u);
        else x.b[u] = ld_elems(q + u * qs, 1, in ? cols : 0);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          x.ar[u][m] = 0u;  // a predicated load: nothing waits for it here
          if (in && m < a.M) x.ar[u][m] = bits(A[(long long)m * a.lda + k]);
        }
      }
    } else {
      const T* q = B + (long long)k0 * a.sbk + (long long)n * a.sbn;
      const int valid = max(0, min(V, bt.kstop - k0));
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (fast) x.b[c] = valid ? ld_stream(q + c * a.sbn) : make_uint4(0u, 0u, 0u, 0u);
        else x.b[c] = ld_elems(q + c * a.sbn, a.sbk, n + c < a.N ? valid : 0);
      }
    }
  };

  float acc = 0.f, p[4][PC];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int e = 0; e < PC; ++e) p[m][e] = 0.f;
  // v: chunk c's partial of this thread's output, in chunk order into acc,
  // which the first chunk seeds from C (once the previous kernel on the
  // stream has finished, for a chained chunk) or from zero
  auto add = [&](float v, int c) {
    if (c == 0) {
      if (a.chained) tc::wait_for_previous();
      acc = a.c_init && om < a.M && on < a.N ? a.C[(long long)om * a.N + on] : 0.f;
    }
    acc = __fadd_rn(acc, v);
  };

  Batch bi{0, 0, 0, 0, 0}, bc{0, 0, 0, 0, 0};  // the next batch to fetch; to sum
  bi.enter(a, STEP);
  bc.enter(a, STEP);
  Regs xc, xn;
  fetch(xc, bi);
  bi.next(a, STEP, UB);
  while (bc.c < a.nc) {
    fetch(xn, bi);  // in flight while this batch is summed
    bi.next(a, STEP, UB);
    if constexpr (!KF) {
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        if (bc.j + u >= bc.steps) break;
#pragma unroll
        for (int e = 0; e < PC; ++e) {
          const float b = elem<T>(xc.b[u], e);
#pragma unroll
          for (int m = 0; m < 4; ++m) p[m][e] = __fmaf_rn(from_bits<T>(xc.ar[u][m]), b, p[m][e]);
        }
      }
    } else {
      const int k0 = bc.kbase + bc.j * STEP + r;
      const int valid = max(0, min(V, bc.kstop - k0));
      uint4 ak[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const T* am = A + (long long)m * a.lda + k0;
        const int mv = m < a.M ? valid : 0;
        ak[m] = mv == V && a.a_vec ? *reinterpret_cast<const uint4*>(am) : ld_elems(am, 1, mv);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float av[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) av[m] = elem<T>(ak[m], e);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float b = elem<T>(xc.b[c], e);
#pragma unroll
          for (int m = 0; m < 4; ++m) p[m][c] = __fmaf_rn(av[m], b, p[m][c]);
        }
      }
    }
    if (bc.j + UB >= bc.steps) {  // chunk c's partials are whole
      const int c = bc.c;
      float* dst = KF ? nullptr : red + (c % 2 * kWarps + warp) * OUT + lane * V;
      float own = 0.f;  // k-fast: this lane's output's partial
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < PC; ++e) {
          float v = p[m][e];
          p[m][e] = 0.f;
#pragma unroll
          for (int x = LW; x < 32; x *= 2) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, x));
          if constexpr (KF) {
            if (lane == m * kCols + e) own = v;
          } else {
            if (lane < LW) dst[m * TN + e] = v;
          }
        }
      if constexpr (KF) {
        if (mine) add(own, c);
      } else {  // a fixed pairwise tree over the warps
        __syncthreads();
        if (mine) {
          float v[kWarps];
#pragma unroll
          for (int w = 0; w < kWarps; ++w) v[w] = red[(c % 2 * kWarps + w) * OUT + threadIdx.x];
#pragma unroll
          for (int s = 1; s < kWarps; s *= 2)
#pragma unroll
            for (int w = 0; w + s < kWarps; w += 2 * s) v[w] = __fadd_rn(v[w], v[w + s]);
          add(v[0], c);
        }
      }
    }
    bc.next(a, STEP, UB);
    xc = xn;
  }
  if (mine && om < a.M && on < a.N) a.C[(long long)om * a.N + on] = acc;
}

}  // namespace dec

// Dynamic shared memory above 48 KB has to be allowed per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Launches kernel with the given cluster size (0: none) and, with overlap,
// the programmatic dependent launch attribute; returns the launch's error.
// Every path launches through it; the two attributes launch together (the
// wlbp kernels' chained chunks use both).
// A refused launch (shared memory, cluster) returns its error: there is no
// other path.  The kernel's attributes are set again only for a larger
// launch or another device (a launch costs the host a few microseconds,
// and base and wlbp make one per chunk): the shared memory it may use, and
// the largest carveout, so that two CTAs (of one launch, or of a chunk's
// launch and the next one's) fit on an SM.
template <auto kernel, typename... Args>
int launch_ex(dim3 grid, int threads, int smem, cudaStream_t stream, int cluster, bool overlap,
              Args... args) {
  static int set_smem = -1, set_device = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && (device != set_device || smem > set_smem)) {
    err = allow_smem(kernel, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess) {
      set_smem = smem;
      set_device = device;
    }
  }
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attrs[2];
  int n = 0;
  if (cluster > 0) {
    attrs[n].id = cudaLaunchAttributeClusterDimension;
    attrs[n].val.clusterDim.x = cluster;
    attrs[n].val.clusterDim.y = 1;
    attrs[n].val.clusterDim.z = 1;
    ++n;
  }
  if (overlap) {
    attrs[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = n;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}


namespace tc {

// 128-row tiles, unless they would give fewer CTAs than three quarters of
// the SMs (qwen3-1.7b's N = 1024 GEMMs at M = 512: 64 CTAs, against 128
// with 64-row tiles).  Every output's partial is the same mma sequence
// whatever the tile, so the choice changes no number.
bool tall_tiles(int M, int N) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return 4LL * ((M + 127) / 128) * ((N + TN - 1) / TN) >= 3LL * sms;
}

template <int TM>
int ws_chunk(int wlbp, const u16* A, long long lda, const u16* B, long long sbk, long long sbn,
             float* c, int M, int N, int K, int k0, int bk, cudaStream_t stream) {
  constexpr int NT = Shape<TM>::NT;
  const int kend = (long long)k0 + bk < K ? k0 + bk : K;
  const int nt = (N + TN - 1) / TN, mt = (M + TM - 1) / TM;
  if (!wlbp)
    return launch_ex<tile_kernel<TM>>(dim3(nt, mt), NT, smem_bytes<TM>(kStages, kStages),
                                      stream, 0, true, A, lda, B, sbk, sbn, c, M, N, k0,
                                      kend, kend - k0, 1);
  const int nslab = (kend - k0 + KT - 1) / KT;
  int G = 1;  // CTAs per cluster: a power of two, at most one per M tile
  while (2 * G <= mt && 2 * G <= kMaxCluster) G *= 2;
  return launch_ex<wlbp_kernel<TM>>(dim3(G, nt), NT, smem_bytes<TM>(kWlbpStages, nslab),
                                    stream, G, true, A, lda, B, sbk, sbn, c, M, N, k0, kend,
                                    nslab);
}

template <int TM>
int wls(const u16* A, long long lda, const u16* B, long long sbk, long long sbn, float* c,
        int M, int N, int K, int bk, cudaStream_t stream) {
  const int nt = (N + TN - 1) / TN, mt = (M + TM - 1) / TM;
  return launch_ex<tile_kernel<TM>>(dim3(nt, mt), Shape<TM>::NT,
                                    smem_bytes<TM>(kStages, kStages), stream, 0, false, A, lda,
                                    B, sbk, sbn, c, M, N, 0, K, bk < K ? bk : K, 0);
}

// The bf16 M > 4 entry points.
int launch_ws_chunk(int wlbp, const void* a, long long lda, const void* b, long long sbk,
                    long long sbn, float* c, int M, int N, int K, int k0, int bk,
                    cudaStream_t stream) {
  const u16* A = static_cast<const u16*>(a);
  const u16* B = static_cast<const u16*>(b);
  return tall_tiles(M, N)
             ? ws_chunk<128>(wlbp, A, lda, B, sbk, sbn, c, M, N, K, k0, bk, stream)
             : ws_chunk<64>(wlbp, A, lda, B, sbk, sbn, c, M, N, K, k0, bk, stream);
}

int launch_wls(const void* a, long long lda, const void* b, long long sbk, long long sbn,
               float* c, int M, int N, int K, int bk, cudaStream_t stream) {
  const u16* A = static_cast<const u16*>(a);
  const u16* B = static_cast<const u16*>(b);
  return tall_tiles(M, N) ? wls<128>(A, lda, B, sbk, sbn, c, M, N, K, bk, stream)
                          : wls<64>(A, lda, B, sbk, sbn, c, M, N, K, bk, stream);
}

}  // namespace tc


namespace dec {

int sm_count() {
  static int sms = 0, set_device = -1;
  int device = 0;
  if (cudaGetDevice(&device) == cudaSuccess && device != set_device &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) == cudaSuccess)
    set_device = device;
  return sms;
}

// 16-byte loads of B need an aligned base and strides that keep every unit
// aligned; k-fast units also need chunk starts and K on a unit boundary.
template <typename T>
int vec_ok(bool kf, const void* b, long long sbk, long long sbn, int K, int bk) {
  constexpr long long V = 16 / (long long)sizeof(T);
  if (reinterpret_cast<unsigned long long>(b) % 16 != 0) return 0;
  return kf ? (sbk == 1 && sbn % V == 0 && bk % V == 0 && K % V == 0) : sbk % V == 0;
}

// A's runs of 16 bytes along k are whole units when A, its row stride and
// every chunk start are aligned to them.
template <typename T>
int a_vec(const void* a, long long lda, int bk) {
  constexpr long long V = 16 / (long long)sizeof(T);
  return reinterpret_cast<unsigned long long>(a) % 16 == 0 && lda % V == 0 && bk % V == 0;
}

// One decode launch: the chunk at k0 (base, wlbp: each chunk after the
// first chained to the one before by programmatic dependent launch, so
// that it runs while that one drains; its first may read an A that the
// kernel before it is still writing), or every chunk (wls).
template <int LN, typename T>
int launch(const void* a, long long lda, const void* b, long long sbk, long long sbn, float* c,
           int M, int N, int K, int k0, int bk, int wls_all, int c_init, cudaStream_t stream) {
  using D = Dec<LN, T>;
  const int tiles = (int)(((long long)N + D::TN - 1) / D::TN);
  const int nc = wls_all ? (int)(((long long)K + bk - 1) / bk) : 1;
  const int chained = !wls_all && k0 > 0;
  const Args args{a, lda, b, sbk, sbn, c, M, N, K, k0, bk, nc,
                  vec_ok<T>(D::KF, b, sbk, sbn, K, bk), a_vec<T>(a, lda, bk), c_init, chained};
  return launch_ex<decode_kernel<LN, T>>(dim3(tiles), NT, 0, stream, 0, chained, args);
}

// The M <= 4 entry point.  Row-major B takes the widest tile that still
// gives about one CTA an SM (no chunk is split across CTAs: its partial is
// the tile's own); any other strides the k-fast tile.  The tile depends on
// N (and the SM count) alone, as the schedules' bit-identity needs.
template <typename T>
int entry_t(const void* a, long long lda, const void* b, long long sbk, long long sbn,
            float* c, int M, int N, int K, int k0, int bk, int wls_all, int c_init,
            cudaStream_t s) {
  if (sbn != 1)
    return launch<0, T>(a, lda, b, sbk, sbn, c, M, N, K, k0, bk, wls_all, c_init, s);
  const long long V = 16 / (long long)sizeof(T), want = 9LL * sm_count();
  const auto wide = [&](long long ln) { return 10 * (((long long)N + ln * V - 1) / (ln * V)) >= want; };
  if (wide(8)) return launch<8, T>(a, lda, b, sbk, sbn, c, M, N, K, k0, bk, wls_all, c_init, s);
  if (wide(4)) return launch<4, T>(a, lda, b, sbk, sbn, c, M, N, K, k0, bk, wls_all, c_init, s);
  if (wide(2)) return launch<2, T>(a, lda, b, sbk, sbn, c, M, N, K, k0, bk, wls_all, c_init, s);
  return launch<1, T>(a, lda, b, sbk, sbn, c, M, N, K, k0, bk, wls_all, c_init, s);
}

int entry(int bf16, const void* a, long long lda, const void* b, long long sbk, long long sbn,
          float* c, int M, int N, int K, int k0, int bk, int wls_all, int c_init,
          cudaStream_t s) {
  return bf16 ? entry_t<__nv_bfloat16>(a, lda, b, sbk, sbn, c, M, N, K, k0, bk, wls_all, c_init, s)
              : entry_t<float>(a, lda, b, sbk, sbn, c, M, N, K, k0, bk, wls_all, c_init, s);
}

}  // namespace dec


namespace simt {

// base and wls: 128-row tiles of 256 threads, unless they would give fewer
// CTAs than three quarters of the SMs (the tensor-core path's rule): then
// 64-row tiles of 128 threads (4 x 8 outputs a thread in both).  At
// qwen3-1.7b's prefill (M = 512) that is 128 CTAs for N = 2048, 384 for
// N = 6144, and 128 of 64 rows for N = 1024.  Every output's sum is the
// same FMA chain whatever the tile, so the choice changes no number.
int tile_rows(int M, int N) { return tc::tall_tiles(M, N) ? 128 : 64; }

template <int TM>
int tile_launch(const float* A, long long lda, const float* B, long long sbk, long long sbn,
                float* c, int M, int N, int kbeg, int kstop, int bk, bool wls,
                cudaStream_t stream) {
  using S = Shape<TM, 4>;
  const int nt = (N + TN - 1) / TN, mt = (M + TM - 1) / TM;
  const int smem = (kStages * (S::A_SLAB + B_SLAB) + (wls ? TM * TN : 0)) * (int)sizeof(float);
  return launch_ex<sgemm_tile<TM, 4>>(dim3(nt, mt), S::NT, smem, stream, 0, !wls, A, lda, B, sbk,
                                      sbn, c, M, N, kbeg, kstop, bk, (int)!wls);
}

// wlbp: 256-row tiles of 256 threads, 8 x 8 outputs a thread.  At
// M = 512 a cluster is two CTAs, so half of each B block is gathered from
// the other CTA's shared memory.
constexpr int kWlbpRows = 256;
using WlbpShape = Shape<kWlbpRows, 8>;

// Slabs of B one CTA of sgemm_wlbp keeps beside its rings.
constexpr int kShareCap =
    (kSmemMax / 4 - kStages * WlbpShape::A_SLAB - 2 * B_SLAB) / B_SLAB;

// The cluster of a wlbp chunk `depth` deep: one CTA per M tile, a power of
// two up to kMaxCluster, and more while the block does not fit in the
// CTAs' shares; 0 where kMaxCluster CTAs cannot hold it (deeper than
// kMaxCluster * kShareCap * KT rows).
int cluster_size(int M, int depth) {
  const int nslab = (depth + KT - 1) / KT, mt = (M + kWlbpRows - 1) / kWlbpRows;
  int G = 1;
  while (2 * G <= kMaxCluster && (2 * G <= mt || (nslab + G - 1) / G > kShareCap)) G *= 2;
  return (nslab + G - 1) / G <= kShareCap ? G : 0;
}

// The f32 M > 4 entry points.
int launch_ws_chunk(int wlbp, const void* a, long long lda, const void* b, long long sbk,
                    long long sbn, float* c, int M, int N, int K, int k0, int bk,
                    cudaStream_t stream) {
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  const int kend = (long long)k0 + bk < K ? k0 + bk : K;
  if (!wlbp)
    return tile_rows(M, N) == 128
               ? tile_launch<128>(A, lda, B, sbk, sbn, c, M, N, k0, kend, kend - k0, false, stream)
               : tile_launch<64>(A, lda, B, sbk, sbn, c, M, N, k0, kend, kend - k0, false, stream);
  const int nslab = (kend - k0 + KT - 1) / KT;
  const int G = cluster_size(M, kend - k0);
  if (G == 0) return (int)cudaErrorInvalidValue;  // deeper than a cluster holds
  const int smem =
      (kStages * WlbpShape::A_SLAB + (2 + (nslab + G - 1) / G) * B_SLAB) * (int)sizeof(float);
  return launch_ex<sgemm_wlbp<kWlbpRows, 8>>(dim3(G, (N + TN - 1) / TN), WlbpShape::NT, smem,
                                             stream, G, true, A, lda, B, sbk, sbn, c, M, N, k0,
                                             kend, nslab);
}

int launch_wls(const void* a, long long lda, const void* b, long long sbk, long long sbn,
               float* c, int M, int N, int K, int bk, cudaStream_t stream) {
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  bk = bk < K ? bk : K;
  return tile_rows(M, N) == 128
             ? tile_launch<128>(A, lda, B, sbk, sbn, c, M, N, 0, K, bk, true, stream)
             : tile_launch<64>(A, lda, B, sbk, sbn, c, M, N, 0, K, bk, true, stream);
}

}  // namespace simt

}  // namespace

extern "C" {

// One k-chunk [k0, k0 + bk) of C += A @ B for the base (wlbp = 0) or wlbp
// (wlbp = 1) schedule.  A: [M, K] bf16 (bf16 = 1) or f32, row stride lda,
// unit k stride.  B: [K, N] with strides (sbk, sbn).  C: [M, N] f32,
// contiguous, updated in place; at M <= 4, c_init = 0 says that C holds
// nothing yet and the chunk's sum is added to zero instead (M > 4 always
// reads C).  Returns the launch's error.
int rasa_ws_chunk(int wlbp, int bf16, const void* a, long long lda, const void* b,
                  long long sbk, long long sbn, float* c, int M, int N, int K, int k0,
                  int bk, int c_init, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 4) return dec::entry(bf16, a, lda, b, sbk, sbn, c, M, N, K, k0, bk, 0, c_init, s);
  return bf16 ? tc::launch_ws_chunk(wlbp, a, lda, b, sbk, sbn, c, M, N, K, k0, bk, s)
              : simt::launch_ws_chunk(wlbp, a, lda, b, sbk, sbn, c, M, N, K, k0, bk, s);
}

// All of C += A @ B, output-stationary, k-chunks of bk (same layouts and
// c_init).
int rasa_wls(int bf16, const void* a, long long lda, const void* b, long long sbk,
             long long sbn, float* c, int M, int N, int K, int bk, int c_init, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 4) return dec::entry(bf16, a, lda, b, sbk, sbn, c, M, N, K, 0, bk, 1, c_init, s);
  return bf16 ? tc::launch_wls(a, lda, b, sbk, sbn, c, M, N, K, bk, s)
              : simt::launch_wls(a, lda, b, sbk, sbn, c, M, N, K, bk, s);
}

// The rows of the f32 M > 4 path's CTA tile at (M, N) on the current
// device, for wlbp (wlbp = 1) or base and wls (its columns are 64).
int rasa_sgemm_tile(int wlbp, int M, int N) {
  return wlbp ? simt::kWlbpRows : simt::tile_rows(M, N);
}

// The cluster size of an f32 M > 4 wlbp chunk `depth` deep, or 0 where the
// chunk is deeper than a cluster of 8 CTAs holds (rasa_ws_chunk refuses it).
int rasa_sgemm_wlbp_cluster(int M, int depth) { return simt::cluster_size(M, depth); }

const char* rasa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
