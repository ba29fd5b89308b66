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
//   M > 4, f32: SIMT fp32 FMA (TF32 would break the reference's rel_err
//         < 1e-5 for f32 inputs).  64 x 64 CTA tiles, 4 x 4 outputs per
//         thread, one FMA chain per output over each chunk (fma_slab);
//         the next k-slab's loads are issued before the current slab's
//         arithmetic.
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
//         tiles are walked over it (the WLBP weight-load skip).  SIMT: one
//         CTA per N slab walks every M tile.  bf16: a cluster of G <= 8
//         CTAs along M shares the block: each loads 1/G of it, gathers the
//         rest from the others' shared memory, and walks its own M tiles.
//   wls   output-stationary: one CTA per output tile keeps an fp32 register
//         accumulator seeded from C, walks all k-chunks, writes C once.
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

template <int TM_, int TN_, int RM_, int RN_, int KT_>
struct Tile {
  static constexpr int TM = TM_, TN = TN_, RM = RM_, RN = RN_, KT = KT_;
  static constexpr int CM = TM / RM, CN = TN / RN;  // threads along M, N
  static constexpr int NT = CM * CN;                // threads per CTA
  static constexpr int LDA = TM + 4, LDB = TN + 4;  // smem pitches: 16-byte rows
  static constexpr int NA = TM * KT / NT, NB = KT * TN / NT;  // loads per thread
};
using kSquare = Tile<64, 64, 4, 4, 16>;   // M > 4, f32; bf16 and M <= 4 below

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename S> __device__ __forceinline__ S from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Loads are issued kBatch at a time into registers before any is stored,
// so each thread keeps kBatch global loads in flight.
constexpr int kBatch = 16;

// A slab [TM rows, KT] at (m0, ks) -> As[kk * LDA + r] as fp32, zero outside
// rows < M and k < kend.  Consecutive threads read consecutive k (wlbp).
template <class C, typename T>
__device__ __forceinline__ void load_a(float* As, const T* A, long long lda,
                                       int M, int m0, int ks, int kend) {
  constexpr int total = C::TM * C::KT;
  for (int base = threadIdx.x; base < total; base += C::NT * kBatch) {
    float r[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * C::NT;
      const int kk = idx % C::KT, m = m0 + idx / C::KT, k = ks + kk;
      r[u] = (idx < total && m < M && k < kend) ? to_f32(A[(long long)m * lda + k]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * C::NT;
      if (idx < total) As[(idx % C::KT) * C::LDA + idx / C::KT] = r[u];
    }
  }
}

// B block [rows, TN] at (ks, n0) -> Bs[kk * ldb + c] in type S, zero outside
// k < kend and n < N.  Threads walk B's unit-stride axis, so the loads are
// coalesced both for a row-major weight and for the transposed embedding.
template <class C, typename S, typename T>
__device__ __forceinline__ void load_b(S* Bs, int ldb, const T* B, long long sbk,
                                       long long sbn, int N, int n0, int ks,
                                       int kend, int rows) {
  const bool n_fast = (sbn == 1);
  const int total = rows * C::TN;
  for (int base = threadIdx.x; base < total; base += C::NT * kBatch) {
    float r[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * C::NT;
      const int kk = n_fast ? idx / C::TN : idx % rows;
      const int c = n_fast ? idx % C::TN : idx / rows;
      const int k = ks + kk, n = n0 + c;
      r[u] = (idx < total && k < kend && n < N) ? to_f32(B[k * sbk + n * sbn]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * C::NT;
      const int kk = n_fast ? idx / C::TN : idx % rows;
      const int c = n_fast ? idx % C::TN : idx / rows;
      if (idx < total) Bs[kk * ldb + c] = from_f32<S>(r[u]);
    }
  }
}

__device__ __forceinline__ void load4(const float* p, float (&b)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
}

// The one order every schedule shares on this path: for each of this
// thread's outputs (rows tr*4 + i, columns tc*4 + j of the tile),
// p = fma(a[k], b[k], p) for k ascending over one KT slab.
template <class C, typename S>
__device__ __forceinline__ void fma_slab(float (&p)[C::RM][C::RN], const float* As,
                                         const S* Bs, int ldb, int tr, int tc) {
  static_assert(C::RM == 4 && C::RN == 4, "4 x 4 outputs per thread");
#pragma unroll
  for (int kk = 0; kk < C::KT; ++kk) {
    float a[4], b[4];
    load4(As + kk * C::LDA + tr * 4, a);
    load4(Bs + kk * ldb + tc * 4, b);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = __fmaf_rn(a[i], b[j], p[i][j]);
  }
}

template <class C>
__device__ __forceinline__ void zero(float (&p)[C::RM][C::RN]) {
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RN; ++j) p[i][j] = 0.f;
}

// C[m, n] = C[m, n] + p, one rounded add per chunk (the `c_in + dot` step).
// C is updated in place: the wrapper owns the buffer.
template <class C>
__device__ __forceinline__ void fold_into_c(float* Cm, int M, int N, int m0, int n0,
                                            int tr, int tc,
                                            const float (&p)[C::RM][C::RN]) {
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RN; ++j) {
      const int m = m0 + tr * C::RM + i, n = n0 + tc * C::RN + j;
      if (m < M && n < N) {
        float* c = Cm + (long long)m * N + n;
        *c = __fadd_rn(*c, p[i][j]);
      }
    }
}

// One KT slab of A and B in flight in registers (issued before the
// previous slab's arithmetic, stored to shared memory after it).
template <class C>
struct SqStage {
  float a[C::NA], b[C::NB];
};

template <class C, typename T>
__device__ __forceinline__ void sq_issue(SqStage<C>& st, const T* A, long long lda,
                                         const T* B, long long sbk, long long sbn, int M,
                                         int N, int m0, int n0, int ks, int kend) {
  const bool n_fast = (sbn == 1);
#pragma unroll
  for (int u = 0; u < C::NA; ++u) {
    const int idx = threadIdx.x + u * C::NT;
    const int m = m0 + idx / C::KT, k = ks + idx % C::KT;
    st.a[u] = (m < M && k < kend) ? to_f32(A[(long long)m * lda + k]) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < C::NB; ++u) {
    const int idx = threadIdx.x + u * C::NT;
    const int kk = n_fast ? idx / C::TN : idx % C::KT;
    const int c = n_fast ? idx % C::TN : idx / C::KT;
    const int k = ks + kk, n = n0 + c;
    st.b[u] = (k < kend && n < N) ? to_f32(B[k * sbk + n * sbn]) : 0.f;
  }
}

template <class C>
__device__ __forceinline__ void sq_commit(const SqStage<C>& st, float* As, float* Bs,
                                          bool n_fast) {
#pragma unroll
  for (int u = 0; u < C::NA; ++u) {
    const int idx = threadIdx.x + u * C::NT;
    As[(idx % C::KT) * C::LDA + idx / C::KT] = st.a[u];
  }
#pragma unroll
  for (int u = 0; u < C::NB; ++u) {
    const int idx = threadIdx.x + u * C::NT;
    const int kk = n_fast ? idx / C::TN : idx % C::KT;
    const int c = n_fast ? idx % C::TN : idx / C::KT;
    Bs[kk * C::LDB + c] = st.b[u];
  }
}

// p = the chunk [k0, kend) partial of this thread's outputs, with A and B
// staged slab by slab, the next slab's loads in flight during the
// arithmetic (base and wls).
template <class C, typename T>
__device__ __forceinline__ void staged_chunk(float (&p)[C::RM][C::RN], float* As,
                                             float* Bs, const T* A, long long lda,
                                             const T* B, long long sbk, long long sbn,
                                             int M, int N, int m0, int n0, int k0,
                                             int kend, int tr, int tc) {
  zero<C>(p);
  SqStage<C> st;
  sq_issue<C>(st, A, lda, B, sbk, sbn, M, N, m0, n0, k0, kend);
  for (int ks = k0; ks < kend; ks += C::KT) {
    sq_commit<C>(st, As, Bs, sbn == 1);
    __syncthreads();
    if (ks + C::KT < kend)
      sq_issue<C>(st, A, lda, B, sbk, sbn, M, N, m0, n0, ks + C::KT, kend);
    fma_slab<C>(p, As, Bs, C::LDB, tr, tc);
    __syncthreads();
  }
}

template <class C>
__host__ __device__ constexpr int staged_smem_bytes() {
  return (C::KT * C::LDA + C::KT * C::LDB) * 4;
}

template <class C, typename T>
__global__ void __launch_bounds__(C::NT)
base_chunk_kernel(const T* A, long long lda, const T* B, long long sbk, long long sbn,
                  float* Cm, int M, int N, int K, int k0, int bk) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = smem + C::KT * C::LDA;
  const int tr = threadIdx.x / C::CN, tc = threadIdx.x % C::CN;
  const int n0 = blockIdx.x * C::TN, m0 = blockIdx.y * C::TM;
  float p[C::RM][C::RN];
  staged_chunk<C>(p, As, Bs, A, lda, B, sbk, sbn, M, N, m0, n0, k0, min(k0 + bk, K),
                  tr, tc);
  fold_into_c<C>(Cm, M, N, m0, n0, tr, tc, p);
}

template <class C, typename T>
__global__ void __launch_bounds__(C::NT)
wlbp_chunk_kernel(const T* A, long long lda, const T* B, long long sbk, long long sbn,
                  float* Cm, int M, int N, int K, int k0, int bk) {
  extern __shared__ float smem[];
  float* As = smem;
  T* Bblk = reinterpret_cast<T*>(smem + C::KT * C::LDA);
  constexpr int ldb = C::LDB;
  const int kend = min(k0 + bk, K);
  const int rows = (kend - k0 + C::KT - 1) / C::KT * C::KT;
  const int tr = threadIdx.x / C::CN, tc = threadIdx.x % C::CN;
  const int n0 = blockIdx.x * C::TN;
  // the chunk's one weight load: B stays resident for every M tile below
  load_b<C>(Bblk, ldb, B, sbk, sbn, N, n0, k0, kend, rows);
  for (int m0 = 0; m0 < M; m0 += C::TM) {
    float p[C::RM][C::RN];
    zero<C>(p);
    for (int ks = k0; ks < kend; ks += C::KT) {
      load_a<C>(As, A, lda, M, m0, ks, kend);
      __syncthreads();
      fma_slab<C>(p, As, Bblk + (ks - k0) * ldb, ldb, tr, tc);
      __syncthreads();
    }
    fold_into_c<C>(Cm, M, N, m0, n0, tr, tc, p);
  }
}

template <class C, typename T>
__global__ void __launch_bounds__(C::NT)
wls_kernel(const T* A, long long lda, const T* B, long long sbk, long long sbn,
           float* Cm, int M, int N, int K, int bk) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = smem + C::KT * C::LDA;
  const int tr = threadIdx.x / C::CN, tc = threadIdx.x % C::CN;
  const int n0 = blockIdx.x * C::TN, m0 = blockIdx.y * C::TM;
  float acc[C::RM][C::RN];
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RN; ++j) {
      const int m = m0 + tr * C::RM + i, n = n0 + tc * C::RN + j;
      acc[i][j] = (m < M && n < N) ? Cm[(long long)m * N + n] : 0.f;
    }
  for (int k0 = 0; k0 < K; k0 += bk) {
    float p[C::RM][C::RN];
    staged_chunk<C>(p, As, Bs, A, lda, B, sbk, sbn, M, N, m0, n0, k0,
                    min(k0 + bk, K), tr, tc);
#pragma unroll
    for (int i = 0; i < C::RM; ++i)
#pragma unroll
      for (int j = 0; j < C::RN; ++j) acc[i][j] = __fadd_rn(acc[i][j], p[i][j]);
  }
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RN; ++j) {
      const int m = m0 + tr * C::RM + i, n = n0 + tc * C::RN + j;
      if (m < M && n < N) Cm[(long long)m * N + n] = acc[i][j];
    }
}

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
// Both the tensor-core path and the decode path launch through it; the two
// attributes launch together (tc::wlbp_kernel's chained chunks use both).
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

template <class C, typename T>
int ws_chunk(int wlbp, const void* a, long long lda, const void* b, long long sbk,
             long long sbn, float* c, int M, int N, int K, int k0, int bk,
             cudaStream_t stream) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  const int nt = (N + C::TN - 1) / C::TN;
  if (wlbp) {
    // the block holds the chunk's real depth, as wlbp_chunk_kernel reads it
    const int depth = (long long)k0 + bk < K ? bk : K - k0;
    const int rows = (depth + C::KT - 1) / C::KT * C::KT;
    const int smem = C::KT * C::LDA * 4 + rows * C::LDB * (int)sizeof(T);
    auto kernel = wlbp_chunk_kernel<C, T>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<nt, C::NT, smem, stream>>>(A, lda, B, sbk, sbn, c, M, N, K, k0, bk);
  } else {
    const int smem = staged_smem_bytes<C>();
    auto kernel = base_chunk_kernel<C, T>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(nt, (M + C::TM - 1) / C::TM), C::NT, smem, stream>>>(
        A, lda, B, sbk, sbn, c, M, N, K, k0, bk);
  }
  return (int)cudaGetLastError();
}

template <class C, typename T>
int wls(const void* a, long long lda, const void* b, long long sbk, long long sbn,
        float* c, int M, int N, int K, int bk, cudaStream_t stream) {
  const int smem = staged_smem_bytes<C>();
  auto kernel = wls_kernel<C, T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((N + C::TN - 1) / C::TN, (M + C::TM - 1) / C::TM), C::NT, smem, stream>>>(
      static_cast<const T*>(a), lda, static_cast<const T*>(b), sbk, sbn, c, M, N, K, bk);
  return (int)cudaGetLastError();
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
              : ws_chunk<kSquare, float>(wlbp, a, lda, b, sbk, sbn, c, M, N, K, k0, bk, s);
}

// All of C += A @ B, output-stationary, k-chunks of bk (same layouts and
// c_init).
int rasa_wls(int bf16, const void* a, long long lda, const void* b, long long sbk,
             long long sbn, float* c, int M, int N, int K, int bk, int c_init, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 4) return dec::entry(bf16, a, lda, b, sbk, sbn, c, M, N, K, 0, bk, 1, c_init, s);
  return bf16 ? tc::launch_wls(a, lda, b, sbk, sbn, c, M, N, K, bk, s)
              : wls<kSquare, float>(a, lda, b, sbk, sbn, c, M, N, K, bk, s);
}

const char* rasa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
