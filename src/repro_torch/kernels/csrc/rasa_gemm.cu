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
//   M <= 4 (decode): the M extent is 4, so no thread idles on padding
//         rows, and each CTA owns 16 columns.  One chain per output would
//         leave too few threads to keep HBM busy, so each chunk's k range
//         is split over 16 thread groups (sk_partial), and every chunk's B
//         block is loaded with 16-byte vector loads in one go; wls issues
//         the next chunk's loads before summing the current one.  With one
//         M tile, base and wlbp make the same traversal on this path.
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
// accumulator; fma_slab: a k-ascending fp32 FMA chain from 0; sk_partial:
// such chains over 16 contiguous pieces, added in a fixed pairwise tree),
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
// M <= 4.  One output per thread leaves too few threads to keep HBM busy, so
// here each chunk's k range is split over kSkS thread groups: group w runs
// the fp32 FMA chain over its own contiguous piece, from 0, and the pieces'
// sums are added in a fixed pairwise tree.  That order is the decode path's
// one order, shared by all schedules.  A CTA owns kSkTN columns; it loads
// the chunk's whole bk x kSkTN block of B at once with 16-byte loads along
// B's unit-stride axis (row-major weights or the transposed embedding).
// With a single M tile, base and wlbp make the same traversal here.

constexpr int kSkTM = 4, kSkTN = 16, kSkNT = 256, kSkS = kSkNT / kSkTN;

template <typename T>
__host__ __device__ constexpr int sk_vec() { return 16 / (int)sizeof(T); }
template <typename T>
__host__ __device__ constexpr int sk_pitch() { return kSkTN + sk_vec<T>(); }
__host__ __device__ inline int sk_rows(int bk) { return (bk + kSkS - 1) / kSkS * kSkS; }

template <typename T>
__host__ __device__ inline int sk_smem_bytes(int bk) {
  return sk_rows(bk) * 16                                  // A: float4 of 4 rows per k
         + sk_rows(bk) * sk_pitch<T>() * (int)sizeof(T)    // the B block
         + kSkS * kSkTM * kSkTN * 4;                       // the pieces' sums
}

// One chunk's A and B values in flight in registers: issued (sk_issue)
// before they are needed and stored to shared memory (sk_commit) after, so
// the output-stationary kernel overlaps the next chunk's loads with this
// chunk's arithmetic.  Each thread holds up to kBatch 16-byte units of B
// and kBatch values of A, which covers chunks of up to kSkMaxRows k.
constexpr int kSkMaxRows = 1024;

template <typename T>
struct SkStage {
  alignas(16) T b[kBatch][sk_vec<T>()];
  float a[kBatch];
};

// Unit u of this thread: row kk and column c of the block's B tile.  A unit
// is one 16-byte vector along B's unit-stride axis; for the transposed
// layout two neighbouring threads read one 32-byte sector.
template <typename T>
__device__ __forceinline__ void sk_unit(int idx, bool n_fast, int& kk, int& c) {
  constexpr int V = sk_vec<T>();
  if (n_fast) {
    kk = idx / (kSkTN / V);
    c = idx % (kSkTN / V) * V;
  } else {
    c = idx / 2 % kSkTN;
    kk = (idx % 2 + 2 * (idx / (2 * kSkTN))) * V;
  }
}

// Loads A[0:4, k0:k0+rows] and B[k0:k0+rows, n0:n0+TN] into st, zero
// outside rows < M, k < kend and n < N.
template <typename T>
__device__ __forceinline__ void sk_issue(SkStage<T>& st, const T* A, long long lda,
                                         const T* B, long long sbk, long long sbn, int M,
                                         int N, int n0, int k0, int kend, int rows,
                                         bool vec_ok) {
  constexpr int V = sk_vec<T>();
  const bool n_fast = (sbn == 1);
  const int units = rows * kSkTN / V;
  const T zero = from_f32<T>(0.f);
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int idx = threadIdx.x + u * kSkNT;
    if (idx >= units) continue;
    int kk, c;
    sk_unit<T>(idx, n_fast, kk, c);
    const int k = k0 + kk, n = n0 + c;
    const bool whole = n_fast ? (k < kend && n + V <= N) : (k + V <= kend && n < N);
    if (vec_ok && whole) {
      *reinterpret_cast<uint4*>(st.b[u]) =
          __ldg(reinterpret_cast<const uint4*>(B + k * sbk + n * sbn));
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int kj = n_fast ? k : k + j, nj = n_fast ? n + j : n;
        st.b[u][j] = (kj < kend && nj < N) ? B[kj * sbk + nj * sbn] : zero;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int idx = threadIdx.x + u * kSkNT;
    const int m = idx / rows, k = k0 + idx % rows;
    st.a[u] = (idx < rows * kSkTM && m < M && k < kend)
                  ? to_f32(A[(long long)m * lda + k]) : 0.f;
  }
}

// st -> As[kk * 4 + m] (a float4 of the 4 rows per k) and Bs[kk * pitch + c].
template <typename T>
__device__ __forceinline__ void sk_commit(const SkStage<T>& st, float* As, T* Bs,
                                          int rows, bool n_fast) {
  constexpr int V = sk_vec<T>(), P = sk_pitch<T>();
  const int units = rows * kSkTN / V;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int idx = threadIdx.x + u * kSkNT;
    if (idx >= units) continue;
    int kk, c;
    sk_unit<T>(idx, n_fast, kk, c);
    if (n_fast) {
      *reinterpret_cast<uint4*>(Bs + kk * P + c) = *reinterpret_cast<const uint4*>(st.b[u]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) Bs[(kk + j) * P + c] = st.b[u][j];
    }
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int idx = threadIdx.x + u * kSkNT;
    if (idx < rows * kSkTM) As[(idx % rows) * kSkTM + idx / rows] = st.a[u];
  }
}

// The decode path's shared routine, on a committed chunk: the partial of
// output (t / TN, n0 + t % TN), returned in thread t < TM * TN.  Group w
// runs the FMA chain over its piece of the chunk; the kSkS pieces' sums are
// added in a fixed pairwise tree.
template <typename T>
__device__ __forceinline__ float sk_partial(const float* As, const T* Bs, float* red,
                                            int rows) {
  const int c = threadIdx.x % kSkTN, w = threadIdx.x / kSkTN, len = rows / kSkS;
  float p[kSkTM] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int kk = w * len; kk < (w + 1) * len; ++kk) {
    const float4 a = reinterpret_cast<const float4*>(As)[kk];
    const float b = to_f32(Bs[kk * sk_pitch<T>() + c]);
    p[0] = __fmaf_rn(a.x, b, p[0]);
    p[1] = __fmaf_rn(a.y, b, p[1]);
    p[2] = __fmaf_rn(a.z, b, p[2]);
    p[3] = __fmaf_rn(a.w, b, p[3]);
  }
#pragma unroll
  for (int m = 0; m < kSkTM; ++m) red[(w * kSkTM + m) * kSkTN + c] = p[m];
  __syncthreads();
  float v[kSkS];
  v[0] = 0.f;
  if (threadIdx.x < kSkTM * kSkTN) {
#pragma unroll
    for (int s = 0; s < kSkS; ++s) v[s] = red[s * kSkTM * kSkTN + threadIdx.x];
#pragma unroll
    for (int step = 1; step < kSkS; step *= 2)
#pragma unroll
      for (int i = 0; i + step < kSkS; i += 2 * step) v[i] = __fadd_rn(v[i], v[i + step]);
  }
  return v[0];
}

// Shared-memory carve-up: A (float4 per k), the B block, the pieces' sums.
template <typename T>
struct SkSmem {
  float* As;
  T* Bs;
  float* red;
  __device__ SkSmem(unsigned char* smem, int rows)
      : As(reinterpret_cast<float*>(smem)),
        Bs(reinterpret_cast<T*>(smem + rows * 16)),
        red(reinterpret_cast<float*>(smem + rows * 16 + rows * sk_pitch<T>() * sizeof(T))) {}
};

template <typename T>
__global__ void __launch_bounds__(kSkNT)
sk_chunk_kernel(const T* A, long long lda, const T* B, long long sbk, long long sbn,
                float* Cm, int M, int N, int K, int k0, int bk, int vec_ok) {
  extern __shared__ __align__(16) unsigned char sk_smem[];
  const int rows = sk_rows(bk), n0 = blockIdx.x * kSkTN;
  SkSmem<T> sm(sk_smem, rows);
  SkStage<T> st;
  sk_issue(st, A, lda, B, sbk, sbn, M, N, n0, k0, min(k0 + bk, K), rows, vec_ok);
  sk_commit(st, sm.As, sm.Bs, rows, sbn == 1);
  __syncthreads();
  const float part = sk_partial(sm.As, sm.Bs, sm.red, rows);
  const int m = threadIdx.x / kSkTN, n = n0 + threadIdx.x % kSkTN;
  if (threadIdx.x < kSkTM * kSkTN && m < M && n < N) {
    float* c = Cm + (long long)m * N + n;
    *c = __fadd_rn(*c, part);  // C is updated in place
  }
}

template <typename T>
__global__ void __launch_bounds__(kSkNT)
sk_wls_kernel(const T* A, long long lda, const T* B, long long sbk, long long sbn,
              float* Cm, int M, int N, int K, int bk, int vec_ok) {
  extern __shared__ __align__(16) unsigned char sk_smem[];
  const int rows = sk_rows(bk), n0 = blockIdx.x * kSkTN;
  SkSmem<T> sm(sk_smem, rows);
  const int m = threadIdx.x / kSkTN, n = n0 + threadIdx.x % kSkTN;
  const bool mine = threadIdx.x < kSkTM * kSkTN && m < M && n < N;
  float acc = mine ? Cm[(long long)m * N + n] : 0.f;
  SkStage<T> st;
  sk_issue(st, A, lda, B, sbk, sbn, M, N, n0, 0, min(bk, K), rows, vec_ok);
  for (int k0 = 0; k0 < K; k0 += bk) {
    // the previous chunk's reads of As/Bs ended at sk_partial's barrier
    sk_commit(st, sm.As, sm.Bs, rows, sbn == 1);
    __syncthreads();
    if (k0 + bk < K)  // the next chunk's loads fly while this one is summed
      sk_issue(st, A, lda, B, sbk, sbn, M, N, n0, k0 + bk, min(k0 + 2 * bk, K), rows,
               vec_ok);
    acc = __fadd_rn(acc, sk_partial(sm.As, sm.Bs, sm.red, rows));
  }
  if (mine) Cm[(long long)m * N + n] = acc;
}

// Dynamic shared memory above 48 KB has to be allowed per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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

// Launches kernel with the given cluster size (0: none) and, with overlap,
// the programmatic dependent launch attribute; returns the launch's error.
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


// 16-byte vector loads of B need an aligned base, strides that keep every
// vector aligned along the unit-stride axis, and (along k) chunk starts on
// a vector boundary.
template <typename T>
int sk_vec_ok(const void* b, long long sbk, long long sbn, int bk) {
  const long long V = sk_vec<T>();
  if (reinterpret_cast<unsigned long long>(b) % 16 != 0) return 0;
  return sbn == 1 ? sbk % V == 0 : (sbk == 1 && sbn % V == 0 && bk % V == 0);
}

template <typename T>
int sk_launch(int wls_all, const void* a, long long lda, const void* b, long long sbk,
              long long sbn, float* c, int M, int N, int K, int k0, int bk,
              cudaStream_t stream) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  if (sk_rows(bk) > kSkMaxRows) return (int)cudaErrorInvalidValue;
  const int smem = sk_smem_bytes<T>(bk), grid = (N + kSkTN - 1) / kSkTN;
  const int vec_ok = sk_vec_ok<T>(b, sbk, sbn, bk);
  if (wls_all) {
    cudaError_t err = allow_smem(sk_wls_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    sk_wls_kernel<T><<<grid, kSkNT, smem, stream>>>(A, lda, B, sbk, sbn, c, M, N, K, bk,
                                                     vec_ok);
  } else {
    cudaError_t err = allow_smem(sk_chunk_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    sk_chunk_kernel<T><<<grid, kSkNT, smem, stream>>>(A, lda, B, sbk, sbn, c, M, N, K, k0,
                                                       bk, vec_ok);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One k-chunk [k0, k0 + bk) of C += A @ B for the base (wlbp = 0) or wlbp
// (wlbp = 1) schedule.  A: [M, K] bf16 (bf16 = 1) or f32, row stride lda,
// unit k stride.  B: [K, N] with strides (sbk, sbn).  C: [M, N] f32,
// contiguous, updated in place.  Returns cudaGetLastError() after launch.
int rasa_ws_chunk(int wlbp, int bf16, const void* a, long long lda, const void* b,
                  long long sbk, long long sbn, float* c, int M, int N, int K, int k0,
                  int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= kSkTM)
    return bf16 ? sk_launch<__nv_bfloat16>(0, a, lda, b, sbk, sbn, c, M, N, K, k0, bk, s)
                : sk_launch<float>(0, a, lda, b, sbk, sbn, c, M, N, K, k0, bk, s);
  return bf16 ? tc::launch_ws_chunk(wlbp, a, lda, b, sbk, sbn, c, M, N, K, k0, bk, s)
              : ws_chunk<kSquare, float>(wlbp, a, lda, b, sbk, sbn, c, M, N, K, k0, bk, s);
}

// All of C += A @ B, output-stationary, k-chunks of bk (same layouts).
int rasa_wls(int bf16, const void* a, long long lda, const void* b, long long sbk,
             long long sbn, float* c, int M, int N, int K, int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= kSkTM)
    return bf16 ? sk_launch<__nv_bfloat16>(1, a, lda, b, sbk, sbn, c, M, N, K, 0, bk, s)
                : sk_launch<float>(1, a, lda, b, sbk, sbn, c, M, N, K, 0, bk, s);
  return bf16 ? tc::launch_wls(a, lda, b, sbk, sbn, c, M, N, K, bk, s)
              : wls<kSquare, float>(a, lda, b, sbk, sbn, c, M, N, K, bk, s);
}

const char* rasa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
