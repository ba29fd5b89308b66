// RASA-scheduled GEMM for Hopper (sm_90a): C (+)= A @ B, fp32 accumulation.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/rasa_gemm.py:
//   rasa_ws_chunk<base>  <- _ws_call(schedule="base")  (body _accum_kernel)
//   rasa_ws_chunk<wlbp>  <- _ws_call(schedule="wlbp")  (body _accum_kernel)
//   rasa_wls             <- rasa_gemm(schedule="wls")  (body _scratch_kernel)
//
// What bounds it on this card.  At qwen3-1.7b decode (M = batch = 4) every
// step reads all ~3.44 GB of bf16 weights once, so the floor is the HBM
// rate: >= 1.03 ms per step at 3.35 TB/s.  At prefill (M = 512) it is the
// arithmetic: 2 * M * 1.41e9 flop of the layers' GEMMs at the 67 TFLOP/s
// fp32 SIMT peak, >= 21.5 ms.
//
// What the design does about it.  This is a simple, exact first version:
// SIMT fp32 FMA (no tensor cores: TF32 would break the reference's
// rel_err < 1e-5 for f32 inputs), operands staged through shared memory.
// The schedules keep their meaning:
//   base  one CTA per (M tile, N tile) for one k-chunk; each CTA loads its
//         own B slab, so B is re-read from HBM once per M tile.
//   wlbp  one CTA per N slab for one k-chunk; it loads its bk x TN block of
//         B into shared memory once and walks every M tile over it: B is
//         read from HBM once per chunk (the WLBP weight-load skip).
//   wls   output-stationary: one CTA per output tile keeps an fp32 register
//         accumulator seeded from C, walks all k-chunks, writes C once.
// Two tile paths, chosen by M alone:
//   M > 4 (prefill): 64 x 64 CTA tiles, 4 x 4 outputs per thread, one FMA
//         chain per output over each chunk (fma_slab); the next k-slab's
//         loads are issued before the current slab's arithmetic.
//   M <= 4 (decode): the M extent is 4, so no thread idles on padding
//         rows, and each CTA owns 16 columns.  One chain per output would
//         leave too few threads to keep HBM busy, so each chunk's k range
//         is split over 16 thread groups (sk_partial), and every chunk's B
//         block is loaded with 16-byte vector loads in one go; wls issues
//         the next chunk's loads before summing the current one.  With one
//         M tile, base and wlbp make the same traversal on this path.
//
// Numerics.  The three schedules are bit-identical.  On each path every
// output's partial sum over one k-chunk is formed in one fixed order by one
// shared routine (fma_slab: a k-ascending fp32 FMA chain from 0; sk_partial:
// such chains over 16 contiguous pieces, added in a fixed pairwise tree),
// and is then added to C with one rounded add, exactly as the reference's
// `c_in + dot` and `acc += dot`.
//
// No padding: the kernels mask the ragged edge (zero padding is exact), and
// take B's strides, so the tied LM head reads embedding.T without a copy.

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
using kSquare = Tile<64, 64, 4, 4, 16>;   // M > 4 (prefill); M <= 4 below

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
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&b)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  b[0] = lo.x; b[1] = lo.y; b[2] = hi.x; b[3] = hi.y;
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
    const int rows = (bk + C::KT - 1) / C::KT * C::KT;
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
  return bf16 ? ws_chunk<kSquare, __nv_bfloat16>(wlbp, a, lda, b, sbk, sbn, c, M, N, K, k0, bk, s)
              : ws_chunk<kSquare, float>(wlbp, a, lda, b, sbk, sbn, c, M, N, K, k0, bk, s);
}

// All of C += A @ B, output-stationary, k-chunks of bk (same layouts).
int rasa_wls(int bf16, const void* a, long long lda, const void* b, long long sbk,
             long long sbn, float* c, int M, int N, int K, int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= kSkTM)
    return bf16 ? sk_launch<__nv_bfloat16>(1, a, lda, b, sbk, sbn, c, M, N, K, 0, bk, s)
                : sk_launch<float>(1, a, lda, b, sbk, sbn, c, M, N, K, 0, bk, s);
  return bf16 ? wls<kSquare, __nv_bfloat16>(a, lda, b, sbk, sbn, c, M, N, K, bk, s)
              : wls<kSquare, float>(a, lda, b, sbk, sbn, c, M, N, K, bk, s);
}

const char* rasa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
