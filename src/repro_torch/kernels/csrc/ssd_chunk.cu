// Fused Mamba2 SSD chunk scan for Hopper (sm_90a), fp32 throughout.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_chunk.py:
//   ssd_chunk_fwd  <- ssd_chunk_fused (body _ssd_kernel)
//
// What it computes, per (bh) and chunk after chunk (q rows, seg = the
// within-chunk cumsum of dt * a):
//   y_i    = sum_{j<=i} (c_i . b_j) exp(seg_i - seg_j) (x_j dt_j)
//          + (c_i . state) exp(seg_i)                 state before the chunk
//   state  = state exp(seg_last) + sum_j b_j exp(seg_last - seg_j) (x_j dt_j)^T
// with the state [N, P] starting at zero; the final state is returned.
//
// What bounds it on this card.  Per chunk the arithmetic is q^2/2 (N + P)
// multiply-adds for the intra-chunk term plus 2 q N P for the inter-chunk
// term and the state update, against (2P + 2N + 1) q elements streamed:
// at mamba2-130m's N = 128, P = 64, q = 256 that is ~50 flop per byte of
// f32 (~100 of bf16), so for f32 inputs the operations over the 67 TFLOP/s fp32 peak bound
// it; for bf16 inputs the card's peak is the tensor cores' 989 TFLOP/s and
// the bytes bound it (chip_smoke.py reports both sides).
//
// What the design does about it.  A simple, exact first version:
// - One CTA per bh; the TPU grid's sequential chunk axis becomes a loop
//   inside the CTA (CTAs run in no order, so nothing could carry over
//   between them), and the running state [N, P] stays in shared memory in
//   fp32 (32 KB at N = 128, P = 64).
// - A chunk's [q, q] score block does not fit (256 KB of fp32 at q = 256,
//   against 227 KB of shared memory), so the intra-chunk term is tiled:
//   64-row tiles i of C and, for each, the 64-column tiles j <= i of B and
//   x dt, with one 64 x 64 score tile in shared memory at a time.  y for a
//   chunk takes the inter-chunk term from the state before the update.
// - Every product is a SIMT fp32 FMA chain (the reference holds f32 inputs
//   to 2e-5, which TF32 would break); each thread owns a 4 x 4 score block
//   and a 4-row block of y, so every shared-memory read is reused 4 times.
// - seg comes from a warp scan of dt * a in f64 (correctly rounded to f32);
//   dt arrives in f32 or x's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;               // row / column tile of the intra-chunk term
constexpr int kRA = kT / 16;         // tile rows per thread
constexpr int kWPitch = kT + 1;
constexpr int kMaxP = 128, kMaxN = 128, kMaxChunk = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ inline size_t smem_floats(int p, int n, int chunk) {
  return (size_t)n * p                  // state
         + 2 * (size_t)kT * (n + 1)     // C tile, B tile
         + (size_t)kT * p               // x dt tile
         + (size_t)kT * kWPitch         // score tile
         + 2 * (size_t)chunk;           // dt, seg
}

// seg[i] = sum_{k<=i} dts[k] * a over the chunk, by warp 0: each lane sums
// its run of the chunk, the lanes' totals are scanned with shuffles, then
// each lane writes its run from the prefix of the lanes before it.  The
// products are rounded to f32 and summed in f64, so seg is the correctly
// rounded f32 running sum (torch.cumsum accumulates f32 in f64 on the
// CPU; the plain version sums in f64).  exp(seg_i - seg_j) inherits seg's
// absolute error, and |seg| reaches hundreds at a real layer's decay rates.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float* seg, float a,
                                             int chunk) {
  const int lane = threadIdx.x, per = (chunk + 31) / 32;
  const int b0 = min(lane * per, chunk), b1 = min(b0 + per, chunk);
  double run = 0.0;
  for (int i = b0; i < b1; ++i) run += (double)__fmul_rn(dts[i], a);
  double tot = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, tot, o);
    if (lane >= o) tot += v;
  }
  double acc = __shfl_up_sync(0xffffffffu, tot, 1);   // the lanes before this one
  if (lane == 0) acc = 0.0;
  for (int i = b0; i < b1; ++i) {
    acc += (double)__fmul_rn(dts[i], a);
    seg[i] = (float)acc;
  }
}

// rows [r0, r0 + kT) of a [rows_total, width] matrix -> dst[r][k] (pitch),
// scaled per row by scale[r] when given, zero beyond rows_total.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* src, int width,
                                          int r0, int rows_total, const float* scale) {
  for (int idx = threadIdx.x; idx < kT * width; idx += kThreads) {
    const int r = idx / width, k = idx % width, row = r0 + r;
    float v = 0.f;
    if (row < rows_total) {
      v = to_f32(src[(long long)row * width + k]);
      if (scale) v *= scale[row];
    }
    dst[r * pitch + k] = v;
  }
}

// NA: state rows per thread (n <= 16 NA); NU: columns per thread (p <= 16 NU).
// Thread (tr, tc) owns tile entries (tr + 16 a, tc + 16 b), y entries
// (tr + 16 a, tc + 16 u) and state entries (tr + 16 a, tc + 16 u).
template <typename T, typename TD, int NA, int NU>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ X, const TD* __restrict__ DT,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, T* __restrict__ Y, float* __restrict__ Fin,
                 int s, int p, int n, int chunk) {
  extern __shared__ float smem[];
  const int np = n + 1;                 // odd for even n: conflict-free rows
  float* state = smem;                  // [n][p]
  float* Cs = state + n * p;            // [kT][np]
  float* Bs = Cs + kT * np;             // [kT][np]
  float* Xs = Bs + kT * np;             // [kT][p], x * dt
  float* Ws = Xs + kT * p;              // [kT][kWPitch], scores
  float* dts = Ws + kT * kWPitch;       // [chunk]
  float* seg = dts + chunk;             // [chunk]
  const int bh = blockIdx.x;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const float a = A[bh];
  X += (long long)bh * s * p;
  Y += (long long)bh * s * p;
  DT += (long long)bh * s;
  Bm += (long long)bh * s * n;
  Cm += (long long)bh * s * n;
  for (int idx = threadIdx.x; idx < n * p; idx += kThreads) state[idx] = 0.f;
  const int ntiles = (chunk + kT - 1) / kT;

  for (int c0 = 0; c0 < s; c0 += chunk) {
    const T* Xc = X + (long long)c0 * p;
    const T* Bc = Bm + (long long)c0 * n;
    const T* Cc = Cm + (long long)c0 * n;
    __syncthreads();   // the previous chunk's state update is complete
    for (int i = threadIdx.x; i < chunk; i += kThreads) dts[i] = to_f32(DT[c0 + i]);
    __syncthreads();
    if (threadIdx.x < 32) chunk_cumsum(dts, seg, a, chunk);
    __syncthreads();
    const float seg_last = seg[chunk - 1];

    // y, one 64-row tile of the chunk at a time, from the state before the update
    for (int ti = 0; ti < ntiles; ++ti) {
      const int i0 = ti * kT;
      __syncthreads();   // the previous row tile's reads of Cs are done
      load_tile(Cs, np, Cc, n, i0, chunk, (const float*)nullptr);
      float y[kRA][NU];
#pragma unroll
      for (int r = 0; r < kRA; ++r)
#pragma unroll
        for (int u = 0; u < NU; ++u) y[r][u] = 0.f;

      for (int tj = 0; tj <= ti; ++tj) {
        const int j0 = tj * kT;
        __syncthreads();   // the previous column tile's reads are done
        load_tile(Bs, np, Bc, n, j0, chunk, (const float*)nullptr);
        load_tile(Xs, p, Xc, p, j0, chunk, dts);
        __syncthreads();
        float w[kRA][kRA];
#pragma unroll
        for (int r = 0; r < kRA; ++r)
#pragma unroll
          for (int c = 0; c < kRA; ++c) w[r][c] = 0.f;
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          float cv[kRA], bv[kRA];
#pragma unroll
          for (int r = 0; r < kRA; ++r) cv[r] = Cs[(tr + 16 * r) * np + k];
#pragma unroll
          for (int c = 0; c < kRA; ++c) bv[c] = Bs[(tc + 16 * c) * np + k];
#pragma unroll
          for (int r = 0; r < kRA; ++r)
#pragma unroll
            for (int c = 0; c < kRA; ++c) w[r][c] = fmaf(cv[r], bv[c], w[r][c]);
        }
#pragma unroll
        for (int r = 0; r < kRA; ++r)
#pragma unroll
          for (int c = 0; c < kRA; ++c) {
            const int i = i0 + tr + 16 * r, j = j0 + tc + 16 * c;
            float v = 0.f;
            if (i < chunk && j < chunk) {
              const float diff = i >= j ? seg[i] - seg[j] : -1e30f;
              v = w[r][c] * expf(diff);
            }
            Ws[(tr + 16 * r) * kWPitch + tc + 16 * c] = v;
          }
        __syncthreads();
#pragma unroll 2
        for (int jj = 0; jj < kT; ++jj) {
          float wv[kRA];
#pragma unroll
          for (int r = 0; r < kRA; ++r) wv[r] = Ws[(tr + 16 * r) * kWPitch + jj];
#pragma unroll
          for (int u = 0; u < NU; ++u) {
            const int col = tc + 16 * u;
            if (col < p) {
              const float xv = Xs[jj * p + col];
#pragma unroll
              for (int r = 0; r < kRA; ++r) y[r][u] = fmaf(wv[r], xv, y[r][u]);
            }
          }
        }
      }

      // inter-chunk term, then y out
      float t[kRA][NU];
#pragma unroll
      for (int r = 0; r < kRA; ++r)
#pragma unroll
        for (int u = 0; u < NU; ++u) t[r][u] = 0.f;
#pragma unroll 2
      for (int k = 0; k < n; ++k) {
        float cv[kRA];
#pragma unroll
        for (int r = 0; r < kRA; ++r) cv[r] = Cs[(tr + 16 * r) * np + k];
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const int col = tc + 16 * u;
          if (col < p) {
            const float sv = state[k * p + col];
#pragma unroll
            for (int r = 0; r < kRA; ++r) t[r][u] = fmaf(cv[r], sv, t[r][u]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRA; ++r) {
        const int i = i0 + tr + 16 * r;
        if (i >= chunk) continue;
        const float e = expf(seg[i]);
        T* yrow = Y + (long long)(c0 + i) * p;
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const int col = tc + 16 * u;
          if (col < p) yrow[col] = from_f32<T>(y[r][u] + t[r][u] * e);
        }
      }
    }

    // state update: st_c = sum_j (b_j exp(seg_last - seg_j)) (x_j dt_j)^T
    float acc[NA][NU];
#pragma unroll
    for (int r = 0; r < NA; ++r)
#pragma unroll
      for (int u = 0; u < NU; ++u) acc[r][u] = 0.f;
    for (int tj = 0; tj < ntiles; ++tj) {
      const int j0 = tj * kT;
      __syncthreads();   // reads of Bs, Xs and (phase above) state are done
      for (int idx = threadIdx.x; idx < kT * n; idx += kThreads) {
        const int r = idx / n, k = idx % n, j = j0 + r;
        Bs[r * np + k] =
            j < chunk ? to_f32(Bc[(long long)j * n + k]) * expf(seg_last - seg[j]) : 0.f;
      }
      load_tile(Xs, p, Xc, p, j0, chunk, dts);
      __syncthreads();
#pragma unroll 2
      for (int jj = 0; jj < kT; ++jj) {
        float bv[NA];
#pragma unroll
        for (int r = 0; r < NA; ++r) {
          const int k = tr + 16 * r;
          bv[r] = k < n ? Bs[jj * np + k] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const int col = tc + 16 * u;
          if (col < p) {
            const float xv = Xs[jj * p + col];
#pragma unroll
            for (int r = 0; r < NA; ++r) acc[r][u] = fmaf(bv[r], xv, acc[r][u]);
          }
        }
      }
    }
    const float decay = expf(seg_last);
#pragma unroll
    for (int r = 0; r < NA; ++r) {
      const int k = tr + 16 * r;
      if (k >= n) continue;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int col = tc + 16 * u;
        if (col < p) state[k * p + col] = state[k * p + col] * decay + acc[r][u];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n * p; idx += kThreads)
    Fin[(long long)bh * n * p + idx] = state[idx];
}

template <typename T, typename TD, int NA, int NU>
int launch(const void* x, const void* dt, const float* a, const void* b, const void* c,
           void* y, float* fin, int bh, int s, int p, int n, int chunk, cudaStream_t stream) {
  const size_t smem = smem_floats(p, n, chunk) * sizeof(float);
  auto kernel = ssd_chunk_kernel<T, TD, NA, NU>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<bh, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const TD*>(dt), a, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), fin, s, p, n, chunk);
  return (int)cudaGetLastError();
}

template <typename T, typename TD>
int dispatch(const void* x, const void* dt, const float* a, const void* b, const void* c,
             void* y, float* fin, int bh, int s, int p, int n, int chunk, cudaStream_t st) {
  if (n <= 64)
    return p <= 64 ? launch<T, TD, 4, 4>(x, dt, a, b, c, y, fin, bh, s, p, n, chunk, st)
                   : launch<T, TD, 4, 8>(x, dt, a, b, c, y, fin, bh, s, p, n, chunk, st);
  return p <= 64 ? launch<T, TD, 8, 4>(x, dt, a, b, c, y, fin, bh, s, p, n, chunk, st)
                 : launch<T, TD, 8, 8>(x, dt, a, b, c, y, fin, bh, s, p, n, chunk, st);
}

}  // namespace

extern "C" {

// y, final state = SSD(x, dt, a, b, c).  x, y: [bh, s, p]; dt: [bh, s];
// a: [bh] f32; b, c: [bh, s, n]; fin: [bh, n, p] f32; all contiguous.
// x/b/c/y are bf16 (x_bf16 = 1) or f32; dt is bf16 (dt_bf16 = 1) or f32.
// s must be a multiple of chunk.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it does not take.
int ssd_chunk_fwd(int x_bf16, int dt_bf16, const void* x, const void* dt, const void* a,
                  const void* b, const void* c, void* y, void* fin, int bh, int s, int p,
                  int n, int chunk, void* stream) {
  if (bh < 1 || s < 1 || p < 1 || p > kMaxP || n < 1 || n > kMaxN || chunk < 1 ||
      chunk > kMaxChunk || s % chunk != 0 || (dt_bf16 && !x_bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float* f = static_cast<float*>(fin);
  if (!x_bf16) return dispatch<float, float>(x, dt, af, b, c, y, f, bh, s, p, n, chunk, st);
  if (dt_bf16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(x, dt, af, b, c, y, f, bh, s, p, n, chunk,
                                                  st);
  return dispatch<__nv_bfloat16, float>(x, dt, af, b, c, y, f, bh, s, p, n, chunk, st);
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
