// Flash attention forward for Hopper (sm_90a): online softmax in fp32.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention_fwd  <- flash_attention (body _flash_kernel), reached
//                           through ops.flash_mha
//
// What it computes.  O[bh] = softmax(scale * Q[bh] K[kv]^T, masked) V[kv]
// with kv = bh / group (GQA without copying the kv heads).  The mask is
// top-left causal (row i sees columns j <= i) with the finite -1e30 of the
// reference; kv positions in [skv, skv_pad) are zero keys and zero values
// (the reference's zero padding to a multiple of block_kv, seen by every
// row the mask lets see them), and positions at or beyond skv_pad do not
// exist.  Running max, sum and accumulator are
// fp32; the output is acc / max(l, 1e-30) in Q's type.
//
// What bounds it on this card.  4 * D flop per (row, visible column) pair
// against (2 + 2 / group) * S * D elements moved.  For f32 inputs the
// operations over the 67 TFLOP/s fp32 peak bound it at every S the port
// drives; for bf16 inputs the card's peak is the tensor cores' 989 TFLOP/s,
// and the bytes bound it up to S near 1000 (chip_smoke.py reports
// both sides).  This kernel runs SIMT fp32 whatever the input type, so it
// sits far above the bf16 bound.
//
// What the design does about it.  This is a simple, exact first version,
// SIMT fp32 FMA (no tensor cores; the reference holds f32 inputs to
// rel_err < 1e-5, which TF32 would break).  One CTA of 256 threads per
// (bh, 64-row Q tile) walks the 64-column K/V tiles up to the diagonal;
// the TPU grid's sequential kv axis becomes this loop, since CTAs run in
// no order.  Q (pre-scaled), the K tile and the V tile are staged in shared
// memory as fp32; each thread owns a 4 x 4 block of the score tile and a
// 4-row x (D / 16)-column block of the accumulator, so both products reuse
// every shared-memory read 4 times.  Rows of a score tile are reduced
// with warp shuffles over the 16 threads that share them.  Tiles are
// issued heaviest first (the last Q tiles see the most K tiles).  Masked
// entries add exactly zero once a row has seen column 0, which is in its
// first tile, so the reference's block-skip rule changes no number and
// the kernel skips at its own tile granularity.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64, kBKV = 64, kThreads = 256;
constexpr int kMaxD = 256;
constexpr int kR = kBQ / 16;     // score / output rows per thread
constexpr int kC = kBKV / 16;    // score columns per thread
constexpr int kPPitch = kBKV + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Row pitch of the Q and K tiles: odd, so that the 16 rows a warp reads at
// one column fall into distinct banks.
__host__ __device__ inline int qk_pitch(int d) { return d | 1; }

__host__ inline size_t smem_bytes(int d) {
  return ((size_t)(kBQ + kBKV) * qk_pitch(d) + (size_t)kBKV * d + (size_t)kBQ * kPPitch) *
         sizeof(float);
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// NU: output columns per thread, d <= 16 * NU.  Thread (tr, tc) owns score
// entries (tr + 16 i, tc + 16 j) and output entries (tr + 16 i, tc + 16 u).
template <typename T, int NU>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                 T* __restrict__ O, int group, int sq, int skv, int skv_pad, int d,
                 float scale, int causal) {
  extern __shared__ float smem[];
  const int pitch = qk_pitch(d);
  float* Qs = smem;                    // [kBQ][pitch], q * scale
  float* Ks = Qs + kBQ * pitch;        // [kBKV][pitch]
  float* Vs = Ks + kBKV * pitch;       // [kBKV][d]
  float* Ps = Vs + kBKV * d;           // [kBQ][kPPitch], probabilities
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest tiles first
  const T* Qb = Q + (long long)bh * sq * d;
  const T* Kb = K + (long long)(bh / group) * skv * d;
  const T* Vb = V + (long long)(bh / group) * skv * d;

  for (int idx = threadIdx.x; idx < kBQ * d; idx += kThreads) {
    const int r = idx / d, c = idx % d, row = q0 + r;
    Qs[r * pitch + c] = row < sq ? to_f32(Qb[(long long)row * d + c]) * scale : 0.f;
  }

  float m[kR], l[kR], acc[kR][NU];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[i][u] = 0.f;
  }

  // columns at or beyond skv_pad do not exist; causal rows stop at the diagonal
  const int kv_end = causal ? min(skv_pad, min(q0 + kBQ, sq)) : skv_pad;
  for (int k0 = 0; k0 < kv_end; k0 += kBKV) {
    __syncthreads();   // the previous tile's reads of Ks, Vs and Ps are done
    for (int idx = threadIdx.x; idx < kBKV * d; idx += kThreads) {
      const int r = idx / d, c = idx % d, col = k0 + r;
      const bool real = col < skv;
      Ks[r * pitch + c] = real ? to_f32(Kb[(long long)col * d + c]) : 0.f;
      Vs[r * d + c] = real ? to_f32(Vb[(long long)col * d + c]) : 0.f;
    }
    __syncthreads();

    float s[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[kR], kv[kC];
#pragma unroll
      for (int i = 0; i < kR; ++i) qv[i] = Qs[(tr + 16 * i) * pitch + c];
#pragma unroll
      for (int j = 0; j < kC; ++j) kv[j] = Ks[(tc + 16 * j) * pitch + c];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online-softmax update of each of this thread's rows
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = q0 + tr + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int col = k0 + tc + 16 * j;
        if (col >= skv_pad || (causal && col > row)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < NU; ++u) acc[i][u] *= alpha;
#pragma unroll
      for (int j = 0; j < kC; ++j) Ps[(tr + 16 * i) * kPPitch + tc + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P V
#pragma unroll 2
    for (int j = 0; j < kBKV; ++j) {
      float pv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) pv[i] = Ps[(tr + 16 * i) * kPPitch + j];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int c = tc + 16 * u;
        if (c < d) {
          const float vv = Vs[j * d + c];
#pragma unroll
          for (int i = 0; i < kR; ++i) acc[i][u] = fmaf(pv[i], vv, acc[i][u]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = O + ((long long)bh * sq + row) * d;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int c = tc + 16 * u;
      if (c < d) orow[c] = from_f32<T>(acc[i][u] / li);
    }
  }
}

template <typename T, int NU>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int group, int sq,
           int skv, int skv_pad, int d, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  auto kernel = flash_fwd_kernel<T, NU>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), group, sq, skv, skv_pad, d, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh, int group, int sq,
             int skv, int skv_pad, int d, float scale, int causal, cudaStream_t s) {
  if (d <= 64) return launch<T, 4>(q, k, v, o, bh, group, sq, skv, skv_pad, d, scale, causal, s);
  if (d <= 128) return launch<T, 8>(q, k, v, o, bh, group, sq, skv, skv_pad, d, scale, causal, s);
  return launch<T, 16>(q, k, v, o, bh, group, sq, skv, skv_pad, d, scale, causal, s);
}

}  // namespace

extern "C" {

// O = attention(Q, K, V).  Q, O: [bh, sq, d]; K, V: [bh / group, skv, d];
// all contiguous, bf16 (bf16 = 1) or f32.  skv_pad >= skv is the padded kv
// extent.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it does not take.
int flash_attention_fwd(int bf16, const void* q, const void* k, const void* v, void* o,
                        int bh, int group, int sq, int skv, int skv_pad, int d, float scale,
                        int causal, void* stream) {
  if (d < 1 || d > kMaxD || bh < 1 || bh > 65535 || group < 1 || sq < 1 || skv < 1 ||
      skv_pad < skv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, bh, group, sq, skv, skv_pad, d, scale,
                                        causal, s)
              : dispatch<float>(q, k, v, o, bh, group, sq, skv, skv_pad, d, scale, causal, s);
}

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
