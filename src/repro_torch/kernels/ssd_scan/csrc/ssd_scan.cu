// Mamba-2 SSD chunked scan, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ssd_scan/kernel.py::ssd_scan (body _ssd_kernel). Same
// function, in the model's layout: xdt (B, S, H, P) = x * dt, the
// single-group B and C (B, S, N), dA (B, S, H) float32 <= 0, each given
// through strides with a contiguous last axis, so B and C are read as
// column slices of the causal convolution's output with no copy. Per head
// the recurrence is
//     state_t = exp(dA_t) state_{t-1} + B_t (x) xdt_t     ((N, P), float32)
//     y_t     = C_t . state_t
// from a zero state; y (B, S, H, P) in xdt's dtype (the wrapper allocates
// it contiguous). No final state is returned, as in the reference.
//
// Bound: at zamba2-1.2b's forward shape (B=4, S=2048, H=64, P=N=64, bf16)
// the work is bytes: xdt and y (2 x 67 MB), dA (2 MB) and B, C (2 MB)
// read or written once, ~138 MB against 3.35 TB/s, ~41 us. The chunked
// algorithm needs ~13 GFLOP when C B^T is formed once per chunk and shared
// by the heads (the TPU kernel's reuse of the B/C block), ~13 us at the
// bf16 tensor-core rate; this kernel forms it per head (~17 GFLOP) in
// float32 on the CUDA cores (67 TFLOP/s, ~0.25 ms), so the operations on
// the CUDA cores bound it, not the bytes.
//
// Design. The TPU kernel runs the chunk axis as the sequential grid axis
// with the (N, P) state in VMEM scratch. Blocks here run in parallel and
// in no order, so one block owns a (batch row, head) and loops over the
// chunks itself, the float32 state in shared memory for the whole
// sequence. The chunk length is the kernel's own (64 tokens), not the
// model's ssm_chunk: the function does not depend on it, and the last,
// ragged chunk is zero-padded (dA = 0, B = C = xdt = 0 past S), which
// leaves the state and the cumulative decay unchanged. N and P up to 64
// are zero-padded to 64. Per chunk, in float32 in shared memory:
//     cum   = cumsum(dA)                          (64,)   one thread, fp64
//     att   = tril(C B^T * exp(cum_i - cum_j))    (64, 64)
//     y     = att @ xdt + exp(cum) * (C @ state)  (64, P)
//     state = exp(cum_last) state + B^T (exp(cum_last - cum) * xdt)
// Every exponent is <= 0 (the mask is applied before the exponential), so
// nothing overflows for any dA <= 0. The cumulative decay is summed in
// float64: with fast decays it reaches ~-1000 within a chunk, and the
// float32 difference cum_i - cum_j of two such sums loses ~1e-4 of the
// exponent it needs (the reference's cumsum does, in float32). Each of
// the 256 threads computes a 4 x 4 tile of every 64 x 64 product (rows
// 4*ty.., columns tx + 16*c), with rows padded to 65 floats so the column
// reads are conflict-free.
// Later work, not here: tensor cores, and forming C B^T once per chunk
// for all heads (64x fewer operations for that term).
//
// C interface for ctypes; launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;        // tokens per chunk
constexpr int kT = 64;        // N and P are zero-padded to this
constexpr int kLd = kT + 1;   // padded row length of every tile
constexpr int kThreads = 256;
constexpr int kSmem =
    (4 * kQ * kLd + kT * kLd + 2 * kQ) * sizeof(float) + kQ * sizeof(double);

struct Params {
  const void* x;
  const void* b;
  const void* c;
  const float* da;
  void* y;
  int B, S, H, P, N;
  long long x_sb, x_ss, x_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long a_sb, a_ss, a_sh;
  long long y_sb, y_ss, y_sh;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Params p) {
  extern __shared__ float smem[];
  float* X = smem;                  // [kQ][kLd]  xdt of the chunk
  float* Bm = X + kQ * kLd;         // [kQ][kLd]  B
  float* Cm = Bm + kQ * kLd;        // [kQ][kLd]  C
  float* Att = Cm + kQ * kLd;       // [kQ][kLd]  masked, decayed C B^T
  float* St = Att + kQ * kLd;       // [kT][kLd]  state (N, P)
  float* wdec = St + kT * kLd;      // [kQ]       exp(cum_last - cum_j)
  float* ecum = wdec + kQ;          // [kQ]       exp(cum_i)
  double* cum = reinterpret_cast<double*>(ecum + kQ);  // [kQ] cumsum(dA)

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const T* bg = static_cast<const T*>(p.b) + b * p.b_sb;
  const T* cg = static_cast<const T*>(p.c) + b * p.c_sb;
  const float* ag = p.da + b * p.a_sb + h * p.a_sh;
  T* yg = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh;

  for (int e = tid; e < kT * kLd; e += kThreads) St[e] = 0.f;

  for (int s0 = 0; s0 < p.S; s0 += kQ) {
    const int q = min(kQ, p.S - s0);
    for (int e = tid; e < kQ * kT; e += kThreads) {
      const int i = e / kT, j = e % kT;
      const long long s = s0 + i;
      const bool in = i < q;
      X[i * kLd + j] = (in && j < p.P) ? to_f(xg[s * p.x_ss + j]) : 0.f;
      Bm[i * kLd + j] = (in && j < p.N) ? to_f(bg[s * p.b_ss + j]) : 0.f;
      Cm[i * kLd + j] = (in && j < p.N) ? to_f(cg[s * p.c_ss + j]) : 0.f;
    }
    if (tid < kQ) cum[tid] = tid < q ? ag[(s0 + tid) * p.a_ss] : 0.0;
    __syncthreads();
    if (tid == 0) {
      double run = 0.0;
      for (int i = 0; i < kQ; ++i) {
        run += cum[i];
        cum[i] = run;
      }
    }
    __syncthreads();
    const double last = cum[kQ - 1];  // padded tokens add 0
    if (tid < kQ) {
      wdec[tid] = expf(static_cast<float>(last - cum[tid]));
      ecum[tid] = expf(static_cast<float>(cum[tid]));
    }

    // att[i][j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i, else 0
    {
      float acc[4][4] = {};
#pragma unroll 8
      for (int k = 0; k < kT; ++k) {
        float a[4], bb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = Cm[(ty * 4 + r) * kLd + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) bb[c] = Bm[(tx + 16 * c) * kLd + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bb[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          Att[i * kLd + j] =
              j <= i ? acc[r][c] * expf(static_cast<float>(cum[i] - cum[j]))
                     : 0.f;
        }
      }
    }
    __syncthreads();

    // y = att @ xdt + exp(cum) * (C @ state)
    {
      float acc[4][4] = {}, inter[4][4] = {};
#pragma unroll 8
      for (int k = 0; k < kQ; ++k) {
        float a[4], xx[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = Att[(ty * 4 + r) * kLd + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) xx[c] = X[k * kLd + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], xx[c], acc[r][c]);
      }
#pragma unroll 8
      for (int k = 0; k < kT; ++k) {
        float a[4], ss[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = Cm[(ty * 4 + r) * kLd + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) ss[c] = St[k * kLd + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            inter[r][c] = fmaf(a[r], ss[c], inter[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r;
        if (i >= q) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pc = tx + 16 * c;
          if (pc < p.P)
            yg[(s0 + i) * p.y_ss + pc] =
                from_f<T>(acc[r][c] + ecum[i] * inter[r][c]);
        }
      }
    }
    __syncthreads();   // every thread has read the state before it changes

    // state = exp(cum_last) state + B^T (exp(cum_last - cum) * xdt)
    {
      float acc[4][4] = {};
#pragma unroll 8
      for (int j = 0; j < kQ; ++j) {
        const float w = wdec[j];
        float a[4], xx[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = Bm[j * kLd + ty * 4 + r] * w;
#pragma unroll
        for (int c = 0; c < 4; ++c) xx[c] = X[j * kLd + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], xx[c], acc[r][c]);
      }
      const float el = expf(static_cast<float>(last));
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* s = &St[(ty * 4 + r) * kLd + tx + 16 * c];
          *s = fmaf(el, *s, acc[r][c]);
        }
    }
    __syncthreads();   // before the next chunk overwrites the tiles
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T><<<p.B * p.H, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype (of xdt, B and C; y takes it too): 0 = float32, 1 = bfloat16. dA
// is float32. Strides are in elements: xdt and y (batch, sequence, head),
// B and C (batch, sequence), dA (batch, sequence, head); the last axis of
// every tensor must be contiguous. P and N at most 64.
extern "C" int ssd_scan_forward(
    const void* x, const void* b, const void* c, const void* da, void* y,
    int B, int S, int H, int P, int N, int dtype,
    long long x_sb, long long x_ss, long long x_sh,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long a_sb, long long a_ss, long long a_sh,
    long long y_sb, long long y_ss, long long y_sh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > kT || N <= 0 || N > kT)
    return cudaErrorInvalidValue;
  Params p{x, b, c, static_cast<const float*>(da), y, B, S, H, P, N,
           x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss, a_sb, a_ss, a_sh,
           y_sb, y_ss, y_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(p, s);
    case 1: return launch<__nv_bfloat16>(p, s);
  }
  return cudaErrorInvalidValue;
}
