// RWKV-6 (Finch) WKV recurrence, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6/kernel.py::
// rwkv6_scan (body _rwkv6_kernel). Same function, in the model's layout:
// r, k, v, w (B, S, H, D) float32 (w the per-step decay in (0, 1)), each
// given through strides with a contiguous last axis; the bonus u (H, D)
// and the optional initial state s0 (B, H, D, D) contiguous. Per head,
// with the state S (Dk, Dv) in float32:
//     o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
// o (B, S, H, D) float32 and the final state (B, H, D, D) float32, both
// allocated contiguous by the wrapper.
//
// Bound: at rwkv6-7b's forward shape (B=4, S=2048, H=64, D=64) the work
// is bytes: r, k, v, w read and o written once, 5 x 134 MB = 671 MB of
// float32, ~0.20 ms at 3.35 TB/s (the states are 4 MB each). The
// recurrence needs 5 flops per state entry per token (r^T S, and
// w * S + k v^T; the bonus term is O(D)), ~10.7 GFLOP, ~0.16 ms at the
// CUDA cores' 67 TFLOP/s; this kernel spends 7 (it forms k v^T and the
// bonus per entry), ~0.22 ms. (The model hands the kernel float32 casts
// of bf16 projections; reading the bf16 values is later work.)
//
// Design. The TPU kernel expands each chunk in pairwise log-decay space
// so that its matrix unit does the work, at the price of an (L, L, D)
// decay tensor, with every exponent <= 0 so that no data-dependent decay
// overflows. A GPU has no need of that: the recurrence is run token by
// token, exactly as defined, with the state in registers. It takes no
// exponential and no logarithm, so nothing can overflow or underflow
// beyond float32's own (a decay of exp(-e^4) ~ 1.9e-24 is a normal
// float), and it does not depend on any chunk length: a ragged S is the
// same loop. One block of 256 threads owns a (batch row, head); thread
// (g, j) holds state rows 16g..16g+15 of value column j in 16 registers.
// Tokens are staged 16 at a time in shared memory (r, k, w read as
// broadcasts, v by column), the four row groups' partial outputs are
// summed through shared memory, and each staged block costs two barriers.
// D up to 64 is zero-padded to 64 (padded rows stay 0).
//
// C interface for ctypes; launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // D is zero-padded to this
constexpr int kRows = 16;       // state rows per thread
constexpr int kGroups = kD / kRows;
constexpr int kThreads = kGroups * kD;
constexpr int kTok = 16;        // tokens staged per step (32 KB)

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  const float* s0;   // nullable: zero initial state
  float* o;
  float* sT;
  int B, S, H, D;
  long long r_sb, r_ss, r_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  long long o_sb, o_ss, o_sh;
};

__global__ void __launch_bounds__(kThreads) wkv_kernel(Params p) {
  __shared__ __align__(16) float R[kTok][kD];
  __shared__ __align__(16) float K[kTok][kD];
  __shared__ __align__(16) float W[kTok][kD];
  __shared__ float V[kTok][kD];
  __shared__ float Y[kTok][kGroups][kD];

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int tid = threadIdx.x;
  const int j = tid % kD;         // value column
  const int g = tid / kD;         // row group: rows g*kRows ..
  const int D = p.D;

  const float* rg = p.r + b * p.r_sb + h * p.r_sh;
  const float* kg = p.k + b * p.k_sb + h * p.k_sh;
  const float* vg = p.v + b * p.v_sb + h * p.v_sh;
  const float* wg = p.w + b * p.w_sb + h * p.w_sh;
  float* og = p.o + b * p.o_sb + h * p.o_sh;
  const long long sbase = (static_cast<long long>(b) * p.H + h) * D * D;

  float s[kRows], u[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = g * kRows + i;
    const bool in = row < D && j < D;
    s[i] = (in && p.s0) ? p.s0[sbase + row * D + j] : 0.f;
    u[i] = row < D ? p.u[h * D + row] : 0.f;
  }

  for (int t0 = 0; t0 < p.S; t0 += kTok) {
    const int nt = min(kTok, p.S - t0);
    for (int e = tid; e < kTok * kD; e += kThreads) {
      const int t = e / kD, d = e % kD;
      const bool in = t < nt && d < D;
      const long long tt = t0 + t;
      R[t][d] = in ? rg[tt * p.r_ss + d] : 0.f;
      K[t][d] = in ? kg[tt * p.k_ss + d] : 0.f;
      V[t][d] = in ? vg[tt * p.v_ss + d] : 0.f;
      W[t][d] = in ? wg[tt * p.w_ss + d] : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float vj = V[t][j];
      const float4* r4 = reinterpret_cast<const float4*>(&R[t][g * kRows]);
      const float4* k4 = reinterpret_cast<const float4*>(&K[t][g * kRows]);
      const float4* w4 = reinterpret_cast<const float4*>(&W[t][g * kRows]);
      float y = 0.f;
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q];
        const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          const float kvij = kv[e] * vj;
          y = fmaf(rv[e], fmaf(u[i], kvij, s[i]), y);
          s[i] = fmaf(wv[e], s[i], kvij);
        }
      }
      Y[t][g][j] = y;
    }
    __syncthreads();
    for (int e = tid; e < nt * kD; e += kThreads) {
      const int t = e / kD, d = e % kD;
      if (d < D) {
        float y = 0.f;
#pragma unroll
        for (int q = 0; q < kGroups; ++q) y += Y[t][q][d];
        og[(t0 + t) * p.o_ss + d] = y;
      }
    }
    // The next staging writes R, K, V, W only, which every thread has
    // finished reading (barrier above); Y is rewritten only after the
    // next staging's barrier, by which point these reads are done.
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = g * kRows + i;
    if (row < D && j < D) p.sT[sbase + row * D + j] = s[i];
  }
}

}  // namespace

// All tensors float32. Strides in elements, in the order (batch, sequence,
// head); the last axis of r, k, v, w and o must be contiguous. u (H, D),
// s0 and sT (B, H, D, D) contiguous; s0 may be null. D at most 64.
extern "C" int rwkv6_forward(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, void* o, void* sT,
    int B, int S, int H, int D,
    long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long w_sb, long long w_ss, long long w_sh,
    long long o_sb, long long o_ss, long long o_sh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > kD)
    return cudaErrorInvalidValue;
  Params p{static_cast<const float*>(r), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<const float*>(w),
           static_cast<const float*>(u), static_cast<const float*>(s0),
           static_cast<float*>(o), static_cast<float*>(sT),
           B, S, H, D,
           r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           w_sb, w_ss, w_sh, o_sb, o_ss, o_sh};
  wkv_kernel<<<B * H, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
