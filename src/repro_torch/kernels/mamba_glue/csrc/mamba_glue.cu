// The Mamba-2 mixer's elementwise glue, forward only, for Hopper (sm_90a):
// two memory-bound kernels that read each input once and write each output
// once.
//
// Replaces no TPU kernel: the reference leaves this glue to XLA, which
// fuses it. The port's plain version (ref.py, the arithmetic of
// models/ssm.py) runs it as a chain of PyTorch elementwise passes, ~15 GB
// a Mamba-2 layer at zamba2-1.2b's forward shape (B = 8, S = 4096, d_inner
// 4096, N 64, H 64) where ~1.9 GB is the least, and took 55% of that
// forward on the card. These kernels replace the chain.
//
// conv_silu_dt_kernel. In: the conv input u = [x, B, C] (B, S, C), the
// raw dt (B, S, H), both column slices of the in_proj output read through
// their strides; conv_w (4, C), conv_b (C), dt_bias and A_log (H) float32.
// Out, in one pass: conv_out = silu(causal depthwise conv(u) + conv_b)
// (B, S, C); dA = softplus(dt + dt_bias) * -exp(A_log) (B, S, H) float32;
// xdt = conv_out[..., :d_in] * dt (B, S, d_in). A thread owns V channels
// (one 16-byte vector where the layout allows) and a tile of consecutive
// tokens of one batch row; the three inputs before the current token stay
// in registers, so the padded copy is gone: the tile's first token reads
// its three predecessors (zero before s = 0, as F.pad gives them), ~5%
// more reads at 64-token tiles. Tokens are loaded kUnroll at a time before
// any is computed, to keep loads in flight. dt's softplus is computed by
// each thread of a head (cheap); the head's first thread writes dA.
// Bound: bytes, u read and conv_out and xdt written once (~0.82 GB at the
// zamba2 shape, 245 us at 3.35 TB/s).
//
// gated_rms_norm_kernel. In: y (B, S, H, P) from the SSD scan, xh (a view
// of conv_out), z (the in_proj output's column slice), D (H), the norm's
// float32 gamma (d_in). Out: rmsnorm((y + D xh) * silu(z)) * (1 + gamma)
// (B, S, d_in), the input of out_proj. One block a row of d_in channels:
// each thread forms its vectors' gated values, keeps them in shared memory
// and sums their squares in float32; a warp-shuffle and block reduction
// gives the row's mean of squares; the threads then scale and store.
// Nothing between the skip and the output touches device memory. Bound:
// bytes, y, xh and z read and the output written once (~1.07 GB, 320 us).
//
// Rounding: each kernel rounds where the plain version does, so the
// outputs equal it. In the input dtype (bf16 or float32): the conv's four
// products and its adds in `sum`'s order ((0 + w0 u0) + w1 u1) + ..., the
// bias, SiLU (x / (1 + exp(-x)), as PyTorch computes it, in float32); dt
// in float32 (softplus with PyTorch's threshold 20), rounded to the input
// dtype before xdt's product; D xh, the skip's add, silu(z), the gate's
// product; the norm in float32, x rsqrt(mean + eps) (1 + gamma), cast
// once. PyTorch computes a bf16 product or sum in float32 and rounds it to
// bf16; float32's 24 bits are at least 2 x 8 + 2, so that double rounding
// equals one rounding of the exact result (Figueroa), which the card's
// bf16 instructions give (mul.rn.bf16, add.rn.bf16): the kernels use them,
// and convert to float32 only for SiLU, softplus and the norm (on the
// card a float-to-bf16 conversion issues at a quarter of the rate of an
// add; the first version rounded each step through float32 and took 4.4x
// its bound). Every product and add is explicitly rounded (__fmul_rn,
// __hmul_rn, ...), so nvcc contracts nothing into an FMA. What can differ:
// the float32 sum of squares' order (the reduction's), and the library's
// exp, log1p and rsqrt where PyTorch's build would differ from this one.
//
// Vector width V (elements, 16 bytes at most) is the wrapper's choice: the
// widest that divides the channel counts, the head dim and every row
// stride, and to which every base address is aligned; so an unaligned
// column slice takes narrower loads and is not refused.
//
// C interface for ctypes; launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kConv = 4;        // conv width
constexpr int kUnroll = 4;      // tokens loaded ahead in the conv kernel
constexpr int kConvThreads = 256;
constexpr int kNormThreads = 512;   // at most, a row's block

// An element type: its raw storage, widening to float, rounding a float
// to it, and its correctly rounded product and sum.
struct F32 {
  using raw = float;
  static __device__ __forceinline__ float wide(raw r) { return r; }
  static __device__ __forceinline__ raw narrow(float x) { return x; }
  static __device__ __forceinline__ raw mul(raw a, raw b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ raw add(raw a, raw b) {
    return __fadd_rn(a, b);
  }
};

struct BF16 {
  using raw = __nv_bfloat16;
  static __device__ __forceinline__ float wide(raw r) {
    return __bfloat162float(r);
  }
  static __device__ __forceinline__ raw narrow(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ raw mul(raw a, raw b) {
    return __hmul_rn(a, b);
  }
  static __device__ __forceinline__ raw add(raw a, raw b) {
    return __hadd_rn(a, b);
  }
};

template <int BYTES> struct Word;
template <> struct Word<16> { using T = uint4; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<4> { using T = unsigned int; };
template <> struct Word<2> { using T = unsigned short; };

// V elements at p (aligned to their size), in one load.
template <typename E, int V>
__device__ __forceinline__ void load_vec(const typename E::raw* p,
                                         typename E::raw (&out)[V]) {
  using W = typename Word<V * sizeof(typename E::raw)>::T;
  const W w = *reinterpret_cast<const W*>(p);
  memcpy(out, &w, sizeof(W));
}

// V elements stored at p in one store.
template <typename E, int V>
__device__ __forceinline__ void store_vec(typename E::raw* p,
                                          const typename E::raw (&in)[V]) {
  using W = typename Word<V * sizeof(typename E::raw)>::T;
  W w;
  memcpy(&w, in, sizeof(W));
  *reinterpret_cast<W*>(p) = w;
}

// V float32 values (gamma) at p, aligned to 4 V bytes, in 16-byte loads
// where V allows.
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&out)[V]) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      float4 q = *reinterpret_cast<const float4*>(p + i);
      out[i] = q.x; out[i + 1] = q.y; out[i + 2] = q.z; out[i + 3] = q.w;
    }
  } else {
    load_vec<F32, V>(p, out);
  }
}

template <typename E>
__device__ __forceinline__ typename E::raw zero() {
  return E::narrow(0.f);
}

// PyTorch's SiLU in float32: x / (1 + exp(-x)).
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
}

// PyTorch's softplus (beta 1, threshold 20) in float32.
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

// ---------------------------------------------------------------------------
// conv_silu_dt
// ---------------------------------------------------------------------------

struct ConvParams {
  const void* u;           // (B, S, C), strides u_sb, u_ss, 1
  const void* w;           // (4, C) contiguous
  const void* bias;        // (C,)
  const void* dt;          // (B, S, H), strides d_sb, d_ss, d_sh
  const float* dt_bias;    // (H,)
  const float* a_log;      // (H,)
  void* out;               // (B, S, C) contiguous
  float* da;               // (B, S, H) contiguous
  void* xdt;               // (B, S, d_in) contiguous
  int B, S, C, d_in, P, H, tile;
  long long u_sb, u_ss, d_sb, d_ss, d_sh;
};

template <typename E, int V>
__global__ void __launch_bounds__(kConvThreads)
conv_silu_dt_kernel(ConvParams p) {
  using raw = typename E::raw;
  const int ng = p.C / V;
  const int ntile = (p.S + p.tile - 1) / p.tile;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(p.B) * ntile * ng) return;
  const int g = static_cast<int>(idx % ng);
  const long long rest = idx / ng;
  const int t = static_cast<int>(rest % ntile);
  const int b = static_cast<int>(rest / ntile);
  const int c0 = g * V;
  const int s0 = t * p.tile;
  const int s1 = min(p.S, s0 + p.tile);

  const raw* u = static_cast<const raw*>(p.u) + b * p.u_sb + c0;
  raw* out = static_cast<raw*>(p.out) +
             (static_cast<long long>(b) * p.S) * p.C + c0;
  raw w[kConv][V], bias[V];
#pragma unroll
  for (int k = 0; k < kConv; ++k)
    load_vec<E, V>(static_cast<const raw*>(p.w) + k * p.C + c0, w[k]);
  load_vec<E, V>(static_cast<const raw*>(p.bias) + c0, bias);

  // the window's three earlier inputs: hist[0] is s - 3
  raw hist[kConv - 1][V];
#pragma unroll
  for (int k = 0; k < kConv - 1; ++k) {
    const int s = s0 - (kConv - 1) + k;
    if (s >= 0) {
      load_vec<E, V>(u + s * p.u_ss, hist[k]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) hist[k][i] = zero<E>();
    }
  }

  const bool is_x = c0 < p.d_in;
  const int head = is_x ? c0 / p.P : 0;
  const bool lead = is_x && c0 % p.P == 0;
  float dtb = 0.f, a = 0.f;
  const raw* dt = static_cast<const raw*>(p.dt) + b * p.d_sb + head * p.d_sh;
  if (is_x) {
    dtb = p.dt_bias[head];
    a = -expf(p.a_log[head]);
  }
  raw* xdt = static_cast<raw*>(p.xdt) +
             (static_cast<long long>(b) * p.S) * p.d_in + c0;
  float* da = p.da + (static_cast<long long>(b) * p.S) * p.H + head;

  for (int sb = s0; sb < s1; sb += kUnroll) {
    raw cur[kUnroll][V];
    raw dtraw[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int s = sb + k;
      if (s < s1) {
        load_vec<E, V>(u + s * p.u_ss, cur[k]);
        if (is_x) dtraw[k] = dt[s * p.d_ss];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int s = sb + k;
      if (s >= s1) break;
      raw o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        // sum(w[j] * pad[j + s]) from 0, each step rounded to E
        raw acc = E::add(zero<E>(), E::mul(w[0][i], hist[0][i]));
        acc = E::add(acc, E::mul(w[1][i], hist[1][i]));
        acc = E::add(acc, E::mul(w[2][i], hist[2][i]));
        acc = E::add(acc, E::mul(w[3][i], cur[k][i]));
        acc = E::add(acc, bias[i]);
        o[i] = E::narrow(silu(E::wide(acc)));
        hist[0][i] = hist[1][i];
        hist[1][i] = hist[2][i];
        hist[2][i] = cur[k][i];
      }
      store_vec<E, V>(out + static_cast<long long>(s) * p.C, o);
      if (is_x) {
        const float d = softplus(__fadd_rn(E::wide(dtraw[k]), dtb));
        if (lead) da[static_cast<long long>(s) * p.H] = __fmul_rn(d, a);
        const raw de = E::narrow(d);
        raw x[V];
#pragma unroll
        for (int i = 0; i < V; ++i) x[i] = E::mul(o[i], de);
        store_vec<E, V>(xdt + static_cast<long long>(s) * p.d_in, x);
      }
    }
  }
}

template <typename E, int V>
cudaError_t launch_conv(const ConvParams& p, cudaStream_t stream) {
  const long long ntile = (p.S + p.tile - 1) / p.tile;
  const long long threads = static_cast<long long>(p.B) * ntile * (p.C / V);
  const long long blocks = (threads + kConvThreads - 1) / kConvThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  conv_silu_dt_kernel<E, V><<<static_cast<unsigned>(blocks), kConvThreads,
                              0, stream>>>(p);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_conv_e(const ConvParams& p, int vec, cudaStream_t s) {
  switch (vec) {
    case 1: return launch_conv<E, 1>(p, s);
    case 2: return launch_conv<E, 2>(p, s);
    case 4: return launch_conv<E, 4>(p, s);
    case 8:
      if constexpr (sizeof(typename E::raw) == 2) return launch_conv<E, 8>(p, s);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// gated_rms_norm
// ---------------------------------------------------------------------------

struct NormParams {
  const void* y;           // (B, S, d_in) rows, strides y_sb, y_ss, 1
  const void* xh;          // the same, x_sb, x_ss
  const void* z;           // the same, z_sb, z_ss
  const void* d;           // (H,)
  const float* gamma;      // (d_in,)
  void* out;               // (B, S, d_in) contiguous
  int S, d_in, P;
  float eps, inv_n;
  long long y_sb, y_ss, x_sb, x_ss, z_sb, z_ss;
};

template <typename E, int V>
__global__ void __launch_bounds__(kNormThreads)
gated_rms_norm_kernel(NormParams p) {
  using raw = typename E::raw;
  extern __shared__ __align__(16) unsigned char norm_smem[];
  float* partial = reinterpret_cast<float*>(norm_smem);      // [32]
  raw* vals = reinterpret_cast<raw*>(norm_smem + 32 * sizeof(float));

  const int row = blockIdx.x;
  const int b = row / p.S, s = row % p.S;
  const raw* y = static_cast<const raw*>(p.y) + b * p.y_sb + s * p.y_ss;
  const raw* xh = static_cast<const raw*>(p.xh) + b * p.x_sb + s * p.x_ss;
  const raw* z = static_cast<const raw*>(p.z) + b * p.z_sb + s * p.z_ss;
  const raw* dvec = static_cast<const raw*>(p.d);
  const int nv = p.d_in / V;

  float sq = 0.f;
  for (int j = threadIdx.x; j < nv; j += blockDim.x) {
    const int c0 = j * V;
    raw yv[V], xv[V], zv[V], v[V];
    load_vec<E, V>(y + c0, yv);
    load_vec<E, V>(xh + c0, xv);
    load_vec<E, V>(z + c0, zv);
    const raw dh = dvec[c0 / p.P];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const raw skip = E::add(yv[i], E::mul(dh, xv[i]));
      v[i] = E::mul(skip, E::narrow(silu(E::wide(zv[i]))));
      const float f = E::wide(v[i]);
      sq = __fadd_rn(sq, __fmul_rn(f, f));
    }
    store_vec<E, V>(vals + c0, v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = sq;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    float t = lane < nw ? partial[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, off));
    if (lane == 0) partial[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(__fadd_rn(__fmul_rn(partial[0], p.inv_n), p.eps));

  raw* out = static_cast<raw*>(p.out) + static_cast<long long>(row) * p.d_in;
  for (int j = threadIdx.x; j < nv; j += blockDim.x) {
    const int c0 = j * V;
    raw v[V];
    float g[V];
    load_vec<E, V>(vals + c0, v);
    load_f32<V>(p.gamma + c0, g);
#pragma unroll
    for (int i = 0; i < V; ++i)
      v[i] = E::narrow(__fmul_rn(__fmul_rn(E::wide(v[i]), r),
                                 __fadd_rn(1.f, g[i])));
    store_vec<E, V>(out + c0, v);
  }
}

template <typename E, int V>
cudaError_t launch_norm(const NormParams& p, int rows, cudaStream_t stream) {
  const int nv = p.d_in / V;
  int threads = ((nv + 31) / 32) * 32;
  if (threads > kNormThreads) threads = kNormThreads;
  const size_t smem = 32 * sizeof(float) +
                      static_cast<size_t>(p.d_in) * sizeof(typename E::raw);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  gated_rms_norm_kernel<E, V><<<rows, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_norm_e(const NormParams& p, int rows, int vec,
                          cudaStream_t s) {
  switch (vec) {
    case 1: return launch_norm<E, 1>(p, rows, s);
    case 2: return launch_norm<E, 2>(p, rows, s);
    case 4: return launch_norm<E, 4>(p, rows, s);
    case 8:
      if constexpr (sizeof(typename E::raw) == 2)
        return launch_norm<E, 8>(p, rows, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int conv_silu_dt_forward(
    const void* u, const void* w, const void* bias, const void* dt,
    const void* dt_bias, const void* a_log, void* out, void* da, void* xdt,
    int B, int S, int C, int d_in, int P, int H, int tile, int vec, int dtype,
    long long u_sb, long long u_ss, long long d_sb, long long d_ss,
    long long d_sh, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || d_in <= 0 || d_in > C || P <= 0 ||
      H <= 0 || H * P != d_in || tile <= 0 || vec <= 0 || C % vec != 0 ||
      P % vec != 0)
    return cudaErrorInvalidValue;
  ConvParams p{u, w, bias, dt,
               static_cast<const float*>(dt_bias),
               static_cast<const float*>(a_log), out,
               static_cast<float*>(da), xdt, B, S, C, d_in, P, H, tile,
               u_sb, u_ss, d_sb, d_ss, d_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_conv_e<F32>(p, vec, s);
    case 1: return launch_conv_e<BF16>(p, vec, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int gated_rms_norm_forward(
    const void* y, const void* xh, const void* z, const void* d,
    const void* gamma, void* out, int B, int S, int d_in, int P, float eps,
    float inv_n, int vec, int dtype, long long y_sb, long long y_ss,
    long long x_sb, long long x_ss, long long z_sb, long long z_ss,
    void* stream) {
  if (B <= 0 || S <= 0 || d_in <= 0 || P <= 0 || d_in % P != 0 ||
      vec <= 0 || P % vec != 0 ||
      static_cast<long long>(B) * S > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  NormParams p{y, xh, z, d, static_cast<const float*>(gamma), out, S, d_in,
               P, eps, inv_n, y_sb, y_ss, x_sb, x_ss, z_sb, z_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_norm_e<F32>(p, B * S, vec, s);
    case 1: return launch_norm_e<BF16>(p, B * S, vec, s);
  }
  return cudaErrorInvalidValue;
}
