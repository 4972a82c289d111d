// Single-token GQA decode attention against a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py::decode_attention
// (body _decode_kernel). Same contract: q (B, H, D) one token; k/v
// (B, KV, S, D) given through strides, so the model's cache layout
// (B, S, KV, D) is read in place with no transpose; lengths (B,) int32; a
// runtime window (<= 0: full history). Position j of row b is valid iff
// j < min(len_b, S) and, when window > 0, j >= len_b - window. Scale
// D^-0.5, fp32 online softmax, output in q's dtype, 0 for a row with no
// valid key. Under GQA, q-head h reads kv-head h / (H / KV); heads are
// never broadcast in memory.
//
// Bound: decode is memory-bound. The work is ~4 flops per KV element
// against 2 bytes (bf16) of it, far below the H100's ~295 flops/byte
// ridge, so the floor is the valid KV bytes,
// B * KV * min(len, S) * D * 2 (k and v) * sizeof(T), at 3.35 TB/s.
//
// Design: the TPU kernel streams KV blocks through one program per
// (row, kv-head), B * KV programs in order; on a card with 132 SMs that
// leaves most SMs idle (8 blocks at B=4, KV=2). This kernel splits the
// key axis instead (split-K, "flash-decoding"):
//  1. decode_split_kernel: one block per (split, row, kv-head, head
//     chunk). It loads its query heads once (G of them, up to 16 per
//     chunk) into registers and streams its share of the valid keys. Each
//     key is read by LPK = D/4 lanes, 4 elements (8 or 16 bytes) each, and
//     scored against every head with a shuffle reduction, so one read of a
//     key serves the whole GQA group. Every lane group keeps its own
//     online-softmax state (m, l, acc); the groups of a warp merge by
//     shuffles, the warps of the block through shared memory, and the
//     block writes fp32 partials (m, l, acc) to scratch the wrapper
//     allocates. Splits wholly past the length or below the window run no
//     key loop and write an empty partial.
//  2. decode_merge_kernel: one block per (row, q-head) rescales and sums
//     the partials and writes the output.
// No tensor cores, TMA or wgmma yet: a right and simple kernel first.
//
// C interface for ctypes; launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kEPL = 4;  // elements per lane per key

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  float* part_m;
  float* part_l;
  float* part_acc;
  int B, H, KV, S, D, G, HC;
  long long q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int window;
  float scale;
  int num_splits;
  int split_size;
};

__device__ __forceinline__ void load4(const float* p, float (&x)[kEPL]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}

// bf16 -> fp32 is exact: the bf16 bits are the high half of the float.
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[kEPL]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  x[0] = __uint_as_float(t.x << 16);
  x[1] = __uint_as_float(t.x & 0xffff0000u);
  x[2] = __uint_as_float(t.y << 16);
  x[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even
}

// Weight of a partial with running max m under the merged max mn; an
// empty partial (m = -inf) weighs 0, also when mn is -inf.
__device__ __forceinline__ float rescale(float m, float mn) {
  return m == -INFINITY ? 0.f : expf(m - mn);
}

template <typename T, int LPK, int GM>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const Params p) {
  constexpr int D = LPK * kEPL;
  constexpr int KPW = 32 / LPK;  // keys a warp scores per step
  __shared__ float sm_m[kWarps][GM];
  __shared__ float sm_l[kWarps][GM];
  __shared__ float sm_acc[kWarps][GM][D];

  const int split = blockIdx.x;
  const int chunk = blockIdx.y % p.HC;
  const int kvh = (blockIdx.y / p.HC) % p.KV;
  const int b = blockIdx.y / (p.HC * p.KV);
  const int h0 = kvh * p.G + chunk * GM;  // first q-head of this block
  const int gn = min(GM, p.G - chunk * GM);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPK;
  const int d0 = (lane % LPK) * kEPL;

  const int len = p.lengths[b];
  const int hi = min(len, p.S);
  const int lo = p.window > 0 ? max(len - p.window, 0) : 0;
  const int start = max(lo, split * p.split_size);
  const int end = min(hi, (split + 1) * p.split_size);

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + d0;
  float qr[GM][kEPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < gn) {
      load4(q + (h0 + g) * p.q_sh, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < kEPL; ++e) qr[g][e] = 0.f;
    }
  }

  float m[GM], l[GM], acc[GM][kEPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kEPL; ++e) acc[g][e] = 0.f;
  }

  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh + d0;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh + d0;
  // The loop bound is uniform across the warp so every lane reaches the
  // shuffles; a lane group past `end` scores a zero key and skips the
  // update.
#pragma unroll 2
  for (int jb = start + warp * KPW; jb < end; jb += kWarps * KPW) {
    const int j = jb + grp;
    const bool ok = j < end;
    float kf[kEPL], vf[kEPL];
    if (ok) {
      load4(kb + j * p.k_ss, kf);
      load4(vb + j * p.v_ss, vf);
    } else {
#pragma unroll
      for (int e = 0; e < kEPL; ++e) kf[e] = vf[e] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < kEPL; ++e) s = fmaf(qr[g][e], kf[e], s);
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (ok) {
        s *= p.scale;
        const float mn = fmaxf(m[g], s);
        const float alpha = expf(m[g] - mn);  // m = -inf -> 0
        const float pr = expf(s - mn);
        l[g] = l[g] * alpha + pr;
#pragma unroll
        for (int e = 0; e < kEPL; ++e) acc[g][e] = fmaf(acc[g][e], alpha, pr * vf[e]);
        m[g] = mn;
      }
    }
  }

  // Merge the lane groups of this warp (each scored other keys).
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo2 = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float wa = rescale(m[g], mn), wb = rescale(mo, mn);
      l[g] = l[g] * wa + lo2 * wb;
#pragma unroll
      for (int e = 0; e < kEPL; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * wa + ao * wb;
      }
      m[g] = mn;
    }
  }

  if (lane < LPK) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int e = 0; e < kEPL; ++e) sm_acc[warp][g][d0 + e] = acc[g][e];
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // Merge the warps and write this split's partial for each head.
  for (int idx = threadIdx.x; idx < gn * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = rescale(sm_m[w][g], mx);
      lsum += sm_l[w][g] * wt;
      asum += sm_acc[w][g][d] * wt;
    }
    const long long o =
        (static_cast<long long>(b) * p.H + h0 + g) * p.num_splits + split;
    p.part_acc[o * D + d] = asum;
    if (d == 0) {
      p.part_m[o] = mx;
      p.part_l[o] = lsum;
    }
  }
}

template <typename T>
__global__ void decode_merge_kernel(const Params p) {
  const long long bh = blockIdx.x;  // b * H + h
  const float* pm = p.part_m + bh * p.num_splits;
  const float* pl = p.part_l + bh * p.num_splits;
  const float* pa = p.part_acc + bh * p.num_splits * p.D;
  float mx = -INFINITY;
  for (int s = 0; s < p.num_splits; ++s) mx = fmaxf(mx, pm[s]);
  T* out = static_cast<T*>(p.out) + bh * p.D;
  for (int d = threadIdx.x; d < p.D; d += blockDim.x) {
    float lsum = 0.f, asum = 0.f;
    for (int s = 0; s < p.num_splits; ++s) {
      const float wt = rescale(pm[s], mx);
      lsum += pl[s] * wt;
      asum += pa[s * p.D + d] * wt;
    }
    store1(out + d, lsum > 0.f ? asum / lsum : 0.f);
  }
}

template <typename T, int LPK, int GM>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.num_splits, p.B * p.KV * p.HC);
  decode_split_kernel<T, LPK, GM><<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T><<<p.B * p.H, p.D, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int LPK>
cudaError_t dispatch_heads(int gm, const Params& p, cudaStream_t stream) {
  switch (gm) {
    case 1: return launch<T, LPK, 1>(p, stream);
    case 2: return launch<T, LPK, 2>(p, stream);
    case 4: return launch<T, LPK, 4>(p, stream);
    case 8: return launch<T, LPK, 8>(p, stream);
    case 16: return launch<T, LPK, 16>(p, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_dim(int gm, const Params& p, cudaStream_t stream) {
  switch (p.D) {
    case 16: return dispatch_heads<T, 4>(gm, p, stream);
    case 64: return dispatch_heads<T, 16>(gm, p, stream);
    case 128: return dispatch_heads<T, 32>(gm, p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// axis of q, k and v must be contiguous and 4-element aligned.
extern "C" int decode_attention_forward(
    const void* q, const void* k, const void* v, const int* lengths,
    void* out, float* part_m, float* part_l, float* part_acc,
    int B, int H, int KV, int S, int D, int dtype,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    int window, float scale, int num_splits, int split_size, void* stream) {
  if (KV <= 0 || H % KV != 0 || num_splits <= 0 || split_size <= 0)
    return cudaErrorInvalidValue;
  Params p{q, k, v, lengths, out, part_m, part_l, part_acc,
           B, H, KV, S, D, H / KV, 0,
           q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           window, scale, num_splits, split_size};
  // Heads per block: the group size rounded up to a power of two, at
  // most 16; larger groups are cut into chunks of 16 (grid dimension y).
  int gm = 1;
  while (gm < p.G && gm < 16) gm <<= 1;
  p.HC = (p.G + gm - 1) / gm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_dim<float>(gm, p, s);
    case 1: return dispatch_dim<__nv_bfloat16>(gm, p, s);
  }
  return cudaErrorInvalidValue;
}
