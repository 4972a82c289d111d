// Single-token GQA decode attention against a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py::decode_attention
// (body _decode_kernel). Same contract: q (B, H, D) one token; k/v
// (B, KV, S, D) given through strides, so the model's cache layout
// (B, S, KV, D) is read in place with no transpose; lengths (B,) int32; a
// runtime window (<= 0: full history). Position j of row b is valid iff
// j < min(len_b, S) and, when window > 0, j >= len_b - window. Scale
// D^-0.5, fp32 softmax state, output in q's dtype, 0 for a row with no
// valid key. Under GQA, q-head h reads kv-head h / (H / KV); heads are
// never broadcast in memory.
//
// Blocks of one cache: the cache given may be one block of a cache split
// on its positions (a rank's share of a sequence-sharded cache). Key j
// then holds position offset + j, and the visible keys in block
// coordinates are [max(len - window - offset, 0), min(len - offset, S)):
// clamping len to S alone would take a block that lies wholly below len
// as ending at S but put the window's lower edge in the wrong frame.
// With a non-null ``lse`` the kernel also writes each (row, head)'s
// running max m (natural log) and sum l, from which the blocks' outputs
// merge; where a row has no visible key, m = -inf and l = 0.
//
// Bound: decode is memory-bound. The work is ~4 flops per KV element
// against 2 bytes (bf16) of it, far below the H100's ~295 flops/byte
// ridge, so the floor is the valid KV bytes,
// B * KV * min(len, S) * D * 2 (k and v) * sizeof(T), at 3.35 TB/s. What
// reaches it is bytes in flight: ~25 KB per SM to cover HBM's latency.
//
// Design: the TPU kernel streams KV blocks through one program per
// (row, kv-head), B * KV programs in order; on a card with 132 SMs that
// leaves most SMs idle (8 blocks at B=4, KV=2). Here the key axis is split
// (split-K, "flash-decoding"): one block per (split, row, kv-head, chunk
// of up to 16 q-heads), and a merge pass when there is more than one
// split. Dispatch is by dtype and head dim:
//  - bfloat16, D = 64 and 128: decode_split_kernel_tc, a tensor-core tile
//    pipeline. Four warps stream 64-key tiles of K and V through a ring of
//    cp.async stages in shared memory (three at D = 128, four at D = 64),
//    one __syncthreads a tile, so up to two tiles (64 KB at D = 128) are
//    in flight behind the one being scored. The chunk's q-heads are the
//    16 rows of mma.sync m16n8k16 (the GQA group padded to 16: 12 for
//    starcoder2, 1 for zamba2; 24 and 48 in chunks of 16), so one read
//    of a key serves the whole group. Each warp scores its own 16 keys of
//    the tile (K fragments by ldmatrix), runs the online softmax once per
//    tile per head over them, and adds P V on the tensor cores (V by
//    ldmatrix.trans; P as two bf16 terms, hi + lo, which costs nothing
//    measurable in a bytes-bound kernel and keeps a float32 P's accuracy).
//    The four warps' states merge through shared memory at the end. The
//    wrapper's split plan gives about one block per SM; with one split
//    the block writes the output itself and no merge runs, otherwise it
//    writes a float32 partial (m, l, acc).
//    ptxas (CUDA 12.9, sm_90a): 221 registers at D = 128, 125 at D = 64,
//    no spills; dynamic shared memory 104,448 and 73,728 bytes.
//  - float32 (any D) and bfloat16 D = 16 (the CPU tests' widths):
//    decode_split_kernel on the CUDA cores, each key read by D/4 lanes
//    and scored against every head by a shuffle reduction, per-key online
//    softmax.
//  decode_merge_kernel: one block per (row, q-head) rescales and sums the
// partials and writes the output.
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
  float* lse_m;  // (B, H) m and l of the finished rows, or null
  float* lse_l;
  int B, H, KV, S, D, G, HC;
  long long q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int window;
  float scale;
  int num_splits;
  int split_size;
  int offset;  // position of key 0 of this block
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

  const int len = p.lengths[b] - p.offset;  // in block coordinates
  const int hi = min(max(len, 0), p.S);
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

// LSE: also write each row's (m, l). A separate instantiation, so that the
// default merge (no (m, l)) is the code it was: the store's possible
// aliasing of the partials measured +5% at the serve shape.
template <typename T, bool LSE>
__global__ void decode_merge_kernel(const Params p) {
  const long long bh = blockIdx.x;  // b * H + h
  const float* pm = p.part_m + bh * p.num_splits;
  const float* pl = p.part_l + bh * p.num_splits;
  const float* pa = p.part_acc + bh * p.num_splits * p.D;
  // unrolled so that the loads of several splits wait out one latency
  float mx = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < p.num_splits; ++s) mx = fmaxf(mx, pm[s]);
  T* out = static_cast<T*>(p.out) + bh * p.D;
  for (int d = threadIdx.x; d < p.D; d += blockDim.x) {
    float lsum = 0.f, asum = 0.f;
#pragma unroll 8
    for (int s = 0; s < p.num_splits; ++s) {
      const float wt = rescale(pm[s], mx);
      lsum += pl[s] * wt;
      asum += pa[s * p.D + d] * wt;
    }
    store1(out + d, lsum > 0.f ? asum / lsum : 0.f);
    if (LSE && d == 0) {
      p.lse_m[bh] = mx;
      p.lse_l[bh] = lsum;
    }
  }
}

template <typename T>
cudaError_t launch_merge(const Params& p, cudaStream_t stream) {
  if (p.lse_m != nullptr)
    decode_merge_kernel<T, true><<<p.B * p.H, p.D, 0, stream>>>(p);
  else
    decode_merge_kernel<T, false><<<p.B * p.H, p.D, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int LPK, int GM>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.num_splits, p.B * p.KV * p.HC);
  decode_split_kernel<T, LPK, GM><<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge<T>(p, stream);
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


// ---------------------------------------------------------------------------
// bfloat16, D = 64 and 128: tensor-core tile pipeline
// ---------------------------------------------------------------------------

constexpr int kTK = 64;          // keys per tile: 16 per warp
constexpr int kRows = 16;        // q-heads per block: mma.sync's M
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct TcCfg {
  static constexpr int kStages = D == 128 ? 3 : 4;
  static constexpr int kST = D + 8;  // row stride: ldmatrix conflict-free
  static constexpr int kSmem = kStages * 2 * kTK * kST * 2;
  static_assert(kWarps * kRows * D * 4 + 2 * kWarps * kRows * 4 <= kSmem,
                "the warps' states fit in the ring for the final merge");
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

// c += a (16x16, row) @ b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. ``trans`` transposes each matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// One 16-byte chunk global -> shared, asynchronously; ``bytes`` 0 reads
// nothing and zero-fills the chunk.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel_tc(const Params p) {
  using C = TcCfg<D>;
  constexpr int S = C::kStages;
  constexpr int ST = C::kST;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const ring = reinterpret_cast<__nv_bfloat16*>(smem);

  const int split = blockIdx.x;
  const int chunk = blockIdx.y % p.HC;
  const int kvh = (blockIdx.y / p.HC) % p.KV;
  const int b = blockIdx.y / (p.HC * p.KV);
  const int h0 = kvh * p.G + chunk * kRows;  // first q-head of this block
  const int gn = min(kRows, p.G - chunk * kRows);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group: heads h0 + g, h0 + g + 8
  const int t = lane % 4;
  const int lr = lane % 8;  // ldmatrix: matrix lane / 8, row lane % 8
  const int lm = lane / 8;

  const int len = p.lengths[b] - p.offset;  // in block coordinates
  const int hi = min(max(len, 0), p.S);
  const int lo = p.window > 0 ? max(len - p.window, 0) : 0;
  const int start = max(lo, split * p.split_size);
  const int end = min(hi, (split + 1) * p.split_size);
  const int n = end > start ? (end - start + kTK - 1) / kTK : 0;

  // Q as the A operand, loaded once: qf[ks] covers dims ks*16..+15 of
  // heads g and g + 8 (zero rows past the group).
  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb;
  const __nv_bfloat16* q0 = qb + (h0 + g) * p.q_sh;
  const __nv_bfloat16* q1 = qb + (h0 + g + 8) * p.q_sh;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + t * 2;
    qf[ks][0] = g < gn ? ld32(q0 + c) : 0u;
    qf[ks][1] = g + 8 < gn ? ld32(q1 + c) : 0u;
    qf[ks][2] = g < gn ? ld32(q0 + c + 8) : 0u;
    qf[ks][3] = g + 8 < gn ? ld32(q1 + c + 8) : 0u;
  }

  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  // Tile i (keys start + 64 i ..) into ring slot i % S, one cp.async
  // group; keys at or past ``end`` are zero-filled and never read.
  auto stage = [&](int i) {
    __nv_bfloat16* sK = ring + (i % S) * 2 * kTK * ST;
    __nv_bfloat16* sV = sK + kTK * ST;
    constexpr int CPR = D / 8;  // 16-byte chunks per row
    static_assert(kTK * CPR % kThreads == 0, "whole chunks per thread");
#pragma unroll
    for (int it = 0; it < kTK * CPR / kThreads; ++it) {
      const int idx = it * kThreads + threadIdx.x;
      const int row = idx / CPR;
      const int c8 = (idx % CPR) * 8;
      const int j = start + i * kTK + row;
      const bool in = j < end;
      const long long src = in ? j : start;
      cp_async16(&sK[row * ST + c8], kb + src * p.k_ss + c8, in ? 16 : 0);
      cp_async16(&sV[row * ST + c8], vb + src * p.v_ss + c8, in ? 16 : 0);
    }
  };

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n) stage(i);
    cp_async_commit();
  }

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 domain)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums
  const float sl2 = p.scale * kLog2e;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<S - 2>();  // tile i has landed (this thread's copies)
    __syncthreads();         // ... everyone's; and slot (i - 1) % S is free
    if (i + S - 1 < n) stage(i + S - 1);
    cp_async_commit();

    const __nv_bfloat16* sK = ring + (i % S) * 2 * kTK * ST + warp * 16 * ST;
    const __nv_bfloat16* sV = sK + kTK * ST;
    // Scores of the 16 heads against this warp's 16 keys: two 8-key
    // tiles; one ldmatrix.x4 gives two 16-dim steps of one.
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ks += 2) {
        uint32_t kf[4];
        ldsm_x4(kf, &sK[(nt * 8 + lr) * ST + ks * 16 + lm * 8]);
        mma_bf16(sc[nt], qf[ks], kf[0], kf[1]);
        mma_bf16(sc[nt], qf[ks + 1], kf[2], kf[3]);
      }
    }
    const int jw = start + i * kTK + warp * 16;
    if (jw + 16 > end) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (jw + nt * 8 + t * 2 + (e & 1) >= end) sc[nt][e] = -INFINITY;
    }
    float mx0 = fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1]));
    float mx1 = fmaxf(fmaxf(sc[0][2], sc[0][3]), fmaxf(sc[1][2], sc[1][3]));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0 * sl2);
    const float mn1 = fmaxf(m1, mx1 * sl2);
    // A row with nothing valid yet keeps m = -inf and weighs 0.
    const float a0 = mn0 == -INFINITY ? 1.f : exp2f(m0 - mn0);
    const float a1 = mn1 == -INFINITY ? 1.f : exp2f(m1 - mn1);
    const float nm0 = mn0 == -INFINITY ? 0.f : -mn0;
    const float nm1 = mn1 == -INFINITY ? 0.f : -mn1;
    float pr[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pr[nt][e] = exp2f(fmaf(sc[nt][e], sl2, e < 2 ? nm0 : nm1));
    l0 = l0 * a0 + pr[0][0] + pr[0][1] + pr[1][0] + pr[1][1];
    l1 = l1 * a1 + pr[0][2] + pr[0][3] + pr[1][2] + pr[1][3];
    m0 = mn0;
    m1 = mn1;
    // P as the A operand of one 16-key step, split into two bf16 terms.
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = pr[r / 2][(r % 2) * 2], y = pr[r / 2][(r % 2) * 2 + 1];
      const __nv_bfloat162 hb = __floats2bfloat162_rn(x, y);
      ph[r] = *reinterpret_cast<const uint32_t*>(&hb);
      pl[r] = pack_bf16(x - __bfloat162float(hb.x), y - __bfloat162float(hb.y));
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= a0;
      o[dt][1] *= a0;
      o[dt][2] *= a1;
      o[dt][3] *= a1;
    }
    // O += P V: one ldmatrix.x4.trans gives the B fragments of two 8-dim
    // tiles (keys {0, 8} + row, dims dt*8 + {0, 8}), read transposed.
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      uint32_t vf[4];
      ldsm_x4_trans(vf, &sV[((lm % 2) * 8 + lr) * ST + dt * 8 + (lm / 2) * 8]);
      mma_bf16(o[dt], ph, vf[0], vf[1]);
      mma_bf16(o[dt], pl, vf[0], vf[1]);
      mma_bf16(o[dt + 1], ph, vf[2], vf[3]);
      mma_bf16(o[dt + 1], pl, vf[2], vf[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' states now

  // Merge the four warps (each scored other keys of every tile).
  float* s_acc = reinterpret_cast<float*>(smem);        // [warp][row][D]
  float* s_m = s_acc + kWarps * kRows * D;              // [warp][row]
  float* s_l = s_m + kWarps * kRows;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float* a_lo = s_acc + (warp * kRows + g) * D;
  float* a_hi = a_lo + 8 * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    a_lo[c] = o[dt][0];
    a_lo[c + 1] = o[dt][1];
    a_hi[c] = o[dt][2];
    a_hi[c + 1] = o[dt][3];
  }
  if (t == 0) {
    s_m[warp * kRows + g] = m0;
    s_m[warp * kRows + g + 8] = m1;
    s_l[warp * kRows + g] = l0;
    s_l[warp * kRows + g + 8] = l1;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gn * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * kRows + r]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = s_m[w * kRows + r];
      const float wt = mw == -INFINITY ? 0.f : exp2f(mw - mx);
      lsum += s_l[w * kRows + r] * wt;
      asum += s_acc[(w * kRows + r) * D + d] * wt;
    }
    const long long bh = static_cast<long long>(b) * p.H + h0 + r;
    if (p.num_splits == 1) {
      store1(static_cast<__nv_bfloat16*>(p.out) + bh * D + d,
             lsum > 0.f ? asum / lsum : 0.f);
      if (d == 0 && p.lse_m != nullptr) {
        p.lse_m[bh] = mx == -INFINITY ? -INFINITY : mx * kLn2;
        p.lse_l[bh] = lsum;
      }
    } else {
      const long long o_ = bh * p.num_splits + split;
      p.part_acc[o_ * D + d] = asum;
      if (d == 0) {
        p.part_m[o_] = mx == -INFINITY ? -INFINITY : mx * kLn2;  // natural log
        p.part_l[o_] = lsum;
      }
    }
  }
}

template <int D>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  constexpr int smem = TcCfg<D>::kSmem;  // above 48 KB: opt in
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.num_splits, p.B * p.KV * p.HC);
  decode_split_kernel_tc<D><<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.num_splits == 1) return err;
  return launch_merge<__nv_bfloat16>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// axis of q, k and v must be contiguous; the bf16 D = 64/128 path copies
// 16-byte chunks (strides a multiple of 8 elements, 16-byte-aligned data).
// offset: the position of key 0 (0 for a whole cache); lse: null, or
// (2, B, H) float32 for m then l.
extern "C" int decode_attention_forward(
    const void* q, const void* k, const void* v, const int* lengths,
    void* out, float* part_m, float* part_l, float* part_acc,
    int B, int H, int KV, int S, int D, int dtype,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    int window, float scale, int num_splits, int split_size, int offset,
    float* lse, void* stream) {
  if (KV <= 0 || H % KV != 0 || num_splits <= 0 || split_size <= 0)
    return cudaErrorInvalidValue;
  Params p{q, k, v, lengths, out, part_m, part_l, part_acc,
           lse, lse == nullptr ? nullptr : lse + B * H,
           B, H, KV, S, D, H / KV, 0,
           q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           window, scale, num_splits, split_size, offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && (D == 64 || D == 128)) {
    p.HC = (p.G + kRows - 1) / kRows;  // chunks of 16 q-heads
    return D == 64 ? launch_tc<64>(p, s) : launch_tc<128>(p, s);
  }
  // CUDA cores: heads per block, the group size rounded up to a power of
  // two, at most 16; larger groups are cut into chunks of 16.
  int gm = 1;
  while (gm < p.G && gm < 16) gm <<= 1;
  p.HC = (p.G + gm - 1) / gm;
  if (dtype == 0) return dispatch_dim<float>(gm, p, s);
  if (dtype == 1 && D == 16) return dispatch_heads<__nv_bfloat16, 4>(gm, p, s);
  return cudaErrorInvalidValue;
}
