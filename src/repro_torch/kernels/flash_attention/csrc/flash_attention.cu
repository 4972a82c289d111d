// Blocked online-softmax (flash) attention, forward only, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention (body
// _attn_kernel). Same contract, in the model's layout: q (B, Sq, H, D),
// k/v (B, Sk, KV, D), each given through strides with a contiguous last
// axis, so the projections' outputs are read in place with no transpose.
// Under GQA, q-head h reads kv-head h / (H / KV); heads are never
// broadcast in memory. Query and key positions both start at 0. Key j is
// visible to query i iff j < Sk, j <= i when causal, and j > i - window
// when the runtime window is > 0. Scale sm_scale, float32 running max, sum
// and accumulator; a row with no visible key gives exactly 0; output in
// q's dtype (the wrapper allocates it contiguous).
//
// Bound: at the shapes the model runs (S >= 1024, D = 64 or 128) the work
// is operations: 4 * D flops per visible (query, key) pair against
// (Sq + 2 Sk) * D * 2 bytes read once, ~1000 flops per byte for causal
// S = 2048, far above the H100's ~295 flops/byte bf16 ridge. So the floor
// is the bf16 tensor-core rate, 989 TFLOP/s; in float32 (no TF32) it is
// the 67 TFLOP/s of the CUDA cores.
//
// Design. The TPU kernel walks the key blocks of one (row, head, query
// block) sequentially on one core, carrying the softmax state in VMEM
// scratch. Here the key axis is a loop inside a block over key tiles
// staged in shared memory; the softmax state stays in registers. Key tiles
// wholly above the diagonal or below the window are never loaded (the
// loop bounds), as the TPU kernel's pl.when skips them; only tiles that
// the diagonal, the window or the ragged end cut pay for the element
// mask. The query tiles with the most keys under a causal mask are
// scheduled first. Dispatch is by dtype and head dim:
//  - bfloat16, D = 64 and 128: flash_fwd_wgmma, persistent and
//    warp-specialised: one block of 384 threads per SM walks work tiles
//    of 128 queries of one (head, batch row), longest first. Warpgroup 0
//    is the producer (setmaxnreg gives its registers away): one thread
//    issues every load with TMA, through 4-D tensor maps over the model
//    layout's (D, heads, S, B) strides, 128-byte swizzled: the work
//    tile's Q into one of two buffers (the next tile's Q loads while this
//    one finishes), then K and V tiles of 128 keys into a ring of stages
//    (two at D = 128, four at D = 64) that runs on across work tiles,
//    guarded by full/empty mbarrier pairs. Keys past Sk and queries past
//    Sq arrive as TMA's zero fill. Warpgroups 1 and 2 are consumers of 64
//    query rows each: S = Q K^T as wgmma m64n128k16 with both operands in
//    shared memory (K's row-major tile is K-major, as B wants); the online
//    softmax on S's fp32 accumulator fragment; O += P V as wgmma with P
//    from registers (S's accumulator fragment is, register for register,
//    the A fragment) and V's row-major tile read MN-major through the
//    transpose bit, so V is never transposed. The two consumers take
//    turns at the tensor cores (named barriers, FA3's ping-pong): each
//    issues P V of tile i and S of tile i + 1 back to back, then takes
//    the softmax of tile i + 1 while the other's products run.
//    What bounds it: the tensor cores, and the softmax between them. How
//    P enters P V (the route) is fixed per head dim at compile time, the
//    faster of the two on the card at that head dim (PERF.md §6 keeps the
//    other's times):
//      route 0, D = 128: P as two bf16 terms, hi + lo (~16 significant
//      bits, a float32 P's accuracy; one bf16 P misses the bound where
//      outputs are small), two P V products per 16 keys: 1.5x the tensor
//      work the bound counts;
//      route 1, D = 64: fp16 P against fp16 V. The producer's other three
//      warps convert each landed V tile in shared memory, scaled by the
//      power of two that puts the work tile's largest |V| so far in
//      [2^14, 2^15) (found from the tile's bf16 exponents): no overflow
//      past 65504, and exact for every value within 2^29 of the largest;
//      the consumers fold a change of that shift into O's rescale and
//      undo it at the end. At D = 128 the converters, not the tensor
//      cores, set the pace, so route 0 is the faster there.
//    ptxas (CUDA 12.9, sm_90a): 168 registers at entry (setmaxnreg:
//    consumers 240 at D = 128, 232 at D = 64; producer 24 / 40), no
//    spills, no stack; dynamic shared memory 197,752 bytes at D = 128,
//    165,072 at D = 64 (one block per SM).
//  - bfloat16, D = 16 (the CPU tests' widths only): flash_fwd_bf16, four
//    warps, 64 queries x 64 keys per tile, mma.sync m16n8k16 with P as
//    hi + lo, ldmatrix fragments and a two-buffer cp.async ring.
//  - float32: flash_fwd_f32, full float32 on the CUDA cores (tensor-core
//    float32 would be TF32). Four warps of four query rows, 32 keys per
//    tile, one key per lane for the scores, one output dimension per lane
//    (stride 32) for P @ V.
//
// The tensor maps are encoded on the host for every call with the
// driver's cuTensorMapEncodeTiled, reached through the runtime's
// cudaGetDriverEntryPoint (no -lcuda). TMA needs a 16-byte-aligned base
// and 16-byte-multiple strides: the wrapper checks both and raises.
//
// C interface for ctypes; launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after the launch (or an error
// code without launching when a tensor map cannot be made).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, Sq, Sk, H, KV, G;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  int window;
  float scale;
};

constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  return j < p.Sk && (!p.causal || j <= i) &&
         (p.window <= 0 || j > i - p.window);
}

// First key tile (a multiple of bk) and the key end for queries
// [q0, q0 + bq): nothing above the diagonal, nothing below the window.
__device__ __forceinline__ void key_range(const Params& p, int q0, int bq,
                                          int bk, int& k_lo, int& k_end) {
  k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q0 + bq);
  const int lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_lo = (lo / bk) * bk;
}

// ---------------------------------------------------------------------------
// bfloat16, D = 16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;  // queries per block: 4 warps x 16 rows
constexpr int kBK = 64;  // keys per tile

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

// Stage key tile [k0, k0 + kBK) of K and V into shared memory (row
// stride ST), as one cp.async group. Rows past Sk are zero-filled and
// never read (their source address is clamped to row 0).
template <int D, int ST>
__device__ __forceinline__ void stage_kv(__nv_bfloat16* sK, __nv_bfloat16* sV,
                                         const __nv_bfloat16* kb,
                                         const __nv_bfloat16* vb,
                                         const Params& p, int k0) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  static_assert(kBK * CPR % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < kBK * CPR / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int row = idx / CPR;
    const int c8 = (idx % CPR) * 8;
    const int j = k0 + row;
    const bool in = j < p.Sk;
    const int src = in ? j : 0;
    cp_async16(&sK[row * ST + c8], kb + src * p.k_ss + c8, in ? 16 : 0);
    cp_async16(&sV[row * ST + c8], vb + src * p.v_ss + c8, in ? 16 : 0);
  }
  cp_async_commit();
}

template <int D>
constexpr int bf16_smem_bytes() {
  return 2 * 2 * kBK * (D + 8) * 2;  // {K, V} x 2 buffers, bf16
}

// Whether every query of [q0, q0 + bq) sees every key of [k0, k0 + bk):
// such a tile needs no element mask.
__device__ __forceinline__ bool tile_full(const Params& p, int q0, int bq,
                                          int k0, int bk) {
  return k0 + bk <= p.Sk && (!p.causal || k0 + bk - 1 <= q0) &&
         (p.window <= 0 || k0 > q0 + bq - 1 - p.window);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(const Params p) {
  constexpr int ST = D + 8;     // K/V row stride (elements): the 8 rows an
                                // ldmatrix reads fall in distinct banks
  // Two buffers of K and V: the next tile loads while this one computes.
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const sbuf = reinterpret_cast<__nv_bfloat16*>(smem);

  // The last query tiles (the most keys under a causal mask) go first.
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / p.G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;

  // Q fragments (A operand), loaded once: qf[ks] covers dims ks*16..+15.
  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + t * 2;
    qf[ks][0] = r0 < p.Sq ? ld32(qb + r0 * p.q_ss + c) : 0u;
    qf[ks][1] = r1 < p.Sq ? ld32(qb + r1 * p.q_ss + c) : 0u;
    qf[ks][2] = r0 < p.Sq ? ld32(qb + r0 * p.q_ss + c + 8) : 0u;
    qf[ks][3] = r1 < p.Sq ? ld32(qb + r1 * p.q_ss + c + 8) : 0u;
  }

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 domain)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums

  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const float sl2 = p.scale * kLog2e;
  int k_lo, k_end;
  key_range(p, q0, kBQ, kBK, k_lo, k_end);
  // ldmatrix row addresses of this lane: matrix l / 8, row l % 8
  const int lr = lane % 8;
  const int lm = lane / 8;

  if (k_lo < k_end)
    stage_kv<D, ST>(sbuf, sbuf + kBK * ST, kb, vb, p, k_lo);
  for (int k0 = k_lo, buf = 0; k0 < k_end; k0 += kBK, buf ^= 1) {
    const __nv_bfloat16* sK = sbuf + buf * 2 * kBK * ST;
    const __nv_bfloat16* sV = sK + kBK * ST;
    if (k0 + kBK < k_end) {  // prefetch the next tile into the other buffer
      __nv_bfloat16* nK = sbuf + (buf ^ 1) * 2 * kBK * ST;
      stage_kv<D, ST>(nK, nK + kBK * ST, kb, vb, p, k0 + kBK);
      cp_async_wait<1>();    // this tile's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys. One
    // ldmatrix.x4 gives the B fragments of two 16-dim steps of one
    // 8-key tile: matrices (keys nt*8.., dims ks*16 + {0, 8, 16, 24}).
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ks += 2) {
        uint32_t kf[4];
        if (ks + 1 < D / 16) {
          ldsm_x4(kf, &sK[(nt * 8 + lr) * ST + ks * 16 + lm * 8]);
          mma_bf16(s[nt], qf[ks], kf[0], kf[1]);
          mma_bf16(s[nt], qf[ks + 1], kf[2], kf[3]);
        } else {  // D = 16: one step, matrices 2-3 repeat 0-1
          ldsm_x4(kf, &sK[(nt * 8 + lr) * ST + (lm % 2) * 8]);
          mma_bf16(s[nt], qf[ks], kf[0], kf[1]);
        }
      }
    }

    // Mask (only tiles the diagonal, the window or the ragged end cut),
    // scale into the log2 domain, and take the row maxima.
    const bool full = tile_full(p, q0, kBQ, k0, kBK);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? r0 : r1;
        const int j = k0 + nt * 8 + t * 2 + (e & 1);
        s[nt][e] = full || visible(p, i, j) ? s[nt][e] * sl2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // The four threads of a group hold the same two rows.
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    // A row with nothing visible yet keeps m = -inf and weighs 0.
    const float a0 = mn0 == -INFINITY ? 1.f : exp2f(m0 - mn0);
    const float a1 = mn1 == -INFINITY ? 1.f : exp2f(m1 - mn1);

    // P as the A operand of P @ V, split into two bf16 terms, P = hi + lo
    // (hi = bf16(P), lo = bf16(P - hi)): P keeps ~16 significant bits, so
    // the product is as exact as a float32 P would make it. One bf16
    // rounding of P would cost up to 2^-9 |v| per output, far more than
    // an output's own rounding where the output is small.
    uint32_t ph[kBK / 16][4], pl[kBK / 16][4];
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn0 : mn1;
        pr[e] = mn == -INFINITY ? 0.f : exp2f(s[nt][e] - mn);
      }
      ls0 += pr[0] + pr[1];
      ls1 += pr[2] + pr[3];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(pr[2 * half], pr[2 * half + 1]);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            pr[2 * half] - __bfloat162float(hi.x),
            pr[2 * half + 1] - __bfloat162float(hi.y));
        ph[nt / 2][(nt % 2) * 2 + half] =
            *reinterpret_cast<const uint32_t*>(&hi);
        pl[nt / 2][(nt % 2) * 2 + half] =
            *reinterpret_cast<const uint32_t*>(&lo);
      }
    }
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= a0;
      o[dt][1] *= a0;
      o[dt][2] *= a1;
      o[dt][3] *= a1;
    }
    // O += P V. One ldmatrix.x4.trans gives the B fragments of two 8-dim
    // tiles for one 16-key step: matrices (keys kk*16 + {0, 8},
    // dims dt*8 + {0, 8}), read transposed from row-major V.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, &sV[(kk * 16 + (lm % 2) * 8 + lr) * ST + dt * 8 +
                              (lm / 2) * 8]);
        mma_bf16(o[dt], ph[kk], vf[0], vf[1]);
        mma_bf16(o[dt], pl[kk], vf[0], vf[1]);
        mma_bf16(o[dt + 1], ph[kk], vf[2], vf[3]);
        mma_bf16(o[dt + 1], pl[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before refill
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* ob =
      static_cast<__nv_bfloat16*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (r0 < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * p.o_ss + c) =
          pack_bf16(o[dt][0] * inv0, o[dt][1] * inv0);
    if (r1 < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * p.o_ss + c) =
          pack_bf16(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, full float32
// ---------------------------------------------------------------------------

constexpr int kRPW = 4;            // query rows per warp
constexpr int kFQ = 4 * kRPW;      // queries per block
constexpr int kFK = 32;            // keys per tile: one per lane

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Params p) {
  constexpr int DPL = (D + 31) / 32;  // output dims per lane
  __shared__ float sQ[kFQ][D];
  __shared__ float sK[kFK][D + 1];    // +1: lanes read rows conflict-free
  __shared__ float sV[kFK][D];

  const int q0 = blockIdx.x * kFQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  for (int idx = threadIdx.x; idx < kFQ * D; idx += kThreads) {
    const int row = idx / D, d = idx % D;
    const int i = q0 + row;
    sQ[row][d] = i < p.Sq ? qb[i * p.q_ss + d] : 0.f;
  }

  float m[kRPW], l[kRPW], acc[kRPW][DPL];
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }

  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  int k_lo, k_end;
  key_range(p, q0, kFQ, kFK, k_lo, k_end);

  for (int k0 = k_lo; k0 < k_end; k0 += kFK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kFK * D; idx += kThreads) {
      const int row = idx / D, d = idx % D;
      const int j = k0 + row;
      const bool in = j < p.Sk;  // never read past the ragged end
      sK[row][d] = in ? kb[j * p.k_ss + d] : 0.f;
      sV[row][d] = in ? vb[j * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[kRPW];
#pragma unroll
    for (int r = 0; r < kRPW; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = sK[lane][d];
#pragma unroll
      for (int r = 0; r < kRPW; ++r)
        s[r] = fmaf(sQ[warp * kRPW + r][d], kd, s[r]);
    }

    const int j = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRPW; ++r) {
      const int i = q0 + warp * kRPW + r;
      const float sc = visible(p, i, j) ? s[r] * p.scale : -INFINITY;
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[r], mx);
      const float alpha = mn == -INFINITY ? 1.f : expf(m[r] - mn);
      const float pr = mn == -INFINITY ? 0.f : expf(sc - mn);
      float ps = pr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * alpha + ps;
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
      for (int jj = 0; jj < kFK; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, pr, jj);
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          acc[r][e] = fmaf(pj, sV[jj][(lane + 32 * e) % D], acc[r][e]);
      }
    }
  }

  float* ob = static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    const int i = q0 + warp * kRPW + r;
    if (i >= p.Sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) ob[i * p.o_ss + d] = acc[r][e] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16, D = 64 and 128: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kWBQ = 128;        // queries per work tile: two consumers x 64
constexpr int kWBK = 128;        // keys per tile
constexpr int kWThreads = 384;   // producer warpgroup + two consumers
constexpr int kSwz = 64;         // bf16 elements in a 128-byte swizzle row
constexpr int kConverters = 96;  // producer threads that convert V (route 1)
constexpr uint32_t kMaxSpins = 1u << 26;  // a lost barrier traps, not hangs
constexpr int kSmemMax = 232448;          // per block, opted in

template <int D>
struct WCfg {
  static constexpr int kHalves = D / kSwz;            // 128-byte columns
  static constexpr int kQBytes = kWBQ * D * 2;
  static constexpr int kTileBytes = kWBK * D * 2;       // K or V tile
  // as many stages as fit, at most four; + 1024: the base is rounded up
  // to the swizzle's 1024-byte period
  static constexpr int kFit =
      (kSmemMax - 1024 - 2 * kQBytes - 8 * 16 - 80) / (2 * kTileBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kBarOff = 2 * kQBytes + 2 * kStages * kTileBytes;
  // barriers, then per stage route 1's V shift and its converters' maxima
  static constexpr int kAuxOff = kBarOff + 8 * (4 + 3 * kStages);
  static constexpr int kSmem = 1024 + kAuxOff + 20 * kStages;
  static_assert(kStages >= 2 && kSmem <= kSmemMax, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of parity ``parity``.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins == kMaxSpins) __trap();
  }
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on ``bar``.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fffu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fffu) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from moving accesses of registers that an
// asynchronous wgmma reads or writes across its wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two bf16 -> two fp16 times sv (a power of two): exact wherever the
// product is in fp16's normal range.
__device__ __forceinline__ uint32_t bf16x2_to_f16x2(uint32_t x, float sv) {
  return pack_f16(__uint_as_float(x << 16) * sv,
                  __uint_as_float(x & 0xffff0000u) * sv);
}

// Route 1 converts a V tile as V 2^shift, with the shift that puts the
// work tile's max |V| so far in [2^14, 2^15): fp16 neither overflows
// (65504) nor loses the bits of values within 2^29 of the largest. From
// the bf16 bits of max |V| (exponent e): shift = 141 - e, at most 126; an
// all-zero tile sets no bound, an inf or NaN gives 0 (no shift).
__device__ __forceinline__ int v_shift_bound(uint32_t max_bits) {
  const int e = static_cast<int>(max_bits >> 7);
  if (max_bits == 0) return 126;
  if (e == 255) return 0;
  return min(126, 141 - e);
}

// 2^x as a float, for x in [-126, 127]: exact.
__device__ __forceinline__ float pow2(int x) {
  return __int_as_float((x + 127) << 23);
}

// d (m64n128, fp32) = A (64x16) . B^T (B 128x16) [+ d], A and B bf16 in
// shared memory, both K-major under the 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64n128, fp32) += A (64x16, bf16 in registers) . B (16x128), B bf16
// in shared memory, MN-major under the 128-byte swizzle (transpose bit).
__device__ __forceinline__ void wgmma_rs_n128_bf16(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n128, fp32) += A (64x16, f16 in registers) . B (16x128), B f16
// in shared memory, MN-major under the 128-byte swizzle (transpose bit).
__device__ __forceinline__ void wgmma_rs_n128_f16(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n64, fp32) += A (64x16, bf16 in registers) . B (16x64), B bf16
// in shared memory, MN-major under the 128-byte swizzle (transpose bit).
__device__ __forceinline__ void wgmma_rs_n64_bf16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n64, fp32) += A (64x16, f16 in registers) . B (16x64), B f16
// in shared memory, MN-major under the 128-byte swizzle (transpose bit).
__device__ __forceinline__ void wgmma_rs_n64_f16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <bool F16>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (F16) wgmma_rs_n128_f16(d, a, db);
  else wgmma_rs_n128_bf16(d, a, db);
}
template <bool F16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (F16) wgmma_rs_n64_f16(d, a, db);
  else wgmma_rs_n64_bf16(d, a, db);
}

// Named barriers 1 and 2 order the two consumer warpgroups' turns at the
// tensor cores (barrier 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// S = Q K^T for one consumer (64 rows) and one key tile: k-step ks reads
// 16 dims, 32 bytes into the 128-byte swizzle row of column block ks / 4.
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[kWBK / 2], uint32_t qa,
                                        uint32_t sK) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t col = (ks % 4) * 32;
    wgmma_ss_n128(sc, gmma_desc(qa + (ks / 4) * kWBQ * 128 + col, 16, 1024),
                  gmma_desc(sK + (ks / 4) * kWBK * 128 + col, 16, 1024),
                  ks > 0);
  }
}

// O += P V for one key tile: k-step kk reads keys 16 kk.. (two 8-key
// swizzle groups, SBO 1024 bytes) and all D columns (column blocks LBO
// apart), once per P term.
template <int D, bool kF16P>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[kWBK / 16][4],
                                         const uint32_t (&pb)[kWBK / 16][4],
                                         uint32_t sV) {
#pragma unroll
  for (int kk = 0; kk < kWBK / 16; ++kk) {
    const uint64_t dv = gmma_desc(sV + kk * 16 * 128, kWBK * 128, 1024);
    wgmma_rs<kF16P>(o, pa[kk], dv);
    if constexpr (!kF16P) wgmma_rs<false>(o, pb[kk], dv);
  }
}

// Online softmax of one tile's scores sc (64 rows x kWBK keys of this
// consumer; sc[4 jb + e] is row (e < 2 ? r0 : r1), key k0 + 8 jb + 2 t +
// (e & 1)): mask (only tiles the diagonal, the window or the ragged end
// cut), new row maxima m (log2 domain), rescale of O and of the row sums
// l, and P as the A fragments of P V, pa[kk] = keys 16 kk.. (route 0:
// pa = bf16(P), pb = bf16(P - pa); route 1: pa = fp16(P)). O also takes
// vf, route 1's change of V's shift.
template <int D, bool kF16P>
__device__ __forceinline__ void softmax_tile(
    const Params& p, float (&sc)[kWBK / 2], float (&o)[D / 2],
    uint32_t (&pa)[kWBK / 16][4], uint32_t (&pb)[kWBK / 16][4], float& m0,
    float& m1, float& l0, float& l1, int row0, int r0, int r1, int t,
    int k0, float sl2, float vf) {
  if (!tile_full(p, row0, 64, k0, kWBK)) {
#pragma unroll
    for (int jb = 0; jb < kWBK / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!visible(p, e < 2 ? r0 : r1, k0 + jb * 8 + t * 2 + (e & 1)))
          sc[4 * jb + e] = -INFINITY;
  }
  float x0[kWBK / 16], x1[kWBK / 16];  // pairwise: short dependency chains
#pragma unroll
  for (int j = 0; j < kWBK / 16; ++j) {
    x0[j] = fmaxf(fmaxf(sc[8 * j], sc[8 * j + 1]),
                  fmaxf(sc[8 * j + 4], sc[8 * j + 5]));
    x1[j] = fmaxf(fmaxf(sc[8 * j + 2], sc[8 * j + 3]),
                  fmaxf(sc[8 * j + 6], sc[8 * j + 7]));
  }
#pragma unroll
  for (int w = kWBK / 32; w > 0; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) {
      x0[j] = fmaxf(x0[j], x0[j + w]);
      x1[j] = fmaxf(x1[j], x1[j + w]);
    }
  float mx0 = x0[0], mx1 = x1[0];
  // the four threads of a quad hold the same two rows
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0 * sl2);
  const float mn1 = fmaxf(m1, mx1 * sl2);
  // A row with nothing visible yet keeps m = -inf and weighs 0.
  const float a0 = mn0 == -INFINITY ? 1.f : ex2(m0 - mn0);
  const float a1 = mn1 == -INFINITY ? 1.f : ex2(m1 - mn1);
  const float nm0 = mn0 == -INFINITY ? 0.f : -mn0;
  const float nm1 = mn1 == -INFINITY ? 0.f : -mn1;
#pragma unroll
  for (int e = 0; e < kWBK / 2; ++e)
    sc[e] = ex2(fmaf(sc[e], sl2, (e & 2) ? nm1 : nm0));
#pragma unroll
  for (int j = 0; j < kWBK / 16; ++j) {
    x0[j] = (sc[8 * j] + sc[8 * j + 1]) + (sc[8 * j + 4] + sc[8 * j + 5]);
    x1[j] = (sc[8 * j + 2] + sc[8 * j + 3]) + (sc[8 * j + 6] + sc[8 * j + 7]);
  }
#pragma unroll
  for (int w = kWBK / 32; w > 0; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) {
      x0[j] += x0[j + w];
      x1[j] += x1[j + w];
    }
  l0 = l0 * a0 + x0[0];
  l1 = l1 * a1 + x1[0];
  m0 = mn0;
  m1 = mn1;
  const float o0 = a0 * vf, o1 = a1 * vf;
#pragma unroll
  for (int jb = 0; jb < D / 8; ++jb) {
    o[4 * jb] *= o0;
    o[4 * jb + 1] *= o0;
    o[4 * jb + 2] *= o1;
    o[4 * jb + 3] *= o1;
  }
#pragma unroll
  for (int jb = 0; jb < kWBK / 8; ++jb)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int slot = (jb % 2) * 2 + half;
      const float x = sc[4 * jb + 2 * half], y = sc[4 * jb + 2 * half + 1];
      if constexpr (kF16P) {
        pa[jb / 2][slot] = pack_f16(x, y);
      } else {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
        pa[jb / 2][slot] = *reinterpret_cast<const uint32_t*>(&hi);
        pb[jb / 2][slot] = pack_bf16(x - __bfloat162float(hi.x),
                                     y - __bfloat162float(hi.y));
      }
    }
}

// The work tile w (128 queries of one head and batch row), longest first
// under a causal mask: query tile from the last, then head, then row.
__device__ __forceinline__ void work_tile(const Params& p, int w, int& q0,
                                          int& h, int& b) {
  const int n_qt = (p.Sq + kWBQ - 1) / kWBQ;
  const int hb = w % (p.H * p.B);
  q0 = (n_qt - 1 - w / (p.H * p.B)) * kWBQ;
  h = hb % p.H;
  b = hb / p.H;
}

// Persistent: block j takes work tiles j, j + gridDim.x, ... Shared memory
// (from a 1024-byte-aligned base): two Q buffers [halves][128 rows][64];
// per stage K then V, each [halves][kWBK keys][64], all 128-byte swizzled by
// TMA; then the barriers q_full[2], q_empty[2], full[stages],
// empty[stages], vready[stages] (route 1: V converted). The K/V ring runs
// on across work tiles; the producer loads the next tile's Q while the
// consumers finish this one.
template <int D, bool kF16P>
__global__ void __launch_bounds__(kWThreads, 1)
flash_fwd_wgmma(const __grid_constant__ Params p,
                const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv) {
  using C = WCfg<D>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;                      // buffer j at + j * kQBytes
  const uint32_t sKV = base + 2 * C::kQBytes;    // stage s: K, then V
  const uint32_t q_full0 = base + C::kBarOff;
  const uint32_t q_empty0 = q_full0 + 16;
  const uint32_t full0 = q_empty0 + 16;
  const uint32_t empty0 = full0 + 8 * S;
  const uint32_t vready0 = empty0 + 8 * S;
  // route 1: vshift[s], the shift V's tile in stage s was converted with;
  // vmax[s][w], converter warp w's max |V| bits
  int* const vshift =
      reinterpret_cast<int*>(smem_raw + (base - raw) + C::kAuxOff);
  uint32_t* const vmax = reinterpret_cast<uint32_t*>(vshift + S);
  const int total = (p.Sq + kWBQ - 1) / kWBQ * p.H * p.B;

  if (threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j) {
      mbar_init(q_full0 + 8 * j, 1);
      mbar_init(q_empty0 + 8 * j, 2 * 128);
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * 128);
      mbar_init(vready0 + 8 * s, kConverters);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup ----
    regs_dec<kF16P ? 40 : 24>();
    if (threadIdx.x == 0) {
      int it = 0;  // K/V tiles loaded so far
      for (int w = blockIdx.x, wi = 0; w < total; w += gridDim.x, ++wi) {
        int q0, h, b, k_lo, k_end;
        work_tile(p, w, q0, h, b);
        key_range(p, q0, kWBQ, kWBK, k_lo, k_end);
        const int ntiles = k_end > k_lo ? (k_end - k_lo + kWBK - 1) / kWBK : 0;
        const int kvh = h / p.G;
        const int j = wi % 2;
        mbar_wait(q_empty0 + 8 * j, ((wi / 2) & 1) ^ 1);
        mbar_expect_tx(q_full0 + 8 * j, C::kQBytes);
#pragma unroll
        for (int hf = 0; hf < C::kHalves; ++hf)
          tma_load_4d(sQ + j * C::kQBytes + hf * kWBQ * 128, &tq,
                      q_full0 + 8 * j, hf * kSwz, h, q0, b);
        for (int i = 0; i < ntiles; ++i, ++it) {
          const int s = it % S;
          const uint32_t sK = sKV + s * 2 * C::kTileBytes;
          const uint32_t sV = sK + C::kTileBytes;
          const int k0 = k_lo + i * kWBK;
          mbar_wait(empty0 + 8 * s, ((it / S) & 1) ^ 1);
          mbar_expect_tx(full0 + 8 * s, 2 * C::kTileBytes);
#pragma unroll
          for (int hf = 0; hf < C::kHalves; ++hf) {
            tma_load_4d(sK + hf * kWBK * 128, &tk, full0 + 8 * s, hf * kSwz,
                        kvh, k0, b);
            tma_load_4d(sV + hf * kWBK * 128, &tv, full0 + 8 * s, hf * kSwz,
                        kvh, k0, b);
          }
        }
      }
    } else if (kF16P && threadIdx.x >= 32) {
      // route 1: convert each landed V tile to fp16 in place (elementwise,
      // so the swizzle does not matter), scaled by the running shift
      const int t = threadIdx.x - 32;
      const int cwarp = t / 32;
      int it = 0;
      for (int w = blockIdx.x; w < total; w += gridDim.x) {
        int q0, h, b, k_lo, k_end;
        work_tile(p, w, q0, h, b);
        key_range(p, q0, kWBQ, kWBK, k_lo, k_end);
        const int ntiles = k_end > k_lo ? (k_end - k_lo + kWBK - 1) / kWBK : 0;
        int run = 126;  // the work tile's shift so far
        for (int i = 0; i < ntiles; ++i, ++it) {
          const int s = it % S;
          mbar_wait(full0 + 8 * s, (it / S) & 1);
          uint4* v = reinterpret_cast<uint4*>(
              smem_raw + (base - raw) + 2 * C::kQBytes +
              (2 * s + 1) * C::kTileBytes);
          uint32_t mx = 0;  // max |V| bits, in both bf16 halves
#pragma unroll 4
          for (int c = t; c < C::kTileBytes / 16; c += kConverters) {
            const uint4 x = v[c];
            mx = __vmaxu2(mx, x.x & 0x7fff7fffu);
            mx = __vmaxu2(mx, x.y & 0x7fff7fffu);
            mx = __vmaxu2(mx, x.z & 0x7fff7fffu);
            mx = __vmaxu2(mx, x.w & 0x7fff7fffu);
          }
          mx = __reduce_max_sync(0xffffffffu, max(mx & 0xffffu, mx >> 16));
          if (t % 32 == 0) vmax[4 * s + cwarp] = mx;
          asm volatile("bar.sync 3, %0;\n" :: "n"(kConverters) : "memory");
          mx = max(vmax[4 * s], max(vmax[4 * s + 1], vmax[4 * s + 2]));
          run = min(run, v_shift_bound(mx));
          const float sv = pow2(run);
#pragma unroll 4
          for (int c = t; c < C::kTileBytes / 16; c += kConverters) {
            uint4 x = v[c];
            x.x = bf16x2_to_f16x2(x.x, sv);
            x.y = bf16x2_to_f16x2(x.y, sv);
            x.z = bf16x2_to_f16x2(x.z, sv);
            x.w = bf16x2_to_f16x2(x.w, sv);
            v[c] = x;
          }
          if (t == 0) vshift[s] = run;
          // generic-proxy writes, read next by wgmma (the async proxy)
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(vready0 + 8 * s);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    regs_inc<kF16P ? 232 : 240>();
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int t = lane % 4;
    const float sl2 = p.scale * kLog2e;
    const int mine = 1 + cw, other = 2 - cw;     // named barriers

    float o[D / 2];
    float sc[kWBK / 2];                    // S, then P in float32
    uint32_t pa[kWBK / 16][4], pb[kWBK / 16][4];

    // Each warpgroup issues its products in turns (FA3's ping-pong):
    // P V of tile i and S of tile i + 1 back to back, then the other
    // warpgroup's, while this one takes the softmax of tile i + 1. A
    // stage is released when its P V has completed.
    if (cw == 1) bar_arrive(other);  // warpgroup 1 takes the first turn
    int it = 0;  // K/V tiles consumed so far
    for (int w = blockIdx.x, wi = 0; w < total; w += gridDim.x, ++wi) {
      int q0, h, b, k_lo, k_end;
      work_tile(p, w, q0, h, b);
      key_range(p, q0, kWBQ, kWBK, k_lo, k_end);
      const int ntiles = k_end > k_lo ? (k_end - k_lo + kWBK - 1) / kWBK : 0;
      const bool last = w + static_cast<int>(gridDim.x) >= total;
      const int row0 = q0 + cw * 64;
      const int r0 = row0 + warp * 16 + lane / 4;  // fragment rows r0, r0 + 8
      const int r1 = r0 + 8;
      const int j = wi % 2;
      const uint32_t qa = sQ + j * C::kQBytes + cw * 64 * 128;
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 domain)
      float l0 = 0.f, l1 = 0.f;  // this thread's share of the sums
      int shift = 0;             // route 1: the shift of V in O

      mbar_wait(q_full0 + 8 * j, (wi / 2) & 1);
      if (ntiles > 0) {
        bar_sync(mine);
        mbar_wait(full0 + 8 * (it % S), (it / S) & 1);
        wgmma_fence();
        issue_s<D>(sc, qa, sKV + (it % S) * 2 * C::kTileBytes);
        wgmma_commit();
        bar_arrive(other);
        wgmma_wait_all();
        reg_fence(sc);
        if constexpr (kF16P) {
          mbar_wait(vready0 + 8 * (it % S), (it / S) & 1);
          shift = vshift[it % S];
        }
        softmax_tile<D, kF16P>(p, sc, o, pa, pb, m0, m1, l0, l1, row0,
                                     r0, r1, t, k_lo, sl2, 1.f);
        for (int i = 0; i + 1 < ntiles; ++i, ++it) {
          const int s = it % S, s1 = (it + 1) % S;
          bar_sync(mine);
          mbar_wait(full0 + 8 * s1, ((it + 1) / S) & 1);
          wgmma_fence();
          issue_pv<D, kF16P>(
              o, pa, pb, sKV + s * 2 * C::kTileBytes + C::kTileBytes);
          issue_s<D>(sc, qa, sKV + s1 * 2 * C::kTileBytes);
          wgmma_commit();
          bar_arrive(other);
          wgmma_wait_all();
          reg_fence(o);
          reg_fence(pa);
          if constexpr (!kF16P) reg_fence(pb);
          reg_fence(sc);
          mbar_arrive(empty0 + 8 * s);
          float vf = 1.f;  // O is rescaled to tile i + 1's shift of V
          if constexpr (kF16P) {
            mbar_wait(vready0 + 8 * s1, ((it + 1) / S) & 1);
            vf = pow2(max(-126, vshift[s1] - shift));
            shift = vshift[s1];
          }
          softmax_tile<D, kF16P>(p, sc, o, pa, pb, m0, m1, l0, l1,
                                       row0, r0, r1, t,
                                       k_lo + (i + 1) * kWBK, sl2, vf);
        }
        const int s = it % S;
        bar_sync(mine);
        wgmma_fence();
        issue_pv<D, kF16P>(o, pa, pb,
                                 sKV + s * 2 * C::kTileBytes + C::kTileBytes);
        wgmma_commit();
        // the turns alternate to the end: warpgroup 2 takes the last one
        if (cw == 0 || !last) bar_arrive(other);
        wgmma_wait_all();
        reg_fence(o);
        reg_fence(pa);
        if constexpr (!kF16P) reg_fence(pb);
        mbar_arrive(empty0 + 8 * s);
        ++it;
      }
      mbar_arrive(q_empty0 + 8 * j);  // every S of this tile has completed

      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      // route 1: undo V's power-of-two shift
      const float su = pow2(-shift);
      const float inv0 = l0 > 0.f ? su / l0 : 0.f;
      const float inv1 = l1 > 0.f ? su / l1 : 0.f;
      __nv_bfloat16* ob =
          static_cast<__nv_bfloat16*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        const int c = jb * 8 + t * 2;
        if (r0 < p.Sq)
          *reinterpret_cast<uint32_t*>(ob + r0 * p.o_ss + c) =
              pack_bf16(o[4 * jb] * inv0, o[4 * jb + 1] * inv0);
        if (r1 < p.Sq)
          *reinterpret_cast<uint32_t*>(ob + r1 * p.o_ss + c) =
              pack_bf16(o[4 * jb + 2] * inv1, o[4 * jb + 3] * inv1);
      }
    }
  }
}

template <int D>
struct LaunchBf16 {
  static cudaError_t run(const Params& p, cudaStream_t stream) {
    constexpr int smem = bf16_smem_bytes<D>();  // above 48 KB: opt in
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.H, p.B, (p.Sq + kBQ - 1) / kBQ);
    flash_fwd_bf16<D><<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
};

template <int D>
struct LaunchF32 {
  static cudaError_t run(const Params& p, cudaStream_t stream) {
    const dim3 grid((p.Sq + kFQ - 1) / kFQ, p.H, p.B);
    flash_fwd_f32<D><<<grid, kThreads, 0, stream>>>(p);
    return cudaGetLastError();
  }
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor (B, S, heads, D) with element strides (sb, ss, sh) as the
// 4-D map (D, heads, S, B), boxes of 64 x 1 x rows x 1, 128-byte swizzle,
// zero fill out of bounds. A dimension of size 1 gets the packed stride
// (its stride is never used, and TMA wants every stride aligned).
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
                int D, long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  if (heads == 1) sh = D;
  if (S == 1) ss = sh * heads;
  if (B == 1) sb = ss * S;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kSwz), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One persistent block per SM of the current device.
int num_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    return 132;
  return n;
}

template <int D, bool kF16P>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, p.q, p.B, p.Sq, p.H, D, p.q_sb, p.q_ss, p.q_sh, kWBQ) ||
      !tensor_map(&tk, p.k, p.B, p.Sk, p.KV, D, p.k_sb, p.k_ss, p.k_sh, kWBK) ||
      !tensor_map(&tv, p.v, p.B, p.Sk, p.KV, D, p.v_sb, p.v_ss, p.v_sh, kWBK))
    return cudaErrorInvalidValue;
  constexpr int smem = WCfg<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D, kF16P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int total = (p.Sq + kWBQ - 1) / kWBQ * p.H * p.B;
  flash_fwd_wgmma<D, kF16P><<<std::min(total, num_sms()), kWThreads, smem,
                              stream>>>(p, tq, tk, tv);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, in the
// order (batch, sequence, head); the last axis of every tensor must be
// contiguous.
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* out,
    int B, int Sq, int Sk, int H, int KV, int D, int dtype,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float scale, void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || Sq <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  Params p{q, k, v, out, B, Sq, Sk, H, KV, H / KV,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
      case 16: return LaunchF32<16>::run(p, s);
      case 64: return LaunchF32<64>::run(p, s);
      case 128: return LaunchF32<128>::run(p, s);
    }
  } else if (dtype == 1) {
    switch (D) {  // the P route is bound to the head dim (see the top)
      case 16: return LaunchBf16<16>::run(p, s);
      case 64: return launch_wgmma<64, true>(p, s);
      case 128: return launch_wgmma<128, false>(p, s);
    }
  }
  return cudaErrorInvalidValue;
}
