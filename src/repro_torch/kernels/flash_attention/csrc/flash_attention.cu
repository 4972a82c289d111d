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
// Bound: at the shapes the model runs (S >= 1024, D = 128) the work is
// operations: 4 * D flops per visible (query, key) pair against
// (Sq + 2 Sk) * D * 2 bytes read once, ~1000 flops per byte for causal
// S = 2048, far above the H100's ~295 flops/byte bf16 ridge. So the floor
// is the bf16 tensor-core rate, 989 TFLOP/s; in float32 (no TF32) it is
// the 67 TFLOP/s of the CUDA cores.
//
// Design. The TPU kernel walks the key blocks of one (row, head, query
// block) sequentially on one core, carrying the softmax state in VMEM
// scratch. Here one block owns a (query tile, head, batch row), and the
// key axis is a loop inside the block over key tiles staged in shared
// memory; the softmax state stays in registers. Key tiles wholly above the
// diagonal or below the window are never visited (the loop bounds), as the
// TPU kernel's pl.when skips them; keys past Sk are never read (the tile
// is zero-filled there and masked).
//  - bfloat16: flash_fwd_bf16, four warps, 64 queries x 64 keys per tile.
//    Each warp owns 16 query rows. Q @ K^T and P @ V run on the tensor
//    cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate): the score
//    accumulators of two 8-key tiles are, register for register, the A
//    operand of the P @ V product, so P never leaves registers. P goes in
//    as two bf16 terms (hi + lo, ~16 significant bits), so its rounding
//    costs no more than a float32 P would. K and V are staged row-major,
//    each row padded by 8 elements, and their fragments are read with
//    ldmatrix (V transposed by ldmatrix.trans), conflict-free. Two tile
//    buffers: cp.async loads the next key tile while the warps compute
//    on this one. Tiles that the diagonal, the window and the ragged end
//    do not cut skip the element mask. The query tiles with the most
//    keys under a causal mask are scheduled first.
//  - float32: flash_fwd_f32, full float32 on the CUDA cores (tensor-core
//    float32 would be TF32). Four warps of four query rows, 32 keys per
//    tile, one key per lane for the scores, one output dimension per lane
//    (stride 32) for P @ V.
// No TMA, wgmma or warp specialisation yet: a right and simple kernel
// first.
//
// C interface for ctypes; launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// bfloat16: tensor cores (mma.sync m16n8k16)
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

template <template <int> class Launch>
cudaError_t dispatch_dim(int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 16: return Launch<16>::run(p, stream);
    case 64: return Launch<64>::run(p, stream);
    case 128: return Launch<128>::run(p, stream);
  }
  return cudaErrorInvalidValue;
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
  switch (dtype) {
    case 0: return dispatch_dim<LaunchF32>(D, p, s);
    case 1: return dispatch_dim<LaunchBf16>(D, p, s);
  }
  return cudaErrorInvalidValue;
}
