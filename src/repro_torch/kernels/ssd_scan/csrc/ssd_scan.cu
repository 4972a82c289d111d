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
// Both kernels run the chunked form with the kernel's own 64-token chunks
// (the function does not depend on the chunk; the last, ragged chunk is
// zero-padded: dA = 0, B = C = xdt = 0 past S, which leaves the state and
// the cumulative decay unchanged), N and P up to 64 zero-padded to 64:
//     cum   = cumsum(dA)                          (64,)   float64
//     att   = tril(C B^T * exp(cum_i - cum_j))    (64, 64)
//     y     = att @ xdt + exp(cum) * (C @ state)  (64, P)
//     state = exp(cum_last) state + (w B)^T xdt,  w_j = exp(cum_last - cum_j)
// Every exponent is <= 0 (the mask is applied before the exponential), so
// nothing overflows for any dA <= 0. The cumulative decay is summed in
// float64: with fast decays it reaches ~-1000 within a chunk, and the
// float32 difference cum_i - cum_j of two such sums loses ~1e-4 of the
// exponent it needs (the reference's cumsum does, in float32).
//
// Bound: at zamba2-1.2b's forward shape (B=4, S=2048, H=64, P=N=64, bf16)
// the work is bytes: xdt and y (2 x 67 MB), dA (2 MB) and B, C (2 MB)
// read or written once, ~138 MB against 3.35 TB/s, 41.3 us. The chunked
// algorithm needs ~11 GFLOP with C B^T formed once per chunk for all
// heads, ~11 us at the bf16 tensor-core rate.
//
// bfloat16: ssd_scan_tc_kernel, on the tensor cores. A block owns one
// batch row and a pair of heads (B * H / 2 = 128 blocks at the zamba2
// shape, one per SM) and walks the chunks with 16 warps: warp (r, hh, c)
// owns token rows 16 r.. of y and state rows 16 r.. of head hh, for the
// columns 32 c.. of P. Per chunk, with one block barrier and one per row
// block:
// - cp.async (16 bytes a thread) brings C, B and both heads' xdt tiles of
//   chunk k + 1 into a two-stage ring while chunk k computes; B and C are
//   loaded once per block, not per head.
// - C B^T is formed once per chunk for both heads: its causal 16 x 8
//   tiles (j < 16 (r + 1)) are shared out among the four warps of row
//   block r (mma.sync m16n8k16 with ldmatrix, float32 accumulation) into a
//   float tile in shared memory, behind a barrier of those four warps;
//   each head's warps apply their decay mask to their rows in registers
//   and feed the result to att @ xdt as the A operand.
// - The decay mask exp(cum_i - cum_j), j <= i: below the diagonal 16 x 16
//   block as two factors exp(cum_i - cum_16r) exp(cum_16r - cum_j), each
//   <= 1, precomputed per chunk; on the diagonal block directly, from the
//   float64 difference carried as hi + lo floats, masked before ex2.
// - The float32 operands of y enter the bf16 products as two bf16 terms,
//   hi + lo (hi = bf16(x), lo = bf16(x - hi)): the masked att and the
//   carried state (C @ state; its float32 master stays in the owning
//   warp's registers, a hi/lo copy goes to a double-buffered shared tile
//   for the other warps). The decay-weighted w B of the state update
//   enters as one bf16 term: on the card a single term for att reached
//   0.98 of the output bound at the zamba2 shape, for the state 0.64, for
//   w B 0.48 (hi + lo everywhere: 0.41), and hi + lo on w B costs ~10% of
//   the kernel's time. The bf16 inputs (C, B, xdt) enter as they are.
// - The decay cumsum is a float64 warp scan (shuffles), one warp per head
//   (of row block 0, which has the fewest causal steps), done for chunk
//   k + 1 during chunk k into a double buffer with what derives from it.
// - y is staged per warp in shared memory and written in 16-byte stores.
// The wrapper refuses bf16 data that cp.async cannot read: a base or a
// stride (of xdt, B, C) that is not a multiple of 16 bytes, or P, N not a
// multiple of 8.
//
// float32: ssd_scan_kernel, the CUDA-core kernel of the port's first
// version (the path of the full-width zamba2 float32 logit gate): one
// block per (batch row, head), the four products in float32, each of 256
// threads a 4 x 4 tile, C B^T formed per head, the cumsum by one thread.
//
// The C entry picks the kernel by dtype. C interface for ctypes; launches
// on the caller's stream, allocates nothing, and returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;        // tokens per chunk
constexpr int kT = 64;        // N and P are zero-padded to this

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

// ---------------------------------------------------------------------------
// float32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kLd = kT + 1;   // padded row length of every tile
constexpr int kThreads = 256;
constexpr int kSmem =
    (4 * kQ * kLd + kT * kLd + 2 * kQ) * sizeof(float) + kQ * sizeof(double);

__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Params p) {
  extern __shared__ float fsmem[];
  float* X = fsmem;                 // [kQ][kLd]  xdt of the chunk
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

  const float* xg = static_cast<const float*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* bg = static_cast<const float*>(p.b) + b * p.b_sb;
  const float* cg = static_cast<const float*>(p.c) + b * p.c_sb;
  const float* ag = p.da + b * p.a_sb + h * p.a_sh;
  float* yg = static_cast<float*>(p.y) + b * p.y_sb + h * p.y_sh;

  for (int e = tid; e < kT * kLd; e += kThreads) St[e] = 0.f;

  for (int s0 = 0; s0 < p.S; s0 += kQ) {
    const int q = min(kQ, p.S - s0);
    for (int e = tid; e < kQ * kT; e += kThreads) {
      const int i = e / kT, j = e % kT;
      const long long s = s0 + i;
      const bool in = i < q;
      X[i * kLd + j] = (in && j < p.P) ? xg[s * p.x_ss + j] : 0.f;
      Bm[i * kLd + j] = (in && j < p.N) ? bg[s * p.b_ss + j] : 0.f;
      Cm[i * kLd + j] = (in && j < p.N) ? cg[s * p.c_ss + j] : 0.f;
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
            yg[(s0 + i) * p.y_ss + pc] = acc[r][c] + ecum[i] * inter[r][c];
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

cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<<<p.B * p.H, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kHeads = 2;            // heads per block
constexpr int kWarps = 16;           // (row block r, head, column half c)
constexpr int kTcThreads = kWarps * 32;
constexpr int kStages = 2;           // chunk ring
constexpr int kST = kT + 8;          // tile row stride: ldmatrix conflict-free
constexpr int kTile = kQ * kST;      // elements of one 64-row bf16 tile
constexpr int kCS = kQ + 4;          // row stride of the float C B^T tile
constexpr int kYS = 32 + 8;          // row stride of a warp's y staging tile
constexpr double kLog2e = 1.4426950408889634;

// Per head and chunk: the decay's float64 cumsum and what is derived.
struct Decay {
  float ch[kQ];        // log2(e) cumsum(dA) within the chunk, float64 summed,
  float cl[kQ];        // as hi + lo floats: ch = float(.), cl = . - ch
  float rf[kQ];        // exp(cum_i - cum_16r), 16 r <= i < 16 (r + 1)
  float kf[4][kQ];     // kf[r][j] = exp(cum_16r - cum_j), j < 16 r (r > 0)
  float w[kQ];         // exp(cum_last - cum_j)
  float ecum[kQ];      // exp(cum_i)
  float el;            // exp(cum_last)
  float pad[3];
};

constexpr int kRingBytes = kStages * (2 + kHeads) * kTile * 2;
constexpr int kStateBytes = 2 * kHeads * 2 * kTile * 2;  // [buf][head][hi/lo]
constexpr int kCbBytes = kQ * kCS * 4;
constexpr int kDecayBytes = 2 * kHeads * sizeof(Decay);  // [buf][head]
constexpr int kYBytes = kWarps * 16 * kYS * 2;
constexpr int kTcSmem =
    kRingBytes + kStateBytes + kCbBytes + kDecayBytes + kYBytes;
static_assert(kTcThreads == kQ * 8, "one row of each tile a thread");
static_assert(sizeof(Decay) % 16 == 0, "Decay keeps 16-byte alignment");
static_assert(kTcSmem <= 232448, "shared memory of one block");

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) as bf16 pairs hi = bf16(.), lo = bf16(. - hi); .x is the low half.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
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

// Chunk k's C, B and the block's xdt tiles into ring slot ``dst``
// (C | B | xdt head 0 | xdt head 1, 64 rows each): thread tid copies the
// 16 bytes at column 8 (tid % 8) of row tid / 8 of each. Rows past S,
// columns past N or P and heads past H are zero-filled.
__device__ __forceinline__ void load_chunk(const Params& p, __nv_bfloat16* dst,
                                           int b, int h0, int s0) {
  const int i = threadIdx.x / 8, c8 = (threadIdx.x % 8) * 8;
  const long long s = s0 + i;
  __nv_bfloat16* d = dst + i * kST + c8;
  const bool okn = s < p.S && c8 < p.N;
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(p.c) +
                            b * p.c_sb + s * p.c_ss + c8;
  const __nv_bfloat16* bg = static_cast<const __nv_bfloat16*>(p.b) +
                            b * p.b_sb + s * p.b_ss + c8;
  cp_async16(d, okn ? cg : p.x, okn ? 16 : 0);
  cp_async16(d + kTile, okn ? bg : p.x, okn ? 16 : 0);
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    const bool ok = s < p.S && c8 < p.P && h0 + hh < p.H;
    const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(p.x) +
                              b * p.x_sb + s * p.x_ss + (h0 + hh) * p.x_sh + c8;
    cp_async16(d + (2 + hh) * kTile, ok ? xg : p.x, ok ? 16 : 0);
  }
}

// The warp's float64 inclusive scan of one head's chunk decays: lane l
// holds tokens 2l and 2l + 1 (0 past S).
__device__ __forceinline__ void scan_decay(Decay& d, float a0, float a1,
                                           int lane) {
  const double x0 = a0, x1 = x0 + a1;
  double incl = x1;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const double y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  double prev = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) prev = 0.0;
  const double c0 = prev + x0, c1 = prev + x1;
  const double last = __shfl_sync(0xffffffffu, c1, 31);
  const double l0 = c0 * kLog2e, l1 = c1 * kLog2e;
  const float h0 = static_cast<float>(l0), h1 = static_cast<float>(l1);
  reinterpret_cast<float2*>(d.ch)[lane] = make_float2(h0, h1);
  reinterpret_cast<float2*>(d.cl)[lane] = make_float2(
      static_cast<float>(l0 - h0), static_cast<float>(l1 - h1));
  reinterpret_cast<float2*>(d.w)[lane] =
      make_float2(expf(static_cast<float>(last - c0)),
                  expf(static_cast<float>(last - c1)));
  reinterpret_cast<float2*>(d.ecum)[lane] =
      make_float2(expf(static_cast<float>(c0)), expf(static_cast<float>(c1)));
  if (lane == 0) d.el = expf(static_cast<float>(last));
  // the factors of exp(cum_i - cum_j) = rf[i] kf[r][j] for j < 16 r <= i
  const double ref = __shfl_sync(0xffffffffu, c0, (lane / 8) * 8);
  reinterpret_cast<float2*>(d.rf)[lane] =
      make_float2(expf(static_cast<float>(c0 - ref)),
                  expf(static_cast<float>(c1 - ref)));
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    const double cr = __shfl_sync(0xffffffffu, c0, 8 * r);
    reinterpret_cast<float2*>(d.kf[r])[lane] =
        make_float2(expf(fminf(static_cast<float>(cr - c0), 0.f)),
                    expf(fminf(static_cast<float>(cr - c1), 0.f)));
  }
}

// exp(cum_i - cum_j) for j <= i, from the hi + lo parts of log2(e) cum:
// the difference of the float64 sums to float precision, clamped at 0
// against rounding; float64 arithmetic here costs more than the products.
__device__ __forceinline__ float decay(float hi, float li, float hj, float lj) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(e) : "f"(fminf((hi - hj) + (li - lj), 0.f)));
  return e;
}

__global__ void __launch_bounds__(kTcThreads, 1)
ssd_scan_tc_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const sstate =
      reinterpret_cast<__nv_bfloat16*>(smem + kRingBytes);
  float* const scb = reinterpret_cast<float*>(smem + kRingBytes + kStateBytes);
  Decay* const sdecay =
      reinterpret_cast<Decay*>(smem + kRingBytes + kStateBytes + kCbBytes);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // warp 4 r + 2 hh + c: row block r, head hh, column half c. Warps w,
  // w + 4, .. share a scheduler, so each holds every row block (row block
  // r has r + 1 causal steps).
  const int r = warp / 4, hh = (warp / 2) % 2, c = warp % 2;
  const int g = lane / 4, t = lane % 4;   // fragment row group, column pair
  const int lr = lane % 8, lm = lane / 8; // ldmatrix row, matrix
  const int b = blockIdx.y;
  const int h0 = blockIdx.x * kHeads, h = h0 + hh;
  const int nc = (p.S + kQ - 1) / kQ;
  const int i0 = 16 * r + g;              // this thread's rows i0, i0 + 8
  __nv_bfloat16* const ystage = reinterpret_cast<__nv_bfloat16*>(
      smem + kRingBytes + kStateBytes + kCbBytes + kDecayBytes) +
      warp * 16 * kYS;

  // warp (r = 0, hh, c = 0) scans head hh's decays
  const bool scanner = r == 0 && c == 0;
  const float* ag = p.da + b * p.a_sb + h * p.a_sh;
  float da0 = 0.f, da1 = 0.f;
  auto fetch_decay = [&](int s0) {
    da0 = da1 = 0.f;
    const long long s = s0 + 2 * lane;
    if (h < p.H && s < p.S) da0 = ag[s * p.a_ss];
    if (h < p.H && s + 1 < p.S) da1 = ag[(s + 1) * p.a_ss];
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nc) load_chunk(p, ring + k * (2 + kHeads) * kTile, b, h0, k * kQ);
    cp_async_commit();
  }
  if (scanner) {
    fetch_decay(0);
    scan_decay(sdecay[hh], da0, da1, lane);
    fetch_decay(kQ);
  }

  float st[4][4];  // state rows i0, i0 + 8 (of N), columns 32 c + 8 pt + ..
#pragma unroll
  for (int pt = 0; pt < 4; ++pt)
    st[pt][0] = st[pt][1] = st[pt][2] = st[pt][3] = 0.f;

  for (int k = 0; k < nc; ++k) {
    cp_async_wait<kStages - 2>();  // chunk k has landed (this thread's)
    __syncthreads();               // ... everyone's; slot (k - 1) is free
    if (k + kStages - 1 < nc)
      load_chunk(p, ring + ((k + kStages - 1) % kStages) * (2 + kHeads) * kTile,
                 b, h0, (k + kStages - 1) * kQ);
    cp_async_commit();

    const int s0 = k * kQ;
    const __nv_bfloat16* sC = ring + (k % kStages) * (2 + kHeads) * kTile;
    const __nv_bfloat16* sB = sC + kTile;
    const __nv_bfloat16* x = sB + (1 + hh) * kTile;
    const __nv_bfloat16* sS = sstate + ((k % 2) * kHeads + hh) * 2 * kTile;
    __nv_bfloat16* sSn = sstate + (((k + 1) % 2) * kHeads + hh) * 2 * kTile;
    const Decay& d = sdecay[(k % 2) * kHeads + hh];

    // C rows 16 r.. as A fragments, four 16-wide steps over N
    uint32_t cf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm_x4(cf[kk], &sC[(16 * r + (lane % 16)) * kST + 16 * kk +
                          (lane / 16) * 8]);
    // C B^T, once for both heads: the causal 8-column tiles of row block
    // r (j < 16 (r + 1)) are shared out among its four warps
    for (int nt = 2 * hh + c; nt <= 2 * r + 1; nt += 4) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; kk += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, &sB[(nt * 8 + lr) * kST + kk * 16 + lm * 8]);
        mma_bf16(a, cf[kk], bf[0], bf[1]);
        mma_bf16(a, cf[kk + 1], bf[2], bf[3]);
      }
      *reinterpret_cast<float2*>(&scb[i0 * kCS + 8 * nt + 2 * t]) =
          make_float2(a[0], a[1]);
      *reinterpret_cast<float2*>(&scb[(i0 + 8) * kCS + 8 * nt + 2 * t]) =
          make_float2(a[2], a[3]);
    }
    // C B^T rows 16 r.. are complete: only row block r's warps read them
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + r) : "memory");
    // the next chunk's decays (fetched a chunk ago) into the other buffer,
    // by warps of row block 0, which have the fewest causal steps; then
    // fetch the one after (every warp reads it after the next barrier)
    if (scanner && k + 1 < nc) {
      scan_decay(sdecay[((k + 1) % 2) * kHeads + hh], da0, da1, lane);
      fetch_decay((k + 2) * kQ);
    }

    // y = exp(cum_i) (C @ state) + tril(C B^T * exp(cum_i - cum_j)) @ xdt,
    // the state at the chunk's start as hi + lo
    float acc[4][4];
#pragma unroll
    for (int pt = 0; pt < 4; ++pt)
      acc[pt][0] = acc[pt][1] = acc[pt][2] = acc[pt][3] = 0.f;
    if (k > 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int pt = 0; pt < 4; pt += 2) {
            uint32_t v[4];
            ldsm_x4_trans(v, &sS[part * kTile +
                                 (16 * kk + (lm % 2) * 8 + lr) * kST +
                                 32 * c + (pt + lm / 2) * 8]);
            mma_bf16(acc[pt], cf[kk], v[0], v[1]);
            mma_bf16(acc[pt + 1], cf[kk], v[2], v[3]);
          }
      const float e0 = d.ecum[i0], e1 = d.ecum[i0 + 8];
#pragma unroll
      for (int pt = 0; pt < 4; ++pt) {
        acc[pt][0] *= e0;
        acc[pt][1] *= e0;
        acc[pt][2] *= e1;
        acc[pt][3] *= e1;
      }
    }
    const float r0 = d.rf[i0], r1 = d.rf[i0 + 8];
    const float hi0 = d.ch[i0], lo0 = d.cl[i0];
    const float hi1 = d.ch[i0 + 8], lo1 = d.cl[i0 + 8];
    for (int kk = 0; kk <= r; ++kk) {
      float m[2][4];  // masked, decayed att of column tiles 2 kk, 2 kk + 1
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 16 * kk + 8 * u + 2 * t;
        const float2 a0 = *reinterpret_cast<const float2*>(&scb[i0 * kCS + j]);
        const float2 a1 =
            *reinterpret_cast<const float2*>(&scb[(i0 + 8) * kCS + j]);
        if (kk < r) {  // j < 16 r <= i: two factors, each <= 1
          const float2 kj = *reinterpret_cast<const float2*>(&d.kf[r][j]);
          m[u][0] = a0.x * r0 * kj.x;
          m[u][1] = a0.y * r0 * kj.y;
          m[u][2] = a1.x * r1 * kj.x;
          m[u][3] = a1.y * r1 * kj.y;
          continue;
        }
        // the diagonal block: directly, masked before the exponential
        const float2 hj = *reinterpret_cast<const float2*>(&d.ch[j]);
        const float2 lj = *reinterpret_cast<const float2*>(&d.cl[j]);
        m[u][0] = j <= i0 ? a0.x * decay(hi0, lo0, hj.x, lj.x) : 0.f;
        m[u][1] = j + 1 <= i0 ? a0.y * decay(hi0, lo0, hj.y, lj.y) : 0.f;
        m[u][2] = j <= i0 + 8 ? a1.x * decay(hi1, lo1, hj.x, lj.x) : 0.f;
        m[u][3] = j + 1 <= i0 + 8 ? a1.y * decay(hi1, lo1, hj.y, lj.y) : 0.f;
      }
      uint32_t ah[4], al[4];
      split2(m[0][0], m[0][1], ah[0], al[0]);
      split2(m[0][2], m[0][3], ah[1], al[1]);
      split2(m[1][0], m[1][1], ah[2], al[2]);
      split2(m[1][2], m[1][3], ah[3], al[3]);
#pragma unroll
      for (int pt = 0; pt < 4; pt += 2) {
        uint32_t v[4];  // xdt as B fragments: tokens 16 kk.., 2 column tiles
        ldsm_x4_trans(v, &x[(16 * kk + (lm % 2) * 8 + lr) * kST + 32 * c +
                            (pt + lm / 2) * 8]);
        mma_bf16(acc[pt], ah, v[0], v[1]);
        mma_bf16(acc[pt + 1], ah, v[2], v[3]);
        mma_bf16(acc[pt], al, v[0], v[1]);
        mma_bf16(acc[pt + 1], al, v[2], v[3]);
      }
    }

    // y staged, then 16-byte stores
#pragma unroll
    for (int pt = 0; pt < 4; ++pt) {
      const int col = 8 * pt + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(&ystage[g * kYS + col]) =
          __floats2bfloat162_rn(acc[pt][0], acc[pt][1]);
      *reinterpret_cast<__nv_bfloat162*>(&ystage[(g + 8) * kYS + col]) =
          __floats2bfloat162_rn(acc[pt][2], acc[pt][3]);
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int row = n * 8 + lane / 4, col = 32 * c + (lane % 4) * 8;
      const int s = s0 + 16 * r + row;
      if (s < p.S && col < p.P && h < p.H)
        *reinterpret_cast<uint4*>(
            static_cast<__nv_bfloat16*>(p.y) + b * p.y_sb + s * p.y_ss +
            h * p.y_sh + col) =
            *reinterpret_cast<const uint4*>(&ystage[row * kYS +
                                                    (lane % 4) * 8]);
    }
    __syncwarp();

    // state = exp(cum_last) state + (w B)^T xdt, w B as one bf16 term: the
    // A fragments are B^T rows (state rows) 16 r.. over the chunk's tokens
#pragma unroll
    for (int pt = 0; pt < 4; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[pt][e] *= d.el;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t bt[4];
      ldsm_x4_trans(bt, &sB[(16 * kk + (lm / 2) * 8 + lr) * kST + 16 * r +
                            (lm % 2) * 8]);
      const int j = 16 * kk + 2 * t;
      const float2 w0 = *reinterpret_cast<const float2*>(&d.w[j]);
      const float2 w1 = *reinterpret_cast<const float2*>(&d.w[j + 8]);
      uint32_t wb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 bv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&bt[q]));
        const float2 w = q < 2 ? w0 : w1;
        wb[q] = bits(__floats2bfloat162_rn(bv.x * w.x, bv.y * w.y));
      }
#pragma unroll
      for (int pt = 0; pt < 4; pt += 2) {
        uint32_t v[4];
        ldsm_x4_trans(v, &x[(16 * kk + (lm % 2) * 8 + lr) * kST + 32 * c +
                            (pt + lm / 2) * 8]);
        mma_bf16(st[pt], wb, v[0], v[1]);
        mma_bf16(st[pt + 1], wb, v[2], v[3]);
      }
    }
    // the new state's hi + lo for the next chunk's C @ state
    if (k + 1 < nc) {
#pragma unroll
      for (int pt = 0; pt < 4; ++pt) {
        const int col = 32 * c + 8 * pt + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t hi, lo;
          split2(st[pt][2 * half], st[pt][2 * half + 1], hi, lo);
          const int o = (i0 + 8 * half) * kST + col;
          *reinterpret_cast<uint32_t*>(&sSn[o]) = hi;
          *reinterpret_cast<uint32_t*>(&sSn[kTile + o]) = lo;
        }
      }
    }
  }
  cp_async_wait<0>();
}

cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTcSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.H + kHeads - 1) / kHeads, p.B);
  ssd_scan_tc_kernel<<<grid, kTcThreads, kTcSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype (of xdt, B and C; y takes it too): 0 = float32, 1 = bfloat16. dA
// is float32. Strides are in elements: xdt and y (batch, sequence, head),
// B and C (batch, sequence), dA (batch, sequence, head); the last axis of
// every tensor must be contiguous. P and N at most 64; in bfloat16 they
// are multiples of 8, and the bases and strides of xdt, B and C multiples
// of 16 bytes (the wrapper checks).
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
    case 0: return launch_f32(p, s);
    case 1:
      if (P % 8 != 0 || N % 8 != 0) return cudaErrorInvalidValue;
      return launch_bf16(p, s);
  }
  return cudaErrorInvalidValue;
}
