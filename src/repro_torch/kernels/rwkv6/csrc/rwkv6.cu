// RWKV-6 (Finch) WKV recurrence, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6/kernel.py::
// rwkv6_scan (body _rwkv6_kernel). Same function, in the model's layout:
// r, k, v (B, S, H, D) in one dtype, float32 or bfloat16 (the dtype the
// model's projections come in), and w (B, S, H, D) float32 (the per-step
// decay in (0, 1); it sits near 1 and needs float32's resolution), each
// given through strides with a contiguous last axis; the bonus u (H, D)
// and the optional initial state s0 (B, H, D, D) contiguous float32. Per
// head, with the state S (Dk, Dv) in float32:
//     o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
// o (B, S, H, D) in r's dtype (computed in float32, rounded once) and the
// final state (B, H, D, D) float32, both allocated contiguous by the
// wrapper.
//
// Bound: at rwkv6-7b's forward shape (B=4, S=2048, H=64, D=64) the
// recurrence needs 5 flops per state entry per token (r^T S, then
// w * S + k v^T), ~10.7 GFLOP, ~0.16 ms at the CUDA cores' 67 TFLOP/s.
// The bytes are 0.12 ms at the model's dtypes (bf16 r, k, v and o,
// float32 w) and 0.20 ms in float32. This kernel issues 3 float32
// instructions per entry and token for bf16 input and 4 for float32
// (below): ~0.19 and ~0.26 ms at 1.98 GHz.
//
// Design. The TPU kernel expands each chunk in pairwise log-decay space
// so that its matrix unit does the work. Here the recurrence is run token
// by token, exactly as defined, with the float32 state in registers: no
// exponential, no logarithm, no chunk length (a ragged S is the same
// loop), nothing that can overflow beyond float32's own.
// - One block of kThreads threads owns a (batch row, head); two blocks
//   share an SM, one warp on each scheduler. Thread (g, cg) holds the
//   state's rows g*kRows .. +kRows-1 of the value columns
//   cg*kCols .. +kCols-1 in registers. The lanes of a quarter warp share
//   a row group, so their 16-byte loads of r, k and w are broadcasts.
// - Per entry and token: one FFMA for the output, and for the update the
//   plain version's roundings, (w * S) + (k v) with each product rounded,
//   so that the state is the plain version's to the bit: FMUL, FMUL, FADD
//   for float32 input; for bf16 input k v is exact in float32, so FMUL
//   w * S and one FFMA. A fused w * S + k v (one rounding) drifts from the
//   plain version by a few ulps a token, which over a slowly decaying
//   8192-token sequence puts float32 outputs near 0 outside the gate.
// - The bonus term sum_i r_i u_i k_i v_j is c_t v_j: the scalar
//   c_t = sum_i r_i u_i k_i is formed once per token while the block
//   cooks it, so the output is o_j = sum_i r_i S_ij + c_t v_j.
// - Tokens are staged kTok at a time with cp.async (16 bytes a thread)
//   into one raw stage, converted from there ("cooked") to float32 tiles
//   (r, k and w interleaved, below) with c_t formed, 16 bytes a lane.
//   The copies of block n+1 are issued once block n is cooked and land
//   while it is computed. Two barriers a block: block n landed, then
//   block n cooked.
// - The kRows-row partial outputs of a column are summed across the
//   kGroups row groups by warp shuffles, with no shared-memory round
//   trip, each output stored by the thread that ends up holding it.
//   Token t-1's sum runs a step at a time between token t's rows, and
//   the next quad of r, k, w is loaded a row at a time, so that the one
//   warp a scheduler holds rarely waits on a load or a shuffle.
// Float32 summation order of o_j (the float32 gate is checked against
// it): per row group, the even and the odd rows' r_i S_ij are summed in
// two FFMA chains in row order, then added; the row groups' sums are
// added pairwise by the shuffle levels, from the highest row-group bit
// down; c_t: per quad of rows i..i+3, (r_i u_i) k_i, then fmaf of the
// next three rows' (r u) and k onto it, in row order, and these 16 sums
// added pairwise over the lanes (lane bits 3 down to 0); finally
// o_j = fmaf(c_t, v_j, sum).
// D up to 64 is zero-padded to 64 (padded rows and columns stay 0).
//
// C interface for ctypes; launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kD = 64;          // D is zero-padded to this
constexpr int kRows = 16;       // state rows per thread
constexpr int kCols = 4;        // value columns per thread
constexpr int kTok = 32;        // tokens per staged block
constexpr int kGroups = kD / kRows;                 // row groups
constexpr int kThreads = kGroups * (kD / kCols);
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 32 / kGroups;    // lanes of one row group in a warp
constexpr int kLogGroups = kGroups == 1 ? 0 : kGroups == 2 ? 1
                           : kGroups == 4 ? 2 : kGroups == 8 ? 3 : -1;
constexpr int kOut = kCols > kGroups ? kCols / kGroups : 1;
constexpr int kParts = 2;       // output chains per column
static_assert(kRows % 4 == 0 && kLogGroups >= 0 && kThreads % 32 == 0,
              "tile shape");
static_assert(kCols == 2 || kCols % 4 == 0, "v read as float2 or float4");

constexpr int kTile = kTok * kD;               // one staged array

// Shared memory: the raw stage (r, k, v in the input dtype, w float32),
// c_t, and the cooked float32 r, k, w (interleaved) and v.
constexpr int smem_bytes(int in_size) {
  return kTile * (3 * in_size + 4) + kTok * 4 + 4 * kTile * 4;
}
static_assert(smem_bytes(4) <= 232448 / 2, "two blocks an SM");

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;   // nullable: zero initial state
  void* o;
  float* sT;
  int B, S, H, D;
  long long r_sb, r_ss, r_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  long long o_sb, o_ss, o_sh;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const float2 a = load2(p), b = load2(p + 2);
  return make_float4(a.x, a.y, b.x, b.y);
}

// A store under a predicate, so that the value and the address are
// formed in the token's straight-line code and not in a branch.
__device__ __forceinline__ void store_if(float* p, float x, bool ok) {
  asm volatile("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
               " @q st.global.f32 [%0], %1;\n}\n"
               :: "l"(p), "f"(x), "r"(static_cast<unsigned>(ok)));
}

__device__ __forceinline__ void store_if(__nv_bfloat16* p, float x, bool ok) {
  asm volatile("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
               " @q st.global.b16 [%0], %1;\n}\n"
               :: "l"(p), "h"(__bfloat16_as_ushort(__float2bfloat16_rn(x))),
                  "r"(static_cast<unsigned>(ok)));
}

// Where row i of r, k and w is kept in the float32 tiles: row group
// g = i / kRows, quad q = (i % kRows) / 4 of it goes to float4 slot
// q * kGroups + (g ^ swizzle(q)). The row groups' q-th quads are adjacent,
// so a warp's four 16-byte reads of one quad hit distinct banks; the
// swizzle spreads the cook's 16-byte writes of a quarter warp (32
// consecutive rows) over all 32 banks.
__host__ __device__ constexpr int swizzle(int q) {
  return kGroups == 4 ? (q >> 1 & 1) * 2 : kGroups == 8 ? (q & 1) * 4 : 0;
}

__device__ __forceinline__ int interleaved(int i) {
  const int q = (i % kRows) / 4;
  return (q * kGroups + ((i / kRows) ^ swizzle(q))) * 4 + i % 4;
}

// One level of a sum over lanes: the partner is lane ^ m, and hi says
// which of the two this lane is. With n >= 2 values left, this lane keeps
// the upper half of a[0..n) if hi, else the lower, into a[0..n/2), adding
// the partner's copy; with one value left, both add (a butterfly level).
template <int n, int N>
__device__ __forceinline__ void sum_level(float (&a)[N], int m, bool hi) {
  if constexpr (n >= 2) {
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = hi ? a[i] : a[i + n / 2];
      const float keep = hi ? a[i + n / 2] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  } else {
    a[0] += __shfl_xor_sync(0xffffffffu, a[0], m);
  }
}

// f(integral_constant<int, i>) for i = I .. N-1, each i a constant.
template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

// sum_level over lane bits m, m/2, .. 1, starting with n values.
template <int n, int m, int N>
__device__ __forceinline__ void lane_sum(float (&a)[N], int lane) {
  sum_level<n>(a, m, lane & m);
  if constexpr (m > 1) lane_sum<(n > 1 ? n / 2 : 1), m / 2>(a, lane);
}

// Tokens t0 .. t0+nt-1 of one (B, S, H, D) array into a [kTok][kD] tile,
// 16 bytes a copy (thread i copies chunk i % kChunks of tokens
// i / kChunks + j * kPass); columns from D and tokens from nt on are
// zero-filled.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long ss,
                                      int nt, int D) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kChunks = kD / kPer;
  constexpr int kPass = kThreads / kChunks;
  static_assert(kThreads % kChunks == 0 && kTok % kPass == 0, "staging");
  const int q = threadIdx.x % kChunks, t = threadIdx.x / kChunks;
  const bool in = q * kPer < D;
  const T* g = src + t * ss + q * kPer;
  dst += t * kD + q * kPer;
#pragma unroll
  for (int j = 0; j < kTok / kPass; ++j) {
    const bool ok = in && t + j * kPass < nt;
    cp_async16(dst + j * kPass * kD, ok ? g : src, ok ? 16 : 0);
    g += kPass * ss;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) wkv_token_kernel(Params p) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kRaw = kTile * (3 * static_cast<int>(sizeof(T)) + 4);
  constexpr int kPer = kTok / kWarps;    // tokens a warp cooks
  static_assert(kPer <= 32 && (kPer & (kPer - 1)) == 0, "cook");
  extern __shared__ __align__(16) unsigned char smem[];
  float* const Cc = reinterpret_cast<float*>(smem + kRaw);
  float* const Rc = Cc + kTok;
  float* const Kc = Rc + kTile;
  float* const Wc = Kc + kTile;
  float* const Vc = Wc + kTile;

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / kLanes;                     // row group
  const int cg = warp * kLanes + lane % kLanes;    // column group
  const int D = p.D;

  const T* rg = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* wg = p.w + b * p.w_sb + h * p.w_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const long long sbase = (static_cast<long long>(b) * p.H + h) * D * D;

  float s[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int row = g * kRows + i, col = cg * kCols + c;
      s[i][c] = (p.s0 && row < D && col < D) ? p.s0[sbase + row * D + col]
                                             : 0.f;
    }
  }
  // The cook: lane l takes the quad of rows 4 (l % 16) .. + 3 of every
  // other token its warp takes (half-warp l / 16 the other one).
  const int quad = lane % 16, half = lane / 16;
  const float* const uq = p.u + h * D + 4 * quad;
  const float4 u4 = 4 * quad < D ? make_float4(uq[0], uq[1], uq[2], uq[3])
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
  const int slot = interleaved(4 * quad);
  // The output sum leaves this thread with columns vcol .. + kOut - 1; of
  // the threads left with the same columns, the one whose remaining
  // row-group bits are 0 stores them.
  int off = 0;
  bool writer = true;
#pragma unroll
  for (int lv = 0; lv < kLogGroups; ++lv) {
    const int n = kCols >> lv;
    const bool hi = (g >> (kLogGroups - 1 - lv)) & 1;
    if (n >= 2) off += hi ? n / 2 : 0;
    else writer = writer && !hi;
  }
  const int vcol = cg * kCols + off;
  bool stores[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) stores[i] = writer && vcol + i < D;
  T* const ocol = og + vcol;

  // Block blk holds tokens first(blk) .. first(blk + 1) - 1. The second
  // half of the grid starts with a half block: when the grid fills the
  // card in two rounds, its blocks share SMs with the first half's, and
  // the shift keeps two blocks on one SM from staging and cooking (their
  // shared-memory-bound phase) at the same time.
  const int shift = blockIdx.x >= gridDim.x / 2 ? kTok / 2 : 0;
  auto first = [&](int blk) { return max(0, blk * kTok - shift); };
  const int nblk = (p.S + shift + kTok - 1) / kTok;
  auto issue = [&](int blk) {
    T* R = reinterpret_cast<T*>(smem);
    const long long t0 = first(blk);
    const int nt = min(first(blk + 1), p.S) - first(blk);
    stage(R, rg + t0 * p.r_ss, p.r_ss, nt, D);
    stage(R + kTile, kg + t0 * p.k_ss, p.k_ss, nt, D);
    stage(R + 2 * kTile, vg + t0 * p.v_ss, p.v_ss, nt, D);
    stage(reinterpret_cast<float*>(R + 3 * kTile), wg + t0 * p.w_ss, p.w_ss,
          nt, D);
  };

  issue(0);
  cp_async_commit();
  for (int blk = 0; blk < nblk; ++blk) {
    const int t0 = first(blk);
    const int nt = min(first(blk + 1), p.S) - t0;
    cp_async_wait_all();
    // Block blk has landed, and every thread is done with block blk-1's
    // c_t and cooked tiles.
    __syncthreads();

    // The cook: warp wp takes tokens wp + j * kWarps (those past nt read
    // the zero-filled rows), two at a time: r, k, w (interleaved) and v
    // to float32 tiles, 16 bytes a lane, and c_t, each lane's four rows
    // summed in a chain, then summed over the half warp for all its
    // tokens at once (lane l ends with token j = 2 ((l % 16) / kHalfLanes)
    // + l / 16 of the warp's).
    constexpr int kHalfLanes = 16 / (kPer / 2);
    const T* R = reinterpret_cast<const T*>(smem);
    const float* W = reinterpret_cast<const float*>(R + 3 * kTile);
    float cw[kPer / 2];
#pragma unroll
    for (int j = 0; j < kPer / 2; ++j) {
      const int t = warp + (2 * j + half) * kWarps;
      const int e = t * kD + 4 * quad;
      const float4 r4 = load4(R + e), k4 = load4(R + kTile + e);
      *reinterpret_cast<float4*>(Rc + t * kD + slot) = r4;
      *reinterpret_cast<float4*>(Kc + t * kD + slot) = k4;
      *reinterpret_cast<float4*>(Wc + t * kD + slot) = load4(W + e);
      *reinterpret_cast<float4*>(Vc + e) = load4(R + 2 * kTile + e);
      float c = (r4.x * u4.x) * k4.x;
      c = fmaf(r4.y * u4.y, k4.y, c);
      c = fmaf(r4.z * u4.z, k4.z, c);
      cw[j] = fmaf(r4.w * u4.w, k4.w, c);
    }
    lane_sum<kPer / 2, 8>(cw, lane);
    if (quad % kHalfLanes == 0)
      Cc[warp + (2 * (quad / kHalfLanes) + half) * kWarps] = cw[0];
    __syncthreads();
    // The raw stage is free again: the next block's copies go in now,
    // after the cook (they would contend with its shared-memory traffic),
    // and land while this block is computed.
    if (blk + 1 < nblk) issue(blk + 1);
    cp_async_commit();

    // Token t's updates run while token t-1's partial sums (pend) are
    // summed over the row groups and stored, one step after each quad of
    // rows, in the same straight-line code (token 0 is peeled), so that
    // the shuffles' and loads' latencies hide behind the updates; the
    // first quad of token t+1's r, k, w and its v are loaded during t.
    T* optr = ocol + static_cast<long long>(t0) * p.o_ss;   // token t0
    float pend[kCols], ct = 0.f, vt[kOut];
    auto reduce_step = [&](auto step_c, int tp) {
      constexpr int step = decltype(step_c)::value;
      if constexpr (step < kLogGroups) {
        sum_level<(kCols >> step)>(pend, kLanes << (kLogGroups - 1 - step),
                                   (g >> (kLogGroups - 1 - step)) & 1);
      } else if constexpr (step == kLogGroups) {
        ct = Cc[tp];
#pragma unroll
        for (int i = 0; i < kOut; ++i) vt[i] = Vc[tp * kD + vcol + i];
      } else if constexpr (step == kLogGroups + 1) {
#pragma unroll
        for (int i = 0; i < kOut; ++i)
          store_if(optr + i, fmaf(ct, vt[i], pend[i]), stores[i]);
        optr += p.o_ss;
      }
    };
    constexpr int kSteps = kLogGroups + 2;
    static_assert(kSteps <= kRows, "a reduction step after a row");
    const float4* R4 = reinterpret_cast<const float4*>(Rc);
    const float4* K4 = reinterpret_cast<const float4*>(Kc);
    const float4* W4 = reinterpret_cast<const float4*>(Wc);
    auto load_v = [&](int t, float (&x)[kCols]) {
      if constexpr (kCols % 4 == 0) {
#pragma unroll
        for (int c = 0; c < kCols; c += 4) {
          const float4 f = *reinterpret_cast<const float4*>(
              Vc + t * kD + cg * kCols + c);
          x[c] = f.x; x[c + 1] = f.y; x[c + 2] = f.z; x[c + 3] = f.w;
        }
      } else {
        const float2 f = load2(Vc + t * kD + cg * kCols);
        x[0] = f.x; x[1] = f.y;
      }
    };
    // The quad of rows after the one in use (or token t+1's first) is in
    // flight: its r, k and w are loaded one per row, so that no burst of
    // 16-byte loads stalls the updates.
    constexpr int kQuads = kRows / 4;
    float4 nr = R4[g], nk = K4[g], nw = W4[g];
    float vn[kCols];
    load_v(0, vn);
    auto token = [&](int t, auto reduce_prev) {
      constexpr bool kReduce = decltype(reduce_prev)::value;
      float v[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[c] = vn[c];
      const int tn = min(t + 1, nt - 1);
      float y[kCols][kParts];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
#pragma unroll
        for (int j = 0; j < kParts; ++j) y[c][j] = 0.f;
      }
      float4 rr, kk, ww;
      static_for<0, kRows>([&](auto i_c) {
        constexpr int i = decltype(i_c)::value;
        constexpr int q = i / 4, e = i % 4;
        // the next quad: q + 1 of this token, or the next token's first
        const int at = q + 1 < kQuads
            ? (t * kD) / 4 + (q + 1) * kGroups + (g ^ swizzle(q + 1))
            : (tn * kD) / 4 + g;
        if constexpr (e == 0) {
          rr = nr;
          kk = nk;
          ww = nw;
          nr = R4[at];
        } else if constexpr (e == 1) {
          nk = K4[at];
        } else if constexpr (e == 2) {
          nw = W4[at];
        }
        if constexpr (i == kRows - 2) load_v(tn, vn);
        const float ri = e == 0 ? rr.x : e == 1 ? rr.y : e == 2 ? rr.z : rr.w;
        const float ki = e == 0 ? kk.x : e == 1 ? kk.y : e == 2 ? kk.z : kk.w;
        const float wi = e == 0 ? ww.x : e == 1 ? ww.y : e == 2 ? ww.z : ww.w;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          y[c][i % kParts] = fmaf(ri, s[i][c], y[c][i % kParts]);
          if constexpr (kBf16) {
            // k v of two bf16 values is exact in float32: one FFMA
            // rounds (w S) + k v as the plain version does
            s[i][c] = fmaf(ki, v[c], __fmul_rn(wi, s[i][c]));
          } else {
            const float kv = __fmul_rn(ki, v[c]);
            s[i][c] = __fadd_rn(__fmul_rn(wi, s[i][c]), kv);
          }
        }
        // token t-1's sum: step k after row (k + 1) * kRows / kSteps - 1
        if constexpr (kReduce) {
          static_for<0, kSteps>([&](auto k_c) {
            constexpr int k = decltype(k_c)::value;
            if constexpr ((k + 1) * kRows / kSteps - 1 == i)
              reduce_step(k_c, t - 1);
          });
        }
      });
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        pend[c] = y[c][0];
#pragma unroll
        for (int j = 1; j < kParts; ++j) pend[c] += y[c][j];
      }
    };
    token(0, std::false_type{});
#pragma unroll 2
    for (int t = 1; t < nt; ++t) token(t, std::true_type{});
    static_for<0, kSteps>([&](auto st) { reduce_step(st, nt - 1); });
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int row = g * kRows + i, col = cg * kCols + c;
      if (row < D && col < D) p.sT[sbase + row * D + col] = s[i][c];
    }
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const int bytes = smem_bytes(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      wkv_token_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  wkv_token_kernel<T><<<p.B * p.H, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype of r, k, v and o: 0 = float32, 1 = bfloat16; w, u, s0 and sT are
// float32. Strides in elements, in the order (batch, sequence, head); the
// last axis of r, k, v, w and o must be contiguous. u (H, D), s0 and sT
// (B, H, D, D) contiguous; s0 may be null. D at most 64. r, k, v and w
// are read 16 bytes at a time: D * element size a multiple of 16, and
// their bases and strides multiples of 16 bytes (the wrapper checks).
extern "C" int rwkv6_forward(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, void* o, void* sT,
    int B, int S, int H, int D, int dtype,
    long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long w_sb, long long w_ss, long long w_sh,
    long long o_sb, long long o_ss, long long o_sh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > kD || D % 4 != 0)
    return cudaErrorInvalidValue;
  Params p{r, k, v, static_cast<const float*>(w),
           static_cast<const float*>(u), static_cast<const float*>(s0),
           o, static_cast<float*>(sT), B, S, H, D,
           r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           w_sb, w_ss, w_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(p, s);
    case 1:
      if (D % 8 != 0) return cudaErrorInvalidValue;
      return launch<__nv_bfloat16>(p, s);
  }
  return cudaErrorInvalidValue;
}
