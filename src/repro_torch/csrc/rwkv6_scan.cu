// RWKV6 chunked linear-attention scan from a zero state, hand-written for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rwkv6_scan/kernel.py, `_rwkv_kernel`
// (launched by `rwkv6_scan_kernel`), the Pallas TPU kernel for the
// chunk-local part of the RWKV6 time mix: in the port it runs once per
// layer in every one-shot prefill of an RWKV6 model.
//
// Computes, for r, k, v, logw [B,S,H,N] fp32 (logw < 0) and u [H,N] fp32,
// y [B,S,H,N] and the final state [B,H,N,N], both fp32, from S = 0:
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
//   y_t = r_t (diag(u) k_t v_t^T + S_{t-1})
// in chunks of C positions.  With cum the inclusive prefix sum of logw
// inside the chunk, cum_ex = cum - logw and total = cum[C-1]:
//   y_t = (r_t * e^{cum_ex_t}) S + sum_{s<t} A_ts v_s + (r_t . u . k_t) v_t
//   A_ts = sum_n r_tn k_sn e^{cum_ex_tn - cum_sn}
//   S   <- e^{total} * S + sum_s (k_s * e^{total - cum_s}) v_s^T
// All exponents are taken in base 2, on log2(e) * logw, and every one of
// them is <= 0, so no factor exceeds 1 however strong the decay (factoring
// A's exponent into e^{cum_ex_t} * e^{-cum_s} would overflow fp32).
//
// Sub-chunked scores.  Each chunk is cut into sub-chunks of 16 positions.
// For s in sub-chunk i and t in sub-chunk j > i the decay factors through
// ref_j = cum_ex at the first row of sub-chunk j:
//   e^{cum_ex_t - cum_s} = e^{cum_ex_t - ref_j} * e^{ref_j - cum_s},
// both exponents <= 0, so the off-diagonal 16x16 score blocks are products
// of decayed r and k.  Only the diagonal blocks (120 pairs s < t of 2016
// per 64-position chunk, 480 of them) keep one exponential per (t, s, n).
//
// What bounds it on an H100: by chip_smoke.py's yardstick, at the serving
// path's prefill shape (r [16,256,40,64], chunk 64), operations and bytes
// about equally: the sub-chunked algorithm's 4.3 GFLOP of fp32 and 0.12 G
// exponentials take 0.066 ms at 67 TFLOP/s, and the 220 MB it moves (r, k,
// v, logw in, y and the state out) 0.066 ms at 3.35 TB/s.  Its
// exponentials take 0.03 ms on the MUFU at 16 a clock per SM, and its
// products run on the tensor cores.  The design before it
// (0.63 ms) read about one
// shared-memory word per FMA in its score phase and three [64,64]x[64,64]
// products on the CUDA cores.  Measured (NVIDIA H100 80GB HBM3, 700 W): 0.21
// ms.  Builds that skip one phase each put the diagonal blocks and the
// y products first, then the state update and the loads, prefix sum and
// barriers; 640 blocks at two per SM make 2.4 waves, so the third wave
// runs 40% full.
//
// What this design does about it: one block of 8 warps per (h, b) (640
// blocks at the serving shape, two resident per SM) walks the chunks in
// order with the [N,N] state in shared memory.  Per chunk:
//   1. r, k, v and logw arrive by 16-byte cp.async; the prefix sum of
//      log2(e) * logw runs on all 256 threads (segments, then offsets);
//   2. the diagonal score blocks on the CUDA cores: each thread takes two
//      rows (p, 15 - p) of one sub-chunk, so every warp does 15 row pairs,
//      over an n-slice, and a butterfly reduce-scatter of the 32 partial
//      row entries across the slice lanes; then six warps run the
//      off-diagonal blocks on the tensor cores, decaying r and k as they
//      load the fragments;
//   3. r <- r e^{cum_ex}, k <- k e^{total - cum} in place;
//   4. y = r S + A v (A lower-triangular: its k-steps stop at the
//      diagonal; each warp takes the m-tiles i and C/16-1-i so that warps
//      do equal work), then S <- e^{total} S + k^T v, written after a
//      barrier.
// The products are warp-level mma.sync m16n8k8 TF32 with fp32 sums.  Each
// operand is split into hi, its TF32 cut (one AND), and lo = x - hi (exact,
// read by the tensor core as TF32 in turn); three products are summed,
// lo.hi + hi.lo into one accumulator and hi.hi into another ("3xTF32").  A
// CPU emulation of this decomposition (tests/test_torch_kernels.py) holds
// 2e-3 with it (2.3e-5) and misses with one TF32 product (up to 1.5e-2).
// Rows are padded so that fragment reads are free of bank conflicts (N + 4
// floats for rows read along n, N + 8 for rows read along the reduction),
// but for the state update's transposed read of k (two-way).
// Every array index in the diagonal phase is a constant after unrolling: a
// runtime index put its 32 partial sums in local memory (0.27 ms).  Rows
// past S (the ragged last chunk) load k = v = r = 0 and a decay of 1
// (cp.async's zero fill), so the state passes through them unchanged and
// their outputs are not written.
//
// C interface (ctypes): repro_rwkv6_scan returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SUB = 16;  // positions per sub-chunk = rows of an mma tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t MAX_SMEM = 232448;  // per-block dynamic limit on sm_90

// Shared-memory layout (floats).
template <int N, int C>
struct Layout {
  static constexpr int LA = N + 4;   // rows read along n (A fragments)
  static constexpr int LB = N + 8;   // rows read along the reduction (B)
  static constexpr int LS = C + 4;   // score rows
  static constexpr int SEG = THREADS / N;      // prefix-sum segments
  static constexpr int R = 0;                  // r, then r e^{cum_ex} [C][LA]
  static constexpr int K = R + C * LA;         // k, then k e^{total-cum}
  static constexpr int V = K + C * LA;         // v [C][LB]
  static constexpr int CUM = V + C * LB;       // [C+1][LA]: row 0 = 0, row
                                               //   t+1 = cum_t (log2 units)
  static constexpr int SC = CUM + (C + 1) * LA;  // scores, s <= t [C][LS]
  static constexpr int ST = SC + C * LS;       // state [N][LB]
  static constexpr int U = ST + N * LB;        // bonus u [N]
  static constexpr int TOT = U + N;            // segment sums [SEG][N]
  static constexpr int FLOATS = TOT + SEG * N;
};

__host__ __device__ constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// c ? a : b on values: a select the compiler cannot turn into a runtime
// index of the array a and b come from
__device__ __forceinline__ float sel(bool c, float a, float b) {
  float y;
  asm("{.reg .pred p; setp.ne.b32 p, %3, 0; selp.f32 %0, %1, %2, p;}"
      : "=f"(y) : "f"(a), "f"(b), "r"((int)c));
  return y;
}

// x = hi + lo: hi is x cut to TF32 (its low 13 mantissa bits cleared), lo =
// x - hi is exact in fp32 and goes to the tensor core as it is, which reads
// its top 19 bits: lo's error is under 2^-10 |lo| < 2^-20 |x|
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of a 16x8 tile (rows m, columns k) split into hi / lo
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(const float* x) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
  }
};

// B fragment of an 8x8 tile (rows k, columns n) split into hi / lo
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float x0, float x1) {
    split(x0, hi[0], lo[0]);
    split(x1, hi[1], lo[1]);
  }
};

// d + dc += a b in 3xTF32: the two small products go to their own sum dc,
// so that the three products of a tile are not one dependent chain
__device__ __forceinline__ void mma3(float* d, float* dc, const FragA& a,
                                     const FragB& b) {
  mma(dc, a.lo, b.hi);
  mma(dc, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

template <int M>
__device__ __forceinline__ void fold(float (*d)[4], float (*dc)[4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] += dc[i][e];
}

// A fragment from a row-major [m][k] array: lane (g, q) holds (g, q),
// (g + 8, q), (g, q + 4), (g + 8, q + 4)
__device__ __forceinline__ void load_a(FragA& f, const float* x, int ld,
                                       int g, int q) {
  const float v[4] = {x[g * ld + q], x[(g + 8) * ld + q],
                      x[g * ld + q + 4], x[(g + 8) * ld + q + 4]};
  f.set(v);
}

// B fragment from a row-major [k][n] array: (q, g), (q + 4, g)
__device__ __forceinline__ void load_b(FragB& f, const float* x, int ld,
                                       int g, int q) {
  f.set(x[q * ld + g], x[(q + 4) * ld + g]);
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

template <int N, int C>
__global__ void __launch_bounds__(THREADS, N <= 64 ? 2 : 1)
rwkv6_chunked(const float* __restrict__ r, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ logw,
              const float* __restrict__ u, float* __restrict__ y,
              float* __restrict__ state, int S, int H) {
  using L = Layout<N, C>;
  constexpr int LA = L::LA, LB = L::LB, LS = L::LS, SEG = L::SEG;
  constexpr int MT = C / SUB;              // sub-chunks = 16-row m-tiles
  constexpr int NV = N / 4;                // float4 per row
  // diagonal blocks: MT * 8 row pairs, NSL lanes (an n-slice of NPS
  // columns each) per pair
  constexpr int NSL = THREADS / (MT * 8);
  constexpr int NPS = N / NSL;
  constexpr int STEPS = log2i(NSL);          // butterfly steps
  static_assert((1 << STEPS) == NSL, "NSL is a power of two");
  // y jobs: m-tiles {i, MT-1-i} (one m-tile when MT is 1) x 2 n-tiles
  constexpr int NPAIR = MT > 1 ? MT / 2 : 1;
  constexpr int YJOBS = NPAIR * (N / 16);
  // state jobs: one 16-row m-tile x 4 n-tiles, all held until the barrier
  constexpr int SJOBS = (N / 16) * (N / 32);
  constexpr int SJW = (SJOBS + WARPS - 1) / WARPS;
  static_assert(N % 32 == 0 && C % SUB == 0 && C % SEG == 0, "shape");
  static_assert(NSL >= 1 && NSL <= 32 && N % NSL == 0, "diagonal split");

  extern __shared__ __align__(16) float smem[];
  float* rs = smem + L::R;
  float* ks = smem + L::K;
  float* vs = smem + L::V;
  float* cum = smem + L::CUM;
  float* sc = smem + L::SC;
  float* ss = smem + L::ST;
  float* us = smem + L::U;
  float* tot = smem + L::TOT;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;    // mma fragment coordinates
  const size_t pos_stride = (size_t)H * N;            // one position
  const size_t base = ((size_t)b * S * H + h) * N;    // (b, 0, h, 0)

  for (int i = tid; i < N * LB; i += THREADS) ss[i] = 0.f;
  for (int i = tid; i < N; i += THREADS) {
    us[i] = u[(size_t)h * N + i];
    cum[i] = 0.f;                                     // row 0 stays 0
  }

  for (int c0 = 0; c0 < S; c0 += C) {
    const int len = min(C, S - c0);
    __syncthreads();  // the previous chunk's readers are done

    // 1. stage r, k, v, logw; rows past S are zero (logw 0: decay 1)
    for (int i = tid; i < C * NV; i += THREADS) {
      const int t = i / NV, n = (i % NV) * 4;
      const bool ok = t < len;
      const size_t off = ok ? base + (size_t)(c0 + t) * pos_stride + n : 0;
      cp16(rs + t * LA + n, r + off, ok);
      cp16(ks + t * LA + n, k + off, ok);
      cp16(vs + t * LB + n, v + off, ok);
      cp16(cum + (t + 1) * LA + n, logw + off, ok);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                     : "memory");
    __syncthreads();

    // inclusive prefix sum of log2(e) * logw down each column: SEG
    // segments of C / SEG rows, each summed in registers, then each adds
    // the sums of the segments before it
    {
      constexpr int SL = C / SEG;
      const int n = tid % N, sg = tid / N;
      float* col = cum + (1 + sg * SL) * LA + n;
      float w[SL];
#pragma unroll
      for (int i = 0; i < SL; ++i) w[i] = col[i * LA] * LOG2E;
#pragma unroll
      for (int i = 1; i < SL; ++i) w[i] += w[i - 1];
      tot[sg * N + n] = w[SL - 1];
      __syncthreads();
      float off = 0.f;
      for (int i = 0; i < sg; ++i) off += tot[i * N + n];
#pragma unroll
      for (int i = 0; i < SL; ++i) col[i * LA] = w[i] + off;
      __syncthreads();
    }

    // 2a. diagonal blocks: thread (p, j, slice) takes rows t1 = 16j + p and
    // t2 = 16j + 15 - p of sub-chunk j (p is the same across a warp, so its
    // loop bounds are uniform), columns n0 .. n0 + NPS - 1
    {
      const int pi = tid / NSL, sl = tid % NSL;
      const int j = pi % MT, p = pi / MT;
      const int t1 = j * SUB + p, t2 = j * SUB + SUB - 1 - p;
      const int n0 = sl * NPS;
      float r1[NPS], e1[NPS], r2[NPS], e2[NPS];
#pragma unroll
      for (int i = 0; i < NPS; ++i) {
        r1[i] = rs[t1 * LA + n0 + i];
        e1[i] = cum[t1 * LA + n0 + i];             // cum_ex_t1
        r2[i] = rs[t2 * LA + n0 + i];
        e2[i] = cum[t2 * LA + n0 + i];
      }
      // part[0..15]: row t1, part[16..31]: row t2, by s - 16j; s == t is
      // the bonus term r_t . u . k_t.  Every index into part is a constant
      // (a runtime one would put the array in local memory).
      float part[2 * SUB];
#pragma unroll
      for (int s = 0; s < SUB; ++s) {
        float a1 = 0.f, a2 = 0.f;
        if (s <= SUB - 1 - p) {                    // uniform across the warp
          const float* kr = ks + (j * SUB + s) * LA + n0;
          const float* cr = cum + (j * SUB + s + 1) * LA + n0;  // cum_s
          if (s < SUB - 1 - p) {
#pragma unroll
            for (int i = 0; i < NPS; ++i)
              a2 = fmaf(r2[i] * kr[i], ex2(fminf(e2[i] - cr[i], 0.f)), a2);
          } else {
#pragma unroll
            for (int i = 0; i < NPS; ++i)
              a2 = fmaf(r2[i] * us[n0 + i], kr[i], a2);
          }
          if (s < p) {
#pragma unroll
            for (int i = 0; i < NPS; ++i)
              a1 = fmaf(r1[i] * kr[i], ex2(fminf(e1[i] - cr[i], 0.f)), a1);
          } else if (s == p) {
#pragma unroll
            for (int i = 0; i < NPS; ++i)
              a1 = fmaf(r1[i] * us[n0 + i], kr[i], a1);
          }
        }
        part[s] = a1;
        part[SUB + s] = a2;
      }
      // butterfly reduce-scatter over the NSL lanes of the pair: each step
      // halves the entries a lane holds; lane sl ends with 32 / NSL
      // consecutive entries, summed over all n
      int first = 0;
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const int m = NSL >> (st + 1), half = SUB >> st;
        const bool up = sl & m;
#pragma unroll
        for (int i = 0; i < SUB; ++i) {
          if (i < half) {
            const float send = sel(up, part[i], part[i + half]);
            const float keep = sel(up, part[i + half], part[i]);
            part[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
          }
        }
        if (up) first += half;
      }
#pragma unroll
      for (int i = 0; i < 2 * SUB / NSL; ++i) {
        const int e = first + i;
        const int t = e < SUB ? t1 : t2;
        sc[t * LS + j * SUB + (e % SUB)] = part[i];
      }
    }

    // 2b. off-diagonal blocks (i < j) on the tensor cores: A[t][s] =
    // (r_t e^{cum_ex_t - ref_j}) . (k_s e^{ref_j - cum_s}), ref_j = cum_ex
    // at row 16j; the decays are applied as the fragments are loaded
    for (int blk = warp; blk < MT * (MT - 1) / 2; blk += WARPS) {
      int j = 1, i = blk;
      while (i >= j) i -= j++;
      const float* ref = cum + j * SUB * LA;
      float acc[2][4] = {}, cor[2][4] = {};
#pragma unroll 2
      for (int n0 = 0; n0 < N; n0 += 8) {
        const float* rr = rs + j * SUB * LA + n0;
        const float* ce = cum + j * SUB * LA + n0;
        const float rf0 = ref[n0 + q], rf1 = ref[n0 + q + 4];
        float x[4];
        x[0] = rr[g * LA + q] * ex2(fminf(ce[g * LA + q] - rf0, 0.f));
        x[1] = rr[(g + 8) * LA + q] *
               ex2(fminf(ce[(g + 8) * LA + q] - rf0, 0.f));
        x[2] = rr[g * LA + q + 4] * ex2(fminf(ce[g * LA + q + 4] - rf1, 0.f));
        x[3] = rr[(g + 8) * LA + q + 4] *
               ex2(fminf(ce[(g + 8) * LA + q + 4] - rf1, 0.f));
        FragA fa;
        fa.set(x);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int s = i * SUB + nt * 8 + g;
          const float* kr = ks + s * LA + n0;
          const float* cs = cum + (s + 1) * LA + n0;            // cum_s
          FragB fb;
          fb.set(kr[q] * ex2(fminf(rf0 - cs[q], 0.f)),
                 kr[q + 4] * ex2(fminf(rf1 - cs[q + 4], 0.f)));
          mma3(acc[nt], cor[nt], fa, fb);
        }
      }
      fold<2>(acc, cor);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float* o = sc + (j * SUB + g) * LS + i * SUB + nt * 8 + 2 * q;
        o[0] = acc[nt][0];
        o[1] = acc[nt][1];
        o[8 * LS] = acc[nt][2];
        o[8 * LS + 1] = acc[nt][3];
      }
    }
    __syncthreads();

    // 3. r <- r * e^{cum_ex}, k <- k * e^{total - cum} (both exponents <= 0)
    for (int i = tid; i < C * N; i += THREADS) {
      const int t = i / N, n = i % N;
      rs[t * LA + n] *= ex2(fminf(cum[t * LA + n], 0.f));
      ks[t * LA + n] *= ex2(fminf(cum[C * LA + n] - cum[(t + 1) * LA + n],
                                  0.f));
    }
    __syncthreads();

    // 4a. y = r_dec S + A v, 16x16 output blocks of m-tiles {i, MT-1-i}
    for (int job = warp; job < YJOBS; job += WARPS) {
      const int pr = job % NPAIR, n0 = (job / NPAIR) * 16;
      const int mt[2] = {pr, MT - 1 - pr};
      constexpr int NM = MT > 1 ? 2 : 1;
      float acc[2][2][4] = {}, cor[2][2][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < N; kk += 8) {
        FragB fb[2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          load_b(fb[nt], ss + kk * LB + n0 + nt * 8, LB, g, q);
#pragma unroll
        for (int mi = 0; mi < NM; ++mi) {
          FragA fa;
          load_a(fa, rs + mt[mi] * SUB * LA + kk, LA, g, q);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma3(acc[mi][nt], cor[mi][nt], fa, fb[nt]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < NM; ++mi) {
        for (int s0 = 0; s0 < (mt[mi] + 1) * SUB; s0 += 8) {
          FragA fa;
          load_a(fa, sc + mt[mi] * SUB * LS + s0, LS, g, q);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            FragB fb;
            load_b(fb, vs + s0 * LB + n0 + nt * 8, LB, g, q);
            mma3(acc[mi][nt], cor[mi][nt], fa, fb);
          }
        }
        fold<2>(acc[mi], cor[mi]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int t = mt[mi] * SUB + g, n = n0 + nt * 8 + 2 * q;
          if (t < len)
            *reinterpret_cast<float2*>(y + base + (size_t)(c0 + t) * pos_stride
                                       + n) =
                make_float2(acc[mi][nt][0], acc[mi][nt][1]);
          if (t + 8 < len)
            *reinterpret_cast<float2*>(y + base +
                                       (size_t)(c0 + t + 8) * pos_stride + n) =
                make_float2(acc[mi][nt][2], acc[mi][nt][3]);
        }
      }
    }

    // 4b. S[n][m] <- e^{total_n} S[n][m] + sum_s k_dec[s][n] v[s][m], held
    // in registers until every reader of the old state is done
    float sacc[SJW][4][4];
#pragma unroll
    for (int jw = 0; jw < SJW; ++jw) {
      const int job = warp + jw * WARPS;
      if (job >= SJOBS) break;
      const int m0 = (job % (N / 16)) * 16, n0 = (job / (N / 16)) * 32;
      const float d0 = ex2(fminf(cum[C * LA + m0 + g], 0.f));
      const float d1 = ex2(fminf(cum[C * LA + m0 + g + 8], 0.f));
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* so = ss + (m0 + g) * LB + n0 + nt * 8 + 2 * q;
        sacc[jw][nt][0] = d0 * so[0];
        sacc[jw][nt][1] = d0 * so[1];
        sacc[jw][nt][2] = d1 * so[8 * LB];
        sacc[jw][nt][3] = d1 * so[8 * LB + 1];
      }
      float cor[4][4] = {};
      for (int s0 = 0; s0 < len; s0 += 8) {
        // A[n][s] = k_dec[s][n]: the transpose of a row-major [s][n] array
        const float* kb = ks + s0 * LA + m0;
        const float x[4] = {kb[q * LA + g], kb[q * LA + g + 8],
                            kb[(q + 4) * LA + g], kb[(q + 4) * LA + g + 8]};
        FragA fa;
        fa.set(x);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          FragB fb;
          load_b(fb, vs + s0 * LB + n0 + nt * 8, LB, g, q);
          mma3(sacc[jw][nt], cor[nt], fa, fb);
        }
      }
      fold<4>(sacc[jw], cor);
    }
    __syncthreads();  // every reader of the old state is done
#pragma unroll
    for (int jw = 0; jw < SJW; ++jw) {
      const int job = warp + jw * WARPS;
      if (job >= SJOBS) break;
      const int m0 = (job % (N / 16)) * 16, n0 = (job / (N / 16)) * 32;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float* so = ss + (m0 + g) * LB + n0 + nt * 8 + 2 * q;
        *reinterpret_cast<float2*>(so) =
            make_float2(sacc[jw][nt][0], sacc[jw][nt][1]);
        *reinterpret_cast<float2*>(so + 8 * LB) =
            make_float2(sacc[jw][nt][2], sacc[jw][nt][3]);
      }
    }
  }
  __syncthreads();

  float* out = state + ((size_t)b * H + h) * N * N;
  for (int i = tid; i < N * N; i += THREADS) out[i] = ss[(i / N) * LB + i % N];
}

template <int N, int C>
int launch(const float* r, const float* k, const float* v, const float* logw,
           const float* u, float* y, float* state, int B, int S, int H,
           cudaStream_t stream) {
  const size_t bytes = Layout<N, C>::FLOATS * sizeof(float);
  static_assert(Layout<N, C>::FLOATS * sizeof(float) <= MAX_SMEM,
                "shared memory");
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_chunked<N, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(H, B);
  rwkv6_chunked<N, C><<<grid, THREADS, bytes, stream>>>(r, k, v, logw, u, y,
                                                        state, S, H);
  return (int)cudaGetLastError();
}

template <int N>
int launch_n(const float* r, const float* k, const float* v,
             const float* logw, const float* u, float* y, float* state,
             int B, int S, int H, int chunk, cudaStream_t st) {
  switch (chunk) {
    case 16: return launch<N, 16>(r, k, v, logw, u, y, state, B, S, H, st);
    case 32: return launch<N, 32>(r, k, v, logw, u, y, state, B, S, H, st);
    case 64: return launch<N, 64>(r, k, v, logw, u, y, state, B, S, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, logw, y: [B,S,H,N] fp32, contiguous and 16-byte aligned; u: [H,N];
// state: [B,H,N,N].  N in {32, 64, 128}; chunk in {16, 32, 64}.
extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                                const void* logw, const void* u, void* y,
                                void* state, int B, int S, int H, int N,
                                int chunk, void* stream) {
  if (B <= 0 || S < 0 || H <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const float* r_ = static_cast<const float*>(r);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* w_ = static_cast<const float*>(logw);
  const float* u_ = static_cast<const float*>(u);
  float* y_ = static_cast<float*>(y);
  float* s_ = static_cast<float*>(state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 32:
      return launch_n<32>(r_, k_, v_, w_, u_, y_, s_, B, S, H, chunk, st);
    case 64:
      return launch_n<64>(r_, k_, v_, w_, u_, y_, s_, B, S, H, chunk, st);
    case 128:
      return launch_n<128>(r_, k_, v_, w_, u_, y_, s_, B, S, H, chunk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
