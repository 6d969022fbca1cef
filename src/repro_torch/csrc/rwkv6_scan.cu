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
// The exponent of A stays one difference per (t, s, n): it is <= 0, so
// e^x <= 1 however strong the decay.  Factoring it into
// e^{cum_ex_t} * e^{-cum_s} overflows fp32 under strong decay.  All
// exponents are taken in base 2, on log2(e) * logw.
//
// What bounds it on an H100: operations.  At the serving path's prefill
// shape (r [16,256,40,64], chunk 64) the kernel moves 220 MB (r, k, v,
// logw in, y and the state out): 0.066 ms at 3.35 TB/s.  It computes
// about 4.7 GFLOP of fp32 and 0.35 G exponentials (the s < t pairs of
// each chunk take one each): about 0.075 ms at 67 TFLOP/s on the CUDA
// cores.  chip_smoke.py computes both from the shapes it runs.
//
// What this design does about it: one block per (h, b) (640 blocks at the
// serving shape, two resident per SM) walks the chunks in order, in place
// of the TPU's sequential grid axis, with the [N,N] state in shared
// memory.  Each chunk stages r, k, v and the prefix-summed log decay in
// shared memory (the exclusive sum of row t is the inclusive sum of row
// t - 1, so cum_ex takes no tile of its own: 100 KB at N 64, C 64),
// computes only the s <= t half of the score matrix, and then the output
// and the state update as register-tiled products.  Rows past S (the
// ragged last chunk) load k = v = 0 and a decay of 1, so the state passes
// through them unchanged and their outputs are not written.  Everything
// runs in fp32 on the CUDA cores; the exponentials of the score matrix
// (one per (t, s, n)) are what keeps it from the tensor cores, and a
// wgmma/TMA formulation is later work.
//
// C interface (ctypes): repro_rwkv6_scan returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t MAX_SMEM = 232448;  // per-block dynamic limit on sm_90

// Shared-memory layout (floats).  Rows are padded to N + 1 so that threads
// reading one column of different rows hit different banks.
template <int N, int C>
struct Layout {
  static constexpr int LD = N + 1;
  static constexpr int R = 0;                  // [C][LD]: r, then r e^{cum_ex}
  static constexpr int K = R + C * LD;         // [C][LD]: k, then
                                               //   k e^{total - cum}
  static constexpr int V = K + C * LD;         // v [C][LD]
  static constexpr int CUM = V + C * LD;       // [C+1][LD]: row 0 = 0, row t+1
                                               //   = cum_t (log2 units)
  static constexpr int A = CUM + (C + 1) * LD; // scores, s <= t [C][C+1]
  static constexpr int ST = A + C * (C + 1);   // state [N][N]
  static constexpr int U = ST + N * N;         // bonus u [N]
  static constexpr int FLOATS = U + N;
};

// Two blocks per SM fit the shared memory up to N 64 (100 KB each at C 64):
// ask the compiler to keep registers within that too.
template <int N, int C>
__global__ void __launch_bounds__(THREADS, N <= 64 ? 2 : 1)
rwkv6_chunked(const float* __restrict__ r, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ logw,
              const float* __restrict__ u, float* __restrict__ y,
              float* __restrict__ state, int S, int H) {
  using L = Layout<N, C>;
  constexpr int LD = L::LD;
  constexpr int G = THREADS / N;  // row groups: a warp is one group
  constexpr int RT = C / G;       // output rows per thread
  constexpr int RS = N / G;       // state rows per thread
  constexpr int RB = RS < 16 ? RS : 16;  // state rows per register batch
  constexpr int NV = N / 4;       // float4 per row
  static_assert(N % 32 == 0 && C % G == 0 && RS % RB == 0, "shape");

  extern __shared__ __align__(16) float smem[];
  float* rs = smem + L::R;
  float* ks = smem + L::K;
  float* vs = smem + L::V;
  float* cum = smem + L::CUM;
  float* as = smem + L::A;
  float* ss = smem + L::ST;
  float* us = smem + L::U;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int m = tid % N, g = tid / N;
  const size_t pos_stride = (size_t)H * N;            // one position
  const size_t base = ((size_t)b * S * H + h) * N;    // (b, 0, h, 0)

  for (int i = tid; i < N * N; i += THREADS) ss[i] = 0.f;
  for (int i = tid; i < N; i += THREADS) {
    us[i] = u[(size_t)h * N + i];
    cum[i] = 0.f;                                     // row 0 stays 0
  }

  for (int c0 = 0; c0 < S; c0 += C) {
    const int len = min(C, S - c0);
    __syncthreads();  // the previous chunk's readers are done

    // stage r, k, v and log2(e) * logw; rows past S are k = v = r = 0 and
    // a decay of 1
    for (int i = tid; i < C * NV; i += THREADS) {
      const int t = i / NV, n = (i % NV) * 4;
      float4 rv = make_float4(0.f, 0.f, 0.f, 0.f), kv = rv, vv = rv, wv = rv;
      if (t < len) {
        const size_t off = base + (size_t)(c0 + t) * pos_stride + n;
        rv = *reinterpret_cast<const float4*>(r + off);
        kv = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
        wv = *reinterpret_cast<const float4*>(logw + off);
      }
      float* rr = rs + t * LD + n;
      float* kr = ks + t * LD + n;
      float* vr = vs + t * LD + n;
      float* wr = cum + (t + 1) * LD + n;
      rr[0] = rv.x; rr[1] = rv.y; rr[2] = rv.z; rr[3] = rv.w;
      kr[0] = kv.x; kr[1] = kv.y; kr[2] = kv.z; kr[3] = kv.w;
      vr[0] = vv.x; vr[1] = vv.y; vr[2] = vv.z; vr[3] = vv.w;
      wr[0] = wv.x * LOG2E; wr[1] = wv.y * LOG2E;
      wr[2] = wv.z * LOG2E; wr[3] = wv.w * LOG2E;
    }
    __syncthreads();

    // inclusive prefix sum of the log decay down each column
    for (int n = tid; n < N; n += THREADS) {
      float acc = 0.f;
      for (int t = 1; t <= C; ++t) {
        acc += cum[t * LD + n];
        cum[t * LD + n] = acc;
      }
    }
    __syncthreads();

    // scores A[t][s] for s <= t (s == t: the bonus term r . u . k)
    constexpr int P = C * (C + 1) / 2;
    for (int p = tid; p < P; p += THREADS) {
      int t = (int)((sqrtf(8.f * (float)p + 1.f) - 1.f) * 0.5f);
      while (t * (t + 1) / 2 > p) --t;
      while ((t + 1) * (t + 2) / 2 <= p) ++t;
      const int s = p - t * (t + 1) / 2;
      float acc = 0.f;
      if (t < len) {
        const float* rt = rs + t * LD;
        const float* kt = ks + s * LD;
        if (s == t) {
          for (int n = 0; n < N; ++n) acc = fmaf(rt[n] * us[n], kt[n], acc);
        } else {
          const float* ce = cum + t * LD;        // cum_ex_t
          const float* cs = cum + (s + 1) * LD;  // cum_s
          for (int n = 0; n < N; ++n)
            acc = fmaf(rt[n] * kt[n], exp2f(fminf(ce[n] - cs[n], 0.f)), acc);
        }
      }
      as[t * (C + 1) + s] = acc;
    }
    __syncthreads();

    // r <- r * e^{cum_ex}, k <- k * e^{total - cum} (both exponents <= 0)
    for (int i = tid; i < C * N; i += THREADS) {
      const int t = i / N, n = i % N;
      rs[t * LD + n] *= exp2f(cum[t * LD + n]);
      ks[t * LD + n] *= exp2f(cum[C * LD + n] - cum[(t + 1) * LD + n]);
    }
    __syncthreads();

    // y[t][m] = sum_n r_dec[t][n] S[n][m] + sum_{s<=t} A[t][s] v[s][m]
    {
      float acc[RT];
#pragma unroll
      for (int j = 0; j < RT; ++j) acc[j] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float sv = ss[n * N + m];
#pragma unroll
        for (int j = 0; j < RT; ++j)
          acc[j] = fmaf(rs[(g + j * G) * LD + n], sv, acc[j]);
      }
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int t = g + j * G;
        if (t >= len) continue;
        const float* at = as + t * (C + 1);
        float a = acc[j];
        for (int s = 0; s <= t; ++s) a = fmaf(at[s], vs[s * LD + m], a);
        y[base + (size_t)(c0 + t) * pos_stride + m] = a;
      }
    }
    __syncthreads();  // every reader of the old state is done

    // S[n][m] <- e^{total_n} S[n][m] + sum_s k_dec[s][n] v[s][m]
    for (int n0 = 0; n0 < RS; n0 += RB) {
      float acc[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const int n = g + (n0 + j) * G;
        acc[j] = exp2f(cum[C * LD + n]) * ss[n * N + m];
      }
      for (int s = 0; s < len; ++s) {
        const float vv = vs[s * LD + m];
#pragma unroll
        for (int j = 0; j < RB; ++j)
          acc[j] = fmaf(ks[s * LD + g + (n0 + j) * G], vv, acc[j]);
      }
#pragma unroll
      for (int j = 0; j < RB; ++j) ss[(g + (n0 + j) * G) * N + m] = acc[j];
    }
  }
  __syncthreads();

  float* out = state + ((size_t)b * H + h) * N * N;
  for (int i = tid; i < N * N; i += THREADS) out[i] = ss[i];
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
