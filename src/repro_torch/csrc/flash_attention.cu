// Flash attention forward over contiguous positions, hand-written for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, `_attn_kernel`
// (launched by `flash_attention_kernel`), the Pallas TPU kernel that runs
// the prefill attention of every genserve admission.
//
// Computes, for q [B,S,H,hd] and k/v [B,S,KV,hd] (fp32 or bf16), out
// [B,S,H,hd] in q's dtype: s = (q.k) / sqrt(hd); optional cap*tanh(s/cap);
// masked to NEG_INF (finite, -1e30) where k >= S, or causal and q < k, or
// windowed and q - k >= window; online softmax with fp32 running max,
// denominator and accumulator; GQA head h reads kv head h / (H/KV).
//
// What bounds it on an H100: at the serving path's prefill shape
// (B=16, S=256, H=16, KV=8, hd=128, bf16, causal) the function must move
// 50.3 MB (q, k, v read once, out written once), 15 us at 3.35 TB/s, and
// do 4.3 GFLOP on the unmasked (causal) pairs, 4.4 us at the 989 TFLOP/s
// bf16 tensor-core peak: the roofline bound is the bytes.
//
// What this design does about it: it is the simple, correct first kernel.
// One block of 256 threads owns a 64-row query tile of one (b, h) and loops
// over 64-row key tiles staged in shared memory as fp32, so every K/V byte
// is read once per query tile rather than once per query row.  Key tiles
// that causal or window masking leave fully masked are skipped (a block
// only reaches later tiles after a real score has set the running max, and
// a masked entry's weight exp(-1e30 - m) is exactly 0, so skipping does not
// change the numbers).  The ragged edge (k >= S, q >= S) is masked in the
// kernel, with no padding in Python.  Products run on the CUDA cores in
// fp32 FMA (67 TFLOP/s peak), so this version is bounded by arithmetic at
// about 64 us, not by bytes: moving QK^T and PV onto wgmma with TMA-fed
// tiles is the later step toward the 15 us bound.
//
// Shared memory: Q^T and K^T tiles (padded rows), V tile, the score tile
// and per-row (m, l, corr): 117 KB for hd=128, above the 48 KB static
// limit, so the launcher raises the dynamic limit with
// cudaFuncSetAttribute once per instantiation.
//
// C interface (ctypes): repro_flash_attention returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key rows per shared-memory tile
constexpr int THREADS = 256;
constexpr int PAD = 4;       // keeps transposed rows 16-byte aligned

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)HD * (BQ + PAD) + (size_t)HD * (BK + PAD) + (size_t)BK * HD +
         (size_t)BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int S, int H, int KV,
          int causal, int window, float cap, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                        // [HD][BQ + PAD]  (transposed)
  float* Kt = Qt + HD * (BQ + PAD);        // [HD][BK + PAD]  (transposed)
  float* Vs = Kt + HD * (BK + PAD);        // [BK][HD]
  float* Ss = Vs + BK * HD;                // [BQ][BK + 1]
  float* m_s = Ss + BQ * (BK + 1);         // [BQ] running max
  float* l_s = m_s + BQ;                   // [BQ] running denominator
  float* c_s = l_s + BQ;                   // [BQ] this tile's correction

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * BQ;

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    const int qi = q0 + r;
    float x = 0.f;
    if (qi < S) x = to_f(q[(((size_t)b * S + qi) * H + h) * HD + d]);
    Qt[d * (BQ + PAD) + r] = x;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  // scores: thread (ty, tx) owns rows ty*4+i and key columns tx*4+j;
  // output: rows ty*4+i and head-dim columns tx + 16*j
  const int ty = tid / 16, tx = tid % 16;
  constexpr int CPT = HD / 16;
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + BQ, S) - 1;
  const int n_kt = (S + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    if (causal && k0 > q_last) break;                          // all k > q
    if (window > 0 && q0 - (k0 + BK - 1) >= window) continue;  // all out
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int r = idx / HD, d = idx % HD;
      const int ki = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (ki < S) {
        const size_t off = (((size_t)b * S + ki) * KV + kvh) * HD + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      Kt[d * (BK + PAD) + r] = kx;
      Vs[r * HD + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa =
          *reinterpret_cast<const float4*>(&Qt[d * (BQ + PAD) + ty * 4]);
      const float4 ka =
          *reinterpret_cast<const float4*>(&Kt[d * (BK + PAD) + tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        bool ok = ki < S;
        if (causal) ok = ok && qi >= ki;
        if (window > 0) ok = ok && (qi - ki) < window;
        Ss[(ty * 4 + i) * (BK + 1) + tx * 4 + j] = ok ? x : NEG_INF;
      }
    }
    __syncthreads();

    {  // online softmax, four lanes per row
      const int r = tid >> 2, part = tid & 3;
      float* row = Ss + r * (BK + 1) + part * (BK / 4);
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < BK / 4; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 4; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vv = Vs[kk * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qi = q0 + r;
    if (qi >= S) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
    T* o = out + (((size_t)b * S + qi) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < CPT; ++j) store(&o[tx + 16 * j], acc[i][j] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int causal, int window, float cap,
           cudaStream_t stream) {
  const size_t bytes = smem_floats<HD>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd<T, HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, causal,
      window, cap, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int H, int KV, int hd, int causal, int window, float cap,
             cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, KV, causal, window, cap, st);
    case 48: return launch<T, 48>(q, k, v, out, B, S, H, KV, causal, window, cap, st);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, KV, causal, window, cap, st);
    case 80: return launch<T, 80>(q, k, v, out, B, S, H, KV, causal, window, cap, st);
    case 96: return launch<T, 96>(q, k, v, out, B, S, H, KV, causal, window, cap, st);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, KV, causal, window, cap, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// window <= 0: no window; cap <= 0: no softcap.  Returns cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int H, int KV, int hd, int causal,
                                     int window, float cap, int is_bf16,
                                     void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, H, KV, hd, causal,
                                   window, cap, st);
  return dispatch<float>(q, k, v, out, B, S, H, KV, hd, causal, window, cap,
                         st);
}
