// Flash-decode: one query token per row against a (ring) KV cache,
// hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py, `_decode_kernel`
// (launched by `decode_attention_kernel`), the Pallas TPU kernel that runs
// in every layer of every genserve wave decode step.
//
// Computes, for q [B,H,hd], k/v [B,L,KV,hd] (fp32 or bf16) and an additive
// fp32 bias [B,L] (0 = attend, -1e30 = masked), out [B,H,hd] in q's dtype:
// softmax(cap*tanh((q.k/sqrt(hd))/cap) + bias) . v over kv head h/(H/KV),
// with an fp32 running max, denominator and accumulator.  The cap is
// applied before the bias, and the bias is added before the running max.
//
// What bounds it on an H100: bytes.  At the serving path's decode shape
// (B=16 slots, H=16, KV=8, hd=128, L=320, bf16) the K and V caches are
// 21 MB, 6.3 us at 3.35 TB/s, against 42 MFLOP of arithmetic.
//
// What this design does about it (flash-decoding): B*H is small while L is
// long, so a (split, kv head, b) grid cuts L into splits of a few 64-key
// tiles, giving B*KV*splits blocks to fill 132 SMs.  Each block stages a
// K/V tile in shared memory once and uses it for all H/KV query heads of
// its kv head (the Pallas grid reloads it for every query head), keeps
// per-head running (max, denominator, accumulator) in shared memory, and
// writes them as a partial result per split; a second small kernel
// combines the splits, rescaling each by exp(m_i - M).  The combination is
// exact: a fully masked split has m = -1e30 and weight exp(-1e30 - M) = 0
// once any real score exists.  Keys past L are never part of any split,
// so a row whose every entry is masked still averages over exactly L keys,
// as the reference does.  Loads are scalar and products run on the CUDA
// cores in fp32; vectorised (16-byte) loads and TMA are the next step
// toward the bytes bound.
//
// C interface (ctypes): repro_decode_attention returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TILE = 64;      // keys per shared-memory tile
constexpr int THREADS = 128;
constexpr size_t MAX_SMEM = 232448;  // per-block dynamic limit on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_floats(int g, int hd) {
  return (size_t)g * hd                 // q rows of the kv head's group
         + (size_t)TILE * (hd + 1)      // K tile (padded rows)
         + (size_t)TILE * hd            // V tile
         + (size_t)g * TILE             // scores / probabilities
         + (size_t)g * hd               // accumulators
         + 3 * (size_t)g;               // m, l, corr
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_split(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ bias,
             float* __restrict__ m_part, float* __restrict__ l_part,
             float* __restrict__ acc_part, int H, int KV, int L, int hd,
             int chunk, int n_splits, float cap, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int g = H / KV;
  float* qs = smem;                      // [g][hd]
  float* ks = qs + g * hd;               // [TILE][hd + 1]
  float* vs = ks + TILE * (hd + 1);      // [TILE][hd]
  float* ss = vs + TILE * hd;            // [g][TILE]
  float* acc = ss + g * TILE;            // [g][hd]
  float* m_s = acc + g * hd;             // [g]
  float* l_s = m_s + g;                  // [g]
  float* c_s = l_s + g;                  // [g]

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int start = split * chunk;
  const int end = min(start + chunk, L);

  for (int idx = tid; idx < g * hd; idx += THREADS) {
    const int gi = idx / hd, d = idx % hd;
    qs[idx] = to_f(q[((size_t)b * H + kvh * g + gi) * hd + d]);
    acc[idx] = 0.f;
  }
  for (int gi = tid; gi < g; gi += THREADS) {
    m_s[gi] = NEG_INF;
    l_s[gi] = 0.f;
  }

  for (int t0 = start; t0 < end; t0 += TILE) {
    const int n = min(TILE, end - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < n * hd; idx += THREADS) {
      const int r = idx / hd, d = idx % hd;
      const size_t off = (((size_t)b * L + t0 + r) * KV + kvh) * hd + d;
      ks[r * (hd + 1) + d] = to_f(k[off]);
      vs[r * hd + d] = to_f(v[off]);
    }
    __syncthreads();
    for (int idx = tid; idx < g * n; idx += THREADS) {
      const int gi = idx / n, r = idx % n;
      const float* qr = qs + gi * hd;
      const float* kr = ks + r * (hd + 1);
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (cap > 0.f) s = cap * tanhf(s / cap);
      ss[gi * TILE + r] = s + bias[(size_t)b * L + t0 + r];
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += THREADS / 32) {  // a warp per head
      float* row = ss + gi * TILE;
      float mx = NEG_INF;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, row[r]);
      mx = warp_max(mx);
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float p = expf(row[r] - m_new);
        row[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[gi] = l_s[gi] * corr + sum;
        m_s[gi] = m_new;
        c_s[gi] = corr;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < g * hd; idx += THREADS) {
      const int gi = idx / hd, d = idx % hd;
      const float* p = ss + gi * TILE;
      float a = acc[idx] * c_s[gi];
      for (int r = 0; r < n; ++r) a = fmaf(p[r], vs[r * hd + d], a);
      acc[idx] = a;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < g * hd; idx += THREADS) {
    const int gi = idx / hd, d = idx % hd;
    const size_t bh = (size_t)b * H + kvh * g + gi;
    acc_part[(bh * n_splits + split) * hd + d] = acc[idx];
  }
  for (int gi = tid; gi < g; gi += THREADS) {
    const size_t bh = (size_t)b * H + kvh * g + gi;
    m_part[bh * n_splits + split] = m_s[gi];
    l_part[bh * n_splits + split] = l_s[gi];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine(const float* __restrict__ m_part,
               const float* __restrict__ l_part,
               const float* __restrict__ acc_part, T* __restrict__ out,
               int hd, int n_splits) {
  const size_t bh = blockIdx.x;
  const float* mp = m_part + bh * n_splits;
  const float* lp = l_part + bh * n_splits;
  float M = NEG_INF;
  for (int i = 0; i < n_splits; ++i) M = fmaxf(M, mp[i]);
  float l = 0.f;
  for (int i = 0; i < n_splits; ++i) l += lp[i] * expf(mp[i] - M);
  const float den = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < n_splits; ++i)
      a += acc_part[(bh * n_splits + i) * hd + d] * expf(mp[i] - M);
    store(&out[bh * hd + d], a / den);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, void* m_part, void* l_part, void* acc_part, int B,
           int H, int KV, int L, int hd, int chunk, int n_splits, float cap,
           cudaStream_t stream) {
  const size_t bytes = smem_floats(H / KV, hd) * sizeof(float);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  static size_t configured = 48 * 1024;
  if (bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = bytes;
  }
  const dim3 grid(n_splits, KV, B);
  decode_split<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(acc_part), H, KV, L, hd, chunk, n_splits, cap,
      1.0f / sqrtf((float)hd));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine<T><<<B * H, THREADS, 0, stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<T*>(out), hd,
      n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

// cap <= 0: no softcap.  chunk: keys per split (a multiple of 64);
// n_splits = ceil(L / chunk).  m_part/l_part [B,H,n_splits] and acc_part
// [B,H,n_splits,hd] are fp32 scratch the caller allocates.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* out, void* m_part, void* l_part,
                                      void* acc_part, int B, int H, int KV,
                                      int L, int hd, int chunk, int n_splits,
                                      float cap, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || L <= 0 || hd <= 0 || H % KV != 0 ||
      chunk <= 0 || n_splits != (L + chunk - 1) / chunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, bias, out, m_part, l_part,
                                 acc_part, B, H, KV, L, hd, chunk, n_splits,
                                 cap, st);
  return launch<float>(q, k, v, bias, out, m_part, l_part, acc_part, B, H,
                       KV, L, hd, chunk, n_splits, cap, st);
}
