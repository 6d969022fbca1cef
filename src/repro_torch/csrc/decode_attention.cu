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
// What bounds it on an H100 (SXM, 700 W): bytes.  At the serving path's
// decode shape (B=16 slots, H=16, KV=8, hd=128, L=320, bf16) the K and V
// caches are 21 MB, 6.3 us at 3.35 TB/s, against 42 MFLOP of arithmetic;
// with g = H/KV = 2 (qwen3) or 8 (Jamba) query heads per kv head an MMA
// tile would be mostly empty, so the products stay on the CUDA cores.
//
// What this design does about it: one launch per call over a (split,
// kv head x head group, b) grid.  L is cut into splits only when the
// (b, kv head, head group) blocks are too few to give each SM one; at
// the serving shapes they are not (128 and 256 blocks), so there is one
// split and no combine.  A block of eight warps takes up to GROUP = 4
// query heads of one kv head (Jamba's eight are two blocks, which read
// the same K/V through L2), and streams its keys through a ring of
// NST = 4 shared-memory stages, each holding a 64-byte-row-wide tile of
// K, V (32 keys in bf16, 16 in fp32; the storage dtype is kept) and the
// tile's bias, filled by 16-byte `cp.async.cg` copies (4-byte ones for
// the bias): three tiles are in flight while one is consumed, behind one
// __syncthreads per tile.  q for the block's heads sits in registers: a
// group of LPR lanes (16 at hd 128 in bf16) owns one key row at a time,
// each lane one 16-byte vector of it.  Per tile a lane group takes RPS
// rows (2 at hd 128): their dot products for all heads are independent
// chains, reduced over the group by shuffles; then one rescale per head
// per tile and one `ex2.approx` per (row, head), on scores in base 2
// (scaled by log2(e) after the bias).  Each lane keeps, for every head,
// the running (max, denominator) and the accumulator of its vector's
// slice of hd, updated from the V vector at the same place.  The lane
// groups, then the eight warps, are merged at the end by the usual
// rescale by 2^(m_i - M).  With one split the block writes the output;
// otherwise it writes its (m, l, acc) to the one scratch buffer, and the
// last split block of each (b, kv head, head group) to finish, found
// through an atomic ticket (reset to 0 by that block), combines the
// splits in the same launch.  The combination is exact: keys past L
// belong to no split; a masked score is -1e30 * log2(e) (the bias swamps
// the product in fp32), which is also every state's starting maximum, so
// a fully masked split has that maximum and weight 2^(m - M) = 0 once any
// real score exists, and a row whose every entry is masked averages over
// exactly L keys, as the reference does.
//
// Head dims 1-256 are read in place, at their own row stride, so the
// cache is never copied: the kernel is built exactly at widths HD = 16,
// 32, 48, 64, 80, 96, 128 and 256, and masked at 64, 128 and 256,
// where any other head dim runs on the first at or above it, the lanes
// past its last vector idle (above hd 128 in fp32 a lane holds two
// vectors).  Rows that are no multiple of 16 bytes (hd % 8 in bf16, hd %
// 4 in fp32) are copied element by element, their last vector
// zero-filled past hd in shared memory.  The softmax scale comes from the
// caller (1/sqrt of the native head dim).
//
// C interface (ctypes): repro_decode_attention returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float M0 = NEG_INF * LOG2E;  // a masked score in base 2
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NST = 4;     // ring stages
constexpr int GROUP = 4;   // query heads per block at most

template <typename T>
__host__ __device__ constexpr int vec_elems() { return 16 / (int)sizeof(T); }
template <typename T>
__host__ __device__ constexpr int tile_rows() { return 64 / (int)sizeof(T); }
__host__ __device__ constexpr int pow2_at_least(int x) {
  return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2);
}

template <typename T, int HD, int G>
constexpr size_t smem_bytes() {
  return (size_t)NST * 2 * tile_rows<T>() * HD * sizeof(T)  // K, V ring
         + (size_t)NST * tile_rows<T>() * sizeof(float)     // bias ring
         + (size_t)WARPS * G * (HD + 2) * sizeof(float)     // warp merge
         + 16;                                              // ticket flag
}

// Blocks per SM the launch bounds plan for: one where the shared memory of
// two does not fit (HD above 128).
template <int HD>
constexpr int blocks_per_sm() { return HD <= 128 ? 2 : 1; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 16-byte vector at p (16-byte aligned) as floats into f[0 .. VEC).
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (m, l, acc) of b folded into a's, each weighted by 2^(m_i - M) (base-2
// maxima).
__device__ __forceinline__ void merge_into(float& m, float& l, float* acc,
                                          float mo, float lo, const float* ao,
                                          int n) {
  const float M = fmaxf(m, mo);
  const float a = ex2(m - M), c = ex2(mo - M);
  l = l * a + lo * c;
  for (int e = 0; e < n; ++e) acc[e] = acc[e] * a + ao[e] * c;
  m = M;
}

// HD: the instantiated width, at least the runtime head dim hd, which is
// the rows' stride in device memory.  Shared-memory rows are HD wide; a
// lane holds VPL 16-byte vectors of a row (two in fp32 above hd 128), the
// vectors past ceil(hd / VEC) idle.  Where hd is no multiple of VEC (rows
// not 16-byte aligned) the tiles are copied element by element, the
// columns from hd to the end of the last vector zeroed once, so the last
// vector of each row reads zeros there.  FULL: hd == HD, every bound a
// constant (the masked build took 3-8% longer at hd 128 in bf16 at the
// serving shapes on an H100 80GB HBM3 at 700 W).
template <typename T, int HD, int G, bool FULL>
__global__ void __launch_bounds__(THREADS, blocks_per_sm<HD>())
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ bias,
              T* __restrict__ out, float* __restrict__ scratch,
              int* __restrict__ tickets, int H, int KV, int L, int hd_arg,
              int chunk, int n_splits, int n_hg, float cap, float scale) {
  constexpr int VEC = vec_elems<T>();      // elements per 16-byte vector
  constexpr int VPR = HD / VEC;            // vectors per key row
  constexpr int VPL = (VPR + 31) / 32;     // vectors per lane
  constexpr int EPL = VPL * VEC;           // elements per lane
  constexpr int LPR = pow2_at_least(VPR / VPL);  // lanes per key row
  constexpr int RPW = 32 / LPR;            // key rows per warp at a time
  constexpr int TILE = tile_rows<T>();
  constexpr int STAGE = 2 * TILE * HD;     // K then V, elements
  // rows per lane group per tile (at hd 32 in bf16 half the groups idle)
  constexpr int RPS = TILE >= WARPS * RPW ? TILE / (WARPS * RPW) : 1;
  static_assert(VPR * VEC == HD && VPR % VPL == 0 && LPR <= 32, "head dim");
  static_assert(RPS * WARPS * RPW >= TILE, "tile rows");

  extern __shared__ __align__(16) uint8_t smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* bias_s = reinterpret_cast<float*>(ring + NST * STAGE);  // [NST][TILE]
  float* red = bias_s + NST * TILE;          // [WARPS][G][HD + 2]
  int* flag = reinterpret_cast<int*>(red + WARPS * G * (HD + 2));

  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / n_hg, hg = blockIdx.y % n_hg;
  const int g = H / KV;
  const int h0 = kvh * g + hg * GROUP;      // first query head of the block
  const int gc = min(G, g - hg * GROUP);    // query heads of the block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / LPR, c = lane % LPR;
  const int hd = FULL ? HD : hd_arg;
  const int nv = (hd + VEC - 1) / VEC;      // vectors of a row holding data
  const bool aligned = hd % VEC == 0;
  const int start = split * chunk;
  const int end = min(start + chunk, L);
  const int n_tiles = (end - start + TILE - 1) / TILE;

  if (!aligned)  // zeros between hd and the end of the last vector
    for (int i = tid; i < NST * 2 * TILE * (nv * VEC - hd); i += THREADS) {
      const int r = i / (nv * VEC - hd), d = hd + i % (nv * VEC - hd);
      store(&ring[r * HD + d], 0.f);
    }
  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      const int k0 = start + t * TILE;
      const int rows = min(TILE, end - k0);
      T* ks = ring + (t % NST) * STAGE;
      T* vs = ks + TILE * HD;
      const size_t base = ((size_t)b * L + k0) * KV + kvh;  // row r at
                                                            // base + r KV
      // (the loops run over the HD-wide layout, so their divisors are
      // constants, and skip what lies past hd)
      if (aligned) {
        for (int i = tid; i < rows * VPR; i += THREADS) {
          const int r = i / VPR, cc = i % VPR;
          if (cc >= nv) continue;
          const size_t off = (base + (size_t)r * KV) * hd + cc * VEC;
          cp16(ks + r * HD + cc * VEC, k + off);
          cp16(vs + r * HD + cc * VEC, v + off);
        }
      } else {  // rows not 16-byte aligned: element copies, in order
        for (int i = tid; i < rows * HD; i += THREADS) {
          const int r = i / HD, d = i % HD;
          if (d >= hd) continue;
          const size_t off = (base + (size_t)r * KV) * hd + d;
          ks[r * HD + d] = k[off];
          vs[r * HD + d] = v[off];
        }
      }
      for (int i = tid; i < rows; i += THREADS)
        cp4(bias_s + (t % NST) * TILE + i, bias + (size_t)b * L + k0 + i);
    }
    cp_commit();  // an empty group past the last tile keeps the count
  };
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) load_tile(t);

  // this lane's VPL vectors of a row: vector c * VPL + u, live below nv
  float qr[G][EPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[gi][e] = 0.f;
    if (gi >= gc) continue;
    const T* qh = q + ((size_t)b * H + h0 + gi) * hd;
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
      const int vi = c * VPL + u;
      if (vi >= nv) continue;
      if (aligned) {
        load16(qh + vi * VEC, &qr[gi][u * VEC]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (vi * VEC + e < hd) qr[gi][u * VEC + e] = to_f(qh[vi * VEC + e]);
      }
    }
  }
  // running (max, denominator) per head in base 2, and the accumulator of
  // this lane's slice of hd; every state starts at M0, which no score is
  // below (a masked score is (x - 1e30) * log2(e) = M0)
  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = M0;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[gi][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<NST - 2>();  // this thread's copies of tile t have landed
    __syncthreads();     // everyone's have; tile t-1's stage is free
    load_tile(t + NST - 1);
    const T* ks = ring + (t % NST) * STAGE;
    const T* vs = ks + TILE * HD;
    const float* bs = bias_s + (t % NST) * TILE;
    const int rows = min(TILE, end - (start + t * TILE));

    // scores of this lane group's RPS rows, all heads: independent
    // chains, so the loads, products and shuffles overlap
    float sc[RPS][G];
#pragma unroll
    for (int j = 0; j < RPS; ++j) {
      const int r = (j * WARPS + warp) * RPW + sub;
      float kf[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) kf[e] = 0.f;
#pragma unroll
      for (int u = 0; u < VPL; ++u)
        if (r < rows && c * VPL + u < nv)
          load16(ks + r * HD + (c * VPL + u) * VEC, &kf[u * VEC]);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qr[gi][e], kf[e], d);
        sc[j][gi] = d;
      }
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < RPS; ++j)
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
          sc[j][gi] += __shfl_xor_sync(0xffffffffu, sc[j][gi], o);

    // one rescale per head per tile, then the rows' weights
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float mt = m[gi];
#pragma unroll
      for (int j = 0; j < RPS; ++j) {
        const int r = (j * WARPS + warp) * RPW + sub;
        float x = cap > 0.f ? cap * tanhf(sc[j][gi] * scale / cap)
                            : sc[j][gi] * scale;
        x = r < rows ? (x + bs[r]) * LOG2E : M0;
        sc[j][gi] = x;
        mt = fmaxf(mt, x);
      }
      const float corr = ex2(m[gi] - mt);
      m[gi] = mt;
      l[gi] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[gi][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < RPS; ++j) {
      const int r = (j * WARPS + warp) * RPW + sub;
      if (r >= rows) continue;
      float vf[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) vf[e] = 0.f;
#pragma unroll
      for (int u = 0; u < VPL; ++u)
        if (c * VPL + u < nv)
          load16(vs + r * HD + (c * VPL + u) * VEC, &vf[u * VEC]);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float p = ex2(sc[j][gi] - m[gi]);
        l[gi] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[gi][e] = fmaf(p, vf[e], acc[gi][e]);
      }
    }
  }
  cp_wait<0>();

  // merge the RPW lane groups of each warp (lanes c, c + LPR, ...)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float ao[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        ao[e] = __shfl_xor_sync(0xffffffffu, acc[gi][e], o);
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[gi], o);
      merge_into(m[gi], l[gi], acc[gi], mo, lo, ao, EPL);
    }
  }
  if (sub == 0 && c * VPL < nv) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float* w = red + (warp * G + gi) * (HD + 2);
      if (c == 0) {
        w[0] = m[gi];
        w[1] = l[gi];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) w[2 + c * EPL + e] = acc[gi][e];
    }
  }
  __syncthreads();

  // merge the warps: one thread per (head, column)
  for (int i = tid; i < gc * HD; i += THREADS) {
    const int gi = i / HD, d = i % HD;
    if (d >= hd) continue;
    float M = M0, ls = 0.f, a = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float* p = red + (w * G + gi) * (HD + 2);
      merge_into(M, ls, &a, p[0], p[1], p + 2 + d, 1);
    }
    const size_t bh = (size_t)b * H + h0 + gi;
    if (n_splits == 1) {
      store(&out[bh * hd + d], a / fmaxf(ls, 1e-30f));
    } else {
      float* part = scratch + (bh * n_splits + split) * (hd + 2);
      part[2 + d] = a;
      if (d == 0) {
        part[0] = M;
        part[1] = ls;
      }
    }
  }
  if (n_splits == 1) return;

  // the last split block of this (b, kv head, head group) combines
  __threadfence();
  __syncthreads();
  int* ticket = tickets + (size_t)b * gridDim.y + blockIdx.y;
  if (tid == 0) *flag = atomicAdd(ticket, 1) == n_splits - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  for (int i = tid; i < gc * HD; i += THREADS) {
    const int gi = i / HD, d = i % HD;
    if (d >= hd) continue;
    const size_t bh = (size_t)b * H + h0 + gi;
    const float* part = scratch + bh * n_splits * (hd + 2);
    float M = M0, ls = 0.f, a = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float* p = part + s * (hd + 2);
      const float ad = __ldcg(p + 2 + d);
      merge_into(M, ls, &a, __ldcg(p), __ldcg(p + 1), &ad, 1);
    }
    store(&out[bh * hd + d], a / fmaxf(ls, 1e-30f));
  }
  if (tid == 0) *ticket = 0;  // ready for the next call
}

template <typename T, int HD, int G, bool FULL>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, void* scratch, void* tickets, int B, int H, int KV,
           int L, int hd, int chunk, int n_splits, int n_hg, float cap,
           float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T, HD, G>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, HD, G, FULL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(n_splits, KV * n_hg, B);
  decode_kernel<T, HD, G, FULL><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(out), static_cast<float*>(scratch),
      static_cast<int*>(tickets), H, KV, L, hd, chunk, n_splits, n_hg, cap,
      scale);
  return (int)cudaGetLastError();
}

// G: query heads per block rounded up to 2 or GROUP
template <typename T, int HD, bool FULL>
int by_group(int g, const void* q, const void* k, const void* v,
             const void* bias, void* out, void* scratch, void* tickets, int B,
             int H, int KV, int L, int hd, int chunk, int n_splits, int n_hg,
             float cap, float scale, cudaStream_t st) {
  if (g <= 2)
    return launch<T, HD, 2, FULL>(q, k, v, bias, out, scratch, tickets, B, H,
                                  KV, L, hd, chunk, n_splits, n_hg, cap,
                                  scale, st);
  return launch<T, HD, GROUP, FULL>(q, k, v, bias, out, scratch, tickets, B,
                                    H, KV, L, hd, chunk, n_splits, n_hg, cap,
                                    scale, st);
}

// hd runs on the exact build of its own width where there is one, else
// on the masked build of the first of 64, 128, 256 at or above it
template <typename T>
int by_head_dim(int hd, int g, const void* q, const void* k, const void* v,
                const void* bias, void* out, void* scratch, void* tickets,
                int B, int H, int KV, int L, int chunk, int n_splits,
                int n_hg, float cap, float scale, cudaStream_t st) {
#define REPRO_DECODE_HD(D, FULL)                                              \
  return by_group<T, D, FULL>(g, q, k, v, bias, out, scratch, tickets, B, H, \
                              KV, L, hd, chunk, n_splits, n_hg, cap, scale,  \
                              st);
  switch (hd) {
    case 16: REPRO_DECODE_HD(16, true)
    case 32: REPRO_DECODE_HD(32, true)
    case 48: REPRO_DECODE_HD(48, true)
    case 64: REPRO_DECODE_HD(64, true)
    case 80: REPRO_DECODE_HD(80, true)
    case 96: REPRO_DECODE_HD(96, true)
    case 128: REPRO_DECODE_HD(128, true)
    case 256: REPRO_DECODE_HD(256, true)
    default: break;
  }
  if (hd < 64) REPRO_DECODE_HD(64, false)
  if (hd < 128) REPRO_DECODE_HD(128, false)
  if (hd < 256) REPRO_DECODE_HD(256, false)
#undef REPRO_DECODE_HD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// cap <= 0: no softcap; scale: the softmax scale (1/sqrt of the native head
// dim).  hd: any head dim from 1 to 256, also the rows' stride.  chunk:
// keys per split (a multiple of 32); n_splits = ceil(L / chunk).  With
// n_splits > 1, scratch is fp32 [B, H, n_splits, hd + 2] and tickets int32
// [B, KV * ceil((H/KV) / GROUP)], all zero before the call and left zero
// after it; with one split both may be null.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* out, void* scratch, void* tickets,
                                      int B, int H, int KV, int L, int hd,
                                      int chunk, int n_splits, float cap,
                                      float scale, int is_bf16,
                                      void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || L <= 0 || hd <= 0 || hd > 256 ||
      H % KV != 0 || chunk <= 0 || chunk % 32 != 0 ||
      n_splits != (L + chunk - 1) / chunk ||
      (n_splits > 1 && (scratch == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int g = H / KV;
  const int n_hg = (g + GROUP - 1) / GROUP;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return by_head_dim<__nv_bfloat16>(hd, g, q, k, v, bias, out, scratch,
                                      tickets, B, H, KV, L, chunk, n_splits,
                                      n_hg, cap, scale, st);
  return by_head_dim<float>(hd, g, q, k, v, bias, out, scratch, tickets, B, H,
                            KV, L, chunk, n_splits, n_hg, cap, scale, st);
}
