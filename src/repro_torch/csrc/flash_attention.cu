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
// What bounds it on an H100 (SXM, 700 W): at the serving path's prefill
// shape (B=16, S=256, H=16, KV=8, hd=128, bf16, causal) the function must
// move 50.3 MB (q, k, v read once, out written once), 15 us at 3.35 TB/s,
// and do 4.3 GFLOP on the unmasked (causal) pairs, 4.4 us at the 989
// TFLOP/s bf16 tensor-core peak: the roofline bound is the bytes.  At
// Jamba's GQA-8 shape (H=64) it is 151 MB, 45 us.
//
// Two kernels, chosen by dtype alone (the wrapper states the split and
// counts the tensor-core launches apart; neither is a fallback):
//
// bf16 -> `flash_tc`, on the tensor cores.  A work item is a 64-row query
// tile of one (b, h); one warpgroup (128 threads) per block runs items in
// a persistent grid (two blocks per SM up to hd 128, one above: the
// shared memory of hd 136-256 holds one), heaviest (last) query tiles
// first.  TMA brings each item's Q tile and a 2-stage ring of 64-key K/V
// tiles into shared memory as bf16, each head dim padded to NP = 1-4
// panels of 64 columns with the 128-byte swizzle; TMA fills the columns
// past hd and the rows past S with zeros, so the padded products are
// unchanged and Python pads nothing where TMA can read the row (hd a
// multiple of 8: rows of 16 bytes).  The K/V tiles of a block's items
// form one stream: the next tile lands while this one is consumed (an
// mbarrier per stage), across item boundaries, and the next item's Q
// lands in a second buffer, so an item's first loads do not wait behind
// its predecessor.  S = Q.K^T is `wgmma` m64n64k16 with both operands
// K-major in shared memory; the online softmax runs on the fp32
// accumulators in registers (row max and sum over the four lanes of a row
// with shuffles, `ex2.approx` on scores pre-scaled by scale*log2(e)),
// masking only on the diagonal, ragged and window-edge tiles; P is packed
// to bf16 in registers as the A operand of O += P.V (`wgmma`
// m64n{64,128}k16 per pair of panels, V from shared memory as the
// MN-major B operand).  The accumulators never leave registers; the
// padded output columns are never stored.  Key tiles that causal or
// window masking leave fully masked are skipped (a masked entry's weight
// ex2(-1e30 - m) is exactly 0 once a real score has set the running max,
// and a row whose first tiles are all masked is wiped by the 0 correction
// when one arrives).  Shared memory: 48 KB per panel (Q twice, K and V
// twice each), so 192 KB at hd 193-256.
//
// fp32 -> `flash_fwd`, the first CUDA-core kernel: TF32 would break the
// 2e-4 fp32 parity the full-width token-identity checks rest on.  One
// block of 256 threads owns a 64-row query tile and loops over 64-row key
// tiles staged in shared memory as fp32 (117 KB at hd 128, 217 KB at
// 256), products in fp32 FMA.  It is instantiated at HD = 16, 32, 48, 64,
// 80, 96, 128, 192 and 256; a head dim runs on the first HD at or above
// it, its element loads masked past hd (zeros) and its stores too, or on
// a build without the masks where hd is HD, at every HD but 192 (a width
// no served configuration has: hd 129-192 all run masked).
//
// The softmax scale comes from the caller (1/sqrt of the native head
// dim), never from a template width.
//
// The tensor maps are encoded on the host per call by
// `cuTensorMapEncodeTiled`, whose address the CUDA runtime looks up (no
// -lcuda at link time).
//
// C interface (ctypes): repro_flash_attention returns cudaGetLastError(),
// or cudaErrorInvalidValue when a tensor map cannot be encoded.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- fp32: the CUDA-core kernel --------------------------------------------

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key rows per shared-memory tile
constexpr int THREADS = 256;
constexpr int PAD = 4;       // keeps transposed rows 16-byte aligned

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)HD * (BQ + PAD) + (size_t)HD * (BK + PAD) + (size_t)BK * HD +
         (size_t)BQ * (BK + 1) + 3 * BQ;
}

// FULL: hd == HD, so the row stride and the column bound are constants
// (the masked build took 4-12% longer at hd 48 and 128, where the widths
// agree, on an H100 80GB HBM3 at 700 W).
template <typename T, int HD, bool FULL>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int S, int H, int KV,
          int hd_arg, int causal, int window, float cap, float scale) {
  const int hd = FULL ? HD : hd_arg;
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
    if (qi < S && d < hd) x = to_f(q[(((size_t)b * S + qi) * H + h) * hd + d]);
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
      if (ki < S && d < hd) {
        const size_t off = (((size_t)b * S + ki) * KV + kvh) * hd + d;
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
    T* o = out + (((size_t)b * S + qi) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      if (tx + 16 * j < hd) store(&o[tx + 16 * j], acc[i][j] / den);
  }
}

template <typename T, int HD, bool FULL>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int hd, int causal, int window, float cap,
           float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats<HD>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, HD, FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd<T, HD, FULL><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, hd, causal,
      window, cap, scale);
  return (int)cudaGetLastError();
}


// ---- bf16: wgmma + TMA ----------------------------------------------------

namespace tc {

constexpr int BM = 64;             // query rows per block (one warpgroup)
constexpr int BN = 64;             // keys per K/V tile
constexpr int STAGES = 2;          // K/V ring depth
constexpr int THREADS = 128;
constexpr int PANEL = 64 * 128;    // bytes: 64 rows x 128 bytes (64 bf16)
constexpr float LOG2E = 1.4426950408889634f;

// Two Q tiles, then STAGES K tiles, then STAGES V tiles (NP panels each),
// then the mbarriers; 1 KB of slack to align the tiles for the 128-byte
// swizzle.
template <int NP>
constexpr size_t smem_bytes() {
  return (size_t)(2 + 2 * STAGES) * NP * PANEL + 8 * (2 + STAGES) + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor of a 128-byte-swizzled tile in shared memory:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (spins == (1u << 26)) __trap();  // a load that never lands: fail
  }
}

// One box {64 columns, 1 head, 64 rows, 1 batch} of a [B, S, heads, hd]
// tensor into shared memory; completion is reported to `bar` in bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int head,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(head), "r"(row), "r"(b)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads of the accumulators across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64x64] (+)= A[64x16] . B[16x64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64x64] += A[64x16] . B[16x64], A in registers, B MN-major in shared
// memory (trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64x128] += A[64x16] . B[16x128], A in registers, B MN-major in shared
// memory (trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// O[:, 64 P ...] += A . V for the panels from P on: an n128 product per
// pair of panels (its accumulators the next 64 of o), an n64 one for a
// last odd panel.
template <int NP, int P = 0>
__device__ __forceinline__ void pv_product(float (&o)[NP * 32],
                                           const uint32_t (&a)[4],
                                           uint32_t v_addr) {
  if constexpr (P < NP) {
    const uint64_t db = sw128_desc(v_addr + P * PANEL, PANEL, 1024);
    if constexpr (P + 1 < NP) {
      wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(o + 32 * P), a, db);
      pv_product<NP, P + 2>(o, a, v_addr);
    } else {
      wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(o + 32 * P), a, db);
    }
  }
}

// One work item: a 64-row query tile of one (b, h) and its key tiles.
// Items are numbered heaviest first (every head's last query tile, then
// the one before, ...), and block j of the persistent grid takes items j,
// j + gridDim.x, ...
struct Item {
  int b, h, kvh, q0, kt_lo, n;  // n >= 1 key tiles from kt_lo
};

__device__ __forceinline__ Item item_of(int i, int B, int S, int H, int KV,
                                        int causal, int window) {
  const int n_qt = (S + BM - 1) / BM;
  Item w;
  const int bh = i % (B * H);
  w.b = bh / H;
  w.h = bh % H;
  w.kvh = w.h / (H / KV);
  w.q0 = (n_qt - 1 - i / (B * H)) * BM;
  const int q_last = min(w.q0 + BM, S) - 1;
  const int n_kt = (S + BN - 1) / BN;
  const int kt_hi = causal ? min(n_kt, q_last / BN + 1) : n_kt;
  w.kt_lo = 0;  // first key tile not wholly outside the window
  if (window > 0) {
    const int t = w.q0 - window - (BN - 1);
    if (t >= 0) w.kt_lo = t / BN + 1;
  }
  w.n = kt_hi - w.kt_lo;  // the tile holding key q0 is always in
  return w;
}

// Blocks per SM: two while the shared memory of two fits (NP <= 2).
template <int NP>
constexpr int blocks_per_sm() { return NP <= 2 ? 2 : 1; }

// NP = padded head dim / 64.  Thread t of the warpgroup holds, for every
// 64x64 score tile and the 64 x 64*NP output tile, rows r = 16*(t/32) +
// (t%32)/4 and r + 8, columns 8*c + 2*(t%4) + {0, 1} (the wgmma accumulator
// layout, which is also the A-operand layout of P).
//
// The K/V tiles of a block's items form one stream through the ring:
// thread 0 keeps STAGES tiles of it in flight, across item boundaries, and
// loads the next item's Q into the other of two Q buffers while this item
// runs, so an item's first tiles and Q are waiting when its predecessor's
// epilogue ends.
template <int NP>
__global__ void __launch_bounds__(THREADS, blocks_per_sm<NP>())
flash_tc(const __grid_constant__ CUtensorMap qmap,
         const __grid_constant__ CUtensorMap kmap,
         const __grid_constant__ CUtensorMap vmap,
         __nv_bfloat16* __restrict__ out, int B, int S, int H, int KV,
         int hd, int causal, int window, float cap, float scale) {
  constexpr int ND = NP * 32;  // fp32 output accumulators per thread
  constexpr uint32_t KV_BYTES = 2 * NP * PANEL;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + 2 * NP * PANEL;      // [STAGES][NP][64 rows][128 B]
  uint8_t* vs = ks + STAGES * NP * PANEL;  // [STAGES][NP][64 rows][128 B]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(vs + STAGES * NP * PANEL);
  uint64_t* full = qbar + 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_items = B * H * ((S + BM - 1) / BM);

  // producer state, used by thread 0 only: the next stream position and
  // the item and key tile it belongs to
  int p_item = blockIdx.x, p_kt = 0, p_pos = 0;
  Item pw = item_of(p_item, B, S, H, KV, causal, window);
  auto load_next = [&]() {
    if (p_item >= n_items) return;
    const int stage = p_pos % STAGES;
    uint64_t* bar = &full[stage];
    mbar_expect_tx(bar, KV_BYTES);
    const int row = (pw.kt_lo + p_kt) * BN;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tma_load(ks + (stage * NP + p) * PANEL, &kmap, bar, p * 64, pw.kvh,
               row, pw.b);
      tma_load(vs + (stage * NP + p) * PANEL, &vmap, bar, p * 64, pw.kvh,
               row, pw.b);
    }
    ++p_pos;
    if (++p_kt == pw.n) {
      p_kt = 0;
      p_item += gridDim.x;
      if (p_item < n_items) pw = item_of(p_item, B, S, H, KV, causal, window);
    }
  };
  auto load_q = [&](int i, int buf) {
    const Item w = item_of(i, B, S, H, KV, causal, window);
    mbar_expect_tx(&qbar[buf], NP * PANEL);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tma_load(qs + (buf * NP + p) * PANEL, &qmap, &qbar[buf], p * 64, w.h,
               w.q0, w.b);
  };

  if (tid == 0) {
    for (int i = 0; i < 2 + STAGES; ++i) mbar_init(&qbar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_q(blockIdx.x, 0);
    for (int s = 0; s < STAGES; ++s) load_next();
  }

  const int r_lo = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const float sl2 = scale * LOG2E;
  int c_pos = 0;  // consumer's stream position
  int local = 0;  // items done by this block
  for (int it = blockIdx.x; it < n_items; it += gridDim.x, ++local) {
    const Item w = item_of(it, B, S, H, KV, causal, window);
    const int qb = local & 1;
    if (tid == 0 && it + (int)gridDim.x < n_items)
      load_q(it + gridDim.x, qb ^ 1);  // its buffer's last reader is done
    const int q0 = w.q0;

    float o[ND];
#pragma unroll
    for (int j = 0; j < ND; ++j) o[j] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF;  // running max of rows r, r + 8 (log2)
    float l0 = 0.f, l1 = 0.f;          // this thread's part of the sums
    const uint32_t q_addr = smem_u32(qs + qb * NP * PANEL);
    mbar_wait(&qbar[qb], (local >> 1) & 1);

    for (int i = 0; i < w.n; ++i, ++c_pos) {
      const int stage = c_pos % STAGES;
      const int k0 = (w.kt_lo + i) * BN;
      const uint32_t k_addr = smem_u32(ks + stage * NP * PANEL);
      const uint32_t v_addr = smem_u32(vs + stage * NP * PANEL);
      mbar_wait(&full[stage], (c_pos / STAGES) & 1);

      // S = Q . K^T: 16 head-dim columns per wgmma; within a panel the
      // descriptor advances 32 bytes, across panels one panel.
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < NP * 4; ++kk) {
        const uint32_t off = (kk >> 2) * PANEL + (kk & 3) * 32;
        wgmma_ss_n64(sc, sw128_desc(q_addr + off, 16, 1024),
                     sw128_desc(k_addr + off, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait0();
      fence_regs(sc);

      // online softmax in registers, base 2
      const bool edge = (k0 + BN > S) || (causal && k0 + BN - 1 > q0) ||
                        (window > 0 && q0 + BM - 1 - k0 >= window);
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float x = cap > 0.f ? cap * tanhf(sc[j] * scale / cap) * LOG2E
                            : sc[j] * sl2;
        if (edge) {
          const int qi = q0 + r_lo + ((j >> 1) & 1) * 8;
          const int ki = k0 + (j >> 2) * 8 + cq + (j & 1);
          bool ok = ki < S;
          if (causal) ok = ok && qi >= ki;
          if (window > 0) ok = ok && (qi - ki) < window;
          if (!ok) x = NEG_INF;
        }
        sc[j] = x;
        if ((j >> 1) & 1)
          mx1 = fmaxf(mx1, x);
        else
          mx0 = fmaxf(mx0, x);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float s0 = 0.f, s1 = 0.f;
      uint32_t pa[16];  // P in bf16: pa[4*kk .. 4*kk+3] is the A fragment
                        // of keys 16*kk .. 16*kk+15
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const bool hi = (j >> 1) & 1;
        const float mm = hi ? mn1 : mn0;
        const float p0 = ex2(sc[j] - mm), p1 = ex2(sc[j + 1] - mm);
        if (hi)
          s1 += p0 + p1;
        else
          s0 += p0 + p1;
        pa[j >> 1] = pack_bf16(p0, p1);
      }
      l0 = l0 * c0 + s0;
      l1 = l1 * c1 + s1;
#pragma unroll
      for (int j = 0; j < ND; ++j) o[j] *= ((j >> 1) & 1) ? c1 : c0;

      // O += P . V: 16 keys per wgmma, V rows 128 bytes apart, 8-row
      // groups 1 KB apart (SBO), head-dim panels one panel apart (LBO)
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                               pa[4 * kk + 3]};
        pv_product<NP>(o, a, v_addr + kk * 2048);
      }
      wg_commit();
      wg_wait0();
      fence_regs(o);

      __syncthreads();  // every warp is done reading this stage
      if (tid == 0) load_next();
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qi = q0 + r_lo + 8 * rr;
      if (qi >= S) continue;
      __nv_bfloat16* row = out + (((size_t)w.b * S + qi) * H + w.h) * hd;
#pragma unroll
      for (int c8 = 0; c8 < NP * 8; ++c8) {
        const int col = c8 * 8 + cq;
        if (col < hd) {
          const int j = c8 * 4 + rr * 2;
          *reinterpret_cast<__nv_bfloat162*>(row + col) =
              __floats2bfloat162_rn(o[j] * inv[rr], o[j + 1] * inv[rr]);
        }
      }
    }
  }
}

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encoder() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// A bf16 [B, S, heads, hd] tensor as 4-D boxes of 64 columns x 1 head x 64
// rows x 1 batch, 128-byte swizzle; out-of-range elements read as zero.
int make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int S,
             int B) {
  const EncodeFn enc = encoder();
  if (enc == nullptr) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int hd, int causal, int window, float cap,
           float scale, cudaStream_t stream, int* launched) {
  CUtensorMap qm, km, vm;
  int e = make_map(&qm, q, hd, H, S, B);
  if (e == 0) e = make_map(&km, k, hd, KV, S, B);
  if (e == 0) e = make_map(&vm, v, hd, KV, S, B);
  if (e != 0) return e;
  const size_t bytes = smem_bytes<NP>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t ce = cudaFuncSetAttribute(
        flash_tc<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (ce != cudaSuccess) return (int)ce;
    configured = true;
  }
  int dev = 0, sms = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce != cudaSuccess) return (int)ce;
  const int n_items = B * H * ((S + BM - 1) / BM);
  const int resident = blocks_per_sm<NP>() * sms;
  const int grid = n_items < resident ? n_items : resident;
  flash_tc<NP><<<grid, THREADS, bytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), B, S, H, KV, hd, causal,
      window, cap, scale);
  *launched = 1;
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// window <= 0: no window; cap <= 0: no softcap; scale: the softmax scale
// (1/sqrt of the native head dim).  bf16 runs the tensor-core kernel on
// head dims that are multiples of 8 up to 256 (the caller pads others),
// fp32 the CUDA-core one on every head dim up to 256; *tensor_cores is set
// to 1 where the tensor-core kernel is launched and to 0 otherwise, so
// the caller counts what ran.  Returns cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int H, int KV, int hd, int causal,
                                     int window, float cap, float scale,
                                     int is_bf16, void* stream,
                                     int* tensor_cores) {
  *tensor_cores = 0;
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 ||
      hd > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (hd % 8 != 0) return (int)cudaErrorInvalidValue;
    switch ((hd + 63) / 64) {
      case 1: return tc::launch<1>(q, k, v, out, B, S, H, KV, hd, causal, window, cap, scale, st, tensor_cores);
      case 2: return tc::launch<2>(q, k, v, out, B, S, H, KV, hd, causal, window, cap, scale, st, tensor_cores);
      case 3: return tc::launch<3>(q, k, v, out, B, S, H, KV, hd, causal, window, cap, scale, st, tensor_cores);
      default: return tc::launch<4>(q, k, v, out, B, S, H, KV, hd, causal, window, cap, scale, st, tensor_cores);
    }
  }
#define REPRO_FLASH_HD(D)                                                     \
  if (hd == D)                                                                \
    return launch<float, D, true>(q, k, v, out, B, S, H, KV, hd, causal,     \
                                  window, cap, scale, st);                    \
  if (hd < D)                                                                 \
    return launch<float, D, false>(q, k, v, out, B, S, H, KV, hd, causal,    \
                                   window, cap, scale, st);
  REPRO_FLASH_HD(16)
  REPRO_FLASH_HD(32)
  REPRO_FLASH_HD(48)
  REPRO_FLASH_HD(64)
  REPRO_FLASH_HD(80)
  REPRO_FLASH_HD(96)
  REPRO_FLASH_HD(128)
  if (hd <= 192)
    return launch<float, 192, false>(q, k, v, out, B, S, H, KV, hd, causal,
                                     window, cap, scale, st);
  REPRO_FLASH_HD(256)
#undef REPRO_FLASH_HD
  return (int)cudaErrorInvalidValue;
}
