// Mamba selective scan from a zero state, hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mamba_scan/kernel.py, `_mamba_kernel`
// (launched by `mamba_scan_kernel`), the Pallas TPU kernel of the Mamba
// recurrence: in the port it runs once per Mamba layer in every one-shot
// prefill of a Jamba model.
//
// Computes, for dt, x [B,S,di], Bm, Cm [B,S,ds] and A [di,ds], all fp32,
// y [B,S,di] and the final state h_end [B,di,ds], both fp32, from h = 0:
//   h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t
//   y_t = sum_s h_t[s] C_t[s]
// (no D x skip: the caller adds it).
//
// What bounds it on an H100: bytes by the formula chip_smoke.py applies.
// At the serving path's prefill shape (dt/x [16,256,16384], ds 16) it moves
// 823.6 MB (dt, x and y at 268.4 MB each, h_end 16.8 MB): 0.246 ms at 3.35
// TB/s; its 7.5 G fp32 operations take 0.112 ms at 67 TFLOP/s.  It also
// takes one exponential per state element and step, 1.07 G, and the
// card's exponential unit (MUFU) does 16 a clock per SM: 0.257 ms at 1.98
// GHz, as much as the bytes.  Measured (NVIDIA H100 80GB HBM3, 700 W):
// 0.39 ms; a build without the exponentials runs at 0.29 ms (2.8 TB/s, the
// streaming rate), one with half of them at 0.31 ms.  So streaming and the
// MUFU together hold it: neither overlaps the other fully.  Moving one
// exponential in 8 or 16 to an FMA-pipe polynomial, deeper copy rings (3,
// 4 or 8 tiles of 4-8 steps) and fewer registers for more blocks were each
// no faster.
//
// What this design does about it:
//   - the exponential is one FMUL and one ex2.approx.ftz.f32 on A's row
//     pre-multiplied by log2(e) in registers; the accurate expf added its
//     range reduction on the FMA pipe, about ten issue slots per element;
//   - one thread per (b, d) channel holds h[ds] and A's row in registers
//     (128 registers, four 128-thread blocks per SM), so the per-step work
//     that is not per state element (dt, x, dt x, the y store) is shared by
//     all ds elements; y sums four partial chains;
//   - dt, x, B_t and C_t arrive as 16-step tiles through a 2-stage ring of
//     16-byte cp.async copies (4-byte copies where di is not a multiple of
//     4 or a pointer is not 16-byte aligned) whose source pointers step by
//     one tile, so the next tile is in flight while one is computed, with
//     one barrier per tile;
//   - 2048 blocks at the serving shape over 4 x 132 resident: 3.9 waves,
//     the last one nearly full.
// ds is instantiated at 8, 16 and 32: at 32, a[32] and h[32] take 64
// registers and the ring 40 KB of static shared memory, three blocks per
// SM.
// Steps past S (the ragged last tile) load dt = x = 0 (cp.async's zero
// fill), which leaves h unchanged (exp(0) = 1), and write no y; channels
// past di compute on zeros and write nothing, so the wrapper pads nothing.
//
// C interface (ctypes): repro_mamba_scan returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // channels per block, one thread each
constexpr int T = 16;         // time steps per tile
constexpr int STAGES = 2;     // tiles in the ring
constexpr float LOG2E = 1.4426950408889634f;

template <int DS>
struct Tile {
  float dt[T][THREADS], x[T][THREADS], b[T][DS], c[T][DS];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// E-float asynchronous copy global -> shared (E = 4: 16 bytes); zero fill
// when !ok
template <int E>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (E == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0));
}

// Blocks per SM the launch bounds plan for: at DS 32, four would leave
// 128 registers for a[32], h[32] and the rest, and ptxas spills (64-84
// bytes a thread): 0.77 ms against 0.71 at three, dt/x [16,256,16384], on
// an H100 80GB HBM3 at 700 W.
template <int DS>
constexpr int blocks_per_sm() { return DS <= 16 ? 4 : 3; }

template <int DS, bool VEC>
__global__ void __launch_bounds__(THREADS, blocks_per_sm<DS>())
mamba_scan_fwd(const float* __restrict__ dt, const float* __restrict__ x,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               const float* __restrict__ A, float* __restrict__ y,
               float* __restrict__ h_end, int S, int di) {
  constexpr int E = VEC ? 4 : 1;           // floats per copy
  constexpr int CPR = THREADS / E;         // copies per dt / x row
  constexpr int RSTEP = THREADS / CPR;     // rows between a thread's copies
  constexpr int BPR = DS / E;              // copies per B / C row
  static_assert(DS % 4 == 0 && T % RSTEP == 0, "shape");
  __shared__ __align__(16) Tile<DS> ring[STAGES];

  const int tid = threadIdx.x, b = blockIdx.y, d0 = blockIdx.x * THREADS;
  const int d = d0 + tid;
  const bool active = d < di;
  const size_t row = (size_t)b * S;  // (b, t = 0)

  float a[DS], h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    a[s] = active ? A[(size_t)d * DS + s] * LOG2E : 0.f;
    h[s] = 0.f;
  }

  // this thread's dt / x copies: column cc, rows tr + k * RSTEP of a tile;
  // the source pointers step by T rows per tile
  const int cc = (tid % CPR) * E, tr = tid / CPR;
  const bool col_ok = d0 + cc < di;
  const size_t rstride = (size_t)RSTEP * di, tstride = (size_t)T * di;
  const float* dtp = dt + (row + tr) * di + d0 + cc;
  const float* xp = x + (row + tr) * di + d0 + cc;
  auto load = [&](int tile) {
    Tile<DS>& tl = ring[tile % STAGES];
    const int left = S - tile * T - tr;    // rows of this tile left at tr
#pragma unroll
    for (int k = 0; k < T / RSTEP; ++k) {
      const bool ok = col_ok && k * RSTEP < left;
      cp_async<E>(&tl.dt[tr + k * RSTEP][cc], ok ? dtp + k * rstride : dt,
                  ok);
      cp_async<E>(&tl.x[tr + k * RSTEP][cc], ok ? xp + k * rstride : x, ok);
    }
    dtp += tstride;
    xp += tstride;
    for (int i = tid; i < 2 * T * BPR; i += THREADS) {
      const int m = i / (T * BPR), j = i % (T * BPR);
      const int t = j / BPR, s = (j % BPR) * E;
      const bool ok = t < S - tile * T;
      const float* src = m ? Cm : Bm;
      cp_async<E>(m ? &tl.c[t][s] : &tl.b[t][s],
                  ok ? src + (row + (size_t)tile * T + t) * DS + s : src, ok);
    }
  };

  const int ntiles = (S + T - 1) / T;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles) load(i);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  float* yp = y + row * di + d;
  for (int tile = 0; tile < ntiles; ++tile) {
    // this tile's copies have landed; every reader of the stage refilled
    // below (the previous tile's) is done
    asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 2) : "memory");
    __syncthreads();
    if (tile + STAGES - 1 < ntiles) load(tile + STAGES - 1);
    asm volatile("cp.async.commit_group;" ::: "memory");

    const Tile<DS>& tl = ring[tile % STAGES];
    const int len = min(T, S - tile * T);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float dtv = tl.dt[t][tid];
      const float dx = dtv * tl.x[t][tid];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < DS; s += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&tl.b[t][s]);
        const float4 c4 = *reinterpret_cast<const float4*>(&tl.c[t][s]);
        h[s] = fmaf(ex2(dtv * a[s]), h[s], dx * b4.x);
        h[s + 1] = fmaf(ex2(dtv * a[s + 1]), h[s + 1], dx * b4.y);
        h[s + 2] = fmaf(ex2(dtv * a[s + 2]), h[s + 2], dx * b4.z);
        h[s + 3] = fmaf(ex2(dtv * a[s + 3]), h[s + 3], dx * b4.w);
        acc[0] = fmaf(h[s], c4.x, acc[0]);
        acc[1] = fmaf(h[s + 1], c4.y, acc[1]);
        acc[2] = fmaf(h[s + 2], c4.z, acc[2]);
        acc[3] = fmaf(h[s + 3], c4.w, acc[3]);
      }
      if (active && t < len) *yp = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      yp += di;
    }
  }

  if (active) {
    float4* out = reinterpret_cast<float4*>(h_end + ((size_t)b * di + d) * DS);
#pragma unroll
    for (int s = 0; s < DS / 4; ++s)
      out[s] = make_float4(h[4 * s], h[4 * s + 1], h[4 * s + 2], h[4 * s + 3]);
  }
}

template <int DS>
int launch(const float* dt, const float* x, const float* Bm, const float* Cm,
           const float* A, float* y, float* h_end, int B, int S, int di,
           cudaStream_t stream) {
  const dim3 grid((di + THREADS - 1) / THREADS, B);
  const bool vec = di % 4 == 0 &&
                   ((uintptr_t)dt | (uintptr_t)x | (uintptr_t)Bm |
                    (uintptr_t)Cm) % 16 == 0;
  if (vec)
    mamba_scan_fwd<DS, true><<<grid, THREADS, 0, stream>>>(
        dt, x, Bm, Cm, A, y, h_end, S, di);
  else
    mamba_scan_fwd<DS, false><<<grid, THREADS, 0, stream>>>(
        dt, x, Bm, Cm, A, y, h_end, S, di);
  return (int)cudaGetLastError();
}

}  // namespace

// dt, x, y: [B,S,di]; Bm, Cm: [B,S,ds]; A: [di,ds]; h_end: [B,di,ds] (16-byte
// aligned); all fp32 and contiguous.  ds in {8, 16, 32} (the caller pads
// others with zeros).
extern "C" int repro_mamba_scan(const void* dt, const void* x, const void* Bm,
                                const void* Cm, const void* A, void* y,
                                void* h_end, int B, int S, int di, int ds,
                                void* stream) {
  if (B <= 0 || B > 65535 || S < 0 || di <= 0)
    return (int)cudaErrorInvalidValue;
  const float* dt_ = static_cast<const float*>(dt);
  const float* x_ = static_cast<const float*>(x);
  const float* b_ = static_cast<const float*>(Bm);
  const float* c_ = static_cast<const float*>(Cm);
  const float* a_ = static_cast<const float*>(A);
  float* y_ = static_cast<float*>(y);
  float* h_ = static_cast<float*>(h_end);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ds) {
    case 8:
      return launch<8>(dt_, x_, b_, c_, a_, y_, h_, B, S, di, st);
    case 16:
      return launch<16>(dt_, x_, b_, c_, a_, y_, h_, B, S, di, st);
    case 32:
      return launch<32>(dt_, x_, b_, c_, a_, y_, h_, B, S, di, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
