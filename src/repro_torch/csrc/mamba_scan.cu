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
// What bounds it on an H100: bytes.  At the serving path's prefill shape
// (dt/x [16,256,16384], ds 16) it moves 823.6 MB (dt, x and y at 268.4 MB
// each, h_end 16.8 MB): 0.246 ms at 3.35 TB/s.  It computes about 7.5 G
// fp32 operations (seven per state element and step, an exponential
// counted as one): 0.112 ms at 67 TFLOP/s.  chip_smoke.py computes both
// from the shapes it runs.
//
// What this design does about it: the TPU kernel blocks channels by 256 and
// walks time in chunks of 64 over a sequential grid axis, carrying h in
// VMEM scratch from one chunk to the next; the chunk is a VMEM artifact.
// The recurrence is elementwise in di, so here one thread owns one (b, d)
// channel and keeps its h[ds] (and A's row) in registers for the whole
// sequence: the only traffic is one read of dt and x and one write of y
// per channel and step, coalesced across the 128 channels of a block, and
// one write of h_end at the end.  B_t and C_t, shared by every channel of
// a row, are staged in shared memory for a tile of T steps; each thread
// loads its tile of dt and x into registers before the steps, so a
// thread has 2T independent loads in flight.  Steps past S (the ragged
// last tile) load dt = x = 0, which leaves h unchanged (exp(0) = 1), and
// write no y; channels past di compute nothing and write nothing, so the
// wrapper pads nothing.  The exponential is expf (not __expf), to hold
// 1e-3 against the recurrence over long sequences.
//
// C interface (ctypes): repro_mamba_scan returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // channels per block
constexpr int T = 16;         // time steps per staged tile

template <int DS>
__global__ void __launch_bounds__(THREADS)
mamba_scan_fwd(const float* __restrict__ dt, const float* __restrict__ x,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               const float* __restrict__ A, float* __restrict__ y,
               float* __restrict__ h_end, int S, int di) {
  static_assert(DS % 4 == 0, "h_end is stored as float4");
  __shared__ float sb[T * DS];
  __shared__ float sc[T * DS];

  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool active = d < di;
  const size_t row = (size_t)b * S;  // (b, t = 0)

  float a[DS], h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    a[s] = active ? A[(size_t)d * DS + s] : 0.f;
    h[s] = 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += T) {
    const int len = min(T, S - t0);
    __syncthreads();  // the previous tile's readers of sb / sc are done
    for (int i = threadIdx.x; i < T * DS; i += THREADS) {
      const bool ok = i / DS < len;
      const size_t off = (row + t0) * DS + i;
      sb[i] = ok ? Bm[off] : 0.f;
      sc[i] = ok ? Cm[off] : 0.f;
    }
    float dtv[T], xv[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const bool ok = active && t < len;
      const size_t off = (row + t0 + t) * di + d;
      dtv[t] = ok ? dt[off] : 0.f;
      xv[t] = ok ? x[off] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float dx = dtv[t] * xv[t];
      const float* bt = sb + t * DS;
      const float* ct = sc + t * DS;
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        h[s] = fmaf(expf(dtv[t] * a[s]), h[s], dx * bt[s]);
        acc = fmaf(h[s], ct[s], acc);
      }
      if (active && t < len) y[(row + t0 + t) * di + d] = acc;
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
  mamba_scan_fwd<DS><<<grid, THREADS, 0, stream>>>(dt, x, Bm, Cm, A, y, h_end,
                                                   S, di);
  return (int)cudaGetLastError();
}

}  // namespace

// dt, x, y: [B,S,di]; Bm, Cm: [B,S,ds]; A: [di,ds]; h_end: [B,di,ds] (16-byte
// aligned); all fp32 and contiguous.  ds in {8, 16}.
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
    default:
      return (int)cudaErrorInvalidValue;
  }
}
