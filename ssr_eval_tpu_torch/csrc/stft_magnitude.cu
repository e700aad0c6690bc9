// |STFT| of hop-strided frames, read straight from a reflect-extended signal,
// by a shared-memory FFT.
//
// Replaces ssr_eval_tpu/dsp/pallas_stft.py::fused_ct_stft_magnitude (the
// Pallas kernel _ct_kernel, defined at pallas_stft.py:81 and launched at
// pallas_stft.py:123).
//
//   out[b, f, k] = | sum_n ext[b, f*hop + n] * win[n] * exp(-2*pi*i*n*k/N) |
//
// for every frame f < max_frames and bin k <= N/2, for any N <= 4096 (the
// Pallas kernel takes only N = 2^L * 128).  Framing, window, transform and
// magnitude run in one pass: frames and complex spectra never reach device
// memory.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 outside the tensor
// cores).  At the main path's shape (B = 16 buffers of 329,728 extended
// samples, 744 frames, N = 2048, 1025 bins) a call must read 21 MB and
// write 49 MB: ~70 MB, ~21 us.  An FFT needs ~0.7 GFLOP for it (2.5 N log2 N
// per frame), ~0.01 ms, so the call is memory-bound in principle; in
// practice the shared-memory round trips of the FFT passes set the pace, so
// the design keeps their number low (radix-16 passes, the input load fused
// into the first pass, the last pass storing straight to its consumer).
//
// Two transform paths, chosen by N (the wrapper's table plan,
// dsp/stft_kernel.py::_fft_plan, builds the matching tables):
//   split (N a power of two >= 2): z[n] = w x[2n] + i w x[2n+1] goes through
//     one P = N/2 point complex FFT, then
//     X[k] = (Z[k] + conj Z[P-k])/2 - i/2 e^{-2 pi i k/N} (Z[k] - conj Z[P-k]).
//   Bluestein (every other N, and N = 1): a[n] = x[n] w[n] c[n] with the
//     chirp c[n] = e^{-i pi (n^2 mod 2N)/N}; A = FFT_M(a); the table D holds
//     conj(FFT_M(conj c, wrapped)) / M; |X[k]| = |FFT_M(conj(A) * D)[k]|.
//     Only bins k < K = N/2 + 1 are kept, so the circular convolution needs
//     M >= N + K - 1 (not 2N - 1): M = 4096 at N = 2229, 2048 at N = 743.
//     |c[k]| = 1, so the output chirp multiply drops out of the magnitude.
//
// The complex FFT is Stockham (autosort, no bit reversal): radix-16 passes,
// then one radix-2, 4 or 8 pass for the rest of log2 P, all unrolled at
// compile time per P.  Each thread holds one radix-16 group (16 complex
// values) in registers; a pass reads all groups, synchronises and writes
// them back in place (one buffer per frame, P + P/16 float2: one pad slot
// every 16 entries makes the stride-16 writes conflict-free).  The first
// pass reads its groups straight from ext (coalesced 4-byte loads: hop
// leaves frame starts unaligned); the last pass of each Bluestein FFT
// stores through a functor (the first multiplies by D, the second writes
// |.| to device memory as coalesced rows).  Twiddles come from a table laid
// out per pass as [pass][r-1][k] (float64-built, float32-stored), so the
// lanes of a warp read consecutive entries; there is no sinf/cosf and no
// recurrence in the kernel, only the radix-16 butterfly's eight constants.
//
// Launch: a flat 1-D grid over the B x max_frames frames; a frame takes
// T = P/16 threads, and a block holds 256/T frames when P < 4096.  Each
// frame is transformed by the same code in a fixed order with no atomics,
// so a row's output does not depend on its batch.  No TF32, no tensor
// cores.
//
// The backward (ssr_stft_magnitude_backward, every N <= 4096) has no TPU
// counterpart: XLA differentiates the JAX package's |STFT|.  For one frame
// with y = w * frame, X = rFFT(y), m = |X| and upstream gradient g:
//   H[k] = g[k] X[k] / m[k]  (0 where m[k] = 0, torch's abs backward)
//   d frame[n] = w[n] Re sum_{k<=N/2} H[k] e^{+2 pi i k n/N}
// and d ext is the overlap-add of d frame at stride hop.  Nothing of the
// forward is saved but ext: each frame's spectrum is recomputed.  Per frame,
// in shared memory:
//   split: the forward's Stockham FFT gives Z; each thread turns a pair
//     (Z[k], Z[P-k]) into (X[k], X[P-k]), then H, then the pair (C[k],
//     C[P-k]) of the half-length inverse in place, with
//       C[k] = (H[k] + conj H[P-k])/2 + i e^{+2 pi i k/N} (H[k] - conj H[P-k])/2,
//       C[0] = (Re H[0] + Re H[P]) + i (Re H[0] - Re H[P]);
//     then c = conj(FFT_P(conj C)) gives d frame[2m] = w Re c[m] and
//     d frame[2m+1] = w Im c[m].
//   Bluestein, at the forward's M: the forward's two FFTs leave
//     F[k] = c[k] conj X[k], so u[k] = g[k] conj F[k] / |F[k]| = H[k] conj c[k]
//     for k < K (0 beyond).  With nk = (n^2 + k^2 - (n-k)^2)/2 the inverse is
//     a chirp-z too: d frame[n] = w[n] Re(conj c[n] sum_{k<K} u[k] c[n-k]),
//     a linear convolution of K inputs into N outputs, exact circularly at
//     the same M >= N + K - 1.  Its kernel e[m] = c[|m|] is conj(b[-m]) for
//     the forward's b, so FFT(e) = conj FFT(b) and the forward's table D
//     serves: conj(FFT_M(u) D) -> FFT_M -> G = conj(u * e), and
//     d frame[n] = w[n] Re(c[n] G[n]).  Four M-point FFTs per frame.
// Each frame's gradient lands in its own FFT buffer (N unpadded floats).
// One launch; the overlap-add is fused in shared memory.  A block owns the
// output samples under S consecutive frame starts of one row, [s S hop,
// (s+1) S hop) (the last segment runs to the end of the row), and computes
// every frame that covers them: its S frames and the halo = ceil(N/hop) - 1
// frames that start before the segment (their other samples belong to the
// block before, which computes them too).  Frames run in rounds of the
// block's frames in ascending order; after each round the block adds the
// round's frames, in ascending order, into a shared-memory ring of the
// segment's open samples (a power of two >= N slots), and after frame f
// writes out every sample below (f+1) hop, which no later frame reaches (0
// past the last frame's end).  One thread owns each sample (its adds, its
// write, its slot), so the ring needs no barrier.  So each sample is one
// fixed-order float32 sum, starting from 0, over its covering frames in
// ascending order: the same for any S and any batch, with no atomics and
// no per-frame scratch in device memory.  The ring keeps shared memory at
// the forward's plus N floats whatever S, so S only trades the halo's
// recompute against how evenly the blocks fill the SMs: segment_frames
// picks it per shape.
// Bound: ext and g read once, d ext written once (at [16, 604 frames],
// 2048/441: 74 MB, ~22 us at 3.35 TB/s) against 2 x 2.5 N log2 N per frame
// (1.1 GFLOP, ~16 us at 67 TFLOP/s): bytes bound it.  As in the forward,
// shared-memory round trips of the FFT passes set the pace in practice;
// the halo adds about halo/S to them.

#include <cuda_runtime.h>

#include <algorithm>
#include <array>
#include <climits>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace {

constexpr int kMaxFft = 4096;
constexpr int kBlockThreads = 256;  // threads of a block when P <= 4096

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }

// Forward DFTs in natural order, in place.
__device__ __forceinline__ void dft2(float2& a, float2& b) {
  const float2 t = a;
  a = cadd(t, b);
  b = csub(t, b);
}

__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2, float2& v3) {
  const float2 t0 = cadd(v0, v2), t1 = csub(v0, v2);
  const float2 t2 = cadd(v1, v3), t3 = mul_neg_i(csub(v1, v3));
  v0 = cadd(t0, t2);
  v2 = csub(t0, t2);
  v1 = cadd(t1, t3);
  v3 = csub(t1, t3);
}

constexpr float kH = 0.70710678118654752440f;   // cos(pi/4)
constexpr float kC1 = 0.92387953251128675613f;  // cos(pi/8)
constexpr float kS1 = 0.38268343236508977173f;  // sin(pi/8)

__device__ __forceinline__ void dft8(float2* v) {
  dft4(v[0], v[2], v[4], v[6]);  // even samples -> e0..e3 in v[0], v[2], v[4], v[6]
  dft4(v[1], v[3], v[5], v[7]);  // odd samples  -> o0..o3 in v[1], v[3], v[5], v[7]
  const float2 o1 = cmul(v[3], make_float2(kH, -kH));   // * e^{-i pi/4}
  const float2 o2 = mul_neg_i(v[5]);                    // * e^{-i pi/2}
  const float2 o3 = cmul(v[7], make_float2(-kH, -kH));  // * e^{-3i pi/4}
  const float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6], o0 = v[1];
  v[0] = cadd(e0, o0);
  v[4] = csub(e0, o0);
  v[1] = cadd(e1, o1);
  v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2);
  v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3);
  v[7] = csub(e3, o3);
}

// 16 = 4 x 4: DFT4 over n2 of v[n1 + 4 n2] into slot n1 + 4 k1, twiddle by
// e^{-2 pi i n1 k1/16}, DFT4 over n1 into slot 4 k1 + k2, which holds
// X[k1 + 4 k2]; the final transpose puts X in natural order.
__device__ __forceinline__ void dft16(float2* v) {
#pragma unroll
  for (int n1 = 0; n1 < 4; ++n1) dft4(v[n1], v[n1 + 4], v[n1 + 8], v[n1 + 12]);
  const float2 w1 = make_float2(kC1, -kS1), w2 = make_float2(kH, -kH), w3 = make_float2(kS1, -kC1);
  const float2 w6 = make_float2(-kH, -kH), w9 = make_float2(-kC1, kS1);
  v[5] = cmul(v[5], w1);
  v[9] = cmul(v[9], w2);
  v[13] = cmul(v[13], w3);
  v[6] = cmul(v[6], w2);
  v[10] = mul_neg_i(v[10]);
  v[14] = cmul(v[14], w6);
  v[7] = cmul(v[7], w3);
  v[11] = cmul(v[11], w6);
  v[15] = cmul(v[15], w9);
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) dft4(v[4 * k1], v[4 * k1 + 1], v[4 * k1 + 2], v[4 * k1 + 3]);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = a + 1; b < 4; ++b) {
      const float2 s = v[4 * a + b];
      v[4 * a + b] = v[4 * b + a];
      v[4 * b + a] = s;
    }
  }
}

template <int R>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 2) {
    dft2(v[0], v[1]);
  } else if constexpr (R == 4) {
    dft4(v[0], v[1], v[2], v[3]);
  } else if constexpr (R == 8) {
    dft8(v);
  } else {
    dft16(v);
  }
}

struct LoadBuf {
  const float2* buf;
  __device__ __forceinline__ float2 operator()(int i) const { return buf[pad(i)]; }
};

struct StoreBuf {
  float2* buf;
  __device__ __forceinline__ void operator()(int i, float2 v) const { buf[pad(i)] = v; }
};

// Split path input: z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1].
struct LoadPairs {
  const float* __restrict__ x;
  const float* __restrict__ win;
  bool valid;
  __device__ __forceinline__ float2 operator()(int n) const {
    if (!valid) return make_float2(0.f, 0.f);
    return make_float2(__ldg(x + 2 * n) * __ldg(win + 2 * n),
                       __ldg(x + 2 * n + 1) * __ldg(win + 2 * n + 1));
  }
};

// Bluestein input: a[n] = x[n] w[n] c[n] for n < N, zero beyond.
struct LoadChirp {
  const float* __restrict__ x;
  const float* __restrict__ win;
  const float2* __restrict__ chirp;
  int n_fft;
  bool valid;
  __device__ __forceinline__ float2 operator()(int n) const {
    if (!valid || n >= n_fft) return make_float2(0.f, 0.f);
    const float s = __ldg(x + n) * __ldg(win + n);
    const float2 c = __ldg(chirp + n);
    return make_float2(s * c.x, s * c.y);
  }
};

// Bluestein, end of the first FFT: conj(A[i]) * D[i], back into the buffer.
struct StoreConjMul {
  float2* buf;
  const float2* __restrict__ d;
  __device__ __forceinline__ void operator()(int i, float2 v) const {
    const float2 w = __ldg(d + i);
    buf[pad(i)] = make_float2(v.x * w.x + v.y * w.y, v.x * w.y - v.y * w.x);
  }
};

// Bluestein, end of the second FFT: |.| of the first n_bins points.
struct StoreMag {
  float* out;
  int n_bins;
  bool valid;
  __device__ __forceinline__ void operator()(int i, float2 v) const {
    if (valid && i < n_bins) out[i] = sqrtf(v.x * v.x + v.y * v.y);
  }
};

// Threads per frame for a P-point FFT: one radix-16 group each.
template <int P>
__host__ __device__ constexpr int frame_threads() {
  return P >= 16 ? P / 16 : 1;
}

// Threads per block: 256 (256/T frames) up to P = 4096, T beyond.
template <int P>
__host__ __device__ constexpr int block_threads() {
  return frame_threads<P>() >= kBlockThreads ? frame_threads<P>()
                                             : kBlockThreads / frame_threads<P>() * frame_threads<P>();
}

// Resident blocks per SM that the register allocation must allow, chosen
// by timing each path at the main shapes on an H100 (PERF.md §6): the
// split path runs best at 4 blocks of 256 threads (64 registers), Bluestein,
// whose first pass keeps three input streams in flight, at 2 (128
// registers; at 64 it spills).  Left to itself ptxas gives the 4096-point
// Bluestein kernel ~170 registers: one block per SM.
template <int P, bool kBluestein>
__host__ __device__ constexpr int min_blocks() {
  return block_threads<P>() > kBlockThreads ? 1 : kBluestein ? 2 : 4;
}

// One Stockham radix-R pass over P points whose sub-transforms have length
// Ns so far.  Group j (< P/R) loads entries j + r P/R, twiddles entry r by
// e^{-2 pi i r k/(Ns R)} (k = j mod Ns), runs the R-point DFT and stores
// entry r at (j - k) R + k + r Ns.  The frame's T threads take groups
// t, t + T, ...: 16/R each.  kReadsBuf: `load` reads the buffer that
// `store` writes, so all reads finish before the first write.
template <int P, int Ns, int R, bool kReadsBuf, class Load, class Store>
__device__ __forceinline__ void fft_pass(const float2* __restrict__ tw, int t, const Load& load,
                                         const Store& store) {
  constexpr int T = frame_threads<P>();
  constexpr int kSpan = P / R;
  constexpr int kGroups = (kSpan + T - 1) / T;
  float2 v[kGroups][R];
#pragma unroll
  for (int s = 0; s < kGroups; ++s) {
    const int j = t + s * T;
    if (kSpan % T == 0 || j < kSpan) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[s][r] = load(j + r * kSpan);
    }
  }
  if constexpr (kReadsBuf) __syncthreads();
#pragma unroll
  for (int s = 0; s < kGroups; ++s) {
    const int j = t + s * T;
    if (kSpan % T == 0 || j < kSpan) {
      const int k = j & (Ns - 1);
      if constexpr (Ns > 1) {
#pragma unroll
        for (int r = 1; r < R; ++r) v[s][r] = cmul(v[s][r], __ldg(tw + (r - 1) * Ns + k));
      }
      dft<R>(v[s]);
      const int base = (j - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) store(base + r * Ns, v[s][r]);
    }
  }
  __syncthreads();
}

// The passes of a P-point forward FFT from sub-length Ns on: radix 16 while
// P/Ns >= 16, then the rest.  The first pass loads through `load`, later
// ones from the buffer; the last stores through `last`.
template <int P, int Ns, bool kFirst, bool kFirstReadsBuf, class Load, class Last>
__device__ __forceinline__ void fft_passes(float2* buf, const float2* __restrict__ tw, int t,
                                           const Load& load, const Last& last) {
  constexpr int R = P / Ns >= 16 ? 16 : P / Ns;
  constexpr bool kLast = Ns * R == P;
  if constexpr (kFirst && kLast) {
    fft_pass<P, Ns, R, kFirstReadsBuf>(tw, t, load, last);
  } else if constexpr (kFirst) {
    fft_pass<P, Ns, R, kFirstReadsBuf>(tw, t, load, StoreBuf{buf});
  } else if constexpr (kLast) {
    fft_pass<P, Ns, R, true>(tw, t, LoadBuf{buf}, last);
  } else {
    fft_pass<P, Ns, R, true>(tw, t, LoadBuf{buf}, StoreBuf{buf});
  }
  if constexpr (!kLast) {
    fft_passes<P, Ns * R, false, true>(buf, tw + (R - 1) * Ns, t, load, last);
  }
}

// In-place forward FFT of a P-point frame: input through `load`, output
// through `last`.  Every thread of the block calls it (barriers).
template <int P, bool kLoadReadsBuf, class Load, class Last>
__device__ __forceinline__ void fft(float2* buf, const float2* __restrict__ tw, int t,
                                    const Load& load, const Last& last) {
  if constexpr (P == 1) {
    const float2 v = load(0);
    if constexpr (kLoadReadsBuf) __syncthreads();
    last(0, v);
    __syncthreads();
  } else {
    fft_passes<P, 1, true, kLoadReadsBuf>(buf, tw, t, load, last);
  }
}

// One frame per T threads; the block's frames are consecutive rows of the
// flattened [B * max_frames] output.  P = 2^kLog2P is the complex FFT's
// length: N/2 on the split path, M for Bluestein.
template <bool kBluestein, int kLog2P>
__global__ void __launch_bounds__(block_threads<1 << kLog2P>(), min_blocks<1 << kLog2P, kBluestein>())
stft_fft_kernel(const float* __restrict__ ext, const float* __restrict__ win,
                const float2* __restrict__ tw, const float2* __restrict__ table_a,
                const float2* __restrict__ table_b, float* __restrict__ out, int ext_len,
                int n_fft, int hop, int max_frames, int n_frames) {
  constexpr int P = 1 << kLog2P;
  constexpr int T = frame_threads<P>();
  constexpr int kFrames = T >= kBlockThreads ? 1 : kBlockThreads / T;
  constexpr int kBufLen = P + ((P - 1) >> 4);
  extern __shared__ float2 smem[];
  const int t = threadIdx.x % T;
  const int fl = threadIdx.x / T;
  float2* buf = smem + fl * kBufLen;
  const int g = blockIdx.x * kFrames + fl;
  const bool valid = g < n_frames;
  const int b = valid ? g / max_frames : 0;
  const int f = valid ? g - b * max_frames : 0;
  const float* x = ext + static_cast<size_t>(b) * ext_len + static_cast<size_t>(f) * hop;
  const int n_bins = n_fft / 2 + 1;
  float* o = out + static_cast<size_t>(valid ? g : 0) * n_bins;

  if constexpr (!kBluestein) {
    fft<P, false>(buf, tw, t, LoadPairs{x, win, valid}, StoreBuf{buf});
    for (int k = t; k < n_bins; k += T) {
      const float2 zk = buf[pad(k & (P - 1))];
      const float2 zr = buf[pad((P - k) & (P - 1))];
      const float2 zc = make_float2(zr.x, -zr.y);
      const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y + zc.y));
      const float2 od = mul_neg_i(make_float2(0.5f * (zk.x - zc.x), 0.5f * (zk.y - zc.y)));
      const float2 xk = cadd(e, cmul(__ldg(table_a + k), od));
      if (valid) o[k] = sqrtf(xk.x * xk.x + xk.y * xk.y);
    }
  } else {
    fft<P, false>(buf, tw, t, LoadChirp{x, win, table_a, n_fft, valid}, StoreConjMul{buf, table_b});
    fft<P, true>(buf, tw, t, LoadBuf{buf}, StoreMag{o, n_bins, valid});
  }
}


// Backward, start of the split inverse: conj(C[i]) from the buffer.
struct LoadConjBuf {
  const float2* buf;
  __device__ __forceinline__ float2 operator()(int i) const {
    const float2 v = buf[pad(i)];
    return make_float2(v.x, -v.y);
  }
};

// Backward, end of the split inverse: F = FFT_P(conj C) = conj(c), so
// d frame[2m] = w[2m] Re F[m] and d frame[2m+1] = -w[2m+1] Im F[m], into
// the frame's buffer read as unpadded (d frame[2m], d frame[2m+1]) pairs.
struct StoreFrameGrad {
  float2* d;
  const float2* __restrict__ win;
  __device__ __forceinline__ void operator()(int m, float2 v) const {
    const float2 w = __ldg(win + m);
    d[m] = make_float2(w.x * v.x, -w.y * v.y);
  }
};

// X[k] of the split from the half-length spectrum: zk = Z[k], zr = Z[P-k].
__device__ __forceinline__ float2 split_bin(float2 zk, float2 zr, float2 a) {
  const float2 zc = make_float2(zr.x, -zr.y);
  const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y + zc.y));
  const float2 od = mul_neg_i(make_float2(0.5f * (zk.x - zc.x), 0.5f * (zk.y - zc.y)));
  return cadd(e, cmul(a, od));
}

// H = g X / |X|, 0 where |X| = 0 (|X| rounded as the forward rounds it).
__device__ __forceinline__ float2 mag_grad(float2 x, float g) {
  const float m = sqrtf(x.x * x.x + x.y * x.y);
  if (m == 0.f) return make_float2(0.f, 0.f);
  return make_float2(g * (x.x / m), g * (x.y / m));
}

// Bluestein backward, end of the second FFT: F[k] = c[k] conj X[k] ->
// u[k] = g[k] conj F[k] / |F[k]| for k < n_bins, 0 beyond.
struct StoreChirpMagGrad {
  float2* buf;
  const float* __restrict__ gm;
  int n_bins;
  bool valid;
  __device__ __forceinline__ void operator()(int i, float2 v) const {
    float2 u = make_float2(0.f, 0.f);
    if (valid && i < n_bins) u = mag_grad(make_float2(v.x, -v.y), __ldg(gm + i));
    buf[pad(i)] = u;
  }
};

// Bluestein backward, end of the third FFT: conj(U[i] D[i]).
struct StoreMulConj {
  float2* buf;
  const float2* __restrict__ d;
  __device__ __forceinline__ void operator()(int i, float2 v) const {
    const float2 w = __ldg(d + i);
    buf[pad(i)] = make_float2(v.x * w.x - v.y * w.y, -(v.x * w.y + v.y * w.x));
  }
};

// Bluestein backward, end of the fourth FFT: d frame[n] = w[n] Re(c[n] G[n])
// for n < N, into the frame's buffer read as unpadded floats.
struct StoreChirpGrad {
  float* d;
  const float* __restrict__ win;
  const float2* __restrict__ chirp;
  int n_fft;
  __device__ __forceinline__ void operator()(int n, float2 v) const {
    if (n >= n_fft) return;
    const float2 c = __ldg(chirp + n);
    d[n] = __ldg(win + n) * (c.x * v.x - c.y * v.y);
  }
};

// The gradient of one frame, d frame[n] for n < N, left in `buf` as
// unpadded floats (see the head of the file).  x: the frame's first sample;
// gm: its n_bins upstream gradients.  An invalid frame reads zeros and
// leaves garbage.  Every thread of the block calls it (barriers); it ends
// with one.  Not inlined: as a call its transforms get the registers to
// themselves, where inlined they shared them with the segment's state and
// spilled, and ran slower on an H100 (PERF.md §6).
template <bool kBluestein, int P>
__device__ __noinline__ void frame_grad(float2* buf, const float* __restrict__ x,
                                           const float* __restrict__ win, const float2* __restrict__ tw,
                                           const float2* __restrict__ table_a,
                                           const float2* __restrict__ table_b,
                                           const float* __restrict__ gm, int n_fft, int t, bool valid) {
  constexpr int T = frame_threads<P>();
  if constexpr (!kBluestein) {
    fft<P, false>(buf, tw, t, LoadPairs{x, win, valid}, StoreBuf{buf});
    // Pairs (k, P - k), k <= P/2: each thread reads and writes only its own
    // pair's two slots, so the in-place update needs no barrier inside.
    for (int k = t; k <= P / 2; k += T) {
      const int j = P - k;
      const float2 zk = buf[pad(k)];
      const float2 zj = buf[pad(j & (P - 1))];
      const float2 ak = __ldg(table_a + k), aj = __ldg(table_a + j);
      const float2 hk = mag_grad(split_bin(zk, zj, ak), __ldg(gm + k));
      const float2 hj = mag_grad(split_bin(zj, zk, aj), __ldg(gm + j));
      if (k == 0) {
        buf[pad(0)] = make_float2(hk.x + hj.x, hk.x - hj.x);
        continue;
      }
      // e^{+2 pi i k/N} = conj(table_a[k])
      const float2 ek = make_float2(0.5f * (hk.x + hj.x), 0.5f * (hk.y - hj.y));
      const float2 ok = cmul(make_float2(0.5f * (hk.x - hj.x), 0.5f * (hk.y + hj.y)), make_float2(ak.x, -ak.y));
      buf[pad(k)] = make_float2(ek.x - ok.y, ek.y + ok.x);  // E + i O
      if (j != k) {
        const float2 ej = make_float2(ek.x, -ek.y);  // (H[j] + conj H[k])/2 = conj E[k]
        const float2 oj =
            cmul(make_float2(0.5f * (hj.x - hk.x), 0.5f * (hj.y + hk.y)), make_float2(aj.x, -aj.y));
        buf[pad(j)] = make_float2(ej.x - oj.y, ej.y + oj.x);
      }
    }
    __syncthreads();
    fft<P, true>(buf, tw, t, LoadConjBuf{buf}, StoreFrameGrad{buf, reinterpret_cast<const float2*>(win)});
  } else {
    fft<P, false>(buf, tw, t, LoadChirp{x, win, table_a, n_fft, valid}, StoreConjMul{buf, table_b});
    fft<P, true>(buf, tw, t, LoadBuf{buf}, StoreChirpMagGrad{buf, gm, n_fft / 2 + 1, valid});
    fft<P, true>(buf, tw, t, LoadBuf{buf}, StoreMulConj{buf, table_b});
    fft<P, true>(buf, tw, t, LoadBuf{buf}, StoreChirpGrad{reinterpret_cast<float*>(buf), win, table_a, n_fft});
  }
}

// Resident blocks per SM of the backward, chosen by timing on an H100
// (PERF.md §6): the forward's, except that the split path runs best
// at 3 blocks (80 registers; at 64 the segment's bookkeeping beside the
// FFT spills, at 128 two blocks leave the SM idle).
template <int P, bool kBluestein>
__host__ __device__ constexpr int bwd_min_blocks() {
  return kBluestein || block_threads<P>() > kBlockThreads ? min_blocks<P, kBluestein>() : 3;
}

// The backward: block blockIdx.x = b * n_seg + s owns samples
// [s S hop, (s+1) S hop) of row b (the last segment: to ext_len), S =
// seg_frames.  Dynamic shared memory: the frames' FFT buffers, then a ring
// of ring_len floats (a power of two >= max(N, threads)) holding the
// samples not yet written.  Sample j is added to, written out and cleared
// by thread j mod threads alone, in its slot j mod ring_len: after frame f
// every sample below (f+1) hop is final, and a slot is reused only by a
// sample at least N later, which no frame before the next one reaches.
// Same threads per frame and frames per block as the forward; P = N/2 on
// the split path, M for Bluestein.
template <bool kBluestein, int kLog2P>
__global__ void __launch_bounds__(block_threads<1 << kLog2P>(), bwd_min_blocks<1 << kLog2P, kBluestein>())
stft_bwd_kernel(const float* __restrict__ ext, const float* __restrict__ win,
                const float2* __restrict__ tw, const float2* __restrict__ table_a,
                const float2* __restrict__ table_b, const float* __restrict__ grad_mag,
                float* __restrict__ grad_ext, int ext_len, int n_fft, int hop, int max_frames,
                int seg_frames, int n_seg, int ring_len) {
  constexpr int P = 1 << kLog2P;
  constexpr int T = frame_threads<P>();
  constexpr int kThreads = block_threads<P>();
  constexpr int kFrames = kThreads / T;
  constexpr int kBufLen = P + ((P - 1) >> 4);
  extern __shared__ float2 smem[];
  float* ring = reinterpret_cast<float*>(smem + kFrames * kBufLen);
  const int tid = threadIdx.x;
  const int b = blockIdx.x / n_seg;
  const int s = blockIdx.x - b * n_seg;
  const int n_bins = n_fft / 2 + 1;
  const int j0 = s * seg_frames * hop;
  const int j1 = s == n_seg - 1 ? ext_len : j0 + seg_frames * hop;
  // frames covering [j0, j1): f hop <= j < f hop + N
  const int f_begin = j0 >= n_fft ? (j0 - n_fft) / hop + 1 : 0;
  const int f_end = min(max_frames, (s + 1) * seg_frames);
  float* out = grad_ext + static_cast<size_t>(b) * ext_len;

  for (int i = tid; i < ring_len; i += kThreads) ring[i] = 0.f;
  int written = j0;  // samples of [j0, written) are out
  for (int f0 = f_begin; f0 < f_end; f0 += kFrames) {
    const int fl = tid / T;
    const int fv = min(f0 + fl, f_end - 1);
    frame_grad<kBluestein, P>(smem + fl * kBufLen,
                              ext + static_cast<size_t>(b) * ext_len + static_cast<size_t>(fv) * hop, win, tw,
                              table_a, table_b, grad_mag + (static_cast<size_t>(b) * max_frames + fv) * n_bins,
                              n_fft, tid % T, f0 + fl < f_end);
    const int f_last = min(f0 + kFrames, f_end) - 1;
    for (int f = f0; f <= f_last; ++f) {  // ascending: each sample's order
      const float* d = reinterpret_cast<const float*>(smem + (f - f0) * kBufLen);
      const int lo = max(j0, f * hop), hi = min(j1, f * hop + n_fft);
      for (int j = lo + ((tid - lo) & (kThreads - 1)); j < hi; j += kThreads) {
        ring[j & (ring_len - 1)] += d[j - f * hop];
      }
      const int done = f == f_end - 1 ? j1 : min(j1, (f + 1) * hop);
      for (int j = written + ((tid - written) & (kThreads - 1)); j < done; j += kThreads) {
        float& slot = ring[j & (ring_len - 1)];
        out[j] = slot;
        slot = 0.f;
      }
      written = max(written, done);
    }
    __syncthreads();  // the next round overwrites the buffers
  }
}

using KernelFn = void (*)(const float*, const float*, const float2*, const float2*, const float2*,
                          float*, int, int, int, int, int);
using BwdFn = void (*)(const float*, const float*, const float2*, const float2*, const float2*,
                       const float*, float*, int, int, int, int, int, int, int);

template <bool kBluestein, int... L>
std::array<KernelFn, sizeof...(L)> kernel_table(std::integer_sequence<int, L...>) {
  return {{&stft_fft_kernel<kBluestein, L>...}};
}

template <bool kBluestein, int... L>
std::array<BwdFn, sizeof...(L)> bwd_table(std::integer_sequence<int, L...>) {
  return {{&stft_bwd_kernel<kBluestein, L>...}};
}

// Split: P = N/2 <= 2048 (log2 P <= 11); Bluestein: M <= 8192 (log2 M <= 13).
const auto kSplitKernels = kernel_table<false>(std::make_integer_sequence<int, 12>{});
const auto kBluesteinKernels = kernel_table<true>(std::make_integer_sequence<int, 14>{});
const auto kBwdSplitKernels = bwd_table<false>(std::make_integer_sequence<int, 12>{});
const auto kBwdBluesteinKernels = bwd_table<true>(std::make_integer_sequence<int, 14>{});

// Frames per block and dynamic shared memory of a P-point frame kernel.
void frame_launch_shape(int fft_len, int* frames_per_block, size_t* smem) {
  const int T = fft_len >= 16 ? fft_len / 16 : 1;
  *frames_per_block = T >= kBlockThreads ? 1 : kBlockThreads / T;
  const int buf_len = fft_len + ((fft_len - 1) >> 4);
  *smem = static_cast<size_t>(*frames_per_block) * buf_len * sizeof(float2);
}

// The transform of N and its checks: fft_len must be N/2 for a power-of-two
// N >= 2 and the next power of two >= N + N/2 otherwise.
bool fft_shape(int n_fft, int fft_len, bool* split, int* log2_len) {
  *split = n_fft >= 2 && (n_fft & (n_fft - 1)) == 0;
  int want = *split ? n_fft / 2 : 1;
  while (!*split && want < n_fft + n_fft / 2) want <<= 1;
  *log2_len = 0;
  while ((1 << *log2_len) < want) ++*log2_len;
  return fft_len == want;
}

bool frames_fit(int n_fft, int hop, int max_frames, int ext_len) {
  return n_fft > 0 && n_fft <= kMaxFft && hop > 0 && max_frames > 0 &&
         static_cast<long long>(ext_len) >= static_cast<long long>(max_frames - 1) * hop + n_fft;
}

// A backward launch's kernel, threads, frames per block, ring and dynamic
// shared memory (the frames' buffers, then the ring: at most 86 KB, for
// M = 8192) for N.
struct BwdShape {
  BwdFn kernel;
  int threads, frames_per_block, ring_len;
  size_t smem;
};

BwdShape bwd_shape(bool split, int log2_len, int n_fft, int fft_len) {
  BwdShape b;
  b.kernel = split ? kBwdSplitKernels[log2_len] : kBwdBluesteinKernels[log2_len];
  frame_launch_shape(fft_len, &b.frames_per_block, &b.smem);
  b.threads = (fft_len >= 16 ? fft_len / 16 : 1) * b.frames_per_block;
  b.ring_len = 1;
  while (b.ring_len < std::max(n_fft, b.threads)) b.ring_len <<= 1;
  b.smem += sizeof(float) * b.ring_len;
  return b;
}

// S for a backward launch: the least
//   rounds(S) x ceil(blocks(S) / resident blocks),
// rounds(S) = ceil(min(S + halo, max_frames) / frames per block) and
// blocks(S) = batch x ceil(max_frames / S), the halo ceil(N/hop) - 1: a
// block's rounds, the halo's recompute included, times the waves of blocks.
// Ties go to the larger S (less recompute).  Cached per shape and device.
cudaError_t segment_frames(const BwdShape& sh, int batch, int n_fft, int hop, int max_frames, int* seg_frames) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int, int>, int> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(dev, batch, n_fft, hop, max_frames);
  std::lock_guard<std::mutex> lock(mu);
  auto hit = cache.find(key);
  if (hit == cache.end()) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(sh.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(sh.smem))) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sh.kernel, sh.threads, sh.smem)) !=
            cudaSuccess) {
      return err;
    }
    if (per_sm <= 0) return cudaErrorInvalidConfiguration;
    const long long slots = static_cast<long long>(sms) * per_sm;
    const int halo = (n_fft - 1) / hop;
    int best = 1;
    long long best_cost = LLONG_MAX;
    for (int s = 1; s <= max_frames; ++s) {
      const long long rounds = (std::min(s + halo, max_frames) + sh.frames_per_block - 1) / sh.frames_per_block;
      const long long blocks = static_cast<long long>(batch) * ((max_frames + s - 1) / s);
      const long long cost = rounds * ((blocks + slots - 1) / slots);
      if (cost <= best_cost) {
        best_cost = cost;
        best = s;
      }
    }
    hit = cache.emplace(key, best).first;
  }
  *seg_frames = hit->second;
  return cudaSuccess;
}

}  // namespace

// ext [batch, ext_len] f32, win [n_fft] f32, out [batch, max_frames,
// n_fft/2 + 1] f32; tables from dsp/stft_kernel.py::_fft_plan as interleaved
// (re, im) f32: twiddle = the per-pass FFT twiddles of the fft_len-point
// transform; split path: table_a = e^{-2 pi i k/N}, k <= N/2, table_b
// unused; Bluestein: table_a = the chirp c[n], n < N, table_b = D[j],
// j < fft_len.  All on the device, contiguous.  fft_len must be N/2 for a
// power-of-two N >= 2 and the next power of two >= N + N/2 otherwise.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int ssr_stft_magnitude(const float* ext, const float* win, const float* twiddle,
                                  const float* table_a, const float* table_b, float* out, int batch,
                                  int ext_len, int n_fft, int hop, int max_frames, int fft_len,
                                  void* stream) {
  bool split;
  int log2P;
  if (batch <= 0 || !frames_fit(n_fft, hop, max_frames, ext_len) || !fft_shape(n_fft, fft_len, &split, &log2P) ||
      twiddle == nullptr || table_a == nullptr || (!split && table_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_frames = static_cast<long long>(batch) * max_frames;
  if (n_frames > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int T = fft_len >= 16 ? fft_len / 16 : 1;
  int frames_per_block;
  size_t smem;
  frame_launch_shape(fft_len, &frames_per_block, &smem);
  const long long blocks = (n_frames + frames_per_block - 1) / frames_per_block;
  const KernelFn kernel = split ? kSplitKernels[log2P] : kBluesteinKernels[log2P];
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), T * frames_per_block, smem,
           static_cast<cudaStream_t>(stream)>>>(
      ext, win, reinterpret_cast<const float2*>(twiddle),
      reinterpret_cast<const float2*>(table_a), reinterpret_cast<const float2*>(table_b), out,
      ext_len, n_fft, hop, max_frames, static_cast<int>(n_frames));
  return static_cast<int>(cudaGetLastError());
}

// The frames per segment S that the backward takes for this shape on the
// current device when the caller leaves it (see segment_frames), into
// *seg_frames.  Returns a CUDA error code; a failed CUDA call's error is
// cleared, so no later launch reports it.
extern "C" int ssr_stft_magnitude_backward_plan(int batch, int ext_len, int n_fft, int hop, int max_frames,
                                                int fft_len, int* seg_frames) {
  bool split;
  int log2_len;
  if (batch <= 0 || !frames_fit(n_fft, hop, max_frames, ext_len) || !fft_shape(n_fft, fft_len, &split, &log2_len)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      segment_frames(bwd_shape(split, log2_len, n_fft, fft_len), batch, n_fft, hop, max_frames, seg_frames);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// The gradient of sum(grad_mag * |STFT|) with respect to ext, for any
// N <= 4096, in one launch.  ext, win, twiddle, table_a, table_b and
// fft_len as for ssr_stft_magnitude; grad_mag [batch, max_frames, N/2 + 1]
// f32; grad_ext [batch, ext_len] f32, every sample written.  seg_frames: S,
// the frames per segment (see the head of the file), <= 0 to leave it to
// segment_frames; the result does not depend on it.  win must be 8-byte
// aligned.  Launches on `stream` and returns cudaGetLastError().
extern "C" int ssr_stft_magnitude_backward(const float* ext, const float* win, const float* twiddle,
                                           const float* table_a, const float* table_b,
                                           const float* grad_mag, float* grad_ext, int batch,
                                           int ext_len, int n_fft, int hop, int max_frames,
                                           int fft_len, int seg_frames, void* stream) {
  bool split;
  int log2_len;
  if (batch <= 0 || !frames_fit(n_fft, hop, max_frames, ext_len) || !fft_shape(n_fft, fft_len, &split, &log2_len) ||
      twiddle == nullptr || table_a == nullptr || (!split && table_b == nullptr) ||
      (reinterpret_cast<size_t>(win) & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (seg_frames <= 0) {
    const int err = ssr_stft_magnitude_backward_plan(batch, ext_len, n_fft, hop, max_frames, fft_len, &seg_frames);
    if (err != cudaSuccess) return err;
  }
  seg_frames = std::min(seg_frames, max_frames);
  const BwdShape sh = bwd_shape(split, log2_len, n_fft, fft_len);
  const long long n_seg = (max_frames + seg_frames - 1) / seg_frames;
  const long long blocks = static_cast<long long>(batch) * n_seg;
  if (blocks > INT_MAX || static_cast<long long>(max_frames + seg_frames) * hop > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (sh.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(sh.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(sh.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sh.kernel<<<static_cast<unsigned>(blocks), sh.threads, sh.smem, static_cast<cudaStream_t>(stream)>>>(
      ext, win, reinterpret_cast<const float2*>(twiddle), reinterpret_cast<const float2*>(table_a),
      reinterpret_cast<const float2*>(table_b), grad_mag, grad_ext, ext_len, n_fft, hop, max_frames, seg_frames,
      static_cast<int>(n_seg), sh.ring_len);
  return static_cast<int>(cudaGetLastError());
}
