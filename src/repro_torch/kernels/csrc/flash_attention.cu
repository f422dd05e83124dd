// Causal flash attention, forward, float32, for sm_90a.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel (the Pallas
// TPU kernel) for float32 inputs whose S·G rows per kv head are more than
// the split-KV decode (csrc/flash_decode.cu) takes; bf16 goes to the
// tensor-core kernel (csrc/flash_prefill.cu).  See
// kernels/flash_attention.py::flash_route.  It computes that kernel's
// function, not its block structure:
//
//   out[b, s, h] = Σ_t softmax_t(q[b,s,h]·k[b,t,kv] · scale) · v[b,t,kv]
//
// over the allowed keys t: kpos[t] >= 0, kpos[t] <= qpos[s] when causal,
// kpos[t] > qpos[s] - window when a window is set; kv = h / (H / KH).  The
// online softmax keeps m, l and the accumulator in float32.  A row with no
// allowed key gets 0 (the Pallas kernel averages V over its masked keys
// there; no caller keeps such rows).  Layouts are the reference's: q and
// out (B, S, H, hd), k and v (B, T, KH, hd), all contiguous; qpos (S,) and
// kpos (T,) int32.  Given an lse pointer (B, H, S), float32, it also
// stores each row's log-sum-exp of its scaled scores, m + log l (-inf for
// a row with no allowed key), which the backward
// (csrc/flash_attention_bwd.cu) recomputes P from; with a null pointer it
// stores nothing else, and out is the same either way.
//
// What bounds it: 4·hd flops per allowed (query, key) pair on 2·hd·4 bytes
// per key read from L2, so it is bound by arithmetic.  It uses float32
// FMAs on the CUDA cores (67 TFLOP/s peak): TF32 on the tensor cores
// would not meet float32's tolerance, and float32 serves the card-vs-CPU
// parity, not serving.
//
// Design (an SGEMM-style register tiling of both products):
// * One block of 256 threads per (tile of BM = 128 query rows (64 at hd
//   256, below), kv head, batch).  GQA is folded into the rows as in the
//   Pallas kernel: row r of
//   a (batch, kv head) is (s, g) = (r / G, r % G), so the G query heads
//   that share a kv head share every K/V tile the block stages.  Row
//   blocks are issued last-first, so the causal diagonal's longest rows
//   start first.
// * Thread (rg, cg), rg = 0..15 and cg = 0..15 (the 16 cg of one rg are
//   one half-warp), owns rows rg*TM .. rg*TM+TM-1 (TM = BM/16 = 8).  Of a
//   key tile of BN keys it owns keys cg + 16j (BN/16 of them); of the
//   output, hd/16 columns.
//   S = Q·Kᵀ is a TM × BN/16 micro-tile of outer products over hd: per
//   four dims, BN/16 + 8 16-byte shared loads feed 32·BN/16 FMAs.  Q is
//   staged once, transposed (Qs[d][row]); K and V tiles row-major with a
//   4-float pad, so the 16 key rows a half-warp reads fall in distinct
//   banks.
// * K and V tiles are double-buffered: cp.async fetches the next tile
//   (zero-filled past T) while this one computes.  One block barrier per
//   tile: P is exchanged only inside a warp (a half-warp writes and reads
//   its own rows of Ps), so the rest is __syncwarp.
// * The softmax is per (row, key): the row max over the tile is the
//   thread's max reduced by 4 shuffles inside the half-warp; exp is
//   evaluated once per (row, key) and once per row for the rescale; each
//   thread keeps its own partial row sum l, reduced once at the end (the
//   rescale is the same for every partial of a row).
// * P goes through shared memory (Ps[key][row], padded) and O += P·V runs
//   as a second micro-tile: 8 rows by the thread's hd/16 columns, per key
//   three 16-byte loads for 32 FMAs (hd 64).
// * Each key tile is classed from the block's qpos min/max (its valid
//   rows) and the tile's kpos min, max and min over kpos >= 0, never from
//   the tile's index, so a wrapped ring buffer (unsorted kpos) is safe:
//   "skip" when no key can be allowed for any row (never loaded),
//   "unmasked" when every key is allowed for every row (no mask test), else
//   "masked" (kernels/flash_attention.py::flash_tile_class mirrors it).
//   Each warp scans ahead to the next tile that is not skipped, so every
//   warp agrees on it without a barrier.  Rows past S·G compute on zero q
//   and are never stored; keys past T have kpos -1.
// * Scores are scaled after the dot and masked to -inf before the max;
//   exp is the IEEE expf (never fast math).  FMAs are written as fmaf, so
//   the library's global -fmad=false does not split them.
// * head_dim 256 (PaliGemma) takes row blocks of BM = 64 (4 rows a
//   thread): at 128 rows the transposed Q alone would be 132 KB and the
//   whole block ~285 KB of shared memory, and each thread would hold
//   8 × 16 output sums; at 64 rows it is 207 KB and 4 × 16.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int PAD = 4;           // floats of padding per shared row

enum TileClass : int { SKIP = 0, UNMASKED = 1, MASKED = 2 };

template <int HD> struct Shape {
  static constexpr int BM = HD >= 256 ? 64 : 128;  // query rows per block
  static constexpr int TM = BM / 16;               // rows per thread
  static constexpr int QST = BM + PAD;             // Qs and Ps row stride (floats)
  static constexpr int BN = HD <= 64 ? 64 : 32;    // keys per tile
  static constexpr int TN = BN / 16;               // keys per thread
  static constexpr int VW = HD >= 64 ? 4 : 2;      // output columns per vector
  static constexpr int NV = HD / 16 / VW;          // vectors per thread
  static constexpr int KST = HD + PAD;             // K and V row stride
  static constexpr int SMEM_FLOATS = HD * QST + 4 * BN * KST + BN * QST;
  static constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float) + BM * sizeof(int);
  static_assert(TM % 4 == 0 && SMEM_BYTES <= 232448, "row block");
};

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool fill) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = fill ? 16 : 0;     // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ bool key_allowed(int kp, int qp, int causal, int window) {
  return kp >= 0 && (!causal || kp <= qp)
      && (!window || (long long)kp > (long long)qp - window);
}

// The tile's class from the block's valid-row qpos range [qmin, qmax] and
// the tile's kpos min, max and min over kpos >= 0 (vmin).
__device__ __forceinline__ int tile_class(int qmin, int qmax, int kmin, int kmax,
                                          int vmin, int causal, int window) {
  if (kmax < 0 || (causal && vmin > qmax)
      || (window && (long long)kmax <= (long long)qmin - window))
    return SKIP;
  if (kmin >= 0 && (!causal || kmax <= qmin)
      && (!window || (long long)kmin > (long long)qmax - window))
    return UNMASKED;
  return MASKED;
}

// First tile at or after `tile` that is not skipped (ntiles if none), and
// its class; computed by each warp on its own, identically.
template <int BN>
__device__ int next_tile(int tile, int ntiles, const int* __restrict__ kpos, int T,
                         int qmin, int qmax, int causal, int window, int& cls) {
  const int lane = threadIdx.x % 32;
  for (; tile < ntiles; ++tile) {
    int kmin = INT_MAX, kmax = INT_MIN, vmin = INT_MAX;
#pragma unroll
    for (int u = lane; u < BN; u += 32) {
      const int t = tile * BN + u;
      const int kp = t < T ? kpos[t] : -1;
      kmin = min(kmin, kp);
      kmax = max(kmax, kp);
      if (kp >= 0) vmin = min(vmin, kp);
    }
    kmin = __reduce_min_sync(0xffffffffu, kmin);
    kmax = __reduce_max_sync(0xffffffffu, kmax);
    vmin = __reduce_min_sync(0xffffffffu, vmin);
    cls = tile_class(qmin, qmax, kmin, kmax, vmin, causal, window);
    if (cls != SKIP) return tile;
  }
  return ntiles;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ qpos,
             const int* __restrict__ kpos, float* __restrict__ out,
             float* __restrict__ lse, int S, int H, int KH, int T, int group,
             float scale, int causal, int window) {
  using Sh = Shape<HD>;
  constexpr int BM = Sh::BM, TM = Sh::TM, QST = Sh::QST;
  constexpr int BN = Sh::BN, TN = Sh::TN, VW = Sh::VW, NV = Sh::NV, KST = Sh::KST;
  constexpr int C4 = HD / 4;       // 16-byte pieces per row of q, k or v

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // [HD][QST], transposed
  float* Ks = Qs + HD * QST;                 // [2][BN][KST]
  float* Vs = Ks + 2 * BN * KST;             // [2][BN][KST]
  float* Ps = Vs + 2 * BN * KST;             // [BN][QST], key-major
  int* sQpos = reinterpret_cast<int*>(Ps + BN * QST);   // [BM]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int rg = (tid / 32) * 2 + lane / 16;     // rows rg*TM .. rg*TM + TM - 1
  const int cg = lane % 16;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const long long rows = (long long)S * group;
  const long long row0 = (long long)(gridDim.x - 1 - blockIdx.x) * BM;
  const int nrows = (int)min((long long)BM, rows - row0);

  // Stage Q transposed (zeros past S·G) and the rows' positions.
  for (int i = tid; i < BM * C4; i += kThreads) {
    const int rr = i % BM;
    const int c = (i / BM) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rr < nrows) {
      const long long r = row0 + rr;
      const long long s = r / group;
      const int h = kvh * group + (int)(r % group);
      x = *reinterpret_cast<const float4*>(q + ((b * (long long)S + s) * H + h) * HD + c);
    }
    Qs[(c + 0) * QST + rr] = x.x;
    Qs[(c + 1) * QST + rr] = x.y;
    Qs[(c + 2) * QST + rr] = x.z;
    Qs[(c + 3) * QST + rr] = x.w;
  }
  for (int rr = tid; rr < BM; rr += kThreads)
    sQpos[rr] = rr < nrows ? qpos[(row0 + rr) / group] : 0;
  __syncthreads();

  // The block's qpos range over its valid rows (each warp, identically).
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int rr = lane; rr < nrows; rr += 32) {
    qmin = min(qmin, sQpos[rr]);
    qmax = max(qmax, sQpos[rr]);
  }
  qmin = __reduce_min_sync(0xffffffffu, qmin);
  qmax = __reduce_max_sync(0xffffffffu, qmax);

  const long long kvstride = (long long)KH * HD;
  const float* kb = k + (long long)b * T * kvstride + (long long)kvh * HD;
  const float* vb = v + (long long)b * T * kvstride + (long long)kvh * HD;
  auto load_tile = [&](int tile, int buf) {
    float* kd = Ks + buf * BN * KST;
    float* vd = Vs + buf * BN * KST;
    for (int i = tid; i < BN * C4; i += kThreads) {
      const int key = i / C4;
      const int c = (i % C4) * 4;
      const int t = tile * BN + key;
      const bool in = t < T;
      const long long off = in ? (long long)t * kvstride + c : 0;
      cp_async16(kd + key * KST + c, kb + off, in);
      cp_async16(vd + key * KST + c, vb + off, in);
    }
  };

  float o[TM][NV * VW];
  float m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NV * VW; ++c) o[i][c] = 0.f;
  }

  const int ntiles = (T + BN - 1) / BN;
  int cls = SKIP;
  int cur = next_tile<BN>(0, ntiles, kpos, T, qmin, qmax, causal, window, cls);
  if (cur < ntiles) load_tile(cur, 0);
  cp_async_commit();
  int buf = 0;
  while (cur < ntiles) {
    int nxt_cls = SKIP;
    const int nxt =
        next_tile<BN>(cur + 1, ntiles, kpos, T, qmin, qmax, causal, window, nxt_cls);
    cp_async_wait_all();       // this thread's copies of this tile
    // The one block barrier of a tile: this tile's copies are visible to
    // all, and every warp is done with the other buffer, which the next
    // tile's copies then fill while this tile computes.
    __syncthreads();
    if (nxt < ntiles) load_tile(nxt, buf ^ 1);
    cp_async_commit();

    const float* kt = Ks + buf * BN * KST;
    const float* vt = Vs + buf * BN * KST;
    // S = Q·Kᵀ: rows rg*8 + i, keys cg + 16j.
    float sc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sc[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float4 kf[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        kf[j] = *reinterpret_cast<const float4*>(kt + (cg + 16 * j) * KST + d);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float qv[TM];
#pragma unroll
        for (int u = 0; u < TM / 4; ++u) {
          const float4 x = *reinterpret_cast<const float4*>(Qs + (d + e) * QST + rg * TM + 4 * u);
          qv[4 * u + 0] = x.x;
          qv[4 * u + 1] = x.y;
          qv[4 * u + 2] = x.z;
          qv[4 * u + 3] = x.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) sc[i][j] = fmaf(qv[i], comp(kf[j], e), sc[i][j]);
      }
    }
    if (cls == MASKED) {
      int kp[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int t = cur * BN + cg + 16 * j;
        kp[j] = t < T ? kpos[t] : -1;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int qp = sQpos[rg * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          sc[i][j] = key_allowed(kp[j], qp, causal, window) ? sc[i][j] * scale
                                                            : -INFINITY;
      }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) sc[i][j] *= scale;
    }

    // Online softmax, one exp per (row, key); P to shared memory.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = sc[i][0];
#pragma unroll
      for (int j = 1; j < TN; ++j) mx = fmaxf(mx, sc[i][j]);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // Until a row has seen an allowed key, m stays -inf; shifting by 0
      // then keeps exp's arguments free of inf - inf.
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        sc[i][j] = expf(sc[i][j] - m_use);
        psum += sc[i][j];
      }
      l[i] = fmaf(l[i], corr, psum);
#pragma unroll
      for (int c = 0; c < NV * VW; ++c) o[i][c] *= corr;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float* pr = Ps + (cg + 16 * j) * QST + rg * TM;
#pragma unroll
      for (int u = 0; u < TM / 4; ++u)
        *reinterpret_cast<float4*>(pr + 4 * u) =
            make_float4(sc[4 * u][j], sc[4 * u + 1][j], sc[4 * u + 2][j], sc[4 * u + 3][j]);
    }
    // A half-warp writes and reads only its own rows of Ps.
    __syncwarp();

    // O += P·V: rows rg*8 + i, columns u*16*VW + cg*VW + c.
#pragma unroll 16
    for (int key = 0; key < BN; ++key) {
      float pv[TM];
#pragma unroll
      for (int u = 0; u < TM / 4; ++u) {
        const float4 x = *reinterpret_cast<const float4*>(Ps + key * QST + rg * TM + 4 * u);
        pv[4 * u + 0] = x.x;
        pv[4 * u + 1] = x.y;
        pv[4 * u + 2] = x.z;
        pv[4 * u + 3] = x.w;
      }
      float vv[NV * VW];
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const float* src = vt + key * KST + u * 16 * VW + cg * VW;
        if constexpr (VW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          vv[u * VW + 0] = x.x;
          vv[u * VW + 1] = x.y;
          vv[u * VW + 2] = x.z;
          vv[u * VW + 3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(src);
          vv[u * VW + 0] = x.x;
          vv[u * VW + 1] = x.y;
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < NV * VW; ++c) o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
    }
    cur = nxt;
    cls = nxt_cls;
    buf ^= 1;
  }

  // The row sums over the half-warp, then out = o / l (0 for a row with
  // no allowed key).
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int rr = rg * TM + i;
    if (rr >= nrows) continue;
    const long long r = row0 + rr;
    const long long s = r / group;
    const int h = kvh * group + (int)(r % group);
    if (lse != nullptr && cg == 0)
      lse[((long long)b * H + h) * S + s] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    float* dst = out + ((b * (long long)S + s) * H + h) * HD;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      float y[VW];
#pragma unroll
      for (int c = 0; c < VW; ++c) y[c] = l[i] > 0.f ? o[i][u * VW + c] / l[i] : 0.f;
      float* p = dst + u * 16 * VW + cg * VW;
      if constexpr (VW == 4)
        *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
      else
        *reinterpret_cast<float2*>(p) = make_float2(y[0], y[1]);
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const int* qpos,
           const int* kpos, float* out, float* lse, int B, int S, int H, int KH,
           int T, float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = Shape<HD>::SMEM_BYTES;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  constexpr int BM = Shape<HD>::BM;
  const long long rows = (long long)S * (H / KH);
  const long long tiles = (rows + BM - 1) / BM;
  if (tiles > INT_MAX || KH > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)tiles, (unsigned)KH, (unsigned)B);
  flash_kernel<HD><<<grid, kThreads, smem, stream>>>(q, k, v, qpos, kpos, out, lse, S, H,
                                                     KH, T, H / KH, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// float32 only; lse may be null.  Returns the launch's cudaError_t.
int fs_flash_attention(const void* q, const void* k, const void* v,
                       const int* qpos, const int* kpos, void* out, void* lse,
                       int B, int S, int H, int KH, int T, int hd, float scale,
                       int causal, int window, void* stream) {
    if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0) {
        return (int)cudaErrorInvalidValue;
    }
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(out);
    float* lf = static_cast<float*>(lse);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 32:
            return launch<32>(qf, kf, vf, qpos, kpos, of, lf, B, S, H, KH, T, scale, causal,
                              window, st);
        case 64:
            return launch<64>(qf, kf, vf, qpos, kpos, of, lf, B, S, H, KH, T, scale, causal,
                              window, st);
        case 128:
            return launch<128>(qf, kf, vf, qpos, kpos, of, lf, B, S, H, KH, T, scale, causal,
                               window, st);
        case 256:
            return launch<256>(qf, kf, vf, qpos, kpos, of, lf, B, S, H, KH, T, scale, causal,
                               window, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
