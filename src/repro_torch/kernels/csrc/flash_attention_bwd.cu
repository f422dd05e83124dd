// Causal flash attention, backward, float32, for sm_90a.
//
// Replaces no TPU kernel: the reference's Pallas kernel
// (src/repro/kernels/flash_attention.py::_flash_kernel) has no backward,
// and the reference trains attention through the plain einsums, which hold
// the whole (S, T) score tensor of every head.  It is the gradient of
// csrc/flash_attention.cu's function, so that training in float32 on the
// card keeps no score tensor: kernels/flash_attention.py::FlashAttentionF32
// runs that kernel forward (with the per-row log-sum-exp, lse) and these
// three kernels backward.  With P[s, t] = exp(q_s·k_t · scale - lse_s) over
// the allowed keys (the same test as the forward: kpos >= 0, causal,
// window) and D_s = Σ_d dO[s, d] · O[s, d]:
//
//   dV[t] = Σ_s P[s, t] · dO[s]
//   dS[s, t] = P[s, t] · (dO[s]·v_t - D_s)
//   dK[t] = scale · Σ_s dS[s, t] · q_s        (over the G query heads of t's kv head)
//   dQ[s] = scale · Σ_t dS[s, t] · k_t
//
// A row with no allowed key has lse = -inf and gets no gradient (its
// output is 0 in the forward).  Layouts are the forward's: q, out, dout and
// dq (B, S, H, hd); k, v, dk and dv (B, T, KH, hd); lse and D (B, H, S); all
// contiguous float32; qpos (S,) and kpos (T,) int32.
//
// What bounds it: the gradient needs 5·hd FMAs per allowed (query, key)
// pair (q·k, dO·v, P·dO, dS·q and dS·k) on the CUDA cores (33.5e12
// FMA/s), against q, k, v, out, dout and the three gradients over HBM
// once: bound by arithmetic, 2.5 times the forward's 2·hd FMAs a pair.
// This design does 7·hd: the dQ kernel computes q·k and dO·v again, the
// price of summing without float atomics.  TF32 would not meet float32's
// tolerance.
//
// Design.  No float atomics: every gradient element is summed by one thread
// in a fixed order, so two runs give the same bits.
// * bwd_dot_kernel: D, one warp a row of dO and O, a fixed shuffle tree.
// * bwd_dkdv_kernel: one block of 256 threads per (tile of BN keys, kv
//   head, batch); it walks the row tiles of its kv head, BM folded rows
//   (s, g) = (r / G, r % G) of the G query heads that share it, as the
//   forward folds them, so dK and dV sum over the group in registers.
//   Warp w owns keys w·KW .. w·KW + KW - 1 of the tile: it computes S and
//   dP for every row of the row tile and those keys (each lane a TR × KT
//   micro-tile: rows lane/4 + 8i, keys lane%4 + 4j), writes P, then dS,
//   into its own slice of shared memory, and accumulates dV += Pᵀ·dO and
//   dK += dSᵀ·Q for its keys (each lane KW keys × hd/32 columns) — P and
//   dS never leave the warp, so a row tile takes one block barrier.  Q and
//   dO row tiles are double-buffered by cp.async, with their lse, D and
//   positions; K and V are staged once.  Key tiles are issued first-first,
//   so the causal tiles with the most rows start first.
// * bwd_dq_kernel: the forward's shape: one block per (tile of BM folded
//   rows, kv head, batch), thread (rg, cg) owning TM rows × TN keys of S
//   and dP, then TM rows × hd/16 columns of dQ += dS·K; Q and dO staged
//   once, transposed; K and V tiles double-buffered by cp.async; dS
//   exchanged inside a half-warp; row blocks issued last-first.
// * Row and key tiles are classed as in the forward (skip / unmasked /
//   masked, from the qpos range of the valid rows and the kpos min, max and
//   min over kpos >= 0 of the keys; kernels/flash_attention.py::
//   flash_tile_class mirrors the test), so causal and windowed tiles with
//   no allowed pair are never loaded, and a wrapped or holed kpos is safe.
//   Rows past S·G and keys past T are zero-filled and masked (a padded row
//   has lse = +inf, so its P is 0).
// * P = expf(s·scale - lse) with the IEEE expf (never fast math); FMAs are
//   written as fmaf, so the library's global -fmad=false does not split
//   them.  scale multiplies dK and dQ once, at the end.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int PAD = 4;           // floats of padding per shared row

enum TileClass : int { SKIP = 0, UNMASKED = 1, MASKED = 2 };

// The dK/dV kernel's tiles.
template <int HD> struct KVShape {
  static constexpr int BN = HD >= 256 ? 32 : 64;   // keys per block
  static constexpr int KW = BN / 8;                // keys per warp
  static constexpr int KT = KW / 4;                // S / dP keys per lane
  static constexpr int BM = HD >= 256 ? 32 : 64;   // rows per row tile
  static constexpr int TR = BM / 8;                // S / dP rows per lane
  static constexpr int CW = HD / 32;               // dK / dV columns per lane
  static constexpr int KST = HD + PAD;             // row stride of K, V, Q, dO
  static constexpr int SMEM_FLOATS = 2 * BN * KST + 4 * BM * KST + BM * BN + 4 * BM;
  static constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float) + 2 * BM * sizeof(int);
  static_assert(KW % 4 == 0, "keys per warp");
  static_assert(SMEM_BYTES <= 232448, "dK/dV block");
};

// The dQ kernel's tiles (the forward's, with dO beside Q).
template <int HD> struct QShape {
  static constexpr int BM = HD >= 256 ? 64 : 128;  // rows per block
  static constexpr int TM = BM / 16;               // rows per thread
  static constexpr int QST = BM + PAD;             // Qs, dOs and Ds row stride
  static constexpr int BN = HD <= 64 ? 64 : (HD <= 128 ? 32 : 16);  // keys per tile
  static constexpr int TN = BN / 16;               // keys per thread
  static constexpr int VW = HD >= 64 ? 4 : 2;      // dQ columns per vector
  static constexpr int NV = HD / 16 / VW;          // vectors per thread
  static constexpr int KST = HD + PAD;             // K and V row stride
  static constexpr int SMEM_FLOATS = 2 * HD * QST + 4 * BN * KST + BN * QST + 2 * BM;
  static constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float) + BM * sizeof(int);
  static_assert(TM % 4 == 0 && SMEM_BYTES <= 232448, "dQ block");
};

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// N consecutive floats from 16-byte (N % 4 == 0) or 8-byte aligned shared memory.
template <int N>
__device__ __forceinline__ void load_cols(const float* src, float* dst) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int u = 0; u < N; u += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + u);
      dst[u] = x.x;
      dst[u + 1] = x.y;
      dst[u + 2] = x.z;
      dst[u + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x;
    dst[1] = x.y;
  } else {
    dst[0] = src[0];
  }
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

// csrc/flash_attention.cu's tile test: rows with qpos in [qmin, qmax] (the
// valid ones) against keys with kpos min kmin, max kmax and min over
// kpos >= 0 vmin.
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

// kpos min, max and min over kpos >= 0 of keys [t0, t0 + n) (slots past T
// count as -1), reduced over the warp.
__device__ __forceinline__ void key_range(const int* __restrict__ kpos, int T, int t0,
                                          int n, int& kmin, int& kmax, int& vmin) {
  const int lane = threadIdx.x % 32;
  kmin = INT_MAX;
  kmax = INT_MIN;
  vmin = INT_MAX;
  for (int u = lane; u < n; u += 32) {
    const int t = t0 + u;
    const int kp = t < T ? kpos[t] : -1;
    kmin = min(kmin, kp);
    kmax = max(kmax, kp);
    if (kp >= 0) vmin = min(vmin, kp);
  }
  kmin = __reduce_min_sync(0xffffffffu, kmin);
  kmax = __reduce_max_sync(0xffffffffu, kmax);
  vmin = __reduce_min_sync(0xffffffffu, vmin);
}

// qpos min and max over folded rows [r0, r0 + n), reduced over the warp.
__device__ __forceinline__ void row_range(const int* __restrict__ qpos, int group,
                                          long long r0, int n, int& qmin, int& qmax) {
  const int lane = threadIdx.x % 32;
  qmin = INT_MAX;
  qmax = INT_MIN;
  for (int u = lane; u < n; u += 32) {
    const int qp = qpos[(r0 + u) / group];
    qmin = min(qmin, qp);
    qmax = max(qmax, qp);
  }
  qmin = __reduce_min_sync(0xffffffffu, qmin);
  qmax = __reduce_max_sync(0xffffffffu, qmax);
}

// D[b, h, s] = Σ_d dout[b, s, h, d] · out[b, s, h, d]: one warp a row
// (rows in memory order), a fixed shuffle tree.
__global__ void __launch_bounds__(kThreads)
bwd_dot_kernel(const float* __restrict__ dout, const float* __restrict__ out,
               float* __restrict__ dsum, long long rows, int S, int H, int hd) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const float* a = dout + row * hd;
  const float* c = out + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(a[d], c[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long b = row / ((long long)S * H);
    const long long s = (row / H) % S;
    const int h = (int)(row % H);
    dsum[(b * H + h) * S + s] = acc;
  }
}

// First row tile at or after `tile` that is not skipped against the
// block's keys (ntiles if none), and its class; each warp alike.
template <int BM>
__device__ int next_row_tile(int tile, int ntiles, const int* __restrict__ qpos,
                             long long rows, int group, int kmin, int kmax, int vmin,
                             int causal, int window, int& cls) {
  for (; tile < ntiles; ++tile) {
    const long long r0 = (long long)tile * BM;
    const int n = (int)min((long long)BM, rows - r0);
    int qmin, qmax;
    row_range(qpos, group, r0, n, qmin, qmax);
    cls = tile_class(qmin, qmax, kmin, kmax, vmin, causal, window);
    if (cls != SKIP) return tile;
  }
  return ntiles;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                const int* __restrict__ qpos, const int* __restrict__ kpos,
                float* __restrict__ dk, float* __restrict__ dv, int S, int H, int KH,
                int T, int group, float scale, int causal, int window) {
  using Sh = KVShape<HD>;
  constexpr int BN = Sh::BN, KW = Sh::KW, KT = Sh::KT, BM = Sh::BM, TR = Sh::TR;
  constexpr int CW = Sh::CW, KST = Sh::KST;
  constexpr int C4 = HD / 4;       // 16-byte pieces per row

  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                          // [BN][KST]
  float* Vs = Ks + BN * KST;                 // [BN][KST]
  float* Qs = Vs + BN * KST;                 // [2][BM][KST]
  float* Os = Qs + 2 * BM * KST;             // [2][BM][KST], dO
  float* Ps = Os + 2 * BM * KST;             // [8 warps][BM][KW]: P, then dS
  float* sLse = Ps + BM * BN;                // [2][BM]
  float* sD = sLse + 2 * BM;                 // [2][BM]
  int* sPos = reinterpret_cast<int*>(sD + 2 * BM);   // [2][BM]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rgi = lane / 4;        // S / dP rows rgi + 8i
  const int kgi = lane % 4;        // S / dP keys warp*KW + kgi + 4j
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int key0 = blockIdx.x * BN;
  const long long rows = (long long)S * group;
  const long long kvstride = (long long)KH * HD;
  float* Pw = Ps + warp * BM * KW;

  // Stage the block's K and V (zeros past T), and the keys' range.
  const float* kb = k + (long long)b * T * kvstride + (long long)kvh * HD;
  const float* vb = v + (long long)b * T * kvstride + (long long)kvh * HD;
  for (int i = tid; i < BN * C4; i += kThreads) {
    const int key = i / C4;
    const int c = (i % C4) * 4;
    const int t = key0 + key;
    const bool in = t < T;
    const long long off = in ? (long long)t * kvstride + c : 0;
    cp_async16(Ks + key * KST + c, kb + off, in);
    cp_async16(Vs + key * KST + c, vb + off, in);
  }
  cp_async_commit();
  int kmin, kmax, vmin;
  key_range(kpos, T, key0, BN, kmin, kmax, vmin);
  int kp[KT];
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    const int t = key0 + warp * KW + kgi + 4 * j;
    kp[j] = t < T ? kpos[t] : -1;
  }

  auto load_rows = [&](int tile, int buf) {
    const long long r0 = (long long)tile * BM;
    float* qd = Qs + buf * BM * KST;
    float* od = Os + buf * BM * KST;
    for (int i = tid; i < BM * C4; i += kThreads) {
      const int rr = i / C4;
      const int c = (i % C4) * 4;
      const long long r = r0 + rr;
      const bool in = r < rows;
      long long off = 0;
      if (in) {
        const long long s = r / group;
        const int h = kvh * group + (int)(r % group);
        off = ((b * (long long)S + s) * H + h) * HD + c;
      }
      cp_async16(qd + rr * KST + c, q + off, in);
      cp_async16(od + rr * KST + c, dout + off, in);
    }
    for (int rr = tid; rr < BM; rr += kThreads) {
      const long long r = r0 + rr;
      float l = INFINITY, dd = 0.f;   // a padded row: P = exp(-inf) = 0
      int qp = 0;
      if (r < rows) {
        const long long s = r / group;
        const int h = kvh * group + (int)(r % group);
        const long long at = ((long long)b * H + h) * S + s;
        l = lse[at];
        dd = dsum[at];
        qp = qpos[s];
      }
      sLse[buf * BM + rr] = l;
      sD[buf * BM + rr] = dd;
      sPos[buf * BM + rr] = qp;
    }
  };

  float dka[KW][CW], dva[KW][CW];
#pragma unroll
  for (int j = 0; j < KW; ++j)
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      dka[j][c] = 0.f;
      dva[j][c] = 0.f;
    }

  const int ntiles = (int)((rows + BM - 1) / BM);
  int cls = SKIP;
  int cur = next_row_tile<BM>(0, ntiles, qpos, rows, group, kmin, kmax, vmin, causal,
                              window, cls);
  if (cur < ntiles) load_rows(cur, 0);
  cp_async_commit();
  int buf = 0;
  while (cur < ntiles) {
    int nxt_cls = SKIP;
    const int nxt = next_row_tile<BM>(cur + 1, ntiles, qpos, rows, group, kmin, kmax, vmin,
                                      causal, window, nxt_cls);
    cp_async_wait_all();
    // The one block barrier of a row tile: this tile (and K, V) visible to
    // all, every warp done with the other buffer, which the next tile's
    // copies then fill while this one computes.
    __syncthreads();
    if (nxt < ntiles) load_rows(nxt, buf ^ 1);
    cp_async_commit();

    const float* qt = Qs + buf * BM * KST;
    const float* ot = Os + buf * BM * KST;
    // S = Q·Kᵀ and dP = dO·Vᵀ: rows rgi + 8i, keys warp*KW + kgi + 4j.
    float sc[TR][KT], dp[TR][KT];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        sc[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 kf[KT], vf[KT];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int key = warp * KW + kgi + 4 * j;
        kf[j] = *reinterpret_cast<const float4*>(Ks + key * KST + d);
        vf[j] = *reinterpret_cast<const float4*>(Vs + key * KST + d);
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qt + (rgi + 8 * i) * KST + d);
        const float4 ov = *reinterpret_cast<const float4*>(ot + (rgi + 8 * i) * KST + d);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            sc[i][j] = fmaf(comp(qv, e), comp(kf[j], e), sc[i][j]);
            dp[i][j] = fmaf(comp(ov, e), comp(vf[j], e), dp[i][j]);
          }
      }
    }
    // P and dS (dS kept in dp); P to the warp's slice of shared memory.
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int rr = rgi + 8 * i;
      const float l = sLse[buf * BM + rr];
      const float dd = sD[buf * BM + rr];
      const int qp = sPos[buf * BM + rr];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const bool ok = cls == UNMASKED || key_allowed(kp[j], qp, causal, window);
        const float p = ok ? expf(sc[i][j] * scale - l) : 0.f;
        dp[i][j] = p * (dp[i][j] - dd);
        Pw[rr * KW + kgi + 4 * j] = p;
      }
    }
    __syncwarp();
    // dV += Pᵀ·dO: keys warp*KW + j, columns lane*CW + c.
#pragma unroll 4
    for (int rr = 0; rr < BM; ++rr) {
      float pr[KW], ov[CW];
      load_cols<KW>(Pw + rr * KW, pr);
      load_cols<CW>(ot + rr * KST + lane * CW, ov);
#pragma unroll
      for (int j = 0; j < KW; ++j)
#pragma unroll
        for (int c = 0; c < CW; ++c) dva[j][c] = fmaf(pr[j], ov[c], dva[j][c]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < KT; ++j) Pw[(rgi + 8 * i) * KW + kgi + 4 * j] = dp[i][j];
    __syncwarp();
    // dK += dSᵀ·Q (scale at the end).
#pragma unroll 4
    for (int rr = 0; rr < BM; ++rr) {
      float pr[KW], qv[CW];
      load_cols<KW>(Pw + rr * KW, pr);
      load_cols<CW>(qt + rr * KST + lane * CW, qv);
#pragma unroll
      for (int j = 0; j < KW; ++j)
#pragma unroll
        for (int c = 0; c < CW; ++c) dka[j][c] = fmaf(pr[j], qv[c], dka[j][c]);
    }
    cur = nxt;
    cls = nxt_cls;
    buf ^= 1;
  }
  cp_async_wait_all();   // K and V's copies, when no row tile was loaded

  // Every key of the tile gets its gradient (0 where no row reaches it).
#pragma unroll
  for (int j = 0; j < KW; ++j) {
    const int t = key0 + warp * KW + j;
    if (t >= T) continue;
    const long long at = ((b * (long long)T + t) * KH + kvh) * HD + lane * CW;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      dk[at + c] = dka[j][c] * scale;
      dv[at + c] = dva[j][c];
    }
  }
}

// First key tile at or after `tile` that is not skipped against the
// block's rows (ntiles if none), and its class; each warp alike.
template <int BN>
__device__ int next_key_tile(int tile, int ntiles, const int* __restrict__ kpos, int T,
                             int qmin, int qmax, int causal, int window, int& cls) {
  for (; tile < ntiles; ++tile) {
    int kmin, kmax, vmin;
    key_range(kpos, T, tile * BN, BN, kmin, kmax, vmin);
    cls = tile_class(qmin, qmax, kmin, kmax, vmin, causal, window);
    if (cls != SKIP) return tile;
  }
  return ntiles;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              const int* __restrict__ qpos, const int* __restrict__ kpos,
              float* __restrict__ dq, int S, int H, int KH, int T, int group,
              float scale, int causal, int window) {
  using Sh = QShape<HD>;
  constexpr int BM = Sh::BM, TM = Sh::TM, QST = Sh::QST;
  constexpr int BN = Sh::BN, TN = Sh::TN, VW = Sh::VW, NV = Sh::NV, KST = Sh::KST;
  constexpr int C4 = HD / 4;

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // [HD][QST], transposed
  float* Os = Qs + HD * QST;                 // [HD][QST], dO transposed
  float* Ks = Os + HD * QST;                 // [2][BN][KST]
  float* Vs = Ks + 2 * BN * KST;             // [2][BN][KST]
  float* Ds = Vs + 2 * BN * KST;             // [BN][QST], dS key-major
  float* sLse = Ds + BN * QST;               // [BM]
  float* sD = sLse + BM;                     // [BM]
  int* sQpos = reinterpret_cast<int*>(sD + BM);   // [BM]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int rg = (tid / 32) * 2 + lane / 16;     // rows rg*TM .. rg*TM + TM - 1
  const int cg = lane % 16;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const long long rows = (long long)S * group;
  const long long row0 = (long long)(gridDim.x - 1 - blockIdx.x) * BM;
  const int nrows = (int)min((long long)BM, rows - row0);

  // Stage Q and dO transposed (zeros past S·G) and the rows' lse, D, qpos.
  for (int i = tid; i < BM * C4; i += kThreads) {
    const int rr = i % BM;
    const int c = (i / BM) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (rr < nrows) {
      const long long r = row0 + rr;
      const long long s = r / group;
      const int h = kvh * group + (int)(r % group);
      const long long off = ((b * (long long)S + s) * H + h) * HD + c;
      x = *reinterpret_cast<const float4*>(q + off);
      y = *reinterpret_cast<const float4*>(dout + off);
    }
    Qs[(c + 0) * QST + rr] = x.x;
    Qs[(c + 1) * QST + rr] = x.y;
    Qs[(c + 2) * QST + rr] = x.z;
    Qs[(c + 3) * QST + rr] = x.w;
    Os[(c + 0) * QST + rr] = y.x;
    Os[(c + 1) * QST + rr] = y.y;
    Os[(c + 2) * QST + rr] = y.z;
    Os[(c + 3) * QST + rr] = y.w;
  }
  for (int rr = tid; rr < BM; rr += kThreads) {
    float l = INFINITY, dd = 0.f;
    int qp = 0;
    if (rr < nrows) {
      const long long r = row0 + rr;
      const long long s = r / group;
      const int h = kvh * group + (int)(r % group);
      const long long at = ((long long)b * H + h) * S + s;
      l = lse[at];
      dd = dsum[at];
      qp = qpos[s];
    }
    sLse[rr] = l;
    sD[rr] = dd;
    sQpos[rr] = qp;
  }
  __syncthreads();

  int qmin, qmax;
  {
    const int lane32 = tid % 32;
    qmin = INT_MAX;
    qmax = INT_MIN;
    for (int rr = lane32; rr < nrows; rr += 32) {
      qmin = min(qmin, sQpos[rr]);
      qmax = max(qmax, sQpos[rr]);
    }
    qmin = __reduce_min_sync(0xffffffffu, qmin);
    qmax = __reduce_max_sync(0xffffffffu, qmax);
  }

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

  float acc[TM][NV * VW];
  float lrow[TM], drow[TM];
  int qprow[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    lrow[i] = sLse[rg * TM + i];
    drow[i] = sD[rg * TM + i];
    qprow[i] = sQpos[rg * TM + i];
#pragma unroll
    for (int c = 0; c < NV * VW; ++c) acc[i][c] = 0.f;
  }

  const int ntiles = (T + BN - 1) / BN;
  int cls = SKIP;
  int cur = next_key_tile<BN>(0, ntiles, kpos, T, qmin, qmax, causal, window, cls);
  if (cur < ntiles) load_tile(cur, 0);
  cp_async_commit();
  int buf = 0;
  while (cur < ntiles) {
    int nxt_cls = SKIP;
    const int nxt =
        next_key_tile<BN>(cur + 1, ntiles, kpos, T, qmin, qmax, causal, window, nxt_cls);
    cp_async_wait_all();
    __syncthreads();
    if (nxt < ntiles) load_tile(nxt, buf ^ 1);
    cp_async_commit();

    const float* kt = Ks + buf * BN * KST;
    const float* vt = Vs + buf * BN * KST;
    // S = Q·Kᵀ and dP = dO·Vᵀ: rows rg*TM + i, keys cg + 16j.
    float sc[TM][TN], dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        sc[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 kf[TN], vf[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        kf[j] = *reinterpret_cast<const float4*>(kt + (cg + 16 * j) * KST + d);
        vf[j] = *reinterpret_cast<const float4*>(vt + (cg + 16 * j) * KST + d);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float qv[TM], ov[TM];
#pragma unroll
        for (int u = 0; u < TM / 4; ++u) {
          const float4 x = *reinterpret_cast<const float4*>(Qs + (d + e) * QST + rg * TM + 4 * u);
          const float4 y = *reinterpret_cast<const float4*>(Os + (d + e) * QST + rg * TM + 4 * u);
          qv[4 * u + 0] = x.x;
          qv[4 * u + 1] = x.y;
          qv[4 * u + 2] = x.z;
          qv[4 * u + 3] = x.w;
          ov[4 * u + 0] = y.x;
          ov[4 * u + 1] = y.y;
          ov[4 * u + 2] = y.z;
          ov[4 * u + 3] = y.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            sc[i][j] = fmaf(qv[i], comp(kf[j], e), sc[i][j]);
            dp[i][j] = fmaf(ov[i], comp(vf[j], e), dp[i][j]);
          }
      }
    }
    // dS = P·(dP - D) into shared memory, key-major.
    int kp[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int t = cur * BN + cg + 16 * j;
      kp[j] = t < T ? kpos[t] : -1;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float ds[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const bool ok = cls == UNMASKED || key_allowed(kp[j], qprow[i], causal, window);
        const float p = ok ? expf(sc[i][j] * scale - lrow[i]) : 0.f;
        ds[i] = p * (dp[i][j] - drow[i]);
      }
      float* pr = Ds + (cg + 16 * j) * QST + rg * TM;
#pragma unroll
      for (int u = 0; u < TM / 4; ++u)
        *reinterpret_cast<float4*>(pr + 4 * u) =
            make_float4(ds[4 * u], ds[4 * u + 1], ds[4 * u + 2], ds[4 * u + 3]);
    }
    // A half-warp writes and reads only its own rows of Ds.
    __syncwarp();

    // dQ += dS·K: rows rg*TM + i, columns u*16*VW + cg*VW + c.
#pragma unroll 8
    for (int key = 0; key < BN; ++key) {
      float pv[TM];
#pragma unroll
      for (int u = 0; u < TM / 4; ++u) {
        const float4 x = *reinterpret_cast<const float4*>(Ds + key * QST + rg * TM + 4 * u);
        pv[4 * u + 0] = x.x;
        pv[4 * u + 1] = x.y;
        pv[4 * u + 2] = x.z;
        pv[4 * u + 3] = x.w;
      }
      float kv[NV * VW];
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const float* src = kt + key * KST + u * 16 * VW + cg * VW;
        if constexpr (VW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          kv[u * VW + 0] = x.x;
          kv[u * VW + 1] = x.y;
          kv[u * VW + 2] = x.z;
          kv[u * VW + 3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(src);
          kv[u * VW + 0] = x.x;
          kv[u * VW + 1] = x.y;
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < NV * VW; ++c) acc[i][c] = fmaf(pv[i], kv[c], acc[i][c]);
    }
    cur = nxt;
    cls = nxt_cls;
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int rr = rg * TM + i;
    if (rr >= nrows) continue;
    const long long r = row0 + rr;
    const long long s = r / group;
    const int h = kvh * group + (int)(r % group);
    float* dst = dq + ((b * (long long)S + s) * H + h) * HD;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      float* p = dst + u * 16 * VW + cg * VW;
      if constexpr (VW == 4)
        *reinterpret_cast<float4*>(p) =
            make_float4(acc[i][u * VW] * scale, acc[i][u * VW + 1] * scale,
                        acc[i][u * VW + 2] * scale, acc[i][u * VW + 3] * scale);
      else
        *reinterpret_cast<float2*>(p) =
            make_float2(acc[i][u * VW] * scale, acc[i][u * VW + 1] * scale);
    }
  }
}

template <typename F>
int configure(F* kernel, size_t smem, bool& configured) {
  if (configured) return (int)cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  configured = true;
  return (int)cudaSuccess;
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* out,
           const float* dout, const float* lse, const int* qpos, const int* kpos,
           float* dq, float* dk, float* dv, float* dsum, int B, int S, int H, int KH,
           int T, float scale, int causal, int window, cudaStream_t stream) {
  static bool kv_configured = false, q_configured = false;
  int err = configure(bwd_dkdv_kernel<HD>, KVShape<HD>::SMEM_BYTES, kv_configured);
  if (err) return err;
  err = configure(bwd_dq_kernel<HD>, QShape<HD>::SMEM_BYTES, q_configured);
  if (err) return err;
  const int group = H / KH;
  const long long rows = (long long)B * S * H;
  const long long dot_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  const long long key_tiles = ((long long)T + KVShape<HD>::BN - 1) / KVShape<HD>::BN;
  const long long row_tiles =
      ((long long)S * group + QShape<HD>::BM - 1) / QShape<HD>::BM;
  if (dot_blocks > INT_MAX || key_tiles > INT_MAX || row_tiles > INT_MAX || KH > 65535
      || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  bwd_dot_kernel<<<(unsigned)dot_blocks, kThreads, 0, stream>>>(dout, out, dsum, rows, S,
                                                                 H, HD);
  err = (int)cudaGetLastError();
  if (err) return err;
  bwd_dkdv_kernel<HD><<<dim3((unsigned)key_tiles, (unsigned)KH, (unsigned)B), kThreads,
                        KVShape<HD>::SMEM_BYTES, stream>>>(
      q, k, v, dout, lse, dsum, qpos, kpos, dk, dv, S, H, KH, T, group, scale, causal,
      window);
  err = (int)cudaGetLastError();
  if (err) return err;
  bwd_dq_kernel<HD><<<dim3((unsigned)row_tiles, (unsigned)KH, (unsigned)B), kThreads,
                      QShape<HD>::SMEM_BYTES, stream>>>(
      q, k, v, dout, lse, dsum, qpos, kpos, dq, S, H, KH, T, group, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// float32 only.  dsum is (B, H, S) float32 scratch for D.  Launches the
// three kernels in order on `stream`; returns the first cudaError_t.
int fs_flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                           const void* dout, const void* lse, const int* qpos,
                           const int* kpos, void* dq, void* dk, void* dv, void* dsum,
                           int B, int S, int H, int KH, int T, int hd, float scale,
                           int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(out);
  const float* gf = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  float* df = static_cast<float*>(dsum);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(qf, kf, vf, of, gf, lf, qpos, kpos, dqf, dkf, dvf, df, B, S, H, KH,
                        T, scale, causal, window, st);
    case 64:
      return launch<64>(qf, kf, vf, of, gf, lf, qpos, kpos, dqf, dkf, dvf, df, B, S, H, KH,
                        T, scale, causal, window, st);
    case 128:
      return launch<128>(qf, kf, vf, of, gf, lf, qpos, kpos, dqf, dkf, dvf, df, B, S, H,
                         KH, T, scale, causal, window, st);
    case 256:
      return launch<256>(qf, kf, vf, of, gf, lf, qpos, kpos, dqf, dkf, dvf, df, B, S, H,
                         KH, T, scale, causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
