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
// kpos (T,) int32.
//
// What bounds it: 4·hd flops per allowed (query, key) pair on 2·hd·4 bytes
// per key read from L2, so it is bound by arithmetic.  It uses float32
// FMAs on the CUDA cores (67 TFLOP/s peak): TF32 on the tensor cores
// would not meet float32's tolerance, and float32 serves the card-vs-CPU
// parity, not serving.
//
// Design:
// * One block of 128 threads per (tile of query rows, kv head, batch).
//   GQA is folded into the rows as in the Pallas kernel: row r of a
//   (batch, kv head) is (s, g) = (r / G, r % G), so the G query heads that
//   share a kv head share every K/V tile the block stages.
// * LANES = hd/16 threads own one row; each keeps 16 of its q values and
//   16 accumulator values in registers, as four float4s interleaved so
//   that the lanes of a row read 64 contiguous bytes of shared memory.  A
//   score is the lanes' partial dots summed by __shfl_xor_sync.
// * K and V tiles of 4096/hd keys are staged in shared memory (32 KB).  A
//   tile is skipped when none of its keys is allowed for any row of the
//   block; that is decided from the tile's kpos values, never from its
//   index, so a wrapped ring buffer (unsorted kpos) is safe.  Both ragged
//   edges are masked here: rows past S·G are idle, keys past T read as
//   masked zeros.
// * Scores are scaled after the dot and masked before the max; exp is
//   the IEEE expf (never fast math).  FMAs are written as fmaf, so the
//   library's global -fmad=false does not split them.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDimsPerLane = 16;
constexpr int kVecsPerLane = kDimsPerLane / 4;   // float4s per lane
constexpr int kTileElems = 4096;                 // keys per tile × hd
constexpr int kChunk = 8;                        // keys per softmax step

__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
}

// 16 bytes of a K or V row → shared memory.
__device__ __forceinline__ void stage16(const float* src, float* dst) {
    store4(dst, load4(src));
}

__device__ __forceinline__ bool key_allowed(int kp, int qp, int causal, int window) {
    return kp >= 0 && (!causal || kp <= qp)
        && (!window || (long long)kp > (long long)qp - window);
}

template <typename Elem, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
             const Elem* __restrict__ v, const int* __restrict__ qpos,
             const int* __restrict__ kpos, Elem* __restrict__ out,
             int S, int H, int KH, int T, int group, float scale, int causal,
             int window) {
    constexpr int LANES = HD / kDimsPerLane;
    constexpr int ROWS = kThreads / LANES;
    constexpr int BK = kTileElems / HD;
    constexpr int EPV = 16 / sizeof(Elem);     // elements per 16-byte load
    constexpr int VPR = HD / EPV;              // 16-byte loads per key row
    static_assert(BK % kChunk == 0 && BK <= kThreads, "tile shape");

    __shared__ __align__(16) float sK[BK * HD];
    __shared__ __align__(16) float sV[BK * HD];
    __shared__ int sKpos[BK];
    __shared__ int sQmin, sQmax;

    const int tid = threadIdx.x;
    const int lane = tid % LANES;
    const int kvh = blockIdx.y;
    const int b = blockIdx.z;
    const long long row = (long long)blockIdx.x * ROWS + tid / LANES;
    const bool valid = row < (long long)S * group;
    const int s = valid ? (int)(row / group) : 0;
    const int h = kvh * group + (valid ? (int)(row % group) : 0);
    const int qp = valid ? qpos[s] : 0;

    if (tid == 0) {
        sQmin = INT_MAX;
        sQmax = INT_MIN;
    }
    __syncthreads();
    if (valid && lane == 0) {
        atomicMin(&sQmin, qp);
        atomicMax(&sQmax, qp);
    }
    __syncthreads();
    const int qmin = sQmin;
    const int qmax = sQmax;

    const long long qoff = (((long long)b * S + s) * H + h) * HD;
    float4 qv[kVecsPerLane];
    float4 acc[kVecsPerLane];
#pragma unroll
    for (int i = 0; i < kVecsPerLane; ++i) {
        const int d = 4 * (lane + LANES * i);
        qv[i] = valid ? load4(q + qoff + d) : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float m = -INFINITY;
    float l = 0.f;

    const long long kvstride = (long long)KH * HD;
    const Elem* kb = k + (long long)b * T * kvstride + (long long)kvh * HD;
    const Elem* vb = v + (long long)b * T * kvstride + (long long)kvh * HD;
    const float4* sK4 = reinterpret_cast<const float4*>(sK);
    const float4* sV4 = reinterpret_cast<const float4*>(sV);

    for (int t0 = 0; t0 < T; t0 += BK) {
        int any = 0;
        if (tid < BK) {
            const int t = t0 + tid;
            const int kp = t < T ? kpos[t] : -1;
            sKpos[tid] = kp;
            // Allowed for some row of the block: the rows' positions lie
            // in [qmin, qmax].
            any = kp >= 0 && (!causal || kp <= qmax)
                && (!window || (long long)kp > (long long)qmin - window);
        }
        if (!__syncthreads_or(any)) continue;

        for (int i = tid; i < BK * VPR; i += kThreads) {
            const int j = i / VPR;
            const int c = (i % VPR) * EPV;
            const int t = t0 + j;
            float* dk = sK + j * HD + c;
            float* dv = sV + j * HD + c;
            if (t < T) {
                stage16(kb + t * kvstride + c, dk);
                stage16(vb + t * kvstride + c, dv);
            } else {
#pragma unroll
                for (int e = 0; e < EPV; ++e) {
                    dk[e] = 0.f;
                    dv[e] = 0.f;
                }
            }
        }
        __syncthreads();

        for (int j0 = 0; j0 < BK; j0 += kChunk) {
            float sc[kChunk];
#pragma unroll
            for (int c = 0; c < kChunk; ++c) {
                float a = 0.f;
#pragma unroll
                for (int i = 0; i < kVecsPerLane; ++i) {
                    const float4 kk = sK4[(j0 + c) * (HD / 4) + lane + LANES * i];
                    a = fmaf(qv[i].x, kk.x, a);
                    a = fmaf(qv[i].y, kk.y, a);
                    a = fmaf(qv[i].z, kk.z, a);
                    a = fmaf(qv[i].w, kk.w, a);
                }
                sc[c] = a;
            }
#pragma unroll
            for (int off = 1; off < LANES; off <<= 1) {
#pragma unroll
                for (int c = 0; c < kChunk; ++c) {
                    sc[c] += __shfl_xor_sync(0xffffffffu, sc[c], off);
                }
            }
            float mx = -INFINITY;
            unsigned ok = 0;    // bit c: key j0 + c is allowed for this row
#pragma unroll
            for (int c = 0; c < kChunk; ++c) {
                sc[c] *= scale;
                if (valid && key_allowed(sKpos[j0 + c], qp, causal, window)) {
                    ok |= 1u << c;
                    mx = fmaxf(mx, sc[c]);
                }
            }
            const float m_new = fmaxf(m, mx);
            // Until a row has seen an allowed key, m stays -inf; shifting by
            // 0 then keeps exp's arguments free of inf - inf.
            const float m_use = m_new == -INFINITY ? 0.f : m_new;
            const float corr = expf(m - m_use);
            float psum = 0.f;
#pragma unroll
            for (int c = 0; c < kChunk; ++c) {
                sc[c] = (ok >> c) & 1u ? expf(sc[c] - m_use) : 0.f;
                psum += sc[c];
            }
            l = fmaf(l, corr, psum);
#pragma unroll
            for (int i = 0; i < kVecsPerLane; ++i) {
                float4 a = make_float4(acc[i].x * corr, acc[i].y * corr,
                                       acc[i].z * corr, acc[i].w * corr);
#pragma unroll
                for (int c = 0; c < kChunk; ++c) {
                    const float4 vv = sV4[(j0 + c) * (HD / 4) + lane + LANES * i];
                    a.x = fmaf(sc[c], vv.x, a.x);
                    a.y = fmaf(sc[c], vv.y, a.y);
                    a.z = fmaf(sc[c], vv.z, a.z);
                    a.w = fmaf(sc[c], vv.w, a.w);
                }
                acc[i] = a;
            }
            m = m_new;
        }
        __syncthreads();
    }

    if (valid) {
#pragma unroll
        for (int i = 0; i < kVecsPerLane; ++i) {
            const int d = 4 * (lane + LANES * i);
            float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
            if (l > 0.f) {
                o = make_float4(acc[i].x / l, acc[i].y / l, acc[i].z / l,
                                acc[i].w / l);
            }
            store4(out + qoff + d, o);
        }
    }
}

template <typename Elem, int HD>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kpos, void* out, int B, int S, int H, int KH, int T,
           float scale, int causal, int window, cudaStream_t stream) {
    constexpr int ROWS = kThreads / (HD / kDimsPerLane);
    const long long rows = (long long)S * (H / KH);
    const long long tiles = (rows + ROWS - 1) / ROWS;
    if (tiles > INT_MAX || KH > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
    dim3 grid((unsigned)tiles, (unsigned)KH, (unsigned)B);
    flash_kernel<Elem, HD><<<grid, kThreads, 0, stream>>>(
        static_cast<const Elem*>(q), static_cast<const Elem*>(k),
        static_cast<const Elem*>(v), qpos, kpos, static_cast<Elem*>(out), S, H,
        KH, T, H / KH, scale, causal, window);
    return (int)cudaGetLastError();
}

template <typename Elem>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const int* qpos, const int* kpos, void* out, int B, int S, int H,
              int KH, int T, float scale, int causal, int window,
              cudaStream_t stream) {
    switch (hd) {
        case 32:
            return launch<Elem, 32>(q, k, v, qpos, kpos, out, B, S, H, KH, T,
                                    scale, causal, window, stream);
        case 64:
            return launch<Elem, 64>(q, k, v, qpos, kpos, out, B, S, H, KH, T,
                                    scale, causal, window, stream);
        case 128:
            return launch<Elem, 128>(q, k, v, qpos, kpos, out, B, S, H, KH, T,
                                     scale, causal, window, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// float32 only.  Returns the launch's cudaError_t.
int fs_flash_attention(const void* q, const void* k, const void* v,
                       const int* qpos, const int* kpos, void* out, int B,
                       int S, int H, int KH, int T, int hd, float scale,
                       int causal, int window, void* stream) {
    if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0) {
        return (int)cudaErrorInvalidValue;
    }
    return launch_hd<float>(hd, q, k, v, qpos, kpos, out, B, S, H, KH, T, scale,
                            causal, window, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
