// Flash attention, forward, split over the keys: the decode kernel.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel (line 40,
// the Pallas TPU kernel) for the shapes where few query rows share a kv
// head: S·G (query positions × heads per kv head) up to 8, which covers a
// decode step (S = 1) of every configuration the port serves
// (kernels/flash_attention.py::flash_route).  bf16 and float32.  Same
// function as csrc/flash_prefill.cu:
//
//   out[b, s, h] = Σ_t softmax_t(q[b,s,h]·k[b,t,kv] · scale) · v[b,t,kv]
//
// over the allowed keys (kpos[t] >= 0, causal, window); float32 scores,
// softmax and sums, p float32 in P·V, zeros for a row with no allowed key.
//
// What bounds it: every K and V row of the cache is read once for the
// S·G rows of its kv head, ~4·hd flops per key and row: at SmolLM-360M's
// decode (B 4, 16 424 slots, 5 kv heads, hd 64, bf16) 84 MB per layer,
// 0.025 ms at 3.35 TB/s; the flops are ~1% of that.  So it is bound by
// HBM bytes, and the design's goal is to keep enough loads in flight on
// all 132 SMs.
//
// Design:
// * Split pass: one block of 128 threads per (partition of keys, kv head,
//   batch); a partition holds 32 KB of K and 32 KB of V (256 keys at hd
//   64 in bf16: 65 × 5 × 4 = 1300 blocks at the serve shape).  The block
//   reads its kpos, q and positions first and skips a partition with no
//   allowed key for any row (empty cache slots, the window, ring holes),
//   judged from its kpos values: it writes m = -inf, l = 0, acc = 0.  A
//   live partition's K and V rows stream into shared memory with
//   cp.async, 16 bytes a thread, all 64 KB in flight at once in four
//   commit groups (keys past T arrive as zeros); the block works on each
//   group as it lands.  hd·size/16 lanes share one key, each reading one
//   16-byte vector (at most 32 lanes: at hd 256 in float32 a key's 64
//   vectors span one warp, two adjacent vectors a lane); a score is the
//   lanes' partial dots summed by __shfl_xor_sync.  The block keeps the
//   S·G rows of its kv head (q in
//   registers); each lane group keeps its own online softmax (m, l, acc)
//   over its keys; groups merge by shuffles, warps through shared memory,
//   in a fixed order.  The block writes one float32 partial (m, l,
//   acc[hd]) per row to scratch the wrapper allocates.
// * Combine pass: one block per (batch, kv head, row) merges that row's
//   partials in partition order (log-sum-exp rescale: the weights once
//   into shared memory, then each thread's columns), divides by l and
//   writes q's dtype; zeros where no partition has an allowed key.  No
//   float atomics: the same bits on every run.
// * exp is the IEEE expf (never fast math); FMAs are written as fmaf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKBytes = 32768;   // K (and V) bytes of a partition
constexpr int kGroups = 4;       // cp.async groups a partition arrives in
constexpr int kMaxRows = 8;      // S·G rows per kv head
constexpr int kCombineThreads = 128;

// Keys per partition: 256 at hd 64 in bf16.
__host__ __device__ constexpr int partition_keys(int hd, int elem_bytes) {
    return kKBytes / (hd * elem_bytes);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ bool key_allowed(int kp, int qp, int causal, int window) {
    return kp >= 0 && (!causal || kp <= qp)
        && (!window || (long long)kp > (long long)qp - window);
}

// 16 bytes → float32 values.
__device__ __forceinline__ void to_float(const uint4& u, float* f) {  // float32
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void to_float8(const uint4& u, float* f) {  // bf16
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        f[2 * i] = x.x;
        f[2 * i + 1] = x.y;
    }
}

template <typename Elem>
__device__ __forceinline__ void load_vec(const Elem* p, float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    if constexpr (sizeof(Elem) == 4) {
        to_float(u, f);
    } else {
        to_float8(u, f);
    }
}

__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
}

// (m, l, acc) ← the merge of (m, l, acc) and (mo, lo, acco): both rescaled
// to the larger max; an empty side (m = -inf) weighs 0.
template <int V>
__device__ __forceinline__ void merge(float& m, float& l, float* acc, float mo, float lo,
                                      const float* acco) {
    const float mn = fmaxf(m, mo);
    const float mu = mn == -INFINITY ? 0.f : mn;
    const float a = expf(m - mu);
    const float b = expf(mo - mu);
    l = l * a + lo * b;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = acc[e] * a + acco[e] * b;
    m = mn;
}

template <typename Elem, int HD, int RC>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const Elem* __restrict__ q, const Elem* __restrict__ k,
                   const Elem* __restrict__ v, const int* __restrict__ qpos,
                   const int* __restrict__ kpos, float* __restrict__ pm,
                   float* __restrict__ pl, float* __restrict__ pacc, int S, int H,
                   int KH, int T, int G, int R, int nparts, float scale, int causal,
                   int window) {
    constexpr int VEC = 16 / sizeof(Elem);      // elements per 16-byte vector
    constexpr int VPK = HD / VEC;               // 16-byte vectors per key
    constexpr int NV = VPK > 32 ? VPK / 32 : 1; // vectors per lane and key
    constexpr int EPL = VEC * NV;               // elements per lane and key
    constexpr int LPK = HD / EPL;               // lanes per key
    constexpr int KPW = 32 / LPK;               // keys per warp step
    constexpr int P = partition_keys(HD, sizeof(Elem));
    constexpr int GK = P / kGroups;             // keys per cp.async group
    constexpr int STEPS = GK / (kWarps * KPW);  // keys per lane group and group
    constexpr int VPG = GK * VPK;               // 16-byte vectors of K per group
    static_assert(LPK <= 32 && LPK * EPL == HD && STEPS >= 1
                  && GK % (kWarps * KPW) == 0 && VPG % kThreads == 0,
                  "partition shape");

    extern __shared__ __align__(16) uint8_t smem[];
    Elem* s_k = reinterpret_cast<Elem*>(smem);                    // P × HD
    Elem* s_v = s_k + P * HD;                                     // P × HD
    int* s_kpos = reinterpret_cast<int*>(s_v + P * HD);           // P
    float* s_m = reinterpret_cast<float*>(s_kpos + P);            // kWarps × RC
    float* s_l = s_m + kWarps * RC;                               // kWarps × RC
    float* s_acc = s_l + kWarps * RC;                             // kWarps × RC × HD

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int grp = lane / LPK;
    const int sub = lane % LPK;
    const int part = blockIdx.x;
    const int kvh = blockIdx.y;
    const int b = blockIdx.z;
    const int t_begin = part * P;
    const int t_end = min(T, t_begin + P);
    const long long prow = ((long long)b * KH + kvh) * R;   // first row of scratch

    // Positions, q and the partition's liveness in one round trip.
    int qp[RC];
#pragma unroll
    for (int r = 0; r < RC; ++r) qp[r] = r < R ? qpos[r / G] : 0;
    float qv[RC][EPL];
#pragma unroll
    for (int r = 0; r < RC; ++r) {
        if (r < R) {
            const long long off = (((long long)b * S + r / G) * H + kvh * G + r % G) * HD;
#pragma unroll
            for (int n = 0; n < NV; ++n) load_vec(q + off + sub * EPL + n * VEC, qv[r] + n * VEC);
        } else {
#pragma unroll
            for (int e = 0; e < EPL; ++e) qv[r][e] = 0.f;
        }
    }
    int any = 0;
    for (int j = tid; j < P; j += kThreads) {
        const int kp = t_begin + j < t_end ? kpos[t_begin + j] : -1;
        s_kpos[j] = kp;
#pragma unroll
        for (int r = 0; r < RC; ++r) any |= r < R && key_allowed(kp, qp[r], causal, window);
    }
    if (!__syncthreads_or(any)) {
        for (int i = tid; i < R * HD; i += kThreads) {
            const long long pr = (prow + i / HD) * nparts + part;
            pacc[pr * HD + i % HD] = 0.f;
            if (i % HD == 0) {
                pm[pr] = -INFINITY;
                pl[pr] = 0.f;
            }
        }
        return;
    }

    // Stream the partition's K and V rows into shared memory, in kGroups
    // commit groups; keys past T arrive as zeros.
    const long long kstride = (long long)KH * HD;
    const Elem* kb = k + ((long long)b * T + t_begin) * kstride + (long long)kvh * HD;
    const Elem* vb = v + ((long long)b * T + t_begin) * kstride + (long long)kvh * HD;
    const uint32_t sk = static_cast<uint32_t>(__cvta_generic_to_shared(s_k));
    const uint32_t sv = static_cast<uint32_t>(__cvta_generic_to_shared(s_v));
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
#pragma unroll
        for (int i = 0; i < VPG / kThreads; ++i) {
            const int idx = g * VPG + i * kThreads + tid;     // vector of the partition
            const int key = idx / VPK;
            const int c = (idx % VPK) * VEC;
            const bool in = t_begin + key < t_end;
            const long long src = in ? key * kstride + c : 0;
            cp_async16(sk + (key * HD + c) * (int)sizeof(Elem), kb + src, in ? 16 : 0);
            cp_async16(sv + (key * HD + c) * (int)sizeof(Elem), vb + src, in ? 16 : 0);
        }
        cp_async_commit();
    }

    float m[RC], l[RC], acc[RC][EPL];
#pragma unroll
    for (int r = 0; r < RC; ++r) {
        m[r] = -INFINITY;
        l[r] = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
        if (g == 0) cp_async_wait<kGroups - 1>();
        if (g == 1) cp_async_wait<kGroups - 2>();
        if (g == 2) cp_async_wait<kGroups - 3>();
        if (g == 3) cp_async_wait<0>();
        __syncthreads();
        float kf[STEPS][EPL], vf[STEPS][EPL];
        int kp[STEPS];
#pragma unroll
        for (int c = 0; c < STEPS; ++c) {
            const int key = g * GK + (c * kWarps + warp) * KPW + grp;
#pragma unroll
            for (int n = 0; n < NV; ++n) {
                load_vec(s_k + key * HD + sub * EPL + n * VEC, kf[c] + n * VEC);
                load_vec(s_v + key * HD + sub * EPL + n * VEC, vf[c] + n * VEC);
            }
            kp[c] = s_kpos[key];
        }
#pragma unroll
        for (int r = 0; r < RC; ++r) {
            if (r >= R) continue;      // uniform over the block
            float sc[STEPS];
#pragma unroll
            for (int c = 0; c < STEPS; ++c) {
                float d = 0.f;
#pragma unroll
                for (int e = 0; e < EPL; ++e) d = fmaf(qv[r][e], kf[c][e], d);
#pragma unroll
                for (int off = 1; off < LPK; off <<= 1) {
                    d += __shfl_xor_sync(0xffffffffu, d, off);
                }
                sc[c] = key_allowed(kp[c], qp[r], causal, window) ? d * scale : -INFINITY;
            }
            float mx = sc[0];
#pragma unroll
            for (int c = 1; c < STEPS; ++c) mx = fmaxf(mx, sc[c]);
            // Until a row has seen an allowed key its m stays -inf and the
            // shift is 0, so exp never sees inf - inf.
            const float mn = fmaxf(m[r], mx);
            const float mu = mn == -INFINITY ? 0.f : mn;
            const float corr = expf(m[r] - mu);
            float psum = 0.f;
#pragma unroll
            for (int c = 0; c < STEPS; ++c) {
                sc[c] = expf(sc[c] - mu);
                psum += sc[c];
            }
            l[r] = fmaf(l[r], corr, psum);
#pragma unroll
            for (int e = 0; e < EPL; ++e) {
                float a = acc[r][e] * corr;
#pragma unroll
                for (int c = 0; c < STEPS; ++c) a = fmaf(sc[c], vf[c][e], a);
                acc[r][e] = a;
            }
            m[r] = mn;
        }
    }

    // Merge the lane groups of a warp (lanes with the same slice of hd).
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
        for (int r = 0; r < RC; ++r) {
            if (r >= R) continue;
            float acco[EPL];
#pragma unroll
            for (int e = 0; e < EPL; ++e) acco[e] = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
            const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
            const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
            merge<EPL>(m[r], l[r], acc[r], mo, lo, acco);
        }
    }
    if (grp == 0) {
#pragma unroll
        for (int r = 0; r < RC; ++r) {
            if (r >= R) continue;
            if (sub == 0) {
                s_m[warp * RC + r] = m[r];
                s_l[warp * RC + r] = l[r];
            }
#pragma unroll
            for (int e = 0; e < EPL; ++e) {
                s_acc[(warp * RC + r) * HD + sub * EPL + e] = acc[r][e];
            }
        }
    }
    __syncthreads();
    // Merge the warps, in warp order, and write the partition's partials.
    for (int i = tid; i < R * HD; i += kThreads) {
        const int r = i / HD;
        const int d = i % HD;
        float mm = s_m[r], ll = s_l[r], aa = s_acc[r * HD + d];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
            const float ao = s_acc[(w * RC + r) * HD + d];
            merge<1>(mm, ll, &aa, s_m[w * RC + r], s_l[w * RC + r], &ao);
        }
        const long long pr = (prow + r) * nparts + part;
        pacc[pr * HD + d] = aa;
        if (d == 0) {
            pm[pr] = mm;
            pl[pr] = ll;
        }
    }
}

template <typename Elem, int HD, int RC>
constexpr int split_smem() {
    return 2 * kKBytes + 4 * partition_keys(HD, sizeof(Elem)) + 4 * kWarps * RC * (2 + HD);
}

// One block per (batch, kv head, row): the partials of the row, merged in
// partition order.  The weights are computed once into shared memory;
// each thread then sums its columns of acc.
template <typename Elem>
__global__ void __launch_bounds__(kCombineThreads)
flash_decode_combine(const float* __restrict__ pm, const float* __restrict__ pl,
                     const float* __restrict__ pacc, Elem* __restrict__ out, int S,
                     int H, int KH, int G, int R, int HD, int nparts) {
    extern __shared__ float s_w[];              // nparts weights
    __shared__ float s_red[kCombineThreads];
    __shared__ float s_total;
    const long long row = blockIdx.x;
    const int tid = threadIdx.x;
    const float* m = pm + row * nparts;
    const float* l = pl + row * nparts;
    float mx = -INFINITY;
    for (int p = tid; p < nparts; p += kCombineThreads) mx = fmaxf(mx, m[p]);
    s_red[tid] = mx;
    __syncthreads();
    if (tid == 0) {
        for (int i = 1; i < kCombineThreads; ++i) mx = fmaxf(mx, s_red[i]);
        s_red[0] = mx;
    }
    __syncthreads();
    mx = s_red[0];
    const float shift = mx == -INFINITY ? 0.f : mx;
    for (int p = tid; p < nparts; p += kCombineThreads) {
        s_w[p] = expf(m[p] - shift);            // 0 for an empty partition
    }
    __syncthreads();
    if (tid == 0) {
        float total = 0.f;
        for (int p = 0; p < nparts; ++p) total = total + l[p] * s_w[p];
        s_total = total;
    }
    __syncthreads();
    const float total = s_total;
    const int r = (int)(row % R);
    const long long bk = row / R;
    const int kvh = (int)(bk % KH);
    const long long b = bk / KH;
    const long long off = ((b * S + r / G) * H + kvh * G + r % G) * HD;
    for (int d = tid; d < HD; d += kCombineThreads) {
        const float* a = pacc + row * nparts * HD + d;
        float aa = 0.f;
#pragma unroll 8
        for (int p = 0; p < nparts; ++p) aa = aa + a[(long long)p * HD] * s_w[p];
        store_elem(out + off + d, total > 0.f ? aa / total : 0.f);
    }
}

// cudaFuncSetAttribute once per device and kernel (``done``: bit d set
// once device d has it); a host call the serve path need not repeat.
template <typename F>
cudaError_t set_smem_once(F* kernel, int bytes, unsigned long long& done) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 64 && ((done >> dev) & 1ull)) return cudaSuccess;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess && dev < 64) done |= 1ull << dev;
    return e;
}

template <typename Elem, int HD, int RC>
int launch(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
           void* out, float* pm, float* pl, float* pacc, int B, int S, int H, int KH,
           int T, float scale, int causal, int window, int nparts, cudaStream_t stream) {
    const int G = H / KH;
    const int R = S * G;
    constexpr int smem = split_smem<Elem, HD, RC>();
    static unsigned long long smem_set = 0;     // one per instantiation
    cudaError_t e = set_smem_once(flash_decode_split<Elem, HD, RC>, smem, smem_set);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)nparts, (unsigned)KH, (unsigned)B);
    flash_decode_split<Elem, HD, RC><<<grid, kThreads, smem, stream>>>(
        static_cast<const Elem*>(q), static_cast<const Elem*>(k),
        static_cast<const Elem*>(v), qpos, kpos, pm, pl, pacc, S, H, KH, T, G, R,
        nparts, scale, causal, window);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    flash_decode_combine<Elem><<<(unsigned)((long long)B * KH * R), kCombineThreads,
                                 nparts * sizeof(float), stream>>>(
        pm, pl, pacc, static_cast<Elem*>(out), S, H, KH, G, R, HD, nparts);
    return (int)cudaGetLastError();
}

template <typename Elem, int HD>
int launch_rows(int R, const void* q, const void* k, const void* v, const int* qpos,
                const int* kpos, void* out, float* pm, float* pl, float* pacc, int B,
                int S, int H, int KH, int T, float scale, int causal, int window,
                int nparts, cudaStream_t stream) {
    if (R <= 4) {
        return launch<Elem, HD, 4>(q, k, v, qpos, kpos, out, pm, pl, pacc, B, S, H, KH,
                                   T, scale, causal, window, nparts, stream);
    }
    return launch<Elem, HD, kMaxRows>(q, k, v, qpos, kpos, out, pm, pl, pacc, B, S, H,
                                      KH, T, scale, causal, window, nparts, stream);
}

template <typename Elem>
int launch_hd(int hd, int R, const void* q, const void* k, const void* v,
              const int* qpos, const int* kpos, void* out, float* pm, float* pl,
              float* pacc, int B, int S, int H, int KH, int T, float scale, int causal,
              int window, int nparts, cudaStream_t stream) {
    switch (hd) {
        case 32:
            return launch_rows<Elem, 32>(R, q, k, v, qpos, kpos, out, pm, pl, pacc, B, S,
                                         H, KH, T, scale, causal, window, nparts, stream);
        case 64:
            return launch_rows<Elem, 64>(R, q, k, v, qpos, kpos, out, pm, pl, pacc, B, S,
                                         H, KH, T, scale, causal, window, nparts, stream);
        case 128:
            return launch_rows<Elem, 128>(R, q, k, v, qpos, kpos, out, pm, pl, pacc, B,
                                          S, H, KH, T, scale, causal, window, nparts,
                                          stream);
        case 256:
            return launch_rows<Elem, 256>(R, q, k, v, qpos, kpos, out, pm, pl, pacc, B,
                                          S, H, KH, T, scale, causal, window, nparts,
                                          stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  ``part`` must be this library's
// partition size for (hd, dtype), 32768 / (hd · element bytes), and
// ``nparts`` = ceil(T / part); pm and pl hold
// B·KH·S·G·nparts floats, pacc that many times hd.  Returns the launches'
// cudaError_t.
int fs_flash_decode(const void* q, const void* k, const void* v, const int* qpos,
                    const int* kpos, void* out, void* pm, void* pl, void* pacc, int B,
                    int S, int H, int KH, int T, int hd, int dtype, float scale,
                    int causal, int window, int part, int nparts, void* stream) {
    const int esize = dtype == 0 ? 4 : 2;
    if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0 || (hd != 32 && hd != 64
        && hd != 128 && hd != 256) || part != partition_keys(hd, esize)
        || nparts != (T + part - 1) / part || B > 65535 || KH > 65535
        || nparts > 12288) {   // the combine's weights fit 48 KB
        return (int)cudaErrorInvalidValue;
    }
    const int R = S * (H / KH);
    if (R > kMaxRows) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* m = static_cast<float*>(pm);
    float* l = static_cast<float*>(pl);
    float* a = static_cast<float*>(pacc);
    if (dtype == 0) {
        return launch_hd<float>(hd, R, q, k, v, qpos, kpos, out, m, l, a, B, S, H, KH, T,
                                scale, causal, window, nparts, st);
    }
    if (dtype == 1) {
        return launch_hd<__nv_bfloat16>(hd, R, q, k, v, qpos, kpos, out, m, l, a, B, S,
                                        H, KH, T, scale, causal, window, nparts, st);
    }
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
