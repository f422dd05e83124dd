// Flash attention, forward, bf16, on the tensor cores: the prefill kernel.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel (line 40,
// the Pallas TPU kernel) for bf16 inputs whose S·G rows per kv head are
// more than the split-KV decode takes (kernels/flash_attention.py::
// flash_route).  It computes that kernel's function:
//
//   out[b, s, h] = Σ_t softmax_t(q[b,s,h]·k[b,t,kv] · scale) · v[b,t,kv]
//
// over the allowed keys t: kpos[t] >= 0, kpos[t] <= qpos[s] when causal,
// kpos[t] > qpos[s] - window when a window is set; kv = h / (H / KH).
// Scores, the softmax, m, l and the accumulator are float32, and p keeps
// its float32 precision in P·V.  A row with no allowed key gets 0.
// Layouts: q and out (B, S, H, hd), k and v (B, T, KH, hd), contiguous;
// qpos (S,) and kpos (T,) int32.
//
// What bounds it: 4·hd flops per allowed (query, key) pair, on 2·hd·2
// bytes per key that L2 serves to every query tile: at SmolLM-360M's
// prefill (hd 64, S = T = 16 384) it is bound by the tensor cores (989
// TFLOP/s dense bf16), then by the softmax's float32 work (an IEEE expf,
// the scale, max, sum and the split of p: ~15 CUDA-core ops per pair,
// against 33.5e12 ops/s).
//
// Design:
// * One CTA of 384 threads per (tile of 128 query positions, query head,
//   batch); GQA is not folded into the rows (a 64-row wgmma tile does not
//   divide into G = 3 heads; L2 shares K/V between the G heads).  The
//   grid runs the last query tiles (the longest under a causal mask)
//   first.
// * Warpgroup 0 is the producer: one warp scans each key tile's kpos,
//   skips the tile when none of its keys is allowed for any row of the
//   CTA (judged from the kpos values and the CTA's [qmin, qmax], never
//   from the tile's index: a wrapped ring has unsorted kpos), marks it
//   "whole" when every key is allowed for every row, and has TMA copy the
//   K and V tiles (128-byte or 64-byte swizzle, a 4-D tensor map over
//   (B, T, KH, hd)) into a two-stage ring in dynamic shared memory, on
//   mbarriers; keys past T arrive as zeros.  After the last live tile it
//   posts an end marker.  It gives registers away (setmaxnreg).
// * Warpgroups 1 and 2 are consumers, 64 query rows each.  S = Q·Kᵀ is
//   wgmma m64nBNk16 with Q and K in shared memory, float32 accumulators.
//   The mask is applied only on tiles that are not whole (the diagonal,
//   holes, the window, the ragged T edge).  Online softmax in registers
//   on the accumulator fragment: row max and sum over the 4 threads of a
//   row (quad shuffles); the IEEE expf (never fast math); FMAs written
//   as fmaf where one is meant (the library builds with -fmad=false).
// * P·V keeps p's float32 precision: p = p_hi + p_lo, p_hi = bf16(p),
//   p_lo = bf16(p − p_hi); two wgmma m64nHDk16 with A from registers and
//   V (MN-major, the transpose bit) in shared memory accumulate both into
//   one float32 tile accumulator.  The residual is ~2^-17·p; l sums the
//   float32 p.  The tile's sum is added to the row's accumulator on the
//   CUDA cores (O = O·corr + O_tile): the tensor cores' own accumulation
//   is coarser than a float32 add, and over a 16k-key row it moved many
//   more bf16 outputs by an ulp; per tile it stays at 16 steps.
// * Rows past S are computed on zeros and never stored; a row whose l is
//   0 stores zeros.
// * head_dim 256 (PaliGemma) breaks both budgets of the shape above, so it
//   takes smaller pieces.  Shared memory: key tiles of BN = 64 (Q 64 KB,
//   two stages of K and V 128 KB: 192 KB of the 227 KB a block may have;
//   BN = 128 would need 320 KB).  Registers: a consumer thread holds its
//   rows' float32 O (hd/2 = 128 values); O_tile for all 256 columns would
//   add 128 more, past the 232 it is given.  So P·V runs in NC = 64-column
//   chunks of V, one swizzle atom each: for each chunk the same p_hi and
//   p_lo fragments, two wgmma m64n64k16 per 16 keys into one 32-value
//   O_tile, then O = O·corr + O_tile for those columns on the CUDA cores,
//   as at the other head dims (the same precision: p float32, each tile's
//   sum added in float32).  At hd ≤ 128 NC = hd: one chunk, as before.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 384;     // producer warpgroup + two consumers
constexpr int kBM = 128;          // query positions per CTA
constexpr int kStages = 2;        // K/V ring depth
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int HD>
struct Cfg {
    static constexpr int BN = HD >= 128 ? 64 : 128;       // keys per tile
    static constexpr int NC = HD > 128 ? 64 : HD;         // V columns per P·V chunk
    static constexpr int SW = HD * 2 >= 128 ? 128 : HD * 2;  // swizzle bytes
    static constexpr int AC = SW / 2;                     // columns per atom
    static constexpr int NA = HD / AC;                    // atoms along hd
    static constexpr int LAYOUT = SW == 128 ? 1 : 2;      // wgmma swizzle code
    static constexpr int Q_BYTES = kBM * HD * 2;
    static constexpr int KV_BYTES = BN * HD * 2;
    // Offsets from the 1024-byte-aligned base of dynamic shared memory.
    static constexpr int OFF_K = Q_BYTES;
    static constexpr int OFF_V = OFF_K + kStages * KV_BYTES;
    static constexpr int OFF_KPOS = OFF_V + kStages * KV_BYTES;
    static constexpr int OFF_META = OFF_KPOS + kStages * BN * 4;
    static constexpr int OFF_BAR = OFF_META + kStages * 8;   // 8-aligned
    static constexpr int OFF_QRANGE = OFF_BAR + 8 * (1 + 3 * kStages);
    static constexpr int SMEM = 1024 + OFF_QRANGE + 8;      // + alignment slack
    static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "tile alignment");
    static_assert(HD % NC == 0 && (NC == HD || NC % AC == 0), "PV chunks of whole swizzle atoms");
    static_assert(SMEM <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// Returns once the phase of parity ``parity`` has completed.  A wait that
// never completes (a broken pipeline) traps after 2^28 polls (seconds)
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    for (uint32_t polls = 0; !done; ++polls) {
        if (polls == (1u << 28)) __trap();
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
           "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle code in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses to accumulator registers across
// the asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D(64×64) (+)= A·B, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

// D(64×128) (+)= A·B, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
}

// D(64×32) (+)= A·B, A in registers, B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D(64×64) (+)= A·B, A in registers, B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D(64×128) (+)= A·B, A in registers, B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int acc) {
    static_assert(N == 64 || N == 128, "key tile");
    if constexpr (N == 64) {
        wgmma_ss_n64(d, da, db, acc);
    } else {
        wgmma_ss_n128(d, da, db, acc);
    }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db, int acc) {
    static_assert(N == 32 || N == 64 || N == 128, "V columns of a PV chunk");
    if constexpr (N == 32) {
        wgmma_rs_n32(d, a, db, acc);
    } else if constexpr (N == 64) {
        wgmma_rs_n64(d, a, db, acc);
    } else {
        wgmma_rs_n128(d, a, db, acc);
    }
}

__device__ __forceinline__ bool key_allowed(int kp, int qp, int causal, int window) {
    return kp >= 0 && (!causal || kp <= qp)
        && (!window || (long long)kp > (long long)qp - window);
}

// (x, y) → their bf16 pair (hi) and the bf16 pair of what hi leaves (lo).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const int* __restrict__ qpos, const int* __restrict__ kpos,
                     __nv_bfloat16* __restrict__ out, int S, int H, int KH, int T,
                     int n_qtiles, float scale, int causal, int window) {
    using C = Cfg<HD>;
    constexpr int BN = C::BN, SW = C::SW, AC = C::AC, NA = C::NA;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const uint32_t base = smem_u32(smem);
    int* s_kpos = reinterpret_cast<int*>(smem + C::OFF_KPOS);
    int* s_meta = reinterpret_cast<int*>(smem + C::OFF_META);   // (tile, whole)
    int* s_qrange = reinterpret_cast<int*>(smem + C::OFF_QRANGE);
    const uint32_t bar_q = base + C::OFF_BAR;
    auto full_k = [&](int st) { return bar_q + 8u * (1 + st); };
    auto full_v = [&](int st) { return bar_q + 8u * (1 + kStages + st); };
    auto empty = [&](int st) { return bar_q + 8u * (1 + 2 * kStages + st); };

    const int tid = threadIdx.x;
    const int h = blockIdx.x % H;
    const int b = blockIdx.x / H;
    const int q0 = (n_qtiles - 1 - (int)blockIdx.y) * kBM;   // longest tiles first
    const int kvh = h / (H / KH);

    if (tid == 0) {
        s_qrange[0] = INT_MAX;
        s_qrange[1] = INT_MIN;
        mbar_init(bar_q, 1);
        for (int st = 0; st < kStages; ++st) {
            mbar_init(full_k(st), 1);
            mbar_init(full_v(st), 1);
            mbar_init(empty(st), 8);     // one arrival per consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid < kBM && q0 + tid < S) {
        const int qp = qpos[q0 + tid];
        atomicMin(&s_qrange[0], qp);
        atomicMax(&s_qrange[1], qp);
    }
    __syncthreads();
    const int qmin = s_qrange[0];
    const int qmax = s_qrange[1];

    if (tid < 128) {
        // ---- producer ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
        if (tid < 32) {
            const int lane = tid;
            if (lane == 0) {
                mbar_arrive_tx(bar_q, C::Q_BYTES);
#pragma unroll
                for (int a = 0; a < NA; ++a) {
                    tma_load_4d(base + a * (kBM * SW), &qmap, bar_q, a * AC, h, q0, b);
                }
            }
            int stage = 0;
            uint32_t phase = 0;
            const int ntiles = (T + BN - 1) / BN;
            for (int j = 0; j < ntiles; ++j) {
                const int t0 = j * BN;
                int kp[BN / 32];
                bool any = false, all = true;
#pragma unroll
                for (int i = 0; i < BN / 32; ++i) {
                    const int t = t0 + lane + 32 * i;
                    kp[i] = t < T ? kpos[t] : -1;
                    // allowed for some row / for every row of the CTA: the
                    // rows' positions lie in [qmin, qmax]
                    any |= kp[i] >= 0 && (!causal || kp[i] <= qmax)
                        && (!window || (long long)kp[i] > (long long)qmin - window);
                    all &= kp[i] >= 0 && (!causal || kp[i] <= qmin)
                        && (!window || (long long)kp[i] > (long long)qmax - window);
                }
                if (!__any_sync(0xffffffffu, any)) continue;
                const int whole = __all_sync(0xffffffffu, all);
                if (lane == 0) mbar_wait(empty(stage), phase ^ 1u);
                __syncwarp();
#pragma unroll
                for (int i = 0; i < BN / 32; ++i) s_kpos[stage * BN + lane + 32 * i] = kp[i];
                if (lane == 0) {
                    s_meta[2 * stage] = j;
                    s_meta[2 * stage + 1] = whole;
                }
                __syncwarp();
                if (lane == 0) {
                    const uint32_t dk = base + C::OFF_K + stage * C::KV_BYTES;
                    const uint32_t dv = base + C::OFF_V + stage * C::KV_BYTES;
                    mbar_arrive_tx(full_k(stage), C::KV_BYTES);
#pragma unroll
                    for (int a = 0; a < NA; ++a) {
                        tma_load_4d(dk + a * (BN * SW), &kmap, full_k(stage), a * AC, kvh, t0, b);
                    }
                    mbar_arrive_tx(full_v(stage), C::KV_BYTES);
#pragma unroll
                    for (int a = 0; a < NA; ++a) {
                        tma_load_4d(dv + a * (BN * SW), &vmap, full_v(stage), a * AC, kvh, t0, b);
                    }
                }
                if (++stage == kStages) {
                    stage = 0;
                    phase ^= 1u;
                }
            }
            if (lane == 0) {     // end marker
                mbar_wait(empty(stage), phase ^ 1u);
                s_meta[2 * stage] = -1;
                mbar_arrive(full_k(stage));
            }
        }
    } else {
        // ---- consumers: 64 query rows each ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
        const int cw = tid / 128 - 1;
        const int warp = (tid % 128) / 32;
        const int lane = tid % 32;
        const int r0 = cw * 64 + warp * 16 + lane / 4;    // rows r0 and r0 + 8
        const bool ok0 = q0 + r0 < S;
        const bool ok1 = q0 + r0 + 8 < S;
        const int qp0 = ok0 ? qpos[q0 + r0] : 0;
        const int qp1 = ok1 ? qpos[q0 + r0 + 8] : 0;

        constexpr int NC = C::NC;
        float o[HD / 2], ot[NC / 2];
        float s[BN / 2];
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
        for (int i = 0; i < NC / 2; ++i) ot[i] = 0.f;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
        float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
        const uint32_t q_base = base + cw * 64 * SW;
        int stage = 0;
        uint32_t phase = 0;
        mbar_wait(bar_q, 0);
        for (;;) {
            mbar_wait(full_k(stage), phase);
            if (s_meta[2 * stage] < 0) break;
            const int whole = s_meta[2 * stage + 1];
            const uint32_t k_base = base + C::OFF_K + stage * C::KV_BYTES;
            const uint32_t v_base = base + C::OFF_V + stage * C::KV_BYTES;

            // S = Q·Kᵀ (64 × BN per warpgroup)
            fence_regs<BN / 2>(s);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const int a = kk * 16 / AC;
                const uint32_t off = (kk * 16 % AC) * 2;
                const uint64_t da = make_desc(q_base + a * (kBM * SW) + off, 0, 8 * SW, C::LAYOUT);
                const uint64_t db = make_desc(k_base + a * (BN * SW) + off, 0, 8 * SW, C::LAYOUT);
                wgmma_ss<BN>(s, da, db, kk > 0);
            }
            wgmma_commit();
            wgmma_wait0();
            fence_regs<BN / 2>(s);

            // Fragment element i: row r0 + 8·((i >> 1) & 1), key column
            // 8·(i >> 2) + 2·(lane % 4) + (i & 1).
            if (!whole) {
                const int* kp = s_kpos + stage * BN;
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) {
                    const int col = (i >> 2) * 8 + (lane % 4) * 2 + (i & 1);
                    if (!key_allowed(kp[col], (i & 2) ? qp1 : qp0, causal, window)) {
                        s[i] = -INFINITY;
                    }
                }
            }
            float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) {
                if (i & 2) {
                    mx1 = fmaxf(mx1, s[i]);
                } else {
                    mx0 = fmaxf(mx0, s[i]);
                }
            }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
                mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
            }
            // Scores are scaled after the dot; scale > 0, so the max of the
            // scaled scores is the scaled max.  Until a row has seen an
            // allowed key its m stays -inf and the shift is 0, which keeps
            // exp's arguments free of inf - inf.
            const float mn0 = fmaxf(m0, mx0 * scale);
            const float mn1 = fmaxf(m1, mx1 * scale);
            const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
            const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
            const float c0 = expf(m0 - mu0);
            const float c1 = expf(m1 - mu1);
            m0 = mn0;
            m1 = mn1;
            float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) {
                if (i & 2) {
                    s[i] = expf(fmaf(s[i], scale, -mu1));
                    sum1 += s[i];
                } else {
                    s[i] = expf(fmaf(s[i], scale, -mu0));
                    sum0 += s[i];
                }
            }
            l0 = fmaf(l0, c0, sum0);     // per-thread partial sums of the row
            l1 = fmaf(l1, c1, sum1);

            // p as A fragments: keys 16·kk .. 16·kk + 15 of the tile.
            uint32_t ph[BN / 16][4], pl[BN / 16][4];
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const int i = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
                    split_bf16(s[i], s[i + 1], ph[kk][r], pl[kk][r]);
                }
            }

            // O_tile = p_hi·V + p_lo·V on the tensor cores, then
            // O = O·corr + O_tile in float32 on the CUDA cores: the tensor
            // cores' accumulation rounds coarser than float32 adds, so a
            // sum over the whole row stays out of them.  Chunk c holds V's
            // columns c·NC .. c·NC + NC - 1 (atoms c·NC/AC on).
            mbar_wait(full_v(stage), phase);
#pragma unroll
            for (int c = 0; c < HD / NC; ++c) {
                const uint32_t v_chunk = v_base + c * (NC / AC) * (BN * SW);
                fence_regs<NC / 2>(ot);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < BN / 16; ++kk) {
                    const uint64_t dv = make_desc(v_chunk + kk * 16 * SW, BN * SW, 8 * SW,
                                                  C::LAYOUT);
                    wgmma_rs<NC>(ot, ph[kk], dv, kk > 0);
                    wgmma_rs<NC>(ot, pl[kk], dv, 1);
                }
                wgmma_commit();
                wgmma_wait0();
                fence_regs<NC / 2>(ot);
#pragma unroll
                for (int i = 0; i < NC / 2; ++i) {
                    o[c * NC / 2 + i] = fmaf(o[c * NC / 2 + i], (i & 2) ? c1 : c0, ot[i]);
                }
            }
            if (lane == 0) mbar_arrive(empty(stage));
            if (++stage == kStages) {
                stage = 0;
                phase ^= 1u;
            }
        }

#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            l0 += __shfl_xor_sync(0xffffffffu, l0, off);
            l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const bool ok = half ? ok1 : ok0;
            const float l = half ? l1 : l0;
            if (!ok) continue;
            __nv_bfloat16* row = out + (((long long)b * S + q0 + r0 + 8 * half) * H + h) * HD;
#pragma unroll
            for (int j = 0; j < HD / 8; ++j) {
                const float x = l > 0.f ? o[4 * j + 2 * half] / l : 0.f;
                const float y = l > 0.f ? o[4 * j + 2 * half + 1] / l : 0.f;
                *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * (lane % 4)) =
                    __floats2bfloat162_rn(x, y);
            }
        }
    }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime so
// that the library needs no -lcuda.
EncodeTiledFn encode_fn() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                      cudaEnableDefault, &found);
#endif
        if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) {
            fn = reinterpret_cast<EncodeTiledFn>(p);
        }
    }
    return fn;
}

// A (rows, heads, hd) bf16 tensor per batch → a 4-D map whose box is one
// head's ``box_rows`` rows × one swizzle atom of columns.
bool make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int hd, int heads,
              int rows, int batch, int box_rows, int sw) {
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)rows,
                                (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                   (cuuint64_t)rows * heads * hd * 2};
    const cuuint32_t box[4] = {(cuuint32_t)(sw / 2), 1, (cuuint32_t)box_rows, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
               strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
               sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

template <int HD>
int launch(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
           void* out, int B, int S, int H, int KH, int T, float scale, int causal,
           int window, cudaStream_t stream) {
    using C = Cfg<HD>;
    const EncodeTiledFn enc = encode_fn();
    if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
    const long long n_qtiles = (S + kBM - 1) / kBM;
    if (n_qtiles > 65535 || (long long)B * H > INT_MAX) {
        return (int)cudaErrorInvalidConfiguration;
    }
    CUtensorMap qm, km, vm;
    if (!make_map(enc, &qm, q, HD, H, S, B, kBM, C::SW)
        || !make_map(enc, &km, k, HD, KH, T, B, C::BN, C::SW)
        || !make_map(enc, &vm, v, HD, KH, T, B, C::BN, C::SW)) {
        return (int)cudaErrorInvalidValue;
    }
    static unsigned long long smem_set = 0;     // one per instantiation
    const cudaError_t e = set_smem_once(flash_prefill_kernel<HD>, C::SMEM, smem_set);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)(B * H), (unsigned)n_qtiles);
    flash_prefill_kernel<HD><<<grid, kThreads, C::SMEM, stream>>>(
        qm, km, vm, qpos, kpos, static_cast<__nv_bfloat16*>(out), S, H, KH, T,
        (int)n_qtiles, scale, causal, window);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 only.  Returns the launch's cudaError_t.
int fs_flash_prefill(const void* q, const void* k, const void* v, const int* qpos,
                     const int* kpos, void* out, int B, int S, int H, int KH, int T,
                     int hd, float scale, int causal, int window, void* stream) {
    if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (hd) {
        case 32:
            return launch<32>(q, k, v, qpos, kpos, out, B, S, H, KH, T, scale, causal,
                              window, st);
        case 64:
            return launch<64>(q, k, v, qpos, kpos, out, B, S, H, KH, T, scale, causal,
                              window, st);
        case 128:
            return launch<128>(q, k, v, qpos, kpos, out, B, S, H, KH, T, scale, causal,
                               window, st);
        case 256:
            return launch<256>(q, k, v, qpos, kpos, out, B, S, H, KH, T, scale, causal,
                               window, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
