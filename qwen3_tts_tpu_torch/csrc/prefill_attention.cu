// Causal GQA flash attention for the talker prefill, over a left-padded batch.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/prefill_attention.py
// `flash_prefill` (kernel body `_prefill_kernel`); its plain twin is
// `flash_prefill_ref` in qwen3_tts_tpu_torch/ops/cuda/prefill_attention.py.
//
// What it computes: out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h/G] * scale)
// . v[b, j, h/G] over the keys start[b] <= j <= i (and j > i - window when a
// sliding window is set), with an fp32 online softmax. Query rows in the left
// padding (i < start[b]) see no key and are written as zeros.
//
// What bounds it on the H100: tensor-core operations. At the 1.7B shapes
// (Hq 16, Hkv 8, D 128, bf16) and B=4, T=2048 without padding the two
// products are 4*B*Hq*D*T(T+1)/2 = 68.8 GFLOP (~70 us at 989 TFLOP/s) against
// ~101 MB of q/k/v/out (~30 us at 3.35 TB/s), so each layer's call is
// compute-bound; only wgmma reaches the card's tensor-core rate.
//
// The design (Hopper: TMA, wgmma, warp specialisation, a persistent grid):
//   * a work item is (batch row, kv head, 64 query positions); the wrapper's
//     `flash_plan` lists, per item, the 128-key tiles it visits (from
//     max(start, q_lo - window + 1) to the causal diagonal: the TPU kernel's
//     block skip) and which of them are wholly visible (no mask), and deals
//     the items heaviest first over one CTA per SM (the persistent grid);
//   * three warpgroups: one producer warp starts every load as TMA tensor
//     copies straight from the strided (D, H, T, B) views the prefill hands
//     over (q/k/v are views into one fused qkv product: no copy), the Q tile
//     once per item and the K/V tiles into a 2-stage ring, each stage with a
//     full and an empty mbarrier; keys past T arrive as TMA's zero fill;
//   * two consumer warpgroups take the G = 2 query heads of the kv head, 64
//     rows each, so every K/V tile in shared memory serves both heads (the
//     TPU kernel's static G-loop); setmaxnreg moves the producer's registers
//     to them;
//   * S = Q K^T as wgmma m64n128k16 with both operands in shared memory
//     (128-byte swizzle; a 128-wide head row is two 64-column TMA boxes and
//     the descriptors walk both halves), fp32 accumulators in registers;
//     masks only on the item's edge tiles; the online softmax in exp2 with the
//     scale folded in; P rounds to bf16 in registers, where the score
//     accumulator's layout is the A fragment of O += P V (wgmma with A from
//     registers), V the B operand read MN-major through the descriptor's
//     transpose bit, so V is never transposed in memory; a stage's empty
//     barrier is released once its P V product is done;
//   * every mbarrier wait gives up after ~2^32 clocks and traps, so a lost
//     arrival fails the launch in seconds instead of hanging the card.
//
// Built for the one shape the released configurations (1.7B and 0.6B) use
// and the on-card check holds against the twin: bf16, D = 128, G = Hq / Hkv =
// 2. Another width gets its own instantiation and its own on-card case.
#include <cuda.h>   // CUtensorMap; the encoder comes through the runtime's entry-point query

#include "common.cuh"

namespace {

constexpr int FP_D = 128;         // head dim
constexpr int FP_G = 2;           // query heads per kv head = consumer warpgroups
constexpr int FP_BQ = 64;         // query positions per work item (one wgmma M)
constexpr int FP_BK = 128;        // keys per K/V tile (one wgmma N)
constexpr int FP_BOX = 64;        // bf16 columns per TMA box: 128 bytes, the swizzle's row
constexpr int FP_STAGES = 2;
constexpr int FP_THREADS = 384;   // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int FP_CONSUMERS = FP_G * 128;
constexpr int FP_ITEM = 8;        // ints per work item (ops/cuda/prefill_attention.py)
constexpr long long FP_WAIT_CLOCKS = 1ll << 32;   // ~2.4 s at 1.755 GHz

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle's
// period). A tile is stored as two halves of 64 columns, each row 128 bytes.
constexpr uint32_t SM_Q_HALF = FP_BQ * FP_BOX * 2;      //  8 KB
constexpr uint32_t SM_Q_HEAD = 2 * SM_Q_HALF;           // 16 KB
constexpr uint32_t SM_KV_HALF = FP_BK * FP_BOX * 2;     // 16 KB
constexpr uint32_t SM_KV_TILE = 2 * SM_KV_HALF;         // 32 KB
constexpr uint32_t SM_Q = 0;
constexpr uint32_t SM_K = SM_Q + FP_G * SM_Q_HEAD;      // 32 KB
constexpr uint32_t SM_V = SM_K + FP_STAGES * SM_KV_TILE;
constexpr uint32_t SM_BAR = SM_V + FP_STAGES * SM_KV_TILE;   // 160 KB
// barriers: full[s] at 8 s, empty[s] at 16 + 8 s, q_full at 32, q_empty at 40
constexpr uint32_t SM_BYTES = SM_BAR + 64 + 1024;       // + the alignment slack

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

// one arrival that also announces `bytes` of TMA transactions to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the phase of parity `parity` to complete; trap if it never does.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > FP_WAIT_CLOCKS) __trap();
}

// ---- TMA ------------------------------------------------------------------

// One box of the (D, H, T, B) view at element coordinates (d, h, t, b) into
// shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int h, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(t), "r"(b)
      : "memory");
}

// A 128-wide head row of `rows` positions: two 64-column boxes, half h at
// dst + h * half_bytes.
__device__ __forceinline__ void tma_rows(uint32_t dst, uint32_t half_bytes, const CUtensorMap* map,
                                         uint32_t bar, int h, int t, int b) {
  tma_load(dst, map, bar, 0, h, t, b);
  tma_load(dst + half_bytes, map, bar, FP_BOX, h, t, b);
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator registers across an async wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FP_REGS64                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define FP_ACC8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define FP_ACC64                                                                       \
  FP_ACC8(0), FP_ACC8(8), FP_ACC8(16), FP_ACC8(24), FP_ACC8(32), FP_ACC8(40), FP_ACC8(48), \
      FP_ACC8(56)

// d (64 x 128, f32) (+)= A (64 x 16) B (16 x 128), both from shared memory,
// both K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FP_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FP_ACC64
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 128)
// from shared memory read MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FP_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FP_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
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

// S (64 queries x 128 keys) = Q K^T over D = 128: eight k-steps of 16, four
// in each 64-column half; within a half a step is 32 bytes further along the
// swizzled 128-byte rows. K-major: the leading offset is unused, 1024 bytes
// to the next 8 rows.
__device__ __forceinline__ void s_product(float (&s)[64], uint32_t q_tile, uint32_t k_tile) {
  fence_acc(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < FP_D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss(s, sw128_desc(q_tile + (kk / 4) * SM_Q_HALF + off, 16, 1024),
             sw128_desc(k_tile + (kk / 4) * SM_KV_HALF + off, 16, 1024), kk > 0);
  }
  wg_commit();
  wg_wait0();
  fence_acc(s);
}

// P (64 x 128 keys) as bf16 A fragments: the score accumulator's layout (per
// warp rows 16w + lane/4 and + 8, per 8-key block j the keys 8j + 2(lane%4)
// and + 1) is the A fragment of k-step kk = keys 16kk..16kk + 15.
__device__ __forceinline__ void p_frags(const float (&p)[64], uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16(p[8 * kk + 0], p[8 * kk + 1]);
    pa[kk][1] = pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
    pa[kk][2] = pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
    pa[kk][3] = pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
  }
}

// O (64 x 128 d) += P V over the tile's 128 keys: eight k-steps of 16 keys,
// each 16 rows (2048 bytes) further into the V tile. MN-major: 1024 bytes
// to the next 8 keys (stride offset), one half (16 KB) to the next 64
// columns of d (leading offset).
__device__ __forceinline__ void pv_product(float (&o)[64], const uint32_t (&pa)[8][4],
                                           uint32_t v_tile) {
  fence_acc(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < FP_BK / 16; ++kk)
    wgmma_rs_t(o, pa[kk], sw128_desc(v_tile + kk * 16 * 128, SM_KV_HALF, 1024));
  wg_commit();
  wg_wait0();
  fence_acc(o);
}

}  // namespace

struct FlashPrefillArgs {
  int B, T, Hq, Hkv, D, window;  // window 0 = none
  int grid;                      // CTAs: the plan's item lists
  float scale;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh;  // element strides
  const bf16* q;       // (B, T, Hq, D) view, last axis contiguous
  const bf16* k;       // (B, T, Hkv, D) view
  const bf16* v;       // (B, T, Hkv, D) view
  bf16* out;           // (B, T, Hq, D) contiguous
  const int* items;    // (n, FP_ITEM) work items, grouped by CTA (flash_plan)
  const int* item_off; // (grid + 1,) CTA c runs items [item_off[c], item_off[c + 1])
};

// A work item (ops/cuda/prefill_attention.py `flash_plan`): batch row, kv
// head, first query position, the visited 128-key tiles [kt_lo, kt_hi]
// (empty: every row is left padding, a zero write), the unmasked tiles
// [um_lo, um_hi], and the row's first valid slot.
struct Item {
  int b, hk, q_lo, kt_lo, kt_hi, um_lo, um_hi, start;
};

__device__ __forceinline__ Item load_item(const int* p) {
  const int4 x = *reinterpret_cast<const int4*>(p);
  const int4 y = *reinterpret_cast<const int4*>(p + 4);
  return Item{x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
}

__global__ void __launch_bounds__(FP_THREADS, 1)
    k_flash_prefill(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const FlashPrefillArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + SM_BAR;
  const uint32_t q_full = bar + 32, q_empty = bar + 40;
  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < FP_STAGES; ++s) {
      mbar_init(bar + 8 * s, 1);
      mbar_init(bar + 16 + 8 * s, FP_CONSUMERS);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, FP_CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int i0 = a.item_off[blockIdx.x], i1 = a.item_off[blockIdx.x + 1];

  if (wg == FP_G) {
    // ---- producer: one thread starts every TMA copy ----
    reg_dealloc<40>();
    if (tid == FP_G * 128) {
      int it = 0, qi = 0;
      for (int i = i0; i < i1; ++i) {
        const Item w = load_item(a.items + (size_t)i * FP_ITEM);
        if (w.kt_lo > w.kt_hi) continue;
        for (int kt = w.kt_lo; kt <= w.kt_hi; ++kt, ++it) {
          const int s = it % FP_STAGES;
          const uint32_t ph = (it / FP_STAGES) & 1;
          mbar_wait(bar + 16 + 8 * s, ph ^ 1);
          mbar_expect_tx(bar + 8 * s, 2 * SM_KV_TILE);
          tma_rows(base + SM_K + s * SM_KV_TILE, SM_KV_HALF, &tk, bar + 8 * s, w.hk,
                   kt * FP_BK, w.b);
          tma_rows(base + SM_V + s * SM_KV_TILE, SM_KV_HALF, &tv, bar + 8 * s, w.hk,
                   kt * FP_BK, w.b);
          if (kt == w.kt_lo) {   // the item's Q once its first K/V tile is on its way
            mbar_wait(q_empty, (qi & 1) ^ 1);
            mbar_expect_tx(q_full, FP_G * SM_Q_HEAD);
            for (int g = 0; g < FP_G; ++g)
              tma_rows(base + SM_Q + g * SM_Q_HEAD, SM_Q_HALF, &tq, q_full, w.hk * FP_G + g,
                       w.q_lo, w.b);
            ++qi;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup g takes query head hk * G + g ----
    reg_alloc<232>();
    const int g = wg, lane = tid & 31, warp = (tid & 127) >> 5;
    const int c2 = 2 * (lane & 3);
    const int r0 = 16 * warp + (lane >> 2);   // this thread's rows r0 and r0 + 8
    const int T = a.T, window = a.window;
    const float sl2 = a.scale * 1.4426950408889634f;   // scores in log2 units
    const uint32_t q_tile = base + SM_Q + g * SM_Q_HEAD;
    const long long ost = (long long)a.Hq * FP_D;
    int it = 0, qi = 0;
    for (int i = i0; i < i1; ++i) {
      const Item w = load_item(a.items + (size_t)i * FP_ITEM);
      const int hq = w.hk * FP_G + g;
      const int row0 = w.q_lo + r0, row1 = row0 + 8;
      bf16* out0 = a.out + ((long long)w.b * T + row0) * ost + hq * FP_D;
      bf16* out1 = out0 + 8 * ost;
      if (w.kt_lo > w.kt_hi) {   // every row in the left padding
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (row0 < T) *reinterpret_cast<uint32_t*>(out0 + 8 * j + c2) = 0u;
          if (row1 < T) *reinterpret_cast<uint32_t*>(out1 + 8 * j + c2) = 0u;
        }
        continue;
      }
      float o[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) o[e] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
      mbar_wait(q_full, qi & 1);
      for (int kt = w.kt_lo; kt <= w.kt_hi; ++kt, ++it) {
        const int s = it % FP_STAGES;
        mbar_wait(bar + 8 * s, (it / FP_STAGES) & 1);
        float sc[64];
        s_product(sc, q_tile, base + SM_K + s * SM_KV_TILE);
        if (kt == w.kt_hi) mbar_arrive(q_empty);   // the item's last read of Q
        const int k0 = kt * FP_BK;
        const bool masked = kt < w.um_lo || kt > w.um_hi;
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          float x = sc[e] * sl2;
          if (masked) {
            const int key = k0 + 8 * (e >> 2) + c2 + (e & 1);
            const int row = (e & 2) ? row1 : row0;
            const bool ok = key >= w.start && key <= row && key < T &&
                            (window <= 0 || key > row - window);
            x = ok ? x : -INFINITY;
          }
          sc[e] = x;
          if (e & 2) mx1 = fmaxf(mx1, x);
          else mx0 = fmaxf(mx0, x);
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_MASK, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_MASK, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_MASK, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_MASK, mx1, 2));
        const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
        // a row with no live key yet keeps m = -inf; exponentiate against 0
        const float u0 = n0 == -INFINITY ? 0.f : n0;
        const float u1 = n1 == -INFINITY ? 0.f : n1;
        const float cr0 = ex2(m0 - u0), cr1 = ex2(m1 - u1);
        m0 = n0;
        m1 = n1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          const float p = ex2(sc[e] - ((e & 2) ? u1 : u0));
          sc[e] = p;
          if (e & 2) ps1 += p;
          else ps0 += p;
        }
        l0 = l0 * cr0 + ps0;   // per-thread partial; summed over the quad at the end
        l1 = l1 * cr1 + ps1;
#pragma unroll
        for (int e = 0; e < 64; ++e) o[e] *= (e & 2) ? cr1 : cr0;
        uint32_t pa[8][4];
        p_frags(sc, pa);
        pv_product(o, pa, base + SM_V + s * SM_KV_TILE);
        mbar_arrive(bar + 16 + 8 * s);   // the stage's K and V are read
      }
      ++qi;
      l0 += __shfl_xor_sync(FULL_MASK, l0, 1);
      l0 += __shfl_xor_sync(FULL_MASK, l0, 2);
      l1 += __shfl_xor_sync(FULL_MASK, l1, 1);
      l1 += __shfl_xor_sync(FULL_MASK, l1, 2);
      // rows that saw no key (left padding) have l == 0: write zeros
      const float i0f = l0 > 0.f ? 1.f / l0 : 0.f;
      const float i1f = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (row0 < T)
          *reinterpret_cast<uint32_t*>(out0 + 8 * j + c2) =
              pack_bf16(o[4 * j] * i0f, o[4 * j + 1] * i0f);
        if (row1 < T)
          *reinterpret_cast<uint32_t*>(out1 + 8 * j + c2) =
              pack_bf16(o[4 * j + 2] * i1f, o[4 * j + 3] * i1f);
      }
    }
  }
}

namespace {

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so the library links without -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// The TMA map of a (B, T, H, D = 128) bf16 view with element strides (sb, st,
// sh, 1), as the 4-D tensor (D, H, T, B) with the view's own byte strides;
// boxes of 64 columns x 1 head x `rows` positions, 128-byte swizzle; reads
// past T fill zeros.
bool make_map(CUtensorMap* m, const bf16* ptr, int B, int T, int H, long long sb, long long st,
              long long sh, int rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {FP_D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {FP_BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(ptr), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

bool make_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv, int B, int T, int Hq, int Hkv,
               const bf16* q, const bf16* k, const bf16* v, const long long* s) {
  return make_map(tq, q, B, T, Hq, s[0], s[1], s[2], FP_BQ) &&
         make_map(tk, k, B, T, Hkv, s[3], s[4], s[5], FP_BK) &&
         make_map(tv, v, B, T, Hkv, s[6], s[7], s[8], FP_BK);
}

}  // namespace

// Shapes the wrapper has checked: D = FP_D, Hq = FP_G * Hkv, the views'
// strides in whole 16 bytes.
extern "C" int qt_flash_prefill(const FlashPrefillArgs* a, void* stream) {
  if (a->D != FP_D || a->Hq != FP_G * a->Hkv || a->grid < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_maps(&tq, &tk, &tv, a->B, a->T, a->Hq, a->Hkv, a->q, a->k, a->v, &a->sqb))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(k_flash_prefill, cudaFuncAttributeMaxDynamicSharedMemorySize, SM_BYTES);
  LAUNCH_CHECK();
  k_flash_prefill<<<a->grid, FP_THREADS, SM_BYTES, (cudaStream_t)stream>>>(tq, tk, tv, *a);
  LAUNCH_CHECK();
  return 0;
}

// The kernel's two products alone, for an on-card check of the TMA maps,
// the descriptors and the fragment layouts: one warpgroup loads, by TMA from
// the given strided views, the Q tile of query head hq (64 positions from
// q_lo) and the K and V tiles of its kv head (128 keys from k0) of batch row
// b; then s = Q K^T (64 x 128 f32) and o = bf16(s) V (64 x 128 f32), both
// through the kernel's own s_product, p_frags and pv_product.
struct FlashProbeArgs {
  int B, T, Hq, Hkv, b, hq, q_lo, k0;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh;
  const bf16* q;
  const bf16* k;
  const bf16* v;
  float* s;   // (64, 128)
  float* o;   // (64, 128)
};

constexpr uint32_t PROBE_BYTES = SM_Q_HEAD + 2 * SM_KV_TILE + 64 + 1024;

__global__ void __launch_bounds__(128, 1)
    k_flash_probe(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const FlashProbeArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qt = base, kt = base + SM_Q_HEAD, vt = kt + SM_KV_TILE;
  const uint32_t bar = vt + SM_KV_TILE;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, SM_Q_HEAD + 2 * SM_KV_TILE);
    tma_rows(qt, SM_Q_HALF, &tq, bar, a.hq, a.q_lo, a.b);
    tma_rows(kt, SM_KV_HALF, &tk, bar, a.hq / FP_G, a.k0, a.b);
    tma_rows(vt, SM_KV_HALF, &tv, bar, a.hq / FP_G, a.k0, a.b);
  }
  mbar_wait(bar, 0);
  float s[64], o[64];
  s_product(s, qt, kt);
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = 16 * warp + (lane >> 2), c2 = 2 * (lane & 3);
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    a.s[(r0 + ((e & 2) ? 8 : 0)) * FP_BK + 8 * (e >> 2) + c2 + (e & 1)] = s[e];
    o[e] = 0.f;
  }
  uint32_t pa[8][4];
  p_frags(s, pa);
  pv_product(o, pa, vt);
#pragma unroll
  for (int e = 0; e < 64; ++e)
    a.o[(r0 + ((e & 2) ? 8 : 0)) * FP_D + 8 * (e >> 2) + c2 + (e & 1)] = o[e];
}

extern "C" int qt_flash_probe(const FlashProbeArgs* a, void* stream) {
  if (a->Hq != FP_G * a->Hkv) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_maps(&tq, &tk, &tv, a->B, a->T, a->Hq, a->Hkv, a->q, a->k, a->v, &a->sqb))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(k_flash_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, PROBE_BYTES);
  LAUNCH_CHECK();
  k_flash_probe<<<1, 128, PROBE_BYTES, (cudaStream_t)stream>>>(tq, tk, tv, *a);
  LAUNCH_CHECK();
  return 0;
}
