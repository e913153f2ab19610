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
// compute-bound; the dense plain path instead writes and re-reads a
// (B, Hq, T, T) fp32 score tensor (1 GB at these shapes).
//
// What this first design does about it:
//   * one block per (query tile, kv head, batch row), looping over the KV
//     tiles inside the block (the TPU grid's sequential KV axis). The block
//     holds all G query heads of its kv head (128 query rows: BQ = 128 / G
//     positions x G heads), so every K/V tile staged in shared memory serves
//     G heads;
//   * only live tiles are visited: from max(start, q_lo - window + 1) to the
//     causal diagonal (the TPU kernel's block skip), and a warp whose 16 rows
//     a tile cannot reach skips its products; the ragged end of T is masked
//     here (keys past T load as zeros), so the wrapper pads nothing;
//   * QK^T and PV run on the tensor cores as mma.sync m16n8k16 bf16 with fp32
//     accumulation; K and V fragments come from shared memory by ldmatrix
//     (V transposed), P stays in registers between the two products (the
//     score accumulator's layout is the next product's A fragment);
//   * K/V tiles are double-buffered with cp.async, so the next tile loads
//     while this one computes; rows are padded by 8 bf16 so ldmatrix is free
//     of bank conflicts;
//   * the heaviest query tiles (near the end of T) are scheduled first.
// Not yet: wgmma, TMA, warp specialisation, a persistent grid. Those are the
// later steps towards the bound.
//
// Inputs are (B, T, H, D) views with element strides given per axis; the
// last axis must be contiguous and every row 16-byte aligned (the wrapper
// checks, and makes a contiguous copy otherwise).
//
// Built for the one shape the released configurations (1.7B and 0.6B) use
// and the on-card check holds against the twin: D = 128, G = Hq / Hkv = 2.
// Another width gets its own instantiation and its own on-card case.
#include "common.cuh"

namespace {

constexpr int FP_ROWS = 128;    // query rows (positions x heads) per block
constexpr int FP_BK = 64;       // keys per KV tile
constexpr int FP_THREADS = 256; // 8 warps x 16 rows
constexpr int FP_PAD = 8;       // bf16 of row padding in shared memory
constexpr int FP_D = 128;       // head dim
constexpr int FP_G = 2;         // query heads per kv head

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
// cp_async_commit and cp_async_wait<N> come from common.cuh

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace

struct FlashPrefillArgs {
  int B, T, Hq, Hkv, D, window;  // window 0 = none
  float scale;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh;  // element strides
  const bf16* q;       // (B, T, Hq, D) view, last axis contiguous
  const bf16* k;       // (B, T, Hkv, D) view
  const bf16* v;       // (B, T, Hkv, D) view
  const int* start;    // (B,) first valid slot per row
  bf16* out;           // (B, T, Hq, D) contiguous
};

__global__ void __launch_bounds__(FP_THREADS, 1)
    k_flash_prefill(const FlashPrefillArgs a) {
  constexpr int D = FP_D, G = FP_G;
  constexpr int LD = D + FP_PAD;        // shared row stride, bf16
  constexpr int KT = D / 16;            // k-steps over the head dim
  constexpr int NT = FP_BK / 8;         // score n-tiles per KV tile
  constexpr int DT = D / 8;             // output n-tiles
  constexpr int TILE = FP_BK * LD;      // bf16 per K (or V) tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);  // [stage][K, V][BK][LD]

  constexpr int BQ = FP_ROWS / G;                   // positions per block
  const int qt = gridDim.x - 1 - blockIdx.x;        // heaviest tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q_lo = qt * BQ;
  const int T = a.T, start = a.start[b], window = a.window;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  constexpr int warps_per_head = BQ / 16;
  const int gi = warp / warps_per_head;
  const int hq = hk * G + gi;
  const int r_lo = q_lo + (warp % warps_per_head) * 16;  // this warp's 16 rows
  const int r_hi = r_lo + 15;
  const int row0 = r_lo + g, row1 = r_lo + g + 8;

  // this warp's Q fragments (A operand, row-major 16 x D), straight from
  // global memory; rows past T are zeros
  uint32_t qa[KT][4];
  {
    const bf16* q0 = a.q + b * a.sqb + (long long)row0 * a.sqt + hq * a.sqh;
    const bf16* q1 = a.q + b * a.sqb + (long long)row1 * a.sqt + hq * a.sqh;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = row0 < T ? *reinterpret_cast<const uint32_t*>(q0 + c) : 0u;
      qa[kk][1] = row1 < T ? *reinterpret_cast<const uint32_t*>(q1 + c) : 0u;
      qa[kk][2] = row0 < T ? *reinterpret_cast<const uint32_t*>(q0 + c + 8) : 0u;
      qa[kk][3] = row1 < T ? *reinterpret_cast<const uint32_t*>(q1 + c + 8) : 0u;
    }
  }

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float sl2 = a.scale * 1.4426950408889634f;  // scores in log2 units

  // live keys of the block: [k_first, k_last]
  int k_first = start;
  if (window > 0) k_first = max(k_first, q_lo - window + 1);
  k_first = max(k_first, 0);
  const int k_last = min(q_lo + BQ, T) - 1;
  const int t0 = k_first / FP_BK;
  const int ntiles = k_first <= k_last ? k_last / FP_BK - t0 + 1 : 0;

  const bf16* kbase = a.k + b * a.skb + hk * a.skh;
  const bf16* vbase = a.v + b * a.svb + hk * a.svh;
  auto load_tile = [&](int stage, int k0) {
    bf16* ks = smem + stage * 2 * TILE;
    bf16* vs = ks + TILE;
    constexpr int CHUNKS = FP_BK * (D / 8);  // 16-byte chunks per tile
    for (int c = tid; c < CHUNKS; c += FP_THREADS) {
      const int r = c / (D / 8), col = (c % (D / 8)) * 8;
      const int key = k0 + r;
      const bool ok = key < T;
      const long long kr = ok ? key : 0;
      cp_async16((unsigned)__cvta_generic_to_shared(ks + r * LD + col),
                 kbase + kr * a.skt + col, ok ? 16 : 0);
      cp_async16((unsigned)__cvta_generic_to_shared(vs + r * LD + col),
                 vbase + kr * a.svt + col, ok ? 16 : 0);
    }
  };

  if (ntiles > 0) {
    load_tile(0, t0 * FP_BK);
    cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_tile((it + 1) & 1, (t0 + it + 1) * FP_BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int k0 = (t0 + it) * FP_BK;
    // can any of this warp's rows see a key of this tile? (causally the last
    // row sees the latest keys, through the window the first row the
    // earliest)
    const bool live = max(k0, start) <= r_hi &&
                      (window <= 0 || k0 + FP_BK - 1 > r_lo - window);
    if (live) {
      const bf16* ks = smem + (it & 1) * 2 * TILE;
      const bf16* vs = ks + TILE;
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const int mrow = lane & 7, mat = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t kb[4];
          const bf16* ptr = ks + (16 * p + (mat >> 1) * 8 + mrow) * LD + kk * 16 + (mat & 1) * 8;
          ldmatrix_x4(kb, (unsigned)__cvta_generic_to_shared(ptr));
          mma_bf16(s[2 * p], qa[kk], kb[0], kb[1]);
          mma_bf16(s[2 * p + 1], qa[kk], kb[2], kb[3]);
        }
      }
      // mask only where the tile is not wholly valid for every row
      const bool full = k0 >= start && k0 + FP_BK - 1 <= r_lo && k0 + FP_BK <= T &&
                        (window <= 0 || k0 > r_hi - window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * sl2;
          if (!full) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const int row = e < 2 ? row0 : row1;
            const bool ok = key >= start && key <= row && key < T &&
                            (window <= 0 || key > row - window);
            x = ok ? x : -INFINITY;
          }
          s[j][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_MASK, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_MASK, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_MASK, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_MASK, mx1, 2));
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      // a row with no live key yet keeps m = -inf; exponentiate against 0
      const float u0 = n0 == -INFINITY ? 0.f : n0;
      const float u1 = n1 == -INFINITY ? 0.f : n1;
      const float c0 = exp2f(m0 - u0), c1 = exp2f(m1 - u1);
      m0 = n0;
      m1 = n1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = exp2f(s[j][0] - u0);
        s[j][1] = exp2f(s[j][1] - u0);
        s[j][2] = exp2f(s[j][2] - u1);
        s[j][3] = exp2f(s[j][3] - u1);
        ps0 += s[j][0] + s[j][1];
        ps1 += s[j][2] + s[j][3];
      }
      l0 = l0 * c0 + ps0;  // per-thread partial; summed over the quad at the end
      l1 = l1 * c1 + ps1;
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        o[i][0] *= c0;
        o[i][1] *= c0;
        o[i][2] *= c1;
        o[i][3] *= c1;
      }
#pragma unroll
      for (int c = 0; c < FP_BK / 16; ++c) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
        pa[1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
        pa[2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
        pa[3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
        for (int qd = 0; qd < D / 16; ++qd) {
          uint32_t vb[4];
          const bf16* ptr = vs + (16 * c + (mat & 1) * 8 + mrow) * LD + qd * 16 + (mat >> 1) * 8;
          ldmatrix_x4_trans(vb, (unsigned)__cvta_generic_to_shared(ptr));
          mma_bf16(o[2 * qd], pa, vb[0], vb[1]);
          mma_bf16(o[2 * qd + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // the stage is overwritten by the next prefetch
  }

  l0 += __shfl_xor_sync(FULL_MASK, l0, 1);
  l0 += __shfl_xor_sync(FULL_MASK, l0, 2);
  l1 += __shfl_xor_sync(FULL_MASK, l1, 1);
  l1 += __shfl_xor_sync(FULL_MASK, l1, 2);
  // rows that saw no key (left padding) have l == 0: write zeros
  const float i0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float i1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const long long ost = (long long)a.Hq * D;
  bf16* out0 = a.out + ((long long)b * T + row0) * ost + hq * D;
  bf16* out1 = a.out + ((long long)b * T + row1) * ost + hq * D;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int c = i * 8 + 2 * t;
    if (row0 < T) *reinterpret_cast<uint32_t*>(out0 + c) = pack_bf16(o[i][0] * i0, o[i][1] * i0);
    if (row1 < T) *reinterpret_cast<uint32_t*>(out1 + c) = pack_bf16(o[i][2] * i1, o[i][3] * i1);
  }
}

// Shapes the wrapper has checked: D = FP_D, Hq = FP_G * Hkv.
extern "C" int qt_flash_prefill(const FlashPrefillArgs* a, void* stream) {
  if (a->D != FP_D || a->Hq != FP_G * a->Hkv) return (int)cudaErrorInvalidValue;
  const int smem = 2 * 2 * FP_BK * (FP_D + FP_PAD) * (int)sizeof(bf16);
  cudaFuncSetAttribute(k_flash_prefill, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  LAUNCH_CHECK();
  constexpr int BQ = FP_ROWS / FP_G;
  dim3 grid((a->T + BQ - 1) / BQ, a->Hkv, a->B);
  k_flash_prefill<<<grid, FP_THREADS, smem, (cudaStream_t)stream>>>(*a);
  LAUNCH_CHECK();
  return 0;
}
