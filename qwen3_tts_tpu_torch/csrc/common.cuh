// Building blocks shared by the two W8A8 decode kernels (talker_step.cu and
// subtalker.cu): a row RMSNorm + per-row int8 activation quantiser, a W8A8
// GEMM for small row counts, QK-RMSNorm + RoPE with the KV-slot write, a
// GQA decode attention over a bf16 or an int8 cache, SiLU(gate)*up with
// quantisation, and the host function that chains them into one decoder
// layer.
//
// Numerics follow the JAX reference twins (ops/pallas/subtalker.py
// `subtalker_frame_ref`, ops/pallas/talker_step.py `talker_step_ref`):
//   * activations are quantised per row as q = clip(rint(x / s), +-127) with
//     s = max(amax / 127, 1e-12) and an IEEE division (not a reciprocal);
//   * int8 x int8 products accumulate exactly in int32 (dp4a), and the
//     epilogue is (float(acc) * s_row) * s_col;
//   * values round to bf16 at the reference's points (matmul outputs before
//     each residual add, q/k after RoPE, v, softmax weights);
//   * an int8 KV slot is the JAX `kv_quantize` of the bf16 K/V row over D:
//     s = max(amax, 1e-8) / 127 (IEEE division), q = clip(rint(x / s), +-127).
// The library is compiled with --fmad=false so that a*b+c is not contracted
// into an FMA the reference does not have.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

typedef __nv_bfloat16 bf16;

#define NEG_INF_F (-3.402823466e+38f)   // float32 min, the reference's mask value
#define FULL_MASK 0xffffffffu
#define LAUNCH_CHECK()                                   \
  do {                                                   \
    cudaError_t e_ = cudaGetLastError();                 \
    if (e_ != cudaSuccess) return (int)e_;               \
  } while (0)

static __device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
static __device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
static __device__ __forceinline__ float to_f(float x) { return x; }
static __device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
static __device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Block-wide sum or max; every thread gets the result. blockDim.x must be a
// multiple of 32; `red` is 32 floats of shared memory.
template <bool MAX>
static __device__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float w = __shfl_xor_sync(FULL_MASK, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  __syncthreads();  // a previous call may still be reading red
  if (lane == 0) red[wid] = v;
  __syncthreads();
  v = lane < nw ? red[lane] : (MAX ? -INFINITY : 0.f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float w = __shfl_xor_sync(FULL_MASK, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  return v;
}

static __device__ __forceinline__ int8_t quant_one(float v, float s) {
  float q = rintf(v / s);
  return (int8_t)fminf(fmaxf(q, -127.f), 127.f);
}

// One block per row of x (bf16, H wide). With w: y = bf16(rms(x) * w); without
// w: y = x. Writes any of: the f32 normed row before rounding (outf), the bf16
// row (outb), the row's int8 quantisation (xq, xs). Dynamic smem: H floats.
static __global__ void k_row_norm(const bf16* __restrict__ x, int ldx,
                                  const float* __restrict__ w, float eps, int H,
                                  int8_t* xq, int ldq, float* xs, float* outf,
                                  bf16* outb, int ldo) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const int r = blockIdx.x;
  const bf16* xr = x + (size_t)r * ldx;
  float ss = 0.f;
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    float v = bf(xr[j]);
    row[j] = v;
    ss += v * v;
  }
  float rinv = 1.f;
  if (w) {
    ss = block_reduce<false>(ss, red);
    rinv = 1.f / sqrtf(ss / (float)H + eps);
  }
  float amax = 0.f;
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    float y = row[j];
    if (w) y = (y * rinv) * w[j];
    if (outf) outf[(size_t)r * ldo + j] = y;
    if (outb) outb[(size_t)r * ldo + j] = __float2bfloat16_rn(y);
    y = bf16r(y);
    row[j] = y;  // only this thread reads it back
    amax = fmaxf(amax, fabsf(y));
  }
  if (!xq) return;
  amax = block_reduce<true>(amax, red);
  const float s = fmaxf(amax / 127.f, 1e-12f);
  if (threadIdx.x == 0) xs[r] = s;
  for (int j = threadIdx.x; j < H; j += blockDim.x)
    xq[(size_t)r * ldq + j] = quant_one(row[j], s);
}

// W8A8 GEMM for few rows: out[r, n] = (float(sum_k xq[r,k] wq[n,k]) * xs[r]) * ws[n].
// One warp per output column n, lanes stride K in 16-byte vectors (dp4a).
// K is split into nseg equal segments, each with its own activation scale
// xs[r, c]; mode 0 writes f32, mode 1 writes bf16, mode 2 adds into the bf16
// residual: out = bf16(out + bf16(y_c)) for c = 0, 1, ... in order (the talker
// step's chunked down projection). nseg > 1 needs mode 2.
template <int RB>
static __global__ void k_w8a8(const int8_t* __restrict__ xq, int ldx,
                              const float* __restrict__ xs, int nseg, int R,
                              int K, const int8_t* __restrict__ wq, int ldw,
                              const float* __restrict__ ws, int N, int mode,
                              float* outf, bf16* outb, int ldo) {
  const int n = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (n >= N) return;
  const int seg = K / nseg;
  const int8_t* wrow = wq + (size_t)n * ldw;
  const float wsn = ws[n];
  for (int c = 0; c < nseg; ++c) {
    for (int r0 = 0; r0 < R; r0 += RB) {
      int acc[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) acc[i] = 0;
      for (int k = lane * 16; k < seg; k += 32 * 16) {
        const int4 w4 = *reinterpret_cast<const int4*>(wrow + c * seg + k);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          if (r0 + i < R) {
            const int4 x4 = *reinterpret_cast<const int4*>(
                xq + (size_t)(r0 + i) * ldx + c * seg + k);
            acc[i] = __dp4a(x4.x, w4.x, acc[i]);
            acc[i] = __dp4a(x4.y, w4.y, acc[i]);
            acc[i] = __dp4a(x4.z, w4.z, acc[i]);
            acc[i] = __dp4a(x4.w, w4.w, acc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc[i] += __shfl_xor_sync(FULL_MASK, acc[i], o);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = r0 + i;
        if (lane == i && r < R) {
          const float y = ((float)acc[i] * xs[(size_t)r * nseg + c]) * wsn;
          const size_t o = (size_t)r * ldo + n;
          if (mode == 0)
            outf[o] = y;
          else if (mode == 1)
            outb[o] = __float2bfloat16_rn(y);
          else
            outb[o] = __float2bfloat16_rn(bf(outb[o]) + bf16r(y));
        }
      }
    }
  }
}

// One layer's KV cache. A bf16 cache: kc/vc are bf16 (B, kvh, S_buf, D) and
// ks is NULL. An int8 cache: kc/vc are int8, ks/vs the f32 (B, kvh, S_buf)
// scale planes, and knew/vnew (B, kvh, D) bf16 receive the fresh unquantized
// K/V that the attention folds in at finalize.
struct KVPtrs {
  void *kc, *vc;
  float *ks, *vs;
  bf16 *knew, *vnew;
};

static inline KVPtrs kv_layer(const KVPtrs& kv, int li, size_t layer_slots, int D) {
  const size_t elem = kv.ks ? 1 : sizeof(bf16);
  KVPtrs o = kv;
  o.kc = (char*)kv.kc + li * layer_slots * D * elem;
  o.vc = (char*)kv.vc + li * layer_slots * D * elem;
  if (kv.ks) {
    o.ks = kv.ks + li * layer_slots;
    o.vs = kv.vs + li * layer_slots;
  }
  return o;
}

// Store thread d's element of a fresh K or V row (cache row `row` = b*kvh+h)
// at slot sl. Block-wide in int8 mode (every thread of the block calls it):
// the row's scale needs its amax. A slot outside [0, S_buf) traps: the launch
// fails and the caller's next sync raises, as an out-of-range index does in
// a PyTorch CUDA kernel (a per-row slot tensor is not checked on the host,
// which would cost a sync per step).
static __device__ void store_kv(void* cache, float* scales, bf16* fresh, size_t row,
                                int S_buf, int sl, int D, int d, float val, bool active,
                                float* red) {
  if (sl < 0 || sl >= S_buf) __trap();
  const bf16 vb = __float2bfloat16_rn(val);
  if (!scales) {
    if (active) ((bf16*)cache)[(row * S_buf + sl) * D + d] = vb;
    return;
  }
  const float x = bf(vb);
  const float amax = block_reduce<true>(active ? fabsf(x) : 0.f, red);
  const float s = fmaxf(amax, 1e-8f) / 127.f;
  if (!active) return;
  fresh[row * D + d] = vb;
  ((int8_t*)cache)[(row * S_buf + sl) * D + d] = quant_one(x, s);
  if (d == 0) scales[row * S_buf + sl] = s;
}

// QK-RMSNorm + RoPE on the f32 qkv projection, and the cache write.
// grid (B, heads + 2*kvh), block 128 (D <= 128). Head ids [0, heads) are q
// (written to q_out), then kvh k heads, then kvh v heads, both stored into
// this layer's cache `kv` at slot[b] (or slot_const when slot is null): bf16,
// or int8 with their scales (and the bf16 row in kv.knew/vnew). cos/sin
// rows: row b at offset b*cs_ld (cs_ld 0 = shared).
static __global__ void k_qk_rope(const float* __restrict__ qkv, int ldqkv,
                                 int heads, int kvh, int D,
                                 const float* __restrict__ qn,
                                 const float* __restrict__ kn, float eps,
                                 const float* __restrict__ cosr,
                                 const float* __restrict__ sinr, int cs_ld,
                                 bf16* q_out, KVPtrs kv, int S_buf,
                                 const int* slot, int slot_const) {
  __shared__ float y_s[128];
  __shared__ float red[32];
  const int b = blockIdx.x, hid = blockIdx.y, d = threadIdx.x;
  const int nq = heads * D, nkv = kvh * D;
  const bool active = d < D;
  const int sl = slot ? slot[b] : slot_const;
  const float* src = qkv + (size_t)b * ldqkv;
  if (hid >= heads + kvh) {  // v: into the cache, no norm, no rope
    const int h = hid - heads - kvh;
    store_kv(kv.vc, kv.vs, kv.vnew, (size_t)b * kvh + h, S_buf, sl, D, d,
             active ? src[nq + nkv + h * D + d] : 0.f, active, red);
    return;
  }
  const bool is_q = hid < heads;
  const int off = is_q ? hid * D : nq + (hid - heads) * D;
  const float v = active ? src[off + d] : 0.f;
  const float ss = block_reduce<false>(v * v, red);
  const float* nw = is_q ? qn : kn;
  const float y = active ? (v * (1.f / sqrtf(ss / (float)D + eps))) * nw[d] : 0.f;
  if (active) y_s[d] = y;
  __syncthreads();
  const int half = D / 2;
  float o = 0.f;
  if (active) {
    const float rot = d < half ? -y_s[d + half] : y_s[d - half];
    o = y * cosr[(size_t)b * cs_ld + d] + rot * sinr[(size_t)b * cs_ld + d];
  }
  if (is_q) {
    if (active) q_out[(size_t)b * nq + hid * D + d] = __float2bfloat16_rn(o);
    return;
  }
  store_kv(kv.kc, kv.ks, kv.knew, (size_t)b * kvh + (hid - heads), S_buf, sl, D, d, o,
           active, red);
}

#define ATT_CHUNK 128
#define ATT_MAX_G 8

// GQA decode attention for one query position per row, one block per
// (row b, kv head h), ATT_CHUNK = 128 threads; G = heads / kvh query heads
// share the block's K/V. q head index = h * G + g. Per chunk, thread t scores
// slot c0 + t for all G heads (its K row in 16-byte loads, D % 8 == 0; int8:
// D % 16 == 0), then owns output column d = t for the P.V sum.
//
// Talker mode (sub_pos < 0): slots j < ci[b] with valid[b, j] (and inside the
// window) are attended as an online softmax over 128-slot chunks, exactly
// the reference's order of operations: per chunk m' = max(m, max s),
// e = bf16(exp(s - m')), l = l*exp(m - m') + sum e, acc = acc*exp(m - m') +
// e.v; then the fresh K/V of slot ci[b] is folded in: e_new = bf16(exp(s_new -
// m_tot)), o = (acc*corr + e_new*v_new) / (l*corr + e_new). Masked slots are
// skipped, which gives the reference's result: their weights are exactly 0,
// or (while no slot has been live) are wiped by a zero correction factor
// later. Q8 (int8 cache): s = (q . k_int8) * k_scale[j] * D^-0.5, the P.V
// weight is bf16(e * v_scale[j]) against v_int8 (l still sums e), and the
// fresh K/V comes from kv.knew/vnew in bf16 (the slot holds its int8 copy);
// a bf16 cache's fresh K/V is read back from slot ci[b]. The cache pointers
// stay typed and __restrict__ (not void*), so the compiler may route either
// element type's loads through the read-only data cache.
//
// Sub-talker mode (sub_pos >= 0, bf16 only): slots 0..sub_pos, one plain
// softmax p = bf16(exp(s - m) / sum exp(s - m)), o = sum p.v.
template <typename KV>  // bf16: a bf16 cache; int8_t: an int8 cache with scales
static __global__ void k_attn(const bf16* __restrict__ q, const KV* __restrict__ kc,
                              const KV* __restrict__ vc, const float* __restrict__ ks,
                              const float* __restrict__ vs,
                              const bf16* __restrict__ knew, const bf16* __restrict__ vnew,
                              int S_buf, int S_att,
                              int heads, int kvh, int D, float scale,
                              const int* __restrict__ ci,
                              const uint8_t* __restrict__ valid, int ld_valid,
                              int window, int sub_pos, bf16* out) {
  constexpr bool Q8 = sizeof(KV) == 1;
  __shared__ float qf[ATT_MAX_G][128];
  __shared__ float sc[ATT_MAX_G][ATT_CHUNK];
  __shared__ float red[32];
  const int b = blockIdx.x / kvh, h = blockIdx.x % kvh, G = heads / kvh;
  const int tid = threadIdx.x;
  const bool sub = sub_pos >= 0;
  for (int i = tid; i < G * D; i += blockDim.x)
    qf[i / D][i % D] = bf(q[(size_t)b * heads * D + (size_t)(h * G) * D + i]);
  const size_t row = (size_t)b * kvh + h;
  const KV* kb = kc + row * S_buf * D;
  const KV* vb = vc + row * S_buf * D;
  const float* ksb = Q8 ? ks + row * S_buf : nullptr;
  const float* vsb = Q8 ? vs + row * S_buf : nullptr;
  const int lim = sub ? sub_pos + 1 : S_att;
  const int cib = sub ? 0 : ci[b];
  float m[ATT_MAX_G], l[ATT_MAX_G], acc[ATT_MAX_G];
#pragma unroll
  for (int g = 0; g < ATT_MAX_G; ++g) {
    m[g] = NEG_INF_F;
    l[g] = 0.f;
    acc[g] = 0.f;
  }
  __syncthreads();
  for (int c0 = 0; c0 < lim; c0 += ATT_CHUNK) {
    const int cend = min(c0 + ATT_CHUNK, lim);
    float vsj = 0.f;  // Q8: this thread's slot's V scale
    {  // scores: thread tid owns slot c0 + tid and reads its K row in 16-byte vectors
      const int j = c0 + tid;
      bool ok = j < cend;
      if (ok && !sub)
        ok = j < cib && valid[(size_t)b * ld_valid + j] &&
             (window <= 0 || j > cib - window);
      float part[ATT_MAX_G];
#pragma unroll
      for (int g = 0; g < ATT_MAX_G; ++g) part[g] = 0.f;
      if (ok) {
        if constexpr (Q8) {
          const int4* krow = reinterpret_cast<const int4*>(kb + (size_t)j * D);
#pragma unroll 2
          for (int d16 = 0; d16 < D / 16; ++d16) {
            const int4 k4 = krow[d16];
            const int8_t* kv8 = reinterpret_cast<const int8_t*>(&k4);
#pragma unroll
            for (int e = 0; e < 16; ++e) {
              const float kf = (float)kv8[e];
#pragma unroll
              for (int g = 0; g < ATT_MAX_G; ++g)
                if (g < G) part[g] += qf[g][d16 * 16 + e] * kf;
            }
          }
          const float ksj = ksb[j];
#pragma unroll
          for (int g = 0; g < ATT_MAX_G; ++g) part[g] *= ksj;
          vsj = vsb[j];
        } else {
          const uint4* krow = reinterpret_cast<const uint4*>(kb + (size_t)j * D);
#pragma unroll 4
          for (int d8 = 0; d8 < D / 8; ++d8) {
            const uint4 k4 = krow[d8];
            const bf16* kv16 = reinterpret_cast<const bf16*>(&k4);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float kf = bf(kv16[e]);
#pragma unroll
              for (int g = 0; g < ATT_MAX_G; ++g)
                if (g < G) part[g] += qf[g][d8 * 8 + e] * kf;
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < ATT_MAX_G; ++g)
        if (g < G) sc[g][tid] = ok ? part[g] * scale : -INFINITY;
    }
    __syncthreads();
    float corr[ATT_MAX_G];
    bool live[ATT_MAX_G];
#pragma unroll
    for (int g = 0; g < ATT_MAX_G; ++g) {
      corr[g] = 1.f;
      live[g] = false;
      if (g >= G) continue;
      const float sv = sc[g][tid];
      const float cm = block_reduce<true>(sv, red);
      if (cm == -INFINITY) continue;  // block-uniform: nothing live here
      live[g] = true;
      if (sub) {
        const float p = sv == -INFINITY ? 0.f : expf(sv - cm);
        const float sum = block_reduce<false>(p, red);
        sc[g][tid] = bf16r(p / sum);
      } else {
        const float m_new = fmaxf(m[g], cm);
        corr[g] = expf(m[g] - m_new);
        const float e = sv == -INFINITY ? 0.f : bf16r(expf(sv - m_new));
        const float es = block_reduce<false>(e, red);
        l[g] = l[g] * corr[g] + es;
        m[g] = m_new;
        sc[g][tid] = Q8 ? bf16r(e * vsj) : e;
      }
    }
    __syncthreads();
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < ATT_MAX_G; ++g) {
        if (!live[g]) continue;
        float pv = 0.f;
        for (int t = 0; t < cend - c0; ++t)
          pv += sc[g][t] * to_f(vb[(size_t)(c0 + t) * D + tid]);
        acc[g] = sub ? pv : acc[g] * corr[g] + pv;
      }
    }
    __syncthreads();  // sc is rewritten by the next chunk
  }
  bf16* ob = out + (size_t)b * heads * D + (size_t)(h * G) * D;
  if (sub) {
#pragma unroll
    for (int g = 0; g < ATT_MAX_G; ++g)
      if (g < G && tid < D) ob[g * D + tid] = __float2bfloat16_rn(acc[g]);
    return;
  }
  const float kn_d = tid >= D ? 0.f
                              : Q8 ? bf(knew[row * D + tid]) : to_f(kb[(size_t)cib * D + tid]);
  const float vn_d = tid >= D ? 0.f
                              : Q8 ? bf(vnew[row * D + tid]) : to_f(vb[(size_t)cib * D + tid]);
#pragma unroll
  for (int g = 0; g < ATT_MAX_G; ++g) {
    if (g >= G) break;
    const float s_new =
        block_reduce<false>(tid < D ? qf[g][tid] * kn_d : 0.f, red) * scale;
    const float m_tot = fmaxf(m[g], s_new);
    const float c = expf(m[g] - m_tot);
    const float e_new = bf16r(expf(s_new - m_tot));
    const float den = l[g] * c + e_new;
    if (tid < D) ob[g * D + tid] = __float2bfloat16_rn((acc[g] * c + e_new * vn_d) / den);
  }
}

// SiLU(gate) * up on the bf16 gate|up row, rounded to bf16, then quantised
// per (row, segment): grid (R, nseg), each block owns inter/nseg columns.
static __global__ void k_silu_quant(const bf16* __restrict__ gu, int ldg,
                                    int inter, int nseg, int8_t* xq, float* xs) {
  __shared__ float red[32];
  const int r = blockIdx.x, c = blockIdx.y, seg = inter / nseg;
  const bf16* g = gu + (size_t)r * ldg + (size_t)c * seg;
  const bf16* u = g + inter;
  float amax = 0.f;
  for (int j = threadIdx.x; j < seg; j += blockDim.x) {
    const float gv = bf(g[j]);
    amax = fmaxf(amax, fabsf(bf16r((gv * (1.f / (1.f + expf(-gv)))) * bf(u[j]))));
  }
  amax = block_reduce<true>(amax, red);
  const float s = fmaxf(amax / 127.f, 1e-12f);
  if (threadIdx.x == 0) xs[(size_t)r * nseg + c] = s;
  for (int j = threadIdx.x; j < seg; j += blockDim.x) {
    const float gv = bf(g[j]);
    const float p = bf16r((gv * (1.f / (1.f + expf(-gv)))) * bf(u[j]));
    xq[(size_t)r * inter + (size_t)c * seg + j] = quant_one(p, s);
  }
}

// ---------------------------------------------------------------------------
// Host side: one decoder layer as a chain of the kernels above.
// ---------------------------------------------------------------------------

struct LayerWeights {  // one layer's slices of the stacked int8 tensors
  const int8_t *qkv_q, *o_q, *gu_q, *dn_q;
  const float *qkv_s, *o_s, *gu_s, *dn_s;
  const float *ln1, *ln2, *qn, *kn;  // norm weights, f32
};

struct LayerShape {
  int B, H, heads, kvh, D, inter, nseg, S_buf, S_att, window;
  float eps, scale;
};

struct LayerScratch {
  int8_t* xq;   // (B, max(H, heads*D, inter)) int8
  float* xs;    // (B, max(1, nseg))
  float* qkv;   // (B, (heads + 2 kvh) D) f32
  bf16* q;      // (B, heads D)
  bf16* o;      // (B, heads D)
  bf16* gu;     // (B, 2 inter)
};

static inline int w8a8_launch(const int8_t* xq, int ldx, const float* xs, int nseg,
                              int R, int K, const int8_t* wq, int ldw,
                              const float* ws, int N, int mode, float* outf,
                              bf16* outb, int ldo, cudaStream_t st) {
  const int warps = 8;
  k_w8a8<8><<<(N + warps - 1) / warps, warps * 32, 0, st>>>(
      xq, ldx, xs, nseg, R, K, wq, ldw, ws, N, mode, outf, outb, ldo);
  LAUNCH_CHECK();
  return 0;
}

static inline int row_norm_launch(const bf16* x, int ldx, const float* w, float eps,
                                  int H, int R, int8_t* xq, int ldq, float* xs,
                                  float* outf, bf16* outb, int ldo, cudaStream_t st) {
  k_row_norm<<<R, 256, H * sizeof(float), st>>>(x, ldx, w, eps, H, xq, ldq, xs,
                                                 outf, outb, ldo);
  LAUNCH_CHECK();
  return 0;
}

// x (B, H) bf16 is the residual stream, updated in place. kv is this
// layer's (B, kvh, S_buf, D) cache (bf16, or int8 with scales). Talker mode:
// slot/ci per row (ci), valid (B, ld_valid), sub_pos = -1. Sub-talker mode
// (bf16 cache): slot_const = sub_pos = the position, ci/valid unused.
static int run_layer(const LayerShape& s, const LayerWeights& w, bf16* x,
                     const float* cosr, const float* sinr, int cs_ld,
                     const KVPtrs& kv, const int* ci, const uint8_t* valid,
                     int ld_valid, int sub_pos, const LayerScratch& t,
                     cudaStream_t st) {
  const int nq = s.heads * s.D, nqkv = (s.heads + 2 * s.kvh) * s.D;
  int e;
  if ((e = row_norm_launch(x, s.H, w.ln1, s.eps, s.H, s.B, t.xq, s.H, t.xs,
                           nullptr, nullptr, 0, st)))
    return e;
  if ((e = w8a8_launch(t.xq, s.H, t.xs, 1, s.B, s.H, w.qkv_q, s.H, w.qkv_s, nqkv,
                       0, t.qkv, nullptr, nqkv, st)))
    return e;
  k_qk_rope<<<dim3(s.B, s.heads + 2 * s.kvh), 128, 0, st>>>(
      t.qkv, nqkv, s.heads, s.kvh, s.D, w.qn, w.kn, s.eps, cosr, sinr, cs_ld,
      t.q, kv, s.S_buf, sub_pos >= 0 ? nullptr : ci, sub_pos);
  LAUNCH_CHECK();
  if (kv.ks)
    k_attn<int8_t><<<s.B * s.kvh, ATT_CHUNK, 0, st>>>(
        t.q, (const int8_t*)kv.kc, (const int8_t*)kv.vc, kv.ks, kv.vs, kv.knew, kv.vnew,
        s.S_buf, s.S_att, s.heads, s.kvh, s.D, s.scale, ci, valid, ld_valid, s.window,
        sub_pos, t.o);
  else
    k_attn<bf16><<<s.B * s.kvh, ATT_CHUNK, 0, st>>>(
        t.q, (const bf16*)kv.kc, (const bf16*)kv.vc, nullptr, nullptr, nullptr, nullptr,
        s.S_buf, s.S_att, s.heads, s.kvh, s.D, s.scale, ci, valid, ld_valid, s.window,
        sub_pos, t.o);
  LAUNCH_CHECK();
  if ((e = row_norm_launch(t.o, nq, nullptr, 0.f, nq, s.B, t.xq, nq, t.xs, nullptr,
                           nullptr, 0, st)))
    return e;
  if ((e = w8a8_launch(t.xq, nq, t.xs, 1, s.B, nq, w.o_q, nq, w.o_s, s.H, 2,
                       nullptr, x, s.H, st)))
    return e;
  if ((e = row_norm_launch(x, s.H, w.ln2, s.eps, s.H, s.B, t.xq, s.H, t.xs,
                           nullptr, nullptr, 0, st)))
    return e;
  if ((e = w8a8_launch(t.xq, s.H, t.xs, 1, s.B, s.H, w.gu_q, s.H, w.gu_s,
                       2 * s.inter, 1, nullptr, t.gu, 2 * s.inter, st)))
    return e;
  k_silu_quant<<<dim3(s.B, s.nseg), 256, 0, st>>>(t.gu, 2 * s.inter, s.inter,
                                                   s.nseg, t.xq, t.xs);
  LAUNCH_CHECK();
  return w8a8_launch(t.xq, s.inter, t.xs, s.nseg, s.B, s.inter, w.dn_q, s.inter,
                     w.dn_s, s.H, 2, nullptr, x, s.H, st);
}

static LayerWeights layer_slice(const LayerWeights& w, int li, int H, int heads,
                                int kvh, int D, int inter) {
  const size_t nq = (size_t)heads * D, nqkv = (size_t)(heads + 2 * kvh) * D;
  LayerWeights o;
  o.qkv_q = w.qkv_q + li * nqkv * H;
  o.qkv_s = w.qkv_s + li * nqkv;
  o.o_q = w.o_q + li * (size_t)H * nq;
  o.o_s = w.o_s + li * (size_t)H;
  o.gu_q = w.gu_q + li * (size_t)2 * inter * H;
  o.gu_s = w.gu_s + li * (size_t)2 * inter;
  o.dn_q = w.dn_q + li * (size_t)H * inter;
  o.dn_s = w.dn_s + li * (size_t)H;
  o.ln1 = w.ln1 + li * (size_t)H;
  o.ln2 = w.ln2 + li * (size_t)H;
  o.qn = w.qn + li * (size_t)D;
  o.kn = w.kn + li * (size_t)D;
  return o;
}
