// One whole sub-talker (code predictor) frame as ONE persistent kernel: 16
// positions (2 prefill + 14 steps) through the 5-layer W8A8 code predictor
// on the layer engine of common.cuh, with per-step lm head, temperature,
// exact top-k, Gumbel-max sampling and the embedding gather.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/subtalker.py
// `subtalker_frame_fused` (kernel body `_subtalker_kernel`); its plain twin
// is `subtalker_frame_ref` in qwen3_tts_tpu_torch/ops/cuda/subtalker.py.
//
// What bounds it on the H100: bytes. Counting each input byte once, a frame
// needs the ~78 MB of int8 layer weights (qkv 4096x1024, o 1024x2048,
// gate_up 6144x1024, down 1024x3072, 5 layers), the 15 bf16 lm heads (63
// MB) and the projection (4 MB): ~0.044 ms at 3.35 TB/s for B=8. The 15
// dependent steps (sample -> embed -> next position) serialise the frame,
// and the weights fit neither in shared memory (~30 MB over all SMs) nor in
// the 50 MB L2 with the heads, so each position streams them again: ~1.3 GB
// a frame (~0.4 ms), nothing resident across positions. The TPU kernel's
// design (all weights resident in 128 MB of VMEM for the frame) does not
// carry over.
//
// What the design does about it: one cooperative launch per frame, one
// block per SM. A position is the projection (bf16 weights through the same
// cp.async ring as the int8 ones, on the bf16 tensor cores), five engine
// layers of nine stages each (the attention over <= 16 slots folded into
// stage (ii)), and per step the final norm recomputed by every block in
// front of its lm-head columns (the f32 rows as three bf16 terms, so the
// products are the f32 row's), then the sampling: one block per row keeps
// the logits row in shared memory, finds the exact k-th value with the
// reference's 32-step bit search, adds the caller's Gumbel noise, takes the
// lowest-index argmax and gathers the sampled embedding row into the next
// position's input and the running bf16 emb_sum, while the other blocks
// wait at the barrier. ~770 grid barriers a frame at ~1 us each, which is
// what bounds it: a layer's stages take ~45 us where its weights take 4.5.
// The frame never returns to the host.
#include "common.cuh"

static __device__ __forceinline__ int order_key(float v) {
  // monotone int32 image of a float (radix-sort trick, signed)
  const int bits = __float_as_int(v);
  return bits >= 0 ? bits : (~bits) ^ (int)0x80000000;
}

// Sampling for one step of row b by one block. Greedy (do_sample 0): argmax
// of the logits. Sampled: lt = logits / temp[b]; for 0 < k < V mask lt < kth
// (kth = the exact k-th largest value); add the Gumbel row; argmax. Ties go
// to the lowest index, as jnp.argmax does. Then gather the embedding row of
// the code into xraw and add it into emb_sum (bf16). lt: V floats of shared
// memory.
static __device__ __noinline__ void sample_row(int b, const float* logits, int V, int do_sample,
                                  const float* __restrict__ temp,
                                  const int* __restrict__ topk,
                                  const float* __restrict__ gumbel,
                                  const bf16* __restrict__ table, int Ht, int* codes, int Qm1,
                                  int col, bf16* xraw, bf16* emb_sum, float* lt, EngMisc* mi) {
  const int tid = threadIdx.x;
  const float* lr = logits + (size_t)b * V;
  const float tb = do_sample ? temp[b] : 1.f;
  for (int j = tid * 4; j < V; j += blockDim.x * 4) {   // V % 4 == 0
    float4 v = __ldcg(reinterpret_cast<const float4*>(lr + j));
    if (do_sample) {
      v.x = v.x / tb;
      v.y = v.y / tb;
      v.z = v.z / tb;
      v.w = v.w / tb;
    }
    *reinterpret_cast<float4*>(lt + j) = v;
  }
  __syncthreads();
  if (do_sample) {
    const int k = topk[b];
    if (k > 0 && k < V) {
      // largest t with count(key >= t) >= k: exactly the k-th largest key.
      // One barrier a step: the warps' counts meet in one of three counters,
      // and a step clears the one the next step will use (last read two
      // barriers ago).
      int lo = INT_MIN, hi = INT_MAX;
      if (tid < 3) mi->redi[tid] = 0;
      __syncthreads();
      for (int it = 0; it < 32; ++it) {
        const int mid = (lo >> 1) + (hi >> 1) + ((lo | hi) & 1);
        unsigned c = 0;
        for (int j = tid; j < V; j += blockDim.x) c += order_key(lt[j]) >= mid ? 1u : 0u;
        c = __reduce_add_sync(FULL_MASK, c);
        if ((tid & 31) == 0 && c) atomicAdd(&mi->redi[it % 3], (int)c);
        if (tid == 0) mi->redi[(it + 1) % 3] = 0;
        __syncthreads();
        if (mi->redi[it % 3] >= k) lo = mid; else hi = mid - 1;
      }
      const float kth = __int_as_float(lo >= 0 ? lo : ~(lo ^ (int)0x80000000));
      __syncthreads();
      for (int j = tid; j < V; j += blockDim.x)
        if (lt[j] < kth) lt[j] = NEG_INF_F;
    }
    const float* gr = gumbel + (size_t)b * V;
    __syncthreads();   // four neighbours' masked values: another thread wrote them
    for (int j = tid * 4; j < V; j += blockDim.x * 4) {
      const float4 g4 = *reinterpret_cast<const float4*>(gr + j);
      float4 v = *reinterpret_cast<float4*>(lt + j);
      v.x = v.x + g4.x;
      v.y = v.y + g4.y;
      v.z = v.z + g4.z;
      v.w = v.w + g4.w;
      *reinterpret_cast<float4*>(lt + j) = v;
    }
    __syncthreads();
  }
  float best = -INFINITY;
  int bi = INT_MAX;
  for (int j = tid; j < V; j += blockDim.x)
    if (lt[j] > best) { best = lt[j]; bi = j; }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL_MASK, best, o);
    const int oi = __shfl_xor_sync(FULL_MASK, bi, o);
    if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
  }
  const int lane = tid & 31, wid = tid >> 5, nw = blockDim.x >> 5;
  __syncthreads();   // red may still be read by the search's last reduce
  if (lane == 0) { mi->red[wid] = best; mi->redi[wid] = bi; }
  __syncthreads();
  if (tid == 0) {
    for (int i = 1; i < nw; ++i)
      if (mi->red[i] > best || (mi->red[i] == best && mi->redi[i] < bi)) {
        best = mi->red[i];
        bi = mi->redi[i];
      }
    // best/bi of thread 0 already hold warp 0's result
    mi->code = bi;
    codes[(size_t)b * Qm1 + col] = bi;
  }
  __syncthreads();
  const bf16* row = table + (size_t)mi->code * Ht;
  for (int j = tid * 4; j < Ht; j += blockDim.x * 4) {   // Ht % 4 == 0
    const size_t o = (size_t)b * Ht + j;
    const uint2 r4 = *reinterpret_cast<const uint2*>(row + j);
    const uint2 e4 = __ldcg(reinterpret_cast<const uint2*>(emb_sum + o));
    const bf16* rv = reinterpret_cast<const bf16*>(&r4);
    const bf16* ev = reinterpret_cast<const bf16*>(&e4);
    __align__(8) bf16 sum[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[e] = __float2bfloat16_rn(bf(ev[e]) + bf(rv[e]));
    *reinterpret_cast<uint2*>(xraw + o) = r4;
    *reinterpret_cast<uint2*>(emb_sum + o) = *reinterpret_cast<const uint2*>(sum);
  }
}

struct SubtalkerArgs {
  int B, Ht, Hc, heads, kvh, D, inter, V, Qm1, L, has_proj, do_sample;
  float eps, scale;
  const bf16* x0;          // (B, 2, Ht): past hidden, code-0 embedding
  const float* cosr;       // (Qm1 + 1, D)
  const float* sinr;
  const float* gumbel;     // (Qm1, B, V), read only when do_sample
  const float* temp;       // (B,)
  const int* topk;         // (B,)
  const bf16* projw;       // (Hc, Ht) when has_proj
  const float* projb;      // (Hc,)
  LayerWeights w;          // stacked (L, ...) tensors
  const float* fnw;        // (Hc,) final norm
  const bf16* lm_heads;    // (Qm1, V, Hc)
  const bf16* embeds;      // (Qm1, V, Ht)
  bf16* kc;                // (L, B, kvh, Qm1 + 1, D) scratch cache
  bf16* vc;
  EngineScratch t;         // amax: ((Qm1 + 1) L, B, 1)
  long long zero_bytes;    // of the zeroed region that starts at t.bar
  long long part_off;      // set by the launch: where `part` of gemm_bf16w lies in shared memory
  bf16* x;                 // (B, Hc) residual scratch
  bf16* xraw;              // (B, Ht) next position's raw input
  float* logits;           // (B, V)
  int* codes;              // (B, Qm1) out
  bf16* emb_sum;           // (B, Ht) out
};

static __global__ void __launch_bounds__(ENG_THREADS, 1) k_subtalker_frame(SubtalkerArgs a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const EngSmem sm = eng_smem(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int smax = a.Qm1 + 1;
  const LayerShape s{a.B, a.Hc, a.heads, a.kvh, a.D, a.inter, 1, a.eps};
  const int nqkv = (a.heads + 2 * a.kvh) * a.D;
  const size_t layer_kv = (size_t)a.B * a.kvh * smax * a.D;
  AttnParams ap{};
  ap.B = a.B;
  ap.heads = a.heads;
  ap.kvh = a.kvh;
  ap.D = a.D;
  ap.eps = a.eps;
  ap.scale = a.scale;
  ap.cs_ld = 0;
  ap.S_buf = smax;
  ap.S_att = smax;
  ap.splits = 1;
  ap.cps = 1;
  for (int i = blockIdx.x * ENG_THREADS + tid; i < a.B * a.Ht; i += gridDim.x * ENG_THREADS)
    a.emb_sum[i] = __float2bfloat16_rn(0.f);
  // the bf16-weight stages' partial sums, behind the widest staged rows
  float* part = reinterpret_cast<float*>(smem_raw + a.part_off);
  WStream ws;
  for (int pos = 0; pos < smax; ++pos) {
    // position 0 reads the talker hidden, 1 the code-0 embedding, later ones
    // the embedding sampled at the previous position
    const bf16* xin = pos < 2 ? a.x0 + (size_t)pos * a.Ht : a.xraw;
    const int ldx = pos < 2 ? 2 * a.Ht : a.Ht;
    if (a.has_proj) {
      bf16* x_s = reinterpret_cast<bf16*>(sm.act);
      __syncthreads();   // the previous stage is done with the act region
      stage_rows(xin, ldx, a.Ht, a.B, x_s, bf16w_stride(a.Ht, false));
      ENG_MARK();
      gemm_bf16w<bf16>(x_s, a.B, a.Ht, a.projw, a.projb, a.Hc, nullptr, a.x, a.Hc, sm, part);
    } else {
      for (int i = blockIdx.x * ENG_THREADS + tid; i < a.B * a.Hc; i += gridDim.x * ENG_THREADS)
        a.x[i] = __ldcg(xin + (size_t)(i / a.Hc) * ldx + i % a.Hc);
    }
    gemm_begin_plain(ws, sm.ring, a.w.qkv_q, a.Hc, nqkv, a.Hc);
    ENG_MARK();
    grid_barrier(a.t.bar, &sm.mi->nth_barrier);
    ap.cosr = a.cosr + (size_t)pos * a.D;
    ap.sinr = a.sinr + (size_t)pos * a.D;
    ap.sub_pos = pos;
    for (int li = 0; li < a.L; ++li) {
      const LayerWeights w = layer_slice(a.w, li, a.Hc, a.heads, a.kvh, a.D, a.inter);
      ap.kv = KVPtrs{a.kc + li * layer_kv, a.vc + li * layer_kv, nullptr, nullptr};
      const int8_t* next = li + 1 < a.L ? a.w.qkv_q + (size_t)(li + 1) * nqkv * a.Hc : nullptr;
      engine_layer<bf16>(s, w, next, a.x, a.x, ap, a.t,
                         a.t.amax + ((size_t)pos * a.L + li) * a.B, ws, sm);
    }
    if (pos == 0) continue;  // the prefill position only fills the cache
    // every block: the final norm of all rows (f32, not rounded), then its
    // own columns of this step's lm head
    float* hn_s = reinterpret_cast<float*>(sm.act);
    for (int r = warp; r < a.B; r += ENG_WARPS)
      warp_norm_row(a.x + (size_t)r * a.Hc, a.Hc, a.fnw, a.eps,
                    hn_s + (size_t)r * bf16w_stride(a.Hc, true), nullptr);
    ENG_MARK();
    gemm_bf16w<float>(hn_s, a.B, a.Hc, a.lm_heads + (size_t)(pos - 1) * a.V * a.Hc, nullptr, a.V,
                      a.logits, nullptr, a.V, sm, part);
    ENG_MARK();
    grid_barrier(a.t.bar, &sm.mi->nth_barrier);
    ENG_MARK();
    if ((int)blockIdx.x < a.B)
      sample_row(blockIdx.x, a.logits, a.V, a.do_sample, a.temp, a.topk,
                 a.do_sample ? a.gumbel + (size_t)(pos - 1) * a.B * a.V : nullptr,
                 a.embeds + (size_t)(pos - 1) * a.V * a.Ht, a.Ht, a.codes, a.Qm1, pos - 1,
                 a.xraw, a.emb_sum, reinterpret_cast<float*>(sm.act), sm.mi);
    ENG_MARK();
    grid_barrier(a.t.bar, &sm.mi->nth_barrier);
    ENG_MARK();
  }
}

// Bytes of the act region: the layers' rows, the rows staged for the
// projection (bf16) and the lm head (f32), or the logits row of the sampling.
static size_t subtalker_act(const SubtalkerArgs* a) {
  const LayerShape s{a->B, a->Hc, a->heads, a->kvh, a->D, a->inter, 1, a->eps};
  size_t act = layer_act_bytes(s);
  const size_t staged[] = {
      a->has_proj ? (size_t)a->B * bf16w_stride(a->Ht, false) * sizeof(bf16) : 0,
      (size_t)a->B * bf16w_stride(a->Hc, true) * sizeof(float), (size_t)a->V * sizeof(float)};
  for (size_t v : staged) act = v > act ? v : act;
  return (act + 127) / 128 * 128;
}

static int subtalker_launch(const SubtalkerArgs* a, void* stream, int* grid, int* smem_out,
                            bool launch) {
  SubtalkerArgs args = *a;
  args.part_off = SM_ACT + subtalker_act(a);
  const size_t smem = args.part_off + BF16W_PART_BYTES;
  if (smem_out) *smem_out = (int)smem;
  return engine_launch(k_subtalker_frame, &args, smem, a->t.bar, (size_t)a->zero_bytes,
                       (cudaStream_t)stream, grid, launch);
}

extern "C" int qt_subtalker_frame(const SubtalkerArgs* a, void* stream) {
  return subtalker_launch(a, stream, nullptr, nullptr, true);
}

// The grid and the dynamic shared memory qt_subtalker_frame would launch with.
extern "C" int qt_subtalker_frame_geometry(const SubtalkerArgs* a, int* grid, int* smem) {
  return subtalker_launch(a, nullptr, grid, smem, false);
}

#ifdef ENG_PROFILE
// The clock marks of this file's engine launches since the last call.
extern "C" int qt_subtalker_clock(long long* out, int* n) { return eng_read_clock(out, n); }
#endif
