// One whole sub-talker (code predictor) frame: 16 positions (2 prefill + 14
// steps) through the 5-layer W8A8 code predictor, with per-step lm head,
// temperature, exact top-k, Gumbel-max sampling and the embedding gather.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/subtalker.py
// `subtalker_frame_fused` (kernel body `_subtalker_kernel`); its plain twin
// is `subtalker_frame_ref` in qwen3_tts_tpu_torch/ops/cuda/subtalker.py.
//
// What bounds it on the H100: bytes. Counting each input byte once, a frame
// needs the ~78 MB of int8 layer weights (qkv 4096x1024, o 1024x2048,
// gate_up 6144x1024, down 1024x3072, 5 layers), the 15 bf16 lm heads (63
// MB) and the projection (4 MB): ~0.044 ms at 3.35 TB/s for B=8. This
// design does not reach that: the 15 dependent steps (sample -> embed ->
// next position) serialise the frame, and the weights fit neither in shared
// memory nor in the 50 MB L2, so each position re-reads them and a frame
// streams ~1.3 GB (~0.4 ms). The TPU kernel's design (all weights resident
// in 128 MB of VMEM for the frame) does not carry over.
//
// What this first design does about it: the same W8A8 building blocks as
// the talker step (common.cuh) stream each weight byte once per position;
// sampling is one block per row that keeps the logits row in shared memory,
// finds the exact k-th value with the reference's 32-step bit search, adds
// the caller's Gumbel noise, takes the lowest-index argmax and gathers the
// sampled embedding row straight into the next position's input and the
// running bf16 emb_sum, so the frame never returns to the host. The host
// loop lives in C (qt_subtalker_frame), one call per frame. Launch gaps
// (~53 launches per position) dominate at small batch; a persistent kernel
// or a CUDA graph and tensor-core weight streaming are later work.
#include "common.cuh"

// y[r, n] = sum_k x[r, k] * float(w[n, k]) (+ bias[n]) in f32, x bf16 or f32.
// One warp per output column n, lanes stride K in 8-element vectors.
template <typename XT, int RB>
static __global__ void k_gemm_bf16w(const XT* __restrict__ x, int ldx, int R, int K,
                                    const bf16* __restrict__ w, int ldw,
                                    const float* __restrict__ bias, int N,
                                    float* outf, bf16* outb, int ldo) {
  const int n = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (n >= N) return;
  const bf16* wrow = w + (size_t)n * ldw;
  for (int r0 = 0; r0 < R; r0 += RB) {
    float acc[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) acc[i] = 0.f;
    for (int k = lane * 8; k < K; k += 32 * 8) {
      const uint4 wv = *reinterpret_cast<const uint4*>(wrow + k);
      const bf16* wp = reinterpret_cast<const bf16*>(&wv);
      float wf[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) wf[e] = bf(wp[e]);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        if (r0 + i >= R) break;
        const XT* xp = x + (size_t)(r0 + i) * ldx + k;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i] += to_f(xp[e]) * wf[e];
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
        const float y = bias ? acc[i] + bias[n] : acc[i];
        if (outf) outf[(size_t)r * ldo + n] = y;
        if (outb) outb[(size_t)r * ldo + n] = __float2bfloat16_rn(y);
      }
    }
  }
}

static __device__ __forceinline__ int order_key(float v) {
  // monotone int32 image of a float (radix-sort trick, signed)
  const int bits = __float_as_int(v);
  return bits >= 0 ? bits : (~bits) ^ (int)0x80000000;
}

// Sampling for one step, one block per row b (blockDim 256). Greedy
// (do_sample 0): argmax of the logits. Sampled: lt = logits / temp[b]; for
// 0 < k < V mask lt < kth (kth = the exact k-th largest value); add the
// Gumbel row; argmax. Ties go to the lowest index, as jnp.argmax does. Then
// gather the embedding row of the code into xraw and add it into emb_sum
// (bf16). Dynamic smem: V floats.
static __global__ void k_sample(const float* __restrict__ logits, int V, int do_sample,
                                const float* __restrict__ temp,
                                const int* __restrict__ topk,
                                const float* __restrict__ gumbel,
                                const bf16* __restrict__ table, int Ht, int* codes,
                                int Qm1, int col, bf16* xraw, bf16* emb_sum) {
  extern __shared__ float lt[];
  __shared__ float red[32];
  __shared__ int redi[32];
  __shared__ int code_s;
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* lr = logits + (size_t)b * V;
  const float tb = do_sample ? temp[b] : 1.f;
  for (int j = tid; j < V; j += blockDim.x) lt[j] = do_sample ? lr[j] / tb : lr[j];
  __syncthreads();
  if (do_sample) {
    const int k = topk[b];
    if (k > 0 && k < V) {
      // largest t with count(key >= t) >= k: exactly the k-th largest key
      int lo = INT_MIN, hi = INT_MAX;
      for (int it = 0; it < 32; ++it) {
        const int mid = (lo >> 1) + (hi >> 1) + ((lo | hi) & 1);
        float cnt = 0.f;
        for (int j = tid; j < V; j += blockDim.x) cnt += order_key(lt[j]) >= mid ? 1.f : 0.f;
        cnt = block_reduce<false>(cnt, red);
        if (cnt >= (float)k) lo = mid; else hi = mid - 1;
      }
      const float kth = __int_as_float(lo >= 0 ? lo : ~(lo ^ (int)0x80000000));
      __syncthreads();
      for (int j = tid; j < V; j += blockDim.x)
        if (lt[j] < kth) lt[j] = NEG_INF_F;
    }
    const float* gr = gumbel + (size_t)b * V;
    for (int j = tid; j < V; j += blockDim.x) lt[j] = lt[j] + gr[j];
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
  if (lane == 0) { red[wid] = best; redi[wid] = bi; }
  __syncthreads();
  if (tid == 0) {
    for (int i = 1; i < nw; ++i)
      if (red[i] > best || (red[i] == best && redi[i] < bi)) { best = red[i]; bi = redi[i]; }
    // best/bi of thread 0 already hold warp 0's result
    code_s = bi;
    codes[(size_t)b * Qm1 + col] = bi;
  }
  __syncthreads();
  const bf16* row = table + (size_t)code_s * Ht;
  for (int j = tid; j < Ht; j += blockDim.x) {
    const bf16 v = row[j];
    xraw[(size_t)b * Ht + j] = v;
    emb_sum[(size_t)b * Ht + j] = __float2bfloat16_rn(bf(emb_sum[(size_t)b * Ht + j]) + bf(v));
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
  LayerScratch t;
  bf16* x;                 // (B, Hc) residual scratch
  bf16* xraw;              // (B, Ht) next position's raw input
  float* hn;               // (B, Hc) final-normed hidden, f32
  float* logits;           // (B, V)
  int* codes;              // (B, Qm1) out
  bf16* emb_sum;           // (B, Ht) out
};

extern "C" int qt_subtalker_frame(const SubtalkerArgs* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int smax = a->Qm1 + 1;
  LayerShape s{a->B, a->Hc, a->heads, a->kvh, a->D, a->inter, 1,
               smax, smax, 0, a->eps, a->scale};
  const size_t layer_kv = (size_t)a->B * a->kvh * smax * a->D;
  cudaMemsetAsync(a->emb_sum, 0, (size_t)a->B * a->Ht * sizeof(bf16), st);
  LAUNCH_CHECK();
  for (int i = 0; i < smax; ++i) {
    // position 0 reads the talker hidden, 1 the code-0 embedding, later ones
    // the embedding sampled at the previous position
    const bf16* xin = i < 2 ? a->x0 + (size_t)i * a->Ht : a->xraw;
    const int ldx = i < 2 ? 2 * a->Ht : a->Ht;
    if (a->has_proj) {
      k_gemm_bf16w<bf16, 8><<<(a->Hc + 7) / 8, 256, 0, st>>>(
          xin, ldx, a->B, a->Ht, a->projw, a->Ht, a->projb, a->Hc, nullptr, a->x, a->Hc);
    } else {
      cudaMemcpy2DAsync(a->x, a->Hc * sizeof(bf16), xin, ldx * sizeof(bf16),
                        a->Hc * sizeof(bf16), a->B, cudaMemcpyDeviceToDevice, st);
    }
    LAUNCH_CHECK();
    for (int li = 0; li < a->L; ++li) {
      const LayerWeights w = layer_slice(a->w, li, a->Hc, a->heads, a->kvh, a->D, a->inter);
      const KVPtrs kv{a->kc + li * layer_kv, a->vc + li * layer_kv, nullptr, nullptr,
                      nullptr, nullptr};
      const int e = run_layer(s, w, a->x, a->cosr + (size_t)i * a->D,
                              a->sinr + (size_t)i * a->D, 0, kv, nullptr, nullptr, 0, i,
                              a->t, st);
      if (e) return e;
    }
    if (i == 0) continue;  // the prefill position only fills the cache
    int e = row_norm_launch(a->x, a->Hc, a->fnw, a->eps, a->Hc, a->B, nullptr, 0,
                            nullptr, a->hn, nullptr, a->Hc, st);
    if (e) return e;
    k_gemm_bf16w<float, 8><<<(a->V + 7) / 8, 256, 0, st>>>(
        a->hn, a->Hc, a->B, a->Hc, a->lm_heads + (size_t)(i - 1) * a->V * a->Hc,
        a->Hc, nullptr, a->V, a->logits, nullptr, a->V);
    LAUNCH_CHECK();
    k_sample<<<a->B, 256, a->V * sizeof(float), st>>>(
        a->logits, a->V, a->do_sample, a->temp, a->topk,
        a->do_sample ? a->gumbel + (size_t)(i - 1) * a->B * a->V : nullptr,
        a->embeds + (size_t)(i - 1) * a->V * a->Ht, a->Ht, a->codes, a->Qm1, i - 1,
        a->xraw, a->emb_sum);
    LAUNCH_CHECK();
  }
  return 0;
}
