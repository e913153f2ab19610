// One 28-layer talker decode step, W8A8, over a bf16 or an int8 KV cache.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/talker_step.py
// `talker_step_fused_cache` (kernel body `_kernel`); its plain twin is
// `talker_step_ref` in qwen3_tts_tpu_torch/ops/cuda/talker_step.py.
//
// What bounds it on the H100: weight bytes. At 1.7B one step streams 1.41 GB
// of int8 weights (qkv 4096x2048, o 2048x2048, gate_up 12288x2048, down
// 2048x6144 per layer, 28 layers) for a handful of rows, so its floor is
// ~0.42 ms at 3.35 TB/s; the KV window adds B * 28 * 2 * 8 * S * 128 * 2
// bytes. The arithmetic (2 int8 ops per weight byte per row) is far below
// the int8 tensor-core rate at B <= 32.
//
// What this first design does about it: every weight byte is read once per
// step by exactly one warp in 16-byte vectors (one warp per output column,
// all rows of the batch share the load); activations are quantised per row
// once per matmul and stay in L1/L2; the KV window is read once per (row, kv
// head) block for all G query heads that share it. It does NOT yet overlap
// layers or use the tensor cores: each layer is 10 short launches
// (norm+quant, qkv, qk-norm+rope+cache write, attention, quant, o+residual,
// norm+quant, gate_up, silu+quant, chunked down+residual), so at small batch
// launch gaps dominate. A persistent kernel or a CUDA graph over the step,
// and wgmma/TMA weight streaming, are the next steps.
//
// int8-KV mode (the JAX kernel's quant_kv): the cache holds int8 K/V with
// f32 per-(slot, head) scales. At B=2 over a ~2400-slot window one step
// reads the same 1.41 GB of weights plus B * 28 * 2 * 8 * S * 128 bytes of
// int8 K/V (~275 MB; 550 MB in bf16) and 8 bytes of scales per (slot, head),
// so the mode is bounded by bytes as the bf16 one is, with half the KV term.
// This first design keeps k_attn's structure and only halves its KV loads:
// a K row is 8 16-byte vectors instead of 16, its scale multiplies the
// finished dot product, the V scale folds into the bf16 softmax weight
// (bf16(e * v_scale)) before the P.V sum over int8 V. It adds no split of
// the window across blocks (16 blocks at B=2 still walk all of it), so the
// halved bytes buy little while the loop is latency-bound. The fresh slot
// attends in bf16 from a (B, kvh, D) scratch that k_qk_rope fills; the same
// kernel stores the slot's int8 quantization and scale early, which is safe
// because k_attn masks slot ci out of the chunk pass.
//
// The chunked MLP keeps the reference's math: the down projection is C
// separate W8A8 products over inter/C columns, each with its own per-row
// activation scale, added into the bf16 residual in order (k_w8a8 nseg = C).
#include "common.cuh"

struct TalkerStepArgs {
  int B, H, heads, kvh, D, inter, nseg, L, S_buf, S_att, window, ld_valid;
  float eps, scale;
  const bf16* embed;       // (B, H)
  const float* cosr;       // (B, D)
  const float* sinr;       // (B, D)
  const int* ci;           // (B,) cache slot written this step
  const uint8_t* valid;    // (B, ld_valid) bool
  LayerWeights w;          // stacked (L, ...) tensors
  const float* fnw;        // (H,) final norm
  KVPtrs kv;               // (L, B, kvh, S_buf, D) bf16, or int8 + (L, B, kvh, S_buf) scales
  LayerScratch t;
  bf16* x;                 // (B, H) residual scratch
  bf16* h;                 // (B, H) out: final-normed hidden
};

extern "C" const char* qt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

extern "C" int qt_talker_step(const TalkerStepArgs* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemcpyAsync(a->x, a->embed, (size_t)a->B * a->H * sizeof(bf16),
                  cudaMemcpyDeviceToDevice, st);
  LAUNCH_CHECK();
  LayerShape s{a->B, a->H, a->heads, a->kvh, a->D, a->inter, a->nseg,
               a->S_buf, a->S_att, a->window, a->eps, a->scale};
  const size_t layer_slots = (size_t)a->B * a->kvh * a->S_buf;
  for (int li = 0; li < a->L; ++li) {
    const LayerWeights w = layer_slice(a->w, li, a->H, a->heads, a->kvh, a->D, a->inter);
    const int e = run_layer(s, w, a->x, a->cosr, a->sinr, a->D,
                            kv_layer(a->kv, li, layer_slots, a->D), a->ci, a->valid,
                            a->ld_valid, -1, a->t, st);
    if (e) return e;
  }
  return row_norm_launch(a->x, a->H, a->fnw, a->eps, a->H, a->B, nullptr, 0, nullptr,
                         nullptr, a->h, a->H, st);
}

// The int8-KV store of k_qk_rope (store_kv) on R given bf16 rows of D <= 128:
// q (R, D) int8, s (R,) f32, fresh (R, D) the bf16 rows as the attention
// would read them. No decode path calls it; it lets a test hold the device
// quantizer to `kv_quantize` bit for bit on chosen values (rounding ties).
static __global__ void k_kv_store_rows(const bf16* __restrict__ x, int D, int8_t* q,
                                       float* s, bf16* fresh) {
  __shared__ float red[32];
  const int r = blockIdx.x, d = threadIdx.x;
  const bool active = d < D;
  store_kv(q, s, fresh, r, 1, 0, D, d, active ? bf(x[(size_t)r * D + d]) : 0.f, active,
           red);
}

extern "C" int qt_kv_store_rows(const bf16* x, int R, int D, int8_t* q, float* s,
                                bf16* fresh, void* stream) {
  if (D > 128) return (int)cudaErrorInvalidValue;
  k_kv_store_rows<<<R, 128, 0, (cudaStream_t)stream>>>(x, D, q, s, fresh);
  LAUNCH_CHECK();
  return 0;
}
