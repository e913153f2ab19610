// One 28-layer talker decode step, W8A8, over a bf16 or an int8 KV cache, as
// ONE persistent kernel on the layer engine of common.cuh.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/talker_step.py
// `talker_step_fused_cache` (kernel body `_kernel`); its plain twin is
// `talker_step_ref` in qwen3_tts_tpu_torch/ops/cuda/talker_step.py.
//
// What bounds it on the H100: weight bytes. At 1.7B one step streams 1.41 GB
// of int8 weights (qkv 4096x2048, o 2048x2048, gate_up 12288x2048, down
// 2048x6144 per layer, 28 layers) for a handful of rows, so its floor is
// ~0.42 ms at 3.35 TB/s; the KV window adds B * 28 * 2 * 8 * S * 128 * 2
// bytes (half of that, plus 8 bytes of scales per (slot, head), with an int8
// cache). The arithmetic (2 int8 ops per weight byte per row) is far below
// the int8 tensor-core rate at B <= 32.
//
// What the design does about it: one cooperative launch, one block per SM,
// runs all layers; a layer is nine stages between grid barriers (252 a
// step), each block streaming its own output columns of every matrix through
// a cp.async ring into int8 tensor-core mma, with the next matrix's first
// tiles already in flight while the block waits at a barrier or quantises
// its rows (common.cuh has the stages). The attention is split-K: a (row,
// KV head) window is cut into `kv_splits` runs of 128-slot chunks, so that
// B * kvh * splits items cover the SMs (B=2 over a 2400-slot clone window:
// 16 x 7 items instead of 16 blocks walking all of it); each item keeps the
// reference's online softmax over its chunks, and the last item of a (row,
// head) to finish folds the partial (m, l, acc) in split order and then the
// fresh slot. A split moves the running max at which e = bf16(exp(s - m)) is
// rounded, so outputs agree with the one-pass order to bf16 rounding, not
// bit for bit; `talker_step_ref(..., kv_splits=S)` is the same split math in
// plain PyTorch.
//
// int8-KV mode (the JAX kernel's quant_kv): the cache holds int8 K/V with
// f32 per-(slot, head) scales. A K row is 8 16-byte vectors instead of 16,
// its scale multiplies the finished dot product, the V scale folds into the
// bf16 softmax weight (bf16(e * v_scale)) before the P.V sum over int8 V.
// The fresh slot attends in bf16 from the item's own registers; split 0 of
// a (row, head) stores the slot's int8 quantization and scale (`store_kv`),
// which is safe because the chunk pass masks slot ci out.
//
// The chunked MLP keeps the reference's math: the down projection is C
// separate W8A8 products over inter/C columns, each with its own per-row
// activation scale, added into the bf16 residual in order (stage (v)).
#include "common.cuh"

struct TalkerStepArgs {
  int B, H, heads, kvh, D, inter, nseg, L, S_buf, S_att, window, ld_valid;
  int kv_splits, kv_cps;   // window splits, 128-slot chunks per split
  int cache_rows;          // rows of the caches kv points into (>= B: a row tile's launch)
  float eps, scale;
  const bf16* embed;       // (B, H)
  const float* cosr;       // (B, D)
  const float* sinr;       // (B, D)
  const int* ci;           // (B,) cache slot written this step
  const uint8_t* valid;    // (B, ld_valid) bool
  LayerWeights w;          // stacked (L, ...) tensors
  const float* fnw;        // (H,) final norm
  KVPtrs kv;               // row 0 of this launch in (L, cache_rows, kvh, S_buf, D) bf16, or
                           // int8 + (L, cache_rows, kvh, S_buf) scales
  EngineScratch t;         // amax: (L, B, nseg)
  long long zero_bytes;    // of the zeroed region that starts at t.bar
  bf16* x;                 // (B, H) residual scratch
  bf16* h;                 // (B, H) out: final-normed hidden
};

extern "C" const char* qt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

template <typename KV>
static __global__ void __launch_bounds__(ENG_THREADS, 1) k_talker_step(TalkerStepArgs a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const EngSmem sm = eng_smem(smem_raw);
  const LayerShape s{a.B, a.H, a.heads, a.kvh, a.D, a.inter, a.nseg, a.eps};
  const int nqkv = (a.heads + 2 * a.kvh) * a.D;
  const size_t layer_slots = (size_t)a.cache_rows * a.kvh * a.S_buf;
  AttnParams ap{};
  ap.B = a.B;
  ap.heads = a.heads;
  ap.kvh = a.kvh;
  ap.D = a.D;
  ap.eps = a.eps;
  ap.scale = a.scale;
  ap.cosr = a.cosr;
  ap.sinr = a.sinr;
  ap.cs_ld = a.D;
  ap.S_buf = a.S_buf;
  ap.S_att = a.S_att;
  ap.window = a.window;
  ap.ci = a.ci;
  ap.valid = a.valid;
  ap.ld_valid = a.ld_valid;
  ap.sub_pos = -1;
  ap.splits = a.kv_splits;
  ap.cps = a.kv_cps;
  ap.part_ml = a.t.part_ml;
  ap.part_acc = a.t.part_acc;
  ap.cnt = a.t.cnt;
  WStream ws;
  gemm_begin_plain(ws, sm.ring, a.w.qkv_q, a.H, nqkv, a.H);
  for (int li = 0; li < a.L; ++li) {
    const LayerWeights w = layer_slice(a.w, li, a.H, a.heads, a.kvh, a.D, a.inter);
    ap.kv = kv_layer(a.kv, li, layer_slots, a.D);
    const int8_t* next = li + 1 < a.L ? a.w.qkv_q + (size_t)(li + 1) * nqkv * a.H : nullptr;
    engine_layer<KV>(s, w, next, li == 0 ? a.embed : a.x, a.x, ap, a.t,
                     a.t.amax + (size_t)li * a.B * a.nseg, ws, sm);
  }
  // the final norm, one warp per row
  const int warp = threadIdx.x >> 5;
  for (int r = blockIdx.x * ENG_WARPS + warp; r < a.B; r += gridDim.x * ENG_WARPS)
    warp_norm_row(a.x + (size_t)r * a.H, a.H, a.fnw, a.eps, nullptr, a.h + (size_t)r * a.H);
}

static size_t talker_smem(const TalkerStepArgs* a) {
  const LayerShape s{a->B, a->H, a->heads, a->kvh, a->D, a->inter, a->nseg, a->eps};
  return SM_ACT + layer_act_bytes(s);
}

static int talker_launch(const TalkerStepArgs* a, void* stream, int* grid, bool launch) {
  const size_t smem = talker_smem(a);
  cudaStream_t st = (cudaStream_t)stream;
  if (a->kv.ks)
    return engine_launch(k_talker_step<int8_t>, a, smem, a->t.bar, (size_t)a->zero_bytes, st,
                         grid, launch);
  return engine_launch(k_talker_step<bf16>, a, smem, a->t.bar, (size_t)a->zero_bytes, st, grid,
                       launch);
}

extern "C" int qt_talker_step(const TalkerStepArgs* a, void* stream) {
  return talker_launch(a, stream, nullptr, true);
}

// The grid and the dynamic shared memory qt_talker_step would launch with.
extern "C" int qt_talker_step_geometry(const TalkerStepArgs* a, int* grid, int* smem) {
  *smem = (int)talker_smem(a);
  return talker_launch(a, nullptr, grid, false);
}

// The int8-KV store of stage (ii) (store_kv) on R given bf16 rows of D <= 128:
// q (R, D) int8, s (R,) f32. No decode path calls it; it lets a test hold the
// device quantizer to `kv_quantize` bit for bit on chosen values (rounding
// ties).
static __global__ void k_kv_store_rows(const bf16* __restrict__ x, int D, int8_t* q,
                                       float* s) {
  __shared__ float red[32];
  const int r = blockIdx.x, d = threadIdx.x;
  const bool active = d < D;
  store_kv(q, s, r, 1, 0, D, d, active ? bf(x[(size_t)r * D + d]) : 0.f, active, red);
}

extern "C" int qt_kv_store_rows(const bf16* x, int R, int D, int8_t* q, float* s,
                                void* stream) {
  if (D > 128) return (int)cudaErrorInvalidValue;
  k_kv_store_rows<<<R, 128, 0, (cudaStream_t)stream>>>(x, D, q, s);
  LAUNCH_CHECK();
  return 0;
}

// The engine's quantiser and GEMM stage alone, for a test of their
// exactness: B rows of x (bf16, row stride ldx) are quantised per row (no
// norm) and multiplied with rows [0, N) of wq (int8, row stride ldw, K columns
// from the pointer given), out[r, n] = (float(acc) * xs[r]) * ws[n] in f32.
// paired = 1 runs the gate_up tiling: N = 2 * inter rows, gate row j and up
// row j in one tile.
struct GemmProbeArgs {
  int B, N, K, ldx, ldw, paired;
  const bf16* x;
  const int8_t* wq;
  const float* ws;
  float* out;      // (B, N)
  unsigned* bar;   // 2 words, zeroed by the launch
  int8_t* xq_g;    // (B, K) scratch
  float* xs_g;     // (B,) scratch
};

static __global__ void __launch_bounds__(ENG_THREADS, 1) k_gemm_probe(GemmProbeArgs a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const EngSmem sm = eng_smem(smem_raw);
  int8_t* xq = reinterpret_cast<int8_t*>(sm.act);
  WStream ws;
  Epi e{};
  e.ws = a.ws;
  e.outf = a.out;
  e.ldo = a.N;
  if (a.paired) {
    gemm_begin_paired(ws, sm.ring, a.wq, a.ldw, a.N / 2, a.K);
    e.mode = EPI_PAIR_F32;
    e.ws_hi = a.ws + a.N / 2;
    e.hi_off = a.N / 2;
  } else {
    gemm_begin_plain(ws, sm.ring, a.wq, a.ldw, a.N, a.K);
    e.mode = EPI_F32;
  }
  quant_rows(a.x, a.ldx, a.K, nullptr, 0.f, nullptr, 1, a.B, a.xq_g, a.K, a.xs_g, sm.mi);
  grid_barrier(a.bar, &sm.mi->nth_barrier);
  load_rows(a.xq_g, a.K, a.K, a.B, a.xs_g, 1, xq, act_stride(a.K), sm.mi);
  gemm_run(ws, sm, xq, act_stride(a.K), a.B, e);
}

extern "C" int qt_gemm_probe(const GemmProbeArgs* a, void* stream) {
  const size_t smem = SM_ACT + (size_t)((a->B + 7) / 8 * 8) * act_stride(a->K);
  return engine_launch(k_gemm_probe, a, smem, a->bar, 2 * sizeof(unsigned),
                       (cudaStream_t)stream, nullptr, true);
}

// n grid barriers and nothing else: what one barrier costs on this card.
struct BarrierProbeArgs {
  int n;
  unsigned* bar;   // the barrier's word (2 allocated), zeroed by the launch
};

static __global__ void __launch_bounds__(ENG_THREADS, 1) k_barrier_probe(BarrierProbeArgs a) {
  __shared__ unsigned nth;
  if (threadIdx.x == 0) nth = 0;
  for (int i = 0; i < a.n; ++i) grid_barrier(a.bar, &nth);
}

extern "C" int qt_barrier_probe(const BarrierProbeArgs* a, void* stream) {
  return engine_launch(k_barrier_probe, a, 0, a->bar, 2 * sizeof(unsigned),
                       (cudaStream_t)stream, nullptr, true);
}

#ifdef ENG_PROFILE
// The clock marks of this file's engine launches since the last call.
extern "C" int qt_talker_clock(long long* out, int* n) { return eng_read_clock(out, n); }
#endif
