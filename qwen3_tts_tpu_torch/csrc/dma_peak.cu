// The two device-memory bandwidth probes: the card's achievable read rate on
// one long contiguous stream, and on the talker step's own fetch set.
//
// `k_stream` replaces the TPU kernel benchmarks/dma_peak.py `stream_bw`
// (kernel body `_stream_kernel`): per-lane column sums of an int8
// (rows, 1024) buffer over P passes, out = P * sum_rows x[:, lane].
// `k_shaped` replaces benchmarks/dma_peak.py `shaped_bw` (`_shaped_kernel`):
// per pass, for every layer l and KV chunk c, the column sums of the (Wr, H)
// int8 weight block of layer l (columns [:128]), the (D,) lane sums of one K
// and one V chunk (B, Hkv, Sc, D), and the scalar sums of two (H,) f32
// vectors. The plain twins are `stream_sum_ref` / `shaped_sum_ref` in
// qwen3_tts_tpu_torch/ops/cuda/dma_peak.py.
//
// What bounds them on the H100: bytes, by construction. A pass reads every
// input byte once (2 GB for the stream; 1.18 GB at 256 KV slots, 3.99 GB at
// 1024 for the shaped set) and does about one integer or float add per
// byte, far below the card's operation rates. So the design spends as few
// instructions per byte as it can and keeps enough loads in flight:
// - 16-byte loads (`ld.global.cs`, streamed past the caches), neighbouring
//   threads on neighbouring addresses, every thread keeping its column
//   group for the whole launch, 256 threads a block, as many blocks as fit
//   on the card but no more than one pass has items (the wrapper's grid);
// - int8 sums as SIMD within a register: a byte biased to 0..255 goes into a
//   16-bit half of a 32-bit accumulator (one LOP3 and one add for two bytes),
//   flushed to int32 every 240 rows; a bf16 value goes to a double
//   accumulator, so the K/V sums match a float64 sum to far below f32
//   rounding whatever the order;
// - all P passes in one launch, over a flat list of work items ordered pass
//   first (each item a contiguous piece of ~512 KB, or one `block_rows`
//   block of the stream), dealt to the blocks round robin: no byte is read
//   again before the whole pass (2 GB, 40x the 50 MB L2) has been read, so
//   every pass comes from device memory;
// - the cross-block reduction is deterministic: integer sums go through
//   64-bit integer atomics (exact, so their order cannot show), the double
//   K/V and vector sums through per-block partials that a second small
//   kernel adds in block order.
// Every byte counted in the bytes moved reaches a checked output: the
// shaped probe also returns the (L, H) column sums of every weight block
// over all H columns (the JAX output keeps 128 of them), so a kernel that
// skipped weight bytes would fail its twin.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 240;        // rows per SIMD accumulator before a flush (<= 256)
constexpr int kLanes = 1024;       // the stream probe's row width in bytes
constexpr int kMaxH = 4096;        // widest weight row (H / 16 vectors divide kThreads)
constexpr int kD = 128;            // K/V head width: the output's 128 lanes

#define DMA_CHECK()                              \
  do {                                           \
    cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

// 16 int8 lanes, one 16-byte vector a row, summed as SIMD within a register:
// e[j] holds bytes 4j and 4j+2 (biased by 128) in its low and high halves,
// o[j] bytes 4j+1 and 4j+3.
struct I8Lanes {
  uint32_t e[4], o[4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = o[j] = 0u;
  }

  __device__ __forceinline__ void add(uint4 v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      e[j] += (w[j] ^ 0x80808080u) & 0x00FF00FFu;
      o[j] += ((w[j] >> 8) ^ 0x00800080u) & 0x00FF00FFu;
    }
  }

  // add the lane sums of the last n rows to s, less the bias
  __device__ __forceinline__ void flush(int n, int* s) {
    const int bias = 128 * n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[4 * j] += (int)(e[j] & 0xFFFFu) - bias;
      s[4 * j + 1] += (int)(o[j] & 0xFFFFu) - bias;
      s[4 * j + 2] += (int)(e[j] >> 16) - bias;
      s[4 * j + 3] += (int)(o[j] >> 16) - bias;
    }
    zero();
  }
};

// Thread t's share of the column sums of nvec 16-byte vectors from base:
// vectors t, t + blockDim, ... (all in column group t % (row vectors), since
// the row's vector count divides blockDim), added into s[16].
__device__ __forceinline__ void colsum_share(const uint4* __restrict__ base, long long nvec, int* s) {
  const long long t = threadIdx.x;
  const long long cnt = nvec > t ? (nvec - t + blockDim.x - 1) / blockDim.x : 0;
  const uint4* p = base + t;
  I8Lanes acc;
  acc.zero();
  for (long long k0 = 0; k0 < cnt; k0 += kBatch) {
    const int m = (int)min((long long)kBatch, cnt - k0);
    const uint4* q = p + k0 * blockDim.x;
#pragma unroll 4
    for (int k = 0; k < m; ++k) acc.add(__ldcs(q + (long long)k * blockDim.x));
    acc.flush(m, s);
  }
}

__device__ __forceinline__ void add_bf16x8(uint4 v, double* kv) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    kv[2 * j] += (double)__uint_as_float(w[j] << 16);
    kv[2 * j + 1] += (double)__uint_as_float(w[j] & 0xFFFF0000u);
  }
}

}  // namespace

struct StreamArgs {
  long long rows, block_rows;   // x is (rows, 1024) int8; one item = block_rows rows
  int passes, grid;
  const int8_t* x;
  unsigned long long* acc;      // (1024,) int64 scratch
  float* out;                   // (1024,)
};

struct ShapedArgs {
  int L, Wr, H, BH, Hkv, Sc, nS, passes, grid;
  int w_rows, runs;             // weight rows per item; (b, h) runs per K/V item
  // K/V element strides: layer, chunk, batch row, kv head (a run of Sc x D is
  // contiguous)
  long long k_sl, k_sc, k_sb, k_sh, v_sl, v_sc, v_sb, v_sh;
  const int8_t* w;              // (L, Wr, H)
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* s1;              // (L, H)
  const float* s2;
  unsigned long long* colsum;   // (L, H) int64 scratch
  double* kvpart;               // (grid, 128) scratch
  double* scpart;               // (grid,) scratch
  float* out;                   // (128,)
  float* side;                  // (L, H): P x the column sums of every weight block
};

static __global__ void __launch_bounds__(kThreads) k_stream(StreamArgs a) {
  __shared__ long long s[kLanes];
  const long long n = (a.rows + a.block_rows - 1) / a.block_rows;
  const long long items = n * a.passes;
  long long tot[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) tot[j] = 0;
  for (long long i = blockIdx.x; i < items; i += gridDim.x) {
    const long long c = i % n;                 // pass i / n is the outer loop
    const long long r0 = c * a.block_rows;
    const long long r1 = min(a.rows, r0 + a.block_rows);
    int sums[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) sums[j] = 0;
    colsum_share((const uint4*)(a.x + r0 * kLanes), (r1 - r0) * (kLanes / 16), sums);
#pragma unroll
    for (int j = 0; j < 16; ++j) tot[j] += sums[j];
  }
  // the kThreads / 64 threads of a column group add in thread order
  const int g = threadIdx.x % (kLanes / 16);
  for (int q = 0; q < kThreads / (kLanes / 16); ++q) {
    if ((int)threadIdx.x / (kLanes / 16) == q) {
#pragma unroll
      for (int j = 0; j < 16; ++j) s[16 * g + j] = (q ? s[16 * g + j] : 0) + tot[j];
    }
    __syncthreads();
  }
  for (int l = threadIdx.x; l < kLanes; l += blockDim.x)
    atomicAdd(a.acc + l, (unsigned long long)s[l]);
}

static __global__ void k_stream_out(const unsigned long long* acc, float* out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l < kLanes) out[l] = (float)(long long)acc[l];
}

static __global__ void __launch_bounds__(kThreads) k_shaped(ShapedArgs a) {
  __shared__ int s_col[kMaxH];
  __shared__ double s_kv[kThreads / 16][kD];
  __shared__ double s_sc[kThreads];
  const int t = threadIdx.x;
  const int nw = (a.Wr + a.w_rows - 1) / a.w_rows;
  const int nkv = (a.BH + a.runs - 1) / a.runs;
  const long long per_layer = nw + 2LL * a.nS * nkv;
  const long long per_pass = a.L * per_layer;
  const long long items = per_pass * a.passes;
  const int vpr = a.H / 16;
  for (int h = t; h < a.H; h += blockDim.x) s_col[h] = 0;
  __syncthreads();
  double kv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  double sc = 0;
  for (long long i = blockIdx.x; i < items; i += gridDim.x) {
    const long long rem = i % per_pass;        // pass i / per_pass is the outer loop
    const int l = (int)(rem / per_layer);
    long long j = rem % per_layer;
    if (j < nw) {                              // rows [r0, r1) of layer l's weight block
      const long long r0 = j * a.w_rows;
      const long long r1 = min((long long)a.Wr, r0 + a.w_rows);
      int sums[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) sums[q] = 0;
      colsum_share((const uint4*)(a.w + ((long long)l * a.Wr + r0) * a.H),
                   (r1 - r0) * vpr, sums);
      if (t < (int)min((long long)blockDim.x, (r1 - r0) * vpr)) {
        int* dst = s_col + 16 * (t % vpr);
#pragma unroll
        for (int q = 0; q < 16; ++q) atomicAdd(dst + q, sums[q]);
      }
      if (j == 0)                              // the layer's two vectors, once
        for (int h = t; h < a.H; h += blockDim.x)
          sc += (double)a.s1[(long long)l * a.H + h] + (double)a.s2[(long long)l * a.H + h];
      __syncthreads();
      for (int h = t; h < a.H; h += blockDim.x) {
        atomicAdd(a.colsum + (long long)l * a.H + h, (unsigned long long)(long long)s_col[h]);
        s_col[h] = 0;
      }
      __syncthreads();
    } else {                                   // runs [g * runs, ...) of a K or V chunk
      j -= nw;
      const bool is_k = j < (long long)a.nS * nkv;
      j %= (long long)a.nS * nkv;
      const int c = (int)(j / nkv), gi = (int)(j % nkv);
      const __nv_bfloat16* chunk = is_k ? a.k + l * a.k_sl + c * a.k_sc
                                        : a.v + l * a.v_sl + c * a.v_sc;
      const long long sb = is_k ? a.k_sb : a.v_sb, sh = is_k ? a.k_sh : a.v_sh;
      const int nvec = a.Sc * (kD / 8);
      const int cnt = nvec > t ? (nvec - t + blockDim.x - 1) / blockDim.x : 0;
      for (int r = gi * a.runs; r < min(a.BH, (gi + 1) * a.runs); ++r) {
        const uint4* run = (const uint4*)(chunk + (r / a.Hkv) * sb + (r % a.Hkv) * sh) + t;
#pragma unroll 4
        for (int q = 0; q < cnt; ++q) add_bf16x8(__ldcs(run + q * blockDim.x), kv);
      }
    }
  }
  // the 16 threads of a lane group, then the block's threads, in order
#pragma unroll
  for (int e = 0; e < 8; ++e) s_kv[t / 16][8 * (t % 16) + e] = kv[e];
  s_sc[t] = sc;
  __syncthreads();
  if (t < kD) {
    double x = 0;
    for (int r = 0; r < kThreads / 16; ++r) x += s_kv[r][t];
    a.kvpart[(long long)blockIdx.x * kD + t] = x;
  }
  if (t == 0) {
    double x = 0;
    for (int r = 0; r < kThreads; ++r) x += s_sc[r];
    a.scpart[blockIdx.x] = x;
  }
}

static __global__ void k_shaped_out(ShapedArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (long long)a.L * a.H) a.side[i] = (float)(long long)a.colsum[i];
  if (i < kD) {
    double w = 0, kvs = 0, scs = 0;
    for (int l = 0; l < a.L; ++l) w += (double)(long long)a.colsum[(long long)l * a.H + i];
    for (int b = 0; b < a.grid; ++b) kvs += a.kvpart[(long long)b * kD + i];
    for (int b = 0; b < a.grid; ++b) scs += a.scpart[b];
    a.out[i] = (float)(a.nS * w + kvs + a.nS * scs);
  }
}

extern "C" int qt_dma_max_grid(int shaped, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (shaped)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_shaped, kThreads, 0);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_stream, kThreads, 0);
  DMA_CHECK();
  *grid = sms * per_sm;
  return 0;
}

extern "C" int qt_stream_sum(const StreamArgs* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(a->acc, 0, kLanes * sizeof(unsigned long long), st);
  DMA_CHECK();
  k_stream<<<a->grid, kThreads, 0, st>>>(*a);
  DMA_CHECK();
  k_stream_out<<<kLanes / kThreads, kThreads, 0, st>>>(a->acc, a->out);
  DMA_CHECK();
  return 0;
}

extern "C" int qt_shaped_sum(const ShapedArgs* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (a->H > kMaxH || a->H % 16 || kThreads % (a->H / 16) || a->H < kD)
    return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(a->colsum, 0, (size_t)a->L * a->H * sizeof(unsigned long long), st);
  DMA_CHECK();
  k_shaped<<<a->grid, kThreads, 0, st>>>(*a);
  DMA_CHECK();
  const long long n = (long long)a->L * a->H;
  k_shaped_out<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(*a);
  DMA_CHECK();
  return 0;
}
