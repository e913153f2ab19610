// The decode layer engine shared by the two W8A8 decode kernels
// (talker_step.cu and subtalker.cu). Each of them is ONE persistent kernel,
// launched cooperatively with one block of ENG_THREADS threads per SM; the
// loop over layers (and, in the sub-talker, over positions) runs inside the
// kernel, and the stages of a layer are separated by a grid-wide barrier.
//
// One layer is nine stages (the first of each pair quantises rows once for
// the grid, one block a row; measured, that extra barrier is cheaper than
// every block quantising every row itself, from 2 rows on):
//   (i)   RMSNorm + int8 quantiser of the residual rows; | every block copies
//         the int8 rows and runs its own units of the qkv projection;
//   (ii)  per (row, KV head[, window split]): QK-RMSNorm, RoPE, the cache
//         store and the attention (split-K over the window in the talker
//         step, one plain softmax over <= 16 slots in the sub-talker);
//   (iii) quantiser of the attention output; | its units of the o projection
//         + residual;
//   (iv)  RMSNorm + quantiser; | gate_up, gate row j and up row j in one mma
//         tile, so SiLU(gate)*up stays in the block; the product's per-(row,
//         segment) absolute maximum is gathered with an atomic max;
//   (v)   quantiser of every (row, segment) of the product at that maximum;
//         | per segment: its units of the down projection, added into the
//         bf16 residual in segment order.
// What a stage costs on the H100 is round trips to L2 and instruction throughput,
// not bytes: a barrier ~1 us, a stage 2-5 us, the weights' 4.5-15 us a layer
// hidden behind them.
//
// The GEMM stage. A unit is 16 weight rows (output columns) by the whole K
// of the call; block b owns units b, b + grid, ... of every matrix. The 16
// warps of a block split K in 64-byte chunks; each lane copies its own 16
// bytes of two weight rows per chunk into a ring of RING_STAGES stages with
// cp.async and reads back exactly the bytes it copied, so the ring needs no
// barrier; the copies run ahead across units, and the first stages of a
// matrix are started before the grid barrier in front of it. The products
// run on the int8 tensor cores (mma.sync m16n8k32, the
// weight tile as the 16-row operand, 8 batch rows as the columns; K is
// permuted the same way on both operands, which an exact integer sum
// allows). The warps' int32 partial sums meet in shared memory through
// atomic adds: exact in any order, so every GEMM output equals the
// reference's bit for bit. A matrix with fewer than one 16-row unit per
// block is cut into 8-row units (half of the mma tile idle).
//
// Numerics follow the JAX reference twins (ops/pallas/subtalker.py
// `subtalker_frame_ref`, ops/pallas/talker_step.py `talker_step_ref`):
//   * activations are quantised per row as q = clip(rint(x / s), +-127) with
//     s = max(amax / 127, 1e-12) and an IEEE division (not a reciprocal);
//   * int8 x int8 products accumulate exactly in int32, and the epilogue is
//     (float(acc) * s_row) * s_col;
//   * values round to bf16 at the reference's points (matmul outputs before
//     each residual add, q/k after RoPE, v, softmax weights);
//   * an int8 KV slot is the JAX `kv_quantize` of the bf16 K/V row over D:
//     s = max(amax, 1e-8) / 127 (IEEE division), q = clip(rint(x / s), +-127).
// The library is compiled with --fmad=false so that a*b+c is not contracted
// into an FMA the reference does not have.
//
// Data that one block writes and another reads inside a launch (the
// residual, qkv, the attention output, the product, partial softmax sums,
// the sub-talker's cache) is read with __ldcg: L2 is the point of coherence.
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

#define ENG_THREADS 512
#define ENG_WARPS 16
#define ENG_MAX_ROWS 32           // batch rows a launch takes (4 mma column tiles)
#define RING_STAGES 4
#define RING_SLOT 1024            // bytes a warp copies per stage: 2 x 16 a lane
#define ACT_PAD 64                // row stride of the int8 rows: K + 64 when K % 128 == 0
#define ATT_CHUNK 128
#define ATT_MAX_G 2              // query heads per KV head the attention is built for
// a grid barrier that spins this often traps: a lost arrival fails the launch
#define BARRIER_SPIN_LIMIT (1u << 22)

// dynamic shared memory of an engine kernel, in bytes from its base
#define SM_RING 0
#define SM_ACC (ENG_WARPS * RING_STAGES * RING_SLOT)
#define SM_ACC_BYTES (2 * ENG_MAX_ROWS * 16 * 4)
#define SM_MISC (SM_ACC + SM_ACC_BYTES)
#define SM_MISC_BYTES 1024
#define SM_ACT (SM_MISC + SM_MISC_BYTES)

// Built with -DENG_PROFILE, block 0 notes the clock at every mark of a launch
// (ENG_MARK after each part of a stage); qt_*_clock reads the marks back.
#ifdef ENG_PROFILE
#define ENG_MARKS 4096
static __device__ long long eng_clock[ENG_MARKS];
static __device__ int eng_clock_n;
#define ENG_MARK()                                                          \
  do {                                                                      \
    if (blockIdx.x == 0 && threadIdx.x == 0 && eng_clock_n < ENG_MARKS)     \
      eng_clock[eng_clock_n++] = clock64();                                 \
  } while (0)
static int eng_read_clock(long long* out, int* n) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(n, eng_clock_n, sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, eng_clock, sizeof(long long) * ENG_MARKS);
  const int zero = 0;
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(eng_clock_n, &zero, sizeof(int));
  return (int)e;
}
#else
#define ENG_MARK()
#endif

static __device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
static __device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
static __device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
static __device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

static __device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
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

// The low byte of quant_one(v, s), given rs = 1 / s, without a division for
// most values. t = v * rs is within 2e-5 of the IEEE quotient (|v / s| <=
// 128), so away from a rounding tie both round to the same integer; within
// 1e-3 of one the IEEE quotient decides: bit-equal to quant_one. Clipping
// first changes nothing (the bounds are integers), and adding 1.5 * 2^23
// rounds a |t| <= 127 to the nearest even integer in one add, leaving that
// integer's two's complement byte in the low mantissa bits.
static __device__ __forceinline__ unsigned quant_fast(float v, float s, float rs) {
  const float magic = 12582912.f;
  const float t = fminf(fmaxf(v * rs, -127.f), 127.f);
  const float tm = t + magic;
  const float q = tm - magic;
  if (fabsf(fabsf(t - q) - 0.5f) < 1e-3f) return (unsigned)(int)quant_one(v, s) & 0xffu;
  return (unsigned)__float_as_int(tm) & 0xffu;
}

// Small per-block state next to the ring (SM_MISC).
struct EngMisc {
  unsigned nth_barrier;       // grid barriers this block has passed
  float red[32];
  float xs[ENG_MAX_ROWS];     // the staged rows' activation scales
  float m[ATT_MAX_G], l[ATT_MAX_G], corr[ATT_MAX_G], snew[ATT_MAX_G];
  int live[ATT_MAX_G];
  int flag;
  int redi[32];
  int code;
};

struct EngSmem {
  uint8_t* ring;
  int* acc;
  EngMisc* mi;
  uint8_t* act;
};

static __device__ __forceinline__ EngSmem eng_smem(uint8_t* base) {
  EngSmem s;
  s.ring = base + SM_RING;
  s.acc = reinterpret_cast<int*>(base + SM_ACC);
  s.mi = reinterpret_cast<EngMisc*>(base + SM_MISC);
  s.act = base + SM_ACT;
  for (int i = threadIdx.x; i < SM_ACC_BYTES / 4; i += blockDim.x) s.acc[i] = 0;
  if (threadIdx.x == 0) s.mi->nth_barrier = 0;
  __syncthreads();
  return s;
}

// Grid-wide barrier over all co-resident blocks (a cooperative launch): one
// word, zeroed by the launch, that only counts up. Thread 0 adds its arrival
// with a release and polls the word with an acquire until it has reached
// (this block's barrier number) x (blocks); the __syncthreads around them
// extend both to the block. No reset, no second word: the last arrival is
// itself what the others wait to see, one round trip to L2 less than a
// counter with a generation flag. *nth is the block's barrier count so far
// (shared memory, zero at the kernel's start). A wait that spins past
// BARRIER_SPIN_LIMIT traps.
static __device__ __noinline__ void grid_barrier(unsigned* bar, unsigned* nth) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned target = ++*nth * gridDim.x;
    const size_t cnt = __cvta_generic_to_global(bar);
    unsigned seen, spins = 0;
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(cnt) : "memory");
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(cnt) : "memory");
      if (++spins > BARRIER_SPIN_LIMIT) __trap();
    } while (seen < target);
  }
  __syncthreads();
}

static __device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c (16 x 8, s32) += a (16 x 32, s8, row) * b (32 x 8, s8, col)
static __device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2, int a3,
                                              int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col); registers hold bf16 pairs
static __device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a1,
                                                unsigned a2, unsigned a3, unsigned b0,
                                                unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The W8A8 GEMM stage
// ---------------------------------------------------------------------------

// One block's stream of weight tiles for one GEMM call: unit ordinal ui is
// unit blockIdx.x + ui * gridDim.x, rows [unit * ustride, +8) of `lo` and of
// `hi` (hi NULL: 8-row units); warp w takes the 64-byte chunks w, w + 16, ...
// of K. `iss*` is the copy side, which runs RING_STAGES - 1 ahead.
struct WStream {
  const int8_t *lo, *hi;
  size_t ldw;
  int ustride, nunits, cpw, total;
  int iss, iss_u, iss_c;
};

static __device__ __forceinline__ void wstream_copy(WStream& s, uint8_t* ring) {
  if (s.iss < s.total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t row = (size_t)(blockIdx.x + s.iss_u * gridDim.x) * s.ustride + (lane >> 2);
    const size_t off = row * s.ldw + (size_t)(warp + s.iss_c * ENG_WARPS) * 64 + (lane & 3) * 16;
    uint8_t* slot = ring + (warp * RING_STAGES + s.iss % RING_STAGES) * RING_SLOT + lane * 16;
    cp_async16(slot, s.lo + off);
    if (s.hi) cp_async16(slot + RING_SLOT / 2, s.hi + off);
    if (++s.iss_c == s.cpw) {
      s.iss_c = 0;
      ++s.iss_u;
    }
  }
  ++s.iss;
  cp_async_commit();
}

// Start the copies of a GEMM over rows [0, U * ustride) of lo (and hi),
// columns [0, K) (the caller offsets lo/hi to a K segment); K % 64 == 0.
static __device__ __forceinline__ void gemm_begin(WStream& s, uint8_t* ring, const int8_t* lo,
                                  const int8_t* hi, size_t ldw, int ustride, int U, int K) {
  const int warp = threadIdx.x >> 5, nch = K / 64;
  s.lo = lo;
  s.hi = hi;
  s.ldw = ldw;
  s.ustride = ustride;
  s.nunits = U > (int)blockIdx.x ? (U - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  s.cpw = nch > warp ? (nch - warp + ENG_WARPS - 1) / ENG_WARPS : 0;
  s.total = s.nunits * s.cpw;
  s.iss = s.iss_u = s.iss_c = 0;
#pragma unroll
  for (int i = 0; i < RING_STAGES - 1; ++i) wstream_copy(s, ring);
}

// A plain (N, K) matrix: 16-row units when every block gets one, else 8-row.
static __device__ __forceinline__ void gemm_begin_plain(WStream& s, uint8_t* ring, const int8_t* w,
                                        size_t ldw, int N, int K) {
  const bool t16 = N % 16 == 0 && N / 16 >= (int)gridDim.x;
  gemm_begin(s, ring, w, t16 ? w + 8 * ldw : nullptr, ldw, t16 ? 16 : 8, N / (t16 ? 16 : 8), K);
}

// gate_up: rows [0, inter) gate and [inter, 2 inter) up; unit j holds gate
// rows 8j.. in the mma tile's rows 0-7 and up rows 8j.. in rows 8-15.
static __device__ __forceinline__ void gemm_begin_paired(WStream& s, uint8_t* ring, const int8_t* w,
                                         size_t ldw, int inter, int K) {
  gemm_begin(s, ring, w, w + (size_t)inter * ldw, ldw, 8, inter / 8, K);
}

enum { EPI_F32 = 0, EPI_RESID = 1, EPI_SILU = 2, EPI_PAIR_F32 = 3 };

// What happens to y = (float(acc) * xs[r]) * ws[n]:
//   EPI_F32      outf[r, n] = y
//   EPI_RESID    xout[r, n] = bf16(xres[r, n] + bf16(y))
//   EPI_SILU     (paired) prod[r, j] = bf16(silu(bf16(y_gate)) * bf16(y_up)),
//                and amax[r, j / seg] takes max |prod| (float bits, atomic)
//   EPI_PAIR_F32 (paired) outf[r, j] = y_gate, outf[r, hi_off + j] = y_up
struct Epi {
  int mode, ldo;
  const float *ws, *ws_hi;
  float* outf;
  int hi_off;
  const bf16* xres;
  bf16* xout;
  bf16* prod;
  int* amax;
  int seg, nseg;
};

// Row stride of K int8 columns staged in shared memory: 64 mod 128, so that
// the eight rows a quarter-warp reads 64 bytes of fall in distinct banks.
static __host__ __device__ __forceinline__ int act_stride(int K) {
  return K % 128 == 0 ? K + ACT_PAD : K;
}

// Consume the stream begun with gemm_begin against the B rows staged as
// int8 in xq_s (row stride `stride`, scales mi->xs), all units of this block.
static __device__ __forceinline__ void gemm_run(WStream& s, const EngSmem& sm,
                                                const int8_t* xq_s, int stride, int B,
                                                const Epi& e) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tig = lane & 3;
  const int nbt = (B + 7) >> 3;
  const bool tile16 = s.hi != nullptr;
  const bool paired = e.mode >= EPI_SILU;
  __syncthreads();   // the rows are staged; the previous call's epilogue is over
  int i = 0;
  for (int ui = 0; ui < s.nunits; ++ui) {
    int acc[4][4];
#pragma unroll
    for (int bt = 0; bt < 4; ++bt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[bt][k] = 0;
    for (int ci = 0; ci < s.cpw; ++ci, ++i) {
      cp_async_wait<RING_STAGES - 2>();
      const uint8_t* slot =
          sm.ring + (warp * RING_STAGES + i % RING_STAGES) * RING_SLOT + lane * 16;
      const int4 wl = *reinterpret_cast<const int4*>(slot);
      int4 wh = make_int4(0, 0, 0, 0);
      if (tile16) wh = *reinterpret_cast<const int4*>(slot + RING_SLOT / 2);
      const int8_t* xp = xq_s + (size_t)gq * stride + (warp + ci * ENG_WARPS) * 64 + tig * 16;
#pragma unroll
      for (int bt = 0; bt < 4; ++bt) {
        if (bt < nbt) {
          const int4 xv = *reinterpret_cast<const int4*>(xp + (size_t)bt * 8 * stride);
          mma_s8(acc[bt], wl.x, wh.x, wl.y, wh.y, xv.x, xv.y);
          mma_s8(acc[bt], wl.z, wh.z, wl.w, wh.w, xv.z, xv.w);
        }
      }
      wstream_copy(s, sm.ring);
    }
    int* A = sm.acc + (ui & 1) * (ENG_MAX_ROWS * 16);
#pragma unroll
    for (int bt = 0; bt < 4; ++bt) {
      if (bt < nbt) {
        const int r0 = bt * 8 + tig * 2;
        atomicAdd(&A[r0 * 16 + gq], acc[bt][0]);
        atomicAdd(&A[(r0 + 1) * 16 + gq], acc[bt][1]);
        if (tile16) {
          atomicAdd(&A[r0 * 16 + gq + 8], acc[bt][2]);
          atomicAdd(&A[(r0 + 1) * 16 + gq + 8], acc[bt][3]);
        }
      }
    }
    __syncthreads();
    // Epilogue: thread (r, i16) owns the sum of batch row r and tile row i16
    // (paired: of tile rows i16 and i16 + 8) and clears it for the unit
    // after the next; the other half of the buffers is in use meanwhile.
    const int t = threadIdx.x;
    if (t < nbt * 8 * 16) {
      const int r = t >> 4, i16 = t & 15;
      const int u = blockIdx.x + ui * gridDim.x;
      const bool own = i16 < 8 || (tile16 && !paired);
      int a = 0, a2 = 0;
      if (own) {
        a = A[r * 16 + i16];
        A[r * 16 + i16] = 0;
        if (paired) {
          a2 = A[r * 16 + i16 + 8];
          A[r * 16 + i16 + 8] = 0;
        }
      }
      const bool act = own && r < B;
      float pabs = 0.f;
      if (act) {
        const float xsr = sm.mi->xs[r];
        if (!paired) {
          const int n = u * s.ustride + i16;
          const float y = ((float)a * xsr) * e.ws[n];
          const size_t o = (size_t)r * e.ldo + n;
          if (e.mode == EPI_F32)
            e.outf[o] = y;
          else
            e.xout[o] = __float2bfloat16_rn(bf(__ldcg(e.xres + o)) + bf16r(y));
        } else {
          const int j = u * 8 + i16;
          const float yg = ((float)a * xsr) * e.ws[j];
          const float yu = ((float)a2 * xsr) * e.ws_hi[j];
          if (e.mode == EPI_PAIR_F32) {
            e.outf[(size_t)r * e.ldo + j] = yg;
            e.outf[(size_t)r * e.ldo + e.hi_off + j] = yu;
          } else {
            const float gv = bf16r(yg), uv = bf16r(yu);
            const float p = bf16r((gv * (1.f / (1.f + expf(-gv)))) * uv);
            e.prod[(size_t)r * e.ldo + j] = __float2bfloat16_rn(p);
            pabs = fabsf(p);
          }
        }
      }
      if (e.mode == EPI_SILU) {   // the 8 columns of a (row, unit) lie in one segment
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) pabs = fmaxf(pabs, __shfl_xor_sync(FULL_MASK, pabs, o));
        if (act && i16 == 0)
          atomicMax(&e.amax[r * e.nseg + (u * 8) / e.seg], __float_as_int(pabs));
      }
    }
  }
  cp_async_wait<0>();
}

// Eight norm weights (32-byte aligned) in two loads.
static __device__ __forceinline__ void load_w8(const float* w, float (&out)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(w);
  const float4 b = *reinterpret_cast<const float4*>(w + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// The three steps of quant_rows over one 8-column vector v8 of a row.
static __device__ __forceinline__ float qr_sumsq(const uint4& v8) {
  const bf16* v = reinterpret_cast<const bf16*>(&v8);
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float f = bf(v[k]);
    ss += f * f;
  }
  return ss;
}

// y = bf16((x * rinv) * w) with w, else x
static __device__ __forceinline__ void qr_values(const uint4& v8, const float* __restrict__ w8,
                                                 float rinv, float (&y)[8]) {
  const bf16* v = reinterpret_cast<const bf16*>(&v8);
  if (w8) {
    float wv[8];
    load_w8(w8, wv);
#pragma unroll
    for (int k = 0; k < 8; ++k) y[k] = bf16r((bf(v[k]) * rinv) * wv[k]);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) y[k] = bf(v[k]);
  }
}

static __device__ __forceinline__ float qr_amax(const uint4& v8, const float* __restrict__ w8,
                                                float rinv) {
  float y[8], amax = 0.f;
  qr_values(v8, w8, rinv, y);
#pragma unroll
  for (int k = 0; k < 8; ++k) amax = fmaxf(amax, fabsf(y[k]));
  return amax;
}

static __device__ __forceinline__ uint2 qr_quant(const uint4& v8, const float* __restrict__ w8,
                                                 float rinv, float s, float rs) {
  float y[8];
  qr_values(v8, w8, rinv, y);
  unsigned q[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < 8; ++k)
    q[k >> 2] |= quant_fast(y[k], s, rs) << (8 * (k & 3));
  return make_uint2(q[0], q[1]);
}

// Quantise B x nseg activation rows of K bf16 columns once for the grid:
// block b takes the (row, segment) items b, b + grid, ... (segment c of row r
// at src + r * ld + c * K; with w: nseg = 1), one 8-column vector a thread (K
// <= 4096). With w the row is RMS-normalised first, y = bf16((x * rinv) * w).
// The scale is the row's own max |y| / 127, or, with amax_bits, that
// gathered maximum (float bits, amax_bits[r * nseg + c]). The int8 row goes
// to xq_g (row stride ldq), its scale to xs_g[r * nseg + c]; after a grid
// barrier load_rows brings them into every block. (Every block quantising
// every row itself saved that barrier and measured slower from 2 rows on:
// ~1 us a row of instructions, 132 times over, against ~5 us flat.)
static __device__ __noinline__ void quant_rows(const bf16* src, int ld, int K,
                                                    const float* __restrict__ w, float eps,
                                                    const int* amax_bits, int nseg, int B,
                                                    int8_t* xq_g, int ldq, float* xs_g,
                                                    EngMisc* mi) {
  const int tid = threadIdx.x, nv = K / 8;
  for (int item = blockIdx.x; item < B * nseg; item += gridDim.x) {
    const int r = item / nseg, c = item - r * nseg;
    uint4 v8 = make_uint4(0u, 0u, 0u, 0u);
    if (tid < nv)
      v8 = __ldcg(reinterpret_cast<const uint4*>(src + (size_t)r * ld + (size_t)c * K) + tid);
    const float* w8 = w && tid < nv ? w + tid * 8 : nullptr;
    float rinv = 1.f;
    if (w) rinv = 1.f / sqrtf(block_reduce<false>(qr_sumsq(v8), mi->red) / (float)K + eps);
    float amax;
    if (amax_bits)
      amax = __int_as_float(__ldcg(amax_bits + item));
    else
      amax = block_reduce<true>(tid < nv ? qr_amax(v8, w8, rinv) : 0.f, mi->red);
    const float s = fmaxf(amax / 127.f, 1e-12f), rs = 1.f / s;
    if (tid < nv)
      *reinterpret_cast<uint2*>(xq_g + (size_t)r * ldq + (size_t)c * K + tid * 8) =
          qr_quant(v8, w8, rinv, s, rs);
    if (tid == 0) xs_g[item] = s;
  }
}

// Bring B rows of K int8 columns that quant_rows left in xq_g (row stride
// ldq), and their scales xs_g[r * xs_ld], into shared memory: the rows at
// stride `stride` (act_stride), the scales in mi->xs. K % 16 == 0.
static __device__ void load_rows(const int8_t* xq_g, int ldq, int K, int B, const float* xs_g,
                                 int xs_ld, int8_t* xq_s, int stride, EngMisc* mi) {
  const int tid = threadIdx.x, nv = K / 16, total = B * nv;
  __syncthreads();   // the previous call's readers of the rows and scales are done
  for (int vid = tid; vid < total; vid += ENG_THREADS) {
    const int r = vid / nv, j = vid - r * nv;
    cp_async16(xq_s + (size_t)r * stride + j * 16, xq_g + (size_t)r * ldq + j * 16);
  }
  cp_async_commit();
  if (tid < B) mi->xs[tid] = __ldcg(xs_g + (size_t)tid * xs_ld);
  cp_async_wait<0>();   // the weights' stages in flight too; the GEMM stage's barrier follows
}

// Copy B rows of K bf16 values (src, row stride ld, written earlier in this
// launch) into shared memory, row stride dst_ld. K and dst_ld % 8 == 0.
static __device__ void stage_rows(const bf16* src, int ld, int K, int B, bf16* dst, int dst_ld) {
  const int nv = K / 8, total = B * nv;
  for (int vid = threadIdx.x; vid < total; vid += ENG_THREADS) {
    const int r = vid / nv, jv = vid - r * nv;
    reinterpret_cast<uint4*>(dst + (size_t)r * dst_ld)[jv] =
        __ldcg(reinterpret_cast<const uint4*>(src + (size_t)r * ld) + jv);
  }
}

// RMSNorm of one row by one warp, y = (x * rinv) * w in f32: to outf (not
// rounded) and/or outb (bf16). K % 8 == 0.
static __device__ void warp_norm_row(const bf16* xr, int K, const float* w, float eps,
                                     float* outf, bf16* outb) {
  const int lane = threadIdx.x & 31;
  float ss = 0.f;
  for (int j = lane * 8; j < K; j += 256) {
    const uint4 v8 = __ldcg(reinterpret_cast<const uint4*>(xr + j));
    const bf16* v = reinterpret_cast<const bf16*>(&v8);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float f = bf(v[k]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  const float rinv = 1.f / sqrtf(ss / (float)K + eps);
  for (int j = lane * 8; j < K; j += 256) {
    const uint4 v8 = __ldcg(reinterpret_cast<const uint4*>(xr + j));
    const bf16* v = reinterpret_cast<const bf16*>(&v8);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float y = (bf(v[k]) * rinv) * w[j + k];
      if (outf) outf[j + k] = y;
      if (outb) outb[j + k] = __float2bfloat16_rn(y);
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16-weight GEMM stage (the sub-talker's projection and lm heads)
// ---------------------------------------------------------------------------

// Row strides (in elements) of the rows staged for gemm_bf16w, chosen so that
// the eight rows a quarter-warp reads fall in distinct banks.
static __host__ __device__ __forceinline__ int bf16w_stride(int K, bool f32_rows) {
  return f32_rows ? K + 4 : K + 32;
}
#define BF16W_PART_BYTES (ENG_WARPS * ENG_MAX_ROWS * 8 * 4)   // the warps' partial sums

static __device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// y[r, n] = sum_k x[r, k] * float(w[n, k]) (+ bias[n]) in f32 for the B rows
// staged in shared memory (x_s, row stride bf16w_stride, XT bf16 or f32); w is
// (N, K) bf16, N % 8 == 0, K % 32 == 0. The same stream as the W8A8 stage, in
// 8-column units (unit j = columns 8j..8j+7; block b takes units b, b + grid,
// ...): the 16 warps split K in 64-byte chunks through the cp.async ring and
// multiply on the bf16 tensor cores (mma.sync m16n8k16, f32 accumulation,
// the 8 weight rows in half of the 16-row operand). bf16 rows go in as they
// are; f32 rows as three bf16 terms (x = hi + mid + lo exactly), so the
// products are those of the f32 row. The warps' partial sums meet in shared
// memory (`part`, BF16W_PART_BYTES) and are added in warp order: the result
// does not depend on timing.
template <typename XT>
static __device__ __noinline__ void gemm_bf16w(const XT* x_s, int B, int K,
                                               const bf16* __restrict__ w,
                                               const float* __restrict__ bias, int N,
                                               float* outf, bf16* outb, int ldo,
                                               const EngSmem& sm, float* part) {
  constexpr bool F32 = sizeof(XT) == 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tig = lane & 3;
  const int nbt = (B + 7) >> 3, stride = bf16w_stride(K, F32);
  WStream s;
  gemm_begin(s, sm.ring, reinterpret_cast<const int8_t*>(w), nullptr, (size_t)K * 2, 8, N / 8,
             K * 2);
  __syncthreads();   // the rows are staged
  int i = 0;
  for (int ui = 0; ui < s.nunits; ++ui) {
    float acc[4][4];
#pragma unroll
    for (int bt = 0; bt < 4; ++bt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[bt][k] = 0.f;
    for (int ci = 0; ci < s.cpw; ++ci, ++i) {
      cp_async_wait<RING_STAGES - 2>();
      const uint4 wl = *reinterpret_cast<const uint4*>(
          sm.ring + (warp * RING_STAGES + i % RING_STAGES) * RING_SLOT + lane * 16);
      const XT* xp = x_s + (size_t)gq * stride + (warp + ci * ENG_WARPS) * 32 + tig * 8;
#pragma unroll
      for (int bt = 0; bt < 4; ++bt) {
        if (bt < nbt) {
          const XT* xr = xp + (size_t)bt * 8 * stride;
          if constexpr (F32) {
            const float4 xa = *reinterpret_cast<const float4*>(xr);
            const float4 xb = *reinterpret_cast<const float4*>(xr + 4);
            float x[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
            for (int term = 0; term < 3; ++term) {
              unsigned b[4];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                b[k] = pack_bf16x2(x[2 * k], x[2 * k + 1]);
                x[2 * k] -= bf16r(x[2 * k]);   // what this term leaves for the next
                x[2 * k + 1] -= bf16r(x[2 * k + 1]);
              }
              mma_bf16(acc[bt], wl.x, 0u, wl.y, 0u, b[0], b[1]);
              mma_bf16(acc[bt], wl.z, 0u, wl.w, 0u, b[2], b[3]);
            }
          } else {
            const uint4 xv = *reinterpret_cast<const uint4*>(xr);
            mma_bf16(acc[bt], wl.x, 0u, wl.y, 0u, xv.x, xv.y);
            mma_bf16(acc[bt], wl.z, 0u, wl.w, 0u, xv.z, xv.w);
          }
        }
      }
      wstream_copy(s, sm.ring);
    }
#pragma unroll
    for (int bt = 0; bt < 4; ++bt) {
      if (bt < nbt) {   // acc[bt][0], [1]: weight row gq, batch rows bt * 8 + 2 tig, + 1
        float* pr = part + ((size_t)warp * ENG_MAX_ROWS + bt * 8 + tig * 2) * 8 + gq;
        pr[0] = acc[bt][0];
        pr[8] = acc[bt][1];
      }
    }
    __syncthreads();
    const int t = threadIdx.x;
    if (t < nbt * 8 * 8) {
      const int r = t >> 3, n = (blockIdx.x + ui * gridDim.x) * 8 + (t & 7);
      float y = 0.f;
      for (int wq = 0; wq < ENG_WARPS; ++wq)
        y += part[((size_t)wq * ENG_MAX_ROWS + r) * 8 + (t & 7)];
      if (bias) y += bias[n];
      if (r < B) {
        if (outf) outf[(size_t)r * ldo + n] = y;
        if (outb) outb[(size_t)r * ldo + n] = __float2bfloat16_rn(y);
      }
    }
    __syncthreads();   // part is rewritten by the next unit
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Stage (ii): QK-norm, RoPE, the cache store and the attention
// ---------------------------------------------------------------------------

// One layer's KV cache. A bf16 cache: kc/vc are bf16 (B, kvh, S_buf, D) and
// ks is NULL. An int8 cache: kc/vc are int8, ks/vs the f32 (B, kvh, S_buf)
// scale planes.
struct KVPtrs {
  void *kc, *vc;
  float *ks, *vs;
};

static __host__ __device__ inline KVPtrs kv_layer(const KVPtrs& kv, int li,
                                                  size_t layer_slots, int D) {
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
static __device__ void store_kv(void* cache, float* scales, size_t row, int S_buf, int sl,
                                int D, int d, float val, bool active, float* red) {
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
  ((int8_t*)cache)[(row * S_buf + sl) * D + d] = quant_one(x, s);
  if (d == 0) scales[row * S_buf + sl] = s;
}

struct AttnParams {
  int B, heads, kvh, D;
  float eps, scale;
  const float* qkv;            // (B, (heads + 2 kvh) D) f32, stage (i)'s output
  const float *qn, *kn;        // (D,) norm weights
  const float *cosr, *sinr;    // row b at b * cs_ld (0: one row for all)
  int cs_ld;
  KVPtrs kv;                   // this layer's cache
  int S_buf, S_att, window;
  const int* ci;               // (B,) slot written this step (talker)
  const uint8_t* valid;        // (B, ld_valid)
  int ld_valid;
  int sub_pos;                 // >= 0: the sub-talker at this position
  int splits, cps;             // talker: window splits, 128-slot chunks per split
  float* part_ml;              // (B kvh splits, G, 2) partial max and sum
  float* part_acc;             // (B kvh splits, G, D) partial P.V
  unsigned* cnt;               // (B kvh) arrivals, zero between layers
  bf16* out;                   // (B, heads D)
};

// Floats of shared memory attn_stage wants at `fs`.
static __host__ __device__ inline size_t attn_smem_floats(int G, int D) {
  return (size_t)((G + 2) + (ENG_THREADS / D) * G) * D + (size_t)G * ATT_CHUNK;
}

// Work items (row b, KV head h, split sp), dealt round robin over the blocks.
// Every item: QK-RMSNorm and RoPE of the G query heads of h and of the fresh
// K row, in f32 from the qkv projection; q, k, v round to bf16. Split 0
// stores K/V into the cache at the row's slot.
//
// Talker (sub_pos < 0): the item attends the 128-slot chunks [sp cps, (sp +
// 1) cps) of the window as the reference's online softmax (slots j < ci[b],
// valid, inside the sliding window; per chunk m' = max(m, max s), e =
// bf16(exp(s - m')), l = l exp(m - m') + sum e, acc = acc exp(m - m') + e.v;
// int8 cache: s = (q . k_int8) k_scale[j] D^-0.5 and the P.V weight is
// bf16(e v_scale[j]) against v_int8). With one split the item goes on to the
// finalize. With more, it leaves (m, l, acc) in global memory and counts its
// arrival; the last of an (b, h) to arrive folds the partials in split order
// (m' = max(m_a, m_b), l = l_a exp(m_a - m') + l_b exp(m_b - m'), acc
// likewise) and finalizes: the fresh K/V in bf16, e_new = bf16(exp(s_new -
// m_tot)), o = (acc c + e_new v_new) / (l c + e_new), c = exp(m - m_tot).
// Thread t scores slot t / 4 of a chunk over a quarter of D (16-byte
// vectors, interleaved over the four lanes), warp g runs head g's softmax
// update, and thread t sums P.V for column t % D over a 1 / (ENG_THREADS / D)
// share of the chunk's slots. D is 64 or 128, G at most ATT_MAX_G = 2 (both
// released talkers and code predictors), so (G + 2) D <= ENG_THREADS.
//
// Sub-talker (sub_pos >= 0, bf16 cache): slots 0..sub_pos, one plain softmax
// p = bf16(exp(s - m) / sum exp(s - m)), o = sum p.v.
template <typename KV>  // bf16: a bf16 cache; int8_t: an int8 cache with scales
static __device__ __noinline__ void attn_stage(const AttnParams& p, float* fs, EngMisc* mi) {
  constexpr bool Q8 = sizeof(KV) == 1;
  constexpr int VE = Q8 ? 16 : 8;   // cache elements per 16-byte vector
  const int D = p.D, G = p.heads / p.kvh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool sub = p.sub_pos >= 0;
  const int splits = sub ? 1 : p.splits;
  const int nq = p.heads * D, nkv = p.kvh * D;
  float* vec = fs;                       // q heads, k, v of the item
  float* sc = vec + (G + 2) * D;         // (G, ATT_CHUNK) scores, then weights
  float* accp = sc + G * ATT_CHUNK;      // (ENG_THREADS / D, G, D) P.V partials
  const int ngrp = ENG_THREADS / D, spg = ATT_CHUNK / ngrp;
  const int d_own = tid % D, grp = tid / D;
  const int nitems = p.B * p.kvh * splits;
  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    const int bh = item / splits, sp = item % splits;
    const int b = bh / p.kvh, h = bh % p.kvh;
    __syncthreads();   // the previous item is done with fs and mi
    // warp w takes vector w of the item (the G query heads, then k, then v):
    // lane l holds elements l, l + 32, ..., so a rotation partner (d +- D/2)
    // sits in the same lane, and norm and RoPE need no block barrier
    const int sl = sub ? p.sub_pos : p.ci[b];
    if (warp < G + 2) {
      const int w = warp, ne = D / 32;   // ne is 2 or 4
      const int off = w < G ? (h * G + w) * D : (w == G ? nq + h * D : nq + nkv + h * D);
      const float* src = p.qkv + (size_t)b * (nq + 2 * nkv) + off;
      float raw[4], y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) raw[e] = e < ne ? __ldcg(src + lane + 32 * e) : 0.f;
      if (w <= G) {
        const float* nw = w < G ? p.qn : p.kn;
        const float* cr = p.cosr + (size_t)b * p.cs_ld;
        const float* sr = p.sinr + (size_t)b * p.cs_ld;
        float nv[4], cv[4], sv[4], ss = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = lane + 32 * e;
          nv[e] = e < ne ? nw[d] : 0.f;
          cv[e] = e < ne ? cr[d] : 0.f;
          sv[e] = e < ne ? sr[d] : 0.f;
          ss += raw[e] * raw[e];
        }
        const float rinv = 1.f / sqrtf(warp_sum(ss) / (float)D + p.eps);
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = (raw[e] * rinv) * nv[e];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (e < ne) {
            // the partner's index is static after unrolling: e +- 2 of 4, or the other of 2
            const float rot = ne == 4 ? (e < 2 ? -y[(e + 2) & 3] : y[(e + 2) & 3])
                                      : (e == 0 ? -y[1] : y[0]);
            const float o = y[e] * cv[e] + rot * sv[e];
            vec[w * D + lane + 32 * e] = w < G ? bf16r(o) : o;   // k is rounded by the store
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < ne) vec[w * D + lane + 32 * e] = raw[e];
      }
    }
    __syncthreads();
    if (sp == 0) {
      const bool active = tid < D;
      store_kv(p.kv.kc, p.kv.ks, bh, p.S_buf, sl, D, tid, active ? vec[G * D + tid] : 0.f,
               active, mi->red);
      store_kv(p.kv.vc, p.kv.vs, bh, p.S_buf, sl, D, tid,
               active ? vec[(G + 1) * D + tid] : 0.f, active, mi->red);
    }
    __syncthreads();
    if (tid < 2 * D) vec[G * D + tid] = bf16r(vec[G * D + tid]);
    __syncthreads();
    const float* kn_s = vec + G * D;
    const float* vn_s = vec + (G + 1) * D;
    bf16* ob = p.out + (size_t)b * nq + (size_t)(h * G) * D;

    if (sub) {
      const int n = p.sub_pos + 1;
      const bf16* kb = (const bf16*)p.kv.kc + (size_t)bh * p.S_buf * D;
      const bf16* vb = (const bf16*)p.kv.vc + (size_t)bh * p.S_buf * D;
      // the slots' V column of this thread, asked for with the K rows
      const int og = tid / D, od = tid % D;   // output (head, column), og < G
      float vv[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        vv[j] = og < G && j < n ? bf(__ldcg(vb + (size_t)j * D + od)) : 0.f;
      // scores: lane l of a warp takes four columns of the (head, slot)
      // pairs warp, warp + 16 (G n <= 32 pairs)
      uint2 kk[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int pr = warp + u * ENG_WARPS;
        if (pr < G * n && lane * 4 < D)
          kk[u] = __ldcg(reinterpret_cast<const uint2*>(kb + (size_t)(pr % n) * D) + lane);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int pr = warp + u * ENG_WARPS;
        if (pr < G * n) {   // warp-uniform
          const int g = pr / n, j = pr % n;
          float dot = 0.f;
          if (lane * 4 < D) {
            const bf16* kv = reinterpret_cast<const bf16*>(&kk[u]);
#pragma unroll
            for (int e = 0; e < 4; ++e) dot += vec[g * D + lane * 4 + e] * bf(kv[e]);
          }
          dot = warp_sum(dot);
          if (lane == 0) sc[g * ATT_CHUNK + j] = dot * p.scale;
        }
      }
      __syncthreads();
      if (warp < G) {   // head `warp`: lane j holds slot j (n <= 16)
        const float sj = lane < n ? sc[warp * ATT_CHUNK + lane] : -INFINITY;
        const float m = warp_max(sj);
        const float e = lane < n ? expf(sj - m) : 0.f;
        const float sum = warp_sum(e);
        if (lane < n) sc[warp * ATT_CHUNK + lane] = bf16r(e / sum);
      }
      __syncthreads();
      if (og < G) {
        float o = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (j < n) o += sc[og * ATT_CHUNK + j] * vv[j];
        ob[tid] = __float2bfloat16_rn(o);
      }
      continue;
    }

    const int cib = sl;
    const KV* __restrict__ kb = (const KV*)p.kv.kc + (size_t)bh * p.S_buf * D;
    const KV* __restrict__ vb = (const KV*)p.kv.vc + (size_t)bh * p.S_buf * D;
    const float* __restrict__ ksb = Q8 ? p.kv.ks + (size_t)bh * p.S_buf : nullptr;
    const float* __restrict__ vsb = Q8 ? p.kv.vs + (size_t)bh * p.S_buf : nullptr;
    if (tid < ATT_MAX_G) {
      mi->m[tid] = NEG_INF_F;
      mi->l[tid] = 0.f;
    }
    float acc[ATT_MAX_G];
#pragma unroll
    for (int g = 0; g < ATT_MAX_G; ++g) acc[g] = 0.f;
    const int nchunks = (p.S_att + ATT_CHUNK - 1) / ATT_CHUNK;
    const int c_hi = min(nchunks, (sp + 1) * p.cps);
    __syncthreads();
    ENG_MARK();
    for (int c = sp * p.cps; c < c_hi; ++c) {
      const int c0 = c * ATT_CHUNK;
      if (c0 >= cib) break;   // every later slot is masked
      const int cend = min(c0 + ATT_CHUNK, p.S_att);
      // this thread's share of the chunk's V column d_own, asked for before
      // the scores so that it arrives with the K rows: one round trip a chunk
      float vf[ATT_CHUNK / 4];
#pragma unroll
      for (int u = 0; u < ATT_CHUNK / 4; ++u) {
        const int s = grp * spg + u;
        vf[u] = u < spg && s < cend - c0 ? to_f(vb[(size_t)(c0 + s) * D + d_own]) : 0.f;
      }
      {  // scores: four lanes share slot c0 + tid / 4
        const int sj = tid >> 2, pq = tid & 3, j = c0 + sj;
        const bool ok = j < cend && j < cib && p.valid[(size_t)b * p.ld_valid + j] &&
                        (p.window <= 0 || j > cib - p.window);
        float part[ATT_MAX_G];
#pragma unroll
        for (int g = 0; g < ATT_MAX_G; ++g) part[g] = 0.f;
        if (ok) {
          const uint4* krow = reinterpret_cast<const uint4*>(kb + (size_t)j * D);
          uint4 k4[4];   // all of the row's loads first: one round trip
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (pq + 4 * u < D / VE) k4[u] = krow[pq + 4 * u];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int vi = pq + 4 * u;
            if (vi < D / VE) {
              const KV* kv = reinterpret_cast<const KV*>(&k4[u]);
#pragma unroll
              for (int e = 0; e < VE; ++e) {
                const float kf = to_f(kv[e]);
#pragma unroll
                for (int g = 0; g < ATT_MAX_G; ++g)
                  if (g < G) part[g] += vec[g * D + vi * VE + e] * kf;
              }
            }
          }
        }
        float ksj = 1.f;
        if constexpr (Q8) ksj = ok ? ksb[j] : 0.f;
#pragma unroll
        for (int g = 0; g < ATT_MAX_G; ++g) {
          if (g < G) {
            float s = part[g];
            s += __shfl_xor_sync(FULL_MASK, s, 1);
            s += __shfl_xor_sync(FULL_MASK, s, 2);
            if constexpr (Q8) s *= ksj;
            if (pq == 0) sc[g * ATT_CHUNK + sj] = ok ? s * p.scale : -INFINITY;
          }
        }
      }
      __syncthreads();
      for (int g = warp; g < G; g += ENG_WARPS) {   // head g's softmax update
        float sv[ATT_CHUNK / 32], cm = -INFINITY;
#pragma unroll
        for (int q = 0; q < ATT_CHUNK / 32; ++q) {
          sv[q] = sc[g * ATT_CHUNK + lane + 32 * q];
          cm = fmaxf(cm, sv[q]);
        }
        cm = warp_max(cm);
        if (cm == -INFINITY) {   // warp-uniform: nothing live in this chunk
          if (lane == 0) mi->live[g] = 0;
          continue;
        }
        const float m_old = mi->m[g], m_new = fmaxf(m_old, cm);
        const float corr = expf(m_old - m_new);
        float es = 0.f;
#pragma unroll
        for (int q = 0; q < ATT_CHUNK / 32; ++q) {
          const bool on = sv[q] != -INFINITY;
          const float e = on ? bf16r(expf(sv[q] - m_new)) : 0.f;
          es += e;
          float wgt = e;
          if constexpr (Q8) wgt = on ? bf16r(e * vsb[c0 + lane + 32 * q]) : 0.f;
          sc[g * ATT_CHUNK + lane + 32 * q] = wgt;
        }
        es = warp_sum(es);
        if (lane == 0) {
          mi->l[g] = mi->l[g] * corr + es;
          mi->m[g] = m_new;
          mi->corr[g] = corr;
          mi->live[g] = 1;
        }
      }
      __syncthreads();
      {  // P.V: column d_own over this thread's share of the chunk's slots
#pragma unroll
        for (int g = 0; g < ATT_MAX_G; ++g) {
          if (g < G && mi->live[g]) {
            float pv = 0.f;
#pragma unroll
            for (int u = 0; u < ATT_CHUNK / 4; ++u)
              if (u < spg) pv += sc[g * ATT_CHUNK + grp * spg + u] * vf[u];
            acc[g] = acc[g] * mi->corr[g] + pv;
          }
        }
      }
      __syncthreads();   // sc, live and corr are rewritten by the next chunk
    }
    ENG_MARK();
    // fold the slot shares: accp[0, G, D) becomes the item's P.V
#pragma unroll
    for (int g = 0; g < ATT_MAX_G; ++g)
      if (g < G) accp[(grp * G + g) * D + d_own] = acc[g];
    __syncthreads();
    for (int idx = tid; idx < G * D; idx += ENG_THREADS) {
      float a = accp[idx];
      for (int q = 1; q < ngrp; ++q) a += accp[q * G * D + idx];
      accp[idx] = a;
    }
    __syncthreads();
    if (splits > 1) {
      float* pml = p.part_ml + (size_t)item * G * 2;
      float* pac = p.part_acc + (size_t)item * G * D;
      for (int idx = tid; idx < G * D; idx += ENG_THREADS) pac[idx] = accp[idx];
      if (tid < G) {
        pml[tid * 2] = mi->m[tid];
        pml[tid * 2 + 1] = mi->l[tid];
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        const int last = atomicAdd(p.cnt + bh, 1u) == (unsigned)(splits - 1);
        if (last) p.cnt[bh] = 0;   // every split has arrived; the next layer starts at 0
        mi->flag = last;
      }
      __syncthreads();
      if (!mi->flag) continue;
      __threadfence();
      const float* ml0 = p.part_ml + (size_t)bh * splits * G * 2;
      const float* ac0 = p.part_acc + (size_t)bh * splits * G * D;
      for (int idx = tid; idx < G * D; idx += ENG_THREADS) {
        const int g = idx / D;
        float M = __ldcg(ml0 + g * 2), Lc = __ldcg(ml0 + g * 2 + 1), A = __ldcg(ac0 + idx);
        for (int s = 1; s < splits; ++s) {
          const float ms = __ldcg(ml0 + ((size_t)s * G + g) * 2);
          const float ls = __ldcg(ml0 + ((size_t)s * G + g) * 2 + 1);
          const float as = __ldcg(ac0 + (size_t)s * G * D + idx);
          const float mt = fmaxf(M, ms);
          const float wa = expf(M - mt), wb = expf(ms - mt);
          Lc = Lc * wa + ls * wb;
          A = A * wa + as * wb;
          M = mt;
        }
        accp[idx] = A;
        if (idx % D == 0) {
          mi->m[g] = M;
          mi->l[g] = Lc;
        }
      }
      __syncthreads();
    }
    for (int g = warp; g < G; g += ENG_WARPS) {   // the fresh slot's score
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += vec[g * D + d] * kn_s[d];
      dot = warp_sum(dot);
      if (lane == 0) mi->snew[g] = dot * p.scale;
    }
    __syncthreads();
    for (int idx = tid; idx < G * D; idx += ENG_THREADS) {
      const int g = idx / D, d = idx % D;
      const float M = mi->m[g], s_new = mi->snew[g];
      const float m_tot = fmaxf(M, s_new);
      const float c = expf(M - m_tot);
      const float e_new = bf16r(expf(s_new - m_tot));
      const float den = mi->l[g] * c + e_new;
      ob[idx] = __float2bfloat16_rn((accp[idx] * c + e_new * vn_s[d]) / den);
    }
  }
}

// ---------------------------------------------------------------------------
// One decoder layer
// ---------------------------------------------------------------------------

struct LayerWeights {  // one layer's slices of the stacked int8 tensors
  const int8_t *qkv_q, *o_q, *gu_q, *dn_q;
  const float *qkv_s, *o_s, *gu_s, *dn_s;
  const float *ln1, *ln2, *qn, *kn;  // norm weights, f32
};

struct LayerShape {
  int B, H, heads, kvh, D, inter, nseg;
  float eps;
};

// Global scratch of a launch. From `bar` on it is one zeroed region.
struct EngineScratch {
  float* qkv;        // (B, (heads + 2 kvh) D) f32
  bf16* o;           // (B, heads D)
  bf16* prod;        // (B, inter)
  float* part_ml;    // attention partials, see AttnParams
  float* part_acc;
  unsigned* bar;     // the grid barrier's word
  unsigned* cnt;     // (B kvh)
  int* amax;         // (layer instances, B, nseg) max |product|, float bits
  int8_t* xq_g;      // (B, max(H, heads D, inter)) rows quantised once for the grid
  float* xs_g;       // (B, nseg) their scales
};

static __host__ __device__ inline LayerWeights layer_slice(const LayerWeights& w, int li,
                                                           int H, int heads, int kvh, int D,
                                                           int inter) {
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

// Bytes of the `act` region one layer wants: the widest int8 rows, or the
// attention's floats.
static __host__ __device__ inline size_t layer_act_bytes(const LayerShape& s) {
  int kmax = s.H > s.heads * s.D ? s.H : s.heads * s.D;
  if (s.inter / s.nseg > kmax) kmax = s.inter / s.nseg;
  const size_t rows = (size_t)((s.B + 7) / 8 * 8) * act_stride(kmax);
  const size_t att = attn_smem_floats(s.heads / s.kvh, s.D) * sizeof(float);
  return rows > att ? rows : att;
}

// The five stages of one layer. xin is the residual the layer reads (the
// first layer's may be the caller's input), x the (B, H) stream it leaves
// updated. The copies of this layer's qkv weights must have been begun on
// `ws`; on return those of `next_qkv` (if any) are begun. `amax` is this
// layer instance's zeroed (B, nseg) block. Ends on a grid barrier.
template <typename KV>
static __device__ void engine_layer(const LayerShape& s, const LayerWeights& w,
                                    const int8_t* next_qkv, const bf16* xin, bf16* x,
                                    AttnParams& ap, const EngineScratch& t, int* amax,
                                    WStream& ws, const EngSmem& sm) {
  const int nq = s.heads * s.D, nqkv = (s.heads + 2 * s.kvh) * s.D, seg = s.inter / s.nseg;
  int8_t* xq = reinterpret_cast<int8_t*>(sm.act);
  Epi e{};
  // (i)
  ENG_MARK();
  quant_rows(xin, s.H, s.H, w.ln1, s.eps, nullptr, 1, s.B, t.xq_g, s.H, t.xs_g, sm.mi);
  grid_barrier(t.bar, &sm.mi->nth_barrier);
  load_rows(t.xq_g, s.H, s.H, s.B, t.xs_g, 1, xq, act_stride(s.H), sm.mi);
  ENG_MARK();
  e.mode = EPI_F32;
  e.ws = w.qkv_s;
  e.outf = t.qkv;
  e.ldo = nqkv;
  gemm_run(ws, sm, xq, act_stride(s.H), s.B, e);
  gemm_begin_plain(ws, sm.ring, w.o_q, nq, s.H, nq);
  ENG_MARK();
  grid_barrier(t.bar, &sm.mi->nth_barrier);
  ENG_MARK();
  // (ii)
  ap.qkv = t.qkv;
  ap.qn = w.qn;
  ap.kn = w.kn;
  ap.out = t.o;
  attn_stage<KV>(ap, reinterpret_cast<float*>(sm.act), sm.mi);
  ENG_MARK();
  grid_barrier(t.bar, &sm.mi->nth_barrier);
  ENG_MARK();
  // (iii)
  quant_rows(t.o, nq, nq, nullptr, 0.f, nullptr, 1, s.B, t.xq_g, nq, t.xs_g, sm.mi);
  grid_barrier(t.bar, &sm.mi->nth_barrier);
  load_rows(t.xq_g, nq, nq, s.B, t.xs_g, 1, xq, act_stride(nq), sm.mi);
  ENG_MARK();
  e.mode = EPI_RESID;
  e.ws = w.o_s;
  e.xres = xin;
  e.xout = x;
  e.ldo = s.H;
  gemm_run(ws, sm, xq, act_stride(nq), s.B, e);
  gemm_begin_paired(ws, sm.ring, w.gu_q, s.H, s.inter, s.H);
  ENG_MARK();
  grid_barrier(t.bar, &sm.mi->nth_barrier);
  ENG_MARK();
  // (iv)
  quant_rows(x, s.H, s.H, w.ln2, s.eps, nullptr, 1, s.B, t.xq_g, s.H, t.xs_g, sm.mi);
  grid_barrier(t.bar, &sm.mi->nth_barrier);
  load_rows(t.xq_g, s.H, s.H, s.B, t.xs_g, 1, xq, act_stride(s.H), sm.mi);
  ENG_MARK();
  e.mode = EPI_SILU;
  e.ws = w.gu_s;
  e.ws_hi = w.gu_s + s.inter;
  e.prod = t.prod;
  e.ldo = s.inter;
  e.amax = amax;
  e.seg = seg;
  e.nseg = s.nseg;
  gemm_run(ws, sm, xq, act_stride(s.H), s.B, e);
  gemm_begin_plain(ws, sm.ring, w.dn_q, s.inter, s.H, seg);
  ENG_MARK();
  grid_barrier(t.bar, &sm.mi->nth_barrier);
  ENG_MARK();
  // (v)
  e.mode = EPI_RESID;
  e.ws = w.dn_s;
  e.xres = x;
  e.xout = x;
  e.ldo = s.H;
  // every (row, segment) of the product at once
  quant_rows(t.prod, s.inter, seg, nullptr, 0.f, amax, s.nseg, s.B, t.xq_g, s.inter, t.xs_g,
             sm.mi);
  grid_barrier(t.bar, &sm.mi->nth_barrier);
  for (int c = 0; c < s.nseg; ++c) {
    load_rows(t.xq_g + (size_t)c * seg, s.inter, seg, s.B, t.xs_g + c, s.nseg, xq,
              act_stride(seg), sm.mi);
    ENG_MARK();
    gemm_run(ws, sm, xq, act_stride(seg), s.B, e);
    ENG_MARK();
    if (c + 1 < s.nseg)
      gemm_begin_plain(ws, sm.ring, w.dn_q + (size_t)(c + 1) * seg, s.inter, s.H, seg);
    else if (next_qkv)
      gemm_begin_plain(ws, sm.ring, next_qkv, s.H, nqkv, s.H);
  }
  grid_barrier(t.bar, &sm.mi->nth_barrier);
  ENG_MARK();
}

// ---------------------------------------------------------------------------
// Host side: the cooperative launch
// ---------------------------------------------------------------------------

// Launch `kernel(args)` with one block of ENG_THREADS per SM and `smem` bytes
// of dynamic shared memory, after zeroing the launch's zeroed scratch region
// on the stream (the barrier words among it: nothing is reset by the host).
// Any refusal (shared memory over the limit, no co-resident grid) comes back
// as its CUDA error: there is no other route. With launch false it only
// checks that the launch would fit and reports its grid.
template <typename Args>
static int engine_launch(void (*kernel)(Args), const Args* args, size_t smem, void* zero,
                         size_t zero_bytes, cudaStream_t st, int* grid_out, bool launch) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, ENG_THREADS,
                                                         smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (grid_out) *grid_out = sms;
  if (!launch) return 0;
  if (zero_bytes && (e = cudaMemsetAsync(zero, 0, zero_bytes, st)) != cudaSuccess)
    return (int)e;
  void* params[] = {const_cast<Args*>(args)};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(sms), dim3(ENG_THREADS), params,
                                  smem, st);
  return (int)e;
}
