// int8 x int8 -> int32 GEMM and int8 convolution (implicit GEMM) with a
// per-column dequantize epilogue, for sm_90a.
//
// Replaces the Pallas TPU kernel `_pallas_int8_matmul` of
// tools/bench_int8_matmul.py. It computes what `int8_matmul_reference` in
// ops/int8_matmul.py computes:
//
//   acc[m,n] = sum_k a[m,k] * w[n,k]                 (exact, in int32)
//   out[m,n] = out_t(f32(acc[m,n]) * scale[n] (+ bias[n]))
//
// with w int8 (N,K) K-contiguous, scale and bias f32 (N,), out bf16 or f32
// (M,N) row-major. The epilogue follows the JAX formulas step by step,
// each rounded to nearest even: int -> f32, the multiply, then the bias
// add (__fmul_rn / __fadd_rn, built with --fmad=false), then the cast.
//
// One kernel, two ways of feeding its A tile:
// * GEMM mode: a is an int8 (M,K) row-major matrix, K a multiple of 16;
//   TMA loads its tiles.
// * conv mode: a is the implicit patch matrix of an NHWC int8 activation
//   x (B,H,W,C), C a multiple of 16, for a square k x k conv of stride s
//   and zero padding p: row m = (b, ho, wo) is one output pixel, and the
//   16 bytes at K offset kk = (kh*k + kw)*C + c are
//   x[b, ho*s - p + kh, wo*s - p + kw, c .. c+15], zeros past the image
//   edge or past K. The producer warps gather them straight into the
//   swizzled tile with cp.async: no im2col copy is ever written. This is
//   `int8_conv_nhwc_reference` (im2col, then the GEMM), the function
//   JAX's lax.conv_general_dilated computes on s8 x s8 -> s32.
//
// What bounds it on an H100 (1,979 int8 TOP/s, 3.35 TB/s). GEMM mode does
// 2*N operations per byte of A it reads, under the card's ~590 operations
// per byte for N <= 256, so the bytes of A and of the output bound it;
// for a 3x3 conv on im2col patches A is 9x the activation. In conv mode A
// costs the activation's own bytes in device memory, which makes the
// N >= 256 head convs bound by the tensor cores' rate; but each input byte
// reaches shared memory once per tap, 9 times, from L2, and that traffic
// is what holds back the N = 64..128 convs.
//
// Design. 128 x BN output tiles, K in slices of 128 bytes, three
// warpgroups per block:
// * warpgroup 0 produces. In GEMM mode one thread issues the TMA loads of
//   the A and B slices. In conv mode its 128 threads gather A with 16-byte
//   cp.async (8 threads per 128-byte row, so a warp reads 4 rows of 128
//   contiguous bytes, 8 rows a thread), each thread's copies of a slice
//   counted on the slice's barrier as they land (cp.async.mbarrier.arrive
//   .noinc: no thread waits for its copies), and one thread loads B by
//   TMA. Slices go into a ring of 3 to 8 stages, each signalled full and
//   empty by mbarriers.
// * warpgroups 1 and 2 consume: each runs wgmma m64nBNk32 s8 x s8 -> s32
//   on its 64 rows of the tile, reading both operands from the 128-byte
//   swizzled stages (the layout TMA writes, and the conv gather writes by
//   hand; in conv mode a proxy fence after the barrier orders the gathered
//   bytes before the wgmma reads them), one slice's products in flight
//   while the next slice's are issued.
// * the epilogue dequantizes in registers; bf16 out with N a multiple of 8
//   goes through a swizzled tile in shared memory to TMA stores, which
//   write whole lines (from the fragments' scattered 4-byte stores the
//   stores took half the kernel's time), the rest by direct stores.
// * blocks are persistent (one per SM), walking tiles N fastest, so the
//   producer loads the next tile while the consumers store this one, and
//   the blocks that share an A tile run together.
// * the wrapper chooses BN per call (ops/int8_matmul.py `tile_plan`): 64
//   for N <= 64, else 128 in GEMM mode (more stages in flight) and 256 in
//   conv mode for N > 128 (fewer N tiles, each of which gathers A anew);
//   narrower when the tiles would fill at most half the SMs, and for a
//   long K then split K: each split adds its exact int32 partial sums into
//   a zeroed (M,N) buffer with integer atomics (exact in any order) and
//   one more kernel applies the epilogue, so the result is bit-identical.
// TMA zero-fills rows past M and N and columns past K. K is at most
// 131071, so |acc| <= K * 128 * 128 < 2^31 cannot overflow.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;             // rows of a tile: two consumer warpgroups of 64
constexpr int BK = 128;             // bytes of K per stage: one swizzled 128-byte row
constexpr int THREADS = 384;        // producer warpgroup + two consumer warpgroups
constexpr int A_STAGE = BM * BK;    // bytes
constexpr int MAX_K = 131071;
constexpr int SMEM_MAX = 232448;    // shared memory a block may use on sm_90

template <int BN> struct Cfg {
  static constexpr int B_STAGE = BN * BK;
  static constexpr int OUT_TILE = BM * BN * 2;    // a bf16 tile staged for the TMA store
  static constexpr int FIT = (SMEM_MAX - OUT_TILE - 1024 - 256) / (A_STAGE + B_STAGE);
  static constexpr int STAGES = FIT < 8 ? FIT : 8;                  // 3, 6 or 8
  static constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) + OUT_TILE + 1024 + 2 * STAGES * 8;
  static_assert(B_STAGE % 1024 == 0 && OUT_TILE % 1024 == 0,
                "swizzled tiles start at multiples of 1024 bytes");
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};

struct Params {
  int M, N, K;
  int k_tiles, k_per_split, splits, tiles_m, tiles_n;
  const float* scale;
  const float* bias;       // or null
  void* out;               // bf16 or f32 (M,N); unused when splitting K
  int out_f32;
  int store_tma;           // bf16 out through shared memory and TMA stores
  int* partial;            // split K: zeroed int32 (M,N) sums, else null
  // conv mode
  const int8_t* x;         // (B,H,W,C)
  int H, W, C, Ho, Wo, ksize, stride, pad;
};

__device__ __forceinline__ float dequant(int acc, float scale, float bias, bool has_bias) {
  float v = __fmul_rn(__int2float_rn(acc), scale);
  return has_bias ? __fadd_rn(v, bias) : v;
}

__device__ __forceinline__ void store2(__nv_bfloat16* out, size_t idx, float v0, float v1,
                                       bool ok0, bool ok1, bool paired) {
  if (paired && ok1) {
    *reinterpret_cast<__nv_bfloat162*>(out + idx) =
        __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
    return;
  }
  if (ok0) out[idx] = __float2bfloat16_rn(v0);
  if (ok1) out[idx + 1] = __float2bfloat16_rn(v1);
}

__device__ __forceinline__ void store2(float* out, size_t idx, float v0, float v1,
                                       bool ok0, bool ok1, bool paired) {
  if (paired && ok1) {
    *reinterpret_cast<float2*>(out + idx) = make_float2(v0, v1);
    return;
  }
  if (ok0) out[idx] = v0;
  if (ok1) out[idx + 1] = v1;
}

// The consumer warpgroup's finished 64 x BN tile -> bf16 in shared memory
// (boxes of 64 rows x 128 bytes in the 128-byte swizzle, so that the
// fragment's 4-byte writes hit 32 distinct banks) -> TMA stores, which
// write whole lines and clip the ragged edges. `stage` is the
// warpgroup's part of the staging area, its stores' previous use done.
template <int BN>
__device__ __forceinline__ void epilogue_tma(const int (&acc)[BN / 2], const Params& p,
                                             const CUtensorMap* map_out, uint32_t stage,
                                             int cw, int warp, int lane, int m0, int n0) {
  const bool has_bias = p.bias != nullptr;
  const int g = lane / 4, t = lane % 4;
  if (threadIdx.x % 128 == 0) tma_store_wait_read();   // the last tile's stores read `stage`
  named_barrier(1 + cw, 128);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    const bool ok0 = n < p.N, ok1 = n + 1 < p.N;
    const float s0 = ok0 ? p.scale[n] : 0.0f, s1 = ok1 ? p.scale[n + 1] : 0.0f;
    const float b0 = (has_bias && ok0) ? p.bias[n] : 0.0f;
    const float b1 = (has_bias && ok1) ? p.bias[n + 1] : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;   // r % 8 == g
      __nv_bfloat162 v = __halves2bfloat162(
          __float2bfloat16_rn(dequant(acc[4 * j + 2 * h], s0, b0, has_bias)),
          __float2bfloat16_rn(dequant(acc[4 * j + 2 * h + 1], s1, b1, has_bias)));
      st_shared_u32(stage + (j / 8) * 8192 + r * 128 + (((j % 8) ^ g) << 4) + 4 * t,
                    *reinterpret_cast<uint32_t*>(&v));
    }
  }
  fence_proxy_async();
  named_barrier(1 + cw, 128);
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int b = 0; b < BN / 64; ++b)
      tma_store_2d(map_out, stage + b * 8192, n0 + 64 * b, m0 + 64 * cw);
    tma_store_commit();
  }
}

// the consumer thread's fragment of a finished 64 x BN tile -> out
template <int BN, typename OutT>
__device__ __forceinline__ void epilogue(const int (&acc)[BN / 2], const Params& p,
                                         long m_base, int n_base) {
  OutT* out = static_cast<OutT*>(p.out);
  const bool has_bias = p.bias != nullptr;
  const bool paired = (p.N % 2) == 0;   // 2-element stores stay aligned
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n_base + 8 * j;
    const bool ok0 = n < p.N, ok1 = n + 1 < p.N;
    const float s0 = ok0 ? p.scale[n] : 0.0f, s1 = ok1 ? p.scale[n + 1] : 0.0f;
    const float b0 = (has_bias && ok0) ? p.bias[n] : 0.0f;
    const float b1 = (has_bias && ok1) ? p.bias[n + 1] : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long m = m_base + 8 * h;
      if (m >= p.M) continue;
      store2(out, size_t(m) * p.N + n, dequant(acc[4 * j + 2 * h], s0, b0, has_bias),
             dequant(acc[4 * j + 2 * h + 1], s1, b1, has_bias), ok0, ok1, paired);
    }
  }
}

template <int BN>
__device__ __forceinline__ void add_partial(const int (&acc)[BN / 2], const Params& p,
                                            long m_base, int n_base) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n_base + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long m = m_base + 8 * h;
      if (m >= p.M) continue;
      int* dst = p.partial + size_t(m) * p.N + n;
      if (n < p.N) atomicAdd(dst, acc[4 * j + 2 * h]);
      if (n + 1 < p.N) atomicAdd(dst + 1, acc[4 * j + 2 * h + 1]);
    }
  }
}

struct Unit {
  int mt, nt, k_begin, k_end;
};

__device__ __forceinline__ Unit decode(const Params& p, int u) {
  Unit t;
  t.nt = u % p.tiles_n;
  const int r = u / p.tiles_n;
  const int sp = r % p.splits;
  t.mt = r / p.splits;
  t.k_begin = sp * p.k_per_split;
  t.k_end = min(p.k_tiles, t.k_begin + p.k_per_split);
  return t;
}

template <int BN, bool CONV>
__global__ void __launch_bounds__(THREADS, 1)
int8_matmul_kernel(__grid_constant__ const CUtensorMap map_a,     // GEMM mode only
                   __grid_constant__ const CUtensorMap map_b,
                   __grid_constant__ const CUtensorMap map_out,   // when p.store_tma
                   __grid_constant__ const Params p) {
  using C = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  // stages and the output tile at multiples of 1024 bytes (the swizzle's
  // period), barriers after
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t a_tiles = base;
  const uint32_t b_tiles = base + C::STAGES * A_STAGE;
  const uint32_t out_tile = b_tiles + C::STAGES * C::B_STAGE;
  const uint32_t full = out_tile + C::OUT_TILE;            // STAGES x 8 bytes
  const uint32_t empty = full + C::STAGES * 8;

  const int wg = threadIdx.x / 128;
  const int units = p.tiles_m * p.tiles_n * p.splits;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      // full: the B (and, in GEMM mode, A) transaction's arrival, plus in
      // conv mode one arrival per producer thread for its gathered chunks
      mbar_init(full + 8 * s, CONV ? 129 : 1);
      mbar_init(empty + 8 * s, 8);                 // one per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    if constexpr (!CONV) {
      if (threadIdx.x != 0) return;
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit t = decode(p, u);
        for (int kt = t.k_begin; kt < t.k_end; ++kt, ++it) {
          const int s = it % C::STAGES;
          mbar_wait(empty + 8 * s, ((it / C::STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(full + 8 * s, A_STAGE + C::B_STAGE);
          tma_load_2d(a_tiles + s * A_STAGE, &map_a, full + 8 * s, kt * BK, t.mt * BM);
          tma_load_2d(b_tiles + s * C::B_STAGE, &map_b, full + 8 * s, kt * BK, t.nt * BN);
        }
      }
    } else {
      const int pt = threadIdx.x;           // 0..127
      const int chunk = pt & 7;             // 16-byte chunk of the 128-byte row
      const int row0 = pt >> 3;             // rows row0 + 16*i, i < 8
      // the swizzle puts chunk c of row r at c ^ (r % 8); r % 8 == row0 % 8
      const uint32_t dst0 = row0 * BK + ((chunk ^ (row0 & 7)) << 4);
      const int hw_out = p.Ho * p.Wo;
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit t = decode(p, u);
        int hi0[8], wi0[8], pix0[8];        // this thread's 8 output pixels
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int m = t.mt * BM + row0 + 16 * i;
          if (m < p.M) {
            const int b = m / hw_out, r = m - b * hw_out;
            const int ho = r / p.Wo, wo = r - ho * p.Wo;
            hi0[i] = ho * p.stride - p.pad;
            wi0[i] = wo * p.stride - p.pad;
            pix0[i] = (b * p.H + hi0[i]) * p.W + wi0[i];
          } else {
            hi0[i] = -0x40000000;           // outside the image at every tap
            wi0[i] = 0;
            pix0[i] = 0;
          }
        }
        for (int kt = t.k_begin; kt < t.k_end; ++kt, ++it) {
          const int s = it % C::STAGES;
          mbar_wait(empty + 8 * s, ((it / C::STAGES) & 1) ^ 1);
          if (pt == 0) {
            mbar_arrive_expect_tx(full + 8 * s, C::B_STAGE);
            tma_load_2d(b_tiles + s * C::B_STAGE, &map_b, full + 8 * s, kt * BK, t.nt * BN);
          }
          const int kk = kt * BK + chunk * 16;
          const int tap = kk / p.C;
          const int c = kk - tap * p.C;
          const int kh = tap / p.ksize, kw = tap - kh * p.ksize;
          const bool k_ok = kk < p.K;
          const uint32_t dst = a_tiles + s * A_STAGE + dst0;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int hi = hi0[i] + kh, wi = wi0[i] + kw;
            const bool ok = k_ok && unsigned(hi) < unsigned(p.H) && unsigned(wi) < unsigned(p.W);
            const int8_t* src = ok ? p.x + (long long)(pix0[i] + kh * p.W + kw) * p.C + c : p.x;
            cp_async16(dst + 16 * i * BK, src, ok);
          }
          cp_async_arrive(full + 8 * s);    // arrives when this thread's copies land
        }
      }
      cp_async_wait_all();
    }
  } else {
    // ------------------------------------------------------------ consumers
    const int cw = wg - 1;                  // rows cw*64 .. cw*64+63 of the tile
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    int acc[BN / 2];
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit t = decode(p, u);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      for (int kt = t.k_begin; kt < t.k_end; ++kt, ++it) {
        const int s = it % C::STAGES;
        mbar_wait(full + 8 * s, (it / C::STAGES) & 1);
        if (CONV) fence_proxy_async();      // the gathered A was written by cp.async
        const uint64_t da = sw128_desc(a_tiles + s * A_STAGE + cw * 64 * BK);
        const uint64_t db = sw128_desc(b_tiles + s * C::B_STAGE);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k32 = 0; k32 < BK / 32; ++k32)   // +32 bytes = +2 in the address field
          wgmma_s8<BN>(acc, da + 2 * k32, db + 2 * k32, 1);
        wgmma_commit();
        fence_regs(acc);
        wgmma_wait<1>();                    // the previous slice's products are done
        fence_regs(acc);
        if (kt > t.k_begin && lane == 0)
          mbar_arrive(empty + 8 * ((it - 1) % C::STAGES));
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % C::STAGES));

      const long m_base = long(t.mt) * BM + cw * 64 + warp * 16 + lane / 4;
      const int n_base = t.nt * BN + (lane % 4) * 2;
      if (p.partial != nullptr)
        add_partial<BN>(acc, p, m_base, n_base);
      else if (p.store_tma)
        epilogue_tma<BN>(acc, p, &map_out, out_tile + cw * (C::OUT_TILE / 2), cw, warp, lane,
                         t.mt * BM, t.nt * BN);
      else if (p.out_f32)
        epilogue<BN, float>(acc, p, m_base, n_base);
      else
        epilogue<BN, __nv_bfloat16>(acc, p, m_base, n_base);
    }
    if (p.store_tma && threadIdx.x % 128 == 0) tma_store_wait();
  }
}

// split K: the epilogue over the summed partials
template <typename OutT>
__global__ void int8_matmul_finish(const int* __restrict__ partial,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ bias, OutT* __restrict__ out,
                                   long total, int N) {
  const bool has_bias = bias != nullptr;
  for (long i = blockIdx.x * long(blockDim.x) + threadIdx.x; i < total;
       i += long(gridDim.x) * blockDim.x) {
    const int n = int(i % N);
    const float v = dequant(partial[i], scale[n], has_bias ? bias[n] : 0.0f, has_bias);
    if constexpr (sizeof(OutT) == 4) out[i] = v;
    else out[i] = __float2bfloat16_rn(v);
  }
}

// ---------------------------------------------------------------- host side

// a (rows, cols) row-major matrix of 1- or 2-byte elements, in boxes of
// box_rows x 128 bytes in the 128-byte swizzle; loads read zeros outside
// it, stores skip what lies outside it
bool make_map(CUtensorMap* map, const void* ptr, long rows, int cols, int box_rows,
              bool bf16) {
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  const int elem_bytes = bf16 ? 2 : 1;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * elem_bytes};
  const cuuint32_t box[2] = {cuuint32_t(BK / elem_bytes), cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

template <int BN, bool CONV>
int launch_bn(const void* a, const void* w, Params p, cudaStream_t s) {
  using C = Cfg<BN>;
  CUtensorMap map_a, map_b, map_out;
  if (!make_map(&map_b, w, p.N, p.K, BN, false)) return int(cudaErrorInvalidValue);
  if (CONV)
    map_a = map_b;                          // unused
  else if (!make_map(&map_a, a, p.M, p.K, BM, false))
    return int(cudaErrorInvalidValue);
  // bf16 rows of whole 16-byte units go out by TMA; anything else by
  // direct stores from the fragments
  p.store_tma = p.partial == nullptr && !p.out_f32 && p.N % 8 == 0 &&
                reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  if (!p.store_tma)
    map_out = map_b;                        // unused
  else if (!make_map(&map_out, p.out, p.M, p.N, 64, true))
    return int(cudaErrorInvalidValue);
  const cudaError_t e = allow_dynamic_smem<&int8_matmul_kernel<BN, CONV>>(C::SMEM);
  if (e != cudaSuccess) return int(e);
  const long units = long(p.tiles_m) * p.tiles_n * p.splits;
  const int sms = sm_count();
  const int grid = int(units < sms ? units : sms);
  int8_matmul_kernel<BN, CONV><<<grid, THREADS, C::SMEM, s>>>(map_a, map_b, map_out, p);
  return int(cudaGetLastError());
}

template <bool CONV>
int launch(const void* a, const void* w, Params p, int bn, void* out, cudaStream_t s) {
  if (p.M == 0 || p.N == 0) return int(cudaGetLastError());
  p.k_tiles = (p.K + BK - 1) / BK;
  if (p.splits < 1 || p.splits > p.k_tiles) return int(cudaErrorInvalidValue);
  p.k_per_split = (p.k_tiles + p.splits - 1) / p.splits;
  p.splits = (p.k_tiles + p.k_per_split - 1) / p.k_per_split;   // no empty split
  p.tiles_m = (p.M + BM - 1) / BM;
  p.tiles_n = (p.N + bn - 1) / bn;
  if (long(p.tiles_m) * p.tiles_n * p.splits > 0x7fffffffL) return int(cudaErrorInvalidValue);
  if ((p.splits > 1) != (p.partial != nullptr)) return int(cudaErrorInvalidValue);
  p.out = out;
  int status;
  switch (bn) {
    case 64: status = launch_bn<64, CONV>(a, w, p, s); break;
    case 128: status = launch_bn<128, CONV>(a, w, p, s); break;
    case 256: status = launch_bn<256, CONV>(a, w, p, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  if (status != 0 || p.partial == nullptr) return status;
  const long total = long(p.M) * p.N;
  const int blocks = int((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  if (p.out_f32)
    int8_matmul_finish<float><<<blocks, 256, 0, s>>>(p.partial, p.scale, p.bias,
                                                     static_cast<float*>(out), total, p.N);
  else
    int8_matmul_finish<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        p.partial, p.scale, p.bias, static_cast<__nv_bfloat16*>(out), total, p.N);
  return int(cudaGetLastError());
}

Params base_params(const void* scale, const void* bias, int M, int N, int K, int out_f32,
                   int splits, void* partial) {
  Params p{};
  p.M = M;
  p.N = N;
  p.K = K;
  p.splits = splits;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out_f32 = out_f32;
  p.partial = static_cast<int*>(partial);
  return p;
}

}  // namespace

extern "C" {

// GEMM mode. x (M,K) int8, w (N,K) int8, scale (N,) f32, bias (N,) f32 or
// null, out (M,N): bf16 when out_f32 == 0, else f32. All contiguous and
// 16-byte aligned; K a positive multiple of 16, at most 131071. bn: the
// tile width, 64, 128 or 256; splits: the number of K splits, and then
// `partial` a zeroed int32 (M,N) buffer (null when splits == 1). Launches
// on `stream`; returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments the kernel does not take).
int int8_matmul(const void* x, const void* w, const void* scale, const void* bias, void* out,
                int M, int N, int K, int out_f32, int bn, int splits, void* partial,
                void* stream) {
  if (M < 0 || N < 0 || K <= 0 || K % 16 != 0 || K > MAX_K) return int(cudaErrorInvalidValue);
  Params p = base_params(scale, bias, M, N, K, out_f32, splits, partial);
  return launch<false>(x, w, p, bn, out, static_cast<cudaStream_t>(stream));
}

// Conv mode. x (B,H,W,C) int8 NHWC, C a positive multiple of 16; w (N,
// ksize*ksize*C) int8 in (kh, kw, c) order; out (B,Ho,Wo,N) with
// Ho = (H + 2*pad - ksize) / stride + 1 (and Wo alike). The rest as for
// int8_matmul, with M = B*Ho*Wo and K = ksize*ksize*C.
int int8_conv_nhwc(const void* x, const void* w, const void* scale, const void* bias,
                   void* out, int B, int H, int W, int C, int N, int ksize, int stride,
                   int pad, int out_f32, int bn, int splits, void* partial, void* stream) {
  if (B < 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 != 0 || ksize <= 0 || stride <= 0 ||
      pad < 0 || N < 0)
    return int(cudaErrorInvalidValue);
  const long K = long(ksize) * ksize * C;
  const long ho = (long(H) + 2 * pad - ksize) / stride + 1;
  const long wo = (long(W) + 2 * pad - ksize) / stride + 1;
  const long M = long(B) * ho * wo;
  if (K > MAX_K || ho <= 0 || wo <= 0 || M > 0x7fffffffL ||
      long(B) * (H + 2 * pad) * (W + 2 * pad) > 0x7fffffffL)
    return int(cudaErrorInvalidValue);
  Params p = base_params(scale, bias, int(M), N, int(K), out_f32, splits, partial);
  p.x = static_cast<const int8_t*>(x);
  p.H = H;
  p.W = W;
  p.C = C;
  p.Ho = int(ho);
  p.Wo = int(wo);
  p.ksize = ksize;
  p.stride = stride;
  p.pad = pad;
  return launch<true>(x, w, p, bn, out, static_cast<cudaStream_t>(stream));
}

const char* int8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
