// int8 x int8 -> int32 GEMM with a per-column dequantize epilogue, for
// sm_90a.
//
// Replaces the Pallas TPU kernel `_pallas_int8_matmul` of
// tools/bench_int8_matmul.py. It computes what `int8_matmul_reference` in
// ops/int8_matmul.py computes:
//
//   acc[m,n] = sum_k x[m,k] * w[n,k]                 (exact, in int32)
//   out[m,n] = out_t(f32(acc[m,n]) * scale[n] (+ bias[n]))
//
// with x int8 (M,K) row-major, w int8 (N,K) K-contiguous, scale and bias
// f32 (N,), out bf16 or f32 (M,N) row-major. The epilogue follows the JAX
// formulas step by step, each rounded to nearest even: int -> f32, the
// multiply, then the bias add (__fmul_rn / __fadd_rn, never contracted
// into an FMA), then the cast. The TPU kernel's case (one scalar scale, no
// bias, bf16 out) is a filled scale vector; ops/quant.py's dequantize
// (s_x * s_w[n], then the conv bias) is the general case.
//
// What bounds it on an H100: at the quantized convs' im2col shapes
// (K = 64..18432, N = 64..512) a GEMM does 2*N operations per byte of x it
// reads, under the card's int8 ridge point of ~590 operations per byte for
// N <= 256, so the bytes of x (read once) and of the output bound it.
//
// Design, a simple kernel that is right first: 128x128 output tiles, one
// block of 8 warps each (2 along M x 4 along N, 64x32 per warp), a K loop
// over 64-byte slices. Both operands go to shared memory by cp.async
// (16 bytes a thread, zero-filled past the ragged M and N edges) in two
// stages, so the next slice loads while the tensor cores work on this one.
// Rows are padded to 80 bytes, so the fragment loads of a warp hit 32
// distinct banks. The products run on mma.sync m16n8k32 s8 x s8 -> s32.
// Blocks walk N fastest, so the blocks that share an x tile run together
// and all but the first read it from L2. K must be a multiple of 64 (the
// wrapper pads both operands with zeros, which is exact) and at most
// 131071, so |acc| <= K*128*128 < 2^31 cannot overflow.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;              // bytes of K per stage
constexpr int LDS = BK + 16;        // padded shared row, bytes
constexpr int THREADS = 256;
constexpr int WARP_M = 64;          // rows per warp
constexpr int WARP_N = 32;          // columns per warp
constexpr int MT = WARP_M / 16;     // m16 tiles per warp
constexpr int NT = WARP_N / 8;      // n8 tiles per warp
constexpr int CHUNKS = BM * BK / 16 / THREADS;   // 16-byte copies a thread per operand

static_assert(BM == BN, "one copy loop serves both operands");
static_assert((BM / WARP_M) * (BN / WARP_N) * 32 == THREADS, "warp grid");
static_assert(LDS % 16 == 0, "cp.async needs 16-byte aligned rows");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

template <typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
int8_matmul_kernel(const int8_t* __restrict__ x,      // (M,K)
                   const int8_t* __restrict__ w,      // (N,K)
                   const float* __restrict__ scale,   // (N,)
                   const float* __restrict__ bias,    // (N,) or null
                   OutT* __restrict__ out,            // (M,N)
                   int M, int N, int K) {
  __shared__ __align__(128) int8_t a_s[2][BM * LDS];
  __shared__ __align__(128) int8_t b_s[2][BN * LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;          // row (A, C) / column (B) within a fragment
  const int tig = lane & 3;           // thread in its group of four
  const int wm = (warp >> 2) * WARP_M;
  const int wn = (warp & 3) * WARP_N;

  const int n_tiles = (N + BN - 1) / BN;
  const long m0 = long(blockIdx.x / n_tiles) * BM;
  const long n0 = long(blockIdx.x % n_tiles) * BN;

  // this thread's 16-byte copies: row r, chunk c of a 128 x 64-byte slice
  int cp_row[CHUNKS], cp_col[CHUNKS];
  bool a_ok[CHUNKS], b_ok[CHUNKS];
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int idx = tid + i * THREADS;
    cp_row[i] = idx >> 2;
    cp_col[i] = (idx & 3) * 16;
    a_ok[i] = m0 + cp_row[i] < M;
    b_ok[i] = n0 + cp_row[i] < N;
  }
  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const long am = a_ok[i] ? m0 + cp_row[i] : 0;
      const long bn = b_ok[i] ? n0 + cp_row[i] : 0;
      cp_async16(&a_s[stage][cp_row[i] * LDS + cp_col[i]],
                 x + am * K + k0 + cp_col[i], a_ok[i]);
      cp_async16(&b_s[stage][cp_row[i] * LDS + cp_col[i]],
                 w + bn * K + k0 + cp_col[i], b_ok[i]);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int k_tiles = K / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) load_stage((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();        // an empty group on the last slice keeps the count
    cp_async_wait_1();        // this slice has landed
    __syncthreads();
    const int8_t* as = a_s[kt & 1];
    const int8_t* bs = b_s[kt & 1];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = as + (wm + i * 16 + gid) * LDS + ks + tig * 4;
        af[i][0] = *reinterpret_cast<const unsigned*>(p);
        af[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
        af[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* p = bs + (wn + j * 8 + gid) * LDS + ks + tig * 4;
        bf[j][0] = *reinterpret_cast<const unsigned*>(p);
        bf[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();          // done reading this stage before it is refilled
  }

  // epilogue: thread holds columns n0+wn+j*8+tig*2+{0,1} of rows
  // m0+wm+i*16+gid (+8)
  const bool has_bias = bias != nullptr;
  const bool paired = (N % 2) == 0;   // 2-element stores stay aligned
  float sc[NT][2], bi[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long n = n0 + wn + j * 8 + tig * 2 + e;
      sc[j][e] = n < N ? scale[n] : 0.0f;
      bi[j][e] = (has_bias && n < N) ? bias[n] : 0.0f;
    }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long m = m0 + wm + i * 16 + gid + h * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const long n = n0 + wn + j * 8 + tig * 2;
        const float v0 = dequant(acc[i][j][2 * h], sc[j][0], bi[j][0], has_bias);
        const float v1 = dequant(acc[i][j][2 * h + 1], sc[j][1], bi[j][1], has_bias);
        store2(out, size_t(m) * N + n, v0, v1, n < N, n + 1 < N, paired);
      }
    }
}

}  // namespace

extern "C" {

// x (M,K) int8, w (N,K) int8, scale (N,) f32, bias (N,) f32 or null,
// out (M,N): bf16 when out_f32 == 0, else f32. All contiguous and 16-byte
// aligned; K a positive multiple of 64, at most 131071. Launches on
// `stream`; returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments the kernel does not take).
int int8_matmul(const void* x, const void* w, const void* scale, const void* bias,
                void* out, int M, int N, int K, int out_f32, void* stream) {
  if (M < 0 || N < 0 || K <= 0 || K % BK != 0 || K > 131071)
    return int(cudaErrorInvalidValue);
  const long blocks = long((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (blocks == 0) return int(cudaGetLastError());
  if (blocks > 0x7fffffffL) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xq = static_cast<const int8_t*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (out_f32)
    int8_matmul_kernel<float><<<unsigned(blocks), THREADS, 0, s>>>(
        xq, wq, sc, bi, static_cast<float*>(out), M, N, K);
  else
    int8_matmul_kernel<__nv_bfloat16><<<unsigned(blocks), THREADS, 0, s>>>(
        xq, wq, sc, bi, static_cast<__nv_bfloat16*>(out), M, N, K);
  return int(cudaGetLastError());
}

const char* int8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
