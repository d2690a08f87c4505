// Fused ResNet stem on a 4x4 space-to-depth frame, for sm_90a.
//
// Replaces the Pallas TPU kernel `_fused_kernel` of
// cl_object_detection_tpu/ops/stem_pallas.py (called by
// `_stem_fused_pallas`). It computes what `stem_fused_reference` there
// computes (and ops/stem_fused.py `stem_fused_reference` here):
//
//   y4[b,I,J,n] = sum_{T,U,c} x4[b,I+T-1,J+U-1,c] * w[(T*3+U)*64+c, n]
//                 (3x3 stride-1 conv, zero padding, K = 576, N = 256)
//   y4 = relu(bf16(y4) + bf16(bias[n]))         (bias after the cast)
//   out[b,I,J,o] = max over conv rows {2I-1,2I,2I+1} x cols {2J-1,2J,2J+1}
//                  of the phase-packed y4[..., (a*2+b)*64+o],
//                  with conv row/col -1 at -inf
//
// What bounds it on an H100: the packed GEMM, 2*M*576*256 operations for
// M = B*H4*W4 pixels, against ~0.4 KB of traffic per pixel: it sits
// above the card's bf16 ridge point, so the tensor cores are the limit.
//
// Design: the (576, 256) packed weight is 295 KB, more than a block's
// shared memory, and re-reading it per spatial tile would make the L2 the
// limit. So each persistent block owns one quarter of the output
// channels (16 pooled channels = 64 GEMM columns, 4 phases x 16): its
// 72 KB weight slice stays resident in shared memory for the whole run,
// and the block walks over spatial tiles. A tile is 15x15 pooled pixels;
// the block computes 16x16 conv pixels (one halo row above and one halo
// column to the left for the pool) from an 18x18x64 input tile (the conv
// halo, zero outside the image), with 16 warps each running one row of
// 16 pixels through bf16 WMMA (f32 accumulation). The f32 tile goes to
// shared memory; the epilogue casts, adds the bias, applies ReLU and
// pools, and writes only the 16 pooled channels of its quarter. Ragged
// edges are masked; there is no constraint on H4 or W4.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TR = 15;          // pooled rows per tile
constexpr int TC = 15;          // pooled cols per tile
constexpr int HR = TR + 1;      // conv rows computed (pool halo above)
constexpr int HC = TC + 1;      // conv cols computed (pool halo left) = 16
constexpr int XR = TR + 3;      // input rows (conv halo)
constexpr int XC = TC + 3;      // input cols
constexpr int CIN = 64;
constexpr int XS = 80;          // x tile pixel stride, elements (160 B)
constexpr int KDIM = 576;
constexpr int NQ = 64;          // GEMM columns per block: 4 phases x 16
constexpr int WS = 72;          // weight slice row stride, elements
constexpr int AS = 68;          // f32 accumulator row stride, elements
constexpr int WARPS = HR;       // one warp per conv row of the tile
constexpr int THREADS = WARPS * 32;
constexpr int QUARTERS = 4;

constexpr size_t X_BYTES = size_t(XR) * XC * XS * 2;
constexpr size_t W_BYTES = size_t(KDIM) * WS * 2;
constexpr size_t A_BYTES = size_t(HR) * HC * AS * 4;
constexpr size_t SMEM_BYTES = X_BYTES + W_BYTES + A_BYTES;

static_assert(HC == 16, "one WMMA row fragment per conv row");
static_assert((XS * 2) % 32 == 0 && (WS * 16 * 2) % 32 == 0, "alignment");

__device__ __forceinline__ float stem_value(const float* acc, int hr, int hc,
                                            int p, int j, float bias_b,
                                            int I0, int J0) {
  // conv pixel (I0-1+hr, J0-1+hc) of phase p, channel j of the quarter
  if (I0 - 1 + hr < 0 || J0 - 1 + hc < 0) return -__int_as_float(0x7f800000);  // -inf
  float y = __bfloat162float(__float2bfloat16_rn(acc[(hr * HC + hc) * AS + p * 16 + j]));
  float v = __bfloat162float(__float2bfloat16_rn(y + bias_b));
  return fmaxf(v, 0.0f);
}

__global__ void __launch_bounds__(THREADS, 1)
stem_fused_kernel(const __nv_bfloat16* __restrict__ x,    // (B,H4,W4,64)
                  const __nv_bfloat16* __restrict__ w,    // (576,256)
                  const float* __restrict__ bias,         // (256,)
                  __nv_bfloat16* __restrict__ out,        // (B,H4,W4,64)
                  int B, int H4, int W4) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem + X_BYTES);
  float* acc_s = reinterpret_cast<float*>(smem + X_BYTES + W_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int q = blockIdx.x % QUARTERS;
  const int slot = blockIdx.x / QUARTERS;
  const int nslots = gridDim.x / QUARTERS;

  // resident weight slice: column p*16+j <- w[:, p*64 + q*16 + j]
  for (int idx = tid; idx < KDIM * 8; idx += THREADS) {
    int k = idx >> 3, part = idx & 7;        // 8 x 16 B per row
    int p = part >> 1, half = part & 1;
    const uint4* src = reinterpret_cast<const uint4*>(
        w + size_t(k) * 256 + p * 64 + q * 16 + half * 8);
    *reinterpret_cast<uint4*>(w_s + k * WS + p * 16 + half * 8) = *src;
  }
  __shared__ float bias_s[NQ];
  if (tid < NQ) {
    int p = tid >> 4, j = tid & 15;
    bias_s[tid] = __bfloat162float(__float2bfloat16_rn(bias[p * 64 + q * 16 + j]));
  }

  const int tiles_h = (H4 + TR - 1) / TR;
  const int tiles_w = (W4 + TC - 1) / TC;
  const int ntiles = B * tiles_h * tiles_w;

  for (int tile = slot; tile < ntiles; tile += nslots) {
    const int b = tile / (tiles_h * tiles_w);
    const int rem = tile % (tiles_h * tiles_w);
    const int I0 = (rem / tiles_w) * TR;
    const int J0 = (rem % tiles_w) * TC;

    __syncthreads();  // previous tile's epilogue is done with x_s/acc_s
    for (int idx = tid; idx < XR * XC * 8; idx += THREADS) {
      int pix = idx >> 3, v = idx & 7;
      int gi = I0 - 2 + pix / XC;
      int gj = J0 - 2 + pix % XC;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gi >= 0 && gi < H4 && gj >= 0 && gj < W4)
        val = reinterpret_cast<const uint4*>(
            x + ((size_t(b) * H4 + gi) * W4 + gj) * CIN)[v];
      *reinterpret_cast<uint4*>(x_s + pix * XS + v * 8) = val;
    }
    __syncthreads();

    {
      const int r = warp;  // conv row r of the tile = global row I0-1+r
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) wmma::fill_fragment(acc[p], 0.0f);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
#pragma unroll 1
      for (int t = 0; t < 9; ++t) {
        const int T = t / 3, U = t % 3;
        const __nv_bfloat16* arow = x_s + ((r + T) * XC + U) * XS;
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          wmma::load_matrix_sync(a, arow + c4 * 16, XS);
          const __nv_bfloat16* brow = w_s + (t * CIN + c4 * 16) * WS;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            wmma::load_matrix_sync(bf, brow + p * 16, WS);
            wmma::mma_sync(acc[p], a, bf, acc[p]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
        wmma::store_matrix_sync(acc_s + r * HC * AS + p * 16, acc[p], AS,
                                wmma::mem_row_major);
    }
    __syncthreads();

    for (int idx = tid; idx < TR * TC * 16; idx += THREADS) {
      const int j = idx & 15;
      const int pix = idx >> 4;
      const int i = pix / TC, jj = pix % TC;
      const int gI = I0 + i, gJ = J0 + jj;
      if (gI >= H4 || gJ >= W4) continue;
      const int up = i, cur = i + 1, left = jj, ccur = jj + 1;
      float m = stem_value(acc_s, up, left, 3, j, bias_s[48 + j], I0, J0);
      m = fmaxf(m, stem_value(acc_s, up, ccur, 2, j, bias_s[32 + j], I0, J0));
      m = fmaxf(m, stem_value(acc_s, up, ccur, 3, j, bias_s[48 + j], I0, J0));
      m = fmaxf(m, stem_value(acc_s, cur, left, 1, j, bias_s[16 + j], I0, J0));
      m = fmaxf(m, stem_value(acc_s, cur, ccur, 0, j, bias_s[j], I0, J0));
      m = fmaxf(m, stem_value(acc_s, cur, ccur, 1, j, bias_s[16 + j], I0, J0));
      m = fmaxf(m, stem_value(acc_s, cur, left, 3, j, bias_s[48 + j], I0, J0));
      m = fmaxf(m, stem_value(acc_s, cur, ccur, 2, j, bias_s[32 + j], I0, J0));
      m = fmaxf(m, stem_value(acc_s, cur, ccur, 3, j, bias_s[48 + j], I0, J0));
      out[((size_t(b) * H4 + gI) * W4 + gJ) * CIN + q * 16 + j] =
          __float2bfloat16_rn(m);
    }
  }
}

}  // namespace

extern "C" {

// x4 (B,H4,W4,64) bf16, w (576,256) bf16, bias (256,) f32, out like x4;
// all contiguous, 16-byte aligned. Launches on `stream`; returns
// cudaGetLastError().
int stem_fused_bf16(const void* x, const void* w, const void* bias, void* out,
                    int B, int H4, int W4, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stem_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long ntiles = long(B) * ((H4 + TR - 1) / TR) * ((W4 + TC - 1) / TC);
  long slots = sms / QUARTERS;
  if (slots < 1) slots = 1;
  if (slots > ntiles) slots = ntiles;
  if (slots < 1) return int(cudaGetLastError());   // empty batch
  stem_fused_kernel<<<int(slots * QUARTERS), THREADS, SMEM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), B, H4, W4);
  return int(cudaGetLastError());
}

const char* stem_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
