// Fused ResNet stem on a 4x4 space-to-depth frame, for sm_90a.
//
// Replaces the Pallas TPU kernel `_fused_kernel` of
// cl_object_detection_tpu/ops/stem_pallas.py (called by
// `_stem_fused_pallas`). It computes what `stem_fused_reference` there
// computes (and ops/stem_fused.py `stem_fused_reference` here):
//
//   y4[b,I,J,n] = sum_{T,U,c} x4[b,I+T-1,J+U-1,c] * w[(T*3+U)*64+c, n]
//                 (3x3 stride-1 conv, zero padding, K = 576, N = 256)
//   y4 = relu(bf16(bf16(y4) + bf16(bias[n])))   (bias after the cast)
//   out[b,I,J,o] = max over conv rows {2I-1,2I,2I+1} x cols {2J-1,2J,2J+1}
//                  of the phase-packed y4[..., (a*2+b)*64+o],
//                  with conv row/col -1 at -inf
//
// What bounds it on an H100 (989 bf16 TFLOP/s, 3.35 TB/s): the packed
// GEMM does 2*576*256 operations per pixel against ~0.26 KB of device
// memory traffic per pixel, far above the card's ridge point, so the
// tensor cores bound it. But each unit (below) re-reads the whole 295 KB
// weight and each input pixel once per tap, from L2: about 2.9 GB of
// weight and 1.45 GB of patches at B=32, 608x832, which may set the pace
// before the tensor cores do.
//
// Design: an implicit GEMM on the pipeline of int8_matmul.cu's conv
// mode, with bf16 operands and the pool in the epilogue.
// * A unit is an 8 x 16 window of conv pixels, the 128 GEMM rows of one
//   tile: conv rows I0-1 .. I0+6 and cols J0-1 .. J0+14, which hold the
//   pool's halo above and to the left, for 7 x 15 pooled outputs (ragged
//   edges masked). One tile is all N = 256 columns (4 phases x 64
//   channels), so a block computes every output channel of its pixels.
//   K is 9 slices of 128 bytes, one per tap: the 64 bf16 channels of the
//   input pixel shifted by (T-1, U-1).
// * Warpgroup 0 produces: its 128 threads gather each tap's A slice with
//   16-byte cp.async into a 128-byte-swizzled stage (zero fill is the
//   conv's padding), each thread's copies arriving on the stage's barrier
//   as they land; one thread loads the tap's B slice, rows 0..255 x bytes
//   [t*128, t*128+128) of the (256, 576) K-major weight, by TMA in the
//   same swizzle. A ring of 3 stages of 48 KB.
// * Warpgroups 1 and 2 consume: wgmma m64n256k16 bf16 x bf16 -> f32 on
//   their 64 rows, 4 k-steps per slice, 128 accumulators a thread.
// * Epilogue: each consumer thread rounds its fragment to bf16, adds the
//   bf16 bias, applies ReLU (conv row or col -1 becomes -inf), and writes
//   it to a 128 x 256 bf16 tile in shared memory (rows padded by 16
//   bytes, so the fragment's 4-byte writes hit 32 banks). After a named
//   barrier the 256 consumer threads take the max over 9 phase-block
//   values per pooled output, 8 channels at a time, and store 16 bytes.
// * Blocks are persistent (one per SM) and walk the units, so the
//   producer loads the next unit's slices while the consumers pool.
// A float32 stem runs the second kernel below, stem_fused_f32_kernel: the
// 7x7 conv itself on the FMA units (no packed zeros), on the same windows
// and with the same pool, in float32 throughout.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int CIN = 64;                   // packed input channels: 128 bytes, one slice
constexpr int TAPS = 9;
constexpr int N = 256;                    // GEMM columns: 4 phases x 64 channels
constexpr int WIN_R = 8, WIN_C = 16;      // conv pixels of a unit
constexpr int OUT_R = WIN_R - 1, OUT_C = WIN_C - 1;   // pooled outputs of a unit
constexpr int BM = WIN_R * WIN_C;         // 128 GEMM rows: two consumer warpgroups of 64
constexpr int BK = 128;                   // bytes of K per stage
constexpr int THREADS = 384;              // producer warpgroup + two consumer warpgroups
constexpr int STAGES = 3;
constexpr int A_STAGE = BM * BK;          // 16 KB
constexpr int B_STAGE = N * BK;           // 32 KB
constexpr int TILE_ROW = N * 2 + 16;      // bytes per row of the epilogue tile
constexpr int TILE = BM * TILE_ROW;
constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) + TILE + 1024 + 2 * STAGES * 8;

static_assert(CIN * 2 == BK, "one tap is one 128-byte slice");
static_assert(SMEM + N * 4 <= 232448, "shared memory");

struct Params {
  const __nv_bfloat16* x;   // (B,H4,W4,64)
  const float* bias;        // (256,)
  __nv_bfloat16* out;       // (B,H4,W4,64)
  int B, H4, W4, tiles_h, tiles_w;
};

// conv value -> bf16, + bf16 bias, -> bf16, ReLU (as stem_fused_reference)
__device__ __forceinline__ float stem_value(float acc, float bias_b) {
  const float y = __bfloat162float(__float2bfloat16_rn(acc));
  return fmaxf(__bfloat162float(__float2bfloat16_rn(y + bias_b)), 0.0f);
}

__device__ __forceinline__ uint4 max8(uint4 a, uint4 b) {
  uint4 m;
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162* pm = reinterpret_cast<__nv_bfloat162*>(&m);
#pragma unroll
  for (int i = 0; i < 4; ++i) pm[i] = __hmax2(pa[i], pb[i]);
  return m;
}

__global__ void __launch_bounds__(THREADS, 1)
stem_fused_kernel(__grid_constant__ const CUtensorMap map_w,   // (256, 576) bf16
                  __grid_constant__ const Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float bias_s[N];               // bf16-rounded bias
  // stages at multiples of 1024 bytes (the swizzle's period), then the
  // epilogue tile, then the barriers
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t a_tiles = base;
  const uint32_t b_tiles = base + STAGES * A_STAGE;
  const uint32_t tile = b_tiles + STAGES * B_STAGE;
  const uint32_t full = tile + TILE;        // STAGES x 8 bytes
  const uint32_t empty = full + STAGES * 8;
  uint8_t* tile_ptr = smem_raw + (tile - raw);

  const int wg = threadIdx.x / 128;
  const int per_image = p.tiles_h * p.tiles_w;
  const int units = p.B * per_image;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // full: the B transaction's arrival plus one per producer thread
      // for its gathered chunks; empty: one per consumer warp
      mbar_init(full + 8 * s, 129);
      mbar_init(empty + 8 * s, 8);
    }
    fence_mbar_init();
  }
  for (int n = threadIdx.x; n < N; n += THREADS)
    bias_s[n] = __bfloat162float(__float2bfloat16_rn(p.bias[n]));
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    const int pt = threadIdx.x;           // 0..127
    const int chunk = pt & 7;             // 16-byte chunk of the 128-byte row
    const int col = pt >> 3;              // window column; GEMM rows col + 16*r, r < 8
    // the swizzle puts chunk c of row m at c ^ (m % 8), and m % 8 == col % 8
    const uint32_t dst0 = col * BK + ((chunk ^ (col & 7)) << 4);
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int b = u / per_image, rem = u - b * per_image;
      const int ti = rem / p.tiles_w;
      const int I0 = ti * OUT_R, J0 = (rem - ti * p.tiles_w) * OUT_C;
      // tap (T,U) of window pixel (r, col) reads input (I0-2+r+T, J0-2+col+U)
      const __nv_bfloat16* xb = p.x + size_t(b) * p.H4 * p.W4 * CIN + chunk * 8;
      for (int t = 0; t < TAPS; ++t, ++it) {
        const int s = it % STAGES;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        if (pt == 0) {
          mbar_arrive_expect_tx(full + 8 * s, B_STAGE);
          tma_load_2d(b_tiles + s * B_STAGE, &map_w, full + 8 * s, t * CIN, 0);
        }
        const int T = t / 3, U = t - 3 * T;
        const int gj = J0 - 2 + col + U;
        const bool col_ok = unsigned(gj) < unsigned(p.W4);
        const uint32_t dst = a_tiles + s * A_STAGE + dst0;
#pragma unroll
        for (int r = 0; r < WIN_R; ++r) {
          const int gi = I0 - 2 + r + T;
          const bool ok = col_ok && unsigned(gi) < unsigned(p.H4);
          const __nv_bfloat16* src = ok ? xb + (size_t(gi) * p.W4 + gj) * CIN : p.x;
          cp_async16(dst + r * WIN_C * BK, src, ok);
        }
        cp_async_arrive(full + 8 * s);    // arrives when this thread's copies land
      }
    }
    cp_async_wait_all();
  } else {
    // ------------------------------------------------------------ consumers
    const int cw = wg - 1;                // GEMM rows cw*64 .. cw*64+63
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, q = lane % 4;
    const int r = cw * 4 + warp;          // this warp's window row; its cols g, g + 8
    float acc[N / 2];
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int b = u / per_image, rem = u - b * per_image;
      const int ti = rem / p.tiles_w;
      const int I0 = ti * OUT_R, J0 = (rem - ti * p.tiles_w) * OUT_C;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
      for (int t = 0; t < TAPS; ++t, ++it) {
        const int s = it % STAGES;
        mbar_wait(full + 8 * s, (it / STAGES) & 1);
        fence_proxy_async();              // the gathered A was written by cp.async
        const uint64_t da = sw128_desc(a_tiles + s * A_STAGE + cw * 64 * BK);
        const uint64_t db = sw128_desc(b_tiles + s * B_STAGE);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k16 = 0; k16 < BK / 32; ++k16)   // +32 bytes = +2 in the address field
          wgmma_bf16<N>(acc, da + 2 * k16, db + 2 * k16, 1);
        wgmma_commit();
        fence_regs(acc);
        wgmma_wait<1>();                  // the previous slice's products are done
        fence_regs(acc);
        if (t > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));

      // ---- epilogue: bf16 tile in shared memory, then the pool
      named_barrier(1, 256);              // the last unit's pool has read the tile
      const bool row_pad = I0 - 1 + r < 0;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int n = 8 * j + 2 * q;
        const float b0 = bias_s[n], b1 = bias_s[n + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = g + 8 * h;
          float v0 = stem_value(acc[4 * j + 2 * h], b0);
          float v1 = stem_value(acc[4 * j + 2 * h + 1], b1);
          if (row_pad || J0 - 1 + c < 0) v0 = v1 = __int_as_float(0xff800000);   // -inf
          *reinterpret_cast<__nv_bfloat162*>(tile_ptr + (r * WIN_C + c) * TILE_ROW + 2 * n) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
      named_barrier(1, 256);
      // pooled output (pi, pj) of the unit: window rows pi (up), pi+1
      // (cur), cols pj (left), pj+1; 8 channels of phase block ph at byte
      // ph*128 + ch8*16 of a window pixel's row
      for (int idx = threadIdx.x - 128; idx < OUT_R * OUT_C * 8; idx += 256) {
        const int ch8 = idx & 7, pix = idx >> 3;
        const int pi = pix / OUT_C, pj = pix - pi * OUT_C;
        const int I = I0 + pi, J = J0 + pj;
        if (I >= p.H4 || J >= p.W4) continue;
        const uint8_t* w0 = tile_ptr + (pi * WIN_C + pj) * TILE_ROW + ch8 * 16;
        auto at = [&](int dr, int dc, int ph) {
          return *reinterpret_cast<const uint4*>(w0 + (dr * WIN_C + dc) * TILE_ROW + ph * 128);
        };
        uint4 m = at(0, 0, 3);            // conv row 2I-1: the up row's a = 1 blocks
        m = max8(m, at(0, 1, 2));
        m = max8(m, at(0, 1, 3));
        m = max8(m, at(1, 0, 1));         // conv rows 2I, 2I+1: the cur row's blocks
        m = max8(m, at(1, 0, 3));
        m = max8(m, at(1, 1, 0));
        m = max8(m, at(1, 1, 1));
        m = max8(m, at(1, 1, 2));
        m = max8(m, at(1, 1, 3));
        *reinterpret_cast<uint4*>(p.out + ((size_t(b) * p.H4 + I) * p.W4 + J) * CIN + ch8 * 8) = m;
      }
    }
  }
}

// ------------------------------------------------------ the float32 form
//
// The tensor cores have no float32 product (TF32 keeps 10 bits of the
// mantissa), so a float32 stem runs on the FMA units. There the packed
// GEMM would waste most of its work: of its 576 K-rows per column, the 16
// pad channels of each tap are zeros, and of a phase's 9 x 16 (T,alpha,
// U,beta) tap rows only 49 fall inside the 7x7 support, so only 147 of
// 576 products are not zero. This form computes the 7x7/2 conv itself,
// 147 products per output, from a compact (147, 64) weight: the 7x7
// kernel k7[kh,kw,c,o] (BN scale folded in) in the order the loop walks,
// row (kh*3 + c)*7 + kw (ops/stem_fused.py `stem_weight_f32`).
//
// What bounds it on an H100: 147 x 64 FMAs (2*147*64 operations) per
// conv pixel against the frame read once, far above the float32 ridge point; at
// 67 TFLOP/s the conv takes 0.284 ms at B=8, 608x832, and the 8 x 16
// windows (the pool's halo, ragged edges) add a quarter.
//
// Design: a block is one window of the bf16 form (8 x 16 grid pixels =
// 16 x 32 conv pixels, for 7 x 15 pooled outputs) x 32 output channels
// (grid: units x 2). It stages the window's input reach in shared memory
// once, de-interleaved from the space-to-depth frame into an RGB tile of
// 3 x 40 x 72 pixels (grid rows I0-2 .. I0+7, cols J0-2 .. J0+15, zeros
// outside the frame; the 16 pad channels are never read), and the
// block's 147 x 32 weights. Each of its 256 threads holds one conv row x
// 8 consecutive conv columns x 8 channels (64 sums): per (kh, c) it reads
// the 21 input pixels its 8 outputs x 7 kw taps touch with six 16-byte
// loads, then per kw two 16-byte weight loads (the same for every thread
// of a channel group: a broadcast) feed 64 FMAs. The epilogue adds the
// phase's bias, applies ReLU (-inf at conv row or col -1) into a
// 16 x 32 x 32 tile over the same shared memory, and takes the max over
// the 3 x 3 conv pixels of each pooled output. Rounding is float32
// throughout, as stem_fused_reference in float32.

constexpr int F_OC = 32;                  // output channels of a block
constexpr int F_THREADS = 256;
constexpr int F_CONV_R = 2 * WIN_R, F_CONV_C = 2 * WIN_C;   // conv pixels of a window
constexpr int F_IN_R = 4 * (WIN_R + 2), F_IN_C = 4 * (WIN_C + 2);   // RGB pixels staged
constexpr int F_IN = 3 * F_IN_R * F_IN_C; // floats of the input tile, [c][row][col]
constexpr int F_STAGE = (WIN_R + 2) * (WIN_C + 2) * 12;   // 16-byte loads of the reach
constexpr int F_STAGE_ITERS = (F_STAGE + F_THREADS - 1) / F_THREADS;
constexpr int F_TAPS = 7 * 3 * 7;         // rows of the compact weight, (kh, c, kw)
constexpr int F_W = F_TAPS * F_OC;        // floats of the block's weights, [tap][o]
constexpr int F_TILE = F_CONV_R * F_CONV_C * F_OC;   // epilogue tile, [row][col][o]
constexpr int F_SMEM = (F_IN + F_W > F_TILE ? F_IN + F_W : F_TILE) * 4;

static_assert(F_CONV_R * (F_CONV_C / 8) * (F_OC / 8) == F_THREADS,
              "a thread: one conv row x 8 columns x 8 channels");
static_assert(F_SMEM <= 232448, "shared memory");

__global__ void __launch_bounds__(F_THREADS, 2)
stem_fused_f32_kernel(const float* __restrict__ x,      // (B,H4,W4,64)
                      const float* __restrict__ w,      // (147, 64) compact 7x7 weight
                      const float* __restrict__ bias,   // (256,) phase-packed
                      float* __restrict__ out,          // (B,H4,W4,64)
                      int H4, int W4, int tiles_h, int tiles_w) {
  extern __shared__ __align__(16) float fsmem[];
  float* in_s = fsmem;
  float* w_s = fsmem + F_IN;

  const int per_image = tiles_h * tiles_w;
  const int b = blockIdx.x / per_image, rem = blockIdx.x - b * per_image;
  const int ti = rem / tiles_w;
  const int I0 = ti * OUT_R, J0 = (rem - ti * tiles_w) * OUT_C;
  const int o0 = blockIdx.y * F_OC;
  const int t = threadIdx.x;
  const int cg = t & 3;                   // channels o0 + cg*8 .. +7
  const int qg = (t >> 2) & 3;            // conv columns qg*8 .. qg*8+7 of the window
  const int p = t >> 4;                   // conv row of the window
  const float* xb = x + size_t(b) * H4 * W4 * CIN;

  // grid pixel (gr, gc) of the reach is (I0-2+gr, J0-2+gc); its channel
  // (al*4 + be)*3 + c is RGB pixel (4*gr + al, 4*gc + be), channel c
  // all of a thread's loads are issued before its stores, so their L2
  // latencies overlap
  float4 staged[F_STAGE_ITERS];
#pragma unroll
  for (int it = 0; it < F_STAGE_ITERS; ++it) {
    const int i = t + it * F_THREADS;
    const int q4 = i % 12, pix = i / 12;
    const int gr = pix / (WIN_C + 2), gi = I0 - 2 + gr, gj = J0 - 2 + pix - gr * (WIN_C + 2);
    staged[it] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);   // the conv's zero padding
    if (i < F_STAGE && unsigned(gi) < unsigned(H4) && unsigned(gj) < unsigned(W4))
      staged[it] = __ldg(reinterpret_cast<const float4*>(xb + (size_t(gi) * W4 + gj) * CIN) + q4);
  }
#pragma unroll
  for (int it = 0; it < F_STAGE_ITERS; ++it) {
    const int i = t + it * F_THREADS;
    if (i >= F_STAGE) break;
    const int q4 = i % 12, pix = i / 12;
    const int gr = pix / (WIN_C + 2), gc = pix - gr * (WIN_C + 2);
    const float vs[4] = {staged[it].x, staged[it].y, staged[it].z, staged[it].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = 4 * q4 + e, al = ch / 12, be = (ch % 12) / 3, c = ch % 3;
      in_s[(c * F_IN_R + 4 * gr + al) * F_IN_C + 4 * gc + be] = vs[e];
    }
  }
  for (int i = t; i < F_TAPS * (F_OC / 4); i += F_THREADS) {
    const int row = i / (F_OC / 4), q = i - row * (F_OC / 4);
    reinterpret_cast<float4*>(w_s)[i] =
        __ldg(reinterpret_cast<const float4*>(w + size_t(row) * CIN + o0) + q);
  }
  __syncthreads();

  // conv pixel (p, q) of the window is conv (2*(I0-1) + p, 2*(J0-1) + q);
  // its tap (kh, kw) reads RGB pixel (2p + kh + 1, 2q + kw + 1) of the tile
  float acc[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[j][c] = 0.0f;
  for (int kh = 0; kh < 7; ++kh) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4* src =
          reinterpret_cast<const float4*>(in_s + (c * F_IN_R + 2 * p + kh + 1) * F_IN_C + 16 * qg);
      float a[24];
#pragma unroll
      for (int v = 0; v < 6; ++v) {
        const float4 s4 = src[v];
        a[4 * v] = s4.x;
        a[4 * v + 1] = s4.y;
        a[4 * v + 2] = s4.z;
        a[4 * v + 3] = s4.w;
      }
      const float* wr = w_s + (kh * 3 + c) * 7 * F_OC + cg * 8;
#pragma unroll
      for (int kw = 0; kw < 7; ++kw) {
        const float4 w0 = *reinterpret_cast<const float4*>(wr + kw * F_OC);
        const float4 w1 = *reinterpret_cast<const float4*>(wr + kw * F_OC + 4);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int o = 0; o < 8; ++o) acc[j][o] = fmaf(a[2 * j + kw + 1], wv[o], acc[j][o]);
      }
    }
  }

  __syncthreads();                        // the input and weights become the tile
  float* tile = fsmem;
  const int a_ph = p & 1;                 // the conv row's phase
  const bool row_pad = 2 * (I0 - 1) + p < 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int q = 8 * qg + j;
    const bool pad = row_pad || 2 * (J0 - 1) + q < 0;
    const float* bp = bias + (a_ph * 2 + (j & 1)) * CIN + o0 + cg * 8;
    float v[8];
#pragma unroll
    for (int o = 0; o < 8; ++o)
      v[o] = pad ? __int_as_float(0xff800000) : fmaxf(acc[j][o] + __ldg(bp + o), 0.0f);
    float4* dst = reinterpret_cast<float4*>(tile + (p * F_CONV_C + q) * F_OC + cg * 8);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  __syncthreads();
  // pooled output (pi, pj) of the unit: conv rows 2pi+1 .. 2pi+3 and
  // cols 2pj+1 .. 2pj+3 of the window, i.e. conv rows 2I-1 .. 2I+1
  for (int i = t; i < OUT_R * OUT_C * F_OC; i += F_THREADS) {
    const int o = i % F_OC, pix = i / F_OC;
    const int pi = pix / OUT_C, pj = pix - pi * OUT_C;
    const int I = I0 + pi, J = J0 + pj;
    if (I >= H4 || J >= W4) continue;
    const float* t0 = tile + ((2 * pi + 1) * F_CONV_C + 2 * pj + 1) * F_OC + o;
    float m = t0[0];
#pragma unroll
    for (int dr = 0; dr < 3; ++dr)
#pragma unroll
      for (int dc = 0; dc < 3; ++dc) m = fmaxf(m, t0[(dr * F_CONV_C + dc) * F_OC]);
    out[((size_t(b) * H4 + I) * W4 + J) * CIN + o0 + o] = m;
  }
}

// ---------------------------------------------------------------- host side

// the (256, 576) bf16 weight in boxes of 256 rows x 128 bytes (one tap),
// in the 128-byte swizzle
bool make_weight_map(CUtensorMap* map, const void* w) {
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(TAPS * CIN), cuuint64_t(N)};
  const cuuint64_t strides[1] = {cuuint64_t(TAPS * CIN * 2)};
  const cuuint32_t box[2] = {cuuint32_t(CIN), cuuint32_t(N)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// x4 (B,H4,W4,64) bf16, w (256,576) bf16 (the packed kernel K-major: row
// n is output channel n over K = (T,U,c)), bias (256,) f32, out like x4;
// all contiguous, 16-byte aligned. Launches on `stream`; returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not
// take).
int stem_fused_bf16(const void* x, const void* w, const void* bias, void* out,
                    int B, int H4, int W4, void* stream) {
  if (B < 0 || H4 < 0 || W4 < 0) return int(cudaErrorInvalidValue);
  Params p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B;
  p.H4 = H4;
  p.W4 = W4;
  p.tiles_h = (H4 + OUT_R - 1) / OUT_R;
  p.tiles_w = (W4 + OUT_C - 1) / OUT_C;
  const long units = long(B) * p.tiles_h * p.tiles_w;
  if (units == 0) return int(cudaGetLastError());   // empty batch
  if (units > 0x7fffffffL) return int(cudaErrorInvalidValue);
  CUtensorMap map_w;
  if (!make_weight_map(&map_w, w)) return int(cudaErrorInvalidValue);
  const cudaError_t e = allow_dynamic_smem<&stem_fused_kernel>(SMEM);
  if (e != cudaSuccess) return int(e);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = int(units < sms ? units : (sms > 0 ? sms : 1));
  stem_fused_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(map_w, p);
  return int(cudaGetLastError());
}

// The float32 form: x4 (B,H4,W4,64) f32, w (147, 64) f32 (the compact
// 7x7 weight, row (kh*3 + c)*7 + kw), bias (256,) f32, out like x4; all
// contiguous, 16-byte aligned. Launches on `stream`; returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not
// take).
int stem_fused_f32(const void* x, const void* w, const void* bias, void* out,
                   int B, int H4, int W4, void* stream) {
  if (B < 0 || H4 < 0 || W4 < 0) return int(cudaErrorInvalidValue);
  const int tiles_h = (H4 + OUT_R - 1) / OUT_R, tiles_w = (W4 + OUT_C - 1) / OUT_C;
  const long units = long(B) * tiles_h * tiles_w;
  if (units == 0) return int(cudaGetLastError());   // empty batch
  if (units > 0x7fffffffL) return int(cudaErrorInvalidValue);
  const cudaError_t e = allow_dynamic_smem<&stem_fused_f32_kernel>(F_SMEM);
  if (e != cudaSuccess) return int(e);
  stem_fused_f32_kernel<<<dim3(unsigned(units), CIN / F_OC), F_THREADS, F_SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), H4, W4, tiles_h, tiles_w);
  return int(cudaGetLastError());
}

const char* stem_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
