// Batched greedy hard NMS (keep masks), for sm_90a.
//
// Replaces the Pallas TPU kernel `_nms_fp_kernel` of
// cl_object_detection_tpu/ops/nms_pallas.py (called by
// `nms_pallas_batched`). Per image it computes the keep mask of greedy NMS
// over k score-sorted (class-offset) boxes: box j is kept iff its score is
// > 0 and no earlier kept box i < j has
//     inter(i,j) / max(area_i + area_j - inter(i,j), 1e-8) > thresh,
// area = max(x2-x1,0)*max(y2-y1,0). That is the unique fixed point of the
// TPU kernel's iteration keep <- valid & !(keep^T S > 0), so the masks are
// bit-identical to ops/nms.py `nms_iterative`. The division form of the
// test is kept, and the file is compiled with --fmad=false: a product
// form, or `area_i + area_j - iw*ih` contracted into an FMA, rounds
// differently and flips keep bits for IoUs within an ulp of the threshold.
//
// What bounds it on an H100: the k(k-1)/2 IoU tests per image, ~14 fp32
// operations each outside the tensor cores, then a greedy scan whose steps
// depend on each other; the bytes (k boxes in, k bytes out) are
// negligible. Design: two launches on the caller's stream.
// * nms_mask_kernel builds the strictly-upper suppression bitmask of every
//   image across the whole card, into a global workspace of k rows of
//   `wp` words per image (row i, word w holds j = 32w..32w+31 > i; wp is
//   ceil(k/32) rounded up to 4 words, so that rows start 16-byte
//   aligned). A block is one image x 64 rows x 64 columns (2 words), and
//   only blocks on or above the diagonal are launched. It stages its 64
//   column boxes and their areas in shared memory; each of its 64 threads
//   tests one row against them and writes two words. At B=32, k=1024 the
//   workspace is 4.2 MB and stays in L2.
// * nms_scan_kernel runs the greedy scan, one warp per image, in bands of
//   32 rows. Band w's rows, words [w & ~3, wp), and its 32 scores are
//   copied into shared memory with cp.async as tiles of up to 128 words,
//   in a ring of 4 tiles kept 3 tiles ahead of the scan, so the L2
//   latency is paid once at the start and not per kept box. For each band
//   the warp resolves the 32 candidates (valid and not yet removed) with
//   the band's diagonal words in registers (a shuffle per kept box), then
//   ORs the kept rows of the band's tiles into the `removed` words in
//   shared memory; the lanes meet at __syncwarp, never at a block
//   barrier. Shared memory holds the tiles and 4 bytes per 32 boxes for
//   the removed bits: k up to ~1.3 million, where one image's workspace
//   (k^2/8 bytes) would be 216 GB.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int MASK_ROWS = 64;            // rows (and columns) of a mask block
constexpr int TILE_WORDS = 128;          // columns of a scan tile
constexpr int TILE_ROW = TILE_WORDS + 4; // a tile row in shared memory, 16-byte aligned
constexpr int TILE = 32 * TILE_ROW + 32; // words of a tile: a band of 32 rows, its scores
constexpr int STAGES = 4;                // tiles in the ring
constexpr size_t SMEM_MAX = 232448;      // shared memory a block may use on sm_90

__device__ __forceinline__ float box_area(float4 v) {
  return fmaxf(v.z - v.x, 0.0f) * fmaxf(v.w - v.y, 0.0f);
}

// the IoU test of ops/nms.py `_iou_matrix`, in its IEEE operations
__device__ __forceinline__ bool suppresses(float4 bi, float ai, float4 bj, float aj,
                                           float thresh) {
  const float iw = fmaxf(fminf(bi.z, bj.z) - fmaxf(bi.x, bj.x), 0.0f);
  const float ih = fmaxf(fminf(bi.w, bj.w) - fmaxf(bi.y, bj.y), 0.0f);
  const float inter = iw * ih;
  const float uni = fmaxf(ai + aj - inter, 1e-8f);
  return inter / uni > thresh;
}

__global__ void __launch_bounds__(MASK_ROWS)
nms_mask_kernel(const float4* __restrict__ boxes,   // (B,k) xyxy
                uint32_t* __restrict__ work,        // (B,k,wp)
                int B, int k, int wp, int nb, float thresh) {
  __shared__ float4 col_box[MASK_ROWS];
  __shared__ float col_area[MASK_ROWS];
  // blockIdx.x -> (row block rb, column block cb >= rb): counted from the
  // last row block, whose single block is q = 0, row block nb-1-R holds
  // q in [R(R+1)/2, (R+1)(R+2)/2)
  const long q = long(nb) * (nb + 1) / 2 - 1 - blockIdx.x;
  int R = int((sqrt(8.0 * double(q) + 1.0) - 1.0) * 0.5);
  while (long(R) * (R + 1) / 2 > q) --R;
  while (long(R + 1) * (R + 2) / 2 <= q) ++R;
  const int rb = nb - 1 - R;
  const int cb = nb - 1 - int(q - long(R) * (R + 1) / 2);
  const int tid = threadIdx.x;
  const int i = rb * MASK_ROWS + tid;
  const int words = (k + 31) >> 5;

  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const float4* bb = boxes + size_t(b) * k;
    __syncthreads();                      // the last image's reads are done
    const int jt = cb * MASK_ROWS + tid;
    if (jt < k) {
      const float4 v = bb[jt];
      col_box[tid] = v;
      col_area[tid] = box_area(v);
    }
    __syncthreads();
    if (i >= k) continue;
    const float4 bi = bb[i];
    const float ai = box_area(bi);
    uint32_t* row = work + (size_t(b) * k + i) * wp;
    // off the diagonal and inside k, every column j > i counts
    const bool full = cb > rb && (cb + 1) * MASK_ROWS <= k;
#pragma unroll
    for (int h = 0; h < MASK_ROWS / 32; ++h) {
      const int w = cb * (MASK_ROWS / 32) + h;
      if (w >= words) break;
      uint32_t bits = 0;
#pragma unroll 8
      for (int t = 0; t < 32; ++t) {
        const int j = w * 32 + t;
        if (!full && (j <= i || j >= k)) continue;
        if (suppresses(bi, ai, col_box[h * 32 + t], col_area[h * 32 + t], thresh))
          bits |= 1u << t;
      }
      row[w] = bits;
    }
  }
}

// the scan's tiles in order: band w, then its chunks c of TILE_WORDS
// columns from w & ~3 up to wp
struct Tile {
  int w, c;
};

__device__ __forceinline__ Tile next_tile(Tile t, int wp) {
  if ((t.w & ~3) + (t.c + 1) * TILE_WORDS < wp) return {t.w, t.c + 1};
  return {t.w + 1, 0};
}

// a band's rows (zeros past k) at dst, then with its first tile the
// band's 32 scores (zero, so not valid, past k)
__device__ __forceinline__ void load_tile(uint32_t* dst, const uint32_t* wb, const float* ss,
                                          Tile t, int k, int wp, int words) {
  const int lane = threadIdx.x;
  if (t.w < words) {
    const int col0 = (t.w & ~3) + t.c * TILE_WORDS;
    const int chunks = min(TILE_WORDS, wp - col0) / 4;   // 16-byte chunks of a row
    for (int idx = lane; idx < 32 * chunks; idx += 32) {
      const int r = idx / chunks, ch = idx - r * chunks;
      const int i = t.w * 32 + r;
      const bool ok = i < k;
      cp_async16(smem_addr(dst + r * TILE_ROW + 4 * ch),
                 ok ? wb + size_t(i) * wp + col0 + 4 * ch : wb, ok);
    }
    if (t.c == 0) {
      const int i = t.w * 32 + lane;
      cp_async4(smem_addr(dst + 32 * TILE_ROW + lane), i < k ? ss + i : ss, i < k);
    }
  }
  cp_async_commit();                      // an empty group past the last tile
}

__global__ void __launch_bounds__(32)
nms_scan_kernel(const uint32_t* __restrict__ work,   // (B,k,wp)
                const float* __restrict__ scores,    // (B,k)
                unsigned char* __restrict__ keep,    // (B,k) 0/1
                int k, int wp) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tiles = smem;                             // STAGES x TILE
  uint32_t* removed = tiles + STAGES * TILE;          // wp words
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int words = (k + 31) >> 5;
  const uint32_t* wb = work + size_t(b) * k * wp;
  const float* ss = scores + size_t(b) * k;

  Tile ahead{0, 0};
  for (int s = 0; s < STAGES - 1; ++s) {
    load_tile(tiles + s * TILE, wb, ss, ahead, k, wp, words);
    ahead = next_tile(ahead, wp);
  }
  for (int w = lane; w < wp; w += 32) removed[w] = 0;

  uint32_t kept = 0;                      // the current band's kept boxes
  int n = 0;                              // tiles consumed
  for (Tile cur{0, 0}; cur.w < words; cur = next_tile(cur, wp), ++n) {
    // the buffer of tile n - 1, which every lane has left at the last
    // __syncwarp
    load_tile(tiles + ((n + STAGES - 1) % STAGES) * TILE, wb, ss, ahead, k, wp, words);
    ahead = next_tile(ahead, wp);
    cp_async_wait_group<STAGES - 1>();    // this lane's copies of tile n landed
    __syncwarp();                         // every lane's did
    const uint32_t* tile = tiles + (n % STAGES) * TILE;
    const int col0 = (cur.w & ~3) + cur.c * TILE_WORDS;
    if (cur.c == 0) {
      const float score = __uint_as_float(tile[32 * TILE_ROW + lane]);
      // row 32w + lane's diagonal word (its bits j > i inside word w)
      const uint32_t diag = tile[lane * TILE_ROW + (cur.w - col0)];
      uint32_t cand = __ballot_sync(0xffffffffu, score > 0.0f) & ~removed[cur.w];
      kept = 0;
      while (cand) {
        const int t = __ffs(cand) - 1;
        kept |= 1u << t;
        cand &= ~__shfl_sync(0xffffffffu, diag, t);
        cand &= ~(1u << t);
      }
      const int i = cur.w * 32 + lane;
      if (i < k) keep[size_t(b) * k + i] = (kept >> lane) & 1u;
    }
    if (kept != 0) {
      const int ncols = min(TILE_WORDS, wp - col0);
      for (int col = lane; col < ncols; col += 32) {
        if (col0 + col <= cur.w) continue;   // only the words after the band's own
        uint32_t acc = 0;
#pragma unroll
        for (int t = 0; t < 32; ++t)
          if ((kept >> t) & 1u) acc |= tile[t * TILE_ROW + col];
        removed[col0 + col] |= acc;
      }
    }
    __syncwarp();                         // removed is current; tile n's buffer is free
  }
  cp_async_wait_all();
}

size_t scan_smem_bytes(int wp) {
  return (size_t(STAGES) * TILE + size_t(wp)) * 4;
}

}  // namespace

extern "C" {

// boxes (B,k,4) f32, scores (B,k) f32, keep (B,k) 1-byte bool, `work` a
// (B, k, wp) uint32 workspace with wp = ceil(k/32) rounded up to a
// multiple of 4 (ops/nms_fp.py `workspace_words`; no need to clear it);
// contiguous, boxes and work 16-byte aligned. Launches the mask kernel
// then the scan on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for shapes it does not take).
int nms_fp(const void* boxes, const void* scores, void* keep, void* work, int B, int k,
           float thresh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 0 || B < 0) return int(cudaErrorInvalidValue);
  if (B == 0 || k == 0) return int(cudaGetLastError());
  const int words = (k + 31) / 32;
  const int wp = (words + 3) & ~3;
  const size_t smem = scan_smem_bytes(wp);
  if (smem > SMEM_MAX) return int(cudaErrorInvalidValue);
  const int nb = (k + MASK_ROWS - 1) / MASK_ROWS;
  const long blocks = long(nb) * (nb + 1) / 2;
  if (blocks > 0x7fffffffL) return int(cudaErrorInvalidValue);
  cudaError_t e = allow_dynamic_smem<&nms_scan_kernel>(int(SMEM_MAX));
  if (e != cudaSuccess) return int(e);
  nms_mask_kernel<<<dim3(unsigned(blocks), unsigned(B < 65535 ? B : 65535)), MASK_ROWS, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<uint32_t*>(work), B, k, wp, nb, thresh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  nms_scan_kernel<<<B, 32, smem, s>>>(
      static_cast<const uint32_t*>(work), static_cast<const float*>(scores),
      static_cast<unsigned char*>(keep), k, wp);
  return int(cudaGetLastError());
}

const char* nms_fp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
