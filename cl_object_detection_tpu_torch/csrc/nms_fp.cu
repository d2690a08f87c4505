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
// operations each outside the tensor cores, then a scan whose length is
// the number of kept boxes; the bytes (k boxes in, k bytes out) are
// negligible. Design: one block per image. The strictly-lower suppression
// matrix is built as a bitmask (row i, word w holds j = 32w..32w+31 > i),
// then one warp runs the greedy scan word by word: only kept boxes cost
// an iteration (OR of their row into the `removed` words). Two forms of
// the bitmask:
// * shared memory, while it fits (k <= 1248): the boxes and areas go
//   there too, and rows are padded by one word so that the 32 lanes of a
//   warp, which build 32 consecutive rows, write to 32 different banks.
//   The scan keeps the `removed` words in registers, two per lane.
// * otherwise a global-memory workspace of k x words words per image that
//   the wrapper allocates. The boxes are read through L1 and the areas
//   recomputed (the same IEEE operations, so the same bits); consecutive
//   threads build consecutive words of one row, so the stores coalesce.
//   The `removed` words live in shared memory; shared memory then holds
//   three bit rows, 12 bytes per 32 boxes, which is the only cap on k.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr size_t SMEM_MAX = 232448;   // shared memory a block may use on sm_90

__device__ __forceinline__ float box_area(float4 v) {
  return fmaxf(v.z - v.x, 0.0f) * fmaxf(v.w - v.y, 0.0f);
}

// the suppression bits of box i against boxes j = 32w..32w+31 (j > i);
// the areas from `area`, or recomputed from the boxes when RECOMPUTE
template <bool RECOMPUTE>
__device__ __forceinline__ uint32_t suppress_word(float4 bi, float ai, int i, int w, int k,
                                                  const float4* bx, const float* area,
                                                  float thresh) {
  uint32_t bits = 0;
  if (w * 32 + 31 <= i) return bits;
  for (int t = 0; t < 32; ++t) {
    const int j = w * 32 + t;
    if (j <= i || j >= k) continue;
    const float4 bj = bx[j];
    const float aj = RECOMPUTE ? box_area(bj) : area[j];
    const float iw = fmaxf(fminf(bi.z, bj.z) - fmaxf(bi.x, bj.x), 0.0f);
    const float ih = fmaxf(fminf(bi.w, bj.w) - fmaxf(bi.y, bj.y), 0.0f);
    const float inter = iw * ih;
    const float uni = fmaxf(ai + aj - inter, 1e-8f);
    if (inter / uni > thresh) bits |= 1u << t;
  }
  return bits;
}

// the three bit rows (valid, keep, removed) at the start of shared memory,
// padded so that the boxes after them are 16-byte aligned
__host__ __device__ inline size_t bits_bytes(int k) {
  const size_t words = (size_t(k) + 31) / 32;
  return (3 * words * 4 + 15) & ~size_t(15);
}

template <bool GLOBAL_MASK>
__global__ void __launch_bounds__(THREADS)
nms_fp_kernel(const float4* __restrict__ boxes,   // (B,k) xyxy
              const float* __restrict__ scores,   // (B,k)
              unsigned char* __restrict__ keep,   // (B,k) 0/1
              uint32_t* __restrict__ work,        // (B,k,words) when GLOBAL_MASK
              int k, float thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) >> 5;
  uint32_t* valid_bits = reinterpret_cast<uint32_t*>(smem);
  uint32_t* keep_bits = valid_bits + words;
  uint32_t* removed = keep_bits + words;
  // shared form: boxes, areas and the padded k x (words+1) bitmask after
  // the bit rows
  float4* bx = reinterpret_cast<float4*>(smem + bits_bytes(k));
  float* area = reinterpret_cast<float*>(bx + k);
  const int stride = GLOBAL_MASK ? words : words + 1;   // row length, in words

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float4* bb = boxes + size_t(b) * k;
  const float* ss = scores + size_t(b) * k;
  uint32_t* mask = GLOBAL_MASK ? work + size_t(b) * k * words
                               : reinterpret_cast<uint32_t*>(area + k);

  if (!GLOBAL_MASK) {
    for (int i = tid; i < k; i += THREADS) {
      const float4 v = bb[i];
      bx[i] = v;
      area[i] = box_area(v);
    }
  }
  for (int w = tid; w < words; w += THREADS) {
    uint32_t bits = 0;
    for (int t = 0; t < 32; ++t) {
      const int j = w * 32 + t;
      if (j < k && ss[j] > 0.0f) bits |= 1u << t;
    }
    valid_bits[w] = bits;
    removed[w] = 0;                              // read by the global form only
  }
  __syncthreads();

  if (!GLOBAL_MASK) {
    // consecutive threads take consecutive rows i of one word w, so box j
    // is a shared-memory broadcast
    for (int idx = tid; idx < words * k; idx += THREADS) {
      const int w = idx / k, i = idx - w * k;
      mask[i * stride + w] = suppress_word<false>(bx[i], area[i], i, w, k, bx, area, thresh);
    }
  } else {
    // consecutive threads take consecutive words w of one row i
    for (long idx = tid; idx < long(words) * k; idx += THREADS) {
      const int i = int(idx / words), w = int(idx - long(i) * words);
      const float4 bi = bb[i];
      mask[size_t(i) * stride + w] = suppress_word<true>(bi, box_area(bi), i, w, k, bb, nullptr, thresh);
    }
  }
  __syncthreads();

  if (tid < 32) {
    const int lane = tid;
    if constexpr (!GLOBAL_MASK) {
      // k <= 1248, at most 39 words: lane l holds the `removed` bits of
      // words l and l + 32 in registers
      uint32_t rem[2] = {0, 0};
      for (int w = 0; w < words; ++w) {
        const uint32_t rem_w = __shfl_sync(0xffffffffu, w < 32 ? rem[0] : rem[1], w & 31);
        uint32_t cand = valid_bits[w] & ~rem_w;
        uint32_t kept = 0;
        while (cand) {
          const int t = __ffs(cand) - 1;
          const uint32_t* row = mask + (w * 32 + t) * stride;
          kept |= 1u << t;
          if (lane < words) rem[0] |= row[lane];
          if (lane + 32 < words) rem[1] |= row[lane + 32];
          cand &= ~row[w];
          cand &= ~(1u << t);
        }
        if (lane == 0) keep_bits[w] = kept;
      }
    } else {
      // any k: lane l ORs words w + l, w + l + 32, ... of a kept row into
      // `removed` in shared memory (row i has no bits before its own
      // word); the __syncwarp() orders each word's writes before the next
      // word's reads, whichever lanes made them
      for (int w = 0; w < words; ++w) {
        __syncwarp();
        uint32_t cand = valid_bits[w] & ~removed[w];
        uint32_t kept = 0;
        while (cand) {
          const int t = __ffs(cand) - 1;
          const uint32_t* row = mask + size_t(w * 32 + t) * stride;
          kept |= 1u << t;
          for (int ww = w + lane; ww < words; ww += 32) removed[ww] |= row[ww];
          cand &= ~row[w];
          cand &= ~(1u << t);
        }
        if (lane == 0) keep_bits[w] = kept;
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < k; i += THREADS)
    keep[size_t(b) * k + i] = (keep_bits[i >> 5] >> (i & 31)) & 1u;
}

// the shared-memory form's bytes (ops/nms_fp.py `smem_bytes` mirrors it)
size_t smem_bytes(int k) {
  const size_t words = (size_t(k) + 31) / 32;
  return bits_bytes(k) + size_t(k) * 16 + size_t(k) * 4 + size_t(k) * (words + 1) * 4;
}

template <bool GLOBAL_MASK>
int launch(const void* boxes, const void* scores, void* keep, void* work, int B, int k,
           float thresh, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      nms_fp_kernel<GLOBAL_MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (B > 0 && k > 0)
    nms_fp_kernel<GLOBAL_MASK><<<B, THREADS, smem, stream>>>(
        static_cast<const float4*>(boxes), static_cast<const float*>(scores),
        static_cast<unsigned char*>(keep), static_cast<uint32_t*>(work), k, thresh);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// boxes (B,k,4) f32, scores (B,k) f32, keep (B,k) 1-byte bool; contiguous,
// boxes 16-byte aligned. `work`: null for the shared-memory form, else a
// B*k*ceil(k/32) uint32 workspace (no need to clear it) for the global
// form, which takes any k whose bit rows fit. Launches on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue for a form that does
// not fit).
int nms_fp(const void* boxes, const void* scores, void* keep, void* work, int B, int k,
           float thresh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 0 || B < 0) return int(cudaErrorInvalidValue);
  if (work == nullptr) {
    if (smem_bytes(k) > SMEM_MAX) return int(cudaErrorInvalidValue);
    return launch<false>(boxes, scores, keep, work, B, k, thresh, smem_bytes(k), s);
  }
  if (bits_bytes(k) > SMEM_MAX) return int(cudaErrorInvalidValue);
  return launch<true>(boxes, scores, keep, work, B, k, thresh, bits_bytes(k), s);
}

const char* nms_fp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
