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
// negligible. Design: one block per image. The boxes and areas go to
// shared memory; the strictly-lower suppression matrix is built there as
// a bitmask (row i, word w holds j = 32w..32w+31 > i), rows padded by one
// word so that the 32 lanes of a warp, which take 32 consecutive rows,
// write to 32 different banks. One warp then runs the greedy scan word by
// word: each lane holds the `removed` bits of its words, and only kept
// boxes cost an iteration (OR of their row into `removed`). At k = 1024
// the matrix is 132 KB, so the block asks for up to 227 KB of dynamic
// shared memory; the wrapper refuses a k that does not fit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int MAX_WORD_REGS = 2;   // removed words per lane: k <= 2048

__global__ void __launch_bounds__(THREADS)
nms_fp_kernel(const float4* __restrict__ boxes,   // (B,k) xyxy
              const float* __restrict__ scores,   // (B,k)
              unsigned char* __restrict__ keep,   // (B,k) 0/1
              int k, float thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) >> 5;
  const int stride = words + 1;                  // padded row, in words
  float4* bx = reinterpret_cast<float4*>(smem);
  float* area = reinterpret_cast<float*>(bx + k);
  uint32_t* valid_bits = reinterpret_cast<uint32_t*>(area + k);
  uint32_t* keep_bits = valid_bits + words;
  uint32_t* mask = keep_bits + words;            // k x stride

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float4* bb = boxes + size_t(b) * k;
  const float* ss = scores + size_t(b) * k;

  for (int i = tid; i < k; i += THREADS) {
    float4 v = bb[i];
    bx[i] = v;
    area[i] = fmaxf(v.z - v.x, 0.0f) * fmaxf(v.w - v.y, 0.0f);
  }
  for (int w = tid; w < words; w += THREADS) {
    uint32_t bits = 0;
    for (int t = 0; t < 32; ++t) {
      int j = w * 32 + t;
      if (j < k && ss[j] > 0.0f) bits |= 1u << t;
    }
    valid_bits[w] = bits;
  }
  __syncthreads();

  // suppression bitmask: consecutive threads take consecutive rows i of
  // one word w, so box j is a shared-memory broadcast
  for (int idx = tid; idx < words * k; idx += THREADS) {
    const int w = idx / k, i = idx - w * k;
    uint32_t bits = 0;
    if (w * 32 + 31 > i) {
      const float4 bi = bx[i];
      const float ai = area[i];
      for (int t = 0; t < 32; ++t) {
        const int j = w * 32 + t;
        if (j <= i || j >= k) continue;
        const float4 bj = bx[j];
        const float iw = fmaxf(fminf(bi.z, bj.z) - fmaxf(bi.x, bj.x), 0.0f);
        const float ih = fmaxf(fminf(bi.w, bj.w) - fmaxf(bi.y, bj.y), 0.0f);
        const float inter = iw * ih;
        const float uni = fmaxf(ai + area[j] - inter, 1e-8f);
        if (inter / uni > thresh) bits |= 1u << t;
      }
    }
    mask[i * stride + w] = bits;
  }
  __syncthreads();

  if (tid < 32) {
    const int lane = tid;
    uint32_t removed[MAX_WORD_REGS];
#pragma unroll
    for (int r = 0; r < MAX_WORD_REGS; ++r) removed[r] = 0;
    for (int w = 0; w < words; ++w) {
      const int reg = w >> 5;
      uint32_t mine = removed[0];
#pragma unroll
      for (int r = 1; r < MAX_WORD_REGS; ++r)
        if (reg == r) mine = removed[r];
      const uint32_t rem_w = __shfl_sync(0xffffffffu, mine, w & 31);
      uint32_t cand = valid_bits[w] & ~rem_w;
      uint32_t kept = 0;
      while (cand) {
        const int t = __ffs(cand) - 1;
        const uint32_t* row = mask + (w * 32 + t) * stride;
        kept |= 1u << t;
#pragma unroll
        for (int r = 0; r < MAX_WORD_REGS; ++r) {
          const int ww = lane + 32 * r;
          if (ww < words) removed[r] |= row[ww];
        }
        cand &= ~row[w];
        cand &= ~(1u << t);
      }
      if (lane == 0) keep_bits[w] = kept;
    }
  }
  __syncthreads();

  for (int i = tid; i < k; i += THREADS)
    keep[size_t(b) * k + i] = (keep_bits[i >> 5] >> (i & 31)) & 1u;
}

size_t smem_bytes(int k) {
  const size_t words = (size_t(k) + 31) / 32;
  return size_t(k) * 16 + size_t(k) * 4 + 2 * words * 4 +
         size_t(k) * (words + 1) * 4;
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for k boxes per image.
size_t nms_fp_smem_bytes(int k) { return smem_bytes(k); }

// boxes (B,k,4) f32, scores (B,k) f32, keep (B,k) 1-byte bool; contiguous,
// boxes 16-byte aligned. Launches on `stream`; returns cudaGetLastError().
int nms_fp(const void* boxes, const void* scores, void* keep, int B, int k,
           float thresh, void* stream) {
  const size_t smem = smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      nms_fp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (B > 0 && k > 0)
    nms_fp_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(boxes), static_cast<const float*>(scores),
        static_cast<unsigned char*>(keep), k, thresh);
  return int(cudaGetLastError());
}

const char* nms_fp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
