// COCO-protocol per-class evaluation, C++ core (own copy of the JAX
// package's native/coco_eval.cpp, the same source line for line below
// this header).
//
// Native replacement for pycocotools' C/Cython COCOeval. The Python
// implementation in eval/coco_eval.py is the semantic oracle; this file
// accelerates the hot loops (per-image greedy matching at 10 IoU
// thresholds + PR accumulation) for full-dataset sweeps.
//
// Semantics (kept in lockstep with eval/coco_eval.py and covered by
// tests/test_torch_coco_eval.py):
//   * detections per image sorted by score (stable), capped at max_dets;
//   * greedy match: each det takes the unmatched GT with the highest IoU
//     >= threshold (ties -> later GT, like pycocotools' running update);
//   * AP@0.5 with 101-point interpolated precision envelope;
//   * AR = mean over the 10 thresholds of final recall.
//
// Built at first use by native/__init__.py:
//   g++ -O3 -shared -fPIC -std=c++17 -o build/native/libcocoeval-<hash>.so coco_eval.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kNumThresh = 10;
constexpr int kNumRecall = 101;

struct Det {
  float score;
  float box[4];  // xywh
};

double iou_xywh(const float* a, const float* b) {
  const double ax2 = a[0] + a[2], ay2 = a[1] + a[3];
  const double bx2 = b[0] + b[2], by2 = b[1] + b[3];
  const double iw = std::min(ax2, bx2) - std::max((double)a[0], (double)b[0]);
  const double ih = std::min(ay2, by2) - std::max((double)a[1], (double)b[1]);
  if (iw <= 0 || ih <= 0) return 0.0;
  const double inter = iw * ih;
  const double uni = (double)a[2] * a[3] + (double)b[2] * b[3] - inter;
  return uni < 1e-9 ? 0.0 : inter / uni;
}

}  // namespace

extern "C" {

// det_*: n_det entries; det_img in [0, n_imgs); boxes xywh row-major.
// gt_*: n_gt entries, same convention.
// out: [ap50, ar]. Returns 0 on success, 1 when the class has no GT
// (outputs set to -1, mirroring the Python evaluator).
int coco_eval_class(const int* det_img, const float* det_score,
                    const float* det_box, int64_t n_det, const int* gt_img,
                    const float* gt_box, int64_t n_gt, int n_imgs,
                    int max_dets, double* out) {
  out[0] = out[1] = -1.0;
  if (n_gt == 0) return 1;

  // bucket by image
  std::vector<std::vector<Det>> dets(n_imgs);
  for (int64_t i = 0; i < n_det; ++i) {
    const int im = det_img[i];
    if (im < 0 || im >= n_imgs) continue;
    Det d;
    d.score = det_score[i];
    std::memcpy(d.box, det_box + 4 * i, sizeof(d.box));
    dets[im].push_back(d);
  }
  std::vector<std::vector<const float*>> gts(n_imgs);
  for (int64_t i = 0; i < n_gt; ++i) {
    const int im = gt_img[i];
    if (im >= 0 && im < n_imgs) gts[im].push_back(gt_box + 4 * i);
  }

  std::vector<float> all_scores;
  // matches[t] bitset per detection, aligned with all_scores order
  std::vector<std::vector<uint8_t>> matches(kNumThresh);

  std::vector<double> thresh(kNumThresh);
  // (50 + 5t)/100.0 reproduces numpy's arange(0.5, 1.0, 0.05).round(2)
  // bit-for-bit (0.5 + 0.05*t differs by 1 ulp at t=7 -> an IoU of
  // exactly 0.85 would match in Python but not here)
  for (int t = 0; t < kNumThresh; ++t) thresh[t] = (50 + 5 * t) / 100.0;

  for (int im = 0; im < n_imgs; ++im) {
    auto& dv = dets[im];
    if (dv.empty()) continue;
    std::stable_sort(dv.begin(), dv.end(), [](const Det& a, const Det& b) {
      return a.score > b.score;
    });
    const int nd = std::min<int>((int)dv.size(), max_dets);
    const auto& gv = gts[im];
    const int ng = (int)gv.size();

    // IoU cache
    std::vector<double> ious((size_t)nd * ng);
    for (int d = 0; d < nd; ++d)
      for (int g = 0; g < ng; ++g)
        ious[(size_t)d * ng + g] = iou_xywh(dv[d].box, gv[g]);

    for (int t = 0; t < kNumThresh; ++t) {
      std::vector<uint8_t> taken(ng, 0);
      const double thr = std::min(thresh[t], 1.0 - 1e-10);
      for (int d = 0; d < nd; ++d) {
        double best = thr;
        int bm = -1;
        for (int g = 0; g < ng; ++g) {
          if (taken[g]) continue;
          const double v = ious[(size_t)d * ng + g];
          if (v < best) continue;
          best = v;
          bm = g;
        }
        uint8_t m = 0;
        if (bm >= 0) {
          taken[bm] = 1;
          m = 1;
        }
        matches[t].push_back(m);
      }
    }
    for (int d = 0; d < nd; ++d) all_scores.push_back(dv[d].score);
  }

  const int64_t total = (int64_t)all_scores.size();
  if (total == 0) {
    out[0] = out[1] = 0.0;
    return 0;
  }

  // global stable sort by descending score
  std::vector<int64_t> order(total);
  for (int64_t i = 0; i < total; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return all_scores[a] > all_scores[b];
  });

  // AP@0.5 (t = 0)
  {
    std::vector<double> pr(total), rc(total);
    double tp = 0, fp = 0;
    for (int64_t i = 0; i < total; ++i) {
      if (matches[0][order[i]])
        tp += 1;
      else
        fp += 1;
      rc[i] = tp / (double)n_gt;
      pr[i] = tp / std::max(tp + fp, 1e-300);
    }
    for (int64_t i = total - 2; i >= 0; --i) pr[i] = std::max(pr[i], pr[i + 1]);
    double ap = 0.0;
    for (int r = 0; r < kNumRecall; ++r) {
      // r * 0.01 == numpy linspace(0, 1, 101)[r] bit-for-bit (r/100.0
      // differs at 10 of the 101 points)
      const double want = r * 0.01;
      // searchsorted left
      int64_t lo = 0, hi = total;
      while (lo < hi) {
        const int64_t mid = (lo + hi) / 2;
        if (rc[mid] < want)
          lo = mid + 1;
        else
          hi = mid;
      }
      if (lo < total) ap += pr[lo];
    }
    out[0] = ap / kNumRecall;
  }

  // AR: mean final recall over thresholds
  double ar = 0.0;
  for (int t = 0; t < kNumThresh; ++t) {
    int64_t tp = 0;
    for (int64_t i = 0; i < total; ++i) tp += matches[t][i];
    ar += (double)tp / (double)n_gt;
  }
  out[1] = ar / kNumThresh;
  return 0;
}

// Greedy hard NMS on xyxy boxes sorted by descending score.
// keep: out array of n uint8.
void greedy_nms(const float* boxes, const float* scores, int n,
                float iou_thresh, uint8_t* keep) {
  for (int i = 0; i < n; ++i) keep[i] = scores[i] > 0.f ? 1 : 0;
  std::vector<double> area(n);
  for (int i = 0; i < n; ++i) {
    const float* b = boxes + 4 * i;
    area[i] = std::max(0.f, b[2] - b[0]) * (double)std::max(0.f, b[3] - b[1]);
  }
  for (int i = 0; i < n; ++i) {
    if (!keep[i]) continue;
    const float* bi = boxes + 4 * i;
    for (int j = i + 1; j < n; ++j) {
      if (!keep[j]) continue;
      const float* bj = boxes + 4 * j;
      const double iw =
          std::min(bi[2], bj[2]) - std::max(bi[0], bj[0]);
      const double ih =
          std::min(bi[3], bj[3]) - std::max(bi[1], bj[1]);
      if (iw <= 0 || ih <= 0) continue;
      const double inter = iw * ih;
      const double uni = std::max(area[i] + area[j] - inter, 1e-9);
      if (inter / uni > iou_thresh) keep[j] = 0;
    }
  }
}

}  // extern "C"
