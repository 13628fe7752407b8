// Greedy per-image detection<->GT matching for the keypoint evaluator.
//
// Native counterpart of detrpose_tpu_torch/data/evaluator.py::_evaluate_img's
// matching loops (the pycocotools evaluateImg protocol): for each OKS
// threshold, detections in score order greedily take the best still-available
// GT; matched non-crowd GTs can't be re-matched; ignored-GT matches mark the
// detection ignored.
//
// The port's own copy of the JAX package's native/coco_match.cc. Built on
// demand by detrpose_tpu_torch/utils/native.py (g++ -O2 -shared, into the
// package's _build/) and called through ctypes; the Python loop beside the
// call is the fallback and the reference.

#include <cstdint>

extern "C" void match_image(
    int T, int D, int G,
    const double* ious,        // D x G row-major
    const double* thrs,        // T
    const uint8_t* gt_ignore,  // G
    const uint8_t* gt_iscrowd, // G
    int64_t* gtm,              // T x G, init -1
    int64_t* dtm,              // T x D, init -1
    uint8_t* dt_ignore         // T x D, init 0
) {
  for (int t = 0; t < T; ++t) {
    int64_t* gtm_t = gtm + (int64_t)t * G;
    int64_t* dtm_t = dtm + (int64_t)t * D;
    uint8_t* dti_t = dt_ignore + (int64_t)t * D;
    for (int d = 0; d < D; ++d) {
      double iou = thrs[t] < (1.0 - 1e-10) ? thrs[t] : (1.0 - 1e-10);
      int m = -1;
      const double* iou_d = ious + (int64_t)d * G;
      for (int g = 0; g < G; ++g) {
        // already-matched gts can only be re-matched if iscrowd
        if (gtm_t[g] >= 0 && !gt_iscrowd[g]) continue;
        // past matchable non-ignore gts (gts are sorted ignore-last)
        if (m > -1 && !gt_ignore[m] && gt_ignore[g]) break;
        if (iou_d[g] < iou) continue;
        iou = iou_d[g];
        m = g;
      }
      if (m == -1) continue;
      dtm_t[d] = m;
      gtm_t[m] = d;
      dti_t[d] = gt_ignore[m];
    }
  }
}
