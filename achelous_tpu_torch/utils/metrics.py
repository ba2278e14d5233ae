"""Evaluation metrics: detection mAP (COCO-style + VOC), segmentation mIoU,
point-cloud mIoU.

A copy of achelous_tpu/utils/metrics.py, which is numpy only; the port
keeps its own so that it imports nothing of the JAX package.

Replaces reference utils/utils_map.py (VOC get_map :276-797, pycocotools
get_coco_map :894-922), utils_seg/utils_metrics.py:35-60 and
utils_seg_pc/utils_metrics.py:6-23 — computed fully in memory (no txt/png
file exchange) in pure numpy (pycocotools is not available in this image;
the COCO AP here uses the standard 101-point interpolation and matching
rules, so numbers are comparable).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# segmentation (reference utils_seg/utils_metrics.py)
# ---------------------------------------------------------------------------


def fast_hist(label: np.ndarray, pred: np.ndarray, n: int) -> np.ndarray:
    """Confusion matrix accumulator (utils_seg/utils_metrics.py:35-44)."""
    k = (label >= 0) & (label < n)
    return np.bincount(n * label[k].astype(int) + pred[k],
                       minlength=n ** 2).reshape(n, n)


def per_class_iu(hist):
    return np.diag(hist) / np.maximum(hist.sum(1) + hist.sum(0) - np.diag(hist), 1)


def per_class_pa_recall(hist):
    return np.diag(hist) / np.maximum(hist.sum(1), 1)


def per_class_precision(hist):
    return np.diag(hist) / np.maximum(hist.sum(0), 1)


def per_accuracy(hist):
    return np.sum(np.diag(hist)) / np.maximum(np.sum(hist), 1)


def compute_miou(gts: Sequence[np.ndarray], preds: Sequence[np.ndarray],
                 num_classes: int) -> Dict[str, np.ndarray]:
    """mIoU over a list of (gt, pred) label maps
    (utils_seg/utils_metrics.py:63-107)."""
    hist = np.zeros((num_classes, num_classes), np.int64)
    for g, p in zip(gts, preds):
        hist += fast_hist(g.flatten(), p.flatten(), num_classes)
    return {"hist": hist, "iou": per_class_iu(hist),
            "pa_recall": per_class_pa_recall(hist),
            "precision": per_class_precision(hist),
            "miou": float(np.nanmean(per_class_iu(hist))),
            "accuracy": float(per_accuracy(hist))}


def pc_mean_iou(confusion: np.ndarray) -> float:
    """Point-cloud seg mIoU (utils_seg_pc/utils_metrics.py:6-23)."""
    inter = np.diag(confusion)
    union = confusion.sum(1) + confusion.sum(0) - inter
    iou = inter / np.maximum(union, 1)
    return float(np.mean(iou))


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------


def box_iou_xyxy(a: np.ndarray, b: np.ndarray,
                 plus_one: bool = False) -> np.ndarray:
    """IoU matrix between [N,4] and [M,4] xyxy boxes.

    plus_one=True uses the classic VOC-devkit pixel convention
    (w = x2 - x1 + 1; reference utils_map.py:468-474) — the VOC mAP path
    needs it for exact parity; COCO/pycocotools use the continuous
    convention (plus_one=False)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    e = 1.0 if plus_one else 0.0
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + e, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0] + e) * (a[:, 3] - a[:, 1] + e)
    area_b = (b[:, 2] - b[:, 0] + e) * (b[:, 3] - b[:, 1] + e)
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-12)


def log_average_miss_rate(precision: np.ndarray, fp_cumsum: np.ndarray,
                          num_images: int):
    """LAMR averaged at 9 log-spaced FPPI points in [1e-2, 1e0]
    (reference utils/utils_map.py:31-67)."""
    if precision.size == 0:
        return 0.0, 1.0, 0.0
    fppi = fp_cumsum / float(num_images)
    mr = 1.0 - precision
    fppi_tmp = np.insert(fppi, 0, -1.0)
    mr_tmp = np.insert(mr, 0, 1.0)
    ref = np.logspace(-2.0, 0.0, num=9)
    for i, r in enumerate(ref):
        j = np.where(fppi_tmp <= r)[0][-1]
        ref[i] = mr_tmp[j]
    lamr = float(np.exp(np.mean(np.log(np.maximum(1e-10, ref)))))
    return lamr, mr, fppi


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """Continuous VOC AP (reference utils/utils_map.py:95-150)."""
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _match_class(dets: List[Tuple[float, np.ndarray]],
                 gts_per_img: Dict[int, np.ndarray],
                 iou_thr: float,
                 coco: bool = False) -> Tuple[np.ndarray, np.ndarray, int]:
    """Greedy score-ordered matching for one class at one IoU threshold.

    dets: list of (score, box, img_id) sorted desc by score.
    Returns (tp flags, fp flags, n_gt).

    Two matching rules exist in the reference's eval stack:
      * coco=True — pycocotools COCOeval.evaluateImg: each detection matches
        the highest-IoU GT among the *still-unmatched* GTs clearing the
        threshold (a det can fall through to the 2nd-best GT if the best was
        taken by a higher-scored det);
      * coco=False — VOC get_map (utils_map.py:542-571): the detection is
        tied to its overall argmax-IoU GT; if that GT is already used the
        det is a false positive even when another GT would match.
    """
    n_gt = sum(len(v) for v in gts_per_img.values())
    matched = {k: np.zeros(len(v), bool) for k, v in gts_per_img.items()}
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, (score, box, img) in enumerate(dets):
        gt = gts_per_img.get(img)
        if gt is None or len(gt) == 0:
            fp[i] = 1
            continue
        # VOC path uses the devkit's +1-pixel IoU (utils_map.py:468-474)
        ious = box_iou_xyxy(box[None], gt, plus_one=not coco)[0]
        if coco:
            free = ~matched[img] & (ious >= iou_thr)
            if free.any():
                # pycocotools evaluateImg scans GTs with `if iou < best:
                # continue` — equality UPDATES, so among free GTs tying at
                # the max IoU the LAST one wins (np.argmax would take the
                # first; counterexample pinned in test_coco_golden.py)
                vals = np.where(free, ious, -1.0)
                j = int(np.flatnonzero(vals == vals.max())[-1])
                matched[img][j] = True
                tp[i] = 1
            else:
                fp[i] = 1
        else:
            j = int(np.argmax(ious))
            if ious[j] >= iou_thr and not matched[img][j]:
                matched[img][j] = True
                tp[i] = 1
            else:
                fp[i] = 1
    return tp, fp, n_gt


def _ap_recall_at(tp, fp, n_gt, coco_interp=True):
    if n_gt == 0:
        return np.nan, np.nan
    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    rec = ctp / n_gt
    prec = ctp / np.maximum(ctp + cfp, 1e-12)
    recall = rec[-1] if len(rec) else 0.0
    if not coco_interp:
        return voc_ap(rec, prec), recall
    # COCO 101-point interpolation
    mpre = prec.copy()
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    r_points = np.linspace(0, 1, 101)
    idx = np.searchsorted(rec, r_points, side="left")
    ap = float(np.mean([mpre[i] if i < len(mpre) else 0.0 for i in idx]))
    return ap, recall


def compute_det_metrics(detections: List[Dict], ground_truths: List[Dict],
                        num_classes: int, max_det: int = 100,
                        per_class: bool = False) -> Dict[str, float]:
    """COCO-style detection metrics, fully in memory.

    detections: per image {'boxes': [N,4] xyxy, 'scores': [N], 'classes': [N]}
    ground_truths: per image {'boxes': [M,4] xyxy, 'classes': [M]}
    Returns mAP50-95, mAP50, mAP75, AR100 (averaged over classes present in
    the GT, matching pycocotools conventions; reference callbacks report
    stats[1] = AP50, utils/callbacks.py:267-271).

    Semantics are pycocotools-exact for useCats=1 / area 'all' / no crowd:
    best-unmatched-GT matching, per-(image,category) maxDets truncation,
    stable score sorts, 101-point searchsorted interpolation — cross-
    validated to 1e-9 against an independent COCOeval transcription in
    tests/test_coco_golden.py (pycocotools itself is not installed here).
    """
    iou_thrs = np.linspace(0.5, 0.95, 10)   # exact decimals (pycocotools)
    per_cls_dets = {c: [] for c in range(num_classes)}
    per_cls_gts = {c: {} for c in range(num_classes)}
    for img_id, (det, gt) in enumerate(zip(detections, ground_truths)):
        scores = np.asarray(det["scores"])
        classes = np.asarray(det["classes"])
        for c in range(num_classes):
            # maxDets applies per image PER CATEGORY (pycocotools
            # evaluateImg truncates the per-(img,cat) det list)
            dm = np.where(classes == c)[0]
            order = dm[np.argsort(-scores[dm], kind="mergesort")][:max_det]
            for i in order:
                per_cls_dets[c].append((float(scores[i]),
                                        np.asarray(det["boxes"][i]), img_id))
            m = np.asarray(gt["classes"]) == c
            if m.any():
                per_cls_gts[c][img_id] = np.asarray(gt["boxes"])[m]

    aps = np.full((num_classes, len(iou_thrs)), np.nan)
    recalls = np.full((num_classes, len(iou_thrs)), np.nan)
    for c in range(num_classes):
        if not per_cls_gts[c]:
            continue
        dets = sorted(per_cls_dets[c], key=lambda t: -t[0])  # stable
        for k, thr in enumerate(iou_thrs):
            tp, fp, n_gt = _match_class(dets, per_cls_gts[c], thr, coco=True)
            aps[c, k], recalls[c, k] = _ap_recall_at(tp, fp, n_gt)
    out = {
        "mAP50-95": float(np.nanmean(aps)) if not np.isnan(aps).all() else 0.0,
        "mAP50": float(np.nanmean(aps[:, 0])) if not np.isnan(aps[:, 0]).all() else 0.0,
        "mAP75": float(np.nanmean(aps[:, 5])) if not np.isnan(aps[:, 5]).all() else 0.0,
        "AR100": float(np.nanmean(recalls)) if not np.isnan(recalls).all() else 0.0,
    }
    if per_class:
        # per-class AP50 / AP (classes absent from the GT -> NaN, matching
        # pycocotools' -1 sentinel semantics of "not evaluated")
        out["per_class_ap50"] = {c: float(aps[c, 0])
                                 for c in range(num_classes)}
        out["per_class_ap"] = {c: float(np.mean(aps[c]))
                               for c in range(num_classes)}
    return out


def compute_voc_map(detections: List[Dict], ground_truths: List[Dict],
                    num_classes: int, iou_thr: float = 0.5) -> Dict[str, float]:
    """VOC mAP at a single IoU (reference get_map, utils_map.py:276-797)."""
    table = voc_per_class_table(detections, ground_truths, num_classes,
                                iou_thr)
    aps = [row["ap"] for row in table.values()]
    return {"mAP": float(np.mean(aps)) if aps else 0.0}


def voc_per_class_table(detections: List[Dict], ground_truths: List[Dict],
                        num_classes: int, iou_thr: float = 0.5
                        ) -> Dict[int, Dict[str, float]]:
    """Per-class AP / LAMR / recall / precision — the table the reference
    prints and plots per class (utils/utils_map.py:560-640: AP from the VOC
    matching at min_overlap, LAMR from log_average_miss_rate(rec, fp,
    n_images-containing-the-class), final recall/precision of the full
    ranked list).  Classes with no GT are omitted (reference iterates
    gt_classes only)."""
    out: Dict[int, Dict[str, float]] = {}
    for c in range(num_classes):
        dets, gts = [], {}
        for img_id, (det, gt) in enumerate(zip(detections, ground_truths)):
            m = np.asarray(det["classes"]) == c
            for s, b in zip(np.asarray(det["scores"])[m],
                            np.asarray(det["boxes"])[m]):
                dets.append((float(s), b, img_id))
            gm = np.asarray(gt["classes"]) == c
            if gm.any():
                gts[img_id] = np.asarray(gt["boxes"])[gm]
        if not gts:
            continue
        dets.sort(key=lambda t: -t[0])
        tp, fp, n_gt = _match_class(dets, gts, iou_thr)
        ap, _ = _ap_recall_at(tp, fp, n_gt, coco_interp=False)
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        rec = ctp / n_gt
        prec = ctp / np.maximum(ctp + cfp, 1e-12)
        # reference utils_map.py:599 passes the RECALL cumsum and the fp
        # cumsum, with n_images = images containing this class
        lamr, _, _ = log_average_miss_rate(rec, cfp, len(gts))
        out[c] = {"ap": float(ap), "lamr": float(lamr),
                  "recall": float(rec[-1]) if len(rec) else 0.0,
                  "precision": float(prec[-1]) if len(prec) else 0.0,
                  "n_gt": int(n_gt)}
    return out
