"""Instance-map evaluation: per-view Hungarian-matched IoU and COCO-style mAP.

Behavioral parity with /root/reference/networks/evaluator.py:77-180:
 * calculate_ap: sort matched IoUs by per-object confidence (descending), threshold at
   {0.5, 0.75, 0.8, 0.85, 0.9, 0.95} (evaluator.py:10), cumulative precision/recall,
   COCO integral AP (backward-max precision envelope over recall change points);
   the 11-point interpolation variant is kept as an option.
 * ins_eval: argmax predicted labels (optional ScanNet mask -> unlabeled=ins_num and
   drop of that pseudo-label), per-object median confidence from the max-channel
   probability, re-encode predictions as compacted one-hot masks, Hungarian match
   against GT masks, matched IoUs -> AP; also returns the pred->GT label mapping used
   by the visualizer/matching_log.json (tester.py:124-129).

This is offline/eval code and runs host-side in NumPy; the assignment reuses the
framework's own in-graph Jonker-Volgenant solver (objfield.hungarian) on the host
platform so the whole framework has a single matching implementation.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

THRESHOLDS = (0.5, 0.75, 0.8, 0.85, 0.9, 0.95)


def _lsa_rect(cost: np.ndarray) -> np.ndarray:
    """Optimal assignment for a rectangular (rows <= cols) cost matrix.

    Returns col index per row. Pads to square with constant rows (column-
    indifferent), then runs the framework's Jonker-Volgenant solver.
    """
    import jax

    from dmnerf_tpu.objfield.hungarian import linear_sum_assignment_jax

    r, c = cost.shape
    sq = np.zeros((c, c), np.float32)
    sq[:r] = cost
    # the solve is a short serial loop on a tiny matrix: run it on the host CPU
    # backend where one is registered (JAX_PLATFORMS may list only the GPU)
    try:
        device = jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        device = None
    with jax.default_device(device):
        col4row = np.asarray(linear_sum_assignment_jax(sq))
    return col4row[:r]


def _pairwise_costs_np(pred_ins: np.ndarray, gt_ins: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Same math as objfield.losses.pairwise_costs, host-side (evaluator.py:54-68)."""
    n = pred_ins.shape[0]
    log_p = np.log(pred_ins + 1e-8)
    log_1p = np.log(1.0 - pred_ins + 1e-8)
    gt_t = gt_ins.T
    cost_ce = -(gt_t @ log_p + (1.0 - gt_t) @ log_1p) / n
    tp = gt_t @ pred_ins
    pred_sum = pred_ins.sum(axis=0)[None, :]
    gt_sum = gt_ins.sum(axis=0)[:, None]
    siou = tp / (tp + (pred_sum - tp) + (gt_sum - tp) + 1e-6)
    return cost_ce, 1.0 - siou


def calculate_ap(
    ious: np.ndarray,
    gt_number: int,
    confidence: Optional[np.ndarray] = None,
    function_select: str = "integral",
) -> List[float]:
    if confidence is not None:
        order = np.argsort(-confidence, kind="stable")
        vals = ious[order]
    else:
        vals = np.sort(ious)[::-1]

    ap_list = []
    for thre in THRESHOLDS:
        tp = (vals > thre).astype(np.float64)
        cum = np.cumsum(tp)
        precisions = cum / (np.arange(len(tp)) + 1)
        recalls = cum / gt_number
        if function_select == "integral":
            # COCO integral (evaluator.py:92-102)
            mrec = np.concatenate([[0.0], recalls, [1.0]])
            mprec = np.concatenate([[0.0], precisions, [0.0]])
            for i in range(len(mprec) - 1, 0, -1):
                mprec[i - 1] = max(mprec[i - 1], mprec[i])
            idx = np.where(mrec[1:] != mrec[:-1])[0]
            ap = float(np.sum((mrec[idx + 1] - mrec[idx]) * mprec[idx + 1]))
        else:
            # 11-point interpolation (evaluator.py:78-86)
            ap = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                sel = recalls >= t
                p = float(np.max(precisions[sel])) if sel.any() else 0.0
                ap += p / 11.0
        ap_list.append(ap)
    return ap_list


def ins_eval(
    pred_ins: np.ndarray,   # [H, W, ins_num] composited instance probabilities
    gt_ins: np.ndarray,     # [H, W, ins_num] compacted GT one-hot masks
    gt_ins_num: int,
    ins_num: int,
    mask: Optional[np.ndarray] = None,
):
    """Returns (pred_label [H, W], ap[6], matched_gt_labels [gt_ins_num])."""
    pred_label = np.argmax(pred_ins, axis=-1)
    if mask is not None:
        pred_label = pred_label.copy()
        pred_label[mask == 0] = ins_num   # unlabeled pseudo-label (tester.py:105-110)
        valid_pred_labels = np.unique(pred_label)[:-1]
    else:
        valid_pred_labels = np.unique(pred_label)
    valid_pred_num = len(valid_pred_labels)

    # per-object median confidence from the max channel probability
    pred_conf_mask = np.max(pred_ins, axis=-1)
    pred_conf_scores = np.array(
        [np.median(pred_conf_mask[pred_label == label]) for label in valid_pred_labels],
        dtype=np.float64,
    )

    # compacted one-hot re-encoding of the prediction (evaluator.py:147-149)
    flat_label = pred_label.reshape(-1)
    pred_onehot = np.zeros((flat_label.shape[0], ins_num), np.float32)
    for j, label in enumerate(valid_pred_labels):
        pred_onehot[flat_label == label, j] = 1.0

    gt_flat = gt_ins.reshape(-1, ins_num).astype(np.float32)
    cost_ce, cost_siou = _pairwise_costs_np(pred_onehot, gt_flat)
    col4row = _lsa_rect((cost_ce + cost_siou)[:gt_ins_num])

    valid_inds = col4row.copy()
    ious = 1.0 - cost_siou[np.arange(gt_ins_num), valid_inds]

    confidence = np.zeros(gt_ins_num)
    for i, vi in enumerate(valid_inds):
        confidence[i] = pred_conf_scores[vi] if vi < valid_pred_num else 0.0

    ap = calculate_ap(ious, gt_ins_num, confidence=confidence)

    # pred->GT mapping: -1 marks GT objects matched to a nonexistent prediction
    invalid = valid_inds >= valid_pred_num
    safe_inds = np.where(invalid, 0, valid_inds)
    matched = valid_pred_labels[safe_inds].astype(np.int64)
    matched[invalid] = -1

    return pred_label, ap, matched


def compact_gt_one_hot_np(gt_label: np.ndarray, ins_num: int, drop_last: bool = False):
    """Host-side GT one-hot compaction used by the eval drivers
    (tester.py:101-115): columns ordered by ascending unique label.

    drop_last=True reproduces the ScanNet path's ``unique(...)[:-1]`` (drops the
    air/unlabeled pseudo-label, which sorts last).
    """
    valid_labels = np.unique(gt_label)
    if drop_last:
        valid_labels = valid_labels[:-1]
    valid_num = len(valid_labels)
    flat = gt_label.reshape(-1)
    one_hot = np.zeros((flat.shape[0], ins_num), np.float32)
    for j, label in enumerate(valid_labels):
        one_hot[flat == label, j] = 1.0
    return one_hot.reshape(*gt_label.shape, ins_num), valid_num, valid_labels
