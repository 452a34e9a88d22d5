# Copied from the JAX package: paddle_tpu/metrics.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Python-side metrics (reference: python/paddle/fluid/metrics.py)."""

from __future__ import annotations

import numpy as np

__all__ = ["MetricBase", "Accuracy", "ChunkEvaluator", "EditDistance",
           "Auc", "Precision", "Recall", "CompositeMetric",
           "DetectionMAP"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for k, v in self.__dict__.items():
            if isinstance(v, (int, float)):
                setattr(self, k, 0)
            elif isinstance(v, np.ndarray):
                setattr(self, k, np.zeros_like(v))

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no data updated")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(int).reshape(-1)
        labels = np.asarray(labels).astype(int).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        return self.tp / max(self.tp + self.fp, 1)


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(int).reshape(-1)
        labels = np.asarray(labels).astype(int).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        return self.tp / max(self.tp + self.fn, 1)


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1)
        self._stat_neg = np.zeros(num_thresholds + 1)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        pos_score = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        bucket = np.clip((pos_score * self._num_thresholds).astype(int), 0,
                         self._num_thresholds)
        for b, l in zip(bucket, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def eval(self):
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tot_pos, tot_neg = tp[-1], fp[-1]
        if tot_pos * tot_neg == 0:
            return 0.0
        tp0 = np.concatenate([[0], tp[:-1]])
        fp0 = np.concatenate([[0], fp[:-1]])
        return float(np.sum((fp - fp0) * (tp + tp0) / 2.0) / (tot_pos * tot_neg))


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances)
        self.total_distance += float(np.sum(distances))
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(distances > 0))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no data updated")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).reshape(-1)[0])
        self.num_label_chunks += int(np.asarray(num_label_chunks).reshape(-1)[0])
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).reshape(-1)[0])

    def eval(self):
        precision = self.num_correct_chunks / max(self.num_infer_chunks, 1)
        recall = self.num_correct_chunks / max(self.num_label_chunks, 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-6)
        return precision, recall, f1


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class DetectionMAP(MetricBase):
    """Mean average precision for detection (reference: metrics.py:695
    DetectionMAP + operators/detection_map_op; 11-point or integral AP).

    update() takes per-image detections [[label, score, x1,y1,x2,y2], ...]
    (the multiclass_nms output rows) and ground truth
    [[label, x1,y1,x2,y2], ...]."""

    def __init__(self, name=None, overlap_threshold=0.5,
                 ap_version="integral", evaluate_difficult=False):
        super().__init__(name)
        assert ap_version in ("integral", "11point")
        self.overlap_threshold = overlap_threshold
        self.ap_version = ap_version
        self.evaluate_difficult = evaluate_difficult
        self.reset()

    def reset(self, executor=None, program=None):
        self._dets = []       # (img_id, label, score, box)
        self._gts = []        # (img_id, label, box)
        self._img = 0

    @staticmethod
    def _iou(a, b):
        ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
        ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
        iw, ih = max(ix2 - ix1, 0.0), max(iy2 - iy1, 0.0)
        inter = iw * ih
        ua = ((a[2] - a[0]) * (a[3] - a[1]) +
              (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    def update(self, detections, gts):
        """gt rows: [label, x1,y1,x2,y2] or [label, x1,y1,x2,y2,
        difficult]."""
        for d in detections:
            if d[0] < 0:
                continue
            self._dets.append((self._img, int(d[0]), float(d[1]),
                               tuple(float(v) for v in d[2:6])))
        for g in gts:
            difficult = bool(g[5]) if len(g) > 5 else False
            self._gts.append((self._img, int(g[0]),
                              tuple(float(v) for v in g[1:5]), difficult))
        self._img += 1

    def eval(self, executor=None, program=None):
        import collections

        labels = {g[1] for g in self._gts}
        aps = []
        for lab in sorted(labels):
            gts = collections.defaultdict(list)
            npos = 0
            for img, gl, box, difficult in self._gts:
                if gl == lab:
                    hard = difficult and not self.evaluate_difficult
                    gts[img].append([box, False, hard])
                    if not hard:
                        npos += 1
            dets = sorted((d for d in self._dets if d[1] == lab),
                          key=lambda d: -d[2])
            tp, fp = [], []
            for img, _, score, box in dets:
                best, best_g = 0.0, None
                for g in gts.get(img, []):
                    i = self._iou(box, g[0])
                    if i > best:
                        best, best_g = i, g
                if best >= self.overlap_threshold and \
                        best_g is not None:
                    if best_g[2]:
                        continue  # difficult gt: neither tp nor fp (VOC)
                    if not best_g[1]:
                        best_g[1] = True
                        tp.append(1.0)
                        fp.append(0.0)
                    else:
                        tp.append(0.0)
                        fp.append(1.0)
                else:
                    tp.append(0.0)
                    fp.append(1.0)
            if npos == 0:
                continue
            tp = np.cumsum(tp) if tp else np.zeros(0)
            fp = np.cumsum(fp) if fp else np.zeros(0)
            rec = tp / npos if len(tp) else np.zeros(0)
            prec = tp / np.maximum(tp + fp, 1e-9) if len(tp) else \
                np.zeros(0)
            if self.ap_version == "11point":
                ap = 0.0
                for t in np.linspace(0, 1, 11):
                    p = prec[rec >= t].max() if (rec >= t).any() else 0.0
                    ap += p / 11.0
            else:
                ap = 0.0
                mrec = np.concatenate([[0.0], rec, [1.0]])
                mpre = np.concatenate([[0.0], prec, [0.0]])
                for i in range(len(mpre) - 2, -1, -1):
                    mpre[i] = max(mpre[i], mpre[i + 1])
                idx = np.where(mrec[1:] != mrec[:-1])[0]
                ap = float(np.sum((mrec[idx + 1] - mrec[idx]) *
                                  mpre[idx + 1]))
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0
