"""Metrics (``paddle_tpu.metric`` counterpart)."""
from . import detection, metrics
from .detection import DetectionMAP
from .metrics import Accuracy, Auc, Metric, Precision, Recall, accuracy

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy",
           "DetectionMAP", "metrics"]
