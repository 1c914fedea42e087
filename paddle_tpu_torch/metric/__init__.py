"""Metrics (``paddle_tpu.metric`` counterpart). ``DetectionMAP`` is not
ported yet."""
from . import metrics
from .metrics import Accuracy, Auc, Metric, Precision, Recall, accuracy

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy",
           "metrics"]
