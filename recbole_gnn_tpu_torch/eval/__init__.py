from recbole_gnn_tpu_torch.eval.evaluator import Evaluator
from recbole_gnn_tpu_torch.eval.metrics import topk_metrics

__all__ = ["Evaluator", "topk_metrics"]
