from acmil_tpu_torch.engine.families import (ACMILFamily, FAMILIES, Family,
                                             get_family)
from acmil_tpu_torch.engine.metrics import (accuracy, auroc,
                                            classification_metrics, f1_macro)
from acmil_tpu_torch.engine.train import evaluate, is_better, make_eval_step

__all__ = [
    "ACMILFamily",
    "FAMILIES",
    "Family",
    "get_family",
    "accuracy",
    "auroc",
    "classification_metrics",
    "f1_macro",
    "evaluate",
    "is_better",
    "make_eval_step",
]
