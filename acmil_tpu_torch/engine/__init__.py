from acmil_tpu_torch.engine.families import (ACMILFamily, DSMILFamily,
                                             FAMILIES, Family, get_family)
from acmil_tpu_torch.engine.metrics import (accuracy, auroc,
                                            classification_metrics, f1_macro)
from acmil_tpu_torch.engine.schedules import half_cosine_schedule
from acmil_tpu_torch.engine.train import (TrainState, create_train_state,
                                          evaluate, evaluate_scanned,
                                          family_supports_scan, is_better,
                                          make_eval_step,
                                          make_scan_eval_step,
                                          make_scan_train_step,
                                          make_train_step, train_one_epoch,
                                          train_one_epoch_scanned)

__all__ = [
    "ACMILFamily",
    "DSMILFamily",
    "FAMILIES",
    "Family",
    "get_family",
    "accuracy",
    "auroc",
    "classification_metrics",
    "f1_macro",
    "half_cosine_schedule",
    "TrainState",
    "create_train_state",
    "evaluate",
    "evaluate_scanned",
    "family_supports_scan",
    "is_better",
    "make_eval_step",
    "make_scan_eval_step",
    "make_scan_train_step",
    "make_train_step",
    "train_one_epoch",
    "train_one_epoch_scanned",
]
