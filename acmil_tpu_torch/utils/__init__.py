from acmil_tpu_torch.utils.logging import (MetricLogger, MetricsWriter,
                                           SmoothedValue)
from acmil_tpu_torch.utils.seed import set_seed

__all__ = ["MetricLogger", "MetricsWriter", "SmoothedValue", "set_seed"]
