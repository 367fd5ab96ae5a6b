from deepspeech_tpu_torch.utils.logging import (MetricsLogger, Observer,
                                                ObserverList)
from deepspeech_tpu_torch.utils.meters import AverageMeter, StopWatch

__all__ = ["MetricsLogger", "Observer", "ObserverList", "AverageMeter",
           "StopWatch"]
