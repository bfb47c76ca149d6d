from multibox_tpu_torch.models.detector import MultiBoxDetector
from multibox_tpu_torch.models.heads import MultiBoxHead
from multibox_tpu_torch.models.inception_v3 import InceptionV3

__all__ = ["InceptionV3", "MultiBoxDetector", "MultiBoxHead"]
