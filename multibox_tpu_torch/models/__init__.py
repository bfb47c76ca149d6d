from multibox_tpu_torch.models.detector import MultiBoxDetector
from multibox_tpu_torch.models.heads import MultiBoxHead, SSDHead
from multibox_tpu_torch.models.inception_v3 import InceptionV3
from multibox_tpu_torch.models.mobilenet import MobileNetV2

__all__ = ["InceptionV3", "MobileNetV2", "MultiBoxDetector", "MultiBoxHead", "SSDHead"]
