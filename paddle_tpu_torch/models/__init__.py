"""Model builders of the port's slices (counterpart of
paddle_tpu/models/): each appends its ops into the current default
program, fluid style. The BERT and GPT builders are imported from their
modules (models.bert, models.gpt)."""

from .resnet import resnet, resnet_train_net  # noqa: F401
from .yolov3 import YoloConfig, yolov3_infer, yolov3_train  # noqa: F401
from .deepfm import DeepFMConfig, deepfm  # noqa: F401
from .mask_rcnn import (  # noqa: F401
    MaskRCNNConfig,
    batched_detection_enabled,
    mask_rcnn_infer,
    mask_rcnn_train,
    mask_rcnn_train_batched,
)
