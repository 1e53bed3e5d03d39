"""Models of the port: FM (any order), FFM, DeepFM and DCN-V2 (the port's own)."""

from fast_tffm_tpu_torch.models.base import Batch, logistic_loss, masked_l2  # noqa: F401
from fast_tffm_tpu_torch.models.dcnv2 import DCNv2Model  # noqa: F401
from fast_tffm_tpu_torch.models.deepfm import DeepFMModel  # noqa: F401
from fast_tffm_tpu_torch.models.ffm import FFMModel  # noqa: F401
from fast_tffm_tpu_torch.models.fm import FMModel  # noqa: F401
