from pmpu_tpu_torch.models.hprob_unet import HierarchicalProbUNet
from pmpu_tpu_torch.models.prob_unet import ProbabilisticUNet
from pmpu_tpu_torch.models.unet import UNet

__all__ = ["HierarchicalProbUNet", "ProbabilisticUNet", "UNet"]
