"""
Global-quantity regression head, under the reference's module path (counterpart of
uniception_tpu/models/prediction_heads/global_head.py): the class shares the pose head's trunk in pose_head.py.
"""

from uniception_tpu_torch.models.prediction_heads.pose_head import GlobalHead, ResConvBlock

__all__ = ["GlobalHead", "ResConvBlock"]
