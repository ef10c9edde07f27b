"""Models of the port (``pointunet_tpu/models``): the reference's public
names."""
from .attention3d import (
    ChannelWiseAttention2D,
    ChannelWiseAttention3D,
    SpatialAttention2D,
    SpatialAttention3D,
)
from .fastconv import FastConv
from .randlanet import RandLANet, init_randlanet
from .upsample import bilinear_upsample_3d
from .losses import (
    generalised_dice_loss,
    point_dice_loss,
    point_dice_weighted,
    saliency_dice_loss,
    saliency_dice_loss_mixup,
    soft_dice,
    soft_dice_mixup,
    weighted_cross_entropy,
)
from .saliency_unet import SaliencyUNet, UNet3D, init_saliency_unet

__all__ = [
    "ChannelWiseAttention2D",
    "ChannelWiseAttention3D",
    "SpatialAttention2D",
    "SpatialAttention3D",
    "FastConv",
    "bilinear_upsample_3d",
    "RandLANet",
    "init_randlanet",
    "SaliencyUNet",
    "UNet3D",
    "init_saliency_unet",
    "point_dice_weighted",
    "saliency_dice_loss_mixup",
    "soft_dice_mixup",
    "generalised_dice_loss",
    "point_dice_loss",
    "saliency_dice_loss",
    "soft_dice",
    "weighted_cross_entropy",
]
