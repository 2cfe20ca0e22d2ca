"""The port's models, by the JAX package's registry keys."""

from .easy_unet import Identity, SpatialRescaler
from .efficient_unet import EfficientUNet, EfficientUNetCond, MFEfficientUNet
from .hdit import HDiT
from .layout_encoder import LayoutTransformerEncoder, LayoutTransformerEncoderV5
from .layout_unet import LayoutUnet, LayoutUnetV1
from .openai_unet import OpenAIUNet
from .point_unet import ObjectGenEncoder, PointUNet
from .refinenet import LiDARGenRefineNet
from .scene_graph import SceneGraph
from .unet_1d import UNet1DModel

_REGISTRY = {
    "efficient_unet": EfficientUNet,
    "efficient_unet_cond": EfficientUNetCond,
    "mf_efficient_unet": MFEfficientUNet,
    "layout_encoder": LayoutTransformerEncoder,
    "layout_encoder_v5": LayoutTransformerEncoderV5,
    "layout_unet_v1": LayoutUnetV1,
    "layout_unet": LayoutUnet,
    "unet_1d": UNet1DModel,
    "scene_graph": SceneGraph,
    "object_gen_encoder": ObjectGenEncoder,
    "point_unet": PointUNet,
    "hdit": HDiT,
    "refinenet": LiDARGenRefineNet,
    "openai_unet": OpenAIUNet,
    "easy_unet": SpatialRescaler,
    "identity": Identity,
}


def build_model(architecture: str, **kwargs):
    if architecture not in _REGISTRY:
        raise ValueError(f"architecture {architecture!r} is not a model of the registry (have {sorted(_REGISTRY)})")
    return _REGISTRY[architecture](**kwargs)
