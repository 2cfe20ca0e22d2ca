from .pointnet import PointNetFeatureExtractor, convert_pointnet_state_dict  # noqa: F401
from .rangenet import RangeNet, convert_rangenet_state_dict, preprocess_range_input  # noqa: F401
