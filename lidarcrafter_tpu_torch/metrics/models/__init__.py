"""Detectors behind the detection metric and DCF: ``detector.py`` (the
substitute ``VoxelDetector``) and ``voxel_rcnn.py`` (pcdet's Voxel R-CNN with
a CenterHead).  Port of the JAX package's ``metrics/models``."""
