"""Models behind the object-level metrics: ``detector.py`` (the substitute
``VoxelDetector``) and ``voxel_rcnn.py`` (pcdet's Voxel R-CNN with a
CenterHead) for detection and DCF, ``glenet.py`` (RGF's box-uncertainty
CVAE) and ``ptv3.py`` (the segmenter).  Port of the JAX package's
``metrics/models``."""
