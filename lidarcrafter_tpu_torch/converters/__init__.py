"""Data-pipeline converters: the nuScenes info pickles, their lidarseg
paths and the object-classification split (copies of the JAX package's
``tools/converters``).  The devkit paths sit behind gated imports."""
