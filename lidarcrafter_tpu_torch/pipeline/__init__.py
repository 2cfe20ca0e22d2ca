"""The 4D rollout: a layout-conditioned first frame, then autoregressive
frames conditioned on the warped previous frame."""

from .temporal import TemporalRollout
