"""Noise schedules, the continuous- and discrete-time samplers and MeanFlow."""

from .conditional import CondContinuousDiffusion  # noqa: F401
from .continuous import ContinuousDiffusion  # noqa: F401
from .discrete import DiscreteDiffusion  # noqa: F401
from .layout import CondLayoutDiffusion  # noqa: F401
from .mean_flow import MeanFlow  # noqa: F401
