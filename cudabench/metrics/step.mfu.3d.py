"""The 3D step's model FLOPs over the measured window, % of the f32 peak."""
from cudabench.layers import step_mfu as read  # noqa: F401
