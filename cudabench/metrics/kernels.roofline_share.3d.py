"""The 3D warps' and compositions' byte bound over their kernels' time, %."""
from cudabench.layers import roofline_share as read  # noqa: F401
