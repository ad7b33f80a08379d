"""Device ms a 3D step in convolution, BatchNorm and upsampling kernels."""
from cudabench.layers import model_device_ms as read  # noqa: F401
