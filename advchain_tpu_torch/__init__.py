"""advchain_tpu_torch — the PyTorch/CUDA port of advchain_tpu for NVIDIA
Hopper (H100).

It mirrors the JAX package's layout so each module's counterpart is easy
to find:
  ops/        numeric primitives (grid sample, B-spline, Gaussian, flows)
  kernels/    hand-written CUDA kernels for sm_90a, with plain twins
  augmentor/  the four transforms + the compose solver
  losses/     consistency divergences (mse / kl / contour)
  models/     the UNet and its wrapper, plus weight conversion
  parallel/   meshes over torch.distributed ranks, the fused adversarial
              and supervised train steps (one GPU or data-parallel), and
              the spatially sharded halo exchange, Gaussian and sampler
  utils/      image I/O, random chains, RandAugment, checkpoints,
              profiling and plots

Entry points run on the GPU unless the caller asks for the CPU: models are
created on ``device="cuda"`` by default, and the solver and transforms run
on the device of the data they are given.
"""

__version__ = "0.1.0"


def resolve_device(device=None):
    """``None`` means the GPU.  Raises when CUDA is asked for and absent, so
    an entry point never drops to the CPU silently."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
