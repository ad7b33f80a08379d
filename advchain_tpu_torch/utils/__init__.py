"""I/O, random chains, visualization, rand-augment, checkpoints and
profiling (port of advchain_tpu/utils)."""

from advchain_tpu_torch.utils.io import (check_dir, load_image_label,
                                         rescale_intensity, read_nrrd,
                                         read_nifti, read_medical_image)
from advchain_tpu_torch.utils.chain import random_chain
from advchain_tpu_torch.utils.rand_augment import MyRandAugment, apply_op
from advchain_tpu_torch.utils.profiling import (trace, Timer, benchmark,
                                                checked, start_trace,
                                                stop_trace)
from advchain_tpu_torch.utils.checkpoint import (save_checkpoint,
                                                 restore_checkpoint,
                                                 save_transform_state,
                                                 restore_transform_state)

__all__ = [
    "check_dir", "load_image_label", "rescale_intensity",
    "read_nrrd", "read_nifti", "read_medical_image",
    "random_chain", "MyRandAugment", "apply_op",
    "trace", "Timer", "benchmark", "checked", "start_trace", "stop_trace",
    "save_checkpoint", "restore_checkpoint", "save_transform_state",
    "restore_transform_state",
]
