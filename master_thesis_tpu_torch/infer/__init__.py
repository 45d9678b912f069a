"""Full-video inference: the three inpainting algorithms and video writing."""

from master_thesis_tpu_torch.infer.algorithms import (  # noqa: F401
    FILL_COLOR,
    Inpainter,
    get_indexes_ff,
    get_indexes_ip,
)
from master_thesis_tpu_torch.infer.video import write_frames, write_video  # noqa: F401
