from .fk import LinkFrames, joint_frame, make_fk, make_link_frames_fn  # noqa: F401
from .approx import (apply_deltas, apply_deltas_single, make_jacobian,  # noqa: F401
                     make_linearizer)
