"""bio_ik_tpu_torch — the PyTorch/CUDA port of :mod:`bio_ik_tpu`.

The JAX package stays the reference; this package mirrors its module
names and layout so each counterpart is easy to find.  Plain tensor code
is PyTorch; the fused bio2 megastep and species step, Pallas kernels in the
reference, are hand-written CUDA kernels (``csrc/megastep.cu``,
``csrc/species.cu``), each with a plain torch version beside it that the
CPU runs.  Entry points run on the card unless
the caller passes ``device="cpu"``.
"""

from .device import asset_path, resolve_device  # noqa: F401
from .robot import RobotModel, load_urdf, parse_urdf  # noqa: F401
from .math import Frame  # noqa: F401
from .config import SolverConfig  # noqa: F401
from .problem import Problem  # noqa: F401
from .api import AdaptiveBatchSolver, IKResult, IKSolver  # noqa: F401
from .kinematics import make_fk  # noqa: F401
from . import goals  # noqa: F401

__version__ = "0.1.0"
