"""Solver configuration.

Port of :mod:`bio_ik_tpu.config`, field for field: the counterpart of
the reference's ``IKParams`` (reference: src/utils.h:64-85 populated in
kinematics_plugin.cpp:243-267).  A hashable frozen dataclass.

Timeout semantics: the reference races wall-clock deadlines between solver
steps (ik_parallel.h:160-168); the batched solve runs whole kernel
launches, so budgets are expressed in iterations (``max_steps``), optionally chunked
(``steps_per_check``) for host-side convergence polling — the analog of
the reference's 4-steps-then-check batching.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

__all__ = ["SolverConfig", "DEFAULT_CONFIG"]


@dataclass(frozen=True)
class SolverConfig:
    # solver selection (reference: `mode` param, default bio2_memetic)
    mode: str = "bio2_memetic"
    # island count: 0 ⇒ solver default (reference: `threads` param,
    # ik_parallel.h:113-127; bio1/bio2 default 4)
    islands: int = 0

    # log the solver-iteration count of each query (reference: `counter`
    # param, ik_parallel.h:107,263-266)
    counter: bool = False

    # acceptance tolerances (reference: kinematics_plugin.cpp:259-261;
    # dpos/drot default disabled, dtwist 1e-5)
    dpos: float = float("inf")
    drot: float = float("inf")   # degrees
    dtwist: float = 1e-5

    # evolution parameters (reference: ik_evolution_2.cpp:137-141, 349-351,
    # 453; ik_evolution_1.cpp defaults via kinematics_plugin.cpp:265-266)
    population_size: int = 8     # bio1 population
    elite_count: int = 4         # bio1 elites
    no_wipeout: bool = False
    linear_fitness: bool = False

    # iteration budget (replaces wall-clock timeout; see module docstring)
    max_steps: int = 16
    steps_per_check: int = 4     # reference: ik_parallel.h:165-168

    # island-model extension: broadcast the running best into every
    # island after each chunk (no reference analog — the reference's
    # islands exchange nothing; see Solver.inject)
    elite_migration: bool = False

    # fused batch engine routing for bio2-family modes ("auto" | "on" |
    # "off"): "auto" routes solve_batch to the fused megastep engine (the
    # CUDA kernel on the card, its plain torch version on the CPU) when
    # the problem qualifies; see bio_ik_tpu_torch.engine.FusedBio2Engine.supports
    fused: str = "auto"

    # in-kernel mutation-noise generator for the fused engine:
    # "clt4" (Irwin–Hall sum-of-4, transcendental-free, tails truncated
    # at ±3.46σ) or "box_muller" (exact normals).  The vmapped XLA path
    # always uses exact threefry normals; see kernels/bio2_fullstep.py
    # gauss_from_u01 for the statistical rationale.
    gauss_mode: str = "clt4"

    # numerics
    dtype: str = "float32"

    # default-goal construction knobs (reference:
    # kinematics_plugin.cpp:286-329)
    rotation_scale: float = 0.5
    position_only_ik: bool = False
    center_joints_weight: float = 0.0
    avoid_joint_limits_weight: float = 0.0
    minimal_displacement_weight: float = 0.0

    # neural-mode training budget (reference: FANN training at first
    # initialize, ik_neural.cpp:270-281; steps here are Adam minibatch
    # updates rather than FANN epochs)
    neural_train_steps: int = 2000

    # PRNG
    seed: int = 0

    def __post_init__(self):
        if self.gauss_mode not in ("clt4", "box_muller"):
            raise ValueError(
                f"gauss_mode must be 'clt4' or 'box_muller', got "
                f"{self.gauss_mode!r}"
            )

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SolverConfig()
