"""Top-level solve API: island racing, scenario batching, adaptive retries
and latency mode.

Port of :mod:`bio_ik_tpu.api` (reference: src/kinematics_plugin.cpp:437-655
searchPositionIK, src/ik_parallel.h:90-277 IKParallel).  The reference
races its solver on N threads that share a ``finished`` flag; here islands
are rows of the solver state, stepped in lock-step, and the race is a
budget of ``max_steps`` steps with the best accepted solution kept between
acceptance chunks (winner selection as ik_parallel.h:220-261).

  * ``IKSolver.solve`` / ``search`` — one query on the island path (the
    unfused solver of ``config.mode``, ``solvers/``), as in the JAX package;
  * ``IKSolver.solve_batch`` — B queries on the fused engine (its fullstep
    tier for revolute/prismatic chains, its species tier for floating or
    planar ones), or on the island path where the fused kernels cannot
    express the problem (:meth:`FusedBio2Engine.shared_reason`);
  * ``IKSolver.solve_until`` — latency mode: one query, acceptance checked
    on the host after each chunk, the first accepted winner returned,
    optionally against a wall-clock deadline; one megastep launch per chunk
    on the fullstep tier, the island path otherwise;
  * ``AdaptiveBatchSolver`` — the multi-phase retry ladder, on the device
    when every phase has the engine, else with failures compacted on the
    host.

``SolverConfig(counter=True)`` records every call of ``solve``,
``solve_batch`` and ``solve_until`` in ``IKSolver.stats`` (a
:class:`profiling.SolveStats`) and logs each query's steps, as the JAX
package does.
"""

from __future__ import annotations

import itertools
import logging
import math
import time
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .config import DEFAULT_CONFIG, SolverConfig
from .engine import FusedBio2Engine, fold_in, mix32, winner
from .goals import Goal
from .interop import tree_map
from .kernels.fk_rows import supports_fullstep_chain
from .problem import Problem
from .profiling import SolveStats
from .robot.model import RobotModel
from .solvers.base import SolverContext, make_solver

__all__ = ["IKSolver", "IKResult", "AdaptiveBatchSolver"]

_M32 = 0xFFFFFFFF


class IKResult(NamedTuple):
    q: torch.Tensor          # full variable vector of the winner (..., Vfull)
    success: torch.Tensor    # bool: winner passed the acceptance test
    fitness: torch.Tensor    # primary fitness of the winner
    qa: torch.Tensor         # active variables of the winner (..., V)


def _check_device(model: RobotModel, device):
    if device is not None and torch.device(device).type != model.device.type:
        raise ValueError(f"device {device} differs from the model's "
                         f"{model.device}; build the RobotModel on it")


def _build_engines(solvers) -> float:
    """Build the CUDA instances of the solvers' fused engines on a card,
    all at once; returns the seconds spent (0 when there is nothing to
    build)."""
    from .kernels.build import build_all

    names = []
    for s in solvers:
        eng = s.engine
        if eng is not None and s.device.type == "cuda":
            names.append((eng.mega if eng.fullstep else eng.kernel).source)
    return build_all(sorted(set(names))) if names else 0.0


def _log_counter(steps: int, islands: int) -> None:
    """Iteration-count observability (reference: the ``counter`` param logs
    iteration_count after each query, ik_parallel.h:107, 263-266)."""
    logging.getLogger("bio_ik_tpu_torch").info(
        "ik solve: %d steps x %d islands", steps, islands)


class IKSolver:
    """Solver for one robot + goal structure (reference: the plugin's
    ``initialize``, kinematics_plugin.cpp:191-335).  Runs on the model's
    device — the card unless the model was built with ``device="cpu"``."""

    def __init__(
        self,
        model: RobotModel,
        goals: Sequence[Goal],
        config: SolverConfig = DEFAULT_CONFIG,
        fixed_joints: Sequence[str] = (),
        active_variables: Optional[Sequence[int]] = None,
        device=None,
    ):
        _check_device(model, device)
        self.model = model
        self.config = config
        self.device = model.device
        self.problem = Problem(model, goals, fixed_joints=fixed_joints,
                               active_variables=active_variables, config=config)
        # per-call metrics when the reference's ``counter`` knob is on
        # (opt-in: recording reads the success and fitness on the host)
        self.stats = SolveStats() if config.counter else None
        self.ctx = SolverContext(self.problem)
        self.solver = make_solver(config.mode, self.ctx, config)
        self.islands = config.islands or self.solver.default_islands
        self.spc = max(1, min(config.steps_per_check, config.max_steps))
        self.nchecks = max(1, config.max_steps // self.spc)
        self.fullstep_chain = supports_fullstep_chain(
            model, [model.link_index[t] for t in self.problem.tip_links])
        # steps run by the last solve_until (the iteration count the JAX
        # package records with ``counter``)
        self.last_steps = 0
        self.engine = None
        # why there is no engine; ``kernel_gap`` when only the card cannot
        # hold the problem's CUDA instance (its block exceeds the shared
        # memory at every group size) — then solve_batch raises rather than
        # leave the kernel's work to the island path
        self.unsupported, self.kernel_gap = None, False
        if config.fused == "off" or config.elite_migration:
            self.unsupported = ("fused='off'" if config.fused == "off"
                                else "elite_migration runs on the island path")
        else:
            self.unsupported = FusedBio2Engine.shared_reason(self)
            if self.unsupported is None:
                self.unsupported = FusedBio2Engine.card_reason(self)
                self.kernel_gap = self.unsupported is not None
                if not self.kernel_gap:
                    self.engine = FusedBio2Engine(self)

    @classmethod
    def for_tips(cls, model: RobotModel, tip_links: Sequence[str],
                 config: SolverConfig = DEFAULT_CONFIG, **kwargs) -> "IKSolver":
        """Default-goal construction mirroring the reference plugin's
        ``load()`` (kinematics_plugin.cpp:273-330): one PoseGoal per tip,
        plus the configured regularizers."""
        from .goals import (AvoidJointLimitsGoal, CenterJointsGoal,
                            MinimalDisplacementGoal, PoseGoal)

        rs = 0.0 if config.position_only_ik else config.rotation_scale
        goals = [PoseGoal(link=t, rotation_scale=rs) for t in tip_links]
        if config.center_joints_weight > 0:
            goals.append(CenterJointsGoal(weight=config.center_joints_weight))
        if config.avoid_joint_limits_weight > 0:
            goals.append(AvoidJointLimitsGoal(weight=config.avoid_joint_limits_weight))
        if config.minimal_displacement_weight > 0:
            goals.append(MinimalDisplacementGoal(
                weight=config.minimal_displacement_weight))
        return cls(model, goals, config, **kwargs)

    def make_data(self, q_seed_full) -> Dict[str, Any]:
        return self.problem.make_data(q_seed_full)

    def _rewrap(self, qa, seed_active):
        """Shift revolute angles by 2π multiples toward the seed, wrap into
        limits, clamp (reference: kinematics_plugin.cpp:580-613; skipped
        with mimic joints, as in the reference)."""
        if self.model.mimic_vars:
            return qa
        p = self.problem
        av = np.asarray(p.active_vars)
        rev = torch.as_tensor(self.model.var_is_revolute[av], device=qa.device)
        two_pi = 2.0 * math.pi
        r = seed_active
        v = qa - torch.round((qa - r) / two_pi) * two_pi
        hi, lo = p.amax, p.amin
        v = v - torch.ceil(torch.clamp(v - hi, min=0.0) / two_pi) * two_pi
        v = v + torch.ceil(torch.clamp(lo - v, min=0.0) / two_pi) * two_pi
        v = torch.minimum(torch.maximum(v, lo), hi)
        return torch.where(rev, v, qa)

    # ------------------------------------------------------------------
    # island path (JAX api.py:270-345)
    def _key(self, key):
        """``(2,)`` int64 key words on the solver's device; default the
        words of ``jax.random.PRNGKey(config.seed)``."""
        if key is None:
            key = [0, self.config.seed & _M32]
        return torch.as_tensor(key, device=self.device).to(torch.int64) & _M32

    def _generator(self, keys) -> torch.Generator:
        """The one random stream of an island solve, seeded from every word
        of ``keys (B, 2)`` through the port's integer hash (one host read)."""
        lo, hi = 0x5EED, 0x1D15
        for w0, w1 in torch.as_tensor(keys).reshape(-1, 2).tolist():
            lo = mix32(lo ^ mix32((w0 & _M32) ^ mix32(w1 & _M32)))
            hi = mix32(hi ^ mix32((w1 & _M32) ^ mix32((w0 & _M32) ^ 0x68E31DA4)))
        g = torch.Generator(device=self.device)
        g.manual_seed((hi << 32) | lo)
        return g

    def _init_islands(self, keys, data):
        """Solver state of ``B · islands`` rows (scenario-major) and the
        first winner.  Island 0 of each scenario starts from the seed; the
        others are flagged ``randomize`` (JAX api.py:270-275): gd and jac
        start them from a random configuration, the bio2 family, bio1 and
        test ignore the flag.  Returns
        ``(state, best, data_r)``, ``data_r`` being ``data`` repeated per
        island."""
        B, I = keys.shape[0], self.islands
        data_r = tree_map(lambda x: x[:, None].expand((B, I) + x.shape[1:])
                          .reshape((B * I,) + x.shape[1:]), data)
        randomize = torch.arange(B * I, device=self.device) % I > 0
        state = self.solver.init(self._generator(keys), data_r, randomize)
        return state, self._eval_islands(state, data, data_r), data_r

    def _eval_islands(self, state, data, data_r):
        """Winner per scenario among its islands' incumbents (reference:
        ik_parallel.h:220-261; :func:`engine.winner`)."""
        qa, fit = self.solver.solution(state, data_r)
        tips = self.ctx.tips_packed(data_r["seed_full"], qa)
        B, I = data["seed_active"].shape[0], self.islands
        return winner(self.problem, qa.reshape(B, I, -1), fit.reshape(B, I),
                      tips.reshape((B, I) + tips.shape[1:]), data)

    def _chunk(self, state, best, data, data_r):
        """``steps_per_check`` solver steps, then one acceptance evaluation
        (reference: 4 steps per timeout/solution check, ik_parallel.h:165-168)."""
        for _ in range(self.spc):
            state = self.solver.step(state, data_r)
        best = FusedBio2Engine._merge(best, self._eval_islands(state, data, data_r))
        if self.config.elite_migration:
            # broadcast each scenario's running best into its islands
            # (island-model extension, no reference analog; Solver.inject)
            I = self.islands
            state = self.solver.inject(state, best[0].repeat_interleave(I, 0),
                                       best[1].repeat_interleave(I, 0))
        return state, best

    def _result(self, best, data) -> IKResult:
        qa, fit, ok, _ = best
        qa = self._rewrap(qa, data["seed_active"])
        return IKResult(q=self.ctx.qfull(data["seed_full"], qa), success=ok,
                        fitness=fit, qa=qa)

    def _solve_batch(self, keys, data) -> IKResult:
        """B queries on the island path, each with ``islands`` islands."""
        state, best, data_r = self._init_islands(keys, data)
        for _ in range(self.nchecks):
            state, best = self._chunk(state, best, data, data_r)
        return self._result(best, data)

    def warmup(self) -> float:
        """Build the CUDA kernel instance the fused engine launches, if it is
        not built yet: on a shape no prebuilt source holds that is one
        ``nvcc`` (tens of seconds, once per shape; the library is kept under
        ``build/kernels``), which the first :meth:`solve_batch` would pay
        otherwise.  Nothing to build on the CPU or without a fused engine.
        Returns the seconds spent."""
        return _build_engines([self])

    # ------------------------------------------------------------------
    def _record(self, res, t0: float, steps: int, log: bool = True):
        """Record a call in :attr:`stats` (``counter=True``): its wall time
        to the result's arrival on the host, and its steps (JAX
        api.py:379-387, :427-455, :471-479)."""
        if self.stats is not None:
            if res.success.is_cuda:
                # the wall time ends when the card has the result
                torch.cuda.synchronize(res.success.device)
            self.stats.record(res, time.perf_counter() - t0, steps)
            if log:
                _log_counter(steps, self.islands)

    def solve_batch(self, keys, data) -> IKResult:
        """Solve B queries at once.  Every leaf of ``data`` carries a
        leading batch axis; ``keys`` is a ``(B, 2)`` integer tensor of
        32-bit words (a raw JAX ``PRNGKey`` per scenario).  The fused engine
        runs it; where the fused kernels cannot express the problem, the
        island path does, as in the JAX package; where only the card cannot
        hold the problem's kernel instance, this raises.  The first call on
        a shape no prebuilt source holds builds its instance
        (:meth:`warmup` builds it ahead)."""
        t0 = time.perf_counter()
        if self.engine is not None:
            res = self.engine.solve_batch(keys, data)
        elif self.kernel_gap:
            raise NotImplementedError(self.unsupported)
        else:
            res = self._solve_batch(keys, data)
        self._record(res, t0, self.config.max_steps, log=False)
        return res

    def solve(self, q_seed, key=None, data=None) -> IKResult:
        """Solve one query on the island path (JAX api.py:371-388).
        ``q_seed (Vfull,)`` seeds every island; ``data`` (optional) is a
        :meth:`make_data` dict with updated goal parameters; ``key`` is two
        32-bit words (default: those of ``PRNGKey(config.seed)``)."""
        if data is None:
            data = self.make_data(q_seed)
        t0 = time.perf_counter()
        res = self._solve_batch(self._key(key)[None],
                                tree_map(lambda x: x[None], data))
        res = tree_map(lambda x: x[0], res)
        # a fixed budget runs all of it on every island
        self._record(res, t0, self.config.max_steps)
        return res

    def search(self, q_seed, key=None, data=None, *,
               return_approximate_solution=False, solution_callback=None):
        """MoveIt-style search on top of :meth:`solve` (reference:
        kinematics_plugin.cpp:638-654): ``None`` instead of an unaccepted
        result unless ``return_approximate_solution``; ``solution_callback``
        ``(IKResult) -> bool`` (the analog of MoveIt's IKCallbackFn) is a
        host-side filter that can reject an accepted solution."""
        res = self.solve(q_seed, key=key, data=data)
        if not bool(res.success) and not return_approximate_solution:
            return None
        if solution_callback is not None and not solution_callback(res):
            return None
        return res

    def solve_until(self, q_seed, key=None, data=None, timeout_s=None) -> IKResult:
        """Latency mode (JAX api.py:406-456): ``steps_per_check``-step
        chunks, stopping at the first chunk whose winner is accepted — the
        reference's first-success-cancels-the-rest race (ik_parallel.h:160-190).
        ``timeout_s`` replaces the step budget with a wall-clock deadline
        (kinematics_plugin.cpp:506-507); at least one chunk runs.

        On the engine's fullstep tier each chunk is one megastep launch
        (:meth:`FusedBio2Engine.solve_until`); otherwise the island path
        runs it — a floating or planar chain, or a problem the fused
        kernels cannot express.  A fullstep chain whose kernel instance the
        card cannot hold raises.  ``last_steps`` holds the steps run, which
        ``counter=True`` records."""
        key = self._key(key)
        if data is None:
            data = self.make_data(q_seed)
        t_start = time.perf_counter()
        if self.engine is not None and self.engine.fullstep:
            res, self.last_steps = self.engine.solve_until(key, data,
                                                           timeout_s=timeout_s)
            self._record(res, t_start, self.last_steps)
            return res
        if self.kernel_gap and self.fullstep_chain:
            raise NotImplementedError(self.unsupported)
        deadline = None if timeout_s is None else t_start + timeout_s
        data_b = tree_map(lambda x: x[None], data)
        state, best, data_r = self._init_islands(key[None], data_b)
        steps = 0
        for _ in (itertools.count() if timeout_s is not None else range(self.nchecks)):
            state, best = self._chunk(state, best, data_b, data_r)
            steps += self.spc
            if bool(best[2][0]):      # the success flag: host-side early exit
                break
            if deadline is not None and time.perf_counter() >= deadline:
                break
        self.last_steps = steps
        res = tree_map(lambda x: x[0], self._result(best, data_b))
        self._record(res, t_start, steps)
        return res


class AdaptiveBatchSolver:
    """Multi-phase scenario-batched solving with failure compaction on the
    device: a first pass over the whole batch, then retries of the worst
    ``fractions[i]·B`` scenarios (failures first) with the next phase's
    island count and step budget (reference economics:
    ik_parallel.h:160-190)."""

    def __init__(self, model, goal_list, config=DEFAULT_CONFIG,
                 phases=((1, 8), (2, 32), (4, 64)), chunk_fraction=0.25,
                 fractions=None, device=None, **kwargs):
        _check_device(model, device)
        self.phases = phases
        self.chunk_fraction = chunk_fraction
        if fractions is None:
            fractions = tuple(
                0.75 if i == 0 else 0.25 / (2 ** (i - 1))
                for i in range(len(phases) - 1)
            )
        self.fractions = fractions
        # each phase checks acceptance once, at its end (one megastep
        # launch per phase on the fullstep tier; max_steps species
        # launches on the species tier)
        self.solvers = [
            IKSolver(model, goal_list,
                     config.replace(islands=i, max_steps=s, steps_per_check=s),
                     **kwargs)
            for i, s in phases
        ]

    @property
    def problem(self):
        return self.solvers[0].problem

    def warmup(self) -> float:
        """:meth:`IKSolver.warmup` for every phase's solver (one build for
        all: the phases share the instance's shape)."""
        return _build_engines(self.solvers)

    def make_data(self, q_seed_full):
        return self.solvers[0].make_data(q_seed_full)

    def _adaptive_on_device(self, keys, data):
        B = keys.shape[0]
        res = self.solvers[0].engine._solve_batch(keys, data)
        for phase_idx, solver in enumerate(self.solvers[1:], start=1):
            chunk = max(1, int(B * self.fractions[phase_idx - 1]))
            # failures first (stable sort keeps a deterministic order)
            order = torch.argsort(res.success.to(torch.int32), stable=True)
            idx = order[:chunk]
            sub_data = tree_map(lambda x: x[idx], data)
            sub = solver.engine._solve_batch(fold_in(keys[idx], phase_idx),
                                             sub_data)
            res = self._take(res, idx, sub)
        return res

    @staticmethod
    def _take(res, idx, sub):
        """Adopt a retry where it succeeds and the incumbent does not, or
        ties on success with lower fitness — with the retry's OWN success
        flag (the JAX package's rule, api.py:102-116)."""
        r_ok = res.success[idx]
        take = (sub.success & ~r_ok) | (
            (sub.success == r_ok) & (sub.fitness < res.fitness[idx]))

        def put(full, new):
            t = take[:, None] if full.dim() > 1 else take
            return full.index_copy(0, idx, torch.where(t, new, full[idx]))

        return IKResult(q=put(res.q, sub.q), success=put(res.success, sub.success),
                        fitness=put(res.fitness, sub.fitness),
                        qa=put(res.qa, sub.qa))

    def solve_batch(self, keys, data) -> IKResult:
        if all(s.engine is not None for s in self.solvers):
            return self._adaptive_on_device(keys, data)
        return self._adaptive_on_host(keys, data)

    def _adaptive_on_host(self, keys, data):
        """The ladder where a phase has no engine (JAX api.py:126-163): the
        failures of each phase, read on the host, re-solved by the next in
        chunks of ``chunk_fraction·B`` (padded by repeating entries); a
        retry is adopted where it succeeds or fits better."""
        res = self.solvers[0].solve_batch(keys, data)
        B = keys.shape[0]
        chunk = max(1, int(B * self.chunk_fraction))
        for phase_idx, solver in enumerate(self.solvers[1:], start=1):
            fail = np.flatnonzero(~res.success.cpu().numpy())
            if fail.size == 0:
                break
            for lo in range(0, fail.size, chunk):
                idx = torch.as_tensor(fail[lo:lo + chunk], device=keys.device)
                pad = torch.as_tensor(np.resize(fail[lo:lo + chunk], chunk),
                                      device=keys.device)
                sub = solver.solve_batch(fold_in(keys[pad], phase_idx),
                                         tree_map(lambda x: x[pad], data))
                n = idx.shape[0]
                take = sub.success[:n] | (sub.fitness[:n] < res.fitness[idx])
                upd, src = idx[take], torch.nonzero(take)[:, 0]
                res = IKResult(*(full.index_copy(0, upd, new[src])
                                 for full, new in zip(res, sub)))
        return res
