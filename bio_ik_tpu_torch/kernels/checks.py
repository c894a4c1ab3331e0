"""Kernel self-checks: megastep and species-step inputs from a seed, and
lane-by-lane agreement.

Port of :mod:`bio_ik_tpu.kernels.checks`, shared by the CPU tests (plain
torch version against the JAX body) and ``chip_smoke.py`` (CUDA kernel
against the plain version on the card).  The two sides of a comparison
are not bitwise equal — nvcc contracts ``a·b + c`` into FMA, eager PyTorch
does not — and a last-bit fitness difference can flip a discrete
selection, after which that lane legitimately follows another trajectory
(the JAX package's own note, checks.py:88-95).  So agreement is counted
per lane, each lane's whole state within a tolerance.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["megastep_inputs", "species_inputs", "sec_rows", "lane_agreement",
           "max_abs_err", "axis_negated", "MISS", "HIGH_DOF"]

# how far a non-pose goal instance of megastep_inputs misses the frame it
# is placed at (_kind_rows): metres, radians.  Parents 1e-3 rad off q*
# move the tip by ~1e-3 m and ~3e-3 rad, so the relu kinds' terms act on
# ≥ 99.8 % of the parents of pr2_arm
MISS = (0.002, 0.01)

# the problems of the high-DOF megastep instances, the JAX suite's
# snake32_position and humanoid_whole_body rows (tools/bench_suite.py:
# 134-142, 175-197): robot, tip links, the kind of each goal instance (on
# tip k), and the secondary terms their checks run with — all four on the
# snake, the reference's two regularizers on the humanoid
HIGH_DOF = {
    "snake": ("snake.urdf", ("head",), ("position",),
              ("alpha", "beta", "gamma", "delta")),
    "humanoid": ("humanoid.urdf", ("r_hand", "l_hand", "head"), ("pose",) * 3,
                 ("beta", "gamma")),
}


def sec_rows(model, sec_terms, N: int, rng, weight: float = 0.05):
    """numpy packed secondary rows ``(8·V, N)`` (bio2_step.SEC_ROWS order)
    for every variable of ``model`` active, as ``engine._secondary_rows``
    builds them for goals of weight ``weight`` in ``sec_terms``: α and γ
    ``w²·(vw·bounded)²``, β ``w²·vw²``, δ ``w²`` with the velocity weights
    ``vw``; the joint_variable targets ``tbar`` and the seed drawn per
    species pair from ``rng`` in the bounds, the centers and half spans
    from the bounds."""
    b = model._np_bounds
    V = model.nvars
    rcp = b["max_velocity_rcp"]
    vw = rcp / rcp.sum() if rcp.sum() > 0 else np.full(V, 1.0 / V)
    bnd = np.isfinite(b["clip_max"]).astype(np.float64)
    w2 = weight * weight
    coef = {"alpha": w2 * (vw * bnd) ** 2, "beta": w2 * vw ** 2,
            "gamma": w2 * (vw * bnd) ** 2, "delta": np.full(V, w2)}
    zero = np.zeros((V, N))

    def rows(x):
        return np.tile(np.asarray(x, np.float64)[:, None], (1, N))

    def pairs(x):
        return np.repeat(x, 2, axis=0)[:N].T

    lo, hi = b["min"], b["max"]
    tbar = pairs(rng.uniform(lo, hi, size=((N + 1) // 2, V)))
    seed = pairs(rng.uniform(lo, hi, size=((N + 1) // 2, V)))
    out = [rows(coef[t]) if t in sec_terms else zero
           for t in ("alpha", "beta", "gamma", "delta")]
    out += [tbar if "delta" in sec_terms else zero, rows(0.5 * (lo + hi)),
            rows(0.5 * b["span"]), seed]
    return np.ascontiguousarray(np.concatenate(out, 0), dtype=np.float32)


def _kind_rows(kind, pos, quat, miss=MISS):
    """numpy goal rows ``(gpos (3, n), gquat (4, n), gaux (3, n), wpos (n,),
    wrot (n,))`` of one instance of ``kind`` (engine._goal_rows' packing)
    at tip frames ``pos (n, 3)``, ``quat (n, 4)`` (rotation R).  The pose
    family holds the frame with bench.py's weights.  Every other kind
    misses the frame, so its term and its gradient act at every lane, by
    ``miss = (metres, radians)``: line, plane, max_distance, min_distance
    and the cone's apex by the metres; lookat's target off R·x (1 m away:
    near its target the lookat error turns the tips' rounding into large
    fitness differences), the cone's R·z past its allowance, direction's
    R·y off its direction and side's R·x across it (R·x · dir =
    sin(radians) > 0) by the radians."""
    from ..math.quat import quat_rotate

    n = pos.shape[0]
    q = torch.from_numpy(quat)

    def rot(axis):
        return quat_rotate(q, torch.tensor(axis, dtype=q.dtype).expand(n, 3)).numpy()

    def tile(x):
        return np.tile(np.asarray(x, np.float64)[:, None], (1, n))

    ident = tile((0.0, 0.0, 0.0, 1.0))
    zeros = np.zeros((3, n))
    ones, nil = np.ones(n), np.zeros(n)
    m, a = miss
    c, s = np.cos(a), np.sin(a)
    # the angular kinds at the weight that makes their miss cost what the
    # metric kinds' does
    wa = np.full(n, (m / a) ** 2)
    if kind in ("position", "orientation", "pose"):
        w = {"position": (ones, nil), "orientation": (nil, ones)}.get(
            kind, (ones, np.full(n, 0.25)))
        return pos.T, quat.T, zeros, w[0], w[1]
    if kind == "lookat":
        return (pos + 1.0 * rot((c, s, 0.0))).T, ident, tile((1.0, 0.0, 0.0)), wa, nil
    if kind == "line":
        d = rot((0.0, 0.0, 1.0))
        return (pos + 0.1 * d + m * rot((1.0, 0.0, 0.0))).T, ident, d.T, ones, nil
    if kind == "plane":
        nrm = rot((0.0, 1.0, 0.0))
        return (pos + m * nrm).T, ident, nrm.T, ones, nil
    if kind in ("max_distance", "min_distance"):
        dist = 0.1 - m if kind == "max_distance" else 0.1 + m
        return (pos + np.asarray([0.1, 0.0, 0.0])).T, ident, zeros, ones, np.full(n, dist)
    if kind == "cone":
        allow = 0.05
        gq = np.concatenate([rot((0.0, np.sin(allow + a), np.cos(allow + a))).T,
                             np.full((1, n), allow)])
        return ((pos + m * rot((1.0, 0.0, 0.0))).T, gq, tile((0.0, 0.0, 1.0)), wa,
                np.full(n, 0.5))
    # direction: R·y off dir; side: R·x across dir
    axis = (0.0, 1.0, 0.0) if kind == "direction" else (1.0, 0.0, 0.0)
    return rot((s, c, 0.0)).T, ident, tile(axis), wa, nil


def megastep_inputs(model, tip, sp, n_steps: int, N: int, seed: int = 7,
                    spread: float = 1e-3, with_noise: bool = True,
                    sec_terms=(), inst_kind=None, inst_tip=None, miss=MISS):
    """numpy ``(state, consts, noise)`` for one megastep launch on ``N``
    lanes of ``model``, made from ``seed``: a reachable target per species
    pair (exact FK of a uniform q*), both parents at q* plus gaussian noise
    of ``spread`` rad — the state of a solve under way — the model's
    bounds, and noise tensors with the real rate ladder.  ``tip`` is one
    tip link or a list; goal instance k (K = ``sp.K``) sits on tip
    ``inst_tip[k]`` (default ``k`` mod T) with kind ``inst_kind[k]``
    (default pose, with bench.py's weights), its rows those of
    ``engine._goal_rows`` met at q* (the pose family) or missed by
    ``miss`` = (metres, radians) (:func:`_kind_rows`); the consts carry
    ``gaux`` after ``gquat`` when a kind needs it
    (bio2_fullstep.AUX_KINDS).  ``noise = (noise, rates, wipe_u, wipe_g)``,
    or None without ``with_noise`` (in-kernel RNG runs).  With
    ``sec_terms`` the consts end with the packed secondary rows
    (:func:`sec_rows`) and ``noise`` with the pre-selection uniforms
    ``keep (steps·gens, 1, N)``, drawn after everything else (the other
    inputs do not change).

    Far from a solution the memetic line search divides differences of
    nearly equal fitness values, so two correct implementations that round
    differently part ways on most lanes; near one they agree."""
    from ..kinematics import make_fk
    from .bio2_fullstep import AUX_KINDS

    tips = [tip] if isinstance(tip, str) else list(tip)
    T, K, V = len(tips), sp.K, sp.V
    inst_kind = list(inst_kind or ["pose"] * K)
    inst_tip = list(inst_tip if inst_tip is not None else [k % T for k in range(K)])
    rng = np.random.default_rng(seed)
    f32 = np.float32
    b = model._np_bounds
    # one target per species pair: the two lanes of an island share it
    qstar = np.repeat(rng.uniform(b["min"], b["max"], size=((N + 1) // 2, V)),
                      2, axis=0)[:N].astype(f32)
    tg = make_fk(model, tips, device="cpu")(torch.from_numpy(qstar))
    goal = [_kind_rows(kd, tg.pos[:, t].numpy(), tg.quat[:, t].numpy(), miss)
            for kd, t in zip(inst_kind, inst_tip)]
    genes = np.tile(qstar.T, (2, 1)) + rng.normal(size=(2 * V, N)) * spread
    genes = np.clip(genes, np.tile(b["clip_min"], 2)[:, None],
                    np.tile(b["clip_max"], 2)[:, None]).astype(f32)

    def rows(x):
        return np.ascontiguousarray(np.tile(x.astype(f32)[:, None], (1, N)))

    def stack(i):
        return np.ascontiguousarray(np.concatenate([np.reshape(g[i], (-1, N))
                                                    for g in goal]), dtype=f32)

    state = (
        genes,
        (rng.normal(size=(2 * V, N)) * 0.01).astype(f32),
        np.full((1, N), np.inf, f32),                       # sfit
        genes[:V].copy(),                                   # sol
        np.full((1, N), 1e30, f32),                         # sol_fit
        np.zeros((7 * T, N), f32),                          # sol_tips
    )
    consts = (np.zeros((1, N), f32), stack(0), stack(1))    # qfix (none), gpos, gquat
    if any(kd in AUX_KINDS for kd in inst_kind):
        consts += (stack(2),)                               # gaux
    consts += (
        stack(3), stack(4),                                 # wpos, wrot
        rows(b["span"]), rows(b["clip_min"]), rows(b["clip_max"]),
        rows(b["min"]), rows(b["max"]),
    )
    noise = None
    sg = n_steps * sp.gens
    if with_noise:
        k = rng.integers(0, 16, size=(sg, sp.C, N))
        noise = (
            rng.normal(size=(sg, V, sp.C, N)).astype(f32),
            np.exp2(k - 23.0).astype(f32),
            rng.uniform(size=(n_steps, 1, N)).astype(f32),
            rng.uniform(size=(n_steps, V, N)).astype(f32),
        )
    if sec_terms:
        consts += (sec_rows(model, sec_terms, N, rng),)
        if with_noise:
            noise += (rng.uniform(size=(sg, 1, N)).astype(f32),)
    return state, consts, noise


def species_inputs(model, tip: str, sp, N: int, seed: int = 7,
                   spread: float = 1e-3, sec_terms=(), philox: bool = False):
    """numpy arguments of one species step (:class:`SpeciesKernel` order)
    on ``N`` lanes of ``model``/``tip`` with every variable active (K = 1),
    made from ``seed``: a solve under way as in :func:`megastep_inputs` —
    one reachable target per species pair (exact FK of a uniform q* whose
    quaternion blocks are normalized), both parents ``spread`` off it —
    then ``tips0``/``deltas`` from the port's linearizer at parent 0, pose
    weights of bench.py's goal (so both fitness terms are exercised), the
    model's bounds, and noise and rates with the real rate ladder; with
    ``sec_terms`` also ``keeps (gens, 1, N)`` and the packed secondary rows
    (:func:`sec_rows`), drawn after everything else.

    With ``philox`` (the kernel's in-kernel Philox mode) the result is
    ``(args, kw)``: ``args`` up to ``cmax`` (no noise, rates or keeps) and
    ``kw = {"salt": (1, N) int32}`` (one random salt per species pair) and,
    with ``sec_terms``, ``kw["sec"]``, the packed secondary rows, both
    drawn after the lane state: the keyword arguments of the call with
    ``seed`` and ``step``."""
    from ..kinematics import make_fk, make_linearizer

    V, K = sp.V, sp.K
    if V != model.nvars or K != 1:
        raise ValueError("species_inputs wants every variable active and K = 1")
    rng = np.random.default_rng(seed)
    f32 = np.float32
    b = model._np_bounds
    qstar = rng.uniform(b["min"], b["max"], size=((N + 1) // 2, V))
    for s in sp.quat_slices:
        qstar[:, s:s + 4] /= np.linalg.norm(qstar[:, s:s + 4], axis=1,
                                            keepdims=True)
    qstar = np.repeat(qstar, 2, axis=0)[:N].astype(f32)
    tg = make_fk(model, [tip], device="cpu")(torch.from_numpy(qstar))
    genes = np.tile(qstar.T, (2, 1)) + rng.normal(size=(2 * V, N)) * spread
    genes = np.clip(genes, np.tile(b["clip_min"], 2)[:, None],
                    np.tile(b["clip_max"], 2)[:, None]).astype(f32)
    tips0, deltas = make_linearizer(model, [tip], list(range(V)))(
        torch.from_numpy(np.ascontiguousarray(genes[:V].T)))
    # (N, T=1, V, 7) → rows v·7 + d
    deltas = deltas[:, 0].reshape(N, V * 7).T

    def rows(x):
        return np.ascontiguousarray(np.tile(x.astype(f32)[:, None], (1, N)))

    args = (
        genes,
        (rng.normal(size=(2 * V, N)) * 0.01).astype(f32),
        np.ascontiguousarray(tips0[:, 0].numpy().T),
        np.ascontiguousarray(deltas.numpy()),
        np.ascontiguousarray(tg.pos[:, 0].numpy().T),
        np.ascontiguousarray(tg.quat[:, 0].numpy().T),
        np.ones((K, N), f32),
        np.full((K, N), 0.25, f32),
        rows(b["span"]), rows(b["clip_min"]), rows(b["clip_max"]),
    )
    if philox:
        salt = np.repeat(rng.integers(-2 ** 31, 2 ** 31, size=(N + 1) // 2),
                         2)[:N].astype(np.int32)[None]
        kw = {"salt": salt}
        if sec_terms:
            kw["sec"] = sec_rows(model, sec_terms, N, rng)
        return args, kw
    k = rng.integers(0, 16, size=(sp.gens, sp.C, N))
    args += (rng.standard_normal(size=(sp.gens, V, sp.C, N), dtype=f32),
             np.exp2(k - 23.0).astype(f32))
    if sec_terms:
        args += (rng.uniform(size=(sp.gens, 1, N)).astype(f32),
                 sec_rows(model, sec_terms, N, rng))
    return args


def axis_negated(model, var: int):
    """A copy of ``model`` whose joint of variable ``var`` turns about its
    negated axis: the chain of a wrong plain version (a control the checks
    must fail), the model itself unchanged."""
    import copy

    wrong = copy.copy(model)
    wrong.axis = model.axis.copy()
    li = int(np.flatnonzero(model.vstart == var)[0])
    wrong.axis[li] = -wrong.axis[li]
    return wrong


def lane_agreement(outs_a, outs_b, rtol=1e-5, atol=1e-6):
    """Boolean ``(N,)``: lanes whose every output row agrees within
    ``|a − b| ≤ atol + rtol·|b|`` (equal infinities and NaNs agree)."""
    def host(x):
        return x.cpu() if torch.is_tensor(x) else torch.from_numpy(np.array(x))

    ok = None
    for a, b in zip(outs_a, outs_b):
        a, b = host(a), host(b)
        close = torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=True)
        lane_ok = close.reshape(-1, close.shape[-1]).all(dim=0)
        ok = lane_ok if ok is None else ok & lane_ok
    return ok


def max_abs_err(a, b, mask=None):
    """Largest ``|a − b|`` over the lanes in ``mask`` (all when None)."""
    d = (torch.as_tensor(a).cpu() - torch.as_tensor(b).cpu()).abs()
    d = d.reshape(-1, d.shape[-1])
    if mask is not None:
        d = d[:, mask.cpu()]
    return float(d.max()) if d.numel() else 0.0
