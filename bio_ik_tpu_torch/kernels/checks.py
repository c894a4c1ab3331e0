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

__all__ = ["megastep_inputs", "species_inputs", "lane_agreement", "max_abs_err"]


def megastep_inputs(model, tip: str, sp, n_steps: int, N: int, seed: int = 7,
                    spread: float = 1e-3, with_noise: bool = True):
    """numpy ``(state, consts, noise)`` for one megastep launch on ``N``
    lanes of ``model``/``tip`` (one pose goal, K = 1), made from ``seed``:
    a reachable target per species pair (exact FK of a uniform q*,
    pose weights of bench.py's goal), both parents at q* plus gaussian
    noise of ``spread`` rad — the state of a solve under way — the model's
    bounds, and noise tensors with the real rate ladder.
    ``noise = (noise, rates, wipe_u, wipe_g)``, or None without
    ``with_noise`` (in-kernel RNG runs).

    Far from a solution the memetic line search divides differences of
    nearly equal fitness values, so two correct implementations that round
    differently part ways on most lanes; near one they agree."""
    from ..kinematics import make_fk

    V = sp.V
    rng = np.random.default_rng(seed)
    f32 = np.float32
    b = model._np_bounds
    # one target per species pair: the two lanes of an island share it
    qstar = np.repeat(rng.uniform(b["min"], b["max"], size=((N + 1) // 2, V)),
                      2, axis=0)[:N].astype(f32)
    tg = make_fk(model, [tip], device="cpu")(torch.from_numpy(qstar))
    pos = tg.pos[:, 0].numpy().T
    quat = tg.quat[:, 0].numpy().T
    genes = np.tile(qstar.T, (2, 1)) + rng.normal(size=(2 * V, N)) * spread
    genes = np.clip(genes, np.tile(b["clip_min"], 2)[:, None],
                    np.tile(b["clip_max"], 2)[:, None]).astype(f32)

    def rows(x):
        return np.ascontiguousarray(np.tile(x.astype(f32)[:, None], (1, N)))

    state = (
        genes,
        (rng.normal(size=(2 * V, N)) * 0.01).astype(f32),
        np.full((1, N), np.inf, f32),                       # sfit
        genes[:V].copy(),                                   # sol
        np.full((1, N), 1e30, f32),                         # sol_fit
        np.zeros((7, N), f32),                              # sol_tips
    )
    consts = (
        np.zeros((1, N), f32),                              # qfix (none)
        np.ascontiguousarray(pos, dtype=f32),               # gpos
        np.ascontiguousarray(quat, dtype=f32),              # gquat
        np.ones((sp.K, N), f32),                            # wpos
        np.full((sp.K, N), 0.25, f32),                      # wrot
        rows(b["span"]), rows(b["clip_min"]), rows(b["clip_max"]),
        rows(b["min"]), rows(b["max"]),
    )
    if not with_noise:
        return state, consts, None
    sg = n_steps * sp.gens
    k = rng.integers(0, 16, size=(sg, sp.C, N))
    noise = (
        rng.normal(size=(sg, V, sp.C, N)).astype(f32),
        np.exp2(k - 23.0).astype(f32),
        rng.uniform(size=(n_steps, 1, N)).astype(f32),
        rng.uniform(size=(n_steps, V, N)).astype(f32),
    )
    return state, consts, noise


def species_inputs(model, tip: str, sp, N: int, seed: int = 7,
                   spread: float = 1e-3):
    """numpy arguments of one species step (:class:`SpeciesKernel` order)
    on ``N`` lanes of ``model``/``tip`` with every variable active (K = 1),
    made from ``seed``: a solve under way as in :func:`megastep_inputs` —
    one reachable target per species pair (exact FK of a uniform q* whose
    quaternion blocks are normalized), both parents ``spread`` off it —
    then ``tips0``/``deltas`` from the port's linearizer at parent 0, pose
    weights of bench.py's goal (so both fitness terms are exercised), the
    model's bounds, and noise and rates with the real rate ladder."""
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

    k = rng.integers(0, 16, size=(sp.gens, sp.C, N))
    return (
        genes,
        (rng.normal(size=(2 * V, N)) * 0.01).astype(f32),
        np.ascontiguousarray(tips0[:, 0].numpy().T),
        np.ascontiguousarray(deltas.numpy()),
        np.ascontiguousarray(tg.pos[:, 0].numpy().T),
        np.ascontiguousarray(tg.quat[:, 0].numpy().T),
        np.ones((K, N), f32),
        np.full((K, N), 0.25, f32),
        rows(b["span"]), rows(b["clip_min"]), rows(b["clip_max"]),
        rng.standard_normal(size=(sp.gens, V, sp.C, N), dtype=f32),
        np.exp2(k - 23.0).astype(f32),
    )


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
