#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                  # every phase (what CI runs)
    python3 chip_smoke.py --only build,check

Drives ``bio_ik_tpu_torch`` (never JAX) through its main path and holds the
hand-written CUDA kernel against its plain torch version.  Phases, each
printing one JSON line; any failure raises and exits non-zero:

  1. build    — card name and power limit, torch/CUDA versions, nvcc build
                of every kernel source (in parallel) and its ptxas report;
  2. check    — megastep kernel vs plain version in noise-tensor mode at the
                main path's sizes (PR2, V=7, K=1, C=16, gens=8, mem_iters=8,
                n_steps=2, N=4096): ≥ 85 % of lanes agree (beside the
                plain version on the CPU vs the card, the floor between two
                correct versions); exact FK and fitness with no selection
                agree on all 131 072 lanes of the first launch (atol 1e-5);
  3. rng      — in-kernel Philox vs the plain version's Philox at the lane
                count of each of the four launches (two steps, ≥ 85 % of
                lanes), clt4 moments over ≥ 1 M draws, rate-bin
                uniformity, bitwise reproducibility, salt locality;
  4. main     — bench.py's configuration through AdaptiveBatchSolver at
                B = 65 536: success, median position error, solves/s,
                launches per solve_batch (must be 4), determinism, the
                success flags re-derived from the returned q, and a small
                solve on the card beside the same on the CPU plain path;
  5. times    — the kernel at each phase's launch shape (CUDA events) and
                the plain version at phase 1, beside the FLOP/byte bound;
  6. profile  — torch.profiler over one solve_batch of the main path:
                device time by kernel, device busy and idle share.

The last lines are the kernels JSON line, the ``nvidia-smi`` name/power
line, and ``{"ok": true, "device": {...}}``.  Exits non-zero without a
result when there is no CUDA device or the package is missing.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TIP = "r_gripper_tool_frame"
PHASES = ((1, 24), (2, 32), (4, 64), (8, 32))
FRACTIONS = (0.15, 0.03, 0.008)
B_MAIN = 65536
QUEUE, REPEATS = 16, 3      # bench.py: 16 batches queued, best of 3
# H100 SXM published peaks (NVIDIA's data sheet, 700 W): FP32 outside the
# tensor cores, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def phase_shapes():
    """(lanes, n_steps) of the main path's four megastep launches: B scenarios
    × islands × 2 species, B cut to int(B·fraction) in each retry phase."""
    out = []
    for i, (islands, steps) in enumerate(PHASES):
        b = B_MAIN if i == 0 else max(1, int(B_MAIN * FRACTIONS[i - 1]))
        out.append((b * islands * 2, steps))
    return out


def cuda_ms(fn, reps):
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


class Smoke:
    def __init__(self):
        import torch
        from bio_ik_tpu_torch import RobotModel, asset_path

        self.torch = torch
        self.dev = torch.device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"))
        self.cpu_model = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"),
                                                   device="cpu")
        self.kernels = {}

    # -------------------------------------------------------------- 1 --
    def build(self):
        import torch
        from bio_ik_tpu_torch.kernels.build import build_all, ptxas_report

        secs = build_all(["megastep"])
        emit({"phase": "build", "gpu": smi_line(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": secs,
              "ptxas": ptxas_report("megastep").strip().splitlines()})

    def _mega(self, n_steps, gens=8, mem_iters=8, memetic="q"):
        from bio_ik_tpu_torch.kernels.bio2_megastep import Megastep
        from bio_ik_tpu_torch.kernels.bio2_step import SpeciesParams

        sp = SpeciesParams(V=7, K=1, C=16, gens=gens, mem_iters=mem_iters,
                           memetic=memetic)
        return Megastep(self.model, [TIP], list(range(7)), [0], sp,
                        n_steps), sp

    def _inputs(self, sp, n_steps, N, seed=7, spread=1e-3, with_noise=True):
        from bio_ik_tpu_torch.interop import tree_from_numpy
        from bio_ik_tpu_torch.kernels.checks import megastep_inputs

        state, consts, noise = megastep_inputs(
            self.model, TIP, sp, n_steps, N, seed, spread=spread,
            with_noise=with_noise)
        return (tree_from_numpy(state, self.dev),
                tree_from_numpy(consts, self.dev),
                None if noise is None else tree_from_numpy(noise, self.dev))

    # -------------------------------------------------------------- 2 --
    def check(self):
        from bio_ik_tpu_torch.kernels.bio2_megastep import Megastep, array_draw
        from bio_ik_tpu_torch.kernels.checks import lane_agreement, max_abs_err

        N = 4096
        mega, sp = self._mega(2)
        state, consts, noise = self._inputs(sp, 2, N)
        k_out = mega(state, consts, noise=noise[0], rates=noise[1],
                     wipe_u=noise[2], wipe_g=noise[3])
        p_out = mega.body(state, consts, array_draw(*noise, sp.gens))
        self.torch.cuda.synchronize()
        agree = lane_agreement(k_out, p_out)
        frac = float(agree.float().mean())
        # the floor of that fraction between two correct versions that round
        # differently: the plain version on the CPU against itself on the card
        cpu = [tuple(t.cpu() for t in x) for x in (state, consts, noise)]
        cpu_mega = Megastep(self.cpu_model, [TIP], list(range(7)), [0], sp, 2)
        c_out = cpu_mega.body(cpu[0], cpu[1], array_draw(*cpu[2], sp.gens))
        floor = float(lane_agreement(p_out, c_out).float().mean())
        # no selection: zero generations, no memetic, one step — the
        # incumbent then holds the exact FK tips and fitness of parent 0;
        # compared on every lane of the first phase's launch
        N = phase_shapes()[0][0]
        fk_mega, fsp = self._mega(1, gens=0, mem_iters=0, memetic="")
        fstate, fconsts, fnoise = self._inputs(fsp, 1, N, seed=11)
        fk_k = fk_mega(fstate, fconsts, noise=fnoise[0], rates=fnoise[1],
                       wipe_u=fnoise[2], wipe_g=fnoise[3])
        fk_p = fk_mega.body(fstate, fconsts, array_draw(*fnoise, 0))
        err_tips = max_abs_err(fk_k[5], fk_p[5])
        err_fit = max_abs_err(fk_k[4], fk_p[4])
        # agreement by stage (steps, gens, mem_iters) and far from a
        # solution, for the record
        stages = {}
        for steps, gens, mem, spread in ((1, 8, 0, 1e-3), (1, 0, 8, 1e-3),
                                         (1, 8, 8, 1e-3), (2, 8, 8, 1e-2),
                                         (2, 8, 8, 5e-2)):
            m2, sp2 = self._mega(steps, gens=gens, mem_iters=mem,
                                 memetic="q" if mem else "")
            s2, c2, n2 = self._inputs(sp2, steps, 4096, spread=spread)
            a2 = lane_agreement(
                m2(s2, c2, noise=n2[0], rates=n2[1], wipe_u=n2[2], wipe_g=n2[3]),
                m2.body(s2, c2, array_draw(*n2, gens)))
            stages[f"{steps}x{gens}x{mem}@{spread}"] = float(a2.float().mean())
        emit({"phase": "check", "lanes": 4096, "agree_frac": frac,
              "plain_cpu_vs_card_agree_frac": floor, "fk_lanes": N,
              "fk_max_abs_err": err_tips, "fit_max_abs_err": err_fit,
              "agree_max_abs_err": max(max_abs_err(a, b, agree)
                                       for a, b in zip(k_out, p_out)),
              "agree_by_stage": stages})
        if frac < 0.85:
            raise AssertionError(f"kernel agrees with the plain version on "
                                 f"{frac:.3f} of lanes (< 0.85)")
        if not (err_tips <= 1e-5 and err_fit <= 1e-5):
            raise AssertionError(f"exact FK/fitness disagree: {err_tips}, {err_fit}")
        self.kernels["agree_frac"] = frac
        self.kernels["max_abs_err"] = max(err_tips, err_fit)

    # -------------------------------------------------------------- 3 --
    def rng(self):
        import torch
        from bio_ik_tpu_torch.kernels.bio2_fullstep import (
            gauss_from_u01, philox_words, rate_from_bits, u01_from_bits)
        from bio_ik_tpu_torch.kernels.bio2_megastep import philox_draw
        from bio_ik_tpu_torch.kernels.checks import lane_agreement

        mega, sp = self._mega(2)
        seed = 1234567
        gen = torch.Generator(self.dev).manual_seed(3)

        def pair_salt(n):
            """One random salt per scenario; a species pair shares it."""
            s = torch.randint(-2**31, 2**31 - 1, (1, n // 2), dtype=torch.int32,
                              device=self.dev, generator=gen)
            return s.repeat_interleave(2, dim=1)

        # in-kernel Philox against the plain version's Philox, at the lane
        # count of each of the main path's launches (two steps each)
        agree = {}
        for N, _ in phase_shapes():
            state, consts, _ = self._inputs(sp, 2, N, with_noise=False)
            salt = pair_salt(N)
            k1 = mega(state, consts, seed=seed, salt=salt)
            p1 = mega.body(state, consts, philox_draw(seed, salt, sp.V, sp.C))
            torch.cuda.synchronize()
            agree[N] = float(lane_agreement(k1, p1).float().mean())
        N = 4096
        state, consts, _ = self._inputs(sp, 2, N, with_noise=False)
        salt = pair_salt(N)
        k1 = mega(state, consts, seed=seed, salt=salt)
        k2 = mega(state, consts, seed=seed, salt=salt)
        bitwise = all(torch.equal(a, b) for a, b in zip(k1, k2))
        # one scenario's salt changes (its two lanes of one island)
        salt2 = salt.clone()
        salt2[0, 100:102] ^= 0x5A5A5A5A
        k3 = mega(state, consts, seed=seed, salt=salt2)
        changed = torch.zeros(N, dtype=torch.bool, device=self.dev)
        for a, b in zip(k1, k3):
            changed |= (a != b).any(dim=0)
        only_own = bool(changed[100:102].all()) and int(changed.sum()) == 2
        # the stream's statistics (the kernel draws these same bits)
        lane = torch.arange(N, device=self.dev, dtype=torch.int64)[None]
        idx = torch.arange(256, device=self.dev, dtype=torch.int64)[:, None]
        s64 = salt.to(torch.int64) & 0xFFFFFFFF
        w = philox_words(seed, lane, 0, 0, idx, s64)
        g = gauss_from_u01([u01_from_bits(x) for x in w]).double()
        kb = (rate_from_bits(w[0]).log2() + 23).round().long()
        hist = torch.bincount(kb.flatten(), minlength=16).double()
        rel = (hist / hist.mean() - 1).abs().max().item()
        out = {"phase": "rng", "kernel_vs_plain_agree_frac_by_lanes": agree,
               "bitwise_repeat": bitwise, "salt_changes_only_own_lanes": only_own,
               "gauss_draws": g.numel(), "gauss_mean": g.mean().item(),
               "gauss_var": g.var().item(), "rate_bins_max_rel_dev": rel}
        emit(out)
        if not (min(agree.values()) >= 0.85 and bitwise and only_own
                and g.numel() >= 1 << 20
                and abs(out["gauss_mean"]) < 0.01
                and abs(out["gauss_var"] - 1) < 0.02 and rel < 0.1):
            raise AssertionError(f"RNG check failed: {out}")

    # -------------------------------------------------------------- 4 --
    def _bench(self, model, B, phases=PHASES, fractions=FRACTIONS):
        import numpy as np
        import torch
        import bio_ik_tpu_torch.goals as G
        from bio_ik_tpu_torch import AdaptiveBatchSolver, SolverConfig, make_fk
        from bio_ik_tpu_torch.interop import tree_map

        dev = model.device
        fk = make_fk(model, [TIP])
        b = model._np_bounds
        qg = np.random.default_rng(0).uniform(
            b["min"], b["max"], size=(B, model.nvars)).astype(np.float32)
        tg = fk(torch.as_tensor(qg, device=dev))
        s = AdaptiveBatchSolver(model, [G.PoseGoal(link=TIP)],
                                SolverConfig(mode="bio2_memetic", dtwist=1e-3),
                                phases=phases, fractions=fractions)
        data = tree_map(lambda x: x.expand((B,) + x.shape).contiguous(),
                        s.make_data(torch.as_tensor(model.neutral_q())))
        data["primary"][0]["position"] = tg.pos.contiguous()
        data["primary"][0]["orientation"] = tg.quat.contiguous()
        keys = torch.stack([torch.zeros(B, dtype=torch.int64),
                            torch.arange(B, dtype=torch.int64)], -1).to(dev)
        return s, data, keys, fk, tg

    def main(self):
        import numpy as np
        import torch
        from bio_ik_tpu_torch.engine import fold_in
        from bio_ik_tpu_torch.kernels.bio2_megastep import Megastep

        s, data, keys, fk, tg = self._bench(self.model, B_MAIN)
        t0 = time.perf_counter()
        res = s.solve_batch(keys, data)          # warm-up (build, caches)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        Megastep.launches = 0
        res = s.solve_batch(keys, data)
        torch.cuda.synchronize()
        launches = Megastep.launches
        res2 = s.solve_batch(keys, data)
        det = all(torch.equal(a, b) for a, b in zip(res, res2))
        Q = QUEUE
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            for r in range(Q):
                out = s.solve_batch(fold_in(keys, 1000 + r), data)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / Q)
        dt = min(times)
        success = float(res.success.float().mean())
        perr = (fk(res.q).pos[:, 0] - tg.pos[:, 0]).norm(dim=-1)
        med = float(perr.median())
        # the returned success flags re-derived from the returned q alone:
        # exact FK, then the acceptance test (problem.cpp:259-341)
        p = s.problem
        qa = res.q[:, torch.as_tensor(p.active_vars, device=res.q.device)]
        recheck = p.check_solution(fk(res.q), qa, data)
        flags_agree = float((recheck == res.success).float().mean())
        # a small solve on the card and on the CPU plain path (same keys,
        # same Philox bits): statistically alike, not lane-identical —
        # trajectories far from a solution part ways on rounding
        Bs = 256
        sg, dg, kg, _, _ = self._bench(self.model, Bs, ((1, 12), (2, 12)), (0.5,))
        sc, dc, kc, _, _ = self._bench(self.cpu_model, Bs, ((1, 12), (2, 12)), (0.5,))
        rg, rc = sg.solve_batch(kg, dg), sc.solve_batch(kc, dc)
        out = {"phase": "main", "batch": B_MAIN, "success_rate": success,
               "median_pos_err_m": med, "solves_per_s": B_MAIN * success / dt,
               "batch_time_ms": dt * 1e3, "times_ms": [t * 1e3 for t in times],
               "first_call_s": first_s, "launches_per_solve_batch": launches,
               "deterministic": det,
               "success_flags_recheck_agree": flags_agree,
               "small_solve_success_gpu_cpu": [float(rg.success.float().mean()),
                                               float(rc.success.float().mean())]}
        emit(out)
        self.kernels["launches"] = launches
        if launches != len(PHASES):
            raise AssertionError(f"{launches} megastep launches per solve_batch")
        if not det:
            raise AssertionError("two runs with the same keys differ")
        if flags_agree < 0.999:
            raise AssertionError(f"success flags disagree with a re-check: {out}")
        if not (success >= 0.999 and med <= 1.7e-6 and np.isfinite(med)):
            raise AssertionError(f"quality below the JAX path's: {out}")

    # -------------------------------------------------------------- 6 --
    def profile(self):
        """Where one solve_batch of the main path spends device time:
        torch.profiler over a warm call, device time by kernel name, and
        the device's busy share of the host-clock wall time."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        s, data, keys, _, _ = self._bench(self.model, B_MAIN)
        s.solve_batch(keys, data)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.solve_batch(keys, data)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6

        def dev_us(e, self_only):
            name = "self_device_time_total" if self_only else "device_time_total"
            return getattr(e, name, 0.0) or 0.0

        ev = [e for e in prof.key_averages() if dev_us(e, True) > 0]
        busy_us = sum(dev_us(e, True) for e in ev)
        top = sorted(ev, key=lambda e: -dev_us(e, True))[:10]
        emit({"phase": "profile", "wall_ms": wall_us / 1e3,
              "device_busy_ms": busy_us / 1e3,
              "device_idle_share": 1.0 - busy_us / wall_us,
              "device_ops": len(ev),
              "top": [{"name": e.key[:80], "ms": dev_us(e, True) / 1e3,
                       "count": e.count} for e in top]})

    # -------------------------------------------------------------- 5 --
    def times(self):
        import torch
        from bio_ik_tpu_torch.kernels.bio2_megastep import (
            megastep_flops_per_lane, philox_draw)

        rows = []
        shapes = phase_shapes()
        for N, steps in shapes:
            mega, sp = self._mega(steps)
            state, consts, _ = self._inputs(sp, steps, N, with_noise=False)
            salt = torch.arange(N, dtype=torch.int32, device=self.dev)[None] // 2
            run = lambda: mega(state, consts, seed=99, salt=salt)  # noqa: E731
            run()
            torch.cuda.synchronize()
            ms = cuda_ms(run, 5)
            flops = megastep_flops_per_lane(sp, steps) * N
            V, K = sp.V, sp.K
            nbytes = 4 * N * (2 * (4 * V + 2 + V + 7) + 5 * V + 9 * K + 1 + 1)
            ops_ms, bytes_ms = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
            rows.append({"lanes": N, "n_steps": steps, "ms": ms,
                         "gflop": flops / 1e9, "bytes": nbytes,
                         "bound_ms": max(ops_ms, bytes_ms),
                         "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                         "flop_rate_tflops": flops / ms / 1e9})
        # plain version at phase 1's shape (the same Philox bits), once
        N, steps = shapes[0]
        mega, sp = self._mega(steps)
        state, consts, _ = self._inputs(sp, steps, N, with_noise=False)
        salt = torch.arange(N, dtype=torch.int32, device=self.dev)[None] // 2
        warm, _ = self._mega(1)
        warm.body(state, consts, philox_draw(99, salt, sp.V, sp.C))
        plain_ms = cuda_ms(lambda: mega.body(
            state, consts, philox_draw(99, salt, sp.V, sp.C)), 1)
        # generating the noise in the kernel against reading the same
        # draws' worth from noise tensors: phase 1's lanes at two steps
        mega, sp = self._mega(2)
        state, consts, _ = self._inputs(sp, 2, N, with_noise=False)
        g = torch.Generator(self.dev).manual_seed(5)
        sg = 2 * sp.gens
        noise = dict(
            noise=torch.randn((sg, sp.V, sp.C, N), device=self.dev, generator=g),
            rates=torch.exp2(torch.randint(0, 16, (sg, sp.C, N), device=self.dev,
                                           generator=g).float() - 23),
            wipe_u=torch.rand((2, 1, N), device=self.dev, generator=g),
            wipe_g=torch.rand((2, sp.V, N), device=self.dev, generator=g))
        split = {}
        for mode, run in (
                ("philox_ms", lambda: mega(state, consts, seed=99, salt=salt)),
                ("noise_tensor_ms", lambda: mega(state, consts, **noise))):
            run()
            torch.cuda.synchronize()
            split[mode] = cuda_ms(run, 10)
        split.update(lanes=N, n_steps=2,
                     noise_bytes=sum(t.numel() * 4 for t in noise.values()))
        del noise
        emit({"phase": "times", "megastep": rows, "plain_phase1_ms": plain_ms,
              "rng_split": split, "gpu": smi_line()})
        r0 = rows[0]
        self.kernels.update(ms=r0["ms"], plain_ms=plain_ms,
                            bound_ms=r0["bound_ms"], bound_by=r0["bound_by"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="build,check,rng,main,times,profile",
                    help="comma-separated phases to run")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        sys.exit("chip_smoke: torch is not installed")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's smoke run needs the card")
    sys.path.insert(0, ROOT)
    try:
        import bio_ik_tpu_torch  # noqa: F401
    except ImportError as e:
        sys.exit(f"chip_smoke: the bio_ik_tpu_torch package is missing ({e})")
    smoke = Smoke()
    phases = args.only.split(",")
    for name in phases:
        getattr(smoke, name)()
    k = smoke.kernels
    emit({"kernels": [{
        "name": "megastep",
        "route": "cuda",
        "source": "bio_ik_tpu_torch/csrc/megastep.cu",
        "replaces": "bio_ik_tpu/kernels/bio2_megastep.py:321",
        "launches": k.get("launches"),
        "max_abs_err": k.get("max_abs_err"),
        "agree_frac": k.get("agree_frac"),
        "ms": k.get("ms"),
        "plain_ms": k.get("plain_ms"),
        "bound_ms": k.get("bound_ms"),
        "bound_by": k.get("bound_by"),
        "library_ms": None,
    }]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
