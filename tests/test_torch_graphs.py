"""``graphs.Replay`` and the functions the port replays from CUDA graphs (no
JAX: the ``cuda``-marked tests run on the card's machine, which has none).

On the CPU a ``Replay`` calls its function; on the card it replays a CUDA
graph of it, bitwise the eager call (the ``cuda`` tests, which skip here:
``python -m pytest --noconftest tests/test_torch_graphs.py -m cuda`` on the
card).  A capture refuses what touches the host, so the CPU rehearsal runs
every replayed function of the solvers that replay — on robots with each
joint type, mimic joints and every goal kind — with the port's own code
refused a copy from host data, a read of a tensor to the host and an index
that is a host list or a boolean mask.
"""

import contextlib
import sys

import numpy as np
import pytest
import torch

import bio_ik_tpu_torch.goals as G
from bio_ik_tpu_torch import IKSolver, RobotModel, SolverConfig, asset_path
from bio_ik_tpu_torch.graphs import Replay
from bio_ik_tpu_torch.interop import tree_map
from bio_ik_tpu_torch.solvers.lbfgs import value_and_grad

torch.set_num_threads(1)

TIP = "r_gripper_tool_frame"

MIMIC_URDF = """
<robot name="gripper">
  <link name="base"/><link name="f1"/><link name="f2"/>
  <joint name="drive" type="revolute">
    <parent link="base"/><child link="f1"/><origin xyz="0.1 0 0"/>
    <axis xyz="0 0 1"/><limit lower="0" upper="1" velocity="1"/>
  </joint>
  <joint name="follower" type="revolute">
    <parent link="base"/><child link="f2"/><origin xyz="0 0.1 0"/>
    <axis xyz="0 0 1"/><limit lower="0" upper="2" velocity="1"/>
    <mimic joint="drive" multiplier="2.0" offset="0.1"/>
  </joint>
</robot>
"""


def _robot(name, device):
    """A robot of the joint type ``name`` stands for, with its tips."""
    if name == "mimic":
        return RobotModel.from_urdf_string(MIMIC_URDF, device=device), ["f2"]
    tips = {"pr2_arm": [TIP], "pr2_dual": [TIP, "l_gripper_tool_frame"],  # prismatic torso
            "planar_arm": ["tool"], "free_arm": ["tool"]}[name]           # planar, floating
    return RobotModel.from_urdf_file(asset_path(name + ".urdf"), device=device), tips


def _goals(tips, every_kind=False):
    t = tips[0]
    goals = [G.PoseGoal(link=t, position=(0.3, 0.1, 0.2))]
    if len(tips) > 1:
        goals.append(G.PositionGoal(link=tips[1], position=(0.2, 0.3, 0.3)))
    if every_kind:
        goals += [
            G.OrientationGoal(link=t), G.LookAtGoal(link=t, target=(1.0, 0.0, 0.5)),
            G.MaxDistanceGoal(link=t, target=(0.5, -0.2, 0.6), distance=0.2),
            G.MinDistanceGoal(link=t, target=(0.5, -0.2, 0.6), distance=0.6),
            G.LineGoal(link=t, direction=(0.0, 0.6, 0.8)), G.PlaneGoal(link=t),
            G.SideGoal(link=t, direction=(1.0, 0.0, 0.0)),
            G.DirectionGoal(link=t, direction=(1.0, 0.0, 0.0)),
            G.ConeGoal(link=t, direction=(1.0, 0.0, 0.0), angle=0.3, position_weight=0.5),
            G.TouchGoal(link="r_wrist_roll_link", position=(0.5, -0.2, 0.6)),
            G.BalanceGoal(target=(0.2, -0.1, 0.0)),
            G.LinkFunctionGoal(link=t, function=lambda p, q: torch.sum(p * p, dim=-1)),
            G.JointFunctionGoal(variable_names=("r_shoulder_pan_joint",),
                                function=lambda v: 0.5 * v),
            G.JointVariableGoal(variable_name="r_elbow_flex_joint", variable_position=-1.0),
            G.AvoidJointLimitsGoal(), G.CenterJointsGoal(), G.MinimalDisplacementGoal(),
            G.RegularizationGoal()]
    return goals


def _objective(device, mode="optlib_lbfgs_4", robot="pr2_arm", **cfg):
    m, tips = _robot(robot, device)
    s = IKSolver(m, _goals(tips), SolverConfig(mode=mode, **cfg))
    B = 8
    data = tree_map(lambda x: x.expand((B,) + x.shape).contiguous(),
                    s.make_data(torch.as_tensor(m.neutral_q(), device=device)))
    keys = torch.stack([torch.full((B,), 7), torch.arange(B)], -1).to(device)
    st, _, dr = s._init_islands(keys, data)
    return s, st, dr


def test_replay_calls_the_function_on_the_cpu():
    s, st, dr = _objective("cpu")
    f = s.solver._objective(dr)
    before = Replay.replays
    v, g = Replay(lambda x: value_and_grad(f, x))(st.qa)
    v0, g0 = value_and_grad(f, st.qa)
    assert torch.equal(v, v0) and torch.equal(g, g0) and Replay.replays == before
    one = Replay(lambda x: x * 2)(torch.ones(3))
    assert torch.equal(one, torch.full((3,), 2.0))


def test_replay_passes_trees_of_arguments_on_the_cpu():
    rp = Replay(lambda x, tree, none: x + tree["a"][0] * tree["s"])
    tree = {"a": [torch.ones(2)], "s": 3.0}     # a leaf that is no tensor too
    assert torch.equal(rp(torch.zeros(2), tree, None), torch.full((2,), 3.0))


def test_capture_keeps_the_garbage_collector_off(monkeypatch):
    """A capture runs with Python's cyclic collector off (a collection could
    destroy a dead solver's graph, which invalidates the capture) and turns
    it back on after, also when the captured call raises; with the
    collector off before, it stays off.  The graph API is stubbed."""
    import gc

    from bio_ik_tpu_torch import graphs

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: "graph")
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    assert graphs._capture(lambda x: (gc.isenabled(), x), (7,)) == ("graph", (False, 7))
    assert gc.isenabled()

    def boom():
        raise RuntimeError("capture")

    with pytest.raises(RuntimeError, match="capture"):
        graphs._capture(boom, ())
    assert gc.isenabled()
    gc.disable()
    try:
        graphs._capture(lambda: None, ())
        assert not gc.isenabled()
    finally:
        gc.enable()


def _ours():
    """Whether the caller of the refused call is the port's own code."""
    return sys._getframe(2).f_globals.get("__name__", "").startswith("bio_ik_tpu_torch")


def _host_index(i):
    if isinstance(i, tuple):
        return any(_host_index(x) for x in i)
    return isinstance(i, (list, np.ndarray)) or (torch.is_tensor(i) and i.dtype == torch.bool)


@contextlib.contextmanager
def _no_host_traffic():
    """What a CUDA graph capture refuses, refused in the port's own code."""
    T, saved = torch.Tensor, []

    def refuse(obj, name, bad=lambda *a, **k: True):
        orig = getattr(obj, name)

        def guarded(*a, **k):
            if _ours() and bad(*a, **k):
                raise AssertionError(f"{name} in a replayed function")
            return orig(*a, **k)

        saved.append((obj, name, orig))
        setattr(obj, name, guarded)

    for name in ("tensor", "from_numpy", "nonzero", "masked_select"):
        refuse(torch, name)
    refuse(torch, "as_tensor", lambda x, *a, **k: not torch.is_tensor(x))
    for name in ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "nonzero",
                 "new_tensor"):
        refuse(T, name)
    refuse(T, "__getitem__", lambda self, i: _host_index(i))
    refuse(T, "__setitem__", lambda self, i, v: _host_index(i))
    try:
        yield
    finally:
        for obj, name, orig in reversed(saved):
            setattr(obj, name, orig)


REPLAYING = ("bio1", "gd_c_4", "gd_r_4", "optlib_lbfgs_4", "optlib_gd_4", "optlib_nm_r_4",
             "bio2_memetic_lbfgs", "neural")
WITH_ND = REPLAYING + ("optlib_nd_4",)   # V backward passes: the small robots only


@pytest.mark.parametrize("robot,modes,every_kind", [
    ("pr2_dual", REPLAYING, False), ("planar_arm", WITH_ND, False),
    ("free_arm", WITH_ND, False), ("mimic", WITH_ND, False),
    ("pr2_arm", ("bio1", "gd_4", "optlib_lbfgs_4", "bio2_memetic_lbfgs"), True)])
def test_replayed_functions_touch_no_host_memory(robot, modes, every_kind, monkeypatch):
    """A solve of each mode that replays, with every replayed function run
    once as its first eager call and once more as its capture would see it:
    nothing the capture refuses."""
    def rehearse(self, *args):
        self.fn(*args)
        with _no_host_traffic():
            return self.fn(*args)

    monkeypatch.setattr(Replay, "__call__", rehearse)
    m, tips = _robot(robot, "cpu")
    for mode in modes:
        s = IKSolver(m, _goals(tips, every_kind), SolverConfig(
            mode=mode, max_steps=2, neural_train_steps=2,
            dtype="float64" if mode == "gd_c_4" else "float32"))
        assert torch.isfinite(s.solve(torch.as_tensor(m.neutral_q())).fitness).all()


def _eager(fn):
    """``fn()`` with every ``Replay`` calling its function."""
    replay = Replay.__call__
    try:
        Replay.__call__ = lambda self, *a: self.fn(*a)
        return fn()
    finally:
        Replay.__call__ = replay


@pytest.mark.cuda
@pytest.mark.parametrize("robot,mode,cfg", [
    ("pr2_arm", "bio1", {}), ("pr2_arm", "bio1", {"linear_fitness": True}),
    ("pr2_arm", "gd_c_4", {"dtype": "float64"}), ("pr2_arm", "gd_r_4", {}),
    ("pr2_arm", "optlib_nd_4", {}), ("pr2_arm", "optlib_nm_r_4", {}),
    ("pr2_arm", "bio2_memetic_lbfgs", {}),
    ("pr2_dual", "bio1", {}), ("pr2_dual", "gd_c_4", {}), ("pr2_dual", "optlib_lbfgs_4", {}),
    ("planar_arm", "gd_4", {}), ("mimic", "optlib_lbfgs_4", {}), ("mimic", "bio1", {})])
def test_replayed_steps_are_bitwise_the_eager_steps_on_the_card(robot, mode, cfg):
    """4 steps of each solver that replays CUDA graphs, from one init and
    one random stream, equal the eager steps bit for bit; the graphs
    captured for one solve's rows serve another's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    s, _, dr = _objective("cuda", mode, robot, **cfg)
    keys = torch.stack([torch.full((8,), 7), torch.arange(8)], -1).cuda()

    def run(d):
        st, _, d = s._init_islands(keys, tree_map(lambda x: x[::s.islands], d))
        for _ in range(4):
            st = s.solver.step(st, d)
        return [x for x in st if torch.is_tensor(x)]

    replays = [r for r in vars(s.solver).values() if isinstance(r, Replay)]
    for a, b in zip(run(dr), _eager(lambda: run(dr))):
        assert torch.equal(a, b)
    graphs, before = sum(len(r._graphs) for r in replays), Replay.replays
    other = tree_map(lambda x: x.clone(), dr)     # another solve's data tensors
    for a, b in zip(run(other), _eager(lambda: run(other))):
        assert torch.equal(a, b)
    assert Replay.replays > before and sum(len(r._graphs) for r in replays) == graphs


@pytest.mark.cuda
def test_replay_is_bitwise_the_eager_call_on_the_card():
    """The objective's value and gradient and one optlib step from CUDA
    graph replays equal the eager calls bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    s, st, dr = _objective("cuda")
    f = s.solver._objective(dr)
    rp = Replay(lambda x: value_and_grad(f, x))
    for shift in (0.01, -0.02, 0.03, -0.04):
        x = st.qa + shift
        v, g = rp(x)
        v0, g0 = value_and_grad(f, x)
        assert torch.equal(v, v0) and torch.equal(g, g0)
    assert len(rp._graphs) == 1
    graphed = s.solver.step(st, dr)
    plain = _eager(lambda: s.solver.step(st, dr))
    assert torch.equal(graphed.qa, plain.qa) and torch.equal(graphed.best_fitness,
                                                             plain.best_fitness)
