"""The species kernel's in-kernel Philox mode, held on the CPU in plain torch.

``csrc/species.cu`` draws its children's noise, the rates and the
pre-selection keep from the megastep's Philox stream (key (seed, 0),
counter (lane, step, generation, draw), the lane's salt in every word).
On CPU tensors ``SpeciesKernel`` runs ``make_species_inner`` on the
tensors ``bio2_megastep.philox_draw`` draws for that step, generation by
generation; these tests hold that entry to the plain version fed with
``philox_draw``'s tensors, bitwise, and the stream's per-lane, per-step
and per-scenario properties.  The kernel itself is held to the plain
version on the card by ``chip_smoke.py`` and by the ``cuda``-marked test
here.  Torch and numpy only (no JAX), a few seconds in all.
"""

import pytest
import torch

from bio_ik_tpu_torch import RobotModel, asset_path
from bio_ik_tpu_torch.interop import tree_from_numpy
from bio_ik_tpu_torch.kernels.bio2_megastep import philox_draw
from bio_ik_tpu_torch.kernels.bio2_step import (SpeciesKernel, SpeciesParams,
                                                make_species_inner)
from bio_ik_tpu_torch.kernels.checks import species_inputs

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

REG = ("beta", "gamma")                 # MinimalDisplacement + AvoidJointLimits
ARMS = {"free_arm.urdf": (3,), "planar_arm.urdf": ()}


def _setup(name, sec_terms=(), N=64, gens=2, mem_iters=2, dev="cpu"):
    """A SpeciesKernel of the robot (C = 16, every variable active) and one
    step's Philox-mode arguments on ``N`` lanes."""
    tm = RobotModel.from_urdf_file(asset_path(name), device="cpu")
    sp = SpeciesParams(V=tm.nvars, K=1, gens=gens, mem_iters=mem_iters,
                       quat_slices=ARMS[name])
    args, kw = species_inputs(tm, "tool", sp, N, sec_terms=sec_terms, philox=True)
    return (SpeciesKernel(sp, sec_terms), tree_from_numpy(args, dev),
            tree_from_numpy(kw, dev))


def _plain(kern, args, kw, seed, step, gauss_mode="clt4"):
    """make_species_inner on philox_draw's tensors of ``step``."""
    sp = kern.sp
    draw_gen = philox_draw(seed, kw["salt"], sp.V, sp.C, gauss_mode,
                           keep=bool(kern.sec_terms))(step)[0]
    d = [draw_gen(g) for g in range(sp.gens)]
    extra = ((torch.stack([x[2] for x in d]), kw["sec"]) if kern.sec_terms else ())
    return make_species_inner(sp, kern.sec_terms)(
        *args, torch.stack([x[0] for x in d]), torch.stack([x[1] for x in d]), *extra)


@pytest.mark.parametrize("terms", [(), REG], ids=["pose", "regularized"])
@pytest.mark.parametrize("name", list(ARMS))
def test_philox_entry_is_inner_on_philox_draws(name, terms):
    kern, args, kw = _setup(name, terms)
    SpeciesKernel.launches = 0
    out = kern(*args, seed=123, step=5, **kw)
    ref = _plain(kern, args, kw, 123, 5)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert SpeciesKernel.launches == 0          # CPU: the plain version
    # the step moved the parents (the draws took part)
    assert not torch.equal(out[0], args[0])


def test_philox_entry_box_muller():
    kern, args, kw = _setup("free_arm.urdf")
    out = kern(*args, seed=9, step=0, gauss_mode="box_muller", **kw)
    ref = _plain(kern, args, kw, 9, 0, "box_muller")
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    clt4 = kern(*args, seed=9, step=0, **kw)
    assert not torch.equal(out[0], clt4[0])


def test_philox_stream_is_per_lane_step_seed_and_salt():
    """A lane's draws depend on its index, the step, the seed and its salt
    only: the first lanes of a wider launch draw what a narrower launch
    draws; another step or seed draws anew; a changed salt of one species
    pair changes that pair's two lanes and no other."""
    kern, args, kw = _setup("free_arm.urdf", REG)
    wide = kern.philox_tensors(7, 2, kw["salt"])
    narrow = kern.philox_tensors(7, 2, kw["salt"][:, :16])
    assert all(torch.equal(a[..., :16], b) for a, b in zip(wide, narrow))
    for seed, step in ((7, 3), (8, 2)):
        other = kern.philox_tensors(seed, step, kw["salt"])
        assert not any(bool((a == b).all()) for a, b in zip(wide, other))
    salt2 = kw["salt"].clone()
    salt2[0, 10:12] ^= 0x5A5A5A5A                # scenario of lanes 10, 11
    out = kern(*args, seed=7, step=2, **kw)
    out2 = kern(*args, seed=7, step=2, **dict(kw, salt=salt2))
    changed = torch.zeros(64, dtype=torch.bool)
    for a, b in zip(out, out2):
        changed |= (a != b).any(0)
    assert changed.nonzero().flatten().tolist() == [10, 11]


def test_philox_wrapper_arguments():
    kern, args, kw = _setup("free_arm.urdf", REG, N=8, gens=1, mem_iters=1)
    salt, sec = kw["salt"], kw["sec"]
    noise = torch.zeros((1, 10, 16, 8))
    rates = torch.zeros((1, 16, 8))
    keeps = torch.zeros((1, 1, 8))
    with pytest.raises(ValueError, match="seed and salt"):
        kern(*args, sec=sec, seed=1)                       # no salt
    with pytest.raises(ValueError, match="seed and salt"):
        kern(*args, noise, rates, keeps, sec, seed=1, salt=salt)   # both modes
    with pytest.raises(ValueError, match="keeps"):
        kern(*args, keeps=keeps, sec=sec, seed=1, salt=salt)      # keeps in Philox mode
    with pytest.raises(ValueError, match="keeps and sec"):
        kern(*args, seed=1, salt=salt)                     # sec missing
    with pytest.raises(ValueError, match="gauss_mode"):
        kern(*args, sec=sec, seed=1, salt=salt, gauss_mode="uniform")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kern(*(a.to("meta") for a in args), sec=sec.to("meta"), seed=1,
             salt=salt.to("meta"))
    out = kern(*args, sec=sec, seed=1, salt=salt)
    assert [tuple(t.shape) for t in out] == [(20, 8), (20, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("terms", [(), REG], ids=["pose", "regularized"])
def test_species_cuda_philox_is_bitwise_the_plain_version(terms):
    """The hand-written kernel in Philox mode (CLT4) against the plain
    version on the card: bitwise, one counted launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    kern, args, kw = _setup("free_arm.urdf", terms, N=4096, gens=8, mem_iters=8,
                            dev="cuda")
    before = SpeciesKernel.launches
    out = kern(*args, seed=31, step=4, **kw)
    ref = _plain(kern, args, kw, 31, 4)
    torch.cuda.synchronize()
    assert SpeciesKernel.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_mulhilo_is_the_exact_64_bit_product():
    """The plain Philox's 32×32 → 64-bit products, formed in int64 modulo
    2^64, against Python's exact integers, at the edges and at random."""
    from bio_ik_tpu_torch.kernels.bio2_fullstep import _mulhilo

    edge = [0, 1, 2, 0xFFFF, 0x10000, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1]
    rand = torch.randint(0, 2 ** 32, (4096,), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(5)).tolist()
    b = torch.tensor(edge + rand, dtype=torch.int64)
    for a in (0xD2511F53, 0xCD9E8D57):
        hi, lo = _mulhilo(a, b)
        exact = [a * x for x in b.tolist()]
        assert hi.tolist() == [p >> 32 for p in exact]
        assert lo.tolist() == [p & 0xFFFFFFFF for p in exact]
