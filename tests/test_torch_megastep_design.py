"""The megastep kernel's design, held on the CPU in plain torch and Python.

``csrc/megastep.cu`` splits a lane's children over a group of G threads
and merges their best two by shuffles; it ranks the secondary pre-selection
across the group; it draws its randomness with a lean word mapping
(``bio2_megastep.philox_draw``).  The wide layout (``csrc/megastep_wide.cuh``)
runs a lane over a group of W threads: the children's genes by (child,
quad) items whose Philox calls no two items share, the merge and ranking
over the group, the lane's vectors in a region of shared memory whose size
the wrapper mirrors.  None of that runs here, so these tests
hold plain emulations of the kernel's algorithms to the sequential scan
and to ``bio2_step.preselect``, and the plain draw mapping to an
independent pure-Python Philox.  The kernel itself is held to them on the
card by ``chip_smoke.py`` and by the ``cuda``-marked test here.  Torch and
numpy only (no JAX), a few seconds in all.
"""

import math

import numpy as np
import pytest
import torch

from bio_ik_tpu_torch import RobotModel, asset_path
from bio_ik_tpu_torch.interop import tree_from_numpy
from bio_ik_tpu_torch.kernels.bio2_fullstep import (
    clt4_from_fields,
    gauss_from_u01,
    packed_fields,
    philox_words,
    rates_from_words,
)
from bio_ik_tpu_torch.kernels.bio2_megastep import (
    MEGASTEP_GROUPS,
    Megastep,
    _branch_slots,
    array_draw,
    choose_group,
    choose_width,
    clt4_calls,
    megastep_smem_bytes,
    philox_calls_per_lane_step,
    philox_draw,
    wide_widths,
)
from bio_ik_tpu_torch.kernels.bio2_step import SpeciesParams, preselect
from bio_ik_tpu_torch.kernels.checks import lane_agreement, megastep_inputs

# small tensors: one intra-op thread per test worker (the suite runs six)
torch.set_num_threads(1)

TIP = "r_gripper_tool_frame"
C = 16
P0, P1 = -2, -1          # the kernel's handles of the two parents
INF = float("inf")


# ---- the generation's best two -------------------------------------------


def scan_select(f):
    """The sequential scan the kernel reproduces: pool p0, p1, child
    0..C−1 (``f[0]``, ``f[1]``, ``f[2:]``), p1 first only if strictly
    better, then each child offered on strict '<'.  Returns the handles."""
    return select_two(f[0], f[1], [(x, c) for c, x in enumerate(f[2:])])


def _lex_less(a, b):
    return a[0] < b[0] or (a[0] == b[0] and a[1] < b[1])


def group_select(f, G):
    """The kernel's emulation: thread j scans its children c ≡ j (mod G)
    from (+inf, none); a butterfly of xor-shuffles merges the threads'
    pairs under (f, index); the parents' scan then takes the group's two."""
    none = (INF, 1 << 31)
    pairs = []
    for j in range(G):
        a, b = none, none
        for c in range(j, C, G):
            x = f[2 + c]
            if x < a[0]:
                a, b = (x, c), a
            elif x < b[0]:
                b = (x, c)
        pairs.append((a, b))
    off = 1
    while off < G:
        new = []
        for j in range(G):
            (a1, a2), (b1, b2) = pairs[j], pairs[j ^ off]
            if _lex_less(b1, a1):
                new.append((b1, a1 if _lex_less(a1, b2) else b2))
            else:
                new.append((a1, b1 if _lex_less(b1, a2) else a2))
        pairs = new
        off <<= 1
    assert all(p == pairs[0] for p in pairs)     # every thread, the same two
    (c1f, c1), (c2f, c2) = pairs[0]
    return select_two(f[0], f[1], [(c1f, c1), (c2f, c2)])


def select_two(fp0, fp1, kids):
    """The parents' scan over the offered ``(f, index)`` children."""
    sw = fp1 < fp0
    f1, h1, f2, h2 = (fp1, P1, fp0, P0) if sw else (fp0, P0, fp1, P1)
    for x, c in kids:
        if x < f1:
            f1, h1, f2, h2 = x, c, f1, h1
        elif x < f2:
            f2, h2 = x, c
    return h1, h2


def _pools(kind, n=1500, seed=0):
    r = np.random.default_rng(seed)
    if kind == "random":
        f = r.standard_normal((n, C + 2))
    elif kind == "ties":
        f = r.integers(0, 3, (n, C + 2)).astype(float)
        f[:50] = 1.0                                   # all-ties pools
    else:   # NaN and ±inf in p0, p1 and children
        f = r.integers(0, 4, (n, C + 2)).astype(float)
        special = r.choice([np.nan, np.inf, -np.inf], (n, C + 2))
        hit = r.uniform(size=(n, C + 2)) < 0.25
        f[hit] = special[hit]
        f[:20, 0] = np.nan
        f[20:40, 1] = np.nan
        f[40:60, :2] = np.nan
        f[60:80, 2:] = np.nan
    return f.astype(np.float32).astype(float)


# the group sizes of the narrow layout and the widths of the wide one
GROUP_SIZES = sorted(set(MEGASTEP_GROUPS["megastep"]) | set(MEGASTEP_GROUPS["megastep_wide"])
                     | set(MEGASTEP_GROUPS["megastep_high"]))


@pytest.mark.parametrize("kind", ["random", "ties", "nonfinite"])
@pytest.mark.parametrize("G", GROUP_SIZES)
def test_group_best_two_is_the_sequential_scan(G, kind):
    for f in _pools(kind, seed=G):
        assert group_select(list(f), G) == scan_select(list(f)), f


@pytest.mark.parametrize("kind", ["random", "ties", "inf"])
def test_sequential_scan_is_the_plain_first_min_pick(kind):
    """Without NaN the scan picks what the plain version's two argmins
    pick (bio2_fullstep: first-min select of 2 of C+2)."""
    f = _pools("ties" if kind == "inf" else kind, seed=7)
    if kind == "inf":
        f[np.random.default_rng(8).uniform(size=f.shape) < 0.3] = np.inf
    t = torch.as_tensor(f.T, dtype=torch.float32)             # (C+2, n)
    i1 = torch.argmin(t, 0, keepdim=True)
    i2 = torch.argmin(t.scatter(0, i1, INF), 0, keepdim=True)
    for lane, row in enumerate(f):
        h1, h2 = scan_select(list(row))
        assert (h1 + 2, h2 + 2) == (int(i1[0, lane]), int(i2[0, lane])), row


@pytest.mark.parametrize("G", MEGASTEP_GROUPS["megastep"])
def test_group_ranking_is_preselect(G):
    """The secondary pre-selection as the kernel ranks it: each thread
    counts, for each of its children, the C values it receives by shuffles
    (s_j < s_c, or equal and j < c); kept iff the rank is below
    int(keep·(C−1)) + 1 — the children preselect keeps."""
    r = np.random.default_rng(G)
    n = 600
    s = r.integers(0, 6, (C, n)).astype(np.float32)              # many ties
    s[r.uniform(size=s.shape) < 0.05] = np.nan
    s[:, :40] = 2.0                                               # all ties
    keep = r.uniform(size=(1, n)).astype(np.float32)
    fit = np.zeros((C + 2, n), np.float32)
    want = preselect(torch.from_numpy(fit), torch.from_numpy(s),
                     torch.from_numpy(keep), C)[2:] == 0.0
    kcount = (keep * (C - 1)).astype(np.int32) + 1
    for lane in range(n):
        kept = np.zeros(C, bool)
        for j in range(G):
            own = list(range(j, C, G))
            rank = [0] * len(own)
            for kk in range(C // G):              # received in this order
                for src in range(G):
                    cj = kk * G + src
                    sv = s[cj, lane]
                    for k, c in enumerate(own):
                        sc = s[c, lane]
                        rank[k] += bool(sv < sc or (sv == sc and cj < c))
            for k, c in enumerate(own):
                kept[c] = rank[k] < kcount[0, lane]
        assert kept.tolist() == want[:, lane].tolist()


@pytest.mark.parametrize("W", sorted(set(MEGASTEP_GROUPS["megastep_wide"])
                                     | set(MEGASTEP_GROUPS["megastep_high"])))
def test_wide_group_ranking_is_preselect(W):
    """The wide layout's pre-selection: thread j ranks its children c = k·W
    + j against the C values in the lane's shared memory (s_j < s_c, or
    equal and j < c), kept iff the rank is below int(keep·(C−1)) + 1 — the
    children preselect keeps, with W above C (threads with no child) too."""
    r = np.random.default_rng(W)
    n = 400
    s = r.integers(0, 6, (C, n)).astype(np.float32)
    s[r.uniform(size=s.shape) < 0.05] = np.nan
    s[:, :40] = 2.0
    keep = r.uniform(size=(1, n)).astype(np.float32)
    fit = np.zeros((C + 2, n), np.float32)
    want = preselect(torch.from_numpy(fit), torch.from_numpy(s),
                     torch.from_numpy(keep), C)[2:] == 0.0
    kcount = (keep * (C - 1)).astype(np.int32) + 1
    for lane in range(n):
        kept = np.zeros(C, bool)
        for j in range(W):
            for c in range(j, C, W):
                sc = s[c, lane]
                rank = sum(bool(s[jj, lane] < sc or (s[jj, lane] == sc and jj < c))
                           for jj in range(C))
                kept[c] = rank < kcount[0, lane]
        assert kept.tolist() == want[:, lane].tolist()


# ---- the draw mapping -----------------------------------------------------

_M32 = 0xFFFFFFFF


def _philox_py(ctr, key):
    """Philox4x32-10 on Python ints (Salmon et al., SC'11)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & _M32,
                          (p0 >> 32) ^ c3 ^ k1, p0 & _M32)
    return c0, c1, c2, c3


def test_draw_mapping_known_answers():
    """philox_draw against words computed with a pure-Python Philox: rate c
    is the 4-bit field c of call V·C, the keep the call's last word, the
    wipe coin and restart genes words 0 and 1 + v of calls 0 and 1 of
    generation 0xFFFFFFFF, and CLT4 Gaussian v of child c the integer sum
    of 24-bit fields 4v … 4v + 3 of calls 6c … 6c + 5 read as one bit
    string; and the stream's first values, pinned."""
    V, seed, step, g = 7, 20251017, 3, 5
    salt = torch.tensor([[0x1234567, 0x1234567, -5, -5]], dtype=torch.int32)
    draw_gen, wu, wg = philox_draw(seed, salt, V, C, keep=True)(step)
    noise, rates, keep = draw_gen(g)
    for lane in range(4):
        sl = int(salt[0, lane]) & _M32

        def words(gen, idx):
            return [w ^ sl for w in _philox_py((lane, step, gen, idx), (seed, 0))]

        rw = words(g, V * C)
        k = [(rw[c // 8] >> (4 * (c % 8))) & 15 for c in range(C)]
        assert rates[:, lane].tolist() == [2.0 ** (x - 23) for x in k]
        assert float(keep[0, lane]) == (rw[3] >> 8) / 2 ** 24
        ww = words(0xFFFFFFFF, 0) + words(0xFFFFFFFF, 1)
        assert float(wu[0, lane]) == (ww[0] >> 8) / 2 ** 24
        assert wg[:, lane].tolist() == [(x >> 8) / 2 ** 24 for x in ww[1:1 + V]]
        for c in (0, 9, 15):
            bits = 0
            for k in range(6):               # ceil(3V/4) calls per child
                for i, w in enumerate(words(g, 6 * c + k)):
                    bits |= w << (32 * (4 * k + i))
            for v in range(V):
                s = sum((bits >> (24 * f)) & 0xFFFFFF for f in range(4 * v, 4 * v + 4))
                x = (np.float32(s) * np.float32(2.0 ** -24) - np.float32(2.0)) \
                    * np.float32(math.sqrt(3.0))
                assert float(noise[v, c, lane]) == float(x)
    # the stream itself, lane 0
    assert (torch.log2(rates[:, 0]) + 23).round().long().tolist() == [
        10, 3, 7, 4, 6, 6, 10, 6, 9, 13, 0, 13, 2, 11, 15, 10]
    assert float(keep[0, 0]) == 0.6446987986564636
    assert float(wu[0, 0]) == 0.6403344869613647
    assert float(noise[0, 0, 0]) == -0.55475252866745
    assert philox_calls_per_lane_step(SpeciesParams(V=7, K=1)) == 778   # was 1 032


def test_rate_fields_are_uniform():
    """The 16 rate values 2^(k−23), k = 0..15, equally often over 524 288
    draws (4 096 lanes × 8 generations × 16 children: the rate call of
    each generation, draw V·C)."""
    lane = torch.arange(4096, dtype=torch.int64)[None]
    salt = lane // 2
    k = torch.cat([(torch.log2(rates_from_words(philox_words(
        5, lane, 0, g, torch.full((1, 1), 7 * C), salt), C)) + 23).round().long()
        .flatten() for g in range(8)])
    hist = torch.bincount(k, minlength=16).double()
    assert hist.numel() == 16 and int(hist.sum()) == 524288
    assert float((hist / hist.mean() - 1).abs().max()) < 0.03


def test_clt4_integer_sum_matches_the_float_formula():
    """The kernel's CLT4 sum (four 24-bit fields summed in integers, one
    conversion) against the float sum of the same four uniforms
    (gauss_from_u01): the sums within 2^-22, one ulp of [2, 4) (the float
    sum rounds up to three times, in [1, 2) by up to 2^-24 each); the
    Gaussians' mean and variance the same, and those of N(0, 1)."""
    w = [torch.as_tensor(x, dtype=torch.int64) for x in np.random.default_rng(3)
         .integers(0, 2 ** 32, size=(3, 1 << 20), dtype=np.uint64).astype(np.int64)]
    fields = packed_fields(w, 4)                  # four fields, three words
    gi = clt4_from_fields(fields)
    u = [x.to(torch.float32) * 2.0 ** -24 for x in fields]
    sf = u[0] + u[1] + u[2] + u[3]
    si = sum(fields).to(torch.float32) * 2.0 ** -24
    assert float((si - sf).abs().max()) <= 2.0 ** -22
    assert float((si == sf).float().mean()) > 0.5
    gf = gauss_from_u01(u).double()
    gi = gi.double()
    assert abs(float(gi.mean() - gf.mean())) < 1e-7
    assert abs(float(gi.var() - gf.var())) < 1e-6
    assert abs(float(gi.mean())) < 3e-3 and abs(float(gi.var()) - 1) < 5e-3


# ---- launch shape ---------------------------------------------------------


def quad_calls(V, q):
    """The Philox calls of a child that the wide layout's item for variables
    4q … 4q+3 makes (csrc/megastep_wide.cuh ``child_quad``: calls 3q … 3q+2
    of the child's ceil(3V/4)), and for each of those variables the three
    words of the child's stream its Gaussian's four 24-bit fields fill
    (words 3v … 3v+2: 96 bits)."""
    calls = [k for k in range(3 * q, 3 * q + 3) if k < clt4_calls(V)]
    words = {v: (3 * v, 3 * v + 1, 3 * v + 2) for v in range(4 * q, min(4 * q + 4, V))}
    return calls, words


@pytest.mark.parametrize("V", [7, 17, 30, 32])
def test_quad_items_make_each_call_once_and_give_the_packed_gaussians(V):
    """The wide layout's child items: (child c, quad q) for q < ceil(V/4),
    item i on thread i mod W.  Each of a child's ceil(3V/4) Philox calls is
    made by exactly one item, and the Gaussians an item forms from its
    twelve words (fields 4i … 4i+3 of them for variable 4q + i) are those
    of packed_fields and clt4_from_fields over the child's whole word
    string — philox_draw's, so the bits are unchanged."""
    nq = (V + 3) // 4
    made = []
    for q in range(nq):
        calls, words = quad_calls(V, q)
        made += calls
        assert all(w // 4 in calls for ws in words.values() for w in ws)
    assert sorted(made) == list(range(clt4_calls(V)))
    for W in (4, 8, 16, 32):        # the lane's calls of a generation over its threads
        owner = {}
        for it in range(C * nq):
            c, q = divmod(it, nq)
            for k in quad_calls(V, q)[0]:
                assert (c, k) not in owner
                owner[c, k] = it % W
        assert len(owner) == C * clt4_calls(V)
        assert max(owner.values()) < W
    n = 64
    lane = torch.arange(n, dtype=torch.int64)[None]
    salt = (torch.arange(n, dtype=torch.int64)[None] * 7919) & 0xFFFFFFFF
    nc = clt4_calls(V)
    for c in (0, 5, 15):
        idx = torch.arange(c * nc, (c + 1) * nc, dtype=torch.int64)[:, None]
        w = torch.stack(philox_words(3, lane, 1, 2, idx, salt), 1).reshape(4 * nc, n)
        f = packed_fields(list(w.unbind(0)), 4 * V)
        want = torch.stack([clt4_from_fields(f[4 * v:4 * v + 4]) for v in range(V)])
        for q in range(nq):
            calls, words = quad_calls(V, q)
            local = torch.cat([w[4 * k:4 * k + 4] for k in calls]
                              + [torch.zeros((12 - 4 * len(calls), n), dtype=w.dtype)])
            lf = packed_fields(list(local.unbind(0)), 16)
            for i, v in enumerate(sorted(words)):
                got = clt4_from_fields(lf[4 * i:4 * i + 4])
                assert torch.equal(got, want[v]), (V, c, v)


def test_wide_layout_bytes_by_hand():
    """The Python copy of wide_layout() (csrc/megastep_wide.cuh) at the
    prebuilt and generated instances, against the words counted by hand:
    block tables nlinks·(7 + 19 + 2) + V·(T + K) + K + K·V + 2K + T, then
    (128 / W) lanes of an odd number of words — 8V; the secondary rows the
    terms read (beta and gamma: beta, seed, gamma, mid, hspan, 5V; all four
    terms 8V); V + 7T; the children's block max(max(C, 13)·(V | 1),
    7·nlinks); 7·ncol; 7T; 12K; 14K; 7K; 2K; C with secondary terms; 8."""
    # the humanoid (30, 3, 3): 19 links, 22 columns
    block = 19 * 28 + 30 * 6 + 3 + 90 + 6 + 3                                # 814
    lane = 240 + 30 + 21 + 16 * 31 + 154 + 21 + 36 + 42 + 21 + 6 + 8         # 1075
    assert megastep_smem_bytes(30, 19, 1, 16, 16, 0, 22, 3, 3) == 4 * (block + lane * 8)
    lane_sec = lane + 150 + 16                                                # 1241
    assert megastep_smem_bytes(30, 19, 1, 16, 8, 6, 22, 3, 3) == 4 * (block + lane_sec * 16)
    # snake-32 (32, 1, 1): 34 links, 32 columns; an even count rounds up
    block = 34 * 28 + 32 * 2 + 1 + 32 + 2 + 1                                 # 1052
    lane = 256 + 32 + 7 + 16 * 33 + 224 + 7 + 12 + 14 + 7 + 2 + 8            # 1097
    assert megastep_smem_bytes(32, 34, 0, 16, 16, 0, 32, 1, 1) == 4 * (block + lane * 8)
    assert megastep_smem_bytes(32, 34, 0, 16, 8, 15, 32, 1, 1) == \
        4 * (block + (lane + 256 + 16) * 16)
    # the PR2 dual arm (17, 2, 2): 18 links, 16 columns
    block = 18 * 28 + 17 * 4 + 2 + 34 + 4 + 2                                 # 614
    lane = 136 + 17 + 14 + 16 * 17 + 112 + 14 + 24 + 28 + 14 + 4 + 8         # 643
    assert megastep_smem_bytes(17, 18, 0, 16, 8, 0, 16, 2, 2) == 4 * (block + lane * 16)
    # generated: the dual arm with the head (17, 3, 3), 20 links, 19
    # columns, with secondary terms; the humanoid's hands (30, 2, 2)
    block = 20 * 28 + 17 * 6 + 3 + 51 + 6 + 3                                 # 725
    lane = 136 + 85 + 17 + 21 + 16 * 17 + 133 + 21 + 36 + 42 + 21 + 6 + 16 + 8   # 814
    assert megastep_smem_bytes(17, 20, 0, 16, 8, 6, 19, 3, 3) == 4 * (block + 815 * 16)
    block = 17 * 28 + 30 * 4 + 2 + 60 + 4 + 2                                 # 664
    lane = 240 + 30 + 14 + 16 * 31 + 126 + 14 + 24 + 28 + 14 + 4 + 8         # 998
    assert megastep_smem_bytes(30, 17, 0, 16, 16, 0, 18, 2, 2) == 4 * (block + 999 * 8)
    # few children and a long chain: the frames (7·nlinks) size the block
    block = 40 * 28 + 7 * 2 + 1 + 7 + 2 + 1                                   # 1145
    lane = 56 + 7 + 7 + 280 + 49 + 7 + 12 + 14 + 7 + 2 + 8                    # 449
    assert megastep_smem_bytes(7, 40, 0, 4, 4, 0, 7, 1, 1) == 4 * (block + lane * 32)


def test_branch_slots_keep_only_non_adjacent_parents():
    tm = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"), device="cpu")
    mega = Megastep(tm, [TIP], list(range(7)), [0], SpeciesParams(V=7, K=1), 1)
    assert mega.nbranch == 0 and (mega._chain[0][:, 6] == -1).all()
    # rows: parent, jtype, src_kind, src_idx, tip_mask, pre_const
    li = np.array([[-1, 0, 3, 0, 0, 0], [0, 1, 1, 0, 1, 1], [1, 1, 1, 1, 1, 0],
                   [1, 1, 1, 2, 2, 0], [2, 0, 0, 0, 0, 0], [3, 0, 3, 0, 0, 0]])
    assert _branch_slots(li).tolist() == [-1, 0, 1, -1, -1, -1]


def test_group_rule_fills_the_card():
    """The G of least estimated time — rounds of resident blocks times the
    per-thread share of a lane-step — with the blocks an H100's 132 SMs hold
    of each instance (3 per SM for the pose-only kernel at G = 1, 2 at G > 1
    and for the secondary-goal kernel): the G each ladder launch ran fastest
    at on that card (PERF.md §6), and G > 1 where a launch fills less than
    the card."""
    pose = {g: (3 if g == 1 else 2) * 132 for g in MEGASTEP_GROUPS["megastep"]}
    sec = dict.fromkeys(MEGASTEP_GROUPS["megastep"], 2 * 132)
    main = [choose_group(n, pose) for n in (131072, 39320, 15728, 8384)]
    reg = [choose_group(n, sec) for n in (131072, 78640, 52424, 31456)]
    assert main == [1, 1, 2, 4] and reg == [1, 1, 1, 1]
    for res in (pose, sec):
        assert choose_group(4096, res, C=4) == 4 and choose_group(256, res) == 8
        assert choose_group(1 << 20, res) == 1


@pytest.mark.parametrize("path,lanes,blocks_per_sm,want", [
    ("pr2_dual_pose2", 32768, {4: 2, 8: 4, 16: 4}, 8),
    ("pr2_dual_multigoal", 131072, {4: 2, 8: 4, 16: 4}, 8),
    ("humanoid_whole_body", 32768, {8: 3, 16: 4}, 16),
    ("humanoid_whole_body_mm", 8192, {8: 3, 16: 4}, 16),
    ("snake32_position", 524288, {8: 3, 16: 4}, 8),
    ("shapes_main_ii_17x3x3", 32768, {4: 2, 8: 4, 16: 4}, 8),
    ("shapes_main_v_30x2x2", 32768, {8: 3, 16: 4}, 16),
    ("shapes_main_i_7x2x1", 131072, {4: 4, 8: 4}, 4),
    ("shapes_main_i_last", 8384, {4: 4, 8: 4}, 8),
    ("shapes_main_iv_7x1x1_second", 39320, {4: 4, 8: 4}, 4),
])
def test_width_rule_at_the_paths_launch_shapes(path, lanes, blocks_per_sm, want):
    """choose_width at each path's first launch (and the arm lookat
    ladder's last), with the blocks per SM an H100's 132 SMs hold of each
    instance's wide layout (shared memory, or the 128-register cap of 4
    blocks): the width that ran fastest there on that card (PERF.md §6)."""
    assert choose_width(lanes, {w: b * 132 for w, b in blocks_per_sm.items()}) == want
    with pytest.raises(ValueError, match="no group width fits"):
        choose_width(lanes, dict.fromkeys(blocks_per_sm, 0))


def test_tree_from_numpy_defaults_to_the_card():
    """interop.tree_from_numpy, like every entry point, runs on the card
    unless asked for the CPU: here, with no card, the default raises."""
    tree = {"a": np.zeros(3, np.float32), "b": [np.arange(2, dtype=np.uint32)]}
    cpu = tree_from_numpy(tree, "cpu")
    assert cpu["a"].device.type == "cpu" and cpu["b"][0].dtype == torch.int64
    if torch.cuda.is_available():
        assert tree_from_numpy(tree)["a"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tree_from_numpy(tree)


# ---- on the card ----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("sec_terms", [(), ("beta", "gamma")], ids=["pose", "sec"])
def test_cuda_group_sizes_give_the_same_lanes(sec_terms):
    """The kernel at every G equals G = 1 lane for lane in noise-tensor mode
    (the draws do not depend on G), and agrees with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    tm = RobotModel.from_urdf_file(asset_path("pr2_arm.urdf"))
    sp = SpeciesParams(V=7, K=1, C=16, gens=2, mem_iters=2)
    state, consts, noise = tree_from_numpy(
        megastep_inputs(tm, TIP, sp, 2, 2048, sec_terms=sec_terms), "cuda")
    mega = Megastep(tm, [TIP], list(range(7)), [0], sp, 2, sec_terms=sec_terms)
    kw = dict(noise=noise[0], rates=noise[1], wipe_u=noise[2], wipe_g=noise[3])
    if sec_terms:
        kw["keep"] = noise[4]
    outs = {G: mega(state, consts, group=G, **kw) for G in MEGASTEP_GROUPS["megastep"]}
    for G in MEGASTEP_GROUPS["megastep"][1:]:
        for a, b in zip(outs[G], outs[1]):
            assert torch.equal(a, b), G
    ref = mega.body(state, consts, array_draw(*noise[:4], sp.gens, keep=kw.get("keep")))
    torch.cuda.synchronize()
    assert lane_agreement(outs[1], ref).float().mean() >= 0.85
