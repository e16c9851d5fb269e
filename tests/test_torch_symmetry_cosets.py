"""The factorised K6 and K2's cluster plan, off the card.

On the card K6 (kernels/symmetrize_pw.py) sums one op of each rotation over
the G where the character sum over the pure translations T does not vanish,
and divides by the representatives' count; its plain version sums every op
over every G. Here the host tables (build_cosets) are held to the group's
structure at the 2-, 16- and 54-atom cells and at magnetic groups, a torch
mirror of the kernel's index map is held to the plain version, and an op
list that is no group is refused. K2's plan (davidson_residual_plan) is held
to one block a row at every 2-atom shape and a cluster a row at full width,
and a numpy mirror of its cluster kernel's index map to cover every element
once within the shared-memory budget."""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from sirius_tpu_torch.dft.density import build_sym_pw_tables
from sirius_tpu_torch.kernels import davidson_residual as k2
from sirius_tpu_torch.kernels import symmetrize_pw as k6
from sirius_tpu_torch.testing import (synthetic_silicon_context,
                                      threads_per_test_worker)

# torch's intra-op threads: one share of the cores per test worker
torch.set_num_threads(threads_per_test_worker())

SMALL = dict(gk_cutoff=3.5, pw_cutoff=9.0)
SM = 132  # an H100's SMs
# the relative normwise gap of the factorised sum to the plain one: both
# sum the same terms, in another order and with |T| phases fewer
FACTOR_TOL = 1e-13


def group_tables(ctx):
    """The numpy tables build_sym_pw_tables gives build_cosets."""
    ops = ctx.symmetry.ops
    rot = np.stack([np.rint(np.linalg.inv(op.w_k)).astype(np.int32)
                    for op in ops])
    trans = np.stack([op.t for op in ops]).astype(np.float64)
    sign = np.array([op.spin_sign for op in ops], dtype=np.float64)
    srot = np.stack([np.linalg.det(op.rot_cart) * op.rot_cart for op in ops])
    return np.asarray(ctx.gvec.millers, dtype=np.int32), rot, trans, sign, srot


_CONTEXTS = {}


def context(name):
    """The cells of these tests, built once a worker."""
    if name not in _CONTEXTS:
        if name == "fm16":
            # the 16-atom cell with +0.5 along z on every atom
            ctx = chip_smoke.magnetic_supercell_context(
                2, dict(SMALL, ngridk=(1, 1, 1)), chip_smoke.SPIN,
                chip_smoke.US_SYM, 0.5)
        elif name == "canted16":
            # the 16-atom non-collinear cell of the full-width spinor run
            ctx = chip_smoke.magnetic_supercell_context(
                2, dict(SMALL, ngridk=(1, 1, 1)), chip_smoke.NONCOLLINEAR,
                chip_smoke.US_SYM, chip_smoke.CANTED[0])
        elif name == "afm2":
            ctx = chip_smoke.xc_context("pw_us_sym_afm")
        else:
            ctx = synthetic_silicon_context(**CELLS[name])
        _CONTEXTS[name] = ctx
    return _CONTEXTS[name]


CELLS = {"si2": {}, "si16": dict(supercell=2), "si2_small": SMALL,
         "si16_small": dict(SMALL, supercell=2),
         "si54_small": dict(SMALL, supercell=3)}


@pytest.mark.parametrize("name,nops,translations", [
    ("si2_small", 48, 1), ("si16_small", 384, 8), ("si54_small", 1296, 27),
    ("afm2", 8, 1), ("fm16", 64, 8), ("canted16", 48, 8)])
def test_ops_split_into_rotation_classes(name, nops, translations):
    millers, rot, trans, sign, srot = group_tables(context(name))
    assert len(rot) == nops
    reps, tops = k6.factor_translations(rot, trans, sign)
    assert len(tops) == translations
    assert len(reps) * translations == nops
    # one representative a rotation, the first of its class in index order
    assert len({rot[i].tobytes() for i in reps}) == len(reps)
    assert list(reps) == sorted(reps)
    for i in range(nops):
        first = next(j for j in range(nops) if np.array_equal(rot[j], rot[i]))
        assert first in reps
    assert (rot[tops] == np.eye(3, dtype=np.int32)).all()


@pytest.mark.parametrize("name,want", [("si2", None), ("si16", 36325)])
def test_live_g_are_the_primitive_cells(name, want):
    # at the 2-atom cell every G is live; at the 16-atom cell the live G
    # are the primitive cell's G set (that of the 2-atom cell)
    ctx = context(name)
    cos = k6.build_cosets(*group_tables(ctx), "cpu")
    ng = ctx.gvec.num_gvec
    want = ng if want is None else want
    assert want == context("si2").gvec.num_gvec
    for live in (cos.live, cos.live_axial):
        assert live.dtype == torch.int32 and live.shape == (want,)
        assert bool((live[1:] > live[:-1]).all())


@pytest.mark.parametrize("name", ["si2_small", "afm2"])
def test_a_group_without_translations_is_every_op_over_every_g(name):
    # the kernel then sums what the unfactorised kernel summed, in order
    ctx = context(name)
    tb = build_sym_pw_tables(ctx, "cpu")
    cos = tb.cosets
    assert cos.num_translations == 1 and cos.num_reps == tb.num_ops
    for got, want in ((cos.rot, tb.rot), (cos.trans, tb.trans),
                      (cos.sign, tb.sign), (cos.srot, tb.srot)):
        assert torch.equal(got, want)
    every = torch.arange(ctx.gvec.num_gvec, dtype=torch.int32)
    assert torch.equal(cos.live, every) and torch.equal(cos.live_axial, every)


def factorised(f, tb, cos, axial=False, vector=False):
    """A torch mirror of the kernel's index map: the representatives in
    order over the live G, divided by their count; 0 at every other G."""
    live = (cos.live_axial if axial else cos.live).long()
    m = tb.millers.long()[live]
    mf = m.to(torch.float64)
    acc = torch.zeros(f.shape[:-1] + (live.shape[0],), dtype=f.dtype)
    for r in range(cos.num_reps):
        g, _ = k6.source_index(m, cos.rot[r], tb.lut, tb.dims)
        x = mf @ cos.trans[r]
        phase = torch.polar(torch.ones_like(x), -2.0 * math.pi
                            * (x - torch.round(x)))
        if axial:
            phase = phase * cos.sign[r]
        acc += ((cos.srot[r].to(f.dtype) @ f[:, g]) if vector else f[g]) * phase
    out = torch.zeros_like(f)
    out[..., live] = acc / cos.num_reps
    return out


def spin_flip_translations(tables):
    """The 16-atom group with a spin sign that flips under half the pure
    translations: s = (-1)^(2 T_x) on T = {0, 1/2}^3, each op the sign of
    its translation from its representative. The axial character then
    differs from the scalar one."""
    millers, rot, trans, _, srot = tables
    sign = np.ones(len(rot))
    reps, tops = k6.factor_translations(rot, trans, sign)
    cls = {rot[r].tobytes(): r for r in reps}
    for i in range(len(rot)):
        d = trans[i] - trans[cls[rot[i].tobytes()]]
        sign[i] = -1.0 if round(2 * (d[0] % 1.0)) % 2 else 1.0
    return millers, rot, trans, sign, srot


def tables_with(ctx, flip=False):
    tb = build_sym_pw_tables(ctx, "cpu")
    if flip:
        millers, rot, trans, sign, srot = spin_flip_translations(
            group_tables(ctx))
        tb.sign = torch.as_tensor(sign)
        tb.cosets = k6.build_cosets(millers, rot, trans, sign, srot, "cpu")
    return tb


@pytest.mark.parametrize("form", ["scalar", "axial", "vector"])
@pytest.mark.parametrize("name,flip", [
    ("si2_small", False), ("si16_small", False), ("afm2", False),
    ("fm16", False), ("canted16", False), ("si16_small", True),
    pytest.param("si54_small", False, marks=pytest.mark.slow)])
def test_factorised_sum_is_the_plain_sum(name, flip, form):
    ctx = context(name)
    tb = tables_with(ctx, flip)
    ng = ctx.gvec.num_gvec
    rng = np.random.default_rng(17)
    shape = (3, ng) if form == "vector" else (ng,)
    f = torch.as_tensor(rng.standard_normal(shape)
                        + 1j * rng.standard_normal(shape))
    axial, vector = form == "axial", form == "vector"
    base = (tb.millers, tb.lut, tb.rot, tb.trans)
    if vector:
        want = k6.symmetrize_vector_pw_plain(f, *base, tb.srot, tb.dims)
    else:
        want = k6.symmetrize_pw_plain(f, *base, tb.dims,
                                      tb.sign if axial else None)
    got = factorised(f, tb, tb.cosets, axial, vector)
    norm = float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))
    assert norm <= FACTOR_TOL
    live = tb.cosets.live_axial if axial else tb.cosets.live
    dead = torch.ones(ng, dtype=torch.bool)
    dead[live.long()] = False
    assert bool((got[..., dead] == 0).all())
    # the plain sum vanishes there to rounding
    if bool(dead.any()):
        assert float(want[..., dead].abs().max()) <= (
            FACTOR_TOL * float(want.abs().max()))
    if flip:
        assert not torch.equal(tb.cosets.live, tb.cosets.live_axial)


@pytest.mark.parametrize("drop", [0, 3, 200, 383])
def test_an_op_list_that_is_no_group_is_refused(drop):
    # one op removed from the 16-atom group: its class (or, for a pure
    # translation, every other class) no longer has |T| ops
    millers, rot, trans, sign, srot = group_tables(context("si16_small"))
    keep = np.arange(len(rot)) != drop
    with pytest.raises(ValueError, match="symmetry op|no identity"):
        k6.build_cosets(millers, rot[keep], trans[keep], sign[keep],
                        srot[keep], "cpu")


def test_a_spin_sign_off_its_coset_is_refused():
    millers, rot, trans, sign, srot = group_tables(context("si16_small"))
    sign = sign.copy()
    reps, _ = k6.factor_translations(rot, trans, sign)
    op = next(i for i in range(len(rot)) if i not in set(reps))
    sign[op] = -sign[op]
    with pytest.raises(ValueError, match=f"symmetry op {op}: spin sign"):
        k6.build_cosets(millers, rot, trans, sign, srot, "cpu")


def test_chip_smoke_records_the_factorisation(monkeypatch, capsys):
    # the 54-atom K6 record's phase on a small supercell, on the CPU (the
    # plain version against itself): the factorisation, the factorised
    # work's bound beside the unfactorised sum's, the random field's check,
    # and the yardstick's size instead of its time
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    rec = chip_smoke.check_kernel_symmetrize(
        "si16_small", context("si16_small"), torch.device("cpu"),
        "cpu")["symmetrize_pw"]
    assert (rec["num_ops"], rec["num_translations"], rec["num_reps"]) == (
        384, 8, 48)
    assert rec["num_live"] < rec["num_gvec"]
    assert rec["bound_ms_unfactorised"] > rec["bound_ms"] > 0
    assert rec["library_ms"] is None and "not built" in rec["library"]
    assert rec["random_rel_err"] == 0.0
    assert rec["random_plain_max_off_live"] <= 1e-13


# K2: (rows, ngk, element bytes) of the 2-atom decks' band solves: the
# k-point decks (up to 8 k-points x 14 bands of ngk_max 982), the Gamma
# packed-real ones (941), the spinor ones ([nb, 2 ngk] rows), each in fp64
# and fp32
TWO_ATOM = [(8 * 14, 982, 16), (3 * 14, 982, 8), (14, 941, 8), (14, 941, 4),
            (8 * 28, 2 * 982, 16), (8 * 28, 2 * 982, 8), (16, 2 * 400, 16)]
# the full-width shapes: 54 atoms packed real f64 / f32, 16 atoms US
# complex128 / complex64, 16 atoms NC, the 16-atom spinor rows
FULL_WIDTH = [(129, 26469, 8, 8), (129, 26469, 4, 8), (126, 7880, 16, 8),
              (126, 7880, 8, 2), (336, 7880, 16, 8), (336, 15760, 16, 8)]


@pytest.mark.parametrize("nrows,ngk,eb", TWO_ATOM)
def test_residual_plan_takes_a_block_a_row_at_two_atoms(nrows, ngk, eb):
    plan = k2.davidson_residual_plan(nrows, ngk, eb, SM)
    assert plan["cluster"] == 1 and plan["blocks"] == nrows


@pytest.mark.parametrize("nrows,ngk,eb,want", FULL_WIDTH)
def test_residual_plan_clusters_rows_at_full_width(nrows, ngk, eb, want):
    plan = k2.davidson_residual_plan(nrows, ngk, eb, SM)
    assert plan["cluster"] == want
    assert plan["blocks"] >= SM


def test_residual_plan_takes_waves_into_account():
    # a row no cluster's slices fit: one block a row
    assert k2.davidson_residual_plan(10, 40000, 16, SM)["cluster"] == 1
    # rows whose smallest fitting cluster runs in one wave take it (here 4:
    # a cluster of 2 gives a block 192 KB), more rows the largest
    assert k2.davidson_residual_plan(4, 8000, 16, SM)["cluster"] == 4
    assert k2.davidson_residual_plan(400, 8000, 16, SM)["cluster"] == 8


def cluster_hits(nrows, ngk, eb, plan):
    """How often csrc/davidson_residual.cu's cluster kernel touches each
    element of each row: its copies to shared memory (passes 1 and 2 read
    only those) and its stores of w (a scalar head up to the slice's first
    16-byte boundary of w, whose base is on one, 16-byte vectors, a scalar
    tail)."""
    c, sl = plan["cluster"], plan["slice"]
    epv = 16 // eb
    copied = np.zeros((nrows, ngk), dtype=np.int64)
    stored = np.zeros((nrows, ngk), dtype=np.int64)
    threads = np.arange(k2.THREADS)
    for block in range(nrows * c):
        row, rank = divmod(block, c)
        lo = rank * sl
        n = max(0, min(ngk, lo + sl) - lo)
        for i0 in range(0, n, k2.THREADS):
            i = i0 + threads[threads < n - i0]
            copied[row, lo + i] += 1
        off = row * ngk + lo
        head = min(n, (epv - off % epv) % epv)
        nvec = (n - head) // epv
        for v in range(nvec):
            start = off + head + v * epv
            assert start % epv == 0  # a 16-byte store
            stored[row, lo + head + v * epv:lo + head + (v + 1) * epv] += 1
        rest = head + nvec * epv
        for i in range(head + n - rest):
            j = i if i < head else rest + i - head
            stored[row, lo + j] += 1
    return copied, stored


@pytest.mark.parametrize("nrows,ngk,eb", [(3, 4099, 8), (5, 2051, 16),
                                          (4, 8195, 4), (7, 4097, 8),
                                          (2, 26469, 8), (2, 7880, 16)])
def test_residual_cluster_map_covers_every_element_once(nrows, ngk, eb):
    plan = k2.davidson_residual_plan(nrows, ngk, eb, SM)
    assert plan["cluster"] > 1
    assert plan["shared"] == 3 * plan["slice"] * eb <= k2.SLICE_BUDGET
    assert k2.BLOCKS_PER_SM * (plan["shared"] + k2.STATIC_SHARED
                               + k2.BLOCK_RESERVED) <= k2.SHARED_SM
    copied, stored = cluster_hits(nrows, ngk, eb, plan)
    assert (copied == 1).all() and (stored == 1).all()
