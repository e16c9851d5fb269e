"""The launch plan and pair walk of the redesigned K8b, off the card.

csrc/gamma_pack.cu's pack_pairs takes one thread a (G, -G) pair, in sphere
order, and PACK_ROWS rows a thread (kernels/gamma_pack.py::pack_plan); the
threads past P take slot 0 and the padding slots. Here its walk is
mirrored in torch on the 2-atom Gamma deck and on random tables with
padding slots, block by block of its grid, with the kernel's operations
in its order, and held bitwise to box_to_packed_hx_plain in float64 and
float32 at a row count that ends on a half tile and at one row, every
packed slot of every row written exactly once; the plan is held to cover
its grid at the 2- and 54-atom shapes."""

from types import SimpleNamespace

import chip_smoke
import numpy as np
import pytest
import torch

from sirius_tpu_torch.kernels import gamma_pack as k8
from sirius_tpu_torch.ops.gamma import build_gamma_map, make_gamma_params
from sirius_tpu_torch.testing import synthetic_silicon_context
from sirius_tpu_torch.testing import threads_per_test_worker

# torch's intra-op threads: one share of the cores per test worker
torch.set_num_threads(threads_per_test_worker())

# the 2-atom Gamma parity deck (chip_smoke.py's GAMMA2, US + symmetry)
GAMMA2 = dict(gk_cutoff=6.0, pw_cutoff=20.0, ngridk=(1, 1, 1), ultrasoft=True,
              use_symmetry=True)
# the 54-atom cell's band-solve block: rows 2 nb, packed slots, pairs
FULL54 = (258, 26469, 13234)


@pytest.fixture(scope="module")
def gamma2():
    ctx = synthetic_silicon_context(**GAMMA2)
    gm = build_gamma_map(np.asarray(ctx.gkvec.millers[0]),
                         np.asarray(ctx.gkvec.mask[0]))
    return ctx, gm, tuple(ctx.fft_coarse.dims)


def inputs(gamma2, real, rows):
    """The deck's params at real, and a seeded packed block x [1, rows,
    ngk] and transformed box [1, rows, nbox]."""
    ctx, gm, dims = gamma2
    gp = make_gamma_params(ctx, np.zeros(dims), gm, device="cpu", dtype=real)
    rng = np.random.default_rng(11)
    ngk = gp.mask_p.shape[0]
    x = torch.as_tensor(rng.standard_normal((1, rows, ngk))).to(real)
    z = rng.standard_normal((2, 1, rows, int(np.prod(dims))))
    vbox = torch.complex(torch.as_tensor(z[0]), torch.as_tensor(z[1])).to(
        torch.complex128 if real == torch.float64 else torch.complex64)
    return gp, x, vbox


def walk_pairs(vbox, x, gp, plan):
    """hx, sx [B, R, ngk] as pack_pairs computes them under plan, block by
    block of its grid (thread j < P the pair j, thread P slot 0, the
    threads past P the padding slots, each over the rows of its tile), and
    how often each slot of each row was stored."""
    b, r, ngk = x.shape
    nrows, npair = b * r, gp.rep_box.shape[0]
    box = vbox.reshape(nrows, -1)
    xr = x.reshape(nrows, ngk)
    hx, sx = torch.zeros_like(xr), torch.zeros_like(xr)
    hits = torch.zeros((nrows, ngk), dtype=torch.int64)
    h = torch.tensor(k8.HALF_SQRT2, dtype=x.dtype)
    zero = torch.zeros((), dtype=x.dtype)

    def store(row, slots, vp, m, ek):
        # store_slot of csrc/gamma_pack.cu
        xm = xr[row, slots] * m
        hx[row, slots] = (ek * xm + vp) * m
        sx[row, slots] = xm * m
        hits[row, slots] += 1

    t = plan["rows_per_thread"]
    bx, by = plan["blocks"]
    for blk in range(bx):
        j = torch.arange(blk * plan["threads"], (blk + 1) * plan["threads"])
        j = j[j < ngk - npair]
        k, rest = j[j < npair], j[j >= npair]
        a, bslot = 1 + k, 1 + npair + k
        ma, mb = gp.mask_p[a], gp.mask_p[bslot]
        ea = torch.where(ma > 0, gp.ekin_p[a], zero)
        eb = torch.where(mb > 0, gp.ekin_p[bslot], zero)
        p = torch.where(rest == npair, 0, rest + npair)
        m = gp.mask_p[p]
        ek = torch.where(m > 0, gp.ekin_p[p], zero)
        for tile in range(by):
            for row in range(tile * t, min((tile + 1) * t, nrows)):
                u = box[row, gp.rep_box[k].long()]
                w = box[row, gp.par_box[k].long()]
                store(row, a, h * u.real + h * w.real, ma, ea)
                store(row, bslot, h * u.imag - h * w.imag, mb, eb)
                vp = torch.where(p == 0, box[row, gp.zero_box].real, zero)
                store(row, p, vp, m, ek)
    return hx.view(b, r, ngk), sx.view(b, r, ngk), hits


@pytest.mark.parametrize("one_row", [False, True])
@pytest.mark.parametrize("real", [torch.float64, torch.float32])
def test_pair_walk_is_bitwise_the_plain_version(gamma2, real, one_row):
    # 2 nb + 3 rows end on a half tile; one row is less than one tile
    rows = 1 if one_row else 2 * gamma2[0].num_bands + 3
    gp, x, vbox = inputs(gamma2, real, rows)
    rows, ngk = x.shape[1:]
    plan = k8.pack_plan(rows, ngk, gp.rep_box.shape[0])
    hx, sx, hits = walk_pairs(vbox, x, gp, plan)
    assert (hits == 1).all()
    want = k8.box_to_packed_hx_plain(vbox, x, gp.ekin_p, gp.mask_p, gp.rep_box,
                                     gp.par_box, gp.zero_box)
    assert torch.equal(hx, want[0]) and torch.equal(sx, want[1])


@pytest.mark.parametrize("rows", [5, 1])
@pytest.mark.parametrize("real", [torch.float64, torch.float32])
def test_pair_walk_covers_padding_slots(real, rows):
    # random tables with padding slots past 1 + 2P (mask 0), which the
    # Gamma decks here do not have, as chip_smoke.py's edge cases make
    # them: the threads past P store them once
    npair = 300
    vbox, x, tables = chip_smoke.synthetic_pack_tables(
        np.random.default_rng(12), rows, npair, 7, 4096, real, "cpu")
    gp = SimpleNamespace(**dict(zip(
        ("ekin_p", "mask_p", "rep_box", "par_box", "zero_box"), tables)))
    plan = k8.pack_plan(rows, x.shape[-1], npair)
    hx, sx, hits = walk_pairs(vbox, x, gp, plan)
    assert (hits == 1).all()
    want = k8.box_to_packed_hx_plain(vbox, x, *tables)
    assert torch.equal(hx, want[0]) and torch.equal(sx, want[1])
    assert not hx[..., 1 + 2 * npair:].any()


@pytest.mark.parametrize("rows,ngk,npair", [
    FULL54, (129, 26469, 13234), (28, 941, 470), (1, 941, 470), (3, 5, 2)])
def test_pack_plan_covers_the_grid(rows, ngk, npair):
    plan = k8.pack_plan(rows, ngk, npair)
    bx, by = plan["blocks"]
    tile = plan["rows_per_thread"]
    assert tile == k8.PACK_ROWS and plan["threads"] == k8.PACK_THREADS
    assert bx * plan["threads"] >= ngk - npair > (bx - 1) * plan["threads"]
    assert by * tile >= rows > (by - 1) * tile
