"""The launch plans of the redesigned K1c and K5 kernels, off the card.

csrc/veff_multiply.cu launches one block per (row, tile of 256 16-byte
vectors); kernels/augmentation.py::d_operator_plan sizes K5's grid and
csrc/augmentation.cu walks it. The index maps of the kernels are mirrored
here in numpy and held to cover every element of fr, and every G and every
(channel, atom, q) of D, exactly once, over shapes with odd row lengths,
views off a 16-byte boundary, tiny G counts, G below one tile and many
atoms. The multi-channel plain D operator is held to one call per channel
(bitwise: it is that loop)."""

import itertools

import numpy as np
import pytest
import torch

from sirius_tpu_torch.kernels import augmentation as k45
from sirius_tpu_torch.testing import threads_per_test_worker

# torch's intra-op threads: one share of the cores per test worker
torch.set_num_threads(threads_per_test_worker())

SM = 132  # an H100's SMs
K1C_THREADS = 256  # 16-byte vectors a block of csrc/veff_multiply.cu


def k1c_hits(nbatch, r_per_b, n, element_bytes, offset):
    """How often the kernel's threads touch each element of fr
    [nbatch, r_per_b, n] laid out `offset` elements past a 16-byte
    boundary, as csrc/veff_multiply.cu launches it: block = row * coltiles
    + tile, per row the 16-byte vectors from its first boundary, and the
    scalar head and tail taken by vector column 0."""
    epv = 16 // element_bytes
    coltiles = -(-max(n // epv, 1) // K1C_THREADS)
    hits = np.zeros((nbatch * r_per_b, n), dtype=np.int64)
    cols = np.arange(K1C_THREADS)
    for block in range(coltiles * nbatch * r_per_b):
        row = block // coltiles
        v = (block - row * coltiles) * K1C_THREADS + cols
        h = ((offset + row * n) * element_bytes % 16) // element_bytes
        nv = (n - h) // epv
        vv = v[v < nv]
        for k in range(epv):
            np.add.at(hits[row], h + epv * vv + k, 1)
        if block == row * coltiles:  # vector column 0's head and tail
            if h:
                hits[row, 0] += 1
            if h + nv * epv < n:
                hits[row, h + nv * epv] += 1
    return hits


@pytest.mark.parametrize("element_bytes,offset", [(16, 0), (8, 0), (8, 1)])
@pytest.mark.parametrize("r_per_b", [1, 8, 11])
@pytest.mark.parametrize("n", [1, 2, 3, 27, 512, 1025])
def test_veff_multiply_plan_covers_every_element_once(n, r_per_b,
                                                      element_bytes, offset):
    hits = k1c_hits(3, r_per_b, n, element_bytes, offset)
    assert (hits == 1).all()


PLAN_SHAPES = [(1, 10, 1, 1), (2, 1, 1, 64), (3, 10, 1, 37), (7, 10, 1, 10007),
               (7, 10, 2, 10007), (7, 10, 4, 10007), (16, 10, 1, 291693),
               (16, 10, 2, 291693), (16, 10, 4, 291693), (54, 10, 1, 984161),
               (54, 10, 2, 984161), (135, 10, 4, 2003), (600, 10, 1, 2003),
               (5, 36, 2, 999), (7, 171, 4, 1000)]


@pytest.mark.parametrize("na,nqlm,nch,ng", PLAN_SHAPES)
def test_d_operator_plan_covers_every_g_and_output_once(na, nqlm, nch, ng):
    plan = k45.d_operator_plan(na, nqlm, nch, ng, SM)
    tg, group, chunk = plan["tg"], plan["group"], plan["chunk"]
    assert tg in k45.G_TILES and tg % 4 == 0 and chunk % tg == 0
    assert k45.THREADS % tg == 0
    # the atom groups of the launches
    assert 1 <= group <= na and plan["ngroups"] == -(-na // group)
    sizes = [min(group, na - a0) for a0 in range(0, na, group)]
    assert sum(sizes) == na
    # the blocks' chunks and their tiles: every G once
    g_hits = np.zeros(ng, dtype=np.int64)
    for blk in range(plan["nblocks"]):
        gbeg, gend = blk * chunk, min(blk * chunk + chunk, ng)
        assert gend > gbeg  # no block without G
        for it in range(-(-(gend - gbeg) // tg)):
            g0 = gbeg + it * tg
            g_hits[g0:min(g0 + tg, gend)] += 1
    assert (g_hits == 1).all()
    # each launch's threads: every (row, q) of its output, row = (channel,
    # atom), and every G of a tile, once
    for size in set(sizes):
        lay = k45.d_operator_layout(size, nqlm, nch, tg)
        assert lay["shared"] <= k45.SHARED_MAX
        ntile = lay["out_tiles"]
        assert ntile <= k45.THREADS
        lanes = k45.THREADS // ntile
        mgn = -(-(nch * size) // k45.TM)
        qgn = ntile // mgn
        hits = np.zeros((mgn * k45.TM, qgn * k45.TN, tg), dtype=np.int64)
        for t in range(ntile * lanes):
            # tile (mg, qg) owns rows mg + i mgn and q qg + j qgn
            u, lane = t % ntile, t // ntile
            mg, qg = u % mgn, u // mgn
            for i, j in itertools.product(range(k45.TM), range(k45.TN)):
                hits[mg + i * mgn, qg + j * qgn, lane::lanes] += 1
        assert (hits == 1).all()
        # pass 2: one warp a (channel, atom, q)
        rows, qs = np.divmod(np.arange(nch * size * nqlm), nqlm)
        chan, atom = np.divmod(rows, size)
        assert len(set(zip(chan, atom, qs))) == nch * size * nqlm
    if plan["blocks_per_sm"] == k45.BLOCKS_PER_SM:
        assert k45.BLOCKS_PER_SM * (plan["shared"] + 1024) <= k45.SHARED_SM


def test_d_operator_plan_fills_the_card_at_full_width():
    # split-K over G: two or three blocks an SM at the 16- and 54-atom
    # cells, all atoms and channels in one launch
    for na, nch, ng in ((16, 1, 291693), (16, 4, 291693), (54, 1, 984161),
                        (54, 2, 984161)):
        plan = k45.d_operator_plan(na, 10, nch, ng, SM)
        bps = plan["blocks_per_sm"]
        assert plan["ngroups"] == 1 and bps in (2, 3)
        assert 0.9 * SM * bps <= plan["nblocks"] <= SM * bps


def _tables(rng, na, ng):
    xi1, xi2 = np.triu_indices(3)
    nbeta = 3 * na
    off = 3 * np.arange(na)[:, None]
    q = rng.standard_normal((6, ng)) + 1j * rng.standard_normal((6, ng))
    t = torch.as_tensor
    tables = (t(rng.integers(-6, 7, (ng, 3)), dtype=torch.int32),
              t(rng.uniform(0.0, 1.0, (na, 3))), t(q),
              t((off + xi1) * nbeta + off + xi2, dtype=torch.int32),
              t((off + xi2) * nbeta + off + xi1, dtype=torch.int32),
              t((xi1 != xi2).astype(np.float64)))
    return tables, nbeta


@pytest.mark.parametrize("nch", [1, 2, 4])
def test_multichannel_d_operator_plain_is_one_call_per_channel(nch):
    rng = np.random.default_rng(5 + nch)
    ng, na = 301, 3
    tables, nbeta = _tables(rng, na, ng)
    v = torch.as_tensor(rng.standard_normal((nch, ng))
                        + 1j * rng.standard_normal((nch, ng)))
    d0 = torch.as_tensor(rng.standard_normal((nch, nbeta, nbeta)))
    got = k45.d_operator(v, *tables, 0.9, d0.clone())
    assert got.shape == (nch, nbeta, nbeta)
    for c in range(nch):
        want = k45.d_operator(v[c:c + 1], *tables, 0.9, d0[c:c + 1].clone())
        assert torch.equal(got[c:c + 1], want)
    assert not torch.equal(got, d0)
    assert k45.d_operator.launches == 0
