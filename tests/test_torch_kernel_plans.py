"""The launch plans of the redesigned K1c, K4 and K5 kernels, off the card.

csrc/veff_multiply.cu launches one block per (row, tile of 256 16-byte
vectors); kernels/augmentation.py::d_operator_plan sizes K5's grid and
csrc/augmentation.cu walks it. The index maps of the kernels are mirrored
here in numpy and held to cover every element of fr, and every G and every
(channel, atom, q) of D, exactly once, over shapes with odd row lengths,
views off a 16-byte boundary, tiny G counts, G below one tile and many
atoms. The multi-channel plain D operator is held to one call per channel
(bitwise: it is that loop).

K4's walk (rho_aug_plan's row tiles over the (G, -G) rows of gvec_pairs,
the q chunks 8, 4, 2, 1 and the atom tiles) is mirrored in numpy too, with
the one-thread-a-G kernel it replaced beside it: without fused
multiply-adds, and with phases whose sine is odd bit for bit (the premise
the card's sincospi is checked for), the walk writes every (channel, G)
once and gives the earlier kernel's bits, a zero's sign at most apart."""

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


def k4_phases(millers, pos):
    """(sin, cos) [ng, na] of -2 m . tau, the sine odd bit for bit."""
    m = millers.astype(np.float64)
    y = -2.0 * (m[:, None, 0] * pos[None, :, 0]
                + m[:, None, 1] * pos[None, :, 1]
                + m[:, None, 2] * pos[None, :, 2])
    return np.copysign(np.sin(np.pi * np.abs(y)), y), np.cos(np.pi * y)


def k4_one_thread_a_g(dmp, millers, pos, q):
    """The earlier K4: each G alone, q chunks of 8 summed over the atoms in
    order, each chunk then contracted into the running sum, q in order."""
    sn, cs = k4_phases(millers, pos)
    ns, na, nqlm = dmp.shape
    acc_re = np.zeros((ns, q.shape[1]))
    acc_im = np.zeros((ns, q.shape[1]))
    for j in range(nqlm):
        u_re = np.zeros_like(acc_re)
        u_im = np.zeros_like(acc_im)
        for a in range(na):
            u_re = u_re + cs[:, a] * dmp[:, a, j][:, None]
            u_im = u_im + sn[:, a] * dmp[:, a, j][:, None]
        acc_re = acc_re + (u_re * q[j].real - u_im * q[j].imag)
        acc_im = acc_im + (u_re * q[j].imag + u_im * q[j].real)
    return acc_re + 1j * acc_im


def k4_walk(dmp, millers, pos, q, pairs, plan, nblocks):
    """The redesigned K4 as csrc/augmentation.cu walks it: block b takes
    row tiles b, b + nblocks, ...; thread (s, k, r) row r of the tile on
    channel s and the q in [k nqlm / K, (k + 1) nqlm / K), K = ksplit, in
    chunks 8, 4, 2, 1 wide; the atoms in tiles of plan["atoms"], one chain;
    thread k > 0 hands its atom sums to k = 0 through shared memory, which
    contracts every q in order; -G from G's sums, the imaginary part
    negated. Returns the output and how often each (channel, G) was
    written."""
    ns, na, nqlm = dmp.shape
    ng = q.shape[1]
    tg, atoms, ks = plan["tg"], plan["atoms"], plan["ksplit"]
    nrow = pairs.shape[0]
    out = np.zeros((ns, ng), dtype=np.complex128)
    hits = np.zeros((ns, ng), dtype=np.int64)

    def width(left):
        return 8 if left >= 8 else 4 if left >= 4 else 2 if left >= 2 else 1

    def contract(acc, j, u_re, u_im, g, gp):
        qv, qp = q[j, g], q[j, gp]
        acc[0] = acc[0] + (u_re * qv.real - u_im * qv.imag)
        acc[1] = acc[1] + (u_re * qv.imag + u_im * qv.real)
        ui = -u_im
        acc[2] = acc[2] + (u_re * qp.real - ui * qp.imag)
        acc[3] = acc[3] + (u_re * qp.imag + ui * qp.real)

    for b in range(nblocks):
        for tile in range(b, -(-nrow // tg), nblocks):
            rows = np.arange(tile * tg, min(tile * tg + tg, nrow))
            g, gp = pairs[rows, 0], pairs[rows, 1]
            sn, cs = k4_phases(millers[g], pos)
            acc = np.zeros((4, ns, len(rows)))  # re, im of G; of -G
            ubuf = {}  # q -> the atom sums thread k > 0 hands over
            for k in range(ks):
                q0, qhi = k * nqlm // ks, (k + 1) * nqlm // ks
                while q0 < qhi:
                    nq = width(qhi - q0)
                    u_re = np.zeros((nq, ns, len(rows)))
                    u_im = np.zeros((nq, ns, len(rows)))
                    for a0 in range(0, na, atoms):
                        for a in range(a0, min(a0 + atoms, na)):
                            for j in range(nq):
                                c = dmp[:, a, q0 + j][:, None]
                                u_re[j] = u_re[j] + cs[:, a] * c
                                u_im[j] = u_im[j] + sn[:, a] * c
                    for j in range(nq):
                        if k == 0:
                            contract(acc, q0 + j, u_re[j], u_im[j], g, gp)
                        else:
                            ubuf[q0 + j] = (u_re[j], u_im[j])
                    q0 += nq
            for j in sorted(ubuf):
                contract(acc, j, *ubuf[j], g, gp)
            out[:, g] = acc[0] + 1j * acc[1]
            hits[:, g] += 1
            other = gp != g
            out[:, gp[other]] = acc[2][:, other] + 1j * acc[3][:, other]
            hits[:, gp[other]] += 1
    return out, hits


def symmetric_millers(rng, ng):
    """ng (odd) distinct Millers closed under G -> -G, G = 0 among them."""
    half = rng.choice(6 ** 3, (ng - 1) // 2, replace=False)
    m = np.stack(np.unravel_index(half, (6, 6, 6)), 1) + [1, -2, -2]
    m = rng.permutation(np.concatenate([m, -m, np.zeros((1, 3), int)]))
    return m.astype(np.int32)


@pytest.mark.parametrize("ns,nqlm,na,ng,atoms,ksplit", [
    (1, 10, 7, 41, None, 1), (1, 10, 7, 41, None, 2),
    (2, 10, 16, 301, None, 2), (4, 10, 5, 201, None, 1),
    (1, 3, 4, 101, None, 2), (2, 15, 3, 101, None, 2),
    (1, 10, 9, 101, 4, 1), (4, 3, 11, 61, 2, 1), (1, 10, 54, 101, None, None)])
def test_k4_walk_writes_once_and_keeps_the_earlier_bits(ns, nqlm, na, ng,
                                                        atoms, ksplit):
    rng = np.random.default_rng(ng + 7 * nqlm + ns)
    millers = symmetric_millers(rng, ng)
    pos = rng.uniform(0.0, 1.0, (na, 3))
    # one exact zero coefficient: a chain of zero terms must stay harmless
    dmp = rng.standard_normal((ns, na, nqlm))
    dmp[0, :, 0] = 0.0
    q = rng.standard_normal((nqlm, ng)) + 1j * rng.standard_normal((nqlm, ng))
    pairs = k45.gvec_pairs(millers).numpy()
    plan = dict(k45.rho_aug_plan(na, nqlm, ns, pairs.shape[0]))
    if atoms is not None:  # force atom tiles
        plan["atoms"] = atoms
    if ksplit is not None:  # force the q split
        plan["ksplit"] = ksplit
    got, hits = k4_walk(dmp, millers, pos, q, pairs, plan, nblocks=3)
    assert (hits == 1).all()
    want = k4_one_thread_a_g(dmp, millers, pos, q)
    x = got.view(np.float64)
    y = want.view(np.float64)
    differ = x.view(np.int64) != y.view(np.int64)
    assert not (differ & ~((x == 0.0) & (y == 0.0))).any()
