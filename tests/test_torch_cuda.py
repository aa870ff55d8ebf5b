"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports nothing of JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips (the kernels have no CPU mode).
Integer outputs are bit-equal; histograms bit-equal on dyadic g, h; the
ensemble sum, taken in another order, to rtol 1e-5.  Each class-batched
kernel is held against its plain version at K = 1 and K > 1, and each
kernel that reads 4-bit ``PackedCodes`` also against its uint8 twin.
The split-search kernel's decisions, and its fold into the tree tables,
are bit-equal to the plain version on dyadic histograms, eagerly and
replayed from a CUDA graph.
The training variants (histogram subtraction, the lossguide grower, the
host split offload, GOSS, fused rounds as CUDA graphs) are held against
their direct or host-loop counterparts on the card and against the CPU.
Missing values, 40-category fields and squared error
(``tests/test_torch_mixed_fields.py``) hold against the float64 reference
on the card as on the CPU.
The out-of-core path: a chunk binned on the card equals the host's codes,
the pinned upload ring delivers every chunk intact, the chunked grower
equals the in-memory one on exact-grid statistics, and a stream (with an
OOM halving) holds the stream's contract against the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.api.plan import ExecutionPlan
from repro_torch.core import binning, gbdt, splits
from repro_torch.core import tree as tree_mod
from repro_torch.core.binning import PackedCodes
from repro_torch.data import make_tabular
from repro_torch.kernels import _build, ref
from repro_torch.kernels import histogram as hist_k
from repro_torch.kernels import partition as part_k
from repro_torch.kernels import traversal as trav_k

import test_torch_mixed_fields as mixed_fields

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _codes(n, C, n_bins, rng):
    codes = rng.integers(0, n_bins, (n, C)).astype(np.uint8)
    codes[rng.uniform(size=codes.shape) < 0.1] = n_bins - 1
    return codes


def _trees(T, depth, C, n_bins, rng, device):
    n_int = 2 ** depth - 1
    return ref.TreeArrays(*[torch.from_numpy(a).to(device) for a in (
        rng.integers(-1, C, (T, n_int)).astype(np.int32),
        rng.integers(0, n_bins - 1, (T, n_int)).astype(np.int32),
        rng.integers(0, 2, (T, n_int)).astype(np.int32),
        rng.integers(0, 2, (T, n_int)).astype(np.int32),
        rng.normal(size=(T, 2 ** depth)).astype(np.float32))])


def _edge_trees(depth, C, n_bins, rng, device):
    """Trees whose roots take every decoded form's edge, each root seeing
    every record: numeric roots at every threshold from 0 to the missing
    bin's (n_bins - 1) and one past it, missing codes going left and
    right; categorical roots at code 0 and at the top value bin, both
    ways; pass-through roots; two padding trees (every node feature -1,
    zero leaves).  Deeper nodes are drawn as ``_trees`` draws them."""
    mb = n_bins - 1
    roots = [(f, t, 0, dl) for t in range(mb + 1) for f, dl in
             ((t % C, t % 2), ((t + 1) % C, 1 - t % 2))]
    roots += [(f, t, 1, dl) for t in (0, mb - 1) for dl in (0, 1)
              for f in (0, C - 1)]
    roots += [(-1, 0, 0, 0), (-1, mb, 1, 1)]
    trees = _trees(len(roots) + 2, depth, C, n_bins, rng, "cpu")
    for i, root in enumerate(roots):
        for a, v in zip(trees[:4], root):
            a[i, 0] = v
    for a in trees[:4]:
        a[len(roots):] = -1 if a is trees.feature else 0
    trees.leaf_value[len(roots):] = 0.0
    return ref.TreeArrays(*[a.to(device) for a in trees])


def _edge_codes(n, C, n_bins, rng):
    """Codes in which every field takes every code, the missing bin (the
    last) among them."""
    return np.stack([rng.permutation(n) % n_bins for _ in range(C)],
                    1).astype(np.uint8)


def _layout(layout, n, F, NB, NN, shape, rng):
    """Codes and node ids of one test layout: ``random`` (10 % missing,
    nodes uniform), ``two`` (every code on bins 0-1, as two-category fields
    put them: many records of one code, merged before they are added),
    ``one_slot`` (every record in the last node, the others empty),
    ``sparse`` (even nodes only: every other slot empty) or ``outside``
    (codes on all 256 byte values and node ids in [-1, NN]: the kernels
    skip codes >= NB and nodes outside [0, NN))."""
    codes = _codes(n, F, NB, rng)
    if layout == "two":
        codes = rng.integers(0, 2, (n, F)).astype(np.uint8)
    elif layout == "outside":
        codes = rng.integers(0, 256, (n, F)).astype(np.uint8)
    nid = rng.integers(0, NN, shape).astype(np.int32)
    if layout == "one_slot":
        nid[:] = NN - 1
    elif layout == "sparse":
        nid -= nid % 2
    elif layout == "outside":
        nid = rng.integers(-1, NN + 1, shape).astype(np.int32)
    return codes, nid


def _plain_in_range(codes, g, h, nid, NN, NB):
    """The plain histogram of the records of a node in [0, NN) and of the
    codes < NB, which is what the kernels add (the plain version itself
    takes only those)."""
    ok = (nid >= 0) & (nid < NN)
    return hist_k.histogram_plain(
        codes, torch.where(ok, g, 0.0), torch.where(ok, h, 0.0),
        torch.where(ok, nid, 0), NN, 256)[..., :NB, :]


@pytest.mark.parametrize("n,F,NB,NN,layout", [
    (64, 3, 8, 1, "random"), (777, 13, 16, 4, "random"),
    (5000, 28, 256, 32, "random"), (5000, 28, 256, 512, "random"),
    # one slot: no sort, the list is the identity
    (5000, 28, 256, 1, "random"), (3000, 28, 256, 1, "two"),
    # two-category codes; empty slots; one slot holding every record
    (5000, 28, 256, 32, "two"), (4000, 28, 256, 32, "sparse"),
    (4000, 28, 256, 32, "one_slot"),
    # F > 32 and not a multiple of 32: lanes take fields l, l + 32, ...
    (3000, 54, 256, 16, "random"), (3000, 54, 256, 32, "two"),
    # 115 fields of 256 bins pass the shared-memory budget: field tiles
    (3000, 115, 256, 8, "random"), (3000, 115, 256, 1, "two"),
    # many blocks, each share crossing slot boundaries
    (200_000, 28, 256, 32, "random"), (200_000, 28, 256, 64, "sparse")])
def test_histogram_kernel_matches_plain(cuda, n, F, NB, NN, layout):
    rng = np.random.default_rng(n + NN)
    codes, nid = _layout(layout, n, F, NB, NN, (n,), rng)
    codes, nid = torch.from_numpy(codes).to(cuda), torch.from_numpy(nid).to(cuda)
    g = torch.from_numpy(rng.integers(-64, 64, n) / 64).float().to(cuda)
    h = torch.from_numpy(rng.integers(1, 64, n) / 64).float().to(cuda)
    before = _build.launch_counts()["histogram"]
    got = hist_k.histogram_cuda(codes, g, h, nid, n_nodes=NN, n_bins=NB)
    assert _build.launch_counts()["histogram"] == before + 1
    assert torch.equal(got, hist_k.histogram_plain(codes, g, h, nid, NN, NB))


@pytest.mark.parametrize("n,F,NB,NN,K,layout", [
    (777, 13, 16, 4, 1, "random"), (1000, 5, 16, 2, 3, "random"),
    # 7 x 32 slots of 256 bins: 1.75 MB per field
    (5000, 54, 256, 32, 7, "random"),
    # 3 x 512 slots
    (3000, 3, 256, 512, 3, "random"), (3000, 28, 256, 512, 3, "sparse"),
    # the Covertype shape's collision case: two-category codes, K = 7
    (5000, 54, 256, 32, 7, "two"), (5000, 54, 256, 1, 7, "two"),
    (4000, 54, 256, 32, 7, "one_slot"),
    # field tiles at K > 1; many blocks
    (2000, 115, 256, 4, 3, "sparse"), (100_000, 54, 256, 32, 7, "random")])
def test_class_batched_histogram_kernel_matches_plain(cuda, n, F, NB, NN, K,
                                                      layout):
    rng = np.random.default_rng(n + K)
    codes, nid = _layout(layout, n, F, NB, NN, (K, n), rng)
    codes, nid = torch.from_numpy(codes).to(cuda), torch.from_numpy(nid).to(cuda)
    g = torch.from_numpy(rng.integers(-64, 64, (K, n)) / 64).float().to(cuda)
    h = torch.from_numpy(rng.integers(1, 64, (K, n)) / 64).float().to(cuda)
    before = _build.launch_counts()["histogram"]
    got = hist_k.histogram_cuda(codes, g, h, nid, n_nodes=NN, n_bins=NB)
    assert _build.launch_counts()["histogram"] == before + 1
    assert got.shape == (K, NN, F, NB, 2)
    assert torch.equal(got, hist_k.histogram_plain(codes, g, h, nid, NN, NB))


def _dyadic_stats(K, n, NN, rng, cuda):
    shape = (n,) if K == 1 else (K, n)
    g = torch.from_numpy(rng.integers(-64, 64, shape) / 64).float().to(cuda)
    h = torch.from_numpy(rng.integers(1, 64, shape) / 64).float().to(cuda)
    nid = torch.from_numpy(rng.integers(0, NN, shape).astype(np.int32)
                           ).to(cuda)
    return g, h, nid


@pytest.mark.parametrize("n,F,NN,K", [
    (777, 13, 4, 1),
    # 512 slots of 16 bins
    (1001, 9, 512, 1),
    # 1001 fields of 16 bins pass the budget: two tiles of 501, the second
    # starting at field 501, inside a packed byte
    (301, 1001, 1, 1),
    # the IoT shape's fields: F odd, one pad nibble a record
    (3001, 115, 32, 1),
    (3001, 54, 32, 7), (500, 5, 3, 3),
    # odd F past one warp's lanes; one slot (no sort); K > 1 at odd F
    (2001, 33, 8, 1), (2001, 115, 1, 1), (2001, 63, 64, 3)])
def test_nibble_histogram_kernel_matches_plain(cuda, n, F, NN, K):
    rng = np.random.default_rng(n + F + K)
    codes = torch.from_numpy(_codes(n, F, 16, rng)).to(cuda)
    packed = PackedCodes.pack(codes)
    assert packed.data.shape == (n, (F + 1) // 2)
    g, h, nid = _dyadic_stats(K, n, NN, rng, cuda)
    geo = hist_k.grouped_geometry(n, K, NN, F, 16,
                                  hist_k.grouped_limits(cuda))
    assert F != 1001 or (geo.n_ftiles, geo.field_tile) == (2, 501)
    before = _build.launch_counts()
    got = hist_k.histogram_cuda(packed, g, h, nid, n_nodes=NN, n_bins=16)
    after = _build.launch_counts()
    assert after["histogram_nibble"] == before["histogram_nibble"] + 1
    assert after["histogram"] == before["histogram"]
    assert torch.equal(got, hist_k.histogram_plain(packed, g, h, nid, NN, 16))
    # bit-equal to the uint8 kernel on the same codes
    assert torch.equal(got, hist_k.histogram_cuda(codes, g, h, nid,
                                                  n_nodes=NN, n_bins=16))


@pytest.mark.parametrize("n,F,NB,NN,K,layout", [
    (777, 13, 16, 4, 1, "random"), (5000, 28, 256, 32, 1, "random"),
    (3001, 54, 256, 32, 7, "random"), (1000, 5, 16, 2, 3, "random"),
    # one slot (K * NN = 1): no sort, the list is the records
    (5000, 28, 256, 1, 1, "random"), (3000, 28, 256, 1, 1, "two"),
    # many blocks, shares crossing slot boundaries; empty slots
    (200_000, 28, 256, 32, 1, "random"), (200_000, 28, 256, 64, 1, "sparse"),
    (4000, 28, 256, 32, 1, "one_slot"),
    # node ids outside [0, NN) and codes >= NB are skipped, sorted or not
    (5000, 28, 200, 32, 1, "outside"), (3000, 28, 200, 1, 1, "outside"),
    (2000, 54, 200, 8, 3, "outside"),
    # rows read byte by byte (F % 4 != 0); IoT's 115 fields, unpacked
    (3001, 54, 256, 16, 1, "random"), (2001, 115, 16, 32, 1, "random"),
    # 115 fields of 256 bins: three tiles of 39 (bytes); 120: three of 40
    # (words)
    (3000, 115, 256, 8, 1, "random"), (2000, 120, 256, 4, 1, "random"),
    # Covertype's collision case: two-category codes, K = 7
    (5000, 54, 256, 32, 7, "two"), (5000, 54, 256, 1, 7, "two"),
    (100_000, 54, 256, 32, 7, "random"),
    # codes that start off a 4-byte boundary are read byte by byte
    (3000, 28, 256, 8, 1, "off_word")])
def test_naive_histogram_kernel_matches_plain(cuda, n, F, NB, NN, K, layout):
    rng = np.random.default_rng(n + NN + K)
    shape = (n,) if K == 1 else (K, n)
    codes, nid = _layout(layout, n, F, NB, NN, shape, rng)
    codes, nid = torch.from_numpy(codes).to(cuda), torch.from_numpy(nid).to(cuda)
    if layout == "off_word":
        flat = torch.empty(n * F + 1, dtype=torch.uint8, device=cuda)
        codes = flat[1:].view(n, F).copy_(codes)
        assert codes.data_ptr() % 4 == 1 and codes.is_contiguous()
    g = torch.from_numpy(rng.integers(-64, 64, shape) / 64).float().to(cuda)
    h = torch.from_numpy(rng.integers(1, 64, shape) / 64).float().to(cuda)
    before = _build.launch_counts()["histogram_naive"]
    got = hist_k.histogram_naive_cuda(codes, g, h, nid, n_nodes=NN,
                                      n_bins=NB)
    assert _build.launch_counts()["histogram_naive"] == before + 1
    assert got.shape == shape[:-1] + (NN, F, NB, 2)
    assert torch.equal(got, _plain_in_range(codes, g, h, nid, NN, NB))
    assert torch.equal(got, hist_k.histogram_cuda(codes, g, h, nid,
                                                  n_nodes=NN, n_bins=NB))


def test_naive_histogram_refuses_more_nodes_than_the_sort_holds(cuda):
    """The counting sort holds max_sort_nodes counters a class: the naive
    kernel refuses more nodes, as the grouped kernel does."""
    limit = hist_k.grouped_limits(cuda).max_sort_nodes
    codes = torch.zeros((64, 3), dtype=torch.uint8, device=cuda)
    g = torch.ones(64, device=cuda)
    nid = torch.zeros(64, dtype=torch.int32, device=cuda)
    before = _build.launch_counts()
    for fn in (hist_k.histogram_naive_cuda, hist_k.histogram_cuda):
        with pytest.raises(ValueError, match=f"at most {limit}"):
            fn(codes, g, g, nid, n_nodes=limit + 1, n_bins=4)
    assert _build.launch_counts() == before


# The grouped kernel's fixed-point cases at the cells' shapes, with
# non-dyadic g and h (on no float32 grid a float sum keeps exact):
# name -> (n, F, NB, K, codes).
FIXED_POINT_CASES = {
    "higgs": (2_000_000, 28, 256, 1, "random"),
    # Covertype: K = 7, 10 numeric fields and 44 of two categories
    "covertype": (581_012, 54, 256, 7, "two"),
    # IoT: 115 fields of 16 bins, 4-bit packed (the nibble entry)
    "iot": (2_000_000, 115, 16, 1, "nibble"),
}

# The float-atomic grouped kernel's (the float32 bins that the fixed-point
# bins replaced) largest error over the bins against the float64 sum of
# the same float32 g (h), at each case and level: the least of 20
# launches, so the smallest it reached, rounded down (measured on an
# NVIDIA H100 80GB HBM3 at 700 W with scripts/hist_accuracy.py).
FLOAT_ATOMIC_MAX_ERR = {
    ("higgs", 1): (2.09e-4, 1.26e-3), ("higgs", 32): (1.05e-5, 9.70e-6),
    ("covertype", 1): (7.54e-4, 3.02e-2),
    ("covertype", 32): (2.63e-4, 4.80e-3),
    ("iot", 1): (2.66e-4, 2.02e-2), ("iot", 32): (3.79e-5, 2.42e-4),
}


def fixed_point_case(name, NN, device):
    """(codes, g, h, node ids, NB) of one of FIXED_POINT_CASES at NN nodes
    a class, made with numpy from one seed (the same on every machine):
    normal g and uniform h at Higgs, softmax-like g in (-1, 1) and h =
    p(1 - p) at Covertype and IoT."""
    n, F, NB, K, kind = FIXED_POINT_CASES[name]
    rng = np.random.default_rng(31)
    codes = rng.integers(0, NB, (n, F), dtype=np.uint8)
    if kind == "two":
        codes[:, 10:] = rng.integers(0, 2, (n, F - 10), dtype=np.uint8)
    shape = (n,) if K == 1 else (K, n)
    if name == "higgs":
        g = rng.normal(size=shape)
        h = rng.uniform(0.05, 0.25, shape)
    else:
        p = rng.uniform(0.0, 1.0, shape)
        g = p - (rng.uniform(size=shape) < p)
        h = p * (1.0 - p)
    nid = rng.integers(0, NN, shape).astype(np.int32)
    codes = torch.from_numpy(codes).to(device)
    if kind == "nibble":
        codes = PackedCodes.pack(codes)
    return (codes, torch.from_numpy(g.astype(np.float32)).to(device),
            torch.from_numpy(h.astype(np.float32)).to(device),
            torch.from_numpy(nid).to(device), NB)


def float64_histogram(codes, g, h, nid, NN, NB):
    """The histogram of float32 g, h summed in float64 (the order of the
    adds moves it by float64 ulps only): (K, NN, F, NB, 2)."""
    codes = codes.unpack() if isinstance(codes, PackedCodes) else codes
    g, h, nid = (t.reshape(-1, t.shape[-1]) for t in (g, h, nid))
    K, n = g.shape
    F = codes.shape[1]
    idx = ((torch.arange(K, device=g.device)[:, None] * NN + nid.long())
           [:, :, None] * F + torch.arange(F, device=g.device)) * NB \
        + codes.long()[None]
    size = K * NN * F * NB

    def total(w):
        return torch.bincount(idx.reshape(-1), minlength=size,
                              weights=w.double()[:, :, None]
                              .expand(K, n, F).reshape(-1))

    return torch.stack([total(g), total(h)], -1).reshape(K, NN, F, NB, 2)


@pytest.mark.parametrize("NN", [1, 32])
@pytest.mark.parametrize("name", sorted(FIXED_POINT_CASES))
def test_fixed_point_histogram_is_the_same_every_launch(cuda, name, NN):
    """Integer sums do not depend on their order: 20 launches on
    non-dyadic g, h at the cells' shapes give one histogram, bit for
    bit."""
    codes, g, h, nid, NB = fixed_point_case(name, NN, cuda)
    first = hist_k.histogram_cuda(codes, g, h, nid, n_nodes=NN, n_bins=NB)
    for _ in range(19):
        again = hist_k.histogram_cuda(codes, g, h, nid, n_nodes=NN,
                                      n_bins=NB)
        assert torch.equal(again, first)


@pytest.mark.parametrize("NN", [1, 32])
@pytest.mark.parametrize("name", sorted(FIXED_POINT_CASES))
def test_fixed_point_histogram_no_less_exact_than_float_atomics(cuda, name,
                                                                NN):
    """Against the float64 sum of the same float32 g, h, the largest error
    over the bins is no larger than the float-atomic kernel's least
    (FLOAT_ATOMIC_MAX_ERR), and each bin is within its records' rounding
    to the grid (half a step each) and half a float32 ulp of the exact
    sum of the rounded records."""
    codes, g, h, nid, NB = fixed_point_case(name, NN, cuda)
    got = hist_k.histogram_cuda(codes, g, h, nid, n_nodes=NN, n_bins=NB)
    want = float64_histogram(codes, g, h, nid, NN, NB).reshape(got.shape)
    err = (got.double() - want).abs()
    count = float64_histogram(codes, torch.ones_like(g), torch.ones_like(h),
                              nid, NN, NB).reshape(got.shape)
    scale = hist_k.fixed_point_scale(g, h)
    step = scale.double().reciprocal().reshape(scale.shape[:-1]
                                               + (1, 1, 1, 2))
    top = got.abs()
    ulp = torch.nextafter(top, torch.full_like(top, float("inf"))) - top
    assert torch.all(err <= count * step / 2 + ulp.double() / 2)
    for i, parent in enumerate(FLOAT_ATOMIC_MAX_ERR[(name, NN)]):
        assert float(err[..., i].max()) <= parent


@pytest.mark.parametrize("NN", [1, 2])
def test_fixed_point_words_do_not_overflow_at_the_extremes(cuda, NN):
    """20 M records of one code in one slot, each g the largest value of
    its grid (2^31 - 128 steps) and each h its negative: a block's share
    passes 2^16 positions, and the sums are exact, so the histogram is the
    float32 rounding of n·g and n·h."""
    n, v = 20_000_000, 1.9999999
    codes = torch.zeros((n, 3), dtype=torch.uint8, device=cuda)
    g = torch.full((n,), v, device=cuda)
    nid = torch.full((n,), NN - 1, dtype=torch.int32, device=cuda)
    geo = hist_k.grouped_geometry(n, 1, NN, 3, 2,
                                  hist_k.grouped_limits(cuda))
    assert geo.per_block > 2 ** 16 == geo.flush_every
    got = hist_k.histogram_cuda(codes, g, -g, nid, n_nodes=NN, n_bins=2)
    want = torch.zeros((NN, 3, 2, 2), dtype=torch.float64)
    total = n * float(torch.tensor(v, dtype=torch.float32))
    want[NN - 1, :, 0, 0], want[NN - 1, :, 0, 1] = total, -total
    assert torch.equal(got.cpu(), want.float())


@pytest.mark.parametrize("packed", [False, True])
def test_fixed_point_histogram_of_non_finite_stats(cuda, packed):
    """A NaN or infinite g (h) of a class makes that statistic's histogram
    NaN, never finite; the class's other statistic and the other class
    are as the plain version's (dyadic)."""
    rng = np.random.default_rng(5)
    n, F, NN, K = 3000, 9, 4, 3
    codes = torch.from_numpy(_codes(n, F, 16, rng)).to(cuda)
    if packed:
        codes = PackedCodes.pack(codes)
    g, h, nid = _dyadic_stats(K, n, NN, rng, cuda)
    g[0, 17] = float("nan")
    h[1, 5] = float("inf")
    got = hist_k.histogram_cuda(codes, g, h, nid, n_nodes=NN, n_bins=16)
    assert torch.isnan(got[0, ..., 0]).all()
    assert torch.isnan(got[1, ..., 1]).all()
    want = hist_k.histogram_plain(codes, g, h, nid, NN, 16)
    assert torch.equal(got[0, ..., 1], want[0, ..., 1])
    assert torch.equal(got[1, ..., 0], want[1, ..., 0])
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("n,K,nn", [(3001, 1, 16), (3001, 7, 32),
                                    (2, 3, 4)])
def test_nibble_partition_kernel_matches_plain(cuda, n, K, nn):
    """Odd n: each packed row of the column-major copy holds ceil(n/2)
    bytes and ends in a pad nibble."""
    rng = np.random.default_rng(n + K)
    F = 115
    codes_cm = torch.from_numpy(_codes(n, F, 16, rng).T.copy()).to(cuda)
    packed = PackedCodes.pack(codes_cm)
    assert packed.data.shape == (F, (n + 1) // 2)
    shape = (nn,) if K == 1 else (K, nn)
    nid = torch.from_numpy(rng.integers(0, nn, shape[:-1] + (n,))
                           .astype(np.int32)).to(cuda)
    split = [torch.from_numpy(a).to(cuda) for a in (
        rng.integers(-1, F, shape).astype(np.int32),
        rng.integers(0, 16, shape).astype(np.int32),
        rng.integers(0, 2, shape).astype(np.int32),
        rng.integers(0, 2, shape).astype(np.int32))]
    before = _build.launch_counts()
    got = part_k.partition_cm_cuda(nid, packed, *split, missing_bin=15)
    after = _build.launch_counts()
    assert after["partition_nibble"] == before["partition_nibble"] + 1
    assert after["partition"] == before["partition"]
    assert torch.equal(got, part_k.partition_cm_plain(nid, packed, *split,
                                                      15))
    assert torch.equal(got, part_k.partition_cm_cuda(nid, codes_cm, *split,
                                                     missing_bin=15))


def test_partition_kernels_match_plain(cuda):
    rng = np.random.default_rng(0)
    n, nn, F, n_bins = 3001, 16, 28, 256
    nid = torch.from_numpy(rng.integers(0, nn, n).astype(np.int32)).to(cuda)
    codes = torch.from_numpy(_codes(n, F, n_bins, rng)).to(cuda)
    split = [torch.from_numpy(a).to(cuda) for a in (
        rng.integers(-1, F, nn).astype(np.int32),
        rng.integers(0, n_bins, nn).astype(np.int32),
        rng.integers(0, 2, nn).astype(np.int32),
        rng.integers(0, 2, nn).astype(np.int32))]
    assert torch.equal(
        part_k.partition_cuda(nid, codes, *split, missing_bin=n_bins - 1),
        part_k.partition_plain(nid, codes, *split, n_bins - 1))
    codes_cm = codes.T.contiguous()
    assert torch.equal(
        part_k.partition_cm_cuda(nid, codes_cm, *split,
                                 missing_bin=n_bins - 1),
        part_k.partition_cm_plain(nid, codes_cm, *split, n_bins - 1))


@pytest.mark.parametrize("K,nn", [(1, 16), (3, 4), (7, 32)])
def test_class_batched_partition_kernel_matches_plain(cuda, K, nn):
    rng = np.random.default_rng(K)
    n, F, n_bins = 3001, 54, 256
    nid = torch.from_numpy(rng.integers(0, nn, (K, n)).astype(np.int32)
                           ).to(cuda)
    codes_cm = torch.from_numpy(_codes(n, F, n_bins, rng).T.copy()).to(cuda)
    split = [torch.from_numpy(a).to(cuda) for a in (
        rng.integers(-1, F, (K, nn)).astype(np.int32),
        rng.integers(0, n_bins, (K, nn)).astype(np.int32),
        rng.integers(0, 2, (K, nn)).astype(np.int32),
        rng.integers(0, 2, (K, nn)).astype(np.int32))]
    before = _build.launch_counts()["partition"]
    got = part_k.partition_cm_cuda(nid, codes_cm, *split,
                                   missing_bin=n_bins - 1)
    assert _build.launch_counts()["partition"] == before + 1
    assert torch.equal(got, part_k.partition_cm_plain(nid, codes_cm, *split,
                                                      n_bins - 1))


def _splits(shape, F, n_bins, rng, device):
    return [torch.from_numpy(a).to(device) for a in (
        rng.integers(-1, F, shape).astype(np.int32),
        rng.integers(0, n_bins, shape).astype(np.int32),
        rng.integers(0, 2, shape).astype(np.int32),
        rng.integers(0, 2, shape).astype(np.int32))]


EDGES = [(1, 1, 1), (3, 1, 2), (4097, 1, 32),    # n < 4, odd n
         (1031, 1, part_k.MAX_NODES),            # the largest split table
         (4098, 7, 32),                          # class rows off 16 bytes
         (1031, 3, part_k.MAX_NODES),
         (8192, 7, 64)]                          # whole groups only


@pytest.mark.parametrize("layout,n,K,nn",
                         [("rows",) + e for e in EDGES if e[1] == 1]
                         + [(lay,) + e for lay in ("cm", "nibble")
                            for e in EDGES])
def test_partition_entries_at_their_edges(cuda, layout, n, K, nn):
    """Every layout of the partition kernel against its plain version where
    a thread's 4 records do not fill a group or their class row does not
    start on 16 bytes, at K = 7 and at NN up to ``MAX_NODES``; the split
    arrays handed over as strided views of (K, 2^D - 1) tree tables, as
    the grower hands them, and as separate tensors."""
    rng = np.random.default_rng(n + K + nn)
    F, NB = (115, 16) if layout == "nibble" else (54, 256)
    codes_cm = torch.from_numpy(_codes(n, F, NB, rng).T.copy()).to(cuda)
    shape = (nn,) if K == 1 else (K, nn)
    nid = torch.from_numpy(rng.integers(0, nn, shape[:-1] + (n,))
                           .astype(np.int32)).to(cuda)
    split = _splits(shape, F, NB, rng, cuda)
    tables = [torch.full((K, 2 * nn + 5), 7, dtype=torch.int32, device=cuda)
              for _ in split]
    for table, part in zip(tables, split):
        table[:, nn + 2:2 * nn + 2] = part.reshape(K, nn)
    views = [t[:, nn + 2:2 * nn + 2] for t in tables]
    if K == 1:
        views = [v[0] for v in views]
    if layout == "rows":
        lvl = codes_cm[split[0].clamp(min=0).long()].T.contiguous()
        renum = torch.where(split[0] >= 0, torch.arange(
            nn, dtype=torch.int32, device=cuda), -1)
        want = part_k.partition_plain(nid, lvl, renum, *split[1:], NB - 1)
        for args in ((renum, *split[1:]), (renum, *views[1:])):
            assert torch.equal(part_k.partition_cuda(
                nid, lvl, *args, missing_bin=NB - 1), want)
        return
    codes = PackedCodes.pack(codes_cm) if layout == "nibble" else codes_cm
    counter = "partition_nibble" if layout == "nibble" else "partition"
    want = part_k.partition_cm_plain(nid, codes, *split, NB - 1)
    for args in (split, views):
        before = _build.launch_counts()[counter]
        got = part_k.partition_cm_cuda(nid, codes, *args, missing_bin=NB - 1)
        assert _build.launch_counts()[counter] == before + 1
        assert torch.equal(got, want)


def test_partition_marks_what_it_cannot_route(cuda):
    """Node ids outside [0, NN) and split fields past the codes give -1;
    any negative field is a pass-through (left)."""
    n, F = 9, 3
    codes_cm = torch.zeros((F, n), dtype=torch.uint8, device=cuda)
    nid = torch.tensor([0, 1, 2, 3, -1, 4, 0, 1, 2], dtype=torch.int32,
                       device=cuda)
    split = [torch.tensor(a, dtype=torch.int32, device=cuda) for a in (
        [-5, 3, 0, -1], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0])]
    got = part_k.partition_cm_cuda(nid, codes_cm, *split, missing_bin=255)
    assert got.tolist() == [0, -1, 4, 6, -1, -1, 0, -1, 4]


@pytest.mark.parametrize("K,depth,packed", [(1, 6, False), (7, 6, False),
                                            (4, 3, True)])
def test_class_batched_traversal_kernel_matches_plain(cuda, K, depth,
                                                      packed):
    """Step ⑤ walks one round's K trees through the ensemble kernel's
    staged body at T = K: each class's leaf exactly, and, added into the
    margins in place, ``margins + leaf`` bit for bit."""
    rng = np.random.default_rng(K + depth)
    C, n, NB = 54, 4099, 16 if packed else 256
    forest = _trees(K, depth, C, NB, rng, cuda)
    codes = torch.from_numpy(_codes(n, C, NB, rng)).to(cuda)
    if packed:
        codes = PackedCodes.pack(codes)
    before = _build.launch_counts()["traversal"]
    got = trav_k.traverse_forest_cuda(forest, codes, missing_bin=NB - 1)
    assert _build.launch_counts()["traversal"] == before + 1
    assert got.shape == (n, K)
    want = trav_k.traverse_forest_plain(forest, codes, NB - 1)
    assert torch.equal(got, want)
    margins = torch.from_numpy(rng.normal(size=(n, K)).astype(np.float32)
                               ).to(cuda)
    if K == 1:
        margins = margins[:, 0].contiguous()
    expect = margins + want.reshape(margins.shape)
    out = trav_k.traverse_forest_cuda(forest, codes, missing_bin=NB - 1,
                                      margins=margins)
    assert out is margins and torch.equal(out, expect)


@pytest.mark.parametrize("T,K,depth", [(504, 7, 6), (10, 3, 4), (97, 2, 10)])
def test_multiclass_ensemble_kernel_matches_plain(cuda, T, K, depth):
    """Tree blocks that start inside a round (T and the staged block count
    share no factor with K)."""
    rng = np.random.default_rng(T)
    trees = _trees(T, depth, 54, 256, rng, cuda)
    codes = torch.from_numpy(_codes(3001, 54, 256, rng)).to(cuda)
    got = trav_k.predict_ensemble_cuda(trees, codes, missing_bin=255,
                                       n_classes=K)
    assert got.shape == (3001, K)
    torch.testing.assert_close(
        got, trav_k.predict_ensemble_plain(trees, codes, 255, n_classes=K),
        rtol=1e-5, atol=1e-5)
    dyadic = trees._replace(leaf_value=torch.round(trees.leaf_value * 64) / 64)
    assert torch.equal(
        trav_k.predict_ensemble_cuda(dyadic, codes, missing_bin=255,
                                     n_classes=K),
        trav_k.predict_ensemble_plain(dyadic, codes, 255, n_classes=K))


@pytest.mark.parametrize("T,depth", [(1, 6), (13, 3), (40, 10)])
def test_traversal_kernels_match_plain(cuda, T, depth):
    rng = np.random.default_rng(T)
    trees = _trees(T, depth, 28, 256, rng, cuda)
    codes = torch.from_numpy(_codes(4099, 28, 256, rng)).to(cuda)
    one = ref.TreeArrays(*[a[0] for a in trees])
    assert torch.equal(trav_k.traverse_cuda(one, codes, missing_bin=255),
                       trav_k.traverse_plain(one, codes, 255))
    torch.testing.assert_close(
        trav_k.predict_ensemble_cuda(trees, codes, missing_bin=255),
        trav_k.predict_ensemble_plain(trees, codes, 255),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K", [1, 7])
def test_plain_ensemble_sums_in_the_kernels_order(cuda, K):
    """Both add each record's real leaves in tree order onto zeros or onto
    the output given, so they agree bit for bit."""
    rng = np.random.default_rng(K)
    trees = _trees(7 * K + 3, 6, 28, 256, rng, cuda)
    codes = torch.from_numpy(_codes(2053, 28, 256, rng)).to(cuda)
    assert torch.equal(
        trav_k.predict_ensemble_cuda(trees, codes, missing_bin=255,
                                     n_classes=K),
        trav_k.predict_ensemble_plain(trees, codes, 255, n_classes=K))
    base = torch.randn((2053, K), device=cuda)
    got = trav_k.predict_ensemble_cuda(trees, codes, missing_bin=255,
                                       n_classes=K, out=base.clone())
    want = trav_k.predict_ensemble_plain(trees, codes, 255, n_classes=K,
                                         out=base.clone())
    assert torch.equal(got, want)


def _ensemble_matches_plain(trees, codes, K, missing_bin, counter):
    """The kernel against the plain version: rtol 1e-5 on the trees' real
    leaves, bit-equal on their leaves rounded to 1/64; each launch counted
    once under ``counter``."""
    before = _build.launch_counts()[counter]
    got = trav_k.predict_ensemble_cuda(trees, codes, missing_bin=missing_bin,
                                       n_classes=K)
    assert _build.launch_counts()[counter] == before + 1
    assert got.shape == ((codes.shape[0],) if K == 1 else (codes.shape[0], K))
    torch.testing.assert_close(
        got, trav_k.predict_ensemble_plain(trees, codes, missing_bin,
                                           n_classes=K), rtol=1e-5, atol=1e-5)
    dyadic = trees._replace(leaf_value=torch.round(trees.leaf_value * 64) / 64)
    assert torch.equal(
        trav_k.predict_ensemble_cuda(dyadic, codes, missing_bin=missing_bin,
                                     n_classes=K),
        trav_k.predict_ensemble_plain(dyadic, codes, missing_bin,
                                      n_classes=K))


@pytest.mark.parametrize("n,F,T,K,depth", [
    (1001, 28, 13, 1, 6),        # n not a multiple of R
    (7, 28, 13, 1, 6),           # n < 32
    (5, 54, 21, 7, 6),
    (2053, 115, 40, 1, 6),       # F odd, padded to 4 bytes
    (2053, 115, 40, 7, 6),
    (3001, 28, 1, 1, 6),         # one tree
    (3001, 54, 1, 7, 6),         # one tree: classes 1..6 stay 0
    (3001, 28, "TB+3", 1, 6),    # T not a multiple of TB
    (3001, 54, "TB+3", 7, 6),
    (3001, 115, "TB+3", 7, 6),
    (2999, 28, 9, 1, 1),         # depth 1
    (2999, 54, 16, 3, 1),
    (1025, 28, "TB+3", 1, 10),   # depth 10: 2047-word trees
    (1025, 54, 11, 7, 10),
    (1001, 28, "edges", 1, 6),   # every decoded form's edge (_edge_trees)
    (1001, 54, "edges", 7, 6),
    (777, 115, "edges", 7, 3)])
def test_staged_ensemble_kernel_matches_plain(cuda, n, F, T, K, depth):
    """The staged entry (code rows in shared memory) at the edges of its
    geometry: partial record blocks, odd widths, partial tree blocks; and
    at the edges of the decoded nodes, code 255 the missing bin."""
    limits = trav_k.ensemble_limits(cuda)
    if T == "TB+3":
        T = trav_k.ensemble_geometry(n, F, 100_000, depth, limits).trees + 3
    rng = np.random.default_rng(n + F + K + depth
                                + (T if isinstance(T, int) else 0))
    if T == "edges":
        trees = _edge_trees(depth, F, 256, rng, cuda)
        codes = torch.from_numpy(_edge_codes(n, F, 256, rng)).to(cuda)
        T = trees.feature.shape[0]
    else:
        trees = _trees(T, depth, F, 256, rng, cuda)
        codes = torch.from_numpy(_codes(n, F, 256, rng)).to(cuda)
    geo = trav_k.ensemble_geometry(n, F, T, depth, limits)
    assert geo.entry == "staged" and geo.records % 32 == 0
    _ensemble_matches_plain(trees, codes, K, 255, "ensemble")


@pytest.mark.parametrize("K", [1, 3])
def test_wide_ensemble_entry_past_the_staged_limit(cuda, K):
    """Code rows one field past the staged limit take the wide entry
    (counted as ``ensemble_wide``); rows at the limit are still staged."""
    limits = trav_k.ensemble_limits(cuda)
    top = trav_k.max_staged_fields(6, limits)
    rng = np.random.default_rng(top + K)
    for F, counter in ((top, "ensemble"), (top + 1, "ensemble_wide")):
        assert trav_k.ensemble_geometry(300, F, 20, 6, limits).entry == \
            ("staged" if counter == "ensemble" else "wide")
        trees = _trees(20, 6, F, 256, rng, cuda)
        codes = torch.from_numpy(_codes(300, F, 256, rng)).to(cuda)
        _ensemble_matches_plain(trees, codes, K, 255, counter)


@pytest.mark.parametrize("n,F,T,K", [(2053, 115, 40, 1), (2053, 115, 40, 7),
                                     (5, 9, 13, 3), (3001, 28, "TB+3", 1),
                                     (1001, 115, "edges", 1),
                                     (1001, 115, "edges", 7),
                                     (333, 9, "edges", 7)])
def test_nibble_ensemble_entry_matches_plain(cuda, n, F, T, K):
    """4-bit packed rows staged as they lie (F odd: a pad nibble a row),
    bit-equal on dyadic leaves to the uint8 entry on the same codes; and
    at the edges of the decoded nodes (``_edge_trees``: codes 0-15, 15 the
    missing bin)."""
    limits = trav_k.ensemble_limits(cuda)
    if T == "TB+3":
        T = trav_k.ensemble_geometry(n, F, 100_000, 6, limits,
                                     packed=True).trees + 3
    rng = np.random.default_rng(n + F + K + (T if isinstance(T, int) else 0))
    if T == "edges":
        trees = _edge_trees(6, F, 16, rng, cuda)
        codes = torch.from_numpy(_edge_codes(n, F, 16, rng)).to(cuda)
        T = trees.feature.shape[0]
    else:
        trees = _trees(T, 6, F, 16, rng, cuda)
        codes = torch.from_numpy(_codes(n, F, 16, rng)).to(cuda)
    assert trav_k.ensemble_geometry(n, F, T, 6, limits,
                                    packed=True).entry == "staged"
    packed = PackedCodes.pack(codes)
    _ensemble_matches_plain(trees, packed, K, 15, "ensemble")
    dyadic = trees._replace(leaf_value=torch.round(trees.leaf_value * 64) / 64)
    assert torch.equal(
        trav_k.predict_ensemble_cuda(dyadic, packed, missing_bin=15,
                                     n_classes=K),
        trav_k.predict_ensemble_cuda(dyadic, codes, missing_bin=15,
                                     n_classes=K))


@pytest.mark.parametrize("K", [1, 7])
@pytest.mark.parametrize("packed", [False, True])
def test_wide_ensemble_entry_decodes_every_edge(cuda, packed, K):
    """The wide entry (code rows read from global memory) at the edges of
    its decoded nodes (``_edge_trees``), uint8 and 4-bit packed rows."""
    limits = trav_k.ensemble_limits(cuda)
    F = trav_k.max_staged_fields(6, limits, packed) + 1
    NB = 16 if packed else 256
    rng = np.random.default_rng(F + K)
    trees = _edge_trees(6, F, NB, rng, cuda)
    codes = torch.from_numpy(_edge_codes(300, F, NB, rng)).to(cuda)
    assert trav_k.ensemble_geometry(300, F, trees.feature.shape[0], 6,
                                    limits, packed).entry == "wide"
    _ensemble_matches_plain(trees, PackedCodes.pack(codes) if packed
                            else codes, K, NB - 1, "ensemble_wide")


@pytest.mark.parametrize("F,packed", [(28, False), (54, False),
                                      (115, True), (28, True)])
def test_staged_rows_that_do_not_start_on_16_bytes(cuda, F, packed):
    """Code rows whose storage starts off 16 bytes (a view one byte into a
    buffer) are staged byte by byte: the same sums as an aligned copy, in
    whole words (F % 4 == 0) and byte by byte (F % 4 != 0)."""
    rng = np.random.default_rng(F + packed)
    n, NB = 1037, 16 if packed else 256
    codes = torch.from_numpy(_codes(n, F, NB, rng)).to(cuda)
    aligned = PackedCodes.pack(codes) if packed else codes
    data = aligned.data if packed else aligned
    buf = torch.empty(data.numel() + 1, dtype=torch.uint8, device=cuda)
    buf[1:] = data.reshape(-1)
    shifted = buf[1:].view(data.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 1
    off = PackedCodes(shifted, F) if packed else shifted
    trees = _trees(40, 6, F, NB, rng, cuda)
    for K in (1, 3):
        assert torch.equal(
            trav_k.predict_ensemble_cuda(trees, off, missing_bin=NB - 1,
                                         n_classes=K),
            trav_k.predict_ensemble_cuda(trees, aligned, missing_bin=NB - 1,
                                         n_classes=K))
    _ensemble_matches_plain(trees, off, 3, NB - 1, "ensemble")


@pytest.mark.parametrize("packed", [False, True])
def test_wide_traversal_entry_past_the_staged_limit(cuda, packed):
    """Step ⑤ on rows one field past the staged limit takes the wide entry
    (counted as ``traversal_wide``), bit-equal to its plain version."""
    limits = trav_k.ensemble_limits(cuda)
    F = trav_k.max_staged_fields(6, limits, packed) + 1
    NB = 16 if packed else 256
    rng = np.random.default_rng(F)
    forest = _trees(3, 6, F, NB, rng, cuda)
    codes = torch.from_numpy(_codes(300, F, NB, rng)).to(cuda)
    if packed:
        codes = PackedCodes.pack(codes)
    before = _build.launch_counts()
    got = trav_k.traverse_forest_cuda(forest, codes, missing_bin=NB - 1)
    after = _build.launch_counts()
    assert after["traversal_wide"] == before["traversal_wide"] + 1
    assert after["traversal"] == before["traversal"]
    assert torch.equal(got, trav_k.traverse_forest_plain(forest, codes,
                                                         NB - 1))


@pytest.mark.parametrize("n_bins,K", [(16, None), (16, 3), (64, None),
                                      (64, 3)])
def test_round_step5_reads_no_host_value(cuda, monkeypatch, n_bins, K):
    """Step ⑤ of a round on the card (F = 20 > 2^3 - 1): one traversal
    launch over the row-major codes, packed or not; no column gather from
    the column-major copy, no unpack, no device->host read; the margins
    take each leaf in place, bit-equal to ``margins + leaf``."""
    import dataclasses

    X, y, _ = make_tabular(2001, 20, 0, task="binary" if K is None
                           else "multiclass", n_classes=K or 4, seed=9)
    data = binning.Binner(n_bins).fit(X).transform(X)
    assert isinstance(data.codes, PackedCodes) == (n_bins == 16)
    cfg = gbdt.GBDTConfig(n_trees=1, max_depth=3, objective="binary:logistic"
                          if K is None else "multi:softmax", n_classes=K)
    tree = gbdt.train(cfg, data, y).model.trees
    forest = tree if K else ref.TreeArrays(*[a[0] for a in tree])
    rng = np.random.default_rng(n_bins)
    margins = torch.from_numpy(rng.normal(size=(2001, K or 1)).astype(
        np.float32)).to(cuda)
    margins = margins if K else margins[:, 0].contiguous()
    plain = data.codes.unpack() if n_bins == 16 else data.codes
    delta = trav_k.traverse_forest_plain(
        tree if K else ref.TreeArrays(*[a[None] for a in forest]), plain,
        data.missing_bin)
    expect = margins + delta.reshape(margins.shape)

    class Poison:
        def __getattr__(self, name):
            raise AssertionError(f"step ⑤ read the column-major copy "
                                 f"({name})")

    def refuse(*args, **kwargs):
        raise AssertionError("step ⑤ made a forbidden call")

    poisoned = dataclasses.replace(data, codes_cm=Poison())
    monkeypatch.setattr(PackedCodes, "unpack", refuse)
    monkeypatch.setattr(trav_k, "check_fields", refuse)
    for name in ("item", "tolist", "cpu", "numpy", "__int__", "__float__",
                 "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    before = _build.launch_counts()
    predict = gbdt._predict_forest if K else gbdt._predict_one_tree
    out = predict(forest, poisoned, None, margins)
    after = _build.launch_counts()
    monkeypatch.undo()
    assert out is margins and torch.equal(out, expect)
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"traversal": 1}


def test_ensemble_limits_read_from_the_card(cuda):
    """The limits that size an ensemble launch come from the built kernel
    and the card, and leave room for the paths' staged rows."""
    limits = trav_k.ensemble_limits(cuda)
    assert limits.threads % 32 == 0 and limits.per_thread >= 1
    assert limits.blocks_per_sm >= 3
    assert 0 < limits.block_reserved < limits.block_shared \
        <= limits.sm_shared
    higgs = trav_k.ensemble_geometry(10_000_000, 28, 500, 6, limits)
    assert higgs.entry == "staged"
    assert limits.sm_shared // (higgs.smem + limits.block_reserved) >= 3
    assert trav_k.ensemble_limits(cuda) is limits     # read once a device


def test_grouped_limits_read_from_the_card(cuda):
    """The limits that size a grouped launch come from the built kernel
    and the card, and leave room for the paths' bins and sort counters."""
    limits = hist_k.grouped_limits(cuda)
    props = torch.cuda.get_device_properties(cuda)
    assert limits.sms == props.multi_processor_count
    assert limits.blocks_per_sm >= 1 and limits.sort_node_bytes == 12
    assert 0 < limits.block_reserved < limits.block_shared \
        <= limits.sm_shared
    assert limits.naive_blocks_per_sm == 3
    # Higgs's 28 fields of 256 bins fit one block (padded to 32 fields),
    # the grouped kernel's fixed-point bins and the naive kernel's floats
    assert 16 * 256 * 32 <= limits.grouped_budget
    assert 8 * 256 * 28 <= limits.budget
    assert limits.max_sort_nodes >= 2 ** 14
    assert hist_k.grouped_limits(cuda) is limits     # read once a device


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    codes = torch.zeros((8, 3), dtype=torch.uint8, device=cuda)
    g = torch.zeros(8, device=cuda)
    nid = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        hist_k.histogram_cuda(codes, g.double(), g, nid, n_nodes=1, n_bins=4)
    with pytest.raises(ValueError):
        hist_k.histogram_cuda(codes.T, g, g, nid, n_nodes=1, n_bins=4)
    # more nodes than the counting sort's shared counters hold
    limits = hist_k.grouped_limits(cuda)
    with pytest.raises(ValueError, match="nodes"):
        hist_k.histogram_cuda(codes, g, g, nid,
                              n_nodes=limits.max_sort_nodes + 1, n_bins=4)
    tree = ref.TreeArrays(*[a.to(cuda) for a in (
        torch.tensor([5], dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
        torch.zeros(2))])
    with pytest.raises(ValueError, match="field 5"):
        trav_k.traverse_cuda(tree, codes, missing_bin=3)
    packed = PackedCodes.pack(codes)
    with pytest.raises(ValueError, match="at most 16 bins"):
        hist_k.histogram_cuda(packed, g, g, nid, n_nodes=1, n_bins=17)
    with pytest.raises(ValueError, match="unpacked"):
        hist_k.histogram_naive_cuda(packed, g, g, nid, n_nodes=1, n_bins=4)
    with pytest.raises(ValueError, match="do not hold"):
        hist_k.histogram_cuda(PackedCodes(packed.data, 5), g, g, nid,
                              n_nodes=1, n_bins=4)


def test_slice_on_card_matches_cpu(cuda):
    X, y, cats = make_tabular(3000, 14, 2, n_cats=6, task="binary",
                              missing_rate=0.05, seed=3)
    b = binning.Binner(64, cats).fit(X)
    cfg = gbdt.GBDTConfig(n_trees=4, max_depth=3,
                          objective="binary:logistic")
    cpu = gbdt.train(cfg, b.transform(X, device="cpu"), y, device="cpu")
    card = gbdt.train(cfg, b.transform(X), y)
    for field in ("feature", "threshold", "is_cat", "default_left"):
        assert torch.equal(getattr(card.model.trees, field).cpu(),
                           getattr(cpu.model.trees, field))
    np.testing.assert_allclose(card.history["train_loss"],
                               cpu.history["train_loss"], rtol=1e-5)


def test_multiclass_slice_on_card_matches_cpu(cuda):
    X, y, cats = make_tabular(3000, 6, 4, n_cats=3, task="multiclass",
                              n_classes=4, missing_rate=0.05, seed=5)
    b = binning.Binner(64, cats).fit(X)
    cfg = gbdt.GBDTConfig(n_trees=3, max_depth=3, learning_rate=0.5,
                          objective="multi:softmax", n_classes=4)
    cpu = gbdt.train(cfg, b.transform(X, device="cpu"), y, device="cpu")
    _build.reset_launch_counts()
    card = gbdt.train(cfg, b.transform(X), y)
    counts = _build.launch_counts()
    assert counts["histogram"] == counts["partition"] == 3 * 3
    assert counts["traversal"] == 3
    for field in ("feature", "is_cat"):
        assert torch.equal(getattr(card.model.trees, field).cpu(),
                           getattr(cpu.model.trees, field))
    # A node holding two categories of a 3-category field offers two mirror
    # splits (either category left, the missing records beside it) that
    # route every record alike with the children swapped; their gains tie
    # in real arithmetic, so the order of the float32 histogram sums picks
    # one (ROADMAP Queue 3).  A node's (threshold, default_left) equals the
    # CPU fit's, or that of a CPU fit of the same records in another order
    # (the witness) at that node.
    def words(fit):
        return torch.stack([getattr(fit.model.trees, f).cpu()
                            for f in ("threshold", "default_left")], -1)

    seen = [words(cpu)]
    for seed in range(8):
        p = np.random.default_rng(seed).permutation(len(y))
        seen.append(words(gbdt.train(cfg, b.transform(X[p], device="cpu"),
                                     y[p], device="cpu")))
    got = words(card)
    witnessed = (torch.stack(seen) == got).all(-1).any(0)
    assert witnessed.all(), (
        f"nodes {torch.nonzero(~witnessed).tolist()}: card "
        f"{got[~witnessed].tolist()}, CPU {seen[0][~witnessed].tolist()}")
    torch.testing.assert_close(card.margins.cpu(), cpu.margins, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(card.history["train_loss"],
                               cpu.history["train_loss"], rtol=1e-5)
    margins = card.model.predict_margin(b.transform(X))
    assert margins.shape == (3000, 4) and _build.launch_counts()["ensemble"]
    torch.testing.assert_close(margins, card.margins, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("objective,K", [("binary:logistic", None),
                                         ("multi:softmax", 3)])
def test_packed_slice_on_card_matches_cpu(cuda, objective, K):
    """A 16-bin fit on PackedCodes: the nibble histogram and partition on
    the card grow the CPU fit's trees, and the Fig. 9 twin
    (``hist_strategy="cuda_packed"``) grows them too."""
    X, y, cats = make_tabular(3001, 15, 0, task="binary" if K is None
                              else "multiclass", n_classes=K or 4,
                              missing_rate=0.05, seed=7)
    b = binning.Binner(16).fit(X)
    cfg = gbdt.GBDTConfig(n_trees=3, max_depth=3, learning_rate=0.5,
                          objective=objective, n_classes=K)
    cpu = gbdt.train(cfg, b.transform(X, device="cpu"), y, device="cpu")
    data = b.transform(X)
    assert isinstance(data.codes, PackedCodes)
    assert isinstance(data.codes_cm, PackedCodes)
    _build.reset_launch_counts()
    card = gbdt.train(cfg, data, y)
    counts = _build.launch_counts()
    assert counts["histogram_nibble"] == counts["partition_nibble"] == 3 * 3
    assert counts["histogram"] == counts["partition"] == 0
    naive = gbdt.train(cfg, data, y,
                       plan=ExecutionPlan(hist_strategy="cuda_packed"))
    assert _build.launch_counts()["histogram_naive"] == 3 * 3
    for run in (card, naive):
        assert torch.equal(run.model.trees.feature.cpu(),
                           cpu.model.trees.feature)
        np.testing.assert_allclose(run.history["train_loss"],
                                   cpu.history["train_loss"], rtol=1e-5)
    margins = card.model.predict_margin(data)
    torch.testing.assert_close(margins, card.margins, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(card.model.predict_margin(data.codes),
                               margins)


def test_packed_rounds_on_card_unpack_nothing(cuda, monkeypatch):
    """Level-wise rounds on 4-bit packed codes at the IoT width (115
    fields, 16 bins): the nibble kernels read the packed copies as they
    are, so a round records no ``codes.unpack`` span."""
    X, y, _ = make_tabular(6001, 115, 0, task="binary", seed=30)
    data = binning.Binner(16).fit(X).transform(X)
    assert isinstance(data.codes, PackedCodes)
    assert isinstance(data.codes_cm, PackedCodes)
    cfg = gbdt.GBDTConfig(n_trees=3, max_depth=6,
                          objective="binary:logistic")
    monkeypatch.setattr(obs, "_rows", {})
    monkeypatch.setattr(obs, "_enabled", True)
    _build.reset_launch_counts()
    gbdt.train(cfg, data, y)
    rows = obs.spans()
    assert rows["gbdt.round"]["count"] == 3
    assert binning.UNPACK_SPAN not in rows, rows[binning.UNPACK_SPAN]
    assert _build.launch_counts()["histogram_nibble"] == 3 * 6


# --------------------------------------------------------------------------
# the serving engine: a CUDA graph per shape bucket
# --------------------------------------------------------------------------
def _graph_model(T, K, F, depth, rng, device, base=0.25):
    trees = _trees(T * K, depth, F, 256, rng, device)
    base_margin = (float(base) if K == 1
                   else rng.normal(size=K).astype(np.float32))
    return gbdt.GBDTModel(trees=trees, base_margin=base_margin,
                          objective="multi:softmax" if K > 1
                          else "reg:squarederror", missing_bin=255,
                          n_fields=F, max_depth=depth, n_classes=K)


@pytest.mark.parametrize("K", [1, 7])
def test_graph_replay_bit_equal_to_direct_kernel(cuda, K):
    """Three row buckets (one of them padded rows), each captured once and
    replayed bit-equal to the direct kernel call; captures count as
    traces, replays as replays, and the kernel's launch count moves only
    at capture."""
    from repro_torch.core import inference

    rng = np.random.default_rng(K)
    model = _graph_model(9, K, 28, 6, rng, cuda)
    cache = inference.PredictCache()
    for n, traces, launches in ((100, 1, 2), (128, 1, 0), (3000, 2, 2)):
        codes = torch.from_numpy(_codes(n, 28, 256, rng)).to(cuda)
        direct = model.predict_margin(codes)
        before = _build.launch_counts()["ensemble"]
        got = model.predict_margin(codes, mode="cached", cache=cache)
        assert torch.equal(got, direct)
        assert cache.stats()["traces"] == traces
        again = model.predict_margin(codes, mode="cached", cache=cache)
        assert torch.equal(again, direct)
        # a capture launches twice (the eager first run and the captured
        # body); replays never count
        assert _build.launch_counts()["ensemble"] - before == launches
    assert cache.stats()["replays"] == 6


def test_same_bucket_hot_swap_recaptures_nothing(cuda):
    from repro_torch.core import inference

    rng = np.random.default_rng(3)
    v1 = _graph_model(100, 1, 28, 6, rng, cuda, base=0.5)
    v2 = _graph_model(99, 1, 28, 6, rng, cuda, base=-1.5)
    assert inference.bucket_trees(99) == inference.bucket_trees(100) == 104
    codes = torch.from_numpy(_codes(500, 28, 256, rng)).to(cuda)
    cache = inference.PredictCache()
    assert torch.equal(v1.predict_margin(codes, mode="cached", cache=cache),
                       v1.predict_margin(codes))
    traces = cache.stats()["traces"]
    # v2's trees and base margin go into the live buffers; then v1 again
    for model in (v2, v1, v2):
        assert torch.equal(
            model.predict_margin(codes, mode="cached", cache=cache),
            model.predict_margin(codes))
    assert cache.stats()["traces"] == traces


def test_threads_replaying_one_graph_get_their_own_rows(cuda):
    import threading

    from repro_torch.core import inference

    rng = np.random.default_rng(4)
    model = _graph_model(20, 1, 28, 6, rng, cuda)
    batches = [torch.from_numpy(_codes(200 + 7 * i, 28, 256, rng)).to(cuda)
               for i in range(4)]
    want = [model.predict_margin(c) for c in batches]
    cache = inference.PredictCache()
    model.predict_margin(batches[0], mode="cached", cache=cache)
    errors = []

    def serve(i):
        for _ in range(25):
            got = model.predict_margin(batches[i], mode="cached",
                                       cache=cache)
            if not torch.equal(got, want[i]):
                errors.append(i)

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert cache.stats()["traces"] == 1 and cache.stats()["replays"] == 101


def test_capture_while_another_thread_replays(cuda):
    """``publish`` warms a new bucket (a capture) while the server thread
    replays a warm one: both succeed and stay bit-equal."""
    import threading

    from repro_torch.core import inference

    rng = np.random.default_rng(5)
    model = _graph_model(16, 1, 28, 6, rng, cuda)
    warm = torch.from_numpy(_codes(256, 28, 256, rng)).to(cuda)
    want = model.predict_margin(warm)
    cache = inference.PredictCache()
    model.predict_margin(warm, mode="cached", cache=cache)
    stop, errors = threading.Event(), []

    def serve():
        while not stop.is_set():
            if not torch.equal(model.predict_margin(warm, mode="cached",
                                                    cache=cache), want):
                errors.append("replay")

    t = threading.Thread(target=serve)
    t.start()
    try:
        for n in (600, 1500, 5000):
            codes = torch.from_numpy(_codes(n, 28, 256, rng)).to(cuda)
            assert torch.equal(model.predict_margin(codes, mode="cached",
                                                    cache=cache),
                               model.predict_margin(codes))
    finally:
        stop.set()
        t.join()
    assert not errors and cache.stats()["traces"] == 4


def test_trees_past_the_row_raise_at_load(cuda):
    from repro_torch.core import inference

    rng = np.random.default_rng(6)
    model = _graph_model(4, 1, 40, 4, rng, cuda)
    codes = torch.from_numpy(_codes(300, 28, 256, rng)).to(cuda)
    cache = inference.PredictCache()
    with pytest.raises(ValueError, match="splits on field"):
        model.predict_margin(codes, mode="cached", cache=cache)
    assert cache.stats()["traces"] == 0


# --------------------------------------------------------------------------
# the training variants on the card
# --------------------------------------------------------------------------
def _grower_case(n, F, n_bins, K, rng, packed=None):
    """A dataset on the CPU (its last field categorical) and dyadic (K, n)
    statistics, so every order of summation is exact."""
    codes = _codes(n, F, n_bins, rng)
    codes[:, -1] %= 3
    is_cat = np.arange(F) == F - 1
    data = binning.dataset_from_codes(codes, is_cat, n_bins, packed=packed,
                                      device="cpu")
    g = torch.from_numpy(rng.integers(-64, 64, (K, n)) / 64).float()
    h = torch.from_numpy(rng.integers(1, 64, (K, n)) / 64).float()
    common = dict(n_bins=n_bins, missing_bin=n_bins - 1,
                  is_cat_field=torch.from_numpy(is_cat),
                  field_mask=torch.ones(F, dtype=torch.bool), lambda_=1.0,
                  gamma=0.0, min_child_weight=0.5)
    return data, g, h, common


def _on(common, device):
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v
            for k, v in common.items()}


@pytest.mark.parametrize("K", [1, 4])
def test_subtraction_level_on_card_bit_equal_to_direct(cuda, K, monkeypatch):
    """Masked statistics in one class-batched launch at K > 1, the
    smaller children compacted into n // 2 records at K = 1: either way
    the level's histogram equals the direct pass on dyadic stats."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(40 + K)
    n, F = 20_001, 28
    codes = torch.from_numpy(_codes(n, F, 256, rng)).to(cuda)
    g, h, parent = _dyadic_stats(K, n, 8, rng, cuda)
    if K == 1:
        g, h, parent = g[None], h[None], parent[None]
    child = (2 * parent + torch.randint(0, 2, parent.shape, device=cuda,
                                        dtype=torch.int32)).contiguous()
    plan = ExecutionPlan().resolved()
    parent_hist = ops.build_histogram(codes, g, h, parent, n_nodes=8,
                                      n_bins=256, plan=plan)
    seen = []
    real = hist_k.histogram_cuda

    def spy(codes, g, *a, **kw):
        seen.append((codes.shape[0], tuple(g.shape)))
        return real(codes, g, *a, **kw)

    def level(codes, g, h, child, parent_hist):
        records = tree_mod.ResidentRecords(codes, None, g, h, n_bins=256,
                                           missing_bin=255, plan=plan)
        records.node_ids = child
        return tree_mod.subtract_level_hist(records, parent_hist, 16)

    monkeypatch.setattr(hist_k, "histogram_cuda", spy)
    got = level(codes, g, h, child, parent_hist)
    assert seen == ([(n, (K, n))] if K > 1 else [(n // 2, (n // 2,))])
    direct = ops.build_histogram(codes, g, h, child, n_nodes=16, n_bins=256,
                                 plan=plan)
    assert torch.equal(got, direct)
    plain = level(codes.cpu(), g.cpu(), h.cpu(), child.cpu(),
                  parent_hist.cpu())
    assert torch.equal(got.cpu(), plain)


@pytest.mark.parametrize("K,packed", [(1, False), (4, False), (1, True)])
def test_subtraction_grower_on_card_matches_direct(cuda, K, packed):
    rng = np.random.default_rng(50 + K)
    data, g, h, common = _grower_case(30_000, 20, 16 if packed else 64, K,
                                      rng, packed=packed)
    dev = data.to(cuda)
    kw = dict(depth=5, **_on(common, cuda))
    args = (dev.codes, dev.codes_cm, g.to(cuda), h.to(cuda))
    sub = tree_mod.fit_forest(*args, plan=ExecutionPlan(
        hist_subtraction=True), **kw)
    direct = tree_mod.fit_forest(*args, plan=ExecutionPlan(), **kw)
    cpu = tree_mod.fit_forest(data.codes, data.codes_cm, g, h, depth=5,
                              plan=ExecutionPlan(hist_subtraction=True),
                              **common)
    for a, b, c in zip(sub, direct, cpu):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


def test_lossguide_on_packed_codes_on_card(cuda):
    """The lossguide grower reads its predicate column from the packed
    column-major copy (one row unpacked) and bins each node with the nibble
    kernel at one node: 1 + splits launches; its tree equals the CPU's on
    dyadic stats."""
    rng = np.random.default_rng(60)
    data, g, h, common = _grower_case(40_000, 115, 16, 1, rng, packed=True)
    dev = data.to(cuda)
    assert isinstance(dev.codes_cm, PackedCodes)
    _build.reset_launch_counts()
    card = tree_mod.fit_tree_lossguide(dev.codes, dev.codes_cm, g[0].to(cuda),
                                       h[0].to(cuda), depth=6, max_leaves=20,
                                       **_on(common, cuda))
    counts = _build.launch_counts()
    splits = int((card.feature >= 0).sum())
    assert 1 <= splits <= 19
    assert counts["histogram_nibble"] == 1 + splits
    cpu = tree_mod.fit_tree_lossguide(data.codes, data.codes_cm, g[0], h[0],
                                      depth=6, max_leaves=20, **common)
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)


def test_host_split_offload_on_card_matches_device(cuda):
    rng = np.random.default_rng(61)
    data, g, h, common = _grower_case(5000, 12, 32, 3, rng)
    codes = data.codes.to(cuda)
    nid = torch.from_numpy(rng.integers(0, 4, (3, 5000)).astype(np.int32))
    hist = hist_k.histogram_cuda(codes, g.to(cuda), h.to(cuda), nid.to(cuda),
                                 n_nodes=4, n_bins=32).reshape(12, 12, 32, 2)
    c = _on(common, cuda)
    args = (hist, c["is_cat_field"], c["field_mask"], 1.0, 0.0, 0.5)
    host = splits.find_best_splits_host(*args)
    dev = splits.find_best_splits(*args)
    for name, a, b in zip(dev._fields, host, dev):
        assert a.device == b.device and torch.equal(a, b), name


# --------------------------------------------------------------------------
# step ②: the split-search kernel against its plain version
# --------------------------------------------------------------------------
def _dyadic_level_hist(lead, F, NB, rng, zero_frac=0.3):
    """A (*lead, F, NB, 2) float32 level histogram of dyadic g, h (every
    partial sum exact in float32), 30 % of its bins empty (numeric ties at
    consecutive bins)."""
    g = rng.integers(-64, 64, lead + (F, NB)) / 64
    h = rng.integers(0, 64, lead + (F, NB)) / 64
    empty = rng.uniform(size=g.shape) < zero_frac
    g[empty] = 0.0
    h[empty] = 0.0
    return np.stack([g, h], -1).astype(np.float32)


def _split_case(case, KNN, F, NB, rng):
    """(hist, is_cat, mask, min_child_weight) of one kernel-parity case."""
    hist = _dyadic_level_hist((KNN,), F, NB, rng)
    is_cat = np.zeros(F, bool)
    mask = np.ones(F, bool)
    mcw = 0.5
    if case == "cat_mask":
        is_cat = rng.uniform(size=F) < 0.4
        mask = rng.uniform(size=F) < 0.7
        mask[0] = False                 # the parent's field may be masked
    elif case == "refused":
        is_cat = rng.uniform(size=F) < 0.4
        mcw = 1e9                       # every candidate refused
    elif case == "ties":
        # every field a copy of field 0: the best ties across all fields
        # (and so across warps); categorical copies with bins in equal
        # pairs tie across bins
        hist[:] = hist[:, :1]
        is_cat = np.arange(F) % 2 == 1
        hist[:, 1::2, 1:NB - 1:2] = hist[:, 1::2, 0:NB - 2:2]
    return hist, is_cat, mask, mcw


@pytest.mark.parametrize("case", ["numeric", "cat_mask", "refused", "ties"])
@pytest.mark.parametrize("NB", [256, 16])
@pytest.mark.parametrize("F", [28, 54, 115])
@pytest.mark.parametrize("KNN", [1, 32, 224])
def test_split_kernel_bit_equal_to_plain(cuda, KNN, F, NB, case):
    """On dyadic histograms the kernel's eight decision arrays equal the
    plain version's bit for bit, in one launch; ties take the first bin,
    then the first field; a refused node reads gain -1, feature 0,
    threshold 0."""
    rng = np.random.default_rng(KNN * 1000 + F * 10 + NB)
    hist, is_cat, mask, mcw = _split_case(case, KNN, F, NB, rng)
    args = (torch.from_numpy(hist).to(cuda), torch.from_numpy(is_cat).to(cuda),
            torch.from_numpy(mask).to(cuda), 1.0, 0.0, mcw)
    before = _build.launch_counts()["split_level"]
    got = splits.find_best_splits(*args)
    assert _build.launch_counts()["split_level"] == before + 1
    want = splits.find_best_splits_plain(*args)
    for name, a, b in zip(want._fields, got, want):
        assert a.shape == (KNN,) and a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    if case == "refused":
        assert torch.equal(got.gain, torch.full_like(got.gain, -1.0))
        assert not got.feature.any() and not got.threshold.any()
    if case == "ties":
        # the first numeric copy (field 0) or the first categorical one
        assert bool(((got.feature == 0) | (got.feature == 1)).all())


@pytest.mark.parametrize("flags", ["bool", "int32"])
def test_split_kernel_takes_field_flags_as_given(cuda, flags):
    """Bool and int32 field flags read alike; is_cat echoes the flag."""
    rng = np.random.default_rng(7)
    hist, is_cat, mask, mcw = _split_case("cat_mask", 16, 28, 256, rng)
    dtype = torch.bool if flags == "bool" else torch.int32
    args = (torch.from_numpy(hist).to(cuda),
            torch.from_numpy(is_cat).to(cuda, dtype),
            torch.from_numpy(mask).to(cuda, dtype), 1.0, 0.25, mcw)
    got = splits.find_best_splits(*args)
    want = splits.find_best_splits_plain(*args)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name


def _level_hists(K, depth, F, NB, rng):
    """One dyadic (K, 2^L, F, NB, 2) histogram a level, with a quarter of
    the nodes below the root empty (every candidate refused: a new
    leaf)."""
    out = []
    for level in range(depth):
        hist = _dyadic_level_hist((K, 2 ** level), F, NB, rng)
        if level > 0:
            hist[rng.uniform(size=(K, 2 ** level)) < 0.25] = 0.0
        out.append(torch.from_numpy(hist))
    return out


def _fresh_state(K, depth, device):
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.full((K, 2 ** depth - 1), -1, **i32),
            torch.zeros((K, 2 ** depth - 1), **i32),
            torch.zeros((K, 2 ** depth - 1), **i32),
            torch.zeros((K, 2 ** depth - 1), **i32),
            torch.zeros((K, 2 ** depth), dtype=torch.float32, device=device),
            torch.zeros((K, 2 ** depth), dtype=torch.bool, device=device))


@pytest.mark.parametrize("K,F,NB", [(1, 28, 256), (7, 54, 256),
                                    (3, 115, 16)])
def test_split_fold_leaves_the_plain_tables(cuda, K, F, NB):
    """The fused search and fold of ``decide_level`` leave the same six
    tables, decisions and split mask as the plain search and fold, level
    after level (resolved nodes included), one launch a level."""
    depth = 5
    rng = np.random.default_rng(K + F)
    hists = _level_hists(K, depth, F, NB, rng)
    is_cat = torch.from_numpy(np.arange(F) % 5 == 4).to(cuda)
    mask = torch.from_numpy(rng.uniform(size=F) < 0.9).to(cuda)
    fused, plain = _fresh_state(K, depth, cuda), _fresh_state(K, depth, cuda)
    for level, hist in enumerate(hists):
        hist = hist.to(cuda)
        before = _build.launch_counts()["split_level"]
        fused, best, split = tree_mod.decide_level(
            hist, level, depth, fused, is_cat, mask, 1.0, 0.0, 0.5)
        assert _build.launch_counts()["split_level"] == before + 1
        plain, want, want_split = tree_mod.decide_level(
            hist, level, depth, plain, is_cat, mask, 1.0, 0.0, 0.5,
            find=splits.find_best_splits_plain)
        assert torch.equal(split, want_split), level
        for name, a, b in zip(want._fields, best, want):
            assert a.shape == (K, 2 ** level) and torch.equal(a, b), name
        for i, (a, b) in enumerate(zip(fused, plain)):
            assert torch.equal(a, b), (level, i)
    assert bool(plain[5].any())            # leaves settled on the way
    assert bool((plain[0] < 0).any()) and bool((plain[0] >= 0).any())


def test_split_kernel_replays_from_a_cuda_graph(cuda):
    """Search and fold captured in a CUDA graph: a replay on new histogram
    values gives what an eager launch gives on them."""
    K, F, NB, depth, level = 7, 54, 256, 6, 5
    rng = np.random.default_rng(3)
    is_cat = torch.from_numpy(np.arange(F) >= 10).to(cuda)
    mask = torch.ones(F, dtype=torch.bool, device=cuda)
    hist = torch.from_numpy(
        _dyadic_level_hist((K, 2 ** level), F, NB, rng)).to(cuda)
    state = _fresh_state(K, depth, cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):       # warm: the library loads eagerly
        tree_mod.decide_level(hist, level, depth,
                              _fresh_state(K, depth, cuda), is_cat, mask,
                              1.0, 0.0, 0.5)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _, best, split = tree_mod.decide_level(
            hist, level, depth, state, is_cat, mask, 1.0, 0.0, 0.5)
        search = splits.find_best_splits(hist.reshape(-1, F, NB, 2), is_cat,
                                         mask, 1.0, 0.0, 0.5)
    for trial in range(2):
        new = _dyadic_level_hist((K, 2 ** level), F, NB, rng)
        new[rng.uniform(size=(K, 2 ** level)) < 0.25] = 0.0
        hist.copy_(torch.from_numpy(new))
        fresh = _fresh_state(K, depth, cuda)
        for t, f in zip(state, fresh):
            t.copy_(f)
        graph.replay()
        torch.cuda.synchronize()
        want_state, want, want_split = tree_mod.decide_level(
            hist, level, depth, fresh, is_cat, mask, 1.0, 0.0, 0.5,
            find=splits.find_best_splits_plain)
        assert torch.equal(split, want_split), trial
        for name, a, b in zip(want._fields, best, want):
            assert torch.equal(a, b), (trial, name)
        for name, a, b in zip(want._fields, search, want):
            assert torch.equal(a, b.reshape(-1)), (trial, name)
        for a, b in zip(state, want_state):
            assert torch.equal(a, b), trial


def test_fit_forest_launches_the_split_kernel_once_a_level(cuda,
                                                           monkeypatch):
    """One ``split_level`` launch a level of a tree-growing call, and no
    plain split search on the card."""
    rng = np.random.default_rng(64)
    data, g, h, common = _grower_case(20_000, 28, 256, 3, rng)
    dev = data.to(cuda)
    cpu = tree_mod.fit_forest(data.codes, data.codes_cm, g, h, depth=6,
                              **common)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA histogram took the plain split search")

    monkeypatch.setattr(splits, "find_best_splits_plain", refuse)
    _build.reset_launch_counts()
    card = tree_mod.fit_forest(dev.codes, dev.codes_cm, g.to(cuda),
                               h.to(cuda), depth=6, **_on(common, cuda))
    assert _build.launch_counts()["split_level"] == 6
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)


def test_goss_weights_on_card_match_cpu(cuda):
    rng = np.random.default_rng(62)
    g = torch.from_numpy((rng.integers(-20, 21, (50_000, 3)) / 8)
                         .astype(np.float32))
    pick = gbdt.goss_pick(50_000, 0.2, 0.1,
                          torch.Generator(device=cuda).manual_seed(1))
    assert pick.device.type == "cuda"
    card = gbdt.goss_weights(g.to(cuda), None, 0.2, 0.1, pick=pick)
    cpu = gbdt.goss_weights(g, None, 0.2, 0.1, pick=pick.cpu())
    assert torch.equal(card.cpu(), cpu)


def _variant_fit_data(K, n):
    """Card data whose labels split evenly (two halves, or K equal
    classes): the base margin is then 0, round 0's g and h are dyadic and
    its histograms exact in any order of summation, so round 0's trees of
    two fits agree bit for bit."""
    X, score, _ = make_tabular(n, 10, 0, missing_rate=0.05, seed=7)
    rank = np.argsort(np.argsort(score, kind="stable"), kind="stable")
    y = (rank * (K or 2) // n).astype(np.float32)
    b = binning.Binner(64).fit(X)
    return b.transform(X), y


FUSED_CARD_CASES = {
    "logistic": (dict(objective="binary:logistic"), {}),
    "stochastic": (dict(objective="binary:logistic", subsample=0.7,
                        colsample_bytree=0.6), {}),
    # GOSS samples by rank of |g|: where the atomics' order moves a margin
    # by an ulp, two records of nearly equal |g| can swap ranks and the
    # sample with them, so both fits drift apart by a few records' weight;
    # at 10^6 records that stays far below the tolerance
    "goss": (dict(objective="binary:logistic", goss_top_rate=0.2,
                  goss_other_rate=0.1), {}),
    "squared": (dict(objective="reg:squarederror"), {}),
    "subtraction": (dict(objective="binary:logistic"),
                    dict(hist_subtraction=True)),
    "softmax_sub": (dict(objective="multi:softmax", n_classes=4),
                    dict(hist_subtraction=True)),
}


@pytest.mark.parametrize("case", sorted(FUSED_CARD_CASES))
def test_fused_fit_on_card_matches_host_loop(cuda, case):
    """One CUDA graph a round against the host loop on the same data and
    draws: round 0's trees equal (its sums are exact), the losses within
    rtol 1e-4; the graph is captured once and replayed every later round,
    and its replays carry each kernel's launches of the round."""
    kw, plan_kw = FUSED_CARD_CASES[case]
    K = kw.get("n_classes")
    data, y = _variant_fit_data(K, 1_000_000 if case == "goss" else 20_000)
    plan = ExecutionPlan(**plan_kw)
    config = gbdt.GBDTConfig(n_trees=5, max_depth=4, seed=2, **kw)
    gbdt.round_step_cache_clear()
    host = gbdt.train(config, data, y, plan=plan)
    _build.reset_launch_counts()
    fused = gbdt.train(dataclasses.replace(config, fused_rounds=True), data,
                       y, plan=plan)
    counts = _build.launch_counts()
    stats = fused.stats
    assert stats["fused_graph"]
    assert (stats["graph_captures"], stats["graph_replays"]) == (1, 4)
    launches = stats["launches"]
    assert launches["histogram"] == launches["partition"] == 4 * 5
    assert launches["traversal"] == 5
    # the wrappers counted the eager round and the capture, not replays
    assert counts["histogram"] == 2 * 4 and counts["traversal"] == 2
    Kt = K or 1
    for field in ("feature", "threshold", "is_cat"):
        assert torch.equal(getattr(fused.model.trees, field)[:Kt],
                           getattr(host.model.trees, field)[:Kt]), field
    np.testing.assert_allclose(fused.history["train_loss"],
                               host.history["train_loss"], rtol=1e-4)
    torch.testing.assert_close(fused.margins, host.margins, rtol=1e-4,
                               atol=1e-4)
    # a second fit of the same step key replays from its first round
    again = gbdt.train(dataclasses.replace(config, fused_rounds=True,
                                           seed=3), data, y, plan=plan).stats
    assert (again["graph_captures"], again["graph_replays"]) == (0, 5)


def test_fused_fit_on_packed_codes_on_card(cuda):
    """Fused rounds on 4-bit codes (the nibble histogram, partition and
    step ⑤ inside the graph): round 0 equal to the host loop's, the
    losses within rtol 1e-4, the nibble kernels' launches replayed."""
    X, score, _ = make_tabular(20_000, 9, 0, missing_rate=0.05, seed=8)
    rank = np.argsort(np.argsort(score, kind="stable"), kind="stable")
    y = (rank * 2 // len(rank)).astype(np.float32)
    data = binning.Binner(16).fit(X).transform(X)
    assert isinstance(data.codes, PackedCodes)
    config = gbdt.GBDTConfig(n_trees=4, max_depth=4,
                             objective="binary:logistic")
    gbdt.round_step_cache_clear()
    host = gbdt.train(config, data, y)
    fused = gbdt.train(dataclasses.replace(config, fused_rounds=True), data,
                       y)
    launches = fused.stats["launches"]
    assert launches["histogram_nibble"] == launches["partition_nibble"] \
        == 4 * 4 and launches["traversal"] == 4
    for field in ("feature", "threshold", "is_cat"):
        assert torch.equal(getattr(fused.model.trees, field)[0],
                           getattr(host.model.trees, field)[0]), field
    np.testing.assert_allclose(fused.history["train_loss"],
                               host.history["train_loss"], rtol=1e-4)


def test_fused_rounds_with_host_offload_run_eagerly(cuda):
    data, y = _variant_fit_data(None, 5000)
    config = gbdt.GBDTConfig(n_trees=3, max_depth=3,
                             objective="binary:logistic", fused_rounds=True)
    plan = ExecutionPlan(host_offload_split=True)
    res = gbdt.train(config, data, y, plan=plan)
    assert not res.stats["fused_graph"]
    host = gbdt.train(dataclasses.replace(config, fused_rounds=False), data,
                      y, plan=plan)
    np.testing.assert_allclose(res.history["train_loss"],
                               host.history["train_loss"], rtol=1e-4)


# --------------------------------------------------------------------------
# the out-of-core path: device binning, the pinned ring, the chunked grower
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_transform_chunk_on_card_bit_equal_to_host(cuda, dtype, monkeypatch):
    """A streamed chunk binned on the card (float64 edge tables) equals
    the host's ``transform_codes`` on every value: the edges' float32
    roundings, the values just below the edges, NaN, ±inf, ±0.0 and
    categorical values out of range."""
    import warnings

    rng = np.random.default_rng(0)
    n = 200_000
    X = rng.normal(size=(n, 5))
    X[:, 4] = rng.integers(-3, 12, size=n) + rng.uniform(-0.9, 0.9, size=n)
    b = binning.Binner(256, categorical_fields=[4]).fit(X)
    e = b._edges[0][np.isfinite(b._edges[0])]
    X[:254, 0] = e.astype(np.float32).astype(np.float64)[:254]
    X[:e.size, 1] = np.nextafter(e, -np.inf)
    X[254:262, 0] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e300, -1e300,
                     5e-324]
    X[262:274, 4] = [np.nan, np.inf, -np.inf, -0.0, 1e19, -1e19, 9e18,
                     -0.5, 3.99, 200, 2.0 ** 63, -2.0 ** 63]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        X = X.astype(dtype)
        want = b.transform_codes(X)
    got = b.transform_chunk(torch.from_numpy(X).to(cuda))
    assert got.is_cuda and torch.equal(got.cpu(), torch.from_numpy(want))
    monkeypatch.setattr(binning, "_BIN_BLOCK_BYTES", 4096)
    small = b.transform_chunk(torch.from_numpy(X).to(cuda))
    assert torch.equal(small, got)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_ring_delivers_every_chunk(cuda, depth):
    """Raw chunks staged in the pinned ring and uploaded on the copy stream
    reach the consumer intact, with the consumer slower than the uploads
    (a slot reused before its upload landed would corrupt a chunk), and
    ``close`` mid-pass stops the worker and runs the generator's
    ``finally``."""
    from repro_torch.data.pipeline import PrefetchIterator

    rng = np.random.default_rng(depth)
    chunks = [rng.normal(size=(50_000 + 17 * i, 9)).astype(np.float32)
              for i in range(12)]
    sums = []
    with PrefetchIterator(iter(chunks), device=cuda, depth=depth) as it:
        for x in it:
            torch.cuda._sleep(2_000_000)        # a slow consumer
            sums.append(x.double().sum(dim=0))
    for a, want in zip(sums, chunks):
        np.testing.assert_array_equal(a.cpu().numpy(),
                                      want.astype(np.float64).sum(axis=0))
    assert len(sums) == len(chunks)
    cleaned = []

    def gen():
        try:
            yield from chunks
        finally:
            cleaned.append(True)

    it = PrefetchIterator(gen(), device=cuda, depth=depth)
    first = next(it)
    assert torch.equal(first.cpu(), torch.from_numpy(chunks[0]))
    it.close()
    assert cleaned == [True] and not it._thread.is_alive()


@pytest.mark.parametrize("K,packed", [(1, False), (7, False), (1, True)])
def test_fit_forest_chunked_on_card_bit_equal_to_fit_forest(cuda, K,
                                                           packed):
    """On exact-grid statistics the chunked grower on the card grows the
    in-memory grower's trees and routes every record to the same leaf;
    the CPU's chunked grower agrees."""
    rng = np.random.default_rng(60 + K)
    n_bins = 16 if packed else 64
    data, g, h, common = _grower_case(40_000, 20, n_bins, K, rng,
                                      packed=packed)
    codes = np.asarray(data.codes)
    dev = data.to(cuda)
    kw = dict(depth=5, **_on(common, cuda))
    whole = tree_mod.fit_forest(dev.codes, dev.codes_cm, g.to(cuda),
                                h.to(cuda), **kw)

    def chunks(device):
        def it():
            for lo in range(0, 40_000, 9_000):
                c = torch.from_numpy(codes[lo:lo + 9_000]).to(device)
                yield lo, lo + c.shape[0], (PackedCodes.pack(c) if packed
                                            else c)
        return it

    _build.reset_launch_counts()
    card, ids = tree_mod.fit_forest_chunked(chunks(cuda), g, h, **kw)
    counts = _build.launch_counts()
    cpu, cpu_ids = tree_mod.fit_forest_chunked(chunks("cpu"), g, h, depth=5,
                                               **common)
    for a, b, c in zip(card, whole, cpu):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    assert torch.equal(ids.cpu(), cpu_ids)
    nib = "_nibble" if packed else ""
    assert counts["histogram" + nib] == 5 * 5          # levels x chunks
    assert counts["partition" + nib] == 5 * 5


@pytest.mark.parametrize("objective,K", [("reg:squarederror", None),
                                         ("multi:softmax", 3)])
def test_stream_on_card_matches_cpu(cuda, objective, K):
    """``train_streaming`` on the card against the CPU stream: round 0's
    split fields exact, losses to rtol 1e-5; the streamed margins of a
    warm start equal the direct predict bit for bit; the kernels launch
    once a chunk a level."""
    from repro_torch.data.pipeline import ArraySource

    X, y, cats = make_tabular(6000, 8, 2, n_cats=3, task="multiclass"
                              if K else "regression", n_classes=3,
                              missing_rate=0.05, seed=9)
    X = X.astype(np.float32)
    b = binning.Binner(64, cats).fit(X)
    cfg = gbdt.GBDTConfig(n_trees=3, max_depth=4, learning_rate=0.3,
                          objective=objective, n_classes=K)
    src = ArraySource(X, y)
    cpu = gbdt.train_streaming(cfg, src, b, y, chunk_rows=1500,
                               device="cpu")
    _build.reset_launch_counts()
    card = gbdt.train_streaming(cfg, src, b, y, chunk_rows=1500)
    counts = _build.launch_counts()
    assert counts["histogram"] == counts["partition"] == 3 * 4 * 4
    k = K or 1
    for field in ("feature", "is_cat"):
        assert torch.equal(getattr(card.model.trees, field)[:k].cpu(),
                           getattr(cpu.model.trees, field)[:k])
    np.testing.assert_allclose(card.history["train_loss"],
                               cpu.history["train_loss"], rtol=1e-5)
    data = b.transform(X)
    margins = card.model.predict_margin(data)
    assert torch.equal(margins, card.margins)
    warm = gbdt.train_streaming(dataclasses.replace(cfg, n_trees=1), src, b,
                                y, chunk_rows=2000, init_model=card.model)
    assert warm.model.n_rounds == 4
    assert torch.equal(warm.model.predict_margin(data), warm.margins)


def test_oom_halving_stream_on_card(cuda):
    """A device OOM during a streamed round on the card halves the chunk
    and replays the round; the fit holds the stream's contract against the
    fault-free one (round 0 exact, losses to rtol 1e-5)."""
    from repro_torch.data.pipeline import ArraySource
    from repro_torch.resilience import (DeviceOOMError, FaultSchedule,
                                        FaultySource, RecoveryPolicy)

    X, y, _ = make_tabular(8000, 10, 0, task="binary", seed=4)
    b = binning.Binner(64).fit(X)
    cfg = gbdt.GBDTConfig(n_trees=3, max_depth=4,
                          objective="binary:logistic")
    clean = gbdt.train_streaming(cfg, ArraySource(X, y), b, y,
                                 chunk_rows=2000)
    sched = FaultSchedule().add("source", 9, exc=DeviceOOMError)
    res = gbdt.train_streaming(cfg, FaultySource(ArraySource(X, y), sched),
                               b, y, chunk_rows=2000,
                               recovery=RecoveryPolicy(min_chunk_rows=256))
    assert res.stats["oom_halvings"] == 1 and res.stats["chunk_rows"] == 1000
    assert res.stats["n_chunks"] == 8
    assert torch.equal(res.model.trees.feature[0],
                       clean.model.trees.feature[0])
    np.testing.assert_allclose(res.history["train_loss"],
                               clean.history["train_loss"], rtol=1e-5)


# --------------------------------------------------------------------------
# the distributed path on one card (a mesh that repeats cuda:0)
# --------------------------------------------------------------------------
def _exact_grid(n, seed, device):
    rng = np.random.default_rng(seed)
    g = (rng.integers(-64, 65, n) / 64).astype(np.float32)
    h = (rng.integers(1, 65, n) / 64).astype(np.float32)
    return (torch.from_numpy(g).to(device), torch.from_numpy(h).to(device))


@pytest.mark.parametrize("D", [1, 4])
def test_distributed_schedule_on_card_bit_equal(cuda, D):
    """On a ("data",) mesh of D shards of the card, on exact-grid
    statistics: the histogram equals ``build_histogram`` with one launch a
    shard; the explicit and owner-evaluates trees and final node ids and
    ``pjit_fit_tree`` equal ``fit_forest`` bit for bit."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.kernels import ops

    mesh = make_mesh((D,), ("data",), devices=[cuda] * D)
    rng = np.random.default_rng(D)
    n, F, NB = 40_000, 9, 64
    codes = torch.from_numpy(_codes(n, F, NB, rng)).to(cuda)
    g, h = _exact_grid(n, D, cuda)
    nid = torch.from_numpy(rng.integers(0, 8, n).astype(np.int32)).to(cuda)
    _build.reset_launch_counts()
    hist = sharding.distributed_histogram(mesh, codes, g, h, nid, n_nodes=8,
                                          n_bins=NB)
    assert _build.launch_counts()["histogram"] == D
    assert torch.equal(hist, ops.build_histogram(codes, g, h, nid,
                                                 n_nodes=8, n_bins=NB))
    kw = dict(depth=5, n_bins=NB, missing_bin=NB - 1,
              is_cat_field=torch.zeros(F, dtype=torch.bool, device=cuda),
              field_mask=torch.ones(F, dtype=torch.bool, device=cuda),
              lambda_=1.0, gamma=0.0, min_child_weight=1.0)
    cm = codes.T.contiguous()
    want = tree_mod.fit_forest(codes, cm, g[None], h[None], **kw)
    for bits in (False, True):
        tree, ids = sharding.distributed_fit_tree(
            mesh, codes, cm, g, h, partition_bits=bits,
            return_node_ids=True, **kw)
        assert all(torch.equal(a, b[0]) for a, b in zip(tree, want))
        leaf = ref.traverse_forest_ref(want, codes, NB - 1)[:, 0]
        slot = torch.gather(want.leaf_value[0], 0, ids.long())
        assert torch.equal(slot, leaf)
    pj = sharding.pjit_fit_tree(mesh, **{k: v for k, v in kw.items()
                                         if k not in ("is_cat_field",
                                                      "field_mask")})
    assert all(torch.equal(a, b[0]) for a, b in zip(
        pj(codes, cm, g, h, kw["is_cat_field"], kw["field_mask"]), want))


@pytest.mark.parametrize("objective,K", [("binary:logistic", None),
                                         ("multi:softmax", 3)])
def test_train_distributed_on_card_matches_host_loop(cuda, objective, K):
    """``train_distributed`` at D = 1 and D = 4 on the card against the
    host loop: histogram and partition launched once a shard a level, no
    traversal (step ⑤ is a leaf lookup), round 0's split fields exact and
    losses within rtol 1e-4."""
    from repro_torch.distributed.trainer import train_distributed
    from repro_torch.launch.mesh import make_mesh

    X, y, cats = make_tabular(30_000, 8, 2, n_cats=3, task="multiclass"
                              if K else "binary", n_classes=3, seed=12)
    data = binning.Binner(64, cats).fit(X).transform(X)
    cfg = gbdt.GBDTConfig(n_trees=4, max_depth=4, objective=objective,
                          n_classes=K)
    host = gbdt.train(cfg, data, y)
    for D in (1, 4):
        _build.reset_launch_counts()
        res = train_distributed(cfg, data, y, mesh=make_mesh(
            (D,), ("data",), devices=[cuda] * D))
        counts = _build.launch_counts()
        assert counts["histogram"] == counts["partition"] == D * 4 * 4
        assert counts["traversal"] == 0
        k = K or 1
        assert torch.equal(res.model.trees.feature[:k],
                           host.model.trees.feature[:k])
        np.testing.assert_allclose(res.history["train_loss"],
                                   host.history["train_loss"], rtol=1e-4)
        assert torch.equal(res.model.predict_margin(data), res.margins)


def test_sharded_predict_on_card(cuda):
    """``sharded_predict`` on a (1, 4) ("data", "model") mesh of the card:
    one ensemble launch a shard, margins within rtol 1e-6 of
    ``predict_margin``, bit-equal on dyadic leaves."""
    import dataclasses as dc

    from repro_torch.core.inference import pad_trees, sharded_predict
    from repro_torch.launch.mesh import make_mesh

    X, y, _ = make_tabular(20_000, 10, 0, task="binary", seed=3)
    data = binning.Binner(64).fit(X).transform(X)
    model = gbdt.train(gbdt.GBDTConfig(n_trees=6, max_depth=5,
                                       objective="binary:logistic"),
                       data, y).model
    mesh = make_mesh((1, 4), ("data", "model"), devices=[cuda] * 4)
    _build.reset_launch_counts()
    out = sharded_predict(mesh, pad_trees(model, 4), data.codes)
    assert _build.launch_counts()["ensemble"] == 4
    torch.testing.assert_close(out, model.predict_margin(data), rtol=1e-6,
                               atol=1e-6)
    leaves = torch.from_numpy(np.random.default_rng(1).integers(
        -64, 65, model.trees.leaf_value.shape).astype(np.float32) / 64)
    dy = dc.replace(model, base_margin=0.25, trees=model.trees._replace(
        leaf_value=leaves.to(cuda)))
    assert torch.equal(sharded_predict(mesh, pad_trees(dy, 4), data.codes),
                       dy.predict_margin(data))


# -- missing values, 40-category fields, squared error: the CPU checks of
# tests/test_torch_mixed_fields.py, run on the card ------------------------
@pytest.mark.parametrize("seed", mixed_fields.SEEDS)
def test_mixed_fields_codes_on_card(cuda, seed):
    mixed_fields.check_codes(seed, cuda)


@pytest.mark.parametrize("seed", mixed_fields.SEEDS)
def test_mixed_fields_fit_on_card(cuda, seed):
    mixed_fields.check_fit(seed, cuda)


@pytest.mark.parametrize("way", ["left", "right"])
def test_mixed_fields_missing_direction_on_card(cuda, way):
    mixed_fields.check_missing_split(way, cuda)


@pytest.mark.parametrize("cat", [17, 39])
def test_mixed_fields_high_category_on_card(cuda, cat):
    mixed_fields.check_category_split(cat, cuda)


def test_mixed_fields_split_counters_on_card(cuda):
    mixed_fields.check_counters(cuda)
