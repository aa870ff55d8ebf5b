"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports nothing of JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips (the kernels have no CPU mode).
Integer outputs are bit-equal; histograms bit-equal on dyadic g, h; the
ensemble sum, taken in another order, to rtol 1e-5.  Each class-batched
kernel is held against its plain version at K = 1 and K > 1, and each
kernel that reads 4-bit ``PackedCodes`` also against its uint8 twin.
"""
import numpy as np
import pytest
import torch

from repro_torch.api.plan import ExecutionPlan
from repro_torch.core import binning, gbdt
from repro_torch.core.binning import PackedCodes
from repro_torch.data import make_tabular
from repro_torch.kernels import _build, ref
from repro_torch.kernels import histogram as hist_k
from repro_torch.kernels import partition as part_k
from repro_torch.kernels import traversal as trav_k

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


def _layout(layout, n, F, NB, NN, shape, rng):
    """Codes and node ids of one test layout: ``random`` (10 % missing,
    nodes uniform), ``two`` (every code on bins 0-1, as two-category fields
    put them: many records of one code, merged before they are added),
    ``one_slot`` (every record in the last node, the others empty) or
    ``sparse`` (even nodes only: every other slot empty)."""
    codes = _codes(n, F, NB, rng)
    if layout == "two":
        codes = rng.integers(0, 2, (n, F)).astype(np.uint8)
    nid = rng.integers(0, NN, shape).astype(np.int32)
    if layout == "one_slot":
        nid[:] = NN - 1
    elif layout == "sparse":
        nid -= nid % 2
    return codes, nid


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
    # 512 slots of 16 bins leave 3 fields a tile: tiles start at fields 3
    # and 9, inside a packed byte
    (1001, 9, 512, 1),
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
    _, ft = hist_k.tile_shape(K * NN, F, 16)
    assert NN != 512 or ft % 2 == 1
    before = _build.launch_counts()
    got = hist_k.histogram_cuda(packed, g, h, nid, n_nodes=NN, n_bins=16)
    after = _build.launch_counts()
    assert after["histogram_nibble"] == before["histogram_nibble"] + 1
    assert after["histogram"] == before["histogram"]
    assert torch.equal(got, hist_k.histogram_plain(packed, g, h, nid, NN, 16))
    # bit-equal to the uint8 kernel on the same codes
    assert torch.equal(got, hist_k.histogram_cuda(codes, g, h, nid,
                                                  n_nodes=NN, n_bins=16))


@pytest.mark.parametrize("n,F,NB,NN,K", [
    (777, 13, 16, 4, 1), (5000, 28, 256, 32, 1), (5000, 28, 256, 1, 1),
    (3001, 54, 256, 32, 7), (1000, 5, 16, 2, 3)])
def test_naive_histogram_kernel_matches_plain(cuda, n, F, NB, NN, K):
    rng = np.random.default_rng(n + NN + K)
    codes = torch.from_numpy(_codes(n, F, NB, rng)).to(cuda)
    g, h, nid = _dyadic_stats(K, n, NN, rng, cuda)
    before = _build.launch_counts()["histogram_naive"]
    got = hist_k.histogram_naive_cuda(codes, g, h, nid, n_nodes=NN,
                                      n_bins=NB)
    assert _build.launch_counts()["histogram_naive"] == before + 1
    assert torch.equal(got, hist_k.histogram_plain(codes, g, h, nid, NN, NB))
    assert torch.equal(got, hist_k.histogram_cuda(codes, g, h, nid,
                                                  n_nodes=NN, n_bins=NB))


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


@pytest.mark.parametrize("K,depth,per_class", [(1, 6, False), (7, 6, False),
                                               (4, 3, True)])
def test_class_batched_traversal_kernel_matches_plain(cuda, K, depth,
                                                      per_class):
    rng = np.random.default_rng(K + depth)
    C, n = 54, 4099
    forest = _trees(K, depth, C, 256, rng, cuda)
    shape = (K, n, C) if per_class else (n, C)
    codes = torch.from_numpy(
        _codes(int(np.prod(shape[:-1])), C, 256, rng).reshape(shape)).to(cuda)
    before = _build.launch_counts()["traversal"]
    got = trav_k.traverse_forest_cuda(forest, codes, missing_bin=255)
    assert _build.launch_counts()["traversal"] == before + 1
    assert got.shape == (n, K)
    assert torch.equal(got, trav_k.traverse_forest_plain(forest, codes, 255))


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


def test_grouped_limits_read_from_the_card(cuda):
    """The limits that size a grouped launch come from the built kernel
    and the card, and leave room for the paths' bins and sort counters."""
    limits = hist_k.grouped_limits(cuda)
    props = torch.cuda.get_device_properties(cuda)
    assert limits.sms == props.multi_processor_count
    assert limits.blocks_per_sm >= 1 and limits.sort_node_bytes == 12
    assert 0 < limits.block_reserved < limits.block_shared \
        <= limits.sm_shared
    # Higgs's 28 fields of 256 bins fit one block (padded to 32 fields)
    assert 8 * 256 * 32 <= limits.budget
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
