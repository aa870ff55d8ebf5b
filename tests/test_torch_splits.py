"""Step ②'s semantics, pinned on the plain version.

On the card ``find_best_splits`` is one launch of the split-search kernel
(``csrc/splits.cu``), held bit-equal to :func:`find_best_splits_plain` in
``tests/test_torch_cuda.py``; these tests fix what both must do: ties go
to the first bin, then to the first field; the missing bin goes left only
when that is strictly better; a node with no admissible candidate reads
gain -1, feature 0, threshold 0; a categorical field's candidate is one
category against the rest.  A CPU histogram takes the plain version and
never counts a kernel launch.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import splits
from repro_torch.core import tree as tree_mod
from repro_torch.kernels import _build
from repro_torch.kernels import splits as split_k


def _hist(fields):
    """(1, F, NB, 2) float32 from per-field lists of (g, h) bins, the last
    the missing bin."""
    return torch.tensor([fields], dtype=torch.float32)


def _decide(hist, is_cat=None, mask=None, lambda_=1.0, gamma=0.0, mcw=0.0):
    F = hist.shape[1]
    is_cat = torch.zeros(F, dtype=torch.bool) if is_cat is None else \
        torch.tensor(is_cat)
    mask = torch.ones(F, dtype=torch.bool) if mask is None else \
        torch.tensor(mask)
    return splits.find_best_splits(hist, is_cat, mask, lambda_, gamma, mcw)


def _gain(GL, HL, G, H, lambda_=1.0):
    GR, HR = G - GL, H - HL
    return 0.5 * (GL ** 2 / (HL + lambda_) + GR ** 2 / (HR + lambda_)
                  - G ** 2 / (H + lambda_))


# field 0: bin 0 sends the negative mass left, bins 1-2 are empty (their
# prefixes equal bin 0's, so they tie with it), bin 3 holds the rest
TIED_BINS = [(-2.0, 1.0), (0.0, 0.0), (0.0, 0.0), (2.0, 1.0), (0.0, 0.0)]


@pytest.mark.parametrize("empty_bins", [1, 2, 3])
def test_numeric_ties_over_bins_take_the_first_bin(empty_bins):
    bins = ([(-2.0, 1.0)] + [(0.0, 0.0)] * empty_bins + [(2.0, 1.0)]
            + [(0.0, 0.0)])
    d = _decide(_hist([bins]))
    assert int(d.threshold) == 0 and int(d.feature) == 0
    assert float(d.gain) == pytest.approx(_gain(-2.0, 1.0, 0.0, 2.0))


@pytest.mark.parametrize("first", [0, 1, 2, 3])
def test_categorical_ties_over_bins_take_the_first_bin(first):
    """Two categories with the same statistics give the same one-vs-rest
    gain, the best of the field: the first of them wins."""
    bins = [(2.0, 1.0)] * 5 + [(0.0, 0.0)]
    bins[first] = bins[first + 1] = (-3.0, 1.0)
    d = _decide(_hist([bins]), is_cat=[True])
    assert int(d.threshold) == first and int(d.is_cat) == 1
    assert float(d.gain) == pytest.approx(_gain(-3.0, 1.0, 0.0, 5.0))


@pytest.mark.parametrize("pair", [(0, 2), (1, 3), (2, 3)])
def test_ties_over_fields_take_the_first_field(pair):
    """Every field carries the node's records; the two best fields hold the
    same histogram, the others a weaker one: the first of the pair wins."""
    weak = [(-1.0, 1.0), (1.0, 1.0), (0.0, 0.0), (0.0, 0.0), (0.0, 0.0)]
    fields = [list(weak) for _ in range(4)]
    for f in pair:
        fields[f] = list(TIED_BINS)
    d = _decide(_hist(fields))
    assert int(d.feature) == pair[0] and int(d.threshold) == 0
    assert float(d.gain) == pytest.approx(_gain(-2.0, 1.0, 0.0, 2.0))


@pytest.mark.parametrize("missing,left", [
    ((0.0, 0.0), 0),          # nothing missing: both directions tie
    ((-1.0, 1.0), 1),         # missing records look like the left side
    ((1.0, 1.0), 0)])         # ... like the right side
def test_missing_goes_left_only_when_strictly_better(missing, left):
    bins = [(-2.0, 1.0), (2.0, 1.0), missing]
    d = _decide(_hist([bins]))
    assert int(d.default_left) == left and int(d.threshold) == 0
    hl = 1.0 + (missing[1] if left else 0.0)
    assert float(d.left_h) == hl
    G, H = sum(b[0] for b in bins), sum(b[1] for b in bins)
    gl = -2.0 + (missing[0] if left else 0.0)
    assert float(d.gain) == pytest.approx(_gain(gl, hl, G, H))


@pytest.mark.parametrize("refusal", ["min_child_weight", "field_mask",
                                     "empty_node"])
def test_a_node_without_candidates_reads_gain_minus_one(refusal):
    """Every candidate refused: gain -1, feature 0, threshold 0 (the
    argmax's first index), and the parent's sums still reported."""
    fields = [list(TIED_BINS), [(-1.0, 1.0), (1.0, 1.0), (0.0, 0.0),
                                (0.0, 0.0), (0.0, 0.0)]]
    kw = {}
    if refusal == "min_child_weight":
        kw["mcw"] = 1e9
    elif refusal == "field_mask":
        kw["mask"] = [False, False]
    else:
        fields = [[(0.0, 0.0)] * 5] * 2
        kw["mcw"] = 0.5
    d = _decide(_hist(fields), **kw)
    assert float(d.gain) == -1.0
    assert int(d.feature) == 0 and int(d.threshold) == 0
    assert float(d.node_g) == sum(b[0] for b in fields[0])
    assert float(d.node_h) == sum(b[1] for b in fields[0])


def test_masked_field_loses_to_any_open_one():
    weak = [(-1.0, 1.0), (1.0, 1.0), (0.0, 0.0), (0.0, 0.0), (0.0, 0.0)]
    d = _decide(_hist([list(TIED_BINS), weak]), mask=[False, True])
    assert int(d.feature) == 1 and float(d.gain) == pytest.approx(
        _gain(-1.0, 1.0, 0.0, 2.0))


@pytest.mark.parametrize("cat", [False, True])
def test_categorical_candidate_is_one_category_against_the_rest(cat):
    """Category 2 alone holds the negative mass: one-vs-rest isolates it
    (GL = its G alone), while "code <= t" cannot (its prefix at 2 still
    carries bins 0-1) and finds a smaller gain."""
    bins = [(1.0, 1.0), (1.0, 1.0), (-4.0, 1.0), (2.0, 1.0), (0.0, 0.0)]
    d = _decide(_hist([bins]), is_cat=[cat])
    G, H = 0.0, 4.0
    assert int(d.threshold) == 2 and int(d.is_cat) == int(cat)
    if cat:
        assert float(d.gain) == pytest.approx(_gain(-4.0, 1.0, G, H))
        assert float(d.left_h) == 1.0
    else:
        assert float(d.gain) == pytest.approx(_gain(-2.0, 3.0, G, H))
        assert float(d.left_h) == 3.0
        assert _gain(-2.0, 3.0, G, H) < _gain(-4.0, 1.0, G, H)


def test_cpu_histogram_takes_the_plain_version():
    """On the CPU ``find_best_splits`` is the plain version, and neither
    the search nor a tree-growing call counts a kernel launch."""
    rng = np.random.default_rng(5)
    hist = torch.from_numpy((rng.integers(0, 64, (6, 9, 32, 2)) / 64)
                            .astype(np.float32))
    is_cat = torch.from_numpy(np.arange(9) % 3 == 0)
    mask = torch.from_numpy(rng.uniform(size=9) < 0.8)
    _build.reset_launch_counts()
    got = splits.find_best_splits(hist, is_cat, mask, 1.0, 0.0, 0.5)
    want = splits.find_best_splits_plain(hist, is_cat, mask, 1.0, 0.0, 0.5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    n, F = 500, 9
    codes = torch.from_numpy(rng.integers(0, 32, (n, F)).astype(np.uint8))
    g = torch.from_numpy(rng.normal(size=(2, n)).astype(np.float32))
    h = torch.ones((2, n))
    tree_mod.fit_forest(codes, codes.T.contiguous(), g, h, depth=3,
                        n_bins=32, missing_bin=31, is_cat_field=is_cat,
                        field_mask=mask, lambda_=1.0, gamma=0.0,
                        min_child_weight=0.5)
    assert _build.launch_counts()["split_level"] == 0


def test_split_kernel_wrapper_refuses_a_cpu_histogram():
    hist = torch.zeros((2, 3, 8, 2))
    flags = torch.zeros(3, dtype=torch.bool)
    before = _build.launch_counts()["split_level"]
    with pytest.raises(ValueError, match="unsupported device"):
        split_k.split_level_cuda(hist, flags, flags, 1.0, 0.0, 0.0)
    assert _build.launch_counts()["split_level"] == before
