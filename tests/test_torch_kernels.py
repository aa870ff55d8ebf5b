"""The port's kernel modules against the JAX package, module by module.

Each plain PyTorch version (what the CUDA wrappers run for CPU tensors) is
held against ``repro.kernels.ref`` and against the Pallas kernels in
interpret mode, on the same numpy inputs.  Integer outputs must be
bit-equal; histograms bit-equal on dyadic statistics and rtol 1e-5
otherwise; ensemble sums rtol 1e-5 (the tree sum is taken in another
order).  The kernels themselves are held against their plain versions on
the card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import tree as jax_tree
from repro.kernels import histogram as jax_hist
from repro.kernels import partition as jax_part
from repro.kernels import ref as jax_ref
from repro.kernels import traversal as jax_trav

from repro_torch.api.plan import ExecutionPlan
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import histogram as hist_k
from repro_torch.kernels import partition as part_k
from repro_torch.kernels import traversal as trav_k


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _hist_inputs(n, F, NB, NN, seed, dyadic):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, NB, (n, F)).astype(np.uint8)
    codes[:, -1] = NB - 1                      # an all-missing column
    if dyadic:
        g = (rng.integers(-64, 64, n) / 64).astype(np.float32)
        h = (rng.integers(1, 64, n) / 64).astype(np.float32)
    else:
        g = rng.normal(size=n).astype(np.float32)
        h = rng.uniform(0.1, 1.0, n).astype(np.float32)
    nid = rng.integers(0, NN, n).astype(np.int32)
    return codes, g, h, nid


def _hist_close(got, want, g, h, codes, nid, NN, NB):
    """rtol 1e-5 plus atol 1e-5 times the bin's sum of |g| (|h|): the
    float error of a reordered sum scales with the magnitudes summed."""
    mag = np.asarray(jax_ref.histogram_ref(
        jnp.asarray(codes), jnp.abs(jnp.asarray(g)), jnp.abs(jnp.asarray(h)),
        jnp.asarray(nid), NN, NB))
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-5 * mag)


HIST_CASES = [(64, 3, 8, 1), (777, 13, 16, 4), (515, 9, 256, 2),
              (300, 1, 4, 2)]


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("n,F,NB,NN", HIST_CASES)
def test_histogram_plain_matches_jax(n, F, NB, NN, dyadic):
    codes, g, h, nid = _hist_inputs(n, F, NB, NN, seed=n + F, dyadic=dyadic)
    got = ref.histogram_ref(_t(codes), _t(g), _t(h), _t(nid), NN, NB)
    assert got.shape == (NN, F, NB, 2) and got.dtype == torch.float32
    want_ref = jax_ref.histogram_ref(jnp.asarray(codes), jnp.asarray(g),
                                     jnp.asarray(h), jnp.asarray(nid), NN, NB)
    want_pallas = jax_hist.histogram_pallas(
        jnp.asarray(codes), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(nid), n_nodes=NN, n_bins=NB, interpret=True)
    for want in (want_ref, want_pallas):
        if dyadic:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _hist_close(got.numpy(), want, g, h, codes, nid, NN, NB)


def test_histogram_wrapper_takes_plain_version_on_cpu():
    codes, g, h, nid = _hist_inputs(333, 5, 16, 4, seed=1, dyadic=False)
    _build.reset_launch_counts()
    got = hist_k.histogram_cuda(_t(codes), _t(g), _t(h), _t(nid),
                                n_nodes=4, n_bins=16)
    want = hist_k.histogram_plain(_t(codes), _t(g), _t(h), _t(nid), 4, 16)
    assert torch.equal(got, want)
    assert _build.launch_counts()["histogram"] == 0


# What csrc/histogram.cu's kernels and an H100 SXM give
# (hist_grouped_limits): one block of 1,024 threads of the grouped kernel
# an SM (its registers), three of the naive kernel (its launch bounds), 12
# sort bytes a node, 132 SMs, 228 KB an SM, 1 KB of it kept a block, 227 KB
# a block at most.
H100 = hist_k.GroupedLimits(blocks_per_sm=1, naive_blocks_per_sm=3,
                            sort_node_bytes=12, sms=132, sm_shared=233_472,
                            block_reserved=1_024, block_shared=232_448)


def test_grouped_limits_budget():
    """Two naive blocks' bins an SM, one grouped block's; a sort block's
    counters for 19,370 nodes."""
    assert H100.budget == 233_472 // 2 - 1_024
    assert H100.grouped_budget == 232_448
    assert H100.max_sort_nodes == 232_448 // 12
    small = H100._replace(sm_shared=100_000, block_shared=40_000)
    assert small.budget == small.grouped_budget == 40_000


@pytest.mark.parametrize("n,K,NN,F,NB", [
    (10_000_000, 1, 1, 28, 256), (10_000_000, 1, 32, 28, 256),
    (581_012, 7, 32, 54, 256), (581_012, 7, 1, 54, 256),
    (2_000_000, 1, 32, 115, 16), (3000, 1, 8, 115, 256),
    (3000, 3, 512, 3, 256), (1, 1, 1, 1, 2), (777, 2, 3, 13, 15),
    # a block's share past 2^16 positions many times over
    (50_000_000, 1, 1, 28, 256)])
def test_grouped_geometry_covers_every_slot_and_field(n, K, NN, F, NB):
    geo = hist_k.grouped_geometry(n, K, NN, F, NB, H100)
    # bins: four [bin][field] word arrays, a tile's fields padded to a
    # multiple of 32 (lane l always on bank l); within 227 KB, one block an
    # SM
    assert geo.row % 32 == 0 and geo.field_tile <= geo.row < \
        geo.field_tile + 32
    assert geo.smem == 16 * (NB + 1) * geo.row + 20_480   # and the stages
    assert geo.smem <= 227 * 1024
    assert geo.smem + H100.block_reserved <= H100.sm_shared \
        or geo.n_ftiles == 1
    # the field tiles cover every field once, none empty
    assert (geo.n_ftiles - 1) * geo.field_tile < F <= \
        geo.n_ftiles * geo.field_tile
    assert geo.n_ftiles == 1 or geo.smem <= H100.grouped_budget
    # the blocks' shares cover every sorted (class, record) position, and
    # the blocks fit the card at once
    assert geo.blocks * geo.per_block >= K * n
    assert (geo.blocks - 1) * geo.per_block < K * n
    assert geo.blocks * geo.n_ftiles <= H100.blocks_per_sm * H100.sms
    # a block flushes at least every 2^16 positions, so no bin word
    # overflows, and not more often than that asks
    assert 1 <= geo.flush_every <= 2 ** 16
    assert geo.flush_every == min(geo.per_block, 2 ** 16)
    # the sort's blocks cover every record of a class; none at one slot
    if K * NN == 1:
        assert geo.sort_blocks == geo.sort_chunk == 0
    else:
        assert geo.sort_blocks * geo.sort_chunk >= n
        assert (geo.sort_blocks - 1) * geo.sort_chunk < n
        assert NN <= H100.max_sort_nodes
        assert NN * H100.sort_node_bytes <= H100.block_shared


def test_grouped_geometry_at_the_paths_shapes():
    """Higgs's 28 fields of 256 bins sit in one block (128 KB and 20 KB of
    stages, one block an SM, one wave of 132) whose share of 75,758
    positions passes 2^16, so it flushes every 2^16; Covertype's 54 pad to
    64 and would pass the budget, so they take two tiles of 27 (66 blocks
    each, shares of 61,623 positions: no flush but at slots' edges); IoT's
    115 fields of 16 bins one (32 KB and the stages); 115 fields of 256 bins
    four tiles of 29."""
    higgs = hist_k.grouped_geometry(10_000_000, 1, 32, 28, 256, H100)
    cover = hist_k.grouped_geometry(581_012, 7, 32, 54, 256, H100)
    iot = hist_k.grouped_geometry(2_000_000, 1, 32, 115, 16, H100)
    wide = hist_k.grouped_geometry(3000, 1, 8, 115, 256, H100)
    assert (higgs.n_ftiles, higgs.row, higgs.smem) == (1, 32, 152_064)
    assert (higgs.blocks, higgs.per_block) == (132, 75_758)
    assert higgs.flush_every == 2 ** 16
    assert (cover.n_ftiles, cover.field_tile, cover.row) == (2, 27, 32)
    assert (cover.blocks, cover.per_block) == (66, 61_623)
    assert cover.flush_every == cover.per_block
    assert (iot.n_ftiles, iot.row, iot.smem) == (1, 128, 55_296)
    assert iot.blocks == 132
    assert (wide.n_ftiles, wide.field_tile) == (4, 29)


def _flush_runs(offsets, per_block, flush_every, block):
    """The runs of sorted positions that block ``block`` adds between two
    flushes, walked as ``csrc/histogram.cu``'s ``for_each_slot`` and
    ``hist_grouped_kernel`` walk them: its share of the list cut at each
    slot's edge (``offsets``: the slots' exclusive scan, the total last),
    then every ``flush_every`` positions.  (slot, first, end) each."""
    p = block * per_block
    end = min(offsets[-1], p + per_block)
    runs, s = [], 0
    while p < end:
        while offsets[s + 1] <= p:
            s += 1
        e = min(end, offsets[s + 1])
        runs += [(s, a, min(e, a + flush_every))
                 for a in range(p, e, flush_every)]
        p = e
    return runs


@pytest.mark.parametrize("n,K,NN", [
    # one slot, shares past 2^16 positions; Higgs's deepest level; one
    # slot holding nearly every record; Covertype's classes
    (20_000_000, 1, 1), (10_000_000, 1, 32), (12_000_000, 1, 8),
    (581_012, 7, 32)])
def test_grouped_blocks_flush_every_2_16_positions(n, K, NN):
    """No block adds more than 2^16 sorted positions between two flushes,
    where its share holds more, and each run lies in one slot: the blocks'
    runs cover the sorted list once."""
    geo = hist_k.grouped_geometry(n, K, NN, 28, 256, H100)
    rng = np.random.default_rng(n + NN)
    sizes = rng.multinomial(K * n, rng.dirichlet(np.ones(K * NN) / 4))
    offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    runs = [r for b in range(geo.blocks)
            for r in _flush_runs(offsets, geo.per_block, geo.flush_every, b)]
    assert max(e - a for _, a, e in runs) <= 2 ** 16
    assert all(offsets[s] <= a < e <= offsets[s + 1] for s, a, e in runs)
    assert [a for _, a, _ in runs] == [0] + [e for _, _, e in runs][:-1]
    assert runs[-1][2] == K * n
    if n > 2 ** 16 * geo.blocks:
        assert geo.per_block > 2 ** 16 == geo.flush_every


@pytest.mark.parametrize("K", [None, 3])
@pytest.mark.parametrize("magnitude", [1e-25, 3e-4, 0.25, 1.0, 7.5, 2e20])
def test_fixed_point_scale_is_a_power_of_two_at_2_30(K, magnitude):
    """Each class's scale of g and of h is a power of two that puts the
    largest |g| (|h|) in [2^30, 2^31): the grid is at most 2^-30 of it and
    every record's value lands on an int32."""
    rng = np.random.default_rng(int(magnitude * 1e3) % 997 + (K or 0))
    shape = (1000,) if K is None else (K, 1000)
    g = torch.from_numpy(rng.normal(size=shape) * magnitude).float()
    h = torch.from_numpy(rng.uniform(0, 1, shape) * magnitude / 7).float()
    scale = hist_k.fixed_point_scale(g, h)
    assert scale.dtype == torch.float32
    assert scale.shape == shape[:-1] + (2,)
    mant, _ = torch.frexp(scale)
    assert torch.all(mant == 0.5)
    for i, stat in enumerate((g, h)):
        top = stat.abs().amax(-1).double() * scale[..., i].double()
        assert torch.all((2.0 ** 30 <= top) & (top < 2.0 ** 31))
        q = torch.round(stat.double() * scale[..., i, None].double())
        assert q.abs().max() < 2 ** 31


def test_fixed_point_scale_of_zero_nan_and_inf():
    """All-zero g gets a finite grid on which every record is 0; a NaN or
    infinite g gets scale 0, which the kernel turns into a NaN histogram;
    the other statistic and the other classes keep their grids."""
    g = torch.tensor([[0.0, -0.0, 0.0], [1.0, float("nan"), 0.5],
                      [2.0, float("inf"), 1.0], [1e-40, 0.0, -1e-42]])
    h = torch.tensor([[0.5, 0.25, 0.75]] * 4)
    scale = hist_k.fixed_point_scale(g, h)
    assert scale[0, 0] == 2.0 ** 126 and torch.all(g[0] * scale[0, 0] == 0)
    assert scale[1, 0] == scale[2, 0] == 0.0
    assert scale[3, 0] == 2.0 ** 126          # subnormal g: a coarse grid
    assert torch.all(torch.abs(g[3] * scale[3, 0]) < 1)
    assert torch.all(scale[:, 1] == 2.0 ** 31)
    one = hist_k.fixed_point_scale(g[1], h[1])
    assert one.shape == (2,) and torch.equal(one, scale[1])


def test_fixed_point_words_hold_2_16_extreme_adds():
    """The kernel's words at their extremes: 2^16 adds of the largest q of
    either sign (2^31 - 128 on the grid) keep the signed high word within
    int32 and the low word within uint32, and hi·2^16 + lo gives back the
    exact sum."""
    g = torch.tensor([1.9999999, -1.9999999], dtype=torch.float32)
    scale = hist_k.fixed_point_scale(g, g.abs())
    q = torch.round(g.double() * scale[0].double()).long()
    assert q.tolist() == [2 ** 31 - 128, -(2 ** 31 - 128)]
    hi, lo = q >> 16, q & 0xFFFF
    assert hi.tolist() == [2 ** 15 - 1, -2 ** 15] and lo.max() < 2 ** 16
    n = 2 ** 16
    hi_sum, lo_sum = hi * n, lo * n
    assert torch.all((-2 ** 31 <= hi_sum) & (hi_sum < 2 ** 31))
    assert torch.all((0 <= lo_sum) & (lo_sum < 2 ** 32))
    assert torch.equal(hi_sum * 2 ** 16 + lo_sum, q * n)


def _check_naive_geometry(n, K, NN, F, NB, limits):
    """The naive kernel's launch: flat [field][bin][2] bins of the tile's
    fields, unpadded, within the budget; field tiles only where one slot's
    bins of every field pass it; shares covering the K·n sorted positions
    in one wave; the sort as the grouped kernel's."""
    geo = hist_k.grouped_geometry(n, K, NN, F, NB, limits, naive=True)
    assert geo.row == geo.field_tile
    assert geo.smem == 8 * NB * geo.field_tile
    assert geo.smem <= limits.budget or geo.field_tile == 1
    assert (geo.n_ftiles == 1) == (8 * NB * F <= limits.budget)
    assert (geo.n_ftiles - 1) * geo.field_tile < F <= \
        geo.n_ftiles * geo.field_tile
    assert geo.blocks * geo.per_block >= K * n
    assert (geo.blocks - 1) * geo.per_block < K * n
    assert geo.blocks * geo.n_ftiles <= \
        limits.naive_blocks_per_sm * limits.sms
    assert geo.flush_every == geo.per_block    # flushed at slots' edges
    grouped = hist_k.grouped_geometry(n, K, NN, F, NB, limits)
    assert (geo.sort_blocks, geo.sort_chunk) == (grouped.sort_blocks,
                                                 grouped.sort_chunk)
    return geo


@pytest.mark.parametrize("n,K,NN,F,NB", [
    (10_000_000, 1, 1, 28, 256), (10_000_000, 1, 32, 28, 256),
    (3000, 1, 512, 28, 256), (777, 1, 4, 9, 16), (1, 1, 1, 1, 2),
    # class-batched slots (K x NN): 7 x 32 and 3 x 512 of 256 bins, 3 x 4
    # of 16 bins, 3 x 32 of one field
    (581_012, 7, 32, 54, 256), (3000, 3, 512, 3, 256), (3000, 3, 4, 5, 16),
    (3000, 3, 32, 1, 256),
    # K = 7 at 54 fields: one tile; 115 fields of 256 bins: three
    (581_012, 7, 1, 54, 256), (3000, 1, 8, 115, 256)])
def test_naive_geometry_fits_shared_memory(n, K, NN, F, NB):
    _check_naive_geometry(n, K, NN, F, NB, H100)


def test_naive_geometry_at_the_paths_shapes():
    """Higgs's 28 fields of 256 bins are one tile of 57,344 B (three blocks
    an SM, one wave); Covertype's 54 one tile of 110,592 B (two an SM); 115
    fields of 256 bins pass the 115,712 B budget, so three tiles of 39; the
    IoT shape's 115 fields of 16 bins, unpacked, one tile."""
    higgs = _check_naive_geometry(10_000_000, 1, 32, 28, 256, H100)
    cover = _check_naive_geometry(581_012, 7, 32, 54, 256, H100)
    wide = _check_naive_geometry(3000, 1, 8, 115, 256, H100)
    iot = _check_naive_geometry(2_000_000, 1, 32, 115, 16, H100)
    assert (higgs.n_ftiles, higgs.smem, higgs.blocks) == (1, 57_344, 3 * 132)
    assert (cover.n_ftiles, cover.smem, cover.blocks) == (1, 110_592, 2 * 132)
    assert H100.budget == 115_712
    assert (wide.n_ftiles, wide.field_tile, wide.smem) == (3, 39, 79_872)
    assert (iot.n_ftiles, iot.smem) == (1, 14_720)


H100_ENSEMBLE = trav_k.EnsembleLimits(threads=256, per_thread=2,
                                      blocks_per_sm=4, sm_shared=233_472,
                                      block_reserved=1_024,
                                      block_shared=232_448)


@pytest.mark.parametrize("depth", [1, 6, 10])
@pytest.mark.parametrize("F", [1, 28, 54, 115, 1000])
@pytest.mark.parametrize("n,T", [(10_000_000, 500), (581_012, 504),
                                 (3001, 13), (7, 1)])
def test_ensemble_geometry_fits_shared_memory(n, F, T, depth):
    """Staged rows of R records (a multiple of 32: lane l reads bank l) and
    TB trees within the block's shared memory, the budget of four blocks
    an SM wherever 32 rows fit it; R and TB no larger than n and T need."""
    L = H100_ENSEMBLE
    geo = trav_k.ensemble_geometry(n, F, T, depth, L)
    tree_bytes = 4 * ((2 << depth) - 1)
    row = 4 * -(-F // 4)
    assert geo.entry == "staged"
    assert geo.records % 32 == 0 and geo.records % geo.per_thread == 0
    assert geo.per_thread == L.per_thread
    assert 1 <= geo.threads <= L.threads
    assert geo.records <= max(32, 64 * -(-n // 64))
    assert 1 <= geo.trees <= T
    assert geo.smem == geo.records * row + geo.trees * tree_bytes
    assert geo.smem <= L.block_shared
    if 32 * row + tree_bytes <= L.budget:
        assert geo.smem <= L.budget


@pytest.mark.parametrize("F", [28, 54])
def test_ensemble_geometry_keeps_three_blocks_an_sm(F):
    """At the Higgs and Covertype widths a block stages 512 records (256
    threads of 2) and at least 16 trees, and four blocks fit an SM."""
    L = H100_ENSEMBLE
    geo = trav_k.ensemble_geometry(10_000_000, F, 500, 6, L)
    assert (geo.records, geo.per_thread, geo.threads) == (512, 2, 256)
    assert geo.trees >= trav_k.MIN_STAGED_TREES
    assert L.sm_shared // (geo.smem + L.block_reserved) >= 3
    iot = trav_k.ensemble_geometry(2_000_000, 115, 500, 6, L)
    assert iot.records == 384 and iot.trees >= trav_k.MIN_STAGED_TREES


@pytest.mark.parametrize("depth", [1, 6, 10])
def test_ensemble_geometry_wide_entry_exactly_past_the_staged_limit(depth):
    """32 records' rows plus one tree fill a block at the limit; one field
    more takes the wide entry (one record a thread, trees only)."""
    L = H100_ENSEMBLE
    tree_bytes = 4 * ((2 << depth) - 1)
    top = trav_k.max_staged_fields(depth, L)
    assert 32 * top + tree_bytes <= L.block_shared \
        < 32 * (top + 4) + tree_bytes
    at = trav_k.ensemble_geometry(100, top, 500, depth, L)
    assert at.entry == "staged" and at.records == 32 and at.trees >= 1
    assert at.smem <= L.block_shared
    past = trav_k.ensemble_geometry(100, top + 1, 500, depth, L)
    assert past.entry == "wide" and past.per_thread == 1
    assert past.records == past.threads == L.threads
    assert past.smem == past.trees * tree_bytes <= L.budget
    assert trav_k.ensemble_geometry(100, trav_k.MAX_FIELDS - 1, 500, depth,
                                    L).entry == "wide"


def test_ensemble_limits_budget():
    assert H100_ENSEMBLE.budget == 233_472 // 4 - 1_024
    small = H100_ENSEMBLE._replace(sm_shared=100_000, block_shared=20_000)
    assert small.budget == 20_000


def _splits(nn, n_cols, n_bins, rng, passthrough=True):
    f = rng.integers(-1 if passthrough else 0, n_cols, nn).astype(np.int32)
    thr = rng.integers(0, n_bins, nn).astype(np.int32)
    cat = rng.integers(0, 2, nn).astype(np.int32)
    dl = rng.integers(0, 2, nn).astype(np.int32)
    return f, thr, cat, dl


@pytest.mark.parametrize("n,nn,n_cols,n_bins", [
    (100, 1, 1, 8), (1000, 8, 8, 16), (1777, 16, 20, 256), (4096, 4, 3, 4)])
def test_partition_plain_matches_jax(n, nn, n_cols, n_bins):
    rng = np.random.default_rng(n)
    nid = rng.integers(0, nn, n).astype(np.int32)
    codes = rng.integers(0, n_bins, (n, n_cols)).astype(np.uint8)
    codes[rng.uniform(size=codes.shape) < 0.2] = n_bins - 1   # missing
    f, thr, cat, dl = _splits(nn, n_cols, n_bins, rng)
    got = ref.partition_ref(_t(nid), _t(codes), _t(f), _t(thr), _t(cat),
                            _t(dl), n_bins - 1)
    assert got.dtype == torch.int32
    args = [jnp.asarray(a) for a in (nid, codes, f, thr, cat, dl)]
    want_ref = jax_ref.partition_ref(*args, n_bins - 1)
    want_pallas = jax_part.partition_pallas(*args, missing_bin=n_bins - 1,
                                            interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pallas))
    for fn in (part_k.partition_cuda, ops.partition_level):
        out = fn(_t(nid), _t(codes), _t(f), _t(thr), _t(cat), _t(dl),
                 missing_bin=n_bins - 1)
        assert torch.equal(out, got)


@pytest.mark.parametrize("n,nn,F,n_bins", [(513, 4, 6, 16), (2000, 16, 28, 256)])
def test_partition_cm_plain_matches_jax_gather(n, nn, F, n_bins):
    """The column-major entry equals the grower's JAX step ③:
    ``_gather_fields`` of the split fields + ``partition_ref`` on the
    renumbered columns."""
    rng = np.random.default_rng(nn)
    nid = rng.integers(0, nn, n).astype(np.int32)
    codes_cm = rng.integers(0, n_bins, (F, n)).astype(np.uint8)
    codes_cm[0] = n_bins - 1                          # all-missing field
    f, thr, cat, dl = _splits(nn, F, n_bins, rng)
    got = part_k.partition_cm_plain(_t(nid), _t(codes_cm), _t(f), _t(thr),
                                    _t(cat), _t(dl), n_bins - 1)
    do_split = jnp.asarray(f >= 0)
    lvl = jax_tree._gather_fields(jnp.asarray(codes_cm),
                                  jnp.where(do_split, jnp.asarray(f), 0))
    want = jax_ref.partition_ref(
        jnp.asarray(nid), lvl.T,
        jnp.where(do_split, jnp.arange(nn, dtype=jnp.int32), -1),
        jnp.asarray(thr), jnp.asarray(cat), jnp.asarray(dl), n_bins - 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for fn in (part_k.partition_cm_cuda, ops.partition_level_cm):
        out = fn(_t(nid), _t(codes_cm), _t(f), _t(thr), _t(cat), _t(dl),
                 missing_bin=n_bins - 1)
        assert torch.equal(out, got)


def _random_trees(T, depth, n_cols, n_bins, seed):
    """Stacked (T, ...) numpy trees with pass-through nodes, categorical
    splits and both missing directions."""
    rng = np.random.default_rng(seed)
    n_int = 2 ** depth - 1
    return dict(
        feature=rng.integers(-1, n_cols, (T, n_int)).astype(np.int32),
        threshold=rng.integers(0, n_bins - 1, (T, n_int)).astype(np.int32),
        is_cat=rng.integers(0, 2, (T, n_int)).astype(np.int32),
        default_left=rng.integers(0, 2, (T, n_int)).astype(np.int32),
        leaf_value=rng.normal(size=(T, 2 ** depth)).astype(np.float32))


def _codes(n, C, n_bins, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, n_bins, (n, C)).astype(np.uint8)
    codes[rng.uniform(size=codes.shape) < 0.1] = n_bins - 1
    return codes


def _as(trees, mod, conv, index=None):
    pick = (lambda a: a) if index is None else (lambda a: a[index])
    return mod.TreeArrays(**{k: conv(pick(v)) for k, v in trees.items()})


def test_pack_node_table_matches_jax():
    trees = _random_trees(5, 4, 30, 256, seed=0)
    got = trav_k.pack_node_table(_as(trees, ref, _t))
    want = jax_trav.pack_node_table(_as(trees, jax_ref, jnp.asarray))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,depth,C,n_bins", [
    (1, 1, 1, 4), (777, 3, 5, 16), (2048, 6, 28, 256), (300, 4, 7, 8)])
def test_traverse_plain_matches_jax(n, depth, C, n_bins):
    trees = _random_trees(1, depth, C, n_bins, seed=depth)
    codes = _codes(n, C, n_bins, seed=n)
    got = ref.traverse_ref(_as(trees, ref, _t, 0), _t(codes), n_bins - 1)
    jt = _as(trees, jax_ref, jnp.asarray, 0)
    want_ref = jax_ref.traverse_ref(jt, jnp.asarray(codes), n_bins - 1)
    want_pallas = jax_trav.traverse_pallas(jt, jnp.asarray(codes),
                                           missing_bin=n_bins - 1,
                                           interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pallas))
    for fn in (trav_k.traverse_cuda, ops.traverse_tree):
        assert torch.equal(fn(_as(trees, ref, _t, 0), _t(codes),
                              missing_bin=n_bins - 1), got)


@pytest.mark.parametrize("n,T,depth,F,n_bins", [
    (513, 7, 3, 6, 16), (64, 1, 2, 3, 4), (1500, 13, 6, 28, 256)])
def test_ensemble_plain_matches_jax(n, T, depth, F, n_bins):
    trees = _random_trees(T, depth, F, n_bins, seed=T)
    trees["feature"][0] = -1                   # a pass-through tree
    codes = _codes(n, F, n_bins, seed=T + n)
    got = trav_k.predict_ensemble_plain(_as(trees, ref, _t), _t(codes),
                                        n_bins - 1)
    jt = _as(trees, jax_ref, jnp.asarray)
    want_ref = jax_ref.predict_ensemble_batched(jt, jnp.asarray(codes),
                                                n_bins - 1)
    # trees_per_block 4 does not divide T: the Pallas path pads the ensemble
    want_pallas = jax_trav.predict_ensemble_pallas(
        jt, jnp.asarray(codes), missing_bin=n_bins - 1, depth=depth,
        interpret=True, trees_per_block=4)
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    out = ops.predict_ensemble(_as(trees, ref, _t), _t(codes),
                               missing_bin=n_bins - 1, depth=depth)
    assert torch.equal(out, got)


def test_ensemble_plain_walks_in_record_blocks(monkeypatch):
    trees = _random_trees(5, 3, 4, 8, seed=2)
    codes = _codes(1000, 4, 8, seed=3)
    whole = trav_k.predict_ensemble_plain(_as(trees, ref, _t), _t(codes), 7)
    monkeypatch.setattr(trav_k, "PLAIN_ENTRIES", 2000)  # 2 trees a pass
    blocks = trav_k.predict_ensemble_plain(_as(trees, ref, _t), _t(codes), 7)
    assert torch.equal(whole, blocks)


def test_ensemble_leaf_choice_matches_per_tree_walk():
    """Integer leaves make the sum exact: the batched walk picks the same
    leaf as a one-tree walk, tree by tree."""
    trees = _random_trees(9, 4, 6, 16, seed=5)
    trees["leaf_value"] = np.round(trees["leaf_value"] * 4).astype(np.float32)
    codes = _t(_codes(700, 6, 16, seed=6))
    got = trav_k.predict_ensemble_plain(_as(trees, ref, _t), codes, 15)
    want = sum(ref.traverse_ref(_as(trees, ref, _t, i), codes, 15)
               for i in range(9))
    assert torch.equal(got, want)


def test_reference_plan_selects_plain_versions():
    codes, g, h, nid = _hist_inputs(200, 4, 8, 2, seed=9, dyadic=True)
    args = (_t(codes), _t(g), _t(h), _t(nid))
    a = ops.build_histogram(*args, n_nodes=2, n_bins=8,
                            plan=ExecutionPlan(hist_strategy="reference"))
    b = ops.build_histogram(*args, n_nodes=2, n_bins=8)
    assert torch.equal(a, b)


def test_plan_resolution_and_refusals():
    plan = ExecutionPlan().resolved()
    assert (plan.hist_strategy, plan.partition_strategy,
            plan.traversal_strategy) == ("cuda", "cuda", "cuda")
    assert ExecutionPlan(traversal_strategy="reference").resolved() \
        .traversal_strategy == "reference"
    with pytest.raises(ValueError):
        ExecutionPlan(hist_strategy="pallas_grouped")
    with pytest.raises(TypeError):
        ExecutionPlan(mesh=object())
    # class-batched statistics and multi-class ensembles are ported
    hist = ops.build_histogram(torch.zeros((8, 2), dtype=torch.uint8),
                               torch.ones((2, 8)), torch.ones((2, 8)),
                               torch.zeros((2, 8), dtype=torch.int32),
                               n_nodes=1, n_bins=4)
    assert hist.shape == (2, 1, 2, 4, 2) and float(hist[..., 0].sum()) \
        == 2 * 2 * 8
    margins = ops.predict_ensemble(_as(_random_trees(2, 2, 3, 4, 0), ref, _t),
                                   _t(_codes(8, 3, 4, 0)), missing_bin=3,
                                   depth=2, n_classes=3)
    assert margins.shape == (8, 3) and torch.all(margins[:, 2] == 0)


def test_library_names_carry_source_hash():
    paths = {name: _build._library_path(name) for name in _build.SOURCES}
    assert all(p.parent == _build.BUILD_DIR for p in paths.values())
    assert len({p.name for p in paths.values()}) == len(_build.SOURCES)
    assert all((_build.CSRC / f"{name}.cu").exists() for name in paths)
