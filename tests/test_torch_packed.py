"""4-bit packed codes in the port against the JAX package.

The counterparts of ``tests/test_packed_codes.py``: each case feeds the
same numpy inputs, made from a seed, to ``repro`` and ``repro_torch``
(plain versions on the CPU; Pallas kernels in interpret mode), at odd n
and odd F so that both layouts carry a pad nibble.  Tolerances:

* packed bytes, unpacked codes, node ids and tree structure: bit-equal;
* histograms: bit-equal on dyadic g, h; rtol 1e-5 on real ones;
* ``train``: leaves, losses and margins within rtol 1e-5 plus 1e-5 of the
  largest |value| (XLA's CPU ``log``/``exp`` and torch's differ in the
  last ulp, ROADMAP Queue 3); the port's packed fit bit-equal to its
  unpacked one.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JaxPlan
from repro.core import binning as jax_binning
from repro.core import gbdt as jax_gbdt
from repro.core import tree as jax_tree
from repro.kernels import histogram as jax_hist
from repro.kernels import ops as jax_ops
from repro.kernels import partition as jax_part
from repro.kernels import ref as jax_ref

from repro_torch.api.plan import ExecutionPlan
from repro_torch.core import binning, gbdt
from repro_torch.core.binning import PackedCodes
from repro_torch.kernels import _build, ops, ref

JAX_REFERENCE = JaxPlan(hist_strategy="scatter",
                        partition_strategy="reference",
                        traversal_strategy="reference")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=1e-5):
    """rtol plus ``rtol`` of the largest |want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _codes16(shape, seed):
    codes = np.random.default_rng(seed).integers(0, 16, shape).astype(np.uint8)
    codes.flat[0] = 15                             # the missing bin
    return codes


# -- the container -----------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (33, 15), (2, 17),
                                   (128, 28), (3, 5, 9)])
def test_pack_nibbles_bit_equal_to_jax(shape):
    codes = _codes16(shape, seed=sum(shape))
    n = shape[-1]
    want = np.asarray(jax_binning.pack_nibbles(jnp.asarray(codes)))
    got = binning.pack_nibbles(_t(codes))
    assert got.shape[-1] == (n + 1) // 2 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(binning.pack_nibbles_np(codes), want)
    np.testing.assert_array_equal(binning.unpack_nibbles(got, n).numpy(),
                                  codes)
    np.testing.assert_array_equal(
        binning.unpack_nibbles(got, n).numpy(),
        np.asarray(jax_binning.unpack_nibbles(jnp.asarray(want), n)))


def test_packed_codes_container_matches_jax():
    codes = _codes16((41, 9), seed=0)
    ours, theirs = (binning.PackedCodes.pack_np(codes),
                    jax_binning.PackedCodes.pack_np(codes))
    assert tuple(ours.shape) == theirs.shape == (41, 9)
    assert ours.ndim == theirs.ndim and ours.bits == theirs.bits == 4
    assert ours.dtype == torch.uint8 and ours.nbytes == theirs.nbytes == 41 * 5
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(theirs.data))
    np.testing.assert_array_equal(ours.unpack().numpy(), codes)
    # leading-axis gather keeps the packed form
    idx = np.array([3, 3, 40, 0])
    sel = ours[_t(idx)]
    assert isinstance(sel, PackedCodes) and sel.n == 9
    np.testing.assert_array_equal(sel.data.numpy(),
                                  np.asarray(theirs[idx].data))
    # numpy conversion gives the unpacked matrix, as repro's does
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
    assert np.asarray(ours, dtype=np.int32).dtype == np.int32
    # packing a tensor on its device gives the host packer's bytes
    assert torch.equal(PackedCodes.pack(_t(codes)).data, ours.data)
    assert ours.to("cpu").device == torch.device("cpu")
    plain = _t(codes)
    assert binning.as_unpacked(plain) is plain
    assert torch.equal(binning.as_unpacked(ours), plain)


@pytest.mark.parametrize("max_bins,packed", [(16, None), (16, True),
                                             (16, False), (17, None),
                                             (64, True)])
def test_dual_layout_matches_jax(max_bins, packed):
    rng = np.random.default_rng(max_bins)
    X = rng.normal(size=(257, 9))
    X[rng.uniform(size=X.shape) < 0.05] = np.nan
    if packed and max_bins > binning.PACK_MAX_BINS:
        for mod, kw in ((jax_binning, {}), (binning, {"device": "cpu"})):
            with pytest.raises(ValueError, match="packed codes need"):
                mod.bin_dataset(X, max_bins, packed=packed, **kw)
            with pytest.raises(ValueError, match="packed codes need"):
                mod.dataset_from_codes(np.zeros((4, 3)), n_bins=max_bins,
                                       packed=True, **kw)
        return
    theirs = jax_binning.bin_dataset(X, max_bins, packed=packed)
    ours = binning.bin_dataset(X, max_bins, packed=packed, device="cpu")
    want_packed = isinstance(theirs.codes, jax_binning.PackedCodes)
    assert want_packed == (max_bins <= 16 and packed is not False)
    for got, want in ((ours.codes, theirs.codes),
                      (ours.codes_cm, theirs.codes_cm)):
        assert isinstance(got, PackedCodes) == want_packed
        raw = got.data if want_packed else got
        np.testing.assert_array_equal(
            raw.numpy(), np.asarray(want.data if want_packed else want))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert (ours.n_records, ours.n_fields) == (theirs.n_records,
                                               theirs.n_fields) == (257, 9)
    assert ours.to("cpu") is ours
    d = binning.dataset_from_codes(np.asarray(theirs.codes), None, max_bins,
                                   packed=packed, device="cpu")
    assert isinstance(d.codes_cm, PackedCodes) == want_packed
    np.testing.assert_array_equal(np.asarray(d.codes_cm),
                                  np.asarray(theirs.codes_cm))


# -- step ① -------------------------------------------------------------------
def _stats(K, n, NN, seed, dyadic):
    rng = np.random.default_rng(seed)
    if dyadic:
        g = (rng.integers(-64, 64, (K, n)) / 64).astype(np.float32)
        h = (rng.integers(1, 64, (K, n)) / 64).astype(np.float32)
    else:
        g = rng.normal(size=(K, n)).astype(np.float32)
        h = rng.uniform(0.5, 2.0, (K, n)).astype(np.float32)
    nid = rng.integers(0, NN, (K, n)).astype(np.int32)
    if K == 1:
        return g[0], h[0], nid[0]
    return g, h, nid


def _assert_hist(got, want, dyadic):
    if dyadic:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("K", [1, 3])
def test_packed_histogram_matches_jax(K, dyadic):
    """The nibble branch of ``histogram_pallas`` (interpret mode) against
    the port's ``build_histogram`` on the same PackedCodes."""
    n, F, NB, NN = 257, 9, 16, 4
    codes = _codes16((n, F), seed=K)
    g, h, nid = _stats(K, n, NN, seed=K + 7, dyadic=dyadic)
    jpc = jax_binning.PackedCodes.pack_np(codes)
    want = jax_hist.histogram_pallas(jpc, *[jnp.asarray(a) for a in (g, h,
                                                                     nid)],
                                     n_nodes=NN, n_bins=NB, interpret=True)
    pc = PackedCodes.pack_np(codes)
    _build.reset_launch_counts()
    for plan in (ExecutionPlan(hist_strategy="reference"), None):
        got = ops.build_histogram(pc, _t(g), _t(h), _t(nid), n_nodes=NN,
                                  n_bins=NB, plan=plan)
        assert got.shape == ((NN, F, NB, 2) if K == 1
                             else (K, NN, F, NB, 2))
        _assert_hist(got, want, dyadic)
        # the packed and the uint8 layout give one histogram, bit for bit
        assert torch.equal(got, ops.build_histogram(
            _t(codes), _t(g), _t(h), _t(nid), n_nodes=NN, n_bins=NB,
            plan=plan))
    assert not any(_build.launch_counts().values())  # CPU: plain versions


@pytest.mark.parametrize("K", [1, 3])
def test_cuda_packed_route_matches_jax(K):
    """``hist_strategy="cuda_packed"`` is ``"pallas_packed"``'s counterpart:
    both unpack PackedCodes and run the naive-packing histogram.  Both are
    held to ``histogram_ref``, bit-equal on dyadic stats."""
    n, F, NB, NN = 301, 7, 16, 2
    codes = _codes16((n, F), seed=10 + K)
    g, h, nid = _stats(K, n, NN, seed=K, dyadic=True)
    jargs = [jnp.asarray(a) for a in (g, h, nid)]
    want = jax_ops.build_histogram(
        jax_binning.PackedCodes.pack_np(codes), *jargs, n_nodes=NN,
        n_bins=NB, plan=JaxPlan(hist_strategy="pallas_packed").resolved())
    oracle = jax_ops.build_histogram(
        jnp.asarray(codes), *jargs, n_nodes=NN, n_bins=NB,
        plan=JaxPlan(hist_strategy="scatter"))
    np.testing.assert_array_equal(np.asarray(want), np.asarray(oracle))
    plan = ExecutionPlan(hist_strategy="cuda_packed")
    for c in (PackedCodes.pack_np(codes), _t(codes)):
        got = ops.build_histogram(c, _t(g), _t(h), _t(nid), n_nodes=NN,
                                  n_bins=NB, plan=plan)
        np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))
    assert torch.equal(got, ref.histogram_ref(_t(codes), _t(g), _t(h),
                                              _t(nid), NN, NB))


def test_cuda_packed_is_a_histogram_strategy_only():
    assert ExecutionPlan(hist_strategy="cuda_packed").resolved() \
        .hist_strategy == "cuda_packed"
    for step in ("partition_strategy", "traversal_strategy"):
        with pytest.raises(ValueError, match=f"unknown {step}"):
            ExecutionPlan(**{step: "cuda_packed"})


# -- step ③ -------------------------------------------------------------------
@pytest.mark.parametrize("n,K,nn", [(257, 1, 4), (513, 3, 8)])
def test_packed_partition_cm_matches_jax(n, K, nn):
    """The grower's step ③ on a packed column-major copy: ``repro`` gathers
    the packed split rows, unpacks them and runs ``partition_pallas``
    (vmapped over classes); the port reads the packed bytes in place."""
    F, NB = 9, 16
    rng = np.random.default_rng(n)
    codes_cm = _codes16((F, n), seed=n)
    nid = rng.integers(0, nn, (K, n)).astype(np.int32)
    f = rng.integers(-1, F, (K, nn)).astype(np.int32)
    thr = rng.integers(0, NB, (K, nn)).astype(np.int32)
    cat = rng.integers(0, 2, (K, nn)).astype(np.int32)
    dl = rng.integers(0, 2, (K, nn)).astype(np.int32)
    do_split = jnp.asarray(f >= 0)
    lvl = jax_tree._gather_fields(jax_binning.PackedCodes.pack_np(codes_cm),
                                  jnp.where(do_split, jnp.asarray(f), 0))
    renum = jnp.where(do_split, jnp.broadcast_to(
        jnp.arange(nn, dtype=jnp.int32), (K, nn)), -1)
    want = jax.vmap(functools.partial(
        jax_part.partition_pallas, missing_bin=NB - 1, interpret=True))(
        jnp.asarray(nid), lvl.transpose(0, 2, 1), renum, jnp.asarray(thr),
        jnp.asarray(cat), jnp.asarray(dl))
    pc = PackedCodes.pack_np(codes_cm)
    assert pc.data.shape == (F, (n + 1) // 2)
    args = [_t(a) for a in (f, thr, cat, dl)]
    if K == 1:
        nid, want, args = nid[0], want[0], [a[0] for a in args]
    for plan in (ExecutionPlan(partition_strategy="reference"), None):
        got = ops.partition_level_cm(_t(nid), pc, *args, missing_bin=NB - 1,
                                     plan=plan)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(got, ops.partition_level_cm(
            _t(nid), _t(codes_cm), *args, missing_bin=NB - 1, plan=plan))


def test_consumers_unpack_packed_codes():
    """Step ⑤ and batch inference read PackedCodes as their codes."""
    n, F, NB, depth = 301, 9, 16, 3
    codes = _codes16((n, F), seed=3)
    rng = np.random.default_rng(3)
    n_int = 2 ** depth - 1
    trees = ref.TreeArrays(*[_t(a) for a in (
        rng.integers(-1, F, (5, n_int)).astype(np.int32),
        rng.integers(0, NB - 1, (5, n_int)).astype(np.int32),
        rng.integers(0, 2, (5, n_int)).astype(np.int32),
        rng.integers(0, 2, (5, n_int)).astype(np.int32),
        rng.normal(size=(5, 2 ** depth)).astype(np.float32))])
    pc = ops.pack_codes(_t(codes))
    assert isinstance(pc, PackedCodes) and pc.data.shape == (n, 5)
    assert torch.equal(ops.unpack_codes(pc), _t(codes))
    one = ref.TreeArrays(*[a[0] for a in trees])
    assert torch.equal(ops.traverse_tree(one, pc, missing_bin=NB - 1),
                       ops.traverse_tree(one, _t(codes), missing_bin=NB - 1))
    forest = ref.TreeArrays(*[a[:3] for a in trees])
    assert torch.equal(ops.traverse_forest(forest, pc, missing_bin=NB - 1),
                       ops.traverse_forest(forest, _t(codes),
                                           missing_bin=NB - 1))
    lvl = ops.pack_codes(_t(codes[:, :4]))
    split = [_t(a) for a in (np.array([0, 3], np.int32),
                             np.array([5, 9], np.int32),
                             np.array([0, 1], np.int32),
                             np.array([1, 0], np.int32))]
    nid = _t(rng.integers(0, 2, n).astype(np.int32))
    assert torch.equal(
        ops.partition_level(nid, lvl, *split, missing_bin=NB - 1),
        ops.partition_level(nid, _t(codes[:, :4]), *split,
                            missing_bin=NB - 1))
    for K in (1, 5):
        assert torch.equal(
            ops.predict_ensemble(trees, pc, missing_bin=NB - 1, depth=depth,
                                 n_classes=K),
            ops.predict_ensemble(trees, _t(codes), missing_bin=NB - 1,
                                 depth=depth, n_classes=K))


# -- the packed fit as a whole --------------------------------------------------
@pytest.mark.parametrize("objective,K", [("binary:logistic", None),
                                         ("multi:softmax", 3)])
def test_train_packed_matches_jax(objective, K):
    """F = 9 > 2^3 - 1, so step ⑤ gathers renumbered columns from the
    packed column-major copy; n = 501 and F = 9 are odd."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(501, 9)).astype(np.float32)
    X[rng.random(X.shape) < 0.04] = np.nan
    if K is None:
        y = (X[:, 0] + 0.5 * rng.normal(size=501) > 0).astype(np.float32)
    else:
        y = rng.integers(0, K, size=501).astype(np.float32)
        y[X[:, 1] > 0.5] = 0
    n_tr = 400
    jb = jax_binning.Binner(16).fit(X[:n_tr])
    tb = binning.Binner.from_arrays(16, jb._edges, jb._is_cat,
                                    jb._n_value_bins)
    jtr, jev = jb.transform(X[:n_tr]), jb.transform(X[n_tr:])
    ttr, tev = (tb.transform(X[:n_tr], device="cpu"),
                tb.transform(X[n_tr:], device="cpu"))
    assert isinstance(jtr.codes, jax_binning.PackedCodes)
    assert isinstance(ttr.codes, PackedCodes)
    assert isinstance(ttr.codes_cm, PackedCodes)
    kw = dict(n_trees=4, max_depth=3, learning_rate=0.5, objective=objective,
              n_classes=K)
    theirs = jax_gbdt.train(jax_gbdt.GBDTConfig(**kw), jtr, y[:n_tr],
                            eval_set=(jev, y[n_tr:]), plan=JAX_REFERENCE)
    ours = gbdt.train(gbdt.GBDTConfig(**kw), ttr, y[:n_tr],
                      eval_set=(tev, y[n_tr:]), device="cpu")
    m, j = ours.model, theirs.model
    feature = m.trees.feature.numpy()
    np.testing.assert_array_equal(feature, np.asarray(j.trees.feature))
    # a pass-through node (feature -1) keeps the threshold of its best
    # candidate, whose gain is 0 up to rounding: an ulp of softmax's g picks
    # it (ROADMAP Queue 3), and no record reads it
    split = feature >= 0
    for field in ("threshold", "is_cat", "default_left"):
        np.testing.assert_array_equal(
            getattr(m.trees, field).numpy()[split],
            np.asarray(getattr(j.trees, field))[split], err_msg=field)
    _close(m.trees.leaf_value.numpy(), j.trees.leaf_value)
    for key in ("train_loss", "eval_loss"):
        np.testing.assert_allclose(ours.history[key], theirs.history[key],
                                   rtol=1e-5)
    for data_t, data_j in ((ttr, jtr), (tev, jev)):
        _close(m.predict_margin(data_t).numpy(),
               j.predict_margin(data_j.codes))
        _close(m.predict_margin(data_t.codes).numpy(),
               m.predict_margin(data_t).numpy())
    _close(m.predict_margin(ttr).numpy(), ours.margins.numpy())
    # the port's packed fit is its unpacked fit, bit for bit
    plain = gbdt.train(gbdt.GBDTConfig(**kw),
                       tb.transform(X[:n_tr], packed=False, device="cpu"),
                       y[:n_tr], device="cpu")
    again = gbdt.train(gbdt.GBDTConfig(**kw), ttr, y[:n_tr], device="cpu")
    assert again.history["train_loss"] == plain.history["train_loss"]
    for a, b in zip(again.model.trees, plain.model.trees):
        assert torch.equal(a, b)
    assert torch.equal(again.model.predict_margin(ttr),
                       plain.model.predict_margin(
                           tb.transform(X[:n_tr], packed=False,
                                        device="cpu")))
