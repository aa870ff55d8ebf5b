"""The port's distributed path against ``repro``'s, on the CPU.

``repro``'s side runs once for the module, in a subprocess with 8 forced
host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_distributed.py`` runs it), and saves its inputs and outputs
to an npz.  The port runs the same inputs on meshes of repeated CPU
devices (``["cpu"] * D``), its counterpart of the forced device count.

Contracts (ROADMAP's three tiers): integer outputs (tree structure, node
ids, re-mesh events) exact; sums bit-equal where the statistics are
dyadic; everything else to the stated tolerance.  ``repro``'s own
``distributed_fit_tree`` raises on this JAX (ROADMAP Oracles), so the
port's explicit schedule is held against ``repro``'s single-device
``fit_tree``, to ``tests/test_perf_variants.py``'s tolerance.  At K = 3
the port is held to ``repro``'s distributed trainer (structure exact,
leaves and losses rtol 1e-5), not to bit-equality with a fused trainer.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.api import BoosterRegressor, ExecutionPlan
from repro_torch.core import gbdt, tree as tree_mod
from repro_torch.core.binning import dataset_from_codes
from repro_torch.core.inference import pad_trees, sharded_predict
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import elastic, sharding
from repro_torch.distributed.trainer import (DistributedConfig,
                                             train_distributed)
from repro_torch.launch.mesh import (data_axes, make_mesh,
                                     make_production_mesh, model_axis,
                                     n_data_shards)
from repro_torch.resilience import (DeviceOOMError, FaultInjector,
                                    GracefulShutdown,
                                    NumericalDivergenceError, Preemption,
                                    RecoveryPolicy, TrainingInterrupted,
                                    TransientIOError)

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIELDS = ("feature", "threshold", "is_cat", "default_left", "leaf_value")
STRUCTURE = FIELDS[:4]

_JAX_SIDE = r'''
import sys, tempfile
import numpy as np, jax, jax.numpy as jnp
from repro.api import BoosterRegressor, ExecutionPlan
from repro.core import GBDTConfig, bin_dataset, fit_tree
from repro.core.inference import pad_trees, sharded_predict
from repro.data import make_tabular
from repro.distributed.sharding import (distributed_histogram,
                                        distributed_split_combine,
                                        pjit_fit_tree)
from repro.distributed.trainer import (DistributedConfig, data_parallel_mesh,
                                       train_distributed)
from repro.launch.mesh import make_mesh
from repro.resilience.faults import FaultInjector

out = {}
devs = jax.devices()
assert len(devs) == 8
mesh42 = make_mesh((4, 2), ("data", "model"))
plan = ExecutionPlan.auto(hist_strategy="scatter")

def put(prefix, trees):
    for f in trees._fields:
        out[f"{prefix}_{f}"] = np.asarray(getattr(trees, f))

# step ① / ② / pjit on a (4, 2) mesh
rng = np.random.default_rng(0)
n, F, NB, NN = 4096, 8, 16, 4
codes = rng.integers(0, NB, (n, F)).astype(np.uint8)
g = rng.normal(size=n).astype(np.float32)
h = rng.uniform(.1, 1, n).astype(np.float32)
nid = rng.integers(0, NN, n).astype(np.int32)
out.update(h_codes=codes, h_g=g, h_h=h, h_nid=nid)
c, gg, hh, ii = map(jnp.asarray, (codes, g, h, nid))
hist = distributed_histogram(mesh42, c, gg, hh, ii, n_nodes=NN, n_bins=NB,
                             plan=plan)
out["h_hist"] = np.asarray(hist)
iscat = jnp.zeros((F,), bool)
fmask = jnp.ones((F,), bool)
put("h_split", distributed_split_combine(mesh42, hist, iscat, fmask, 1.0,
                                         0.0, 1.0, F))
fj = pjit_fit_tree(mesh42, depth=4, n_bins=NB, missing_bin=NB - 1,
                   lambda_=1.0, gamma=0.0, min_child_weight=1.0, plan=plan)
put("h_pjit", fj(c, jnp.asarray(codes.T.copy()), gg, hh, iscat, fmask))

# the single-device reference tree of the explicit variants
rng = np.random.default_rng(0)
vc = rng.integers(0, 16, (2048, 8)).astype(np.uint8)
vg = rng.normal(size=2048).astype(np.float32)
vh = rng.uniform(.1, 1, 2048).astype(np.float32)
out.update(v_codes=vc, v_g=vg, v_h=vh)
put("v_ref", fit_tree(jnp.asarray(vc), jnp.asarray(vc.T.copy()),
                      jnp.asarray(vg), jnp.asarray(vh), depth=3, n_bins=16,
                      missing_bin=15, is_cat_field=jnp.zeros((8,), bool),
                      field_mask=jnp.ones((8,), bool), lambda_=1.0,
                      gamma=0.0, min_child_weight=1.0,
                      plan=plan.replace(partition_strategy="reference")))

def k1_data(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(4096, 6))
    y = (rng.integers(-8, 9, 4096) * 0.25).astype(np.float32)
    return bin_dataset(X, max_bins=32), y

# train_distributed at K = 1 (dyadic targets) and K = 3
data, y = k1_data(0)
out.update(k1_codes=np.asarray(data.codes), k1_y=y)
for D in (1, 2, 8):
    res = train_distributed(GBDTConfig(n_trees=4, max_depth=4), data, y,
                            mesh=data_parallel_mesh(devs[:D]), plan=plan)
    put(f"k1_D{D}", res.model.trees)
    out[f"k1_D{D}_loss"] = np.asarray(res.history["train_loss"])
rng = np.random.default_rng(1)
X = rng.normal(size=(4096, 6))
y3 = rng.integers(0, 3, 4096)
data3 = bin_dataset(X, max_bins=32)
out.update(k3_codes=np.asarray(data3.codes), k3_y=y3)
for D in (1, 8):
    res = train_distributed(
        GBDTConfig(n_trees=3, max_depth=3, objective="multi:softmax",
                   n_classes=3), data3, y3, mesh=data_parallel_mesh(devs[:D]),
        eval_set=(data3, y3), plan=plan)
    put(f"k3_D{D}", res.model.trees)
    out[f"k3_D{D}_loss"] = np.asarray(res.history["train_loss"])
    out[f"k3_D{D}_eval_loss"] = np.asarray(res.history["eval_loss"])

# subtraction on 8 shards, the estimator's fit(mesh=), sharded_predict
X, y, _ = make_tabular(2048, 6, 0, task="regression", seed=3)
sdata = bin_dataset(X, max_bins=32)
out.update(sub_X=X, sub_y=y, sub_codes=np.asarray(sdata.codes))
put("sub", train_distributed(
    GBDTConfig(n_trees=3, max_depth=4), sdata, y,
    plan=plan.replace(hist_subtraction=True),
    mesh=data_parallel_mesh(devs)).model.trees)
est = BoosterRegressor(n_trees=3, max_depth=4, max_bins=32)
est.fit(X, y, mesh=data_parallel_mesh(devs))
out["est_pred"] = np.asarray(est.predict(X))
out["est_n_shards"] = np.asarray(est.stats_["n_shards"])
put("est", est.model_.trees)
out["est_base"] = np.asarray(est.model_.base_margin, np.float32)
out["sp_margin"] = np.asarray(sharded_predict(
    mesh42, pad_trees(est.model_, 2), est._bin(X).codes))

# elastic: a worker lost at round 5 of 8 shards (6 survive), restore and
# replay; and a grow event 4 -> 8 shards at round 4
data, y = k1_data(0)
cfg = GBDTConfig(n_trees=8, max_depth=3, seed=11)
runs = {"golden": train_distributed(cfg, data, y, plan=plan,
                                    mesh=data_parallel_mesh(devs))}
with tempfile.TemporaryDirectory() as d:
    runs["fault"] = train_distributed(
        cfg, data, y, plan=plan, mesh=data_parallel_mesh(devs),
        dist=DistributedConfig(checkpoint_dir=d, checkpoint_every=2,
                               fault_injector=FaultInjector(
                                   fail_at_steps=(5,)),
                               survivors=lambda v: v[:-2]))
runs["grow"] = train_distributed(
    cfg, data, y, plan=plan, mesh=data_parallel_mesh(devs[:4]),
    dist=DistributedConfig(available_devices=lambda t:
                           devs[:4] if t < 4 else devs))
for tag, r in runs.items():
    put(f"el_{tag}", r.model.trees)
    out[f"el_{tag}_events"] = np.asarray(
        [list(map(str, e)) for e in r.stats["remesh_events"]], dtype=str)
    out[f"el_{tag}_restarts"] = np.asarray(r.stats["restarts"])
    out[f"el_{tag}_pred"] = np.asarray(r.model.predict(data))
np.savez(sys.argv[1], **out)
print("JAX_SIDE_OK")
'''


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    """``repro``'s outputs, from one subprocess with 8 host devices."""
    path = tmp_path_factory.mktemp("jax_side") / "out.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-W", "ignore", "-c", _JAX_SIDE,
                          str(path)], env=env, cwd=_ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and "JAX_SIDE_OK" in out.stdout, \
        out.stdout + out.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _cpu_mesh(shape, axes=("data",)):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _trees(jx, prefix):
    return [jx[f"{prefix}_{f}"] for f in FIELDS]


def _data(codes, n_bins=32):
    return dataset_from_codes(codes, n_bins=n_bins, device="cpu")


def _assert_forest(got, want, what, rtol=1e-5, atol=1e-6):
    """Structure exact, leaves within rtol/atol."""
    for f, a, b in zip(FIELDS, got, want):
        a = np.asarray(a.cpu() if torch.is_tensor(a) else a)
        if f in STRUCTURE:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=f"{what} {f}")


def _cfg(**kw):
    return gbdt.GBDTConfig(**kw)


# --------------------------------------------------------------------------
# the mesh and its collectives
# --------------------------------------------------------------------------
def test_mesh_shapes_axes_and_refusals():
    mesh = _cpu_mesh((4, 2), ("data", "model"))
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert data_axes(mesh) == ("data",) and model_axis(mesh) == "model"
    assert n_data_shards(mesh) == 4
    pod = make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert n_data_shards(pod) == 32 and data_axes(pod) == ("pod", "data")
    assert make_production_mesh(devices=["cpu"] * 256).shape == \
        {"data": 16, "model": 16}
    assert mesh == _cpu_mesh((4, 2), ("data", "model"))
    assert hash(mesh) == hash(_cpu_mesh((4, 2), ("data", "model")))
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh((4, 2), ("data", "model"), devices=["cpu"] * 7)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA"):
            make_mesh((2,), ("data",))
    plan = ExecutionPlan(mesh=mesh, data_axes=["data"])
    assert plan.data_axes == ("data",) and "mesh=" in plan.describe()
    with pytest.raises(ValueError, match="not present"):
        ExecutionPlan(mesh=mesh, data_axes=("pod",))
    with pytest.raises(ValueError, match="only applies"):
        ExecutionPlan(data_axes=("data",))


def test_psum_fixed_order_and_stats():
    mesh = _cpu_mesh((4, 2), ("data", "model"))
    rng = np.random.default_rng(0)
    parts = [[torch.from_numpy(rng.normal(size=5).astype(np.float32))
              for _ in range(2)] for _ in range(4)]
    sharding.reset_collective_stats()
    out = sharding.psum(mesh, parts, "data")
    for m in range(2):
        want = ((parts[0][m] + parts[1][m]) + parts[2][m]) + parts[3][m]
        assert all(torch.equal(out[d][m], want) for d in range(4))
    out = sharding.psum(mesh, parts, "model")
    assert torch.equal(out[3][1], parts[3][0] + parts[3][1])
    st = sharding.collective_stats()
    assert st["all-reduce"] == {"count": 2, "bytes": 2 * 2 * 5 * 4}
    with pytest.raises(ValueError, match="psum over"):
        sharding.psum(make_mesh((2, 2, 2), ("pod", "data", "model"),
                                devices=["cpu"] * 8), parts, "pod")
    assert sharding.reset_collective_stats()["all-reduce"]["count"] == 2
    assert sharding.collective_stats()["all-reduce"]["count"] == 0


# --------------------------------------------------------------------------
# the explicit schedule and pjit_fit_tree against repro
# --------------------------------------------------------------------------
def test_histogram_split_combine_and_pjit_match_jax(jx):
    """(4, 2) mesh: the histogram within rtol 1e-5 + atol 1e-5 and the
    split fields exact against ``repro``'s explicit collectives;
    ``pjit_fit_tree`` structure exact, leaves rtol 1e-5, and equal to the
    port's explicit schedule."""
    mesh = _cpu_mesh((4, 2), ("data", "model"))
    codes, g, h, nid = (torch.from_numpy(jx[k]) for k in
                        ("h_codes", "h_g", "h_h", "h_nid"))
    sharding.reset_collective_stats()
    hist = sharding.distributed_histogram(mesh, codes, g, h, nid, n_nodes=4,
                                          n_bins=16)
    np.testing.assert_allclose(hist.numpy(), jx["h_hist"], rtol=1e-5,
                               atol=1e-5)
    F = codes.shape[1]
    iscat, fmask = torch.zeros(F, dtype=torch.bool), torch.ones(
        F, dtype=torch.bool)
    ds = sharding.distributed_split_combine(mesh, hist, iscat, fmask, 1.0,
                                            0.0, 1.0, F)
    for f in ("feature", "threshold", "is_cat", "default_left"):
        np.testing.assert_array_equal(getattr(ds, f).numpy(),
                                      jx[f"h_split_{f}"], err_msg=f)
    np.testing.assert_allclose(ds.gain.numpy(), jx["h_split_gain"],
                               rtol=1e-5)
    st = sharding.collective_stats()
    assert st["all-reduce"]["count"] == 1 and st["all-gather"]["count"] == 1
    assert st["all-reduce"]["bytes"] == 2 * 4 * 4 * 16 * 2 * 4
    kw = dict(depth=4, n_bins=16, missing_bin=15, lambda_=1.0, gamma=0.0,
              min_child_weight=1.0)
    t = sharding.pjit_fit_tree(mesh, **kw)(codes, codes.T.contiguous(), g,
                                           h, iscat, fmask)
    _assert_forest(t, _trees(jx, "h_pjit"), "pjit")
    explicit = sharding.distributed_fit_tree(
        mesh, codes, codes.T.contiguous(), g, h, is_cat_field=iscat,
        field_mask=fmask, **kw)
    _assert_forest(t, [a.numpy() for a in explicit], "pjit vs explicit",
                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bits,hist_dtype", [(False, None), (True, None),
                                             (True, torch.bfloat16)],
                         ids=["explicit", "bits", "bits_bf16"])
def test_explicit_tree_variants_match_jax_fit_tree(jx, bits, hist_dtype):
    """``repro``'s ``distributed_fit_tree`` raises on this JAX, so the
    port's is held against ``repro``'s single-device ``fit_tree`` at
    ``test_perf_variants.py``'s tolerance (rtol 1e-3, atol 1e-4)."""
    mesh = _cpu_mesh((4, 2), ("data", "model"))
    codes, g, h = (torch.from_numpy(jx[k]) for k in
                   ("v_codes", "v_g", "v_h"))
    t = sharding.distributed_fit_tree(
        mesh, codes, codes.T.contiguous(), g, h, depth=3, n_bins=16,
        missing_bin=15, is_cat_field=torch.zeros(8, dtype=torch.bool),
        field_mask=torch.ones(8, dtype=torch.bool), lambda_=1.0, gamma=0.0,
        min_child_weight=1.0, hist_dtype=hist_dtype, partition_bits=bits)
    for f, a, b in zip(FIELDS, t, _trees(jx, "v_ref")):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=1e-4,
                                   err_msg=f)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_explicit_schedule_bit_equal_to_fit_forest_on_exact_grid(shape):
    """On dyadic statistics every sum is exact: the explicit schedule (the
    bits variant too) and ``pjit_fit_tree`` give ``fit_forest``'s trees and
    final node ids bit for bit; the bf16 sum's histogram lies within
    bfloat16 rounding of the float32 one."""
    mesh = _cpu_mesh(shape, ("data", "model"))
    rng = np.random.default_rng(5)
    n, F, NB = 2000, 6, 16
    codes = torch.from_numpy(rng.integers(0, NB, (n, F)).astype(np.uint8))
    g = torch.from_numpy((rng.integers(-64, 65, n) / 64).astype(np.float32))
    h = torch.from_numpy((rng.integers(1, 65, n) / 64).astype(np.float32))
    iscat = torch.tensor([0, 1, 0, 0, 1, 0], dtype=torch.bool)
    fmask = torch.ones(F, dtype=torch.bool)
    kw = dict(depth=4, n_bins=NB, missing_bin=NB - 1, is_cat_field=iscat,
              field_mask=fmask, lambda_=1.0, gamma=0.0, min_child_weight=1.0)
    data = _data(codes.numpy(), NB)
    want = tree_mod.fit_forest(data.codes, data.codes_cm, g[None], h[None],
                               **kw)
    ids = torch.zeros(n, dtype=torch.int32)
    for level in range(4):
        off = 2 ** level - 1
        ids = tree_mod.ops.partition_level_cm(
            ids[None], data.codes_cm,
            *[t[:, off:2 * off + 1] for t in want[:4]],
            missing_bin=NB - 1)[0]
    for bits in (False, True):
        t, nid = sharding.distributed_fit_tree(
            mesh, codes, codes.T.contiguous(), g, h, partition_bits=bits,
            return_node_ids=True, **kw)
        for f, a, b in zip(FIELDS, t, want):
            assert torch.equal(a, b[0]), (bits, f)
        assert torch.equal(nid, ids)
    pj = sharding.pjit_fit_tree(mesh, **{k: v for k, v in kw.items()
                                         if k not in ("is_cat_field",
                                                      "field_mask")})
    assert all(torch.equal(a, b[0]) for a, b in zip(
        pj(codes, codes.T.contiguous(), g, h, iscat, fmask), want))
    # the bf16 sum: every part rounded to bfloat16 (unit roundoff 2^-8),
    # then D - 1 additions rounded again
    g2 = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    D = sharding.shard_grid(mesh).shape[0]

    def total(gg, dtype=None):
        return sharding.distributed_histogram(
            mesh, codes, gg, h, torch.zeros(n, dtype=torch.int32),
            n_nodes=1, n_bins=NB, hist_dtype=dtype)

    f32, bf, mag = total(g2), total(g2, torch.bfloat16), total(g2.abs())
    assert torch.all((bf - f32).abs() <= 2 * D * 2.0 ** -8 * mag)
    assert not torch.equal(bf, f32)


# --------------------------------------------------------------------------
# train_distributed against repro's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("D", [1, 2, 8])
def test_train_distributed_k1_matches_jax(jx, D):
    """K = 1 on dyadic targets: structure exact against ``repro``'s D-shard
    fit, leaves and losses rtol 1e-5; round 0 bit-equal to the port's
    host-loop ``train`` for every D, and the whole D = 1 fit bit-equal to
    it (padding rows add +0.0)."""
    data, y = _data(jx["k1_codes"]), jx["k1_y"]
    cfg = _cfg(n_trees=4, max_depth=4)
    res = train_distributed(cfg, data, y, mesh=_cpu_mesh((D,)))
    assert res.stats["n_shards"] == D and res.stats["distributed"]
    assert res.stats["devices"] == ["cpu"] * D
    _assert_forest(res.model.trees, _trees(jx, f"k1_D{D}"), f"D={D}")
    np.testing.assert_allclose(res.history["train_loss"],
                               jx[f"k1_D{D}_loss"], rtol=1e-5)
    host = gbdt.train(cfg, data, y, device="cpu")
    for a, b in zip(res.model.trees, host.model.trees):
        assert torch.equal(a[0], b[0])
        if D == 1:
            assert torch.equal(a, b)
    if D == 1:
        assert res.history["train_loss"] == host.history["train_loss"]
        assert torch.equal(res.margins, host.margins)


@pytest.mark.parametrize("D", [1, 8])
def test_train_distributed_k3_matches_jax(jx, D):
    """K = 3 softmax with an eval set: structure exact against ``repro``'s
    D-shard fit, leaves, losses and eval losses rtol 1e-5 (no bit-equality
    with a fused trainer: ROADMAP Oracles)."""
    data, y = _data(jx["k3_codes"]), jx["k3_y"]
    cfg = _cfg(n_trees=3, max_depth=3, objective="multi:softmax",
               n_classes=3)
    res = train_distributed(cfg, data, y, mesh=_cpu_mesh((D,)),
                            eval_set=(data, y))
    _assert_forest(res.model.trees, _trees(jx, f"k3_D{D}"), f"K=3 D={D}")
    for key in ("loss", "eval_loss"):
        np.testing.assert_allclose(
            res.history["train_loss" if key == "loss" else key],
            jx[f"k3_D{D}_{key}"], rtol=1e-5)
    assert res.margins.shape == (4096, 3)


def test_train_distributed_subtraction_matches_jax(jx):
    """Smaller-child subtraction on 8 shards: structure exact against
    ``repro``'s, predictions rtol 1e-5 + atol 1e-6."""
    data, y = _data(jx["sub_codes"]), jx["sub_y"]
    plan = ExecutionPlan(hist_subtraction=True)
    res = train_distributed(_cfg(n_trees=3, max_depth=4), data, y,
                            mesh=_cpu_mesh((8,)), plan=plan)
    _assert_forest(res.model.trees, _trees(jx, "sub"), "subtraction")
    host = gbdt.train(_cfg(n_trees=3, max_depth=4), data, y, plan=plan,
                      device="cpu")
    torch.testing.assert_close(res.model.predict(data),
                               host.model.predict(data), rtol=1e-5,
                               atol=1e-6)


def test_estimator_fit_mesh_and_sharded_predict_match_jax(jx):
    """``fit(mesh=)`` trains through the distributed engine (predictions
    rtol 1e-5 + atol 1e-5 against ``repro``'s), a plan with a (4, 2) mesh
    predicts through ``sharded_predict`` (rtol 1e-5 against ``repro``'s,
    1e-6 against the port's direct predict), and a mesh refuses the
    out-of-core path."""
    X, y = jx["sub_X"], jx["sub_y"]
    est = BoosterRegressor(n_trees=3, max_depth=4, max_bins=32,
                           device="cpu")
    est.fit(X, y, mesh=_cpu_mesh((8,)))
    assert est.stats_["distributed"] and est.stats_["n_shards"] == 8
    np.testing.assert_allclose(est.predict(X).numpy(), jx["est_pred"],
                               rtol=1e-5, atol=1e-5)
    direct = est.predict_margin(X)
    mesh = _cpu_mesh((4, 2), ("data", "model"))
    sharded = est.predict_margin(X, plan=ExecutionPlan(mesh=mesh))
    np.testing.assert_allclose(sharded.numpy(), jx["sp_margin"], rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(sharded, direct, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="out-of-core"):
        est.fit(X, y, mesh=mesh, plan=ExecutionPlan(chunk_bytes=1 << 20))


def test_sharded_predict_multiclass_dyadic_and_launches(monkeypatch):
    """K = 3 over a (2, 2) mesh: bit-equal to ``predict_margin`` on dyadic
    leaves and base margin, ``ops.predict_ensemble`` called once a shard,
    and an unpadded ensemble refused."""
    import dataclasses

    from repro_torch.kernels import ops

    data = _data(np.random.default_rng(2).integers(0, 16, (301, 5)), 16)
    y = np.random.default_rng(3).integers(0, 3, 301)
    model = gbdt.train(_cfg(n_trees=3, max_depth=3,
                            objective="multi:softmax", n_classes=3), data,
                       y, device="cpu").model
    leaves = torch.from_numpy(np.random.default_rng(4).integers(
        -64, 65, model.trees.leaf_value.shape).astype(np.float32) / 64)
    model = dataclasses.replace(
        model, trees=model.trees._replace(leaf_value=leaves),
        base_margin=np.float32([0.25, -0.5, 1.0]))
    mesh = _cpu_mesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="pad_trees"):
        sharded_predict(mesh, model, data)
    calls = []
    real = ops.predict_ensemble

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ops, "predict_ensemble", counting)
    out = sharded_predict(mesh, pad_trees(model, 2 * 3), data)
    assert len(calls) == 4 and out.shape == (301, 3)
    assert torch.equal(out, model.predict_margin(data))


# --------------------------------------------------------------------------
# elasticity, recovery, shutdown
# --------------------------------------------------------------------------
def test_elastic_shrink_restore_replay_matches_jax(jx, tmp_path):
    """A worker lost at round 5 on 8 shards: re-mesh onto 6, restore the
    round-4 checkpoint, replay; a grow 4 -> 8 at round 4.  Re-mesh events
    and restarts equal ``repro``'s, structure exact against its fits,
    predictions rtol 1e-5 + atol 1e-6."""
    data, y = _data(jx["k1_codes"]), jx["k1_y"]
    cfg = _cfg(n_trees=8, max_depth=3, seed=11)
    runs = {"golden": train_distributed(cfg, data, y, mesh=_cpu_mesh((8,)))}
    runs["fault"] = train_distributed(
        cfg, data, y, mesh=_cpu_mesh((8,)),
        dist=DistributedConfig(checkpoint_dir=str(tmp_path),
                               checkpoint_every=2,
                               fault_injector=FaultInjector(
                                   fail_at_steps=(5,)),
                               survivors=lambda v: v[:-2]))
    runs["grow"] = train_distributed(
        cfg, data, y, mesh=_cpu_mesh((4,)),
        dist=DistributedConfig(available_devices=lambda t:
                               ["cpu"] * (4 if t < 4 else 8)))
    for tag, r in runs.items():
        events = [list(map(str, e)) for e in r.stats["remesh_events"]]
        assert events == jx[f"el_{tag}_events"].tolist(), tag
        assert r.stats["restarts"] == int(jx[f"el_{tag}_restarts"])
        _assert_forest(r.model.trees, _trees(jx, f"el_{tag}"), tag)
        np.testing.assert_allclose(r.model.predict(data).numpy(),
                                   jx[f"el_{tag}_pred"], rtol=1e-5,
                                   atol=1e-6)
    st = runs["fault"].stats
    assert st["n_shards"] == 6 and st["replayed_rounds"] == 1
    assert runs["fault"].model.n_trees == 8


def test_elastic_context_and_positional_checkpoints_cross_read(tmp_path):
    """``ElasticContext`` shrinks a (4, 2) mesh to (3, 2); a positional
    checkpoint of ``repro`` restores into the port's state and predicts on
    the re-placed shards (padded 2000 -> 2001) as before, and one of the
    port restores into ``repro``'s state."""
    from repro.core import GBDTConfig as JConfig, GBDTModel as JModel
    from repro.core import dataset_from_codes as jcodes, train as jtrain
    from repro.distributed import checkpoint as jckpt

    codes = np.random.default_rng(1).integers(0, 31, (2000, 6))
    y = np.random.default_rng(2).normal(size=2000).astype(np.float32)
    jres = jtrain(JConfig(n_trees=3, max_depth=3), jcodes(codes, n_bins=32),
                  y)
    jckpt.save(str(tmp_path / "jax"), jres.model.to_state(), step=3)
    data = _data(codes)
    model = gbdt.train(_cfg(n_trees=3, max_depth=3), data, y,
                       device="cpu").model
    ctx = elastic.ElasticContext(model_parallel=2, devices=["cpu"] * 8)
    assert ctx.mesh.shape == {"data": 4, "model": 2}
    mesh2 = ctx.resize(["cpu"] * 6)
    assert mesh2.shape == {"data": 3, "model": 2}
    placed = sharding.shard_dataset(data, mesh2)
    assert placed.n_pad == 2001 and [b for b in placed.bounds] == \
        [(0, 667), (667, 1334), (1334, 2001)]
    state, step, _ = ckpt.restore(str(tmp_path / "jax"),
                                  like=model.to_state(), device=ctx.owner)
    assert step == 3
    restored = gbdt.GBDTModel.from_state(state, device="cpu")
    pred = torch.cat([restored.predict(s) for s in placed.shards])[:2000]
    np.testing.assert_allclose(pred.numpy(),
                               np.asarray(jres.model.predict(
                                   jcodes(codes, n_bins=32))),
                               rtol=1e-5, atol=1e-6)
    ckpt.save(str(tmp_path / "port"), model.to_state(), step=7)
    jstate, jstep, _ = jckpt.restore(str(tmp_path / "port"),
                                     like=jres.model.to_state())
    assert jstep == 7
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(jstate["trees"][f]),
                                      getattr(model.trees, f).numpy())
    jm = JModel.from_state(jstate)
    np.testing.assert_allclose(np.asarray(jm.predict(jcodes(codes,
                                                            n_bins=32))),
                               model.predict(data).numpy(), rtol=1e-6)
    assert elastic.largest_mesh_shape(7, 2) == (3, 2)
    with pytest.raises(ValueError):
        elastic.largest_mesh_shape(1, 2)
    moved = elastic.reshard_tree({"a": [torch.ones(2)], "b": 3}, "cpu")
    assert moved["b"] == 3 and moved["a"][0].device.type == "cpu"


def _k1(seed=0, n=2048):
    rng = np.random.default_rng(seed)
    data = _data(rng.integers(0, 31, (n, 5)))
    y = (rng.integers(-8, 9, n) * 0.25).astype(np.float32)
    return data, y


@pytest.mark.parametrize("branch", ["transient", "oom", "divergence",
                                    "preemption"])
def test_recovery_branches(branch, tmp_path):
    """Each branch of ``recovery=``: a transient failure retries on the
    same mesh and a one-off divergence replays the round (both bit-equal
    to the fault-free fit); a device OOM doubles ``hist_slices`` (structure
    exact, leaves rtol 1e-5); a preemption re-meshes onto 3 shards,
    restores and replays (structure exact, leaves rtol 1e-5)."""
    data, y = _k1()
    cfg = _cfg(n_trees=5, max_depth=3)
    mesh = _cpu_mesh((4,))
    golden = train_distributed(cfg, data, y, mesh=mesh)
    exc = {"transient": TransientIOError, "oom": DeviceOOMError,
           "divergence": NumericalDivergenceError,
           "preemption": Preemption}[branch]
    res = train_distributed(
        cfg, data, y, mesh=mesh,
        dist=DistributedConfig(fault_injector=FaultInjector((2,), exc=exc)),
        recovery=RecoveryPolicy(checkpoint_dir=str(tmp_path),
                                checkpoint_every=2))
    st = res.stats
    counter = {"transient": "recoveries", "oom": "oom_halvings",
               "divergence": "divergence_rollbacks",
               "preemption": "restarts"}[branch]
    assert st[counter] == 1
    if branch in ("transient", "divergence"):
        assert all(torch.equal(a, b) for a, b in zip(res.model.trees,
                                                     golden.model.trees))
        assert st["remesh_events"] == [] and st["n_shards"] == 4
        return
    if branch == "oom":
        assert st["hist_slices"] == 2 and st["n_shards"] == 4
    else:
        assert st["remesh_events"] == [("shrink", 2, 3)]
        assert st["n_shards"] == 3 and st["replayed_rounds"] == 0
    _assert_forest(res.model.trees, [a.numpy() for a in golden.model.trees],
                   branch)


def test_legacy_restarts_budget_and_fatal_errors():
    """Without a policy any failure re-meshes, ``dist.max_restarts`` times;
    with one a non-transient error propagates at once."""
    data, y = _k1(1, 1024)
    cfg = _cfg(n_trees=4, max_depth=2)
    with pytest.raises(RuntimeError, match="injected"):
        train_distributed(cfg, data, y, mesh=_cpu_mesh((4,)),
                          dist=DistributedConfig(
                              max_restarts=1,
                              fault_injector=FaultInjector((1, 2))))
    with pytest.raises(ValueError, match="injected"):
        train_distributed(cfg, data, y, mesh=_cpu_mesh((2,)),
                          dist=DistributedConfig(
                              fault_injector=FaultInjector((1,),
                                                           exc=ValueError)),
                          recovery=RecoveryPolicy())
    with pytest.raises(ValueError, match="model"):
        train_distributed(cfg, data, y,
                          mesh=_cpu_mesh((2, 2), ("data", "model")))
    with pytest.raises(ValueError, match="needs a mesh"):
        train_distributed(cfg, data, y)


def test_shutdown_commits_then_resume_equals_uninterrupted(tmp_path):
    """A shutdown requested in round 2 commits it and a round checkpoint
    and raises ``TrainingInterrupted``; continuing from the partial model
    on 2 shards reproduces the uninterrupted 4-shard fit's structure
    (leaves rtol 1e-6), its margins taken from the matching checkpoint."""
    data, y = _k1(2, 1536)
    cfg = _cfg(n_trees=6, max_depth=3)
    golden = train_distributed(cfg, data, y, mesh=_cpu_mesh((4,)))
    sd = GracefulShutdown(signals=())
    dist = DistributedConfig(checkpoint_dir=str(tmp_path), checkpoint_every=4)
    with pytest.raises(TrainingInterrupted) as info:
        train_distributed(cfg, data, y, mesh=_cpu_mesh((4,)), dist=dist,
                          shutdown=sd,
                          callback=lambda t, m: t == 2 and sd.request())
    stop = info.value
    assert stop.rounds_done == 3 and stop.result.stats["interrupted"]
    assert ckpt.list_steps(os.path.join(str(tmp_path), "rounds")) == [3]
    rest = train_distributed(
        _cfg(n_trees=3, max_depth=3), data, y, mesh=_cpu_mesh((2,)),
        dist=dist, init_model=stop.result.model)
    assert rest.model.n_rounds == 6
    np.testing.assert_allclose(rest.history["train_loss"],
                               golden.history["train_loss"][3:], rtol=1e-6)
    _assert_forest(rest.model.trees, [a.numpy() for a in golden.model.trees],
                   "resumed", rtol=1e-6, atol=1e-7)


def test_grower_packed_layouts_and_hist_slices_bit_equal():
    """At 16 bins the shards' column-major copies ship packed (even shard
    sizes) or unpacked (odd); either, and step ① in 3 slices, grows the
    uint8, one-slice trees bit for bit on dyadic statistics."""
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 15, (1201, 7))
    g = torch.from_numpy((rng.integers(-64, 65, 1201) / 64).astype(
        np.float32))
    h = torch.ones(1201)
    plan = ExecutionPlan().resolved()
    out = []
    for packed, D, slices in ((False, 2, 1), (True, 2, 1), (True, 3, 3)):
        data = dataset_from_codes(codes, n_bins=16, packed=packed,
                                  device="cpu")
        mesh = _cpu_mesh((D,))
        placed = sharding.shard_dataset(data, mesh)
        assert placed.cm_packed == (packed and (placed.n_pad // D) % 2 == 0)
        records = sharding.ShardedRecords(placed, g[None], h[None],
                                          plan=plan, hist_slices=slices)
        tree = tree_mod.grow_levels(
            records, depth=4, is_cat_field=data.is_categorical,
            field_mask=torch.ones(7, dtype=torch.bool), lambda_=1.0,
            gamma=0.0, min_child_weight=1.0)
        out.append(tree)
    assert all(torch.equal(a, b) for t in out[1:] for a, b in zip(t, out[0]))
