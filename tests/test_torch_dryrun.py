"""The port's dry runs, report and LM sharding rules, on the CPU.

The sharding rules are held against ``repro``'s leaf by leaf on
``AbstractMesh``es of the production shapes (no placeholder devices), the
per-card shapes against ``NamedSharding.shard_shape``.  ``repro``'s
``launch.dryrun`` forces 512 host devices when it is imported, so its
``input_specs`` and ``VARIANTS`` are read once, in a subprocess.  The meta
plan's FLOPs are held against ``FlopCounterMode`` over the same program on
real CPU tensors; the GBDT plan's collectives against the port's own
``collective_stats()`` (``repro``'s explicit schedule raises on this JAX,
so the port's is the one to hold them to).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P
from jax.tree_util import DictKey
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_arch as jax_arch
from repro.launch import report as jreport
from repro.models import lm as jlm
from repro_torch.configs import ARCH_IDS, SHAPES, get_arch, get_smoke
from repro_torch.configs.registry import ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun, dryrun_gbdt, report
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                     meta_mesh, meta_production_mesh,
                                     shard_shape)
from repro_torch.models import lm

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_ENV = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
KV_SHARDS = ("hd", "seq", "kv", "none")


def _meshes(which):
    shape, axes = MESHES[which]
    return AbstractMesh(shape, axes), meta_mesh(shape, axes)


def _flat(tree):
    """``{dotted path: leaf}`` of a pytree, PartitionSpecs as leaves."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, P)):
        out[".".join(str(p.key) if isinstance(p, DictKey) else str(p.idx)
                     for p in path)] = leaf
    return out


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch):
    return _flat(jlm.abstract_params(jax_arch(arch)))


def _jax_shard_shape(am, spec, shape):
    """``NamedSharding.shard_shape``; where an axis does not divide a
    dimension (which it refuses: whisper's 1,500 audio frames under
    ``kv_shard="seq"``), the ceiling of each dimension over its axes'
    sizes."""
    try:
        return tuple(NamedSharding(am, P(*spec)).shard_shape(tuple(shape)))
    except ValueError:
        sizes = dict(zip(am.axis_names, am.axis_sizes))
        parts = [1 if a is None else int(np.prod(
            [sizes[x] for x in ((a,) if isinstance(a, str) else a)]))
            for a in spec]
        return tuple(-(-d // n) for d, n in zip(shape, parts))


# --------------------------------------------------------------------------
# the sharding rules
# --------------------------------------------------------------------------
@pytest.mark.parametrize("which", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_partition_specs_match_repro(arch, which):
    """Every parameter's spec equals ``repro``'s in the stacked layout,
    its per-card shape ``NamedSharding.shard_shape``'s, its shape and
    dtype ``abstract_params``'."""
    am, mm = _meshes(which)
    want = _flat(jlm.partition_specs(jax_arch(arch), am))
    abstract = _jax_abstract(arch)
    got = lm.param_shardings(get_arch(arch), mm)
    mine = lm.abstract_params(get_arch(arch))
    assert set(got) == set(want) == set(mine)
    for key, spec in want.items():
        assert got[key][0] == tuple(spec), key
        shape = tuple(abstract[key].shape)
        assert mine[key][0] == shape, key
        assert str(mine[key][1]).split(".")[-1] == str(abstract[key].dtype)
        local = _jax_shard_shape(am, spec, shape)
        assert got[key][1] == local, key
        assert got[key][2] == int(np.prod(local)) * mine[key][1].itemsize


def test_shard_shape_takes_the_ceiling():
    """An axis that does not divide a dimension gives its largest shard;
    ``abstract_params`` keys a stacked leaf by its group's first layer."""
    mesh = meta_mesh((16, 16), ("data", "model"))
    assert shard_shape(mesh, ("model", None), (122753, 10)) == (7673, 10)
    assert shard_shape(mesh, (("data", "model"), None), (1000, 3)) == (4, 3)
    assert shard_shape(mesh, (None,), (5,)) == (5,)
    cfg = get_arch("jamba-v0.1-52b")
    assert lm.stacked_name(cfg, "blocks.13.mixer.in_proj") == (
        "blocks.5.mixer.in_proj", 1, 4)
    assert lm.abstract_params(cfg)["blocks.5.mixer.in_proj"][0][0] == 4


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_repro(arch, shape_name):
    """For all four ``kv_shard`` values on both production meshes: layer i
    of the port's cache is group i // period of ``repro``'s stacked leaf
    at pattern position i % period, with ``repro``'s spec after its group
    axis and ``repro``'s per-card shape."""
    shape = SHAPES[shape_name]
    cfg, jcfg = get_arch(arch), jax_arch(arch)
    period = cfg.scan_period()
    for which in MESHES:
        am, mm = _meshes(which)
        for kv in KV_SHARDS:
            jc, js = jlm.cache_specs(jcfg, am, shape.global_batch,
                                     shape.seq_len, kv_shard=kv)
            caches, specs = lm.cache_specs(cfg, mm, shape.global_batch,
                                           shape.seq_len, kv_shard=kv)
            assert len(caches) == cfg.n_layers
            for i, (cache, spec) in enumerate(zip(caches, specs)):
                want_c, want_s = _flat(jc[i % period]), _flat(js[i % period])
                got_c = _flat(cache)
                got_s = {k: v for k, v in _flat_specs(spec)}
                assert set(got_c) == set(want_c) == set(got_s)
                for k, leaf in want_c.items():
                    assert tuple(leaf.shape[1:]) == tuple(got_c[k].shape)
                    assert leaf.shape[0] == cfg.n_layers // period
                    assert str(got_c[k].dtype).split(".")[-1] == \
                        str(leaf.dtype)
                    assert got_c[k].device.type == "meta"
                    jspec = tuple(want_s[k].spec)
                    assert jspec == (None,) + got_s[k], (i, k, kv)
                    assert _jax_shard_shape(am, jspec, leaf.shape)[1:] == \
                        shard_shape(mm, got_s[k], got_c[k].shape)


def _flat_specs(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flat_specs(v, key + ".")
        else:
            yield key, v


# --------------------------------------------------------------------------
# inputs and variants against repro's launcher (one subprocess)
# --------------------------------------------------------------------------
_JAX_SIDE = r"""
import dataclasses, json, sys
from jax.sharding import AbstractMesh
from repro.configs import ARCH_IDS, SHAPES, get_arch
from repro.launch import dryrun
meshes = {"single": AbstractMesh((16, 16), ("data", "model")),
          "multi": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
out = {"inputs": {}, "variants": {}}
for which, mesh in meshes.items():
    for aid in ARCH_IDS:
        for sh in SHAPES:
            cfg, opts = dryrun.VARIANTS["base"](get_arch(aid), SHAPES[sh])
            batch, shard = dryrun._batch_specs(cfg, SHAPES[sh], mesh, opts)
            out["inputs"][f"{which}/{aid}/{sh}"] = {
                k: [list(v.shape), str(v.dtype), list(shard[k].spec)]
                for k, v in batch.items()}
for name, fn in dryrun.VARIANTS.items():
    for aid in ARCH_IDS:
        for sh in SHAPES:
            cfg, opts = fn(get_arch(aid), SHAPES[sh])
            out["variants"][f"{name}/{aid}/{sh}"] = [
                dataclasses.asdict(cfg), opts]
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def jax_launcher():
    res = subprocess.run([sys.executable, "-c", _JAX_SIDE], env=_ENV,
                         cwd=_ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout)


def _jsonable(spec):
    return [list(s) if isinstance(s, tuple) else s for s in spec]


def test_input_specs_match_repro(jax_launcher):
    """Every cell's inputs on both meshes: shapes, dtypes and specs."""
    want = jax_launcher["inputs"]
    assert len(want) == 2 * len(ARCH_IDS) * len(SHAPES)
    for key, leaves in want.items():
        which, aid, sh = key.split("/")
        mesh = meta_mesh(*MESHES[which])
        batch = dryrun.input_specs(aid, sh, mesh)
        cfg, opts = dryrun.VARIANTS["base"](get_arch(aid), SHAPES[sh])
        _, specs = dryrun._batch_specs(cfg, SHAPES[sh], mesh, opts)
        assert set(batch) == set(leaves), key
        for k, (shape, dtype, spec) in leaves.items():
            assert list(batch[k].shape) == shape, (key, k)
            assert str(batch[k].dtype).split(".")[-1] == dtype, (key, k)
            assert batch[k].device.type == "meta"
            assert _jsonable(specs[k]) == spec, (key, k)


def test_variants_match_repro(jax_launcher):
    """The same 20 names, giving equal configs and options everywhere."""
    want = jax_launcher["variants"]
    assert {k.split("/")[0] for k in want} == set(dryrun.VARIANTS)
    assert len(dryrun.VARIANTS) == 20
    for key, (cfg_j, opts_j) in want.items():
        name, aid, sh = key.split("/")
        cfg, opts = dryrun.VARIANTS[name](get_arch(aid), SHAPES[sh])
        assert dataclasses.asdict(cfg) == cfg_j, key
        assert opts == opts_j, key


# --------------------------------------------------------------------------
# the meta plan against a real run
# --------------------------------------------------------------------------
SMALL = {"train": ShapeConfig("t", 16, 2, "train"),
         "prefill": ShapeConfig("p", 16, 2, "prefill"),
         "decode": ShapeConfig("d", 16, 2, "decode")}


def _real_batch(cfg, shape):
    gen = torch.Generator().manual_seed(0)
    meta, _ = dryrun._batch_specs(cfg, shape, meta_mesh((1, 1), ("data",
                                                                 "model")),
                                  {})
    out = {}
    for k, v in meta.items():
        if v.is_floating_point():
            out[k] = torch.randn(v.shape, generator=gen)
        elif k == "positions":
            out[k] = torch.arange(v.shape[-1]).expand(v.shape).to(v.dtype)
        else:
            out[k] = torch.randint(0, cfg.vocab, v.shape, generator=gen,
                                   dtype=v.dtype)
    return out


@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("arch", ["minicpm-2b", "mixtral-8x22b",
                                  "mamba2-370m"])
def test_meta_plan_flops_equal_a_real_run(arch, kind):
    """The meta trace's FLOPs equal ``FlopCounterMode`` over the same
    program on real CPU tensors (dense, MoE, SSM smoke configs)."""
    cfg, shape = get_smoke(arch), SMALL[kind]
    plan = dryrun.trace_cell(cfg, shape, {})
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _real_batch(cfg, shape)
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            from repro_torch.models import optim
            lm.make_train_step(cfg)(model, optim.adamw_init(model), batch)
        elif kind == "prefill":
            lm.prefill(cfg, model, batch, max_len=shape.seq_len)
        else:
            caches = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                                   device="cpu")
            lm.decode_step(cfg, model, caches, batch["token"],
                           shape.seq_len - 1)
    assert plan["flops"] > 0
    assert plan["flops"] == fc.get_total_flops()
    assert plan["bytes"] > 0 and plan["largest_output"] > 0
    if kind == "train":
        assert plan["saved_bytes"] > 0


def test_trace_fails_on_a_tensor_off_meta():
    """A tensor on another device during a meta trace fails the cell."""
    with pytest.raises(RuntimeError, match="during a meta trace"):
        with dryrun.OpBytes():
            torch.ones(2, device="meta") + torch.ones(2)
    with dryrun.OpBytes() as counter:    # an empty marker holds no data
        torch.empty((0,), requires_grad=True)
    assert counter.ops == 1


def test_lm_plan_records_and_links():
    """One cell on both meshes: one trace, the mesh-independent numbers
    shared, the shard bytes and collectives each mesh's own, every
    collective with its link; the card's arguments are its parameter
    shards, gradients and float32 moments."""
    meshes = [meta_production_mesh(False), meta_production_mesh(True)]
    cfg = dataclasses.replace(get_arch("mamba2-370m"), n_layers=2)
    trace = dryrun.trace_cell(cfg, SHAPES["train_4k"], {})
    single, multi = (dryrun.plan_cell(cfg, SHAPES["train_4k"], m, {}, trace)
                     for m in meshes)
    assert single["mesh"] == "16x16" and multi["mesh"] == "2x16x16"
    assert single["flops_per_chip"] == 2 * multi["flops_per_chip"]
    assert single["flops_per_chip"] * 256 == trace["flops"]
    shard = lm.param_shardings(cfg, meshes[0])
    params = sum(v[2] for v in shard.values())
    assert single["parameter_bytes"] == params
    assert single["moment_bytes"] == 2 * params      # float32 weights
    assert single["bytes_per_device"] == (
        single["argument_size_in_bytes"] + single["temp_size_in_bytes"])
    for rec in (single, multi):
        assert {e["link"] for e in rec["collective_links"]} == {"net"}
        assert rec["collective_s"] == pytest.approx(
            sum(e["bytes"] for e in rec["collective_links"]) / rl.NET_BW)
        assert rec["collectives"]["all-reduce"]["count"] > 0
    assert single["inert"] == []
    cfg, opts = dryrun.VARIANTS["act_pin_all"](get_arch("qwen3-14b"),
                                              SHAPES["train_4k"])
    assert [k for k in dryrun.INERT_OPTS if opts.get(k)] == ["act_pin"]


def test_link_rule():
    """NVLink within a node of 8 consecutive cards, the network across;
    the production mesh's axes both leave the node."""
    mesh = meta_mesh((16, 16), ("data", "model"))
    assert rl.link_of(mesh, "model") == rl.link_of(mesh, "data") == "net"
    small = meta_mesh((2, 8), ("data", "model"))
    assert rl.link_of(small, "model") == "nvlink"
    assert rl.link_of(small, "data") == "net"
    assert rl.link_of(meta_mesh((1, 1), ("data", "model")), "data") == "none"
    assert make_production_mesh(multi_pod=True,
                                devices=["meta"] * 512).size == 512


# --------------------------------------------------------------------------
# the GBDT plan against the port's collectives
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def gbdt_data():
    rng = np.random.default_rng(0)
    n, F = 2000, 8
    codes = torch.from_numpy(rng.integers(0, 32, (n, F)).astype(np.uint8))
    return (codes, codes.T.contiguous(),
            torch.from_numpy(rng.normal(size=n).astype(np.float32)),
            torch.from_numpy(rng.random(n).astype(np.float32)))


@pytest.mark.parametrize("variant", dryrun_gbdt.VARIANTS)
@pytest.mark.parametrize("shape", [(4, 2), (2, 2, 2)])
def test_gbdt_plan_collectives_equal_the_port(gbdt_data, shape, variant):
    """Kind, count and bytes of every collective of one depth-6 tree on a
    CPU mesh, as ``collective_stats()`` counts them, equal the plan's."""
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    mesh = make_mesh(shape, axes, devices=["cpu"] * 8)
    codes, codes_cm, g, h = gbdt_data
    F, NB = codes.shape[1], 32
    kw = dict(depth=6, n_bins=NB, missing_bin=NB - 1, lambda_=1.0,
              gamma=0.0, min_child_weight=1.0)
    masks = (torch.zeros(F, dtype=torch.bool), torch.ones(F, dtype=torch.bool))
    sharding.reset_collective_stats()
    if variant == "base":
        sharding.pjit_fit_tree(mesh, **kw)(codes, codes_cm, g, h, *masks)
    else:
        sharding.distributed_fit_tree(
            mesh, codes, codes_cm, g, h, is_cat_field=masks[0],
            field_mask=masks[1], partition_bits="bits" in variant,
            hist_dtype=torch.bfloat16 if "bf16" in variant else None, **kw)
    got = sharding.collective_stats()
    plan = dryrun_gbdt.plan_levels(mesh, n_records=codes.shape[0],
                                   n_fields=F, n_bins=NB, depth=6,
                                   variant=variant)
    assert got == rl.by_kind(dryrun_gbdt.plan_collectives(plan))
    assert got["all-reduce"]["count"] > 6


def test_gbdt_plan_single_pod_shard():
    """The single-pod plan's card: 12,500,000 records x 4 fields."""
    rec = dryrun_gbdt.run(False, "explicit", 200_000_000, 64, 256, 6)
    assert (rec["records_per_card"], rec["fields_per_card"]) == (12_500_000,
                                                                   4)
    assert rec["chips"] == 256 and len(rec["levels"]) == 6
    assert rec["collectives"]["all-gather"]["count"] == 12


# --------------------------------------------------------------------------
# the report and the CLIs
# --------------------------------------------------------------------------
def _records(tmp_path):
    meshes = [meta_production_mesh(False)]
    (ok,) = dryrun.run_cell("mamba2-370m", "decode_32k", meshes)
    recs = {"single_mamba2-370m_decode_32k": ok,
            "single_qwen3-14b_long_500k": {
                "arch": "qwen3-14b", "shape": "long_500k",
                "variant": "base", "mesh": "16x16", "skipped": True,
                "reason": "full attention"},
            "single_minicpm-2b_train_4k": {
                "arch": "minicpm-2b", "shape": "train_4k", "mesh": "16x16",
                "variant": "base", "error": "boom", "traceback": "tb"},
            "single_minicpm-2b_train_4k_no_remat": dict(
                ok, arch="minicpm-2b", shape="train_4k",
                variant="no_remat")}
    for name, rec in recs.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    return recs


def test_report_rows_match_repro(tmp_path):
    """``roofline_rows`` of one directory, with SKIP and FAIL records and a
    variant's, equal ``repro``'s rows; both read the same records."""
    _records(tmp_path)
    for variant in ("base", "no_remat"):
        got = report.roofline_rows(report.load(str(tmp_path), "single",
                                               variant))
        want = jreport.roofline_rows(jreport.load(str(tmp_path), "single",
                                                  variant))
        assert got == want
    base = report.roofline_rows(report.load(str(tmp_path)))
    assert [r["status"] for r in base] == ["ok", "FAIL", "SKIP"]


def _cli(module, *args):
    return subprocess.run([sys.executable, "-m", module, *args], env=_ENV,
                          cwd=_ROOT, capture_output=True, text=True,
                          timeout=300)


def test_clis_exit_0_on_a_small_cell(tmp_path):
    """``dryrun`` on one cell, ``dryrun_gbdt`` on a small dataset, then
    ``report`` over the LM records."""
    res = _cli("repro_torch.launch.dryrun", "--arch", "mamba2-370m",
               "--shape", "decode_32k", "--mesh", "both", "--out",
               str(tmp_path))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "0 failures" in res.stdout
    rec = json.loads((tmp_path / "multi_mamba2-370m_decode_32k.json")
                     .read_text())
    assert rec["mesh"] == "2x16x16" and rec["chips"] == 512
    res = _cli("repro_torch.launch.dryrun_gbdt", "--records", "20000",
               "--fields", "32", "--mesh", "both", "--variant",
               "explicit_bits_bf16", "--out", str(tmp_path))
    assert res.returncode == 0, res.stdout + res.stderr
    rec = json.loads((tmp_path / "single_gbdt_explicit_bits_bf16.json")
                     .read_text())
    assert rec["shape"] == "fit_tree_20000x32" and "plan_s" in rec
    res = _cli("repro_torch.launch.report", "--dir", str(tmp_path))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "mamba2-370m | decode_32k | ok" in res.stdout


def test_failing_cell_is_recorded_and_exits_1(tmp_path, monkeypatch):
    """A cell that raises is written with its error and traceback, and the
    run exits 1."""
    def boom(*a, **kw):
        raise RuntimeError("no plan")

    monkeypatch.setattr(dryrun, "trace_cell", boom)
    with pytest.raises(SystemExit) as exit_:
        dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert exit_.value.code == 1
    rec = json.loads((tmp_path / "single_mamba2-370m_decode_32k.json")
                     .read_text())
    assert rec["error"] == "no plan" and "RuntimeError" in rec["traceback"]
