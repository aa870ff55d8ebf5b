"""The port's launch drivers, H100 roofline and step journal, on the CPU.

The train CLI's SIGTERM round trip runs as subprocesses (a real signal,
exit code 75, then ``--resume``) and must finish bit-equal to an
uninterrupted run: on the CPU the plain kernels are deterministic and a
resumed fit replays its margins round by round.  The other CLI cases run
``main`` in this process.  The roofline is held to ``repro``'s
arithmetic: the same formulas, with the H100's datasheet peaks.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.launch import roofline as jrl
from repro_torch.api import serialize
from repro_torch.distributed import fault, sharding
from repro_torch.launch import roofline as rl
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import make_mesh

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_ENV = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
FIELDS = ("feature", "threshold", "is_cat", "default_left", "leaf_value")


def _train_args(ckpt, *extra, records=3000, trees=6):
    return ["--device", "cpu", "--records", str(records), "--trees",
            str(trees), "--depth", "4", "--max-bins", "32", "--ckpt-every",
            "2", "--ckpt-dir", str(ckpt), *extra]


def _history(out: str):
    line = [ln for ln in out.splitlines() if ln.startswith("[train] history")]
    return json.loads(line[-1].split(" ", 2)[2])


def _final_trees(ckpt):
    est, _ = serialize.load_checkpoint(str(ckpt), device="cpu")
    return est.model_.trees


def test_train_cli_sigterm_exit_75_then_resume_is_bit_equal(tmp_path):
    """SIGTERM after the first checkpoint: exit code 75 with a committed
    checkpoint; ``--resume`` grows the remaining trees, and the ensemble
    and the loss history equal an uninterrupted run's bit for bit."""
    trees = 80
    cmd = [sys.executable, "-m", "repro_torch.launch.train"]
    full = subprocess.run(cmd + _train_args(tmp_path / "full",
                                            trees=trees),
                          env=_ENV, cwd=_ROOT, capture_output=True,
                          text=True, timeout=300)
    assert full.returncode == 0, full.stdout + full.stderr
    ckpt = tmp_path / "cut"
    proc = subprocess.Popen(cmd + _train_args(ckpt, trees=trees), env=_ENV,
                            cwd=_ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    journal = fault.StepJournal(str(ckpt / "journal.jsonl"))
    deadline = time.monotonic() + 240
    while journal.last_step() is None and proc.poll() is None \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == train.EX_TEMPFAIL, out + err
    assert "interrupted (SIGTERM)" in out
    cut = _history(out)["train_loss"]
    assert 0 < len(cut) < trees
    resumed = subprocess.run(cmd + _train_args(ckpt, "--resume",
                                               trees=trees),
                             env=_ENV, cwd=_ROOT, capture_output=True,
                             text=True, timeout=300)
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    assert cut + _history(resumed.stdout)["train_loss"] == \
        _history(full.stdout)["train_loss"]
    for f, a, b in zip(FIELDS, _final_trees(ckpt),
                       _final_trees(tmp_path / "full")):
        assert torch.equal(a, b), f


def test_train_cli_resume_without_checkpoint_refused(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint"):
        train.main(_train_args(tmp_path, "--resume"))


def test_train_cli_data_shards_and_stream(tmp_path, capsys):
    """``--data-shards 2`` on the CPU runs the distributed trainer on two
    shards (losses within rtol 1e-5 of one device's); ``--stream`` trains
    out-of-core from npz shards through a ``RetryingSource``."""
    train.main(_train_args(tmp_path / "one"))
    one = _history(capsys.readouterr().out)["train_loss"]
    train.main(_train_args(tmp_path / "two", "--data-shards", "2"))
    out = capsys.readouterr().out
    assert "shards 2 on ['cpu', 'cpu']" in out
    np.testing.assert_allclose(_history(out)["train_loss"], one, rtol=1e-5)
    train.main(_train_args(tmp_path / "stream", "--stream"))
    out = capsys.readouterr().out
    assert "[train] resilience:" in out and os.path.isdir(
        tmp_path / "stream" / "shards")
    np.testing.assert_allclose(_history(out)["train_loss"], one, rtol=1e-4)
    with pytest.raises(SystemExit, match="cannot combine"):
        train.main(_train_args(tmp_path / "x", "--stream", "--data-shards",
                               "2"))


def test_train_cli_more_shards_than_cuda_devices_refused(tmp_path):
    n = torch.cuda.device_count()
    with pytest.raises(SystemExit, match="exceeds the"):
        train.main(_train_args(tmp_path, "--device", "cuda",
                               "--data-shards", str(max(2, n + 1))))


@pytest.mark.parametrize("cli", [train, serve], ids=["train", "serve"])
def test_lm_mode_names_its_roadmap_item(cli, capsys):
    """``--mode lm`` runs on the CPU when asked: ``train`` (item 10b,
    ported) trains the default arch's smoke config for three steps and
    prints its step-0 loss, finite and within 0.1 of ln(256) = 5.545 (a
    0.02-std init gives logits of std ~0.02 x sqrt(64) = 0.16 at the smoke
    width); its weights come from a torch generator, not ``repro``'s
    threefry, so the losses are not ``repro``'s.  ``serve`` (item 10a)
    serves and prints its prefill and decode lines."""
    if cli is train:
        cli.main(["--mode", "lm", "--device", "cpu", "--trees", "3"])
        out = capsys.readouterr().out
        line = [ln for ln in out.splitlines()
                if ln.startswith("[lm] step 0 loss ")]
        assert len(line) == 1, out
        loss = float(line[0].rsplit(" ", 1)[1])
        assert np.isfinite(loss) and abs(loss - np.log(256)) < 0.1
        assert "[lm] done: 3 steps on cpu" in out
        return
    cli.main(["--mode", "lm", "--device", "cpu", "--prompt-len", "16",
              "--gen", "8"])
    out = capsys.readouterr().out
    assert "[serve] prefill 4x16: " in out
    assert "[serve] decoded 7 steps x 4 seqs (greedy): " in out


@pytest.mark.parametrize("arch,extra", [
    ("qwen3-14b", []), ("mixtral-8x22b", []), ("whisper-large-v3", []),
    ("mamba2-370m", ["--no-greedy", "--temperature", "0.7"])])
def test_serve_cli_lm_prints_prefill_and_decode(arch, extra, capsys):
    """``--mode lm`` on the CPU: one prefill of the smoke config, then
    ``--gen - 1`` decode steps (mixtral's 40-token prompt passes its
    32-token window), with ``repro``'s driver's lines."""
    prompt = "40" if arch == "mixtral-8x22b" else "16"
    serve.main(["--mode", "lm", "--device", "cpu", "--arch", arch,
                "--batch", "2", "--prompt-len", prompt, "--gen", "8",
                *extra])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"[serve] prefill 2x{prompt}: ")
    mode = "sampled@T=0.7" if extra else "greedy"
    assert out[1].startswith(f"[serve] decoded 7 steps x 2 seqs ({mode}): ")
    assert out[1].endswith("on cpu")
    first = out[2].split(": ", 1)[1].removesuffix(" ...")
    assert len(json.loads(first)) == 8


def test_serve_cli_gbdt_zero_retraces_and_drops(tmp_path, capsys):
    """The serving driver on the CPU over small tenants saved where it
    looks for its demo bundles: warm-up, the hot swap half way, both
    verdicts OK."""
    from repro_torch.api import (BoosterClassifier, BoosterRegressor,
                                 make_tabular)

    for name, cls, task, seed in (
            ("m0_binary", BoosterClassifier, "binary", 0),
            ("m1_regression", BoosterRegressor, "regression", 1),
            ("m0_binary_v2", BoosterClassifier, "binary", 100)):
        X, y, cats = make_tabular(1500, 20, 8, n_cats=12, task=task,
                                  seed=seed)
        cls(n_trees=6, max_depth=4, max_bins=64, categorical_fields=cats,
            device="cpu").fit(X, y).save(str(tmp_path / name))
    serve.main(["--device", "cpu", "--model-dir", str(tmp_path),
                "--batch", "300", "--requests", "8"])
    out = capsys.readouterr().out
    assert "no bundle" not in out
    assert "hot-swapped m0_binary -> v2" in out
    assert "(zero silent drops: OK)" in out
    assert "zero retraces across hot-swap: OK" in out
    assert serve.request_sizes(300) == [300, 150, 225, 100]


# --------------------------------------------------------------------------
# the H100 roofline against repro's arithmetic
# --------------------------------------------------------------------------
def test_roofline_peaks_are_the_h100_datasheet():
    assert (rl.PEAK_FLOPS, rl.PEAK_FLOPS_FP32, rl.HBM_BW, rl.LINK_BW) == \
        (989e12, 67e12, 3.35e12, 450e9)


@pytest.mark.parametrize("args", [(197e12, 819e9 / 2, 0.0),
                                  (1e12, 1e12, 1e12), (0.0, 0.0, 0.0),
                                  (5e9, 3e12, 7e8)])
def test_roofline_terms_match_jax_arithmetic(args):
    """The H100's terms are ``repro``'s arithmetic at the H100's peaks:
    ``repro``'s function on inputs rescaled by the ratio of the peaks
    gives the same terms (rtol 1e-12), the same dominant term and the same
    fraction."""
    f, b, c = args
    got = rl.roofline_terms(f, b, c)
    assert got["compute_s"] == f / 989e12 and got["memory_s"] == b / 3.35e12
    assert got["collective_s"] == c / 450e9
    want = jrl.roofline_terms(f * jrl.PEAK_FLOPS / rl.PEAK_FLOPS,
                              b * jrl.HBM_BW / rl.HBM_BW,
                              c * jrl.LINK_BW / rl.LINK_BW)
    assert got["dominant"] == want["dominant"]
    for key in ("compute_s", "memory_s", "collective_s",
                "roofline_fraction"):
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0)


def test_model_flops_shape_bytes_and_format_table():
    for kind in ("train", "prefill", "decode"):
        assert rl.model_flops(kind, 10, 7) == jrl.model_flops(kind, 10, 7)
    assert rl._shape_bytes("bfloat16[2,3]") == jrl._shape_bytes(
        "bf16[2,3]{1,0}") == 12
    assert rl._shape_bytes("uint8[10]") == 10
    assert rl._shape_bytes("(float32[4], int32[2])") == 24
    rows = [{"cell": "higgs", "ms": 1.25, "bound": "bytes"},
            {"cell": "covertype-7", "ms": 10}]
    keys = ["cell", "ms", "bound"]
    assert rl.format_table(rows, keys) == jrl.format_table(rows, keys)


def test_collectives_read_the_mesh_counters():
    """``collectives`` takes ``collective_stats()`` (the mesh collectives
    the port ran) in place of HLO text and returns ``parse_collectives``'
    shape: every kind, its count and bytes."""
    mesh = make_mesh((2,), ("data",), devices=["cpu", "cpu"])
    sharding.reset_collective_stats()
    sharding.psum(mesh, [[torch.ones(16, 128)], [torch.ones(16, 128)]],
                  "data")
    out = rl.collectives()
    assert set(out) == set(jrl.parse_collectives(""))
    assert out["all-reduce"] == {"count": 1, "bytes": 2 * 16 * 128 * 4}
    assert rl.collective_bytes() == 2 * 16 * 128 * 4
    assert rl.collectives({})["all-gather"] == {"count": 0, "bytes": 0}


# --------------------------------------------------------------------------
# the step journal and the restart driver
# --------------------------------------------------------------------------
def test_journal_survives_torn_writes(tmp_path):
    j = fault.StepJournal(str(tmp_path / "sub" / "j.jsonl"))
    assert j.last_step() is None and j.entries() == []
    j.append(0, {"loss": 1.0})
    j.append(1, {"loss": 0.5})
    with open(j.path, "a") as f:
        f.write('{"step": 2, "loss":')  # torn tail
    assert j.last_step() == 1
    assert [e["loss"] for e in j.entries()] == [1.0, 0.5]


def test_run_with_restarts_resumes_after_the_last_step():
    starts, seen = [], []

    def make_trainer(start):
        starts.append(start)
        for step in range(start, 6):
            if step in (2, 4) and len(starts) <= 2 and step not in seen:
                seen.append(step)
                raise RuntimeError(f"worker lost at {step}")
            yield step

    restarts = []
    last = fault.run_with_restarts(make_trainer, max_restarts=3,
                                   on_restart=lambda k, e:
                                   restarts.append((k, str(e))))
    assert last == 5 and starts == [0, 2, 4]
    assert restarts == [(1, "worker lost at 2"), (2, "worker lost at 4")]

    def always(start):
        yield start
        raise RuntimeError("down")

    with pytest.raises(RuntimeError, match="down"):
        fault.run_with_restarts(always, max_restarts=2)


def test_moved_fault_names_warn():
    from repro_torch.resilience import faults
    for name in ("Fault", "FaultInjector", "FaultSchedule"):
        with pytest.warns(DeprecationWarning, match="resilience.faults"):
            assert getattr(fault, name) is getattr(faults, name)
    with pytest.raises(AttributeError):
        fault.NoSuchName
