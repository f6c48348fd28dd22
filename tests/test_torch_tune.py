"""The port's schedule autotuner (``mxnet_tpu_torch.tune``) against the JAX
package's (``mxnet_tpu.tune``), on the CPU.

- The schedule table: a table the port writes, ``"cuda"`` and ``"cpu"``
  records of every kind, loads in ``mxnet_tpu.tune.ScheduleTable`` with
  every record kept, and a JAX-written table (``"tpu"`` and ``"cpu"``)
  in the port's; ``make_key`` is the same string; a corrupt or
  version-mismatched table behaves as empty and is rewritten whole by the
  next commit; the memo, ``reload`` and the miss registry behave as the
  JAX package's.
- Tiles: the blocked plain flash attention at every candidate ``(block_q,
  block_k)`` against the JAX ``flash_attention`` at the same blocks in
  interpret mode, forward and ``jax.vjp`` gradient (fp32, rtol 1e-4 /
  atol 1e-5); the plain B1-B3 at every ``chan_block`` / pixel split
  against the JAX Pallas kernels in interpret mode (under the test-local
  ``TPUCompilerParams`` alias), the same tolerance.
- The consult: a table entry is run by ``flash_attention`` and the fused
  kernels; an entry that does not fit the shape counts a
  ``fallback_illegal`` and runs the hand default; ``MXNET_TPU_TUNE=0``
  reads nothing.
- ``python -m mxnet_tpu_torch.tune --cpu`` end to end at a small shape
  (the report line, a second run all cache hits, ``--compare``); the
  sweep entry points default to ``cuda``.
- ``Module.fit`` with ``MXNET_TUNE_BACKGROUND=1`` on a tiny fused ResNet
  commits at its drain boundary, and the next consult of that key hits.
- ``graph_fingerprint``, ``schedule_of`` and ``choice_of`` equal the JAX
  package's on the same Symbol JSON (ResNet-50, LeNet);
  ``decode_schedule_shape`` and the sweepable kernels are the JAX
  package's.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import mxnet_tpu as jmx
import mxnet_tpu.tune as jtune
from mxnet_tpu.kernels import fused_block as jfb
from mxnet_tpu.kernels.flash_attention import flash_attention as jax_flash
from mxnet_tpu.tune import table as jtable

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import profiler, tune
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import flash_attention as tfa
from mxnet_tpu_torch.kernels import fused_block as tfb
from mxnet_tpu_torch.tune import table as ttable

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _fresh_table(monkeypatch, tmp_path):
    """A table of each test's own, and both packages' process state reset
    around it."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)
    monkeypatch.setenv("MXNET_TPU_TUNE_TABLE", str(tmp_path / "table.json"))
    monkeypatch.delenv("MXNET_TPU_TUNE", raising=False)
    monkeypatch.delenv("MXNET_TUNE_MODEL", raising=False)
    for pkg in (tune, jtune):
        pkg.reset()
    profiler.tuning_reset()
    yield
    for pkg in (tune, jtune):
        pkg.reset()
    profiler.tuning_reset()


def _record(kernel, shape, schedule, ms=1.0):
    return {"schedule": dict(schedule), "ms_per_iter": ms,
            "default_schedule": dict(schedule), "default_ms_per_iter": ms,
            "speedup_vs_default": 1.0,
            "timings": [{"schedule": dict(schedule), "ms_per_iter": ms,
                         "plan": tune.plan_for(kernel, shape, schedule)}]}


PORT_RECORDS = [
    ("fused_fwd", (64, 14, 14, 256, 256, 3, 1), {"chan_block": 128}),
    ("fused_wgrad", (64, 14, 14, 256, 256, 3, 1), {"row_tile": 16}),
    ("fused_dgrad", (64, 14, 14, 256, 256, 3, 1), {"chan_block": 64}),
    ("flash_attention", (8, 8, 2048, 2048, 64, 1),
     {"block_q": 128, "block_k": 64}),
    ("flash_attention", (8, 8, 1, 1024, 128, 0),
     {"block_q": 64, "block_k": 128}),
]


@pytest.mark.parametrize("kernel,shape,dtype,backend", [
    ("fused_fwd", (2, 8, 8, 32, 32, 3, 1), "bfloat16", "cuda"),
    ("flash_attention", (8, 8, 2048, 2048, 64, 1), "float32", "cpu"),
    ("train_pipeline", (123456, 4, 3, 32, 32), "float32", "tpu")])
def test_make_key_is_the_jax_packages(kernel, shape, dtype, backend):
    assert tune.make_key(kernel, shape, dtype, backend) == \
        jtune.make_key(kernel, shape, dtype, backend)


def test_port_table_loads_in_jax_with_every_record(tmp_path):
    path = str(tmp_path / "port.json")
    t = tune.ScheduleTable(path)
    keys = []
    for backend in ("cuda", "cpu"):
        for kernel, shape, sched in PORT_RECORDS:
            keys.append(t.record(kernel, shape, "bfloat16", backend,
                                 _record(kernel, shape, sched)))
    t.record(tune.PIPELINE_KERNEL, (7, 4, 3, 32, 32), "float32", "cuda",
             _record("flash_attention", PORT_RECORDS[3][1],
                     {"block_q": 64, "block_k": 64}) | {
                 "schedule": tune.schedule_of({"remat": "pass",
                                               "layout": "on"})})
    j = jtable.ScheduleTable(path)
    assert len(j) == len(t) == len(keys) + 1 and j.load_error is None
    assert j.entries() == t.entries()
    for backend in ("cuda", "cpu"):
        for kernel, shape, sched in PORT_RECORDS:
            assert j.lookup(kernel, shape, "bfloat16", backend,
                            record_stats=False) == sched


def test_jax_table_loads_in_the_port_with_every_record(tmp_path):
    path = str(tmp_path / "jax.json")
    j = jtable.ScheduleTable(path)
    recs = [("fused_fwd", (2, 8, 8, 32, 32, 3, 1),
             {"row_tile": 4, "chan_block": 128, "batch_fold": 2}, "tpu"),
            ("flash_attention", (2, 2, 64, 64, 16, 1),
             {"block_q": 16, "block_k": 32}, "cpu"),
            ("train_pipeline", (99, 4, 3, 32, 32),
             {"remat": 2, "layout": 1}, "tpu")]
    for kernel, shape, sched, backend in recs:
        j.record(kernel, shape, "float32", backend,
                 {"schedule": sched, "ms_per_iter": 1.0})
    t = tune.ScheduleTable(path)
    assert len(t) == len(recs) and t.load_error is None
    assert t.entries() == j.entries()
    for kernel, shape, sched, backend in recs:
        assert t.lookup(kernel, shape, "float32", backend,
                        record_stats=False) == sched


@pytest.mark.parametrize("raw", ["{not json", "[1, 2]",
                                 '{"version": 2, "entries": {}}',
                                 '{"version": 1, "entries": {"k": '
                                 '{"schedule": {"tile": 3}}}}'],
                         ids=["garbage", "list", "version", "knob"])
def test_corrupt_table_falls_back_and_is_rewritten(tmp_path, raw):
    path = tmp_path / "bad.json"
    path.write_text(raw)
    shape = (2, 8, 8, 32, 32, 3, 1)
    for pkg in (ttable, jtable):
        t = pkg.ScheduleTable(str(path))
        assert t.lookup("fused_fwd", shape, "float32", "cpu",
                        record_stats=False) is None
        assert t.load_error
    t = tune.ScheduleTable(str(path))
    t.record("fused_fwd", shape, "float32", "cpu",
             {"schedule": {"chan_block": 64}, "ms_per_iter": 1.0})
    data = json.loads(path.read_text())
    assert data["version"] == tune.TABLE_VERSION and len(data["entries"]) == 1
    assert t.load_error is None
    assert jtable.ScheduleTable(str(path)).lookup(
        "fused_fwd", shape, "float32", "cpu", record_stats=False) == \
        {"chan_block": 64}
    with pytest.raises(ValueError, match="known integer knobs"):
        t.record("fused_fwd", shape, "float32", "cpu",
                 {"schedule": {"chan_block": 0}})


def test_memo_reload_and_the_merged_timing_bank(tmp_path):
    path = str(tmp_path / "t.json")
    shape = (1, 1, 64, 64, 64, 1)
    a, b = tune.ScheduleTable(path), tune.ScheduleTable(path)
    assert a.lookup("flash_attention", shape, "bfloat16", "cpu") is None
    b.record("flash_attention", shape, "bfloat16", "cpu",
             _record("flash_attention", shape,
                     {"block_q": 64, "block_k": 64}, 2.0))
    # a's memo keeps its miss until a reload
    assert a.lookup("flash_attention", shape, "bfloat16", "cpu") is None
    a.reload()
    assert a.lookup("flash_attention", shape, "bfloat16", "cpu") == \
        {"block_q": 64, "block_k": 64}
    # a second commit merges the banked timings (a fresh row wins)
    a.record("flash_attention", shape, "bfloat16", "cpu",
             _record("flash_attention", shape,
                     {"block_q": 128, "block_k": 64}, 1.0))
    b.reload()
    rows = {tuple(sorted(r["schedule"].items())): r["ms_per_iter"]
            for r in b.entry("flash_attention", shape, "bfloat16",
                             "cpu")["timings"]}
    assert rows == {(("block_k", 64), ("block_q", 64)): 2.0,
                    (("block_k", 64), ("block_q", 128)): 1.0}


def test_consults_count_and_record_misses(monkeypatch):
    shape = (1, 2, 64, 64, 64, 1)
    q = torch.randn(1, 2, 64, 64)
    tfa.flash_attention(q, q, q, causal=True)
    tfa.flash_attention(q, q, q, causal=True)
    stats = profiler.tuning_stats()
    assert stats["misses"] == 2 and stats["hits"] == 0
    key = tune.make_key("flash_attention", shape, "float32", "cpu")
    assert [(m["key"], m["count"]) for m in tune.recorded_misses()] == \
        [(key, 2)]
    tune.get_table().record("flash_attention", shape, "float32", "cpu",
                            _record("flash_attention", shape,
                                    {"block_q": 64, "block_k": 64}))
    assert tune.recorded_misses() == []
    tfa.flash_attention(q, q, q, causal=True)
    stats = profiler.tuning_stats()
    assert stats["hits"] == 1
    assert stats["kernels"][key] == {"schedule": {"block_q": 64,
                                                  "block_k": 64},
                                     "source": "table"}
    monkeypatch.setenv("MXNET_TPU_TUNE", "0")
    profiler.tuning_reset()
    tfa.flash_attention(q, q, q, causal=True)
    assert profiler.tuning_stats() == {}
    assert tune.schedule_for("flash_attention", shape, "float32") is None


# ---------------------------------------------------------------------------
# tiles: the blocked plain versions against the JAX package's kernels
# ---------------------------------------------------------------------------
def _flash_both(d, causal, blocks, seed, s=256):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(1, 2, s, d).astype(np.float32)
                   for _ in range(4))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, **blocks)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    want, vjp = jax.vjp(lambda *a: jax_flash(*a, causal=causal,
                                             interpret=True, **blocks),
                        *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    for g, w in zip(grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tile", [(64, 64), (64, 128), (128, 64),
                                  (128, 128)], ids=lambda t: "%dx%d" % t)
def test_blocked_plain_flash_matches_jax_at_every_tile(tile, causal):
    cands = [c["schedule"] for c in tune.flash_candidates(256, 256, d=64)
             if c["status"] in ("default", "candidate")]
    blocks = dict(block_q=tile[0], block_k=tile[1])
    assert blocks in cands
    _flash_both(64, causal, blocks, seed=tile[0] + tile[1] + causal)


@pytest.mark.parametrize("d", [192, 256])
def test_blocked_plain_flash_matches_jax_at_d192_d256(d):
    cands = [c["schedule"] for c in tune.flash_candidates(128, 128, d=d)
             if c["status"] in ("default", "candidate")]
    assert cands == [{"block_q": 64, "block_k": 64}]
    _flash_both(d, True, cands[0], seed=d, s=128)


def test_flash_candidates_prune_by_the_kernels_tiles():
    def status(entries):
        return {tuple(e["schedule"].values()): e["status"] for e in entries}

    assert status(tune.flash_candidates(1024, 1024, d=128)) == {
        (64, 64): "pruned_duplicate", (64, 128): "candidate",
        (128, 64): "candidate", (128, 128): "candidate"}
    assert set(status(tune.flash_candidates(1024, 1024, d=200)).values()) \
        == {"pruned_duplicate", "pruned_illegal"}
    assert set(status(tune.flash_candidates(1024, 1024, d=64,
                                            dtype="float32")).values()) \
        == {"pruned_duplicate", "pruned_illegal"}
    decode = status(tune.flash_candidates(1, 1024, d=64))
    assert decode[(128, 64)] == decode[(128, 128)] == "pruned_illegal"
    assert decode[(64, 128)] == "candidate"


CONV = (2, 8, 128, 128)     # n, h, ci, co


def _conv_arrays(k, seed):
    n, h, ci, co = CONV
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, h, ci).astype(np.float32)
    w = (rng.randn(k, k, ci, co) / np.sqrt(k * k * ci)).astype(np.float32)
    scale = (rng.rand(ci) + 0.5).astype(np.float32)
    bias = (rng.randn(ci) * 0.5).astype(np.float32)
    g = rng.randn(n, h, h, co).astype(np.float32)
    return x, w, scale, bias, g


@pytest.mark.parametrize("chan_block", [64, 128])
def test_plain_fwd_and_dgrad_match_jax_at_every_chan_block(chan_block):
    x, w, scale, bias, g = _conv_arrays(3, chan_block)
    sched = {"chan_block": chan_block}
    shape = (CONV[0], CONV[1], CONV[1], CONV[2])
    for kernel in ("fused_fwd", "fused_dgrad"):
        assert sched in [c["schedule"] for c in tune.fused_candidates(
            kernel, shape, w.shape, 1)
            if c["status"] in ("default", "candidate")]
    jy, jst = jfb.conv_fwd(jnp.asarray(x), jnp.asarray(w),
                           prologue=(jnp.asarray(scale), jnp.asarray(bias),
                                     True), emit_stats=True, interpret=True)
    ty, tst = tfb.conv_fwd_reference(
        torch.tensor(x), torch.tensor(w),
        prologue=(torch.tensor(scale), torch.tensor(bias), True),
        emit_stats=True, schedule=sched)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=RTOL,
                               atol=1e-3)
    jdx = jfb.conv_dgrad(jnp.asarray(g), jnp.asarray(w), x.shape,
                         interpret=True)
    tdx, _ = tfb.conv_dgrad_reference(torch.tensor(g), torch.tensor(w),
                                      x.shape, schedule=sched)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx[0]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("k", [1, 3])
def test_plain_wgrad_matches_jax_at_every_split(k):
    x, w, scale, bias, g = _conv_arrays(k, 30 + k)
    shape = (CONV[0], CONV[1], CONV[1], CONV[2])
    scheds = [c["schedule"] for c in tune.fused_candidates(
        "fused_wgrad", shape, w.shape, 1)
        if c["status"] in ("default", "candidate")]
    assert len(scheds) >= 2 and all("row_tile" in s for s in scheds)
    want = np.asarray(jfb.conv_wgrad(
        jnp.asarray(x), jnp.asarray(g), w.shape,
        x_prologue=(jnp.asarray(scale), jnp.asarray(bias), True),
        interpret=True))
    for sched in scheds:
        dw = tfb.conv_wgrad_reference(
            torch.tensor(x), torch.tensor(g), w.shape,
            x_prologue=(torch.tensor(scale), torch.tensor(bias), True),
            schedule=sched)
        np.testing.assert_allclose(dw.numpy(), want, rtol=RTOL, atol=1e-4)


def test_wgrad_split_mirrors_the_kernels_hand_default():
    # 64 x 14 x 14, 3x3 at 256 channels: 196 boxes of 2x2x16, 48 CTAs a
    # chunk, six chunks to cover 132 SMs twice
    assert tfb.pick_box(64, 14, 14) == (2, 2, 16)
    assert tfb.wgrad_split(64, 14, 14, 256, 256, 3, 1) == (196, 33, 6)
    assert tfb.wgrad_split(64, 14, 14, 256, 256, 3, 1, 196) == (196, 196, 1)
    assert tfb.wgrad_split(64, 14, 14, 256, 256, 3, 1, 197) is None
    assert tfb.default_schedule("wgrad", (64, 14, 14, 256), (3, 3, 256, 256),
                                1, torch.bfloat16) == {"row_tile": 33}
    assert tfb.default_schedule("wgrad", (64, 14, 14, 256), (3, 3, 256, 256),
                                1, torch.float32) == {"chan_block": 64}


def test_fused_consult_runs_the_entry_and_falls_back_on_an_illegal_one():
    x, w, scale, bias, g = _conv_arrays(1, 5)
    n, h, ci, co = CONV
    key_shape = (n, h, h, ci, co, 1, 1)
    tx, tw = torch.tensor(x).bfloat16(), torch.tensor(w).bfloat16()
    table = tune.get_table()
    table.record("fused_fwd", key_shape, "bfloat16", "cpu",
                 {"schedule": {"chan_block": 64}, "ms_per_iter": 1.0})
    table.record("fused_dgrad", key_shape, "bfloat16", "cpu",
                 {"schedule": {"batch_fold": 2}, "ms_per_iter": 1.0})
    y, _ = tfb.conv_fwd(tx, tw)
    want, _ = tfb.conv_fwd_reference(tx, tw, schedule={"chan_block": 64})
    assert torch.equal(y, want)
    tfb.conv_dgrad(torch.tensor(g).bfloat16(), tw, tx.shape)
    stats = profiler.tuning_stats()
    assert stats["hits"] == 2 and stats["fallbacks"] == 1
    key = tune.make_key("fused_dgrad", key_shape, "bfloat16", "cpu")
    assert stats["kernels"][key] == {"schedule": None,
                                     "source": "fallback_illegal"}
    with pytest.raises(MXNetError, match="schedule"):
        tfb.conv_fwd(tx, tw, schedule={"chan_block": 256})
    with pytest.raises(MXNetError, match="schedule"):
        tfb.conv_fwd(tx.float(), tw.float(), schedule={"chan_block": 128})


def test_flash_consult_runs_the_entry_and_falls_back_on_an_illegal_one():
    q = torch.randn(1, 2, 256, 64)
    shape = (1, 2, 256, 256, 64, 1)
    table = tune.get_table()
    qb = q.bfloat16()
    table.record("flash_attention", shape, "bfloat16", "cpu",
                 {"schedule": {"block_q": 128, "block_k": 128},
                  "ms_per_iter": 1.0})
    out = tfa.flash_attention(qb, qb, qb, causal=True)
    assert torch.equal(out, tfa.flash_attention(qb, qb, qb, causal=True,
                                                block_q=128, block_k=128))
    assert profiler.tuning_stats()["hits"] == 1
    # float32 takes (64, 64) only: the entry is illegal there
    table.record("flash_attention", shape, "float32", "cpu",
                 {"schedule": {"block_q": 128, "block_k": 128},
                  "ms_per_iter": 1.0})
    out = tfa.flash_attention(q, q, q, causal=True)
    assert torch.equal(out, tfa.flash_attention(q, q, q, causal=True,
                                                block_q=64, block_k=64))
    stats = profiler.tuning_stats()
    assert stats["fallbacks"] == 1
    key = tune.make_key("flash_attention", shape, "float32", "cpu")
    assert stats["kernels"][key]["source"] == "fallback_illegal"


# ---------------------------------------------------------------------------
# the CLI, the entry points' device, background tuning
# ---------------------------------------------------------------------------
CLI_SMALL = ["--cpu", "--batch", "1", "--hw", "4", "--ci", "128",
             "--flash-batch", "1", "--heads", "1", "--seq", "128",
             "--head-dim", "64", "--decode-slots", "2", "--repeats", "1",
             "--target-sec", "0.001", "--min-iters", "1"]


def _cli(argv):
    from mxnet_tpu_torch.tune import __main__ as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    lines = buf.getvalue().strip().splitlines()
    return lines, json.loads(lines[-1])


def test_cli_runs_end_to_end_on_the_cpu(tmp_path):
    table = str(tmp_path / "cli.json")
    lines, rep = _cli(CLI_SMALL + ["--table", table])
    assert rep["backend"] == "cpu" and rep["table"] == table
    assert len(rep["tune"]) == 5 and all(
        not r["cache_hit"] and r["n_timed"] >= 1
        and r["winner"]["clock"] == "wall" for r in rep["tune"].values())
    assert {r["kernel"] for r in rep["tune"].values()} == set(
        tune.SWEEPABLE_KERNELS)
    assert any("flash_attention|2x1x1x128x64x0|bfloat16|cpu" in ln
               for ln in lines)
    _lines, again = _cli(CLI_SMALL + ["--table", table])
    assert all(r["cache_hit"] and r["n_timed"] == 0
               for r in again["tune"].values())
    _lines, comp = _cli(CLI_SMALL + ["--table", table, "--compare",
                                     "--kernels", "fused_wgrad"])
    (r,) = comp["tune"].values()
    assert r["exhaustive"]["n_timed"] >= 1 and "winner_delta_pct" in r
    # the JAX package reads every record the CLI wrote
    assert len(jtable.ScheduleTable(table)) == 5


def test_sweep_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises((RuntimeError, AssertionError)):
        tune.sweep_flash(1, 1, 64, 64, 64, dtype="bfloat16", repeats=1)
    with pytest.raises(SystemExit, match="--cpu"):
        _cli(["--kernels", "flash_attention"])


def test_background_tuner_commits_at_fits_drain_boundary(monkeypatch):
    from mxnet_tpu_torch.models import resnet

    monkeypatch.setenv("MXNET_TUNE_BACKGROUND", "1")
    sym = resnet.resnet(units=[1], num_stages=1, filter_list=[8, 16],
                        num_classes=3, image_shape=(3, 16, 16),
                        bottle_neck=True, fused=True)
    rng = np.random.RandomState(0)
    x = rng.randn(8, 3, 16, 16).astype(np.float32)
    y = rng.randint(0, 3, (8,)).astype(np.float32)
    with mx.cpu():
        mod = mx.mod.Module(sym, context=mx.cpu())
        mod.fit(mx.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
                optimizer="sgd", initializer=mx.init.Xavier())
    stats = profiler.tuning_stats()
    assert stats["bg_slots"] == stats["bg_commits"] == 1
    (key, rec), = tune.get_table().entries().items()
    assert rec["backend"] == "cpu" and rec["kernel"] in tune.FUSED_KINDS
    # the next consult of that key hits
    profiler.tuning_reset()
    assert tune.schedule_for(rec["kernel"], rec["shape"], rec["dtype"],
                             "cpu") == rec["schedule"]
    assert profiler.tuning_stats()["hits"] == 1


def test_background_tuner_arms_only_when_asked(monkeypatch):
    assert tune.BackgroundTuner.from_env() is None
    monkeypatch.setenv("MXNET_TUNE_BACKGROUND", "1")
    assert isinstance(tune.BackgroundTuner.from_env(), tune.BackgroundTuner)
    monkeypatch.setenv("MXNET_TPU_TUNE", "0")
    assert tune.BackgroundTuner.from_env() is None
    monkeypatch.setenv("MXNET_TUNE_BACKGROUND", "maybe")
    with pytest.raises(MXNetError, match="MXNET_TUNE_BACKGROUND"):
        tune.BackgroundTuner.from_env()


# ---------------------------------------------------------------------------
# pipeline keys, rule kernels, the decode key
# ---------------------------------------------------------------------------
def _both_symbols(name):
    from mxnet_tpu_torch.models import lenet, resnet

    if name == "resnet50":
        sym = resnet.get_symbol(num_classes=1000, num_layers=50,
                                image_shape=(3, 224, 224))
    else:
        sym = lenet.get_symbol(num_classes=10)
    return sym, jmx.sym.load_json(sym.tojson())


@pytest.mark.parametrize("name", ["resnet50", "lenet"])
def test_pipeline_keys_match_jax(name):
    sym, jsym = _both_symbols(name)
    assert tune.graph_fingerprint(sym) == jtune.graph_fingerprint(jsym)
    assert tune.pipeline_table_shape(sym, (4, 3, 224, 224)) == \
        jtune.pipeline_table_shape(jsym, (4, 3, 224, 224))
    for choice in tune.candidate_pipelines():
        sched = tune.schedule_of(choice)
        assert sched == jtune.schedule_of(choice)
        assert tune.choice_of(sched) == jtune.choice_of(sched) == choice
    with pytest.raises(MXNetError):
        tune.choice_of({"remat": 9, "layout": 1})


def test_sweepable_kernels_and_rule_kernels_match_jax():
    assert tune.sweepable_kernels() == jtune.sweepable_kernels()
    assert tune.rule_kernels()["bottleneck_fuse"] == \
        jtune.rule_kernels()["bottleneck_fuse"]


def test_decode_schedule_shape_matches_jax():
    from mxnet_tpu.models import transformer as jtf
    from mxnet_tpu_torch.models import transformer as ttf

    for kw in (dict(), dict(d_model=256, n_heads=4)):
        assert ttf.decode_schedule_shape(ttf.TransformerConfig(**kw), 8,
                                         1024) == \
            jtf.decode_schedule_shape(jtf.TransformerConfig(**kw), 8, 1024)


def test_pipeline_consult_hits_a_committed_choice():
    sym, _ = _both_symbols("lenet")
    shape = tune.pipeline_table_shape(sym, (4, 1, 28, 28))
    assert tune.pipeline_for(sym, (4, 1, 28, 28), backend="cpu") == (
        tune.HAND_DEFAULT, "default")
    tune.get_table().record(
        tune.PIPELINE_KERNEL, shape, "float32", "cpu",
        {"schedule": tune.schedule_of({"remat": "pass", "layout": "on"}),
         "ms_per_iter": 1.0})
    assert tune.pipeline_for(sym, (4, 1, 28, 28), backend="cpu") == (
        {"remat": "pass", "layout": "on"}, "table")


def test_dump_profile_holds_tuning_stats(tmp_path):
    q = torch.randn(1, 1, 64, 64)
    tfa.flash_attention(q, q, q)
    profiler.set_config(filename=str(tmp_path / "p.json"))
    try:
        profiler.dump_profile()
    finally:
        profiler.set_config()
    out = json.loads((tmp_path / "p.json").read_text())
    assert out["tuningStats"]["misses"] == 1
    assert out["tuningStats"] == profiler.tuning_stats()


def test_pipeline_sweep_commits_and_the_consult_hits():
    """``sweep_train_pipelines`` on LeNet on the CPU: six candidates built
    and featurized from the port's own measurements (residual bytes, the
    carry, the remat plan; no kernel launches on the CPU), timed, the
    winner committed under ``train_pipeline`` and read back by
    ``pipeline_for``."""
    sym, _ = _both_symbols("lenet")
    rng = np.random.RandomState(0)
    batch = {"data": rng.randn(4, 1, 28, 28).astype(np.float32),
             "softmax_label": rng.randint(0, 10, (4,)).astype(np.float32)}
    rep = tune.sweep_train_pipelines(
        sym, dict(name="sgd", learning_rate=0.1), batch, steps=1,
        ranked=False, step_kw={"device": "cpu"})
    assert rep["backend"] == "cpu" and rep["n_timed"] == 6
    plans = [e for e in rep["trajectory"]]
    assert all("ms_per_iter" in e and e["residual_bytes"] > 0
               for e in plans)
    rec = tune.get_table().entry(tune.PIPELINE_KERNEL, tuple(rep["shape"]),
                                 "float32", "cpu")
    assert all(t["plan"]["n"] == 0 and t["plan"]["calls"] > 0
               for t in rec["timings"])
    choice, source = tune.pipeline_for(sym, (4, 1, 28, 28), backend="cpu")
    assert source == "table" and choice == rep["winner"]["choice"]
