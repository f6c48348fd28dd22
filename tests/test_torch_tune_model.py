"""The port's learned cost model (``mxnet_tpu_torch.tune.model``) against the
JAX package's (``mxnet_tpu.tune.model``), on the CPU.

Both fit the same banked records of one schedule table file: the same
groups, rows, weights, standardization, intercept and cross-validated rank
correlation, the same abstentions, and the same predictions (rtol 1e-9:
the same numpy arithmetic on the same rows). The flash-attention
``plan_for`` is the JAX package's block arithmetic exactly; a model file
written by either package loads in the other, and a corrupt one behaves
as absent in both. A usable model ranks a sweep's candidates (the top
``topk`` timed, the rest ``skipped_ranked``).
"""
import numpy as np
import pytest

import mxnet_tpu.tune as jtune
from mxnet_tpu.tune import model as jmodel
from mxnet_tpu.tune import table as jtable

from mxnet_tpu_torch import tune
from mxnet_tpu_torch.tune import model as tmodel
from mxnet_tpu_torch.tune import search as tsearch

RTOL = 1e-9

FLASH_SHAPES = [(8, 8, s, s, d, c) for s in (256, 1024, 2048)
                for d in (64, 128) for c in (0, 1)]
TILES = [(64, 64), (64, 128), (128, 64), (128, 128)]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_TPU_TUNE_TABLE", str(tmp_path / "table.json"))
    monkeypatch.delenv("MXNET_TUNE_MODEL", raising=False)
    for pkg in (tune, jtune):
        pkg.reset()
    yield
    for pkg in (tune, jtune):
        pkg.reset()


def _banked_table(path):
    """A port-written table: flash rows (a noisy function of the blocks and
    the work, enough to fit) and three fused_fwd rows (too few: that group
    abstains)."""
    rng = np.random.RandomState(0)
    t = tune.ScheduleTable(path)
    for shape in FLASH_SHAPES:
        timings = []
        for bq, bk in TILES:
            sched = {"block_q": bq, "block_k": bk}
            plan = tune.plan_for("flash_attention", shape, sched)
            ms = 1e-6 * shape[2] * shape[3] * shape[4] / (bq * bk) ** 0.3 \
                * (0.5 if shape[5] else 1.0) * (1 + 0.05 * rng.rand())
            timings.append({"schedule": sched, "ms_per_iter": ms,
                            "plan": plan})
        best = min(timings, key=lambda r: r["ms_per_iter"])
        t.record("flash_attention", shape, "bfloat16", "cuda",
                 {"schedule": best["schedule"],
                  "ms_per_iter": best["ms_per_iter"], "timings": timings})
    shape = (64, 14, 14, 256, 256, 3, 1)
    t.record("fused_fwd", shape, "bfloat16", "cuda", {
        "schedule": {"chan_block": 128}, "ms_per_iter": 0.1,
        "timings": [{"schedule": {"chan_block": c}, "ms_per_iter": ms,
                     "plan": tune.plan_for("fused_fwd", shape,
                                           {"chan_block": c})}
                    for c, ms in ((64, 0.11), (128, 0.1))]})
    return t


def test_cost_models_fit_the_same_rows_to_the_same_weights(tmp_path):
    path = str(tmp_path / "table.json")
    t = _banked_table(path)
    tm = tmodel.CostModel(str(tmp_path / "port.model.json"))
    jm = jmodel.CostModel(str(tmp_path / "jax.model.json"))
    trep = tm.fit_from_table(t)
    jrep = jm.fit_from_table(jtable.ScheduleTable(path))
    assert trep["fit"] == jrep["fit"] and trep["skipped"] == jrep["skipped"]
    assert set(trep["fit"]) == {"flash_attention|cuda"}
    assert "fused_fwd|cuda" in trep["skipped"]
    tg, jg = tm.load(strict=True), jm.load(strict=True)
    assert set(tg) == set(jg)
    for gk in tg:
        assert tg[gk]["rows"] == jg[gk]["rows"] == len(FLASH_SHAPES) * 4
        for field in ("weights", "mu", "sd", "intercept", "val_corr"):
            np.testing.assert_allclose(tg[gk][field], jg[gk][field],
                                       rtol=RTOL, atol=0)
    for kernel in ("flash_attention", "fused_fwd", "fused_wgrad"):
        assert tm.usable(kernel, "cuda") == jm.usable(kernel, "cuda")
    plans = [tune.plan_for("flash_attention", (4, 8, 512, 512, 64, 1),
                           {"block_q": bq, "block_k": bk})
             for bq, bk in TILES]
    np.testing.assert_allclose(tm.predict("flash_attention", "cuda", plans),
                               jm.predict("flash_attention", "cuda", plans),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("shape", FLASH_SHAPES[:6] + [(8, 8, 1, 1024, 128,
                                                       0)])
def test_flash_plan_is_the_jax_packages(shape):
    for bq, bk in TILES + [(16, 32)]:
        sched = {"block_q": bq, "block_k": bk}
        assert tune.plan_for("flash_attention", shape, sched) == \
            jtune.plan_for("flash_attention", shape, sched)
        np.testing.assert_array_equal(
            tune.features_from_plan(tune.plan_for("flash_attention", shape,
                                                  sched)),
            jtune.features_from_plan(jtune.plan_for("flash_attention", shape,
                                                    sched)))
    assert tmodel.FEATURE_NAMES == jmodel.FEATURE_NAMES
    assert (tmodel.MIN_FIT_ROWS, tmodel.CORR_FLOOR, tmodel.RIDGE_LAMBDA) == \
        (jmodel.MIN_FIT_ROWS, jmodel.CORR_FLOOR, jmodel.RIDGE_LAMBDA)


def test_fused_plans_describe_the_cuda_kernels():
    shape = (64, 14, 14, 256, 256, 3, 1)
    fwd = tune.plan_for("fused_fwd", shape, {"chan_block": 128})
    assert fwd["grid"] == [196, 2, 1] and fwd["bco"] == 128 \
        and fwd["calls"] == 9 and fwd["work"] == 64 * 256 * 128
    wg = tune.plan_for("fused_wgrad", shape, {"row_tile": 33})
    assert wg["grid"] == [48, 6, 1] and wg["nb"] == 6 and wg["th"] == 33
    dg = tune.plan_for("fused_dgrad", (64, 28, 28, 128, 128, 3, 2),
                       {"chan_block": 64})
    assert dg["grid"] == [4 * 196, 2, 1]
    assert set(fwd) == set(tsearch.plan_summary(fwd))


def test_model_files_load_in_both_packages(tmp_path):
    path = str(tmp_path / "table.json")
    t = _banked_table(path)
    port_file, jax_file = (str(tmp_path / n) for n in ("p.json", "j.json"))
    tmodel.CostModel(port_file).fit_from_table(t)
    jmodel.CostModel(jax_file).fit_from_table(jtable.ScheduleTable(path))
    for cls, f in ((jmodel.CostModel, port_file),
                   (tmodel.CostModel, jax_file)):
        groups = cls(f).load(strict=True)
        assert set(groups) == {"flash_attention|cuda"}


@pytest.mark.parametrize("raw", ["garbage", '{"version": 9}',
                                 '{"version": 1, "features": ["m"], '
                                 '"groups": {}}'])
def test_corrupt_model_behaves_as_absent_in_both(tmp_path, raw):
    f = tmp_path / "m.json"
    f.write_text(raw)
    for mod in (tmodel, jmodel):
        m = mod.CostModel(str(f))
        ok, why = m.usable("flash_attention", "cuda")
        assert not ok and "unusable" in why
        with pytest.raises(mod.CostModelError):
            mod.CostModel(str(f)).load(strict=True)


def test_a_usable_model_ranks_a_sweeps_candidates(tmp_path):
    path = str(tmp_path / "table.json")
    t = _banked_table(path)
    m = tmodel.CostModel(str(tmp_path / "m.json"))
    m.fit_from_table(t)
    assert m.usable("flash_attention", "cuda")[0]
    shape = (8, 8, 1024, 1024, 128, 1)
    entries = tune.flash_candidates(1024, 1024, d=128)
    info = tsearch._apply_ranking("flash_attention", shape, "bfloat16",
                                  "cuda", entries, 1, t, cost_model=m)
    assert info["mode"] == "ranked" and info["n_scored"] == 3
    assert sum(e["status"] == "candidate" for e in entries) == 1
    assert sum(e["status"] == "skipped_ranked" for e in entries) == 2
    # the fused group has two rows: it abstains into the exhaustive sweep
    fe = tune.fused_candidates("fused_fwd", (64, 14, 14, 256),
                               (3, 3, 256, 256), 1)
    info = tsearch._apply_ranking("fused_fwd", (64, 14, 14, 256, 256, 3, 1),
                                  "bfloat16", "cuda", fe, 1, t, cost_model=m)
    assert info["mode"] == "exhaustive" and info["abstained"]
