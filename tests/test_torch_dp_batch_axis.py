"""Ops over the batch axis under a data-parallel mesh (fault C7), on 2 gloo
ranks on the CPU.

Inside ``spmd_scope`` each rank holds its 4 rows of a global batch of 8
(each row (3, 4)). Every op that touches axis 0 either raises by name
there (softmax, log_softmax, argmax and argmin over axis 0 or all axes,
LayerNorm over axis 0, Concat on dim 0, a transpose or swapaxes that moves
axis 0, a Reshape whose output rows are not the input rows', Dropout with
a mask shared along axis 0, RNN, whose batch is axis 1, and
softmax_cross_entropy, a sum over the batch), or gives the rank's rows of
the whole batch's result: the same ops over other axes, Flatten and a
Reshape that keeps axis 0 first, merges it with the axes after it or
splits it with the batch factor leading, and the loss heads' gradients
(make_loss's ``batch`` and ``valid`` normalizations and SoftmaxOutput's
``batch`` divide by the global batch and count). Float rows are held at
rtol 1e-6 (the same arithmetic on fewer rows); indices, reshapes and
transposes bit for bit. Outside the scope each C7 op is bit for bit the
plain torch computation it was before the repair.
"""
import numpy as np
import pytest
import torch

import torch_dp_workers as w

RANK_TIMEOUT = 120
WORLD = 2

RAISE = ("softmax-axis0", "log_softmax-axis0", "argmax-axis0",
         "argmax-all", "argmin-axis0", "LayerNorm-axis0", "Concat-dim0",
         "Reshape-split-batch", "Reshape-batch-literal", "transpose-move",
         "transpose-reverse", "swapaxes-0-1", "Dropout-axes0", "RNN",
         "softmax_cross_entropy")
ROWS = ("softmax-axis1", "log_softmax-axis-1", "argmax-axis2",
        "argmin-axis1", "LayerNorm-axis-1", "Concat-dim1", "Reshape-keep",
        "Reshape-merge", "Reshape-split-rows", "Reshape-reverse-merge",
        "Flatten", "transpose-keep", "swapaxes-1-2", "make_loss-batch",
        "make_loss-valid", "make_loss-null", "SoftmaxOutput-batch",
        "LinearRegressionOutput", "SVMOutput")
EXACT = ("argmax-axis2", "argmin-axis1", "Concat-dim1", "Reshape-keep",
         "Reshape-merge", "Reshape-split-rows", "Reshape-reverse-merge",
         "Flatten", "transpose-keep", "swapaxes-1-2")


def _plain(x):
    """Each C7 op as plain torch, before the guard."""
    var, mean = torch.var_mean(x, dim=0, correction=0, keepdim=True)
    return {
        "softmax-axis0": torch.softmax(x, dim=0),
        "softmax-axis1": torch.softmax(x, dim=1),
        "log_softmax-axis0": torch.log_softmax(x, dim=0),
        "argmax-axis0": torch.argmax(x, dim=0).float(),
        "argmax-all": torch.argmax(x.reshape(-1), 0).float(),
        "argmin-axis0": torch.argmin(x, dim=0).float(),
        "LayerNorm-axis0": (x - mean) * torch.rsqrt(var + 1e-5),
        "Concat-dim0": torch.cat([x, 2 * x], dim=0),
        "Reshape-keep": x.reshape(8, 12),
        "Reshape-merge": x.reshape(24, 4),
        "Reshape-split-batch": x.reshape(2, 4, 3, 4),
        "Reshape-batch-literal": x.reshape(4, 24),
        "Flatten": x.reshape(8, 12),
        "transpose-move": x.permute(1, 0, 2),
        "transpose-reverse": x.permute(2, 1, 0),
        "swapaxes-0-1": x.transpose(0, 1),
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("batch_axis")
    ctx = w.start_ranks("batch_axis_worker", WORLD, out)
    return w.join_ranks(ctx, out, RANK_TIMEOUT)


def test_every_case_is_classified():
    assert sorted(RAISE + ROWS) == sorted(w.batch_axis_cases())


@pytest.mark.parametrize("name", RAISE)
def test_raises_by_name_under_the_scope(ranks, name):
    op = name.split("-")[0]
    for r in ranks:
        kind, msg = r[name][0]
        assert kind == "raised", (name, msg)
        assert msg.startswith("MXNetError") and op in msg, msg
        assert "data-parallel" in msg, msg


@pytest.mark.parametrize("name", ROWS)
def test_gives_the_ranks_rows_of_the_whole_batch(ranks, name):
    for rank, r in enumerate(ranks):
        (kind, got), whole = r[name]
        assert kind == "ok", (name, got)
        rows = whole.shape[0] // WORLD
        want = whole[rank * rows:(rank + 1) * rows]
        if name in EXACT:
            assert torch.equal(got, want), name
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)


@pytest.mark.parametrize("name", sorted(_plain(torch.zeros(8, 3, 4))))
def test_unchanged_outside_the_scope(ranks, name):
    want = _plain(torch.from_numpy(w.batch_axis_input()))[name]
    for r in ranks:
        assert torch.equal(r[name][1], want), name
