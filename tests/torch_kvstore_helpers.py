"""Helpers of the port's parameter-server tests: the tolerance check and
the deadline that bounds every test body and teardown (a hang fails the
test instead of eating the suite's clock)."""
import functools
import threading

import numpy as np
import pytest

import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-4, 1e-5
DEADLINE = 60


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _within(seconds, fn, *args):
    """``fn(*args)`` on a thread; fails if it has not returned within
    ``seconds``, re-raises what it raised."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:  # noqa: B902 - re-raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail("%s did not return within %d s"
                    % (getattr(fn, "__name__", fn), seconds))
    if "err" in box:
        raise box["err"]
    return box.get("out")


def bounded(fn):
    """Run a test body under the ``DEADLINE`` (on its thread, the port's
    default context is the CPU too: contexts are thread-local)."""
    def on_cpu(*args, **kwargs):
        with tmx.cpu():
            return fn(*args, **kwargs)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return _within(DEADLINE, functools.partial(on_cpu, *args, **kwargs))

    return wrapper


def _stop(*objs):
    def run():
        for o in objs:
            (o.close if hasattr(o, "close") else o.shutdown)()

    _within(30, run)
