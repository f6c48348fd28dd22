"""Round-robin kernel timing (counterpart of ``mxnet_tpu/tune/harness.py``).

The JAX harness runs the kernel N times inside one jitted ``lax.scan`` so
dispatch cost amortizes away. PyTorch runs eagerly, so a timed program
here is ``iters`` back-to-back calls of the same function, timed two ways
on the card (``chip_smoke.py``'s ``_time_ms`` pair):

- **event**: CUDA events around the calls. This holds the wrapper's host
  time whenever the card waits for it.
- **device**: the same calls behind a spin kernel (``torch.cuda._sleep``)
  queued first that lasts twice the host time of enqueueing them, so the
  host has queued every call before the start event fires: device time
  only.

On the CPU (the plain versions) a program is timed with ``perf_counter``
and has no device time. Programs are timed round robin, every repeat of
every candidate in turn, so drift on a shared host hits every candidate
alike, and each candidate's runs are summarized by a trimmed mean.
"""
from __future__ import annotations

import time

# the spin kernel counts cycles; at most ~2e9 of them a second on an H100,
# so a spin sized at this rate lasts at least as long on a slower clock
SPIN_CYCLES_PER_S = 2e9
# calls a timed program holds at most on the card: more would fill the
# launch queue while the spin runs, and the device time would hold gaps
MAX_CARD_ITERS = 100


class Program:
    """One timed program: ``iters`` calls of ``fn``; ``spin`` the cycles of
    the spin kernel in front of it on the card (0 on the CPU)."""

    def __init__(self, fn, iters, on_card, spin=0):
        self.fn, self.iters, self.on_card, self.spin = fn, iters, on_card, spin


def _sync(on_card):
    if on_card:
        import torch

        torch.cuda.synchronize()


def prepare_run(fn, iters=None, target_sec=0.3, min_iters=10, on_card=True):
    """Warm ``fn`` (its first call builds the kernel), choose ``iters``
    calls so that a program lasts about ``target_sec`` (wall time), and
    size the card's spin from the host time of enqueueing them."""
    fn()
    _sync(on_card)
    t0 = time.perf_counter()
    fn()
    _sync(on_card)
    per = time.perf_counter() - t0
    if iters is None:
        iters = max(min_iters, int(target_sec / max(per, 1e-9)))
        if on_card:
            iters = min(iters, MAX_CARD_ITERS)
    iters = max(1, int(iters))
    spin = 0
    if on_card:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = time.perf_counter() - t0
        _sync(on_card)
        spin = int(max(2 * host, 1e-4) * SPIN_CYCLES_PER_S)
    return Program(fn, iters, on_card, spin)


def run_once(prog):
    """``(ms, device_ms)`` per call of one run of ``prog``: on the card the
    event and the device time, on the CPU the wall time and None."""
    if not prog.on_card:
        t0 = time.perf_counter()
        for _ in range(prog.iters):
            prog.fn()
        return (time.perf_counter() - t0) * 1e3 / prog.iters, None
    import torch

    out = []
    for spin in (0, prog.spin):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(spin)
        start.record()
        for _ in range(prog.iters):
            prog.fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / prog.iters)
    return out[0], out[1]


def summarize(runs):
    """Trimmed mean and relative spread: drop len//3 runs from each end (at
    4 runs or more) and report the middle."""
    n = len(runs)
    if not n:
        return 0.0, 0.0
    trim = max(1, n // 3) if n >= 4 else 0
    mid = sorted(runs)[trim:-trim] if trim else sorted(runs)
    mean = sum(mid) / len(mid)
    spread = (max(mid) - min(mid)) / mean if mean else 0.0
    return mean, spread


def time_round_robin(prepared, repeats):
    """Interleaved timing of several prepared programs.

    ``prepared``: [(name, Program)]; returns {name: {"ms": [...],
    "device_ms": [...] or None}}, ms per call."""
    runs = {name: {"ms": [], "device_ms": []} for name, _ in prepared}
    for _ in range(repeats):
        for name, prog in prepared:
            ms, dev = run_once(prog)
            runs[name]["ms"].append(ms)
            runs[name]["device_ms"].append(dev)
    for r in runs.values():
        if any(v is None for v in r["device_ms"]):
            r["device_ms"] = None
    return runs
