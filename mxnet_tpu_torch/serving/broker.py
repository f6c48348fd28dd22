"""Serving brokers (counterpart of ``mxnet_tpu/serving/broker.py``): the
dynamic-batching :class:`ModelServer` for bound symbol models and the
continuous-batching :class:`GenerateServer`.

Bounded queue depth gives backpressure: ``submit`` blocks (up to
``MXNET_SERVE_SUBMIT_TIMEOUT``) while the queue holds
``MXNET_SERVE_QUEUE_DEPTH`` requests, then raises. A decode-loop death is
sticky and surfaces on the next submit. ``close()`` stops and joins the
loop with a bounded deadline and fails queued and in-flight requests
loudly.

Not ported yet: ``ModelServer``'s tenant/priority QoS classes, its
checkpoint hot swap (``swap_from_checkpoint``) and the chaos hooks;
``GenerateServer``'s shared-prefix KV cache (``prefix_cache``),
speculative decoding (``spec_k``) and the ``generate:stall`` hook
(ROADMAP.md Queue A items 8 and 11).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from .. import profiler
from .generate import (
    GenerateError,
    GenerativePredictor,
    PagePoolExhausted,
    _env_nonneg_int,
    _env_positive_int,
    _env_strict_bool,
)
from .predictor import (
    AOTPredictor,
    ServingError,
    env_batch_ladder,
    env_positive_float,
    env_positive_int,
    validate_ladder,
)


class DeadlineExceeded(ServingError):
    """A request's deadline expired before it was dispatched (it was SHED
    at dequeue) or while it was decoding. Its future fails with this
    error."""


class ServerClosed(ServingError):
    """The request was REJECTED (or failed while still queued) because
    the server is shutting down — it never finished, so a router may
    safely resubmit it elsewhere."""


class ServerOverloaded(ServingError):
    """Backpressure rejection: the bounded request queue stayed full
    past the submit timeout. The request never entered the queue."""


class _Request:
    __slots__ = ("inputs", "rows", "future", "t_submit", "deadline")

    def __init__(self, inputs, rows, deadline=None):
        self.inputs = inputs
        self.rows = rows
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = deadline  # absolute time.monotonic(), or None


class _ModelWorker:
    """One model's queue + serving thread (drain and coalesce)."""

    def __init__(self, name, predictor, queue_depth):
        self.name = name
        self.predictor = predictor
        self._depth = queue_depth
        self._cond = threading.Condition()
        self._q = deque()
        self._stopped = False
        self._error = None       # sticky worker-death error
        # held around every batch forward; swap() takes it to wait out the
        # in-flight batch before republishing weights
        self._exec_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="serve-%s" % name)
        self._thread.start()

    def enqueue(self, req, timeout):
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                if self._stopped:
                    if self._error is not None:
                        raise ServingError("model %r: worker died: %r"
                                           % (self.name, self._error))
                    raise ServerClosed("model %r: worker is stopped"
                                       % self.name)
                if len(self._q) < self._depth:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ServerOverloaded(
                        "model %r: request queue full (%d queued, "
                        "MXNET_SERVE_QUEUE_DEPTH=%d) — backpressure timeout"
                        % (self.name, len(self._q), self._depth))
                self._cond.wait(min(remaining, 0.1))
            self._q.append(req)
            depth = len(self._q)
            self._cond.notify_all()
        return depth

    def _drain_locked(self):
        """Pop the largest ready batch: queued requests in FIFO order while
        the running row total fits the largest bucket. Requests whose
        deadline passed are shed here, before they take a batch slot.
        Returns (reqs, rows, shed)."""
        cap = self.predictor.max_bucket
        now = time.monotonic()
        shed, reqs, total = [], [], 0
        while self._q:
            r = self._q[0]
            if r.deadline is not None and now > r.deadline:
                shed.append(self._q.popleft())
                continue
            if reqs and total + r.rows > cap:
                break
            reqs.append(self._q.popleft())
            total += r.rows
        return reqs, total, shed

    def _run(self):
        try:
            while True:
                with self._cond:
                    while not self._q and not self._stopped:
                        self._cond.wait()
                    if self._stopped:
                        return
                    reqs, rows, shed = self._drain_locked()
                    self._cond.notify_all()  # queue space freed
                if shed:
                    # futures fail outside the lock: done-callbacks run
                    # inline and may submit again
                    exc = DeadlineExceeded(
                        "model %r: deadline expired before dispatch (shed "
                        "at dequeue)" % self.name)
                    for r in shed:
                        if not r.future.done():
                            r.future.set_exception(exc)
                    profiler.serving_record(self.name, shed=len(shed))
                if not reqs:
                    continue
                try:
                    self._execute(reqs, rows)
                except Exception as e:  # a bad batch fails ITS futures only
                    for r in reqs:
                        if not r.future.done():
                            r.future.set_exception(e)
                    profiler.serving_record(self.name, errors=len(reqs))
        except BaseException as e:  # worker death: sticky, fail the queue
            with self._cond:
                self._error = e
                self._stopped = True
                pending = list(self._q)
                self._q.clear()
                self._cond.notify_all()
            for r in pending:
                if not r.future.done():
                    r.future.set_exception(e)

    def _execute(self, reqs, rows):
        pred = self.predictor
        bucket = pred.pick_bucket(rows)
        with self._exec_lock:
            if len(reqs) == 1 and reqs[0].rows == bucket:
                inputs = reqs[0].inputs  # exact fit: no assembly copy
            else:
                inputs = {}
                for name in pred.data_names:
                    first = reqs[0].inputs[name]
                    buf = np.zeros((bucket,) + first.shape[1:],
                                   dtype=first.dtype)
                    ofs = 0
                    for r in reqs:
                        buf[ofs:ofs + r.rows] = r.inputs[name]
                        ofs += r.rows
                    inputs[name] = buf
            outs = pred.run_bucket(inputs, bucket)
        now = time.perf_counter()
        lats, ofs = [], 0
        for r in reqs:
            r.future.set_result([o[ofs:ofs + r.rows]
                                 if o.ndim and o.shape[0] == bucket else o
                                 for o in outs])
            ofs += r.rows
            lats.append(now - r.t_submit)
        profiler.serving_record(self.name, batches=1, rows=rows,
                                capacity=bucket, latencies=lats)

    def stop(self):
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    def join(self, timeout):
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def fail_pending(self, exc):
        with self._cond:
            pending = list(self._q)
            self._q.clear()
            self._cond.notify_all()
        for r in pending:
            if not r.future.done():
                r.future.set_exception(exc)
        return len(pending)


class ModelServer:
    """Multi-model dynamic-batching inference server.

    ::

        with ModelServer(dtype="bfloat16") as srv:
            srv.add_model("resnet", symbol=sym, arg_params=args,
                          aux_params=auxs,
                          data_shapes={"data": (1, 3, 224, 224)})
            fut = srv.submit("resnet", batch_np)   # -> Future
            probs = fut.result()[0]

    One worker thread per resident model drains everything queued, up to
    the model's largest batch bucket, into one padded forward and slices
    the results back per request: under light load a request rides alone
    in the smallest bucket, under heavy load the queue refills while a
    batch computes and the next drain coalesces. ``submit`` blocks for
    queue space up to ``MXNET_SERVE_SUBMIT_TIMEOUT`` seconds while
    ``MXNET_SERVE_QUEUE_DEPTH`` requests are queued, then raises
    :class:`ServerOverloaded`. ``device`` defaults to ``cuda`` (raising
    when there is none).
    """

    def __init__(self, ladder=None, queue_depth=None, submit_timeout=None,
                 dtype="float32", device=None):
        self._ladder = env_batch_ladder() if ladder is None \
            else validate_ladder(ladder)
        self._queue_depth = env_positive_int(
            "MXNET_SERVE_QUEUE_DEPTH", 256) if queue_depth is None \
            else int(queue_depth)
        if self._queue_depth < 1:
            raise ServingError("ModelServer: queue_depth must be >= 1, got "
                               "%d" % self._queue_depth)
        self._submit_timeout = env_positive_float(
            "MXNET_SERVE_SUBMIT_TIMEOUT", 60.0) if submit_timeout is None \
            else float(submit_timeout)
        self._dtype = dtype
        self._device = device
        self._workers = {}
        self._lock = threading.Lock()
        self._closed = False

    def add_model(self, name, symbol=None, arg_params=None, aux_params=None,
                  data_shapes=None, predictor=None, **predictor_kwargs):
        """Make ``name`` resident: either hand in a prebuilt
        :class:`AOTPredictor`, or a symbol + params + data_shapes and the
        server binds one at its ladder, dtype and device."""
        self._check_open()
        if predictor is None:
            if symbol is None or data_shapes is None:
                raise ServingError(
                    "add_model(%r): need either predictor= or symbol=/"
                    "data_shapes= (+params)" % name)
            predictor_kwargs.setdefault("ladder", self._ladder)
            predictor_kwargs.setdefault("dtype", self._dtype)
            predictor_kwargs.setdefault("device", self._device)
            predictor = AOTPredictor(symbol, arg_params, aux_params,
                                     data_shapes=data_shapes,
                                     **predictor_kwargs)
        with self._lock:
            if name in self._workers:
                raise ServingError("model %r is already resident; use swap() "
                                   "to update its weights" % name)
            self._workers[name] = _ModelWorker(name, predictor,
                                               self._queue_depth)
        return predictor

    def models(self):
        with self._lock:
            return sorted(self._workers)

    def _worker(self, name):
        with self._lock:
            worker = self._workers.get(name)
        if worker is None:
            raise ServingError("unknown model %r (resident: %s)"
                               % (name, self.models()))
        return worker

    def _check_open(self):
        if self._closed:
            raise ServerClosed("ModelServer is closed")

    def submit(self, name, inputs, timeout=None, deadline=None):
        """Enqueue one request; returns a ``concurrent.futures.Future``
        resolving to the list of output arrays (request row count). A
        ``deadline`` (seconds from now) makes it sheddable: still queued
        when it passes, the request is dropped at dequeue and its future
        fails with :class:`DeadlineExceeded`."""
        self._check_open()
        worker = self._worker(name)
        inputs, rows = worker.predictor._normalize(inputs)
        worker.predictor.pick_bucket(rows)  # reject oversized in the caller
        if deadline is not None:
            deadline = float(deadline)
            if not deadline > 0:
                raise ServingError("submit: deadline must be > 0 seconds, "
                                   "got %r" % deadline)
            deadline = time.monotonic() + deadline
        req = _Request(inputs, rows, deadline=deadline)
        depth = worker.enqueue(
            req, self._submit_timeout if timeout is None else timeout)
        profiler.serving_record(name, requests=1, queue_depth=depth)
        return req.future

    def predict(self, name, inputs, timeout=None):
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(name, inputs, timeout=timeout).result()

    def swap(self, name, arg_params=None, aux_params=None,
             allow_extra=False):
        """Replace a resident model's weights without dropping requests:
        waits out the in-flight batch, swaps, releases; queued requests are
        served by the new weights."""
        self._check_open()
        worker = self._worker(name)
        with worker._exec_lock:
            return worker.predictor.swap_params(arg_params, aux_params,
                                                allow_extra=allow_extra)

    def stats(self, reset=False):
        """Per-model serving counters (see profiler.serving_stats)."""
        return profiler.serving_stats(reset=reset)

    def close(self, timeout=5.0):
        """Stop and join every worker (bounded), fail still-queued requests
        with :class:`ServerClosed`. Idempotent; submits after close
        raise."""
        if self._closed:
            return
        self._closed = True
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            w.stop()
        deadline = time.monotonic() + timeout
        for w in workers:
            w.join(max(0.0, deadline - time.monotonic()))
        exc = ServerClosed("ModelServer closed before the request was "
                           "dispatched")
        for w in workers:
            w.fail_pending(exc)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _GenRequest:
    __slots__ = ("tokens", "max_new", "eos_id", "future", "stream_fn",
                 "t_submit", "deadline", "out", "pages", "slot", "ttft",
                 "unflushed")

    def __init__(self, tokens, max_new, eos_id, deadline, stream_fn):
        self.tokens = tokens
        self.max_new = max_new
        self.eos_id = eos_id
        self.future = Future()
        self.stream_fn = stream_fn
        self.t_submit = time.perf_counter()
        self.deadline = deadline     # absolute time.monotonic(), or None
        self.out = []
        self.pages = []
        self.slot = None
        self.ttft = None
        self.unflushed = []


class GenerateServer:
    """Continuous-batching autoregressive decode server.

    A generate request is a *prefill* plus an open-ended run of
    single-token decode steps, and requests finish at different steps.
    The decode loop admits new requests into vacated batch slots EVERY
    decode step (continuous batching): admit (shedding deadline-expired
    requests at dequeue) -> prefill admitted prompts into freshly
    allocated KV pages -> one decode step over all active slots ->
    sample, stream, finish, recycle pages. ``admit_policy="drain"``
    admits only once the whole batch has finished, for comparison.

    Memory is paged (:class:`~.generate.PagePool`): each slot holds a
    block table naming its pages; completion returns the pages
    immediately. Pool exhaustion at admission backpressures (the
    request waits in queue); a request that can never fit — or a
    mid-decode page the pool cannot provide — fails fast with the
    typed :class:`~.generate.PagePoolExhausted`.

    The request future resolves to ``{"tokens", "finish_reason",
    "prompt_tokens", "ttft_s", "latency_s"}``; a ``stream_fn`` callback
    additionally receives token chunks every
    ``MXNET_GENERATE_STREAM_FLUSH`` decode steps. Sampling is greedy:
    ``np.argmax`` of the host logits, first index on ties.

    ``device`` defaults to ``cuda`` (raising when there is none); pass
    ``device="cpu"`` to serve on the CPU.
    """

    FINISH_EOS = "eos"
    FINISH_LENGTH = "length"

    def __init__(self, config=None, params=None, predictor=None, *,
                 slots=None, page_size=None, pool_bytes=None,
                 max_steps=None, stream_flush=None, queue_depth=None,
                 submit_timeout=None, admit_policy="continuous",
                 prefix_cache=None, spec_k=None, device=None,
                 name="generate", **pred_kwargs):
        if predictor is None and (config is None or params is None):
            raise GenerateError(
                "GenerateServer: need either predictor= or "
                "config=/params=")
        # knob parsing first: a malformed knob must raise (naming the
        # knob) before any device work or thread starts
        prefix_on = _env_strict_bool("MXNET_GENERATE_PREFIX_CACHE") \
            if prefix_cache is None else bool(prefix_cache)
        _env_nonneg_int("MXNET_GENERATE_PREFIX_EVICT")
        spec = _env_nonneg_int("MXNET_GENERATE_SPEC_K") \
            if spec_k is None else int(spec_k)
        _env_nonneg_int("MXNET_GENERATE_DRAFT")
        if prefix_on:
            raise GenerateError(
                "GenerateServer: prefix_cache (MXNET_GENERATE_PREFIX_CACHE) "
                "is not ported yet (ROADMAP.md Queue A item 8)")
        if spec > 0:
            raise GenerateError(
                "GenerateServer: speculative decoding (spec_k / "
                "MXNET_GENERATE_SPEC_K=%d) is not ported yet (ROADMAP.md "
                "Queue A item 8)" % spec)
        if admit_policy not in ("continuous", "drain"):
            raise GenerateError("GenerateServer: admit_policy must be "
                                "continuous|drain, got %r" % admit_policy)
        self._policy = admit_policy
        self._max_steps = _env_positive_int("MXNET_GENERATE_MAX_STEPS") \
            if max_steps is None else int(max_steps)
        if self._max_steps < 1:
            raise GenerateError("GenerateServer: max_steps must be >= 1, "
                                "got %d" % self._max_steps)
        self._flush_every = _env_positive_int("MXNET_GENERATE_STREAM_FLUSH") \
            if stream_flush is None else int(stream_flush)
        if self._flush_every < 1:
            raise GenerateError("GenerateServer: stream_flush must be "
                                ">= 1, got %d" % self._flush_every)
        self._depth = env_positive_int("MXNET_SERVE_QUEUE_DEPTH", 256) \
            if queue_depth is None else int(queue_depth)
        self._submit_timeout = env_positive_float(
            "MXNET_SERVE_SUBMIT_TIMEOUT", 60.0) if submit_timeout is None \
            else float(submit_timeout)
        if predictor is None:
            predictor = GenerativePredictor(
                config, params, slots=slots, page_size=page_size,
                pool_bytes=pool_bytes, device=device, **pred_kwargs)
        self.predictor = predictor
        self.name = name

        S, MP = predictor.slots, predictor.max_pages_per_slot
        self._slot_req = [None] * S
        self._block_tables = np.zeros((S, MP), np.int32)
        self._positions = np.zeros((S,), np.int32)
        self._tokens = np.zeros((S,), np.int32)
        self._active = np.zeros((S,), bool)

        self._cond = threading.Condition()
        self._q = deque()
        self._stopped = False
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="generate-%s" % name)
        self._thread.start()

    # -- producer side -------------------------------------------------------
    def submit(self, tokens, max_new_tokens=None, eos_id=None,
               deadline=None, stream_fn=None, timeout=None):
        """Enqueue one generate request; returns a Future resolving to
        ``{"tokens": [int], "finish_reason": "eos"|"length",
        "ttft_s", "latency_s", "prompt_tokens"}``. ``deadline``
        (seconds from now) marks it sheddable at dequeue AND bounds the
        decode run itself — a mid-generation expiry fails the future
        with :class:`DeadlineExceeded` and recycles the slot + pages.
        ``max_new_tokens`` is capped by ``MXNET_GENERATE_MAX_STEPS`` and
        the per-slot context bound."""
        pred = self.predictor
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.shape[0] < 1:
            raise GenerateError("submit: empty prompt")
        if int(tokens.min()) < 0 or int(tokens.max()) >= pred.config.vocab:
            # prefill and decode CLAMP ids; serving a clamped id would
            # silently diverge from the zero-masking one-shot forward, so
            # reject at the door
            raise GenerateError(
                "submit: prompt token ids must lie in [0, %d), got "
                "range [%d, %d]" % (pred.config.vocab, tokens.min(),
                                    tokens.max()))
        if tokens.shape[0] > pred.max_ctx - 1:
            raise GenerateError(
                "submit: %d-token prompt exceeds the per-slot context "
                "bound %d (need room for >= 1 generated token)"
                % (tokens.shape[0], pred.max_ctx))
        if pred.pages_needed(tokens.shape[0]) > pred.pool.num_pages:
            raise PagePoolExhausted(
                "submit: prompt needs %d pages, the whole pool holds %d"
                % (pred.pages_needed(tokens.shape[0]),
                   pred.pool.num_pages))
        max_new = self._max_steps if max_new_tokens is None \
            else int(max_new_tokens)
        if max_new < 1:
            raise GenerateError("submit: max_new_tokens must be >= 1, "
                                "got %d" % max_new)
        max_new = min(max_new, self._max_steps,
                      pred.max_ctx - int(tokens.shape[0]))
        if deadline is not None:
            deadline = float(deadline)
            if not deadline > 0:
                raise GenerateError("submit: deadline must be > 0 "
                                    "seconds, got %r" % deadline)
            deadline = time.monotonic() + deadline
        req = _GenRequest(tokens, max_new, eos_id, deadline, stream_fn)
        wait_until = time.monotonic() + (
            self._submit_timeout if timeout is None else float(timeout))
        with self._cond:
            while True:
                if self._stopped:
                    if self._error is not None:
                        raise ServingError("GenerateServer %r: worker "
                                           "died: %r" % (self.name,
                                                         self._error))
                    raise ServerClosed("GenerateServer %r is closed"
                                       % self.name)
                if len(self._q) < self._depth:
                    break
                remaining = wait_until - time.monotonic()
                if remaining <= 0:
                    raise ServerOverloaded(
                        "GenerateServer %r: request queue full (%d "
                        "queued, MXNET_SERVE_QUEUE_DEPTH=%d)"
                        % (self.name, len(self._q), self._depth))
                self._cond.wait(min(remaining, 0.1))
            self._q.append(req)
            depth = len(self._q)
            self._cond.notify_all()
        profiler.generate_record(requests=1, queue_depth=depth)
        return req.future

    def generate(self, tokens, **kw):
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(tokens, **kw).result()

    # -- worker side ---------------------------------------------------------
    def _active_count(self):
        return int(self._active.sum())

    def _admit_locked(self):
        """Pop admissible requests into slots (shedding expired ones at
        dequeue); pages are reserved here so a request is only popped
        when its prompt fits. Returns (admitted, shed, starved) —
        ``starved`` is a request that can NEVER be admitted (no active
        slots to recycle pages from and nothing else admitted this
        round): it must fail typed instead of stalling forever."""
        pred = self.predictor
        admitted, shed = [], []
        if self._policy == "drain" and self._active_count() > 0:
            return admitted, shed, None
        free = [i for i in range(pred.slots) if self._slot_req[i] is None]
        now = time.monotonic()
        while free and self._q:
            r = self._q[0]
            if r.deadline is not None and now > r.deadline:
                shed.append(self._q.popleft())
                continue
            try:
                r.pages = pred.pool.alloc(pred.pages_needed(r.tokens.shape[0]))
            except PagePoolExhausted:
                if not admitted and self._active_count() == 0:
                    return admitted, shed, self._q.popleft()
                break     # backpressure: completions will recycle pages
            self._q.popleft()
            r.slot = free.pop(0)
            self._slot_req[r.slot] = r
            admitted.append(r)
        if shed or admitted:
            self._cond.notify_all()   # queue space freed
        return admitted, shed, None

    def _record_pool(self):
        s = self.predictor.pool.stats()
        profiler.generate_record(pages_in_use=s["in_use"],
                                 pages_high_water=s["high_water"],
                                 pool_pages=s["num_pages"])

    def _vacate(self, r):
        slot = r.slot
        if slot is not None:
            with self._cond:
                self._slot_req[slot] = None
                self._active[slot] = False
                self._block_tables[slot, :] = 0
                self._positions[slot] = 0
                self._tokens[slot] = 0
                self._cond.notify_all()
        if r.pages:
            self.predictor.pool.free(r.pages)
            r.pages = []
        self._record_pool()

    def _flush_stream(self, r, final=False):
        if r.stream_fn is None:
            r.unflushed = []
            return
        if r.unflushed and (final or len(r.unflushed) >= self._flush_every):
            chunk, r.unflushed = r.unflushed, []
            try:
                r.stream_fn(chunk)
            except Exception:
                pass     # a broken stream consumer must not kill the loop

    def _finish(self, r, reason):
        self._vacate(r)
        self._flush_stream(r, final=True)
        profiler.generate_record(finished=1, **{reason: 1})
        r.future.set_result({
            "tokens": list(r.out),
            "finish_reason": reason,
            "prompt_tokens": int(r.tokens.shape[0]),
            "ttft_s": r.ttft,
            "latency_s": time.perf_counter() - r.t_submit,
        })

    def _fail(self, r, exc, counter=None):
        self._vacate(r)
        self._flush_stream(r, final=True)
        profiler.generate_record(finished=1, **{counter or "errors": 1})
        if not r.future.done():
            r.future.set_exception(exc)

    def _check_done(self, r, tok):
        """EOS / length / deadline disposition for a just-produced
        token; returns True when the request left its slot."""
        if r.eos_id is not None and tok == r.eos_id:
            self._finish(r, self.FINISH_EOS)
            return True
        if len(r.out) >= r.max_new:
            self._finish(r, self.FINISH_LENGTH)
            return True
        if r.deadline is not None and time.monotonic() > r.deadline:
            self._fail(r, DeadlineExceeded(
                "generate: deadline expired after %d token(s); slot and "
                "pages recycled" % len(r.out)), counter="deadline")
            return True
        return False

    def _prefill_one(self, r):
        pred = self.predictor
        t0 = time.perf_counter()
        try:
            logits = pred.prefill(r.tokens, r.pages)
        except Exception as e:
            self._fail(r, e)
            return
        now = time.perf_counter()
        r.ttft = now - r.t_submit
        tok = int(np.argmax(logits))
        r.out.append(tok)
        r.unflushed.append(tok)
        # tokens counts every GENERATED token; the first one comes out
        # of prefill, the rest out of decode steps
        profiler.generate_record(prefills=1, tokens=1,
                                 prefill_tokens=int(r.tokens.shape[0]),
                                 busy_seconds=now - t0, ttfts=[r.ttft])
        self._record_pool()
        slot = r.slot
        self._block_tables[slot, :len(r.pages)] = r.pages
        self._positions[slot] = r.tokens.shape[0]
        self._tokens[slot] = tok
        self._flush_stream(r)
        if not self._check_done(r, tok):
            self._active[slot] = True

    def _grow_pages(self):
        """Before a decode step, make sure every active slot owns the
        page its next write position lands in; a pool that cannot grow a
        mid-flight request fails it typed (never a silent stall)."""
        pred = self.predictor
        for slot in np.flatnonzero(self._active):
            r = self._slot_req[slot]
            pidx = min(int(self._positions[slot]),
                       pred.max_ctx - 1) // pred.page_size
            if self._block_tables[slot, pidx] != 0:
                continue
            try:
                page, = pred.pool.alloc(1)
            except PagePoolExhausted as e:
                self._fail(r, PagePoolExhausted(
                    "generate: pool exhausted growing a mid-flight "
                    "request past %d token(s): %s" % (len(r.out), e)),
                    counter="exhausted")
                continue
            r.pages.append(page)
            self._block_tables[slot, pidx] = page

    def _decode_step(self):
        pred = self.predictor
        t0 = time.perf_counter()
        logits = pred.decode(self._tokens, self._positions,
                             self._block_tables, self._active)
        active = np.flatnonzero(self._active)
        self._positions[active] += 1
        profiler.generate_record(decode_steps=1, tokens=len(active),
                                 slot_steps=pred.slots,
                                 active_slot_steps=len(active),
                                 busy_seconds=time.perf_counter() - t0)
        for slot in active:
            r = self._slot_req[slot]
            tok = int(np.argmax(logits[slot]))
            r.out.append(tok)
            r.unflushed.append(tok)
            self._tokens[slot] = tok
            self._flush_stream(r)
            self._check_done(r, tok)

    def _run(self):
        try:
            while True:
                with self._cond:
                    while (not self._q and not self._active_count()
                           and not self._stopped):
                        self._cond.wait()
                    if self._stopped:
                        return
                    admitted, shed, starved = self._admit_locked()
                if shed:
                    exc = DeadlineExceeded(
                        "generate: deadline expired before admission "
                        "(shed at dequeue)")
                    for r in shed:
                        if not r.future.done():
                            r.future.set_exception(exc)
                    profiler.generate_record(shed=len(shed))
                if starved is not None:
                    self._fail(starved, PagePoolExhausted(
                        "generate: prompt of %d token(s) cannot be "
                        "admitted — pool empty with no requests in "
                        "flight to recycle from"
                        % starved.tokens.shape[0]), counter="exhausted")
                for r in admitted:
                    self._prefill_one(r)
                if not self._active_count():
                    continue
                self._grow_pages()
                if self._active_count():
                    self._decode_step()
        except BaseException as e:   # loop death: sticky, fail everything
            with self._cond:
                self._error = e
                self._stopped = True
                pending = list(self._q)
                self._q.clear()
                inflight = [r for r in self._slot_req if r is not None]
                self._cond.notify_all()
            for r in pending:
                if not r.future.done():
                    r.future.set_exception(e)
            for r in inflight:
                self._fail(r, e)
            raise

    # -- observability / lifecycle -------------------------------------------
    def stats(self, reset=False):
        """Generative-serving counters (see profiler.generate_stats)."""
        return profiler.generate_stats(reset=reset)

    def close(self, timeout=5.0):
        """Stop the decode loop, fail queued AND in-flight requests
        with the typed :class:`ServerClosed` (a router may retry them
        elsewhere), recycle every page. Idempotent."""
        with self._cond:
            if self._stopped and self._error is None and \
                    not any(self._slot_req) and not self._q:
                return
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout)
        exc = ServerClosed("GenerateServer closed before the request "
                           "finished")
        with self._cond:
            pending = list(self._q)
            self._q.clear()
            inflight = [r for r in self._slot_req if r is not None]
        for r in pending:
            if not r.future.done():
                r.future.set_exception(exc)
        for r in inflight:
            self._fail(r, exc)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
