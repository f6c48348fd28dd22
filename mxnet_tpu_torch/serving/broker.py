"""Serving brokers (counterpart of ``mxnet_tpu/serving/broker.py``): the
dynamic-batching :class:`ModelServer` for bound symbol models and the
continuous-batching :class:`GenerateServer`.

Bounded queue depth gives backpressure: ``submit`` blocks (up to
``MXNET_SERVE_SUBMIT_TIMEOUT``) while the queue holds
``MXNET_SERVE_QUEUE_DEPTH`` requests, then raises. A decode-loop death is
sticky and surfaces on the next submit. ``close()`` stops and joins the
loop with a bounded deadline and fails queued and in-flight requests
loudly.

``ModelServer.swap_from_checkpoint(prefix=, epoch=)`` hot-swaps a model
from a ``save_checkpoint`` pair (``model.load_checkpoint``); an int8 model
requantizes its weights on the swap. Requests carry an optional QoS
``tenant`` and ``priority`` class (``serving/qos.py``): the worker dequeues
by class, then FIFO, and counts sheds per tenant; ``pending()`` is the
drain observable of a fleet replica (``serving/fleet.py``), and
:class:`ReplicaDraining` its typed admission rejection.
``swap_from_checkpoint(directory=)`` swaps in the newest committed
checkpoint of an elastic-training ``CheckpointManager`` directory.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from .. import chaos, profiler
from .generate import (
    GenerateError,
    GenerativePredictor,
    PagePoolExhausted,
    PrefixIndex,
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


class ReplicaDraining(ServerClosed):
    """Admission-time rejection from a replica in the ``draining`` state
    (explicit drain RPC or rolling ``fleet_swap``): nothing was executed,
    in-flight work continues to completion, and the router is expected to
    retry the request on a different replica."""


class ServerOverloaded(ServingError):
    """Backpressure rejection: the bounded request queue stayed full
    past the submit timeout. The request never entered the queue."""


class _Request:
    __slots__ = ("inputs", "rows", "future", "t_submit", "deadline",
                 "tenant", "priority")

    def __init__(self, inputs, rows, deadline=None, tenant=None,
                 priority=1):
        self.inputs = inputs
        self.rows = rows
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = deadline  # absolute time.monotonic(), or None
        self.tenant = tenant      # QoS label, or None
        self.priority = 1 if priority is None else int(priority)


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
        self._busy = False       # a batch is executing right now
        # held around every batch forward; swap() takes it to wait out the
        # in-flight batch before republishing weights
        self._exec_lock = threading.Lock()
        self._batch_hook = None  # test seam: called before each forward
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
        """Pop the largest ready batch: queued requests in priority-then-
        FIFO order while the running row total fits the largest bucket.
        Requests whose deadline passed are shed here, before they take a
        batch slot. Priority classes reorder only when classes mix (a
        stable sort: FIFO within a class), so a latency request jumps
        queued bulk work. Returns (reqs, rows, shed)."""
        cap = self.predictor.max_bucket
        now = time.monotonic()
        shed, reqs, total = [], [], 0
        queue = self._q
        if len({r.priority for r in queue}) > 1:
            queue = sorted(queue, key=lambda r: r.priority)
        taken = set()
        for r in queue:
            if r.deadline is not None and now > r.deadline:
                shed.append(r)
                taken.add(id(r))
                continue
            if reqs and total + r.rows > cap:
                break
            reqs.append(r)
            taken.add(id(r))
            total += r.rows
        if taken:
            if len(taken) == len(self._q):
                self._q.clear()
            else:
                remaining = [r for r in self._q if id(r) not in taken]
                self._q.clear()
                self._q.extend(remaining)
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
                    if reqs:
                        self._busy = True
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
                        if r.tenant is not None:
                            profiler.qos_record(r.tenant, shed=1)
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
                finally:
                    with self._cond:
                        self._busy = False
                        self._cond.notify_all()
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
            if self._batch_hook is not None:
                self._batch_hook(reqs)
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
        server binds one at its ladder, dtype and device; other keywords
        (``quant=``, ``calib_data=``, ...) go to the predictor."""
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

    def submit(self, name, inputs, timeout=None, deadline=None,
               tenant=None, priority=None):
        """Enqueue one request; returns a ``concurrent.futures.Future``
        resolving to the list of output arrays (request row count). A
        ``deadline`` (seconds from now) makes it sheddable: still queued
        when it passes, the request is dropped at dequeue and its future
        fails with :class:`DeadlineExceeded`. ``tenant``/``priority``
        label the request for QoS: a lower priority dequeues first (see
        ``qos.PRIORITIES``), and sheds of a labelled request are counted
        per tenant in ``qos_stats``."""
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
        req = _Request(inputs, rows, deadline=deadline, tenant=tenant,
                       priority=priority)
        depth = worker.enqueue(
            req, self._submit_timeout if timeout is None else timeout)
        profiler.serving_record(name, requests=1, queue_depth=depth)
        return req.future

    def predict(self, name, inputs, timeout=None, tenant=None,
                priority=None):
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(name, inputs, timeout=timeout, tenant=tenant,
                           priority=priority).result()

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

    def swap_from_checkpoint(self, name, prefix=None, epoch=None,
                             directory=None):
        """Hot-swap a resident model from a checkpoint, as :meth:`swap` with
        ``allow_extra=True``: the pair ``prefix``-``epoch``
        (``model.load_checkpoint``; epoch 0 when None), or the newest
        committed checkpoint of the elastic-training ``CheckpointManager``
        ``directory`` (``CheckpointManager.latest()``)."""
        if (prefix is None) == (directory is None):
            raise ServingError("swap_from_checkpoint: pass exactly one of "
                               "prefix= or directory=")
        if prefix is not None:
            from ..model import load_checkpoint

            _, arg_params, aux_params = load_checkpoint(
                prefix, 0 if epoch is None else int(epoch))
        else:
            from ..checkpoint import CheckpointManager

            ckpt = CheckpointManager(directory).latest()
            if ckpt is None:
                raise ServingError(
                    "swap_from_checkpoint: no committed checkpoint "
                    "under %r" % directory)
            arg_params, aux_params = ckpt.split_weights()
        return self.swap(name, arg_params, aux_params, allow_extra=True)

    def stats(self, reset=False):
        """Per-model serving counters (see profiler.serving_stats)."""
        return profiler.serving_stats(reset=reset)

    def pending(self):
        """Queued requests plus in-flight batches across all resident
        models: the drain observable (a draining replica admits nothing and
        waits for this to reach 0 before swapping or deregistering)."""
        with self._lock:
            workers = list(self._workers.values())
        total = 0
        for w in workers:
            with w._cond:
                total += len(w._q) + (1 if w._busy else 0)
        return total

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
                 "t_submit", "deadline", "no_eos", "out", "pages", "slot",
                 "ttft", "unflushed", "prefix_len", "shared", "draft_pages",
                 "draft_pos")

    def __init__(self, tokens, max_new, eos_id, deadline, stream_fn):
        self.tokens = tokens
        self.max_new = max_new
        self.eos_id = eos_id
        self.future = Future()
        self.stream_fn = stream_fn
        self.t_submit = time.perf_counter()
        self.deadline = deadline     # absolute time.monotonic(), or None
        self.no_eos = False          # chaos generate:stall: never sees EOS
        self.out = []
        self.pages = []
        self.slot = None
        self.ttft = None
        self.unflushed = []
        self.prefix_len = 0          # tokens covered by shared prefix pages
        self.shared = 0              # pages borrowed from the prefix index
        self.draft_pages = []        # draft predictor's pages (spec decode)
        self.draft_pos = 0           # next position the draft cache needs


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

    ``prefix_cache`` (``MXNET_GENERATE_PREFIX_CACHE``) turns on the
    shared-prefix KV cache: admission matches the longest indexed run of
    full prompt pages (:class:`~.generate.PrefixIndex`), shares those
    pages copy-on-write and prefills only the tail; ``prefix_evict``
    bounds the pages the index may pin. ``spec_k``
    (``MXNET_GENERATE_SPEC_K``) > 0 turns on speculative decoding: a
    draft model (the target's first ``draft`` layers, or
    ``draft_config``/``draft_params``) proposes up to k tokens a slot,
    and one ``extend`` of the target verifies them. Both give the same
    greedy tokens as the plain path.

    ``device`` defaults to ``cuda`` (raising when there is none); pass
    ``device="cpu"`` to serve on the CPU.

    A sharded predictor (``GenerativePredictor(mesh=)``, or ``mesh=``
    passed through to it) is served the same way on the mesh's rank 0
    while every other rank runs ``predictor.follow()``; :meth:`close`
    releases them. A failed sharded call (a follower died) ends the
    decode loop with the error, which every pending request gets.
    Speculative decoding on a sharded predictor takes the self-draft
    (``draft`` layers, ``GenerativePredictor.self_draft``): it holds views
    of the target's blocks, and each of its calls reaches the followers
    through the target's lockstep as an op of its own. An explicit
    ``draft_config``/``draft_params`` there raises (not ported).
    """

    FINISH_EOS = "eos"
    FINISH_LENGTH = "length"

    def __init__(self, config=None, params=None, predictor=None, *,
                 slots=None, page_size=None, pool_bytes=None,
                 max_steps=None, stream_flush=None, queue_depth=None,
                 submit_timeout=None, admit_policy="continuous",
                 prefix_cache=None, prefix_evict=None, spec_k=None,
                 draft=None, draft_config=None, draft_params=None,
                 device=None, name="generate", **pred_kwargs):
        if predictor is None and (config is None or params is None):
            raise GenerateError(
                "GenerateServer: need either predictor= or "
                "config=/params=")
        # knob parsing first: a malformed knob must raise (naming the
        # knob) before any device work or thread starts
        prefix_on = _env_strict_bool("MXNET_GENERATE_PREFIX_CACHE") \
            if prefix_cache is None else bool(prefix_cache)
        prefix_bound = _env_nonneg_int("MXNET_GENERATE_PREFIX_EVICT") \
            if prefix_evict is None else int(prefix_evict)
        self._spec_k = _env_nonneg_int("MXNET_GENERATE_SPEC_K") \
            if spec_k is None else int(spec_k)
        draft_layers = _env_nonneg_int("MXNET_GENERATE_DRAFT") \
            if draft is None else int(draft)
        mesh = pred_kwargs.get("mesh") if predictor is None \
            else predictor.mesh
        if self._spec_k > 0 and mesh is not None and (
                draft_config is not None or draft_params is not None):
            raise GenerateError(
                "GenerateServer: speculative decoding (spec_k=%d) on a "
                "sharded predictor with draft_config=/draft_params= is not "
                "ported: use the self-draft (draft=N layers)" % self._spec_k)
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
        self._prefix = PrefixIndex(predictor.page_size, prefix_bound) \
            if prefix_on else None
        self._draft = None
        if self._spec_k > 0:
            if draft_config is None or draft_params is None:
                if draft_layers < 1:
                    raise GenerateError(
                        "GenerateServer: speculative decoding "
                        "(MXNET_GENERATE_SPEC_K=%d) needs a draft model: "
                        "set MXNET_GENERATE_DRAFT >= 1 (self-draft layer "
                        "count) or pass draft_config=/draft_params="
                        % self._spec_k)
                # the self-draft's tensors are views of the target's fp32
                # params (its blocks on a mesh): the draft copies nothing
                try:
                    self._draft = predictor.self_draft(draft_layers)
                except ValueError as e:
                    raise GenerateError("GenerateServer: %s" % e)
            else:
                self._draft = GenerativePredictor(
                    draft_config, draft_params, slots=predictor.slots,
                    page_size=predictor.page_size, pool_bytes=0,
                    max_ctx=predictor.max_ctx, device=predictor.device)

        S, MP = predictor.slots, predictor.max_pages_per_slot
        self._slot_req = [None] * S
        self._block_tables = np.zeros((S, MP), np.int32)
        self._positions = np.zeros((S,), np.int32)
        self._tokens = np.zeros((S,), np.int32)
        self._active = np.zeros((S,), bool)
        # the draft model's own block tables (its pool is auto-sized to
        # slots x max-context pages, so draft growth can never exhaust)
        self._draft_bt = np.zeros((S, MP), np.int32) \
            if self._draft is not None else None

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

    def _alloc_pages(self, n):
        """``pool.alloc`` with prefix-index pressure relief: under
        exhaustion, evict least-recently-matched index entries until the
        allocation fits or the index is empty, so sharing never causes a
        :class:`PagePoolExhausted` a no-sharing run would avoid. (An
        evicted page only becomes free once no live request still shares
        it, hence the loop.)"""
        pred = self.predictor
        while True:
            try:
                return pred.pool.alloc(n)
            except PagePoolExhausted:
                if self._prefix is None or \
                        not self._prefix.evict_lru(pred.pool):
                    raise
                profiler.generate_record(prefix_evictions=1)

    def _reserve_pages(self, r):
        """Reserve a request's KV pages at admission: match the longest
        cached prefix (those pages are shared copy-on-write; the match
        already took the request's reference on each) and allocate
        private pages for the rest. On exhaustion the match references are
        released and the FULL allocation is retried unshared (sharing must
        never block an admission the unshared path could serve) before the
        exhaustion propagates."""
        pred = self.predictor
        need = pred.pages_needed(r.tokens.shape[0])
        matched = []
        if self._prefix is not None:
            matched = self._prefix.match([int(t) for t in r.tokens],
                                         pred.pool)
        try:
            tail = self._alloc_pages(need - len(matched))
        except PagePoolExhausted:
            if not matched:
                raise
            pred.pool.unref(matched)
            matched, tail = [], self._alloc_pages(need)
        r.pages = matched + tail
        r.shared = len(matched)
        r.prefix_len = len(matched) * pred.page_size

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
                self._reserve_pages(r)
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
                                 pool_pages=s["num_pages"],
                                 page_ref_high_water=s["ref_high_water"])
        if self._prefix is not None:
            profiler.generate_record(prefix_pages=self._prefix.pages)

    def _vacate(self, r):
        slot = r.slot
        if slot is not None:
            with self._cond:
                self._slot_req[slot] = None
                self._active[slot] = False
                self._block_tables[slot, :] = 0
                self._positions[slot] = 0
                self._tokens[slot] = 0
                if self._draft_bt is not None:
                    self._draft_bt[slot, :] = 0
                self._cond.notify_all()
        if r.pages:
            # drops ONE reference per page: private pages free, shared
            # prefix pages just decrement (the index and/or other
            # requests still hold theirs)
            self.predictor.pool.free(r.pages)
            r.pages = []
        if r.draft_pages:
            self._draft.pool.free(r.draft_pages)
            r.draft_pages = []
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
        if r.eos_id is not None and tok == r.eos_id and not r.no_eos:
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
        if chaos.generate_fault() == "stall":
            r.no_eos = True    # the request that never emits EOS
        t0 = time.perf_counter()
        try:
            if r.prefix_len:
                # shared-prefix admission: the first prefix_len tokens'
                # K/V already live in the matched (shared) pages; run only
                # the uncovered tail, which attends the shared pages but
                # writes only the private ones (copy-on-write)
                logits = pred.extend_tail(r.tokens[r.prefix_len:],
                                          r.prefix_len, r.pages)
            else:
                logits = pred.prefill(r.tokens, r.pages)
            if self._draft is not None:
                r.draft_pages = self._draft.pool.alloc(
                    self._draft.pages_needed(r.tokens.shape[0]))
                self._draft.prefill(r.tokens, r.draft_pages)
        except Exception as e:
            self._fail(r, e)
            return
        now = time.perf_counter()
        r.ttft = now - r.t_submit
        tok = int(np.argmax(logits))
        r.out.append(tok)
        r.unflushed.append(tok)
        # tokens counts every GENERATED token; the first one comes out
        # of prefill, the rest out of decode steps. prefill_tokens counts
        # tokens actually RUN: a matched prefix's tokens land in
        # prefill_tokens_saved instead (their sum is the prompt)
        profiler.generate_record(prefills=1, tokens=1,
                                 prefill_tokens=int(r.tokens.shape[0])
                                 - r.prefix_len,
                                 busy_seconds=now - t0, ttfts=[r.ttft])
        if r.prefix_len:
            profiler.generate_record(prefix_hits=1, shared_pages=r.shared,
                                     prefill_tokens_saved=r.prefix_len)
        if self._prefix is not None:
            # index this prompt's full pages for future admissions (the
            # index takes its own reference on newly indexed pages, so
            # they outlive this request)
            self._prefix.insert([int(t) for t in r.tokens], r.pages,
                                pred.pool)
        self._record_pool()
        slot = r.slot
        self._block_tables[slot, :len(r.pages)] = r.pages
        self._positions[slot] = r.tokens.shape[0]
        self._tokens[slot] = tok
        if self._draft is not None:
            self._draft_bt[slot, :len(r.draft_pages)] = r.draft_pages
            r.draft_pos = int(r.tokens.shape[0])
        self._flush_stream(r)
        if not self._check_done(r, tok):
            self._active[slot] = True

    def _grow_pages(self, headroom=0):
        """Before a decode step, make sure every active slot owns the
        page(s) its next write positions land in, up to ``headroom``
        extra positions past the pending one for a speculative round's
        verify writes (in the draft's table too); a pool that cannot grow
        a mid-flight request fails it typed (never a silent stall)."""
        pred = self.predictor
        for slot in np.flatnonzero(self._active):
            r = self._slot_req[slot]
            upto = min(int(self._positions[slot]) + headroom,
                       pred.max_ctx - 1)
            try:
                for pidx in range(upto // pred.page_size + 1):
                    if self._block_tables[slot, pidx] != 0:
                        continue
                    page, = self._alloc_pages(1)
                    r.pages.append(page)
                    self._block_tables[slot, pidx] = page
                if self._draft is not None:
                    for pidx in range(upto // pred.page_size + 1):
                        if self._draft_bt[slot, pidx] != 0:
                            continue
                        page, = self._draft.pool.alloc(1)
                        r.draft_pages.append(page)
                        self._draft_bt[slot, pidx] = page
            except PagePoolExhausted as e:
                self._fail(r, PagePoolExhausted(
                    "generate: pool exhausted growing a mid-flight "
                    "request past %d token(s): %s" % (len(r.out), e)),
                    counter="exhausted")

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

    def _spec_step(self):
        """One speculative-decoding round, in place of one single-token
        decode step when ``spec_k > 0``:

        1. the DRAFT predictor catches its KV cache up to each slot's
           committed chain, then proposes up to k tokens a slot (batched
           single-token draft steps with per-slot feed cursors; slots
           needing fewer steps go inactive early);
        2. ONE batched ``extend`` of the TARGET verifies, per slot, the
           pending token plus its proposals (k + 1 rows);
        3. the longest proposal prefix agreeing with the target's argmax
           chain is accepted and emitted, plus the target's own next token
           (the replacement at the first disagreement, the bonus token on
           full acceptance).

        Every emitted token IS the argmax of the target's logits given
        the tokens before it (acceptance is argmax equality, first index
        on ties), so the chain is token for token the non-speculative
        greedy chain, and EOS / length / deadline disposition runs per
        emitted token in order. ``k_i`` is capped by the context bound but
        not by the tokens a request has left, so the last round may verify
        past ``max_new_tokens``; ``_check_done`` cuts the tail. Rejected
        proposals leave K/V behind past the accepted prefix in both
        caches; the next round writes those positions before any row
        attends them."""
        pred, draft, k = self.predictor, self._draft, self._spec_k
        t0 = time.perf_counter()
        active = [int(s) for s in np.flatnonzero(self._active)]
        S = pred.slots

        chain_len, k_i, feed, props = {}, {}, {}, {}
        for s in active:
            r = self._slot_req[s]
            chain = [int(t) for t in r.tokens] + r.out
            L = len(chain)                    # pending sits at L - 1
            chain_len[s] = L
            k_i[s] = max(0, min(k, pred.max_ctx - L))
            # tokens the draft cache has not ingested yet (committed chain
            # only; proposals are appended as they are drafted)
            feed[s] = [(chain[p], p) for p in range(r.draft_pos, L)]
            props[s] = []

        # -- draft phase: batched single-token steps ------------------
        while True:
            todo = [s for s in active if len(props[s]) < k_i[s]]
            if not todo:
                break
            toks = np.zeros((S,), np.int32)
            poss = np.zeros((S,), np.int32)
            act = np.zeros((S,), bool)
            fed = {}
            for s in todo:
                if feed[s]:
                    t, p = feed[s].pop(0)
                else:
                    j = len(props[s])
                    t, p = props[s][j - 1], chain_len[s] + j - 1
                toks[s], poss[s], act[s] = t, p, True
                fed[s] = p
            logits = draft.decode(toks, poss, self._draft_bt, act)
            for s in todo:
                # feeding position p yields the draft's prediction for
                # p + 1; only positions at/past the chain end propose
                if fed[s] >= chain_len[s] - 1:
                    props[s].append(int(np.argmax(logits[s])))
                r = self._slot_req[s]
                r.draft_pos = max(r.draft_pos, fed[s] + 1)

        # -- verify phase: one batched target extend ------------------
        T = k + 1
        vt = np.zeros((S, T), np.int32)
        vp = np.zeros((S, T), np.int32)
        vv = np.zeros((S, T), bool)
        for s in active:
            n = 1 + k_i[s]
            vt[s, :n] = ([self._tokens[s]] + props[s])[:n]
            vp[s, :n] = np.arange(chain_len[s] - 1, chain_len[s] - 1 + n)
            vv[s, :n] = True
        logits = pred.extend(vt, vp, self._block_tables, vv)

        # -- accept phase ---------------------------------------------
        emitted_total = 0
        for s in active:
            r = self._slot_req[s]
            L, ks = chain_len[s], k_i[s]
            accepted, emit = 0, []
            for j in range(ks + 1):
                t_target = int(np.argmax(logits[s, j]))
                emit.append(t_target)
                if j < ks and props[s][j] == t_target:
                    accepted += 1
                    continue
                break
            # the draft cache is right up to position L + accepted - 1
            # (chain[L-1] and the accepted proposals); what it wrote past
            # that is a rejected token's K/V: rewind the cursor so the
            # next round overwrites it
            r.draft_pos = min(r.draft_pos, L + accepted)
            profiler.generate_record(draft_proposed=ks,
                                     draft_accepted=accepted)
            done = False
            for t in emit:
                r.out.append(t)
                r.unflushed.append(t)
                emitted_total += 1
                self._tokens[s] = t
                self._flush_stream(r)
                if self._check_done(r, t):
                    done = True
                    break
            if not done:
                self._positions[s] = L - 1 + len(emit)
        profiler.generate_record(
            decode_steps=1, spec_rounds=1, tokens=emitted_total,
            slot_steps=S, active_slot_steps=len(active),
            busy_seconds=time.perf_counter() - t0)

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
                if self._draft is not None:
                    # speculative round: the verify writes up to spec_k
                    # positions past the pending token
                    self._grow_pages(headroom=self._spec_k)
                    if self._active_count():
                        self._spec_step()
                else:
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

    @property
    def prefix(self):
        """The :class:`~.generate.PrefixIndex` (None when sharing is
        off)."""
        return self._prefix

    @property
    def draft_predictor(self):
        """The draft :class:`~.generate.GenerativePredictor` (None when
        speculative decoding is off)."""
        return self._draft

    def prefix_stats(self):
        """Prefix-index counters, or None when sharing is off."""
        return None if self._prefix is None else self._prefix.stats()

    def clear_prefix(self):
        """Evict every prefix-index entry, releasing the index's page
        references: after the last in-flight request finishes the pool
        then drains to ``in_use == 0`` (the leak check)."""
        if self._prefix is not None:
            self._prefix.clear(self.predictor.pool)
            self._record_pool()

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
        self.predictor.close()
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
