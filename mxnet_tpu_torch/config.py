"""The ``MXNET_*`` knobs the port reads.

A copy of the entries of ``mxnet_tpu/config.py`` that this package uses,
with the same defaults and the same strict accessors: a malformed value
raises :class:`~.base.MXNetError` naming the knob, never a silently
substituted default.
"""
from __future__ import annotations

import os

from .base import MXNetError

# name -> (default, description)
KNOBS = {
    "MXNET_SERVE_QUEUE_DEPTH": (
        "256", "per-model bounded request queue; a full queue backpressures "
        "submit() (serving/broker.py)"),
    "MXNET_SERVE_SUBMIT_TIMEOUT": (
        "60", "seconds submit() may block on backpressure before raising "
        "(serving/broker.py)"),
    "MXNET_GENERATE_MAX_STEPS": (
        "256", "decode-step cap per generate request (also the default "
        "max_new_tokens); integer >= 1 (serving/broker.py)"),
    "MXNET_GENERATE_SLOTS": (
        "8", "batch-slot count of the continuous-batching decode step; "
        "integer >= 1 (serving/generate.py)"),
    "MXNET_GENERATE_PAGE_SIZE": (
        "16", "tokens per KV-cache page; integer >= 1 (serving/generate.py)"),
    "MXNET_GENERATE_POOL_BYTES": (
        "0", "KV page-pool budget in bytes; 0 auto-sizes to slots x "
        "max-context pages; integer >= 0 (serving/generate.py)"),
    "MXNET_GENERATE_STREAM_FLUSH": (
        "8", "decode steps between stream_fn token flushes; integer >= 1 "
        "(serving/broker.py)"),
    "MXNET_GENERATE_PREFIX_CACHE": (
        "0", "enable the shared-prefix KV cache: a radix index over full "
        "KV pages keyed by token-id page runs; admission matches the "
        "longest cached prefix, shares those pages copy-on-write via "
        "per-page refcounts and prefills only the uncovered tail; off "
        "(the default) is bit-identical to the unshared path; "
        "0/1/true/false (serving/broker.py GenerateServer)"),
    "MXNET_GENERATE_PREFIX_EVICT": (
        "0", "max KV pages the prefix index may pin; crossing the bound "
        "evicts least-recently-matched entries, and pool pressure "
        "evicts regardless (sharing never causes a PagePoolExhausted "
        "a no-sharing run would avoid); 0 = bounded only by pool "
        "pressure; integer >= 0 (serving/broker.py GenerateServer)"),
    "MXNET_GENERATE_SPEC_K": (
        "0", "speculative-decoding depth: the draft model proposes k "
        "tokens per slot per round and ONE batched verify step of the "
        "target model accepts the longest agreeing prefix (greedy "
        "token-for-token parity with non-speculative decode); 0 "
        "disables; integer >= 0 (serving/broker.py GenerateServer)"),
    "MXNET_GENERATE_DRAFT": (
        "0", "self-draft layer count for speculative decoding: the draft "
        "model is the target's FIRST N transformer layers sharing "
        "embed/pos/final-LN (models/transformer.py draft_from_layers); "
        "0 means an explicit draft_config=/draft_params= must be "
        "passed when MXNET_GENERATE_SPEC_K > 0; integer >= 0 "
        "(serving/broker.py GenerateServer)"),
    "MXNET_FAULT_SPEC": (
        "", "deterministic fault injection rules (chaos.py grammar: "
        "crash/nan/preempt @step, rpc drop, heartbeat stall, replica "
        "crash/stall, router drop, generate stall, autoscaler crash)"),
    "MXNET_SERVE_QUANT": (
        "none", "default serving quantization mode when AOTPredictor "
        "quant=None: 'none' or 'int8' (int8 needs calib_data=; asking "
        "without it raises CalibrationError) (serving/predictor.py, "
        "ir/quantize.py)"),
    "MXNET_QUANT_CALIB_BATCHES": (
        "8", "max calibration batches the int8 quantization pass consumes "
        "from the provided calibration data; integer >= 1 "
        "(ir/quantize.py)"),
    "MXNET_SERVE_BATCH_LADDER": (
        "1,4,16,64", "comma-separated batch-size buckets the AOT predictor "
        "binds; requests pad up to the nearest bucket (serving/predictor.py; "
        "malformed or non-increasing ladders raise)"),
    "MXNET_TPU_ZERO": (
        "0", "shard the weight update over the data axes (ZeRO): "
        "reduce-scatter the gradients, update a 1/N optimizer-state shard, "
        "all-gather the params (parallel/spmd.py, module/spmd_group.py)"),
    "MXNET_TPU_ZERO_WIRE": (
        "raw", "gradient-shard wire treatment inside the ZeRO step: 'raw' or "
        "'2bit' (the error-feedback two-bit quantizer applied to the "
        "reduce-scattered shard; residual is 1/N-sharded too) "
        "(parallel/spmd.py)"),
    "MXNET_TPU_ZERO_WIRE_THRESHOLD": (
        "0.5", "ternary threshold for MXNET_TPU_ZERO_WIRE=2bit; finite float "
        "> 0 (parallel/spmd.py)"),
    "MXNET_TPU_ZERO_MIN_SIZE": (
        "1024", "parameters with fewer elements keep replicated optimizer "
        "state under ZeRO; integer >= 0 (parallel/spmd.py)"),
    "MXNET_TPU_MAX_INFLIGHT": (
        "2", "steps of the fused Module group queued on the card before the "
        "host waits for the oldest; integer >= 1 (module/spmd_group.py)"),
    "MXNET_TPU_DEVICE_METRICS": (
        "1", "keep Module.fit's metric sums on the card (TrainStep "
        "metric_stats), read at Speedometer/epoch boundaries; 0|1 "
        "(module/spmd_group.py, metric.py)"),
    "MXNET_MP_SIZE": (
        "1", "tensor-parallel ('mp') mesh-axis size for the fused SPMD step "
        "and the sharded serving group: train_mesh() splits the world (one "
        "process a device) into a (dp = N // mp) x mp mesh, so mp must "
        "divide the world size; 1 (the default) is bit-identical to the "
        "pure data-parallel path; integer >= 1 (parallel/mesh.py "
        "train_mesh, module/spmd_group.py, serving/predictor.py)"),
    "MXNET_MP_RULES": (
        "", "parameter-sharding rules 'regex:spec;regex:spec' where spec is "
        "a comma list with one entry per dim, each '*' (replicate that dim) "
        "or a mesh-axis name, e.g. 'fc1_weight:mp,*;fc2_weight:*,mp' shards "
        "fc1's output rows and fc2's input columns over mp (the Megatron "
        "pair); a matched rule that names a missing axis or does not divide "
        "the dim raises (no silent replication); malformed grammar raises "
        "naming this knob (parallel/spmd.py parse_rules, "
        "module/spmd_group.py)"),
    "MXNET_TPU_SENTINEL": (
        "off", "anomaly sentinel of the train step: off|record|skip|halt "
        "(parallel/spmd.py)"),
    "MXNET_TPU_REMAT": (
        "0", "rematerialization mode of the train step: 0/off, 1 (full "
        "recompute), conv (keep conv/matmul outputs), pass (the ir/remat.py "
        "plan) (parallel/spmd.py)"),
    "MXNET_IR_TRAIN_PASSES": (
        "", "comma-separated pass pipeline rewriting the training graph "
        "before TrainStep reads it, e.g. layout (parallel/spmd.py)"),
    "MXNET_IR_LAYOUT": (
        "1", "kill switch of the layout pass: 0 runs it with no rules "
        "(ir/passes.py); 0|1, anything else raises"),
    "MXNET_TPU_GUARD": (
        "1", "arm the Module.fit self-healing guardrail when a coordinated "
        "checkpoint directory (MXNET_CHECKPOINT_DIR) is configured: "
        "consecutive-unhealthy / loss-spike detection triggers a "
        "coordinated rollback to CheckpointManager.latest() with LR "
        "backoff (health.py); 0|1, anything else raises"),
    "MXNET_TPU_GUARD_CONSEC": (
        "3", "consecutive unhealthy steps (fused: the sentinel's device "
        "consec counter; host tier: consecutive non-finite-output "
        "batches) that trigger a rollback (health.py)"),
    "MXNET_TPU_GUARD_SPIKE": (
        "10.0", "loss-spike rollback trigger: a checked loss above this "
        "ratio of its running EMA rolls back; 0 disables spike detection "
        "(health.py)"),
    "MXNET_TPU_GUARD_BACKOFF": (
        "0.5", "learning-rate multiplier applied on every rollback (in (0, "
        "1]); applied server-side on dist_async via the rollback RPC "
        "and via a fused-step rebuild on kvstore='tpu' (health.py)"),
    "MXNET_TPU_GUARD_BUDGET": (
        "2", "bounded rollback budget: after this many rollbacks the next "
        "trigger fails the job loudly (elastic supervision resumes it "
        "from the last checkpoint) instead of looping (health.py)"),
    "MXNET_TPU_GUARD_INTERVAL": (
        "10", "fused-tier guard check cadence in batches: the sentinel "
        "counters are drained (one blocking device read) every N "
        "batches, amortized like the Speedometer (health.py)"),
    "MXNET_PREEMPT_GRACE": (
        "15", "preemption grace window in seconds: on SIGTERM/SIGINT a "
        "launch.py-spawned worker drains in-flight steps and writes a "
        "resumable checkpoint, then exits with the distinguished "
        "EXIT_PREEMPTED status; a hard-exit timer guarantees the "
        "process is gone within the window either way (health.py)"),
    "MXNET_CHECKPOINT_DIR": (
        "", "coordinated checkpoint directory (CheckpointManager.from_env; "
        "exported by tools/launch.py to every role) (checkpoint.py)"),
    "MXNET_CHECKPOINT_PERIOD": (
        "1", "checkpoint every N epochs (checkpoint.py)"),
    "MXNET_CHECKPOINT_RETAIN": (
        "2", "newest complete checkpoints kept (checkpoint.py)"),
    "MXNET_TPU_TUNE": (
        "1", "consult the on-disk schedule table for the searched tiles of "
        "the hand-written kernels when they are called (the kernels "
        "consult tune.schedule_for with the hand defaults as fallback, so "
        "an empty table runs the hand defaults); 0 pins the hand defaults "
        "(tune/table.py)"),
    "MXNET_TPU_TUNE_TABLE": (
        "", "schedule-table path override (default ~/.cache/mxnet_tpu/"
        "schedule_table.json); written atomically by python -m "
        "mxnet_tpu_torch.tune, keyed (kernel, shape, dtype, backend) "
        "(tune/table.py)"),
    "MXNET_TUNE_RANKER": (
        "1", "rank sweep candidates with the learned cost model and time "
        "only the top MXNET_TUNE_TOPK (the hand default is always timed); "
        "the ranker abstains into the exhaustive sweep when the model is "
        "missing, under-trained or below the validation rank-correlation "
        "floor; 0 pins the exhaustive sweep (tune/search.py)"),
    "MXNET_TUNE_TOPK": (
        "3", "how many model-ranked candidates a ranked sweep times, on top "
        "of the always-timed hand default (tune/search.py)"),
    "MXNET_TUNE_MODEL": (
        "", "cost-model path override (default: next to the schedule "
        "table, <table>.model.json); versioned JSON written atomically by "
        "model refits; corrupt files log, behave as absent and are "
        "rewritten whole by the next fit (tune/model.py)"),
    "MXNET_TUNE_BACKGROUND": (
        "0", "arm tune.BackgroundTuner in Module.fit: bounded tuning slots "
        "at the epoch-end drain boundary for shapes the job ran "
        "(schedule-table misses), never inside the step loop "
        "(tune/background.py)"),
    "MXNET_TUNE_BG_BUDGET": (
        "2", "max timed programs per background-tuning slot, hand default "
        "included (tune/background.py)"),
    "MXNET_TPU_FEED_DEPTH": (
        "2",
        "DeviceQueueIter bounded pipeline depth: batches staged on the "
        "card ahead of the consumer (parallel/feed.py); integer >= 1"),
    "MXNET_DATA_SHARDS": (
        "8",
        "default shard count for write_record_shards (capped at the "
        "record count so no shard is empty); integer >= 1 "
        "(data/writer.py)"),
    "MXNET_DATA_WORKERS": (
        "0",
        "background decode/augment process-pool size for "
        "ShardedRecordStream; 0 decodes inline on the reading thread; "
        "integer >= 0 (data/service.py)"),
    "MXNET_DATA_PREFETCH": (
        "2",
        "prefetch-queue depth (read/decode chunks buffered ahead of "
        "the training thread); 0 = fully synchronous reads; integer >= 0 "
        "(data/service.py)"),
    "MXNET_DATA_DETERMINISTIC": (
        "1",
        "seed record decode/augment from (epoch, shard, record-index) "
        "so shard rebalancing replays byte-identical batches; 0 salts "
        "seeds with worker identity; 0|1, anything else raises "
        "(data/service.py)"),
    "MXNET_DATA_LEASE_TTL": (
        "30",
        "shard-lease time-to-live in seconds: a lease not renewed "
        "(cursor committed) within the TTL returns to the pool for "
        "rebalancing; finite float > 0 (data/lease.py's local "
        "authority)"),
    "MXNET_KVSTORE_PIPELINE": (
        "1", "async per-shard sender pipeline of the server tier's client; "
        "0 falls back to the synchronous client; 0|1, anything else raises "
        "(kvstore_server.py)"),
    "MXNET_KVSTORE_RPC_RETRIES": (
        "2", "bounded kvstore RPC retries with reconnect to the same URI; "
        "integer >= 0 (kvstore_server.py)"),
    "MXNET_KVSTORE_RECONNECT_DEADLINE": (
        "5", "seconds per reconnect attempt; finite float > 0 "
        "(kvstore_server.py)"),
    "MXNET_KVSTORE_REDISCOVER_TIMEOUT": (
        "30", "seconds to wait for a respawned server's new URI through the "
        "tracker (ServerKVStore(tracker_client=)); finite float > 0 "
        "(kvstore_server.py)"),
    "MXNET_KVSTORE_COALESCE_KEYS": (
        "16", "max keys per coalesced push_multi frame; integer >= 0, 0 "
        "means 1 (kvstore_server.py)"),
    "MXNET_KVSTORE_COALESCE_BYTES": (
        str(1 << 20), "max bytes per coalesced push_multi frame; integer "
        ">= 0, 0 means 1 (kvstore_server.py)"),
    "MXNET_KVSTORE_BARRIER_TIMEOUT": (
        "120", "server barrier timeout in seconds: a barrier that cannot "
        "complete raises instead of spinning (kvstore_server.py)"),
    "MXNET_TPU_ZERO_SERVER": (
        "0", "dist_async mirror of weight-update sharding: slice each "
        "large dense key's value AND optimizer state across ALL "
        "servers (push scatters slices, pull gathers) so per-server "
        "memory scales 1/num_servers; must be set job-wide "
        "(kvstore_server.py); 0|1, anything else raises"),
    "MXNET_MAX_RESTARTS": (
        "0", "elastic respawn budget of a node: > 0 switches the tracker's "
        "and the servers' barriers into elastic mode, where a dead waiter "
        "retracts its arrival (tracker.py, kvstore_server.py)"),
    "MXNET_TRACKER_HEARTBEAT_INTERVAL": (
        "2.0", "client heartbeat period in seconds; finite float > 0 "
        "(tracker.py)"),
    "MXNET_TRACKER_HEARTBEAT_TIMEOUT": (
        "30.0", "scheduler-side beat-loss dead-node threshold in seconds; "
        "finite float > 0 (tracker.py)"),
    "MXNET_TRACKER_BARRIER_TIMEOUT": (
        "120", "tracker barrier timeout in seconds; finite float > 0 "
        "(tracker.py)"),
    "MXNET_FLEET_RETRIES": (
        "2", "router retry budget per request beyond the first attempt: "
        "never-sent failures and admission rejections (draining, closed, "
        "overloaded) retry on another replica, in-flight losses only for "
        "idempotent requests; integer >= 0 (serving/fleet.py)"),
    "MXNET_FLEET_TIMEOUT": (
        "30", "per-request end-to-end budget in seconds across all router "
        "attempts, also forwarded to the replica as its shed-at-dequeue "
        "deadline; finite float > 0 (serving/fleet.py)"),
    "MXNET_FLEET_BACKOFF": (
        "0.05", "base exponential backoff in seconds between router "
        "retries (doubles per attempt, capped at 1 s); finite float >= 0 "
        "(serving/fleet.py)"),
    "MXNET_FLEET_VIEW_INTERVAL": (
        "2.0", "tracker-view refresh period in seconds: the router re-reads "
        "the replicas' membership and load gauges, and each replica "
        "re-publishes at the same cadence; finite float > 0 "
        "(serving/fleet.py)"),
    "MXNET_FLEET_CONNECT_DEADLINE": (
        "5.0", "seconds the router spends connecting to one replica before "
        "the attempt counts as never sent and fails over; finite float > 0 "
        "(serving/fleet.py)"),
    "MXNET_SERVE_DRAIN_TIMEOUT": (
        "30", "seconds a draining replica waits for queued and in-flight "
        "requests before the drain RPC errors (the rolling fleet_swap's "
        "bound); finite float > 0 (serving/fleet.py)"),
    "MXNET_FLEET_AUTOSCALE_INTERVAL": (
        "1.0", "autoscaler control-tick period in seconds; finite float > 0 "
        "(serving/autoscale.py)"),
    "MXNET_FLEET_AUTOSCALE_MIN": (
        "1", "floor on the fleet's desired replica count; integer >= 1, "
        "at most _MAX (serving/autoscale.py)"),
    "MXNET_FLEET_AUTOSCALE_MAX": (
        "4", "ceiling on the fleet's desired replica count; integer >= 1 "
        "(serving/autoscale.py)"),
    "MXNET_FLEET_AUTOSCALE_UP_LOAD": (
        "4.0", "mean queued + in-flight per serving replica at or above "
        "which a tick votes scale-up; finite float > 0 "
        "(serving/autoscale.py)"),
    "MXNET_FLEET_AUTOSCALE_DOWN_LOAD": (
        "0.5", "mean queued + in-flight per serving replica at or below "
        "which a tick votes scale-down; float >= 0, below _UP_LOAD (the "
        "gap is the anti-flap dead band) (serving/autoscale.py)"),
    "MXNET_FLEET_AUTOSCALE_HYSTERESIS": (
        "3", "consecutive agreeing ticks a scale decision needs; integer "
        ">= 1 (serving/autoscale.py)"),
    "MXNET_FLEET_AUTOSCALE_COOLDOWN": (
        "5.0", "seconds after a scale action during which further actions "
        "are held; float >= 0 (serving/autoscale.py)"),
    "MXNET_FLEET_AUTOSCALE_SLO_MS": (
        "0", "serving p99 SLO in milliseconds: a replica at or above it "
        "makes the tick vote scale-up; 0 disables it; float >= 0 "
        "(serving/autoscale.py)"),
    "MXNET_QOS_TENANTS": (
        "", "per-tenant QoS spec 'name[:k=v,...];...' with keys prio|"
        "priority (latency|normal|bulk), req_rate (requests/s > 0) and "
        "tok_rate (rows/s > 0); empty disables QoS; malformed raises "
        "naming this knob (serving/qos.py)"),
    "MXNET_QOS_DEFAULT_PRIORITY": (
        "normal", "priority class of requests with no tenant label or an "
        "unconfigured tenant: latency|normal|bulk (serving/qos.py)"),
    "MXNET_QOS_BURST_SECONDS": (
        "1.0", "token-bucket burst window: a tenant may burst rate x burst "
        "units above its steady rate; finite float > 0 (serving/qos.py)"),
    "MXNET_PS_SERVER_URI": (
        "", "comma-separated server URIs: kvstore.create('dist_async') "
        "returns the ServerKVStore client of these servers (kvstore.py)"),
    "MXNET_PS_BIND_HOST": (
        "", "server bind host override (kvstore_server.py)"),
    "MXNET_PS_BIND_PORT": (
        "0", "server bind port override (kvstore_server.py)"),
    "MXNET_PS_ADVERTISE_HOST": (
        "", "address a multi-host server publishes to the tracker "
        "(kvstore_server.py)"),
    "DMLC_ROLE": (
        "worker", "worker|server|scheduler: the role the server entry "
        "point runs; a worker's is an exit-0 shim (kvstore_server.py)"),
    "DMLC_PS_ROOT_URI": (
        "", "coordinator host (dist.py env_spec)"),
    "DMLC_PS_ROOT_PORT": (
        "9091", "coordinator port (dist.py env_spec)"),
    "DMLC_NUM_WORKER": (
        "1", "world size (dist.py env_spec)"),
    "DMLC_WORKER_ID": (
        "0", "worker rank (dist.py env_spec)"),
    "MXNET_EMBED_SHARDS": (
        "0", "row-shard count override for ShardedEmbeddingTable; 0 (the "
        "default) shards one-per-server, shard s lives on server "
        "s % num_servers otherwise; integer >= 0 (embedding/table.py)"),
    "MXNET_EMBED_DEDUP": (
        "1", "deduplicate requested row ids before pulling (one row_pull "
        "frame per shard); 0 falls back to the naive per-id pull baseline; "
        "0|1, anything else raises (embedding/table.py)"),
    "MXNET_EMBED_PULL_BATCH": (
        "65536", "max rows per row_pull RPC frame: larger requests split "
        "into several frames per shard; integer >= 1 (embedding/table.py)"),
    "MXNET_EMBED_WIRE": (
        "raw", "row-gradient wire of the embedding scatter pushes: 'raw' or "
        "'2bit' (the packed two-bit quantizer on the pushed row block, with "
        "per-row error-feedback residuals held by the client) "
        "(embedding/table.py)"),
    "MXNET_EMBED_WIRE_THRESHOLD": (
        "0.5", "ternary threshold for MXNET_EMBED_WIRE=2bit; finite float "
        "> 0 (embedding/table.py)"),
    "MXNET_STORAGE_FALLBACK_LOG_VERBOSE": (
        "1", "log a warning the first time a sparse array of each storage "
        "type is densified for a dense op; 0 silences it; 0|1 "
        "(ndarray/sparse.py)"),
    "MXNET_IR_PASSES": (
        "fusion", "default pass pipeline for ir.apply_passes(passes=None): "
        "a comma list of registered pass names (fusion|residual|layout|"
        "quantize); unknown names raise naming this knob (ir/passes.py)"),
    "MXNET_PROFILER_MODE": (
        "symbolic", "profiler mode at autostart (symbolic|all) — "
        "profiler.py"),
    "MXNET_PROFILER_AUTOSTART": (
        "0", "start the profiler at import; dump on exit — profiler.py"),
    "MXNET_BACKWARD_DO_MIRROR": (
        "0", "recompute in the backward: a bound executor's training graph "
        "keeps only its variables for the backward and reruns every op "
        "node there (the selective remat with an empty save set); 0|1, "
        "anything else raises (executor.py)"),
    "MXNET_INFER_DEBUG": (
        "0", "set in the environment to a non-empty value (any, as the "
        "JAX package reads it), shape inference prints the full traceback "
        "of each node it fails to evaluate to stderr (executor.py)"),
    "MXNET_TPU_FUSED_ROW_TILE": (
        "", "the JAX package's Pallas row tile (output rows of an image a "
        "grid tile) has no counterpart: B2's tile counts pixel boxes a "
        "chunk, so a set value raises by name and points to the "
        "row_tile launch parameter and the schedule table "
        "(kernels/fused_block.py)"),
    "MXNET_GLUON_REPO": (
        "", "local directory or file:// URL the model zoo copies "
        "pretrained .params files from (gluon/model_zoo/model_store.py)"),
    "MXNET_ENGINE_TYPE": (
        "ThreadedEngine", "the host dependency engine: ThreadedEngine (the "
        "native scheduler; ThreadedEnginePerDevice is an alias) or "
        "NaiveEngine (runs each function when pushed); anything else "
        "raises (engine.py)"),
    "MXNET_CPU_WORKER_NTHREADS": (
        "4", "worker threads of the native ThreadedEngine; integer >= 1 "
        "(engine.py; src/engine.cc)"),
    "MXNET_CPU_PRIORITY_NTHREADS": (
        "4", "no effect: the native engine has one pool ordered by "
        "priority, and torch's streams order the card"),
    "MXNET_GPU_WORKER_NTHREADS": (
        "2", "no effect: torch's CUDA streams order the card's work, not "
        "engine threads"),
    "MXNET_ENGINE_INFO": (
        "0", "accepted and unread: the native engine logs no schedule"),
    "MXNET_TPU_HOST_POOL_BYTES": (
        str(1 << 30), "bytes the default native host storage pool keeps "
        "cached for reuse; integer >= 0 (storage.py)"),
    "MXNET_TPU_NO_NATIVE": (
        "0", "1 forces the Python paths: no native runtime is built or "
        "loaded, recordio reads and writes in Python and the engine is "
        "NaiveEngine (_native.py)"),
    "MXNET_IR_FUSE": (
        "1", "kill switch for rule-based fusion in the model builders: "
        "resnet(fused=True) applies the IR fusion pass when 1, returns the "
        "unfused graph when 0 (models/resnet.py); 0|1, anything else raises"),
}


def get(name):
    """Raw string value of a knob: the environment wins, then the default."""
    if name in os.environ:
        return os.environ[name]
    if name in KNOBS:
        return KNOBS[name][0]
    return None


def get_int(name, default=None):
    """The knob as an int (None when unset and without a default)."""
    v = os.environ.get(name)
    if v is None:
        v = str(default) if default is not None else get(name)
    return int(v) if v not in (None, "") else None


def get_bool(name, default=False):
    """Lenient boolean: 1/true/yes/on are True, anything else False (the
    JAX package's ``get_bool``, used for ``MXNET_TPU_TUNE``)."""
    v = os.environ.get(name, "1" if default else "0")
    return str(v).strip().lower() in ("1", "true", "yes", "on")


def get_strict_bool(name):
    """0/1/true/false/yes/no/on/off; anything else raises MXNetError."""
    v = str(get(name)).strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise MXNetError("%s=%r must be a boolean (0|1)" % (name, get(name)))


def get_choice(name, choices):
    """The knob lower-cased, which must be one of ``choices``."""
    v = str(get(name)).strip().lower()
    if v not in choices:
        raise MXNetError("%s=%r must be one of %s"
                         % (name, get(name), "|".join(choices)))
    return v


def get_nonneg_int(name):
    raw = get(name)
    try:
        v = int(str(raw).strip())
    except (TypeError, ValueError):
        v = -1
    if v < 0:
        raise MXNetError("%s=%r must be an integer >= 0" % (name, raw))
    return v


def get_positive_int(name):
    raw = get(name)
    try:
        v = int(str(raw).strip())
    except (TypeError, ValueError):
        v = 0
    if v < 1:
        raise MXNetError("%s=%r must be an integer >= 1" % (name, raw))
    return v


def get_nonneg_float(name):
    raw = get(name)
    try:
        v = float(str(raw).strip())
    except (TypeError, ValueError):
        v = float("nan")
    if not 0.0 <= v < float("inf"):  # also rejects NaN
        raise MXNetError("%s=%r must be a finite float >= 0" % (name, raw))
    return v


def get_positive_float(name):
    raw = get(name)
    try:
        v = float(str(raw).strip())
    except (TypeError, ValueError):
        v = float("nan")
    if not 0.0 < v < float("inf"):  # also rejects NaN
        raise MXNetError("%s=%r must be a finite float > 0" % (name, raw))
    return v


def describe():
    """``[(name, current value, description)]`` for every knob the port
    reads."""
    return [(n, get(n), d) for n, (_default, d) in sorted(KNOBS.items())]


def print_summary():
    for name, value, desc in describe():
        print("%-40s %-10s %s" % (name, value, desc))
