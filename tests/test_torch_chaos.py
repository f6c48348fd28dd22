"""``MXNET_FAULT_SPEC`` in the PyTorch port against the JAX package.

- Every spec of a table, valid or malformed, parses alike in both
  packages: the same rules, or ``FaultSpecError`` with the same message.
- Every target has its hook in the port: ``chaos.engine()`` builds for
  a spec naming any of them, alone or beside another, with the JAX
  engine's rules, role, rank and incarnation. How the fleet's hooks fire
  is in ``tests/test_torch_fleet.py``, the training plane's (``worker``,
  ``server``, ``rpc``) in ``tests/test_torch_self_healing.py`` and
  ``tests/test_torch_kvstore_server.py``.
- ``generate:stall@req=2`` on a port ``GenerateServer`` on the CPU: the
  second admitted request ignores its EOS, finishes ``"length"`` at the
  cap, its slot and pages come back, and a request queued behind it is
  served.
"""
import numpy as np
import pytest

from mxnet_tpu import chaos as jchaos
from mxnet_tpu_torch import chaos
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.models import transformer as tfm
from mxnet_tpu_torch.serving import GenerateServer

VALID = [
    "",
    "  ;  ",
    "generate:stall@req=1",
    "generate:stall@req=3,restart=any",
    "generate:stall@req=2;generate:stall@req=5",
    "worker:0:crash@step=3",
    "worker:1:nan@step=2,restart=1",
    "worker:0:preempt@step=4",
    "server:0:crash@step=5,restart=any",
    "server:2:preempt@step=1",
    "replica:1:crash@req=4",
    "replica:0:stall@req=2",
    "rpc:drop@op=push,p=0.5,seed=3",
    "rpc:drop@op=pull,n=2,phase=reply",
    "rpc:drop@op=push,side=server",
    "router:drop@n=1,phase=reply",
    "router:drop@p=0.25,seed=9",
    "heartbeat:stall@after=3",
    "autoscaler:crash@tick=2",
    "worker:0:crash@step=3; rpc:drop@op=push,n=1",
]

MALFORMED = [
    "generate:stall",                      # no '@'
    "generate:stall@",                     # empty params
    "generate:stall@step=1",               # generate needs req
    "generate:crash@req=1",                # unknown action
    "generate:0:stall@req=1",              # generate takes no rank
    "generate:stall@req=x",                # not an integer
    "gpu:0:crash@step=1",                  # unknown target
    "worker:crash@step=1",                 # worker needs a rank
    "worker:a:crash@step=1",               # rank not an integer
    "worker:0:crash@req=1",                # crash needs step
    "worker:0:crash@step=1,restart=two",
    "replica:0:stall@step=2",              # replica needs req
    "autoscaler:crash@step=1",             # autoscaler needs tick
    "heartbeat:stall@n=1",                 # stall needs after
    "rpc:drop@p=1.5",                      # p out of [0, 1]
    "rpc:drop@p=half",
    "rpc:drop@phase=later",
    "rpc:drop@side=both",
    "rpc:drop@side=server,phase=reply",    # phase is client-only
    "router:drop@op=push",                 # op is rpc-only
    "router:drop@side=server",
    "rpc:drop@n",                          # bad k=v
    "rpc:drop@=3",
    "generate:stall@req=1;worker:0:boom@step=1",
]


def _parsed(mod, text):
    try:
        return [(r.text, r.target, r.rank, r.action, r.params)
                for r in mod.parse_spec(text)]
    except mod.FaultSpecError as e:
        return ("FaultSpecError", str(e))


@pytest.mark.parametrize("text", VALID + MALFORMED)
def test_spec_parses_alike_in_both_packages(text):
    ours, theirs = _parsed(chaos, text), _parsed(jchaos, text)
    assert ours == theirs
    assert isinstance(ours, list) == (text in VALID)


@pytest.fixture
def fault_spec(monkeypatch):
    def set_spec(text):
        monkeypatch.setenv("MXNET_FAULT_SPEC", text)
        chaos.reset_engine()

    yield set_spec
    monkeypatch.delenv("MXNET_FAULT_SPEC", raising=False)
    chaos.reset_engine()


@pytest.mark.parametrize("text,target", [
    ("worker:0:crash@step=3", "worker"), ("server:0:preempt@step=1", "server"),
    ("replica:1:stall@req=2", "replica"), ("rpc:drop@op=push", "rpc"),
    ("router:drop@n=1", "router"), ("heartbeat:stall@after=2", "heartbeat"),
    ("autoscaler:crash@tick=1", "autoscaler"),
    ("generate:stall@req=1;worker:0:nan@step=2", "worker"),
])
def test_unwired_target_raises_by_name(fault_spec, text, target):
    """Once, the training plane's targets raised by name here; now every
    target is wired: the engine builds, as the JAX package's does, and
    fires nothing at construction."""
    fault_spec(text)
    for _ in range(2):                     # and again: the cached engine
        eng = chaos.engine()
        assert target in [r.target for r in eng.rules]
    jeng = jchaos.ChaosEngine(text)
    assert [(r.text, r.target, r.rank, r.action, r.params)
            for r in eng.rules] == \
        [(r.text, r.target, r.rank, r.action, r.params) for r in jeng.rules]
    assert (eng.role, eng.rank, eng.restart) == \
        (jeng.role, jeng.rank, jeng.restart)
    assert chaos.generate_fault() in (None, "stall")
    assert chaos.rpc_fault("pull") is False or target == "rpc"


def test_generate_fault_counts_admitted_requests(fault_spec):
    fault_spec("generate:stall@req=2")
    assert [chaos.generate_fault() for _ in range(4)] == \
        [None, "stall", None, None]        # fires once
    fault_spec("")
    assert chaos.engine() is None and chaos.generate_fault() is None


def test_generate_stall_ignores_eos_and_recycles(fault_spec):
    cfg = tfm.TransformerConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                                d_ff=64, max_len=64, dtype="float32")
    params = tfm.init_params(cfg, seed=0)
    prompt = np.arange(3, 19)
    kw = dict(slots=1, page_size=8, max_steps=8, device="cpu")
    with GenerateServer(cfg, params, **kw) as srv:
        chain = srv.generate(prompt, max_new_tokens=6)["tokens"]
    eos = chain[2]
    stop = chain.index(eos) + 1
    fault_spec("generate:stall@req=2")
    profiler.generate_reset()
    with GenerateServer(cfg, params, **kw) as srv:
        futs = [srv.submit(prompt, max_new_tokens=6, eos_id=eos)
                for _ in range(3)]         # one slot: each waits its turn
        first, stalled, behind = [f.result(timeout=60) for f in futs]
        stats = srv.stats()
        pool = srv.predictor.pool.stats()
    assert first["finish_reason"] == "eos" and first["tokens"] == chain[:stop]
    assert stalled["finish_reason"] == "length"
    assert stalled["tokens"] == chain and len(chain) == 6
    assert behind["finish_reason"] == "eos"
    assert behind["tokens"] == chain[:stop]
    assert stats["eos"] == 2 and stats["length"] == 1
    assert pool["in_use"] == 0 and pool["allocs"] == pool["frees"]
