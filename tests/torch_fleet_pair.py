"""Shared rig of the PyTorch-port fleet parity tests: each scenario runs
once through the JAX package and once through the port, over a namespace
of the same names, and the two logs must be equal.

- :func:`ns` -- the namespace of one side (``"jax"`` or ``"port"``): the
  fleet, routing, disaggregation, autopilot and live-weights classes, the
  serving and page-cache primitives, the fault plane and the schemas.
- :func:`fake_engine` -- the host-side engine fake of JAX
  ``tests/test_fleet.py`` built over a side's ``RequestOutput`` and
  ``BackpressureError``.
- :func:`engine_factory` -- a paged tiny-Llama ``ServingEngine`` factory
  over the shared pair of :mod:`torch_port_pair` (``page_size`` 4, 9 pages,
  B = 2: the oracles' fixture).
"""

import importlib
import types

import jax
import numpy as np
import torch

from torch_port_pair import C, build_pair

PKGS = {"jax": "neuronx_distributed_tpu", "port": "neuronx_distributed_tpu_torch"}
SIDES = tuple(PKGS)
B, T, PAGE, PAGES = 2, 16, 4, 9

_NS: dict = {}


def ns(side):
    if side in _NS:
        return _NS[side]
    pkg = PKGS[side]

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    n = types.SimpleNamespace(side=side, pkg=pkg)
    for name in ("serving.fleet", "serving.fleet.disagg", "serving",
                 "weights", "resilience"):
        m = mod(name)
        for attr in getattr(m, "__all__", None) or dir(m):
            if not attr.startswith("__"):
                setattr(n, attr, getattr(m, attr))
    driver = mod("serving.driver")
    n.poisson_arrivals, n.replay = driver.poisson_arrivals, driver.replay
    n.autopilot = mod("serving.fleet.autopilot")
    n.routing = mod("serving.fleet.routing")
    n.router_mod = mod("serving.fleet.router")
    n.transfer = mod("kvcache.transfer")
    n.prefix = mod("kvcache.prefix")
    n.allocator = mod("kvcache.allocator")
    n.pool = mod("kvcache.pool")
    n.scheduler = mod("serving.scheduler")
    n.request = mod("serving.request")
    n.supervisor = mod("resilience.supervisor")
    n.faults = mod("resilience.faults")
    n.aggregate = mod("obs.aggregate")
    n.RequestOutput = n.request.RequestOutput
    n.BackpressureError = n.scheduler.BackpressureError
    n.AdmissionError = n.scheduler.AdmissionError
    n.RateLimited = n.scheduler.RateLimited
    n.SlotScheduler = n.scheduler.SlotScheduler
    n.TokenBucket = n.scheduler.TokenBucket
    n.RestartBackoff = n.supervisor.RestartBackoff
    n.load_score = n.routing.load_score
    n.FleetHealth = n.aggregate.FleetHealth
    n.validate_jsonl = mod("obs.schemas").validate_jsonl
    n.validate_record = mod("obs.schemas").validate_record
    n.install_plan = n.faults.install_plan
    n.clear_plan = n.faults.clear_plan
    n.MetricRegistry = mod("obs").MetricRegistry
    n.CompileLedger = mod("obs").CompileLedger
    n.fake = fake_engine(n)
    _NS[side] = n
    return n


def fake_engine(n):
    """JAX ``tests/test_fleet.py``'s ``_FakeEngine`` over side ``n``:
    finishes each request after ``work`` steps, optional bounded
    admission, crash on demand through ``crash_next``."""

    class _FakeEngine:
        def __init__(self, work=2, capacity=None):
            self.work = work
            self.capacity = capacity
            self.queue = []
            self.crash_next = False
            self.closed = False

        def submit(self, req):
            if self.capacity is not None and len(self.queue) >= self.capacity:
                raise n.BackpressureError("fake full")
            self.queue.append([req, self.work])

        def cancel(self, rid):
            for ent in self.queue:
                if ent[0].request_id == rid and ent[1] >= 0:
                    ent[1] = -1  # emit a cancelled output next step
                    return True
            return False

        @property
        def has_work(self):
            return bool(self.queue)

        def step(self):
            if self.crash_next:
                self.crash_next = False
                raise RuntimeError("fake engine crash")
            outs, keep = [], []
            for req, left in self.queue:
                if left > 0:
                    keep.append([req, left - 1])
                    continue
                state = "cancelled" if left < 0 else "finished"
                outs.append(n.RequestOutput(
                    request_id=req.request_id, state=state,
                    finish_reason=None if left < 0 else "length",
                    prompt_len=len(req.prompt_ids),
                    token_ids=() if left < 0 else (1, 2), queue_ms=0.0,
                    ttft_ms=None if left < 0 else 1.0, total_ms=2.0))
            self.queue = keep
            return outs

        def close(self):
            self.closed = True

    return _FakeEngine


def req(n, rid, plen=4, max_new=3, **kw):
    return n.Request(request_id=rid, prompt_ids=list(range(1, plen + 1)),
                     max_new_tokens=max_new, **kw)


def fake_fleet(n, size=3, policy="round_robin", factory=None, **kw):
    factory = n.fake if factory is None else factory
    return n.FleetRouter([n.Replica(i, factory, backoff_base_s=0.0)
                          for i in range(size)], policy=policy, **kw)


def pair(seed=0):
    """``(jax wrapper, port wrapper, jax module, jax params, port cfg)`` at
    B = 2, C = 8, T = 16 (built once per process)."""
    return build_pair(batch_size=B, max_total_len=T, seed=seed)


def pool(side, seed=0):
    jpim, tpim, _, _, _ = pair(seed)
    return jpim if side == "jax" else tpim


def engine_factory(side, model=None, seed=0, num_pages=PAGES, **kw):
    """A paged ``ServingEngine`` factory on ``model`` (default: the pair's
    wrapper of ``side``), each engine with its own registry."""
    n = ns(side)
    model = pool(side) if model is None else model

    def factory():
        if side == "jax":
            return n.ServingEngine(model, rng=jax.random.PRNGKey(seed),
                                   registry=n.MetricRegistry(),
                                   page_size=PAGE, num_pages=num_pages, **kw)
        return n.ServingEngine(model, seed=seed, registry=n.MetricRegistry(),
                               page_size=PAGE, num_pages=num_pages,
                               device="cpu", **kw)
    return factory


def fresh_port_pool(params):
    """A port wrapper of its own over the JAX ``params`` (no other engine
    has held it: a weight swap writes it in place)."""
    from neuronx_distributed_tpu_torch.convert import llama_params_from_jax
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM
    from neuronx_distributed_tpu_torch.trace import (
        InferenceConfig,
        ParallelInferenceModel,
    )

    cfg = pair()[4]
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    return ParallelInferenceModel(
        model, InferenceConfig(B, C, T, torch.float32), device="cpu")


def port_params(params):
    """The port's flat parameter mapping of a JAX param tree."""
    from neuronx_distributed_tpu_torch.convert import llama_params_from_jax

    return llama_params_from_jax(jax.tree.map(np.asarray, params), pair()[4])


def shared_prompts(vocab, n, rs):
    """Half share one page-aligned 4-token preamble, half are unrelated
    (JAX ``tests/test_fleet.py:_shared_prompts``)."""
    sys_ids = rs.randint(1, vocab, size=4).tolist()
    return [
        sys_ids + rs.randint(1, vocab, size=3).tolist()
        if i % 2 == 0 else
        rs.randint(1, vocab, size=int(rs.randint(3, 8))).tolist()
        for i in range(n)
    ]


def by_client(router, outs):
    """``{client id: (tokens, state, replica, requeues, migrations)}`` of a
    drained fleet's outputs ``{global id: output}``."""
    got = {}
    for gid, o in outs.items():
        rec = router._tracked[gid]
        got[router.client_id(gid)] = (list(o.token_ids), o.state,
                                      rec.replica_id, rec.requeues,
                                      rec.migrations)
    return got
