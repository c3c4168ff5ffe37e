"""PyTorch port: import boundaries and device defaults.

The port, ``chip_smoke.py`` and the port's ``tools/torch_*.py`` scripts
import ``torch`` and never ``jax``,
``flax`` or the JAX package (``neuronx_distributed_tpu``): an AST scan of
every file shows it, and a subprocess that blocks those modules imports
every port module.  Entry points called without ``device=`` run on CUDA
and raise when it is absent.
"""

import ast
import importlib
import os
import pkgutil
import shutil
import subprocess
import sys
import types

import pytest
import torch

import neuronx_distributed_tpu_torch as port
from neuronx_distributed_tpu_torch.config import training_config
from neuronx_distributed_tpu_torch.kvcache.pool import PagePool
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from neuronx_distributed_tpu_torch.serving import ServingEngine
from neuronx_distributed_tpu_torch.trace import InferenceConfig, ParallelInferenceModel
from neuronx_distributed_tpu_torch.trainer import initialize_parallel_model
from neuronx_distributed_tpu_torch.utils.device import resolve_device

fa = importlib.import_module("neuronx_distributed_tpu_torch.ops.flash_attention")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(port.__file__)
FORBIDDEN = ("jax", "flax", "neuronx_distributed_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    tools = os.path.join(REPO, "tools")
    files += [os.path.join(tools, n) for n in sorted(os.listdir(tools))
              if n.startswith("torch_") and n.endswith(".py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _forbidden(name):
    return name is not None and name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


BLOCKED_IMPORT = """
import importlib, pkgutil, sys
for name in list(sys.modules):
    if name.split(".")[0] in {forbidden!r}:
        del sys.modules[name]

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import neuronx_distributed_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
print(len(mods))
"""


def test_port_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_IMPORT.format(forbidden=FORBIDDEN)],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 20


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    icfg = InferenceConfig(2, 4, 8, torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaForCausalLM(cfg)
    model = LlamaForCausalLM(cfg, device="cpu").init_random(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ParallelInferenceModel(model, icfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagePool(2, 4, 4, 8, 8)
    pim = ParallelInferenceModel(model, icfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(pim, page_size=4)
    assert ServingEngine(pim, page_size=4, device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_cuda_or_package(tmp_path):
    """No card: non-zero exit and no result line.  Alone in a directory
    (without the package): the same."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for script in (os.path.join(REPO, "chip_smoke.py"), str(alone)):
        proc = subprocess.run([sys.executable, script], capture_output=True,
                              text=True, timeout=300, env=env,
                              cwd=os.path.dirname(script))
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
    # even where CUDA answers, the copy without the package refuses to run
    fake_cuda = ("import runpy, sys, torch; torch.cuda.is_available = "
                 "lambda: True; sys.argv = [sys.argv[1]]; "
                 "runpy.run_path(sys.argv[0], run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", fake_cuda, str(alone)],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(tmp_path))
    assert proc.returncode != 0 and "package" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_walk_covers_the_slice():
    names = {m.name for m in pkgutil.walk_packages(port.__path__,
                                                   "neuronx_distributed_tpu_torch.")}
    for mod in ("ops.paged_attention", "ops._build", "ops.flash_attention",
                "parallel.norm", "parallel.layers", "parallel.qkv",
                "models.llama", "models.gemma", "convert.jax_params", "kvcache.allocator",
                "kvcache.prefix", "kvcache.pool", "kvcache.quant",
                "trace.engine",
                "serving.request", "serving.scheduler", "serving.driver",
                "serving.paged", "serving.engine", "utils.logger",
                "utils.device", "version", "config", "models.common",
                "parallel.loss", "parallel.grads", "optimizer.adamw_fp32",
                "trainer.trainer", "trainer.metrics", "tenancy",
                "tenancy.store", "peft", "resilience", "resilience.faults",
                "resilience.supervisor", "obs", "obs.registry",
                "obs.schemas", "obs.flight", "obs.tracing",
                "obs.transfer_audit", "obs.metrics_server",
                "utils.timeline") + PART2_MODULES + FLEET_MODULES + TP_MODULES \
            + A9E_MODULES + A11_MODULES:
        assert f"neuronx_distributed_tpu_torch.{mod}" in names


# ROADMAP A8 part 2: the modules the AST scan and the blocked import above
# must reach
PART2_MODULES = ("obs.compile_ledger", "obs.memory_ledger", "obs.perf",
                 "obs.health", "obs.aggregate", "obs.report",
                 "obs.hlo_audit", "utils.profiling", "trace.export")


# ROADMAP A7, the fleet: the counterparts of the JAX package's fleet,
# transfer and live-weights modules
FLEET_MODULES = ("serving.fleet", "serving.fleet.replica",
                 "serving.fleet.routing", "serving.fleet.router",
                 "serving.fleet.autopilot", "serving.fleet.disagg",
                 "serving.fleet.disagg.roles",
                 "serving.fleet.disagg.directory",
                 "serving.fleet.disagg.router", "kvcache.transfer",
                 "weights", "weights.swapper")


# ROADMAP A9 with A10's parallel state: tensor-parallel serving
TP_MODULES = ("utils.common", "utils.distributed", "parallel.mesh",
              "parallel.mappings", "serving.lockstep")


# ROADMAP A9e and A10's dtypes: GPT-NeoX and BERT pretraining (LayerNorm
# and the dense core live in parallel.norm and models.common)
A9E_MODULES = ("models.gpt_neox", "models.bert", "utils.dtypes")


# ROADMAP A10's trainer degrees with A11: head padding and ZeRO-1 (the
# layers, loss, grads and trainer were ported files already)
A11_MODULES = ("parallel.pad", "optimizer.zero1", "parallel.loss",
               "parallel.grads", "parallel.qkv", "trainer.trainer")


@pytest.mark.parametrize("mod", TP_MODULES)
def test_tp_module_imports_no_jax(mod):
    _check_module(mod)


@pytest.mark.parametrize("mod", A11_MODULES)
def test_a11_module_imports_no_jax(mod):
    _check_module(mod)


@pytest.mark.parametrize("mod", A9E_MODULES)
def test_a9e_module_imports_no_jax(mod):
    _check_module(mod)


@pytest.mark.parametrize("mod", PART2_MODULES)
def test_part2_module_imports_no_jax(mod):
    _check_module(mod)


@pytest.mark.parametrize("mod", FLEET_MODULES)
def test_fleet_module_imports_no_jax(mod):
    _check_module(mod)


def _check_module(mod):
    path = os.path.join(PKG, *mod.split("."))
    path = (os.path.join(path, "__init__.py") if os.path.isdir(path)
            else path + ".py")
    assert path in _port_files()
    module = importlib.import_module(f"neuronx_distributed_tpu_torch.{mod}")
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [n for n in names if _forbidden(n)], mod
    assert module.__name__.endswith(mod)


def test_part2_arguments_construct_on_the_cpu(tmp_path):
    """``Observability(ledgers=True, health=True, perf=True)`` builds its
    parts, and ``ServingEngine`` takes them on the CPU."""
    from neuronx_distributed_tpu_torch.obs import Observability

    hub = Observability(str(tmp_path), ledgers=True, health=True, perf=True)
    assert None not in (hub.compile_ledger, hub.memory_ledger,
                        hub.health_monitor, hub.perf)
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    model = LlamaForCausalLM(cfg, device="cpu").init_random(0)
    pim = ParallelInferenceModel(model, InferenceConfig(2, 4, 8,
                                                        torch.float32),
                                 device="cpu")
    eng = ServingEngine(pim, page_size=4, device="cpu", obs=hub,
                        compile_ledger=hub.compile_ledger,
                        memory_ledger=hub.memory_ledger,
                        health=hub.health_monitor, perf=hub.perf)
    assert eng.compile_ledger is pim.compile_ledger is hub.compile_ledger
    assert eng._perf is pim.perf is hub.perf
    assert hub.memory_ledger.subsystems()["params"]["bytes"] == sum(
        p.numel() * 4 for p in model.parameters())
    eng.close()
    hub.close()


def test_training_entry_points_default_to_cuda(monkeypatch):
    """``initialize_parallel_model`` runs on CUDA unless ``device="cpu"``;
    the flash entries run where their tensors lie: the kernels for CUDA
    tensors, the plain versions for CPU tensors, and nothing else."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32)
    config = training_config(compute_dtype="float32")
    build = lambda d: LlamaForCausalLM(cfg, device=d)  # noqa: E731
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_parallel_model(config, build)
    model = initialize_parallel_model(config, build, device="cpu")
    assert model.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in model.module.parameters())
    cuda_like = types.SimpleNamespace(device=torch.device("cuda"))
    assert fa._route(cuda_like) is True
    q = torch.zeros(1, 2, 4, 64)
    assert fa._route(q) is False
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa._route(q.to("meta"))

    def no_build(name):
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr("neuronx_distributed_tpu_torch.ops._build.load",
                        no_build)
    assert fa.flash_attention(q, q, q).shape == q.shape


@pytest.mark.parametrize("module", ["flash_attention", "paged_attention"])
def test_kernel_wrappers_have_no_fallback(module):
    """No ``try`` in a kernel module: on CUDA a wrapper launches its
    kernel or raises, and never falls back to its plain version."""
    path = os.path.join(PKG, "ops", f"{module}.py")
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
