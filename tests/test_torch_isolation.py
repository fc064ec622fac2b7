"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor any module of ``repro``, and its entry points refuse
to run without a CUDA device unless the CPU is asked for."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    bad = [n for n in _imports(path)
           if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.xsim, repro_torch.xsim.grid, repro_torch.cuda_build, "
            "repro_torch.xsim.families, repro_torch.runtime.elastic, "
            "repro_torch.launch.serve, repro_torch.models.transformer, "
            "repro_torch.models.rwkv6, repro_torch.models.lm, "
            "repro_torch.kernels.rwkv6_scan, repro_torch.sched, "
            "repro_torch.sched.queue_sim, repro_torch.sched.strategies, "
            "repro_torch.sched.runner, repro_torch.core.regret, "
            "repro_torch.obs, repro_torch.obs.trace, repro_torch.obs.metrics, "
            "repro_torch.obs.export, repro_torch.obs.telemetry, "
            "repro_torch.obs.registry, repro_torch.obs.serve_obs, "
            "repro_torch.parallel.fleet, repro_torch.runtime.pool, "
            "repro_torch.runtime.checkpoint, repro_torch.serve.asa, "
            "repro_torch.serve.chaos, repro_torch.serve.loop, "
            "repro_torch.rl, repro_torch.rl.features, repro_torch.rl.policy, "
            "repro_torch.rl.rollout, repro_torch.rl.train, "
            "repro_torch.launch.mesh, repro_torch.parallel.sharding, "
            "repro_torch.parallel.dist, repro_torch.launch.train, "
            "repro_torch.runtime.campaign;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')];"
            "assert not bad, bad")
    env_path = str(ROOT / "src")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin"})


def test_entry_points_default_to_cuda():
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve
    from repro_torch.core import prng
    from repro_torch.models import rwkv6, transformer
    from repro_torch.obs import trace
    from repro_torch.rl import policy as rl_policy
    from repro_torch.rl import train as rl_train
    from repro_torch.launch import mesh
    from repro_torch.runtime import campaign
    from repro_torch.sched.centers import CENTERS
    from repro_torch.sched.queue_sim import QueueSim
    from repro_torch.serve import asa as serve_asa
    from repro_torch.serve import loop
    from repro_torch.xsim import families, grid, policies, state

    cfg = grid.XSimConfig(n_warm=4, n_backlog=4, n_arrivals=4)

    def frozen():   # a traced one-scenario batch, on the default device
        return state.freeze(state.empty_table(4), total_cores=8.0,
                            free_cores=8.0, trace_capacity=4)
    lm = ARCHS["qwen2-0.5b"].reduced()
    ssm = ARCHS["rwkv6-3b"].reduced()
    if torch.cuda.is_available():
        assert policies.init_fleet(2).log_p.is_cuda
        assert families.family_grid(cfg, "faulty", n_seeds=1).fault_t.is_cuda
        assert transformer.init_lm(lm)["embed"]["table"].is_cuda
        assert rwkv6.init_decode_state(ssm, 1)["wkv"].is_cuda
        assert trace.init(4, 2).data.is_cuda
        assert frozen().trace.head.is_cuda
        assert serve_asa.init_table(4).key.is_cuda
        assert loop.ASAServer(loop.ServeConfig(n_slots=4))._table.t.is_cuda
        assert rl_policy.init_params(prng.PRNGKey(0)).w1.is_cuda
        assert campaign.CampaignScheduler(QueueSim(
            CENTERS["uppmax"], seed=0)).est.state.log_p.is_cuda
        assert mesh.make_scenarios_mesh().devices[0].type == "cuda"
        return
    for call in (lambda: policies.init_fleet(2),
                 lambda: grid.make_grid(cfg, n_seeds=1),
                 lambda: families.family_grid(cfg, "faulty", n_seeds=1),
                 lambda: grid.center_params(grid.CENTERS["hpc2n"]),
                 lambda: trace.init(4, 2),
                 lambda: grid.make_grid(cfg.with_trace(), n_seeds=1),
                 frozen,
                 lambda: serve.serve("qwen2-0.5b", gen=1),
                 lambda: serve.serve("rwkv6-3b", gen=1),
                 lambda: rwkv6.init_lm(ssm),
                 lambda: rwkv6.init_decode_state(ssm, 1),
                 lambda: transformer.init_lm(lm),
                 lambda: transformer.init_kv_caches(lm, 1, 4),
                 lambda: serve_asa.init_table(4),
                 lambda: loop.ASAServer(loop.ServeConfig(n_slots=4)),
                 lambda: loop.ServeSupervisor(loop.ServeConfig(n_slots=4)),
                 lambda: rl_policy.init_params(prng.PRNGKey(0)),
                 lambda: rl_train.warmed_fleet(rl_train.TrainConfig(), 0),
                 lambda: rl_train.train(rl_train.TrainConfig(iters=1)),
                 lambda: rl_train.evaluate(None),
                 lambda: campaign.CampaignScheduler(
                     QueueSim(CENTERS["uppmax"], seed=0))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # the default mesh is over the CUDA devices: none here
    with pytest.raises(ValueError, match="device"):
        mesh.make_scenarios_mesh()
    g = grid.make_grid(cfg, n_seeds=1, policy_ids=(1,), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        grid.run_grid(g)


# the port's line-for-line copies of stdlib-only reference modules
COPIES = ("runtime/pool.py", "obs/registry.py", "obs/serve_obs.py",
          "serve/chaos.py")


def _body_below_docstring_and_imports(path: Path) -> str:
    """The module's code without its docstring and its top-level imports
    (comments aside: the AST keeps none)."""
    body = ast.parse(path.read_text()).body
    if body and isinstance(body[0], ast.Expr) and \
            isinstance(body[0].value, ast.Constant):
        body = body[1:]
    body = [n for n in body if not isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    return "\n".join(ast.dump(n) for n in body)


@pytest.mark.parametrize("rel", COPIES)
def test_copies_equal_the_reference_below_docstring_and_imports(rel):
    port = _body_below_docstring_and_imports(PORT / rel)
    ref = _body_below_docstring_and_imports(ROOT / "src" / "repro" / rel)
    assert port == ref, f"{rel} drifted from the reference"
    imports = [n for n in _imports(PORT / rel)
               if n.split(".")[0] not in ("__future__",)]
    assert all(n.split(".")[0] == "repro_torch" or n in sys.stdlib_module_names
               or n.split(".")[0] in sys.stdlib_module_names
               for n in imports), imports
