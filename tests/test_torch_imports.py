"""Import guard: no module of `repro_torch`, and not `chip_smoke.py`,
imports JAX or the JAX package `repro` (checked on the source, by AST)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = (sorted(PORT.rglob("*.py")) + sorted((ROOT / "bench_torch").glob("*.py"))
         + [ROOT / "chip_smoke.py"])
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_has_modules():
    names = {p.relative_to(PORT).as_posix() for p in FILES if PORT in p.parents}
    for need in ("core/spice/char_batch.py", "kernels/batched_solve/fused.py",
                 "interop.py", "core/compiler.py", "core/retention.py",
                 "core/power.py", "kernels/batched_solve/kernel.py",
                 "kernels/batched_solve/ref.py",
                 "kernels/gc_array_step/kernel.py",
                 "kernels/gc_array_step/ops.py",
                 "kernels/gc_array_step/ref.py",
                 "kernels/flash_attention/kernel.py",
                 "kernels/flash_attention/ops.py",
                 "kernels/flash_attention/ref.py", "configs/base.py",
                 "configs/llama3_2_1b.py", "models/common.py",
                 "models/attention.py", "models/transformer.py",
                 "models/model.py", "models/moe.py", "models/ssm.py",
                 "models/xlstm.py",
                 "serving/engine.py",
                 "serving/sampling.py", "runtime/telemetry.py",
                 "launch/serve.py", "core/dse.py", "core/dse_batch.py",
                 "core/dse_grad.py", "core/multibank.py",
                 "api/__init__.py", "api/queries.py", "api/results.py",
                 "api/store.py", "api/leases.py", "api/plan.py",
                 "api/executor.py", "api/session.py", "geom/__init__.py",
                 "geom/grid.py", "geom/extract.py", "geom/placer.py",
                 "geom/router.py", "geom/verify.py",
                 "kernels/batched_solve/sparse.py", "optim/__init__.py",
                 "optim/optimizers.py", "optim/dse_opt.py",
                 "launch/roofline.py", "workloads/__init__.py",
                 "workloads/profiler.py", "runtime/__init__.py",
                 "runtime/profile.py", "runtime/governor.py",
                 "runtime/replay.py", "testing/__init__.py",
                 "testing/faults.py", "launch/compile_service.py",
                 "launch/fleet.py", "data/__init__.py", "data/pipeline.py",
                 "optim/schedules.py", "optim/compression.py",
                 "checkpoint/__init__.py", "checkpoint/ckpt.py",
                 "training/__init__.py", "training/loop.py",
                 "launch/steps.py", "launch/train.py", "launch/mesh.py",
                 "launch/sharding.py", "launch/hlo_analysis.py",
                 "launch/dryrun.py", "launch/report.py"):
        assert need in names
    for src in ("fused_newton", "gauss_jordan", "gc_array_step",
                "flash_attention", "flash_attention_tc"):
        assert (PORT / "csrc" / f"{src}.cu").exists()


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT)
                         .as_posix())
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name in _imported(tree):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


def test_training_names_are_ported():
    """No training name of the port raises NotImplementedError: the
    deferred placeholders are gone."""
    src = "\n".join(p.read_text() for p in FILES if PORT in p.parents)
    assert "deferred(" not in src
