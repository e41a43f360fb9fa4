"""What the benchmark loads: after the harness, the reference, the control
and every traffic and metric module are imported, no module of JAX or the
JAX package is loaded (compared by whole top-level name: the port's name
begins with the JAX package's), and the reference imports nothing of the
port."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _loaded_after(imports: str) -> list:
    code = (f"import sys\n{imports}\n"
            "print(__import__('json').dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return json.loads(out.stdout.strip().splitlines()[-1])


def _modules(sub: str) -> list:
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(HERE, sub, "*.py"))
                  if not os.path.basename(p).startswith("__"))


def test_harness_loads_no_jax():
    imports = ["import benchmark.run, benchmark.harness, benchmark.control, benchmark.costs",
               "import benchmark.reference.pipelines"]
    imports += [f"import benchmark.traffic.{m}" for m in _modules("traffic")]
    imports += [f"import benchmark.metrics.{m}" for m in _modules("metrics")]
    # the port itself, as a run loads it: the model, its kernels' wrappers
    imports += ["import videoseal_tpu_torch.models.videoseal"]
    top = _loaded_after("\n".join(imports))
    assert "videoseal_tpu_torch" in top and "torch" in top
    assert not set(top) & {"jax", "jaxlib", "flax", "videoseal_tpu"}


def test_forbidden_modules_by_whole_name(monkeypatch):
    from benchmark import harness
    monkeypatch.setitem(sys.modules, "videoseal_tpu_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxlibrary", object())
    assert "videoseal_tpu_torch_extra" not in harness.forbidden_modules()
    assert "jaxlibrary" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "videoseal_tpu.models", object())
    assert "videoseal_tpu.models" in harness.forbidden_modules()


def test_reference_imports_nothing_of_the_port():
    for path in glob.glob(os.path.join(HERE, "reference", "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("videoseal_tpu_torch", "videoseal_tpu", "jax"), \
                    f"{path} imports {name}"
    top = _loaded_after("import benchmark.reference.pipelines, benchmark.reference.nets")
    assert not set(top) & {"videoseal_tpu_torch", "videoseal_tpu", "jax"}


def test_harness_reads_none_of_the_tpu_records():
    for path in glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True):
        with open(path) as f:
            text = f.read()
        for name in ("BENCH_r0", "MULTICHIP_r0", "BASELINE.", "chip_smoke", "bench.py"):
            assert name not in text or path.endswith("test_bench_imports.py"), (path, name)
