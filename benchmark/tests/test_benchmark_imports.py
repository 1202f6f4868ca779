"""Nothing the harness runs imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "radegs_tpu"}
HARNESS = ["benchmark.run", "benchmark.jobs", "benchmark.calibrate", "benchmark.check",
           "benchmark.program", "benchmark.roofline", "benchmark.tracing", "benchmark.scene",
           "radegs_torch.train.loop", "radegs_torch.renderer"]


def loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    code = "import importlib\n" + "".join(f"importlib.import_module({m!r})\n" for m in HARNESS)
    code += ("from benchmark import jobs, run\nimport os\n"
             "for f in os.listdir('benchmark/metrics'):\n"
             "    if f.endswith('.py') and not f.startswith('_'):\n"
             "        run.reader(f[:-3])\n"
             "for f in os.listdir(jobs.KIND_DIR) if os.path.isdir(jobs.KIND_DIR) else []:\n"
             "    if f.endswith('.py'):\n"
             "        jobs.kind(f[:-3])\n")
    top = loaded_after(code)
    assert not top & FORBIDDEN
    assert "radegs_torch" in top and "radegs_tpu" not in top


def test_forbidden_names_are_whole_names():
    from benchmark import run

    saved = dict(sys.modules)
    try:
        sys.modules.pop("jax", None)
        assert "jax" not in run.forbidden_modules()
        sys.modules["radegs_tpu_like"] = sys
        assert "radegs_tpu_like" not in run.forbidden_modules()
        sys.modules["jax.numpy"] = sys
        assert run.forbidden_modules() == ["jax"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_reference_imports_nothing_of_the_program():
    top = loaded_after("import benchmark.reference.render, benchmark.reference.train, "
                       "benchmark.reference.scene")
    assert not top & (FORBIDDEN | {"radegs_torch"})
    ref = os.path.join(ROOT, "benchmark", "reference")
    for f in os.listdir(ref):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, f)).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"radegs_torch"}, (f, n)
