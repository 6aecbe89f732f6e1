"""What the benchmark runs imports neither JAX nor the JAX package
(top-level names compared whole: ``pcseg_tpu_torch`` begins with
``pcseg_tpu``), nor ``bench.py`` or ``benchmarks/``; the reference imports
nothing of the program."""

import ast
import os
import subprocess
import sys

from portbench.bench import guard, spec

HARNESS = ["portbench.run", "portbench.bench.harness", "portbench.bench.ranks",
           "portbench.bench.spec", "portbench.paths.stream",
           "portbench.paths.frame", "portbench.paths.sharded",
           "portbench.reference.control",
           "pcseg_tpu_torch.models.pipeline",
           "pcseg_tpu_torch.parallel.sharded",
           "pcseg_tpu_torch.parallel.distributed",
           "pcseg_tpu_torch.kernels.build", "pcseg_tpu_torch.native"]


def modules_of(sub):
    base = os.path.join(spec.BENCH_DIR, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py") and "tests" not in d:
                rel = os.path.relpath(os.path.join(d, f), spec.ROOT)
                yield rel[:-3].replace(os.sep, ".").removesuffix(".__init__")


def loaded_by(mods):
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]); "
            "import importlib\n"
            "for m in sys.argv[2:]: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, spec.ROOT, *mods],
                         capture_output=True, text=True, timeout=240,
                         check=True, env=dict(os.environ, JAX_PLATFORMS=""))
    import json
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules({"pcseg_tpu_torch.ops": 1}) == []
    assert guard.forbidden_modules({"pcseg_tpu.ops": 1, "jax": 1,
                                    "jaxlib.xla": 1}) == [
        "jax", "jaxlib", "pcseg_tpu"]


def test_the_harness_loads_no_jax():
    mods = HARNESS + list(modules_of("readers")) + list(modules_of("kernels"))
    top = loaded_by(mods)
    assert "pcseg_tpu_torch" in top
    assert not top & set(guard.FORBIDDEN) | {"bench", "benchmarks"} & top


def test_the_reference_loads_nothing_of_the_program():
    top = loaded_by(list(modules_of("reference")))
    assert not top & {"pcseg_tpu_torch", *guard.FORBIDDEN}


def test_no_source_of_the_benchmark_names_the_jax_package():
    for d, _, files in os.walk(spec.BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    top = n.split(".")[0]
                    assert top not in (*guard.FORBIDDEN, "bench",
                                       "benchmarks"), (f, n)
                    if "reference" in d:
                        assert top != "pcseg_tpu_torch", (f, n)
