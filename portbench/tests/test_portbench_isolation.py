"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference and the form modules import nothing of the port."""

import ast
import subprocess
import sys
import textwrap

from portbench.tests.helpers import BENCH, REPO

PORT = "gat_pytorch_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "gat_pytorch_tpu")


def imported(path):
    """Top-level and portbench module names that `path` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def module_file(name):
    rel = name.split(".")[1:]
    for cand in (BENCH.joinpath(*rel).with_suffix(".py"),
                 BENCH.joinpath(*rel, "__init__.py")):
        if cand.exists():
            return cand
    return None


def test_reference_imports_nothing_of_the_port():
    """The reference, and the form modules it takes the weights' layout
    from, with all they import of the benchmark."""
    todo = (list((BENCH / "reference").glob("*.py"))
            + list((BENCH / "forms").glob("*.py")))
    seen, tops = set(), set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in imported(path):
            tops.add(name.split(".")[0])
            if name.startswith("portbench."):
                found = module_file(name)
                if found is not None:
                    todo.append(found)
    assert PORT not in tops
    assert not tops & set(BANNED)


def run(code):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)


def test_a_run_loads_no_jax(tmp_path):
    out = run(f"""
        import sys, time, torch
        sys.path.insert(0, {str(REPO)!r})
        from pathlib import Path
        from portbench import harness, spec
        from portbench.tests.helpers import small_root
        cell = spec.load_cell("arxiv-full-v5",
                              data_root=small_root(Path({str(tmp_path)!r})))
        res = harness.run_cell(cell, 3, 0.2, False, torch.device("cpu"),
                               time.perf_counter())
        assert res["correct"], res
        print("FOUND", harness.forbidden_modules())
        print("PORT", "{PORT}" in sys.modules)
        """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
    assert "PORT True" in out.stdout


def test_the_check_compares_whole_top_level_names():
    out = run(f"""
        import sys, types
        sys.path.insert(0, {str(REPO)!r})
        from portbench import harness
        for name in ("gat_pytorch_tpu_torch.models", "jaxtyping"):
            sys.modules[name] = types.ModuleType(name)
        print(harness.forbidden_modules())
        sys.modules["gat_pytorch_tpu.ops"] = types.ModuleType("x")
        sys.modules["jax.numpy"] = types.ModuleType("y")
        print(harness.forbidden_modules())
        """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[:2] == [
        "[]", "['gat_pytorch_tpu.ops', 'jax.numpy']"]
