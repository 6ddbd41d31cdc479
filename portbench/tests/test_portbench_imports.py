"""The whole-name check of forbidden modules."""

from __future__ import annotations

import subprocess
import sys

from portbench import harness

from conftest import ROOT


def test_the_port_passes_and_the_reference_package_does_not():
    assert harness.forbidden_modules(["crisperwhisper_tpu_torch",
                                      "crisperwhisper_tpu_torch.x",
                                      "jaxtyping", "flaxen.y"]) == []
    assert harness.forbidden_modules(["crisperwhisper_tpu.ops"]) == \
        ["crisperwhisper_tpu"]
    assert harness.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla",
                                      "flax.linen"]) == ["flax", "jax",
                                                         "jaxlib"]


def test_the_harness_and_the_port_load_none():
    code = ("import portbench.harness, portbench.check, "
            "crisperwhisper_tpu_torch.hub; from portbench import harness; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    import ast
    import os
    from conftest import PORTBENCH
    for root, _, names in os.walk(PORTBENCH):
        for name in names:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                tree = ast.parse(f.read())
            mods = []
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods += [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods.append(node.module)
            assert not harness.forbidden_modules(mods), (name, mods)
