"""The PyTorch port imports no JAX and nothing of the JAX package
(crisperwhisper_tpu), directly or through what it imports, and
chip_smoke.py names no module of the repo but the port."""

import ast
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import crisperwhisper_tpu_torch
import crisperwhisper_tpu_torch.hub
import crisperwhisper_tpu_torch.cli
import crisperwhisper_tpu_torch.pipeline.asr
import crisperwhisper_tpu_torch.ops.fused_attention
import crisperwhisper_tpu_torch.ops.align_prep
import crisperwhisper_tpu_torch.ops.dtw
import crisperwhisper_tpu_torch.ops.alignment
import crisperwhisper_tpu_torch.ops.decode_step
import crisperwhisper_tpu_torch.ops.ring_write
import crisperwhisper_tpu_torch.ops.decode_attention
import crisperwhisper_tpu_torch.audio.fused_mel
import crisperwhisper_tpu_torch.probe
import crisperwhisper_tpu_torch.decoding.longform
import crisperwhisper_tpu_torch.decoding.assisted
import crisperwhisper_tpu_torch.tokenizer
import crisperwhisper_tpu_torch.pipeline.pauses
import crisperwhisper_tpu_torch.config
import crisperwhisper_tpu_torch.testing
import crisperwhisper_tpu_torch.serving
import crisperwhisper_tpu_torch.serving.batcher
import crisperwhisper_tpu_torch.serving.live
import crisperwhisper_tpu_torch.utils.tracing
import crisperwhisper_tpu_torch.utils.evaluation
import crisperwhisper_tpu_torch.tokenizer.normalizers
import crisperwhisper_tpu_torch.tokenizer.number_normalizer
import crisperwhisper_tpu_torch.app
import crisperwhisper_tpu_torch.audio
import crisperwhisper_tpu_torch.decoding
import crisperwhisper_tpu_torch.models
import crisperwhisper_tpu_torch.ops
import crisperwhisper_tpu_torch.utils.checkpoint
import crisperwhisper_tpu_torch.tokenizer.synthetic
import crisperwhisper_tpu_torch.decoding.generate
import crisperwhisper_tpu_torch.models.quantize
import crisperwhisper_tpu_torch.parallel
import crisperwhisper_tpu_torch.parallel.mesh
import crisperwhisper_tpu_torch.parallel.multihost
import crisperwhisper_tpu_torch.parallel.dryrun
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "crisperwhisper_tpu"))
print(",".join(loaded))
"""


@pytest.mark.parametrize("extra", ["", "import crisperwhisper_tpu_torch.native_bindings\n"])
def test_port_imports_no_jax(extra):
    """Neither jax nor crisperwhisper_tpu (or a module under either) is
    in sys.modules after importing the port's modules."""
    env = {**os.environ, "PYTHONPATH": _REPO}
    proc = subprocess.run([sys.executable, "-c", extra + _PROBE],
                          capture_output=True, text=True, env=env,
                          cwd=_REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", \
        f"modules loaded: {proc.stdout.strip()}"


def _imported_roots(path: str) -> set[str]:
    """The top-level names of every absolute import in a source file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_file_imports_the_jax_package():
    """A static scan: no file of the port (nor chip_smoke.py) has an
    import statement naming crisperwhisper_tpu or jax, at any depth."""
    files = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(_REPO,
                                               "crisperwhisper_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    bad = {os.path.relpath(f, _REPO): sorted(
        _imported_roots(f) & {"crisperwhisper_tpu", "jax", "jaxlib"})
        for f in files}
    assert not {f: r for f, r in bad.items() if r}


def test_chip_smoke_imports_only_the_port():
    """Every import in chip_smoke.py is the standard library, numpy,
    scipy, torch or crisperwhisper_tpu_torch."""
    with open(os.path.join(_REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "relative import"
            roots.add(node.module.split(".")[0])
    third_party = roots - set(sys.stdlib_module_names)
    assert "crisperwhisper_tpu_torch" in third_party
    assert third_party <= {"numpy", "scipy", "torch",
                           "crisperwhisper_tpu_torch"}, third_party
