"""The port stands alone: no module of ``mpi_pytorch_tpu_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, asking for CUDA where
there is none raises instead of carrying on on the CPU, and the kernel
modules import without ``nvcc``. Also: the host-side image math is the JAX
package's, bit for bit."""

import ast
import os
import pathlib

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mpi_pytorch_tpu")


def _port_sources():
    files = sorted((REPO / "mpi_pytorch_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    assert path.exists(), path
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_cuda_without_a_card_raises(monkeypatch):
    from mpi_pytorch_tpu_torch import Config
    from mpi_pytorch_tpu_torch.hardware import resolve_device
    from mpi_pytorch_tpu_torch.serve import InferenceServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("MPT_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device()  # the default is the card
    with pytest.raises(RuntimeError, match="is_available"):
        InferenceServer(Config(num_classes=10, width=32, height=32))
    monkeypatch.setenv("MPT_PLATFORM", "cpu")
    assert resolve_device().type == "cpu"
    with pytest.raises(ValueError, match="cuda or cpu"):
        resolve_device("meta")


def test_kernel_modules_import_without_nvcc():
    """In a fresh interpreter with no CUDA toolkit in reach, every kernel
    module imports and builds nothing; asking for the library then fails
    loudly, naming nvcc."""
    import subprocess
    import sys

    code = (
        "import mpi_pytorch_tpu_torch.ops.fused_stem, mpi_pytorch_tpu_torch.ops.fused_head_ce\n"
        "import mpi_pytorch_tpu_torch.ops.flash_attention, mpi_pytorch_tpu_torch.ops.fused_attention_small\n"
        "import mpi_pytorch_tpu_torch.ops.quantize\n"
        "import mpi_pytorch_tpu_torch.models.vit\n"
        "import mpi_pytorch_tpu_torch.serve\n"
        "from mpi_pytorch_tpu_torch.ops import _build\n"
        "assert _build._lib is None\n"
        "try:\n"
        "    _build.load_library()\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc not found' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('built without nvcc')\n"
        "print(sorted(p.name for p in _build._sources()))\n"
    )
    env = {"PATH": "", "CUDA_HOME": "/nonexistent", "PYTHONPATH": str(REPO)}
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert (
        "['flash_attention.cu', 'fused_attention_small.cu', 'fused_head_ce_bwd.cu', "
        "'fused_stem.cu', 'head_predict_tc.cu', 'runtime.cu']"
        in out.stdout
    )


def test_env_flag_matches_jax_package(monkeypatch):
    from mpi_pytorch_tpu.utils.env import env_flag as jax_flag
    from mpi_pytorch_tpu_torch.utils.env import env_flag

    for raw in ("", "0", "false", "No", "OFF", "1", "true", "yes", "anything"):
        monkeypatch.setenv("MPT_TEST_FLAG", raw)
        assert env_flag("MPT_TEST_FLAG") == jax_flag("MPT_TEST_FLAG"), raw
    monkeypatch.delenv("MPT_TEST_FLAG")
    assert env_flag("MPT_TEST_FLAG", True) is True


def test_host_image_math_is_bit_identical(tmp_path):
    from PIL import Image

    from mpi_pytorch_tpu.data import pipeline as jax_pipe
    from mpi_pytorch_tpu_torch.data import pipeline as port_pipe

    for seed in (0, 17):
        a = jax_pipe.synthetic_image(seed, (24, 40))
        b = port_pipe.synthetic_image(seed, (24, 40))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jax_pipe.normalize_image(a), port_pipe.normalize_image(b))
    px = np.random.default_rng(1).integers(0, 256, size=(50, 70, 3)).astype(np.uint8)
    path = os.fspath(tmp_path / "x.png")
    Image.fromarray(px).save(path)
    np.testing.assert_array_equal(
        jax_pipe.decode_image(path, (32, 48)), port_pipe.decode_image(path, (32, 48))
    )
