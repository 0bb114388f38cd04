"""The PyTorch port stands alone.

  - importing `paddle_tpu_torch` and its modules loads neither JAX nor
    anything of `paddle_tpu` (checked in a fresh interpreter);
  - no module of the package, nor `chip_smoke.py`, nor the card tests
    (run where JAX is not installed), imports them (AST scan);
  - the entry points run on CUDA unless asked for the CPU: without a card
    they raise rather than drift onto the CPU.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "paddle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import paddle_tpu_torch, paddle_tpu_torch.models, "
        "paddle_tpu_torch.serving, paddle_tpu_torch.kernels.attention, "
        "paddle_tpu_torch.kernels.quantized_matmul, "
        "paddle_tpu_torch.kernels._build, paddle_tpu_torch.observability, "
        "paddle_tpu_torch.serving.trace, "
        "paddle_tpu_torch.kernels.flash_attention, "
        "paddle_tpu_torch.distributed, paddle_tpu_torch.core.numerics, "
        "paddle_tpu_torch.core.tree, paddle_tpu_torch.kernels.rms_norm, "
        "paddle_tpu_torch.serving.spec_decode\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) in \
                ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_no_source_imports_jax_or_the_reference():
    files = sorted(PACKAGE.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernels_cuda.py"]
    assert len(files) > 10
    bad = {str(f.relative_to(ROOT)): name for f in files
           for name in _imports(f) if _forbidden(name)}
    assert not bad


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny():
    from paddle_tpu_torch.models import LlamaArgs

    return LlamaArgs(vocab_size=32, hidden_size=16, intermediate_size=32,
                     num_layers=1, num_heads=2, num_kv_heads=1,
                     rope_theta=10000.0, rms_eps=1e-6)


def test_entry_points_raise_without_cuda_unless_asked_for_cpu(no_cuda):
    from paddle_tpu_torch.models import (Llama, generate, init_params,
                                         params_from_numpy)
    from paddle_tpu_torch.distributed import HybridParallelEngine
    from paddle_tpu_torch.models import (adamw_state_from_numpy,
                                         tree_from_numpy)
    from paddle_tpu_torch.serving import Engine, PagedEngine

    args = _tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(args, device="cuda")
    params = init_params(args, device="cpu")
    model = Llama(args, params)
    tree = {"embedding": params["embedding"].numpy(),
            "layers": {k: v.numpy() for k, v in params["layers"].items()},
            "final_norm": params["final_norm"].numpy(),
            "lm_head": params["lm_head"].numpy()}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(tree, args)
    assert params_from_numpy(tree, args, device="cpu").device.type == "cpu"
    ids = np.ones((1, 3), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(model, ids, max_new_tokens=2)
    assert generate(model, ids, max_new_tokens=2, device="cpu").shape == (1, 5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HybridParallelEngine(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        HybridParallelEngine(args, device="cuda")
    eng = HybridParallelEngine(args, device="cpu")
    params, opt = eng.init_state(0)
    assert {p.device.type for p in (params["embedding"], opt["m"]["lm_head"])} \
        == {"cpu"}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tree_from_numpy(tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        adamw_state_from_numpy({"m": tree, "v": tree, "step": 0})
    for cls in (Engine, PagedEngine):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(model, max_slots=1, max_len=16)
        assert cls(model, max_slots=1, max_len=16, device="cpu").device.type \
            == "cpu"
