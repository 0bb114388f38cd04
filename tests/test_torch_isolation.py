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

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

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
        "paddle_tpu_torch.serving.spec_decode, "
        "paddle_tpu_torch.serving.disagg, paddle_tpu_torch.serving.router, "
        "paddle_tpu_torch.models.gpt, paddle_tpu_torch.models.bert, "
        "paddle_tpu_torch.kernels.tuning, "
        "paddle_tpu_torch.distributed.checkpoint, "
        "paddle_tpu_torch.distributed.checkpoint.chaos, "
        "paddle_tpu_torch.observability.monitor, "
        "paddle_tpu_torch.observability.hardware, "
        "paddle_tpu_torch.observability.telemetry, "
        "paddle_tpu_torch.framework, paddle_tpu_torch.framework.dtypes, "
        "paddle_tpu_torch.framework.device, "
        "paddle_tpu_torch.framework.random, "
        "paddle_tpu_torch.framework.flags, paddle_tpu_torch.core.tensor, "
        "paddle_tpu_torch.core.backward, paddle_tpu_torch.core.ops_patch, "
        "paddle_tpu_torch.core.tensor_methods, paddle_tpu_torch.autograd, "
        "paddle_tpu_torch.ops.creation, paddle_tpu_torch.ops.math, "
        "paddle_tpu_torch.ops.manipulation, paddle_tpu_torch.ops.logic, "
        "paddle_tpu_torch.ops.search, paddle_tpu_torch.ops.linalg, "
        "paddle_tpu_torch.nn.functional.flash_attention, "
        "paddle_tpu_torch.nn.functional, paddle_tpu_torch.ops.extras, "
        "paddle_tpu_torch.ops.legacy_ps, paddle_tpu_torch.linalg, "
        "paddle_tpu_torch.fft, paddle_tpu_torch.framework.io, "
        "paddle_tpu_torch._C_ops, paddle_tpu_torch.core.native, "
        "paddle_tpu_torch.nn.layer.layers, paddle_tpu_torch.nn.layer.common, "
        "paddle_tpu_torch.nn.layer.rnn, paddle_tpu_torch.nn.layer.extras, "
        "paddle_tpu_torch.nn.layer.transformer, "
        "paddle_tpu_torch.nn.initializer, paddle_tpu_torch.nn.utils, "
        "paddle_tpu_torch.optimizer, paddle_tpu_torch.optimizer.lr, "
        "paddle_tpu_torch.amp, paddle_tpu_torch.io, "
        "paddle_tpu_torch.metric, paddle_tpu_torch.hapi, "
        "paddle_tpu_torch.hapi.callbacks, paddle_tpu_torch.vision, "
        "paddle_tpu_torch.vision.models, paddle_tpu_torch.vision.datasets, "
        "paddle_tpu_torch.models.llama, paddle_tpu_torch.distributed.engine, "
        "paddle_tpu_torch.vision.ops, paddle_tpu_torch.vision.transforms, "
        "paddle_tpu_torch.vision.transforms.functional, "
        "paddle_tpu_torch.vision.models.resnet, "
        "paddle_tpu_torch.jit, paddle_tpu_torch.inference, "
        "paddle_tpu_torch.models.unet, "
        "paddle_tpu_torch.vision.models.vit, "
        "paddle_tpu_torch.vision.models.densenet, "
        "paddle_tpu_torch.vision.models.googlenet, "
        "paddle_tpu_torch.vision.models.inceptionv3, "
        "paddle_tpu_torch.vision.models.mobilenetv1, "
        "paddle_tpu_torch.vision.models.mobilenetv2, "
        "paddle_tpu_torch.vision.models.mobilenetv3, "
        "paddle_tpu_torch.vision.models.shufflenetv2, "
        "paddle_tpu_torch.vision.models.squeezenet, "
        "paddle_tpu_torch.vision.models.vgg, "
        "paddle_tpu_torch.vision.models.alexnet\n"
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
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernels_cuda.py",
        ROOT / "tests" / "test_torch_eager_cuda.py",
        ROOT / "tests" / "torch_op_cases.py",
        ROOT / "tests" / "torch_layer_cases.py"]
    for mod in ("framework", "core", "autograd", "ops", "nn", "optimizer",
                "amp", "io", "metric", "hapi", "vision", "layer",
                "initializer", "transforms", "models", "distributed"):
        assert any(f.parent.name == mod or f.parent.parent.name == mod
                   for f in files), mod
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


def test_serving_slice_entry_points_raise_without_cuda(no_cuda):
    """GPT-2, BERT, the disaggregated pair and the router's backends."""
    from paddle_tpu_torch.models import (Bert, BertConfig, Gpt, GPTGenArgs,
                                         Llama, init_params)
    from paddle_tpu_torch.serving import (BertBackend, DisaggServer,
                                          GptEngine)

    gargs = GPTGenArgs(vocab_size=32, hidden_size=16, num_layers=1,
                       num_heads=2, max_position_embeddings=32)
    bcfg = BertConfig(vocab_size=32, hidden_size=16, num_hidden_layers=1,
                      num_attention_heads=2, intermediate_size=32,
                      max_position_embeddings=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Gpt(gargs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Bert(bcfg)
    gpt, bert = Gpt(gargs, device="cpu"), Bert(bcfg, device="cpu")
    assert (gpt.device.type, bert.device.type) == ("cpu", "cpu")
    llama = Llama(_tiny(), init_params(_tiny(), device="cpu"))
    for make in (lambda **kw: GptEngine(gpt, max_slots=1, max_len=16, **kw),
                 lambda **kw: BertBackend(bert, **kw),
                 lambda **kw: DisaggServer(llama, max_slots=1, max_len=16,
                                           **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        assert make(device="cpu") is not None


def test_checkpoint_monitor_and_tuner_entry_points_without_cuda(no_cuda,
                                                                tmp_path):
    """The engine with save_every / resume raises without a card unless
    the CPU is asked for; on the CPU it builds its manager and monitor.
    The tuner never measures without a card, and the monitor reads no
    card's memory or peak on the CPU. The fault injector is the port's own
    copy (no `tools`)."""
    from paddle_tpu_torch.distributed import HybridParallelEngine
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.kernels import tuning
    from paddle_tpu_torch.observability import TrainingMonitor

    args = _tiny()
    for kw in (dict(save_every=2), dict(resume=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            HybridParallelEngine(args, checkpoint=str(tmp_path), **kw)
        eng = HybridParallelEngine(args, checkpoint=str(tmp_path),
                                   device="cpu", **kw)
        assert isinstance(eng.checkpoint_manager, CheckpointManager)
        params, opt = eng.init_state(0)
        assert eng.maybe_resume(params, opt)[2] == 0
    mon = TrainingMonitor(nan_action="none")
    assert mon.record_step(0.1, tokens=8)["hbm_high_water_bytes"] == 0
    assert mon.peak_flops is None
    calls = []
    for device in (None, "cpu"):
        tuning.get_blocks("b8_tile", {"m": 2048}, torch.bfloat16,
                          {"tile_m": 256}, device=device,
                          measure=lambda b: calls.append(b) or 1.0,
                          candidates=[{"tile_m": 128}])
    assert not calls
    assert "tools" not in {name.split(".")[0] for f in
                           (PACKAGE / "distributed" / "checkpoint").glob(
                               "*.py") for name in _imports(f)}


def test_eager_creation_raises_without_cuda_unless_asked_for_cpu(no_cuda,
                                                                 monkeypatch):
    """With no card and no set_device('cpu'), the eager surface creates
    nothing: every creation path raises instead of landing on the CPU;
    an explicit place or set_device('cpu') works."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as device_mod

    monkeypatch.setattr(device_mod, "_current", None)
    for make in (lambda: paddle.to_tensor([1.0]), lambda: paddle.zeros([2]),
                 lambda: paddle.randn([2]), lambda: paddle.arange(3),
                 lambda: paddle.Tensor(np.ones(2)), paddle.get_device,
                 lambda: paddle.set_device("gpu")):
        with pytest.raises(RuntimeError, match="CUDA|device='cpu'"):
            make()
    with pytest.raises(ValueError, match="'gpu'"):
        paddle.set_device("tpu")
    assert paddle.to_tensor([1.0], place="cpu").place.type == "cpu"
    paddle.set_device("cpu")
    assert paddle.zeros([2]).place.type == "cpu"


def test_part_2_entry_points_raise_without_cuda_unless_asked_for_cpu(
        no_cuda, monkeypatch, tmp_path):
    """A place-less `load`, `fft.fftfreq` and the legacy ops that build
    their outputs on the host go to the card like creation does: without
    one they raise; asked for the CPU they run there."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as device_mod

    monkeypatch.setattr(device_mod, "_current", None)
    path = tmp_path / "t.pdparams"
    paddle.save({"w": paddle.to_tensor([1.0], place="cpu")}, str(path))
    for make in (lambda: paddle.load(str(path)),
                 lambda: paddle.fft.fftfreq(4),
                 lambda: paddle.SelectedRows([0], np.ones((1, 2)))):
        with pytest.raises(RuntimeError, match="CUDA|device='cpu'"):
            make()
    paddle.set_device("cpu")
    assert paddle.load(str(path))["w"].place.type == "cpu"
    assert paddle.fft.fftfreq(4).place.type == "cpu"


def test_layer_and_optimizer_creation_raise_without_cuda_unless_cpu(
        no_cuda, monkeypatch):
    """A layer's parameters, an initializer's draw, a DataLoader's batches
    and the layer-built Llama are created on the creation place: without
    a card and without set_device('cpu') they raise; asked for the CPU
    they land there, and the optimizer keeps its state beside them."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as device_mod
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    monkeypatch.setattr(device_mod, "_current", None)
    tiny = LlamaConfig.tiny(num_hidden_layers=1)
    ds = paddle.io.TensorDataset([np.ones((4, 2), np.float32)])
    for make in (lambda: paddle.nn.Linear(2, 3),
                 lambda: paddle.nn.BatchNorm1D(3),
                 lambda: paddle.nn.initializer.XavierNormal()([2, 3],
                                                            "float32"),
                 lambda: paddle.vision.models.LeNet(),
                 lambda: LlamaForCausalLM(tiny),
                 lambda: next(iter(paddle.io.DataLoader(ds, batch_size=2)))):
        with pytest.raises(RuntimeError, match="CUDA|device='cpu'"):
            make()
    paddle.set_device("cpu")
    lin = paddle.nn.Linear(2, 3)
    opt = paddle.optimizer.AdamW(0.1, parameters=lin.parameters())
    lin(paddle.ones([1, 2])).sum().backward()
    opt.step()
    assert {p.place.type for p in lin.parameters()} == {"cpu"}
    assert {v.device.type for v in opt._accumulators.values()} == {"cpu"}
    with pytest.raises(RuntimeError, match="CUDA"):
        lin.to(device="gpu")


def test_engine_and_model_creation_raise_without_cuda_unless_cpu(
        no_cuda, monkeypatch):
    """GPT, BERT and the vision zoo are created on the creation place, and
    the Engine runs where the model's parameters are: without a card and
    without set_device('cpu') creating them raises; asked for the CPU the
    Engine trains there."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import Engine
    from paddle_tpu_torch.framework import device as device_mod
    from paddle_tpu_torch.models import bert_tiny, gpt_tiny

    monkeypatch.setattr(device_mod, "_current", None)
    for make in (lambda: gpt_tiny(num_hidden_layers=1),
                 lambda: bert_tiny(num_hidden_layers=1),
                 lambda: paddle.vision.models.resnet18(num_classes=2),
                 lambda: paddle.vision.models.vit_tiny(depth=1)):
        with pytest.raises(RuntimeError, match="CUDA|device='cpu'"):
            make()
    paddle.set_device("cpu")
    model = paddle.nn.Linear(3, 2)
    eng = Engine(model, loss=paddle.nn.CrossEntropyLoss(),
                 optimizer=paddle.optimizer.SGD(
                     0.1, parameters=model.parameters()))
    loss = eng.train_batch([np.ones((2, 3), np.float32)],
                           [np.zeros((2,), np.int64)])
    assert loss.place.type == "cpu" and eng.device.type == "cpu"
    assert {t.device.type for t in eng.state[0].values()} == {"cpu"}
