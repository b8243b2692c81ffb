"""Guards of the port: it stands apart from the JAX package, and its entry
points run on the card unless the caller asks for the CPU."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import (deepseek_7b, granite_moe_3b, llava_next_mistral_7b,
                                 recurrentgemma_9b, registry, rwkv6_1p6b, whisper_tiny)
from repro_torch.core import calibration
from repro_torch.kernels import dispatch
from repro_torch.kernels.attention import flash, flash_bwd
from repro_torch.kernels.decode import flash_decode as fd
from repro_torch.kernels.rwkv import wkv, wkv_bwd
from repro_torch.launch import train as train_cli
from repro_torch.models import api, cnn
from repro_torch.models.common import tensor_leaves
from repro_torch.serving import kvcache
from repro_torch.serving.continuous import ContinuousServer
from repro_torch.serving.engine import InferenceEngine
from repro_torch.train.loop import train

ROOT = Path(__file__).resolve().parents[1]
PORT_SRC = ROOT / "src" / "repro_torch"
PORT_FILES = (sorted(PORT_SRC.rglob("*.py")) + sorted((ROOT / "tools").glob("*.py"))
              + [ROOT / "chip_smoke.py"])
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_the_reference(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_scan_sees_the_whole_port():
    names = {p.relative_to(PORT_SRC).as_posix() for p in PORT_FILES if PORT_SRC in p.parents}
    for module in ("models/transformer.py", "kernels/dispatch.py", "serving/continuous.py",
                   "launch/serve.py", "configs/registry.py", "models/ssm.py",
                   "kernels/rwkv/wkv.py", "models/cnn.py", "core/calibration.py",
                   "core/function.py", "serving/handler.py", "models/moe.py",
                   "configs/granite_moe_3b.py", "configs/mistral_nemo_12b.py",
                   "models/hybrid.py", "models/encdec.py", "models/vlm.py",
                   "serving/kvcache.py", "serving/quantize.py", "train/optimizer.py",
                   "train/data.py", "train/loop.py", "train/checkpoint.py", "launch/steps.py",
                   "launch/train.py", "kernels/attention/flash_bwd.py",
                   "kernels/rwkv/wkv_bwd.py", "core/resources.py", "core/billing.py",
                   "core/distributed.py", "core/providers.py", "core/container.py",
                   "core/workload.py", "core/faults.py", "core/autoscaler.py",
                   "core/cluster/__init__.py", "core/cluster/events.py",
                   "core/cluster/policies.py", "core/cluster/router.py",
                   "core/cluster/cluster.py", "core/stack.py", "core/metrics.py",
                   "core/sla.py", "core/simulator.py", "core/platform.py",
                   "core/scenarios.py", "core/keepalive.py", "core/advisor.py"):
        assert module in names
    assert ROOT / "tools" / "replay_determinism.py" in PORT_FILES
    assert "torch" in _imported_roots(ROOT / "src" / "repro_torch" / "__init__.py")


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_default_to_the_card():
    cfg = deepseek_7b.SMOKE
    if torch.cuda.is_available():
        assert InferenceEngine(cfg, max_cache=16).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg, max_cache=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousServer(cfg, slots=2, max_seq=16)
    assert InferenceEngine(cfg, max_cache=16, device="cpu").device.type == "cpu"


def test_rwkv_engine_defaults_to_the_card():
    cfg = rwkv6_1p6b.SMOKE
    if torch.cuda.is_available():
        assert InferenceEngine(cfg, max_cache=16).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg, max_cache=16)
    assert InferenceEngine(cfg, max_cache=16, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("cfg", [deepseek_7b.SMOKE, rwkv6_1p6b.SMOKE, granite_moe_3b.SMOKE,
                                 recurrentgemma_9b.SMOKE, whisper_tiny.SMOKE,
                                 llava_next_mistral_7b.SMOKE], ids=lambda c: c.family)
def test_init_cache_defaults_to_the_card(cfg):
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in tensor_leaves(api.init_cache(cfg, 2, 16)))
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_cache(cfg, 2, 16)
    assert all(t.device.type == "cpu"
               for t in tensor_leaves(api.init_cache(cfg, 2, 16, device="cpu")))


def test_train_defaults_to_the_card():
    cfg = deepseek_7b.SMOKE
    if torch.cuda.is_available():
        pytest.skip("a card is present; train() would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        train(cfg, steps=1, batch=2, seq=8, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--arch", "deepseek-7b", "--smoke", "--steps", "1"])
    assert train(cfg, steps=1, batch=2, seq=8, verbose=False, device="cpu").steps == 1


def _grad_inputs():
    t = torch.zeros((1, 8, 2, 32), requires_grad=True)
    u, s0 = torch.zeros((2, 32)), torch.zeros((1, 2, 32, 32))
    valid = torch.ones(8, dtype=torch.bool)
    lse = torch.zeros((1, 2, 8))
    return {"K1 flash_attention": lambda: flash.flash_attention(t, t, t),
            "K2 flash_decode": lambda: fd.flash_decode(t[:, :1], t, t, valid),
            "K3 wkv6": lambda: wkv.wkv6(t, t, t, t, u, s0),
            "K1-bwd": lambda: flash_bwd.flash_attention_bwd(t, t, t, t, t, lse),
            "K3-bwd": lambda: wkv_bwd.wkv6_bwd(t, t, t, t, u, s0, t, s0)}


@pytest.mark.parametrize("name", sorted(_grad_inputs()))
def test_kernel_wrappers_refuse_an_input_that_requires_grad(name):
    """A wrapper called outside its autograd Function would end the graph
    at its ctypes launch and drop the gradient silently: it raises first,
    on any device.  Without grad mode it goes on to its other checks (here:
    the CPU tensors are refused)."""
    call = _grad_inputs()[name]
    with pytest.raises(RuntimeError, match="requires grad"):
        call()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        call()


def test_rwkv_scan_refuses_an_in_place_state_under_autograd():
    r = torch.zeros((1, 4, 2, 16), requires_grad=True)
    state = torch.zeros((1, 2, 16, 16))
    with pytest.raises(ValueError, match="out_state"):
        dispatch.rwkv_scan(r, r, r, r, torch.zeros((2, 16)), state, out_state=state)


def test_paged_pool_defaults_to_the_card():
    cfg = deepseek_7b.SMOKE
    if torch.cuda.is_available():
        assert kvcache.PagedPool(cfg, 4).k.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        kvcache.PagedPool(cfg, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        kvcache.valid_mask(8, 3)
    assert kvcache.PagedPool(cfg, 4, device="cpu").k.device.type == "cpu"


@pytest.mark.parametrize("name", sorted(registry.PAPER_MODELS))
def test_cnn_init_params_defaults_to_the_card(name):
    cfg = registry.get(name).smoke
    if torch.cuda.is_available():
        params = cnn.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        assert params["conv1"].is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        cnn.init_params(cfg, torch.Generator().manual_seed(0))
    assert not cnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")["conv1"].is_cuda


def test_calibration_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        assert calibration.host_fingerprint()["backend"] == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        calibration.measure_model("squeezenet", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        calibration.calibrate(str(tmp_path / "cal.json"), models=["squeezenet"], smoke=True)
    assert not (tmp_path / "cal.json").exists()


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py would run")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        for line in out.stdout.splitlines():
            with pytest.raises(ValueError):
                json.loads(line)
