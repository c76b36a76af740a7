"""Rules of the port: it imports nothing of JAX or of the JAX package,
its entry points refuse to run quietly on the CPU when no device is
named, and the CPU path never launches (or builds) a CUDA kernel."""
import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode  # noqa: E402
from repro_torch.models.lm import DecoderModel  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference_package(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "repro"), (path, mod)


def test_entry_points_refuse_cpu_fallback_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = reduced_config("gemma-2b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecoderModel(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model, model.init(0))
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--requests", "1"])


def test_unported_configs_and_families_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("mixtral-8x22b")
    from repro_torch.core.config import Family
    moe = get_config("gemma-2b").__class__(
        name="m", family=Family.MOE, num_layers=1, d_model=8, vocab_size=16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(moe, device="cpu")


def test_cpu_path_never_launches_or_builds_a_kernel():
    """A CPU prefill over the flash threshold and a decode tick run the
    plain versions: both launch counts stay 0 and nvcc is never sought."""
    cfg = reduced_config("gemma-2b")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    flash_decode.launches = flash_attention_fwd.launches = 0
    toks = torch.randint(2, cfg.vocab_size, (1, 2100))
    logits, cache = model.prefill(params, {"tokens": toks})
    logits, _ = model.decode_step(params, {"tokens": toks[:, :1]}, cache)
    assert torch.isfinite(logits).all()
    assert flash_decode.launches == 0 and flash_attention_fwd.launches == 0
    assert _build._LIBS == {}


def test_chip_smoke_fails_without_a_card():
    """No card: a nonzero exit code and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
