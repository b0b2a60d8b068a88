"""The port's rules: it never imports JAX or the reference package, and its
entry points run on the card unless the caller asks for the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m == "repro" or m.startswith(("repro.", "jax", "jaxlib"))))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_without_jax_or_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 43, out.stdout


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule is moot")


def test_entry_points_raise_without_a_card():
    _no_card()
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main
    from repro_torch.models import Model
    from repro_torch.serve import GenerationEngine
    cfg = get_config("gpt2-large").replace(n_layers=1, d_model=64,
                                           vocab_size=64, n_heads=4,
                                           n_kv_heads=4, d_ff=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine(cfg, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "gpt2-large", "--continuous"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "gpt2-large"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "gpt2-large", "--mode", "raceit_q8",
              "--staged-attention"])
    from repro_torch.ckpt import load_reference_checkpoint, params_from_numpy
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"blocks": {}}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_reference_checkpoint("no-such-checkpoint", cfg)


def test_cpu_request_runs_the_plain_path():
    from repro_torch import resolve_device
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_without_a_card():
    """The chip check exits non-zero and prints no result line here."""
    _no_card()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
