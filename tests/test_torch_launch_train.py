"""The port's training launcher, `python -m repro_torch.launch.train`, in a
child process on the CPU: a 6-step run, then a second on a ``--data 2
--model 2`` mesh (every position on the CPU) that resumes from its
checkpoint to step 8; a ``--data`` that does not divide the batch is
refused before anything is made; the child never imports `jax` or
`repro`."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import _torch_helpers  # noqa: E402,F401  (one torch thread a worker)

from repro_torch.launch import parse_overrides  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARGS = ["--arch", "olmo-1b", "--set", "n_layers=2", "d_model=128",
        "vocab_size=512", "--device", "cpu"]
# runs the launcher as __main__, then prints the modules it imported
CHILD = ("import runpy, sys\n"
         "sys.argv = ['train'] + sys.argv[1:]\n"
         "try:\n"
         "    runpy.run_module('repro_torch.launch.train', "
         "run_name='__main__')\n"
         "finally:\n"
         "    print('MODULES', sorted(m for m in sys.modules if m.split('.')"
         "[0] in ('jax', 'jaxlib', 'repro')))\n")


def _launch(*args):
    # one torch thread, as the test process runs (tests/_torch_helpers.py)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", CHILD, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_launcher_runs_resumes_and_refuses_model_parallel(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = _launch(*ARGS, "--steps", "6", "--ckpt-dir", ckpt)
    assert first.returncode == 0, first.stderr
    assert "[train] olmo-1b: step 6 loss " in first.stdout
    assert "resumed" not in first.stdout
    assert "MODULES []" in first.stdout
    second = _launch(*ARGS, "--steps", "8", "--ckpt-dir", ckpt, "--data",
                     "2", "--model", "2")
    assert second.returncode == 0, second.stderr
    assert "[loop] resumed from step 6" in second.stdout
    assert "[train] olmo-1b: step 8 loss " in second.stdout
    assert "MODULES []" in second.stdout
    assert sorted(os.listdir(ckpt)) == ["step-6", "step-8"]
    refused = _launch(*ARGS, "--steps", "2", "--data", "3", "--ckpt-dir",
                      str(tmp_path / "refused"))
    assert refused.returncode != 0
    assert "a batch of 8 rows does not split over 3 data replicas" in \
        refused.stderr
    assert not (tmp_path / "refused").exists()


def test_train_function_and_overrides(tmp_path):
    assert parse_overrides(["n_layers=2", "norm=rmsnorm", "window=8.5"]) == {
        "n_layers": 2, "norm": "rmsnorm", "window": 8.5}
    with pytest.raises(SystemExit):
        parse_overrides(["n_layers"])
    params, opt_state, out = train(
        "gpt2-large", steps=3, batch=2, seq=16, ckpt_dir=str(tmp_path),
        overrides=parse_overrides(["n_layers=1", "d_model=32", "n_heads=2",
                                   "n_kv_heads=2", "d_ff=64",
                                   "vocab_size=64"]),
        device="cpu", log=lambda *a: None)
    assert out["final_step"] == 3 and int(opt_state["step"]) == 3
    assert params["blocks"][0]["attn"]["wq"].shape == (32, 2, 16)
    with pytest.raises(ValueError, match="does not split over 3 data"):
        train("gpt2-large", data=3, device="cpu")
