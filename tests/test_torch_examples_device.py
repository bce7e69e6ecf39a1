"""The examples that run the model stack (``serve_real_model``,
``train_lm``) and ``calibration_study --oracle kernels``: on the CPU when
asked for it, and on the card by default, raising where there is none
(nothing steps down to the CPU)."""
import math
import re

import pytest
import torch

from test_torch_examples import TWIN_DIR, stdout_of


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, torch's default of
    a thread per core oversubscribes the host, and the 54 training steps
    below took 117 s in place of 2."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serve_real_model_on_the_cpu(tmp_path, monkeypatch):
    out = stdout_of(TWIN_DIR / "serve_real_model.py", ["--device", "cpu"],
                    tmp_path, monkeypatch)
    lines = out.splitlines()
    assert len(lines) == 5
    assert lines[0] == "real MiniEngine (PyTorch, CPU):"
    assert lines[2] == "Frontier simulation (CPU-calibrated hardware profile):"
    for line in (lines[1], lines[3]):
        numbers = [float(x) for x in re.findall(r"\d+\.\d+", line)]
        assert len(numbers) == 3
        assert all(math.isfinite(x) and x > 0 for x in numbers), line
    err = float(re.fullmatch(r"relative error: (\S+)%", lines[4]).group(1))
    assert math.isfinite(err)


def test_train_lm_resumes_on_the_cpu(tmp_path, monkeypatch):
    """ckpt_every is the example's 50, so the first run takes 50 steps."""
    argv = ["--device", "cpu", "--size", "smoke", "--ckpt-dir", "ckpt"]
    first = stdout_of(TWIN_DIR / "train_lm.py", argv + ["--steps", "50"],
                      tmp_path, monkeypatch)
    assert "resumed from step" not in first
    assert (tmp_path / "ckpt" / "step_00000050").is_dir()
    second = stdout_of(TWIN_DIR / "train_lm.py", argv + ["--steps", "4"],
                       tmp_path, monkeypatch)
    assert "resumed from step 50" in second
    losses = [float(x) for x in re.findall(r"loss (\d+\.\d+)", first + second)]
    assert losses and all(math.isfinite(x) for x in losses)


@pytest.mark.parametrize("name,argv", [
    ("serve_real_model", []),
    ("train_lm", ["--size", "smoke", "--steps", "1", "--ckpt-dir", "ckpt"]),
    ("calibration_study", ["--smoke", "--oracle", "kernels"]),
], ids=["serve_real_model", "train_lm", "calibration_study"])
def test_without_a_card_the_default_device_raises(name, argv, tmp_path,
                                                  monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this holds where there is none")
    with pytest.raises(RuntimeError, match="CUDA device"):
        stdout_of(TWIN_DIR / f"{name}.py", argv, tmp_path, monkeypatch)
