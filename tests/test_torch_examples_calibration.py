"""``examples_torch/specs/calibration.json``, the spec priced by fitted
operator models, through both packages: a small ``kernelsim`` fit at
qwen2-7b's geometry made by the port into ``tmp_path``, and both specs'
``opmodel.calibration`` pointed at it alike.  The refined run prices its
dense GEMMs on the virtual kernels, about 30 s a package on the CPU, so the
reference runs through its CLI in a process of its own meanwhile, and this
test has a file of its own."""
import json
import os
import subprocess
import sys

from repro_torch.api import SimSpec, run
from repro_torch.calib import calibrate
from test_torch_examples import REF_DIR, ROOT, TWIN_DIR, chip_smoke


def test_calibrated_spec_runs_to_the_reference_report(tmp_path):
    fit = str(tmp_path / "calib")
    calibrate(model="qwen2-7b", oracle="kernelsim", n_train=60, n_eval=20,
              out_root=fit, device="cpu")
    with open(TWIN_DIR / "specs" / "calibration.json") as f:
        spec = json.load(f)
    assert spec["opmodel"] == {"name": "refined", "calibration": "artifacts/calib_torch"}
    spec["opmodel"]["calibration"] = fit
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-m", "repro", "run",
         str(REF_DIR / "specs" / "calibration.yaml"), "-o", str(tmp_path),
         "--set", f"opmodel.calibration={fit}"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        got = json.loads(run(SimSpec.from_dict(spec), device="cpu").to_json())
    finally:
        out, _ = ref.communicate(timeout=300)
    assert ref.returncode == 0, out
    with open(tmp_path / f"{spec['name']}.report.json") as f:
        want = json.load(f)
    assert got["all_complete"] and got["summary"]["n_completed"] == 150
    assert chip_smoke().stable_view(got) == chip_smoke().stable_view(want)
