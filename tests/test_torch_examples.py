"""The twins of the examples (``examples_torch/``) against the reference's
(``examples/``): one twin per script and one JSON spec per YAML spec, and each
twin's source equal to the reference's with the imports renamed, apart from
the lines pinned here.  The other ``test_torch_examples_*.py`` files run them
(stdout, specs, the device examples) and import their helpers from here."""
import contextlib
import difflib
import importlib.util
import io
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REF_DIR, TWIN_DIR = ROOT / "examples", ROOT / "examples_torch"
EXPECTED_DIR = TWIN_DIR / "expected"
EXAMPLES = sorted(p.stem for p in REF_DIR.glob("*.py"))
SPECS = sorted(p.stem for p in (REF_DIR / "specs").glob("*.yaml"))

# The mechanical renaming: imports, and the paths and module the docstrings
# name (a script's own path, a YAML spec's JSON twin, ``python -m``).
RENAMES = (
    (re.compile(r"^(from|import) repro(?=[. ])", re.M), r"\1 repro_torch"),
    (re.compile(r"python examples/"), "python examples_torch/"),
    (re.compile(r"examples/specs/(\w+)\.yaml"), r"examples_torch/specs/\1.json"),
    (re.compile(r"python -m repro run"), "python -m repro_torch run"),
)

# Every line where a twin differs from its renamed reference, as
# (reference lines, twin lines) in the order of the diff.
PINNED = {
    "calibration_study": (
        ["   default — swap in the real Pallas kernels with --oracle pallas on an",
         "   accelerator) and print the fitted / analytical / vidur-proxy error",
         "   table on the held-out heterogeneous grid.",
         '    ap.add_argument("--out", default="artifacts/calib")',
         "                    n_train=n_train, n_eval=n_eval, out_root=args.out)",
         "    analytical = run(base)",
         '                               "opmodel.calibration": args.out}))'],
        ["   default — swap in the real CUDA kernels with --oracle kernels on the",
         "   card) and print the fitted / analytical / vidur-proxy error",
         "   table on the held-out heterogeneous grid.  The fit keeps calibrate's",
         "   default hardware, A800-SXM4-80G, so --oracle kernels labels the card's",
         "   times as an A800's.",
         "        [--oracle kernels] [--device cuda|cpu]",
         '    ap.add_argument("--out", default="artifacts/calib_torch")',
         '    ap.add_argument("--device", default="cuda",',
         '                    help="where the oracle and the runs go; nothing steps down")',
         "                    n_train=n_train, n_eval=n_eval, out_root=args.out,",
         "                    device=args.device)",
         "    analytical = run(base, device=args.device)",
         '                               "opmodel.calibration": args.out}),',
         "                 device=args.device)"]),
    "fault_tolerance_study": (
        ["be three YAML files run by `python -m repro_torch run`."],
        ["be three JSON specs run by `python -m repro_torch run`."]),
    "quickstart": (
        ["read the typed `Report`.  The same specs serialize to YAML — see"],
        ["read the typed `Report`.  The same specs serialize to JSON — see"]),
    "serve_real_model": (
        ["    PYTHONPATH=src python examples_torch/serve_real_model.py",
         "def main():",
         "              calibrate=False)",
         '    print("real MiniEngine (JAX, CPU):")',
         '    print("Frontier simulation (CPU-calibrated hardware profile):")'],
        ["    PYTHONPATH=src python examples_torch/serve_real_model.py [--device cpu]",
         "import argparse", "", "import torch", "",
         "def main(argv=None):",
         "    ap = argparse.ArgumentParser()",
         '    ap.add_argument("--device", default="cuda",',
         '                    help="cuda (default) or cpu; nothing steps down")',
         "    a = ap.parse_args(argv)",
         "              calibrate=False, device=a.device)",
         '    where = (torch.cuda.get_device_name(a.device)',
         '             if torch.device(a.device).type == "cuda" else "CPU")',
         '    print(f"real MiniEngine (PyTorch, {where}):")',
         '    print(f"Frontier simulation ({where}-calibrated hardware profile):")']),
    "trace_study": (
        ['SPEC = os.path.join(HERE, "specs", "trace.yaml")'],
        ['SPEC = os.path.join(HERE, "specs", "trace.json")']),
    "train_lm": (
        ["checkpoints (restart-safe).  On this CPU container use --steps to taste;",
         "the same code path jit-lowers on the production meshes (launch/dryrun.py).",
         '    ap.add_argument("--ckpt-dir", default="artifacts/ckpt_100m")',
         "              resume=True, log_every=10)"],
        ["checkpoints (restart-safe).  Runs on the card (--device cpu to taste);",
         "the same code path is costed on the production meshes (launch/dryrun.py).",
         '    ap.add_argument("--ckpt-dir", default="artifacts/ckpt_100m_torch")',
         '    ap.add_argument("--device", default="cuda",',
         '                    help="cuda (default) or cpu; nothing steps down")',
         "              resume=True, log_every=10, device=a.device)"]),
}


def renamed(text: str) -> str:
    for pattern, repl in RENAMES:
        text = pattern.sub(repl, text)
    return text


def differing_lines(name: str) -> tuple:
    ref = renamed((REF_DIR / f"{name}.py").read_text()).splitlines()
    twin = (TWIN_DIR / f"{name}.py").read_text().splitlines()
    diff = [line for line in difflib.unified_diff(ref, twin, lineterm="", n=0)
            if line[:1] in "+-" and not line.startswith(("+++", "---"))]
    return ([line[1:] for line in diff if line[0] == "-"],
            [line[1:] for line in diff if line[0] == "+"])


def test_every_example_and_spec_has_a_twin():
    assert len(EXAMPLES) == 13 and len(SPECS) == 9
    assert sorted(p.stem for p in TWIN_DIR.glob("*.py")) == EXAMPLES
    assert sorted(p.stem for p in (TWIN_DIR / "specs").glob("*.json")) == SPECS


@pytest.mark.parametrize("name", EXAMPLES)
def test_twin_differs_from_the_reference_only_where_pinned(name):
    assert differing_lines(name) == PINNED.get(name, ([], []))


# ------------------------------------------------------ helpers for the rest --
def chip_smoke():
    """The card's script (its examples lists, the wall-clock mask and
    ``stable_view``); importing it needs no card."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def load(path: Path):
    """Import an example script by path under a module name of its own."""
    spec = importlib.util.spec_from_file_location(
        f"{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stdout_of(path: Path, argv, cwd: Path, monkeypatch) -> str:
    """``main()`` of an example run in ``cwd`` with ``argv`` as its command
    line, its stdout masked; trace_study writes under ``cwd``."""
    mod = load(path)
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    if hasattr(mod, "OUT"):
        monkeypatch.setattr(mod, "OUT", str(cwd / "artifacts"))
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        mod.main()
    return chip_smoke().mask_wall_clock(text.getvalue())
