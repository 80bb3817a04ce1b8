"""The PyTorch port stands alone: no JAX and no cmix_tpu import anywhere in
cmix_tpu_torch, chip_smoke.py or the goldens' reader it imports
(tests/golden_cases.py), which imports no torch either."""

import os
import pkgutil
import re
import subprocess
import sys

import cmix_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|cmix_tpu)(\b|\.)",
                     re.M)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        cmix_tpu_torch.__path__, "cmix_tpu_torch."))


def test_every_module_imports_with_jax_and_cmix_tpu_blocked():
    mods = _port_modules()
    assert {"cmix_tpu_torch.engine", "cmix_tpu_torch.mixer.ilstm",
            "cmix_tpu_torch.utils.intmath", "cmix_tpu_torch.utils.checkpoint",
            "cmix_tpu_torch.preprocess.jpeg",
            "cmix_tpu_torch.utils.profiling",
            "cmix_tpu_torch.parallel.distributed",
            "cmix_tpu_torch.parallel.mesh", "cmix_tpu_torch.parallel.dryrun",
            "cmix_tpu_torch.preprocess.enwik9",
            "cmix_tpu_torch.tools.make_dict",
            "cmix_tpu_torch.tools.core_words",
            "cmix_tpu_torch.bench"} <= set(mods) and len(mods) > 15
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'jax.numpy', 'cmix_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import chip_smoke\n"
        "assert 'torch' not in sys.modules\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cmix_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_no_jax_or_cmix_tpu_import_in_sources():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tests", "golden_cases.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "cmix_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    assert len(files) > 15
    for name in ("csrc/dmc_counts.cu", "csrc/dmc_walk.cuh", "mixer/ilstm.py",
                 "utils/intmath.py", "convert.py", "preprocess/jpeg.py",
                 "preprocess/media.py", "preprocess/wrt.py",
                 "utils/checkpoint.py", "utils/profiling.py",
                 "parallel/distributed.py", "parallel/mesh.py",
                 "parallel/dryrun.py", "preprocess/enwik9.py",
                 "tools/make_dict.py", "tools/core_words.py"):
        assert os.path.join(ROOT, "cmix_tpu_torch", name) in files
    hits = []
    for path in files:
        with open(path) as f:
            hits += [(path, m.group(0)) for m in _IMPORT.finditer(f.read())]
    assert not hits, hits
