"""The run path loads neither JAX nor the JAX package, by whole top-level
names (kmc_tpu_torch begins with kmc_tpu), and refuses to report when it
finds one."""
import subprocess
import sys
import types
from pathlib import Path

import pytest

from kmcbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_whole_names(monkeypatch):
    for name in ("kmc_tpu_torch", "kmc_tpu_torch.runner", "jaxtyping",
                 "kmc_tpu2", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    for name in ("kmc_tpu.runner", "jaxlib.xla_client", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == ["flax", "jaxlib", "kmc_tpu"]


RUN_SMALL = """
import sys
sys.path.insert(0, {root!r})
from kmcbench.conftest import small_cell
from kmcbench.harness import forbidden_modules, run_cell
{before}
res = run_cell(small_cell(), 2**34 + 1, 0.3, {traced}, device="cpu")
assert res["correct"], res
print("LOADED", sorted(m.split(".")[0] for m in sys.modules))
print("FORBIDDEN", forbidden_modules())
"""


@pytest.mark.parametrize("traced", [False, True])
def test_run_path_loads_no_jax(traced):
    code = RUN_SMALL.format(root=str(ROOT), before="", traced=traced)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
    assert "'kmc_tpu_torch'" in out.stdout


def test_a_run_that_loaded_jax_reports_nothing():
    before = ("import types; sys.modules['jax'] = "
              "types.ModuleType('jax')")
    code = RUN_SMALL.format(root=str(ROOT), before=before, traced=False)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "loaded modules of JAX or the JAX package: jax" in out.stderr
    assert "LOADED" not in out.stdout
