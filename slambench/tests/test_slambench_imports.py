"""What the run and the reference load: no JAX and no JAX package in the
run's process, nothing of the program in the reference's. Top-level
module names are compared whole: ``vslam_tpu_torch`` is not
``vslam_tpu``."""
import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REF = os.path.join(ROOT, "slambench", "reference")

# everything a run imports: the harness, the program it drives, the
# reference, the traffic generators, the yardstick and every reader
RUN_IMPORTS = """
import json, sys
import slambench.run as r
import vslam_tpu_torch.config, vslam_tpu_torch.pipeline.slam
import slambench.reference.check, slambench.traffic.corridor
import slambench.traffic.handheld, slambench.lib.trace, slambench.lib.ate
import slambench.lib.device, slambench.lib.roofline
man = r.manifest()
for m in man["end_to_end"] + man["per_layer"]:
    r.reader(m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REF_IMPORTS = """
import json, pkgutil, importlib, sys
import slambench.reference as ref
for m in pkgutil.walk_packages(ref.__path__, "slambench.reference."):
    importlib.import_module(m.name)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str):
    import json
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    tops = _top_level(RUN_IMPORTS)
    assert "vslam_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "vslam_tpu"}


def test_reference_loads_nothing_of_the_program():
    tops = _top_level(REF_IMPORTS)
    assert not tops & {"vslam_tpu_torch", "vslam_tpu", "jax", "jaxlib",
                       "flax"}


def test_reference_sources_import_nothing_of_the_program():
    for dirpath, _, files in os.walk(REF):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module]
                else:
                    continue
                for m in mods:
                    assert m.split(".")[0] not in (
                        "vslam_tpu_torch", "vslam_tpu", "jax", "jaxlib",
                        "flax"), (name, m)


def test_forbidden_modules_compares_whole_names():
    from slambench import run
    sys.modules.setdefault("vslam_tpu_torch_fake_probe", sys)
    try:
        assert "vslam_tpu_torch_fake_probe" not in run.forbidden_modules()
    finally:
        del sys.modules["vslam_tpu_torch_fake_probe"]
