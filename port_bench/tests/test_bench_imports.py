"""Nothing the benchmark or its reference imports is JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""
import ast
import glob
import os
import subprocess
import sys

from conftest import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "terrain_diffusion_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", f"import sys; sys.path[:0] = "
                          f"[{BENCH_DIR!r}, {ROOT!r}]\n{code}\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_imports_neither_jax_nor_either_package():
    loaded = _loaded("import reference.world, reference.unet")
    assert not loaded & FORBIDDEN
    assert "terrain_diffusion_tpu_torch" not in loaded
    for path in glob.glob(os.path.join(BENCH_DIR, "reference", "*.py")):
        tree = ast.parse(open(path, encoding="utf-8").read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            assert not {n.split(".")[0] for n in names} & (FORBIDDEN | {
                "terrain_diffusion_tpu_torch", "harness"}), (path, names)


def test_the_harness_and_the_port_it_runs_load_no_jax():
    loaded = _loaded(
        "import harness.cell, harness.trace, harness.program, harness.load, harness.work\n"
        "import terrain_diffusion_tpu_torch.serving.api, terrain_diffusion_tpu_torch.serving."
        "coalesce, terrain_diffusion_tpu_torch.pipeline.world, "
        "terrain_diffusion_tpu_torch.nn.edm_unet")
    assert not loaded & FORBIDDEN
    assert "terrain_diffusion_tpu_torch" in loaded
