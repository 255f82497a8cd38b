"""The port's C++ OBJ reader (liverrenderer_tpu_torch/csrc/mesh_load.cpp,
through scene/meshio.load_mesh) against its plain Python version
(`meshio._load_obj`) and the JAX package's native reader
(liverrenderer_tpu/_native obj_load through its load_mesh): equal bit for
bit on every OBJ case of tests/test_torch_io.py, on the parse's corner
cases, and on the liver proxy written as OBJ.
"""
import numpy as np
import pytest

from liverrenderer_tpu.scene import meshio as jmeshio
from liverrenderer_tpu_torch.scene import meshio as tmeshio
from liverrenderer_tpu_torch.scene.liver_proxy import liver_mesh
from test_torch_io import OBJ, _OBJ_V, _assert_mesh_equal
from torch_threads import torch_threads_per_worker  # noqa: F401

CASES = dict(OBJ)
CASES.update({
    # polygons of 3 to 6 corners, blank lines, \r\n, vp and o/g/s/usemtl
    # lines, a comment line
    "mixed_lines": _OBJ_V.replace("\n", "\r\n") + "\n# a comment\no obj\n"
    "g grp\ns 1\nusemtl m\nvp 0.5 0.5\nvt 0 0\nvt 1 0\nvt 1 1\n"
    "vn 0 0 1\nf 1/1/1 2/2/1 3/3/1 4/1/1 5/2/1\n\nf 3/3/1 4/2/1 5/1/1\n",
    # a corner that repeats one vertex with other uvs and normals
    "split_uvs": _OBJ_V + "vt 0 0\nvt 0.5 0.5\nvn 1 0 0\nvn 0 1 0\n"
    "f 1/1/1 2/1/1 3/1/1\nf 1/2/2 3/2/2 4/2/2\n",
    # exponents and signs in the numbers
    "numbers": "v 1e-3 -2.5E+1 +0.125\nv .5 -.25 1.\nv 3 4 5\n"
    "vt 1e-1 9E-1\nf 1/1 2/1 3/1\n",
})


def _write(tmp_path, name, text):
    p = tmp_path / f"{name}.obj"
    p.write_text(text)
    return str(p)


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_equals_plain_and_jax(tmp_path, case):
    p = _write(tmp_path, case, CASES[case])
    native = tmeshio.load_obj_native(p)
    _assert_mesh_equal(native, tmeshio._load_obj(p))
    _assert_mesh_equal(native, jmeshio.load_mesh(p))
    _assert_mesh_equal(tmeshio.load_mesh(p), native)


@pytest.mark.parametrize("subdiv", [2, 4])
def test_liver_proxy_as_obj(tmp_path, subdiv):
    """The liver proxy with normals and uvs: 1-based v/vt/vn corners."""
    v, f, n, uv = liver_mesh(subdiv, 0)
    lines = [f"v {a!r} {b!r} {c!r}" for a, b, c in v.tolist()]
    lines += [f"vt {a!r} {b!r}" for a, b in uv.tolist()]
    lines += [f"vn {a!r} {b!r} {c!r}" for a, b, c in n.tolist()]
    lines += ["f " + " ".join(f"{i + 1}/{i + 1}/{i + 1}" for i in tri)
              for tri in f.tolist()]
    p = _write(tmp_path, "liver", "\n".join(lines) + "\n")
    native = tmeshio.load_mesh(p)
    _assert_mesh_equal(native, tmeshio._load_obj(p))
    _assert_mesh_equal(native, jmeshio.load_mesh(p))
    assert native.faces.shape == f.shape
    # vertices are renumbered by first use; each corner keeps its position
    np.testing.assert_array_equal(native.vertices[native.faces], v[f])


def test_missing_file_raises(tmp_path):
    with pytest.raises(OSError):
        tmeshio.load_obj_native(str(tmp_path / "absent.obj"))
