"""Builds the port's host C++ sources (csrc/*.cpp with a plain C
interface) into shared libraries, loaded with ctypes by their callers:
the BVH build (accel/bvh.py) and the PIZ Huffman decode (io/exr.py).

Each source compiles once per content hash into build/torch_kernels (the
host C++ compiler, else nvcc as a C++ compiler); a failed compile raises,
and nothing falls back.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"


def _compiler(what: str) -> list:
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx:
        return [cxx]
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError(f"{what}: no C++ compiler (c++, g++ or nvcc)")
    return [str(Path(CUDA_HOME) / "bin" / "nvcc"), "-x", "c++"]


def compile_shared(src: Path, build_dir: Path, what: str) -> dict:
    """Compile `src` into build_dir/<stem>_<hash>.so unless it is there ->
    {"path", "seconds", "log"}.  Raises RuntimeError naming `what` and the
    source when the compiler fails."""
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    build_dir.mkdir(parents=True, exist_ok=True)
    so = build_dir / f"{src.stem}_{tag}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        cxx = _compiler(what)
        pic = ["-Xcompiler", "-fPIC"] if cxx[0].endswith("nvcc") \
            else ["-fPIC"]
        res = subprocess.run(cxx + ["-O2", "-std=c++17", "-shared", *pic,
                                    "-o", tmp, str(src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"{what}: compiling {src.name} failed\n"
                               + res.stdout + res.stderr)
        log = res.stdout + res.stderr
        # rename(2) into place: a concurrent builder never loads a
        # half-written library
        os.replace(tmp, so)
    return {"path": str(so), "seconds": time.perf_counter() - t0,
            "log": log}
