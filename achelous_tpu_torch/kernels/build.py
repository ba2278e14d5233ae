"""Build and load the port's CUDA kernels.

At first use, `nvcc` compiles every `csrc/*.cu` of this package, one
process a source, all started together, and links the objects into one
shared library with a plain C interface, under `build/kernels/` at the
root of the checkout, named by a hash of the sources and flags; later
calls (and later processes) reuse it.  The library is loaded with ctypes.
Nothing is fetched: the sources in the checkout are the whole input.

    python -m achelous_tpu_torch.kernels.build     # build, print seconds
    python -m achelous_tpu_torch.kernels.build --report
        # also: each kernel's registers, shared memory and spills
        # (nvcc -Xptxas -v) and its tensor-core (HMMA), ldmatrix (LDSM)
        # and cp.async (LDGSTS) instructions in the built library's SASS
        # (cuobjdump -sass)
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> (argtypes, restype) of the C interface in csrc/*.cu
SIGNATURES = {
    "achelous_fused_radarconv": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _P], _I),
    "achelous_deform_samples": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _P], _I),
    "achelous_farthest_point_sample": ([_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                        _P], _I),
    "achelous_bias_attention": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, ctypes.c_float, _I, _P], _I),
    "achelous_cuda_error_string": ([_I], ctypes.c_char_p),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise FileNotFoundError("nvcc not found on PATH or in CUDA_HOME")
    return str(path)


def library_path(flags: tuple = ()) -> Path:
    """Where the library built with NVCC_FLAGS + `flags` lives: named by a
    hash of the flags and of every source and header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + list(flags)).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libachelous_kernels_{h.hexdigest()[:16]}.so"


def build(flags: tuple = ()) -> float:
    """Compile the library (with NVCC_FLAGS + `flags`) if it is not built
    yet; returns the seconds the compile took (0.0 when it was already
    there)."""
    lib = library_path(flags)
    nvcc_flags = NVCC_FLAGS + list(flags)
    if lib.exists():
        return 0.0
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    objs = BUILD_DIR / f"{lib.stem}.{os.getpid()}.objs"
    objs.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        compiles = []
        for src in sources():
            obj = objs / f"{src.stem}.o"
            cmd = [nvcc()] + nvcc_flags + ["-c", "-o", str(obj), str(src)]
            compiles.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, proc in compiles:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        cmd = [nvcc(), "-shared", "-o", str(tmp)] + nvcc_flags + sorted(
            str(o) for o in objs.glob("*.o"))
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(objs, ignore_errors=True)
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with every entry point's argtypes declared."""
    build()
    lib = ctypes.CDLL(str(library_path()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer as a ctypes argument."""
    return ctypes.c_void_p(t.data_ptr())


def raise_on(name: str, err: int):
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronise does not report it)."""
    if err != 0:
        msg = load().achelous_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


SASS_OPS = ("HMMA", "LDSM", "LDGSTS")


def report():
    """Print what ptxas says of each kernel, and the count of SASS_OPS in
    each kernel function of the built library."""
    objs = BUILD_DIR / f"report.{os.getpid()}"
    objs.mkdir(parents=True, exist_ok=True)
    try:
        for src in sources():
            proc = subprocess.run(
                [nvcc()] + NVCC_FLAGS + ["-Xptxas", "-v", "-c", "-o",
                                         str(objs / f"{src.stem}.o"),
                                         str(src)],
                capture_output=True, text=True, check=True)
            print(f"== {src.name} (ptxas -v)")
            print("\n".join(line for line in proc.stderr.splitlines()
                            if "ptxas info" in line or "spill" in line))
    finally:
        shutil.rmtree(objs, ignore_errors=True)
    cuobjdump = Path(nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library_path())],
                          capture_output=True, text=True, check=True).stdout
    print("== SASS instruction counts per kernel function")
    func, counts = None, {}
    for line in sass.splitlines() + ["Function : <end>"]:
        if "Function : " in line:
            if func is not None:
                print(f"{func}: " + ", ".join(f"{op} {counts[op]}"
                                              for op in SASS_OPS))
            func = line.split("Function : ")[1].strip()
            counts = {op: 0 for op in SASS_OPS}
            continue
        for op in SASS_OPS:
            if f" {op}" in line:
                counts[op] += 1


if __name__ == "__main__":
    import sys
    print(f"built {library_path()} in {build():.1f} s")
    if "--report" in sys.argv[1:]:
        report()
