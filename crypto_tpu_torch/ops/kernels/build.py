"""Build and load the port's CUDA kernels.

`crypto_tpu_torch/csrc/*.cu` are compiled by `nvcc` for `sm_90a` at first
use into one shared library with a plain C interface under `build/` at the
root of the checkout (listed in `.gitignore`), and loaded with `ctypes`.
Each source compiles in its own `nvcc` process, all started together; the
library's name carries a hash of the sources, so an edit rebuilds.  No
PyTorch headers are included, which keeps a build to seconds.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises when that is not 0.

    python3 -m crypto_tpu_torch.ops.kernels.build [--lib LIB]

prints every kernel's registers and spills (from ptxas's `-v` report in
the build log, kept beside the library) and its SASS instruction count
(`cuobjdump --dump-sass`), on the machine with the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("mont_mul.cu", "affine_level.cu", "chunked_level.cu",
           "jacobian.cu", "normalize.cu", "fq2_mul.cu", "affine_level_fq2.cu",
           "gather.cu")
HEADERS = ("field.cuh", "ptx.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_U32 = ctypes.c_uint32
_INT = ctypes.c_int
# C entry point -> argument types (pointers and the stream as void*)
SIGNATURES = {
    "crypto_mont_mul": [_P, _P, _P, _I64, _INT, _P, _U32, _P],
    "crypto_mont_pow": [_P, _P, _I64, _INT, _P, _U32, _P, _P],
    "crypto_affine_level": [_P] * 9 + [_I64, _INT, _P, _U32, _P, _P, _P],
    "crypto_affine_level_fast": [_P] * 10 + [_I64, _INT, _P, _U32, _P, _P,
                                             _P],
    "crypto_chunked_prefix": [_P] * 10 + [_I64, _INT, _P, _U32, _P],
    "crypto_chunked_down": [_P] * 11 + [_I64, _INT, _P, _U32, _P],
    "crypto_chunked_prefix_fast": [_P] * 7 + [_I64, _INT, _P, _U32, _P],
    "crypto_chunked_down_fast": [_P] * 10 + [_I64, _INT, _P, _U32, _P],
    "crypto_jac_add": [_P] * 10 + [_I64, _INT, _P, _U32, _P],
    "crypto_jac_add_mixed": [_P] * 8 + [_I64, _INT, _P, _U32, _P],
    "crypto_jac_double": [_P] * 6 + [_I64, _INT, _P, _U32, _P],
    "crypto_normalize": [_P] * 6 + [_I64, _INT, _P, _U32, _P, _P, _P],
    "crypto_fq2_mul": [_P, _P, _P, _I64, _INT, _P, _U32, _P],
    "crypto_fq2_sqr": [_P, _P, _I64, _INT, _P, _U32, _P],
    "crypto_affine_pre_fq2": [_P] * 9 + [_I64, _INT, _P, _U32, _P],
    "crypto_affine_post_fq2": [_P] * 10 + [_I64, _INT, _P, _U32, _P],
    "crypto_gather_rows_t": [_P, _P, _P, _I64, _I64, _I64, _P],
    "crypto_slot_tables": [_P] * 4 + [_I64, _I64, _INT, _P, _U32, _P],
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("crypto_tpu_torch: nvcc not found; the CUDA kernels "
                       "are built on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    objs, procs = [], []
    # objects, log and library are named per process until the library is
    # renamed into place, so concurrent builds of one checkout do not clash
    pid = os.getpid()
    for name in SOURCES:
        obj = BUILD_DIR / f"{target.stem}.{pid}.{Path(name).stem}.o"
        objs.append(obj)
        procs.append((name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    failed = []
    for name, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    log = "\n".join(logs)
    log_tmp = BUILD_DIR / f"{target.stem}.{pid}.log"
    log_tmp.write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log[-6000:]}")
    tmp = target.with_suffix(f".{pid}.tmp")
    link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(tmp)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(log_tmp, target.with_suffix(".log"))
    os.replace(tmp, target)
    for obj in objs:
        obj.unlink()
    build_info.update(seconds=time.time() - t0)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"libcrypto_tpu_torch_{_digest()}.so"
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            build_info.setdefault("seconds", 0.0)
            build_info["path"] = str(target)
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def _short_names(mangled) -> dict:
    """Mangled kernel names -> `name<args>`, demangled by c++filt (in the
    binutils that nvcc's host compiler needs)."""
    mangled = sorted(set(mangled))
    out = subprocess.run(["c++filt"], input="\n".join(mangled),
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.splitlines()
    names = {}
    for m, d in zip(mangled, out):
        hit = re.search(r"(\w+_kernel(<[^>]*>)?)\(", d)
        names[m] = hit.group(1) if hit else d
    return names


def kernel_resources(log: str) -> dict:
    """ptxas's `-v` report in a build log -> {kernel: {"registers": r,
    "spill_stores": bytes, "spill_loads": bytes}} for every entry
    function."""
    res, cur = {}, None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '(\S+)'", line)
        if hit:
            cur = res.setdefault(hit.group(1), {})
            continue
        if cur is None:
            continue
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        line)
        if hit:
            cur["spill_stores"], cur["spill_loads"] = map(int, hit.groups())
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            cur["registers"] = int(hit.group(1))
            cur = None
    names = _short_names(res)
    return {names[k]: v for k, v in sorted(res.items())}


def sass_counts(lib: str) -> dict:
    """{kernel: SASS instructions, NOPs left out} of a built library, from
    `cuobjdump --dump-sass`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dump = subprocess.run([tool, "--dump-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in dump.splitlines():
        hit = re.match(r"\s*Function : (\S+)", line)
        if hit:
            cur = hit.group(1)
            counts[cur] = 0
        elif cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?!NOP\b)\S", line):
            counts[cur] += 1
    names = _short_names(counts)
    return {names[k]: v for k, v in sorted(counts.items())}


def main(argv=None) -> int:
    """Print every kernel's registers, spills and SASS instruction count,
    one JSON object a line, for the checkout's library (built if need be)
    or for the library given by --lib (its build log beside it)."""
    import argparse
    import json
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--lib", help="a built library; default: this "
                    "checkout's, built on first use")
    args = ap.parse_args(argv)
    if not args.lib:
        load_library()
    lib = Path(args.lib or build_info["path"])
    logs = sorted(lib.parent.glob(lib.stem + ".*log"))
    res = kernel_resources(logs[-1].read_text() if logs else "")
    for name, n in sass_counts(str(lib)).items():
        print(json.dumps(dict(kernel=name, sass_instructions=n,
                              **res.get(name, {}))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
