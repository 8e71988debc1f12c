"""Build, load and launch the port's CUDA kernels.

All of ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
one shared library with a plain C interface, at first use, under
``zkir_tpu_torch/_build/`` (git-ignored).  The library's file name holds
a hash of the sources and flags, so an edited source builds anew.  It is
loaded with ``ctypes``: pointers and the stream pass as ``c_void_p``,
lengths as ``c_longlong``.

Every C entry point launches on the given stream (PyTorch's current
one), does not synchronise, and returns ``cudaGetLastError()``; ``launch``
raises if that is not 0.  One exception: ``p2_grind`` returns a host
value (the nonce), so it waits for its stream before it returns.
``launches`` holds one plain count per kernel, raised by one where the
kernel is launched and nowhere else.

Generated sources (the quotient's parts, ``prover/quotient_codegen.py``)
are compiled by ``build_generated`` with the same nvcc and flags, each
into a library of its own.

Nothing here runs at import time: the CPU tests import every module, and
this machine need not have ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD = pathlib.Path(__file__).resolve().parent / "_build"
# --threads 0: one compilation per source file, all started together.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--threads", "0")

_P = ctypes.c_void_p
_N = ctypes.c_longlong
_I = ctypes.c_int
# C entry point -> argument types (the stream is appended to each).
_SIGNATURES = {
    # a, b, out, host descriptor (shape, strides, immediates), op
    "m31_binary": (_P, _P, _P, _P, _I),
    # a_re, a_im, b_re, b_im, out_re, out_im, host descriptor, op
    "cm31_binary": (_P, _P, _P, _P, _P, _P, _P, _I),
    # in_re, in_im, in_row_stride, in_len, out_re, out_im, out_row_stride,
    # mid, pre, post, batch, log_n, scale, host plan (ops/ntt.py
    # plan_words)
    "cm31_ntt": (_P, _P, _N, _N, _P, _P, _N, _P, _P, _P, _N, _I, _N, _P),
    "p2_permute": (_P, _P, _N),
    "p2_sponge_rows": (_P, _P, _N, _N, _I),
    # states [n, 16] (in place), blocks [n, w], n, w, pad
    "p2_sponge_absorb": (_P, _P, _N, _N, _I),
    "p2_compress_level": (_P, _P, _N),
    # leaves, levels 1.. in one buffer, leaf count
    "p2_merkle_tree": (_P, _P, _N),
    # host state (16 uint32), bits, start nonce, nonce limit, host nonce
    # (int64; the entry point synchronises)
    "p2_grind": (_P, _I, _N, _N, _P),
    # data, offsets, lengths, output rows, digests, k
    "p2_sponge_bytes": (_P, _P, _P, _P, _P, _N),
    # host descriptor (csrc/interp.cu's enum)
    "interp_run": (_P,),
    # data, offsets, lengths, states in (or null), states out, witness (or
    # null), n, pad
    "sha256_blocks": (_P, _P, _P, _P, _P, _P, _N, _I),
    # data, offsets, lengths, state in (or null), state out, n, pad
    "keccak_absorb": (_P, _P, _P, _P, _P, _N, _I),
    # data, offsets, lengths, first lanes, output rows, digests, n, lanes
    "b3_rows": (_P, _P, _P, _P, _P, _P, _N, _N),
    # cv (or null), words, counter lo, counter hi, block_len, flags, out, n
    "b3_compress": (_P, _P, _P, _P, _P, _P, _P, _N),
    # x0..x3, y0..y3, a, b (each or null), out [4, R, n], host descriptor
    "qm31_inv_scaled": (_P,) * 12,
    # in0..in3, out [4, R, n], tile status (zero words), R, n, vec
    "m31_exclusive_scan": (_P, _P, _P, _P, _P, _P, _N, _N, _I),
}

# One count per entry point; a module that builds kernels of its own
# (prover/quotient_codegen.py) adds its count here.
launches = {name: 0 for name in _SIGNATURES}

_lib = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD / f"libzkir_kernels.{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library unless a build of these exact sources exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    return so


def build_generated(sources, extra_flags=()) -> None:
    """Compile each generated source ``X.cu`` into its own library
    ``X.so`` beside it, one ``nvcc`` per source, all started together,
    with this module's flags, ``extra_flags`` and ``csrc/`` on the include
    path.  nvcc's messages go to ``X.log``.  Raises with nvcc's messages
    if any source fails."""
    nvcc = _nvcc()
    jobs = []
    for cu in sources:
        so = cu.with_suffix(".so")
        tmp = cu.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-I", str(CSRC), "-o",
               str(tmp), str(cu)]
        jobs.append((cu, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cu, so, tmp, proc in jobs:
        messages = proc.communicate()[0]
        cu.with_suffix(".log").write_text(messages)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {cu.name} ({proc.returncode}):"
                          f"\n{messages}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def _load():
    global _lib
    if _lib is not None:
        return _lib
    import numpy as np
    import torch

    torch.cuda.init()
    lib = ctypes.CDLL(str(build()))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [*args, _P]
        fn.restype = _I
    lib.zk_error_string.argtypes = [_I]
    lib.zk_error_string.restype = ctypes.c_char_p
    lib.p2_set_constants.argtypes = [_P, _P, _P]
    lib.p2_set_constants.restype = _I

    from .ops.poseidon2 import _params_np

    external, internal, dm1 = (np.ascontiguousarray(a, dtype=np.uint32)
                               for a in _params_np())
    _check(lib, lib.p2_set_constants(external.ctypes.data,
                                     internal.ctypes.data, dm1.ctypes.data),
           "p2_set_constants")
    _lib = lib
    return lib


def _check(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.zk_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {err} ({msg})")


def launch(name: str, *args) -> None:
    """Launch C entry point ``name`` on the current stream and count it."""
    lib = _lib or _load()
    _check(lib, getattr(lib, name)(*args, _current_stream()), name)
    launches[name] += 1


def _current_stream() -> int:
    """The raw handle of PyTorch's current CUDA stream.  A prove makes
    thousands of launches, and ``torch.cuda.current_stream()`` costs more
    host time than a launch does (it builds a ``Stream`` object and checks
    the device each time), so the handle is read through the raw getter
    where this PyTorch has it."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream().cuda_stream
    return raw(torch.cuda.current_device())
