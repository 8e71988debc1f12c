"""ctypes bridge to the native C++ interpreter (``runtime/zkir_vm.cpp``).

Counterpart of ``zkir_tpu/runtime/native_vm.py``: the same ``run_native``,
``NativeResult`` and halt codes.  The port keeps its own copy of the C++
source and builds it on first use (``g++ -O3``) into
``zkir_tpu_torch/_build/``, under a name that holds a hash of the source,
so an edited source builds anew.  A failed build raises
``NativeBuildError``; nothing falls back to another engine.  Crypto
syscalls halt with ``HALT_UNSUPPORTED_SYSCALL``: programs that use them
run on the batched interpreter (``run --engine gpu``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from dataclasses import dataclass
from typing import List, Optional

_SRC = pathlib.Path(__file__).resolve().parent / "zkir_vm.cpp"
_BUILD = pathlib.Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

HALT_NONE = 0
HALT_EBREAK = 1
HALT_EXIT = 2
HALT_CYCLE_LIMIT = 3
HALT_ERROR = 4
HALT_UNSUPPORTED_SYSCALL = 6

_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    pass


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return _BUILD / f"libzkir_vm.{h.hexdigest()[:16]}.so"


def ensure_built() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        try:
            subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                           check=True, capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            detail = getattr(e, "stderr", None) or str(e)
            raise NativeBuildError(f"failed to build native VM: {detail}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.zkir_run.restype = ctypes.c_int
    lib.zkir_run.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64,   # code
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,    # data
        ctypes.c_uint64,                                    # entry
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,   # inputs
        ctypes.c_uint64,                                    # max_cycles
        ctypes.POINTER(ctypes.c_uint64),                    # out regs[16]
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,   # outputs
        ctypes.POINTER(ctypes.c_uint64),                    # n_outputs
        ctypes.POINTER(ctypes.c_uint64),                    # cycles
        ctypes.POINTER(ctypes.c_uint64),                    # exit_code
    ]
    _lib = lib
    return lib


def available() -> bool:
    try:
        ensure_built()
        return True
    except NativeBuildError:
        return False


@dataclass
class NativeResult:
    halt: int
    cycles: int
    exit_code: int
    outputs: List[int]
    regs: List[int]


def run_native(program, inputs: List[int],
               max_cycles: int = 1_000_000,
               max_outputs: int = 4096) -> NativeResult:
    """Execute a Program on the native core."""
    lib = ensure_built()

    code_arr = (ctypes.c_uint32 * max(len(program.code), 1))(
        *[w & 0xFFFFFFFF for w in program.code])
    data_bytes = bytes(program.data)
    data_arr = (ctypes.c_uint8 * max(len(data_bytes), 1))(*data_bytes)
    in_arr = (ctypes.c_uint64 * max(len(inputs), 1))(
        *[v & ((1 << 64) - 1) for v in inputs])
    regs = (ctypes.c_uint64 * 16)()
    outputs = (ctypes.c_uint64 * max_outputs)()
    n_out = ctypes.c_uint64()
    cycles = ctypes.c_uint64()
    exit_code = ctypes.c_uint64()

    halt = lib.zkir_run(
        code_arr, len(program.code),
        data_arr, len(data_bytes),
        program.header.entry_point,
        in_arr, len(inputs),
        max_cycles,
        regs, outputs, max_outputs, ctypes.byref(n_out),
        ctypes.byref(cycles), ctypes.byref(exit_code),
    )
    return NativeResult(
        halt=halt,
        cycles=cycles.value,
        exit_code=exit_code.value,
        outputs=list(outputs[: n_out.value]),
        regs=list(regs),
    )
